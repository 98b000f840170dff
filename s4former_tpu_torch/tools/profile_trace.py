"""Read a ``torch.profiler`` chrome trace and print where the time went
(counterpart of the trace reader in the root ``tools/profile_trace.py``,
which reads ``jax.profiler`` traces):

    python -m s4former_tpu_torch.tools.profile_trace TRACE [--steps N]

TRACE is a ``trace.json`` written by ``core.hooks.StepTrace`` (by
``tools.train --profile FIRST N`` into ``WORK_DIR/profile/``, or by
``core.hooks.profile_steps``), or the directory that holds it. ``--steps``
divides the times by the number of steps the trace holds.

It prints:
- the device-op breakdown: device time by kernel name (kernels, copies
  and memsets), the ``TOP`` longest;
- the device's busy share: the union of the device's activity intervals
  over the trace's wall time;
- the host time of the dispatching threads, those that launch kernels:
  the Python thread that runs the forward and the optimizer, and the
  autograd engine's thread that runs the backward (on a trace without a
  card, the thread with the most operator time). The union of their
  operator and CUDA runtime calls is the time the host was dispatching;
  outside it the host ran Python, waited for the interpreter lock or for
  a core, or waited on the card. Beside it, each thread's operator time,
  top-level operator calls and their mean length (an operator slows when
  other threads take its core).
"""
from __future__ import annotations

import argparse
import collections
import json
import os.path as osp
from typing import Dict, Iterable, List, Sequence, Tuple

from s4former_tpu_torch.core.hooks import StepTrace

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
LAUNCHES = ('cudaLaunchKernel', 'cuLaunchKernel', 'cudaLaunchKernelExC',
            'cuLaunchKernelEx')
TOP = 15


def load_events(path: str) -> List[dict]:
    if osp.isdir(path):
        path = osp.join(path, StepTrace.TRACE_FILE)
    with open(path) as f:
        trace = json.load(f)
    return trace['traceEvents'] if isinstance(trace, dict) else trace


def merge(intervals: Iterable[Tuple[float, float]]
          ) -> List[Tuple[float, float]]:
    """Sorted, disjoint union of (start, end) intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _length(intervals: Sequence[Tuple[float, float]]) -> float:
    return sum(e - s for s, e in intervals)


def _pct(values: List[float], q: float) -> float:
    if not values:
        return 0.0
    v = sorted(values)
    return v[min(len(v) - 1, int(q * (len(v) - 1) + 0.5))]


def analyze(events: List[dict], steps: int = 1) -> Dict:
    """Summary of a trace's complete ('X') events, times in ms per step
    (``steps`` steps in the trace)."""
    spans = [e for e in events if e.get('ph') == 'X' and 'dur' in e]
    window = [e for e in spans if e.get('cat') == 'Trace']
    if window:
        t0 = min(e['ts'] for e in window)
        t1 = max(e['ts'] + e['dur'] for e in window)
    else:
        t0 = min(e['ts'] for e in spans)
        t1 = max(e['ts'] + e['dur'] for e in spans)
    wall = t1 - t0
    names = {(e.get('pid'), e.get('tid')): e.get('args', {}).get('name', '')
             for e in events if e.get('ph') == 'M' and
             e.get('name') == 'thread_name'}
    per = 1e3 * steps            # trace microseconds -> ms per step

    device = [e for e in spans if str(e.get('cat', '')).lower()
              in DEVICE_CATS]
    by_name: Dict[str, List[float]] = collections.defaultdict(
        lambda: [0.0, 0])
    for e in device:
        by_name[e['name']][0] += e['dur']
        by_name[e['name']][1] += 1
    busy = _length(merge((e['ts'], e['ts'] + e['dur']) for e in device))

    threads: Dict[Tuple, Dict] = collections.defaultdict(
        lambda: {'ops': [], 'runtime': [], 'launches': 0})
    for e in spans:
        cat = e.get('cat')
        if cat not in ('cpu_op', 'cuda_runtime', 'cuda_driver'):
            continue
        t = threads[(e.get('pid'), e.get('tid'))]
        t['ops' if cat == 'cpu_op' else 'runtime'].append(
            (e['ts'], e['ts'] + e['dur']))
        t['launches'] += e['name'] in LAUNCHES
    host = {}
    for key, t in threads.items():
        calls = merge(t['ops'])
        host[key] = {'thread': names.get(key, str(key[1])),
                     'op_ms': _length(calls) / per,
                     'op_calls': len(calls) / steps,
                     'op_mean_us': _length(calls) / len(calls) if calls
                     else 0.0,
                     'launches': t['launches'] / steps}
    dispatch = [k for k, t in threads.items() if t['launches']]
    if not dispatch and threads:
        dispatch = [max(threads, key=lambda k: host[k]['op_ms'])]
    out = {'steps': steps, 'wall_ms': wall / per,
           'device_ms': sum(v[0] for v in by_name.values()) / per,
           'device_busy_ms': busy / per,
           'device_busy_share': busy / wall if wall else 0.0,
           'device_ops': [{'name': n[:120], 'ms': d / per, 'calls': c}
                          for n, (d, c) in sorted(by_name.items(),
                                                  key=lambda kv: -kv[1][0]
                                                  )[:TOP]],
           'threads': sorted(({**v, 'dispatch': k in dispatch}
                              for k, v in host.items()),
                             key=lambda v: -v['op_ms'])}
    if dispatch:
        active = merge(iv for k in dispatch
                       for iv in threads[k]['ops'] + threads[k]['runtime'])
        gaps = [b[0] - a[1] for a, b in zip(active, active[1:])]
        big = [g for g in gaps if g > 1e3]
        out['dispatch'] = {
            'threads': [host[k]['thread'] for k in dispatch],
            'launches': sum(threads[k]['launches'] for k in dispatch) / steps,
            'busy_ms': _length(active) / per,
            'busy_share': _length(active) / wall if wall else 0.0,
            'idle_ms': (wall - _length(active)) / per,
            'gaps': len(gaps) / steps,
            'gap_p50_us': _pct(gaps, 0.5), 'gap_p99_us': _pct(gaps, 0.99),
            'gap_max_ms': max(gaps, default=0.0) / 1e3,
            'gaps_over_1ms': len(big) / steps,
            'gaps_over_1ms_ms': sum(big) / per}
    return out


def report(s: Dict) -> str:
    lines = [f'{s["steps"]} step(s): {s["wall_ms"]:.2f} ms of wall a step; '
             f'device busy {s["device_busy_ms"]:.2f} ms '
             f'({100 * s["device_busy_share"]:.1f}%), '
             f'{s["device_ms"]:.2f} ms of device ops']
    if s['device_ops']:
        lines.append('device ops (ms a step, calls a step):')
        lines += [f'  {op["ms"]:9.3f}  {op["calls"] / s["steps"]:7.1f}  '
                  f'{op["name"][:90]}' for op in s['device_ops']]
    d = s.get('dispatch')
    if d:
        lines.append(
            f'dispatching threads {", ".join(d["threads"])}: '
            f'{d["launches"]:.0f} launches, in calls {d["busy_ms"]:.2f} ms '
            f'({100 * d["busy_share"]:.1f}%), outside {d["idle_ms"]:.2f} ms; '
            f'{d["gaps"]:.0f} gaps between calls (p50 '
            f'{d["gap_p50_us"]:.1f} us, p99 {d["gap_p99_us"]:.1f} us, max '
            f'{d["gap_max_ms"]:.2f} ms; {d["gaps_over_1ms"]:.1f} over 1 ms '
            f'hold {d["gaps_over_1ms_ms"]:.2f} ms) a step')
    lines.append('host threads (operator ms, top-level calls, mean us, '
                 'launches a step):')
    lines += [f'  {t["op_ms"]:9.3f} {t["op_calls"]:7.0f} '
              f'{t["op_mean_us"]:8.1f} {t["launches"]:6.0f}  {t["thread"]}'
              f'{"  <- dispatch" if t["dispatch"] else ""}'
              for t in s['threads']]
    return '\n'.join(lines)


def main(argv=None) -> Dict:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('trace', help='trace.json or its directory')
    parser.add_argument('--steps', type=int, default=1,
                        help='the number of steps the trace holds')
    args = parser.parse_args(argv)
    summary = analyze(load_events(args.trace), args.steps)
    print(report(summary))
    return summary


if __name__ == '__main__':
    main()
