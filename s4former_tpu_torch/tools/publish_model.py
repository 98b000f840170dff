"""Strip a training checkpoint for release (counterpart of
``tools/publish_model.py``; reference: tools/publish_model.py):

    python -m s4former_tpu_torch.tools.publish_model IN OUT [--to-pth]

IN is a training checkpoint directory of the port's runner
(``work_dir/iter_N``). Only the inference state is kept: the student's
state dict (parameters and BN statistics); the SGD buffers, the EMA
teacher and the step are dropped. It is written as the checkpoint
directory ``OUT-<h>`` (``state.pt`` holding ``{'model': ...}``, which
``tools.test``, ``apis.init_segmentor`` and the demos load), where ``<h>``
is the first 8 hex digits of the SHA-256 of the kept tensors' bytes in
``state_dict`` order (the port's own hash: the JAX tool hashes its tree's
leaves, so the two names differ). ``--to-pth`` also writes
``OUT-<h>.pth``, the reference-layout ``{'state_dict': ..., 'meta': ...}``
file. Both are written to a temporary name and renamed into place. Touches
no device.
"""
import argparse
import hashlib
import os
import os.path as osp
import shutil


def state_hash(sd) -> str:
    """SHA-256 hex digest of the tensors' bytes in ``sd``'s order."""
    import torch
    h = hashlib.sha256()
    for t in sd.values():
        h.update(t.detach().cpu().contiguous().reshape(-1).view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


def main(argv=None):
    """Publish; returns (published directory, .pth path or None)."""
    parser = argparse.ArgumentParser(description='Publish a checkpoint')
    parser.add_argument('in_ckpt', help='training checkpoint dir (iter_N)')
    parser.add_argument('out_ckpt', help='output prefix')
    parser.add_argument('--to-pth', action='store_true',
                        help='also write a reference-layout state_dict '
                             'next to the published dir (loadable by '
                             'mmseg tools)')
    args = parser.parse_args(argv)

    from s4former_tpu_torch.core.checkpoint import (STATE_FILE, _write,
                                                    load_model_state_dict)
    sd = load_model_state_dict(args.in_ckpt)
    out = f'{osp.abspath(args.out_ckpt)}-{state_hash(sd)[:8]}'
    tmp = out + '.tmp'
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    _write({'model': sd}, osp.join(tmp, STATE_FILE))
    shutil.rmtree(out, ignore_errors=True)
    os.replace(tmp, out)
    print(f'published {out}')
    pth = None
    if args.to_pth:
        pth = out + '.pth'
        _write({'state_dict': sd,
                'meta': {'exported_by': 's4former_tpu_torch'}}, pth)
        print(f'exported reference-layout state_dict {pth}')
    return out, pth


if __name__ == '__main__':
    main()
