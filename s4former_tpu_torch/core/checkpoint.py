"""Weight bridge (counterpart of the torch-facing half of
``s4former_tpu/core/checkpoint.py``).

The port's modules carry the reference (mmseg) parameter names, so its
``state_dict`` is the reference layout:

- ``state_dict_from_jax_variables(variables)``: the JAX package's
  ``{'params', 'batch_stats'[, 'ema_params', 'ema_batch_stats']}`` tree, as
  numpy arrays, -> reference-layout tensors. It unstacks the scanned ViT
  layers and the vmapped aux heads and transposes dense and conv kernels.
  Same keys and values as JAX ``export_reference_state_dict`` (l.2739) for
  the ViT and SETR-PUP; for the MiT and the SegFormer head it inverts JAX
  ``convert_mit_backbone`` (l.283) and ``convert_segformer_head`` (l.911).
- ``load_reference_state_dict(path)``: an mmseg/S4Former ``.pth``, or a
  backbone-only DeiT file with bare OpenMMLab or timm keys
  (``normalize_backbone_keys``, applied to ViT-layout backbones only: a MiT
  backbone's keys pass unrenamed, as JAX ``convert_mmseg_checkpoint``
  leaves them), -> tensors under the port's names, with
  the bicubic pos-embed resize on load of JAX ``_resize_pos_embed_np``
  (l.169); ``overlay_state_dict`` loads them over a model, counts what it
  overlaid and raises when that is nothing.
- ``ema_state_dict(sd)``: the EMA twin's keys (``backbone_ema.``,
  ``decode_head_ema.``) renamed onto the student's.
- ``train_state_dicts_from_jax(state)``: the JAX ``TrainState`` (params,
  batch_stats, SGD momentum, EMA params and EMA batch_stats) -> state dicts
  under the port's names, so both packages can start training from one
  state (``semi.train_step.train_state_from_jax`` builds the port's).

And the port's own training checkpoints, with the contract of the JAX
module's orbax half (l.30-143): ``save_checkpoint(work_dir, step, state,
keep, meta, block)`` writes ``work_dir/iter_{step}/state.pt`` (a torch
file of the ``TrainState``: step, student, SGD buffers, EMA teacher,
annealed momentum) and ``s4former_meta.json``; ``finalize_pending_saves``,
``find_all_checkpoints``, ``find_latest_checkpoint`` and
``load_checkpoint``. Orbax directories need JAX and are not read here.
"""
from __future__ import annotations

import dataclasses
import json
import os
import os.path as osp
import re
import shutil
import threading
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

StateDict = Dict[str, torch.Tensor]
STATE_FILE = 'state.pt'
META_FILE = 's4former_meta.json'


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, order='C'))   # a writable copy


def _conv(kernel) -> torch.Tensor:
    """flax HWIO conv kernel -> torch OIHW."""
    return _t(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


def _vit(p: Mapping, prefix: str) -> StateDict:
    sd: StateDict = {}
    for name in ('cls_token', 'pos_embed'):
        if name in p:
            sd[prefix + name] = _t(p[name])
    if 'patch_embed' in p:
        sd[prefix + 'patch_embed.projection.weight'] = _conv(
            p['patch_embed']['kernel'])
        sd[prefix + 'patch_embed.projection.bias'] = _t(
            p['patch_embed']['bias'])
    if 'layers' in p:
        blk = p['layers']['block']
        dense = {'attn.attn.in_proj': blk['attn']['qkv'],
                 'attn.attn.out_proj.': blk['attn']['proj'],
                 'ffn.layers.0.0.': blk['ffn']['fc1'],
                 'ffn.layers.1.': blk['ffn']['fc2']}
        for i in range(np.asarray(blk['ln1']['scale']).shape[0]):
            pre = f'{prefix}layers.{i}.'
            for ln in ('ln1', 'ln2'):
                sd[f'{pre}{ln}.weight'] = _t(blk[ln]['scale'][i])
                sd[f'{pre}{ln}.bias'] = _t(blk[ln]['bias'][i])
            for key, leaf in dense.items():
                # torch MHA names its fused qkv in_proj_weight/in_proj_bias
                sep = '_' if key.endswith('in_proj') else ''
                sd[f'{pre}{key}{sep}weight'] = _t(
                    np.asarray(leaf['kernel'][i]).T)
                sd[f'{pre}{key}{sep}bias'] = _t(leaf['bias'][i])
    return sd


def _setr_up(p: Mapping, bs: Mapping, prefix: str) -> StateDict:
    sd: StateDict = {}
    if 'norm' in p:
        sd[prefix + 'norm.weight'] = _t(p['norm']['scale'])
        sd[prefix + 'norm.bias'] = _t(p['norm']['bias'])
    i = 0
    while f'up_convs_{i}' in p:
        c = p[f'up_convs_{i}']
        pre = f'{prefix}up_convs.{i}.0.'
        sd[pre + 'conv.weight'] = _conv(c['conv']['kernel'])
        sd[pre + 'bn.weight'] = _t(c['bn']['scale'])
        sd[pre + 'bn.bias'] = _t(c['bn']['bias'])
        stats = bs.get(f'up_convs_{i}', {}).get('bn', {})
        if stats:
            sd[pre + 'bn.running_mean'] = _t(stats['mean'])
            sd[pre + 'bn.running_var'] = _t(stats['var'])
        i += 1
    if 'conv_seg' in p:
        sd[prefix + 'conv_seg.weight'] = _conv(p['conv_seg']['kernel'])
        sd[prefix + 'conv_seg.bias'] = _t(p['conv_seg']['bias'])
    return sd


def _scale_bias(p: Mapping) -> Tuple[torch.Tensor, torch.Tensor]:
    """A flax LayerNorm's or BatchNorm's (scale, bias) as torch's (weight,
    bias)."""
    return _t(p['scale']), _t(p['bias'])


def _dense_as_conv1x1(kernel) -> torch.Tensor:
    """flax Dense kernel [Cin, Cout] -> torch 1x1 conv weight [Cout, Cin,
    1, 1]."""
    return _t(np.asarray(kernel).T[:, :, None, None])


def _mit(p: Mapping, prefix: str) -> StateDict:
    """JAX MixVisionTransformer params -> the mmseg MiT layout (the inverse
    of JAX ``convert_mit_backbone``)."""
    sd: StateDict = {}

    def put(key, leaf, weight):
        sd[prefix + key + '.weight'] = weight
        if 'bias' in leaf:
            sd[prefix + key + '.bias'] = _t(leaf['bias'])
    s = 0
    while f'patch_embed_{s}' in p:
        pe = p[f'patch_embed_{s}']
        put(f'layers.{s}.0.projection', pe['proj'],
            _conv(pe['proj']['kernel']))
        (sd[f'{prefix}layers.{s}.0.norm.weight'],
         sd[f'{prefix}layers.{s}.0.norm.bias']) = _scale_bias(pe['norm'])
        i = 0
        while f'stage_{s}_block_{i}' in p:
            blk = p[f'stage_{s}_block_{i}']
            pre = f'layers.{s}.1.{i}.'
            for ln in ('norm1', 'norm2'):
                (sd[f'{prefix}{pre}{ln}.weight'],
                 sd[f'{prefix}{pre}{ln}.bias']) = _scale_bias(blk[ln])
            attn = blk['attn']
            sd[f'{prefix}{pre}attn.attn.in_proj_weight'] = _t(np.concatenate(
                [np.asarray(attn['q']['kernel']).T,
                 np.asarray(attn['kv']['kernel']).T]))
            if 'bias' in attn['q']:
                sd[f'{prefix}{pre}attn.attn.in_proj_bias'] = _t(
                    np.concatenate([np.asarray(attn['q']['bias']),
                                    np.asarray(attn['kv']['bias'])]))
            put(pre + 'attn.attn.out_proj', attn['proj'],
                _t(np.asarray(attn['proj']['kernel']).T))
            if 'sr' in attn:
                put(pre + 'attn.sr', attn['sr'], _conv(attn['sr']['kernel']))
                (sd[f'{prefix}{pre}attn.norm.weight'],
                 sd[f'{prefix}{pre}attn.norm.bias']) = _scale_bias(attn['sr_norm'])
            ffn = blk['ffn']
            put(pre + 'ffn.layers.0', ffn['fc1'],
                _dense_as_conv1x1(ffn['fc1']['kernel']))
            put(pre + 'ffn.layers.1', ffn['dwconv'],
                _conv(ffn['dwconv']['kernel']))
            put(pre + 'ffn.layers.4', ffn['fc2'],
                _dense_as_conv1x1(ffn['fc2']['kernel']))
            i += 1
        (sd[f'{prefix}layers.{s}.2.weight'],
         sd[f'{prefix}layers.{s}.2.bias']) = _scale_bias(p[f'norm_{s}'])
        s += 1
    return sd


def _segformer(p: Mapping, bs: Mapping, prefix: str) -> StateDict:
    """JAX SegformerHead params + BN statistics -> the mmseg layout (the
    inverse of JAX ``convert_segformer_head``)."""
    sd: StateDict = {}

    def bn(key, name):
        sd[prefix + key + '.bn.weight'], sd[prefix + key + '.bn.bias'] = \
            _scale_bias(p[name])
        if name in bs:
            sd[prefix + key + '.bn.running_mean'] = _t(bs[name]['mean'])
            sd[prefix + key + '.bn.running_var'] = _t(bs[name]['var'])
    i = 0
    while f'convs_{i}' in p:
        sd[f'{prefix}convs.{i}.conv.weight'] = _dense_as_conv1x1(
            p[f'convs_{i}']['kernel'])
        bn(f'convs.{i}', f'convs_{i}_bn')
        i += 1
    if 'fusion_conv' in p:
        sd[prefix + 'fusion_conv.conv.weight'] = _conv(
            p['fusion_conv']['kernel'])
        bn('fusion_conv', 'fusion_bn')
    if 'conv_seg' in p:
        sd[prefix + 'conv_seg.weight'] = _conv(p['conv_seg']['kernel'])
        sd[prefix + 'conv_seg.bias'] = _t(p['conv_seg']['bias'])
    return sd


def _backbone(p: Mapping, prefix: str) -> StateDict:
    return _mit(p, prefix) if 'patch_embed_0' in p else _vit(p, prefix)


def _head(p: Mapping, bs: Mapping, prefix: str) -> StateDict:
    return (_segformer if 'fusion_conv' in p else _setr_up)(p, bs, prefix)


def _index_tree(tree, j: int):
    if isinstance(tree, Mapping):
        return {k: _index_tree(v, j) for k, v in tree.items()}
    return np.asarray(tree)[j]


def state_dict_from_jax_variables(variables: Mapping) -> StateDict:
    """JAX variables tree (numpy leaves) -> reference-layout state dict."""
    params = variables.get('params', variables)
    bs = variables.get('batch_stats', {})
    sd: StateDict = {}
    if 'backbone_m' in params:
        sd.update(_backbone(params['backbone_m'], 'backbone.'))
    if 'decode_head_m' in params:
        sd.update(_head(params['decode_head_m'],
                        bs.get('decode_head_m', {}), 'decode_head.'))
    if 'aux_heads' in params:     # the vmapped stack of identical aux heads
        stacked_p = params['aux_heads']['head']
        stacked_b = bs.get('aux_heads', {}).get('head', {})
        n = np.asarray(stacked_p['conv_seg']['bias']).shape[0]
        for j in range(n):
            sd.update(_setr_up(_index_tree(stacked_p, j),
                               _index_tree(stacked_b, j),
                               f'auxiliary_head.{j}.'))
    j = 0
    while f'aux_heads_{j}' in params:   # unfused per-level aux heads
        sd.update(_setr_up(params[f'aux_heads_{j}'],
                           bs.get(f'aux_heads_{j}', {}),
                           f'auxiliary_head.{j}.'))
        j += 1
    ema = variables.get('ema_params')
    if ema:
        ebs = variables.get('ema_batch_stats', {})
        if 'backbone_m' in ema:
            sd.update(_backbone(ema['backbone_m'], 'backbone_ema.'))
        if 'decode_head_m' in ema:
            sd.update(_head(ema['decode_head_m'],
                            ebs.get('decode_head_m', {}),
                            'decode_head_ema.'))
    return sd


def train_state_dicts_from_jax(jax_state) -> Dict[str, Optional[StateDict]]:
    """A JAX ``TrainState`` (any object with its fields; numpy-convertible
    leaves) -> {'model': params + BN statistics, 'momentum': the SGD buffers
    under the parameter names, 'ema': the teacher's params + BN statistics,
    or None}."""
    model = state_dict_from_jax_variables(
        {'params': jax_state.params, 'batch_stats': jax_state.batch_stats})
    momentum = state_dict_from_jax_variables({'params': jax_state.momentum})
    ema = None
    if jax_state.ema_params is not None:
        ema = state_dict_from_jax_variables(
            {'params': jax_state.ema_params,
             'batch_stats': jax_state.ema_batch_stats or {}})
    return {'model': model, 'momentum': momentum, 'ema': ema}


def resize_pos_embed(pos: torch.Tensor, dst_grid: Tuple[int, int],
                     with_cls: bool = True) -> torch.Tensor:
    """Bicubic pos-embed grid resize on load (reference vit.py:381-395)."""
    grid = pos[:, 1:] if with_cls else pos
    src = int(round(grid.shape[1] ** 0.5))
    if (src, src) == tuple(dst_grid):
        return pos
    t = grid.reshape(1, src, src, -1).permute(0, 3, 1, 2).float()
    t = F.interpolate(t, size=tuple(dst_grid), mode='bicubic',
                      align_corners=False)
    out = t.permute(0, 2, 3, 1).reshape(1, dst_grid[0] * dst_grid[1], -1)
    if with_cls:
        out = torch.cat([pos[:, :1].float(), out], dim=1)
    return out.to(pos.dtype)


_TIMM_LAYER_RENAMES = (('norm1.', 'ln1.'), ('norm2.', 'ln2.'),
                       ('attn.qkv.weight', 'attn.attn.in_proj_weight'),
                       ('attn.qkv.bias', 'attn.attn.in_proj_bias'),
                       ('attn.proj.', 'attn.attn.out_proj.'),
                       ('mlp.fc1.', 'ffn.layers.0.0.'),
                       ('mlp.fc2.', 'ffn.layers.1.'))
_TIMM_RENAMES = {'patch_embed.proj.weight': 'patch_embed.projection.weight',
                 'patch_embed.proj.bias': 'patch_embed.projection.bias',
                 # the final norm: the ViT's ``ln1`` (absent, and so dropped
                 # on load, without ``final_norm``)
                 'norm.weight': 'ln1.weight', 'norm.bias': 'ln1.bias'}


def normalize_backbone_keys(sd: Mapping[str, torch.Tensor]) -> StateDict:
    """Backbone keys (without ``backbone.``) in the timm DeiT layout
    (``blocks.i.attn.qkv.*``, ``patch_embed.proj.*``, ``norm.*``) or the
    OpenMMLab one -> the OpenMMLab (mmseg) names the port's ViT carries
    (JAX ``_normalize_backbone_keys``, checkpoint.py:188-222)."""
    out: StateDict = {}
    for k, v in sd.items():
        if k.startswith('blocks.'):
            k = 'layers.' + k[len('blocks.'):]
        m = re.match(r'layers\.(\d+)\.(.*)', k)
        if m:
            rest = m.group(2)
            for old, new in _TIMM_LAYER_RENAMES:
                rest = rest.replace(old, new)
            k = f'layers.{m.group(1)}.{rest}'
        out[_TIMM_RENAMES.get(k, k)] = v
    return out


# the key that marks an mmseg MiT backbone (JAX convert_backbone's test)
MIT_MARKER = 'layers.0.0.projection.weight'


def _is_bare_backbone(sd: Mapping[str, torch.Tensor]) -> bool:
    """A backbone-only file: no ``backbone.`` key, and ViT keys at the top
    (JAX ``convert_mmseg_checkpoint``, checkpoint.py:2482-2487)."""
    return not any(k.startswith('backbone.') for k in sd) and any(
        k.startswith(('layers.', 'blocks.', 'patch_embed.')) or
        k in ('cls_token', 'pos_embed') for k in sd)


def load_reference_state_dict(path: str,
                              dst_grid: Optional[Tuple[int, int]] = None
                              ) -> StateDict:
    """An mmseg-layout ``.pth`` or a backbone-only DeiT file -> state dict.

    Unwraps ``state_dict``/``model``, strips a ``module.`` prefix and drops
    BN ``num_batches_tracked`` counters. A backbone-only file (bare keys,
    OpenMMLab or timm names) becomes ``backbone.*``; timm names under
    ``backbone.``/``backbone_ema.`` are renamed too, unless the backbone is
    a MiT (``MIT_MARKER``: its ``layers.{s}.1.{i}.norm1`` keys are not
    timm's, JAX ``convert_mmseg_checkpoint`` l.2489). The (EMA) backbone
    pos-embed is resized to ``dst_grid``. Keys the model lacks (DeiT's
    ``head.*`` and ``dist_token``, the final norm) stay in the dict; the
    overlay drops them."""
    obj = torch.load(path, map_location='cpu', weights_only=True)
    for key in ('state_dict', 'model'):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
            break
    raw = {(k[len('module.'):] if k.startswith('module.') else k): v
           for k, v in obj.items() if isinstance(v, torch.Tensor) and
           not k.endswith('num_batches_tracked')}
    if _is_bare_backbone(raw):
        raw = {'backbone.' + k: v for k, v in raw.items()}
    sd: StateDict = {}
    for prefix in ('backbone.', 'backbone_ema.'):
        part = {k[len(prefix):]: v for k, v in raw.items()
                if k.startswith(prefix)}
        if MIT_MARKER not in part:
            part = normalize_backbone_keys(part)
        sd.update({prefix + k: v for k, v in part.items()})
    sd.update({k: v for k, v in raw.items()
               if not k.startswith(('backbone.', 'backbone_ema.'))})
    if dst_grid is not None:
        for k in ('backbone.pos_embed', 'backbone_ema.pos_embed'):
            if k in sd:
                sd[k] = resize_pos_embed(sd[k], dst_grid)
    return sd


def overlay_state_dict(model: torch.nn.Module,
                       sd: Mapping[str, torch.Tensor],
                       source: str = 'the checkpoint') -> Dict[str, int]:
    """Load the entries of ``sd`` that name a tensor of ``model`` over its
    weights; the rest stay as they are. Returns the counts of the model's
    tensors overlaid, in all and in the backbone: ``loaded``, ``total``,
    ``backbone_loaded``, ``backbone_total``. Raises ValueError when ``sd``
    overlays none: a file that loads nothing would train or serve the
    seeded weights."""
    own = model.state_dict()
    hits = {k: v for k, v in sd.items() if k in own}
    if not hits:
        raise ValueError(
            f'{source} overlays none of the model\'s {len(own)} tensors '
            f'(its keys begin {sorted(sd)[:4]}; the model\'s '
            f'{sorted(own)[:4]})')
    model.load_state_dict(hits, strict=False)
    backbone = [k for k in own if k.startswith('backbone.')]
    return {'loaded': len(hits), 'total': len(own),
            'backbone_loaded': sum(k in hits for k in backbone),
            'backbone_total': len(backbone)}


def ema_state_dict(sd: Mapping[str, torch.Tensor]) -> StateDict:
    """The EMA twin's entries (``backbone_ema.*``, ``decode_head_ema.*``)
    under the student's names; empty when the file holds no twin."""
    out: StateDict = {}
    for src, dst in (('backbone_ema.', 'backbone.'),
                     ('decode_head_ema.', 'decode_head.')):
        for k, v in sd.items():
            if k.startswith(src):
                out[dst + k[len(src):]] = v
    return out


# ------------------------------------------------------ training checkpoints
def _host_copy(state) -> Dict[str, Any]:
    """The TrainState's tensors copied to host memory now (a device ->
    host copy waits for the step that wrote them)."""
    def cpu(sd: Mapping[str, torch.Tensor]) -> StateDict:
        return {k: v.detach().to('cpu', copy=True) for k, v in sd.items()}
    annealed = state.annealed_momentum
    return {'step': int(state.step),
            'model': cpu(state.model.state_dict()),
            'momentum': cpu(state.momentum),
            'ema_model': (None if state.ema_model is None
                          else cpu(state.ema_model.state_dict())),
            'annealed_momentum': (None if annealed is None else
                                  annealed.detach().to('cpu', copy=True))}


def _write(payload: Dict[str, Any], target: str) -> None:
    """torch.save to a temporary name, made durable, then renamed: a
    process killed mid-write leaves no ``target``."""
    tmp = target + '.tmp'
    with open(tmp, 'wb') as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, target)


class _AsyncSaver:
    """At most one checkpoint write in flight.

    ``save`` copies the state to host memory before it returns, so the
    step loop may go on changing the state; a thread writes the copy. The
    meta file and the pruning of old checkpoints, which must see a
    complete checkpoint, run at ``finalize``: on the next save, or when
    the caller asks (the JAX module's orbax contract, l.30-79)."""

    def __init__(self):
        self._pending = None  # (thread, errors, work_dir, path, meta, keep)

    def save(self, work_dir: str, step: int, state, keep: int,
             meta: Optional[Dict], block: bool) -> str:
        self.finalize()
        path = osp.abspath(osp.join(work_dir, f'iter_{step}'))
        os.makedirs(path, exist_ok=True)
        payload = _host_copy(state)
        errors: List[BaseException] = []

        def write():
            try:
                _write(payload, osp.join(path, STATE_FILE))
            except Exception as e:  # re-raised by finalize
                errors.append(e)
        thread = threading.Thread(target=write, name='s4-checkpoint')
        thread.start()
        self._pending = (thread, errors, work_dir, path, meta, keep)
        if block:
            self.finalize()
        return path

    def finalize(self) -> Optional[str]:
        """Wait for the write in flight (if any), then write its meta and
        prune old checkpoints. Returns the finished path or None."""
        if self._pending is None:
            return None
        thread, errors, work_dir, path, meta, keep = self._pending
        self._pending = None
        thread.join()
        if errors:
            raise RuntimeError(f'checkpoint write to {path} failed') \
                from errors[0]
        if meta:
            with open(osp.join(path, META_FILE), 'w') as f:
                json.dump(meta, f)
        _prune_old_checkpoints(work_dir, keep)
        return path


_SAVER = _AsyncSaver()


def save_checkpoint(work_dir: str, step: int, state, keep: int = 3,
                    meta: Optional[Dict] = None, block: bool = True) -> str:
    """Save a ``TrainState`` under work_dir/iter_{step}. ``block=False``
    returns once the state is on the host; the write finishes in the
    background (finalized by the next save or ``finalize_pending_saves``)."""
    return _SAVER.save(work_dir, step, state, keep, meta, block)


def finalize_pending_saves() -> Optional[str]:
    """Barrier for the checkpoint write in flight (before exit, or before
    reading back the checkpoint just written)."""
    return _SAVER.finalize()


def _prune_old_checkpoints(work_dir: str, keep: int):
    ckpts = find_all_checkpoints(work_dir)
    for path, _ in ckpts[:-keep] if keep > 0 else []:
        shutil.rmtree(path, ignore_errors=True)


def find_all_checkpoints(work_dir: str) -> List[Tuple[str, int]]:
    """COMPLETE checkpoints under work_dir, sorted by step: ``iter_N``
    directories holding ``state.pt``. A write in flight or killed holds
    only ``state.pt.tmp`` and is skipped (reference utils/misc.py:7-41)."""
    out = []
    if not osp.isdir(work_dir):
        return out
    for name in os.listdir(work_dir):
        m = re.fullmatch(r'iter_(\d+)', name)
        if m and osp.isfile(osp.join(work_dir, name, STATE_FILE)):
            out.append((osp.join(work_dir, name), int(m.group(1))))
    return sorted(out, key=lambda x: x[1])


def find_latest_checkpoint(work_dir: str) -> Optional[str]:
    """Auto-resume discovery (reference utils/misc.py:7-41)."""
    ckpts = find_all_checkpoints(work_dir)
    return ckpts[-1][0] if ckpts else None


def load_checkpoint(path: str, target_state=None):
    """The checkpoint at ``path`` (an ``iter_N`` directory). With
    ``target_state``, its modules, SGD buffers, step and annealed momentum
    are loaded onto the state's own device and the state is returned;
    without, the raw dict of CPU tensors."""
    file = osp.join(path, STATE_FILE)
    if target_state is None:
        return torch.load(file, map_location='cpu', weights_only=True)
    device = target_state.step.device
    raw = torch.load(file, map_location=device, weights_only=True)
    target_state.model.load_state_dict(raw['model'])
    if (raw['ema_model'] is None) != (target_state.ema_model is None):
        raise ValueError(f'{path}: the EMA teacher is in one of the '
                         f'checkpoint and the state, not both')
    if target_state.ema_model is not None:
        target_state.ema_model.load_state_dict(raw['ema_model'])
    if raw['momentum'].keys() != target_state.momentum.keys():
        raise ValueError(f'{path}: SGD buffers of other parameters')
    for name, buf in target_state.momentum.items():
        buf.copy_(raw['momentum'][name])
    return dataclasses.replace(
        target_state,
        step=torch.tensor(raw['step'], dtype=torch.int64, device=device),
        annealed_momentum=raw['annealed_momentum'])


def load_model_state_dict(path: str) -> StateDict:
    """The student's state dict (parameters and BN statistics) of a
    training checkpoint, for evaluation."""
    return load_checkpoint(path)['model']
