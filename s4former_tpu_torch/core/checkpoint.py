"""Weight bridge (counterpart of the torch-facing half of
``s4former_tpu/core/checkpoint.py``).

The port's modules carry the reference (mmseg) parameter names, so its
``state_dict`` is the reference layout:

- ``state_dict_from_jax_variables(variables)``: the JAX package's
  ``{'params', 'batch_stats'[, 'ema_params', 'ema_batch_stats']}`` tree, as
  numpy arrays, -> reference-layout tensors. It unstacks the scanned ViT
  layers and the vmapped aux heads and transposes dense and conv kernels.
  Same keys and values as JAX ``export_reference_state_dict`` (l.2739) for
  the ViT and SETR-PUP; for the MiT, the MLA neck and the SegFormer, FCN,
  SETR-MLA and Segmenter heads it inverts JAX's ``convert_*`` functions
  (l.283, 1657, 911, 959, 1680, 1609), which
  ``convert_mmseg_checkpoint`` applies. (JAX's export writes no neck,
  and of those heads only ``conv_seg``.) Likewise for the CNN slice: the
  ResNets (``convert_resnet_backbone``, l.503; the shortcut lands at
  ``downsample.0``/``.1``: the JAX tree does not tell V1d's, whose
  reference keys are ``.1``/``.2``, from V1c's, and no config uses V1d), ICNet
  (l.1412), the PSP (l.998), DeepLabV3+ (``convert_aspp_head``, l.1074),
  FPN (l.1787) and CC (l.1591) heads and the FPN (l.1772) and IC (l.1756)
  necks; and for the Swin/HRNet slice: ResNeXt (ResNet's keys), ResNeSt
  (l.560), Swin (l.364; PatchMerging's 4C axis back to mmseg's
  channel-major order, and a shrunk window's table at the centre of the
  window's), HRNet (l.694), the UPer (l.1019) and OCR (l.2225) heads and a
  cascade's stages (``cascade_heads_{i}`` -> ``decode_head.{i}.``). The
  aux heads that JAX builds one by one in ``aux_logits`` (identical heads
  on levels of different shapes, ICNet's) arrive as ``{Type}_{j}`` and
  land at ``auxiliary_head.{j}.``.
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
``load_checkpoint``. Orbax directories need JAX and are not read here. A
state split by tensor parallelism or ZeRO-3 is written whole: every rank
joins the gather (``host_state``), then rank 0 alone copies and writes;
``load_checkpoint`` cuts the whole tensors to the target's split.
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

from s4former_tpu_torch.parallel.tp import (shard_state_dict,
                                            unshard_state_dict)

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
    if 'ln_final' in p:        # final_norm: mmseg's ln1
        sd[prefix + 'ln1.weight'] = _t(p['ln_final']['scale'])
        sd[prefix + 'ln1.bias'] = _t(p['ln_final']['bias'])
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
                if 'bias' in leaf:      # qkv_bias=False has none
                    sd[f'{pre}{key}{sep}bias'] = _t(leaf['bias'][i])
    return sd


def _conv_bn_pair(c: Mapping, stats: Mapping, conv_key: str,
                  bn_key: str) -> StateDict:
    """A JAX ``ConvBNReLU`` / ``ConvBN`` (``conv`` kernel, ``bn``
    scale/bias; its BN statistics, if any) -> the conv's and the BN's
    reference keys."""
    sd = {conv_key + '.weight': _conv(c['conv']['kernel']),
          bn_key + '.weight': _t(c['bn']['scale']),
          bn_key + '.bias': _t(c['bn']['bias'])}
    stats = stats.get('bn', {})
    if stats:
        sd[bn_key + '.running_mean'] = _t(stats['mean'])
        sd[bn_key + '.running_var'] = _t(stats['var'])
    return sd


def _convbn(c: Mapping, stats: Mapping, pre: str) -> StateDict:
    """A JAX ``ConvBNReLU`` -> mmcv ``ConvModule`` keys under ``pre``."""
    return _conv_bn_pair(c, stats, pre + 'conv', pre + 'bn')


def _sepconv(c: Mapping, stats: Mapping, pre: str) -> StateDict:
    """JAX ``SepConvBNReLU`` -> mmcv ``DepthwiseSeparableConvModule`` keys
    (the inverse of JAX ``_sepconvmodule``)."""
    sd = {}
    for conv, bn, ref in (('depthwise', 'dw_bn', 'depthwise_conv'),
                          ('pointwise', 'pw_bn', 'pointwise_conv')):
        sd.update(_convbn({'conv': c[conv], 'bn': c[bn]},
                          {'bn': stats.get(bn, {})}, f'{pre}{ref}.'))
    return sd


def _resnet(p: Mapping, bs: Mapping, prefix: str) -> StateDict:
    """JAX ResNet(V1c/V1d) -> the mmseg layout (the inverse of JAX
    ``convert_resnet_backbone``): ``stem{n}`` -> ``stem.{0,3,6}`` convs and
    ``stem.{1,4,7}`` BNs, or ``stem`` -> ``conv1``/``bn1``;
    ``layer{s}_{j}`` -> ``layer{s}.{j}.conv{c}``/``bn{c}`` and the
    shortcut at ``downsample.0``/``.1``."""
    sd: StateDict = {}
    if 'stem1' in p:
        for n in (1, 2, 3):
            sd.update(_conv_bn_pair(p[f'stem{n}'], bs.get(f'stem{n}', {}),
                                    f'{prefix}stem.{3 * n - 3}',
                                    f'{prefix}stem.{3 * n - 2}'))
    elif 'stem' in p:
        sd.update(_conv_bn_pair(p['stem'], bs.get('stem', {}),
                                prefix + 'conv1', prefix + 'bn1'))
    for name, blk in p.items():
        m = re.fullmatch(r'layer(\d+)_(\d+)', name)
        if m is not None:
            sd.update(_block(blk, bs.get(name, {}),
                             f'{prefix}layer{m.group(1)}.{m.group(2)}.'))
    return sd


def _block(blk: Mapping, stats: Mapping, pre: str) -> StateDict:
    """A JAX ResNet block (``conv{c}`` ConvBNs, ``downsample``) -> the
    reference's ``conv{c}``/``bn{c}`` and ``downsample.0``/``.1``."""
    sd: StateDict = {}
    for c in (1, 2, 3):
        if f'conv{c}' in blk:
            sd.update(_conv_bn_pair(blk[f'conv{c}'], stats.get(f'conv{c}', {}),
                                    f'{pre}conv{c}', f'{pre}bn{c}'))
    if 'downsample' in blk:
        sd.update(_conv_bn_pair(blk['downsample'], stats.get('downsample', {}),
                                f'{pre}downsample.0', f'{pre}downsample.1'))
    return sd


def _norm(p: Mapping, key: str, stats: Optional[Mapping] = None
          ) -> StateDict:
    """A flax LayerNorm or bare BatchNorm (scale, bias; a BN's statistics,
    if any) -> ``weight``, ``bias`` (``running_mean``, ``running_var``)."""
    sd = {key + '.weight': _t(p['scale']), key + '.bias': _t(p['bias'])}
    if stats:
        sd[key + '.running_mean'] = _t(stats['mean'])
        sd[key + '.running_var'] = _t(stats['var'])
    return sd


def _resnest(p: Mapping, bs: Mapping, prefix: str) -> StateDict:
    """JAX cnn_zoo.ResNeSt -> the mmseg layout (the inverse of JAX
    ``convert_resnest_backbone``, l.560): ResNet's stem and ``conv1``/
    ``conv3``; the split attention's ``conv2`` kernel, ``bn0``, ``fc1``,
    ``bn1``, ``fc2`` under ``conv2.``; the V1d shortcut at
    ``downsample.1``/``.2``."""
    sd = _resnet({k: v for k, v in p.items() if k.startswith('stem')}, bs,
                 prefix)
    for name, blk in p.items():
        m = re.fullmatch(r'layer(\d+)_(\d+)', name)
        if m is None:
            continue
        pre = f'{prefix}layer{m.group(1)}.{m.group(2)}.'
        stats = bs.get(name, {})
        for c in (1, 3):
            sd.update(_conv_bn_pair(blk[f'conv{c}'], stats.get(f'conv{c}', {}),
                                    f'{pre}conv{c}', f'{pre}bn{c}'))
        sd[pre + 'conv2.conv.weight'] = _conv(blk['conv2']['kernel'])
        for b in ('bn0', 'bn1'):
            sd.update(_norm(blk[b], f'{pre}conv2.{b}', stats.get(b)))
        for fc in ('fc1', 'fc2'):
            sd[f'{pre}conv2.{fc}.weight'] = _conv(blk[fc]['kernel'])
            sd[f'{pre}conv2.{fc}.bias'] = _t(blk[fc]['bias'])
        if 'downsample' in blk:
            sd.update(_conv_bn_pair(blk['downsample'],
                                    stats.get('downsample', {}),
                                    f'{pre}downsample.1',
                                    f'{pre}downsample.2'))
    return sd


def _dense(p: Mapping, key: str) -> StateDict:
    """A flax Dense (kernel [in, out], bias if any) -> a torch Linear."""
    sd = {key + '.weight': _t(np.asarray(p['kernel']).T)}
    if 'bias' in p:
        sd[key + '.bias'] = _t(p['bias'])
    return sd


def _rpb_tables(p: Mapping) -> Dict[str, np.ndarray]:
    """Each Swin block's relative-position table in the window's layout:
    JAX sizes a block's table by the window it ran at, smaller than the
    configured one where the grid was (``min(window_size, h, w)``); the
    largest table names the configured window, and a smaller one fills
    its central offsets (the port's ``WindowAttention`` reads those)."""
    tables = {k: np.asarray(v['attn']['relative_position_bias_table'])
              for k, v in p.items() if k.startswith('stage_')}
    if not tables:
        return {}
    span = int(round(max(t.shape[0] for t in tables.values()) ** 0.5))
    out = {}
    for k, t in tables.items():
        n = int(round(t.shape[0] ** 0.5))
        full = np.zeros((span, span, t.shape[1]), t.dtype)
        o = (span - n) // 2
        full[o:o + n, o:o + n] = t.reshape(n, n, -1)
        out[k] = full.reshape(span * span, -1)
    return out


def _swin(p: Mapping, prefix: str) -> StateDict:
    """JAX SwinTransformer -> the mmseg layout (the inverse of JAX
    ``convert_swin_backbone``, l.364): PatchMerging's 4C axis back to
    ``nn.Unfold``'s channel-major order."""
    sd: StateDict = {}
    if 'patch_embed' in p:
        sd[prefix + 'patch_embed.projection.weight'] = _conv(
            p['patch_embed']['kernel'])
        sd[prefix + 'patch_embed.projection.bias'] = _t(
            p['patch_embed']['bias'])
    if 'patch_norm' in p:
        sd.update(_norm(p['patch_norm'], prefix + 'patch_embed.norm'))
    tables = _rpb_tables(p)
    for name, blk in p.items():
        m = re.fullmatch(r'stage_(\d+)_block_(\d+)', name)
        if m is not None:
            pre = f'{prefix}stages.{m.group(1)}.blocks.{m.group(2)}.'
            sd.update(_norm(blk['norm1'], pre + 'norm1'))
            sd.update(_norm(blk['norm2'], pre + 'norm2'))
            sd.update(_dense(blk['attn']['qkv'], pre + 'attn.w_msa.qkv'))
            sd.update(_dense(blk['attn']['proj'], pre + 'attn.w_msa.proj'))
            sd[pre + 'attn.w_msa.relative_position_bias_table'] = _t(
                tables[name])
            sd.update(_dense(blk['fc1'], pre + 'ffn.layers.0.0'))
            sd.update(_dense(blk['fc2'], pre + 'ffn.layers.1'))
            continue
        m = re.fullmatch(r'(merge_norm|merge|out_norm)_(\d+)', name)
        if m is None:
            continue
        kind, stage = m.groups()
        if kind == 'out_norm':
            sd.update(_norm(blk, f'{prefix}norm{stage}'))
            continue
        # JAX index j = pos * C + c holds the reference's c * 4 + pos
        c4 = np.asarray(blk['kernel' if kind == 'merge' else 'scale']
                        ).shape[0]
        c = c4 // 4
        perm = np.asarray([(j % c) * 4 + j // c for j in range(c4)])
        pre = f'{prefix}stages.{stage}.downsample.'
        if kind == 'merge':
            kernel = np.asarray(blk['kernel'])             # [4C, 2C]
            red = np.empty((kernel.shape[1], c4), kernel.dtype)
            red[:, perm] = kernel.T
            sd[pre + 'reduction.weight'] = _t(red)
        else:
            for leaf, ref in (('scale', 'weight'), ('bias', 'bias')):
                v = np.asarray(blk[leaf])
                out = np.empty_like(v)
                out[perm] = v
                sd[f'{pre}norm.{ref}'] = _t(out)
    return sd


def _hrnet(p: Mapping, bs: Mapping, prefix: str) -> StateDict:
    """JAX HRNet -> the mmseg layout (the inverse of JAX
    ``convert_hrnet_backbone``, l.694): ``layer1_{k}`` and
    ``stage{s}_m{m}_br{b}_b{k}`` blocks as ResNet's; ``transition{t}_{i}
    [_{j}]`` and ``stage{s}_m{m}_fuse_{i}_{j}[_{k}]`` ConvBNs at the
    reference's ``Sequential`` indices (``.0`` conv, ``.1`` BN)."""
    sd: StateDict = {}
    for n in (1, 2):
        sd.update(_conv_bn_pair(p[f'conv{n}'], bs.get(f'conv{n}', {}),
                                f'{prefix}conv{n}', f'{prefix}bn{n}'))
    blocks = {}
    for name, c in p.items():
        m = re.fullmatch(r'layer1_(\d+)', name)
        if m is not None:
            blocks[name] = f'layer1.{m.group(1)}'
            continue
        m = re.fullmatch(r'stage(\d)_m(\d+)_br(\d+)_b(\d+)', name)
        if m is not None:
            s_, mod, b, k = m.groups()
            blocks[name] = f'stage{s_}.{mod}.branches.{b}.{k}'
            continue
        m = (re.fullmatch(r'transition(\d)_(\d+)((?:_\d+)?)', name) or
             re.fullmatch(r'stage(\d)_m(\d+)_fuse_(\d+)_(\d+)((?:_\d+)?)',
                          name))
        if m is None:
            continue
        if name.startswith('transition'):
            t, i, j = m.groups()
            key = f'transition{t}.{i}' + j.replace('_', '.')
        else:
            s_, mod, i, j, k = m.groups()
            key = f'stage{s_}.{mod}.fuse_layers.{i}.{j}' + k.replace('_', '.')
        sd.update(_conv_bn_pair(c, bs.get(name, {}), f'{prefix}{key}.0',
                                f'{prefix}{key}.1'))
    for name, key in blocks.items():
        sd.update(_block(p[name], bs.get(name, {}), f'{prefix}{key}.'))
    return sd


def _icnet(p: Mapping, bs: Mapping, prefix: str) -> StateDict:
    """JAX cnn_zoo.ICNet -> the mmseg layout (the inverse of JAX
    ``convert_icnet_backbone``, l.1412)."""
    sd = _resnet(p['backbone'], bs.get('backbone', {}), prefix + 'backbone.')
    for ours, ref in ([(f'conv_sub1_{i}', f'conv_sub1.{i}') for i in range(3)]
                      + [('conv_sub2', 'conv_sub2'), ('conv_sub4', 'conv_sub4'),
                         ('psp_bottleneck', 'psp_bottleneck')]):
        sd.update(_convbn(p[ours], bs.get(ours, {}), f'{prefix}{ref}.'))
    i = 0
    while f'psp_{i}' in p:
        sd.update(_convbn(p[f'psp_{i}'], bs.get(f'psp_{i}', {}),
                          f'{prefix}psp_modules.{i}.1.'))
        i += 1
    return sd


def _conv_seg(p: Mapping, prefix: str) -> StateDict:
    if 'conv_seg' not in p:
        return {}
    return {prefix + 'conv_seg.weight': _conv(p['conv_seg']['kernel']),
            prefix + 'conv_seg.bias': _t(p['conv_seg']['bias'])}


def _setr_up(p: Mapping, bs: Mapping, prefix: str) -> StateDict:
    sd: StateDict = {}
    if 'norm' in p:
        sd[prefix + 'norm.weight'] = _t(p['norm']['scale'])
        sd[prefix + 'norm.bias'] = _t(p['norm']['bias'])
    i = 0
    while f'up_convs_{i}' in p:
        sd.update(_convbn(p[f'up_convs_{i}'], bs.get(f'up_convs_{i}', {}),
                          f'{prefix}up_convs.{i}.0.'))
        i += 1
    sd.update(_conv_seg(p, prefix))
    return sd


def _convbns(p: Mapping, bs: Mapping, prefix: str,
             names: Mapping[str, str]) -> StateDict:
    """The ConvBNReLUs of ``names`` (JAX name -> reference key) present
    in ``p``."""
    sd: StateDict = {}
    for ours, ref in names.items():
        if ours in p:
            sd.update(_convbn(p[ours], bs.get(ours, {}), f'{prefix}{ref}.'))
    return sd


def _uper(p: Mapping, bs: Mapping, prefix: str) -> StateDict:
    """JAX misc_heads.UPerHead -> the mmseg layout (the inverse of JAX
    ``convert_uper_head``, l.1019)."""
    names = {'psp_bottleneck': 'bottleneck',
             'fpn_bottleneck': 'fpn_bottleneck'}
    for name in p:
        m = re.fullmatch(r'(psp|lateral|fpn)_(\d+)', name)
        if m is not None:
            kind, i = m.groups()
            names[name] = {'psp': f'psp_modules.{i}.1',
                           'lateral': f'lateral_convs.{i}',
                           'fpn': f'fpn_convs.{i}'}[kind]
    sd = _convbns(p, bs, prefix, names)
    sd.update(_conv_seg(p, prefix))
    return sd


def _ocr(p: Mapping, bs: Mapping, prefix: str) -> StateDict:
    """JAX misc_heads.OCRHead -> the mmseg layout (the inverse of JAX
    ``convert_ocr_head``, l.2225)."""
    ocb = 'object_context_block.'
    sd = _convbns(p, bs, prefix, {
        'bottleneck': 'bottleneck',
        'ocb_query_0': ocb + 'query_project.0',
        'ocb_query_1': ocb + 'query_project.1',
        'ocb_key_0': ocb + 'key_project.0',
        'ocb_key_1': ocb + 'key_project.1',
        'ocb_value': ocb + 'value_project',
        'ocb_out': ocb + 'out_project',
        'ocb_bottleneck': ocb + 'bottleneck'})
    sd.update(_conv_seg(p, prefix))
    return sd


def _fcn(p: Mapping, bs: Mapping, prefix: str) -> StateDict:
    """JAX misc_heads.FCNHead -> the mmseg layout (the inverse of JAX
    ``convert_fcn_head``, l.959)."""
    sd: StateDict = {}
    names = [f'convs_{i}' for i in range(len(p)) if f'convs_{i}' in p]
    for name in names + (['conv_cat'] if 'conv_cat' in p else []):
        key = name.replace('convs_', 'convs.')
        sd.update(_convbn(p[name], bs.get(name, {}), f'{prefix}{key}.'))
    sd.update(_conv_seg(p, prefix))
    return sd


def _psp(p: Mapping, bs: Mapping, prefix: str) -> StateDict:
    """JAX misc_heads.PSPHead -> the mmseg layout (the inverse of JAX
    ``convert_psp_head``, l.998)."""
    sd: StateDict = {}
    i = 0
    while f'pool_conv_{i}' in p:
        sd.update(_convbn(p[f'pool_conv_{i}'], bs.get(f'pool_conv_{i}', {}),
                          f'{prefix}psp_modules.{i}.1.'))
        i += 1
    sd.update(_convbn(p['bottleneck'], bs.get('bottleneck', {}),
                      prefix + 'bottleneck.'))
    sd.update(_conv_seg(p, prefix))
    return sd


def _aspp(p: Mapping, bs: Mapping, prefix: str) -> StateDict:
    """JAX zoo_heads.DepthwiseSeparableASPPHead -> the mmseg layout (the
    inverse of JAX ``convert_aspp_head``, l.1074)."""
    sd: StateDict = {}
    names = [('image_pool', 'image_pool.1'), ('bottleneck', 'bottleneck'),
             ('c1_bottleneck', 'c1_bottleneck')]
    names += [(f'aspp_{i}', f'aspp_modules.{i}') for i in range(len(p))]
    names += [(f'sep_fuse_{j}', f'sep_bottleneck.{j}') for j in (0, 1)]
    for ours, ref in names:
        if ours not in p:
            continue
        put = _sepconv if 'depthwise' in p[ours] else _convbn
        sd.update(put(p[ours], bs.get(ours, {}), f'{prefix}{ref}.'))
    sd.update(_conv_seg(p, prefix))
    return sd


def _fpn_head(p: Mapping, bs: Mapping, prefix: str) -> StateDict:
    """JAX extra_heads.FPNHead -> the mmseg layout (the inverse of JAX
    ``convert_fpn_head``, l.1787): ``scale_heads_{i}_{k}`` ->
    ``scale_heads.{i}.{2k}``. A level's k-th conv sits at 2k between the
    upsamples; a level without upsamples (the finest) has one conv, at
    0."""
    sd: StateDict = {}
    for name, c in p.items():
        m = re.fullmatch(r'scale_heads_(\d+)_(\d+)', name)
        if m is not None:
            sd.update(_convbn(c, bs.get(name, {}), f'{prefix}scale_heads.'
                              f'{m.group(1)}.{2 * int(m.group(2))}.'))
    sd.update(_conv_seg(p, prefix))
    return sd


def _cc(p: Mapping, bs: Mapping, prefix: str) -> StateDict:
    """JAX extra_heads.CCHead -> the mmseg layout (the inverse of JAX
    ``convert_cc_head``, l.1591): the FCN keys and ``cca.{query,key,
    value}_conv``, ``cca.gamma.scale`` (0-dimensional)."""
    sd = _fcn(p, bs, prefix)
    cca = p['cca']
    for name in ('query', 'key', 'value'):
        sd[f'{prefix}cca.{name}_conv.weight'] = _conv(cca[name]['kernel'])
        sd[f'{prefix}cca.{name}_conv.bias'] = _t(cca[name]['bias'])
    sd[f'{prefix}cca.gamma.scale'] = _t(np.asarray(cca['gamma'],
                                                   np.float32).reshape(()))
    return sd


def _fpn_neck(p: Mapping, prefix: str) -> StateDict:
    """JAX necks.FPN -> the mmseg layout (the inverse of JAX
    ``convert_fpn_neck``, l.1772)."""
    sd: StateDict = {}
    for ours, ref in (('lateral', 'lateral_convs'), ('fpn', 'fpn_convs')):
        i = 0
        while f'{ours}_{i}' in p:
            pre = f'{prefix}{ref}.{i}.conv.'
            sd[pre + 'weight'] = _conv(p[f'{ours}_{i}']['kernel'])
            sd[pre + 'bias'] = _t(p[f'{ours}_{i}']['bias'])
            i += 1
    return sd


def _ic_neck(p: Mapping, bs: Mapping, prefix: str) -> StateDict:
    """JAX necks.ICNeck -> the mmseg layout (the inverse of JAX
    ``convert_ic_neck``, l.1756)."""
    sd: StateDict = {}
    for cff in ('cff_24', 'cff_12'):
        for sub in ('conv_low', 'conv_high'):
            sd.update(_convbn(p[cff][sub], bs.get(cff, {}).get(sub, {}),
                              f'{prefix}{cff}.{sub}.'))
    return sd


def _neck(p: Mapping, bs: Mapping, prefix: str) -> StateDict:
    if 'cff_24' in p:
        return _ic_neck(p, bs, prefix)
    if 'lateral_0' in p:
        return _fpn_neck(p, prefix)
    return _mla_neck(p, prefix)


def _setr_mla(p: Mapping, bs: Mapping, prefix: str) -> StateDict:
    """JAX misc_heads.SETRMLAHead -> the mmseg layout (the inverse of JAX
    ``convert_setr_mla_head``, l.1680)."""
    sd: StateDict = {}
    i = 0
    while f'up_conv_{i}_a' in p:
        for j, part in enumerate('ab'):
            name = f'up_conv_{i}_{part}'
            sd.update(_convbn(p[name], bs.get(name, {}),
                              f'{prefix}up_convs.{i}.{j}.'))
        i += 1
    sd.update(_conv_seg(p, prefix))
    return sd


def _layer(blk: Mapping, pre: str) -> StateDict:
    """One unstacked JAX ``TransformerEncoderLayer`` -> the mmcv layer's
    keys under ``pre``."""
    sd: StateDict = {}
    for ln in ('ln1', 'ln2'):
        sd[f'{pre}{ln}.weight'] = _t(blk[ln]['scale'])
        sd[f'{pre}{ln}.bias'] = _t(blk[ln]['bias'])
    dense = {'attn.attn.in_proj_': blk['attn']['qkv'],
             'attn.attn.out_proj.': blk['attn']['proj'],
             'ffn.layers.0.0.': blk['ffn']['fc1'],
             'ffn.layers.1.': blk['ffn']['fc2']}
    for key, leaf in dense.items():
        # torch MHA names its fused qkv in_proj_weight/in_proj_bias
        sd[f'{pre}{key}weight'] = _t(np.asarray(leaf['kernel']).T)
        if 'bias' in leaf:      # qkv_bias=False has none
            sd[f'{pre}{key}bias'] = _t(leaf['bias'])
    return sd


def _segmenter(p: Mapping, prefix: str) -> StateDict:
    """JAX extra_heads.SegmenterMaskTransformerHead -> the mmseg layout
    (the inverse of JAX ``convert_segmenter_mask_head``, l.1609)."""
    sd: StateDict = {prefix + 'cls_emb': _t(p['cls_emb'])}
    for name in ('dec_proj', 'patch_proj', 'classes_proj'):
        sd[f'{prefix}{name}.weight'] = _t(np.asarray(p[name]['kernel']).T)
        if 'bias' in p[name]:
            sd[f'{prefix}{name}.bias'] = _t(p[name]['bias'])
    for name in ('decoder_norm', 'mask_norm'):
        sd[f'{prefix}{name}.weight'], sd[f'{prefix}{name}.bias'] = \
            _scale_bias(p[name])
    i = 0
    while f'layers_{i}' in p:
        sd.update(_layer(p[f'layers_{i}'], f'{prefix}layers.{i}.'))
        i += 1
    return sd


def _mla_neck(p: Mapping, prefix: str) -> StateDict:
    """JAX necks.MLANeck -> the mmseg layout (the inverse of JAX
    ``convert_mla_neck``, l.1657)."""
    sd: StateDict = {}
    i = 0
    while f'norm_{i}' in p:
        sd[f'{prefix}norm.{i}.weight'], sd[f'{prefix}norm.{i}.bias'] = \
            _scale_bias(p[f'norm_{i}'])
        i += 1
    for ours, ref in (('proj', 'mla.channel_proj'),
                      ('feat', 'mla.feat_extract')):
        i = 0
        while f'{ours}_{i}' in p:
            pre = f'{prefix}{ref}.{i}.conv.'
            sd[pre + 'weight'] = _conv(p[f'{ours}_{i}']['kernel'])
            sd[pre + 'bias'] = _t(p[f'{ours}_{i}']['bias'])
            i += 1
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


def _plain(leaf: Mapping, key: str) -> StateDict:
    """A bare flax conv (kernel, maybe bias) -> ``key.weight`` (``.bias``)."""
    sd = {key + '.weight': _conv(leaf['kernel'])}
    if 'bias' in leaf:
        sd[key + '.bias'] = _t(leaf['bias'])
    return sd


def _arm(p: Mapping, bs: Mapping, pre: str) -> StateDict:
    """JAX ``AttentionRefinement`` -> ``conv_layer`` and
    ``atten_conv_layer.1``."""
    sd = _convbn(p['conv'], bs.get('conv', {}), pre + 'conv_layer.')
    sd.update(_convbn({'conv': p['gate_conv'], 'bn': p['gate_bn']},
                      {'bn': bs.get('gate_bn', {})},
                      pre + 'atten_conv_layer.1.'))
    return sd


def _bisenetv1(p: Mapping, bs: Mapping, prefix: str) -> StateDict:
    """JAX cnn_zoo.BiSeNetV1 -> the mmseg layout (the inverse of JAX
    ``convert_bisenetv1_backbone``, l.1537)."""
    cp = prefix + 'context_path.'
    sd = _resnet(p['context_backbone'], bs.get('context_backbone', {}),
                 cp + 'backbone.')
    sd.update(_convbns(p, bs, prefix, {
        **{f'spatial_{i}': f'spatial_path.layer{i + 1}' for i in range(4)},
        'refine32': 'context_path.conv_head32',
        'refine16': 'context_path.conv_head16',
        'gap_conv': 'context_path.gap_conv.1'}))
    for arm in ('arm16', 'arm32'):
        sd.update(_arm(p[arm], bs.get(arm, {}), f'{cp}{arm}.'))
    sd.update(_convbns(p['ffm'], bs.get('ffm', {}), prefix + 'ffm.',
                       {'conv': 'conv1', 'atten': 'conv_atten.0'}))
    return sd


def _bisenetv2(p: Mapping, bs: Mapping, prefix: str) -> StateDict:
    """JAX cnn_zoo.BiSeNetV2 -> the mmseg layout (the inverse of JAX
    ``convert_bisenetv2_backbone``, l.1115)."""
    names = {'stem_first': 'semantic.stage1.conv_first',
             'stem_convs_0': 'semantic.stage1.convs.0',
             'stem_convs_1': 'semantic.stage1.convs.1',
             'stem_fuse': 'semantic.stage1.fuse_last',
             'bga_detail_dw': 'bga.detail_dwconv.0.depthwise_conv',
             'bga_detail_down': 'bga.detail_down.0',
             'bga_semantic_conv': 'bga.semantic_conv.0',
             'bga_semantic_dw': 'bga.semantic_dwconv.0.depthwise_conv',
             'bga_conv': 'bga.conv'}
    ge = {'conv1': 'conv1', 'dwconv_0': 'dwconv.0', 'dwconv_1': 'dwconv.1',
          'conv2': 'conv2.0', 'short_dw': 'shortcut.0.depthwise_conv',
          'short_pw': 'shortcut.0.pointwise_conv'}
    sd: StateDict = {}
    last = 1
    for name in p:
        m = re.fullmatch(r'detail_(\d+)_(\d+)', name)
        if m is not None:
            names[name] = 'detail.detail_branch.{}.{}'.format(*m.groups())
        m = re.fullmatch(r'stage(\d+)_(\d+)', name)
        if m is not None:       # a GE layer of semantic stage 2, 3, ...
            last = max(last, int(m.group(1)))
            sd.update(_convbns(p[name], bs.get(name, {}), '{}semantic.stage'
                               '{}.{}.'.format(prefix, *m.groups()), ge))
    ce = f'semantic.stage{last}_CEBlock.'
    names.update(ce_conv_gap=ce + 'conv_gap', ce_conv_last=ce + 'conv_last')
    sd.update(_convbns(p, bs, prefix, names))
    sd.update(_norm(p['ce_gap_bn'], prefix + ce + 'gap.1',
                    bs.get('ce_gap_bn')))
    for ours, ref in (('bga_detail_pw', 'bga.detail_dwconv.0'),
                      ('bga_semantic_pw', 'bga.semantic_dwconv.0')):
        sd.update(_plain(p[ours], f'{prefix}{ref}.pointwise_conv.conv'))
    return sd


def _stdc_net(p: Mapping, bs: Mapping, prefix: str) -> StateDict:
    """JAX cnn_zoo.STDCNet -> the mmseg layout (the inverse of JAX
    ``convert_stdc_backbone``, l.1442). An ``add`` module's downsample
    sits at both ``layers.0.1`` and ``downsample``, as the reference
    shares it."""
    sd = _convbns(p, bs, prefix, {'stages_0': 'stages.0',
                                  'stages_1': 'stages.1',
                                  'final_conv': 'final_conv'})
    for name, mp in p.items():
        m = re.fullmatch(r'stages_(\d+)_(\d+)', name)
        if m is None:
            continue
        pre = '{}stages.{}.{}.'.format(prefix, *m.groups())
        mb = bs.get(name, {})
        add = 'skip_0' in mp
        names = {f'layers_{k}': f'layers.{k}' for k in range(1, len(mp))}
        names.update(layers_0='layers.0.0' if add else 'layers.0',
                     downsample='downsample', skip_0='skip.0',
                     skip_1='skip.1')
        sd.update(_convbns(mp, mb, pre, names))
        if add:
            sd.update(_convbns(mp, mb, pre, {'downsample': 'layers.0.1'}))
    return sd


def _stdc_context_path(p: Mapping, bs: Mapping, prefix: str) -> StateDict:
    """JAX cnn_zoo.STDCContextPathNet -> the mmseg layout (the inverse of
    JAX ``convert_stdc_context_path``, l.1495)."""
    sd = _stdc_net(p['backbone'], bs.get('backbone', {}),
                   prefix + 'backbone.')
    for i in (0, 1):
        sd.update(_arm(p[f'arms_{i}'], bs.get(f'arms_{i}', {}),
                       f'{prefix}arms.{i}.'))
    sd.update(_convbns(p, bs, prefix, {'convs_0': 'convs.0',
                                       'convs_1': 'convs.1',
                                       'conv_avg': 'conv_avg'}))
    sd.update(_convbn(p['ffm']['conv0'], bs.get('ffm', {}).get('conv0', {}),
                      prefix + 'ffm.conv0.'))
    for k, ours in ((1, 'atten_0'), (2, 'atten_1')):
        sd.update(_plain(p['ffm'][ours], f'{prefix}ffm.attention.{k}.conv'))
    return sd


def _dw_bn(p: Mapping, bs: Mapping, conv: str, bn: str,
           pre: str) -> StateDict:
    """A bare JAX depthwise conv + its separate BN -> a ``ConvModule``."""
    return _convbn({'conv': p[conv], 'bn': p[bn]}, {'bn': bs.get(bn, {})},
                   pre)


def _fastscnn(p: Mapping, bs: Mapping, prefix: str) -> StateDict:
    """JAX cnn_zoo.FastSCNN -> the mmseg layout (the inverse of JAX
    ``convert_fastscnn_backbone``, l.1201)."""
    lds = prefix + 'learning_to_downsample.'
    gfe = prefix + 'global_feature_extractor.'
    ff = prefix + 'feature_fusion.'
    sd = _convbn(p['lds0'], bs.get('lds0', {}), lds + 'conv.')
    for k in (1, 2):
        sd.update(_dw_bn(p, bs, f'lds{k}_dw', f'lds{k}_bn',
                         f'{lds}dsconv{k}.depthwise_conv.'))
        sd.update(_convbn(p[f'lds{k}_pw'], bs.get(f'lds{k}_pw', {}),
                          f'{lds}dsconv{k}.pointwise_conv.'))
    names = {'ppm_out': 'out'}
    for name, mp in p.items():
        m = re.fullmatch(r'gfe_(\d+)_(\d+)', name)
        if m is not None:
            pre = f'{gfe}bottleneck{int(m.group(1)) + 1}.{m.group(2)}.conv.'
            mb = bs.get(name, {})
            sd.update(_convbn(mp['expand'], mb.get('expand', {}), pre + '0.'))
            sd.update(_dw_bn(mp, mb, 'dw', 'dw_bn', pre + '1.'))
            sd.update(_convbn(mp['proj'], mb.get('proj', {}), pre + '2.'))
        m = re.fullmatch(r'ppm_(\d+)', name)
        if m is not None:
            names[name] = f'ppm.{m.group(1)}.1'
    sd.update(_convbns(p, bs, gfe, names))
    sd.update(_dw_bn(p, bs, 'ffm_dw', 'ffm_dw_bn', ff + 'dwconv.'))
    sd.update(_convbns(p, bs, ff, {'ffm_low': 'conv_lower_res',
                                   'ffm_high': 'conv_higher_res'}))
    return sd


def _cgnet(p: Mapping, bs: Mapping, prefix: str) -> StateDict:
    """JAX cnn_zoo.CGNet -> the mmseg layout (the inverse of JAX
    ``convert_cgnet_backbone``, l.1358)."""
    sd: StateDict = {}
    for i in range(3):
        sd.update(_convbn(p[f'stem_{i}'], bs.get(f'stem_{i}', {}),
                          f'{prefix}stem.{i}.'))
        sd[f'{prefix}stem.{i}.activate.weight'] = _t(
            p[f'stem_{i}_act']['alpha'])
    for k in range(3):
        sd.update(_norm(p[f'norm_prelu_{k}_bn'], f'{prefix}norm_prelu_{k}.0',
                        bs.get(f'norm_prelu_{k}_bn')))
        sd[f'{prefix}norm_prelu_{k}.1.weight'] = _t(
            p[f'norm_prelu_{k}_act']['alpha'])
    for name, mp in p.items():
        m = re.fullmatch(r'level(\d)_(\d+)', name)
        if m is None:
            continue
        pre = '{}level{}.{}.'.format(prefix, *m.groups())
        mb = bs.get(name, {})
        sd.update(_convbn(mp['conv1x1'], mb.get('conv1x1', {}),
                          pre + 'conv1x1.'))
        sd[pre + 'conv1x1.activate.weight'] = _t(mp['conv1x1_act']['alpha'])
        for conv in ('f_loc', 'f_sur', 'bottleneck'):
            if conv in mp:
                sd.update(_plain(mp[conv], pre + conv))
        sd.update(_norm(mp['bn'], pre + 'bn', mb.get('bn')))
        sd[pre + 'activate.weight'] = _t(mp['activate']['alpha'])
        for fc, idx in (('fc1', 0), ('fc2', 2)):
            sd.update(_dense(mp[fc], f'{pre}f_glo.fc.{idx}'))
    return sd


def _erfnet(p: Mapping, bs: Mapping, prefix: str) -> StateDict:
    """JAX cnn_zoo.ERFNet -> the mmseg layout (the inverse of JAX
    ``convert_erfnet_backbone``, l.1289). The transposed conv: flax's
    HWIO kernel, flipped in both spatial axes, is torch's [Cin, Cout,
    kh, kw] ``ConvTranspose2d`` weight."""
    sd: StateDict = {}
    nb = (('c31a', '0'), ('c13a', '2'), ('c31b', '5'), ('c13b', '7'))
    for name, mp in p.items():
        m = re.fullmatch(r'(encoder|decoder)_(\d+)(_conv|_bn)?', name)
        if m is None:
            continue
        kind, i, part = m.groups()
        pre = f'{prefix}{kind}.{i}.'
        mb = bs.get(name, {})
        if part == '_conv':
            k = np.asarray(mp['kernel'])[::-1, ::-1]
            sd[pre + 'conv.weight'] = _t(np.transpose(k, (2, 3, 0, 1)))
            sd[pre + 'conv.bias'] = _t(mp['bias'])
        elif part == '_bn':
            sd.update(_norm(mp, pre + 'bn', mb))
        elif 'conv' in mp:                        # DownsamplerBlock
            sd.update(_plain(mp['conv'], pre + 'conv'))
            sd.update(_norm(mp['bn'], pre + 'bn', mb.get('bn')))
        else:                                     # NonBottleneck1d
            for ours, idx in nb:
                sd.update(_plain(mp[ours], f'{pre}convs_layers.{idx}'))
            for ours, idx in (('bn1', '3'), ('bn2', '8')):
                sd.update(_norm(mp[ours], f'{pre}convs_layers.{idx}',
                                mb.get(ours)))
    return sd


def _mobilenet_v3(p: Mapping, bs: Mapping, prefix: str) -> StateDict:
    """JAX mobilenet.MobileNetV3 -> the mmseg layout (the inverse of JAX
    ``convert_mobilenet_v3_backbone``, l.1254)."""
    sd: StateDict = {}
    for name, mp in p.items():
        m = re.fullmatch(r'(layer\d+)(?:_(expand|dw|linear|se1|se2))?', name)
        if m is None:
            continue
        layer, part = m.groups()
        if part in ('se1', 'se2'):
            sd.update(_plain(mp, f'{prefix}{layer}.se.conv{part[-1]}.conv'))
            continue
        ref = {None: '', 'expand': 'expand_conv.', 'dw': 'depthwise_conv.',
               'linear': 'linear_conv.'}[part]
        sd.update(_convbn(mp, bs.get(name, {}), f'{prefix}{layer}.{ref}'))
    return sd


def _backbone(p: Mapping, bs: Mapping, prefix: str) -> StateDict:
    if 'patch_embed_0' in p:
        return _mit(p, prefix)
    for marker, fn in (('spatial_0', _bisenetv1), ('detail_0_0', _bisenetv2),
                       ('arms_0', _stdc_context_path),
                       ('stages_0', _stdc_net), ('lds0', _fastscnn),
                       ('stem_0_act', _cgnet), ('encoder_0', _erfnet),
                       ('layer0', _mobilenet_v3)):
        if marker in p:
            return fn(p, bs, prefix)
    if 'conv_sub1_0' in p:
        return _icnet(p, bs, prefix)
    if 'stage_0_block_0' in p:
        return _swin(p, prefix)
    if 'stage2_m0_br0_b0' in p:
        return _hrnet(p, bs, prefix)
    if 'layer1_0' in p:          # ResNet, ResNeXt (ResNet's keys), ResNeSt
        return _resnest(p, bs, prefix) if 'bn0' in p['layer1_0'] else \
            _resnet(p, bs, prefix)
    return _vit(p, prefix)


def _sep_fcn(p: Mapping, bs: Mapping, prefix: str) -> StateDict:
    """JAX zoo_heads.DepthwiseSeparableFCNHead -> the mmseg layout (the
    inverse of JAX ``convert_sep_fcn_head``, l.2182)."""
    sd: StateDict = {}
    for name in p:
        if name.startswith('convs_') or name == 'conv_cat':
            key = name.replace('convs_', 'convs.')
            sd.update(_sepconv(p[name], bs.get(name, {}), f'{prefix}{key}.'))
    sd.update(_conv_seg(p, prefix))
    return sd


def _lraspp(p: Mapping, bs: Mapping, prefix: str) -> StateDict:
    """JAX zoo_heads.LRASPPHead -> the mmseg layout (the inverse of JAX
    ``convert_lraspp_head``, l.2200)."""
    sd = _plain(p['conv_up_input'], prefix + 'conv_up_input')
    sd.update(_plain(p['image_pool_conv'], prefix + 'image_pool.1.conv'))
    names = {'aspp_conv': 'aspp_conv'}
    for name in p:
        m = re.fullmatch(r'(convs|conv_ups)_(\d+)', name)
        if m is not None and m.group(1) == 'convs':
            sd.update(_plain(p[name], f'{prefix}convs.conv{m.group(2)}'))
        elif m is not None:
            names[name] = f'conv_ups.conv_up{m.group(2)}'
    sd.update(_convbns(p, bs, prefix, names))
    sd.update(_conv_seg(p, prefix))
    return sd


def _head(p: Mapping, bs: Mapping, prefix: str) -> StateDict:
    """Any ported head's subtree, told apart by its leaves as JAX
    ``convert_any_head`` (l.2281) tells the mmseg layouts apart."""
    if 'fusion_conv' in p:
        return _segformer(p, bs, prefix)
    if 'ocb_query_0' in p:
        return _ocr(p, bs, prefix)
    if 'lateral_0' in p:
        return _uper(p, bs, prefix)
    if 'dec_proj' in p:
        return _segmenter(p, prefix)
    if 'up_conv_0_a' in p:
        return _setr_mla(p, bs, prefix)
    if 'norm' in p:
        return _setr_up(p, bs, prefix)
    if 'image_pool' in p or 'sep_fuse_0' in p:
        return _aspp(p, bs, prefix)
    if 'pool_conv_0' in p:
        return _psp(p, bs, prefix)
    if 'scale_heads_0_0' in p:
        return _fpn_head(p, bs, prefix)
    if 'cca' in p:
        return _cc(p, bs, prefix)
    if 'conv_up_input' in p:
        return _lraspp(p, bs, prefix)
    if 'depthwise' in p.get('convs_0', {}):
        return _sep_fcn(p, bs, prefix)
    return _fcn(p, bs, prefix)


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
        sd.update(_backbone(params['backbone_m'], bs.get('backbone_m', {}),
                            'backbone.'))
    if 'neck_m' in params:
        sd.update(_neck(params['neck_m'], bs.get('neck_m', {}), 'neck.'))
    if 'decode_head_m' in params:
        sd.update(_head(params['decode_head_m'],
                        bs.get('decode_head_m', {}), 'decode_head.'))
    i = 0
    while f'cascade_heads_{i}' in params:    # CascadeEncoderDecoder
        sd.update(_head(params[f'cascade_heads_{i}'],
                        bs.get(f'cascade_heads_{i}', {}),
                        f'decode_head.{i}.'))
        i += 1
    if 'aux_heads' in params:     # the vmapped stack of identical aux heads
        stacked_p = params['aux_heads']['head']
        stacked_b = bs.get('aux_heads', {}).get('head', {})
        n = np.asarray(stacked_p['conv_seg']['bias']).shape[0]
        for j in range(n):
            sd.update(_head(_index_tree(stacked_p, j),
                            _index_tree(stacked_b, j),
                            f'auxiliary_head.{j}.'))
    for name in params:
        # unfused per-level aux heads: the config's list (aux_heads_{j}),
        # or identical heads on levels of different shapes ({Type}_{j})
        m = re.fullmatch(r'(?:aux_heads|[A-Za-z]+Head)_(\d+)', name)
        if m is not None:
            sd.update(_head(params[name], bs.get(name, {}),
                            f'auxiliary_head.{m.group(1)}.'))
    ema = variables.get('ema_params')
    if ema:
        ebs = variables.get('ema_batch_stats', {})
        if 'backbone_m' in ema:
            sd.update(_backbone(ema['backbone_m'],
                                ebs.get('backbone_m', {}), 'backbone_ema.'))
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
def host_state(state, main: bool = True) -> Optional[Dict[str, Any]]:
    """The TrainState's tensors copied to host memory now (a device ->
    host copy waits for the step that wrote them), whole: a state split by
    tensor parallelism or ZeRO-3 (``state.plan``) is gathered first, a
    collective every rank must join. Only ``main`` copies; the others get
    None."""
    plan = getattr(state, 'plan', None)

    def whole(sd: Mapping[str, torch.Tensor]) -> Optional[StateDict]:
        sd = unshard_state_dict(plan, dict(sd))
        if not main:
            return None
        return {k: v.detach().to('cpu', copy=True) for k, v in sd.items()}
    model = whole(state.model.state_dict())
    momentum = whole(state.momentum)
    ema = None if state.ema_model is None else \
        whole(state.ema_model.state_dict())
    if not main:
        return None
    annealed = state.annealed_momentum
    return {'step': int(state.step), 'model': model, 'momentum': momentum,
            'ema_model': ema,
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
        payload = state if isinstance(state, dict) else host_state(state)
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
    """Save a ``TrainState`` (or its ``host_state``) under
    work_dir/iter_{step}. ``block=False`` returns once the state is on the
    host; the write finishes in the background (finalized by the next save
    or ``finalize_pending_saves``). A split state must be gathered by every
    rank first: pass ``host_state(state, is_main())`` of each rank, and
    save on the main one."""
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
    without, the raw dict of CPU tensors. The file is whole; a split
    target (``target_state.plan``) takes this rank's pieces, whatever split
    wrote it."""
    file = osp.join(path, STATE_FILE)
    if target_state is None:
        return torch.load(file, map_location='cpu', weights_only=True)
    device = target_state.step.device
    raw = torch.load(file, map_location=device, weights_only=True)
    plan = getattr(target_state, 'plan', None)
    for key in ('model', 'momentum', 'ema_model'):
        if raw[key] is not None:
            raw[key] = shard_state_dict(plan, raw[key])
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
