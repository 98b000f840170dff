"""The CNN slice held to the JAX package on the CPU, in f32, module by
module: the adaptive average pool, the ResNets (depths 18 and 50, V1c,
V1d and the plain stem, ``half_after_stage``, fdrop on the taps), the PSP,
DeepLabV3+ (``DepthwiseSeparableASPPHead``), FPN and CC heads, the FPN and
IC necks and ICNet, each from perturbed JAX weights through the weight
bridge on seeded numpy inputs; in eval mode and in train mode (BN on the
batch's statistics, and the running statistics both packages then
update), with and without a PatchShuffle permutation where the JAX head
takes one. Then the tiny DeepLabV3+ segmentor: the forward, the port's
state dict back through JAX ``convert_mmseg_checkpoint`` to the same
variables, teacher-PASA inference (the bias is built and ignored, as in
JAX), and the seeded initialisation of the new parameters.

The JAX modules are initialised from their shapes
(``tests/_torch_port.py:shaped_variables``: a jitted init of a ResNet-50
takes many seconds to compile) and applied jitted.

Tolerance: max |port - JAX| <= 1e-4 * max(1, max |JAX|) for every output
and updated BN statistic (f32, convolutions summed in another order,
through up to 50 layers whose perturbed weights grow the activations).
"""
import copy
import re
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s4former_tpu import apis as japis
from s4former_tpu.config import Config as JConfig
from s4former_tpu.core.checkpoint import convert_mmseg_checkpoint
from s4former_tpu.models import build_segmentor as j_build_segmentor
from s4former_tpu.models import init_segmentor_variables
from s4former_tpu.models.backbones import cnn_zoo as j_cnn_zoo
from s4former_tpu.models.backbones import resnet as j_resnet
from s4former_tpu.models.decode_heads import extra_heads as j_extra
from s4former_tpu.models.decode_heads import misc_heads as j_misc
from s4former_tpu.models.decode_heads import zoo_heads as j_zoo
from s4former_tpu.models.necks import necks as j_necks
from s4former_tpu.ops.resize import \
    adaptive_avg_pool as j_adaptive_avg_pool
from s4former_tpu.ops.resize import \
    adaptive_pool_matrix_np as j_adaptive_pool_matrix_np
from s4former_tpu_torch import apis
from s4former_tpu_torch.config import Config
from s4former_tpu_torch.core.checkpoint import state_dict_from_jax_variables
from s4former_tpu_torch.models import build_segmentor, init_segmentor_weights
from s4former_tpu_torch.models import dropout as tdrop
from s4former_tpu_torch.models.backbones.cnn_zoo import ICNet
from s4former_tpu_torch.models.backbones.resnet import (ResNet, ResNetV1c,
                                                        ResNetV1d)
from s4former_tpu_torch.models.decode_heads.extra_heads import (
    CCHead, CrissCrossAttention, FPNHead)
from s4former_tpu_torch.models.decode_heads.misc_heads import PSPHead
from s4former_tpu_torch.models.decode_heads.zoo_heads import \
    DepthwiseSeparableASPPHead
from s4former_tpu_torch.models.necks.necks import FPN, ICNeck
from s4former_tpu_torch.ops import flash_attention as fa
from s4former_tpu_torch.ops.resize import (adaptive_avg_pool,
                                           adaptive_pool_matrix_np)
from s4former_tpu_torch.registry import MODELS
from tests._torch_port import (assert_argmax_agrees, cnn_model, perturbed,
                               shaped_variables)

TOL = 1e-4
B, NCLS = 2, 5
N = 2                 # PatchMix_N: a map of P x P holds (P/N)^2 blocks


def _perm(p, seed=0):
    """[B, (p/N)^2] block permutations for a p x p map."""
    rs = np.random.RandomState(seed)
    return np.stack([rs.permutation((p // N) ** 2) for _ in range(B)]
                    ).astype(np.int32)


def _close(got, want, what=''):
    """max |got - want| <= TOL * max(1, max |want|)."""
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(
        got, want, rtol=0, atol=TOL * max(1.0, float(np.abs(want).max())),
        err_msg=what)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _maps(seed, shapes):
    rs = np.random.RandomState(seed)
    return [rs.randn(*s).astype(np.float32) for s in shapes]


def _mask_for(shape, keep):
    seed = zlib.crc32(repr((tuple(shape), round(float(keep), 6))).encode())
    return np.random.RandomState(seed).rand(*tuple(shape)) < keep


@pytest.fixture
def fixed_masks(monkeypatch):
    """Both packages draw the mask of ``_mask_for`` for a (shape, keep)."""
    drawn = {'jax': [], 'port': []}

    def bernoulli(key, p=0.5, shape=None):
        drawn['jax'].append(tuple(shape or ()))
        return jnp.asarray(_mask_for(shape or (), p))

    def keep_mask(generator, keep, shape, device):
        drawn['port'].append(tuple(shape))
        return torch.from_numpy(_mask_for(shape, keep))
    monkeypatch.setattr(jax.random, 'bernoulli', bernoulli)
    monkeypatch.setattr(tdrop, 'keep_mask', keep_mask)
    return drawn


SCOPE_PREFIX = {'backbone_m': 'backbone.', 'neck_m': 'neck.',
                'decode_head_m': 'decode_head.'}


def _bridge(v, scope, avg_down=False):
    """The port's state dict (prefix stripped) of a module's variables.
    ``avg_down``: the module is a ResNetV1d, whose shortcut conv and BN
    the reference keeps at ``downsample.1``/``.2`` (its pool is ``.0``);
    the bridge writes V1c's ``.0``/``.1``, as the JAX tree does not tell
    the two apart."""
    tree = {'params': {scope: v['params']},
            'batch_stats': {scope: v.get('batch_stats', {})}}
    prefix = SCOPE_PREFIX[scope]
    sd = {k[len(prefix):]: t for k, t in
          state_dict_from_jax_variables(tree).items()}
    if avg_down:
        sd = {re.sub(r'downsample\.(\d)\.',
                     lambda m: f'downsample.{int(m.group(1)) + 1}.', k): t
              for k, t in sd.items()}
    return sd


def _module_case(jmod, port, args, scope, train, seed=0, avg_down=False,
                 j_kw=None, p_kw=None):
    """``jmod`` and ``port`` on the same inputs and weights; returns both
    outputs (as lists of numpy arrays / tensors) after checking them and,
    in train mode, the running statistics both packages updated."""
    jargs = [jax.tree_util.tree_map(jnp.asarray, a) for a in args]
    v = shaped_variables(lambda: jmod.init(jax.random.PRNGKey(0), *jargs,
                                           train=False), seed)
    sd = _bridge(v, scope, avg_down)
    port.load_state_dict(sd)
    port.train(train)
    j_kw, p_kw = j_kw or {}, p_kw or {}

    @jax.jit
    def run(v, *a):
        return jmod.apply(v, *a, train=train, mutable=['batch_stats'],
                          **j_kw)
    want, mutated = run(jax.tree_util.tree_map(jnp.asarray, v), *jargs)
    pargs = [[_t(x) for x in a] if isinstance(a, (list, tuple)) else _t(a)
             for a in args]
    with torch.no_grad():
        got = port(*pargs, train=train, **p_kw)
    wants = list(want) if isinstance(want, (list, tuple)) else [want]
    gots = list(got) if isinstance(got, (list, tuple)) else [got]
    assert len(gots) == len(wants)
    for i, (g, w) in enumerate(zip(gots, wants)):
        assert g.dtype == torch.float32
        _close(g, w, f'output {i}')
    if train:
        stats = _bridge({'params': v['params'],
                         'batch_stats': jax.tree_util.tree_map(
                             np.asarray, dict(mutated['batch_stats']))},
                        scope, avg_down)
        own = port.state_dict()
        n = 0
        for k, w in stats.items():
            if k.endswith(('running_mean', 'running_var')):
                _close(own[k], w.numpy(), k)
                n += 1
        assert n > 0
    else:
        # eval mode leaves the statistics as they were
        for k, t in port.state_dict().items():
            if k.endswith(('running_mean', 'running_var')):
                np.testing.assert_array_equal(t.numpy(), sd[k].numpy())
    return gots, wants


# ------------------------------------------------------- adaptive pool
@pytest.mark.parametrize('hw', [(7, 5), (4, 9)])
def test_adaptive_avg_pool_matches_both_jax_functions(hw):
    """One function for JAX ``ops/resize.adaptive_avg_pool`` and
    ``zoo_heads._adaptive_pool`` (ICNet's), at sizes where h % s != 0 and
    s > h; the matrices equal JAX's exactly; torch's AdaptiveAvgPool2d
    agrees."""
    x = np.random.RandomState(sum(hw)).randn(2, *hw, 3).astype(np.float32)
    for s in (1, 2, 3, 6):
        for n in set(hw):
            np.testing.assert_array_equal(
                adaptive_pool_matrix_np(n, s),
                j_adaptive_pool_matrix_np(n, s))
        got = adaptive_avg_pool(_t(x), (s, s))
        _close(got, j_adaptive_avg_pool(jnp.asarray(x), (s, s)))
        _close(got, j_zoo._adaptive_pool(jnp.asarray(x), s))
        ref = torch.nn.functional.adaptive_avg_pool2d(
            _t(x).permute(0, 3, 1, 2), s).permute(0, 2, 3, 1)
        _close(got, ref.numpy())


# ------------------------------------------------------------- ResNets
def _resnet_kw(depth, **kw):
    # ResNet-18 at a stem as wide as its layer1: no shortcut conv there
    return dict(dict(depth=depth, stem_channels=16 if depth >= 50 else 8,
                     base_channels=8, out_indices=(0, 1, 2, 3)), **kw)


RESNET_CASES = {
    # the -D8 stages (DeepLabV3+, PSP, CC), contract_dilation on
    'v1c_50_d8': (j_resnet.ResNetV1c, ResNetV1c, _resnet_kw(
        50, strides=(1, 2, 1, 1), dilations=(1, 1, 2, 4),
        contract_dilation=True)),
    # V1d: avg_down shortcuts (a pool over odd sizes: ceil mode)
    'v1d_50': (j_resnet.ResNetV1d, ResNetV1d, _resnet_kw(50)),
    # FPN's strides; ResNet-18's layer1 has no shortcut conv
    'v1c_18': (j_resnet.ResNetV1c, ResNetV1c, _resnet_kw(18)),
    'v1d_18': (j_resnet.ResNetV1d, ResNetV1d, _resnet_kw(18)),
    # the plain 7x7 stem, ICNet's half_after_stage, the taps it takes
    'resnet_18_half': (j_resnet.ResNet, ResNet, _resnet_kw(
        18, out_indices=(1, 3), half_after_stage=1,
        dilations=(1, 1, 2, 4), strides=(1, 2, 1, 1))),
}
# Train mode at depth 18: through ResNet-50's 16 blocks of train-mode BN
# the f32 forward is ill-conditioned with seeded weights (the batch
# variance E[x^2] - mean^2 of a residual stream whose mean outgrows its
# spread loses digits): JAX against itself moves layer4 by about the
# tolerance when its input moves in the seventh digit, so the two
# packages cannot agree there to 1e-4. Depth 50 is held in eval mode.
RESNET_RUNS = [('v1c_50_d8', False), ('v1d_50', False), ('v1c_18', False),
               ('v1c_18', True), ('v1d_18', False), ('v1d_18', True),
               ('resnet_18_half', False), ('resnet_18_half', True)]


@pytest.mark.parametrize('case,train', RESNET_RUNS,
                         ids=[f'{c}-{"train" if t else "eval"}'
                              for c, t in RESNET_RUNS])
def test_resnet_matches_jax(case, train):
    jcls, pcls, kw = RESNET_CASES[case]
    # odd sizes: V1d's ceil-mode pool has partial windows
    x = np.random.RandomState(1).randn(B, 66, 62, 3).astype(np.float32)
    port = pcls(**kw)
    gots, _ = _module_case(jcls(**kw), port, (x,), 'backbone_m', train,
                           avg_down=case.startswith('v1d'))
    assert len(gots) == len(kw['out_indices'])
    keys = set(port.state_dict())
    assert ('stem.6.weight' in keys) == (case != 'resnet_18_half')
    assert ('conv1.weight' in keys) == (case == 'resnet_18_half')
    if case.startswith('v1d'):
        assert 'layer2.0.downsample.1.weight' in keys
        assert 'layer2.0.downsample.0.weight' not in keys
    if '18' in case:
        assert not any(k.startswith('layer1.0.downsample') for k in keys)
    if case == 'resnet_18_half':
        # the layer2 tap before the halving, layer4 after it
        assert gots[0].shape[1:3] == (9, 8) and \
            gots[1].shape[1:3] == (4, 4)


# ResNet-50 in train mode is held against a witness: the same JAX module
# in x64 from the same weights (its BNs still cast their outputs to f32).
# Each output tap and BN running statistic of the port is within
# WITNESS_MULT x JAX-f32's own distance to the witness, or TOL of
# max(1, its largest value): the port's CPU convolutions land 2-3x as far
# from it as XLA's.
WITNESS_MULT = 4


def test_resnet50_train_mode_against_x64_witness():
    jcls, pcls, kw = RESNET_CASES['v1c_50_d8']
    x = np.random.RandomState(1).randn(B, 66, 62, 3).astype(np.float32)
    jmod, port = jcls(**kw), pcls(**kw)
    v = shaped_variables(lambda: jmod.init(jax.random.PRNGKey(0),
                                           jnp.asarray(x), train=False))
    port.load_state_dict(_bridge(v, 'backbone_m'))

    def run(v, a):
        out, mutated = jmod.apply(v, a, train=True, mutable=['batch_stats'])
        return out, mutated['batch_stats']
    f32 = jax.jit(run)(jax.tree_util.tree_map(jnp.asarray, v),
                       jnp.asarray(x))
    with jax.enable_x64(True):
        f64 = jax.jit(run)(jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)), v),
            jnp.asarray(x, jnp.float64))
        f64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), f64)
    with torch.no_grad():
        got = port(_t(x), train=True)

    def stats(bs):
        return _bridge({'params': v['params'], 'batch_stats': dict(
            jax.tree_util.tree_map(np.asarray, bs))}, 'backbone_m')
    want32, want64 = stats(f32[1]), stats(f64[1])
    own = port.state_dict()
    pairs = [(f'output {i}', g.numpy(), np.asarray(w), w64)
             for i, (g, w, w64) in enumerate(zip(got, f32[0], f64[0]))]
    pairs += [(k, own[k].numpy(), want32[k].numpy(), want64[k].numpy())
              for k in want64 if k.endswith(('running_mean', 'running_var'))]
    # the stem's 3 BNs, 16 blocks x 3, 4 shortcuts
    assert len(pairs) == len(kw['out_indices']) + 2 * 55
    for name, g, w, w64 in pairs:
        g, w = g.astype(np.float64), w.astype(np.float64)
        err, jax_err = np.abs(g - w64).max(), np.abs(w - w64).max()
        tol = TOL * max(1.0, np.abs(w64).max())
        assert err <= max(WITNESS_MULT * jax_err, tol), \
            (name, err, jax_err, tol)


def test_resnet_fdrop_and_semi_keywords(fixed_masks):
    """fdrop on each tap given the same [B, 1, 1, C] masks; the attention
    bias, pos_mode and return_attn accepted and ignored; no kernel
    launch."""
    jcls, pcls, kw = RESNET_CASES['v1c_18']
    x = np.random.RandomState(2).randn(B, 64, 64, 3).astype(np.float32)
    port = pcls(**kw)
    launches = fa.launch_count
    bias = torch.ones(B, 1, 17, 17)
    _module_case(jcls(**kw), port, (x,), 'backbone_m', True,
                 j_kw=dict(use_fdrop=True, rngs={'fdrop':
                                                 jax.random.PRNGKey(1)}),
                 p_kw=dict(use_fdrop=True, attn_bias=bias,
                           pos_mode='avg', generator=torch.Generator()))
    assert fixed_masks['port'] == fixed_masks['jax'] == \
        [(B, 1, 1, c) for c in (8, 16, 32, 64)]
    assert fa.launch_count == launches
    with torch.no_grad():
        feats, attn = port.eval()(_t(x), return_attn=True)
    assert attn == ([], None) and len(feats) == 4
    assert 'ResNetV1d' in MODELS and 'ICNet' in MODELS


# --------------------------------------------------------------- heads
def _head_case(jmod, port, feats, perm, train, seed=0):
    kw = {} if perm is None else dict(patchmix_n=N)
    j_kw = dict(kw, patchmix_perm=None if perm is None else jnp.asarray(perm))
    p_kw = dict(kw, patchmix_perm=None if perm is None else
                torch.from_numpy(perm), generator=torch.Generator())
    gots, _ = _module_case(jmod, port, (feats,), 'decode_head_m', train,
                           seed, j_kw=j_kw, p_kw=p_kw)
    return gots[0]


PERM_IDS = dict(argvalues=[False, True], ids=['plain', 'shuffled'])


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
@pytest.mark.parametrize('perm', **PERM_IDS)
def test_psp_head_matches_jax(perm, train):
    """The pyramid over a 10 x 10 map (10 % 3, 10 % 6 != 0), the
    PatchShuffle undone on the input."""
    kw = dict(in_channels=24, channels=8, num_classes=NCLS, in_index=1,
              pool_scales=(1, 2, 3, 6), dropout_ratio=0.0)
    feats = _maps(3, [(B, 10, 10, 12), (B, 10, 10, 24)])
    port = PSPHead(**kw)
    _head_case(j_misc.PSPHead(**kw), port, feats,
               _perm(10) if perm else None, train)
    assert 'psp_modules.3.1.conv.weight' in port.state_dict()


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
@pytest.mark.parametrize('perm', **PERM_IDS)
def test_ds_aspp_head_matches_jax(perm, train):
    """DeepLabV3+'s head: image pool, 1x1 and separable dilated branches,
    the c1 skip (read raw: with a permutation it stays shuffled while the
    main input is undone), the separable fuse; the image pool's BN trains
    on one 1 x 1 value a sample."""
    kw = dict(in_channels=24, channels=16, num_classes=NCLS,
              dilations=(1, 2, 3), c1_in_channels=12, c1_channels=8,
              c1_index=0, in_index=1, dropout_ratio=0.0)
    feats = _maps(4, [(B, 16, 16, 12), (B, 8, 8, 24)])
    port = DepthwiseSeparableASPPHead(**kw)
    perm = _perm(8) if perm else None
    got = _head_case(j_zoo.DepthwiseSeparableASPPHead(**kw), port, feats,
                     perm, train)
    assert got.shape == (B, 16, 16, NCLS)
    keys = set(port.state_dict())
    assert {'image_pool.1.conv.weight', 'aspp_modules.0.conv.weight',
            'aspp_modules.2.depthwise_conv.conv.weight',
            'aspp_modules.2.pointwise_conv.bn.running_var',
            'c1_bottleneck.conv.weight',
            'sep_bottleneck.1.depthwise_conv.bn.weight'} <= keys
    assert port.aspp_modules[2].depthwise_conv.conv.groups == 24
    if perm is not None:
        # the c1 skip is not undone: unshuffling it too changes the logits
        from s4former_tpu_torch.models.decode_heads.base import \
            unshuffle_feature_map
        undone = [unshuffle_feature_map(_t(feats[0]),
                                        torch.from_numpy(_perm(16)), N),
                  _t(feats[1])]
        with torch.no_grad():
            other = port(undone, train=False, patchmix_perm=torch.from_numpy(
                perm), patchmix_n=N)
            own = port([_t(f) for f in feats], train=False,
                       patchmix_perm=torch.from_numpy(perm), patchmix_n=N)
        assert (other - own).abs().max() > 1e-3


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_fpn_head_matches_jax_and_never_undoes_a_shuffle(train):
    """Scale heads of 1, 1, 2 and 3 convs (strides 4-32), summed at the
    finest; a permutation given to it changes nothing (JAX l.55-56)."""
    kw = dict(in_channels=(8, 12, 16, 20), channels=8, num_classes=NCLS,
              feature_strides=(4, 8, 16, 32), in_index=(0, 1, 2, 3),
              dropout_ratio=0.0)
    feats = _maps(5, [(B, 16, 16, 8), (B, 8, 8, 12), (B, 4, 4, 16),
                      (B, 2, 2, 20)])
    port = FPNHead(**kw)
    got = _head_case(j_extra.FPNHead(**kw), port, feats, _perm(16), train)
    with torch.no_grad():
        plain = port([_t(f) for f in feats], train=False)
    if not train:
        np.testing.assert_array_equal(got.numpy(), plain.numpy())
    keys = set(port.state_dict())
    assert {'scale_heads.0.0.conv.weight', 'scale_heads.2.2.conv.weight',
            'scale_heads.3.4.bn.running_mean'} <= keys
    assert not any(k.startswith('scale_heads.0.2') for k in keys)


def test_criss_cross_attention_matches_jax():
    """Row and column attention with the -inf self term on the column
    energies, gamma non-zero (perturbed)."""
    x = _maps(6, [(B, 6, 5, 16)])[0]
    jmod = j_extra.CrissCrossAttention(16)
    v = shaped_variables(lambda: jmod.init(jax.random.PRNGKey(0),
                                           jnp.asarray(x)), 1)
    assert abs(float(v['params']['gamma'])) > 0
    port = CrissCrossAttention(16)
    sd = {k[len('decode_head.cca.'):]: t for k, t in
          state_dict_from_jax_variables(
              {'params': {'decode_head_m': {'cca': v['params']}}}).items()}
    port.load_state_dict(sd)
    assert port.gamma.scale.dim() == 0
    want = jmod.apply(jax.tree_util.tree_map(jnp.asarray, v),
                      jnp.asarray(x))
    with torch.no_grad():
        got = port(_t(x))
    _close(got, want)


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
@pytest.mark.parametrize('perm', **PERM_IDS)
def test_cc_head_matches_jax(perm, train):
    """CCHead: conv, two criss-cross passes, conv, conv_cat on the
    (unshuffled) input; gamma perturbed away from its 0."""
    kw = dict(in_channels=24, channels=16, num_classes=NCLS, recurrence=2,
              in_index=1, dropout_ratio=0.0)
    feats = _maps(7, [(B, 6, 6, 8), (B, 8, 8, 24)])
    port = CCHead(**kw)
    _head_case(j_extra.CCHead(**kw), port, feats,
               _perm(8) if perm else None, train)
    assert float(port.cca.gamma.scale.detach()) != 0
    assert {'convs.0.conv.weight', 'convs.1.bn.weight',
            'conv_cat.conv.weight', 'cca.query_conv.bias',
            'cca.gamma.scale'} <= set(port.state_dict())
    assert port.cca.query_conv.out_channels == 2


# --------------------------------------------------------------- necks
def test_fpn_neck_matches_jax():
    """Biased 1x1 laterals, the nearest top-down sum, biased 3x3s."""
    kw = dict(in_channels=[8, 12, 16, 20], out_channels=8, num_outs=4)
    feats = _maps(8, [(B, 16, 16, 8), (B, 8, 8, 12), (B, 4, 4, 16),
                      (B, 2, 2, 20)])
    port = FPN(**kw)
    gots, _ = _module_case(j_necks.FPN(**kw), port, (feats,), 'neck_m',
                           False)
    assert len(gots) == 4
    assert sorted(port.state_dict()) == sorted(
        f'{m}.{i}.conv.{w}' for m in ('lateral_convs', 'fpn_convs')
        for i in range(4) for w in ('weight', 'bias'))


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_ic_neck_matches_jax(train):
    """Two cascade fusions; the output (x_24, x_12, x_cff_12)."""
    kw = dict(in_channels=(8, 16, 12), out_channels=8)
    feats = _maps(9, [(B, 16, 16, 8), (B, 8, 8, 16), (B, 4, 4, 12)])
    port = ICNeck(**kw)
    gots, _ = _module_case(j_necks.ICNeck(**kw), port, (feats,), 'neck_m',
                           train)
    assert [tuple(g.shape[1:3]) for g in gots] == [(8, 8), (16, 16),
                                                   (16, 16)]
    assert port.cff_24.conv_low.conv.dilation == (2, 2)


ICNET_KW = dict(
    backbone_cfg=dict(type='ResNetV1c', depth=18, stem_channels=16,
                      base_channels=8, num_stages=4,
                      out_indices=(0, 1, 2, 3), dilations=(1, 1, 2, 4),
                      strides=(1, 2, 1, 1)),
    layer_channels=(16, 64), light_branch_middle_channels=8,
    psp_out_channels=16, out_channels=(8, 16, 12))


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_icnet_matches_jax(train, fixed_masks):
    """ICNet: the light branch, the half image through the inner ResNet
    (out_indices (1, 3), halved after layer2), the pyramid pooling at
    sizes the scales do not divide; no fdrop is drawn even when asked."""
    x = np.random.RandomState(10).randn(B, 96, 80, 3).astype(np.float32)
    port = ICNet(**ICNET_KW)
    gots, _ = _module_case(j_cnn_zoo.ICNet(**ICNET_KW), port, (x,),
                           'backbone_m', train,
                           j_kw=dict(use_fdrop=True),
                           p_kw=dict(use_fdrop=True,
                                     generator=torch.Generator()))
    assert [tuple(g.shape[1:]) for g in gots] == [(12, 10, 8), (6, 5, 16),
                                                  (3, 2, 12)]
    assert fixed_masks['jax'] == fixed_masks['port'] == []
    assert port.backbone.out_indices == (1, 3)
    keys = set(port.state_dict())
    assert {'backbone.stem.0.weight', 'conv_sub1.2.conv.weight',
            'psp_modules.3.1.bn.running_var', 'psp_bottleneck.conv.weight',
            'conv_sub2.conv.weight', 'conv_sub4.conv.weight'} <= keys


# ----------------------------------------------------------- segmentor
def _tiny_pair(depth=18, seed=0):
    cfg = cnn_model(depth)
    jmodel = j_build_segmentor(copy.deepcopy(cfg))
    v = shaped_variables(lambda: init_segmentor_variables(
        jmodel, jax.random.PRNGKey(0), (1, 64, 64, 3)), seed)
    model = build_segmentor(copy.deepcopy(cfg)).eval()
    model.load_state_dict(state_dict_from_jax_variables(v))
    return jmodel, v, model


def test_tiny_deeplabv3plus_forward_and_bridge_back():
    """The tiny DeepLabV3+ (ResNetV1c-50, the c1 skip, an FCN aux head):
    the forward; the port's state dict (BN statistics included) read back
    by JAX ``convert_mmseg_checkpoint`` to the same variables, number for
    number."""
    jmodel, v, model = _tiny_pair(depth=50)
    x = np.random.RandomState(11).randn(2, 64, 64, 3).astype(np.float32)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        jax.tree_util.tree_map(jnp.asarray, v), jnp.asarray(x))
    with torch.no_grad():
        got = model(_t(x))
    _close(got, want)
    sd = model.state_dict()
    assert sum(t.numel() for t in sd.values()) == sum(
        np.size(leaf) for leaf in jax.tree_util.tree_leaves(v))
    back = convert_mmseg_checkpoint({k: t.numpy() for k, t in sd.items()},
                                    num_aux=1)
    for path, leaf in jax.tree_util.tree_flatten_with_path(v)[0]:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(np.asarray(node), leaf,
                                      err_msg=jax.tree_util.keystr(path))


def test_teacher_pasa_with_a_cnn_matches_jax():
    """Teacher-PASA inference with a ResNet student: the bias is built
    from the teacher and ignored by the backbone, as in JAX; the labels
    are the plain request's."""
    jmodel, v, model = _tiny_pair(seed=1)
    ema = perturbed(v, seed=2)
    teacher = state_dict_from_jax_variables(ema)
    assert any(k.endswith('running_mean') for k in teacher)
    js = japis.Segmentor(jmodel, jax.tree_util.tree_map(jnp.asarray, v),
                         JConfig(dict(crop_size=(64, 64))))
    seg = apis.Segmentor(model, Config(dict(crop_size=(64, 64))), 'cpu')
    img = np.random.RandomState(8).randint(0, 256, (50, 60, 3), np.uint8)
    want = japis.inference_with_teacher_pasa(
        js, img, jax.tree_util.tree_map(jnp.asarray, ema))
    got = apis.inference_with_teacher_pasa(seg, img, teacher)
    plain = apis.inference_segmentor(seg, img)
    np.testing.assert_array_equal(got, plain)
    x, _ = japis._prepare_image(js, img)
    logits = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        js.variables, jnp.asarray(x))[0, :50, :60]
    probs = np.asarray(jax.nn.softmax(logits, -1))
    np.testing.assert_array_equal(want, probs.argmax(-1))
    assert_argmax_agrees(probs, np.eye(NCLS, dtype=np.float32)[got], TOL)


def test_init_draws_the_new_parameters():
    """``init_segmentor_weights`` on the CNN modules: conv kernels normal
    with std 1/sqrt(fan_in) (a depthwise 3x3's fan-in is 9), biases 0, BN
    scales 1 and statistics 0 and 1, CCNet's 0-dimensional gamma 0."""
    cfg = cnn_model(50)
    cfg['auxiliary_head'].append(dict(
        type='CCHead', in_channels=256, channels=16, num_classes=NCLS,
        in_index=3))
    model = build_segmentor(cfg)
    with torch.no_grad():
        for t in model.state_dict().values():
            t.fill_(0.5)
    init_segmentor_weights(model, torch.Generator().manual_seed(0))
    sd = model.state_dict()
    assert sd['auxiliary_head.1.cca.gamma.scale'].dim() == 0
    assert float(sd['auxiliary_head.1.cca.gamma.scale']) == 0.0
    for k, t in sd.items():
        if k.endswith('running_mean'):
            assert (t == 0.5).all(), k        # buffers are not drawn
    fresh = build_segmentor(cnn_model(50)).state_dict()
    assert all((t == 0).all() for k, t in fresh.items()
               if k.endswith('running_mean'))
    assert all((t == 1).all() for k, t in fresh.items()
               if k.endswith('running_var'))
    dw = sd['decode_head.aspp_modules.1.depthwise_conv.conv.weight']
    assert dw.shape[1:] == (1, 3, 3)
    assert abs(float(dw.std()) * 3 - 1) < 0.1
    big = sd['backbone.layer4.0.conv2.weight']
    assert abs(float(big.std()) * (big[0].numel() ** 0.5) - 1) < 0.05
    assert (sd['decode_head.conv_seg.bias'] == 0).all()
    assert (sd['backbone.stem.1.weight'] == 1).all()
    assert (sd['backbone.stem.1.bias'] == 0).all()
