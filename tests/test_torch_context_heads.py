"""The context-head slice held to the JAX package on the CPU, in f32:
MobileNetV2 and the twelve heads of JAX ``zoo_heads.py`` it adds (ASPP,
NL, GC, DNL, ANN, APC, DM, EMA, Enc, ISA, PSA, DA), with the Encoding
layer and PSAMask.

- MobileNetV2 (``widen_factor`` 0.25, so every width is 8-80) at the -D8
  strides and dilations and at the defaults, on 64² inputs, in eval and
  train mode: every returned map and, in train mode, every running
  statistic; where one parts from JAX's f32 run by more than TOL (the
  default strides' 2 x 2 maps in train mode: BN variances of 8 values a
  channel cancel in f32), within WITNESS_MULT x JAX-f32's own distance
  to JAX's x64 run, or TOL of it.
- MobileNetV2 at full width against the mmseg-layout torch oracle of
  JAX's ``tests/test_core/test_mobilenet_parity.py`` (its settings: both
  stride recipes, randomised BN statistics): its state dict loads with
  ``load_state_dict`` and gives the oracle's maps; read by JAX's
  converter and back through the port's bridge it is unchanged.
- Each head alone on four seeded NHWC feature maps of 8 x 8 (widths 8,
  12, 16, 24), in eval mode, and in train mode with a PatchShuffle
  permutation of its 4 x 4 blocks of 2 (ANN undoes it on its high level
  only, Enc never): the logits, and the running statistics and EMA's
  ``bases`` the call moves. Enc's SE logits against the ones JAX sows.
- The bridge: the port's state dict read back by the head's JAX
  ``convert_*`` gives JAX's variables leaf for leaf (ANN's shared
  query/key projection is in the state dict twice, under both names, as
  mmseg's is); saved as a ``.pth`` it loads into a fresh head with
  ``load_state_dict``.
- ``Encoding`` against JAX's; ``psamask`` against JAX's ``_psamask``,
  bit for bit, collect and distribute, masks smaller and larger than
  the map.
- The seeded init: one seed, one state dict, EMA's ``bases`` included
  (the card-vs-CPU phases build a model on each device from a seed).

Weights from the JAX init's shapes (``tests/_torch_port.py:
shaped_variables``), carried across by the bridge. Tolerance: max |port -
JAX| <= TOL * max(1, max |JAX|) (f32, sums in another order).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s4former_tpu.core import checkpoint as jcheckpoint
from s4former_tpu.models.backbones.mobilenet import \
    MobileNetV2 as JMobileNetV2
from s4former_tpu.models.decode_heads import zoo_heads as jzoo
from s4former_tpu.ops.encoding import Encoding as JEncoding
from s4former_tpu_torch.core.checkpoint import state_dict_from_jax_variables
from s4former_tpu_torch.models.backbones.mobilenet import MobileNetV2
from s4former_tpu_torch.models.decode_heads import zoo_heads
from s4former_tpu_torch.ops.encoding import Encoding
from tests._torch_port import shaped_variables
from tests.test_core.test_mobilenet_parity import TorchMobileNetV2

TOL = 1e-4
WITNESS_MULT = 4
WIDTHS = (8, 12, 16, 24)
HW = 8
N = 2                      # PatchMix_N: 4 x 4 blocks of 2 on the 8 x 8 map
D8 = dict(strides=(1, 2, 2, 1, 1, 1, 1), dilations=(1, 1, 1, 2, 2, 4, 4))

# JAX's reader of each head's mmseg layout (``convert_any_head`` takes an
# EncHead with laterals for a UPerHead: it tests ``lateral_convs`` first)
CONVERT = {'ASPPHead': 'aspp', 'NLHead': 'nl', 'GCHead': 'gc',
           'DNLHead': 'nl', 'ANNHead': 'ann', 'APCHead': 'apc',
           'DMHead': 'dm', 'EMAHead': 'ema', 'EncHead': 'enc',
           'ISAHead': 'isa', 'PSAHead': 'psa', 'DAHead': 'da'}
# each head's tiny settings (the -D8 heads read the last map)
HEADS = {
    'ASPPHead': dict(in_channels=24, channels=8, dilations=(1, 2, 3)),
    'NLHead': dict(in_channels=24, channels=8),
    'GCHead': dict(in_channels=24, channels=8, ratio=0.25),
    'DNLHead': dict(in_channels=24, channels=8),
    'ANNHead': dict(in_channels=(16, 24), in_index=(2, 3), channels=8,
                    project_channels=4),
    'APCHead': dict(in_channels=24, channels=8),
    'DMHead': dict(in_channels=24, channels=8),
    'EMAHead': dict(in_channels=24, channels=8, ema_channels=8,
                    num_bases=4),
    'EncHead': dict(in_channels=(12, 16, 24), in_index=(1, 2, 3),
                    channels=8, num_codes=4, use_se_loss=True,
                    add_lateral=True),
    'ISAHead': dict(in_channels=24, channels=8, isa_channels=4,
                    down_factor=(3, 3)),
    'PSAHead': dict(in_channels=24, channels=8, mask_size=(5, 7)),
    'DAHead': dict(in_channels=24, channels=8, pam_channels=4),
}


def _close(got, want, what):
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * max(1.0, np.abs(want).max()),
                               err_msg=what)


def _feats(seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(2, HW, HW, c).astype(np.float32) for c in WIDTHS]


def _perm():
    rs = np.random.RandomState(7)
    g = HW // N
    return np.stack([rs.permutation(g * g) for _ in range(2)]
                    ).astype(np.int32)


PREFIX = {'decode_head_m': 'decode_head.', 'backbone_m': 'backbone.'}


def _bridged(scope, params, batch_stats):
    """The port's state dict (prefix stripped) of a module's variables."""
    sd = state_dict_from_jax_variables(
        {'params': {scope: params},
         'batch_stats': {scope: jax.tree_util.tree_map(np.asarray,
                                                       batch_stats)}})
    return {k[len(PREFIX[scope]):]: t for k, t in sd.items()}


def _port_of(scope, v, module):
    """``module`` loaded with the JAX variables ``v`` of ``scope``."""
    module.load_state_dict(_bridged(scope, v['params'], v['batch_stats']))
    return module


_BUILT = {}


def _head_pair(name):
    """(JAX head, its seeded variables, the port's head with them), built
    once a worker; the port's head is a fresh copy each call."""
    if name not in _BUILT:
        kw = dict(HEADS[name], num_classes=5, dropout_ratio=0.0)
        jhead = getattr(jzoo, name)(**kw)
        feats = [jnp.asarray(f) for f in _feats()]
        v = shaped_variables(lambda: jhead.init(jax.random.PRNGKey(0),
                                                feats, train=False))
        port = _port_of('decode_head_m', v, getattr(zoo_heads, name)(**kw))
        _BUILT[name] = jhead, v, port
    jhead, v, port = _BUILT[name]
    return jhead, v, copy.deepcopy(port)


def _stats(scope, v, batch_stats):
    """The buffers a train-mode call moves, bridged from JAX's."""
    return {k: t for k, t in _bridged(scope, v['params'],
                                      batch_stats).items()
            if k.endswith(('running_mean', 'running_var', 'bases'))}


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
@pytest.mark.parametrize('strides', ['d8', 'default'])
def test_mobilenet_v2_matches_jax(strides, train):
    kw = dict(widen_factor=0.25, out_indices=(0, 1, 2, 4, 6),
              **(D8 if strides == 'd8' else {}))
    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    jmod = JMobileNetV2(**kw)
    v = shaped_variables(lambda: jmod.init(jax.random.PRNGKey(0),
                                           jnp.asarray(x), train=False))
    port = _port_of('backbone_m', v, MobileNetV2(**kw))
    assert 'layer1.0.conv.1.conv.weight' in port.state_dict()
    assert 'layer2.0.conv.2.conv.weight' in port.state_dict()
    def fwd(v, x):
        return jmod.apply(v, x, train=train, mutable=['batch_stats'])
    want, upd = jax.jit(fwd)(jax.tree_util.tree_map(jnp.asarray, v),
                             jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x), train=train)
    assert len(got) == len(want) == 5
    # the -D8 recipe: stages 3-6 stay at 1/8
    side = [g.shape[1] for g in got]
    assert side == ([32, 16, 8, 8, 8] if strides == 'd8' else
                    [32, 16, 8, 4, 2])
    pairs = {f'out {i}': (g.numpy(), np.asarray(w))
             for i, (g, w) in enumerate(zip(got, want))}
    if train:
        stats = _stats('backbone_m', v, upd['batch_stats'])
        own = port.state_dict()
        assert len(stats) == 2 * 51     # 51 BNs
        pairs.update({k: (own[k].numpy(), t.numpy())
                      for k, t in stats.items()})
    far = [k for k, (g, w) in pairs.items()
           if np.abs(g - w).max() > TOL * max(1.0, np.abs(w).max())]
    if not far:
        return
    # in train mode the default strides' last maps are 2 x 2 (8 values a
    # BN channel), whose f32 variances cancel: where the port parts from
    # JAX's f32 run, JAX's x64 run decides
    with jax.enable_x64(True):
        w64, u64 = jax.jit(fwd)(jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)), v),
            jnp.asarray(x, jnp.float64))
        w64 = {f'out {i}': np.asarray(w, np.float64)
               for i, w in enumerate(w64)}
        if train:
            w64.update({k: t.numpy() for k, t in _stats(
                'backbone_m', v, u64['batch_stats']).items()})
    for k in far:
        g, w = pairs[k]
        err = np.abs(g - w64[k]).max()
        jax_err = np.abs(w - w64[k]).max()
        tol = TOL * max(1.0, np.abs(w64[k]).max())
        assert err <= max(WITNESS_MULT * jax_err, tol), (k, err, jax_err, tol)


@pytest.mark.parametrize('strides', ['d8', 'default'])
def test_mobilenet_v2_loads_the_mmseg_layout(strides):
    """The mmseg-layout torch oracle of JAX's own test (its BN statistics
    randomised): its state dict loads into the port's MobileNetV2 with
    ``load_state_dict`` (strict), which then returns the oracle's maps
    within TOL; through JAX ``convert_mobilenet_v2_backbone`` and back
    through the port's bridge it is the same state dict, bit for bit."""
    d = D8 if strides == 'd8' else dict(strides=(1, 2, 2, 2, 1, 2, 1),
                                         dilations=(1,) * 7)
    torch.manual_seed(0)
    oracle = TorchMobileNetV2(d['strides'], d['dilations']).eval()
    for m in oracle.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.normal_(0, 0.2)
            m.running_var.uniform_(0.5, 1.5)
    sd = oracle.state_dict_mmseg()
    port = MobileNetV2(out_indices=(1, 2, 4, 6), **d).eval()
    port.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    with torch.no_grad():
        want = oracle(torch.from_numpy(x).permute(0, 3, 1, 2),
                      out_indices=(1, 2, 4, 6))
        got = port(torch.from_numpy(x))
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g.numpy(), w.permute(0, 2, 3, 1).numpy(), f'out {i}')
    p, bs = jcheckpoint.convert_mobilenet_v2_backbone(sd)
    back = _bridged('backbone_m', p, bs)
    assert sorted(back) == sorted(sd)
    for k, t in back.items():
        np.testing.assert_array_equal(t.numpy(), sd[k], err_msg=k)


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
@pytest.mark.parametrize('name', sorted(HEADS))
def test_head_matches_jax(name, train):
    """Logits (and in train mode, with a PatchShuffle undone, the running
    statistics and EMA's bases the call moves) within TOL of JAX's."""
    jhead, v, port = _head_pair(name)
    feats = _feats(1)
    perm = _perm() if train else None
    kw = dict(train=train, patchmix_perm=perm, patchmix_n=N if train else 0)

    def fwd(v, feats):
        out, upd = jhead.apply(v, feats, mutable=['batch_stats',
                                                  'intermediates'], **kw)
        return out, upd
    want, upd = jax.jit(fwd)(jax.tree_util.tree_map(jnp.asarray, v),
                             [jnp.asarray(f) for f in feats])
    kw['patchmix_perm'] = None if perm is None else torch.from_numpy(perm)
    extra = {'return_se_logits': True} if name == 'EncHead' else {}
    with torch.no_grad():
        got = port([torch.from_numpy(f) for f in feats], **kw, **extra)
    if name == 'EncHead':
        got, se = got
        _close(se.numpy(), upd['intermediates']['se_logits'][0], 'se_logits')
    assert got.shape == (2, HW, HW, 5)
    _close(got.numpy(), want, 'logits')
    stats = _stats('decode_head_m', v, upd['batch_stats'])
    own = port.state_dict()
    assert len(stats) > 0
    moved = 0
    for k, t in stats.items():
        _close(own[k].numpy(), t.numpy(), k)
        before = _BUILT[name][2].state_dict()[k]
        moved += not torch.equal(own[k], before)
    assert moved == (len(stats) if train else 0)
    if name == 'EMAHead':
        assert own['ema_module.bases'].shape == (1, 8, 4)


@pytest.mark.parametrize('name', sorted(HEADS))
def test_bridge_reads_back_and_loads(name, tmp_path):
    """The port's state dict through JAX's ``convert_*`` of the head gives
    JAX's variables leaf for leaf; as a ``.pth`` it loads into a fresh
    head."""
    _, v, port = _head_pair(name)
    sd = port.state_dict()
    convert = getattr(jcheckpoint, f'convert_{CONVERT[name]}_head')
    p, bs = convert({k: t.numpy() for k, t in sd.items()})
    n = 0
    for tree, back in ((v['params'], p), (v['batch_stats'], bs)):
        leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
        got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
        assert len(got) == len(leaves)
        for path, leaf in leaves:
            np.testing.assert_array_equal(
                np.asarray(got[path]), leaf,
                err_msg=f'{name} {jax.tree_util.keystr(path)}')
            n += 1
    shared = [k for k in sd if k.startswith('context.stages') and
              '.query_project.' in k]
    assert len(shared) == (5 if name == 'ANNHead' else 0)
    assert n == len(sd) - len(shared)
    path = tmp_path / 'head.pth'
    torch.save({'state_dict': {f'decode_head.{k}': t
                               for k, t in sd.items()}}, path)
    loaded = torch.load(path, weights_only=True)['state_dict']
    fresh = getattr(zoo_heads, name)(**HEADS[name], num_classes=5)
    fresh.load_state_dict({k[len('decode_head.'):]: t
                           for k, t in loaded.items()})
    for k, t in fresh.state_dict().items():
        assert torch.equal(t, sd[k]), k


def test_encoding_matches_jax():
    rs = np.random.RandomState(2)
    x = rs.randn(2, 5, 6, 12).astype(np.float32)
    jenc = JEncoding(num_codes=7)
    v = jenc.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jenc.apply(v, jnp.asarray(x)))
    enc = Encoding(12, 7)
    with torch.no_grad():
        enc.codewords.copy_(torch.tensor(
            np.asarray(v['params']['codewords'])))
        enc.scale.copy_(torch.tensor(np.asarray(v['params']['scale'])))
        got = enc(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 7, 12)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize('collect', [True, False],
                         ids=['collect', 'distribute'])
@pytest.mark.parametrize('hw,mask', [((4, 5), (7, 9)), ((6, 6), (3, 5)),
                                     ((5, 3), (9, 5))])
def test_psamask_matches_jax_exactly(hw, mask, collect):
    h, w = hw
    a = np.random.RandomState(3).randn(2, h, w, mask[0] * mask[1]
                                       ).astype(np.float32)
    want = np.asarray(jzoo._psamask(jnp.asarray(a), mask, h, w, collect))
    got = zoo_heads.psamask(torch.from_numpy(a), mask, collect).numpy()
    assert got.shape == (2, h * w, h * w)
    np.testing.assert_array_equal(got, want)


def test_seeded_init_draws_every_head_tensor_from_the_seed():
    """``init_segmentor_weights`` from one seed gives the same state dict
    on every build, buffers included (EMA's ``bases``), with each module's
    own initialisers: Encoding's codewords within ±1/sqrt(K C) and scales
    in [-1, 0), unit-norm bases, GCNet's LayerNorm the identity."""
    from s4former_tpu_torch.models import (build_segmentor,
                                           init_segmentor_weights)
    from tests._torch_port import emanet_model
    cfgs = [emanet_model(), emanet_model()]
    for cfg, head in zip(cfgs, ('EncHead', 'GCHead')):
        cfg['decode_head'] = dict(HEADS[head], type=head, num_classes=5,
                                  in_channels=(32, 64, 128)
                                  if head == 'EncHead' else 128)
    for cfg in [emanet_model()] + cfgs:
        sds = [init_segmentor_weights(build_segmentor(copy.deepcopy(cfg)),
                                      torch.Generator().manual_seed(3)
                                      ).state_dict() for _ in range(2)]
        assert sds[0].keys() == sds[1].keys()
        for k in sds[0]:
            assert torch.equal(sds[0][k], sds[1][k]), k
        sd = sds[0]
        if 'decode_head.ema_module.bases' in sd:
            norms = sd['decode_head.ema_module.bases'].norm(dim=1)
            torch.testing.assert_close(norms, torch.ones_like(norms))
        if 'decode_head.enc_module.encoding.0.scale' in sd:
            scale = sd['decode_head.enc_module.encoding.0.scale']
            words = sd['decode_head.enc_module.encoding.0.codewords']
            assert (scale >= -1).all() and (scale < 0).all()
            assert words.abs().max() <= 1 / (4 * 8) ** 0.5
        if 'decode_head.gc_block.channel_add_conv.1.weight' in sd:
            ln = sd['decode_head.gc_block.channel_add_conv.1.weight']
            assert ln.shape == (2, 1, 1) and (ln == 1).all()
