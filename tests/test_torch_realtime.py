"""The real-time CNN slice held to the JAX package on the CPU, in f32:
BiSeNetV1 (on its ResNet-18), BiSeNetV2, STDC (STDCNet1 + its context
path, ``STDCHead``), Fast-SCNN (``DepthwiseSeparableFCNHead``), CGNet,
ERFNet and LR-ASPP on MobileNetV3-large (``LRASPPHead``), each the whole
model of its base config (``configs/_base_/models/``) at the config's own
widths on 64² inputs.

- The cross-entropy on labels at or above the head's class count (STDC's
  2-class ``STDCHead`` takes the 19-class labels): JAX contracts with
  ``jax.nn.one_hot``, so such a pixel has an nll of 0 and a class weight
  of 0 and still counts in the mean; the port's loss equals JAX's
  (rtol 1e-6), with and without class weights and ``avg_non_ignore``,
  and on labels in range it is bit for bit the gather it was before.
- Each model's backbone, decode head and aux heads
  (``forward_train_heads_from_img``) against JAX's, in eval mode and in
  train mode (batch statistics; the running statistics both update;
  dropout, the heads' and ERFNet's, given the same masks by (shape,
  keep) in both packages): every map within TOL of JAX's largest entry.
  Weights from the JAX init's shapes (``tests/_torch_port.py:
  shaped_variables``), carried across by the bridge.
- The bridge's keys: the port's state dict read back by JAX
  ``convert_mmseg_checkpoint`` (backbone, decode head) and
  ``convert_any_head`` (each aux head) gives JAX's variables, leaf for
  leaf, and every leaf of them.
- ``stdc_boundary_targets`` equals JAX's on labels with regions and
  ignored pixels.

Tolerance: max |port - JAX| <= 1e-4 * max(1, max |JAX|) (f32,
convolutions summed in another order, through up to ~60 layers).
"""
import copy
import os.path as osp
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from s4former_tpu.core.checkpoint import (convert_any_head,
                                          convert_mmseg_checkpoint)
from s4former_tpu.models import build_segmentor as j_build_segmentor
from s4former_tpu.models import init_segmentor_variables
from s4former_tpu.models.backbones.cnn_zoo import STDCNet as JSTDCNet
from s4former_tpu.models.decode_heads.extra_heads import \
    stdc_boundary_targets as j_stdc_boundary_targets
from s4former_tpu.models.losses.cross_entropy import \
    cross_entropy_loss as j_cross_entropy_loss
from s4former_tpu_torch.config import Config
from s4former_tpu_torch.core.checkpoint import state_dict_from_jax_variables
from s4former_tpu_torch.models import build_segmentor
from s4former_tpu_torch.models.backbones.cnn_zoo import STDCNet
from s4former_tpu_torch.models.decode_heads.extra_heads import \
    stdc_boundary_targets
from s4former_tpu_torch.models.losses.cross_entropy import (
    cross_entropy_loss, softmax_cross_entropy_with_ignore)
from s4former_tpu_torch.ops import flash_attention as fa
from tests._torch_port import shaped_variables
from tests.test_torch_cnn import fixed_masks  # noqa: F401 (a fixture)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))

TOL = 1e-4
WITNESS_MULT = 4
REALTIME = ('bisenetv1_r18-d32.py', 'bisenetv2.py', 'stdc.py',
            'fast_scnn.py', 'cgnet.py', 'erfnet_fcn.py', 'lraspp_m-v3-d8.py')
AUX_NAME = re.compile(r'(?:aux_heads|[A-Za-z]+Head)_(\d+)')


def _config(name):
    return dict(Config.fromfile(
        f'{REPO}/configs/_base_/models/{name}').model)


# ---------------------------------------------------------------- the CE
def _labels(rs, shape, top):
    """Labels in 0..top-1 with about a tenth of them 255 (ignored)."""
    label = rs.randint(0, top, shape)
    label[rs.rand(*shape) < 0.1] = 255
    return label


@pytest.mark.parametrize('weighted', [False, True])
@pytest.mark.parametrize('avg_non_ignore', [False, True])
def test_cross_entropy_on_labels_beyond_the_classes_matches_jax(
        weighted, avg_non_ignore):
    """2-class logits against labels 0-18 (and 255): the port's loss is
    JAX's; a label in [2, 255) has nll 0 and stays valid."""
    rs = np.random.RandomState(0)
    logits = rs.randn(2, 8, 8, 2).astype(np.float32)
    label = _labels(rs, (2, 8, 8), 19)
    cw = [0.3, 1.7] if weighted else None
    want = float(j_cross_entropy_loss(jnp.asarray(logits),
                                      jnp.asarray(label), class_weight=cw,
                                      avg_non_ignore=avg_non_ignore))
    got = float(cross_entropy_loss(torch.from_numpy(logits),
                                   torch.from_numpy(label), class_weight=cw,
                                   avg_non_ignore=avg_non_ignore))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    nll, valid = softmax_cross_entropy_with_ignore(
        torch.from_numpy(logits), torch.from_numpy(label), class_weight=cw)
    beyond = torch.from_numpy((label >= 2) & (label != 255))
    assert beyond.any()
    assert (nll[beyond] == 0).all() and (valid[beyond] == 1).all()
    assert (valid[torch.from_numpy(label == 255)] == 0).all()


@pytest.mark.parametrize('weighted', [False, True])
def test_cross_entropy_in_range_is_the_gather_bit_for_bit(weighted):
    """On labels below the class count (and 255) the loss is the plain
    gather's, bit for bit: the repair changes no path that ran before."""
    rs = np.random.RandomState(1)
    logits = torch.from_numpy(rs.randn(2, 16, 16, 21).astype(np.float32))
    label = torch.from_numpy(_labels(rs, (2, 16, 16), 21))
    cw = torch.from_numpy(rs.rand(21).astype(np.float32)) if weighted \
        else None
    valid = label != 255
    safe = torch.where(valid, label, torch.zeros_like(label)).long()
    want = -F.log_softmax(logits, dim=-1).gather(-1, safe[..., None])[..., 0]
    if weighted:
        want = want * cw[safe]
    want = want * valid.float()
    nll, _ = softmax_cross_entropy_with_ignore(logits, label,
                                               class_weight=cw)
    assert torch.equal(nll, want)


# ------------------------------------------------------------ the models
_PAIRS = {}


def _pair(name):
    """(JAX model, its seeded variables, the port's model with them),
    built once a worker."""
    if name not in _PAIRS:
        cfg = _config(name)
        jmodel = j_build_segmentor(copy.deepcopy(cfg))
        v = shaped_variables(lambda: init_segmentor_variables(
            jmodel, jax.random.PRNGKey(0), (1, 64, 64, 3)), 0)
        model = build_segmentor(copy.deepcopy(cfg))
        model.load_state_dict(state_dict_from_jax_variables(v))
        _PAIRS[name] = jmodel, v, model
    jmodel, v, model = _PAIRS[name]
    fresh = copy.deepcopy(model)   # train mode moves the statistics
    return jmodel, v, fresh


@pytest.mark.parametrize('name', REALTIME)
def test_model_train_forward_against_x64_witness(name, fixed_masks):
    """Backbone + decode head + aux heads in train mode, and every running
    statistic they update: within TOL of JAX's f32 run, or where not, held
    against its x64 witness (the module docstring); no kernel launch."""
    jmodel, v, model = _pair(name)
    # samples of very different brightness and contrast, as photographs
    # are: noise of one distribution pools to near-equal features, and
    # the batch statistics of the pooled gates (ARMs, FFMs, the context
    # embedding, SE) would divide by a near-zero variance
    x = (np.random.RandomState(3).randn(2, 64, 64, 3) *
         np.array([0.4, 2.5])[:, None, None, None] +
         np.array([-1.5, 1.5])[:, None, None, None]).astype(np.float32)

    def fwd(v, x):
        (main, aux), upd = jmodel.apply(
            v, img=x, train=True, method='forward_train_heads_from_img',
            mutable=['batch_stats'], rngs={'dropout': jax.random.PRNGKey(0)})
        return [main] + list(aux), upd['batch_stats']
    f32 = jax.jit(fwd)(jax.tree_util.tree_map(jnp.asarray, v),
                       jnp.asarray(x))
    launches = fa.launch_count
    with torch.no_grad():
        main, aux = model.forward_train_heads_from_img(
            torch.from_numpy(x), train=True,
            generator=torch.Generator().manual_seed(0))
    assert fa.launch_count == launches

    def stats(bs):
        return state_dict_from_jax_variables(
            {'params': v['params'],
             'batch_stats': jax.tree_util.tree_map(np.asarray, bs)})
    want32, own = stats(f32[1]), model.state_dict()
    names = [k for k in want32 if k.endswith(('running_mean', 'running_var'))]
    assert names and len(f32[0]) == 1 + len(model.auxiliary_head)
    got = [t.numpy() for t in [main] + list(aux)] + \
        [own[k].numpy() for k in names]
    want = [np.asarray(w) for w in f32[0]] + [want32[k].numpy() for k in names]
    what = [f'logits {i}' for i in range(len(f32[0]))] + names
    far = [i for i, (g, w) in enumerate(zip(got, want))
           if g.shape != w.shape or np.abs(g - w).max() >
           TOL * max(1.0, np.abs(w).max())]
    if not far:
        return
    # where the port parts from JAX's f32 run, the x64 witness decides
    with jax.enable_x64(True):
        f64 = jax.jit(fwd)(jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)), v),
            jnp.asarray(x, jnp.float64))
        f64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), f64)
    want64 = stats(f64[1])
    want64 = [w for w in f64[0]] + [want64[k].numpy() for k in names]
    for i in far:
        g, w, w64 = (a.astype(np.float64) for a in (got[i], want[i],
                                                     want64[i]))
        assert g.shape == w64.shape, what[i]
        err, jax_err = np.abs(g - w64).max(), np.abs(w - w64).max()
        tol = TOL * max(1.0, np.abs(w64).max())
        assert err <= max(WITNESS_MULT * jax_err, tol), \
            (what[i], err, jax_err, tol)


@pytest.mark.parametrize('name', REALTIME)
def test_bridge_reads_back_to_the_jax_variables(name):
    """The port's state dict through JAX's converters gives JAX's
    variables leaf for leaf, and no leaf is left out."""
    _, v, model = _pair(name)
    sd = {k: t.numpy() for k, t in model.state_dict().items()}
    back = convert_mmseg_checkpoint(sd, num_aux=0)
    trees = {'backbone_m': (back['params']['backbone_m'],
                            back['batch_stats'].get('backbone_m', {})),
             'decode_head_m': (back['params']['decode_head_m'],
                               back['batch_stats'].get('decode_head_m',
                                                       {}))}
    for scope in v['params']:
        m = AUX_NAME.fullmatch(scope)
        if m is not None:
            pre = f'auxiliary_head.{m.group(1)}.'
            trees[scope] = convert_any_head(
                {k[len(pre):]: t for k, t in sd.items()
                 if k.startswith(pre)})
    assert sorted(trees) == sorted(v['params'])
    n = 0
    for col, i in (('params', 0), ('batch_stats', 1)):
        for scope, tree in v[col].items():
            leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
            got = dict(jax.tree_util.tree_flatten_with_path(
                trees[scope][i])[0])
            assert len(got) == len(leaves), (col, scope)
            for path, leaf in leaves:
                np.testing.assert_array_equal(
                    np.asarray(got[path]), leaf,
                    err_msg=f'{col} {scope} {jax.tree_util.keystr(path)}')
                n += 1
    assert n == len(jax.tree_util.tree_leaves(v)) == len(sd)


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_stdc_add_fusion_matches_jax(train):
    """STDCNet's ``add`` modules (no config uses them; the stride-2 one
    holds its downsample at ``layers.0.1`` and ``downsample``, as the
    reference shares it) with the final 1x1, narrow, against JAX: the
    three maps and, in train mode, the running statistics."""
    kw = dict(channels=(8, 16, 32, 64, 128), bottleneck_type='add',
              with_final_conv=True)
    x = np.random.RandomState(5).randn(2, 64, 64, 3).astype(np.float32)
    jmod = JSTDCNet(**kw)
    v = shaped_variables(lambda: jmod.init(jax.random.PRNGKey(0),
                                           jnp.asarray(x), train=False))
    port = STDCNet(**kw)
    assert 'stages.2.0.layers.0.1.conv.weight' in port.state_dict()
    assert 'stages.2.0.downsample.conv.weight' in port.state_dict()
    tree = {'params': {'backbone_m': v['params']},
            'batch_stats': {'backbone_m': v['batch_stats']}}
    port.load_state_dict({k[len('backbone.'):]: t for k, t in
                          state_dict_from_jax_variables(tree).items()})
    want, upd = jax.jit(lambda v, x: jmod.apply(
        v, x, train=train, mutable=['batch_stats']))(
            jax.tree_util.tree_map(jnp.asarray, v), jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x), train=train)
    pairs = list(zip(got, want))
    if train:
        tree['batch_stats']['backbone_m'] = jax.tree_util.tree_map(
            np.asarray, upd['batch_stats'])
        stats = state_dict_from_jax_variables(tree)
        pairs += [(port.state_dict()[k[len('backbone.'):]], stats[k])
                  for k in stats if k.endswith('running_var')]
    assert len(pairs) > (3 if train else 2)
    for g, w in pairs:
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=TOL * max(1.0, np.abs(w).max()))


def test_stdc_boundary_targets_match_jax():
    """Region labels (blocks of 8 and 5 pixels, ignored strips) through
    both packages' boundary targets: equal, and about a tenth boundary."""
    rs = np.random.RandomState(4)
    label = np.kron(rs.randint(0, 19, (2, 8, 13)),
                    np.ones((8, 5), np.int64))[:, :64, :64]
    label[:, 20:23] = 255
    want = np.asarray(j_stdc_boundary_targets(jnp.asarray(label)))
    got = stdc_boundary_targets(torch.from_numpy(label)).numpy()
    assert got.shape == (2, 64, 64) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert 0.05 < got.mean() < 0.5
