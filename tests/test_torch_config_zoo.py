"""The port's twin of the JAX package's tests/test_config_zoo.py: every
config under configs/ that has a model loads through the port's
``_base_`` machinery and either builds a segmentor in the port (on the
meta device, so no memory is spent) or raises the registry's KeyError
naming a model type of that config that is not ported yet. The JAX
package builds each of them.

Then the tiny 64² forward of eighteen base models, held to JAX in f32 from
perturbed JAX weights through the weight bridge: ``setr_mla.py`` and
``segmenter_vit-b_mask.py``, ``setr_pup.py`` and ``segformer_mit-b0.py``,
and the five ResNet bases (``deeplabv3plus_r50-d8.py``,
``pspnet_r50-d8.py``, ``fpn_r50.py``, ``ccnet_r50-d8.py``,
``icnet_r50-d8.py``), narrowed through ``stem_channels`` /
``base_channels`` and the heads' ``channels`` at depth 50, and
``upernet_swin.py`` (Swin-T's depths at embed 24) and ``ocrnet_hr18.py``
(the cascade; ``tests/_torch_port.py:hrnet_extra``), and the seven
real-time CNNs at their configs' own widths (``bisenetv1_r18-d32.py``,
``bisenetv2.py``, ``stdc.py``, ``fast_scnn.py``, ``cgnet.py``,
``erfnet_fcn.py``, ``lraspp_m-v3-d8.py``), their
weights made from the JAX init's shapes
(``tests/_torch_port.py:shaped_variables``; a jitted init of a ResNet-50
takes many seconds to compile). The ViT-scale ones are shrunk as JAX's test
shrinks Segmenter (img_size 64, embed 64, 4 heads; the head to embed 64,
4 heads, 1 layer), with the taps inside the shrunk depth: JAX indexes
its stacked layer outputs and jnp clamps an index past the end to the
last layer (Segmenter's 11 of 2 reads layer 1), where the port refuses
it. Tolerance 1e-4 of the logits' largest magnitude (f32, sums in
another order, through the layers and the head; the perturbed weights
give logits of tens).
"""
import copy
import glob
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import s4former_tpu.models  # noqa: F401
import s4former_tpu_torch.models  # noqa: F401
from s4former_tpu.config import Config as JConfig
from s4former_tpu.models import build_segmentor as j_build_segmentor
from s4former_tpu.models import init_segmentor_variables
from s4former_tpu_torch.config import Config
from s4former_tpu_torch.core.checkpoint import state_dict_from_jax_variables
from s4former_tpu_torch.models import build_segmentor
from s4former_tpu_torch.registry import MODELS
from tests._torch_port import hrnet_extra, perturbed, shaped_variables

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
ALL_CONFIGS = sorted(
    glob.glob(osp.join(REPO, 'configs', '**', '*.py'), recursive=True))
# the configs with a model (the dataset, schedule and runtime fragments
# have none); a file's content decides, the same in every worker
MODEL_CONFIGS = [p for p in ALL_CONFIGS if 'model' in Config.fromfile(p)]
# what the port builds today; any other config names an unported type
PORTED_BASES = ('setr_mla.py', 'segmenter_vit-b_mask.py', 'setr_pup.py',
                'segformer_mit-b0.py', 'deeplabv3plus_r50-d8.py',
                'pspnet_r50-d8.py', 'fpn_r50.py', 'ccnet_r50-d8.py',
                'icnet_r50-d8.py', 'upernet_swin.py', 'ocrnet_hr18.py',
                'bisenetv1_r18-d32.py', 'bisenetv2.py', 'stdc.py',
                'fast_scnn.py', 'cgnet.py', 'erfnet_fcn.py',
                'lraspp_m-v3-d8.py')
# weights from the JAX init's shapes (a jitted init compiles for long)
CNN_BASES = PORTED_BASES[4:]
# the real-time CNNs run at their configs' own widths
REALTIME_BASES = PORTED_BASES[11:]
ATOL = 1e-4


def _types(tree):
    """The module types of a model config tree (the segmentor, backbone,
    neck and heads; not the norm, activation, init or loss settings,
    which the build does not look up)."""
    if isinstance(tree, dict):
        own = [tree['type']] if isinstance(tree.get('type'), str) else []
        return own + [t for k, v in tree.items()
                      if not (k.endswith('_cfg') or
                              k in ('norm_layer', 'loss_decode'))
                      for t in _types(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _types(v)]
    return []


def test_model_configs_found():
    assert len(MODEL_CONFIGS) == 31
    assert len(ALL_CONFIGS) - len(MODEL_CONFIGS) == 4


@pytest.mark.parametrize('path', MODEL_CONFIGS,
                         ids=[osp.relpath(p, REPO) for p in MODEL_CONFIGS])
def test_config_builds_or_names_an_unported_type(path):
    cfg = Config.fromfile(path)
    assert j_build_segmentor(JConfig.fromfile(path).model) is not None
    missing = [t for t in _types(cfg.model) if t not in MODELS]
    try:
        with torch.device('meta'):
            model = build_segmentor(cfg.model)
    except KeyError as e:
        assert osp.basename(path) not in PORTED_BASES, (path, str(e))
        assert missing, f'{path}: KeyError with every type ported: {e}'
        assert any(f'{t} is not in the models registry' in str(e)
                   for t in missing), (str(e), missing)
        return
    assert not missing, (path, missing)
    head = cfg.model['decode_head']
    if isinstance(head, list):      # a cascade: the last stage's classes
        head = head[-1]
    assert model.num_classes == head['num_classes']
    assert sum(p.numel() for p in model.parameters()) > 0


def test_every_model_type_is_ported():
    """With the real-time CNNs every module type that a config under
    configs/ names is in the port's registry."""
    missing = {t for p in MODEL_CONFIGS
               for t in _types(Config.fromfile(p).model) if t not in MODELS}
    assert not missing, sorted(missing)


def _shrunk(name):
    mc = copy.deepcopy(dict(Config.fromfile(
        osp.join(REPO, 'configs', '_base_', 'models', name)).model))
    vit = dict(img_size=(64, 64), embed_dims=64, num_heads=4)
    if name == 'segmenter_vit-b_mask.py':
        mc['backbone'].update(vit, num_layers=2, out_indices=(1,))
        mc['decode_head'].update(in_channels=64, embed_dims=64, num_heads=4,
                                 num_layers=1, channels=64)
    elif name == 'setr_mla.py':
        mc['backbone'].update(vit, num_layers=4, out_indices=(0, 1, 2, 3))
        mc['neck']['in_channels'] = [64] * 4
    elif name == 'setr_pup.py':
        mc['backbone'].update(vit, num_layers=4, out_indices=(0, 1, 2, 3))
        for head in [mc['decode_head']] + mc['auxiliary_head']:
            head['in_channels'] = 64
    elif name == 'upernet_swin.py':
        mc['backbone'].update(embed_dims=24, num_heads=[1, 2, 3, 6])
        mc['decode_head'].update(in_channels=[24, 48, 96, 192], channels=16)
        mc['auxiliary_head'][0].update(in_channels=96, channels=16)
    elif name == 'ocrnet_hr18.py':
        mc['backbone']['extra'] = hrnet_extra()
        for head in mc['decode_head']:
            head.update(in_channels=[4, 8, 16, 32], channels=16)
        mc['decode_head'][1]['ocr_channels'] = 8
    elif name in REALTIME_BASES:
        pass
    elif name in CNN_BASES:
        # ResNet-50 at stem 16, base 8: stages of 32, 64, 128, 256
        narrow = dict(stem_channels=16, base_channels=8)
        heads = [mc['decode_head']] + mc.get('auxiliary_head', [])
        if name == 'icnet_r50-d8.py':
            mc['backbone']['backbone_cfg'].update(narrow)
            mc['backbone'].update(layer_channels=(64, 256),
                                  light_branch_middle_channels=8,
                                  psp_out_channels=16, out_channels=(8, 16, 16))
            mc['neck'].update(in_channels=(8, 16, 16), out_channels=16)
            for head in heads:
                head.update(in_channels=16, channels=16)
        elif name == 'fpn_r50.py':
            mc['backbone'].update(narrow)
            mc['neck'].update(in_channels=[32, 64, 128, 256], out_channels=16)
            mc['decode_head'].update(in_channels=[16] * 4, channels=16)
        else:
            mc['backbone'].update(narrow)
            mc['decode_head'].update(in_channels=256, channels=16)
            if name == 'deeplabv3plus_r50-d8.py':
                mc['decode_head'].update(c1_in_channels=32, c1_channels=8)
            for head in mc['auxiliary_head']:
                head.update(in_channels=128, channels=16)
    return mc


@pytest.mark.parametrize('name', PORTED_BASES)
def test_base_model_tiny_forward_matches_jax(name):
    mc = _shrunk(name)
    jcfg = copy.deepcopy(mc)
    if jcfg['backbone']['type'] == 'VisionTransformer':
        jcfg['backbone']['use_flash'] = False
    jmodel = j_build_segmentor(jcfg)
    if name in CNN_BASES:
        v = shaped_variables(lambda: init_segmentor_variables(
            jmodel, jax.random.PRNGKey(0), (1, 64, 64, 3)), 0)
    else:
        # jitted: eagerly, JAX dispatches (and compiles) op by op
        v = jax.jit(lambda key: init_segmentor_variables(
            jmodel, key, (1, 64, 64, 3)))(jax.random.PRNGKey(0))
        v = perturbed({'params': v['params'],
                       'batch_stats': v.get('batch_stats', {})}, 0)
    img = np.random.RandomState(0).randn(1, 64, 64, 3).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        jax.tree_util.tree_map(jnp.asarray, v), jnp.asarray(img)))
    model = build_segmentor(mc).eval()
    model.load_state_dict(state_dict_from_jax_variables(v))
    with torch.no_grad():
        got = model(torch.from_numpy(img)).numpy()
    assert got.shape == want.shape == (1, 64, 64, 19)
    if name == 'segmenter_vit-b_mask.py':
        # JAX's test keeps the tap 11 of 2 layers (clamped); the port refuses
        with pytest.raises(ValueError, match='out_indices'):
            build_segmentor(dict(mc, backbone=dict(mc['backbone'],
                                                   out_indices=(11,))))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ATOL * np.abs(want).max())
