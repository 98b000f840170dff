"""The ViT, SETR-UP and PASA options of the JAX modules, held to them on the
CPU in f32 from one set of perturbed weights: ``qkv_bias=False``,
``use_flash=False`` (which must call no flash kernel), ``final_norm``,
``output_cls_token``, the SETR-UP head's ``use_addition_up_scale`` and
PASA's ``layer_scales`` (a per-layer bias [num_layers, B, 1, T, T], layer i
taking its slice)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import s4former_tpu.models  # noqa: F401  (registers the JAX modules)
import s4former_tpu_torch.models  # noqa: F401
from s4former_tpu.registry import BACKBONES as J_BACKBONES
from s4former_tpu.registry import HEADS as J_HEADS
from s4former_tpu.semi.pasa import build_pasa_bias as j_build_pasa_bias
from s4former_tpu_torch.core.checkpoint import state_dict_from_jax_variables
from s4former_tpu_torch.ops import attention as attention_mod
from s4former_tpu_torch.registry import BACKBONES, HEADS
from s4former_tpu_torch.semi.pasa import build_pasa_bias
from tests._torch_port import image_batch, perturbed

ATOL = RTOL = 1e-4       # f32 on both sides, sums in another order
VIT = dict(type='VisionTransformer', img_size=(64, 64), patch_size=16,
           embed_dims=32, num_layers=2, num_heads=4, out_indices=(0, 1))
VIT_OPTIONS = {
    'qkv_bias_off': dict(qkv_bias=False),
    'use_flash_off': dict(use_flash=False),
    'final_norm': dict(final_norm=True),
    'output_cls_token': dict(output_cls_token=True),
}


def _vit_pair(options, seed=0):
    """(JAX module, its perturbed variables, the port's module on them)."""
    cfg = dict(VIT, **options)
    jmodel = J_BACKBONES.build(dict(cfg))
    v = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 3)))
    params = perturbed({'params': v['params']}, seed)['params']
    sd = state_dict_from_jax_variables({'params': {'backbone_m': params}})
    model = BACKBONES.build(dict(cfg)).eval()
    own = {k[len('backbone.'):]: t for k, t in sd.items()}
    model.load_state_dict(own)
    return jmodel, jax.tree_util.tree_map(jnp.asarray, params), model, own


def _taps(out):
    """A tap, or [map, cls token], as a flat list of numpy arrays."""
    flat = []
    for tap in out:
        flat += [np.asarray(t) for t in tap] if isinstance(tap, (list, tuple)) \
            else [np.asarray(tap)]
    return flat


@pytest.mark.parametrize('option', list(VIT_OPTIONS))
def test_vit_option_matches_jax(option, monkeypatch):
    jmodel, jparams, model, sd = _vit_pair(VIT_OPTIONS[option])
    if option == 'qkv_bias_off':
        # mmseg's layout: the key is absent, not zero
        assert not any('in_proj_bias' in k for k in sd)
        assert model.layers[0].attn.attn.in_proj_bias is None
    if option == 'final_norm':
        assert 'ln1.weight' in sd
    calls = []
    real = attention_mod.flash_attention
    monkeypatch.setattr(attention_mod, 'flash_attention',
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x = image_batch(1, 64, 64)
    want = jmodel.apply({'params': jparams}, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    want, got = _taps(want), _taps(got)
    assert len(got) == len(want) == (4 if option == 'output_cls_token'
                                     else 2)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    # the option's own path: no flash call at all; the default takes the
    # flash wrapper in every layer (its plain version on the CPU)
    assert len(calls) == (0 if option == 'use_flash_off' else 2)


def test_output_cls_token_needs_the_cls_token():
    with pytest.raises(ValueError, match='with_cls_token'):
        BACKBONES.build(dict(VIT, output_cls_token=True,
                             with_cls_token=False))


HEAD = dict(type='SETRUPHead', in_channels=32, channels=16, num_classes=5,
            in_index=0, num_convs=2, up_scale=2, kernel_size=3,
            use_addition_up_scale=True)


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_setr_up_addition_up_scale_matches_jax(train):
    jhead = J_HEADS.build(dict(HEAD))
    x = np.random.RandomState(2).normal(0, 1, (2, 4, 4, 32)).astype(
        np.float32)
    v = jhead.init(jax.random.PRNGKey(0), [jnp.asarray(x)])
    variables = perturbed({'params': v['params'],
                           'batch_stats': v['batch_stats']}, 1)
    sd = state_dict_from_jax_variables(
        {'params': {'decode_head_m': variables['params']},
         'batch_stats': {'decode_head_m': variables['batch_stats']}})
    head = HEADS.build(dict(HEAD))
    head.load_state_dict({k[len('decode_head.'):]: t for k, t in sd.items()})
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    if train:
        want, _ = jhead.apply(jv, [jnp.asarray(x)], train=True,
                              mutable=['batch_stats'])
    else:
        want = jhead.apply(jv, [jnp.asarray(x)])
    with torch.no_grad():
        got = head([torch.from_numpy(x)], train=train)
    # 4 -> x2 (+x2) -> 16 -> deferred x4: 64, twice the scale without it
    assert tuple(got.shape) == tuple(want.shape) == (2, 64, 64, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_pasa_layer_scales_match_jax_and_feed_each_layer():
    rs = np.random.RandomState(4)
    unconf = rs.uniform(0, 1, (2, 16)).astype(np.float32)
    scales = np.asarray([0.5, 2.0], np.float32)
    want = j_build_pasa_bias(jnp.asarray(unconf), 5.0, True,
                             layer_scales=jnp.asarray(scales))
    got = build_pasa_bias(torch.from_numpy(unconf), 5.0, True,
                          layer_scales=torch.from_numpy(scales))
    assert tuple(got.shape) == tuple(want.shape) == (2, 2, 1, 17, 17)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)

    # the ViT hands layer i its slice: equal scales give the JAX ViT's
    # output on the shared 4-D bias; unequal ones, layer by layer
    jmodel, jparams, model, _ = _vit_pair({})
    x = np.concatenate([image_batch(3, 64, 64), image_batch(5, 64, 64)])
    bias = build_pasa_bias(torch.from_numpy(unconf), 5.0, True)
    want = jmodel.apply({'params': jparams}, jnp.asarray(x),
                        attn_bias=jnp.asarray(bias.numpy()))
    with torch.no_grad():
        got = model(torch.from_numpy(x),
                    attn_bias=bias[None].expand(2, -1, -1, -1, -1))
        per_layer = model(torch.from_numpy(x), attn_bias=_scaled(
            bias, torch.from_numpy(scales)))
        h = model.layers[0](_tokens(model, x), 0.5 * bias)
        first = h[:, 1:].reshape(2, 4, 4, 32)
        h = model.layers[1](h, 2.0 * bias)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(per_layer[0].numpy(), first.numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(per_layer[1].numpy(),
                               h[:, 1:].reshape(2, 4, 4, 32).numpy(),
                               rtol=1e-6, atol=1e-6)


def _scaled(bias, scales):
    """build_pasa_bias's per-layer stack from its 4-D bias."""
    return bias[None] * scales[:, None, None, None, None]


def _tokens(model, x):
    """The ViT's tokens before the first layer (cls + patches + pos)."""
    t = model.patch_embed(torch.from_numpy(x), torch.float32)
    cls = model.cls_token.expand(t.shape[0], -1, -1)
    return torch.cat([cls, t], dim=1) + model.pos_embed
