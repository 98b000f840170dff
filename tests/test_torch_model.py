"""The port's modules held to the JAX package on the CPU, in f32, from one
set of perturbed weights: ViT taps (and attention maps), SETR-PUP head,
EncoderDecoder.encode_decode, and the weight bridge."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s4former_tpu.apis import init_segmentor as j_init_segmentor
from s4former_tpu.core.checkpoint import (_resize_pos_embed_np,
                                          export_reference_state_dict)
from s4former_tpu.models.decode_heads.base import \
    transform_inputs as j_transform_inputs
from s4former_tpu_torch.config import Config
from s4former_tpu_torch.core.checkpoint import (load_reference_state_dict,
                                                state_dict_from_jax_variables)
from s4former_tpu_torch.models import build_segmentor
from s4former_tpu_torch.models.decode_heads.base import transform_inputs
from tests._torch_port import image_batch, jax_variables, write_tiny_config

# f32 on both sides; sums run in another order (XLA vs ATen), and the
# error grows through 2 layers and the head's convs
ATOL = RTOL = 1e-4


@pytest.fixture(scope='module')
def models(tmp_path_factory):
    cfg_path = write_tiny_config(tmp_path_factory.mktemp('cfg'))
    js = j_init_segmentor(cfg_path)
    variables = jax_variables(js, seed=0)
    model = build_segmentor(Config.fromfile(cfg_path).model).eval()
    model.load_state_dict(state_dict_from_jax_variables(variables))
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    return js.model, jv, model, variables


# 50 x 70 is neither square nor 16-divisible: AdaptivePadding pads it to
# 64 x 80 and the 4 x 4 pos-embed grid is resized to 4 x 5
@pytest.mark.parametrize('hw', [(64, 64), (50, 70)], ids=['crop', 'ragged'])
def test_vit_taps_and_attention_maps(models, hw):
    jmodel, jv, model, _ = models
    x = image_batch(1, *hw)
    feats_j, (attn_j, hw_j) = jmodel.apply(
        jv, method='extract_feat', img=jnp.asarray(x), return_attn=True)
    with torch.no_grad():
        feats, (attn, grid) = model.extract_feat(torch.from_numpy(x),
                                                 return_attn=True)
    assert tuple(grid) == tuple(hw_j)
    assert len(feats) == len(feats_j) == 2
    for f, f_j in zip(feats, feats_j):
        np.testing.assert_allclose(f.numpy(), np.asarray(f_j), rtol=RTOL,
                                   atol=ATOL)
    for a, a_j in zip(attn, attn_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(a_j), rtol=RTOL,
                                   atol=1e-6)


def test_vit_with_pasa_bias(models):
    jmodel, jv, model, _ = models
    x = image_batch(2, 64, 64)
    bias = np.random.RandomState(3).normal(
        0, 1.0, (1, 1, 17, 17)).astype(np.float32)
    f_j = jmodel.apply(jv, method='forward_decode_from_img',
                       img=jnp.asarray(x), train=False,
                       attn_bias=jnp.asarray(bias))
    with torch.no_grad():
        f = model.forward_decode_from_img(torch.from_numpy(x),
                                          attn_bias=torch.from_numpy(bias))
    np.testing.assert_allclose(f.numpy(), np.asarray(f_j), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize('pos_mode', ['none', 'avg', 'duplicate'])
def test_vit_pos_embed_ablations(models, pos_mode):
    jmodel, jv, model, _ = models
    x = image_batch(6, 64, 64)
    feats_j = jmodel.apply(jv, method='extract_feat', img=jnp.asarray(x),
                           pos_mode=pos_mode)
    with torch.no_grad():
        feats = model.extract_feat(torch.from_numpy(x), pos_mode=pos_mode)
    for f, f_j in zip(feats, feats_j):
        np.testing.assert_allclose(f.numpy(), np.asarray(f_j), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize('transform', ['resize_concat', 'multiple_select'])
def test_transform_inputs(transform):
    rs = np.random.RandomState(7)
    feats = [rs.normal(size=(1, 4 * 2 ** i, 6 * 2 ** i, 3)).astype(
        np.float32) for i in range(3)]
    ref = j_transform_inputs([jnp.asarray(f) for f in feats], [0, 2],
                             transform)
    out = transform_inputs([torch.from_numpy(f) for f in feats], [0, 2],
                           transform)
    ref = ref if isinstance(ref, list) else [ref]
    out = out if isinstance(out, list) else [out]
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


def test_setr_up_heads(models):
    """The main head (classifier before its last upsample) and the aux
    heads (one conv) on the same backbone features."""
    jmodel, jv, model, _ = models
    rs = np.random.RandomState(4)
    feats = [rs.normal(size=(1, 4, 5, 64)).astype(np.float32)
             for _ in range(2)]
    main_j = jmodel.apply(jv, method='decode_logits',
                          feats=[jnp.asarray(f) for f in feats])
    aux_j = jmodel.apply(jv, method='aux_logits',
                         feats=[jnp.asarray(f) for f in feats])
    with torch.no_grad():
        main = model.decode_logits([torch.from_numpy(f) for f in feats])
        aux = model.aux_logits([torch.from_numpy(f) for f in feats])
    assert main.shape == (1, 16, 20, 5)
    np.testing.assert_allclose(main.numpy(), np.asarray(main_j), rtol=RTOL,
                               atol=ATOL)
    assert len(aux) == len(aux_j) == 2
    for a, a_j in zip(aux, aux_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(a_j), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize('hw', [(64, 64), (50, 70)], ids=['crop', 'ragged'])
def test_encode_decode(models, hw):
    jmodel, jv, model, _ = models
    x = image_batch(5, *hw)
    ref = jmodel.apply(jv, jnp.asarray(x), train=False)
    with torch.no_grad():
        out = model.encode_decode(torch.from_numpy(x))
    assert out.shape == (1, *hw, 5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_bridge_matches_export_reference_state_dict(models):
    """state_dict_from_jax_variables gives export_reference_state_dict's
    keys and values, which are exactly the port's state_dict keys."""
    _, _, model, variables = models
    ema = jax.tree_util.tree_map(lambda a: a * 0.5, variables)
    full = dict(variables, ema_params=ema['params'],
                ema_batch_stats=ema['batch_stats'])
    ref = export_reference_state_dict(full)
    ours = state_dict_from_jax_variables(full)
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v),
                                      err_msg=k)
    student = {k for k in ref if '_ema.' not in k}
    assert set(model.state_dict()) == student


def test_load_reference_state_dict_resizes_pos_embed(models, tmp_path):
    """A .pth whose pos-embed grid differs from the crop's is resized
    bicubically on load, as the JAX package does (tolerance 1e-6: the same
    torch interpolate on both sides); BN counters are dropped."""
    _, _, model, variables = models
    sd = export_reference_state_dict(variables)
    pos = np.random.RandomState(8).normal(
        size=(1, 1 + 6 * 6, 64)).astype(np.float32)
    sd['backbone.pos_embed'] = pos
    sd['decode_head.up_convs.0.0.bn.num_batches_tracked'] = np.asarray(7)
    path = tmp_path / 'grid6.pth'
    torch.save({'state_dict': {k: torch.from_numpy(np.asarray(v))
                               for k, v in sd.items()}}, path)
    loaded = load_reference_state_dict(str(path), dst_grid=(4, 4))
    np.testing.assert_allclose(loaded['backbone.pos_embed'].numpy(),
                               _resize_pos_embed_np(pos, (4, 4)), atol=1e-6)
    assert set(loaded) == set(model.state_dict())
