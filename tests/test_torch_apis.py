"""The port's serving slice held to the JAX package on the CPU, in f32:
init_segmentor + inference (whole, slide, flip), inference_segmentor,
inference_with_teacher_pasa and inference_segmentor_with_attn, from the
same weights given directly and through a .pth file; and the flagship
configs."""
import inspect
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s4former_tpu import apis as japis
from s4former_tpu.config import Config as JConfig
from s4former_tpu.core.checkpoint import export_reference_state_dict
from s4former_tpu.models.segmentors.inference import inference as j_inference
from s4former_tpu.ops.resize import resize_bilinear as j_resize_bilinear
from s4former_tpu.semi.pasa import build_pasa_bias as j_build_pasa_bias
from s4former_tpu_torch import apis
from s4former_tpu_torch.config import Config
from s4former_tpu_torch.core.checkpoint import (ema_state_dict,
                                                load_reference_state_dict,
                                                state_dict_from_jax_variables)
from s4former_tpu_torch.models import build_segmentor
from s4former_tpu_torch.ops import flash_attention as fa
from tests._torch_port import (assert_argmax_agrees, image_batch,
                               jax_variables, perturbed, write_tiny_config)

# probabilities in f32 on both sides (sums in another order)
ATOL = 1e-4
FLAGSHIP = osp.join(osp.dirname(__file__), '..', 'configs', 'setr',
                    'setr_deit-base_pup_bs_8_512x512_80k_pascal_1over16_'
                    'split_classic_{}.py')


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp('cfg')
    paths = {m: write_tiny_config(d, m) for m in ('whole', 'slide')}
    js = japis.init_segmentor(paths['whole'])
    variables = jax_variables(js, seed=0)
    ema = perturbed(variables, seed=1)
    js.variables = jax.tree_util.tree_map(jnp.asarray, variables)
    j_ema = jax.tree_util.tree_map(jnp.asarray, ema)
    sd = state_dict_from_jax_variables(variables)
    ema_sd = ema_state_dict(state_dict_from_jax_variables(
        dict(variables, ema_params=ema['params'],
             ema_batch_stats=ema['batch_stats'])))
    return dict(paths=paths, js=js, j_ema=j_ema, variables=variables,
                ema=ema, sd=sd, ema_sd=ema_sd, dir=d)


def _port(setup, mode='whole', checkpoint=None):
    seg = apis.init_segmentor(setup['paths'][mode], checkpoint=checkpoint,
                              device='cpu')
    if checkpoint is None:
        seg.model.load_state_dict(setup['sd'])
    return seg


def _image(seed, h, w):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3), np.uint8)


@pytest.mark.parametrize('flip', [False, True], ids=['plain', 'flip'])
@pytest.mark.parametrize('mode', ['whole', 'slide'])
def test_inference_probs_match_jax(setup, mode, flip):
    js = setup['js']
    seg = _port(setup, mode)
    jseg = japis.Segmentor(js.model, js.variables,
                           JConfig.fromfile(setup['paths'][mode]))
    assert (seg.mode, seg.crop_size, seg.stride) == \
        (jseg.mode, jseg.crop_size, jseg.stride)
    x = image_batch(7, 80, 100)
    ref = np.asarray(j_inference(
        jseg.apply_fn, jnp.asarray(x), 5, mode=mode, crop_size=jseg.crop_size,
        stride=jseg.stride, flip=flip))
    out = seg.probs(torch.from_numpy(x), flip=flip).numpy()
    assert out.shape == (1, 80, 100, 5)
    np.testing.assert_allclose(out, ref, atol=ATOL)
    assert_argmax_agrees(ref, out, ATOL)


def _pasa_probs_jax(setup, img):
    """The JAX teacher-PASA path of apis.py:134-164, up to the student's
    probabilities (whose top-2 margins say where labels must agree)."""
    js = setup['js']
    x, _ = japis._prepare_image(js, img)
    x = jnp.asarray(x)
    t = js.model.apply(setup['j_ema'], method='forward_decode_from_img',
                       img=x, train=False)
    conf = jnp.max(jax.nn.softmax(t.astype(jnp.float32), -1), -1)
    b, hh, ww = conf.shape
    pool = max(hh // (x.shape[1] // 16), 1)
    unconf = jnp.mean((1.0 - conf).reshape(b, hh // pool, pool, ww // pool,
                                           pool), axis=(2, 4)).reshape(b, -1)
    logits = js.model.apply(js.variables, method='forward_decode_from_img',
                            img=x, train=False,
                            attn_bias=j_build_pasa_bias(unconf, 5.0, True))
    logits = j_resize_bilinear(logits, x.shape[1:3], False)
    return np.asarray(jax.nn.softmax(logits.astype(jnp.float32), -1))


@pytest.mark.parametrize('source', ['state_dict', 'pth'])
def test_serving_apis_match_jax(setup, source):
    """inference_segmentor and inference_with_teacher_pasa label maps, from
    weights given directly or loaded from a .pth written by the JAX
    package's export_reference_state_dict."""
    js = setup['js']
    if source == 'pth':
        path = str(setup['dir'] / 'tiny.pth')
        export_reference_state_dict(
            dict(setup['variables'], ema_params=setup['ema']['params'],
                 ema_batch_stats=setup['ema']['batch_stats']), path=path)
        seg = _port(setup, checkpoint=path)
        ema_sd = ema_state_dict(load_reference_state_dict(path))
        assert set(ema_sd) == set(setup['ema_sd'])
    else:
        seg = _port(setup)
        ema_sd = setup['ema_sd']
    img = _image(8, 50, 70)     # padded to 64 x 70, then to 64 x 80 (ViT)
    launches = fa.launch_count
    x, _ = apis._prepare_image(seg, img)
    p_ref = np.asarray(j_inference(js.apply_fn, jnp.asarray(x), 5))
    np.testing.assert_allclose(seg.probs(torch.from_numpy(x)).numpy(), p_ref,
                               atol=ATOL)
    labels = apis.inference_segmentor(seg, img)
    assert labels.shape == (50, 70) and labels.dtype == np.int32
    np.testing.assert_array_equal(
        np.asarray(japis.inference_segmentor(js, img)),
        p_ref[0].argmax(-1)[:50, :70])
    assert_argmax_agrees(p_ref[0, :50, :70], _onehot(labels), ATOL)

    p_pasa = _pasa_probs_jax(setup, img)[0, :50, :70]
    labels = apis.inference_with_teacher_pasa(seg, img, ema_sd)
    assert labels.shape == (50, 70)
    assert_argmax_agrees(p_pasa, _onehot(labels), ATOL)
    # the bias changes the answer, so the test does see the PASA path
    assert not np.array_equal(labels, apis.inference_segmentor(seg, img))
    assert fa.launch_count == launches      # the CPU never reaches the kernel


def _onehot(labels):
    return np.eye(5, dtype=np.float32)[labels]


def test_inference_with_attn_matches_jax(setup):
    js = setup['js']
    seg = _port(setup)
    img = _image(9, 50, 70)
    s_j, l_j, a_j = japis.inference_segmentor_with_attn(js, img)
    s, logits, attns = apis.inference_segmentor_with_attn(seg, img)
    assert s.shape == (50, 70)
    np.testing.assert_allclose(logits, l_j, rtol=1e-4, atol=ATOL)
    assert [a.shape for a in attns] == [a.shape for a in a_j]
    for a, b in zip(attns, a_j):
        np.testing.assert_allclose(a, b, atol=1e-6)


@pytest.mark.parametrize('variant', ['sup', 'semi_beta_1_th_0.95_MT_w_ours'])
def test_flagship_configs_build_at_full_width(variant):
    """The flagship configs load unchanged (``_base_`` chains, bf16 dtype,
    semi flags) and build DeiT-B SETR-PUP with four aux heads; built on the
    meta device, so no memory is spent."""
    cfg = Config.fromfile(FLAGSHIP.format(variant))
    with torch.device('meta'):
        model = build_segmentor(cfg.model)
    bb = model.backbone
    assert (bb.embed_dims, bb.num_heads, len(bb.layers)) == (768, 12, 12)
    assert bb.dtype == torch.bfloat16 and model.decode_head.dtype == \
        torch.bfloat16
    assert bb.pos_embed.shape == (1, 1025, 768)
    assert len(model.auxiliary_head) == 4 and model.num_classes == 21
    n = sum(p.numel() for p in model.backbone.parameters())
    assert 85e6 < n < 87e6          # DeiT-B
    assert cfg.model.test_cfg['mode'] == 'whole'


def test_init_segmentor_defaults_to_cuda():
    sig = inspect.signature(apis.init_segmentor)
    assert sig.parameters['device'].default == 'cuda'
