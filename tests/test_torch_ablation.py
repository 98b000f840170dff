"""The ablation flags of the port's S4Former step, module by module, held to
the JAX package on the CPU in f32 (the 3-step trajectories of each flag
group are in test_torch_ablation_step.py).

- Mixes: each JAX mix function's draws are made again here from the same
  key with the same ``jax.random`` calls, handed to the port's apply, and
  the result compared with the JAX function's output: masks, labels and
  permuted or selected images bit for bit, blended images within 1e-6.
  The port's own draws are held by their laws: box area against
  ``cutout_area``, k patches cut, n // 2 + 1 classes chosen, gate and
  keep rates within 5 sigma over 10^5 draws, Beta means within 5 sigma.
- Dropout, drop path and fdrop: the same masks go to both packages, by
  monkeypatching ``jax.random.bernoulli`` and the port's
  ``models.dropout.keep_mask`` in the test (nothing of either package is
  edited). One unscanned JAX ``TransformerEncoderLayer`` takes its masks in
  call order; the scanned ViT, the SETR heads and the MiT take one mask per
  (shape, keep), which a scan traced once also gets. Outputs within 1e-5.
- Deterministic modules: the sigmoid CE within 1e-6, the layer-wise decay
  multipliers equal through the weight bridge, the EMA with head dropout
  within 1e-6 given the same skips.
"""
import copy
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s4former_tpu.core.optim import \
    build_layer_decay_trees as j_build_layer_decay_trees
from s4former_tpu.models import build_segmentor as j_build_segmentor
from s4former_tpu.models import init_segmentor_variables
from s4former_tpu.models.backbones.vit import \
    TransformerEncoderLayer as JLayer
from s4former_tpu.models.losses import cross_entropy as jce
from s4former_tpu.semi import ema as jema
from s4former_tpu.semi import mixes as jmixes
from s4former_tpu_torch.core.checkpoint import state_dict_from_jax_variables
from s4former_tpu_torch.core.optim import build_layer_decay_trees
from s4former_tpu_torch.models import build_segmentor
from s4former_tpu_torch.models import dropout as tdrop
from s4former_tpu_torch.models.losses import cross_entropy as ce
from s4former_tpu_torch.semi import ema, mixes
from s4former_tpu_torch.semi.config import SemiConfig
from s4former_tpu_torch.semi.train_step import _gate, train_state_from_jax
from tests._torch_port import (TRAIN_MODEL, jax_train_model, mit_model_cfg,
                               perturbed, torch_train_model)

NCLS = 5
BLEND_ATOL = 1e-6
FWD_ATOL = 1e-5
N_DRAWS = 100_000


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def _images_labels(seed, b=4, hw=64, ignore=True):
    """Normalised-image-like floats and labels with a missing class, an
    ignore block and one sample of a single class."""
    rs = np.random.RandomState(seed)
    imgs = rs.randn(b, hw, hw, 3).astype(np.float32)
    labels = rs.randint(0, NCLS - 1, (b, hw, hw)).astype(np.int32)
    if ignore:
        labels[:, :hw // 4, :hw // 4] = 255
    labels[-1] = 2
    return imgs, labels


def _assert_mix(got, want):
    (gi, gl), (wi, wl) = got, want
    np.testing.assert_array_equal(_np(gl), _np(wl))
    np.testing.assert_allclose(_np(gi), _np(wi), rtol=0, atol=BLEND_ATOL)


# ------------------------------------------------------- the JAX draws
def j_class_scores(key, b, patchwise, n_patches):
    """The uniforms JAX ``classmix`` draws inside its vmaps."""
    keys = jax.random.split(key, b)
    uniform = jax.vmap(lambda k: jax.random.uniform(k, (NCLS,)))
    if not patchwise:
        return np.asarray(uniform(keys))
    return np.stack([np.asarray(uniform(jax.random.split(k, n_patches)))
                     for k in keys])


def j_adaptive_draws(key, b, hw):
    """The draws of JAX ``cutmix_label_adaptive``, by the port's names."""
    h, w = hw
    k1, k2, k3, k4, k5, k6 = jax.random.split(key, 6)
    out = {'perm': jax.random.permutation(k1, b),
           'lam_l': jax.random.beta(k2, 8.0, 2.0),
           'lam_u': jax.random.beta(k3, 4.0, 4.0),
           'u': jax.random.uniform(k6, (b,))}
    for k, tag in ((k4, 'l'), (k5, 'u')):
        kx, ky = jax.random.split(k)
        out['cx_' + tag] = jax.random.randint(kx, (b,), w // 8, w)
        out['cy_' + tag] = jax.random.randint(ky, (b,), h // 8, h)
    return {k: np.asarray(v) for k, v in out.items()}


# ------------------------------------------------------------- CutMix
@pytest.mark.parametrize('seed', [0, 1])
def test_patchwise_cutmix_matches_jax(seed):
    """JAX cutmix(patchwise) == the port's apply of JAX's masks; the port
    builds the same masks from JAX's per-patch scores."""
    imgs, labels = _images_labels(seed)
    key = jax.random.PRNGKey(seed)
    want = jmixes.cutmix(key, jnp.asarray(imgs), jnp.asarray(labels), 2.0,
                         True, 16)
    masks = np.asarray(jmixes._batch_patchwise_masks(key, 4, (64, 64), 16,
                                                     2.0))
    _assert_mix(mixes.cutmix_with_masks(_t(masks), _t(imgs), _t(labels)),
                want)
    scores = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (16,)))(
        jax.random.split(key, 4)))
    np.testing.assert_array_equal(
        mixes.patchwise_mask_from_scores(_t(scores), (64, 64), 16,
                                         2.0).numpy(), masks)


def test_sup_cutmix_matches_jax():
    imgs, labels = _images_labels(3)
    key = jax.random.PRNGKey(3)
    want = jmixes.sup_cutmix(key, jnp.asarray(imgs), jnp.asarray(labels))
    masks = np.asarray(jmixes._batch_box_masks(key, 4, (64, 64), 2.0))
    _assert_mix(mixes.cutmix_with_masks(_t(masks), _t(imgs), _t(labels)),
                want)


@pytest.mark.parametrize('patchwise', [False, True])
def test_cutout_matches_jax(patchwise):
    imgs, labels = _images_labels(4)
    key = jax.random.PRNGKey(4)
    want = jmixes.cutout(key, jnp.asarray(imgs), jnp.asarray(labels), 2.0,
                         patchwise, 32)
    masks = np.asarray(
        jmixes._batch_patchwise_masks(key, 4, (64, 64), 32, 2.0)
        if patchwise else jmixes._batch_box_masks(key, 4, (64, 64), 2.0))
    got = mixes.cutout_with_masks(_t(masks), _t(imgs), _t(labels))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize('patchwise', [False, True])
def test_classmix_matches_jax(patchwise):
    """Whole-image and per-super-patch class selection (patchsize 32 of a
    64² image: 4 super-patches, one of them all 255 and one of one
    class)."""
    imgs, labels = _images_labels(5)
    labels[0, :32, 32:] = 1
    labels[1, 32:, 32:] = 255
    key = jax.random.PRNGKey(5)
    want = jmixes.classmix(key, jnp.asarray(imgs), jnp.asarray(labels),
                           NCLS, patchwise, 32)
    scores = j_class_scores(key, 4, patchwise, 4)
    got = mixes.classmix_with_scores(_t(scores), _t(imgs), _t(labels), NCLS,
                                     patchwise, 32)
    _assert_mix(got, want)


def test_mix_with_labeled_matches_jax():
    imgs, labels = _images_labels(6)
    sup_imgs, sup_labels = _images_labels(7)
    conf = (np.random.RandomState(8).rand(4, 64, 64) > 0.995).astype(
        np.int32)
    conf[0, :16, :16] = 1
    want = jmixes.mix_with_labeled(*map(jnp.asarray, (
        imgs, labels, sup_imgs, sup_labels, conf)), 16)
    got = mixes.mix_with_labeled(*map(_t, (imgs, labels, sup_imgs,
                                           sup_labels, conf)), 16)
    _assert_mix(got, want)
    assert 0 < (_np(got[1]) != labels).mean() < 1


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_cutmix_label_adaptive_matches_jax(seed):
    """Given JAX's draws, the port's apply gives JAX's images, labels and
    probabilities bit for bit (where-selections only), with the reference's
    row/column quirk."""
    imgs, labels = _images_labels(10 + seed)
    sup_imgs, sup_labels = _images_labels(20 + seed)
    rs = np.random.RandomState(seed)
    max_probs = rs.rand(4, 64, 64).astype(np.float32)
    conf = np.array([0.0, 1.0, 0.5, rs.rand()], np.float32)
    key = jax.random.PRNGKey(seed)
    want = jmixes.cutmix_label_adaptive(
        key, *map(jnp.asarray, (imgs, labels, max_probs, sup_imgs,
                                sup_labels, conf)))
    draws = {k: _t(v) for k, v in j_adaptive_draws(key, 4, (64, 64)).items()}
    got = mixes.cutmix_label_adaptive(draws, *map(_t, (
        imgs, labels, max_probs, sup_imgs, sup_labels, conf)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    assert (_np(got[0]) != imgs).any()


# --------------------------------------------------- the port's draws
def test_box_masks_cut_the_area():
    """Box area within rounding of H*W/ratio, the box inside the image."""
    for ratio in (2.0, 4.0):
        m = mixes.random_box_mask(torch.Generator().manual_seed(0), 2000,
                                  (64, 48), ratio)
        cut = (m == 0).sum(dim=(1, 2)).float()
        rows = (m == 0).any(dim=2).sum(dim=1).float()
        assert ((cut - 64 * 48 / ratio).abs() <= rows / 2 + 64).all()
        assert cut.min() > 0


@pytest.mark.parametrize('ratio', [2.0, 4.0])
def test_patchwise_masks_cut_k_patches(ratio):
    m = mixes.random_patchwise_mask(torch.Generator().manual_seed(1), 500,
                                    (64, 96), 16, ratio)
    patches = m.reshape(500, 4, 16, 6, 16)
    whole = patches.amin(dim=(2, 4)) == patches.amax(dim=(2, 4))
    assert whole.all()
    assert ((patches[:, :, 0, :, 0] == 0).sum(dim=(1, 2)) ==
            int(24 // ratio)).all()


@pytest.mark.parametrize('patchwise', [False, True])
def test_class_masks_select_half_the_classes(patchwise):
    """n // 2 + 1 of the n present classes are kept (per 32² super-patch
    with ``patchwise``, none where it has one class, and its 255 pixels
    kept)."""
    imgs, labels = _images_labels(30, b=64)
    labels[:, 32:, :32] = 3
    scores = mixes.class_scores(torch.Generator().manual_seed(2), 64, NCLS,
                                (64, 64), patchwise, 32)
    m = mixes.class_masks(scores, _t(labels), NCLS, patchwise, 32).bool()
    lab = _t(labels)
    regions = [(slice(None), slice(None))] if not patchwise else \
        [(slice(r, r + 32), slice(c, c + 32)) for r in (0, 32)
         for c in (0, 32)]
    for i in range(64):
        for rows, cols in regions:
            li, mi = lab[i, rows, cols], m[i, rows, cols]
            present = [c for c in range(NCLS) if (li == c).any()]
            kept = [c for c in present if mi[li == c].all()]
            assert all(not mi[li == c].any() for c in present
                       if c not in kept)
            if patchwise and len(present) <= 1:
                assert kept == [] and mi[li == 255].all()
            else:
                assert len(kept) == min(len(present) // 2 + 1,
                                        len(present))


@pytest.mark.parametrize('prob', [0.5, 0.3])
def test_gate_and_keep_rates(prob):
    """The mix gates, the dropout keep masks and the EMA head skips open
    with their probability, within 5 sigma over 10^5 draws."""
    sigma = (N_DRAWS * prob * (1 - prob)) ** 0.5
    gen = torch.Generator().manual_seed(3)
    gates = sum(bool(_gate(gen, prob, 'cpu')) for _ in range(N_DRAWS // 10))
    assert abs(gates - N_DRAWS // 10 * prob) <= 5 * sigma / 10 ** 0.5
    for draw in (lambda: tdrop.keep_mask(gen, prob, (N_DRAWS,), 'cpu'),
                 lambda: ema.head_skip_draw(gen, N_DRAWS, prob, 'cpu')):
        assert abs(int(draw().sum()) - N_DRAWS * prob) <= 5 * sigma


def test_adaptive_draws_follow_their_laws():
    """lam_l ~ Beta(8, 2), lam_u ~ Beta(4, 4) (means within 5 sigma over
    2 x 10^4 draws), a permutation, centres in [size // 8, size)."""
    gen = torch.Generator().manual_seed(4)
    n = 20_000
    lam_l = torch.stack([mixes.beta_draw(gen, 8, 2) for _ in range(n)])
    lam_u = torch.stack([mixes.beta_draw(gen, 4, 4) for _ in range(n)])
    for lam, mean, var in ((lam_l, 0.8, 16 / 1100), (lam_u, 0.5, 16 / 576)):
        assert abs(lam.mean().item() - mean) <= 5 * (var / n) ** 0.5
        assert abs(lam.var().item() - var) <= 0.1 * var
    d = mixes.adaptive_draws(gen, 6, (64, 96))
    assert sorted(d['perm'].tolist()) == list(range(6))
    assert ((d['cx_l'] >= 12) & (d['cx_l'] < 96)).all()
    assert ((d['cy_u'] >= 8) & (d['cy_u'] < 64)).all()


# ------------------------------------------- dropout, drop path, fdrop
def _mask_for(shape, keep, index=None):
    """A seeded bool mask, by (shape, keep) or by draw index."""
    seed = zlib.crc32(repr((tuple(shape), round(float(keep), 6),
                            index)).encode())
    return np.random.RandomState(seed).rand(*tuple(shape)) < keep


class _FixedMasks:
    """Stand-ins for ``jax.random.bernoulli`` and ``keep_mask`` that hand
    both packages the masks of ``_mask_for``; ``ordered`` numbers the
    draws, else a mask depends on (shape, keep) only."""

    def __init__(self, ordered=False):
        self.ordered = ordered
        self.jax_shapes, self.port_shapes = [], []

    def bernoulli(self, key, p=0.5, shape=None):
        shape = tuple(shape or ())
        idx = len(self.jax_shapes) if self.ordered else None
        self.jax_shapes.append(shape)
        return jnp.asarray(_mask_for(shape, p, idx))

    def keep_mask(self, generator, keep, shape, device):
        idx = len(self.port_shapes) if self.ordered else None
        self.port_shapes.append(tuple(shape))
        return torch.from_numpy(_mask_for(shape, keep, idx))


def _train_cfg(backbone=(), head=(), aux_loss=None):
    cfg = copy.deepcopy(TRAIN_MODEL)
    cfg['backbone'].update(dict(backbone))
    for h in [cfg['decode_head']] + cfg['auxiliary_head']:
        h.update(dict(head))
    if aux_loss is not None:
        cfg['auxiliary_head'][0]['loss_decode'] = aux_loss
    return cfg


@pytest.fixture(scope='module')
def jax_state():
    return jax_train_model(seed=0)[1]


@pytest.mark.parametrize('drop_rate,drop_path_rate',
                         [(0.1, 0.0), (0.0, 0.2), (0.1, 0.2)])
def test_vit_layer_matches_jax_given_masks(jax_state, monkeypatch,
                                           drop_rate, drop_path_rate):
    """One unscanned JAX layer (the parameters of layer 0) and the port's
    layer draw their masks in the same order and shapes: projection
    dropout, drop path, two FFN dropouts, drop path."""
    fixed = _FixedMasks(ordered=True)
    monkeypatch.setattr(jax.random, 'bernoulli', fixed.bernoulli)
    monkeypatch.setattr(tdrop, 'keep_mask', fixed.keep_mask)
    block = jax.tree_util.tree_map(
        lambda a: np.asarray(a)[0],
        jax_state.params['backbone_m']['layers']['block'])
    x = np.random.RandomState(1).randn(2, 17, 64).astype(np.float32)
    jlayer = JLayer(embed_dims=64, num_heads=4, feedforward_channels=256,
                    drop_rate=drop_rate, drop_path_rate=drop_path_rate,
                    use_flash=False)
    want, _ = jlayer.apply({'params': block}, jnp.asarray(x), None, False,
                           rngs={'dropout': jax.random.PRNGKey(0)})
    model = torch_train_model()
    train_state_from_jax(model, jax_state)
    with torch.no_grad():
        got = model.backbone.layers[0](_t(x), None, drop_rate,
                                       drop_path_rate, torch.Generator())
    assert fixed.port_shapes == fixed.jax_shapes
    assert len(fixed.jax_shapes) == 3 * (drop_rate > 0) + \
        2 * (drop_path_rate > 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FWD_ATOL)


def _model_pair(jax_state, cfg):
    """(JAX model, its variables, the port's model) of ``cfg`` with the
    weights of ``jax_state``."""
    jcfg = copy.deepcopy(cfg)
    jcfg['backbone']['use_flash'] = False
    jmodel = j_build_segmentor(jcfg)
    variables = {'params': jax_state.params,
                 'batch_stats': jax_state.batch_stats}
    model = torch_train_model(cfg)
    train_state_from_jax(model, jax_state)
    return jmodel, variables, model


@pytest.mark.parametrize('what', ['fdrop', 'all'])
def test_vit_and_heads_match_jax_given_masks(jax_state, monkeypatch, what):
    """The scanned JAX ViT (its one traced body's masks are every layer's)
    and the SETR heads against the port given the same (shape, keep)
    masks: fdrop alone (in eval too, as JAX), or token, projection and FFN
    dropout 0.1, drop path 0.2, attention dropout 0.3, fdrop and head
    dropout 0.1 on the main and aux heads, in train mode."""
    fixed = _FixedMasks()
    monkeypatch.setattr(jax.random, 'bernoulli', fixed.bernoulli)
    monkeypatch.setattr(tdrop, 'keep_mask', fixed.keep_mask)
    rates = {} if what == 'fdrop' else dict(drop_rate=0.1,
                                            drop_path_rate=0.2,
                                            attn_drop_rate=0.3)
    cfg = _train_cfg(rates, {} if what == 'fdrop' else {'dropout_ratio': 0.1})
    jmodel, variables, model = _model_pair(jax_state, cfg)
    x = np.random.RandomState(2).randn(2, 64, 64, 3).astype(np.float32)
    train = what == 'all'
    (want, want_aux), _ = jmodel.apply(
        variables, method='forward_train_heads_from_img', img=jnp.asarray(x),
        train=train, use_fdrop=True, mutable=['batch_stats'],
        rngs={'dropout': jax.random.PRNGKey(0),
              'fdrop': jax.random.PRNGKey(1)})
    with torch.no_grad():
        got, got_aux = model.forward_train_heads_from_img(
            _t(x), train=train, use_fdrop=True, generator=torch.Generator())
    assert sorted(set(fixed.port_shapes)) == sorted(set(fixed.jax_shapes))
    assert (2, 1, 1, 64) in fixed.port_shapes
    if train:
        assert {(2, 17, 64), (2, 17, 256), (2, 1, 1), (2, 64, 64, 16),
                (2, 16, 16, 16)} <= set(fixed.port_shapes)
    for g, w in zip([got] + got_aux, [want] + list(want_aux)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=FWD_ATOL)


@pytest.mark.parametrize('package', ['jax', 'port'])
def test_attn_drop_rate_changes_no_output(jax_state, package):
    """JAX drops the attention probabilities it returns, after the output
    (vit.py:66-70): a train forward with attn_drop_rate 0.5 equals one at
    rate 0, in both packages."""
    x = np.random.RandomState(3).randn(2, 64, 64, 3).astype(np.float32)
    outs = []
    for rate in (0.0, 0.5):
        jmodel, variables, model = _model_pair(
            jax_state, _train_cfg({'attn_drop_rate': rate}))
        if package == 'jax':
            out, _ = jmodel.apply(
                variables, method='forward_decode_from_img',
                img=jnp.asarray(x), train=True, mutable=['batch_stats'],
                rngs={'dropout': jax.random.PRNGKey(0)})
            outs.append(np.asarray(out))
        else:
            with torch.no_grad():
                outs.append(model.forward_decode_from_img(
                    _t(x), train=True,
                    generator=torch.Generator().manual_seed(0)).numpy())
    np.testing.assert_array_equal(outs[0], outs[1])


def test_setr_head_with_dropout_takes_the_jax_order(jax_state):
    """dropout_ratio > 0 switches off the deferred upsample in both
    packages, in eval mode too: the port's eval logits equal JAX's within
    1e-5 and differ from the deferred order's by f32 rounding only."""
    x = np.random.RandomState(4).randn(2, 64, 64, 3).astype(np.float32)
    jmodel, variables, model = _model_pair(
        jax_state, _train_cfg(head={'dropout_ratio': 0.1}))
    want = jmodel.apply(variables, method='forward_decode_from_img',
                        img=jnp.asarray(x), train=False)
    deferred = torch_train_model()
    train_state_from_jax(deferred, jax_state)
    with torch.no_grad():
        got = model.forward_decode_from_img(_t(x)).numpy()
        other = deferred.forward_decode_from_img(_t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=FWD_ATOL)
    np.testing.assert_allclose(got, other, rtol=0, atol=FWD_ATOL)
    assert not np.array_equal(got, other)


@pytest.mark.parametrize('backbone', ['vit', 'mit'])
def test_fdrop_masks_are_channelwise_per_sample(backbone):
    """Each output map's channels are kept whole (x2) or zeroed, one draw
    per sample and channel, about half kept; the next stage of a MiT reads
    the unmasked map."""
    from s4former_tpu_torch.models import init_segmentor_weights
    cfg = TRAIN_MODEL if backbone == 'vit' else mit_model_cfg()
    model = build_segmentor(copy.deepcopy(cfg))
    init_segmentor_weights(model, torch.Generator().manual_seed(0))
    x = torch.randn(8, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        plain = model.extract_feat(x)
        drop = model.extract_feat(x, use_fdrop=True,
                                  generator=torch.Generator().manual_seed(2))
    kept_total = n_total = 0
    for p, d in zip(plain, drop):
        kept = (d != 0).flatten(1, 2)            # [B, HW, C]
        assert torch.equal(kept.all(dim=1), kept.any(dim=1))
        k = kept.all(dim=1)
        torch.testing.assert_close(d.permute(0, 3, 1, 2)[k],
                                   2 * p.permute(0, 3, 1, 2)[k], rtol=0,
                                   atol=0)
        kept_total += int(k.sum())
        n_total += k.numel()
    assert abs(kept_total - n_total / 2) <= 5 * (n_total / 4) ** 0.5


def test_mit_fdrop_matches_jax(monkeypatch):
    """The JAX MiT's fdrop (mit.py:218-224) against the port's, given the
    same [B, 1, 1, C] masks per stage."""
    fixed = _FixedMasks()
    monkeypatch.setattr(jax.random, 'bernoulli', fixed.bernoulli)
    monkeypatch.setattr(tdrop, 'keep_mask', fixed.keep_mask)
    cfg = mit_model_cfg()
    jmodel = j_build_segmentor(copy.deepcopy(cfg))
    v = jax.jit(lambda key: init_segmentor_variables(
        jmodel, key, (1, 64, 64, 3)))(jax.random.PRNGKey(0))
    variables = perturbed({'params': v['params'],
                           'batch_stats': v['batch_stats']}, 0)
    model = build_segmentor(cfg)
    model.load_state_dict(state_dict_from_jax_variables(variables))
    x = np.random.RandomState(5).randn(2, 64, 64, 3).astype(np.float32)
    want = jmodel.apply(variables, method='extract_feat', img=jnp.asarray(x),
                        use_fdrop=True, rngs={'fdrop': jax.random.PRNGKey(0)})
    with torch.no_grad():
        got = model.extract_feat(_t(x), use_fdrop=True,
                                 generator=torch.Generator())
    assert fixed.port_shapes == fixed.jax_shapes == [
        (2, 1, 1, c) for c in (8, 16, 40, 64)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=FWD_ATOL)


# --------------------------------------------------- deterministic modules
@pytest.mark.parametrize('case', ['indices', 'ignore_avg_non_ignore',
                                  'same_shape_target', 'weighted'])
def test_binary_cross_entropy_matches_jax(case):
    rs = np.random.RandomState(7)
    logits = (rs.randn(2, 16, 16, NCLS) * 3).astype(np.float32)
    label = rs.randint(0, NCLS, (2, 16, 16)).astype(np.int32)
    kw = dict(use_sigmoid=True)
    if case == 'ignore_avg_non_ignore':
        label[:, :5] = 255
        kw['avg_non_ignore'] = True
    if case == 'same_shape_target':
        label = (rs.rand(2, 16, 16, NCLS) > 0.6).astype(np.float32)
    if case == 'weighted':
        label[0, 3] = 255
        kw['loss_weight'] = 0.4
    want = jce.CrossEntropyLoss(**kw)(jnp.asarray(logits),
                                      jnp.asarray(label))
    got = ce.CrossEntropyLoss(**kw)(_t(logits), _t(label))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize('reduction', ['none', 'sum'])
def test_cross_entropy_accepts_any_reduction_and_takes_the_mean(reduction):
    """As JAX, which stores ``reduction`` and ignores it."""
    rs = np.random.RandomState(8)
    logits = rs.randn(2, 8, 8, NCLS).astype(np.float32)
    label = rs.randint(0, NCLS, (2, 8, 8)).astype(np.int32)
    for sigmoid in (False, True):
        want = jce.CrossEntropyLoss(use_sigmoid=sigmoid, reduction=reduction)(
            jnp.asarray(logits), jnp.asarray(label))
        got = ce.CrossEntropyLoss(use_sigmoid=sigmoid, reduction=reduction)(
            _t(logits), _t(label))
        mean = ce.CrossEntropyLoss(use_sigmoid=sigmoid)(_t(logits),
                                                        _t(label))
        assert float(got) == float(mean)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    with pytest.raises(NotImplementedError, match='mask'):
        ce.CrossEntropyLoss(use_mask=True)


def _jax_mults_by_port_name(params, mults):
    """A JAX multiplier tree broadcast to its leaves' shapes, through the
    weight bridge: port name -> the multiplier (one value a tensor)."""
    full = jax.tree_util.tree_map(
        lambda p, m: np.broadcast_to(np.asarray(m, np.float32),
                                     tuple(p.shape)).copy(), params, mults)
    out = {}
    for name, t in state_dict_from_jax_variables({'params': full}).items():
        values = torch.unique(t.float())
        assert values.numel() == 1, name
        out[name] = float(values)
    return out


@pytest.mark.parametrize('model_kind,num_layers',
                         [('vit', 2), ('vit', 12), ('mit', 4)])
def test_layer_decay_matches_jax_through_the_bridge(model_kind, num_layers):
    """Every parameter's lr and weight-decay multiplier equal JAX's
    ``build_layer_decay_trees`` through the bridge: the ViT's blocks decay
    when the backbone has ``num_layers`` of them (JAX matches its stacked
    axis; 12 of a 2-layer ViT gives them 1), the embeddings take
    decay**(num_layers + 1), the MiT's patch embeddings too."""
    if model_kind == 'vit':
        cfg = TRAIN_MODEL
        jcfg = copy.deepcopy(cfg)
        jcfg['backbone']['use_flash'] = False
    else:
        cfg = jcfg = mit_model_cfg()
    jmodel = j_build_segmentor(copy.deepcopy(jcfg))
    params = jax.eval_shape(lambda key: init_segmentor_variables(
        jmodel, key, (1, 64, 64, 3)), jax.random.PRNGKey(0))['params']
    j_lr, j_wd = j_build_layer_decay_trees(params, num_layers, 0.65)
    model = build_segmentor(copy.deepcopy(cfg))
    named = dict(model.named_parameters())
    lr, wd = build_layer_decay_trees(named, {n: p.dim()
                                             for n, p in named.items()},
                                     num_layers, 0.65, mit=model_kind == 'mit')
    want_lr = _jax_mults_by_port_name(params, j_lr)
    want_wd = _jax_mults_by_port_name(params, j_wd)
    assert sorted(want_lr) == sorted(lr) == sorted(named)
    for name in named:
        assert lr[name] == pytest.approx(want_lr[name], rel=1e-6), name
        assert wd[name] == want_wd[name], name
    decayed = {v for n, v in lr.items() if n.startswith('backbone.')}
    assert len(decayed) == (num_layers + 1 if num_layers == 2 else 2)
    with pytest.raises(NotImplementedError, match='stage_wise'):
        build_layer_decay_trees(named, {}, 2, 0.65, 'stage_wise')


@pytest.mark.parametrize('pattern', ['head_params', 'every_other'])
def test_ema_head_dropout_matches_jax_given_skips(jax_state, monkeypatch,
                                                  pattern):
    """JAX ema_update_scoped with momentum_head_dropout, its per-leaf skips
    fixed by rule, against the port given the same skips by name: the
    head's skipped parameters keep the teacher's value, everything else
    (head buffers, backbone, aux heads) lerps."""
    head = jax_state.params['decode_head_m']
    paths = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_flatten_with_path(head)[0]]

    def rule(i, name):
        if pattern == 'head_params':
            return 'conv_seg' in name or 'norm' in name
        return i % 2 == 0
    skips = [rule(i, p) for i, p in enumerate(paths)]
    calls = []

    def bernoulli(key, p=0.5, shape=None):
        calls.append(p)
        return jnp.asarray(skips[len(calls) - 1])
    monkeypatch.setattr(jax.random, 'bernoulli', bernoulli)
    m = 0.9
    new_p = jema.ema_update_scoped(jax_state.ema_params, jax_state.params,
                                   m, m, m, dropout_head=0.5,
                                   key=jax.random.PRNGKey(0))
    new_bs = jema.ema_update_scoped(jax_state.ema_batch_stats,
                                    jax_state.batch_stats, m, m, m)
    assert calls == [0.5] * len(paths)
    model = torch_train_model()
    state = train_state_from_jax(model, jax_state)
    # each head leaf's index in flax's order, by port name, through the
    # bridge
    index = jax.tree_util.tree_map(lambda _: -1.0, jax_state.params)
    index['decode_head_m'] = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(head), [float(i)
                                             for i in range(len(paths))])
    order = {n: int(i) for n, i in _jax_mults_by_port_name(
        jax_state.params, index).items() if i >= 0}
    by_name = {n: skips[i] for n, i in order.items()}
    teacher = state.ema_model.state_dict()
    before = {k: v.clone() for k, v in teacher.items()}
    ema.ema_update_scoped(teacher, model.state_dict(), m, m, m,
                          {n: torch.tensor(s) for n, s in by_name.items()})
    want = state_dict_from_jax_variables({'params': new_p,
                                          'batch_stats': new_bs})
    for name, w in want.items():
        np.testing.assert_allclose(teacher[name].numpy(), w.numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)
        if by_name.get(name):
            assert torch.equal(teacher[name], before[name]), name
        elif teacher[name].is_floating_point():
            assert not torch.equal(teacher[name], before[name]), name
    assert any(by_name.values()) and not all(by_name.values())


def test_ema_head_skip_leaves_buffers_aux_and_backbone(jax_state):
    """With every head parameter skipped, only they keep their teacher
    values."""
    model = torch_train_model()
    state = train_state_from_jax(model, jax_state)
    teacher = state.ema_model.state_dict()
    before = {k: v.clone() for k, v in teacher.items()}
    heads = {'decode_head.' + n: torch.tensor(True)
             for n, _ in model.decode_head.named_parameters()}
    ema.ema_update_scoped(teacher, model.state_dict(), 0.9, 0.9, 0.9, heads)
    for name, t in teacher.items():
        if not t.is_floating_point():
            continue
        assert torch.equal(t, before[name]) == (name in heads), name
    assert any('running_var' in n and n.startswith('decode_head.')
               for n in teacher)

