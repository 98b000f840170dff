"""The port's training modules held to their JAX functions on the CPU, in
f32, on the same numpy inputs: CE and accuracy, the pseudo-label losses,
the PASA bias, CutMix and PatchShuffle with given masks and permutations
(and the random draws by shape, range and rate), the PatchShuffle undo,
NCR in every mode, the scoped EMA, poly LR / lr multipliers / SGD, and the
SETR-PUP head and the whole model in train mode with BN running statistics.
Tolerance 1e-5 unless a test states another (f32 sums in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s4former_tpu.core import optim as joptim
from s4former_tpu.models.decode_heads import base as jbase
from s4former_tpu.models.losses import cross_entropy as jce
from s4former_tpu.semi import ema as jema
from s4former_tpu.semi import mixes as jmixes
from s4former_tpu.semi import ncr as jncr
from s4former_tpu.semi import pasa as jpasa
from s4former_tpu.semi import pseudo as jpseudo
from s4former_tpu_torch.core import optim
from s4former_tpu_torch.core.checkpoint import state_dict_from_jax_variables
from s4former_tpu_torch.models.decode_heads import base
from s4former_tpu_torch.models.losses import cross_entropy as ce
from s4former_tpu_torch.semi import ema, mixes, ncr, pasa, pseudo
from tests._torch_port import jax_train_model, perturbed, torch_train_model

TOL = 1e-5
NCLS = 5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol)


@pytest.fixture(scope='module')
def seg():
    """logits [2, 16, 12, 5] and labels with some 255 (ignore) pixels."""
    rs = np.random.RandomState(0)
    logits = rs.normal(0, 2.0, (2, 16, 12, NCLS)).astype(np.float32)
    label = rs.randint(0, NCLS, (2, 16, 12)).astype(np.int32)
    label[rs.rand(2, 16, 12) < 0.2] = 255
    return logits, label


@pytest.mark.parametrize('avg_non_ignore', [False, True])
def test_cross_entropy_and_accuracy(seg, avg_non_ignore):
    logits, label = seg
    kw = dict(avg_non_ignore=avg_non_ignore, loss_weight=0.4)
    want = jce.CrossEntropyLoss(**kw)(jnp.asarray(logits), jnp.asarray(label))
    got = ce.CrossEntropyLoss(**kw)(_t(logits), _t(label))
    _close(got, want)
    cw = [0.5, 1.0, 2.0, 1.0, 0.1]
    _close(ce.cross_entropy_loss(_t(logits), _t(label), class_weight=cw),
           jce.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(label),
                                  class_weight=cw))
    _close(ce.accuracy(_t(logits), _t(label)),
           jce.accuracy(jnp.asarray(logits), jnp.asarray(label)))
    # bf16 logits are upcast inside the loss
    lb = torch.from_numpy(logits).to(torch.bfloat16)
    _close(ce.CrossEntropyLoss(**kw)(lb, _t(label)),
           ce.CrossEntropyLoss(**kw)(lb.float(), _t(label)), 0)


@pytest.mark.parametrize('soft', [False, True])
def test_pseudo_labels_and_losses(seg, soft):
    logits, _ = seg
    rs = np.random.RandomState(1)
    student = rs.normal(0, 1.0, (2, 8, 6, NCLS)).astype(np.float32)
    kw = dict(unsup_confidence=0.5, unsup_temperature=2.0 if soft else 1.0,
              unsup_soft=soft)
    ti_j = jpseudo.extract_teacher_info(jnp.abs(jnp.asarray(logits)), **kw)
    ti = pseudo.extract_teacher_info(_t(np.abs(logits)), **kw)
    for name in ('hard_label', 'conf_mask'):
        np.testing.assert_array_equal(getattr(ti, name).numpy(),
                                      np.asarray(getattr(ti_j, name)))
    _close(ti.max_prob, ti_j.max_prob)
    assert 0.1 < float(pseudo.mask_ratio(ti.conf_mask)) < 0.9
    _close(pseudo.mask_ratio(ti.conf_mask), jpseudo.mask_ratio(ti_j.conf_mask))
    # the student logits at half resolution are resized to the labels'
    _close(pseudo.pseudo_ce_loss(_t(student), ti.hard_label),
           jpseudo.pseudo_ce_loss(jnp.asarray(student), ti_j.hard_label))
    if soft:
        _close(ti.soft_label, ti_j.soft_label)
        full = rs.normal(0, 1.0, (2, 16, 12, NCLS)).astype(np.float32)
        _close(pseudo.soft_pseudo_ce_loss(_t(full), ti.soft_label,
                                          ti.conf_mask),
               jpseudo.soft_pseudo_ce_loss(jnp.asarray(full), ti_j.soft_label,
                                           ti_j.conf_mask))


def test_pasa_bias_from_conf_mask():
    conf = (np.random.RandomState(2).rand(2, 64, 48) > 0.4).astype(np.int32)
    want = jpasa.pasa_bias_from_conf_mask(jnp.asarray(conf), 16, 5.0, True)
    got = pasa.pasa_bias_from_conf_mask(_t(conf), 16, 5.0, True)
    assert got.shape == (2, 1, 13, 13)
    _close(got, want)


def test_cutmix_and_patch_perm_with_given_randomness():
    rs = np.random.RandomState(3)
    imgs = rs.normal(size=(3, 64, 64, 3)).astype(np.float32)
    labels = rs.randint(0, NCLS, (3, 64, 64)).astype(np.int32)
    masks = np.ones((3, 64, 64), np.float32)
    masks[0, 5:40, 10:30] = 0
    masks[2, 30:, :50] = 0
    i_j, l_j = jmixes.cutmix_with_masks(jnp.asarray(masks),
                                        jnp.asarray(imgs), jnp.asarray(labels))
    i_t, l_t = mixes.cutmix_with_masks(_t(masks), _t(imgs), _t(labels))
    _close(i_t, i_j, 0)
    np.testing.assert_array_equal(l_t.numpy(), np.asarray(l_j))
    perms = np.stack([rs.permutation(4) for _ in range(3)]).astype(np.int32)
    _close(mixes.apply_patch_perm(_t(imgs), _t(perms), 2),
           jmixes.apply_patch_perm(jnp.asarray(imgs), jnp.asarray(perms), 2),
           0)


def test_random_mixes_shape_range_and_rate():
    """torch.Generator cannot give jax.random's numbers: the draws are
    checked by shape, range and rate."""
    g = torch.Generator().manual_seed(0)
    m = mixes.random_box_mask(g, 400, (64, 48), ratio=2.0)
    assert m.shape == (400, 64, 48) and set(m.unique().tolist()) == {0., 1.}
    zeros = (m == 0).sum(dim=(1, 2)).float()
    # one box of area H*W/2, its height rounded and clamped into the image
    assert ((zeros - 64 * 48 / 2).abs() <= 64).all()
    imgs = torch.randn(400, 64, 64, 3, generator=g)
    out, perm = mixes.patch_shuffle(g, imgs, 2, 16, patchmix_ratio=0.5)
    assert perm.shape == (400, 4) and perm.dtype == torch.int32
    assert (perm.sort(dim=1).values == torch.arange(4)).all()
    shuffled = (perm != torch.arange(4)).any(dim=1).float().mean()
    # gate rate 0.5, less the 1/24 of drawn permutations that are identity
    assert abs(float(shuffled) - 0.5 * 23 / 24) < 0.08
    _close(out, mixes.apply_patch_perm(imgs, perm, 2), 0)


def test_unshuffle_tokens_and_feature_map():
    rs = np.random.RandomState(4)
    tokens = rs.normal(size=(2, 64, 5)).astype(np.float32)  # 8 x 8 grid
    perm = np.stack([rs.permutation(16), np.arange(16)]).astype(np.int32)
    np.testing.assert_array_equal(
        base.invert_permutation(_t(perm)).numpy(),
        np.asarray(jbase.invert_permutation(jnp.asarray(perm))))
    _close(base.unshuffle_tokens(_t(tokens), _t(perm), 2),
           jbase.unshuffle_tokens(jnp.asarray(tokens), jnp.asarray(perm), 2),
           0)
    fmap = tokens.reshape(2, 8, 8, 5)
    _close(base.unshuffle_feature_map(_t(fmap), _t(perm), 2),
           jbase.unshuffle_feature_map(jnp.asarray(fmap), jnp.asarray(perm),
                                       2), 0)
    # the undo inverts the image-side shuffle on the patch grid
    img = rs.normal(size=(2, 128, 128, 1)).astype(np.float32)
    shuffled = mixes.apply_patch_perm(_t(img), _t(perm), 2, patch_size=16)
    grid = shuffled.reshape(2, 8, 16, 8, 16, 1)[:, :, 0, :, 0]
    orig = _t(img).reshape(2, 8, 16, 8, 16, 1)[:, :, 0, :, 0]
    _close(base.unshuffle_feature_map(grid, _t(perm), 2), orig, 0)


@pytest.mark.parametrize('mode', ncr.MODES)
def test_ncr_loss_modes(seg, mode):
    logits, label = seg
    teacher = np.random.RandomState(5).normal(0, 2.0, logits.shape).astype(
        np.float32)
    want = jncr.ncr_loss(jnp.asarray(logits), jnp.asarray(teacher),
                         jnp.asarray(label), NCLS, mode)
    got = ncr.ncr_loss(_t(logits), _t(teacher), _t(label), NCLS, mode)
    assert float(got) > 0
    _close(got, want)


@pytest.fixture(scope='module')
def variables():
    """Perturbed {'params', 'batch_stats'} of the training tests' model."""
    _, state = jax_train_model(seed=3, ema=False)
    return {'params': state.params, 'batch_stats': state.batch_stats}


@pytest.mark.parametrize('annealed', [False, True])
def test_ema_update_scoped(variables, annealed):
    """Backbone, decode head and aux heads each with their own momentum,
    over the parameters and the BN statistics, through the bridge."""
    student = perturbed(variables, 7)
    m_head = 0.5 if annealed else 0.9
    want = {
        'params': jema.ema_update_scoped(variables['params'],
                                         student['params'], 0.99, m_head, 0.7),
        'batch_stats': jema.ema_update_scoped(
            variables['batch_stats'], student['batch_stats'], 0.99, m_head,
            0.7, is_params=False)}
    teacher = state_dict_from_jax_variables(variables)
    momentum = torch.tensor(m_head) if annealed else m_head
    ema.ema_update_scoped(teacher, state_dict_from_jax_variables(student),
                          0.99, momentum, 0.7)
    ref = state_dict_from_jax_variables(want)
    assert sorted(teacher) == sorted(ref)
    assert any(k.startswith('auxiliary_head.') and 'running_var' in k
               for k in ref)
    for k, v in ref.items():
        _close(teacher[k], v, 1e-6)


def test_lr_multipliers_leaf_by_leaf(variables):
    """build_lr_mult_tree: the JAX multiplier of every flax leaf, carried
    through the bridge, is the port's multiplier of that parameter: x10 on
    decode_head. and auxiliary_head., x1 on the whole backbone."""
    mults = joptim.build_lr_mult_tree(variables['params'], {'head': 10.0})
    as_leaves = jax.tree_util.tree_map(
        lambda m, p: np.full(np.shape(p), m, np.float32), mults,
        variables['params'])
    ref = state_dict_from_jax_variables({'params': as_leaves})
    model = torch_train_model()
    ours = optim.build_lr_mult_tree(dict(model.named_parameters()),
                                    {'head': 10.0})
    assert sorted(ours) == sorted(ref)
    for name, leaf in ref.items():
        assert np.all(leaf.numpy() == ours[name]), name
        assert ours[name] == (10.0 if name.startswith(
            ('decode_head.', 'auxiliary_head.')) else 1.0), name


def test_poly_lr_and_sgd_update(variables):
    for step in (0, 1, 37, 100, 150):
        _close(optim.poly_lr(torch.tensor(step), 0.01, 100, 0.9, 1e-4),
               joptim.poly_lr(jnp.asarray(step), 0.01, 100, 0.9, 1e-4))
    params_j = variables['params']
    grads_j = perturbed(params_j, 11, std=1.0)
    buf_j = perturbed(params_j, 12, std=0.5)
    lr = 0.003
    mults = joptim.build_lr_mult_tree(params_j, {'head': 10.0})
    new_p, new_b = joptim.sgd_update(params_j, grads_j, buf_j,
                                     jnp.asarray(lr), mults, 0.9, 1e-4)
    params = state_dict_from_jax_variables({'params': params_j})
    grads = state_dict_from_jax_variables({'params': grads_j})
    bufs = state_dict_from_jax_variables({'params': buf_j})
    optim.sgd_update(params, grads, bufs, torch.tensor(lr),
                     optim.build_lr_mult_tree(params, {'head': 10.0}), 0.9,
                     1e-4)
    for got, want in ((params, new_p), (bufs, new_b)):
        ref = state_dict_from_jax_variables({'params': want})
        for k, v in ref.items():
            _close(got[k], v, 1e-6)
    norm = optim.global_grad_norm(grads)
    _close(norm, joptim.global_grad_norm(grads_j))
    clipped = optim.clip_grads_by_norm(grads, 0.5 * float(norm))
    ref = state_dict_from_jax_variables(
        {'params': joptim.clip_grads_by_norm(grads_j, 0.5 * float(norm))})
    for k, v in ref.items():
        _close(clipped[k], v)


@pytest.fixture(scope='module')
def train_pair():
    jmodel, state = jax_train_model(seed=5, ema=False)
    jv = {'params': state.params, 'batch_stats': state.batch_stats}
    model = torch_train_model()
    model.load_state_dict(state_dict_from_jax_variables(jv))
    return jmodel, jv, model


def test_setr_up_head_train_mode_and_running_stats(train_pair):
    """Batch statistics (biased variance) normalise the maps; the running
    statistics move as flax's: 0.9 old + 0.1 batch. With a PatchShuffle
    permutation the head undoes it on the tokens first."""
    jmodel, jv, model = train_pair
    rs = np.random.RandomState(6)
    feats = [rs.normal(size=(2, 4, 4, 64)).astype(np.float32)
             for _ in range(2)]
    perm = np.stack([[2, 0, 3, 1], [0, 1, 2, 3]]).astype(np.int32)
    want, upd = jmodel.apply(
        jv, [jnp.asarray(f) for f in feats], train=True,
        patchmix_perm=jnp.asarray(perm), patchmix_n=2,
        method='decode_logits', mutable=['batch_stats'])
    got = model.decode_logits([_t(f) for f in feats], train=True,
                              patchmix_perm=_t(perm), patchmix_n=2)
    assert got.shape == (2, 64, 64, NCLS)
    _close(got.detach(), want, 1e-4)
    ref = state_dict_from_jax_variables({'params': jv['params'],
                                         'batch_stats': upd['batch_stats']})
    ours = model.state_dict()
    names = [k for k in ref if k.startswith('decode_head.') and 'running' in k]
    assert len(names) == 4
    for k in names:
        _close(ours[k], ref[k])
        assert not np.allclose(ref[k].numpy(), state_dict_from_jax_variables(
            jv)[k].numpy())


def test_model_train_heads_with_bias(train_pair):
    """forward_train_heads_from_img in train mode with a PASA-shaped bias:
    main and aux logits, and every BN's running statistics."""
    jmodel, jv, _ = train_pair
    model = torch_train_model()
    model.load_state_dict(state_dict_from_jax_variables(jv))
    rs = np.random.RandomState(8)
    x = rs.normal(size=(2, 64, 64, 3)).astype(np.float32)
    bias = rs.normal(size=(2, 1, 17, 17)).astype(np.float32)
    (main_j, aux_j), upd = jmodel.apply(
        jv, img=jnp.asarray(x), train=True, attn_bias=jnp.asarray(bias),
        method='forward_train_heads_from_img', mutable=['batch_stats'])
    main, aux = model.forward_train_heads_from_img(
        _t(x), train=True, attn_bias=_t(bias))
    _close(main.detach(), main_j, 1e-4)
    for a, a_j in zip(aux, aux_j):
        _close(a.detach(), a_j, 1e-4)
    ref = state_dict_from_jax_variables({'params': jv['params'],
                                         'batch_stats': upd['batch_stats']})
    ours = model.state_dict()
    for k, v in ref.items():
        _close(ours[k], v, 1e-4)
