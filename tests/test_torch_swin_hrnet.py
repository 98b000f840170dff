"""The Swin, HRNet and ResNeXt/ResNeSt slice held to the JAX package on the
CPU, in f32, module by module: ResNeXt and ResNeSt at depth 50 (narrowed),
Swin (embed 24, depths (2, 2, 2, 2)), HRNet with one block a branch, the
FCN head under ``resize_concat``, the UPer and OCR heads; then tiny
UPerNet-Swin and OCRNet-HRNet segmentors (``configs/_base_/models/``
``upernet_swin.py`` and ``ocrnet_hr18.py`` narrowed): the forward, and the
port's state dict back through JAX ``convert_mmseg_checkpoint`` to the
same variables, and teacher-PASA inference through the cascade's
stages. Each from JAX weights made from the shapes
(``tests/_torch_port.py:shaped_variables``) through the weight bridge, on
seeded numpy inputs; in eval mode and, where the module trains, in train
mode (BN on the batch's statistics and the running statistics both
packages then update; Swin's drop path given the same masks).

Swin at 64² has token grids 16, 8, 4 and 2: at window 7 every stage pads,
stage 0 and 1 shift (stage 0 pads its shifted grid from 16 to 21), and
stages 2 and 3 run at the grid as their window (shrunk) and unshifted; at
window 2 no window shrinks, every stage but the last shifts, nothing pads.

Tolerance: max |port - JAX| <= 1e-4 * max(1, max |JAX|) (``_close``).
"""
import copy

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
from s4former_tpu.models.backbones import hrnet as j_hrnet
from s4former_tpu.models.backbones import swin as j_swin
from s4former_tpu.models.decode_heads import misc_heads as j_misc
from s4former_tpu_torch import apis
from s4former_tpu_torch.config import Config
from s4former_tpu_torch.core.checkpoint import state_dict_from_jax_variables
from s4former_tpu_torch.models import build_segmentor
from s4former_tpu_torch.models.backbones import swin
from s4former_tpu_torch.models.backbones.cnn_zoo import ResNeSt, ResNeXt
from s4former_tpu_torch.models.backbones.hrnet import HRNet
from s4former_tpu_torch.models.decode_heads.misc_heads import (FCNHead,
                                                               OCRHead,
                                                               UPerHead)
from s4former_tpu_torch.ops import flash_attention as fa
from tests._torch_port import (assert_argmax_agrees, hrnet_extra,
                               ocrnet_model, perturbed, shaped_variables,
                               upernet_swin_model)
from tests.test_torch_cnn import (_bridge, _close,  # noqa: F401
                                  _module_case, _t, fixed_masks)

B = 2


def _x(seed, h=64, w=64, c=3):
    return np.random.RandomState(seed).randn(B, h, w, c).astype(np.float32)


# --------------------------------------------------- ResNeXt, ResNeSt
CNN_CASES = {
    # 32x4d's shape narrowed: groups 4, width int(8 * 16 / 64) * 4 = 8
    'resnext': (j_cnn_zoo.ResNeXt, ResNeXt, dict(
        depth=50, stem_channels=16, base_channels=8, groups=4,
        base_width=16)),
    # the -D8 strides and dilations (avd pool at layer2 only), radix 2
    'resnest_d8': (j_cnn_zoo.ResNeSt, ResNeSt, dict(
        depth=50, stem_channels=16, base_channels=8, strides=(1, 2, 1, 1),
        dilations=(1, 1, 2, 4), contract_dilation=True)),
    # every stage strided; radix 1 (the sigmoid gate), grouped fc's
    'resnest_r1_g2': (j_cnn_zoo.ResNeSt, ResNeSt, dict(
        depth=50, stem_channels=16, base_channels=8, radix=1, groups=2,
        base_width=64)),
}


@pytest.mark.parametrize('case', sorted(CNN_CASES))
def test_resnext_resnest_match_jax(case):
    """Eval mode at depth 50 (train-mode f32 through 16 blocks is
    ill-conditioned with seeded weights: ``test_torch_cnn.py``); odd sizes,
    so V1d's ceil-mode shortcut pool has partial windows. The keys are the
    reference's: ResNeXt ResNet's, ResNeSt the split attention's."""
    jcls, pcls, kw = CNN_CASES[case]
    port = pcls(**kw)
    gots, _ = _module_case(jcls(**kw), port, (_x(1, 66, 62),), 'backbone_m',
                           False)
    assert len(gots) == 4 and gots[3].shape[-1] == 8 * 8 * 4
    keys = set(port.state_dict())
    if case == 'resnext':
        assert 'layer1.0.conv2.weight' in keys and 'conv1.weight' in keys
        assert port.layer1[0].conv2.groups == 4
    else:
        assert {'stem.6.weight', 'layer2.0.conv2.fc1.bias',
                'layer2.0.conv2.bn0.running_var',
                'layer2.0.downsample.1.weight'} <= keys
        assert not any('bn2' in k for k in keys)


# ---------------------------------------------------------------- Swin
SWIN_KW = dict(embed_dims=24, depths=(2, 2, 2, 2), num_heads=(1, 2, 3, 6))


@pytest.mark.parametrize('window,train', [(7, False), (7, True),
                                          (2, False)])
def test_swin_matches_jax(window, train, fixed_masks):
    """At window 7 the shrunk, padded and unshifted paths; at 2 the shift
    on every stage but the last, without padding. In train mode the drop
    path (rate 0.2, rising over the blocks) given the same masks (Swin
    has no BN: train mode changes nothing else)."""
    kw = dict(SWIN_KW, window_size=window,
              drop_path_rate=0.2 if train else 0.0)
    jmod, port = j_swin.SwinTransformer(**kw), swin.SwinTransformer(**kw)
    x = _x(2)
    v = shaped_variables(lambda: jmod.init(jax.random.PRNGKey(0),
                                           jnp.asarray(x)))
    port.load_state_dict(_bridge(v, 'backbone_m'))
    want = jax.jit(lambda v, x: jmod.apply(
        v, x, train=train, rngs={'dropout': jax.random.PRNGKey(3)}))(
            jax.tree_util.tree_map(jnp.asarray, v), jnp.asarray(x))
    with torch.no_grad():
        gots = port(_t(x), train=train,
                    generator=torch.Generator().manual_seed(0))
    for g, w in zip(gots, want, strict=True):
        _close(g, w)
    assert [g.shape[1:] for g in gots] == [(16, 16, 24), (8, 8, 48),
                                           (4, 4, 96), (2, 2, 192)]
    # two drop paths a block but the first (rate 0), one mask shape
    n_masks = 14 if train else 0
    assert fixed_masks['port'] == fixed_masks['jax'] == [(B, 1, 1)] * n_masks
    keys = set(port.state_dict())
    assert 'stages.0.downsample.reduction.weight' in keys and \
        'stages.3.downsample.reduction.weight' not in keys
    assert port.stages[3].blocks[0].attn['w_msa'] \
        .relative_position_bias_table.shape == ((2 * window - 1) ** 2, 6)


def test_swin_gradient_on_zero_tokens_matches_jax():
    """The backward against JAX's, on an image whose bottom half is zero
    and weights whose biases are zero (as both packages' seeded init):
    those patches are exact zero tokens, whose LayerNorms have no
    variance, and both packages' gradients blow up alike (to ~1e22 at
    the patch embedding: the reason ``chip_smoke.py`` trains Swin on
    unpadded crops). Every parameter's gradient within 1e-4 of its
    largest magnitude."""
    kw = dict(embed_dims=24, depths=(2, 2), num_heads=(1, 2),
              window_size=7, out_indices=(0, 1))
    x = _x(11, 128, 128)
    x[:, 64:] = 0
    jmod, port = j_swin.SwinTransformer(**kw), swin.SwinTransformer(**kw)
    v = shaped_variables(lambda: jmod.init(jax.random.PRNGKey(0),
                                           jnp.asarray(x)))
    v = jax.tree_util.tree_map_with_path(
        lambda p, a: np.zeros_like(a) if p[-1].key == 'bias' else a, v)
    port.load_state_dict(_bridge(v, 'backbone_m'))
    cot = _maps(12, [(B, 32, 32, 24), (B, 16, 16, 48)])

    def loss(params):
        outs = jmod.apply({'params': params}, jnp.asarray(x))
        return sum((o * jnp.asarray(c)).sum() for o, c in zip(outs, cot))
    grads = jax.jit(jax.grad(loss))(
        jax.tree_util.tree_map(jnp.asarray, v['params']))
    sum((o * _t(c)).sum() for o, c in zip(port(_t(x)), cot)).backward()
    want = _bridge({'params': jax.tree_util.tree_map(np.asarray, grads)},
                   'backbone_m')
    got = {n: p.grad for n, p in port.named_parameters()}
    assert sorted(got) == sorted(want)
    assert float(want['patch_embed.projection.bias'].abs().max()) > 1e20
    for name, w in want.items():
        _close(got[name], w.numpy(), name)


def test_swin_window_pieces_match_jax():
    """The window partition, its inverse and the relative-position index
    equal JAX's; the central index of a table reads the offsets of a
    smaller window."""
    x = _x(4, 14, 21, 5)
    _close(swin.window_partition(_t(x), 7), j_swin.window_partition(
        jnp.asarray(x), 7))
    parts = j_swin.window_partition(jnp.asarray(x), 7)
    _close(swin.window_reverse(_t(np.asarray(parts)), 7, 14, 21), x)
    for ws in (2, 4, 7):
        np.testing.assert_array_equal(
            swin.relative_position_index(ws).numpy(),
            np.asarray(j_swin._relative_position_index(ws)))
    big, small = swin.relative_position_index(3, 7), \
        swin.relative_position_index(3)
    offsets = np.stack(np.divmod(small.numpy(), 5)) - 2     # (dy, dx)
    np.testing.assert_array_equal(big.numpy(),
                                  (offsets[0] + 6) * 13 + offsets[1] + 6)


# --------------------------------------------------------------- HRNet
@pytest.mark.parametrize('multiscale,train', [(True, False), (True, True),
                                              (False, False)])
def test_hrnet_matches_jax(multiscale, train):
    """One block a branch, two modules in stage 3 (branch widths 4, 8, 16,
    32): the transitions (a new branch from the last, 3 from 2 and 4 from
    3), the fusion both ways, ``multiscale_output``."""
    kw = dict(extra=hrnet_extra(), multiscale_output=multiscale)
    port = HRNet(**kw)
    gots, _ = _module_case(j_hrnet.HRNet(**kw), port, (_x(5),),
                           'backbone_m', train)
    want = [(16, 16, 4), (8, 8, 8), (4, 4, 16), (2, 2, 32)]
    assert [g.shape[1:] for g in gots] == (want if multiscale else want[:1])
    keys = set(port.state_dict())
    assert {'transition1.1.0.0.weight', 'transition3.3.0.1.running_var',
            'stage3.1.fuse_layers.2.0.1.0.weight',
            'stage3.1.fuse_layers.0.2.1.running_mean',
            'stage4.0.branches.3.0.conv2.weight',
            'layer1.0.downsample.0.weight'} <= keys
    assert port.transition2[0] is None and port.transition2[1] is None


# ----------------------------------------------------------------- heads
MAPS = [(B, 16, 16, 4), (B, 8, 8, 8), (B, 4, 4, 16), (B, 2, 2, 32)]


def _maps(seed, shapes=MAPS):
    rs = np.random.RandomState(seed)
    return [rs.randn(*s).astype(np.float32) for s in shapes]


def _perm(seed=0, g=8):
    rs = np.random.RandomState(seed)
    return np.stack([rs.permutation(g * g) for _ in range(B)]
                    ).astype(np.int32)


@pytest.mark.parametrize('perm,train', [(False, False), (True, True)])
def test_fcn_resize_concat_matches_jax(perm, train):
    """OCRNet's first stage: the four levels resized to the first and
    concatenated (``in_channels`` their widths' list), a 1x1 conv, no
    dropout; the PatchShuffle undone on the concatenated 1/4 map."""
    kw = dict(in_channels=[4, 8, 16, 32], in_index=(0, 1, 2, 3),
              input_transform='resize_concat', channels=12, num_convs=1,
              kernel_size=1, concat_input=False, dropout_ratio=-1,
              num_classes=5)
    extra = {'patchmix_perm': _perm(), 'patchmix_n': 2} if perm else {}
    _module_case(j_misc.FCNHead(**kw), FCNHead(**kw), (_maps(6),),
                 'decode_head_m', train,
                 j_kw={k: jnp.asarray(v) if k == 'patchmix_perm' else v
                       for k, v in extra.items()},
                 p_kw={k: torch.from_numpy(v) if k == 'patchmix_perm'
                       else v for k, v in extra.items()})


@pytest.mark.parametrize('train', [False, True])
def test_uper_head_matches_jax_and_never_undoes_a_shuffle(train):
    """PSP on the deepest level, laterals, top-down sums, fpn convs and
    the bottleneck; a PatchShuffle permutation changes nothing (JAX
    l.199-200)."""
    kw = dict(in_channels=[4, 8, 16, 32], channels=12, num_classes=5,
              dropout_ratio=0.0)
    port = UPerHead(**kw)
    gots, _ = _module_case(j_misc.UPerHead(**kw), port, (_maps(7),),
                           'decode_head_m', train)
    with torch.no_grad():
        port.eval()
        shuffled = port([_t(m) for m in _maps(7)],
                        patchmix_perm=torch.from_numpy(_perm()),
                        patchmix_n=2)
    if not train:
        torch.testing.assert_close(shuffled, gots[0], rtol=0, atol=0)
    assert {'psp_modules.3.1.conv.weight', 'lateral_convs.2.bn.weight',
            'fpn_convs.0.conv.weight', 'fpn_bottleneck.bn.running_var',
            'bottleneck.conv.weight'} <= set(port.state_dict())


@pytest.mark.parametrize('train', [False, True])
def test_ocr_head_matches_jax(train):
    """The previous stage's logits (at another size than the map, so
    resized) give the class contexts; the object-attention block and the
    fusion bottleneck (context first); BN over a [B, K, 1, C] map of the
    contexts in train mode."""
    kw = dict(in_channels=[4, 8, 16, 32], in_index=(0, 1, 2, 3),
              input_transform='resize_concat', channels=12,
              ocr_channels=8, dropout_ratio=-1, num_classes=5)
    inputs = _maps(8, MAPS + [(B, 8, 8, 5)])
    port = OCRHead(**kw)
    _module_case(j_misc.OCRHead(**kw), port, (inputs,), 'decode_head_m',
                 train)
    assert {'bottleneck.conv.weight',
            'object_context_block.query_project.1.bn.weight',
            'object_context_block.key_project.0.conv.weight',
            'object_context_block.value_project.bn.running_mean',
            'object_context_block.out_project.conv.weight',
            'object_context_block.bottleneck.conv.weight',
            'conv_seg.bias'} <= set(port.state_dict())


# ------------------------------------------------------- tiny segmentors
def _tiny_pair(cfg):
    """(JAX model, its variables, the port's model loaded through the
    bridge)."""
    jmodel = j_build_segmentor(copy.deepcopy(cfg))
    v = shaped_variables(lambda: init_segmentor_variables(
        jmodel, jax.random.PRNGKey(0), (1, 64, 64, 3)))
    model = build_segmentor(copy.deepcopy(cfg))
    model.load_state_dict(state_dict_from_jax_variables(v))
    return jmodel, v, model.eval()


@pytest.mark.parametrize('which', ['upernet_swin', 'ocrnet_hrnet'])
def test_tiny_segmentor_forward_and_bridge_back(which):
    """The forward (the cascade's second stage on the first's logits);
    the port's state dict read back by JAX ``convert_mmseg_checkpoint``
    to the same variables, number for number (Swin at window 2: at
    window 7 JAX sizes the shrunk stages' tables by their grid, which no
    mmseg file can hold); no kernel launch."""
    cfg = upernet_swin_model(window_size=2) if which == 'upernet_swin' \
        else ocrnet_model()
    jmodel, v, model = _tiny_pair(cfg)
    x = _x(9)
    launches = fa.launch_count
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        jax.tree_util.tree_map(jnp.asarray, v), jnp.asarray(x))
    with torch.no_grad():
        got = model(_t(x))
    _close(got, want)
    assert fa.launch_count == launches
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
    if which == 'ocrnet_hrnet':
        assert model.num_classes == cfg['decode_head'][-1]['num_classes']
        assert any(k.startswith('decode_head.1.object_context_block.')
                   for k in sd)


def test_swin_shrunk_window_tables_through_the_bridge():
    """At window 7 and 64² the JAX tables of stages 2 and 3 hold (2 ws -
    1)² offsets of their shrunk windows; the bridge puts them at the
    centre of the port's 13 x 13 tables, where the forward reads them, and
    the tiny UPerNet-Swin agrees with JAX."""
    jmodel, v, model = _tiny_pair(upernet_swin_model(window_size=7))
    bb = v['params']['backbone_m']
    assert bb['stage_2_block_0']['attn'][
        'relative_position_bias_table'].shape == (49, 3)
    table = model.backbone.stages[2].blocks[0].attn['w_msa'] \
        .relative_position_bias_table.detach().numpy()
    np.testing.assert_array_equal(
        table.reshape(13, 13, 3)[3:10, 3:10].reshape(49, 3),
        bb['stage_2_block_0']['attn']['relative_position_bias_table'])
    assert not table.reshape(13, 13, 3)[0].any()
    x = _x(10)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        jax.tree_util.tree_map(jnp.asarray, v), jnp.asarray(x))
    with torch.no_grad():
        _close(model(_t(x)), want)


def test_teacher_pasa_with_the_cascade_matches_jax():
    """Teacher-PASA inference on the tiny OCRNet: the teacher's stages in
    turn (the second on the first's logits) give the confidence; the bias
    is built and ignored by HRNet, as in JAX, so the labels are the plain
    request's."""
    jmodel, v, model = _tiny_pair(ocrnet_model())
    ema = perturbed(v, seed=2)
    js = japis.Segmentor(jmodel, jax.tree_util.tree_map(jnp.asarray, v),
                         JConfig(dict(crop_size=(64, 64))))
    seg = apis.Segmentor(model, Config(dict(crop_size=(64, 64))), 'cpu')
    img = np.random.RandomState(8).randint(0, 256, (50, 60, 3), np.uint8)
    want = japis.inference_with_teacher_pasa(
        js, img, jax.tree_util.tree_map(jnp.asarray, ema))
    got = apis.inference_with_teacher_pasa(
        seg, img, state_dict_from_jax_variables(ema))
    np.testing.assert_array_equal(got, apis.inference_segmentor(seg, img))
    x, _ = japis._prepare_image(js, img)
    logits = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        js.variables, jnp.asarray(x))[0, :50, :60]
    probs = np.asarray(jax.nn.softmax(logits, -1))
    np.testing.assert_array_equal(want, probs.argmax(-1))
    assert_argmax_agrees(probs, np.eye(5, dtype=np.float32)[got], 1e-4)
