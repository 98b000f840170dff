"""EncoderDecoder segmentor (counterpart of
``s4former_tpu/models/segmentors/encoder_decoder.py``; reference:
mmseg/models/segmentors/encoder_decoder.py).

Holds only the network: backbone, neck, decode head and aux heads. The semi
algorithm lives in ``semi/train_step.py``; its EMA teacher is a second copy
of this module (``apis.inference_with_teacher_pasa`` runs it from a state
dict instead). The aux heads are plain per-level modules under the
reference's keys ``auxiliary_head.{i}.``; serving builds and loads them
but runs them only in training. ``train`` selects the training forward
(BN on batch statistics) per call, as the JAX methods' ``train`` argument
does; it defaults to eval. ``generator`` carries a train forward's
randomness (the MiT's drop path, the SegFormer head's dropout) to the
backbone and the heads, as the JAX methods' ``rngs={'dropout': ...}``
does. A neck (``neck.``) runs after the backbone in ``extract_feat``,
which passes the backbone's attention maps through (JAX
encoder_decoder.py:120-138).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from s4former_tpu_torch.ops.resize import resize_bilinear
from s4former_tpu_torch.registry import MODELS, SEGMENTORS

_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def _build_module(cfg: Optional[Dict]):
    if cfg is None:
        return None
    kwargs = dict(cfg)
    # configs are plain python dicts; accept dtype as a string
    if isinstance(kwargs.get('dtype'), str):
        kwargs['dtype'] = _DTYPES[kwargs['dtype']]
    return MODELS.build(kwargs)


@SEGMENTORS.register_module()
class EncoderDecoder(nn.Module):
    """Backbone -> (neck) -> decode head (+ aux heads), built from config
    dicts."""

    def __init__(self, backbone: Dict, decode_head: Dict,
                 neck: Optional[Dict] = None,
                 auxiliary_head=None,
                 align_corners: bool = False):
        super().__init__()
        self.align_corners = align_corners
        self.backbone = _build_module(backbone)
        self.neck = _build_module(neck)
        self.decode_head = _build_module(decode_head)
        if isinstance(auxiliary_head, dict):
            auxiliary_head = [auxiliary_head]
        self.auxiliary_head = nn.ModuleList(
            [_build_module(a) for a in auxiliary_head or []])

    @property
    def num_classes(self) -> int:
        return self.decode_head.num_classes

    def extract_feat(self, img: torch.Tensor, *, train: bool = False,
                     attn_bias: Optional[torch.Tensor] = None,
                     pos_mode: str = 'default',
                     use_fdrop: bool = False,
                     return_attn: bool = False,
                     generator: Optional[torch.Generator] = None):
        """Backbone (+ neck) features (tuple of NHWC maps) [, (attns,
        grid)]."""
        out = self.backbone(img, train=train, attn_bias=attn_bias,
                            pos_mode=pos_mode, use_fdrop=use_fdrop,
                            return_attn=return_attn, generator=generator)
        if self.neck is None:
            return out
        feats, attn = out if return_attn else (out, None)
        feats = self.neck(feats, train=train)
        return (feats, attn) if return_attn else feats

    def decode_logits(self, feats, *, train: bool = False,
                      patchmix_perm: Optional[torch.Tensor] = None,
                      patchmix_n: int = 0,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
        """Main-head logits (reference ``forward_get_logits``)."""
        return self.decode_head(feats, train=train,
                                patchmix_perm=patchmix_perm,
                                patchmix_n=patchmix_n, generator=generator)

    def aux_logits(self, feats, *, train: bool = False,
                   generator: Optional[torch.Generator] = None
                   ) -> List[torch.Tensor]:
        return [head(feats, train=train, generator=generator)
                for head in self.auxiliary_head]

    def encode_decode(self, img: torch.Tensor) -> torch.Tensor:
        """Logits resized to the input resolution
        (encoder_decoder.py:265-296)."""
        logits = self.decode_logits(self.extract_feat(img))
        if tuple(logits.shape[1:3]) != tuple(img.shape[1:3]):
            logits = resize_bilinear(logits, tuple(img.shape[1:3]),
                                     self.align_corners)
        return logits

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.encode_decode(img)

    def forward_train_heads(self, feats, *, train: bool = True,
                            patchmix_perm: Optional[torch.Tensor] = None,
                            patchmix_n: int = 0,
                            generator: Optional[torch.Generator] = None):
        """(main logits, [aux logits...]) for the training step."""
        main = self.decode_logits(feats, train=train,
                                  patchmix_perm=patchmix_perm,
                                  patchmix_n=patchmix_n, generator=generator)
        return main, self.aux_logits(feats, train=train, generator=generator)

    def forward_decode_from_img(self, img: torch.Tensor, *,
                                train: bool = False,
                                attn_bias: Optional[torch.Tensor] = None,
                                pos_mode: str = 'default',
                                use_fdrop: bool = False,
                                patchmix_perm: Optional[torch.Tensor] = None,
                                patchmix_n: int = 0,
                                generator: Optional[torch.Generator] = None
                                ) -> torch.Tensor:
        """Main-head logits at head resolution (the unlabeled branch and
        the teacher never use the aux heads, encoder_decoder.py:650-679)."""
        feats = self.extract_feat(img, train=train, attn_bias=attn_bias,
                                  pos_mode=pos_mode, use_fdrop=use_fdrop,
                                  generator=generator)
        return self.decode_logits(feats, train=train,
                                  patchmix_perm=patchmix_perm,
                                  patchmix_n=patchmix_n, generator=generator)

    def forward_train_heads_from_img(
            self, img: torch.Tensor, *, train: bool = True,
            attn_bias: Optional[torch.Tensor] = None,
            pos_mode: str = 'default', use_fdrop: bool = False,
            patchmix_perm: Optional[torch.Tensor] = None,
            patchmix_n: int = 0,
            generator: Optional[torch.Generator] = None):
        feats = self.extract_feat(img, train=train, attn_bias=attn_bias,
                                  pos_mode=pos_mode, use_fdrop=use_fdrop,
                                  generator=generator)
        return self.forward_train_heads(feats, train=train,
                                        patchmix_perm=patchmix_perm,
                                        patchmix_n=patchmix_n,
                                        generator=generator)


def build_segmentor(cfg: Dict) -> EncoderDecoder:
    """Build a segmentor from a model config dict, dropping the keys that
    configure training, the semi algorithm or the EMA twin, so reference
    configs load unchanged. A MiT backbone takes the segmentor's PASA flags
    ``attn_mask_weight`` and ``adaptive_attn_mask`` as its own config
    (JAX encoder_decoder.py:236-243; the reference passes them per
    forward, mit.py:460)."""
    cfg = dict(cfg)
    for k in ('pretrained', 'train_cfg', 'test_cfg', 'init_cfg'):
        cfg.pop(k, None)
    bb = cfg.get('backbone')
    if isinstance(bb, dict) and bb.get('type') == 'MixVisionTransformer':
        bb = dict(bb)
        for k in ('attn_mask_weight', 'adaptive_attn_mask'):
            if k in cfg and k not in bb:
                bb[k] = cfg[k]
        cfg['backbone'] = bb
    for k in list(cfg):
        if k.endswith('_ema') or k in SEMI_FLAG_KEYS:
            cfg.pop(k)
    return SEGMENTORS.build(cfg)


# every semi-algorithm constructor flag of the reference segmentor
# (encoder_decoder.py:25-95)
SEMI_FLAG_KEYS = frozenset({
    'ema', 'sup_ema', 'ema_momentum', 'attn_frozen', 'attn_frozen_rate',
    'momentum_backbone', 'momentum_head', 'momentum_head_dropout',
    'momentum_head_exp', 'momentum_exp', 'ema_test',
    'sup_ClassMix', 'sup_cutmix',
    'unsup_weight', 'unsup_confidence', 'unsup_soft', 'unsup_temperature',
    'iter_unsup_start',
    'strong_aug_prob', 'cutout_area', 'use_CutMix', 'use_CutOut',
    'use_ClassMix', 'mix_with_labeled', 'patchwise',
    'use_PatchShuffle', 'PatchMix_N', 'patchmix_ratio', 'patchsize',
    'use_PatchShuffle_w_Classmix', 'use_PatchShuffle_w_Cutmix',
    'no_pos_embed', 'avg_pos_emd', 'duplicate_pos_emd',
    'adaptive_attn_mask', 'attn_mask_weight', 'attn_mask_seperate_head',
    'attn_mask_w_fdrop',
    'negative_class_ranking', 'negative_class_ranking_mode',
    'use_fdrop', 'unimatch', 'fdrop_loss_weight', 'use_cutmix_adaptive',
    'use_attn_mask_inline', 'fuse_unsup_passes',
    'backbone_pretrain', 'projection_head',
})
