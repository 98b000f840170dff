"""SemiConfig: every semi-supervised algorithm flag of the reference
segmentor (reference: mmseg/models/segmentors/encoder_decoder.py:25-95),
lifted out of the model into a static dataclass consumed by the train step.
Defaults match the reference constructor exactly.

The port's own copy of ``s4former_tpu/semi/config.py`` (the port imports
nothing of the JAX package). The port's train step (``semi/train_step.py``)
runs every flag; none raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SemiConfig:
    # ema
    ema: bool = False
    sup_ema: bool = False
    ema_momentum: float = 0.999
    attn_frozen: bool = False
    momentum_backbone: Optional[float] = None
    momentum_head: Optional[float] = None
    momentum_head_dropout: float = 0.0
    momentum_head_exp: float = 0.0
    momentum_exp: float = 0.0
    ema_test: bool = False
    # supervised mixes
    sup_ClassMix: bool = False
    sup_cutmix: bool = False
    # unsup branch
    unsup_weight: float = 2.0
    unsup_confidence: float = 0.75
    unsup_soft: bool = False
    unsup_temperature: float = 1.0
    iter_unsup_start: int = 0
    # strong augmentation
    strong_aug_prob: float = 0.5
    cutout_area: float = 2.0
    use_CutMix: bool = False
    use_CutOut: bool = False
    use_ClassMix: bool = False
    mix_with_labeled: bool = False
    patchwise: bool = False
    # PatchShuffle
    use_PatchShuffle: bool = False
    PatchMix_N: int = 8
    patchmix_ratio: float = 0.5
    patchsize: int = 16
    use_PatchShuffle_w_Classmix: bool = False
    use_PatchShuffle_w_Cutmix: bool = False
    # position embedding ablations
    no_pos_embed: bool = False
    avg_pos_emd: bool = False
    duplicate_pos_emd: bool = False
    # PASA
    adaptive_attn_mask: bool = False
    attn_mask_weight: float = 50.0
    attn_mask_seperate_head: bool = False
    attn_mask_w_fdrop: bool = False
    # NCR
    negative_class_ranking: bool = False
    negative_class_ranking_mode: str = 'sup_only'
    # our extension: the reference's inline (non-separate-head) PASA path
    # builds an attention mask for the final student pass but the resulting
    # loss is dead code (compute_pseudo_loss is only called when
    # use_fdrop/attn_mask_seperate_head, encoder_decoder.py:656-687), so the
    # reference MT baseline trains with NO unsup loss. We gate the inline
    # bias behind this explicit flag and give MT a real pseudo-CE loss.
    use_attn_mask_inline: bool = False
    # our extension: run the PASA separate-head pass and the final mixed
    # student pass as ONE concatenated-batch forward (same math per-sample;
    # BatchNorm moments are computed over the fused 2B batch instead of
    # per-pass — documented divergence, disable for exact-parity studies).
    # Halves the forward count of the unsup branch and doubles its batch.
    fuse_unsup_passes: bool = True
    # other methods
    use_fdrop: bool = False
    unimatch: bool = False
    fdrop_loss_weight: float = 0.5
    use_cutmix_adaptive: bool = False

    @property
    def pos_mode(self) -> str:
        if self.no_pos_embed:
            return 'none'
        if self.avg_pos_emd:
            return 'avg'
        if self.duplicate_pos_emd:
            return 'duplicate'
        return 'default'

    @property
    def effective_momentum_backbone(self) -> float:
        return self.momentum_backbone if self.momentum_backbone is not None \
            else self.ema_momentum

    @property
    def effective_momentum_head(self) -> float:
        return self.momentum_head if self.momentum_head is not None \
            else self.ema_momentum

    @staticmethod
    def from_model_cfg(model_cfg: dict) -> 'SemiConfig':
        """Extract semi flags from a reference-shaped model config dict."""
        fields = {f.name for f in dataclasses.fields(SemiConfig)}
        kwargs = {k: v for k, v in dict(model_cfg).items() if k in fields}
        return SemiConfig(**kwargs)
