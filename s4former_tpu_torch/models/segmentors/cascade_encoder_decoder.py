"""Cascade encoder-decoder (counterpart of
``s4former_tpu/models/segmentors/cascade_encoder_decoder.py``; reference:
mmseg/models/segmentors/cascade_encoder_decoder.py).

``decode_head`` is a list of head configs, kept as a ``ModuleList`` under
the reference keys ``decode_head.{i}.``: the first stage runs on the
backbone (or neck) features, each later one on those features and the
previous stage's logits (the last input). The last stage's logits are the
segmentor's; its ``num_classes`` is the model's. In training the earlier
stages' logits come before the aux heads' in ``forward_train_heads``, so
the step trains them as aux heads with their own ``loss_decode`` (JAX
train_step.py:75-99). Only the first stage is handed the PatchShuffle
permutation (JAX l.50, l.60); ``generator`` reaches every stage.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from s4former_tpu_torch.models.segmentors.encoder_decoder import (
    EncoderDecoder, _build_module)
from s4former_tpu_torch.registry import SEGMENTORS


@SEGMENTORS.register_module()
class CascadeEncoderDecoder(EncoderDecoder):
    """Backbone -> (neck) -> a chain of decode heads (+ aux heads)."""

    def __init__(self, backbone: Dict, decode_head: List[Dict],
                 num_stages: int = 2, **kwargs):
        super().__init__(backbone, None, **kwargs)
        self.decode_head = nn.ModuleList([_build_module(h)
                                          for h in decode_head])

    @property
    def num_classes(self) -> int:
        return self.decode_head[-1].num_classes

    def _stages(self, feats, train: bool,
                patchmix_perm: Optional[torch.Tensor], patchmix_n: int,
                generator: Optional[torch.Generator]) -> List[torch.Tensor]:
        out = self.decode_head[0](feats, train=train,
                                  patchmix_perm=patchmix_perm,
                                  patchmix_n=patchmix_n, generator=generator)
        logits = [out]
        for head in self.decode_head[1:]:
            out = head(list(feats) + [out], train=train, generator=generator)
            logits.append(out)
        return logits

    def decode_logits(self, feats, *, train: bool = False,
                      patchmix_perm: Optional[torch.Tensor] = None,
                      patchmix_n: int = 0,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
        return self._stages(feats, train, patchmix_perm, patchmix_n,
                            generator)[-1]

    def forward_train_heads(self, feats, *, train: bool = True,
                            patchmix_perm: Optional[torch.Tensor] = None,
                            patchmix_n: int = 0,
                            generator: Optional[torch.Generator] = None):
        """(last stage's logits, [earlier stages'..., aux logits...])."""
        logits = self._stages(feats, train, patchmix_perm, patchmix_n,
                              generator)
        return logits[-1], logits[:-1] + self.aux_logits(
            feats, train=train, generator=generator)
