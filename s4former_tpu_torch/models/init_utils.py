"""Seeded parameter initialisation (counterpart of
``s4former_tpu/models/init_utils.py``).

Follows flax's default initialisers in kind: dense and conv kernels are
normal with std 1/sqrt(fan_in) (lecun normal), biases zero, norms identity,
the ViT ``pos_embed`` normal with std 0.02 and ``cls_token`` zero. The draws
come from an explicit ``torch.Generator`` on the CPU, so one seed gives the
same weights on every device; they do not reproduce ``jax.random`` streams.
"""
from __future__ import annotations

import math

import torch
from torch import nn


@torch.no_grad()
def init_segmentor_weights(model: nn.Module,
                           generator: torch.Generator) -> nn.Module:
    """Draw every parameter of ``model`` (on the CPU) from ``generator``."""
    for name, p in model.named_parameters():
        leaf = name.rsplit('.', 1)[-1]
        if name.endswith('pos_embed'):
            p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
        elif p.dim() >= 2 and leaf != 'cls_token':
            fan_in = p[0].numel()
            p.copy_(torch.randn(p.shape, generator=generator) /
                    math.sqrt(fan_in))
        elif leaf == 'weight' and p.dim() == 1:   # LayerNorm / BN scale
            p.fill_(1.0)
        else:                                     # biases, cls_token
            p.zero_()
    return model
