"""Seeded parameter initialisation (counterpart of
``s4former_tpu/models/init_utils.py``).

Follows flax's default initialisers in kind: dense and conv kernels are
normal with std 1/sqrt(fan_in) (lecun normal), biases zero, norms identity,
the ViT ``pos_embed``, Segmenter's ``cls_emb`` and Swin's
``relative_position_bias_table`` normal with std 0.02 and ``cls_token``
zero. A module with its own initialisers draws them in ``init_seeded``
(EncNet's ``Encoding``: uniform codewords and scales; EMANet's bases, a
buffer). The draws
come from an explicit ``torch.Generator`` on the CPU, so one seed gives the
same weights on every device; they do not reproduce ``jax.random`` streams.
"""
from __future__ import annotations

import contextlib
import math

import torch
from torch import nn

# the ``torch.nn.init`` functions PyTorch's modules call in
# ``reset_parameters``
_DEFAULT_INITS = ('kaiming_uniform_', 'uniform_', 'normal_', 'ones_',
                  'zeros_', 'constant_', 'trunc_normal_', 'xavier_uniform_')


@contextlib.contextmanager
def skip_default_init():
    """Build modules without PyTorch's default parameter draws (their
    ``reset_parameters`` leave the parameters as allocated), for a model
    whose every parameter ``init_segmentor_weights`` then draws: those
    draws cost the host about as long again as the seeded ones. Buffers
    are made as usual."""
    saved = {name: getattr(nn.init, name) for name in _DEFAULT_INITS}
    try:
        for name in _DEFAULT_INITS:
            setattr(nn.init, name, lambda tensor, *args, **kwargs: tensor)
        yield
    finally:
        for name, fn in saved.items():
            setattr(nn.init, name, fn)


@torch.no_grad()
def init_segmentor_weights(model: nn.Module,
                           generator: torch.Generator) -> nn.Module:
    """Draw every parameter of ``model`` (on the CPU) from ``generator``."""
    for name, p in model.named_parameters():
        leaf = name.rsplit('.', 1)[-1]
        if name.endswith(('pos_embed', 'cls_emb',
                          'relative_position_bias_table')):
            p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
        elif p.dim() >= 2 and leaf != 'cls_token':
            fan_in = p[0].numel()
            p.copy_(torch.randn(p.shape, generator=generator) /
                    math.sqrt(fan_in))
        elif leaf == 'weight' and p.dim() == 1:   # LayerNorm / BN scale
            p.fill_(1.0)
        else:                                     # biases, cls_token
            p.zero_()
    for m in model.modules():
        if isinstance(m, nn.LayerNorm) and m.elementwise_affine:
            m.weight.fill_(1.0)     # GCNet's LayerNorm([planes, 1, 1]) too
            m.bias.zero_()
        elif hasattr(m, 'init_seeded'):
            m.init_seeded(generator)
    return model
