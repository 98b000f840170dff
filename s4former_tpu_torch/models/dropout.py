"""Train-mode randomness of the port's models: element-wise dropout (flax
``nn.Dropout``), per-sample drop path and the channelwise fdrop of the
backbones' outputs (reference ``nn.Dropout2d(0.5)``, vit.py:563-564), each
drawn from the caller's ``torch.Generator`` on the tensor's device.

Every mask comes from ``keep_mask``: a kept value is scaled by 1/keep and a
dropped one is 0, as the JAX package's ``jnp.where(mask, x / keep, 0)``.
Under data parallelism a mask is drawn at the global batch and the rank
keeps its rows (``parallel.mesh.draw_rows``): the masks of the N-rank step
are those of the single-process step on the global batch.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from s4former_tpu_torch.parallel.mesh import draw_rows


def keep_mask(generator: Optional[torch.Generator], keep: float,
              shape: Sequence[int], device) -> torch.Tensor:
    """A bool mask of ``shape`` (batch axis first), each entry True with
    probability ``keep`` (``jax.random.bernoulli(key, keep, shape)``)."""
    if generator is None:
        raise ValueError('dropout and drop path in train mode draw from a '
                         'torch.Generator; pass generator=')
    return draw_rows(lambda s: torch.rand(s, generator=generator,
                                          device=device) < keep, shape)


def apply_keep(x: torch.Tensor, mask: torch.Tensor,
               rate: float) -> torch.Tensor:
    """``x`` with a drawn ``mask`` of a dropout of ``rate`` applied: kept
    values scaled by 1/keep, dropped ones 0."""
    keep = 1.0 - rate
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def _masked(x: torch.Tensor, rate: float, shape: Sequence[int],
            generator: Optional[torch.Generator]) -> torch.Tensor:
    return apply_keep(x, keep_mask(generator, 1.0 - rate, shape, x.device),
                      rate)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Element-wise dropout: each value kept with probability 1 - rate
    (scaled by 1/keep) or zeroed."""
    return _masked(x, rate, x.shape, generator)


def drop_path(y: torch.Tensor, rate: float,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    """Per-sample stochastic depth: each sample's ``y`` is kept with
    probability 1 - rate (scaled by 1/keep) or zeroed."""
    return _masked(y, rate, (y.shape[0],) + (1,) * (y.dim() - 1), generator)


def channel_dropout(x: torch.Tensor, generator: Optional[torch.Generator],
                    rate: float = 0.5) -> torch.Tensor:
    """fdrop on an NHWC map: one keep mask [B, 1, 1, C] per sample and
    channel (the JAX backbones' ``bernoulli(key, 0.5, (B, 1, 1, C))``, kept
    channels x2)."""
    return _masked(x, rate, (x.shape[0], 1, 1, x.shape[-1]), generator)
