"""Encoding layer of EncNet (counterpart of ``s4former_tpu/ops/encoding.py``;
reference: mmseg/ops/encoding.py:7-76).

Every pixel is soft-assigned to ``num_codes`` codewords by the scaled
squared L2 distance ``scale_k * |x - c_k|²``, and the assigned residuals
are summed: out[b, k] = sum_n a[b, n, k] (x[b, n] - c_k). As JAX's, the
distance and the sum are expanded into products of ``x`` and the
codewords apart, so the peak is [B, N, K] and not the reference's
[B, N, K, C]. ``codewords`` [K, C] and ``scale`` [K] hold the reference's
values (keys ``codewords``, ``scale``) and its uniform initial ranges.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class Encoding(nn.Module):
    """NHWC [B, H, W, C] -> encoded residuals [B, num_codes, C], f32."""

    def __init__(self, channels: int, num_codes: int = 32):
        super().__init__()
        self.codewords = nn.Parameter(torch.empty(num_codes, channels))
        self.scale = nn.Parameter(torch.empty(num_codes))
        self.init_seeded(None)

    @torch.no_grad()
    def init_seeded(self, generator: Optional[torch.Generator]):
        """The reference's uniform ranges: codewords within
        ±1/sqrt(num_codes * channels), scales in [-1, 0)."""
        k, c = self.codewords.shape
        std = 1.0 / (k * c) ** 0.5
        self.codewords.uniform_(-std, std, generator=generator)
        self.scale.uniform_(-1.0, 0.0, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        feats = x.reshape(b, h * w, c).float()
        cw = self.codewords.float()
        x2 = (feats * feats).sum(-1, keepdim=True)               # [B, N, 1]
        c2 = (cw * cw).sum(-1)                                   # [K]
        xc = torch.einsum('bnc,kc->bnk', feats, cw)              # [B, N, K]
        assign = torch.softmax(self.scale * (x2 - 2.0 * xc + c2), dim=2)
        agg_x = torch.einsum('bnk,bnc->bkc', assign, feats)
        agg_c = assign.sum(1)[..., None] * cw[None]
        return (agg_x - agg_c).to(x.dtype)
