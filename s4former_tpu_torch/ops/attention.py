"""Multi-head attention compute path (counterpart of
``s4former_tpu/ops/attention.py``).

- ``dot_product_attention``: plain PyTorch; can return the probabilities
  (the explicit debug output that replaces the reference's patched-mmcv
  ``.self_attn``, mmseg/models/backbones/vit.py:550).
- ``multi_head_attention``: the ViT's dispatch. It goes through
  ``flash_attention``, which launches the CUDA kernel for CUDA tensors and
  takes its plain version for CPU tensors. A request for probabilities, or
  ``use_flash=False``, takes ``dot_product_attention``, as the JAX dispatch
  does.

Shapes: q, k, v are [B, L, H, D]; bias broadcasts to [B, H, Lq, Lk] (PASA
uses [B, 1, L, L]).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from s4former_tpu_torch.ops.flash_attention import flash_attention


def dot_product_attention(
        q: torch.Tensor,
        k: torch.Tensor,
        v: torch.Tensor,
        bias: Optional[torch.Tensor] = None,
        return_probs: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns (out [B,L,H,D], probs [B,H,Lq,Lk] or None). Logits are f32
    whatever the input dtype; the probabilities meet v in v's dtype."""
    d = q.shape[-1]
    logits = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float())
    logits = logits * (1.0 / math.sqrt(d))
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum('bhqk,bkhd->bqhd', probs.to(v.dtype).float(),
                       v.float()).to(q.dtype)
    return (out, probs) if return_probs else (out, None)


def multi_head_attention(
        q: torch.Tensor,
        k: torch.Tensor,
        v: torch.Tensor,
        bias: Optional[torch.Tensor] = None,
        return_probs: bool = False,
        use_flash: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Flash attention (CUDA kernel on the card, its plain version on the
    CPU), or the plain path when probabilities are asked for or the model
    sets ``use_flash=False`` (the JAX option; no kernel runs then)."""
    if return_probs or not use_flash:
        return dot_product_attention(q, k, v, bias, return_probs)
    return flash_attention(q, k, v, bias=bias), None
