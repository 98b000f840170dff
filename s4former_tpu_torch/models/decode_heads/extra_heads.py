"""Segmenter's mask-transformer decode head (counterpart of
``SegmenterMaskTransformerHead`` in
``s4former_tpu/models/decode_heads/extra_heads.py``, l.142-207; reference:
mmseg/models/decode_heads/segmenter_mask_head.py).

The picked feature map's patch tokens go through ``dec_proj``; the
learnable class embeddings ``cls_emb`` [1, num_classes, C] are appended;
``num_layers`` of the ViT's ``TransformerEncoderLayer`` run over the
whole sequence with plain attention (``use_flash=False``, as JAX l.184:
no kernel launches here) and drop path ramping linearly from 0 to
``drop_path_rate``; ``decoder_norm``; the patch and class tokens are
projected (``patch_proj``, ``classes_proj``, no bias), L2-normalised, and
their products are the masks, normalised over the classes by
``mask_norm``. Both norms take eps 1e-5 (mmcv's LN default; the head does
not pass the backbone's 1e-6). In f32, as the JAX head, whose layers
carry no ``dtype``. Reference keys: ``dec_proj``, ``cls_emb``,
``layers.{i}.*`` (the backbone layer's names), ``decoder_norm``,
``patch_proj``, ``classes_proj``, ``mask_norm``; no ``conv_seg``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from s4former_tpu_torch.models.backbones.vit import TransformerEncoderLayer
from s4former_tpu_torch.models.decode_heads.zoo_heads import HeadBase
from s4former_tpu_torch.registry import HEADS


@HEADS.register_module()
class SegmenterMaskTransformerHead(HeadBase):
    """Masks = LN(normalize(patches) @ normalize(classes)^T)."""

    def __init__(self, in_channels: int = 768, num_layers: int = 2,
                 num_heads: int = 6, embed_dims: int = 384,
                 channels: int = 384,       # config-parity alias, unused
                 num_classes: int = 21, mlp_ratio: int = 4,
                 drop_path_rate: float = 0.1, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, qkv_bias: bool = True,
                 in_index: Union[int, Sequence[int]] = -1,
                 input_transform: Optional[str] = None, **kwargs):
        super().__init__(num_classes, in_index, input_transform, **kwargs)
        self.drop_rate = drop_rate
        self.attn_drop_rate = attn_drop_rate   # changes no output (vit.py)
        self.drop_paths = [drop_path_rate * i / max(num_layers - 1, 1)
                           for i in range(num_layers)]
        self.dec_proj = nn.Linear(in_channels, embed_dims)
        self.cls_emb = nn.Parameter(torch.zeros(1, num_classes, embed_dims))
        self.layers = nn.ModuleList([
            TransformerEncoderLayer(embed_dims, num_heads,
                                    mlp_ratio * embed_dims,
                                    qkv_bias=qkv_bias, use_flash=False)
            for _ in range(num_layers)])
        self.decoder_norm = nn.LayerNorm(embed_dims, eps=1e-5)
        self.patch_proj = nn.Linear(embed_dims, embed_dims, bias=False)
        self.classes_proj = nn.Linear(embed_dims, embed_dims, bias=False)
        self.mask_norm = nn.LayerNorm(num_classes, eps=1e-5)

    def forward(self, inputs, *, train: bool = False,
                patchmix_perm: Optional[torch.Tensor] = None,
                patchmix_n: int = 0,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """``generator`` draws the train forward's dropout and drop path."""
        x = self._pick(inputs, patchmix_perm, patchmix_n).float()
        b, h, w, c = x.shape
        k = self.num_classes
        tokens = self.dec_proj(x.reshape(b, h * w, c))
        tokens = torch.cat([tokens, self.cls_emb.expand(b, -1, -1)], dim=1)
        for layer, drop_path in zip(self.layers, self.drop_paths):
            tokens = layer(tokens, None, self.drop_rate if train else 0.0,
                           drop_path if train else 0.0, generator)
        tokens = self.decoder_norm(tokens)
        patches = F.normalize(self.patch_proj(tokens[:, :-k]), dim=-1,
                              eps=1e-12)
        classes = F.normalize(self.classes_proj(tokens[:, -k:]), dim=-1,
                              eps=1e-12)
        masks = self.mask_norm(torch.einsum('bpd,bkd->bpk', patches,
                                            classes))
        return masks.reshape(b, h, w, k)
