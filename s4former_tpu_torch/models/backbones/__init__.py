"""Backbones; importing registers them."""
from s4former_tpu_torch.models.backbones.vit import VisionTransformer  # noqa: F401
from s4former_tpu_torch.models.backbones.mit import MixVisionTransformer  # noqa: F401
