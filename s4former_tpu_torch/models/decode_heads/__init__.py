"""Decode heads; importing registers them."""
from s4former_tpu_torch.models.decode_heads.setr_up import SETRUPHead  # noqa: F401
from s4former_tpu_torch.models.decode_heads.segformer import SegformerHead  # noqa: F401
