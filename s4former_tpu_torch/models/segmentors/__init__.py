"""Segmentors; importing registers them."""
from s4former_tpu_torch.models.segmentors.encoder_decoder import (  # noqa: F401
    EncoderDecoder, build_segmentor)
