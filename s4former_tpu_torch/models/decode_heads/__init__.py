"""Decode heads; importing registers them."""
from s4former_tpu_torch.models.decode_heads.setr_up import SETRUPHead  # noqa: F401
from s4former_tpu_torch.models.decode_heads.segformer import SegformerHead  # noqa: F401
from s4former_tpu_torch.models.decode_heads.zoo_heads import (  # noqa: F401
    ANNHead, APCHead, ASPPHead, DAHead, DepthwiseSeparableASPPHead,
    DepthwiseSeparableFCNHead, DMHead, DNLHead, EMAHead, EncHead, GCHead,
    ISAHead, LRASPPHead, NLHead, PSAHead)
from s4former_tpu_torch.models.decode_heads.misc_heads import (  # noqa: F401
    FCNHead, OCRHead, PSPHead, SETRMLAHead, UPerHead)
from s4former_tpu_torch.models.decode_heads.extra_heads import (  # noqa: F401
    CCHead, FPNHead, SegmenterMaskTransformerHead, STDCHead)
