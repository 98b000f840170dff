"""s4former_tpu_torch: the PyTorch + CUDA port of s4former_tpu for NVIDIA
Hopper (H100).

The JAX package ``s4former_tpu`` is the reference; each module here mirrors
the module of the same path there. Importing the package has no side
effects: no platform selection, no compile cache, no kernel build.
"""
__version__ = '0.1.0'

from s4former_tpu_torch.config import Config, ConfigDict, DictAction  # noqa: F401
from s4former_tpu_torch.registry import (BACKBONES, HEADS, MODELS,  # noqa: F401
                                         SEGMENTORS)
