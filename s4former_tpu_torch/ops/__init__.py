"""Tensor ops: resize, attention and the CUDA flash-attention kernel."""
