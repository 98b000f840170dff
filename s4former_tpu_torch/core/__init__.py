"""Checkpoint bridge between the JAX package, mmseg .pth files and the port."""
