"""Losses; importing registers them."""
from s4former_tpu_torch.models.losses.cross_entropy import CrossEntropyLoss  # noqa: F401
