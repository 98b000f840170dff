"""Necks; importing registers them."""
from s4former_tpu_torch.models.necks.necks import (  # noqa: F401
    FPN, ICNeck, MLANeck)
