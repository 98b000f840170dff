"""Data layer: importing it registers the datasets and pipelines."""
from s4former_tpu_torch.data import datasets, pipelines  # noqa: F401
from s4former_tpu_torch.data.datasets.custom import build_dataset  # noqa: F401
from s4former_tpu_torch.data.loader import (SemiBalanceSampler,  # noqa: F401
                                            SemiLoader)
