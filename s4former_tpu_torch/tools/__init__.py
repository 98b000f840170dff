"""Command-line entry points: ``python -m s4former_tpu_torch.tools.train``
and ``python -m s4former_tpu_torch.tools.test``."""
