"""Demo scripts of the port (``python -m s4former_tpu_torch.demo.<name>``)."""
