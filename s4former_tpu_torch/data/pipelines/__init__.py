from s4former_tpu_torch.data.pipelines import transforms  # noqa: F401
