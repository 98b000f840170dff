from s4former_tpu_torch.data.pipelines import transforms  # noqa: F401
from s4former_tpu_torch.data.pipelines import extra_transforms  # noqa: F401
