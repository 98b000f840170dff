from s4former_tpu_torch.data.datasets.custom import (  # noqa: F401
    CustomDataset, PascalVOCDataset, RepeatDataset, SemiDataset,
    build_dataset)
