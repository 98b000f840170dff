from s4former_tpu_torch.data.datasets.custom import (  # noqa: F401
    CityscapesDataset, CustomDataset, PascalVOCDataset, RepeatDataset,
    SemiDataset, build_dataset)
