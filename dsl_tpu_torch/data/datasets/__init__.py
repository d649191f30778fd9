from dsl_tpu_torch.data.datasets.custom import CustomDataset  # noqa: F401
from dsl_tpu_torch.data.datasets.coco import (  # noqa: F401
    COCO_CLASSES, CocoDataset)
from dsl_tpu_torch.data.datasets.semicoco import SemiCOCODataset  # noqa: F401
