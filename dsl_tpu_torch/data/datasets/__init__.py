from dsl_tpu_torch.data.datasets.custom import CustomDataset  # noqa: F401
from dsl_tpu_torch.data.datasets.coco import (  # noqa: F401
    COCO_CLASSES, CocoDataset)
from dsl_tpu_torch.data.datasets.semicoco import SemiCOCODataset  # noqa: F401
from dsl_tpu_torch.data.datasets.voc import (  # noqa: F401
    VOC_CLASSES, VOCDataset, WIDERFaceDataset, XMLDataset)
from dsl_tpu_torch.data.datasets.semivoc import SemiVOCDataset  # noqa: F401
from dsl_tpu_torch.data.datasets.voc2coco import Voc2CocoDataset  # noqa: F401
from dsl_tpu_torch.data.datasets.wrappers import (  # noqa: F401
    ClassBalancedDataset, ConcatDataset, RepeatDataset)
