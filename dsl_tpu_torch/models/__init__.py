"""Importing this package registers every ported model part."""
from dsl_tpu_torch.models.backbones import ResNet, RLAResNet  # noqa: F401
from dsl_tpu_torch.models.necks import FPN  # noqa: F401
from dsl_tpu_torch.models.dense_heads import (  # noqa: F401
    FCOSHead, RPNHead, RetinaHead, fcos_get_bboxes)
from dsl_tpu_torch.models.roi_heads import Shared2FCBBoxHead  # noqa: F401
from dsl_tpu_torch.models.detectors import (  # noqa: F401
    FCOS, FasterRCNN, RetinaNet, SingleStageDetector, TwoStageDetector,
    build_detector, detector_predict)
