from dsl_tpu_torch.models.detectors.single_stage import (  # noqa: F401
    FCOS, SSD, RetinaNet, SingleStageDetector, build_detector, detector_loss,
    detector_predict)
from dsl_tpu_torch.models.detectors.cascade_rcnn import (  # noqa: F401
    HTC, CascadeRCNN, SCNet, build_cascade_rcnn, cascade_rcnn_loss,
    cascade_rcnn_predict, htc_loss, htc_predict, scnet_loss, scnet_predict)
from dsl_tpu_torch.models.detectors.two_stage import (  # noqa: F401
    RPN, DetectoRS, FasterRCNN, FastRCNN, MaskScoringRCNN, TwoStageDetector,
    fast_rcnn_predict, rpn_only_loss, rpn_only_predict, two_stage_loss,
    two_stage_predict)
from dsl_tpu_torch.models.detectors.multi_head import (  # noqa: F401
    FCOSMultiHead, SingleStageMultiHeadDetector, build_multi_head_detector,
    multi_head_loss, multi_head_predict)
