from dsl_tpu_torch.models.detectors.single_stage import (  # noqa: F401
    FCOS, SingleStageDetector, build_detector, detector_predict)
