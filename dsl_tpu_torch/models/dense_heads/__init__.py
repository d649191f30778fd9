from dsl_tpu_torch.models.dense_heads.fcos_head import (  # noqa: F401
    FCOSHead, fcos_get_bboxes)
