from dsl_tpu_torch.models.dense_heads.fcos_head import (  # noqa: F401
    FCOSHead, fcos_get_bboxes)
from dsl_tpu_torch.models.dense_heads.retina_head import (  # noqa: F401
    RetinaHead, retina_get_bboxes, retina_loss)
from dsl_tpu_torch.models.dense_heads.rpn_head import (  # noqa: F401
    RPNHead, rpn_loss, rpn_proposals)
from dsl_tpu_torch.models.dense_heads.ssd_head import (  # noqa: F401
    SSDHead, ssd_get_bboxes, ssd_loss)
from dsl_tpu_torch.models.dense_heads.yolact_head import (  # noqa: F401
    YOLACTHead, YOLACTProtonet, YOLACTSegmHead, yolact_loss, yolact_predict)
from dsl_tpu_torch.models.dense_heads.vfnet_head import (  # noqa: F401
    VFNetHead, vfnet_get_bboxes, vfnet_loss)
from dsl_tpu_torch.models.dense_heads.nasfcos_head import (  # noqa: F401
    NASFCOSHead)
