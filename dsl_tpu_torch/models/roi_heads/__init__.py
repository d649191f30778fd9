from dsl_tpu_torch.models.roi_heads.standard_roi_head import (  # noqa: F401
    Shared2FCBBoxHead, Shared4Conv1FCBBoxHead, extract_roi_feats,
    roi_head_loss, roi_head_predict)
from dsl_tpu_torch.models.roi_heads.mask_head import FCNMaskHead  # noqa: F401
from dsl_tpu_torch.models.roi_heads.shared_heads import (  # noqa: F401
    BBoxHeadAvgPool, ResLayerSharedHead)
from dsl_tpu_torch.models.roi_heads.maskiou_head import MaskIoUHead  # noqa: F401
from dsl_tpu_torch.models.roi_heads.htc import (  # noqa: F401
    FusedSemanticHead, HTCMaskHead)
from dsl_tpu_torch.models.roi_heads.scnet import (  # noqa: F401
    FeatureRelayHead, GlobalContextHead, SCNetBBoxHead, SCNetMaskHead)
from dsl_tpu_torch.models.roi_heads.point_rend import (  # noqa: F401
    CoarseMaskHead, MaskPointHead)
