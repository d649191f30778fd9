from dsl_tpu_torch.models.necks.channel_mapper import (  # noqa: F401
    IdentityNeck, SequentialNeck)
from dsl_tpu_torch.models.necks.fpn import FPN  # noqa: F401
from dsl_tpu_torch.models.necks.ssd_neck import SSDNeck  # noqa: F401
from dsl_tpu_torch.models.necks.rfp import RFP  # noqa: F401
from dsl_tpu_torch.models.necks.hrfpn import HRFPN  # noqa: F401
from dsl_tpu_torch.models.necks.pafpn import PAFPN  # noqa: F401
from dsl_tpu_torch.models.necks.fpn_carafe import FPN_CARAFE  # noqa: F401
from dsl_tpu_torch.models.necks.bfp import BFP  # noqa: F401
from dsl_tpu_torch.models.necks.nas_fpn import NASFPN  # noqa: F401
from dsl_tpu_torch.models.necks.nasfcos_fpn import FPG, NASFCOS_FPN  # noqa: F401
