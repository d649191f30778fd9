from dsl_tpu_torch.models.necks.channel_mapper import IdentityNeck  # noqa: F401
from dsl_tpu_torch.models.necks.fpn import FPN  # noqa: F401
from dsl_tpu_torch.models.necks.ssd_neck import SSDNeck  # noqa: F401
from dsl_tpu_torch.models.necks.rfp import RFP  # noqa: F401
from dsl_tpu_torch.models.necks.hrfpn import HRFPN  # noqa: F401
