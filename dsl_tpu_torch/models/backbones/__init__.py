from dsl_tpu_torch.models.backbones.resnet import (  # noqa: F401
    ResNet, ResNetV1d, ResNeXt)
from dsl_tpu_torch.models.backbones.rla_resnet import RLAResNet  # noqa: F401
from dsl_tpu_torch.models.backbones.ssd_vgg import SSDVGG  # noqa: F401
from dsl_tpu_torch.models.backbones.detectors_resnet import (  # noqa: F401
    DetectoRSResNet, DetectoRSResNeXt)
from dsl_tpu_torch.models.backbones.hrnet import HRNet  # noqa: F401
from dsl_tpu_torch.models.backbones.regnet import RegNet  # noqa: F401
from dsl_tpu_torch.models.backbones.resnest import ResNeSt  # noqa: F401
from dsl_tpu_torch.models.backbones.res2net import Res2Net  # noqa: F401
from dsl_tpu_torch.models.backbones.mobilenet_v2 import MobileNetV2  # noqa: F401
