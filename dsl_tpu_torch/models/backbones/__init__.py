from dsl_tpu_torch.models.backbones.resnet import ResNet  # noqa: F401
from dsl_tpu_torch.models.backbones.rla_resnet import RLAResNet  # noqa: F401
