from dsl_tpu_torch.models.backbones.rla_resnet import RLAResNet  # noqa: F401
