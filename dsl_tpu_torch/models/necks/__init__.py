from dsl_tpu_torch.models.necks.fpn import FPN  # noqa: F401
