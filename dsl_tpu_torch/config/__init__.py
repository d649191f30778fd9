from dsl_tpu_torch.config.config import Config, ConfigDict

__all__ = ["Config", "ConfigDict"]
