"""The port's command-line tools: ``python -m dsl_tpu_torch.tools.train``
and ``python -m dsl_tpu_torch.tools.test``."""
