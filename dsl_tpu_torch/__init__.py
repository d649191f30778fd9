"""PyTorch/CUDA port of ``dsl_tpu`` for NVIDIA Hopper (H100).

A package of its own beside the JAX one: it imports ``torch`` and never
``jax``, ``flax`` or ``dsl_tpu``. Module names mirror ``dsl_tpu``'s so each
counterpart is easy to find. Entry points run on CUDA unless the caller
passes ``device="cpu"``.
"""

__version__ = "0.1.0"
