"""divergen_tpu_torch — the PyTorch/CUDA port of divergen_tpu for NVIDIA H100.

The JAX package ``divergen_tpu`` stays beside it as the reference. The port
mirrors its layout; every TPU Pallas kernel on a ported path becomes a
hand-written CUDA kernel under ``csrc/``, with its plain torch version in the
same module (used for CPU tensors). This package imports torch, never jax,
and nothing of ``divergen_tpu``: it keeps its own copy of what it needs.
"""

__version__ = "0.1.0"
