"""PyTorch/CUDA port of s2p_tpu for NVIDIA Hopper (H100).

``s2p_tpu`` (JAX) stays the reference; this package imports nothing of it
and nothing of JAX. Hand-written CUDA kernels live in ``csrc/`` and build
at first use.
"""

__version__ = "0.1.0"
