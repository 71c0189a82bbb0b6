"""duodiff_tpu_torch — the PyTorch / CUDA port of ``duodiff_tpu`` for one
NVIDIA H100.

The JAX package ``duodiff_tpu`` stays the reference; every module here keeps
its counterpart's name and public layout (NHWC images, (B, L, D) tokens, the
reference's state-dict names) so the two can be held against each other on
the same weights and inputs. The two Pallas sublayer kernels of the sampling
path are hand-written CUDA kernels for Hopper (``csrc/``), built with
``nvcc`` on first use; everything the JAX package leaves to XLA is plain
PyTorch. Nothing in this package imports ``jax``.
"""

__version__ = "0.1.0"
