"""Sublayer kernels and their plain PyTorch versions
(counterpart of ``duodiff_tpu.ops``)."""
