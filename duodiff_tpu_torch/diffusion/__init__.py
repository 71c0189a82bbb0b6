"""Noise schedule and samplers (counterpart of ``duodiff_tpu.diffusion``)."""
