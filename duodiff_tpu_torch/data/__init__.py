"""Data: index sampler, loader and dataset readers (counterpart of
``duodiff_tpu.data``)."""
