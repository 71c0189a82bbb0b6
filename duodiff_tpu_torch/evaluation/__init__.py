"""FID and the weight-free quality metrics (counterpart of
``duodiff_tpu/evaluation``)."""
