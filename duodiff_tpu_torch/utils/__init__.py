"""Weight conversion and model loading (counterpart of ``duodiff_tpu.utils``)."""
