"""U-ViT model (counterpart of ``duodiff_tpu.models``)."""
