"""Training: losses, LR schedule, optimizer and train step, checkpoints and
the trainer (counterpart of ``duodiff_tpu.training``)."""
