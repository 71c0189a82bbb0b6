"""Data and tensor parallelism over ``torch.distributed`` (counterpart of
``duodiff_tpu/parallel``): the process grid (:mod:`.mesh`) and the
tensor-parallel fused sublayers (:mod:`.tp_fused`)."""

from duodiff_tpu_torch.parallel.mesh import (
    Grid,
    close,
    env_spec,
    pipeline_grid,
    sampling_grid,
    training_grid,
)

__all__ = ["Grid", "close", "env_spec", "pipeline_grid", "sampling_grid", "training_grid"]
