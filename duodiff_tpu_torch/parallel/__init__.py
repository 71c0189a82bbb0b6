"""Data and tensor parallelism and FSDP over ``torch.distributed``
(counterpart of ``duodiff_tpu/parallel``): the process grid (:mod:`.mesh`),
the tensor-parallel fused sublayers and the differentiable collectives of
every shard (:mod:`.tp_fused`), and the sharding of large leaves over the
data group (:mod:`.fsdp`)."""

from duodiff_tpu_torch.parallel.mesh import (
    Grid,
    close,
    env_spec,
    pipeline_grid,
    sampling_grid,
    training_grid,
)

__all__ = ["Grid", "close", "env_spec", "pipeline_grid", "sampling_grid", "training_grid"]
