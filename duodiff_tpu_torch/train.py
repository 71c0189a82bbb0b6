"""Training CLI (counterpart of the repository's ``main.py``, with its flag
names, plus ``--device``).

    python -m duodiff_tpu_torch.train --config_path configs/uvit_cifar10.yaml \\
        --dataset cifar10 --data_path data --n_steps 200 --batch_size 128 \\
        --use_amp --num_warmup_steps 20 --log_path logs --exp_name run \\
        --device cuda

``--config_path`` overlays the file's ``model_params`` on the flags.
``--attn_impl`` picks the block: ``fused`` (K1/K2 forward and K6/K7
backward kernels, bf16 under ``--use_amp``; default on CUDA), ``plain``
(autograd through the plain PyTorch sublayers; default on the CPU),
``pallas`` (the unfused block around the attention kernels K9 forward and
K10 backward, bf16 on CUDA) or ``xla`` (the unfused block around plain
attention). ``--dataset imagenet64`` (and ``celeba``, ``imagenet256``) reads
the decoded-image cache under ``<data_path>/_duodiff_cache``
(``data/synthetic.py`` writes a synthetic one); a config with an
``autoencoder`` block (latent ImageNet-256) encodes every batch with that
frozen autoencoder before the step. ``--label_dropout P`` trains for
classifier-free guidance.
``--grad_accum K`` averages the gradients of K data steps into one optimizer
update (``--n_steps`` must be a multiple of K; warm-up and the schedule count
updates), ``--skip_nonfinite N`` drops an update whose gradients are not
finite until more than N in a row were, and ``--use_checkpoint`` recomputes
each block in the backward instead of keeping its activations. With
``--attn_impl fused`` the environment variable ``DUODIFF_MLP_BWD_SPLIT=1``
takes the split MLP backward kernel K8 in place of K7, whose scratch
``DUODIFF_MLP_BWD_SPLIT_CFG=<splits>`` bounds (row chunks on the card).
``--log_every_n_steps N`` samples ``--n_samples`` images every N steps and
at the last (per-step statistics as ``.npy`` and the grid as a PNG in the
run's folder), ``--profile`` traces steps 3 to 8 of the run with
``torch.profiler`` into ``<log_path>/<exp_name>/profile``, and
``--async_checkpoint`` writes checkpoints in a background thread.

Data and tensor parallelism run under ``python -m torch.distributed.run``:

    python -m torch.distributed.run --standalone --nproc_per_node 4 \
        -m duodiff_tpu_torch.train --model_parallel 2 ...

forms a (data 2, model 2) grid (``parallel/mesh.py``); ``--multihost`` lets
the grid span nodes (``--nnodes``), the model groups staying on one node.
Without the torchrun environment the run is one process, as it always was.
``--fsdp`` cuts every leaf of at least ``--fsdp_min_size`` elements over the
data group, by the JAX trainer's rule (``parallel/fsdp.py``), with AdamW's
moments and the EMA; it composes with ``--model_parallel`` and shards
nothing (and says so) when the data group is 1. The unfused block
(``--attn_impl pallas`` / ``xla``) runs under ``--model_parallel`` too.
On one process on a CUDA device every kind of train step (and a latent
config's encode) replays a CUDA graph after its eager warm-up and its
capture; the run prints its route (``train step graphs: on``). On the CPU,
on a process grid (data or tensor parallelism, ``--fsdp``: their
collectives go through the host over gloo) and with ``main(argv,
graphs=False)`` (a library caller's comparison, no flag) the steps run
eagerly. A failed capture raises.
Checkpoints land in ``<log_path>/<exp_name>/<save_name>_last/checkpoint.pth``;
``python -m duodiff_tpu_torch.sample --checkpoint_path`` (``eesample`` for an
early-exit model) loads that file.
"""

from __future__ import annotations

import argparse

from duodiff_tpu_torch.config import merge_args_with_config
from duodiff_tpu_torch.utils.train_utils import get_exp_name


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Training parameters")
    # Training
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--n_steps", type=int, required=True)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--num_timesteps", type=int, default=1000)
    p.add_argument("--use_amp", action="store_true", default=False,
                   help="bf16 compute (no grad scaler needed)")
    p.add_argument("--amp_dtype", type=str, default="bfloat16")
    p.add_argument("--attn_impl", type=str, default=None,
                   choices=["auto", "xla", "pallas", "fused", "plain"],
                   help="Block: fused sublayer kernels, their plain PyTorch versions, or "
                        "the unfused block around the attention kernels (pallas) or plain "
                        "attention (xla) (default, and auto: fused on CUDA, plain on the CPU)")
    p.add_argument("--label_dropout", type=float, default=0.0,
                   help="Classifier-free-guidance training: replace this fraction of the "
                        "labels by the null label (num_classes - 1)")
    p.add_argument("--gelu", type=str, default="exact", choices=["exact", "tanh"])
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--use_checkpoint", action="store_true", default=False,
                   help="Recompute each block in the backward (activation checkpointing)")
    # Logging
    p.add_argument("--log_path", type=str, default="logs")
    p.add_argument("--exp_name", type=str, default=None)
    p.add_argument("--log_every_n_steps", type=int, default=None)
    p.add_argument("--n_samples", type=int, default=16)
    p.add_argument("--sample_height", type=int, default=32)
    p.add_argument("--sample_width", type=int, default=32)
    p.add_argument("--sample_seed", type=int, default=42)
    # Checkpointing
    p.add_argument("--load_checkpoint_path", type=str, default=None)
    p.add_argument("--load_backbone", type=str, default=None)
    p.add_argument("--freeze_backbone", action="store_true")
    p.add_argument("--normalize_timesteps", action="store_true")
    p.add_argument("--use_unweighted_loss", action="store_true",
                   help="deediff_uvit: add the heads' unweighted loss term to the total")
    p.add_argument("--parametrization", type=str, default="predict_noise",
                   choices=["predict_noise", "predict_original", "predict_previous"])
    p.add_argument("--save_checkpoint_path", type=str, default=None)
    p.add_argument("--save_every_n_steps", type=int, default=None)
    p.add_argument("--save_new_every_n_steps", type=int, default=None)
    p.add_argument("--async_checkpoint", action="store_true", default=False)
    p.add_argument("--resume", action="store_true", default=False)
    # Optimizer
    p.add_argument("--distill_config", type=str, default=None,
                   help="Teacher model config: distil the student from its outputs")
    p.add_argument("--distill_from", type=str, default=None,
                   help="Teacher checkpoint (.pth); random teacher if omitted")
    p.add_argument("--distill_alpha", type=float, default=1.0)
    p.add_argument("--distill_t_min", type=int, default=0)
    p.add_argument("--ema_decay", type=float, default=0.0)
    p.add_argument("--optimizer", type=str, default="adamw", choices=["adamw"])
    p.add_argument("--lr", type=float, default=0.0002)
    p.add_argument("--weight_decay", type=float, default=0.03)
    p.add_argument("--beta1", type=float, default=0.99)
    p.add_argument("--beta2", type=float, default=0.999)
    p.add_argument("--grad_accum", type=int, default=1,
                   help="Average the gradients of this many data steps into one update")
    p.add_argument("--skip_nonfinite", type=int, default=0,
                   help="Skip an update with non-finite gradients, up to this many in a row")
    # LR scheduler
    p.add_argument("--num_warmup_steps", type=int, default=1500)
    # Model
    p.add_argument("--config_path", type=str, default=None,
                   help="Config file; its model_params overwrite the flags")
    p.add_argument("--model", type=str, default="uvit", choices=["uvit", "deediff_uvit"])
    p.add_argument("--classifier_type", type=str, default="attention_probe",
                   choices=["attention_probe", "mlp_probe_per_layer", "mlp_probe_per_timestep",
                            "mlp_probe_per_layer_per_timestep"])
    p.add_argument("--img_size", type=int, default=32)
    p.add_argument("--patch_size", type=int, default=2)
    p.add_argument("--in_chans", type=int, default=3)
    p.add_argument("--embed_dim", type=int, default=512)
    p.add_argument("--depth", type=int, default=13)
    p.add_argument("--num_heads", type=int, default=8)
    p.add_argument("--mlp_ratio", type=int, default=4)
    p.add_argument("--qkv_bias", action="store_true", default=False)
    p.add_argument("--mlp_time_embed", action="store_true", default=False)
    p.add_argument("--num_classes", type=int, default=-1)
    p.add_argument("--profile", action="store_true", default=False)
    # Dataset
    p.add_argument("--dataset", type=str, default="cifar10",
                   choices=["cifar10", "celeba", "imagenet64", "imagenet256"])
    p.add_argument("--data_path", type=str, default="data")
    p.add_argument("--cache_data", action="store_true", default=False,
                   help="Accepted; CIFAR-10 lives in memory, celeba, imagenet64 and "
                        "imagenet256 are read from their caches only")
    # Parallelism
    p.add_argument("--model_parallel", type=int, default=1,
                   help="Tensor-parallel degree: shard the heads and the MLP hidden columns "
                        "over groups of this many ranks (under torch.distributed.run)")
    p.add_argument("--fsdp", action="store_true", default=False,
                   help="Cut the large parameters, AdamW's moments and the EMA over the data "
                        "ranks (ZeRO-3: gathered around each block, gradients "
                        "reduce-scattered)")
    p.add_argument("--fsdp_min_size", type=int, default=16384,
                   help="--fsdp leaves a parameter of fewer elements whole on every rank")
    p.add_argument("--multihost", action="store_true", default=False,
                   help="Let the torch.distributed.run grid span nodes")
    # Device
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None, *, graphs: bool = True):
    """Run the CLI; returns the Trainer, its logged metrics in ``.logs``.
    ``graphs=False`` runs the train steps eagerly on a CUDA device too."""
    args = get_args(argv)
    if args.exp_name is None:
        args.exp_name = get_exp_name(args)
    if args.config_path is not None:
        merge_args_with_config(args, args.config_path)
    from duodiff_tpu_torch.training.trainer import Trainer

    from duodiff_tpu_torch.parallel.mesh import close

    trainer = Trainer(args, graphs=graphs)
    try:
        trainer.train()
    finally:
        close(trainer.grid)
    return trainer


if __name__ == "__main__":
    main()
