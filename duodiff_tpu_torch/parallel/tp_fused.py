"""Tensor-parallel fused sublayers over a model group (counterpart of
``duodiff_tpu/parallel/tp_fused.py``), and the differentiable collectives
of every tensor-parallel shard (:func:`replicated`, :func:`sum_over_shards`,
:func:`gather_shards`), which the unfused block, the time embedding and the
early-exit heads and probes use too (Megatron's f and g).

Each rank of a model group holds its shard of a block: the q, k and v
columns of H / mp whole heads (A = D / mp) and the matching proj rows, and
hidden / mp columns of fc1 with the matching fc2 rows
(:func:`duodiff_tpu_torch.utils.convert.shard_state_dict`). It runs the shard
forms of the fused kernels on them (``residual=False``: K1 and K2 forward,
K6 and K7 backward), and the model group sums the partials, one all-reduce
a sublayer forward:

    y = (x.f32 + sum_shards(partial).f32 + bias.f32).to(x.dtype),

the partial rounded to the activation dtype before the sum, as
``tp_fused.py:110-113`` and ``:151-154``. The kernel gets a zero bias, as
there. x, the LayerNorm parameters and the output bias are replicated, so in
the backward the shards' dx partials and LayerNorm gradients are summed over
the model group (what ``shard_map`` does for the ``P(None)`` inputs) before
``+ dy``: one all-reduce of dx and one of the (2, D) LayerNorm gradients a
sublayer. The sum runs in the collective's order, not JAX's psum order.
Every all-reduce is synchronous on the current stream: none overlaps a
backward kernel (``parallel/mesh.py``). On a CPU tensor the kernels'
wrappers run their plain PyTorch versions, as everywhere in the port.
"""

from __future__ import annotations

import torch

from duodiff_tpu_torch.ops.block import (
    FusedAttnSublayerFn,
    FusedMlpSublayerFn,
    fused_attn_sublayer,
    fused_mlp_sublayer,
)


class _SumOverShards(torch.autograd.Function):
    """Forward: the partials summed over the model group. Backward: the
    output's gradient is every shard's partial's."""

    @staticmethod
    def forward(ctx, partial, grid):
        return grid.model_sum(partial)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _Replicated(torch.autograd.Function):
    """Forward: the replicated input as it is. Backward: the shards'
    gradients of it summed over the model group."""

    @staticmethod
    def forward(ctx, t, grid):
        ctx.grid = grid
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.grid.model_sum(g.contiguous()), None


class _GatherShards(torch.autograd.Function):
    """Forward: the model group's shards side by side on ``dim``. Backward:
    the gradient of the whole, summed over the model group (the shards'
    consumers each give a part), this rank's slice of it."""

    @staticmethod
    def forward(ctx, t, grid, dim):
        ctx.grid, ctx.dim, ctx.n = grid, dim, t.shape[dim]
        return grid.model_gather(t, dim)

    @staticmethod
    def backward(ctx, g):
        g = ctx.grid.model_sum(g.contiguous())
        return g.narrow(ctx.dim, ctx.grid.model_rank * ctx.n, ctx.n), None, None


def replicated(t: torch.Tensor, grid) -> torch.Tensor:
    """``t``, a tensor every rank of the model group holds whole, as the
    input of shard-local work: its gradient is summed over the model group."""
    return _Replicated.apply(t, grid)


def sum_over_shards(partial: torch.Tensor, grid) -> torch.Tensor:
    """The shards' partials summed over the model group, whose gradient each
    partial takes whole."""
    return _SumOverShards.apply(partial, grid)


def gather_shards(t: torch.Tensor, grid, dim: int) -> torch.Tensor:
    """The model group's shards ``t`` put together on ``dim`` (one
    all-gather), as the input of shard-local work that reads the whole
    (its gradient is summed over the model group, then sliced)."""
    return _GatherShards.apply(t, grid, dim)


def _finish(x, total, bias):
    """x + the summed partials + the bias, in fp32, rounded once."""
    return (x.float() + total.float() + bias.float()).to(x.dtype)


def tp_attn_sublayer(x, ops, bias, *, num_heads: int, grid, eps: float = 1e-5):
    """The attention sublayer on the packed shard operands ``ops`` (those of
    ``ops.block.pack_attn`` with a zero ``bp``), ``num_heads`` local heads;
    ``bias`` the real proj bias. No gradient."""
    partial = fused_attn_sublayer(x, *ops, num_heads=num_heads, eps=eps, residual=False)
    return _finish(x, grid.model_sum_(partial), bias)


def tp_mlp_sublayer(x, ops, bias, *, gelu_approx: bool, grid, eps: float = 1e-5):
    """The MLP sublayer on the packed shard operands ``ops`` (those of
    ``ops.block.pack_mlp`` with a zero ``b2``); ``bias`` the real fc2 bias.
    No gradient."""
    partial = fused_mlp_sublayer(x, *ops, gelu_approx=gelu_approx, eps=eps, residual=False)
    return _finish(x, grid.model_sum_(partial), bias)


def tp_attn_sublayer_train(x, ln_w, ln_b, qkv_w, qkv_b, proj_w, proj_b, *, num_heads: int, grid,
                           eps: float = 1e-5):
    """The attention sublayer on the live shard parameters, differentiable:
    K1's shard form forward and K6's backward."""
    xr = _Replicated.apply(x, grid)
    ln = _Replicated.apply(torch.stack([ln_w, ln_b]), grid)
    zero = torch.zeros_like(proj_b)
    partial = FusedAttnSublayerFn.apply(xr, ln[0], ln[1], qkv_w, qkv_b, proj_w, zero,
                                        num_heads, eps, False)
    return _finish(x, _SumOverShards.apply(partial, grid), proj_b)


def tp_mlp_sublayer_train(x, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, *, gelu_approx: bool, grid,
                          eps: float = 1e-5):
    """The MLP sublayer on the live shard parameters, differentiable: K2's
    shard form forward and K7's backward (K7 whatever
    ``DUODIFF_MLP_BWD_SPLIT`` says: K8 is square only)."""
    xr = _Replicated.apply(x, grid)
    ln = _Replicated.apply(torch.stack([ln_w, ln_b]), grid)
    zero = torch.zeros_like(fc2_b)
    partial = FusedMlpSublayerFn.apply(xr, ln[0], ln[1], fc1_w, fc1_b, fc2_w, zero,
                                       gelu_approx, eps, False)
    return _finish(x, _SumOverShards.apply(partial, grid), fc2_b)
