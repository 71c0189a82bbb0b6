"""Fully sharded data parallelism over the grid's data group (counterpart of
``fsdp_shard_params`` and ``opt_state_shardings``,
``duodiff_tpu/parallel/mesh.py:171-253``, and of the ZeRO-3 schedule GSPMD
gives them).

**The rule.** A parameter is sharded over the data group exactly when JAX's
rule shards it, judged on its shape in the JAX layout (:func:`jax_layout`:
``(in, out)`` kernels, the patch embedding a ``(p*p*C, D)`` matmul, q, k
and v in the "heads" layout ``(D, 3, H, Dh)`` under tensor parallelism):
start from its tensor-parallel dim (``convert.shard_kind``); a model group
of 1 frees that dim; the leaf has at least ``min_size`` elements; and some
dim not cut by the model group divides by the data size
(:func:`fsdp_sharded`). Such a leaf is held as a flat chunk: data rank ``d``
keeps elements ``[d n / data, (d + 1) n / data)`` of its (tensor-parallel)
tensor flattened, ``n / data`` elements, the count JAX's ``shard_shape``
gives, under its own name; the rest stay whole on every rank. AdamW's
``mu`` and ``nu``, the accumulated gradients and the EMA shadow are made
like the parameters, so they take the same chunks.

**The schedule** (ZeRO-3). The sharded leaves fall into units: each
transformer block, and the rest of the model (the embeddings, the decoder,
the early-exit heads and probes), the root. Before a unit runs, one
all-gather over the data group (:meth:`Grid.data_gather`) puts its leaves
together, each a tensor of its own, contiguous and aligned as the kernels
want; the unit's code reads them in place of its parameters. Autograd saves
no gathered weight: a saved-tensor hook keeps a note of it instead, and the
backward gathers the unit again when it first needs it. Once the unit's
backward is done, its gradients are averaged over the data group by one
reduce-scatter (:meth:`Grid.data_scatter_mean`), which leaves each rank the
gradient of its chunks. A block under ``--use_checkpoint`` runs again in the
backward anyway, and gathers again there. A frozen unit (``requires_grad``
false: ``--freeze_backbone``) is gathered and never reduce-scattered. Every
collective is synchronous on the current stream (``parallel/mesh.py``), so
none overlaps a kernel; no ``torch.distributed.fsdp`` is used, whose
prefetch streams would. The root is gathered once for the whole forward.

:func:`full_params` gathers every unit once, for sampling (the in-training
sampler, the EMA's samples): inside it the model holds its whole weights,
and the blocks pack their kernels' operands from them as a whole model does.
"""

from __future__ import annotations

from contextlib import ExitStack, contextmanager, nullcontext
from typing import Optional

import torch
from torch import nn

from duodiff_tpu_torch.utils.convert import full_shape, shard_kind

_STACKED = ("heads.", "probes.")


def jax_layout(name: str, shape, heads: int, model: int) -> tuple[tuple, Optional[int]]:
    """The JAX parameter's shape of the port's (full, unsharded) leaf
    ``name`` of ``shape``, and its dim the model group cuts (None: none).
    ``heads``: the model's attention heads; ``model``: the model group's
    size (the JAX trainer stores q, k and v in the "heads" layout when it
    is over 1)."""
    shape = tuple(shape)
    kind = shard_kind(name)
    last = name.rsplit(".", 1)[-1]
    if kind == "qkv" and model > 1:  # (D, 3, H, Dh) kernel, (3, H, Dh) bias
        if last == "weight":
            d = shape[1]
            return (d, 3, heads, d // heads), 2
        return (3, heads, shape[0] // (3 * heads)), 1
    if name.endswith("attn.proj.weight") and model > 1:  # (H, Dh, D)
        return (heads, shape[1] // heads, shape[0]), 0
    if name.endswith("patch_embed.proj.weight"):  # conv (D, C, p, p) -> dense (p*p*C, D)
        d, c, p, _ = shape
        return (p * p * c, d), None
    if any(part in name for part in _STACKED):  # the early-exit stacks: depth first
        if last in ("decoder_weight", "kv_weight", "fc1_weight"):  # (depth, out, in)
            dims = (shape[0], shape[2], shape[1])
        elif last == "conv_weight":  # (depth, out, in, k, k) -> (depth, k, k, in, out)
            dims = (shape[0], shape[3], shape[4], shape[2], shape[1])
        else:
            dims = shape
        return dims, None if kind is None else (1 if kind == "deep" else len(dims) - 1)
    if len(shape) == 2 and last == "weight" and not name.endswith("label_emb.weight"):
        dims = (shape[1], shape[0])  # a (out, in) weight -> (in, out) kernel
    elif len(shape) == 4:  # a conv (out, in, k, k) -> (k, k, in, out)
        dims = (shape[2], shape[3], shape[1], shape[0])
    else:
        dims = shape
    if kind is None:
        return dims, None
    if kind == "qkv":  # packed (D, 3D) kernel or (3D,) bias at model 1
        return dims, len(dims) - 1
    return dims, (1 if len(dims) == 2 else 0) if kind == "rows" else 0


def fsdp_sharded(jax_shape, tp_dim: Optional[int], data: int, model: int,
                 min_size: int) -> bool:
    """``fsdp_shard_params``' decision for one leaf: whether it gets the
    "data" axis."""
    numel = 1
    for n in jax_shape:
        numel *= n
    if data <= 1 or numel < min_size:
        return False
    cut = None
    if tp_dim is not None and model > 1:
        if jax_shape[tp_dim] % model:
            cut = None  # JAX's guard: a dim the model group does not divide -> replicated
        else:
            cut = tp_dim
    return any(i != cut and n % data == 0 for i, n in enumerate(jax_shape))


def plan(named_shapes: dict, heads: int, data: int, model: int, min_size: int) -> dict:
    """``{name: sharded over the data group?}`` for full (unsharded) leaves."""
    return {name: fsdp_sharded(*jax_layout(name, shape, heads, model), data, model, min_size)
            for name, shape in named_shapes.items()}


class _Gather(torch.autograd.Function):
    """Forward: a unit's chunks put together over the data group. Backward:
    the gradients of the whole leaves, each rank's chunks of their mean over
    the data group (one reduce-scatter)."""

    @staticmethod
    def forward(ctx, unit, *chunks):
        ctx.unit = unit
        return tuple(unit.gather_now(chunks))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ctx.unit.scatter(grads))


class Unit:
    """The FSDP leaves of one module (a block, or the root's rest):
    ``names`` relative to ``module``, each leaf's tensor-parallel shape in
    ``shapes``."""

    def __init__(self, module: nn.Module, names: list, shapes: list, grid, free: bool):
        self.module, self.names, self.shapes, self.grid = module, names, shapes, grid
        self.chunks = [int(torch.Size(s).numel()) // grid.data for s in shapes]
        self.offsets = [sum(self.chunks[:i]) for i in range(len(self.chunks))]
        self.width = sum(self.chunks)
        self.free = free     # keep no gathered weight for the backward (see use())
        self.whole = False   # inside full_params: the module holds the gathered weights
        self.node = None     # the _Gather node of the current forward
        self._again = None   # the weights gathered again in the backward

    def _slots(self):
        out = []
        for name in self.names:
            path, _, attr = name.rpartition(".")
            out.append((self.module.get_submodule(path) if path else self.module, attr))
        return out

    def params(self) -> list:
        return [mod._parameters[attr] for mod, attr in self._slots()]

    def gather_now(self, chunks) -> list:
        """The whole leaves from this rank's chunks: one all-gather, then
        each leaf copied out into a tensor of its own."""
        flat = torch.cat([c.reshape(-1) for c in chunks]) if len(chunks) > 1 else chunks[0]
        rows = self.grid.data_gather(flat.detach()).view(self.grid.data, self.width)
        return [rows[:, o:o + c].reshape(shape).clone()
                for o, c, shape in zip(self.offsets, self.chunks, self.shapes)]

    def scatter(self, grads) -> list:
        """This rank's chunks of the data group's mean of ``grads`` (the
        whole leaves' gradients): one reduce-scatter."""
        self._again = None
        rows = torch.empty((self.grid.data, self.width), dtype=torch.float32,
                           device=grads[0].device)
        for g, o, c in zip(grads, self.offsets, self.chunks):
            rows[:, o:o + c].copy_(g.reshape(self.grid.data, c))
        flat = self.grid.data_scatter_mean(rows.view(-1))
        return [flat[o:o + c] for o, c in zip(self.offsets, self.chunks)]

    def gather(self) -> list:
        self.node = None
        params = self.params()
        if torch.is_grad_enabled() and any(p.requires_grad for p in params):
            out = _Gather.apply(self, *params)
            self.node = out[0].grad_fn
            return list(out)
        with torch.no_grad():
            return self.gather_now(params)

    # --- the saved-tensor hooks: a note in place of a gathered weight ------

    def _note(self, t: torch.Tensor, gathered: list):
        """(index, dtype) when ``t`` is gathered leaf ``index`` or a cast of
        it, else None."""
        for i, g in enumerate(gathered):
            if (t.data_ptr() == g.data_ptr() and t.dtype == g.dtype and t.shape == g.shape
                    and t.stride() == g.stride()):
                return i, None
        fn = t.grad_fn
        if (fn is not None and type(fn).__name__ == "ToCopyBackward0"
                and fn.next_functions and fn.next_functions[0][0] is self.node
                and self.node is not None):
            return fn.next_functions[0][1], t.dtype
        return None

    def _hooks(self, gathered: list):
        def pack(t):
            base = t if t._base is None else t._base
            note = self._note(base, gathered)
            if note is None:
                return t
            return note, t.shape, t.stride(), t.storage_offset() - base.storage_offset()

        def unpack(saved):
            if isinstance(saved, torch.Tensor):
                return saved
            (i, dtype), shape, stride, offset = saved
            if self._again is None:
                with torch.no_grad():
                    self._again = self.gather_now(self.params())
            w = self._again[i] if dtype is None else self._again[i].to(dtype)
            return w.as_strided(shape, stride, w.storage_offset() + offset)

        return torch.autograd.graph.saved_tensors_hooks(pack, unpack)

    @contextmanager
    def use(self):
        """The module with its leaves gathered in place of its chunks, for
        one forward; the chunks are put back after it."""
        slots, params = self._slots(), self.params()
        self._again = None
        gathered = self.gather()
        for (mod, attr), g in zip(slots, gathered):
            mod._parameters[attr] = g
        hooks = self._hooks(gathered) if self.free and self.node is not None else nullcontext()
        try:
            with hooks:
                yield
        finally:
            for (mod, attr), p in zip(slots, params):
                mod._parameters[attr] = p


class FSDP:
    """The FSDP state of a model: the root's units (its trained and its
    frozen leaves), the blocks' units, and the shape of each sharded leaf
    (``shapes``: what ``convert.gather_state_dict`` takes)."""

    def __init__(self, roots: list, units: list, shapes: dict):
        self.roots, self.units, self.shapes = roots, units, shapes

    @property
    def names(self) -> frozenset:
        return frozenset(self.shapes)


def shard_model(model: nn.Module, grid, min_size: int, heads: int) -> Optional[FSDP]:
    """Cut ``model``'s leaves (its tensor-parallel shards already, full
    weights loaded) into this data rank's chunks by :func:`plan`, in place,
    and attach the units; ``model.fsdp`` is the state, or None when the data
    group is 1 (nothing is sharded, as JAX's rule shards nothing then)."""
    from duodiff_tpu_torch.models.layers import Block

    model.fsdp = None
    if grid.data <= 1:
        return None
    full = {}
    for name, p in model.named_parameters():
        kind = shard_kind(name) if grid.model > 1 else None
        full[name] = tuple(p.shape) if kind is None else full_shape(kind, p.shape, grid.model)
    sharded = plan(full, heads, grid.data, grid.model, min_size)
    shapes = {}
    for name, p in list(model.named_parameters()):
        if not sharded[name]:
            continue
        path, _, attr = name.rpartition(".")
        mod = model.get_submodule(path) if path else model
        shapes[name] = tuple(p.shape)
        chunk = p.detach().reshape(grid.data, -1)[grid.data_rank].clone()
        setattr(mod, attr, nn.Parameter(chunk, requires_grad=p.requires_grad))
    free = not getattr(model, "use_checkpoint", False) and not getattr(
        getattr(model, "uvit", None), "use_checkpoint", False)
    units, taken = [], set()
    for prefix, mod in model.named_modules():
        if not isinstance(mod, Block):
            continue
        names = [n for n in shapes if n.startswith(prefix + ".")]
        taken.update(names)
        unit = Unit(mod, [n[len(prefix) + 1:] for n in names], [shapes[n] for n in names],
                    grid, free) if names else None
        mod.fsdp_unit = unit
        if unit is not None:
            units.append(unit)
    # the rest, the root, in two units where some of it is frozen: a frozen
    # leaf's gradient is never reduce-scattered
    rest = [n for n in shapes if n not in taken]
    trained = {n: model.get_parameter(n).requires_grad for n in rest}
    roots = [Unit(model, names, [shapes[n] for n in names], grid, True)
             for names in ([n for n in rest if trained[n]], [n for n in rest if not trained[n]])
             if names]
    model.fsdp = FSDP(roots, units, shapes)
    return model.fsdp


@contextmanager
def root(model: nn.Module):
    """The context of a model's whole forward: its root units gathered (a
    no-op without FSDP or inside :func:`full_params`)."""
    state = getattr(model, "fsdp", None)
    with ExitStack() as stack:
        for unit in () if state is None else state.roots:
            if not unit.whole:
                stack.enter_context(unit.use())
        yield


@contextmanager
def full_params(model: nn.Module):
    """Every unit of an FSDP model gathered once, no gradient, for sampling;
    the blocks' packed operands are dropped when it ends. A no-op without
    FSDP."""
    state = getattr(model, "fsdp", None)
    if state is None:
        yield
        return
    units = [*state.roots, *state.units]
    saved = []
    try:
        with torch.no_grad():
            for u in units:
                slots, params = u._slots(), u.params()
                for (mod, attr), g in zip(slots, u.gather_now(params)):
                    mod._parameters[attr] = g
                u.whole = True
                saved.append((u, slots, params))
        yield
    finally:
        for u, slots, params in saved:
            for (mod, attr), p in zip(slots, params):
                mod._parameters[attr] = p
            u.whole = False
            if u in state.units:
                u.module._packed = None
