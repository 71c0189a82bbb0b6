"""Static-scale calibration of the int8 MLP sublayers (counterpart of
``duodiff_tpu/utils/int8_calib.py``).

The W8A8 kernels quantize activations per row. Static scales for the MLP
sublayer's two quant sites (post-LayerNorm, post-GELU) replace the row
maxima and the row dequant. Calibration runs one reverse DDPM trajectory
through the model's calibration forward (:meth:`UViT.forward_calib`: the
dynamic-int8 block that also returns its MLP activation amaxes) and keeps,
per block and site, the running max of the amax and each step's quantile
curve of the per-row amaxes at :data:`CALIB_FRACTIONS`. Both stay on the
device until the trajectory ends. :func:`scales_from_stats` turns them into
per-block scales, which :func:`save_int8_scales` writes in the JSON layout
that ``utils/int8_scales.py`` and the JAX package read.
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from duodiff_tpu_torch.diffusion.sampling import ddpm_loop

# Quantile fractions at which each step's row-amax distribution is kept
# (dense in the tail, where a clip scale lives); the union over the steps is
# rebuilt from these curves (_union_percentile).
CALIB_FRACTIONS = tuple(
    [i / 19 * 0.95 for i in range(20)]
    + [0.97, 0.98, 0.99, 0.995, 0.998, 0.999, 0.9995, 0.9999, 1.0]
)

# torch.quantile refuses inputs of more elements than this
_QUANTILE_MAX_ELEMENTS = 2**24


def _union_percentile(quants, fractions, p: float) -> float:
    """Percentile ``p`` (in [0, 100]) of the union (equal-weight mixture over
    steps) of per-step row-amax distributions, each given by its quantile
    curve ``quants[s]`` at ``fractions``."""
    q = np.asarray(quants, np.float64)  # (S, Q), rows nondecreasing
    f = np.asarray(fractions, np.float64)
    cand = np.unique(q.reshape(-1))
    cdf = np.zeros_like(cand)
    for row in q:
        cdf += np.interp(cand, row, f, left=0.0, right=1.0)
    cdf /= q.shape[0]
    idx = int(np.searchsorted(cdf, p / 100.0, side="left"))
    return float(cand[min(idx, len(cand) - 1)])


def _row_quantiles(rows: torch.Tensor, fractions: torch.Tensor) -> torch.Tensor:
    """(R, N) -> (R, Q): each row's quantiles at ``fractions`` with linear
    interpolation (``jnp.quantile``'s default), in calls of at most 2**24
    elements. These are the steps of ``torch.quantile(rows, fractions,
    dim=-1).t()``, to the bit, less its check that the fractions lie in [0,
    1], which reads a CPU tensor's value on the host: this runs inside a
    step body. A row holding a NaN gives NaN, as there."""
    n = rows.shape[-1]
    if n > _QUANTILE_MAX_ELEMENTS:
        raise ValueError(f"a row of {n} amaxes is more than torch.quantile takes "
                         f"({_QUANTILE_MAX_ELEMENTS}): calibrate at a smaller batch")
    per_call = _QUANTILE_MAX_ELEMENTS // n
    out = []
    for i in range(0, rows.shape[0], per_call):
        ordered = torch.sort(rows[i:i + per_call], dim=-1).values
        ranks = torch.broadcast_tensors(fractions * (n - 1),
                                        ordered.isnan().any(-1, keepdim=True))
        ranks = ranks[0].masked_fill(ranks[1], n - 1)
        below = ranks.to(torch.long)
        weights = ranks - below
        low = ordered.gather(-1, below)
        out.append(low.lerp_(ordered.gather(-1, ranks.ceil_().to(torch.long)), weights))
    return torch.cat(out)


def calibrate_int8_stats(
    model,
    schedule,
    generator: Optional[torch.Generator],
    shape: Sequence[int],
    *,
    parametrization: str = "predict_noise",
    y: Optional[torch.Tensor] = None,
    x_init: Optional[torch.Tensor] = None,
    noise_table: Optional[torch.Tensor] = None,
    graphs=True,
):
    """One reverse DDPM trajectory, t = T-1 .. 0, through
    ``model.forward_calib`` (an int8 UViT without static scales, packed, or
    an EarlyExitUViT around one, which steps on its backbone).
    Returns ``(amax, quants)``:

        amax:   {block name: (2,) np.float32}, the largest amax of each site
        quants: {block name: (steps, 2, Q) np.float32}, per step the quantile
                curve of the site's per-row amaxes at CALIB_FRACTIONS

    The start noise and each step's noise come from ``generator`` unless
    ``x_init`` / ``noise_table`` (as :func:`ddpm_loop` takes it) give them.
    Nothing is read from the device before the trajectory ends: each step
    is :func:`ddpm_loop`'s body and the statistics are its aux rows.
    ``graphs`` is :func:`ddpm_loop`'s: on the card by default the step is a
    CUDA graph, replayed (the JAX package's one jitted scan)."""
    names = model.block_names()
    if x_init is None:
        x_init = torch.randn(tuple(shape), generator=generator, device=generator.device,
                             dtype=torch.float32)
    fractions = torch.tensor(CALIB_FRACTIONS, dtype=torch.float32, device=x_init.device)

    def apply(x, t_batch, y):
        out, stats = model.forward_calib(x, t_batch, y)
        amax = torch.stack([stats[n][0] for n in names])           # (blocks, 2)
        rows = torch.stack([stats[n][1] for n in names])           # (blocks, 2, B*L)
        curves = _row_quantiles(rows.reshape(-1, rows.shape[-1]), fractions)
        return out, (amax, curves.reshape(len(names), 2, -1))

    _, (amax_rows, curves) = ddpm_loop(
        apply, schedule, parametrization, x_init, generator,
        range(schedule.steps - 1, -1, -1), y, noise_table=noise_table,
        aux_fn=lambda out: out, graphs=graphs,
    )
    amax = amax_rows.amax(0).cpu().numpy()
    curves = curves.cpu().numpy()
    return ({n: amax[i] for i, n in enumerate(names)},
            {n: curves[:, i] for i, n in enumerate(names)})


def scales_from_stats(
    amax: Dict[str, np.ndarray],
    quants: Dict[str, np.ndarray],
    *,
    mode: str = "amax",
    percentile: float = 99.9,
    margin: float = 1.0,
) -> Dict[str, Tuple[float, float]]:
    """Per-block static scales from the trajectory's statistics.

    mode="amax":       the largest amax * margin (one hot row sets it);
    mode="percentile": the ``percentile``-th percentile of the union of the
                       per-row amaxes over all steps, * margin, never above
                       the amax. Rows above it saturate (the kernels clip).
    """
    if mode == "amax":
        return {k: (float(v[0]) * margin, float(v[1]) * margin) for k, v in amax.items()}
    if mode != "percentile":
        raise ValueError(f"unknown calibration mode {mode!r}")
    out = {}
    for k, q in quants.items():
        sx = _union_percentile(q[:, 0, :], CALIB_FRACTIONS, percentile)
        sh = _union_percentile(q[:, 1, :], CALIB_FRACTIONS, percentile)
        out[k] = (min(sx * margin, float(amax[k][0])), min(sh * margin, float(amax[k][1])))
    return out


def calibrate_int8_mlp_scales(model, schedule, generator, shape, *,
                              margin: float = 1.0, mode: str = "amax",
                              percentile: float = 99.9,
                              **trajectory) -> Dict[str, Tuple[float, float]]:
    """:func:`calibrate_int8_stats` (``trajectory`` holds its keyword
    arguments) then :func:`scales_from_stats`."""
    amax, quants = calibrate_int8_stats(model, schedule, generator, shape, **trajectory)
    return scales_from_stats(amax, quants, mode=mode, percentile=percentile, margin=margin)


def save_int8_scales(path, scales: Dict[str, Tuple[float, float]],
                     meta: Optional[dict] = None) -> None:
    """Write ``{"blocks": {name: [sx, sh]}, "meta": {...}}``."""
    with open(path, "w") as f:
        json.dump({"blocks": {k: list(v) for k, v in scales.items()}, "meta": meta or {}},
                  f, indent=2, sort_keys=True)
