"""Cross-layer probe calibration for adaptive early exit (counterpart of
``duodiff_tpu/diffusion/calibration.py``).

Each per-layer probe is trained on its own, so raw probe values are not
comparable across layers. :func:`collect_probe_stats` runs one dense
trajectory driven by the backbone and logs, step by step, each probe's
batch mean beside its head's realized error against the backbone,
``mean((g_i - backbone)^2)``; :func:`fit_probe_calibration` fits an affine
map from the one onto the other, slot by slot; :func:`apply_probe_calibration`
applies it, clamped to the ranges the fit saw. The JSON file
(:func:`save_probe_calibration`) is the JAX package's, so either package
reads the other's.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from duodiff_tpu_torch.diffusion.sampling import _initial_noise, ddpm_loop
from duodiff_tpu_torch.diffusion.schedule import NoiseSchedule


def collect_probe_stats(apply_fn: Callable, schedule: NoiseSchedule,
                        generator: Optional[torch.Generator], shape: Sequence[int] = None,
                        y: Optional[torch.Tensor] = None, x_init: Optional[torch.Tensor] = None,
                        noise_table: Optional[torch.Tensor] = None, graphs=True):
    """One dense early-exit trajectory over t = T-1 .. 0, driven by the
    backbone output (the dense path, threshold -inf), logging for each step
    ``u_rows[t, i] = mean(u_i)`` and ``e_rows[t, i] = mean((g_i -
    backbone)^2)``. ``apply_fn(x, t_batch, y) -> (backbone, u, g)``; noise
    from ``generator`` or row t of ``noise_table``. Returns ``(u_rows,
    e_rows)``, (steps, depth) float32 numpy, row t = timestep t.

    The JAX package's one ``lax.scan``: each step is :func:`ddpm_loop`'s
    body (t read from the device table, x written in place), the two rows
    its aux rows on the device, read once after the last step; ``graphs``
    is :func:`ddpm_loop`'s (a CUDA graph on the card by default)."""

    def rows(out):
        backbone, u, g = out
        err = g.float() - backbone.float()[None]
        return backbone, (u.float().mean(1), (err * err).mean(dim=tuple(range(1, err.ndim))))

    x = _initial_noise(x_init, shape, generator)
    _, (u_rows, e_rows) = ddpm_loop(apply_fn, schedule, "predict_noise", x, generator,
                                    range(schedule.steps - 1, -1, -1), y,
                                    noise_table=noise_table, aux_fn=rows, graphs=graphs)
    return u_rows.flip(0).cpu().numpy(), e_rows.flip(0).cpu().numpy()


def fit_probe_calibration(u_rows, e_rows, *, min_rel_var: float = 1e-12) -> dict:
    """Per slot the least-squares affine ``e ~= a * u + b``, the slope clamped
    to >= 0; a slot with no probe variance or no positive slope falls back
    to ``a = 0, b = mean(e)``. Returns ``{"a", "b", "r", "mean_error",
    "u_min", "u_max", "e_min", "e_max"}``, one entry a slot (``r`` the
    Pearson correlation, the rest the ranges the fit saw)."""
    u = np.asarray(u_rows, np.float64)
    e = np.asarray(e_rows, np.float64)
    if u.shape != e.shape or u.ndim != 2:
        raise ValueError(f"shape mismatch: u {u.shape} vs e {e.shape}")
    a_out, b_out, r_out = [], [], []
    for i in range(u.shape[1]):
        ui, ei = u[:, i], e[:, i]
        mu, me = ui.mean(), ei.mean()
        var_u = ((ui - mu) ** 2).mean()
        var_e = ((ei - me) ** 2).mean()
        cov = ((ui - mu) * (ei - me)).mean()
        a = cov / var_u if var_u > min_rel_var * max(mu * mu, 1.0) else 0.0
        if a <= 0.0:
            a = 0.0
        b = me - a * mu
        r = cov / np.sqrt(var_u * var_e) if var_u > 0 and var_e > 0 else 0.0
        a_out.append(float(a))
        b_out.append(float(b))
        r_out.append(float(r))
    return {
        "a": a_out,
        "b": b_out,
        "r": r_out,
        "mean_error": [float(v) for v in e.mean(axis=0)],
        "u_min": [float(v) for v in u.min(axis=0)],
        "u_max": [float(v) for v in u.max(axis=0)],
        "e_min": [float(v) for v in e.min(axis=0)],
        "e_max": [float(v) for v in e.max(axis=0)],
    }


def apply_probe_calibration(calib: dict, slot: int, value: float) -> float:
    """A raw probe mean at ``slot`` in realized-error units: the value
    clipped into the slot's fitted input range, mapped, and the result
    clipped into the slot's observed error range, so the estimate never
    leaves what the fit measured."""
    v = float(value)
    if "u_min" in calib and "u_max" in calib:
        v = min(max(v, float(calib["u_min"][slot])), float(calib["u_max"][slot]))
    out = float(calib["a"][slot]) * v + float(calib["b"][slot])
    if "e_min" in calib and "e_max" in calib:
        out = min(max(out, float(calib["e_min"][slot])), float(calib["e_max"][slot]))
    return out


def save_probe_calibration(path, calib: dict, *, meta: Optional[dict] = None) -> None:
    payload = dict(calib)
    payload["unit"] = "mse_vs_backbone"
    if meta:
        payload["meta"] = meta
    Path(path).write_text(json.dumps(payload, indent=1))


def load_probe_calibration(path) -> dict:
    """A calibration file, checked: slopes, intercepts and per-slot mean
    errors of one length."""
    calib = json.loads(Path(path).read_text())
    if "a" not in calib or "b" not in calib:
        raise ValueError(f"{path} is not a probe calibration file (expected 'a'/'b' "
                         "slope/intercept lists; produce one with tools/calibrate_probes.py)")
    if len(calib["a"]) != len(calib["b"]):
        raise ValueError(f"{path}: len(a) != len(b)")
    if "mean_error" not in calib:
        raise ValueError(f"{path}: missing 'mean_error' (per-layer realized-error means) — "
                         "regenerate with tools/calibrate_probes.py")
    if len(calib["mean_error"]) != len(calib["a"]):
        raise ValueError(f"{path}: len(mean_error) != len(a)")
    return calib
