"""Run naming and metrics logging (counterpart of
``duodiff_tpu/utils/train_utils.py``; TensorBoard events are not written)."""

from __future__ import annotations

import json
from pathlib import Path
from time import localtime, strftime


def get_exp_name(args) -> str:
    """``{dataset}-{model}-{timestamp}``."""
    return f"{args.dataset}-{args.model}-{strftime('%Y-%m-%d_%H:%M:%S', localtime())}"


def _maybe_str(v):
    try:
        json.dumps(v)
        return v
    except TypeError:
        return str(v)


class MetricsLogger:
    """Scalars appended to ``metrics.jsonl``, hyperparameters in
    ``hparams.json``; nothing written when not ``enabled`` (a rank other
    than 0)."""

    def __init__(self, log_dir, enabled: bool = True):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.enabled = enabled
        self._jsonl = open(self.log_dir / "metrics.jsonl", "a") if enabled else None

    def log_scalars(self, step: int, scalars: dict) -> None:
        if self._jsonl is None:
            return
        self._jsonl.write(json.dumps({"step": step, **{k: float(v) for k, v in scalars.items()}})
                          + "\n")
        self._jsonl.flush()

    def log_hparams(self, hparams: dict) -> None:
        if not self.enabled:
            return
        with open(self.log_dir / "hparams.json", "w") as f:
            json.dump({k: _maybe_str(v) for k, v in hparams.items()}, f, indent=2)

    def close(self) -> None:
        """Release the jsonl file; later calls are no-ops. Idempotent."""
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
