"""Full-training-state checkpoints in torch format (counterpart of
``duodiff_tpu/training/checkpointer.py``).

``<log_path>/<exp_name>/<save_name>_last/`` (rolling) or ``..._step-N/``
(archived) holds ``checkpoint.pth`` and ``run_args.json``. The ``.pth`` is
one dict of tensors and plain values, loadable with ``weights_only=True``:

- ``step``;
- ``model_state_dict``: the parameters under the reference's names, so the
  sampling CLI's ``--checkpoint_path <dir>/checkpoint.pth`` loads it as is;
- ``optimizer``: the AdamW count and moments; ``ema_state_dict`` when an
  EMA is kept;
- ``sampler_state``: the data sampler's permutation (as a tensor), index,
  epoch and seed.

The file is written to a temporary name and renamed, so a reader sees a
whole checkpoint or none.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Optional

import numpy as np
import torch

CHECKPOINT_FILE = "checkpoint.pth"


def _sampler_to_torch(state: dict) -> dict:
    return {"perm": torch.from_numpy(np.asarray(state["perm"], np.int64)),
            "perm_index": int(state["perm_index"]), "epoch": int(state["epoch"]),
            "seed": int(state["seed"])}


def _sampler_from_torch(state: dict) -> dict:
    return {**state, "perm": state["perm"].numpy()}


def _jsonable(d: dict) -> dict:
    out = {}
    for k, v in d.items():
        try:
            json.dumps(v)
            out[k] = v
        except TypeError:
            out[k] = str(v)
    return out


class Checkpointer:
    """Manages ``<log_path>/<exp_name>/<save_name>{_last,_step-N}`` dirs."""

    def __init__(self, log_path, exp_name: str, save_name: Optional[str] = None,
                 dataset: str = "", model: str = ""):
        self.log_path = Path(log_path) / exp_name
        self.save_name = save_name or f"{dataset}_{model}"
        self.log_path.mkdir(parents=True, exist_ok=True)

    def save(self, *, step: int, model_state: dict, optimizer_state: Optional[dict] = None,
             ema_state: Optional[dict] = None, sampler_state: Optional[dict] = None,
             args: Optional[dict] = None, new_checkpoint: bool = False) -> Path:
        suffix = f"step-{step}" if new_checkpoint else "last"
        path = self.log_path / f"{self.save_name}_{suffix}"
        path.mkdir(parents=True, exist_ok=True)
        cpu = lambda d: {k: v.detach().cpu() for k, v in d.items()}  # noqa: E731
        state = {"step": int(step), "model_state_dict": cpu(model_state)}
        if optimizer_state is not None:
            # the moments (and an accumulation window's running mean) as CPU
            # tensors, the counters as they are
            state["optimizer"] = {k: cpu(v) if isinstance(v, dict) else v
                                  for k, v in optimizer_state.items()}
        if ema_state is not None:
            state["ema_state_dict"] = cpu(ema_state)
        if sampler_state is not None:
            state["sampler_state"] = _sampler_to_torch(sampler_state)
        tmp = path / f"{CHECKPOINT_FILE}.{os.getpid()}.tmp"
        torch.save(state, tmp)
        os.replace(tmp, path / CHECKPOINT_FILE)
        if args is not None:
            with open(path / "run_args.json", "w") as f:
                json.dump(_jsonable(args), f, indent=2)
        return path

    def tracked_checkpoints(self) -> list[Path]:
        """Archived step-N checkpoints sorted by step ascending."""
        found = []
        for p in self.log_path.glob(f"{self.save_name}_step-*"):
            m = re.search(r"step-(\d+)$", p.name)
            if m and p.is_dir():
                found.append((int(m.group(1)), p))
        return [p for _, p in sorted(found)]

    def last_checkpoint(self) -> Optional[Path]:
        """Newest checkpoint that loads; corrupt or partial ones are skipped."""
        candidates = self.tracked_checkpoints()
        last = self.log_path / f"{self.save_name}_last"
        if last.is_dir():
            candidates.append(last)
        for path in reversed(candidates):
            try:
                state = torch.load(path / CHECKPOINT_FILE, map_location="cpu", weights_only=True)
                if "step" not in state or "model_state_dict" not in state:
                    raise IOError("no step or model_state_dict")
                return path
            except Exception as e:  # corrupt or partial write
                print(f"Checkpoint {path} appears corrupted: {e}")
        return None

    @staticmethod
    def restore(path) -> dict:
        """The saved state of a checkpoint directory (or its .pth file) on the
        CPU, the sampler state back in numpy."""
        path = Path(path)
        if path.is_dir():
            path = path / CHECKPOINT_FILE
        state = torch.load(path, map_location="cpu", weights_only=True)
        if "sampler_state" in state:
            state["sampler_state"] = _sampler_from_torch(state["sampler_state"])
        return state
