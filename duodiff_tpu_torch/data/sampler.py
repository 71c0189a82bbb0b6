"""Resumable, seedable index sampler (counterpart of
``duodiff_tpu/data/sampler.py``): an infinite stream of dataset indices,
one permutation per epoch drawn with numpy from ``seed + epoch``, so its
permutations are the JAX package's to the bit. get_state / set_state give
exact mid-epoch resume."""

from __future__ import annotations

import numpy as np


class ResumableSeedableSampler:
    def __init__(self, num_samples: int, seed: int):
        self.num_samples = num_samples
        self.seed = int(seed)
        self.epoch = 0
        self.perm_index = 0
        self.perm = self._make_perm()

    def _make_perm(self) -> np.ndarray:
        return np.random.default_rng(self.seed + self.epoch).permutation(self.num_samples)

    def next_indices(self, n: int) -> np.ndarray:
        """Draw the next n indices (rolls epochs as needed)."""
        out = np.empty(n, dtype=np.int64)
        filled = 0
        while filled < n:
            take = min(len(self.perm) - self.perm_index, n - filled)
            out[filled:filled + take] = self.perm[self.perm_index:self.perm_index + take]
            self.perm_index += take
            filled += take
            if self.perm_index >= len(self.perm):
                self.perm_index = 0
                self.epoch += 1
                self.perm = self._make_perm()
        return out

    def get_state(self) -> dict:
        return {"perm": np.asarray(self.perm), "perm_index": self.perm_index,
                "epoch": self.epoch, "seed": self.seed}

    def set_state(self, state: dict) -> None:
        self.perm = np.asarray(state["perm"])
        self.perm_index = int(state["perm_index"])
        self.epoch = int(state["epoch"])
        self.seed = int(state["seed"])
