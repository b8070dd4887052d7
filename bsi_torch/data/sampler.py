"""Index streams for step-based training and exact-coverage evaluation.

Counterpart of ``bsi_tpu/data/sampler.py`` (plain numpy, the same streams):

- :class:`InfiniteIndexStream`: an endless reshuffled-permutation stream
  with a checkpointable cursor and optional sharding (each shard takes every
  ``num_shards``-th index);
- :func:`eval_shard`: a ``range(shard, n, num_shards)`` split with no
  padding, so evaluation covers each example exactly once;
- :func:`padded_batches`: fixed-size batches with a mask over the ragged
  tail, so metrics are exact sums over the real examples.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np


class InfiniteIndexStream:
    """Endless stream of dataset indices, reshuffled each epoch.

    The state (epoch, position) is a plain dict so it can live inside a
    checkpoint and make training resumption bit-exact.
    """

    def __init__(self, n: int, seed: int, shard_id: int = 0, num_shards: int = 1):
        if not 0 <= shard_id < num_shards:
            raise ValueError(f"shard_id {shard_id} out of range for {num_shards} shards")
        self.n = n
        self.seed = seed
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.epoch = 0
        self.pos = 0
        self._perm: np.ndarray | None = None

    def _epoch_perm(self) -> np.ndarray:
        if self._perm is None:
            rng = np.random.default_rng(np.random.SeedSequence([self.seed, self.epoch]))
            perm = rng.permutation(self.n)
            self._perm = perm[self.shard_id :: self.num_shards]
        return self._perm

    def next_indices(self, count: int) -> np.ndarray:
        """Return the next ``count`` indices of this shard's stream."""
        out = np.empty(count, dtype=np.int64)
        filled = 0
        while filled < count:
            perm = self._epoch_perm()
            take = min(count - filled, len(perm) - self.pos)
            out[filled : filled + take] = perm[self.pos : self.pos + take]
            filled += take
            self.pos += take
            if self.pos >= len(perm):
                self.epoch += 1
                self.pos = 0
                self._perm = None
        return out

    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "pos": self.pos, "seed": self.seed}

    def load_state_dict(self, state: dict) -> None:
        self.epoch = int(state["epoch"])
        self.pos = int(state["pos"])
        self.seed = int(state["seed"])
        self._perm = None


def eval_shard(n: int, shard_id: int = 0, num_shards: int = 1) -> np.ndarray:
    """Exact-coverage eval split: every index appears on exactly one shard."""
    return np.arange(shard_id, n, num_shards, dtype=np.int64)


def padded_batches(
    indices: np.ndarray, batch_size: int, num_batches: Optional[int] = None
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yield fixed-size ``(indices, mask)`` batches covering ``indices`` once.

    The final ragged batch is padded by repeating index 0 with mask 0 —
    fixed shapes, exact metrics via the mask. ``num_batches`` forces
    a fixed batch count (extra batches are fully masked), so hosts with
    differently sized eval shards stay in SPMD lockstep.
    """
    n = len(indices)
    produced = 0
    for start in range(0, n, batch_size):
        chunk = indices[start : start + batch_size]
        mask = np.ones(len(chunk), dtype=np.bool_)
        if len(chunk) < batch_size:
            pad = batch_size - len(chunk)
            chunk = np.concatenate([chunk, np.zeros(pad, dtype=chunk.dtype)])
            mask = np.concatenate([mask, np.zeros(pad, dtype=np.bool_)])
        produced += 1
        yield chunk, mask
    while num_batches is not None and produced < num_batches:
        produced += 1
        yield (
            np.zeros(batch_size, dtype=np.int64),
            np.zeros(batch_size, dtype=np.bool_),
        )
