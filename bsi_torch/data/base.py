"""Data module protocol and the in-memory array data module.

Counterpart of ``bsi_tpu/data/base.py``, with the same streams: hosts hold
the dataset as numpy arrays (NHWC, normalized to [-1, 1], or uint8
normalized on gather) or as a lazy row source (``npysource.py``), and
batches are vectorized gathers that the trainer copies to the device. The
infinite train stream and the exact-coverage eval split live in
:mod:`bsi_torch.data.sampler`.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from bsi_torch.core.discretization import Discretization
from bsi_torch.utils import profiling

from .sampler import InfiniteIndexStream, eval_shard, padded_batches


class ArrayDataModule:
    """In-memory data module over NumPy arrays.

    Splits: ``train`` (infinite stream), ``val``, ``test``, plus a
    ``train_eval`` subset used as the second eval split.
    """

    name = "arrays"

    def __init__(
        self,
        train: np.ndarray,
        val: np.ndarray,
        test: Optional[np.ndarray] = None,
        *,
        train_eval_size: int = 5000,
        batch_size: int = 128,
        eval_batch_size: Optional[int] = None,
        seed: int = 0,
        augment_flip: bool = False,
        shard_id: int = 0,
        num_shards: int = 1,
        preload: bool = True,  # accepted for config uniformity; in-memory
        # array modules are always "preloaded" (ImageNet's honours it)
    ):
        self._train = train
        self._val = val
        self._test = test if test is not None else val
        self.batch_size = batch_size
        self.eval_batch_size = eval_batch_size or batch_size
        if num_shards > 1:
            # equal per-host shards: batch sizes must divide over hosts
            for label, bs in (
                ("batch_size", self.batch_size),
                ("eval_batch_size", self.eval_batch_size),
            ):
                if bs % num_shards != 0:
                    raise ValueError(
                        f"{label}={bs} is not divisible by num_shards="
                        f"{num_shards}; multi-host batches must be equal per "
                        f"host"
                    )
        self.seed = seed
        self.augment_flip = augment_flip
        self.shard_id = shard_id
        self.num_shards = num_shards
        # deterministic train-eval subset
        rng = np.random.default_rng(np.random.SeedSequence([seed, 60321]))
        k = min(train_eval_size, len(train))
        self._train_eval_idx = np.sort(rng.choice(len(train), size=k, replace=False))
        self.stream = InfiniteIndexStream(
            len(train), seed, shard_id=shard_id, num_shards=num_shards
        )
        self._aug_rng = np.random.default_rng(np.random.SeedSequence([seed, 77]))

    # ------------------------------------------------------------- metadata

    def data_shape(self) -> tuple[int, ...]:
        return tuple(self._train.shape[1:])

    def discretization(self) -> Discretization:
        return Discretization.image_8bit()

    def short_name(self) -> str:
        return self.name

    # ----------------------------------------------------------------- train

    def _prepare(self, batch: np.ndarray) -> np.ndarray:
        """Per-batch postprocessing: uint8 storage is normalized to [-1, 1]
        float32 on gather."""
        if batch.dtype == np.uint8:
            return batch.astype(np.float32) * (2.0 / 255.0) - 1.0
        return batch

    def train_batches(self, per_host_batch: Optional[int] = None) -> Iterator[np.ndarray]:
        """Endless stream of training batches (this host's equal shard of the
        global batch; divisibility is guaranteed by the constructor guard)."""
        if per_host_batch is None:
            per_host_batch = self.batch_size // self.num_shards
        while True:
            with profiling.span("data.batch"):
                idx = self.stream.next_indices(per_host_batch)
                flip = (
                    self._aug_rng.random(len(idx)) < 0.5 if self.augment_flip else None
                )
                batch = self._prepare(self._train[idx])
                if flip is not None:
                    batch = np.where(flip[:, None, None, None], batch[:, :, ::-1, :], batch)
            yield batch

    # ------------------------------------------------------------------ eval

    def _train_eval_subset(self):
        if hasattr(self._train, "subset"):  # a lazy row source stays lazy
            return self._train.subset(self._train_eval_idx)
        return self._train[self._train_eval_idx]

    def eval_splits(self) -> dict[str, np.ndarray]:
        """Named eval splits; 'train' is the fixed train subset."""
        return {"val": self._val, "train": self._train_eval_subset()}

    def test_splits(self) -> dict[str, np.ndarray]:
        return {"test": self._test, "train": self._train_eval_subset()}

    def eval_batches(
        self, split: np.ndarray, batch_size: Optional[int] = None
    ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Fixed-shape (batch, mask) pairs covering this host's shard of the
        split exactly once.

        ``eval_batch_size`` is the *global* eval batch; each host feeds its
        ``1/num_shards`` slice per step. All hosts yield the same number of
        batches (fully-masked tail batches where a shard runs out early), so
        the eval loops of all processes stay in lockstep.
        """
        bs = (batch_size or self.eval_batch_size) // self.num_shards
        idx = eval_shard(len(split), self.shard_id, self.num_shards)
        largest_shard = -(-len(split) // self.num_shards)
        num_batches = max(-(-largest_shard // bs), 1)
        for chunk, mask in padded_batches(idx, bs, num_batches=num_batches):
            yield self._prepare(split[chunk]), mask

    # ------------------------------------------------------------- state

    def state_dict(self) -> dict:
        return {"stream": self.stream.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.stream.load_state_dict(state["stream"])


class SyntheticDataModule(ArrayDataModule):
    """Deterministic synthetic 8-bit image data for tests and dry runs."""

    name = "synthetic"

    def __init__(
        self,
        *,
        n_train: int = 512,
        n_val: int = 128,
        data_shape: tuple[int, int, int] = (8, 8, 3),
        seed: int = 0,
        **kwargs,
    ):
        rng = np.random.default_rng(seed)

        def make(n):
            # smooth low-frequency blobs quantized to 8-bit bin centers
            h, w, c = data_shape
            yy, xx = np.mgrid[0:h, 0:w]
            yy = yy / max(h - 1, 1)
            xx = xx / max(w - 1, 1)
            base = np.zeros((n, h, w, c), np.float32)
            for i in range(n):
                fx, fy = rng.uniform(0.5, 3, 2)
                phase = rng.uniform(0, 2 * np.pi, c)
                for ch in range(c):
                    base[i, :, :, ch] = np.sin(
                        2 * np.pi * (fx * xx + fy * yy) + phase[ch]
                    )
            levels = np.round((base * 0.5 + 0.5) * 255)
            return (levels / 255 * 2 - 1).astype(np.float32)

        super().__init__(make(n_train), make(n_val), seed=seed, **kwargs)
