"""Lazy row source over a ``.npy`` file (the ``preload: no`` path).

Counterpart of ``bsi_tpu/data/h5source.py`` (``H5LazySource``), which reads
rows of an h5 dataset per batch. The port's caches are ``.npy`` files (h5py
is not among its dependencies), so this source maps the file with
``np.load(..., mmap_mode="r")`` and copies out the rows a batch asks for:
the set is never read into memory as a whole. Rows come back in the order
asked, repeated indices included, as the JAX source's ``np.unique`` and
inverse round trip returns them.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np


class NpyRowSource:
    """Array-like view over the rows of one ``.npy`` file, optionally
    restricted to a subset of row indices (the train/val splits of one file)."""

    def __init__(self, path: str | Path, subset: Optional[np.ndarray] = None):
        self._array = np.load(path, mmap_mode="r")
        self._subset = None if subset is None else np.asarray(subset, np.int64)

    @property
    def dtype(self):
        return self._array.dtype

    @property
    def shape(self):
        n = len(self._subset) if self._subset is not None else self._array.shape[0]
        return (n,) + self._array.shape[1:]

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, idx) -> np.ndarray:
        idx = np.atleast_1d(np.asarray(idx, np.int64))
        if self._subset is not None:
            idx = self._subset[idx]
        # fancy indexing of the map copies just these rows, in this order
        return np.ascontiguousarray(self._array[idx])

    def subset(self, indices: np.ndarray) -> "NpyRowSource":
        """The rows ``indices`` of this source, as a source over the same map."""
        base = np.asarray(indices, np.int64)
        src = NpyRowSource.__new__(NpyRowSource)
        src._array = self._array
        src._subset = base if self._subset is None else self._subset[base]
        return src
