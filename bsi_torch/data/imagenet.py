"""Downsampled ImageNet (32x32 / 64x64) data module.

Counterpart of ``bsi_tpu/data/imagenet.py``: reads the official
downsampled-ImageNet ``.npz`` shards (``Imagenet{n}_train_npz/
train_data_batch_*.npz`` and ``Imagenet{n}_val_npz/val_data.npz`` under
``root``: ``data`` uint8 ``[N, 3*n*n]`` channel-planar, ``labels``
optional), turns them into NHWC uint8 with int16 labels, takes the same
deterministic 1% val split off the train set with the same fixed seed, and
serves the official val set as the test split. Images are normalized on
gather (``ArrayDataModule``).

The cache is ``.npy`` files under ``root``
(``imagenet{n}-{train,test}{,-labels}.npy``), written from the shards on
first use, where the JAX package writes one ``imagenet{n}.h5``: h5py is not
among the port's dependencies, and the port does not read the JAX cache.
With ``preload: no`` (the imagenet64 recipe) the images stay on disk and
each batch reads its rows through :class:`~.npysource.NpyRowSource`.
Nothing is downloaded.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import numpy as np

from .base import ArrayDataModule
from .npysource import NpyRowSource

SPLIT_SEED = 91_042_787  # the JAX package's fixed split seed


def _to_nhwc(flat: np.ndarray, n: int) -> np.ndarray:
    return np.ascontiguousarray(flat.reshape(-1, 3, n, n).transpose(0, 2, 3, 1))


def _shards(root: Path, n: int) -> tuple[list[Path], Path]:
    train_dir = root / f"Imagenet{n}_train_npz"
    val_file = root / f"Imagenet{n}_val_npz" / "val_data.npz"
    shards = sorted(train_dir.glob("train_data_batch_*.npz"))
    if not shards or not val_file.exists():
        raise FileNotFoundError(
            f"Downsampled ImageNet{n} npz shards not found under {root} (expected "
            f"{train_dir}/train_data_batch_*.npz and {val_file}; nothing is downloaded)"
        )
    return shards, val_file


def _save(path: Path, array: np.ndarray) -> None:
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npy")
    np.save(tmp, array)
    os.replace(tmp, path)


def _build_cache(root: Path, n: int, files: dict[str, Path]) -> None:
    """Write the train images shard by shard into the cache file (one shard
    in memory at a time), then the labels and the test split."""
    shards, val_file = _shards(root, n)
    counts, labels = [], []
    for shard in shards:
        with np.load(shard) as z:
            counts.append(z["data"].shape[0])
            labels.append(np.asarray(z["labels"], np.int16) if "labels" in z else None)
    tmp = files["train"].with_name(f"{files['train'].stem}.{os.getpid()}.tmp.npy")
    out = np.lib.format.open_memmap(tmp, mode="w+", dtype=np.uint8, shape=(sum(counts), n, n, 3))
    start = 0
    for shard, count in zip(shards, counts):
        with np.load(shard) as z:
            out[start:start + count] = _to_nhwc(z["data"].astype(np.uint8), n)
        start += count
    out.flush()
    del out
    os.replace(tmp, files["train"])
    if all(part is not None for part in labels):
        _save(files["train-labels"], np.concatenate(labels))
    with np.load(val_file) as z:
        if "labels" in z:
            _save(files["test-labels"], np.asarray(z["labels"], np.int16))
        _save(files["test"], _to_nhwc(z["data"].astype(np.uint8), n))


def _cache(root: Path, n: int) -> dict[str, Path]:
    """The cache files; the label files exist where the shards carry labels."""
    files = {name: root / f"imagenet{n}-{name}.npy" for name in ("train", "train-labels", "test", "test-labels")}
    if not (files["train"].exists() and files["test"].exists()):
        root.mkdir(parents=True, exist_ok=True)
        _build_cache(root, n, files)
    return files


def write_synthetic_shards(root: str | Path, n: int, n_train: int, n_val: int, *, seed: int,
                           n_shards: int = 2) -> None:
    """Random images in the official shard format under ``root``: ``n_train``
    train images over ``n_shards`` ``train_data_batch_{i}.npz`` (``data``,
    1-based ``labels``, the train set's ``mean``) and ``n_val`` in
    ``val_data.npz``, all drawn from ``seed``. For runs without the dataset."""
    root = Path(root)
    rng = np.random.default_rng(seed)
    draw = lambda count: (rng.integers(0, 256, (count, 3 * n * n), dtype=np.uint8),
                          rng.integers(1, 1001, count).tolist())
    train_dir, val_dir = root / f"Imagenet{n}_train_npz", root / f"Imagenet{n}_val_npz"
    train_dir.mkdir(parents=True, exist_ok=True)
    val_dir.mkdir(parents=True, exist_ok=True)
    parts = [draw(len(rows)) for rows in np.array_split(np.arange(n_train), n_shards)]
    mean = np.concatenate([data for data, _ in parts]).mean(axis=0)
    for i, (data, labels) in enumerate(parts, start=1):
        np.savez(train_dir / f"train_data_batch_{i}.npz", data=data, labels=labels, mean=mean)
    data, labels = draw(n_val)
    np.savez(val_dir / "val_data.npz", data=data, labels=labels)


class ImageNetDataModule(ArrayDataModule):
    def __init__(
        self,
        root: str = "data/imagenet32",
        *,
        n: int = 32,
        batch_size: int = 128,
        eval_batch_size: Optional[int] = None,
        val_fraction: float = 0.01,
        train_eval_size: int = 5000,
        preload: bool = True,
        seed: int = 0,
        shard_id: int = 0,
        num_shards: int = 1,
    ):
        self.name = f"imagenet{n}"
        self.n = n
        files = _cache(Path(root), n)
        load_labels = lambda name: np.load(files[name]) if files[name].exists() else None
        self.train_full_labels = load_labels("train-labels")
        self.test_labels = load_labels("test-labels")

        train_full = NpyRowSource(files["train"])
        rng = np.random.default_rng(SPLIT_SEED)
        perm = rng.permutation(len(train_full))
        n_val = int(len(train_full) * val_fraction)
        val_idx, train_idx = np.sort(perm[:n_val]), np.sort(perm[n_val:])
        if self.train_full_labels is not None:
            self.train_labels = self.train_full_labels[train_idx]
            self.val_labels = self.train_full_labels[val_idx]

        if preload:
            images = np.load(files["train"])  # uint8, normalized on gather
            train, val, test = images[train_idx], images[val_idx], np.load(files["test"])
            del images
        else:
            train, val = train_full.subset(train_idx), train_full.subset(val_idx)
            test = NpyRowSource(files["test"])

        super().__init__(
            train,
            val,
            test,
            train_eval_size=train_eval_size,
            batch_size=batch_size,
            eval_batch_size=eval_batch_size,
            seed=seed,
            shard_id=shard_id,
            num_shards=num_shards,
        )

    def data_shape(self) -> tuple[int, ...]:
        return (self.n, self.n, 3)
