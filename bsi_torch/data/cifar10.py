"""CIFAR-10 data module.

Counterpart of ``bsi_tpu/data/cifar10.py``: reads the standard python-pickle
batches (a ``cifar-10-batches-py`` directory or ``cifar-10-python.tar.gz``
under ``root``), caches the images NHWC/uint8 and the labels, makes the same
deterministic 90/10 train/val split with the same fixed seed, and serves the
same 5k train-eval subset as the second eval split. The cache is ``.npy``
files (``cifar10-{train,test}{,-labels}.npy``) where the JAX package writes
one h5 file, since h5py is not among the port's dependencies; the 150 MB of
images are held in memory either way, so ``preload`` is accepted and has
nothing to choose. Nothing is downloaded: the raw archive must be under
``root``.
"""

from __future__ import annotations

import os
import pickle
import tarfile
from pathlib import Path
from typing import Optional

import numpy as np

from .base import ArrayDataModule

SPLIT_SEED = 387_241_991  # the JAX package's fixed split seed


def _load_pickle_batches(root: Path) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Return (train_images, train_labels, test_images, test_labels); images
    NHWC uint8, labels int16."""
    batches_dir = root / "cifar-10-batches-py"
    if not batches_dir.exists():
        tarball = root / "cifar-10-python.tar.gz"
        if not tarball.exists():
            raise FileNotFoundError(
                f"CIFAR-10 raw data not found: place cifar-10-python.tar.gz or the extracted "
                f"cifar-10-batches-py directory under {root} (nothing is downloaded)"
            )
        with tarfile.open(tarball) as tf:
            tf.extractall(root, filter="data")

    def read(name):
        with open(batches_dir / name, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        # stored as [N, 3072] with CHW pixel order -> NHWC
        data = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return np.ascontiguousarray(data), np.asarray(d[b"labels"], np.int16)

    parts = [read(f"data_batch_{i}") for i in range(1, 6)]
    train = np.concatenate([p[0] for p in parts])
    train_labels = np.concatenate([p[1] for p in parts])
    test, test_labels = read("test_batch")
    return train, train_labels, test, test_labels


def _cache(root: Path) -> dict[str, Path]:
    """The cache files, written from the raw batches on first use."""
    files = {name: root / f"cifar10-{name}.npy" for name in ("train", "train-labels", "test", "test-labels")}
    if not all(path.exists() for path in files.values()):
        arrays = dict(zip(files, _load_pickle_batches(root)))
        root.mkdir(parents=True, exist_ok=True)
        for name, path in files.items():
            tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npy")
            np.save(tmp, arrays[name])
            os.replace(tmp, path)
    return files


class CIFAR10DataModule(ArrayDataModule):
    name = "cifar10"

    def __init__(
        self,
        root: str = "data/cifar10",
        *,
        batch_size: int = 128,
        eval_batch_size: Optional[int] = None,
        augment_flip: bool = False,
        val_fraction: float = 0.1,
        train_eval_size: int = 5000,
        preload: bool = True,
        seed: int = 0,
        shard_id: int = 0,
        num_shards: int = 1,
    ):
        files = _cache(Path(root))
        train_full = np.load(files["train"])
        self.train_full_labels = np.load(files["train-labels"])
        self.test_labels = np.load(files["test-labels"])
        # deterministic 90/10 split, independent of the run seed
        rng = np.random.default_rng(SPLIT_SEED)
        perm = rng.permutation(len(train_full))
        n_val = int(len(train_full) * val_fraction)
        val_idx, train_idx = np.sort(perm[:n_val]), np.sort(perm[n_val:])
        self.train_labels = self.train_full_labels[train_idx]
        self.val_labels = self.train_full_labels[val_idx]
        super().__init__(
            train_full[train_idx],
            train_full[val_idx],
            np.load(files["test"]),
            train_eval_size=train_eval_size,
            batch_size=batch_size,
            eval_batch_size=eval_batch_size,
            seed=seed,
            augment_flip=augment_flip,
            shard_id=shard_id,
            num_shards=num_shards,
        )

    def data_shape(self) -> tuple[int, ...]:
        return (32, 32, 3)
