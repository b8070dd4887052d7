"""Frechet Inception Distance: streaming statistics, the distance, the
per-stage metric of validation.

Counterpart of ``bsi_tpu/metrics/fid.py``. Real-set statistics are computed
once and stored as ``.npz`` with keys ``n``, ``sum``, ``cov_sum`` (numpy
f64), the torchmetrics state format, so a stats file passes unchanged
between the two packages and torchmetrics. Generated samples are
accumulated the same way, and the distance follows torchmetrics'
``_compute_fid`` (the trace of the matrix square root from the eigenvalues
of ``cov1 @ cov2``), in numpy f64 on the host.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch



def _host_f64(embeddings) -> np.ndarray:
    if isinstance(embeddings, torch.Tensor):
        return embeddings.detach().to("cpu", torch.float64).numpy()
    return np.asarray(embeddings, np.float64)


class FeatureStats:
    """Streaming (n, sum, cov_sum) accumulator over embedding batches."""

    def __init__(self, dim: int):
        self.n = 0
        self.sum = np.zeros(dim, np.float64)
        self.cov_sum = np.zeros((dim, dim), np.float64)

    def update(self, embeddings) -> None:
        """Add a ``[N, dim]`` batch (a tensor on any device, or an array),
        taken to the host in f64."""
        e = _host_f64(embeddings)
        self.n += len(e)
        self.sum += e.sum(axis=0)
        self.cov_sum += e.T @ e

    def mean_cov(self) -> tuple[np.ndarray, np.ndarray]:
        if self.n < 2:
            raise ValueError("Need at least two samples for covariance")
        mean = self.sum / self.n
        cov = (self.cov_sum - self.n * np.outer(mean, mean)) / (self.n - 1)
        return mean, cov

    def save_npz(self, path: str | Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, n=np.asarray(self.n), sum=self.sum, cov_sum=self.cov_sum)

    @classmethod
    def from_npz(cls, path: str | Path) -> "FeatureStats":
        with np.load(path) as z:
            stats = cls(len(z["sum"]))
            stats.n = int(np.asarray(z["n"]).item())
            stats.sum = z["sum"].astype(np.float64)
            stats.cov_sum = z["cov_sum"].astype(np.float64)
        return stats


def reduce_stats_across_processes(stats: FeatureStats, *, device: Optional[torch.device] = None) -> FeatureStats:
    """The statistics summed over every process: ``n``, ``sum`` and
    ``cov_sum`` in f64, on ``device`` for the all-reduce (the card for NCCL)
    and back. The identity without a process group. The trainer's ranks that hold no rows of their own (model ranks
    other than 0) add nothing, so the sum over every process is the sum
    over the data group."""
    if not (torch.distributed.is_available() and torch.distributed.is_initialized()):
        return stats
    d = len(stats.sum)
    flat = np.concatenate([[float(stats.n)], stats.sum, stats.cov_sum.reshape(-1)])
    t = torch.from_numpy(flat).to(device if device is not None else "cpu")
    torch.distributed.all_reduce(t)
    flat = t.cpu().numpy()
    out = FeatureStats(d)
    out.n = int(round(flat[0]))
    out.sum = flat[1:1 + d].copy()
    out.cov_sum = flat[1 + d:].reshape(d, d).copy()
    return out


def frechet_distance(mean1: np.ndarray, cov1: np.ndarray, mean2: np.ndarray, cov2: np.ndarray) -> float:
    """FID between two Gaussians, computed like torchmetrics' ``_compute_fid``:
    ``|m1-m2|^2 + tr(c1) + tr(c2) - 2 sum(sqrt(eigvals(c1 @ c2)).real)``."""
    a = np.atleast_1d(np.asarray(mean1, np.float64))
    b = np.atleast_1d(np.asarray(mean2, np.float64))
    c1 = np.atleast_2d(np.asarray(cov1, np.float64))
    c2 = np.atleast_2d(np.asarray(cov2, np.float64))
    diff = a - b
    eigvals = np.linalg.eigvals(c1 @ c2)
    tr_covmean = np.sqrt(eigvals.astype(np.complex128)).real.sum()
    return float(diff @ diff + np.trace(c1) + np.trace(c2) - 2.0 * tr_covmean)


def fid_from_stats(stats1: FeatureStats, stats2: FeatureStats) -> float:
    m1, c1 = stats1.mean_cov()
    m2, c2 = stats2.mean_cov()
    return frechet_distance(m1, c1, m2, c2)


def fid_stats_path(root: str | Path, dataset_name: str, split: str) -> Path:
    """Where a dataset split's precomputed statistics live."""
    return Path(root) / "data" / "fid-stats" / dataset_name / f"{split}.npz"


class FIDScore:
    """FID against precomputed real-set statistics.

    ``embed_fn`` maps a uint8 image batch ``[N, H, W, 3]`` to ``[N, dim]``
    embeddings (see :func:`bsi_torch.metrics.inception.make_embed_fn`).
    Updates run in blocks of ``block_size`` images to bound device memory.
    """

    def __init__(self, embed_fn: Callable, real_stats: FeatureStats, *, block_size: int = 256,
                 dim: Optional[int] = None):
        self.embed_fn = embed_fn
        self.real_stats = real_stats
        self.block_size = block_size
        self.fake_stats = FeatureStats(dim or len(real_stats.sum))

    def update(self, images_uint8) -> None:
        for start in range(0, len(images_uint8), self.block_size):
            self.fake_stats.update(self.embed_fn(images_uint8[start:start + self.block_size]))

    def compute(self) -> float:
        return fid_from_stats(self.fake_stats, self.real_stats)

    def reset(self) -> None:
        self.fake_stats = FeatureStats(len(self.real_stats.sum))


def images_to_uint8(batch01: np.ndarray) -> np.ndarray:
    """[0, 1]-clamped float images -> uint8, the FID input convention."""
    return (255 * np.clip(batch01, 0.0, 1.0)).astype(np.uint8)


def build_validation_fid(
    data,
    *,
    stages: tuple[str, ...] = ("val", "train", "test"),
    stats_root: str | Path = ".",
    weights_path: Optional[str | Path] = None,
    embed_fn: Optional[Callable] = None,
    block_size: int = 256,
    warn: Optional[Callable[[str], None]] = None,
    device: torch.device | str | None = None,
) -> dict[str, FIDScore]:
    """Per-stage :class:`FIDScore` metrics for validation.

    FID is active only for 3-channel image data, and only for the stages
    whose statistics exist at ``<stats_root>/data/fid-stats/<dataset>/
    <stage>.npz``; each missing one is a warning, not an error. ``embed_fn``
    replaces the InceptionV3 (the tests pass a stub); without it the weights
    are found by :func:`~bsi_torch.metrics.inception.default_weights_path`
    and the network runs on ``device`` (the card when None). Returns ``{}``
    when no FID can be computed.
    """
    warn = warn or (lambda msg: None)
    shape = data.data_shape()
    if len(shape) != 3 or shape[-1] != 3:
        return {}

    stats: dict[str, FeatureStats] = {}
    for stage in stages:
        path = fid_stats_path(stats_root, data.short_name(), stage)
        if path.is_file():
            stats[stage] = FeatureStats.from_npz(path)
        else:
            warn(f"No precomputed FID statistics for {stage} found.")
    if not stats:
        return {}

    if embed_fn is None:
        from .inception import default_weights_path, load_params, make_embed_fn

        weights = weights_path or default_weights_path()
        if weights is None:
            warn("FID stats found but no InceptionV3 weights; set BSI_TPU_INCEPTION_WEIGHTS to enable "
                 "validation-time FID.")
            return {}
        embed_fn = make_embed_fn(load_params(weights), device=device)

    return {stage: FIDScore(embed_fn, real, block_size=block_size) for stage, real in stats.items()}
