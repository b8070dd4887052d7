"""Every draw of a train step and of a sampling call, worked out again from
the seeds the benchmark hands to both sides.

- **Noise of a train step** (from the state's generator): one uniform
  offset, a permutation of the batch, then a standard normal of the
  batch's shape; ``t = ((perm / (1 + B)) + offset) mod 1``.
- **Noise of a sampling call** (from the caller's generator): a standard
  normal of the sample batch's shape for the initial belief, then one a
  step, in order.
- **Dropout of a train step**: the device's default generator, seeded with
  the step's seed (:func:`seeded`), draws in forward order, as the model
  kind's ``dropout_plan`` lists the draws. The attention mask comes,
  on a CUDA device, from one int32 seed a (row, head), drawn as
  ``randint(0, 2**31 - 1)``, through Philox4x32-10 (:func:`philox_keep`);
  elsewhere from a uniform a probability. A module's mask is torch's
  dropout of a tensor of ones of the masked tensor's shape, dtype and
  memory format.
- **The order of the data**: epoch ``e`` visits the rows in
  ``default_rng(SeedSequence([data_seed, e])).permutation(n)``.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch
from torch.nn import functional as F

_U32 = 0xFFFFFFFF
_M = (0xD2511F53, 0xCD9E8D57)
_W = (0x9E3779B9, 0xBB67AE85)
_MASK64 = (1 << 64) - 1


def _mix64(z: int) -> int:
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def step_seed(dropout_seed: int, step: int) -> int:
    """The seed of step ``step``'s dropout under a state's dropout seed:
    splitmix64's finaliser of (finaliser of the seed) + step."""
    return _mix64((_mix64(dropout_seed & _MASK64) + step) & _MASK64)


def _mulhilo(m: int, x: torch.Tensor):
    a = m * (x & 0xFFFF)
    b = m * (x >> 16)
    t = a + ((b & 0xFFFF) << 16)
    return (b >> 16) + (t >> 32), t & _U32


def philox_keep(seeds: torch.Tensor, seq: int, keep_prob: float) -> torch.Tensor:
    """bool ``[..., S, S]`` from int32 ``seeds [...]``: element (i, j) is kept
    where word ``2 * ((i >> 3) & 1) + (j & 1)`` of Philox4x32-10 with counter
    ``(j >> 1, i & ~8, 0, 0)`` and key ``(seed, 0)`` lies below
    ``round(keep_prob * 2**32)``."""
    dev = seeds.device
    flat = seeds.reshape(-1).to(torch.int64) & _U32
    i = torch.arange(seq, device=dev, dtype=torch.int64)
    c1 = (i & ~8)[None, :, None]
    c0 = torch.arange((seq + 1) // 2, device=dev, dtype=torch.int64)[None, None, :]
    upper = ((i >> 3) & 1).bool()[None, :, None]
    threshold = min(int(round(keep_prob * 4294967296.0)), _U32)
    out = []
    chunk = max(1, (1 << 24) // (seq * ((seq + 1) // 2)))
    for start in range(0, flat.numel(), chunk):
        k0, k1 = flat[start:start + chunk, None, None], torch.zeros((), dtype=torch.int64, device=dev)
        x0, x1, x2, x3 = c0, c1, torch.zeros_like(c0), torch.zeros_like(c0)
        for r in range(10):
            hi0, lo0 = _mulhilo(_M[0], x0)
            hi1, lo1 = _mulhilo(_M[1], x2)
            x0, x1, x2, x3 = hi1 ^ x1 ^ k0, lo1, hi0 ^ x3 ^ k1, lo0
            if r < 9:
                k0, k1 = (k0 + _W[0]) & _U32, (k1 + _W[1]) & _U32
        even, odd = torch.where(upper, x2, x0), torch.where(upper, x3, x1)
        bits = torch.stack([even, odd], dim=-1).reshape(k0.shape[0], seq, -1)[..., :seq]
        out.append(bits < threshold)
    return torch.cat(out).reshape(*seeds.shape, seq, seq)


@dataclass
class AttentionDraw:
    """One attention call's dropout: int32 seeds ``[B, H]`` (CUDA) or a bool
    mask ``[B, H, S, S]`` (elsewhere)."""

    seeds: torch.Tensor | None
    keep: torch.Tensor | None
    seq: int
    keep_prob: float

    @classmethod
    def draw(cls, batch: int, heads: int, seq: int, rate: float, device) -> "AttentionDraw":
        """One call's draw from the device's default generator."""
        if torch.device(device).type == "cuda":
            return cls(torch.randint(0, 2**31 - 1, (batch, heads), dtype=torch.int32, device=device), None, seq,
                       1.0 - rate)
        return cls(None, torch.rand((batch, heads, seq, seq), device=device) < 1.0 - rate, seq, 1.0 - rate)

    def mask(self, rows: slice) -> torch.Tensor:
        if self.keep is not None:
            return self.keep[rows]
        return philox_keep(self.seeds[rows], self.seq, self.keep_prob)


def module_keep(shape, rate: float, dtype, device, memory_format) -> torch.Tensor:
    """A module's keep mask: torch's dropout of a tensor of ones of the
    masked tensor's shape, dtype and memory format."""
    ones = torch.ones(shape, dtype=dtype, device=device).contiguous(memory_format=memory_format)
    return F.dropout(ones, rate, training=True) != 0


@contextlib.contextmanager
def seeded(seed: int, device):
    """The device's default generator seeded with ``seed`` inside the block
    (a train step's dropout draws from it), its state restored after."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    index = (device.index if device.index is not None else torch.cuda.current_device()) if cuda else None
    with torch.random.fork_rng(devices=[index] if cuda else []):
        (torch.cuda.default_generators[index] if cuda else torch.default_generator).manual_seed(seed)
        yield


def train_noise(generator: torch.Generator, x: torch.Tensor):
    """``(t [B], eps)`` of one train step from the state's generator."""
    offset = torch.rand((), generator=generator, dtype=x.dtype, device=x.device)
    perm = torch.randperm(x.shape[0], generator=generator, device=x.device)
    t = torch.remainder(perm.to(x.dtype) / (1 + x.shape[0]) + offset, 1.0)
    return t, torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)


def sampling_noise(generator: torch.Generator, shape: tuple, k: int, *, skip_calls: int = 0):
    """The ``k + 1`` standard normals of one sampling call, after
    ``skip_calls`` earlier calls of the same shape and k drew theirs."""
    draw = lambda: torch.randn(shape, generator=generator, device=generator.device)
    for _ in range(skip_calls * (k + 1)):
        draw()
    return [draw() for _ in range(k + 1)]


def data_rows(n: int, data_seed: int, count: int) -> np.ndarray:
    """The first ``count`` row indices of the train stream over ``n`` rows."""
    out, epoch = [], 0
    while sum(len(o) for o in out) < count:
        out.append(np.random.default_rng(np.random.SeedSequence([data_seed, epoch])).permutation(n))
        epoch += 1
    return np.concatenate(out)[:count]


def to_unit(u8: np.ndarray) -> np.ndarray:
    """uint8 images to f32 in [-1, 1]: ``u8 * 2/255 - 1``."""
    return u8.astype(np.float32) * (2.0 / 255.0) - 1.0
