"""The attention dropout mask: one int32 seed per (batch, head), from which
every attention kernel (K2, K3, K5f, K5b, K6f, K6b) regenerates the same
keep mask, so no backward needs a mask in memory.

The TPU kernels reseed the core's generator per (batch, head); the port's
kernels draw their bits from a counter-based Philox4x32-10 instead
(``csrc/packed_attention_common.cuh`` states the mapping from an element to
its bits). :func:`_philox_keep_mask` is the plain PyTorch twin of that
mapping, bit for bit.
"""

from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(m: int, x: torch.Tensor):
    """High and low 32 bits of ``m * x`` for 32-bit ``m`` and int64 ``x``
    holding 32-bit values, in int64 without overflow (x in 16-bit halves)."""
    a = m * (x & 0xFFFF)
    b = m * (x >> 16)
    t = a + ((b & 0xFFFF) << 16)
    return (b >> 16) + (t >> 32), t & _U32


def _philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors holding 32-bit values (broadcasting)."""
    for round_ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        if round_ < 9:
            k0 = (k0 + _PHILOX_W[0]) & _U32
            k1 = (k1 + _PHILOX_W[1]) & _U32
    return c0, c1, c2, c3


def keep_threshold(keep_prob: float) -> int:
    """The 32-bit threshold below which a draw keeps its element, as the TPU
    kernels' ``_keep_mask`` has it."""
    return min(int(round(keep_prob * 4294967296.0)), _U32)


def _philox_keep_mask(seeds: torch.Tensor, seq: int, keep_prob: float, *, chunk: int = 64) -> torch.Tensor:
    """The kernels' keep mask, bool ``[B, H, S, S]`` on ``seeds``' device,
    from int32 ``seeds [B, H]`` (``[B*H, S, S]`` from the flat ``[B*H]``
    that K5f and K5b take): element (b, h, i, j) is kept where word
    ``2 * ((i >> 3) & 1) + (j & 1)`` of Philox4x32-10 with counter
    ``(j >> 1, i & ~8, 0, 0)`` and key ``(seeds[b, h], 0)`` lies below
    :func:`keep_threshold`. Computed ``chunk`` heads at a time, in int64."""
    dev = seeds.device
    flat = seeds.reshape(-1).to(torch.int64) & _U32
    i = torch.arange(seq, device=dev, dtype=torch.int64)
    c1 = (i & ~8)[None, :, None]
    c0 = torch.arange((seq + 1) // 2, device=dev, dtype=torch.int64)[None, None, :]
    upper = ((i >> 3) & 1).bool()[None, :, None]
    threshold = keep_threshold(keep_prob)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    out = []
    for start in range(0, flat.numel(), chunk):
        key = flat[start:start + chunk, None, None]
        w0, w1, w2, w3 = _philox4x32_10(c0, c1, zero, zero, key, zero)
        even = torch.where(upper, w2, w0)  # column j even
        odd = torch.where(upper, w3, w1)
        bits = torch.stack([even, odd], dim=-1).reshape(key.shape[0], seq, -1)[..., :seq]
        out.append(bits < threshold)
    return torch.cat(out).reshape(*seeds.shape, seq, seq)


def keep_probe(batch: int, heads: int, seq: int, head_dim: int, dtype, device,
               generator: torch.Generator | None = None):
    """Attention inputs ``[B, H, S, D]`` whose output reads out the keep mask.

    q = 0, so every probability is 1/S whatever k is (k is drawn from
    ``generator``); v at key j is the one-hot of column j mod D. Under a
    keep mask the output at (row, c) is the number of kept keys j = c mod D
    over ``S * keep_prob`` (:func:`keep_probe_counts`), exact up to the
    output's rounding, so one flipped keep bit moves an element by
    ``1 / (S * keep_prob)``: 4.1e-3 at S = 256 and keep_prob 0.95, where
    bf16 rounding moves it by less than 1e-4.
    """
    q = torch.zeros(batch, heads, seq, head_dim, dtype=dtype, device=device)
    k = torch.randn(batch, heads, seq, head_dim, generator=generator, device=device).to(dtype)
    one_hot = torch.nn.functional.one_hot(torch.arange(seq, device=device) % head_dim, head_dim)
    v = one_hot.to(dtype).expand(batch, heads, seq, head_dim).contiguous()
    return q, k, v


def keep_probe_counts(keeps: torch.Tensor, head_dim: int, keep_prob: float) -> torch.Tensor:
    """The attention output of :func:`keep_probe`'s inputs under bool
    ``keeps [..., S, S]``: f32 ``[..., S, D]``, the kept keys j = c mod D of
    each row over ``S * keep_prob``."""
    seq = keeps.shape[-1]
    one_hot = torch.nn.functional.one_hot(torch.arange(seq, device=keeps.device) % head_dim, head_dim)
    return torch.matmul(keeps.float(), one_hot.float()) / (seq * keep_prob)


def keep_probe_bwd(batch: int, heads: int, seq: int, head_dim: int, dtype, device):
    """Backward inputs ``[B, H, S, D]`` (q, k, v, dO) whose gradients read out
    the keep mask.

    q = 0, so every probability is 1/S; k at key j is the one-hot of column
    j mod D, v is ones, dO at query i the one-hot of column i mod D. Under a
    keep mask dV[j, c] counts the kept queries i = c mod D of key j and
    dQ[i, c] the kept keys j = c mod D of row i (:func:`keep_probe_bwd_counts`),
    so the dV of a backward reads the mask as its key-major kernel sees it
    and the dQ as its query-major kernel does: one flipped keep bit moves dV
    by 1 / (S keep_prob) and dQ by scale / (S keep_prob), 5.1e-4 at S = 256,
    D = 64 and keep_prob 0.95, where bf16 rounding moves it by < 1e-5.
    """
    one_hot = torch.nn.functional.one_hot(torch.arange(seq, device=device) % head_dim, head_dim).to(dtype)
    q = torch.zeros(batch, heads, seq, head_dim, dtype=dtype, device=device)
    k = one_hot.expand(batch, heads, seq, head_dim).contiguous()
    v = torch.ones(batch, heads, seq, head_dim, dtype=dtype, device=device)
    return q, k, v, k.clone()


def keep_probe_bwd_counts(keeps: torch.Tensor, head_dim: int, keep_prob: float, scale: float):
    """dq and dv (f32 ``[..., S, D]``) of :func:`keep_probe_bwd`'s inputs under
    bool ``keeps [..., S, S]``: with P = 1/S, out = kept_i / (S keep_prob) in
    every column, delta_i = out_i and dS_ij = (keep_ij / keep_prob - delta_i)
    / S, dQ = dS K scale and dV = Pd^T dO."""
    seq = keeps.shape[-1]
    one_hot = torch.nn.functional.one_hot(torch.arange(seq, device=keeps.device) % head_dim, head_dim).float()
    kept = keeps.float()
    delta = kept.sum(dim=-1, keepdim=True) / (seq * keep_prob)
    ds = (kept / keep_prob - delta) / seq
    return torch.matmul(ds, one_hot) * scale, torch.matmul(kept.transpose(-1, -2), one_hot) / (seq * keep_prob)


def draw_seeds(batch: int, heads: int, device, generator: torch.Generator | None = None) -> torch.Tensor:
    """One int32 dropout seed per (batch, head), ``[batch, heads]``, as the
    JAX package draws them (``randint(0, 2**31 - 1)``), from ``generator``
    (the device's default one when None)."""
    return torch.randint(0, 2**31 - 1, (batch, heads), dtype=torch.int32, device=device, generator=generator)


def _keeps(seeds, seq: int, rate: float):
    """The plain versions' keep mask at ``rate`` from ``seeds [B, H]``, or
    None at rate 0."""
    if rate == 0.0:
        return None
    if seeds is None:
        raise ValueError("attention dropout needs seeds")
    return _philox_keep_mask(seeds, seq, 1.0 - rate)


def kernel_dropout_args(name: str, seeds, rate: float, shape: tuple, device):
    """(seeds pointer, threshold, 1 / keep_prob) for an attention kernel's C
    entry: no seeds and keep_prob 1 at rate 0, else contiguous int32 seeds
    of ``shape`` on ``device``. Raises on anything else."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"{name}: dropout rate {rate} not in [0, 1)")
    if rate == 0.0:
        return None, _U32, 1.0
    if (seeds is None or seeds.dtype != torch.int32 or tuple(seeds.shape) != tuple(shape)
            or seeds.device != device or not seeds.is_contiguous()):
        raise ValueError(f"{name}: dropout needs contiguous int32 seeds of shape {tuple(shape)} on {device}")
    keep = 1.0 - rate
    return seeds.data_ptr(), keep_threshold(keep), 1.0 / keep
