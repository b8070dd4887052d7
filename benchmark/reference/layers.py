"""Plain layers of the reference: dense, convolution, the norms, attention,
Fourier features and the Nyquist embedding, in f32.

Dense weights are ``[out, in]`` and convolution weights ``OIHW``, images
NCHW inside a network and NHWC at its boundary, as the models define them.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
from torch.nn import functional as F

EPS = 1e-6  # every norm of both models
FP8_MAX = 448.0  # largest float8_e4m3fn


class Precision:
    """Rounds the operands of every product. ``"f32"`` leaves them;
    ``"fp8"`` rounds each to float8 e4m3 with one scale per tensor (its
    largest magnitude onto 448), as an fp8 matmul takes them."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "f32":
            return x
        scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        q = (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
        # rounding is a constant to autograd: the gradient passes straight through
        return x + (q - x).detach()


F32 = Precision("f32")


@contextlib.contextmanager
def tf32(enabled: bool):
    """Both TF32 flags (cuBLAS matmuls, cuDNN convolutions) set to
    ``enabled`` inside the block, restored after."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def dense(x, p: dict, name: str, q: Precision = F32):
    return F.linear(q(x), q(p[f"{name}.weight"]), p[f"{name}.bias"])


def conv(x, p: dict, name: str, q: Precision = F32):
    """'SAME' convolution at stride 1 of NCHW ``x``."""
    w = p[f"{name}.weight"]
    return F.conv2d(q(x), q(w), p[f"{name}.bias"], padding=w.shape[-1] // 2)


def layer_norm(x, weight=None, bias=None):
    """Over the last axis, eps 1e-6; affine where weight and bias are given."""
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + EPS)
    return y if weight is None else y * weight + bias


def group_norm(x, weight, bias, groups: int = 32):
    """GroupNorm of NCHW ``x`` over ``groups`` groups of channels, eps 1e-6."""
    b, c, h, w = x.shape
    xg = x.reshape(b, groups, c // groups, h, w)
    mean = xg.mean(dim=(2, 3, 4), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(2, 3, 4), keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + EPS)).reshape(b, c, h, w)
    return y * weight[None, :, None, None] + bias[None, :, None, None]


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x**3)))


def heads_per_group(head_dim: int, heads: int) -> int:
    """Heads per 128-column group of the qkv projection's output: its
    columns are ordered (group, q/k/v, head in group, head_dim), a group
    being 128 columns of each of q, k and v where whole heads tile them."""
    if head_dim < 128 and 128 % head_dim == 0 and heads % (128 // head_dim) == 0:
        return 128 // head_dim
    return 1


def split_qkv(qkv, heads: int):
    """``[B, S, 3*H*D]`` in the grouped order -> q, k, v ``[B, H, S, D]``."""
    b, s, three_hd = qkv.shape
    d = three_hd // 3 // heads
    hpg = heads_per_group(d, heads)
    x = qkv.reshape(b, s, heads // hpg, 3, hpg, d)
    return [x[:, :, :, j].reshape(b, s, heads, d).permute(0, 2, 1, 3) for j in range(3)]


def attention(q, k, v, keep=None, keep_prob: float = 1.0, prec: Precision = F32):
    """softmax(q k^T / sqrt(D)) v over ``[B, H, S, D]``; with a bool ``keep
    [B, H, S, S]`` each probability is kept where it is True and scaled by
    ``1 / keep_prob`` (dropout on the probabilities)."""
    logits = torch.matmul(prec(q), prec(k).transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    probs = torch.softmax(logits, dim=-1)
    if keep is not None:
        probs = torch.where(keep, probs / keep_prob, 0.0)
    return torch.matmul(prec(probs), prec(v))


def merge_heads(x):
    b, h, s, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, s, h * d)


def fourier_channels(cfg: dict) -> int:
    """The input's channels with its Fourier features (``cfg["fourier"]``,
    ``(n_min, n_max)`` or None) beside them."""
    c = cfg["data_shape"][-1]
    ff = cfg.get("fourier")
    return c * (1 + (2 * (ff[1] - ff[0] + 1) if ff else 0))


def fourier_features(x, n_min: int, n_max: int):
    """``sin(2 pi 2^n x + {0, pi/2})`` for n in [n_min, n_max] over the last
    axis of NHWC ``x``: ``[..., C * 2 * (n_max - n_min + 1)]``, ordered
    (channel, frequency, phase)."""
    ns = torch.arange(n_min, n_max + 1, dtype=torch.float64)
    coefs = (2 * math.pi * 2.0**ns).to(x.dtype).to(x.device)
    offsets = torch.tensor([0.0, math.pi / 2], dtype=x.dtype, device=x.device)
    return torch.sin(coefs[:, None] * x[..., None, None] + offsets).reshape(*x.shape[:-1], -1)


def _nyquist_constants(size: int, rate: int):
    """Frequencies from 1/8 up to Nyquist / (2 golden ratio), geometrically
    spaced, each as a (sin, cos) pair; rounded to f32."""
    k = size // 2
    golden = (1 + math.sqrt(5)) / 2
    freqs = np.geomspace(1 / 8, rate / 2 / (2 * golden), num=k)
    scale = np.repeat(2 * np.pi * freqs, 2).astype(np.float32)
    bias = np.tile(np.array([0.0, np.pi / 2]), k).astype(np.float32)
    return scale, bias


def nyquist(t, size: int, rate: int):
    """The Nyquist sinusoidal embedding of ``t [B]``: ``[B, size]``."""
    scale, bias = _nyquist_constants(size, rate)
    as_t = lambda a: torch.as_tensor(a, dtype=t.dtype, device=t.device)
    return torch.sin(as_t(scale) * t[:, None] + as_t(bias))


def nyquist_table_2d(hidden: int, grid: int, rate: int) -> np.ndarray:
    """The DiT's fixed 2D table, f64 ``[grid*grid, hidden]``: a row and a
    column embedding of ``linspace(0, 1, grid)`` side by side, rows major."""
    scale, bias = _nyquist_constants(hidden // 2, rate)
    emb = np.sin(scale * np.linspace(0.0, 1.0, grid)[:, None] + bias)
    return np.concatenate([np.repeat(emb, grid, axis=0), np.tile(emb, (grid, 1))], axis=1)
