"""Pixel attention for the UNet.

Counterpart of ``bsi_tpu/nn/attention.py::Attention2D``. The qkv projection's
output channels use the JAX package's GROUPED layout (see
:func:`repack_qkv_grouped`), so weights converted from JAX need no reshuffle.
"""

from __future__ import annotations

import torch
from torch import nn

from bsi_torch.ops import multi_head_attention, split_qkv_grouped
from bsi_torch.ops.flash_attention_packed import qkv_heads_per_group

from .layers import Conv


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    # [B, H, S, D] -> [B, S, H*D]
    b, h, s, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, s, h * d)


def repack_qkv_grouped(w: torch.Tensor, heads: int) -> torch.Tensor:
    """Permute a reference-layout ``(qkv h c)`` packed LAST axis to the GROUPED
    ``(g qkv hpg c)`` layout, as the JAX package's function of the same name."""
    shape = w.shape
    d = shape[-1] // (3 * heads)
    hpg = qkv_heads_per_group(d, heads)
    w = w.reshape(shape[:-1] + (3, heads // hpg, hpg * d))
    w = torch.movedim(w, -3, -2)  # (qkv g x) -> (g qkv x)
    return w.reshape(shape)


class Attention2D(nn.Module):
    """Self-attention over all pixels of an NCHW feature map, with 3x3
    convolutions as the qkv and output projections."""

    def __init__(self, channels: int, heads: int = 4, *, dtype=None, device=None):
        super().__init__()
        self.heads = heads
        self.to_qkv = Conv(channels, 3 * channels, 3, dtype=dtype, device=device)
        self.to_out = Conv(channels, channels, 3, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        qkv = self.to_qkv(x).permute(0, 2, 3, 1).reshape(b, h * w, 3 * c)
        q, k, v = split_qkv_grouped(qkv, self.heads)
        out = multi_head_attention(q, k, v)
        out = _merge_heads(out).reshape(b, h, w, c).permute(0, 3, 1, 2)
        return self.to_out(out)
