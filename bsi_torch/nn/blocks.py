"""Residual conv blocks and the no-resampling U-Net skeleton.

Counterpart of ``bsi_tpu/nn/blocks.py``. Feature maps are NCHW in
``torch.channels_last`` memory format, so a ``permute(0, 2, 3, 1)`` gives the
JAX package's NHWC layout as a free view; submodule names are the flax
names, so converted weights load by name.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn
from torch.nn import functional as F

from bsi_torch.ops.groupnorm_silu import groupnorm_silu

from .attention import Attention2D
from .layers import Conv, Dense, GroupNorm


def feature_modulation(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """FiLM over NCHW: ``shift + (scale + 1) * x`` with per-channel ``[B, C]`` scale/shift."""
    return shift[:, :, None, None] + (scale[:, :, None, None] + 1.0) * x


class GroupNormSiLU(nn.Module):
    """GroupNorm followed by SiLU through :func:`bsi_torch.ops.groupnorm_silu`.

    Parameters and semantics are those of flax ``nn.GroupNorm`` (scale and
    bias in f32, cast to the compute dtype before the fused op)."""

    def __init__(self, num_channels: int, num_groups: int = 32, *, dtype=None, device=None):
        super().__init__()
        self.num_groups = num_groups
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_channels, device=device))
        self.bias = nn.Parameter(torch.zeros(num_channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        dt = self.dtype or x.dtype
        x3 = x.permute(0, 2, 3, 1).reshape(b, h * w, c).to(dt)
        out = groupnorm_silu(x3, self.weight.to(dt), self.bias.to(dt), self.num_groups)
        return out.reshape(b, h, w, c).permute(0, 3, 1, 2)


class ResidualBlock(nn.Module):
    """Norm -> act -> conv3x3 -> FiLM(c) -> act -> dropout -> conv3x3 + skip,
    then with ``attention`` a tail ``out + Attention2D_0(GroupNorm_1(out))``
    over the block's own pixels.

    The tail's norm is ``GroupNorm_1``, flax's automatic name beside the
    block's ``GroupNorm_0``: with silu the JAX block names its fused norm
    ``GroupNorm_0`` explicitly and the tail's clashes with it, so flax
    builds the tail for every other activation only.
    """

    def __init__(
        self,
        dim_in: int,
        dim_out: int,
        c_dim: int,
        *,
        actfn: Callable[[torch.Tensor], torch.Tensor] = F.silu,
        groups: int = 32,
        dropout: float | None = None,
        attention: bool = False,
        attention_heads: int = 4,
        dtype=None,
        device=None,
    ):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.actfn = actfn
        self.to_scale_shift = Dense(c_dim, 2 * dim_out, **kw)
        if actfn is F.silu:
            self.GroupNorm_0 = GroupNormSiLU(dim_in, groups, **kw)
        else:
            self.GroupNorm_0 = GroupNorm(dim_in, groups, **kw)
        self.conv1 = Conv(dim_in, dim_out, 3, **kw)
        self.dropout = nn.Dropout(dropout) if dropout is not None else None
        self.conv2 = Conv(dim_out, dim_out, 3, **kw)
        self.skip = Conv(dim_in, dim_out, 1, **kw) if dim_in != dim_out else None
        if attention:
            self.GroupNorm_1 = GroupNorm(dim_out, groups, **kw)
            self.Attention2D_0 = Attention2D(dim_out, attention_heads, **kw)
        self.attention = attention

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        scale, shift = self.to_scale_shift(c).chunk(2, dim=-1)
        h = self.GroupNorm_0(x)
        if self.actfn is not F.silu:
            h = self.actfn(h)
        h = self.conv1(h)
        h = feature_modulation(h, scale, shift)
        h = self.actfn(h)
        if self.dropout is not None:
            h = self.dropout(h)
        h = self.conv2(h)
        if self.skip is not None:
            x = self.skip(x)
        out = x + h
        if self.attention:
            out = out + self.Attention2D_0(self.GroupNorm_1(out))
        return out


class SimplifiedUNet(nn.Module):
    """U-Net without down/upsampling: ``levels`` residual blocks down (each
    pushing a skip), an attention-centred bottleneck, and ``levels`` blocks up
    consuming ``cat([x, skip])``. Blocks are ``down_{i}``, ``center_in``,
    ``center_out`` and ``up_{i}``, as in flax; with
    ``downsampling_attention`` each ends in an attention tail."""

    def __init__(
        self,
        dim: int,
        levels: int,
        c_dim: int,
        *,
        actfn: Callable[[torch.Tensor], torch.Tensor] = F.silu,
        dropout: float | None = None,
        downsampling_attention: bool = False,
        attention_heads: int = 1,
        dtype=None,
        device=None,
    ):
        super().__init__()
        self.levels = levels
        block = lambda dim_in: ResidualBlock(
            dim_in, dim, c_dim, actfn=actfn, dropout=dropout, attention=downsampling_attention,
            attention_heads=attention_heads, dtype=dtype, device=device
        )
        for i in range(levels):
            self.add_module(f"down_{i}", block(dim))
        self.center_in = block(dim)
        self.GroupNorm_0 = GroupNorm(dim, 32, dtype=dtype, device=device)
        self.Attention2D_0 = Attention2D(dim, attention_heads, dtype=dtype, device=device)
        self.center_out = block(dim)
        for i in range(levels):
            self.add_module(f"up_{i}", block(2 * dim))

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        skips = []
        for i in range(self.levels):
            x = getattr(self, f"down_{i}")(x, c)
            skips.append(x)
        x = self.center_in(x, c)
        x = x + self.Attention2D_0(self.GroupNorm_0(x))
        x = self.center_out(x, c)
        for i in range(self.levels):
            x = torch.cat([x, skips.pop()], dim=1)
            x = getattr(self, f"up_{i}")(x, c)
        return x
