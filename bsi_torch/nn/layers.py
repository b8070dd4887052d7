"""Dense, convolution and GroupNorm layers with flax's numerics.

flax keeps parameters in f32 and, given a compute ``dtype``, casts the input
and the parameters to it at every call; without one it computes in the
promoted type of input and parameters. These layers do the same, and
initialise like flax's defaults (lecun-normal kernels, zero biases,
GroupNorm scale 1 and bias 0), so a port model at random weights has the
activation scale of the JAX model.

Convolutions take NCHW tensors, which the UNet keeps in
``torch.channels_last`` memory format (cuDNN's natural bf16 layout).
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from bsi_torch.ops.conv3x3 import conv3x3

# flax's lecun_normal: a normal truncated at two standard deviations, rescaled
# so the truncated distribution has variance 1 / fan_in.
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(weight: torch.Tensor) -> None:
    fan_in = weight[0].numel()
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std)


def compute_dtype(dtype, x: torch.Tensor, param: torch.Tensor) -> torch.dtype:
    return dtype if dtype is not None else torch.promote_types(x.dtype, param.dtype)


class Dense(nn.Linear):
    """flax ``nn.Dense``: ``weight`` is the transposed flax ``kernel``."""

    def __init__(self, in_features: int, out_features: int, *, dtype=None, device=None):
        super().__init__(in_features, out_features, device=device)
        self.dtype = dtype
        _lecun_normal_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(self.dtype, x, self.weight)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Conv(nn.Conv2d):
    """flax ``nn.Conv`` with "SAME" padding at stride 1, odd square kernels.

    ``weight`` is the flax HWIO ``kernel`` as OIHW. A 3x3 convolution goes
    through :func:`bsi_torch.ops.conv3x3.conv3x3` (K8f in f32 on the card).
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, *,
                 dtype=None, device=None):
        if kernel_size % 2 != 1:
            raise ValueError("SAME padding needs an odd kernel size")
        super().__init__(in_channels, out_channels, kernel_size,
                         padding=kernel_size // 2, device=device)
        self.dtype = dtype
        _lecun_normal_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(self.dtype, x, self.weight)
        x, weight, bias = x.to(dt), self.weight.to(dt), self.bias.to(dt)
        if self.kernel_size == (3, 3):
            return conv3x3(x, weight, bias)
        return F.conv2d(x, weight, bias, padding=self.padding)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis: eps 1e-6, statistics in at
    least f32 by flax's default fast variance (E[x^2] - E[x]^2, clipped at
    0), ``(x - mean) * (rsqrt(var + eps) * weight) + bias``, output in the
    compute dtype. ``weight`` is the flax ``scale``."""

    def __init__(self, num_features: int, *, dtype=None, epsilon: float = 1e-6, device=None):
        super().__init__()
        self.dtype = dtype
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        st = torch.promote_types(self.dtype if self.dtype is not None else x.dtype, torch.float32)
        xs = x.to(st)
        mean = xs.mean(dim=-1, keepdim=True)
        var = torch.clamp((xs * xs).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.epsilon) * self.weight.to(st)
        y = (x.to(torch.promote_types(x.dtype, st)) - mean) * mul + self.bias
        out_dtype = self.dtype if self.dtype is not None else torch.promote_types(x.dtype, self.weight.dtype)
        return y.to(out_dtype)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` over NCHW: f32 one-pass statistics with the
    variance clipped at 0, eps 1e-6, f32 affine, output in the compute dtype."""

    def __init__(self, num_channels: int, num_groups: int = 32, *, dtype=None,
                 epsilon: float = 1e-6, device=None):
        super().__init__()
        self.num_groups = num_groups
        self.dtype = dtype
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(num_channels, device=device))
        self.bias = nn.Parameter(torch.zeros(num_channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        g = self.num_groups
        ct = torch.promote_types(torch.promote_types(x.dtype, torch.float32), self.weight.dtype)
        xg = x.permute(0, 2, 3, 1).reshape(b, h * w, g, c // g)
        x32 = xg.to(ct)
        mean = x32.mean(dim=(1, 3), keepdim=True)
        var = torch.clamp((x32 * x32).mean(dim=(1, 3), keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.epsilon) * self.weight.to(ct).reshape(1, 1, g, c // g)
        y = (x32 - mean) * mul + self.bias.to(ct).reshape(1, 1, g, c // g)
        out_dtype = self.dtype if self.dtype is not None else torch.promote_types(x.dtype, self.weight.dtype)
        return y.to(out_dtype).reshape(b, h, w, c).permute(0, 3, 1, 2)
