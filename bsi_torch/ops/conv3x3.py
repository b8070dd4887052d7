"""K8f: the f32 3x3 convolution, a CUDA C++ kernel for Hopper's CUDA cores.

``F.conv2d(x, w, b, padding=1)`` at stride 1 (flax's "SAME") in f32, on
channels-last (NHWC) maps, with a channels-last output. No TPU kernel is
replaced: the JAX package's convolutions are XLA's (``flax.linen.Conv``).
The kernel exists because cuDNN runs f32 convolutions with TF32 off by FFT,
at about a fifth of the card's f32 FFMA rate on the VDM-UNet's shapes, where
these convolutions are 95 % of a forward's operations. Its arithmetic is
f32 products summed by FFMA in one fixed order, then the bias: no TF32, no
tensor cores, no atomics (``csrc/conv3x3.cu`` says how it is laid out).

Dispatch, by what the inputs show: a CUDA f32 input with a 3x3 f32 weight
runs the kernel, after :func:`_fitted` has made it one that :func:`fits`
(the channels zero-padded to a multiple of the kernel's slab of ``K_TILE``,
as the UNet's ``encode`` with its 21 Fourier channels needs, ``Cout`` to one
of ``COUT_VECTOR``, the input in ``channels_last`` memory, 16-byte aligned);
the CPU and bf16 (the UNet's bf16 training stays on cuDNN's tensor cores)
run ``F.conv2d``. The gradients are cuDNN's
(``torch.ops.aten.convolution_backward``), as ``F.conv2d``'s are.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.nn import functional as F

from bsi_torch.utils import profiling

from . import _build

SOURCE = "conv3x3.cu"
# Input channels of one tap a slab (csrc/conv3x3.cu's kBK, which refuses any
# other Cin at the launch): Cin must be a multiple of it; Cout one of
# COUT_VECTOR, the width of the output stores.
K_TILE = 16
COUT_VECTOR = 4


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    lib.bsi_conv3x3_f32_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.bsi_conv3x3_f32_fwd.restype = ctypes.c_int
    return lib


def fits(x: torch.Tensor, weight: torch.Tensor) -> bool:
    """Whether the kernel can take this convolution, whatever the device: f32
    input ``[B, Cin, H, W]`` in ``channels_last`` memory, 16-byte aligned; an
    f32 weight ``[Cout, Cin, 3, 3]``; ``Cin`` a multiple of ``K_TILE`` and
    ``Cout`` of ``COUT_VECTOR``."""
    return (x.dtype == torch.float32 and weight.dtype == torch.float32 and x.ndim == 4 and weight.ndim == 4
            and weight.shape[1:] == (x.shape[1], 3, 3) and x.shape[1] % K_TILE == 0
            and weight.shape[0] % COUT_VECTOR == 0 and x.is_contiguous(memory_format=torch.channels_last)
            and x.data_ptr() % 16 == 0)


def conv3x3_cuda(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Launch K8f: ``F.conv2d(x, weight, bias, padding=1)`` for a CUDA input
    that :func:`fits` and a contiguous f32 ``bias`` ``[Cout]``, all on one device.
    Returns ``[B, Cout, H, W]`` in ``channels_last`` memory. Raises on
    anything else."""
    if not fits(x, weight):
        raise ValueError(f"conv3x3_cuda takes an f32 channels_last x [B, Cin, H, W] (Cin a multiple of {K_TILE}, "
                         f"16-byte aligned) and an f32 weight [Cout, Cin, 3, 3] (Cout a multiple of "
                         f"{COUT_VECTOR}); got x {tuple(x.shape)} {x.dtype}, weight {tuple(weight.shape)} "
                         f"{weight.dtype}")
    cout = weight.shape[0]
    if bias.dtype != torch.float32 or bias.shape != (cout,) or not bias.is_contiguous():
        raise ValueError(f"conv3x3_cuda takes a contiguous f32 bias [{cout}], got {tuple(bias.shape)} {bias.dtype}")
    if not (x.is_cuda and weight.device == x.device and bias.device == x.device):
        raise ValueError("conv3x3_cuda needs x, weight and bias on one CUDA device")
    b, cin, h, w = x.shape
    if b * h * w >= 2**31:
        raise ValueError(f"conv3x3_cuda: {b * h * w} pixels, over the kernel's 2**31")
    # [3, 3, Cin, Cout]: a slab's rows of the implicit GEMM's B are contiguous
    packed = weight.permute(2, 3, 1, 0).contiguous()
    out = torch.empty((b, cout, h, w), dtype=x.dtype, device=x.device, memory_format=torch.channels_last)
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.bsi_conv3x3_f32_fwd(
            x.data_ptr(), packed.data_ptr(), bias.data_ptr(), out.data_ptr(), b, h, w, cin, cout,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(lib, code, "conv3x3_f32_fwd kernel")
    conv3x3_cuda.launches += 1
    return out


conv3x3_cuda.launches = 0


class _Conv3x3(torch.autograd.Function):
    """K8f forward; cuDNN's input, weight and bias gradients backward."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        return conv3x3_cuda(x, weight, bias)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        # stride 1, padding 1, dilation 1, not transposed, one group
        return torch.ops.aten.convolution_backward(g, x, weight, [weight.shape[0]], [1, 1], [1, 1], [1, 1], False,
                                                   [0, 0], 1, list(ctx.needs_input_grad))


def _fitted(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``F.conv2d(x, weight, bias, padding=1)`` through :class:`_Conv3x3` for
    any f32 ``x`` ``[B, Cin, H, W]`` and 3x3 ``weight``: Cin is padded with
    zero channels (of ``x`` and of ``weight``) to a multiple of ``K_TILE``,
    Cout with zero filters to one of ``COUT_VECTOR`` (cut off the output),
    and ``x`` copied to ``channels_last`` memory, 16-byte aligned, where it
    is not. Differentiable; the padding adds only zero products."""
    cin, cout = weight.shape[1], weight.shape[0]
    pad_in, pad_out = -cin % K_TILE, -cout % COUT_VECTOR
    if pad_in:
        x = torch.cat([x, x.new_zeros((x.shape[0], pad_in) + x.shape[2:])], dim=1)
        weight = F.pad(weight, (0, 0, 0, 0, 0, pad_in))
    if pad_out:
        weight = F.pad(weight, (0, 0, 0, 0, 0, 0, 0, pad_out))
        bias = F.pad(bias, (0, pad_out))
    x = x.contiguous(memory_format=torch.channels_last)
    if x.data_ptr() % 16:
        x = x.clone(memory_format=torch.channels_last)
    out = _Conv3x3.apply(x, weight, bias.contiguous())
    return out[:, :cout] if pad_out else out


def conv3x3(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``F.conv2d(x, weight, bias, padding=1)`` for a 3x3 ``weight``: K8f
    for a CUDA f32 input and weight (:func:`_fitted`), else ``F.conv2d``.
    Differentiable. Counts ``ops.K8f.kernel`` or ``ops.K8f.plain`` while a
    profiler runs."""
    kernel = x.is_cuda and x.dtype == torch.float32 and weight.dtype == torch.float32
    if profiling.enabled():
        profiling.count_call("K8f", None, kernel, x, weight, bias)
    if kernel:
        return _fitted(x, weight, bias)
    return F.conv2d(x, weight, bias, padding=1)
