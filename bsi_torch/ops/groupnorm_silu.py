"""K7: fused GroupNorm + SiLU, forward and backward, CUDA C++ kernels for Hopper.

Counterpart of ``bsi_tpu/ops/groupnorm_silu.py`` (the ``pallas_call``s of
``_fwd_kernel`` and ``_bwd_kernel``). The forward (K7f) computes
``silu(GroupNorm(x) * gamma + beta)`` over ``[B, rows, C]`` (rows =
flattened pixels, channels last) with f32 one-pass
statistics (E[x^2] - E[x]^2), eps 1e-6, the affine in f32, then a cast to
the input dtype and SiLU in that dtype. ``_reference_math`` is its plain
PyTorch version. The backward (K7b) is the closed-form VJP the JAX kernel
computes, with the group statistics recomputed from x and z in f32 (not
rounded as the forward rounds it): ``dz = g * silu'(z)``, per-image partials
``dgamma_b = sum_rows dz * xhat`` and ``dbeta_b = sum_rows dz``, and ``dx =
rstd * (dxhat - mean_g(dxhat) - xhat * mean_g(dxhat * xhat))`` with ``dxhat
= dz * gamma``; ``_bwd_math`` is its plain version. The wrapper sums the
partials over the batch, as the JAX package sums outside its kernel.

Dispatch departs from the JAX package on purpose. There the kernel is
opt-in, because on the TPU it lost to XLA fusing the plain math into a
reduce pass and one elementwise pass. Eager PyTorch fuses nothing: the plain
version makes several full passes over a 16-33 MB activation. So every CUDA
tensor runs the kernel, and there is no switch.

What bounds them on an H100 is memory: one read of x (and of g) and one
write of the output (33.5 MB at [64, 1024, 128] bf16, 10 us at 3.35 TB/s;
the backward 100.7 MB at [128, 1024, 128], 30 us). A group's statistics
need all its rows before any row can be written, so a kernel that cannot
keep a group on chip reads x (and g) more than once. The design (``csrc/groupnorm_silu.cu``) keeps it on
chip: a slab, one image x 128 bytes of every row (64 bf16 or 32 f32
channels, whole groups), is split by rows across a thread block cluster of
1-8 CTAs, each holding its share resident in shared memory, loaded by TMA
with every chunk in flight at once. The CTAs exchange per-channel partial
sums through distributed shared memory, in rank order (no atomics: two
launches give the same bits), then normalise from shared memory and send
each chunk out by TMA store as soon as it is done. ``plan`` picks the slab
width, chunk rows and cluster size: the smallest cluster whose share fits
64 KB of shared memory a CTA (three CTAs an SM), doubled while the launch
would leave more than half the SMs idle. A slab that 8 CTAs cannot hold raises
``ValueError``; there is no other route. What holds them from the bound:
the CTAs of a wave load together and then compute together, so the
arithmetic (a sigmoid an element forward, two backward, on the MUFU at a
quarter of the FMA rate) is not hidden under memory traffic; the forward
reaches about half its bound, the backward 37-45 % (PERF.md).

The backward takes g in any strides: one that is not contiguous is copied
first, and ``groupnorm_silu_bwd_cuda.g_copies`` counts the copies (none on
the UNet's paths, where g comes channels-last from the convolution).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from bsi_torch.utils import profiling

from . import _build

SOURCE = "groupnorm_silu.cu"
_EPS = 1e-6
# CTA threads, as csrc/groupnorm_silu.cu has them.
_THREADS = 256
_WARPS = _THREADS // 32
# The dynamic shared memory one block may take on an H100 (227 KB).
SMEM_LIMIT = 232448
_MAX_CLUSTER = 8
# The largest share of a slab a CTA takes where a larger cluster can halve
# it: three CTAs share an SM's 228 KB.
_CTA_SHARE = 64 * 1024
# Bytes of one slab row, and of one chunk of it (a TMA box, one mbarrier).
_ROW_BYTES = 128
_CHUNK_BYTES = 8192
_SMS = 132  # an H100 SXM's


def _reference_math(x3, gamma, beta, groups: int):
    ct = torch.promote_types(x3.dtype, torch.float32)
    b, rows, c = x3.shape
    xg = x3.to(ct).reshape(b, rows, groups, c // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg * xg).mean(dim=(1, 3), keepdim=True) - mean * mean
    rstd = torch.rsqrt(var + _EPS)
    gamma_g = gamma.to(ct).reshape(1, 1, groups, c // groups)
    beta_g = beta.to(ct).reshape(1, 1, groups, c // groups)
    z = ((xg - mean) * (rstd * gamma_g) + beta_g).reshape(b, rows, c)
    z = z.to(x3.dtype)  # silu in the input dtype, like GroupNorm -> silu
    return z * torch.sigmoid(z)


def _bwd_math(x3, gamma, beta, g, groups: int):
    """The closed-form VJP of ``_reference_math`` with z in f32, as the JAX
    backward kernel computes it. Returns ``(dx, dgamma, dbeta)``: dx in x's
    dtype, dgamma and dbeta summed over the batch in gamma's dtype."""
    ct = torch.promote_types(x3.dtype, torch.float32)
    b, rows, c = x3.shape
    cg = c // groups
    xg = x3.to(ct).reshape(b, rows, groups, cg)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg * xg).mean(dim=(1, 3), keepdim=True) - mean * mean
    rstd = torch.rsqrt(var + _EPS)
    xhat = ((xg - mean) * rstd).reshape(b, rows, c)
    z = xhat * gamma.to(ct) + beta.to(ct)
    sig = torch.sigmoid(z)
    dz = g.to(ct) * (sig * (1.0 + z * (1.0 - sig)))
    dgamma = (dz * xhat).sum(dim=(0, 1))
    dbeta = dz.sum(dim=(0, 1))
    dxhat = (dz * gamma.to(ct)).reshape(b, rows, groups, cg)
    xhat = xhat.reshape(b, rows, groups, cg)
    m1 = dxhat.mean(dim=(1, 3), keepdim=True)
    m2 = (dxhat * xhat).mean(dim=(1, 3), keepdim=True)
    dx = (rstd * (dxhat - m1 - xhat * m2)).reshape(b, rows, c)
    return dx.to(x3.dtype), dgamma.to(gamma.dtype), dbeta.to(beta.dtype)


class Plan(NamedTuple):
    """How the kernels cut ``[B, rows, C]``: ``slabs`` slabs of one image x
    ``width`` channels x all rows, each cut into ``chunks`` TMA boxes of
    ``chunk_rows`` rows and split across a cluster of ``cluster`` CTAs, each
    CTA taking ``smem_bytes`` of dynamic shared memory."""

    width: int
    chunk_rows: int
    chunks: int
    cluster: int
    slabs: int
    smem_bytes: int


def _smem_bytes(backward: bool, size: int, chunks: int, cluster: int, chunk_rows: int, width: int) -> int:
    """A CTA's dynamic shared memory, as ``csrc/groupnorm_silu.cu``'s
    ``Layout`` lays it out: its chunks of x (and g), an mbarrier a chunk
    (rounded up to 128 bytes), a buffer of per-channel partials an exchange,
    the warps' per-channel sums, per-channel constants and 1,024 bytes to
    align the base."""
    tensors = 2 if backward else 1
    per_cta = -(-chunks // cluster)
    return (1024 + per_cta * tensors * chunk_rows * width * size + -(-8 * tensors * per_cta // 128) * 128
            + tensors * width * 8 + _WARPS * width * 8 + width * 16)


@functools.cache
def plan(batch: int, rows: int, c: int, groups: int, dtype: torch.dtype, backward: bool = False) -> Plan:
    """The kernels' plan for ``[batch, rows, c]`` in ``dtype``: the least
    cluster whose CTAs' shares of a slab fit ``_CTA_SHARE``, doubled while
    the slabs' CTAs would leave more than half the SMs idle. Raises
    ``ValueError`` where the kernels cannot take the shape: a row stride
    that is not a multiple of 16 bytes (TMA), a slab that does not hold
    whole groups, or a slab larger than 8 CTAs' shared memory."""
    name = "groupnorm_silu_bwd_cuda" if backward else "groupnorm_silu_cuda"
    size = dtype.itemsize
    if batch < 1 or rows < 1 or groups < 1 or c % groups:
        raise ValueError(f"{name}: bad shape [{batch}, {rows}, {c}] for {groups} groups")
    if c * size % 16:
        raise ValueError(f"{name}: the row stride C x element size = {c * size} bytes is not a multiple of "
                         f"16 bytes, which TMA needs")
    width = min(c, _ROW_BYTES // size)
    row_bytes = width * size
    if c % width or width % (c // groups) or row_bytes & (row_bytes - 1):
        raise ValueError(f"{name}: C={c} with {groups} groups has no slab of whole groups in "
                         f"{_ROW_BYTES} bytes of a row or a power of two below it")
    chunk_rows = min(_CHUNK_BYTES // row_bytes, 256, -(-rows // 8) * 8)
    chunks = -(-rows // chunk_rows)
    slabs = batch * c // width
    share = lambda n: -(-chunks // n) * chunk_rows * row_bytes * (2 if backward else 1)
    cluster = 1
    while cluster < min(_MAX_CLUSTER, chunks) and (share(cluster) > _CTA_SHARE or 2 * slabs * cluster < _SMS):
        cluster *= 2
    smem = _smem_bytes(backward, size, chunks, cluster, chunk_rows, width)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: a slab of {rows} rows x {width} channels needs {smem} bytes of shared "
                         f"memory a CTA in a cluster of {cluster}, over the limit of {SMEM_LIMIT}")
    return Plan(width, chunk_rows, chunks, cluster, slabs, smem)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    lib.bsi_groupnorm_silu_fwd.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                                           + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
    lib.bsi_groupnorm_silu_fwd.restype = ctypes.c_int
    lib.bsi_groupnorm_silu_bwd.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                                           + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
    lib.bsi_groupnorm_silu_bwd.restype = ctypes.c_int
    lib.bsi_groupnorm_silu_max_clusters.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    lib.bsi_groupnorm_silu_max_clusters.restype = ctypes.c_int
    return lib


def max_active_clusters(p: Plan, dtype: torch.dtype, backward: bool = False) -> int:
    """How many clusters of plan ``p`` the card holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    lib = _lib()
    out = ctypes.c_int(0)
    code = lib.bsi_groupnorm_silu_max_clusters(int(backward), int(dtype == torch.bfloat16), p.cluster,
                                               p.smem_bytes, ctypes.byref(out))
    _build.check(lib, code, "cudaOccupancyMaxActiveClusters")
    return out.value


def _check_cuda_args(name, x3, gamma, beta, groups):
    """Raise unless x is a contiguous, 16-byte aligned CUDA ``[B, rows, C]``
    (bf16 or f32) and gamma, beta are contiguous ``[C]`` in x's dtype on its
    device."""
    if not (x3.is_cuda and gamma.device == x3.device and beta.device == x3.device):
        raise ValueError(f"{name} needs x, gamma, beta on one CUDA device")
    if x3.dtype not in (torch.bfloat16, torch.float32) or gamma.dtype != x3.dtype or beta.dtype != x3.dtype:
        raise ValueError(f"{name} takes bf16 or f32, got {x3.dtype}, {gamma.dtype}, {beta.dtype}")
    if x3.ndim != 3:
        raise ValueError(f"{name} takes [B, rows, C], got {tuple(x3.shape)}")
    b, rows, c = x3.shape
    if c % groups or gamma.shape != (c,) or beta.shape != (c,) or rows < 1 or b < 1:
        raise ValueError(f"{name}: bad shapes x {tuple(x3.shape)}, gamma "
                         f"{tuple(gamma.shape)}, beta {tuple(beta.shape)}, groups {groups}")
    if not (x3.is_contiguous() and gamma.is_contiguous() and beta.is_contiguous()):
        raise ValueError(f"{name} needs contiguous x, gamma, beta")
    if x3.data_ptr() % 16:
        raise ValueError(f"{name} needs x 16-byte aligned (TMA)")


def groupnorm_silu_cuda(x3, gamma, beta, groups: int):
    """Launch K7's forward on a contiguous CUDA ``[B, rows, C]`` (bf16 or f32)
    with ``gamma``, ``beta`` of shape ``[C]`` in x's dtype. Raises on anything else."""
    _check_cuda_args("groupnorm_silu_cuda", x3, gamma, beta, groups)
    b, rows, c = x3.shape
    p = plan(b, rows, c, groups, x3.dtype)
    out = torch.empty_like(x3)
    lib = _lib()
    with torch.cuda.device(x3.device):
        code = lib.bsi_groupnorm_silu_fwd(
            x3.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), b, rows, c, groups,
            int(x3.dtype == torch.bfloat16), p.width, p.chunk_rows, p.cluster, p.smem_bytes,
            1.0 / (rows * (c // groups)), _EPS, x3.device.index, torch.cuda.current_stream(x3.device).cuda_stream,
        )
    _build.check(lib, code, "groupnorm_silu_fwd kernel")
    groupnorm_silu_cuda.launches += 1
    return out


groupnorm_silu_cuda.launches = 0


def groupnorm_silu_bwd_cuda(x3, gamma, beta, g, groups: int):
    """Launch K7's backward (K7b): x, gamma, beta as the forward takes them and
    the output gradient ``g`` of x's shape and dtype in any strides (a ``g``
    that is not contiguous is copied first, and ``g_copies`` counts it).
    Returns ``(dx, dgamma, dbeta)`` as ``_bwd_math`` does. Raises on anything else."""
    _check_cuda_args("groupnorm_silu_bwd_cuda", x3, gamma, beta, groups)
    if g.shape != x3.shape or g.dtype != x3.dtype or g.device != x3.device:
        raise ValueError(f"groupnorm_silu_bwd_cuda: g {tuple(g.shape)} {g.dtype} on {g.device} "
                         f"does not match x {tuple(x3.shape)} {x3.dtype} on {x3.device}")
    if not g.is_contiguous() or g.data_ptr() % 16:
        g = g.contiguous()
        groupnorm_silu_bwd_cuda.g_copies += 1
    b, rows, c = x3.shape
    p = plan(b, rows, c, groups, x3.dtype, backward=True)
    dx = torch.empty_like(x3)
    partials = torch.empty(2, b, c, dtype=torch.float32, device=x3.device)  # dgamma_b, dbeta_b
    lib = _lib()
    with torch.cuda.device(x3.device):
        code = lib.bsi_groupnorm_silu_bwd(
            x3.data_ptr(), gamma.data_ptr(), beta.data_ptr(), g.data_ptr(), dx.data_ptr(), partials[0].data_ptr(),
            partials[1].data_ptr(), b, rows, c, groups, int(x3.dtype == torch.bfloat16), p.width, p.chunk_rows,
            p.cluster, p.smem_bytes, 1.0 / (rows * (c // groups)), _EPS, x3.device.index,
            torch.cuda.current_stream(x3.device).cuda_stream,
        )
    _build.check(lib, code, "groupnorm_silu_bwd kernel")
    groupnorm_silu_bwd_cuda.launches += 1
    dgamma, dbeta = partials.sum(1).to(gamma.dtype)
    return dx, dgamma, dbeta


groupnorm_silu_bwd_cuda.launches = 0
groupnorm_silu_bwd_cuda.g_copies = 0  # gradients copied to contiguous before a launch


def _forward(x3, gamma, beta, groups):
    if x3.device.type == "cpu":
        return _reference_math(x3, gamma, beta, groups)
    if x3.device.type == "cuda":
        return groupnorm_silu_cuda(x3, gamma, beta, groups)
    raise ValueError(f"groupnorm_silu has no path for device {x3.device}")


def _backward(x3, gamma, beta, g, groups):
    if x3.device.type == "cpu":
        return _bwd_math(x3, gamma, beta, g, groups)
    if x3.device.type == "cuda":
        return groupnorm_silu_bwd_cuda(x3, gamma, beta, g, groups)
    raise ValueError(f"groupnorm_silu has no backward for device {x3.device}")


class _GroupNormSiLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x3, gamma, beta, groups):
        ctx.groups = groups
        ctx.save_for_backward(x3, gamma, beta)
        return _forward(x3, gamma, beta, groups)

    @staticmethod
    def backward(ctx, g):
        x3, gamma, beta = ctx.saved_tensors
        return (*_backward(x3, gamma, beta, g, ctx.groups), None)


def groupnorm_silu(x3, gamma, beta, groups: int):
    """``silu(GroupNorm(x) * gamma + beta)`` over ``[B, rows, C]``.

    A CUDA tensor runs the kernels, forward and backward (or raises where
    they cannot take the shape); a CPU tensor runs the plain versions.
    Differentiable.
    """
    if profiling.enabled():
        profiling.count_call("K7f", "K7b", x3.device.type == "cuda", x3, gamma, beta)
    return _GroupNormSiLU.apply(x3, gamma, beta, groups)
