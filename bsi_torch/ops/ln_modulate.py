"""K4f and K4b: fused LayerNorm + adaLN modulate, forward and backward,
kernels for Hopper (K4f in Triton, K4b in CUDA C++).

Counterpart of ``bsi_tpu/ops/ln_modulate.py`` (the ``pallas_call``s of
``_fwd_kernel`` in ``_fwd_pallas`` and of ``_bwd_kernel`` in
``_bwd_pallas``). The forward computes, over ``[B, S, D]`` tokens with
per-image ``[B, D]`` conditioning,

    out = shift[:, None, :] + (scale[:, None, :] + 1) * LayerNorm(x)

where the LayerNorm has no affine, eps 1e-6, and two-pass f32 statistics
(mean, then the mean of the centred squares); the result is cast to x's
dtype. ``_reference_math`` is its plain PyTorch version. The backward (K4b)
returns dx, dshift and dscale in one pass: per token row, with the
statistics recomputed and n = LayerNorm(x), dn = g * (1 + scale),

    dx = rstd * (dn - mean(dn) - n * mean(dn * n));

per image, dshift = sum_s g and dscale = sum_s g * n, cast to scale's dtype.
``_bwd_math`` is its plain version.

Dispatch follows the JAX package: a CUDA tensor of a shape the TPU kernel
takes (``_kernel_applicable``) runs K4f and, for its gradient, K4b;
anything else the plain version, whose backward is autograd through it, as
JAX's fallback VJP.

Design: the bound on an H100 is memory. K4f reads x and writes the output
once (67.4 MB at DiT-L/2's [64, 256, 1024] bf16, 20 us at 3.35 TB/s): a
program holds ``ROWS`` whole token rows of one image in registers, reduces
their statistics there, and reads that image's shift and scale once, at any
strides (the DiT passes column slices of its adaLN output). K4b reads x and
g and writes dx once (100.7 MB, 30 us); ``csrc/ln_modulate.cu`` streams an
image's rows through a TMA ring to warps that take one row each, and sums
dshift and dscale over the image inside the same launch, across a thread
block cluster (``plan`` cuts the work; the source says how).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from bsi_torch.utils import profiling

from . import _build

SOURCE = "ln_modulate.cu"
_EPS = 1e-6
# Elements of x one K4f program holds.
_TILE_ELEMS = 4096
# K4b's CTA, as csrc/ln_modulate.cu has it: eight warps, in the TMA body
# seven consumers (one row each a tile) and one producer; the plain body's
# tiles are 32 rows.
_CWARPS = 7
_PLAIN_ROWS = 32
# The dynamic shared memory one block may take on an H100 (227 KB).
SMEM_LIMIT = 232448
_MAX_CLUSTER = 8
# A TMA box (32 lanes x 16 bytes of a row), and the widest row whose
# columns' partials and scale a lane holds in registers.
_BOX_BYTES = 512
_MAX_TMA_D = 1024
# The ring's room a CTA (one CTA an SM), and its most stages.
_RING_BYTES = 96 * 1024
_MAX_STAGES = 8
_SMS = 132  # an H100 SXM's


def _ln(x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    xc = x - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + _EPS)


def _reference_math(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``shift + (scale + 1) * LayerNorm(x)`` with statistics in at least f32."""
    ct = torch.promote_types(x.dtype, torch.float32)
    out = shift.to(ct)[:, None, :] + (scale.to(ct)[:, None, :] + 1.0) * _ln(x.to(ct))
    return out.to(x.dtype)


def _bwd_math(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor):
    """Plain version of K4b, the TPU kernel's ``_bwd_kernel``: ``(dx, dshift,
    dscale)`` of :func:`_reference_math` for the output gradient ``g``, in
    at least f32, dx in x's dtype and the other two in scale's."""
    ct = torch.promote_types(x.dtype, torch.float32)
    x32, g32 = x.to(ct), g.to(ct)
    mean = x32.mean(dim=-1, keepdim=True)
    xc = x32 - mean
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + _EPS)
    norm = xc * rstd
    dshift = g32.sum(dim=1)
    dscale = (g32 * norm).sum(dim=1)
    dn = g32 * (scale.to(ct)[:, None, :] + 1.0)
    m1 = dn.mean(dim=-1, keepdim=True)
    m2 = (dn * norm).mean(dim=-1, keepdim=True)
    dx = rstd * (dn - m1 - norm * m2)
    return dx.to(x.dtype), dshift.to(scale.dtype), dscale.to(scale.dtype)


def _shape_applicable(seq: int, d: int) -> bool:
    # lane/sublane-friendly and VMEM-sized on the TPU; the port keeps the rule
    return d % 128 == 0 and seq % 8 == 0 and seq * d * 4 * 3 <= 12 * 2**20


def _kernel_applicable(x: torch.Tensor) -> bool:
    """The JAX package's ``_use_pallas`` with "tpu" read as "cuda"."""
    return x.device.type == "cuda" and x.ndim == 3 and _shape_applicable(x.shape[1], x.shape[2])


@functools.cache
def _kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def ln_mod_fwd(
        x_ptr, shift_ptr, scale_ptr, out_ptr, S, D, sh_b, sh_d, sc_b, sc_d, inv_d, eps,
        ROWS: tl.constexpr, BLOCK_D: tl.constexpr,
    ):
        b = tl.program_id(1).to(tl.int64)
        r = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
        c = tl.arange(0, BLOCK_D)
        cmask = c < D
        mask = (r < S)[:, None] & cmask[None, :]
        offs = (b * S + r[:, None]) * D + c[None, :]
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        mean = tl.sum(x, axis=1) * inv_d
        xc = tl.where(mask, x - mean[:, None], 0.0)
        var = tl.sum(xc * xc, axis=1) * inv_d
        rstd = 1.0 / tl.sqrt(var + eps)
        shift = tl.load(shift_ptr + b * sh_b + c * sh_d, mask=cmask, other=0.0).to(tl.float32)
        scale = tl.load(scale_ptr + b * sc_b + c * sc_d, mask=cmask, other=0.0).to(tl.float32)
        out = shift[None, :] + (scale[None, :] + 1.0) * (xc * rstd[:, None])
        tl.store(out_ptr + offs, out.to(out_ptr.dtype.element_ty), mask=mask)

    return ln_mod_fwd


class Plan(NamedTuple):
    """How K4b cuts ``[B, S, D]``: each image's rows in ``tiles`` tiles of
    ``rows`` rows, split across a cluster of ``cluster`` CTAs; ``tma``
    says which body runs (``lane_vectors`` 16-byte column vectors a lane of
    a row, 0 for the plain body), with ``stages`` ring stages, each CTA
    taking ``smem_bytes`` of dynamic shared memory."""

    tma: bool
    lane_vectors: int
    rows: int
    tiles: int
    stages: int
    cluster: int
    smem_bytes: int


def _tile_bytes(size: int, d: int) -> int:
    """A ring tile of one tensor: boxes of 512 bytes of each of its rows,
    enough to cover a row (TMA reads columns past D as zero)."""
    return -(-d * size // _BOX_BYTES) * _CWARPS * _BOX_BYTES


def _smem_bytes(tma: bool, size: int, d: int, stages: int) -> int:
    """A CTA's dynamic shared memory, as ``csrc/ln_modulate.cu``'s ``Layout``
    lays it out. TMA body: the ring (each stage a tile of x and one of g),
    which then holds the consumer warps' column partials (8 bytes a column
    a warp), whichever is larger, and two mbarriers a stage. Plain body: the
    column partials and a tile's row statistics. Both: 128 bytes to align
    the base."""
    if not tma:
        return d * 8 + _PLAIN_ROWS * 8 + 128
    return max(2 * stages * _tile_bytes(size, d), _CWARPS * d * 8) + 16 * stages + 128


@functools.cache
def plan(batch: int, seq: int, d: int, dtype: torch.dtype) -> Plan:
    """K4b's plan for ``[batch, seq, d]`` in ``dtype``. Rows of a stride TMA
    takes (a multiple of 16 bytes) and at most 1,024 wide run the TMA body,
    in tiles of one row a consumer warp, with as many ring stages as 96 KB
    hold (at least 2, at most 8 and a CTA's tiles); other rows the plain
    body, in tiles of 32. The cluster of an image's CTAs doubles, up to 8
    and the image's tiles, while the doubled grid would still hold at most
    one CTA an SM. Raises ``ValueError`` on an empty shape and where the
    plain body's column partials (8 bytes a column) pass the shared
    memory."""
    size = dtype.itemsize
    if batch < 1 or seq < 1 or d < 1:
        raise ValueError(f"layernorm_modulate_bwd_cuda: bad shape [{batch}, {seq}, {d}]")
    tma = d * size % 16 == 0 and d <= _MAX_TMA_D
    rows = _CWARPS if tma else _PLAIN_ROWS
    tiles = -(-seq // rows)
    cluster = 1
    while 2 * cluster <= min(_MAX_CLUSTER, tiles) and 2 * batch * cluster <= _SMS:
        cluster *= 2
    lane_vectors, stages = 0, 0
    if tma:
        lane_vectors = 1 << (-(-d * size // _BOX_BYTES) - 1).bit_length()
        fit = max(2, _RING_BYTES // (2 * _tile_bytes(size, d)))
        stages = max(1, min(_MAX_STAGES, -(-tiles // cluster), fit))
    smem = _smem_bytes(tma, size, d, stages)
    if smem > SMEM_LIMIT:
        raise ValueError(f"layernorm_modulate_bwd_cuda: rows of {d} columns need {smem} bytes of shared memory "
                         f"a CTA, over the limit of {SMEM_LIMIT}")
    return Plan(tma, lane_vectors, rows, tiles, stages, cluster, smem)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    lib.bsi_ln_modulate_bwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 2
                                        + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.bsi_ln_modulate_bwd.restype = ctypes.c_int
    lib.bsi_ln_modulate_bwd_max_clusters.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    lib.bsi_ln_modulate_bwd_max_clusters.restype = ctypes.c_int
    return lib


def max_active_clusters(p: Plan, d: int, dtype: torch.dtype) -> int:
    """How many clusters of K4b's plan ``p`` for rows of ``d`` the card holds
    at once (``cudaOccupancyMaxActiveClusters``)."""
    lib = _lib()
    out = ctypes.c_int(0)
    code = lib.bsi_ln_modulate_bwd_max_clusters(int(dtype == torch.bfloat16), int(p.tma), d, p.cluster,
                                                p.smem_bytes, ctypes.byref(out))
    _build.check(lib, code, "cudaOccupancyMaxActiveClusters")
    return out.value


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _check_cuda(name: str, x: torch.Tensor, cond: torch.Tensor, scale: torch.Tensor) -> None:
    """Raise unless x is a contiguous CUDA ``[B, S, D]`` (bf16 or f32) and
    ``cond`` and ``scale`` are ``[B, D]`` in x's dtype on its device."""
    if not (x.is_cuda and cond.device == x.device and scale.device == x.device):
        raise ValueError(f"{name} needs its tensors on one CUDA device")
    if x.dtype not in (torch.bfloat16, torch.float32) or cond.dtype != x.dtype or scale.dtype != x.dtype:
        raise ValueError(f"{name} takes bf16 or f32, got {x.dtype}, {cond.dtype}, {scale.dtype}")
    if x.ndim != 3 or cond.shape != (x.shape[0], x.shape[2]) or scale.shape != cond.shape or x.numel() == 0:
        raise ValueError(f"{name}: bad shapes x {tuple(x.shape)}, {tuple(cond.shape)}, {tuple(scale.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} needs a contiguous x")


def layernorm_modulate_cuda(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Launch K4f on a contiguous CUDA ``[B, S, D]`` x (bf16 or f32) with
    ``shift`` and ``scale`` of shape ``[B, D]`` in x's dtype, at any strides.
    Raises on anything else."""
    _check_cuda("layernorm_modulate_cuda", x, shift, scale)
    b, seq, d = x.shape
    block_d = _next_pow2(d)
    rows = max(1, _TILE_ELEMS // block_d)
    out = torch.empty_like(x)
    kernel = _kernel()
    with torch.cuda.device(x.device):
        layernorm_modulate_cuda.compiled = kernel[(-(-seq // rows), b)](
            x, shift, scale, out, seq, d, *shift.stride(), *scale.stride(), 1.0 / d, _EPS,
            ROWS=rows, BLOCK_D=block_d, num_warps=8,
        )
    layernorm_modulate_cuda.launches += 1
    return out


layernorm_modulate_cuda.launches = 0
layernorm_modulate_cuda.compiled = None  # the last launch's compiled kernel (registers, spills)


def layernorm_modulate_bwd_cuda(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor):
    """Launch K4b: x as K4f takes it, ``scale`` ``[B, D]`` at any strides and
    the output gradient ``g`` of x's shape and dtype (x and g 16-byte aligned
    where the plan's body is TMA's). Returns ``(dx, dshift, dscale)`` as
    ``_bwd_math`` does, from one kernel. Raises on anything else."""
    _check_cuda("layernorm_modulate_bwd_cuda", x, scale, scale)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device or not g.is_contiguous():
        raise ValueError(f"layernorm_modulate_bwd_cuda: g {tuple(g.shape)} {g.dtype} on {g.device} "
                         f"is not a contiguous match of x {tuple(x.shape)} {x.dtype}")
    b, seq, d = x.shape
    p = plan(b, seq, d, x.dtype)
    if p.tma and (x.data_ptr() % 16 or g.data_ptr() % 16):
        raise ValueError("layernorm_modulate_bwd_cuda needs x and g 16-byte aligned (TMA)")
    dx = torch.empty_like(x)
    dshift = torch.empty(b, d, dtype=scale.dtype, device=x.device)
    dscale = torch.empty_like(dshift)
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.bsi_ln_modulate_bwd(
            x.data_ptr(), scale.data_ptr(), g.data_ptr(), dx.data_ptr(), dshift.data_ptr(), dscale.data_ptr(),
            b, seq, d, *scale.stride(), int(x.dtype == torch.bfloat16), int(p.tma), p.rows, p.stages, p.cluster,
            p.smem_bytes, _EPS, x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(lib, code, "ln_modulate_bwd kernel")
    layernorm_modulate_bwd_cuda.launches += 1
    return dx, dshift, dscale


layernorm_modulate_bwd_cuda.launches = 0


class _LayerNormModulate(torch.autograd.Function):
    """K4f forward, K4b backward; saves x and scale, as JAX's VJP does."""

    @staticmethod
    def forward(ctx, x, shift, scale):
        ctx.save_for_backward(x, scale)
        return layernorm_modulate_cuda(x, shift, scale)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        return layernorm_modulate_bwd_cuda(x, scale, g.contiguous())


def layernorm_modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``shift + (scale + 1) * LayerNorm(x)`` over ``[B, S, D]`` tokens with
    per-image ``[B, D]`` conditioning.

    A CUDA tensor of a shape the kernels take runs K4f, and K4b for its
    gradient; anything else runs the plain version, differentiable by
    autograd.
    """
    kernel = _kernel_applicable(x)
    if profiling.enabled():
        profiling.count_call("K4f", "K4b", kernel, x, shift, scale)
    if kernel:
        return _LayerNormModulate.apply(x.contiguous(), shift, scale)
    return _reference_math(x, shift, scale)
