"""K4f and K4b: fused LayerNorm + adaLN modulate, forward and backward,
Triton kernels for Hopper.

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
g and writes dx once (100.7 MB, 30 us): a program walks ``_BWD_CHUNKS``
blocks of ``ROWS`` rows of one image, two-pass f32 statistics per row as
``_ln``, and sums its rows' g and g * n into per-program f32 partials of
dshift and dscale, which the wrapper adds up (no atomics, as K7b does).
"""

from __future__ import annotations

import functools

import torch

_EPS = 1e-6
# Elements of x one program holds.
_TILE_ELEMS = 4096
# Row blocks one K4b program walks: its partial sums of dshift and dscale
# cover ROWS * _BWD_CHUNKS rows (32 at D = 1024).
_BWD_CHUNKS = 8


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


@functools.cache
def _bwd_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def ln_mod_bwd(
        x_ptr, scale_ptr, g_ptr, dx_ptr, dshift_ptr, dscale_ptr, S, D, sc_b, sc_d, inv_d, eps,
        ROWS: tl.constexpr, CHUNKS: tl.constexpr, BLOCK_D: tl.constexpr,
    ):
        pid = tl.program_id(0)
        b = tl.program_id(1).to(tl.int64)
        c = tl.arange(0, BLOCK_D)
        cmask = c < D
        scale1 = tl.load(scale_ptr + b * sc_b + c * sc_d, mask=cmask, other=0.0).to(tl.float32) + 1.0
        dshift = tl.zeros([BLOCK_D], dtype=tl.float32)
        dscale = tl.zeros([BLOCK_D], dtype=tl.float32)
        for chunk in range(CHUNKS):
            r = (pid * CHUNKS + chunk) * ROWS + tl.arange(0, ROWS)
            mask = (r < S)[:, None] & cmask[None, :]
            offs = (b * S + r[:, None]) * D + c[None, :]
            x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            mean = tl.sum(x, axis=1) * inv_d
            xc = tl.where(mask, x - mean[:, None], 0.0)
            rstd = 1.0 / tl.sqrt(tl.sum(xc * xc, axis=1) * inv_d + eps)
            norm = xc * rstd[:, None]
            dshift += tl.sum(g, axis=0)
            dscale += tl.sum(g * norm, axis=0)
            dn = g * scale1[None, :]
            m1 = tl.sum(dn, axis=1) * inv_d
            m2 = tl.sum(dn * norm, axis=1) * inv_d
            dx = rstd[:, None] * (dn - m1[:, None] - norm * m2[:, None])
            tl.store(dx_ptr + offs, dx.to(dx_ptr.dtype.element_ty), mask=mask)
        part = (pid * tl.num_programs(1) + b) * D + c
        tl.store(dshift_ptr + part, dshift, mask=cmask)
        tl.store(dscale_ptr + part, dscale, mask=cmask)

    return ln_mod_bwd


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
    the output gradient ``g`` of x's shape and dtype. Returns ``(dx, dshift,
    dscale)`` as ``_bwd_math`` does. Raises on anything else."""
    _check_cuda("layernorm_modulate_bwd_cuda", x, scale, scale)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device or not g.is_contiguous():
        raise ValueError(f"layernorm_modulate_bwd_cuda: g {tuple(g.shape)} {g.dtype} on {g.device} "
                         f"is not a contiguous match of x {tuple(x.shape)} {x.dtype}")
    b, seq, d = x.shape
    block_d = _next_pow2(d)
    rows = max(1, _TILE_ELEMS // block_d)
    chunks = min(_BWD_CHUNKS, -(-seq // rows))
    n_prog = -(-seq // (rows * chunks))
    dx = torch.empty_like(x)
    dshift_p = torch.empty(n_prog, b, d, dtype=torch.float32, device=x.device)
    dscale_p = torch.empty(n_prog, b, d, dtype=torch.float32, device=x.device)
    kernel = _bwd_kernel()
    with torch.cuda.device(x.device):
        layernorm_modulate_bwd_cuda.compiled = kernel[(n_prog, b)](
            x, scale, g, dx, dshift_p, dscale_p, seq, d, *scale.stride(), 1.0 / d, _EPS,
            ROWS=rows, CHUNKS=chunks, BLOCK_D=block_d, num_warps=8,
        )
    layernorm_modulate_bwd_cuda.launches += 1
    return dx, dshift_p.sum(0).to(scale.dtype), dscale_p.sum(0).to(scale.dtype)


layernorm_modulate_bwd_cuda.launches = 0
layernorm_modulate_bwd_cuda.compiled = None  # the last launch's compiled kernel (registers, spills)


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
    if _kernel_applicable(x):
        return _LayerNormModulate.apply(x.contiguous(), shift, scale)
    return _reference_math(x, shift, scale)
