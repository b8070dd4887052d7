"""K4f: fused LayerNorm + adaLN modulate forward, a Triton kernel for Hopper.

Counterpart of ``bsi_tpu/ops/ln_modulate.py`` (the ``pallas_call`` of
``_fwd_kernel`` in ``_fwd_pallas``). It computes, over ``[B, S, D]`` tokens
with per-image ``[B, D]`` conditioning,

    out = shift[:, None, :] + (scale[:, None, :] + 1) * LayerNorm(x)

where the LayerNorm has no affine, eps 1e-6, and two-pass f32 statistics
(mean, then the mean of the centred squares); the result is cast to x's
dtype. ``_reference_math`` is its plain PyTorch version.

Dispatch follows the JAX package: a CUDA tensor of a shape the TPU kernel
takes (``_kernel_applicable``) runs K4f, anything else the plain version,
whose backward is autograd through it, as JAX's fallback VJP. The kernel's
backward (K4b) is not ported yet, so a backward through K4f raises.

Design: the bound on an H100 is memory, one read of x and one write of the
output (67.4 MB at DiT-L/2's [64, 256, 1024] bf16, 20 us at 3.35 TB/s). A
program holds ``ROWS`` whole token rows of one image in registers, reduces
their statistics there, and reads that image's shift and scale once, at any
strides (the DiT passes column slices of its adaLN output).
"""

from __future__ import annotations

import functools

import torch

_EPS = 1e-6
# Elements of x one program holds.
_TILE_ELEMS = 4096


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


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def layernorm_modulate_cuda(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Launch K4f on a contiguous CUDA ``[B, S, D]`` x (bf16 or f32) with
    ``shift`` and ``scale`` of shape ``[B, D]`` in x's dtype, at any strides.
    Raises on anything else."""
    if not (x.is_cuda and shift.device == x.device and scale.device == x.device):
        raise ValueError("layernorm_modulate_cuda needs x, shift, scale on one CUDA device")
    if x.dtype not in (torch.bfloat16, torch.float32) or shift.dtype != x.dtype or scale.dtype != x.dtype:
        raise ValueError(f"layernorm_modulate_cuda takes bf16 or f32, got {x.dtype}, {shift.dtype}, {scale.dtype}")
    if x.ndim != 3 or shift.shape != (x.shape[0], x.shape[2]) or scale.shape != shift.shape or x.numel() == 0:
        raise ValueError(f"layernorm_modulate_cuda: bad shapes x {tuple(x.shape)}, shift "
                         f"{tuple(shift.shape)}, scale {tuple(scale.shape)}")
    if not x.is_contiguous():
        raise ValueError("layernorm_modulate_cuda needs a contiguous x")
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


class _LayerNormModulate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shift, scale):
        return layernorm_modulate_cuda(x, shift, scale)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "the backward of K4f is K4b (ln_modulate _bwd_pallas), which is not ported yet")


def layernorm_modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``shift + (scale + 1) * LayerNorm(x)`` over ``[B, S, D]`` tokens with
    per-image ``[B, D]`` conditioning.

    A CUDA tensor of a shape the kernel takes runs K4f (forward only: its
    backward raises until K4b is ported); anything else runs the plain
    version, differentiable by autograd.
    """
    if _kernel_applicable(x):
        return _LayerNormModulate.apply(x.contiguous(), shift, scale)
    return _reference_math(x, shift, scale)
