"""K7 forward: fused GroupNorm + SiLU, a Triton kernel for Hopper.

Counterpart of ``bsi_tpu/ops/groupnorm_silu.py`` (the ``pallas_call`` of
``_fwd_kernel``). Computes ``silu(GroupNorm(x) * gamma + beta)`` over
``[B, rows, C]`` (rows = flattened pixels, channels last) with f32 one-pass
statistics (E[x^2] - E[x]^2), eps 1e-6, the affine in f32, then a cast to
the input dtype and SiLU in that dtype. ``_reference_math`` is its plain
PyTorch version.

Dispatch departs from the JAX package on purpose. There the kernel is
opt-in, because on the TPU it lost to XLA fusing the plain math into a
reduce pass and one elementwise pass. Eager PyTorch fuses nothing: the plain
version makes several full passes over a 16-33 MB activation. So every CUDA
tensor runs the kernel, and there is no switch.

Design: the bound on an H100 is memory, one read and one write of x
(33.5 MB at [64, 1024, 128] bf16, 10 us at 3.35 TB/s; 67 MB, 20 us at
[64, 1024, 256]). One program holds all rows of a block of channels (whole
groups) in registers, reduces the group statistics there and writes the
result, so x is read once and written once. Programs run over
(batch, channel block): 8 or 16 blocks per image, 512 or 1,024 programs at
the UNet's shapes, where one program per image would give 64 for 132 SMs.
A channel block is ``BLOCK_C`` contiguous channels of each row (32 bytes in
bf16 at 16 channels), a whole DRAM sector.

The gradient recomputes through ``_reference_math`` under autograd; the
backward kernel (K7b) comes with the training slice.
"""

from __future__ import annotations

import functools

import torch

_EPS = 1e-6
# Elements of x one program holds: rows x channels of its block.
_TILE_ELEMS = 16384


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


@functools.cache
def _kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def gn_silu_fwd(
        x_ptr, gamma_ptr, beta_ptr, out_ptr, rows, C, inv_n, eps,
        CG: tl.constexpr, BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr,
    ):
        b = tl.program_id(0).to(tl.int64)
        cb = tl.program_id(1)
        r = tl.arange(0, BLOCK_R)
        cl = tl.arange(0, BLOCK_C)
        c = cb * BLOCK_C + cl
        offs = b * rows * C + r[:, None] * C + c[None, :]
        mask = (r < rows)[:, None]
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        csum = tl.sum(x, axis=0)
        csq = tl.sum(x * x, axis=0)
        # Group sums, broadcast back to each channel of the group.
        same = (cl[:, None] // CG) == (cl[None, :] // CG)
        gsum = tl.sum(tl.where(same, csum[:, None], 0.0), axis=0)
        gsq = tl.sum(tl.where(same, csq[:, None], 0.0), axis=0)
        mean = gsum * inv_n
        var = gsq * inv_n - mean * mean
        rstd = 1.0 / tl.sqrt(var + eps)
        gamma = tl.load(gamma_ptr + c).to(tl.float32)
        beta = tl.load(beta_ptr + c).to(tl.float32)
        z = (x - mean[None, :]) * (rstd * gamma)[None, :] + beta[None, :]
        dt = out_ptr.dtype.element_ty
        z = z.to(dt).to(tl.float32)
        sig = (1.0 / (1.0 + tl.exp(-z))).to(dt).to(tl.float32)
        tl.store(out_ptr + offs, (z * sig).to(dt), mask=mask)

    return gn_silu_fwd


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _block_c(rows: int, c: int, groups: int) -> int:
    """Channels per program: whole groups, a power of two dividing C, about
    ``_TILE_ELEMS`` elements per program. Raises where none exists."""
    cg = c // groups
    block = max(_TILE_ELEMS // _next_pow2(rows), 1)
    block = min(block, c)
    while block % cg or c % block:
        if block >= c:
            raise ValueError(f"groupnorm_silu_cuda: no channel block for C={c}, groups={groups}")
        block *= 2
    if block & (block - 1):
        raise ValueError(f"groupnorm_silu_cuda: channel block {block} is not a power of two")
    return block


def groupnorm_silu_cuda(x3, gamma, beta, groups: int):
    """Launch K7's forward on a contiguous CUDA ``[B, rows, C]`` (bf16 or f32)
    with ``gamma``, ``beta`` of shape ``[C]`` in x's dtype. Raises on anything else."""
    if not (x3.is_cuda and gamma.device == x3.device and beta.device == x3.device):
        raise ValueError("groupnorm_silu_cuda needs x, gamma, beta on one CUDA device")
    if x3.dtype not in (torch.bfloat16, torch.float32) or gamma.dtype != x3.dtype or beta.dtype != x3.dtype:
        raise ValueError(f"groupnorm_silu_cuda takes bf16 or f32, got {x3.dtype}, {gamma.dtype}, {beta.dtype}")
    if x3.ndim != 3:
        raise ValueError(f"groupnorm_silu_cuda takes [B, rows, C], got {tuple(x3.shape)}")
    b, rows, c = x3.shape
    if c % groups or gamma.shape != (c,) or beta.shape != (c,) or rows < 1 or b < 1:
        raise ValueError(f"groupnorm_silu_cuda: bad shapes x {tuple(x3.shape)}, gamma "
                         f"{tuple(gamma.shape)}, beta {tuple(beta.shape)}, groups {groups}")
    if not (x3.is_contiguous() and gamma.is_contiguous() and beta.is_contiguous()):
        raise ValueError("groupnorm_silu_cuda needs contiguous x, gamma, beta")
    block_c = _block_c(rows, c, groups)
    out = torch.empty_like(x3)
    kernel = _kernel()
    with torch.cuda.device(x3.device):
        kernel[(b, c // block_c)](
            x3, gamma, beta, out, rows, c, 1.0 / (rows * (c // groups)), _EPS,
            CG=c // groups, BLOCK_R=_next_pow2(rows), BLOCK_C=block_c, num_warps=8,
        )
    groupnorm_silu_cuda.launches += 1
    return out


groupnorm_silu_cuda.launches = 0


def _forward(x3, gamma, beta, groups):
    if x3.device.type == "cpu":
        return _reference_math(x3, gamma, beta, groups)
    if x3.device.type == "cuda":
        return groupnorm_silu_cuda(x3, gamma, beta, groups)
    raise ValueError(f"groupnorm_silu has no path for device {x3.device}")


class _GroupNormSiLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x3, gamma, beta, groups):
        ctx.groups = groups
        ctx.save_for_backward(x3, gamma, beta)
        return _forward(x3, gamma, beta, groups)

    @staticmethod
    def backward(ctx, g):
        x3, gamma, beta = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (x3, gamma, beta)]
            out = _reference_math(*leaves, ctx.groups)
            return (*torch.autograd.grad(out, leaves, g), None)


def groupnorm_silu(x3, gamma, beta, groups: int):
    """``silu(GroupNorm(x) * gamma + beta)`` over ``[B, rows, C]``.

    A CUDA tensor runs the kernel (or raises where it cannot take the
    shape); a CPU tensor runs the plain version. Differentiable.
    """
    return _GroupNormSiLU.apply(x3, gamma, beta, groups)
