"""K7: fused GroupNorm + SiLU, forward and backward, Triton kernels for Hopper.

Counterpart of ``bsi_tpu/ops/groupnorm_silu.py`` (the ``pallas_call``s of
``_fwd_kernel`` and ``_bwd_kernel``). The forward (K7f) computes
``silu(GroupNorm(x) * gamma + beta)`` over ``[B, rows, C]`` (rows =
flattened pixels, channels last) with f32 one-pass
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

The backward (K7b) is the closed-form VJP the JAX kernel computes, with the
group statistics recomputed from x in f32 and z recomputed in f32 (not
rounded to the input dtype as the forward rounds it): ``dz = g * silu'(z)``,
per-image partials ``dgamma_b = sum_rows dz * xhat`` and ``dbeta_b = sum_rows
dz``, and ``dx = rstd * (dxhat - mean_g(dxhat) - xhat * mean_g(dxhat * xhat))``
with ``dxhat = dz * gamma``. ``_bwd_math`` is its plain PyTorch version. Its
bound is memory too: x and g read once, dx written once (100.7 MB at
[128, 1024, 128] bf16, 30 us at 3.35 TB/s; 201 MB, 60 us at C=256). It runs
over the forward's (image, channel block) grid, but a program cannot hold x
and g of its block in registers (2 x 64 KB of f32 at 16 channels x 1,024
rows), so it walks the rows in chunks three times: the statistics, then dz
and its column sums against 1 and xhat, then dx. A block's 32 + 32 KB of
bf16 is meant to stay in the 50 MB L2 between the passes, so that the
rereads come from L2 rather than HBM. The partials go out per image and the
wrapper sums them over the batch: no atomics, so the result is
deterministic.
"""

from __future__ import annotations

import functools

import torch

_EPS = 1e-6
# Elements of x one program holds: rows x channels of its block.
_TILE_ELEMS = 16384
# Elements of x (and of g) the backward reads per chunk of rows.
_BWD_CHUNK_ELEMS = 2048


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


@functools.cache
def _bwd_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def gn_silu_bwd(
        x_ptr, gamma_ptr, beta_ptr, g_ptr, dx_ptr, dgamma_ptr, dbeta_ptr,
        rows, C, g_sb, g_sr, g_sc, inv_n, eps,
        CG: tl.constexpr, BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr,
    ):
        b = tl.program_id(0).to(tl.int64)
        cb = tl.program_id(1)
        cl = tl.arange(0, BLOCK_C)
        c = cb * BLOCK_C + cl
        x_base = x_ptr + b * rows * C + c[None, :]
        g_base = g_ptr + b * g_sb + c[None, :].to(tl.int64) * g_sc
        dx_base = dx_ptr + b * rows * C + c[None, :]
        same = (cl[:, None] // CG) == (cl[None, :] // CG)

        # Pass 1: group statistics of x, broadcast to the group's channels.
        csum = tl.zeros([BLOCK_C], dtype=tl.float32)
        csq = tl.zeros([BLOCK_C], dtype=tl.float32)
        for r0 in range(0, rows, BLOCK_R):
            r = r0 + tl.arange(0, BLOCK_R)
            mask = (r < rows)[:, None]
            x = tl.load(x_base + r[:, None] * C, mask=mask, other=0.0).to(tl.float32)
            csum += tl.sum(x, axis=0)
            csq += tl.sum(x * x, axis=0)
        mean = tl.sum(tl.where(same, csum[:, None], 0.0), axis=0) * inv_n
        var = tl.sum(tl.where(same, csq[:, None], 0.0), axis=0) * inv_n - mean * mean
        rstd = 1.0 / tl.sqrt(var + eps)
        gamma = tl.load(gamma_ptr + c).to(tl.float32)
        beta = tl.load(beta_ptr + c).to(tl.float32)

        # Pass 2: dz = g * silu'(z) and its column sums against 1 and xhat.
        sdz = tl.zeros([BLOCK_C], dtype=tl.float32)
        sdzx = tl.zeros([BLOCK_C], dtype=tl.float32)
        for r0 in range(0, rows, BLOCK_R):
            r = r0 + tl.arange(0, BLOCK_R)
            mask = (r < rows)[:, None]
            x = tl.load(x_base + r[:, None] * C, mask=mask, other=0.0).to(tl.float32)
            go = tl.load(g_base + r[:, None].to(tl.int64) * g_sr, mask=mask, other=0.0).to(tl.float32)
            xhat = (x - mean[None, :]) * rstd[None, :]
            z = xhat * gamma[None, :] + beta[None, :]
            sig = 1.0 / (1.0 + tl.exp(-z))
            dz = go * (sig * (1.0 + z * (1.0 - sig)))
            sdz += tl.sum(dz, axis=0)
            sdzx += tl.sum(dz * xhat, axis=0)
        tl.store(dgamma_ptr + b * C + c, sdzx)
        tl.store(dbeta_ptr + b * C + c, sdz)
        # Group means of dxhat = dz * gamma and of dxhat * xhat.
        m1 = tl.sum(tl.where(same, (sdz * gamma)[:, None], 0.0), axis=0) * inv_n
        m2 = tl.sum(tl.where(same, (sdzx * gamma)[:, None], 0.0), axis=0) * inv_n

        # Pass 3: dx.
        for r0 in range(0, rows, BLOCK_R):
            r = r0 + tl.arange(0, BLOCK_R)
            mask = (r < rows)[:, None]
            x = tl.load(x_base + r[:, None] * C, mask=mask, other=0.0).to(tl.float32)
            go = tl.load(g_base + r[:, None].to(tl.int64) * g_sr, mask=mask, other=0.0).to(tl.float32)
            xhat = (x - mean[None, :]) * rstd[None, :]
            z = xhat * gamma[None, :] + beta[None, :]
            sig = 1.0 / (1.0 + tl.exp(-z))
            dxhat = go * (sig * (1.0 + z * (1.0 - sig))) * gamma[None, :]
            dx = rstd[None, :] * (dxhat - m1[None, :] - xhat * m2[None, :])
            tl.store(dx_base + r[:, None] * C, dx.to(dx_ptr.dtype.element_ty), mask=mask)

    return gn_silu_bwd


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


def _check_cuda_args(name, x3, gamma, beta, groups):
    """Raise unless x is a contiguous CUDA ``[B, rows, C]`` (bf16 or f32) and
    gamma, beta are contiguous ``[C]`` in x's dtype on its device."""
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


def groupnorm_silu_cuda(x3, gamma, beta, groups: int):
    """Launch K7's forward on a contiguous CUDA ``[B, rows, C]`` (bf16 or f32)
    with ``gamma``, ``beta`` of shape ``[C]`` in x's dtype. Raises on anything else."""
    _check_cuda_args("groupnorm_silu_cuda", x3, gamma, beta, groups)
    b, rows, c = x3.shape
    block_c = _block_c(rows, c, groups)
    out = torch.empty_like(x3)
    kernel = _kernel()
    with torch.cuda.device(x3.device):
        groupnorm_silu_cuda.compiled = kernel[(b, c // block_c)](
            x3, gamma, beta, out, rows, c, 1.0 / (rows * (c // groups)), _EPS,
            CG=c // groups, BLOCK_R=_next_pow2(rows), BLOCK_C=block_c, num_warps=8,
        )
    groupnorm_silu_cuda.launches += 1
    return out


groupnorm_silu_cuda.launches = 0
groupnorm_silu_cuda.compiled = None  # the last launch's compiled kernel (registers, spills)


def groupnorm_silu_bwd_cuda(x3, gamma, beta, g, groups: int):
    """Launch K7's backward (K7b): x, gamma, beta as the forward takes them and
    the output gradient ``g`` of x's shape and dtype in any strides. Returns
    ``(dx, dgamma, dbeta)`` as ``_bwd_math`` does. Raises on anything else."""
    _check_cuda_args("groupnorm_silu_bwd_cuda", x3, gamma, beta, groups)
    if g.shape != x3.shape or g.dtype != x3.dtype or g.device != x3.device:
        raise ValueError(f"groupnorm_silu_bwd_cuda: g {tuple(g.shape)} {g.dtype} on {g.device} "
                         f"does not match x {tuple(x3.shape)} {x3.dtype} on {x3.device}")
    b, rows, c = x3.shape
    block_c = _block_c(rows, c, groups)
    block_r = min(max(_BWD_CHUNK_ELEMS // block_c, 1), _next_pow2(rows))
    dx = torch.empty_like(x3)
    dgamma_b = torch.empty(b, c, dtype=torch.float32, device=x3.device)
    dbeta_b = torch.empty(b, c, dtype=torch.float32, device=x3.device)
    kernel = _bwd_kernel()
    with torch.cuda.device(x3.device):
        groupnorm_silu_bwd_cuda.compiled = kernel[(b, c // block_c)](
            x3, gamma, beta, g, dx, dgamma_b, dbeta_b, rows, c, *g.stride(),
            1.0 / (rows * (c // groups)), _EPS,
            CG=c // groups, BLOCK_R=block_r, BLOCK_C=block_c, num_warps=4,
        )
    groupnorm_silu_bwd_cuda.launches += 1
    return dx, dgamma_b.sum(0).to(gamma.dtype), dbeta_b.sum(0).to(beta.dtype)


groupnorm_silu_bwd_cuda.launches = 0
groupnorm_silu_bwd_cuda.compiled = None  # the last launch's compiled kernel


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
    return _GroupNormSiLU.apply(x3, gamma, beta, groups)
