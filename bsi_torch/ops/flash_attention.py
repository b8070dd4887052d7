"""K1, K5f and K5b: attention over ``[batch, heads, seq, head_dim]``, CUDA C++
kernels for Hopper, and the autograd function that dispatches between them.

Counterpart of ``bsi_tpu/ops/flash_attention.py``:

- K1 (:func:`flash_attention_cuda`, the ``pallas_call`` of ``_attn_kernel``):
  the no-dropout forward, source ``csrc/flash_attention.cu``;
- K5f (:func:`flash_attention_dropout_cuda`, ``_attn_dropout_kernel``): the
  whole-sequence forward with optional dropout from one int32 seed per
  (batch, head), source ``csrc/flash_attention_dropout.cu``;
- K5b (:func:`flash_attention_bwd_cuda`, ``_attn_bwd_kernel``): its backward,
  which regenerates K5f's keep mask from the same seeds, source
  ``csrc/flash_attention_bwd.cu``; in bf16 at head_dim 64 and 128 it runs
  ``csrc/bh_attention_bwd_sm90.cuh`` (TMA, ``wgmma``, persistent blocks),
  which K3 and K6b run too, and reads K5f's output and row statistics.

K1 and K5f launch the same device code as K2 and K6f,
``csrc/bh_attention_fwd_sm90.cuh``, in bf16 at head_dim 64 and 128 (TMA
and ``wgmma``, persistent blocks), its SGEMM-tiled exact-f32 body in f32 at
128, and ``csrc/packed_attention_fwd.cuh``'s bodies otherwise. The
sources' header notes give the designs and the bounds on an H100.
``_fwd_math`` and ``_bwd_math`` are the plain PyTorch versions of the TPU
kernels' functions of the same names, with an explicit keep mask: the CPU
path and the reference on the card. ``_lse_math`` and ``_bwd_from_stats``
are those of the contract between the bf16 forward and backward at head_dim
64 and 128: the forward also writes each row's log-sum-exp (base 2, as the
kernels' exponentials), the backward takes it and the forward's output in
place of a pass over the keys (``STATS_HEAD_DIMS``). The keep mask of K5f and K5b is
:func:`bsi_torch.ops.dropout_mask._philox_keep_mask` of the seeds, flat
``[B*H]`` as the JAX package's are: the bits K2 and K3 draw.

:class:`_FusedAttention` is the counterpart of the JAX package's
``_fused_sdpa_fn(rate)``: its forward is K5f when ``rate > 0`` or ``S <=
MAX_FUSED_TRAIN_SEQ``, else K1; its backward is the VJP of the plain
attention ``_xla_attention`` when ``rate == 0`` and ``S >
MAX_FUSED_TRAIN_SEQ``, else K5b. On a CPU tensor each kernel's place is
taken by its plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .dropout_mask import _keeps, kernel_dropout_args

SOURCE = "flash_attention.cu"
DROPOUT_SOURCE = "flash_attention_dropout.cu"
BWD_SOURCE = "flash_attention_bwd.cu"
HEAD_DIMS = (64, 128, 256)
# Longest sequence the JAX package's whole-sequence kernels (K5f, K5b) take
# without dropout; longer ones run K1 forward and the VJP of the plain
# attention backward.
MAX_FUSED_TRAIN_SEQ = 512
# Head dims at which the bf16 forwards (K2, K5f, K6f) write the row
# statistics and the backwards (K3, K5b, K6b) read them with the forward's
# output; f32, and bf16 at 256, keep the backwards that recompute them. The
# plain versions follow this; the card's wrappers ask the C side
# (:func:`stats_ld`).
STATS_HEAD_DIMS = (64, 128)
LOG2E = 1.4426950408889634


def _xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, dropout_rate: float = 0.0,
                   generator: torch.Generator | None = None, uniform: torch.Tensor | None = None) -> torch.Tensor:
    """Plain attention over ``[batch, heads, seq, head_dim]``, the JAX
    package's XLA formulation.

    The logits are f32 whatever the input dtype (so f64 inputs lose
    precision here), and the probabilities go back to the input dtype for
    the product with v. With ``dropout_rate > 0`` each probability is kept
    where a uniform draw from ``generator`` falls below ``1 - dropout_rate``
    and scaled by its inverse, as ``jax.random.bernoulli`` keeps it; a given
    ``uniform`` (of the probabilities' shape) takes the draw's place.
    """
    dim = q.shape[-1]
    scale = 1.0 / torch.sqrt(torch.tensor(dim, dtype=torch.float32)).to(q.dtype)
    acc = torch.promote_types(q.dtype, torch.float32)
    logits = torch.matmul((q * scale).to(acc), k.to(acc).transpose(-1, -2))
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    if dropout_rate > 0.0:
        keep_prob = 1.0 - dropout_rate
        if uniform is None:
            uniform = torch.rand(probs.shape, generator=generator, device=probs.device)
        keep = uniform < keep_prob
        probs = torch.where(keep, probs / keep_prob, 0.0)
    return torch.matmul(probs, v)


def _softmax(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) over ``[..., S, D]``: f32 logits from q scaled
    in f32, max-subtracted."""
    logits = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    logits = logits - logits.amax(dim=-1, keepdim=True)
    unnorm = torch.exp(logits)
    return unnorm / unnorm.sum(dim=-1, keepdim=True)


def _fwd_math(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, keep=None,
              keep_prob: float = 1.0) -> torch.Tensor:
    """softmax(q k^T * scale) [dropout] v over ``[..., S, D]``, as the TPU
    kernels' ``_fwd_math``: f32 max-subtracted softmax, the probabilities
    (zeroed where the bool ``keep [..., S, S]`` is False and scaled by
    ``1 / keep_prob``, when given) cast to v's dtype, P V accumulated in f32.
    Returns f32."""
    probs = _softmax(q, k, scale)
    if keep is not None:
        probs = torch.where(keep, probs / keep_prob, 0.0)
    return torch.matmul(probs.to(v.dtype).float(), v.float())


def _bwd_math(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, scale: float,
              keep=None, keep_prob: float = 1.0):
    """The VJP of :func:`_fwd_math` with respect to q, k and v, recomputing
    the softmax, as the TPU kernels' ``_bwd_math``: with P the softmax and Pd
    its dropped, rescaled version, dV = Pd^T dO with Pd cast to the input
    dtype; dP = keep * (dO V^T) / keep_prob; dS = P (dP - rowsum(dP P)) cast
    to the input dtype; dQ = dS K * scale, dK = dS^T Q * scale. Products in
    f32. Returns f32 dq, dk, dv."""
    probs = _softmax(q, k, scale)
    dropped = probs if keep is None else torch.where(keep, probs / keep_prob, 0.0)
    do32 = do.float()
    dv = torch.matmul(dropped.to(v.dtype).float().transpose(-1, -2), do32)
    dp = torch.matmul(do32, v.float().transpose(-1, -2))
    if keep is not None:
        dp = torch.where(keep, dp / keep_prob, 0.0)
    ds = (probs * (dp - (dp * probs).sum(dim=-1, keepdim=True))).to(v.dtype).float()
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    return dq, dk, dv


def _lse_math(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """The row statistics the bf16 forwards write for their backward, over
    ``[..., S, D]``: log2 of sum_j 2^(x_ij) with x = q k^T * scale * log2(e)
    (base 2, as the kernels' exponentials; the natural log-sum-exp of the
    scaled logits times log2(e)). f32 ``[..., S]``."""
    logits = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    return torch.logsumexp(logits, dim=-1) * LOG2E


def _bwd_from_stats(q, k, v, do, out, lse, scale: float, keep=None, keep_prob: float = 1.0,
                    acc: torch.dtype = torch.float32):
    """The backward of the Hopper kernels, from the forward's output ``out``
    and row statistics ``lse`` (:func:`_lse_math`) instead of a pass over the
    keys: P = 2^(x - lse) with x = q k^T * scale * log2(e); delta = rowsum(dO
    out) in f32, which equals rowsum(dP P) since out = Pd V; then
    :func:`_bwd_math`'s formulas and roundings (Pd and dS cast to v's dtype
    before their products), products in ``acc``. Returns dq, dk, dv in
    ``acc``."""
    logits = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    probs = torch.exp2(logits * LOG2E - lse.float()[..., None])
    delta = (do.float() * out.float()).sum(dim=-1, keepdim=True)
    dropped = probs if keep is None else torch.where(keep, probs / keep_prob, 0.0)
    do_acc = do.to(acc)
    dv = torch.matmul(dropped.to(v.dtype).to(acc).transpose(-1, -2), do_acc)
    dp = torch.matmul(do_acc, v.to(acc).transpose(-1, -2))
    if keep is not None:
        dp = torch.where(keep, dp / keep_prob, 0.0)
    ds = (probs * (dp - delta)).to(v.dtype).to(acc)
    dq = torch.matmul(ds, k.to(acc)) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.to(acc)) * scale
    return dq, dk, dv


def _scale(q: torch.Tensor) -> float:
    return 1.0 / (q.shape[-1] ** 0.5)


def writes_stats(dtype: torch.dtype, head_dim: int) -> bool:
    """Whether the plain versions pass row statistics from forward to
    backward for ``dtype`` at ``head_dim``, as the card's route does."""
    return dtype == torch.bfloat16 and head_dim in STATS_HEAD_DIMS


def stats_ld(lib, seq: int, head_dim: int, dtype: torch.dtype) -> int:
    """The row stride of the statistics that ``lib``'s route writes or reads
    for ``dtype`` at ``head_dim`` (each head's rows over whole tiles), or 0
    where it takes none: its C entry ``bsi_attention_stats_ld``."""
    return lib.bsi_attention_stats_ld(seq, head_dim, int(dtype == torch.bfloat16))


def stats_buffer(batch: int, heads: int, seq: int, ld: int, device) -> torch.Tensor:
    """An f32 ``[B, H, S]`` for a forward's row statistics, each head's rows
    ``ld`` apart (:func:`stats_ld`), as the kernels write and read them."""
    return torch.empty(batch, heads, ld, dtype=torch.float32, device=device)[..., :seq]


def stats_arg(name: str, lse: torch.Tensor, batch: int, heads: int, seq: int, ld: int, device) -> torch.Tensor:
    """``lse [B, H, S]`` (f32, on ``device``) in :func:`stats_buffer`'s
    layout: as it is if it has it, else a copy (zero past S). Raises on
    anything else."""
    if lse.shape != (batch, heads, seq) or lse.dtype != torch.float32 or lse.device != device:
        raise ValueError(f"{name}: lse must be f32 {(batch, heads, seq)} on {device}, "
                         f"got {lse.dtype} {tuple(lse.shape)} on {lse.device}")
    if lse.stride() == (heads * ld, ld, 1) and lse.data_ptr() % 16 == 0:
        return lse
    padded = torch.zeros(batch, heads, ld, dtype=torch.float32, device=device)
    padded[..., :seq] = lse
    return padded[..., :seq]


def bwd_workspace(lib, bh: int, seq: int, head_dim: int, dtype: torch.dtype, dropout: bool,
                  device) -> torch.Tensor:
    """The scratch a backward takes (its C entry says how much: by route,
    and with or without dropout)."""
    nbytes = lib.bsi_attention_bwd_workspace_bytes(bh, seq, head_dim, int(dtype == torch.bfloat16), int(dropout))
    return torch.empty(nbytes, dtype=torch.uint8, device=device)


# ----------------------------------------------------------------- kernels


def _check_cuda(name: str, tensors) -> tuple[int, int, int, int]:
    """Raise unless every tensor is a contiguous CUDA ``[B, H, S, D]`` of one
    shape and dtype (bf16 or f32) with D in ``HEAD_DIMS``. Returns the shape."""
    first = tensors[0]
    if not all(t.is_cuda and t.device == first.device for t in tensors):
        raise ValueError(f"{name} needs its inputs on one CUDA device")
    if first.dtype not in (torch.bfloat16, torch.float32) or any(t.dtype != first.dtype for t in tensors):
        raise ValueError(f"{name} takes bf16 or f32, got {[t.dtype for t in tensors]}")
    if first.ndim != 4 or any(t.shape != first.shape for t in tensors):
        raise ValueError(f"{name} takes [B, H, S, D] inputs of one shape, got {[tuple(t.shape) for t in tensors]}")
    b, h, seq, d = first.shape
    if d not in HEAD_DIMS or seq < 1 or b * h < 1:
        raise ValueError(f"{name} takes head_dim in {HEAD_DIMS}, got shape {tuple(first.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous inputs")
    return b, h, seq, d


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch K1 on contiguous CUDA tensors ``[B, H, S, D]`` (bf16 or f32,
    D in ``HEAD_DIMS``, any S). Raises on anything else."""
    b, h, seq, d = _check_cuda("flash_attention_cuda", (q, k, v))
    lib = _lib()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.bsi_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b * h, seq, d, int(q.dtype == torch.bfloat16), _scale(q), stream,
        )
    _build.check(lib, code, "flash_attention kernel")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


def flash_attention_dropout_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 seeds: torch.Tensor | None = None, rate: float = 0.0, *,
                                 with_lse: bool = False):
    """Launch K5f on contiguous CUDA ``[B, H, S, D]`` q, k, v (bf16 or f32, D
    in ``HEAD_DIMS``, any S), with dropout at ``rate`` from int32 ``seeds
    [B*H]`` (ignored at rate 0). Returns ``[B, H, S, D]`` in q's dtype; with
    ``with_lse``, ``(out, lse)``: the row statistics f32 ``[B, H, S]``
    (:func:`_lse_math`) where the route writes them (bf16 at head_dim 64 and
    128), else None. Raises on anything else."""
    name = "flash_attention_dropout_cuda"
    b, h, seq, d = _check_cuda(name, (q, k, v))
    seed_ptr, threshold, inv_keep = kernel_dropout_args(name, seeds, rate, (b * h,), q.device)
    lib = _dropout_lib()
    out = torch.empty_like(q)
    ld = stats_ld(lib, seq, d, q.dtype)
    lse = stats_buffer(b, h, seq, ld, q.device) if with_lse and ld else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.bsi_flash_attention_dropout_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
            b * h, seq, d, int(q.dtype == torch.bfloat16), _scale(q), seed_ptr, threshold, inv_keep, stream,
        )
    _build.check(lib, code, "flash_attention_dropout kernel")
    flash_attention_dropout_cuda.launches += 1
    return (out, lse) if with_lse else out


flash_attention_dropout_cuda.launches = 0


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                             seeds: torch.Tensor | None = None, rate: float = 0.0, *,
                             out: torch.Tensor | None = None, lse: torch.Tensor | None = None):
    """Launch K5b: the gradients dq, dk, dv ``[B, H, S, D]`` of K5f for the
    output gradient ``do``, on contiguous CUDA tensors of one shape (bf16 or
    f32, D in ``HEAD_DIMS``, any S), with K5f's ``seeds`` and ``rate``. In
    bf16 at head_dim 64 and 128 it reads K5f's output ``out`` and row
    statistics ``lse`` (:func:`flash_attention_dropout_cuda` with
    ``with_lse``); when either is not given it launches K5f for both first.
    Other routes ignore them. Raises on anything else."""
    name = "flash_attention_bwd_cuda"
    b, h, seq, d = _check_cuda(name, (q, k, v, do))
    seed_ptr, threshold, inv_keep = kernel_dropout_args(name, seeds, rate, (b * h,), q.device)
    lib = _bwd_lib()
    out_ptr = lse_ptr = None
    ld = stats_ld(lib, seq, d, q.dtype)
    if ld:
        if out is None or lse is None:
            out, lse = flash_attention_dropout_cuda(q, k, v, seeds, rate, with_lse=True)
        _check_cuda(name, (q, out))
        lse = stats_arg(name, lse, b, h, seq, ld, q.device)
        out_ptr, lse_ptr = out.data_ptr(), lse.data_ptr()
    grads = tuple(torch.empty_like(q) for _ in range(3))
    workspace = bwd_workspace(lib, b * h, seq, d, q.dtype, seed_ptr is not None, q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.bsi_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), out_ptr, lse_ptr,
            *(g.data_ptr() for g in grads), workspace.data_ptr(), b * h, seq, d, int(q.dtype == torch.bfloat16),
            _scale(q), seed_ptr, threshold, inv_keep, stream,
        )
    _build.check(lib, code, "flash_attention_bwd kernel")
    flash_attention_bwd_cuda.launches += 1
    return grads


flash_attention_bwd_cuda.launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.bsi_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@functools.cache
def _dropout_lib() -> ctypes.CDLL:
    lib = _build.load(DROPOUT_SOURCE)
    fn = lib.bsi_flash_attention_dropout_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _bind_stats(lib)
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load(BWD_SOURCE)
    fn = lib.bsi_flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _bind_bwd(lib)
    return lib


def _bind_stats(lib: ctypes.CDLL) -> None:
    fn = lib.bsi_attention_stats_ld
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int


def _bind_bwd(lib: ctypes.CDLL) -> None:
    _bind_stats(lib)
    fn = lib.bsi_attention_bwd_workspace_bytes
    fn.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 4
    fn.restype = ctypes.c_longlong


# ----------------------------------------------------------------- entries


def _no_path(name: str, device) -> ValueError:
    return ValueError(f"{name} has no path for device {device}")


def _keep(q: torch.Tensor, seeds, rate: float):
    """The keep mask ``[B, H, S, S]`` of K5f's dropout from the flat seeds
    ``[B*H]``, or None at rate 0."""
    b, h, seq, _ = q.shape
    return _keeps(None if seeds is None else seeds.reshape(b, h), seq, rate)


def flash_attention_dropout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            seeds: torch.Tensor | None = None, *, rate: float = 0.0, with_lse: bool = False):
    """Whole-sequence attention over ``[B, H, S, D]`` with dropout at ``rate``
    from int32 ``seeds [B*H]``. A CUDA tensor runs K5f (or raises where K5f
    cannot take it); a CPU tensor runs the plain version with
    ``_philox_keep_mask``'s mask. With ``with_lse``, ``(out, lse)`` as
    :func:`flash_attention_dropout_cuda` returns them: the statistics where
    the card's route writes them (:func:`writes_stats`, on the CPU
    :func:`_lse_math`'s), else None."""
    if q.device.type == "cpu":
        out = _fwd_math(q, k, v, _scale(q), _keep(q, seeds, rate), 1.0 - rate).to(q.dtype)
        if not with_lse:
            return out
        return out, _lse_math(q, k, _scale(q)) if writes_stats(q.dtype, q.shape[-1]) else None
    if q.device.type == "cuda":
        return flash_attention_dropout_cuda(q, k, v, seeds, rate, with_lse=with_lse)
    raise _no_path("flash_attention_dropout", q.device)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                        seeds: torch.Tensor | None = None, *, rate: float = 0.0,
                        out: torch.Tensor | None = None, lse: torch.Tensor | None = None):
    """dq, dk, dv of :func:`flash_attention_dropout` for the output gradient
    ``do``, in q's dtype, from the forward's ``out`` and ``lse`` where given.
    A CUDA tensor runs K5b; a CPU tensor the plain version
    (:func:`_bwd_from_stats` with both given, else :func:`_bwd_math`)."""
    if q.device.type == "cpu":
        keep, scale = _keep(q, seeds, rate), _scale(q)
        if out is not None and lse is not None:
            grads = _bwd_from_stats(q, k, v, do, out, lse, scale, keep, 1.0 - rate)
        else:
            grads = _bwd_math(q, k, v, do, scale, keep, 1.0 - rate)
        return tuple(g.to(q.dtype) for g in grads)
    if q.device.type == "cuda":
        return flash_attention_bwd_cuda(q, k, v, do, seeds, rate, out=out, lse=lse)
    raise _no_path("flash_attention_bwd", q.device)


def _k1(q, k, v):
    if q.device.type == "cpu":
        return _fwd_math(q, k, v, _scale(q)).to(q.dtype)
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v)
    raise _no_path("flash_attention", q.device)


class _FusedAttention(torch.autograd.Function):
    """The JAX package's ``_fused_sdpa_fn(rate)``: K5f or K1 forward, K5b or
    the VJP of ``_xla_attention`` backward, by rate and S. ``seeds`` (int32
    ``[B*H]``, or None at rate 0) are saved so that K5b regenerates K5f's
    keep mask; with ``stats`` (a gradient will be taken) K5f also returns
    its row statistics, saved with its output for K5b."""

    @staticmethod
    def forward(ctx, q, k, v, seeds, rate, stats):
        ctx.rate = rate
        out = lse = None
        if rate > 0.0 or q.shape[-2] <= MAX_FUSED_TRAIN_SEQ:
            if stats:
                out, lse = flash_attention_dropout(q, k, v, seeds, rate=rate, with_lse=True)
            else:
                out = flash_attention_dropout(q, k, v, seeds, rate=rate)
        else:
            out = _k1(q, k, v)
        ctx.save_for_backward(q, k, v, seeds, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, seeds, out, lse = ctx.saved_tensors
        if ctx.rate == 0.0 and q.shape[-2] > MAX_FUSED_TRAIN_SEQ:
            with torch.enable_grad():
                leaves = [x.detach().requires_grad_() for x in (q, k, v)]
                grads = torch.autograd.grad(_xla_attention(*leaves), leaves, g)
        else:
            grads = flash_attention_bwd(q, k, v, g.contiguous(), seeds, rate=ctx.rate, out=out, lse=lse)
        return (*grads, None, None, None)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seeds: torch.Tensor | None = None,
                    rate: float = 0.0) -> torch.Tensor:
    """Differentiable fused attention over contiguous ``[B, H, S, D]``, with
    dropout at ``rate`` from int32 ``seeds [B*H]``: :class:`_FusedAttention`.
    A CUDA tensor runs the kernels (or raises where they cannot take it); a
    CPU tensor runs their plain versions."""
    stats = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    return _FusedAttention.apply(q, k, v, seeds, float(rate), stats)
