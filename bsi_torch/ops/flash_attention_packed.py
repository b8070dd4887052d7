"""K2, K6f, K3 and K6b: attention over heads read in place from the packed
layouts, forward and backward, CUDA C++ kernels for Hopper; the grouped qkv
layout helpers; the dropout mask.

Counterpart of ``bsi_tpu/ops/flash_attention_packed.py``. K2
(:func:`flash_attention_fused`) reads q, k and v straight out of the qkv
projection's output ``[B, S, 3*H*D]`` in the GROUPED layout
(:func:`qkv_heads_per_group`) and writes ``[B, S, H*D]``, with no split or
merge copy; K6f (:func:`flash_attention_packed`) runs the same kernel over
three ``[B, S, H*D]`` tensors. Their backwards, K3
(:func:`flash_attention_fused_bwd`, which writes the fused dqkv in the
grouped layout in place) and K6b (:func:`flash_attention_packed_bwd`), are
one kernel pair in the same way. The kernels take the layout (row stride,
column stride between head groups, heads per group) as arguments. Sources:
``csrc/flash_attention_packed.cu`` (forward) and
``csrc/flash_attention_packed_bwd.cu`` (backward); their header notes give
the designs and the bounds on an H100. In bf16 at head_dim 64 and 128 the
forward runs the Hopper body that K1 and K5f run too
(``csrc/bh_attention_fwd_sm90.cuh``: TMA, ``wgmma``, persistent blocks) and,
asked for them, writes each row's statistics (``with_lse``); the backward
runs the Hopper body that K5b runs too (``csrc/bh_attention_bwd_sm90.cuh``),
which reads them and the forward's output (``out``, ``lse``).

Attention dropout follows the TPU kernels: one int32 seed per (batch, head)
(:func:`draw_seeds`), from which every kernel regenerates the same keep mask,
so the backward needs no mask in memory (:mod:`bsi_torch.ops.dropout_mask`).

``_packed_fwd_math`` and ``_packed_bwd_math`` are the plain PyTorch versions
of the kernels' per-head math (the TPU kernel's functions of the same
names), with optional explicit keep masks; ``_fused_fwd_math``,
``_packed_heads_math``, ``_fused_bwd_math`` and ``_packed_heads_bwd_math``
are the plain versions of the four entries, the backwards from the
forward's output and statistics where given
(:func:`bsi_torch.ops.flash_attention._bwd_from_stats`), and
``_fused_lse_math`` and ``_packed_heads_lse_math`` those of the statistics.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .dropout_mask import (  # noqa: F401 (_philox4x32_10, keep_threshold: re-exported)
    _keeps,
    _philox4x32_10,
    _philox_keep_mask,
    draw_seeds,
    keep_threshold,
    kernel_dropout_args,
)
from .flash_attention import (
    MAX_FUSED_TRAIN_SEQ,
    _bwd_from_stats,
    _lse_math,
    _bind_bwd,
    _bind_stats,
    _no_path,
    bwd_workspace,
    stats_arg,
    stats_buffer,
    stats_ld,
    writes_stats,
)

LANE = 128
SOURCE = "flash_attention_packed.cu"
BWD_SOURCE = "flash_attention_packed_bwd.cu"
HEAD_DIMS = (64, 128, 256)


def qkv_heads_per_group(head_dim: int, heads: int) -> int:
    """Heads per 128-lane group in the GROUPED qkv weight layout.

    The grouped layout packs the qkv projection's output axis as
    ``(group, qkv, heads_per_group, head_dim)``: at head_dim 64 a group is a
    head pair. head_dim >= 128 gives one head per group, as do head dims
    that do not tile 128 lanes.
    """
    if head_dim < LANE and LANE % head_dim == 0 and heads % (LANE // head_dim) == 0:
        return LANE // head_dim
    return 1


def packed_applicable(hd_total: int, heads: int, seq: int) -> bool:
    """Shapes the packed kernels accept, as the JAX package's function of the
    same name: whole heads of 64, 128 or 256 (head pairs whole at 64), a
    sequence of whole 128-row blocks up to ``MAX_FUSED_TRAIN_SEQ``."""
    if heads <= 0 or hd_total % heads:
        return False
    head_dim = hd_total // heads
    if head_dim not in HEAD_DIMS:
        return False
    if head_dim == 64 and heads % 2:
        return False
    return seq >= 128 and seq % 128 == 0 and seq <= MAX_FUSED_TRAIN_SEQ


def split_qkv_grouped(qkv: torch.Tensor, heads: int):
    """GROUPED-layout qkv ``[B, S, (g qkv hpg d)]`` -> q, k, v ``[B, H, S, D]`` (views)."""
    b, s, three_hd = qkv.shape
    hd = three_hd // 3
    d = hd // heads
    hpg = qkv_heads_per_group(d, heads)
    x = qkv.reshape(b, s, heads // hpg, 3, hpg, d)
    pick = lambda j: x[:, :, :, j].reshape(b, s, heads, d).permute(0, 2, 1, 3)
    return pick(0), pick(1), pick(2)


def merge_qkv_grouped(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`split_qkv_grouped`: ``[B, H, S, D]`` q, k, v ->
    the grouped ``[B, S, 3*H*D]`` buffer (a copy)."""
    b, heads, s, d = q.shape
    hpg = qkv_heads_per_group(d, heads)
    group = lambda x: x.permute(0, 2, 1, 3).reshape(b, s, heads // hpg, hpg * d)
    return torch.stack([group(q), group(k), group(v)], dim=3).reshape(b, s, 3 * heads * d)


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    # [B, S, H*D] -> [B, H, S, D]
    b, s, hd = x.shape
    return x.reshape(b, s, heads, hd // heads).permute(0, 2, 1, 3)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    # [B, H, S, D] -> [B, S, H*D]
    b, h, s, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, s, h * d)


# -------------------------------------------------------------- plain math


def _packed_fwd_math(q, k, v, scale: float, keeps=None, keep_prob: float = 1.0):
    """softmax(q k^T * scale) [dropout] v per head over ``[..., S, D]``.

    The TPU kernel's math: q scaled in f32, f32 logits, a max-subtracted f32
    softmax, the probabilities (dropped where ``keeps`` is False and scaled
    by ``1 / keep_prob``) cast to v's dtype for P V, accumulated in at least
    f32. ``keeps``: bool ``[..., S, S]`` or None. Returns f32.
    """
    logits = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    logits = logits - logits.amax(dim=-1, keepdim=True)
    unnorm = torch.exp(logits)
    probs = unnorm / unnorm.sum(dim=-1, keepdim=True)
    if keeps is not None:
        probs = torch.where(keeps, probs / keep_prob, 0.0)
    acc = torch.promote_types(v.dtype, torch.float32)
    return torch.matmul(probs.to(v.dtype).to(acc), v.to(acc)).float()


def _packed_bwd_math(q, k, v, do, scale: float, keeps=None, keep_prob: float = 1.0):
    """The VJP of :func:`_packed_fwd_math` with respect to q, k and v, as the
    TPU kernel's ``_packed_bwd_math``: the softmax recomputed from f32
    logits, the dropped probabilities cast to v's dtype for dV, dS cast to
    v's dtype for dQ and dK, products accumulated in at least f32. Returns
    dq, dk, dv in that accumulation dtype."""
    acc = torch.promote_types(v.dtype, torch.float32)
    logits = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    logits = logits - logits.amax(dim=-1, keepdim=True)
    unnorm = torch.exp(logits)
    probs = unnorm / unnorm.sum(dim=-1, keepdim=True)
    dropped = probs if keeps is None else torch.where(keeps, probs / keep_prob, 0.0)
    do_acc = do.to(acc)
    dv = torch.matmul(dropped.to(v.dtype).to(acc).transpose(-1, -2), do_acc)
    dp = torch.matmul(do_acc, v.to(acc).transpose(-1, -2))
    if keeps is not None:
        dp = torch.where(keeps, dp / keep_prob, 0.0)
    ds = (probs * (dp - (dp * probs).sum(dim=-1, keepdim=True))).to(v.dtype).to(acc)
    dq = torch.matmul(ds, k.to(acc)) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.to(acc)) * scale
    return dq, dk, dv


def _scale(head_dim: int) -> float:
    return 1.0 / (head_dim**0.5)


def _fused_fwd_math(qkv: torch.Tensor, heads: int, keeps=None, keep_prob: float = 1.0):
    """Plain version of K2: grouped qkv ``[B, S, 3*H*D]`` -> ``[B, S, H*D]``
    in qkv's dtype. ``keeps``: bool ``[B, H, S, S]`` or None."""
    q, k, v = split_qkv_grouped(qkv, heads)
    out = _packed_fwd_math(q, k, v, _scale(q.shape[-1]), keeps, keep_prob)
    return _merge_heads(out).to(qkv.dtype)


def _packed_heads_math(q, k, v, heads: int, keeps=None, keep_prob: float = 1.0):
    """Plain version of K6f: q, k, v ``[B, S, H*D]`` -> ``[B, S, H*D]`` in q's dtype."""
    q4, k4, v4 = (_split_heads(x, heads) for x in (q, k, v))
    out = _packed_fwd_math(q4, k4, v4, _scale(q4.shape[-1]), keeps, keep_prob)
    return _merge_heads(out).to(q.dtype)


def _fused_lse_math(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Plain version of K2's row statistics: f32 ``[B, H, S]`` (``_lse_math``)."""
    q, k, _ = split_qkv_grouped(qkv, heads)
    return _lse_math(q, k, _scale(q.shape[-1]))


def _packed_heads_lse_math(q: torch.Tensor, k: torch.Tensor, heads: int) -> torch.Tensor:
    """Plain version of K6f's row statistics: f32 ``[B, H, S]``."""
    q4, k4 = _split_heads(q, heads), _split_heads(k, heads)
    return _lse_math(q4, k4, _scale(q4.shape[-1]))


def _heads_bwd(q4, k4, v4, do4, heads: int, keeps, keep_prob: float, out=None, lse=None):
    # _packed_bwd_math, or its counterpart from the forward's output [B, S,
    # H*D] and statistics [B, H, S] where both are given
    scale = _scale(q4.shape[-1])
    if out is None or lse is None:
        return _packed_bwd_math(q4, k4, v4, do4, scale, keeps, keep_prob)
    acc = torch.promote_types(v4.dtype, torch.float32)
    return _bwd_from_stats(q4, k4, v4, do4, _split_heads(out, heads), lse, scale, keeps, keep_prob, acc)


def _fused_bwd_math(qkv: torch.Tensor, do: torch.Tensor, heads: int, keeps=None, keep_prob: float = 1.0,
                    out=None, lse=None):
    """Plain version of K3: grouped qkv and dO ``[B, S, H*D]`` -> the fused
    dqkv ``[B, S, 3*H*D]`` in the grouped layout, in qkv's dtype; from K2's
    output and statistics where both are given."""
    q, k, v = split_qkv_grouped(qkv, heads)
    grads = _heads_bwd(q, k, v, _split_heads(do, heads), heads, keeps, keep_prob, out, lse)
    return merge_qkv_grouped(*grads).to(qkv.dtype)


def _packed_heads_bwd_math(q, k, v, do, heads: int, keeps=None, keep_prob: float = 1.0, out=None, lse=None):
    """Plain version of K6b: q, k, v, dO ``[B, S, H*D]`` -> dq, dk, dv
    ``[B, S, H*D]`` in q's dtype; from K6f's output and statistics where
    both are given."""
    q4, k4, v4, do4 = (_split_heads(x, heads) for x in (q, k, v, do))
    grads = _heads_bwd(q4, k4, v4, do4, heads, keeps, keep_prob, out, lse)
    return tuple(_merge_heads(g).to(q.dtype) for g in grads)


# ----------------------------------------------------------------- kernels


def _check_cuda(name: str, tensors, heads: int, width: int) -> int:
    """Raise unless every tensor is a contiguous, 16-byte aligned CUDA
    ``[B, S, width * H * D]`` of one shape and dtype (bf16 or f32) with D in
    ``HEAD_DIMS``. Returns the head dim."""
    first = tensors[0]
    if not all(t.is_cuda and t.device == first.device for t in tensors):
        raise ValueError(f"{name} needs its inputs on one CUDA device")
    if first.dtype not in (torch.bfloat16, torch.float32) or any(t.dtype != first.dtype for t in tensors):
        raise ValueError(f"{name} takes bf16 or f32, got {[t.dtype for t in tensors]}")
    if first.ndim != 3 or any(t.shape != first.shape for t in tensors):
        raise ValueError(f"{name} takes [B, S, F] inputs of one shape, got {[tuple(t.shape) for t in tensors]}")
    b, seq, feat = first.shape
    if heads <= 0 or feat % width or (feat // width) % heads:
        raise ValueError(f"{name}: feature dim {feat} does not hold {heads} whole heads")
    head_dim = feat // width // heads
    if head_dim not in HEAD_DIMS or seq < 1 or b < 1 or b * heads > 65535:
        raise ValueError(f"{name} takes head_dim in {HEAD_DIMS} and B*H <= 65535, "
                         f"got {tuple(first.shape)} with {heads} heads")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors):
        raise ValueError(f"{name} needs contiguous, 16-byte aligned inputs")
    return head_dim


def _check_do(name: str, do: torch.Tensor, like: torch.Tensor, width: int) -> None:
    b, seq, feat = like.shape
    if (do.device != like.device or do.dtype != like.dtype or do.shape != (b, seq, feat // width)
            or not do.is_contiguous() or do.data_ptr() % 16):
        raise ValueError(f"{name}: dO must be a contiguous, aligned {(b, seq, feat // width)} "
                         f"{like.dtype} on {like.device}, got {tuple(do.shape)} {do.dtype} on {do.device}")


def _launch(q_ptr, k_ptr, v_ptr, out, batch, seq, heads, head_dim, hpg, group_stride, in_ld, seeds,
            rate, with_lse, what):
    seed_ptr, threshold, inv_keep = kernel_dropout_args(what, seeds, rate, (batch, heads), out.device)
    lib = _lib()
    ld = stats_ld(lib, seq, head_dim, out.dtype)
    lse = stats_buffer(batch, heads, seq, ld, out.device) if with_lse and ld else None
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        code = lib.bsi_packed_attention_fwd(
            q_ptr, k_ptr, v_ptr, out.data_ptr(), None if lse is None else lse.data_ptr(), batch, seq, heads,
            head_dim, hpg, group_stride, in_ld, out.shape[-1], int(out.dtype == torch.bfloat16),
            _scale(head_dim), seed_ptr, threshold, inv_keep, stream,
        )
    _build.check(lib, code, what)
    return (out, lse) if with_lse else out


def flash_attention_fused_cuda(qkv: torch.Tensor, heads: int, seeds: torch.Tensor | None = None,
                               rate: float = 0.0, *, with_lse: bool = False):
    """Launch K2 on a contiguous CUDA grouped qkv buffer ``[B, S, 3*H*D]``
    (bf16 or f32, D in ``HEAD_DIMS``, any S), with dropout at ``rate`` from
    int32 ``seeds [B, H]``. Returns ``[B, S, H*D]`` in qkv's dtype; with
    ``with_lse``, ``(out, lse)``: the row statistics f32 ``[B, H, S]`` where
    the route writes them (bf16 at head_dim 64 and 128), else None. Raises
    on anything else."""
    head_dim = _check_cuda("flash_attention_fused_cuda", (qkv,), heads, 3)
    b, seq, three_hd = qkv.shape
    hpg = qkv_heads_per_group(head_dim, heads)
    out = torch.empty(b, seq, three_hd // 3, dtype=qkv.dtype, device=qkv.device)
    base, step = qkv.data_ptr(), hpg * head_dim * qkv.element_size()
    result = _launch(base, base + step, base + 2 * step, out, b, seq, heads, head_dim, hpg,
                     3 * hpg * head_dim, three_hd, seeds, rate, with_lse, "flash_attention_fused kernel")
    flash_attention_fused_cuda.launches += 1
    return result


flash_attention_fused_cuda.launches = 0


def flash_attention_packed_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                                seeds: torch.Tensor | None = None, rate: float = 0.0, *, with_lse: bool = False):
    """Launch K6f on contiguous CUDA ``[B, S, H*D]`` q, k, v (bf16 or f32, D
    in ``HEAD_DIMS``, any S), dropout and ``with_lse`` as K2's. Returns
    ``[B, S, H*D]`` (and the statistics). Raises on anything else."""
    head_dim = _check_cuda("flash_attention_packed_cuda", (q, k, v), heads, 1)
    b, seq, hd = q.shape
    result = _launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), torch.empty_like(q), b, seq, heads, head_dim, 1,
                     head_dim, hd, seeds, rate, with_lse, "flash_attention_packed kernel")
    flash_attention_packed_cuda.launches += 1
    return result


flash_attention_packed_cuda.launches = 0


def _launch_bwd(ptrs, grads, do, out, lse, ld, batch, seq, heads, head_dim, hpg, group_stride, in_ld, seeds, rate,
                what):
    seed_ptr, threshold, inv_keep = kernel_dropout_args(what, seeds, rate, (batch, heads), do.device)
    out_ptr = lse_ptr = None
    if ld:
        _check_do(what, out, do, 1)
        lse = stats_arg(what, lse, batch, heads, seq, ld, do.device)
        out_ptr, lse_ptr = out.data_ptr(), lse.data_ptr()
    lib = _bwd_lib()
    workspace = bwd_workspace(lib, batch * heads, seq, head_dim, do.dtype, seed_ptr is not None, do.device)
    with torch.cuda.device(do.device):
        stream = torch.cuda.current_stream(do.device).cuda_stream
        code = lib.bsi_packed_attention_bwd(
            *ptrs, do.data_ptr(), out_ptr, lse_ptr, *grads, workspace.data_ptr(), batch, seq, heads, head_dim,
            hpg, group_stride, in_ld, do.shape[-1], int(do.dtype == torch.bfloat16), _scale(head_dim),
            seed_ptr, threshold, inv_keep, stream,
        )
    _build.check(lib, code, what)


def flash_attention_fused_bwd_cuda(qkv: torch.Tensor, do: torch.Tensor, heads: int,
                                   seeds: torch.Tensor | None = None, rate: float = 0.0, *,
                                   out: torch.Tensor | None = None, lse: torch.Tensor | None = None):
    """Launch K3: the grouped qkv buffer ``[B, S, 3*H*D]`` and the output
    gradient dO ``[B, S, H*D]`` (contiguous CUDA, bf16 or f32, D in
    ``HEAD_DIMS``, any S), with the forward's ``seeds`` and ``rate``. In
    bf16 at head_dim 64 and 128 it reads K2's output ``out`` and statistics
    ``lse`` (:func:`flash_attention_fused_cuda` with ``with_lse``); when
    either is not given it launches K2 for both first. Returns the fused
    dqkv ``[B, S, 3*H*D]`` in the grouped layout, written by the kernel in
    place. Raises on anything else."""
    name = "flash_attention_fused_bwd_cuda"
    head_dim = _check_cuda(name, (qkv,), heads, 3)
    _check_do(name, do, qkv, 3)
    b, seq, three_hd = qkv.shape
    ld = stats_ld(_bwd_lib(), seq, head_dim, qkv.dtype)
    if ld and (out is None or lse is None):
        out, lse = flash_attention_fused_cuda(qkv, heads, seeds, rate, with_lse=True)
    hpg = qkv_heads_per_group(head_dim, heads)
    dqkv = torch.empty_like(qkv)
    step = hpg * head_dim * qkv.element_size()
    offsets = lambda t: (t.data_ptr(), t.data_ptr() + step, t.data_ptr() + 2 * step)
    _launch_bwd(offsets(qkv), offsets(dqkv), do, out, lse, ld, b, seq, heads, head_dim, hpg, 3 * hpg * head_dim,
                three_hd, seeds, rate, "flash_attention_fused_bwd kernel")
    flash_attention_fused_bwd_cuda.launches += 1
    return dqkv


flash_attention_fused_bwd_cuda.launches = 0


def flash_attention_packed_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                                    heads: int, seeds: torch.Tensor | None = None, rate: float = 0.0, *,
                                    out: torch.Tensor | None = None, lse: torch.Tensor | None = None):
    """Launch K6b on contiguous CUDA ``[B, S, H*D]`` q, k, v and dO (bf16 or
    f32, D in ``HEAD_DIMS``, any S), dropout, ``out`` and ``lse`` as K3's
    (K6f's here). Returns dq, dk, dv ``[B, S, H*D]``. Raises on anything
    else."""
    name = "flash_attention_packed_bwd_cuda"
    head_dim = _check_cuda(name, (q, k, v, do), heads, 1)
    b, seq, hd = q.shape
    ld = stats_ld(_bwd_lib(), seq, head_dim, q.dtype)
    if ld and (out is None or lse is None):
        out, lse = flash_attention_packed_cuda(q, k, v, heads, seeds, rate, with_lse=True)
    grads = tuple(torch.empty_like(q) for _ in range(3))
    _launch_bwd((q.data_ptr(), k.data_ptr(), v.data_ptr()), tuple(g.data_ptr() for g in grads), do, out, lse, ld,
                b, seq, heads, head_dim, 1, head_dim, hd, seeds, rate, name)
    flash_attention_packed_bwd_cuda.launches += 1
    return grads


flash_attention_packed_bwd_cuda.launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.bsi_packed_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 3
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_float,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _bind_stats(lib)
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load(BWD_SOURCE)
    fn = lib.bsi_packed_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 3
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _bind_bwd(lib)
    return lib


# ------------------------------------------------------------------ entries


def flash_attention_fused(qkv: torch.Tensor, *, heads: int, seeds: torch.Tensor | None = None,
                          rate: float = 0.0, with_lse: bool = False):
    """Attention straight off a grouped qkv buffer ``[B, S, 3*H*D]`` ->
    ``[B, S, H*D]``, dropout at ``rate`` from ``seeds [B, H]``; with
    ``with_lse`` also the row statistics, as :func:`flash_attention_fused_cuda`
    returns them. A CUDA tensor runs K2 (or raises where K2 cannot take it);
    a CPU tensor runs the plain version with :func:`_philox_keep_mask`'s
    mask (and the statistics where the card's route writes them)."""
    if qkv.device.type == "cpu":
        out = _fused_fwd_math(qkv, heads, _keeps(seeds, qkv.shape[1], rate), 1.0 - rate)
        if not with_lse:
            return out
        return out, _fused_lse_math(qkv, heads) if writes_stats(qkv.dtype, qkv.shape[-1] // 3 // heads) else None
    if qkv.device.type == "cuda":
        return flash_attention_fused_cuda(qkv, heads, seeds, rate, with_lse=with_lse)
    raise _no_path("flash_attention_fused", qkv.device)


def flash_attention_fused_bwd(qkv: torch.Tensor, do: torch.Tensor, *, heads: int,
                              seeds: torch.Tensor | None = None, rate: float = 0.0,
                              out: torch.Tensor | None = None, lse: torch.Tensor | None = None) -> torch.Tensor:
    """The fused dqkv ``[B, S, 3*H*D]`` of :func:`flash_attention_fused` for
    the output gradient ``do``, from the forward's ``out`` and ``lse`` where
    given. A CUDA tensor runs K3; a CPU tensor the plain version."""
    if qkv.device.type == "cpu":
        return _fused_bwd_math(qkv, do, heads, _keeps(seeds, qkv.shape[1], rate), 1.0 - rate, out, lse)
    if qkv.device.type == "cuda":
        return flash_attention_fused_bwd_cuda(qkv, do, heads, seeds, rate, out=out, lse=lse)
    raise _no_path("flash_attention_fused_bwd", qkv.device)


def flash_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, heads: int,
                           seeds: torch.Tensor | None = None, rate: float = 0.0, with_lse: bool = False):
    """Attention over packed ``[B, S, H*D]`` q, k, v, dropout and
    ``with_lse`` as :func:`flash_attention_fused`'s. A CUDA tensor runs K6f
    (or raises where K6f cannot take it); a CPU tensor runs the plain
    version."""
    if q.device.type == "cpu":
        out = _packed_heads_math(q, k, v, heads, _keeps(seeds, q.shape[1], rate), 1.0 - rate)
        if not with_lse:
            return out
        return out, _packed_heads_lse_math(q, k, heads) if writes_stats(q.dtype, q.shape[-1] // heads) else None
    if q.device.type == "cuda":
        return flash_attention_packed_cuda(q, k, v, heads, seeds, rate, with_lse=with_lse)
    raise _no_path("flash_attention_packed", q.device)


def flash_attention_packed_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, *,
                               heads: int, seeds: torch.Tensor | None = None, rate: float = 0.0,
                               out: torch.Tensor | None = None, lse: torch.Tensor | None = None):
    """dq, dk, dv of :func:`flash_attention_packed` for the output gradient
    ``do``, from the forward's ``out`` and ``lse`` where given. A CUDA tensor
    runs K6b; a CPU tensor the plain version."""
    if q.device.type == "cpu":
        return _packed_heads_bwd_math(q, k, v, do, heads, _keeps(seeds, q.shape[1], rate), 1.0 - rate, out, lse)
    if q.device.type == "cuda":
        return flash_attention_packed_bwd_cuda(q, k, v, do, heads, seeds, rate, out=out, lse=lse)
    raise _no_path("flash_attention_packed_bwd", q.device)
