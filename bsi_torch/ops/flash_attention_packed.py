"""K2 and K6f: attention over heads read in place from the packed layouts,
a CUDA C++ kernel for Hopper; the grouped qkv layout helpers.

Counterpart of ``bsi_tpu/ops/flash_attention_packed.py``. K2
(:func:`flash_attention_fused`) reads q, k and v straight out of the qkv
projection's output ``[B, S, 3*H*D]`` in the GROUPED layout
(:func:`qkv_heads_per_group`) and writes ``[B, S, H*D]``, with no split or
merge copy; K6f (:func:`flash_attention_packed`) runs the same kernel over
three ``[B, S, H*D]`` tensors. One kernel serves both: it takes the layout
(row stride, column stride between head groups, heads per group) as
arguments. The source is ``csrc/flash_attention_packed.cu``; its header note
gives the design and the bound on an H100.

``_packed_fwd_math`` is the plain PyTorch version of the kernel's per-head
math (the TPU kernel's ``_packed_fwd_math``), with optional explicit keep
masks for attention dropout; ``_fused_fwd_math`` and ``_packed_heads_math``
are the plain versions of the two entries. Dropout inside the kernels, and
their backwards (K3, K6b), are not ported yet.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .flash_attention import MAX_FUSED_TRAIN_SEQ

LANE = 128
SOURCE = "flash_attention_packed.cu"
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


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    # [B, S, H*D] -> [B, H, S, D]
    b, s, hd = x.shape
    return x.reshape(b, s, heads, hd // heads).permute(0, 2, 1, 3)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    # [B, H, S, D] -> [B, S, H*D]
    b, h, s, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, s, h * d)


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


def _check_cuda(name: str, tensors, heads: int, width: int) -> int:
    """Raise unless every tensor is a contiguous, 16-byte aligned CUDA
    ``[B, S, width]`` of one shape and dtype (bf16 or f32) with whole heads
    of a supported size. Returns the head dim."""
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


def _launch(q_ptr, k_ptr, v_ptr, out, batch, seq, heads, head_dim, hpg, group_stride, in_ld, what):
    lib = _lib()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        code = lib.bsi_packed_attention_fwd(
            q_ptr, k_ptr, v_ptr, out.data_ptr(), batch, seq, heads, head_dim, hpg,
            group_stride, in_ld, out.shape[-1], int(out.dtype == torch.bfloat16),
            _scale(head_dim), stream,
        )
    _build.check(lib, code, what)


def flash_attention_fused_cuda(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Launch K2 on a contiguous CUDA grouped qkv buffer ``[B, S, 3*H*D]``
    (bf16 or f32, D in ``HEAD_DIMS``, any S). Returns ``[B, S, H*D]`` in
    qkv's dtype. Raises on anything else."""
    head_dim = _check_cuda("flash_attention_fused_cuda", (qkv,), heads, 3)
    b, seq, three_hd = qkv.shape
    hpg = qkv_heads_per_group(head_dim, heads)
    out = torch.empty(b, seq, three_hd // 3, dtype=qkv.dtype, device=qkv.device)
    base, step = qkv.data_ptr(), hpg * head_dim * qkv.element_size()
    _launch(base, base + step, base + 2 * step, out, b, seq, heads, head_dim, hpg,
            3 * hpg * head_dim, three_hd, "flash_attention_fused kernel")
    flash_attention_fused_cuda.launches += 1
    return out


flash_attention_fused_cuda.launches = 0


def flash_attention_packed_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """Launch K6f on contiguous CUDA ``[B, S, H*D]`` q, k, v (bf16 or f32, D
    in ``HEAD_DIMS``, any S). Returns ``[B, S, H*D]``. Raises on anything else."""
    head_dim = _check_cuda("flash_attention_packed_cuda", (q, k, v), heads, 1)
    b, seq, hd = q.shape
    out = torch.empty_like(q)
    _launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out, b, seq, heads, head_dim, 1,
            head_dim, hd, "flash_attention_packed kernel")
    flash_attention_packed_cuda.launches += 1
    return out


flash_attention_packed_cuda.launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.bsi_packed_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 3
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def flash_attention_fused(qkv: torch.Tensor, *, heads: int) -> torch.Tensor:
    """No-dropout attention straight off a grouped qkv buffer ``[B, S, 3*H*D]``
    -> ``[B, S, H*D]``. A CUDA tensor runs K2 (or raises where K2 cannot take
    it); a CPU tensor runs the plain version. Forward only."""
    if qkv.device.type == "cpu":
        return _fused_fwd_math(qkv, heads)
    if qkv.device.type == "cuda":
        return flash_attention_fused_cuda(qkv, heads)
    raise ValueError(f"flash_attention_fused has no path for device {qkv.device}")


def flash_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, heads: int) -> torch.Tensor:
    """No-dropout attention over packed ``[B, S, H*D]`` q, k, v. A CUDA tensor
    runs K6f (or raises where K6f cannot take it); a CPU tensor runs the
    plain version. Forward only."""
    if q.device.type == "cpu":
        return _packed_heads_math(q, k, v, heads)
    if q.device.type == "cuda":
        return flash_attention_packed_cuda(q, k, v, heads)
    raise ValueError(f"flash_attention_packed has no path for device {q.device}")
