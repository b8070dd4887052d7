"""Multi-head attention dispatch.

Counterpart of ``bsi_tpu/ops/attention.py``. The JAX package routes to its
Pallas kernels on a TPU for lane-aligned shapes and to plain XLA math
elsewhere; the port routes CUDA tensors of the same shapes to its kernels
and everything else to the same plain math:

- ``[B, H, S, D]`` q, k, v (:func:`multi_head_attention`) to
  :func:`bsi_torch.ops.flash_attention.fused_attention`, the counterpart of
  JAX's ``_fused_sdpa_fn``: K5f forward and K5b backward up to
  ``MAX_FUSED_TRAIN_SEQ`` (and at any S with dropout), K1 forward and the
  plain VJP backward above it;
- the grouped qkv buffer ``[B, S, 3*H*D]``
  (:func:`multi_head_attention_fused_qkv`) to K2, and packed ``[B, S, H*D]``
  q, k, v (:func:`multi_head_attention_packed`) to K6f
  (:mod:`bsi_torch.ops.flash_attention_packed`), with K3 and K6b backward.

Dropout runs inside the kernels: one int32 seed per (batch, head), drawn
with ``torch.randint`` from ``generator`` (the device's default one when
None), from which the forward and the backward regenerate the same Philox
keep mask. On the plain path dropout draws its keep mask with
``torch.rand`` from ``generator``, as JAX's fallback draws it from its key.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from bsi_torch.utils import profiling

from .flash_attention import MAX_FUSED_TRAIN_SEQ, _xla_attention, fused_attention
from .flash_attention_packed import (
    _merge_heads,
    _split_heads,
    draw_seeds,
    flash_attention_fused_bwd_cuda,
    flash_attention_fused_cuda,
    flash_attention_packed_bwd_cuda,
    flash_attention_packed_cuda,
    packed_applicable,
    split_qkv_grouped,
)


class DrawShard(NamedTuple):
    """A rank's part of a global attention batch under a parallel layout:
    the global batch and head count, and where this rank's rows and heads
    start. The dropout draws are taken for the global ``[batch, heads]``
    and cut to this rank's block, so every head of every row draws what a
    single process running the global batch draws."""

    batch: int
    row: int
    heads: int
    head: int

    def cut(self, x: torch.Tensor, batch: int, heads: int) -> torch.Tensor:
        return x[self.row:self.row + batch, self.head:self.head + heads].contiguous()


def _kernel_applicable(q: torch.Tensor) -> bool:
    """The JAX package's ``_pallas_applicable`` with "tpu" read as "cuda"."""
    if q.device.type != "cuda":
        return False
    seq, head_dim = q.shape[-2], q.shape[-1]
    return head_dim in (64, 128, 256) and seq >= 128 and seq % 128 == 0


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         dropout_rate: float = 0.0, generator: torch.Generator | None = None,
                         shard: Optional[DrawShard] = None) -> torch.Tensor:
    """Scaled dot-product attention over ``[batch, heads, seq, head_dim]``.

    Routes to :func:`~bsi_torch.ops.flash_attention.fused_attention` where
    the JAX package routes to ``_fused_sdpa_fn``: a CUDA tensor of a shape
    the kernels take, without dropout at any S and with dropout up to
    ``MAX_FUSED_TRAIN_SEQ``; everything else takes the plain path, as in
    JAX. Differentiable. ``shard`` cuts the dropout draws from the global
    batch's (:class:`DrawShard`).
    """
    b, h, s = q.shape[:3]
    kernel = _kernel_applicable(q) and (dropout_rate == 0.0 or s <= MAX_FUSED_TRAIN_SEQ)
    if profiling.enabled():
        fused = dropout_rate > 0.0 or s <= MAX_FUSED_TRAIN_SEQ  # K5f, else K1 (and a plain backward)
        profiling.count_call("K5f" if fused else "K1", "K5b" if fused else None, kernel, q, k, v)
    if kernel:
        seeds = _seeds(b, h, q.device, dropout_rate, generator, shard)
        return fused_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               None if seeds is None else seeds.reshape(-1), dropout_rate)
    uniform = None
    if shard is not None and dropout_rate > 0.0:
        uniform = shard.cut(torch.rand((shard.batch, shard.heads, s, s), generator=generator, device=q.device), b, h)
    return _xla_attention(q, k, v, dropout_rate=dropout_rate, generator=generator, uniform=uniform)


def _takes_grad(*tensors) -> bool:
    """Whether autograd will take a gradient through these inputs: the
    forward then writes the row statistics its backward reads."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _FusedQKVAttention(torch.autograd.Function):
    """K2 forward, K3 backward; the seeds (or None at rate 0) are saved so
    that K3 regenerates K2's keep mask. With ``stats`` (a gradient will be
    taken) K2 also writes its row statistics, saved with its output for K3
    (the DiT keeps that output anyway: it is ``to_out``'s input)."""

    @staticmethod
    def forward(ctx, qkv, seeds, heads, rate, stats):
        ctx.heads, ctx.rate = heads, rate
        if stats:
            out, lse = flash_attention_fused_cuda(qkv, heads, seeds, rate, with_lse=True)
        else:
            out, lse = flash_attention_fused_cuda(qkv, heads, seeds, rate), None
        ctx.save_for_backward(qkv, seeds, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, seeds, out, lse = ctx.saved_tensors
        dqkv = flash_attention_fused_bwd_cuda(qkv, g.contiguous(), ctx.heads, seeds, ctx.rate, out=out, lse=lse)
        return dqkv, None, None, None, None


class _PackedAttention(torch.autograd.Function):
    """K6f forward, K6b backward, seeds and statistics as
    :class:`_FusedQKVAttention`."""

    @staticmethod
    def forward(ctx, q, k, v, seeds, heads, rate, stats):
        ctx.heads, ctx.rate = heads, rate
        if stats:
            out, lse = flash_attention_packed_cuda(q, k, v, heads, seeds, rate, with_lse=True)
        else:
            out, lse = flash_attention_packed_cuda(q, k, v, heads, seeds, rate), None
        ctx.save_for_backward(q, k, v, seeds, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, seeds, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_packed_bwd_cuda(q, k, v, g.contiguous(), ctx.heads, seeds, ctx.rate,
                                                     out=out, lse=lse)
        return dq, dk, dv, None, None, None, None


def _seeds(batch: int, heads: int, device, dropout_rate: float, generator, shard: Optional[DrawShard] = None):
    if dropout_rate == 0.0:
        return None
    if shard is None:
        return draw_seeds(batch, heads, device, generator)
    return shard.cut(draw_seeds(shard.batch, shard.heads, device, generator), batch, heads)


def multi_head_attention_fused_qkv(qkv: torch.Tensor, *, heads: int, dropout_rate: float = 0.0,
                                   generator: torch.Generator | None = None,
                                   shard: Optional[DrawShard] = None) -> torch.Tensor:
    """Attention straight off the fused qkv projection output.

    ``qkv``: ``[B, S, 3*H*D]`` in the GROUPED layout. A CUDA tensor of a
    shape the packed kernels take runs K2, which reads q, k and v in place,
    and K3 for its gradient, both with in-kernel dropout; anything else
    takes JAX's fallback, the split followed by :func:`multi_head_attention`.
    Output ``[B, S, H*D]``. Under a parallel layout ``heads`` are this
    rank's and ``shard`` places them and the rows in the global batch.
    """
    b, s, three_hd = qkv.shape
    if three_hd % (3 * heads):
        raise ValueError(f"fused qkv dim {three_hd} not divisible by 3*heads={3 * heads}")
    hd_total = three_hd // 3
    if qkv.device.type == "cuda" and packed_applicable(hd_total, heads, s):
        if profiling.enabled():
            profiling.count_call("K2", "K3", True, qkv)
        seeds = _seeds(b, heads, qkv.device, dropout_rate, generator, shard)
        return _FusedQKVAttention.apply(qkv.contiguous(), seeds, heads, float(dropout_rate), _takes_grad(qkv))
    q, k, v = split_qkv_grouped(qkv, heads)
    return _merge_heads(multi_head_attention(q, k, v, dropout_rate=dropout_rate, generator=generator, shard=shard))


def multi_head_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, heads: int,
                                dropout_rate: float = 0.0,
                                generator: torch.Generator | None = None) -> torch.Tensor:
    """Attention over the packed layout ``[B, S, H*D]`` (head-major columns).

    A CUDA tensor of a shape the packed kernels take runs K6f (K6b for its
    gradient), with in-kernel dropout; anything else takes JAX's fallback,
    a split into ``[B, H, S, D]`` followed by :func:`multi_head_attention`
    and a merge.
    """
    b, s, hd_total = q.shape
    if hd_total % heads:
        raise ValueError(f"feature dim {hd_total} not divisible by heads={heads}")
    if q.device.type == "cuda" and packed_applicable(hd_total, heads, s):
        seeds = _seeds(b, heads, q.device, dropout_rate, generator)
        return _PackedAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), seeds, heads,
                                      float(dropout_rate), _takes_grad(q, k, v))
    out = multi_head_attention(*(_split_heads(x, heads) for x in (q, k, v)),
                               dropout_rate=dropout_rate, generator=generator)
    return _merge_heads(out)
