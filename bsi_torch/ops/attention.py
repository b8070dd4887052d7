"""Multi-head attention dispatch.

Counterpart of ``bsi_tpu/ops/attention.py``. The JAX package routes to its
Pallas kernels on a TPU for lane-aligned shapes and to plain XLA math
elsewhere; the port routes CUDA tensors of the same shapes to its kernels
and everything else to the same plain math:

- ``[B, H, S, D]`` q, k, v (:func:`multi_head_attention`) to K1
  (:func:`bsi_torch.ops.flash_attention.flash_attention`);
- the grouped qkv buffer ``[B, S, 3*H*D]``
  (:func:`multi_head_attention_fused_qkv`) to K2, and packed ``[B, S, H*D]``
  q, k, v (:func:`multi_head_attention_packed`) to K6f
  (:mod:`bsi_torch.ops.flash_attention_packed`).

The backwards of K2 and K6f (K3, K6b) and the kernels' Philox dropout are
not ported yet: on a CUDA tensor that takes K2 or K6f, a backward or a
dropout rate above 0 raises. On the plain path dropout draws its keep mask
with ``torch.rand`` from ``generator`` (the device's default one when None).
"""

from __future__ import annotations

import torch

from .flash_attention import MAX_FUSED_TRAIN_SEQ, _xla_attention, flash_attention
from .flash_attention_packed import (
    _merge_heads,
    _split_heads,
    flash_attention_fused_cuda,
    flash_attention_packed_cuda,
    packed_applicable,
    split_qkv_grouped,
)


def _kernel_applicable(q: torch.Tensor) -> bool:
    """The JAX package's ``_pallas_applicable`` with "tpu" read as "cuda"."""
    if q.device.type != "cuda":
        return False
    seq, head_dim = q.shape[-2], q.shape[-1]
    return head_dim in (64, 128, 256) and seq >= 128 and seq % 128 == 0


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         dropout_rate: float = 0.0, generator: torch.Generator | None = None) -> torch.Tensor:
    """Scaled dot-product attention over ``[batch, heads, seq, head_dim]``.

    Routes to K1 where the JAX package would route to its Pallas kernel,
    otherwise to the plain path. With dropout, the JAX package's kernel for
    sequences up to 512 (K5f) is not ported: a CUDA tensor of such a shape
    raises; longer or unaligned ones take the plain path, as in JAX.
    Differentiable.
    """
    if dropout_rate == 0.0:
        if _kernel_applicable(q):
            return flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
        return _xla_attention(q, k, v)
    if _kernel_applicable(q) and q.shape[-2] <= MAX_FUSED_TRAIN_SEQ:
        raise NotImplementedError(
            "attention dropout on CUDA tensors of this shape needs K5f "
            "(flash_attention_dropout), which is not ported yet")
    return _xla_attention(q, k, v, dropout_rate=dropout_rate, generator=generator)


def _no_dropout_on_kernel(dropout_rate: float, backward: str) -> None:
    if dropout_rate > 0.0:
        raise NotImplementedError(
            f"attention dropout inside the packed kernels comes with {backward} (Philox masks "
            "regenerated in the backward), which is not ported yet")


class _FusedQKVAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, heads):
        return flash_attention_fused_cuda(qkv, heads)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "the backward of K2 is K3 (flash_attention_fused_bwd), which is not ported yet")


class _PackedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, heads):
        return flash_attention_packed_cuda(q, k, v, heads)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "the backward of K6f is K6b (flash_attention_packed_bwd), which is not ported yet")


def multi_head_attention_fused_qkv(qkv: torch.Tensor, *, heads: int, dropout_rate: float = 0.0,
                                   generator: torch.Generator | None = None) -> torch.Tensor:
    """Attention straight off the fused qkv projection output.

    ``qkv``: ``[B, S, 3*H*D]`` in the GROUPED layout. A CUDA tensor of a
    shape the packed kernels take runs K2, which reads q, k and v in place;
    anything else takes JAX's fallback, the split followed by
    :func:`multi_head_attention`. Output ``[B, S, H*D]``.
    """
    b, s, three_hd = qkv.shape
    if three_hd % (3 * heads):
        raise ValueError(f"fused qkv dim {three_hd} not divisible by 3*heads={3 * heads}")
    hd_total = three_hd // 3
    if qkv.device.type == "cuda" and packed_applicable(hd_total, heads, s):
        _no_dropout_on_kernel(dropout_rate, "K3")
        return _FusedQKVAttention.apply(qkv.contiguous(), heads)
    q, k, v = split_qkv_grouped(qkv, heads)
    return _merge_heads(multi_head_attention(q, k, v, dropout_rate=dropout_rate, generator=generator))


def multi_head_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, heads: int,
                                dropout_rate: float = 0.0,
                                generator: torch.Generator | None = None) -> torch.Tensor:
    """Attention over the packed layout ``[B, S, H*D]`` (head-major columns).

    A CUDA tensor of a shape the packed kernels take runs K6f; anything else
    takes JAX's fallback, a split into ``[B, H, S, D]`` followed by
    :func:`multi_head_attention` and a merge.
    """
    b, s, hd_total = q.shape
    if hd_total % heads:
        raise ValueError(f"feature dim {hd_total} not divisible by heads={heads}")
    if q.device.type == "cuda" and packed_applicable(hd_total, heads, s):
        _no_dropout_on_kernel(dropout_rate, "K6b")
        return _PackedAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), heads)
    out = multi_head_attention(*(_split_heads(x, heads) for x in (q, k, v)),
                               dropout_rate=dropout_rate, generator=generator)
    return _merge_heads(out)
