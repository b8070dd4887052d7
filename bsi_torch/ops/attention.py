"""Multi-head attention dispatch.

Counterpart of ``bsi_tpu/ops/attention.py``. The JAX package routes to its
Pallas kernel on a TPU for lane-aligned shapes and to plain XLA math
elsewhere; the port routes CUDA tensors of the same shapes to K1
(:func:`bsi_torch.ops.flash_attention.flash_attention`) and everything else
to the same plain math.
"""

from __future__ import annotations

import torch

from .flash_attention import _xla_attention, flash_attention
from .flash_attention_packed import qkv_heads_per_group


def _kernel_applicable(q: torch.Tensor) -> bool:
    """The JAX package's ``_pallas_applicable`` with "tpu" read as "cuda"."""
    if q.device.type != "cuda":
        return False
    seq, head_dim = q.shape[-2], q.shape[-1]
    return head_dim in (64, 128, 256) and seq >= 128 and seq % 128 == 0


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Scaled dot-product attention over ``[batch, heads, seq, head_dim]``, no dropout.

    Routes to K1 where the JAX package would route to its Pallas kernel,
    otherwise to the plain path. Differentiable either way.
    """
    if _kernel_applicable(q):
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    return _xla_attention(q, k, v)


def split_qkv_grouped(qkv: torch.Tensor, heads: int):
    """GROUPED-layout qkv ``[B, S, (g qkv hpg d)]`` -> q, k, v ``[B, H, S, D]`` (views)."""
    b, s, three_hd = qkv.shape
    hd = three_hd // 3
    d = hd // heads
    hpg = qkv_heads_per_group(d, heads)
    x = qkv.reshape(b, s, heads // hpg, 3, hpg, d)
    pick = lambda j: x[:, :, :, j].reshape(b, s, heads, d).permute(0, 2, 1, 3)
    return pick(0), pick(1), pick(2)
