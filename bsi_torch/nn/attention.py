"""Attention modules: the DiT's token attention and the UNet's pixel attention.

Counterpart of ``bsi_tpu/nn/attention.py`` (``TokenAttention``,
``Attention2D``). The qkv projections' output channels use the JAX
package's GROUPED layout (see :func:`repack_qkv_grouped`), so weights
converted from JAX need no reshuffle, and the token attention's projection
output feeds the fused-qkv kernel (K2) as it is.
"""

from __future__ import annotations

import torch
from torch import nn

from bsi_torch.ops import multi_head_attention, multi_head_attention_fused_qkv, split_qkv_grouped
from bsi_torch.ops.attention import DrawShard
from bsi_torch.ops.flash_attention_packed import _merge_heads, qkv_heads_per_group

from .layers import Conv, Dense


def repack_qkv_grouped(w: torch.Tensor, heads: int) -> torch.Tensor:
    """Permute a reference-layout ``(qkv h c)`` packed LAST axis to the GROUPED
    ``(g qkv hpg c)`` layout, as the JAX package's function of the same name."""
    shape = w.shape
    d = shape[-1] // (3 * heads)
    hpg = qkv_heads_per_group(d, heads)
    w = w.reshape(shape[:-1] + (3, heads // hpg, hpg * d))
    w = torch.movedim(w, -3, -2)  # (qkv g x) -> (g qkv x)
    return w.reshape(shape)


class TokenAttention(nn.Module):
    """Multi-head self-attention over a token sequence ``[B, S, F]``: a Dense
    qkv projection in the grouped layout straight into
    :func:`bsi_torch.ops.multi_head_attention_fused_qkv`, then a Dense out
    projection. Attention dropout at ``dropout`` is on in ``train()`` mode.

    Under a parallel layout (:meth:`set_layout`) the dropout draws are the
    global batch's, cut to this rank's rows and heads; with tensor
    parallelism ``to_qkv`` and ``to_out`` are a Megatron column/row pair
    and the kernels see this rank's ``heads / tp`` heads. A pipeline
    microbatch (``rows``, :class:`bsi_torch.parallel.pipeline.MicroRows`)
    cuts its rows out of its stage's local batch the same way."""

    def __init__(self, dim: int, heads: int, dropout: float = 0.0, *, dtype=None, device=None):
        super().__init__()
        self.heads = heads
        self.dropout = dropout
        self.to_qkv = Dense(dim, 3 * dim, dtype=dtype, device=device)
        self.to_out = Dense(dim, dim, dtype=dtype, device=device)
        self.mesh = None
        self.tp = None

    def set_layout(self, mesh, tp) -> None:
        """``mesh``: the :class:`~bsi_torch.parallel.Mesh` (None: one
        process); ``tp``: its :class:`~bsi_torch.parallel.TensorParallel`
        or None."""
        self.mesh, self.tp = mesh, tp

    def _shard(self, batch: int, heads: int, rows=None):
        distributed = self.mesh is not None and self.mesh.distributed
        if not distributed and rows is None:
            return None
        data_size, data_rank = (self.mesh.data_size, self.mesh.data_rank) if distributed else (1, 0)
        head = self.mesh.model_rank * heads if self.tp is not None else 0
        local, row = (batch, 0) if rows is None else (rows.batch, rows.row)
        return DrawShard(local * data_size, data_rank * local + row, self.heads, head)

    def forward(self, x: torch.Tensor, rows=None) -> torch.Tensor:
        rate = self.dropout if self.training else 0.0
        tp = self.tp
        heads = self.heads if tp is None else self.heads // tp.size
        qkv = self.to_qkv(x if tp is None else tp.enter(x))
        out = multi_head_attention_fused_qkv(qkv, heads=heads, dropout_rate=rate,
                                             shard=self._shard(qkv.shape[0], heads, rows))
        return self.to_out(out) if tp is None else tp.leave(self.to_out, out)


class Attention2D(nn.Module):
    """Self-attention over all pixels of an NCHW feature map, with 3x3
    convolutions as the qkv and output projections."""

    def __init__(self, channels: int, heads: int = 4, *, dtype=None, device=None):
        super().__init__()
        self.heads = heads
        self.to_qkv = Conv(channels, 3 * channels, 3, dtype=dtype, device=device)
        self.to_out = Conv(channels, channels, 3, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        qkv = self.to_qkv(x).permute(0, 2, 3, 1).reshape(b, h * w, 3 * c)
        q, k, v = split_qkv_grouped(qkv, self.heads)
        out = multi_head_attention(q, k, v)
        out = _merge_heads(out).reshape(b, h, w, c).permute(0, 3, 1, 2)
        return self.to_out(out)
