"""Grouped qkv layout helpers, copied from ``bsi_tpu/ops/flash_attention_packed.py``.

The packed attention kernels themselves (K2, K3, K6) come with the DiT slice.
"""

from __future__ import annotations

LANE = 128


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
