"""The port's kernels and their dispatch.

K1, K5f and K5b live in :mod:`bsi_torch.ops.flash_attention`, K2, K6f, K3
and K6b in :mod:`bsi_torch.ops.flash_attention_packed` (the attention
kernels' dropout mask in :mod:`bsi_torch.ops.dropout_mask`), K4f and K4b in
:mod:`bsi_torch.ops.ln_modulate`, K7 in :mod:`bsi_torch.ops.groupnorm_silu` and
K8f, the f32 3x3 convolution, in :mod:`bsi_torch.ops.conv3x3`;
their entry functions are not re-exported here, so the module names stay the
modules.
"""

from .attention import (
    multi_head_attention,
    multi_head_attention_fused_qkv,
    multi_head_attention_packed,
    split_qkv_grouped,
)

__all__ = [
    "multi_head_attention",
    "multi_head_attention_fused_qkv",
    "multi_head_attention_packed",
    "split_qkv_grouped",
]
