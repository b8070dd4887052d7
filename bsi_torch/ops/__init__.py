"""The port's kernels and their dispatch.

K1 lives in :mod:`bsi_torch.ops.flash_attention` and K7's forward in
:mod:`bsi_torch.ops.groupnorm_silu`; their entry functions are not re-exported
here, so the module names stay the modules.
"""

from .attention import multi_head_attention, split_qkv_grouped

__all__ = ["multi_head_attention", "split_qkv_grouped"]
