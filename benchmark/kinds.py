"""Which layer a device kernel belongs to, by its name.

Started from ``bsi_torch/profile_sampling.py::_kind``. The port's kernels
are told apart by the names of their CUDA and Triton functions; cuBLAS's
and cuDNN's by their libraries' names; the optimizer's and the EMA's by
the ``foreach`` (multi-tensor) kernels they alone launch.
"""

from __future__ import annotations

# (substring, kind), first match wins: K1 before K5f, since "bh_attn_fwd"
# and "packed_attn_fwd" hold "attn_fwd" too.
PORT_KERNELS = (
    ("k1_attn_fwd", "K1 attention"),
    ("bh_attn_fwd", "K5f attention"),
    ("bh_attn_bwd", "K5b attention backward"),
    ("packed_attn_fwd", "K2 fused-qkv attention"),
    ("packed_attn_bwd", "K3 fused-qkv attention backward"),
    ("ln_mod_fwd", "K4f layernorm_modulate"),
    ("ln_mod_bwd", "K4b layernorm_modulate backward"),
    ("gn_silu_fwd", "K7f groupnorm_silu"),
    ("gn_silu_bwd", "K7b groupnorm_silu backward"),
)
ATTENTION = {"K1 attention", "K5f attention", "K5b attention backward", "K2 fused-qkv attention",
             "K3 fused-qkv attention backward"}
NORM = {"K4f layernorm_modulate", "K4b layernorm_modulate backward", "K7f groupnorm_silu",
        "K7b groupnorm_silu backward"}
MATMUL = "matmul and convolution (cuBLAS, cuDNN)"
OPTIMIZER = "optimizer, clipping and EMA (foreach)"
COPY = "casts and copies"
ELEMENTWISE = "elementwise, reductions and the rest"
TRANSFER = "memcpy and memset"
# cuDNN runs the f32 UNet's 3x3 convolutions (TF32 off) by FFT: its product in
# the frequency domain is ``pointwise_mult_and_sum_complex``
_LIBRARY = ("nvjet", "gemm", "gemv", "xmma", "cutlass", "cudnn", "conv", "wgrad", "dgrad", "fprop", "winograd",
            "fft", "pointwise_mult_and_sum", "flip_filter")


def kind(name: str, category: str = "kernel") -> str:
    if category != "kernel":
        return TRANSFER
    for key, label in PORT_KERNELS:
        if key in name:
            return label
    low = name.lower()
    if any(key in low for key in _LIBRARY):
        return MATMUL
    if "foreach" in low or "multi_tensor" in low:
        return OPTIMIZER
    if "copy_kernel" in low:
        return COPY
    return ELEMENTWISE
