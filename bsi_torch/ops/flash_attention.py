"""K1: fused no-dropout attention forward, a CUDA C++ kernel for Hopper.

Counterpart of ``bsi_tpu/ops/flash_attention.py::flash_attention`` (the
``pallas_call`` of ``_attn_kernel``). The kernel source is
``csrc/flash_attention.cu``; its header note gives the design and the bound
on an H100. ``_fwd_math`` is its plain PyTorch version: the CPU path and the
reference on the card.

The backward follows the JAX package's rule (``ops/attention.py``'s
``fused_bwd``): above ``MAX_FUSED_TRAIN_SEQ`` it is the VJP of the plain
attention ``_xla_attention``, the function JAX differentiates there (the
scale and ``q * scale`` rounded to the input dtype, P V in the input dtype).
At or below it JAX has a fused backward kernel (K5b, not yet ported); until
it is, the port differentiates ``_fwd_math`` there.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

SOURCE = "flash_attention.cu"
HEAD_DIMS = (64, 128, 256)
# Longest sequence the JAX package's fused backward kernel takes; longer ones
# take the VJP of the plain attention.
MAX_FUSED_TRAIN_SEQ = 512


def _xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, dropout_rate: float = 0.0,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """Plain attention over ``[batch, heads, seq, head_dim]``, the JAX
    package's XLA formulation.

    The logits are f32 whatever the input dtype (so f64 inputs lose
    precision here), and the probabilities go back to the input dtype for
    the product with v. With ``dropout_rate > 0`` each probability is kept
    where a uniform draw from ``generator`` falls below ``1 - dropout_rate``
    and scaled by its inverse, as ``jax.random.bernoulli`` keeps it.
    """
    dim = q.shape[-1]
    scale = 1.0 / torch.sqrt(torch.tensor(dim, dtype=torch.float32)).to(q.dtype)
    acc = torch.promote_types(q.dtype, torch.float32)
    logits = torch.matmul((q * scale).to(acc), k.to(acc).transpose(-1, -2))
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    if dropout_rate > 0.0:
        keep_prob = 1.0 - dropout_rate
        keep = torch.rand(probs.shape, generator=generator, device=probs.device) < keep_prob
        probs = torch.where(keep, probs / keep_prob, 0.0)
    return torch.matmul(probs, v)


def _fwd_math(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over ``[..., S, D]``: f32 max-subtracted softmax,
    probabilities cast to v's dtype, P V accumulated in f32. Returns f32."""
    logits = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    logits = logits - logits.amax(dim=-1, keepdim=True)
    unnorm = torch.exp(logits)
    probs = unnorm / unnorm.sum(dim=-1, keepdim=True)
    return torch.matmul(probs.to(v.dtype).float(), v.float())


def _scale(q: torch.Tensor) -> float:
    return 1.0 / (q.shape[-1] ** 0.5)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch K1 on contiguous CUDA tensors ``[B, H, S, D]`` (bf16 or f32,
    D in ``HEAD_DIMS``, any S). Raises on anything else."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_cuda needs q, k, v on one CUDA device")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_cuda takes bf16 or f32, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one [B, H, S, D] shape, got {q.shape}, {k.shape}, {v.shape}")
    b, h, seq, d = q.shape
    if d not in HEAD_DIMS or seq < 1 or b * h < 1:
        raise ValueError(f"flash_attention_cuda takes head_dim in {HEAD_DIMS}, got shape {tuple(q.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_cuda needs contiguous q, k, v")
    lib = _lib()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.bsi_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b * h, seq, d, int(q.dtype == torch.bfloat16), _scale(q), stream,
        )
    _build.check(lib, code, "flash_attention kernel")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.bsi_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _forward(q, k, v):
    if q.device.type == "cpu":
        return _fwd_math(q, k, v, _scale(q)).to(q.dtype)
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v)
    raise ValueError(f"flash_attention has no path for device {q.device}")


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            if q.shape[-2] > MAX_FUSED_TRAIN_SEQ:
                out = _xla_attention(*leaves)
            else:
                out = _fwd_math(*leaves, _scale(q)).to(q.dtype)
            return torch.autograd.grad(out, leaves, g)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Fused no-dropout self-attention over ``[batch, heads, seq, head_dim]``.

    A CUDA tensor runs K1 (or raises where K1 cannot take it); a CPU tensor
    runs the plain version. Differentiable.
    """
    return _FlashAttention.apply(q, k, v)
