"""K1's plain version, the attention dispatch and the grouped qkv layout,
against the JAX package on the CPU."""

import numpy as np
import numpy.testing as npt
import pytest
import torch

import jax.numpy as jnp

from bsi_tpu.nn.attention import _merge_heads as jax_merge_heads
from bsi_tpu.nn.attention import repack_qkv_grouped as jax_repack
from bsi_tpu.ops import attention as jax_attention
from bsi_tpu.ops.flash_attention import flash_attention as jax_flash_attention

from bsi_torch.nn.attention import _merge_heads, repack_qkv_grouped
from bsi_torch.ops import attention, flash_attention as fa


def _qkv(shape, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(dtype) for _ in range(3)]


def test_twin_matches_pallas_kernel_in_interpret_mode():
    q, k, v = _qkv((1, 2, 256, 128), 0, np.float32)
    ref = np.asarray(jax_flash_attention(*map(jnp.asarray, (q, k, v)), interpret=True))
    ours = fa.flash_attention(*map(torch.from_numpy, (q, k, v)))
    assert ours.dtype == torch.float32
    npt.assert_allclose(ours.numpy(), ref, atol=1e-5, rtol=0)


def test_twin_matches_xla_attention_f64():
    # JAX's plain attention takes f32 logits even from f64 inputs, hence 1e-6.
    q, k, v = _qkv((2, 2, 64, 32), 1)
    ref = np.asarray(jax_attention._xla_attention(*map(jnp.asarray, (q, k, v))))
    ours = fa._fwd_math(*map(torch.from_numpy, (q, k, v)), 1.0 / np.sqrt(32))
    npt.assert_allclose(ours.numpy(), ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_plain_path_matches_jax(dtype):
    # Both sides round the logits to f32 and take an f32 softmax, whose exp
    # differs between the two libraries by an ulp: 1e-6 at either dtype.
    atol = 1e-6
    q, k, v = _qkv((2, 2, 64, 32), 2, dtype)
    ref = np.asarray(jax_attention.multi_head_attention(*map(jnp.asarray, (q, k, v))))
    ours = attention.multi_head_attention(*map(torch.from_numpy, (q, k, v)))
    npt.assert_allclose(ours.numpy(), ref, atol=atol, rtol=0)


def test_cpu_tensors_never_take_the_kernel_route():
    q = torch.zeros(1, 1, 1024, 128)
    assert not attention._kernel_applicable(q)


@pytest.mark.parametrize("d,heads", [(128, 1), (64, 2), (32, 2)])
def test_grouped_layout_matches_jax(d, heads):
    rng = np.random.default_rng(3)
    qkv = rng.normal(size=(2, 16, 3 * heads * d))
    ours = attention.split_qkv_grouped(torch.from_numpy(qkv), heads)
    ref = jax_attention.split_qkv_grouped(jnp.asarray(qkv), heads)
    for a, b in zip(ours, ref):
        npt.assert_array_equal(a.numpy(), np.asarray(b))
    npt.assert_array_equal(_merge_heads(ours[0]).numpy(), np.asarray(jax_merge_heads(ref[0])))
    w = rng.normal(size=(3, 3, 8, 3 * heads * d))
    npt.assert_array_equal(
        repack_qkv_grouped(torch.from_numpy(w), heads).numpy(), np.asarray(jax_repack(jnp.asarray(w), heads))
    )


def test_gradient_recomputes_through_twin():
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv((1, 1, 16, 8), 4))
    g = torch.from_numpy(np.random.default_rng(5).normal(size=(1, 1, 16, 8)))
    torch.autograd.backward(fa.flash_attention(q, k, v), g)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    torch.autograd.backward(fa._fwd_math(*leaves, 1.0 / np.sqrt(8)).double(), g)
    for ours, ref in zip((q, k, v), leaves):
        npt.assert_allclose(ours.grad.numpy(), ref.grad.numpy(), atol=1e-12)


def test_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 1, 128, 128)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q, q, q)
