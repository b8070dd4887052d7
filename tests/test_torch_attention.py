"""K1's plain version, the attention dispatch and the grouped qkv layout,
against the JAX package on the CPU."""

import numpy as np
import numpy.testing as npt
import pytest
import torch

import jax
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
    ours = fa.fused_attention(*map(torch.from_numpy, (q, k, v)))
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
    # At S <= 512 the backward is K5b's plain version, _bwd_math, which
    # recomputes the softmax; it is the gradient of the forward's twin up to
    # the f32 logits both take.
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv((1, 1, 16, 8), 4))
    g = torch.from_numpy(np.random.default_rng(5).normal(size=(1, 1, 16, 8)))
    torch.autograd.backward(fa.fused_attention(q, k, v), g)
    plain = fa._bwd_math(q.detach(), k.detach(), v.detach(), g, 1.0 / np.sqrt(8))
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    torch.autograd.backward(fa._fwd_math(*leaves, 1.0 / np.sqrt(8)).double(), g)
    for ours, want, ref in zip((q, k, v), plain, leaves):
        npt.assert_array_equal(ours.grad.numpy(), want.double().numpy())
        npt.assert_allclose(ours.grad.numpy(), ref.grad.numpy(), atol=1e-6)


def test_backward_above_512_is_the_vjp_of_jax_plain_attention():
    # JAX differentiates _xla_attention above MAX_FUSED_TRAIN_SEQ. Values v
    # close to one constant make dP = g v^T nearly constant along each row,
    # so the softmax backward cancels to 1e-3 of its inputs and shows which
    # formulation is differentiated: the VJP of _xla_attention stays within
    # the tolerance, the recomputation through _fwd_math (the backward before
    # this rule) misses it at f32 by 2x.
    rng = np.random.default_rng(6)
    shape = (1, 2, 640, 64)
    q, k, g = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    v = (1.0 + 0.01 * rng.normal(size=shape)).astype(np.float32)
    _, vjp = jax.vjp(jax_attention._xla_attention, *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(w) for w in vjp(jnp.asarray(g))]
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = torch.autograd.grad(fa.fused_attention(*leaves), leaves, torch.from_numpy(g))
    old_leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    old = torch.autograd.grad(fa._fwd_math(*old_leaves, fa._scale(old_leaves[0])), old_leaves,
                              torch.from_numpy(g))
    # f32 on both sides; 1e-4 of each gradient's largest element
    tol = [1e-4 * np.abs(w).max() for w in want]
    for ours, w, t in zip(got, want, tol):
        assert np.abs(ours.numpy() - w).max() <= t
    assert any(np.abs(o.numpy() - w).max() > t for o, w, t in zip(old, want, tol))
    # in bf16 the backward is exactly autograd through the plain attention
    bf = [torch.from_numpy(a).bfloat16().requires_grad_() for a in (q, k, v)]
    got_bf = torch.autograd.grad(fa.fused_attention(*bf), bf, torch.from_numpy(g).bfloat16())
    plain = [a.detach().clone().requires_grad_() for a in bf]
    want_bf = torch.autograd.grad(fa._xla_attention(*plain), plain, torch.from_numpy(g).bfloat16())
    for ours, w in zip(got_bf, want_bf):
        assert torch.equal(ours, w)


def test_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 1, 128, 128)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q, q, q)
