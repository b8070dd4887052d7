"""K7's plain versions (forward and backward) and the GroupNorm modules
against the JAX package on the CPU."""

import importlib

import numpy as np
import numpy.testing as npt
import pytest
import torch

import flax.linen as flax_nn
import jax
import jax.numpy as jnp

# bsi_tpu.ops re-exports the function under the module's name
jax_gn = importlib.import_module("bsi_tpu.ops.groupnorm_silu")

from bsi_torch.nn import GroupNorm, GroupNormSiLU
from bsi_torch.ops import groupnorm_silu as gn


def _inputs(shape, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.normal(size=shape) * 2.0 + 0.5).astype(dtype)
    gamma = (1.0 + 0.1 * rng.normal(size=(c,))).astype(dtype)
    beta = (0.1 * rng.normal(size=(c,))).astype(dtype)
    return x, gamma, beta


@pytest.mark.parametrize("c", [128, 256])
def test_twin_matches_reference_math_f64(c):
    x, gamma, beta = _inputs((2, 64, c), c)
    ref = np.asarray(jax_gn._reference_math(*map(jnp.asarray, (x, gamma, beta)), 32))
    ours = gn.groupnorm_silu(*map(torch.from_numpy, (x, gamma, beta)), 32)
    npt.assert_allclose(ours.numpy(), ref, rtol=1e-10, atol=1e-13)


def test_twin_matches_pallas_kernel_in_interpret_mode():
    x, gamma, beta = _inputs((2, 64, 128), 7, np.float32)
    ref = np.asarray(
        jax_gn._fwd_pallas(*map(jnp.asarray, (x, gamma, beta)), groups=32, interpret=True)
    )
    ours = gn._reference_math(*map(torch.from_numpy, (x, gamma, beta)), 32)
    npt.assert_allclose(ours.numpy(), ref, atol=1e-5, rtol=0)


def _flax_groupnorm(x_nhwc, gamma, beta, silu):
    module = flax_nn.GroupNorm(num_groups=32)
    params = {"params": {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)}}
    out = module.apply(params, jnp.asarray(x_nhwc))
    return np.asarray(flax_nn.silu(out) if silu else out)


@pytest.mark.parametrize("silu", [True, False])
def test_modules_match_flax_groupnorm(silu):
    x, gamma, beta = _inputs((2, 4, 4, 64), 8)
    module = GroupNormSiLU(64, 32, device="cpu") if silu else GroupNorm(64, 32, device="cpu")
    module.double()
    with torch.no_grad():
        module.weight.copy_(torch.from_numpy(gamma))
        module.bias.copy_(torch.from_numpy(beta))
    x_nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
    ours = module(x_nchw).permute(0, 2, 3, 1).detach().numpy()
    npt.assert_allclose(ours, _flax_groupnorm(x, gamma, beta, silu), rtol=1e-10, atol=1e-12)


def test_gradient_recomputes_through_twin():
    x, gamma, beta = (torch.from_numpy(a).requires_grad_() for a in _inputs((2, 8, 64), 9))
    g = torch.from_numpy(np.random.default_rng(10).normal(size=(2, 8, 64)))
    torch.autograd.backward(gn.groupnorm_silu(x, gamma, beta, 32), g)
    ref_x, ref_g, ref_b = (a.detach().clone().requires_grad_() for a in (x, gamma, beta))
    _, vjp = jax.vjp(
        lambda a, b, c: jax_gn._reference_math(a, b, c, 32),
        *(jnp.asarray(a.detach().numpy()) for a in (ref_x, ref_g, ref_b)),
    )
    for ours, ref in zip((x, gamma, beta), vjp(jnp.asarray(g.numpy()))):
        npt.assert_allclose(ours.grad.numpy(), np.asarray(ref), rtol=1e-9, atol=1e-11)


def _bwd_inputs(shape, seed, dtype=np.float64):
    x, gamma, beta = _inputs(shape, seed, dtype)
    g = np.random.default_rng(seed + 100).normal(size=shape).astype(dtype)
    return x, gamma, beta, g


@pytest.mark.parametrize("c", [64, 128])
def test_bwd_math_matches_jax_vjp_f64(c):
    x, gamma, beta, g = _bwd_inputs((2, 16, c), 20 + c)
    _, vjp = jax.vjp(lambda a, b_, c_: jax_gn._reference_math(a, b_, c_, 32),
                     *map(jnp.asarray, (x, gamma, beta)))
    want = vjp(jnp.asarray(g))
    got = gn._bwd_math(*map(torch.from_numpy, (x, gamma, beta, g)), 32)
    for ours, ref in zip(got, want):
        npt.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-12)


def test_bwd_math_matches_pallas_kernel_in_interpret_mode():
    x, gamma, beta, g = _bwd_inputs((4, 16, 128), 21, np.float32)
    dx, dgamma_b, dbeta_b = jax_gn._bwd_pallas(*map(jnp.asarray, (x, gamma, beta, g)), groups=32,
                                               interpret=True)
    got = gn._bwd_math(*map(torch.from_numpy, (x, gamma, beta, g)), 32)
    # f32 on both sides, sums in another order (the partials over 16 rows,
    # then over 4 images): the JAX package's own kernel test holds 3e-5
    for ours, ref in zip(got, (dx, dgamma_b.sum(0), dbeta_b.sum(0))):
        npt.assert_allclose(ours.numpy(), np.asarray(ref), atol=3e-5, rtol=0)


def test_bwd_math_matches_autograd_through_forward_twin():
    # The second reference: autograd through _reference_math, which at f64
    # rounds nothing, so it is the same function.
    x, gamma, beta, g = _bwd_inputs((3, 10, 64), 22)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, gamma, beta)]
    want = torch.autograd.grad(gn._reference_math(*leaves, 32), leaves, torch.from_numpy(g))
    got = gn._bwd_math(*map(torch.from_numpy, (x, gamma, beta, g)), 32)
    for ours, ref in zip(got, want):
        npt.assert_allclose(ours.numpy(), ref.numpy(), rtol=1e-10, atol=1e-12)


def test_cpu_backward_takes_the_plain_vjp(monkeypatch):
    calls = []
    real = gn._bwd_math
    monkeypatch.setattr(gn, "_bwd_math", lambda *a: calls.append(1) or real(*a))
    x, gamma, beta = (torch.from_numpy(a).requires_grad_() for a in _inputs((2, 8, 64), 23))
    gn.groupnorm_silu(x, gamma, beta, 32).sum().backward()
    assert calls == [1]
    with pytest.raises(ValueError, match="no backward"):
        gn._backward(*(t.detach().to("meta") for t in (x, gamma, beta, x)), 32)


def test_channel_blocks_hold_whole_groups():
    # 16 channels of all 1,024 rows per program at the UNet's shapes
    assert gn._block_c(1024, 128, 32) == 16
    assert gn._block_c(1024, 256, 32) == 16
    assert gn._block_c(4096, 128, 32) == 4
    assert gn._block_c(100, 64, 32) == 64
    with pytest.raises(ValueError):
        gn._block_c(1024, 96, 32)  # 3 channels per group: no power-of-two block


def test_kernel_wrapper_refuses_cpu_tensors():
    x, gamma, beta = (torch.from_numpy(a).float() for a in _inputs((2, 8, 64), 11))
    with pytest.raises(ValueError, match="CUDA"):
        gn.groupnorm_silu_cuda(x, gamma, beta, 32)
    with pytest.raises(ValueError, match="CUDA"):
        gn.groupnorm_silu_bwd_cuda(x, gamma, beta, x, 32)
