"""K4f's and K4b's plain versions, the LayerNorm+modulate dispatch and the
flax LayerNorm, against the JAX package on the CPU."""

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from bsi_tpu.ops import ln_modulate as jax_lm

from bsi_torch.nn import LayerNorm
from bsi_torch.ops import ln_modulate as lm


def _inputs(shape, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    b, s, d = shape
    x = (rng.normal(size=shape) * 2 + 0.5).astype(dtype)
    shift = rng.normal(size=(b, d)).astype(dtype)
    scale = (rng.normal(size=(b, d)) * 0.1).astype(dtype)
    return x, shift, scale


def test_plain_matches_jax_reference_f64():
    x, shift, scale = _inputs((3, 16, 128), 0)
    want = np.asarray(jax_lm._reference_math(*map(jnp.asarray, (x, shift, scale))))
    got = lm._reference_math(*map(torch.from_numpy, (x, shift, scale)))
    assert got.dtype == torch.float64
    npt.assert_allclose(got.numpy(), want, atol=1e-12, rtol=0)


@pytest.mark.parametrize("shape", [(4, 16, 128), (8, 8, 256)])
def test_plain_matches_pallas_kernel_in_interpret_mode(shape):
    # f32 on both sides; the statistics are summed in another order: 1e-5
    x, shift, scale = _inputs(shape, 1, np.float32)
    want = np.asarray(jax_lm._fwd_pallas(*map(jnp.asarray, (x, shift, scale)), interpret=True))
    got = lm._reference_math(*map(torch.from_numpy, (x, shift, scale)))
    assert got.dtype == torch.float32
    npt.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_cpu_entry_value_and_gradient_match_jax_f64():
    # On the CPU both packages take the plain math; the port's backward is
    # autograd through it, JAX's the VJP of its fallback.
    x, shift, scale = _inputs((2, 8, 128), 2)
    g = np.random.default_rng(3).normal(size=x.shape)
    out, vjp = jax.vjp(jax_lm.layernorm_modulate, *map(jnp.asarray, (x, shift, scale)))
    want_grads = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, shift, scale)]
    got = lm.layernorm_modulate(*leaves)
    npt.assert_allclose(got.detach().numpy(), np.asarray(out), atol=1e-12, rtol=0)
    for ours, want in zip(torch.autograd.grad(got, leaves, torch.from_numpy(g)), want_grads):
        npt.assert_allclose(ours.numpy(), np.asarray(want), atol=1e-10, rtol=0)


@pytest.mark.parametrize("shape", [(4, 16, 128), (8, 8, 256)])
def test_bwd_plain_matches_pallas_kernel_in_interpret_mode(shape):
    # K4b's plain version against the TPU kernel in interpret mode, f32 on
    # both sides, the sums in another order: 1e-5
    x, _, scale = _inputs(shape, 5, np.float32)
    g = np.random.default_rng(6).normal(size=shape).astype(np.float32)
    want = jax_lm._bwd_pallas(*map(jnp.asarray, (x, scale, g)), interpret=True)
    got = lm._bwd_math(*map(torch.from_numpy, (x, scale, g)))
    for ours, ref in zip(got, want):
        assert ours.dtype == torch.float32
        npt.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_bwd_plain_matches_jax_fallback_vjp_f64():
    x, shift, scale = _inputs((3, 8, 128), 7)
    g = np.random.default_rng(8).normal(size=x.shape)
    _, vjp = jax.vjp(jax_lm.layernorm_modulate, *map(jnp.asarray, (x, shift, scale)))
    got = lm._bwd_math(*map(torch.from_numpy, (x, scale, g)))
    for ours, ref in zip(got, vjp(jnp.asarray(g))):
        assert ours.dtype == torch.float64
        npt.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-10, rtol=0)


def test_bwd_plain_casts_as_the_tpu_kernel():
    # dx in x's dtype, dshift and dscale in scale's
    x, _, scale = _inputs((2, 8, 128), 9, np.float32)
    g = np.random.default_rng(10).normal(size=x.shape).astype(np.float32)
    xt, gt = torch.from_numpy(x).bfloat16(), torch.from_numpy(g).bfloat16()
    dx, dshift, dscale = lm._bwd_math(xt, torch.from_numpy(scale).bfloat16(), gt)
    assert dx.dtype == dshift.dtype == dscale.dtype == torch.bfloat16
    assert dshift.shape == dscale.shape == (2, 128)


def test_kernel_route_follows_the_jax_rule():
    assert lm._shape_applicable(256, 1024)  # DiT-L/2
    assert not lm._shape_applicable(256, 1000)  # lanes
    assert not lm._shape_applicable(250, 1024)  # sublanes
    assert not lm._shape_applicable(4096, 1024)  # 48 MiB of f32 > 12 MiB
    assert not lm._kernel_applicable(torch.zeros(1, 256, 1024))  # CPU tensors never


def test_kernel_wrapper_refuses_cpu_tensors():
    x = torch.zeros(1, 8, 128)
    with pytest.raises(ValueError, match="CUDA"):
        lm.layernorm_modulate_cuda(x, x[:, 0], x[:, 0])
    with pytest.raises(ValueError, match="CUDA"):
        lm.layernorm_modulate_bwd_cuda(x, x[:, 0], x)


@pytest.mark.parametrize("dtype", [None, jnp.bfloat16])
def test_layernorm_matches_flax(dtype):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 16, 64)) * 3 + 1.0
    params = {"scale": rng.normal(size=64).astype(np.float32) + 1.0,
              "bias": rng.normal(size=64).astype(np.float32)}
    ref = flax_nn.LayerNorm(dtype=dtype)
    ours = LayerNorm(64, dtype=None if dtype is None else torch.bfloat16, device="cpu")
    ours.load_state_dict({"weight": torch.from_numpy(params["scale"]), "bias": torch.from_numpy(params["bias"])})
    if dtype is None:
        # f64 input, f32 parameters: f64 statistics and output
        want = np.asarray(ref.apply({"params": params}, jnp.asarray(x)))
        got = ours(torch.from_numpy(x))
        assert got.dtype == torch.float64
        npt.assert_allclose(got.detach().numpy(), want, atol=1e-12, rtol=0)
    else:
        # f32 input: f32 statistics, bf16 output; the two libraries' f32
        # sums can move the final rounding by one bf16 ulp
        x32 = x.astype(np.float32)
        want = np.asarray(ref.apply({"params": params}, jnp.asarray(x32)).astype(jnp.float32))
        got = ours(torch.from_numpy(x32))
        assert got.dtype == torch.bfloat16
        npt.assert_allclose(got.float().detach().numpy(), want, atol=1e-6, rtol=2**-8)
