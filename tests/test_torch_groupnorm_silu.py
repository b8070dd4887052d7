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


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows", [64, 256, 1024, 4096])
@pytest.mark.parametrize("c", [32, 64, 128, 256])
def test_plan_cuts_slabs_of_whole_groups(c, rows, dtype, backward):
    b, size = 64, dtype.itemsize
    p = gn.plan(b, rows, c, 32, dtype, backward)
    # a slab is 128 bytes of every row (or the whole row), whole groups
    assert p.width == min(c, 128 // size)
    assert c % p.width == 0 and p.width % (c // 32) == 0
    assert p.slabs == b * c // p.width
    # TMA boxes of at most 256 rows and 8 KB, rows past the end zero-filled
    assert p.chunk_rows % 8 == 0 and p.chunk_rows <= 256 and p.chunk_rows * p.width * size <= 8192
    assert p.chunks == -(-rows // p.chunk_rows)
    assert p.cluster in (1, 2, 4, 8) and p.cluster <= p.chunks
    # a CTA's share of the slab: its chunks of x, and of g backward
    share = lambda n: -(-p.chunks // n) * p.chunk_rows * p.width * size * (2 if backward else 1)
    assert share(p.cluster) < p.smem_bytes <= gn.SMEM_LIMIT
    # the least cluster whose share fits 64 KB and whose CTAs fill half the
    # card
    assert share(p.cluster) <= 65536 or p.cluster == min(8, p.chunks)
    if p.cluster > 1:
        assert share(p.cluster // 2) > 65536 or p.slabs * p.cluster < 132


@pytest.mark.parametrize("shape,dtype,backward,want", [
    # the 32x32 UNet's sampling forwards: 128 KB slabs over 2 CTAs, three an SM
    ((64, 1024, 128), torch.bfloat16, False, (64, 64, 16, 2, 128, 72320)),
    ((64, 1024, 256), torch.bfloat16, False, (64, 64, 16, 2, 256, 72320)),
    # its train step's backwards: x and g, 256 KB a slab over 4 CTAs
    ((128, 1024, 128), torch.bfloat16, True, (64, 64, 16, 4, 256, 72832)),
    ((128, 1024, 256), torch.bfloat16, True, (64, 64, 16, 4, 512, 72832)),
    # the 16x16 eval step's f32 forward: 32 channels a slab
    ((64, 256, 128), torch.float32, False, (32, 64, 4, 1, 256, 36736)),
    # a 64x64 UNet's backward: 1 MB a slab over 8 CTAs
    ((64, 4096, 128), torch.bfloat16, True, (64, 64, 64, 8, 128, 138368)),
    # one ragged box of 104 rows of 64 bytes
    ((2, 100, 32), torch.bfloat16, False, (32, 104, 1, 1, 2, 10624)),
])
def test_plan_at_the_paths_shapes(shape, dtype, backward, want):
    # (width, chunk_rows, chunks, cluster, slabs, smem_bytes)
    assert tuple(gn.plan(*shape, 32, dtype, backward)) == want


@pytest.mark.parametrize("shape,groups,backward,match", [
    ((2, 64, 36), 4, False, "16 bytes"),  # 72-byte rows: no TMA row stride
    ((2, 64, 96), 32, False, "whole groups"),  # 3 channels a group
    ((1, 16384, 64), 32, False, "shared memory"),  # 2 MB a slab: 256 KB a CTA of 8
    ((1, 8192, 128), 32, True, "shared memory"),
])
def test_plan_refuses_what_the_kernels_cannot_take(shape, groups, backward, match):
    with pytest.raises(ValueError, match=match):
        gn.plan(*shape, groups, torch.bfloat16, backward)


def test_kernel_wrapper_refuses_cpu_tensors():
    x, gamma, beta = (torch.from_numpy(a).float() for a in _inputs((2, 8, 64), 11))
    with pytest.raises(ValueError, match="CUDA"):
        gn.groupnorm_silu_cuda(x, gamma, beta, 32)
    with pytest.raises(ValueError, match="CUDA"):
        gn.groupnorm_silu_bwd_cuda(x, gamma, beta, x, 32)
