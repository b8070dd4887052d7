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


# K4b's plan (csrc/ln_modulate.cu): the shapes the card tests run, DiT-L/2's
# first; then wide rows (the plain body) and one tile's worth of rows.
_PLAN_SHAPES = [(64, 256, 1024), (3, 16, 384), (2, 5, 100), (2, 300, 256), (2, 256, 1024), (1, 1, 8),
                (7, 1000, 512), (4, 33, 1152), (1, 4, 8192)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", _PLAN_SHAPES)
def test_bwd_plan_covers_every_row_once(shape, dtype):
    b, seq, d = shape
    p = lm.plan(b, seq, d, dtype)
    # one cluster an image; rank r of it takes tiles [r T / n, (r + 1) T / n)
    assert p.tiles == -(-seq // p.rows)
    covered = []
    for rank in range(p.cluster):
        first, end = rank * p.tiles // p.cluster, (rank + 1) * p.tiles // p.cluster
        assert end > first  # every CTA has a tile
        covered += [r for r in range(first * p.rows, end * p.rows) if r < seq]
    assert covered == list(range(seq))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", _PLAN_SHAPES)
def test_bwd_plan_fits_the_card(shape, dtype):
    b, seq, d = shape
    p = lm.plan(b, seq, d, dtype)
    assert p.cluster in (1, 2, 4, 8) and p.cluster <= p.tiles
    assert p.smem_bytes <= lm.SMEM_LIMIT == 232448
    # the TMA body takes rows of a multiple of 16 bytes and at most 1,024
    # columns (a lane's 32 columns of partials and scale in registers), in
    # tiles of one row a consumer warp; the plain body anything else
    assert p.tma == (d * dtype.itemsize % 16 == 0 and d <= 1024)
    if p.tma:
        assert p.rows == 7 and 1 <= p.stages <= 8
        assert p.lane_vectors in (1, 2, 4, 8) and 32 * 16 * p.lane_vectors >= d * dtype.itemsize
    else:
        assert p.rows == 32 and p.stages == 0 and p.lane_vectors == 0
    # the cluster grows while the doubled grid holds at most a CTA an SM
    if 2 * p.cluster <= min(8, p.tiles):
        assert 2 * b * p.cluster > 132
    if p.cluster > 1:
        assert b * p.cluster <= 132


@pytest.mark.parametrize("dtype,want", [
    # DiT-L/2: 37 tiles of 7 rows an image over two CTAs, one an SM (128 of
    # 132); 3 stages of 28 KB of x and g
    (torch.bfloat16, (True, 4, 7, 37, 3, 2, 86192)),
    # f32 rows of 4 KB: two stages of 56 KB
    (torch.float32, (True, 8, 7, 37, 2, 2, 114848)),
])
def test_bwd_plan_at_dit_l2(dtype, want):
    # (tma, lane_vectors, rows, tiles, stages, cluster, smem_bytes)
    assert tuple(lm.plan(64, 256, 1024, dtype)) == want


@pytest.mark.parametrize("shape,dtype,tma", [
    ((64, 256, 1024), torch.bfloat16, True),
    ((3, 16, 384), torch.bfloat16, True),
    ((2, 5, 100), torch.bfloat16, False),  # 200-byte rows: no TMA stride
    ((2, 5, 100), torch.float32, True),  # 400 bytes: 25 vectors
    ((2, 300, 256), torch.float32, True),
    ((4, 33, 1152), torch.bfloat16, False),  # 36 columns a lane
])
def test_bwd_plan_route(shape, dtype, tma):
    assert lm.plan(*shape, dtype).tma is tma


def test_bwd_plan_raises_only_past_what_the_kernel_holds():
    # the plain body keeps 8 bytes a column and 8 a tile row
    assert lm.plan(1, 64, 29000, torch.float32).smem_bytes == 29000 * 8 + 32 * 8 + 128
    with pytest.raises(ValueError, match="shared memory"):
        lm.plan(1, 64, 30000, torch.float32)
    with pytest.raises(ValueError, match="bad shape"):
        lm.plan(2, 0, 1024, torch.bfloat16)


def test_bwd_smem_mirrors_the_layout():
    # TMA body: the ring, or the 7 warps' column partials where larger, plus
    # two mbarriers a stage and 128 bytes of alignment
    assert lm._smem_bytes(True, 2, 1024, 3) == 3 * 2 * 4 * 7 * 512 + 48 + 128
    assert lm._smem_bytes(True, 2, 1024, 1) == 7 * 1024 * 8 + 16 + 128
    assert lm._smem_bytes(True, 4, 100, 1) == 2 * 7 * 512 + 16 + 128  # one box a row
    assert lm._smem_bytes(False, 2, 100, 0) == 100 * 8 + 32 * 8 + 128

