"""K2's and K6f's plain versions, the packed attention dispatch, and the
DiT's token attention and MLP, against the JAX package on the CPU."""

import importlib

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from bsi_tpu.nn import MLP as JaxMLP
from bsi_tpu.nn import TokenAttention as JaxTokenAttention
from bsi_tpu.ops import attention as jax_attention

from bsi_torch.convert import params_from_jax
from bsi_torch.nn import MLP, TokenAttention
from bsi_torch.ops import attention, flash_attention_packed as fap

jax_fap = importlib.import_module("bsi_tpu.ops.flash_attention_packed")

SHAPES = [(4, 64), (2, 128)]  # (heads, head_dim): two heads per group, one


def _normal(shape, seed, dtype=np.float64):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


@pytest.mark.parametrize("heads,d", SHAPES)
def test_fused_twin_matches_pallas_kernel_in_interpret_mode(heads, d):
    # f32, rate 0: the same math on both sides, sums in another order: 1e-5
    qkv = _normal((2, 128, 3 * heads * d), heads)
    qkv32 = qkv.astype(np.float32)
    want = np.asarray(jax_fap.flash_attention_fused(
        jnp.asarray(qkv32), jnp.zeros(2 * heads, jnp.int32), heads=heads, rate=0.0, interpret=True))
    got = fap.flash_attention_fused(torch.from_numpy(qkv32), heads=heads)
    assert got.dtype == torch.float32 and got.shape == (2, 128, heads * d)
    npt.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("heads,d", SHAPES)
def test_packed_twin_matches_pallas_kernel_in_interpret_mode(heads, d):
    q, k, v = (_normal((2, 128, heads * d), 10 + i, np.float32) for i in range(3))
    want = np.asarray(jax_fap.flash_attention_packed(
        *map(jnp.asarray, (q, k, v)), jnp.zeros(2 * heads, jnp.int32), heads=heads, rate=0.0,
        interpret=True))
    got = fap.flash_attention_packed(*map(torch.from_numpy, (q, k, v)), heads=heads)
    npt.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("d", [64, 128])
def test_twin_with_keep_masks_matches_jax_packed_math(d):
    # One [S, 128] lane block of the TPU kernel: 128 // d heads, picked by
    # lane masks there and by columns here, with the same injected keep masks.
    # Both sides take f32 logits from f64 inputs, hence 1e-6.
    seq, keep_prob = 64, 0.8
    n_sub = 128 // d
    q, k, v = (_normal((seq, 128), 20 + i) for i in range(3))
    keeps = np.random.default_rng(23).uniform(size=(n_sub, seq, seq)) < keep_prob
    masks = jax_fap._subhead_masks(d, jnp.float32)
    want = np.asarray(jax_fap._packed_fwd_math(
        *map(jnp.asarray, (q, k, v)), masks, [jnp.asarray(m) for m in keeps], 1.0 / np.sqrt(d), keep_prob))
    heads = lambda x: torch.from_numpy(x).reshape(seq, n_sub, d).permute(1, 0, 2)
    got = fap._packed_fwd_math(heads(q), heads(k), heads(v), 1.0 / np.sqrt(d), torch.from_numpy(keeps), keep_prob)
    npt.assert_allclose(got.permute(1, 0, 2).reshape(seq, 128).numpy(), want, atol=1e-6, rtol=0)


def test_packed_applicable_matches_jax():
    for hd_total in (64, 128, 192, 256, 384, 512, 1024, 1000):
        for heads in (1, 2, 3, 4, 8, 16):
            for seq in (64, 128, 200, 256, 384, 512, 640):
                assert fap.packed_applicable(hd_total, heads, seq) == jax_fap.packed_applicable(
                    hd_total, heads, seq), (hd_total, heads, seq)
    assert fap.packed_applicable(1024, 16, 256)  # DiT-L/2


@pytest.mark.parametrize("heads,d", SHAPES + [(3, 64)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_cpu_dispatch_matches_jax_fallback(heads, d, dtype):
    # Both packages take the split and the plain attention on the CPU; JAX's
    # plain attention rounds the logits to f32 at either dtype: 1e-6.
    qkv = _normal((2, 32, 3 * heads * d), 30 + heads, dtype)
    want = np.asarray(jax_attention.multi_head_attention_fused_qkv(jnp.asarray(qkv), heads=heads))
    got = attention.multi_head_attention_fused_qkv(torch.from_numpy(qkv), heads=heads)
    npt.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    q, k, v = np.split(qkv, 3, axis=-1)
    want = np.asarray(jax_attention.multi_head_attention_packed(*map(jnp.asarray, (q, k, v)), heads=heads))
    got = attention.multi_head_attention_packed(*map(torch.from_numpy, (q, k, v)), heads=heads)
    npt.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_cpu_dispatch_differentiates_the_plain_path():
    qkv = torch.from_numpy(_normal((1, 16, 3 * 2 * 8), 40)).requires_grad_()
    g = torch.from_numpy(_normal((1, 16, 16), 41))
    (grad,) = torch.autograd.grad(attention.multi_head_attention_fused_qkv(qkv, heads=2), qkv, g)
    leaf = qkv.detach().clone().requires_grad_()
    q, k, v = fap.split_qkv_grouped(leaf, 2)
    want = fap._merge_heads(attention._xla_attention(q, k, v))
    (want_grad,) = torch.autograd.grad(want, leaf, g)
    assert torch.equal(grad, want_grad)


def test_cpu_dropout_keeps_and_rescales():
    # v = 1 makes every output entry the kept probability mass of its row
    # over keep_prob: 0 where everything was dropped, 1 on average.
    b, s, heads, d, rate = 4, 64, 2, 8, 0.25
    q, k = (torch.from_numpy(_normal((b, s, heads * d), 50 + i)) for i in range(2))
    v = torch.ones(b, s, heads * d, dtype=torch.float64)
    gen = torch.Generator().manual_seed(0)
    out = attention.multi_head_attention_packed(q, k, v, heads=heads, dropout_rate=rate, generator=gen)
    plain = attention.multi_head_attention_packed(q, k, v, heads=heads)
    npt.assert_allclose(plain.numpy(), 1.0, atol=1e-6)
    rows = out[..., ::d]  # one column per head
    assert abs(rows.mean().item() - 1.0) < 0.05
    again = attention.multi_head_attention_packed(q, k, v, heads=heads, dropout_rate=rate,
                                                  generator=torch.Generator().manual_seed(0))
    assert torch.equal(out, again)


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros(1, 128, 3 * 128)
    with pytest.raises(ValueError, match="CUDA"):
        fap.flash_attention_fused_cuda(x, 2)
    y = torch.zeros(1, 128, 128)
    with pytest.raises(ValueError, match="CUDA"):
        fap.flash_attention_packed_cuda(y, y, y, 2)


@pytest.mark.parametrize("heads", [2, 1])
def test_token_attention_matches_flax(heads):
    dim = 128
    ref = JaxTokenAttention(heads=heads)
    x = _normal((2, 16, dim), 60)
    params = ref.init(jax.random.key(heads), jnp.asarray(x))
    want = np.asarray(ref.apply(params, jnp.asarray(x)))
    ours = TokenAttention(dim, heads, device="cpu")
    ours.load_state_dict(params_from_jax(params))
    with torch.inference_mode():
        got = ours.double().eval()(torch.from_numpy(x))
    npt.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_mlp_matches_flax():
    ref = JaxMLP(out_features=8, hidden_features=[32, 16],
                 actfn=lambda v: flax_nn.gelu(v, approximate=True))
    x = _normal((3, 12), 70)
    params = ref.init(jax.random.key(0), jnp.asarray(x))
    want = np.asarray(ref.apply(params, jnp.asarray(x)))
    ours = MLP(12, 8, [32, 16], actfn=lambda v: torch.nn.functional.gelu(v, approximate="tanh"), device="cpu")
    ours.load_state_dict(params_from_jax(params))
    assert ours.widths() == [32, 16]
    with torch.inference_mode():
        got = ours.double()(torch.from_numpy(x))
    npt.assert_allclose(got.numpy(), want, atol=1e-12, rtol=0)
    with pytest.raises(ValueError, match="hidden_layers"):
        MLP(12, 8, 32, device="cpu")
