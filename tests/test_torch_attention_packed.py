"""K2's, K6f's, K3's and K6b's plain versions, the Philox keep mask, the
packed attention dispatch, and the DiT's token attention and MLP, against
the JAX package on the CPU."""

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
from bsi_torch.ops import attention, flash_attention as fa, flash_attention_packed as fap
from bsi_torch.ops.dropout_mask import keep_probe, keep_probe_counts

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


@pytest.mark.parametrize("heads,d", SHAPES)
def test_fused_bwd_twin_matches_pallas_kernel_in_interpret_mode(heads, d):
    # K3's plain version against the TPU kernel run in interpret mode, f32,
    # rate 0: the same math, sums in another order: 1e-5
    qkv = _normal((2, 128, 3 * heads * d), 80 + heads, np.float32)
    do = _normal((2, 128, heads * d), 81 + heads, np.float32)
    want = np.asarray(jax_fap.flash_attention_fused_bwd(
        jnp.asarray(qkv), jnp.asarray(do), jnp.zeros(2 * heads, jnp.int32), heads=heads, rate=0.0,
        interpret=True))
    got = fap.flash_attention_fused_bwd(torch.from_numpy(qkv), torch.from_numpy(do), heads=heads)
    assert got.dtype == torch.float32 and got.shape == qkv.shape
    npt.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("heads,d", SHAPES)
def test_packed_bwd_twin_matches_pallas_kernel_in_interpret_mode(heads, d):
    q, k, v, do = (_normal((2, 128, heads * d), 90 + i, np.float32) for i in range(4))
    want = jax_fap.flash_attention_packed_bwd(
        *map(jnp.asarray, (q, k, v, do)), jnp.zeros(2 * heads, jnp.int32), heads=heads, rate=0.0,
        interpret=True)
    got = fap.flash_attention_packed_bwd(*map(torch.from_numpy, (q, k, v, do)), heads=heads)
    for ours, ref in zip(got, want):
        npt.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("d", [64, 128])
def test_bwd_twin_with_keep_masks_matches_jax_packed_math(d):
    # The TPU kernel's backward math on one [S, 128] lane block with injected
    # keep masks (interpret mode takes rate 0 only). f64 inputs, f32 logits
    # on both sides: 1e-6 against gradients of order one.
    seq, keep_prob = 64, 0.8
    n_sub = 128 // d
    q, k, v, do = (_normal((seq, 128), 100 + i) for i in range(4))
    keeps = np.random.default_rng(104).uniform(size=(n_sub, seq, seq)) < keep_prob
    masks = jax_fap._subhead_masks(d, jnp.float32)
    want = jax_fap._packed_bwd_math(*map(jnp.asarray, (q, k, v, do)), masks,
                                    [jnp.asarray(m) for m in keeps], 1.0 / np.sqrt(d), keep_prob)
    heads = lambda x: torch.from_numpy(x).reshape(seq, n_sub, d).permute(1, 0, 2)
    got = fap._packed_bwd_math(heads(q), heads(k), heads(v), heads(do), 1.0 / np.sqrt(d),
                               torch.from_numpy(keeps), keep_prob)
    for ours, ref in zip(got, want):
        npt.assert_allclose(ours.permute(1, 0, 2).reshape(seq, 128).numpy(), np.asarray(ref), atol=1e-6, rtol=0)


# ---------------------------------------------------------- the keep mask


def test_philox_matches_random123_known_answers():
    # Philox4x32-10 known-answer vectors (Salmon et al., the Random123 suite)
    t = lambda *v: [torch.tensor(x, dtype=torch.int64) for x in v]
    cases = [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, want in cases:
        assert tuple(int(w) for w in fap._philox4x32_10(*t(*ctr), *t(*key))) == want


def test_keep_mask_takes_the_stated_philox_word_of_each_element():
    seeds = torch.tensor([[7, 2**31 - 2]], dtype=torch.int32)
    seq, keep_prob = 40, 0.6
    mask = fap._philox_keep_mask(seeds, seq, keep_prob)
    threshold = fap.keep_threshold(keep_prob)
    t = lambda x: torch.tensor(x, dtype=torch.int64)
    for h, seed in enumerate((7, 2**31 - 2)):
        for i, j in [(0, 0), (3, 5), (8, 1), (15, 38), (17, 39), (39, 22)]:
            words = fap._philox4x32_10(t(j >> 1), t(i & ~8), t(0), t(0), t(seed), t(0))
            bits = int(words[2 * ((i >> 3) & 1) + (j & 1)])
            assert bool(mask[0, h, i, j]) == (bits < threshold), (h, i, j)


def test_keep_mask_shape_seeds_and_rate():
    b, heads, seq, keep_prob = 2, 3, 128, 0.95
    seeds = fap.draw_seeds(b, heads, "cpu", torch.Generator().manual_seed(0))
    assert seeds.dtype == torch.int32 and seeds.shape == (b, heads)
    assert (seeds >= 0).all()
    mask = fap._philox_keep_mask(seeds, seq, keep_prob)
    assert mask.dtype == torch.bool and mask.shape == (b, heads, seq, seq)
    # the same seeds give the same mask, whatever the chunking
    assert torch.equal(mask, fap._philox_keep_mask(seeds.clone(), seq, keep_prob, chunk=1))
    # different (batch, head) seeds give different masks
    flat = mask.reshape(b * heads, -1)
    assert all(not torch.equal(flat[m], flat[n]) for m in range(b * heads) for n in range(m))
    # the kept fraction within 6 sigma of keep_prob over B*H*S^2 draws
    n = mask.numel()
    sigma = np.sqrt(keep_prob * (1 - keep_prob) / n)
    assert abs(mask.double().mean().item() - keep_prob) <= 6 * sigma
    assert fap.keep_threshold(1.0) == 2**32 - 1 and fap.keep_threshold(0.5) == 2**31


def test_cpu_entries_with_seeds_drop_by_the_philox_mask():
    b, s, heads, d, rate = 2, 32, 2, 8, 0.3
    qkv = torch.from_numpy(_normal((b, s, 3 * heads * d), 110))
    do = torch.from_numpy(_normal((b, s, heads * d), 111))
    seeds = fap.draw_seeds(b, heads, "cpu", torch.Generator().manual_seed(1))
    keeps = fap._philox_keep_mask(seeds, s, 1 - rate)
    got = fap.flash_attention_fused(qkv, heads=heads, seeds=seeds, rate=rate)
    assert torch.equal(got, fap._fused_fwd_math(qkv, heads, keeps, 1 - rate))
    assert not torch.equal(got, fap.flash_attention_fused(qkv, heads=heads))
    dqkv = fap.flash_attention_fused_bwd(qkv, do, heads=heads, seeds=seeds, rate=rate)
    # the fused gradient is autograd's through the plain forward with that mask
    leaf = qkv.clone().requires_grad_()
    (want,) = torch.autograd.grad(fap._fused_fwd_math(leaf, heads, keeps, 1 - rate), leaf, do)
    npt.assert_allclose(dqkv.numpy(), want.numpy(), atol=1e-6, rtol=0)
    # K6b's twin is K3's, split
    q, k, v = (fap._merge_heads(t) for t in fap.split_qkv_grouped(qkv, heads))
    grads = fap.flash_attention_packed_bwd(q, k, v, do, heads=heads, seeds=seeds, rate=rate)
    split = lambda t: fap._split_heads(t, heads)
    assert torch.equal(fap.merge_qkv_grouped(*map(split, grads)), dqkv)
    with pytest.raises(ValueError, match="seeds"):
        fap.flash_attention_fused(qkv, heads=heads, rate=rate)


@pytest.mark.parametrize("rate", [0.05, 0.1])
@pytest.mark.parametrize("twin,heads,seq,d", [("fused", 4, 256, 64), ("packed", 2, 200, 128),
                                              ("dropout", 2, 256, 128)])
def test_keep_probe_reads_the_mask_out_of_the_plain_twins(twin, heads, seq, d, rate):
    # q = 0 and one-hot v (keep_probe): each output element times S keep_prob
    # is the count of kept keys j = c mod D of its row, exactly, so one
    # flipped keep bit moves it by a whole 1 / (S keep_prob)
    b, keep_prob = 2, 1.0 - rate
    seeds = fap.draw_seeds(b, heads, "cpu", torch.Generator().manual_seed(2))
    q, k, v = keep_probe(b, heads, seq, d, torch.float32, "cpu", torch.Generator().manual_seed(3))
    if twin == "fused":
        out = fap._split_heads(fap.flash_attention_fused(fap.merge_qkv_grouped(q, k, v), heads=heads, seeds=seeds,
                                                         rate=rate), heads)
    elif twin == "packed":
        out = fap._split_heads(fap.flash_attention_packed(*map(fap._merge_heads, (q, k, v)), heads=heads,
                                                          seeds=seeds, rate=rate), heads)
    else:
        out = fa.flash_attention_dropout(q, k, v, seeds.reshape(-1), rate=rate)
    keeps = fap._philox_keep_mask(seeds, seq, keep_prob)
    counts = torch.matmul(keeps.double(), torch.nn.functional.one_hot(torch.arange(seq) % d, d).double())
    assert 0 < (~keeps).sum() and (counts > 0).any()
    scaled = out.double() * seq * keep_prob
    assert torch.equal(scaled.round(), counts)
    assert (scaled - counts).abs().max().item() <= 1e-5
    npt.assert_allclose(out.numpy(), keep_probe_counts(keeps, d, keep_prob).numpy(), atol=1e-6, rtol=0)


def test_merge_qkv_grouped_inverts_the_split():
    for heads, d in [(4, 64), (2, 128), (3, 64)]:
        qkv = torch.from_numpy(_normal((2, 8, 3 * heads * d), heads))
        assert torch.equal(fap.merge_qkv_grouped(*fap.split_qkv_grouped(qkv, heads)), qkv)


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
    with pytest.raises(ValueError, match="CUDA"):
        fap.flash_attention_fused_bwd_cuda(x, y, 2)
    with pytest.raises(ValueError, match="CUDA"):
        fap.flash_attention_packed_bwd_cuda(y, y, y, y, 2)


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
