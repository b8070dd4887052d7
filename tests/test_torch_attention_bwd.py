"""The contract between the bf16 attention forwards and backwards at head_dim
64 and 128 (K2/K3, K6f/K6b, K5f/K5b): the forward's row statistics and the
backward from the forward's output and statistics, in their plain versions,
against the JAX package on the CPU: the log-sum-exp of JAX's logits, the
Pallas backwards in interpret mode, ``_packed_bwd_math`` and ``_bwd_math``
with injected keep masks, and ``jax.vjp`` of ``_fused_sdpa_fn``."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from bsi_tpu.ops.attention import _fused_sdpa_fn

from bsi_torch.ops import flash_attention as fa, flash_attention_packed as fap
from bsi_torch.ops.dropout_mask import _philox_keep_mask, draw_seeds, keep_probe_bwd, keep_probe_bwd_counts

jax_fa = importlib.import_module("bsi_tpu.ops.flash_attention")
jax_fap = importlib.import_module("bsi_tpu.ops.flash_attention_packed")

SHAPES = [(4, 64), (2, 128)]  # (heads, head_dim): two heads per group, one


def _normal(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


def _jax_lse2(q, k, scale):
    # the natural log-sum-exp of JAX's f32 logits (q scaled, as its kernels
    # scale it), times log2(e): the base-2 statistics the port's kernels keep
    logits = jnp.einsum("...qd,...kd->...qk", jnp.asarray(q) * scale, jnp.asarray(k),
                        precision=jax.lax.Precision.HIGHEST)
    return np.asarray(jax.scipy.special.logsumexp(logits, axis=-1)) * np.log2(np.e)


@pytest.mark.parametrize("seq", [128, 200, 1])
@pytest.mark.parametrize("d", [64, 128])
def test_plain_lse_matches_the_logsumexp_of_jax_logits(seq, d):
    # f32 on both sides, sums in another order: 1e-5 against values of ~8
    q, k = (_normal((2, 3, seq, d), s) for s in (1, 2))
    scale = 1.0 / np.sqrt(d)
    got = fa._lse_math(torch.from_numpy(q), torch.from_numpy(k), scale)
    assert got.dtype == torch.float32 and got.shape == (2, 3, seq)
    npt.assert_allclose(got.numpy(), _jax_lse2(q, k, scale), atol=1e-5, rtol=0)


@pytest.mark.parametrize("heads,d", SHAPES)
def test_entries_return_the_statistics_of_each_head(heads, d):
    # K2's, K6f's and K5f's plain entries with with_lse, in bf16 (where the
    # card's route writes the statistics): the same output as without, and
    # each head's statistics in [B, H, S], against JAX's logits of the same
    # bf16 values. In f32 the route writes none, nor do the entries.
    b, seq = 2, 128
    qkv = torch.from_numpy(_normal((b, seq, 3 * heads * d), 3)).bfloat16()
    out, lse = fap.flash_attention_fused(qkv, heads=heads, with_lse=True)
    assert torch.equal(out, fap.flash_attention_fused(qkv, heads=heads))
    q4, k4, v4 = fap.split_qkv_grouped(qkv, heads)
    want = _jax_lse2(q4.float().numpy(), k4.float().numpy(), 1.0 / np.sqrt(d))
    npt.assert_allclose(lse.numpy(), want, atol=1e-5, rtol=0)
    q, k, v = (fap._merge_heads(t).contiguous() for t in (q4, k4, v4))
    out6, lse6 = fap.flash_attention_packed(q, k, v, heads=heads, with_lse=True)
    assert torch.equal(out6, fap.flash_attention_packed(q, k, v, heads=heads))
    assert torch.equal(lse6, lse)
    q4, k4, v4 = (t.contiguous() for t in (q4, k4, v4))
    out5, lse5 = fa.flash_attention_dropout(q4, k4, v4, None, rate=0.0, with_lse=True)
    assert torch.equal(out5, fa.flash_attention_dropout(q4, k4, v4, None, rate=0.0))
    assert torch.equal(lse5, lse)
    assert fap.flash_attention_fused(qkv.float(), heads=heads, with_lse=True)[1] is None
    assert fa.flash_attention_dropout(q4.float(), k4.float(), v4.float(), None, rate=0.0, with_lse=True)[1] is None


@pytest.mark.parametrize("heads,d", SHAPES)
def test_fused_bwd_from_statistics_matches_pallas_kernel_in_interpret_mode(heads, d):
    # K3's plain version from K2's output and statistics against the TPU
    # kernel run in interpret mode, f32, rate 0: the same gradients, sums in
    # another order and delta from the output: 1e-5
    qkv = _normal((2, 128, 3 * heads * d), 80 + heads)
    do = _normal((2, 128, heads * d), 81 + heads)
    want = np.asarray(jax_fap.flash_attention_fused_bwd(
        jnp.asarray(qkv), jnp.asarray(do), jnp.zeros(2 * heads, jnp.int32), heads=heads, rate=0.0,
        interpret=True))
    tqkv, tdo = torch.from_numpy(qkv), torch.from_numpy(do)
    out = fap.flash_attention_fused(tqkv, heads=heads)
    got = fap.flash_attention_fused_bwd(tqkv, tdo, heads=heads, out=out, lse=fap._fused_lse_math(tqkv, heads))
    assert got.dtype == torch.float32 and got.shape == qkv.shape
    npt.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("heads,d", SHAPES)
def test_packed_bwd_from_statistics_matches_pallas_kernel_in_interpret_mode(heads, d):
    q, k, v, do = (_normal((2, 128, heads * d), 90 + i) for i in range(4))
    want = jax_fap.flash_attention_packed_bwd(
        *map(jnp.asarray, (q, k, v, do)), jnp.zeros(2 * heads, jnp.int32), heads=heads, rate=0.0,
        interpret=True)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = fap.flash_attention_packed(tq, tk, tv, heads=heads), fap._packed_heads_lse_math(tq, tk, heads)
    got = fap.flash_attention_packed_bwd(tq, tk, tv, tdo, heads=heads, out=out, lse=lse)
    for ours, ref in zip(got, want):
        npt.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", [(2, 2, 128, 64), (1, 1, 256, 128)])
def test_bh_bwd_from_statistics_matches_pallas_kernel_in_interpret_mode(shape):
    # K5b's plain version from K5f's output and statistics
    q, k, v, do = (_normal(shape, s + 20) for s in range(4))
    seeds = jnp.zeros((shape[0] * shape[1],), jnp.int32)
    wants = jax_fa.flash_attention_bwd(*map(jnp.asarray, (q, k, v, do)), seeds, rate=0.0, interpret=True)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = fa.flash_attention_dropout(tq, tk, tv, None, rate=0.0), fa._lse_math(tq, tk, fa._scale(tq))
    for g, w in zip(fa.flash_attention_bwd(tq, tk, tv, tdo, None, rate=0.0, out=out, lse=lse), wants):
        npt.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)


@pytest.mark.parametrize("keep_prob", [0.9, 0.5])
def test_bwd_from_statistics_matches_jax_bwd_math_with_an_injected_mask(keep_prob):
    # f64 inputs; JAX's and the port's logits are f32, so are P, the
    # statistics and delta here: 1e-6 against gradients of order one
    seq, d = 128, 64
    q, k, v, do = (_normal((seq, d), s, np.float64) for s in range(4))
    keep = np.random.default_rng(4).uniform(size=(seq, seq)) < keep_prob
    scale = 1.0 / np.sqrt(d)
    wants = jax_fa._bwd_math(*map(jnp.asarray, (q, k, v, do, keep)), scale, keep_prob)
    tq, tk, tv, tdo, tkeep = map(torch.from_numpy, (q, k, v, do, keep))
    out = fa._fwd_math(tq, tk, tv, scale, tkeep, keep_prob)
    grads = fa._bwd_from_stats(tq, tk, tv, tdo, out, fa._lse_math(tq, tk, scale), scale, tkeep, keep_prob)
    for g, w in zip(grads, wants):
        npt.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)


@pytest.mark.parametrize("d", [64, 128])
def test_packed_bwd_from_statistics_matches_jax_packed_math_with_masks(d):
    # One [S, 128] lane block of the TPU kernel, its heads picked by lane
    # masks there and by columns here, the same injected keep masks; f64
    # inputs, f32 logits and statistics: 1e-6
    seq, keep_prob = 64, 0.8
    n_sub = 128 // d
    q, k, v, do = (_normal((seq, 128), 100 + i, np.float64) for i in range(4))
    keeps = np.random.default_rng(104).uniform(size=(n_sub, seq, seq)) < keep_prob
    masks = jax_fap._subhead_masks(d, jnp.float32)
    want = jax_fap._packed_bwd_math(*map(jnp.asarray, (q, k, v, do)), masks,
                                    [jnp.asarray(m) for m in keeps], 1.0 / np.sqrt(d), keep_prob)
    tq, tk, tv, tdo = (torch.from_numpy(x)[None] for x in (q, k, v, do))
    tkeeps = torch.from_numpy(keeps)[None]
    out = fap._packed_heads_math(tq, tk, tv, n_sub, tkeeps, keep_prob)
    lse = fap._packed_heads_lse_math(tq, tk, n_sub)
    got = fap._packed_heads_bwd_math(tq, tk, tv, tdo, n_sub, tkeeps, keep_prob, out, lse)
    for ours, ref in zip(got, want):
        npt.assert_allclose(ours[0].numpy(), np.asarray(ref), atol=1e-6, rtol=0)


@pytest.mark.parametrize("rate", [0.05, 0.1])
@pytest.mark.parametrize("heads,d", SHAPES)
def test_bf16_bwd_from_statistics_stays_within_the_kernels_tolerance(heads, d, rate):
    # bf16: delta from the output rounded to bf16 and P from the statistics
    # move dS by bf16 roundings: within the 2e-2 of the largest element the
    # card's checks hold the kernels to, for K3, K6b and K5b with the Philox
    # mask
    b, seq = 2, 200
    qkv = torch.from_numpy(_normal((b, seq, 3 * heads * d), 5)).bfloat16()
    do = torch.from_numpy(_normal((b, seq, heads * d), 6)).bfloat16()
    seeds = draw_seeds(b, heads, "cpu", torch.Generator().manual_seed(7))
    out, lse = fap.flash_attention_fused(qkv, heads=heads, seeds=seeds, rate=rate, with_lse=True)
    got = fap.flash_attention_fused_bwd(qkv, do, heads=heads, seeds=seeds, rate=rate, out=out, lse=lse)
    want = fap.flash_attention_fused_bwd(qkv, do, heads=heads, seeds=seeds, rate=rate)
    for g, w in zip(fap.split_qkv_grouped(got, heads), fap.split_qkv_grouped(want, heads)):
        assert (g.float() - w.float()).abs().max() <= 2e-2 * w.float().abs().max()
    q4, k4, v4 = (t.contiguous() for t in fap.split_qkv_grouped(qkv, heads))
    do4 = fap._split_heads(do, heads).contiguous()
    flat = seeds.reshape(-1)
    out5, lse5 = fa.flash_attention_dropout(q4, k4, v4, flat, rate=rate, with_lse=True)
    for g, w in zip(fa.flash_attention_bwd(q4, k4, v4, do4, flat, rate=rate, out=out5, lse=lse5),
                    fa.flash_attention_bwd(q4, k4, v4, do4, flat, rate=rate)):
        assert (g.float() - w.float()).abs().max() <= 2e-2 * w.float().abs().max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 2, 128, 64), (1, 2, 256, 128), (2, 1, 200, 64)])
def test_cpu_autograd_path_matches_jax_fused_sdpa_vjp(monkeypatch, shape, dtype):
    # fused_attention's CPU path takes the card's route: in bf16 K5f's
    # output and statistics saved for K5b's plain version, in f32 none. Its
    # gradients stay JAX's (the Pallas kernels in interpret mode there):
    # f32 within 1e-5, bf16 within 2e-2 of the largest element (P, dS and
    # the output rounded to bf16 at other points)
    fwd, drop, bwd = jax_fa.flash_attention, jax_fa.flash_attention_dropout, jax_fa.flash_attention_bwd
    monkeypatch.setattr(jax_fa, "flash_attention", lambda q, k, v, **kw: fwd(q, k, v, interpret=True))
    monkeypatch.setattr(jax_fa, "flash_attention_dropout", lambda *a, **kw: drop(*a, interpret=True, **kw))
    monkeypatch.setattr(jax_fa, "flash_attention_bwd", lambda *a, **kw: bwd(*a, interpret=True, **kw))
    seen = []
    plain = fa._bwd_from_stats
    monkeypatch.setattr(fa, "_bwd_from_stats", lambda *a, **kw: seen.append(1) or plain(*a, **kw))
    q, k, v, g = (_normal(shape, s + 60) for s in range(4))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    seeds = jnp.zeros(shape[:2], jnp.int32)
    out, vjp = jax.vjp(lambda a, b, c: _fused_sdpa_fn(0.0)(a, b, c, seeds),
                       *(jnp.asarray(x, jdt) for x in (q, k, v)))
    wants = vjp(jnp.asarray(g, jdt))
    leaves = [torch.from_numpy(x).to(tdt).requires_grad_() for x in (q, k, v)]
    got = fa.fused_attention(*leaves)
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(g).to(tdt))
    assert seen == ([1] if dtype == "bfloat16" else [])
    pairs = [(got.detach(), out), *zip(grads, wants)]
    for ours, w in pairs:
        w = np.asarray(w, np.float32)
        tol = 1e-5 * max(1.0, np.abs(w).max()) if dtype == "float32" else 2e-2 * np.abs(w).max()
        npt.assert_allclose(ours.float().numpy(), w, atol=tol, rtol=0)


@pytest.mark.parametrize("rate", [0.05, 0.1])
@pytest.mark.parametrize("seq,d", [(256, 64), (256, 128), (200, 64)])
def test_keep_probe_bwd_reads_the_mask_out_of_the_plain_backwards(seq, d, rate):
    # f32: the plain backwards, from the statistics and without them, give
    # keep_probe_bwd_counts' dq and dv for the Philox mask, and dk = 0
    b, heads = 2, 2
    q, k, v, do = keep_probe_bwd(b, heads, seq, d, torch.float32, "cpu")
    seeds = draw_seeds(b, heads, "cpu", torch.Generator().manual_seed(8))
    keeps = _philox_keep_mask(seeds, seq, 1.0 - rate)
    want_dq, want_dv = keep_probe_bwd_counts(keeps, d, 1.0 - rate, fa._scale(q))
    flat = seeds.reshape(-1)
    out, lse = fa.flash_attention_dropout(q, k, v, flat, rate=rate), fa._lse_math(q, k, fa._scale(q))
    for dq, dk, dv in (fa.flash_attention_bwd(q, k, v, do, flat, rate=rate, out=out, lse=lse),
                       fa.flash_attention_bwd(q, k, v, do, flat, rate=rate)):
        npt.assert_allclose(dq.numpy(), want_dq.numpy(), atol=1e-7, rtol=0)
        npt.assert_allclose(dv.numpy(), want_dv.numpy(), atol=1e-7, rtol=0)
        assert not dk.any()


def test_stats_buffer_and_argument_layout():
    # the kernels' layout: rows of a head `ld` apart (the C side's stride,
    # 256 for S = 200); another layout is copied into it, zero past S
    buf = fa.stats_buffer(2, 3, 200, 256, "cpu")
    assert buf.shape == (2, 3, 200) and buf.stride() == (3 * 256, 256, 1)
    assert fa.stats_arg("t", buf, 2, 3, 200, 256, torch.device("cpu")) is buf
    plain = torch.randn(2, 3, 200)
    moved = fa.stats_arg("t", plain, 2, 3, 200, 256, torch.device("cpu"))
    assert torch.equal(moved, plain) and moved.stride() == buf.stride()
    with pytest.raises(ValueError, match="lse"):
        fa.stats_arg("t", plain[:, :2], 2, 3, 200, 256, torch.device("cpu"))
    assert fa.writes_stats(torch.bfloat16, 64) and fa.writes_stats(torch.bfloat16, 128)
    assert not fa.writes_stats(torch.bfloat16, 256) and not fa.writes_stats(torch.float32, 64)
