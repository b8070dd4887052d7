"""K5f and K5b's plain versions and the fused attention function that
dispatches between K1, K5f and K5b, against the JAX package on the CPU:
``_fwd_math`` and ``_bwd_math`` with injected keep masks, the Pallas
kernels in interpret mode, and ``jax.vjp`` of ``_fused_sdpa_fn``."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from bsi_tpu.ops.attention import _fused_sdpa_fn

from bsi_torch.ops import attention
from bsi_torch.ops import flash_attention as fa
from bsi_torch.ops.dropout_mask import _philox_keep_mask, draw_seeds

# bsi_tpu.ops re-exports the flash_attention function under the module's name
jax_fa = importlib.import_module("bsi_tpu.ops.flash_attention")


def _normal(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


def _interpret_kernels(monkeypatch):
    """Reroute the JAX dispatch's kernel calls through interpret mode, as
    tests/test_attention_grad.py does."""
    fwd, drop, bwd = jax_fa.flash_attention, jax_fa.flash_attention_dropout, jax_fa.flash_attention_bwd
    monkeypatch.setattr(jax_fa, "flash_attention", lambda q, k, v, **kw: fwd(q, k, v, interpret=True))
    monkeypatch.setattr(jax_fa, "flash_attention_dropout", lambda *a, **kw: drop(*a, interpret=True, **kw))
    monkeypatch.setattr(jax_fa, "flash_attention_bwd", lambda *a, **kw: bwd(*a, interpret=True, **kw))


@pytest.mark.parametrize("keep_prob", [0.9, 0.5])
def test_plain_math_matches_jax_with_an_injected_mask(keep_prob):
    # f32 on both sides; JAX's exact-f32 dots (Precision.HIGHEST) against
    # torch's f32 matmuls summed in another order: 1e-5
    seq, d = 128, 64
    q, k, v, do = (_normal((seq, d), s) for s in range(4))
    keep = np.random.default_rng(4).uniform(size=(seq, seq)) < keep_prob
    scale = 1.0 / np.sqrt(d)
    jq, jk, jv, jdo, jkeep = map(jnp.asarray, (q, k, v, do, keep))
    want = np.asarray(jax_fa._fwd_math(jq, jk, jv, jkeep, scale, keep_prob))
    tq, tk, tv, tdo, tkeep = map(torch.from_numpy, (q, k, v, do, keep))
    got = fa._fwd_math(tq, tk, tv, scale, tkeep, keep_prob)
    npt.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    wants = jax_fa._bwd_math(jq, jk, jv, jdo, jkeep, scale, keep_prob)
    for g, w in zip(fa._bwd_math(tq, tk, tv, tdo, scale, tkeep, keep_prob), wants):
        npt.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)


def test_bf16_plain_backward_rounds_where_jax_does():
    # dS cast to the input dtype before dQ and dK, Pd before dV: in bf16 the
    # port's plain backward gives JAX's numbers up to f32 sums in another
    # order, which a bf16 rounding can turn into one bf16 ulp (2^-8 relative)
    seq, d, keep_prob = 128, 64, 0.9
    q, k, v, do = (_normal((seq, d), s + 10) for s in range(4))
    keep = np.random.default_rng(14).uniform(size=(seq, seq)) < keep_prob
    scale = 1.0 / np.sqrt(d)
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do)]
    wants = jax_fa._bwd_math(*jb, jnp.asarray(keep), scale, keep_prob)
    tb = [torch.from_numpy(x).bfloat16() for x in (q, k, v, do)]
    for g, w in zip(fa._bwd_math(*tb, scale, torch.from_numpy(keep), keep_prob), wants):
        w = np.asarray(w, np.float32)
        npt.assert_allclose(g.numpy(), w, atol=1e-2 * np.abs(w).max(), rtol=0)


@pytest.mark.parametrize("shape", [(2, 2, 128, 64), (1, 1, 256, 128)])
def test_entries_match_pallas_kernels_in_interpret_mode(shape):
    q, k, v, do = (_normal(shape, s + 20) for s in range(4))
    seeds = jnp.zeros((shape[0] * shape[1],), jnp.int32)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    want = np.asarray(jax_fa.flash_attention_dropout(jq, jk, jv, seeds, rate=0.0, interpret=True))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    got = fa.flash_attention_dropout(tq, tk, tv, None, rate=0.0)
    assert got.dtype == torch.float32 and got.shape == shape
    npt.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    wants = jax_fa.flash_attention_bwd(jq, jk, jv, jdo, seeds, rate=0.0, interpret=True)
    for g, w in zip(fa.flash_attention_bwd(tq, tk, tv, tdo, None, rate=0.0), wants):
        npt.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", [(2, 2, 128, 64), (1, 2, 256, 128), (1, 1, 640, 64)])
def test_fused_attention_matches_jax_fused_sdpa_vjp(monkeypatch, shape):
    # S <= 512: K5f and K5b (their plain versions here, the Pallas kernels in
    # interpret mode there); S = 640: K1 forward, the VJP of the plain
    # attention backward, on both sides
    _interpret_kernels(monkeypatch)
    q, k, v, g = (_normal(shape, s + 30) for s in range(4))
    seeds = jnp.zeros(shape[:2], jnp.int32)
    out, vjp = jax.vjp(lambda a, b, c: _fused_sdpa_fn(0.0)(a, b, c, seeds), *map(jnp.asarray, (q, k, v)))
    wants = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = fa.fused_attention(*leaves)
    npt.assert_allclose(got.detach().numpy(), np.asarray(out), atol=1e-5, rtol=0)
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(g))
    for gr, w in zip(grads, wants):
        w = np.asarray(w)
        npt.assert_allclose(gr.numpy(), w, atol=1e-5 * max(1.0, np.abs(w).max()), rtol=0)


def test_fused_attention_with_dropout_drops_by_the_philox_mask():
    # the CPU path of rate > 0: the plain versions with the mask of the flat
    # [B*H] seeds, the bits K5f and K5b draw; the gradient is autograd's
    # through the plain forward with that mask
    b, h, s, d, rate = 2, 2, 128, 64, 0.1
    q, k, v, g = (torch.from_numpy(_normal((b, h, s, d), x + 40)) for x in range(4))
    seeds = draw_seeds(b, h, "cpu", torch.Generator().manual_seed(0)).reshape(-1)
    keep = _philox_keep_mask(seeds, s, 1 - rate).reshape(b, h, s, s)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fa.fused_attention(*leaves, seeds, rate)
    assert torch.equal(out, fa._fwd_math(q, k, v, fa._scale(q), keep, 1 - rate))
    assert not torch.equal(out, fa.fused_attention(q, k, v))
    grads = torch.autograd.grad(out, leaves, g)
    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    wants = torch.autograd.grad(fa._fwd_math(*plain, fa._scale(q), keep, 1 - rate), plain, g)
    for gr, w in zip(grads, wants):
        npt.assert_allclose(gr.numpy(), w.numpy(), atol=1e-5 * w.abs().max().item(), rtol=0)
    with pytest.raises(ValueError, match="seeds"):
        fa.fused_attention(q, k, v, None, rate)


def test_dispatch_keeps_cpu_tensors_on_the_plain_path(monkeypatch):
    # the kernels' route is for CUDA tensors; a CPU tensor with dropout at
    # S <= 512 takes JAX's fallback, torch.rand masks from the generator
    calls = []
    monkeypatch.setattr(attention, "fused_attention", lambda *a: calls.append(a))
    q = torch.from_numpy(_normal((1, 1, 256, 128), 50))
    out = attention.multi_head_attention(q, q, q, dropout_rate=0.5, generator=torch.Generator().manual_seed(1))
    again = attention.multi_head_attention(q, q, q, dropout_rate=0.5, generator=torch.Generator().manual_seed(1))
    assert not calls and torch.equal(out, again)
    assert not torch.equal(out, attention.multi_head_attention(q, q, q))


def test_kernel_wrappers_refuse_cpu_tensors_and_bad_seeds():
    q = torch.zeros(1, 2, 128, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_dropout_cuda(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd_cuda(q, q, q, q)
    with pytest.raises(ValueError, match="seeds"):
        fa.kernel_dropout_args("k5f", torch.zeros(1, 2, dtype=torch.int32), 0.1, (2,), torch.device("cpu"))
    with pytest.raises(ValueError, match="rate"):
        fa.kernel_dropout_args("k5f", None, 1.0, (2,), torch.device("cpu"))
