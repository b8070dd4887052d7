"""The port's kernels on the card, against their plain versions.

These tests need an NVIDIA GPU and import neither JAX nor ``bsi_tpu``, so
they run where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

Without a card they skip.
"""

import itertools

import pytest
import torch

from bsi_torch.ops import attention, flash_attention as fa, flash_attention_packed as fap
from bsi_torch.ops import groupnorm_silu as gn, ln_modulate as lm
from bsi_torch.ops.dropout_mask import keep_probe, keep_probe_bwd, keep_probe_bwd_counts, keep_probe_counts

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, *shape, dtype, device):
    return torch.randn(*shape, generator=gen, device=device).to(dtype)


@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-5)])
@pytest.mark.parametrize("shape", [(2, 1, 1024, 128), (3, 2, 200, 64), (1, 2, 384, 256), (2, 1, 1, 128),
                                   (2, 2, 63, 128), (1, 1, 1000, 128)])
def test_flash_attention_kernel_matches_twin(cuda, shape, dtype, atol):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (_randn(gen, *shape, dtype=dtype, device=cuda) for _ in range(3))
    got = fa.flash_attention_cuda(q, k, v)
    want = fa._fwd_math(q, k, v, fa._scale(q))
    assert got.dtype == dtype and got.shape == q.shape
    assert (got.float() - want).abs().max().item() <= atol


def test_cuda_tensor_routes_to_flash_attention(cuda):
    # as the JAX package routes it: S <= 512 to the whole-sequence K5f, longer
    # sequences to K1
    gen = torch.Generator(device=cuda).manual_seed(1)
    qkv = _randn(gen, 2, 256, 3 * 128, dtype=torch.bfloat16, device=cuda)
    q, k, v = attention.split_qkv_grouped(qkv, 1)
    k1, k5f = fa.flash_attention_cuda.launches, fa.flash_attention_dropout_cuda.launches
    out = attention.multi_head_attention(q, k, v)
    assert fa.flash_attention_dropout_cuda.launches == k5f + 1
    assert fa.flash_attention_cuda.launches == k1
    want = fa._fwd_math(q, k, v, fa._scale(q))
    assert (out.float() - want).abs().max().item() <= 2e-2
    long = _randn(gen, 2, 1, 1024, 128, dtype=torch.bfloat16, device=cuda)
    out = attention.multi_head_attention(long, long, long)
    assert fa.flash_attention_cuda.launches == k1 + 1
    assert fa.flash_attention_dropout_cuda.launches == k5f + 1
    assert (out.float() - fa._fwd_math(long, long, long, fa._scale(long))).abs().max().item() <= 2e-2
    # a shape the JAX package sends to plain math goes there here too
    short = _randn(gen, 2, 1, 64, 128, dtype=torch.bfloat16, device=cuda)
    attention.multi_head_attention(short, short, short)
    assert fa.flash_attention_cuda.launches == k1 + 1
    assert fa.flash_attention_dropout_cuda.launches == k5f + 1


def test_flash_attention_kernel_rejects_unsupported(cuda):
    x = torch.zeros(1, 1, 128, 32, device=cuda)
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(x, x, x)
    y = torch.zeros(1, 1, 128, 64, device=cuda).transpose(2, 3)
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(y, y, y)


@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-5)])
@pytest.mark.parametrize("shape", [(2, 1024, 128), (2, 1024, 256), (3, 100, 64)])
def test_groupnorm_silu_kernel_matches_twin(cuda, shape, dtype, atol):
    gen = torch.Generator(device=cuda).manual_seed(2)
    c = shape[-1]
    x = _randn(gen, *shape, dtype=dtype, device=cuda) * 2.0 + 0.5
    gamma = (1.0 + 0.1 * torch.randn(c, generator=gen, device=cuda)).to(dtype)
    beta = (0.1 * torch.randn(c, generator=gen, device=cuda)).to(dtype)
    before = gn.groupnorm_silu_cuda.launches
    got = gn.groupnorm_silu(x, gamma, beta, 32)
    assert gn.groupnorm_silu_cuda.launches == before + 1
    want = gn._reference_math(x, gamma, beta, 32).float()
    assert got.dtype == dtype
    # bf16: f32 statistics summed in another order can move a rounding by one
    # bf16 ulp (2^-7 relative at most)
    rtol = 2**-7 if dtype == torch.bfloat16 else 0.0
    assert ((got.float() - want).abs() <= atol + rtol * want.abs()).all()


def _gn_bwd_inputs(gen, shape, dtype, device):
    c = shape[-1]
    x = _randn(gen, *shape, dtype=dtype, device=device) * 2.0 + 0.5
    gamma = (1.0 + 0.1 * torch.randn(c, generator=gen, device=device)).to(dtype)
    beta = (0.1 * torch.randn(c, generator=gen, device=device)).to(dtype)
    g = _randn(gen, *shape, dtype=dtype, device=device)
    return x, gamma, beta, g


def assert_bwd_close(got, want, dtype):
    """dx within 1e-5 (f32) or 2e-2 plus one bf16 ulp (bf16); dgamma and
    dbeta, sums over every row of every image, within 1e-4 of their largest
    element (f32 sums in another order), plus one ulp in bf16."""
    ulp = 2**-7 if dtype == torch.bfloat16 else 0.0
    dx_atol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        a, b = a.float(), b.float()
        atol = dx_atol if i == 0 else 1e-4 * b.abs().max().item()
        assert ((a - b).abs() <= atol + ulp * b.abs()).all(), i


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(128, 1024, 128), (128, 1024, 256), (3, 100, 64)])
def test_groupnorm_silu_bwd_kernel_matches_plain(cuda, shape, dtype):
    gen = torch.Generator(device=cuda).manual_seed(3)
    x, gamma, beta, g = _gn_bwd_inputs(gen, shape, dtype, cuda)
    before = gn.groupnorm_silu_bwd_cuda.launches
    got = gn.groupnorm_silu_bwd_cuda(x, gamma, beta, g, 32)
    assert gn.groupnorm_silu_bwd_cuda.launches == before + 1
    assert_bwd_close(got, gn._bwd_math(x, gamma, beta, g, 32), dtype)


def test_groupnorm_silu_bwd_kernel_takes_strided_gradients(cuda):
    # the gradient of an NCHW tensor that is not channels_last reaches the
    # backward as [B, rows, C] with rows of stride 1
    gen = torch.Generator(device=cuda).manual_seed(4)
    x, gamma, beta, g = _gn_bwd_inputs(gen, (2, 256, 64), torch.float32, cuda)
    g_strided = g.permute(0, 2, 1).contiguous().permute(0, 2, 1)
    assert not g_strided.is_contiguous()
    copies = gn.groupnorm_silu_bwd_cuda.g_copies
    assert_bwd_close(gn.groupnorm_silu_bwd_cuda(x, gamma, beta, g_strided, 32),
                     gn._bwd_math(x, gamma, beta, g, 32), torch.float32)
    assert gn.groupnorm_silu_bwd_cuda.g_copies == copies + 1


def test_cuda_groupnorm_silu_backward_launches_k7b_only(cuda, monkeypatch):
    def plain_vjp(*args):
        raise AssertionError("the plain VJP ran on a CUDA tensor")

    monkeypatch.setattr(gn, "_bwd_math", plain_vjp)
    gen = torch.Generator(device=cuda).manual_seed(5)
    x, gamma, beta, g = _gn_bwd_inputs(gen, (2, 1024, 128), torch.bfloat16, cuda)
    leaves = [t.requires_grad_() for t in (x, gamma, beta)]
    fwd, bwd = gn.groupnorm_silu_cuda.launches, gn.groupnorm_silu_bwd_cuda.launches
    torch.autograd.grad(gn.groupnorm_silu(*leaves, 32), leaves, g)
    assert gn.groupnorm_silu_cuda.launches == fwd + 1
    assert gn.groupnorm_silu_bwd_cuda.launches == bwd + 1


# K7f and K7b at every kind of plan: rows ragged (100, 1,000) and whole (256,
# 4,096), C 32 to 256 (1 to 8 channels a group), bf16 and f32, at batch 2,
# where the plan grows clusters to fill the card: clusters of 1, 2, 4 and 8
# CTAs.
GN_PLANS = [(2, rows, c) for rows in (100, 256, 1000, 4096) for c in (32, 64, 128, 256)]


@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-5)])
@pytest.mark.parametrize("shape", GN_PLANS)
def test_groupnorm_silu_kernel_matches_twin_over_plans(cuda, shape, dtype, atol):
    gen = torch.Generator(device=cuda).manual_seed(6)
    x, gamma, beta, _ = _gn_bwd_inputs(gen, shape, dtype, cuda)
    got = gn.groupnorm_silu_cuda(x, gamma, beta, 32)
    want = gn._reference_math(x, gamma, beta, 32).float()
    rtol = 2**-7 if dtype == torch.bfloat16 else 0.0
    assert ((got.float() - want).abs() <= atol + rtol * want.abs()).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", GN_PLANS)
def test_groupnorm_silu_bwd_kernel_matches_plain_over_plans(cuda, shape, dtype):
    gen = torch.Generator(device=cuda).manual_seed(7)
    x, gamma, beta, g = _gn_bwd_inputs(gen, shape, dtype, cuda)
    assert_bwd_close(gn.groupnorm_silu_bwd_cuda(x, gamma, beta, g, 32), gn._bwd_math(x, gamma, beta, g, 32), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(64, 1024, 128), (128, 1024, 256), (2, 1000, 128), (2, 4096, 64), (3, 100, 32)])
def test_groupnorm_silu_kernels_repeat_bit_for_bit(cuda, shape, dtype):
    # the cluster's ranks sum their partials in rank order, without atomics
    gen = torch.Generator(device=cuda).manual_seed(8)
    x, gamma, beta, g = _gn_bwd_inputs(gen, shape, dtype, cuda)
    assert torch.equal(gn.groupnorm_silu_cuda(x, gamma, beta, 32), gn.groupnorm_silu_cuda(x, gamma, beta, 32))
    first = gn.groupnorm_silu_bwd_cuda(x, gamma, beta, g, 32)
    assert all(map(torch.equal, first, gn.groupnorm_silu_bwd_cuda(x, gamma, beta, g, 32)))


def test_groupnorm_silu_kernels_refuse_slabs_beyond_a_cluster(cuda):
    # 8 CTAs hold 16,384 rows of a forward slab (2 MB) or 8,192 of a backward
    # one (x and g, 2 MB) in no way: 256 KB a CTA
    x = torch.zeros(1, 16384, 64, dtype=torch.bfloat16, device=cuda)
    ones, zeros = torch.ones(64, dtype=torch.bfloat16, device=cuda), torch.zeros(64, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        gn.groupnorm_silu_cuda(x, ones, zeros, 32)
    with pytest.raises(ValueError, match="shared memory"):
        gn.groupnorm_silu_bwd_cuda(x[:, :8192], ones, zeros, x[:, :8192], 32)
    # one under the limits runs
    assert torch.isfinite(gn.groupnorm_silu_cuda(x[:, :8192], ones, zeros, 32)).all()


# ------------------------------------------------ K2, K6f: packed attention


def _packed_atol(dtype):
    # bf16: the probabilities are rounded to bf16 at other points (online
    # softmax against the plain version's normalised ones) and the output is
    # rounded to bf16; f32: exact f32 products summed in another order
    return 2e-2 if dtype == torch.bfloat16 else 1e-5


# K2 and K6f at ragged lengths (one row, under one tile, past a tile) at
# head_dim 64 (head pairs) and 128 (one head a group): the tensor maps
# zero-fill rows past S, keys past S are masked in the last tile only.
RAGGED = [(2, 1, 4, 64), (2, 63, 4, 64), (1, 1000, 2, 64), (2, 1, 2, 128), (2, 63, 2, 128), (3, 200, 2, 128),
          (1, 1000, 1, 128)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,heads,d", [(2, 256, 16, 64), (2, 128, 2, 128), (1, 128, 2, 256),
                                         (3, 200, 4, 64), (2, 96, 3, 64), *RAGGED])
def test_fused_qkv_kernel_matches_plain(cuda, b, s, heads, d, dtype):
    gen = torch.Generator(device=cuda).manual_seed(10)
    qkv = _randn(gen, b, s, 3 * heads * d, dtype=dtype, device=cuda)
    before = fap.flash_attention_fused_cuda.launches
    got = fap.flash_attention_fused(qkv, heads=heads)
    assert fap.flash_attention_fused_cuda.launches == before + 1
    want = fap._fused_fwd_math(qkv, heads)
    assert got.dtype == dtype and got.shape == (b, s, heads * d)
    assert (got.float() - want.float()).abs().max().item() <= _packed_atol(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,heads,d", [(2, 256, 16, 64), (2, 128, 2, 128), (3, 200, 4, 64), *RAGGED])
def test_packed_kernel_matches_plain(cuda, b, s, heads, d, dtype):
    gen = torch.Generator(device=cuda).manual_seed(11)
    q, k, v = (_randn(gen, b, s, heads * d, dtype=dtype, device=cuda) for _ in range(3))
    before = fap.flash_attention_packed_cuda.launches
    got = fap.flash_attention_packed(q, k, v, heads=heads)
    assert fap.flash_attention_packed_cuda.launches == before + 1
    want = fap._packed_heads_math(q, k, v, heads)
    assert (got.float() - want.float()).abs().max().item() <= _packed_atol(dtype)


def test_packed_kernels_refuse_unsupported(cuda):
    with pytest.raises(ValueError):
        fap.flash_attention_fused_cuda(torch.zeros(1, 128, 3 * 2 * 32, device=cuda), 2)
    with pytest.raises(ValueError):
        fap.flash_attention_fused_cuda(torch.zeros(1, 3 * 128, 128, device=cuda).transpose(1, 2), 1)
    x = torch.zeros(1, 128, 128, device=cuda)
    with pytest.raises(ValueError):
        fap.flash_attention_packed_cuda(x, x, x.double(), 2)


def test_packed_dispatch_routes_forward_and_backward_to_kernels(cuda):
    gen = torch.Generator(device=cuda).manual_seed(12)
    qkv = _randn(gen, 2, 256, 3 * 4 * 64, dtype=torch.bfloat16, device=cuda).requires_grad_()
    k2, k3 = fap.flash_attention_fused_cuda.launches, fap.flash_attention_fused_bwd_cuda.launches
    out = attention.multi_head_attention_fused_qkv(qkv, heads=4, dropout_rate=0.1, generator=gen)
    out.sum().backward()
    assert fap.flash_attention_fused_cuda.launches == k2 + 1
    assert fap.flash_attention_fused_bwd_cuda.launches == k3 + 1
    assert qkv.grad.shape == qkv.shape and torch.isfinite(qkv.grad.float()).all()
    q = _randn(gen, 2, 256, 256, dtype=torch.bfloat16, device=cuda).requires_grad_()
    k6f, k6b = fap.flash_attention_packed_cuda.launches, fap.flash_attention_packed_bwd_cuda.launches
    attention.multi_head_attention_packed(q, q, q, heads=4).sum().backward()
    assert fap.flash_attention_packed_cuda.launches == k6f + 1
    assert fap.flash_attention_packed_bwd_cuda.launches == k6b + 1
    # a shape the packed kernels do not take goes to the split path (K1 here)
    before_k1 = fa.flash_attention_cuda.launches
    attention.multi_head_attention_fused_qkv(_randn(gen, 2, 640, 3 * 128, dtype=torch.bfloat16, device=cuda),
                                             heads=1)
    assert fa.flash_attention_cuda.launches == before_k1 + 1


# ------------------------------------- dropout masks, K2 with dropout, K3, K6b

RATE = 0.05


def _seeds(gen, b, heads, device):
    return fap.draw_seeds(b, heads, device, gen)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,heads,d", [(2, 256, 16, 64), (2, 128, 2, 128), (1, 128, 2, 256), (3, 200, 4, 64),
                                         *RAGGED])
def test_fused_qkv_kernel_with_dropout_matches_plain(cuda, b, s, heads, d, dtype):
    # f32 at 1e-5 shows that the masks agree: one differing keep bit moves an
    # output by about p * v / keep_prob, far above it
    gen = torch.Generator(device=cuda).manual_seed(21)
    qkv = _randn(gen, b, s, 3 * heads * d, dtype=dtype, device=cuda)
    seeds = _seeds(gen, b, heads, cuda)
    got = fap.flash_attention_fused_cuda(qkv, heads, seeds, RATE)
    keeps = fap._philox_keep_mask(seeds, s, 1.0 - RATE)
    want = fap._fused_fwd_math(qkv, heads, keeps, 1.0 - RATE)
    assert (got.float() - want.float()).abs().max().item() <= _packed_atol(dtype)
    q, k, v = (t.contiguous() for t in qkv.chunk(3, dim=-1))
    got = fap.flash_attention_packed_cuda(q, k, v, heads, seeds, RATE)
    want = fap._packed_heads_math(q, k, v, heads, keeps, 1.0 - RATE)
    assert (got.float() - want.float()).abs().max().item() <= _packed_atol(dtype)


@pytest.mark.parametrize("rate", [RATE, 0.1])
@pytest.mark.parametrize("kernel,b,heads,s,d", [("k2", 2, 4, 256, 64), ("k6f", 2, 4, 256, 64), ("k5f", 2, 2, 256, 64),
                                                ("k2", 2, 2, 200, 128), ("k6f", 1, 2, 384, 128), ("k5f", 2, 1, 256, 128)])
def test_bf16_keep_masks_are_the_philox_twins_bit_for_bit(cuda, kernel, b, heads, s, d, rate):
    # keep_probe's inputs read the mask out: each element is the count of
    # kept keys j = c mod D over S keep_prob, so one flipped keep bit moves
    # it by 1 / (S keep_prob) >= 2.6e-3 here, bf16 rounding by < 1e-4: 1e-3
    gen = torch.Generator(device=cuda).manual_seed(23)
    q, k, v = keep_probe(b, heads, s, d, torch.bfloat16, cuda, gen)
    seeds = _seeds(gen, b, heads, cuda)
    keeps = fap._philox_keep_mask(seeds, s, 1.0 - rate)
    if kernel == "k2":
        got = fap._split_heads(fap.flash_attention_fused_cuda(fap.merge_qkv_grouped(q, k, v), heads, seeds, rate),
                               heads)
    elif kernel == "k6f":
        got = fap._split_heads(fap.flash_attention_packed_cuda(
            *(fap._merge_heads(t).contiguous() for t in (q, k, v)), heads, seeds, rate), heads)
    else:
        got = fa.flash_attention_dropout_cuda(q, k, v, seeds.reshape(-1), rate)
    want = fa._fwd_math(q, k, v, fa._scale(q), keeps, 1.0 - rate)
    counts = keep_probe_counts(keeps, d, 1.0 - rate)
    assert (want - counts).abs().max().item() <= 1e-3
    assert (got.float() - want).abs().max().item() <= 1e-3
    assert (got.float() - counts).abs().max().item() <= 1e-3


def _bwd_close(got, want, dtype, floor=0.0):
    """bf16: within 2e-2 of the largest element (P and dS rounded to bf16 at
    other points than the plain version's, and the outputs to bf16); f32:
    within 1e-5 of it (exact f32 products summed in another order); plus
    `floor`."""
    tol = (2e-2 if dtype == torch.bfloat16 else 1e-5) * want.float().abs().max().item() + floor
    err = (got.float() - want.float()).abs().max().item()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert err <= tol, (err, tol)


def _interleave(dq, dk, dv, heads):
    split = lambda t: fap._split_heads(t, heads)
    return fap.merge_qkv_grouped(split(dq), split(dk), split(dv))


@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,heads,d", [(2, 256, 16, 64), (2, 128, 2, 128), (3, 200, 4, 64), (1, 96, 1, 128),
                                         (2, 256, 2, 256), (1, 160, 1, 256)])
def test_fused_qkv_bwd_kernel_matches_plain(cuda, b, s, heads, d, dtype, rate):
    gen = torch.Generator(device=cuda).manual_seed(22)
    qkv = _randn(gen, b, s, 3 * heads * d, dtype=dtype, device=cuda)
    do = _randn(gen, b, s, heads * d, dtype=dtype, device=cuda)
    seeds = _seeds(gen, b, heads, cuda) if rate else None
    keeps = fap._philox_keep_mask(seeds, s, 1.0 - rate) if rate else None
    before = fap.flash_attention_fused_bwd_cuda.launches
    got = fap.flash_attention_fused_bwd(qkv, do, heads=heads, seeds=seeds, rate=rate)
    assert fap.flash_attention_fused_bwd_cuda.launches == before + 1
    _bwd_close(got, fap._fused_bwd_math(qkv, do, heads, keeps, 1.0 - rate), dtype)
    # K6b on the same q, k, v: the same numbers, K3's dqkv its interleave bit for bit
    q, k, v = (t.contiguous() for t in fap.split_qkv_grouped(qkv, heads))
    q, k, v = (fap._merge_heads(t).contiguous() for t in (q, k, v))
    grads = fap.flash_attention_packed_bwd(q, k, v, do, heads=heads, seeds=seeds, rate=rate)
    for g, w in zip(grads, fap._packed_heads_bwd_math(q, k, v, do, heads, keeps, 1.0 - rate)):
        _bwd_close(g, w, dtype)
    assert torch.equal(got, _interleave(*grads, heads))


def test_bwd_kernels_refuse_unsupported(cuda):
    qkv = torch.zeros(1, 128, 3 * 2 * 32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fap.flash_attention_fused_bwd_cuda(qkv, torch.zeros(1, 128, 64, device=cuda), 2)
    qkv = torch.zeros(1, 128, 3 * 2 * 64, device=cuda)
    with pytest.raises(ValueError, match="dO"):
        fap.flash_attention_fused_bwd_cuda(qkv, torch.zeros(1, 128, 64, device=cuda), 2)
    with pytest.raises(ValueError, match="seeds"):
        fap.flash_attention_fused_bwd_cuda(qkv, torch.zeros(1, 128, 128, device=cuda), 2, None, 0.1)


def test_packed_attention_gradient_matches_plain_autograd(cuda):
    # the autograd path end to end, dropout on: K2 + K3 against autograd
    # through the plain forward with the same seeds' mask, f32
    gen = torch.Generator(device=cuda).manual_seed(23)
    b, s, heads, d = 2, 256, 4, 64
    qkv = _randn(gen, b, s, 3 * heads * d, dtype=torch.float32, device=cuda).requires_grad_()
    g = _randn(gen, b, s, heads * d, dtype=torch.float32, device=cuda)
    state = torch.cuda.get_rng_state(cuda)
    out = attention.multi_head_attention_fused_qkv(qkv, heads=heads, dropout_rate=RATE)
    (grad,) = torch.autograd.grad(out, qkv, g)
    torch.cuda.set_rng_state(state, cuda)
    seeds = fap.draw_seeds(b, heads, cuda)
    leaf = qkv.detach().clone().requires_grad_()
    keeps = fap._philox_keep_mask(seeds, s, 1.0 - RATE)
    (want,) = torch.autograd.grad(fap._fused_fwd_math(leaf, heads, keeps, 1.0 - RATE), leaf, g)
    assert (grad - want).abs().max().item() <= 1e-5 * want.abs().max().item()


# ---------------------------- the Hopper backward: statistics from the forward


@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("b,s,heads,d", [(2, 256, 16, 64), (2, 256, 2, 128), (2, 1, 4, 64), (2, 63, 4, 64),
                                         (3, 200, 3, 64), (2, 384, 4, 64), (2, 63, 2, 128), (1, 200, 2, 128)])
def test_k3_k6b_from_the_forward_statistics(cuda, b, s, heads, d, rate):
    # bf16 at head_dim 64 and 128: K2's row statistics against the plain
    # version's (f32 logits, sums in another order: 1e-4); K3 and K6b from
    # them against the plain backward (at S = 1 dQ and dK vanish: delta from
    # the bf16 output and dP from the products are two roundings of terms
    # of dV's scale, so 2e-2 of dV's largest element beside); with them
    # given, without them (the forward launched first) and launched twice:
    # the same bits; K3's dqkv K6b's dq|dk|dv interleaved
    gen = torch.Generator(device=cuda).manual_seed(24)
    qkv = _randn(gen, b, s, 3 * heads * d, dtype=torch.bfloat16, device=cuda)
    do = _randn(gen, b, s, heads * d, dtype=torch.bfloat16, device=cuda)
    seeds = _seeds(gen, b, heads, cuda) if rate else None
    keeps = fap._philox_keep_mask(seeds, s, 1.0 - rate) if rate else None
    out, lse = fap.flash_attention_fused_cuda(qkv, heads, seeds, rate, with_lse=True)
    assert torch.equal(out, fap.flash_attention_fused_cuda(qkv, heads, seeds, rate))
    assert (lse - fap._fused_lse_math(qkv, heads)).abs().max().item() <= 1e-4
    forwards = fap.flash_attention_fused_cuda.launches
    got = fap.flash_attention_fused_bwd_cuda(qkv, do, heads, seeds, rate, out=out, lse=lse)
    assert fap.flash_attention_fused_cuda.launches == forwards
    want = fap._fused_bwd_math(qkv, do, heads, keeps, 1.0 - rate)
    floor = 2e-2 * fap.split_qkv_grouped(want, heads)[2].float().abs().max().item() if s == 1 else 0.0
    _bwd_close(got, want, torch.bfloat16, floor)
    assert torch.equal(got, fap.flash_attention_fused_bwd_cuda(qkv, do, heads, seeds, rate, out=out, lse=lse))
    assert torch.equal(got, fap.flash_attention_fused_bwd_cuda(qkv, do, heads, seeds, rate))
    assert fap.flash_attention_fused_cuda.launches == forwards + 1
    q, k, v = (fap._merge_heads(t).contiguous() for t in fap.split_qkv_grouped(qkv, heads))
    out6, lse6 = fap.flash_attention_packed_cuda(q, k, v, heads, seeds, rate, with_lse=True)
    assert torch.equal(lse6, lse)
    grads = fap.flash_attention_packed_bwd_cuda(q, k, v, do, heads, seeds, rate, out=out6, lse=lse6)
    for g, w in zip(grads, fap._packed_heads_bwd_math(q, k, v, do, heads, keeps, 1.0 - rate)):
        _bwd_close(g, w, torch.bfloat16, floor)
    assert torch.equal(got, _interleave(*grads, heads))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("shape", [(16, 1, 256, 128), (2, 2, 256, 64), (3, 1, 200, 128), (2, 1, 1, 128),
                                   (2, 2, 63, 64), (1, 1, 384, 128)])
def test_k5b_from_the_forward_statistics(cuda, shape, rate):
    gen = torch.Generator(device=cuda).manual_seed(25)
    q, k, v, do, seeds, keep = _k5_inputs(gen, shape, torch.bfloat16, rate, cuda)
    out, lse = fa.flash_attention_dropout_cuda(q, k, v, seeds, rate, with_lse=True)
    assert (lse - fa._lse_math(q, k, fa._scale(q))).abs().max().item() <= 1e-4
    grads = fa.flash_attention_bwd_cuda(q, k, v, do, seeds, rate, out=out, lse=lse)
    wants = fa._bwd_math(q, k, v, do, fa._scale(q), keep, 1.0 - rate)
    floor = 2e-2 * wants[2].abs().max().item() if shape[2] == 1 else 0.0  # as K3's at S = 1
    for g, w in zip(grads, wants):
        _bwd_close(g, w.to(torch.bfloat16), torch.bfloat16, floor)
    for again in (fa.flash_attention_bwd_cuda(q, k, v, do, seeds, rate, out=out, lse=lse),
                  fa.flash_attention_bwd_cuda(q, k, v, do, seeds, rate)):
        assert all(map(torch.equal, again, grads))
    # statistics from the plain version, in another layout, give the same
    # numbers up to their own rounding
    plain = fa.flash_attention_bwd_cuda(q, k, v, do, seeds, rate, out=out, lse=fa._lse_math(q, k, fa._scale(q)))
    for g, w in zip(plain, grads):
        _bwd_close(g, w, torch.bfloat16, floor)


@pytest.mark.parametrize("rate", [RATE, 0.1])
@pytest.mark.parametrize("kernel,b,heads,s,d", [("k3", 2, 4, 256, 64), ("k6b", 2, 4, 256, 64), ("k5b", 2, 2, 256, 64),
                                                ("k3", 2, 2, 200, 128), ("k5b", 2, 1, 256, 128)])
def test_backward_keep_masks_are_the_philox_twins_bit_for_bit(cuda, kernel, b, heads, s, d, rate):
    # keep_probe_bwd's inputs read the mask out of dV (the dkv kernel reads
    # the bits back) and dQ (the dq kernel draws them): one flipped bit moves
    # dV by 1 / (S keep_prob) >= 3.9e-3 and dQ by scale / (S keep_prob) >=
    # 3.8e-4 here, bf16 rounding by < 5e-5
    gen = torch.Generator(device=cuda).manual_seed(26)
    q, k, v, do = keep_probe_bwd(b, heads, s, d, torch.bfloat16, cuda)
    seeds = _seeds(gen, b, heads, cuda)
    keeps = fap._philox_keep_mask(seeds, s, 1.0 - rate)
    if kernel == "k3":
        got = fap.split_qkv_grouped(fap.flash_attention_fused_bwd_cuda(
            fap.merge_qkv_grouped(q, k, v), fap._merge_heads(do), heads, seeds, rate), heads)
    elif kernel == "k6b":
        got = [fap._split_heads(t, heads) for t in fap.flash_attention_packed_bwd_cuda(
            *(fap._merge_heads(t).contiguous() for t in (q, k, v, do)), heads, seeds, rate)]
    else:
        got = fa.flash_attention_bwd_cuda(q, k, v, do, seeds.reshape(-1), rate)
    want_dq, want_dv = keep_probe_bwd_counts(keeps, d, 1.0 - rate, fa._scale(q))
    assert (got[0].float() - want_dq).abs().max().item() <= 1e-4
    assert (got[2].float() - want_dv).abs().max().item() <= 1e-3


def test_training_paths_pass_the_statistics(cuda, monkeypatch):
    # the autograd paths launch each forward once and each backward once,
    # the backward reading the forward's statistics (no second forward);
    # under no_grad the forwards write none
    gen = torch.Generator(device=cuda).manual_seed(27)
    qkv = _randn(gen, 2, 256, 3 * 4 * 64, dtype=torch.bfloat16, device=cuda).requires_grad_()
    counts = fap.flash_attention_fused_cuda.launches, fap.flash_attention_fused_bwd_cuda.launches
    attention.multi_head_attention_fused_qkv(qkv, heads=4, dropout_rate=RATE, generator=gen).sum().backward()
    assert (fap.flash_attention_fused_cuda.launches, fap.flash_attention_fused_bwd_cuda.launches) == (
        counts[0] + 1, counts[1] + 1)
    q = _randn(gen, 2, 1, 256, 128, dtype=torch.bfloat16, device=cuda).requires_grad_()
    counts = fa.flash_attention_dropout_cuda.launches, fa.flash_attention_bwd_cuda.launches
    attention.multi_head_attention(q, q, q, dropout_rate=0.1, generator=gen).sum().backward()
    assert (fa.flash_attention_dropout_cuda.launches, fa.flash_attention_bwd_cuda.launches) == (
        counts[0] + 1, counts[1] + 1)
    calls = []
    real = fap.stats_buffer
    monkeypatch.setattr(fap, "stats_buffer", lambda *a: calls.append(a) or real(*a))
    with torch.no_grad():
        attention.multi_head_attention_fused_qkv(qkv, heads=4)
    assert not calls


def test_routes_report_their_statistics_and_scratch(cuda):
    # every library reports one stride for the statistics (the bf16 routes
    # at 64 and 128, rows over whole 128-row tiles) and 0 elsewhere, as the
    # plain versions' writes_stats has it; the scratch follows the route
    libs = (fap._lib(), fap._bwd_lib(), fa._dropout_lib(), fa._bwd_lib())
    for seq, d, dtype in itertools.product((1, 200, 256, 384), fa.HEAD_DIMS, (torch.bfloat16, torch.float32)):
        want = -(-seq // 128) * 128 if fa.writes_stats(dtype, d) else 0
        assert {fa.stats_ld(lib, seq, d, dtype) for lib in libs} == {want}
    size = lambda seq, d, dtype, dropout: fa.bwd_workspace(fa._bwd_lib(), 8, seq, d, dtype, dropout, cuda).numel()
    assert size(256, 64, torch.bfloat16, True) == 0  # one block a head
    assert size(384, 64, torch.bfloat16, False) == 8 * 384 * 4  # delta only
    assert size(384, 64, torch.bfloat16, True) == 8 * 384 * 4 + 8 * 9 * 2048  # and the keep bits
    assert size(384, 256, torch.bfloat16, True) == 3 * 8 * 384 * 4  # the recomputing bodies' statistics


# ------------------------------------------- K5f, K5b: whole-sequence attention

K5_RATE = 0.1


def _k5_inputs(gen, shape, dtype, rate, device):
    q, k, v, do = (_randn(gen, *shape, dtype=dtype, device=device) for _ in range(4))
    b, h, s, _ = shape
    seeds = fap.draw_seeds(b, h, device, gen).reshape(-1) if rate else None
    keep = fa._keep(q, seeds, rate)
    return q, k, v, do, seeds, keep


@pytest.mark.parametrize("rate", [0.0, K5_RATE])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("s", [128, 256, 384, 512])
def test_flash_attention_dropout_kernel_matches_plain(cuda, s, d, dtype, rate):
    # f32 within 1e-5 at rate 0.1 pins the in-kernel mask to the Philox twin:
    # one differing keep bit moves an output by about p * v / keep_prob
    gen = torch.Generator(device=cuda).manual_seed(40)
    q, k, v, _, seeds, keep = _k5_inputs(gen, (2, 2, s, d), dtype, rate, cuda)
    before = fa.flash_attention_dropout_cuda.launches
    got = fa.flash_attention_dropout(q, k, v, seeds, rate=rate)
    assert fa.flash_attention_dropout_cuda.launches == before + 1
    want = fa._fwd_math(q, k, v, fa._scale(q), keep, 1.0 - rate)
    assert got.dtype == dtype and got.shape == q.shape
    assert (got.float() - want).abs().max().item() <= _packed_atol(dtype)


@pytest.mark.parametrize("rate", [0.0, K5_RATE])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(3, 1, 200, 128), (2, 1, 1, 128), (1, 2, 1000, 128)])
def test_flash_attention_dropout_kernel_takes_ragged_lengths(cuda, shape, dtype, rate):
    # rows past S of a slice: the bf16 body's tensor maps zero-fill them, the
    # f32 body's copies too; keys past S are masked before the max
    gen = torch.Generator(device=cuda).manual_seed(41)
    q, k, v, _, seeds, keep = _k5_inputs(gen, shape, dtype, rate, cuda)
    got = fa.flash_attention_dropout_cuda(q, k, v, seeds, rate)
    want = fa._fwd_math(q, k, v, fa._scale(q), keep, 1.0 - rate)
    assert (got.float() - want).abs().max().item() <= _packed_atol(dtype)


@pytest.mark.parametrize("rate", [0.0, K5_RATE])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("s", [128, 256, 384, 512])
def test_flash_attention_bwd_kernel_matches_plain(cuda, s, d, dtype, rate):
    gen = torch.Generator(device=cuda).manual_seed(41)
    q, k, v, do, seeds, keep = _k5_inputs(gen, (2, 2, s, d), dtype, rate, cuda)
    before = fa.flash_attention_bwd_cuda.launches
    grads = fa.flash_attention_bwd(q, k, v, do, seeds, rate=rate)
    assert fa.flash_attention_bwd_cuda.launches == before + 1
    for g, w in zip(grads, fa._bwd_math(q, k, v, do, fa._scale(q), keep, 1.0 - rate)):
        _bwd_close(g, w.to(dtype), dtype)


def test_k5_kernels_refuse_unsupported(cuda):
    x = torch.zeros(1, 2, 128, 32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_dropout_cuda(x, x, x)
    y = torch.zeros(1, 2, 128, 64, device=cuda)
    with pytest.raises(ValueError, match="seeds"):
        fa.flash_attention_bwd_cuda(y, y, y, y, torch.zeros(1, 2, dtype=torch.int32, device=cuda), 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_dropout_cuda(y.transpose(2, 3), y.transpose(2, 3), y.transpose(2, 3))


def test_attention_dispatch_runs_k5f_and_k5b_with_dropout(cuda, monkeypatch):
    # [B, H, S, D] attention with dropout at S <= 512: K5f forward, K5b
    # backward, never the plain versions; the gradient is autograd's through
    # the plain forward with the seeds' mask, f32
    def plain(*args, **kw):
        raise AssertionError("a plain version ran on a CUDA tensor")

    gen = torch.Generator(device=cuda).manual_seed(42)
    b, h, s, d = 2, 2, 256, 128
    q, k, v, g = (_randn(gen, b, h, s, d, dtype=torch.float32, device=cuda) for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    counts = fa.flash_attention_dropout_cuda.launches, fa.flash_attention_bwd_cuda.launches
    state = gen.get_state()
    with monkeypatch.context() as m:
        m.setattr(fa, "_fwd_math", plain)
        m.setattr(fa, "_bwd_math", plain)
        out = attention.multi_head_attention(*leaves, dropout_rate=K5_RATE, generator=gen)
        grads = torch.autograd.grad(out, leaves, g)
    assert fa.flash_attention_dropout_cuda.launches == counts[0] + 1
    assert fa.flash_attention_bwd_cuda.launches == counts[1] + 1
    gen.set_state(state)
    keep = fa._keep(q, fap.draw_seeds(b, h, cuda, gen).reshape(-1), K5_RATE)
    plain_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want_out = fa._fwd_math(*plain_leaves, fa._scale(q), keep, 1.0 - K5_RATE)
    assert (out - want_out).abs().max().item() <= 1e-5
    for got, want in zip(grads, torch.autograd.grad(want_out, plain_leaves, g)):
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_tiny_unet16_on_card_matches_cpu(cuda):
    # the 16x16 slice: forward, train-loss gradients and the eval step's bpd,
    # f32, through K5f, K5b and K7 on the card against the plain path on the
    # CPU; dim 128 gives K5 a head of 128
    from bsi_torch.core import BSI
    from bsi_torch.models import DenoisingVDMUNet
    from bsi_torch.nn import FourierFeatures, NyquistPositionalEmbedding
    from bsi_torch.train import AdamState, TrainState, make_eval_step, module_apply

    torch.manual_seed(0)
    kw = dict(data_shape=(16, 16, 3), pos_emb=NyquistPositionalEmbedding(16, 100), dim=128, levels=2,
              fourier_features=FourierFeatures(6, 8))
    cpu = DenoisingVDMUNet(device="cpu", **kw).eval()
    card = DenoisingVDMUNet(device=cuda, **kw).eval()
    card.load_state_dict(cpu.state_dict())
    algo = BSI(data_shape=(16, 16, 3), lambda_0=1e-2, alpha_M=1e6, alpha_R=2e6, k=50, preconditioning="edm")
    gen = torch.Generator().manual_seed(1)
    x = torch.rand(2, 16, 16, 3, generator=gen) * 2 - 1
    mu, t = torch.randn(2, 16, 16, 3, generator=gen), torch.rand(2, generator=gen)
    k5f, k5b, k1 = (fa.flash_attention_dropout_cuda.launches, fa.flash_attention_bwd_cuda.launches,
                    fa.flash_attention_cuda.launches)
    with torch.inference_mode():
        want, got = cpu(mu, t), card(mu.to(cuda), t.to(cuda)).cpu()
    assert (got - want).abs().max().item() <= 1e-4 * max(1.0, want.abs().max().item())
    tt, eps = algo.train_noise(gen, x)
    grads = []
    for model, dev in ((cpu, "cpu"), (card, cuda)):
        named = dict(model.named_parameters())
        loss = algo._train_loss_on(model, x.to(dev), tt.to(dev), eps.to(dev)).mean()
        grads.append([gr.cpu() for gr in torch.autograd.grad(loss, list(named.values()))])
    for (name, _), w, gr in zip(cpu.named_parameters(), *grads):
        assert (gr - w).norm() <= 1e-3 * w.norm() + 1e-12, name
    draws = algo.elbo_noise(gen, x)
    bpds = []
    for model, dev in ((cpu, "cpu"), (card, cuda)):
        params = {k: v.detach() for k, v in model.named_parameters()}
        state = TrainState.create(params=params, opt_state=AdamState(0, {}, {}), generator=torch.Generator())
        step = make_eval_step(algo, module_apply(model, train=False),
                              noise=lambda batch: [d.to(batch.device) for d in draws])
        bpds.append(step(state, x.to(dev), torch.ones(2, device=dev))["bpd_sum"].item())
    assert abs(bpds[1] - bpds[0]) <= 1e-4 * abs(bpds[0])
    assert fa.flash_attention_dropout_cuda.launches == k5f + 1 + 1 + 2
    assert fa.flash_attention_bwd_cuda.launches == k5b + 1
    assert fa.flash_attention_cuda.launches == k1


@pytest.mark.parametrize("side", [16, 32])
def test_tiny_gelu_unet_with_attention_tails_on_card_matches_cpu(cuda, side):
    # downsampling_attention: an attention in each of the 4 blocks and the
    # centre, over S = side^2 pixels: K5f at 16x16, K1 at 32x32. f32 against
    # the plain path on the CPU.
    from bsi_torch.models import DenoisingVDMUNet
    from bsi_torch.nn import FourierFeatures, NyquistPositionalEmbedding

    torch.manual_seed(0)
    shape = (side, side, 3)
    kw = dict(data_shape=shape, pos_emb=NyquistPositionalEmbedding(16, 100), dim=128, levels=1, actfn="gelu",
              downsampling_attention=True, fourier_features=FourierFeatures(6, 8))
    cpu = DenoisingVDMUNet(device="cpu", **kw).eval()
    card = DenoisingVDMUNet(device=cuda, **kw).eval()
    card.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(1)
    mu, t = torch.randn((2,) + shape, generator=gen), torch.rand(2, generator=gen)
    k5f, k1 = fa.flash_attention_dropout_cuda.launches, fa.flash_attention_cuda.launches
    with torch.inference_mode():
        want, got = cpu(mu, t), card(mu.to(cuda), t.to(cuda)).cpu()
    assert fa.flash_attention_dropout_cuda.launches == k5f + (5 if side == 16 else 0)
    assert fa.flash_attention_cuda.launches == k1 + (5 if side == 32 else 0)
    assert (got - want).abs().max().item() <= 1e-4 * max(1.0, want.abs().max().item())


def test_dit_remat_on_card_redraws_the_same_dropout(cuda):
    # remat with dropout 0.05 in K2 (seeds drawn inside each block) and
    # nn.Dropout: the recompute restores the card's RNG state, so the masks
    # and the gradients are those without remat. f32; each leaf within 1e-6
    # of its norm, the kernels' own run-to-run order of sums.
    from bsi_torch.core import BSI
    from bsi_torch.models import DenoisingDiT

    kw = dict(data_shape=(32, 32, 3), patch_size=2, dim=128, depth=2, heads=2, dropout=0.05)
    algo = BSI(data_shape=(32, 32, 3), lambda_0=1e-2, alpha_M=1e6, alpha_R=2e6, k=50, preconditioning="edm")
    gen = torch.Generator().manual_seed(2)
    x = torch.rand(2, 32, 32, 3, generator=gen) * 2 - 1
    t, eps = algo.train_noise(gen, x)
    grads = []
    for remat in (False, True):
        torch.manual_seed(0)
        model = DenoisingDiT(remat=remat, device=cuda, **kw).train()
        with torch.no_grad():
            for name, p in model.named_parameters():
                if ".ada_out." in name:
                    p.normal_(0.0, 0.02)
        named = dict(model.named_parameters())
        torch.cuda.manual_seed(3)
        k2 = fap.flash_attention_fused_cuda.launches
        loss = algo._train_loss_on(model, x.to(cuda), t.to(cuda), eps.to(cuda)).mean()
        grads.append(torch.autograd.grad(loss, list(named.values())))
        assert fap.flash_attention_fused_cuda.launches == k2 + (4 if remat else 2)
    for (name, _), want, got in zip(named.items(), *grads):
        assert (got - want).norm() <= 1e-6 * want.norm() + 1e-12, name


# ------------------------------------------------- K4f: LayerNorm+modulate


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(64, 256, 1024), (3, 16, 384), (2, 5, 100)])
def test_ln_modulate_kernel_matches_plain(cuda, shape, dtype):
    gen = torch.Generator(device=cuda).manual_seed(13)
    b, s, d = shape
    x = _randn(gen, *shape, dtype=dtype, device=cuda) * 2.0 + 0.5
    # shift and scale as column slices of one adaLN output, as the DiT has them
    mod = _randn(gen, b, 6 * d, dtype=dtype, device=cuda)
    shift, scale = mod[:, :d], mod[:, d:2 * d] * 0.1
    assert not shift.is_contiguous()
    before = lm.layernorm_modulate_cuda.launches
    got = lm.layernorm_modulate_cuda(x, shift, scale)
    assert lm.layernorm_modulate_cuda.launches == before + 1
    want = lm._reference_math(x, shift, scale)
    assert got.dtype == dtype and got.shape == x.shape
    # bf16: f32 statistics summed in another order can move the final
    # rounding by one bf16 ulp (2^-7 relative at most)
    atol, rtol = (2e-2, 2**-7) if dtype == torch.bfloat16 else (1e-5, 0.0)
    assert ((got.float() - want.float()).abs() <= atol + rtol * want.float().abs()).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(64, 256, 1024), (3, 16, 384), (2, 5, 100), (2, 300, 256)])
def test_ln_modulate_bwd_kernel_matches_plain(cuda, shape, dtype):
    gen = torch.Generator(device=cuda).manual_seed(15)
    b, s, d = shape
    x = _randn(gen, *shape, dtype=dtype, device=cuda) * 2.0 + 0.5
    g = _randn(gen, *shape, dtype=dtype, device=cuda)
    scale = _randn(gen, b, 6 * d, dtype=dtype, device=cuda)[:, d:2 * d] * 0.1
    before = lm.layernorm_modulate_bwd_cuda.launches
    got = lm.layernorm_modulate_bwd_cuda(x, scale, g)
    assert lm.layernorm_modulate_bwd_cuda.launches == before + 1
    assert_bwd_close(got, lm._bwd_math(x, scale, g), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(64, 256, 1024), (2, 300, 256)])
def test_ln_modulate_bwd_kernel_repeats_bit_for_bit(cuda, shape, dtype):
    # dshift and dscale are summed in warp order, then in cluster rank order,
    # without atomics
    gen = torch.Generator(device=cuda).manual_seed(16)
    b, s, d = shape
    x = _randn(gen, *shape, dtype=dtype, device=cuda) * 2.0 + 0.5
    g = _randn(gen, *shape, dtype=dtype, device=cuda)
    scale = _randn(gen, b, 6 * d, dtype=dtype, device=cuda)[:, d:2 * d] * 0.1
    first = lm.layernorm_modulate_bwd_cuda(x, scale, g)
    assert all(map(torch.equal, lm.layernorm_modulate_bwd_cuda(x, scale, g), first))


def test_ln_modulate_bwd_kernel_refuses_misaligned_rows(cuda):
    x = torch.zeros(2 * 8 * 128 + 1, device=cuda)[1:].view(2, 8, 128)
    assert x.is_contiguous() and x.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        lm.layernorm_modulate_bwd_cuda(x, torch.zeros(2, 128, device=cuda), torch.zeros_like(x))


def test_ln_modulate_dispatch_and_backward(cuda):
    gen = torch.Generator(device=cuda).manual_seed(14)
    x = _randn(gen, 2, 256, 1024, dtype=torch.bfloat16, device=cuda).requires_grad_()
    mod = _randn(gen, 2, 6 * 1024, dtype=torch.bfloat16, device=cuda).requires_grad_()
    shift, scale = mod[:, :1024], mod[:, 1024:2048]
    fwd, bwd = lm.layernorm_modulate_cuda.launches, lm.layernorm_modulate_bwd_cuda.launches
    out = lm.layernorm_modulate(x, shift, scale)
    g = _randn(gen, 2, 256, 1024, dtype=torch.bfloat16, device=cuda)
    dx, dmod = torch.autograd.grad(out, (x, mod), g)
    assert lm.layernorm_modulate_cuda.launches == fwd + 1
    assert lm.layernorm_modulate_bwd_cuda.launches == bwd + 1
    want = lm._bwd_math(x.detach(), scale.detach(), g)
    assert torch.equal(dx, want[0]) or (dx.float() - want[0].float()).abs().max().item() <= 2e-2
    assert dmod.dtype == torch.bfloat16 and (dmod[:, 2048:] == 0).all()
    # a shape the JAX package keeps off its kernel takes the plain path, and
    # its backward is autograd through it
    y = _randn(gen, 2, 7, 100, dtype=torch.float32, device=cuda).requires_grad_()
    out = lm.layernorm_modulate(y, shift[:, :100].float().detach(), scale[:, :100].float().detach())
    assert lm.layernorm_modulate_cuda.launches == fwd + 1
    out.sum().backward()
    assert lm.layernorm_modulate_bwd_cuda.launches == bwd + 1
    assert torch.isfinite(y.grad).all()


def test_tiny_dit_on_card_matches_cpu(cuda):
    from bsi_torch.models import DenoisingDiT
    from bsi_torch.nn import FourierFeatures

    torch.manual_seed(0)
    kw = dict(data_shape=(32, 32, 3), patch_size=2, dim=128, depth=2, heads=2,
              fourier_features=FourierFeatures(6, 8))
    cpu = DenoisingDiT(device="cpu", **kw).eval()
    with torch.no_grad():
        for i in range(2):  # adaLN-Zero: without this every block is the identity
            ada = getattr(cpu.dit, f"block_{i}").ada_out
            ada.weight.normal_(0.0, 0.02)
            ada.bias.normal_(0.0, 0.02)
    card = DenoisingDiT(device=cuda, **kw).eval()
    card.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(1)
    mu, t = torch.randn(2, 32, 32, 3, generator=gen), torch.rand(2, generator=gen)
    k2, k4 = fap.flash_attention_fused_cuda.launches, lm.layernorm_modulate_cuda.launches
    with torch.inference_mode():
        want = cpu(mu, t)
        got = card(mu.to(cuda), t.to(cuda)).cpu()
    assert fap.flash_attention_fused_cuda.launches == k2 + 2
    assert lm.layernorm_modulate_cuda.launches == k4 + 4
    # f32 on both sides, TF32 off: sums in another order through two blocks
    assert (got - want).abs().max().item() <= 1e-4 * max(1.0, want.abs().max().item())


def test_tiny_dit_train_gradients_on_card_match_cpu(cuda):
    # f32, dropout off (the card's masks and the CPU's cannot match), ada_out
    # filled: the train-loss gradient through K2, K3, K4f and K4b against the
    # plain path on the CPU, each leaf within 1e-4 of its norm
    from bsi_torch.core import BSI
    from bsi_torch.models import DenoisingDiT
    from bsi_torch.nn import FourierFeatures

    torch.manual_seed(0)
    kw = dict(data_shape=(32, 32, 3), patch_size=2, dim=128, depth=2, heads=2,
              fourier_features=FourierFeatures(6, 8))
    cpu = DenoisingDiT(device="cpu", **kw)
    with torch.no_grad():
        for name, p in cpu.named_parameters():
            if ".ada_out." in name:
                p.normal_(0.0, 0.02)
    card = DenoisingDiT(device=cuda, **kw)
    card.load_state_dict(cpu.state_dict())
    algo = BSI(data_shape=(32, 32, 3), lambda_0=1e-2, alpha_M=1e6, alpha_R=2e6, k=50, preconditioning="edm")
    gen = torch.Generator().manual_seed(2)
    x = torch.rand(2, 32, 32, 3, generator=gen) * 2 - 1
    t, eps = algo.train_noise(gen, x)
    counts = (fap.flash_attention_fused_bwd_cuda.launches, lm.layernorm_modulate_bwd_cuda.launches)
    grads = []
    for model, dev in ((cpu, "cpu"), (card, cuda)):
        named = dict(model.named_parameters())
        loss = algo._train_loss_on(model, x.to(dev), t.to(dev), eps.to(dev)).mean()
        grads.append([g.cpu() for g in torch.autograd.grad(loss, list(named.values()))])
    assert fap.flash_attention_fused_bwd_cuda.launches == counts[0] + 2
    assert lm.layernorm_modulate_bwd_cuda.launches == counts[1] + 4
    for (name, _), want, got in zip(cpu.named_parameters(), *grads):
        assert (got - want).norm() <= 1e-4 * want.norm() + 1e-12, name
