"""K8f, the f32 3x3 convolution (``bsi_torch/ops/conv3x3.py``): its dispatch
and wrapper on the CPU, and the kernel against f64 ``F.conv2d`` on the card.

The ``cuda`` tests need an NVIDIA GPU and import neither JAX nor
``bsi_tpu``:

    python -m pytest --noconftest tests/test_torch_conv3x3.py -m cuda
"""

from __future__ import annotations

import pytest
import torch
from torch.nn import functional as F

from bsi_torch.models.unet import DenoisingVDMUNet
from bsi_torch.nn import Conv, FourierFeatures, NyquistPositionalEmbedding
from bsi_torch.ops import conv3x3 as cv
from bsi_torch.utils import profiling

CPU = [torch.profiler.ProfilerActivity.CPU]
CL = torch.channels_last


@pytest.fixture(autouse=True)
def fresh():
    profiling.clear()
    yield
    profiling.clear()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def k8f_counts() -> dict:
    return {key: n for key, n in profiling.counters().items() if key.startswith("ops.K8f.")}


# (kernel size, Cin, Cout, dtype, channels_last): whether the kernel fits it
ROUTES = {
    "f32 3x3": ((3, 16, 8, torch.float32, True), True),
    "bf16": ((3, 16, 8, torch.bfloat16, True), False),
    "1x1": ((1, 16, 8, torch.float32, True), False),
    "Cin 21": ((3, 21, 8, torch.float32, True), False),
    "Cout 6": ((3, 16, 6, torch.float32, True), False),
    "NCHW": ((3, 16, 8, torch.float32, False), False),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_conv_routes_by_its_inputs_and_the_cpu_runs_plain(case):
    (size, cin, cout, dtype, channels_last), fit = ROUTES[case]
    torch.manual_seed(0)
    layer = Conv(cin, cout, size, dtype=dtype)
    with torch.no_grad():
        layer.bias.normal_()
    x = torch.randn(2, cin, 5, 6).to(memory_format=CL if channels_last else torch.contiguous_format)
    assert cv.fits(x.to(dtype), layer.weight.to(dtype)) == (fit and size == 3)
    with torch.no_grad(), torch.profiler.profile(activities=CPU):
        got = layer(x)
    want = F.conv2d(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype), padding=size // 2)
    assert got.dtype == dtype and torch.equal(got, want)
    # only 3x3 convolutions are K8f's to take or leave
    assert k8f_counts() == ({"ops.K8f.plain": 1} if size == 3 else {})


@pytest.mark.parametrize("case,match", [
    ("bf16", "takes an f32"), ("Cin 12", "takes an f32"), ("NCHW", "takes an f32"),
    ("5x5", "takes an f32"), ("bias", "bias"), ("bias f64", "bias"), ("cpu", "CUDA device"),
])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(case, match):
    cin = 12 if case == "Cin 12" else 16
    x = torch.randn(2, cin, 4, 4, dtype=torch.bfloat16 if case == "bf16" else torch.float32)
    if case != "NCHW":
        x = x.to(memory_format=CL)
    weight = torch.randn(8, cin, 5 if case == "5x5" else 3, 5 if case == "5x5" else 3, dtype=x.dtype)
    bias = torch.randn(7 if case == "bias" else 8, dtype=torch.float64 if case == "bias f64" else torch.float32)
    with pytest.raises(ValueError, match=match):
        cv.conv3x3_cuda(x, weight, bias)


@pytest.mark.parametrize("needed", [(True, True, True), (True, False, False), (False, True, True)])
def test_the_function_takes_cudnns_gradients(monkeypatch, needed):
    """The autograd Function's backward is ``F.conv2d``'s: with the launch
    replaced by ``F.conv2d`` on the CPU, every gradient asked for is the
    plain one."""
    monkeypatch.setattr(cv, "conv3x3_cuda", lambda x, w, b: F.conv2d(x, w, b, padding=1))
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 8, 5, 4, generator=gen, dtype=torch.float64).to(memory_format=CL)
    w = torch.randn(4, 8, 3, 3, generator=gen, dtype=torch.float64)
    b = torch.randn(4, generator=gen, dtype=torch.float64)
    g = torch.randn(2, 4, 5, 4, generator=gen, dtype=torch.float64)
    inputs = [t.clone().requires_grad_(n) for t, n in zip((x, w, b), needed)]
    plain = [t.clone().requires_grad_(n) for t, n in zip((x, w, b), needed)]
    got = torch.autograd.grad(cv._Conv3x3.apply(*inputs), [t for t in inputs if t.requires_grad], g)
    want = torch.autograd.grad(F.conv2d(*plain, padding=1), [t for t in plain if t.requires_grad], g)
    assert len(got) == sum(needed)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, rtol=1e-12, atol=1e-12)


# (Cin, Cout, channels_last, 16-byte aligned): inputs the dispatch fits to the
# kernel on the card
FITTED = {
    "encode's Cin 21": (21, 8, True, True),
    "Cout 6": (16, 6, True, True),
    "NCHW": (16, 8, False, True),
    "unaligned": (16, 8, True, False),
}


@pytest.mark.parametrize("case", list(FITTED))
def test_the_dispatch_fits_any_f32_input_to_the_kernel(monkeypatch, case):
    """``_fitted`` pads the channels and copies the layout until the launch
    takes them, and its output and gradients are ``F.conv2d``'s on the
    caller's tensors: the launch replaced by ``F.conv2d`` on the CPU, in f64."""
    cin, cout, channels_last, aligned = FITTED[case]

    def launch(x, w, b):
        assert x.shape[1] % cv.K_TILE == 0 and w.shape[:2] == (b.shape[0], x.shape[1])
        assert w.shape[0] % cv.COUT_VECTOR == 0 and x.is_contiguous(memory_format=CL) and x.data_ptr() % 16 == 0
        return F.conv2d(x, w, b, padding=1)

    monkeypatch.setattr(cv, "conv3x3_cuda", launch)
    gen = torch.Generator().manual_seed(4)
    shape = (2, 5, 6, cin)
    x = torch.randn(1 + 2 * 5 * 6 * cin, generator=gen, dtype=torch.float64)[1 - aligned:][:2 * 5 * 6 * cin]
    x = x.view(shape).permute(0, 3, 1, 2)
    if not channels_last:
        x = x.contiguous()
    assert x.is_contiguous(memory_format=CL) == channels_last and (x.data_ptr() % 16 == 0) == aligned
    w = torch.randn(cout, cin, 3, 3, generator=gen, dtype=torch.float64)
    b = torch.randn(cout, generator=gen, dtype=torch.float64)
    g = torch.randn(2, cout, 5, 6, generator=gen, dtype=torch.float64)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    plain = [t.clone().requires_grad_() for t in (x, w, b)]
    got, want = cv._fitted(*leaves), F.conv2d(*plain, padding=1)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    for a, e in zip(torch.autograd.grad(got, leaves, g), torch.autograd.grad(want, plain, g)):
        assert a.shape == e.shape
        torch.testing.assert_close(a, e, rtol=1e-12, atol=1e-12)


def tiny_unet(dtype=None, device=None) -> DenoisingVDMUNet:
    torch.manual_seed(0)
    return DenoisingVDMUNet((4, 4, 3), NyquistPositionalEmbedding(8, 100), fourier_features=FourierFeatures(6, 8),
                            dim=32, levels=1, n_attention_heads=1, dtype=dtype, device=device).eval()


def test_a_unet_forward_counts_each_3x3_convolution():
    model = tiny_unet(device="cpu")
    convs = [m for m in model.modules() if isinstance(m, Conv) and m.kernel_size == (3, 3)]
    assert len(convs) == 4 * 1 + 2 * 2 + 2 + 1  # 2 a block in 4 blocks, qkv, out, encode
    mu = torch.rand(2, 4, 4, 3)
    with torch.no_grad(), torch.profiler.profile(activities=CPU):
        for _ in range(2):
            model(mu, torch.full((2,), 0.5))
    assert k8f_counts() == {"ops.K8f.plain": 2 * len(convs)}


# ------------------------------------------------------------------ the card
# (batch, Cin, Cout, H, W): the UNet's three (128 -> 128, the up blocks'
# 256 -> 128, the attention's 128 -> 384), then batch 1, a border-heavy 8x8,
# tiles that the pixels and Cout leave ragged, and the least Cin.
SHAPES = [(128, 128, 128, 32, 32), (128, 256, 128, 32, 32), (128, 128, 384, 32, 32), (1, 128, 128, 32, 32),
          (16, 128, 128, 8, 8), (3, 48, 132, 5, 7), (2, 16, 4, 9, 3)]


def lecun(gen, cout, cin, device):
    return torch.randn(cout, cin, 3, 3, generator=gen, device=device) / (9 * cin) ** 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_f64_conv2d(cuda, shape):
    b, cin, cout, h, w = shape
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(b, cin, h, w, generator=gen, device=cuda).to(memory_format=CL)
    weight = lecun(gen, cout, cin, cuda)
    bias = torch.randn(cout, generator=gen, device=cuda)
    got = cv.conv3x3_cuda(x, weight, bias)
    again = cv.conv3x3_cuda(x, weight, bias)
    want = F.conv2d(x.double(), weight.double(), bias.double(), padding=1)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == want.shape and got.is_contiguous(memory_format=CL)
    # f32 sums of 9 Cin products of size ~1 / sqrt(9 Cin) into outputs up to
    # ~5, rounded at each of up to 2,304 steps: ~1e-5 at the worst of 16 M
    # outputs; TF32 products would miss by ~5e-4 typically
    assert (got.double() - want).abs().max().item() <= 5e-5
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_gradients_through_the_kernel_are_conv2ds(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(4, 32, 8, 8, generator=gen, device=cuda).to(memory_format=CL)
    weight, bias = lecun(gen, 64, 32, cuda), torch.randn(64, generator=gen, device=cuda)
    g = torch.randn(4, 64, 8, 8, generator=gen, device=cuda).to(memory_format=CL)
    leaves = [t.clone().requires_grad_() for t in (x, weight, bias)]
    launches = cv.conv3x3_cuda.launches
    got = torch.autograd.grad(cv.conv3x3(*leaves), leaves, g)
    assert cv.conv3x3_cuda.launches == launches + 1
    plain = [t.clone().requires_grad_() for t in (x, weight, bias)]
    want = torch.autograd.grad(F.conv2d(*plain, padding=1), plain, g)
    for a, e in zip(got, want):
        assert (a - e).abs().max().item() <= 1e-5 * e.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FITTED))
def test_the_dispatch_on_the_card_matches_f64_conv2d(cuda, case):
    cin, cout, channels_last, aligned = FITTED[case]
    gen = torch.Generator(device=cuda).manual_seed(5)
    n = 128 * 32 * 32 * cin if case.startswith("encode") else 2 * 5 * 6 * cin
    shape = (128, 32, 32, cin) if case.startswith("encode") else (2, 5, 6, cin)
    x = torch.randn(1 + n, generator=gen, device=cuda)[1 - aligned:][:n].view(shape).permute(0, 3, 1, 2)
    if not channels_last:
        x = x.contiguous()
    weight, bias = lecun(gen, cout, cin, cuda), torch.randn(cout, generator=gen, device=cuda)
    launches = cv.conv3x3_cuda.launches
    got = cv.conv3x3(x, weight, bias)
    assert cv.conv3x3_cuda.launches == launches + 1
    want = F.conv2d(x.double(), weight.double(), bias.double(), padding=1)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert (got.double() - want).abs().max().item() <= 5e-5


@pytest.mark.cuda
def test_the_card_routes_f32_channels_last_to_the_kernel(cuda):
    model = tiny_unet(device=cuda)
    convs = [m for m in model.modules() if isinstance(m, Conv) and m.kernel_size == (3, 3)]
    mu = torch.rand(2, 4, 4, 3, device=cuda)
    with torch.no_grad(), torch.profiler.profile(activities=CPU):
        model(mu, torch.full((2,), 0.5, device=cuda))
    # every 3x3, the encode's 21 Fourier channels padded to 32
    assert k8f_counts() == {"ops.K8f.kernel": len(convs)}
    layer = Conv(16, 8, 3, device=cuda)
    x = torch.randn(2, 16, 4, 4, device=cuda)
    launches = cv.conv3x3_cuda.launches
    layer(x.to(memory_format=CL))
    assert cv.conv3x3_cuda.launches == launches + 1
    layer(x)  # NCHW: copied to channels_last
    assert cv.conv3x3_cuda.launches == launches + 2
    Conv(16, 8, 3, dtype=torch.bfloat16, device=cuda)(x.to(memory_format=CL))
    assert cv.conv3x3_cuda.launches == launches + 2
