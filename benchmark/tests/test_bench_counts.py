"""The analytic counts: the models' FLOPs a forward, and each kernel call's
bound at the shapes of the kernel table in PERF.md."""

import pytest
import torch

from benchmark import counts, harness, reference
from benchmark.tests import tiny

DIT, UNET = (harness.load_cell(name) for name in ("dit-l2-in32.train-b64", "vdm-unet-c10.sample-k20-b128"))


def test_model_flops_at_the_published_widths():
    assert reference.model("dit").flops(DIT.reference_model()) / 1e9 == pytest.approx(161.46, abs=0.005)
    assert reference.model("unet").flops(UNET.reference_model()) / 1e9 == pytest.approx(53.47, abs=0.005)


@pytest.mark.parametrize("name", ["dit-l2-in32.train-b64", "vdm-unet-c10.sample-k20-b128"])
def test_model_flops_equal_the_layers_the_port_runs(name):
    """Held to the shapes the port's layers see (its ``count_flops`` hooks)."""
    from bsi_torch.profile_sampling import count_flops
    from bsi_torch.tasks.task import build_model

    cell = tiny.cell(name)
    model = build_model(cell.config["program"]["task"]["model"], tuple(cell.config["data_shape"]), device="cpu")
    mu = torch.zeros((2, *cell.config["data_shape"]))
    with torch.no_grad():
        hooked = sum(count_flops(model, lambda: model.eval()(mu, torch.full((2,), 0.5))).values()) / 2
    assert cell.model.flops(cell.reference_model()) == pytest.approx(hooked, rel=1e-12)


@pytest.mark.parametrize("call, shape, dtype, ms", [
    (counts.attention_fwd, (64, 16, 256, 64), "bf16", 0.0401),  # K2 [64, 256, 3072]
    (counts.attention_bwd, (64, 16, 256, 64), "bf16", 0.0701),  # K3
    (counts.attention_fwd, (64, 1, 1024, 128), "bf16", 0.0347),  # K1, by its operations
    (counts.attention_fwd, (64, 1, 256, 128), "bf16", 0.0050),  # K5f
    (counts.attention_fwd, (64, 1, 256, 128), "f32", 0.0321),  # K5f f32, by its operations
    (counts.attention_bwd, (128, 1, 256, 128), "bf16", 0.0175),  # K5b
    (counts.ln_modulate_fwd, (64, 256, 1024), "bf16", 0.0201),  # K4f
    (counts.ln_modulate_bwd, (64, 256, 1024), "bf16", 0.0302),  # K4b
    (counts.groupnorm_silu_fwd, (64, 1024, 256), "bf16", 0.0200),  # K7f at C=256
    (counts.groupnorm_silu_fwd, (64, 1024, 128), "bf16", 0.0100),  # K7f at C=128
    (counts.groupnorm_silu_bwd, (128, 1024, 256), "bf16", 0.0601),  # K7b at C=256
    (counts.conv3x3_fwd, (128, 32, 32, 128, 128), "f32", 0.5769),  # K8f 128->128, by its operations
    (counts.conv3x3_fwd, (128, 32, 32, 256, 128), "f32", 1.1539),  # K8f 256->128
    (counts.conv3x3_fwd, (128, 32, 32, 128, 384), "f32", 1.7308),  # K8f 128->384
])
def test_bounds_of_the_kernel_table(call, shape, dtype, ms):
    assert counts.bound_s(*call(*shape, dtype), dtype) * 1e3 == pytest.approx(ms, abs=5e-5)


def test_calls_a_forward():
    dit, unet = reference.model("dit"), reference.model("unet")
    dit_sizes, unet_sizes = DIT.reference_model(), UNET.reference_model()
    assert [n for _, n in dit.attention_calls(dit_sizes, 64, "bf16", True)] == [24, 24]
    assert [n for _, n in dit.norm_calls(dit_sizes, 64, "bf16", False)] == [48]
    assert dit.conv3x3_calls(dit_sizes, 64, "bf16") == []
    assert [n for _, n in unet.attention_calls(unet_sizes, 128, "f32", False)] == [1]
    assert [n for _, n in unet.norm_calls(unet_sizes, 128, "bf16", True)] == [34, 32, 34, 32]
    conv = unet.conv3x3_calls(unet_sizes, 128, "f32")
    assert [n for _, n in conv] == [1, 101, 32, 1]  # 135: encode, d->d, 2d->d (up), qkv
    assert conv[1][0] * 1e3 == pytest.approx(0.577, abs=5e-4)  # 128->128 at b128, as PERF.md's kernel table
