"""The port's trainer on two gloo ranks against one process, on the CPU,
f64: data parallelism and FSDP (the UNet and the DiT), the DiT's tensor
parallelism with and without sequence parallelism, each also with
attention and block dropout on, resume under FSDP and TP, a one-process
checkpoint restored under FSDP, and every guard's message (the pipeline's
own layouts are in ``tests/test_torch_pipeline.py``). One launch of
``tests/torch_parallel_worker.py`` runs them all; each rank runs its
one-process baseline beside the layout. Tolerances are the JAX package's
(``tests/test_multiprocess.py``): 1e-5 relative on the trajectory, the
validation bpd and the parameters, 1e-12 between ranks."""

import numpy.testing as npt
import pytest

from torch_parallel_worker import launch

LAYOUTS = ["unet_dp", "unet_fsdp", "dit_fsdp", "dit_tp", "dit_tp_sp", "dit_tp_dropout", "dit_tp_sp_dropout"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return launch(tmp_path_factory.mktemp("ranks2"), 2, "layouts2,resume,guards")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_two_ranks_reproduce_one_process(ranks, layout):
    a, b = (r["layouts2"][layout] for r in ranks)
    # both ranks hold the same replicated view of the run
    for key in ("loss", "grad_norm", "val_bpd", "val_fid", "param_sum"):
        npt.assert_allclose(a["layout"][key], b["layout"][key], rtol=1e-12, err_msg=key)
    got, want = a["layout"], a["base"]
    npt.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    npt.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-5)
    npt.assert_allclose(got["val_bpd"], want["val_bpd"], rtol=1e-5)
    npt.assert_allclose(got["val_fid"], want["val_fid"], rtol=1e-6)
    npt.assert_allclose(got["param_sum"], want["param_sum"], rtol=1e-5)
    # each leaf: f64 throughout, so far below the JAX test's 1e-5
    assert a["worst_leaf"] < 1e-9, a["worst_leaf"]
    assert len(got["loss"]) == 3


def test_layouts_hold_only_their_shards(ranks):
    d = ranks[0]["layouts2"]
    assert d["unet_dp"]["local_numel"] == d["unet_dp"]["full_numel"]
    # FSDP: the leaves of 2**14 elements or more are halved
    assert d["unet_fsdp"]["local_numel"] < d["unet_fsdp"]["full_numel"]
    assert d["dit_fsdp"]["local_numel"] < d["dit_fsdp"]["full_numel"]
    # TP: every Megatron pair's weights are halved
    assert d["dit_tp"]["local_numel"] < 0.6 * d["dit_tp"]["full_numel"]


@pytest.mark.parametrize("layout", ["fsdp", "tp"])
def test_resume_is_exact(ranks, layout):
    for r in ranks:
        got = r["resume"][layout]
        assert got["bit_equal"] and got["step"] == 6 and got["count"] == 6


def test_a_replicated_checkpoint_restores_under_fsdp(ranks):
    got = ranks[0]["resume"]["replicated_to_fsdp"]
    assert got["step"] == 6
    # the FSDP run's 3 steps are the one-process run's steps 4-6
    npt.assert_allclose(got["layout"]["loss"], got["base"]["loss"][3:], rtol=1e-5)
    npt.assert_allclose(got["layout"]["val_bpd"], got["base"]["val_bpd"], rtol=1e-5)
    assert got["worst_leaf"] < 1e-9
    assert got["local_numel"] < got["full_numel"]


@pytest.mark.parametrize("guard, message", [
    ("sp_without_tp", "ValueError: sequence_parallel=true requires model_parallelism > 1"),
    ("pipeline", "ValueError: data.batch_size=8 gives 8 examples per data-parallel device, not divisible by "
                 "pp_microbatches=3; the pipeline needs equal microbatches on every device"),
    ("pipeline_unet", "ValueError: pipeline_parallelism=2 needs the DiT (task/model=dit)"),
    ("pipeline_accum", "ValueError: data.batch_size=8 gives 1 examples per accumulation micro-batch and "
                       "data-parallel device, not divisible by pp_microbatches=2"),
    ("pipeline_depth", "ValueError: model depth 3 not divisible by pipe axis 2"),
    ("indivisible_batch", "ValueError: data.batch_size=9 is not divisible by the mesh's data-axis size 2"),
    ("qkv_groups", "ValueError: model_parallelism=2 does not divide the 1 qkv head groups of 2 heads"),
    ("world_vs_tp", "ValueError: 2 devices not divisible by model_parallelism=3"),
])
def test_every_guard_raises_with_its_message(ranks, guard, message):
    for r in ranks:
        assert r["guards"][guard] is not None and r["guards"][guard].startswith(message), r["guards"][guard]
