"""The port's trainer on four gloo ranks (TP 2 x FSDP 2, with and without
sequence parallelism; FSDP over a data axis of 2 x 2 with
``dcn_data_parallelism=2``) against one process, the ``nn.Dropout`` masks across
the ranks of a TP 2 x DP 2 mesh with and without SP, and ``python -m bsi_torch.train``'s entry
point on two ranks joined from torchrun's variables, on the CPU, f64."""

import numpy as np
import numpy.testing as npt
import pytest

from torch_parallel_worker import launch


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    return launch(tmp_path_factory.mktemp("ranks4"), 4, "layouts4")


@pytest.fixture(scope="module")
def entry(tmp_path_factory):
    return launch(tmp_path_factory.mktemp("entry"), 2, "entry", env=True)


@pytest.mark.parametrize("layout", ["dit_tp_fsdp", "dit_tp_sp_fsdp", "unet_dcn_fsdp"])
def test_tp_x_fsdp_on_four_ranks_reproduces_one_process(ranks4, layout):
    first = ranks4[0]["layouts4"][layout]
    for r in ranks4[1:]:
        other = r["layouts4"][layout]["layout"]
        for key in ("loss", "grad_norm", "val_bpd", "val_fid", "param_sum"):
            npt.assert_allclose(other[key], first["layout"][key], rtol=1e-12, err_msg=key)
    got, want = first["layout"], first["base"]
    for key in ("loss", "grad_norm", "val_bpd", "param_sum"):
        npt.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)
    npt.assert_allclose(got["val_fid"], want["val_fid"], rtol=1e-6)
    assert first["worst_leaf"] < 1e-9
    # TP halves the pairs, FSDP halves again what is large enough; FSDP
    # over four data ranks quarters the UNet's leaves of 2**14 or more
    assert first["local_numel"] < {"unet_dcn_fsdp": 0.8}.get(layout, 0.4) * first["full_numel"]


def _masks(ranks4, layout):
    """(data rank, model rank) -> the first block's pre-MLP dropout mask."""
    out = {}
    for r in ranks4:
        d = r["layouts4"]["dropout_masks"]
        (m,) = d[layout]
        bits = np.unpackbits(np.frombuffer(bytes.fromhex(m["bits"]), np.uint8))
        out[d["data_rank"], d["model_rank"]] = bits[:int(np.prod(m["shape"]))].reshape(m["shape"]).astype(bool)
    return out


def test_dropout_masks_follow_the_data_rank(ranks4):
    masks = _masks(ranks4, "tp")
    assert set(masks) == {(0, 0), (0, 1), (1, 0), (1, 1)}
    # equal on the model ranks of one replica, different across replicas
    assert (masks[0, 0] == masks[0, 1]).all() and (masks[1, 0] == masks[1, 1]).all()
    assert not (masks[0, 0] == masks[1, 0]).all()
    assert 0.3 < masks[0, 0].mean() < 0.7  # rate 0.5


def test_dropout_masks_under_sp_are_the_token_shards_of_the_replicas(ranks4):
    """Under SP each model rank holds half the tokens: their masks differ,
    and side by side they are the mask the replica draws without SP."""
    tp, sp = _masks(ranks4, "tp"), _masks(ranks4, "tp_sp")
    for d in (0, 1):
        a, b = sp[d, 0], sp[d, 1]
        assert a.shape[1] * 2 == tp[d, 0].shape[1] and not (a == b).all()
        assert (np.concatenate([a, b], axis=1) == tp[d, 0]).all()
    assert not (sp[0, 0] == sp[1, 0]).all()


def test_entry_point_joins_the_group_from_the_environment(entry):
    a, b = (r["entry"] for r in entry)
    assert a["backend"] == b["backend"] == "gloo" and a["world"] == b["world"] == 2
    # one run directory (rank 0's stamp), one metrics file (rank 0 writes)
    assert a["runs"] == b["runs"] and len(a["runs"]) == 1
    assert a["metrics_files"] == b["metrics_files"] and len(a["metrics_files"]) == 1
    # seed=null: every rank took rank 0's draw
    assert a["seed"] == b["seed"]


def test_entry_point_resumes_under_tp_sp_fsdp(entry):
    a = entry[0]["entry"]
    assert len(a["val_bpd"]) == 1 and a["resumed_steps"] == [3] and len(a["resumed_val_bpd"]) == 1
