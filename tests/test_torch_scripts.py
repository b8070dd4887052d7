"""The port's eval scripts (``python -m bsi_torch.scripts.<name>``) end to
end on the CPU, on a checkpoint of ``python -m bsi_torch.train`` (a small
MLP, 3 steps), and their output keys against the JAX scripts' own on a
checkpoint of the same config (``train.py``). FID runs with a stub embedder
except where a test says otherwise."""

import json
import math
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bsi_tpu.metrics as J
import bsi_tpu.metrics.inception as JI
import bsi_torch.metrics as P
import bsi_torch.metrics.inception as PI
from bsi_torch.scripts import (compute_fid_stats, eval_elbo, eval_fid, eval_overrides, generate_sample_history,
                               generate_samples, render_samples, sample_h_alpha)
from bsi_torch.tasks.plots import read_png

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "scripts"
# tests/test_scripts.py's checkpoint: the same config for both packages
TRAIN_ARGS = ["data=synthetic", "data.n_train=64", "data.n_val=16", "data.batch_size=16", "task.model=mlp",
              "task.algorithm.k=4", "task.ema.update_after_step=1", "trainer.max_steps=3",
              "trainer.val_check_interval=2", "trainer.log_every_n_steps=1", "trainer.limit_eval_batches=1",
              "trainer.plots=no", "seed=11"]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    from bsi_torch.train.__main__ import main

    tmp = tmp_path_factory.mktemp("torch_ckpt")
    assert main(TRAIN_ARGS + ["+trainer.device=cpu", f"run_root={tmp}/runs"]) == 0
    (ckpt,) = tmp.glob("runs/*/*/ckpt_last")
    return ckpt


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_ckpt")
    sys.path.insert(0, str(REPO))
    try:
        import train as train_cli
    finally:
        sys.path.remove(str(REPO))
    assert train_cli.main(TRAIN_ARGS + [f"run_root={tmp}/runs"]) == 0
    (ckpt,) = tmp.glob("runs/*/*/ckpt_last")
    return ckpt


def stub_embed(imgs):
    x = np.asarray(imgs, np.float64) / 255.0
    return np.concatenate([x.mean(axis=(1, 2)), x.std(axis=(1, 2))], axis=1)


def wide_stub_embed(imgs):
    """The stub at the Inception's width, for the scripts that size their
    statistics 2048-d."""
    return np.tile(stub_embed(imgs), 342)[:, :2048]


@pytest.fixture
def stubbed(monkeypatch):
    """The stub in place of the InceptionV3 in both packages, where each
    script and the trainers look for it."""
    for module in (eval_fid, generate_samples, compute_fid_stats, PI, J, JI):
        monkeypatch.setattr(module, "default_weights_path", lambda: Path("stub"))
        monkeypatch.setattr(module, "load_params", lambda path: {})
        monkeypatch.setattr(module, "make_embed_fn", lambda params, device=None: stub_embed)


def stub_stats(root, data, splits=("train", "test")):
    """Stub-embedder statistics of the data module's own splits."""
    arrays = dict(data.eval_splits(), test=data.test_splits()["test"])
    out = {}
    for split in splits:
        stats = P.FeatureStats(6)
        stats.update(stub_embed(P.images_to_uint8((np.asarray(arrays[split]) + 1) / 2)))
        stats.save_npz(P.fid_stats_path(root, data.short_name(), split))
        out[split] = stats
    return out


def run_jax(name: str, argv: list[str], monkeypatch):
    monkeypatch.syspath_prepend(str(SCRIPTS))
    monkeypatch.setattr(sys, "argv", [name] + argv)
    runpy.run_path(str(SCRIPTS / f"{name}.py"), run_name="__main__")


# ----------------------------------------------------------- each script


def test_eval_elbo(checkpoint, tmp_path):
    out = tmp_path / "elbo.json"
    assert eval_elbo.main(["-c", str(checkpoint), "-o", str(out), "-k", "inf", "4", "--split", "val", "-r", "2",
                           "-m", "2", "data.eval_batch_size=16"]) == 0
    results = json.loads(out.read_text())
    assert set(results["bpd_means"]) == {"inf", "4"}
    for k in ("inf", "4"):
        assert math.isfinite(results["bpd_means"][k]) and results["bpd_mean_vars"][k] > 0


def test_generate_samples_with_the_inception_and_render(checkpoint, tmp_path, monkeypatch):
    """The real network at random weights, from a ``.pth`` the weights
    variable names: the embeddings' sums and the FID against both splits."""
    weights = tmp_path / "pt_inception-random.pth"
    torch.save(P.random_params(0), weights)
    monkeypatch.setenv("BSI_TPU_INCEPTION_WEIGHTS", str(weights))
    embed = P.make_embed_fn(P.load_params(weights), device="cpu")
    rng = np.random.default_rng(0)
    for split in ("train", "test"):
        stats = P.FeatureStats(2048)
        stats.update(embed(rng.integers(0, 256, size=(4, 8, 8, 3), dtype=np.uint8)))
        stats.save_npz(P.fid_stats_path(tmp_path, "synthetic", split))

    out = tmp_path / "samples.npz"
    assert generate_samples.main(["-c", str(checkpoint), "-o", str(out), "-n", "12", "-k", "4", "--fid-stats-root",
                                  str(tmp_path), "data.eval_batch_size=8"]) == 0
    with np.load(out) as z:
        assert z["samples"].shape == (12, 8, 8, 3) and np.isfinite(z["samples"]).all()
        assert int(z["k"]) == 4 and str(z["schedule"]) == "linear" and bool(z["ema"])
        assert int(z["embedding_n"]) == 12 and z["embedding_cov_sum"].shape == (2048, 2048)
        assert math.isfinite(float(z["fid_train"])) and math.isfinite(float(z["fid_test"]))
        want = P.FeatureStats(2048)
        want.update(embed(P.images_to_uint8((z["samples"] + 1) / 2)))
        np.testing.assert_allclose(z["embedding_sum"], want.sum, rtol=1e-12)
        samples = z["samples"]

    png = tmp_path / "grid.png"
    assert render_samples.main([str(out), str(png), "--cols", "4"]) == 0
    grid = read_png(png)
    assert grid.shape == (3 * 8, 4 * 8, 3)
    first = np.clip((samples[0] + 1) / 2 * 255, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(grid[:8, :8], first)


def test_generate_sample_history(checkpoint, tmp_path):
    out = tmp_path / "hist.npz"
    assert generate_sample_history.main(["-c", str(checkpoint), "-o", str(out), "-n", "3", "-k", "4"]) == 0
    with np.load(out) as z:
        assert z["mus"].shape == z["x_hats"].shape == (5, 3, 8, 8, 3)
        assert z["ys"].shape == (4, 3, 8, 8, 3)
        assert {z[k].dtype for k in z.files} == {np.dtype(np.uint8)}


def test_sample_h_alpha(checkpoint, tmp_path):
    out = tmp_path / "h_alpha.npz"
    assert sample_h_alpha.main(["-c", str(checkpoint), "-o", str(out), "-n", "16", "--split", "val",
                                "data.eval_batch_size=16"]) == 0
    with np.load(out) as z:
        assert z["lambda"].shape == (16,) and np.all(np.diff(z["lambda"]) > 0)
        errs = z["squared_error_samples_bpd"]
        assert errs.shape == (16, 16) and np.isfinite(errs).all()


def test_eval_overrides_with_validation_fid(checkpoint, tmp_path, stubbed):
    from bsi_torch.scripts._common import load_trainer

    _, _, data = load_trainer(str(checkpoint), [])
    stub_stats(tmp_path, data)
    out = tmp_path / "metrics.json"
    assert eval_overrides.main(["-c", str(checkpoint), "-o", str(out), "trainer.limit_eval_batches=1",
                                f"trainer.fid_stats_root={tmp_path}"]) == 0
    metrics = json.loads(out.read_text())
    for key in ("test/bpd", "test/fid-6", "train/fid-6"):
        assert math.isfinite(metrics[key]), key


def test_eval_fid_requires_weights(checkpoint, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("BSI_TPU_INCEPTION_WEIGHTS", raising=False)
    with pytest.raises(SystemExit, match="Inception weights"):
        eval_fid.main(["-c", str(checkpoint), "-o", str(tmp_path / "fid.json"), "-k", "4"])


def test_eval_fid_sweep(checkpoint, tmp_path, stubbed):
    """Checkpoint -> schedule sweep -> samples -> embeddings -> statistics ->
    the FID against train and test -> JSON, for two schedules."""
    from bsi_torch.scripts._common import load_trainer

    _, _, data = load_trainer(str(checkpoint), [])
    split_stats = stub_stats(tmp_path, data)
    model_fids = []
    for sched in ("linear", "cosine"):
        out = tmp_path / f"fid_{sched}.json"
        assert eval_fid.main(["-c", str(checkpoint), "-o", str(out), "-k", "2", "4", "-s", sched, "-n", "16",
                              "--fid-stats-root", str(tmp_path), "--inception-weights", "stubbed", "--batch-size",
                              "16", "data.eval_batch_size=16"]) == 0
        res = json.loads(out.read_text())
        assert res["config"] == {"n": 16, "k": [2, 4], "schedule": sched, "overrides": ["data.eval_batch_size=16"]}
        assert set(res["fid"]) == {"2", "4"}
        for by_split in res["fid"].values():
            assert set(by_split) == {"train", "test"}
            for v in by_split.values():
                assert math.isfinite(v) and v > -1e-6  # a squared distance
                model_fids.append(v)
    # the real distribution against itself scores far better than the
    # 3-step model: the metric discriminates
    real_vs_real = P.fid_from_stats(split_stats["test"], split_stats["train"])
    assert real_vs_real < 0.5 * min(model_fids), (real_vs_real, min(model_fids))


def test_compute_fid_stats_matches_jax(tmp_path, stubbed, monkeypatch):
    """``train`` covers the training set and its validation split; the stub's
    statistics of the port's synthetic data are the JAX script's bits."""
    for module in (compute_fid_stats, J):
        monkeypatch.setattr(module, "make_embed_fn", lambda params, device=None: wide_stub_embed)
    sizes = {"train": 512 + 128, "val": 128, "test": 128}
    for split, n in sizes.items():
        assert compute_fid_stats.main(["synthetic", split, "--out-root", str(tmp_path / "torch"),
                                       "--batch-size", "200"]) == 0
        stats = P.FeatureStats.from_npz(P.fid_stats_path(tmp_path / "torch", "synthetic", split))
        assert stats.n == n
    run_jax("compute_fid_stats", ["synthetic", "train", "--out-root", str(tmp_path / "jax"), "--batch-size", "200"],
            monkeypatch)
    ours = np.load(P.fid_stats_path(tmp_path / "torch", "synthetic", "train"))
    theirs = np.load(J.fid_stats_path(tmp_path / "jax", "synthetic", "train"))
    assert sorted(ours.files) == sorted(theirs.files) == ["cov_sum", "n", "sum"]
    for key in ours.files:
        np.testing.assert_array_equal(ours[key], theirs[key])


def test_module_entry_point(checkpoint, tmp_path):
    out = tmp_path / "elbo.json"
    proc = subprocess.run([sys.executable, "-m", "bsi_torch.scripts.eval_elbo", "-c", str(checkpoint), "-o", str(out),
                           "--split", "val", "data.eval_batch_size=16"], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "k=inf: bpd" in proc.stdout and set(json.loads(out.read_text())["bpd_means"]) == {"inf"}


# ------------------------------------------- output keys against the JAX scripts


def _keys(path: Path):
    """The output's keys: a JSON's nested keys, or an .npz's arrays with
    their ranks and dtype kinds."""
    if path.suffix == ".json":
        def walk(node):
            return {k: walk(v) for k, v in node.items()} if isinstance(node, dict) else type(node).__name__
        return walk(json.loads(path.read_text()))
    with np.load(path) as z:
        return {k: (z[k].ndim, z[k].dtype.kind) for k in z.files}


def _both(name, argv, checkpoint, jax_checkpoint, tmp_path, monkeypatch, suffix):
    """Runs the port's script and the JAX one with the same arguments on their
    checkpoints; returns each output's keys."""
    ours, theirs = tmp_path / f"torch{suffix}", tmp_path / f"jax{suffix}"
    module = sys.modules[f"bsi_torch.scripts.{name}"]
    assert module.main(["-c", str(checkpoint), "-o", str(ours), *argv]) == 0
    run_jax(name, ["-c", str(jax_checkpoint), "-o", str(theirs), *argv], monkeypatch)
    return _keys(ours), _keys(theirs)


CASES = {
    "eval_elbo": (["-k", "inf", "4", "--split", "val", "data.eval_batch_size=16"], ".json"),
    "eval_fid": (["-k", "2", "-n", "16", "--batch-size", "16", "--inception-weights", "stubbed",
                  "data.eval_batch_size=16"], ".json"),
    "generate_samples": (["-n", "12", "-k", "4", "data.eval_batch_size=8"], ".npz"),
    "generate_sample_history": (["-n", "3", "-k", "4"], ".npz"),
    "sample_h_alpha": (["-n", "8", "--split", "val", "data.eval_batch_size=16"], ".npz"),
    "eval_overrides": (["trainer.limit_eval_batches=1"], ".json"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_output_keys_match_the_jax_scripts(name, checkpoint, jax_checkpoint, tmp_path, stubbed, monkeypatch):
    from bsi_torch.scripts._common import load_trainer

    argv, suffix = CASES[name]
    _, _, data = load_trainer(str(checkpoint), [])
    stub_stats(tmp_path, data, ("train", "test", "val"))
    root = {"eval_fid": ["--fid-stats-root", str(tmp_path)],
            "eval_overrides": [f"trainer.fid_stats_root={tmp_path}"]}.get(name, [])
    if name == "generate_samples":
        # its embeddings' sums at the Inception's width (the FID against
        # statistics is tested with the real network above)
        for module in (generate_samples, J):
            monkeypatch.setattr(module, "make_embed_fn", lambda params, device=None: wide_stub_embed)
    ours, theirs = _both(name, argv + root, checkpoint, jax_checkpoint, tmp_path, monkeypatch, suffix)
    assert ours == theirs
    if name == "eval_overrides":
        assert "test/fid-6" in ours and "train/fid-6" in ours
    if name == "generate_samples":
        assert {"embedding_sum", "embedding_cov_sum", "embedding_n"} <= set(ours)
