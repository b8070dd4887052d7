"""Validation FID in the port's trainer, on the CPU with a stub embedder:
``build_task`` finds the statistics and the (stubbed) weights, ``validate``
logs ``val/fid-6`` over one sample per real example drawn from the eval
generator after each batch's eval step, resets the accumulator, and gives
the same bits at every call."""

import math
from pathlib import Path

import numpy as np
import pytest
import torch

import bsi_torch.metrics.inception as PI
from bsi_torch.metrics import FeatureStats, fid_from_stats, fid_stats_path, images_to_uint8
from bsi_torch.train.loop import EVAL_SEED
from torch_tiny import tiny_trainer


def stub_embed(imgs):
    x = torch.as_tensor(np.asarray(imgs), dtype=torch.float64) / 255.0
    return torch.cat([x.mean(dim=(1, 2)), x.std(dim=(1, 2))], dim=1)


@pytest.fixture
def trainer(tmp_path, monkeypatch):
    monkeypatch.setattr(PI, "default_weights_path", lambda: Path("stub.pth"))
    monkeypatch.setattr(PI, "load_params", lambda path: {})
    monkeypatch.setattr(PI, "make_embed_fn", lambda params, device=None: stub_embed)
    real = FeatureStats(6)
    real.update(stub_embed(np.random.default_rng(0).integers(0, 256, size=(32, 4, 4, 3), dtype=np.uint8)))
    real.save_npz(fid_stats_path(tmp_path, "synthetic", "val"))
    trainer = tiny_trainer(tmp_path, f"trainer.fid_stats_root={tmp_path}")
    trainer.state = trainer.init_state()
    return trainer


def test_validate_logs_fid_over_the_eval_generator_samples(trainer):
    assert set(trainer.fid_metrics) == {"val"}
    metrics = trainer.validate()
    fid = metrics["val/fid-6"]
    assert math.isfinite(fid) and fid >= -1e-6
    assert not any(key.startswith("train/fid") for key in metrics)
    # the accumulator is reset after the distance
    assert trainer.fid_metrics["val"].fake_stats.n == 0

    # the same distance over the samples the eval generator draws after each
    # val batch's eval step: 6 real examples in batches of 4 (2 masked)
    generator = torch.Generator().manual_seed((EVAL_SEED ^ trainer.seed) % 2**63)
    fake = FeatureStats(6)
    for batch, mask in trainer.data.eval_batches(trainer.data.eval_splits()["val"]):
        trainer._eval_step(trainer.state, torch.as_tensor(batch), torch.as_tensor(mask), generator)
        samples = trainer.sample_fn(trainer.state, generator, len(batch))
        unit = trainer.data.discretization().to_unit_interval(samples).numpy()
        fake.update(stub_embed(images_to_uint8(unit[np.asarray(mask, bool)])))
    assert fake.n == 6
    assert fid == fid_from_stats(fake, trainer.fid_metrics["val"].real_stats)


def test_validate_is_bit_identical_across_calls(trainer):
    first, second = trainer.validate(), trainer.validate()
    assert first == second and "val/fid-6" in first


def test_test_stage_and_fid_off(trainer, tmp_path):
    real = trainer.fid_metrics["val"].real_stats
    real.save_npz(fid_stats_path(tmp_path, "synthetic", "test"))
    trainer = tiny_trainer(tmp_path, f"trainer.fid_stats_root={tmp_path}", name="test")
    trainer.state = trainer.init_state()
    assert set(trainer.fid_metrics) == {"val", "test"}
    metrics = trainer.test()
    assert math.isfinite(metrics["test/fid-6"]) and "val/fid-6" not in metrics
    off = tiny_trainer(tmp_path, f"trainer.fid_stats_root={tmp_path}", "trainer.fid=no", name="off")
    assert off.fid_metrics == {}
