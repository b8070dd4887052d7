"""The port's Trainer, built by ``build_task`` from the repo's configs on the
CPU, against a JAX loop of the JAX package's train and eval steps on the JAX
data module's batches, with JAX's parameters and draws carried across; and
its checkpoints, resume, NaN guard and preemption."""

import json

import numpy as np
import numpy.testing as npt
import pytest
import torch

import jax
import jax.numpy as jnp

from bsi_tpu.config import ConfigLoader as JaxConfigLoader
from bsi_tpu.data import SyntheticDataModule as JaxSynthetic
from bsi_tpu.tasks.task import build_algorithm as jax_build_algorithm
from bsi_tpu.tasks.task import build_ema as jax_build_ema
from bsi_tpu.tasks.task import build_model as jax_build_model
from bsi_tpu.tasks.task import build_optimizer as jax_build_optimizer
from bsi_tpu.train import TrainState as JaxTrainState
from bsi_tpu.train import make_eval_step as jax_make_eval_step
from bsi_tpu.train import make_train_step as jax_make_train_step

from bsi_torch.convert import _find_adam_state, params_to_jax, train_state_from_jax
from bsi_torch.train import make_eval_step, make_train_step

from test_torch_train import jax_noise
from test_torch_unet16 import jax_elbo_draws
from torch_tiny import tiny_config, tiny_trainer

STEPS = ["trainer.max_steps=3", "trainer.val_check_interval=3"]


def as_f64(data):
    """The data module with its arrays in f64, as the parity tests compute."""
    data._train, data._val, data._test = (a.astype(np.float64) for a in (data._train, data._val, data._test))
    return data


def jax_side(tmp_path, extra, model):
    """The JAX package's model, algorithm, optimizer, data and jitted steps
    for the same config, and a state with f64 parameters."""
    cfg = tiny_config(tmp_path, *extra, model=model, loader=JaxConfigLoader)
    task, trainer_cfg = cfg["task"], cfg["trainer"]
    data_cfg = {k: v for k, v in cfg["data"].items() if k not in ("_target_", "name")}
    data = as_f64(JaxSynthetic(seed=cfg["seed"], **data_cfg))
    shape = data.data_shape()
    model = jax_build_model(task["model"], shape)
    algo = jax_build_algorithm(task["algorithm"], shape, data.discretization())
    tx, _ = jax_build_optimizer(task["optimizer"], task.get("lr_scheduler"), trainer_cfg["max_steps"],
                                trainer_cfg["gradient_clip_val"])
    params = model.init(jax.random.key(1), jnp.zeros((2,) + shape), jnp.zeros((2,)))
    params = jax.tree.map(lambda a: a.astype(jnp.float64), params)
    state = JaxTrainState.create(params=params, opt_state=tx.init(params), rng=jax.random.key(cfg["seed"]))
    train_step = jax.jit(jax_make_train_step(algo, lambda p, mu, t, rng: model.apply(p, mu, t), tx,
                                             jax_build_ema(task["ema"])))
    eval_step = jax.jit(jax_make_eval_step(algo, lambda p, mu, t, rng: model.apply(p, mu, t)))
    return cfg, data, state, train_step, eval_step


def jax_validate(cfg, data, state, eval_step) -> dict:
    """``bsi_tpu``'s ``Trainer.validate`` over ``eval_step``: one key from
    ``0x5EED ^ seed``, split per batch, masked sums over each split."""
    rng = jax.random.key((0x5EED ^ cfg["seed"]) % 2**63)
    metrics = {}
    for name, split in data.eval_splits().items():
        sums = {}
        for batch, mask in data.eval_batches(split):
            rng, sub = jax.random.split(rng)
            for k, v in eval_step(state, jnp.asarray(batch), jnp.asarray(mask), sub).items():
                sums[k] = sums.get(k, 0.0) + float(v)
        prefix = "val" if name == "val" else "train"
        metrics[f"{prefix}/elbo"] = sums["elbo_sum"] / sums["count"]
        metrics[f"{prefix}/bpd"] = sums["bpd_sum"] / sums["count"]
        for k, v in sums.items():
            if k.startswith("part_sum/"):
                metrics[f"{prefix}/{k[len('part_sum/'):]}"] = v / sums["count"]
    return metrics


def jax_eval_noise(cfg):
    """The eval draws of ``jax_validate``, batch after batch."""
    rng = [jax.random.key((0x5EED ^ cfg["seed"]) % 2**63)]

    def noise(batch):
        rng[0], sub = jax.random.split(rng[0])
        return jax_elbo_draws(sub, tuple(batch.shape), 1, 1)

    return noise


def assert_params_close(got_tree, want_tree, *, model: str, lr_sum: float) -> None:
    got = dict(jax.tree_util.tree_leaves_with_path(got_tree))
    want = jax.tree_util.tree_leaves_with_path(want_tree)
    assert set(got) == {path for path, _ in want}
    for path, w in want:
        diff = got[path] - np.asarray(w)
        if model == "mlp":
            npt.assert_allclose(got[path], np.asarray(w), rtol=1e-10, atol=1e-12, err_msg=str(path))
            continue
        # the UNet: JAX takes the attention logits in f32 even at f64, and
        # Adam moves an element by up to lr wherever its gradient is rounding
        # noise; as test_torch_train.py::test_unet_trajectory_matches_jax holds
        # it: the key bias (no gradient at all) within Adam's bound, every
        # other leaf in root mean square within 1e-3 of the summed rates
        if jax.tree_util.keystr(path).endswith("['to_qkv']['bias']"):
            assert np.abs(diff[32:64]).max() <= 2 * lr_sum
            diff = np.concatenate([diff[:32], diff[64:]])
        assert np.sqrt(np.mean(diff**2)) <= 1e-3 * lr_sum, path


@pytest.mark.parametrize("model", ["mlp", "unet"])
def test_trainer_steps_and_validate_match_jax(tmp_path, model):
    # no dropout: the JAX package's masks cannot be drawn here
    extra = STEPS + (["task.model.dropout=0"] if model == "unet" else [])
    cfg, jax_data, jax_state, jax_step, jax_eval = jax_side(tmp_path, extra, model)
    key = jax_state.rng
    trainer = tiny_trainer(tmp_path, *extra, model=model)
    as_f64(trainer.data)
    trainer.state = train_state_from_jax(jax_state, generator=torch.Generator(), device="cpu")
    shape = trainer.data.data_shape()
    trainer._train_step = make_train_step(trainer.algorithm, trainer.train_apply, trainer.optimizer,
                                          trainer.ema_cfg, noise=jax_noise(key, shape))
    trainer.fit()
    batches = jax_data.train_batches()
    lr_sum = sum(trainer.optimizer.lr(count) for count in range(3))
    for _ in range(3):
        jax_state, _ = jax_step(jax_state, jnp.asarray(next(batches)))
    assert trainer.state.step == 3 and trainer.data.state_dict() == jax_data.state_dict()
    adam = _find_adam_state(jax_state.opt_state)
    assert trainer.state.opt_state.count == int(adam.count) == 3
    assert_params_close(params_to_jax(trainer.state.params), jax_state.params["params"], model=model,
                        lr_sum=lr_sum)
    assert_params_close(params_to_jax(trainer.state.ema_params), jax_state.ema_params["params"], model=model,
                        lr_sum=lr_sum)

    # validate() on JAX's state and draws against JAX's eval step
    trainer.state = train_state_from_jax(jax_state, generator=torch.Generator(), device="cpu")
    trainer._eval_step = make_eval_step(trainer.algorithm, trainer.eval_apply, noise=jax_eval_noise(cfg))
    got = trainer.validate()
    want = jax_validate(cfg, jax_data, jax_state, jax_eval)
    assert set(got) == set(want) and {"val/bpd", "train/bpd", "val/l_recon", "train/l_measure"} <= set(got)
    for name, value in want.items():
        npt.assert_allclose(got[name], value, rtol=1e-10 if model == "mlp" else 1e-6, err_msg=name)

    # the log: train/lr and steps/s at every step, the validation after step 3
    records = [json.loads(line) for line in (trainer.run_dir / "metrics.jsonl").read_text().splitlines()]
    train_logs = [r for r in records if "train/loss" in r]
    assert [r["step"] for r in train_logs] == [1, 2, 3]
    npt.assert_allclose([r["train/lr"] for r in train_logs], [trainer.optimizer.lr(c) for c in range(3)])
    assert all(r["train/steps_per_sec"] > 0 for r in train_logs)
    assert any("val/bpd" in r and r["step"] == 3 for r in records)


def test_validate_is_repeatable_and_checkpoints_round_trip_bit_for_bit(tmp_path):
    trainer = tiny_trainer(tmp_path, *STEPS)
    trainer.fit()
    assert trainer.validate() == trainer.validate()
    assert np.isfinite(trainer.best_bpd)
    path = trainer.save("manual")
    meta = json.loads((path / "meta.json").read_text())
    assert meta["config"]["seed"] == 5 and meta["data_state"] == trainer.data.state_dict()
    assert meta["extra"]["best_bpd"] == trainer.best_bpd
    other = tiny_trainer(tmp_path, *STEPS, name="other")
    other.restore(path)
    assert_states_equal(other, trainer)
    # best_bpd survives a restore from ckpt_best, which fit() wrote
    best = tiny_trainer(tmp_path, *STEPS, name="best")
    best.restore(trainer.run_dir / "ckpt_best")
    assert best.best_bpd == trainer.best_bpd


def assert_states_equal(a, b) -> None:
    sa, sb = a.state, b.state
    assert (sa.step, sa.opt_state.count, sa.dropout_seed) == (sb.step, sb.opt_state.count, sb.dropout_seed)
    for da, db in ((sa.params, sb.params), (sa.ema_params, sb.ema_params), (sa.opt_state.mu, sb.opt_state.mu),
                   (sa.opt_state.nu, sb.opt_state.nu)):
        assert list(da) == list(db)
        for name in da:
            assert torch.equal(da[name], db[name]), name
    assert torch.equal(sa.generator.get_state(), sb.generator.get_state())
    assert a.data.state_dict() == b.data.state_dict()
    assert a.best_bpd == b.best_bpd


def test_resume_replays_the_straight_run_bit_for_bit(tmp_path):
    # dropout 0.1 (the UNet config's): the masks of steps 3 and 4 must replay
    common = ["trainer.val_check_interval=2"]
    straight = tiny_trainer(tmp_path, *common, "trainer.max_steps=4", name="straight")
    straight.fit()
    first = tiny_trainer(tmp_path, *common, "trainer.max_steps=2", name="first")
    first.fit()
    resumed = tiny_trainer(tmp_path, *common, "trainer.max_steps=4", name="resumed")
    resumed.fit(from_checkpoint=str(first.run_dir / "ckpt_last"))
    assert resumed.state.step == 4
    assert_states_equal(resumed, straight)
    assert not torch.equal(straight.state.params["decode.weight"], first.state.params["decode.weight"])


def test_nan_guard_writes_ckpt_nan(tmp_path):
    trainer = tiny_trainer(tmp_path, "trainer.max_steps=2")
    trainer.state = trainer.init_state()
    with torch.no_grad():
        trainer.state.params["decode.bias"].fill_(float("nan"))
    with pytest.raises(FloatingPointError, match="ckpt_nan"):
        trainer.fit()
    meta = json.loads((trainer.run_dir / "ckpt_nan" / "meta.json").read_text())
    assert meta["config"]["seed"] == 5
    assert (trainer.run_dir / "ckpt_nan" / "state.pt").exists()


def test_preemption_writes_ckpt_interrupt_and_stops(tmp_path):
    class Triggered:
        triggered = True

    trainer = tiny_trainer(tmp_path, "trainer.max_steps=5", preemption=Triggered())
    metrics = trainer.fit()
    assert metrics["preempted"] is True and trainer.state.step == 1
    resumed = tiny_trainer(tmp_path, "trainer.max_steps=5", name="resumed")
    resumed.restore(trainer.run_dir / "ckpt_interrupt")
    assert resumed.state.step == 1 and resumed.data.state_dict() == trainer.data.state_dict()
    assert not (trainer.run_dir / "ckpt_last").exists()


def test_accumulation_through_the_trainer(tmp_path):
    trainer = tiny_trainer(tmp_path, "trainer.max_steps=2", "trainer.accumulate_grad_batches=2")
    metrics = trainer.fit()
    assert trainer.state.step == 2 and trainer.state.opt_state.count == 2
    # two optimizer steps of 4 images each: 8 images drawn from the stream
    assert trainer.data.stream.pos == 8 and np.isfinite(metrics["train/loss"])
    with pytest.raises(ValueError, match="divisible"):
        tiny_trainer(tmp_path, "trainer.accumulate_grad_batches=3")


def test_build_task_refuses_what_is_not_ported(tmp_path, monkeypatch):
    # every layout is ported (tests/test_torch_parallel_*.py,
    # tests/test_torch_pipeline.py); in one process without a group their
    # guards speak, as the JAX package's do on one device
    for extra, message in ((["trainer.pipeline_parallelism=2"],
                            "1 devices not divisible by model_parallelism=1 x pipeline_parallelism=2"),
                           (["trainer.model_parallelism=2"], "1 devices not divisible by model_parallelism=2"),
                           (["trainer.dcn_data_parallelism=2"], "dcn_data_parallelism=2"),
                           (["trainer.sequence_parallel=yes"], "requires model_parallelism > 1")):
        with pytest.raises(ValueError, match=message):
            tiny_trainer(tmp_path, *extra)
    # FSDP over one process holds the whole state, as JAX's over one device
    trainer = tiny_trainer(tmp_path, "trainer.fsdp=yes", "trainer.max_steps=1")
    assert trainer.layout is None and np.isfinite(trainer.fit()["train/loss"])
    # validation FID is ported (tests/test_torch_fid_trainer.py): statistics
    # without Inception weights give no FID, as in the JAX package
    from bsi_torch.metrics import FeatureStats, fid_stats_path

    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("BSI_TPU_INCEPTION_WEIGHTS", raising=False)
    stats = FeatureStats(2048)
    stats.update(np.random.default_rng(0).normal(size=(4, 2048)))
    stats.save_npz(fid_stats_path(tmp_path, "synthetic", "val"))
    assert tiny_trainer(tmp_path, f"trainer.fid_stats_root={tmp_path}").fid_metrics == {}
    assert tiny_trainer(tmp_path, f"trainer.fid_stats_root={tmp_path}", "trainer.fid=no").fid_metrics == {}
    # no statistics: no FID, as in the JAX package
    assert tiny_trainer(tmp_path, f"trainer.fid_stats_root={tmp_path / 'elsewhere'}").fid_metrics == {}


def test_bf16_precision_trains_a_bf16_model_on_f32_parameters(tmp_path):
    trainer = tiny_trainer(tmp_path, "trainer.max_steps=1", "trainer.precision=bf16")
    assert trainer.model is not trainer.eval_model
    metrics = trainer.fit()
    assert np.isfinite(metrics["train/loss"]) and np.isfinite(metrics["val/bpd"])
    assert all(p.dtype == torch.float32 for p in trainer.state.params.values())
    mu, t = torch.zeros((2, 4, 4, 3)), torch.full((2,), 0.5)
    assert trainer.train_apply(trainer.state.params, mu, t).dtype == torch.bfloat16
    assert trainer.eval_apply(trainer.state.params, mu, t).dtype == torch.float32


def test_step_window_profiler_writes_a_chrome_trace(tmp_path):
    from bsi_torch.utils.profiling import StepWindowProfiler

    profiler = StepWindowProfiler(tmp_path / "profile", start_step=1, num_steps=2)
    for step in range(5):
        torch.ones(8).sum()
        profiler.on_step(step)
    trace = json.loads((tmp_path / "profile" / "trace.json").read_text())
    assert trace["traceEvents"]
    profiler.on_step(6)
    profiler.close()  # nothing left to write


@pytest.mark.parametrize("shape", [(5, 7, 3), (4, 6, 1), (3, 3, 4), (2, 9)])
def test_plots_png_writer_round_trips_through_pil(shape):
    import io

    from PIL import Image

    from bsi_torch.tasks.plots import png_bytes

    array = np.random.default_rng(0).integers(0, 256, shape).astype(np.uint8)
    decoded = np.asarray(Image.open(io.BytesIO(png_bytes(array))))
    npt.assert_array_equal(decoded, array[..., 0] if shape[-1] == 1 else array)


@pytest.mark.parametrize("shape", [(5, 7, 3), (4, 6, 1), (3, 3, 4), (2, 9)])
def test_plots_png_reader_inverts_the_writer(shape, tmp_path):
    from bsi_torch.tasks.plots import png_bytes, read_png, save_png

    array = np.random.default_rng(1).integers(0, 256, shape).astype(np.uint8)
    save_png(tmp_path / "a.png", array)
    npt.assert_array_equal(read_png(tmp_path / "a.png"), array.reshape(*shape[:2], -1))
    # one flipped bit of the pixel data fails its chunk's CRC
    data = bytearray(png_bytes(array))
    data[45] ^= 1
    (tmp_path / "b.png").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        read_png(tmp_path / "b.png")


def test_a_short_run_profiles_its_last_steps(tmp_path):
    # trainer.profile_steps traces from step 10, or, in a run too short for
    # that, its last steps
    trainer = tiny_trainer(tmp_path, "trainer.max_steps=2", "trainer.profile_steps=1")
    assert trainer.profiler.start_step == 0 and trainer.profiler.end_step == 1
    trainer.fit()
    assert trainer.profiler.trace_path.is_file()
    assert tiny_trainer(tmp_path, "trainer.max_steps=100", "trainer.profile_steps=5").profiler.start_step == 10
