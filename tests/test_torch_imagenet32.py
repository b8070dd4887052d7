"""The slice as a whole on the CPU: the imagenet32 recipe
(``experiment=imagenet32``) through the port's config, data module,
``build_task`` and Trainer, for each task of the recipe's sweep (BSI, VDM,
BFN), at a narrow DiT (depth 2, dim 128, 2 heads of 64, patch 2 on 32x32:
256 tokens) on shards in the official format; against the JAX package's
model, algorithm, optimizer, data module and jitted train and eval steps on
the same weights (``ada_out`` filled), batch and draws. The first train
step's loss and the validation's bpd after it agree within 1e-8 relative
(f64 on both sides; measured ~1e-11); and the recipe's sweep runs every
task through ``python -m bsi_torch.train -m``."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from bsi_tpu.config import ConfigLoader as JaxConfigLoader
from bsi_tpu.data import ImageNetDataModule as JaxImageNet
from bsi_tpu.tasks.task import build_algorithm as jax_build_algorithm
from bsi_tpu.tasks.task import build_ema as jax_build_ema
from bsi_tpu.tasks.task import build_model as jax_build_model
from bsi_tpu.tasks.task import build_optimizer as jax_build_optimizer
from bsi_tpu.train import TrainState as JaxTrainState
from bsi_tpu.train import make_eval_step as jax_make_eval_step
from bsi_tpu.train import make_train_step as jax_make_train_step

from bsi_torch.config import ConfigLoader, instantiate
from bsi_torch.convert import train_state_from_jax
from bsi_torch.core import BFN, BSI, VDM
from bsi_torch.data import ImageNetDataModule
from bsi_torch.data.imagenet import write_synthetic_shards
from bsi_torch.tasks import build_task
from bsi_torch.train import make_eval_step, make_train_step

from test_torch_dit import fill_ada_out
from test_torch_train import jax_noise
from test_torch_trainer import jax_eval_noise, jax_validate
from torch_tiny import CONFIGS

NARROW = ["task.model.dim=128", "task.model.depth=2", "task.model.heads=2"]


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("imagenet32")
    write_synthetic_shards(root, 32, 400, 16, seed=3)
    return root


def overrides(root, run_root, task, *extra):
    return ["experiment=imagenet32", f"task={task}", f"data.root={root}", *NARROW, "task.model.dropout=0",
            "data.batch_size=8", "data.eval_batch_size=16", "+data.train_eval_size=16", "trainer.max_steps=1",
            "trainer.val_check_interval=1", "trainer.plots=no", "trainer.num_sanity_val_steps=0", "seed=5",
            "+trainer.device=cpu", f"run_root={run_root}", *extra]


def normalized_f64(data):
    """The module's uint8 images normalized (as on gather) and held in f64,
    as the parity tests compute."""
    data._train, data._val, data._test = (data._prepare(a).astype(np.float64)
                                          for a in (data._train, data._val, data._test))
    return data


@pytest.mark.parametrize("task,cls", [("bsi", BSI), ("vdm", VDM), ("bfn", BFN)])
def test_first_step_and_validation_match_jax(shards, tmp_path, task, cls):
    ov = overrides(shards, tmp_path, task)
    cfg = JaxConfigLoader(CONFIGS).load("train", ov)
    config = ConfigLoader(CONFIGS).load("train", ov)
    seed = config["seed"]

    # the JAX side: the recipe's model, algorithm and optimizer; f64
    # parameters with ada_out filled
    data_kw = {k: v for k, v in cfg["data"].items() if k not in ("_target_", "name")}
    jax_data = normalized_f64(JaxImageNet(seed=seed, **data_kw))
    shape = jax_data.data_shape()
    model = jax_build_model(cfg["task"]["model"], shape)
    algo = jax_build_algorithm(cfg["task"]["algorithm"], shape, jax_data.discretization())
    tx, _ = jax_build_optimizer(cfg["task"]["optimizer"], cfg["task"].get("lr_scheduler"),
                                cfg["trainer"]["max_steps"], cfg["trainer"]["gradient_clip_val"])
    params = model.init(jax.random.key(1), jnp.zeros((2,) + shape), jnp.zeros((2,)))
    params = jax.tree.map(lambda a: a.astype(jnp.float64), fill_ada_out(params, 2))
    state = JaxTrainState.create(params=params, opt_state=tx.init(params), rng=jax.random.key(seed))
    apply = lambda p, mu, t, rng: model.apply(p, mu, t)
    jax_step = jax.jit(jax_make_train_step(algo, apply, tx, jax_build_ema(cfg["task"]["ema"])))
    jax_eval = jax.jit(jax_make_eval_step(algo, apply))

    # the port: the entry point's data module and build_task, on JAX's state
    # and draws
    data = instantiate(config["data"], seed=seed)
    assert isinstance(data, ImageNetDataModule) and data.data_shape() == (32, 32, 3)
    trainer = build_task(config, normalized_f64(data), run_dir=tmp_path / "run", seed=seed, device="cpu")
    assert isinstance(trainer.algorithm, cls) and trainer.algorithm.data_shape == (32, 32, 3)
    named = dict(trainer.model.named_parameters())
    assert (named["dit.block_0.attn.to_qkv.weight"].shape, len([n for n in named if n.endswith("ada_out.weight")])) \
        == ((384, 128), 2)
    trainer.state = train_state_from_jax(state, generator=torch.Generator(), device="cpu")
    trainer._train_step = make_train_step(trainer.algorithm, trainer.train_apply, trainer.optimizer,
                                          trainer.ema_cfg, noise=jax_noise(state.rng, shape))
    trainer._eval_step = make_eval_step(trainer.algorithm, trainer.eval_apply, noise=jax_eval_noise(cfg))
    metrics = trainer.fit()

    state, jax_metrics = jax_step(state, jnp.asarray(next(jax_data.train_batches())))
    want = jax_validate(cfg, jax_data, state, jax_eval)
    npt.assert_allclose(metrics["train/loss"], float(jax_metrics["train/loss"]), rtol=1e-8)
    assert set(want) <= set(metrics)
    for name in ("val/bpd", "train/bpd", "val/elbo"):
        npt.assert_allclose(metrics[name], want[name], rtol=1e-8, err_msg=name)
    parts = {"bsi": "l_measure", "vdm": "l_diff", "bfn": "l_latent"}[task]
    npt.assert_allclose(metrics[f"val/{parts}"], want[f"val/{parts}"], rtol=1e-8)


def test_the_recipe_sweep_runs_every_task(shards, tmp_path, capfd):
    # the recipe's sweep: 3 seeds x (vdm, bfn, bsi), each a one-step fit
    from bsi_torch.train.__main__ import main

    extra = ["task.model.dim=64", "task.model.heads=1", "task.model.depth=1", "data.batch_size=4",
             "data.eval_batch_size=4", "+data.train_eval_size=4", "trainer.max_steps=1", "trainer.plots=no",
             "trainer.num_sanity_val_steps=0", "trainer.limit_eval_batches=1", "eval_testset=no",
             "+trainer.device=cpu", f"data.root={shards}", f"run_root={tmp_path}"]
    assert main(["-m", "experiment=imagenet32", *extra]) == 0
    out = capfd.readouterr().out
    assert "=== run 9/9" in out and out.strip().splitlines()[-1].startswith("best val/bpd: ")
    runs = sorted((tmp_path / "bsi-imagenet32").iterdir())
    assert len(runs) == 9
    tasks = sorted(json.loads((run / "config.json").read_text())["task"]["name"] for run in runs)
    assert tasks == ["bfn"] * 3 + ["bsi"] * 3 + ["vdm"] * 3


def test_imagenet64_trains_through_the_entry_point_from_the_lazy_source(tmp_path, capfd):
    # DiT-L/4's recipe (patch 4 on 64x64: 256 tokens again), preload: no
    from bsi_torch.train.__main__ import main

    write_synthetic_shards(tmp_path / "data", 64, 200, 8, seed=4)
    args = ["experiment=imagenet64", "task=bsi", "task.model.dim=64", "task.model.heads=1", "task.model.depth=1",
            "data.batch_size=4", "data.eval_batch_size=4", "+data.train_eval_size=4", "trainer.max_steps=2",
            "trainer.accumulate_grad_batches=2", "trainer.log_every_n_steps=1", "trainer.plots=no",
            "trainer.limit_eval_batches=1", "+trainer.device=cpu", "seed=3", f"data.root={tmp_path / 'data'}",
            f"run_root={tmp_path / 'runs'}"]
    assert main(args) == 0
    (run,) = (tmp_path / "runs" / "bsi-imagenet64").iterdir()
    config = json.loads((run / "config.json").read_text())
    assert config["data"]["preload"] is False and config["task"]["model"]["patch_size"] == 4
    records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    bpds = [r[k] for r in records for k in ("val/bpd", "test/bpd") if k in r]
    assert len(losses) == 2 and len(bpds) == 3 and np.isfinite(losses + bpds).all()
    assert (tmp_path / "data" / "imagenet64-train.npy").exists() and "best val/bpd" in capfd.readouterr().out
