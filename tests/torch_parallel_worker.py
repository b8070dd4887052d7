"""One rank of the port's multi-process CPU tests (gloo), started by
``subprocess.Popen`` from the ``test_torch_parallel_*`` files:

    torch_parallel_worker.py <rendezvous> <rank> <world> <phases> <out_dir>

``<rendezvous>`` is a ``file://`` store path, or ``env:<port>``: then the
worker sets torchrun's variables and leaves the group to the entry point
(``bsi_torch.parallel.initialize_distributed``). ``<phases>`` is a comma
list of the functions below; each returns a JSON-able dict, and the rank
writes ``{phase: result}`` to ``<out_dir>/rank<r>.json``.

Every layout runs beside its one-process baseline in the same process (a
trainer on ``Mesh()``, which runs no collective), on a constant dataset as
``tests/_mp_worker.py`` uses: the global loss does not depend on which rank
reads which rows. Everything is f64. The worker imports torch and never JAX.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))

SHAPE = (8, 8, 3)
DIT = ["task/model=dit", "task.model.dim=64", "task.model.depth=2", "task.model.heads=2",
       "task.model.patch_size=2", "task.model.fourier_features.n_min=6", "task.model.fourier_features.n_max=7"]
UNET = ["task.model.dim=32", "task.model.levels=1", "task.model.dropout=null"]
TINY = ["data=synthetic", "data.data_shape=[8,8,3]", "data.batch_size=8", "data.eval_batch_size=8",
        "task.algorithm.k=3", "task.lr_scheduler.warmup_steps=2", "task.ema.update_after_step=1",
        "trainer.plots=no", "trainer.log_every_n_steps=1", "trainer.num_sanity_val_steps=0",
        "trainer.fid=no", "trainer.async_checkpointing=no", "seed=5", "+trainer.device=cpu"]


def _model_args(model: str, dropout=None) -> list[str]:
    if model == "dit":
        return DIT + [f"task.model.dropout={'null' if dropout is None else dropout}"]
    return UNET


class ListLogger:
    """A MetricLogger that keeps the records in memory."""

    def __init__(self):
        from bsi_torch.utils.logging import SilentLogger

        self._inner = SilentLogger()
        self._wandb = None
        self.records: list[dict] = []

    def log(self, step, metrics):
        self.records.append({"step": int(step), **{k: float(v) for k, v in metrics.items()}})

    def __getattr__(self, name):
        return getattr(self._inner, name)


def stub_embed(imgs):
    import numpy as np
    import torch

    x = torch.as_tensor(np.asarray(imgs), dtype=torch.float64) / 255.0
    return torch.cat([x.mean(dim=(1, 2)), x.std(dim=(1, 2))], dim=1)


def build(tmp: Path, model: str, *extra: str, dropout=None, mesh_less: bool = False, steps: int = 3,
          fid: bool = True):
    """A Trainer from ``build_task`` on the tiny config, a constant dataset
    sharded by this rank's data rank, and a stub FID on ``val``. With
    ``mesh_less`` the trainer runs as one process (no collective)."""
    import numpy as np
    import torch.distributed as dist

    from bsi_torch.config import ConfigLoader
    from bsi_torch.data import ArrayDataModule
    from bsi_torch.metrics import FeatureStats, FIDScore
    from bsi_torch.parallel import Mesh, host_shard
    from bsi_torch.tasks import build_task
    from torch_tiny import CONFIGS

    overrides = TINY + _model_args(model, dropout) + [f"trainer.max_steps={steps}", f"run_root={tmp}", *extra]
    if mesh_less:
        overrides = [o for o in overrides if not o.startswith(("trainer.model_parallelism", "trainer.fsdp",
                                                                 "trainer.sequence_parallel",
                                                                 "trainer.pipeline_parallelism",
                                                                 "trainer.pp_microbatches"))]
    config = ConfigLoader(CONFIGS).load("train", overrides)
    tp = int(config["trainer"].get("model_parallelism", 1))
    pp = int(config["trainer"].get("pipeline_parallelism", 1))
    shard_id, num_shards = (0, 1) if mesh_less else host_shard(tp, pp)
    value = 2 * (128 / 255) - 1  # an exact 8-bit bin centre
    data = ArrayDataModule(np.full((32,) + SHAPE, value), np.full((16,) + SHAPE, value),
                           batch_size=8, eval_batch_size=8, train_eval_size=8, seed=0, shard_id=shard_id,
                           num_shards=num_shards)
    import bsi_torch.tasks.task as task_module

    make_mesh = task_module.make_mesh
    if mesh_less:
        task_module.make_mesh = lambda **kw: Mesh()
    try:
        # a layout's ranks share one run directory, as under the entry point
        run_dir = tmp / (f"run{dist.get_rank()}" if mesh_less else "run")
        trainer = build_task(config, data, run_dir=run_dir, seed=config["seed"], device="cpu", logger=ListLogger())
    finally:
        task_module.make_mesh = make_mesh
    if fid:
        real = FeatureStats(6)
        real.update(stub_embed(np.random.default_rng(0).integers(0, 256, size=(32,) + SHAPE, dtype=np.uint8)))
        trainer.fid_metrics = {"val": FIDScore(stub_embed, real)}
    return trainer


def full_params(trainer) -> dict:
    return full_params_of(trainer, "params")


def summary(trainer) -> dict:
    """Losses, grad norms, the last validation and the full parameters' sum."""
    records = trainer.logger.records
    params = full_params(trainer)
    last = lambda key: ([r[key] for r in records if key in r] or [None])[-1]
    return {
        "loss": [r["train/loss"] for r in records if "train/loss" in r],
        "grad_norm": [r["train/grad_norm"] for r in records if "train/grad_norm" in r],
        "val_bpd": last("val/bpd"),
        "val_fid": last("val/fid-6"),
        "param_sum": float(sum(p.double().sum() for p in params.values())),
    }


def compare(layout_trainer, base_trainer) -> dict:
    """The layout's summary, the baseline's, and each leaf's distance to
    the baseline's relative to the baseline's norm (the largest)."""
    got, want = full_params(layout_trainer), full_params(base_trainer)
    worst = max(float((got[n] - want[n]).norm() / want[n].norm().clamp_min(1e-30)) for n in want)
    return {"layout": summary(layout_trainer), "base": summary(base_trainer), "worst_leaf": worst,
            "local_numel": sum(p.numel() for p in layout_trainer.state.params.values()),
            "full_numel": sum(p.numel() for p in want.values())}


def fit_pair(tmp: Path, model: str, *extra: str, dropout=None, steps: int = 3) -> dict:
    base = build(tmp / "base", model, *extra, dropout=dropout, mesh_less=True, steps=steps)
    base.fit()
    trainer = build(tmp / "layout", model, *extra, dropout=dropout, steps=steps)
    trainer.fit()
    return compare(trainer, base)


# ---------------------------------------------------------------- phases


def layouts2(tmp: Path) -> dict:
    """DP and FSDP on the UNet and the DiT, TP and TP+SP on the DiT, with
    and without dropout: each against its one-process run."""
    return {
        "unet_dp": fit_pair(tmp / "unet_dp", "unet"),
        "unet_fsdp": fit_pair(tmp / "unet_fsdp", "unet", "trainer.fsdp=yes"),
        "dit_fsdp": fit_pair(tmp / "dit_fsdp", "dit", "trainer.fsdp=yes"),
        "dit_tp": fit_pair(tmp / "dit_tp", "dit", "trainer.model_parallelism=2"),
        "dit_tp_sp": fit_pair(tmp / "dit_tp_sp", "dit", "trainer.model_parallelism=2",
                              "trainer.sequence_parallel=yes"),
        "dit_tp_dropout": fit_pair(tmp / "dit_tp_dropout", "dit", "trainer.model_parallelism=2", dropout=0.1),
        "dit_tp_sp_dropout": fit_pair(tmp / "dit_tp_sp_dropout", "dit", "trainer.model_parallelism=2",
                                      "trainer.sequence_parallel=yes", dropout=0.1),
    }


def layouts4(tmp: Path) -> dict:
    """TP 2 x FSDP 2 (and with SP) and FSDP over a data axis of 2 x 2
    (``dcn_data_parallelism=2``) on four ranks against one process, and the
    nn.Dropout masks across the ranks of a TP 2 x DP 2 mesh."""
    out = {
        "unet_dcn_fsdp": fit_pair(tmp / "unet_dcn_fsdp", "unet", "trainer.dcn_data_parallelism=2", "trainer.fsdp=yes"),
        "dit_tp_fsdp": fit_pair(tmp / "dit_tp_fsdp", "dit", "trainer.model_parallelism=2", "trainer.fsdp=yes"),
        "dit_tp_sp_fsdp": fit_pair(tmp / "dit_tp_sp_fsdp", "dit", "trainer.model_parallelism=2",
                                   "trainer.sequence_parallel=yes", "trainer.fsdp=yes"),
    }
    out["dropout_masks"] = dropout_masks(tmp / "masks")
    return out


def dropout_masks(tmp: Path) -> dict:
    """One train step of the DiT with block dropout under TP 2, and under
    TP 2 + SP: the pre-MLP nn.Dropout's mask of the first block as the MLP
    sees it (this rank's tokens under SP), its bits packed into hex."""
    import numpy as np

    out = {"data_rank": None, "model_rank": None}
    for name, extra in (("tp", ()), ("tp_sp", ("trainer.sequence_parallel=yes",))):
        trainer = build(tmp / name, "dit", "trainer.model_parallelism=2", *extra, dropout=0.5, steps=1, fid=False)
        masks = []

        def hook(module, inputs):
            dropped = (inputs[0] == 0).numpy()
            masks.append({"shape": list(dropped.shape), "bits": np.packbits(dropped).tobytes().hex()})

        trainer.model.dit.block_0.mlp.register_forward_pre_hook(hook)
        trainer.state = trainer.init_state()
        batch = next(trainer.data.train_batches())
        trainer._train_step(trainer.state, trainer._to_device(batch))
        out[name] = masks
        out["data_rank"], out["model_rank"] = trainer.mesh.data_rank, trainer.mesh.model_rank
    return out


def resume(tmp: Path) -> dict:
    """Resume under FSDP and under TP: 3 steps, a checkpoint, a new trainer
    restored from it to 6, against 6 straight (bit for bit); and a
    one-process checkpoint restored under FSDP, against 6 one-process steps."""
    import torch

    out = {}
    for name, extra in (("fsdp", ("trainer.fsdp=yes",)), ("tp", ("trainer.model_parallelism=2",))):
        straight = build(tmp / name / "straight", "dit", *extra, steps=6, fid=False)
        straight.fit()
        first = build(tmp / name / "first", "dit", *extra, steps=3, fid=False)
        first.fit()
        ckpt = first.save("resume")
        resumed = build(tmp / name / "resumed", "dit", *extra, steps=6, fid=False)
        resumed.fit(from_checkpoint=str(ckpt))
        a, b = full_params(straight), full_params(resumed)
        ma = {k: full_params_of(straight, k) for k in ("ema_params", "mu", "nu")}
        mb = {k: full_params_of(resumed, k) for k in ("ema_params", "mu", "nu")}
        out[name] = {
            "bit_equal": all(torch.equal(a[n], b[n]) for n in a)
            and all(torch.equal(ma[k][n], mb[k][n]) for k in ma for n in ma[k]),
            "loss_straight": straight.logger.records[-1].get("val/bpd"),
            "loss_resumed": resumed.logger.records[-1].get("val/bpd"),
            "step": resumed.state.step, "count": resumed.state.opt_state.count,
        }
    # a replicated (one-process) checkpoint restored under FSDP
    base = build(tmp / "rep" / "base", "dit", steps=3, mesh_less=True, fid=False)
    base.fit()
    ckpt = base.save("rep")  # every rank writes its own copy: one process each
    base6 = build(tmp / "rep" / "base6", "dit", steps=6, mesh_less=True, fid=False)
    base6.fit()
    fsdp = build(tmp / "rep" / "fsdp", "dit", "trainer.fsdp=yes", steps=6, fid=False)
    fsdp.fit(from_checkpoint=str(ckpt))
    out["replicated_to_fsdp"] = compare(fsdp, base6) | {"step": fsdp.state.step}
    return out


def full_params_of(trainer, part: str) -> dict:
    """Every full leaf of the state's ``part`` (params, ema_params, mu or
    nu), gathered over the layout (a collective every rank joins)."""
    layout = trainer.layout
    tensors = {"params": trainer.state.params, "ema_params": trainer.state.ema_params}.get(part)
    if tensors is None:
        tensors = getattr(trainer.state.opt_state, part)
    tensors = {n: p.detach() for n, p in tensors.items()}
    items = layout.full_items(tensors) if layout is not None else tensors.items()
    return {n: p.clone() for n, p in items}


def guards(tmp: Path) -> dict:
    """Every guard's message."""
    out = {}
    cases = {
        "sp_without_tp": ("dit", ("trainer.sequence_parallel=yes",)),
        "pipeline": ("dit", ("trainer.pipeline_parallelism=2", "trainer.pp_microbatches=3")),
        "pipeline_unet": ("unet", ("trainer.pipeline_parallelism=2",)),
        "pipeline_accum": ("dit", ("trainer.pipeline_parallelism=2", "trainer.accumulate_grad_batches=8")),
        "pipeline_depth": ("dit", ("trainer.pipeline_parallelism=2", "task.model.depth=3")),
        "indivisible_batch": ("dit", ("trainer.model_parallelism=1",)),
        "qkv_groups": ("dit", ("trainer.model_parallelism=2", "task.model.dim=128")),
        "world_vs_tp": ("dit", ("trainer.model_parallelism=3",)),
    }
    for name, (model, extra) in cases.items():
        try:
            if name == "indivisible_batch":
                trainer = build(tmp / name, model, *extra, steps=1, fid=False)
                trainer.data.batch_size = 9
                trainer._check_divisibility()
            else:
                build(tmp / name, model, *extra, steps=1, fid=False)
            out[name] = None
        except Exception as e:  # the message is what the test reads
            out[name] = f"{type(e).__name__}: {e}"
    return out


def entry(tmp: Path) -> dict:
    """``python -m bsi_torch.train``'s ``main`` with TP 2, SP and FSDP on
    the DiT, then resumed from its checkpoint: the group comes from
    torchrun's variables."""
    import torch.distributed as dist

    from bsi_torch.train.__main__ import main

    args = TINY + _model_args("dit") + ["trainer.max_steps=2", f"run_root={tmp}", "trainer.model_parallelism=2",
                                        "trainer.sequence_parallel=yes", "trainer.fsdp=yes", "seed=null"]
    assert main(args) == 0
    out = {"backend": dist.get_backend(), "world": dist.get_world_size(),
           "runs": sorted(str(p.relative_to(tmp)) for p in tmp.glob("*/*") if p.is_dir()),
           "metrics_files": sorted(str(p.relative_to(tmp)) for p in tmp.glob("*/*/metrics.jsonl"))}
    # rank 0 wrote the run; every rank resumes from its checkpoint
    ckpt = [str(next(tmp.glob("*/*/ckpt_last"))) if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(ckpt, src=0)
    ckpt = Path(ckpt[0])
    records = [json.loads(line) for line in (ckpt.parent / "metrics.jsonl").read_text().splitlines()]
    out["val_bpd"] = [r["val/bpd"] for r in records if "val/bpd" in r]
    out["seed"] = json.loads((ckpt / "meta.json").read_text())["config"]["seed"]
    assert main(args[:-1] + [f"seed={out['seed']}", "trainer.max_steps=3", f"from_ckpt={ckpt}",
                             f"run_root={tmp / 'resumed'}"]) == 0
    resumed = [json.loads(line) for p in (tmp / "resumed").glob("*/*/metrics.jsonl")
               for line in p.read_text().splitlines()]
    out["resumed_steps"] = [r["step"] for r in resumed if "train/loss" in r]
    out["resumed_val_bpd"] = [r["val/bpd"] for r in resumed if "val/bpd" in r]
    return out


def jax_step(tmp: Path) -> dict:
    """The tiny DiT's train step under TP 2 + SP on the weights, batch and
    draws that ``test_torch_parallel_jax.py`` wrote (``../inputs.pt``):
    each step's loss and grad norm, and the full parameters after (rank 0
    writes them to ``params.pt``)."""
    import torch
    import torch.distributed as dist

    from bsi_torch.core import BSI
    from bsi_torch.models import DenoisingDiT
    from bsi_torch.nn import FourierFeatures
    from bsi_torch.parallel import StateLayout, make_mesh, token_stream_sharding
    from bsi_torch.train import EMAConfig, TrainState, make_optimizer, make_train_step, module_apply
    from bsi_torch.train import warmup_cosine_schedule

    inputs = torch.load(tmp.parent / "inputs.pt", weights_only=False)
    mesh = make_mesh(model_parallelism=2)
    model = DenoisingDiT(fourier_features=FourierFeatures(6, 7), device="cpu", **inputs["model"]).double()
    model.load_state_dict(inputs["params"])
    model.set_token_sharding(token_stream_sharding(mesh))
    full = dict(model.named_parameters())
    layout = StateLayout.build(mesh, full, tensor=True)
    params = {n: layout.local(n, p.detach()).requires_grad_() for n, p in full.items()}
    tx = make_optimizer(warmup_cosine_schedule(**inputs["sched"]))
    state = TrainState.create(params=params, opt_state=tx.init(params), generator=torch.Generator())
    draws = inputs["draws"]
    step = make_train_step(BSI(**inputs["algo"]), module_apply(model), tx, EMAConfig(**inputs["ema"]),
                           noise=lambda n, like: draws[n], layout=layout)
    metrics = []
    for _ in range(len(draws)):
        state, m = step(state, inputs["batch"])
        metrics.append({k: float(v) for k, v in m.items()})
    after = {n: layout.full(n, p.detach()) for n, p in state.params.items()}
    if dist.get_rank() == 0:
        torch.save(after, tmp / "params.pt")
    return {"metrics": metrics, "local_numel": sum(p.numel() for p in state.params.values())}


# ------------------------------------------------------- the pipeline


def _pipe_model(inputs: dict, mesh, *, sp: bool = False, dropout=None):
    """The tiny DiT of ``inputs`` with ``scan_blocks=True`` on ``mesh`` (its
    Megatron pairs over the model group, with ``sp`` its token stream too)."""
    from bsi_torch.models import DenoisingDiT
    from bsi_torch.nn import FourierFeatures
    from bsi_torch.parallel import apply_sequence_parallelism

    model = DenoisingDiT(fourier_features=FourierFeatures(6, 7), device="cpu", scan_blocks=True, dropout=dropout,
                         **inputs["model"]).double()
    model.load_state_dict(inputs["params"])
    if sp:
        apply_sequence_parallelism(model, mesh)
    else:
        model.set_layout(mesh)
    return model


def _staged(model, mesh, microbatches: int, **kw):
    """``(apply, layout, params)``: the pipelined apply, the layout and this
    rank's leaves, the foreign blocks freed."""
    from bsi_torch.parallel import StateLayout, make_pipeline_apply

    layout = StateLayout.build(mesh, dict(model.named_parameters()), tensor=True, **kw)
    apply = make_pipeline_apply(model, mesh, microbatches)
    params = {n: layout.local(n, p.detach()).requires_grad_() for n, p in model.named_parameters()
              if layout.holds(n)}
    model.keep_blocks(apply.pipeline.lo, apply.pipeline.hi)
    return apply, layout, params


def pipe_apply(tmp: Path) -> dict:
    """The pipelined forward of the tiny DiT and the gradients of the mean
    square of its output, under each of ``inputs["cases"][world]`` (P, M,
    TP, SP), on the weights and inputs of ``../inputs.pt``: each rank saves
    its output, the full gradient of every leaf it holds (after the
    layout's reduction) and its point-to-point transfers to
    ``<case>_rank<r>.pt``."""
    import torch
    import torch.distributed as dist

    from bsi_torch.parallel import make_mesh

    inputs = torch.load(tmp.parent / "inputs.pt", weights_only=False)
    out = {}
    for case in inputs["cases"][dist.get_world_size()]:
        pipe, micro, tp, sp = case
        name = f"p{pipe}_m{micro}_tp{tp}" + ("_sp" if sp else "")
        mesh = make_mesh(model_parallelism=tp, pipeline_parallelism=pipe)
        model = _pipe_model(inputs, mesh, sp=sp)
        apply, layout, params = _staged(model, mesh, micro)
        apply.pipeline.trace = trace = []
        y = apply(params, inputs["mu"], inputs["t"])
        leaves = list(params.values())
        grads = torch.autograd.grad((y ** 2).mean(), leaves, allow_unused=True)
        grads = layout.reduce_grads(list(params), [torch.zeros_like(p) if g is None else g
                                                   for p, g in zip(leaves, grads)])
        full = {n: layout.full(n, g) for n, g in zip(params, grads)}
        torch.save({"y": y.detach(), "grads": full, "trace": trace, "stage": mesh.pipe_rank},
                   tmp / f"{name}_rank{dist.get_rank()}.pt")
        out[name] = {"stage": mesh.pipe_rank, "held": len(params), "blocks": [apply.pipeline.lo, apply.pipeline.hi]}
    return out


def pipe_step(tmp: Path) -> dict:
    """``make_train_step`` with the pipelined apply at P 2 x DP 2 on the
    weights, batch and draws of ``../inputs.pt`` (JAX's, through
    ``noise=``): each step's metrics and, on rank 0, the full parameters
    after (``params.pt``)."""
    import torch
    import torch.distributed as dist

    from bsi_torch.core import BSI
    from bsi_torch.parallel import make_mesh
    from bsi_torch.train import EMAConfig, TrainState, make_optimizer, make_train_step, warmup_cosine_schedule

    inputs = torch.load(tmp.parent / "inputs.pt", weights_only=False)
    mesh = make_mesh(pipeline_parallelism=2)
    model = _pipe_model(inputs, mesh)
    apply, layout, params = _staged(model, mesh, 2)
    tx = make_optimizer(warmup_cosine_schedule(**inputs["sched"]))
    state = TrainState.create(params=params, opt_state=tx.init(params), generator=torch.Generator())
    draws = inputs["draws"]
    step = make_train_step(BSI(**inputs["algo"]), apply, tx, EMAConfig(**inputs["ema"]),
                           noise=lambda n, like: draws[n], layout=layout)
    rows = inputs["batch"].shape[0] // mesh.data_size
    batch = inputs["batch"][mesh.data_rank * rows:(mesh.data_rank + 1) * rows]
    metrics = []
    for _ in range(len(draws)):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    after = dict(layout.full_items({n: p.detach() for n, p in state.params.items()}))
    if dist.get_rank() == 0:
        torch.save(after, tmp / "params.pt")
    return {"metrics": metrics, "local_numel": sum(p.numel() for p in state.params.values()),
            "mesh": [mesh.data_rank, mesh.pipe_rank]}


def pipe_masks(tmp: Path) -> dict:
    """The pre-MLP nn.Dropout mask of every block and microbatch of one
    pipelined train-mode forward (P 2, M 2, dropout 0.5) under two step
    seeds, the first twice, and the one-process masks under the first: as
    the MLP sees them (zeros dropped), bits packed into hex, by block."""
    import numpy as np
    import torch

    from bsi_torch.parallel import make_mesh
    from bsi_torch.train.step import _dropout_rng, module_apply

    inputs = torch.load(tmp.parent / "inputs.pt", weights_only=False)
    mesh = make_mesh(pipeline_parallelism=2)

    def masks_of(model, apply, params, seed):
        seen = {}

        def hook(i):
            def record(module, args):
                seen.setdefault(i, []).append(np.packbits((args[0] == 0).numpy()).tobytes().hex())
            return record

        blocks = [(i, getattr(model.dit, f"block_{i}")) for i in range(model.depth)]
        handles = [block.mlp.register_forward_pre_hook(hook(i)) for i, block in blocks
                   if next(block.parameters()).device.type != "meta"]
        with torch.no_grad(), _dropout_rng(torch.device("cpu"), seed):
            y = apply(params, inputs["mu"], inputs["t"])
        for h in handles:
            h.remove()
        return {str(i): v for i, v in seen.items()}, float(y.double().square().sum())

    model = _pipe_model(inputs, mesh, dropout=0.5)
    apply, _, params = _staged(model, mesh, 2)
    runs = {key: masks_of(model, apply, params, seed) for key, seed in (("a", 11), ("a_again", 11), ("b", 12))}
    one = _pipe_model(inputs, mesh, dropout=0.5)
    one_params = dict(one.named_parameters())
    runs["one_process"] = masks_of(one, module_apply(one), one_params, 11)
    return {key: {"masks": m, "out": o} for key, (m, o) in runs.items()}


def remat_runs(tmp: Path, *extra: str, one: bool = False) -> dict:
    """The Trainer with ``remat`` under the layout ``extra``, dropout on,
    against one process without it and against the layout without it; with
    ``one`` also one process with ``remat`` against one without."""
    remat = "task.model.remat=yes"
    base = build(tmp / "base", "dit", dropout=0.1, mesh_less=True)
    base.fit()
    off = build(tmp / "off", "dit", *extra, dropout=0.1)
    off.fit()
    on = build(tmp / "on", "dit", *extra, remat, dropout=0.1)
    on.fit()
    out = {"layout": compare(on, base), "layout_off": compare(on, off)}
    if one:
        alone = build(tmp / "one", "dit", remat, dropout=0.1, mesh_less=True)
        alone.fit()
        out["one"] = compare(alone, base)
    return out


def pipe_trainer2(tmp: Path) -> dict:
    """The Trainer at P 2 (with attention and block dropout, at M 4, and
    with remat) against one process, and the checkpoints across P 1 and
    P 2."""
    return {
        "dropout": fit_pair(tmp / "dropout", "dit", "trainer.pipeline_parallelism=2", dropout=0.1),
        "m4": fit_pair(tmp / "m4", "dit", "trainer.pipeline_parallelism=2", "trainer.pp_microbatches=4"),
        "remat": remat_runs(tmp / "remat", "trainer.pipeline_parallelism=2", one=True),
        "ckpt": pipe_checkpoints(tmp / "ckpt"),
    }


def pipe_trainer4(tmp: Path) -> dict:
    """The Trainer at P 2 x DP 2 with FSDP, and at P 2 x TP 2 with SP and
    dropout (also with remat), against one process."""
    tp_sp = ("trainer.pipeline_parallelism=2", "trainer.model_parallelism=2", "trainer.sequence_parallel=yes")
    return {
        "fsdp": fit_pair(tmp / "fsdp", "dit", "trainer.pipeline_parallelism=2", "trainer.fsdp=yes"),
        "tp_sp": fit_pair(tmp / "tp_sp", "dit", *tp_sp, dropout=0.1),
        "remat": remat_runs(tmp / "remat", *tp_sp),
    }


def pipe_entry(tmp: Path) -> dict:
    """``python -m bsi_torch.train``'s ``main`` at P 2 (the group already
    joined, which ``initialize_distributed`` keeps), then its checkpoint
    restored without the pipe as the eval scripts restore one
    (``load_trainer`` with ``trainer.pipeline_parallelism=1``; the group
    makes that a data axis of 2)."""
    import torch
    import torch.distributed as dist

    from bsi_torch.scripts._common import load_trainer
    from bsi_torch.train.__main__ import main

    args = TINY + _model_args("dit") + ["trainer.max_steps=2", f"run_root={tmp}", "trainer.pipeline_parallelism=2"]
    assert main(args) == 0
    ckpt = [str(next(tmp.glob("*/*/ckpt_last"))) if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(ckpt, src=0)
    ckpt = Path(ckpt[0])
    records = [json.loads(line) for line in (ckpt.parent / "metrics.jsonl").read_text().splitlines()]
    trainer, config, _ = load_trainer(str(ckpt), ["trainer.pipeline_parallelism=1"],
                                      run_dir=tmp / f"eval{dist.get_rank()}")
    saved = torch.load(ckpt / "state.pt", weights_only=True)["params"]
    full = full_params(trainer)
    return {"val_bpd": [r["val/bpd"] for r in records if "val/bpd" in r],
            "loss": [r["train/loss"] for r in records if "train/loss" in r],
            "restored": trainer.mesh.pipe_size == 1 and trainer.state.step == 2 and set(full) == set(saved)
            and all(torch.equal(p, saved[n]) for n, p in full.items()),
            "pipeline_parallelism": config["trainer"]["pipeline_parallelism"]}


def pipe_checkpoints(tmp: Path) -> dict:
    """A P 2 checkpoint restored at P 1 and a P 1 checkpoint at P 2, each
    state held bit for bit to the file; the P 2 run resumed from its own
    checkpoint (dropout on) against the straight run, bit for bit; and the
    P 1 checkpoint continued at P 2 against P 1 straight."""
    import torch
    import torch.distributed as dist

    p2 = ("trainer.pipeline_parallelism=2",)
    parts = ("params", "ema_params", "mu", "nu")

    def saved_parts(ckpt: Path) -> dict:
        saved = torch.load(ckpt / "state.pt", weights_only=True)
        return {"params": saved["params"], "ema_params": saved["ema_params"], **saved["opt_state"]}

    def equal(trainer, saved: dict) -> bool:
        got = {part: full_params_of(trainer, part) for part in parts}
        return all(set(got[k]) == set(saved[k]) and all(torch.equal(got[k][n], saved[k][n]) for n in saved[k])
                   for k in parts)

    out = {}
    # P 2 -> P 1, and P 2 resumed from its own checkpoint
    first = build(tmp / "p2_first", "dit", *p2, steps=3, dropout=0.1, fid=False)
    first.fit()
    ckpt = first.save("p2")
    dist.barrier()
    saved = saved_parts(ckpt)
    out["p2_gathers_the_file"] = equal(first, saved)
    one = build(tmp / "p1_from_p2", "dit", steps=3, dropout=0.1, mesh_less=True, fid=False)
    one.restore(ckpt)
    out["p2_to_p1_bit_equal"] = equal(one, saved) and one.state.step == 3
    straight = build(tmp / "p2_straight", "dit", *p2, steps=6, dropout=0.1, fid=False)
    straight.fit()
    resumed = build(tmp / "p2_resumed", "dit", *p2, steps=6, dropout=0.1, fid=False)
    resumed.fit(from_checkpoint=str(ckpt))
    out["p2_resume_bit_equal"] = all(
        all(torch.equal(a, b) for a, b in zip(full_params_of(straight, k).values(),
                                               full_params_of(resumed, k).values()))
        for k in parts)
    # P 1 -> P 2 (each rank wrote its own one-process checkpoint)
    base = build(tmp / "p1_first", "dit", steps=3, mesh_less=True, fid=False)
    base.fit()
    ckpt1 = base.save("p1")
    saved1 = saved_parts(ckpt1)
    staged = build(tmp / "p2_from_p1", "dit", *p2, steps=6, fid=False)
    staged.restore(ckpt1)
    out["p1_to_p2_bit_equal"] = equal(staged, saved1) and staged.state.step == 3
    base6 = build(tmp / "p1_straight", "dit", steps=6, mesh_less=True, fid=False)
    base6.fit()
    staged.fit()
    out["p1_to_p2_then_3_steps"] = compare(staged, base6)
    out["held"] = sorted(staged.state.params)
    return out


def launch(tmp: Path, world: int, phases: str, *, env: bool = False, timeout: float = 300.0) -> list[dict]:
    """Run ``phases`` on ``world`` worker processes (a fresh ``file://``
    store under ``tmp``, or with ``env`` torchrun's variables and a port
    from ``bind(0)``); returns each rank's results."""
    import socket
    import subprocess

    tmp.mkdir(parents=True, exist_ok=True)
    if env:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            rendezvous = f"env:{s.getsockname()[1]}"
    else:
        rendezvous = str(tmp / "store")
    out = tmp / "out"
    environ = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                                                                "MASTER_ADDR", "MASTER_PORT")}
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), rendezvous, str(rank), str(world),
                               phases, str(out)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=environ) for rank in range(world)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} of {world} failed:\n{log[-4000:]}"
    return [json.loads((out / f"rank{rank}.json").read_text()) for rank in range(world)]


def main() -> None:
    rendezvous, rank, world, phases, out_dir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], \
        Path(sys.argv[5])
    import torch

    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    import torch.distributed as dist

    if rendezvous.startswith("env:"):
        os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
                           "MASTER_ADDR": "localhost", "MASTER_PORT": rendezvous[4:]})
    else:
        dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank, world_size=world)
    results = {}
    for phase in phases.split(","):
        tmp = out_dir / phase
        tmp.mkdir(parents=True, exist_ok=True)
        results[phase] = globals()[phase](tmp)
    (out_dir / f"rank{rank}.json").write_text(json.dumps(results))
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
