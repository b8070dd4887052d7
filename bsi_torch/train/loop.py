"""Step-based training loop, on one device or over a mesh of processes.

Counterpart of ``bsi_tpu/train/loop.py::Trainer``: an explicit loop with

- the train step of :mod:`.step` (gradient accumulation included),
- a sanity validation before the first step, the NaN guard (``ckpt_nan``),
  logging of the loss, the gradient norm, ``train/lr`` and
  ``train/steps_per_sec``, preemption to ``ckpt_interrupt``,
- periodic validation with exact masked metrics over the val split and a
  fixed train subset (logged as ``train/*``), on the EMA parameters, with
  the eval noise drawn from a generator seeded with ``0x5EED ^ seed`` anew
  at every call, so two validations of one state agree,
- ``ckpt_last`` and ``ckpt_best`` (with ``best_bpd``) written in the
  background, and resume from a checkpoint with the data cursor,
- validation FID where ``fid_metrics`` holds a metric for a split: one
  sample per real row of each eval batch, drawn with the EMA model from the
  eval generator after that batch's eval step,
- callbacks (the plots) at validation time, and an optional stall watchdog.

Batches leave the data module as numpy arrays and reach the device from
pinned memory with ``non_blocking=True``.

With a ``mesh`` (:func:`bsi_torch.parallel.make_mesh` under a process
group) the state is laid out over it (:class:`~bsi_torch.parallel.StateLayout`:
replicated, FSDP with ``fsdp``, the DiT's tensor parallelism where the
model group has more than one rank, its sequence parallelism with
``sequence_parallel``, its pipeline stages where the pipe axis has more
than one) and the data module gives this data rank's rows. Under a pipe
axis the train step, the eval step and the sampler run the pipelined model
(:func:`bsi_torch.parallel.make_pipeline_apply`, ``pp_microbatches``
microbatches, the pipe size by default), the model needs
``scan_blocks=True``, and each rank's models keep only its stage's blocks.
Validation sums its metrics over the data group; FID draws the global
sample batch in lockstep, each data rank embeds its rows and only pipe and
model rank 0 of each replica adds them. Rank 0 alone writes checkpoints
(the full state, gathered first: the file is the same whatever the layout)
and every rank waits for the write; ``restore`` reads the full state and
cuts this rank's shards, so a checkpoint of any layout restores under any
other.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from bsi_torch.core.common import resolve_device
from bsi_torch.metrics.fid import fid_from_stats, images_to_uint8, reduce_stats_across_processes
from bsi_torch.parallel import Mesh, StateLayout, apply_sequence_parallelism, check_host_batch, make_pipeline_apply
from bsi_torch.utils import profiling
from bsi_torch.utils.logging import MetricLogger, count_params

from .checkpoint import AsyncCheckpointWriter, load_checkpoint, save_checkpoint, state_to_host
from .ema import EMAConfig
from .state import TrainState
from .step import eval_params, make_eval_step, make_sample_fn, make_train_step, module_apply

EVAL_SEED = 0x5EED


class Trainer:
    """Trains ``model`` with ``algorithm`` on ``data``; see the module doc."""

    def __init__(
        self,
        *,
        algorithm,
        model: torch.nn.Module,
        optimizer,
        data,
        ema: EMAConfig | None = None,
        eval_model: Optional[torch.nn.Module] = None,
        max_steps: int = 10000,
        val_check_interval: int = 10000,
        log_every: int = 50,
        n_elbo_recon_samples: int = 1,
        n_elbo_measure_samples: int = 1,
        limit_eval_batches: Optional[int] = None,
        sanity_val_batches: int = 0,
        run_dir: str | Path = "runs/default",
        logger: Optional[MetricLogger] = None,
        config: Optional[dict] = None,
        seed: int = 0,
        device: torch.device | str | None = None,
        callbacks: tuple = (),
        preemption=None,
        profiler=None,
        accumulate_grad_batches: int = 1,
        lr_schedule=None,
        async_checkpointing: bool = True,
        stall_timeout_s: Optional[float] = None,
        fid_metrics: Optional[dict] = None,
        mesh: Optional[Mesh] = None,
        fsdp: bool = False,
        sequence_parallel: bool = False,
        pp_microbatches: Optional[int] = None,
    ):
        self.device = resolve_device(device)
        self.algorithm = algorithm
        self.model = model
        self.eval_model = eval_model if eval_model is not None else model
        self.optimizer = optimizer
        self.data = data
        self.ema_cfg = ema or EMAConfig()
        self.max_steps = max_steps
        self.val_check_interval = val_check_interval
        self.log_every = log_every
        self.limit_eval_batches = limit_eval_batches
        self.sanity_val_batches = sanity_val_batches
        self.run_dir = Path(run_dir)
        self.logger = logger or MetricLogger(self.run_dir)
        self.config = config or {}
        self.seed = seed
        self.callbacks = callbacks
        # split name -> FIDScore (bsi_torch.metrics.build_validation_fid)
        self.fid_metrics = fid_metrics or {}
        self.preemption = preemption
        self.profiler = profiler
        # The learning rate of each step, for the train/lr log.
        self.lr_schedule = lr_schedule
        self.best_bpd = float("inf")
        self.async_checkpointing = async_checkpointing
        self._ckpt_writer: Optional[AsyncCheckpointWriter] = None
        # Gradient accumulation: batch_size is the optimizer-step batch,
        # split into this many micro-batches, as in the JAX trainer.
        self.accum = int(accumulate_grad_batches)
        if self.accum < 1:
            raise ValueError("accumulate_grad_batches must be >= 1")
        # Fail-fast stall detection (utils/watchdog.py), armed after the first
        # logged step; 0 or less is refused, not read as "off".
        if stall_timeout_s is not None and stall_timeout_s <= 0:
            raise ValueError(f"stall_timeout_s must be positive (or None for no watchdog), got {stall_timeout_s}")
        self.stall_timeout_s = stall_timeout_s
        self._watchdog = None
        self._warmed: set[str] = set()

        # The layout: the mesh's collectives run only under a process group.
        self.mesh = mesh if mesh is not None else Mesh()
        models = (self.model,) if self.eval_model is self.model else (self.model, self.eval_model)
        if sequence_parallel:
            for m in models:
                apply_sequence_parallelism(m, self.mesh)
        elif self.mesh.distributed:
            for m in models:
                if hasattr(m, "set_layout"):
                    m.set_layout(self.mesh)
        # the DiT takes tensor parallelism; other models stay replicated on
        # the model group (each of its ranks computes the whole model)
        tensor = hasattr(self.model, "set_layout")
        self.layout = StateLayout.build(self.mesh, dict(self.model.named_parameters()), fsdp=fsdp,
                                        tensor=tensor) if self.mesh.distributed else None

        if self.mesh.pipe_size > 1:
            # GPipe stages of the DiT's blocks over the pipe axis
            # (bsi_torch/parallel/pipeline.py); each model keeps its stage's blocks
            self.train_apply = make_pipeline_apply(self.model, self.mesh, pp_microbatches, train=True)
            self.eval_apply = make_pipeline_apply(self.eval_model, self.mesh, pp_microbatches, train=False)
            stage = self.train_apply.pipeline
            for m in models:
                m.keep_blocks(stage.lo, stage.hi)
        else:
            self.train_apply = module_apply(self.model, train=True)
            self.eval_apply = module_apply(self.eval_model, train=False)
        self._train_step = make_train_step(algorithm, self.train_apply, optimizer, self.ema_cfg,
                                           accum_steps=self.accum, layout=self.layout)
        self._eval_step = make_eval_step(algorithm, self.eval_apply, n_recon_samples=n_elbo_recon_samples,
                                         n_measure_samples=n_elbo_measure_samples, layout=self.layout)
        self.sample_fn = make_sample_fn(algorithm, self.eval_apply, layout=self.layout)
        self.state: TrainState | None = None
        self._check_divisibility()

    # ------------------------------------------------------------------ setup

    def _check_divisibility(self):
        """Fail with an actionable message when a batch size does not divide
        over the mesh's data axis."""
        n_data = self.mesh.data_size
        for label, bs in (
            ("batch_size", getattr(self.data, "batch_size", None)),
            ("eval_batch_size", getattr(self.data, "eval_batch_size", None)),
        ):
            if bs is not None and bs % n_data != 0:
                raise ValueError(
                    f"data.{label}={bs} is not divisible by the mesh's data-axis "
                    f"size {n_data}; choose a {label} that is a multiple of the "
                    f"number of data-parallel devices"
                )
        bs = getattr(self.data, "batch_size", None)
        if self.accum > 1 and bs is not None and bs % (self.accum * n_data) != 0:
            raise ValueError(
                f"data.batch_size={bs} must be divisible by "
                f"accumulate_grad_batches={self.accum} x data-axis size {n_data} "
                f"so every micro-batch shards evenly"
            )
        if self.mesh.pipe_size > 1:
            m = self.train_apply.pipeline.micro
            for label, bs in (
                ("batch_size", getattr(self.data, "batch_size", None)),
                ("eval_batch_size", getattr(self.data, "eval_batch_size", None)),
            ):
                if bs is not None and (bs // n_data) % m != 0:
                    raise ValueError(
                        f"data.{label}={bs} gives {bs // n_data} examples per "
                        f"data-parallel device, not divisible by "
                        f"pp_microbatches={m}; the pipeline needs equal "
                        f"microbatches on every device"
                    )
            bs = getattr(self.data, "batch_size", None)
            if self.accum > 1 and bs is not None and (bs // (self.accum * n_data)) % m != 0:
                raise ValueError(
                    f"data.batch_size={bs} gives {bs // (self.accum * n_data)} examples per "
                    f"accumulation micro-batch and data-parallel device, not divisible by "
                    f"pp_microbatches={m}; the pipeline needs equal microbatches on every device"
                )

    def init_state(self) -> TrainState:
        """A state at step 0: the model's parameters (initialised from the
        run seed by ``build_task``) copied, this rank's shards of them under
        a layout (those of its stage under a pipe axis), the EMA a copy of
        them, fresh Adam moments, and the generator and dropout seed derived
        from the run seed."""
        gen_seed, dropout_seed = (int(w) for w in np.random.SeedSequence([int(self.seed), 0x57A7E]).generate_state(
            2, np.uint64))
        cut = self.layout.local if self.layout is not None else lambda name, p: p.clone()
        params = {name: cut(name, p.detach().to(self.device)).requires_grad_()
                  for name, p in self.model.named_parameters() if self.layout is None or self.layout.holds(name)}
        generator = torch.Generator(device=self.device).manual_seed(gen_seed)
        state = TrainState.create(params=params, opt_state=self.optimizer.init(params), generator=generator,
                                  dropout_seed=dropout_seed)
        self.logger.console_line(f"model parameters: {count_params(dict(self.model.named_parameters())):,}")
        return state

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        with profiling.span("train.to_device"):
            tensor = torch.from_numpy(np.ascontiguousarray(array))
            if self.device.type == "cuda":
                return tensor.pin_memory().to(self.device, non_blocking=True)
            return tensor.to(self.device)

    def _warm(self, path: str):
        """Context of one call on ``path``: the first call may build
        kernels, so the watchdog is held off around it."""
        first = path not in self._warmed
        self._warmed.add(path)
        if first and self._watchdog is not None:
            return self._watchdog.suspended()
        return contextlib.nullcontext()

    def _beat(self) -> None:
        if self._watchdog is not None:
            self._watchdog.beat()

    # ------------------------------------------------------------------ train

    def fit(self, from_checkpoint: Optional[str] = None) -> dict:
        if from_checkpoint is not None:
            self.restore(from_checkpoint)
        if self.state is None:
            self.state = self.init_state()
        self.logger.log_hyperparams(self.config)

        batches = self.data.train_batches()
        start_step = int(self.state.step)
        last_metrics: dict = {}
        try:
            if self.sanity_val_batches and start_step == 0:
                # catch eval-path breakage before a long run; the metrics
                # are discarded and the callbacks (plots) skipped
                limit, self.limit_eval_batches = self.limit_eval_batches, self.sanity_val_batches
                cbs, self.callbacks = self.callbacks, ()
                try:
                    self.validate()
                finally:
                    self.limit_eval_batches, self.callbacks = limit, cbs

            t_log = time.time()
            for step in range(start_step, self.max_steps):
                batch = next(batches)
                if self.layout is not None and step == start_step and getattr(self.data, "batch_size", None):
                    check_host_batch(len(batch), self.data.batch_size, self.mesh.data_size)
                if self.accum > 1:
                    batch = batch.reshape((self.accum, -1) + batch.shape[1:])
                with self._warm("train"):
                    self.state, metrics = self._train_step(self.state, self._to_device(batch))
                if self.profiler is not None:
                    self.profiler.on_step(step)

                if (step + 1) % self.log_every == 0 or step + 1 == self.max_steps:
                    host = {k: float(v) for k, v in metrics.items()}
                    if not np.isfinite(host["train/loss"]):
                        # NaN guard: checkpoint the broken state for post-mortem
                        self.save("nan")
                        raise FloatingPointError(f"non-finite train loss {host['train/loss']} at step "
                                                 f"{step + 1} (state saved to ckpt_nan)")
                    dt = time.time() - t_log
                    host["train/steps_per_sec"] = self.log_every / dt if dt > 0 else 0.0
                    if self.lr_schedule is not None:
                        lr = self.lr_schedule
                        host["train/lr"] = float(lr(step) if callable(lr) else lr)
                    t_log = time.time()
                    self.logger.log(step + 1, host)
                    self.logger.console_line(f"step {step + 1}/{self.max_steps}  loss {host['train/loss']:.4f}  "
                                             f"({host['train/steps_per_sec']:.2f} it/s)")
                    last_metrics = host
                    if self.stall_timeout_s is not None:
                        if self._watchdog is None:
                            # armed after the first host fetch, so the first
                            # steps' kernel builds cannot trip it
                            from bsi_torch.utils.watchdog import StallWatchdog

                            self._watchdog = StallWatchdog(self.stall_timeout_s).start()
                        else:
                            self._watchdog.beat()

                if self.preemption is not None and self._preempted():
                    path = self.save("interrupt")
                    self.logger.console_line(f"preempted at step {step + 1}; checkpoint saved to {path}")
                    last_metrics["preempted"] = True
                    return last_metrics

                if (step + 1) % self.val_check_interval == 0 or step + 1 == self.max_steps:
                    val_metrics = self.validate()
                    last_metrics.update(val_metrics)
                    bpd = val_metrics.get("val/bpd", float("inf"))
                    if bpd < self.best_bpd:
                        # best_bpd first, so both checkpoints carry the new best
                        self.best_bpd = bpd
                        self.save("last", wait=False)
                        self.save("best", wait=False)
                    else:
                        self.save("last", wait=False)
                    self._beat()
                    t_log = time.time()
        finally:
            if self._watchdog is not None:
                self._watchdog.stop()
                self._watchdog = None
            self.flush_checkpoints()
            if self.profiler is not None:
                self.profiler.close()
        if np.isfinite(self.best_bpd):
            last_metrics["best/bpd"] = self.best_bpd
        return last_metrics

    def _preempted(self) -> bool:
        """Whether any rank caught the preemption signal (all ranks then
        save together)."""
        flag = bool(self.preemption.triggered)
        if self.layout is None:
            return flag
        t = torch.tensor([int(flag)], device=self.mesh.device())
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    # ------------------------------------------------------------------- eval

    def validate(self, *, stage: str = "val") -> dict:
        """One evaluation pass over every eval split; returns the metrics.

        The eval noise comes from a generator seeded with ``0x5EED ^ seed``
        at every call, so two calls at the same parameters return equal
        metrics and successive validations measure only the model's change.
        Each split's sums are exact over its real examples (padded rows are
        masked out). The train subset logs as ``train/*`` in either stage.
        A split with a FID metric logs ``{prefix}/fid-{dim}`` over one sample
        per real example, drawn after each batch's eval step from the same
        generator, so the FID of one state is repeatable too.
        """
        assert self.state is not None, "validate() needs a state: call init_state(), fit() or restore() first"
        self._beat()
        t0 = time.perf_counter()
        splits = self.data.eval_splits() if stage == "val" else self.data.test_splits()
        generator = torch.Generator(device=self.device).manual_seed((EVAL_SEED ^ int(self.seed)) % 2**63)
        metrics: dict[str, float] = {}
        for name, split in splits.items():
            fid = self.fid_metrics.get(name)
            sums: dict[str, float] = {}
            for i, (batch, mask) in enumerate(self.data.eval_batches(split)):
                if self.limit_eval_batches is not None and i >= self.limit_eval_batches:
                    break
                with self._warm("eval"):
                    out = self._eval_step(self.state, self._to_device(batch), self._to_device(mask), generator)
                if self.layout is not None:
                    out = self.layout.sum_over_data({k: v.to(torch.float64) for k, v in out.items()})
                for k, v in out.items():
                    sums[k] = sums.get(k, 0.0) + float(v)
                self._beat()
                if fid is not None:
                    with self._warm("fid"):
                        self._update_fid(fid, generator, len(batch), np.asarray(mask, bool))
                    self._beat()
            prefix = stage if name != "train" else "train"
            if sums.get("count", 0.0) > 0:
                metrics[f"{prefix}/elbo"] = sums["elbo_sum"] / sums["count"]
                metrics[f"{prefix}/bpd"] = sums["bpd_sum"] / sums["count"]
                for k, v in sums.items():
                    if k.startswith("part_sum/"):
                        metrics[f"{prefix}/{k[len('part_sum/'):]}"] = v / sums["count"]
            if fid is not None:
                fake = fid.fake_stats
                if self.layout is not None:
                    fake = reduce_stats_across_processes(fake, device=self.mesh.device())
                if fake.n >= 2:
                    metrics[f"{prefix}/fid-{fake.sum.shape[0]}"] = fid_from_stats(fake, fid.real_stats)
                fid.reset()
        step = int(self.state.step)
        self.logger.log(step, metrics)
        if "val/bpd" in metrics:
            self.logger.console_line(f"validation @ step {step}: bpd {metrics['val/bpd']:.4f}")
        timings = {f"time/{stage}_s": time.perf_counter() - t0}
        for i, cb in enumerate(self.callbacks):
            t1 = time.perf_counter()
            with self._warm(f"callback_{i}"):
                cb(self, stage=stage, step=step)
            self._beat()
            timings[f"time/{type(cb).__name__}_s"] = time.perf_counter() - t1
        self.logger.log(step, timings)
        return metrics

    def test(self) -> dict:
        return self.validate(stage="test")

    def eval_model_fn(self, state: Optional[TrainState] = None):
        """``(mu, t) -> prediction`` of the eval model on ``state``'s (the
        trainer's state's) EMA parameters, gathered once under a layout: what
        the plots and the eval scripts call the model through. Every rank of
        a layout must make it and call it in lockstep."""
        params = eval_params(state if state is not None else self.state, layout=self.layout)
        return lambda mu, t: self.eval_apply(params, mu, t)

    def _update_fid(self, fid, generator: torch.Generator, n: int, mask: np.ndarray) -> None:
        """Draw ``n`` samples (the whole eval batch, padded rows included, as
        the JAX trainer draws them) with the EMA model and feed the rows the
        mask keeps into the FID accumulator: FID sees the split's size.

        Under a layout ``n`` is this data rank's rows: every rank draws the
        global batch's noise in lockstep from the replicated generator and
        samples its own rows alone; only pipe and model rank 0 of each
        replica embeds them (the pipe and model ranks of one replica hold the
        same rows), and ``validate`` sums the statistics over every
        process."""
        m = self.mesh
        global_eval = getattr(self.data, "eval_batch_size", None)
        if self.layout is not None and global_eval is not None and n * m.data_size != int(global_eval):
            raise RuntimeError(
                f"eval batch contract violated: host yielded {n} rows but "
                f"eval_batch_size={global_eval} over {m.data_size} processes requires "
                f"{int(global_eval) // m.data_size} equal rows per host"
            )
        rows = slice(m.data_rank * n, (m.data_rank + 1) * n) if self.layout is not None else None
        samples = self.sample_fn(self.state, generator, n * m.data_size, rows=rows)
        if m.model_rank != 0 or m.pipe_rank != 0:
            return
        samples01 = self.data.discretization().to_unit_interval(samples)
        fid.update(images_to_uint8(samples01.cpu().numpy()[mask]))

    # ------------------------------------------------------------ checkpoints

    def save(self, tag: str = "last", *, wait: bool = True) -> Path:
        """Write ``ckpt_<tag>``. With ``wait=False`` (the periodic saves)
        only the device-to-host copy blocks and the disk write overlaps the
        next steps; ``wait=True`` returns with the checkpoint written.
        Under a layout every rank joins the gather of the full state, rank
        0 writes it, and with ``wait=True`` every rank waits for the write."""
        assert self.state is not None, "save() needs a state"
        path = self.run_dir / f"ckpt_{tag}"
        if self.layout is not None and not self.mesh.writes:
            state_to_host(self.state, full=self.layout.full_items, host=False)
            if wait:
                dist.barrier()
            return path
        full = self.layout.full_items if self.layout is not None else None
        kwargs = dict(config=self.config, data_state=self.data.state_dict(), full=full,
                      extra={"best_bpd": self.best_bpd, "data_shards": self.mesh.data_size})
        t0 = time.perf_counter()
        if self.async_checkpointing:
            if self._ckpt_writer is None:
                self._ckpt_writer = AsyncCheckpointWriter()
            self._ckpt_writer.save(path, self.state, **kwargs)
            self.logger.log(int(self.state.step), {f"time/ckpt_{tag}_copy_s": time.perf_counter() - t0})
            if wait:
                self.flush_checkpoints()
        else:
            save_checkpoint(path, self.state, **kwargs)
            self.logger.log(int(self.state.step), {f"time/ckpt_{tag}_write_s": time.perf_counter() - t0})
            if wait and self.layout is not None:
                dist.barrier()
        return path

    def flush_checkpoints(self) -> None:
        """Block until every checkpoint in flight is written, and log how
        long each write took; under a layout every rank waits for rank 0's
        writes."""
        if self._ckpt_writer is not None:
            for path, seconds in self._ckpt_writer.wait():
                self.logger.log(int(self.state.step), {f"time/{path.name}_write_s": seconds})
        if self.layout is not None:
            dist.barrier()

    def _rescaled_cursor(self, data_state: dict, shards: int) -> dict:
        """The data cursor of a run over ``shards`` data ranks, for this
        run's: each shard's stream position scaled by the ratio (a stream
        shard takes every ``shards``-th index of the epoch's permutation, so
        the same examples have been seen)."""
        n = self.mesh.data_size
        stream = data_state.get("stream")
        if shards == n or stream is None:
            return data_state
        seen = int(stream["pos"]) * int(shards)
        if seen % n:
            raise ValueError(f"a checkpoint of {shards} data ranks at stream position {stream['pos']} cannot "
                             f"resume on {n}: {seen} examples do not split evenly")
        return {**data_state, "stream": {**stream, "pos": seen // n}}

    def restore(self, path: str | Path) -> None:
        # a restore may target a path an async save is still writing
        self.flush_checkpoints()
        if self.state is None:
            self.state = self.init_state()
        layout = self.layout
        self.state, meta = load_checkpoint(path, self.state, local=layout.local if layout is not None else None,
                                           names=layout.names if layout is not None else None)
        if meta.get("data_state"):
            self.data.load_state_dict(self._rescaled_cursor(meta["data_state"],
                                                            (meta.get("extra") or {}).get("data_shards", 1)))
        # best-checkpoint bookkeeping: a requeued run never overwrites
        # ckpt_best with a worse model
        best = (meta.get("extra") or {}).get("best_bpd")
        if best is not None:
            self.best_bpd = float(best)
