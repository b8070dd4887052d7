"""One run of one cell: the cell's files, the program built through its own
entry, the seeds, and the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``. Its configuration
is ``configs/<config>.json`` (the recipe as the program runs it, under
``program``), its traffic ``workloads/<traffic>.json``, whose ``driver``
names ``drivers/<driver>.py``, its limits ``limits/<cell>.json``, and each
per-layer metric ``metrics/<metric>.py``. The driver sets up, measures the
window, and reads both sides of the check; this module does the rest.
"""

from __future__ import annotations

import atexit
import copy
import gc
import importlib.util
import json
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "bsi_tpu")
SEED_NAMES = ("weights", "data", "noise", "dropout", "sample", "check")


def read_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A driver's or a metric's file, loaded by its path (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"benchmark_part_{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)

    @property
    def kind(self) -> str:
        """The configuration's model kind: its file ``reference/<kind>.py``
        is the reference's model and the counts' shapes."""
        return self.config["model"]

    @property
    def model(self):
        """The model kind's file (:func:`benchmark.reference.model`)."""
        from benchmark import reference

        return reference.model(self.kind)

    @property
    def precision(self) -> str:
        """``bf16`` or ``f32``, the compute precision the traffic runs."""
        return "bf16" if self.program()["trainer"]["precision"] in ("bf16", "bf16-mixed") else "f32"

    def program(self) -> dict:
        """The config ``build_task`` takes: the recipe, with the traffic's
        precision, and no plots or validation FID (which a run of the
        window never reaches)."""
        cfg = copy.deepcopy(self.config["program"])
        trainer = cfg.setdefault("trainer", {})
        trainer["precision"] = str(self.traffic.get("precision", trainer.get("precision", "32")))
        trainer.update(plots=False, fid=False)
        return cfg

    def reference_model(self) -> dict:
        """The model's sizes as the reference takes them."""
        return self.model.sizes(self.config)

    def algorithm(self) -> dict:
        return self.config["program"]["task"]["algorithm"]


def load_cell(workload: str, bench: dict | None = None) -> Cell:
    bench = bench if bench is not None else read_json(REPO / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json; there are {sorted(entries)}")
    entry = entries[workload]
    config_file = next(c["file"] for c in bench["configs"] if c["name"] == entry["config"])
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(name=workload, config=read_json(REPO / config_file),
                traffic=read_json(HERE / "workloads" / f"{entry['traffic']}.json"),
                limits=read_json(HERE / "limits" / f"{workload}.json"), chips=int(entry["chips"]),
                end_to_end=e2e, per_layer=per_layer)


def seeds(seed: int) -> dict:
    """The run's seeds, one a purpose, from ``--seed`` (any whole number)."""
    words = np.random.SeedSequence(abs(int(seed))).generate_state(len(SEED_NAMES), np.uint64)
    return {name: int(w) >> 1 for name, w in zip(SEED_NAMES, words)}


def forbidden_modules() -> list[str]:
    """The top-level names of loaded modules that the run may not hold."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def build_trainer(cell: Cell, data, device, run_dir: Path):
    """The program's Trainer through ``build_task``, as ``python -m
    bsi_torch.train`` and the eval scripts build it."""
    from bsi_torch.tasks.task import build_task

    return build_task(cell.program(), data, run_dir=run_dir, seed=0, device=device)


def install_weights(trainer, weights: dict, shapes: dict) -> None:
    """The benchmark's weights into the trainer's state: parameters and EMA.
    The state has to hold exactly the reference's leaves."""
    import torch

    state = trainer.state
    got = {n: tuple(p.shape) for n, p in state.params.items()}
    if got != {n: tuple(s) for n, s in shapes.items()}:
        missing, extra = sorted(set(shapes) - set(got)), sorted(set(got) - set(shapes))
        raise RuntimeError(f"the program's leaves differ from the reference's: missing {missing[:5]}, "
                           f"extra {extra[:5]}, or shapes differ")
    with torch.no_grad():
        for name, w in weights.items():
            state.params[name].copy_(w)
            state.ema_params[name].copy_(w)


def scratch_dir() -> Path:
    """A directory for the trainer's run (its log) under the temp dir,
    removed when the process ends."""
    path = Path(tempfile.mkdtemp(prefix="benchmark-run-"))
    atexit.register(shutil.rmtree, path, True)
    return path


class Device:
    """The calls a driver makes on its device. On a CUDA device: synchronise,
    the allocator's peak, and step ends as CUDA events on the stream; on the
    CPU, where only the tests drive a run, their host counterparts."""

    def __init__(self, device):
        import torch

        self.torch, self.device = torch, torch.device(device)
        self.cuda = self.device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize(self.device)

    def peak(self) -> int:
        return self.torch.cuda.max_memory_allocated(self.device) if self.cuda else 0

    def reset_peak(self) -> None:
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats(self.device)

    def mark(self):
        """A point on the device's timeline: ``periods_ms`` takes the gaps."""
        if not self.cuda:
            return time.perf_counter()
        event = self.torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def periods_ms(self, marks: list) -> list[float]:
        if not self.cuda:
            return [(b - a) * 1e3 for a, b in zip(marks[:-1], marks[1:])]
        return [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])]

    def free(self) -> None:
        gc.collect()
        if self.cuda:
            self.torch.cuda.empty_cache()


def per_layer(cell: Cell, info) -> dict:
    out = {}
    for m in cell.per_layer:
        value = load_module(HERE / "metrics" / f"{m['name']}.py").read(info)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def device_record(count: int, peak_bytes: int, trace=None) -> dict:
    import torch

    record = {"platform": "gpu", "kind": torch.cuda.get_device_name(0) if torch.cuda.is_available() else None,
              "count": count, "memory_peak_bytes": int(peak_bytes)}
    if trace is not None:
        record.update(busy_s=trace.busy_s, window_s=trace.window_s)
    return record


def breakdown(trace) -> dict:
    """The device's kinds of operation by time and its longest idle gaps,
    each gap's label followed, where the program recorded spans, by the
    innermost span at the gap's midpoint (``cudaLaunchKernel [step.forward]``)."""
    from benchmark import spans

    ops = sorted(trace.by_kind.items(), key=lambda kv: -kv[1])[:10]
    found = spans.recorded() if trace.base_ns is not None else []
    gaps = []
    for i, (label, seconds) in enumerate(trace.gaps[:10]):
        span = spans.innermost(found, trace.span_ns(sum(trace.holes[i]) / 2)) if found else None
        gaps.append([f"{label} [{span.name}]" if span is not None else label, seconds])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": gaps}
