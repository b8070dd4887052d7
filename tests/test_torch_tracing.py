"""The program's spans and counters (``bsi_torch/utils/profiling.py``): off
without a profiler, the span tree of a train step and of a sampling call
under one, and their place on the exported trace's clock.

The ``cuda`` test runs on the card:
``python -m pytest --noconftest tests/test_torch_tracing.py -m cuda``.
"""

from __future__ import annotations

import json

import pytest
import torch
from torch_tiny import tiny_trainer

from bsi_torch.utils import profiling

CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def fresh():
    profiling.clear()
    yield
    profiling.clear()


def one_step(trainer):
    batches = trainer.data.train_batches()
    trainer.state, metrics = trainer._train_step(trainer.state, trainer._to_device(next(batches)))
    return metrics


def state_tensors(trainer) -> dict:
    s = trainer.state
    out = {f"params/{k}": v for k, v in s.params.items()}
    out.update({f"ema/{k}": v for k, v in s.ema_params.items()})
    out.update({f"mu/{k}": v for k, v in s.opt_state.mu.items()})
    out.update({f"nu/{k}": v for k, v in s.opt_state.nu.items()})
    return out


def dit(tmp_path, name: str):
    trainer = tiny_trainer(tmp_path, model="dit", name=name)
    trainer.state = trainer.init_state()
    return trainer


def test_off_records_nothing_and_the_step_is_the_profiled_one_bit_for_bit(tmp_path):
    plain, traced = dit(tmp_path, "plain"), dit(tmp_path, "traced")
    off = one_step(plain)
    assert not profiling.enabled() and profiling.spans() == [] and profiling.counters() == {}
    with torch.profiler.profile(activities=CPU):
        on = one_step(traced)
    assert profiling.spans() and profiling.counters()
    assert plain.state.step == traced.state.step == 1
    for key in off:
        assert torch.equal(off[key], on[key]), key
    a, b = state_tensors(plain), state_tensors(traced)
    assert a.keys() == b.keys()
    for key in a:
        assert torch.equal(a[key], b[key]), key


def test_the_span_tree_of_a_train_step_and_a_sampling_call(tmp_path):
    trainer = dit(tmp_path, "run")
    with torch.profiler.profile(activities=CPU):
        one_step(trainer)
        trainer.sample_fn(trainer.state, torch.Generator().manual_seed(0), 2)
    spans = profiling.spans()
    names = [s.name for s in spans]
    parents = [None if s.parent is None else spans[s.parent].name for s in spans]
    assert names[:6] == ["data.batch", "train.to_device", "step", "step.forward", "step.backward", "step.update"]
    assert parents[:6] == [None, None, None, "step", "step", "step"]
    assert spans[2].attrs == {"step": 0}
    assert all(s.end_ns is not None and s.start_ns <= s.end_ns for s in spans)
    assert all(s.device_ms is None for s in spans)  # no device events on the CPU
    steps = [s for s in spans if s.name == "sample.step"]
    denoise = [s for s in spans if s.name == "sample.denoise"]
    assert trainer.algorithm.k == 3 and [s.attrs["i"] for s in steps] == [0, 1, 2]
    assert len(denoise) == 4
    assert all(parents[spans.index(s)] == "sample" for s in steps)
    assert [parents[spans.index(s)] for s in denoise] == ["sample.step"] * 3 + ["sample"]


def test_spans_sit_on_the_exported_traces_clock(tmp_path):
    trainer = dit(tmp_path, "run")
    with torch.profiler.profile(activities=CPU) as prof:
        one_step(trainer)
        trainer.sample_fn(trainer.state, torch.Generator().manual_seed(0), 2)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    exported = json.loads(path.read_text())
    base = exported["baseTimeNanoseconds"]
    marks = sorted((e["ts"], e["name"]) for e in exported["traceEvents"] if e.get("cat") == "user_annotation")
    spans = profiling.spans()
    assert [name for _, name in marks] == [s.name for s in spans]
    for (ts, name), s in zip(marks, spans):
        assert abs((s.start_ns - base) / 1e3 - ts) < 1000, name


def test_counters_and_spans_record_only_while_a_profiler_runs():
    with profiling.span("outer", k=1):
        profiling.count("c")
    assert profiling.spans() == [] and profiling.counters() == {}
    with torch.profiler.profile(activities=CPU):
        with profiling.span("outer", k=1):
            with profiling.span("inner"):
                profiling.count("c", 2)
            profiling.count("c")
    spans = profiling.spans()
    assert [(s.name, s.parent, s.attrs) for s in spans] == [("outer", None, {"k": 1}), ("inner", 0, {})]
    assert profiling.counters() == {"c": 3}


@pytest.mark.cuda
def test_device_spans_and_kernel_routes_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from bsi_torch.ops.ln_modulate import layernorm_modulate

    x = torch.randn(2, 128, 256, device="cuda", requires_grad=True)
    shift, scale = torch.zeros(2, 256, device="cuda"), torch.zeros(2, 256, device="cuda")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        with profiling.span("work", device=x.device):
            layernorm_modulate(x, shift, scale).sum().backward()
        torch.cuda.synchronize()
    (work,) = profiling.spans()
    assert work.device_ms is not None and work.device_ms > 0
    assert profiling.counters() == {"ops.K4f.kernel": 1, "ops.K4b.kernel": 1}
