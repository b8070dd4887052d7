"""A model kind is one file, ``reference/<kind>.py``, and a port kernel's kind
one file, ``kernels/<id>.json``: a new architecture joins the benchmark,
with its kernels and a roofline that reads them, by added files alone, and
a kind with no file is named."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness, kinds, reference

UNET_CELL = "vdm-unet-c10.sample-k20-b128"
NEW_CELL = "unet2-c10.sample-k20-b128"
# the new kind's own kernel, whose name holds K8f's match, and its roofline
NEW_KERNEL = {"match": "unet2_conv3x3_f32_fwd", "kind": "K9f unet2 conv3x3", "group": "unet2 conv"}
NEW_METRIC = "unet2_conv_roofline.sample"
NEW_READER = '''from benchmark import kinds, readers


def read(info):
    return readers.roofline_percent(info, readers.conv3x3_calls(info), kinds.group("unet2 conv"), info.forwards)
'''

# run in the copy: its cell and the UNet's, the kind files they load, their
# counts, and a tiny sound sampling run of the new cell on the CPU
PROBE = f"""
import json, time, torch
from types import SimpleNamespace
from benchmark import compare, harness, kinds, readers, trace
from benchmark.tests import tiny
new, old = harness.load_cell({NEW_CELL!r}), harness.load_cell({UNET_CELL!r})
count = lambda c: (c.model.__file__, c.model.flops(c.reference_model()),
                   c.model.attention_calls(c.reference_model(), 128, c.precision, True),
                   c.model.norm_calls(c.reference_model(), 128, c.precision, True),
                   c.model.conv3x3_calls(c.reference_model(), 128, c.precision),
                   sorted(c.model.param_shapes(c.reference_model()).items()))
cell = tiny.cell({NEW_CELL!r})
drv = harness.load_module(harness.HERE / "drivers" / "sample.py")
out = drv.run(cell, seed=3400000011, seconds=0.3, trace=False, t0=time.time(), device=torch.device("cpu"))
# a traced stretch: 300 us of the new kind's kernel, 200 of K8f's, 100 of an elementwise one
names = ["void unet2_conv3x3_f32_fwd<4>(Params)", "conv3x3_f32_fwd(float const*)", "elementwise_kernel<128>"]
events = [{{"ph": "X", "cat": "kernel", "name": n, "ts": 1000 * i, "dur": d}}
          for i, (n, d) in enumerate(zip(names, (300, 200, 100)))]
info = SimpleNamespace(**{{**vars(out.info), "trace": trace.read(events, 0.003)}})
bound = info.forwards * sum(b * n for b, n in readers.conv3x3_calls(info))
print(json.dumps({{"here": str(harness.HERE), "new": count(new), "old": count(old),
                  "correct": compare.verdict(out.checks, cell.limits), "checks": out.checks,
                  "kinds": [kinds.kind(n) for n in names], "by_kind": info.trace.by_kind,
                  "read": harness.per_layer(cell, info), "bound_s": bound}}))
"""


def digests(root) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_kind_joins_by_added_files_alone(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(harness.REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    before = digests(root / "benchmark")
    bench = root / "benchmark"
    # the added files: a kind (a copy of the UNet's), its configuration, its
    # limits, a kernel of its own and a roofline of that kernel
    shutil.copy(bench / "reference" / "unet.py", bench / "reference" / "unet2.py")
    old = harness.load_cell(UNET_CELL)
    config = {**old.config, "name": "unet2-c10", "model": "unet2"}
    (bench / "configs" / "unet2-c10.json").write_text(json.dumps(config, indent=1))
    shutil.copy(bench / "limits" / f"{UNET_CELL}.json", bench / "limits" / f"{NEW_CELL}.json")
    (bench / "kernels" / "K9f.json").write_text(json.dumps(NEW_KERNEL))
    (bench / "metrics" / f"{NEW_METRIC}.py").write_text(NEW_READER)
    # and BENCHMARK.json's new entries
    spec = json.loads((root / "BENCHMARK.json").read_text())
    entry = next(c for c in spec["configs"] if c["name"] == old.config["name"])
    spec["configs"].append({**entry, "name": "unet2-c10", "file": "benchmark/configs/unet2-c10.json"})
    cell = next(w for w in spec["workloads"] if w["name"] == UNET_CELL)
    spec["workloads"].append({**cell, "name": NEW_CELL, "config": "unet2-c10"})
    for metric in spec["end_to_end"] + spec["per_layer"]:
        if UNET_CELL in metric.get("workloads", []):
            metric["workloads"].append(NEW_CELL)
    roofline = next(m for m in spec["per_layer"] if m["name"] == "conv_roofline.sample")
    spec["per_layer"].append({**roofline, "name": NEW_METRIC, "workloads": [NEW_CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    after = digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before
    assert sorted(set(after) - set(before)) == ["configs/unet2-c10.json", "kernels/K9f.json",
                                                 f"limits/{NEW_CELL}.json", f"metrics/{NEW_METRIC}.py",
                                                 "reference/unet2.py"]

    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([str(harness.REPO), os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=root, capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.splitlines()[-1])
    assert got["here"] == str(bench)
    new_file, *new_counts = got["new"]
    old_file, *old_counts = got["old"]
    assert new_file == str(bench / "reference" / "unet2.py") and old_file == str(bench / "reference" / "unet.py")
    assert new_counts == old_counts
    assert got["correct"], got["checks"]
    # the new kernel takes its own kind by the longer match, and leaves K8f's
    # and the elementwise kinds' time alone; each roofline reads its own kernel
    assert got["kinds"] == ["K9f unet2 conv3x3", "K8f conv3x3", kinds.ELEMENTWISE]
    assert got["by_kind"] == pytest.approx({"K9f unet2 conv3x3": 300e-6, "K8f conv3x3": 200e-6,
                                            kinds.ELEMENTWISE: 100e-6})
    assert got["read"][NEW_METRIC]["value"] == pytest.approx(100 * got["bound_s"] / 300e-6)
    assert got["read"]["conv_roofline.sample"]["value"] == pytest.approx(100 * got["bound_s"] / 200e-6)


@pytest.mark.parametrize("kind, says", [("no_such_kind", "benchmark/reference/no_such_kind.py is missing"),
                                        ("draws", "benchmark/reference/draws.py is no model kind's file")])
def test_a_kind_without_its_file_is_named(kind, says):
    with pytest.raises(LookupError, match=says):
        reference.model(kind)


@pytest.mark.parametrize("files, says", [
    ({"a.json": {"match": "x_fwd", "kind": "X", "group": "g"}, "b.json": {"match": "x_fwd", "kind": "Y",
                                                                          "group": "g"}}, "both match 'x_fwd'"),
    ({"a.json": {"match": "x_fwd", "kind": "X", "group": "g"}, "b.json": {"match": "x_bwd", "kind": "X",
                                                                          "group": "h"}}, "in a second group"),
])
def test_a_kernel_kind_is_named_once(tmp_path, monkeypatch, files, says):
    for name, entry in files.items():
        (tmp_path / name).write_text(json.dumps(entry))
    monkeypatch.setattr(kinds, "KERNELS", tmp_path)
    with pytest.raises(ValueError, match=says):
        kinds._port_kernels()


def test_every_kernel_file_names_one_kernel():
    for path in sorted(kinds.KERNELS.glob("*.json")):
        entry = json.loads(path.read_text())
        assert sorted(entry) == ["group", "kind", "match"], path.name
        assert kinds.kind(f"void {entry['match']}<float>(Params)") == entry["kind"]
        assert entry["kind"] in kinds.group(entry["group"])
    lengths = [len(match) for match, _, _ in kinds.PORT_KERNELS]
    assert lengths == sorted(lengths, reverse=True) and len(lengths) == len(list(kinds.KERNELS.glob("*.json")))


def test_the_kinds_found_are_the_cells_kinds():
    cells = harness.read_json(harness.REPO / "BENCHMARK.json")["workloads"]
    assert {harness.load_cell(w["name"]).kind for w in cells} == set(reference.kinds())
