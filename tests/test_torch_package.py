"""Boundaries of the port: what it imports, what it calls, where it runs."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import bsi_torch
from bsi_torch import BSI
from bsi_torch.convert import train_state_from_jax
from bsi_torch.models import DenoisingVDMUNet
from bsi_torch.nn import NyquistPositionalEmbedding

ROOT = Path(bsi_torch.__file__).resolve().parent


def _modules():
    # chip_smoke.py, the card's smoke run, is held to the same rule
    return ["bsi_torch", "chip_smoke"] + [
        m.name for m in pkgutil.walk_packages([str(ROOT)], prefix="bsi_torch.")
    ]


def test_import_pulls_in_no_jax():
    code = (
        "import importlib, sys\n"
        "before = set(sys.modules)\n"
        f"for name in {_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'bsi_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT.parent, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_library_attention_or_compile():
    for path in ROOT.rglob("*"):
        if path.suffix in (".py", ".cu", ".cuh", ".h"):
            text = path.read_text()
            for banned in ("scaled_dot_product_attention", "torch.compile", "import jax", "bsi_tpu."):
                assert banned not in text, f"{path.relative_to(ROOT.parent)} mentions {banned}"
    # chip_smoke.py times the library's calls beside the kernels, but imports
    # nothing of JAX
    smoke = (ROOT.parent / "chip_smoke.py").read_text()
    for banned in ("import jax", "from jax", "bsi_tpu."):
        assert banned not in smoke, f"chip_smoke.py mentions {banned}"


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DenoisingVDMUNet((8, 8, 3), NyquistPositionalEmbedding(8, 100), dim=32, levels=1)
    algo = BSI(data_shape=(8, 8, 3), lambda_0=1e-2, alpha_M=1e6, alpha_R=2e6, k=2)
    fn = lambda mu, t: mu
    with pytest.raises(RuntimeError, match="device='cpu'"):
        algo.sample(fn, torch.Generator(), 2)
    with pytest.raises(ValueError, match="generator"):
        algo.sample(fn, torch.Generator(), 2, device="meta")
    # the training slice: the state converter puts its tensors on the card
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_state_from_jax(object(), generator=torch.Generator())
    # the loss and the step draw on the generator's device, which must be x's
    with pytest.raises(ValueError, match="generator"):
        algo.train_loss(fn, torch.Generator(), torch.zeros(2, 8, 8, 3, device="meta"))
