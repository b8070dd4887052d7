"""Plain PyTorch reference of what the benchmark's cells run.

The denoisers (forward; the backward is autograd's), the BSI training loss
with EDM preconditioning, the sampler's steps, AdamW with global-norm
clipping and the EMA, written from the models' and the algorithm's
definitions in plain ``torch`` operations, f32 by default. It imports
neither ``jax``, the JAX package nor ``bsi_torch``: it takes the
benchmark's weights, data and seeds and works out every draw again
(:mod:`.draws`).

**One file a model kind.** A configuration's ``"model"`` names its kind,
and ``reference/<kind>.py`` is everything the benchmark knows of that
architecture: the reference's sizes from the configuration file
(``sizes``), its leaves (``param_shapes``), its forward (``forward``), its
FLOPs an image-forward (``flops``), the calls of the port's kernels a
forward with each one's bound (``attention_calls``, ``norm_calls``,
``conv3x3_calls``), a train step's dropout draws (``dropout_plan``), the
leaves its weights draw small (``SMALL_WEIGHTS``) and the tiny sizes of the
CPU tests (``TINY``). The rest of the benchmark finds the file by the
kind's name (:func:`model`), so a new architecture joins by added files.

A :class:`~.layers.Precision` turns the products (dense layers,
convolutions, attention's two products) into the control's lower
precision: fp8 operands for the bf16 cells; the f32 cells' control is TF32,
which is a flag of the backends (:func:`~.layers.tf32`).
"""

from __future__ import annotations

import importlib
from pathlib import Path

HERE = Path(__file__).resolve().parent
KIND = ("sizes", "param_shapes", "forward", "flops", "attention_calls", "norm_calls", "conv3x3_calls",
        "dropout_plan", "SMALL_WEIGHTS", "TINY")


def model(kind: str):
    """The file of model kind ``kind``, ``reference/<kind>.py``, loaded;
    raises naming the file where it is missing or lacks a name of
    :data:`KIND`."""
    path = HERE / f"{kind}.py"
    if not kind.isidentifier() or not path.is_file():
        raise LookupError(f"no model kind {kind!r}: benchmark/reference/{kind}.py is missing")
    module = importlib.import_module(f".{kind}", __name__)
    missing = [name for name in KIND if not hasattr(module, name)]
    if missing:
        raise LookupError(f"benchmark/reference/{kind}.py is no model kind's file: it lacks {missing}")
    return module


def kinds() -> list[str]:
    """The model kinds whose files this folder holds."""
    found = []
    for path in sorted(HERE.glob("*.py")):
        if path.stem != "__init__" and all(hasattr(importlib.import_module(f".{path.stem}", __name__), name)
                                           for name in KIND):
            found.append(path.stem)
    return found


def shared_sizes(config: dict) -> dict:
    """The sizes every kind's ``sizes`` starts from: ``data_shape``, the
    model's ``dropout`` and its Fourier features' ``(n_min, n_max)`` or None."""
    m = config["program"]["task"]["model"]
    ff = m.get("fourier_features")
    return {"data_shape": tuple(config["data_shape"]), "dropout": m.get("dropout"),
            "fourier": (ff["n_min"], ff["n_max"]) if ff else None}
