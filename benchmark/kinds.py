"""Which layer a device kernel belongs to, by its name.

Started from ``bsi_torch/profile_sampling.py::_kind``. The port's kernels
are told apart by the names of their CUDA and Triton functions, each
kernel's in a file of its own, ``kernels/<id>.json``, so that a kernel
joins by an added file; they are matched before the libraries' names,
which "conv3x3_f32_fwd" holds one of. cuBLAS's and cuDNN's kernels are
told by their libraries' names; the optimizer's and the EMA's by the
``foreach`` (multi-tensor) kernels they alone launch.
"""

from __future__ import annotations

import json
from pathlib import Path

KERNELS = Path(__file__).resolve().parent / "kernels"


def _port_kernels() -> tuple:
    """Every ``kernels/<id>.json`` (``{"match", "kind", "group"}``: a
    substring of the kernel's name, its kind, and the group of kinds that a
    roofline reads), longest ``match`` first, so that the most specific
    match wins whatever files a later change adds: a new kernel whose name
    holds "conv3x3_f32_fwd" takes its own kind by a longer match."""
    found, seen, groups = [], {}, {}
    for path in sorted(KERNELS.glob("*.json")):
        with open(path) as f:
            entry = json.load(f)
        match, label, group = entry["match"], entry["kind"], entry["group"]
        if match in seen:
            raise ValueError(f"benchmark/kernels/{path.name} and {seen[match]} both match {match!r}")
        if groups.setdefault(label, group) != group:
            raise ValueError(f"benchmark/kernels/{path.name} puts {label!r} in a second group, {group!r}")
        seen[match] = path.name
        found.append((match, label, group))
    return tuple(sorted(found, key=lambda e: (-len(e[0]), e[0])))


PORT_KERNELS = _port_kernels()


def group(name: str) -> set:
    """The kinds of the port's kernels in group ``name`` (``attention``,
    ``norm``, ``conv``, or one that an added kernel's file names)."""
    return {label for _, label, g in PORT_KERNELS if g == name}


MATMUL = "matmul and convolution (cuBLAS, cuDNN)"
OPTIMIZER = "optimizer, clipping and EMA (foreach)"
COPY = "casts and copies"
ELEMENTWISE = "elementwise, reductions and the rest"
TRANSFER = "memcpy and memset"
# cuDNN runs f32 3x3 convolutions (TF32 off) by FFT where K8f does not take
# them: its product in the frequency domain is ``pointwise_mult_and_sum_complex``
_LIBRARY = ("nvjet", "gemm", "gemv", "xmma", "cutlass", "cudnn", "conv", "wgrad", "dgrad", "fprop", "winograd",
            "fft", "pointwise_mult_and_sum", "flip_filter")


def kind(name: str, category: str = "kernel") -> str:
    if category != "kernel":
        return TRANSFER
    for key, label, _ in PORT_KERNELS:
        if key in name:
            return label
    low = name.lower()
    if any(key in low for key in _LIBRARY):
        return MATMUL
    if "foreach" in low or "multi_tensor" in low:
        return OPTIMIZER
    if "copy_kernel" in low:
        return COPY
    return ELEMENTWISE
