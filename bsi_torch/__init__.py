"""bsi_torch: Bayesian Sample Inference in PyTorch, with hand-written CUDA and
Triton kernels for NVIDIA Hopper.

The PyTorch/CUDA port of ``bsi_tpu``; the JAX package is its reference. Entry
points run on the card unless the caller passes ``device="cpu"``.
"""

from .core import BFN, BSI, VDM, Discretization, LogUniform, broadcast_right

__version__ = "0.1.0"

__all__ = [
    "BSI",
    "VDM",
    "BFN",
    "Discretization",
    "LogUniform",
    "broadcast_right",
    "__version__",
]
