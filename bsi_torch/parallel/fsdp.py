"""FSDP: the train state's large leaves sharded over the data axis (ZeRO-3).

Counterpart of ``bsi_tpu/parallel/fsdp.py``. The JAX package shards the
state's leaves and lets XLA insert the all-gathers and reduce-scatters; here
the train step does it: it all-gathers the full parameters before the
forward and reduce-scatters the gradients, averaged over the data group, so
that the optimizer and the EMA update only this rank's shards
(``bsi_torch/parallel/layout.py``). ``params``, ``ema_params`` and the Adam
moments hold only their shards.

The leaf policy is the JAX package's (:func:`assign_zero3_dim`), applied to
the torch shapes: a ``Linear`` weight is ``[out, in]`` where flax's kernel is
``[in, out]``, and a conv weight OIHW where flax's is HWIO, so the dim that
shards is named differently but is the same axis of the same array. Ties
between equal dims break in the flax array's order (:data:`FLAX_ORDER`), as
the JAX package breaks them.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

from .mesh import DATA_AXIS

MIN_SIZE = 2**14
# A torch leaf's dims in the order of the flax array's: a Dense weight is the
# kernel transposed, a conv weight (OIHW) the HWIO kernel permuted.
FLAX_ORDER = {2: (1, 0), 4: (2, 3, 1, 0)}


def assign_zero3_dim(spec: list, shape, axis_size: int, min_size: int = MIN_SIZE) -> list:
    """Put ``DATA_AXIS`` on the largest free dim of ``spec`` (in place) that
    ``axis_size`` divides, when the leaf has at least ``min_size`` elements:
    the ZeRO-3 leaf policy, shared with the tensor-parallel composition.
    Ties go to the dim first in the flax array's order."""
    if not shape or math.prod(shape) < min_size:
        return spec
    order = FLAX_ORDER.get(len(shape), range(len(shape)))
    for i in sorted(order, key=lambda i: -shape[i]):
        if spec[i] is None and shape[i] % axis_size == 0:
            spec[i] = DATA_AXIS
            break
    return spec


def fsdp_plan(params: Mapping[str, object], data_size: int, min_size: int = MIN_SIZE) -> dict[str, Optional[int]]:
    """Each leaf's sharded dim over the data axis, or None (replicated)."""
    plan = {}
    for name, p in params.items():
        shape = tuple(p.shape)
        spec = assign_zero3_dim([None] * len(shape), shape, data_size, min_size)
        plan[name] = spec.index(DATA_AXIS) if DATA_AXIS in spec else None
    return plan
