"""What the per-layer metrics' files (``metrics/<name>.py``) share.

Each reader takes the traced run's ``info``: the cell (whose model kind's
file, ``info.cell.model``, counts the FLOPs and the kernels' calls), its
:class:`~.trace.Trace` of the profiled stretch, the batch, the train steps
(``steps``) or the denoiser forwards (``forwards``) in that stretch, the
examples or samples of the traced window and its seconds, and the window's
peak memory. A reader with nothing to read returns None. A roofline reads
the device time of a group of the port's kernels (:func:`.kinds.group`),
which an added ``kernels/<id>.json`` can name anew.
"""

from __future__ import annotations

from . import counts, kinds


def idle_percent(info):
    if info.trace is None or info.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - info.trace.busy_s / info.trace.window_s)


def peak_gib(info):
    return info.window_peak_bytes / 2**30


def mfu_percent(info, forwards_per_item: float, items: float):
    """Model FLOPs of ``items`` examples or samples at ``forwards_per_item``
    image-forwards each, over the window, against the card's peak for the
    cell's precision."""
    flops = info.cell.model.flops(info.cell.reference_model()) * forwards_per_item * items
    return 100.0 * flops / info.window_s / counts.PEAK_FLOPS[info.cell.precision]


def roofline_percent(info, calls: list, layer: set, repeats: int):
    """The bound time of ``calls`` (``[(bound s, calls a forward)]``) times
    ``repeats``, over the device time of the kernels of ``layer``."""
    if info.trace is None:
        return None
    seconds = sum(s for k, s in info.trace.by_kind.items() if k in layer)
    if seconds <= 0:
        return None
    return 100.0 * repeats * sum(bound * n for bound, n in calls) / seconds


def attention_calls(info, backward: bool):
    return info.cell.model.attention_calls(info.cell.reference_model(), info.batch, info.cell.precision, backward)


def norm_calls(info, backward: bool):
    return info.cell.model.norm_calls(info.cell.reference_model(), info.batch, info.cell.precision, backward)


def conv3x3_calls(info):
    return info.cell.model.conv3x3_calls(info.cell.reference_model(), info.batch, info.cell.precision)


def ms_per_step(info, layer: set):
    if info.trace is None:
        return None
    seconds = sum(s for k, s in info.trace.by_kind.items() if k in layer)
    return 1e3 * seconds / info.steps if seconds > 0 else None


ATTENTION, NORM, CONV = kinds.group("attention"), kinds.group("norm"), kinds.group("conv")
OPTIMIZER = {kinds.OPTIMIZER}
ELEMENTWISE = {kinds.ELEMENTWISE, kinds.COPY}
