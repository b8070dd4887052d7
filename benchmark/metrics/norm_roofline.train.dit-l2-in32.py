"""The fused norms' share of their roofline in the traced train steps:
LayerNorm+modulate (K4f, K4b) in the DiT, GroupNorm+SiLU (K7f, K7b) in the
UNet, forward and backward."""

from benchmark import readers


def read(info):
    return readers.roofline_percent(info, readers.norm_calls(info, True), readers.NORM, info.steps)
