"""The fused norms' share of their roofline in the traced sampling call:
K4f in the DiT, K7f in the UNet."""

from benchmark import readers


def read(info):
    return readers.roofline_percent(info, readers.norm_calls(info, False), readers.NORM, info.forwards)
