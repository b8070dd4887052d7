"""Attention's share of its roofline in the traced sampling call: the bound
time of every attention forward, from the shapes, over the device time of
the kernels that carry them (K1 in the UNet, K2 in the DiT)."""

from benchmark import readers


def read(info):
    return readers.roofline_percent(info, readers.attention_calls(info, False), readers.ATTENTION, info.forwards)
