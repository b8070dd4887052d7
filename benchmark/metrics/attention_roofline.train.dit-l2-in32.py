"""Attention's share of its roofline in the traced train steps: the bound
time of every attention forward and backward, from the shapes, over the
device time of the kernels that carry them (K2 and K3 in the DiT)."""

from benchmark import readers


def read(info):
    return readers.roofline_percent(info, readers.attention_calls(info, True), readers.ATTENTION, info.steps)
