"""The whole train step's share of the card's peak: 3 x the model's FLOPs an
image-forward x the examples of the traced window, over its seconds and
the peak for the cell's precision. Recomputation is not counted."""

from benchmark import readers


def read(info):
    return readers.mfu_percent(info, 3.0, info.examples)
