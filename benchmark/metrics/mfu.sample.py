"""The sampler's share of the card's peak: the model's FLOPs an image-forward
x (k + 1) forwards a sample x the samples of the traced window, over the
seconds of its calls and the peak for the cell's precision (f32 with
TF32 off: 67 TFLOP/s)."""

from benchmark import readers


def read(info):
    return readers.mfu_percent(info, info.forwards, info.samples)
