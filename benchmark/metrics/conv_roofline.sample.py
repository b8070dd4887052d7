"""K8f's share of its roofline in the traced sampling call: the bound time of
every 3x3 convolution of the forwards, from the shapes (``encode`` at the
model's input channels, not the kernel's padded ones), over the device time
of K8f's kernel. Each call is bound by its f32 operations at 67 TFLOP/s."""

from benchmark import readers


def read(info):
    return readers.roofline_percent(info, readers.conv3x3_calls(info), readers.CONV, info.forwards)
