"""Device ms of one denoiser forward of the traced sampling call: the
program's ``sample.denoise`` spans (each sampler step's and the final one,
k + 1 a call) between their events, over their count."""

from benchmark import spans


def read(info):
    return spans.device_ms(spans.recorded(), "sample.denoise", "sample.denoise")
