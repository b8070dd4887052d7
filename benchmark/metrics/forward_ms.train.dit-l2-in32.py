"""Device ms a train step between the events of the program's
``step.forward`` span: the noise draws, the dropout reseed and the loss's
forward through the denoiser."""

from benchmark import spans


def read(info):
    return spans.device_ms(spans.recorded(), "step.forward", "step")
