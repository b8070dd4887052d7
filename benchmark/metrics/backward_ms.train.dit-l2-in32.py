"""Device ms a train step between the events of the program's
``step.backward`` span: ``torch.autograd.grad`` through the denoiser (its
kernels all run on the stream the events bracket)."""

from benchmark import spans


def read(info):
    return spans.device_ms(spans.recorded(), "step.backward", "step")
