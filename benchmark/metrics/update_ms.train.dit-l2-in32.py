"""Device ms a train step between the events of the program's
``step.update`` span: the gradients' norm, clipping, AdamW, the EMA update
and its switch."""

from benchmark import spans


def read(info):
    return spans.device_ms(spans.recorded(), "step.update", "step")
