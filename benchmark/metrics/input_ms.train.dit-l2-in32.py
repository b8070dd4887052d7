"""Host ms a train step inside the program's input spans: ``data.batch``
(the data module's gather, uint8 to f32 and flip) and ``train.to_device``
(``Trainer._to_device``: ``pin_memory`` and the copy's launch)."""

from benchmark import spans


def read(info):
    return spans.host_ms(spans.recorded(), spans.INPUT, "step")
