"""Device idle ms a train step in the traced stretch's idle holes whose
midpoint lies inside one of the program's input spans (``data.batch``, the
data module's gather; ``train.to_device``, ``pin_memory`` and the copy's
launch): the time the device waited on the input path."""

from benchmark import spans


def read(info):
    return spans.idle_ms(info.trace, spans.recorded(), spans.INPUT, "step")
