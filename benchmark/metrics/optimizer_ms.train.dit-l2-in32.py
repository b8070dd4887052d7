"""Device ms a train step of the AdamW, clipping and EMA kernels (the
multi-tensor ``foreach`` kernels only they launch)."""

from benchmark import readers


def read(info):
    return readers.ms_per_step(info, readers.OPTIMIZER)
