"""The peak of allocated device memory over the window of training steps
(``torch.cuda.max_memory_allocated`` after a reset at its start)."""

from benchmark import readers


def read(info):
    return readers.peak_gib(info)
