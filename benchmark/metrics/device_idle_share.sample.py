"""The device's idle share of the traced sampling call: 1 - (union of the
device's operation intervals) / the profiled stretch."""

from benchmark import readers


def read(info):
    return readers.idle_percent(info)
