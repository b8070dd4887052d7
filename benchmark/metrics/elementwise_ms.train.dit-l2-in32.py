"""Device ms a train step of the kernels that are neither matmuls nor
convolutions, nor the port's kernels, nor the optimizer's: the eager
elementwise chains, reductions, casts and copies."""

from benchmark import readers


def read(info):
    return readers.ms_per_step(info, readers.ELEMENTWISE)
