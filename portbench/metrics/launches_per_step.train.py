"""``launches_per_step.train``: CUDA kernel launches a train step: the kernels
of the traced burst over its steps."""

from portbench import layers


def read(cell):
    return layers.launches(cell)
