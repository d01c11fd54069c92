"""``launches_per_batch.eval``: CUDA kernel launches a decoded eval batch: the
kernels of the traced burst over its batches."""

from portbench import layers


def read(cell):
    return layers.launches(cell)
