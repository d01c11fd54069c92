"""``conv_ms_per_step.train``: Device milliseconds a train step in cuDNN's
forward and backward convolutions."""

from portbench import layers


def read(cell):
    return layers.category_ms(cell, ("conv_forward", "conv_backward"))
