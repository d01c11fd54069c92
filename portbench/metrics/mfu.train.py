"""``mfu.train``: Percent of the bf16 peak: the train step's model FLOPs
(``counts/flops.py``, forward, losses and backward) times the window's steps
over the window's seconds."""

from portbench import layers


def read(cell):
    return layers.mfu(cell)
