"""``mfu.eval``: Percent of the bf16 peak: the decoded eval batch's model FLOPs
(``counts/flops.py``, the forward) times the window's batches over the
window's seconds."""

from portbench import layers


def read(cell):
    return layers.mfu(cell)
