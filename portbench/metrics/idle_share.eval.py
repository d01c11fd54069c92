"""``idle_share.eval``: Percent of the traced burst's window in which no
kernel, copy or set ran on the device."""

from portbench import layers


def read(cell):
    return layers.idle_share(cell)
