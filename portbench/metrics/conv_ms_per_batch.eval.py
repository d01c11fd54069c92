"""``conv_ms_per_batch.eval``: Device milliseconds a decoded eval batch in
cuDNN's convolutions and their layout transposes (the convolution category
of the traced burst)."""

from portbench import layers


def read(cell):
    return layers.category_ms(cell, ("convolution",))
