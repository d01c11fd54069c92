"""``elementwise_ms_per_step.train``: Device milliseconds a train step in
elementwise kernels and copies, BN statistics and the optimizer among them:
everything the kernel categories do not name."""

from portbench import layers


def read(cell):
    return layers.category_ms(cell, ("elementwise",))
