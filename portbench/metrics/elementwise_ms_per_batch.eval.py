"""``elementwise_ms_per_batch.eval``: Device milliseconds a decoded eval batch
in elementwise kernels and copies: everything the kernel categories do not
name (BN affines, ReLUs, adds, casts)."""

from portbench import layers


def read(cell):
    return layers.category_ms(cell, ("elementwise",))
