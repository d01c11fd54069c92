"""``host_ms_per_step.train``: Host milliseconds in the train step's call
(``make_train_step``): the mean over the window's steps, by the harness's
clock."""

from portbench import layers


def read(cell):
    return layers.host_ms(cell)
