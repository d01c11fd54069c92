"""``deform_conv_roofline.train``: Percent of its roofline for
``otpose::deform_conv`` (``counts.deform_conv``) in the train step's
forward."""

from portbench import layers


def read(cell):
    return layers.roofline(cell, "otpose::deform_conv")
