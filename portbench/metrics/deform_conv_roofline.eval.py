"""``deform_conv_roofline.eval``: Percent of its roofline for
``otpose::deform_conv`` (``counts.deform_conv``) in the eval step."""

from portbench import layers


def read(cell):
    return layers.roofline(cell, "otpose::deform_conv")
