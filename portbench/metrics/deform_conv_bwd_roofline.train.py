"""``deform_conv_bwd_roofline.train``: Percent of its roofline for
``otpose::deform_conv_bwd`` (``counts.deform_conv_bwd``) in the train step's
backward."""

from portbench import layers


def read(cell):
    return layers.roofline(cell, "otpose::deform_conv_bwd")
