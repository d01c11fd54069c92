"""``fused_attn_roofline.eval``: Percent of its roofline: the least time of
each ``otpose::fused_attn`` call of the traced burst (``counts.fused_attn``
from its recorded shapes) over the device time of the kernels the call
launched."""

from portbench import layers


def read(cell):
    return layers.roofline(cell, "otpose::fused_attn")
