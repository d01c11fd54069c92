"""``fused_mlp_roofline.eval``: Percent of its roofline for
``otpose::fused_mlp`` (``counts.fused_mlp``), as
``fused_attn_roofline.eval``."""

from portbench import layers


def read(cell):
    return layers.roofline(cell, "otpose::fused_mlp")
