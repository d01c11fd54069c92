"""``vit_attention_roofline.eval``: Percent of its roofline for the ViT's fused
attention: its least time over the traced burst (``counts/vit.py::
attention``: q, k, v and the output a layer and frame at the memory rate, or
its products at the bf16 peak, whichever is longer) over the device time of
the attention kernels that the burst's graph replays launched."""

from portbench.counts import vit
from portbench.kinds import eval_vitpose


def read(cell):
    device = eval_vitpose.replayed_s(cell, eval_vitpose.ATTENTION_KEYS)
    if not device:
        return None
    r = cell.reading
    frames = 5 * r["batch"] * r["summary"].steps
    return vit.attention(cell.config["cfg"], frames, r["dtype"]).least_s() / device * 100
