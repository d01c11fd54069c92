"""``vit_matmul_roofline.eval``: Percent of their roofline for the ViT
blocks' four dense products (qkv, proj, fc1, fc2): their FLOPs over the
traced burst (``counts/vit.py::product_flops``, from the configuration's
shapes) at the bf16 peak, over the device time of the dense-product kernels
that the burst's graph replays launched (``kinds/eval_vitpose.py``'s name
table)."""

from portbench import counts
from portbench.counts import vit
from portbench.kinds import eval_vitpose


def read(cell):
    device = eval_vitpose.replayed_s(cell, eval_vitpose.PRODUCT_KEYS,
                                     eval_vitpose.NOT_PRODUCT_KEYS)
    if not device:
        return None
    r = cell.reading
    frames = 5 * r["batch"] * r["summary"].steps
    return vit.product_flops(cell.config["cfg"], frames) / counts.PEAK_BF16 / device * 100
