"""``vit_mfu.eval``: Percent of the bf16 peak: a decoded eval batch's model
FLOPs (``counts/vit.py::eval_flops``: the ViT reference's forward on the
meta device) times the window's batches over the window's seconds."""

from portbench import counts
from portbench.counts import vit


def read(cell):
    r = cell.reading
    if not r.get("steps"):
        return None
    per_batch = vit.eval_flops(cell.config["cfg"], r["batch"])
    return per_batch * r["steps"] / (r["window_s"] * counts.PEAK_BF16) * 100
