"""``vit_host_ms_per_batch.eval``: Host milliseconds a batch in the program's
span ``otpose.model.vit`` (the frame split and the ViT estimator over 5B
frames, a CUDA graph replay once warm) of the decoded eval step, median
over the window's batches.  None for a program without that span."""

from portbench import spans


def read(cell):
    return spans.stage_ms("otpose.eval.step", "otpose.model.vit")
