"""``hrnet_host_ms_per_batch.eval``: Host milliseconds a batch in the program's span
``otpose.model.hrnet`` (the frame split and HRNet over 5B frames) of the
decoded eval step, median over the window's batches."""

from portbench import spans


def read(cell):
    return spans.stage_ms("otpose.eval.step", "otpose.model.hrnet")
