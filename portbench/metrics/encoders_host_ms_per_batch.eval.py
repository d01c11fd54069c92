"""``encoders_host_ms_per_batch.eval``: Host milliseconds a batch in the program's
span ``otpose.model.encoders`` (heatmap fusion, the flow encoder and both
temporal encoders) of the decoded eval step, median over the window's
batches."""

from portbench import spans


def read(cell):
    return spans.stage_ms("otpose.eval.step", "otpose.model.encoders")
