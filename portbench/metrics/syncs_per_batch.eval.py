"""``syncs_per_batch.eval``: Host-device synchronisations inside the decoded eval
step (the program's counter ``host_syncs``), mean over the traced burst's
batches."""

from portbench import spans


def read(cell):
    return spans.mean_count("otpose.eval.step", "host_syncs")
