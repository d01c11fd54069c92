"""``syncs_per_step.train``: Host-device synchronisations inside the train step
(the program's counter ``host_syncs``), mean over the traced burst's
steps."""

from portbench import spans


def read(cell):
    return spans.mean_count("otpose.train.step", "host_syncs")
