"""``update_host_ms_per_step.train``: Host milliseconds a train step in the
program's spans ``otpose.train.update`` (the BN statistics' commit, the
collectives when distributed and the optimizer), median over the window's
steps."""

from portbench import spans


def read(cell):
    return spans.stage_ms("otpose.train.step", "otpose.train.update")
