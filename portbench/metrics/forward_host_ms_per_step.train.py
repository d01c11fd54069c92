"""``forward_host_ms_per_step.train``: Host milliseconds a train step in the
program's span ``otpose.train.forward`` (the model forward, the losses and
the PCK), median over the window's steps."""

from portbench import spans


def read(cell):
    return spans.stage_ms("otpose.train.step", "otpose.train.forward")
