"""``backward_host_ms_per_step.train``: Host milliseconds a train step in the
program's span ``otpose.train.backward`` (the autograd engine's backward,
which the step's thread waits on), median over the window's steps."""

from portbench import spans


def read(cell):
    return spans.stage_ms("otpose.train.step", "otpose.train.backward")
