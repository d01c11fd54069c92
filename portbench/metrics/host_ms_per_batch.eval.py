"""``host_ms_per_batch.eval``: Host milliseconds in the decoded eval step's
call (``make_decoded_eval_step``), before any wait: the mean over the
window's batches, by the harness's clock."""

from portbench import layers


def read(cell):
    return layers.host_ms(cell)
