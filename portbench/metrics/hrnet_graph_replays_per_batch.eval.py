"""``hrnet_graph_replays_per_batch.eval``: CUDA graph replays of HRNet inside the
decoded eval step (the program's counter ``hrnet_graph.replays``), mean over
the traced burst's batches.  None for a program whose eval steps have no
HRNet runner: one that has never counted an ``hrnet_graph.*`` counter."""

from portbench import spans


def read(cell):
    try:
        from otpose_tpu_torch.utils import profiling
    except ImportError:
        return None
    counted = getattr(profiling, "counters", dict)()
    if not any(name.startswith("hrnet_graph.") for name in counted):
        return None
    return spans.mean_count("otpose.eval.step", "hrnet_graph.replays")
