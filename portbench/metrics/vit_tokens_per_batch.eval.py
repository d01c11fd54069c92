"""``vit_tokens_per_batch.eval``: Tokens the ViT estimator took a decoded eval
batch (the program's counter ``vit.tokens``, counted in the stage outside
its graph), mean over the traced burst's batches.  None for a program that
has never counted it."""

from portbench import spans


def read(cell):
    try:
        from otpose_tpu_torch.utils import profiling
    except ImportError:
        return None
    if "vit.tokens" not in getattr(profiling, "counters", dict)():
        return None
    return spans.mean_count("otpose.eval.step", "vit.tokens")
