"""Several processes, one GPU each (counterpart of ``otpose_tpu/parallel/``)."""
