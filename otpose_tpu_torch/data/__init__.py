"""Data pipeline package.

``make_loader`` is the entry point: it builds the device-preprocessing
``DeviceLoader`` (the host reads frames, the run's device does the warp,
normalisation and targets) or the host-path ``Loader`` (the reference's
per-box CPU pipeline, ref: PoseTrackDataset.py:388-425) from
``cfg.TPU.DEVICE_PREPROCESS``, as the JAX package does.
"""

from __future__ import annotations


def resolve_device_preprocess(cfg, device) -> str:
    """Resolve cfg.TPU.DEVICE_PREPROCESS to "off" | "crops" | "full", as the
    JAX package does: "auto" is "crops" on an accelerator and "off" on the
    CPU; "on" is an alias for "crops"."""
    mode = str(cfg.TPU.DEVICE_PREPROCESS).lower()
    if mode in ("on", "true", "1", "crops"):
        return "crops"
    if mode == "full":
        return "full"
    if mode in ("off", "false", "0"):
        return "off"
    if mode != "auto":
        raise ValueError(f"TPU.DEVICE_PREPROCESS must be auto/off/crops/full,"
                         f" got {cfg.TPU.DEVICE_PREPROCESS!r}")
    return "off" if str(device).startswith("cpu") else "crops"


def make_loader(cfg, dataset, batch_size: int, *, shuffle: bool,
                drop_last: bool = False, seed: int | None = None, device="cuda",
                process_shard: bool = False):
    """Build the configured loader for a run on ``device``: the
    ``DeviceLoader`` in mode "crops" or "full" (its batches are tensors on
    ``device``), the host ``Loader`` for "off".

    ``process_shard=True`` (multi-process training): ``batch_size`` is the
    global batch and this rank loads only its data group's rows of each
    batch (``parallel/distributed.py::local_rows`` with ``TPU.ACCUM_STEPS``:
    the loader's process index and count are the data index and the number
    of data groups; the ranks of a seq group load the same rows).
    Eval loaders keep full batches on every rank (the eval shard function
    splits them), so the host's bookkeeping sees every row."""
    from otpose_tpu_torch.data.loader import Loader

    kwargs = dict(shuffle=shuffle, num_workers=cfg.WORKERS,
                  seed=cfg.SEED if seed is None else seed, drop_last=drop_last,
                  prefetch=cfg.TPU.PREFETCH_DEPTH)
    if process_shard:
        from otpose_tpu_torch.parallel.distributed import data_info

        index, groups = data_info()
        if groups > 1:
            kwargs.update(process_index=index, process_count=groups,
                          accum_steps=cfg.TPU.ACCUM_STEPS)
    mode = resolve_device_preprocess(cfg, device)
    if mode != "off":
        from otpose_tpu_torch.data.device_loader import DeviceLoader

        return DeviceLoader(dataset, batch_size, mode=mode,
                            max_frame_hw=tuple(cfg.TPU.MAX_FRAME_HW),
                            device_prefetch=cfg.TPU.PREFETCH_DEPTH, device=device, **kwargs)
    return Loader(dataset, batch_size, **kwargs)


def describe_loader(loader) -> str:
    """One line for a run's log: the loader, its mode and how it decodes
    (and, for the host loader, what warps)."""
    name = type(loader).__name__
    if hasattr(loader, "decoder_detail"):
        return f"{name} ({loader.mode}; frames decoded by {loader.decoder_detail})"
    return (f"{name} (host; frames decoded by {getattr(loader, 'decoder', '?')}, warped "
            f"and targets drawn by {getattr(loader, 'host_warp', '?')})")
