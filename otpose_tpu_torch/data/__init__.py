"""Data pipeline package.

``make_loader`` builds the host-path ``Loader`` (the reference's per-box CPU
pipeline, ref: PoseTrackDataset.py:388-425).  The JAX package's
device-preprocessing loader is not ported yet (ROADMAP Queue 1 item 6), so a
``cfg.TPU.DEVICE_PREPROCESS`` that resolves to one of its modes raises.
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
                drop_last: bool = False, seed: int | None = None, device="cuda"):
    """Build the configured loader for a run on ``device``.  Only the host
    path exists: the device-preprocessing modes raise instead of quietly
    taking it."""
    from otpose_tpu_torch.data.loader import Loader

    mode = resolve_device_preprocess(cfg, device)
    if mode != "off":
        raise NotImplementedError(
            f"TPU.DEVICE_PREPROCESS={cfg.TPU.DEVICE_PREPROCESS!r} resolves to {mode!r} on "
            f"{device}: device preprocessing is not ported yet (ROADMAP Queue 1 item 6); "
            "set TPU.DEVICE_PREPROCESS off for the host path")
    return Loader(dataset, batch_size, shuffle=shuffle, num_workers=cfg.WORKERS,
                  seed=cfg.SEED if seed is None else seed, drop_last=drop_last,
                  prefetch=cfg.TPU.PREFETCH_DEPTH)
