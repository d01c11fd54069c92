"""Prefetching data loader.

Replaces the reference's torch DataLoader worker pool (ref: train.py:43-51)
with a thread-pool pipeline: cv2 jpeg decode releases the GIL, so threads
saturate host IO while the device computes; batches are staged ``prefetch``
deep.  Deterministic per-epoch shuffling and per-sample RNG streams replicate
``worker_init_reset_seed`` determinism (ref: thirdparty/utils/data_utils.py:14-21).
The port's copy of ``otpose_tpu/data/loader.py``: with ``native_host``
(the default, as in the JAX package) each sample's warp, normalisation and
targets go through the native IO library (``data/native.py``) when it
loads, the JAX package's native path bit for bit; without it, or for a
dataset whose frames are not JPEG files, through the dataset's cv2 path.
The frames themselves are read by the dataset's ``read_frame`` either way
(``decoder``).  ``set_start_iteration`` restarts a pass mid-epoch for an
iteration-exact resume.

Multi-process training (``process_count > 1``): ``batch_size`` is the
global batch; every rank draws the same shuffled index batches (same seed
and epoch) and loads only its rows, ``parallel/distributed.py::local_rows``
(with ``accum_steps`` micro-batches, its share of each global micro-batch).
A sample's augmentation is keyed by its index, so it is the same whichever
rank loads it.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from otpose_tpu_torch.data import native as native_io
from otpose_tpu_torch.data.pipeline import collate_host_samples
from otpose_tpu_torch.parallel.distributed import local_rows


class Loader:
    def __init__(self, dataset, batch_size: int, *, shuffle: bool = False,
                 num_workers: int = 4, seed: int = 8888, drop_last: bool = False,
                 prefetch: int = 2, native_host: bool = True, process_index: int = 0,
                 process_count: int = 1, accum_steps: int = 1):
        # native_host: the warp, normalisation and targets through the native
        # library's batch functions when it loads (float bilinear: up to a
        # uint8 step from cv2's fixed point; PoseTrackDataset.get_sample_host)
        self.native_host = native_host
        # how frames are decoded: the host loader reads them with the
        # dataset's read_frame whatever warps them (DeviceLoader chooses)
        self.decoder = "read_frame"
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.epoch = 0
        self._start_iteration = 0
        self.process_index, self.process_count = process_index, process_count
        self._rows = None
        if process_count > 1:
            if not drop_last:
                raise ValueError("multi-process loading needs drop_last=True (every rank "
                                 "takes its share of full batches)")
            self._rows = local_rows(batch_size, accum_steps, process_index, process_count)

    @property
    def host_warp(self) -> str:
        """What warps on the host: "native" (the native library) or the
        dataset's ``warp_frame``."""
        native = (self.native_host and getattr(self.dataset, "reads_jpeg_files", False)
                  and native_io.is_available())
        return "native" if native else "warp_frame"

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def set_start_iteration(self, k: int):
        """Skip the first ``k`` batches of the next pass only (an
        iteration-exact resume).  Exact because the epoch's shuffle and each
        sample's augmentation draw are keyed by (seed, epoch, index), not by
        how many samples came before: a skipped batch consumes nothing."""
        self._start_iteration = int(k)

    def _index_batches(self):
        n = len(self.dataset)
        idxs = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(idxs)
        batches = [idxs[i:i + self.batch_size]
                   for i in range(0, n, self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        if self._rows is not None:
            batches = [b[self._rows] for b in batches]
        start, self._start_iteration = self._start_iteration, 0
        return batches[start:]

    def __iter__(self) -> Iterator:
        batches = self._index_batches()
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def load_sample(args):
            bidx, within, idx = args
            rng = np.random.RandomState(
                (self.seed + self.epoch * 1_000_003 + idx) % (2 ** 31))
            return self.dataset.get_sample_host(int(idx), rng=rng,
                                                native_ok=self.native_host)

        def producer():
            # Any sample-load failure is forwarded to the consumer instead of
            # silently killing this thread (which would hang out_q.get()).
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for bidx, batch_idxs in enumerate(batches):
                        if stop.is_set():
                            break
                        args = [(bidx, j, idx) for j, idx in enumerate(batch_idxs)]
                        samples = list(pool.map(load_sample, args))
                        out_q.put(collate_host_samples(samples))
            except BaseException as e:  # noqa: BLE001 — re-raised in consumer
                out_q.put(e)
            finally:
                out_q.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # drain so the producer can exit
            while thread.is_alive():
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    break
