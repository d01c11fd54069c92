"""Prefetching data loader.

Replaces the reference's torch DataLoader worker pool (ref: train.py:43-51)
with a thread-pool pipeline: cv2 jpeg decode releases the GIL, so threads
saturate host IO while the device computes; batches are staged ``prefetch``
deep.  Deterministic per-epoch shuffling and per-sample RNG streams replicate
``worker_init_reset_seed`` determinism (ref: thirdparty/utils/data_utils.py:14-21).
The port's copy of ``otpose_tpu/data/loader.py``, single process, without
the C++ batch kernels (ROADMAP Queue 1 item 6) and without the multi-process
row blocks (item 7).  ``set_start_iteration`` restarts a pass mid-epoch for
an iteration-exact resume.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from otpose_tpu_torch.data.pipeline import collate_host_samples


class Loader:
    def __init__(self, dataset, batch_size: int, *, shuffle: bool = False,
                 num_workers: int = 4, seed: int = 8888, drop_last: bool = False,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.epoch = 0
        self._start_iteration = 0

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
            return self.dataset.get_sample_host(int(idx), rng=rng)

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
