"""Batched, prefetching input pipeline, as the JAX package's
`data/pipeline.py` builds it.

Host side: threaded decode and paired crop into uint8 batches, with an
optional decoded-image RAM cache; device side: `data.augment` inside the
train step. `prefetch` keeps batches decoded (and copied to the device)
ahead of the consumer in a background thread. `to_device` copies a batch
through pinned host memory without blocking the host.

With the same seeds the batches are the JAX Loader's batches byte for byte:
the per-epoch order comes from `default_rng((seed, epoch))` and each
position's crop from `default_rng((seed, epoch, 2, position))`.
`process_index`/`process_count` select this process's share of every
global batch (default: the whole batch, one process).
"""

from __future__ import annotations

import concurrent.futures as cf
import queue
import threading
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from curl_tpu_torch.data import dataset as ds


class Loader:
    """Iterates dicts of stacked numpy arrays.

    Args:
      records: examples (from `dataset.select_records`).
      batch_size: *global* batch size (divided across processes).
      crop: (H, W) crop applied host-side; random with pad-if-needed when
        `train`, center otherwise.
      train: random crops + reshuffling each epoch.
      seed: shuffle/crop seed.
      drop_last: drop the trailing partial batch (the default for train,
        so every step sees the same shapes).
      num_threads: decode thread pool size.
      process_index/process_count: this process's share of the global
        batch (default 0 of 1: the whole batch).
      cache_mb: decoded-image RAM cache budget (0 = off). Images are
        cached fully decoded, pre-crop; once the budget is full, remaining
        images keep decoding from disk. Epochs revisit every image, so
        "first-N-that-fit" is the right policy (no eviction). Where decode
        bounds training, this removes it for datasets that fit.
    """

    def __init__(
        self,
        records: Sequence[ds.Record],
        batch_size: int,
        crop: Optional[tuple[int, int]] = (256, 256),
        train: bool = False,
        seed: int = 0,
        drop_last: Optional[bool] = None,
        num_threads: int = 8,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
        cache_mb: int = 0,
    ):
        self.records = list(records)
        self.global_batch = batch_size
        self.crop = crop
        self.train = train
        self.seed = seed
        self.drop_last = train if drop_last is None else drop_last
        self.num_threads = num_threads
        self.process_index = 0 if process_index is None else process_index
        self.process_count = 1 if process_count is None else process_count
        if batch_size % self.process_count:
            raise ValueError(
                f"global batch {batch_size} not divisible by process count {self.process_count}"
            )
        self.local_batch = batch_size // self.process_count
        self.epoch = 0
        self._cache: Optional[dict[int, dict]] = {} if cache_mb > 0 else None
        self._cache_limit = cache_mb * 1024 * 1024
        self._cache_bytes = 0
        self._cache_lock = threading.Lock()
        self.cache_hits = 0
        self.cache_misses = 0

    def cache_stats(self) -> dict[str, int]:
        """Decoded-image cache observability: hits/misses/resident bytes."""
        with self._cache_lock:
            return {
                "hits": self.cache_hits,
                "misses": self.cache_misses,
                "entries": len(self._cache or ()),
                "bytes": self._cache_bytes,
            }

    def _load_record(self, global_idx: int) -> dict[str, np.ndarray]:
        if self._cache is None:
            return ds.load_example(self.records[global_idx])
        with self._cache_lock:
            hit = self._cache.get(global_idx)
            if hit is not None:
                self.cache_hits += 1
            else:
                self.cache_misses += 1
        if hit is not None:
            return hit
        ex = ds.load_example(self.records[global_idx])
        size = sum(v.nbytes for v in ex.values() if isinstance(v, np.ndarray))
        with self._cache_lock:
            # Duplicate indices in one wrapped eval batch can race here: both
            # threads decode, but only the first may account the bytes, or the
            # budget shrinks by double-counting the same key.
            if (
                global_idx not in self._cache
                and self._cache_bytes + size <= self._cache_limit
            ):
                self._cache[global_idx] = ex
                self._cache_bytes += size
        return ex

    def __len__(self) -> int:
        n = len(self.records)
        return n // self.global_batch if self.drop_last else -(-n // self.global_batch)

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle deterministically per epoch (the role of
        `DistributedSampler.set_epoch`)."""
        self.epoch = epoch

    def _epoch_order(self) -> np.ndarray:
        idx = np.arange(len(self.records))
        if self.train:
            np.random.default_rng((self.seed, self.epoch)).shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        order = self._epoch_order()
        n_batches = len(self)

        def load_one(global_idx: int, pos: int) -> dict[str, np.ndarray]:
            ex = self._load_record(int(global_idx) % len(self.records))
            if self.crop is not None:
                # Per-example deterministic crop rng; thread-safe by
                # derivation from position, not shared state.
                rng = (
                    np.random.default_rng((self.seed, self.epoch, 2, pos))
                    if self.train
                    else None
                )
                ex = ds.crop_pair(ex, self.crop[0], self.crop[1], rng)
            return ex

        with cf.ThreadPoolExecutor(self.num_threads) as pool:
            for b in range(n_batches):
                start = b * self.global_batch + self.process_index * self.local_batch
                positions = range(start, start + self.local_batch)
                # Trailing partial batch (eval only): wrap around, matching
                # fixed shapes; callers see `count` for correct averaging.
                idxs = [order[p] if p < len(order) else order[p % len(order)] for p in positions]
                examples = list(pool.map(load_one, idxs, positions))
                # valid_count is over the GLOBAL batch (wrapped padding rows
                # are at its tail, so row i is real iff i < valid_count) and
                # is the same on every process.
                valid = min(self.global_batch, len(order) - b * self.global_batch)
                batch = {
                    k: np.stack([ex[k] for ex in examples])
                    for k in ("input_img", "output_img", "mask")
                }
                batch["name"] = [ex["name"] for ex in examples]
                batch["valid_count"] = np.asarray(valid, np.int32)
                yield batch


def prefetch(iterator: Iterator, size: int = 2) -> Iterator:
    """Software pipeline: a background thread keeps up to `size` batches
    decoded ahead of the consumer, so host decode/crop overlaps the device
    step instead of running serially between steps. Errors in the producer
    are raised in the consumer."""
    q: queue.Queue = queue.Queue(maxsize=size)
    _END = object()

    def producer():
        try:
            for item in iterator:
                q.put(item)
            q.put(_END)
        except BaseException as e:  # propagate decode errors to the consumer
            q.put(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def to_device(batch: dict, device) -> dict:
    """Copy the batch's arrays to `device`: through pinned host memory and
    without blocking the host on a CUDA device. Scalars and names stay on
    the host."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.ndim > 0:
            t = torch.from_numpy(v)
            if device.type == "cuda":
                t = t.pin_memory()
            out[k] = t.to(device, non_blocking=True)
        else:
            out[k] = v
    return out
