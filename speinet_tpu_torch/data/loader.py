"""Batched loader with threaded decode and device prefetch (port of
`speinet_tpu/data/loader.py`; parity: data/__init__.py:33-66).

A thread pool decodes and assembles samples (the reference uses n_threads
worker processes); each sample's crop and augmentation draw from a numpy
generator seeded by (seed, epoch, index), so an epoch's batches do not
depend on the thread schedule. `prefetch_to_device` moves batches to the
device a few ahead of use: pinned host memory and non-blocking copies on a
card.

Data parallelism (parity: speinet_tpu/data/loader.py:8-14): every process
builds the same shuffled order (seed and epoch only) and loads only its
`process_index::process_count` stride of each global batch. The global
batch of a step is the processes' batches concatenated in process order,
as `jax.make_array_from_process_local_data` assembles it; `Data` takes the
process index and count from the process group (`parallel/mesh.py`).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Tuple

import numpy as np
import torch

from speinet_tpu_torch.config import Config
from speinet_tpu_torch.data.videodata import VideoDataset
from speinet_tpu_torch.parallel.mesh import rank, world
from speinet_tpu_torch.utils.spans import span


class BatchIterator:
    """Shuffled epoch iterator producing stacked numpy batches."""

    def __init__(self, dataset: VideoDataset, batch_size: int, shuffle: bool,
                 seed: int, n_threads: int = 8, drop_last: bool = False,
                 process_index: int = 0, process_count: int = 1):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.n_threads = n_threads
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = process_count
        if process_count > 1:
            if batch_size % process_count:
                raise ValueError(
                    f"batch_size {batch_size} must divide evenly over "
                    f"{process_count} processes")
            if not drop_last:
                raise ValueError("multi-host loading requires drop_last so "
                                 "every process sees equal shards")

    def __len__(self):
        n = len(self.ds)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray, list]]:
        epoch = self.epoch           # snapshot: shuffle and per-sample rng
        self.epoch += 1              # streams share one epoch label
        rng = np.random.default_rng((self.seed, epoch))
        order = np.arange(len(self.ds))
        if self.shuffle:
            rng.shuffle(order)

        def fetch(i):
            # per-sample rng stream: deterministic given (seed, epoch, index)
            srng = np.random.default_rng((self.seed, epoch, int(i)))
            return self.ds.__getitem__(int(i), rng=srng)

        with ThreadPoolExecutor(max_workers=self.n_threads) as pool:
            for start in range(0, len(order), self.batch_size):
                chunk = order[start : start + self.batch_size]
                if self.drop_last and len(chunk) < self.batch_size:
                    break
                # this process decodes only its stride of the global batch
                chunk = chunk[self.process_index::self.process_count]
                samples = list(pool.map(fetch, chunk))
                inputs = np.stack([s[0] for s in samples])
                gts = np.stack([s[1] for s in samples])
                labels = np.stack([s[2] for s in samples])
                names = [s[3] for s in samples]
                if len(samples[0]) > 4:      # bm mode: 5th stream
                    yield inputs, gts, labels, names, np.stack([s[4] for s in samples])
                else:
                    yield inputs, gts, labels, names


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy array on `device`: through pinned memory and a non-blocking
    copy on a card (the copy is ordered before later work on the stream)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


PREFETCH_DEPTH = 2


def prefetch_to_device(iterator, device: torch.device):
    """Overlap host batch assembly with device compute: the numpy arrays of
    each batch are placed on `device` PREFETCH_DEPTH batches ahead of use
    (other entries pass through). A producer error is raised in the consumer.
    Spans: `loader.batch` around each batch's next() and upload in the
    producer thread, `loader.wait` around the consumer's wait for it."""
    q: "queue.Queue" = queue.Queue(maxsize=PREFETCH_DEPTH)
    sentinel = object()
    failure = []

    def producer():
        try:
            it = iter(iterator)
            while True:
                with span("loader.batch"):
                    batch = next(it, sentinel)
                    if batch is sentinel:
                        break
                    batch = tuple(to_device(a, device) if isinstance(a, np.ndarray)
                                  else a for a in batch)
                q.put(batch)
        except Exception as e:     # handed to the consumer, re-raised there
            failure.append(e)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        with span("loader.wait"):
            item = q.get()
        if item is sentinel:
            break
        yield item
    t.join()
    if failure:
        raise failure[0]


DATASET_MODES = {
    # name-based dataset dispatch (parity: data/__init__.py:41-42 dynamic
    # import of data.<name>): DVD_NFS -> videodata_nfs.py semantics,
    # DVD -> videodata.py (blur-map stream), DVD_ORI -> videodata-ori.py
    "DVD_NFS": "nsf",
    "DVD": "bm",
    "DVD_ORI": "plain",
}


def make_dataset(cfg: Config, name: str, train: bool) -> VideoDataset:
    mode = DATASET_MODES.get(name.upper())
    if mode is None:
        raise NotImplementedError(f"Dataset [{name}] is not found")
    return VideoDataset(cfg, name=name, train=train, mode=mode)


class Data:
    """Train + test loaders (parity: data/__init__.py:33-66)."""

    def __init__(self, cfg: Config):
        self.cfg = cfg
        if not cfg.test_only:
            self.loader_train = BatchIterator(make_dataset(cfg, cfg.data_train, True),
                                              cfg.batch_size, shuffle=True,
                                              seed=cfg.seed, n_threads=cfg.n_threads,
                                              drop_last=True, process_index=rank(),
                                              process_count=world())
        else:
            self.loader_train = None
        self.loader_test = BatchIterator(make_dataset(cfg, cfg.data_test, False), 1,
                                         shuffle=False, seed=cfg.seed,
                                         n_threads=cfg.n_threads)
