"""Host prefetch loader with background batch assembly.

Counterpart of `reid_tpu/data/loader.py:make_eval_loader` (ref
`train_utils.py:21-23` DataLoaderX: a background thread, pinned memory and
non-blocking copies). A worker thread assembles the next uint8 host
batches, in pinned memory when the batches go to a card, while the card
embeds the current one. The last batch is padded by wrapping to the start,
so every batch has the same shape; callers cut the results back to
`len(dataset)`. `make_train_loader` (`reid_tpu/data/loader.py:71-85`)
feeds an epoch of PK batches (`sampler.py`) the same way; the training
augmentation then runs on the device (`transforms.augment_apply`).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from .dataset import ReIDDataset
from .sampler import pk_epoch_indices

PREFETCH = 2            # host batches assembled ahead of the consumer


class PrefetchLoader:
    """Iterate batches of a ReIDDataset with background prefetch. Each
    batch is a dict of torch tensors on `device`."""

    def __init__(self, dataset: ReIDDataset, batch_size: int,
                 indices: np.ndarray, device="cuda"):
        self.dataset = dataset
        self.batch_size = batch_size
        self.indices = indices
        self.device = torch.device(device)

    def __len__(self):
        return -(-len(self.indices) // self.batch_size)

    def _host(self, chunk) -> dict:
        batch = self.dataset.gather(chunk)
        pin = self.device.type == "cuda"
        return {k: (torch.from_numpy(v).pin_memory() if pin
                    else torch.from_numpy(v)) for k, v in batch.items()}

    def __iter__(self) -> Iterator[dict]:
        q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        stop = object()
        closed = threading.Event()
        failure = []

        def producer():
            try:
                n = len(self.indices)
                for s in range(0, n, self.batch_size):
                    if closed.is_set():
                        break
                    chunk = self.indices[s:s + self.batch_size]
                    if len(chunk) < self.batch_size:
                        # pad by wrapping (the same batch shape throughout)
                        extra = self.indices[: self.batch_size - len(chunk)]
                        chunk = np.concatenate([chunk, extra])
                    q.put(self._host(chunk))
            except BaseException as e:     # re-raised in the consumer
                failure.append(e)
            finally:
                q.put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        item = None
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                yield {k: v.to(self.device, non_blocking=True)
                       for k, v in item.items()}
        finally:
            # a consumer that stops early: drain until the producer ends
            closed.set()
            while item is not stop:
                item = q.get()
            t.join()
        if failure:
            raise failure[0]


def make_eval_loader(dataset: ReIDDataset, batch_size: int,
                     device="cuda") -> PrefetchLoader:
    return PrefetchLoader(dataset, batch_size, np.arange(len(dataset)),
                          device=device)


def make_train_loader(dataset: ReIDDataset, batch_size: int,
                      num_instances: int, seed: int = 0, epoch: int = 0,
                      device="cuda", shard=(0, 1)) -> PrefetchLoader:
    """One epoch of the training loader: PK batches (ref
    RandomIdentitySampler_) when `num_instances` > 0, a plain shuffle
    otherwise (ref image_reid_train.py:51-58), drawn from
    `np.random.default_rng(seed + epoch)` as the JAX package draws them.
    `shard` = (rank, size): every rank draws the same epoch and loads
    only its rows rank * B/size : (rank + 1) * B/size of each batch
    (the last batch wrapped first, as the whole loader wraps it)."""
    rng = np.random.default_rng(seed + epoch)
    if num_instances > 0:
        idx = pk_epoch_indices(dataset.labels, batch_size, num_instances,
                               rng)
    else:
        idx = rng.permutation(len(dataset))
    rank, size = shard
    if size > 1:
        short = (-len(idx)) % batch_size
        idx = np.concatenate([idx, idx[:short]]).reshape(-1, batch_size)
        per = batch_size // size
        idx = idx[:, rank * per:(rank + 1) * per].reshape(-1)
        batch_size = per
    return PrefetchLoader(dataset, batch_size, idx, device=device)
