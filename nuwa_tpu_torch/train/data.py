"""Host-side batching (numpy): the port's own copy of the parts of
``nuwa_tpu/train/data.py`` that NUWA training uses, so that the same seed
gives the same batches in the same order as the JAX trainer.

Loaders emit numpy arrays; ``stack_microbatches`` groups a gradient
accumulation window into one leading axis of shape (accum, batch, ...).
"""
from __future__ import annotations

import numpy as np


def cycle(iterable_fn):
    while True:
        yield from iterable_fn()


def accum_log(log, new_logs):
    for k, v in new_logs.items():
        log[k] = log.get(k, 0.0) + v
    return log


def pad_collate(batch):
    """Pad ragged 1-D texts with 0, stack videos: [(text, video)] -> (texts, videos)."""
    texts, videos = zip(*batch)
    max_len = max(t.shape[0] for t in texts)
    out = np.zeros((len(texts), max_len), dtype=np.int64)
    for i, t in enumerate(texts):
        out[i, : t.shape[0]] = t
    return out, np.stack(videos)


class DataLoader:
    """Yields ``pad_collate``d batches of (text, video) pairs, the indices
    shuffled each epoch by ``np.random.default_rng(seed)`` and the last
    partial batch dropped, as the JAX trainer's loader is set."""

    def __init__(self, dataset, batch_size, *, seed=0):
        self.ds = dataset
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        n, bs = len(self.ds), self.batch_size
        order = np.arange(n)
        self.rng.shuffle(order)
        for start in range(0, n - n % bs, bs):
            yield pad_collate([self.ds[int(i)] for i in order[start : start + bs]])

    def cycle(self):
        while True:
            got = False
            for batch in self:
                got = True
                yield batch
            if not got:  # without this, next() would spin forever
                raise ValueError(f"DataLoader yields no batches (dataset size "
                                 f"{len(self.ds)} < batch_size {self.batch_size})")


def stack_microbatches(iterator, accum):
    """Group ``accum`` consecutive (texts, videos) batches into one leading
    axis, padding ragged int64 text widths across the window."""
    while True:
        group = [next(iterator) for _ in range(accum)]
        stacked = []
        for col in zip(*group):
            if col[0].ndim >= 2 and col[0].dtype == np.int64 and any(
                c.shape[1] != col[0].shape[1] for c in col
            ):
                width = max(c.shape[1] for c in col)
                col = [np.pad(c, ((0, 0), (0, width - c.shape[1]))) for c in col]
            stacked.append(np.stack(col))
        yield tuple(stacked)
