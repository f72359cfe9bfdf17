"""The training loader: a ``torch.utils.data.DataLoader`` that yields the JAX
package's ``PrefetchLoader`` batches.

Counterpart of ``dove_tpu/data/loader.py``. ``BatchPlan``, the DataLoader's
batch sampler, makes the JAX loader's batches: a (seed, epoch) shuffle (or
the order of a batch sampler such as ``BucketSampler``), ``drop_last``, and
under ``process_shard`` each process's slice of every global batch. Items
run in worker processes, not threads: the degradations' NumPy draws (normal,
Poisson) hold the interpreter lock. Workers start from a fresh interpreter
(``spawn``) each epoch, and every index they receive carries its epoch, so a
worker's copy of the dataset draws that epoch's degradations. ``collate`` is
the JAX package's: arrays stacked, dicts recursed, everything else listed;
batches stay NumPy, which workers send back through a pipe.
"""

from __future__ import annotations

from typing import Any, Iterator, Sequence

import numpy as np
import torch


def collate(samples: Sequence[dict[str, Any]]) -> dict[str, Any]:
    """Stack a list of sample dicts into one batch dict."""
    out: dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        first = vals[0]
        if isinstance(first, np.ndarray):
            out[key] = np.stack(vals)
        elif isinstance(first, dict):
            out[key] = collate(vals)
        else:
            out[key] = vals
    return out


class BatchPlan(torch.utils.data.Sampler):
    """The batches of one epoch as lists of (epoch, index), in
    ``PrefetchLoader._batches``'s order."""

    def __init__(self, n_items: int, batch_size: int = 1, *, shuffle: bool = True,
                 sampler=None, drop_last: bool = True, seed: int = 0,
                 process_shard: tuple[int, int] = (0, 1)) -> None:
        self.n_items = n_items
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.sampler = sampler
        self.drop_last = drop_last
        self.seed = seed
        self.process_shard = process_shard
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if self.sampler is not None and hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)

    def batches(self) -> list[list[int]]:
        if self.sampler is not None:
            batches = [list(b) for b in self.sampler]
        else:
            order = np.arange(self.n_items)
            if self.shuffle:
                np.random.default_rng((self.seed, self.epoch)).shuffle(order)
            batches = [
                [int(i) for i in order[s : s + self.batch_size]]
                for s in range(0, len(order), self.batch_size)
            ]
            if self.drop_last and batches and len(batches[-1]) < self.batch_size:
                batches.pop()
        pid, nproc = self.process_shard
        if nproc > 1:
            local = []
            for b in batches:
                if len(b) % nproc:
                    raise ValueError(
                        f"batch of {len(b)} not divisible by process_count {nproc}")
                k = len(b) // nproc
                local.append(b[pid * k : (pid + 1) * k])
            return local
        return batches

    def __iter__(self) -> Iterator[list[tuple[int, int]]]:
        for b in self.batches():
            yield [(self.epoch, i) for i in b]

    def __len__(self) -> int:
        return len(self.batches())


class _EpochItems(torch.utils.data.Dataset):
    """``dataset[(epoch, index)]`` -> the item of that index at that epoch."""

    def __init__(self, dataset) -> None:
        self.dataset = dataset

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, key: tuple[int, int]):
        epoch, index = key
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)
        return self.dataset[index]


class Loader:
    """Batches of ``dataset`` (the arguments of the JAX ``PrefetchLoader``);
    ``num_workers`` worker processes, none for loading in this process, and
    ``prefetch`` batches in flight per worker."""

    def __init__(self, dataset, batch_size: int = 1, *, shuffle: bool = True,
                 sampler=None, num_workers: int = 4, prefetch: int = 2,
                 drop_last: bool = True, seed: int = 0,
                 process_shard: tuple[int, int] = (0, 1)) -> None:
        self.dataset = dataset
        self.plan = BatchPlan(len(dataset), batch_size, shuffle=shuffle,
                              sampler=sampler, drop_last=drop_last, seed=seed,
                              process_shard=process_shard)
        workers = max(num_workers, 0)
        self.loader = torch.utils.data.DataLoader(
            _EpochItems(dataset), batch_sampler=self.plan, num_workers=workers,
            collate_fn=collate,
            prefetch_factor=max(prefetch, 1) if workers else None,
            multiprocessing_context="spawn" if workers else None,
        )

    def set_epoch(self, epoch: int) -> None:
        self.plan.set_epoch(epoch)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.plan)

    def __iter__(self) -> Iterator[dict[str, Any]]:
        return iter(self.loader)
