"""Duration-binned, distributed-capable batch sampler.

Parity: reference meldataset.BatchSampler (meldataset.py:228-307): samples
are grouped into 20-frame duration bins (hop 300 => 0.25 s granularity),
bins are shuffled per epoch, and each bin is sharded across
(num_replicas, rank) exactly like torch's DistributedSampler — so per-host
data sharding over DCN is the same interface the reference already exposes
(and pins to (1, 0), meldataset.py:218-220).

Binning gives static batch shapes: every batch drawn from bin k has mel
length in [20k+20, 20k+40), so it pads to a fixed per-bin shape.
"""

from __future__ import annotations

import numpy as np
from typing import Dict, Iterator, List, Sequence

FRAMES_PER_BIN = 20
HOP = 300
MIN_FRAMES = 20


def time_bin(sample_count: int) -> int:
    """reference meldataset.py:302-307."""
    frames = sample_count // HOP
    if frames >= MIN_FRAMES:
        return (frames - MIN_FRAMES) // FRAMES_PER_BIN
    return -1


class DurationBinSampler:
    def __init__(self, sample_lengths: Sequence[int], batch_size: int,
                 num_replicas: int = 1, rank: int = 0, shuffle: bool = True,
                 drop_last: bool = False, seed: int = 0):
        self.batch_size = batch_size
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

        self.time_bins: Dict[int, List[int]] = {}
        for i, n in enumerate(sample_lengths):
            b = time_bin(n)
            if b != -1:
                self.time_bins.setdefault(b, []).append(i)

        self.total_len = 0
        total_batch = batch_size * num_replicas
        for val in self.time_bins.values():
            self.total_len += len(val) // total_batch
            if not drop_last and len(val) % total_batch != 0:
                self.total_len += 1

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.total_len

    def __iter__(self) -> Iterator[List[int]]:
        """Yields (bin_id, [dataset indices]) batches for this rank."""
        rng = np.random.default_rng(self.seed + self.epoch)
        bin_keys = list(self.time_bins.keys())
        order = rng.permutation(len(bin_keys)) if self.shuffle \
            else np.arange(len(bin_keys))
        for oi in order:
            key = bin_keys[int(oi)]
            items = np.asarray(self.time_bins[key])
            # DistributedSampler-within-bin (meldataset.py:281-294)
            if self.shuffle:
                items = items[rng.permutation(len(items))]
            total_batch = self.batch_size * self.num_replicas
            if self.drop_last:
                n_even = (len(items) // total_batch) * total_batch
                items = items[:n_even]
            else:
                # pad by wrapping so every replica sees equal counts
                target = -(-len(items) // total_batch) * total_batch
                if target > len(items) and len(items) > 0:
                    extra = items[: target - len(items)]
                    items = np.concatenate([items, extra])
            shard = items[self.rank::self.num_replicas]
            for i in range(0, len(shard), self.batch_size):
                chunk = shard[i: i + self.batch_size]
                if len(chunk) == self.batch_size or not self.drop_last:
                    yield key, [int(x) for x in chunk]
