"""Distributed index sampler with torch ``DistributedSampler`` semantics,
a copy of the JAX package's ``data/sampler.py`` (numpy, so both packages
draw the same order from the same seed).

- epoch-seeded permutation: reshuffles every epoch via ``set_epoch``,
  identically on every rank with no communication;
- pad to divisible: indices repeat from the front until
  len % num_replicas == 0 when drop_last=False, else truncate;
- stride subsample: rank takes indices[rank::num_replicas].
"""

from __future__ import annotations

import numpy as np


class DistributedSampler:
    def __init__(
        self,
        dataset_len: int,
        num_replicas: int,
        rank: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
    ):
        if rank >= num_replicas or rank < 0:
            raise ValueError(f"rank {rank} out of range for {num_replicas} replicas")
        self.dataset_len = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

        if drop_last and dataset_len % num_replicas != 0:
            self.num_samples = dataset_len // num_replicas
        else:
            self.num_samples = (dataset_len + num_replicas - 1) // num_replicas
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def indices(self) -> np.ndarray:
        if self.shuffle:
            g = np.random.default_rng(self.seed + self.epoch)
            idx = g.permutation(self.dataset_len)
        else:
            idx = np.arange(self.dataset_len)

        if not self.drop_last:
            pad = self.total_size - len(idx)
            if pad > 0:
                reps = int(np.ceil(pad / len(idx)))
                idx = np.concatenate([idx, np.tile(idx, reps)[:pad]])
        else:
            idx = idx[: self.total_size]

        assert len(idx) == self.total_size
        return idx[self.rank :: self.num_replicas]

    def __iter__(self):
        return iter(self.indices())

    def __len__(self) -> int:
        return self.num_samples
