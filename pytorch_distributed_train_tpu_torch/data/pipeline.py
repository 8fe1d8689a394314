"""A one-host training loader: the JAX package's ``HostDataLoader`` batch
order and ``steps_per_epoch`` for training (shuffled, ragged tail dropped),
without threads, worker pools or device prefetch.

Each epoch draws the sampler's permutation (seeded by ``data.seed`` plus
the epoch) and cuts it into ``batch_size`` chunks. Batches are
``{"input_ids": LongTensor (B, S)}`` on the loader's device.
"""

from __future__ import annotations

from typing import Iterator

import torch

from pytorch_distributed_train_tpu_torch.data.sampler import DistributedSampler


class HostDataLoader:
    def __init__(self, dataset, data_cfg, *, device="cuda"):
        self.dataset = dataset
        self.batch = data_cfg.batch_size
        self.device = torch.device(device)
        self.sampler = DistributedSampler(len(dataset), 1, 0, shuffle=True,
                                          seed=data_cfg.seed)

    @property
    def steps_per_epoch(self) -> int:
        return self.sampler.num_samples // self.batch

    def host_batches(self, epoch: int) -> Iterator[dict]:
        """The epoch's numpy batches (the JAX loader's bytes)."""
        self.sampler.set_epoch(epoch)
        idx = self.sampler.indices()
        for b in range(self.steps_per_epoch):
            yield self.dataset.get_batch(idx[b * self.batch:(b + 1) * self.batch])

    def epoch(self, epoch: int) -> Iterator[dict]:
        for batch in self.host_batches(epoch):
            yield {k: torch.from_numpy(v).to(self.device, torch.long)
                   for k, v in batch.items()}
