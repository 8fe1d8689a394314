"""Datasets of the ported training path: ``synthetic_lm`` only, as the
JAX package's ``data/datasets.py`` builds it (numpy, so both packages hold
the same tokens for the same seed)."""

from __future__ import annotations

import numpy as np


class ArrayDataset:
    """In-RAM dataset: dict of equal-length numpy arrays."""

    def __init__(self, arrays: dict[str, np.ndarray]):
        lens = {k: len(v) for k, v in arrays.items()}
        if len(set(lens.values())) != 1:
            raise ValueError(f"ragged arrays: {lens}")
        self.arrays = arrays

    def __len__(self) -> int:
        return len(next(iter(self.arrays.values())))

    def get_batch(self, idx: np.ndarray) -> dict:
        return {k: v[idx] for k, v in self.arrays.items()}


def synthetic_lm(size: int, seq_len: int, vocab_size: int,
                 seed: int = 0) -> ArrayDataset:
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab_size, size=(size, seq_len)).astype(np.int32)
    return ArrayDataset({"input_ids": ids})


def build_dataset(data_cfg, model_cfg, train: bool) -> ArrayDataset:
    """The train split draws from seed 0, the eval split from seed 1."""
    if data_cfg.dataset != "synthetic_lm":
        raise NotImplementedError(
            f"data.dataset={data_cfg.dataset!r} is not ported to the PyTorch "
            "package yet (it has synthetic_lm)")
    return synthetic_lm(data_cfg.synthetic_size, data_cfg.seq_len,
                        model_cfg.vocab_size, seed=0 if train else 1)
