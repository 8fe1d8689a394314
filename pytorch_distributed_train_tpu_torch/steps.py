"""The train step: forward, loss, backward, clip, optimizer update.

The counterpart of the JAX package's ``steps.make_train_step`` on the
single-shot path; accumulation, EMA/SWA, the numeric guard and the fused
epilogue are refused by ``config.refuse_unported``. PyTorch runs the step
eagerly; the params and the optimizer state are updated in place.
"""

from __future__ import annotations

from typing import Callable

import torch

from pytorch_distributed_train_tpu_torch.train_state import TrainState


def make_train_step(model, loss_fn: Callable, tx) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics). The metrics are
    the JAX step's on this path: ``loss``, ``grad_norm`` (global, before
    clipping), ``aux_loss`` (0: no sown losses in a dense model) and the
    loss's own (``perplexity``); 0-d tensors on the model's device."""

    def train_step(state: TrainState, batch: dict):
        tx.zero_grad()
        out = model(batch["input_ids"])
        loss, aux = loss_fn(out, batch)
        loss.backward()
        gnorm = tx.step(state.step)
        state.step += 1
        metrics = {"loss": loss.detach(), "grad_norm": gnorm,
                   "aux_loss": torch.zeros((), device=loss.device), **aux}
        return state, metrics

    return train_step
