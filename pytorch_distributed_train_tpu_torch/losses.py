"""Losses of the ported training path: the JAX package's causal-LM pair.

Each loss returns (scalar fp32 loss, aux metrics dict).

The fused head (:func:`chunked_causal_ce`) computes the LM head and the
cross entropy one sequence chunk at a time under ``torch.utils.checkpoint``,
so at most one (B, chunk, V) fp32 logit tile is live and the backward
recomputes each tile. The logits are fp32 from the compute-dtype operands
with no rounding of the logits to bf16, as the JAX head's
``preferred_element_type=float32`` gives: the head multiplies the
bf16-rounded operands as fp32 tensors (every product of two bf16 values is
exact in fp32, and the sums are fp32).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _perplexity(loss):
    return torch.exp(torch.clamp(loss.detach(), max=20.0))


def causal_lm_xent(logits, batch):
    """Next-token loss over (B, S, V) logits: logits[:, :-1] against
    ids[:, 1:], the mean over positions. (The JAX loss also takes a
    ``loss_mask``; no ported dataset makes one.)"""
    targets = batch["input_ids"][:, 1:]
    loss = F.cross_entropy(logits[:, :-1].float().reshape(-1, logits.shape[-1]),
                           targets.reshape(-1))
    return loss, {"perplexity": _perplexity(loss)}


def fused_causal_lm_xent(out, batch):
    """Loss of a model running the fused chunked head: it returns
    {'loss_sum', 'weight_sum'} instead of logits."""
    del batch
    loss = out["loss_sum"] / out["weight_sum"].clamp_min(1.0)
    return loss, {"perplexity": _perplexity(loss)}


def _chunk_ce(xt, kernel, tt):
    logits = xt.float() @ kernel
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tt.reshape(-1), reduction="sum")


def chunked_causal_ce(x, kernel, input_ids, chunk: int = 256) -> dict:
    """Fused LM head + cross entropy over sequence chunks.

    x: (B, S, E) final hidden states in the compute dtype; kernel: (E, V)
    in the compute dtype; targets are input_ids shifted by one, every
    position weighted 1 (the JAX helper's ``loss_mask`` is not ported: no
    ported dataset makes one). Returns {'loss_sum', 'weight_sum'} fp32
    scalars."""
    xs = x[:, :-1]
    targets = input_ids[:, 1:]
    kf = kernel.float()  # bf16 values, held once in fp32 for the products
    loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for s0 in range(0, xs.shape[1], chunk):
        sl = slice(s0, s0 + chunk)
        loss_sum = loss_sum + checkpoint(_chunk_ce, xs[:, sl], kf,
                                         targets[:, sl], use_reentrant=False)
    weight_sum = torch.tensor(float(targets.numel()), device=x.device)
    return {"loss_sum": loss_sum, "weight_sum": weight_sum}


LOSSES = {
    "causal_lm_xent": causal_lm_xent,
    "fused_causal_lm_xent": fused_causal_lm_xent,
}


def get_loss_fn(name: str):
    if name not in LOSSES:
        raise NotImplementedError(
            f"loss {name!r} is not ported to the PyTorch package yet; it has "
            f"{sorted(LOSSES)}")
    return LOSSES[name]
