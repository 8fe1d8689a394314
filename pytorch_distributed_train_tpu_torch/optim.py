"""AdamW, its LR schedules and global-norm clipping, with the numbers of
the JAX package's optax chain (``optim.make_optimizer``):

    clip_by_global_norm -> adamw(b1, b2, eps, weight_decay, mask) -> schedule

- The schedule is evaluated at the optimizer-update count before the
  update, as optax's ``scale_by_learning_rate`` does: with warmup the first
  update runs at lr 0.
- ``torch.optim.AdamW`` computes optax's update exactly: moments with bias
  correction from count 1, ``m_hat / (sqrt(v_hat) + eps)``, and decoupled
  decay of the pre-update param, all times lr.
- Weight decay skips the params whose JAX path (``layer0/input_norm/scale``,
  see ``interop.jax_path``) matches one of ``optim.decay_exclude``'s
  regexes: two param groups.
- Clipping is optax's ``clip_by_global_norm``: g * max_norm / ||g|| only
  when ||g|| >= max_norm (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to
  the norm and is not the same function).

Only adamw with constant/cosine/linear schedules is ported.
"""

from __future__ import annotations

import math
import re

import torch

from pytorch_distributed_train_tpu_torch.interop import jax_path

SCHEDULES = ("constant", "cosine", "linear")


def make_schedule(opt_cfg, total_steps: int):
    """count -> lr: linear warmup from 0 over ``warmup_steps`` updates, then
    the main schedule over the remaining ``total_steps - warmup_steps``
    (optax ``join_schedules``)."""
    if opt_cfg.schedule not in SCHEDULES:
        raise NotImplementedError(
            f"optim.schedule={opt_cfg.schedule!r} is not ported to the "
            f"PyTorch package yet; it has {list(SCHEDULES)}")
    base = opt_cfg.learning_rate
    warmup = opt_cfg.warmup_steps
    decay_steps = max(total_steps - warmup, 1)
    end = base * opt_cfg.end_lr_factor

    def main(count: int) -> float:
        if opt_cfg.schedule == "constant":
            return base
        c = min(max(count, 0), decay_steps)
        if opt_cfg.schedule == "cosine":
            cos = 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
            return base * ((1.0 - opt_cfg.end_lr_factor) * cos
                           + opt_cfg.end_lr_factor)
        return (base - end) * (1.0 - c / decay_steps) + end

    def schedule(count: int) -> float:
        if warmup > 0 and count < warmup:
            return base * max(count, 0) / warmup
        return main(count - warmup if warmup > 0 else count)

    return schedule


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in fp32."""
    norms = torch._foreach_norm([g.float() for g in grads])
    return torch.linalg.vector_norm(torch.stack(norms))


class AdamW:
    """The optax chain above over a model's named params. ``step(count)``
    clips the gradients in place, sets the lr of update ``count`` and
    steps; it returns the global gradient norm before clipping."""

    def __init__(self, opt_cfg, named_params, schedule):
        patterns = [re.compile(p.strip())
                    for p in opt_cfg.decay_exclude.split(",") if p.strip()]
        decay, no_decay = [], []
        for name, p in named_params:
            path = jax_path(name)
            (no_decay if any(r.search(path) for r in patterns)
             else decay).append(p)
        self.params = decay + no_decay
        self.schedule = schedule
        self.clip = opt_cfg.grad_clip_norm
        groups = [{"params": decay, "weight_decay": opt_cfg.weight_decay}]
        if no_decay:
            groups.append({"params": no_decay, "weight_decay": 0.0})
        self.torch_opt = torch.optim.AdamW(
            groups, lr=0.0, betas=(opt_cfg.beta1, opt_cfg.beta2),
            eps=opt_cfg.eps)

    def step(self, count: int) -> torch.Tensor:
        grads = [p.grad for p in self.params]
        gnorm = global_norm(grads)
        if self.clip > 0:
            keep = gnorm < self.clip
            for g in grads:
                g.copy_(torch.where(keep, g, g / gnorm * self.clip))
        lr = self.schedule(count)
        for group in self.torch_opt.param_groups:
            group["lr"] = lr
        self.torch_opt.step()
        return gnorm

    def zero_grad(self) -> None:
        self.torch_opt.zero_grad(set_to_none=True)


def make_optimizer(opt_cfg, named_params, total_steps: int):
    """(AdamW, schedule) for ``opt_cfg`` over ``named_params`` (the model's
    ``named_parameters()``)."""
    if opt_cfg.name != "adamw":
        raise NotImplementedError(
            f"optim.name={opt_cfg.name!r} is not ported to the PyTorch "
            "package yet (it has adamw)")
    schedule = make_schedule(opt_cfg, total_steps)
    return AdamW(opt_cfg, named_params, schedule), schedule
