"""The training loop: the counterpart of the JAX package's
``trainer.Trainer`` on one card, without its planes.

``Trainer(cfg, device="cuda")`` builds the dataset, the loader, the model
(fp32 params drawn from ``cfg.seed`` on the device, or ``params``), the
optimizer and the step; ``fit(max_steps)`` runs the epoch loop, logs
``[train] step=… loss=…`` every ``obs.log_every_steps`` and at the last
step, and ends with a ``[summary]`` line. Checkpointing, evaluation,
faults, the sentinel, the observability planes, LoRA and distillation are
not ported and are refused when configured on (``config.refuse_unported``
and unknown ``--set`` keys).

Each step ends in a device synchronisation, so the recorded step times
(``step_ms``) are the card's, not the host's enqueue time.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pytorch_distributed_train_tpu_torch.config import refuse_unported
from pytorch_distributed_train_tpu_torch.data.datasets import build_dataset
from pytorch_distributed_train_tpu_torch.data.pipeline import HostDataLoader
from pytorch_distributed_train_tpu_torch.losses import get_loss_fn
from pytorch_distributed_train_tpu_torch.models.registry import build_model
from pytorch_distributed_train_tpu_torch.optim import make_optimizer
from pytorch_distributed_train_tpu_torch.steps import make_train_step
from pytorch_distributed_train_tpu_torch.train_state import TrainState


class Trainer:
    def __init__(self, cfg, device="cuda", params: dict | None = None):
        refuse_unported(cfg)
        if cfg.model.fused_lm_loss != (cfg.loss == "fused_causal_lm_xent"):
            raise ValueError(
                "model.fused_lm_loss and loss='fused_causal_lm_xent' go "
                f"together (got {cfg.model.fused_lm_loss} and {cfg.loss!r})")
        self.cfg = cfg
        self.device = torch.device(device)
        loss_fn = get_loss_fn(cfg.loss)
        self.train_ds = build_dataset(cfg.data, cfg.model, train=True)
        self.train_loader = HostDataLoader(self.train_ds, cfg.data,
                                           device=self.device)
        self.steps_per_epoch = self.train_loader.steps_per_epoch
        if self.steps_per_epoch < 1:
            raise ValueError(
                f"data.synthetic_size {len(self.train_ds)} holds no full "
                f"batch of {cfg.data.batch_size}")
        self.total_steps = (cfg.epochs * self.steps_per_epoch
                            if cfg.epochs > 0 else cfg.total_steps)
        self.model = build_model(cfg.model, cfg.precision, params,
                                 device=self.device, seed=cfg.seed,
                                 trainable=True)
        tx, self.lr_schedule = make_optimizer(
            cfg.optim, self.model.named_parameters(), self.total_steps)
        self.state = TrainState(step=0, model=self.model, tx=tx,
                                schedule=self.lr_schedule)
        self.train_step = make_train_step(self.model, loss_fn, tx)
        self.tokens_per_step = cfg.data.batch_size * cfg.data.seq_len
        self.step_ms: list[float] = []
        self.history: list[dict] = []

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _log(self, step: int, metrics: dict) -> dict:
        rec = {"step": step}
        rec.update({k: float(v) for k, v in metrics.items()})
        rec["lr"] = self.lr_schedule(step)  # the next update's lr
        rec["step_ms"] = self.step_ms[-1]
        rec["tokens_per_sec"] = self.tokens_per_step / self.step_ms[-1] * 1e3
        rec["epoch"] = step // self.steps_per_epoch
        self.history.append(rec)
        print("[train] " + " ".join(
            f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in rec.items()), flush=True)
        return rec

    def fit(self, max_steps: int | None = None) -> TrainState:
        limit = min(self.total_steps, max_steps or self.total_steps)
        step = self.state.step
        epoch = step // self.steps_per_epoch
        skip = step - epoch * self.steps_per_epoch
        t_start = time.perf_counter()
        first = step
        while step < limit:
            for batch in self.train_loader.epoch(epoch):
                if skip:
                    skip -= 1
                    continue
                if step >= limit:
                    break
                t0 = time.perf_counter()
                self.state, metrics = self.train_step(self.state, batch)
                self._sync()
                self.step_ms.append((time.perf_counter() - t0) * 1e3)
                step += 1
                if (step % self.cfg.obs.log_every_steps == 0
                        or step == limit):
                    self._log(step, metrics)
            epoch += 1
        wall = time.perf_counter() - t_start
        ran = self.step_ms[-(step - first):] if step > first else []
        summary = {"steps": step, "wall_s": wall,
                   "step_ms_median": float(np.median(ran)) if ran else 0.0,
                   "final_loss": (self.history[-1]["loss"]
                                  if self.history else float("nan"))}
        print("[summary] " + " ".join(f"{k}={v}" for k, v in summary.items()),
              flush=True)
        return self.state
