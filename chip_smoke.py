#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA package on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its detail as JSON lines; any failure exits non-zero
before the last line:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions.
2. build: the flash kernels (csrc/flash_fwd.cu, csrc/flash_bwd.cu), one
   nvcc each, started together; prints each build's time and ptxas lines.
3. kernel_case: the forward kernel against its plain PyTorch version on the
   card at the serving path's shapes (Llama-2 7B heads: B 1, H 32, D 128,
   bf16, causal) and the training shape (B 2, S 4096), plus GQA, window,
   D 64 and fp32 cases, by element and by row norm; times of the kernel,
   the plain version and one PyTorch library call (a yardstick only),
   beside the least time the card could take (bound).
4. bwd_kernel_case: the dQ and dK/dV kernels against their plain version at
   the training shape and at a ragged S, GQA, window, D 64 and fp32, with
   the same kinds of times and bounds.
5. slice: Llama-2 7B at full width (weights drawn from a seed on the card,
   bf16) behind ContinuousBatcher(slots=4) serving 5 greedy requests;
   checks token counts and that every prefill went through the flash
   kernel. On the 2000-token prompt it then holds every layer's bf16
   attention output through the kernel against the plain attention on the
   same input, and the last-token logits of the kernel route against the
   plain route in bf16 and fp32.
6. train_grads: llama2_7b at full width cut to 8 layers (B 2, seq 4096,
   fp32 params from seed 0, bf16 compute, remat, fused loss): one
   forward/backward on the seed-0 weights and the first batch through the
   kernel route and the plain attention route, in bf16 and fp32, every
   parameter's gradient compared by norm; then each layer's bf16 attention
   input gradient, kernel against plain on the same input and upstream
   gradient, by row norm (each also read against the layer in fp32).
7. train: the same model through Trainer.fit for 10 steps (AdamW): finite
   falling loss, exact launch counts of the three kernels, step time,
   tokens/s, peak memory, one profiled window of 2 steps.

The line before the last is the card's name and power limit; the last line
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and the
# operation rate of each input type (bf16 on the tensor cores, fp32 on the
# CUDA cores, which is what the fp32 kernel uses).
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
BF16_TOL, FP32_TOL, LSE_TOL = 2e-2, 1e-4, 1e-3
# O against the plain version by row: max over (b, s, h) of
# |o - ref| / |ref| (norms over D). A fault confined to the P.V product of
# some query tiles cannot hide here under the atol of small late-row values.
ROW_REL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# The served bf16 route, layer by layer on the 2000-token prompt: each
# layer's attention output (after o_proj) through the kernel against the
# plain attention on the same input, max over tokens of the row-norm
# relative difference. Both routes round O to bf16 (2^-8 relative), so a
# right kernel reads a few 1e-3 here.
ATTN_ROW_REL_TOL = 1e-2
# Last-token logits of the 2000-token prompt, max|kernel - plain| over
# max|plain|: a guard against gross errors only. In bf16 a rounding
# difference in any of the 32 random-weight layers is carried through
# every later one: the plain bf16 route sits 5.84e-2 from the same weights
# computed in fp32 (H100 run), so the bf16 limit stands above that floor;
# the per-layer attention check above is the sharp one for bf16, and the
# fp32 comparison of the two routes at full width the sharp end to end.
LOGIT_REL_TOL = 1e-1
LOGIT_REL_TOL_FP32 = 1e-3
# Backward kernels against their plain version, by row norm: max over rows
# of |a - b| / max(|b|, 1e-2 * mean row norm). The floor keeps rows whose
# exact gradient is ~0 (dq of the first causal row: P = 1 there, so
# dP - delta = 0) from being divided by their own rounding noise. fp32 is
# also held element-wise at the JAX package's grad tolerance
# (tests/test_flash_attention.py).
BWD_ROW_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
BWD_ATOL, BWD_RTOL = 5e-4, 5e-3
ROW_FLOOR = 1e-2
# Training gradients, kernel route against plain route on the same weights
# and batch, ||g_kernel - g_plain|| / ||g_plain|| for every parameter.
GRAD_REL_TOL_FP32 = 1e-3
# bf16: both routes round at other places (P and dS to bf16 in the
# kernels, probabilities and dP to bf16 in the plain path), and every
# rounding is carried through the 8 layers of the backward. On an H100 the
# plain bf16 route itself sits up to 9.76e-2 from the same step in fp32
# (the q/k projections of the last layers) and the kernel route 9.70e-2,
# while the two bf16 routes differ by at most 6.30e-2; so the limit stands
# above that 9.76e-2 floor. The sharp bf16 check is the per-layer
# attention input gradient below (limit 1e-2, reads ~7e-3).
GRAD_REL_TOL_BF16 = 1.5e-1
ATTN_GRAD_ROW_TOL = 1e-2
TRAIN_LAYERS, TRAIN_STEPS = 8, 10
SRC = "pytorch_distributed_train_tpu_torch/csrc/"
JAX_FA = "pytorch_distributed_train_tpu/ops/flash_attention.py"
KERNELS = {
    "flash_fwd": (SRC + "flash_fwd.cu", JAX_FA + ":164"),
    "flash_bwd_dq": (SRC + "flash_bwd.cu", JAX_FA + ":299"),
    "flash_bwd_dkv": (SRC + "flash_bwd.cu", JAX_FA + ":357"),
}


def emit(phase: str, **detail) -> None:
    print(json.dumps({"phase": phase, **detail}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, warmup: int = 3) -> float:
    """Median device time of one call, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def kept_pairs(S: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps: the work this input needs."""
    if not causal:
        return S * S
    if not window:
        return S * (S + 1) // 2
    return sum(min(i + 1, window) for i in range(S))


def bound(B, S, H, Hkv, D, dtype, causal, window, kind="fwd"):
    """Least time (ms) for one call and what sets it. Bytes: each input
    read once, each output written once; operations: 2 per multiply-add of
    each matrix product over the kept pairs (fwd: S and P.V; dq: S, dP,
    dQ; dkv: S, dP, dV, dK)."""
    elt = torch.finfo(dtype).bits // 8
    rows = {"fwd": 2 * H + 2 * Hkv,  # q, o; k, v
            "dq": 3 * H + 2 * Hkv,  # q, do, dq; k, v
            "dkv": 2 * H + 4 * Hkv}[kind]  # q, do; k, v, dk, dv
    vecs = {"fwd": 1, "dq": 2, "dkv": 2}[kind]  # lse (and delta), fp32
    nbytes = B * S * rows * D * elt + vecs * B * H * S * 4
    products = {"fwd": 2, "dq": 3, "dkv": 4}[kind]
    flops = 2 * products * B * H * D * kept_pairs(S, causal, window)
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def row_rel_err(a, b, floor: float = 0.0) -> float:
    """max over rows (last dim) of |a - b| / |b|, in fp32; with ``floor``
    the denominator is at least floor * (mean row norm of b)."""
    a = a.float().reshape(-1, a.shape[-1])
    b = b.float().reshape(-1, b.shape[-1])
    nb = b.norm(dim=1)
    den = nb.clamp_min(max(1e-30, floor * nb.mean().item()))
    return ((a - b).norm(dim=1) / den).max().item()


def counts(fa) -> dict:
    return {"flash_fwd": fa.flash_attention_fwd.launches,
            "flash_bwd_dq": fa.flash_attention_bwd.launches_dq,
            "flash_bwd_dkv": fa.flash_attention_bwd.launches_dkv}


def zero_counts(fa) -> None:
    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_bwd.launches_dq = 0
    fa.flash_attention_bwd.launches_dkv = 0


def delta_counts(fa, before: dict) -> dict:
    return {k: v - before[k] for k, v in counts(fa).items()}


def kernel_case(fa, *, S, B=1, H=32, Hkv=32, D=128, dtype=torch.bfloat16,
                window=0, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def mk(h):
        return torch.randn((B, S, h, D), generator=g, device="cuda",
                           dtype=dtype)

    q, k, v = mk(H), mk(Hkv), mk(Hkv)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    ro, rlse = fa.flash_attention_reference(q, k, v, causal=True,
                                            window=window)
    tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
    err = (o.float() - ro.float()).abs().max().item()
    lse_err = (lse - rlse).abs().max().item()
    row_err = row_rel_err(o, ro)
    ok = (torch.allclose(o.float(), ro.float(), atol=tol, rtol=tol)
          and torch.allclose(lse, rlse, atol=LSE_TOL, rtol=LSE_TOL)
          and row_err <= ROW_REL_TOL[dtype]
          and bool(torch.isfinite(o).all()))
    kernel_ms = time_ms(lambda: fa.flash_attention_fwd(
        q, k, v, causal=True, window=window))
    plain_ms = time_ms(lambda: fa.flash_attention_reference(
        q, k, v, causal=True, window=window), reps=5, warmup=1)
    # yardstick only: one PyTorch call computing the same attention
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    if window:
        i = torch.arange(S, device="cuda")
        band = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window)
        sdpa_kw = {"attn_mask": band}
    else:
        sdpa_kw = {"is_causal": True}
    if Hkv != H:
        sdpa_kw["enable_gqa"] = True
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, **sdpa_kw))
    bound_ms, bound_by = bound(B, S, H, Hkv, D, dtype, True, window)
    detail = {"B": B, "S": S, "H": H, "Hkv": Hkv, "D": D,
              "dtype": str(dtype).replace("torch.", ""), "window": window,
              "max_abs_err": err, "lse_max_abs_err": lse_err,
              "row_rel_err": row_err, "tol": tol, "lse_tol": LSE_TOL,
              "row_rel_tol": ROW_REL_TOL[dtype], "ok": ok,
              "kernel_ms": kernel_ms,
              "plain_ms": plain_ms, "library_ms": library_ms,
              "bound_ms": bound_ms, "bound_by": bound_by}
    emit("kernel_case", **detail)
    if not ok:
        fail(f"flash_fwd disagrees with its plain version: {detail}")
    return detail


def bwd_kernel_case(fa, *, S, B=1, H=32, Hkv=32, D=128,
                    dtype=torch.bfloat16, window=0, seed=0):
    """dQ, dK, dV of the kernels against flash_attention_bwd_reference on
    the same inputs (causal), with times and bounds."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def mk(h):
        return torch.randn((B, S, h, D), generator=g, device="cuda",
                           dtype=dtype)

    q, k, v, do = mk(H), mk(Hkv), mk(Hkv), mk(H)
    with torch.no_grad():
        o, lse = fa.flash_attention_fwd(q, k, v, causal=True, window=window)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True,
                                 window=window)
    torch.cuda.synchronize()
    ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, causal=True,
                                           window=window)
    errs, ok = {}, True
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        e = {"max_abs_err": (a.float() - r.float()).abs().max().item(),
             "row_rel_err": row_rel_err(a, r, ROW_FLOOR)}
        ok = ok and e["row_rel_err"] <= BWD_ROW_TOL[dtype] and bool(
            torch.isfinite(a).all())
        if dtype == torch.float32:
            ok = ok and torch.allclose(a, r, atol=BWD_ATOL, rtol=BWD_RTOL)
        errs[name] = e
    del got, ref
    delta = fa._delta(o, do)
    dq_ms = time_ms(lambda: fa._bwd_dq(q, k, v, do, lse, delta, True, window))
    dkv_ms = time_ms(lambda: fa._bwd_dkv(q, k, v, do, lse, delta, True,
                                         window))
    bwd_ms = time_ms(lambda: fa.flash_attention_bwd(
        q, k, v, o, lse, do, causal=True, window=window))
    plain_ms = time_ms(lambda: fa.flash_attention_bwd_reference(
        q, k, v, o, lse, do, causal=True, window=window), reps=3, warmup=1)
    library_ms = None
    if dtype == torch.bfloat16 and Hkv == H and not window:
        # yardstick only: one PyTorch call computing dq, dk and dv (the
        # flash-attention backward behind scaled_dot_product_attention)
        qt, kt, vt, dot = (x.transpose(1, 2).contiguous()
                           for x in (q, k, v, do))
        f = torch.ops.aten._scaled_dot_product_flash_attention(
            qt, kt, vt, 0.0, True, False)
        library_ms = time_ms(
            lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
                dot, qt, kt, vt, f[0], f[1], f[2], f[3], f[4], f[5], 0.0,
                True, f[6], f[7]))
    dq_bound, dq_by = bound(B, S, H, Hkv, D, dtype, True, window, "dq")
    dkv_bound, dkv_by = bound(B, S, H, Hkv, D, dtype, True, window, "dkv")
    detail = {"B": B, "S": S, "H": H, "Hkv": Hkv, "D": D,
              "dtype": str(dtype).replace("torch.", ""), "window": window,
              "errors": errs, "row_rel_tol": BWD_ROW_TOL[dtype],
              "row_floor": ROW_FLOOR, "ok": ok,
              "dq_ms": dq_ms, "dkv_ms": dkv_ms, "bwd_ms": bwd_ms,
              "plain_ms": plain_ms, "library_ms": library_ms,
              "dq_bound_ms": dq_bound, "dq_bound_by": dq_by,
              "dkv_bound_ms": dkv_bound, "dkv_bound_by": dkv_by}
    if dtype == torch.float32:
        detail.update(atol=BWD_ATOL, rtol=BWD_RTOL)
    emit("bwd_kernel_case", **detail)
    if not ok:
        fail(f"flash_bwd disagrees with its plain version: {detail}")
    return detail


def prefill_logits(model, prompt, P):
    """Last-real-token logits of a bucket-padded B=1 prefill."""
    from pytorch_distributed_train_tpu_torch.generate import init_cache
    from pytorch_distributed_train_tpu_torch.serving import _prefill_step

    ids = torch.zeros((1, P), dtype=torch.long, device="cuda")
    ids[0, : len(prompt)] = torch.tensor(prompt, device="cuda")
    return _prefill_step(model, init_cache(model, 1), ids, len(prompt))


def attention_by_layer(model, prompt, P) -> list[float]:
    """A bucket-padded prefill of ``prompt`` through the kernel route; each
    layer's attention output is held against the plain attention route on
    the same input. Returns, per layer, the max over token rows of the
    row-norm relative difference."""
    from pytorch_distributed_train_tpu_torch.ops import flash_attention as fa

    errs = []

    def hook(attn, args, out):
        x, rope, mode, cache, layer = args
        plain = attn.forward(x, rope, dataclasses.replace(
            mode, attn_impl="xla"), cache, layer)
        errs.append(row_rel_err(out, plain))

    handles = [blk.attn.register_forward_hook(hook) for blk in model.layers]
    before = fa.flash_attention_fwd.launches
    prefill_logits(model.twin(attn_impl="pallas"), prompt, P)
    launched = fa.flash_attention_fwd.launches - before
    for h in handles:
        h.remove()
    if launched != len(model.layers):
        fail(f"the kernel-route prefill launched the kernel {launched} "
             f"times (want one per layer)")
    return errs


def profile_window(phase: str, run, top: int = 12, **detail) -> None:
    """Profile ``run()`` on the card; print the kernels with the most device
    time and the device's busy share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, list] = {}
    for e in prof.events():
        # device kernels and copies only: user annotations (such as the
        # optimizer's step range) also land on the device timeline
        if e.device_type == DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            acc = by_name.setdefault(e.name, [0.0, 0])
            acc[0] += e.time_range.elapsed_us() / 1e3
            acc[1] += 1
    busy = sum(v[0] for v in by_name.values())
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    emit(phase, wall_ms=wall_ms, device_busy_ms=busy,
         device_idle_share=max(0.0, 1.0 - busy / wall_ms), **detail,
         top=[{"kernel": n[:90], "ms": v[0], "calls": v[1],
               "share": v[0] / busy} for n, v in rows])


def profile_run(batcher, rng, vocab: int) -> None:
    """One profiled serving run: 4 prefills of 512-token prompts, then the
    batched decode steps."""
    for _ in range(4):
        batcher.submit(rng.integers(0, vocab, 512).tolist(), 8)

    def run():
        for _ in batcher.run():
            pass

    profile_window("profile", run, prefills=4, prompt_len=512, new_tokens=8)


def build_trainer():
    """The Trainer of llama2_7b at full width, 8 layers, B 2, seq 4096,
    weights from seed 0 on the card."""
    from pytorch_distributed_train_tpu_torch.config import get_preset
    from pytorch_distributed_train_tpu_torch.trainer import Trainer

    cfg = get_preset("llama2_7b")
    cfg.apply_overrides([f"model.num_layers={TRAIN_LAYERS}",
                         "data.batch_size=2", "data.synthetic_size=4",
                         "optim.warmup_steps=2", "obs.log_every_steps=1",
                         "seed=0"])
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in trainer.model.parameters())
    emit("train_setup", seconds=time.perf_counter() - t0, layers=TRAIN_LAYERS,
         hidden=cfg.model.hidden_size, seq_len=cfg.data.seq_len,
         batch=cfg.data.batch_size, params_billion=n_params / 1e9)
    return trainer


def train_phase(fa, trainer, card) -> dict:
    """10 steps of Trainer.fit; returns the run's launch counts."""
    cfg = trainer.cfg
    zero_counts(fa)
    torch.cuda.reset_peak_memory_stats()
    trainer.fit(TRAIN_STEPS)
    launched = counts(fa)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [r["loss"] for r in trainer.history]
    want = {"flash_fwd": 2 * TRAIN_LAYERS * TRAIN_STEPS,
            "flash_bwd_dq": TRAIN_LAYERS * TRAIN_STEPS,
            "flash_bwd_dkv": TRAIN_LAYERS * TRAIN_STEPS}
    step_ms = float(np.median(trainer.step_ms[2:TRAIN_STEPS]))
    tokens = cfg.data.batch_size * cfg.data.seq_len
    emit("train", steps=TRAIN_STEPS, losses=losses,
         grad_norms=[r["grad_norm"] for r in trainer.history],
         lrs=[r["lr"] for r in trainer.history],
         step_ms_by_step=trainer.step_ms, step_ms_median_3_10=step_ms,
         tokens_per_s=tokens / step_ms * 1e3, peak_memory_gb=peak_gb,
         launches=launched, launches_want=want, ln_vocab=math.log(
             cfg.model.vocab_size), card=card)
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        fail(f"training losses are not all finite: {losses}")
    if abs(losses[0] - math.log(cfg.model.vocab_size)) > 1.5:
        fail(f"step-1 loss {losses[0]} is not within 1.5 of ln(vocab)")
    if not losses[-1] < losses[0]:
        fail(f"the loss did not fall: {losses}")
    if launched != want:
        fail(f"training launched {launched} kernels, want {want}")

    profile_window("train_profile", lambda: trainer.fit(TRAIN_STEPS + 2),
                   steps=2, tokens_per_step=tokens)
    return launched


def train_grads_phase(fa, trainer) -> dict:
    """Kernel route against plain route on one forward/backward, at the
    trainer's weights (seed 0, before any update) and its first batch."""
    from pytorch_distributed_train_tpu_torch.losses import (
        fused_causal_lm_xent,
    )
    from pytorch_distributed_train_tpu_torch.models.llama import _Mode

    model = trainer.model
    model.zero_grad(set_to_none=True)
    gc.collect()
    torch.cuda.empty_cache()
    batch = next(iter(trainer.train_loader.epoch(0)))
    ids = batch["input_ids"]
    names = [n for n, _ in model.named_parameters()]
    L = len(model.layers)

    def run(m, kernel: bool):
        model.zero_grad(set_to_none=True)
        before = counts(fa)
        loss, _ = fused_causal_lm_xent(m(ids), batch)
        loss.backward()
        torch.cuda.synchronize()
        got = delta_counts(fa, before)
        want = ({"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L}
                if kernel else dict.fromkeys(got, 0))
        if got != want:
            fail(f"gradient run launched {got}, want {want}")
        return loss.item()

    def grads():
        return [p.grad for p in model.parameters()]

    def rel(a_list, b_list):
        return {n: ((a.float() - b.float()).norm() / b.float().norm()).item()
                for n, a, b in zip(names, a_list, b_list)}

    f32 = torch.float32
    loss = {"fp32_plain": run(model.twin(dtype=f32, attn_impl="xla"), False)}
    g32p = [g.clone() for g in grads()]
    loss["fp32_kernel"] = run(model.twin(dtype=f32), True)
    rel_fp32 = rel(grads(), g32p)
    loss["bf16_plain"] = run(model.twin(attn_impl="xla"), False)
    floor = rel(grads(), g32p)
    g16p = [g.clone() for g in grads()]
    loss["bf16_kernel"] = run(model, True)
    rel_bf16 = rel(grads(), g16p)
    kernel_vs_fp32 = rel(grads(), g32p)
    del g32p, g16p
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    detail = {
        "loss": loss,
        "loss_diff_fp32": loss["fp32_kernel"] - loss["fp32_plain"],
        "loss_diff_bf16": loss["bf16_kernel"] - loss["bf16_plain"],
        "rel_kernel_vs_plain_fp32_max": max(rel_fp32.values()),
        "rel_kernel_vs_plain_bf16_max": max(rel_bf16.values()),
        "rel_plain_bf16_vs_fp32_max": max(floor.values()),
        "rel_kernel_bf16_vs_fp32_max": max(kernel_vs_fp32.values()),
        "tol_fp32": GRAD_REL_TOL_FP32, "tol_bf16": GRAD_REL_TOL_BF16,
        "by_param": {n: [rel_fp32[n], rel_bf16[n], floor[n],
                         kernel_vs_fp32[n]] for n in names},
        "by_param_columns": ["kernel_vs_plain_fp32", "kernel_vs_plain_bf16",
                             "plain_bf16_vs_fp32", "kernel_bf16_vs_fp32"],
    }

    # each layer's bf16 attention input gradient, kernel vs plain, on the
    # same input and the same upstream gradient
    inputs = []
    hooks = [blk.attn.register_forward_hook(
        lambda mod, args, out: inputs.append(args[0].detach()))
        for blk in model.layers]
    with torch.no_grad():
        model(ids)
    for h in hooks:
        h.remove()
    gen = torch.Generator(device="cuda").manual_seed(1)
    attn_errs, kernel_vs_fp32, plain_vs_fp32 = [], [], []
    for i, (blk, x_in) in enumerate(zip(model.layers, inputs)):
        up = torch.randn(x_in.shape, generator=gen, device="cuda",
                         dtype=x_in.dtype)
        dx = {}
        # kernel and plain routes in bf16; the same layer in fp32 (its
        # fp32 params, the bf16 input and upstream gradient widened) as
        # the reference each route's rounding is read against
        for route, dtype in (("auto", x_in.dtype), ("xla", x_in.dtype),
                             ("fp32", torch.float32)):
            x = x_in.to(dtype).requires_grad_()
            before = counts(fa)
            y = blk.attn(x, model.rope, _Mode(
                False, False, "xla" if route == "fp32" else route, 0),
                None, i)
            dx[route], = torch.autograd.grad(y, x, up.to(dtype))
            got = delta_counts(fa, before)
            if got != dict.fromkeys(got, 1 if route == "auto" else 0):
                fail(f"layer {i} {route} attention launched {got}")
        attn_errs.append(row_rel_err(dx["auto"], dx["xla"], ROW_FLOOR))
        kernel_vs_fp32.append(row_rel_err(dx["auto"], dx["fp32"], ROW_FLOOR))
        plain_vs_fp32.append(row_rel_err(dx["xla"], dx["fp32"], ROW_FLOOR))
    detail.update(attn_input_grad_row_rel_by_layer=attn_errs,
                  attn_input_grad_row_rel_max=max(attn_errs),
                  attn_input_grad_row_tol=ATTN_GRAD_ROW_TOL,
                  attn_input_grad_kernel_vs_fp32_by_layer=kernel_vs_fp32,
                  attn_input_grad_plain_vs_fp32_by_layer=plain_vs_fp32)
    emit("train_grads", **detail)
    if detail["rel_kernel_vs_plain_fp32_max"] > GRAD_REL_TOL_FP32:
        fail("fp32 kernel-route gradients differ from the plain route by "
             f"{detail['rel_kernel_vs_plain_fp32_max']:.4g} "
             f"(limit {GRAD_REL_TOL_FP32})")
    if detail["rel_kernel_vs_plain_bf16_max"] > GRAD_REL_TOL_BF16:
        fail("bf16 kernel-route gradients differ from the plain route by "
             f"{detail['rel_kernel_vs_plain_bf16_max']:.4g} "
             f"(limit {GRAD_REL_TOL_BF16})")
    if max(attn_errs) > ATTN_GRAD_ROW_TOL:
        fail(f"bf16 attention input gradient through the kernels differs "
             f"from the plain route by {max(attn_errs):.4g} of a row's norm")
    return detail


def unported_kernels(card) -> None:
    """Bounds of the TPU kernels not ported yet, at the shapes their paths
    would run, and the one PyTorch call that computes K5's function (a
    yardstick for the later port)."""
    bf16 = PEAK_FLOPS[torch.bfloat16]

    def bound_of(nbytes, flops):
        t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / bf16
        return {"bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes > t_ops else "operations"}

    # K4: one ring-attention chunk step of a 4-way ring over S 4096 at the
    # training heads: 1024 local queries against one off-diagonal chunk of
    # 1024 keys (every pair kept); q, k, v bf16 in, O fp32 and lse out.
    B, H, D, C = 2, 32, 128, 1024
    k4 = bound_of(B * C * H * D * (3 * 2 + 4) + B * H * C * 4,
                  4 * B * H * D * C * C)
    k4.update(B=B, H=H, D=D, chunk=C, ring=4)
    # K5 (int8 W, per-output scales) and K6 (int4 W, group-128 scales
    # inside the contraction) at the llama2_7b projections, 4 decode rows.
    R = 4
    k5, k6 = {}, {}
    for name, (Hin, N) in {"q/k/v/o_proj": (4096, 4096),
                           "gate/up_proj": (4096, 11008),
                           "down_proj": (11008, 4096)}.items():
        io = R * Hin * 2 + R * N * 2
        flops = 2 * R * Hin * N
        k5[name] = bound_of(io + Hin * N + N * 4, flops)
        k6[name] = bound_of(io + Hin * N // 2 + Hin * (N // 128) * 4, flops)
        # torch._weight_int8pack_mm: x (R, H) @ int8 W (N, H)^T * scale (N,)
        x = torch.randn(R, Hin, device="cuda", dtype=torch.bfloat16)
        w = torch.randint(-127, 128, (N, Hin), device="cuda",
                          dtype=torch.int8)
        sc = torch.rand(N, device="cuda", dtype=torch.bfloat16)
        try:
            k5[name]["library_ms"] = time_ms(
                lambda: torch._weight_int8pack_mm(x, w, sc))
        except RuntimeError as e:  # a yardstick only: record why it is absent
            k5[name]["library_ms"] = None
            k5[name]["library_error"] = str(e).splitlines()[0][:200]
    emit("unported_kernels", K4=k4, K5=k5, K6=k6, rows=R, card=card,
         K6_library=("none: torch._weight_int4pack_mm groups scales along "
                     "the contraction in groups of 32-256 with zero points; "
                     "K6's scale changes at every input row"))


def serve_phase(fa, card) -> dict:
    """llama2_7b at full width behind the continuous batcher; returns the
    served run's launch counts. Everything it builds dies with its frame."""
    from pytorch_distributed_train_tpu_torch.config import get_preset
    from pytorch_distributed_train_tpu_torch.models.llama import init_params
    from pytorch_distributed_train_tpu_torch.serving import (
        ContinuousBatcher,
        build_serving_model,
    )

    cfg = get_preset("llama2_7b")
    t0 = time.perf_counter()
    params = init_params(cfg.model, cfg.precision, seed=0, device="cuda")
    batcher = ContinuousBatcher(cfg.model, cfg.precision, params, slots=4,
                                device="cuda")
    torch.cuda.synchronize()
    emit("slice_setup", seconds=time.perf_counter() - t0,
         layers=cfg.model.num_layers, hidden=cfg.model.hidden_size,
         weights_gb=sum(t.numel() * t.element_size()
                        for t in params.values()) / 1e9)
    rng = np.random.default_rng(0)
    lengths = [17, 300, 1000, 1500, 2000]
    budgets = [16, 24, 32, 20, 28]
    prompts = [rng.integers(0, cfg.model.vocab_size, n).tolist()
               for n in lengths]
    uids = [batcher.submit(p, n) for p, n in zip(prompts, budgets)]
    buckets = [batcher._bucket(n) for n in lengths]

    zero_counts(fa)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    done = {c.uid: c for c in batcher.run()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    serve_counts = counts(fa)
    launches = serve_counts["flash_fwd"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    st = batcher.stats
    for uid, n in zip(uids, budgets):
        c = done.get(uid)
        if c is None or len(c.tokens) != n or c.finish_reason != "length":
            fail(f"request {uid} did not finish with {n} tokens: {c}")
    per_prefill = cfg.model.num_layers
    if launches < per_prefill * len(prompts):
        fail(f"flash kernel launched {launches} times for {len(prompts)} "
             f"prefills; every prefill must launch it {per_prefill} times")
    decode_tokens = st["generated_tokens"] - st["prefills"]
    emit("slice", requests=len(prompts), prompt_lengths=lengths,
         buckets=buckets, max_new_tokens=budgets, wall_s=wall,
         flash_launches=launches, prefills=st["prefills"],
         decode_steps=st["steps"],
         prefill_tokens_per_s=st["prefill_tokens"] / st["admit_ms"] * 1e3,
         prefill_padded_tokens_per_s=(st["prefill_padded_tokens"]
                                      / st["admit_ms"] * 1e3),
         decode_tokens_per_s=decode_tokens / st["device_ms"] * 1e3,
         admit_ms=st["admit_ms"], decode_ms=st["device_ms"],
         host_ms=st["host_ms"], peak_memory_gb=peak_gb, card=card)

    # where the device time goes: one profiled serving run (4 prefills of
    # 512-token prompts, then batched decode steps), kernels by device time
    profile_run(batcher, rng, cfg.model.vocab_size)

    # The 2000-token prompt's last-token logits through the kernel route
    # and the plain attention route, in bf16 (the served path) and with the
    # same weights computed in fp32 (where the two routes must agree
    # closely: the fp32 kernel path against fp32 plain attention).
    long_prompt = prompts[-1]
    P = batcher._bucket(len(long_prompt))
    model = batcher.model
    attn_errs = attention_by_layer(model, long_prompt, P)
    emit("slice_attention", prompt_len=len(long_prompt), bucket=P,
         layers=len(attn_errs), row_rel_err_by_layer=attn_errs,
         row_rel_err_max=max(attn_errs), row_rel_tol=ATTN_ROW_REL_TOL)
    if len(attn_errs) != cfg.model.num_layers or max(
            attn_errs) > ATTN_ROW_REL_TOL:
        fail(f"bf16 attention through the kernel differs from the plain "
             f"attention by {max(attn_errs):.4g} of a row's norm "
             f"(limit {ATTN_ROW_REL_TOL}) over {len(attn_errs)} layers")
    batcher.cache = None  # free the slots for the fp32 model
    torch.cuda.empty_cache()
    fp32_prec = dataclasses.replace(cfg.precision, compute_dtype="float32")
    fp32_model = build_serving_model(cfg.model, fp32_prec, params,
                                     device="cuda")
    logits = {}
    for prec, m in (("bf16", model), ("fp32", fp32_model)):
        for route in ("pallas", "xla"):
            before = fa.flash_attention_fwd.launches
            t = prefill_logits(m.twin(attn_impl=route), long_prompt, P)
            launched = fa.flash_attention_fwd.launches - before
            if launched != (per_prefill if route == "pallas" else 0):
                fail(f"{prec} {route} route launched the kernel {launched} "
                     f"times (want one per layer on the kernel route only)")
            if t.shape != (1, cfg.model.vocab_size) or not torch.isfinite(
                    t).all():
                fail(f"{prec} {route} logits malformed: {tuple(t.shape)}")
            logits[prec, route] = t
    del fp32_model

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    ref = logits["fp32", "xla"]
    rel_bf16 = rel(logits["bf16", "pallas"], logits["bf16", "xla"])
    rel_fp32 = rel(logits["fp32", "pallas"], ref)
    first_tok = done[uids[-1]].tokens[0]
    emit("slice_logits", prompt_len=len(long_prompt), bucket=P,
         max_abs_logit=logits["bf16", "xla"].abs().max().item(),
         rel_kernel_vs_plain_bf16=rel_bf16, rel_tol_bf16=LOGIT_REL_TOL,
         rel_kernel_vs_plain_fp32=rel_fp32, rel_tol_fp32=LOGIT_REL_TOL_FP32,
         # the bf16 noise floor: each bf16 route against the fp32 reference
         rel_plain_bf16_vs_fp32=rel(logits["bf16", "xla"], ref),
         rel_kernel_bf16_vs_fp32=rel(logits["bf16", "pallas"], ref),
         argmax={f"{p}_{r}": int(t.argmax()) for (p, r), t in logits.items()},
         served_first_token=first_tok)
    if rel_bf16 > LOGIT_REL_TOL:
        fail(f"bf16 kernel-route logits differ from the plain route by "
             f"{rel_bf16:.4g} of max|logit| (limit {LOGIT_REL_TOL})")
    if rel_fp32 > LOGIT_REL_TOL_FP32:
        fail(f"fp32 kernel-route logits differ from the plain route by "
             f"{rel_fp32:.4g} of max|logit| (limit {LOGIT_REL_TOL_FP32})")
    if int(logits["bf16", "pallas"].argmax()) != first_tok:
        fail("the served first token is not the prefill logits' argmax")
    return serve_counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from pytorch_distributed_train_tpu_torch import kernels
    from pytorch_distributed_train_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi_line()

    # 1. device
    emit("device", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    kernels.load_all(["flash_fwd", "flash_bwd"])
    for lib in ("flash_fwd", "flash_bwd"):
        ptxas = [ln.strip() for ln in kernels.BUILD_LOGS.get(
            lib, "").splitlines() if "Used" in ln or "spill" in ln
            or "entry function" in ln]
        emit("build", kernel=lib, seconds=kernels.BUILD_SECONDS.get(lib),
             all_seconds=time.perf_counter() - t0, ptxas=ptxas)

    # 3. forward kernel against its plain version at the paths' shapes
    for S in (32, 128, 512, 1000, 1024, 2048):
        kernel_case(fa, S=S)
    kernel_case(fa, S=1000, Hkv=8)
    kernel_case(fa, S=1000, window=256)
    kernel_case(fa, S=1000, D=64)
    kernel_case(fa, S=1000, dtype=torch.float32)
    fwd_main = kernel_case(fa, B=2, S=4096)  # the training shape
    torch.cuda.empty_cache()

    # 4. backward kernels against their plain version
    bwd_main = bwd_kernel_case(fa, B=2, S=4096)  # the training shape
    bwd_kernel_case(fa, S=1000)
    bwd_kernel_case(fa, S=1000, Hkv=8)
    bwd_kernel_case(fa, S=1000, window=256)
    bwd_kernel_case(fa, S=1000, D=64)
    bwd_kernel_case(fa, S=1000, dtype=torch.float32)
    unported_kernels(card)
    torch.cuda.empty_cache()

    # 5. slice: llama2_7b at full width behind the continuous batcher
    serve_counts = serve_phase(fa, card)
    gc.collect()
    torch.cuda.empty_cache()

    # 6. train_grads: kernel route against plain route, at the seed-0
    # weights the training run then starts from
    trainer = build_trainer()
    train_grads_phase(fa, trainer)

    # 7. train: 10 steps through Trainer.fit
    train_counts = train_phase(fa, trainer, card)
    del trainer

    shape = {k: fwd_main[k] for k in ("B", "S", "H", "Hkv", "D", "dtype")}
    errs = bwd_main["errors"]
    rows = [
        ("flash_fwd", fwd_main["max_abs_err"], fwd_main["kernel_ms"],
         fwd_main["plain_ms"], fwd_main["bound_ms"], fwd_main["bound_by"],
         fwd_main["library_ms"]),
        ("flash_bwd_dq", errs["dq"]["max_abs_err"], bwd_main["dq_ms"],
         bwd_main["plain_ms"], bwd_main["dq_bound_ms"],
         bwd_main["dq_bound_by"], bwd_main["library_ms"]),
        ("flash_bwd_dkv", max(errs["dk"]["max_abs_err"],
                              errs["dv"]["max_abs_err"]), bwd_main["dkv_ms"],
         bwd_main["plain_ms"], bwd_main["dkv_bound_ms"],
         bwd_main["dkv_bound_by"], bwd_main["library_ms"]),
    ]
    # launches: the training path's run (the serving path's beside them);
    # the backward's plain_ms and library_ms time one call that computes
    # dq, dk and dv together
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": KERNELS[name][0],
        "replaces": KERNELS[name][1], "launches": train_counts[name],
        "launches_by_path": {"serve": serve_counts[name],
                             "train": train_counts[name]},
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
        "shape": shape,
    } for name, err, ms, plain_ms, bound_ms, bound_by, lib_ms in rows]}),
        flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
