"""Autoregressive generation with a KV cache (llama family).

The counterpart of the JAX package's ``generate.py``. The KV cache is a
static (B, max_seq_len, Hkv, D) buffer per layer, updated in place; the
prefill is one call over the whole prompt and every later token is a
single-token step. The model owns its weights, so the functions take the
model where the JAX ones take (model, params).

Sampling: greedy, or temperature with top-k / top-p / min-p filtering
(:func:`filter_logits`, the JAX package's rules), drawn from an explicit
``torch.Generator``. Its draws differ from ``jax.random``'s; greedy
decoding is token-identical.

Not ported in this slice: penalties, ``logit_bias``, beam search, seq2seq
and multi-device meshes.
"""

from __future__ import annotations

import torch

from pytorch_distributed_train_tpu_torch.models.llama import KVCache
from pytorch_distributed_train_tpu_torch.models.registry import build_model


def build_decode_model(model_cfg, precision, params: dict | None = None, *,
                       device="cuda", seed: int = 0):
    """The decode-mode model: KV cache enabled. Weights from ``params``, or
    drawn from ``seed`` on ``device``."""
    return build_model(model_cfg, precision, params, device=device,
                       seed=seed).twin(decode=True)


def init_cache(model, batch: int) -> KVCache:
    """Zeroed static KV cache for ``batch`` sequences on the model's
    device, in its compute dtype; the offset is (batch,) for a
    ``decode_rows`` model, else 0-d."""
    cfg = model.cfg
    hkv = cfg.num_kv_heads or cfg.num_heads
    shape = (batch, cfg.max_seq_len, hkv, cfg.hidden_size // cfg.num_heads)
    dev = model.device

    def zeros():
        return torch.zeros(shape, dtype=model.dtype, device=dev)

    idx_shape = (batch,) if model.decode_rows else ()
    return KVCache(k=[zeros() for _ in range(cfg.num_layers)],
                   v=[zeros() for _ in range(cfg.num_layers)],
                   index=torch.zeros(idx_shape, dtype=torch.long, device=dev))


@torch.no_grad()
def _decode_step(model, cache: KVCache, ids):
    """One decode call (prefill or step); returns the last position's
    logits (B, V) fp32. ``cache`` is updated in place."""
    return model(ids, cache)[:, -1]


def filter_logits(logits, temperature, top_k: int, top_p=0.0, min_p=0.0):
    """Temperature scaling, then top-k, top-p (nucleus) and min-p
    truncation; removed entries become -inf.

    ``temperature``, ``top_p`` and ``min_p`` are a Python number or a
    tensor broadcastable against (B, 1) (per-row values; out-of-range
    entries of a tensor disable that filter for the row).
    - top-p keeps the smallest sorted prefix whose mass reaches top_p: a
      token survives iff the mass strictly before it is < top_p (the argmax
      always survives; a prefix landing exactly on top_p drops the next
      token). Ties are ranked by a stable sort, by original position.
    - min-p keeps tokens whose probability is >= min_p x the max
      probability."""
    logits = logits / temperature
    neg = torch.tensor(float("-inf"), dtype=logits.dtype, device=logits.device)
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg, logits)
    p_static = isinstance(top_p, (int, float))
    if (not p_static) or 0.0 < top_p < 1.0:
        p_eff = top_p if p_static else torch.where(
            (top_p > 0.0) & (top_p < 1.0), top_p, torch.ones_like(top_p))
        srt_idx = torch.argsort(-logits, dim=-1, stable=True)
        srt = torch.gather(logits, -1, srt_idx)
        p_srt = torch.softmax(srt, dim=-1)
        before = torch.cumsum(p_srt, dim=-1) - p_srt  # exclusive cumsum
        keep = torch.gather(before < p_eff, -1,
                            torch.argsort(srt_idx, dim=-1))
        logits = torch.where(keep, logits, neg)
    m_static = isinstance(min_p, (int, float))
    if (not m_static) or 0.0 < min_p < 1.0:
        m_eff = min_p if m_static else torch.where(
            (min_p > 0.0) & (min_p < 1.0), min_p, torch.zeros_like(min_p))
        probs = torch.softmax(logits, dim=-1)
        floor = m_eff * probs.amax(dim=-1, keepdim=True)
        logits = torch.where(probs >= floor, logits, neg)
    return logits


def _categorical(logits, generator):
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _sample(logits, generator, temperature: float, top_k: int,
            top_p: float = 0.0, min_p: float = 0.0):
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    return _categorical(filter_logits(logits, temperature, top_k, top_p,
                                      min_p), generator)


@torch.no_grad()
def generate(model, prompt_ids, max_new_tokens: int, *,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
             min_p: float = 0.0, generator: torch.Generator | None = None,
             eos_id: int | None = None):
    """Continue a (B, S) prompt batch; returns (B, S + max_new_tokens) ids
    on the model's device. ``eos_id`` freezes finished rows (their later
    tokens are ``eos_id``)."""
    prompt_ids = torch.as_tensor(prompt_ids, dtype=torch.long,
                                 device=model.device)
    B, S = prompt_ids.shape
    if S + max_new_tokens > model.max_seq_len:
        raise ValueError(
            f"prompt ({S}) + new tokens ({max_new_tokens}) exceeds "
            f"max_seq_len ({model.max_seq_len})")
    if temperature != 0.0 and generator is None:
        generator = torch.Generator(device=model.device)
        generator.manual_seed(0)
    cache = init_cache(model, B)
    logits = _decode_step(model, cache, prompt_ids)  # prefill
    out = [prompt_ids]
    done = torch.zeros(B, dtype=torch.bool, device=model.device)
    for i in range(max_new_tokens):
        nxt = _sample(logits, generator, temperature, top_k, top_p, min_p)
        if eos_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            done = done | (nxt == eos_id)
        out.append(nxt[:, None])
        if i + 1 < max_new_tokens:  # the last sample needs no forward
            logits = _decode_step(model, cache, nxt[:, None])
    return torch.cat(out, dim=1)
