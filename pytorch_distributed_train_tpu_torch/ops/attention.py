"""Attention core with a single dispatch point.

The counterpart of the JAX package's ``ops/attention.py``. Shapes are
(batch, seq, heads, head_dim). ``impl``:

- ``"xla"``: the plain PyTorch path (:func:`_xla_attention`), with the JAX
  package's casts: fp32 scores, masked with the fp32 minimum, fp32 softmax,
  probabilities cast back to the input dtype before P.V.
- ``"pallas"``: the port's hand kernel (``ops/flash_attention.py``); it
  raises for shapes the kernel does not take. On CPU tensors the kernel's
  plain version runs, as the JAX kernel runs in interpret mode off the TPU.
- ``"auto"``: on CUDA every call the kernel supports goes to it; otherwise
  the plain path.
"""

from __future__ import annotations

import torch

from pytorch_distributed_train_tpu_torch.ops import flash_attention as _fa

VALID_IMPLS = ("auto", "xla", "pallas")


def expand_kv_heads(k, v, num_heads: int):
    """Repeat GQA KV heads up to ``num_heads`` (query head h reads KV head
    h // rep)."""
    h_kv = k.shape[2]
    if h_kv == num_heads:
        return k, v
    if h_kv == 0 or num_heads % h_kv != 0:
        raise ValueError(
            f"query heads {num_heads} not divisible by kv heads {h_kv}")
    rep = num_heads // h_kv
    return (k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2))


def dot_product_attention(q, k, v, *, causal: bool = False, mask=None,
                          impl: str = "auto", window: int = 0):
    """q (B, Sq, H, D), k/v (B, Sk, Hkv, D); ``mask`` (B, 1, Sq, Sk) or
    broadcastable, True = keep."""
    if impl not in VALID_IMPLS:
        raise ValueError(
            f"attention impl must be one of {VALID_IMPLS}, got {impl!r}")
    if window:
        if window < 0:
            raise ValueError(f"window must be >= 0, got {window}")
        if not causal:
            raise ValueError("window attention requires causal=True")
    if impl in ("auto", "pallas"):
        if _fa.supported(q, k, v, causal=causal, mask=mask, window=window):
            if impl == "pallas" or q.device.type == "cuda":
                return _fa.flash_attention(q, k, v, causal=causal,
                                           window=window)
        elif impl == "pallas":
            raise ValueError(
                "flash attention kernel unsupported for these shapes")
    return _xla_attention(q, k, v, causal=causal, mask=mask, window=window)


def _xla_attention(q, k, v, *, causal, mask, window=0):
    orig_dtype = q.dtype
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    k, v = expand_kv_heads(k, v, H)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    logits = logits * (1.0 / torch.sqrt(torch.tensor(D, dtype=torch.float32)))
    neg = torch.finfo(torch.float32).min
    if causal:
        # align ends for KV-cache decode
        q_pos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
        k_pos = torch.arange(Sk, device=q.device)[None, :]
        keep = q_pos >= k_pos
        if window:
            keep = keep & ((q_pos - k_pos) < window)
        logits = logits.masked_fill(~keep, neg)
    if mask is not None:
        logits = logits.masked_fill(~mask, neg)
    probs = torch.softmax(logits, dim=-1).to(orig_dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
