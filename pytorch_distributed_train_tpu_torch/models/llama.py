"""Llama-2 decoder in PyTorch: the counterpart of the JAX package's
``models/llama.py`` for the serving and the training paths.

RMSNorm (fp32 math), rotary embeddings (split-half convention, linear or
ntk scaling), GQA-capable attention, SwiGLU MLP, untied LM head.

One class, two ways to hold the weights:

- serving (``trainable=False``): weights live in the compute dtype, cast
  once at load (the JAX package keeps fp32 params and casts them at every
  use, which gives the same values). The LM head keeps its bf16-rounded
  values in fp32.
- training (``trainable=True``): every weight is an ``nn.Parameter`` in
  ``param_dtype`` (fp32) with ``requires_grad``, cast to the compute dtype
  at every use, as the JAX package does; blocks run under remat when
  ``model.remat`` is set, and with ``model.fused_lm_loss`` the forward
  returns {'loss_sum', 'weight_sum'} through ``losses.chunked_causal_ce``.

Norm scales stay fp32 either way. The head multiplies bf16-rounded operands
in fp32, so the logits are fp32 with no bf16 rounding, as the JAX head's
``preferred_element_type`` gives.

Projection weights keep the JAX layout, (in, out), flattened to 2-D:
q/k/v (C, H*D), o (H*D, C), MLP (in, out), embedding (V, C), head (C, V).

Decode modes (the flags of the JAX module, set on a weight-sharing twin,
see :meth:`LlamaForCausalLM.twin`):

- ``decode``: a KV cache (:class:`KVCache`) is read and updated in place.
  A multi-token call is a prefill from position 0 (causal attention over the
  prompt through the configured ``attn_impl``); a one-token call appends at
  the cache's offset and attends over the cache (plain path).
- ``decode_rows``: the cache offset is per row, (B,), for continuous
  batching.

The JAX module's ``decode_multi`` (multi-token continuation, used by chat
sessions and speculative serving) waits for those features.

Not ported yet, and refused when asked for: MoE, context parallelism,
int8 QAT, the paged cache, fp8 KV storage, ``segment_eos_id`` and remat
policies other than "full".
"""

from __future__ import annotations

import copy
import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_distributed_train_tpu_torch.losses import chunked_causal_ce
from pytorch_distributed_train_tpu_torch.models import remat as remat_lib
from pytorch_distributed_train_tpu_torch.ops.attention import (
    VALID_IMPLS,
    dot_product_attention,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got {name!r}")
    return _DTYPES[name]


def rope_frequencies(head_dim: int, max_seq_len: int, theta: float,
                     scaling: float = 1.0, scaling_type: str = "linear",
                     device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables (S, head_dim/2) in fp32. "linear" divides positions by
    ``scaling``; "ntk" rescales the base instead."""
    if scaling_type not in ("linear", "ntk"):
        raise ValueError(
            f"rope_scaling_type must be 'linear' or 'ntk', got "
            f"{scaling_type!r}")
    if scaling_type == "ntk" and scaling != 1.0:
        theta = theta * scaling ** (head_dim / (head_dim - 2))
        scaling = 1.0
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    inv_freq = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                            device=device), exps)
    t = torch.arange(max_seq_len, dtype=torch.float32, device=device) / scaling
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x, cos, sin):
    """x (B, S, H, D), cos/sin (>= S, D/2): rotate the halves
    (x[..., :D/2], x[..., D/2:]). cos/sin are cast to x's dtype first."""
    S, D = x.shape[1], x.shape[-1]
    x1, x2 = x[..., : D // 2], x[..., D // 2:]
    cos = cos[None, :S, None, :].to(x.dtype)
    sin = sin[None, :S, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope_rows(x, cos, sin):
    """Per-row positions: x (B, S, H, D), cos/sin (B, S, D/2)."""
    D = x.shape[-1]
    x1, x2 = x[..., : D // 2], x[..., D // 2:]
    cos = cos[:, :, None, :].to(x.dtype)
    sin = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


@dataclasses.dataclass
class KVCache:
    """Static per-layer K/V buffers (B, max_seq_len, Hkv, D) and the write
    offset: a 0-d tensor, or (B,) in ``decode_rows`` mode. Updated in place
    by the model (the port's counterpart of the flax 'cache' collection)."""

    k: list[torch.Tensor]
    v: list[torch.Tensor]
    index: torch.Tensor


@dataclasses.dataclass(frozen=True)
class _Mode:
    decode: bool
    rows: bool
    attn_impl: str
    window: int


def _param(shape, dtype, device="meta"):
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def _cast(w, x):
    """A weight in x's dtype: a no-op for serving weights, the per-use cast
    of the fp32 params in training."""
    return w.to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = _param((dim,), torch.float32)

    def forward(self, x):
        dtype = x.dtype
        x = x.float()
        y = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + self.eps)
        return (y * self.scale).to(dtype)


class LlamaAttention(nn.Module):
    def __init__(self, hidden: int, num_heads: int, num_kv_heads: int,
                 dtype: torch.dtype):
        super().__init__()
        self.num_heads, self.num_kv_heads = num_heads, num_kv_heads
        self.head_dim = hidden // num_heads
        hd = self.head_dim
        self.q_proj = _param((hidden, num_heads * hd), dtype)
        self.k_proj = _param((hidden, num_kv_heads * hd), dtype)
        self.v_proj = _param((hidden, num_kv_heads * hd), dtype)
        self.o_proj = _param((num_heads * hd, hidden), dtype)

    def forward(self, x, rope, mode: _Mode, cache: KVCache | None,
                layer: int):
        B, S, C = x.shape
        H, Hkv, D = self.num_heads, self.num_kv_heads, self.head_dim
        q = (x @ _cast(self.q_proj, x)).view(B, S, H, D)
        k = (x @ _cast(self.k_proj, x)).view(B, S, Hkv, D)
        v = (x @ _cast(self.v_proj, x)).view(B, S, Hkv, D)
        cos, sin = rope
        if not mode.decode:
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
            y = dot_product_attention(q, k, v, causal=True,
                                      impl=mode.attn_impl, window=mode.window)
        elif S > 1:
            # Prefill: start this cache at position 0; causal attention over
            # the prompt only, through the configured implementation.
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
            cache.k[layer][:, :S] = k
            cache.v[layer][:, :S] = v
            y = dot_product_attention(q, k, v, causal=True,
                                      impl=mode.attn_impl, window=mode.window)
        else:
            # One step at the running offset (per row with decode_rows).
            # Writes start at the offset clamped to [0, L - S], as a
            # dynamic update does; a dead row's free-running offset thus
            # stays inside its own row, while its mask uses the unclamped
            # positions.
            L = cache.k[layer].shape[1]
            idx = cache.index if mode.rows else cache.index.expand(B)
            steps = torch.arange(S, device=x.device)
            pos = idx.clamp(0, L - S)[:, None] + steps  # (B, S)
            q = apply_rope_rows(q, cos[pos], sin[pos])
            k = apply_rope_rows(k, cos[pos], sin[pos])
            rows = torch.arange(B, device=x.device)[:, None]
            cache.k[layer][rows, pos] = k
            cache.v[layer][rows, pos] = v
            q_pos = idx[:, None] + steps  # (B, S)
            k_pos = torch.arange(L, device=x.device)
            mask = k_pos[None, None, :] <= q_pos[:, :, None]  # (B, S, L)
            if mode.window:
                mask &= (q_pos[:, :, None] - k_pos[None, None, :]) < mode.window
            y = dot_product_attention(q, cache.k[layer], cache.v[layer],
                                      mask=mask[:, None], impl="xla")
        return y.reshape(B, S, H * D) @ _cast(self.o_proj, x)


class LlamaMLP(nn.Module):
    def __init__(self, hidden: int, mlp_dim: int, dtype: torch.dtype):
        super().__init__()
        self.gate_proj = _param((hidden, mlp_dim), dtype)
        self.up_proj = _param((hidden, mlp_dim), dtype)
        self.down_proj = _param((mlp_dim, hidden), dtype)

    def forward(self, x):
        gate = F.silu(x @ _cast(self.gate_proj, x))
        return (gate * (x @ _cast(self.up_proj, x))) @ _cast(self.down_proj, x)


class LlamaBlock(nn.Module):
    def __init__(self, cfg, dtype: torch.dtype):
        super().__init__()
        self.input_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.attn = LlamaAttention(cfg.hidden_size, cfg.num_heads,
                                   cfg.num_kv_heads or cfg.num_heads, dtype)
        self.post_attn_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = LlamaMLP(cfg.hidden_size, cfg.mlp_dim, dtype)

    def forward(self, x, rope, mode, cache, layer):
        x = x + self.attn(self.input_norm(x), rope, mode, cache, layer)
        return x + self.mlp(self.post_attn_norm(x))


def _refuse_unported(cfg) -> None:
    unported = {
        "num_experts": (cfg.num_experts > 1, "MoE"),
        "quant_training": (bool(cfg.quant_training), "int8 QAT"),
        "kv_cache_dtype": (bool(cfg.kv_cache_dtype), "fp8/bf16 KV storage"),
        "segment_eos_id": (cfg.segment_eos_id >= 0,
                           "packed-document isolation"),
    }
    for key, (asked, what) in unported.items():
        if asked:
            raise NotImplementedError(
                f"model.{key} ({what}) is not ported to the PyTorch "
                "package yet")
    if cfg.attention_impl not in VALID_IMPLS:
        raise ValueError(f"model.attention_impl must be one of "
                         f"{VALID_IMPLS}, got {cfg.attention_impl!r}")


class LlamaForCausalLM(nn.Module):
    """input_ids (B, S) -> (B, S, vocab) fp32 logits, or, when trainable
    with ``fused_lm_loss``, {'loss_sum', 'weight_sum'}.

    ``params`` (name -> tensor) are adopted without a copy where their
    dtype and device already match, so training updates them in place."""

    def __init__(self, cfg, precision, params: dict, *, device="cuda",
                 trainable: bool = False):
        super().__init__()
        _refuse_unported(cfg)
        if trainable and cfg.remat:
            remat_lib.check_policy(cfg.remat_policy)
        self.trainable = trainable
        if cfg.name != "llama":
            raise ValueError(f"not a llama config: {cfg.name!r}")
        if cfg.hidden_size % cfg.num_heads:
            raise ValueError("hidden_size must divide by num_heads")
        self.cfg = cfg
        self.dtype = torch_dtype(precision.compute_dtype)
        store = torch_dtype(precision.param_dtype) if trainable else self.dtype
        self.max_seq_len = cfg.max_seq_len
        self.attn_impl = cfg.attention_impl
        self.decode = self.decode_rows = False
        self.tok_embed = _param((cfg.vocab_size, cfg.hidden_size), store)
        self.layers = nn.ModuleList(
            LlamaBlock(cfg, store) for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.lm_head = _param((cfg.hidden_size, cfg.vocab_size), torch.float32)
        self._load(params, torch.device(device))
        head_dim = cfg.hidden_size // cfg.num_heads
        self.rope = rope_frequencies(head_dim, cfg.max_seq_len,
                                     cfg.rope_theta, cfg.rope_scaling,
                                     cfg.rope_scaling_type, device=device)

    @property
    def device(self) -> torch.device:
        return self.tok_embed.device

    def _load(self, params: dict, device: torch.device) -> None:
        """Adopt ``params`` (name -> tensor) in the model's dtypes on
        ``device``. A tensor already in the right dtype and device is taken
        as it is, without a copy."""
        names = dict(self.named_parameters())
        missing = sorted(set(names) - set(params))
        extra = sorted(set(params) - set(names))
        if missing or extra:
            raise KeyError(f"params do not match the model: missing "
                           f"{missing[:4]}, unexpected {extra[:4]}")
        for name, p in names.items():
            src = params[name]
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)}, model "
                                 f"wants {tuple(p.shape)}")
            if name == "lm_head" and not self.trainable:
                # bf16 operands, fp32 accumulation: keep the head's
                # compute-dtype values in fp32
                src = src.to(device=device, dtype=self.dtype)
            t = src.to(device=device, dtype=p.dtype)
            mod, _, leaf = name.rpartition(".")
            owner = self.get_submodule(mod) if mod else self
            setattr(owner, leaf, nn.Parameter(t, requires_grad=self.trainable))

    def twin(self, *, decode: bool | None = None,
             decode_rows: bool | None = None,
             attn_impl: str | None = None,
             dtype: torch.dtype | None = None) -> "LlamaForCausalLM":
        """A copy that shares every weight, with other mode flags (or, for
        a trainable model, another compute dtype)."""
        if dtype is not None and not self.trainable:
            raise ValueError("a serving model holds its weights in its "
                             "compute dtype; build another for another dtype")
        m = copy.copy(self)
        for k, val in (("decode", decode), ("decode_rows", decode_rows),
                       ("attn_impl", attn_impl), ("dtype", dtype)):
            if val is not None:
                object.__setattr__(m, k, val)
        return m

    def forward(self, input_ids, cache: KVCache | None = None):
        if self.decode and cache is None:
            raise ValueError("decode mode needs a KVCache (generate.init_cache)")
        B, S = input_ids.shape
        mode = _Mode(self.decode, self.decode_rows, self.attn_impl, self.cfg.attention_window)
        rope = self.rope
        if S > self.max_seq_len and not self.decode:
            head_dim = self.cfg.hidden_size // self.cfg.num_heads
            rope = rope_frequencies(head_dim, S, self.cfg.rope_theta,
                                    self.cfg.rope_scaling,
                                    self.cfg.rope_scaling_type,
                                    device=input_ids.device)
        x = F.embedding(input_ids, self.tok_embed).to(self.dtype)
        remat = self.trainable and self.cfg.remat and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            if remat:
                x = remat_lib.remat_call(layer, x, rope, mode, cache, i)
            else:
                x = layer(x, rope, mode, cache, i)
        if self.decode:
            if S > 1:
                cache.index.fill_(S)
            else:
                cache.index.add_(S)
        x = self.final_norm(x)
        if not self.trainable:
            return x.float() @ self.lm_head
        head = self.lm_head.to(self.dtype)
        if self.cfg.fused_lm_loss and not self.decode:
            return chunked_causal_ce(x, head, input_ids)
        return x.float() @ head.float()


def param_shapes(cfg, precision, *, trainable: bool = False
                 ) -> dict[str, tuple[tuple, torch.dtype]]:
    """name -> (shape, storage dtype) of the model's weights: the compute
    dtype for serving, ``param_dtype`` for training."""
    dtype = torch_dtype(precision.param_dtype if trainable
                        else precision.compute_dtype)
    with torch.device("meta"):
        blk = LlamaBlock(cfg, dtype)
    out = {"tok_embed": ((cfg.vocab_size, cfg.hidden_size), dtype)}
    for i in range(cfg.num_layers):
        for name, p in blk.named_parameters():
            out[f"layers.{i}.{name}"] = (tuple(p.shape), p.dtype)
    out["final_norm.scale"] = ((cfg.hidden_size,), torch.float32)
    out["lm_head"] = ((cfg.hidden_size, cfg.vocab_size), dtype)
    return out


def init_params(cfg, precision, *, seed: int = 0, device="cuda",
                trainable: bool = False) -> dict:
    """Random weights drawn from ``seed`` directly on ``device`` in their
    storage dtype (see :func:`param_shapes`): normal(0, 0.02) for every
    matrix, ones for the norm scales (the JAX package's initialisers; the
    draws differ)."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    out = {}
    for name, (shape, dtype) in param_shapes(
            cfg, precision, trainable=trainable).items():
        if name.endswith(".scale"):
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        else:
            t = torch.empty(shape, dtype=dtype, device=device)
            out[name] = t.normal_(0.0, 0.02, generator=g)
    return out


def llama(cfg, precision, params=None, *, device="cuda", seed: int = 0,
          trainable: bool = False):
    if params is None:
        params = init_params(cfg, precision, seed=seed, device=device,
                             trainable=trainable)
    return LlamaForCausalLM(cfg, precision, params, device=device,
                            trainable=trainable)
