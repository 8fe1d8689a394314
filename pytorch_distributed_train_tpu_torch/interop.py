"""Weights from the JAX package's layout.

:func:`params_from_jax` takes a llama param tree as the JAX package builds
it (nested dicts, leaves as numpy arrays; flax names) and returns the
port's weight dict (name -> fp32 CPU tensor), which ``build_model`` and the
batcher take as ``params``. Layouts:

- ``layer{i}/attn/{q,k,v}_proj/kernel`` (C, H, D) -> ``layers.{i}.attn.*``
  (C, H*D)
- ``layer{i}/attn/o_proj/kernel`` (H, D, C) -> (H*D, C)
- dense kernels (in, out), kept as they are
- ``tok_embed/embedding`` (V, C) -> ``tok_embed``
- ``lm_head/kernel`` (C, V) -> ``lm_head``
- RMSNorm ``scale`` (C,) -> ``*.scale``
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix=()) -> dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _port_name(path: tuple) -> tuple[str, str]:
    """(port name, how to reshape) for one flax param path."""
    if path == ("tok_embed", "embedding"):
        return "tok_embed", "keep"
    if path == ("lm_head", "kernel"):
        return "lm_head", "keep"
    if path == ("final_norm", "scale"):
        return "final_norm.scale", "keep"
    head, *rest = path
    if not head.startswith("layer") or not head[5:].isdigit():
        raise KeyError(f"unknown llama param {'/'.join(path)}")
    i = int(head[5:])
    rest = tuple(rest)
    if rest in (("input_norm", "scale"), ("post_attn_norm", "scale")):
        return f"layers.{i}.{rest[0]}.scale", "keep"
    if len(rest) == 3 and rest[0] == "attn" and rest[2] == "kernel":
        if rest[1] in ("q_proj", "k_proj", "v_proj"):
            return f"layers.{i}.attn.{rest[1]}", "in_heads"
        if rest[1] == "o_proj":
            return f"layers.{i}.attn.o_proj", "heads_out"
    if (len(rest) == 3 and rest[0] == "mlp" and rest[2] == "kernel"
            and rest[1] in ("gate_proj", "up_proj", "down_proj")):
        return f"layers.{i}.mlp.{rest[1]}", "keep"
    raise KeyError(f"llama param {'/'.join(path)} has no counterpart in the "
                   "PyTorch package (MoE, QAT and LoRA are not ported)")


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """The JAX package's llama params (numpy leaves) -> the port's weight
    dict, fp32 on the CPU."""
    out = {}
    for path, arr in _flatten(tree).items():
        name, how = _port_name(path)
        if how == "in_heads":  # (C, H, D) -> (C, H*D)
            arr = arr.reshape(arr.shape[0], -1)
        elif how == "heads_out":  # (H, D, C) -> (H*D, C)
            arr = arr.reshape(-1, arr.shape[-1])
        out[name] = torch.from_numpy(np.array(arr, np.float32, order="C"))
    return out
