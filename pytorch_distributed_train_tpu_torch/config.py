"""The slice's configuration: model architecture, precision, presets and
dotted ``key=value`` overrides (the ``--set`` flag of the CLIs).

Only the fields the Llama serving path reads are here. Field names and
defaults follow the JAX package's ``config.py`` so a preset reads the same
in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


@dataclass
class ModelConfig:
    name: str = "llama"
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: int = 0  # 0 -> = num_heads (MHA); < num_heads -> GQA
    mlp_dim: int = 3072
    vocab_size: int = 30522
    max_seq_len: int = 512
    rope_theta: float = 10000.0
    rope_scaling: float = 1.0
    rope_scaling_type: str = "linear"  # linear | ntk
    rms_norm_eps: float = 1e-5
    # auto | xla | pallas ("pallas" names the port's hand kernel)
    attention_impl: str = "auto"
    attention_window: int = 0  # sliding window span; 0 = full causal
    # Features of the JAX package this slice does not port yet: a
    # non-default value is refused when the model is built
    # (models/llama.py).
    kv_cache_dtype: str = ""
    segment_eos_id: int = -1
    num_experts: int = 0
    quant_training: str = ""


@dataclass
class PrecisionConfig:
    """Params are stored in ``param_dtype`` and compute runs in
    ``compute_dtype``. The port casts the weights to the compute dtype once,
    at load, which gives the same values as the JAX package's cast at every
    use."""

    compute_dtype: str = "float32"  # float32 | bfloat16
    param_dtype: str = "float32"


@dataclass
class ServeConfig:
    preset: str = ""
    model: ModelConfig = field(default_factory=ModelConfig)
    precision: PrecisionConfig = field(default_factory=PrecisionConfig)

    def override(self, dotted: str, value: str) -> None:
        """Apply one ``section.field=value`` override, coercing to the
        field's type."""
        parts = dotted.split(".")
        obj: Any = self
        for p in parts[:-1]:
            if not hasattr(obj, p):
                raise KeyError(f"no config section {p!r} in {dotted!r}")
            obj = getattr(obj, p)
        leaf = parts[-1]
        if not hasattr(obj, leaf):
            raise KeyError(f"no config field {leaf!r} in {dotted!r}")
        setattr(obj, leaf, _coerce(value, getattr(obj, leaf)))

    def apply_overrides(self, pairs: list[str]) -> None:
        for pair in pairs:
            if "=" not in pair:
                raise ValueError(f"override must be key=value, got {pair!r}")
            k, v = pair.split("=", 1)
            self.override(k.strip(), v.strip())


def _coerce(value: str, current: Any) -> Any:
    if isinstance(current, bool):
        if value.lower() in ("1", "true", "yes", "on"):
            return True
        if value.lower() in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"bad bool {value!r}")
    if isinstance(current, int):
        return int(value)
    if isinstance(current, float):
        return float(value)
    return value


def _llama2_7b() -> ServeConfig:
    """Llama-2 7B: hidden 4096, 32 layers, 32 heads (head dim 128), MLP
    11008, vocab 32000, context 4096, bf16 compute over fp32 params."""
    c = ServeConfig(preset="llama2_7b")
    c.model = ModelConfig(
        name="llama", hidden_size=4096, num_layers=32, num_heads=32,
        num_kv_heads=32, mlp_dim=11008, vocab_size=32000, max_seq_len=4096,
        rope_theta=10000.0, rms_norm_eps=1e-5,
    )
    c.precision = PrecisionConfig(compute_dtype="bfloat16")
    return c


_PRESETS = {"llama2_7b": _llama2_7b}


def list_presets() -> list[str]:
    return sorted(_PRESETS)


def get_preset(name: str) -> ServeConfig:
    if name not in _PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {list_presets()}")
    return _PRESETS[name]()
