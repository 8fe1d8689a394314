"""The port's configuration: model architecture, precision, data, optimizer,
presets and dotted ``key=value`` overrides (the ``--set`` flag of the CLIs).

One preset serves both CLIs (``generate_cli`` reads ``model`` and
``precision``, ``train_cli`` the whole config), as in the JAX package. Only
the fields the ported paths read are here. Field names and defaults follow
the JAX package's ``config.py``, so a preset reads the same in both
packages. A few fields exist only to be refused: set to anything but their
default, :func:`refuse_unported` raises ``NotImplementedError`` (features of
the JAX package not ported yet). A field the JAX package has and this one
lacks is refused by ``--set`` as unknown.
"""

from __future__ import annotations

import dataclasses
import json
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
    # Recompute each block's activations in backward (models/remat.py);
    # only the "full" policy is ported.
    remat: bool = False
    remat_policy: str = "full"
    # Fused chunked LM-head loss (losses.chunked_causal_ce): the training
    # forward returns {'loss_sum', 'weight_sum'} instead of (B, S, V)
    # logits. Pairs with loss="fused_causal_lm_xent".
    fused_lm_loss: bool = False
    # auto | xla | pallas ("pallas" names the port's hand kernels)
    attention_impl: str = "auto"
    attention_window: int = 0  # sliding window span; 0 = full causal
    # Features of the JAX package not ported yet: a non-default value is
    # refused when the model is built (models/llama.py).
    kv_cache_dtype: str = ""
    segment_eos_id: int = -1
    num_experts: int = 0
    quant_training: str = ""


@dataclass
class PrecisionConfig:
    """Params are stored in ``param_dtype`` and compute runs in
    ``compute_dtype``. Training keeps the params in ``param_dtype`` and
    casts them at every use, as the JAX package does; serving casts them
    once, at load, which gives the same values."""

    compute_dtype: str = "float32"  # float32 | bfloat16
    param_dtype: str = "float32"
    loss_scale: str = "none"  # refused unless "none" (DynamicScale)


@dataclass
class DataConfig:
    """``batch_size`` is global (one host here)."""

    dataset: str = "synthetic_images"  # only synthetic_lm is ported
    batch_size: int = 128
    seed: int = 0
    seq_len: int = 512
    synthetic_size: int = 51200


@dataclass
class OptimConfig:
    name: str = "sgd"  # only adamw is ported
    learning_rate: float = 0.1
    warmup_steps: int = 0
    schedule: str = "cosine"  # constant | cosine | linear
    weight_decay: float = 1e-4
    # comma-separated regexes over the JAX param path ("layer0/input_norm/
    # scale"); matching params skip weight decay
    decay_exclude: str = ""
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    grad_clip_norm: float = 0.0  # 0 -> off
    end_lr_factor: float = 0.0
    # not ported: refused unless at their defaults
    accum_steps: int = 1
    ema_decay: float = 0.0
    swa_start_step: int = 0
    moment_dtype: str = ""
    layer_lr_decay: float = 1.0
    plateau_factor: float = 0.0
    grad_hook: str = "none"


@dataclass
class TrainStepConfig:
    """Not ported: in-graph microbatching and the fused epilogue."""

    grad_accum_steps: int = 1
    fused_epilogue: bool = False


@dataclass
class CheckpointConfig:
    """Checkpointing is not ported: saving is off (0) and refused when set."""

    save_every_steps: int = 0


@dataclass
class ObsConfig:
    log_every_steps: int = 50


@dataclass
class TrainConfig:
    preset: str = ""
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    precision: PrecisionConfig = field(default_factory=PrecisionConfig)
    train: TrainStepConfig = field(default_factory=TrainStepConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)
    epochs: int = 0  # train horizon: epochs if > 0, else total_steps
    total_steps: int = 1000
    eval_every_steps: int = 0  # eval is not ported: refused when set
    seed: int = 42
    # causal_lm_xent | fused_causal_lm_xent
    loss: str = "softmax_xent"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

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


# dotted field -> what it asks for; refused unless at its default
_UNPORTED_TRAINING = {
    "precision.loss_scale": "dynamic/static loss scaling (DynamicScale)",
    "optim.accum_steps": "optax.MultiSteps accumulation",
    "optim.ema_decay": "EMA weights",
    "optim.swa_start_step": "SWA weights",
    "optim.moment_dtype": "narrowed optimizer moments",
    "optim.layer_lr_decay": "layer-wise LR decay",
    "optim.plateau_factor": "reduce-on-plateau",
    "optim.grad_hook": "gradient compression hooks",
    "train.grad_accum_steps": "in-graph microbatching",
    "train.fused_epilogue": "the fused optimizer epilogue",
    "checkpoint.save_every_steps": "checkpointing",
    "eval_every_steps": "evaluation",
}


def refuse_unported(cfg: TrainConfig) -> None:
    """Raise NotImplementedError for a training feature the port lacks."""
    default = TrainConfig()
    for dotted, what in _UNPORTED_TRAINING.items():
        obj, ref = cfg, default
        for part in dotted.split("."):
            obj, ref = getattr(obj, part), getattr(ref, part)
        if obj != ref:
            raise NotImplementedError(
                f"{dotted}={obj!r} ({what}) is not ported to the PyTorch "
                "package yet")


def _llama2_7b() -> TrainConfig:
    """Llama-2 7B pretrain (the JAX preset): hidden 4096, 32 layers, 32
    heads (head dim 128), MLP 11008, vocab 32000, context 4096; bf16
    compute over fp32 params, remat, the fused chunked head loss; AdamW
    (lr 3e-4, wd 0.1, b2 0.95, cosine after 2000 warmup steps, clip 1.0,
    no decay on RMSNorm scales) on synthetic_lm at seq 4096. The JAX
    preset shards it with FSDP; that mesh has no counterpart here."""
    c = TrainConfig(preset="llama2_7b")
    c.model = ModelConfig(
        name="llama", hidden_size=4096, num_layers=32, num_heads=32,
        num_kv_heads=32, mlp_dim=11008, vocab_size=32000, max_seq_len=4096,
        rope_theta=10000.0, rms_norm_eps=1e-5, remat=True,
        fused_lm_loss=True,
    )
    c.data = DataConfig(dataset="synthetic_lm", batch_size=128, seq_len=4096)
    c.optim = OptimConfig(
        name="adamw", learning_rate=3e-4, weight_decay=0.1, beta2=0.95,
        schedule="cosine", warmup_steps=2000, grad_clip_norm=1.0,
        decay_exclude=r"scale$",
    )
    c.precision = PrecisionConfig(compute_dtype="bfloat16")
    c.total_steps = 500000
    c.loss = "fused_causal_lm_xent"
    return c


_PRESETS = {"llama2_7b": _llama2_7b}


def list_presets() -> list[str]:
    return sorted(_PRESETS)


def get_preset(name: str) -> TrainConfig:
    if name not in _PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {list_presets()}")
    return _PRESETS[name]()
