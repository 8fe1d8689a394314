"""Model registry: config name -> PyTorch model, for serving or training.
The port has the llama family only."""

from __future__ import annotations

from pytorch_distributed_train_tpu_torch.models import llama as _llama

_REGISTRY = {"llama": _llama.llama}


def list_models() -> list[str]:
    return sorted(_REGISTRY)


def build_model(model_cfg, precision_cfg, params: dict | None = None, *,
                device="cuda", seed: int = 0, trainable: bool = False):
    """Build ``model_cfg.name`` under ``precision_cfg`` on ``device``, with
    ``params`` (name -> tensor, e.g. from ``interop.params_from_jax``) or,
    when None, weights drawn from ``seed`` on the device. ``trainable``
    builds the training model (fp32 params with gradients, cast at use)."""
    name = model_cfg.name
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; the PyTorch package has "
                       f"{list_models()}")
    return _REGISTRY[name](model_cfg, precision_cfg, params, device=device,
                           seed=seed, trainable=trainable)
