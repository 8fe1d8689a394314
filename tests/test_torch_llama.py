"""The PyTorch package's Llama against the JAX package's, on the CPU in
fp32: same weights (carried over by ``interop.params_from_jax``), same
numpy inputs, the model-twin tolerance of ``tests/test_torch_parity.py``
(atol 2e-4, rtol 1e-3)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_train_tpu.config import ModelConfig as JModelConfig
from pytorch_distributed_train_tpu.config import (
    PrecisionConfig as JPrecisionConfig,
)
from pytorch_distributed_train_tpu.generate import (
    _decode_step as j_decode_step,
)
from pytorch_distributed_train_tpu.generate import (
    build_decode_model as j_build_decode_model,
)
from pytorch_distributed_train_tpu.generate import init_cache as j_init_cache
from pytorch_distributed_train_tpu.models import llama as jllama
from pytorch_distributed_train_tpu.models.registry import (
    build_model as j_build_model,
)
from pytorch_distributed_train_tpu_torch.config import (
    ModelConfig,
    PrecisionConfig,
    get_preset,
)
from pytorch_distributed_train_tpu_torch.generate import (
    _decode_step,
    build_decode_model,
    init_cache,
)
from pytorch_distributed_train_tpu_torch.interop import params_from_jax
from pytorch_distributed_train_tpu_torch.models import llama as tllama
from pytorch_distributed_train_tpu_torch.models.registry import build_model

ATOL, RTOL = 2e-4, 1e-3
SMALL = dict(name="llama", hidden_size=256, num_layers=2, num_heads=4,
             num_kv_heads=2, mlp_dim=512, vocab_size=512, max_seq_len=256)


@pytest.fixture(scope="module")
def twins():
    jcfg = JModelConfig(**SMALL)
    jparams = j_build_model(jcfg, JPrecisionConfig()).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 4), jnp.int32),
        train=False)["params"]
    jparams = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, ModelConfig(**SMALL), params_from_jax(jparams)


def _ids(B, S, seed):
    return np.random.default_rng(seed).integers(0, SMALL["vocab_size"],
                                                (B, S)).astype(np.int32)


@pytest.mark.parametrize("impl,window", [("auto", 0), ("xla", 0),
                                         ("pallas", 0), ("pallas", 16)])
def test_forward_logits_match_jax(twins, impl, window):
    jcfg, jparams, cfg, params = twins
    jcfg = dataclasses.replace(jcfg, attention_window=window)
    cfg = dataclasses.replace(cfg, attention_window=window)
    ids = _ids(2, 64, seed=1)
    jm = j_build_model(jcfg, JPrecisionConfig())
    ref = np.asarray(jm.apply({"params": jparams}, jnp.asarray(ids),
                              train=False))
    model = build_model(dataclasses.replace(cfg, attention_impl=impl),
                        PrecisionConfig(), params, device="cpu")
    out = model(torch.from_numpy(ids).long())
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("window", [0, 8])
def test_decode_prefill_then_steps_match_jax(twins, window):
    jcfg, jparams, cfg, params = twins
    jcfg = dataclasses.replace(jcfg, attention_window=window)
    cfg = dataclasses.replace(cfg, attention_window=window)
    rng = np.random.default_rng(2)
    prompt = _ids(2, 12, seed=3)
    steps = rng.integers(0, SMALL["vocab_size"], (3, 2, 1)).astype(np.int32)
    jm = j_build_decode_model(jcfg, JPrecisionConfig())
    jcache = j_init_cache(jm, 2)
    model = build_decode_model(cfg, PrecisionConfig(), params, device="cpu")
    cache = init_cache(model, 2)
    for ids in [prompt, *steps]:
        ref, jcache = j_decode_step(jm, jparams, jcache, jnp.asarray(ids))
        out = _decode_step(model, cache, torch.from_numpy(ids).long())
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   atol=ATOL, rtol=RTOL)
    assert int(cache.index) == 12 + 3


def test_decode_rows_offsets_match_jax(twins):
    """Per-row offsets (continuous batching): rows prefilled to different
    lengths step together; each row matches the JAX decode_rows model."""
    jcfg, jparams, cfg, params = twins
    jm = dataclasses.replace(j_build_decode_model(jcfg, JPrecisionConfig()),
                             decode_rows=True)
    jcache = j_init_cache(jm, 2)
    model = build_decode_model(cfg, PrecisionConfig(), params,
                               device="cpu").twin(decode_rows=True)
    cache = init_cache(model, 2)
    ids = _ids(2, 8, seed=4)
    _, jcache = j_decode_step(jm, jparams, jcache, jnp.asarray(ids))
    _decode_step(model, cache, torch.from_numpy(ids).long())
    # rewind row 1 to offset 5, as an admission of a shorter prompt would
    jcache = jax.tree.map(
        lambda x: x.at[1].set(5) if x.ndim == 1 else x, jcache)
    cache.index[1] = 5
    for s in range(3):
        step = _ids(2, 1, seed=10 + s)
        ref, jcache = j_decode_step(jm, jparams, jcache, jnp.asarray(step))
        out = _decode_step(model, cache, torch.from_numpy(step).long())
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   atol=ATOL, rtol=RTOL)
    assert cache.index.tolist() == [11, 8]


@pytest.mark.parametrize("scaling,kind", [(1.0, "linear"), (2.0, "linear"),
                                          (4.0, "ntk")])
def test_rope_matches_jax(scaling, kind):
    jcos, jsin = jllama.rope_frequencies(64, 128, 10000.0, scaling, kind)
    cos, sin = tllama.rope_frequencies(64, 128, 10000.0, scaling, kind)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-5)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-5)
    x = np.random.default_rng(0).standard_normal((1, 16, 2, 64)).astype(
        np.float32)
    ref = jllama.apply_rope(jnp.asarray(x), jcos, jsin)
    out = tllama.apply_rope(torch.from_numpy(x), cos, sin)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    with pytest.raises(ValueError, match="rope_scaling_type"):
        tllama.rope_frequencies(64, 8, 1e4, 2.0, "yarn")


def test_params_from_jax_layouts(twins):
    _, jparams, cfg, params = twins
    H, Hkv, D = 4, 2, 64
    assert tuple(params["layers.0.attn.q_proj"].shape) == (256, H * D)
    assert tuple(params["layers.0.attn.k_proj"].shape) == (256, Hkv * D)
    assert tuple(params["layers.0.attn.o_proj"].shape) == (H * D, 256)
    np.testing.assert_array_equal(
        params["layers.1.attn.o_proj"].numpy(),
        jparams["layer1"]["attn"]["o_proj"]["kernel"].reshape(H * D, 256))
    assert tuple(params["tok_embed"].shape) == (512, 256)
    assert tuple(params["lm_head"].shape) == (256, 512)
    assert set(params) == set(tllama.param_shapes(cfg, PrecisionConfig()))
    with pytest.raises(KeyError, match="no counterpart"):
        params_from_jax({"layer0": {"moe_mlp": {"router": np.zeros(2)}}})


def test_bf16_weights_cast_once_and_head_stays_fp32(twins):
    _, _, cfg, params = twins
    model = build_model(cfg, PrecisionConfig(compute_dtype="bfloat16"),
                        params, device="cpu")
    assert model.layers[0].attn.q_proj.dtype == torch.bfloat16
    assert model.layers[0].input_norm.scale.dtype == torch.float32
    assert model.lm_head.dtype == torch.float32
    # the head keeps its bf16-rounded values
    torch.testing.assert_close(
        model.lm_head, params["lm_head"].to(torch.bfloat16).float(),
        atol=0, rtol=0)
    out = model(torch.zeros((1, 4), dtype=torch.long))
    assert out.dtype == torch.float32


def test_seeded_init_and_preset():
    cfg = get_preset("llama2_7b")
    m = cfg.model
    assert (m.hidden_size, m.num_layers, m.num_heads, m.mlp_dim,
            m.vocab_size, m.max_seq_len) == (4096, 32, 32, 11008, 32000, 4096)
    assert cfg.precision.compute_dtype == "bfloat16"
    cfg.apply_overrides(["model.num_layers=2", "model.hidden_size=128",
                         "model.num_heads=2", "model.mlp_dim=64",
                         "model.vocab_size=300", "model.max_seq_len=64",
                         "precision.compute_dtype=float32"])
    a = tllama.init_params(cfg.model, cfg.precision, seed=3, device="cpu")
    b = tllama.init_params(cfg.model, cfg.precision, seed=3, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.all(a["final_norm.scale"] == 1.0)
    with pytest.raises(KeyError):
        cfg.apply_overrides(["model.no_such_field=1"])


@pytest.mark.parametrize("field,value", [
    ("num_experts", 8), ("quant_training", "int8"),
    ("kv_cache_dtype", "float8_e4m3fn"), ("segment_eos_id", 2),
])
def test_unported_features_are_refused(field, value):
    cfg = dataclasses.replace(ModelConfig(**SMALL), **{field: value})
    with pytest.raises(NotImplementedError, match=field):
        build_model(cfg, PrecisionConfig(), device="cpu")
