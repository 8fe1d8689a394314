"""The PyTorch package's sampling, generate() and continuous batcher
against the JAX package, on the CPU in fp32 with the same weights
(``interop.params_from_jax``).

Greedy completions must be token-identical: the batcher to the JAX
batcher and to the port's own lockstep generate() (the precedent is
``tests/test_serving.py``'s batcher-vs-generate anchor).
"""

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
    build_decode_model as j_build_decode_model,
)
from pytorch_distributed_train_tpu.generate import filter_logits as j_filter
from pytorch_distributed_train_tpu.generate import generate as j_generate
from pytorch_distributed_train_tpu.models.registry import (
    build_model as j_build_model,
)
from pytorch_distributed_train_tpu.serving import (
    ContinuousBatcher as JBatcher,
)
from pytorch_distributed_train_tpu_torch.config import (
    ModelConfig,
    PrecisionConfig,
)
from pytorch_distributed_train_tpu_torch.generate import (
    build_decode_model,
    filter_logits,
    generate,
)
from pytorch_distributed_train_tpu_torch.interop import params_from_jax
from pytorch_distributed_train_tpu_torch.serving import (
    ContinuousBatcher,
    trim_at_eos,
)

SMALL = dict(name="llama", hidden_size=256, num_layers=2, num_heads=4,
             num_kv_heads=2, mlp_dim=512, vocab_size=512, max_seq_len=256)


@pytest.fixture(scope="module")
def twins():
    jcfg = JModelConfig(**SMALL)
    jparams = j_build_model(jcfg, JPrecisionConfig()).init(
        {"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 4), jnp.int32),
        train=False)["params"]
    jparams = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, ModelConfig(**SMALL), params_from_jax(jparams)


def _prompt(n, seed):
    return [int(t) for t in np.random.default_rng(seed).integers(
        0, SMALL["vocab_size"], n)]


@pytest.mark.parametrize("temperature,top_k,top_p,min_p", [
    (1.0, 0, 0.0, 0.0), (0.7, 5, 0.0, 0.0), (1.0, 0, 0.9, 0.0),
    (1.3, 0, 0.0, 0.1), (0.8, 20, 0.5, 0.05),
])
def test_filter_logits_matches_jax(temperature, top_k, top_p, min_p):
    logits = np.random.default_rng(0).standard_normal((3, 64)).astype(
        np.float32) * 3
    ref = np.asarray(j_filter(jnp.asarray(logits), temperature, top_k,
                              top_p, min_p))
    out = filter_logits(torch.from_numpy(logits), temperature, top_k, top_p,
                        min_p).numpy()
    np.testing.assert_array_equal(np.isfinite(out), np.isfinite(ref))
    np.testing.assert_allclose(out[np.isfinite(out)], ref[np.isfinite(ref)],
                               rtol=1e-6)


def test_filter_logits_per_row_tensors_match_jax():
    logits = np.random.default_rng(1).standard_normal((4, 32)).astype(
        np.float32) * 2
    temp = np.array([[0.5], [1.0], [2.0], [1.0]], np.float32)
    top_p = np.array([[0.3], [0.0], [0.95], [1.0]], np.float32)
    min_p = np.array([[0.0], [0.2], [0.0], [0.5]], np.float32)
    ref = np.asarray(j_filter(jnp.asarray(logits), jnp.asarray(temp), 3,
                              jnp.asarray(top_p), jnp.asarray(min_p)))
    out = filter_logits(torch.from_numpy(logits), torch.from_numpy(temp), 3,
                        torch.from_numpy(top_p),
                        torch.from_numpy(min_p)).numpy()
    np.testing.assert_array_equal(np.isfinite(out), np.isfinite(ref))


def test_greedy_generate_token_identical_to_jax(twins):
    jcfg, jparams, cfg, params = twins
    prompts = np.asarray([_prompt(7, 1), _prompt(7, 2)], np.int32)
    ref = np.asarray(j_generate(j_build_decode_model(jcfg,
                                                     JPrecisionConfig()),
                                jparams, jnp.asarray(prompts), 10))
    model = build_decode_model(cfg, PrecisionConfig(), params, device="cpu")
    out = generate(model, prompts, 10)
    assert out.tolist() == ref.tolist()


def test_eos_freezes_rows(twins):
    _, _, cfg, params = twins
    model = build_decode_model(cfg, PrecisionConfig(), params, device="cpu")
    prompt = [_prompt(5, 3)]
    free = generate(model, prompt, 8)[0, 5:].tolist()
    eos = free[2]
    out = generate(model, prompt, 8, eos_id=eos)[0, 5:].tolist()
    first = free.index(eos)
    assert out[: first + 1] == free[: first + 1]
    assert out[first:] == [eos] * (8 - first)
    assert trim_at_eos(out, eos) == free[:first]


def test_sampled_generate_is_reproducible(twins):
    _, _, cfg, params = twins
    model = build_decode_model(cfg, PrecisionConfig(), params, device="cpu")
    runs = [generate(model, [_prompt(5, 4)], 6, temperature=0.8, top_k=20,
                     generator=torch.Generator().manual_seed(7)).tolist()
            for _ in range(2)]
    assert runs[0] == runs[1]


def test_batcher_token_identical_to_jax_batcher_and_generate(twins):
    jcfg, jparams, cfg, params = twins
    prompts = [_prompt(n, 10 + n) for n in (3, 20, 9)]
    budgets = [6, 4, 8]

    jb = JBatcher(jcfg, JPrecisionConfig(), jparams, slots=2)
    juids = [jb.submit(p, n) for p, n in zip(prompts, budgets)]
    jdone = {c.uid: c for c in jb.run()}

    b = ContinuousBatcher(cfg, PrecisionConfig(), params, slots=2,
                          device="cpu")
    uids = [b.submit(p, n) for p, n in zip(prompts, budgets)]
    done = {c.uid: c for c in b.run()}
    assert sorted(done) == sorted(uids)
    assert b.stats["prefills"] == 3

    model = build_decode_model(cfg, PrecisionConfig(), params, device="cpu")
    for uid, juid, p, n in zip(uids, juids, prompts, budgets):
        lockstep = generate(model, [p], n)[0, len(p):].tolist()
        assert done[uid].tokens == jdone[juid].tokens
        assert done[uid].tokens == lockstep
        assert done[uid].finish_reason == "length"


def test_batcher_seeded_sampling_independent_of_batch(twins):
    _, _, cfg, params = twins
    p = _prompt(6, 5)

    def run(extra):
        b = ContinuousBatcher(cfg, PrecisionConfig(), params, slots=2,
                              device="cpu", top_k=30)
        if extra:
            b.submit(_prompt(11, 6), 5, temperature=1.0)
        uid = b.submit(p, 5, temperature=0.9, seed=123)
        return {c.uid: c for c in b.run()}[uid].tokens

    assert run(False) == run(True)


@pytest.mark.parametrize("kwargs", [
    dict(keep=True), dict(session=0), dict(prefix=0),
    dict(repetition_penalty=1.2), dict(logit_bias={1: 5.0}),
])
def test_unported_serving_features_are_refused(twins, kwargs):
    _, _, cfg, params = twins
    b = ContinuousBatcher(cfg, PrecisionConfig(), params, slots=1,
                          device="cpu")
    with pytest.raises(NotImplementedError):
        b.submit([1, 2], 2, **kwargs)
    with pytest.raises(NotImplementedError):
        b.preload([1, 2])
    with pytest.raises(NotImplementedError):
        ContinuousBatcher(cfg, PrecisionConfig(), params, device="cpu",
                          spec_k=2)
    with pytest.raises(ValueError, match="max_seq_len"):
        b.submit([1] * 250, 10)
