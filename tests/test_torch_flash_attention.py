"""The PyTorch package's flash-attention forward against the JAX package.

On the CPU the port's wrapper runs its plain version (the CUDA kernel has
no CPU mode); it is held against the JAX Pallas kernel in interpret mode
and against the JAX ``_xla_attention``, on the same numpy inputs, at the
JAX flash tests' forward tolerance (atol 2e-5). The kernel itself is held
against the plain version on the card by ``tests/test_torch_cuda_kernels.py``
and by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_train_tpu.ops import flash_attention as jfa
from pytorch_distributed_train_tpu.ops.attention import (
    _xla_attention as jax_xla_attention,
)
from pytorch_distributed_train_tpu_torch.ops import attention as tattn
from pytorch_distributed_train_tpu_torch.ops import flash_attention as tfa

ATOL = 2e-5


@pytest.fixture(autouse=True)
def _no_attention_env(monkeypatch):
    # the JAX package's kill switch would turn its pallas calls into XLA
    monkeypatch.delenv("PDTT_ATTENTION_IMPL", raising=False)


def _qkv(B=1, S=256, H=4, Hkv=2, D=64, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, S, H, D)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((B, S, Hkv, D)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((B, S, Hkv, D)) * 0.5).astype(np.float32)
    return q, k, v


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("causal,window,Hkv", [
    (False, 0, 4), (True, 0, 4), (False, 0, 2), (True, 0, 2),
    (True, 64, 2), (True, 100, 1),
])
def test_plain_version_matches_jax_kernel_and_xla(causal, window, Hkv):
    q, k, v = _qkv(Hkv=Hkv, seed=Hkv + window)
    ref_kernel = np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, block_q=128, block_k=128, interpret=True))
    ref_xla = np.asarray(jax_xla_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        mask=None, softmax_dtype=jnp.float32, window=window))
    out = tfa.flash_attention(*_t(q, k, v), causal=causal,
                              window=window).numpy()
    np.testing.assert_allclose(out, ref_kernel, atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(out, ref_xla, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("causal,window", [(False, 0), (True, 0), (True, 96)])
def test_lse_matches_jax_fwd(causal, window):
    B, S, H, Hkv, D = 1, 256, 4, 2, 64
    q, k, v = _qkv(B, S, H, Hkv, D, seed=11)

    def to3(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(-1, S, D)

    o3, lse = jfa._fwd(to3(q), to3(k), to3(v), causal=causal,
                       scale=1.0 / D ** 0.5, block_q=128, block_k=128,
                       window=window, interpret=True)
    o, tlse = tfa.flash_attention_fwd(*_t(q, k, v), causal=causal,
                                      window=window)
    np.testing.assert_allclose(tlse.numpy(),
                               np.asarray(lse).reshape(B, H, S),
                               atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(
        o.numpy(),
        np.asarray(o3).reshape(B, H, S, D).transpose(0, 2, 1, 3),
        atol=ATOL, rtol=ATOL)


def test_ragged_length_matches_xla():
    # the CUDA kernel masks ragged tiles, so any S is supported
    q, k, v = _qkv(S=100, seed=3)
    tq, tk, tv = _t(q, k, v)
    assert tfa.supported(tq, tk, tv, causal=True, mask=None)
    ref = np.asarray(jax_xla_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        mask=None, softmax_dtype=jnp.float32))
    out = tfa.flash_attention(tq, tk, tv, causal=True).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=ATOL)


def test_fully_masked_rows_follow_flash_convention():
    # Self-attention under a causal mask never empties a row, so the
    # convention is held on the plain version's softmax step directly: a
    # row whose every score is NEG_INF gives O = 0 and lse = NEG_INF
    # (the JAX kernel's _finalize), the other rows a normal softmax.
    rng = np.random.default_rng(5)
    s = torch.from_numpy(rng.standard_normal((1, 1, 3, 4)).astype(np.float32))
    s[0, 0, 1] = tfa.NEG_INF
    s[0, 0, 2, 2:] = tfa.NEG_INF
    vf = torch.from_numpy(rng.standard_normal((1, 4, 1, 8)).astype(np.float32))
    o, lse = tfa._softmax_pv(s, vf)
    assert torch.all(o[0, 1] == 0.0)
    assert lse[0, 0, 1].item() == pytest.approx(tfa.NEG_INF)
    for row in (0, 2):
        sr = s[0, 0, row]
        p = torch.softmax(sr, -1)
        torch.testing.assert_close(o[0, row, 0], p @ vf[0, :, 0],
                                   atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(lse[0, 0, row], torch.logsumexp(sr, -1),
                                   atol=1e-6, rtol=1e-6)


def test_supported_rules():
    q, k, v = _t(*_qkv(S=64))
    assert tfa.supported(q, k, v, causal=True, mask=None)
    assert not tfa.supported(q, k, v, causal=True, mask=torch.ones(1))
    q96, k96, v96 = _t(*_qkv(S=64, D=96))
    assert not tfa.supported(q96, k96, v96, causal=True, mask=None)
    k3, v3 = _t(*_qkv(S=64, Hkv=3))[1:]
    assert not tfa.supported(q, k3, v3, causal=True, mask=None)
    assert not tfa.supported(q.half(), k.half(), v.half(), causal=True,
                             mask=None)
    with pytest.raises(ValueError, match="GQA"):
        tfa.flash_attention(q, k3, v3, causal=True)
    with pytest.raises(ValueError, match="causal"):
        tfa.flash_attention(q, k, v, causal=False, window=8)


def test_cpu_tensors_take_plain_version_and_count_no_launch():
    q, k, v = _t(*_qkv(S=64))
    before = tfa.flash_attention_fwd.launches
    out = tattn.dot_product_attention(q, k, v, causal=True, impl="pallas")
    ref, _ = tfa.flash_attention_reference(q, k, v, causal=True)
    assert tfa.flash_attention_fwd.launches == before
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    with pytest.raises(ValueError, match="unsupported"):
        tattn.dot_product_attention(q, k, v, causal=True, impl="pallas",
                                    mask=torch.ones(1, 1, 64, 64,
                                                    dtype=torch.bool))


def test_xla_path_with_decode_mask_matches_jax():
    rng = np.random.default_rng(9)
    B, L, H, Hkv, D = 2, 32, 4, 2, 64
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k = rng.standard_normal((B, L, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, L, Hkv, D)).astype(np.float32)
    pos = np.array([5, 20])
    mask = (np.arange(L)[None, None, :] <= pos[:, None, None])[:, None]
    ref = np.asarray(jax_xla_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
        mask=jnp.asarray(mask), softmax_dtype=jnp.float32))
    out = tattn.dot_product_attention(
        *_t(q, k, v), mask=torch.from_numpy(mask), impl="auto").numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=ATOL)
