"""The PyTorch package's flash-attention backward against the JAX package.

Same numpy inputs through three routes, on the CPU in fp32:

- JAX ``flash_attention(..., interpret=True)`` under ``jax.grad`` (the
  Pallas forward and the ``_bwd_dq_kernel``/``_bwd_dkv_kernel`` backward in
  interpret mode, S 256, blocks 128, as ``tests/test_flash_attention.py``
  runs them);
- the port's ``flash_attention_bwd_reference`` (the kernels' plain
  version) from the forward's O and lse;
- torch autograd through the port's ``_Flash`` (on CPU tensors its forward
  and backward take the plain versions).

Tolerance: the JAX grad test's own, atol 5e-4 / rtol 5e-3. The CUDA kernels
are held against the plain version on the card by
``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_train_tpu.ops import flash_attention as jfa
from pytorch_distributed_train_tpu_torch.ops import attention as tattn
from pytorch_distributed_train_tpu_torch.ops import flash_attention as tfa

ATOL, RTOL = 5e-4, 5e-3


@pytest.fixture(autouse=True)
def _no_attention_env(monkeypatch):
    # the JAX package's kill switch would turn its pallas calls into XLA
    monkeypatch.delenv("PDTT_ATTENTION_IMPL", raising=False)


def _inputs(B, S, H, Hkv, D, seed):
    rng = np.random.default_rng(seed)

    def mk(h):
        return (rng.standard_normal((B, S, h, D)) * 0.5).astype(np.float32)

    return mk(H), mk(Hkv), mk(Hkv), mk(H)  # q, k, v, upstream gradient


def _jax_grads(q, k, v, g, causal, window):
    def loss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal=causal, window=window,
                                block_q=128, block_k=128, interpret=True)
        return jnp.sum(o * jnp.asarray(g))

    return [np.asarray(x) for x in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


@pytest.mark.parametrize("causal,window,H,Hkv,D", [
    (False, 0, 2, 2, 64),
    (True, 0, 2, 2, 64),
    (True, 0, 4, 2, 64),
    (False, 0, 4, 1, 128),
    (True, 64, 4, 2, 64),
    (True, 100, 2, 2, 128),
])
def test_three_routes_agree(causal, window, H, Hkv, D):
    B, S = 1, 256
    q, k, v, g = _inputs(B, S, H, Hkv, D, seed=H + Hkv + D + window)
    ref = _jax_grads(q, k, v, g, causal, window)

    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    o, lse = tfa.flash_attention_fwd(tq, tk, tv, causal=causal, window=window)
    plain = tfa.flash_attention_bwd_reference(tq, tk, tv, o, lse, tg,
                                              causal=causal, window=window)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = tfa.flash_attention(*leaves, causal=causal, window=window)
    autograd = torch.autograd.grad(out, leaves, tg)
    for name, r, a, b in zip(("dq", "dk", "dv"), ref, plain, autograd):
        np.testing.assert_allclose(a.numpy(), r, atol=ATOL, rtol=RTOL,
                                   err_msg=f"plain {name}")
        np.testing.assert_allclose(b.numpy(), r, atol=ATOL, rtol=RTOL,
                                   err_msg=f"autograd {name}")


def test_row_with_neg_inf_lse_matches_jax_bwd():
    """A row whose lse is NEG_INF (the fully-masked-row convention): both
    packages take P with lse 0 there (``:335`` of the JAX kernel), so a row
    whose keys are all masked contributes nothing, and no NaN appears."""
    B, S, H, Hkv, D = 1, 256, 2, 1, 64
    q, k, v, g = _inputs(B, S, H, Hkv, D, seed=21)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    o, lse = tfa.flash_attention_fwd(tq, tk, tv, causal=False)
    lse[:, :, 7] = tfa.NEG_INF
    got = tfa.flash_attention_bwd(tq, tk, tv, o, lse, tg, causal=False)

    def to3(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(-1, S, D)

    dq3, dk3, dv3 = jfa._bwd(
        to3(q), to3(k), to3(v), to3(o.numpy()),
        jnp.asarray(lse.numpy()).reshape(B * H, S, 1), to3(g),
        causal=False, scale=1.0 / D ** 0.5, block_q=128, block_k=128,
        window=0, interpret=True)
    for name, a, r, h in zip(("dq", "dk", "dv"), got, (dq3, dk3, dv3),
                             (H, Hkv, Hkv)):
        r = np.asarray(r).reshape(B, h, S, D).transpose(0, 2, 1, 3)
        assert np.isfinite(a.numpy()).all(), name
        np.testing.assert_allclose(a.numpy(), r, atol=ATOL, rtol=RTOL,
                                   err_msg=name)


def test_dot_product_attention_routes_grads_through_flash():
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(1, 64, 4, 2, 64, 3))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (tfa.flash_attention_bwd.launches_dq,
              tfa.flash_attention_bwd.launches_dkv)
    out = tattn.dot_product_attention(*leaves, causal=True, impl="pallas")
    assert out.grad_fn is not None and "_Flash" in type(out.grad_fn).__name__
    kern = torch.autograd.grad(out, leaves, g)
    # CPU tensors take the plain versions and count no launch
    assert (tfa.flash_attention_bwd.launches_dq,
            tfa.flash_attention_bwd.launches_dkv) == before
    plain = torch.autograd.grad(
        tattn.dot_product_attention(*leaves, causal=True, impl="xla"),
        leaves, g)
    for a, b in zip(kern, plain):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL)
    with torch.no_grad():
        assert tattn.dot_product_attention(
            q, k, v, causal=True, impl="pallas").grad_fn is None


def test_bwd_checks_its_arguments():
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(1, 32, 2, 2, 64, 4))
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    with pytest.raises(ValueError, match="do not match"):
        tfa.flash_attention_bwd(q, k, v, o, lse[:, :1], g, causal=True)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.flash_attention_bwd(*(t.to("meta") for t in (q, k, v, o, lse, g)),
                                causal=True)
