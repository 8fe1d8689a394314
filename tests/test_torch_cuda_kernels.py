"""The CUDA kernels of the PyTorch package against their plain versions,
on the card. Every test here is marked ``cuda`` and skips without a GPU.

This file imports neither JAX nor the JAX package, so it also runs on a
machine without them; there, skip the repository's conftest (which sets up
JAX):

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

from pytorch_distributed_train_tpu_torch.config import (
    ModelConfig,
    PrecisionConfig,
)
from pytorch_distributed_train_tpu_torch.generate import init_cache
from pytorch_distributed_train_tpu_torch.ops import attention as tattn
from pytorch_distributed_train_tpu_torch.ops import flash_attention as tfa
from pytorch_distributed_train_tpu_torch.serving import (
    ContinuousBatcher,
    _prefill_step,
)

pytestmark = pytest.mark.cuda

BF16_TOL, FP32_TOL, LSE_TOL = 2e-2, 1e-4, 1e-3
# Backward against its plain version: by row norm (max over rows of
# |a - b| / max(|b|, 1e-2 * mean row norm); the floor keeps rows whose
# exact gradient is ~0, such as dq of the first causal row, from dividing
# by their own rounding noise) and, in fp32, element-wise at the JAX
# package's grad tolerance (tests/test_flash_attention.py).
BWD_ROW_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
BWD_ATOL, BWD_RTOL = 5e-4, 5e-3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(S, H, Hkv, D, dtype, seed=0, B=1):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def mk(h):
        return torch.randn((B, S, h, D), generator=g, device="cuda",
                           dtype=dtype)

    return mk(H), mk(Hkv), mk(Hkv)


@pytest.mark.parametrize("dtype,B,S,H,Hkv,D,causal,window", [
    (torch.bfloat16, 1, 128, 32, 32, 128, True, 0),
    (torch.bfloat16, 1, 1000, 32, 32, 128, True, 0),
    (torch.bfloat16, 2, 77, 8, 2, 64, True, 0),
    (torch.bfloat16, 1, 1000, 32, 8, 128, True, 0),
    (torch.bfloat16, 1, 700, 16, 16, 128, True, 256),
    (torch.bfloat16, 1, 300, 8, 8, 256, True, 0),
    (torch.bfloat16, 1, 200, 4, 4, 64, False, 0),
    (torch.float32, 1, 300, 8, 8, 128, True, 0),
    (torch.float32, 2, 65, 4, 2, 64, True, 32),
    (torch.float32, 1, 130, 4, 4, 256, False, 0),
])
def test_flash_fwd_matches_plain_version(card, dtype, B, S, H, Hkv, D,
                                         causal, window):
    q, k, v = _qkv(S, H, Hkv, D, dtype, seed=S + D, B=B)
    before = tfa.flash_attention_fwd.launches
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tfa.flash_attention_fwd.launches == before + 1
    assert o.dtype == dtype and lse.dtype == torch.float32
    ro, rlse = tfa.flash_attention_reference(q, k, v, causal=causal,
                                             window=window)
    tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
    torch.testing.assert_close(o.float(), ro.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, rlse, atol=LSE_TOL, rtol=LSE_TOL)


def _row_rel(a, b):
    a = a.float().reshape(-1, a.shape[-1])
    b = b.float().reshape(-1, b.shape[-1])
    nb = b.norm(dim=1)
    return ((a - b).norm(dim=1) / nb.clamp_min(1e-2 * nb.mean())).max().item()


@pytest.mark.parametrize("dtype,B,S,H,Hkv,D,causal,window", [
    (torch.bfloat16, 1, 128, 8, 8, 128, True, 0),
    (torch.bfloat16, 2, 1000, 8, 8, 128, True, 0),
    (torch.bfloat16, 2, 77, 8, 2, 64, True, 0),
    (torch.bfloat16, 1, 1000, 16, 4, 128, True, 0),
    (torch.bfloat16, 1, 700, 8, 8, 128, True, 256),
    (torch.bfloat16, 1, 300, 4, 4, 256, True, 0),
    (torch.bfloat16, 1, 200, 4, 2, 256, False, 0),
    (torch.bfloat16, 1, 200, 4, 4, 64, False, 0),
    (torch.float32, 1, 300, 4, 4, 128, True, 0),
    (torch.float32, 2, 65, 4, 2, 64, True, 32),
    (torch.float32, 1, 130, 4, 4, 256, False, 0),
])
def test_flash_bwd_matches_plain_version(card, dtype, B, S, H, Hkv, D,
                                         causal, window):
    q, k, v = _qkv(S, H, Hkv, D, dtype, seed=S + D + 1, B=B)
    with torch.no_grad():
        o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal,
                                         window=window)
    do = torch.randn(o.shape, device="cuda", dtype=dtype,
                     generator=torch.Generator(device="cuda").manual_seed(7))
    before = (tfa.flash_attention_bwd.launches_dq,
              tfa.flash_attention_bwd.launches_dkv)
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                  window=window)
    torch.cuda.synchronize()
    assert (tfa.flash_attention_bwd.launches_dq,
            tfa.flash_attention_bwd.launches_dkv) == (before[0] + 1,
                                                      before[1] + 1)
    ref = tfa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                            causal=causal, window=window)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == dtype and a.shape == r.shape, name
        assert torch.isfinite(a).all(), name
        assert _row_rel(a, r) <= BWD_ROW_TOL[dtype], (name, _row_rel(a, r))
        if dtype == torch.float32:
            torch.testing.assert_close(a, r, atol=BWD_ATOL, rtol=BWD_RTOL)


def test_flash_bwd_reads_strided_inputs(card):
    # q, k, v as head slices of one fused (B, S, H + 2 Hkv, D) projection:
    # the kernels read them through their strides, no copies
    B, S, H, Hkv, D = 2, 300, 8, 2, 128
    g = torch.Generator(device="cuda").manual_seed(3)
    qkv = torch.randn((B, S, H + 2 * Hkv, D), generator=g, device="cuda",
                      dtype=torch.bfloat16)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + Hkv], qkv[:, :, H + Hkv:]
    assert not q.is_contiguous()
    do = torch.randn((B, S, H, D), generator=g, device="cuda",
                     dtype=torch.bfloat16)
    with torch.no_grad():
        o, lse = tfa.flash_attention_fwd(q.contiguous(), k.contiguous(),
                                         v.contiguous(), causal=True)
    strided = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    dense = tfa.flash_attention_bwd(q.contiguous(), k.contiguous(),
                                    v.contiguous(), o, lse, do, causal=True)
    for a, b in zip(strided, dense):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    with pytest.raises(ValueError, match="aligned"):
        tfa.flash_attention_bwd(q[..., 1:65], k[..., 1:65], v[..., 1:65],
                                o[..., :64].contiguous(), lse,
                                do[..., :64].contiguous(), causal=True)


def test_flash_autograd_runs_the_kernels(card):
    q, k, v = (t.detach().requires_grad_() for t in
               _qkv(256, 4, 2, 64, torch.float32, seed=5))
    g = torch.randn_like(q)
    before = (tfa.flash_attention_fwd.launches,
              tfa.flash_attention_bwd.launches_dq,
              tfa.flash_attention_bwd.launches_dkv)
    out = tattn.dot_product_attention(q, k, v, causal=True, impl="auto")
    grads = torch.autograd.grad(out, (q, k, v), g)
    torch.cuda.synchronize()
    assert (tfa.flash_attention_fwd.launches,
            tfa.flash_attention_bwd.launches_dq,
            tfa.flash_attention_bwd.launches_dkv) == tuple(
                n + 1 for n in before)
    plain = tattn.dot_product_attention(q, k, v, causal=True, impl="xla")
    ref = torch.autograd.grad(plain, (q, k, v), g)
    for a, r in zip(grads, ref):
        torch.testing.assert_close(a, r, atol=BWD_ATOL, rtol=BWD_RTOL)


def test_flash_fwd_refuses_autograd(card):
    q, k, v = _qkv(64, 4, 4, 64, torch.bfloat16)
    q.requires_grad_()
    with pytest.raises(RuntimeError, match="no gradient"):
        tfa.flash_attention_fwd(q, k, v, causal=True)
    with torch.no_grad():
        tfa.flash_attention_fwd(q, k, v, causal=True)


def test_flash_fwd_raises_instead_of_falling_back(card):
    q, k, v = _qkv(64, 4, 4, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention_fwd(q.transpose(1, 2).contiguous().transpose(1, 2),
                                k, v, causal=True)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention_fwd(q[..., :48].contiguous(),
                                k[..., :48].contiguous(),
                                v[..., :48].contiguous(), causal=True)


def test_tiny_batcher_prefills_through_the_kernel(card):
    cfg = ModelConfig(name="llama", hidden_size=256, num_layers=2,
                      num_heads=4, num_kv_heads=2, mlp_dim=512,
                      vocab_size=512, max_seq_len=256)
    prec = PrecisionConfig(compute_dtype="bfloat16")
    b = ContinuousBatcher(cfg, prec, None, slots=2, device="cuda", seed=0)
    uids = [b.submit(list(range(1, n + 1)), 4) for n in (5, 40, 100)]
    tfa.flash_attention_fwd.launches = 0
    done = {c.uid: c for c in b.run()}
    assert sorted(done) == uids
    assert all(len(done[u].tokens) == 4 for u in uids)
    assert tfa.flash_attention_fwd.launches == 3 * cfg.num_layers
    ids = torch.arange(1, 101, device="cuda")[None]
    ids = torch.cat([ids, torch.zeros((1, 28), dtype=torch.long,
                                      device="cuda")], dim=1)
    kern = _prefill_step(b.model, init_cache(b.model, 1), ids, 100)
    plain = _prefill_step(b.model.twin(attn_impl="xla"),
                          init_cache(b.model, 1), ids, 100)
    rel = ((kern - plain).abs().max() / plain.abs().max()).item()
    assert rel < 5e-2
