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
from pytorch_distributed_train_tpu_torch.ops import flash_attention as tfa
from pytorch_distributed_train_tpu_torch.serving import (
    ContinuousBatcher,
    _prefill_step,
)

pytestmark = pytest.mark.cuda

BF16_TOL, FP32_TOL, LSE_TOL = 2e-2, 1e-4, 1e-3


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
