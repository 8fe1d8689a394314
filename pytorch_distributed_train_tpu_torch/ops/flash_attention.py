"""Flash-attention forward: the hand-written CUDA kernel and its plain
PyTorch version.

The counterpart of the JAX package's ``ops/flash_attention.py`` forward
(``_fwd_kernel``). Inputs are (B, S, H, D) at the public functions, as in
the JAX package; K/V may carry fewer heads (GQA, H % Hkv == 0), which the
kernel reads natively without an expanded copy.

- CUDA tensors launch ``csrc/flash_fwd.cu`` or raise: there is no fallback.
- CPU tensors take :func:`flash_attention_reference`, the plain version,
  and count no launch.

``flash_attention_fwd`` returns (O, lse); lse (B, H, S) fp32 is what the
backward of a later training slice reads. ``flash_attention_fwd.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)
DTYPES = (torch.bfloat16, torch.float32)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def supported(q, k, v, *, causal: bool, mask, window: int = 0) -> bool:
    """Shapes and types the kernel takes. Unlike the TPU kernel there is no
    block-divisibility rule: the CUDA kernel masks ragged tiles."""
    del causal, window
    if mask is not None:
        return False
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        return False
    B, Sq, H, D = q.shape
    if k.shape[0] != B or k.shape[1] != Sq or k.shape[3] != D:
        return False
    Hkv = k.shape[2]
    if D not in HEAD_DIMS or Hkv == 0 or H % Hkv != 0:
        return False
    return q.dtype in DTYPES and k.dtype == q.dtype and v.dtype == q.dtype


def _keep_mask(S: int, causal: bool, window: int, device) -> torch.Tensor | None:
    if not causal and not window:
        return None
    rows = torch.arange(S, device=device)[:, None]
    cols = torch.arange(S, device=device)[None, :]
    keep = rows >= cols if causal else torch.ones(S, S, dtype=torch.bool,
                                                  device=device)
    if window:
        keep = keep & ((rows - cols) < window)
    return keep


def flash_attention_reference(q, k, v, *, causal: bool = False,
                              window: int = 0):
    """The plain version of the kernel: the same function computed whole in
    fp32 (scores, masks with NEG_INF, softmax, P.V), O cast to the input
    dtype, lse (B, H, S) fp32; fully masked rows give O = 0 and
    lse = NEG_INF."""
    B, S, H, D = q.shape
    rep = H // k.shape[2]
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * (1.0 / math.sqrt(D))
    keep = _keep_mask(S, causal, window, q.device)
    if keep is not None:
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    o, lse = _softmax_pv(s, vf)
    return o.to(q.dtype), lse


def _softmax_pv(s, vf):
    """Masked scores s (B, H, Sq, Sk) fp32 (masked = NEG_INF) and V
    (B, Sk, H, D) fp32 -> (O (B, Sq, H, D) fp32, lse (B, H, Sq)). A row
    whose every score is masked gives O = 0 and lse = NEG_INF."""
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vf) / l_safe.permute(0, 2, 1, 3)
    return o, (m + torch.log(l_safe))[..., 0]


def _check(q, k, v, window: int, causal: bool) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention wants q (B,S,H,D) and k/v "
                         f"(B,S,Hkv,D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != D:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (self-attention, Sq == Sk)")
    Hkv = k.shape[2]
    if Hkv == 0 or H % Hkv != 0:
        raise ValueError(f"invalid GQA ratio: {H} query heads over "
                         f"{Hkv} KV heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: the kernel "
                         "takes bfloat16 or float32, the same for q, k, v")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if window and not causal:
        raise ValueError("window attention requires causal=True")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")


def flash_attention_fwd(q, k, v, *, causal: bool = False, window: int = 0):
    """(O, lse) for (B, S, H, D) q and (B, S, Hkv, D) k/v."""
    _check(q, k, v, window, causal)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal,
                                         window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, "
                         f"got {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    from pytorch_distributed_train_tpu_torch import kernels

    fn = kernels.load("flash_fwd").flash_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                          ctypes.c_int, ctypes.c_float, ctypes.c_int,
                          ctypes.c_void_p])
    B, S, H, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(*(
        s for t in (q, k, v, o) for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), B, S, H, k.shape[2], D, strides,
                 int(causal), int(window), 1.0 / math.sqrt(D),
                 _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError {err}")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def flash_attention(q, k, v, *, causal: bool = False, window: int = 0):
    """(B, S, H, D) attention output (see :func:`flash_attention_fwd`)."""
    return flash_attention_fwd(q, k, v, causal=causal, window=window)[0]
