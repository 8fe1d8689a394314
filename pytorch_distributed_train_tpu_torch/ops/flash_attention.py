"""Flash attention: the hand-written CUDA kernels and their plain PyTorch
versions.

The counterpart of the JAX package's ``ops/flash_attention.py``: the
forward (``_fwd_kernel``) and the backward pair (``_bwd_dq_kernel``,
``_bwd_dkv_kernel``). Inputs are (B, S, H, D) at the public functions, as in
the JAX package; K/V may carry fewer heads (GQA, H % Hkv == 0), which the
kernels read natively without an expanded copy.

- CUDA tensors launch ``csrc/flash_fwd.cu`` / ``csrc/flash_bwd.cu`` or
  raise: there is no fallback.
- CPU tensors take the plain versions (:func:`flash_attention_reference`,
  :func:`flash_attention_bwd_reference`) and count no launch.

``flash_attention_fwd`` returns (O, lse) and has no gradient: on CUDA it
refuses to run under autograd. The only differentiable route to the
kernels is :func:`flash_attention` (``_Flash``), whose backward is
``flash_attention_bwd``. Launch counters: ``flash_attention_fwd.launches``,
``flash_attention_bwd.launches_dq`` and ``flash_attention_bwd.launches_dkv``.
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


def _cuda_or_raise(t) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, "
                         f"got {t.device}")


def _rows_aligned(name: str, t) -> None:
    """The kernels read rows of D elements with 16-byte loads through the
    tensor's (batch, seq, head) strides: D must be contiguous and every
    row must start on a 16-byte boundary."""
    step = 16 // t.element_size()
    if (t.stride(-1) != 1 or t.data_ptr() % 16
            or any(s % step for s in t.stride()[:3])):
        raise ValueError(f"{name} must have a contiguous head dim and "
                         f"16-byte aligned rows (strides {t.stride()})")


def _fn(lib: str, name: str, n_ptr: int, n_int: int):
    """The C entry ``name`` of ``csrc/<lib>.cu``, its ctypes signature set:
    n_ptr pointers, n_int ints, the strides, causal, window, scale, dtype,
    stream."""
    from pytorch_distributed_train_tpu_torch import kernels

    fn = getattr(kernels.load(lib), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                          ctypes.c_int, ctypes.c_float, ctypes.c_int,
                          ctypes.c_void_p])
    return fn


def _strides(*ts):
    vals = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def flash_attention_fwd(q, k, v, *, causal: bool = False, window: int = 0):
    """(O, lse) for (B, S, H, D) q and (B, S, Hkv, D) k/v. No gradient: on
    CUDA it raises under autograd (use :func:`flash_attention`)."""
    _check(q, k, v, window, causal)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal,
                                         window=window)
    _cuda_or_raise(q)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention_fwd writes its output through a CUDA kernel and "
            "has no gradient; call flash_attention (the autograd route) or "
            "run it under torch.no_grad()")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    fn = _fn("flash_fwd", "flash_fwd", 5, 5)
    B, S, H, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), B, S, H, k.shape[2], D, _strides(q, k, v, o),
                 int(causal), int(window), 1.0 / math.sqrt(D),
                 _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError {err}")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def _delta(o, do):
    """delta = rowsum(dO * O) in fp32, (B, H, S): the preprocess the JAX
    package also computes outside its kernels."""
    return (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()


def flash_attention_bwd_reference(q, k, v, o, lse, do, *, causal: bool = False,
                                  window: int = 0):
    """The plain version of the backward kernels: the flash-2 formulas
    computed whole in fp32 from the forward's O and lse (P = exp(S - lse),
    0 where masked and on rows with lse = NEG_INF; dS = P (dP - delta)).
    Returns (dq, dk, dv) in the input dtype; dk/dv sum over the GQA group."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    rep = H // Hkv
    scale = 1.0 / math.sqrt(D)
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    lse_safe = torch.where(lse <= NEG_INF / 2, torch.zeros_like(lse), lse)
    p = torch.exp(s - lse_safe[..., None])
    keep = _keep_mask(S, causal, window, q.device)
    if keep is not None:
        p = torch.where(keep, p, torch.zeros_like(p))
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - _delta(o, do)[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    if rep > 1:
        dk = dk.reshape(B, S, Hkv, rep, D).sum(3)
        dv = dv.reshape(B, S, Hkv, rep, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = False,
                        window: int = 0):
    """(dq, dk, dv) of the attention (B, S, H, D) -> O, from the forward's
    O and lse (B, H, S) and the output gradient dO. CUDA tensors launch the
    dQ and the dK/dV kernels of ``csrc/flash_bwd.cu``."""
    _check(q, k, v, window, causal)
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (
            q.shape[0], q.shape[2], q.shape[1]):
        raise ValueError(f"o {tuple(o.shape)}, do {tuple(do.shape)} and lse "
                         f"{tuple(lse.shape)} do not match q {tuple(q.shape)}")
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, lse, do,
                                             causal=causal, window=window)
    _cuda_or_raise(q)
    if do.dtype != q.dtype or lse.dtype != torch.float32:
        raise ValueError(f"do must be {q.dtype} and lse float32, got "
                         f"{do.dtype} and {lse.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        _rows_aligned(name, t)
    lse, delta = lse.contiguous(), _delta(o, do)
    dq = _bwd_dq(q, k, v, do, lse, delta, causal, window)
    dk, dv = _bwd_dkv(q, k, v, do, lse, delta, causal, window)
    return dq, dk, dv


def _bwd_launch(entry: str, q, k, v, do, lse, delta, outs, causal, window):
    n_ptr = 6 + len(outs)
    fn = _fn("flash_bwd", entry, n_ptr, 5)
    B, S, H, D = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(),
                 *(t.data_ptr() for t in outs), B, S, H, k.shape[2], D,
                 _strides(q, k, v, do, *outs), int(causal), int(window),
                 1.0 / math.sqrt(D), _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")


def _bwd_dq(q, k, v, do, lse, delta, causal, window):
    """dQ through the dQ kernel (K2); lse and delta (B, H, S) fp32."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _bwd_launch("flash_bwd_dq", q, k, v, do, lse, delta, (dq,), causal,
                window)
    flash_attention_bwd.launches_dq += 1
    return dq


def _bwd_dkv(q, k, v, do, lse, delta, causal, window):
    """(dK, dV) through the dK/dV kernel (K3)."""
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _bwd_launch("flash_bwd_dkv", q, k, v, do, lse, delta, (dk, dv), causal,
                window)
    flash_attention_bwd.launches_dkv += 1
    return dk, dv


flash_attention_bwd.launches_dq = 0
flash_attention_bwd.launches_dkv = 0


class _Flash(torch.autograd.Function):
    """Flash attention under autograd: the forward kernel saves O and lse,
    the backward runs the dQ and dK/dV kernels (the JAX package's
    ``_flash`` custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        with torch.no_grad():
            o, lse = flash_attention_fwd(q, k, v, causal=causal,
                                         window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = False, window: int = 0):
    """(B, S, H, D) attention output; differentiable in q, k, v through
    ``_Flash`` whenever autograd records."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Flash.apply(q, k, v, causal, window)
    return flash_attention_fwd(q, k, v, causal=causal, window=window)[0]
