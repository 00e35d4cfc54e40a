"""Flash attention forward: the CUDA kernel's wrapper.

Counterpart of ``repro.kernels.flash_attention.flash_attention`` (the
Pallas TPU kernel ``flash_attention_fwd``).  :func:`flash_attention_fwd`
launches ``csrc/flash_attention.cu`` for CUDA tensors and runs the plain
version (``ref.flash_attention_plain``) for CPU tensors; it never falls
back from one to the other.
"""
from __future__ import annotations

import torch

from .. import _lib
from .ref import BLOCK_K, BLOCK_Q, flash_attention_plain

HEAD_DIMS = (16, 32, 64, 128, 256)     # the kernel's instantiations
DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        scale: float, seq_k: int | None = None
                        ) -> torch.Tensor:
    """q (B, Hq, Sq, D); k/v (B, Hkv, Sk, D), already padded so that
    Sq % BLOCK_Q == Sk % BLOCK_K == 0; keys at or past ``seq_k`` (default
    Sk) are masked.  Returns (B, Hq, Sq, D) in q's type."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    seq_k = sk if seq_k is None else seq_k
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention takes float32 or bfloat16 q/k/v of "
                        f"one type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != d
            or hq % hkv or sq % BLOCK_Q or sk % BLOCK_K or seq_k > sk):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} seq_k {seq_k}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, seq_k=seq_k)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"q/k/v must share one CUDA or CPU device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in {HEAD_DIMS}, got {d}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    _lib.launch("flash_attention", q.device, q, k, v, out, b, hq, hkv, sq,
                sk, seq_k, d, int(causal), window or 0,
                int(q.dtype == torch.bfloat16), float(scale))
    return out
