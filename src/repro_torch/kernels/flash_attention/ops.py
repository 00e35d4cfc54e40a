"""Model-layout wrapper: padding and the (B,S,H,D) <-> (B,H,S,D) layout
change around :func:`flash_attention_fwd` (counterpart of
``repro.kernels.flash_attention.ops``)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .flash_attention import flash_attention_fwd
from .ref import BLOCK_K, BLOCK_Q


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """Model layout: q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D) -> (B, Sq, Hq, D).
    ``scale`` defaults to 1/sqrt(D).  Pads the sequences to block
    multiples (padded keys are masked inside the kernel; padded query rows
    are sliced off)."""
    sq, sk, d = q.shape[1], k.shape[1], q.shape[3]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    pq, pk = (-sq) % BLOCK_Q, (-sk) % BLOCK_K
    qt = F.pad(q, (0, 0, 0, 0, 0, pq)).transpose(1, 2).contiguous()
    kt = F.pad(k, (0, 0, 0, 0, 0, pk)).transpose(1, 2).contiguous()
    vt = F.pad(v, (0, 0, 0, 0, 0, pk)).transpose(1, 2).contiguous()
    o = flash_attention_fwd(qt, kt, vt, causal=causal, window=window,
                            scale=scale, seq_k=sk)
    return o.transpose(1, 2)[:, :sq]
