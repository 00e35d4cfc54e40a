"""Model-layout wrapper: padding and the (B,S,H,D) <-> (B,H,S,D) layout
change around :func:`flash_attention_fwd` (counterpart of
``repro.kernels.flash_attention.ops``).

A head dim under the kernel's smallest instantiation (command-r-plus's
smoke config has D = 8) is zero-padded up to the smallest one in
``HEAD_DIMS`` (16) rather than given an instantiation of its own: a
wgmma's depth is 16 bf16 values, so a D = 8 tile is no shape the tensor
cores take.  The padding is exact: zero columns of q and k add nothing to
q.k, zero columns of v give zero output columns, and those are sliced
off; ``scale`` defaults to 1/sqrt(D) of the unpadded D (the model passes
1.0).  Every device takes the same padded path, so the CPU tests reach
it."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .flash_attention import HEAD_DIMS, flash_attention_fwd
from .ref import BLOCK_K, BLOCK_Q


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """Model layout: q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D) -> (B, Sq, Hq, D).
    ``scale`` defaults to 1/sqrt(D).  Pads the sequences to block
    multiples (padded keys are masked inside the kernel; padded query rows
    are sliced off) and D under ``HEAD_DIMS[0]`` with zero columns."""
    sq, sk, d = q.shape[1], k.shape[1], q.shape[3]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    pq, pk = (-sq) % BLOCK_Q, (-sk) % BLOCK_K
    pd = max(HEAD_DIMS[0] - d, 0)
    qt = F.pad(q, (0, pd, 0, 0, 0, pq)).transpose(1, 2).contiguous()
    kt = F.pad(k, (0, pd, 0, 0, 0, pk)).transpose(1, 2).contiguous()
    vt = F.pad(v, (0, pd, 0, 0, 0, pk)).transpose(1, 2).contiguous()
    o = flash_attention_fwd(qt, kt, vt, causal=causal, window=window,
                            scale=scale, seq_k=sk)
    return o.transpose(1, 2)[:, :sq, :, :d]
