"""The plain PyTorch version of the RG-LRU scan kernel: the sequential
fp32 recurrence ``h_t = a_t * h_{t-1} + b_t`` from a zero state
(counterpart of ``repro.kernels.rglru_scan.ref.rglru_ref``, which reaches
the same values with an associative scan)."""
from __future__ import annotations

import torch


def rglru_scan_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, S, W) -> h trajectory (B, S, W) in a's type."""
    af, bf = a.float(), b.float()
    h = torch.zeros_like(af[:, 0])
    y = torch.empty_like(af)
    for t in range(a.shape[1]):
        h = af[:, t] * h + bf[:, t]
        y[:, t] = h
    return y.to(a.dtype)
