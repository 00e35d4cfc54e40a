"""Wrapper: pads S to the kernel's chunk with a = 1, b = 0 (steps that
leave the state as it is) and slices back (counterpart of
``repro.kernels.rglru_scan.ops``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .rglru_scan import CHUNK, rglru_scan_fwd


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, S, W) -> h trajectory (B, S, W)."""
    s = a.shape[1]
    pad = (-s) % CHUNK
    if pad:
        a = F.pad(a, (0, 0, 0, pad), value=1.0)
        b = F.pad(b, (0, 0, 0, pad))
    return rglru_scan_fwd(a, b)[:, :s]
