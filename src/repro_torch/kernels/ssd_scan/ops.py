"""Wrapper: pads S to the kernel's chunk with trailing zeros (the scan is
causal, so they change no earlier output) and slices back (counterpart
of ``repro.kernels.ssd_scan.ops``, without its transpose to (b * H, S,
hd) and its broadcast of B and C over heads)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .ssd_scan import CHUNK, ssd_scan_fwd


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """x (b, S, H, hd); dt (b, S, H) fp32; B/C (b, S, n), ngroups = 1;
    A (H,) fp32.  Returns y (b, S, H, hd) in x's type."""
    s = x.shape[1]
    pad = (-s) % CHUNK
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    return ssd_scan_fwd(x, dt, B, C, A)[:, :s]
