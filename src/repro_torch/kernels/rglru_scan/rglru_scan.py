"""RG-LRU scan: the CUDA kernel's wrapper.

Counterpart of ``repro.kernels.rglru_scan.rglru_scan`` (the Pallas TPU
kernel ``rglru_scan_fwd``).  :func:`rglru_scan_fwd` launches
``csrc/rglru_scan.cu`` for CUDA tensors and runs the plain version
(``ref.rglru_scan_plain``) for CPU tensors; it never falls back from one
to the other.
"""
from __future__ import annotations

import torch

from .. import _lib
from .ref import rglru_scan_plain

CHUNK = 16          # csrc/rglru_scan.cu kUnroll: S must be a multiple
DTYPES = (torch.float32, torch.bfloat16)


def rglru_scan_fwd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, S, W) with S % CHUNK == 0 -> h trajectory (B, S, W)."""
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise TypeError(f"the RG-LRU scan takes float32 or bfloat16 a/b of "
                        f"one type, got {a.dtype}, {b.dtype}")
    if a.dim() != 3 or a.shape != b.shape or a.shape[1] % CHUNK:
        raise ValueError(f"a and b must be one (B, S, W) shape with "
                         f"S % {CHUNK} == 0, got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if a.device.type == "cpu":
        return rglru_scan_plain(a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"a/b must share one CUDA or CPU device, got "
                         f"{a.device}, {b.device}")
    a, b = a.contiguous(), b.contiguous()
    y = torch.empty_like(a)
    bsz, s, w = a.shape
    if a.numel():
        _lib.launch("rglru_scan", a.device, a, b, y, bsz, s, w,
                    int(a.dtype == torch.bfloat16))
    return y
