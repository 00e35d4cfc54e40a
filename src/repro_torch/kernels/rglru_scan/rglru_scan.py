"""RG-LRU scan: the CUDA kernels' wrapper.

Counterpart of ``repro.kernels.rglru_scan.rglru_scan`` (the Pallas TPU
kernel ``rglru_scan_fwd``).  :func:`rglru_scan_fwd` launches
``csrc/rglru_scan.cu`` for CUDA tensors and runs the plain version
(``ref.rglru_scan_plain``) for CPU tensors; it never falls back from one
to the other.  Both kernels take any S (steps past S are never run or
stored), so nothing is padded.

Which kernel a CUDA call gets is :func:`plan`'s rule, decided from dtype,
width and alignment before the launch:

- rows of W elements a multiple of 16 bytes and a and b 16-byte aligned
  (what a TMA tensor map can describe): ``rglru_scan_tma_kernel``, a ring
  of TMA tiles of ``TMA_TILE[dtype]`` = (C channels, D steps, K stages);
- anything else: ``rglru_scan_kernel``, one thread per channel loading
  through registers.

Either way the call is one ``rglru_scan`` launch.
"""
from __future__ import annotations

import torch

from .. import _lib
from .ref import rglru_scan_plain

DTYPES = (torch.float32, torch.bfloat16)
KERNEL_IDS = {"ldg": 0, "tma": 1}     # the C entry point's `kernel`
# (C, D, K) of the TMA kernel per dtype: the source's `Tile<T>`, chosen
# by a sweep on the H100 (PERF.md section 6).
TMA_TILE = {torch.float32: (32, 16, 4), torch.bfloat16: (32, 64, 4)}


def plan(dtype: torch.dtype, width: int, addresses) -> str:
    """The kernel (a key of ``KERNEL_IDS``) for a CUDA call on contiguous
    a and b whose data pointers are ``addresses``: the rule in the
    module's docstring."""
    row_bytes = width * (2 if dtype == torch.bfloat16 else 4)
    if row_bytes % 16 == 0 and all(p % 16 == 0 for p in addresses):
        return "tma"
    return "ldg"


def rglru_scan_fwd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, S, W) -> h trajectory (B, S, W) in a's type."""
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise TypeError(f"the RG-LRU scan takes float32 or bfloat16 a/b of "
                        f"one type, got {a.dtype}, {b.dtype}")
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"a and b must be one (B, S, W) shape, got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return rglru_scan_plain(a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"a/b must share one CUDA or CPU device, got "
                         f"{a.device}, {b.device}")
    a, b = a.contiguous(), b.contiguous()
    return launch(a, b, plan(a.dtype, a.shape[2],
                             (a.data_ptr(), b.data_ptr())))


def launch(a: torch.Tensor, b: torch.Tensor, kernel: str) -> torch.Tensor:
    """The wrapper's second half: launch ``kernel`` (a key of
    ``KERNEL_IDS``) on contiguous CUDA a and b that :func:`rglru_scan_fwd`
    has checked and :func:`plan` accepts.  ``chip_smoke.py`` also calls
    it, to hold the per-thread kernel at the model's shape, which the
    rule sends to the TMA ring."""
    y = torch.empty_like(a)
    bsz, s, w = a.shape
    if a.numel():
        _lib.launch("rglru_scan", a.device, a, b, y, bsz, s, w,
                    int(a.dtype == torch.bfloat16), KERNEL_IDS[kernel])
    return y
