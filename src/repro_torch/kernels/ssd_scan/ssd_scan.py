"""SSD chunked scan (Mamba-2): the CUDA kernel's wrapper.

Counterpart of ``repro.kernels.ssd_scan.ssd_scan`` (the Pallas TPU
kernel ``ssd_scan_fwd``), in the model's layout: x (b, S, H, hd), dt
(b, S, H), B and C (b, S, n) shared by every head (ngroups = 1), A (H,).
The kernel reads x, B and C through their strides (in the model they
are column slices of one conv output), so nothing is copied or
broadcast over heads.  :func:`ssd_scan_fwd` launches ``csrc/ssd_scan.cu``
for CUDA tensors and runs the plain version (``ref.ssd_scan_plain``)
for CPU tensors; it never falls back from one to the other.
"""
from __future__ import annotations

import torch

from .. import _lib
from .ref import CHUNK, ssd_scan_plain

DTYPES = (torch.float32, torch.bfloat16)


def ssd_scan_fwd(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """x (b, S, H, hd) and B/C (b, S, n) float32 or bfloat16 of one type,
    dt (b, S, H) and A (H,) float32, S % CHUNK == 0.  Returns y
    (b, S, H, hd) in x's type, contiguous.  The kernel also refuses
    (launch error) an (hd, n) whose fp32 tiles exceed the 227 KB of
    shared memory a block can hold (``smem_floats`` in the source)."""
    if x.dtype not in DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"the SSD scan takes float32 or bfloat16 x/B/C of one "
                        f"type, got {x.dtype}, {B.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32, got {dt.dtype}, "
                        f"{A.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be (b, S, H, hd), got {tuple(x.shape)}")
    b, s, h, hd = x.shape
    n = B.shape[-1]
    if (dt.shape != (b, s, h) or B.dim() != 3 or B.shape[:2] != (b, s)
            or C.shape != B.shape or A.shape != (h,) or s % CHUNK):
        raise ValueError(f"bad shapes x {tuple(x.shape)} dt {tuple(dt.shape)} "
                         f"B {tuple(B.shape)} C {tuple(C.shape)} A "
                         f"{tuple(A.shape)} (S % {CHUNK} == 0)")
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, B, C, A)
    if x.device.type != "cuda" or any(t.device != x.device
                                      for t in (dt, B, C, A)):
        raise ValueError(f"x/dt/B/C/A must share one CUDA or CPU device, got "
                         f"{[str(t.device) for t in (x, dt, B, C, A)]}")
    if hd % 4 or n % 4:
        raise ValueError(f"the kernel takes head_dim and d_state divisible "
                         f"by 4 (float4 tiles), got {hd}, {n}")
    # Strided reads need only unit stride along the last axis.
    x, B, C = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, B, C))
    A = A.contiguous()
    y = torch.empty((b, s, h, hd), dtype=x.dtype, device=x.device)
    if y.numel():
        _lib.launch("ssd_scan", x.device, x, dt, B, C, A, y, b, s, h, hd, n,
                    *x.stride()[:3], *dt.stride(), *B.stride()[:2],
                    *C.stride()[:2], int(x.dtype == torch.bfloat16))
    return y
