"""SSD chunked scan (Mamba-2): the CUDA kernels' wrapper.

Counterpart of ``repro.kernels.ssd_scan.ssd_scan`` (the Pallas TPU
kernel ``ssd_scan_fwd``), in the model's layout: x (b, S, H, hd), dt
(b, S, H), B and C (b, S, n) shared by every head (ngroups = 1), A (H,).
The kernels read x, B and C through their strides (in the model they
are column slices of one conv output), so nothing is copied or
broadcast over heads.  :func:`ssd_scan_fwd` launches ``csrc/ssd_scan.cu``
for CUDA tensors and runs the plain version (``ref.ssd_scan_plain``)
for CPU tensors; it never falls back from one to the other.

Which kernel a CUDA call gets is :func:`plan`'s rule, decided from dtype,
shape and alignment before the launch:

- bf16 with hd in ``TC_HEAD_DIMS``, n in ``TC_STATES``, every base 16-byte
  aligned and every stride (but the unit last one) a multiple of 8
  elements (TMA reads 16-byte aligned rows): the wgmma kernel, with the
  sequence cut into segments of whole chunks.  One CTA fits an SM at a
  time, so ``MIN_WAVES`` is the CTAs each SM runs across the waves of the
  output pass.  From the least segment count whose grid makes
  ``MIN_WAVES`` waves (or one segment per chunk, if fewer) up to twice
  that (each extra segment adds end-state work and a longer chain), the
  rule takes the count whose output pass needs the fewest chunk steps,
  waves x chunks per segment, and the fewest segments among those;
- any other float32 or bf16 call with hd and n multiples of 4: the
  CUDA-core kernel, in one segment;
- anything else is refused.

Either way the wrapper counts one ``ssd_scan`` launch per call (the
wgmma kernel makes two launches when it has more than one segment).
"""
from __future__ import annotations

import torch

from .. import _lib
from .ref import CHUNK, segment_chunks, ssd_scan_plain

DTYPES = (torch.float32, torch.bfloat16)
TC_HEAD_DIMS = (16, 32, 64)      # csrc/ssd_scan.cu launch_tc instances
TC_STATES = (16, 32, 64, 128)
HEADS_PER_CTA = 2                # one consumer warpgroup per head
MIN_WAVES = 2                    # CTAs per SM across the waves
KERNEL_IDS = {"cuda_core": 0, "wgmma": 1}   # the C entry point's `kernel`


def plan(dtype: torch.dtype, hd: int, n: int, strides, addresses, *,
         batch: int, heads: int, seq: int, sms: int) -> tuple[str, int]:
    """(kernel, segments) for a CUDA call: the rule in the module's
    docstring.  ``strides`` are the element strides of x, B and C
    (their last one is 1), ``addresses`` their data pointers, ``seq`` a
    multiple of CHUNK and ``sms`` the card's SM count.  Raises
    ValueError on what no kernel takes."""
    if dtype == torch.bfloat16 and hd in TC_HEAD_DIMS and n in TC_STATES \
            and all(a % 16 == 0 for a in addresses) \
            and all(s % 8 == 0 for s in strides):
        chunks = max(1, seq // CHUNK)
        ctas = -(-heads // HEADS_PER_CTA) * batch      # per segment
        least = min(chunks, -(-MIN_WAVES * sms // ctas))

        def steps(k):         # waves x chunks per segment, then k
            return -(-ctas * k // sms) * segment_chunks(chunks, k), k
        segments = min(range(least, min(chunks, 2 * least) + 1), key=steps)
        return "wgmma", -(-chunks // segment_chunks(chunks, segments))
    if dtype in DTYPES and hd % 4 == 0 and n % 4 == 0:
        return "cuda_core", 1
    raise ValueError(f"no SSD kernel takes {dtype} with head_dim {hd} and "
                     f"d_state {n}: the CUDA-core kernel needs both divisible "
                     f"by 4 (float4 tiles)")


def ssd_scan_fwd(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """x (b, S, H, hd) and B/C (b, S, n) float32 or bfloat16 of one type,
    dt (b, S, H) and A (H,) float32, S % CHUNK == 0.  Returns y
    (b, S, H, hd) in x's type, contiguous.  The CUDA-core kernel also
    refuses (launch error) an (hd, n) whose fp32 tiles exceed the 227 KB
    of shared memory a block can hold (``smem_floats`` in the source)."""
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
    # Strided reads need only unit stride along the last axis.
    x, B, C = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, B, C))
    A = A.contiguous()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    kernel, segs = plan(x.dtype, hd, n,
                        (*x.stride()[:3], *B.stride()[:2], *C.stride()[:2]),
                        (x.data_ptr(), B.data_ptr(), C.data_ptr()), batch=b,
                        heads=h, seq=s, sms=sms)
    return launch(x, dt, B, C, A, kernel, segs)


def launch(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
           C: torch.Tensor, A: torch.Tensor, kernel: str,
           segments: int) -> torch.Tensor:
    """The wrapper's second half: launch ``kernel`` (a key of
    ``KERNEL_IDS``) with ``segments`` segments on CUDA inputs that
    :func:`ssd_scan_fwd` has checked and :func:`plan` accepts.
    ``chip_smoke.py`` also calls it, to time the wgmma kernel at segment
    counts other than the rule's."""
    b, s, h, hd = x.shape
    n = B.shape[-1]
    y = torch.empty((b, s, h, hd), dtype=x.dtype, device=x.device)
    if y.numel():
        ends = torch.empty((b * h * segments * 64 * n if segments > 1 else 0,),
                           dtype=torch.float32, device=x.device)
        logs = torch.empty((b * h * segments if segments > 1 else 0,),
                           dtype=torch.float32, device=x.device)
        _lib.launch("ssd_scan", x.device, x, dt, B, C, A, y, ends, logs, b, s,
                    h, hd, n, *x.stride()[:3], *dt.stride(), *B.stride()[:2],
                    *C.stride()[:2], int(x.dtype == torch.bfloat16),
                    KERNEL_IDS[kernel], segment_chunks(s // CHUNK, segments))
    return y
