"""The plain PyTorch version of the SSD scan kernel: the chunked fp32
computation of ``csrc/ssd_scan.cu`` at its chunk (counterpart of
``repro.kernels.ssd_scan.ssd_scan._kernel``; the per-token recurrence
``repro.kernels.ssd_scan.ref.ssd_ref`` reaches the same values and stays
the oracle in the tests).

Per (batch, head) and chunk of ``chunk`` tokens, with an fp32 (hd, n)
state carried across chunks from zero::

    cum   = cumsum(dt * A)
    L     = exp(cum_i - cum_j) where j <= i, else 0
    y     = ((C B^T) * L * dt_j) x + exp(cum) * C state^T
    state = state * exp(cum_last) + (x * dt * exp(cum_last - cum))^T B

Every chunk's intra-chunk products run batched; only the state carry
walks the chunks in order.  With ``segments`` > 1 the carry follows the
bf16 kernel's decomposition: the chunks are cut into segments of
``segment_chunks`` whole chunks, each segment's end state is summed from
a zero state, with its total decay exp(sum of its chunks' cum_last), and
the segments' carried-in states are chained from those in order.  That
changes only the order of the sums.

:func:`split_bf16x3` is the kernel's exact split of an fp32 operand into
three bf16 pieces, one tensor-core product each, and
:func:`rounding_excess` the measure that holds a bf16 output to it.
"""
from __future__ import annotations

import torch

CHUNK = 64      # csrc/ssd_scan.cu kChunk: S must be a multiple


def segment_chunks(n_chunks: int, segments: int) -> int:
    """Chunks per segment when ``n_chunks`` are cut into at most
    ``segments`` segments of whole chunks (the last may be shorter)."""
    return max(1, -(-n_chunks // max(1, segments)))


def split_bf16x3(v: torch.Tensor):
    """(hi, mid, lo) in bf16 with hi + mid + lo == v exactly for fp32 v
    (pieces below fp32's normal range aside): hi = bf16(v), mid =
    bf16(v - hi), lo = bf16(v - hi - mid); each remainder is exact in
    fp32, and lo holds the last 8 of v's 24 significant bits."""
    v = v.float()
    hi = v.bfloat16()
    r = v - hi.float()
    mid = r.bfloat16()
    return hi, mid, (r - mid.float()).bfloat16()


def rounding_excess(got: torch.Tensor, want32: torch.Tensor) -> torch.Tensor:
    """Per head (axis 2 of (b, S, H, hd)): the largest amount by which
    |got - want32| exceeds bf16's rounding of the fp32 result want32
    (round to nearest: 2^-8 |want32|), over the head's largest |want32|.
    It is 0 when got is want32 rounded to bf16.  A bf16 output whose fp32
    sums differ from want32's only in their order exceeds it by those
    sums' fp32 rounding; one whose products round an fp32 operand to
    fewer bits (one bf16 piece, TF32) exceeds it by that rounding."""
    w = want32.double()
    over = (got.double() - w).abs() - w.abs() * 2.0 ** -8
    return over.clamp_min(0).amax((0, 1, 3)) / w.abs().amax(
        (0, 1, 3)).clamp_min(torch.finfo(torch.float64).tiny)


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, A: torch.Tensor, *, chunk: int = CHUNK,
                   segments: int = 1) -> torch.Tensor:
    """x (b, S, H, hd); dt (b, S, H); B/C (b, S, n), shared by the heads;
    A (H,); S % chunk == 0.  ``segments``: the carry's segments (above).
    Returns y (b, S, H, hd) in x's type."""
    b, s, h, hd = x.shape
    n = B.shape[-1]
    nc = s // chunk
    xf = x.float().reshape(b, nc, chunk, h, hd).transpose(2, 3)   # b,c,h,q,p
    dtf = dt.float().reshape(b, nc, chunk, h).transpose(2, 3)     # b,c,h,q
    Bf = B.float().reshape(b, nc, chunk, n)
    Cf = C.float().reshape(b, nc, chunk, n)
    cum = torch.cumsum(dtf * A.float()[:, None], dim=-1)
    # exp(cum_i - cum_j) overflows above the diagonal: select, never
    # multiply by a 0/1 mask (inf * 0 is NaN).
    tril = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=x.device).tril()
    seg = (cum[..., :, None] - cum[..., None, :]).masked_fill(
        ~tril, float("-inf"))
    scores = Cf @ Bf.transpose(-1, -2)                            # b,c,q,q
    M = scores[:, :, None] * torch.exp(seg) * dtf[..., None, :]
    y = M @ xf
    w = dtf * torch.exp(cum[..., -1:] - cum)
    new = (xf * w[..., None]).transpose(-1, -2) @ Bf[:, :, None]  # b,c,h,p,n
    decay = torch.exp(cum[..., -1])[..., None, None]              # b,c,h,1,1
    zero = torch.zeros((b, h, hd, n), dtype=torch.float32, device=x.device)
    per = segment_chunks(nc, segments)
    starts = range(0, nc, per)
    # Each segment's end state from zero, and its total decay.
    ends = []
    for c0 in starts[:-1]:
        state = zero
        for c in range(c0, c0 + per):
            state = state * decay[:, c] + new[:, c]
        ends.append((state, torch.exp(cum[:, c0:c0 + per, :, -1].sum(1))))
    prior = torch.empty_like(new)
    carry = zero
    for k, c0 in enumerate(starts):
        if k:
            end, total = ends[k - 1]
            carry = carry * total[..., None, None] + end
        state = carry
        for c in range(c0, min(c0 + per, nc)):
            prior[:, c] = state
            state = state * decay[:, c] + new[:, c]
    y = y + torch.exp(cum)[..., None] * (Cf[:, :, None]
                                         @ prior.transpose(-1, -2))
    return y.transpose(2, 3).reshape(b, s, h, hd).to(x.dtype)
