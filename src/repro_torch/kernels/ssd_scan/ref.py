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
walks the chunks in order.
"""
from __future__ import annotations

import torch

CHUNK = 64      # csrc/ssd_scan.cu kChunk: S must be a multiple


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, A: torch.Tensor, *, chunk: int = CHUNK
                   ) -> torch.Tensor:
    """x (b, S, H, hd); dt (b, S, H); B/C (b, S, n), shared by the heads;
    A (H,); S % chunk == 0.  Returns y (b, S, H, hd) in x's type."""
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
    decay = torch.exp(cum[..., -1])                               # b,c,h
    state = torch.zeros((b, h, hd, n), dtype=torch.float32, device=x.device)
    prior = torch.empty_like(new)
    for c in range(nc):
        prior[:, c] = state
        state = state * decay[:, c, :, None, None] + new[:, c]
    y = y + torch.exp(cum)[..., None] * (Cf[:, :, None]
                                         @ prior.transpose(-1, -2))
    return y.transpose(2, 3).reshape(b, s, h, hd).to(x.dtype)
