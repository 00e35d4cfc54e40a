"""The plain PyTorch version of the flash-attention kernel.

Counterpart of ``repro.kernels.flash_attention.ref.attention_ref`` in
role: the function the kernel is held against.  It repeats the kernel's
arithmetic rather than the oracle's: an online softmax over key blocks of
``BLOCK_K`` with fp32 running max, sum and accumulator, and the
probabilities cast to v's type before P·V, as the TPU kernel
(``flash_attention.py::_kernel``) and ``csrc/flash_attention.cu`` do.
Every query row is done at once (the kernel's q-blocks change no value),
and fully masked key blocks change nothing, so the kernel may skip them.
"""
from __future__ import annotations

import torch

BLOCK_Q, BLOCK_K = 64, 32    # csrc/flash_attention.cu kBlockQ, kBlockK
NEG_INF = -1e30              # the TPU kernel's NEG_INF


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool, window: int | None, scale: float,
                          seq_k: int) -> torch.Tensor:
    """q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D), Sk a multiple of BLOCK_K;
    keys at or past ``seq_k`` are masked.  Returns (B, Hq, Sq, D) in q's
    type."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qg = (q * scale).float().reshape(b, hkv, hq // hkv, sq, d)
    qpos = torch.arange(sq, device=q.device)[:, None]
    m = torch.full((b, hkv, hq // hkv, sq), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, hq // hkv, sq, d), device=q.device)
    for k0 in range(0, sk, BLOCK_K):
        kb = k[:, :, None, k0:k0 + BLOCK_K].float()       # (b, hkv, 1, bk, d)
        vb = v[:, :, None, k0:k0 + BLOCK_K]
        s = qg @ kb.transpose(-1, -2)                     # (b, hkv, g, sq, bk)
        kpos = torch.arange(k0, k0 + kb.shape[-2], device=q.device)[None, :]
        ok = kpos < seq_k
        if causal:
            ok = ok & (kpos <= qpos)
        if window is not None:
            ok = ok & (qpos - kpos < window)
        m_new = torch.maximum(m, torch.where(ok, s, NEG_INF).amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p.to(v.dtype).float() @ vb.float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, hq, sq, d).to(q.dtype)
