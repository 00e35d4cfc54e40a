"""The plain PyTorch version of the flash-attention kernel.

Counterpart of ``repro.kernels.flash_attention.ref.attention_ref`` in
role: the function the kernel is held against.  It repeats the kernel's
arithmetic rather than the oracle's: an online softmax over key blocks
with fp32 running max, sum and accumulator, and the probabilities cast to
v's type before P·V, as the TPU kernel (``flash_attention.py::_kernel``)
and ``csrc/flash_attention.cu`` do.  The bf16 probabilities are rounded
against each block's running max, so the blocks are the kernel's for the
input's type (``KEY_BLOCK``).
Every query row is done at once (the kernel's q-blocks change no value),
and fully masked key blocks change nothing, so the kernel may skip them.
"""
from __future__ import annotations

import torch

# Key block of the kernel for each type (csrc/flash_attention.cu: the
# bf16 kernel's kBlockN, the fp32 kernel's kBlockK).
KEY_BLOCK = {torch.bfloat16: 64, torch.float32: 32}
# What the wrapper pads Sq and Sk to: multiples of both kernels' blocks
# (query blocks 128 and 64, key blocks 64 and 32).
BLOCK_Q, BLOCK_K = 128, 64
NEG_INF = -1e30              # the TPU kernel's NEG_INF


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool, window: int | None, scale: float,
                          seq_k: int) -> torch.Tensor:
    """q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) of one type in
    ``KEY_BLOCK``, Sk a multiple of its key block; keys at or past
    ``seq_k`` are masked.  Returns (B, Hq, Sq, D) in q's type."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    bk = KEY_BLOCK[v.dtype]
    qg = (q * scale).float().reshape(b, hkv, hq // hkv, sq, d)
    qpos = torch.arange(sq, device=q.device)[:, None]
    m = torch.full((b, hkv, hq // hkv, sq), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, hq // hkv, sq, d), device=q.device)
    for k0 in range(0, sk, bk):
        kb = k[:, :, None, k0:k0 + bk].float()            # (b, hkv, 1, bk, d)
        vb = v[:, :, None, k0:k0 + bk]
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
