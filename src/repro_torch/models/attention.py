"""Attention (counterpart of ``repro.models.attention``): GQA/MQA, causal
and sliding-window self-attention with RoPE, and single-token decode with
a (ring-buffered, for window layers) KV cache.

Prefill goes through the flash-attention kernel
(``repro_torch.kernels.flash_attention``) wherever the reference picks
one of its XLA twins of that kernel (dense, chunked or windowed einsum
attention): one call, with ``scale=1.0`` because q is scaled in
``_qkv``.  Its masks come from the kernel's block offsets, so the
reference's ``_mask`` has no counterpart here.  Decode stays plain
PyTorch, as the reference's einsum decode is outside any TPU kernel.
QKV bias and QK norm follow the reference's order in prefill and decode:
the projections, the bias (in the compute dtype), the QK norm (a plain
``RMSNorm(head_dim)`` with unit scale, also for gemma3, whose
zero-centered norms are the layer norms only), RoPE, then the scale.
Not in this slice: cross-attention (``models.lm.check_supported``
refuses the configs that need it), prefix-LM and logit soft-capping on
prefill (raise ``NotImplementedError``: the TPU kernel has neither).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.kernels.flash_attention import flash_attention

from .common import (COMPUTE_DTYPE, RMSNorm, apply_rope, dense_init_, param,
                     softcap)

NEG_INF = -2.3819763e38   # the reference's additive mask value


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    rope_theta: float = 10000.0
    use_rope: bool = True
    qkv_bias: bool = False
    qk_norm: bool = False
    logit_softcap: float | None = None
    window: int | None = None          # sliding-window size (None = global)
    causal: bool = True                # False: encoder (bidirectional)

    @property
    def groups(self) -> int:
        return self.n_heads // self.n_kv


class Attention(nn.Module):
    def __init__(self, cfg: AttentionConfig, device=None):
        super().__init__()
        self.cfg = c = cfg
        self.wq = param((c.d_model, c.n_heads, c.head_dim), device)
        self.wk = param((c.d_model, c.n_kv, c.head_dim), device)
        self.wv = param((c.d_model, c.n_kv, c.head_dim), device)
        self.wo = param((c.n_heads, c.head_dim, c.d_model), device)
        if c.qkv_bias:
            self.bq = param((c.n_heads, c.head_dim), device)
            self.bk = param((c.n_kv, c.head_dim), device)
            self.bv = param((c.n_kv, c.head_dim), device)
        if c.qk_norm:
            self.q_norm = RMSNorm(c.head_dim, device=device)
            self.k_norm = RMSNorm(c.head_dim, device=device)

    def reset_parameters(self, generator=None) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            dense_init_(w, generator)
        if self.cfg.qkv_bias:
            with torch.no_grad():
                for b in (self.bq, self.bk, self.bv):
                    b.zero_()

    def _qkv(self, x, positions):
        c = self.cfg
        q = torch.einsum("bsd,dnh->bsnh", x, self.wq.to(x.dtype))
        k = torch.einsum("bsd,dnh->bsnh", x, self.wk.to(x.dtype))
        v = torch.einsum("bsd,dnh->bsnh", x, self.wv.to(x.dtype))
        if c.qkv_bias:
            q = q + self.bq.to(q.dtype)
            k = k + self.bk.to(k.dtype)
            v = v + self.bv.to(v.dtype)
        if c.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        if c.use_rope:
            q = apply_rope(q, positions, c.rope_theta)
            k = apply_rope(k, positions, c.rope_theta)
        scale = torch.tensor(1.0 / np.sqrt(c.head_dim), dtype=q.dtype)
        return q * scale, k, v

    def forward(self, x: torch.Tensor, *, prefix_len=None) -> torch.Tensor:
        """Prefill self-attention over positions 0..S-1.  x: (B, S, D)."""
        c = self.cfg
        if prefix_len is not None or c.logit_softcap is not None:
            raise NotImplementedError(
                "prefix-LM and logit soft-capping on prefill are not ported "
                "(the flash-attention kernel has neither)")
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        q, k, v = self._qkv(x, positions)
        out = flash_attention(q, k, v, causal=c.causal, window=c.window,
                              scale=1.0)
        return torch.einsum("bsnh,nhd->bsd", out, self.wo.to(out.dtype))

    def decode(self, x: torch.Tensor, cache: dict, pos: int):
        """Single-token decode.  x: (B, 1, D); cache {'k', 'v'}:
        (B, Smax, Hkv, hd); pos: absolute position of the new token.
        Window layers hold Smax == window (a ring buffer).  Unlike the
        reference, the cache is updated in place (and returned)."""
        c = self.cfg
        b = x.shape[0]
        positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
        q, k, v = self._qkv(x, positions)
        smax = cache["k"].shape[1]
        slot = pos % smax if c.window is not None else pos
        cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
        # positions stored in the cache: a ring for window layers
        idx = torch.arange(smax, device=x.device)
        if c.window is not None:
            wrap = (pos // smax) * smax
            k_pos = torch.where(idx <= pos % smax, wrap + idx,
                                wrap - smax + idx)
        else:
            k_pos = idx
        valid = (k_pos >= 0) & (k_pos <= pos)
        if c.window is not None:
            valid &= (pos - k_pos) < c.window
        mask = torch.where(valid, 0.0, NEG_INF)
        qg = q.reshape(b, 1, c.n_kv, c.groups, c.head_dim)
        logits = torch.einsum("bskgh,btkh->bkgst", qg, cache["k"]).float()
        logits = softcap(logits, c.logit_softcap) + mask
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        out = torch.einsum("bkgst,btkh->bskgh", probs, cache["v"])
        out = out.reshape(b, 1, c.n_heads, c.head_dim)
        return torch.einsum("bsnh,nhd->bsd", out, self.wo.to(out.dtype)), cache

    def init_cache(self, batch: int, max_len: int,
                   dtype=COMPUTE_DTYPE, device=None) -> dict:
        c = self.cfg
        n = min(max_len, c.window) if c.window is not None else max_len
        shape = (batch, n, c.n_kv, c.head_dim)
        dev = self.wq.device if device is None else device
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev)}
