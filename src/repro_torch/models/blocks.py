"""Layer composition (counterpart of ``repro.models.blocks``): decoder
layers (attention, RG-LRU or SSM mixer; MLP ffn or none) and the layer
stack.

The reference scans ``lax.scan`` over stacked groups of the layer pattern
(recurrentgemma: rglru, rglru, attn; mamba2: ssm) plus a tail, with remat
and sharding hints; on one device the port keeps plain per-layer modules,
layer j being of kind ``pattern[j % len(pattern)]`` as in the reference.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, LayerKind

from .attention import Attention, AttentionConfig
from .common import RMSNorm
from .mlp import MLP, MLPConfig
from .rglru import RecurrentBlock, RGLRUConfig
from .ssm import Mamba2, SSMConfig


def _norm(cfg: ArchConfig, device=None) -> RMSNorm:
    return RMSNorm(cfg.d_model, zero_centered=cfg.zero_centered_norm,
                   device=device)


def make_mixer(cfg: ArchConfig, kind: LayerKind, device=None):
    if kind.mixer == "attn":
        return Attention(AttentionConfig(
            d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
            head_dim=cfg.resolved_head_dim,
            rope_theta=kind.rope_theta or cfg.rope_theta,
            use_rope=cfg.use_rope, qkv_bias=cfg.qkv_bias,
            qk_norm=cfg.qk_norm, logit_softcap=cfg.logit_softcap,
            window=kind.window), device)
    if kind.mixer == "ssm":
        return Mamba2(SSMConfig(d_model=cfg.d_model, d_state=cfg.ssm_state,
                                head_dim=cfg.ssm_head_dim), device)
    if kind.mixer == "rglru":
        return RecurrentBlock(RGLRUConfig(d_model=cfg.d_model,
                                          lru_width=cfg.lru_width), device)
    raise NotImplementedError(f"mixer {kind.mixer!r} is not ported yet")


class DecoderLayer(nn.Module):
    """Pre-norm residual layer: mixer, then the ffn where the kind has
    one (``ffn="none"``, as mamba2's, has neither ``ln2`` nor ``ffn``).
    With ``cfg.post_norms`` (gemma3's sandwich norms) ``ln1_post`` and
    ``ln2_post`` normalise the mixer's and the ffn's outputs before their
    residual adds."""

    def __init__(self, cfg: ArchConfig, kind: LayerKind, device=None):
        super().__init__()
        if kind.ffn not in ("mlp", "none"):
            raise NotImplementedError(f"ffn {kind.ffn!r} is not ported yet")
        self.ln1 = _norm(cfg, device)
        self.mixer = make_mixer(cfg, kind, device)
        if kind.ffn == "mlp":
            self.ln2 = _norm(cfg, device)
            self.ffn = MLP(MLPConfig(cfg.d_model, cfg.d_ff, activation=cfg.act,
                                     gated=cfg.gated_mlp,
                                     use_bias=cfg.mlp_bias), device)
        else:
            self.ffn = None
        self.post_norms = cfg.post_norms
        if cfg.post_norms:
            self.ln1_post = _norm(cfg, device)
            if self.ffn is not None:
                self.ln2_post = _norm(cfg, device)

    def _residual(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """x + the mixer's output h, then the ffn's block."""
        if self.post_norms:
            h = self.ln1_post(h)
        x = x + h
        if self.ffn is None:
            return x
        h = self.ffn(self.ln2(x))
        if self.post_norms:
            h = self.ln2_post(h)
        return x + h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._residual(x, self.mixer(self.ln1(x)))

    def decode(self, x: torch.Tensor, cache: dict, pos: int):
        h = self.ln1(x)
        if isinstance(self.mixer, Attention):
            h, cache = self.mixer.decode(h, cache, pos)
        else:
            h, cache = self.mixer.decode(h, cache)
        return self._residual(x, h), cache

    def init_cache(self, batch: int, max_len: int, dtype,
                   device=None) -> dict:
        if isinstance(self.mixer, Attention):
            return self.mixer.init_cache(batch, max_len, dtype, device)
        return self.mixer.init_cache(batch, dtype, device)


class LayerStack(nn.Module):
    """``n_layers`` decoder layers in the order of the repeating
    pattern."""

    def __init__(self, cfg: ArchConfig, n_layers: int, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, cfg.pattern[j % len(cfg.pattern)], device)
            for j in range(n_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x

    def decode(self, x: torch.Tensor, caches: list, pos: int):
        new = []
        for layer, cache in zip(self.layers, caches):
            x, cache = layer.decode(x, cache, pos)
            new.append(cache)
        return x, new

    def init_caches(self, batch: int, max_len: int, dtype,
                    device=None) -> list:
        return [layer.init_cache(batch, max_len, dtype, device)
                for layer in self.layers]
