"""Top-level model (counterpart of ``repro.models.lm``): the decoder-only
``CausalLM`` with its decode step.

Its layers are attention, RG-LRU and SSM (Mamba-2) mixers with an MLP
ffn or none.  Not ported yet: ``EncDecLM`` (whisper), prefix-LM inputs
(VLM), MoE layers, QKV bias, QK norm, LayerNorm, sandwich norms and
untied heads; ``CausalLM`` and :func:`make_model` raise
``NotImplementedError`` for configs that need them.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device

from .blocks import LayerStack, _norm
from .common import COMPUTE_DTYPE, Embed


class CausalLM(nn.Module):
    """``compute_dtype`` (bf16, the reference's policy) is the dtype of
    the activations and caches; setting it to fp32 runs the same model
    with every rounding of the bf16 path removed."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        check_supported(cfg)
        self.cfg, self.compute_dtype = cfg, COMPUTE_DTYPE
        self.embed = Embed(cfg.padded_vocab, cfg.d_model,
                           scale_by_sqrt_dim=cfg.scale_embed_sqrt_d,
                           device=device)
        self.stack = LayerStack(cfg, cfg.n_layers, device)
        self.final_norm = _norm(cfg, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Initialise every parameter in place from ``generator``."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: (B, S) int -> logits (B, S, V) fp32 (the reference's
        ``apply`` without its MoE aux loss)."""
        x = self.stack(self.embed(tokens, self.compute_dtype))
        return self.embed.attend(self.final_norm(x))

    def init_caches(self, batch: int, max_len: int) -> list:
        return self.stack.init_caches(batch, max_len, self.compute_dtype)

    def cache_layout(self, batch: int, max_len: int) -> dict:
        """The caches as the reference lays them out, on the ``meta``
        device (shapes and dtypes only): ``{"groups": {"l<i>": ...},
        "tail": {"l<i>": ...}}``, pattern position ``i`` of the scan
        groups stacked on a leading ``n_groups`` axis, then the layers
        past the last whole group.  The serving engine places cache
        leaves by this tree, so its tags and byte counts are the
        reference's."""
        per_layer = self.stack.init_caches(batch, max_len,
                                           self.compute_dtype, "meta")
        gs = len(self.cfg.pattern)
        n_groups = self.cfg.n_layers // gs
        groups = {f"l{i}": {k: v.expand((n_groups,) + v.shape)
                            for k, v in per_layer[i].items()}
                  for i in range(gs if n_groups else 0)}
        tail = {f"l{i}": per_layer[n_groups * gs + i]
                for i in range(self.cfg.n_layers % gs)}
        return {"groups": groups, "tail": tail}

    def decode_step(self, token: torch.Tensor, caches: list, pos: int):
        """token: (B, 1) -> (logits (B, 1, V) fp32, caches)."""
        x, caches = self.stack.decode(self.embed(token, self.compute_dtype),
                                      caches, pos)
        return self.embed.attend(self.final_norm(x)), caches


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for what this slice does not port."""
    missing = []
    if cfg.arch_type != "decoder":
        missing.append(f"arch_type={cfg.arch_type!r} (EncDecLM, VLM prefix)")
    for k in cfg.pattern:
        if k.mixer not in ("attn", "rglru", "ssm"):
            missing.append(f"{k.mixer} mixers")
        if k.ffn not in ("mlp", "none"):
            missing.append(f"{k.ffn} ffns")
    if cfg.norm_type != "rms" or cfg.post_norms:
        missing.append("LayerNorm / sandwich norms")
    if not cfg.tie_embeddings:
        missing.append("untied LM head")
    if cfg.qkv_bias or cfg.qk_norm:
        missing.append("QKV bias / QK norm")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet: {', '.join(sorted(set(missing)))} "
            "(ROADMAP queue 1)")


def make_model(cfg: ArchConfig, *, device="cuda", seed: int = 0
               ) -> CausalLM:
    """The port's model of ``cfg`` on ``device``, its weights drawn from a
    ``torch.Generator`` on that device seeded with ``seed``."""
    dev = resolve_device(device)
    model = CausalLM(cfg, dev)
    model.reset_parameters(torch.Generator(dev).manual_seed(seed))
    return model
