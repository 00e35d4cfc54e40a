"""Model substrate of the port: norms, embedding, RoPE, initialisers
(counterpart of ``repro.models.common``).

The reference's modules are dataclasses over parameter pytrees; here they
are ``nn.Module``s that hold their parameters, with the reference's names
and shapes, so that ``models.convert.params_from_reference`` maps one
tree onto the other key for key.  ``forward`` is the reference's
``apply`` (``nn.Module.apply`` is PyTorch's own and is left alone).
Parameters are inference-only (``requires_grad=False``) until the
training slice.

Dtype policy, as in the reference: parameters live in fp32
(``PARAM_DTYPE``), compute runs in bf16 (``COMPUTE_DTYPE``), logits in
fp32.  Every layer computes in the dtype of its input, so the embedding's
output dtype (``CausalLM.compute_dtype``) sets it for the whole model.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

COMPUTE_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.float32


def param(shape, device) -> nn.Parameter:
    """An uninitialised fp32 parameter (``reset_parameters`` fills it)."""
    return nn.Parameter(torch.empty(shape, dtype=PARAM_DTYPE, device=device),
                        requires_grad=False)


def dense_init_(t: torch.Tensor, generator: torch.Generator,
                in_axis: int = 0, scale: float = 1.0) -> None:
    """Truncated-normal fan-in init in place: N(0, scale^2 / fan_in) cut at
    +-2 sigma, with fan_in = ``t.shape[in_axis]`` (the reference's
    ``dense_init``)."""
    std = scale / math.sqrt(t.shape[in_axis])
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


class RMSNorm(nn.Module):
    """RMS norm; ``zero_centered`` scales by (1 + scale) (gemma)."""

    def __init__(self, dim: int, eps: float = 1e-6,
                 zero_centered: bool = False, device=None):
        super().__init__()
        self.eps, self.zero_centered = eps, zero_centered
        self.scale = param((dim,), device)

    def reset_parameters(self, generator=None) -> None:
        del generator
        with torch.no_grad():
            self.scale.fill_(0.0 if self.zero_centered else 1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # Only the statistic runs in fp32; the tensor stays in its dtype.
        var = x.float().square().mean(-1, keepdim=True)
        inv = torch.rsqrt(var + self.eps).to(x.dtype)
        scale = self.scale.float()
        if self.zero_centered:
            scale = 1.0 + scale
        return x * inv * scale.to(x.dtype)


class Embed(nn.Module):
    def __init__(self, vocab: int, dim: int, scale_by_sqrt_dim: bool = False,
                 device=None):
        super().__init__()
        self.dim, self.scale_by_sqrt_dim = dim, scale_by_sqrt_dim
        self.embedding = param((vocab, dim), device)

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.embedding.normal_(0.0, 1.0, generator=generator)

    def forward(self, ids: torch.Tensor,
                dtype: torch.dtype = COMPUTE_DTYPE) -> torch.Tensor:
        """The rows of ``ids`` in ``dtype``, the compute dtype of every
        layer after it."""
        # The reference gathers from the whole table cast to bf16; gathering
        # the rows first gives the same numbers without the table's copy.
        x = self.embedding[ids].to(dtype)
        if self.scale_by_sqrt_dim:
            x = x * torch.tensor(math.sqrt(self.dim), dtype=dtype)
        return x

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """Tied-embedding logits (fp32)."""
        return x.float() @ self.embedding.float().T


def rope_freqs(head_dim: int, theta: float = 10000.0) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Split-half (not interleaved) RoPE.  x: (..., seq, heads, head_dim),
    positions: (..., seq)."""
    freqs = torch.tensor(rope_freqs(x.shape[-1], theta), dtype=torch.float32,
                         device=x.device)
    angles = positions[..., :, None, None].float() * freqs
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(logits: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return logits
    return torch.tanh(logits / cap) * cap
