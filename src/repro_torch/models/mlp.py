"""Dense gated FFN (counterpart of ``repro.models.mlp``): GeGLU / SwiGLU.
Not in this slice (raise ``NotImplementedError``): ungated and biased
MLPs."""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from .common import dense_init_, param


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    d_model: int
    d_ff: int
    activation: str = "silu"     # silu | gelu | gelu_tanh
    gated: bool = True           # SwiGLU/GeGLU when True
    use_bias: bool = False


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


_ACTS = {"silu": F.silu, "gelu": F.gelu, "gelu_tanh": gelu_tanh}


class MLP(nn.Module):
    def __init__(self, cfg: MLPConfig, device=None):
        super().__init__()
        if not cfg.gated or cfg.use_bias:
            raise NotImplementedError("ungated and biased MLPs are not "
                                      "ported yet")
        self.act = _ACTS[cfg.activation]
        self.w_up = param((cfg.d_model, cfg.d_ff), device)
        self.w_down = param((cfg.d_ff, cfg.d_model), device)
        self.w_gate = param((cfg.d_model, cfg.d_ff), device)

    def reset_parameters(self, generator=None) -> None:
        for w in (self.w_up, self.w_down, self.w_gate):
            dense_init_(w, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up = x @ self.w_up.to(x.dtype)
        h = self.act(x @ self.w_gate.to(x.dtype)) * up
        return h @ self.w_down.to(x.dtype)
