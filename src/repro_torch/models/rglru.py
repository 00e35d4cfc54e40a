"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427);
counterpart of ``repro.models.rglru``.

Recurrence: a_t = exp(-c * softplus(Lambda) * sigmoid(W_a x_t)),
h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (sigmoid(W_x x_t) * x_t).

Prefill runs the recurrence through the RG-LRU scan kernel
(``repro_torch.kernels.rglru_scan``) where the reference runs its
``lax.associative_scan`` twin of that kernel; decode is the O(1)
per-token update.  The block wraps the LRU with RecurrentGemma's
structure: two linear branches, a short causal conv on the recurrent
branch, tanh-GeLU gating from the other.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.rglru_scan import rglru_scan

from .common import COMPUTE_DTYPE, dense_init_, param
from .mlp import gelu_tanh

_C = 8.0   # the paper's fixed scalar


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    d_model: int
    lru_width: int | None = None
    conv_width: int = 4

    @property
    def width(self) -> int:
        return self.lru_width or self.d_model


class RGLRU(nn.Module):
    """The bare RG-LRU layer over pre-projected inputs (B, S, W)."""

    def __init__(self, cfg: RGLRUConfig, device=None):
        super().__init__()
        w = cfg.width
        self.w_a = param((w, w), device)
        self.b_a = param((w,), device)
        self.w_x = param((w, w), device)
        self.b_x = param((w,), device)
        self.a_param = param((w,), device)

    def reset_parameters(self, generator=None) -> None:
        dense_init_(self.w_a, generator)
        dense_init_(self.w_x, generator)
        with torch.no_grad():
            self.b_a.zero_()
            self.b_x.zero_()
            # Lambda so that a^c lies in [0.9, 0.999] (paper appendix).
            u = self.a_param.uniform_(0.9 ** 2, 0.999 ** 2,
                                      generator=generator)
            u.copy_(torch.log(torch.expm1(-(1.0 / _C) * torch.log(u))))

    def _gates(self, x: torch.Tensor):
        r = torch.sigmoid(torch.einsum("bsw,wv->bsv", x, self.w_a.to(x.dtype))
                          + self.b_a.to(x.dtype))
        i = torch.sigmoid(torch.einsum("bsw,wv->bsv", x, self.w_x.to(x.dtype))
                          + self.b_x.to(x.dtype))
        log_a = -_C * F.softplus(self.a_param.float()) * r.float()
        a = torch.exp(log_a)
        mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
        b = mult * (i.float() * x.float())
        return a, b

    def forward(self, x: torch.Tensor):
        """x: (B, S, W) -> (y, h_last), from a zero state."""
        a, b = self._gates(x)
        h = rglru_scan(a, b)
        return h.to(x.dtype), h[:, -1]

    def step(self, x: torch.Tensor, h: torch.Tensor):
        """x: (B, 1, W), h: (B, W) -> (y (B, 1, W), h_new)."""
        a, b = self._gates(x)
        h_new = a[:, 0] * h.float() + b[:, 0]
        return h_new[:, None].to(x.dtype), h_new


class RecurrentBlock(nn.Module):
    """RecurrentGemma mixer: x/y branches, conv1d + RG-LRU on x, GeLU(y)
    gate."""

    def __init__(self, cfg: RGLRUConfig, device=None):
        super().__init__()
        self.cfg = c = cfg
        self.proj_x = param((c.d_model, c.width), device)
        self.proj_y = param((c.d_model, c.width), device)
        self.conv_w = param((c.conv_width, c.width), device)
        self.lru = RGLRU(c, device)
        self.proj_out = param((c.width, c.d_model), device)

    def reset_parameters(self, generator=None) -> None:
        for w in (self.proj_x, self.proj_y, self.conv_w, self.proj_out):
            dense_init_(w, generator)

    def _conv(self, x: torch.Tensor, conv_state=None):
        # Tap by tap in x's dtype, as the reference's Python ``sum`` does
        # (F.conv1d would accumulate in fp32 and round differently).
        c = self.cfg
        w = self.conv_w.to(x.dtype)
        pad = (torch.zeros((x.shape[0], c.conv_width - 1, x.shape[2]),
                           dtype=x.dtype, device=x.device)
               if conv_state is None else conv_state.to(x.dtype))
        xp = torch.cat([pad, x], dim=1)
        s = x.shape[1]
        out = xp[:, 0:s] * w[0]
        for i in range(1, c.conv_width):
            out = out + xp[:, i:i + s] * w[i]
        return out, xp[:, -(c.conv_width - 1):]

    def _branches(self, u: torch.Tensor):
        x = torch.einsum("bsd,dw->bsw", u, self.proj_x.to(u.dtype))
        y = torch.einsum("bsd,dw->bsw", u, self.proj_y.to(u.dtype))
        return x, gelu_tanh(y)

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        x, gate = self._branches(u)
        x, _ = self._conv(x)
        x, _ = self.lru(x)
        return torch.einsum("bsw,wd->bsd", x * gate,
                            self.proj_out.to(u.dtype))

    def init_cache(self, batch: int, dtype=COMPUTE_DTYPE,
                   device=None) -> dict:
        c = self.cfg
        dev = self.proj_x.device if device is None else device
        return {"conv": torch.zeros((batch, c.conv_width - 1, c.width),
                                    dtype=dtype, device=dev),
                "h": torch.zeros((batch, c.width), dtype=torch.float32,
                                 device=dev)}

    def decode(self, u: torch.Tensor, cache: dict):
        x, gate = self._branches(u)
        x, conv_state = self._conv(x, cache["conv"])
        x, h = self.lru.step(x, cache["h"])
        out = torch.einsum("bsw,wd->bsd", x * gate, self.proj_out.to(u.dtype))
        return out, {"conv": conv_state, "h": h}
