"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060) mixer;
counterpart of ``repro.models.ssm``.

Prefill runs the chunked SSD scan through the SSD kernel
(``repro_torch.kernels.ssd_scan``) where the reference runs its einsum
twin of that kernel (``Mamba2._ssd``); decode is the O(1) per-token
state update.  Around the scan: one input projection split into the
gate z, the conv branch xBC and the step sizes dt; a short causal
depthwise conv with SiLU on xBC, which splits into x (per head), B and C
(shared by the heads); the D skip, an RMSNorm of y * silu(z), and the
output projection.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.ssd_scan import ssd_scan

from .common import COMPUTE_DTYPE, RMSNorm, dense_init_, param


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    dt_min: float = 0.001
    dt_max: float = 0.1

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


class Mamba2(nn.Module):
    def __init__(self, cfg: SSMConfig, device=None):
        super().__init__()
        self.cfg = c = cfg
        d_in_proj = 2 * c.d_inner + 2 * c.d_state + c.n_heads
        self.in_proj = param((c.d_model, d_in_proj), device)
        self.conv_w = param((c.conv_width, c.d_inner + 2 * c.d_state), device)
        self.A_log = param((c.n_heads,), device)
        self.D = param((c.n_heads,), device)
        self.dt_bias = param((c.n_heads,), device)
        self.norm = RMSNorm(c.d_inner, device=device)
        self.out_proj = param((c.d_inner, c.d_model), device)

    def reset_parameters(self, generator=None) -> None:
        c = self.cfg
        for w in (self.in_proj, self.conv_w, self.out_proj):
            dense_init_(w, generator)
        # The reference's fixed values: A = -(1 .. H), D = 1, and dt_bias
        # the inverse softplus of log-uniform steps in [dt_min, dt_max]
        # from numpy's seed 0.
        dt = np.exp(np.random.RandomState(0).uniform(
            np.log(c.dt_min), np.log(c.dt_max), c.n_heads)).astype(np.float32)
        with torch.no_grad():
            self.A_log.copy_(torch.log(torch.arange(
                1, c.n_heads + 1, dtype=torch.float32)))
            self.D.fill_(1.0)
            self.dt_bias.copy_(torch.from_numpy(dt + np.log(-np.expm1(-dt))))

    # -- projections shared by scan and step -----------------------------------
    def _project(self, u: torch.Tensor):
        c = self.cfg
        zxbcdt = torch.einsum("bsd,de->bse", u, self.in_proj.to(u.dtype))
        z, xbc, dt = torch.split(
            zxbcdt, [c.d_inner, c.d_inner + 2 * c.d_state, c.n_heads], dim=-1)
        dt = F.softplus(dt.float() + self.dt_bias.float())
        return z, xbc, dt

    def _conv(self, xbc: torch.Tensor, conv_state=None):
        """Causal depthwise conv + SiLU; returns (out, new_conv_state).
        Tap by tap in xbc's dtype, as the reference's Python ``sum`` does
        (F.conv1d would accumulate in fp32 and round differently)."""
        c = self.cfg
        w = self.conv_w.to(xbc.dtype)
        pad = (torch.zeros((xbc.shape[0], c.conv_width - 1, xbc.shape[2]),
                           dtype=xbc.dtype, device=xbc.device)
               if conv_state is None else conv_state.to(xbc.dtype))
        xp = torch.cat([pad, xbc], dim=1)
        s = xbc.shape[1]
        out = xp[:, 0:s] * w[0]
        for i in range(1, c.conv_width):
            out = out + xp[:, i:i + s] * w[i]
        return F.silu(out), xp[:, -(c.conv_width - 1):]

    def _split(self, xbc: torch.Tensor):
        """x (B, S, H, hd), B and C (B, S, n): column views of xbc."""
        c = self.cfg
        x, B, C = torch.split(xbc, [c.d_inner, c.d_state, c.d_state], dim=-1)
        return x.unflatten(-1, (c.n_heads, c.head_dim)), B, C

    def _out(self, y: torch.Tensor, x: torch.Tensor, z: torch.Tensor):
        """D skip, RMSNorm of y * silu(z), output projection."""
        c = self.cfg
        y = y.to(z.dtype) + x * self.D.to(z.dtype)[:, None]
        y = self.norm(y.flatten(-2) * F.silu(z))
        return torch.einsum("bsi,id->bsd", y, self.out_proj.to(z.dtype))

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        """Prefill: u (B, S, D), any S (the scan pads to its own chunk;
        the reference pads the whole mixer to ``ssm_chunk`` for its
        einsum scan)."""
        z, xbc, dt = self._project(u)
        xbc, _ = self._conv(xbc)
        x, B, C = self._split(xbc)
        y = ssd_scan(x, dt, B, C, -torch.exp(self.A_log.float()))
        return self._out(y, x, z)

    # -- O(1) decode -----------------------------------------------------------
    def init_cache(self, batch: int, dtype=COMPUTE_DTYPE,
                   device=None) -> dict:
        c = self.cfg
        dev = self.in_proj.device if device is None else device
        return {"conv": torch.zeros((batch, c.conv_width - 1,
                                     c.d_inner + 2 * c.d_state),
                                    dtype=dtype, device=dev),
                "ssm": torch.zeros((batch, c.n_heads, c.head_dim, c.d_state),
                                   dtype=torch.float32, device=dev)}

    def decode(self, u: torch.Tensor, cache: dict):
        """u: (B, 1, D) -> (y, new_cache)."""
        z, xbc, dt = self._project(u)
        xbc, conv_state = self._conv(xbc, cache["conv"])
        x, B, C = self._split(xbc)
        A = -torch.exp(self.A_log.float())
        dA = torch.exp(dt[:, 0] * A)                                # (B, H)
        dBx = torch.einsum("bn,bh,bhp->bhpn", B[:, 0].float(), dt[:, 0],
                           x[:, 0].float())
        h = cache["ssm"] * dA[..., None, None] + dBx
        y = torch.einsum("bn,bhpn->bhp", C[:, 0].float(), h)[:, None]
        return self._out(y, x, z), {"conv": conv_state, "ssm": h}
