"""Serving engine, functional path (counterpart of
``repro.serving.engine.Engine.generate`` with ``track_transfers=False``):
batched greedy prefill + decode through the serve step.

The reference's engine also schedules every step's cache movement on a
NoM bank mesh (tenants, leases, admission, the fabric): that control
plane is ROADMAP queue 1's "Serving control plane" item and is not ported
yet, so ``track_transfers=True`` raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.train.state import make_serve_step


@dataclasses.dataclass
class Engine:
    model: object
    cfg: ArchConfig
    max_len: int = 256
    track_transfers: bool = True

    def __post_init__(self):
        if self.track_transfers:
            raise NotImplementedError(
                "Engine(track_transfers=True) schedules cache transfers on "
                "the NoM fabric: the serving control plane (ROADMAP queue 1, "
                "'Serving control plane') is not ported yet; pass "
                "track_transfers=False")
        self._step = make_serve_step(self.model, self.cfg)

    def generate(self, prompt: torch.Tensor, n_new: int) -> torch.Tensor:
        """prompt: (B, P) int on the model's device -> (B, P + n_new),
        the prompt kept.  The prompt is fed token by token through the
        decode step, as the reference does, then n_new tokens are chosen
        greedily."""
        b, plen = prompt.shape
        caches = self.model.init_caches(b, self.max_len)
        logits = None
        for i in range(plen):
            logits, caches = self._step(prompt[:, i:i + 1], caches, i)
        out = [prompt]
        tok = logits[:, -1:].argmax(-1).to(prompt.dtype)
        out.append(tok)
        for i in range(plen, plen + n_new - 1):
            logits, caches = self._step(tok, caches, i)
            tok = logits[:, -1:].argmax(-1).to(prompt.dtype)
            out.append(tok)
        return torch.cat(out, dim=1)
