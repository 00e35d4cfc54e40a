"""Inference step factories (counterpart of the prefill and serve steps
of ``repro.train.state``).  The port's model holds its weights, so the
steps take no ``params`` argument; both run without autograd."""
from __future__ import annotations

import torch


def make_serve_step(model, cfg):
    """serve_step(token, caches, pos) -> (logits, caches): one decode
    step."""
    del cfg

    @torch.no_grad()
    def serve_step(token, caches, pos):
        return model.decode_step(token, caches, pos)
    return serve_step


def make_prefill_step(model, cfg):
    """prefill_step(tokens) -> logits: the full forward at inference."""
    del cfg

    @torch.no_grad()
    def prefill_step(tokens):
        return model(tokens)
    return prefill_step
