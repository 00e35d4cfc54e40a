"""Architecture registry: the 10 assigned architectures + the paper's own
NoM memory-system config (a copy of ``repro.configs``; the configs are
data, so the registry equals the reference's).  ``--arch <id>`` resolves
through ARCHS; which of them the port runs is decided by
``repro_torch.models.lm.check_supported`` alone."""
from __future__ import annotations

from . import (command_r_plus, gemma3_27b, mamba2_130m, paligemma_3b,
               phi35_moe, qwen15_4b, qwen25_32b, qwen3_moe,
               recurrentgemma_9b, whisper_small)
from .base import ArchConfig, LayerKind

ARCHS = {
    "whisper-small": whisper_small,
    "phi3.5-moe-42b-a6.6b": phi35_moe,
    "qwen3-moe-235b-a22b": qwen3_moe,
    "recurrentgemma-9b": recurrentgemma_9b,
    "mamba2-130m": mamba2_130m,
    "qwen2.5-32b": qwen25_32b,
    "qwen1.5-4b": qwen15_4b,
    "command-r-plus-104b": command_r_plus,
    "gemma3-27b": gemma3_27b,
    "paligemma-3b": paligemma_3b,
}

# The four assigned input shapes (seq_len, global_batch, kind).
SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32_768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32_768, batch=128, kind="decode"),
    "long_500k": dict(seq=524_288, batch=1, kind="decode"),
}


def get_config(arch: str, smoke: bool = False) -> ArchConfig:
    mod = ARCHS[arch]
    return mod.smoke_config() if smoke else mod.config()


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells with skip annotations."""
    out = []
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape, spec in SHAPES.items():
            skip = None
            if shape == "long_500k" and not cfg.sub_quadratic:
                skip = "pure full-attention arch (see DESIGN.md skips)"
            if skip is None or include_skipped:
                out.append((arch, shape, skip))
    return out


__all__ = ["ARCHS", "SHAPES", "ArchConfig", "LayerKind", "get_config",
           "cells"]
