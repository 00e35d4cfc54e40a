"""Architecture registry of the port: only the architectures it runs
(``repro.configs.ARCHS`` lists all ten).  ``--arch <id>`` resolves
through ARCHS."""
from __future__ import annotations

from . import recurrentgemma_9b
from .base import ArchConfig, LayerKind

ARCHS = {
    "recurrentgemma-9b": recurrentgemma_9b,
}


def get_config(arch: str, smoke: bool = False) -> ArchConfig:
    mod = ARCHS[arch]
    return mod.smoke_config() if smoke else mod.config()


__all__ = ["ARCHS", "ArchConfig", "LayerKind", "get_config"]
