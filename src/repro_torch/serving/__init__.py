from .engine import Engine

__all__ = ["Engine"]
