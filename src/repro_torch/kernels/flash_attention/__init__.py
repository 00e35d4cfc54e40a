from . import ops, ref
from .flash_attention import flash_attention_fwd
from .ops import flash_attention

__all__ = ["ops", "ref", "flash_attention", "flash_attention_fwd"]
