from . import ops, ref
from .ops import rglru_scan
from .rglru_scan import rglru_scan_fwd

__all__ = ["ops", "ref", "rglru_scan", "rglru_scan_fwd"]
