from . import ref
from .rglru_scan import rglru_scan_fwd
from .rglru_scan import rglru_scan_fwd as rglru_scan

__all__ = ["ref", "rglru_scan", "rglru_scan_fwd"]
