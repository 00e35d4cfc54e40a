from . import ops, ref
from .ops import ssd_scan
from .ssd_scan import ssd_scan_fwd

__all__ = ["ops", "ref", "ssd_scan", "ssd_scan_fwd"]
