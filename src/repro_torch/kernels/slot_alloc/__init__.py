from . import fused, ops, ref, slot_alloc
from ._lib import launch_counts, reset_launch_counts
from .fused import (fused_prepare, fused_prepare_packed, fused_prepare_plain,
                    fused_prepare_start, fused_prepare_wait, slot_score,
                    slot_score_plain)
from .ops import wavefront_search_kernel_batch
from .slot_alloc import wavefront_search_packed, wavefront_search_plain

__all__ = ["fused", "ops", "ref", "slot_alloc", "launch_counts",
           "reset_launch_counts", "fused_prepare", "fused_prepare_packed",
           "fused_prepare_plain", "fused_prepare_start", "fused_prepare_wait",
           "slot_score", "slot_score_plain", "wavefront_search_kernel_batch",
           "wavefront_search_packed", "wavefront_search_plain"]
