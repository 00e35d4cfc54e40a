"""Slot-bitvector math for TDM circuit switching (port of
``repro.core.bitvec``).

An n-bit *busy* vector marks the TDM slots a circuit cannot use (bit
j == 1: slot j infeasible).  The PE-matrix search combines two
primitives: OR with a port's occupancy row, and a rotate right by one
(slot j upstream is slot j+1 at the current router).

Vectors are packed into 32-bit words (windows up to 32 slots; the paper
uses 16).  On the CPU, torch's ``uint32`` lacks shifts and comparisons,
so torch tensors hold packed vectors as ``int64`` there; on the card
they are ``int32`` tensors whose bit pattern the CUDA kernels read as
``uint32`` (:func:`packed_tensor` / :func:`packed_numpy` convert).  The
numpy twins serve the host-side trace-back and commit loop.
"""
from __future__ import annotations

import numpy as np
import torch

MAX_SLOTS = 32


def full_mask(n_slots: int) -> int:
    """All-busy mask for an n-slot window."""
    if not (0 < n_slots <= MAX_SLOTS):
        raise ValueError(f"n_slots must be in (0, {MAX_SLOTS}], got {n_slots}")
    return (1 << n_slots) - 1


def rotr(v: torch.Tensor, n_slots: int) -> torch.Tensor:
    """Rotate n-slot busy vectors right by one (element-wise, on int64
    tensors holding values in ``[0, 2**n_slots)``).

    Slot j at the upstream router corresponds to slot (j+1) mod n at the
    current router; a right rotation re-indexes upstream bits to the
    current router's slot numbering."""
    return ((v << 1) | (v >> (n_slots - 1))) & full_mask(n_slots)


def rotr_np(v, n_slots: int):
    """numpy twin of :func:`rotr` (host-side trace-back)."""
    v = np.asarray(v, np.uint32)
    mask = np.uint32(full_mask(n_slots))
    return ((v << np.uint32(1)) | (v >> np.uint32(n_slots - 1))) & mask


def rotl_np(v, n_slots: int):
    """Rotate left by one — inverse of :func:`rotr_np`."""
    v = np.asarray(v, np.uint32)
    mask = np.uint32(full_mask(n_slots))
    return ((v >> np.uint32(1)) | (v << np.uint32(n_slots - 1))) & mask


def bit_is_free(vec: int, slot: int) -> bool:
    """True iff `slot` is available (bit clear) in busy-vector `vec`."""
    return (int(vec) >> int(slot)) & 1 == 0


def free_slots(vec: int, n_slots: int) -> list[int]:
    """All available slot indices in a busy-vector."""
    return [s for s in range(n_slots) if bit_is_free(vec, s)]


def set_bit(vec: int, slot: int) -> int:
    return int(vec) | (1 << int(slot))


# ---------------------------------------------------------------------------
# Packed vectors between numpy (uint32) and torch
# ---------------------------------------------------------------------------
def packed_tensor(a, device) -> torch.Tensor:
    """uint32 packed vectors (numpy) as a tensor on ``device``: ``int32``
    bit patterns on CUDA (the kernels' ``uint32``), ``int64`` values on
    the CPU (where the plain versions shift and compare)."""
    a = np.ascontiguousarray(a, np.uint32)
    device = torch.device(device)
    if device.type == "cuda":
        return torch.from_numpy(a.view(np.int32).copy()).to(device)
    return torch.from_numpy(a.astype(np.int64))


def as_i64(t: torch.Tensor) -> torch.Tensor:
    """Packed vectors as non-negative int64 values, whatever their
    holding dtype (an ``int32`` bit pattern or ``int64`` values)."""
    if t.dtype == torch.int64:
        return t
    return t.to(torch.int64) & 0xFFFFFFFF


def as_i32_bits(t: torch.Tensor) -> torch.Tensor:
    """Packed vectors as int32 bit patterns (what the kernels read as
    uint32), from either holding dtype."""
    if t.dtype == torch.int32:
        return t
    t = t.to(torch.int64)
    return torch.where(t >= 2 ** 31, t - 2 ** 32, t).to(torch.int32)


def packed_numpy(t: torch.Tensor) -> np.ndarray:
    """Inverse of :func:`packed_tensor`: host uint32 numpy array."""
    a = t.detach().cpu().numpy()
    if a.dtype == np.int32:
        return a.view(np.uint32)
    return a.astype(np.uint32)
