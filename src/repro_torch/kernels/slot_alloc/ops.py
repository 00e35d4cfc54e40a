"""The search kernel's batch contract (counterpart of
``repro.kernels.slot_alloc.ops``).

``wavefront_search_kernel_batch`` matches
``repro.core.slot_alloc.wavefront_search_batch``: occ (n, N_PORTS)
packed uint32, srcs/dsts (B,) node ids, init (B,) uint32 -> (B, n)
packed busy vectors.  Inputs may be numpy arrays (uploaded to
``device``) or tensors (their device wins); the result is a tensor on
that device — :func:`repro_torch.core.bitvec.packed_numpy` brings it to
the host as uint32.

Every device search of ``TdmAllocator`` comes through this entry; with
``use_kernels=True`` even a one-request round does.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bitvec import packed_tensor
from repro_torch.core.topology import Mesh3D
from repro_torch.device import resolve_device

from .slot_alloc import wavefront_search_packed


def _ids(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.as_tensor(np.asarray(a, np.int64), device=device)


def wavefront_search_kernel_batch(occ_packed, srcs, dsts, init_vecs, *,
                                  mesh: Mesh3D, n_slots: int,
                                  device="cuda") -> torch.Tensor:
    """Batch contract of the search on ``occ_packed``'s device (or
    ``device`` when it is a host array)."""
    if isinstance(occ_packed, torch.Tensor):
        occ, dev = occ_packed, occ_packed.device
    else:
        dev = resolve_device(device)
        occ = packed_tensor(occ_packed, dev)
    init = (init_vecs.to(dev) if isinstance(init_vecs, torch.Tensor)
            else packed_tensor(init_vecs, dev))
    return wavefront_search_packed(occ, _ids(srcs, dev), _ids(dsts, dev),
                                   init, mesh=mesh, n_slots=n_slots)
