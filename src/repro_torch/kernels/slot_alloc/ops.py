"""The search kernel's batch contract (counterpart of
``repro.kernels.slot_alloc.ops``).

``wavefront_search_kernel_batch`` matches
``repro.core.slot_alloc.wavefront_search_batch``: occ (n, N_PORTS)
packed uint32, srcs/dsts (B,) node ids, init (B,) uint32 -> (B, n)
packed busy vectors.  Inputs may be numpy arrays (uploaded to
``device``) or tensors (their device wins); the result is a tensor on
that device — :func:`repro_torch.core.bitvec.packed_numpy` brings it to
the host as uint32.

``wavefront_search_host`` is the allocator's search round (every
device search of ``TdmAllocator`` comes through it; with
``use_kernels=True`` even a one-request round does): host arrays in,
(B, n) uint32 busy vectors out, with one upload of the packed request
words, one launch and one pull into reused pinned memory.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bitvec import packed_numpy, packed_tensor
from repro_torch.core.topology import Mesh3D
from repro_torch.device import resolve_device

from .. import _lib
from .slot_alloc import (check_occ, give_staging, take_staging,
                         wavefront_search_packed)


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


def wavefront_search_host(occ: torch.Tensor, srcs, dsts, init_vecs, *,
                          mesh: Mesh3D, n_slots: int) -> np.ndarray:
    """One search round on ``occ``'s device from host arrays: (B, n)
    uint32 busy vectors on the host.  On CUDA the request words [srcs |
    dsts | init] go up in one copy from a reused pinned buffer, and the
    result comes down in one copy into the same buffer, around one
    launch; the CPU runs the plain version."""
    if not occ.is_cuda:
        return packed_numpy(wavefront_search_kernel_batch(
            occ, srcs, dsts, init_vecs, mesh=mesh, n_slots=n_slots))
    occ = check_occ(occ, mesh, n_slots)
    dev = occ.device
    B, n = len(srcs), mesh.n_nodes
    if B == 0:
        return np.zeros((0, n), np.uint32)
    st = take_staging(dev, 3 * B + B * n)
    h = st.host_np
    h[:B] = srcs
    h[B:2 * B] = dsts
    h[2 * B:3 * B] = np.asarray(init_vecs, np.uint32).view(np.int32)
    off = 3 * B * 4
    stream = torch.cuda.current_stream(dev)
    _lib.launch("wavefront_search", dev, occ, st.dev, st.host,
                st.dev.data_ptr() + off, st.host.data_ptr() + off, B,
                mesh.X, mesh.Y, mesh.Z, n_slots, stream=stream)
    st.event.record(stream)
    st.event.synchronize()
    out = h[3 * B:3 * B + B * n].view(np.uint32).reshape(B, n).copy()
    give_staging(st)
    return out
