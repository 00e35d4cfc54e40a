"""The PE-matrix wavefront search: CUDA kernel + plain PyTorch version.

Counterpart of ``repro.kernels.slot_alloc.slot_alloc`` (the Pallas TPU
kernel ``wavefront_search_planes``).  Both versions here take the packed
contract directly — occ (n, N_PORTS), srcs/dsts (B,), init (B,) packed
32-bit words -> (B, n) busy vectors — because on the GPU a busy vector is
one 32-bit word per node (``csrc/wavefront_search.cu``), not the TPU's
(n, 128) bit-plane tile.

:func:`wavefront_search_packed` launches the kernel for CUDA tensors and
runs :func:`wavefront_search_plain` for CPU tensors; it never falls back
from one to the other.  :class:`Staging` holds the reused pinned and
device buffers through which the allocator's calls move a wave's
requests and results.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.bitvec import as_i32_bits, as_i64, full_mask, rotr
from repro_torch.core.topology import Mesh3D

from .. import _lib

# Shared memory of a fused-prepare CTA is 4 * n * (7 + 2 * 3) bytes (the
# occupancy table, and for each of its two warps a box vector and two
# trace-back masks: ``smem_bytes`` in ``csrc/slot_alloc.cuh``): 156 KB at
# 3072 nodes, within the 227 KB a Hopper CTA may opt into.
MAX_NODES = 3072


def _check_mesh(mesh: Mesh3D, n_slots: int) -> None:
    full_mask(n_slots)                      # validates 0 < n_slots <= 32
    if mesh.n_nodes > MAX_NODES:
        raise ValueError(f"mesh has {mesh.n_nodes} nodes; the search "
                         f"kernels hold at most {MAX_NODES}")


def check_occ(occ: torch.Tensor, mesh: Mesh3D, n_slots: int) -> torch.Tensor:
    """The occupancy table as the kernels read it: (n, 7) int32 bit
    patterns, contiguous.  Raises on a mesh or shape they do not take."""
    _check_mesh(mesh, n_slots)
    if tuple(occ.shape) != (mesh.n_nodes, 7):
        raise ValueError(f"occ must be ({mesh.n_nodes}, 7), got "
                         f"{tuple(occ.shape)}")
    return as_i32_bits(occ).contiguous()


@dataclasses.dataclass(eq=False)
class Staging:
    """Reused buffers of one call on the card: int32 words in pinned
    host memory (``host``, and ``host_np``, its numpy view) and on the
    device, an event that closes the call's work on its stream, and one
    for a side stream to wait on the caller's.  A call packs its request
    words into ``host``; the C entry point copies them up, launches, and
    copies the result down into ``host`` after them.
    :func:`take_staging` hands a buffer out, :func:`give_staging` takes it
    back once its event has fired; the owner gives it back only when
    nothing can read it any more, so a buffer is never rewritten while a
    copy, a kernel or a reader still uses it."""
    host: torch.Tensor
    dev: torch.Tensor
    event: torch.cuda.Event
    ready: torch.cuda.Event
    host_np: np.ndarray


_free_staging: dict[torch.device, list[Staging]] = {}


def take_staging(device: torch.device, words: int) -> Staging:
    """A free staging buffer of at least ``words`` int32 words on
    ``device`` (allocated, at a power of two >= 1024, when none fits)."""
    free = _free_staging.setdefault(device, [])
    for i, st in enumerate(free):
        if st.host.numel() >= words:
            return free.pop(i)
    size = max(1024, 1 << (words - 1).bit_length())
    host = torch.empty(size, dtype=torch.int32, pin_memory=True)
    return Staging(host, torch.empty(size, dtype=torch.int32, device=device),
                   torch.cuda.Event(), torch.cuda.Event(), host.numpy())


def give_staging(st: Staging) -> None:
    """Return ``st`` to the free list after its event has fired."""
    st.event.synchronize()
    _free_staging.setdefault(st.dev.device, []).append(st)


def _geometry(mesh: Mesh3D, srcs: torch.Tensor, dsts: torch.Tensor):
    """Per-request lattice geometry on the requests' device: coords (n,3),
    src coords (B,3), sign (B,3), in-box mask (B,n), lattice distance
    from the source (B,n), request distance (B,), upstream node per dim
    (B,3,n) and sign-chosen output port per dim (B,3)."""
    dev = srcs.device
    coords = torch.as_tensor(mesh.coord_array, dtype=torch.int64, device=dev)
    sc, dc = coords[srcs], coords[dsts]
    sign = torch.sign(dc - sc)
    lo, hi = torch.minimum(sc, dc), torch.maximum(sc, dc)
    in_box = ((coords[None] >= lo[:, None]) & (coords[None] <= hi[:, None])
              ).all(-1)
    off = (coords[None] - sc[:, None]).abs().sum(-1)
    dist = (dc - sc).abs().sum(-1)
    strides = torch.tensor([1, mesh.X, mesh.X * mesh.Y], device=dev)
    node = torch.arange(mesh.n_nodes, device=dev)
    ups = (node[None, None, :] - (sign * strides)[:, :, None]).clamp(
        0, mesh.n_nodes - 1)
    dims = torch.arange(3, device=dev)
    ports = torch.where(sign < 0, 2 * dims + 1, 2 * dims)
    return coords, sc, sign, in_box, off, dist, ups, ports


def wavefront_search_plain(occ: torch.Tensor, srcs: torch.Tensor,
                           dsts: torch.Tensor, init: torch.Tensor, *,
                           mesh: Mesh3D, n_slots: int) -> torch.Tensor:
    """Plain PyTorch version of the search (any device): the same layered
    fixpoint as the kernel, vectorized over the batch.  Returns (B, n)
    int64 busy vectors."""
    _check_mesh(mesh, n_slots)
    srcs, dsts = srcs.to(torch.int64), dsts.to(torch.int64)
    occ = as_i64(occ)
    B, n = srcs.shape[0], mesh.n_nodes
    fm = full_mask(n_slots)
    coords, sc, _sign, in_box, off, dist, ups, ports = _geometry(
        mesh, srcs, dsts)
    occ_sel = occ[:, ports].permute(1, 2, 0)           # (B, 3, n)
    moved = coords.T[None] != sc[:, :, None]           # (B, 3, n)
    vec = torch.full((B, n), fm, dtype=torch.int64, device=srcs.device)
    rows = torch.arange(B, device=srcs.device)
    vec[rows, srcs] = as_i64(init).to(srcs.device) & fm
    for k in range(1, int(dist.max()) + 1 if B else 1):
        acc = torch.full_like(vec, fm)
        for d in range(3):
            u = ups[:, d]
            val = rotr(vec.gather(1, u) | occ_sel[:, d].gather(1, u), n_slots)
            acc = torch.where(moved[:, d], acc & val, acc)
        vec = torch.where(in_box & (off == k), acc, vec)
    return vec


def wavefront_search_packed(occ: torch.Tensor, srcs: torch.Tensor,
                            dsts: torch.Tensor, init: torch.Tensor, *,
                            mesh: Mesh3D, n_slots: int) -> torch.Tensor:
    """Batched search on ``occ``'s device.

    CUDA: launches ``csrc/wavefront_search.cu`` (occ, init and the
    result are int32 bit patterns of packed uint32 words).  CPU: the plain
    version (int64 values)."""
    if not occ.is_cuda:
        return wavefront_search_plain(occ, srcs, dsts, init, mesh=mesh,
                                      n_slots=n_slots)
    occ = check_occ(occ, mesh, n_slots)
    dev = occ.device
    B = int(srcs.shape[0])
    out = torch.empty((B, mesh.n_nodes), dtype=torch.int32, device=dev)
    if B == 0:
        return out
    req = torch.stack([srcs.to(dev, torch.int32), dsts.to(dev, torch.int32),
                       as_i32_bits(init.to(dev))])
    _lib.launch("wavefront_search", dev, occ, req, None, out, None, B,
                mesh.X, mesh.Y, mesh.Z, n_slots)
    return out
