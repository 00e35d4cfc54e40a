"""Slot scoring and the fused per-wave CCU prepare (counterpart of
``repro.kernels.slot_alloc.fused``).

The fused prepare turns a search wave into one launch: wavefront search,
slot scoring, argmin slot choice and a lockstep trace-back of the chosen
arrival slot (``csrc/fused_prepare.cu``).  Everything the host commit
loop needs comes back as two small arrays — ``ints`` (B, 3 + 3L) int32 =
[starts, arr, dists, hop_n[L], hop_p[L], hop_s[L]] with L = max_dist+1,
and ``flags`` (B, 2 + n_slots) = [denied, ok, free[n_slots]] — while the
converged (B, n) vectors stay on the device unless a caller asks for
them (:meth:`FusedPrepare.vecs_np`, extra-slot bundles only).

Slot scoring alone (``csrc/slot_score.cu``) is the counterpart of the
reference's standalone scoring kernel.  As in the reference, the
allocator reaches scoring on the device only inside the fused prepare;
the split pipeline scores on the host (``_best_slots_np``).  Both
kernels score through one ``__device__`` function
(``nom::slot_cost``), in int32: callers keep ``t_ready < 2**31 - 2*n_slots``
(:func:`t_ready_limit`), below which every feasible cost is under
:data:`FAR32` and the argmin equals the host's int64 choice.

Each kernel has its plain PyTorch version here; the wrappers run the
kernel for CUDA tensors and the plain version for CPU tensors.
:func:`fused_prepare_start` launches on a side stream and records a CUDA
event; :func:`fused_prepare_wait` waits on it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.bitvec import (as_i32_bits, as_i64, full_mask,
                                     packed_numpy, packed_tensor)
from repro_torch.core.topology import PORT_LOCAL, Mesh3D
from repro_torch.device import resolve_device

from .. import _lib
from .slot_alloc import (_check_mesh, _geometry, cta_threads,
                         wavefront_search_plain)

__all__ = ["FAR32", "FusedPrepare", "t_ready_limit", "fused_prepare",
           "fused_prepare_packed", "fused_prepare_plain",
           "fused_prepare_start", "fused_prepare_wait", "slot_score",
           "slot_score_plain"]

# int32 "infeasible" sentinel — the host twin (`_best_slots_np`) uses
# int64 2**62; any feasible start cycle is strictly below either, so the
# argmin choice is identical whenever t_ready fits the guard below.
FAR32 = np.int32(2 ** 31 - 1)


def t_ready_limit(n_slots: int) -> int:
    """Exclusive upper bound on ``t_ready`` for the int32 scoring."""
    return 2 ** 31 - 2 * n_slots


# ---------------------------------------------------------------------------
# Slot scoring
# ---------------------------------------------------------------------------
def slot_score_plain(avail: torch.Tensor, dists: torch.Tensor,
                     t_readys: torch.Tensor, n_slots: int) -> torch.Tensor:
    """Plain PyTorch version of the scoring kernel (any device): the
    (B, n_slots) int32 cost matrix of packed availability vectors."""
    a = as_i64(avail)
    d = dists.to(a.device, torch.int64)[:, None]
    t = t_readys.to(a.device, torch.int64)[:, None]
    slots = torch.arange(n_slots, device=a.device)
    free = ((a[:, None] >> slots[None]) & 1) == 0
    s_inj = (slots[None] - d) % n_slots
    c = t + ((s_inj - t) % n_slots)
    return torch.where(free, c, int(FAR32)).to(torch.int32)


def slot_score(avail: torch.Tensor, dists: torch.Tensor,
               t_readys: torch.Tensor, *, n_slots: int) -> torch.Tensor:
    """Score every arrival slot of every row on ``avail``'s device: the
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if not avail.is_cuda:
        return slot_score_plain(avail, dists, t_readys, n_slots)
    full_mask(n_slots)                      # validates 0 < n_slots <= 32
    dev = avail.device
    B = int(avail.shape[0])
    cost = torch.empty((B, n_slots), dtype=torch.int32, device=dev)
    if B == 0:
        return cost
    _lib.launch("slot_score", dev, as_i32_bits(avail).contiguous(),
                dists.to(dev, torch.int32).contiguous(),
                t_readys.to(dev, torch.int32).contiguous(), cost, B, n_slots)
    return cost


# ---------------------------------------------------------------------------
# The fused prepare
# ---------------------------------------------------------------------------
def fused_prepare_plain(occ: torch.Tensor, srcs: torch.Tensor,
                        dsts: torch.Tensor, t_readys: torch.Tensor, *,
                        mesh: Mesh3D, n_slots: int):
    """Plain PyTorch version of the fused kernel (any device): search,
    scoring, argmin and the lockstep trace-back with the kernel's (and
    the reference scan's) exact step semantics.  Returns ``(ints, flags,
    vecs)``: int32, uint8 and int64 packed vectors."""
    srcs, dsts = srcs.to(torch.int64), dsts.to(torch.int64)
    occ = as_i64(occ)
    dev = srcs.device
    B = srcs.shape[0]
    vecs = wavefront_search_plain(
        occ, srcs, dsts, torch.zeros(B, dtype=torch.int64, device=dev),
        mesh=mesh, n_slots=n_slots)
    coords, sc, sign, _in_box, _off, dist, _ups, ports = _geometry(
        mesh, srcs, dsts)
    rows = torch.arange(B, device=dev)
    avail = vecs[rows, dsts] | occ[dsts, PORT_LOCAL]
    cost = slot_score_plain(avail, dist, t_readys.to(dev), n_slots)
    arr = cost.argmin(1) if B else torch.zeros(0, dtype=torch.int64,
                                                device=dev)
    starts = cost[rows, arr]
    free = cost != int(FAR32)
    denied = ~free.any(1)
    L = mesh.max_dist + 1
    hop_n = torch.zeros((B, L), dtype=torch.int64, device=dev)
    hop_p = torch.zeros_like(hop_n)
    hop_s = torch.zeros_like(hop_n)
    hop_n[rows, dist] = dsts
    hop_p[rows, dist] = PORT_LOCAL
    hop_s[rows, dist] = arr
    strides = torch.tensor([1, mesh.X, mesh.X * mesh.Y], device=dev)
    v, j = dsts.clone(), arr.clone()
    active = v != srcs
    ok = torch.ones(B, dtype=torch.bool, device=dev)
    for step in range(int(dist.max()) if B else 0):
        jp = (j - 1) % n_slots
        u = (v[:, None] - sign * strides).clamp(0, mesh.n_nodes - 1)
        valid = (sign != 0) & (coords[v] != sc)
        busy = vecs.gather(1, u) | occ[u, ports]
        cand = valid & (((busy >> jp[:, None]) & 1) == 0)
        has = cand.any(1)
        d = cand.to(torch.int8).argmax(1)      # first free dim: x -> y -> z
        move = active & has
        ok &= ~(active & ~has)
        v2 = torch.where(move, u[rows, d], v)
        w = step < dist
        pos = (dist - 1 - step)[w]
        hop_n[rows[w], pos] = v2[w]
        hop_p[rows[w], pos] = ports[rows, d][w]
        hop_s[rows[w], pos] = jp[w]
        j = torch.where(move, jp, j)
        active = move & (v2 != srcs)
        v = v2
    ints = torch.cat([starts[:, None].to(torch.int64), arr[:, None],
                      dist[:, None], hop_n, hop_p, hop_s], 1).to(torch.int32)
    flags = torch.cat([denied[:, None], ok[:, None], free], 1).to(torch.uint8)
    return ints, flags, vecs


def fused_prepare_packed(occ: torch.Tensor, srcs: torch.Tensor,
                         dsts: torch.Tensor, t_readys: torch.Tensor, *,
                         mesh: Mesh3D, n_slots: int):
    """One wave's prepare on ``occ``'s device: the fused kernel for CUDA
    tensors (``vecs`` as int32 bit patterns), the plain version for CPU
    tensors.  Returns ``(ints, flags, vecs)``."""
    if not occ.is_cuda:
        return fused_prepare_plain(occ, srcs, dsts, t_readys, mesh=mesh,
                                   n_slots=n_slots)
    _check_mesh(mesh, n_slots)
    dev = occ.device
    if tuple(occ.shape) != (mesh.n_nodes, 7):
        raise ValueError(f"occ must be ({mesh.n_nodes}, 7), got "
                         f"{tuple(occ.shape)}")
    B = int(srcs.shape[0])
    L = mesh.max_dist + 1
    ints = torch.empty((B, 3 + 3 * L), dtype=torch.int32, device=dev)
    flags = torch.empty((B, 2 + n_slots), dtype=torch.uint8, device=dev)
    vecs = torch.empty((B, mesh.n_nodes), dtype=torch.int32, device=dev)
    if B == 0:
        return ints, flags, vecs
    _lib.launch("fused_prepare", dev, as_i32_bits(occ).contiguous(),
                srcs.to(dev, torch.int32).contiguous(),
                dsts.to(dev, torch.int32).contiguous(),
                t_readys.to(dev, torch.int32).contiguous(), ints, flags, vecs,
                B, mesh.X, mesh.Y, mesh.Z, n_slots,
                cta_threads(mesh.n_nodes))
    return ints, flags, vecs


@dataclasses.dataclass
class FusedPrepare:
    """Host-side view of one fused wave: small numpy arrays; the (B, n)
    vectors stay on the device until :meth:`vecs_np` is called
    (extra-slot bundles only)."""
    starts: np.ndarray        # (B,) int32 chosen start cycles
    arr: np.ndarray           # (B,) int32 chosen arrival slots
    denied: np.ndarray        # (B,) bool — no free arrival slot
    free: np.ndarray          # (B, n_slots) bool
    hop_n: np.ndarray         # (B, max_dist+1) int32 forward hop nodes
    hop_p: np.ndarray         # (B, max_dist+1) int32 forward hop ports
    hop_s: np.ndarray         # (B, max_dist+1) int32 forward hop slots
    ok: np.ndarray            # (B,) bool — trace-back reached the source
    dists: np.ndarray         # (B,) int32 manhattan distances
    _vecs_dev: torch.Tensor | None = dataclasses.field(repr=False,
                                                       default=None)
    _batch: int = 0

    def vecs_np(self) -> np.ndarray:
        """(B, n) uint32 converged busy vectors (device pull, lazy)."""
        return packed_numpy(self._vecs_dev)[:self._batch]


@dataclasses.dataclass
class _Token:
    ints: torch.Tensor        # host (pinned on CUDA) once the event fires
    flags: torch.Tensor
    vecs: torch.Tensor        # stays on the device
    event: torch.cuda.Event | None
    batch: int
    mesh: Mesh3D


def fused_prepare_start(occ, srcs, dsts, t_readys, *, mesh: Mesh3D,
                        n_slots: int, device="cuda",
                        stream: torch.cuda.Stream | None = None) -> _Token:
    """Launch one wave's fused prepare without blocking.

    ``occ`` is the device occupancy tensor
    (``SlotTable.device_busy_masks``) or host uint32 masks (uploaded to
    ``device``); ``srcs``/``dsts``/``t_readys`` are host arrays, and
    ``t_readys`` must stay below :func:`t_ready_limit`.  On CUDA the
    launch and the pull of ``ints``/``flags`` into pinned host memory go
    on ``stream`` (a side stream that first waits for the current one),
    closed by a recorded event: the host overlaps its bookkeeping with
    the device until :func:`fused_prepare_wait`."""
    if isinstance(occ, torch.Tensor):
        dev = occ.device
    else:
        dev = resolve_device(device)
        occ = packed_tensor(occ, dev)
    t = np.asarray(t_readys, np.int64)
    if t.size and int(t.max()) >= t_ready_limit(n_slots):
        raise ValueError(f"t_ready {int(t.max())} overflows the int32 slot "
                         f"scoring (limit {t_ready_limit(n_slots)})")
    req = torch.from_numpy(np.stack([np.asarray(srcs, np.int64),
                                     np.asarray(dsts, np.int64), t])
                           .astype(np.int32))
    B = req.shape[1]
    if dev.type != "cuda":
        ints, flags, vecs = fused_prepare_plain(
            occ, req[0], req[1], req[2], mesh=mesh, n_slots=n_slots)
        return _Token(ints, flags, vecs, None, B, mesh)
    side = stream if stream is not None else torch.cuda.current_stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    occ.record_stream(side)
    with torch.cuda.stream(side):
        req_d = req.to(dev)
        ints, flags, vecs = fused_prepare_packed(
            occ, req_d[0], req_d[1], req_d[2], mesh=mesh, n_slots=n_slots)
        ints_h = torch.empty(ints.shape, dtype=ints.dtype, pin_memory=True)
        flags_h = torch.empty(flags.shape, dtype=flags.dtype,
                              pin_memory=True)
        ints_h.copy_(ints, non_blocking=True)
        flags_h.copy_(flags, non_blocking=True)
        event = torch.cuda.Event()
        event.record(side)
    return _Token(ints_h, flags_h, vecs, event, B, mesh)


def fused_prepare_wait(token: _Token) -> FusedPrepare:
    """Wait for a :func:`fused_prepare_start` token and unpack it."""
    if token.event is not None:
        token.event.synchronize()
    # Copies, so the pinned buffers return to the host allocator's cache
    # now rather than living on in the commit's expiry buckets.
    ints = token.ints.numpy().copy()
    flags = token.flags.numpy().astype(bool)
    L = token.mesh.max_dist + 1
    return FusedPrepare(
        starts=ints[:, 0], arr=ints[:, 1],
        denied=flags[:, 0], free=flags[:, 2:],
        hop_n=ints[:, 3:3 + L], hop_p=ints[:, 3 + L:3 + 2 * L],
        hop_s=ints[:, 3 + 2 * L:3 + 3 * L], ok=flags[:, 1],
        dists=ints[:, 2], _vecs_dev=token.vecs, _batch=token.batch)


def fused_prepare(occ, srcs, dsts, t_readys, *, mesh: Mesh3D, n_slots: int,
                  device="cuda") -> FusedPrepare:
    """Run one wave's fused prepare and pull the host-side outputs."""
    return fused_prepare_wait(fused_prepare_start(
        occ, srcs, dsts, t_readys, mesh=mesh, n_slots=n_slots,
        device=device))
