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
event; :func:`fused_prepare_wait` waits on it.  On the card a wave is
one upload of the packed request words [srcs | dsts | t_ready], one
launch and one pull of the packed result words (ints, then flags as
bytes: :func:`result_words`) into a reused pinned buffer; the CPU path
packs the plain version's outputs the same way, so both unpack alike.
"""
from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from repro_torch.core.bitvec import (as_i32_bits, as_i64, full_mask,
                                     packed_numpy, packed_tensor)
from repro_torch.core.topology import PORT_LOCAL, Mesh3D
from repro_torch.device import resolve_device

from .. import _lib
from .slot_alloc import (Staging, _geometry, check_occ, give_staging,
                         take_staging, wavefront_search_plain)

__all__ = ["FAR32", "FusedPrepare", "t_ready_limit", "result_words",
           "fused_prepare",
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


def result_words(batch: int, mesh: Mesh3D, n_slots: int) -> int:
    """int32 words of one wave's packed result: ints (B, 3 + 3L), then
    flags (B, 2 + n_slots) as bytes, padded to a whole word."""
    L = mesh.max_dist + 1
    return batch * (3 + 3 * L) + -(-batch * (2 + n_slots) // 4)


def _split_result(words, batch: int, mesh: Mesh3D, n_slots: int):
    """(ints, flags) views of packed result words (numpy or tensor)."""
    width = 3 + 3 * (mesh.max_dist + 1)
    flags = words[batch * width:].view(
        np.uint8 if isinstance(words, np.ndarray) else torch.uint8)
    return (words[:batch * width].reshape(batch, width),
            flags[:batch * (2 + n_slots)].reshape(batch, 2 + n_slots))


def fused_prepare_packed(occ: torch.Tensor, srcs: torch.Tensor,
                         dsts: torch.Tensor, t_readys: torch.Tensor, *,
                         mesh: Mesh3D, n_slots: int):
    """One wave's prepare on ``occ``'s device: the fused kernel for CUDA
    tensors (``vecs`` as int32 bit patterns), the plain version for CPU
    tensors.  Returns ``(ints, flags, vecs)``."""
    if not occ.is_cuda:
        return fused_prepare_plain(occ, srcs, dsts, t_readys, mesh=mesh,
                                   n_slots=n_slots)
    occ = check_occ(occ, mesh, n_slots)
    dev = occ.device
    B = int(srcs.shape[0])
    res = torch.empty(result_words(B, mesh, n_slots), dtype=torch.int32,
                      device=dev)
    vecs = torch.empty((B, mesh.n_nodes), dtype=torch.int32, device=dev)
    if B:
        req = torch.stack([x.to(dev, torch.int32)
                           for x in (srcs, dsts, t_readys)])
        _lib.launch("fused_prepare", dev, occ, req, None, res, None, vecs, B,
                    mesh.X, mesh.Y, mesh.Z, n_slots)
    ints, flags = _split_result(res, B, mesh, n_slots)
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


@dataclasses.dataclass(eq=False)
class _Token:
    words: np.ndarray | None  # packed result (CPU), or None until waited
    staging: Staging | None   # the wave's buffers (CUDA) until waited
    vecs: torch.Tensor | None  # the (B, n) vectors (CPU), or None
    batch: int
    mesh: Mesh3D
    n_slots: int
    release: weakref.finalize | None = None
    waited: FusedPrepare | None = None


def fused_prepare_start(occ, srcs, dsts, t_readys, *, mesh: Mesh3D,
                        n_slots: int, device="cuda",
                        stream: torch.cuda.Stream | None = None) -> _Token:
    """Launch one wave's fused prepare without blocking.

    ``occ`` is the device occupancy tensor
    (``SlotTable.device_busy_masks``) or host uint32 masks (uploaded to
    ``device``); ``srcs``/``dsts``/``t_readys`` are host arrays, and
    ``t_readys`` must stay below :func:`t_ready_limit`.  On CUDA the
    request upload, the launch and the pull of the result words into
    pinned host memory go on ``stream`` (a side stream that first waits
    for the current one), closed by a recorded event: the host overlaps
    its bookkeeping with the device until :func:`fused_prepare_wait`.
    The kernel writes the (B, n) vectors into the staging buffer too, so
    the buffer goes back to its pool only when the :class:`FusedPrepare`
    that can read them is gone (or the token is dropped unwaited)."""
    if isinstance(occ, torch.Tensor):
        dev = occ.device
    else:
        dev = resolve_device(device)
        occ = packed_tensor(occ, dev)
    t = np.asarray(t_readys, np.int64)
    if t.size and int(t.max()) >= t_ready_limit(n_slots):
        raise ValueError(f"t_ready {int(t.max())} overflows the int32 slot "
                         f"scoring (limit {t_ready_limit(n_slots)})")
    B = len(t)
    if dev.type != "cuda" or B == 0:
        req = torch.from_numpy(np.stack([np.asarray(srcs, np.int64).reshape(B),
                                         np.asarray(dsts, np.int64).reshape(B),
                                         t]).astype(np.int32)).to(dev)
        ints, flags, vecs = fused_prepare_packed(
            occ, req[0], req[1], req[2], mesh=mesh, n_slots=n_slots)
        words = np.zeros(result_words(B, mesh, n_slots), np.int32)
        w_ints, w_flags = _split_result(words, B, mesh, n_slots)
        w_ints[:] = ints.cpu().numpy()
        w_flags[:] = flags.cpu().numpy()
        return _Token(words, None, vecs, B, mesh, n_slots)
    occ = check_occ(occ, mesh, n_slots)
    R = result_words(B, mesh, n_slots)
    st = take_staging(dev, 3 * B + R + B * mesh.n_nodes)
    current = torch.cuda.current_stream(dev)
    side = stream if stream is not None else current
    if side != current:     # the kernel reads occ after the caller's work
        st.ready.record(current)
        side.wait_event(st.ready)
        occ.record_stream(side)
    h = st.host_np
    h[:B] = srcs
    h[B:2 * B] = dsts
    h[2 * B:3 * B] = t
    dev_ptr, host_ptr = st.dev.data_ptr(), st.host.data_ptr()
    _lib.launch("fused_prepare", dev, occ, st.dev, st.host,
                dev_ptr + 12 * B, host_ptr + 12 * B, dev_ptr + 4 * (3 * B + R),
                B, mesh.X, mesh.Y, mesh.Z, n_slots, stream=side)
    st.event.record(side)
    token = _Token(None, st, None, B, mesh, n_slots)
    token.release = weakref.finalize(token, give_staging, st)
    token.release.atexit = False
    return token


def fused_prepare_wait(token: _Token) -> FusedPrepare:
    """Wait for a :func:`fused_prepare_start` token and unpack it (the
    same :class:`FusedPrepare` on every call)."""
    if token.waited is not None:
        return token.waited
    B, mesh, n_slots = token.batch, token.mesh, token.n_slots
    R = result_words(B, mesh, n_slots)
    st, vecs, words = token.staging, token.vecs, token.words
    if st is not None:
        st.event.synchronize()
        words = st.host_np[3 * B:3 * B + R].copy()
        vecs = st.dev[3 * B + R:3 * B + R + B * mesh.n_nodes].view(
            B, mesh.n_nodes)
    ints, flags = _split_result(words, B, mesh, n_slots)
    flags = flags.astype(bool)
    L = mesh.max_dist + 1
    fp = FusedPrepare(
        starts=ints[:, 0], arr=ints[:, 1],
        denied=flags[:, 0], free=flags[:, 2:],
        hop_n=ints[:, 3:3 + L], hop_p=ints[:, 3 + L:3 + 2 * L],
        hop_s=ints[:, 3 + 2 * L:3 + 3 * L], ok=flags[:, 1],
        dists=ints[:, 2], _vecs_dev=vecs, _batch=B)
    if st is not None:      # the buffers now live as long as fp
        token.release.detach()
        weakref.finalize(fp, give_staging, st).atexit = False
        token.staging = None
    token.waited = fp
    return fp


def fused_prepare(occ, srcs, dsts, t_readys, *, mesh: Mesh3D, n_slots: int,
                  device="cuda") -> FusedPrepare:
    """Run one wave's fused prepare and pull the host-side outputs."""
    return fused_prepare_wait(fused_prepare_start(
        occ, srcs, dsts, t_readys, mesh=mesh, n_slots=n_slots,
        device=device))
