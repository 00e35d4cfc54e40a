"""TDM slot allocation — the paper's core algorithm (Section 2.1); port
of ``repro.core.slot_alloc``.

The CCU services copy requests by finding a *circuit*: a sequence of
increasingly-numbered TDM slots along a shortest path, so data advances one
hop per cycle with no buffering/arbitration.  The paper implements the
search with a matrix of PEs (one per router) that propagate an n-bit busy
vector along all shortest paths: at each PE the vector is OR-ed with the
output-port occupancy and rotated right (slot j upstream -> slot j+1 here);
zero bits surviving at the destination are feasible circuits.

Implementation layout (mirrors the hardware split):

* :func:`wavefront_search_batch` — the PE-matrix accelerator: the CUDA
  kernel in ``repro_torch.kernels.slot_alloc`` for device tensors, its
  plain PyTorch version on the CPU.
* :class:`SlotTable` — the CCU's occupancy bookkeeping (host-side numpy):
  per (router, port, slot) reservation expiry in TDM-window units, with
  *incrementally maintained* packed busy masks (reservations set bits
  eagerly, an expiry-bucket map clears them lazily as the query window
  advances) and a version-keyed device tensor copy for the kernels.
* :func:`traceback` / :func:`traceback_batch` — walk the converged
  vectors backwards to extract the hop lists, as the paper's "tracing
  back the path towards the source PE"; the batch variant steps every
  requested (request, arrival-slot) job in lockstep with vectorized
  per-dimension upstream selection.

Slot/cycle accounting (paper Fig. 2): a circuit of distance D injected at
source slot ``s`` uses slot ``s+i (mod n)`` at the i-th router on the path
and ejects through the destination's LOCAL port at slot ``s+D (mod n)`` —
e.g. 5 routers / slots 3..7 for the A->B example.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device

from .bitvec import bit_is_free, full_mask, packed_tensor, rotr_np
from .topology import (Mesh3D, N_PORTS, PORT_LOCAL, StackedTopology,
                       port_for)


# ---------------------------------------------------------------------------
# The PE-matrix search (the CUDA kernel on the card, plain PyTorch on CPU)
# ---------------------------------------------------------------------------
def wavefront_search_batch(occ, srcs, dsts, init_vecs, *, mesh: Mesh3D,
                           n_slots: int, device="cuda") -> torch.Tensor:
    """Propagate busy-vectors from each ``srcs[b]`` to every node of the
    shortest-path lattice toward ``dsts[b]`` (one occupancy state shared
    by the batch — the CCU searches concurrent requests in parallel).

    Args:
      occ: (n_nodes, N_PORTS) packed uint32 busy masks per output port
        (host array, or a device tensor such as
        :meth:`SlotTable.device_busy_masks`).
      srcs, dsts: (B,) node ids.
      init_vecs: (B,) uint32 initial busy vector at each source (0 for a
        fresh search; non-zero when composing multi-phase NoM-Light
        routes).

    Returns:
      (B, n_nodes) packed busy vectors on the device (see
      :func:`~repro_torch.core.bitvec.packed_numpy`): converged per node,
      indexed by the slot at which that node's *output* crossbar would be
      used; out-of-lattice nodes hold the all-busy mask.  ``vec[dst] |
      occ[dst, LOCAL]`` is the availability vector of arrival slots.
    """
    from repro_torch.kernels.slot_alloc.ops import \
        wavefront_search_kernel_batch
    return wavefront_search_kernel_batch(occ, srcs, dsts, init_vecs,
                                         mesh=mesh, n_slots=n_slots,
                                         device=device)


def wavefront_search(occ, src: int, dst: int, init_vec: int, *,
                     mesh: Mesh3D, n_slots: int,
                     device="cuda") -> torch.Tensor:
    """Single-request :func:`wavefront_search_batch`: (n_nodes,) vectors."""
    return wavefront_search_batch(
        occ, np.asarray([int(src)]), np.asarray([int(dst)]),
        np.asarray([int(init_vec)], np.uint32), mesh=mesh, n_slots=n_slots,
        device=device)[0]


# At/below this batch the host evaluation wins.  This split (and the
# int32 guard in TdmAllocator._fused_eligible) is the reference's own
# semantics, not a fallback: telemetry's fused_waves / host_waves must
# match the reference's.
_SMALL_SEARCH = 8


# offset enumeration of a shortest-path box, keyed by its spans — shared
# across calls/instances (the box geometry is position-independent).
_BOX_OFFSETS: dict[tuple[int, int, int], list] = {}


def _wavefront_host(occ: np.ndarray, mesh: Mesh3D, n_slots: int, src: int,
                    dst: int, init_vec: int) -> np.ndarray:
    """Scalar twin of :func:`wavefront_search_batch` for tiny batches.

    The shortest-path lattice is a DAG ordered by distance from the
    source, so one pass in topological (upstream-first) order computes
    the exact fixpoint the accelerator reaches after ``max_dist`` sweeps
    — bit-identical, without a device round-trip.  Used for
    conflict-scoped re-search rounds and small serial batches, where the
    dispatch overhead of the vectorized path dwarfs its compute.
    """
    fm = full_mask(n_slots)
    vec = np.full(mesh.n_nodes, fm, np.uint32)
    vec[src] = np.uint32(init_vec & fm)
    if src == dst:
        return vec
    coords = mesh.coord_array
    sx, sy, sz = (int(c) for c in coords[src])
    dx, dy, dz = (int(c) for c in coords[dst])
    spans = (abs(dx - sx), abs(dy - sy), abs(dz - sz))
    sgn = (1 if dx >= sx else -1, 1 if dy >= sy else -1,
           1 if dz >= sz else -1)
    strides = (1, mesh.X, mesh.X * mesh.Y)
    step = tuple(sgn[d] * strides[d] for d in range(3))
    ports = tuple(2 * d + (1 if sgn[d] < 0 else 0) for d in range(3))
    n1 = n_slots - 1
    offsets = _BOX_OFFSETS.get(spans)
    if offsets is None:
        offsets = sorted(
            ((ox, oy, oz) for ox in range(spans[0] + 1)
             for oy in range(spans[1] + 1) for oz in range(spans[2] + 1)
             if ox or oy or oz), key=lambda o: o[0] + o[1] + o[2])
        _BOX_OFFSETS[spans] = offsets
    vals = {src: int(init_vec) & fm}
    nodes, out = [], []
    for off in offsets:
        v = src + off[0] * step[0] + off[1] * step[1] + off[2] * step[2]
        acc = fm
        first = True
        for d in range(3):
            if not off[d]:
                continue
            u = v - step[d]
            val = vals[u] | int(occ[u, ports[d]])
            val = ((val << 1) | (val >> n1)) & fm
            acc = val if first else acc & val
            first = False
        vals[v] = acc
        nodes.append(v)
        out.append(acc)
    vec[nodes] = out
    return vec


# ---------------------------------------------------------------------------
# Host-side CCU bookkeeping
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Circuit:
    """A reserved circuit: ``hops[i] = (node, out_port, slot)`` in forward
    order; the last hop is (dst, PORT_LOCAL, arrival_slot)."""
    src: int
    dst: int
    start_cycle: int          # absolute cycle of source injection
    n_windows: int            # TDM windows the reservation persists
    hops: list[tuple[int, int, int]]
    slots_per_window: int = 1
    uses_bus: bool = False    # NoM-Light vertical bus hop present
    bus_column: int = -1      # (x, y) column whose TSV the bus hop rides
    distance: int = 0         # hops traversed by one beat (src -> dst)

    @property
    def arrival_cycle(self) -> int:
        return self.start_cycle + self.distance

    @property
    def end_cycle(self) -> int:
        """Cycle at which the last beat has arrived at the destination."""
        return self.arrival_cycle + (self.n_windows - 1) * self._n_slots_hint

    _n_slots_hint: int = 16
    # Compute-class fan-in (op="reduce"): the N source banks whose
    # operands this circuit merges at ``dst``.  ``hops`` then holds every
    # per-source route (in source order — the fixed summation tree) plus
    # the ALU-dwell slots on the destination's LOCAL port; ``src`` mirrors
    # ``srcs[0]``; ``distance`` spans injection of the first beat to
    # arrival of the last operand.  Empty for copy/init circuits.
    srcs: tuple = ()


class _PackedExpiry:
    """Expiry table with incrementally maintained packed busy masks.

    ``expiry[*prefix, slot]`` is the TDM window until which the slot is
    reserved (exclusive).  ``masks_at(w)`` returns the packed uint32 busy
    masks (bit s set iff ``expiry[..., s] > w``) *without* recomputing the
    full reduction each call: reservations set bits eagerly, and an
    expiry-bucket map clears them lazily as the query window advances.
    A backward window jump (rare: re-anchored benchmarks/tests) falls back
    to a from-scratch rebuild.  ``version`` bumps on every mask change —
    the device-resident occupancy re-uploads only when it moved.
    """

    def __init__(self, prefix_shape: tuple[int, ...], n_slots: int):
        self.n_slots = n_slots
        self.expiry = np.zeros((*prefix_shape, n_slots), np.int64)
        self.masks = np.zeros(prefix_shape, np.uint32)
        self.window = 0                     # the window `masks` is valid for
        self._weights = np.uint32(1) << np.arange(n_slots, dtype=np.uint32)
        self._buckets: dict[int, list] = {}  # until -> [tuple of idx arrays]
        self.version = 0

    def _recompute(self, window: int) -> None:
        live = self.expiry > window
        self.masks = (live * self._weights).sum(-1, dtype=np.uint64) \
            .astype(np.uint32)
        idx = np.nonzero(live)
        untils = self.expiry[idx]
        self._buckets = {}
        for u in np.unique(untils).tolist():
            m = untils == u
            self._buckets[int(u)] = [tuple(a[m] for a in idx)]
        self.window = window
        self.version += 1

    def masks_at(self, window: int) -> np.ndarray:
        """Packed busy masks as of ``window`` (the live cache — callers
        must treat the returned array as read-only)."""
        if window == self.window:
            return self.masks
        if window < self.window:
            self._recompute(window)
            return self.masks
        changed = False
        for u in [u for u in self._buckets if u <= window]:
            for idx in self._buckets.pop(u):
                still = self.expiry[idx] <= window
                if not still.any():      # re-reserved: lives in a later bucket
                    continue
                pidx = tuple(a[still] for a in idx[:-1])
                np.bitwise_and.at(self.masks, pidx,
                                  ~self._weights[idx[-1][still]])
                changed = True
        self.window = window
        if changed:
            self.version += 1
        return self.masks

    def reserve_arrays(self, idx: tuple[np.ndarray, ...], until: int,
                       unique: bool = False) -> None:
        """Reserve every ``(*prefix, slot)`` in the index arrays until
        ``until`` (exclusive), keeping the packed masks in sync.

        ``unique=True`` asserts the prefix tuples are pairwise distinct
        (true for a single-slot circuit: one hop per node), allowing the
        buffered fancy ``|=`` instead of ``np.bitwise_or.at``."""
        self.expiry[idx] = until
        if until > self.window:
            if unique:
                self.masks[idx[:-1]] |= self._weights[idx[-1]]
            else:
                np.bitwise_or.at(self.masks, idx[:-1],
                                 self._weights[idx[-1]])
        self._buckets.setdefault(int(until), []).append(idx)
        self.version += 1

    def reserve_run(self, idxs: list, cat: tuple[np.ndarray, ...],
                    untils: list[int]) -> None:
        """Batch spelling of :meth:`reserve_arrays` for a *run* of
        reservations whose full ``(*prefix, slot)`` entries are pairwise
        distinct across the whole run (the pending-run commit).  ``cat``
        is the pre-concatenated index tuple of every entry in ``idxs``;
        ``untils`` is per-reservation.  Prefix tuples may still repeat
        (two circuits on the same link at different slots), in which case
        the buffered fancy ``|=`` would drop bits — detect and fall back
        to ``np.bitwise_or.at``."""
        reps = np.fromiter((len(ix[-1]) for ix in idxs), np.int64,
                           len(idxs))
        u = np.repeat(np.asarray(untils, np.int64), reps)
        self.expiry[cat] = u
        live = u > self.window
        flat = cat[0]
        for d, c in enumerate(cat[1:-1], 1):
            flat = flat * self.expiry.shape[d] + c
        if live.all() and np.unique(flat).size == flat.size:
            self.masks[cat[:-1]] |= self._weights[cat[-1]]
        else:
            np.bitwise_or.at(self.masks, tuple(c[live] for c in cat[:-1]),
                             self._weights[cat[-1][live]])
        for ix, until in zip(idxs, untils):
            self._buckets.setdefault(int(until), []).append(ix)
        self.version += 1

    def reserve_flat(self, ent: np.ndarray, until_ent: np.ndarray,
                     idx_untils: list) -> None:
        """Flat-index spelling of :meth:`reserve_run` for the fused wave
        commit: ``ent`` holds raveled ``(*prefix, slot)`` entry ids
        (pairwise distinct across the run), ``until_ent`` the per-entry
        expiry, ``idx_untils`` the ``(idx_tuple, until)`` pairs for the
        lazy-expiry bucket bookkeeping.  Prefixes may repeat (two
        circuits on one link at different slots) — detected, falling
        back to ``np.bitwise_or.at``."""
        self.expiry.reshape(-1)[ent] = until_ent
        live = until_ent > self.window
        if not live.all():  # pragma: no cover - hot path reserves ahead
            ent = ent[live]
        # Entries are pairwise distinct, so each (prefix, slot) bit is
        # contributed at most once — summing the single-bit weights per
        # prefix (bincount) IS their bitwise OR, with no dup-prefix
        # detection needed.
        mf = self.masks.reshape(-1)
        mf |= np.bincount(ent // self.n_slots,
                          weights=self._weights[ent % self.n_slots],
                          minlength=mf.size).astype(np.uint32)
        for ix, until in idx_untils:
            self._buckets.setdefault(until, []).append(ix)
        self.version += 1

    def release_arrays(self, idx: tuple[np.ndarray, ...],
                       prev: np.ndarray) -> None:
        """Roll back a :meth:`reserve_arrays` call: restore the exact prior
        expiries ``prev`` (captured before reserving) for ``idx`` and
        rebuild masks + buckets.  This is the two-phase commit abort path
        (cross-stack far-side conflict) — rollbacks are rare, so a full
        rebuild is cheaper than keeping an undo log in the hot path."""
        self.expiry[idx] = prev
        self._recompute(self.window)


class SlotTable:
    """Occupancy state of every router port (and NoM-Light vertical buses).

    ``expiry[node, port, slot]`` is the TDM-window index until which the slot
    is reserved (exclusive).  A slot is busy for a search anchored at window
    ``w`` iff ``expiry > w`` — conservative for circuits that would start
    after an existing reservation expires, which matches the paper's CCU (it
    services requests in FIFO order against current state).

    The packed busy masks are maintained *incrementally* (bits set on
    ``reserve``, cleared lazily as the query window advances past each
    reservation's expiry — see :class:`_PackedExpiry`) and mirrored into a
    device tensor (:meth:`device_busy_masks`) that the kernels consume
    without a host->device upload per pass.
    """

    def __init__(self, mesh: Mesh3D, n_slots: int = 16, device="cuda"):
        self.mesh = mesh
        self.n_slots = n_slots
        self.device = resolve_device(device)
        self._ports = _PackedExpiry((mesh.n_nodes, N_PORTS), n_slots)
        # One vertical bus resource per (x, y) column (NoM-Light).
        self._bus = _PackedExpiry((mesh.X * mesh.Y,), n_slots)
        self._dev: torch.Tensor | None = None
        self._dev_version = -1

    @classmethod
    def from_expiry(cls, mesh: Mesh3D, expiry: np.ndarray,
                    bus_expiry: np.ndarray, *, window: int = 0,
                    device="cuda") -> "SlotTable":
        """A table holding the given reservations: ``expiry`` (n_nodes,
        N_PORTS, n_slots) and ``bus_expiry`` (X*Y, n_slots) window
        indices — e.g. the reference ``repro.core.slot_alloc.SlotTable``'s
        arrays, so both packages start from the same occupied mesh.  The
        packed masks are rebuilt as of ``window``."""
        expiry = np.asarray(expiry, np.int64)
        n_slots = expiry.shape[-1]
        if expiry.shape != (mesh.n_nodes, N_PORTS, n_slots):
            raise ValueError(f"expiry shape {expiry.shape} does not match "
                             f"the mesh ({mesh.n_nodes}, {N_PORTS}, n_slots)")
        bus_expiry = np.asarray(bus_expiry, np.int64)
        if bus_expiry.shape != (mesh.X * mesh.Y, n_slots):
            raise ValueError(f"bus_expiry shape {bus_expiry.shape} does not "
                             f"match ({mesh.X * mesh.Y}, {n_slots})")
        table = cls(mesh, n_slots, device=device)
        for pe, arr in ((table._ports, expiry), (table._bus, bus_expiry)):
            pe.expiry[...] = arr
            pe._recompute(window)
        return table

    # The underlying expiry arrays stay addressable under their original
    # names (tests and telemetry read them directly).
    @property
    def expiry(self) -> np.ndarray:
        return self._ports.expiry

    @property
    def bus_expiry(self) -> np.ndarray:
        return self._bus.expiry

    # -- masks ---------------------------------------------------------------
    def busy_masks(self, window: int) -> np.ndarray:
        """(n_nodes, N_PORTS) uint32 busy masks as of TDM window `window`."""
        return self._ports.masks_at(window).copy()

    def bus_busy_masks(self, window: int) -> np.ndarray:
        return self._bus.masks_at(window).copy()

    def device_busy_masks(self, window: int) -> torch.Tensor:
        """Device twin of :meth:`busy_masks`: an (n_nodes, N_PORTS) tensor
        on the table's device (int32 bit patterns on CUDA, int64 values
        on the CPU — see :func:`~repro_torch.core.bitvec.packed_tensor`).

        The occupancy stays on the device across search rounds and is
        re-uploaded only when the incremental cache's version moved (every
        reserve, release and expiry bumps it, so a stale copy is never
        served) — a run of searches against an unchanged table pays no
        host->device transfer.  (At this table size — a few KB — one full
        upload beats a scatter of the changed rows.)"""
        masks = self._ports.masks_at(window)
        if self._dev is None or self._dev_version != self._ports.version:
            self._dev = packed_tensor(masks, self.device)
            self._dev_version = self._ports.version
        return self._dev

    # -- validation -----------------------------------------------------------
    def can_reserve(self, hops: list[tuple[int, int, int]],
                    window: int) -> bool:
        """True iff every (node, port, slot) in ``hops`` is free as of
        ``window`` and the hop list itself is internally disjoint — the
        batched scheduler's commit check against circuits reserved after
        the search snapshot was taken."""
        seen: set[tuple[int, int, int]] = set()
        expiry = self._ports.expiry
        for hop in hops:
            node, port, slot = hop
            if hop in seen or expiry[node, port, slot] > window:
                return False
            seen.add(hop)
        return True

    def can_reserve_bus(self, column: int, slot: int, window: int) -> bool:
        return bool(self._bus.expiry[column, slot] <= window)

    # -- reservation ----------------------------------------------------------
    @staticmethod
    def _hops_idx(hops) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        h = np.asarray(hops, np.int64).reshape(-1, 3)
        return h[:, 0], h[:, 1], h[:, 2]

    def reserve(self, circuit: Circuit, window: int) -> None:
        idx = self._hops_idx(circuit.hops)
        if not ((self.expiry[idx] <= window).all()
                and len(circuit.hops) == len(set(circuit.hops))):
            raise RuntimeError("double booking")
        self._ports.reserve_arrays(idx, window + circuit.n_windows)

    def reserve_bus(self, column: int, slot: int, window: int,
                    n_windows: int) -> None:
        if self._bus.expiry[column, slot] > window:
            raise RuntimeError("bus double booking")
        self._bus.reserve_arrays((np.asarray([column]), np.asarray([slot])),
                                 window + n_windows)

    def utilization(self, window: int) -> float:
        return float((self.expiry > window).mean())


# ---------------------------------------------------------------------------
# Trace-back (paper: "reserved by tracing back the path towards the source")
# ---------------------------------------------------------------------------
def traceback(vec: np.ndarray, occ: np.ndarray, mesh: Mesh3D, n_slots: int,
              src: int, dst: int, arrival_slot: int) -> list[tuple[int, int, int]]:
    """Extract one feasible hop list ending at ``dst`` on ``arrival_slot``.

    ``vec`` is the converged busy-vector array of one request (numpy
    uint32, e.g. a row of :func:`wavefront_search_batch`'s result), ``occ``
    the (n_nodes, N_PORTS) busy masks used for the search.
    """
    coords = mesh.coord_array
    hops: list[tuple[int, int, int]] = [(dst, PORT_LOCAL, arrival_slot)]
    v, j = int(dst), int(arrival_slot)
    strides = (1, mesh.X, mesh.X * mesh.Y)
    sign = np.sign(coords[dst] - coords[src])
    guard = 0
    while v != src:
        guard += 1
        if guard > mesh.max_dist + 2:
            raise RuntimeError("traceback failed to reach source")
        jp = (j - 1) % n_slots
        placed = False
        for d in range(3):
            if sign[d] == 0 or coords[v][d] == coords[src][d]:
                continue
            u = v - int(sign[d]) * strides[d]
            p = port_for(d, int(sign[d]))
            if bit_is_free(int(vec[u]) | int(occ[u, p]), jp):
                hops.append((u, p, jp))
                v, j = u, jp
                placed = True
                break
        if not placed:
            raise RuntimeError(
                f"no free upstream at node {v} slot {j} (inconsistent search)")
    hops.reverse()
    return hops


def traceback_batch(vecs: np.ndarray, vec_rows: np.ndarray, occ: np.ndarray,
                    mesh: Mesh3D, n_slots: int, srcs: np.ndarray,
                    dsts: np.ndarray, arrival_slots: np.ndarray):
    """Vectorized :func:`traceback` over a batch of (request, slot) jobs.

    Every job walks upstream in lockstep: one iteration per remaining hop,
    with the per-dimension candidate masks (validity: still displaced from
    the source along d; feasibility: the upstream busy bit is clear)
    evaluated for the whole batch at once and the first free dimension
    selected in the same x->y->z priority order as the serial walk.

    Args:
      vecs: (R, n_nodes) uint32 converged busy vectors.
      vec_rows: (J,) row of ``vecs`` each job reads.
      occ: (n_nodes, N_PORTS) uint32 busy masks the search ran against.
      srcs, dsts, arrival_slots: (J,) per-job endpoints + arrival slot.

    Returns:
      ``(hop_nodes, hop_ports, hop_slots, dists, ok)`` where the hop arrays
      are (J, max_dist+1) with job j's forward hop list in ``[:dists[j]+1]``
      (last entry = (dst, LOCAL, arrival)), and ``ok[j]`` is False when the
      walk found no free upstream (infeasible arrival slot — the batched
      twin of the serial walk's RuntimeError).
    """
    J = srcs.size
    coords = mesh.coord_array
    dists = np.abs(coords[srcs] - coords[dsts]).sum(1)
    L = int(dists.max()) + 1 if J else 1
    hop_n = np.zeros((J, L), np.int64)
    hop_p = np.zeros((J, L), np.int64)
    hop_s = np.zeros((J, L), np.int64)
    rows = np.arange(J)
    hop_n[rows, dists] = dsts
    hop_p[rows, dists] = PORT_LOCAL
    hop_s[rows, dists] = arrival_slots
    src_c = coords[srcs]                                        # (J, 3)
    sign = np.sign(coords[dsts] - src_c).astype(np.int64)       # (J, 3)
    strides = np.asarray([1, mesh.X, mesh.X * mesh.Y], np.int64)
    dims = np.arange(3)
    ports = np.where(sign < 0, 2 * dims + 1, 2 * dims)          # (J, 3)
    v = dsts.astype(np.int64).copy()
    j = np.asarray(arrival_slots, np.int64).copy()
    widx = dists - 1                    # next (backward) write position
    ok = np.ones(J, bool)
    active = v != srcs
    while active.any():
        jp = (j - 1) % n_slots
        u = np.clip(v[:, None] - sign * strides[None], 0, mesh.n_nodes - 1)
        valid = (sign != 0) & (coords[v] != src_c)              # (J, 3)
        busy = vecs[vec_rows[:, None], u] | occ[u, ports]
        cand = valid & (((busy >> jp[:, None]) & 1) == 0)
        has = cand.any(1)
        ok[active & ~has] = False
        move = np.nonzero(active & has)[0]
        d = cand[move].argmax(1)        # first free dim: x -> y -> z priority
        uu = u[move, d]
        hop_n[move, widx[move]] = uu
        hop_p[move, widx[move]] = ports[move, d]
        hop_s[move, widx[move]] = jp[move]
        v[move] = uu
        j[move] = jp[move]
        widx[move] -= 1
        active = np.zeros(J, bool)
        active[move] = v[move] != srcs[move]
    return hop_n, hop_p, hop_s, dists, ok


def _hops_list(hop_n, hop_p, hop_s, job: int, length: int):
    """Forward hop-tuple list of one traceback job (Python ints)."""
    return list(zip(hop_n[job, :length].tolist(), hop_p[job, :length].tolist(),
                    hop_s[job, :length].tolist()))


_SMALL_TRACE = 24     # below this many jobs the scalar walk wins


def _traceback_jobs(vecs, vec_rows, occ, mesh, n_slots, srcs, dsts,
                    arrival_slots):
    """Hop lists + feasibility for a batch of (request, slot) jobs.

    Dispatches between the scalar walk (per-job Python, cheaper below
    ~:data:`_SMALL_TRACE` jobs — e.g. a conflict-scoped re-search round)
    and :func:`traceback_batch` (lockstep numpy, amortizes over large
    rounds).  Both produce identical paths: same x->y->z upstream
    priority, same slot arithmetic.

    Returns ``(hops, ok)`` — per job the forward hop-tuple list (None
    when infeasible) and the feasibility flag.
    """
    J = len(srcs)
    if J < _SMALL_TRACE:
        hops: list = []
        ok = np.ones(J, bool)
        for k in range(J):
            try:
                hops.append(traceback(vecs[vec_rows[k]], occ, mesh, n_slots,
                                      int(srcs[k]), int(dsts[k]),
                                      int(arrival_slots[k])))
            except RuntimeError:
                hops.append(None)
                ok[k] = False
        return hops, ok
    hop_n, hop_p, hop_s, dists, ok = traceback_batch(
        vecs, vec_rows, occ, mesh, n_slots, srcs, dsts, arrival_slots)
    return [_hops_list(hop_n, hop_p, hop_s, k, int(dists[k]) + 1)
            if ok[k] else None for k in range(J)], ok


_FAR = np.int64(2 ** 62)


def _best_slots_np(avail: np.ndarray, dists: np.ndarray,
                   t_readys: np.ndarray, n_slots: int):
    """Vectorized slot choice: earliest (start_cycle, arrival_slot) over
    the free arrival slots of each row's availability vector, for circuits
    of ``dists`` hops ready at ``t_readys``.

    Returns ``(start_cycles, arrival_slots, free, denied)``; ties on the
    start cycle resolve to the lowest arrival slot, exactly like the
    serial ascending scan."""
    slots = np.arange(n_slots, dtype=np.int64)
    free = ((avail.astype(np.int64)[:, None] >> slots[None, :]) & 1) == 0
    s_inj = (slots[None, :] - dists[:, None]) % n_slots
    c = t_readys[:, None] + ((s_inj - t_readys[:, None]) % n_slots)
    cost = np.where(free, c, _FAR)
    a = cost.argmin(1)
    rows = np.arange(len(avail))
    return cost[rows, a], a, free, ~free.any(1)


# ---------------------------------------------------------------------------
# Full allocation: batched search + slot choice + trace-back + reserve
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class AllocResult:
    circuit: Circuit | None
    searched_cycle: int


@dataclasses.dataclass(frozen=True)
class CopyRequest:
    """One pending inter-bank copy for the batched CCU pipeline.

    ``cycle`` optionally anchors this request later than the batch cycle
    (e.g. its source read completes later); the occupancy snapshot is still
    taken at the batch cycle, which is conservative.

    ``op`` selects the operation class: ``"copy"`` (default) streams
    ``nbytes`` over a circuit from ``src`` to ``dst``; ``"init"`` is
    bulk initialization *in place* (``src == dst``) — the CCU sets up a
    zero-hop circuit that occupies only the bank's LOCAL port while the
    bank clears rows internally (RowClone-FPM style), so INIT traffic
    shares the CCU's admission/telemetry pipeline without consuming mesh
    links; ``"reduce"`` is the compute-class fan-in — one ``nbytes``
    operand from every bank in ``srcs`` is combined at ``dst`` over
    per-source circuits sharing the destination port under the ALU-dwell
    occupancy model (``src`` mirrors ``srcs[0]``)."""
    src: int
    dst: int
    nbytes: int
    max_extra_slots: int = 0
    cycle: int | None = None
    op: str = "copy"
    srcs: tuple = ()


@dataclasses.dataclass
class BatchReport:
    """Telemetry of the last ``allocate_batch`` call."""
    n_requests: int = 0
    n_committed: int = 0
    n_denied: int = 0          # no feasible circuit even after re-search
    search_rounds: int = 0     # vectorized wavefront passes issued
    conflicts: int = 0         # stale-snapshot commits that forced a re-search
    n_searched: int = 0        # per-request searches summed over all passes
    #   (conflict-scoped re-search keeps this near n_requests; the old
    #   tail-wide retry made it grow ~quadratically with the tail length)
    fused_waves: int = 0       # prepare rounds served by the fused program
    host_waves: int = 0        # prepare rounds served by the host pipeline


_CONFLICT = object()   # sentinel: stale search, re-run against fresh state


@dataclasses.dataclass
class _Prepared:
    """One request's fully prepared commit: slot choice, traced hop
    bundle and reservation indices, derived from a (possibly stale)
    converged search.  Everything here is a pure function of the search
    snapshot, so committing only needs the live-table freshness check."""
    denied: bool = False
    conflict: bool = False     # prepared state is unusable: force re-search
    dup: bool = False          # bundle internally double-books (defensive)
    src: int = 0
    dst: int = 0
    start_cycle: int = 0
    w_res: int = 0
    n_win: int = 1
    slots_per_window: int = 1
    distance: int = 0
    hops: list | None = None
    idx: tuple | None = None           # (nodes, ports, slots) index arrays
    flat: set | None = None            # flat (node,port,slot) entry ids —
    #   the pending-run membership key (single-slot mesh circuits only)
    uses_bus: bool = False
    bus_column: int = -1
    bus_slots: list | None = None      # [(column, slot)] (NoM-Light)
    reduce: bool = False               # compute-class fan-in bundle: the
    #   (dst, LOCAL) prefix repeats across arrival + dwell slots, so the
    #   commit must take the duplicate-prefix-safe reservation path
    srcs: tuple = ()                   # fan-in sources (reduce only)


class TdmAllocator:
    """The CCU's allocation pipeline for the *full 3D mesh* NoM.

    The paper's CCU sets up *many* link-disjoint circuits that stream
    concurrently; :meth:`allocate_batch` is the corresponding entry point:
    one batched :func:`wavefront_search_batch` pass over every pending
    request, a *vectorized* post-search pipeline (batch slot choice +
    :func:`traceback_batch` over every needed arrival slot, extra-slot
    bundles included), then a host-side commit loop that reserves circuits
    in arrival order.  A commit can discover that an earlier circuit from
    the *same* batch claimed one of its hops (the search snapshot is
    per-round, not per-request); the loser is re-searched against fresh
    state together with only the still-pending requests whose
    shortest-path boxes intersect the resources claimed so far —
    everything else commits from its existing converged vectors — so the
    results are bit-identical to servicing the stream through
    :meth:`allocate` one request at a time.

    ``allocate`` (the serial spelling) implements the paper's 3-cycle
    setup: the request picked at cycle t searches at t (1 cycle), programs
    slot tables (1 cycle), issues the read (1 cycle), so the earliest
    injection is t+3.  It is a batch of one.

    ``device`` (default ``"cuda"``) holds the occupancy tensor the
    kernels read; ``device="cpu"`` runs their plain PyTorch versions.
    """

    def __init__(self, mesh: Mesh3D, n_slots: int = 16,
                 link_bytes: int = 8, use_kernels: bool = False,
                 backend: str = "auto", device="cuda"):
        if backend not in ("auto", "host", "fused"):
            raise ValueError(f"backend must be auto|host|fused, "
                             f"got {backend!r}")
        self.mesh = mesh
        self.n_slots = n_slots
        self.link_bytes = link_bytes  # 64-bit links => 8 bytes/slot-cycle
        self.device = resolve_device(device)
        self.table = SlotTable(mesh, n_slots, device=self.device)
        self.last_report = BatchReport()
        # backend picks who serves a prepare round (search + slot choice +
        # trace-back): "fused" = always the one-launch fused kernel,
        # "host" = always the split pipeline (search kernel; scoring,
        # trace-back and bundles on the host), "auto" = fused for full
        # waves, host for tiny rounds (serial allocate, conflict-scoped
        # re-search) where launch overhead dwarfs the compute.
        self.backend = backend
        self._last_prepare_backend = "host"
        # use_kernels routes every search through the kernel (no host
        # small-batch shortcut), so kernel tests exercise it end to end.
        self._host_small = not use_kernels
        self._stream: torch.cuda.Stream | None = None

    # An in-place INIT clears one DRAM row per TDM window (RowClone-FPM in
    # the bank; no bytes cross the mesh), so its zero-hop circuit holds the
    # LOCAL port for ceil(nbytes / init_row_bytes) windows.
    init_row_bytes: int = 8192

    # Compute-class fan-in (op="reduce"): extra TDM slot(s) the
    # destination bank's ALU holds on its LOCAL port per merged operand
    # (every operand after the first) — the dwell the fold into the
    # accumulator costs before the port can accept the next arrival.
    reduce_dwell: int = 1

    # Requests searched per vectorized wavefront pass.  The accelerator's
    # cost is linear in the wave size, so waves cost no extra search time,
    # and a fresher snapshot per wave keeps stale-commit conflicts flat as
    # the batch grows (results are bit-identical regardless of the value).
    search_wave: int = 64

    def n_windows_for(self, nbytes: int, slots: int = 1) -> int:
        per_window = self.link_bytes * slots
        return max(1, -(-nbytes // per_window))

    def n_windows_for_init(self, nbytes: int) -> int:
        return max(1, -(-nbytes // self.init_row_bytes))

    # -- public API -----------------------------------------------------------
    def allocate(self, src: int, dst: int, nbytes: int, cycle: int,
                 max_extra_slots: int = 0) -> AllocResult:
        """Find + reserve the earliest circuit for a copy of ``nbytes``.

        Returns AllocResult with circuit=None if the lattice is fully busy
        (caller retries next cycle, as the CCU would)."""
        return self.allocate_batch(
            [CopyRequest(src, dst, nbytes, max_extra_slots)], cycle)[0]

    def allocate_batch(self, requests: list, cycle: int) -> list[AllocResult]:
        """Service a batch of pending copy requests concurrently.

        This is the CCU's concurrent circuit establishment (paper Section
        2.2): every request of the batch is searched in one vectorized
        wavefront pass, prepared by the vectorized commit pipeline (batch
        slot choice + batched trace-back), then committed in arrival
        (FIFO) order against the live slot table, so each granted circuit
        is (router, port, slot)-disjoint from every other circuit live in
        its TDM windows.  A commit that finds its hops claimed by an
        earlier commit of the same batch triggers a fresh search for it —
        plus, in the same vectorized pass, any still-pending request whose
        shortest-path box intersects the claimed resources (the
        conflict-scoped invalidation); the rest of the batch commits from
        its existing converged vectors — results are bit-identical to
        streaming the requests through :meth:`allocate` one at a time.

        Args:
          requests: list of :class:`CopyRequest` (or bare
            ``(src, dst, nbytes)`` tuples).  ``src``/``dst`` are int bank
            ids on the mesh; ``nbytes`` is the payload in bytes — with the
            paper's 64-bit links one TDM slot moves ``link_bytes`` (8) per
            window, so the circuit persists
            ``ceil(nbytes / (8 * slots))`` windows.
          cycle: absolute allocator cycle at which the batch is picked up;
            injection starts no earlier than ``cycle + 3`` (the 3-cycle
            search/program/read setup pipeline).  Requests carrying their
            own ``cycle`` anchor are validated against this batch cycle
            (conservative) but reserved at their own window.

        Returns:
          One :class:`AllocResult` per request, in request order.
          ``circuit is None`` means the lattice was saturated at every
          candidate slot.  ``self.last_report`` holds the
          :class:`BatchReport` (search passes, conflicts, denials).
        """
        reqs = [r if isinstance(r, CopyRequest) else CopyRequest(*r)
                for r in requests]
        report = BatchReport(n_requests=len(reqs))
        results: list[AllocResult | None] = [None] * len(reqs)
        if not reqs:
            self.last_report = report
            return results
        window = (cycle + 3) // self.n_slots
        t_readys = np.fromiter(
            (max(r.cycle if r.cycle is not None else cycle, cycle) + 3
             for r in reqs), np.int64, len(reqs))
        # The batch is searched in *waves* (one vectorized pass each): the
        # accelerator's cost is linear in the wave size, so splitting
        # costs nothing, while each wave's snapshot already contains every
        # earlier commit — stale-snapshot conflicts only arise *within* a
        # wave, which keeps their count flat as the batch grows.
        #
        # Within a wave, conflict-scoped invalidation: bitmaps of the
        # nodes / bus columns claimed by commits since the wave's search.
        # A pending request whose shortest-path box contains no claimed
        # resource is *clean*: its converged vectors are provably
        # identical to a fresh search's, so it commits without even
        # touching the live table.  A box-hit state is validated against
        # the live table, and only an actual claim of one of its chosen
        # hops forces a re-search — of that request alone, on the host
        # fast path, not the whole tail.  (A state re-searched after a
        # conflict commits immediately, so the bitmaps never need
        # per-state sequencing.)
        # Deferred circuit emission of the last fused wave: its
        # reservations are final but its Circuit objects are built
        # overlapped with the *next* wave's device program.
        pending = None
        for lo in range(0, len(reqs), self.search_wave):
            hi = min(lo + self.search_wave, len(reqs))
            wave = reqs[lo:hi]
            self._last_prepare_backend = "host"
            if (self._wave_fast
                    and self._fused_eligible(len(wave), t_readys[lo:hi])
                    and all(r.op == "copy" and not r.max_extra_slots
                            for r in wave)):
                # All-simple fused wave: skip per-state materialization
                # entirely — the struct-of-arrays commit below.
                token = self._dispatch_wave_fused(wave, t_readys[lo:hi],
                                                  window)
                if pending is not None:
                    self._emit_wave_fused(pending, results, cycle)
                report.search_rounds += 1
                report.n_searched += len(wave)
                report.fused_waves += 1
                pending = self._commit_wave_fused(
                    token, wave, t_readys[lo:hi], lo, window, cycle,
                    results, report)
                continue
            if pending is not None:
                self._emit_wave_fused(pending, results, cycle)
                pending = None
            states = self._prepare_states(wave, t_readys[lo:hi], window)
            report.search_rounds += 1
            report.n_searched += len(wave)
            if self._last_prepare_backend == "fused":
                report.fused_waves += 1
            else:
                report.host_waves += 1
            # Pending *run*: consecutive single-slot states whose chosen
            # (node, port, slot) reservation entries are pairwise
            # disjoint.  Entry disjointness makes their commits
            # order-independent and keeps each member's live-table
            # validation independent of the others' (a commit only writes
            # its own entries), so the whole run is validated with ONE
            # vectorized expiry gather and committed with one vectorized
            # reservation — outcome-identical to committing each
            # serially.  A state that cannot join (bus route, extra-slot
            # bundle, entry overlap with a pending member) flushes the
            # run first, so the serial path always sees exactly the live
            # table it would have seen.
            run: list[int] = []
            run_claims: set = set()  # entry ids of pending members
            work = list(range(len(wave)))
            i = 0
            while True:
                if i >= len(work):
                    if not run:
                        break
                    redo = self._flush_pending(states, run, wave,
                                               t_readys[lo:hi], results,
                                               lo, window, cycle, report)
                    run = []
                    run_claims = set()
                    if redo:
                        work[i:i] = redo
                    continue
                k = work[i]
                st = states[k]
                if st.denied:
                    report.n_denied += 1
                    results[lo + k] = AllocResult(None, cycle)
                    i += 1
                    continue
                if st.flat is not None and not st.conflict:
                    if run_claims.isdisjoint(st.flat):
                        run.append(k)
                        run_claims |= st.flat
                        i += 1
                        continue
                # k cannot ride the pending run: flush, then retry k (it
                # may start the next run, or fall through to the serial
                # path below once the run is empty).
                if run:
                    redo = self._flush_pending(states, run, wave,
                                               t_readys[lo:hi], results,
                                               lo, window, cycle, report)
                    run = []
                    run_claims = set()
                    if redo:
                        work[i:i] = redo
                    continue
                out = self._commit_prepared(st, window, validate=True)
                if out is _CONFLICT:
                    st, out = self._handle_conflict(
                        wave[k], t_readys[lo + k:lo + k + 1], window,
                        report)
                if out is None:
                    report.n_denied += 1
                else:
                    report.n_committed += 1
                results[lo + k] = AllocResult(out, cycle)
                i += 1
        if pending is not None:
            self._emit_wave_fused(pending, results, cycle)
        self.last_report = report
        return results

    def _handle_conflict(self, req: CopyRequest, t_ready: np.ndarray,
                         window: int, report: BatchReport):
        """Stale-snapshot conflict: re-search ``req`` alone against the
        live table (the conflict-scoped re-search) and commit the fresh
        state, counter bookkeeping included.  Returns ``(state,
        circuit_or_None)``."""
        report.conflicts += 1
        self._last_prepare_backend = "host"
        st = self._reprepare_conflict(req, t_ready, window)
        report.search_rounds += 1
        report.n_searched += 1
        if self._last_prepare_backend == "fused":
            report.fused_waves += 1
        else:
            report.host_waves += 1
        out = self._commit_prepared(st, window, validate=False)
        if out is _CONFLICT:
            raise RuntimeError("fresh search conflicted with itself")
        return st, out

    def _flush_pending(self, states: list[_Prepared], ks: list[int],
                       wave: list[CopyRequest], t_readys_w: np.ndarray,
                       results, lo: int, window: int, cycle: int,
                       report: BatchReport) -> list[int]:
        """Validate + commit a pending run of entry-disjoint single-slot
        states in one vectorized pass.

        The run's expiry gather against the live table is element-wise
        identical to the serial loop's per-state validations: members'
        (node, port, slot) entry sets are pairwise disjoint, so
        committing one never changes another's check.  All pass => one
        batch reservation.  On the
        first failure — exactly the state the serial loop would bounce —
        the passing prefix commits, the loser re-searches fresh (the
        conflict-scoped re-search), and the not-yet-committed tail is
        handed back for another pass, where its members' validations see
        the loser's fresh claims.  Returns that tail."""
        table = self.table
        if len(ks) == 1:
            st = states[ks[0]]
            out = self._commit_prepared(st, window, validate=True)
            if out is _CONFLICT:
                st, out = self._handle_conflict(
                    wave[ks[0]], t_readys_w[ks[0]:ks[0] + 1], window,
                    report)
            if out is None:
                report.n_denied += 1
            else:
                report.n_committed += 1
            results[lo + ks[0]] = AllocResult(out, cycle)
            return []
        idxs = [states[k].idx for k in ks]
        cat = tuple(np.concatenate([ix[j] for ix in idxs])
                    for j in range(3))
        bad = table.expiry[cat] > window
        j = len(ks)
        if bad.any():
            # first member the serial loop would bounce
            lens = np.fromiter((len(ix[0]) for ix in idxs), np.int64,
                               len(idxs))
            pos = int(np.flatnonzero(bad)[0])
            j = int(np.searchsorted(np.cumsum(lens), pos, side="right"))
            idxs = idxs[:j]
            if j:
                upto = int(lens[:j].sum())
                cat = tuple(c[:upto] for c in cat)
        if j:
            table._ports.reserve_run(
                idxs, cat, [states[k].w_res + states[k].n_win
                            for k in ks[:j]])
            n_hint = self.n_slots
            for k in ks[:j]:
                st = states[k]
                report.n_committed += 1
                results[lo + k] = AllocResult(
                    Circuit(src=st.src, dst=st.dst,
                            start_cycle=st.start_cycle,
                            n_windows=st.n_win, hops=st.hops,
                            slots_per_window=st.slots_per_window,
                            uses_bus=st.uses_bus, bus_column=st.bus_column,
                            distance=st.distance, _n_slots_hint=n_hint),
                    cycle)
        if j == len(ks):
            return []
        kbad = ks[j]
        _st, out = self._handle_conflict(
            wave[kbad], t_readys_w[kbad:kbad + 1], window, report)
        if out is None:
            report.n_denied += 1
        else:
            report.n_committed += 1
        results[lo + kbad] = AllocResult(out, cycle)
        return ks[j + 1:]

    # Route all-simple fused waves (plain copies, no extra-slot bundles)
    # through the struct-of-arrays commit — _Prepared objects exist only
    # for conflict re-searches.  NoM-Light waves can carry bus hops, so
    # they keep the generic per-state loop.
    _wave_fast: bool = True

    def _side_stream(self) -> torch.cuda.Stream | None:
        """The stream fused waves launch on (created on first use; None
        on the CPU)."""
        if self.device.type == "cuda" and self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        return self._stream

    def _fused_start(self, srcs, dsts, t_w, window: int):
        from repro_torch.kernels.slot_alloc import fused as _fused
        return _fused.fused_prepare_start(
            self.table.device_busy_masks(window), srcs, dsts, t_w,
            mesh=self.mesh, n_slots=self.n_slots, stream=self._side_stream())

    def _dispatch_wave_fused(self, wave: list[CopyRequest],
                             t_w: np.ndarray, window: int):
        """Launch the fused kernel for a wave without blocking (side
        stream + event) — the caller emits the previous wave's circuits
        while the device searches this one."""
        B = len(wave)
        srcs = np.fromiter((r.src for r in wave), np.int64, B)
        dsts = np.fromiter((r.dst for r in wave), np.int64, B)
        return self._fused_start(srcs, dsts, t_w, window)

    def _emit_wave_fused(self, pending, results, cycle: int) -> None:
        """Deferred circuit emission for a fused wave's clean commits:
        pure bookkeeping (no table access), so it runs overlapped with
        the next wave's device program."""
        wave, lo, rows, fp, n_win, dists_l = pending
        n = self.n_slots
        starts_l = fp.starts.tolist()
        nwin_l = n_win.tolist()
        hn_l = fp.hop_n.tolist()
        hp_l = fp.hop_p.tolist()
        hs_l = fp.hop_s.tolist()
        for i in rows:
            ln = dists_l[i] + 1
            r = wave[i]
            results[lo + i] = AllocResult(
                Circuit(src=r.src, dst=r.dst, start_cycle=starts_l[i],
                        n_windows=nwin_l[i],
                        hops=list(zip(hn_l[i][:ln], hp_l[i][:ln],
                                      hs_l[i][:ln])),
                        distance=dists_l[i], _n_slots_hint=n), cycle)

    def _commit_wave_fused(self, token, wave: list[CopyRequest],
                           t_w: np.ndarray, lo: int, window: int,
                           cycle: int, results, report: BatchReport):
        """Fused-program wave commit without per-state materialization.

        The wave's hop bundles stay in the program's (B, L) output
        arrays.  Rows are cut into *segments* — maximal runs of rows
        whose flat ``(node, port, slot)`` reservation entries are
        pairwise disjoint — by one python scan over the raveled entry
        ids.  Entry disjointness makes a segment's commits
        order-independent and its members' live-table validations
        independent of each other, so each segment is validated with a
        single flat expiry gather and reserved with a single vectorized
        write.  The first failing row of a segment is exactly the state
        the serial loop would bounce: the passing prefix commits, the
        loser re-searches against the live table (the conflict-scoped
        re-search, scalar fast path), and the remainder is requeued as
        its own segment — still pairwise disjoint — whose validation
        then sees the loser's fresh claims.  Bit-identical to streaming
        the wave through :meth:`allocate`.

        Returns the deferred emission record for
        :meth:`_emit_wave_fused` — reservations and conflict results are
        final when this returns, but clean commits' Circuit objects are
        not yet built."""
        from repro_torch.kernels.slot_alloc import fused as _fused
        n = self.n_slots
        B = len(wave)
        fp = _fused.fused_prepare_wait(token)
        self._last_prepare_backend = "fused"
        denied = fp.denied
        if (~denied & ~fp.ok).any():
            i = int(np.flatnonzero(~denied & ~fp.ok)[0])
            raise RuntimeError(
                f"no free upstream for request "
                f"{wave[i].src}->{wave[i].dst} slot {int(fp.arr[i])} "
                f"(inconsistent search)")
        hop_n, hop_p, hop_s = fp.hop_n, fp.hop_p, fp.hop_s
        L = hop_n.shape[1]
        lens = np.where(denied, 0, fp.dists.astype(np.int64) + 1)
        valid = np.arange(L)[None, :] < lens[:, None]
        # int32 throughout: flat ids top out at n_nodes*N_PORTS*n_slots.
        ent = ((hop_n * N_PORTS + hop_p) * n + hop_s)[valid]
        offs = np.zeros(B + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        nbytes = np.fromiter((r.nbytes for r in wave), np.int64, B)
        n_win = np.maximum(1, -(-nbytes // self.link_bytes))
        untils = t_w // n + n_win
        ent_l = ent.tolist()
        offs_l = offs.tolist()
        denied_l = denied.tolist()
        dists_l = fp.dists.tolist()
        untils_l = untils.tolist()
        for i in np.flatnonzero(denied).tolist():
            report.n_denied += 1
            results[lo + i] = AllocResult(None, cycle)
        # Segment scan: a row whose entries hit the current segment's
        # claims starts the next segment.  (Denied rows are zero-width:
        # they never clash and commit nothing.)
        segs: list[tuple[int, int]] = []
        seen: dict[int, int] = {}
        sid = 0
        a = 0
        for i in range(B):
            row = ent_l[offs_l[i]:offs_l[i + 1]]
            for e in row:
                if seen.get(e, -1) == sid:
                    segs.append((a, i))
                    sid += 1
                    a = i
                    break
            for e in row:
                seen[e] = sid
        segs.append((a, B))
        ports = self.table._ports
        ef = ports.expiry.reshape(-1)
        emit_rows: list[int] = []
        p = 0
        while p < len(segs):
            a, b = segs[p]
            p += 1
            pa, pb = offs_l[a], offs_l[b]
            if pa == pb:       # all-denied segment: results already out
                continue
            bad = ef[ent[pa:pb]] > window
            if not bad.any():
                j = b
            else:
                pos = pa + int(np.flatnonzero(bad)[0])
                j = int(np.searchsorted(offs, pos, side="right")) - 1
            if offs_l[j] > pa:
                u_ent = np.repeat(untils[a:j], lens[a:j])
                idx_untils = []
                for i in range(a, j):
                    if denied_l[i]:
                        continue
                    ln = dists_l[i] + 1
                    idx_untils.append(
                        ((hop_n[i, :ln], hop_p[i, :ln], hop_s[i, :ln]),
                         untils_l[i]))
                    report.n_committed += 1
                    emit_rows.append(i)
                ports.reserve_flat(ent[pa:offs_l[j]], u_ent, idx_untils)
            if j >= b:
                continue
            _st, out = self._handle_conflict(wave[j], t_w[j:j + 1],
                                             window, report)
            if out is None:
                report.n_denied += 1
            else:
                report.n_committed += 1
            results[lo + j] = AllocResult(out, cycle)
            if j + 1 < b:
                segs[p:p] = [(j + 1, b)]
        return wave, lo, emit_rows, fp, n_win, dists_l

    # -- search + vectorized post-search pipeline -----------------------------
    def _run_search(self, occ, window, srcs, dsts, inits) -> np.ndarray:
        """One wavefront pass over ``srcs``/``dsts``/``inits`` (numpy
        arrays) against the host busy masks ``occ`` valid at ``window``.

        Large rounds launch the search kernel over the version-keyed
        device occupancy (no power-of-two padding: a CUDA launch has no
        per-shape compile to amortize); at or below :data:`_SMALL_SEARCH`
        entries — a conflict-scoped re-search round, a serial
        ``allocate`` — the host topological evaluation is cheaper than
        the launch (unless ``use_kernels``).  Returns (len(srcs),
        n_nodes) uint32 busy vectors (numpy).  Slot scoring of the round
        stays on the host (:func:`_best_slots_np`), as in the reference:
        one scoring round of 64 rows takes less host time in numpy than
        an upload, a scoring launch and a pull."""
        if self._host_small and len(srcs) <= _SMALL_SEARCH:
            return np.stack([
                _wavefront_host(occ, self.mesh, self.n_slots, int(s),
                                int(d), int(iv))
                for s, d, iv in zip(srcs, dsts, inits)])
        from repro_torch.kernels.slot_alloc.ops import wavefront_search_host
        return wavefront_search_host(
            self.table.device_busy_masks(window), srcs, dsts,
            np.asarray(inits, np.uint32), mesh=self.mesh,
            n_slots=self.n_slots)

    def _prepare_states(self, reqs: list[CopyRequest], t_readys: np.ndarray,
                        window: int) -> list[_Prepared]:
        """Prepare one wave: compute-class fan-ins through the scalar
        :meth:`_prepare_reduce` (identical on every backend), the rest
        through the copy/init pipeline — all against the same occupancy
        snapshot, reassembled in request order."""
        if not reqs:
            return []
        red_ix = {i for i, r in enumerate(reqs) if r.op == "reduce"}
        if not red_ix:
            return self._prepare_copy_states(reqs, t_readys, window)
        occ = self.table._ports.masks_at(window)
        red = {i: self._prepare_reduce(reqs[i], int(t_readys[i]), occ,
                                       window)
               for i in sorted(red_ix)}
        rest_ix = [i for i in range(len(reqs)) if i not in red_ix]
        rest = iter(self._prepare_copy_states(
            [reqs[i] for i in rest_ix], t_readys[rest_ix], window)
            if rest_ix else [])
        return [red[i] if i in red_ix else next(rest)
                for i in range(len(reqs))]

    def _prepare_reduce(self, r: CopyRequest, t_ready: int, occ: np.ndarray,
                        window: int) -> _Prepared:
        """Prepare a fan-in reduce bundle: one single-slot circuit per
        source bank, chosen in *request source order* (the fixed
        summation tree), each searched against the snapshot plus the
        bundle's own earlier reservations.  Every operand after the
        first additionally holds ``reduce_dwell`` ALU-dwell slot(s) on
        the destination's LOCAL port right after its arrival slot — the
        cycles the bank ALU needs to fold the operand into the
        accumulator — so the destination port carries
        ``k + (k-1)*reduce_dwell`` reservations for a fan-in of k.

        The routine is scalar and snapshot-pure on every backend
        (host == fused by construction); serial-vs-batch bit-identity
        follows from the same monotone feasible-set argument as copies:
        commits validate the whole bundle against the live table and a
        stale bundle re-prepares fresh.
        """
        n = self.n_slots
        mesh = self.mesh
        dwell = max(0, int(self.reduce_dwell))
        occ2 = occ.copy()
        hops_all: list[tuple[int, int, int]] = []
        start = last_arrival = None
        for j, s in enumerate(r.srcs):
            s = int(s)
            if s == r.dst:
                return _Prepared(denied=True, src=r.src, dst=r.dst)
            vec = _wavefront_host(occ2, mesh, n, s, r.dst, 0)
            avail = int(vec[r.dst]) | int(occ2[r.dst, PORT_LOCAL])
            local = int(occ2[r.dst, PORT_LOCAL])
            dist = mesh.manhattan(s, r.dst)
            best = None
            for a in range(n):
                if (avail >> a) & 1:
                    continue
                if j and dwell and any((local >> ((a + q) % n)) & 1
                                       for q in range(1, dwell + 1)):
                    continue        # ALU busy right after this arrival
                s_inj = (a - dist) % n
                c = t_ready + ((s_inj - t_ready) % n)
                if best is None or c < best[0]:
                    best = (c, a)
            if best is None:
                return _Prepared(denied=True, src=r.src, dst=r.dst)
            c, a = best
            hops = traceback(vec, occ2, mesh, n, s, r.dst, a)
            if j and dwell:
                hops = hops + [(r.dst, PORT_LOCAL, (a + q) % n)
                               for q in range(1, dwell + 1)]
            for hn, hp, hs in hops:
                occ2[hn, hp] |= np.uint32(1) << np.uint32(hs)
            hops_all += hops
            start = c if start is None else min(start, c)
            last_arrival = (c + dist if last_arrival is None
                            else max(last_arrival, c + dist))
        return _Prepared(
            src=r.src, dst=r.dst, start_cycle=start, w_res=t_ready // n,
            n_win=self.n_windows_for(r.nbytes), slots_per_window=1,
            distance=last_arrival - start, hops=hops_all,
            idx=SlotTable._hops_idx(hops_all), flat=None, reduce=True,
            srcs=tuple(int(s) for s in r.srcs))

    def _prepare_copy_states(self, reqs: list[CopyRequest],
                             t_readys: np.ndarray,
                             window: int) -> list[_Prepared]:
        if not reqs:
            return []
        if self._fused_eligible(len(reqs), t_readys):
            return self._prepare_fused(reqs, t_readys, window)
        occ = self.table._ports.masks_at(window)
        srcs = np.fromiter((r.src for r in reqs), np.int64, len(reqs))
        dsts = np.fromiter((r.dst for r in reqs), np.int64, len(reqs))
        vecs = self._run_search(occ, window, srcs, dsts,
                                np.zeros(len(reqs), np.uint32))
        return self._prepare_full(reqs, t_readys, vecs,
                                  np.arange(len(reqs)), occ, window,
                                  srcs=srcs, dsts=dsts)

    def _reprepare_conflict(self, req: CopyRequest, t_ready: np.ndarray,
                            window: int) -> _Prepared:
        """Fresh single-request prepare after a stale-snapshot conflict.

        On the host backends this skips the batch plumbing entirely: one
        scalar topological wavefront against the refreshed masks, then
        the scalar slot choice / trace-back — the conflict fast path the
        wave structure was designed around.  A forced-fused allocator
        re-prepares through the fused kernel instead, so the
        differential harness exercises it end to end.  Fan-in bundles
        always re-prepare through the scalar reduce routine (their one
        prepare path on every backend)."""
        if req.op == "reduce":
            occ = self.table._ports.masks_at(window)
            return self._prepare_reduce(req, int(t_ready[0]), occ, window)
        if self._host_small and self.backend != "fused":
            occ = self.table._ports.masks_at(window)
            vec = _wavefront_host(occ, self.mesh, self.n_slots, req.src,
                                  req.dst, 0)
            return self._prepare_one(req, int(t_ready[0]), vec, occ, window)
        return self._prepare_states([req], t_ready, window)[0]

    # -- the fused kernel backend ---------------------------------------------
    def _fused_eligible(self, batch: int, t_readys: np.ndarray) -> bool:
        """Route this prepare round through the fused kernel?  "auto"
        keeps the host scalar path for tiny rounds; every backend takes
        the host pipeline when a start cycle could overflow the kernel's
        int32 cost arithmetic (the host pipeline scores in int64).  Both
        rules are the reference's semantics, so fused_waves / host_waves
        match it."""
        if self.backend == "host":
            return False
        if self.backend == "auto" and batch <= _SMALL_SEARCH:
            return False
        return int(t_readys.max()) < 2 ** 31 - 2 * self.n_slots

    def _prepare_fused(self, reqs: list[CopyRequest], t_readys: np.ndarray,
                       window: int) -> list[_Prepared]:
        """One wave through the fused kernel (wavefront + slot choice +
        trace-back in a single launch), then the same bundle assembly as
        :meth:`_prepare_full` — identical denial semantics, extra-slot
        order, and reservation indices."""
        from repro_torch.kernels.slot_alloc import fused as _fused
        n = self.n_slots
        B = len(reqs)
        srcs = np.fromiter((r.src for r in reqs), np.int64, B)
        dsts = np.fromiter((r.dst for r in reqs), np.int64, B)
        fp = _fused.fused_prepare_wait(
            self._fused_start(srcs, dsts, t_readys, window))
        self._last_prepare_backend = "fused"
        denied, arr, ok = fp.denied, fp.arr, fp.ok
        want = np.fromiter(
            (0 if (r.op == "init" or denied[k]) else r.max_extra_slots
             for k, r in enumerate(reqs)), np.int64, B)
        er = ec = extra_hops = extra_ok = None
        if want.any():
            # Extra-slot bundles are rare: trace them on host against the
            # program's converged vectors (bit-identical walks).
            slots_ix = np.arange(n, dtype=np.int64)
            er, ec = np.nonzero(fp.free & (want > 0)[:, None]
                                & (slots_ix[None, :] != arr[:, None]))
            occ = self.table._ports.masks_at(window)
            extra_hops, extra_ok = _traceback_jobs(
                fp.vecs_np(), er, occ, self.mesh, n, srcs[er], dsts[er], ec)
        # One bulk .tolist() per column keeps the per-request assembly in
        # plain-python territory (per-element numpy indexing is ~10x the
        # cost of a list index at this size).
        denied_l = denied.tolist()
        ok_l = ok.tolist()
        dists_l = fp.dists.tolist()
        starts_l = fp.starts.tolist()
        tr_l = t_readys.tolist()
        hn_l = fp.hop_n.tolist()
        hp_l = fp.hop_p.tolist()
        hs_l = fp.hop_s.tolist()
        fl_l = ((fp.hop_n.astype(np.int64) * N_PORTS + fp.hop_p) * n
                + fp.hop_s).tolist()
        states: list[_Prepared] = []
        epos = 0
        for i, r in enumerate(reqs):
            if denied_l[i]:
                states.append(_Prepared(denied=True, src=r.src, dst=r.dst))
                continue
            if not ok_l[i]:
                raise RuntimeError(
                    f"no free upstream for request {r.src}->{r.dst} "
                    f"slot {int(arr[i])} (inconsistent search)")
            dist = dists_l[i]
            ln = dist + 1
            hops = list(zip(hn_l[i][:ln], hp_l[i][:ln], hs_l[i][:ln]))
            k = 1
            if er is not None:
                while epos < len(er) and er[epos] == i:
                    if k < 1 + want[i] and extra_ok[epos]:
                        hops = hops + extra_hops[epos]
                        k += 1
                    epos += 1
            n_win = (self.n_windows_for_init(r.nbytes) if r.op == "init"
                     else self.n_windows_for(r.nbytes, slots=k))
            states.append(_Prepared(
                src=r.src, dst=r.dst, start_cycle=starts_l[i],
                w_res=tr_l[i] // n, n_win=n_win,
                slots_per_window=k, distance=dist, hops=hops,
                idx=(fp.hop_n[i, :ln], fp.hop_p[i, :ln], fp.hop_s[i, :ln])
                if k == 1 else SlotTable._hops_idx(hops),
                flat=set(fl_l[i][:ln]) if k == 1 else None))
        return states

    def _prepare_one(self, r: CopyRequest, t_ready: int, vec: np.ndarray,
                     occ: np.ndarray, window: int) -> _Prepared:
        """Scalar spelling of :meth:`_prepare_full` for a single request —
        the conflict re-search / serial-allocate fast path (same slot
        choice, same trace-back order, same bundle assembly)."""
        n = self.n_slots
        avail = int(vec[r.dst]) | int(occ[r.dst, PORT_LOCAL])
        dist = self.mesh.manhattan(r.src, r.dst)
        best = None
        for a in range(n):
            if (avail >> a) & 1:
                continue
            s = (a - dist) % n
            c = t_ready + ((s - t_ready) % n)
            if best is None or c < best[0]:
                best = (c, a)
        if best is None:
            return _Prepared(denied=True, src=r.src, dst=r.dst)
        start, a = best
        hops = traceback(vec, occ, self.mesh, n, r.src, r.dst, a)
        k = 1
        if r.max_extra_slots and r.op != "init":
            for a2 in range(n):
                if k >= 1 + r.max_extra_slots:
                    break
                if a2 == a or not bit_is_free(avail, a2):
                    continue
                try:
                    hops = hops + traceback(vec, occ, self.mesh, n, r.src,
                                            r.dst, a2)
                except RuntimeError:
                    continue
                k += 1
        n_win = (self.n_windows_for_init(r.nbytes) if r.op == "init"
                 else self.n_windows_for(r.nbytes, slots=k))
        return _Prepared(
            src=r.src, dst=r.dst, start_cycle=start, w_res=t_ready // n,
            n_win=n_win, slots_per_window=k, distance=dist, hops=hops,
            idx=SlotTable._hops_idx(hops),
            flat={(hn * N_PORTS + hp) * n + hs for hn, hp, hs in hops}
            if k == 1 else None)

    def _prepare_full(self, reqs, t_readys, vecs, rows, occ, window,
                      srcs=None, dsts=None) -> list[_Prepared]:
        """The full-mesh post-search pipeline over one round's converged
        vectors: vectorized slot choice, batched trace-back of the chosen
        arrival slot *and* every extra-slot candidate, bundle assembly."""
        n = self.n_slots
        B = len(reqs)
        if B == 1:
            return [self._prepare_one(reqs[0], int(t_readys[0]),
                                      vecs[int(rows[0])], occ, window)]
        coords = self.mesh.coord_array
        if srcs is None:
            srcs = np.fromiter((r.src for r in reqs), np.int64, B)
            dsts = np.fromiter((r.dst for r in reqs), np.int64, B)
        dists = np.abs(coords[srcs] - coords[dsts]).sum(1)
        avail = vecs[rows, dsts] | occ[dsts, PORT_LOCAL]
        starts, arr, free, denied = _best_slots_np(avail, dists, t_readys, n)
        want = np.fromiter(
            (0 if (r.op == "init" or denied[k]) else r.max_extra_slots
             for k, r in enumerate(reqs)), np.int64, B)
        main_rows = np.nonzero(~denied)[0]
        slots_ix = np.arange(n, dtype=np.int64)
        er, ec = np.nonzero(free & (want > 0)[:, None]
                            & (slots_ix[None, :] != arr[:, None]))
        job_req = np.concatenate([main_rows, er])
        job_slot = np.concatenate([arr[main_rows], ec])
        jobs_hops, ok = _traceback_jobs(
            vecs, rows[job_req], occ, self.mesh, n,
            srcs[job_req], dsts[job_req], job_slot)
        main_pos = {int(r): k for k, r in enumerate(main_rows)}
        states: list[_Prepared] = []
        n_main = len(main_rows)
        epos = 0                   # cursor into the extra jobs (row-major)
        for i, r in enumerate(reqs):
            if denied[i]:
                states.append(_Prepared(denied=True, src=r.src, dst=r.dst))
                continue
            mj = main_pos[i]
            if not ok[mj]:
                raise RuntimeError(
                    f"no free upstream for request {r.src}->{r.dst} "
                    f"slot {int(arr[i])} (inconsistent search)")
            hops = jobs_hops[mj]
            k = 1
            while epos < len(er) and er[epos] == i:
                jid = n_main + epos
                if k < 1 + want[i] and ok[jid]:
                    hops = hops + jobs_hops[jid]
                    k += 1
                epos += 1
            # A shortest-path bundle cannot double-book itself: nodes are
            # distinct along one path, and two paths at the same (node,
            # port) sit at the same distance from dst, so distinct arrival
            # slots give distinct slots there — no dup check needed.
            n_win = (self.n_windows_for_init(r.nbytes) if r.op == "init"
                     else self.n_windows_for(r.nbytes, slots=k))
            states.append(_Prepared(
                src=r.src, dst=r.dst, start_cycle=int(starts[i]),
                w_res=int(t_readys[i]) // n, n_win=n_win, slots_per_window=k,
                distance=int(dists[i]), hops=hops,
                idx=SlotTable._hops_idx(hops),
                flat={(hn * N_PORTS + hp) * n + hs for hn, hp, hs in hops}
                if k == 1 else None))
        return states

    # -- commit (host-side, arrival order) ------------------------------------
    def _commit_prepared(self, st: _Prepared, window: int,
                         validate: bool = True):
        """Reserve one prepared circuit against the live table.  Returns
        the Circuit, None (mesh saturated), or _CONFLICT when a commit
        made after the state's search claimed one of its resources.

        ``validate=False`` skips the live-table freshness check — sound
        when the state is *clean* (no resource claimed since its search
        intersects its shortest-path box, so its chosen hops are
        untouched) or freshly re-searched.  Validation runs against the
        snapshot ``window`` (conservative: it is never later than the
        request's own window), but the reservation anchors at the
        request's ready window (``w_res``) so a cycle-anchored request
        holds its slots for its actual streaming interval — exactly what
        serial ``allocate`` at that cycle would reserve."""
        if st.denied:
            return None
        if st.conflict or st.dup:
            return _CONFLICT
        table = self.table
        if validate:
            if (table.expiry[st.idx] > window).any():
                return _CONFLICT
            if st.bus_slots:
                for col, bslot in st.bus_slots:
                    if table.bus_expiry[col, bslot] > window:
                        return _CONFLICT
        elif (table.expiry[st.idx] > window).any():
            # Backstop for the analytical clean-commit invariant: a chosen
            # hop outside a request's shortest-path box (impossible today)
            # must fail loudly, not silently double-book.
            raise RuntimeError("double booking")
        # A reduce bundle repeats the (dst, LOCAL) prefix across its
        # arrival + dwell slots — unique=True's buffered fancy |= would
        # drop bits there, so fan-ins take the duplicate-safe path.
        table._ports.reserve_arrays(st.idx, st.w_res + st.n_win,
                                    unique=(st.slots_per_window == 1
                                            and not st.reduce))
        if st.bus_slots:
            for col, bslot in st.bus_slots:
                table.reserve_bus(col, bslot, st.w_res, st.n_win)
        return Circuit(src=st.src, dst=st.dst, start_cycle=st.start_cycle,
                       n_windows=st.n_win, hops=st.hops,
                       slots_per_window=st.slots_per_window,
                       uses_bus=st.uses_bus, bus_column=st.bus_column,
                       distance=st.distance, _n_slots_hint=self.n_slots,
                       srcs=st.srcs)


class TdmAllocatorLight(TdmAllocator):
    """NoM-Light: no dedicated Z links; vertical movement rides the existing
    per-vault TSV bus — single-cycle multi-hop, but one transfer per column
    per slot (Section 2.3).

    Routes are XY-monotone on one layer plus at most one bus hop.  We search
    both phase orders (XY-then-bus, bus-then-XY) — both ride the same
    vectorized pass as the rest of the batch — and keep the earlier.  The
    post-search pipeline is shared with the full-mesh allocator: same-layer
    requests go through :meth:`_prepare_full` unchanged, and cross-layer
    requests batch every candidate arrival slot of both phase orders
    through the same :func:`traceback_batch` call."""

    # Cross-layer routes carry bus hops the struct-of-arrays wave commit
    # does not model — every NoM-Light wave takes the generic loop.
    _wave_fast = False

    def _reprepare_conflict(self, req, t_ready, window):
        # Cross-layer routes need the bus-aware two-phase prepare; the
        # full-mesh scalar fast path does not apply here.  (The shared
        # _prepare_states split still routes fan-ins to _prepare_reduce.)
        return self._prepare_states([req], t_ready, window)[0]

    def _prepare_reduce(self, r, t_ready, occ, window):
        # Fan-in routes are XY-monotone single-layer circuits; a
        # cross-layer operand would need a bus hop the reduce search does
        # not model — reject loudly rather than route over absent Z links.
        coords = self.mesh.coord_array
        if any(int(coords[int(s)][2]) != int(coords[r.dst][2])
               for s in r.srcs):
            raise ValueError(
                "NoM-Light reduce requires same-layer sources (vertical "
                "operands must ride the TSV bus as explicit copies first)")
        return super()._prepare_reduce(r, t_ready, occ, window)

    def _prepare_copy_states(self, reqs, t_readys, window):
        if not reqs:
            return []
        mesh, n = self.mesh, self.n_slots
        occ = self.table._ports.masks_at(window)
        bus = self.table._bus.masks_at(window)
        coords = mesh.coord_array
        # One search entry per same-layer request; two (order A: src->w on
        # the source layer; order B: w2->dst on the dest layer, injected
        # through the source column's bus availability) per cross-layer one.
        e_src, e_dst, e_init = [], [], []
        meta = []                 # per request: row (same-layer) | (rowA, rowB)
        for r in reqs:
            sx, sy, sz = coords[r.src]
            dx, dy, dz = coords[r.dst]
            if sz == dz:
                meta.append(int(len(e_src)))
                e_src.append(r.src)
                e_dst.append(r.dst)
                e_init.append(0)
            else:
                w = mesh.node_id(int(dx), int(dy), int(sz))   # A: XY first
                w2 = mesh.node_id(int(sx), int(sy), int(dz))  # B: bus first
                init = rotr_np(np.uint32(int(bus[mesh.column_of(r.src)])), n)
                meta.append((len(e_src), w, w2))
                e_src += [r.src, w2]
                e_dst += [w, r.dst]
                e_init += [0, int(init)]
        vecs = self._run_search(occ, window, np.asarray(e_src, np.int64),
                                np.asarray(e_dst, np.int64),
                                np.asarray(e_init, np.uint32))
        # Same-layer subset: the full-mesh pipeline on its own vec rows.
        same_ix = [i for i, m in enumerate(meta) if isinstance(m, int)]
        same_states = iter(self._prepare_full(
            [reqs[i] for i in same_ix], t_readys[same_ix], vecs,
            np.asarray([meta[i] for i in same_ix], np.int64), occ, window,
            ) if same_ix else [])

        # Cross-layer subset, vectorized over requests.
        cross_ix = [i for i, m in enumerate(meta) if not isinstance(m, int)]
        cross = self._prepare_cross(reqs, t_readys, meta, cross_ix, vecs,
                                    occ, bus, window)
        return [next(same_states) if isinstance(m, int) else cross[i]
                for i, m in enumerate(meta)]

    def _prepare_cross(self, reqs, t_readys, meta, cross_ix, vecs, occ, bus,
                       window) -> dict[int, _Prepared]:
        mesh, n = self.mesh, self.n_slots
        out: dict[int, _Prepared] = {}
        if not cross_ix:
            return out
        coords = mesh.coord_array
        B = len(cross_ix)
        srcs = np.fromiter((reqs[i].src for i in cross_ix), np.int64, B)
        dsts = np.fromiter((reqs[i].dst for i in cross_ix), np.int64, B)
        rowsA = np.fromiter((meta[i][0] for i in cross_ix), np.int64, B)
        w_nodes = np.fromiter((meta[i][1] for i in cross_ix), np.int64, B)
        w2_nodes = np.fromiter((meta[i][2] for i in cross_ix), np.int64, B)
        dist_xy = (np.abs(coords[srcs][:, :2] - coords[dsts][:, :2])).sum(1)
        total = dist_xy + 1       # bus = one slot regardless of layer count
        colw = np.fromiter((mesh.column_of(int(w)) for w in w_nodes),
                           np.int64, B)
        cols = np.fromiter((mesh.column_of(int(s)) for s in srcs),
                           np.int64, B)
        t_sub = t_readys[cross_ix]
        availA = (rotr_np(vecs[rowsA, w_nodes] | bus[colw], n)
                  | occ[dsts, PORT_LOCAL])
        availB = vecs[rowsA + 1, dsts] | occ[dsts, PORT_LOCAL]
        cA, aA, freeA, denA = _best_slots_np(availA, total, t_sub, n)
        cB, aB, freeB, denB = _best_slots_np(availB, total, t_sub, n)
        useB = cB < cA            # strict: order A wins ties, as the serial scan
        a0 = np.where(useB, aB, aA)
        starts = np.where(useB, cB, cA)
        denied = denA & denB
        free = np.where(useB[:, None], freeB, freeA)
        # Candidate arrival slots per request: the chosen slot first, then
        # every other free slot ascending (the serial bundle order);
        # trace-back jobs only exist for XY distance > 0.
        jobs_src, jobs_dst, jobs_slot, jobs_row = [], [], [], []
        cand_jobs: list[list] = []   # per request: [(slot, job_id | None)]
        for k in range(B):
            cands = []
            if not denied[k]:
                # Every free slot stays a candidate (chosen slot first, the
                # rest ascending): a trace-back can fail on any of them, and
                # the bundle takes the first 1+max_extra that succeed.
                order = [int(a0[k])] + [s for s in range(n)
                                        if s != a0[k] and free[k, s]]
                for a in order:
                    jid = None
                    if dist_xy[k]:
                        jid = len(jobs_src)
                        if useB[k]:
                            jobs_src.append(int(w2_nodes[k]))
                            jobs_dst.append(int(dsts[k]))
                            jobs_slot.append(a)
                            jobs_row.append(int(rowsA[k] + 1))
                        else:
                            jobs_src.append(int(srcs[k]))
                            jobs_dst.append(int(w_nodes[k]))
                            jobs_slot.append((a - 1) % n)
                            jobs_row.append(int(rowsA[k]))
                    cands.append((a, jid))
            cand_jobs.append(cands)
        jobs_hops, ok = _traceback_jobs(
            vecs, np.asarray(jobs_row, np.int64), occ, mesh, n,
            np.asarray(jobs_src, np.int64), np.asarray(jobs_dst, np.int64),
            np.asarray(jobs_slot, np.int64))
        for k, i in enumerate(cross_ix):
            r = reqs[i]
            if denied[k]:
                out[i] = _Prepared(denied=True, src=r.src, dst=r.dst)
                continue
            picked = []           # [(hops, (bus_col, bus_slot))]
            for a, jid in cand_jobs[k]:
                if len(picked) >= 1 + r.max_extra_slots:
                    break
                if jid is not None and not ok[jid]:
                    continue
                if useB[k]:
                    hops = (jobs_hops[jid] if jid is not None
                            else [(int(dsts[k]), PORT_LOCAL, a)])
                    buspair = (int(cols[k]), (a - int(total[k])) % n)
                else:
                    hops_xy = (jobs_hops[jid][:-1] if jid is not None else [])
                    hops = hops_xy + [(int(dsts[k]), PORT_LOCAL, a)]
                    buspair = (int(colw[k]), (a - 1) % n)
                picked.append((hops, buspair))
            if not picked:
                out[i] = _Prepared(conflict=True, src=r.src, dst=r.dst)
                continue
            hops = [h for hs, _b in picked for h in hs]
            bus_slots = [b for _h, b in picked]
            idx = SlotTable._hops_idx(hops)
            keys = (idx[0] * N_PORTS + idx[1]) * n + idx[2]
            dup = (np.unique(keys).size < keys.size
                   or len({b for b in bus_slots}) < len(bus_slots))
            out[i] = _Prepared(
                src=r.src, dst=r.dst, start_cycle=int(starts[k]),
                w_res=int(t_sub[k]) // n,
                n_win=self.n_windows_for(r.nbytes, slots=len(picked)),
                slots_per_window=len(picked), distance=int(total[k]),
                hops=hops, idx=idx, dup=dup, uses_bus=True,
                bus_column=picked[0][1][0], bus_slots=bus_slots)
        return out


# ---------------------------------------------------------------------------
# Cross-stack circuits (two-phase segmented allocation)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class StackedCircuit:
    """A committed cross-stack circuit through a :class:`StackedTopology`.

    Three reserved segments stream in lock step: the *near* segment
    (``src`` to the near stack's bridge bank, ejecting into the SerDes TX
    buffer through the bridge's LOCAL port), one TDM slot on every
    directed SerDes channel along the stack route, and the *far* segment
    (far bridge to ``dst``).  Intermediate stacks forward bridge-to-bridge
    on the logic die — their meshes are never traversed.  All segments
    hold their slots for the same ``n_windows`` (the stream runs at the
    bottleneck link's byte rate end to end).
    """

    src: tuple[int, int]      # (stack, local node)
    dst: tuple[int, int]
    start_cycle: int          # absolute cycle of source injection
    n_windows: int
    near_hops: list[tuple[int, int, int]]   # (node, port, slot), near stack
    far_hops: list[tuple[int, int, int]]    # (node, port, slot), far stack
    link_slots: list[tuple[int, int]]       # (channel, slot) per SerDes hop
    distance: int             # beat latency src -> dst, SerDes legs included
    slots_per_window: int = 1
    uses_bus: bool = False
    bus_column: int = -1
    _n_slots_hint: int = 16

    @property
    def cross_stack(self) -> bool:
        return True

    @property
    def hops(self) -> list[tuple[int, int, int]]:
        """Mesh hops of both segments (near then far) — SerDes hops are in
        ``link_slots``; node ids are stack-local."""
        return list(self.near_hops) + list(self.far_hops)

    @property
    def arrival_cycle(self) -> int:
        return self.start_cycle + self.distance

    @property
    def end_cycle(self) -> int:
        return self.arrival_cycle + (self.n_windows - 1) * self._n_slots_hint


class SegmentedAllocator:
    """Two-phase cross-stack circuit allocation over per-stack allocators.

    Phase 1 (the near stack's authority): wavefront-search ``src`` to the
    near bridge, walk candidate bridge-arrival slots in earliest-start
    order, and for the first whose SerDes channel chain is free reserve
    the near hops *and* the channel slots.  Phase 2 (the far authority):
    search far bridge -> ``dst`` with the injection slot pinned to the one
    the link chain delivers; a conflict on the far side *rolls back* the
    near-side reservation (restoring the exact prior expiries) and the
    next candidate slot is tried.  Either the whole segmented circuit
    commits or no slot-table state changes at all.

    Slot arithmetic: a beat arriving at the near bridge on slot ``a``
    enters the first channel on ``(a + 1) % n``; each SerDes hop advances
    the slot by ``1 + latency``; the far injection slot is therefore
    ``(a + T) % n`` with ``T = sum(1 + latency_k)``.
    """

    def __init__(self, topology: StackedTopology, allocators: list,
                 n_slots: int = 16):
        if len(allocators) != topology.n_stacks:
            raise ValueError(f"{len(allocators)} allocators for "
                             f"{topology.n_stacks} stacks")
        self.topology = topology
        self.allocators = list(allocators)
        self.n_slots = n_slots
        # One TDM slot resource per directed SerDes channel, same expiry
        # discipline as router ports.
        self.links = _PackedExpiry((max(1, topology.n_channels),), n_slots)
        self.rollbacks = 0        # phase-2 aborts (near side rolled back)
        self.denied = 0           # requests with no committable candidate
        self.link_windows = 0     # SerDes (channel, slot)-windows reserved

    def bottleneck_bytes(self, src_stack: int, dst_stack: int) -> int:
        """Bytes one circuit moves per TDM window src -> dst: the minimum
        of the two mesh link widths and every SerDes link on the route."""
        widths = [self.allocators[src_stack].link_bytes,
                  self.allocators[dst_stack].link_bytes]
        widths += [self.topology.links[c // 2].link_bytes
                   for c in self.topology.route_channels(src_stack, dst_stack)]
        return min(widths)

    def allocate(self, src: tuple[int, int], dst: tuple[int, int],
                 nbytes: int, cycle: int) -> StackedCircuit | None:
        """Reserve the earliest cross-stack circuit, or None (no leaked
        state) when every candidate slot fails phase 2."""
        topo, n = self.topology, self.n_slots
        (sa, s_loc), (sb, d_loc) = src, dst
        if sa == sb:
            raise ValueError("SegmentedAllocator is for cross-stack traffic; "
                             "same-stack requests go to the stack's own CCU")
        near, far = self.allocators[sa], self.allocators[sb]
        mesh_a, mesh_b = topo.stacks[sa], topo.stacks[sb]
        bridge_a, bridge_b = topo.bridge_of(sa), topo.bridge_of(sb)
        chans = topo.route_channels(sa, sb)
        lats = [topo.links[c // 2].latency for c in chans]
        t_ready = cycle + 3                      # the CCU's 3-cycle setup
        window = t_ready // n
        n_win = max(1, -(-nbytes // self.bottleneck_bytes(sa, sb)))
        fm = full_mask(n)
        # Snapshot (copy) the masks: reserve_arrays mutates the live cache
        # in place, and a phase-2 rollback must leave the candidate loop
        # reading the pre-reservation availability.
        occ_a = near.table._ports.masks_at(window).copy()
        dist_a = mesh_a.manhattan(s_loc, bridge_a)
        if s_loc == bridge_a:
            vec_a = None
            avail_a = int(occ_a[bridge_a, PORT_LOCAL])
        else:
            vec_a = _wavefront_host(occ_a, mesh_a, n, s_loc, bridge_a, 0)
            avail_a = int(vec_a[bridge_a]) | int(occ_a[bridge_a, PORT_LOCAL])
        link_masks = self.links.masks_at(window).copy()
        dist_b = mesh_b.manhattan(bridge_b, d_loc)
        T = sum(1 + lat for lat in lats)
        # Bridge-arrival candidates in earliest-injection order (same
        # (start, slot) order the single-stack slot choice uses).
        def _start(a: int) -> int:
            s_inj = (a - dist_a) % n
            return t_ready + ((s_inj - t_ready) % n)
        cands = sorted((a for a in range(n) if bit_is_free(avail_a, a)),
                       key=lambda a: (_start(a), a))
        committed = False
        for a in cands:
            chain, s, free = [], (a + 1) % n, True
            for c, lat in zip(chans, lats):
                if not bit_is_free(int(link_masks[c]), s):
                    free = False
                    break
                chain.append((c, s))
                s = (s + 1 + lat) % n
            if not free:
                continue
            s_far = (a + T) % n
            # -- phase 1: the near authority reserves hops + channel slots.
            near_hops = ([(bridge_a, PORT_LOCAL, a)] if s_loc == bridge_a
                         else traceback(vec_a, occ_a, mesh_a, n, s_loc,
                                        bridge_a, a))
            idx_a = SlotTable._hops_idx(near_hops)
            prev_a = near.table._ports.expiry[idx_a].copy()
            near.table._ports.reserve_arrays(idx_a, window + n_win)
            idx_l = (np.fromiter((c for c, _ in chain), np.int64, len(chain)),
                     np.fromiter((sl for _, sl in chain), np.int64,
                                 len(chain)))
            prev_l = self.links.expiry[idx_l].copy()
            self.links.reserve_arrays(idx_l, window + n_win)
            # -- phase 2: the far authority tries to commit.  Injection is
            # pinned: only s_far is free in the init vector, so any circuit
            # the search finds leaves the far bridge exactly when the link
            # chain delivers the beat.
            occ_b = far.table._ports.masks_at(window)
            far_hops = None
            if d_loc == bridge_b:
                if bit_is_free(int(occ_b[bridge_b, PORT_LOCAL]), s_far):
                    far_hops = [(bridge_b, PORT_LOCAL, s_far)]
            else:
                init = fm ^ (1 << s_far)
                vec_b = _wavefront_host(occ_b, mesh_b, n, bridge_b, d_loc,
                                        init)
                a_far = (s_far + dist_b) % n
                if bit_is_free(int(vec_b[d_loc]) | int(occ_b[d_loc,
                                                             PORT_LOCAL]),
                               a_far):
                    far_hops = traceback(vec_b, occ_b, mesh_b, n, bridge_b,
                                         d_loc, a_far)
            if far_hops is None:
                near.table._ports.release_arrays(idx_a, prev_a)
                self.links.release_arrays(idx_l, prev_l)
                self.rollbacks += 1
                continue
            idx_b = SlotTable._hops_idx(far_hops)
            far.table._ports.reserve_arrays(idx_b, window + n_win)
            self.link_windows += n_win * len(chain)
            committed = True
            return StackedCircuit(
                src=src, dst=dst, start_cycle=_start(a), n_windows=n_win,
                near_hops=near_hops, far_hops=far_hops, link_slots=chain,
                distance=dist_a + T + dist_b, _n_slots_hint=n)
        if not committed:
            self.denied += 1
        return None
