"""Transfer-request vocabulary (port of ``repro.core.scheduler``).

This module holds the *data layer* of the scheduler: the backend-agnostic
:class:`TransferRequest`, the :class:`ScheduleReport` telemetry record,
and the normalization helpers shared by both backends.  The *authority*
that schedules them is :class:`repro_torch.core.fabric.NomFabric` — a
stateful session owning the topology, the allocator, the packing-policy
registry, and a bounded admission queue.

The reference's deprecated ``schedule_transfers`` shim is not ported:
hold a ``NomFabric`` and call its ``schedule``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .nom_collectives import Transfer, TransferPlan, plan_transfers  # noqa: F401  (re-export)
from .slot_alloc import AllocResult, CopyRequest, TdmAllocator


@dataclasses.dataclass(frozen=True)
class TransferRequest:
    """One pending bulk transfer, backend-agnostic.

    This is the lingua franca of :meth:`NomFabric.schedule`: the serving
    engine emits its per-decode-step cache movement as TransferRequests,
    the MoE planner its expert-dispatch blocks, reshard its shard moves.

    Attributes:
      src, dst: endpoint ids.  Bank level (tdm backend): int node ids on
        the :class:`~repro_torch.core.topology.Mesh3D`.  Device level (rounds
        backend): coordinate tuples on the device mesh; a bare int is
        promoted to a 1-D ring coordinate ``(int,)``.
      nbytes: payload size in bytes (default 1).  Determines how many TDM
        windows a bank-level circuit persists (8 bytes/slot-cycle on the
        paper's 64-bit links).
      tag: opaque caller label (cache-leaf path, parameter name, expert
        pair) carried through to the plan for attribution.
      max_extra_slots: bank level only — extra free TDM slots the CCU may
        bundle to accelerate this transfer (paper Section 2.1; default 0).
      cycle: bank level only — anchor this request later than the batch
        cycle (e.g. its source read completes later); default None
        (anchored at the batch cycle).
      op: ``"copy"`` (default) streams ``nbytes`` from ``src`` to ``dst``;
        ``"init"`` is INIT-class bulk initialization *in place* (requires
        ``src == dst``) — ring-buffer overwrites, eviction scrubs, page
        zeroing.  On the tdm backend an INIT becomes a *zero-hop* circuit
        occupying only the bank's LOCAL port while rows clear in-DRAM
        (RowClone-FPM); on the rounds backend it is a local no-route
        transfer.  Either way it shares the batch's admission order and
        shows up in :attr:`ScheduleReport.n_init`.
      src_stack, dst_stack: two-level addressing for a
        :class:`~repro_torch.core.fabric.FabricCluster` — the stack each
        endpoint's (then stack-local) node id lives in.  ``None`` (the
        default) means ``src``/``dst`` are flat ids: plain node ids on a
        single-stack fabric, global ids (see
        :meth:`~repro_torch.core.topology.StackedTopology.global_id`) on a
        cluster.  Single-stack fabrics ignore these fields.
      srcs: compute-class fan-in only (``op="reduce"``): the N source
        banks whose operands are combined at ``dst``.  ``src`` mirrors
        ``srcs[0]`` for backend compatibility.  Build these through
        :func:`reduce_request`.
    """
    src: object
    dst: object
    nbytes: int = 1
    tag: object = None
    max_extra_slots: int = 0
    cycle: int | None = None
    op: str = "copy"
    src_stack: int | None = None
    dst_stack: int | None = None
    srcs: tuple = ()


def reduce_request(srcs, dst, nbytes: int = 1, **kw) -> TransferRequest:
    """Build a compute-class fan-in request: combine one ``nbytes``
    operand from each bank in ``srcs`` at ``dst`` (``op="reduce"``).

    This is the one sanctioned constructor for multi-source requests —
    the planners ``nom_reduce``/``nom_allreduce_banks`` come through
    here.  Sources must be pairwise
    distinct and must not include the destination: the destination bank
    holds the accumulator, it contributes its resident operand for free.
    """
    def _endpoint(e):
        # flat bank id, or a tuple endpoint ((stack, node) on a cluster,
        # device coords on the rounds backend — rejected at schedule()).
        return (tuple(int(v) for v in e) if isinstance(e, (tuple, list))
                else int(e))

    srcs = tuple(_endpoint(s) for s in srcs)
    if not srcs:
        raise ValueError("reduce_request needs at least one source bank")
    if len(set(srcs)) != len(srcs):
        raise ValueError(f"reduce sources must be distinct: {srcs}")
    dst = _endpoint(dst)
    dst_stack = kw.get("dst_stack")
    src_stack = kw.get("src_stack")
    if src_stack is None and dst_stack is None:
        if dst in srcs:
            raise ValueError(
                f"reduce destination {dst} is already a source "
                "(the accumulator bank contributes in place)")
    return TransferRequest(src=srcs[0], dst=dst, nbytes=nbytes,
                           op="reduce", srcs=srcs, **kw)


@dataclasses.dataclass
class ScheduleReport:
    """Telemetry of one :meth:`NomFabric.schedule` call.

    Attributes:
      backend: ``"tdm"`` (bank-level :class:`TdmAllocator` circuits) or
        ``"rounds"`` (device-level DOR round packing).
      n_requests: requests submitted in this batch.
      n_scheduled: requests that received a circuit/route (the rest were
        denied — mesh saturated at every retry slot).
      n_windows: TDM windows (tdm) / rounds (rounds) the schedule spans —
        the makespan in scheduler time units.
      max_inflight: peak concurrent circuits in one window/round — the
        paper's "concurrent transfer" evidence; 1 means serialized.
      avg_inflight: mean in-flight circuits over non-empty windows/rounds.
      stall_cycles: total cycles (tdm; TDM-slot cycles) or rounds (rounds
        backend) that requests waited beyond their earliest possible start
        because slots/links were taken — queueing delay under contention.
      search_rounds: vectorized wavefront passes issued (tdm backend).
      conflicts: stale-snapshot commit retries (tdm backend).
      n_searched: per-request searches summed over all passes (tdm
        backend) — with conflict-scoped re-search this stays near
        ``n_requests + conflicts``; tail-wide retries would grow it
        quadratically with the batch.
      n_init: INIT-class requests (``op="init"``) in this batch — the
        eviction/initialization share of the traffic.
      n_reduce: compute-class requests (``op="reduce"``, fan-in
        circuits) in this batch — the in-memory combine share.
      n_cross_stack: requests whose endpoints live in different stacks of
        a :class:`~repro_torch.core.topology.StackedTopology` (scheduled as
        two-phase segmented circuits by a ``FabricCluster``); 0 on every
        single-stack fabric.
      fused_waves: prepare rounds served by the fused prepare kernel
        (tdm backend) — the allocator's per-wave backend telemetry.
      host_waves: prepare rounds served by the split host pipeline (tiny
        rounds, conflict re-searches, ``backend="host"`` allocators).
    """
    backend: str               # "tdm" | "rounds"
    n_requests: int
    n_scheduled: int
    n_windows: int             # TDM windows (tdm) / rounds (rounds) spanned
    max_inflight: int          # peak concurrent circuits in one window
    avg_inflight: float        # mean over non-empty windows
    stall_cycles: int = 0      # waits beyond the earliest possible start
    search_rounds: int = 0     # vectorized search passes (tdm backend)
    conflicts: int = 0         # stale-snapshot retries (tdm backend)
    n_searched: int = 0        # per-request searches over all passes (tdm)
    n_init: int = 0            # INIT-class (op="init") requests in the batch
    n_reduce: int = 0          # compute-class (op="reduce") requests
    n_cross_stack: int = 0     # cross-stack requests (FabricCluster only)
    fused_waves: int = 0       # prepare rounds served by the fused program
    host_waves: int = 0        # prepare rounds served by the host pipeline
    agg_windows: int = 0       # windows folded into avg_inflight by merge()
    #   (0 on a fresh report: its own n_windows is the weight)

    def merge(self, other: "ScheduleReport") -> "ScheduleReport":
        """Accumulate another report of the same backend (telemetry over a
        sequence of batches, e.g. one serving step after another).
        ``avg_inflight`` stays the mean over all underlying non-empty
        windows (weights tracked in ``agg_windows``); ``n_windows`` keeps
        the largest single-batch makespan."""
        if self.backend != other.backend:
            raise ValueError(f"cannot merge a {other.backend!r} report into "
                             f"a {self.backend!r} one")
        wa = self.agg_windows or self.n_windows
        wb = other.agg_windows or other.n_windows
        num = self.avg_inflight * wa + other.avg_inflight * wb
        return ScheduleReport(
            backend=self.backend,
            n_requests=self.n_requests + other.n_requests,
            n_scheduled=self.n_scheduled + other.n_scheduled,
            n_windows=max(self.n_windows, other.n_windows),
            max_inflight=max(self.max_inflight, other.max_inflight),
            avg_inflight=num / (wa + wb) if wa + wb else 0.0,
            stall_cycles=self.stall_cycles + other.stall_cycles,
            search_rounds=self.search_rounds + other.search_rounds,
            conflicts=self.conflicts + other.conflicts,
            n_searched=self.n_searched + other.n_searched,
            n_init=self.n_init + other.n_init,
            n_reduce=self.n_reduce + other.n_reduce,
            n_cross_stack=self.n_cross_stack + other.n_cross_stack,
            fused_waves=self.fused_waves + other.fused_waves,
            host_waves=self.host_waves + other.host_waves,
            agg_windows=wa + wb)


def _as_copy_requests(transfers) -> list[CopyRequest]:
    """Normalize bank-level input: CopyRequest | TransferRequest | tuple."""
    out = []
    for t in transfers:
        if isinstance(t, CopyRequest):
            out.append(t)
        elif isinstance(t, TransferRequest):
            out.append(CopyRequest(int(t.src), int(t.dst), t.nbytes,
                                   max_extra_slots=t.max_extra_slots,
                                   cycle=t.cycle, op=t.op,
                                   srcs=tuple(int(s) for s in t.srcs)))
        else:
            out.append(CopyRequest(*t))
    return out


def _coord(v) -> tuple[int, ...]:
    return tuple(v) if isinstance(v, (tuple, list)) else (int(v),)


def _as_transfers(transfers) -> list[Transfer]:
    """Normalize device-level input: Transfer | TransferRequest | tuple."""
    out = []
    for t in transfers:
        if isinstance(t, Transfer):
            out.append(t)
        elif isinstance(t, TransferRequest):
            out.append(Transfer(src=_coord(t.src), dst=_coord(t.dst),
                                nbytes=t.nbytes, tag=t.tag))
        else:
            out.append(Transfer(*t))
    return out


def window_occupancy(circuits, n_slots: int) -> tuple[int, int, float]:
    """The reference's window-occupancy histogram, summarised: a circuit
    holds its slots for ``n_windows`` consecutive windows from its
    streaming window (``start_cycle // n_slots``); circuits anchored at
    different cycles are not stacked onto one window.  Returns (span of
    windows from the earliest start, the most circuits live in one
    window, their mean over the windows where any is live).

    The reference fills one counter per window of the span, so a
    multi-megabyte circuit (a full-width cache leaf) costs millions of
    counters.  Here the count is a step function over the sorted circuit
    boundaries, O(circuits log circuits).  The results are the same
    numbers: the mean is an exact integer total over an exact count, one
    correctly rounded division, as numpy's mean of the int64 histogram
    (every partial sum an integer below 2**53)."""
    if not circuits:
        return 0, 0, 0.0
    starts = np.array([c.start_cycle // n_slots for c in circuits], np.int64)
    ends = starts + np.array([c.n_windows for c in circuits], np.int64)
    span = int((ends - starts.min()).max())
    edges, inv = np.unique(np.concatenate([starts, ends]),
                           return_inverse=True)
    step = np.zeros(len(edges), np.int64)
    np.add.at(step, inv, np.repeat(np.array([1, -1], np.int64), len(starts)))
    live = np.cumsum(step)[:-1]          # circuits live in [edge, next edge)
    width = np.diff(edges)
    busy = live > 0
    n_busy = int(width[busy].sum())
    if not n_busy:
        return span, 0, 0.0
    total = int((live[busy] * width[busy]).sum())
    return span, int(live[busy].max()), total / n_busy


def _tdm_report(alloc: TdmAllocator, reqs: list[CopyRequest],
                results: list[AllocResult], cycle: int) -> ScheduleReport:
    circuits = [r.circuit for r in results if r.circuit is not None]
    span, max_inflight, avg_inflight = window_occupancy(circuits,
                                                        alloc.n_slots)
    # Queueing delay: injection happens at start_cycle; the earliest a
    # request could inject is its anchor + the 3-cycle CCU setup pipeline.
    stall = 0
    for rq, res in zip(reqs, results):
        if res.circuit is None:
            continue
        anchor = max(rq.cycle if rq.cycle is not None else cycle, cycle) + 3
        stall += max(0, res.circuit.start_cycle - anchor)
    rep = alloc.last_report
    return ScheduleReport(
        backend="tdm", n_requests=len(results), n_scheduled=len(circuits),
        n_windows=span, max_inflight=max_inflight, avg_inflight=avg_inflight,
        stall_cycles=stall,
        search_rounds=rep.search_rounds, conflicts=rep.conflicts,
        n_searched=rep.n_searched,
        n_init=sum(1 for rq in reqs if rq.op == "init"),
        n_reduce=sum(1 for rq in reqs if rq.op == "reduce"),
        fused_waves=rep.fused_waves, host_waves=rep.host_waves)


__all__ = ["CopyRequest", "ScheduleReport", "Transfer", "TransferPlan",
           "TransferRequest", "reduce_request"]
