"""`NomFabric`: the stateful session API for all NoM traffic (port of
``repro.core.fabric``).

The paper's premise is that the memory controller sets up TDM circuits
*centrally*: one authority owns the topology, the slot tables, and the
arbitration policy, and every consumer negotiates with it.  This module
is that authority as a library object: a :class:`NomFabric` is a
long-lived session that owns

* the **topology** and its allocator — a
  :class:`~repro_torch.core.slot_alloc.TdmAllocator` over a
  :class:`~repro_torch.core.topology.Mesh3D` (bank level,
  ``backend="tdm"``; its search and prepare kernels run on ``device``)
  or a device mesh/torus routed by
  :func:`~repro_torch.core.nom_collectives.plan_transfers` (device
  level, ``backend="rounds"``, host only);
* a named **packing-policy registry** (:func:`register_policy`) —
  ``"arrival"`` (the CCU's FIFO commit rule) and ``"longest_first"``
  (descending route distance, best packing) ship registered; new
  policies are addable without touching core;
* a bounded **admission queue** (:class:`AdmissionQueue` — the CCU's
  request buffering, previously private to the memory simulator) with
  configurable ``"shed"`` / ``"block"`` / ``"raise"`` overflow behavior;
* cumulative :class:`~repro_torch.core.scheduler.ScheduleReport` telemetry
  over the session's lifetime, and a ``policy="auto"`` mode that picks
  the packing policy *and* the effective queue depth per workload from
  the observed ``stall_cycles`` history (the controller-side arbitration
  state that the HMC NoC studies identify as what determines throughput
  under concurrency).

:class:`FabricCluster` holds one such fabric per stack of a
:class:`~repro_torch.core.topology.StackedTopology` and negotiates
cross-stack circuits and reduce trees between them.  See
``docs/fabric.md`` for the session API, which this port keeps.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .nom_collectives import _dor_path, plan_transfers
from .scheduler import (ScheduleReport, TransferRequest, _as_copy_requests,
                        _as_transfers, _tdm_report)
from .slot_alloc import (AllocResult, Circuit, CopyRequest,
                         SegmentedAllocator, TdmAllocator)
from .topology import Mesh3D, StackedTopology


class FabricOverflow(RuntimeError):
    """Raised by ``overflow="raise"`` fabrics when an admission would
    exceed the bounded queue."""


# ---------------------------------------------------------------------------
# Packing-policy registry
# ---------------------------------------------------------------------------
class PolicyContext:
    """What a packing policy may look at besides the requests themselves.

    Attributes:
      backend: ``"tdm"`` or ``"rounds"``.
      distances: per-request route length in hops — Manhattan distance on
        the bank mesh (0 for an in-place INIT, the farthest source for a
        fan-in reduce), DOR path length on the device mesh — the quantity
        ``longest_first`` sorts by.  Computed on first access, so
        distance-blind policies (``"arrival"``) pay nothing for it.
      fanin: per-request fan-in width — ``len(srcs)`` for compute-class
        ``op="reduce"`` requests, 1 for copies/inits — so packing
        policies can weigh how many destination-port slots a request
        will pin.  Lazy like ``distances``.
    """

    def __init__(self, backend: str, distance_fn, fanin_fn=None):
        self.backend = backend
        self._distance_fn = distance_fn
        self._distances: tuple[int, ...] | None = None
        self._fanin_fn = fanin_fn
        self._fanin: tuple[int, ...] | None = None

    @property
    def distances(self) -> tuple[int, ...]:
        if self._distances is None:
            self._distances = tuple(self._distance_fn())
        return self._distances

    @property
    def fanin(self) -> tuple[int, ...]:
        if self._fanin is None:
            self._fanin = (tuple(self._fanin_fn())
                           if self._fanin_fn is not None else ())
        return self._fanin


_POLICIES: dict[str, object] = {}


def register_policy(name: str):
    """Decorator registering a packing policy under ``name``.

    A policy is ``fn(requests, ctx: PolicyContext) -> iterable[int]``
    returning the *commit order* — a permutation of ``range(len(
    requests)))``.  Earlier positions win slot/link contention (the
    batched commit reserves in this order; results always come back in
    request order).  Registering an already-taken name raises
    ``ValueError``; remove experimental policies with
    :func:`unregister_policy`.
    """
    def deco(fn):
        if name in _POLICIES:
            raise ValueError(f"policy {name!r} is already registered")
        _POLICIES[name] = fn
        return fn
    return deco


def unregister_policy(name: str) -> None:
    """Remove a registered policy (the built-ins may not be removed)."""
    if name in ("arrival", "longest_first"):
        raise ValueError(f"built-in policy {name!r} may not be removed")
    if name not in _POLICIES:
        raise ValueError(f"policy {name!r} is not registered")
    del _POLICIES[name]


def registered_policies() -> tuple[str, ...]:
    """Names currently in the registry, registration order."""
    return tuple(_POLICIES)


def get_policy(name: str):
    """Look up a policy by name; unknown names raise ``ValueError``
    listing what is registered (``"auto"`` is a fabric mode, not a
    registry entry)."""
    try:
        return _POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown policy {name!r}; registered: "
            f"{', '.join(_POLICIES)} (or 'auto')") from None


@register_policy("arrival")
def _arrival(reqs, ctx: PolicyContext):
    """FIFO — the CCU's commit rule (paper Section 2.2)."""
    return range(len(reqs))


@register_policy("longest_first")
def _longest_first(reqs, ctx: PolicyContext):
    """Descending route distance (stable): long circuits reserve first,
    short ones fill the remaining slots — best packing on most mixes."""
    return sorted(range(len(reqs)), key=lambda i: -ctx.distances[i])


# ---------------------------------------------------------------------------
# Bounded admission queue (the CCU's request buffering, shared with memsim)
# ---------------------------------------------------------------------------
def _is_init(payload) -> bool:
    """INIT-class detection across both request vocabularies: the
    scheduler's ``op="init"`` strings and the simulator's ``Op.INIT``
    enum (matched by name so core never imports memsim)."""
    op = getattr(payload, "op", "copy")
    return op == "init" or getattr(op, "name", "") == "INIT"


def _is_reduce(payload) -> bool:
    """Compute-class detection across both request vocabularies (the
    scheduler's ``op="reduce"`` and the simulator's ``Op.REDUCE``)."""
    op = getattr(payload, "op", "copy")
    return op == "reduce" or getattr(op, "name", "") == "REDUCE"


def _reduce_srcs(payload) -> tuple:
    """The fan-in source tuple of a reduce-class request (empty for
    copies/inits; memsim requests carry it as ``src_banks``)."""
    srcs = getattr(payload, "srcs", ()) or getattr(payload, "src_banks", ())
    return tuple(srcs)


@dataclasses.dataclass
class AdmissionQueue:
    """The bounded request queue in front of a circuit-setup authority.

    Pending requests sit here (with their arrival cycles) until a drain
    services them in one batched setup pass.  ``depth`` bounds the
    buffer; what happens to an admission that finds it full is the
    ``overflow`` behavior — ``"block"`` (force a drain and stall the
    issuer until the pickup pipeline completes; the memsim CCU's
    backpressure), ``"shed"`` (drop the request, count it), or
    ``"raise"`` (:class:`FabricOverflow`).  INIT-class occupancy is
    accounted separately, as in the simulator's CCU telemetry.

    The queue also owns its *service-latency* record: every admission
    that eventually gets serviced reports its wait (pickup cycle minus
    arrival cycle — the fabric's ``flush`` does this for CCU requests;
    the serving engine does it in engine ticks for tenant admission)
    through :meth:`record_admit`, and :meth:`wait_quantile` answers the
    p50/p99 questions the SLO harness asks.  A bounded reservoir of the
    most recent ``keep_waits`` samples backs the quantiles; the count
    and total (``n_admitted`` / ``wait_total``) are exact regardless.
    """
    depth: int
    overflow: str = "block"
    items: list = dataclasses.field(default_factory=list)  # (cycle, payload)
    busy_until: int = 0        # front-end pickup pipeline drain time
    stall_cycles: int = 0      # issuer cycles lost to queue-full blocking
    full_stalls: int = 0       # admissions that hit a full queue
    n_shed: int = 0            # admissions dropped by overflow="shed"
    peak_occupancy: int = 0
    init_reqs: int = 0
    peak_init: int = 0
    n_admitted: int = 0        # admissions serviced (record_admit calls)
    wait_total: int = 0        # summed service waits (cycles or ticks)
    keep_waits: int = 4096     # recent-wait reservoir for the quantiles
    wait_samples: list = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if self.overflow not in ("block", "shed", "raise"):
            raise ValueError(f"unknown overflow behavior {self.overflow!r}; "
                             "choose from ('block', 'shed', 'raise')")

    def full(self) -> bool:
        return len(self.items) >= self.depth

    def push(self, at: int, payload) -> None:
        if self.full():
            raise FabricOverflow("push on a full admission queue (drain "
                                 "first)")
        self.items.append((at, payload))
        self.peak_occupancy = max(self.peak_occupancy, len(self.items))
        if _is_init(payload):
            self.init_reqs += 1
            n = sum(1 for _at, q in self.items if _is_init(q))
            self.peak_init = max(self.peak_init, n)

    def record_admit(self, wait: int) -> None:
        """Record one serviced admission that waited ``wait`` time units
        (>= 0) between arrival and pickup."""
        wait = max(0, int(wait))
        self.n_admitted += 1
        self.wait_total += wait
        self.wait_samples.append(wait)
        del self.wait_samples[:-self.keep_waits]

    def wait_quantile(self, q: float) -> float:
        """Service-wait quantile (``q`` in [0, 1]) over the recorded
        reservoir; 0.0 before any admission was recorded."""
        if not self.wait_samples:
            return 0.0
        return float(np.quantile(np.asarray(self.wait_samples, float), q))


# ---------------------------------------------------------------------------
# The session object
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class NomFabric:
    """One stateful session owning all NoM traffic of a subsystem.

    Exactly one of ``mesh`` / ``allocator`` (bank level) or ``shape``
    (device level) selects the backend.  ``schedule`` is the synchronous
    batch path every migrated call site uses; ``submit`` / ``flush`` is
    the admission-queue path (the CCU discipline: requests buffer up to
    ``queue_depth``, then one batched setup drains them).

    Attributes:
      mesh: bank-level topology; a :class:`TdmAllocator` is built over it
        (``n_slots`` TDM slots) unless ``allocator`` is given directly.
      allocator: pre-built allocator (e.g. a ``TdmAllocatorLight``); the
        fabric adopts it, topology included.
      shape, torus: device-level topology for the rounds backend.
      policy: registered packing-policy name, or ``"auto"`` to pick per
        workload from stall history (see below).
      queue_depth: admission-queue capacity (``"auto"`` adapts the live
        depth between ``min_queue_depth`` and ``max_queue_depth``).
      overflow: full-queue behavior — ``"block"`` | ``"shed"`` |
        ``"raise"``.
      auto_candidates: policies ``"auto"`` chooses among.
      probe_flushes: flushes spent measuring each candidate before
        exploiting; retune_every: exploit flushes between re-probes.
      keep_history: per-flush reports retained on ``history`` (the
        cumulative ``report`` is exact regardless).
      alloc_backend: who serves the allocator's prepare rounds when the
        fabric builds its own ``TdmAllocator`` — ``"auto"`` (the fused
        prepare kernel for full waves, host pipeline for tiny rounds),
        ``"fused"``, or ``"host"``.  Ignored when ``allocator=`` is
        passed (the adopted allocator keeps its own backend).  Which
        backend actually served each wave shows up in ``telemetry()``
        as ``fused_waves`` / ``host_waves``.
      device: where a fabric-built allocator keeps its occupancy and runs
        its kernels — ``"cuda"`` (default; raises without a CUDA
        device) or ``"cpu"`` (the kernels' plain PyTorch versions).
        Ignored with ``allocator=`` and by the rounds backend.
    """
    mesh: Mesh3D | None = None
    shape: tuple[int, ...] | None = None
    torus: bool = True
    n_slots: int = 16
    allocator: TdmAllocator | None = None
    alloc_backend: str = "auto"
    policy: str = "arrival"
    queue_depth: int = 8
    overflow: str = "block"
    auto_candidates: tuple[str, ...] = ("arrival", "longest_first")
    probe_flushes: int = 1
    retune_every: int = 32
    min_queue_depth: int = 1
    max_queue_depth: int = 64
    keep_history: int = 256
    device: str = "cuda"

    def __post_init__(self):
        bank = (self.mesh is not None) or (self.allocator is not None)
        if bank == (self.shape is not None):
            raise ValueError("pass exactly one of mesh=/allocator= (bank "
                             "level) or shape= (device level)")
        if self.allocator is not None:
            self.mesh = self.allocator.mesh
            self.n_slots = self.allocator.n_slots
        elif self.mesh is not None:
            self.allocator = TdmAllocator(self.mesh, self.n_slots,
                                          backend=self.alloc_backend,
                                          device=self.device)
        self.backend = "tdm" if self.allocator is not None else "rounds"
        if self.policy != "auto":
            get_policy(self.policy)         # fail fast on unknown names
        for name in self.auto_candidates:
            get_policy(name)
        self.queue = AdmissionQueue(self.queue_depth, self.overflow)
        self.clock = 0                 # next batch anchor
        self.last_cycle = 0            # anchor of the most recent batch
        # rounds backend: persistent link -> {absolute rounds} reservations,
        # so consecutive batches contend the way tdm slot tables do.
        self._round_busy: dict[tuple, set[int]] = {}
        self.report: ScheduleReport | None = None
        self.history: list[ScheduleReport] = []
        self.n_flushes = 0
        self.n_policy_switches = 0
        # auto-tune state: per-candidate (cost_sum, flushes) + phase
        self._auto_stats = {name: [0.0, 0] for name in self.auto_candidates}
        self._auto_choice = self.auto_candidates[0] if self.auto_candidates \
            else "arrival"
        self._exploit_flushes = 0
        self._last_full_stalls = 0
        self._calm_flushes = 0         # consecutive quiet, under-filled drains
        # auto-learned per-window slot budget for copies (0 = paper default
        # of one slot/window); grown under sustained conflict-free stalls,
        # shrunk when the wider reservations start colliding.
        self._nom_extra_slots = 0

    # -- introspection -------------------------------------------------------
    @property
    def effective_policy(self) -> str:
        """The policy the next flush will commit with (the auto pick when
        ``policy="auto"``, else ``policy``)."""
        return self._auto_choice if self.policy == "auto" else self.policy

    @property
    def effective_queue_depth(self) -> int:
        """Live admission-queue capacity (auto-tuned when
        ``policy="auto"``)."""
        return self.queue.depth

    @property
    def pending(self) -> int:
        """Requests currently buffered in the admission queue."""
        return len(self.queue.items)

    # -- policy application --------------------------------------------------
    def _distances(self, reqs) -> tuple[int, ...]:
        if self.backend == "tdm":
            return tuple(
                0 if _is_init(r) else
                max(self.mesh.manhattan(int(s), r.dst)
                    for s in _reduce_srcs(r)) if _is_reduce(r) else
                self.mesh.manhattan(r.src, r.dst) for r in reqs)
        return tuple(len(_dor_path(t.src, t.dst, self.shape, self.torus))
                     for t in reqs)

    def _fanins(self, reqs) -> tuple[int, ...]:
        return tuple(max(1, len(_reduce_srcs(r))) if _is_reduce(r) else 1
                     for r in reqs)

    def _order(self, reqs, policy: str) -> list[int]:
        ctx = PolicyContext(self.backend, lambda: self._distances(reqs),
                            lambda: self._fanins(reqs))
        order = list(get_policy(policy)(reqs, ctx))
        if sorted(order) != list(range(len(reqs))):
            raise ValueError(f"policy {policy!r} returned an invalid "
                             f"commit order {order!r} for {len(reqs)} "
                             "requests (must be a permutation)")
        return order

    # -- the synchronous batch path ------------------------------------------
    def schedule(self, transfers, cycle: int | None = None,
                 policy: str | None = None):
        """Schedule a batch of bulk transfers concurrently.

        *All* requests are searched in one vectorized pass and committed in
        the packing policy's order, so every granted circuit is
        link/slot-disjoint from every other one it overlaps.

        Bank level returns ``(list[AllocResult], ScheduleReport)`` in
        request order; device level returns ``(TransferPlan,
        ScheduleReport)``.  ``cycle`` anchors the batch in allocator
        time (default: the fabric's own ``clock``, which then advances
        past the batch's drain).  ``policy`` overrides the session
        policy for this batch only.  Telemetry folds into ``report`` /
        ``history`` either way.
        """
        transfers = list(transfers)
        for t in transfers:
            if _is_init(t) and t.src != t.dst:
                raise ValueError(f"init requires src == dst, got {t!r}")
            if _is_reduce(t):
                if self.backend != "tdm":
                    raise ValueError(
                        "compute-class reduce is a bank-level op (fan-in "
                        "circuits need the tdm slot tables); on the rounds "
                        "backend use the device collectives "
                        "(nom_allreduce) instead")
                srcs = _reduce_srcs(t)
                if not srcs:
                    raise ValueError(f"reduce requires fan-in sources "
                                     f"(srcs), got {t!r}")
                if len(set(srcs)) != len(srcs):
                    raise ValueError(f"reduce sources must be distinct, "
                                     f"got {t!r}")
                if t.dst in srcs:
                    raise ValueError(f"reduce destination {t.dst} is "
                                     f"already a source in {t!r} (resident "
                                     "operands need no transfer)")
        chosen = policy or self.effective_policy
        if self.policy == "auto" and policy is None:
            chosen = self._auto_pick()
        if self.backend == "tdm":
            out = self._schedule_tdm(transfers, cycle, chosen)
        else:
            out = self._schedule_rounds(transfers, chosen, cycle)
        self._record(out[1], chosen, auto=self.policy == "auto"
                     and policy is None)
        return out

    def _schedule_tdm(self, transfers, cycle, policy):
        reqs = _as_copy_requests(transfers)
        if self.policy == "auto" and self._nom_extra_slots:
            # Learned widening: let plain copies claim up to the tuned
            # extra slots per window.  Requests that pin their own budget
            # (max_extra_slots != 0) and non-copy classes keep it.
            reqs = [dataclasses.replace(r,
                                        max_extra_slots=self._nom_extra_slots)
                    if r.op == "copy" and not r.max_extra_slots else r
                    for r in reqs]
        anchor = self.clock if cycle is None else cycle
        order = self._order(reqs, policy)
        permuted = [reqs[i] for i in order]
        res_p = self.allocator.allocate_batch(permuted, anchor)
        report = _tdm_report(self.allocator, permuted, res_p, anchor)
        results = [None] * len(reqs)
        for i, r in zip(order, res_p):
            results[i] = r
        self.last_cycle = anchor
        if cycle is None:
            end = max((r.circuit.end_cycle for r in results
                       if r.circuit is not None), default=anchor)
            self.clock = ((end // self.n_slots) + 1) * self.n_slots
        return results, report

    def _schedule_rounds(self, transfers, policy, cycle=None):
        n_init = sum(1 for t in transfers if _is_init(t))
        norm = _as_transfers(transfers)
        order = self._order(norm, policy)
        base = self.clock if cycle is None else cycle
        # Reservations behind every possible future anchor can never be
        # contended again — drop them so the persistent map stays bounded.
        horizon = min(base, self.clock)
        for hop in list(self._round_busy):
            live = {r for r in self._round_busy[hop] if r >= horizon}
            if live:
                self._round_busy[hop] = live
            else:
                del self._round_busy[hop]
        plan = plan_transfers(self.shape, norm, torus=self.torus, order=order,
                              busy=self._round_busy, base=base)
        self.last_cycle = base
        if cycle is None:
            # Advance past this batch's drain, exactly like the tdm clock:
            # the next default-anchored batch starts on fresh links (so a
            # sequence of default `schedule` calls is identical to the old
            # from-round-0 packing), while an explicitly anchored batch
            # (e.g. a pipelined flush) contends with what still streams.
            self.clock = base + plan.n_rounds
        conc = plan.concurrency()
        stall = sum(s for s, p in zip(plan.starts, plan.paths) if p)
        report = ScheduleReport(
            backend="rounds", n_requests=len(plan.transfers),
            n_scheduled=sum(1 for t, p in zip(norm, plan.paths)
                            if p or t.src == t.dst),
            n_windows=plan.n_rounds, max_inflight=int(conc["max_inflight"]),
            avg_inflight=conc["avg_inflight"], stall_cycles=stall,
            n_init=n_init)
        return plan, report

    # -- the admission-queue path --------------------------------------------
    def submit(self, request, at: int | None = None) -> bool:
        """Admit one request into the bounded queue (arrival cycle
        ``at``, default the fabric clock).  A full queue applies the
        session's overflow behavior: ``"block"`` flushes inline (the
        stall lands in ``queue.stall_cycles``), ``"shed"`` drops the
        request and returns False, ``"raise"`` raises
        :class:`FabricOverflow`.  Returns True when admitted."""
        at = self.clock if at is None else at
        if self.queue.full():
            if self.overflow == "raise":
                raise FabricOverflow(
                    f"admission queue full ({self.queue.depth} pending) "
                    f"and overflow='raise'")
            if self.overflow == "shed":
                self.queue.n_shed += 1
                return False
            self.flush(cycle=at)
            self.queue.full_stalls += 1
            self.queue.stall_cycles += max(0, self.queue.busy_until - at)
            at = max(at, self.queue.busy_until)
        self.queue.push(at, request)
        return True

    def flush(self, cycle: int | None = None):
        """Drain the admission queue through one batched ``schedule``
        call (anchored at ``cycle``, default the head's arrival) and
        model the CCU's pickup pipeline (3-cycle fill + 1/request) in
        ``queue.busy_until``.  Returns the ``(results, report)`` /
        ``(plan, report)`` pair, or None when the queue is empty."""
        if not self.queue.items:
            return None
        arrivals = [at for at, _r in self.queue.items]
        reqs = [r for _at, r in self.queue.items]
        self.queue.items.clear()
        anchor = min(arrivals) if cycle is None else cycle
        pick = max(anchor, self.queue.busy_until)
        self.queue.busy_until = pick + 3 + (len(reqs) - 1)
        for at in arrivals:     # per-request service wait: arrival -> pickup
            self.queue.record_admit(pick - at)
        # Both backends anchor at the pickup cycle: on rounds, the batch
        # packs against reservations still streaming from earlier flushes
        # (persistent `_round_busy`), so back-to-back drains contend the
        # way tdm slot tables always have.
        out = self.schedule(reqs, cycle=pick)
        # Advance the session clock past this drain: later submits with a
        # default arrival must not look like they arrived before it (that
        # would charge them the whole session's elapsed pipeline time as
        # stall on an overflow).
        self.clock = max(self.clock, self.queue.busy_until)
        return out

    # -- telemetry -----------------------------------------------------------
    def _record(self, report: ScheduleReport, policy: str,
                auto: bool) -> None:
        self.n_flushes += 1
        self.history.append(report)
        del self.history[:-self.keep_history]
        self.report = (report if self.report is None
                       else self.report.merge(report))
        if auto:
            self._auto_observe(policy, report)

    def telemetry(self) -> dict:
        """Cumulative session stats: scheduling (``flushes``,
        ``requests``/``scheduled``, ``init_requests`` /
        ``reduce_requests`` op-class counters, concurrency,
        ``stall_cycles``, search/conflict counters incl.
        ``searched_requests``, and the allocator-backend split
        ``fused_waves`` / ``host_waves``), the live knobs
        (``policy``, ``queue_depth``, the learned ``nom_extra_slots``
        copy-widening budget), and admission health
        (``pending``, ``shed``, ``full_stalls``,
        ``queue_stall_cycles``, ``policy_switches``, and the queue's
        service-latency record ``queue_admitted`` /
        ``queue_wait_cycles`` / ``queue_wait_p50`` /
        ``queue_wait_p99``)."""
        agg = self.report
        out = {
            "backend": self.backend,
            "flushes": self.n_flushes,
            "requests": 0 if agg is None else agg.n_requests,
            "scheduled": 0 if agg is None else agg.n_scheduled,
            "init_requests": 0 if agg is None else agg.n_init,
            "reduce_requests": 0 if agg is None else agg.n_reduce,
            "max_inflight": 0 if agg is None else agg.max_inflight,
            "avg_inflight": 0.0 if agg is None else agg.avg_inflight,
            "stall_cycles": 0 if agg is None else agg.stall_cycles,
            "search_rounds": 0 if agg is None else agg.search_rounds,
            "conflicts": 0 if agg is None else agg.conflicts,
            "searched_requests": 0 if agg is None else agg.n_searched,
            "fused_waves": 0 if agg is None else agg.fused_waves,
            "host_waves": 0 if agg is None else agg.host_waves,
            "policy": self.effective_policy,
            "queue_depth": self.queue.depth,
            "nom_extra_slots": self._nom_extra_slots,
            "pending": self.pending,
            "shed": self.queue.n_shed,
            "full_stalls": self.queue.full_stalls,
            "queue_stall_cycles": self.queue.stall_cycles,
            "queue_admitted": self.queue.n_admitted,
            "queue_wait_cycles": self.queue.wait_total,
            "queue_wait_p50": self.queue.wait_quantile(0.5),
            "queue_wait_p99": self.queue.wait_quantile(0.99),
            "policy_switches": self.n_policy_switches,
        }
        return out

    # -- stall-driven auto-tuning --------------------------------------------
    # Deterministic: the trajectory is a pure function of the submitted
    # traffic.  Probe phase measures each candidate for `probe_flushes`
    # batches; exploit phase commits with the cheapest (mean stall_cycles
    # + makespan per flush); after `retune_every` exploit flushes the
    # stats reset and the fabric re-probes (workloads drift).
    def _auto_pick(self) -> str:
        probing = [n for n in self.auto_candidates
                   if self._auto_stats[n][1] < self.probe_flushes]
        if probing:
            choice = probing[0]
        else:
            choice = min(self.auto_candidates,
                         key=lambda n: (self._auto_stats[n][0]
                                        / self._auto_stats[n][1]))
        if choice != self._auto_choice:
            self.n_policy_switches += 1
        self._auto_choice = choice
        return choice

    def _auto_observe(self, policy: str, report: ScheduleReport) -> None:
        if policy in self._auto_stats:
            cost = report.stall_cycles + report.n_windows
            st = self._auto_stats[policy]
            st[0] += cost
            st[1] += 1
        if all(st[1] >= self.probe_flushes
               for st in self._auto_stats.values()):
            self._exploit_flushes += 1
            if self._exploit_flushes >= self.retune_every:
                self._exploit_flushes = 0
                self._auto_stats = {n: [0.0, 0]
                                    for n in self.auto_candidates}
        self._auto_queue_depth(report)
        self._auto_extra_slots(report)

    def _auto_extra_slots(self, report: ScheduleReport) -> None:
        """Conflict feedback on the per-window slot budget: heavy stalls
        with a clean conflict record mean circuits queue behind window
        capacity — widen copies by one extra slot (up to half the TDM
        frame); once the wider reservations start colliding in the
        batched commit (conflict rate over a quarter of the scheduled
        requests), back off.  Deterministic, like the rest of the tuner;
        the live value shows in ``telemetry()["nom_extra_slots"]``."""
        if self.backend != "tdm" or not report.n_requests:
            return
        conflict_rate = report.conflicts / max(1, report.n_scheduled)
        stall_per_req = report.stall_cycles / report.n_requests
        if conflict_rate > 0.25 and self._nom_extra_slots:
            self._nom_extra_slots -= 1
        elif stall_per_req > self.n_slots and conflict_rate <= 0.05:
            self._nom_extra_slots = min(self._nom_extra_slots + 1,
                                        max(0, self.n_slots // 2 - 1))

    def _auto_queue_depth(self, report: ScheduleReport) -> None:
        """Stall feedback on the admission buffer: overflow blocking (or
        heavy in-batch queueing) doubles the depth — bigger drains pack
        better; a sustained run of quiet, under-filled drains halves it
        back toward ``min_queue_depth`` (buffering without benefit)."""
        grew = self.queue.full_stalls > self._last_full_stalls
        self._last_full_stalls = self.queue.full_stalls
        stall_per_req = (report.stall_cycles / report.n_requests
                         if report.n_requests else 0.0)
        if grew or stall_per_req > self.n_slots:
            self.queue.depth = min(self.max_queue_depth,
                                   self.queue.depth * 2)
            self._calm_flushes = 0
        elif report.n_requests <= self.queue.depth // 2 \
                and report.stall_cycles == 0:
            self._calm_flushes += 1
            if self._calm_flushes >= 4:
                self._calm_flushes = 0
                self.queue.depth = max(self.min_queue_depth,
                                       self.queue.depth // 2)
        else:
            self._calm_flushes = 0



# ---------------------------------------------------------------------------
# Multi-stack: one CCU authority per stack + cross-stack negotiation
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ReduceTree:
    """A committed cross-stack compute-class reduce.

    Three kinds of reserved components stream as one logical operation:
    ``partials`` — per-remote-stack fan-in :class:`~repro_torch.core.slot_alloc.
    Circuit`\\ s merging that stack's operands at its bridge bank;
    ``legs`` — one :class:`~repro_torch.core.slot_alloc.StackedCircuit` SerDes
    delivery per remote stack, bridge to destination, anchored at the
    partial's drain (store-and-forward at the bridge's logic-die buffer);
    ``local`` — the destination stack's own fan-in, when it holds
    operands.  Remote partials merge at the destination without extra
    ALU dwell (the SerDes inter-arrival gap already exceeds the merge
    latency — a documented simplification vs the same-stack dwell
    model).  Cycles span the earliest component injection to the last
    component's final beat."""
    dst: tuple[int, int]      # (stack, local node)
    srcs: tuple               # (stack, node) operand endpoints, source order
    start_cycle: int
    arrival_cycle: int        # first beat of the last-arriving component
    end_cycle: int            # last beat landed (reservations drained)
    n_windows: int            # window span of the whole tree
    distance: int             # arrival_cycle - start_cycle
    partials: list            # remote-stack bridge fan-in Circuits
    legs: list                # StackedCircuits bridge -> destination
    local: object | None = None   # destination-stack fan-in Circuit
    slots_per_window: int = 1
    _n_slots_hint: int = 16

    @property
    def cross_stack(self) -> bool:
        return True

    @property
    def hops(self) -> list[tuple[int, int, int]]:
        """Mesh hops of every component (node ids are stack-local);
        SerDes hops are in :attr:`link_slots`."""
        out = []
        for c in (*self.partials, *self.legs,
                  *((self.local,) if self.local is not None else ())):
            out.extend(c.hops)
        return out

    @property
    def link_slots(self) -> list[tuple[int, int]]:
        """(channel, slot) SerDes reservations across all legs."""
        return [ls for leg in self.legs for ls in leg.link_slots]


@dataclasses.dataclass
class FabricCluster:
    """Multi-authority NoM over a :class:`StackedTopology`.

    One :class:`NomFabric` per stack owns that stack's slot tables,
    clock, and policy state — *same-stack traffic is delegated wholesale
    to its stack's fabric* and never takes the cluster's cross-stack
    path.  Cross-stack requests are negotiated between the per-stack CCUs
    by a :class:`~repro_torch.core.slot_alloc.SegmentedAllocator`: the near
    authority reserves its mesh segment plus the SerDes channel slots
    (phase 1), the far authority commits its segment against the pinned
    injection slot (phase 2), and a far-side conflict rolls the near
    reservation back with no slot-table state leaked.

    Requests address banks either as flat global ids (``src``/``dst``
    ints, see :meth:`StackedTopology.global_id`), as ``(stack, node)``
    tuples, or via :class:`TransferRequest`'s ``src_stack``/``dst_stack``
    fields with stack-local node ids.

    With ``n_stacks == 1`` every batch is delegated to the single stack
    fabric with identical arguments — plans, results, and reports are
    bit-identical to holding that :class:`NomFabric` directly.

    ``device`` is passed to every per-stack :class:`NomFabric` the
    cluster builds (``"cuda"`` by default: each stack's search and
    prepare kernels run on the card; ``"cpu"`` runs their plain
    versions).  Ignored with ``allocators=``, which keep their own.
    """

    topology: StackedTopology
    n_slots: int = 16
    policy: str = "arrival"
    queue_depth: int = 8
    overflow: str = "block"
    allocators: list | None = None   # pre-built per-stack allocators
    alloc_backend: str = "auto"      # per-stack allocator prepare backend
    device: str = "cuda"             # per-stack allocators' device

    def __post_init__(self):
        if self.allocators is not None:
            if len(self.allocators) != self.topology.n_stacks:
                raise ValueError(f"{len(self.allocators)} allocators for "
                                 f"{self.topology.n_stacks} stacks")
            self.n_slots = self.allocators[0].n_slots
            self.fabrics = [NomFabric(allocator=a, policy=self.policy,
                                      queue_depth=self.queue_depth,
                                      overflow=self.overflow)
                            for a in self.allocators]
        else:
            self.fabrics = [NomFabric(mesh=m, n_slots=self.n_slots,
                                      policy=self.policy,
                                      queue_depth=self.queue_depth,
                                      overflow=self.overflow,
                                      alloc_backend=self.alloc_backend,
                                      device=self.device)
                            for m in self.topology.stacks]
        self.segmented = SegmentedAllocator(
            self.topology, [f.allocator for f in self.fabrics], self.n_slots)
        self.backend = "tdm"
        self.queue = AdmissionQueue(self.queue_depth, self.overflow)
        self.clock = 0
        self.last_cycle = 0
        self.report: ScheduleReport | None = None
        self.n_flushes = 0
        self.cross_requests = 0
        self.cross_committed = 0
        self.cross_reduce_trees = 0    # committed cross-stack reduce trees
        self.reduce_rollbacks = 0      # trees aborted (state restored)

    # -- introspection -------------------------------------------------------
    @property
    def effective_policy(self) -> str:
        return self.policy

    @property
    def pending(self) -> int:
        return len(self.queue.items)

    def fabric_of(self, stack: int) -> NomFabric:
        """The per-stack CCU authority (its slot tables, clock, queue)."""
        if not 0 <= stack < self.topology.n_stacks:
            raise ValueError(f"stack {stack} out of range "
                             f"[0, {self.topology.n_stacks})")
        return self.fabrics[stack]

    # -- two-level address normalization -------------------------------------
    def _endpoint(self, v, stack: int | None) -> tuple[int, int]:
        if stack is not None:
            self.topology.global_id(int(stack), int(v))  # validates ranges
            return int(stack), int(v)
        if isinstance(v, tuple):
            if len(v) != 2:
                raise ValueError(f"stacked endpoint must be (stack, node), "
                                 f"got {v!r}")
            self.topology.global_id(int(v[0]), int(v[1]))
            return int(v[0]), int(v[1])
        return self.topology.locate(int(v))

    def _split(self, transfers):
        """Partition a batch three ways: same-stack requests (localized,
        grouped per stack), cross-stack copies (kept with their
        endpoints), and cross-stack reduces (kept with every operand
        endpoint — they become reduce trees)."""
        groups: dict[int, list] = {}
        cross: list = []
        cross_red: list = []
        for pos, t in enumerate(transfers):
            if not isinstance(t, (TransferRequest, CopyRequest)):
                t = CopyRequest(*t)
            is_tr = isinstance(t, TransferRequest)
            if _is_reduce(t):
                srcs = _reduce_srcs(t)
                if not srcs:
                    raise ValueError(f"reduce requires fan-in sources "
                                     f"(srcs), got {t!r}")
                s_stack = t.src_stack if is_tr else None
                eps = [self._endpoint(s, s_stack) for s in srcs]
                de = self._endpoint(t.dst, t.dst_stack if is_tr else None)
                if len(set(eps)) != len(eps):
                    raise ValueError(f"reduce sources must be distinct, "
                                     f"got {t!r}")
                if de in eps:
                    raise ValueError(f"reduce destination {de} is already "
                                     f"a source in {t!r}")
                if all(st == de[0] for st, _n in eps):
                    locs = tuple(n for _st, n in eps)
                    if is_tr:
                        local = dataclasses.replace(
                            t, src=locs[0], dst=de[1], srcs=locs,
                            src_stack=None, dst_stack=None)
                    else:
                        local = dataclasses.replace(t, src=locs[0],
                                                    dst=de[1], srcs=locs)
                    groups.setdefault(de[0], []).append((pos, local))
                else:
                    cross_red.append((pos, t, eps, de))
                continue
            se = self._endpoint(t.src, t.src_stack if is_tr else None)
            de = self._endpoint(t.dst, t.dst_stack if is_tr else None)
            if _is_init(t) and se != de:
                raise ValueError(f"init requires src == dst, got {t!r}")
            if se[0] == de[0]:
                if is_tr:
                    local = dataclasses.replace(t, src=se[1], dst=de[1],
                                                src_stack=None,
                                                dst_stack=None)
                else:
                    local = dataclasses.replace(t, src=se[1], dst=de[1])
                groups.setdefault(se[0], []).append((pos, local))
            else:
                cross.append((pos, t, se, de))
        return groups, cross, cross_red

    # -- the synchronous batch path ------------------------------------------
    def schedule(self, transfers, cycle: int | None = None,
                 policy: str | None = None):
        """Schedule a batch across the cluster.

        Same-stack requests go to their stack's :class:`NomFabric` (one
        delegated batch per stack, identical ``cycle``/``policy``
        semantics); cross-stack requests are then negotiated one at a
        time through the two-phase :class:`SegmentedAllocator` — an
        uncommittable request is denied (``circuit=None``), exactly like
        a saturated single-stack mesh.  Returns ``(results, report)``
        with results in request order; the merged report counts the
        cross-stack share in ``n_cross_stack``.
        """
        transfers = list(transfers)
        groups, cross, cross_red = self._split(transfers)
        results: list = [None] * len(transfers)
        reports = []
        for stack in sorted(groups):
            positions = [p for p, _r in groups[stack]]
            reqs = [r for _p, r in groups[stack]]
            res, rep = self.fabrics[stack].schedule(reqs, cycle=cycle,
                                                    policy=policy)
            for p, r in zip(positions, res):
                results[p] = r
            reports.append(rep)
        circuits, stalls = [], 0
        for pos, t, se, de in cross:
            self.cross_requests += 1
            anchor = (cycle if cycle is not None
                      else max(self.fabrics[se[0]].clock,
                               self.fabrics[de[0]].clock))
            rq_cycle = getattr(t, "cycle", None)
            if rq_cycle is not None:
                anchor = max(anchor, rq_cycle)
            circ = self.segmented.allocate(se, de, max(1, t.nbytes), anchor)
            results[pos] = AllocResult(circuit=circ, searched_cycle=anchor)
            if circ is None:
                continue
            self.cross_committed += 1
            circuits.append(circ)
            stalls += max(0, circ.start_cycle - (anchor + 3))
            if cycle is None:
                nxt = ((circ.end_cycle // self.n_slots) + 1) * self.n_slots
                for s in (se[0], de[0]):
                    fab = self.fabrics[s]
                    fab.clock = max(fab.clock, nxt)
        for pos, t, eps, de in cross_red:
            self.cross_requests += 1
            involved = sorted({de[0], *(s for s, _n in eps)})
            anchor = (cycle if cycle is not None
                      else max(self.fabrics[s].clock for s in involved))
            rq_cycle = getattr(t, "cycle", None)
            if rq_cycle is not None:
                anchor = max(anchor, rq_cycle)
            tree = self._reduce_tree(t, eps, de, anchor)
            results[pos] = AllocResult(circuit=tree, searched_cycle=anchor)
            if tree is None:
                continue
            self.cross_committed += 1
            self.cross_reduce_trees += 1
            circuits.append(tree)
            stalls += max(0, tree.start_cycle - (anchor + 3))
            if cycle is None:
                nxt = ((tree.end_cycle // self.n_slots) + 1) * self.n_slots
                for s in involved:
                    fab = self.fabrics[s]
                    fab.clock = max(fab.clock, nxt)
        if cross or cross_red:
            reports.append(self._cross_report(
                len(cross) + len(cross_red), circuits, stalls,
                n_reduce=len(cross_red)))
        if not reports:
            reports = [ScheduleReport(backend="tdm", n_requests=0,
                                      n_scheduled=0, n_windows=0,
                                      max_inflight=0, avg_inflight=0.0)]
        report = reports[0]
        for rep in reports[1:]:
            report = report.merge(rep)
        if groups:
            self.last_cycle = (cycle if cycle is not None else
                               min(self.fabrics[s].last_cycle
                                   for s in groups))
        elif cross or cross_red:
            self.last_cycle = min(r.searched_cycle
                                  for r in results if r is not None)
        self.clock = max([self.clock] + [f.clock for f in self.fabrics])
        self.n_flushes += 1
        self.report = (report if self.report is None
                       else self.report.merge(report))
        return results, report

    def _cross_report(self, n_cross: int, circuits, stalls,
                      n_reduce: int = 0) -> ScheduleReport:
        n = self.n_slots
        starts = [c.start_cycle // n for c in circuits]
        w0 = min(starts, default=0)
        span = max((s - w0 + c.n_windows for s, c in zip(starts, circuits)),
                   default=0)
        active = np.zeros(span, np.int64)
        for s, c in zip(starts, circuits):
            active[s - w0:s - w0 + c.n_windows] += 1
        busy = active[active > 0]
        return ScheduleReport(
            backend="tdm", n_requests=n_cross, n_scheduled=len(circuits),
            n_windows=int(span),
            max_inflight=int(busy.max()) if busy.size else 0,
            avg_inflight=float(busy.mean()) if busy.size else 0.0,
            stall_cycles=stalls, n_cross_stack=n_cross, n_reduce=n_reduce)

    # -- cross-stack reduce trees --------------------------------------------
    def _tree_snapshot(self):
        """Every expiry table a reduce tree may touch (per-stack ports +
        SerDes links), copied — the all-or-nothing restore point."""
        tables = [f.allocator.table._ports for f in self.fabrics]
        tables.append(self.segmented.links)
        return ([(pe, pe.expiry.copy()) for pe in tables],
                self.segmented.link_windows)

    def _tree_restore(self, snap) -> None:
        saved, link_windows = snap
        for pe, exp in saved:
            if not np.array_equal(pe.expiry, exp):
                pe.expiry[...] = exp
                pe._recompute(pe.window)
        self.segmented.link_windows = link_windows

    def _commit_local_reduce(self, stack: int, srcs, dst: int, nbytes: int,
                             cycle: int):
        """Reserve one same-stack fan-in (a reduce-tree component)
        directly against the stack's slot table.  Returns the Circuit or
        None when infeasible; the caller owns tree-level rollback."""
        alloc = self.fabrics[stack].allocator
        n = alloc.n_slots
        t_ready = cycle + 3
        window = t_ready // n
        occ = alloc.table._ports.masks_at(window)
        st = alloc._prepare_reduce(
            CopyRequest(src=srcs[0], dst=dst, nbytes=max(1, nbytes),
                        op="reduce", srcs=tuple(srcs)),
            t_ready, occ, window)
        if st.denied:
            return None
        alloc.table._ports.reserve_arrays(st.idx, st.w_res + st.n_win)
        return Circuit(src=st.src, dst=st.dst, start_cycle=st.start_cycle,
                       n_windows=st.n_win, hops=st.hops,
                       distance=st.distance, _n_slots_hint=n, srcs=st.srcs)

    def _reduce_tree(self, t, eps, de, anchor: int) -> ReduceTree | None:
        """Commit one cross-stack reduce as a tree, all-or-nothing.

        Per remote stack: fan-in partial reduction at the bridge bank
        (bridge-resident operands merge for free), then one SerDes leg
        delivering the partial to the destination, anchored at the
        partial's drain (store-and-forward in the bridge's logic-die
        buffer).  Destination-stack operands fan in locally at the
        anchor.  Any infeasible component restores every expiry table
        byte-identically — the :class:`SegmentedAllocator` two-phase
        discipline widened to the whole tree."""
        ds, d_loc = de
        by_stack: dict[int, list[int]] = {}
        for st_, node in eps:
            by_stack.setdefault(st_, []).append(node)
        local_srcs = by_stack.pop(ds, [])
        snap = self._tree_snapshot()
        partials, legs = [], []
        ok = True
        for st_ in sorted(by_stack):
            bridge = self.topology.bridge_of(st_)
            fan = [nd for nd in by_stack[st_] if nd != bridge]
            leg_anchor = anchor
            if fan:
                part = self._commit_local_reduce(st_, fan, bridge,
                                                 t.nbytes, anchor)
                if part is None:
                    ok = False
                    break
                partials.append(part)
                leg_anchor = part.end_cycle
            leg = self.segmented.allocate((st_, bridge), (ds, d_loc),
                                          max(1, t.nbytes), leg_anchor)
            if leg is None:
                ok = False
                break
            legs.append(leg)
        local = None
        if ok and local_srcs:
            local = self._commit_local_reduce(ds, local_srcs, d_loc,
                                              t.nbytes, anchor)
            ok = local is not None
        if not ok:
            self._tree_restore(snap)
            self.reduce_rollbacks += 1
            return None
        comps = partials + legs + ([local] if local is not None else [])
        start = min(c.start_cycle for c in comps)
        arrival = max(c.arrival_cycle for c in comps)
        end = max(c.end_cycle for c in comps)
        return ReduceTree(dst=de, srcs=tuple(eps), start_cycle=start,
                          arrival_cycle=arrival, end_cycle=end,
                          n_windows=(end - start) // self.n_slots + 1,
                          distance=arrival - start, partials=partials,
                          legs=legs, local=local,
                          _n_slots_hint=self.n_slots)

    # -- the admission-queue path --------------------------------------------
    def submit(self, request, at: int | None = None) -> bool:
        """Admit one request into the cluster-level bounded queue — same
        overflow contract as :meth:`NomFabric.submit`."""
        return NomFabric.submit(self, request, at)

    def flush(self, cycle: int | None = None):
        """Drain the cluster queue through one batched :meth:`schedule`
        call — same pickup-pipeline contract as :meth:`NomFabric.flush`."""
        return NomFabric.flush(self, cycle)

    # -- telemetry -----------------------------------------------------------
    def telemetry(self) -> dict:
        """Cluster-wide stats: the merged scheduling counters, the
        cross-stack protocol counters (``cross_requests`` /
        ``cross_committed`` / ``cross_denied`` / ``cross_rollbacks``,
        the reduce-tree counters ``cross_reduce_trees`` /
        ``reduce_rollbacks``, SerDes ``link_windows``), and each
        stack's own fabric telemetry under ``"stacks"``."""
        agg = self.report
        return {
            "backend": self.backend,
            "n_stacks": self.topology.n_stacks,
            "flushes": self.n_flushes,
            "requests": 0 if agg is None else agg.n_requests,
            "scheduled": 0 if agg is None else agg.n_scheduled,
            "init_requests": 0 if agg is None else agg.n_init,
            "reduce_requests": 0 if agg is None else agg.n_reduce,
            "max_inflight": 0 if agg is None else agg.max_inflight,
            "avg_inflight": 0.0 if agg is None else agg.avg_inflight,
            "stall_cycles": 0 if agg is None else agg.stall_cycles,
            "fused_waves": 0 if agg is None else agg.fused_waves,
            "host_waves": 0 if agg is None else agg.host_waves,
            "cross_requests": self.cross_requests,
            "cross_committed": self.cross_committed,
            "cross_denied": self.segmented.denied,
            "cross_rollbacks": self.segmented.rollbacks,
            "cross_reduce_trees": self.cross_reduce_trees,
            "reduce_rollbacks": self.reduce_rollbacks,
            "link_windows": self.segmented.link_windows,
            "policy": self.effective_policy,
            "queue_depth": self.queue.depth,
            "pending": self.pending,
            "shed": self.queue.n_shed,
            "full_stalls": self.queue.full_stalls,
            "queue_stall_cycles": self.queue.stall_cycles,
            "queue_admitted": self.queue.n_admitted,
            "queue_wait_cycles": self.queue.wait_total,
            "queue_wait_p50": self.queue.wait_quantile(0.5),
            "queue_wait_p99": self.queue.wait_quantile(0.99),
            "stacks": [f.telemetry() for f in self.fabrics],
        }


__all__ = ["AdmissionQueue", "FabricCluster", "FabricOverflow", "NomFabric",
           "PolicyContext", "ReduceTree", "get_policy", "register_policy",
           "registered_policies", "unregister_policy"]
