"""Serving engine: batched prefill + decode with per-arch caches (port of
``repro.serving.engine``).

``generate`` runs greedy decoding through the model's single-token serve
step; prefill feeds the prompt's tokens through the same step
(cache-filling), as the reference does.

Decode-cache movement rides one :class:`~repro_torch.core.fabric.NomFabric`
session, multi-tenant: each ``generate`` stream is a *tenant* that leases
bank homes from a :class:`~repro_torch.serving.placement.BankPool`
(placement policies: strided spread, per-tenant column partitioning,
stall-feedback repacking).  Every step's cache updates are emitted as
:class:`~repro_torch.core.scheduler.TransferRequest`s and scheduled in
one batched ``fabric.schedule`` call; ring-buffer overwrites,
stall-driven evictions, and tenant teardown ride the same batches as
INIT-class requests (``op="init"``, zero-hop circuits) — the serving
analogue of the paper's mixed copy/initialization traffic.  Tenant
admission shares the fabric's overflow semantics: a stream that finds the
pool exhausted is queued or shed (after idle-lease reclaim) instead of
surfacing ``BankPool.lease``'s RuntimeError.  Per-batch
:class:`ScheduleReport`s accumulate on ``Engine.reports`` and aggregate
into ``Engine.last_report``; ``Engine.transfer_telemetry()`` summarizes
both, including the INIT share and admission health.

The fabric's allocator keeps its occupancy on ``Engine.device`` and runs
its search and prepare kernels there (``"cuda"`` by default); the
tenant, lease and admission bookkeeping stays numpy on the host, as in
the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.fabric import AdmissionQueue, FabricCluster, NomFabric
from repro_torch.core.scheduler import ScheduleReport, TransferRequest
from repro_torch.core.topology import Mesh3D, StackedTopology, make_topology
from repro_torch.device import resolve_device
from repro_torch.serving.admission import (AdmissionContext, AdmissionTicket,
                                           TicketColumns, get_admission)
from repro_torch.serving.placement import (BankPool, LeafSpec, step_requests,
                                           teardown_requests)
from repro_torch.train.state import make_serve_step

# Engine admission mode -> fabric/queue overflow behavior.
_ADMISSION = {"queue": "block", "shed": "shed", "raise": "raise"}

CONTROL_PLANES = ("vector", "scalar")


def _flatten(tree, path: str = ""):
    """(key string, leaf) pairs of a tree of nested dicts in JAX's pytree
    order (keys sorted), each key string as ``jax.tree_util.keystr``
    writes it (``['groups']['l0']['conv']``)."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], f"{path}[{k!r}]")]
    return [(path, tree)]


class _ObservedList(list):
    """The tenant queue's backing list, instrumented: any mutation made
    *outside* the engine's own helpers (tests shuffle / filter
    ``tenant_queue.items`` directly as a stand-in for arbitrary queue
    states) fires the hook, so the engine's packed ticket columns and
    queued-name index know to resynchronize before their next use."""

    __slots__ = ("_hook",)

    def __init__(self, iterable, hook):
        super().__init__(iterable)
        self._hook = hook

    def _make(name):
        base = getattr(list, name)

        def method(self, *args, **kw):
            self._hook()
            return base(self, *args, **kw)
        method.__name__ = name
        return method

    for _name in ("append", "extend", "insert", "pop", "remove", "clear",
                  "sort", "reverse", "__setitem__", "__delitem__",
                  "__iadd__", "__imul__"):
        locals()[_name] = _make(_name)
    del _make, _name


@dataclasses.dataclass
class _Tenant:
    """Live state of one serving stream's lease on the bank mesh."""
    name: str
    leases: list
    pos: int = 0               # write position (ring wrap -> evictions)
    stall_mark: int = 0        # tenant's attributed stalls at last repack
    last_active: int = 0       # engine tick of the last scheduled step
    slot: int = -1             # row in the engine's SoA tenant table


class _TenantTable:
    """Structure-of-arrays mirror of the active-tenant set.

    One row per admitted tenant (rows are recycled through a free list),
    columns ``last_active`` (engine tick of the last scheduled step) and
    ``lease_count`` (banks held).  Idle detection — previously a Python
    scan over every ``_Tenant`` per exhausted admission — becomes one
    boolean mask over the ``last_active`` column; only the (typically
    tiny) idle candidate set is ever touched per-element again, to apply
    the scalar path's exact ``(last_active, name)`` victim tie-break.
    """

    def __init__(self, capacity: int = 64):
        self._cap = max(1, capacity)
        self.last_active = np.zeros(self._cap, np.int64)
        self.lease_count = np.zeros(self._cap, np.int64)
        self.used = np.zeros(self._cap, bool)
        self.names: list[str | None] = [None] * self._cap
        self._free: list[int] = list(range(self._cap - 1, -1, -1))

    def add(self, name: str, last_active: int, lease_count: int) -> int:
        if not self._free:
            old = self._cap
            self._cap *= 2
            for col in ("last_active", "lease_count", "used"):
                arr = getattr(self, col)
                fresh = np.zeros(self._cap, arr.dtype)
                fresh[:old] = arr
                setattr(self, col, fresh)
            self.names.extend([None] * old)
            self._free.extend(range(self._cap - 1, old - 1, -1))
        slot = self._free.pop()
        self.last_active[slot] = last_active
        self.lease_count[slot] = lease_count
        self.used[slot] = True
        self.names[slot] = name
        return slot

    def drop(self, slot: int) -> None:
        self.used[slot] = False
        self.names[slot] = None
        self._free.append(slot)

    def touch(self, slot: int, tick: int) -> None:
        self.last_active[slot] = tick

    def idle_slots(self, tick: int, idle_ticks: int) -> np.ndarray:
        """Rows whose tenants have not scheduled for ``idle_ticks``."""
        mask = self.used & (tick - self.last_active >= idle_ticks)
        return np.flatnonzero(mask)

    def leases_active(self) -> int:
        return int(self.lease_count[self.used].sum())


@dataclasses.dataclass
class Engine:
    """Multi-tenant serving engine over a NoM bank mesh.

    Functional path: ``generate`` (batched greedy prefill+decode through
    the model's serve step, built on first use).  Scheduling path
    (``track_transfers=True``, the default): every stream is a tenant of
    ``self.pool``; per-step cache movement and INIT-class eviction
    traffic go through ``self.fabric`` — one
    :class:`~repro_torch.core.fabric.NomFabric` session — so concurrent
    tenants' circuits genuinely compete for (and share) TDM windows.

    Attributes:
      placement_policy: ``"spread"`` | ``"partition"`` |
        ``"stall_feedback"`` (see ``repro_torch/serving/placement.py``).
      sched_policy: fabric packing policy for the per-step batches — a
        registered name or ``"auto"`` (stall-driven pick).
      admission: what happens when ``open_tenant`` finds the bank pool
        exhausted *after* idle-lease reclaim — ``"queue"`` (park the
        stream on a bounded admission queue; it is admitted when
        capacity frees), ``"shed"`` (decline it, counted), or
        ``"raise"`` (surface ``BankPool.lease``'s RuntimeError, the
        pre-fabric behavior).
      admission_strategy: registered admission-strategy name (see
        ``repro_torch/serving/admission.py``) deciding the *order* queued
        streams are offered freed capacity in — ``"fifo"`` (arrival
        order, head-blocking; the legacy discipline), ``"deadline"``
        (strictest-deadline-first), ``"priority"`` (frequency/priority-
        weighted), ``"hybrid"`` (urgent deadlines preempt, utility
        otherwise), or ``"stall_aware"`` (deadline order while the
        fabric is healthy, lightest-first once its stall pressure
        crosses ``STALL_PRESSURE``).  Every strategy breaks ties by
        arrival sequence, so equal-utility waiters admit in stable FIFO
        order.
      control_plane: ``"vector"`` (default) runs admission, expiry, and
        idle eviction over packed structure-of-arrays state — one numpy
        lexsort per drain, boolean-mask expiry, an indexed duplicate
        check — and is bit-identical to ``"scalar"``, the original
        per-tenant Python path kept as the differential reference
        (``tests/test_torch_serving.py`` holds both to the reference).
      idle_evict_ticks: a tenant with no scheduled step for this many
        engine ticks is *idle*; exhausted admissions reclaim idle
        tenants' leases (teardown INIT scrubs ride the fabric) before
        queueing or shedding.  0 disables reclaim.
      deadline_ticks: how many engine ticks a *queued* stream may wait
        for admission.  ``schedule_tick`` sheds waiters older than this
        (counted in ``transfer_telemetry()["tenant_queue_expired"]``,
        with a ``waiter_callback`` notification) — a production engine
        must age out streams whose client has long since timed out
        instead of parking them forever.  0 disables aging.  A stream
        whose ``open_tenant`` ticket carries its own absolute
        ``deadline`` additionally expires once the engine tick passes
        it (and counts a deadline miss), whatever ``deadline_ticks``
        says.
      waiter_callback: optional ``fn(name, event)`` observer for queued
        streams — called with ``"admitted"`` when a waiter gets its
        lease, ``"expired"`` when aged out by ``deadline_ticks`` or its
        own ticket deadline, and ``"shed"`` when a stream is declined
        without ever queueing (admission ``"shed"`` or a full tenant
        queue).  Every admission attempt sees **exactly one** terminal
        event: ``admitted`` xor ``expired`` xor ``shed`` — never both
        of the failure events, even when the stream was declined only
        after a partial idle-lease reclaim.
      ring_slots: ring capacity per KV/ring leaf in token slots for the
        traffic model; ``None`` means ``max_len`` (no wrap within one
        ``generate``).  Smaller values exercise overwrite evictions.
      repack_stall_threshold: accumulated ``stall_cycles`` above which a
        ``stall_feedback`` engine re-homes a tenant (ignored otherwise).
      keep_reports: recent per-batch reports retained for inspection; the
        aggregate (``last_report`` / ``n_sched_steps``) is exact
        regardless, so a long-lived engine stays bounded.
      device: where the fabric's allocator keeps its slot tables and runs
        its search and prepare kernels — ``"cuda"`` (default; raises
        without a CUDA device) or ``"cpu"`` (the kernels' plain PyTorch
        versions).  Resolved only when ``track_transfers`` builds a
        fabric; the model's tensors stay wherever the model put them.
    """
    model: object
    cfg: ArchConfig
    max_len: int = 256
    # NoM cache-transfer scheduling (set track_transfers=False to opt out).
    track_transfers: bool = True
    # A Mesh3D runs the single-stack NomFabric path; a StackedTopology
    # (from make_topology(n_stacks>1, ...)) swaps in a FabricCluster and
    # global bank ids, enabling cross-stack placement and migrate_tenant.
    cache_mesh: Mesh3D | StackedTopology = dataclasses.field(
        default_factory=make_topology)
    n_slots: int = 16
    max_extra_slots: int = 3
    keep_reports: int = 256
    placement_policy: str = "spread"
    sched_policy: str = "arrival"
    admission: str = "queue"
    admission_strategy: str = "fifo"
    control_plane: str = "vector"
    tenant_queue_depth: int = 8
    idle_evict_ticks: int = 4
    deadline_ticks: int = 0
    waiter_callback: object = None
    ring_slots: int | None = None
    repack_stall_threshold: int = 64
    device: str | torch.device = "cuda"

    def __post_init__(self):
        if self.admission not in _ADMISSION:
            raise ValueError(f"unknown admission mode {self.admission!r}; "
                             f"choose from {tuple(_ADMISSION)}")
        if self.control_plane not in CONTROL_PLANES:
            raise ValueError(
                f"unknown control plane {self.control_plane!r}; "
                f"choose from {CONTROL_PLANES}")
        self._vec = self.control_plane == "vector"
        # Resolve the drain-order strategy up front so a typo fails at
        # construction, not at the first overloaded tick.
        self._admission_fn = get_admission(self.admission_strategy)
        # The serve step is built on first use, as jax.jit compiles on
        # first call: a model-free engine (CacheStub) never builds one.
        self._step = None
        stacked = isinstance(self.cache_mesh, StackedTopology)
        self.fabric = None
        if self.track_transfers:
            self.device = resolve_device(self.device)
            if stacked:
                self.fabric = FabricCluster(
                    topology=self.cache_mesh, n_slots=self.n_slots,
                    policy=self.sched_policy,
                    overflow=_ADMISSION[self.admission], device=self.device)
            else:
                self.fabric = NomFabric(
                    mesh=self.cache_mesh, n_slots=self.n_slots,
                    policy=self.sched_policy,
                    overflow=_ADMISSION[self.admission], device=self.device)
        self.pool = (BankPool(self.cache_mesh, self.placement_policy)
                     if self.track_transfers else None)
        # Waiting streams, under the same bounded-queue semantics as the
        # fabric's request admission (shed when this queue is full too).
        self.tenant_queue = AdmissionQueue(
            depth=self.tenant_queue_depth,
            overflow=_ADMISSION[self.admission])
        # Vectorized control-plane state: the packed SoA mirror of the
        # tenant queue (rebuilt lazily when the backing list is mutated
        # from outside the engine), the O(1) queued-name index, and the
        # SoA table of active tenants.  All engine-internal mutations go
        # through _q_push/_q_compact, which keep the mirrors exact.
        self._q_dirty = False
        self._q_guard = False
        self._cols = TicketColumns()
        self._queued_names: set[str] = set()
        self._table = _TenantTable()
        self.tenant_queue.items = _ObservedList(
            self.tenant_queue.items, self._queue_mutated_externally)
        self._tenants: dict[str, _Tenant] = {}
        self._tenant_stalls: dict[str, int] = {}   # per-tenant stall cycles
        self._reclaimed: set[str] = set()  # idle-evicted, owner not yet told
        self._gen_seq = 0
        self._tick = 0             # schedule_tick counter (idle detection)
        self._admit_seq = 0        # arrival order: the universal tie-break
        self._klass_admits: dict[str, int] = {}  # frequency signal
        self._class_stats: dict[str, dict] = {}  # per-klass outcome counts
        self._leaf_cache: dict[int, list] = {}   # batch -> leaf specs
        self.reports: list[ScheduleReport] = []
        self.last_report: ScheduleReport | None = None
        self.n_sched_steps = 0
        self.n_repacks = 0
        self.n_migrations = 0
        self.n_idle_evictions = 0
        self.n_queue_expired = 0
        self.n_deadline_misses = 0
        self.n_admitted_late = 0
        self.peak_tenants = 0

    # -- cache leaf inventory ----------------------------------------------
    def _leaf_specs(self, batch: int) -> list[LeafSpec]:
        """Describe every cache leaf for placement.

        Probed by shape at two cache lengths: a leaf whose
        size scales with ``max_len`` (KV / ring buffers) moves one
        token-slot per step (the size slope) and wraps at ``ring_slots``;
        a length-independent leaf (SSM / RG-LRU state) is refreshed in
        place every step and never wraps.  ``lease_bytes`` is the full
        footprint, scrubbed at teardown.  Specs depend only on ``batch``
        (model and ``max_len`` are fixed per engine), so they are cached —
        the load generator re-probes the same batch sizes thousands of
        times per run.

        The caches are probed on the ``meta`` device, so nothing is
        allocated: through the model's ``cache_layout`` where it has one
        (the port's models keep one cache per layer and lay them out here
        as the reference's scan-grouped tree), else through its
        ``init_caches``.  Leaves are flattened in JAX's pytree order
        (dict keys sorted) and tagged with its key strings
        (``"['groups']['l0']['conv']"``), so specs and every request tag
        equal the reference's."""
        cached = self._leaf_cache.get(batch)
        if cached is not None:
            return cached
        half_len = max(1, self.max_len // 2)
        flat_full = _flatten(self._probe_caches(batch, self.max_len))
        flat_half = _flatten(self._probe_caches(batch, half_len))
        ring = self.ring_slots if self.ring_slots is not None else self.max_len
        out = []
        for (tag, lf), (_tag, lh) in zip(flat_full, flat_half):
            nb_full = lf.numel() * lf.element_size()
            nb_half = lh.numel() * lh.element_size()
            if nb_full != nb_half and self.max_len != half_len:
                step = max(1, (nb_full - nb_half)
                           // (self.max_len - half_len))
                out.append(LeafSpec(tag=tag, step_bytes=step,
                                    lease_bytes=nb_full, ring_slots=ring))
            else:
                out.append(LeafSpec(tag=tag, step_bytes=max(1, nb_full),
                                    lease_bytes=nb_full, ring_slots=0))
        self._leaf_cache[batch] = out
        return out

    def _probe_caches(self, batch: int, max_len: int):
        layout = getattr(self.model, "cache_layout", None)
        if layout is not None:
            return layout(batch, max_len)
        with torch.device("meta"):
            return self.model.init_caches(batch, max_len)

    # -- queue mirrors (vectorized control plane) ---------------------------
    def _queue_mutated_externally(self) -> None:
        if not self._q_guard:
            self._q_dirty = True

    def _q_refresh(self) -> None:
        """Resynchronize the packed columns and the queued-name index
        from the queue's backing list after an external mutation."""
        if not self._q_dirty:
            return
        self._cols.rebuild(self.tenant_queue.items)
        self._queued_names = {tk.name for _at, tk
                              in self.tenant_queue.items}
        self._q_dirty = False

    def _q_push(self, at: int, tk: AdmissionTicket) -> None:
        """Queue one waiter, keeping the SoA mirrors exact."""
        self._q_guard = True
        try:
            self.tenant_queue.push(at, tk)
        finally:
            self._q_guard = False
        if self._vec and not self._q_dirty:
            self._cols.append(at, tk)
            self._queued_names.add(tk.name)

    def _q_compact(self, keep: np.ndarray, removed_names) -> None:
        """Drop the queue rows where ``keep`` is False (one mask pass
        over the columns, one rebuild of the backing list)."""
        items = self.tenant_queue.items
        self._q_guard = True
        try:
            items[:] = [it for it, k in zip(items, keep) if k]
        finally:
            self._q_guard = False
        if self._vec and not self._q_dirty:
            self._cols.compact(keep)
            self._queued_names.difference_update(removed_names)

    def _queued(self, name: str) -> bool:
        """Is ``name`` already waiting for admission?  The vector plane
        answers from the name index; the scalar reference scans the
        queue (the O(queue)-per-open cost the index replaces)."""
        if self._vec:
            self._q_refresh()
            return name in self._queued_names
        return any(tk.name == name for _at, tk in self.tenant_queue.items)

    def _context(self) -> AdmissionContext:
        telemetry = self.fabric.telemetry if self.fabric is not None \
            else None
        return AdmissionContext(self._tick, self._klass_admits,
                                fabric=telemetry)

    # -- tenancy ------------------------------------------------------------
    def _evict_idle_tenant(self) -> bool:
        """Reclaim the most-idle tenant's leases (eviction machinery:
        the vacated homes are scrubbed by an INIT batch through the
        fabric).  Returns False when no tenant qualifies as idle."""
        if not self.idle_evict_ticks:
            return False
        if self._vec:
            # One mask over the SoA table; only the idle candidates are
            # touched per-element (for the exact scalar tie-break).
            slots = self._table.idle_slots(self._tick,
                                           self.idle_evict_ticks)
            if not len(slots):
                return False
            idle = [self._tenants[self._table.names[s]] for s in slots]
        else:
            idle = [t for t in self._tenants.values()
                    if self._tick - t.last_active >= self.idle_evict_ticks]
        if not idle:
            return False
        victim = min(idle, key=lambda t: (t.last_active, t.name))
        self.n_idle_evictions += 1
        self.close_tenant(victim.name)
        # The owner still holds the name: its next close_tenant must be
        # a quiet no-op (and schedule_tick must skip it), not an error.
        self._reclaimed.add(victim.name)
        return True

    def _lease_with_reclaim(self, name: str, specs: list[LeafSpec]) -> list:
        """``pool.lease`` with idle-lease reclaim on exhaustion: evict
        one idle tenant at a time (scrubbing its homes) and retry until
        the lease fits or no idle tenant remains."""
        while True:
            try:
                return self.pool.lease(name, specs)
            except RuntimeError:
                if not self._evict_idle_tenant():
                    raise

    def open_tenant(self, name: str, batch: int, queue: bool = True,
                    deadline: int | None = None, priority: float = 1.0,
                    klass: str = "default") -> list | None:
        """Lease bank homes for a new serving stream.

        One tenant per concurrent ``generate`` stream; ``batch`` sizes the
        leaf footprints.  Returns the leases (also kept internally until
        :meth:`close_tenant`).  Raises ``ValueError`` if the name is
        already active or already queued.

        ``deadline`` (absolute engine tick), ``priority``, and ``klass``
        annotate the stream's :class:`AdmissionTicket` — the utility
        signals the engine's ``admission_strategy`` orders waiters by,
        and the axes the per-class telemetry is bucketed on.  A ticket
        still queued after its ``deadline`` expires (one terminal
        ``"expired"`` event); one admitted late counts a deadline miss.

        When the pool is exhausted (after reclaiming idle tenants'
        leases), the engine's ``admission`` mode decides: ``"queue"``
        parks the stream on ``tenant_queue`` and returns None — it is
        admitted automatically when :meth:`close_tenant` frees capacity;
        ``"shed"`` counts the decline and returns None; ``"raise"``
        surfaces the pool's RuntimeError.  ``queue=False`` downgrades
        ``"queue"`` to shed-on-full for callers (like ``generate``) that
        cannot come back for a deferred admission."""
        if self.pool is None:
            raise RuntimeError("track_transfers=False engine has no pool")
        if name in self._tenants:
            raise ValueError(f"tenant {name!r} already active")
        if self._queued(name):
            raise ValueError(f"tenant {name!r} already queued for admission")
        self._reclaimed.discard(name)      # the name is being reused afresh
        tk = AdmissionTicket(
            name=name, batch=batch, klass=klass, priority=float(priority),
            deadline=None if deadline is None else int(deadline),
            seq=self._admit_seq)
        self._admit_seq += 1
        self._class_bucket(klass)["arrivals"] += 1
        try:
            leases = self._lease_with_reclaim(name, self._leaf_specs(batch))
        except RuntimeError:
            if self.admission == "raise":
                raise
            if (self.admission == "shed" or not queue
                    or self.tenant_queue.full()):
                self._finish(tk, self._tick, "shed")
                return None
            self._q_push(self._tick, tk)
            return None
        self._register_tenant(name, leases)
        # Immediate admissions are not waiter events: the caller holds
        # the leases already, so no "admitted" callback fires.
        self._finish(tk, self._tick, "admitted", notify=False)
        return leases

    def _register_tenant(self, name: str, leases: list) -> None:
        slot = self._table.add(name, self._tick, len(leases))
        self._tenants[name] = _Tenant(name=name, leases=leases,
                                      last_active=self._tick, slot=slot)
        self._tenant_stalls[name] = 0
        self.peak_tenants = max(self.peak_tenants, len(self._tenants))

    def _notify_waiter(self, name: str, event: str) -> None:
        if self.waiter_callback is not None:
            self.waiter_callback(name, event)

    def _class_bucket(self, klass: str) -> dict:
        return self._class_stats.setdefault(klass, {
            "arrivals": 0, "admitted": 0, "shed": 0, "expired": 0,
            "deadline_misses": 0, "wait_ticks": 0})

    def _finish(self, tk: AdmissionTicket, at: int, event: str,
                notify: bool = True) -> None:
        """Terminal accounting for one admission attempt — called exactly
        once per ticket, with its single outcome (``admitted`` xor
        ``expired`` xor ``shed``).  Folds the outcome into the per-class
        stats and deadline-miss counters, records the admission wait, and
        (when ``notify``) emits the one ``waiter_callback`` event."""
        stats = self._class_bucket(tk.klass)
        wait = max(0, self._tick - at)
        missed = False
        if event == "admitted":
            stats["admitted"] += 1
            stats["wait_ticks"] += wait
            self._klass_admits[tk.klass] = (
                self._klass_admits.get(tk.klass, 0) + 1)
            self.tenant_queue.record_admit(wait)
            if tk.deadline is not None and self._tick > tk.deadline:
                self.n_admitted_late += 1
                missed = True
        elif event == "expired":
            stats["expired"] += 1
            self.n_queue_expired += 1
            missed = tk.deadline is not None
        elif event == "shed":
            stats["shed"] += 1
            self.tenant_queue.n_shed += 1
            missed = tk.deadline is not None
        if missed:
            self.n_deadline_misses += 1
            stats["deadline_misses"] += 1
        if notify:
            self._notify_waiter(tk.name, event)

    def _drain_order(self, items, ctx: AdmissionContext) -> list | np.ndarray:
        """The strategy's admission order over the queued waiters.  The
        vector plane uses the strategy's attached batched form (one
        numpy lexsort over the packed columns) when it has one; scalar
        engines — and strategies registered without a vector form —
        compute it ticket by ticket.  Either way the permutation is
        validated before any capacity is offered."""
        vec = getattr(self._admission_fn, "vector", None)
        if self._vec and vec is not None:
            self._q_refresh()
            order = np.asarray(vec(self._cols, ctx))
            if (len(order) != len(items)
                    or not np.array_equal(np.sort(order),
                                          np.arange(len(items)))):
                raise ValueError(
                    f"admission strategy {self.admission_strategy!r} "
                    f"returned {order!r}, not a permutation of "
                    f"range({len(items)})")
            return order
        order = list(self._admission_fn(items, ctx))
        if sorted(order) != list(range(len(items))):
            raise ValueError(
                f"admission strategy {self.admission_strategy!r} returned "
                f"{order!r}, not a permutation of range({len(items)})")
        return order

    def _admit_waiting(self) -> None:
        """Offer freed capacity to the waiting streams in strategy order.

        The registered ``admission_strategy`` returns a permutation of
        the queued waiters (every strategy tie-breaks on the ticket's
        arrival ``seq``, so equal-utility streams admit in stable FIFO
        order no matter how the queue list got shuffled).  A waiter that
        does not fit is skipped and keeps its place — unless the strategy
        is ``head_blocking`` (``fifo``), where it ends the drain to
        preserve strict arrival order.

        The vector plane short-circuits the fit test: a lease can only
        succeed with at least ``len(leaf_specs)`` free banks, so waiters
        needing more than the live free count are skipped without a
        ``pool.lease`` exception round-trip, and the drain ends as soon
        as no remaining waiter could possibly fit — identical outcomes,
        O(admitted) pool calls instead of O(queue)."""
        items = self.tenant_queue.items
        if not items:
            return
        ctx = self._context()
        order = self._drain_order(items, ctx)
        head_blocking = getattr(self._admission_fn, "head_blocking", False)
        taken = set()
        if self._vec:
            # Per-waiter bank demand from the packed batch column: probe
            # the leaf specs once per distinct batch size, not per row.
            self._q_refresh()
            uniq, inv = np.unique(self._cols.batch, return_inverse=True)
            counts = np.array([len(self._leaf_specs(int(b)))
                               for b in uniq], np.int64)
            needed = counts[inv]
            min_needed = int(needed.min())
            free = self.pool.free_banks()
            for i in order:
                i = int(i)
                if free < min_needed and not head_blocking:
                    break              # nothing left can possibly fit
                at, tk = items[i]
                if needed[i] > free:
                    # pool.lease would raise: success needs one free
                    # bank per leaf.  Same outcome, no exception.
                    if head_blocking:
                        break
                    continue
                try:
                    leases = self.pool.lease(tk.name,
                                             self._leaf_specs(tk.batch))
                except RuntimeError:
                    if head_blocking:
                        break
                    continue
                free -= len(leases)
                taken.add(i)
                self._register_tenant(tk.name, leases)
                self._finish(tk, at, "admitted")
        else:
            for i in order:
                at, tk = items[i]
                try:
                    leases = self.pool.lease(tk.name,
                                             self._leaf_specs(tk.batch))
                except RuntimeError:
                    if head_blocking:
                        break
                    continue
                taken.add(i)
                self._register_tenant(tk.name, leases)
                self._finish(tk, at, "admitted")
        if taken:
            keep = np.ones(len(items), bool)
            keep[list(taken)] = False
            self._q_compact(keep, {items[i][1].name for i in taken})

    def _expire_waiters(self) -> None:
        """Age the tenant queue: shed streams that waited longer than
        ``deadline_ticks`` (their client has given up; holding a place
        would only block younger arrivals behind a corpse) and ticketed
        streams whose own absolute ``deadline`` has passed — each with
        its one terminal ``"expired"`` event.  The vector plane finds
        the expired set with one boolean mask over the packed columns
        and only touches those rows per-element."""
        items = self.tenant_queue.items
        if not items:
            return
        if self._vec:
            self._q_refresh()
            cols = self._cols
            aged = np.zeros(len(items), bool)
            if self.deadline_ticks:
                aged = self._tick - cols.at >= self.deadline_ticks
            late = (cols.deadline >= 0) & (self._tick > cols.deadline)
            gone = aged | late
            if not gone.any():
                return
            for i in np.flatnonzero(gone):
                at, tk = items[int(i)]
                self._finish(tk, at, "expired")
            self._q_compact(~gone, {items[int(i)][1].name
                                    for i in np.flatnonzero(gone)})
            # An expired head may have been the only thing blocking a
            # smaller waiter that already fits the pool.
            self._admit_waiting()
            return
        kept = []
        for at, tk in items:
            aged = (self.deadline_ticks
                    and self._tick - at >= self.deadline_ticks)
            late = tk.deadline is not None and self._tick > tk.deadline
            if aged or late:
                self._finish(tk, at, "expired")
            else:
                kept.append((at, tk))
        if len(kept) < len(items):
            items[:] = kept
            self._admit_waiting()

    def tenants(self) -> list[str]:
        """Names of the currently active (admitted) tenants."""
        return list(self._tenants)

    def close_tenant(self, name: str) -> ScheduleReport | None:
        """Tear a stream down: schedule one INIT scrub per vacated home
        (through the same fabric batch), release the leases, admit any
        waiting streams that now fit, and return that final batch's
        report.  A tenant whose leases were already reclaimed by idle
        eviction closes as a quiet no-op (returns None) — the revocation
        happened behind the owner's back."""
        if name in self._reclaimed:
            self._reclaimed.discard(name)
            return None
        if name not in self._tenants:
            raise ValueError(f"tenant {name!r} is not active "
                             "(never opened, or already closed)")
        ten = self._tenants.pop(name)
        self._table.drop(ten.slot)
        self._tenant_stalls.pop(name, None)
        reqs = teardown_requests(ten.leases)
        self.pool.release(name)
        report = self._schedule_batch(reqs) if reqs else None
        self._admit_waiting()
        return report

    def migrate_tenant(self, name: str,
                       dst_stack: int) -> ScheduleReport | None:
        """Move a live tenant's cache homes onto another stack.

        Requires a :class:`~repro_torch.core.topology.StackedTopology`
        engine.  The pool re-homes every lease onto ``dst_stack``
        (:meth:`BankPool.migrate`), then one fabric batch carries the
        tenant's state across: a cross-stack COPY per leaf (old home →
        new home, full leased footprint, streamed through the SerDes
        links) followed by teardown INIT scrubs of the vacated homes —
        the paper's bulk-transfer + initialization mix at tenant
        granularity.  Returns that batch's report, or None when the
        migration was a no-op (already on ``dst_stack``, or the
        destination cannot fit the tenant — placement is then
        unchanged)."""
        if self.pool is None:
            raise RuntimeError("track_transfers=False engine has no pool")
        if name not in self._tenants:
            raise ValueError(f"tenant {name!r} is not active "
                             "(never opened, or already closed)")
        ten = self._tenants[name]
        old, fresh = self.pool.migrate(name, dst_stack)
        if not fresh:
            return None
        # Leases already on dst_stack were kept in place by the pool.
        ten.leases = self.pool.leases(name)
        self._table.lease_count[ten.slot] = len(ten.leases)
        reqs = [TransferRequest(
            src=o.home, dst=f.home,
            nbytes=max(o.leaf.lease_bytes, o.leaf.step_bytes, 1),
            tag=(name, o.leaf.tag, "migrate"),
            max_extra_slots=self.max_extra_slots)
            for o, f in zip(old, fresh)]
        reqs += teardown_requests(old)
        self.n_migrations += 1
        return self._schedule_batch(reqs)

    def schedule_tick(self, tenants: list[str] | None = None
                      ) -> ScheduleReport | None:
        """Schedule one step's transfer set for the named tenants (default:
        all active) as a single concurrent batch, advancing each tenant's
        write position.  This is the scheduler-side heartbeat: ``generate``
        calls it once per model step for its own tenant; the tenancy
        benchmark drives many tenants through it without a model."""
        names = list(self._tenants) if tenants is None else tenants
        self._tick += 1
        self._expire_waiters()
        reqs = []
        for name in names:
            if name in self._reclaimed:
                continue               # idle-evicted: nothing left to move
            if name not in self._tenants:
                raise ValueError(f"tenant {name!r} is not active "
                                 "(never opened, or already closed)")
            ten = self._tenants[name]
            reqs += step_requests(ten.leases, ten.pos,
                                  max_extra_slots=self.max_extra_slots)
            ten.pos += 1
            ten.last_active = self._tick
            self._table.touch(ten.slot, self._tick)
        if not reqs:
            return None
        report = self._schedule_batch(reqs)
        for name in names:
            if name in self._tenants:      # reclaimed names have no state
                self._maybe_repack(self._tenants[name])
        return report

    def _maybe_repack(self, ten: _Tenant) -> None:
        """Stall feedback: re-home a tenant whose *own* circuits queue too
        long (per-tenant stall attribution, accumulated in
        ``_schedule_batch``).  The vacated homes are scrubbed by an INIT
        batch scheduled *immediately* — the pool has already freed those
        banks, so the scrub must land before anyone can re-lease them."""
        if self.placement_policy != "stall_feedback":
            return
        stalls = self._tenant_stalls.get(ten.name, 0) - ten.stall_mark
        evicted, fresh = self.pool.repack(ten.name, stalls,
                                          self.repack_stall_threshold)
        if evicted:
            ten.leases = fresh
            ten.stall_mark = self._tenant_stalls.get(ten.name, 0)
            self.n_repacks += 1
            self._schedule_batch(teardown_requests(evicted))

    # -- scheduling ----------------------------------------------------------
    def _schedule_batch(self, reqs) -> ScheduleReport:
        """Run one transfer batch through the fabric session and fold
        its report into the aggregates; per-request queueing delay is
        attributed to the owning tenant (the first tag element) for the
        stall-feedback policy.  The fabric's clock advances past the
        batch's drain (a model-forward pass dwarfs the cache-flush
        streaming time)."""
        results, report = self.fabric.schedule(reqs)
        cycle = self.fabric.last_cycle
        for rq, res in zip(reqs, results):
            if res.circuit is None or not isinstance(rq.tag, tuple):
                continue
            name = rq.tag[0]
            if name in self._tenant_stalls:
                self._tenant_stalls[name] += max(
                    0, res.circuit.start_cycle - (cycle + 3))
        self.reports.append(report)
        del self.reports[:-self.keep_reports]
        self.n_sched_steps += 1
        self.last_report = (report if self.last_report is None
                            else self.last_report.merge(report))
        return report

    # -- decoding -------------------------------------------------------------
    def generate(self, prompt: torch.Tensor, n_new: int,
                 tenant: str | None = None) -> torch.Tensor:
        """prompt: (B, P) int on the model's device -> (B, P + n_new), the
        prompt kept.  The prompt is fed token by token through the decode
        step, as the reference does, then ``n_new`` tokens are chosen
        greedily.

        The stream runs as a tenant of the bank pool (name ``tenant``,
        auto-generated when None): leases open before prefill, every
        prefill/decode step emits its cache movement through
        :meth:`schedule_tick`, and completion tears the tenant down with
        INIT scrubs (unless ``track_transfers=False``).  A stream the
        pool cannot admit (exhausted even after idle-lease reclaim) is
        *shed from tracking* — tokens still stream, but its cache
        movement is not scheduled (counted in ``shed_tenants``); under
        ``admission="raise"`` the exhaustion raises instead.  Telemetry
        lands on ``self.reports`` / ``self.last_report`` /
        :meth:`transfer_telemetry`.  The tokens do not depend on
        tracking.
        """
        if self._step is None:
            self._step = make_serve_step(self.model, self.cfg)
        b, plen = prompt.shape
        caches = self.model.init_caches(b, self.max_len)
        name = None
        if self.fabric is not None:
            name = tenant or f"gen{self._gen_seq}"
            self._gen_seq += 1
            # queue=False: generate cannot return for a deferred
            # admission, so "queue" mode degrades to shed-on-full here.
            if self.open_tenant(name, b, queue=False) is None:
                name = None
        logits = None
        try:
            for i in range(plen):
                logits, caches = self._step(prompt[:, i:i + 1], caches, i)
                if name is not None:
                    self.schedule_tick([name])
            out = [prompt]
            tok = logits[:, -1:].argmax(-1).to(prompt.dtype)
            out.append(tok)
            for i in range(plen, plen + n_new - 1):
                logits, caches = self._step(tok, caches, i)
                tok = logits[:, -1:].argmax(-1).to(prompt.dtype)
                out.append(tok)
                if name is not None:
                    self.schedule_tick([name])
        finally:
            if name is not None and (name in self._tenants
                                     or name in self._reclaimed):
                self.close_tenant(name)
        return torch.cat(out, dim=1)

    def transfer_telemetry(self) -> dict:
        """Aggregate transfer-scheduling stats over the engine's lifetime.

        Keys: ``steps`` (scheduled batches, incl. teardown), ``requests``
        / ``scheduled`` / ``batch_avg``, ``init_requests`` (eviction +
        teardown INITs), concurrency (``max_inflight`` /
        ``avg_inflight``), ``stall_cycles``, ``search_rounds`` /
        ``conflicts``, tenancy (``active_tenants`` / ``peak_tenants`` /
        ``repacks`` / ``migrations`` / ``cross_stack`` — scheduled
        cross-stack circuits, nonzero only on a stacked engine), and
        admission health (``admission`` / ``admission_strategy`` /
        ``control_plane`` — ``"vector"`` or ``"scalar"`` —
        ``sched_policy`` — the fabric's live policy pick —
        ``queued_tenants`` / ``shed_tenants`` / ``tenant_queue_expired``
        / ``idle_evictions`` / ``deadline_misses`` — expired, shed, or
        late-admitted ticketed streams — / ``admitted_late`` /
        ``admission_wait_p50`` / ``admission_wait_p99`` — admission-wait
        quantiles in engine ticks — / ``admission_classes`` — per-
        service-class outcome counts)."""
        if not self.n_sched_steps:
            return {}
        agg = self.last_report
        return {
            "steps": self.n_sched_steps,
            "requests": agg.n_requests,
            "scheduled": agg.n_scheduled,
            "batch_avg": agg.n_requests / self.n_sched_steps,
            "init_requests": agg.n_init,
            "max_inflight": agg.max_inflight,
            "avg_inflight": agg.avg_inflight,
            "stall_cycles": agg.stall_cycles,
            "search_rounds": agg.search_rounds,
            "conflicts": agg.conflicts,
            "active_tenants": len(self._tenants),
            "peak_tenants": self.peak_tenants,
            "repacks": self.n_repacks,
            "migrations": self.n_migrations,
            "cross_stack": getattr(agg, "n_cross_stack", 0),
            "admission": self.admission,
            "admission_strategy": self.admission_strategy,
            "control_plane": self.control_plane,
            "sched_policy": self.fabric.effective_policy,
            "queued_tenants": len(self.tenant_queue.items),
            "shed_tenants": self.tenant_queue.n_shed,
            "tenant_queue_expired": self.n_queue_expired,
            "idle_evictions": self.n_idle_evictions,
            "deadline_misses": self.n_deadline_misses,
            "admitted_late": self.n_admitted_late,
            "admission_wait_p50": self.tenant_queue.wait_quantile(0.50),
            "admission_wait_p99": self.tenant_queue.wait_quantile(0.99),
            "admission_classes": {k: dict(v) for k, v
                                  in sorted(self._class_stats.items())},
        }
