"""Utility-aware tenant-admission strategies for the serving engine (port
of ``repro.serving.admission``).

The engine's tenant queue used to drain strictly FIFO (with aging).
Under sustained overload that is the wrong discipline for almost every
real serving contract: a latency-class stream with a 3-tick admission
deadline rots behind a bulk stream that would be equally happy admitted
a hundred ticks from now.  This module makes the *order* in which the
engine drains its waiting streams a first-class, registered strategy —
the same registry idiom as the fabric's packing policies
(:func:`repro_torch.core.fabric.register_policy`), applied one layer up, to
*admission* instead of slot packing.

Vocabulary:

* an :class:`AdmissionTicket` is one admission attempt — the stream's
  name and batch plus its utility annotations (``klass``, ``priority``,
  absolute-tick ``deadline``) and the arrival sequence number ``seq``
  that every strategy uses as the final tie-break (stable FIFO among
  equals, independent of any dict/set iteration order);
* a strategy is ``fn(waiters, ctx) -> iterable[int]`` returning the
  *admission order* — a permutation of ``range(len(waiters))`` over the
  queued ``(arrival_tick, ticket)`` pairs.  Earlier positions get first
  claim on freed bank capacity;
* :class:`AdmissionContext` is what a strategy may consult besides the
  waiters themselves (the engine tick, per-class admission frequencies,
  and — new — the fabric's stall/queue-wait telemetry).

Shipped strategies (:func:`registered_admissions`):

``"fifo"``
    Arrival order, head-blocking: a stream that does not fit blocks
    everything behind it, exactly the engine's pre-registry behavior.
``"deadline"``
    Strictest-deadline-first: ticketed waiters by ascending absolute
    deadline, then the deadline-less ones FIFO.  The Icarus
    ``StrictestDeadlineFirst`` discipline applied to tenant admission.
``"priority"``
    Frequency/priority-weighted: descending ``priority *
    (1 + admitted_so_far(klass))`` — a class that keeps being admitted
    is a class the operator keeps paying for (the ``MostFrequentlyUsed``
    analogue), with the static priority as the base utility.
``"hybrid"``
    Deadline waiters inside the urgency window (:data:`HYBRID_SLACK`
    ticks of slack) go first, strictest-first; everything else falls
    back to the priority weighting — urgent SLOs preempt, bulk traffic
    is otherwise utility-ordered.
``"stall_aware"``
    Telemetry-coupled: while the fabric underneath is healthy
    (:meth:`AdmissionContext.stall_pressure` at or below
    :data:`STALL_PRESSURE` stall cycles per scheduled circuit) it is
    exactly the ``deadline`` discipline; once the fabric is stalling,
    the lightest waiters (smallest ``batch`` — the fewest new circuits
    per tick) admit first, so admission stops feeding a congested
    fabric its heaviest streams.

New strategies register with :func:`register_admission` without touching
the engine; :func:`unregister_admission` removes experiments (built-ins
are protected).  ``Engine(admission_strategy=...)`` selects per engine;
per-class outcomes land in ``Engine.transfer_telemetry()``.

Vectorized control plane
------------------------

At the scale the ROADMAP aims for (millions of tenant arrivals per run)
a per-waiter ``sorted(..., key=lambda)`` is the control plane's
bottleneck, not the fabric.  Every built-in therefore ships a second,
*vectorized* form operating on :class:`TicketColumns` — the packed
structure-of-arrays mirror of the queue (``seq`` / ``deadline`` /
``priority`` / klass-id / ``batch`` / arrival tick as numpy columns) —
computing the identical permutation as one ``numpy.lexsort`` per drain.
``register_admission(name, vector=...)`` attaches the vector form;
strategies without one (experiments) simply fall back to the scalar
function.  ``tests/test_torch_serving.py`` holds both forms of every
built-in to the reference's orders.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np

#: Slack (in engine ticks) under which the hybrid strategy treats a
#: deadline waiter as urgent and lets it preempt the priority ordering.
HYBRID_SLACK = 8

#: Fabric stall pressure (stall cycles per scheduled circuit) above
#: which the ``stall_aware`` strategy switches from deadline order to
#: lightest-first admission.
STALL_PRESSURE = 2.0


@dataclasses.dataclass(frozen=True)
class AdmissionTicket:
    """One tenant-admission attempt and its utility annotations.

    Attributes:
      name: tenant name (the ``generate`` stream / ``open_tenant`` name).
      batch: batch size the leaf footprints are built for.
      klass: service-class label for per-class telemetry and the
        frequency weighting (``"default"`` when the caller is classless).
      priority: static utility weight; higher admits earlier under the
        ``priority``/``hybrid`` strategies (1.0 = neutral).
      deadline: absolute engine tick by which admission is still useful;
        ``None`` means no SLO.  A waiter still queued *after* its
        deadline is expired (one terminal ``"expired"`` event) and a
        waiter admitted late counts as a deadline miss.
      seq: global arrival sequence number — the universal tie-break, so
        equal-utility waiters always admit in stable FIFO order.
    """
    name: str
    batch: int
    klass: str = "default"
    priority: float = 1.0
    deadline: int | None = None
    seq: int = 0


class AdmissionContext:
    """What an admission strategy may look at besides the waiters.

    Attributes:
      tick: the engine tick the drain runs at (slack = deadline - tick).
      klass_admits: admissions granted so far per service class — the
        frequency signal the ``priority`` strategy weights by.
      fabric: the engine's fabric telemetry snapshot (the dict
        ``NomFabric.telemetry()`` / ``FabricCluster.telemetry()``
        returns), resolved lazily on first access so strategies that
        never look pay nothing; ``{}`` when the engine runs without a
        fabric.
    """

    def __init__(self, tick: int, klass_admits: Mapping[str, int],
                 fabric=None):
        self.tick = tick
        self.klass_admits = klass_admits
        self._fabric = fabric

    def frequency(self, klass: str) -> int:
        """Admissions granted to ``klass`` so far (0 for a new class)."""
        return self.klass_admits.get(klass, 0)

    @property
    def fabric(self) -> Mapping:
        """The fabric telemetry mapping (lazily resolved; ``{}`` when
        the engine has no fabric)."""
        if callable(self._fabric):
            self._fabric = self._fabric()
        return self._fabric or {}

    def stall_pressure(self) -> float:
        """Fabric stall cycles per scheduled circuit — the congestion
        signal ``stall_aware`` switches on (0.0 without a fabric)."""
        tel = self.fabric
        return tel.get("stall_cycles", 0) / max(1, tel.get("scheduled", 0))


class TicketColumns:
    """Packed structure-of-arrays mirror of a tenant admission queue.

    One row per queued ``(arrival_tick, AdmissionTicket)`` pair, in
    queue-list order; columns are numpy arrays (``at`` arrival tick,
    ``seq``, ``deadline`` with ``-1`` for deadline-less, ``priority``,
    ``klass`` id, ``batch``), capacity-doubled so :meth:`append` is
    amortized O(1) and :meth:`compact` is one boolean-mask pass.  Klass
    labels are interned to small ints (``klass_names`` maps back);
    :meth:`frequencies` expands a per-klass admission count mapping to a
    per-row vector.  This is what the vector form of a strategy sorts —
    one ``numpy.lexsort`` over columns instead of a Python ``sorted``
    over tickets.
    """

    _FIELDS = (("at", np.int64), ("seq", np.int64), ("deadline", np.int64),
               ("priority", np.float64), ("klass", np.int32),
               ("batch", np.int64))

    def __init__(self, capacity: int = 64):
        self.n = 0
        self._cap = max(1, capacity)
        for name, dt in self._FIELDS:
            setattr(self, "_" + name, np.zeros(self._cap, dt))
        self._klass_ids: dict[str, int] = {}
        self.klass_names: list[str] = []

    def __len__(self) -> int:
        return self.n

    def __getattr__(self, name):
        # Column views: cols.seq is the live prefix of the backing array.
        if any(name == f for f, _dt in self._FIELDS):
            return getattr(self, "_" + name)[:self.n]
        raise AttributeError(name)

    def klass_id(self, klass: str) -> int:
        """Intern a klass label to its small-int column value."""
        kid = self._klass_ids.get(klass)
        if kid is None:
            kid = self._klass_ids[klass] = len(self.klass_names)
            self.klass_names.append(klass)
        return kid

    def _grow(self, need: int) -> None:
        while self._cap < need:
            self._cap *= 2
        for name, _dt in self._FIELDS:
            old = getattr(self, "_" + name)
            fresh = np.zeros(self._cap, old.dtype)
            fresh[:self.n] = old[:self.n]
            setattr(self, "_" + name, fresh)

    def append(self, at: int, tk: AdmissionTicket) -> None:
        """Add one queued waiter's row (amortized O(1))."""
        if self.n == self._cap:
            self._grow(self.n + 1)
        i = self.n
        self._at[i] = at
        self._seq[i] = tk.seq
        self._deadline[i] = -1 if tk.deadline is None else tk.deadline
        self._priority[i] = tk.priority
        self._klass[i] = self.klass_id(tk.klass)
        self._batch[i] = tk.batch
        self.n = i + 1

    def compact(self, keep: np.ndarray) -> None:
        """Drop the rows where boolean ``keep`` is False (one mask pass)."""
        kept = int(np.count_nonzero(keep))
        if kept == self.n:
            return
        for name, _dt in self._FIELDS:
            col = getattr(self, "_" + name)
            col[:kept] = col[:self.n][keep]
        self.n = kept

    def rebuild(self, items) -> None:
        """Resynchronize from the queue's backing list (used after an
        external mutation of ``AdmissionQueue.items`` is detected)."""
        self.n = 0
        if len(items) > self._cap:
            self._grow(len(items))
        for at, tk in items:
            self.append(at, tk)

    def frequencies(self, klass_admits: Mapping[str, int]) -> np.ndarray:
        """Per-row admitted-so-far counts for the rows' klasses."""
        table = np.array([klass_admits.get(k, 0)
                          for k in self.klass_names], np.float64)
        if not len(table):
            return np.zeros(self.n, np.float64)
        return table[self.klass]


_ADMISSIONS: dict[str, object] = {}
_BUILTINS = ("fifo", "deadline", "priority", "hybrid", "stall_aware")


def register_admission(name: str, *, head_blocking: bool = False,
                       vector=None):
    """Decorator registering an admission strategy under ``name``.

    A strategy is ``fn(waiters, ctx: AdmissionContext) -> iterable[int]``
    over the queued ``(arrival_tick, AdmissionTicket)`` pairs, returning
    a permutation of ``range(len(waiters))`` — the order freed capacity
    is offered in.  ``head_blocking=True`` keeps strict queue semantics:
    the first waiter that does not fit blocks the rest of the drain
    (``fifo`` uses this to preserve exact arrival order); the default is
    best-effort — a waiter that does not fit is skipped and keeps its
    place for the next drain.  ``vector`` optionally attaches the
    batched form ``vec(cols: TicketColumns, ctx) -> numpy permutation``
    that a vectorized engine uses instead of the scalar function — it
    must compute the *identical* order.  Registering a taken name raises
    ``ValueError``.
    """
    def deco(fn):
        if name in _ADMISSIONS:
            raise ValueError(f"admission strategy {name!r} is already "
                             "registered")
        fn.head_blocking = head_blocking
        fn.vector = vector
        _ADMISSIONS[name] = fn
        return fn
    return deco


def unregister_admission(name: str) -> None:
    """Remove a registered strategy (the built-ins may not be removed)."""
    if name in _BUILTINS:
        raise ValueError(f"built-in admission strategy {name!r} may not "
                         "be removed")
    if name not in _ADMISSIONS:
        raise ValueError(f"admission strategy {name!r} is not registered")
    del _ADMISSIONS[name]


def registered_admissions() -> tuple[str, ...]:
    """Strategy names currently registered, registration order."""
    return tuple(_ADMISSIONS)


def get_admission(name: str):
    """Look up a strategy by name; unknown names raise ``ValueError``
    listing what is registered."""
    try:
        return _ADMISSIONS[name]
    except KeyError:
        raise ValueError(
            f"unknown admission strategy {name!r}; registered: "
            f"{', '.join(_ADMISSIONS)}") from None


def _seq(waiters, i: int) -> int:
    return waiters[i][1].seq


# -- vector forms ------------------------------------------------------------
# Each computes the exact permutation its scalar twin returns.  lexsort
# orders by the LAST key first, so every form passes ``cols.seq`` as the
# first (least-significant) key — the universal FIFO tie-break.

def _fifo_vec(cols: TicketColumns, ctx: AdmissionContext) -> np.ndarray:
    return np.argsort(cols.seq, kind="stable")


def _deadline_keys(cols: TicketColumns):
    has = cols.deadline >= 0
    return np.where(has, cols.deadline, 0), (~has).astype(np.int64)


def _deadline_vec(cols: TicketColumns, ctx: AdmissionContext) -> np.ndarray:
    dl, no_dl = _deadline_keys(cols)
    return np.lexsort((cols.seq, dl, no_dl))


def _weight_vec(cols: TicketColumns, ctx: AdmissionContext) -> np.ndarray:
    return cols.priority * (1.0 + cols.frequencies(ctx.klass_admits))


def _priority_vec(cols: TicketColumns, ctx: AdmissionContext) -> np.ndarray:
    return np.lexsort((cols.seq, -_weight_vec(cols, ctx)))


def _hybrid_vec(cols: TicketColumns, ctx: AdmissionContext) -> np.ndarray:
    has = cols.deadline >= 0
    slack = cols.deadline - ctx.tick
    urgent = has & (slack <= HYBRID_SLACK)
    k1 = (~urgent).astype(np.int64)                 # urgent first
    k2 = np.where(urgent, slack, 0)                 # strictest first
    k3 = np.where(urgent, 0.0, -_weight_vec(cols, ctx))
    return np.lexsort((cols.seq, k3, k2, k1))


def _stall_aware_vec(cols: TicketColumns,
                     ctx: AdmissionContext) -> np.ndarray:
    if ctx.stall_pressure() <= STALL_PRESSURE:
        return _deadline_vec(cols, ctx)
    dl, no_dl = _deadline_keys(cols)
    return np.lexsort((cols.seq, dl, no_dl, cols.batch))


# -- scalar forms (the reference semantics) ----------------------------------

@register_admission("fifo", head_blocking=True, vector=_fifo_vec)
def _fifo(waiters, ctx: AdmissionContext):
    """Stable arrival order (by ticket ``seq``, never list position),
    head-blocking — the engine's legacy discipline."""
    return sorted(range(len(waiters)), key=lambda i: _seq(waiters, i))


@register_admission("deadline", vector=_deadline_vec)
def _deadline(waiters, ctx: AdmissionContext):
    """Strictest-deadline-first; deadline-less waiters trail in FIFO
    order.  Ties (equal deadlines) break by arrival ``seq``."""
    def key(i):
        tk = waiters[i][1]
        has = tk.deadline is not None
        return (0 if has else 1, tk.deadline if has else 0, tk.seq)
    return sorted(range(len(waiters)), key=key)


def _weight(tk: AdmissionTicket, ctx: AdmissionContext) -> float:
    return tk.priority * (1.0 + ctx.frequency(tk.klass))


@register_admission("priority", vector=_priority_vec)
def _priority(waiters, ctx: AdmissionContext):
    """Descending frequency-weighted priority
    (``priority * (1 + admitted_so_far(klass))``), FIFO among equals."""
    return sorted(range(len(waiters)),
                  key=lambda i: (-_weight(waiters[i][1], ctx),
                                 _seq(waiters, i)))


@register_admission("hybrid", vector=_hybrid_vec)
def _hybrid(waiters, ctx: AdmissionContext):
    """Urgent deadlines first, utility-weighted otherwise: a deadline
    waiter with slack <= :data:`HYBRID_SLACK` preempts (strictest
    first); the rest order by the ``priority`` weighting.  Every tie
    breaks by arrival ``seq``."""
    def key(i):
        tk = waiters[i][1]
        slack = None if tk.deadline is None else tk.deadline - ctx.tick
        if slack is not None and slack <= HYBRID_SLACK:
            return (0, slack, 0.0, tk.seq)
        return (1, 0, -_weight(tk, ctx), tk.seq)
    return sorted(range(len(waiters)), key=key)


@register_admission("stall_aware", vector=_stall_aware_vec)
def _stall_aware(waiters, ctx: AdmissionContext):
    """Fabric-coupled admission: deadline order while the fabric is
    healthy; lightest-first (ascending ``batch``, then strictest
    deadline, then ``seq``) once :meth:`AdmissionContext.stall_pressure`
    exceeds :data:`STALL_PRESSURE` — a congested fabric should not be
    fed its heaviest waiters first."""
    if ctx.stall_pressure() <= STALL_PRESSURE:
        return _deadline(waiters, ctx)

    def key(i):
        tk = waiters[i][1]
        has = tk.deadline is not None
        return (tk.batch, 0 if has else 1,
                tk.deadline if has else 0, tk.seq)
    return sorted(range(len(waiters)), key=key)


__all__ = ["HYBRID_SLACK", "STALL_PRESSURE", "AdmissionContext",
           "AdmissionTicket", "TicketColumns", "get_admission",
           "register_admission", "registered_admissions",
           "unregister_admission"]
