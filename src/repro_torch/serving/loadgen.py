"""Trace-driven open-loop load generation for the serving engine (port of
``repro.serving.loadgen``: the same seeds give the same arrivals).

The paper's headline claim is throughput under *concurrent* transfer
load; the serving analogue is admission behavior under sustained tenant
churn.  This module drives an :class:`~repro_torch.serving.engine.Engine`
tick-by-tick with a seeded open-loop arrival process — arrivals do not
wait for completions, exactly like real traffic — and measures what the
ROADMAP's "millions of users" story needs measured: p50/p99 admission
latency, shed and expiry rates, deadline-miss rates per admission
strategy, and circuits-per-window on the NoM fabric underneath.

Three building blocks:

* :class:`ArrivalMix` — a declarative traffic description: the arrival
  *process* (``"poisson"`` | ``"bursty"`` | ``"heavy_tail"``), the mean
  rate, an optional diurnal ramp, and the service-class table
  (:class:`ClassSpec`: share, priority, deadline slack, lifetime) each
  arrival is drawn from.  :func:`get_mix` serves the built-ins
  (:data:`MIXES`): ``poisson``, ``bursty``, ``heavy_tail``, and the
  overloaded ``deadline_heavy`` mix the SLO benchmark gates on.
* :class:`LoadGen` — the seeded generator: ``arrivals(tick)`` yields the
  tick's :class:`Arrival` records deterministically (one stream of
  draws, consumed in tick order, so a fixed ``(mix, seed)`` pair always
  produces the identical trace).
* :func:`drive` — the harness: feeds a generator into an engine
  (``open_tenant`` with the arrival's ticket annotations,
  ``schedule_tick`` every tick, ``close_tenant`` when a tenant's
  lifetime lapses), observes every terminal admission event through the
  engine's ``waiter_callback``, and returns the stats record (the
  reference's ``benchmarks/bench_serving_slo.py`` writes it into
  ``BENCH_serving.json``).
  ``retry_budget > 0`` closes the loop: shed arrivals re-enter after a
  seeded exponential backoff (bounded attempts, refreshed deadlines),
  with the retry/backoff counts in the record.  Each record carries the
  per-tick conservation ledger (``arrivals == admitted + shed +
  expired + waiting + retrying`` at every tick).

The default engine under test is model-free: :class:`CacheStub` exposes
only ``init_caches`` (a KV-ring + state-leaf pair per stream), so the
harness measures admission and scheduling, not matmuls —
:func:`make_slo_engine` builds the standard stub engine the tests and
the benchmark share.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np

import torch

from repro_torch.core.topology import make_topology
from repro_torch.serving.engine import Engine


@dataclasses.dataclass(frozen=True)
class ClassSpec:
    """One service class of an :class:`ArrivalMix`.

    Attributes:
      klass: class label (lands in per-class telemetry).
      weight: relative share of arrivals drawn from this class.
      priority: static utility weight for the ``priority``/``hybrid``
        admission strategies.
      deadline_slack: ``(lo, hi)`` inclusive tick range — each arrival's
        admission deadline is ``tick + U[lo, hi]``; ``None`` means the
        class carries no admission SLO.
      lifetime: ``(lo, hi)`` inclusive range of service ticks an
        admitted tenant stays open before :func:`drive` closes it.
    """
    klass: str
    weight: float
    priority: float = 1.0
    deadline_slack: tuple[int, int] | None = None
    lifetime: tuple[int, int] = (2, 5)


@dataclasses.dataclass(frozen=True)
class ArrivalMix:
    """A reproducible open-loop traffic description.

    Attributes:
      name: mix label (keys the benchmark record).
      process: ``"poisson"`` (memoryless), ``"bursty"`` (a low poisson
        baseline plus a large burst every ``burst_every`` ticks), or
        ``"heavy_tail"`` (poisson baseline plus Pareto-sized arrival
        clumps with probability ``tail_prob`` per tick).
      rate: mean arrivals per tick before the diurnal ramp.
      classes: the service-class table arrivals are drawn from.
      burst_every / burst_mult: bursty-process shape.
      tail_prob / tail_alpha / tail_cap: heavy-tail shape (Pareto index
        ``tail_alpha``, clump size capped at ``tail_cap``).
      diurnal_period / diurnal_amp: sinusoidal rate ramp — the rate at
        tick t is ``rate * (1 + amp * sin(2 pi t / period))``; period 0
        disables the ramp.
    """
    name: str
    process: str
    rate: float
    classes: tuple[ClassSpec, ...]
    burst_every: int = 16
    burst_mult: float = 6.0
    tail_prob: float = 0.08
    tail_alpha: float = 1.3
    tail_cap: int = 24
    diurnal_period: int = 0
    diurnal_amp: float = 0.0

    def __post_init__(self):
        if self.process not in ("poisson", "bursty", "heavy_tail"):
            raise ValueError(f"unknown arrival process {self.process!r}; "
                             "choose from ('poisson', 'bursty', "
                             "'heavy_tail')")
        if not self.classes:
            raise ValueError("an ArrivalMix needs at least one ClassSpec")


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One generated stream arrival (the loadgen's trace unit)."""
    name: str
    tick: int
    klass: str
    priority: float
    deadline: int | None
    lifetime: int
    batch: int = 1


_STANDARD_CLASSES = (
    ClassSpec("latency", weight=0.3, priority=4.0, deadline_slack=(2, 6),
              lifetime=(1, 3)),
    ClassSpec("standard", weight=0.5, priority=1.0, deadline_slack=None,
              lifetime=(2, 5)),
    ClassSpec("bulk", weight=0.2, priority=0.25, deadline_slack=None,
              lifetime=(4, 8)),
)

#: Built-in arrival mixes (get_mix).  The first three are the paper-style
#: traffic shapes; ``deadline_heavy`` is the sustained-overload mix the
#: benchmark's fifo-vs-deadline dominance gate runs on: most arrivals
#: carry tight admission deadlines, so queue *order* decides the miss
#: rate.
MIXES: dict[str, ArrivalMix] = {
    "poisson": ArrivalMix("poisson", "poisson", rate=2.0,
                          classes=_STANDARD_CLASSES,
                          diurnal_period=64, diurnal_amp=0.5),
    "bursty": ArrivalMix("bursty", "bursty", rate=2.0,
                         classes=_STANDARD_CLASSES,
                         burst_every=16, burst_mult=6.0),
    "heavy_tail": ArrivalMix("heavy_tail", "heavy_tail", rate=1.5,
                             classes=_STANDARD_CLASSES,
                             tail_prob=0.1, tail_alpha=1.3, tail_cap=24),
    "deadline_heavy": ArrivalMix(
        "deadline_heavy", "poisson", rate=3.0,
        classes=(
            ClassSpec("urgent", weight=0.6, priority=4.0,
                      deadline_slack=(2, 5), lifetime=(1, 3)),
            ClassSpec("bulk", weight=0.4, priority=0.5,
                      deadline_slack=None, lifetime=(4, 9)),
        )),
}


def get_mix(name: str) -> ArrivalMix:
    """Look up a built-in mix; unknown names raise ``ValueError``
    listing what exists."""
    try:
        return MIXES[name]
    except KeyError:
        raise ValueError(f"unknown arrival mix {name!r}; built-ins: "
                         f"{', '.join(MIXES)}") from None


class LoadGen:
    """Seeded open-loop arrival generator over an :class:`ArrivalMix`.

    One private RNG stream, consumed strictly in tick order: call
    :meth:`arrivals` once per tick, ticks ascending (enforced), and a
    fixed ``(mix, seed)`` pair replays the identical trace.
    """

    def __init__(self, mix: ArrivalMix, seed: int = 0):
        self.mix = mix
        self.seed = seed
        self._rng = np.random.default_rng(
            (int(seed), zlib.crc32(mix.name.encode())))
        self._seq = 0
        self._next_tick = 0
        w = np.array([c.weight for c in mix.classes], float)
        self._class_p = w / w.sum()
        # Per-class lookup tables for the batched draws: one fancy-index
        # per annotation instead of one rng call per arrival.
        self._dl_has = np.array([c.deadline_slack is not None
                                 for c in mix.classes])
        self._dl_lo = np.array([c.deadline_slack[0] if c.deadline_slack
                                else 0 for c in mix.classes], np.int64)
        self._dl_span = np.array(
            [c.deadline_slack[1] - c.deadline_slack[0] + 1
             if c.deadline_slack else 1 for c in mix.classes], np.int64)
        self._life_lo = np.array([c.lifetime[0] for c in mix.classes],
                                 np.int64)
        self._life_span = np.array(
            [c.lifetime[1] - c.lifetime[0] + 1 for c in mix.classes],
            np.int64)

    def rate_at(self, tick: int) -> float:
        """Instantaneous mean arrival rate at ``tick`` (diurnal ramp
        applied; never negative)."""
        mix = self.mix
        if not mix.diurnal_period:
            return mix.rate
        phase = 2.0 * np.pi * tick / mix.diurnal_period
        return max(0.0, mix.rate * (1.0 + mix.diurnal_amp * np.sin(phase)))

    def _count(self, tick: int) -> int:
        mix, rng = self.mix, self._rng
        rate = self.rate_at(tick)
        if mix.process == "poisson":
            return int(rng.poisson(rate))
        if mix.process == "bursty":
            n = int(rng.poisson(rate * 0.4))
            if mix.burst_every and tick % mix.burst_every == 0:
                n += int(rng.poisson(rate * mix.burst_mult))
            return n
        # heavy_tail: light baseline + occasional Pareto-sized clump.
        n = int(rng.poisson(rate * 0.5))
        if rng.random() < mix.tail_prob:
            n += min(mix.tail_cap, 1 + int(rng.pareto(mix.tail_alpha)
                                           * mix.rate))
        return n

    def arrivals(self, tick: int) -> list[Arrival]:
        """The arrivals landing at ``tick`` (possibly empty).  Must be
        called with strictly increasing ticks — the draw stream is the
        determinism contract.

        The tick's annotations are drawn as three batched RNG calls
        (class indices, deadline uniforms, lifetime uniforms) plus
        per-class table lookups — not one rng round-trip per arrival —
        so a burst of hundreds of arrivals costs the same number of
        generator calls as a quiet tick.  A fixed ``(mix, seed)`` pair
        still replays the identical trace."""
        if tick < self._next_tick:
            raise ValueError(f"arrivals() must be called in tick order "
                             f"(got {tick} after {self._next_tick - 1})")
        self._next_tick = tick + 1
        n = self._count(tick)
        if not n:
            return []
        rng, mix = self._rng, self.mix
        kidx = rng.choice(len(mix.classes), size=n, p=self._class_p)
        # lo + floor(u * span) is uniform over [lo, hi] inclusive.
        deadlines = tick + self._dl_lo[kidx] + (
            rng.random(n) * self._dl_span[kidx]).astype(np.int64)
        lifetimes = self._life_lo[kidx] + (
            rng.random(n) * self._life_span[kidx]).astype(np.int64)
        has_dl = self._dl_has[kidx]
        seq0 = self._seq
        self._seq += n
        return [Arrival(
            name=f"{mix.name}-{seq0 + j}", tick=tick,
            klass=mix.classes[k].klass, priority=mix.classes[k].priority,
            deadline=int(deadlines[j]) if has_dl[j] else None,
            lifetime=int(lifetimes[j]))
            for j, k in enumerate(kidx)]


class CacheStub:
    """Model stub exposing only ``init_caches``: one KV ring leaf (size
    scales with ``max_len``) plus one in-place state leaf per stream —
    the smallest footprint that still exercises ring evictions and
    teardown scrubs (2 leased banks per tenant).  The engine probes it on
    the ``meta`` device, so it never allocates."""

    def init_caches(self, batch, max_len):
        return {"kv": torch.zeros((batch, max_len, 16), dtype=torch.int8),
                "state": torch.zeros((batch, 32), dtype=torch.int8)}


def make_slo_engine(admission_strategy: str = "fifo", *,
                    mesh: tuple[int, int, int] = (4, 4, 2),
                    deadline_ticks: int = 12, tenant_queue_depth: int = 16,
                    device="cuda", **kw) -> Engine:
    """The standard harness engine: a :class:`CacheStub` model over a
    small bank mesh (capacity ~``X*Y*(Z-1)/2`` concurrent tenants, so
    the built-in mixes genuinely overload it), queue admission with
    aging, and the given admission strategy.  The fabric runs on
    ``device`` (``"cuda"`` by default; ``"cpu"`` runs the kernels' plain
    versions).  Extra kwargs pass through to
    :class:`~repro_torch.serving.engine.Engine`."""
    kw.setdefault("ring_slots", 4)
    kw.setdefault("idle_evict_ticks", 0)
    return Engine(model=CacheStub(), cfg=None, max_len=16,
                  cache_mesh=make_topology(mesh=mesh),
                  admission="queue", admission_strategy=admission_strategy,
                  deadline_ticks=deadline_ticks,
                  tenant_queue_depth=tenant_queue_depth, device=device, **kw)


def _quantile(samples: list[int], q: float) -> float:
    if not samples:
        return 0.0
    return float(np.quantile(np.asarray(samples, float), q))


def drive(engine: Engine, mix: ArrivalMix | str, ticks: int,
          seed: int = 0, trace: bool = False, retry_budget: int = 0,
          backoff_base: int = 1, backoff_cap: int = 16) -> dict:
    """Drive ``engine`` with ``mix`` for ``ticks`` engine ticks.

    Open loop by default: every generated arrival is offered to
    ``open_tenant`` with its ticket annotations (deadline/priority/
    klass) regardless of how loaded the engine is; admitted tenants run
    for their drawn lifetime (their cache traffic scheduled by the
    engine's per-tick batch) and are then closed, freeing capacity for
    queued waiters.  The engine's ``waiter_callback`` is borrowed for
    the run (the prior callback is restored on exit) to observe the
    terminal admission events.

    ``retry_budget > 0`` closes the loop: a *shed* arrival re-enters
    after a seeded exponential backoff — attempt ``k`` waits a uniform
    ``1..min(backoff_cap, backoff_base * 2**k)`` ticks, drawn from a
    dedicated RNG stream so enabling retries never perturbs the arrival
    trace — up to ``retry_budget`` re-attempts before the shed is
    final.  A retried ticket's admission deadline is refreshed by the
    arrival's original slack; queue expiries never retry (the client's
    deadline has passed — there is nothing left to serve).

    The per-tick bookkeeping is O(events), not O(live tenants): admitted
    streams land in a due-tick completion bucket (closed when their
    lifetime lapses) instead of a per-tenant countdown scan, and
    terminal outcomes are counters — the harness itself stays off the
    profile at the tenant counts the vectorized control plane serves.

    Returns the stats record: totals (``arrivals`` / ``admitted`` /
    ``shed`` / ``expired`` / ``waiting`` / ``completed``), rates
    (``shed_rate`` / ``expiry_rate``), admission-latency percentiles in
    ticks (``p50_wait`` / ``p99_wait``, measured from the *original*
    arrival tick, so a retried admit reports the client-experienced
    wait), the SLO ledger (``deadline_arrivals`` / ``deadline_misses``
    / ``miss_rate``), the closed-loop ledger (``retry_budget`` /
    ``retries`` — backoff re-entries scheduled — / ``retry_admitted``
    — streams admitted only after retrying — / ``backoff_ticks`` —
    total ticks spent in backoff — / ``retrying`` — still in backoff at
    run end), and fabric-side concurrency (``circuits_per_window`` =
    average circuits in flight per TDM window, ``max_inflight``,
    ``stall_cycles``, ``requests`` / ``scheduled``).  With
    ``trace=True`` the record also carries ``per_tick`` — the
    conservation ledger ``(tick, arrivals, admitted, shed, expired,
    waiting, retrying)`` over which ``arrivals == admitted + shed +
    expired + waiting + retrying`` holds.
    """
    if isinstance(mix, str):
        mix = get_mix(mix)
    gen = LoadGen(mix, seed)
    retry_rng = np.random.default_rng(
        (int(seed), zlib.crc32(mix.name.encode()), 0xB0FF))
    pending: dict[str, Arrival] = {}   # queued or in backoff
    attempts: dict[str, int] = {}      # retries used so far
    in_backoff: set[str] = set()
    due: dict[int, list[str]] = {}     # close tick -> admitted names
    retry_at: dict[int, list[str]] = {}
    n_arrivals = n_admitted = n_shed = n_expired = completed = 0
    n_dead = n_retries = n_retry_admitted = backoff_ticks = 0
    waits: list[int] = []
    events: list[tuple[str, str]] = []
    prior_cb = engine.waiter_callback

    def recorder(name, ev):
        events.append((name, ev))
        if prior_cb is not None:
            prior_cb(name, ev)

    def admit(name: str, t: int) -> None:
        nonlocal n_admitted, n_retry_admitted
        a = pending.pop(name, None)
        if a is None:
            return
        n_admitted += 1
        if attempts.pop(name, 0):
            n_retry_admitted += 1
        waits.append(t - a.tick)
        due.setdefault(t + a.lifetime, []).append(name)

    def fold(t: int) -> None:
        nonlocal n_shed, n_expired, n_retries, backoff_ticks
        for name, ev in events:
            if ev == "admitted":
                admit(name, t)
            elif ev == "shed":
                used = attempts.get(name, 0)
                if used < retry_budget:
                    window = min(backoff_cap, backoff_base * 2 ** used)
                    delay = 1 + int(retry_rng.integers(0, max(1, window)))
                    attempts[name] = used + 1
                    n_retries += 1
                    backoff_ticks += delay
                    retry_at.setdefault(t + delay, []).append(name)
                    in_backoff.add(name)
                else:
                    n_shed += 1
                    pending.pop(name, None)
                    attempts.pop(name, None)
            elif ev == "expired":
                n_expired += 1
                pending.pop(name, None)
                attempts.pop(name, None)
        events.clear()

    engine.waiter_callback = recorder
    per_tick = []
    try:
        for t in range(ticks):
            # Backed-off sheds re-enter first (deadline refreshed by the
            # arrival's original slack), then the tick's fresh arrivals.
            for name in retry_at.pop(t, ()):
                in_backoff.discard(name)
                a = pending[name]
                deadline = (None if a.deadline is None
                            else t + (a.deadline - a.tick))
                if engine.open_tenant(name, a.batch, deadline=deadline,
                                      priority=a.priority,
                                      klass=a.klass) is not None:
                    admit(name, t)
            for a in gen.arrivals(t):
                n_arrivals += 1
                n_dead += a.deadline is not None
                pending[a.name] = a
                if engine.open_tenant(
                        a.name, a.batch, deadline=a.deadline,
                        priority=a.priority, klass=a.klass) is not None:
                    admit(a.name, t)         # admitted on the spot
            engine.schedule_tick()           # ages + drains the queue
            fold(t)
            # Retire tenants whose service lifetime lapsed this tick
            # (admitted at t with lifetime L -> closed at t + L).
            for name in due.pop(t, ()):
                engine.close_tenant(name)    # may admit waiters ...
                completed += 1
            fold(t)                          # ... observed here
            if trace:
                per_tick.append({
                    "tick": t, "arrivals": n_arrivals,
                    "admitted": n_admitted, "shed": n_shed,
                    "expired": n_expired,
                    "waiting": len(engine.tenant_queue.items),
                    "retrying": len(in_backoff)})
    finally:
        engine.waiter_callback = prior_cb
    tel = engine.transfer_telemetry()
    rep = engine.last_report
    misses = tel.get("deadline_misses", 0) if tel else 0
    out = {
        "mix": mix.name, "strategy": engine.admission_strategy,
        "seed": seed, "ticks": ticks,
        "arrivals": n_arrivals, "admitted": n_admitted, "shed": n_shed,
        "expired": n_expired,
        "waiting": len(engine.tenant_queue.items),
        "completed": completed,
        "shed_rate": n_shed / n_arrivals if n_arrivals else 0.0,
        "expiry_rate": n_expired / n_arrivals if n_arrivals else 0.0,
        "p50_wait": _quantile(waits, 0.5),
        "p99_wait": _quantile(waits, 0.99),
        "deadline_arrivals": n_dead,
        "deadline_misses": misses,
        "miss_rate": misses / n_dead if n_dead else 0.0,
        "retry_budget": retry_budget,
        "retries": n_retries,
        "retry_admitted": n_retry_admitted,
        "backoff_ticks": backoff_ticks,
        "retrying": len(in_backoff),
        "circuits_per_window": 0.0 if rep is None else rep.avg_inflight,
        "max_inflight": 0 if rep is None else rep.max_inflight,
        "stall_cycles": 0 if rep is None else rep.stall_cycles,
        "requests": 0 if rep is None else rep.n_requests,
        "scheduled": 0 if rep is None else rep.n_scheduled,
    }
    if trace:
        out["per_tick"] = per_tick
    return out


__all__ = ["MIXES", "Arrival", "ArrivalMix", "CacheStub", "ClassSpec",
           "LoadGen", "drive", "get_mix", "make_slo_engine"]
