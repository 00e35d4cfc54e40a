"""The CCU as a host-side planner (port of the host half of
``repro.core.nom_collectives``).

:func:`nom_reduce` and :func:`nom_allreduce_banks` plan memory-side
fan-in and all-reduce over a bank-level fabric session.
:class:`TransferPlan` routes arbitrary (src, dst) transfer sets DOR over
a device mesh/torus and packs them into link-disjoint rounds via greedy
earliest-slot allocation, the same increasing-slot invariant as
:mod:`repro_torch.core.slot_alloc`.  It backs ``NomFabric``'s ``rounds``
backend.  The device collectives (``nom_all_to_all`` and friends) are
not ported yet.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np


# ---------------------------------------------------------------------------
# Bank-level planners over a fabric session (memory-side reduce)
# ---------------------------------------------------------------------------
def nom_reduce(fabric, srcs, dst: int, nbytes: int = 1, cycle=None):
    """One memory-side fan-in on a fabric session: ``nbytes`` operands
    from each bank in ``srcs`` merged at ``dst`` over a compute-class
    circuit.  The planner spelling every subsystem should use.
    Returns ``(AllocResult, ScheduleReport)``."""
    from .scheduler import reduce_request
    (res,), report = fabric.schedule(
        [reduce_request(srcs, dst, nbytes=nbytes)], cycle=cycle)
    return res, report


def nom_allreduce_banks(fabric, banks, nbytes: int, cycle=None):
    """Memory-side all-reduce of an ``nbytes`` vector replicated across
    ``banks``: a reduce-scatter batch (each bank is the fan-in
    destination of its own shard) followed by an all-gather batch (each
    bank streams its reduced shard to every peer).  Both batches go
    through ``fabric.schedule``, so they pack under the session policy
    and land in its telemetry.  Returns ``(results, report)`` with the
    scatter results first and the two batch reports merged."""
    from .scheduler import TransferRequest, reduce_request
    banks = [int(b) for b in banks]
    if len(set(banks)) != len(banks):
        raise ValueError(f"all-reduce banks must be distinct: {banks}")
    if len(banks) < 2:
        raise ValueError("all-reduce needs at least two banks")
    shard = -(-nbytes // len(banks))
    scatter = [reduce_request([s for s in banks if s != d], d, nbytes=shard,
                              tag=("reduce_scatter", d))
               for d in banks]
    res1, rep1 = fabric.schedule(scatter, cycle=cycle)
    gather = [TransferRequest(src=d, dst=o, nbytes=shard,
                              tag=("allgather", d, o))
              for d in banks for o in banks if o != d]
    res2, rep2 = fabric.schedule(gather)
    return res1 + res2, rep1.merge(rep2)


@dataclasses.dataclass(frozen=True)
class Transfer:
    src: tuple[int, ...]
    dst: tuple[int, ...]
    nbytes: int = 1
    tag: object = None


def _dor_path(src: tuple[int, ...], dst: tuple[int, ...],
              shape: tuple[int, ...], torus: bool) -> list[tuple[tuple, int, int]]:
    """Dimension-ordered route; returns [(node, dim, step), ...] hops."""
    hops = []
    cur = list(src)
    for d in range(len(shape)):
        delta = dst[d] - cur[d]
        if torus and abs(delta) > shape[d] // 2:
            delta -= int(np.sign(delta)) * shape[d]
        step = 1 if delta > 0 else -1
        for _ in range(abs(delta)):
            hops.append((tuple(cur), d, step))
            cur[d] = (cur[d] + step) % shape[d]
    return hops


@dataclasses.dataclass
class TransferPlan:
    """Conflict-free multi-round schedule for a set of point-to-point bulk
    transfers on a device mesh/torus.

    ``rounds[k]`` lists (transfer_index, hop) pairs active in round k; a hop
    is (node, dim, step).  Invariants: within a round every directed link
    appears at most once, and each transfer's i-th hop runs in round
    start_i + i (data advances one hop per round with no buffering — the
    paper's increasing-slot rule).
    """
    shape: tuple[int, ...]
    torus: bool
    transfers: list[Transfer]
    starts: list[int]
    paths: list[list[tuple]]

    @property
    def n_rounds(self) -> int:
        return max((s + len(p) for s, p in zip(self.starts, self.paths)),
                   default=0)

    def rounds(self) -> list[list[tuple[int, tuple]]]:
        out: list[list[tuple[int, tuple]]] = [[] for _ in range(self.n_rounds)]
        for i, (s, path) in enumerate(zip(self.starts, self.paths)):
            for j, hop in enumerate(path):
                out[s + j].append((i, hop))
        return out

    def link_utilization(self) -> float:
        n_links = int(np.prod(self.shape)) * 2 * len(self.shape)
        used = sum(len(p) for p in self.paths)
        return used / max(1, n_links * self.n_rounds)

    def concurrency(self) -> dict[str, float]:
        """In-flight transfers per round — the schedule's concurrency
        profile (a transfer is in flight from its start round until its
        last hop)."""
        active = [0] * self.n_rounds
        for s, path in zip(self.starts, self.paths):
            for j in range(len(path)):
                active[s + j] += 1
        busy = [a for a in active if a]
        return {"max_inflight": float(max(busy, default=0)),
                "avg_inflight": float(np.mean(busy)) if busy else 0.0}


def plan_transfers(shape: tuple[int, ...], transfers: list[Transfer],
                   torus: bool = True, policy: str = "longest_first",
                   order: list[int] | None = None,
                   busy: dict[tuple, set[int]] | None = None,
                   base: int = 0) -> TransferPlan:
    """Greedy TDM scheduling: earliest conflict-free start slot per
    transfer (the unrolled-time version of the CCU's slot allocation — a
    transfer that loses a slot to an earlier reservation retries at the
    next start round, the increasing-slot fallback).

    ``policy``: "longest_first" sorts by descending path length (best
    packing); "arrival" keeps request order (the CCU's FIFO commit rule,
    matching ``TdmAllocator.allocate_batch``).  An explicit ``order``
    (a permutation of the transfer indices — how ``NomFabric`` applies
    its registered policies) overrides ``policy``.

    ``busy`` (link -> set of *absolute* rounds) makes link reservations
    persistent across calls: pass the same mapping again and this batch
    packs around what earlier batches still hold — how ``NomFabric``'s
    rounds backend models back-to-back batches contending like the tdm
    backend does.  The batch is anchored at absolute round ``base`` and
    new reservations are recorded at ``base + start + hop``; the returned
    plan's ``starts`` stay batch-relative.  ``busy=None`` (default) keeps
    the one-shot behavior (a private map, nothing persists)."""
    paths = [_dor_path(t.src, t.dst, shape, torus) for t in transfers]
    if order is not None:
        order = list(order)
    elif policy == "longest_first":
        order = sorted(range(len(transfers)), key=lambda i: -len(paths[i]))
    elif policy == "arrival":
        order = list(range(len(transfers)))
    else:
        raise ValueError(f"unknown policy {policy!r}")
    if busy is None:
        busy = defaultdict(set)   # link -> set of rounds (this call only)
    starts = [0] * len(transfers)
    for i in order:
        path = paths[i]
        if not path:
            continue
        s = 0
        while True:
            if all(base + s + j not in busy.get(hop, ())
                   for j, hop in enumerate(path)):
                break
            s += 1
        starts[i] = s
        for j, hop in enumerate(path):
            busy.setdefault(hop, set()).add(base + s + j)
    return TransferPlan(shape=shape, torus=torus, transfers=transfers,
                        starts=starts, paths=paths)
