"""Multi-tenant cache placement and eviction for the serving engine (port
of ``repro.serving.placement``).

The engine's decode caches live on the NoM bank mesh: every cache leaf is
*homed* on a DRAM bank, and its per-step updates stream from the logic-die
staging bank of the home column up to the home (see ``docs/serving.md``).
This module owns the *where*: a :class:`BankPool` leases bank homes to
tenants — one tenant per concurrent ``generate`` stream — under a
placement policy, and turns cache-lifecycle events into scheduler traffic:

* **per-step flush** (:func:`step_requests`) — one ``copy`` transfer per
  leaf, staging → home, exactly the engine's previous static behaviour;
* **ring-buffer overwrite** — once a ring leaf's write position wraps its
  capacity, the incoming line lands on an occupied slot; the overwritten
  slot is scrubbed *in place* first, an INIT-class transfer
  (:class:`~repro_torch.core.scheduler.TransferRequest` with ``op="init"``,
  ``src == dst``) that the TDM backend realizes as a zero-hop circuit;
* **tenant teardown** (:func:`teardown_requests`) — releasing a tenant
  scrubs every leased home with one INIT covering the leaf's full
  footprint (the OS-service bulk-initialization class that RowClone
  accelerates in-DRAM);
* **stall-driven repacking** (:meth:`BankPool.repack`) — the engine feeds
  ``ScheduleReport.stall_cycles`` back; a tenant whose circuits queue too
  long is re-homed onto the least-loaded columns, and the vacated homes
  are scrubbed with INITs (eviction traffic through the same scheduler).

All of it rides the same batched :class:`~repro_torch.core.fabric.NomFabric`
session (``Engine.fabric``) as the copy traffic, so copy and INIT
circuits compete for (and are reported over) one TDM fabric — the
paper's mixed copy/initialization workload.  On exhaustion the engine
routes tenant admission through the fabric's overflow semantics
(queue/shed/raise with idle-lease reclaim) rather than surfacing this
module's ``RuntimeError``.

Placement policies (:data:`PLACEMENT_POLICIES`):

* ``"spread"`` — the classic strided spread: homes stride over the
  DRAM-layer pool with a step coprime to the pool size, so consecutive
  leaves land on different columns.  Tenants interleave freely; isolation
  is probabilistic.
* ``"partition"`` — per-tenant column partitioning: each tenant owns a
  disjoint set of (x, y) columns and its homes cycle through them.
  Cache-flush circuits are purely vertical (staging at z=0 → home in the
  same column), so *tenants' circuits are link-disjoint by construction*.
  On a single-layer mesh, where circuits run horizontally from the row's
  edge staging bank, the partitioned unit is the *row* — the guarantee
  holds with rows as the isolation groups.
* ``"stall_feedback"`` — places like ``"spread"`` but repacks: when the
  engine observes accumulated ``stall_cycles`` above its threshold it
  calls :meth:`BankPool.repack`, which re-leases the tenant onto the
  least-loaded columns and returns the vacated leases for scrubbing.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.scheduler import TransferRequest
from repro_torch.core.topology import Mesh3D, StackedTopology

PLACEMENT_POLICIES = ("spread", "partition", "stall_feedback")


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """Placement-relevant description of one cache leaf.

    Attributes:
      tag: caller label (the engine uses the pytree key path).
      step_bytes: bytes the leaf moves per decode step (the size slope for
        ring leaves; the whole state for in-place leaves).
      lease_bytes: full footprint scrubbed at teardown (>= step_bytes;
        0 falls back to step_bytes).
      ring_slots: ring capacity in token slots — writes at positions >=
        ring_slots overwrite live slots and emit eviction INITs; 0 marks
        an in-place state leaf (SSM / RG-LRU) that never wraps.
    """
    tag: str
    step_bytes: int
    lease_bytes: int = 0
    ring_slots: int = 0


@dataclasses.dataclass(frozen=True)
class Lease:
    """One leased bank home: ``tenant`` holds ``home`` for ``leaf``;
    per-step traffic stages at ``staging`` (the z=0 bank of the home
    column, i.e. the vault controller's landing bank)."""
    tenant: str
    leaf: LeafSpec
    home: int
    staging: int


class BankPool:
    """Leases bank homes on a :class:`~repro_torch.core.topology.Mesh3D` to
    tenants under a placement policy — the multi-tenant replacement for
    the engine's old static per-leaf spread.

    The leasable pool is the DRAM layers (z >= 1); on a single-layer mesh
    the whole plane is leasable and staging sits at the row's edge bank.
    A bank is leased to at most one tenant at a time (never double-leased;
    asserted on every grant), and :meth:`release` must free it before it
    can be re-leased.

    The pool also accepts a
    :class:`~repro_torch.core.topology.StackedTopology`: homes are then
    *global* bank ids spanning every stack, placement groups are
    per-stack columns (a tenant partitioned into stack 0 never shares a
    group with one in stack 1), :meth:`lease` can pin a tenant to a
    subset of stacks, and :meth:`migrate` re-homes a whole tenant onto
    another stack (the engine turns the move into cross-stack COPY
    circuits plus teardown INITs over the vacated homes).
    """

    def __init__(self, mesh: Mesh3D | StackedTopology,
                 policy: str = "spread"):
        if policy not in PLACEMENT_POLICIES:
            raise ValueError(f"unknown policy {policy!r}; "
                             f"choose from {PLACEMENT_POLICIES}")
        self.topology = mesh
        self._stacked = isinstance(mesh, StackedTopology)
        self._meshes = mesh.stacks if self._stacked else (mesh,)
        self.mesh = self._meshes[0]
        self.policy = policy
        self._pool: list[int] = []
        self._single: list[bool] = []           # per stack: Z == 1 fallback
        self._group_off: list[int] = []         # per stack: first group id
        groups = 0
        for s, m in enumerate(self._meshes):
            off = mesh.offsets[s] if self._stacked else 0
            plane = m.X * m.Y
            dram = list(range(plane, m.n_nodes))
            self._single.append(not dram)
            self._pool.extend(off + b for b in (dram or range(plane)))
            self._group_off.append(groups)
            # multi-layer stacks have X*Y column groups, single-layer Y rows
            groups += m.X * m.Y if dram else m.Y
        self._single_layer = self._single[0]
        self._owner: dict[int, str] = {}        # bank -> tenant
        self._leased: dict[str, list[Lease]] = {}
        self._col_owner: dict[int, str] = {}    # group -> tenant (partition)
        self._lease_seq = 0                     # rotates spread start points

    # -- geometry helpers -------------------------------------------------
    def _locate(self, bank: int) -> tuple[int, int]:
        return self.topology.locate(bank) if self._stacked else (0, bank)

    def _gid(self, stack: int, local: int) -> int:
        return self.topology.global_id(stack, local) if self._stacked \
            else local

    def stack_of(self, bank: int) -> int:
        """Stack index owning global bank id ``bank`` (0 on a bare mesh)."""
        return self._locate(bank)[0]

    def _staging_for(self, home: int) -> int:
        stack, local = self._locate(home)
        m = self._meshes[stack]
        x, y, _z = m.coords(local)
        if self._single[stack]:
            return self._gid(stack, m.node_id(0, y, 0))
        return self._gid(stack, m.node_id(x, y, 0))

    def _column(self, bank: int) -> int:
        """Path-confining placement group of a bank: the (x, y) column on
        a multi-layer mesh (cache-flush circuits are vertical), the *row*
        on a single-layer mesh (circuits run along the row from the edge
        staging bank) — the unit the partition policy isolates by and
        :meth:`column_load` counts over.  Groups never span stacks: each
        stack gets a disjoint group-id range."""
        stack, local = self._locate(bank)
        m = self._meshes[stack]
        g = m.coords(local)[1] if self._single[stack] else m.column_of(local)
        return self._group_off[stack] + g

    def _n_groups(self) -> int:
        last = len(self._meshes) - 1
        m = self._meshes[last]
        n = m.Y if self._single[last] else m.X * m.Y
        return self._group_off[last] + n

    def _free_in_column(self, col: int,
                        allowed: set[int] | None = None) -> list[int]:
        return [b for b in self._pool
                if self._column(b) == col and b not in self._owner
                and (allowed is None or b in allowed)]

    # -- candidate orders per policy ---------------------------------------
    def _spread_order(self, seq: int, i: int):
        # Lazy: callers take the first free candidate, so materializing
        # the full rotation per leaf is O(pool) work for nothing.
        n = len(self._pool)
        start = (seq * 13 + i * 37 + 11) % n
        return (self._pool[(start + k) % n] for k in range(n))

    def _partition_candidate(self, tenant: str,
                             allowed: set[int] | None = None) -> int | None:
        """Next home in the tenant's owned groups, acquiring a fresh
        unowned group when the owned ones are exhausted."""
        owned = [c for c, t in self._col_owner.items() if t == tenant]
        # Prefer the owned group with the most free banks (fill evenly).
        for col in sorted(owned,
                          key=lambda c: -len(self._free_in_column(c,
                                                                  allowed))):
            free = self._free_in_column(col, allowed)
            if free:
                return free[0]
        for col in range(self._n_groups()):
            if col not in self._col_owner and self._free_in_column(col,
                                                                   allowed):
                self._col_owner[col] = tenant
                return self._free_in_column(col, allowed)[0]
        return None

    def _least_loaded_order(self, avoid: set[int],
                            allowed: set[int] | None = None) -> list[int]:
        load = self.column_load()
        return sorted((b for b in self._pool if b not in self._owner
                       and (allowed is None or b in allowed)),
                      key=lambda b: (self._column(b) in avoid,
                                     load.get(self._column(b), 0),
                                     b))

    def _pick_home(self, tenant: str, i: int, policy: str, seq: int,
                   avoid: set[int] | None = None,
                   allowed: set[int] | None = None) -> int:
        if policy == "partition":
            home = self._partition_candidate(tenant, allowed)
        elif avoid is not None:     # repack: prefer away from hot columns
            order = self._least_loaded_order(avoid, allowed)
            home = order[0] if order else None
        else:                       # spread / stall_feedback initial
            home = next((b for b in self._spread_order(seq, i)
                         if b not in self._owner
                         and (allowed is None or b in allowed)), None)
        if home is None:
            raise RuntimeError(f"bank pool exhausted leasing for {tenant!r} "
                               f"({len(self._owner)}/{len(self._pool)} "
                               f"banks leased)")
        return home

    # -- public API ---------------------------------------------------------
    def lease(self, tenant: str, leaves: list[LeafSpec],
              _avoid: set[int] | None = None,
              stacks: set[int] | None = None) -> list[Lease]:
        """Lease one home bank per leaf to ``tenant`` under the pool's
        policy.  Returns the leases in leaf order; raises ``RuntimeError``
        when the pool is exhausted.  A tenant may lease repeatedly (e.g.
        after :meth:`release`); banks are never double-leased.  On a
        stacked topology ``stacks`` pins the grant to those stack indices
        (every home drawn from them); ``None`` means any stack."""
        seq = self._lease_seq
        self._lease_seq = (self._lease_seq + 1) % max(1, len(self._pool))
        cols_before = {c for c, t in self._col_owner.items() if t == tenant}
        allowed = None
        if stacks is not None:
            want = set(stacks)
            bad = want - set(range(len(self._meshes)))
            if bad:
                raise ValueError(f"unknown stack indices {sorted(bad)} "
                                 f"(pool has {len(self._meshes)} stacks)")
            allowed = {b for b in self._pool if self.stack_of(b) in want}
        # Exhaustion short-circuit: success needs one free bank per leaf
        # (necessary under every policy — the all-or-nothing rollback
        # below would fire anyway), so an infeasible lease fails in O(1)
        # instead of scanning the pool per leaf first.
        if allowed is None and self.free_banks() < len(leaves):
            raise RuntimeError(f"bank pool exhausted leasing for "
                               f"{tenant!r} ({len(self._owner)}/"
                               f"{len(self._pool)} banks leased)")
        out = []
        try:
            for i, leaf in enumerate(leaves):
                home = self._pick_home(tenant, i, self.policy, seq,
                                       avoid=_avoid, allowed=allowed)
                assert home not in self._owner, "double lease"
                self._owner[home] = tenant
                out.append(Lease(tenant=tenant, leaf=leaf, home=home,
                                 staging=self._staging_for(home)))
        except RuntimeError:
            # All-or-nothing admission: a failed lease must not shrink
            # the pool — roll back this call's grants (banks and any
            # partition groups acquired along the way).
            for ls in out:
                del self._owner[ls.home]
            for col in [c for c, t in self._col_owner.items()
                        if t == tenant and c not in cols_before]:
                del self._col_owner[col]
            raise
        self._leased.setdefault(tenant, []).extend(out)
        return out

    def release(self, tenant: str) -> list[Lease]:
        """Free every bank leased to ``tenant`` and return the vacated
        leases — the caller turns them into teardown INIT scrubs via
        :func:`teardown_requests`."""
        out = self._leased.pop(tenant, [])
        for ls in out:
            self._owner.pop(ls.home, None)
        for col in [c for c, t in self._col_owner.items() if t == tenant]:
            del self._col_owner[col]
        return out

    def repack(self, tenant: str,
               stall_cycles: int, threshold: int = 0
               ) -> tuple[list[Lease], list[Lease]]:
        """Stall-feedback repacking: when ``stall_cycles`` exceeds
        ``threshold``, re-home ``tenant``'s leaves onto the least-loaded
        columns (avoiding its current, contended columns).  Returns
        ``(evicted, fresh)``: the vacated leases (scrub them with INITs)
        and the replacement leases.  Below the threshold returns
        ``([], [])`` and changes nothing.  Under the ``"partition"``
        policy placement is static by design — a tenant's contention is
        confined to its own groups, so re-homing cannot relieve it — and
        repack is a no-op."""
        if (stall_cycles <= threshold or tenant not in self._leased
                or self.policy == "partition"):
            return [], []
        old = self.release(tenant)
        hot = {self._column(ls.home) for ls in old}
        fresh = self.lease(tenant, [ls.leaf for ls in old], _avoid=hot)
        if {ls.home for ls in fresh} & {ls.home for ls in old}:
            # Pool pressure: the "least-loaded" order fell back onto the
            # just-vacated banks — there is nowhere better to go.  Revert
            # to the old placement and report no repack, so the caller
            # never scrubs homes that are still (again) live.
            self.release(tenant)
            for ls in old:
                assert ls.home not in self._owner
                self._owner[ls.home] = tenant
            self._leased[tenant] = list(old)
            return [], []
        return old, fresh

    def _group_stack(self, group: int) -> int:
        """Stack whose group-id range contains ``group``."""
        s = 0
        while s + 1 < len(self._group_off) and group >= self._group_off[s + 1]:
            s += 1
        return s

    def migrate(self, tenant: str,
                dst_stack: int) -> tuple[list[Lease], list[Lease]]:
        """Re-home ``tenant``'s off-stack leases onto stack ``dst_stack``.

        Leases already on ``dst_stack`` stay exactly where they are (no
        pointless copy, and their homes are never at risk of a teardown
        scrub).  Returns ``(old, fresh)`` in matched leaf order for the
        leases that moved: the engine copies each ``old[i].home`` →
        ``fresh[i].home`` (cross-stack COPY circuits through the SerDes
        links) and scrubs the vacated homes with teardown INITs.
        Returns ``([], [])`` — with placement unchanged — when the
        tenant holds nothing, already lives entirely on ``dst_stack``,
        or the destination stack cannot fit the moving leases
        (all-or-nothing: a failed migration rolls back every grant and
        group acquisition, leaving the original placement intact)."""
        if not (0 <= dst_stack < len(self._meshes)):
            raise ValueError(f"stack {dst_stack} out of range "
                             f"[0, {len(self._meshes)})")
        held = self.leases(tenant)
        moving = [ls for ls in held
                  if self.stack_of(ls.home) != dst_stack]
        if not moving:
            return [], []
        owner_snap = dict(self._owner)
        leased_snap = {t: list(v) for t, v in self._leased.items()}
        col_snap = dict(self._col_owner)
        # Partially release: only the moving homes, and only the
        # partition groups on stacks the tenant is leaving.
        for ls in moving:
            self._owner.pop(ls.home, None)
        self._leased[tenant] = [ls for ls in held if ls not in moving]
        for col in [c for c, t in self._col_owner.items()
                    if t == tenant and self._group_stack(c) != dst_stack]:
            del self._col_owner[col]
        try:
            fresh = self.lease(tenant, [ls.leaf for ls in moving],
                               stacks={dst_stack})
        except RuntimeError:
            self._owner = owner_snap
            self._leased = leased_snap
            self._col_owner = col_snap
            return [], []
        return moving, fresh

    def leases(self, tenant: str) -> list[Lease]:
        """Current leases held by ``tenant`` (empty list when none)."""
        return list(self._leased.get(tenant, []))

    def stack_load(self) -> dict[int, int]:
        """Leased banks per stack index — the coarse map
        :meth:`migrate` balances against (``{0: n}`` on a bare mesh)."""
        load: dict[int, int] = {}
        for bank in self._owner:
            s = self.stack_of(bank)
            load[s] = load.get(s, 0) + 1
        return load

    def column_load(self) -> dict[int, int]:
        """Leased banks per placement group — the (x, y) column on a
        multi-layer mesh, the row on a single-layer one — the contention
        map the stall-feedback policy packs against."""
        load: dict[int, int] = {}
        for bank in self._owner:
            col = self._column(bank)
            load[col] = load.get(col, 0) + 1
        return load

    def free_banks(self) -> int:
        """Number of leasable banks not currently under lease."""
        return len(self._pool) - len(self._owner)


# ---------------------------------------------------------------------------
# Lifecycle events -> TransferRequests (all through the engine's NomFabric)
# ---------------------------------------------------------------------------
def step_requests(leases: list[Lease], pos: int,
                  max_extra_slots: int = 0) -> list[TransferRequest]:
    """One decode step's transfer set for ``leases`` at write position
    ``pos``: a staging → home ``copy`` per leaf, preceded — once a ring
    leaf has wrapped (``pos >= ring_slots``) — by an in-place INIT that
    scrubs the slot being overwritten (``pos % ring_slots``), the
    eviction made visible as an ``op="init"`` zero-hop circuit.  A leaf
    homed on its own staging bank is a controller-local write: no copy
    is emitted (its ring evictions still are)."""
    reqs = []
    for ls in leases:
        leaf = ls.leaf
        if leaf.ring_slots and pos >= leaf.ring_slots:
            reqs.append(TransferRequest(
                src=ls.home, dst=ls.home, nbytes=leaf.step_bytes, op="init",
                tag=(ls.tenant, leaf.tag, "evict", pos % leaf.ring_slots)))
        if ls.staging != ls.home:
            reqs.append(TransferRequest(
                src=ls.staging, dst=ls.home, nbytes=leaf.step_bytes,
                tag=(ls.tenant, leaf.tag, "copy"),
                max_extra_slots=max_extra_slots))
    return reqs


def teardown_requests(leases: list[Lease]) -> list[TransferRequest]:
    """Tenant teardown as INIT-class traffic: one in-place scrub per
    vacated home covering the leaf's full leased footprint."""
    return [TransferRequest(
        src=ls.home, dst=ls.home,
        nbytes=max(ls.leaf.lease_bytes, ls.leaf.step_bytes, 1), op="init",
        tag=(ls.tenant, ls.leaf.tag, "teardown")) for ls in leases]


__all__ = ["PLACEMENT_POLICIES", "BankPool", "LeafSpec", "Lease",
           "step_requests", "teardown_requests"]
