"""repro_torch's serving control plane against repro's, on the CPU (the
fabric's kernels on their plain versions): BankPool sequences under every
placement policy on a multi-layer mesh, a single-layer mesh and two
stacks; every admission strategy's scalar and vector orders; the load
generator's arrivals; ``drive`` records with their per-tick ledgers for
every strategy and mix on both control planes, with the engines'
telemetry and the fabrics' slot tables; engines driven op by op under
other placement, admission and scheduling settings; tracked
``Engine.generate`` on recurrentgemma-smoke and mamba2-smoke (leaf specs,
reports, telemetry, and tokens equal to the untracked run); the leaf
specs at full width from shapes alone; the multi-stack engine.  The
control plane is integer and host arithmetic, so every comparison is
exact.  The one ``cuda`` test holds a drive on the card against the
CPU."""
import dataclasses
import importlib.util
import json
import pathlib
import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro_torch.core as PC
import repro_torch.serving as P
from repro_torch.core import FabricCluster, NomFabric, make_topology

ROOT = pathlib.Path(__file__).resolve().parent.parent
STRATEGIES = ("fifo", "deadline", "priority", "hybrid", "stall_aware")
# (mix, ticks): the reference's SLO tests drive 20-80 ticks.
MIX_TICKS = {"poisson": 30, "bursty": 40, "heavy_tail": 60,
             "deadline_heavy": 80}
# benchmarks/bench_serving_slo.py: seed 7, 48 ticks in its quick run.
BENCH_SEED, BENCH_TICKS = 7, 48


@pytest.fixture(scope="module")
def R():
    """The JAX package's serving modules (CPU)."""
    pytest.importorskip("jax")
    import repro.core as core
    import repro.serving as serving
    import repro.serving.loadgen as loadgen
    return type("R", (), {"core": core, "serving": serving,
                          "loadgen": loadgen})


def _plain(x):
    """Leases, requests and reports as plain data (dataclasses of either
    package compare by their fields)."""
    if dataclasses.is_dataclass(x):
        return dataclasses.asdict(x)
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


def _tables(fabric):
    """Every expiry table of a fabric (per stack for a cluster, then the
    SerDes links) with its packed busy masks."""
    fabs = getattr(fabric, "fabrics", [fabric])
    tables = [t for f in fabs for t in (f.allocator.table._ports,
                                        f.allocator.table._bus)]
    if hasattr(fabric, "segmented"):
        tables.append(fabric.segmented.links)
    return [a for t in tables for a in (t.expiry, t.masks,
                                        np.asarray(t.window))]


def _same_fabric(rf, pf):
    assert pf.telemetry() == rf.telemetry()
    for a, b in zip(_tables(rf), _tables(pf)):
        np.testing.assert_array_equal(b, a)


def _same_engine(re, pe):
    assert pe.transfer_telemetry() == re.transfer_telemetry()
    assert _plain(pe.reports) == _plain(re.reports)
    assert _plain(pe.last_report) == _plain(re.last_report)
    _same_fabric(re.fabric, pe.fabric)


# --- placement ---------------------------------------------------------------
TOPOLOGIES = {"mesh": ((4, 4, 2), 1), "single_layer": ((4, 4, 1), 1),
              "stacked": ((4, 4, 2), 2)}


def _pool_ops(pool, mod, seed, n_ops=80):
    """A seeded sequence of lease / release / repack / migrate calls and
    what each returned or raised, with step and teardown requests."""
    rng = np.random.default_rng(seed)
    n_stacks = len(pool._meshes)
    out, names = [], []
    for k in range(n_ops):
        op = rng.choice(["lease", "lease", "release", "repack", "migrate"])
        try:
            if op == "lease" or not names:
                name = f"t{k}"
                leaves = [mod.LeafSpec(f"['x{i}']", step_bytes=int(
                    rng.integers(1, 512)), lease_bytes=int(
                    rng.integers(0, 4096)), ring_slots=int(rng.integers(
                        0, 5))) for i in range(int(rng.integers(1, 6)))]
                stacks = ({int(rng.integers(0, n_stacks))}
                          if n_stacks > 1 and rng.random() < 0.4 else None)
                got = pool.lease(name, leaves, stacks=stacks)
                names.append(name)
                pos = int(rng.integers(0, 9))
                out.append((op, _plain(got), _plain(mod.step_requests(
                    got, pos, max_extra_slots=int(rng.integers(0, 4))))))
            elif op == "release":
                name = names.pop(int(rng.integers(0, len(names))))
                got = pool.release(name)
                out.append((op, _plain(got),
                            _plain(mod.teardown_requests(got))))
            elif op == "repack":
                name = names[int(rng.integers(0, len(names)))]
                got = pool.repack(name, int(rng.integers(0, 100)),
                                  int(rng.integers(0, 50)))
                out.append((op, _plain(got)))
            else:
                name = names[int(rng.integers(0, len(names)))]
                got = pool.migrate(name, int(rng.integers(0, n_stacks + 1)))
                out.append((op, _plain(got)))
        except (RuntimeError, ValueError) as exc:
            out.append((op, type(exc).__name__, str(exc)))
        out.append((pool.free_banks(), pool.column_load(), pool.stack_load()))
    return out


@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
@pytest.mark.parametrize("policy", P.PLACEMENT_POLICIES)
def test_bank_pool_sequences_match_reference(R, topo, policy):
    dims, n = TOPOLOGIES[topo]
    dry = 0
    for seed in range(3):
        ref = R.serving.BankPool(R.core.make_topology(n, dims), policy)
        got = P.BankPool(make_topology(n, dims), policy)
        want = _pool_ops(ref, R.serving, seed)
        assert _pool_ops(got, P, seed) == want
        assert got._owner == ref._owner
        assert got._col_owner == ref._col_owner
        dry += sum(o[:2] == ("lease", "RuntimeError") for o in want)
    assert dry, "no lease ran the pool dry"


def test_bank_pool_rejects_unknown_policy(R):
    with pytest.raises(ValueError, match="unknown policy") as got:
        P.BankPool(make_topology(mesh=(2, 2, 2)), "nope")
    with pytest.raises(ValueError) as want:
        R.serving.BankPool(R.core.make_topology(mesh=(2, 2, 2)), "nope")
    assert str(got.value) == str(want.value)


def _leaves(mod, n=3):
    return [mod.LeafSpec(f"l{i}", step_bytes=64, lease_bytes=256,
                         ring_slots=4) for i in range(n)]


def test_pool_lease_pins_to_stacks(R):
    for mod, core in ((P, PC), (R.serving, R.core)):
        pool = mod.BankPool(core.make_topology(3, mesh=(4, 4, 2)))
        for ls in pool.lease("a", _leaves(mod), stacks={1}):
            assert pool.stack_of(ls.home) == 1
            assert pool.stack_of(ls.staging) == 1
        assert pool.stack_load() == {1: 3}
        with pytest.raises(ValueError, match="unknown stack indices"):
            pool.lease("b", _leaves(mod), stacks={7})
    ref = R.serving.BankPool(R.core.make_topology(3, mesh=(4, 4, 2)))
    got = P.BankPool(make_topology(3, mesh=(4, 4, 2)))
    assert _plain(got.lease("a", _leaves(P), stacks={1, 2})) == \
        _plain(ref.lease("a", _leaves(R.serving), stacks={1, 2}))


def test_pool_migrate_moves_only_off_stack_leases(R):
    ref = R.serving.BankPool(R.core.make_topology(2, mesh=(4, 4, 2)))
    pool = P.BankPool(make_topology(2, mesh=(4, 4, 2)))
    held = pool.lease("a", _leaves(P, 4))
    assert _plain(held) == _plain(ref.lease("a", _leaves(R.serving, 4)))
    on_dst = [ls for ls in held if pool.stack_of(ls.home) == 1]
    old, fresh = pool.migrate("a", 1)
    assert _plain((old, fresh)) == _plain(ref.migrate("a", 1))
    assert len(old) == len(fresh) == 4 - len(on_dst)
    assert all(pool.stack_of(ls.home) == 1 for ls in pool.leases("a"))
    assert {ls.home for ls in on_dst} <= {ls.home for ls in pool.leases("a")}
    assert not {ls.home for ls in old} & {ls.home for ls in fresh}
    assert all(ls.home not in pool._owner for ls in old)
    assert pool.migrate("a", 1) == ([], [])
    with pytest.raises(ValueError, match="out of range"):
        pool.migrate("a", 2)


def test_pool_migrate_rolls_back_on_exhaustion(R):
    snaps = []
    for mod, mk in ((P, make_topology), (R.serving, R.core.make_topology)):
        pool = mod.BankPool(mk(2, mesh=(2, 2, 2)))
        pool.lease("big", [mod.LeafSpec(f"x{i}", 8) for i in range(4)],
                   stacks={1})
        pool.lease("t", [mod.LeafSpec("y", 8)], stacks={0})
        snap = (dict(pool._owner), _plain(pool._leased))
        assert pool.migrate("t", 1) == ([], [])
        assert (dict(pool._owner), _plain(pool._leased)) == snap
        snaps.append(snap)
    assert snaps[0] == snaps[1]


def test_partition_groups_never_span_stacks(R):
    groups = []
    for mod, mk in ((P, make_topology), (R.serving, R.core.make_topology)):
        pool = mod.BankPool(mk(2, mesh=(4, 4, 2)), policy="partition")
        pool.lease("t0", _leaves(mod), stacks={0})
        pool.lease("t1", _leaves(mod), stacks={1})
        g0 = {c for c, t in pool._col_owner.items() if t == "t0"}
        g1 = {c for c, t in pool._col_owner.items() if t == "t1"}
        assert g0 and g1 and not g0 & g1
        assert all(pool._group_stack(g) == 0 for g in g0)
        assert all(pool._group_stack(g) == 1 for g in g1)
        groups.append((g0, g1))
    assert groups[0] == groups[1]


# --- admission ---------------------------------------------------------------
def _waiters(mod, rng, n):
    """A permuted queue of n tickets with random annotations."""
    waiters = [(int(rng.integers(0, 64)), mod.AdmissionTicket(
        name=f"d{i}", batch=int(rng.integers(1, 9)),
        klass=f"k{int(rng.integers(0, 5))}",
        priority=float(rng.choice([0.25, 1.0, 2.0, 4.0])),
        deadline=(None if rng.random() < 0.3
                  else int(rng.integers(0, 200))),
        seq=i)) for i in range(n)]
    return [waiters[int(i)] for i in rng.permutation(n)]


@pytest.mark.parametrize("fabric", ["healthy", "stalled"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_admission_orders_match_reference(R, strategy, fabric):
    fab = ({"stall_cycles": 0, "scheduled": 10} if fabric == "healthy"
           else {"stall_cycles": 10 * int(P.STALL_PRESSURE) + 999,
                 "scheduled": 10})
    fn, rfn = P.get_admission(strategy), R.serving.get_admission(strategy)
    assert (fn.head_blocking, fn.vector is None) == \
        (rfn.head_blocking, rfn.vector is None)
    for seed in range(12):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(1, 90))
        admits = {f"k{i}": int(rng.integers(0, 20)) for i in range(5)}
        tick = int(rng.integers(0, 200))
        w = _waiters(P, np.random.default_rng(seed + 100), n)
        rw = _waiters(R.serving, np.random.default_rng(seed + 100), n)
        want = list(rfn(rw, R.serving.AdmissionContext(tick, admits,
                                                       fabric=dict(fab))))
        assert list(fn(w, P.AdmissionContext(tick, admits,
                                             fabric=dict(fab)))) == want
        cols = P.TicketColumns(capacity=4)
        cols.rebuild(w)
        assert [int(x) for x in fn.vector(cols, P.AdmissionContext(
            tick, admits, fabric=lambda: dict(fab)))] == want


def test_ticket_columns_match_reference(R):
    rng = np.random.default_rng(5)
    w = _waiters(P, rng, 40)
    rw = _waiters(R.serving, np.random.default_rng(5), 40)
    cols, rcols = P.TicketColumns(capacity=3), R.serving.TicketColumns(3)
    for (at, tk), (rat, rtk) in zip(w, rw):
        cols.append(at, tk)
        rcols.append(rat, rtk)
    keep = rng.random(40) < 0.6
    cols.compact(keep)
    rcols.compact(keep)
    for name, _dt in P.TicketColumns._FIELDS:
        np.testing.assert_array_equal(getattr(cols, name),
                                      getattr(rcols, name))
    admits = {"k1": 3, "k4": 9}
    np.testing.assert_array_equal(cols.frequencies(admits),
                                  rcols.frequencies(admits))
    assert cols.klass_names == rcols.klass_names and len(cols) == len(rcols)


def test_admission_registry_and_context():
    assert P.registered_admissions()[:5] == STRATEGIES
    assert P.get_admission("fifo").head_blocking
    with pytest.raises(ValueError, match="fifo"):
        P.get_admission("nope")

    @P.register_admission("lifo_port_test")
    def lifo(waiters, ctx):
        return sorted(range(len(waiters)), key=lambda i: -waiters[i][1].seq)
    try:
        with pytest.raises(ValueError, match="already"):
            P.register_admission("lifo_port_test")(lambda w, c: [])
        stats = P.drive(P.make_slo_engine("lifo_port_test", device="cpu"),
                        "bursty", ticks=24, seed=1)
        assert stats["admitted"] > 0
    finally:
        P.unregister_admission("lifo_port_test")
    with pytest.raises(ValueError, match="built-in"):
        P.unregister_admission("fifo")
    calls = []
    ctx = P.AdmissionContext(0, {}, fabric=lambda: calls.append(1) or {
        "stall_cycles": 4, "scheduled": 2})
    assert not calls and ctx.stall_pressure() == ctx.stall_pressure() == 2.0
    assert calls == [1]
    assert P.AdmissionContext(0, {}).stall_pressure() == 0.0


# --- load generator and drive ------------------------------------------------
@pytest.mark.parametrize("mix", sorted(P.MIXES))
def test_loadgen_arrivals_match_reference(R, mix):
    assert dataclasses.asdict(P.get_mix(mix)) == \
        dataclasses.asdict(R.serving.get_mix(mix))
    for seed in (0, 7, 12345):
        gen, rgen = P.LoadGen(P.get_mix(mix), seed), \
            R.serving.LoadGen(R.serving.get_mix(mix), seed)
        for t in range(60):
            assert gen.rate_at(t) == rgen.rate_at(t)
            assert _plain(gen.arrivals(t)) == _plain(rgen.arrivals(t))
    with pytest.raises(ValueError, match="tick order"):
        gen.arrivals(3)
    with pytest.raises(ValueError, match="poisson"):
        P.get_mix("nope")


@pytest.mark.parametrize("plane", P.CONTROL_PLANES)
@pytest.mark.parametrize("mix", sorted(MIX_TICKS))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_drive_matches_reference(R, strategy, mix, plane):
    """The SLO harness record, per-tick ledger included, is the
    reference's exactly; so are the engine's telemetry, every batch
    report and the fabric's slot tables after the run."""
    pe = P.make_slo_engine(strategy, control_plane=plane, device="cpu")
    re = R.loadgen.make_slo_engine(strategy, control_plane=plane)
    got = P.drive(pe, mix, MIX_TICKS[mix], seed=3, trace=True)
    want = R.loadgen.drive(re, mix, MIX_TICKS[mix], seed=3, trace=True)
    assert got == want
    assert got["arrivals"] > 0 and got["admitted"] > 0
    for row in got["per_tick"]:
        assert row["arrivals"] == (row["admitted"] + row["shed"]
                                   + row["expired"] + row["waiting"]
                                   + row["retrying"])
    _same_engine(re, pe)
    assert pe.fabric.telemetry()["fused_waves"] > 0


@pytest.mark.parametrize("plane", P.CONTROL_PLANES)
def test_closed_loop_drive_matches_reference(R, plane):
    pe = P.make_slo_engine("deadline", control_plane=plane, device="cpu")
    re = R.loadgen.make_slo_engine("deadline", control_plane=plane)
    got = P.drive(pe, "deadline_heavy", 80, seed=5, trace=True,
                  retry_budget=3)
    want = R.loadgen.drive(re, "deadline_heavy", 80, seed=5, trace=True,
                           retry_budget=3)
    assert got == want and got["retries"] > 0 and got["retry_admitted"] > 0
    _same_engine(re, pe)


def test_drive_at_the_benchmark_settings(R):
    """benchmarks/bench_serving_slo.py's engine (mesh 4x4x2, deadline
    ticks 12, queue depth 16) at seed 7 for 48 ticks on deadline_heavy:
    equal records, each also equal to the one the benchmark committed
    in BENCH_serving.json, and the benchmark's gate holds on the
    port's."""
    bench = json.loads((ROOT / "BENCH_serving.json").read_text())
    assert (bench["seed"], bench["ticks"]) == (BENCH_SEED, BENCH_TICKS)
    committed = {(r["mix"], r["strategy"]): r for r in bench["records"]}
    miss = {}
    for strategy in STRATEGIES:
        pe = P.make_slo_engine(strategy, mesh=(4, 4, 2), deadline_ticks=12,
                               tenant_queue_depth=16, device="cpu")
        re = R.loadgen.make_slo_engine(strategy)
        got = P.drive(pe, "deadline_heavy", BENCH_TICKS, seed=BENCH_SEED,
                      trace=True)
        assert got == R.loadgen.drive(re, "deadline_heavy", BENCH_TICKS,
                                      seed=BENCH_SEED, trace=True)
        _same_engine(re, pe)
        got.pop("per_tick")
        assert got == committed[("deadline_heavy", strategy)]
        miss[strategy] = got["miss_rate"]
    assert miss["deadline"] < miss["fifo"]


def test_drive_restores_prior_waiter_callback():
    seen = []
    prior = lambda name, ev: seen.append((name, ev))   # noqa: E731
    eng = P.make_slo_engine("deadline", device="cpu")
    eng.waiter_callback = prior
    P.drive(eng, "deadline_heavy", ticks=20, seed=0)
    assert eng.waiter_callback is prior and seen


# --- the engine op by op -----------------------------------------------------
# name -> (engine settings, share of ticks that step a subset of the
# tenants, telemetry counters the run must move).
ENGINE_CASES = {
    "spread_queue_reclaim": (dict(idle_evict_ticks=1, deadline_ticks=3,
                                  ring_slots=4), 0.9, ("idle_evictions",)),
    "partition_shed_scalar": (dict(placement_policy="partition",
                                   admission="shed", control_plane="scalar",
                                   ring_slots=3), 0.3, ("shed_tenants",)),
    "stall_feedback_single_layer": (dict(
        placement_policy="stall_feedback", repack_stall_threshold=0,
        ring_slots=2, n_slots=2, mesh=(8, 4, 1)), 0.3,
        ("repacks", "stall_cycles")),
    "stall_feedback_auto": (dict(placement_policy="stall_feedback",
                                 sched_policy="auto",
                                 repack_stall_threshold=4), 0.3,
                            ("tenant_queue_expired",)),
    "raise_longest_first": (dict(admission="raise", mesh=(4, 4, 1),
                                 sched_policy="longest_first",
                                 ring_slots=4), 0.3, ("init_requests",)),
    "stacked_spread": (dict(stacks=2, ring_slots=4, idle_evict_ticks=3),
                       0.3, ("migrations", "cross_stack")),
    "stacked_partition_scalar": (dict(stacks=2, placement_policy="partition",
                                      control_plane="scalar",
                                      idle_evict_ticks=1), 0.8,
                                 ("migrations", "idle_evictions")),
    "paper_mesh_hybrid": (dict(mesh=(8, 8, 4), admission_strategy="hybrid",
                               ring_slots=5, max_extra_slots=1), 0.3,
                          ("init_requests",)),
}


def _engine(mod, core, case):
    kw = dict(ENGINE_CASES[case][0])
    mesh, stacks = kw.pop("mesh", (4, 4, 2)), kw.pop("stacks", 1)
    if mod is P:
        kw["device"] = "cpu"
    return mod.Engine(model=mod.loadgen.CacheStub(), cfg=None, max_len=16,
                      cache_mesh=core.make_topology(stacks, mesh),
                      tenant_queue_depth=4, **kw)


def _step(eng, op):
    """Apply one op; its outcome as plain data (or the error it raised)."""
    kind, args = op[0], op[1:]
    try:
        if kind == "open":
            name, batch, kw = args
            return _plain(eng.open_tenant(name, batch, **kw))
        if kind == "tick":
            return _plain(eng.schedule_tick(args[0]))
        if kind == "close":
            return _plain(eng.close_tenant(args[0]))
        return _plain(eng.migrate_tenant(*args))
    except (RuntimeError, ValueError) as exc:
        return type(exc).__name__, str(exc)


N_OPS = 120


def _next_op(eng, rng, k, subset, stacked):
    """One random op, its target drawn from ``eng``'s live tenants."""
    live = eng.tenants()
    u = rng.random()
    if u < 0.35 or not live:
        return ("open", f"s{k}", int(rng.integers(1, 4)), dict(
            deadline=(None if rng.random() < 0.5
                      else eng._tick + int(rng.integers(0, 6))),
            priority=float(rng.choice([0.5, 1.0, 4.0])),
            klass=str(rng.choice(["a", "b"]))))
    if u < 0.7 or (u >= 0.85 and not stacked):
        return ("tick", None if rng.random() >= subset else
                [live[int(i)] for i in rng.choice(len(live), size=min(
                    2, len(live)), replace=False)])
    if u < 0.85:
        return ("close", live[int(rng.integers(0, len(live)))]
                if rng.random() < 0.9 else f"s{k}")
    return ("migrate", live[int(rng.integers(0, len(live)))],
            int(rng.integers(0, 2)))


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_ops_match_reference(R, case):
    """Random open / tick / close / migrate ops in lockstep on both
    engines (each op picked from the reference engine's state): every
    return value, waiter event and the final telemetry, reports and slot
    tables equal."""
    pe, re = _engine(P, PC, case), _engine(R.serving, R.core, case)
    subset, moved = ENGINE_CASES[case][1:]
    events = {"p": [], "r": []}
    pe.waiter_callback = lambda n, ev: events["p"].append((n, ev))
    re.waiter_callback = lambda n, ev: events["r"].append((n, ev))
    rng = np.random.default_rng(sum(map(ord, case)))
    stacked = isinstance(re.fabric, R.core.FabricCluster)
    for k in range(N_OPS):
        op = _next_op(re, rng, k, subset, stacked)
        assert _step(pe, op) == _step(re, op), (k, op)
        assert pe.tenants() == re.tenants()
    assert events["p"] == events["r"]
    _same_engine(re, pe)
    tel = pe.transfer_telemetry()
    assert all(tel[k] > 0 for k in moved), {k: tel[k] for k in moved}


def test_engine_rejects_bad_settings_like_the_reference(R):
    for kw in ({"admission": "later"}, {"control_plane": "simd"},
               {"admission_strategy": "nope"}):
        with pytest.raises(ValueError) as got:
            P.Engine(model=P.loadgen.CacheStub(), cfg=None, device="cpu", **kw)
        with pytest.raises(ValueError) as want:
            R.serving.Engine(model=R.loadgen.CacheStub(), cfg=None, **kw)
        assert str(got.value) == str(want.value)
    eng = P.Engine(model=P.loadgen.CacheStub(), cfg=None,
                   track_transfers=False)
    assert eng.fabric is None and eng.pool is None and eng.device == "cuda"
    with pytest.raises(RuntimeError, match="no pool"):
        eng.open_tenant("a", 1)
    assert eng.transfer_telemetry() == {}


def test_engine_defaults_to_the_card():
    """Engine() tracks transfers by default, building its fabric on the
    card; without a GPU that raises instead of running on the CPU."""
    assert P.Engine.__dataclass_fields__["track_transfers"].default is True
    if torch.cuda.is_available():
        eng = P.make_slo_engine()
        assert eng.fabric.allocator.device.type == "cuda"
        return
    for call in (lambda: P.make_slo_engine(),
                 lambda: P.Engine(model=P.loadgen.CacheStub(), cfg=None)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    eng = P.make_slo_engine(device="cpu")
    assert isinstance(eng.fabric, NomFabric)
    assert eng.fabric.allocator.device.type == "cpu"


# --- tracked generate --------------------------------------------------------
@pytest.fixture(scope="module", params=["recurrentgemma-9b", "mamba2-130m",
                                        "qwen1.5-4b", "gemma3-27b"])
def smoke(request, R):
    """A smoke model drawn by the reference's ``init``, and the port's
    model on the same weights (CPU)."""
    import jax
    from repro.configs import get_config as jget
    from repro.models import make_model as jmake

    from repro_torch.configs import get_config
    from repro_torch.models import CausalLM, params_from_reference
    jcfg = jget(request.param, smoke=True)
    jmodel = jmake(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config(request.param, smoke=True)
    model = CausalLM(cfg, "cpu")
    model.load_state_dict(params_from_reference(
        jax.tree.map(np.asarray, params), cfg))
    return jcfg, jmodel, params, cfg, model


def test_tracked_generate_matches_reference(R, smoke):
    """Leaf specs, every batch report and the telemetry of a tracked
    generate equal the reference's on the same prompt (they depend on
    shapes only); the tokens equal the port's untracked run."""
    import jax.numpy as jnp
    jcfg, jmodel, params, cfg, model = smoke
    prompt = np.random.default_rng(3).integers(0, cfg.vocab, (3, 5))
    eng = P.Engine(model, cfg, max_len=64, device="cpu")
    ref = R.serving.Engine(jmodel, jcfg, max_len=64)
    specs = eng._leaf_specs(3)
    assert _plain(specs) == _plain(ref._leaf_specs(3))
    # recurrentgemma: 12 scan groups of rglru, rglru, attn and a tail of
    # two; gemma3: 2 groups of local, local, global and a tail of two
    # (k and v a layer); mamba2 and qwen1.5: one group of one layer.
    assert len(specs) == {"recurrentgemma-smoke": 10, "gemma3-smoke": 10,
                          "mamba2-smoke": 2, "qwen1.5-smoke": 2}[cfg.name]
    out = eng.generate(torch.as_tensor(prompt), 8)
    ref.generate(params, jnp.asarray(prompt, jnp.int32), 8)
    assert len(eng.reports) == len(ref.reports) == 5 + 8 - 1 + 1
    _same_engine(ref, eng)
    assert eng.tenants() == [] and eng.pool.free_banks() == \
        len(eng.pool._pool)
    plain = P.Engine(model, cfg, max_len=64, track_transfers=False)
    assert torch.equal(out, plain.generate(torch.as_tensor(prompt), 8))
    assert plain._step is not None and plain.fabric is None


def test_generate_shed_from_tracking_keeps_tokens(smoke):
    """A stream the pool cannot admit still generates, untracked, and is
    counted as shed."""
    *_, cfg, model = smoke
    eng = P.Engine(model, cfg, max_len=32, device="cpu",
                   cache_mesh=make_topology(mesh=(2, 2, 2)))
    prompt = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 3)))
    while eng.pool.free_banks() >= len(eng._leaf_specs(2)):
        assert eng.open_tenant(f"hog{eng.pool.free_banks()}", 2)
    n_steps = eng.n_sched_steps
    out = eng.generate(prompt, 4, tenant="late")
    assert eng.tenant_queue.n_shed == 1 and eng.n_sched_steps == n_steps
    plain = P.Engine(model, cfg, max_len=32, track_transfers=False)
    assert torch.equal(out, plain.generate(prompt, 4))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_mod",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# The archs chip_smoke.py serves at full width on the card (MODELS), with
# its cut of layers (MODEL_LAYERS): gemma3-27b at 8 of its 62 layers, one
# 5-local + 1-global period and a tail of two local layers.
_SMOKE = _chip_smoke()
FULL_WIDTH = {arch: _SMOKE.MODEL_LAYERS.get(arch) for arch in _SMOKE.MODELS}


def _full_width(R, arch):
    from repro.configs import get_config as jget
    from repro.models import make_model as jmake

    from repro_torch.configs import get_config
    from repro_torch.models import CausalLM
    jcfg, cfg = jget(arch), get_config(arch)
    if FULL_WIDTH[arch] is not None:
        jcfg = dataclasses.replace(jcfg, n_layers=FULL_WIDTH[arch])
        cfg = dataclasses.replace(cfg, n_layers=FULL_WIDTH[arch])
    return jmake(jcfg), jcfg, CausalLM(cfg, "meta")


@pytest.mark.parametrize("arch", sorted(FULL_WIDTH))
def test_full_width_leaf_specs_match_reference(R, arch):
    """At full width (gemma3-27b at its 8-layer cut), from shapes alone
    (the port's model on the meta device, the reference's through
    jax.eval_shape): the leaf specs at launch/serve.py's max_len equal,
    recurrentgemma's 10 leaves (12 scan groups of rglru, rglru, attn and
    a tail of two), mamba2's 2, qwen1.5's 2 and gemma3's 16 (one group of
    six layers, a tail of two, k and v each)."""
    jmodel, jcfg, model = _full_width(R, arch)
    eng = P.Engine(model, model.cfg, max_len=40, track_transfers=False)
    ref = R.serving.Engine(jmodel, jcfg, max_len=40, track_transfers=False)
    specs = eng._leaf_specs(4)
    assert _plain(specs) == _plain(ref._leaf_specs(4))
    tags = [s.tag for s in specs]
    if arch == "recurrentgemma-9b":
        assert tags[:2] == ["['groups']['l0']['conv']",
                            "['groups']['l0']['h']"]
        assert tags[-1] == "['tail']['l1']['h']" and len(tags) == 10
        assert [s.ring_slots for s in specs if "['l2']" in s.tag] == [40, 40]
    elif arch == "mamba2-130m":
        assert tags == ["['groups']['l0']['conv']", "['groups']['l0']['ssm']"]
    elif arch == "qwen1.5-4b":
        assert tags == ["['groups']['l0']['k']", "['groups']['l0']['v']"]
    else:
        assert len(tags) == 16 and tags[-1] == "['tail']['l1']['v']"
        assert all(s.ring_slots == 40 for s in specs)


@pytest.mark.parametrize("arch", sorted(FULL_WIDTH))
def test_full_width_tenant_matches_reference(R, arch):
    """A tenant with the full-width leaf specs through launch/serve.py's
    lifetime (open, 31 steps, close) on the paper mesh: recurrentgemma's
    and mamba2's circuits hold megabytes (mamba2's ssm leaf 75 MB a
    step), the dense archs' a step of k or v rows, and every report, the
    telemetry and the slot tables equal the reference's; gemma3's 16
    leaves fill a fused wave a step."""
    jmodel, jcfg, model = _full_width(R, arch)
    eng = P.Engine(model, model.cfg, max_len=40, device="cpu")
    ref = R.serving.Engine(jmodel, jcfg, max_len=40)
    for e in (eng, ref):
        e.open_tenant("gen0", 4, queue=False)
        for _ in range(31):
            e.schedule_tick(["gen0"])
        e.close_tenant("gen0")
    _same_engine(ref, eng)
    specs = eng._leaf_specs(4)
    if arch in ("recurrentgemma-9b", "mamba2-130m"):
        assert max(s.step_bytes for s in specs) > 10**6
    else:
        # One decode step's k or v rows for B=4 in bf16: qwen1.5's leaves
        # stack all 40 layers (800 KiB each), gemma3's one layer (16 KiB).
        cfg = model.cfg
        row = 4 * cfg.n_kv * cfg.resolved_head_dim * 2
        layers = cfg.n_layers if arch == "qwen1.5-4b" else 1
        assert [s.step_bytes for s in specs] == [row * layers] * len(specs)
    if arch == "gemma3-27b":
        assert eng.fabric.telemetry()["fused_waves"] >= 31


@settings(max_examples=60, deadline=None, database=None)
@given(st.lists(st.tuples(st.integers(0, 300), st.integers(0, 40)),
                max_size=12), st.sampled_from([1, 4, 16]))
def test_window_occupancy_is_the_reference_histogram(spans, n_slots):
    """The boundary sweep gives the reference's per-window histogram's
    span, maximum and mean, to the last bit."""
    from repro_torch.core.scheduler import window_occupancy
    circuits = [types.SimpleNamespace(start_cycle=c, n_windows=w)
                for c, w in spans]
    starts = [c.start_cycle // n_slots for c in circuits]
    w0 = min(starts, default=0)
    span = max((s - w0 + c.n_windows for s, c in zip(starts, circuits)),
               default=0)
    active = np.zeros(span, np.int64)
    for s, c in zip(starts, circuits):
        active[s - w0:s - w0 + c.n_windows] += 1
    busy = active[active > 0]
    want = (int(span), int(busy.max()) if busy.size else 0,
            float(busy.mean()) if busy.size else 0.0)
    assert window_occupancy(circuits, n_slots) == want


def test_leaf_order_follows_jax_key_order(R):
    """Dict keys sort as strings (``l10`` before ``l2``, ``groups``
    before ``tail``), as jax.tree_util flattens them, with its key
    strings."""
    import jax
    from repro_torch.serving.engine import _flatten
    tree = {"tail": {"l0": {"v": 5, "k": 6}},
            "groups": {f"l{i}": {"h": i, "conv": -i} for i in (0, 2, 10)}}
    want = [(jax.tree_util.keystr(k), v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert _flatten(tree) == want
    assert [k for k, _v in want][2:4] == ["['groups']['l10']['conv']",
                                          "['groups']['l10']['h']"]


def test_serve_launcher_tracks_by_default(capsys):
    from repro_torch.launch.serve import main
    out = main(["--arch", "mamba2-130m", "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "3", "--new-tokens", "4"])
    assert out.shape == (2, 7)
    printed = capsys.readouterr().out
    # 3 + 4 - 1 steps of 2 copies, then 2 teardown INITs.
    assert "[serve] transfers: 14 requests in 7 batches (2 INIT)" in printed


# --- multi-stack engines -----------------------------------------------------
def _stub_engine(mod, mk, topo_args):
    kw = {} if mod is not P else {"device": "cpu"}
    return mod.Engine(model=mod.loadgen.CacheStub(), cfg=None, max_len=16,
                      cache_mesh=mk(*topo_args), ring_slots=4, **kw)


def test_engine_migrate_tenant_cross_stack(R):
    runs = []
    for mod, mk in ((P, make_topology), (R.serving, R.core.make_topology)):
        eng = _stub_engine(mod, mk, (2, (4, 4, 2)))
        assert isinstance(eng.fabric, FabricCluster if mod is P
                          else R.core.FabricCluster)
        eng.open_tenant("t0", 2)
        first = eng.migrate_tenant("t0", 0)
        rep = eng.migrate_tenant("t0", 1)
        assert rep is not None
        assert rep.n_cross_stack >= 1 and rep.n_init >= 1
        assert all(eng.pool.stack_of(ls.home) == 1
                   for ls in eng.pool.leases("t0"))
        tick = eng.schedule_tick(["t0"])
        assert tick is not None
        tel = eng.transfer_telemetry()
        assert tel["migrations"] >= 1 and tel["cross_stack"] >= 1
        assert eng.migrate_tenant("t0", 1) is None
        eng.close_tenant("t0")
        with pytest.raises(ValueError):
            eng.migrate_tenant("t0", 0)
        runs.append((eng, _plain([first, rep, tick])))
    (pe, got), (re, want) = runs
    assert got == want
    _same_engine(re, pe)


def test_engine_single_stack_unchanged(R):
    runs = []
    for mod, mk in ((P, make_topology), (R.serving, R.core.make_topology)):
        eng = _stub_engine(mod, mk, (1, (2, 2, 2)))
        assert isinstance(eng.fabric, NomFabric if mod is P
                          else R.core.NomFabric)
        eng.open_tenant("a", 1)
        assert eng.migrate_tenant("a", 0) is None
        rep = eng.schedule_tick(["a"])
        assert rep.n_cross_stack == 0
        eng.close_tenant("a")
        runs.append((eng, _plain(rep)))
    (pe, got), (re, want) = runs
    assert got == want
    _same_engine(re, pe)


# --- on the card -------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["fifo", "stall_aware"])
def test_drive_on_the_card_matches_the_cpu(strategy):
    """The SLO harness with its fabric on the card (fused prepare kernel
    for every wave over 8 requests) against the same drive on the CPU:
    equal records, telemetry, reports and slot tables."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    from repro_torch.kernels import _lib
    runs = {}
    for device in ("cuda", "cpu"):
        eng = P.make_slo_engine(strategy, device=device)
        _lib.reset_launch_counts()
        rec = P.drive(eng, "deadline_heavy", 40, seed=7, trace=True)
        runs[device] = (eng, rec, dict(_lib.launch_counts))
    (ce, crec, claunch), (pe, prec, _) = runs["cuda"], runs["cpu"]
    assert crec == prec
    _same_engine(pe, ce)
    fused = ce.fabric.telemetry()["fused_waves"]
    assert fused > 0 and claunch["fused_prepare"] == fused
