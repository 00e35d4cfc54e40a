"""repro_torch's multi-stack CCU against repro's, on the CPU (each stack's
kernels on their plain versions): StackedTopology's geometry and errors,
SegmentedAllocator's circuits and link table, FabricCluster on the fused
and host backends (results, reports, telemetry, every slot table and
the cross-stack counters), the two-phase commit and reduce-tree
rollbacks, and the bank-level planners nom_reduce / nom_allreduce_banks.
Everything is integer host arithmetic, held equal exactly.  The one
``cuda`` test holds the cluster on the card against the CPU."""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro_torch.core as P
import repro_torch.core.topology as PT

N_SLOTS = 16
SETTINGS = settings(max_examples=15, deadline=None, database=None)


@pytest.fixture(scope="module")
def R():
    """The JAX package's core (CPU); absent on a machine without JAX."""
    pytest.importorskip("jax")
    import repro.core as ref
    return ref


def _topos(R, n_stacks, dims=(4, 4, 2), **kw):
    return (R.make_topology(n_stacks, dims, **kw),
            P.make_topology(n_stacks, dims, **kw))


def _rkey(res):
    """An AllocResult as plain data: every field of its circuit (a
    Circuit, StackedCircuit or ReduceTree) and its searched cycle."""
    c = res.circuit
    return (res.searched_cycle, None if c is None
            else (type(c).__name__, dataclasses.asdict(c)))


def _state(cl):
    """Every expiry table a cluster holds, each with its packed busy
    masks: per stack its ports and NoM-Light buses, then the SerDes
    links."""
    tables = []
    for f in cl.fabrics:
        tables += [f.allocator.table._ports, f.allocator.table._bus]
    tables.append(cl.segmented.links)
    return [a for t in tables for a in (t.expiry, t.masks,
                                        np.asarray(t.window))]


def _same_cluster(rc, pc):
    assert pc.telemetry() == rc.telemetry()
    for a, b in zip(_state(rc), _state(pc)):
        np.testing.assert_array_equal(b, a)
    assert (pc.clock, pc.last_cycle, pc.n_flushes) == \
        (rc.clock, rc.last_cycle, rc.n_flushes)
    assert [f.clock for f in pc.fabrics] == [f.clock for f in rc.fabrics]
    seg_r, seg_p = rc.segmented, pc.segmented
    assert (seg_p.rollbacks, seg_p.denied, seg_p.link_windows) == \
        (seg_r.rollbacks, seg_r.denied, seg_r.link_windows)


def _stream(topo, n, seed):
    """Seeded request dicts in every addressing form the cluster takes
    (global ids, (stack, node) tuples, src_stack/dst_stack fields):
    copies (extra-slot bundles, per-request anchors), same-stack inits,
    and fan-in reduces from one layer of one stack (the destination's
    layer in its own stack, else the bridge's), same-stack and
    cross-stack."""
    rng = np.random.default_rng(seed)
    mesh = topo.stacks[0]
    out = []
    for _ in range(n):
        u = rng.random()
        if u < 0.08:
            dst = int(rng.integers(topo.n_nodes))
            ds, dl = topo.locate(dst)
            stack = int(rng.integers(topo.n_stacks))
            z = mesh.coords(dl)[2] if stack == ds else 0
            pool = [topo.global_id(stack, v) for v in range(mesh.n_nodes)
                    if mesh.coords(v)[2] == z and
                    topo.global_id(stack, v) != dst]
            srcs = [int(v) for v in rng.choice(pool, size=3, replace=False)]
            if rng.random() < 0.5:
                srcs = [topo.locate(v) for v in srcs]
                dst = topo.locate(dst)
            out.append(("reduce", srcs, dst, int(rng.integers(256, 4096))))
        elif u < 0.18:
            v = int(rng.integers(topo.n_nodes))
            out.append(dict(src=v, dst=v, op="init",
                            nbytes=int(rng.integers(64, 20000))))
        else:
            s, d = (int(x) for x in rng.integers(topo.n_nodes, size=2))
            while s == d:
                d = int(rng.integers(topo.n_nodes))
            req = dict(src=s, dst=d, nbytes=int(rng.integers(64, 4096)),
                       max_extra_slots=(int(rng.integers(1, 4))
                                        if rng.random() < 0.2 else 0),
                       cycle=(int(rng.integers(0, 40))
                              if rng.random() < 0.1 else None))
            form = rng.random()
            if form < 0.3:
                req["src"], req["dst"] = topo.locate(s), topo.locate(d)
            elif form < 0.5:
                (ss, sl), (dd, dl) = topo.locate(s), topo.locate(d)
                req.update(src=sl, dst=dl, src_stack=ss, dst_stack=dd)
            out.append(req)
    return out


def _requests(mod, reqs):
    return [mod.reduce_request(r[1], r[2], nbytes=r[3])
            if isinstance(r, tuple) else mod.TransferRequest(**r)
            for r in reqs]


def _clusters(R, n_stacks, kind, dims=(4, 4, 2), **kw):
    rt, pt = _topos(R, n_stacks, dims, **kw)
    if kind == "light":
        return (R.FabricCluster(rt, allocators=[
                    R.TdmAllocatorLight(m, N_SLOTS) for m in rt.stacks]),
                P.FabricCluster(pt, allocators=[
                    P.TdmAllocatorLight(m, N_SLOTS, device="cpu")
                    for m in pt.stacks]))
    return (R.FabricCluster(rt, n_slots=N_SLOTS, alloc_backend=kind),
            P.FabricCluster(pt, n_slots=N_SLOTS, alloc_backend=kind,
                            device="cpu"))


# --- degenerate single-stack meshes (tests/test_multistack.py) ----------------
@pytest.mark.parametrize("dims,src,dst", [((1, 4, 2), (0, 0, 0), (0, 3, 1)),
                                          ((4, 4, 1), (0, 0, 0), (3, 3, 0))])
def test_degenerate_mesh_allocates_like_reference(R, dims, src, dst):
    rm = R.Mesh3D(*dims, vault_span_y=2)
    pm = PT.Mesh3D(*dims, vault_span_y=2)
    want = R.TdmAllocator(rm, N_SLOTS).allocate(rm.node_id(*src),
                                                rm.node_id(*dst), 512, 0)
    got = P.TdmAllocator(pm, N_SLOTS, device="cpu").allocate(
        pm.node_id(*src), pm.node_id(*dst), 512, 0)
    assert _rkey(got) == _rkey(want)
    slots = [h[2] for h in got.circuit.hops]
    assert all((a + 1) % N_SLOTS == b for a, b in zip(slots, slots[1:]))
    assert got.circuit.hops[-1][1] == P.PORT_LOCAL


def test_rounds_busy_persists_across_anchored_flushes(R):
    """tests/test_multistack.py's rounds-backend check on the port: two
    flushes anchored at one cycle share the session's link reservations;
    un-anchored flushes each equal a fresh session's plan."""
    def plans(mod, anchored):
        reqs = [mod.TransferRequest(src=(i,), dst=((i + 1) % 8,),
                                    nbytes=4096) for i in range(8)]
        fab = mod.NomFabric(shape=(8,), torus=True)
        return [sorted(fab.schedule(reqs, cycle=0 if anchored else None)[0]
                       .starts) for _ in range(2)]
    for anchored in (True, False):
        assert plans(P, anchored) == plans(R, anchored)
    fresh = plans(P, True)[0]
    assert plans(P, True)[1] != fresh
    assert plans(P, False) == [fresh, fresh]


def test_report_merge_accumulates_cross_stack():
    a = P.ScheduleReport(backend="tdm", n_requests=2, n_scheduled=2,
                         n_windows=1, max_inflight=1, avg_inflight=1.0,
                         n_cross_stack=1)
    b = dataclasses.replace(a, n_requests=3, n_scheduled=3, n_cross_stack=2)
    assert a.merge(b).n_cross_stack == 3


# --- StackedTopology ------------------------------------------------------------
TOPOLOGIES = [
    (2, (4, 4, 2), {}), (3, (4, 4, 2), {}), (4, (8, 8, 4), {}),
    (4, (4, 4, 2), {"link": "full"}), (5, (2, 2, 2), {}),
    (3, (4, 4, 2), {"link": "full", "link_latency": 3, "link_bytes": 8}),
    (1, (4, 4, 2), {"meshes": ((4, 4, 2), (2, 4, 2), (4, 2, 1))}),
]


@pytest.mark.parametrize("n_stacks,dims,kw", TOPOLOGIES)
def test_stacked_geometry_matches_reference(R, n_stacks, dims, kw):
    rt, pt = _topos(R, n_stacks, dims, **kw)
    assert isinstance(pt, PT.StackedTopology)
    assert (pt.n_stacks, pt.link, pt.link_latency, pt.link_bytes,
            pt.n_nodes, pt.offsets, pt.n_channels) == \
        (rt.n_stacks, rt.link, rt.link_latency, rt.link_bytes, rt.n_nodes,
         rt.offsets, rt.n_channels)
    assert [(m.X, m.Y, m.Z, m.vault_span_y) for m in pt.stacks] == \
        [(m.X, m.Y, m.Z, m.vault_span_y) for m in rt.stacks]
    assert [dataclasses.astuple(ln) for ln in pt.links] == \
        [dataclasses.astuple(ln) for ln in rt.links]
    for gid in range(rt.n_nodes):
        assert pt.locate(gid) == rt.locate(gid)
        assert pt.stack_of(gid) == rt.stack_of(gid)
        assert pt.global_id(*pt.locate(gid)) == gid
    bridges = [rt.global_id(s, rt.bridge_of(s)) for s in range(rt.n_stacks)]
    for a in range(rt.n_stacks):
        assert pt.bridge_of(a) == rt.bridge_of(a)
        for b in range(rt.n_stacks):
            assert pt.stack_route(a, b) == rt.stack_route(a, b)
            assert pt.route_channels(a, b) == rt.route_channels(a, b)
            assert pt.route_cycles(a, b) == rt.route_cycles(a, b)
            assert pt.is_cross(bridges[a], bridges[b]) == \
                rt.is_cross(bridges[a], bridges[b])
            try:
                want = rt.channel(a, b)
            except ValueError as exc:
                with pytest.raises(ValueError) as got:
                    pt.channel(a, b)
                assert str(got.value) == str(exc)
            else:
                assert pt.channel(a, b) == want


INVALID = [
    lambda T, m: T.StackedTopology(0, m),
    lambda T, m: T.StackedTopology(2, m, link="star"),
    lambda T, m: T.StackedTopology(3, m, meshes=(m, m)),
    lambda T, m: T.StackedTopology(2, m, link_bytes=0),
    lambda T, m: T.StackedTopology(2, m, link_latency=-1),
    lambda T, m: T.StackedTopology(2, m).global_id(2, 0),
    lambda T, m: T.StackedTopology(2, m).global_id(1, m.n_nodes),
    lambda T, m: T.StackedTopology(2, m).locate(-1),
    lambda T, m: T.StackedTopology(2, m).locate(2 * m.n_nodes),
    lambda T, m: T.StackedTopology(3, m).bridge_of(3),
    lambda T, m: T.StackedTopology(4, m).channel(0, 2),
    lambda T, m: T.StackedTopology(3, m).stack_route(0, 5),
]


@pytest.mark.parametrize("case", range(len(INVALID)))
def test_stacked_validation_matches_reference(R, case):
    import repro.core.topology as RT
    with pytest.raises(ValueError) as want:
        INVALID[case](RT, RT.Mesh3D(4, 4, 2))
    with pytest.raises(ValueError) as got:
        INVALID[case](PT, PT.Mesh3D(4, 4, 2))
    assert str(got.value) == str(want.value)


def test_make_topology_forms_match_reference(R):
    assert isinstance(P.make_topology(1, (4, 4, 2)), PT.Mesh3D)
    rt = R.make_topology(2, (4, 4, 4), vault_span_y=4, link="full")
    pt = P.make_topology(2, (4, 4, 4), vault_span_y=4, link="full")
    assert [(m.X, m.Y, m.Z, m.vault_span_y) for m in pt.stacks] == \
        [(m.X, m.Y, m.Z, m.vault_span_y) for m in rt.stacks]
    assert pt.links == tuple(P.StackLink(*dataclasses.astuple(ln))
                             for ln in rt.links)


# --- SegmentedAllocator ---------------------------------------------------------
@pytest.mark.parametrize("light", [False, True])
@pytest.mark.parametrize("n_stacks,kw", [(2, {}), (4, {}),
                                         (3, {"link": "full",
                                              "link_latency": 2})])
@pytest.mark.parametrize("seed", [0, 1])
def test_segmented_allocator_matches_reference(R, seed, n_stacks, kw, light):
    """Seeded cross-stack requests, each stack first congested through its
    own CCU: every StackedCircuit field (or the denial), the link expiry
    table, every stack's expiry and the protocol counters."""
    rc, pc = _clusters(R, n_stacks, "light" if light else "host", **kw)
    topo = pc.topology
    rng = np.random.default_rng(seed)
    mesh = topo.stacks[0]
    for s in range(n_stacks):
        local = [dict(src=int(a), dst=int(b), nbytes=int(n))
                 for a, b, n in zip(rng.integers(mesh.n_nodes, size=24),
                                    rng.integers(mesh.n_nodes, size=24),
                                    rng.integers(256, 4096, size=24))
                 if a != b]
        rc.fabrics[s].schedule(_requests(R, local), cycle=0)
        pc.fabrics[s].schedule(_requests(P, local), cycle=0)
    n_granted = 0
    for _ in range(60):
        sa, sb = rng.choice(n_stacks, size=2, replace=False)
        src = (int(sa), int(rng.integers(mesh.n_nodes)))
        dst = (int(sb), int(rng.integers(mesh.n_nodes)))
        nbytes, cycle = int(rng.integers(16, 4096)), int(rng.integers(0, 600))
        want = rc.segmented.allocate(src, dst, nbytes, cycle)
        got = pc.segmented.allocate(src, dst, nbytes, cycle)
        assert (got is None) == (want is None)
        if got is not None:
            n_granted += 1
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert (got.arrival_cycle, got.end_cycle, got.hops) == \
                (want.arrival_cycle, want.end_cycle, want.hops)
    assert n_granted > 0
    _same_cluster(rc, pc)
    with pytest.raises(ValueError, match="cross-stack traffic"):
        pc.segmented.allocate((0, 1), (0, 2), 64, 0)


def test_segmented_allocator_rejects_allocator_count(R):
    pt = P.make_topology(2, (4, 4, 2))
    with pytest.raises(ValueError, match="1 allocators for 2 stacks"):
        P.SegmentedAllocator(pt, [P.TdmAllocator(pt.stacks[0],
                                                 device="cpu")])
    with pytest.raises(ValueError, match="1 allocators for 2 stacks"):
        P.FabricCluster(pt, allocators=[P.TdmAllocator(pt.stacks[0],
                                                       device="cpu")])


# --- FabricCluster ----------------------------------------------------------------
CLUSTER_CASES = [(2, {}, True), (3, {"link": "full"}, False),
                 (4, {}, True), (4, {"link_latency": 2}, False)]


@pytest.mark.parametrize("n_stacks,kw,anchored", CLUSTER_CASES)
@pytest.mark.parametrize("kind", ["fused", "host", "light"])
def test_cluster_matches_reference(R, kind, n_stacks, kw, anchored):
    """Mixed streams in several flushes, anchored apart (contention and
    denials) or at the session clock: results, reports, telemetry, slot
    tables, clocks and the cross-stack counters all equal."""
    rc, pc = _clusters(R, n_stacks, kind, **kw)
    reqs = _stream(pc.topology, 240, seed=n_stacks)
    for k in range(4):
        chunk = reqs[k * 60:(k + 1) * 60]
        cycle = k * 256 if anchored else None
        r_res, r_rep = rc.schedule(_requests(R, chunk), cycle=cycle)
        p_res, p_rep = pc.schedule(_requests(P, chunk), cycle=cycle)
        assert [_rkey(r) for r in p_res] == [_rkey(r) for r in r_res]
        assert dataclasses.asdict(p_rep) == dataclasses.asdict(r_rep)
    _same_cluster(rc, pc)
    tel = pc.telemetry()
    assert tel["cross_committed"] > 0 and tel["reduce_requests"] > 0


def test_cluster_backends_agree_up_to_the_wave_split(R):
    """The fused and host backends commit the same circuits; only the
    fused/host wave counters differ."""
    pt = P.make_topology(3, (4, 4, 2))
    reqs = _stream(pt, 300, seed=7)
    out = {}
    for kind in ("fused", "host"):
        cl = P.FabricCluster(pt, n_slots=N_SLOTS, alloc_backend=kind,
                             device="cpu")
        res, _rep = cl.schedule(_requests(P, reqs), cycle=0)
        out[kind] = (cl, [_rkey(r) for r in res])
    assert out["fused"][1] == out["host"][1]
    waves = ("fused_waves", "host_waves")
    tf, th = out["fused"][0].telemetry(), out["host"][0].telemetry()
    assert {k: v for k, v in tf.items() if k not in waves + ("stacks",)} == \
        {k: v for k, v in th.items() if k not in waves + ("stacks",)}
    assert tf["fused_waves"] > 0 and th["fused_waves"] == 0
    for a, b in zip(_state(out["fused"][0]), _state(out["host"][0])):
        np.testing.assert_array_equal(a, b)


def test_cluster_submit_and_flush_match_reference(R):
    rc, pc = _clusters(R, 2, "host")
    reqs = _stream(pc.topology, 43, seed=3)
    for i, (a, b) in enumerate(zip(_requests(R, reqs), _requests(P, reqs))):
        assert pc.submit(b, at=i) == rc.submit(a, at=i)
        if pc.pending == 8:
            r_res, _ = rc.flush()
            p_res, _ = pc.flush()
            assert [_rkey(r) for r in p_res] == [_rkey(r) for r in r_res]
    assert pc.pending == rc.pending > 0
    r_res, _ = rc.flush()
    p_res, _ = pc.flush()
    assert [_rkey(r) for r in p_res] == [_rkey(r) for r in r_res]
    assert pc.flush() is None and rc.flush() is None
    _same_cluster(rc, pc)


def test_single_stack_cluster_is_a_bare_fabric(R):
    """One stack: the cluster delegates every batch, so results, reports
    and clocks equal a bare NomFabric's (and the reference's)."""
    mesh = PT.Mesh3D(4, 4, 2)
    rng = np.random.default_rng(3)
    reqs = [dict(src=int(s), dst=int(d), nbytes=256)
            for s, d in zip(rng.integers(32, size=24),
                            rng.integers(32, size=24)) if s != d]
    reqs.append(dict(src=5, dst=5, nbytes=2048, op="init"))
    fab = P.NomFabric(mesh=mesh, n_slots=N_SLOTS, device="cpu")
    clu = P.FabricCluster(topology=P.StackedTopology(1, mesh),
                          n_slots=N_SLOTS, device="cpu")
    ref = R.FabricCluster(topology=R.StackedTopology(1, R.Mesh3D(4, 4, 2)),
                          n_slots=N_SLOTS)
    for _ in range(2):
        res_f, rep_f = fab.schedule(_requests(P, reqs))
        res_c, rep_c = clu.schedule(_requests(P, reqs))
        res_r, rep_r = ref.schedule(_requests(R, reqs))
        assert rep_f == rep_c
        assert dataclasses.asdict(rep_c) == dataclasses.asdict(rep_r)
        assert [_rkey(r) for r in res_f] == [_rkey(r) for r in res_c] == \
            [_rkey(r) for r in res_r]
    assert clu.fabrics[0].clock == fab.clock == ref.fabrics[0].clock
    assert rep_c.n_cross_stack == 0
    np.testing.assert_array_equal(clu.fabrics[0].allocator.table.expiry,
                                  fab.allocator.table.expiry)


def test_cross_stack_circuit_invariants(R):
    """tests/test_multistack.py's structure check on the port's circuit,
    which equals the reference's."""
    rt, pt = _topos(R, 2, link_latency=5, link_bytes=4)
    clu = P.FabricCluster(topology=pt, n_slots=N_SLOTS, device="cpu")
    ref = R.FabricCluster(topology=rt, n_slots=N_SLOTS)
    mesh = pt.stacks[0]
    src, dst = (0, mesh.node_id(2, 3, 1)), (1, mesh.node_id(3, 1, 1))
    c = clu.segmented.allocate(src, dst, 96, cycle=0)
    assert dataclasses.asdict(c) == \
        dataclasses.asdict(ref.segmented.allocate(src, dst, 96, cycle=0))
    n = N_SLOTS
    slots = [h[2] for h in c.near_hops]
    assert all((a + 1) % n == b for a, b in zip(slots, slots[1:]))
    a = slots[-1]
    assert c.near_hops[-1][0] == pt.bridge_of(0)
    chans = pt.route_channels(0, 1)
    assert [ch for ch, _s in c.link_slots] == chans
    s = (a + 1) % n
    for _ch, sl in c.link_slots:
        assert sl == s
        s = (s + 1 + pt.link_latency) % n
    T = pt.route_cycles(0, 1)
    far = [h[2] for h in c.far_hops]
    assert far[0] == (a + T) % n
    assert all((x + 1) % n == y for x, y in zip(far, far[1:]))
    assert c.far_hops[-1][1] == P.PORT_LOCAL
    assert c.n_windows == -(-96 // clu.segmented.bottleneck_bytes(0, 1))
    assert c.distance == len(c.near_hops) - 1 + T + len(c.far_hops) - 1


def test_same_stack_requests_never_take_the_cluster_path():
    clu = P.FabricCluster(topology=P.StackedTopology(2, PT.Mesh3D(4, 4, 2)),
                          n_slots=N_SLOTS, device="cpu")
    _res, rep = clu.schedule([
        P.TransferRequest(src=(0, 1), dst=(0, 9), nbytes=256),
        P.TransferRequest(src=(1, 4), dst=(1, 20), nbytes=256)])
    assert rep.n_scheduled == 2 and rep.n_cross_stack == 0
    assert clu.cross_requests == 0 and clu.segmented.link_windows == 0


@pytest.mark.parametrize("req", [
    dict(src=(0, 3), dst=(1, 3), nbytes=64, op="init"),
    dict(src=(0, 3), dst=(0, 3, 1), nbytes=64),
    ("reduce", [(0, 1), (0, 1)], (1, 2), 64),
    ("reduce", [(0, 1), (1, 2)], (1, 2), 64)])
def test_cluster_rejects_like_reference(R, req):
    rc, pc = _clusters(R, 2, "host")
    with pytest.raises(ValueError) as want:
        rc.schedule(_requests(R, [req]))
    with pytest.raises(ValueError) as got:
        pc.schedule(_requests(P, [req]))
    assert str(got.value) == str(want.value)


# --- two-phase commit: a far-side conflict rolls the near side back --------
def _saturate(alloc):
    ports = alloc.table._ports
    ports.expiry[:] = 1 << 40
    ports._recompute(ports.window)


def test_far_conflict_rolls_back_byte_identically(R):
    rc, pc = _clusters(R, 2, "host")
    for cl in (rc, pc):
        _saturate(cl.segmented.allocators[1])
    before = [a.copy() for a in _state(pc)]
    assert pc.segmented.allocate((0, 10), (1, 21), 512, cycle=0) is None
    assert rc.segmented.allocate((0, 10), (1, 21), 512, cycle=0) is None
    for a, b in zip(_state(pc), before):
        np.testing.assert_array_equal(a, b)
    assert pc.segmented.rollbacks >= 1 and pc.segmented.denied == 1
    _same_cluster(rc, pc)


@SETTINGS
@given(st.integers(0, 2 ** 31 - 1), st.integers(1, 40))
def test_two_phase_commit_leaks_nothing(R, seed, n_far_circuits):
    """Whatever local traffic congests the far stack, a denied cross-stack
    request leaves every table as it found them and a committed one
    reserves exactly its hops on each side; both as the reference."""
    rng = np.random.default_rng(seed)
    rc, pc = _clusters(R, 2, "host")
    mesh = pc.topology.stacks[0]
    local = []
    for _ in range(n_far_circuits):
        s, d = (int(v) for v in rng.integers(mesh.n_nodes, size=2))
        if s != d:
            local.append(dict(src=s, dst=d, nbytes=512))
    rc.fabrics[1].schedule(_requests(R, local), cycle=0)
    pc.fabrics[1].schedule(_requests(P, local), cycle=0)
    seg = pc.segmented
    near, far = (a.table._ports for a in seg.allocators)
    before = (near.expiry.copy(), seg.links.expiry.copy(), far.expiry.copy())
    s, d = int(rng.integers(mesh.n_nodes)), int(rng.integers(mesh.n_nodes))
    nbytes = int(rng.integers(16, 2048))
    c = seg.allocate((0, s), (1, d), nbytes, cycle=0)
    want = rc.segmented.allocate((0, s), (1, d), nbytes, cycle=0)
    assert (None if c is None else dataclasses.asdict(c)) == \
        (None if want is None else dataclasses.asdict(want))
    after = (near.expiry, seg.links.expiry, far.expiry)
    if c is None:
        for a, b in zip(after, before):
            np.testing.assert_array_equal(a, b)
    else:
        assert [(a != b).sum() for a, b in zip(after, before)] == \
            [len(c.near_hops), len(c.link_slots), len(c.far_hops)]
    _same_cluster(rc, pc)


# --- cross-stack reduce trees -----------------------------------------------------
def test_cross_stack_reduce_tree_matches_reference(R):
    rc, pc = _clusters(R, 2, "fused")
    req = [("reduce", [(0, 5), (0, 9), (1, 6), (1, 10)], (0, 2), 256)]
    (r_res,), r_rep = rc.schedule(_requests(R, req))
    (p_res,), p_rep = pc.schedule(_requests(P, req))
    tree = p_res.circuit
    assert isinstance(tree, P.ReduceTree) and tree.cross_stack
    assert len(tree.legs) == 1 and len(tree.partials) == 1
    assert tree.local is not None
    assert tree.legs[0].start_cycle >= tree.partials[0].end_cycle
    assert _rkey(p_res) == _rkey(r_res)
    assert (tree.hops, tree.link_slots) == (r_res.circuit.hops,
                                            r_res.circuit.link_slots)
    assert dataclasses.asdict(p_rep) == dataclasses.asdict(r_rep)
    tel = pc.telemetry()
    assert tel["cross_reduce_trees"] == 1 and tel["reduce_rollbacks"] == 0
    _same_cluster(rc, pc)


def test_cross_stack_reduce_rollback_is_byte_identical(R):
    """The destination's LOCAL port saturated, the tree's local fan-in
    cannot commit: the whole tree rolls back, every table as before."""
    rc, pc = _clusters(R, 2, "fused")
    n_nodes = pc.topology.stacks[0].n_nodes
    fill = [dict(src=(s + 3) % n_nodes, dst=2, nbytes=8 * N_SLOTS * 256,
                 src_stack=0, dst_stack=0) for s in range(N_SLOTS + 8)]
    rc.schedule(_requests(R, fill), cycle=0)
    pc.schedule(_requests(P, fill), cycle=0)
    saved, link_windows = pc._tree_snapshot()
    before = [exp.copy() for _pe, exp in saved]
    req = [("reduce", [(1, 5), (1, 9), (0, 6)], (0, 2), 256)]
    (r_res,), _ = rc.schedule(_requests(R, req), cycle=0)
    (p_res,), _ = pc.schedule(_requests(P, req), cycle=0)
    assert p_res.circuit is None and r_res.circuit is None
    assert pc.telemetry()["reduce_rollbacks"] == 1
    after, after_links = pc._tree_snapshot()
    for (pe, _), exp in zip(after, before):
        np.testing.assert_array_equal(pe.expiry, exp)
    assert after_links == link_windows
    _same_cluster(rc, pc)


def test_same_stack_reduce_localizes_to_the_stack_fabric(R):
    rc, pc = _clusters(R, 2, "host")
    req = [("reduce", [(1, 5), (1, 9)], (1, 2), 128)]
    (r_res,), r_rep = rc.schedule(_requests(R, req))
    (p_res,), p_rep = pc.schedule(_requests(P, req))
    c = p_res.circuit
    assert not isinstance(c, P.ReduceTree) and c.srcs == (5, 9)
    assert p_rep.n_reduce == 1 and p_rep.n_cross_stack == 0
    assert _rkey(p_res) == _rkey(r_res)
    assert dataclasses.asdict(p_rep) == dataclasses.asdict(r_rep)


# --- the bank-level planners --------------------------------------------------------
def test_nom_reduce_matches_reference(R):
    rf = R.NomFabric(mesh=R.make_topology(1, mesh=(4, 4, 2)))
    pf = P.NomFabric(mesh=P.make_topology(1, mesh=(4, 4, 2)), device="cpu")
    r_res, r_rep = R.nom_reduce(rf, srcs=[1, 2, 3], dst=0, nbytes=256)
    p_res, p_rep = P.nom_reduce(pf, srcs=[1, 2, 3], dst=0, nbytes=256)
    assert p_rep.n_reduce == 1 and p_res.circuit.srcs == (1, 2, 3)
    assert _rkey(p_res) == _rkey(r_res)
    assert dataclasses.asdict(p_rep) == dataclasses.asdict(r_rep)
    assert pf.telemetry() == rf.telemetry()


@pytest.mark.parametrize("banks", [[0, 5, 10, 15], [3, 17, 30]])
def test_nom_allreduce_banks_matches_reference(R, banks):
    rf = R.NomFabric(mesh=R.make_topology(1, mesh=(4, 4, 2)))
    pf = P.NomFabric(mesh=P.make_topology(1, mesh=(4, 4, 2)), device="cpu")
    r_res, r_rep = R.nom_allreduce_banks(rf, banks, nbytes=4096)
    p_res, p_rep = P.nom_allreduce_banks(pf, banks, nbytes=4096)
    n = len(banks)
    assert len(p_res) == n + n * (n - 1) and p_rep.n_reduce == n
    assert [_rkey(r) for r in p_res] == [_rkey(r) for r in r_res]
    assert dataclasses.asdict(p_rep) == dataclasses.asdict(r_rep)
    assert pf.telemetry() == rf.telemetry()
    for bad in ([1, 1, 2], [1]):
        with pytest.raises(ValueError) as want:
            R.nom_allreduce_banks(rf, bad, nbytes=64)
        with pytest.raises(ValueError) as got:
            P.nom_allreduce_banks(pf, bad, nbytes=64)
        assert str(got.value) == str(want.value)


def test_nom_allreduce_banks_across_stacks_matches_reference(R):
    """Banks in both stacks of a cluster: the scatter fan-ins become
    cross-stack reduce trees, the gather copies segmented circuits."""
    rc, pc = _clusters(R, 2, "fused")
    banks = [pc.topology.global_id(s, v) for s, v in
             ((0, 0), (0, 5), (1, 0), (1, 10))]
    r_res, r_rep = R.nom_allreduce_banks(rc, banks, nbytes=2048)
    p_res, p_rep = P.nom_allreduce_banks(pc, banks, nbytes=2048)
    assert [_rkey(r) for r in p_res] == [_rkey(r) for r in r_res]
    assert dataclasses.asdict(p_rep) == dataclasses.asdict(r_rep)
    assert pc.telemetry()["cross_reduce_trees"] > 0
    _same_cluster(rc, pc)


# --- on the card -------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fused", "host", "auto", "light"])
def test_cluster_on_the_card_matches_the_cpu(kind):
    """A 3-stack paper-mesh cluster through the CUDA kernels (rounds of
    more than 8 requests per stack) against the same cluster on the CPU:
    every result, report, telemetry value and slot table equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    topo = P.make_topology(3, P.PAPER_MESH)
    reqs = _requests(P, _stream(topo, 600, seed=11))

    def run(device):
        if kind == "light":
            cl = P.FabricCluster(topo, allocators=[
                P.TdmAllocatorLight(m, N_SLOTS, device=device)
                for m in topo.stacks])
        else:
            cl = P.FabricCluster(topo, n_slots=N_SLOTS, alloc_backend=kind,
                                 device=device)
        out = [cl.schedule(reqs[k::3], cycle=k * 512) for k in range(3)]
        return cl, out
    cc, c_out = run("cuda")
    pc, p_out = run("cpu")
    for (c_res, c_rep), (p_res, p_rep) in zip(c_out, p_out):
        assert [_rkey(r) for r in c_res] == [_rkey(r) for r in p_res]
        assert dataclasses.asdict(c_rep) == dataclasses.asdict(p_rep)
    assert cc.telemetry() == pc.telemetry()
    for a, b in zip(_state(cc), _state(pc)):
        np.testing.assert_array_equal(a, b)
