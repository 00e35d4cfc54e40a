"""repro_torch's NomFabric against repro's on the scenarios of
tests/test_fabric.py: policies, admission (shed / block / raise), the
pickup pipeline, auto-tuning and ``telemetry()`` — on the fused and the
host allocator backends (CPU, the kernels' plain versions) and the
rounds backend, every result, report and telemetry value equal."""
import dataclasses

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as P
import repro_torch.core.fabric as PF

BACKENDS = ["fused", "host"]


def _meshes(dims=(4, 4, 2)):
    return R.Mesh3D(*dims), P.Mesh3D(*dims)


def _bank_reqs(mod, n=6, nbytes=256):
    return [mod.TransferRequest(src=i, dst=16 + (i * 3) % 16, nbytes=nbytes,
                                tag=f"r{i}") for i in range(n)]


def _fabrics(alloc_backend="auto", dims=(4, 4, 2), **kw):
    rm, pm = _meshes(dims)
    return (R.NomFabric(mesh=rm, alloc_backend=alloc_backend, **kw),
            P.NomFabric(mesh=pm, alloc_backend=alloc_backend, device="cpu",
                        **kw))


def _key(res):
    c = res.circuit
    return None if c is None else (c.src, c.dst, c.start_cycle, c.n_windows,
                                   tuple(c.hops), c.slots_per_window,
                                   c.distance, c.srcs)


def _same_out(r_out, p_out):
    if r_out is None or p_out is None:
        assert r_out is None and p_out is None
        return
    (rres, rrep), (pres, prep) = r_out, p_out
    assert [_key(r) for r in rres] == [_key(p) for p in pres]
    assert dataclasses.asdict(rrep) == dataclasses.asdict(prep)


def _same_session(rf, pf):
    assert rf.telemetry() == pf.telemetry()
    assert [dataclasses.asdict(r) for r in rf.history] == \
        [dataclasses.asdict(p) for p in pf.history]
    assert (rf.clock, rf.last_cycle, rf.queue.busy_until) == \
        (pf.clock, pf.last_cycle, pf.queue.busy_until)
    if rf.backend == "tdm":
        np.testing.assert_array_equal(rf.allocator.table.expiry,
                                      pf.allocator.table.expiry)


# --- policy registry -----------------------------------------------------------
def test_unknown_policy_raises_with_registry_listing():
    with pytest.raises(ValueError, match="arrival"):
        PF.get_policy("roulette")
    with pytest.raises(ValueError, match="unknown policy"):
        P.NomFabric(shape=(4,), policy="roulette")
    fab = P.NomFabric(shape=(4,))
    with pytest.raises(ValueError, match="unknown policy"):
        fab.schedule([P.TransferRequest((0,), (1,))], policy="roulette")
    assert PF.registered_policies()[:2] == ("arrival", "longest_first")


def test_custom_policy_roundtrip():
    @PF.register_policy("widest_first")
    def widest_first(reqs, ctx):
        return sorted(range(len(reqs)), key=lambda i: -reqs[i].nbytes)

    try:
        assert "widest_first" in PF.registered_policies()
        with pytest.raises(ValueError, match="already registered"):
            PF.register_policy("widest_first")(widest_first)
        _rm, pm = _meshes()
        fab = P.NomFabric(mesh=pm, policy="widest_first", device="cpu")
        res, rep = fab.schedule(_bank_reqs(P, 6))
        assert rep.n_scheduled == 6 and len(res) == 6
    finally:
        PF.unregister_policy("widest_first")
    assert "widest_first" not in PF.registered_policies()
    with pytest.raises(ValueError, match="not registered"):
        PF.unregister_policy("widest_first")
    with pytest.raises(ValueError, match="built-in"):
        PF.unregister_policy("arrival")


def test_policy_must_return_permutation():
    @PF.register_policy("broken")
    def broken(reqs, ctx):
        return [0] * len(reqs)

    try:
        with pytest.raises(ValueError, match="permutation"):
            P.NomFabric(shape=(4,), policy="broken").schedule(
                [P.TransferRequest((0,), (1,)), P.TransferRequest((1,), (2,))])
    finally:
        PF.unregister_policy("broken")


def test_exactly_one_backend():
    _rm, pm = _meshes()
    with pytest.raises(ValueError, match="exactly one"):
        P.NomFabric(device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        P.NomFabric(mesh=pm, shape=(4,), device="cpu")


# --- bank level: sessions equal to the reference --------------------------------
@pytest.mark.parametrize("alloc_backend", BACKENDS)
def test_schedule_sequence_matches_reference(alloc_backend):
    """Back-to-back batches with inits, reduces, explicit and default
    anchors, and a policy override: results, reports, telemetry."""
    rf, pf = _fabrics(alloc_backend, dims=(8, 8, 4), n_slots=16)
    rng = np.random.default_rng(1)
    for k in range(4):
        batch = []
        for _ in range(40):
            s, d = (int(v) for v in rng.integers(256, size=2))
            if s == d:
                batch.append(("init", s))
            else:
                batch.append(("copy", s, d, int(2 ** rng.uniform(9, 14)),
                              int(rng.integers(0, 3))))
        batch.append(("reduce", (3, 77, 140), 9))

        def build(mod):
            out = []
            for b in batch:
                if b[0] == "init":
                    out.append(mod.TransferRequest(src=b[1], dst=b[1],
                                                   nbytes=8192, op="init"))
                elif b[0] == "copy":
                    out.append(mod.TransferRequest(src=b[1], dst=b[2],
                                                   nbytes=b[3],
                                                   max_extra_slots=b[4]))
                else:
                    out.append(mod.reduce_request(b[1], b[2], nbytes=512))
            return out
        cycle = None if k % 2 else 64 * k
        policy = "longest_first" if k == 3 else None
        _same_out(rf.schedule(build(R), cycle=cycle, policy=policy),
                  pf.schedule(build(P), cycle=cycle, policy=policy))
    _same_session(rf, pf)
    tel = pf.telemetry()
    assert tel["reduce_requests"] == 4 and tel["init_requests"] > 0
    if alloc_backend == "fused":
        assert tel["fused_waves"] > 0
    else:
        assert tel["fused_waves"] == 0 and tel["host_waves"] > 0


@pytest.mark.parametrize("alloc_backend", BACKENDS)
def test_overflow_shed_matches_reference(alloc_backend):
    rf, pf = _fabrics(alloc_backend, queue_depth=2, overflow="shed")
    assert [rf.submit(r) for r in _bank_reqs(R, 5)] == \
        [pf.submit(r) for r in _bank_reqs(P, 5)] == \
        [True, True, False, False, False]
    assert pf.telemetry()["shed"] == 3 and pf.pending == 2
    _same_out(rf.flush(), pf.flush())
    assert pf.flush() is None
    _same_session(rf, pf)


@pytest.mark.parametrize("alloc_backend", BACKENDS)
def test_overflow_block_matches_reference(alloc_backend):
    rf, pf = _fabrics(alloc_backend, queue_depth=2, overflow="block")
    for r, p in zip(_bank_reqs(R, 12, nbytes=64), _bank_reqs(P, 12,
                                                            nbytes=64)):
        assert rf.submit(r) and pf.submit(p)
    tel = pf.telemetry()
    assert tel["full_stalls"] == 5 and tel["flushes"] == 5
    assert 0 < tel["queue_stall_cycles"] <= tel["full_stalls"] * 4
    _same_session(rf, pf)


def test_overflow_raise():
    _rm, pm = _meshes()
    fab = P.NomFabric(mesh=pm, queue_depth=1, overflow="raise", device="cpu")
    assert fab.submit(_bank_reqs(P, 1)[0])
    with pytest.raises(PF.FabricOverflow):
        fab.submit(_bank_reqs(P, 2)[1])
    with pytest.raises(ValueError, match="overflow"):
        PF.AdmissionQueue(depth=2, overflow="explode")


def test_flush_models_pickup_pipeline():
    rf, pf = _fabrics(queue_depth=8)
    for r, p in zip(_bank_reqs(R, 4), _bank_reqs(P, 4)):
        rf.submit(r, at=10)
        pf.submit(p, at=10)
    _same_out(rf.flush(), pf.flush())
    assert pf.queue.busy_until == 10 + 3 + 3
    assert pf.queue.wait_quantile(0.5) == rf.queue.wait_quantile(0.5)
    _same_session(rf, pf)


def test_auto_tuning_matches_reference():
    """policy="auto": probe/exploit policy choice, queue-depth growth on
    backpressure and shrink when calm, learned extra slots."""
    rf, pf = _fabrics(n_slots=16, policy="auto", queue_depth=2,
                      overflow="block")
    for _ in range(3):
        for r, p in zip(_bank_reqs(R, 12), _bank_reqs(P, 12)):
            rf.submit(r)
            pf.submit(p)
        _same_out(rf.flush(), pf.flush())
    grown = pf.effective_queue_depth
    assert grown > 2
    for _ in range(12):
        rf.submit(_bank_reqs(R, 1)[0])
        pf.submit(_bank_reqs(P, 1)[0])
        _same_out(rf.flush(), pf.flush())
    assert pf.effective_queue_depth < grown
    _same_session(rf, pf)


def test_request_validation_matches_reference():
    _rm, pm = _meshes()
    fab = P.NomFabric(mesh=pm, device="cpu")
    with pytest.raises(ValueError, match="src == dst"):
        fab.schedule([P.TransferRequest(src=0, dst=1, op="init")])
    with pytest.raises(ValueError, match="distinct"):
        P.reduce_request([1, 1], 5)
    with pytest.raises(ValueError, match="already a source"):
        P.reduce_request([1, 5], 5)
    with pytest.raises(ValueError, match="bank-level"):
        P.NomFabric(shape=(4,)).schedule([P.reduce_request([0, 1], 2)])


# --- device level (rounds backend) ----------------------------------------------
def _moe_mix(mod):
    rng = np.random.default_rng(7)
    ep, reqs = 8, []
    for r in range(ep):
        for q in range(ep):
            if r == q:
                continue
            nbytes = int(rng.integers(1, 9)) * (3 if q < 2 else 1) * 512
            reqs.append(mod.TransferRequest((r,), (q,), nbytes))
            reqs.append(mod.TransferRequest((q,), (r,), nbytes))
    return (ep,), True, reqs


def _serving_mix(mod):
    return (8, 4), False, [
        mod.TransferRequest((0, i % 4), ((1 + (i * 3) % 7), i % 4),
                            nbytes=(i % 3 + 1) * 2048) for i in range(24)]


@pytest.mark.parametrize("mix", [_moe_mix, _serving_mix])
def test_rounds_auto_session_matches_reference(mix):
    shape, torus, rreqs = mix(R)
    _s, _t, preqs = mix(P)
    rf = R.NomFabric(shape=shape, torus=torus, policy="auto")
    pf = P.NomFabric(shape=shape, torus=torus, policy="auto")
    for _ in range(6):
        (rplan, rrep), (pplan, prep) = rf.schedule(rreqs), pf.schedule(preqs)
        assert rplan.starts == pplan.starts
        assert rplan.paths == pplan.paths
        assert dataclasses.asdict(rrep) == dataclasses.asdict(prep)
    assert rf.telemetry() == pf.telemetry()


def test_plan_transfers_matches_reference():
    rng = np.random.default_rng(3)
    pairs = [((int(rng.integers(4)), int(rng.integers(4))),
              (int(rng.integers(4)), int(rng.integers(4)))) for _ in range(30)]
    for policy in ("longest_first", "arrival"):
        rp = R.plan_transfers((4, 4), [R.Transfer(s, d, 64) for s, d in pairs],
                              policy=policy)
        pp = P.plan_transfers((4, 4), [P.Transfer(s, d, 64) for s, d in pairs],
                              policy=policy)
        assert rp.starts == pp.starts and rp.n_rounds == pp.n_rounds
        assert rp.rounds() == pp.rounds()
        assert rp.concurrency() == pp.concurrency()
        assert rp.link_utilization() == pp.link_utilization()
    plan, _rep = P.NomFabric(shape=(4, 4), policy="longest_first").schedule(
        [P.Transfer(s, d, 64) for s, d in pairs])
    assert plan.starts == P.plan_transfers(
        (4, 4), [P.Transfer(s, d, 64) for s, d in pairs]).starts
