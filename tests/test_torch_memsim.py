"""repro_torch.memsim against repro.memsim, on the CPU (the CCU's kernels
on their plain versions): the seeded workloads request by request, every
(workload, config) of tests/test_memsim_claims.py with the paper's bands
held on the port's results, the simulator's knobs, saturation, INIT and
reduce accounting, and multi-stack runs.  Both sides are the same host
arithmetic, so every integer and float must be equal: tolerance 0."""
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest

import repro.core as RC
import repro.memsim as R
import repro.memsim.simulator as RS
import repro_torch.core as PC
import repro_torch.memsim as P
import repro_torch.memsim.simulator as PS

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIG4 = ("fork", "fileCopy20", "fileCopy40", "fileCopy60")


def _claims():
    """tests/test_memsim_claims.py, whose band assertions run here on the
    port's results."""
    spec = importlib.util.spec_from_file_location(
        "memsim_claims", ROOT / "tests" / "test_memsim_claims.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_mod",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reqs(name, **kw):
    return (R.generate(R.WorkloadSpec(name, **kw)),
            P.generate(P.WorkloadSpec(name, **kw)))


def _asdicts(reqs):
    out = []
    for r in reqs:
        d = dataclasses.asdict(r)
        d["op"] = r.op.name
        out.append(d)
    return out


def _same(r_res, p_res):
    assert dataclasses.asdict(p_res) == dataclasses.asdict(r_res)
    assert P.energy_pj(p_res) == R.energy_pj(r_res)


def _both(reqs, name="", **params):
    rr, pr = reqs
    return (R.simulate(rr, R.SimParams(**params), name=name),
            P.simulate(pr, P.SimParams(**params), name=name, device="cpu"))


def _same_run_or_error(reqs, name="", **params):
    """Equal results, or, where the reference raises (NoM-Light cannot
    route cross-layer fan-ins), the same error from the port.  Returns
    the port's result, or None when both raised."""
    try:
        want = R.simulate(reqs[0], R.SimParams(**params), name=name)
    except ValueError as exc:
        with pytest.raises(type(exc)) as got:
            P.simulate(reqs[1], P.SimParams(**params), name=name,
                       device="cpu")
        assert str(got.value) == str(exc)
        assert "same-layer sources" in str(exc)
        return None
    got = P.simulate(reqs[1], P.SimParams(**params), name=name, device="cpu")
    _same(want, got)
    return got


# --- workloads ----------------------------------------------------------------
@pytest.mark.parametrize("n_banks", [256, 1024])
@pytest.mark.parametrize("n_requests", [900, 1200])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(R.WORKLOADS))
def test_generate_matches_reference(name, seed, n_requests, n_banks):
    rr, pr = _reqs(name, n_requests=n_requests, seed=seed, n_banks=n_banks)
    assert _asdicts(pr) == _asdicts(rr)
    assert P.traffic_breakdown(pr) == R.traffic_breakdown(rr)


def test_workload_vocabulary_matches_reference():
    assert [(o.name, o.value) for o in P.Op] == \
        [(o.name, o.value) for o in R.Op]
    assert {k: dataclasses.astuple(v) for k, v in P.WORKLOADS.items()} == \
        {k: dataclasses.astuple(v) for k, v in R.WORKLOADS.items()}
    assert dataclasses.asdict(P.WorkloadSpec("fork")) == \
        dataclasses.asdict(R.WorkloadSpec("fork"))
    assert dataclasses.asdict(P.Timing()) == dataclasses.asdict(R.Timing())
    assert dataclasses.asdict(P.EnergyParams()) == \
        dataclasses.asdict(R.EnergyParams())
    assert P.CONFIGS == R.CONFIGS and P.__all__ == R.__all__
    with pytest.raises(AssertionError):
        P.TrafficMix(0.5, 0.5, 0.5, 0.5)


def test_sim_params_match_reference_fields_and_defaults():
    """The same SimParams mean the same run: the port adds ``device`` as
    a keyword of simulate/MemorySystem, not as a field."""
    rp, pp = R.SimParams(), P.SimParams()
    assert [f.name for f in dataclasses.fields(pp)] == \
        [f.name for f in dataclasses.fields(rp)]
    for f in dataclasses.fields(rp):
        a, b = getattr(rp, f.name), getattr(pp, f.name)
        if f.name == "mesh":
            assert (a.X, a.Y, a.Z, a.vault_span_y) == \
                (b.X, b.Y, b.Z, b.vault_span_y)
        elif f.name == "timing":
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        else:
            assert a == b, f.name
    assert [f.name for f in dataclasses.fields(P.SimResult)] == \
        [f.name for f in dataclasses.fields(R.SimResult)]


# --- the Fig. 4 runs ----------------------------------------------------------
@pytest.fixture(scope="module")
def fig4():
    """Every (workload, config) of tests/test_memsim_claims.py at its
    settings, in both packages."""
    out = {}
    for wl in FIG4:
        reqs = _reqs(wl, n_requests=900, seed=1)
        out[wl] = {cfg: _both(reqs, wl, config=cfg) for cfg in R.CONFIGS}
    return out


@pytest.mark.parametrize("cfg", R.CONFIGS)
@pytest.mark.parametrize("wl", FIG4)
def test_fig4_run_matches_reference(fig4, wl, cfg):
    _same(*fig4[wl][cfg])


@pytest.mark.parametrize("claim", [
    "test_ordering_nom_beats_rowclone_beats_conventional",
    "test_speedup_vs_conventional_in_band",
    "test_speedup_vs_rowclone_in_band",
    "test_nom_light_gap_in_band"])
def test_paper_bands_hold_on_the_port(fig4, claim):
    port = {wl: {cfg: pair[1] for cfg, pair in r.items()}
            for wl, r in fig4.items()}
    getattr(_claims(), claim)(port)


def test_chip_smoke_restates_the_bands(fig4):
    """chip_smoke.py holds the card's results to the same bands: its
    bounds are the claims file's, they pass on the port's results, and
    they catch results out of band."""
    cs = _smoke()
    src = (ROOT / "tests" / "test_memsim_claims.py").read_text()
    lo, hi = cs.FIG4_VS_CONVENTIONAL
    assert f"assert {lo} < _gm(ratios) < {hi}, ratios" in src
    lo, hi = cs.FIG4_VS_ROWCLONE
    assert f"assert {lo} < _gm(ratios) < {hi}, ratios" in src
    lo, hi = cs.FIG4_LIGHT_GAP
    assert f"assert {lo} <= gap <= {hi}, (wl, gap)" in src
    assert cs.FIG4_WORKLOADS == FIG4
    assert (cs.FIG4_REQUESTS, cs.FIG4_SEED) == (900, 1)
    port = {wl: {cfg: pair[1] for cfg, pair in r.items()}
            for wl, r in fig4.items()}
    assert cs.fig4_bands(port) == []
    slow = {wl: dict(r, nom=dataclasses.replace(r["nom"],
                                                ipc=r["rowclone"].ipc))
            for wl, r in port.items()}
    assert len(cs.fig4_bands(slow)) >= len(FIG4)


# --- the knobs ----------------------------------------------------------------
@pytest.fixture(scope="module")
def knob_reqs():
    return _reqs("fileCopy60", n_requests=600, seed=1)


@pytest.mark.parametrize("cfg", ["nom", "nom_light"])
@pytest.mark.parametrize("knob,value", [
    ("nom_link_ratio", 1.0), ("nom_link_ratio", 0.5),
    ("nom_link_ratio", 0.25),
    ("nom_extra_slots", 0), ("nom_extra_slots", 3), ("nom_extra_slots", 7),
    ("nom_ccu_queue_depth", 1), ("nom_ccu_queue_depth", 8),
    ("nom_ccu_queue_depth", 64),
    ("nom_max_inflight", 2), ("nom_max_inflight", 6)])
def test_knob_matches_reference(knob_reqs, cfg, knob, value):
    _same(*_both(knob_reqs, "fileCopy60", config=cfg, **{knob: value}))


def test_window_64_pruning_matches_reference():
    """tests/test_commit_pipeline.py's pruning check on the port, and the
    pruned run equal to the reference's."""
    reqs = _reqs("fileCopy60", n_requests=600, seed=3)
    r_res, pruned = _both(reqs, config="nom", window=64)
    _same(r_res, pruned)
    keep = PS.MemorySystem._prune_inflight
    try:
        PS.MemorySystem._prune_inflight = lambda self, horizon: None
        full = P.simulate(reqs[1], P.SimParams(config="nom", window=64),
                          device="cpu")
    finally:
        PS.MemorySystem._prune_inflight = keep
    assert pruned.extra["nom_inflight_avg"] == full.extra["nom_inflight_avg"]
    assert pruned.extra["nom_inflight_max"] == full.extra["nom_inflight_max"]
    assert pruned.ipc == full.ipc


def test_window_inflight_map_stays_bounded_like_reference():
    def run(mod, sim, **kw):
        sys_ = sim.MemorySystem(mod.SimParams(config="nom"), **kw)
        at = 0
        for i in range(200):
            r = mod.Request(op=mod.Op.COPY, src_bank=(2 * i) % 250,
                            src_row=0, dst_bank=(2 * i) % 250 + 1,
                            dst_row=1, nbytes=4096)
            sys_.copy_nom_batch([(at, r)])
            at += 600
        return sys_.inflight_stats(), len(sys_.window_inflight)
    want = run(R, RS)
    got = run(P, PS, device="cpu")
    assert got == want and got[1] < 200


def test_saturation_raises_fabric_overflow_like_reference():
    def saturate(mod, sim, **kw):
        r = mod.Request(op=mod.Op.COPY, src_bank=0, src_row=0, dst_bank=1,
                        dst_row=1, nbytes=1 << 16)
        sys_ = sim.MemorySystem(mod.SimParams(config="nom"), **kw)
        with pytest.raises(Exception) as exc:
            sys_.copy_nom_batch([(i, r) for i in range(17)])
        return exc.value
    want = saturate(R, RS)
    got = saturate(P, PS, device="cpu")
    assert isinstance(want, RC.FabricOverflow)
    assert isinstance(got, PC.FabricOverflow)
    assert str(got) == str(want) and "saturated" in str(got)
    assert got.retries == want.retries == 64
    assert got.request.nbytes == want.request.nbytes == 1 << 16
    assert got.telemetry == want.telemetry
    assert got.telemetry["table_utilization"] > 0


# --- INIT rows and energy (tests/test_fabric.py) ------------------------------
def test_init_row_bytes_calibrated_like_reference():
    rp = R.SimParams(config="nom", mesh=RC.Mesh3D(4, 4, 2))
    pp = P.SimParams(config="nom", mesh=PC.Mesh3D(4, 4, 2))
    rs, ps = RS.MemorySystem(rp), PS.MemorySystem(pp, device="cpu")
    assert ps.init_windows_per_row == rs.init_windows_per_row > 1
    assert ps.alloc.init_row_bytes == rs.alloc.init_row_bytes
    assert ps.ccu is ps.fabric.queue
    assert isinstance(ps.ccu, PC.AdmissionQueue)
    nbytes = rp.timing.row_bytes
    (rres,), _ = rs.fabric.schedule(
        [RC.TransferRequest(src=20, dst=20, nbytes=nbytes, op="init")],
        cycle=0)
    (pres,), _ = ps.fabric.schedule(
        [PC.TransferRequest(src=20, dst=20, nbytes=nbytes, op="init")],
        cycle=0)
    assert dataclasses.asdict(pres.circuit) == \
        dataclasses.asdict(rres.circuit)
    assert pres.circuit.n_windows == ps.init_windows_per_row


@pytest.mark.parametrize("cfg", R.CONFIGS)
def test_init_rows_and_energy_match_reference(cfg):
    r_res, p_res = _both(_reqs("fork", n_requests=400, seed=3), config=cfg)
    _same(r_res, p_res)
    e = P.energy_pj(p_res)
    if cfg == "conventional":
        assert "init_rows" not in p_res.extra and e["dram_init"] == 0
    else:
        assert p_res.extra["init_rows"] > 0
        assert e["dram_init"] == \
            p_res.extra["init_rows"] * P.EnergyParams().e_init_row
    assert P.init_energy_per_row() == R.init_energy_per_row()


# --- reduce runs (tests/test_reduce.py) ---------------------------------------
def _reduce_pairs(far: bool):
    out = []
    for mod in (R, P):
        out.append([mod.Request(mod.Op.REDUCE, 3, 0, 40, 1, nbytes=4096,
                                src_banks=(3, 17, 25, 33)),
                    mod.Request(mod.Op.REDUCE, 5, 2, 90 if far else 40, 3,
                                nbytes=4096, src_banks=(5, 50, 66, 70))])
    return tuple(out)


@pytest.mark.parametrize("cfg", ["conventional", "rowclone", "nom"])
@pytest.mark.parametrize("far", [False, True])
def test_reduce_fanins_match_reference(cfg, far):
    r_res, p_res = _both(_reduce_pairs(far), config=cfg)
    _same(r_res, p_res)
    if cfg == "nom":
        assert p_res.extra["nom_reduce_elems"] == 6 * (4096 // 8)
        assert (p_res.extra["nom_reduce_stalls"] == 0) == far


@pytest.mark.parametrize("cfg", R.CONFIGS)
def test_gradagg_matches_reference(cfg):
    reqs = _reqs("gradAgg40", n_requests=1200)
    assert P.traffic_breakdown(reqs[1]) == R.traffic_breakdown(reqs[0])
    got = _same_run_or_error(reqs, "gradAgg40", config=cfg)
    assert (got is None) == (cfg == "nom_light")


# --- multi-stack runs ---------------------------------------------------------
@pytest.mark.parametrize("wl", ["fileCopy60", "gradAgg40"])
@pytest.mark.parametrize("cfg", ["nom", "nom_light"])
@pytest.mark.parametrize("link", ["ring", "full"])
@pytest.mark.parametrize("stacks", [2, 4])
def test_stacked_run_matches_reference(stacks, link, cfg, wl):
    """stacks x stack_link on both NoM configs; where the reference
    raises (NoM-Light cannot route cross-layer fan-ins) the port raises
    the same error."""
    reqs = _reqs(wl, n_requests=600, seed=1, n_banks=256 * stacks)
    got = _same_run_or_error(reqs, wl, config=cfg, stacks=stacks,
                             stack_link=link)
    if got is None:
        assert (wl, cfg) == ("gradAgg40", "nom_light")
        return
    assert got.extra["n_stacks"] == stacks
    assert got.extra["nom_cross_stack"] > 0


@pytest.mark.parametrize("cfg", ["conventional", "rowclone"])
def test_stacked_baselines_match_reference(cfg):
    reqs = _reqs("fileCopy40", n_requests=600, seed=2, n_banks=512)
    _same(*_both(reqs, config=cfg, stacks=2))


def test_stacked_serdes_knobs_match_reference():
    reqs = _reqs("fileCopy60", n_requests=600, seed=4, n_banks=768)
    r_res, p_res = _both(reqs, config="nom", stacks=3, serdes_latency=3,
                         serdes_link_bytes=8)
    _same(r_res, p_res)
    assert p_res.extra["serdes_bytes"] > 0


def test_memory_system_runs_on_the_requested_device():
    sys_ = PS.MemorySystem(P.SimParams(config="nom"), device="cpu")
    assert sys_.device.type == "cpu"
    assert sys_.alloc.device.type == "cpu"
    st = PS.MemorySystem(P.SimParams(config="nom_light", stacks=2),
                         device="cpu")
    assert all(f.allocator.device.type == "cpu" for f in st.fabric.fabrics)
    assert isinstance(st.fabric, PC.FabricCluster)
    assert np.array_equal(st.alloc.table.expiry,
                          st.fabric.fabrics[0].allocator.table.expiry)
