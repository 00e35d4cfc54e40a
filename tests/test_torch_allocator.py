"""repro_torch's TdmAllocator / TdmAllocatorLight against repro's, on the
CPU (the kernels' plain versions): every AllocResult, Circuit and
BatchReport and the final slot tables equal bit for bit, on every
prepare backend; plus the state converter and the incremental masks.
"""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core.slot_alloc as R
import repro.core.topology as RT
import repro_torch.core.slot_alloc as P
import repro_torch.core.topology as PT

WIDE = ((8, 8, 4), 16)
TALL = ((4, 4, 2), 8)


def _meshes(dims):
    return RT.Mesh3D(*dims, vault_span_y=1), PT.Mesh3D(*dims, vault_span_y=1)


def _stream(rng, mesh, n, *, contended=False, light=False, mix=True):
    """Seeded request dicts: copies (extra-slot bundles, per-request
    cycle anchors), in-place inits and fan-in reduces."""
    out = []
    for _ in range(n):
        if contended:
            s = mesh.node_id(0, int(rng.integers(mesh.Y)), 0)
            d = mesh.node_id(mesh.X - 1, int(rng.integers(mesh.Y)),
                             int(rng.integers(mesh.Z)))
        else:
            s, d = (int(v) for v in rng.integers(mesh.n_nodes, size=2))
        while s == d:
            d = int(rng.integers(mesh.n_nodes))
        u = rng.random() if mix else 1.0
        if u < 0.05:
            z = mesh.coords(d)[2]
            pool = [v for v in range(mesh.n_nodes) if v != d
                    and (not light or mesh.coords(v)[2] == z)]
            srcs = tuple(int(v) for v in rng.choice(pool, size=3,
                                                    replace=False))
            out.append(dict(src=srcs[0], dst=d, nbytes=512, op="reduce",
                            srcs=srcs))
        elif u < 0.15:
            out.append(dict(src=s, dst=s, op="init",
                            nbytes=int(rng.integers(64, 20000))))
        else:
            out.append(dict(
                src=s, dst=d, nbytes=int(rng.integers(512, 65536)),
                max_extra_slots=(int(rng.integers(1, 4))
                                 if rng.random() < 0.2 else 0),
                cycle=(int(rng.integers(0, 40))
                       if rng.random() < 0.1 else None)))
    return out


def _key(c):
    if c is None:
        return None
    return (c.src, c.dst, c.start_cycle, c.n_windows, tuple(c.hops),
            c.slots_per_window, c.uses_bus, c.bus_column, c.distance, c.srcs,
            c.end_cycle)


def _assert_same(ra, pa, rres, pres):
    assert [(_key(r.circuit), r.searched_cycle) for r in rres] == \
        [(_key(p.circuit), p.searched_cycle) for p in pres]
    assert dataclasses.asdict(ra.last_report) == \
        dataclasses.asdict(pa.last_report)
    np.testing.assert_array_equal(ra.table.expiry, pa.table.expiry)
    np.testing.assert_array_equal(ra.table.bus_expiry, pa.table.bus_expiry)


def _run_both(light, backend, dims, n_slots, reqs, cycles):
    rmesh, pmesh = _meshes(dims)
    ra = (R.TdmAllocatorLight if light else R.TdmAllocator)(
        rmesh, n_slots, backend=backend)
    pa = (P.TdmAllocatorLight if light else P.TdmAllocator)(
        pmesh, n_slots, backend=backend, device="cpu")
    for cyc in cycles:
        rres = ra.allocate_batch([R.CopyRequest(**r) for r in reqs], cyc)
        pres = pa.allocate_batch([P.CopyRequest(**r) for r in reqs], cyc)
        _assert_same(ra, pa, rres, pres)
    return ra, pa


@pytest.mark.parametrize("backend", ["host", "fused", "auto"])
@pytest.mark.parametrize("light", [False, True], ids=["nom", "light"])
def test_stream_matches_reference(light, backend):
    rmesh, _ = _meshes(WIDE[0])
    reqs = _stream(np.random.default_rng(1), rmesh, 140, light=light)
    ra, _pa = _run_both(light, backend, *WIDE, reqs, cycles=(0, 40))
    rep = ra.last_report
    assert rep.conflicts > 0 and rep.n_committed > 0
    if backend == "fused" and not light:
        assert rep.fused_waves > 0 and rep.host_waves > 0
    if backend == "host":
        assert rep.fused_waves == 0


@pytest.mark.parametrize("backend", ["host", "fused", "auto"])
def test_contended_tall_mesh_matches_reference(backend):
    """Saturation: denials and stale-snapshot conflicts on a small mesh,
    over several search-wave sizes."""
    rmesh, _ = _meshes(TALL[0])
    reqs = _stream(np.random.default_rng(2), rmesh, 120, contended=True)
    rmesh, pmesh = _meshes(TALL[0])
    for wave in (5, 64):
        ra = R.TdmAllocator(rmesh, TALL[1], backend=backend)
        pa = P.TdmAllocator(pmesh, TALL[1], backend=backend, device="cpu")
        ra.search_wave = pa.search_wave = wave
        rres = ra.allocate_batch([R.CopyRequest(**r) for r in reqs], 0)
        pres = pa.allocate_batch([P.CopyRequest(**r) for r in reqs], 0)
        _assert_same(ra, pa, rres, pres)
        assert ra.last_report.n_denied > 0


@pytest.mark.parametrize("light", [False, True], ids=["nom", "light"])
def test_serial_allocate_matches_reference(light):
    rmesh, pmesh = _meshes(WIDE[0])
    ra = (R.TdmAllocatorLight if light else R.TdmAllocator)(rmesh, 16)
    pa = (P.TdmAllocatorLight if light else P.TdmAllocator)(pmesh, 16,
                                                            device="cpu")
    rng = np.random.default_rng(3)
    for i in range(40):
        s, d = (int(v) for v in rng.integers(rmesh.n_nodes, size=2))
        if s == d:
            continue
        extra = i % 4
        r = ra.allocate(s, d, 2048, cycle=i * 2, max_extra_slots=extra)
        p = pa.allocate(s, d, 2048, cycle=i * 2, max_extra_slots=extra)
        assert _key(r.circuit) == _key(p.circuit)
    np.testing.assert_array_equal(ra.table.expiry, pa.table.expiry)
    np.testing.assert_array_equal(ra.table.bus_expiry, pa.table.bus_expiry)


def test_use_kernels_routes_every_search_to_the_device_path(monkeypatch):
    """use_kernels keeps the reference's use_pallas meaning: even a
    one-request round runs the (plain, on the CPU) kernel path — same
    circuits as the default allocator."""
    from repro_torch.kernels.slot_alloc import slot_alloc as ks
    calls = []
    real = ks.wavefront_search_plain

    def spy(occ, srcs, *a, **kw):
        calls.append(int(srcs.shape[0]))
        return real(occ, srcs, *a, **kw)

    monkeypatch.setattr(ks, "wavefront_search_plain", spy)
    rmesh, pmesh = _meshes(WIDE[0])
    ref = R.TdmAllocator(rmesh, 16)
    pa = P.TdmAllocator(pmesh, 16, use_kernels=True, backend="host",
                        device="cpu")
    for s, d in ((0, 200), (5, 77), (0, 200)):
        assert _key(ref.allocate(s, d, 256, cycle=0).circuit) == \
            _key(pa.allocate(s, d, 256, cycle=0).circuit)
    assert calls == [1, 1, 1]
    np.testing.assert_array_equal(ref.table.expiry, pa.table.expiry)


def test_reduce_fanin_matches_reference_on_both_backends():
    rmesh, pmesh = _meshes(WIDE[0])
    rng = np.random.default_rng(4)
    reqs = []
    for _ in range(20):
        d = int(rng.integers(rmesh.n_nodes))
        pool = [v for v in range(rmesh.n_nodes) if v != d]
        srcs = tuple(int(v) for v in rng.choice(pool, size=int(
            rng.integers(2, 6)), replace=False))
        reqs.append(dict(src=srcs[0], dst=d, nbytes=1024, op="reduce",
                         srcs=srcs))
    for backend in ("host", "fused"):
        ra = R.TdmAllocator(rmesh, 16, backend=backend)
        pa = P.TdmAllocator(pmesh, 16, backend=backend, device="cpu")
        ra.reduce_dwell = pa.reduce_dwell = 2
        rres = ra.allocate_batch([R.CopyRequest(**r) for r in reqs], 0)
        pres = pa.allocate_batch([P.CopyRequest(**r) for r in reqs], 0)
        _assert_same(ra, pa, rres, pres)


def test_light_rejects_cross_layer_reduce():
    pa = P.TdmAllocatorLight(PT.PAPER_MESH, 16, device="cpu")
    with pytest.raises(ValueError, match="same-layer"):
        pa.allocate_batch([P.CopyRequest(0, 255, 64, op="reduce",
                                         srcs=(0, 1))], 0)


def test_t_ready_beyond_int32_guard_takes_the_host_pipeline():
    """Start cycles the int32 scoring cannot hold go to the host pipeline
    on every backend — the reference's split, so the wave counters
    agree."""
    rmesh, _ = _meshes(WIDE[0])
    reqs = _stream(np.random.default_rng(5), rmesh, 70, mix=False)
    ra, _pa = _run_both(False, "fused", *WIDE, reqs, cycles=(2 ** 31 - 20,))
    assert ra.last_report.fused_waves == 0 and ra.last_report.host_waves > 0


def test_state_converter_starts_both_packages_from_one_mesh():
    rmesh, pmesh = _meshes(WIDE[0])
    rng = np.random.default_rng(6)
    ra = R.TdmAllocatorLight(rmesh, 16)
    ra.allocate_batch([R.CopyRequest(**r)
                       for r in _stream(rng, rmesh, 80, light=True)], 0)
    window = 2
    pa = P.TdmAllocatorLight(pmesh, 16, device="cpu")
    pa.table = P.SlotTable.from_expiry(pmesh, ra.table.expiry,
                                       ra.table.bus_expiry, window=window,
                                       device="cpu")
    np.testing.assert_array_equal(pa.table.busy_masks(window),
                                  ra.table.busy_masks(window))
    np.testing.assert_array_equal(pa.table.bus_busy_masks(window),
                                  ra.table.bus_busy_masks(window))
    np.testing.assert_array_equal(
        pa.table.device_busy_masks(window).numpy().astype(np.uint32),
        ra.table.busy_masks(window))
    more = _stream(rng, rmesh, 80, light=True)
    rres = ra.allocate_batch([R.CopyRequest(**r) for r in more], 40)
    pres = pa.allocate_batch([P.CopyRequest(**r) for r in more], 40)
    _assert_same(ra, pa, rres, pres)
    with pytest.raises(ValueError, match="shape"):
        P.SlotTable.from_expiry(pmesh, ra.table.expiry[:5],
                                ra.table.bus_expiry, device="cpu")


def _reference_masks(expiry, window, n_slots):
    weights = np.uint32(1) << np.arange(n_slots, dtype=np.uint32)
    return ((expiry > window) * weights).sum(axis=-1).astype(np.uint32)


@settings(max_examples=15, deadline=None, database=None)
@given(st.integers(0, 2 ** 31))
def test_incremental_masks_match_recompute_property(seed):
    """Random reserve / bus-reserve / window moves (backward jumps
    included): the incremental masks and the version-keyed device copy
    always equal a from-scratch recompute — a stale device copy would
    hand the kernels wrong occupancy silently."""
    rng = np.random.default_rng(seed)
    mesh = PT.Mesh3D(4, 4, 2)
    table = P.SlotTable(mesh, 8, device="cpu")
    window = 0
    for _ in range(50):
        roll = rng.random()
        if roll < 0.45:
            free = np.argwhere(table.expiry <= window)
            if len(free):
                pick = free[rng.integers(len(free))]
                table.reserve(P.Circuit(src=int(pick[0]), dst=int(pick[0]),
                                        start_cycle=0,
                                        n_windows=int(rng.integers(1, 6)),
                                        hops=[tuple(int(v) for v in pick)]),
                              window)
        elif roll < 0.6:
            free = np.argwhere(table.bus_expiry <= window)
            if len(free):
                col, slot = (int(v) for v in free[rng.integers(len(free))])
                table.reserve_bus(col, slot, window, int(rng.integers(1, 6)))
        elif roll < 0.9:
            window += int(rng.integers(0, 4))
        else:
            window = max(0, window - int(rng.integers(1, 5)))
        want = _reference_masks(table.expiry, window, 8)
        np.testing.assert_array_equal(table.busy_masks(window), want)
        np.testing.assert_array_equal(
            table.bus_busy_masks(window),
            _reference_masks(table.bus_expiry, window, 8))
        dev = table.device_busy_masks(window)
        assert dev.dtype == torch.int64
        np.testing.assert_array_equal(dev.numpy().astype(np.uint32), want)


def test_device_masks_reupload_only_when_the_version_moves():
    table = P.SlotTable(PT.Mesh3D(4, 4, 2), 8, device="cpu")
    first = table.device_busy_masks(0)
    assert table.device_busy_masks(0) is first          # unchanged: cached
    table.reserve(P.Circuit(src=3, dst=3, start_cycle=0, n_windows=2,
                            hops=[(3, 6, 5)]), 0)
    second = table.device_busy_masks(0)
    assert second is not first and int(second[3, 6]) == 1 << 5
    assert int(table.device_busy_masks(2)[3, 6]) == 0   # expired at window 2
    with pytest.raises(RuntimeError, match="double booking"):
        table.reserve(P.Circuit(src=3, dst=3, start_cycle=0, n_windows=2,
                                hops=[(3, 6, 5)]), 0)


def test_allocator_rejects_unknown_backend():
    with pytest.raises(ValueError, match="backend"):
        P.TdmAllocator(PT.Mesh3D(4, 4, 2), 8, backend="gpu", device="cpu")
