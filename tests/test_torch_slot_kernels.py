"""The slot-allocator kernels' plain PyTorch versions against the JAX
package: ``ref.py`` oracles, the jnp fused program, and the Pallas
kernels in interpret mode — bit for bit (tolerance 0), including
power-of-two pad rows (src = dst = 0), zero-distance requests, denied
rows and rows whose trace-back fails.

The ``cuda`` test holds each CUDA kernel equal to its plain version on
the card; it skips where ``torch.cuda.is_available()`` is false.  The
reference imports happen in a fixture, so the file also collects on a
machine without JAX (where only the ``cuda`` test runs).
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.core.bitvec import packed_numpy, packed_tensor
from repro_torch.core.slot_alloc import wavefront_search
from repro_torch.core.topology import Mesh3D, PORT_LOCAL
from repro_torch.kernels import _lib
from repro_torch.kernels.slot_alloc import fused as kf
from repro_torch.kernels.slot_alloc import ops as kops
from repro_torch.kernels.slot_alloc import ref as pref
from repro_torch.kernels.slot_alloc import slot_alloc as ks

CONFIGS = [((8, 8, 4), 16), ((4, 4, 2), 8), ((8, 8, 4), 32)]
FIELDS = ("starts", "arr", "dists", "denied", "ok", "free", "hop_n",
          "hop_p", "hop_s")


@pytest.fixture(scope="module")
def ref():
    """The JAX package's allocator and kernel modules (CPU)."""
    pytest.importorskip("jax")
    import repro.core.slot_alloc as core
    import repro.core.topology as top
    from repro.kernels.slot_alloc import fused, ops
    from repro.kernels.slot_alloc import ref as oracle
    return core, top, fused, ops, oracle


def _occupancy(ref, dims, n_slots, seed, n_circuits=24, nbytes=256):
    """Busy masks of a reference allocator after a seeded stream."""
    core, top = ref[0], ref[1]
    mesh = top.Mesh3D(*dims, vault_span_y=1)
    alloc = core.TdmAllocator(mesh, n_slots)
    rng = np.random.default_rng(seed)
    for i in range(n_circuits):
        s, d = (int(v) for v in rng.integers(mesh.n_nodes, size=2))
        if s != d:
            alloc.allocate(s, d, nbytes, cycle=i * 3)
    return mesh, alloc.table.busy_masks(window=0)


def _requests(rng, n_nodes, B):
    srcs = rng.integers(n_nodes, size=B)
    dsts = rng.integers(n_nodes, size=B)
    srcs[:2] = dsts[:2] = 0          # power-of-two pad rows
    dsts[2] = srcs[2]                # a zero-distance request
    return srcs, dsts


def _plain_search(occ, srcs, dsts, inits, mesh, n_slots):
    return packed_numpy(ks.wavefront_search_plain(
        packed_tensor(occ, "cpu"), torch.as_tensor(srcs),
        torch.as_tensor(dsts), packed_tensor(inits, "cpu"), mesh=mesh,
        n_slots=n_slots))


# --- kernel 1: wavefront search -----------------------------------------------
@pytest.mark.parametrize("dims,n_slots", CONFIGS)
def test_search_plain_matches_ref_and_pallas(ref, dims, n_slots):
    _core, _top, _fused, rops, oracle = ref
    rmesh, occ = _occupancy(ref, dims, n_slots, seed=1)
    mesh = Mesh3D(*dims, vault_span_y=1)
    rng = np.random.default_rng(2)
    srcs, dsts = _requests(rng, mesh.n_nodes, 8)
    inits = rng.integers(0, 2 ** n_slots, size=8,
                         dtype=np.uint64).astype(np.uint32)
    got = _plain_search(occ, srcs, dsts, inits, mesh, n_slots)
    np.testing.assert_array_equal(got, oracle.wavefront_search_ref_batch(
        occ, srcs, dsts, inits, mesh=rmesh, n_slots=n_slots))
    np.testing.assert_array_equal(got, np.asarray(
        rops.wavefront_search_pallas_batch(occ, srcs, dsts, inits,
                                           mesh=rmesh, n_slots=n_slots,
                                           interpret=True)))
    np.testing.assert_array_equal(got, pref.wavefront_search_ref_batch(
        occ, srcs, dsts, inits, mesh=mesh, n_slots=n_slots))


# --- kernel 2: slot scoring ---------------------------------------------------
@pytest.mark.parametrize("n_slots", [8, 16, 32])
def test_score_plain_matches_ref_and_pallas(ref, n_slots):
    _core, _top, rfused, _ops, oracle = ref
    rng = np.random.default_rng(n_slots)
    B = 40
    avail = rng.integers(0, 2 ** n_slots, size=B,
                         dtype=np.uint64).astype(np.uint32)
    avail[0] = (1 << n_slots) - 1                     # fully busy: denied
    dists = rng.integers(0, 3 * n_slots, size=B)
    t = rng.integers(0, 2 ** 31 - 2 * n_slots, size=B)
    got = kf.slot_score_plain(packed_tensor(avail, "cpu"),
                              torch.as_tensor(dists), torch.as_tensor(t),
                              n_slots).numpy()
    np.testing.assert_array_equal(got, oracle.slot_score_ref(avail, dists, t,
                                                             n_slots))
    np.testing.assert_array_equal(got, pref.slot_score_ref(avail, dists, t,
                                                           n_slots))
    planes = rfused.unpack_bits(np.asarray(avail), n_slots)
    pallas = np.asarray(rfused.slot_score_planes(
        planes, np.asarray(dists, np.int32), np.asarray(t, np.int32),
        n_slots=n_slots, interpret=True))
    np.testing.assert_array_equal(got, pallas[:, :n_slots])
    assert (got[0] == kf.FAR32).all()


# --- kernel 3: the fused prepare ----------------------------------------------
def _assert_fused_equal(got, want, live_only=False):
    rows = (~want.denied & want.ok) if live_only else slice(None)
    for f in FIELDS:
        g, w = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        if f in ("hop_n", "hop_p", "hop_s", "arr"):
            g, w = g[rows], w[rows]
        np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("dims,n_slots", CONFIGS)
def test_fused_plain_matches_reference_programs(ref, dims, n_slots):
    _core, _top, rfused, _ops, oracle = ref
    rmesh, occ = _occupancy(ref, dims, n_slots, seed=3, n_circuits=60,
                            nbytes=4096)
    mesh = Mesh3D(*dims, vault_span_y=1)
    rng = np.random.default_rng(4)
    srcs, dsts = _requests(rng, mesh.n_nodes, 16)
    t = rng.integers(3, 500, size=16)
    got = kf.fused_prepare(occ, srcs, dsts, t, mesh=mesh, n_slots=n_slots,
                           device="cpu")
    # every row, garbage of denied rows included, equals the jit program
    jnp_prog = rfused.fused_prepare(occ, srcs, dsts, t, mesh=rmesh,
                                    n_slots=n_slots)
    _assert_fused_equal(got, jnp_prog)
    np.testing.assert_array_equal(got.vecs_np(), np.asarray(
        jnp_prog.vecs_np()))
    pallas = rfused.fused_prepare(occ, srcs, dsts, t, mesh=rmesh,
                                  n_slots=n_slots, kernel="pallas",
                                  interpret=True)
    _assert_fused_equal(got, pallas)
    # the numpy oracles (theirs and the port's) agree on the live rows
    _assert_fused_equal(got, oracle.fused_prepare_ref(
        occ, srcs, dsts, t, mesh=rmesh, n_slots=n_slots), live_only=True)
    _assert_fused_equal(got, pref.fused_prepare_ref(
        occ, srcs, dsts, t, mesh=mesh, n_slots=n_slots), live_only=True)


@settings(max_examples=5, deadline=None, database=None)
@given(st.integers(0, 2 ** 31))
def test_fused_plain_on_saturated_tables(ref, seed):
    """Dense occupancy: denied rows and failed trace-backs are bit-equal
    to the jit program too (ok flags, hop garbage and all)."""
    _core, _top, rfused, _ops, _oracle = ref
    dims, n_slots = (4, 4, 2), 4
    rmesh = ref[1].Mesh3D(*dims, vault_span_y=1)
    mesh = Mesh3D(*dims, vault_span_y=1)
    rng = np.random.default_rng(seed)
    occ = rng.integers(0, 2 ** n_slots, size=(mesh.n_nodes, 7),
                       dtype=np.uint64).astype(np.uint32)
    srcs, dsts = _requests(rng, mesh.n_nodes, 16)
    t = rng.integers(3, 100, size=16)
    got = kf.fused_prepare(occ, srcs, dsts, t, mesh=mesh, n_slots=n_slots,
                           device="cpu")
    _assert_fused_equal(got, rfused.fused_prepare(occ, srcs, dsts, t,
                                                  mesh=rmesh,
                                                  n_slots=n_slots))


def test_one_node_mesh_is_zero_hop():
    mesh = Mesh3D(1, 1, 1, vault_span_y=1)
    occ = np.zeros((1, 7), np.uint32)
    occ[0, PORT_LOCAL] = 0b0101
    fp = kf.fused_prepare(occ, [0, 0], [0, 0], [3, 6], mesh=mesh, n_slots=4,
                          device="cpu")
    np.testing.assert_array_equal(fp.hop_n, [[0], [0]])
    np.testing.assert_array_equal(fp.hop_p, [[PORT_LOCAL], [PORT_LOCAL]])
    np.testing.assert_array_equal(fp.arr, [3, 3])
    np.testing.assert_array_equal(fp.starts, [3, 7])
    assert fp.ok.all() and not fp.denied.any()


# --- wrappers on CPU tensors take the plain versions ---------------------------
def test_wrappers_run_plain_versions_on_cpu_and_count_no_launch():
    mesh = Mesh3D(4, 4, 2, vault_span_y=1)
    rng = np.random.default_rng(5)
    occ = rng.integers(0, 2 ** 8, size=(mesh.n_nodes, 7),
                       dtype=np.uint64).astype(np.uint32)
    srcs, dsts = _requests(rng, mesh.n_nodes, 12)
    inits = np.zeros(12, np.uint32)
    before = dict(_lib.launch_counts)
    occ_t = packed_tensor(occ, "cpu")
    got = kops.wavefront_search_kernel_batch(occ, srcs, dsts, inits,
                                             mesh=mesh, n_slots=8,
                                             device="cpu")
    np.testing.assert_array_equal(
        packed_numpy(got), _plain_search(occ, srcs, dsts, inits, mesh, 8))
    one = wavefront_search(occ_t, srcs[5], dsts[5], 0, mesh=mesh, n_slots=8)
    np.testing.assert_array_equal(packed_numpy(one), packed_numpy(got)[5])
    avail = torch.as_tensor(rng.integers(0, 256, size=12))
    d = torch.as_tensor(rng.integers(0, 9, size=12))
    t = torch.as_tensor(rng.integers(0, 99, size=12))
    assert torch.equal(kf.slot_score(avail, d, t, n_slots=8),
                       kf.slot_score_plain(avail, d, t, 8))
    outs = kf.fused_prepare_packed(occ_t, torch.as_tensor(srcs),
                                   torch.as_tensor(dsts), t, mesh=mesh,
                                   n_slots=8)
    for a, b in zip(outs, kf.fused_prepare_plain(
            occ_t, torch.as_tensor(srcs), torch.as_tensor(dsts), t,
            mesh=mesh, n_slots=8)):
        assert torch.equal(a, b)
    assert dict(_lib.launch_counts) == before


def test_fused_start_rejects_int32_overflow_and_bad_widths():
    mesh = Mesh3D(4, 4, 2, vault_span_y=1)
    occ = np.zeros((mesh.n_nodes, 7), np.uint32)
    with pytest.raises(ValueError, match="int32"):
        kf.fused_prepare_start(occ, [1], [2], [2 ** 31 - 16], mesh=mesh,
                               n_slots=8, device="cpu")
    with pytest.raises(ValueError, match="n_slots"):
        kf.fused_prepare(occ, [1], [2], [3], mesh=mesh, n_slots=33,
                         device="cpu")


# --- on the card ---------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_slots", [16, 32])
def test_cuda_kernels_match_plain(cuda_device, n_slots):
    """Each CUDA kernel equals its plain version on the same device
    tensors (the (8,8,4) mesh, batches of 64 and 1000)."""
    mesh = Mesh3D(8, 8, 4)
    rng = np.random.default_rng(n_slots)
    occ = packed_tensor(rng.integers(0, 2 ** n_slots, size=(256, 7),
                                     dtype=np.uint64).astype(np.uint32)
                        & np.uint32(0x0F0F0F0F), cuda_device)
    for B in (64, 1000):
        srcs, dsts = _requests(rng, 256, B)
        s = torch.as_tensor(srcs, device=cuda_device)
        d = torch.as_tensor(dsts, device=cuda_device)
        init = packed_tensor(rng.integers(0, 2 ** n_slots, size=B,
                                          dtype=np.uint64).astype(np.uint32),
                             cuda_device)
        t = torch.as_tensor(rng.integers(3, 2 ** 20, size=B),
                            device=cuda_device)
        before = dict(_lib.launch_counts)
        got = ks.wavefront_search_packed(occ, s, d, init, mesh=mesh,
                                         n_slots=n_slots)
        np.testing.assert_array_equal(packed_numpy(got), packed_numpy(
            ks.wavefront_search_plain(occ, s, d, init, mesh=mesh,
                                      n_slots=n_slots)))
        avail = torch.as_tensor(rng.integers(0, 2 ** n_slots, size=B),
                                device=cuda_device)
        np.testing.assert_array_equal(
            kf.slot_score(avail, d, t, n_slots=n_slots).cpu().numpy(),
            kf.slot_score_plain(avail, d, t, n_slots).cpu().numpy())
        kern = kf.fused_prepare_packed(occ, s, d, t, mesh=mesh,
                                       n_slots=n_slots)
        plain = kf.fused_prepare_plain(occ, s, d, t, mesh=mesh,
                                       n_slots=n_slots)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(kern[0].cpu().numpy(),
                                      plain[0].cpu().numpy())
        np.testing.assert_array_equal(kern[1].cpu().numpy(),
                                      plain[1].cpu().numpy())
        np.testing.assert_array_equal(packed_numpy(kern[2]),
                                      packed_numpy(plain[2]))
        assert {k: _lib.launch_counts[k] - before[k] for k in before} == \
            {"wavefront_search": 1, "slot_score": 1, "fused_prepare": 1,
             "flash_attention": 0, "rglru_scan": 0}
