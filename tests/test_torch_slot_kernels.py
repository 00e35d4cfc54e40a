"""The slot-allocator kernels' plain PyTorch versions against the JAX
package: ``ref.py`` oracles, the jnp fused program, and the Pallas
kernels in interpret mode — bit for bit (tolerance 0), including
power-of-two pad rows (src = dst = 0), zero-distance requests, denied
rows and rows whose trace-back fails.

The kernels' lane map (how a warp enumerates a lattice layer, written
out on the host here) is held against the plain version's layers.  The ``cuda`` tests hold each CUDA kernel equal to its
plain version on the card (one request, waves, the smallest to the
largest mesh, 1 to 32 slots, and waves whose buffers are reused while
an earlier wave's vectors are still to be read); they skip where
``torch.cuda.is_available()`` is false.  The reference imports happen in
a fixture, so the file also collects on a machine without JAX (where
only the ``cuda`` tests run).
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
    if B > 2:
        srcs[:2] = dsts[:2] = 0      # power-of-two pad rows
        dsts[2] = srcs[2]            # a zero-distance request
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


# --- the kernels' lane map -------------------------------------------------------
def _layer_lanes(mesh, src: int, dst: int, k: int) -> np.ndarray:
    """Lattice layer ``k`` of request (src, dst) as one warp of the
    kernels enumerates it (``nom::wavefront_warp``): a (rounds, 32)
    array of node ids, -1 where a lane idles.  Lane t owns the box rows
    (l1, l2) numbered t, t + 32, ... (row l1 + b1 * l2, a line along x,
    with l the box-local distance from the source per dimension and b1
    the box's extent along y) and takes the row's node l0 = k - l1 - l2
    where that lies in the box.  The lane map of
    ``csrc/slot_alloc.cuh`` written out on the host, to hold against the
    plain version's layers; the ``cuda`` tests below run the kernel's
    own."""
    sc, dc = np.array(mesh.coords(src)), np.array(mesh.coords(dst))
    span = np.abs(dc - sc)
    step = np.sign(dc - sc) * np.array([1, mesh.X, mesh.X * mesh.Y])
    b1 = int(span[1]) + 1
    rows = b1 * (int(span[2]) + 1)
    dl1, dl2 = 32 % b1, 32 // b1
    out = np.full((-(-rows // 32), 32), -1, np.int64)
    for lane in range(32):
        l1, l2 = lane % b1, lane // b1
        for i in range(len(range(lane, rows, 32))):
            l0 = k - l1 - l2
            if 0 <= l0 <= span[0]:
                out[i, lane] = src + l0 * step[0] + l1 * step[1] + l2 * step[2]
            l1, l2 = l1 + dl1, l2 + dl2
            if l1 >= b1:
                l1, l2 = l1 - b1, l2 + 1
    return out


def _layers_of(mesh, pairs):
    """For each (src, dst): the plain version's layer masks, as node-id
    sets per k in [0, dist + 1]."""
    srcs = torch.as_tensor([p[0] for p in pairs])
    dsts = torch.as_tensor([p[1] for p in pairs])
    _c, _sc, _sg, in_box, off, dist, _u, _p = ks._geometry(mesh, srcs, dsts)
    return [[set(np.flatnonzero((in_box[i] & (off[i] == k)).numpy()))
             for k in range(int(dist[i]) + 2)] for i in range(len(pairs))]


@pytest.mark.parametrize("dims,sample", [((4, 4, 2), None),
                                         ((5, 4, 3), None),
                                         ((8, 8, 4), 200)])
def test_layer_lanes_match_plain_layers(dims, sample):
    """Every lattice layer, as the warp enumerates it, is the plain
    version's ``in_box & (off == k)``, each node on one lane once:
    every (src, dst) pair of the small meshes, a sample on the paper
    mesh (its corner-to-corner pairs included)."""
    mesh = Mesh3D(*dims, vault_span_y=1)
    n = mesh.n_nodes
    pairs = [(s, d) for s in range(n) for d in range(n)]
    if sample:
        rng = np.random.default_rng(7)
        pairs = [(0, n - 1), (n - 1, 0), (mesh.X - 1, n - mesh.X)] + [
            pairs[i] for i in rng.choice(len(pairs), sample, replace=False)]
    for (s, d), layers in zip(pairs, _layers_of(mesh, pairs)):
        for k, want in enumerate(layers):
            got = _layer_lanes(mesh, s, d, k)
            ids = got[got >= 0]
            assert len(ids) == len(set(ids.tolist())), (s, d, k)
            assert set(ids.tolist()) == want, (s, d, k)


def test_layer_lanes_fit_one_warp_pass_on_paper_mesh():
    """On the paper mesh every box has at most 32 rows, so a warp takes
    each layer in one pass, and no layer holds more than 28 nodes (the
    full box's middle layers)."""
    mesh = Mesh3D(8, 8, 4)
    widest = 0
    for src in (0, mesh.n_nodes - 1):          # both travel signs
        for dst in range(mesh.n_nodes):
            x, y, z = (abs(a - b) for a, b in zip(mesh.coords(src),
                                                  mesh.coords(dst)))
            for k in range(x + y + z + 1):
                got = _layer_lanes(mesh, src, dst, k)
                assert got.shape == (1, 32)
                widest = max(widest, int((got >= 0).sum()))
    assert widest == 28


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
    host = kops.wavefront_search_host(occ_t, srcs, dsts, inits, mesh=mesh,
                                      n_slots=8)
    assert host.dtype == np.uint32
    np.testing.assert_array_equal(host, packed_numpy(got))
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


# (mesh dims, n_slots) on the card: the paper mesh at 16, 32 and 1
# slots, the smallest and an odd mesh, and the largest the kernels take
# (16x16x12 = MAX_NODES: 156 KB of shared memory a fused-prepare CTA).
CUDA_CASES = [((8, 8, 4), 16), ((8, 8, 4), 32), ((8, 8, 4), 1),
              ((4, 4, 2), 32), ((5, 4, 3), 1), ((16, 16, 12), 16)]


def _cuda_occ(rng, mesh, n_slots, device):
    return packed_tensor(rng.integers(0, 2 ** n_slots, size=(mesh.n_nodes, 7),
                                      dtype=np.uint64).astype(np.uint32)
                         & np.uint32(0x0F0F0F0F), device)


def _assert_fused_plain(fp, occ, srcs, dsts, t, mesh, n_slots):
    """A waited FusedPrepare equals the plain version, lazy vectors
    included."""
    dev = occ.device
    ints, flags, vecs = kf.fused_prepare_plain(
        occ, torch.as_tensor(srcs, device=dev),
        torch.as_tensor(dsts, device=dev), torch.as_tensor(t, device=dev),
        mesh=mesh, n_slots=n_slots)
    ints, flags = ints.cpu().numpy(), flags.cpu().numpy().astype(bool)
    L = mesh.max_dist + 1
    np.testing.assert_array_equal(fp.starts, ints[:, 0])
    np.testing.assert_array_equal(fp.arr, ints[:, 1])
    np.testing.assert_array_equal(fp.dists, ints[:, 2])
    np.testing.assert_array_equal(
        np.concatenate([fp.hop_n, fp.hop_p, fp.hop_s], 1), ints[:, 3:3 + 3 * L])
    np.testing.assert_array_equal(fp.denied, flags[:, 0])
    np.testing.assert_array_equal(fp.ok, flags[:, 1])
    np.testing.assert_array_equal(fp.free, flags[:, 2:])
    np.testing.assert_array_equal(fp.vecs_np(), packed_numpy(vecs))


@pytest.mark.cuda
@pytest.mark.parametrize("dims,n_slots", CUDA_CASES)
def test_cuda_kernels_match_plain(cuda_device, dims, n_slots):
    """Each CUDA kernel equals its plain version on the same device
    tensors, at one request (the mesh's longest) and waves of 64 and
    1000."""
    mesh = Mesh3D(*dims, vault_span_y=1)
    n = mesh.n_nodes
    rng = np.random.default_rng(n_slots)
    occ = _cuda_occ(rng, mesh, n_slots, cuda_device)
    for B in (1, 64, 1000):
        srcs, dsts = (_requests(rng, n, B) if B > 1
                      else (np.array([0]), np.array([n - 1])))
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
             "flash_attention": 0, "rglru_scan": 0, "ssd_scan": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("dims,n_slots", [((8, 8, 4), 16), ((16, 16, 12), 32)])
def test_cuda_search_host_rounds_match_plain(cuda_device, dims, n_slots):
    """The allocator's search round (one upload, one launch, one pull
    through a reused pinned buffer) equals the plain version, round
    after round of changing sizes."""
    mesh = Mesh3D(*dims, vault_span_y=1)
    rng = np.random.default_rng(11)
    occ = _cuda_occ(rng, mesh, n_slots, cuda_device)
    for B in (64, 1, 128, 64, 1):
        srcs, dsts = _requests(rng, mesh.n_nodes, B)
        inits = rng.integers(0, 2 ** n_slots, size=B,
                             dtype=np.uint64).astype(np.uint32)
        got = kops.wavefront_search_host(occ, srcs, dsts, inits, mesh=mesh,
                                         n_slots=n_slots)
        np.testing.assert_array_equal(got, packed_numpy(
            ks.wavefront_search_plain(
                occ, torch.as_tensor(srcs, device=cuda_device),
                torch.as_tensor(dsts, device=cuda_device),
                packed_tensor(inits, cuda_device), mesh=mesh,
                n_slots=n_slots)))


@pytest.mark.cuda
def test_cuda_waves_in_a_row_keep_earlier_vectors(cuda_device):
    """Staging buffers are reused from wave to wave, but a wave's lazy
    vectors stay its own: the first wave's ``vecs_np()``, read after the
    second launch, and two waves in flight at once, all equal the plain
    version."""
    mesh, n_slots = Mesh3D(8, 8, 4), 16
    rng = np.random.default_rng(12)
    occ = _cuda_occ(rng, mesh, n_slots, cuda_device)
    side = torch.cuda.Stream(cuda_device)
    waves = []
    for B in (64, 1, 64, 33):
        srcs, dsts = _requests(rng, mesh.n_nodes, B)
        waves.append((srcs, dsts, rng.integers(3, 2 ** 20, size=B)))
    kw = dict(mesh=mesh, n_slots=n_slots, stream=side)
    first = kf.fused_prepare_wait(kf.fused_prepare_start(occ, *waves[0], **kw))
    token = kf.fused_prepare_start(occ, *waves[1], **kw)
    _assert_fused_plain(first, occ, *waves[0], mesh, n_slots)
    _assert_fused_plain(kf.fused_prepare_wait(token), occ, *waves[1], mesh,
                        n_slots)
    a = kf.fused_prepare_start(occ, *waves[2], **kw)
    b = kf.fused_prepare_start(occ, *waves[3], **kw)
    fb = kf.fused_prepare_wait(b)
    fa = kf.fused_prepare_wait(a)
    again = kf.fused_prepare_wait(kf.fused_prepare_start(occ, *waves[3], **kw))
    _assert_fused_plain(fa, occ, *waves[2], mesh, n_slots)
    _assert_fused_plain(fb, occ, *waves[3], mesh, n_slots)
    _assert_fused_plain(again, occ, *waves[3], mesh, n_slots)
    _assert_fused_plain(first, occ, *waves[0], mesh, n_slots)
