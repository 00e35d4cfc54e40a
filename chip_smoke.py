#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port of NoM (``src/repro_torch``) on one GPU.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine
with an NVIDIA H100 (``sm_90a``), the CUDA toolkit and PyTorch built for
CUDA.  It imports nothing of JAX or of the JAX package ``repro``.

Phases (each prints its lines; any failure exits non-zero):

1. build — compile the six kernels from ``src/repro_torch/kernels/*/csrc``
   (one nvcc each, in parallel); registers, spills and any serialized
   wgmma per instantiation; the SSD wgmma kernel must have neither, the
   search and fused prepare kernels no spills;
2. kernels — wavefront search, slot scoring and fused prepare against
   their plain PyTorch versions on the card, bit-equal, at the paper mesh
   (8x8x4) with 16 and 32 slots and batches of 1, 64, 1000 and 1024, on
   occupancy taken from a real allocator state, then at one request and
   a wave on the meshes and slot counts of ``SLOT_CASES`` (1 to 32 slots,
   4x4x2 to 16x16x12 = MAX_NODES) on seeded random occupancy; at every
   shape also through the wrappers the allocator calls (the search round
   and two fused waves on a side stream through the reused staging
   buffers, the first wave's vectors read after the second's launch);
   times at 1, 64 and 1024 requests (16 slots): CUDA events over
   back-to-back launches and the profiler's kernel duration, beside an
   empty kernel launched the same way (the launch floor) and the bound
   in two counts (bytes or operations, and that taken with the launch
   floor: the profiler's beside the kernel duration, the event floor
   beside the event time);
3. model kernels — flash attention, the RG-LRU scan and the SSD scan
   against their plain versions at the models' prefill shapes (B=2,
   S=4096, 16/1 heads of 256, window 2048, bf16; (2, 4096, 4096) fp32;
   x (4, 8192, 24, 64) bf16 with B/C (4, 8192, 128) as column views of
   one conv output) and at odd ones (S not a block or chunk multiple,
   GQA, no window, fp32; the bf16 attention kernel at every head dim),
   to the tolerances of tests/test_kernels.py (the RG-LRU scan
   bit-equal on every case, through both its kernels: the TMA ring and
   the per-thread one), printing which SSD kernel (wgmma or CUDA cores)
   and how many segments, and which RG-LRU kernel and tile, each case
   ran; times at the models' shapes, both counts of the SSD bound, SDPA
   on the same mask as the attention's library time, and one
   elementwise pass over the RG-LRU scan's bytes beside it; the
   attention at its model shape on five more seeds, held under
   FLASH_MODEL_TOL, with |SDPA - plain|, the share of outputs that
   differ and the largest |plain| among them on all six;
   the SSD scan at its model shape on five more seeds, held per head,
   with the wgmma kernel timed at segment counts beside the rule's; every
   bf16 SSD result held to the plain version's fp32 result beyond bf16's
   own rounding (``SSD_EXACT_TOL``), which a kernel that rounds its fp32
   operands to bf16 or TF32 exceeds; the attention at the dense family's
   head-dim-128 prefill shapes (``DENSE_FLASH``: B=2 x S=4096 bf16,
   qwen1.5-4b 20/20 heads, gemma3-27b 32/16 with its local window of
   1024 and without, qwen2.5-32b 40/8, command-r-plus 96/8), each held
   at 2e-2 and timed beside its bound and SDPA on the same mask,
   qwen1.5-4b's also on five more seeds under FLASH_DENSE_TOL; and
   command-r-plus-smoke's head dim of 8 through the model-layout wrapper
   (zero-padded to 16) against the same call on the CPU;
4. slice — ``NomFabric(mesh=PAPER_MESH, n_slots=16)`` with the fused,
   host and auto allocator backends, and a NoM-Light fabric, on one seeded
   stream of 4096 transfers (copies of 512 B-64 KB with 0-3 extra slots,
   in-place inits, fan-in reduces) in 8 flushes: every circuit and
   schedule report must agree across backends (reports up to the
   fused/host wave split, which differs by construction) and with the
   plain PyTorch versions on the CPU, and every circuit must be well
   formed.  Each path runs with the launch counts set to 0 just before
   it and read just after: its own kernels (``PATH_KERNELS``) must have
   launched, and no other;
5. timing — µs per allocation of each path over rotated rounds (median
   and range), the host time of one split-pipeline scoring round on
   the scoring kernel against numpy (the allocator's choice), the host
   µs per call of the allocator's two device calls (a fused wave, a
   search round) at 1 and 64 requests, and each path's kernel time with
   every launch priced at its own batch size's time;
6. memsim — the paper's Fig. 4 comparison: the workloads fork,
   fileCopy20/40/60 (900 requests, seed 1) under the four configs at
   ``SimParams()`` defaults, and 4 stacks over 1024 banks (fileCopy60
   and gradAgg40 under nom and nom_light; gradAgg40 under NoM-Light must
   raise the reference's ValueError), each ``simulate`` on the card and
   on the CPU with equal ``SimResult``s and energies; the paper's bands
   (``fig4_bands``, as tests/test_memsim_claims.py asserts them) on the
   card's results; a line per config (IPC, cycles, CCU fused and host
   waves, cross-stack copies, wall ms) and the launches of each run (0
   at these settings: every CCU round holds at most 8 requests, which
   the allocator keeps on the host);
7. cluster — ``FabricCluster`` over ``make_topology(4, PAPER_MESH)``
   (ring, SerDes latency 8, 4-byte links, 1024 banks) on the fused, host
   and auto backends and with NoM-Light allocators, on one seeded stream
   of 4096 transfers in 8 flushes at the session clock
   (``make_cluster_stream``: most copies cross stacks, some reduces
   build cross-stack trees): results, reports, telemetry and slot tables
   must agree across the three backends (up to the wave split) and each
   path with itself on the CPU; every circuit well formed, every
   cross-stack circuit's segments chained (``check_stacked``); each path
   run with the launch counts set to 0 just before it and read just
   after must have launched its own kernels (``PATH_KERNELS``, in each
   stack's CCU) and no other; µs per allocation per path over rotated
   rounds;
8. serving SLO — the serving control plane (``repro_torch.serving``) at
   ``benchmarks/bench_serving_slo.py``'s settings: every arrival mix
   under every admission strategy (seed 7, 160 ticks, mesh 4x4x2,
   deadline ticks 12, queue depth 16) with the engine's fabric on the
   card, each drive with the launch counts set to 0 just before it and
   read just after (the fused prepare kernel once per fused CCU wave,
   nothing else) and held equal to the same drive on the CPU (record and
   per-tick ledger, telemetry, batch reports, slot tables); the
   benchmark's gate (deadline misses fewer deadlines than fifo on
   deadline_heavy); per drive the record, µs per tick and the wall split
   into kernels, the rest of the fabric and the control plane;
9. models — the smoke configs of recurrentgemma, mamba2, qwen1.5,
   gemma3, qwen2.5 and command-r-plus (``SMOKE_ARCHS``) on the card
   against the CPU plain versions; then ``recurrentgemma-9b``,
   ``mamba2-130m`` and ``qwen1.5-4b`` at full width and depth and
   ``gemma3-27b`` at full width on 8 of its 62 layers (``MODEL_LAYERS``)
   from seeded weights on the card: the prefill step (recurrentgemma B=2
   x S=4096: 12 flash_attention and 26 rglru_scan launches; mamba2 B=4 x
   S=8192: 24 ssd_scan launches; qwen1.5 and gemma3 B=2 x S=4096: 40 and
   8 flash_attention launches; nothing else), decode vs forward over 64
   tokens,
   ``Engine.generate`` for 4 requests untracked (no launch) and with its
   default transfer tracking on the paper mesh (the fused prepare kernel
   once per fused CCU wave; tokens equal to the untracked run; telemetry,
   reports and slot tables equal to a CPU engine stepped through the
   same tenant lifetime; gemma3's 16 cache leaves fill one fused wave a
   step), times, a profile of one prefill and of one decode step, and
   the peak memory; each model freed before the next;
10. checkpoint — ``repro_torch.checkpoint`` on the card: mamba2-130m
   saved from the card and restored onto it, every parameter and the
   restored model's prefill logits bit-equal to those before the save; a
   tree of bf16 and int32 leaves through a round trip; ``prune`` and
   ``latest_step`` past a stale ``.tmp``; ``cross_stack_reshard_plan`` of
   qwen1.5-4b's fp32 leaf bytes over four paper-mesh stacks, (0, 1, 2,
   3) -> (0, 1, 2), with the CCUs on the card, equal to the CPU's, with
   its launches; ``reshard_plan`` of the same bytes, (4, 4) -> (2, 4),
   in conflict-free rounds;
11. the kernel table (one JSON line, launches per path; the attention's
   row also carries its dense shapes' times as ``dense``), the card's
   name and power limit, and the closing ``{"ok": true, ...}`` line.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
N_TRANSFERS = 4096
N_FLUSHES = 8
WAVE = 64                      # TdmAllocator.search_wave: the main path's batch
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
ALU_OPS_PER_S = 67e12          # H100 SXM non-tensor fp32 rate (no int32 row)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------
def make_stream(mesh, n: int, seed: int, n_flushes: int):
    """``n_flushes`` chunks of transfers: even chunks hold plain copies
    only (the fused backend's struct-of-arrays wave commit), odd chunks
    mix copies with extra-slot bundles, in-place inits and same-layer
    fan-in reduces."""
    from repro_torch.core import TransferRequest, reduce_request
    rng = np.random.default_rng(seed)
    chunks = []
    per = n // n_flushes
    for k in range(n_flushes):
        chunk = []
        for _ in range(per):
            u = rng.random() if k % 2 else 1.0
            if u < 0.05:
                dst = int(rng.integers(mesh.n_nodes))
                z = mesh.coords(dst)[2]
                layer = [v for v in range(mesh.n_nodes)
                         if v != dst and mesh.coords(v)[2] == z]
                srcs = rng.choice(layer, size=int(rng.integers(2, 5)),
                                  replace=False)
                chunk.append(reduce_request([int(s) for s in srcs], dst,
                                            nbytes=int(rng.integers(512,
                                                                    8192))))
            elif u < 0.15:
                v = int(rng.integers(mesh.n_nodes))
                chunk.append(TransferRequest(
                    src=v, dst=v, op="init",
                    nbytes=int(2 ** rng.uniform(13, 16))))
            else:
                s, d = (int(x) for x in rng.integers(mesh.n_nodes, size=2))
                while s == d:
                    d = int(rng.integers(mesh.n_nodes))
                extra = (int(rng.integers(1, 4))
                         if k % 2 and rng.random() < 0.3 else 0)
                chunk.append(TransferRequest(
                    src=s, dst=d, nbytes=int(2 ** rng.uniform(9, 16)),
                    max_extra_slots=extra))
        chunks.append(chunk)
    return chunks


def circuit_key(c):
    if c is None:
        return None
    return (c.src, c.dst, c.start_cycle, c.n_windows, tuple(c.hops),
            c.slots_per_window, c.uses_bus, c.bus_column, c.distance, c.srcs)


def check_circuit(req, c, n_slots: int) -> None:
    """Shape of one granted mesh circuit: every bundle path starts at the
    source, ends in (dst, LOCAL, arrival) and uses increasing slots."""
    from repro_torch.core import PORT_LOCAL
    if req.op == "reduce" or c.uses_bus:
        check(c.hops[-1][0] == req.dst or req.op == "reduce",
              f"circuit {c} does not end at {req.dst}")
        return
    hops = c.hops
    per = c.distance + 1
    check(len(hops) == per * c.slots_per_window,
          f"circuit {c} has {len(hops)} hops for distance {c.distance}")
    for b in range(c.slots_per_window):
        path = hops[b * per:(b + 1) * per]
        check(path[0][0] == req.src and path[-1][:2] == (req.dst, PORT_LOCAL),
              f"bundle {path} of {req} is not src -> (dst, LOCAL)")
        for (_n1, _p1, s1), (_n2, _p2, s2) in zip(path, path[1:]):
            check((s1 + 1) % n_slots == s2, f"slots not increasing in {path}")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def occupied_table(mesh, n_slots: int, device):
    """Occupancy from a real allocator state: a seeded stream committed
    through the fused backend."""
    from repro_torch.core import NomFabric
    fab = NomFabric(mesh=mesh, n_slots=n_slots, alloc_backend="fused",
                    device=str(device))
    for k, chunk in enumerate(make_stream(mesh, 1024, SEED + n_slots, 4)):
        fab.schedule(chunk, cycle=k * 256)
    window = (4 * 256 + 3) // n_slots
    return fab.allocator.table.device_busy_masks(window), fab.allocator


def kernel_inputs(mesh, n_slots: int, B: int, device, rng):
    """Seeded requests: a lone request is the mesh's longest (corner to
    corner, the deepest chain of layers); a wave holds pad rows (src =
    dst = 0), zero-distance requests and that corner request among random
    ones, so one request and a wave carry the same deepest chain."""
    import torch
    from repro_torch.core.bitvec import full_mask, packed_tensor
    srcs = rng.integers(mesh.n_nodes, size=B)
    dsts = rng.integers(mesh.n_nodes, size=B)
    if B == 1:
        srcs[0], dsts[0] = 0, mesh.n_nodes - 1
    else:
        srcs[:2] = dsts[:2] = 0       # power-of-two pad rows: src = dst = 0
        dsts[2:6] = srcs[2:6]         # zero-distance requests
        srcs[6], dsts[6] = 0, mesh.n_nodes - 1
    init = rng.integers(0, full_mask(n_slots) + 1, size=B,
                        dtype=np.uint64).astype(np.uint32)
    t_ready = rng.integers(3, 2 ** 20, size=B)
    as_t = lambda a: torch.as_tensor(a, device=device)   # noqa: E731
    return (as_t(srcs), as_t(dsts), packed_tensor(init, device),
            as_t(t_ready), srcs, dsts)


def random_occupancy(mesh, n_slots: int, device, rng):
    """Seeded occupancy with each slot busy with probability 1/4."""
    from repro_torch.core.bitvec import full_mask, packed_tensor
    a, b = (rng.integers(0, 2 ** 32, size=(mesh.n_nodes, 7), dtype=np.uint64)
            for _ in range(2))
    return packed_tensor((a & b & full_mask(n_slots)).astype(np.uint32),
                         device)


def ms_per_call(fn, reps: int, device) -> float:
    """Device time per call: CUDA events around ``reps`` back-to-back
    calls after a warm-up (host clock on the CPU)."""
    import torch
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(device)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize(device)
    return a.elapsed_time(b) / reps


def raw_launcher(name: str, device, *args, entry=None):
    """A zero-overhead relaunch of kernel ``name`` for timing: its C
    entry point (or ``entry`` = (symbol, argument types) of its library)
    with its arguments resolved once.  These launches are not counted;
    they only measure."""
    import torch
    from repro_torch.kernels import _lib
    lib = _lib.library(name)
    if entry is None:
        fn = getattr(lib, f"{name}_launch")
    else:
        fn = getattr(lib, entry[0])
        fn.argtypes, fn.restype = list(entry[1]), ctypes.c_int
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    stream = torch.cuda.current_stream(device).cuda_stream

    def go(_keep=args):        # holds the tensors behind the raw pointers
        rc = fn(*cargs, stream)
        if rc:
            raise SmokeFailure(f"{name} relaunch failed with CUDA error {rc}")
    return go


def profiled_ms(launchers: dict, reps: int) -> dict:
    """Kernel duration per launch from the profiler (``profile_call``'s
    route) over ``reps`` launches of each of ``launchers`` in one
    profile: name -> ms, or the reason it could not be measured."""
    prof = profile_call(lambda: [fn() for fn in launchers.values()
                                 for _ in range(reps)])
    out = {}
    for name in launchers:
        hit = [r for r in prof.get("port_kernels", [])
               if SLOT_KERNEL_FN[name] in r["name"]]
        out[name] = (hit[0]["ms"] / hit[0]["calls"] if hit
                     else prof.get("not_measured", "no device time"))
    return out


def work(mesh, n_slots: int, srcs: np.ndarray, dsts: np.ndarray):
    """Bytes each kernel must move (inputs read once, outputs written
    once) and the integer operations these inputs need, per kernel."""
    n, B = mesh.n_nodes, len(srcs)
    c = mesh.coord_array.astype(np.int64)
    span = np.abs(c[srcs] - c[dsts])                     # (B, 3)
    box = np.prod(span + 1, axis=1)
    # each box node past the source combines one upstream per moved dim:
    # gather, OR, 3-op rotate, AND ~ 6 ops; plus ~10 ops of geometry.
    moved_terms = np.array([np.sum([np.prod(np.delete(span[b] + 1, d)) * span[b, d]
                                    for d in range(3)]) for b in range(B)])
    search_ops = int(np.sum(moved_terms * 6 + box * 10))
    score_ops = B * n_slots * 10
    trace_ops = int(np.sum(span.sum(1)) * 3 * 8)
    L = mesh.max_dist + 1
    occ_b, req_b = n * 7 * 4, B * 4 * 3
    return {
        "wavefront_search": (occ_b + req_b + B * n * 4, search_ops),
        "slot_score": (req_b + B * n_slots * 4, score_ops),
        "fused_prepare": (occ_b + req_b + B * (3 + 3 * L) * 4
                          + B * (2 + n_slots) + B * n * 4,
                          search_ops + score_ops + trace_ops),
    }


# Function names of the slot kernels and of the launch floor, as the
# profiler shows them.
SLOT_KERNEL_FN = {"wavefront_search": "wavefront_search_kernel",
                  "slot_score": "slot_score_kernel",
                  "fused_prepare": "fused_prepare_kernel",
                  "launch_floor": "launch_floor_kernel"}
# The C entry point of the launch floor: an empty kernel on the search's
# grid, in the search's library (csrc/wavefront_search.cu).
FLOOR_ENTRY = ("wavefront_search_floor_launch",
               (ctypes.c_int, ctypes.c_void_p))
# Beyond the paper mesh on its real occupancy, (mesh dims, n_slots) held
# bit-equal at one request and at a wave on seeded random occupancy: 1
# slot on the paper mesh; two small meshes (one odd) and the largest the
# kernels take (16x16x12 = MAX_NODES: 156 KB of shared memory a CTA),
# each at 1, 16 and 32 slots.
SLOT_CASES = [((8, 8, 4), 1)] + [(dims, k) for dims in ((4, 4, 2), (5, 4, 3),
                                                       (16, 16, 12))
                                 for k in (1, 16, 32)]
TIMED_BATCHES = (1, WAVE, 1024)


def hold_slot_kernels(mesh, n_slots: int, occ, B: int, device, rng):
    """The three slot kernels against their plain versions on one seeded
    batch: (search, score, fused) max |kernel - plain|, the inputs, the
    plain fused flags, and the scoring kernel's inputs."""
    import torch
    from repro_torch.core import PORT_LOCAL
    from repro_torch.core.bitvec import as_i64
    from repro_torch.kernels.slot_alloc import fused as kf
    from repro_torch.kernels.slot_alloc import slot_alloc as ks
    inputs = kernel_inputs(mesh, n_slots, B, device, rng)
    s, d, init, t, srcs_np, dsts_np = inputs
    kw = dict(mesh=mesh, n_slots=n_slots)
    got = ks.wavefront_search_packed(occ, s, d, init, **kw)
    want = ks.wavefront_search_plain(occ, s, d, init, **kw)
    err_s = int((as_i64(got) - as_i64(want)).abs().max())
    # scoring, on the real availability vectors
    avail = want[torch.arange(B, device=device), d] | as_i64(occ)[d, PORT_LOCAL]
    dist = torch.as_tensor(np.abs(mesh.coord_array[srcs_np]
                                  - mesh.coord_array[dsts_np]).sum(1),
                           device=device)
    got_c = kf.slot_score(avail, dist, t, n_slots=n_slots)
    want_c = kf.slot_score_plain(avail, dist, t, n_slots)
    err_c = int((got_c.long() - want_c.long()).abs().max())
    gi, gf, gv = kf.fused_prepare_packed(occ, s, d, t, **kw)
    wi, wf, wv = kf.fused_prepare_plain(occ, s, d, t, **kw)
    err_f = max(int((gi.long() - wi.long()).abs().max()),
                int((gf.long() - wf.long()).abs().max()),
                int((as_i64(gv) - as_i64(wv)).abs().max()))
    host_s, host_f = hold_allocator_calls(mesh, n_slots, occ, inputs, want,
                                          (wi, wf, wv), device)
    return ((max(err_s, host_s), err_c, max(err_f, host_f)), inputs, wf,
            (avail, dist))


def fused_words(fp) -> tuple[np.ndarray, np.ndarray]:
    """A :class:`FusedPrepare`'s (ints, flags) as int64, laid out as
    ``fused_prepare_plain`` returns them."""
    ints = np.concatenate([fp.starts[:, None], fp.arr[:, None],
                           fp.dists[:, None], fp.hop_n, fp.hop_p, fp.hop_s],
                          1)
    flags = np.concatenate([fp.denied[:, None], fp.ok[:, None], fp.free], 1)
    return ints.astype(np.int64), flags.astype(np.int64)


def hold_allocator_calls(mesh, n_slots: int, occ, inputs, want_search,
                         want_fused, device) -> tuple[int, int]:
    """The wrappers the allocator calls, against the plain versions on
    the same inputs: the search round (``ops.wavefront_search_host``:
    host arrays through a reused pinned buffer), and two fused waves
    (``fused_prepare_start`` on a side stream, then
    ``fused_prepare_wait``), the second with its rows reversed and
    launched before the first wave's vectors are read, so a staging
    buffer reused while a ``FusedPrepare`` can still read it shows.
    Returns max |wrapper - plain| of (search, fused: ints, flags and
    vectors)."""
    import torch
    from repro_torch.core.bitvec import packed_numpy
    from repro_torch.kernels.slot_alloc import fused as kf
    from repro_torch.kernels.slot_alloc import ops as kops
    _s, _d, init, t, srcs_np, dsts_np = inputs
    kw = dict(mesh=mesh, n_slots=n_slots)
    i64 = lambda a: np.asarray(a).astype(np.int64)      # noqa: E731
    got = kops.wavefront_search_host(occ, srcs_np, dsts_np,
                                     packed_numpy(init), **kw)
    err_s = int(np.abs(i64(got) - i64(packed_numpy(want_search))).max())
    wi, wf = (i64(x.cpu().numpy()) for x in want_fused[:2])
    wv = i64(packed_numpy(want_fused[2]))
    t_np = t.cpu().numpy()
    side = torch.cuda.Stream(device)
    waves = []
    for order in (slice(None), slice(None, None, -1)):
        fp = kf.fused_prepare_wait(kf.fused_prepare_start(
            occ, srcs_np[order], dsts_np[order], t_np[order], stream=side,
            **kw))
        waves.append((fp, order))
    err_f = 0
    for fp, order in waves[::-1]:     # the first wave's vectors read last
        gi, gf = fused_words(fp)
        err_f = max(err_f, int(np.abs(gi - wi[order]).max()),
                    int(np.abs(gf - wf[order]).max()),
                    int(np.abs(i64(fp.vecs_np()) - wv[order]).max()))
    return err_s, err_f


def slot_raw(mesh, n_slots: int, occ, inputs, score_in, device) -> dict:
    """Raw launchers of the slot kernels on ``inputs`` (as
    :func:`kernel_inputs` gives them), each with its own output buffers;
    the scoring kernel's only with its inputs ``score_in``."""
    import torch
    from repro_torch.core.bitvec import as_i32_bits
    from repro_torch.kernels.slot_alloc import fused as kf
    s, d, init, t, srcs_np, _dsts_np = inputs
    B, dims = len(srcs_np), (mesh.X, mesh.Y, mesh.Z)
    occ32 = as_i32_bits(occ).contiguous()
    i32 = lambda *xs: torch.stack([x.to(device, torch.int32)   # noqa: E731
                                   for x in xs])
    out = torch.empty((B, mesh.n_nodes), dtype=torch.int32, device=device)
    res = torch.empty(kf.result_words(B, mesh, n_slots), dtype=torch.int32,
                      device=device)
    kern = {
        "wavefront_search": raw_launcher(
            "wavefront_search", device, occ32, i32(s, d, as_i32_bits(init)),
            None, out, None, B, *dims, n_slots),
        "fused_prepare": raw_launcher(
            "fused_prepare", device, occ32, i32(s, d, t), None, res, None,
            out, B, *dims, n_slots),
    }
    if score_in is not None:
        avail, dist = score_in
        cost = torch.empty((B, n_slots), dtype=torch.int32, device=device)
        kern["slot_score"] = raw_launcher(
            "slot_score", device, as_i32_bits(avail), dist.to(torch.int32),
            t.to(torch.int32), cost, B, n_slots)
    return kern


def time_slot_kernels(mesh, n_slots: int, occ, inputs, score_in, device,
                      reps: int):
    """Event and profiler times of the three slot kernels and of the
    launch floor on one batch, with each kernel's plain time and its
    bound in two counts: bytes or operations, and that taken together
    with the launch floor, each floor beside the timing it shares a
    route with (the profiler's floor with the kernel duration, the
    event floor, which includes the host's enqueue, with the event
    time)."""
    from repro_torch.kernels.slot_alloc import fused as kf
    from repro_torch.kernels.slot_alloc import slot_alloc as ks
    s, d, init, t, srcs_np, dsts_np = inputs
    avail, dist = score_in
    B, kw = len(srcs_np), dict(mesh=mesh, n_slots=n_slots)
    kern = slot_raw(mesh, n_slots, occ, inputs, score_in, device)
    kern["launch_floor"] = raw_launcher("wavefront_search", device, B,
                                        entry=FLOOR_ENTRY)
    plain = {
        "wavefront_search": lambda: ks.wavefront_search_plain(
            occ, s, d, init, **kw),
        "slot_score": lambda: kf.slot_score_plain(avail, dist, t, n_slots),
        "fused_prepare": lambda: kf.fused_prepare_plain(occ, s, d, t, **kw),
    }
    event = {k: ms_per_call(fn, reps, device) for k, fn in kern.items()}
    prof = profiled_ms(kern, reps)
    floor = {"ms": event["launch_floor"], "kernel_ms": prof["launch_floor"]}
    wb = work(mesh, n_slots, srcs_np, dsts_np)
    rows = {}
    for name, fn in plain.items():
        nbytes, ops = wb[name]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / ALU_OPS_PER_S * 1e3
        bnd = max(t_bytes, t_ops)
        rows[name] = {
            "ms": event[name], "kernel_ms": prof[name],
            "plain_ms": ms_per_call(fn, max(5, reps // 20), device),
            "bound_ms": bnd,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_floor_ms": max(bnd, floor["ms"]),
            "bound_floor_kernel_ms": (max(bnd, floor["kernel_ms"])
                                      if isinstance(floor["kernel_ms"], float)
                                      else floor["kernel_ms"]),
            "bytes": nbytes, "ops": ops}
    return rows, floor


def fmt_ms(x) -> str:
    return f"{x:.5g}" if isinstance(x, float) else str(x)


def phase_kernels(mesh, device, batches=(1, 64, 1000, 1024), slots=(16, 32),
                  reps=200):
    """Every slot kernel against its plain version: on the paper mesh at
    ``batches`` x ``slots`` on occupancy from a real allocator state, then
    at ``SLOT_CASES`` on seeded random occupancy; times at
    ``TIMED_BATCHES`` (16 slots).  Returns the timed rows keyed (kernel,
    B), the launch floor by B and each kernel's largest |kernel - plain|
    over all shapes."""
    from repro_torch.core import Mesh3D
    rng = np.random.default_rng(SEED)
    rows, floors = {}, {}
    max_err: dict[str, int] = {}
    names = ("wavefront_search", "slot_score", "fused_prepare")

    def hold(m, n_slots, occ, B, where):
        errs, inputs, wf, score_in = hold_slot_kernels(m, n_slots, occ, B,
                                                       device, rng)
        for name, err in zip(names, errs):
            max_err[name] = max(max_err.get(name, 0), err)
        check(not any(errs), f"kernel != plain at {where} n_slots={n_slots} "
              f"B={B}: search, score, fused {errs}")
        return inputs, score_in, int(wf[:, 0].sum()), int((wf[:, 1] == 0)
                                                          .sum())

    for n_slots in slots:
        occ, _alloc = occupied_table(mesh, n_slots, device)
        for B in batches:
            inputs, score_in, nd, nf = hold(mesh, n_slots, occ, B, "8x8x4")
            line = (f"[kernels] n_slots={n_slots} B={B}: search, score, "
                    f"fused bit-equal to plain (tolerance 0; {nd} denied "
                    f"rows, {nf} failed walks)")
            if n_slots == 16 and B in TIMED_BATCHES:
                r, floors[B] = time_slot_kernels(mesh, n_slots, occ, inputs,
                                                 score_in, device, reps)
                for name, row in r.items():
                    rows[(name, B)] = row
                line += "; " + "; ".join(
                    f"{k} event {fmt_ms(v['ms'])} ms, kernel "
                    f"{fmt_ms(v['kernel_ms'])} ms (plain "
                    f"{fmt_ms(v['plain_ms'])} ms; bound {v['bound_ms']:.3g} "
                    f"ms by {v['bound_by']}; with the launch floor "
                    f"{fmt_ms(v['bound_floor_kernel_ms'])} ms by the "
                    f"profiler, {fmt_ms(v['bound_floor_ms'])} ms by events)"
                    for k, v in r.items())
                line += (f"; launch floor event {fmt_ms(floors[B]['ms'])} "
                         f"ms, kernel {fmt_ms(floors[B]['kernel_ms'])} ms")
            print(line, flush=True)
    for dims, n_slots in SLOT_CASES:
        m = Mesh3D(*dims, vault_span_y=1)
        occ = random_occupancy(m, n_slots, device, rng)
        stats = [hold(m, n_slots, occ, B, "x".join(map(str, dims)))[2:]
                 for B in (1, WAVE)]
        print(f"[kernels] {m.X}x{m.Y}x{m.Z} n_slots={n_slots} B=1 and "
              f"{WAVE}: search, score, fused bit-equal to plain (tolerance "
              f"0; denied rows, failed walks {stats})", flush=True)
    return rows, floors, max_err


# ---------------------------------------------------------------------------
# Phase 4: the slice end to end
# ---------------------------------------------------------------------------
FLUSH_CYCLES = 2048


def drive(fabric, chunks, cycle_step=FLUSH_CYCLES):
    """Schedule every chunk, one flush each: the k-th anchored at cycle
    k * ``cycle_step`` (so flushes overlap in time), or with
    ``cycle_step=None`` each at the session clock (after the drain of
    the circuits before it); returns (results, reports, seconds)."""
    import torch
    results, reports = [], []
    t0 = time.perf_counter()
    for k, chunk in enumerate(chunks):
        res, rep = fabric.schedule(
            chunk, cycle=None if cycle_step is None else k * cycle_step)
        results += res
        reports.append(rep)
    alloc = (fabric.fabrics[0] if hasattr(fabric, "fabrics")
             else fabric).allocator
    if alloc.device.type == "cuda":
        torch.cuda.synchronize(alloc.device)
    return results, reports, time.perf_counter() - t0


def report_key(rep, with_waves=False):
    d = dataclasses.asdict(rep)
    if not with_waves:
        d.pop("fused_waves")
        d.pop("host_waves")
    return d


N_SLOTS = 16
PATHS = ("fused", "host", "auto", "light")
# The kernels each path launches (and no other): the fused backend sends
# every prepare round, conflict re-searches included, through the fused
# kernel; "auto" sends full waves there and keeps rounds of 8 or fewer
# on the host; the split pipeline (host backend, NoM-Light) searches
# rounds of more than 8 with the search kernel.  As in the reference,
# slot scoring runs on the device only inside the fused kernel
# (nom::slot_cost); the split pipeline scores on the host, so the
# standalone scoring kernel is held against its plain version in phase 2
# and timed against host scoring in phase 4, and launches on no path.
PATH_KERNELS = {"fused": ("fused_prepare",), "auto": ("fused_prepare",),
                "host": ("wavefront_search",),
                "light": ("wavefront_search",)}


def make_fabric(mesh, kind: str, device):
    from repro_torch.core import NomFabric, TdmAllocatorLight
    if kind == "light":
        return NomFabric(allocator=TdmAllocatorLight(mesh, N_SLOTS,
                                                     device=str(device)))
    return NomFabric(mesh=mesh, n_slots=N_SLOTS, alloc_backend=kind,
                     device=str(device))


# Where the batch size sits among each slot kernel's launch arguments
# (after the device; ``_lib.KERNELS``).
BATCH_ARG = {"wavefront_search": 5, "slot_score": 4, "fused_prepare": 6}


@contextlib.contextmanager
def batches_launched(out: dict):
    """While active, add each slot-kernel launch to ``out[(kernel,
    batch)]``: ``_lib.launch`` wrapped, its own count untouched."""
    from repro_torch.kernels import _lib
    launch = _lib.launch

    def record(name, device, *args, **kw):
        launch(name, device, *args, **kw)
        if name in BATCH_ARG:
            key = (name, int(args[BATCH_ARG[name]]))
            out[key] = out.get(key, 0) + 1
    _lib.launch = record
    try:
        yield out
    finally:
        _lib.launch = launch


def phase_slice(mesh, device, chunks, cpu_check=True, batches=None):
    """The four paths on the device, each driven with the launch counts
    set to 0 just before it and read just after, checked against each
    other, the plain CPU versions and the circuit invariants; with a
    ``batches`` dict, each path's launches by (kernel, batch) go into
    ``batches[path]``.  Returns (stats, per-path launch counts, circuit
    keys)."""
    from repro_torch.kernels import _lib
    n_slots = N_SLOTS
    reqs = [r for c in chunks for r in c]
    runs, launches = {}, {}
    for kind in PATHS:
        fab = make_fabric(mesh, kind, device)
        _lib.reset_launch_counts()
        with (batches_launched(batches.setdefault(kind, {}))
              if batches is not None else contextlib.nullcontext()):
            res, reps, secs = drive(fab, chunks)
        launches[kind] = dict(_lib.launch_counts)
        runs[kind] = (fab, res, reps, secs)
        own = PATH_KERNELS[kind]
        check(all(launches[kind][k] > 0 for k in own),
              f"{kind}: a kernel of the path never launched: "
              f"{launches[kind]}")
        check(all(v == 0 for k, v in launches[kind].items() if k not in own),
              f"{kind}: launched a kernel outside its path: {launches[kind]}")
    keys = {k: [circuit_key(r.circuit) for r in v[1]] for k, v in runs.items()}
    for kind in ("host", "auto"):
        check(keys[kind] == keys["fused"],
              f"fused and {kind} backends committed different circuits")
        check([report_key(a) for a in runs[kind][2]]
              == [report_key(b) for b in runs["fused"][2]],
              f"fused and {kind} schedule reports differ")
    for kind, (fab, res, reps, _s) in runs.items():
        for rq, r in zip(reqs, res):
            if r.circuit is not None:
                check_circuit(rq, r.circuit, n_slots)
        for rep in reps:
            check(rep.fused_waves + rep.host_waves == rep.search_rounds,
                  f"{kind}: wave split does not partition search rounds")
    check(sum(r.fused_waves for r in runs["fused"][2]) > 0,
          "the fused backend served no wave")
    if cpu_check:
        for kind in ("fused", "light"):
            res, reps, _s = drive(make_fabric(mesh, kind, "cpu"), chunks)
            check([circuit_key(r.circuit) for r in res] == keys[kind],
                  f"{kind}: CUDA and plain CPU circuits differ")
            check([report_key(a, True) for a in reps]
                  == [report_key(b, True) for b in runs[kind][2]],
                  f"{kind}: CUDA and plain CPU reports differ")
    n = len(reqs)
    tel = {k: v[0].telemetry() for k, v in runs.items()}
    stats = {k: {"seconds": v[3],
                 "scheduled": tel[k]["scheduled"],
                 "fused_waves": tel[k]["fused_waves"],
                 "host_waves": tel[k]["host_waves"],
                 "conflicts": tel[k]["conflicts"]} for k, v in runs.items()}
    print(f"[slice] {n} transfers in {len(chunks)} flushes on "
          f"{mesh.X}x{mesh.Y}x{mesh.Z}/{n_slots}: fused == host == auto "
          f"circuits and reports, CUDA == plain CPU (fused, light); "
          f"{json.dumps(stats)}", flush=True)
    print(f"[launches] per path, each read right after its run: "
          f"{json.dumps(launches)}", flush=True)
    return stats, launches, keys


def phase_timing(mesh, device, chunks, keys, rounds=8, make=make_fabric,
                 key=circuit_key, label="timing", cycle_step=FLUSH_CYCLES):
    """µs per allocation of every path: ``rounds`` rounds, each running
    every path on a fresh fabric (``make``: a NomFabric on ``mesh``, or a
    FabricCluster on a topology), with the order rotated by one place per
    round (each path takes each place equally often when ``rounds`` is a
    multiple of the number of paths).  Returns path -> sorted samples."""
    n = sum(len(c) for c in chunks)
    samples = {k: [] for k in PATHS}
    for r in range(rounds):
        for k in PATHS[r % len(PATHS):] + PATHS[:r % len(PATHS)]:
            res, _reps, secs = drive(make(mesh, k, device), chunks,
                                     cycle_step)
            check([key(x.circuit) for x in res] == keys[k],
                  f"{k}: circuits differ from the checked run")
            samples[k].append(secs / n * 1e6)
    out = {k: sorted(v) for k, v in samples.items()}
    print(f"[{label}] us/alloc median (min-max) over "
          f"{rounds} rotated rounds: " + "; ".join(
              f"{k} {np.median(v):.2f} ({v[0]:.2f}-{v[-1]:.2f})"
              for k, v in out.items()), flush=True)
    return out


def kernel_scoring(avail, dists, t_readys, device):
    """One split-pipeline scoring round on the scoring kernel: a (3, B)
    int32 upload, one launch, a (B, n_slots) pull and the argmin, with
    ``_best_slots_np``'s contract (a denied row's start cycle aside)."""
    import torch
    from repro_torch.kernels.slot_alloc import fused as kf
    req = torch.from_numpy(np.stack([
        np.asarray(avail, np.uint32).view(np.int32),
        np.asarray(dists, np.int32),
        np.asarray(t_readys, np.int32)])).to(device)
    cost = kf.slot_score(req[0], req[1], req[2],
                         n_slots=N_SLOTS).cpu().numpy()
    a = cost.argmin(1)
    free = cost != kf.FAR32
    return (cost[np.arange(len(cost)), a].astype(np.int64), a, free,
            ~free.any(1))


def phase_scoring(mesh, device, host_rounds: int,
                  batches=(WAVE, 2 * WAVE), reps=200, blocks=7):
    """Why the split pipeline scores on the host: host time of one
    scoring round on the scoring kernel (:func:`kernel_scoring`) against
    the reference's numpy scoring (``_best_slots_np``, what the
    allocator runs), on the availability vectors of a real search round
    (2 x 64 rows is NoM-Light's cross-layer round: both phase orders).
    Blocks of ``reps`` calls alternate between the two; returns the
    medians.  ``host_rounds`` is the count of device-searched rounds of
    the host path's run, the rounds the kernel would score."""
    import torch
    from repro_torch.core import PORT_LOCAL
    from repro_torch.core.bitvec import packed_numpy, packed_tensor
    from repro_torch.core.slot_alloc import _best_slots_np
    from repro_torch.kernels.slot_alloc import slot_alloc as ks
    rng = np.random.default_rng(SEED + 1)
    occ, _alloc = occupied_table(mesh, N_SLOTS, device)
    occ_np = packed_numpy(occ)
    out = {}
    for B in batches:
        s, d, _init, _t, srcs_np, dsts_np = kernel_inputs(
            mesh, N_SLOTS, B, device, rng)
        init = packed_tensor(np.zeros(B, np.uint32), device)   # as a wave
        vecs = packed_numpy(ks.wavefront_search_packed(
            occ, s, d, init, mesh=mesh, n_slots=N_SLOTS))
        avail = vecs[np.arange(B), dsts_np] | occ_np[dsts_np, PORT_LOCAL]
        dists = np.abs(mesh.coord_array[srcs_np]
                       - mesh.coord_array[dsts_np]).sum(1)
        t = rng.integers(3, 2 ** 20, size=B)
        arms = {"kernel": lambda: kernel_scoring(avail, dists, t, device),
                "numpy": lambda: _best_slots_np(avail, dists, t, N_SLOTS)}
        a, b = arms["kernel"](), arms["numpy"]()
        ok = ~b[3]                # a denied row's start cycle is unused
        check(all(np.array_equal(x, y) for x, y in zip(a[1:], b[1:]))
              and np.array_equal(a[0][ok], b[0][ok]),
              f"kernel and numpy scoring disagree at B={B}")
        times = {k: [] for k in arms}
        for _ in range(blocks):
            for k, fn in arms.items():
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                times[k].append((time.perf_counter() - t0) / reps * 1e6)
        out[B] = {k: float(np.median(v)) for k, v in times.items()}
    # The rounds the host path searched on the device (64-row waves) are
    # the ones the kernel would score.
    per_alloc = ((out[WAVE]["kernel"] - out[WAVE]["numpy"]) * host_rounds
                 / N_TRANSFERS)
    print("[scoring] host us per split-pipeline scoring round, median of "
          f"{blocks} alternating blocks: " + "; ".join(
              f"B={B} kernel {v['kernel']:.2f} numpy {v['numpy']:.2f}"
              for B, v in out.items())
          + f"; kernel scoring would add {per_alloc:.3f} us/alloc to the "
          "host path", flush=True)
    return out


def phase_host_calls(mesh, device, batches=(1, WAVE), reps=200, blocks=5):
    """Host µs per call of the allocator's two device calls, each ending
    with its result on the host: one fused wave (``fused_prepare_start``
    on the allocator's kind of side stream, then ``fused_prepare_wait``)
    and one search round (``TdmAllocator._run_search``: requests up, one
    launch, vectors down), at 1 and 64 requests on an unchanged
    occupancy table (so no occupancy upload).  Median of ``blocks``
    blocks of ``reps`` calls, the two calls in turns.  Uses only entry
    points the allocator calls, so it runs on any version of the port."""
    import torch
    from repro_torch.core import TdmAllocator
    from repro_torch.kernels.slot_alloc import fused as kf
    rng = np.random.default_rng(SEED + 2)
    occ, _alloc = occupied_table(mesh, N_SLOTS, device)
    search = TdmAllocator(mesh, N_SLOTS, use_kernels=True, device=str(device))
    occ_np = search.table.busy_masks(0)
    side = torch.cuda.Stream(device)
    out = {}
    for B in batches:
        srcs = rng.integers(mesh.n_nodes, size=B)
        dsts = rng.integers(mesh.n_nodes, size=B)
        t = rng.integers(3, 2 ** 20, size=B)
        inits = np.zeros(B, np.uint32)
        arms = {
            "fused": lambda: kf.fused_prepare_wait(kf.fused_prepare_start(
                occ, srcs, dsts, t, mesh=mesh, n_slots=N_SLOTS,
                stream=side)),
            "search": lambda: search._run_search(occ_np, 0, srcs, dsts,
                                                 inits)}
        times = {k: [] for k in arms}
        for fn in arms.values():
            fn()
        for _ in range(blocks):
            for k, fn in arms.items():
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                times[k].append((time.perf_counter() - t0) / reps * 1e6)
        out[B] = {k: float(np.median(v)) for k, v in times.items()}
    print("[host] us per call, median of "
          f"{blocks} alternating blocks of {reps}: " + "; ".join(
              f"B={B} fused start+wait {v['fused']:.2f}, search round "
              f"{v['search']:.2f}" for B, v in out.items()), flush=True)
    return out


def kernel_share(mesh, device, batches: dict, stats: dict, rows: dict):
    """The kernels' share of each path's wall time: every launch priced
    at the event time of its own batch size (``price_launches``)."""
    price = price_launches(mesh, device, batches, rows)
    share = {}
    for kind, per in batches.items():
        kern_ms = sum(v * price[k] for k, v in per.items())
        wall_ms = stats[kind]["seconds"] * 1e3
        share[kind] = (f"{kern_ms:.3f} ms of {wall_ms:.1f} ms "
                       f"({100 * kern_ms / wall_ms:.2f} %); launches by "
                       "batch " + ", ".join(
                           f"{k} B={b}: {v}" for (k, b), v in sorted(
                               per.items())))
    return share


def price_launches(mesh, device, batches: dict, rows: dict) -> dict:
    """Event ms of each (kernel, batch) the paths launched: from the
    timed rows where phase 2 timed that batch, else timed here on seeded
    requests of that size (16 slots, the paper mesh's real occupancy)."""
    occ = None
    rng = np.random.default_rng(SEED + 3)
    price = {}
    for key in sorted({k for per in batches.values() for k in per}):
        if key in rows:
            price[key] = rows[key]["ms"]
            continue
        if occ is None:
            occ, _alloc = occupied_table(mesh, N_SLOTS, device)
        name, B = key
        inputs = kernel_inputs(mesh, N_SLOTS, B, device, rng)
        price[key] = ms_per_call(slot_raw(mesh, N_SLOTS, occ, inputs, None,
                                          device)[name], 200, device)
    return price


# ---------------------------------------------------------------------------
# Phase 3: the model kernels (#4 flash attention, #6 RG-LRU scan)
# ---------------------------------------------------------------------------
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core rate
# (b, sq, sk, hq, hkv, d, causal, window, dtype, tol); the first is the
# model's prefill shape (recurrentgemma-9b, B=2 x S=4096), the next five
# test_flash_attention_sweep's, then odd ones: S not a block multiple,
# g=2 GQA, no window, fp32, Sk != Sq without causality; then the bf16
# (wgmma) kernel at every head dim with S not a block multiple, g=2 GQA,
# no window, a window crossing key blocks, one under a key block, and
# Sk != Sq without causality.  Every case but the model's has scale
# d ** -0.5 != 1.
FLASH_MODEL = (2, 4096, 4096, 16, 1, 256, True, 2048, "bfloat16", 2e-2)
FLASH_CASES = [
    FLASH_MODEL,
    (2, 256, 256, 4, 2, 64, True, None, "float32", 2e-5),
    (1, 200, 200, 4, 1, 64, True, 64, "float32", 2e-5),
    (2, 128, 384, 8, 8, 128, False, None, "float32", 2e-5),
    (1, 256, 256, 2, 2, 64, True, None, "bfloat16", 2e-2),
    (1, 96, 96, 4, 4, 32, True, 32, "float32", 2e-5),
    (1, 333, 333, 4, 2, 64, True, None, "float32", 2e-5),
    (1, 200, 200, 4, 2, 256, True, None, "float32", 2e-5),
    (2, 100, 150, 4, 2, 128, False, None, "float32", 2e-5),
    (1, 200, 200, 4, 2, 16, True, None, "bfloat16", 2e-2),
    (1, 333, 333, 4, 4, 32, True, 100, "bfloat16", 2e-2),
    (2, 300, 300, 8, 4, 128, True, 48, "bfloat16", 2e-2),
    (1, 200, 200, 4, 2, 256, True, None, "bfloat16", 2e-2),
    (2, 100, 150, 4, 2, 128, False, None, "bfloat16", 2e-2),
]
# At the model's shape an output row averages ~2048 keys, so a typical |o|
# is ~0.036 and 2e-2 is about half of it: there the kernel is also held,
# on the script's seed and five more, under FLASH_MODEL_TOL, set from two
# yardsticks and not from the kernel: the reference's own spread (the
# Pallas kernel in interpret mode against the plain version on the CPU,
# at a cut of this shape: up to 0.0039 on six seeds,
# tests/test_torch_model_kernels.py::test_flash_model_cut_spread, which
# holds it under the same bound) and |SDPA - plain| here (up to 0.0078).
# Both only flip the bf16 rounding of a few outputs: one ulp of an output
# in [1, 2) is 0.0078.
FLASH_MODEL_TOL = 1e-2
# The dense family's prefill shapes at head dim 128 (B=2 x S=4096, bf16,
# q pre-scaled, scale 1, as the models call the kernel): qwen1.5-4b's
# 20/20 heads (g=1), gemma3-27b's 32/16 (g=2) on its local layers'
# window of 1024 and on its global layers, qwen2.5-32b's 40/8 (g=5) and
# command-r-plus's 96/8 (g=12); each held against the plain version
# (2e-2, the bf16 sweep's), timed beside its bound and SDPA on the same
# mask.  qwen1.5-4b's is also held on the script's seed and five more
# under FLASH_DENSE_TOL, set as FLASH_MODEL_TOL was: from the
# reference's own spread at a cut of that shape (up to 0.0039 on six
# seeds, tests/test_torch_model_kernels.py::test_flash_dense_cut_spread,
# which holds it under the same bound), not from the kernel.
DENSE_FLASH = {
    "qwen1.5-4b": (2, 4096, 4096, 20, 20, 128, True, None, "bfloat16", 2e-2),
    "gemma3-27b local": (2, 4096, 4096, 32, 16, 128, True, 1024, "bfloat16",
                         2e-2),
    "gemma3-27b global": (2, 4096, 4096, 32, 16, 128, True, None,
                          "bfloat16", 2e-2),
    "qwen2.5-32b": (2, 4096, 4096, 40, 8, 128, True, None, "bfloat16", 2e-2),
    "command-r-plus-104b": (2, 4096, 4096, 96, 8, 128, True, None,
                            "bfloat16", 2e-2),
}
FLASH_DENSE_TOL = 1e-2
# command-r-plus-smoke's attention (B=2, S=80, 8/2 heads of 8) through
# the model-layout wrapper, which zero-pads D = 8 to the kernel's 16:
# against the same call on the CPU (the plain version), bf16 tolerance.
FLASH_SMALL_D = (2, 80, 8, 2, 8)
# (b, s, w, dtype, element offset of the views): the model's shape, then
# odd ones; each held bit-equal to the plain version.  The wrapper's rule
# (rglru_scan.plan) sends the first five to the TMA ring (S and W not
# tile multiples, batch 3, bf16) and the last two to the per-thread
# kernel (200-byte bf16 rows; a view 4 bytes off 16-byte alignment).
RGLRU_MODEL = (2, 4096, 4096, "float32", 0)
RGLRU_CASES = [RGLRU_MODEL, (2, 200, 128, "float32", 0),
               (3, 77, 100, "float32", 0), (1, 130, 128, "bfloat16", 0),
               (2, 300, 72, "bfloat16", 0), (3, 77, 100, "bfloat16", 0),
               (2, 100, 64, "float32", 1)]
# (b, s, h, hd, n, dtype, tol on max |d| / max |plain|, the sweep's own
# measure): the model's prefill shape (mamba2-130m, B=4 x S=8192), the
# four of test_ssd_scan_sweep, then S not a multiple of the chunk and the
# smoke model's heads, then a bf16 head dim outside the wgmma kernel's
# set (the CUDA-core kernel in bf16).  At the model's shape the
# fastest-decaying heads (A down to -24) have the smallest |y|, so each
# head is also held on its own: max |d| / max |plain| within the head <
# SSD_MODEL_TOL, on the script's seed and five more.  Kernel and plain
# both round fp32 sums to bf16, so a differing element is off by one bf16
# ulp, <= 2^-7 of the head's largest |y|: that measure cannot tell an
# exact kernel from one that rounds its fp32 operands to bf16.  So every
# bf16 case, and the model's shape on all six seeds, is also held to the
# plain version's fp32 result: by how much the kernel's bf16 output is
# off it beyond bf16's own rounding (``ref.rounding_excess``), under
# SSD_EXACT_TOL of the head's largest |y|.  All math in fp32 leaves only
# the fp32 rounding of sums taken in another order.
SSD_MODEL = (4, 8192, 24, 64, 128, "bfloat16", 5e-2)
SSD_MODEL_TOL = 1e-2
SSD_EXACT_TOL = 1e-5
SSD_CASES = [SSD_MODEL, (2, 256, 3, 32, 16, "float32", 1e-4),
             (1, 384, 2, 64, 128, "float32", 1e-4),
             (1, 256, 2, 32, 64, "float32", 1e-4),
             (1, 256, 2, 32, 16, "bfloat16", 5e-2),
             (2, 200, 3, 64, 128, "float32", 1e-4),
             (2, 80, 8, 16, 16, "float32", 1e-4),
             (2, 200, 3, 48, 128, "bfloat16", 5e-2)]
# Segment counts at which the wgmma kernel is timed at the model's shape,
# beside the wrapper's rule (ssd_scan.plan).
SSD_SEGMENT_SWEEP = range(1, 17)


def flash_work(b, sq, sk, hq, hkv, d, causal, window, dtype):
    """(bytes, FLOPs) the attention must move and do on these inputs:
    q, k, v read once, o written once; 4*d FLOPs per unmasked (q, k)
    pair (q.k and p.v)."""
    q = np.arange(sq)[:, None]
    k = np.arange(sk)[None, :]
    ok = np.ones((sq, sk), bool)
    if causal:
        ok &= k <= q
    if window is not None:
        ok &= q - k < window
    size = 2 if dtype == "bfloat16" else 4
    nbytes = (2 * b * hq * sq * d + 2 * b * hkv * sk * d) * size
    return nbytes, int(ok.sum()) * 4 * d * b * hq


def ssd_work(b, s, h, hd, n, dtype, chunk):
    """(bytes, bf16 FLOPs, fp32 FLOPs) of the SSD scan computed in chunks
    of q = ``chunk`` tokens: x, B, C, dt and A read once (B and C once per
    batch row, not per head), y written once.  Per (batch, head, chunk),
    over the q(q+1)/2 pairs j <= i only: 2 n per pair for C.B^T, which
    the tensor cores multiply exactly into fp32 when C and B are bf16, and
    2 hd per pair for M.x, whose M is fp32; then 4 q hd n for C.state^T
    and the state update, on the fp32 state.  The count grows with q: at
    q = 1 it is the token-by-token recurrence."""
    size = 2 if dtype == "bfloat16" else 4
    nbytes = (2 * b * s * h * hd + 2 * b * s * n) * size + b * s * h * 4 + h * 4
    chunks = b * h * (s // chunk)
    pairs = chunk * (chunk + 1) // 2
    cb, rest = chunks * pairs * 2 * n, chunks * (pairs * 2 * hd
                                                 + 4 * chunk * hd * n)
    return (nbytes, cb, rest) if dtype == "bfloat16" else (nbytes, 0, cb + rest)


# The rate of a product with one fp32 and one bf16 operand: the fp32 one
# split exactly into three bf16 pieces, one tensor-core pass each (the
# wgmma kernel's method; PR 14's count priced it at the CUDA-core rate).
SPLIT3_OPS_PER_S = BF16_OPS_PER_S / 3


def ssd_bound(case, fp32_rate=SPLIT3_OPS_PER_S):
    """The least time of the SSD scan: its bytes over the memory rate, or
    its operations over their types' rates, at the chunk that needs the
    fewest (q = 1, since the work grows with q), whichever is larger.
    The fp32-operand products go at ``fp32_rate``: a third of the bf16
    tensor rate for bf16 inputs (each fp32 operand in three exact bf16
    pieces), and for fp32 inputs, whose products would take nine, the
    CUDA-core rate.  ``ALU_OPS_PER_S`` gives PR 14's count.  Returns (ms,
    by, bytes, FLOPs)."""
    nbytes, ops16, ops32 = ssd_work(*case[:6], 1)
    if case[5] != "bfloat16":
        fp32_rate = ALU_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (ops16 / BF16_OPS_PER_S + ops32 / fp32_rate) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, ops16 + ops32)


def ssd_inputs(case, gen, device):
    """The sweep's distributions (dt ~ U(0.001, 0.1), B/C ~ 0.3 N(0, 1),
    A = -exp(U(-1, 1))), with x, B and C column views of one (b, S,
    H * hd + 2n) tensor, as the model passes them; at the model's shape
    A = -(1 .. H), the model's init."""
    import torch
    b, s, h, hd, n, dtype = case[:6]
    xbc = torch.randn((b, s, h * hd + 2 * n), generator=gen, device=device)
    xbc[..., h * hd:] *= 0.3
    xbc = xbc.to(getattr(torch, dtype))
    dt = torch.rand((b, s, h), generator=gen, device=device) * 0.099 + 0.001
    A = (-torch.arange(1, h + 1, dtype=torch.float32, device=device)
         if case is SSD_MODEL else
         -torch.exp(torch.rand((h,), generator=gen, device=device) * 2 - 1))
    return (xbc[..., :h * hd].unflatten(-1, (h, hd)), dt,
            xbc[..., h * hd:h * hd + n], xbc[..., h * hd + n:], A)


def bound(nbytes: float, ops: float, ops_per_s: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def ssd_checks(device, gen, rows) -> float:
    """The SSD scan's part of :func:`phase_model_kernels`: every SSD_CASES
    case against the plain version, the model's shape timed (with the
    wgmma kernel at SSD_SEGMENT_SWEEP's segment counts) and held on five
    more seeds, every bf16 result held to SSD_EXACT_TOL once all are
    printed.  Adds the ``ssd_scan`` row to ``rows``; returns the largest
    |kernel - plain|."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import (CHUNK, rounding_excess,
                                                  ssd_scan_plain)
    from repro_torch.kernels.ssd_scan.ssd_scan import launch as ssd_launch
    from repro_torch.kernels.ssd_scan.ssd_scan import plan as ssd_plan
    err_ssd = 0.0
    sms = torch.cuda.get_device_properties(device).multi_processor_count

    def ssd_run(args):
        """The kernel's output, the plain version's in fp32 (with the
        kernel's segments; its bf16 output is this rounded) and the
        (kernel, segments) that the wrapper's rule gave the call."""
        s = args[0].shape[1]
        pad = (-s) % CHUNK
        seen = [F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) if pad else t
                for t in args[:4]]
        x, _, B, C = seen
        how = ssd_plan(x.dtype, x.shape[3], B.shape[2],
                       (*x.stride()[:3], *B.stride()[:2], *C.stride()[:2]),
                       (x.data_ptr(), B.data_ptr(), C.data_ptr()),
                       batch=x.shape[0], heads=x.shape[2], seq=s + pad,
                       sms=sms)
        got = ssd_scan(*args)
        want32 = ssd_scan_plain(*(t.float() for t in seen), args[4],
                                segments=how[1])[:, :s]
        return got, want32, how

    def worst_head(got, want):
        """max |d| / max |plain| within each head, the worst head's."""
        d, w = (got.float() - want.float()).abs(), want.float().abs()
        return (d.amax((0, 1, 3)) / w.amax((0, 1, 3))).max().item(), d, w

    exact = []      # (what, rounding excess): held once all are printed
    for case in SSD_CASES:
        b, s, h, hd, n, dtype, tol = case
        args = ssd_inputs(case, gen, device)
        got, want32, how = ssd_run(args)
        want = want32.to(got.dtype)
        err = float((got.float() - want.float()).abs().max())
        rel = err / float(want.float().abs().max())
        check(math.isfinite(rel) and rel < tol and got.shape == want.shape,
              f"ssd_scan != plain at {case}: relative {rel}")
        err_ssd = max(err_ssd, err)
        line = (f"[kernels] ssd_scan b={b} s={s} h={h} hd={hd} n={n} "
                f"{dtype} on the {how[0]} kernel in {how[1]} segment(s): "
                f"max |kernel - plain| {err:.3g}, / max |plain| {rel:.3g} "
                f"< {tol}")
        if dtype == "bfloat16":
            excess = rounding_excess(got, want32).max().item()
            exact.append((f"{case[:5]} on the {how[0]} kernel", excess))
            line += f"; rounding excess {excess:.3g}"
        if case is SSD_MODEL:
            head, d, w = worst_head(got, want)
            seeds = [(SEED, head, excess)]
            line += (f"; worst head {head:.3g}; mean |plain| "
                     f"{w.mean().item():.4g}, mean |d| / mean |plain| "
                     f"{(d.mean() / w.mean()).item():.3g}")
            del d, w
            bnd, by, nbytes, ops = ssd_bound(case)
            old_bnd, old_by, _, _ = ssd_bound(case, ALU_OPS_PER_S)
            _, k16, k32 = ssd_work(*case[:6], CHUNK)
            k_ms = (k16 / BF16_OPS_PER_S + k32 / SPLIT3_OPS_PER_S) * 1e3
            segs = how[1]
            rows["ssd_scan"] = {
                "ms": ms_per_call(lambda: ssd_scan(*args), 20, device),
                "plain_ms": ms_per_call(
                    lambda: ssd_scan_plain(*args, segments=segs), 3, device),
                "library_ms": None, "bound_ms": bnd, "bound_by": by,
                "bytes": nbytes, "ops": ops}
            ms = rows["ssd_scan"]["ms"]
            line += (f"; kernel {ms:.4g} ms, plain "
                     f"{rows['ssd_scan']['plain_ms']:.4g} ms, bound "
                     f"{bnd:.4g} ms by {by} (fp32-operand products at a "
                     f"third of the bf16 tensor rate; {ms / bnd:.3g}x) and "
                     f"PR 14's count {old_bnd:.4g} ms by {old_by} (at the "
                     f"CUDA-core rate; {ms / old_bnd:.3g}x); "
                     f"{nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP at chunk "
                     f"1; the operations at the kernel's chunk {CHUNK} take "
                     f"{k_ms:.4g} ms")
            # The wgmma kernel at other segment counts than the rule's.
            sweep = {k: ms_per_call(lambda k=k: ssd_launch(
                *args, "wgmma", k), 20, device) for k in SSD_SEGMENT_SWEEP}
            line += (f"; by segment count (the rule's {segs}): " + ", ".join(
                f"{k}: {t:.4g} ms" for k, t in sweep.items()))
        print(line, flush=True)
        del args, got, want, want32
    # The model's shape on five more seeds.
    for seed in range(SEED + 1, SEED + 6):
        args = ssd_inputs(SSD_MODEL, torch.Generator(device).manual_seed(seed),
                          device)
        got, want32, _ = ssd_run(args)
        want = want32.to(got.dtype)
        seeds.append((seed, worst_head(got, want)[0],
                      rounding_excess(got, want32).max().item()))
        exact.append((f"the model's shape on seed {seed}", seeds[-1][2]))
        err_ssd = max(err_ssd, float((got.float() - want.float()).abs().max()))
        del args, got, want, want32
    print(f"[kernels] ssd_scan at the model's shape on seeds {SEED}-"
          f"{SEED + 5}: worst head {[round(h, 6) for _, h, _ in seeds]}, "
          f"each held < {SSD_MODEL_TOL}; rounding excess "
          f"{[float(f'{e:.3g}') for _, _, e in seeds]}", flush=True)
    print(f"[kernels] ssd_scan bf16 rounding excess, each held < "
          f"{SSD_EXACT_TOL}: " + ", ".join(f"{what} {e:.3g}"
                                          for what, e in exact), flush=True)
    for seed, head, _ in seeds:
        check(math.isfinite(head) and head < SSD_MODEL_TOL,
              f"ssd_scan != plain at the model's shape on seed {seed}: worst "
              f"head {head} >= {SSD_MODEL_TOL}")
    for what, e in exact:
        check(math.isfinite(e) and e < SSD_EXACT_TOL,
              f"ssd_scan's bf16 output at {what} is off its plain version's "
              f"fp32 result by more than bf16's rounding: excess {e} >= "
              f"{SSD_EXACT_TOL}")
    return err_ssd


RGLRU_HOST_PASSES = 5


def rglru_checks(device, gen, rows) -> float:
    """The RG-LRU scan on every ``RGLRU_CASES`` entry, bit-equal to its
    plain version, with the kernel and tile the wrapper's rule took; at
    the model's shape its time beside the bound, the plain version, one
    elementwise pass over the same bytes (``torch.add(a, b)``: the card's
    practical rate for them, not the same function), the per-thread
    kernel (bit-equal too) and the host time of a call on each kernel.
    Returns the largest |kernel - plain| (0 where all are equal)."""
    import torch
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_plain
    from repro_torch.kernels.rglru_scan.rglru_scan import (TMA_TILE, launch,
                                                           plan)
    err_rg = 0.0
    for case in RGLRU_CASES:
        b, s, w, dtype, offset = case
        td = getattr(torch, dtype)

        def view(x):
            flat = torch.empty(x.numel() + offset, device=device, dtype=td)
            return flat[offset:].view(x.shape).copy_(x)
        a = view(torch.rand((b, s, w), generator=gen, device=device) * 0.299
                 + 0.7)
        bb = view(torch.randn((b, s, w), generator=gen, device=device) * 0.1)
        kernel = plan(td, w, (a.data_ptr(), bb.data_ptr()))
        got, want = rglru_scan(a, bb), rglru_scan_plain(a, bb)
        err = float((got.float() - want.float()).abs().max())
        check(torch.equal(got, want),
              f"rglru_scan != plain at {case}: max |d| {err}")
        err_rg = max(err_rg, err)
        line = (f"[kernels] rglru_scan b={b} s={s} w={w} {dtype} offset "
                f"{offset}: kernel {kernel}"
                + (" C={} D={} K={}".format(*TMA_TILE[td])
                   if kernel == "tma" else "")
                + ", bit-equal to plain")
        if case is RGLRU_MODEL:
            nbytes, ops = 3 * a.numel() * a.element_size(), 2 * a.numel()
            bnd, by = bound(nbytes, ops, ALU_OPS_PER_S)
            out = torch.empty_like(a)
            rows["rglru_scan"] = {
                "ms": ms_per_call(lambda: rglru_scan(a, bb), 20, device),
                "plain_ms": ms_per_call(lambda: rglru_scan_plain(a, bb), 2,
                                        device),
                "library_ms": None, "bound_ms": bnd, "bound_by": by,
                "bytes": nbytes, "ops": ops}
            add_ms = ms_per_call(lambda: torch.add(a, bb, out=out), 20,
                                 device)
            check(torch.equal(launch(a, bb, "ldg"), got),
                  "rglru_scan's per-thread kernel != plain at the model's "
                  "shape")
            ldg_ms = ms_per_call(lambda: launch(a, bb, "ldg"), 20, device)
            line += (f"; kernel {rows['rglru_scan']['ms']:.4g} ms, plain "
                     f"{rows['rglru_scan']['plain_ms']:.4g} ms, bound "
                     f"{bnd:.4g} ms by {by}; torch.add over the same "
                     f"{nbytes / 1e6:.0f} MB {add_ms:.4g} ms "
                     f"({nbytes / add_ms / 1e9:.4g} TB/s, the kernel "
                     f"{nbytes / rows['rglru_scan']['ms'] / 1e9:.4g} TB/s); "
                     f"per-thread kernel {ldg_ms:.4g} ms")
            host = {"tma": [], "ldg": []}
            for _ in range(RGLRU_HOST_PASSES):
                for k in host:
                    torch.cuda.synchronize(device)
                    t0 = time.perf_counter()
                    for _ in range(10):
                        launch(a, bb, k)
                    host[k].append((time.perf_counter() - t0) * 1e6 / 10)
            torch.cuda.synchronize(device)
            host = {k: float(np.median(v)) for k, v in host.items()}
            line += (f"; host us per call (enqueue, median of "
                     f"{RGLRU_HOST_PASSES} x 10) tma {host['tma']:.1f}, ldg "
                     f"{host['ldg']:.1f}")
            del out
        print(line, flush=True)
        del a, bb, got, want
    return err_rg


def flip_stats(diff, want) -> tuple[float, float]:
    """(share of the outputs where kernel and plain differ, the largest
    |plain| among them): one bf16 ulp of an output under 2 in magnitude is
    at most 2^-7 = 0.0078, under FLASH_MODEL_TOL."""
    flip = diff > 0
    return (float(flip.float().mean()),
            float(want.float().abs()[flip].max()) if flip.any() else 0.0)


def phase_model_kernels(device):
    """Flash attention, the RG-LRU scan and the SSD scan against their
    plain versions on the card, at the models' shapes and at odd ones;
    times at the models' shapes (CUDA events), with SDPA on the same
    boolean causal+window mask as the library time of the attention.
    Returns the kernel-table rows and each kernel's largest |kernel -
    plain|."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.flash_attention.ref import (
        BLOCK_K, BLOCK_Q, flash_attention_plain)
    gen = torch.Generator(device).manual_seed(SEED)
    rows = {}
    err_fa = 0.0

    def flash_inputs(case, gen):
        b, sq, sk, hq, hkv, d = case[:6]
        td = getattr(torch, case[8])
        q = torch.randn((b, hq, sq + (-sq) % BLOCK_Q, d), generator=gen,
                        device=device)
        if case is FLASH_MODEL:
            q = q * d ** -0.5           # the model scales q before the kernel
        k, v = (torch.randn((b, hkv, sk + (-sk) % BLOCK_K, d), generator=gen,
                            device=device).to(td) for _ in range(2))
        return q.to(td), k, v

    for case in FLASH_CASES:
        b, sq, sk, hq, hkv, d, causal, window, dtype, tol = case
        scale = 1.0 if case is FLASH_MODEL else d ** -0.5
        q, k, v = flash_inputs(case, gen)
        kw = dict(causal=causal, window=window, scale=scale, seq_k=sk)
        got = flash_attention_fwd(q, k, v, **kw)
        want = flash_attention_plain(q, k, v, **kw)
        diff = (got[:, :, :sq].float() - want[:, :, :sq].float()).abs()
        err = float(diff.max())
        check(math.isfinite(err) and err < tol,
              f"flash_attention != plain at {case}: {err}")
        err_fa = max(err_fa, err)
        line = (f"[kernels] flash_attention b={b} sq={sq} sk={sk} hq={hq} "
                f"hkv={hkv} d={d} causal={causal} window={window} {dtype}: "
                f"max |kernel - plain| {err:.3g} < {tol}")
        if case is FLASH_MODEL:
            check(err < FLASH_MODEL_TOL, f"flash_attention != plain at the "
                  f"model's shape: {err} >= {FLASH_MODEL_TOL}")
            flips = [flip_stats(diff, want[:, :, :sq])]
            line += (f" and < {FLASH_MODEL_TOL} (mean |plain| "
                     f"{float(want[:, :, :sq].float().abs().mean()):.3g})")
            nbytes, ops = flash_work(*case[:9])
            bnd, by = bound(nbytes, ops, BF16_OPS_PER_S)
            qp = torch.arange(q.shape[2], device=device)[:, None]
            kp = torch.arange(k.shape[2], device=device)[None, :]
            mask = (kp <= qp) & (qp - kp < window) & (kp < sk)
            ke, ve = k.expand(-1, hq, -1, -1), v.expand(-1, hq, -1, -1)
            sdpa = F.scaled_dot_product_attention(q, ke, ve, attn_mask=mask,
                                                  scale=scale)
            sdpa_err = float((sdpa[:, :, :sq].float()
                              - want[:, :, :sq].float()).abs().max())
            rows["flash_attention"] = {
                "ms": ms_per_call(lambda: flash_attention_fwd(q, k, v, **kw),
                                  10, device),
                "plain_ms": ms_per_call(
                    lambda: flash_attention_plain(q, k, v, **kw), 3, device),
                "library_ms": ms_per_call(
                    lambda: F.scaled_dot_product_attention(
                        q, ke, ve, attn_mask=mask, scale=scale), 10, device),
                "bound_ms": bnd, "bound_by": by, "bytes": nbytes,
                "ops": ops}
            line += (f"; kernel {rows['flash_attention']['ms']:.4g} ms, plain "
                     f"{rows['flash_attention']['plain_ms']:.4g} ms, SDPA "
                     f"{rows['flash_attention']['library_ms']:.4g} ms "
                     f"(|SDPA - plain| {sdpa_err:.3g}), bound {bnd:.4g} ms "
                     f"by {by}")
            del sdpa, mask, ke, ve
        print(line, flush=True)
        del q, k, v, got, want, diff
    # The model's shape on five more seeds, held under FLASH_MODEL_TOL
    # after all are printed: the scores' last bits (tensor-core sums
    # against the plain version's fp32 ones) flip the bf16 rounding of a
    # few probabilities, which moves ~0.8 % of the outputs by one bf16 ulp.
    kw = dict(causal=True, window=FLASH_MODEL[7], scale=1.0,
              seq_k=FLASH_MODEL[2])
    errs, sq = [], FLASH_MODEL[1]
    sdpa_errs = [sdpa_err]           # the script's seed, then five more
    for seed in range(SEED + 1, SEED + 6):
        q, k, v = flash_inputs(FLASH_MODEL,
                               torch.Generator(device).manual_seed(seed))
        got = flash_attention_fwd(q, k, v, **kw)[:, :, :sq].float()
        want = flash_attention_plain(q, k, v, **kw)[:, :, :sq].float()
        errs.append(float((got - want).abs().max()))
        flips.append(flip_stats((got - want).abs(), want))
        qp = torch.arange(q.shape[2], device=device)[:, None]
        kp = torch.arange(k.shape[2], device=device)[None, :]
        mask = (kp <= qp) & (qp - kp < kw["window"]) & (kp < kw["seq_k"])
        hq = FLASH_MODEL[3]
        sdpa = F.scaled_dot_product_attention(
            q, k.expand(-1, hq, -1, -1), v.expand(-1, hq, -1, -1),
            attn_mask=mask, scale=1.0)[:, :, :sq].float()
        sdpa_errs.append(float((sdpa - want).abs().max()))
        del q, k, v, got, want, sdpa, mask
    print(f"[kernels] flash_attention at the model's shape on seeds "
          f"{SEED + 1}-{SEED + 5}: max |kernel - plain| {errs} < "
          f"{FLASH_MODEL_TOL}; |SDPA - plain| on seeds {SEED}-{SEED + 5}: "
          f"{sdpa_errs}; on seeds {SEED}-{SEED + 5}, the share of the "
          f"kernel's outputs that differ from plain "
          f"{[float(f'{f:.4g}') for f, _ in flips]} and the largest |plain| "
          f"among them {[float(f'{m:.4g}') for _, m in flips]}", flush=True)
    check(all(e < FLASH_MODEL_TOL for e in errs),
          f"flash_attention != plain at the model's shape on seeds "
          f"{SEED + 1}-{SEED + 5}: {errs}, bound {FLASH_MODEL_TOL}")
    err_fa = max(err_fa, dense_flash_checks(device, gen, rows))
    err_rg = rglru_checks(device, gen, rows)
    err_ssd = ssd_checks(device, gen, rows)
    torch.cuda.empty_cache()
    return rows, {"flash_attention": err_fa, "rglru_scan": err_rg,
                  "ssd_scan": err_ssd}


def dense_flash_checks(device, gen, rows) -> float:
    """Flash attention at the dense family's head-dim-128 shapes
    (DENSE_FLASH) against the plain version, each timed beside its bound
    and SDPA on the same boolean mask (the KV heads repeated for each
    q-head group); qwen1.5-4b's on five more seeds under FLASH_DENSE_TOL;
    and command-r-plus-smoke's D = 8 through the model-layout wrapper
    against the same call on the CPU.  Adds the times to the kernel
    table's row (``dense``); returns the largest |kernel - plain|."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _lib
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_fwd)
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    err_max, dense = 0.0, {}

    def inputs(case, g):
        b, sq, sk, hq, hkv, d = case[:6]
        td = getattr(torch, case[8])
        q = torch.randn((b, hq, sq, d), generator=g, device=device) * d ** -0.5
        k, v = (torch.randn((b, hkv, sk, d), generator=g, device=device)
                for _ in range(2))
        return q.to(td), k.to(td), v.to(td)

    def kwargs(case):
        return dict(causal=case[6], window=case[7], scale=1.0, seq_k=case[2])

    for label, case in DENSE_FLASH.items():
        b, sq, sk, hq, hkv, d, causal, window, dtype, tol = case
        q, k, v = inputs(case, gen)
        kw = kwargs(case)
        got = flash_attention_fwd(q, k, v, **kw)
        want = flash_attention_plain(q, k, v, **kw)
        err = float((got.float() - want.float()).abs().max())
        check(math.isfinite(err) and err < tol,
              f"flash_attention != plain at {label} {case}: {err}")
        err_max = max(err_max, err)
        qp = torch.arange(sq, device=device)[:, None]
        kp = torch.arange(sk, device=device)[None, :]
        mask = kp <= qp
        if window is not None:
            mask &= qp - kp < window
        ke, ve = (x.repeat_interleave(hq // hkv, dim=1) for x in (k, v))
        sdpa_err = float((F.scaled_dot_product_attention(
            q, ke, ve, attn_mask=mask, scale=1.0).float()
            - want.float()).abs().max())
        nbytes, ops = flash_work(*case[:9])
        bnd, by = bound(nbytes, ops, BF16_OPS_PER_S)
        row = {"shape": list(case[:9]), "max_abs_err": err,
               "ms": ms_per_call(lambda: flash_attention_fwd(q, k, v, **kw),
                                 10, device),
               "plain_ms": ms_per_call(
                   lambda: flash_attention_plain(q, k, v, **kw), 3, device),
               "library_ms": ms_per_call(
                   lambda: F.scaled_dot_product_attention(
                       q, ke, ve, attn_mask=mask, scale=1.0), 10, device),
               "bound_ms": bnd, "bound_by": by}
        dense[label] = row
        print(f"[kernels] flash_attention {label} b={b} sq={sq} hq={hq} "
              f"hkv={hkv} (g={hq // hkv}) d={d} window={window} {dtype}: "
              f"max |kernel - plain| {err:.3g} < {tol}; kernel "
              f"{row['ms']:.4g} ms, plain {row['plain_ms']:.4g} ms, SDPA "
              f"{row['library_ms']:.4g} ms (|SDPA - plain| {sdpa_err:.3g}), "
              f"bound {bnd:.4g} ms by {by} (kernel at "
              f"{row['ms'] / bnd:.3g}x)", flush=True)
        del q, k, v, got, want, ke, ve, mask
    case = DENSE_FLASH["qwen1.5-4b"]
    errs = []
    for seed in range(SEED + 1, SEED + 6):
        q, k, v = inputs(case, torch.Generator(device).manual_seed(seed))
        errs.append(float((flash_attention_fwd(q, k, v, **kwargs(case))
                           .float() - flash_attention_plain(
                               q, k, v, **kwargs(case)).float())
                          .abs().max()))
        del q, k, v
    errs.insert(0, dense["qwen1.5-4b"]["max_abs_err"])
    print(f"[kernels] flash_attention at qwen1.5-4b's shape on seeds "
          f"{SEED}-{SEED + 5}: max |kernel - plain| {errs} < "
          f"{FLASH_DENSE_TOL}", flush=True)
    check(all(e < FLASH_DENSE_TOL for e in errs),
          f"flash_attention != plain at qwen1.5-4b's shape: {errs}, bound "
          f"{FLASH_DENSE_TOL}")
    b, s, hq, hkv, d = FLASH_SMALL_D
    q = torch.randn((b, s, hq, d), generator=gen, device=device).bfloat16()
    k, v = (torch.randn((b, s, hkv, d), generator=gen, device=device)
            .bfloat16() for _ in range(2))
    before = _lib.launch_counts["flash_attention"]
    got = flash_attention(q, k, v, scale=1.0)
    launched = _lib.launch_counts["flash_attention"] - before
    want = flash_attention(q.cpu(), k.cpu(), v.cpu(), scale=1.0)
    err = float((got.cpu().float() - want.float()).abs().max())
    check(launched == 1 and tuple(got.shape) == (b, s, hq, d)
          and err < 2e-2, f"flash_attention at D={d} through the wrapper: "
          f"{launched} launches, shape {tuple(got.shape)}, max |kernel - "
          f"plain| {err}")
    print(f"[kernels] flash_attention command-r-plus-smoke b={b} s={s} "
          f"hq={hq} hkv={hkv} d={d} through the model-layout wrapper (D "
          f"zero-padded to 16), bf16: max |card - CPU plain| {err:.3g} < "
          f"2e-2, one launch", flush=True)
    rows["flash_attention"]["dense"] = dense
    return max(err_max, err)


# ---------------------------------------------------------------------------
# Phase 6: memsim, the paper's Fig. 4 comparison
# ---------------------------------------------------------------------------
# The settings of tests/test_memsim_claims.py: the four Fig. 4 workloads,
# 900 requests from seed 1, SimParams() defaults (the paper mesh, 16
# slots) under each of the four configs.
FIG4_WORKLOADS = ("fork", "fileCopy20", "fileCopy40", "fileCopy60")
FIG4_REQUESTS, FIG4_SEED = 900, 1
# The paper's bands as tests/test_memsim_claims.py asserts them: NoM over
# conventional (paper: 3.8x) and over RowClone (1.75x) as geomeans of the
# per-workload IPC ratios, open intervals; NoM-Light's gap to NoM per
# workload (paper: 5-20 %), closed.
FIG4_VS_CONVENTIONAL = (2.5, 6.5)
FIG4_VS_ROWCLONE = (1.25, 2.4)
FIG4_LIGHT_GAP = (0.0, 0.25)
# The multi-stack runs: 4 stacks (ring, the SerDes defaults) over 1024
# banks.  NoM-Light cannot route gradAgg40's cross-layer fan-ins
# (LIGHT_RAISES) and raises, as the reference does.
STACKED_RUNS = (("fileCopy60", "nom"), ("fileCopy60", "nom_light"),
                ("gradAgg40", "nom"), ("gradAgg40", "nom_light"))
STACKED_BANKS = 1024
LIGHT_RAISES = ("gradAgg40", "nom_light")
LIGHT_REDUCE_ERROR = "NoM-Light reduce requires same-layer sources"


def fig4_bands(results) -> list[str]:
    """Where ``results[workload][config]`` (SimResults) leave the paper's
    bands: the ordering NoM > RowClone > conventional per workload, both
    speedup geomeans and the NoM-Light gap.  Empty when all hold."""
    def gm(xs):
        return float(np.exp(np.mean(np.log(xs))))
    bad = []
    for wl, r in results.items():
        if not r["nom"].ipc > r["rowclone"].ipc > r["conventional"].ipc:
            bad.append(f"{wl}: IPC not nom > rowclone > conventional")
        gap = 1 - r["nom_light"].ipc / r["nom"].ipc
        if not FIG4_LIGHT_GAP[0] <= gap <= FIG4_LIGHT_GAP[1]:
            bad.append(f"{wl}: NoM-Light gap {gap} outside {FIG4_LIGHT_GAP}")
    for base, (lo, hi) in (("conventional", FIG4_VS_CONVENTIONAL),
                           ("rowclone", FIG4_VS_ROWCLONE)):
        g = gm([r["nom"].ipc / r[base].ipc for r in results.values()])
        if not lo < g < hi:
            bad.append(f"NoM over {base}: geomean {g} outside ({lo}, {hi})")
    return bad


def simulate_twice(reqs, params, name, device):
    """``simulate`` on the card, the launch counts set to 0 just before
    and read just after, then on the CPU (the plain versions): the two
    ``SimResult``s (``extra`` in full) and energies must be equal.
    Returns (result, wall ms on the card, launches)."""
    import torch
    from repro_torch.kernels import _lib
    from repro_torch.memsim import energy_pj, simulate
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    res = simulate(reqs, params, name=name, device=device)
    torch.cuda.synchronize(device)
    ms = (time.perf_counter() - t0) * 1e3
    launches = dict(_lib.launch_counts)
    cpu = simulate(reqs, params, name=name, device="cpu")
    check(dataclasses.asdict(res) == dataclasses.asdict(cpu),
          f"memsim {name}/{params.config} (stacks {params.stacks}): card "
          f"and CPU results differ")
    check(energy_pj(res) == energy_pj(cpu),
          f"memsim {name}/{params.config}: card and CPU energies differ")
    return res, ms, launches


def memsim_line(label: str, runs: dict) -> str:
    """One printed line for one config: per workload its IPC, cycles,
    CCU waves (fused, host), cross-stack copies, wall ms on the card and
    kernel launches (all kernels, counted from 0 for the run)."""
    return f"[memsim] {label}: " + "; ".join(
        f"{wl} ipc {r.ipc:.6g} cycles {r.cycles} fused/host waves "
        f"{r.extra.get('nom_fused_waves', '-')}/"
        f"{r.extra.get('nom_host_waves', '-')} cross-stack "
        f"{r.extra.get('nom_cross_stack', '-')} {ms:.1f} ms launches "
        f"{sum(launches.values())}"
        for wl, (r, ms, launches) in runs.items())


def phase_memsim(device) -> dict:
    """The Fig. 4 runs and the 4-stack runs, each on the card and on the
    CPU (equal results and energies); the paper's bands on the card's
    results; launches per run.  Returns per-path launches, summed over
    each config's runs: "memsim-<config>" and "memsim-4stack-<config>"."""
    from repro_torch.memsim import (CONFIGS, SimParams, WorkloadSpec,
                                    generate, simulate)
    launches, fig4 = {}, {}
    for cfg in CONFIGS:
        runs = {}
        for wl in FIG4_WORKLOADS:
            reqs = generate(WorkloadSpec(wl, n_requests=FIG4_REQUESTS,
                                         seed=FIG4_SEED))
            runs[wl] = simulate_twice(reqs, SimParams(config=cfg), wl, device)
            fig4.setdefault(wl, {})[cfg] = runs[wl][0]
        launches[f"memsim-{cfg}"] = sum_counts(l for _r, _m, l in
                                               runs.values())
        print(memsim_line(cfg, runs), flush=True)
    bad = fig4_bands(fig4)
    check(not bad, f"the paper's Fig. 4 bands fail on the card: {bad}")
    stacked: dict = {}
    for wl, cfg in STACKED_RUNS:
        reqs = generate(WorkloadSpec(wl, n_requests=FIG4_REQUESTS,
                                     seed=FIG4_SEED, n_banks=STACKED_BANKS))
        params = SimParams(config=cfg, stacks=4)
        if (wl, cfg) == LIGHT_RAISES:
            for dev in (device, "cpu"):
                try:
                    simulate(reqs, params, name=wl, device=dev)
                except ValueError as exc:
                    check(str(exc).startswith(LIGHT_REDUCE_ERROR),
                          f"{wl}/{cfg}: unexpected error {exc}")
                else:
                    raise SmokeFailure(f"{wl}/{cfg} on {dev}: NoM-Light "
                                       "routed cross-layer fan-ins")
            print(f"[memsim] 4 stacks {cfg} {wl}: ValueError "
                  f"({LIGHT_REDUCE_ERROR} ...) on the card and the CPU, "
                  "as the reference", flush=True)
            continue
        stacked.setdefault(cfg, {})[wl] = simulate_twice(reqs, params, wl,
                                                         device)
    for cfg, runs in stacked.items():
        launches[f"memsim-4stack-{cfg}"] = sum_counts(
            l for _r, _m, l in runs.values())
        print(memsim_line(f"4 stacks x {STACKED_BANKS // 4} banks {cfg}",
                          runs), flush=True)
    gm = {base: float(np.exp(np.mean(np.log(
        [r["nom"].ipc / r[base].ipc for r in fig4.values()]))))
        for base in ("conventional", "rowclone")}
    print(f"[memsim] Fig. 4 on the card == CPU, bands hold: NoM over "
          f"conventional {gm['conventional']:.4f} (band "
          f"{FIG4_VS_CONVENTIONAL}), over RowClone {gm['rowclone']:.4f} "
          f"(band {FIG4_VS_ROWCLONE}), NoM-Light gap "
          + ", ".join(f"{wl} {1 - r['nom_light'].ipc / r['nom'].ipc:.4f}"
                      for wl, r in fig4.items())
          + f" (band {FIG4_LIGHT_GAP})", flush=True)
    print(f"[launches] memsim per config, counts set to 0 before each run: "
          f"{json.dumps(launches)}", flush=True)
    return launches


def sum_counts(counts) -> dict:
    out: dict = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


# ---------------------------------------------------------------------------
# Phase 7: the multi-stack CCU (FabricCluster over four paper meshes)
# ---------------------------------------------------------------------------
CLUSTER_STACKS = 4


def make_cluster_stream(topo, n: int, seed: int, n_flushes: int):
    """Phase 4's mix over a StackedTopology, in global bank ids: even
    chunks plain copies, odd chunks copies with extra-slot bundles,
    in-place inits (same-stack: the reference rejects cross-stack inits)
    and fan-in reduces.  Copy endpoints and reduce destinations are
    uniform over all banks, so about 3/4 of the copies cross stacks.  A
    reduce's sources lie in one layer of one stack (uniform over the
    stacks): the destination's layer when that is the destination's
    stack, else the bridge's layer (0).  So some reduces build
    cross-stack trees, and NoM-Light, whose fan-ins take same-layer
    sources only, can route each one (remote partials merge at the
    bridge)."""
    from repro_torch.core import TransferRequest, reduce_request
    rng = np.random.default_rng(seed)
    mesh, n_banks = topo.stacks[0], topo.n_nodes
    chunks = []
    per = n // n_flushes
    for k in range(n_flushes):
        chunk = []
        for _ in range(per):
            u = rng.random() if k % 2 else 1.0
            if u < 0.05:
                dst = int(rng.integers(n_banks))
                d_stack, d_loc = topo.locate(dst)
                stack = int(rng.integers(topo.n_stacks))
                z = mesh.coords(d_loc)[2] if stack == d_stack else 0
                layer = [topo.global_id(stack, v) for v in range(mesh.n_nodes)
                         if mesh.coords(v)[2] == z]
                layer = [g for g in layer if g != dst]
                srcs = rng.choice(layer, size=int(rng.integers(2, 5)),
                                  replace=False)
                chunk.append(reduce_request([int(s) for s in srcs], dst,
                                            nbytes=int(rng.integers(512,
                                                                    8192))))
            elif u < 0.15:
                v = int(rng.integers(n_banks))
                chunk.append(TransferRequest(
                    src=v, dst=v, op="init",
                    nbytes=int(2 ** rng.uniform(13, 16))))
            else:
                s, d = (int(x) for x in rng.integers(n_banks, size=2))
                while s == d:
                    d = int(rng.integers(n_banks))
                extra = (int(rng.integers(1, 4))
                         if k % 2 and rng.random() < 0.3 else 0)
                chunk.append(TransferRequest(
                    src=s, dst=d, nbytes=int(2 ** rng.uniform(9, 16)),
                    max_extra_slots=extra))
        chunks.append(chunk)
    return chunks


def make_cluster(topo, kind: str, device):
    """A FabricCluster on one of the PATHS: the fused, host or auto
    allocator backend in every stack, or NoM-Light allocators."""
    from repro_torch.core import FabricCluster, TdmAllocatorLight
    if kind == "light":
        return FabricCluster(topo, allocators=[
            TdmAllocatorLight(m, N_SLOTS, device=str(device))
            for m in topo.stacks])
    return FabricCluster(topo, n_slots=N_SLOTS, alloc_backend=kind,
                         device=str(device))


def cluster_key(c):
    """Every field of a granted Circuit, StackedCircuit or ReduceTree."""
    return None if c is None else (type(c).__name__, dataclasses.astuple(c))


def check_stacked(topo, c, n_slots: int) -> None:
    """A StackedCircuit's segments chain: near hops from the source to the
    near bridge in increasing slots, arriving on slot a; one slot per
    SerDes channel of the stack route, the first (a + 1) % n, each next
    1 + latency on; far hops from the far bridge injected at
    (a + T) % n, increasing to (dst, LOCAL)."""
    from repro_torch.core import PORT_LOCAL
    (sa, s_loc), (sb, d_loc) = c.src, c.dst

    def chain(hops):
        for (_n1, _p1, s1), (_n2, _p2, s2) in zip(hops, hops[1:]):
            check((s1 + 1) % n_slots == s2, f"slots not increasing in {hops}")
    chain(c.near_hops)
    chain(c.far_hops)
    a = c.near_hops[-1][2]
    check(c.near_hops[0][0] == s_loc
          and c.near_hops[-1][:2] == (topo.bridge_of(sa), PORT_LOCAL),
          f"near segment {c.near_hops} is not {s_loc} -> bridge")
    chans = topo.route_channels(sa, sb)
    check([ch for ch, _s in c.link_slots] == chans,
          f"link slots {c.link_slots} off the route {chans}")
    s = (a + 1) % n_slots
    for ch, sl in c.link_slots:
        check(sl == s, f"link slots {c.link_slots} do not chain from {a}")
        s = (s + 1 + topo.links[ch // 2].latency) % n_slots
    T = topo.route_cycles(sa, sb)
    check(c.far_hops[0][:1] == (topo.bridge_of(sb),)
          and c.far_hops[0][2] == (a + T) % n_slots
          and c.far_hops[-1][:2] == (d_loc, PORT_LOCAL),
          f"far segment {c.far_hops} is not bridge@{(a + T) % n_slots} -> "
          f"{d_loc}")
    check(c.distance == len(c.near_hops) - 1 + T + len(c.far_hops) - 1,
          f"cross-stack distance {c.distance}")


def check_cluster_result(topo, req, c, n_slots: int) -> None:
    """Shape of one granted cluster result: a same-stack circuit as
    check_circuit, in stack-local ids; a StackedCircuit as check_stacked;
    a ReduceTree's legs as check_stacked, its partials ending at their
    bridges and its local fan-in at the destination."""
    import types
    from repro_torch.core import PORT_LOCAL, ReduceTree, StackedCircuit
    if isinstance(c, StackedCircuit):
        check_stacked(topo, c, n_slots)
    elif isinstance(c, ReduceTree):
        check(c.dst == topo.locate(req.dst), f"tree {c} off {req.dst}")
        for leg in c.legs:
            check_stacked(topo, leg, n_slots)
            check(leg.dst == c.dst, f"leg {leg} off {c.dst}")
        for part in c.partials:
            check(part.hops[-1][1] == PORT_LOCAL
                  and part.dst in {topo.bridge_of(s) for s, _ in c.srcs},
                  f"partial {part} does not end at a bridge")
        if c.local is not None:
            check(c.local.dst == c.dst[1], f"local fan-in {c.local}")
    else:
        loc = types.SimpleNamespace(op=req.op, src=topo.locate(req.src)[1],
                                    dst=topo.locate(req.dst)[1])
        check_circuit(loc, c, n_slots)


def cluster_state(cl):
    """Every stack's port expiry table and the SerDes link table."""
    return ([f.allocator.table._ports.expiry.copy() for f in cl.fabrics]
            + [cl.segmented.links.expiry.copy()])


WAVE_KEYS = ("fused_waves", "host_waves")


def telemetry_key(tel: dict) -> dict:
    """A cluster's telemetry without the fused/host wave split."""
    out = {k: v for k, v in tel.items() if k not in WAVE_KEYS + ("stacks",)}
    out["stacks"] = [{k: v for k, v in s.items() if k not in WAVE_KEYS}
                     for s in tel["stacks"]]
    return out


def phase_cluster(topo, device, chunks, batches=None):
    """The four paths over a 4-stack cluster, each flush at the session
    clock (a 4-byte SerDes link holds a 64 KB copy for 16384 windows, so
    flushes anchored 2048 cycles apart, as in phase 4, would find the
    links taken and deny most cross-stack requests), each path driven
    with the launch counts set to 0 just before it and read just after:
    its own kernels
    (PATH_KERNELS) must have launched, and no other.  Results, reports,
    telemetry and slot tables agree across the fused, host and auto
    backends (up to the wave split), and each path with itself on the
    CPU; every result is well formed.  With a ``batches`` dict, each
    path's launches by (kernel, batch) go into ``batches[path]``.
    Returns (per-path launch counts, keys, per-path stats)."""
    from repro_torch.kernels import _lib
    reqs = [r for c in chunks for r in c]
    runs, launches = {}, {}
    for kind in PATHS:
        cl = make_cluster(topo, kind, device)
        _lib.reset_launch_counts()
        with (batches_launched(batches.setdefault(kind, {}))
              if batches is not None else contextlib.nullcontext()):
            res, reps, secs = drive(cl, chunks, None)
        launches[f"cluster-{kind}"] = counts = dict(_lib.launch_counts)
        runs[kind] = (cl, res, reps, secs)
        own = PATH_KERNELS[kind]
        check(all(counts[k] > 0 for k in own),
              f"cluster-{kind}: a kernel of the path never launched: {counts}")
        check(all(v == 0 for k, v in counts.items() if k not in own),
              f"cluster-{kind}: launched a kernel outside its path: {counts}")
    keys = {k: [cluster_key(r.circuit) for r in v[1]]
            for k, v in runs.items()}
    for kind in ("host", "auto"):
        cl, _res, reps, _s = runs[kind]
        ref = runs["fused"][0]
        check(keys[kind] == keys["fused"],
              f"cluster: fused and {kind} backends committed different "
              "results")
        check([report_key(a) for a in reps]
              == [report_key(b) for b in runs["fused"][2]],
              f"cluster: fused and {kind} schedule reports differ")
        check(telemetry_key(cl.telemetry()) == telemetry_key(ref.telemetry()),
              f"cluster: fused and {kind} telemetry differ")
        check(all(np.array_equal(a, b) for a, b in
                  zip(cluster_state(cl), cluster_state(ref))),
              f"cluster: fused and {kind} slot tables differ")
    for kind, (cl, res, reps, _s) in runs.items():
        for rq, r in zip(reqs, res):
            if r.circuit is not None:
                check_cluster_result(topo, rq, r.circuit, N_SLOTS)
        for rep in reps:
            check(rep.fused_waves + rep.host_waves == rep.search_rounds,
                  f"cluster-{kind}: wave split does not partition search "
                  "rounds")
        cpu = make_cluster(topo, kind, "cpu")
        c_res, c_reps, _s = drive(cpu, chunks, None)
        check([cluster_key(r.circuit) for r in c_res] == keys[kind],
              f"cluster-{kind}: CUDA and plain CPU results differ")
        check([report_key(a, True) for a in c_reps]
              == [report_key(b, True) for b in reps],
              f"cluster-{kind}: CUDA and plain CPU reports differ")
        check(cpu.telemetry() == cl.telemetry()
              and all(np.array_equal(a, b) for a, b in
                      zip(cluster_state(cpu), cluster_state(cl))),
              f"cluster-{kind}: CUDA and plain CPU telemetry or slot tables "
              "differ")
    tel = {k: v[0].telemetry() for k, v in runs.items()}
    stats = {k: {"seconds": v[3]} | {
        f: tel[k][f] for f in ("scheduled", "fused_waves", "host_waves",
                               "cross_requests", "cross_committed",
                               "cross_denied", "cross_rollbacks",
                               "cross_reduce_trees", "reduce_rollbacks",
                               "link_windows")}
        for k, v in runs.items()}
    print(f"[cluster] {len(reqs)} transfers in {len(chunks)} flushes on "
          f"{topo.n_stacks} x {topo.stacks[0].X}x{topo.stacks[0].Y}x"
          f"{topo.stacks[0].Z}/{N_SLOTS} ({topo.link}, SerDes latency "
          f"{topo.link_latency}, {topo.link_bytes} B links, {topo.n_nodes} "
          f"banks): fused == host == auto results, reports, telemetry and "
          f"slot tables, CUDA == plain CPU on every path; "
          f"{json.dumps(stats)}", flush=True)
    print(f"[launches] cluster per path, each read right after its run: "
          f"{json.dumps(launches)}", flush=True)
    return launches, keys, stats


@contextlib.contextmanager
def seconds_in(out: dict, owners: dict):
    """While active, add the wall seconds of every call of
    ``owners[name] = (class, method)`` to ``out[name]`` (a nested call of
    another listed method counts in both)."""
    saved = {name: getattr(cls, meth) for name, (cls, meth) in
             owners.items()}

    def timed(name, fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                out[name] = out.get(name, 0.0) + time.perf_counter() - t0
        return call
    for name, (cls, meth) in owners.items():
        setattr(cls, meth, timed(name, saved[name]))
    try:
        yield out
    finally:
        for name, (cls, meth) in owners.items():
            setattr(cls, meth, saved[name])


def cluster_where(topo, device, chunks) -> dict:
    """Where each cluster path's wall time goes, from one more run of it:
    the per-stack fabrics' same-stack batches (``NomFabric.schedule``:
    the CCU pipeline and its kernels), the cross-stack negotiation on
    the host (``SegmentedAllocator.allocate``, the reduce trees'
    ``FabricCluster._reduce_tree``, whose legs are allocations too) and
    the rest (the split, reports, clocks)."""
    from repro_torch.core import FabricCluster, NomFabric, SegmentedAllocator
    owners = {"same-stack": (NomFabric, "schedule"),
              "cross-stack": (SegmentedAllocator, "allocate"),
              "trees": (FabricCluster, "_reduce_tree")}
    out = {}
    for kind in PATHS:
        secs: dict = {}
        with seconds_in(secs, owners):
            _res, _reps, wall = drive(make_cluster(topo, kind, device),
                                      chunks, None)
        out[kind] = {k: round(v * 1e3, 2) for k, v in secs.items()} | {
            "wall": round(wall * 1e3, 2)}
    print(f"[cluster where] ms by part of each path's run (a tree's legs "
          f"count in cross-stack too): {json.dumps(out)}", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 8: the serving control plane under the SLO harness
# ---------------------------------------------------------------------------
# benchmarks/bench_serving_slo.py's published settings: every arrival mix
# under every admission strategy, seed 7, 160 ticks, on
# make_slo_engine's stub engine over a 4x4x2 bank mesh with queue
# admission, 12 deadline ticks and a queue of 16; its gate: on
# deadline_heavy the deadline strategy misses fewer deadlines than fifo.
SLO_SEED, SLO_TICKS = 7, 160
SLO_MESH, SLO_DEADLINE_TICKS, SLO_QUEUE_DEPTH = (4, 4, 2), 12, 16
SLO_STRATEGIES = ("fifo", "deadline", "priority", "hybrid", "stall_aware")
SLO_GATE_MIX = "deadline_heavy"


def slo_engine(strategy: str, device):
    from repro_torch.serving import make_slo_engine
    return make_slo_engine(strategy, mesh=SLO_MESH,
                           deadline_ticks=SLO_DEADLINE_TICKS,
                           tenant_queue_depth=SLO_QUEUE_DEPTH,
                           device=str(device))


def fabric_state(fab):
    """A single-stack fabric's port and bus expiry tables and busy
    masks."""
    t = fab.allocator.table
    return [a.copy() for a in (t._ports.expiry, t._ports.masks,
                               t._bus.expiry, t._bus.masks)]


def same_engines(path: str, eng, cpu) -> None:
    """An engine on the card and its twin on the CPU: equal telemetry,
    batch reports, fabric telemetry and slot tables."""
    check(eng.transfer_telemetry() == cpu.transfer_telemetry(),
          f"{path}: card and CPU engine telemetry differ")
    check([dataclasses.asdict(r) for r in eng.reports]
          == [dataclasses.asdict(r) for r in cpu.reports],
          f"{path}: card and CPU batch reports differ")
    check(eng.fabric.telemetry() == cpu.fabric.telemetry(),
          f"{path}: card and CPU fabric telemetry differ")
    check(all(np.array_equal(a, b) for a, b in zip(
        fabric_state(eng.fabric), fabric_state(cpu.fabric))),
        f"{path}: card and CPU slot tables differ")


def phase_serving_slo(device, ticks=SLO_TICKS):
    """Every (mix, strategy) drive of the SLO harness with the engine's
    fabric on the card, each with the launch counts set to 0 just before
    it and read just after (the fused prepare kernel once per fused
    wave of the fabric's telemetry, and nothing else), held equal to the
    same drive on the CPU (record with its per-tick ledger, telemetry,
    reports, slot tables); the benchmark's gate on the card's records.
    Per drive: the record, µs per tick on the card and on the CPU, the
    launches, and the wall split into kernels (each launch priced at its
    own batch size's event time on this mesh), the rest of the fabric
    (``NomFabric.schedule`` less its kernels: the CCU's host pipeline
    and the launches' host side) and the control plane (engine and load
    generator).  Returns the per-drive launches keyed
    "serving_slo/<mix>/<strategy>"."""
    import torch
    from repro_torch.core import NomFabric, make_topology
    from repro_torch.kernels import _lib
    from repro_torch.serving import MIXES, drive
    launches, batches, runs, miss = {}, {}, {}, {}
    for mix in MIXES:
        for strategy in SLO_STRATEGIES:
            path = f"serving_slo/{mix}/{strategy}"
            eng, secs = slo_engine(strategy, device), {}
            _lib.reset_launch_counts()
            with batches_launched(batches.setdefault(path, {})), \
                    seconds_in(secs, {"fabric": (NomFabric, "schedule")}):
                t0 = time.perf_counter()
                rec = drive(eng, mix, ticks, seed=SLO_SEED, trace=True)
                torch.cuda.synchronize(device)
                wall = time.perf_counter() - t0
            launches[path] = dict(_lib.launch_counts)
            waves = eng.fabric.telemetry()["fused_waves"]
            check(waves > 0, f"{path}: no wave went to the fused kernel")
            check_launches(path, launches[path], {"fused_prepare": waves})
            cpu = slo_engine(strategy, "cpu")
            t0 = time.perf_counter()
            want = drive(cpu, mix, ticks, seed=SLO_SEED, trace=True)
            cpu_wall = time.perf_counter() - t0
            check(rec == want, f"{path}: card and CPU records differ")
            same_engines(path, eng, cpu)
            runs[path] = (rec, wall, secs.get("fabric", 0.0), cpu_wall)
            miss[(mix, strategy)] = rec["miss_rate"]
    check(miss[(SLO_GATE_MIX, "deadline")] < miss[(SLO_GATE_MIX, "fifo")],
          f"on {SLO_GATE_MIX} deadline misses "
          f"{miss[(SLO_GATE_MIX, 'deadline')]}, fifo "
          f"{miss[(SLO_GATE_MIX, 'fifo')]}: the benchmark's gate fails")
    price = price_launches(make_topology(mesh=SLO_MESH), device, batches, {})
    total = {"kernels": 0.0, "fabric": 0.0, "control": 0.0, "wall": 0.0}
    for path, (rec, wall, fab_s, cpu_wall) in runs.items():
        kern = sum(v * price[k] for k, v in batches[path].items())
        split = {"kernels": kern, "fabric": fab_s * 1e3 - kern,
                 "control": (wall - fab_s) * 1e3, "wall": wall * 1e3}
        for k in total:
            total[k] += split[k]
        summary = {k: v for k, v in rec.items() if k != "per_tick"}
        print(f"[serving_slo] {path[len('serving_slo/'):]} {ticks} ticks: "
              f"{json.dumps(summary)}; {wall * 1e6 / ticks:.1f} us per "
              f"tick on the card, {cpu_wall * 1e6 / ticks:.1f} on the CPU "
              f"(equal record, telemetry, reports, slot tables); launches "
              f"fused_prepare {launches[path]['fused_prepare']} "
              f"wavefront_search {launches[path]['wavefront_search']}; ms "
              + " ".join(f"{k} {v:.3f}" for k, v in split.items())
              + f" (kernels {100 * kern / (wall * 1e3):.2f} % of the wall)",
              flush=True)
    print(f"[serving_slo] {len(runs)} drives of {ticks} ticks equal to the "
          f"CPU; gate on {SLO_GATE_MIX}: deadline miss rate "
          f"{miss[(SLO_GATE_MIX, 'deadline')]:.4f} < fifo "
          f"{miss[(SLO_GATE_MIX, 'fifo')]:.4f}; ms in all "
          + " ".join(f"{k} {v:.2f}" for k, v in total.items())
          + f" (kernels {100 * total['kernels'] / total['wall']:.2f} %); "
          "launches by (kernel, batch) priced at "
          + json.dumps({f"{k} B={b}": round(v, 5)
                        for (k, b), v in sorted(price.items())}), flush=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 9: the served models at full width
# ---------------------------------------------------------------------------
# arch -> (prefill batch, prefill length, launches of one prefill step):
# each layer launches its mixer's kernel once (MIXER_KERNEL).
MODELS = {
    "recurrentgemma-9b": (2, 4096, {"flash_attention": 12, "rglru_scan": 26}),
    "mamba2-130m": (4, 8192, {"ssd_scan": 24}),
    "qwen1.5-4b": (2, 4096, {"flash_attention": 40}),
    "gemma3-27b": (2, 4096, {"flash_attention": 8}),
}
# Depth cuts (width untouched): gemma3-27b's 62 layers hold 27.0 B fp32
# parameters (100.6 GiB), more than the card's 80 GB; 8 layers are one
# whole 5-local + 1-global period and a tail of two local layers, so the
# caches have both the reference's `groups` and its `tail` (4.712 B
# parameters, 17.56 GiB).
MODEL_LAYERS = {"gemma3-27b": 8}
# The smoke configs run on the card against the CPU before the models.
SMOKE_ARCHS = tuple(MODELS) + ("qwen2.5-32b", "command-r-plus-104b")
MIXER_KERNEL = {"attn": "flash_attention", "rglru": "rglru_scan",
                "ssm": "ssd_scan"}
PARITY_TOKENS = 64
LOGSOFTMAX_TOL, AGREE = 1.5, 0.95     # tests/test_decode.py, recurrent archs
# Decode vs forward at full width: in fp32 max |d log-softmax| is held at
# a bound set from recurrentgemma's reading on the H100 (0.0122).  In bf16
# the gap is recorded and greedy agreement is held.  With random tied
# weights the largest logit is ~d_model, so any last-bit difference
# between the batched forward and the per-token decode moves a row's
# log-softmax by ~d_model / 256: the attention kernel's rounding (it
# casts the unnormalised probabilities to bf16 before P.V, as the TPU
# kernel does, where the einsum decode casts the normalised ones), the
# SSD scan's chunked sums against the decode's per-token state, and
# matmuls that round differently at the forward's and the decode's
# shapes.  For recurrentgemma the gap of a forward through einsum
# attention, the reference's own prefill arithmetic, is recorded beside
# it; the reference's own gap with its TPU kernel is shown at d_model 64
# and 512 by tests/test_torch_models.py::test_decode_gap_is_rounding.
FP32_GAP_TOL = 0.1
SERVE_B, SERVE_P, SERVE_N = 4, 8, 24  # launch/serve.py's defaults


def logsoftmax_gap(a, b):
    import torch
    la, lb = torch.log_softmax(a, -1), torch.log_softmax(b, -1)
    return (float((la - lb).abs().max()),
            float((la.argmax(-1) == lb.argmax(-1)).float().mean()))


def einsum_attention(q, k, v, *, causal, window, scale):
    """Causal (windowed) attention in the arithmetic of the reference's
    prefill and of the port's decode: fp32 logits, normalised
    probabilities cast to v's type, then P.V.  q (B, S, Hq, D), k/v
    (B, S, Hkv, D), q already scaled."""
    import torch
    assert causal and scale == 1.0
    b, s, hq, d = q.shape
    qg = q.reshape(b, s, k.shape[2], hq // k.shape[2], d)
    logits = torch.einsum("bskgh,btkh->bkgst", qg, k).float()
    i = torch.arange(s, device=q.device)
    ok = i[None, :] <= i[:, None]
    if window is not None:
        ok &= i[:, None] - i[None, :] < window
    probs = torch.softmax(logits.masked_fill(~ok, float("-inf")), -1)
    out = torch.einsum("bkgst,btkh->bskgh", probs.to(v.dtype), v)
    return out.reshape(b, s, hq, d)


def decode_gap(model, cfg, tokens, forward_logits):
    """The first ``forward_logits.shape[1]`` tokens one by one through
    the serve step, against the forward's logits: (max |d log-softmax|,
    greedy agreement)."""
    import torch
    from repro_torch.train import make_serve_step
    b, n = forward_logits.shape[:2]
    step, caches = make_serve_step(model, cfg), model.init_caches(b, n)
    outs = []
    for i in range(n):
        lg, caches = step(tokens[:, i:i + 1], caches, i)
        outs.append(lg)
    return logsoftmax_gap(torch.cat(outs, 1), forward_logits)


def check_launches(path: str, counts: dict, want: dict) -> None:
    want = {k: want.get(k, 0) for k in counts}
    check(counts == want, f"{path}: launches {counts}, expected {want}")


def layer_kernels(cfg) -> dict:
    """Launches of one prefill step by the config's layers: one launch
    of its mixer's kernel per layer."""
    out: dict[str, int] = {}
    for j in range(cfg.n_layers):
        k = MIXER_KERNEL[cfg.pattern[j % len(cfg.pattern)].mixer]
        out[k] = out.get(k, 0) + 1
    return out


def phase_smoke_model(device, arch):
    """The smoke config of ``arch`` (S=80: past recurrentgemma's window
    of 32, five of mamba2's 16-token chunks) on the card, through the
    kernels, against the same weights on the CPU, through the plain
    versions."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.models import CausalLM, make_model
    from repro_torch.train import make_prefill_step
    cfg = get_config(arch, smoke=True)
    model = make_model(cfg, device=device, seed=SEED)
    cpu = CausalLM(cfg, "cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    toks = torch.randint(0, cfg.vocab, (2, 80), device=device,
                         generator=torch.Generator(device).manual_seed(SEED))
    _lib.reset_launch_counts()
    fwd = make_prefill_step(model, cfg)(toks)
    check_launches(f"{cfg.name} prefill", dict(_lib.launch_counts),
                   layer_kernels(cfg))
    want = make_prefill_step(cpu, cfg)(toks.cpu())
    gap, agree = logsoftmax_gap(fwd.cpu(), want)
    check(gap < LOGSOFTMAX_TOL and agree > AGREE,
          f"smoke model: card vs CPU plain gap {gap}, agreement {agree}")
    dgap, dagree = decode_gap(model, cfg, toks, fwd)
    check(dgap < LOGSOFTMAX_TOL and dagree > AGREE,
          f"smoke model: decode vs forward gap {dgap}, agreement {dagree}")
    print(f"[model] {cfg.name} B=2 S=80, bf16: card (kernels "
          f"{json.dumps(layer_kernels(cfg))}) vs "
          f"CPU (plain versions) max |d log-softmax| {gap:.4g}, greedy "
          f"agreement {agree:.4g}; decode vs forward on the card "
          f"{dgap:.4g}, {dagree:.4g} (bounds < {LOGSOFTMAX_TOL}, "
          f"> {AGREE})", flush=True)


# Function names of the port's CUDA kernels, as the profiler shows them.
PORT_KERNEL_NAMES = ("flash_fwd", "rglru_scan", "ssd_scan_kernel",
                     "ssd_tc_kernel", "wavefront_search", "slot_score",
                     "fused_prepare", "launch_floor")


def profile_call(fn):
    """Device time by kernel over one warm call of ``fn`` (torch.profiler)
    against its wall time; returns a summary dict, or the reason it could
    not be measured."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    # Only the profiler's own failures are reported as not measured; a
    # failure of ``fn`` fails the run.
    try:
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
    except Exception as exc:
        return {"not_measured": f"{type(exc).__name__}: {exc}"}
    t0 = time.perf_counter()
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        wall = (time.perf_counter() - t0) * 1e3
        prof.stop()
    try:
        rows = []
        for ev in prof.key_averages():     # device kernels only
            if getattr(ev, "device_type", None) != DeviceType.CUDA:
                continue
            dev_us = getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0))
            if dev_us > 0:
                rows.append((dev_us / 1e3, ev.count, ev.key[:60]))
        rows.sort(reverse=True)
        busy = sum(r[0] for r in rows)
        return {"wall_ms": wall, "device_busy_ms": busy,
                "idle_share": 1 - busy / wall if wall else None,
                "device_kernels": sum(r[1] for r in rows),
                "top": [{"ms": r[0], "calls": r[1], "name": r[2]}
                        for r in rows[:12]],
                "port_kernels": [{"ms": r[0], "calls": r[1], "name": r[2]}
                                 for r in rows if any(
                                     k in r[2] for k in PORT_KERNEL_NAMES)]}
    except Exception as exc:
        return {"not_measured": f"{type(exc).__name__}: {exc}"}


def phase_model(device, arch):
    """``arch`` at full width and depth, weights from a seeded generator
    on the card: the prefill step on its MODELS batch (each layer
    launches its mixer's kernel once), decode-vs-forward parity over the
    first 64 tokens (bounded in fp32, recorded in bf16: see
    FP32_GAP_TOL), and Engine.generate with launch/serve.py's defaults
    (plain decode, no kernel).  Each path runs with the launch counts set
    to 0 just before it and read just after.  Returns the per-path
    launches, keyed "<arch>/prefill" and "<arch>/generate"."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import COMPUTE_DTYPE, attention, make_model
    from repro_torch.serving import Engine
    from repro_torch.train import make_prefill_step, make_serve_step
    cfg = get_config(arch)
    if arch in MODEL_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=MODEL_LAYERS[arch])
    prefill_b, prefill_s, want = MODELS[arch]
    check(layer_kernels(cfg) == want,
          f"{arch}: layers launch {layer_kernels(cfg)}, expected {want}")
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    model = make_model(cfg, device=device, seed=SEED)
    torch.cuda.synchronize(device)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device).manual_seed(SEED + 1)
    tokens = torch.randint(0, cfg.vocab, (prefill_b, prefill_s),
                           generator=gen, device=device)
    prefill = make_prefill_step(model, cfg)

    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    logits = prefill(tokens)
    torch.cuda.synchronize(device)
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = {f"{arch}/prefill": dict(_lib.launch_counts)}
    check_launches(f"{arch}/prefill", launches[f"{arch}/prefill"], want)
    check(tuple(logits.shape) == (prefill_b, prefill_s, cfg.padded_vocab)
          and logits.dtype == torch.float32, f"logits {logits.shape}")
    # Checked in slices of 4096 rows: isfinite on the whole would hold an
    # fp32 abs and two bool copies of the logits (~2.5x their size) and
    # set the phase's peak memory itself.
    check(all(bool(torch.isfinite(part).all())
              for part in logits.flatten(0, 1).split(4096)),
          "prefill logits not finite")
    head = logits[:, :PARITY_TOKENS].clone()
    del logits
    warm = []
    for _ in range(2):
        t0 = time.perf_counter()
        prefill(tokens)
        torch.cuda.synchronize(device)
        warm.append((time.perf_counter() - t0) * 1e3)
    prof = profile_call(lambda: prefill(tokens))
    print(f"[model] {cfg.name} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}): {n_params} parameters (fp32) initialised on "
          f"the card in {init_s:.2f} s; prefill B={prefill_b} x "
          f"S={prefill_s}: {first_ms:.1f} ms first, {warm} ms warm; launches "
          f"{json.dumps(launches[f'{arch}/prefill'])}; logits finite",
          flush=True)
    print(f"[profile] {arch} prefill {json.dumps(prof)}", flush=True)

    gap, agree = decode_gap(model, cfg, tokens, head)
    check(agree > AGREE, f"decode vs forward (bf16): greedy agreement "
          f"{agree}, max |d log-softmax| {gap}")
    logit_std, logit_max = float(head.std()), float(head.max())
    einsum_note = ""
    if "flash_attention" in want:
        attention.flash_attention = einsum_attention
        try:
            gap_einsum, _ = decode_gap(model, cfg, tokens,
                                       prefill(tokens[:, :PARITY_TOKENS]))
        finally:
            attention.flash_attention = flash_attention
        einsum_note = (f"; {gap_einsum:.4g} with the forward's attention in "
                       "einsums")
    model.compute_dtype = torch.float32
    try:
        head32 = prefill(tokens[:, :PARITY_TOKENS])
        gap32, agree32 = decode_gap(model, cfg, tokens, head32)
    finally:
        model.compute_dtype = COMPUTE_DTYPE
    check(gap32 < FP32_GAP_TOL and agree32 > AGREE,
          f"decode vs forward (fp32): max |d log-softmax| {gap32}, "
          f"agreement {agree32}")
    print(f"[model] {cfg.name} decode vs forward over the first "
          f"{PARITY_TOKENS} tokens: fp32 max |d log-softmax| {gap32:.4g} < "
          f"{FP32_GAP_TOL}, greedy agreement {agree32:.4g} > {AGREE}; bf16 "
          f"(served) max |d log-softmax| {gap:.4g} (largest logit "
          f"{logit_max:.4g}, logits' std {logit_std:.4g}{einsum_note}), "
          f"greedy agreement {agree:.4g} > {AGREE}", flush=True)
    del head, head32

    eng = Engine(model, cfg, max_len=SERVE_P + SERVE_N + 8,
                 track_transfers=False)
    prompt = torch.randint(0, cfg.vocab, (SERVE_B, SERVE_P), generator=gen,
                           device=device)
    eng.generate(prompt, 2)                                # warm-up
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.generate(prompt, SERVE_N)
    torch.cuda.synchronize(device)
    gen_s = time.perf_counter() - t0
    launches[f"{arch}/generate"] = dict(_lib.launch_counts)
    check_launches(f"{arch}/generate", launches[f"{arch}/generate"], {})
    check(tuple(out.shape) == (SERVE_B, SERVE_P + SERVE_N)
          and torch.equal(out[:, :SERVE_P], prompt)
          and bool(((out >= 0) & (out < cfg.vocab)).all()),
          f"generate returned {tuple(out.shape)}")
    steps = SERVE_P + SERVE_N - 1
    peak = torch.cuda.max_memory_allocated(device)
    caches = model.init_caches(SERVE_B, SERVE_P + SERVE_N + 8)
    serve = make_serve_step(model, cfg)
    serve(prompt[:, :1], caches, 0)
    prof_dec = profile_call(lambda: serve(prompt[:, 1:2], caches, 1))
    print(f"[profile] {arch} decode step {json.dumps(prof_dec)}", flush=True)
    print(f"[model] {cfg.name} Engine.generate: {SERVE_B} requests, prompt "
          f"{SERVE_P}, {SERVE_N} new tokens in {gen_s * 1e3:.1f} ms "
          f"({gen_s * 1e3 / steps:.2f} ms per decode step, {steps} steps); "
          f"launches {json.dumps(launches[f'{arch}/generate'])}; peak device "
          f"memory {peak / 2**30:.2f} GiB", flush=True)
    launches.update(tracked_generate(model, cfg, device, prompt, out))
    del model, eng
    torch.cuda.empty_cache()
    return launches


def tracked_generate(model, cfg, device, prompt, want):
    """``Engine.generate`` with its default ``track_transfers=True`` and
    the fabric on the card (launch/serve.py's defaults: the paper mesh,
    16 slots), after one warm-up stream on another tracked engine, with
    the launch counts set to 0 just before it and read just after: the
    tokens must equal the untracked run's, the fused prepare kernel must
    have launched once per fused wave of the fabric's telemetry and
    nothing else, and a CPU engine on the same leaf specs, stepped
    through the same tenant lifetime (open, one ``schedule_tick`` per
    step, close), must give equal telemetry, reports and slot tables.
    Then ms per decode step tracked and untracked, fresh engines in
    turns (tracked, untracked, untracked, tracked: the counted run
    first), and the tracked runs' ms per step in ``open_tenant``,
    ``schedule_tick`` and ``close_tenant``, and in ``NomFabric.schedule``
    within the last two.  Returns the launches keyed
    "<arch>/generate_tracked"."""
    import torch
    from repro_torch.core import NomFabric
    from repro_torch.kernels import _lib
    from repro_torch.serving import Engine
    path = f"{cfg.name}/generate_tracked"
    max_len, steps = SERVE_P + SERVE_N + 8, SERVE_P + SERVE_N - 1
    owners = {"open": (Engine, "open_tenant"),
              "tick": (Engine, "schedule_tick"),
              "close": (Engine, "close_tenant"),
              "fabric": (NomFabric, "schedule")}
    Engine(model, cfg, max_len=max_len, device=device).generate(prompt, 2)
    times = {True: [], False: []}
    parts: dict = {}

    def run(track: bool):
        eng = Engine(model, cfg, max_len=max_len, device=device,
                     track_transfers=track)
        with seconds_in(parts, owners) if track else \
                contextlib.nullcontext():
            t0 = time.perf_counter()
            out = eng.generate(prompt, SERVE_N)
            torch.cuda.synchronize(device)
        times[track].append((time.perf_counter() - t0) * 1e3 / steps)
        return eng, out
    _lib.reset_launch_counts()
    eng, out = run(True)
    launches = {path: dict(_lib.launch_counts)}
    check(torch.equal(out, want),
          f"{path}: tokens differ from the untracked run")
    fab = eng.fabric.telemetry()
    check_launches(path, launches[path], {"fused_prepare": fab["fused_waves"]})
    cpu = Engine(model, cfg, max_len=max_len, device="cpu")
    specs = eng._leaf_specs(SERVE_B)
    check(cpu._leaf_specs(SERVE_B) == specs, f"{path}: leaf specs differ")
    cpu.open_tenant("gen0", SERVE_B, queue=False)
    for _ in range(steps):
        cpu.schedule_tick(["gen0"])
    cpu.close_tenant("gen0")
    same_engines(path, eng, cpu)
    for track in (False, False, True):
        run(track)
    tel = eng.transfer_telemetry()
    per_step = {k: v * 1e3 / (2 * steps) for k, v in parts.items()}
    print(f"[serve] {cfg.name} Engine.generate tracking transfers on the "
          f"card: tokens equal to the untracked run; {len(specs)} cache "
          f"leaves ({', '.join(s.tag for s in specs)}), "
          f"{tel['requests']} requests in {tel['steps']} batches "
          f"({tel['init_requests']} INIT), {fab['fused_waves']} fused and "
          f"{fab['host_waves']} host CCU waves; telemetry, reports and slot "
          f"tables equal to a CPU engine's; ms per decode step, in turns: "
          f"tracked {[round(t, 2) for t in times[True]]}, untracked "
          f"{[round(t, 2) for t in times[False]]}; in the tracked runs, "
          f"ms a step in " + ", ".join(f"{k} {v:.3f}" for k, v in
                                       per_step.items())
          + f"; launches {json.dumps(launches[path])}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 10: checkpoints on the card and reshard plans
# ---------------------------------------------------------------------------
CKPT_ARCH, CKPT_TOKENS = "mamba2-130m", (2, 2048)
RESHARD_ARCH = "qwen1.5-4b"
RESHARD_STACKS = ((0, 1, 2, 3), (0, 1, 2))
RESHARD_MESHES = ((4, 4), (2, 4))


def phase_checkpoint(device) -> dict:
    """``repro_torch.checkpoint`` on the card: mamba2-130m at full width
    saved from the card and restored onto it (every parameter and the
    prefill logits bit-equal to those before the save: the kernels have
    no atomics, so a run repeats its bits), a tree of bf16 and int32
    leaves (bf16 stored as its uint16 bits) and an empty dict through a
    round trip, ``prune`` and ``latest_step`` with a stale ``.tmp``
    directory; then ``cross_stack_reshard_plan`` on qwen1.5-4b's fp32
    leaf bytes over four paper-mesh stacks, stacks (0, 1, 2, 3) -> (0, 1,
    2), with the stacks' CCUs on the card, equal to the same plan on the
    CPU (results, report, telemetry), and ``reshard_plan`` of the same
    bytes on a (4, 4) -> (2, 4) device mesh, its rounds conflict-free.
    Files go under the checkout's git-ignored ``build/`` and are removed.
    Returns the launches of the restored model's prefill and of the
    reshard on the card."""
    import shutil
    import torch
    from repro_torch import checkpoint as ckpt
    from repro_torch.checkpoint.reshard import reshard_plan_with_report
    from repro_torch.configs import get_config
    from repro_torch.core import PAPER_MESH, make_topology
    from repro_torch.kernels import _lib
    from repro_torch.models import CausalLM, make_model
    from repro_torch.train import make_prefill_step
    launches = {}
    root = ROOT / "build" / "chip_smoke_checkpoints"
    shutil.rmtree(root, ignore_errors=True)
    try:
        cfg = get_config(CKPT_ARCH)
        model = make_model(cfg, device=device, seed=SEED + 2)
        toks = torch.randint(0, cfg.vocab, CKPT_TOKENS, device=device,
                             generator=torch.Generator(device).manual_seed(
                                 SEED + 3))
        before = make_prefill_step(model, cfg)(toks)
        d = str(root / "model")
        t0 = time.perf_counter()
        ckpt.save(d, 1, {"params": model.state_dict()},
                  extra_meta={"arch": cfg.name})
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tree, manifest = ckpt.restore(d, device=device)
        torch.cuda.synchronize(device)
        restore_s = time.perf_counter() - t0
        state = model.state_dict()
        check(sorted(tree["params"]) == sorted(state)
              and manifest["arch"] == cfg.name, "checkpoint: keys differ")
        for name, val in state.items():
            got = tree["params"][name]
            check(got.device == val.device and got.dtype == val.dtype
                  and torch.equal(got, val),
                  f"checkpoint: {name} differs after the round trip")
        n_bytes = sum(v.numel() * v.element_size() for v in state.values())
        del model, state
        restored = CausalLM(cfg, device)
        restored.load_state_dict(tree["params"])
        del tree
        _lib.reset_launch_counts()
        after = make_prefill_step(restored, cfg)(toks)
        torch.cuda.synchronize(device)
        launches["checkpoint/restored_prefill"] = dict(_lib.launch_counts)
        check_launches("checkpoint/restored_prefill",
                       launches["checkpoint/restored_prefill"],
                       layer_kernels(cfg))
        check(torch.equal(after, before),
              "checkpoint: the restored model's prefill logits differ: "
              f"max |d| {float((after - before).abs().max())}")
        del restored, before, after
        print(f"[checkpoint] {cfg.name} ({n_bytes / 2**20:.1f} MiB fp32) "
              f"saved from the card in {save_s:.2f} s, restored onto it in "
              f"{restore_s:.2f} s: every parameter and the prefill logits "
              f"(B={CKPT_TOKENS[0]} x S={CKPT_TOKENS[1]}, launches "
              f"{json.dumps(launches['checkpoint/restored_prefill'])}) "
              f"bit-equal", flush=True)

        gen = torch.Generator(device).manual_seed(SEED + 4)
        small = {"h": torch.randn((64, 96), generator=gen, device=device)
                 .bfloat16(),
                 "opt": {"ids": torch.randint(-2**31, 2**31 - 1, (257,),
                                              generator=gen, device=device,
                                              dtype=torch.int32),
                         "empty": {}}}
        d = str(root / "small")
        for step in (2, 3, 4):
            ckpt.save(d, step, small)
        (root / "small" / "step_00000009.tmp").mkdir()
        ckpt.prune(d, keep=2)
        kept = sorted(x.name for x in (root / "small").iterdir())
        check(kept == ["step_00000003", "step_00000004", "step_00000009.tmp"]
              and ckpt.latest_step(d) == 4,
              f"checkpoint: prune / latest_step left {kept}")
        got, manifest = ckpt.restore(d, device=device)
        check(manifest["step"] == 4
              and manifest["keys"]["h"]["dtype"] == "bfloat16"
              and manifest["keys"]["opt/ids"]["dtype"] == "int32"
              and got["opt"]["empty"] == {}
              and got["h"].dtype == torch.bfloat16
              and torch.equal(got["h"].view(torch.int16),
                              small["h"].view(torch.int16))
              and torch.equal(got["opt"]["ids"], small["opt"]["ids"]),
              "checkpoint: the bf16 / int32 tree differs after the round "
              "trip")
        print("[checkpoint] bf16 (as uint16 bits) and int32 leaves and an "
              "empty dict bit-equal through save and restore on the card; "
              "prune(keep=2) kept steps 3 and 4, latest_step 4 past a stale "
              ".tmp", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    meta = {k: v.numel() * 4 for k, v in
            CausalLM(get_config(RESHARD_ARCH), "meta").state_dict().items()}
    topo = make_topology(4, PAPER_MESH)
    runs = []                          # the card's, then the CPU's
    for dev in (device, torch.device("cpu")):
        _lib.reset_launch_counts()
        t0 = time.perf_counter()
        res, rep = ckpt.cross_stack_reshard_plan(meta, topo, *RESHARD_STACKS,
                                                 device=dev)
        if not runs:
            torch.cuda.synchronize(dev)
            launches["checkpoint/cross_stack_reshard"] = dict(
                _lib.launch_counts)
        runs.append(([(r.searched_cycle, cluster_key(r.circuit))
                      for r in res], dataclasses.asdict(rep),
                     (time.perf_counter() - t0) * 1e3))
    check(runs[0][:2] == runs[1][:2],
          "cross_stack_reshard_plan: the card's results or report differ "
          "from the CPU's")
    counts = launches["checkpoint/cross_stack_reshard"]
    check(set(k for k, n in counts.items() if n) <= {"fused_prepare"},
          f"cross_stack_reshard_plan launched {counts}")
    rep = runs[0][1]
    plan, prep = reshard_plan_with_report(meta, *RESHARD_MESHES)
    for rnd in plan.rounds():
        hops = [h for _i, h in rnd]
        check(len(hops) == len(set(hops)),
              "reshard_plan: a round uses a link twice")
    print(f"[checkpoint] cross_stack_reshard_plan of {RESHARD_ARCH}'s "
          f"{len(meta)} fp32 leaves ({sum(meta.values()) / 2**30:.2f} GiB) "
          f"over 4 paper-mesh stacks, {RESHARD_STACKS[0]} -> "
          f"{RESHARD_STACKS[1]}: {rep['n_requests']} moves, "
          f"{rep['n_scheduled']} scheduled, {rep['n_cross_stack']} cross-"
          f"stack, {rep['n_windows']} TDM windows; results and report equal "
          f"to the CPU's; {runs[0][2]:.1f} ms on the card, "
          f"{runs[1][2]:.1f} ms on the CPU; launches {json.dumps(counts)}"
          f"; reshard_plan {RESHARD_MESHES[0]} -> {RESHARD_MESHES[1]}: "
          f"{len(plan.transfers)} transfers in {plan.n_rounds} conflict-free "
          f"rounds (max in flight {prep.max_inflight})", flush=True)
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_name(mangled: str) -> str:
    """``flash_fwd_bf16_kernel<256>`` from an Itanium-mangled entry name
    (``_Z[N]<len><ns><len><name>I<template args>E...``)."""
    rest, name = re.sub(r"^_ZN?", "", mangled), mangled
    while (n := re.match(r"\d+", rest)):
        size = int(n.group())
        name, rest = rest[n.end():n.end() + size], rest[n.end() + size:]
    args = re.match(r"I(.*?E)[Ev]", rest)
    if not args:
        return name
    a = re.sub(r"Li(\d+)E", r"\1,", args.group(1))
    a = a.replace("Lb0E", "false,").replace("Lb1E", "true,")
    a = a.replace("13__nv_bfloat16", "bf16,")
    a = "float," + a[1:] if a.startswith("f") else a
    return f"{name}<{a.rstrip('E,')}>"


def ptxas_usage(log: str) -> dict:
    """Registers and spills of each kernel instantiation, from ptxas -v,
    whether ptxas serialized its wgmma instructions, and the waits or
    arrivals it injected around them."""
    out, fn = {}, None
    for ln in log.splitlines():
        if (m := re.search(r"instructions are serialized.* in the function "
                           r"'(\w+)'", ln)):
            out.setdefault(kernel_name(m.group(1)), []).append(
                "wgmma serialized (C7514)")
        elif (m := re.search(r"\((C75\d\d)\) (warpgroup\.\w+) is injected"
                             r".* in function '(\w+)'", ln)):
            note = f"{m.group(2)} injected ({m.group(1)})"
            notes = out.setdefault(kernel_name(m.group(3)), [])
            if note not in notes:
                notes.append(note)
        elif (m := re.search(r"Compiling entry function '(\w+)'", ln)):
            fn = kernel_name(m.group(1))
        elif fn and (m := re.search(r"(\d+) bytes spill stores, (\d+) "
                                    r"bytes spill loads", ln)):
            out.setdefault(fn, []).append(
                f"spills {m.group(1)}/{m.group(2)} B")
        elif fn and (m := re.search(r"Used (\d+) registers", ln)):
            out.setdefault(fn, []).insert(0, f"{m.group(1)} registers")
    return {k: ", ".join(v) for k, v in out.items()}


KERNEL_META = {
    "wavefront_search": ("src/repro_torch/kernels/slot_alloc/csrc/"
                         "wavefront_search.cu",
                         "src/repro/kernels/slot_alloc/slot_alloc.py:76"),
    "slot_score": ("src/repro_torch/kernels/slot_alloc/csrc/slot_score.cu",
                   "src/repro/kernels/slot_alloc/fused.py:86"),
    "fused_prepare": ("src/repro_torch/kernels/slot_alloc/csrc/"
                      "fused_prepare.cu",
                      "src/repro/kernels/slot_alloc/fused.py:213"),
    "flash_attention": ("src/repro_torch/kernels/flash_attention/csrc/"
                        "flash_attention.cu",
                        "src/repro/kernels/flash_attention/"
                        "flash_attention.py:75"),
    "rglru_scan": ("src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
                   "src/repro/kernels/rglru_scan/rglru_scan.py:46"),
    "ssd_scan": ("src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan/ssd_scan.py:60"),
}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found; run "
              "from the repository root", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import PAPER_MESH, make_topology
    from repro_torch.kernels import _lib
    device = torch.device("cuda", 0)
    print(f"[device] {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} cuda {torch.version.cuda} | tf32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}", flush=True)
    check(not torch.backends.cuda.matmul.allow_tf32,
          "fp32 matmuls must run in full fp32 (plain versions, logits)")
    t_start = time.perf_counter()

    secs = _lib.build()
    regs = {k: ptxas_usage(v) for k, v in _lib.build_log.items()}
    print(f"[build] {len(_lib.KERNELS)} kernels built in {secs:.2f} s "
          f"{json.dumps(regs)}", flush=True)
    for fn, use in regs.get("ssd_scan", {}).items():
        check(not fn.startswith("ssd_tc_kernel") or (
            "serialized" not in use and not re.search(r"spills (?!0/0 B)",
                                                      use)),
              f"the SSD wgmma kernel {fn} spills or has its wgmma "
              f"serialized: {use}")
    for name in ("wavefront_search", "fused_prepare"):
        for fn, use in regs.get(name, {}).items():
            check(not re.search(r"spills (?!0/0 B)", use),
                  f"the slot kernel {fn} spills: {use}")

    rows, floors, max_err = phase_kernels(PAPER_MESH, device)
    model_rows, model_err = phase_model_kernels(device)

    chunks = make_stream(PAPER_MESH, N_TRANSFERS, SEED, N_FLUSHES)
    batches: dict = {}
    stats, launches, keys = phase_slice(PAPER_MESH, device, chunks,
                                        batches=batches)
    timing = phase_timing(PAPER_MESH, device, chunks, keys)
    phase_scoring(PAPER_MESH, device, launches["host"]["wavefront_search"])
    phase_host_calls(PAPER_MESH, device)

    smi = nvidia_smi()
    print("[alloc] us/alloc median " + " ".join(
        f"{k} {np.median(v):.2f}" for k, v in timing.items())
        + f" ({smi})", flush=True)
    share = kernel_share(PAPER_MESH, device, batches, stats, rows)
    print(f"[where] kernel time {json.dumps(share)}", flush=True)

    launches.update(phase_memsim(device))
    topo = make_topology(CLUSTER_STACKS, PAPER_MESH)
    check((topo.link, topo.link_latency, topo.link_bytes, topo.n_nodes)
          == ("ring", 8, 4, 1024), f"cluster topology {topo}")
    cchunks = make_cluster_stream(topo, N_TRANSFERS, SEED, N_FLUSHES)
    cbatches: dict = {}
    cl_launches, ckeys, cstats = phase_cluster(topo, device, cchunks,
                                               cbatches)
    launches.update(cl_launches)
    phase_timing(topo, device, cchunks, ckeys, rounds=len(PATHS),
                 make=make_cluster, key=cluster_key, label="cluster timing",
                 cycle_step=None)
    cluster_where(topo, device, cchunks)
    share = kernel_share(PAPER_MESH, device, cbatches, cstats, rows)
    print(f"[cluster where] kernel time {json.dumps(share)}", flush=True)

    launches.update(phase_serving_slo(device))

    for arch in SMOKE_ARCHS:
        phase_smoke_model(device, arch)
    for arch in MODELS:
        launches.update(phase_model(device, arch))
    launches.update(phase_checkpoint(device))

    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        row = model_rows.get(name) or rows[(name, WAVE)]
        by_path = {kind: counts[name] for kind, counts in launches.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": model_err.get(name, max_err.get(name)),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row.get("library_ms")})
        if "dense" in row:             # flash attention's D = 128 shapes
            kernels[-1]["dense"] = row["dense"]
        if name not in model_rows:     # the slot kernels: B = 1 and 64
            one = rows[(name, 1)]
            kernels[-1].update({
                "kernel_ms": row["kernel_ms"], "ms_b1": one["ms"],
                "kernel_ms_b1": one["kernel_ms"],
                "launch_floor_ms": floors[WAVE]["ms"],
                "launch_floor_kernel_ms": floors[WAVE]["kernel_ms"],
                "bound_floor_ms": row["bound_floor_ms"],
                "bound_floor_kernel_ms": row["bound_floor_kernel_ms"]})
        if not any(name in own for own in PATH_KERNELS.values()) \
                and name not in model_rows:
            kernels[-1]["note"] = ("launches on no path: the main path "
                                   "scores inside fused_prepare "
                                   "(nom::slot_cost), the split pipeline "
                                   "on the host, as the reference does")
    print(f"[done] {time.perf_counter() - t_start:.1f} s after the start of "
          f"the build ({smi})", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
