#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port of NoM (``src/repro_torch``) on one GPU.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine
with an NVIDIA H100 (``sm_90a``), the CUDA toolkit and PyTorch built for
CUDA.  It imports nothing of JAX or of the JAX package ``repro``.

Phases (each prints one line, any failure exits non-zero):

1. build — compile the three slot-allocator kernels from
   ``src/repro_torch/kernels/slot_alloc/csrc`` (one nvcc each, in
   parallel);
2. kernels — wavefront search, slot scoring and fused prepare against
   their plain PyTorch versions on the card, bit-equal, at the paper mesh
   (8x8x4) with 16 and 32 slots and batches of 64, 1000 and 1024, on
   occupancy taken from a real allocator state; times at the main
   path's shape (a 64-request search wave, 16 slots);
3. slice — ``NomFabric(mesh=PAPER_MESH, n_slots=16)`` with the fused,
   host and auto allocator backends, and a NoM-Light fabric, on one seeded
   stream of 4096 transfers (copies of 512 B-64 KB with 0-3 extra slots,
   in-place inits, fan-in reduces) in 8 flushes: every circuit and
   schedule report must agree across backends (reports up to the
   fused/host wave split, which differs by construction) and with the
   plain PyTorch versions on the CPU, and every circuit must be well
   formed.  Each path runs with the launch counts set to 0 just before
   it and read just after: its own kernels (``PATH_KERNELS``) must have
   launched, and no other;
4. timing — µs per allocation of each path over rotated rounds (median
   and range), and the host time of one split-pipeline scoring round on
   the scoring kernel against numpy (the allocator's choice);
5. launches — the per-path counts in the kernel table (one JSON line),
   the card's name and power limit, and the closing ``{"ok": true, ...}``
   line.
"""
from __future__ import annotations

import dataclasses
import json
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
    import torch
    from repro_torch.core.bitvec import full_mask, packed_tensor
    srcs = rng.integers(mesh.n_nodes, size=B)
    dsts = rng.integers(mesh.n_nodes, size=B)
    srcs[:2] = dsts[:2] = 0           # power-of-two pad rows: src = dst = 0
    dsts[2:6] = srcs[2:6]             # zero-distance requests
    init = rng.integers(0, full_mask(n_slots) + 1, size=B,
                        dtype=np.uint64).astype(np.uint32)
    t_ready = rng.integers(3, 2 ** 20, size=B)
    as_t = lambda a: torch.as_tensor(a, device=device)   # noqa: E731
    return (as_t(srcs), as_t(dsts), packed_tensor(init, device),
            as_t(t_ready), srcs, dsts)


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


def raw_launcher(name: str, device, *args):
    """A zero-overhead relaunch of kernel ``name`` for timing: the C
    entry point with its arguments resolved once (these launches are
    not counted; they only measure)."""
    import torch
    from repro_torch.kernels.slot_alloc import _lib
    if device.type != "cuda":
        return None
    fn = getattr(_lib._library(name), f"{name}_launch")
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    stream = torch.cuda.current_stream(device).cuda_stream

    def go(_keep=args):        # holds the tensors behind the raw pointers
        rc = fn(*cargs, stream)
        if rc:
            raise SmokeFailure(f"{name} relaunch failed with CUDA error {rc}")
    return go


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


def phase_kernels(mesh, device, batches=(64, 1000, 1024), slots=(16, 32),
                  reps=200):
    """Every kernel against its plain version at the given shapes;
    returns the timed kernel-table rows and each kernel's largest
    |kernel - plain| over all shapes."""
    import torch
    from repro_torch.core import PORT_LOCAL
    from repro_torch.core.bitvec import as_i32_bits, as_i64
    from repro_torch.kernels.slot_alloc import fused as kf
    from repro_torch.kernels.slot_alloc import slot_alloc as ks
    from repro_torch.kernels.slot_alloc import _lib
    rng = np.random.default_rng(SEED)
    rows = {}
    max_err: dict[str, int] = {}
    for n_slots in slots:
        occ, _alloc = occupied_table(mesh, n_slots, device)
        for B in batches:
            s, d, init, t, srcs_np, dsts_np = kernel_inputs(
                mesh, n_slots, B, device, rng)
            kw = dict(mesh=mesh, n_slots=n_slots)
            # -- search
            got = ks.wavefront_search_packed(occ, s, d, init, **kw)
            want = ks.wavefront_search_plain(occ, s, d, init, **kw)
            err_s = int((as_i64(got) - as_i64(want)).abs().max())
            # -- scoring, on the real availability vectors
            avail = want[torch.arange(B, device=device), d] | as_i64(
                occ)[d, PORT_LOCAL]
            dist = torch.as_tensor(np.abs(mesh.coord_array[srcs_np]
                                          - mesh.coord_array[dsts_np]).sum(1),
                                   device=device)
            got_c = kf.slot_score(avail, dist, t, n_slots=n_slots)
            want_c = kf.slot_score_plain(avail, dist, t, n_slots)
            err_c = int((got_c.long() - want_c.long()).abs().max())
            # -- fused prepare
            gi, gf, gv = kf.fused_prepare_packed(occ, s, d, t, **kw)
            wi, wf, wv = kf.fused_prepare_plain(occ, s, d, t, **kw)
            err_f = max(int((gi.long() - wi.long()).abs().max()),
                        int((gf.long() - wf.long()).abs().max()),
                        int((as_i64(gv) - as_i64(wv)).abs().max()))
            for name, err in (("wavefront_search", err_s),
                              ("slot_score", err_c), ("fused_prepare", err_f)):
                max_err[name] = max(max_err.get(name, 0), err)
            check(err_s == err_c == err_f == 0,
                  f"kernel != plain at n_slots={n_slots} B={B}: search "
                  f"{err_s} score {err_c} fused {err_f}")
            nd = int(wf[:, 0].sum())
            line = (f"[kernels] n_slots={n_slots} B={B}: search, score, "
                    f"fused bit-equal to plain (tolerance 0; "
                    f"{nd} denied rows)")
            if n_slots == 16 and B in (WAVE, max(batches)):
                wb = work(mesh, n_slots, srcs_np, dsts_np)
                thr = _lib.cta_threads(mesh.n_nodes)
                X, Y, Z = mesh.X, mesh.Y, mesh.Z
                occ32 = as_i32_bits(occ)
                timed = {
                    "wavefront_search": (
                        raw_launcher("wavefront_search", device, occ32,
                                     s.int(), d.int(), init, got, B, X, Y, Z,
                                     n_slots, thr),
                        lambda: ks.wavefront_search_plain(occ, s, d, init,
                                                          **kw)),
                    "slot_score": (
                        raw_launcher("slot_score", device,
                                     as_i32_bits(avail), dist.int(), t.int(),
                                     got_c, B, n_slots),
                        lambda: kf.slot_score_plain(avail, dist, t, n_slots)),
                    "fused_prepare": (
                        raw_launcher("fused_prepare", device, occ32, s.int(),
                                     d.int(), t.int(), gi, gf, gv, B, X, Y,
                                     Z, n_slots, thr),
                        lambda: kf.fused_prepare_plain(occ, s, d, t, **kw)),
                }
                parts = []
                for name, (kern, plain) in timed.items():
                    nbytes, ops = wb[name]
                    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                    t_ops = ops / ALU_OPS_PER_S * 1e3
                    row = {
                        "ms": (ms_per_call(kern, reps, device)
                               if kern else None),
                        "plain_ms": ms_per_call(plain, max(5, reps // 20),
                                                device),
                        "bound_ms": max(t_bytes, t_ops),
                        "bound_by": "bytes" if t_bytes >= t_ops
                        else "operations",
                        "bytes": nbytes, "ops": ops}
                    rows[(name, B)] = row
                    parts.append(f"{name} {row['ms']} ms (plain "
                                 f"{row['plain_ms']} ms, bound "
                                 f"{row['bound_ms']:.3g} ms by "
                                 f"{row['bound_by']})")
                line += "; " + "; ".join(parts)
            print(line, flush=True)
    return rows, max_err


# ---------------------------------------------------------------------------
# Phase 3: the slice end to end
# ---------------------------------------------------------------------------
def drive(fabric, chunks):
    """Schedule every chunk (one flush each, overlapping in time);
    returns (results, reports, seconds)."""
    import torch
    results, reports = [], []
    t0 = time.perf_counter()
    for k, chunk in enumerate(chunks):
        res, rep = fabric.schedule(chunk, cycle=k * 2048)
        results += res
        reports.append(rep)
    if fabric.allocator.device.type == "cuda":
        torch.cuda.synchronize(fabric.allocator.device)
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


def phase_slice(mesh, device, chunks, cpu_check=True):
    """The four paths on the device, each driven with the launch counts
    set to 0 just before it and read just after, checked against each
    other, the plain CPU versions and the circuit invariants.  Returns
    (stats, per-path launch counts)."""
    from repro_torch.kernels.slot_alloc import _lib
    n_slots = N_SLOTS
    reqs = [r for c in chunks for r in c]
    runs, launches = {}, {}
    for kind in PATHS:
        fab = make_fabric(mesh, kind, device)
        _lib.reset_launch_counts()
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


def phase_timing(mesh, device, chunks, keys, rounds=8):
    """µs per allocation of every path: ``rounds`` rounds, each running
    every path on a fresh fabric, with the order rotated by one place per
    round (each path takes each place equally often when ``rounds`` is a
    multiple of the number of paths).  Returns path -> sorted samples."""
    n = sum(len(c) for c in chunks)
    samples = {k: [] for k in PATHS}
    for r in range(rounds):
        for k in PATHS[r % len(PATHS):] + PATHS[:r % len(PATHS)]:
            res, _reps, secs = drive(make_fabric(mesh, k, device), chunks)
            check([circuit_key(x.circuit) for x in res] == keys[k],
                  f"{k}: circuits differ from the checked run")
            samples[k].append(secs / n * 1e6)
    out = {k: sorted(v) for k, v in samples.items()}
    print("[timing] us/alloc median (min-max) over "
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


# ---------------------------------------------------------------------------
def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


KERNEL_META = {
    "wavefront_search": ("src/repro_torch/kernels/slot_alloc/csrc/"
                         "wavefront_search.cu",
                         "src/repro/kernels/slot_alloc/slot_alloc.py:76"),
    "slot_score": ("src/repro_torch/kernels/slot_alloc/csrc/slot_score.cu",
                   "src/repro/kernels/slot_alloc/fused.py:86"),
    "fused_prepare": ("src/repro_torch/kernels/slot_alloc/csrc/"
                      "fused_prepare.cu",
                      "src/repro/kernels/slot_alloc/fused.py:213"),
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
    from repro_torch.core import PAPER_MESH
    from repro_torch.kernels.slot_alloc import _lib
    device = torch.device("cuda", 0)
    print(f"[device] {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    secs = _lib.build()
    regs = {k: [ln.strip() for ln in v.splitlines()
                if "registers" in ln or "spill" in ln]
            for k, v in _lib.build_log.items()}
    print(f"[build] {len(_lib.KERNELS)} kernels built in {secs:.2f} s "
          f"{json.dumps(regs)}", flush=True)

    rows, max_err = phase_kernels(PAPER_MESH, device)

    chunks = make_stream(PAPER_MESH, N_TRANSFERS, SEED, N_FLUSHES)
    stats, launches, keys = phase_slice(PAPER_MESH, device, chunks)
    timing = phase_timing(PAPER_MESH, device, chunks, keys)
    phase_scoring(PAPER_MESH, device, launches["host"]["wavefront_search"])

    smi = nvidia_smi()
    print("[alloc] us/alloc median " + " ".join(
        f"{k} {np.median(v):.2f}" for k, v in timing.items())
        + f" ({smi})", flush=True)
    # Upper estimate of the kernels' share of each path's wall time:
    # every launch priced at its 64-request time (conflict re-searches
    # launch 1-request waves, which take no longer).
    share = {}
    for kind, counts in launches.items():
        kern_ms = sum(v * rows[(k, WAVE)]["ms"] for k, v in counts.items())
        share[kind] = (f"{kern_ms:.3f} ms of "
                       f"{stats[kind]['seconds'] * 1e3:.1f} ms "
                       f"({100 * kern_ms / (stats[kind]['seconds'] * 1e3):.2f} %)")
    print(f"[where] kernel time <= {json.dumps(share)}", flush=True)
    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        row = rows[(name, WAVE)]
        by_path = {kind: counts[name] for kind, counts in launches.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max_err[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None})
        if not any(name in own for own in PATH_KERNELS.values()):
            kernels[-1]["note"] = ("launches on no path: the main path "
                                   "scores inside fused_prepare "
                                   "(nom::slot_cost), the split pipeline "
                                   "on the host, as the reference does")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
