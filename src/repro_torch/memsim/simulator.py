"""Event/timestamp simulator for the four evaluated memory configurations
(port of ``repro.memsim.simulator``).

Configurations (paper Section 3):

* ``conventional`` — copies/initialization go through the processor: every
  64 B line is read over the vault TSV + off-chip link and written back.
* ``rowclone``     — RowClone FPM for same-subarray copies, LISA for other
  intra-bank copies, RowClone PSM over the *shared internal bus* for
  inter-bank copies (bus reserved for the whole copy).
* ``nom``          — inter-bank copies ride the TDM circuit-switched 3D mesh
  (full NoM); intra-bank copies still use RowClone/LISA, as the paper
  integrates them.
* ``nom_light``    — NoM with the shared-TSV vertical bus instead of
  dedicated Z links.

The processor is a closed-loop core with a fixed-size window of outstanding
memory operations (memory-level parallelism) — performance is reported as
effective IPC over a common per-workload instruction count, so IPC ratios
equal runtime speedups, matching how Fig. 4 compares configurations.

The simulator is host Python; on the NoM configs its CCU is a
:class:`~repro_torch.core.fabric.NomFabric` (or a ``FabricCluster`` with
``stacks > 1``) whose allocators run their search and prepare kernels on
``device`` — ``"cuda"`` by default, ``"cpu"`` for the kernels' plain
PyTorch versions.  The device is a keyword of :class:`MemorySystem` and
:func:`simulate`, not a :class:`SimParams` field, so the same
``SimParams`` mean the same run in this package and the reference.
"""
from __future__ import annotations

import dataclasses
import heapq
from collections import defaultdict

import numpy as np

from repro_torch.core.fabric import (AdmissionQueue, FabricCluster,
                                     FabricOverflow, NomFabric)
from repro_torch.core.slot_alloc import (PORT_LOCAL, CopyRequest,
                                         TdmAllocator, TdmAllocatorLight)
from repro_torch.core.topology import Mesh3D, StackedTopology, make_topology
from repro_torch.device import resolve_device

from .dram import OffChipLink, SharedInternalBus, Timing, VaultController
from .workloads import LINE, Op, Request

CONFIGS = ("conventional", "rowclone", "nom", "nom_light")


@dataclasses.dataclass
class SimParams:
    """Simulation knobs.  All time quantities are logic-die cycles.

    The ``nom_*`` fields model the CCU and router provisioning of the
    paper's NoM (Sections 2.1-2.3):

    * ``nom_link_ratio`` (default 1.0): NoM link frequency as a fraction
      of logic frequency (<= 1) — the paper's frequency-scaling study
      (Fig. 6); transfer durations are divided by this ratio.
    * ``nom_extra_slots`` (default 7): extra free TDM slots the CCU may
      bundle onto one circuit to accelerate it (Section 2.1's multi-slot
      circuits); 0 = one slot per circuit.
    * ``nom_ccu_queue_depth`` (default 8): capacity of the CCU's bounded
      request queue, in pending copy requests.  The CCU drains the queue
      with one batched setup pass (``TdmAllocator.allocate_batch``) when
      it fills; a copy issued against a full queue *backpressures* the
      core until the drain's pickup pipeline completes — the bounded
      router/controller buffering that the HMC NoC studies identify as
      the contention bottleneck.  Depth is clamped to
      ``nom_max_inflight`` when that cap is set (a queue deeper than the
      in-flight circuit budget could never drain faster anyway).
    * ``nom_max_inflight`` (default 0 = uncapped): per-TDM-window cap on
      concurrent circuits — the router-buffering calibration knob; an
      admission that would exceed it is pushed to a later window.
    """
    config: str = "nom"
    mesh: Mesh3D = dataclasses.field(default_factory=make_topology)
    n_slots: int = 16
    timing: Timing = dataclasses.field(default_factory=Timing)
    window: int = 32                 # outstanding memory ops (MLP window)
    line_window: int = 8             # in-flight lines inside a processor copy
    compute_gap: int = 2             # compute cycles between memory issues
    nom_link_ratio: float = 1.0      # NoM link freq / logic freq (<=1)
    nom_extra_slots: int = 7         # extra TDM slots the CCU may bundle
    nom_ccu_queue_depth: int = 8     # bounded CCU request queue (see above)
    nom_max_inflight: int = 0        # per-TDM-window circuit cap (0 = off)
    instr_per_line: int = 2          # conventional copy: LD+ST per line
    # Multi-stack: `stacks` > 1 chains that many copies of `mesh` over
    # SerDes links (bank ids become global ids over all stacks); under the
    # NoM configs the CCU becomes a FabricCluster and cross-stack copies
    # ride two-phase segmented circuits.
    stacks: int = 1
    stack_link: str = "ring"         # inter-stack link graph: ring | full
    serdes_latency: int = 8          # per-SerDes-hop beat latency (cycles)
    serdes_link_bytes: int = 4       # bytes per SerDes TDM slot-window


@dataclasses.dataclass
class SimResult:
    name: str
    config: str
    cycles: int
    instructions: int
    ipc: float
    reqs: int
    copy_bytes: int
    offchip_bytes: int
    nom_hop_beats: int
    bus_busy_cycles: int
    tsv_busy_frac: float
    tsv_conflict_frac: float
    row_hit_rate: float
    extra: dict = dataclasses.field(default_factory=dict)


class MemorySystem:
    """Shared geometry + per-config data paths.

    The NoM configs hold a :class:`~repro_torch.core.fabric.NomFabric`
    session (``self.fabric``): its
    :class:`~repro_torch.core.fabric.AdmissionQueue` *is* the CCU's
    bounded request queue (``self.ccu`` — sim and scheduler share one
    implementation), and every circuit setup goes through
    ``fabric.schedule`` against the config's allocator.  ``device`` is
    where those allocators keep their occupancy and run their kernels
    (``"cuda"`` by default; raises without a CUDA device unless
    ``"cpu"``)."""

    def __init__(self, p: SimParams, device="cuda"):
        self.p = p
        self.device = resolve_device(device)
        self.mesh = p.mesh                       # per-stack geometry
        self.topology = (make_topology(p.stacks, p.mesh, link=p.stack_link,
                                       link_latency=p.serdes_latency,
                                       link_bytes=p.serdes_link_bytes)
                         if p.stacks > 1 else p.mesh)
        self.stacked = isinstance(self.topology, StackedTopology)
        t = p.timing
        n_vaults = self.mesh.n_vaults * p.stacks
        banks_per_vault = len(self.mesh.banks_of_vault(0))
        self.vaults = [VaultController(t, banks_per_vault)
                       for _ in range(n_vaults)]
        self.offchip = OffChipLink(t)
        self.shared_bus = SharedInternalBus()
        alloc: TdmAllocator | None = None
        alloc_cls = {"nom": TdmAllocator, "nom_light": TdmAllocatorLight} \
            .get(p.config)
        stack_allocs: list[TdmAllocator] | None = None
        if alloc_cls is not None:
            if self.stacked:
                stack_allocs = [alloc_cls(m, p.n_slots, device=self.device)
                                for m in self.topology.stacks]
                alloc = stack_allocs[0]
            else:
                alloc = alloc_cls(self.mesh, p.n_slots, device=self.device)
        # Calibration against the RowClone-FPM row-cycle timing: an
        # in-bank zero costs t.rowclone_fpm logic cycles per row, i.e.
        # ceil(rowclone_fpm / n_slots) TDM windows — so the zero-hop
        # circuit's occupancy must cover that many windows per row, not
        # the old 1 window/row optimism.
        self.init_windows_per_row = max(1, -(-t.rowclone_fpm // p.n_slots))
        if alloc is not None:
            # ceil so a k-row INIT occupies exactly k * windows_per_row
            # windows (floor would overshoot by one window per row).
            for a in (stack_allocs or [alloc]):
                a.init_row_bytes = max(
                    1, -(-t.row_bytes // self.init_windows_per_row))
        # Bounded CCU request queue, calibrated against the router-buffering
        # cap: a queue deeper than the in-flight circuit budget would only
        # park requests the mesh cannot admit, so the cap clamps the depth.
        depth = max(1, p.nom_ccu_queue_depth)
        if p.nom_max_inflight:
            depth = max(1, min(depth, p.nom_max_inflight))
        self.fabric: NomFabric | FabricCluster | None = None
        if stack_allocs is not None:
            self.fabric = FabricCluster(topology=self.topology,
                                        queue_depth=depth, overflow="block",
                                        allocators=stack_allocs)
            self.ccu = self.fabric.queue
        elif alloc is not None:
            self.fabric = NomFabric(allocator=alloc, queue_depth=depth,
                                    overflow="block")
            self.ccu = self.fabric.queue
        else:
            self.ccu = AdmissionQueue(depth)
        self.nom_hop_beats = 0
        self.nom_init_windows = 0      # TDM windows held by zero-hop INITs
        self.init_rows = 0             # rows cleared in-DRAM (INIT energy)
        self.init_bytes = 0            # bytes zeroed in-DRAM (no column I/O)
        # stats for the TSV dual-use analysis (NoM-Light motivation)
        self.nom_vertical_cycles = 0
        # Concurrent-transfer telemetry: circuits in flight per TDM window.
        # Only windows at or past the live-circuit horizon stay in the
        # dict; fully-past windows are folded into the _inflight_* stats
        # by _prune_inflight so a long run's footprint stays bounded.
        self.window_inflight: dict[int, int] = {}
        self._inflight_sum = 0         # pruned windows: sum of counts
        self._inflight_windows = 0     # pruned windows: non-empty count
        self._inflight_max = 0         # pruned windows: peak count
        self.nom_alloc_conflicts = 0   # stale-search commit retries
        self.nom_setup_retries = 0     # saturated-mesh re-allocations
        # Allocator-backend split: prepare waves served by the fused
        # prepare kernel vs the host pipeline (ScheduleReport passthrough)
        self.nom_fused_waves = 0
        self.nom_host_waves = 0
        self.nom_batches = 0
        self.nom_batched_reqs = 0
        # SerDes window occupancy (multi-stack): (channel, slot)-windows
        # reserved, bytes that crossed inter-stack links (per directed
        # hop), and how many copies went cross-stack.
        self.serdes_windows = 0
        self.serdes_bytes = 0
        self.nom_cross_stack = 0
        # Compute-class (Op.REDUCE) telemetry: 64-bit merges executed by
        # destination-bank ALUs, and cycles lost to a busy ALU (a second
        # fan-in landing on a bank whose merge pipeline hasn't drained).
        self.nom_reduce_elems = 0
        self.nom_reduce_stalls = 0
        self._reduce_alu_free: dict[int, int] = {}  # dst bank -> ALU free-at

    # -- helpers -------------------------------------------------------------
    @property
    def alloc(self) -> TdmAllocator | None:
        """A representative allocator (None on non-NoM configs): the
        single fabric's, or stack 0's on a cluster — all stacks share the
        same width/slot parameters, which is what the window-estimate and
        telemetry callers need."""
        if self.fabric is None:
            return None
        if isinstance(self.fabric, FabricCluster):
            return self.fabric.fabrics[0].allocator
        return self.fabric.allocator

    def _locate(self, bank: int) -> tuple[int, int]:
        """Global bank id -> (stack, stack-local node id)."""
        return self.topology.locate(bank) if self.stacked else (0, bank)

    def _vault_bank(self, bank: int) -> tuple[VaultController, int]:
        stack, node = self._locate(bank)
        v = stack * self.mesh.n_vaults + self.mesh.vault_of(node)
        local = self.mesh.banks_of_vault(self.mesh.vault_of(node)).index(node)
        return self.vaults[v], local

    # -- window-inflight bookkeeping ------------------------------------------
    def _record_inflight(self, spans: list[tuple[int, int]]) -> None:
        """Fold one batch's ``(start_window, n_windows)`` spans into the
        per-window concurrency map with a single difference-array pass
        instead of one dict update per (circuit, window)."""
        if not spans:
            return
        w0 = min(s for s, _n in spans)
        w1 = max(s + n for s, n in spans)
        diff = np.zeros(w1 - w0 + 1, np.int64)
        for s, n in spans:
            diff[s - w0] += 1
            diff[s - w0 + n] -= 1
        counts = np.cumsum(diff[:-1])
        get = self.window_inflight.get
        for off in np.nonzero(counts)[0].tolist():
            w = w0 + off
            self.window_inflight[w] = get(w, 0) + int(counts[off])

    def _prune_inflight(self, horizon_w: int) -> None:
        """Drop windows strictly before ``horizon_w`` — the CCU pickup
        horizon is monotone, so nothing can increment or query them again
        — folding their counts into the running stats so the reported
        telemetry is unchanged while the map stays bounded."""
        stale = [w for w in self.window_inflight if w < horizon_w]
        for w in stale:
            n = self.window_inflight.pop(w)
            if n > 0:
                self._inflight_sum += n
                self._inflight_windows += 1
                self._inflight_max = max(self._inflight_max, n)

    def inflight_stats(self) -> tuple[float, int]:
        """(mean over non-empty TDM windows, peak) concurrent circuits,
        pruned and live windows combined — exactly what a full
        ``window_inflight`` map would report."""
        live = [n for n in self.window_inflight.values() if n > 0]
        total = self._inflight_sum + sum(live)
        count = self._inflight_windows + len(live)
        peak = max([self._inflight_max] + live)
        return (total / count if count else 0.0), peak

    def line_access(self, at: int, bank: int, row: int, is_write: bool,
                    priority: bool = False, offchip: bool = True) -> int:
        vc, b = self._vault_bank(bank)
        done = vc.access_line(at, b, row, is_write, priority=priority)
        if offchip:
            done = self.offchip.transfer(done, LINE)
        return done

    # -- copy paths ------------------------------------------------------------
    def copy_conventional(self, at: int, r: Request,
                          write_only: bool = False) -> int:
        """Processor-mediated copy/initialize: each 64B line is read over the
        vault TSV + off-chip link into the core and written back.

        The core sustains at most ``line_window`` line-transfers in flight
        (load/store-queue MLP), so a page copy is load-use-latency bound —
        the inefficiency RowClone/NoM eliminate."""
        lines = r.nbytes // LINE
        w = self.p.line_window
        vc, b = self._vault_bank(r.dst_bank)
        done = at
        # The memory controller batches reads then writes per MLP window so
        # same-bank copies don't ping-pong row activations line by line.
        for g in range(0, lines, w):
            batch = min(w, lines - g)
            ready = []
            for _ in range(batch):
                if write_only:
                    ready.append(self.offchip.transfer(at, LINE, down=True))
                else:
                    rd = self.line_access(at, r.src_bank, r.src_row, False)
                    ready.append(self.offchip.transfer(rd, LINE, down=True))
                at += 1
            for rd in ready:
                done = max(done, vc.access_line(rd, b, r.dst_row, True))
            # Next batch's reads overlap this batch's writes (prefetch-style
            # streaming); resource occupancy carries the contention.
            at = max(at, ready[-1] - self.p.timing.offchip_latency)
        return done

    def copy_in_dram_local(self, at: int, r: Request) -> int:
        """RowClone-FPM / LISA intra-bank copy (also used for INIT)."""
        t = self.p.timing
        vc, b = self._vault_bank(r.src_bank)
        rows = max(1, r.nbytes // t.row_bytes)
        if r.op == Op.INIT:
            self.init_rows += rows
            self.init_bytes += r.nbytes
        if r.same_subarray or r.op == Op.INIT:
            per_row = t.rowclone_fpm
        else:
            hops = 4  # average subarray distance for LISA RBM
            per_row = t.rowclone_fpm + hops * t.lisa_hop
        done = at
        for _ in range(rows):
            done = vc.bank_row_op(done, b, per_row)
        return done

    def copy_rowclone_psm(self, at: int, r: Request) -> int:
        """Inter-bank copy over the shared internal bus (bus reserved)."""
        t = self.p.timing
        lines = r.nbytes // LINE
        # src activate + per-line (read beat + write beat on the bus) + dst
        # restore; the row stays open so lines pipeline at burst occupancy.
        per_line = 2 * t.tBURST
        dur = t.tRCD + t.tCL + lines * per_line + t.tWR
        svc, sb = self._vault_bank(r.src_bank)
        dvc, db = self._vault_bank(r.dst_bank)
        ready = max(svc.banks[sb].s.free_at, dvc.banks[db].s.free_at, at)
        start, end = self.shared_bus.reserve(ready, dur)
        svc.banks[sb].s.free_at = end
        dvc.banks[db].s.free_at = end
        # The bus transfer also occupies both vaults' TSVs line by line.
        svc._tsv(start, lines * t.tBURST)
        dvc._tsv(start, lines * t.tBURST)
        return end

    def reduce_processor(self, at: int, r: Request) -> int:
        """Copy-then-compute fallback for Op.REDUCE on the non-NoM
        configs: every operand page round-trips through the processor
        (read over vault TSV + off-chip link, accumulate in the core,
        write the running sum back) — the traffic the compute-class NoM
        op eliminates.  Sequential in the operands: each pass
        read-modify-writes the same destination row."""
        done = at
        for s in r.src_banks:
            step = Request(Op.COPY, int(s), r.src_row, r.dst_bank,
                           r.dst_row, nbytes=r.nbytes)
            done = self.copy_conventional(done, step)
        return done

    def _finish_reduce(self, rq: CopyRequest, r: Request, c,
                       xfer_done: int) -> int:
        """Post-circuit accounting for one committed fan-in: mesh/SerDes
        beat counts, destination-bank ALU occupancy (with backpressure
        when a second fan-in lands on a busy ALU), and the destination
        row write.  Returns the drain cycle."""
        p, t = self.p, self.p.timing
        k = len(rq.srcs)
        beats = max(1, r.nbytes // 8)
        # Each per-source route carries `beats` over its own mesh hops;
        # LOCAL entries (arrival + ALU dwell) are occupancy, not traffic.
        mesh_hops = sum(1 for _n, prt, _s in c.hops if prt != PORT_LOCAL)
        self.nom_hop_beats += beats * mesh_hops
        link_slots = getattr(c, "link_slots", None)
        if link_slots:
            self.serdes_bytes += r.nbytes * len(link_slots)
            self.serdes_windows += c.n_windows * len(link_slots)
            self.nom_cross_stack += 1
        if p.config == "nom":
            d_stack, d_loc = self._locate(r.dst_bank)
            dz = self.mesh.coords(d_loc)[2]
            vert = 0
            for s in rq.srcs:
                s_stack, s_loc = self._locate(int(s))
                sz = self.mesh.coords(s_loc)[2]
                vert += (sz + dz) if s_stack != d_stack else abs(sz - dz)
            self.nom_vertical_cycles += vert * beats
        # Destination-bank ALU: merges k-1 operands into the resident
        # running sum at stream rate (one 64-bit lane), draining one
        # dwell window past the final beat.  A fan-in that lands while
        # the ALU is still draining a previous merge backpressures.
        elems = (k - 1) * beats
        self.nom_reduce_elems += elems
        free = self._reduce_alu_free.get(r.dst_bank, 0)
        if free > c.start_cycle:
            stall = free - c.start_cycle
            self.nom_reduce_stalls += stall
            xfer_done += stall
        dwell = max(0, getattr(self.alloc, "reduce_dwell", 1))
        self._reduce_alu_free[r.dst_bank] = xfer_done + dwell * p.n_slots
        dvc, db = self._vault_bank(r.dst_bank)
        return dvc.bank_row_op(xfer_done, db, t.tRCD + t.tWR)

    def copy_nom(self, at: int, r: Request) -> int:
        """Inter-bank copy over the TDM circuit-switched mesh (batch of 1)."""
        return self.copy_nom_batch([(at, r)])[0]

    def copy_nom_batch(self, items: list[tuple[int, "Request"]],
                       pickup_at: int = 0) -> list[int]:
        """Service a batch of inter-bank copies with one concurrent setup.

        The CCU searches every pending request in a single vectorized
        wavefront pass (``TdmAllocator.allocate_batch``) and programs the
        winning circuits back to back — one per cycle after the 3-cycle
        pipeline fill, versus one setup per 3 cycles when serviced one at a
        time.  The committed circuits are link-disjoint and stream
        concurrently; ``window_inflight`` records how many overlap each TDM
        window, and ``nom_max_inflight`` (if set) caps admissions per
        window, pushing the overflow to the next window (the increasing-
        slot fallback at window granularity)."""
        p, t = self.p, self.p.timing
        # 1) CCU picks up the batch (FIFO; pipelined 1/cycle after fill).
        # The search runs speculatively as requests arrive, so a scheduled
        # drain anchors at the head's arrival; a forced (queue-full) drain
        # passes ``pickup_at`` — it cannot start before the drain decision.
        pick0 = max(min(at for at, _r in items), self.ccu.busy_until,
                    pickup_at)
        self.ccu.busy_until = pick0 + 3 + (len(items) - 1)
        self.nom_batches += 1
        self.nom_batched_reqs += len(items)
        # The pickup horizon is monotone across batches, so every window
        # before it is settled history — fold it out of the live map.
        self._prune_inflight((pick0 + 3) // p.n_slots)
        # 2) source reads (row-granularity into the bank's CS buffer) via
        #    the high-priority copy queue.  An INIT has no source read:
        #    the CCU issues an in-bank RowClone-FPM zero, and its zero-hop
        #    circuit holds only the home bank's LOCAL port.
        reqs: list[CopyRequest] = []
        for i, (at, r) in enumerate(items):
            pick = max(at, pick0 + i)
            if r.op == Op.INIT:
                reqs.append(CopyRequest(r.src_bank, r.src_bank, r.nbytes,
                                        op="init", cycle=pick))
                continue
            if r.op == Op.REDUCE:
                # Every operand bank reads its row into the CS buffer; the
                # fan-in circuit is anchored at the slowest one.
                ready = pick + 3
                for s in r.src_banks:
                    svc, sb = self._vault_bank(int(s))
                    ready = max(ready, svc.bank_row_op(pick + 3, sb,
                                                       t.tRCD + t.tCL))
                reqs.append(CopyRequest(
                    int(r.src_banks[0]), r.dst_bank, r.nbytes, op="reduce",
                    srcs=tuple(int(s) for s in r.src_banks),
                    cycle=max(ready - 3, pick)))
                continue
            svc, sb = self._vault_bank(r.src_bank)
            ready = svc.bank_row_op(pick + 3, sb, t.tRCD + t.tCL)
            # 3) circuit allocation anchored so injection starts when data
            #    is ready (the CCU knows timings deterministically).
            reqs.append(CopyRequest(r.src_bank, r.dst_bank, r.nbytes,
                                    max_extra_slots=p.nom_extra_slots,
                                    cycle=max(ready - 3, pick)))
        batch_cycle = min(rq.cycle for rq in reqs)
        # Per-window concurrency cap: an admission is delayed until every
        # window its circuit could span (conservative slots=1 estimate,
        # +1 for injection rolling into the next window) has headroom over
        # the live circuits plus this batch's earlier admissions — the
        # increasing-slot fallback at window granularity.
        if p.nom_max_inflight:
            planned: dict[int, int] = defaultdict(int)
            bumped = []
            for rq in reqs:
                span = (self.alloc.n_windows_for_init(rq.nbytes)
                        if rq.op == "init"
                        else self.alloc.n_windows_for(rq.nbytes, slots=1)) + 1
                w = (rq.cycle + 3) // p.n_slots
                for _ in range(4096):   # bounded: circuits always expire
                    if all(self.window_inflight.get(u, 0) + planned[u]
                           < p.nom_max_inflight
                           for u in range(w, w + span)):
                        break
                    w += 1
                for u in range(w, w + span):
                    planned[u] += 1
                bumped.append(dataclasses.replace(
                    rq, cycle=max(rq.cycle, w * p.n_slots)))
            reqs = bumped
        results, report = self.fabric.schedule(reqs, cycle=batch_cycle)
        self.nom_alloc_conflicts += report.conflicts
        self.nom_fused_waves += report.fused_waves
        self.nom_host_waves += report.host_waves
        dones = []
        spans: list[tuple[int, int]] = []
        for rq, res, (_at, r) in zip(reqs, results, items):
            tries = 0
            while res.circuit is None and tries < 64:
                tries += 1
                self.nom_setup_retries += 1
                retry = dataclasses.replace(rq, cycle=None)
                (res,), _rep = self.fabric.schedule(
                    [retry], cycle=rq.cycle + tries * p.n_slots)
            c = res.circuit
            if c is None:
                self._record_inflight(spans)
                err = FabricOverflow(
                    f"NoM mesh persistently saturated: no circuit for "
                    f"{r.op.name} {rq.src}->{rq.dst} ({rq.nbytes}B) after "
                    f"{tries} retry windows from cycle {rq.cycle}")
                err.request = r
                err.retries = tries
                err.telemetry = {
                    "queue_depth": self.ccu.depth,
                    "queue_stall_cycles": self.ccu.stall_cycles,
                    "setup_retries": self.nom_setup_retries,
                    "table_utilization": self.alloc.table.utilization(
                        (rq.cycle + 3) // p.n_slots),
                }
                raise err
            w_start = c.start_cycle // p.n_slots   # actual streaming window
            spans.append((w_start, c.n_windows))
            if rq.op == "init":
                # Zero-hop circuit: the bank clears rows internally
                # (RowClone-FPM) while the circuit holds its LOCAL port;
                # nothing streams over mesh links.  The circuit's window
                # count is calibrated (init_windows_per_row windows per
                # row) so occupancy covers the modeled zeroing latency.
                self.nom_init_windows += c.n_windows
                vc, b = self._vault_bank(r.src_bank)
                rows = max(1, -(-r.nbytes // t.row_bytes))
                self.init_rows += rows
                self.init_bytes += r.nbytes
                done = c.start_cycle
                for _ in range(rows):
                    done = vc.bank_row_op(done, b, t.rowclone_fpm)
                dones.append(done)
                continue
            dist = max(c.distance, 1)
            # transfer duration in NoM-link cycles, scaled by link frequency.
            link_cycles = dist + (c.n_windows - 1) * p.n_slots
            xfer_done = c.start_cycle + int(np.ceil(link_cycles
                                                    / p.nom_link_ratio))
            if rq.op == "reduce":
                dones.append(self._finish_reduce(rq, r, c, xfer_done))
                continue
            link_slots = getattr(c, "link_slots", None)
            if link_slots:
                # Cross-stack: only the two mesh segments move beats over
                # TSV/mesh links; the SerDes share is accounted per
                # directed channel hop for the energy model.
                mesh_hops = (len(c.near_hops) - 1) + (len(c.far_hops) - 1)
                self.nom_hop_beats += (r.nbytes // 8) * mesh_hops
                self.serdes_bytes += r.nbytes * len(link_slots)
                self.serdes_windows += c.n_windows * len(link_slots)
                self.nom_cross_stack += 1
            else:
                self.nom_hop_beats += (r.nbytes // 8) * dist
            s_loc = self._locate(r.src_bank)[1]
            d_loc = self._locate(r.dst_bank)[1]
            if self.p.config == "nom":
                # dedicated-Z-link vertical beats (for the TSV dual-use
                # stat); a cross-stack copy descends to the near bridge on
                # layer 0 and climbs to the destination layer far-side.
                sz = self.mesh.coords(s_loc)[2]
                dz = self.mesh.coords(d_loc)[2]
                vert = (sz + dz) if link_slots else abs(sz - dz)
                self.nom_vertical_cycles += vert * (r.nbytes // 8)
            elif c.uses_bus and c.bus_column >= 0:
                # NoM-Light: the vertical hop rides the existing TSV of that
                # column's vault, stealing bandwidth from regular accesses —
                # the bandwidth cost behind the paper's 5-20% gap.
                col_bank = c.bus_column  # a z=0 bank id shares the column idx
                if self.stacked:   # map the stack-local column to its stack
                    col_bank = self.topology.global_id(
                        self._locate(r.src_bank)[0], col_bank)
                vc, _b = self._vault_bank(col_bank)
                vc._tsv(c.start_cycle, r.nbytes // 8)
            # 4) destination write via the copy queue.
            dvc, db = self._vault_bank(r.dst_bank)
            dones.append(dvc.bank_row_op(xfer_done, db, t.tRCD + t.tWR))
        self._record_inflight(spans)
        return dones


def simulate(reqs: list[Request], p: SimParams, name: str = "",
             device="cuda") -> SimResult:
    """Run the closed-loop core over the request stream.

    Under the NoM configs, inter-bank copies *and* bulk initializations
    accumulate in the CCU's bounded request queue (``sys.ccu``, depth
    ``p.nom_ccu_queue_depth``) and are drained by a single batched
    circuit setup (``copy_nom_batch``) — the paper's concurrent circuit
    establishment, over its mixed copy/INIT workload.  A request issued
    against a full queue backpressures the core until the drain's pickup
    pipeline completes; the lost cycles are reported as
    ``extra["nom_ccu_stall_cycles"]``, and the INIT share of the queue
    and of the TDM windows as ``extra["nom_ccu_init_*"]``.

    ``device`` is passed to :class:`MemorySystem`: the CCU's allocators
    run on the card by default, on their plain versions with ``"cpu"``."""
    sys = MemorySystem(p, device=device)
    t = p.timing
    outstanding: list[int] = []   # completion-time min-heap
    core_time = 0
    total_instr = 0               # config-independent instruction count
    copy_bytes = 0
    nom = p.config in ("nom", "nom_light")

    def flush_copies(pickup_at: int = 0):
        if sys.ccu.items:
            for done in sys.copy_nom_batch(sys.ccu.items, pickup_at):
                heapq.heappush(outstanding, done)
            sys.ccu.items.clear()

    def enqueue_nom(issue: int, r: Request) -> int:
        """Admit a copy/INIT into the bounded CCU queue.  The depth
        bounds both dimensions of the CCU's service budget — at most
        ``depth`` buffered requests, and the head waits at most ``depth``
        TDM windows before its batched pickup pass (the concurrent
        circuit establishment).  A request that finds the buffer at depth
        forces an early drain and backpressures the core until the pickup
        pipeline completes.  Returns the (possibly stalled) issue cycle."""
        q = sys.ccu
        if q.items and (issue // p.n_slots
                        - q.items[0][0] // p.n_slots) >= q.depth:
            flush_copies()
        if q.full():
            flush_copies(pickup_at=issue)
            freed = max(issue, q.busy_until)
            q.stall_cycles += freed - issue
            q.full_stalls += 1
            issue = freed
        q.push(issue, r)
        return issue

    for r in reqs:
        # Respect the MLP window (queued CCU copies count as outstanding).
        while len(outstanding) + len(sys.ccu.items) >= p.window:
            if not outstanding:   # only CCU-queued copies left: materialize
                flush_copies()
                continue
            core_time = max(core_time, heapq.heappop(outstanding))
        issue = core_time = core_time + p.compute_gap
        total_instr += p.compute_gap

        if r.op in (Op.READ, Op.WRITE):
            total_instr += 1
            done = sys.line_access(issue, r.src_bank, r.src_row,
                                   r.op == Op.WRITE)
        elif r.op == Op.INIT:
            total_instr += r.nbytes // LINE * 1  # conventional stores
            copy_bytes += r.nbytes
            if p.config == "conventional":
                done = sys.copy_conventional(issue, r, write_only=True)
            elif not nom:
                done = sys.copy_in_dram_local(issue, r)
            else:
                # INIT rides the CCU queue too: the zeroing is still
                # in-bank (RowClone-FPM), but issue/admission shares the
                # bounded buffer with copies, and the zero-hop circuit's
                # occupancy lands in the nom_ccu_* telemetry.
                core_time = max(core_time, enqueue_nom(issue, r))
                continue
        elif r.op == Op.REDUCE:
            k = max(1, len(r.src_banks))
            # k loads + 1 accumulate-store per line, config-independent.
            total_instr += r.nbytes // LINE * (k + 1)
            copy_bytes += r.nbytes * k
            if nom:
                core_time = max(core_time, enqueue_nom(issue, r))
                continue
            done = sys.reduce_processor(issue, r)
        else:  # COPY
            total_instr += r.nbytes // LINE * p.instr_per_line
            copy_bytes += r.nbytes
            if p.config == "conventional":
                done = sys.copy_conventional(issue, r)
            elif r.intra_bank:
                done = sys.copy_in_dram_local(issue, r)
            elif p.config == "rowclone":
                done = sys.copy_rowclone_psm(issue, r)
            else:
                core_time = max(core_time, enqueue_nom(issue, r))
                continue
        heapq.heappush(outstanding, done)

    flush_copies()
    while outstanding:
        core_time = max(core_time, heapq.heappop(outstanding))
    cycles = max(1, core_time)

    tsv_busy = sum(v.tsv_busy_cycles for v in sys.vaults)
    tsv_frac = tsv_busy / (cycles * len(sys.vaults))
    # Probability that a dedicated-Z NoM beat coincides with TSV activity —
    # the observation motivating NoM-Light (Section 2.3).
    conflict = (sys.nom_vertical_cycles / max(cycles, 1)) * tsv_frac
    hit = float(np.mean([v.row_hit_rate for v in sys.vaults]))
    inflight_avg, inflight_max = sys.inflight_stats()
    extra = {}
    if p.config != "conventional":
        # In-DRAM zeroing (RowClone-FPM): rows cleared (charged e_init_row
        # each by the energy model) and the bytes they covered (excluded
        # from the per-line column-I/O energy — nothing left the mats).
        extra["init_rows"] = sys.init_rows
        extra["init_bytes"] = sys.init_bytes
    if nom:
        extra |= {
            "nom_inflight_avg": inflight_avg,
            "nom_inflight_max": int(inflight_max),
            "nom_alloc_conflicts": sys.nom_alloc_conflicts,
            "nom_setup_retries": sys.nom_setup_retries,
            "nom_fused_waves": sys.nom_fused_waves,
            "nom_host_waves": sys.nom_host_waves,
            "nom_batches": sys.nom_batches,
            "nom_batch_avg": (sys.nom_batched_reqs / sys.nom_batches
                              if sys.nom_batches else 0.0),
            "nom_ccu_queue_depth": sys.ccu.depth,
            "nom_ccu_peak_queue": sys.ccu.peak_occupancy,
            "nom_ccu_full_stalls": sys.ccu.full_stalls,
            "nom_ccu_stall_cycles": sys.ccu.stall_cycles,
            # INIT-class occupancy, separately: how much of the bounded
            # queue and of the TDM windows the initialization traffic eats.
            "nom_ccu_init_reqs": sys.ccu.init_reqs,
            "nom_ccu_init_peak": sys.ccu.peak_init,
            "nom_ccu_init_windows": sys.nom_init_windows,
            # Compute-class occupancy: destination-bank ALU merges and
            # the cycles fan-ins lost to a still-draining ALU.
            "nom_reduce_elems": sys.nom_reduce_elems,
            "nom_reduce_stalls": sys.nom_reduce_stalls,
        }
    if nom and p.stacks > 1:
        seg = sys.fabric.segmented
        extra |= {
            "n_stacks": p.stacks,
            "nom_cross_stack": sys.nom_cross_stack,
            "serdes_windows": sys.serdes_windows,
            "serdes_bytes": sys.serdes_bytes,
            "serdes_rollbacks": seg.rollbacks,
            "serdes_denied": seg.denied,
        }
    return SimResult(
        name=name, config=p.config, cycles=cycles, instructions=total_instr,
        ipc=total_instr / cycles, reqs=len(reqs), copy_bytes=copy_bytes,
        offchip_bytes=sys.offchip.bytes_moved, nom_hop_beats=sys.nom_hop_beats,
        bus_busy_cycles=sys.shared_bus.busy_cycles, tsv_busy_frac=tsv_frac,
        tsv_conflict_frac=conflict, row_hit_rate=hit, extra=extra)
