"""DRAM bank / vault timing model for the HMC-like baseline (Section 3);
port of ``repro.memsim.dram`` (host Python, unchanged logic).

Timing is expressed in *logic-layer cycles* at 1.25 GHz (0.8 ns), with
DDR3-1600-derived latencies (paper: "circuit-level parameters and memory
timing parameters are set based on DDR3 DRAM").  The model captures what the
paper's evaluation depends on: row-buffer hits/misses, per-bank service
serialization, per-vault TSV-bus beats, and a priority Copy queue next to the
regular R/W queue in every vault controller (Fig. 2, bottom right).
"""
from __future__ import annotations

import dataclasses

import numpy as np

LOGIC_GHZ = 1.25
NS = LOGIC_GHZ  # cycles per nanosecond


def ns(x: float) -> int:
    return int(round(x * NS))


@dataclasses.dataclass(frozen=True)
class Timing:
    """DDR3-1600-ish latencies in 1.25 GHz logic cycles."""
    tCL: int = ns(13.75)     # CAS
    tRCD: int = ns(13.75)    # activate -> column
    tRP: int = ns(13.75)     # precharge
    tRAS: int = ns(35.0)     # activate -> precharge
    tBURST: int = 8          # 64B over a 64-bit internal bus, 8 beats
    tWR: int = ns(15.0)      # write recovery
    # In-DRAM copy primitives (integrated into all non-conventional configs):
    rowclone_fpm: int = ns(90.0)    # intra-subarray row copy (RowClone FPM)
    lisa_hop: int = ns(8.0)         # per-subarray-hop row relocation (LISA)
    # Off-chip round trip for processor-mediated copies.
    offchip_latency: int = ns(60.0)
    offchip_bytes_per_cycle: float = 16.0   # ~20 GB/s effective per direction

    row_bytes: int = 8192
    line_bytes: int = 64


@dataclasses.dataclass
class BankState:
    free_at: int = 0
    open_row: int = -1


class Bank:
    """Row-buffer-aware single bank."""

    def __init__(self, timing: Timing):
        self.t = timing
        self.s = BankState()
        self.accesses = 0
        self.row_hits = 0

    def access(self, at: int, row: int, is_write: bool) -> tuple[int, int]:
        """Schedule a 64B column access; returns (data_ready, bank_free).

        Row-buffer hits pipeline at burst occupancy (tCCD~tBURST); tCL is
        latency, not occupancy.  Write recovery is charged on the precharge
        path (row change), as in DDR3 bank state machines.
        """
        t = self.t
        start = max(at, self.s.free_at)
        if self.s.open_row == row:
            lat = t.tCL
            self.row_hits += 1
        elif self.s.open_row < 0:
            lat = t.tRCD + t.tCL
        else:
            lat = t.tRP + t.tWR + t.tRCD + t.tCL
        self.s.open_row = row
        ready = start + lat + t.tBURST
        self.s.free_at = start + (lat - t.tCL) + t.tBURST  # occupancy only
        self.accesses += 1
        return ready, self.s.free_at

    def row_op(self, at: int, cycles: int) -> int:
        """Occupy the bank for an in-DRAM row-granularity operation."""
        start = max(at, self.s.free_at)
        self.s.free_at = start + cycles
        self.s.open_row = -1   # row ops end precharged
        self.accesses += 1
        return self.s.free_at


class VaultController:
    """One vault: a TSV data bus shared by its banks, plus two queues.

    Copy-related reads/writes go to a high-priority queue (the paper's Copy
    Q); in this timestamp model priority manifests as copy traffic not
    waiting behind queued regular requests, only behind in-flight bus beats.
    """

    def __init__(self, timing: Timing, n_banks: int):
        self.t = timing
        self.banks = [Bank(timing) for _ in range(n_banks)]
        self.tsv_free_at = 0
        self.tsv_busy_cycles = 0
        self.regular_backlog_at = 0

    def _tsv(self, at: int, beats: int) -> int:
        start = max(at, self.tsv_free_at)
        self.tsv_free_at = start + beats
        self.tsv_busy_cycles += beats
        return self.tsv_free_at

    def access_line(self, at: int, bank: int, row: int, is_write: bool,
                    priority: bool = False) -> int:
        """64B access; returns cycle at which data has crossed the TSV.

        Contention is carried by the bank (burst occupancy, row misses) and
        the TSV bus (beat occupancy); the controller itself pipelines, so no
        additional serialization is imposed here.
        """
        del priority  # priority shows up as not using the TSV at all (row ops)
        ready, _free = self.banks[bank].access(at, row, is_write)
        return self._tsv(ready, self.t.tBURST)

    def bank_row_op(self, at: int, bank: int, cycles: int) -> int:
        return self.banks[bank].row_op(at, cycles)

    @property
    def row_hit_rate(self) -> float:
        a = sum(b.accesses for b in self.banks)
        h = sum(b.row_hits for b in self.banks)
        return h / max(1, a)


class OffChipLink:
    """Processor<->memory SerDes path (full duplex: independent up/down
    lanes, as in HMC SerDes links).  ``transfer`` occupies one lane for the
    serialization time and returns the arrival cycle (occupancy + latency)."""

    def __init__(self, timing: Timing):
        self.t = timing
        self.lane_free = [0, 0]   # 0: memory->cpu (read data), 1: cpu->memory
        self.bytes_moved = 0

    def transfer(self, at: int, nbytes: int, down: bool = False) -> int:
        lane = 1 if down else 0
        start = max(at, self.lane_free[lane])
        dur = int(np.ceil(nbytes / self.t.offchip_bytes_per_cycle))
        self.lane_free[lane] = start + dur
        self.bytes_moved += nbytes
        return start + dur + self.t.offchip_latency

    @property
    def free_at(self) -> int:
        return max(self.lane_free)


class SharedInternalBus:
    """The global internal bus RowClone PSM uses for inter-bank copies.

    It is *reserved* for the whole copy ("other memory requests ... are
    therefore delayed"): one copy at a time, serializing with every other
    inter-bank copy in the chip.
    """

    def __init__(self):
        self.free_at = 0
        self.busy_cycles = 0

    def reserve(self, at: int, cycles: int) -> tuple[int, int]:
        start = max(at, self.free_at)
        self.free_at = start + cycles
        self.busy_cycles += cycles
        return start, self.free_at
