"""Copy-intensive workload generators (paper Section 3, Fig. 3); port of
``repro.memsim.workloads`` (the same numpy ``default_rng`` stream, drawn
in the same order, so a seed gives the same requests in both packages).

Each workload is a deterministic (seeded) request stream with a traffic mix
matching Fig. 3: *fork* (the OS service dominated by page copies on
copy-on-write faults) and *fileCopyXX* (memcached-like object caching with
XX% of memory traffic from inter-bank object copies).  Traffic fractions are
fractions of **bytes moved**, as in the paper's breakdown; copies move 4 KB
pages, regular accesses move 64 B lines.
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np


class Op(enum.Enum):
    READ = 0
    WRITE = 1
    COPY = 2       # src page -> dst page
    INIT = 3       # zero a page
    REDUCE = 4     # combine N source pages at the destination bank


@dataclasses.dataclass(frozen=True)
class Request:
    op: Op
    src_bank: int
    src_row: int
    dst_bank: int = -1
    dst_row: int = -1
    nbytes: int = 64
    intra_bank: bool = False
    same_subarray: bool = False
    # REDUCE fan-in: every source bank whose operand merges at dst_bank
    # (src_bank mirrors src_banks[0]); empty for the other classes.
    src_banks: tuple = ()


@dataclasses.dataclass(frozen=True)
class TrafficMix:
    """Byte-fractions per class; must sum to 1."""
    inter_bank_copy: float
    intra_bank_copy: float
    init: float
    regular: float
    reduce: float = 0.0

    def __post_init__(self):
        total = (self.inter_bank_copy + self.intra_bank_copy + self.init
                 + self.regular + self.reduce)
        assert abs(total - 1.0) < 1e-9, total


# Fig. 3 mixes (inter-bank copy share is the workload's defining number).
# The *Reduce* mixes are ours, not the paper's: optimizer-state
# accumulation / gradient-aggregation services where a compute-class
# fan-in (Op.REDUCE) replaces the copy-then-compute round trip.
WORKLOADS: dict[str, TrafficMix] = {
    "fork":       TrafficMix(0.25, 0.20, 0.15, 0.40),
    "fileCopy20": TrafficMix(0.20, 0.10, 0.10, 0.60),
    "fileCopy40": TrafficMix(0.40, 0.10, 0.08, 0.42),
    "fileCopy60": TrafficMix(0.60, 0.08, 0.05, 0.27),
    "gradAgg20":  TrafficMix(0.10, 0.05, 0.05, 0.60, 0.20),
    "gradAgg40":  TrafficMix(0.10, 0.05, 0.05, 0.40, 0.40),
}

PAGE = 4096
LINE = 64


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    name: str
    n_requests: int = 2000
    n_banks: int = 256
    rows_per_bank: int = 2048
    seed: int = 0
    locality: float = 0.5   # P(regular access hits the currently open row)
    same_subarray_frac: float = 0.5  # intra-bank copies in the same subarray
    reduce_fanin: int = 4   # operands per Op.REDUCE fan-in


def generate(spec: WorkloadSpec) -> list[Request]:
    mix = WORKLOADS[spec.name]
    rng = np.random.default_rng(spec.seed)
    # Convert byte fractions to request counts: a copy/init request moves a
    # page (PAGE bytes), a regular request moves LINE bytes.  Counts are
    # stratified (not sampled) so the realized byte mix matches Fig. 3
    # exactly up to rounding, then the order is shuffled.
    # A reduce request moves fanin operand pages to one destination.
    w = np.array([mix.inter_bank_copy / PAGE, mix.intra_bank_copy / PAGE,
                  mix.init / PAGE, mix.regular / LINE,
                  mix.reduce / (PAGE * max(1, spec.reduce_fanin))])
    p = w / w.sum()
    counts = np.floor(p * spec.n_requests).astype(int)
    counts[np.argmax(p)] += spec.n_requests - counts.sum()
    kinds = np.repeat(np.arange(5), counts)
    rng.shuffle(kinds)
    reqs: list[Request] = []
    open_rows = np.full(spec.n_banks, -1)
    for k in kinds:
        src = int(rng.integers(spec.n_banks))
        if k == 0:  # inter-bank copy
            dst = int(rng.integers(spec.n_banks - 1))
            dst += dst >= src
            reqs.append(Request(Op.COPY, src, int(rng.integers(spec.rows_per_bank)),
                                dst, int(rng.integers(spec.rows_per_bank)),
                                nbytes=PAGE))
        elif k == 1:  # intra-bank copy
            same_sub = bool(rng.random() < spec.same_subarray_frac)
            reqs.append(Request(Op.COPY, src, int(rng.integers(spec.rows_per_bank)),
                                src, int(rng.integers(spec.rows_per_bank)),
                                nbytes=PAGE, intra_bank=True,
                                same_subarray=same_sub))
        elif k == 2:  # init
            row = int(rng.integers(spec.rows_per_bank))
            reqs.append(Request(Op.INIT, src, row, src, row, nbytes=PAGE))
        elif k == 4:  # compute-class fan-in reduce
            fanin = min(max(1, spec.reduce_fanin), spec.n_banks - 1)
            banks = rng.choice(spec.n_banks, size=fanin + 1, replace=False)
            srcs, dst = banks[:-1], int(banks[-1])
            reqs.append(Request(Op.REDUCE, int(srcs[0]),
                                int(rng.integers(spec.rows_per_bank)),
                                dst, int(rng.integers(spec.rows_per_bank)),
                                nbytes=PAGE,
                                src_banks=tuple(int(b) for b in srcs)))
        else:  # regular read/write
            if open_rows[src] >= 0 and rng.random() < spec.locality:
                row = int(open_rows[src])
            else:
                row = int(rng.integers(spec.rows_per_bank))
            open_rows[src] = row
            is_wr = bool(rng.random() < 0.35)
            reqs.append(Request(Op.WRITE if is_wr else Op.READ, src, row,
                                nbytes=LINE))
    return reqs


def traffic_breakdown(reqs: list[Request]) -> dict[str, float]:
    """Byte-share per class — reproduces the paper's Fig. 3."""
    buckets = {"inter_bank_copy": 0, "intra_bank_copy": 0, "init": 0,
               "regular": 0, "reduce": 0}
    for r in reqs:
        if r.op == Op.COPY and not r.intra_bank:
            buckets["inter_bank_copy"] += r.nbytes
        elif r.op == Op.COPY:
            buckets["intra_bank_copy"] += r.nbytes
        elif r.op == Op.INIT:
            buckets["init"] += r.nbytes
        elif r.op == Op.REDUCE:
            buckets["reduce"] += r.nbytes * max(1, len(r.src_banks))
        else:
            buckets["regular"] += r.nbytes
    total = sum(buckets.values())
    return {k: v / total for k, v in buckets.items()}
