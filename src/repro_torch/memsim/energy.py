"""DRAMPower-style energy model (paper Section 3, "Energy analysis");
port of ``repro.memsim.energy``.

Per-event energies follow the Micron DDR3 power-calculator structure the
paper cites: activate/precharge + read/write column energy per access, I/O
energy per bit for on-chip interconnect, and a large off-chip (SerDes +
board trace) cost per bit for data that leaves the stack.  Values are in pJ
and chosen from the public Micron TN-41-01 / HMC literature ballpark — the
*ratios* (NoM vs DDR3 baseline vs RowClone) are what the paper reports.
"""
from __future__ import annotations

import dataclasses

from .simulator import SimResult
from .workloads import LINE


@dataclasses.dataclass(frozen=True)
class EnergyParams:
    e_act_pre: float = 909.0        # activate+precharge per row op (pJ)
    e_rd_wr: float = 467.0          # column read/write per 64B (pJ)
    e_offchip_bit: float = 10.0     # SerDes + trace per bit (pJ)
    e_tsv_bit: float = 0.05         # TSV per bit
    e_hop_bit: float = 0.10         # NoM link+crossbar per bit per hop
    e_bus_bit: float = 0.60         # long global shared-bus wire per bit
    e_router_static_per_cycle: float = 0.002  # per router (NoM overhead)
    n_routers: int = 256
    # Inter-stack SerDes lane per bit per directed hop (pJ) — cheaper than
    # the full off-chip path (short cube-to-cube traces, no DIMM bus) but
    # an order of magnitude above a TSV; charged per `serdes_bytes` of a
    # multi-stack run (each byte counted once per SerDes hop it crossed).
    e_serdes_bit: float = 4.0
    # In-DRAM bulk initialization (RowClone-FPM zero): one activate of the
    # all-zeros source row pattern + precharge per cleared row — no column
    # I/O leaves the mats, so per-row cost sits at the ACT/PRE energy (the
    # RowClone paper's FPM accounting; LISA adds hops only for *copies*).
    e_init_row: float = 909.0
    # Compute-class reduce: one 64-bit integer/FP merge in the destination
    # bank's logic-die ALU (pJ per merged element) — a near-memory adder
    # operates at a small multiple of a TSV bit crossing, far below any
    # path that moves the operand off-stack.  Charged per
    # ``extra["nom_reduce_elems"]``.
    e_reduce_elem: float = 0.08


def init_energy_per_row(params: EnergyParams = EnergyParams()) -> float:
    """Energy to clear one DRAM row in place (pJ) — the INIT-class unit
    cost charged per ``extra["init_rows"]`` by :func:`energy_pj`."""
    return params.e_init_row


def energy_pj(res: SimResult, params: EnergyParams = EnergyParams()) -> dict:
    """Decompose total energy for a finished simulation.  INIT-class
    in-DRAM zeroing is charged per cleared row (``dram_init``,
    ``extra["init_rows"]`` × ``e_init_row``) on the configs that zero in
    place — and those bytes (``extra["init_bytes"]``) are *excluded*
    from the per-line column-I/O term, since no data leaves the mats.
    The conventional config pays for initialization through its store
    traffic instead (no ``init_bytes`` reported)."""
    p = params
    init_lines = res.extra.get("init_bytes", 0) // LINE
    accesses = max(0, res.copy_bytes // LINE - init_lines) + max(res.reqs, 1)
    dram = accesses * (p.e_act_pre * 0.3 + p.e_rd_wr)
    init = res.extra.get("init_rows", 0) * p.e_init_row
    offchip = res.offchip_bytes * 8 * p.e_offchip_bit
    nom = res.nom_hop_beats * 64 * p.e_hop_bit
    bus = res.bus_busy_cycles * 64 * p.e_bus_bit
    serdes = res.extra.get("serdes_bytes", 0) * 8 * p.e_serdes_bit
    reduce_alu = res.extra.get("nom_reduce_elems", 0) * p.e_reduce_elem
    static = (res.cycles * p.e_router_static_per_cycle * p.n_routers
              if res.config.startswith("nom") else 0.0)
    total = dram + init + offchip + nom + bus + serdes + reduce_alu + static
    return {"dram": dram, "dram_init": init, "offchip": offchip,
            "nom_links": nom, "shared_bus": bus, "serdes_links": serdes,
            "reduce_alu": reduce_alu, "router_static": static,
            "total": total, "per_access": total / max(1, accesses)}
