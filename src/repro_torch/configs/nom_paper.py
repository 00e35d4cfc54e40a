"""The paper's own evaluation configuration (Section 3) — the memory
system rather than an LM architecture, so it lives beside ARCHS rather
than in it.  Used by memsim defaults, quickstart, and the benchmarks.

A copy of ``repro.configs.nom_paper``."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class NomSystemConfig:
    # geometry: 4GB HMC-like stack, 32 vaults, 4 DRAM layers, 2 banks/slice
    mesh_x: int = 8
    mesh_y: int = 8
    mesh_z: int = 4              # => 256 banks, topology 8x8x4
    vault_span_y: int = 2        # 32 vaults, 8 banks each
    # TDM circuit switching
    n_slots: int = 16            # 16-slot windows
    link_bits: int = 64          # internal datapath width
    setup_cycles: int = 3        # find path / program tables / issue read
    # clocks
    logic_ghz: float = 1.25
    nom_link_ghz: float = 1.25   # scaled in the frequency experiments
    # sideband slot-table programming bus (Section 2.3): 12 bits =
    # 3 (bank) + 4 (slot) + 6 (in/out ports) per vault per cycle
    sideband_bits: int = 12


PAPER_SYSTEM = NomSystemConfig()
