"""Faithful-reproduction substrate: HMC-like DRAM + workloads + simulator
(port of ``repro.memsim``; the NoM configs' CCU runs its kernels on
``device``)."""
from .dram import Timing
from .energy import EnergyParams, energy_pj, init_energy_per_row
from .simulator import CONFIGS, SimParams, SimResult, simulate
from .workloads import (WORKLOADS, Op, Request, TrafficMix, WorkloadSpec,
                        generate, traffic_breakdown)

__all__ = ["Timing", "EnergyParams", "energy_pj", "init_energy_per_row",
           "CONFIGS", "SimParams",
           "SimResult", "simulate", "WORKLOADS", "Op", "Request",
           "TrafficMix", "WorkloadSpec", "generate", "traffic_breakdown"]
