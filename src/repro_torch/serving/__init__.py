"""The serving engine and its control plane (port of ``repro.serving``)."""
from .admission import (HYBRID_SLACK, STALL_PRESSURE, AdmissionContext,
                        AdmissionTicket, TicketColumns, get_admission,
                        register_admission, registered_admissions,
                        unregister_admission)
from .engine import CONTROL_PLANES, Engine
from .loadgen import (MIXES, Arrival, ArrivalMix, ClassSpec, LoadGen,
                      drive, get_mix, make_slo_engine)
from .placement import (PLACEMENT_POLICIES, BankPool, Lease, LeafSpec,
                        step_requests, teardown_requests)

__all__ = ["CONTROL_PLANES", "Engine", "BankPool", "Lease", "LeafSpec",
           "PLACEMENT_POLICIES", "step_requests", "teardown_requests",
           "HYBRID_SLACK", "STALL_PRESSURE", "AdmissionContext",
           "AdmissionTicket", "TicketColumns", "get_admission",
           "register_admission", "registered_admissions",
           "unregister_admission",
           "MIXES", "Arrival", "ArrivalMix", "ClassSpec", "LoadGen",
           "drive", "get_mix", "make_slo_engine"]
