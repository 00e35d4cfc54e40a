# The paper's primary contribution — TDM circuit-switched inter-bank
# transfer (slot allocation + CCU), single stack and multi-stack — ported
# to PyTorch + CUDA: the allocator's search and prepare run as CUDA
# kernels on the card, its bookkeeping stays numpy on the host.
from .bitvec import bit_is_free, free_slots, full_mask, rotr, rotr_np
from .fabric import (AdmissionQueue, FabricCluster, FabricOverflow,
                     NomFabric, PolicyContext, ReduceTree, get_policy,
                     register_policy, registered_policies, unregister_policy)
from .nom_collectives import (Transfer, TransferPlan, nom_allreduce_banks,
                              nom_reduce, plan_transfers)
from .scheduler import ScheduleReport, TransferRequest, reduce_request
from .slot_alloc import (AllocResult, BatchReport, Circuit, CopyRequest,
                         SegmentedAllocator, SlotTable, StackedCircuit,
                         TdmAllocator, TdmAllocatorLight, traceback,
                         wavefront_search, wavefront_search_batch)
from .topology import (PAPER_MESH, Mesh3D, N_PORTS, PORT_LOCAL, StackLink,
                       StackedTopology, make_topology, port_for)

__all__ = [
    "AdmissionQueue", "FabricCluster", "FabricOverflow", "NomFabric",
    "PolicyContext", "ReduceTree",
    "get_policy", "register_policy", "registered_policies",
    "unregister_policy",
    "bit_is_free", "free_slots", "full_mask", "rotr", "rotr_np",
    "Transfer", "TransferPlan", "nom_allreduce_banks", "nom_reduce",
    "plan_transfers",
    "AllocResult", "BatchReport", "Circuit", "CopyRequest", "ScheduleReport",
    "SegmentedAllocator", "SlotTable", "StackedCircuit", "TdmAllocator",
    "TdmAllocatorLight", "TransferRequest", "reduce_request",
    "traceback", "wavefront_search", "wavefront_search_batch", "PAPER_MESH",
    "Mesh3D", "N_PORTS", "PORT_LOCAL", "StackLink", "StackedTopology",
    "make_topology", "port_for",
]
