"""Elastic resharding: when the mesh changes (node failure, scale-up), plan
the bulk shard migration with the NOM transfer scheduler (counterpart of
``repro.checkpoint.reshard``: equal plans, reports and errors).

``reshard_plan`` computes, for every parameter shard, which device held
the bytes under the old mesh and which device needs them under the new
mesh, and packs the resulting (src, dst, bytes) set into conflict-free
NOM rounds over the device torus — the checkpoint/elastic analogue of the
paper's bulk inter-bank copies.  :func:`cross_stack_reshard_plan` runs
each stack's CCU on ``device`` (its search and prepare kernels on the
card by default; ``"cpu"`` runs their plain versions).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.fabric import FabricCluster, NomFabric
from repro_torch.core.nom_collectives import Transfer, TransferPlan
from repro_torch.core.scheduler import ScheduleReport, TransferRequest
from repro_torch.core.topology import StackedTopology


@dataclasses.dataclass(frozen=True)
class ShardMove:
    param: str
    src_device: tuple
    dst_device: tuple
    nbytes: int


def shard_owners(shape, spec_axes, mesh_shape, axis_names):
    """Ownership map of a sharded array: device coords -> index ranges.

    ``shape`` is the array shape; ``spec_axes`` names, per array dim, the
    mesh axis it is sharded over (``None`` = replicated along that dim —
    every device owns the full extent), PartitionSpec-style;
    ``mesh_shape`` / ``axis_names`` describe the device mesh.  Returns
    ``{device_coords: ((start, stop), ...)}`` with one half-open range
    per array dim — the slice of the array that device holds, the
    granularity :func:`cross_stack_reshard_plan` moves shards at.

    Raises ``ValueError`` when a spec names an unknown mesh axis, reuses
    a mesh axis across dims, or shards a dim that the mesh axis size
    does not divide evenly (partial shards are not modeled)."""
    if len(mesh_shape) != len(axis_names):
        raise ValueError(f"mesh_shape {mesh_shape} and axis_names "
                         f"{axis_names} disagree on rank")
    if len(spec_axes) != len(shape):
        raise ValueError(f"spec_axes {spec_axes} must name one mesh axis "
                         f"(or None) per dim of shape {shape}")
    sizes = dict(zip(axis_names, mesh_shape))
    used = [a for a in spec_axes if a is not None]
    if len(used) != len(set(used)):
        raise ValueError(f"mesh axis reused across dims in {spec_axes}")
    for dim, ax in zip(shape, spec_axes):
        if ax is None:
            continue
        if ax not in sizes:
            raise ValueError(f"unknown mesh axis {ax!r}; "
                             f"mesh has {tuple(axis_names)}")
        if dim % sizes[ax]:
            raise ValueError(f"dim of size {dim} not divisible by mesh "
                             f"axis {ax!r} of size {sizes[ax]}")
    owners = {}
    for dev in np.ndindex(*tuple(mesh_shape)):
        coord = dict(zip(axis_names, dev))
        ranges = []
        for dim, ax in zip(shape, spec_axes):
            if ax is None:
                ranges.append((0, int(dim)))
            else:
                chunk = dim // sizes[ax]
                ranges.append((int(coord[ax] * chunk),
                               int((coord[ax] + 1) * chunk)))
        owners[tuple(int(x) for x in dev)] = tuple(ranges)
    return owners


def reshard_plan(params_meta: dict[str, int], old_mesh: tuple,
                 new_mesh: tuple, torus: bool = True,
                 policy: str = "longest_first") -> TransferPlan:
    """params_meta: name -> nbytes (per-param total).  Devices are laid out
    row-major on both meshes; each param's bytes move from its old owner
    set to its new owner set, round-robin.  Returns the NOM round plan
    (used by tests and the elastic example; actual array placement is done
    by ``restore(device=)`` — this plan is the *schedule* evidence)."""
    plan, _report = reshard_plan_with_report(params_meta, old_mesh, new_mesh,
                                             torus=torus, policy=policy)
    return plan


def reshard_plan_with_report(
        params_meta: dict[str, int], old_mesh: tuple, new_mesh: tuple,
        torus: bool = True,
        policy: str = "longest_first") -> tuple[TransferPlan, ScheduleReport]:
    """Like :func:`reshard_plan` but routed through a one-shot
    :class:`~repro_torch.core.fabric.NomFabric` session (device level),
    returning the concurrency report alongside the plan."""
    old_n = int(np.prod(old_mesh))
    new_n = int(np.prod(new_mesh))
    shape = new_mesh if new_n >= old_n else old_mesh
    coords = lambda i, mesh: tuple(
        int(x) for x in np.unravel_index(i % int(np.prod(mesh)), mesh))
    transfers = []
    for i, (name, nbytes) in enumerate(sorted(params_meta.items())):
        src = coords(i % old_n, shape)
        dst = coords(i % new_n, shape)
        if src != dst:
            transfers.append(Transfer(src=src, dst=dst, nbytes=nbytes,
                                      tag=name))
    fabric = NomFabric(shape=shape, torus=torus, policy=policy)
    return fabric.schedule(transfers)


def cross_stack_reshard_plan(
        params_meta: dict[str, int], topology: StackedTopology,
        old_stacks: tuple, new_stacks: tuple,
        policy: str = "arrival", device="cuda") -> tuple[list, ScheduleReport]:
    """Plan a checkpoint reshard across the stacks of a multi-stack NoM.

    The memory-side analogue of :func:`reshard_plan`: parameters laid
    out round-robin over ``old_stacks`` move to their round-robin owner
    in ``new_stacks`` (stack shrink/grow after failure or scale-up).
    Each move becomes one bank-level request — stack-local node chosen
    by strided spread — scheduled through a one-shot
    :class:`~repro_torch.core.fabric.FabricCluster`: same-stack moves stay on
    that stack's TDM mesh, cross-stack moves negotiate two-phase
    circuits through the SerDes links.  Returns ``(results, report)``
    in sorted-param order; ``report.n_cross_stack`` counts the
    inter-stack share.  ``device`` is the per-stack CCUs' (see
    :class:`~repro_torch.core.fabric.FabricCluster`)."""
    if not old_stacks or not new_stacks:
        raise ValueError("old_stacks and new_stacks must be non-empty")
    for s in (*old_stacks, *new_stacks):
        if not (0 <= s < topology.n_stacks):
            raise ValueError(f"stack {s} out of range "
                             f"[0, {topology.n_stacks})")
    reqs = []
    for i, (name, nbytes) in enumerate(sorted(params_meta.items())):
        so = old_stacks[i % len(old_stacks)]
        sn = new_stacks[i % len(new_stacks)]
        src = (i * 13 + 5) % topology.stacks[so].n_nodes
        dst = (i * 13 + 5) % topology.stacks[sn].n_nodes
        if so == sn and src == dst:
            continue                 # already where it belongs
        reqs.append(TransferRequest(src=src, dst=dst, nbytes=nbytes,
                                    tag=name, src_stack=so, dst_stack=sn))
    cluster = FabricCluster(topology=topology, policy=policy,
                            device=device)
    return cluster.schedule(reqs)
