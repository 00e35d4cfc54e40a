"""Pure-host (numpy) oracles for the slot-allocator kernels; counterpart
of ``repro.kernels.slot_alloc.ref``.

``wavefront_search_ref_batch`` evaluates the scalar topological search
(``_wavefront_host``) one request at a time; ``slot_score_ref`` and
``fused_prepare_ref`` are the numpy twins of the scoring kernel and the
fused prepare (int64 slot choice, lockstep numpy trace-back).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.slot_alloc import (_best_slots_np, _wavefront_host,
                                         traceback_batch)
from repro_torch.core.topology import PORT_LOCAL, Mesh3D

from .fused import FAR32, FusedPrepare


def wavefront_search_ref_batch(occ_packed, srcs, dsts, init_vecs, *,
                               mesh: Mesh3D, n_slots: int) -> np.ndarray:
    occ = np.asarray(occ_packed, np.uint32)
    outs = [_wavefront_host(occ, mesh, n_slots, int(s), int(d), int(iv))
            for s, d, iv in zip(np.asarray(srcs), np.asarray(dsts),
                                np.asarray(init_vecs))]
    return (np.stack(outs) if outs
            else np.zeros((0, mesh.n_nodes), np.uint32))


def slot_score_ref(avail: np.ndarray, dists: np.ndarray,
                   t_readys: np.ndarray, n_slots: int) -> np.ndarray:
    """numpy twin of the slot-score kernel on packed uint32 availability
    vectors: the (B, n_slots) int32 cost matrix."""
    slots = np.arange(n_slots, dtype=np.int64)
    free = ((np.asarray(avail).astype(np.int64)[:, None] >> slots[None]) & 1
            ) == 0
    dists = np.asarray(dists, np.int64)
    t_readys = np.asarray(t_readys, np.int64)
    s_inj = (slots[None] - dists[:, None]) % n_slots
    c = t_readys[:, None] + ((s_inj - t_readys[:, None]) % n_slots)
    return np.where(free, c, np.int64(FAR32)).astype(np.int32)


def fused_prepare_ref(occ: np.ndarray, srcs, dsts, t_readys, *,
                      mesh: Mesh3D, n_slots: int) -> FusedPrepare:
    """Host oracle of the fused prepare: scalar topological wavefront,
    int64 slot choice, lockstep numpy trace-back."""
    srcs = np.asarray(srcs, np.int64)
    dsts = np.asarray(dsts, np.int64)
    t_readys = np.asarray(t_readys, np.int64)
    B = len(srcs)
    occ = np.asarray(occ, np.uint32)
    vecs = wavefront_search_ref_batch(occ, srcs, dsts, np.zeros(B, np.uint32),
                                      mesh=mesh, n_slots=n_slots)
    coords = mesh.coord_array
    dists = np.abs(coords[srcs] - coords[dsts]).sum(1)
    avail = vecs[np.arange(B), dsts] | occ[dsts, PORT_LOCAL]
    starts, arr, free, denied = _best_slots_np(avail, dists, t_readys,
                                               n_slots)
    starts = np.where(denied, np.int64(FAR32), starts)  # int32-safe sentinel
    hop_n, hop_p, hop_s, _, ok = traceback_batch(
        vecs, np.arange(B), occ, mesh, n_slots, srcs, dsts, arr)
    L = mesh.max_dist + 1
    hn = np.zeros((B, L), np.int32)
    hp = np.zeros((B, L), np.int32)
    hs = np.zeros((B, L), np.int32)
    hn[:, :hop_n.shape[1]] = hop_n
    hp[:, :hop_p.shape[1]] = hop_p
    hs[:, :hop_s.shape[1]] = hop_s
    return FusedPrepare(
        starts=starts.astype(np.int32), arr=arr.astype(np.int32),
        denied=denied, free=free, hop_n=hn, hop_p=hp, hop_s=hs, ok=ok,
        dists=dists.astype(np.int32), _vecs_dev=None, _batch=B)
