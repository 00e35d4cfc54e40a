"""repro_torch.core.bitvec / topology against repro.core (bit for bit)."""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core.bitvec as rbv
import repro.core.topology as rtop
import repro_torch.core.bitvec as pbv
import repro_torch.core.topology as ptop

SETTINGS = settings(max_examples=40, deadline=None, database=None)


# --- bitvec -------------------------------------------------------------------
def test_full_mask_matches_reference_and_rejects_bad_widths():
    for n in range(1, 33):
        assert pbv.full_mask(n) == rbv.full_mask(n)
    for bad in (0, 33, -1):
        with pytest.raises(ValueError):
            pbv.full_mask(bad)
    assert pbv.MAX_SLOTS == rbv.MAX_SLOTS


@SETTINGS
@given(st.integers(1, 32), st.lists(st.integers(0, 2**32 - 1), min_size=1,
                                    max_size=16))
def test_rotations_match_reference(n_slots, vals):
    v = np.asarray(vals, np.uint32) & np.uint32(rbv.full_mask(n_slots))
    np.testing.assert_array_equal(pbv.rotr_np(v, n_slots),
                                  rbv.rotr_np(v, n_slots))
    np.testing.assert_array_equal(pbv.rotl_np(v, n_slots),
                                  rbv.rotl_np(v, n_slots))
    # the torch rotate on int64 values (the plain versions' arithmetic)
    got = pbv.rotr(torch.as_tensor(v.astype(np.int64)), n_slots)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                  rbv.rotr_np(v, n_slots))


@SETTINGS
@given(st.integers(1, 32), st.integers(0, 2**32 - 1), st.integers(0, 31))
def test_slot_predicates_match_reference(n_slots, v, slot):
    v &= rbv.full_mask(n_slots)
    slot %= n_slots
    assert pbv.free_slots(v, n_slots) == rbv.free_slots(v, n_slots)
    assert pbv.bit_is_free(v, slot) == rbv.bit_is_free(v, slot)
    assert pbv.set_bit(v, slot) == rbv.set_bit(v, slot)


def test_packed_tensor_roundtrip_keeps_high_bit():
    a = np.asarray([0, 1, 2**31 - 1, 2**31, 2**32 - 1, 0xDEADBEEF], np.uint32)
    t = pbv.packed_tensor(a, "cpu")
    assert t.dtype == torch.int64 and int(t.min()) >= 0
    np.testing.assert_array_equal(pbv.packed_numpy(t), a)
    bits = pbv.as_i32_bits(t)
    assert bits.dtype == torch.int32
    np.testing.assert_array_equal(bits.numpy().view(np.uint32), a)
    np.testing.assert_array_equal(pbv.as_i64(bits).numpy(), a.astype(np.int64))
    np.testing.assert_array_equal(pbv.packed_numpy(bits), a)


# --- topology -----------------------------------------------------------------
MESHES = [(8, 8, 4, 2), (4, 4, 2, 1), (4, 4, 2, 2), (1, 1, 1, 1), (3, 5, 2, 5)]


@pytest.mark.parametrize("dims", MESHES)
def test_mesh_geometry_matches_reference(dims):
    r, p = rtop.Mesh3D(*dims), ptop.Mesh3D(*dims)
    for attr in ("n_nodes", "n_vaults", "max_dist"):
        assert getattr(p, attr) == getattr(r, attr), attr
    np.testing.assert_array_equal(p.coord_array, r.coord_array)
    assert p.coord_array.dtype == r.coord_array.dtype
    np.testing.assert_array_equal(p.upstream_tables["prev"],
                                  r.upstream_tables["prev"])
    for v in range(r.n_nodes):
        assert p.coords(v) == r.coords(v)
        assert p.node_id(*r.coords(v)) == v
        assert p.vault_of(v) == r.vault_of(v)
        assert p.column_of(v) == r.column_of(v)
        for port in range(ptop.N_PORTS):
            assert p.neighbor(v, port) == r.neighbor(v, port)
    for vault in range(r.n_vaults):
        assert p.banks_of_vault(vault) == r.banks_of_vault(vault)


@SETTINGS
@given(st.integers(0, 255), st.integers(0, 255))
def test_routes_match_reference(a, b):
    r, p = rtop.PAPER_MESH, ptop.PAPER_MESH
    assert p.manhattan(a, b) == r.manhattan(a, b)
    assert p.dor_path(a, b) == r.dor_path(a, b)


def test_ports_and_constants_match_reference():
    assert (ptop.PORT_XP, ptop.PORT_XM, ptop.PORT_YP, ptop.PORT_YM,
            ptop.PORT_ZP, ptop.PORT_ZM, ptop.PORT_LOCAL, ptop.N_PORTS) == \
        (rtop.PORT_XP, rtop.PORT_XM, rtop.PORT_YP, rtop.PORT_YM,
         rtop.PORT_ZP, rtop.PORT_ZM, rtop.PORT_LOCAL, rtop.N_PORTS)
    for dim in range(3):
        for direction in (1, -1):
            assert ptop.port_for(dim, direction) == \
                rtop.port_for(dim, direction)


def test_paper_mesh_and_single_stack_factory():
    assert (ptop.PAPER_MESH.X, ptop.PAPER_MESH.Y, ptop.PAPER_MESH.Z,
            ptop.PAPER_MESH.vault_span_y) == (8, 8, 4, 2)
    assert ptop.make_topology() is ptop.PAPER_MESH
    m = ptop.make_topology(1, (4, 4, 2), vault_span_y=1)
    r = rtop.make_topology(1, (4, 4, 2), vault_span_y=1)
    assert (m.X, m.Y, m.Z, m.vault_span_y) == (r.X, r.Y, r.Z, r.vault_span_y)
    # n_stacks > 1 builds a StackedTopology equal to the reference's.
    ps, rs = ptop.make_topology(2, (4, 4, 2)), rtop.make_topology(2, (4, 4, 2))
    assert isinstance(ps, ptop.StackedTopology)
    assert (ps.n_stacks, ps.link, ps.link_latency, ps.link_bytes,
            ps.n_nodes, ps.offsets, ps.n_channels) == \
        (rs.n_stacks, rs.link, rs.link_latency, rs.link_bytes, rs.n_nodes,
         rs.offsets, rs.n_channels)
    assert [dataclasses.astuple(ln) for ln in ps.links] == \
        [dataclasses.astuple(ln) for ln in rs.links]
    assert [(m.X, m.Y, m.Z, m.vault_span_y) for m in ps.stacks] == \
        [(m.X, m.Y, m.Z, m.vault_span_y) for m in rs.stacks]


@pytest.mark.parametrize("dims", [(0, 2, 2), (2, 3, 1), (2, 2, 2, 0)])
def test_mesh_validation_matches_reference(dims):
    with pytest.raises(ValueError):
        rtop.Mesh3D(*dims)
    with pytest.raises(ValueError):
        ptop.Mesh3D(*dims)
