"""repro_torch.checkpoint against repro.checkpoint on the CPU: atomic
saves, prune and the stale ``.tmp`` directory; a model's parameters
through a save and a restore, bit for bit; checkpoints passing between
the two packages both ways (fp32 and int32 leaves, and a reference-saved
``{"params": ...}`` loaded into the port's ``CausalLM``); bf16 leaves,
which the port stores as their uint16 bits (and reads in the reference's
own ``'<V2'`` files too); and the reshard planners' plans, reports,
results and ``ValueError``s equal to the reference's.  Integer and host
arithmetic, so every comparison is exact."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.checkpoint import (cross_stack_reshard_plan, reshard_plan,
                                    shard_owners)
from repro_torch.checkpoint.reshard import reshard_plan_with_report
from repro_torch.configs import get_config
from repro_torch.core import PAPER_MESH, make_topology
from repro_torch.models import CausalLM, make_model, params_from_reference


@pytest.fixture(scope="module")
def R():
    """The JAX package's checkpoint modules (CPU)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    import repro.checkpoint as rckpt
    import repro.checkpoint.reshard as rreshard
    import repro.core as rcore
    return type("R", (), {"jax": jax, "jnp": jnp, "ckpt": rckpt,
                          "reshard": rreshard, "core": rcore})


def _same_tree(a, b):
    assert isinstance(a, dict) == isinstance(b, dict)
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same_tree(a[k], b[k])
        return
    a = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
    b = b if isinstance(b, torch.Tensor) else torch.from_numpy(np.array(b))
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.cpu(), b.cpu())


def _mixed_tree(seed):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.standard_normal((4, 3)).astype(np.float32),
                       "b": rng.standard_normal((3,)).astype(np.float32)},
            "opt": {"count": np.array(7, np.int32),
                    "ids": rng.integers(-5, 5, (2, 5)).astype(np.int32),
                    "empty": {}}}


# --- save / restore / prune ----------------------------------------------------
def test_checkpoint_atomicity_and_prune(tmp_path):
    d = str(tmp_path / "ck")
    tree = {"a": {"w": torch.ones((4, 4))}, "b": torch.zeros((2,))}
    for s in (1, 2, 3, 4):
        ckpt.save(d, s, tree)
    ckpt.prune(d, keep=2)
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004"]
    assert ckpt.latest_step(d) == 4
    # a stale tmp dir must be ignored by restore
    os.makedirs(os.path.join(d, "step_00000099.tmp"), exist_ok=True)
    assert ckpt.latest_step(d) == 4
    tree2, manifest = ckpt.restore(d, device="cpu")
    assert manifest["step"] == 4
    assert torch.equal(tree2["a"]["w"], torch.ones((4, 4)))
    assert ckpt.restore(str(tmp_path / "none"), device="cpu") == (None, None)
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    ckpt.prune(str(tmp_path / "none"))


def test_save_replaces_a_stale_tmp_and_an_older_save(tmp_path):
    d = str(tmp_path / "ck")
    os.makedirs(os.path.join(d, "step_00000005.tmp"))
    open(os.path.join(d, "step_00000005.tmp", "junk.npy"), "w").close()
    ckpt.save(d, 5, {"x": torch.zeros(3)})
    ckpt.save(d, 5, {"x": torch.ones(3)}, extra_meta={"mesh": [2, 4]})
    assert sorted(os.listdir(d)) == ["step_00000005"]
    tree, manifest = ckpt.restore(d, 5, device="cpu")
    assert torch.equal(tree["x"], torch.ones(3)) and manifest["mesh"] == [2, 4]
    assert sorted(os.listdir(os.path.join(d, "step_00000005"))) == [
        "manifest.json", "x.npy"]


def test_restore_needs_the_card_unless_asked_for_the_cpu(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, {"x": torch.arange(4)})
    if torch.cuda.is_available():
        tree, _ = ckpt.restore(d)
        assert tree["x"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ckpt.restore(d)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ckpt.restore(str(tmp_path / "none"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cross_stack_reshard_plan({"p": 1}, make_topology(2, (4, 4, 2)),
                                 (0,), (1,))


def test_manifest_and_files_are_the_references(tmp_path):
    """File names, dtype names and the empty-dict marker as the reference
    writes them."""
    d = str(tmp_path / "ck")
    ckpt.save(d, 3, {"params": {"w": torch.zeros((2, 3))},
                     "n": torch.tensor(5, dtype=torch.int32), "e": {},
                     "h": torch.zeros(2, dtype=torch.bfloat16)})
    with open(os.path.join(d, "step_00000003", "manifest.json")) as f:
        m = json.load(f)
    assert m["step"] == 3
    assert m["keys"] == {
        "params/w": {"file": "params__w.npy", "shape": [2, 3],
                     "dtype": "float32"},
        "n": {"file": "n.npy", "shape": [], "dtype": "int32"},
        "e{}": {"empty": True},
        "h": {"file": "h.npy", "shape": [2], "dtype": "bfloat16"}}
    tree, _ = ckpt.restore(d, device="cpu")
    assert tree["e"] == {} and tree["n"].dtype == torch.int32


def test_elastic_restore_roundtrip(tmp_path):
    """mamba2-smoke's parameters (converted from the reference's tree
    layout by ``make_model``'s own) through a save and a restore: every
    leaf bit-equal, and the restored state dict loads strictly."""
    cfg = get_config("mamba2-130m", smoke=True)
    model = make_model(cfg, device="cpu", seed=5)
    d = str(tmp_path / "ck")
    ckpt.save(d, 5, {"params": model.state_dict()})
    tree, manifest = ckpt.restore(d, device="cpu")
    _same_tree(tree["params"], dict(model.state_dict()))
    again = CausalLM(cfg, "cpu")
    again.load_state_dict(tree["params"])
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 20)))
    with torch.no_grad():
        assert torch.equal(again(toks), model(toks))


def test_bf16_round_trip_is_bit_exact(tmp_path):
    """bf16 leaves (every bit pattern of a seeded draw, infinities and a
    NaN included) come back bit for bit, beside int32 and fp32 ones."""
    x = torch.tensor(np.random.default_rng(1).standard_normal((5, 7)),
                     dtype=torch.float32).bfloat16()
    x[0, 0], x[0, 1], x[0, 2] = float("inf"), float("-inf"), float("nan")
    tree = {"h": x, "c": {"ids": torch.arange(6, dtype=torch.int32),
                          "f": torch.linspace(0, 1, 4)}}
    d = str(tmp_path / "ck")
    ckpt.save(d, 2, tree)
    got, manifest = ckpt.restore(d, device="cpu")
    assert manifest["keys"]["h"]["dtype"] == "bfloat16"
    assert got["h"].dtype == torch.bfloat16
    assert torch.equal(got["h"].view(torch.int16), x.view(torch.int16))
    _same_tree({"c": got["c"]}, {"c": tree["c"]})


# --- between the two packages --------------------------------------------------
def test_port_checkpoints_restore_in_the_reference(R, tmp_path):
    tree = _mixed_tree(2)
    d = str(tmp_path / "ck")
    ckpt.save(d, 9, {k: {kk: (torch.from_numpy(vv) if not isinstance(vv, dict)
                              else vv) for kk, vv in v.items()}
                     for k, v in tree.items()}, extra_meta={"note": "port"})
    got, manifest = R.ckpt.restore(d)
    assert manifest["step"] == 9 and manifest["note"] == "port"
    _same_tree(R.jax.tree.map(np.asarray, got), tree)


def test_reference_checkpoints_restore_in_the_port(R, tmp_path):
    tree = _mixed_tree(3)
    d = str(tmp_path / "ck")
    R.ckpt.save(d, 4, R.jax.tree.map(R.jnp.asarray, tree))
    got, manifest = ckpt.restore(d, device="cpu")
    assert manifest["step"] == 4
    _same_tree(got, tree)
    assert got["opt"]["count"].dtype == torch.int32


def test_reference_bf16_files_restore_in_the_port(R, tmp_path):
    """The reference writes a bf16 leaf as ``'<V2'`` (and cannot read it
    back); the port reads its bits."""
    x = np.random.default_rng(4).standard_normal((3, 4)).astype(np.float32)
    d = str(tmp_path / "ck")
    R.ckpt.save(d, 1, {"h": R.jnp.asarray(x, R.jnp.bfloat16)})
    raw = np.load(os.path.join(d, "step_00000001", "h.npy"))
    assert raw.dtype.kind == "V" and raw.dtype.itemsize == 2
    got, manifest = ckpt.restore(d, device="cpu")
    assert manifest["keys"]["h"]["dtype"] == "bfloat16"
    assert torch.equal(got["h"], torch.tensor(x).bfloat16())


def test_reference_model_checkpoint_loads_into_the_port(R, tmp_path):
    """A reference-saved qwen1.5-smoke ``{"params": ...}`` restores on
    the CPU and converts through ``params_from_reference`` into the
    port's CausalLM: strict load, and logits bit-equal to a model built
    from the reference's tree directly."""
    from repro.configs import get_config as jget
    from repro.models import make_model as jmake
    jcfg = jget("qwen1.5-4b", smoke=True)
    params = jmake(jcfg).init(R.jax.random.PRNGKey(0))
    d = str(tmp_path / "ck")
    R.ckpt.save(d, 11, {"params": params})
    tree, _ = ckpt.restore(d, device="cpu")
    cfg = get_config("qwen1.5-4b", smoke=True)
    model, direct = CausalLM(cfg, "cpu"), CausalLM(cfg, "cpu")
    model.load_state_dict(params_from_reference(tree["params"], cfg))
    direct.load_state_dict(params_from_reference(
        R.jax.tree.map(np.asarray, params), cfg))
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 12)))
    with torch.no_grad():
        assert torch.equal(model(toks), direct(toks))
    assert model.lm_head is not None


# --- reshard plans -------------------------------------------------------------
def test_reshard_plan_conflict_free(R):
    meta = {f"p{i}": 1024 for i in range(40)}
    plan = reshard_plan(meta, old_mesh=(4, 4), new_mesh=(2, 4))
    for rnd in plan.rounds():
        hops = [h for _i, h in rnd]
        assert len(hops) == len(set(hops))
    assert plan.n_rounds >= 1
    want = R.reshard.reshard_plan(meta, old_mesh=(4, 4), new_mesh=(2, 4))
    assert (plan.starts, plan.paths, plan.rounds()) == \
        (want.starts, want.paths, want.rounds())
    assert [dataclasses.asdict(t) for t in plan.transfers] == \
        [dataclasses.asdict(t) for t in want.transfers]


@pytest.mark.parametrize("meshes", [((4, 4), (2, 4)), ((2, 4), (4, 4)),
                                    ((2, 2, 2), (2, 2, 2)), ((8,), (4,))])
@pytest.mark.parametrize("torus", [True, False])
@pytest.mark.parametrize("policy", ["longest_first", "arrival"])
def test_reshard_plan_with_report_matches_reference(R, meshes, torus,
                                                    policy):
    rng = np.random.default_rng(6)
    meta = {f"w{i:02d}": int(rng.integers(1, 1 << 20)) for i in range(37)}
    plan, rep = reshard_plan_with_report(meta, *meshes, torus=torus,
                                         policy=policy)
    wplan, wrep = R.reshard.reshard_plan_with_report(
        meta, *meshes, torus=torus, policy=policy)
    assert (plan.starts, plan.paths, plan.n_rounds) == \
        (wplan.starts, wplan.paths, wplan.n_rounds)
    assert dataclasses.asdict(rep) == dataclasses.asdict(wrep)


def test_shard_owners_partitions_exactly(R):
    owners = shard_owners((8, 6), ("x", None), (4, 2), ("x", "y"))
    assert len(owners) == 8
    assert owners[(0, 0)] == ((0, 2), (0, 6))
    assert owners[(3, 1)] == ((6, 8), (0, 6))
    xs = sorted({r[0] for r in owners.values()})
    assert xs == [(0, 2), (2, 4), (4, 6), (6, 8)]
    assert all(r[1] == (0, 6) for r in owners.values())
    for args in (((8, 6), ("x", None), (4, 2), ("x", "y")),
                 ((12, 8, 4), ("y", None, "x"), (2, 4), ("x", "y")),
                 ((6,), (None,), (3,), ("d",))):
        assert shard_owners(*args) == R.reshard.shard_owners(*args)


@pytest.mark.parametrize("args", [
    ((8,), ("q",), (4,), ("x",)),              # unknown mesh axis
    ((9,), ("x",), (4,), ("x",)),              # not divisible
    ((8, 8), ("x", "x"), (4,), ("x",)),        # reused
    ((8,), ("x", None), (4,), ("x",)),         # rank mismatch
    ((8,), ("x",), (4, 2), ("x",)),            # mesh rank mismatch
])
def test_shard_owners_validates(R, args):
    with pytest.raises(ValueError) as got:
        shard_owners(*args)
    with pytest.raises(ValueError) as want:
        R.reshard.shard_owners(*args)
    assert str(got.value) == str(want.value)


def _rkey(res):
    c = res.circuit
    return (res.searched_cycle, None if c is None
            else (type(c).__name__, dataclasses.asdict(c)))


def test_cross_stack_reshard_plan_moves_between_stacks(R):
    topo = make_topology(3, mesh=(4, 4, 2))
    meta = {f"p{i}": 256 for i in range(9)}
    res, rep = cross_stack_reshard_plan(meta, topo, (0, 1, 2), (0,),
                                        device="cpu")
    assert rep.n_cross_stack > 0
    assert rep.n_scheduled == rep.n_requests    # uncontended: all commit
    wres, wrep = R.reshard.cross_stack_reshard_plan(
        meta, R.core.make_topology(3, mesh=(4, 4, 2)), (0, 1, 2), (0,))
    assert [_rkey(r) for r in res] == [_rkey(r) for r in wres]
    assert dataclasses.asdict(rep) == dataclasses.asdict(wrep)
    for bad in (((0,), (5,)), ((), (0,)), ((0,), ()), ((-1,), (0,))):
        with pytest.raises(ValueError) as got:
            cross_stack_reshard_plan({"p": 1}, topo, *bad, device="cpu")
        with pytest.raises(ValueError) as want:
            R.reshard.cross_stack_reshard_plan(
                {"p": 1}, R.core.make_topology(3, mesh=(4, 4, 2)), *bad)
        assert str(got.value) == str(want.value)


def qwen_leaf_bytes(n_layers=None):
    """Bytes of every fp32 parameter of qwen1.5-4b at full width (and
    depth, unless ``n_layers`` cuts it), by the port's state-dict names
    (shapes only, on the meta device): what ``chip_smoke.py`` reshards."""
    cfg = get_config("qwen1.5-4b")
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = CausalLM(cfg, "meta")
    return {k: v.numel() * 4 for k, v in model.state_dict().items()}


def test_cross_stack_reshard_of_qwen_matches_reference(R):
    """qwen1.5-4b's fp32 leaves over four paper-mesh stacks, moved from
    stacks (0, 1, 2, 3) to (0, 1, 2): the port's results and report equal
    the reference's, and the plan of the same bytes on a (4, 4) -> (2, 4)
    device mesh is conflict-free and equal too.  At 4 of its 40 layers
    (51 leaves): the reference's report keeps a counter per TDM window, so
    its run grows with the moves times their windows (all 483 leaves take
    it ~50 s on a CPU; ``chip_smoke.py`` holds those on the card
    against the port on the CPU)."""
    full = qwen_leaf_bytes()
    assert len(full) == 483 and sum(full.values()) == 3_951_024_640 * 4
    meta = qwen_leaf_bytes(4)
    assert len(meta) == 51
    res, rep = cross_stack_reshard_plan(
        meta, make_topology(4, PAPER_MESH), (0, 1, 2, 3), (0, 1, 2),
        device="cpu")
    wres, wrep = R.reshard.cross_stack_reshard_plan(
        meta, R.core.make_topology(4, R.core.PAPER_MESH), (0, 1, 2, 3),
        (0, 1, 2))
    assert [_rkey(r) for r in res] == [_rkey(r) for r in wres]
    assert dataclasses.asdict(rep) == dataclasses.asdict(wrep)
    assert rep.n_cross_stack > 0 and rep.n_requests == len(res)
    plan = reshard_plan(full, (4, 4), (2, 4))
    for rnd in plan.rounds():
        hops = [h for _i, h in rnd]
        assert len(hops) == len(set(hops))
    want = R.reshard.reshard_plan(full, (4, 4), (2, 4))
    assert (plan.starts, plan.paths) == (want.starts, want.paths)


# --- on the card -----------------------------------------------------------------
@pytest.mark.cuda
def test_cuda_checkpoint_round_trip(tmp_path):
    """A model's parameters saved from the card and restored onto it, bit
    for bit, its prefill logits too; bf16 and int32 leaves as well."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    cfg = get_config("mamba2-130m", smoke=True)
    model = make_model(cfg, seed=6)
    toks = torch.randint(0, cfg.vocab, (2, 40), device="cuda")
    with torch.no_grad():
        before = model(toks)
    d = str(tmp_path / "ck")
    extra = {"h": torch.randn(9, device="cuda").bfloat16(),
             "i": torch.arange(5, device="cuda", dtype=torch.int32)}
    ckpt.save(d, 1, {"params": model.state_dict(), **extra})
    tree, _ = ckpt.restore(d)
    restored = CausalLM(cfg, "cuda")
    restored.load_state_dict(tree["params"])
    with torch.no_grad():
        assert torch.equal(restored(toks), before)
    for k, v in extra.items():
        assert tree[k].device.type == "cuda" and torch.equal(tree[k], v)
