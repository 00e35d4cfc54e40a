"""repro_torch stands alone: no JAX and nothing of repro at import or in
its sources, entry points default to CUDA, and chip_smoke.py refuses to
run without the package or a GPU."""
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
SRC = ROOT / "src"


def test_import_leaves_jax_and_repro_out():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.kernels.slot_alloc\n"
        "import repro_torch.kernels.flash_attention\n"
        "import repro_torch.kernels.rglru_scan, repro_torch.configs\n"
        "import repro_torch.models, repro_torch.train, repro_torch.serving\n"
        "import repro_torch.launch.serve, repro_torch.memsim\n"
        "from repro_torch.serving import BankPool, drive, make_slo_engine\n"
        "from repro_torch.core import NomFabric, TdmAllocatorLight\n"
        "from repro_torch.core import FabricCluster, nom_allreduce_banks\n"
        "from repro_torch.models import make_model, params_from_reference\n"
        "import repro_torch.checkpoint, repro_torch.configs.nom_paper\n"
        "from repro_torch.checkpoint import cross_stack_reshard_plan, restore\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
        "'jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print('LEAKED', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout, out.stdout


def test_sources_never_import_jax_or_repro():
    pat = re.compile(r"^\s*(import jax|from jax|import repro\b|"
                     r"from repro(\.|\s))")
    files = sorted((SRC / "repro_torch").rglob("*.py")) + [ROOT /
                                                          "chip_smoke.py"]
    assert len(files) > 10
    hits = [f"{f.name}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if pat.search(line)]
    assert hits == []


def test_default_device_is_cuda():
    """Entry points default to device="cuda": without a GPU they raise
    (no silent CPU run); with one they build on it.  ``device="cpu"``
    runs the plain versions."""
    from repro_torch.core import PAPER_MESH, FabricCluster, NomFabric, \
        SlotTable, TdmAllocator, make_topology
    from repro_torch.kernels.slot_alloc import fused
    from repro_torch.memsim import SimParams, WorkloadSpec, generate, \
        simulate
    from repro_torch.memsim.simulator import MemorySystem
    from repro_torch.serving import Engine, make_slo_engine
    from repro_torch.serving.loadgen import CacheStub
    occ = np.zeros((PAPER_MESH.n_nodes, 7), np.uint32)
    topo = make_topology(2, (4, 4, 2))
    reqs = generate(WorkloadSpec("fileCopy20", n_requests=50, seed=0))
    calls = [lambda: TdmAllocator(PAPER_MESH),
             lambda: NomFabric(mesh=PAPER_MESH),
             lambda: SlotTable(PAPER_MESH),
             lambda: fused.fused_prepare(occ, [0], [9], [3], mesh=PAPER_MESH,
                                         n_slots=16),
             lambda: FabricCluster(topo),
             lambda: MemorySystem(SimParams()),
             lambda: MemorySystem(SimParams(config="conventional")),
             lambda: simulate(reqs, SimParams()),
             lambda: simulate(reqs, SimParams(config="rowclone")),
             lambda: Engine(model=CacheStub(), cfg=None),
             lambda: make_slo_engine()]
    if torch.cuda.is_available():
        assert TdmAllocator(PAPER_MESH).table.device.type == "cuda"
        assert FabricCluster(topo).fabrics[1].allocator.device.type == "cuda"
        assert MemorySystem(SimParams()).alloc.device.type == "cuda"
        assert make_slo_engine().fabric.allocator.device.type == "cuda"
        return
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert FabricCluster(topo, device="cpu").fabrics[1].allocator.device \
        .type == "cpu"
    assert MemorySystem(SimParams(), device="cpu").alloc.device.type == "cpu"
    assert simulate(reqs, SimParams(), device="cpu").reqs == 50
    assert make_slo_engine(device="cpu").fabric.allocator.device.type \
        == "cpu"
    with pytest.raises(ValueError, match="unsupported device"):
        TdmAllocator(PAPER_MESH, device="meta")


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding only chip_smoke.py (or on a machine with no
    GPU) the script exits non-zero and prints no result."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
