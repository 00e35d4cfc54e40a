"""Build, load and launch the port's CUDA kernels (every kernel package).

Each ``<package>/csrc/<kernel>.cu`` compiles with ``nvcc`` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), named after a hash of its sources and flags, under
``repro_torch/_build/`` (listed in ``.gitignore``).  The first launch
builds whatever is missing — every source in parallel, one ``nvcc``
process each — and loads the libraries with ``ctypes``.  Nothing is
built or loaded when the module is imported, and nothing here runs for
CPU tensors.

Every launch goes through :func:`launch`, which checks the error code
the C entry point returns (``cudaGetLastError()`` right after the
launch) and counts the launch in :data:`launch_counts`, one counter per
kernel of :data:`KERNELS`.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent
BUILD_DIR = PKG.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@dataclasses.dataclass(frozen=True)
class Kernel:
    package: str                 # kernels/<package>/csrc/<name>.cu
    headers: tuple[str, ...]     # csrc headers the source includes
    argtypes: tuple              # C entry point arguments, stream last


KERNELS = {
    # occ, srcs, dsts, init, out, batch, X, Y, Z, n_slots, threads, stream
    "wavefront_search": Kernel("slot_alloc", ("slot_alloc.cuh",),
                               (_P,) * 5 + (_I,) * 6 + (_P,)),
    # avail, dists, t_ready, cost, batch, n_slots, stream
    "slot_score": Kernel("slot_alloc", ("slot_alloc.cuh",),
                         (_P,) * 4 + (_I,) * 2 + (_P,)),
    # occ, srcs, dsts, t_ready, ints, flags, vecs, batch, X, Y, Z,
    # n_slots, threads, stream
    "fused_prepare": Kernel("slot_alloc", ("slot_alloc.cuh",),
                            (_P,) * 7 + (_I,) * 6 + (_P,)),
    # q, k, v, o, batch, hq, hkv, sq, sk, seq_k, head_dim, causal,
    # window (0 = none), bf16, scale, stream
    "flash_attention": Kernel("flash_attention", (),
                              (_P,) * 4 + (_I,) * 10 + (_F, _P)),
    # a, b, y, batch, seq, width, bf16, stream
    "rglru_scan": Kernel("rglru_scan", (), (_P,) * 3 + (_I,) * 4 + (_P,)),
}

# Launches per kernel since the last reset (only real kernel launches:
# the plain PyTorch versions never count).
launch_counts = {name: 0 for name in KERNELS}
_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}     # kernel -> nvcc/ptxas output of its build


def reset_launch_counts() -> None:
    for name in KERNELS:
        launch_counts[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "src/repro_torch/kernels/*/csrc with the CUDA toolkit "
                       "on the machine with the GPU")


def source(name: str) -> Path:
    return PKG / KERNELS[name].package / "csrc" / f"{name}.cu"


def _lib_path(name: str) -> Path:
    csrc = source(name).parent
    h = hashlib.sha256()
    for part in (*(csrc / f for f in KERNELS[name].headers), source(name)):
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=tuple(KERNELS)) -> float:
    """Compile every missing kernel library in parallel; returns the
    seconds spent.  Raises with nvcc's output when a build fails."""
    t0 = time.perf_counter()
    todo = [(n, _lib_path(n)) for n in names if not _lib_path(n).exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for name, path in todo:
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source(name))]
            procs.append((name, path, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for name, path, tmp, proc in procs:
            out, _ = proc.communicate()
            build_log[name] = out
            if proc.returncode:
                failed.append(f"{name}: nvcc exit {proc.returncode}\n{out}")
            else:
                os.replace(tmp, path)    # atomic: never a half-written .so
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built first if missing)."""
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = list(KERNELS[name].argtypes)
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def launch(name: str, device: torch.device, *args) -> None:
    """Launch kernel ``name`` on ``device``'s current stream: ``args``
    are the C entry point's arguments before the stream (tensors are
    passed as device pointers, numbers as the entry point declares
    them).  Raises on a refused launch; counts the launch otherwise."""
    lib = library(name)
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = getattr(lib, f"{name}_launch")(*cargs, stream)
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({msg})")
    launch_counts[name] += 1
