"""The RG-LRU scan's wrapper: what it decides before a launch, held on
the CPU (the kernel rule ``plan``, the TMA tile it reports against the
one the CUDA source builds, any S without padding, against the Pallas
kernel in interpret mode and the plain version), and, on the card, both
CUDA kernels bit-equal to the plain version on shapes that reach every
tail: W not a multiple of the tile's channels, S not a multiple of its
steps, S and W under one tile, batch 3, bf16, rows TMA cannot describe
and a 16-byte-misaligned view.  Inputs come from a numpy seed.

The ``cuda`` tests skip where ``torch.cuda.is_available()`` is false.
The reference imports happen in a fixture, so the file also collects on
a machine without JAX (where only the ``cuda`` tests run).
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.kernels.rglru_scan.ref import rglru_scan_plain
from repro_torch.kernels.rglru_scan.rglru_scan import TMA_TILE, plan


@pytest.fixture(scope="module")
def ref():
    """The JAX package's RG-LRU scan (the Pallas kernel; CPU)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.rglru_scan.ops import rglru_scan as pallas_scan
    return jnp, pallas_scan


def _gates(b, s, w, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.7, 0.999, (b, s, w)).astype(np.float32),
            (rng.standard_normal((b, s, w)) * 0.1).astype(np.float32))


F32, BF16 = torch.float32, torch.bfloat16


# (dtype, W, byte offsets of a's and b's data, kernel): rows of 16-byte
# multiples on 16-byte aligned bases take the TMA ring, the rest the
# per-thread kernel.
@pytest.mark.parametrize("case", [
    (F32, 4096, (0, 0), "tma"),          # the model's width
    (F32, 100, (0, 0), "tma"),           # 400-byte rows, not a tile multiple
    (F32, 4, (0, 0), "tma"),             # one 16-byte row
    (BF16, 72, (0, 0), "tma"),
    (BF16, 8, (0, 0), "tma"),
    (BF16, 100, (0, 0), "ldg"),          # 200-byte rows
    (F32, 6, (0, 0), "ldg"),             # 24-byte rows
    (F32, 4096, (4, 0), "ldg"),          # a misaligned
    (F32, 4096, (0, 8), "ldg"),          # b misaligned
    (BF16, 4096, (2, 2), "ldg"),
])
def test_plan(case):
    dtype, w, offsets, kernel = case
    assert plan(dtype, w, tuple(4096 + o for o in offsets)) == kernel


@pytest.mark.parametrize("dtype,ctype", [(F32, "float"),
                                         (BF16, "__nv_bfloat16")])
def test_tma_tile_matches_the_source(dtype, ctype):
    """``TMA_TILE``, which chip_smoke.py reports, is the (C, D, K) of the
    source's ``Tile<T>``, and it fits what the source asserts (16-byte
    rows, 128-byte aligned tiles, boxes of at most 256 a side, the ring
    and its barriers within the 227 KB a block may hold)."""
    src = _lib.source("rglru_scan").read_text()
    m = re.search(rf"struct Tile<{ctype}> {{\s*static constexpr int "
                  r"C = (\d+), D = (\d+), K = (\d+);", src)
    c, d, k = TMA_TILE[dtype]
    assert tuple(int(v) for v in m.groups()) == (c, d, k)
    size = dtype.itemsize
    assert c * size % 16 == 0 and c * d * size % 128 == 0
    assert c <= 256 and d <= 256
    assert k * 2 * c * d * size + 2 * k * 8 + 128 <= 227 * 1024


@pytest.mark.parametrize("s", [1, 5, 77, 130])
def test_any_seq_matches_pallas_interpret(ref, s):
    """No padding: S of any length gives the Pallas kernel's result
    (which pads S to its chunk) within the sweep's fp32 tolerance, and
    the plain version's bit for bit."""
    jnp, pallas_scan = ref
    a, b = _gates(2, s, 40, 20 + s)
    want = pallas_scan(jnp.asarray(a), jnp.asarray(b), chunk=64,
                       interpret=True)
    got = rglru_scan(torch.tensor(a), torch.tensor(b))
    assert got.shape == (2, s, 40)
    assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-5
    assert torch.equal(got, rglru_scan_plain(torch.tensor(a),
                                             torch.tensor(b)))


# --- on the card ---------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def _on_card(b, s, w, dtype, offset, device, seed):
    """a, b on the card; ``offset`` > 0 makes both views start that many
    elements into their storage (misaligned for TMA)."""
    out = []
    for x in _gates(b, s, w, seed):
        flat = torch.empty(b * s * w + offset, device=device, dtype=dtype)
        view = flat[offset:].view(b, s, w)
        view.copy_(torch.tensor(x, device=device).to(dtype))
        out.append(view)
    return out


# (b, s, w, dtype, element offset, kernel)
CUDA_CASES = [
    (2, 200, 128, F32, 0, "tma"),     # S not a multiple of D
    (3, 77, 100, F32, 0, "tma"),      # W not a multiple of C, batch 3
    (1, 5, 4, F32, 0, "tma"),         # S under D, W under C
    (2, 300, 72, BF16, 0, "tma"),     # bf16, W not a multiple of C
    (1, 130, 128, BF16, 0, "tma"),
    (3, 77, 100, BF16, 0, "ldg"),     # 200-byte rows: no tensor map
    (2, 50, 6, F32, 0, "ldg"),        # 24-byte rows
    (2, 100, 64, F32, 1, "ldg"),      # 16-byte-misaligned view
    (2, 100, 64, BF16, 3, "ldg"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES)
def test_cuda_rglru_kernels_bit_equal(cuda_device, case):
    b, s, w, dtype, offset, kernel = case
    a, bb = _on_card(b, s, w, dtype, offset, cuda_device, 30)
    assert plan(dtype, w, (a.data_ptr(), bb.data_ptr())) == kernel
    before = _lib.launch_counts["rglru_scan"]
    got = rglru_scan(a, bb)
    want = rglru_scan_plain(a, bb)
    torch.cuda.synchronize()
    assert _lib.launch_counts["rglru_scan"] == before + 1
    assert torch.equal(got, want)

