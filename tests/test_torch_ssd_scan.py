"""The SSD scan's plain PyTorch version against the JAX package: against
the Pallas kernel in interpret mode and against ``ssd_ref`` (the
per-token recurrence), on the shapes and with the tolerances of
``tests/test_kernels.py::test_ssd_scan_sweep`` and its measure (max |d|
/ max |want|); then the wrapper's padding, layout and refusals.  Inputs
come from a numpy seed.

Then the kernels' decomposition, held on the CPU: the plain version's
segment carry against ``ssd_ref``, the exact bf16 split of fp32
operands, the measure that holds a bf16 output to it
(``rounding_excess``), the dispatch rule (``plan``) and the build's
header hash.

The ``cuda`` tests hold both CUDA kernels against the plain version on
the card; they skip where ``torch.cuda.is_available()`` is false.  The
reference imports happen in a fixture, so the file also collects on a
machine without JAX (where only the ``cuda`` test runs).
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import re

from repro_torch.kernels import _lib
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_fwd
from repro_torch.kernels.ssd_scan.ref import (CHUNK, rounding_excess,
                                              segment_chunks, split_bf16x3,
                                              ssd_scan_plain)
from repro_torch.kernels.ssd_scan.ssd_scan import plan

# b, s, h, hd, n, chunk (of the Pallas kernel), dtype, tol
SWEEP = [
    (2, 256, 3, 32, 16, 128, "float32", 1e-4),
    (1, 384, 2, 64, 128, 128, "float32", 1e-4),
    (1, 256, 2, 32, 64, 64, "float32", 1e-4),
    (1, 256, 2, 32, 16, 128, "bfloat16", 5e-2),
]


@pytest.fixture(scope="module")
def ref():
    """The JAX package's SSD wrapper (Pallas) and oracle (CPU)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.ssd_scan.ops import ssd_scan as pallas
    from repro.kernels.ssd_scan.ref import ssd_ref
    return jnp, pallas, ssd_ref


def _inputs(b, s, h, hd, n, seed):
    """The sweep's distributions: x ~ N(0, 1), dt ~ U(0.001, 0.1),
    B/C ~ 0.3 N(0, 1), A = -exp(U(-1, 1))."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, hd)).astype(np.float32),
            rng.uniform(0.001, 0.1, (b, s, h)).astype(np.float32),
            (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32),
            (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32),
            (-np.exp(rng.uniform(-1, 1, (h,)))).astype(np.float32))


def _port(inputs, dtype="float32", fn=ssd_scan):
    td = getattr(torch, dtype)
    x, dt, B, C, A = (torch.tensor(a) for a in inputs)
    return fn(x.to(td), dt, B.to(td), C.to(td), A)


def _oracle(ref, inputs, dtype="float32"):
    """ssd_ref on the reference's (b * H, S, .) layout, B and C broadcast
    over heads as its wrapper does; back in the model's layout."""
    jnp, ssd_ref = ref[0], ref[2]
    x, dt, B, C, A = inputs
    b, s, h, hd = x.shape
    n = B.shape[-1]
    jd = getattr(jnp, dtype)
    xr = jnp.asarray(x, jd).transpose(0, 2, 1, 3).reshape(b * h, s, hd)
    dtr = jnp.asarray(dt).transpose(0, 2, 1).reshape(b * h, s, 1)
    Br, Cr = (jnp.broadcast_to(jnp.asarray(a, jd)[:, None], (b, h, s, n))
              .reshape(b * h, s, n) for a in (B, C))
    Ar = jnp.broadcast_to(jnp.asarray(A)[None, :], (b, h)).reshape(b * h, 1)
    y = ssd_ref(xr, dtr, Br, Cr, Ar)
    return np.asarray(y.astype(jnp.float32)).reshape(
        b, h, s, hd).transpose(0, 2, 1, 3)


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


@pytest.mark.parametrize("case", SWEEP)
def test_plain_matches_pallas_interpret(ref, case):
    jnp, pallas = ref[0], ref[1]
    b, s, h, hd, n, chunk, dtype, tol = case
    inputs = _inputs(b, s, h, hd, n, 1)
    jd = getattr(jnp, dtype)
    x, dt, B, C, A = inputs
    want = pallas(jnp.asarray(x, jd), jnp.asarray(dt), jnp.asarray(B, jd),
                  jnp.asarray(C, jd), jnp.asarray(A), chunk=chunk,
                  interpret=True)
    rel = _rel(_port(inputs, dtype), np.asarray(want.astype(jnp.float32)))
    assert rel < tol, rel


@pytest.mark.parametrize("case", SWEEP)
def test_plain_matches_ssd_ref(ref, case):
    b, s, h, hd, n, _chunk, dtype, tol = case
    inputs = _inputs(b, s, h, hd, n, 2)
    rel = _rel(_port(inputs, dtype), _oracle(ref, inputs, dtype))
    assert rel < tol, rel


@settings(max_examples=12, deadline=None, database=None)
@given(b=st.integers(1, 2), s=st.integers(1, 150), h=st.integers(1, 3),
       hd=st.sampled_from([4, 8, 16]), n=st.sampled_from([4, 8, 16]),
       seed=st.integers(0, 2 ** 16))
def test_plain_matches_ssd_ref_on_any_shape(ref, b, s, h, hd, n, seed):
    """Any S, padded by the wrapper, within the sweep's fp32 tolerance."""
    inputs = _inputs(b, s, h, hd, n, seed)
    assert _rel(_port(inputs), _oracle(ref, inputs)) < 1e-4


@pytest.mark.parametrize("chunk", [16, 32, 128, 256])
def test_plain_is_chunk_invariant(chunk):
    """The chunk changes only the rounding: against the kernel's chunk,
    fp32, the sweep's tolerance (measured below 1e-6)."""
    x, dt, B, C, A = (torch.tensor(a) for a in _inputs(2, 512, 3, 16, 32, 3))
    want = ssd_scan_plain(x, dt, B, C, A)
    got = ssd_scan_plain(x, dt, B, C, A, chunk=chunk)
    assert _rel(got, want.numpy()) < 1e-5


def test_padding_leaves_real_positions(ref):
    """S = 200 is no multiple of the chunk: the wrapper pads with zeros
    and slices back.  Against the oracle on the unpadded inputs, and
    equal to the plain version on inputs padded by hand."""
    inputs = _inputs(2, 200, 3, 16, 32, 4)
    got = _port(inputs)
    assert got.shape == (2, 200, 3, 16)
    assert _rel(got, _oracle(ref, inputs)) < 1e-4
    pad = [np.pad(a, [(0, 0), (0, 56)] + [(0, 0)] * (a.ndim - 2))
           if a.ndim > 1 else a for a in inputs]
    assert torch.equal(got, _port(pad, fn=ssd_scan_plain)[:, :200])


def test_b_and_c_are_shared_views(ref):
    """B and C enter as (b, S, n), shared by the heads, and x, B and C as
    column slices of one conv output, as the model passes them: no
    per-head copy is asked for, and the result equals the oracle's on
    B and C broadcast over heads.  A per-head B is refused."""
    b, s, h, hd, n = 2, 128, 3, 16, 8
    x, dt, B, C, A = _inputs(b, s, h, hd, n, 5)
    xbc = torch.tensor(np.concatenate([x.reshape(b, s, h * hd), B, C], -1))
    xv = xbc[..., :h * hd].unflatten(-1, (h, hd))
    Bv, Cv = xbc[..., h * hd:h * hd + n], xbc[..., h * hd + n:]
    assert not xv.is_contiguous() and Bv.stride() == (s * (h * hd + 2 * n),
                                                      h * hd + 2 * n, 1)
    got = ssd_scan(xv, torch.tensor(dt), Bv, Cv, torch.tensor(A))
    assert _rel(got, _oracle(ref, (x, dt, B, C, A))) < 1e-4
    per_head = Bv[:, :, None].expand(b, s, h, n)
    with pytest.raises(ValueError, match="bad shapes"):
        ssd_scan_fwd(xv, torch.tensor(dt), per_head, per_head,
                     torch.tensor(A))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x, dt, B, C, A = (torch.tensor(a) for a in _inputs(1, CHUNK, 2, 8, 4, 6))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ssd_scan_fwd(x.half(), dt, B.half(), C.half(), A)
    with pytest.raises(TypeError, match="one type"):
        ssd_scan_fwd(x, dt, B.bfloat16(), C, A)
    with pytest.raises(TypeError, match="dt and A must be float32"):
        ssd_scan_fwd(x, dt.bfloat16(), B, C, A)
    with pytest.raises(TypeError, match="dt and A must be float32"):
        ssd_scan_fwd(x, dt, B, C, A.double())
    with pytest.raises(ValueError, match=f"S % {CHUNK}"):
        ssd_scan_fwd(x[:, :CHUNK - 1], dt[:, :CHUNK - 1], B[:, :CHUNK - 1],
                     C[:, :CHUNK - 1], A)
    with pytest.raises(ValueError, match="bad shapes"):
        ssd_scan_fwd(x, dt, B, C[..., :2], A)
    with pytest.raises(ValueError, match="bad shapes"):
        ssd_scan_fwd(x, dt, B, C, A[:1])
    with pytest.raises(ValueError, match="bad shapes"):
        ssd_scan_fwd(x, dt[..., :1], B, C, A)
    with pytest.raises(ValueError, match=r"\(b, S, H, hd\)"):
        ssd_scan_fwd(x[..., 0], dt, B, C, A)


def test_plain_version_launches_nothing_on_cpu():
    before = dict(_lib.launch_counts)
    assert "ssd_scan" in before
    got = _port(_inputs(1, 70, 2, 8, 4, 7))
    assert bool(torch.isfinite(got).all())
    assert dict(_lib.launch_counts) == before


@pytest.mark.parametrize("chunks", [5, 7])
@pytest.mark.parametrize("segments", [1, 2, 4])
def test_plain_segments_match_ssd_ref(ref, segments, chunks):
    """The kernel's segment carry (end states from zero, chained in
    order) changes only the rounding: against the oracle at the sweep's
    fp32 tolerance, S a multiple of no segment but one."""
    inputs = _inputs(2, chunks * CHUNK, 3, 16, 32, 9)
    x, dt, B, C, A = (torch.tensor(a) for a in inputs)
    got = ssd_scan_plain(x, dt, B, C, A, segments=segments)
    assert _rel(got, _oracle(ref, inputs)) < 1e-4


@pytest.mark.parametrize("scale", [1e-6, 1.0, 1e6])
def test_split_bf16x3_is_exact(scale):
    """hi + mid + lo rebuilds every fp32 input bit for bit, and a
    product through the pieces (three bf16 x bf16 products, each exact
    in fp32, summed in fp32) is within 2^-22 of the fp32 product."""
    rng = np.random.default_rng(10)
    v = torch.tensor((rng.standard_normal(4096)
                      * np.exp(rng.uniform(-8, 8, 4096)) * scale)
                     .astype(np.float32))
    hi, mid, lo = split_bf16x3(v)
    assert all(p.dtype == torch.bfloat16 for p in (hi, mid, lo))
    assert torch.equal((hi.float() + mid.float()) + lo.float(), v)
    w = torch.tensor(rng.standard_normal(4096).astype(np.float32)).bfloat16()
    got = (hi.float() * w.float() + mid.float() * w.float()) \
        + lo.float() * w.float()
    exact = v.double() * w.double()
    assert float(((got.double() - exact).abs()
                  / exact.abs().clamp_min(1e-300)).max()) <= 2 ** -22


MODEL_STRIDES = (8192 * 1792, 1792, 64, 8192 * 1792, 1792, 8192 * 1792, 1792)


@pytest.mark.parametrize("case", [
    # dtype, hd, n, strides (x 3, B 2, C 2), address offset in bytes,
    # (batch, heads, seq), expected (kernel, segments)
    ("bfloat16", 64, 128, MODEL_STRIDES, 0, (4, 24, 8192),
     ("wgmma", 8)),                       # mamba2-130m: 384 CTAs, 3 waves
    ("bfloat16", 16, 16, (80 * 128, 128, 16, 80 * 16, 16, 80 * 16, 16), 0,
     (2, 8, 128), ("wgmma", 2)),          # mamba2-smoke: one per chunk
    ("bfloat16", 64, 128, MODEL_STRIDES, 0, (1, 2, 64),
     ("wgmma", 1)),                       # one chunk
    ("bfloat16", 32, 16, (256 * 64, 64, 32, 256 * 16, 16, 256 * 16, 16), 0,
     (1, 2, 256), ("wgmma", 4)),          # 4 chunks on one CTA
    ("float32", 64, 128, MODEL_STRIDES, 0, (4, 24, 8192),
     ("cuda_core", 1)),                   # fp32: the CUDA-core kernel
    ("bfloat16", 48, 128, MODEL_STRIDES, 0, (4, 24, 8192),
     ("cuda_core", 1)),                   # hd outside the wgmma set
    ("bfloat16", 64, 96, MODEL_STRIDES, 0, (4, 24, 8192),
     ("cuda_core", 1)),                   # n outside the wgmma set
    ("bfloat16", 64, 128, MODEL_STRIDES, 2, (4, 24, 8192),
     ("cuda_core", 1)),                   # base not 16-byte aligned
    ("bfloat16", 64, 128, (8192 * 1790, 1790, 64, 8192 * 1790, 1790,
                           8192 * 1790, 1790), 0, (4, 24, 8192),
     ("cuda_core", 1)),                   # row stride 3580 B: no TMA
])
def test_dispatch_rule(case):
    dtype, hd, n, strides, off, (b, h, s), want = case
    got = plan(getattr(torch, dtype), hd, n, strides,
               (4096 + off, 8192, 8448), batch=b, heads=h, seq=s, sms=132)
    assert got == want
    kernel, segs = got
    if kernel == "wgmma":
        assert -(-h // 2) * b * segs >= 2 * 132 or segs == s // CHUNK
    assert segment_chunks(s // CHUNK, segs) * segs >= s // CHUNK


@pytest.mark.parametrize("case", [("bfloat16", 64, 6), ("float32", 6, 16),
                                  ("bfloat16", 18, 16)])
def test_dispatch_rule_refuses(case):
    dtype, hd, n = case
    with pytest.raises(ValueError, match="no SSD kernel takes"):
        plan(getattr(torch, dtype), hd, n, (8,) * 7, (0, 0, 0), batch=1,
             heads=2, seq=128, sms=132)


# The largest excess over bf16's rounding (ref.rounding_excess) that the
# bf16 kernels may show against the plain version's fp32 result, of the
# head's largest |y|: chip_smoke.SSD_EXACT_TOL.
EXACT_TOL = 1e-5


def _rounded(t, pieces):
    """t through ``pieces`` of its exact bf16 split, or TF32 (10 of its
    23 fraction bits, rounded to nearest)."""
    if pieces == "tf32":
        i = t.view(torch.int32)
        return ((i + 0x1000) & ~0x1FFF).view(torch.float32)
    return sum(q.float() for q in split_bf16x3(t)[:pieces])


def _plain_rounding_operands(x, dt, B, C, A, pieces, chunk=CHUNK):
    """ssd_scan_plain's sums in one segment, fp32 out, with each fp32
    operand of a product (M, x * w and the carried state) rounded as
    :func:`_rounded` does: a kernel that keeps fewer than three pieces."""
    b, s, h, hd = x.shape
    n = B.shape[-1]
    nc = s // chunk
    xf = x.float().reshape(b, nc, chunk, h, hd).transpose(2, 3)
    dtf = dt.reshape(b, nc, chunk, h).transpose(2, 3)
    Bf = B.float().reshape(b, nc, chunk, n)
    Cf = C.float().reshape(b, nc, chunk, n)
    cum = torch.cumsum(dtf * A[:, None], dim=-1)
    tril = torch.ones((chunk, chunk), dtype=torch.bool).tril()
    seg = (cum[..., :, None] - cum[..., None, :]).masked_fill(
        ~tril, float("-inf"))
    M = (Cf @ Bf.transpose(-1, -2))[:, :, None] * torch.exp(seg) \
        * dtf[..., None, :]
    y = _rounded(M, pieces) @ xf
    xw = xf * (dtf * torch.exp(cum[..., -1:] - cum))[..., None]
    new = _rounded(xw, pieces).transpose(-1, -2) @ Bf[:, :, None]
    decay = torch.exp(cum[..., -1])[..., None, None]
    state = torch.zeros((b, h, hd, n))
    for c in range(nc):
        y[:, c] += torch.exp(cum[:, c])[..., None] * (
            Cf[:, c, None] @ _rounded(state, pieces).transpose(-1, -2))
        state = state * decay[:, c] + new[:, c]
    return y.transpose(2, 3).reshape(b, s, h, hd)


@pytest.mark.parametrize("pieces", [3, "chunk", 2, "tf32", 1])
def test_rounding_excess_tells_exact_from_rounded_operands(pieces):
    """The plain version's fp32 result rounded to bf16 exceeds bf16's
    rounding by nothing; sums taken in another order (the chunk, or three
    pieces of every operand) by their fp32 rounding only, well under
    EXACT_TOL; TF32 and one bf16 piece by far more (measured here:
    1.6e-4 and 1.5e-3).  Two pieces (16 bits, 7.9e-7) fall under it
    too."""
    b, s, h, hd, n = 1, 512, 2, 32, 64
    x, dt, B, C, A = (torch.tensor(a) for a in _inputs(b, s, h, hd, n, 12))
    x, B, C = x.bfloat16(), B.bfloat16(), C.bfloat16()
    want32 = ssd_scan_plain(x.float(), dt, B.float(), C.float(), A)
    assert float(rounding_excess(want32.bfloat16(), want32).max()) == 0
    if pieces == "chunk":
        got = ssd_scan_plain(x.float(), dt, B.float(), C.float(), A,
                             chunk=16)
    else:
        got = _plain_rounding_operands(x, dt, B, C, A, pieces)
    excess = float(rounding_excess(got.bfloat16(), want32).max())
    if pieces in (3, "chunk"):
        assert excess < EXACT_TOL / 100, excess
    elif pieces == 2:
        assert excess < EXACT_TOL, excess
    else:
        assert excess > EXACT_TOL * 10, excess


@pytest.mark.parametrize("name", sorted(_lib.KERNELS))
def test_build_hash_covers_every_included_header(name):
    """Every header a kernel's source includes (its own and the shared
    kernels/csrc/ ones) is hashed into its library's name, so an edit to
    a header rebuilds every kernel that includes it."""
    src = _lib.source(name)
    included = {(src.parent / inc).resolve() for inc in re.findall(
        r'^#include "([^"]+)"', src.read_text(), re.M)}
    listed = {(_lib.PKG / h).resolve() for h in _lib.KERNELS[name].headers}
    assert included == listed
    assert all(p.exists() for p in listed)


# --- on the card ---------------------------------------------------------------
CUDA_CASES = [c[:5] + c[6:] for c in SWEEP] + [
    (2, 200, 3, 64, 128, "float32", 1e-4),      # S not a chunk multiple
    (2, 80, 8, 16, 16, "float32", 1e-4),        # mamba2-smoke's heads
    (1, 1024, 24, 64, 128, "bfloat16", 5e-2),   # mamba2-130m's heads
    (2, 200, 3, 48, 128, "bfloat16", 5e-2),     # bf16 on the CUDA cores
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES)
def test_cuda_ssd_scan_matches_plain(cuda_device, case):
    b, s, h, hd, n, dtype, tol = case
    td = getattr(torch, dtype)
    x, dt, B, C, A = (torch.tensor(a, device=cuda_device)
                      for a in _inputs(b, s, h, hd, n, 8))
    x, B, C = x.to(td), B.to(td), C.to(td)
    before = _lib.launch_counts["ssd_scan"]
    got = ssd_scan(x, dt, B, C, A)
    pad = (-s) % CHUNK
    padded = [torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
              for t in (x, dt, B, C)]
    want32 = ssd_scan_plain(*(t.float() for t in padded), A)[:, :s]
    want = want32.to(td)
    torch.cuda.synchronize()
    assert _lib.launch_counts["ssd_scan"] == before + 1
    rel = ((got.float() - want.float()).abs().max()
           / want.float().abs().max()).item()
    assert rel < tol, rel
    if td == torch.bfloat16:
        assert rounding_excess(got, want32).max().item() < EXACT_TOL


# b, s, h, hd, n, x/B/C as column views of one tensor (the model's
# layout), the segments plan gives on 132 SMs (test_tc_cases_segments)
TC_CASES = [
    (2, 320, 3, 16, 16, False, 5),              # one segment per chunk
    (12, 320, 21, 16, 16, True, 2),             # 3 + 2 chunks, odd H
    (8, 256, 66, 16, 16, True, 1),
    (1, 256, 2, 32, 16, True, 4),
    (4, 128, 132, 32, 16, False, 1),
    (1, 1024, 24, 64, 128, True, 16),
    (4, 1024, 24, 64, 128, True, 8),            # 2 chunks a segment
    (11, 256, 48, 64, 128, True, 1),
    (2, 200, 5, 64, 128, True, 4),              # odd H, S not a chunk multiple
]


def _tc_inputs(case, device, seed):
    """bf16 x, B and C (as column views of one tensor, or not), dt and A,
    padded to whole chunks as the wrapper pads them (before the views
    are cut, so that they stay views)."""
    b, s, h, hd, n, views, _ = case
    x, dt, B, C, A = (torch.tensor(a, device=device)
                      for a in _inputs(b, s, h, hd, n, seed))
    pad = (-s) % CHUNK
    x, dt, B, C = (torch.nn.functional.pad(
        t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (x, dt, B, C))
    if views:
        xbc = torch.cat([x.flatten(2), B, C], -1).bfloat16()
        x = xbc[..., :h * hd].unflatten(-1, (h, hd))
        B, C = xbc[..., h * hd:h * hd + n], xbc[..., h * hd + n:]
    else:
        x, B, C = x.bfloat16(), B.bfloat16(), C.bfloat16()
    return x, dt, B, C, A


def _tc_plan(x, B, C, sms):
    return plan(torch.bfloat16, x.shape[3], B.shape[2],
                (*x.stride()[:3], *B.stride()[:2], *C.stride()[:2]),
                (t.data_ptr() for t in (x, B, C)), batch=x.shape[0],
                heads=x.shape[2], seq=x.shape[1], sms=sms)


@pytest.mark.parametrize("case", TC_CASES)
def test_tc_cases_segments(case):
    """The card cases below reach the wgmma kernel in one segment and in
    several, by plan's own rule (132 SMs, as on the H100)."""
    x, _, B, C, _ = _tc_inputs(case, "cpu", 11)
    assert _tc_plan(x, B, C, 132) == ("wgmma", case[-1])
    assert B.is_contiguous() != case[5]


@pytest.mark.cuda
@pytest.mark.parametrize("case", TC_CASES)
def test_cuda_wgmma_ssd_scan_matches_plain(cuda_device, case):
    """The wgmma kernel (bf16), in one segment and in several, against
    the plain version with the same segments, at the bf16 sweep's 5e-2,
    per head at chip_smoke's 1e-2, and beyond bf16's rounding of the
    plain version's fp32 result at EXACT_TOL."""
    s = case[1]
    x, dt, B, C, A = _tc_inputs(case, cuda_device, 11)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    kernel, segs = _tc_plan(x, B, C, sms)
    assert kernel == "wgmma"
    before = _lib.launch_counts["ssd_scan"]
    got = ssd_scan_fwd(x, dt, B, C, A)[:, :s]
    want32 = ssd_scan_plain(x.float(), dt, B.float(), C.float(), A,
                            segments=segs)[:, :s]
    torch.cuda.synchronize()
    assert _lib.launch_counts["ssd_scan"] == before + 1
    d = (got.float() - want32.bfloat16().float()).abs()
    w = want32.bfloat16().float().abs()
    assert (d.max() / w.max()).item() < 5e-2
    assert (d.amax((0, 1, 3)) / w.amax((0, 1, 3))).max().item() < 1e-2
    assert rounding_excess(got, want32).max().item() < EXACT_TOL
