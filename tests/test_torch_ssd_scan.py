"""The SSD scan's plain PyTorch version against the JAX package: against
the Pallas kernel in interpret mode and against ``ssd_ref`` (the
per-token recurrence), on the shapes and with the tolerances of
``tests/test_kernels.py::test_ssd_scan_sweep`` and its measure (max |d|
/ max |want|); then the wrapper's padding, layout and refusals.  Inputs
come from a numpy seed.

The ``cuda`` test holds the CUDA kernel against the plain version on the
card; it skips where ``torch.cuda.is_available()`` is false.  The
reference imports happen in a fixture, so the file also collects on a
machine without JAX (where only the ``cuda`` test runs).
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.kernels import _lib
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_fwd
from repro_torch.kernels.ssd_scan.ref import CHUNK, ssd_scan_plain

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


# --- on the card ---------------------------------------------------------------
CUDA_CASES = [c[:5] + c[6:] for c in SWEEP] + [
    (2, 200, 3, 64, 128, "float32", 1e-4),      # S not a chunk multiple
    (2, 80, 8, 16, 16, "float32", 1e-4),        # mamba2-smoke's heads
    (1, 1024, 24, 64, 128, "bfloat16", 5e-2),   # mamba2-130m's heads
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
    want = ssd_scan_plain(*padded, A)[:, :s]
    torch.cuda.synchronize()
    assert _lib.launch_counts["ssd_scan"] == before + 1
    rel = ((got.float() - want.float()).abs().max()
           / want.float().abs().max()).item()
    assert rel < tol, rel
