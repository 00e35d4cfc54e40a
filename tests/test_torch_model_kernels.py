"""The model kernels' plain PyTorch versions against the JAX package:
flash attention against the Pallas kernel in interpret mode and against
``attention_ref``, the RG-LRU scan against the Pallas kernel in
interpret mode and against ``rglru_ref``, on the shapes and with the
tolerances of ``tests/test_kernels.py``'s sweeps (plus an MQA, D=256,
windowed case: the recurrentgemma layout).  Inputs come from a numpy seed.

The ``cuda`` tests hold each CUDA kernel against its plain version on
the card; they skip where ``torch.cuda.is_available()`` is false.  The
reference imports happen in a fixture, so the file also collects on a
machine without JAX (where only the ``cuda`` tests run).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.flash_attention import flash_attention, \
    flash_attention_fwd
from repro_torch.kernels.flash_attention.ref import flash_attention_plain
from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_fwd
from repro_torch.kernels.rglru_scan.ref import rglru_scan_plain

# b, sq, sk, hq, hkv, d, causal, window, dtype, tol
FLASH_CASES = [
    (2, 256, 256, 4, 2, 64, True, None, "float32", 2e-5),
    (1, 200, 200, 4, 1, 64, True, 64, "float32", 2e-5),
    (2, 128, 384, 8, 8, 128, False, None, "float32", 2e-5),
    (1, 256, 256, 2, 2, 64, True, None, "bfloat16", 2e-2),
    (1, 96, 96, 4, 4, 32, True, 32, "float32", 2e-5),
    (1, 300, 300, 16, 1, 256, True, 64, "bfloat16", 2e-2),   # MQA, D=256
]
# b, s, w, chunk (of the Pallas kernel), dtype, tol
RGLRU_CASES = [
    (2, 200, 128, 128, "float32", 1e-5),
    (1, 512, 256, 128, "float32", 1e-5),
    (1, 130, 128, 64, "bfloat16", 2e-2),
]


@pytest.fixture(scope="module")
def ref():
    """The JAX package's flash-attention and RG-LRU modules (CPU)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.flash_attention.ops import flash_attention as pallas
    from repro.kernels.flash_attention.ref import attention_ref
    from repro.kernels.rglru_scan.ops import rglru_scan as pallas_scan
    from repro.kernels.rglru_scan.ref import rglru_ref
    return jnp, pallas, attention_ref, pallas_scan, rglru_ref


def _qkv(case, seed):
    b, sq, sk, hq, hkv, d = case[:6]
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, sq, hq, d), (b, sk, hkv, d),
                               (b, sk, hkv, d)))


def _port_flash(qkv, causal, window, dtype):
    td = getattr(torch, dtype)
    q, k, v = (torch.tensor(x).to(td) for x in qkv)
    return flash_attention(q, k, v, causal=causal,
                           window=window).float().numpy()


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_matches_pallas_interpret(ref, case):
    jnp, pallas = ref[0], ref[1]
    causal, window, dtype, tol = case[6:]
    qkv = _qkv(case, 1)
    want = pallas(*(jnp.asarray(x, getattr(jnp, dtype)) for x in qkv),
                  causal=causal, window=window, interpret=True)
    got = _port_flash(qkv, causal, window, dtype)
    err = np.abs(got - np.asarray(want.astype(jnp.float32))).max()
    assert err < tol, err


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_matches_attention_ref(ref, case):
    jnp, attention_ref = ref[0], ref[2]
    causal, window, dtype, tol = case[6:]
    qkv = _qkv(case, 2)
    q, k, v = (jnp.asarray(x, getattr(jnp, dtype)).transpose(0, 2, 1, 3)
               for x in qkv)
    want = attention_ref(q, k, v, causal=causal, window=window)
    got = _port_flash(qkv, causal, window, dtype)
    err = np.abs(got - np.asarray(want.astype(jnp.float32)
                                  .transpose(0, 2, 1, 3))).max()
    assert err < tol, err


def test_flash_masks_padded_keys(ref):
    """Keys the wrapper pads on (Sk not a block multiple) are masked even
    without causality: against the unpadded oracle, fp32 tolerance."""
    jnp, attention_ref = ref[0], ref[2]
    case = (2, 70, 50, 4, 2, 64)
    qkv = _qkv(case, 3)
    want = attention_ref(*(jnp.asarray(x).transpose(0, 2, 1, 3)
                           for x in qkv), causal=False)
    got = _port_flash(qkv, False, None, "float32")
    assert np.abs(got - np.asarray(want).transpose(0, 2, 1, 3)).max() < 2e-5


def test_flash_scale_is_applied_once():
    """``scale`` multiplies q once: scale=1 on q/sqrt(D) equals the
    default scale on q, bit for bit in fp32 when 1/sqrt(D) is a power of
    two."""
    q, k, v = (torch.tensor(x) for x in _qkv((1, 80, 80, 4, 1, 64), 4))
    a = flash_attention(q, k, v, window=32)
    b = flash_attention(q * 0.125, k, v, window=32, scale=1.0)
    assert torch.equal(a, b)


def test_flash_rejects_what_the_kernel_does_not_take():
    q = torch.zeros((1, 2, 64, 32))
    k = torch.zeros((1, 1, 32, 32))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention_fwd(q.half(), k.half(), k.half(), scale=1.0)
    with pytest.raises(ValueError, match="bad shapes"):
        flash_attention_fwd(q[:, :, :60], k, k, scale=1.0)
    with pytest.raises(ValueError, match="bad shapes"):
        flash_attention_fwd(q, k, k, scale=1.0, seq_k=33)
    with pytest.raises(ValueError, match="window"):
        flash_attention_fwd(q, k, k, scale=1.0, window=0)


@pytest.mark.parametrize("case", RGLRU_CASES)
def test_rglru_plain_matches_pallas_interpret(ref, case):
    jnp, pallas_scan = ref[0], ref[3]
    b, s, w, chunk, dtype, tol = case
    a, bb = _gates(b, s, w, 5)
    jd = getattr(jnp, dtype)
    want = pallas_scan(jnp.asarray(a, jd), jnp.asarray(bb, jd), chunk=chunk,
                       interpret=True)
    got = _port_scan(a, bb, dtype)
    assert np.abs(got - np.asarray(want.astype(jnp.float32))).max() < tol


@pytest.mark.parametrize("case", RGLRU_CASES)
def test_rglru_plain_matches_rglru_ref(ref, case):
    jnp, rglru_ref = ref[0], ref[4]
    b, s, w, _chunk, dtype, tol = case
    a, bb = _gates(b, s, w, 6)
    jd = getattr(jnp, dtype)
    want = rglru_ref(jnp.asarray(a, jd), jnp.asarray(bb, jd))
    got = _port_scan(a, bb, dtype)
    assert np.abs(got - np.asarray(want.astype(jnp.float32))).max() < tol


def _gates(b, s, w, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.7, 0.999, (b, s, w)).astype(np.float32),
            (rng.standard_normal((b, s, w)) * 0.1).astype(np.float32))


def _port_scan(a, b, dtype):
    td = getattr(torch, dtype)
    return rglru_scan(torch.tensor(a).to(td),
                      torch.tensor(b).to(td)).float().numpy()


def test_rglru_padding_leaves_the_state():
    """The wrapper pads S with a=1, b=0: the result equals the plain
    recurrence on the unpadded inputs, bit for bit."""
    a, b = (torch.tensor(x) for x in _gates(2, 37, 24, 7))
    assert torch.equal(rglru_scan(a, b), rglru_scan_plain(a, b))


def test_rglru_rejects_what_the_kernel_does_not_take():
    a = torch.zeros((1, 16, 8))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rglru_scan_fwd(a.double(), a.double())
    with pytest.raises(ValueError, match="S % 16"):
        rglru_scan_fwd(a[:, :15], a[:, :15])


def test_plain_versions_launch_nothing_on_cpu():
    before = dict(_lib.launch_counts)
    q, k, v = (torch.tensor(x) for x in _qkv((1, 64, 64, 2, 1, 32), 8))
    flash_attention(q, k, v)
    a, b = (torch.tensor(x) for x in _gates(1, 16, 8, 9))
    rglru_scan(a, b)
    assert dict(_lib.launch_counts) == before
    assert set(_lib.launch_counts) == {"wavefront_search", "slot_score",
                                       "fused_prepare", "flash_attention",
                                       "rglru_scan"}


# --- on the card ---------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES)
def test_cuda_flash_matches_plain(cuda_device, case):
    b, sq, sk, hq, hkv, d, causal, window, dtype, tol = case
    td = getattr(torch, dtype)
    q, k, v = (torch.tensor(x, device=cuda_device).to(td)
               .transpose(1, 2).contiguous() for x in _qkv(
                   (b, sq, sk, hq, hkv, d), 10))
    pq, pk = (-sq) % 64, (-sk) % 32
    q = torch.nn.functional.pad(q, (0, 0, 0, pq))
    k = torch.nn.functional.pad(k, (0, 0, 0, pk))
    v = torch.nn.functional.pad(v, (0, 0, 0, pk))
    before = _lib.launch_counts["flash_attention"]
    kw = dict(causal=causal, window=window, scale=d ** -0.5, seq_k=sk)
    got = flash_attention_fwd(q, k, v, **kw)
    want = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert _lib.launch_counts["flash_attention"] == before + 1
    err = (got.float() - want.float())[:, :, :sq].abs().max().item()
    assert err < tol, err


@pytest.mark.cuda
@pytest.mark.parametrize("case", RGLRU_CASES)
def test_cuda_rglru_matches_plain(cuda_device, case):
    b, s, w, _chunk, dtype, tol = case
    td = getattr(torch, dtype)
    a, bb = (torch.tensor(x, device=cuda_device).to(td)
             for x in _gates(b, s, w, 11))
    before = _lib.launch_counts["rglru_scan"]
    got = rglru_scan(a, bb)
    want = rglru_scan_plain(a, bb)
    torch.cuda.synchronize()
    assert _lib.launch_counts["rglru_scan"] == before + 1
    assert (got.float() - want.float()).abs().max().item() < tol
