"""The port's Mamba-2 model against the JAX package on identical weights:
``mamba2-smoke`` parameters drawn by the reference's ``init`` and loaded
into the port through ``params_from_reference``; every input made from a
numpy seed.  The JAX side runs on the CPU (its einsum ``_ssd``), the port
on the CPU (the SSD kernel's plain version).

The reference forms C·Bᵀ from two bf16 arrays into a bf16 result
(``repro/models/ssm.py:120``); the SSD kernel and its plain version form
it in fp32.  So in bf16 the two models differ by that rounding, held to
the tolerances of ``tests/test_torch_models.py`` (max |d log-softmax| <
1.5 with greedy agreement >= 0.95; measured 0.61 on the logits and 0.54
on 24 decode steps, agreement 1.0); in fp32 they agree to 1e-4.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import _lib
from repro_torch.models import CausalLM, Mamba2, SSMConfig, make_model, \
    params_from_reference
from repro_torch.models.convert import _flat, reference_items
from repro_torch.serving import Engine
from repro_torch.train import make_prefill_step, make_serve_step

ARCH = "mamba2-130m"
LOGSOFTMAX_TOL = 1.5      # max |d log-softmax|, bf16 (tests/test_decode.py)
AGREE = 0.95              # greedy agreement, as tests/test_decode.py


@pytest.fixture(scope="module")
def jx():
    """The JAX package (CPU) and a seeded ``mamba2-smoke``."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.models import make_model as jmake
    cfg = jget(ARCH, smoke=True)
    model = jmake(cfg)
    params = model.init(jax.random.PRNGKey(0))
    return jax, jnp, cfg, model, params


@pytest.fixture(scope="module")
def port(jx):
    """The port's model on the reference's weights."""
    jax, params = jx[0], jx[4]
    cfg = get_config(ARCH, smoke=True)
    model = CausalLM(cfg, "cpu")
    model.load_state_dict(params_from_reference(
        jax.tree.map(np.asarray, params), cfg))
    return cfg, model


def _np(x):
    return np.asarray(x, np.float32)


def _t(x, dtype=torch.bfloat16):
    return torch.tensor(np.asarray(x, np.float32)).to(dtype)


def _x(shape, seed, scale=1.0):
    return np.random.default_rng(seed).standard_normal(shape) * scale


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s))


def _logsoftmax_gap(a, b):
    a = torch.log_softmax(torch.tensor(np.asarray(a, np.float32)), -1)
    b = torch.log_softmax(torch.tensor(np.asarray(b, np.float32)), -1)
    return ((a - b).abs().max().item(),
            (a.argmax(-1) == b.argmax(-1)).float().mean().item())


def _mixer(jx, layer=0):
    """The reference's Mamba2 and the port's on layer ``layer``'s mixer
    weights of the smoke model."""
    jax, jnp = jx[0], jx[1]
    from repro.models.ssm import Mamba2 as JMamba2, SSMConfig as JCfg
    kw = dict(d_model=64, d_state=16, head_dim=16)
    p = jax.tree.map(lambda a: np.asarray(a)[layer],
                     jx[4]["stack"]["groups"]["l0"]["mixer"])
    mod = Mamba2(SSMConfig(**kw), "cpu")
    mod.load_state_dict({k: torch.tensor(v) for k, v in _flat(p)})
    return JMamba2(JCfg(**kw, chunk=16)), jax.tree.map(jnp.asarray, p), mod


# --- configs -------------------------------------------------------------------
@pytest.mark.parametrize("smoke", [False, True])
def test_config_mirrors_reference(jx, smoke):
    from repro.configs import get_config as jget
    want = jget(ARCH, smoke=smoke)
    got = get_config(ARCH, smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count_estimate() == want.param_count_estimate()


def test_full_width_parameters_match_reference(jx):
    """At full width (24 layers, d_model 768), every reference parameter
    maps onto a port parameter of the same shape and none is left over;
    shapes only (the meta device allocates nothing)."""
    jax = jx[0]
    from repro.configs import get_config as jget
    from repro.models import make_model as jmake
    shapes = jax.eval_shape(jmake(jget(ARCH)).init, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                        shapes)
    cfg = get_config(ARCH)
    want = {k: tuple(v.shape) for k, v in reference_items(tree, cfg)}
    model = CausalLM(cfg, "meta")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    assert got["stack.layers.23.mixer.in_proj"] == (768, 3352)
    assert "stack.layers.0.ffn" not in str(sorted(got))
    n = sum(int(np.prod(s)) for s in got.values())
    assert n == 129_057_216       # 24 x 3,763,528 + 50432 x 768 + 768


def test_init_matches_reference_fixed_values(jx):
    """A_log, D, dt_bias and the norm scale are fixed values in the
    reference's init (dt_bias from numpy's seed 0): the port draws the
    same ones; the random weights keep the reference's fan-in scale."""
    params = jx[4]
    cfg = get_config(ARCH, smoke=True)
    model = make_model(cfg, device="cpu", seed=5)
    ref = params["stack"]["groups"]["l0"]["mixer"]
    mix = model.stack.layers[1].mixer
    for name in ("D", "dt_bias"):
        np.testing.assert_array_equal(getattr(mix, name).numpy(),
                                      np.asarray(ref[name])[1], name)
    # log(1 .. H): torch's and XLA's fp32 log differ by an ulp at log 7.
    np.testing.assert_allclose(mix.A_log.numpy(), np.asarray(ref["A_log"])[1],
                               rtol=1e-6, atol=0)
    assert mix.norm.scale.eq(1.0).all()
    assert mix.conv_w.abs().max().item() <= 2.0 / 2.0   # +-2 sigma, fan-in 4
    assert mix.in_proj.abs().max().item() <= 2.0 / 8.0  # fan-in 64


# --- the mixer -----------------------------------------------------------------
def test_mamba2_apply_and_decode(jx):
    """S=40 (padded to the reference's chunk of 16 inside its mixer, and
    to the kernel's 64 by the port's scan wrapper): forward and 40 decode
    steps against the
    reference's, in bf16, and decode against the port's own forward."""
    jnp = jx[1]
    jmod, jp, mod = _mixer(jx)
    x = _x((2, 40, 64), 1)
    want = jmod.apply(jp, jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        got = mod(_t(x))
    assert got.shape == (2, 40, 64) and got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - _np(want.astype(jnp.float32))).max()
    assert err < 6e-2, err      # measured 0.0234: 1 bf16 ulp at |y| < 4
    cache, jcache = mod.init_cache(2), jmod.init_cache(2)
    assert cache["ssm"].shape == (2, 8, 16, 16)
    assert cache["ssm"].dtype == torch.float32
    outs, jouts = [], []
    with torch.no_grad():
        for i in range(40):
            y, cache = mod.decode(_t(x[:, i:i + 1]), cache)
            jy, jcache = jmod.decode(jp, jnp.asarray(x[:, i:i + 1],
                                                     jnp.bfloat16), jcache)
            outs.append(y.float().numpy())
            jouts.append(_np(jy.astype(jnp.float32)))
    dec = np.concatenate(outs, 1)
    assert np.abs(dec - np.concatenate(jouts, 1)).max() < 6e-2   # 0.0234
    assert np.abs(dec - got.float().numpy()).max() < 6e-2        # 0
    np.testing.assert_allclose(cache["ssm"].numpy(), _np(jcache["ssm"]),
                               rtol=0, atol=2e-2)     # 0.0019


def test_mamba2_fp32_matches_reference(jx):
    """In fp32 the mixer's forward (plain chunked scan at 64 tokens) and
    decode equal the reference's (einsum ``_ssd`` at 16) to 1e-4."""
    jnp = jx[1]
    jmod, jp, mod = _mixer(jx, layer=1)
    x = _x((2, 70, 64), 2)
    want = _np(jmod.apply(jp, jnp.asarray(x, jnp.float32)))
    with torch.no_grad():
        got = mod(_t(x, torch.float32)).numpy()
        cache, outs = mod.init_cache(2, torch.float32), []
        for i in range(70):
            y, cache = mod.decode(_t(x[:, i:i + 1], torch.float32), cache)
            outs.append(y.numpy())
    assert np.abs(got - want).max() < 1e-4           # measured 1.7e-6
    assert np.abs(np.concatenate(outs, 1) - want).max() < 1e-4   # 1.4e-6


# --- the model -----------------------------------------------------------------
def test_causal_lm_logits(jx, port):
    jnp, jmodel, params = jx[1], jx[3], jx[4]
    cfg, model = port
    toks = _tokens(cfg, 2, 80, 11)
    want, _ = jmodel.apply(params, jnp.asarray(toks, jnp.int32), remat=False)
    got = make_prefill_step(model, cfg)(torch.as_tensor(toks))
    assert got.shape == (2, 80, cfg.padded_vocab) and got.dtype == torch.float32
    gap, agree = _logsoftmax_gap(want, got)
    assert gap < LOGSOFTMAX_TOL and agree >= AGREE, (gap, agree)


def test_causal_lm_fp32_structure(jx, port, monkeypatch):
    """With both packages computing in fp32 the logits agree to 1e-4,
    and so do the port's decode steps: the bf16 gaps are rounding, not
    structure."""
    import repro.models.common as jcommon
    jnp, jmodel, params = jx[1], jx[3], jx[4]
    cfg, model = port
    monkeypatch.setattr(jcommon, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(model, "compute_dtype", torch.float32)
    toks = _tokens(cfg, 2, 80, 12)
    want, _ = jmodel.apply(params, jnp.asarray(toks, jnp.int32), remat=False)
    got = make_prefill_step(model, cfg)(torch.as_tensor(toks))
    assert np.abs(got.numpy() - _np(want)).max() < 1e-4   # measured 2.0e-5
    step, caches = make_serve_step(model, cfg), model.init_caches(2, 80)
    assert caches[0]["conv"].dtype == caches[1]["ssm"].dtype == torch.float32
    outs = []
    for i in range(80):
        lg, caches = step(torch.as_tensor(toks[:, i:i + 1]), caches, i)
        outs.append(lg)
    assert (torch.cat(outs, 1) - got).abs().max().item() < 1e-4   # 1.9e-5


def test_decode_steps_match_reference_and_forward(jx, port):
    """24 tokens one by one through the serve step (tests/test_decode.py's
    mamba2-130m case): against the reference's decode steps and against
    the port's own forward."""
    jnp, jmodel, params = jx[1], jx[3], jx[4]
    cfg, model = port
    b, s = 2, 24
    toks = _tokens(cfg, b, s, 13)
    step = make_serve_step(model, cfg)
    caches, jcaches = model.init_caches(b, s), jmodel.init_caches(b, s)
    outs, jouts = [], []
    for i in range(s):
        lg, caches = step(torch.as_tensor(toks[:, i:i + 1]), caches, i)
        jlg, jcaches = jmodel.decode_step(
            params, jnp.asarray(toks[:, i:i + 1], jnp.int32), jcaches,
            jnp.int32(i))
        assert lg.shape == (b, 1, cfg.padded_vocab)
        outs.append(lg)
        jouts.append(_np(jlg))
    dec = torch.cat(outs, 1)
    gap, agree = _logsoftmax_gap(np.concatenate(jouts, 1), dec)
    assert gap < LOGSOFTMAX_TOL and agree >= AGREE, (gap, agree)
    fwd = make_prefill_step(model, cfg)(torch.as_tensor(toks))
    gap, agree = _logsoftmax_gap(fwd, dec)
    assert gap < LOGSOFTMAX_TOL and agree >= AGREE, (gap, agree)


# --- serving -------------------------------------------------------------------
def test_engine_generate_keeps_the_prompt(jx, port):
    jnp, jmodel, params = jx[1], jx[3], jx[4]
    cfg, model = port
    prompt = _tokens(cfg, 3, 5, 14)
    before = dict(_lib.launch_counts)
    out = Engine(model, cfg, max_len=64, track_transfers=False).generate(
        torch.as_tensor(prompt), 8)
    assert out.shape == (3, 13)
    assert torch.equal(out[:, :5], torch.as_tensor(prompt))
    assert dict(_lib.launch_counts) == before
    from repro.serving import Engine as JEngine
    want = JEngine(jmodel, jx[2], max_len=64, track_transfers=False).generate(
        params, jnp.asarray(prompt, jnp.int32), 8)
    agree = float((out.numpy() == np.asarray(want)).mean())
    assert agree >= AGREE, agree


def test_serve_launcher():
    from repro_torch.launch.serve import main
    out = main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "3", "--new-tokens", "4"])
    assert out.shape == (2, 7)
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--arch", ARCH, "--smoke"])
