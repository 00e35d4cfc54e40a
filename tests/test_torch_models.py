"""The port's model stack against the JAX package on identical weights:
``recurrentgemma-smoke`` parameters drawn by the reference's ``init`` and
loaded into the port through ``params_from_reference``; every input made
from a numpy seed.  The JAX side runs on the CPU (its einsum and scan
twins of the kernels), the port on the CPU (the kernels' plain versions).

Both sides compute in bf16 but round at different places (XLA's fused
elementwise bf16 against PyTorch's op-by-op bf16, another summation
order in every product), so each comparison states a tolerance measured
with margin.  In fp32 the whole model agrees to 1e-4 (the structure
test); in bf16 the logits' log-softmax differs by 0.38-0.71 (forward and
decode, several seeds), held under 1.5 — the reference's own decode-vs-forward tolerance
for recurrent models (``tests/test_decode.py``) — with greedy agreement
at least 0.95.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels import _lib
from repro_torch.models import (CausalLM, Embed, RMSNorm, make_model,
                                params_from_reference)
from repro_torch.models.attention import Attention, AttentionConfig
from repro_torch.models.common import apply_rope
from repro_torch.models.convert import _flat, reference_items
from repro_torch.models.mlp import MLP, MLPConfig
from repro_torch.models.rglru import RecurrentBlock, RGLRUConfig
from repro_torch.serving import Engine
from repro_torch.train import make_prefill_step, make_serve_step

LOGSOFTMAX_TOL = 1.5      # max |d log-softmax|, bf16 (measured 0.38-0.71)
AGREE = 0.95              # greedy agreement, as tests/test_decode.py


def DECODE_GAP_MARGIN(ref_gap):
    """How far the port's bf16 decode-vs-forward gap may lie from the
    reference's own (with its TPU kernel) at the same width: measured
    0.561 against 0.512 at d_model 64, 3.08 against 3.37 at 512."""
    return 0.25 * ref_gap + 0.25


@pytest.fixture(scope="module")
def jx():
    """The JAX package (CPU) and a seeded ``recurrentgemma-smoke``."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.models import make_model as jmake
    cfg = jget("recurrentgemma-9b", smoke=True)
    model = jmake(cfg)
    params = model.init(jax.random.PRNGKey(0))
    return jax, jnp, cfg, model, params


@pytest.fixture(scope="module")
def port(jx):
    """The port's model on the reference's weights."""
    jax, _jnp, _cfg, _model, params = jx
    cfg = get_config("recurrentgemma-9b", smoke=True)
    model = CausalLM(cfg, "cpu")
    model.load_state_dict(params_from_reference(
        jax.tree.map(np.asarray, params), cfg))
    return cfg, model


def _np(x):
    return np.asarray(x, np.float32)


def _t(x, dtype=torch.bfloat16):
    return torch.tensor(np.asarray(x, np.float32)).to(dtype)


def _load(module, tree):
    """Load a reference module's param subtree into a port module."""
    module.load_state_dict({k: torch.tensor(v) for k, v in _flat(tree)})
    return module


def _x(shape, seed, scale=1.0):
    return np.random.default_rng(seed).standard_normal(shape) * scale


def _layer(jx, i):
    """Layer i of the reference's smoke stack (group 0) as a param tree."""
    jax, params = jx[0], jx[4]
    return jax.tree.map(lambda a: np.asarray(a)[0],
                        params["stack"]["groups"][f"l{i}"])


# --- configs -------------------------------------------------------------------
@pytest.mark.parametrize("smoke", [False, True])
def test_config_mirrors_reference(jx, smoke):
    from repro.configs import get_config as jget
    want = jget("recurrentgemma-9b", smoke=smoke)
    got = get_config("recurrentgemma-9b", smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count_estimate() == want.param_count_estimate()
    assert sorted(ARCHS) == ["mamba2-130m", "recurrentgemma-9b"]


def test_full_width_parameters_match_reference(jx):
    """At full width (38 layers, d_model 4096), every reference parameter
    maps onto a port parameter of the same shape and none is left over;
    shapes only (the meta device allocates nothing)."""
    jax = jx[0]
    from repro.configs import get_config as jget
    from repro.models import make_model as jmake
    shapes = jax.eval_shape(jmake(jget("recurrentgemma-9b")).init,
                            jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                        shapes)
    cfg = get_config("recurrentgemma-9b")
    want = {k: tuple(v.shape) for k, v in reference_items(tree, cfg)}
    model = CausalLM(cfg, "meta")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    n = sum(int(np.prod(s)) for s in got.values())
    assert n == 9_396_301_824       # 37.6 GB of fp32 parameters


# --- modules -------------------------------------------------------------------
def test_rmsnorm(jx):
    from repro.models.common import RMSNorm as JNorm
    jnp = jx[1]
    scale = _x((64,), 1, 0.1)
    x = _x((2, 7, 64), 2, 3.0)
    want = JNorm(64, zero_centered=True).apply(
        {"scale": jnp.asarray(scale, jnp.float32)}, jnp.asarray(x, jnp.bfloat16))
    mod = RMSNorm(64, zero_centered=True, device="cpu")
    mod.scale.copy_(torch.tensor(scale))
    got = mod(_t(x))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - _np(want.astype(jnp.float32))).max()
    assert err < 2e-2, err      # measured 0; 1 bf16 ulp at |y| < 4


def test_embed_apply_and_attend(jx):
    from repro.models.common import Embed as JEmbed
    jnp = jx[1]
    table = _x((256, 64), 3)
    ids = np.random.default_rng(4).integers(0, 256, (2, 9))
    jmod = JEmbed(256, 64, scale_by_sqrt_dim=True)
    p = {"embedding": jnp.asarray(table, jnp.float32)}
    mod = Embed(256, 64, scale_by_sqrt_dim=True, device="cpu")
    mod.embedding.copy_(torch.tensor(table))
    got = mod(torch.as_tensor(ids))
    want = jmod.apply(p, jnp.asarray(ids))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  _np(want.astype(jnp.float32)))
    x = _x((2, 9, 64), 5)
    lg = mod.attend(_t(x))
    assert lg.dtype == torch.float32
    err = np.abs(lg.numpy() - _np(jmod.attend(p, jnp.asarray(
        x, jnp.bfloat16)))).max()
    assert err < 1e-4, err      # measured 0: fp32 products of bf16 inputs


def test_rope_is_split_half(jx):
    from repro.models.common import apply_rope as japply
    jnp = jx[1]
    x = _x((2, 11, 3, 16), 6)
    pos = np.stack([np.arange(11), np.arange(100, 111)])
    want = japply(jnp.asarray(x, jnp.float32), jnp.asarray(pos))
    got = apply_rope(torch.tensor(x, dtype=torch.float32),
                     torch.as_tensor(pos))
    assert np.abs(got.numpy() - _np(want)).max() < 1e-5   # measured 2.4e-7
    # split-half: feature i pairs with i + hd/2, not with i + 1
    one = torch.zeros((1, 1, 1, 16))
    one[..., 0] = 1.0
    rot = apply_rope(one, torch.tensor([[1]]))
    assert rot[..., 8].item() != 0.0 and rot[..., 1].item() == 0.0


def test_mlp_gelu_tanh(jx):
    from repro.models.mlp import MLP as JMLP, MLPConfig as JCfg
    jax, jnp = jx[0], jx[1]
    jmod = JMLP(JCfg(64, 128, activation="gelu_tanh"))
    p = jmod.init(jax.random.PRNGKey(7))
    mod = _load(MLP(MLPConfig(64, 128, activation="gelu_tanh"), "cpu"),
                jax.tree.map(np.asarray, p))
    x = _x((2, 5, 64), 8)
    want = jmod.apply(p, jnp.asarray(x, jnp.bfloat16))
    got = mod(_t(x))
    err = np.abs(got.float().numpy() - _np(want.astype(jnp.float32))).max()
    assert err < 3e-2, err      # measured 0.0078


def test_attention_apply_and_ring_decode(jx):
    """S=80 > window 32: prefill through the flash kernel's plain version
    and 80 decode steps whose ring buffer wraps twice."""
    jnp = jx[1]
    from repro.models.attention import Attention as JAttn, \
        AttentionConfig as JCfg
    kw = dict(d_model=64, n_heads=4, n_kv=1, head_dim=16, window=32)
    jmod, p = JAttn(JCfg(**kw)), _layer(jx, 2)["mixer"]
    mod = _load(Attention(AttentionConfig(**kw), "cpu"), p)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    x = _x((2, 80, 64), 9)
    want = jmod.apply(jp, jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        got = mod(_t(x))
    err = np.abs(got.float().numpy() - _np(want.astype(jnp.float32))).max()
    assert err < 6e-2, err      # measured 0.031: 1 bf16 ulp at |y| in [4, 8)
    cache, jcache = mod.init_cache(2, 80), jmod.init_cache(2, 80)
    assert cache["k"].shape == (2, 32, 1, 16)
    outs, jouts = [], []
    with torch.no_grad():
        for i in range(80):
            y, cache = mod.decode(_t(x[:, i:i + 1]), cache, i)
            jy, jcache = jmod.decode(jp, jnp.asarray(x[:, i:i + 1],
                                                     jnp.bfloat16),
                                     jcache, jnp.int32(i))
            outs.append(y.float().numpy())
            jouts.append(_np(jy.astype(jnp.float32)))
    dec = np.concatenate(outs, 1)
    assert np.abs(dec - np.concatenate(jouts, 1)).max() < 6e-2   # 1.2e-4
    assert np.abs(dec - got.float().numpy()).max() < 6e-2        # 0.031


def test_recurrent_block_apply_and_decode(jx):
    jnp = jx[1]
    from repro.models.rglru import RecurrentBlock as JBlock, \
        RGLRUConfig as JCfg
    jmod, p = JBlock(JCfg(d_model=64, lru_width=64)), _layer(jx, 0)["mixer"]
    mod = _load(RecurrentBlock(RGLRUConfig(d_model=64, lru_width=64), "cpu"),
                p)
    import jax
    jp = jax.tree.map(jnp.asarray, p)
    x = _x((2, 40, 64), 10)
    want = jmod.apply(jp, jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        got = mod(_t(x))
    err = np.abs(got.float().numpy() - _np(want.astype(jnp.float32))).max()
    assert err < 6e-2, err      # measured 0.0039
    cache, jcache = mod.init_cache(2), jmod.init_cache(2)
    outs, jouts = [], []
    with torch.no_grad():
        for i in range(40):
            y, cache = mod.decode(_t(x[:, i:i + 1]), cache)
            jy, jcache = jmod.decode(jp, jnp.asarray(x[:, i:i + 1],
                                                     jnp.bfloat16), jcache)
            outs.append(y.float().numpy())
            jouts.append(_np(jy.astype(jnp.float32)))
    dec = np.concatenate(outs, 1)
    assert np.abs(dec - np.concatenate(jouts, 1)).max() < 6e-2   # 0.0039
    assert np.abs(dec - got.float().numpy()).max() < 6e-2        # 0
    assert cache["h"].dtype == torch.float32


# --- the model -----------------------------------------------------------------
def _logsoftmax_gap(a, b):
    a = torch.log_softmax(torch.tensor(np.asarray(a, np.float32)), -1)
    b = torch.log_softmax(torch.tensor(np.asarray(b, np.float32)), -1)
    return ((a - b).abs().max().item(),
            (a.argmax(-1) == b.argmax(-1)).float().mean().item())


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s))


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
    and so do the port's decode steps: the bf16 gaps above are rounding,
    not structure."""
    import repro.models.common as jcommon
    jnp, jmodel, params = jx[1], jx[3], jx[4]
    cfg, model = port
    monkeypatch.setattr(jcommon, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(model, "compute_dtype", torch.float32)
    toks = _tokens(cfg, 2, 80, 12)
    want, _ = jmodel.apply(params, jnp.asarray(toks, jnp.int32), remat=False)
    got = make_prefill_step(model, cfg)(torch.as_tensor(toks))
    assert np.abs(got.numpy() - _np(want)).max() < 1e-4   # measured 2.3e-5
    step, caches = make_serve_step(model, cfg), model.init_caches(2, 80)
    assert caches[2]["k"].dtype == caches[0]["conv"].dtype == torch.float32
    outs = []
    for i in range(80):
        lg, caches = step(torch.as_tensor(toks[:, i:i + 1]), caches, i)
        outs.append(lg)
    assert (torch.cat(outs, 1) - got).abs().max().item() < 1e-4   # 2.3e-5


def test_decode_steps_match_reference_and_forward(jx, port):
    """24 tokens one by one through the serve step: against the
    reference's decode steps and against the port's own forward."""
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


def test_engine_track_transfers_is_not_ported(port):
    """The serving control plane is ported: ``Engine(model, cfg)``
    tracks transfers by default, as the reference does, with its fabric
    on the card (without a GPU that raises; ``device="cpu"`` runs the
    plain versions).  tests/test_torch_serving.py holds it against the
    reference."""
    cfg, model = port
    if torch.cuda.is_available():
        assert Engine(model, cfg).fabric.allocator.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Engine(model, cfg)
    eng = Engine(model, cfg, device="cpu")
    assert eng.track_transfers and eng.pool is not None
    assert eng.fabric.allocator.device.type == "cpu"


def test_serve_launcher(port):
    from repro_torch.launch.serve import main
    out = main(["--arch", "recurrentgemma-9b", "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "3", "--new-tokens", "4"])
    assert out.shape == (2, 7)
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--arch", "recurrentgemma-9b", "--smoke"])


def test_make_model_seeds_and_refuses_unported_configs():
    cfg = get_config("recurrentgemma-9b", smoke=True)
    a, b = (make_model(cfg, device="cpu", seed=3) for _ in range(2))
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name
    w = a.stack.layers[0].mixer.proj_x
    assert w.abs().max().item() <= 2.0 / 8.0       # +-2 sigma, fan-in 64
    assert a.final_norm.scale.abs().max().item() == 0.0   # zero-centered
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_model(cfg)
    k = cfg.pattern[0]
    for bad in (dataclasses.replace(cfg, arch_type="encdec"),
                dataclasses.replace(cfg, tie_embeddings=False),
                dataclasses.replace(cfg, pattern=(dataclasses.replace(
                    k, ffn="moe"),)),
                dataclasses.replace(cfg, qkv_bias=True),
                dataclasses.replace(cfg, qk_norm=True)):
        with pytest.raises(NotImplementedError, match="not ported"):
            make_model(bad, device="cpu")
        with pytest.raises(NotImplementedError, match="not ported"):
            CausalLM(bad, "cpu")


def test_attention_refuses_what_the_kernel_lacks():
    kw = dict(d_model=64, n_heads=4, n_kv=1, head_dim=16)
    mod = Attention(AttentionConfig(logit_softcap=30.0, **kw), "cpu")
    with pytest.raises(NotImplementedError, match="soft-capping"):
        mod(torch.zeros((1, 4, 64), dtype=torch.bfloat16))
    mod = Attention(AttentionConfig(**kw), "cpu")
    with pytest.raises(NotImplementedError, match="prefix-LM"):
        mod(torch.zeros((1, 4, 64), dtype=torch.bfloat16), prefix_len=2)


@pytest.mark.parametrize("d_model", [64, 512])
def test_decode_gap_is_rounding(jx, monkeypatch, d_model):
    """In fp32 the port's decode reproduces its forward (< 1e-3).  In bf16
    the two differ by the attention kernel's rounding: it casts the
    unnormalised probabilities to bf16 before P.V, as the TPU kernel does,
    where the einsum decode casts the normalised ones.  The reference
    shows the same gap between its own decode and its own forward once
    that forward runs its TPU kernel (the Pallas kernel in interpret mode
    in place of the einsum attention), and the port's bf16 gap stays
    within DECODE_GAP_MARGIN of that gap at each width.  The gap grows
    with width: with random tied weights the largest logit (the input
    token's own) is ~d_model, so a last-bit change of the final hidden
    state moves a row's log-softmax by ~d_model / 256.  12 layers, vocab
    4096, 16 tokens; the numbers print with ``pytest -s``."""
    jax, jnp = jx[0], jx[1]
    import repro.models.attention as jattention
    from repro.configs import get_config as jget
    from repro.kernels.flash_attention.flash_attention import (
        flash_attention_fwd)
    from repro.models import make_model as jmake
    kw = dict(n_layers=12, d_model=d_model, lru_width=d_model,
              d_ff=3 * d_model, vocab=4096, n_heads=16, head_dim=256)
    jcfg = dataclasses.replace(jget("recurrentgemma-9b"), **kw)
    cfg = dataclasses.replace(get_config("recurrentgemma-9b"), **kw)
    jmodel = jmake(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    model = CausalLM(cfg, "cpu")
    model.load_state_dict(params_from_reference(
        jax.tree.map(np.asarray, params), cfg))
    b, s = 2, 16
    toks = _tokens(cfg, b, s, 15)
    jtoks = jnp.asarray(toks, jnp.int32)
    jfwd, _ = jmodel.apply(params, jtoks, remat=False)
    jcaches, jouts = jmodel.init_caches(b, s), []
    for i in range(s):
        lg, jcaches = jmodel.decode_step(params, jtoks[:, i:i + 1], jcaches,
                                         jnp.int32(i))
        jouts.append(_np(lg))
    jdec = np.concatenate(jouts, 1)
    ref_self = _logsoftmax_gap(jdec, jfwd)
    kernel_calls = []

    def attend_kernel(self, q, k, v, mask):
        del mask                   # causal + window, from the kernel's iota
        kernel_calls.append(q.shape)
        pad = (-q.shape[1]) % 128  # the kernel's default blocks
        t = [jnp.pad(x, ((0, 0), (0, pad), (0, 0), (0, 0))).transpose(
            0, 2, 1, 3) for x in (q, k, v)]
        o = flash_attention_fwd(*t, causal=True, window=self.cfg.window,
                                scale=1.0, interpret=True)
        return o.transpose(0, 2, 1, 3)[:, :q.shape[1]]
    monkeypatch.setattr(jattention.Attention, "_attend_dense", attend_kernel)
    jfwd_kernel, _ = jmodel.apply(params, jtoks, remat=False)
    assert kernel_calls     # traced once, in the scan over layer groups
    ref_kernel = _logsoftmax_gap(jdec, jfwd_kernel)
    gaps = {}
    for dtype in (torch.bfloat16, torch.float32):
        model.compute_dtype = dtype
        fwd = make_prefill_step(model, cfg)(torch.as_tensor(toks))
        step, caches, outs = make_serve_step(model, cfg), \
            model.init_caches(b, s), []
        for i in range(s):
            lg, caches = step(torch.as_tensor(toks[:, i:i + 1]), caches, i)
            outs.append(lg)
        gaps[dtype] = _logsoftmax_gap(torch.cat(outs, 1), fwd)
    print(f"d_model {d_model}: logits' std {float(np.std(_np(jfwd))):.3g}; "
          f"max |d log-softmax| (greedy agreement), decode vs forward: port "
          f"bf16 {gaps[torch.bfloat16][0]:.3g} ({gaps[torch.bfloat16][1]:.3g})"
          f", port fp32 {gaps[torch.float32][0]:.3g}; reference bf16 with "
          f"its TPU kernel {ref_kernel[0]:.3g} ({ref_kernel[1]:.3g}), with "
          f"its einsum attention {ref_self[0]:.3g} ({ref_self[1]:.3g})")
    assert gaps[torch.float32][0] < 1e-3
    port_gap = gaps[torch.bfloat16][0]
    assert abs(port_gap - ref_kernel[0]) <= DECODE_GAP_MARGIN(ref_kernel[0])
    assert min(gaps[torch.bfloat16][1], ref_kernel[1], ref_self[1]) >= AGREE
