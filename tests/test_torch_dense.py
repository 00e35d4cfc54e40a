"""The dense-attention family of the port (qwen1.5, qwen2.5,
command-r-plus and gemma3, smoke size) against the JAX package on
identical weights: the configs field for field, attention with QKV bias
and QK norm, gemma3's sandwich-norm layers and the untied head one module
at a time, then the whole models.  Parameters come from the reference's
``init``; the leaves it sets to constants (norm scales, QKV biases) get
seeded noise first, so that every one of them changes the result.  Every
input is made from a numpy seed.  The JAX side runs on the CPU (its
einsum attention, or its Pallas kernel in interpret mode where a test
says so), the port on the CPU (the kernels' plain versions).

Tolerances: fp32 models agree to 1e-4 (the structure checks); bf16
logits within ``LOGSOFTMAX_TOL`` with greedy agreement ``AGREE``; the
port's bf16 decode-vs-forward gap within ``DECODE_GAP_MARGIN`` of the
reference's own gap once its forward runs its TPU kernel (the port's
prefill goes through the kernel, which casts the unnormalised
probabilities to bf16 before P.V, where the einsum decode casts the
normalised ones); with einsum attention in the port's forward the gap is
held under the reference's own dense-arch bound of 5e-2
(``tests/test_decode.py``)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, SHAPES, cells, get_config, nom_paper
from repro_torch.models import CausalLM, params_from_reference
from repro_torch.models import attention as port_attention
from repro_torch.models.attention import Attention, AttentionConfig
from repro_torch.models.blocks import DecoderLayer
from repro_torch.models.convert import _flat, reference_items
from repro_torch.serving import Engine
from repro_torch.train import make_prefill_step, make_serve_step

from test_torch_models import (AGREE, DECODE_GAP_MARGIN, LOGSOFTMAX_TOL,
                               _logsoftmax_gap)

DENSE = ("qwen1.5-4b", "qwen2.5-32b", "command-r-plus-104b", "gemma3-27b")
DENSE_DECODE_TOL = 5e-2     # tests/test_decode.py, dense archs
NOISE = 0.1                 # std of the noise on norm scales and biases
# Module outputs in bf16 are held to two bf16 ulps of the largest |y|
# (one ulp is at most 2^-7 of the value): the two packages round the same
# products at different places.
ULPS = 2 * 2.0 ** -7


def _np(x):
    return np.asarray(x, np.float32)


def _t(x, dtype=torch.bfloat16):
    return torch.tensor(np.asarray(x, np.float32)).to(dtype)


def _x(shape, seed, scale=1.0):
    return np.random.default_rng(seed).standard_normal(shape) * scale


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s))


def _perturb(tree, seed):
    """The tree as numpy arrays, with seeded noise on every norm scale
    and QKV bias (the reference initialises them to ones or zeros)."""
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for key, val in node.items():
            if isinstance(val, dict):
                out[key] = walk(val)
            else:
                val = np.asarray(val, np.float32)
                if key in ("scale", "bq", "bk", "bv"):
                    val = val + NOISE * rng.standard_normal(val.shape
                                                            ).astype(np.float32)
                out[key] = val
        return out
    return walk(tree)


@pytest.fixture(scope="module")
def jax_mods():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    return jax, jnp


@pytest.fixture(scope="module", params=DENSE)
def dense(request, jax_mods):
    """(reference config, model and perturbed params; the port's config
    and model on the same weights) for one dense smoke arch."""
    jax, jnp = jax_mods
    from repro.configs import get_config as jget
    from repro.models import make_model as jmake
    jcfg = jget(request.param, smoke=True)
    jmodel = jmake(jcfg)
    tree = _perturb(jmodel.init(jax.random.PRNGKey(0)), 1)
    cfg = get_config(request.param, smoke=True)
    model = CausalLM(cfg, "cpu")
    model.load_state_dict(params_from_reference(tree, cfg))
    return jcfg, jmodel, jax.tree.map(jnp.asarray, tree), cfg, model


# --- configs -------------------------------------------------------------------
@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_config_mirrors_reference(jax_mods, arch, smoke):
    from repro.configs import get_config as jget
    want, got = jget(arch, smoke=smoke), get_config(arch, smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count_estimate() == want.param_count_estimate()
    assert (got.active_param_count_estimate()
            == want.active_param_count_estimate())
    assert got.padded_vocab == want.padded_vocab


def test_registry_shapes_cells_and_paper_system(jax_mods):
    import repro.configs as jconfigs
    from repro.configs.nom_paper import PAPER_SYSTEM
    assert list(ARCHS) == list(jconfigs.ARCHS) and len(ARCHS) == 10
    assert SHAPES == jconfigs.SHAPES
    for skipped in (False, True):
        assert cells(skipped) == jconfigs.cells(skipped)
    assert (dataclasses.asdict(nom_paper.PAPER_SYSTEM)
            == dataclasses.asdict(PAPER_SYSTEM))
    assert nom_paper.NomSystemConfig() == nom_paper.PAPER_SYSTEM


@pytest.mark.parametrize("arch", DENSE)
def test_full_width_parameters_match_reference(jax_mods, arch):
    """At full width and depth every reference parameter (lm_head, QKV
    biases, QK norms and sandwich norms included) maps onto a port
    parameter of the same shape, none left over; shapes only."""
    jax = jax_mods[0]
    from repro.configs import get_config as jget
    from repro.models import make_model as jmake
    shapes = jax.eval_shape(jmake(jget(arch)).init, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                        shapes)
    cfg = get_config(arch)
    want = {k: tuple(v.shape) for k, v in reference_items(tree, cfg)}
    got = {k: tuple(v.shape) for k, v in
           CausalLM(cfg, "meta").state_dict().items()}
    assert got == want
    assert ("lm_head.kernel" in got) == (not cfg.tie_embeddings)
    names = {k.split(".")[-1] for k in got} | {k.split(".")[-2] for k in got}
    assert ("bq" in names) == cfg.qkv_bias
    assert ("q_norm" in names) == cfg.qk_norm
    assert ("ln2_post" in names) == cfg.post_norms


# --- modules -------------------------------------------------------------------
def jax_tree_index(tree, g):
    """Group g of a stacked param tree, as numpy."""
    return {k: (jax_tree_index(v, g) if isinstance(v, dict)
                else np.asarray(v)[g]) for k, v in tree.items()}


def _load(module, tree):
    module.load_state_dict({k: torch.tensor(v) for k, v in _flat(tree)})
    return module


def test_attention_bias_qk_norm_prefill_and_ring_decode(jax_mods, dense):
    """Layer 0's attention (QKV bias for the qwens, QK norm and window 16
    for gemma3) over S=40 (past gemma3's window), prefill through the
    flash kernel's plain version and 40 decode steps, against the
    reference's modules."""
    jnp = jax_mods[1]
    from repro.models.attention import Attention as JAttn, \
        AttentionConfig as JCfg
    from repro.models.blocks import make_mixer
    jcfg, cfg = dense[0], dense[3]
    kind = cfg.pattern[0]
    jmod = make_mixer(jcfg, jcfg.pattern[0])
    assert isinstance(jmod, JAttn) and isinstance(jmod.cfg, JCfg)
    p = jax_tree_index(dense[2]["stack"]["groups"]["l0"], 0)["mixer"]
    kw = {f.name: getattr(jmod.cfg, f.name)
          for f in dataclasses.fields(AttentionConfig)}
    mod = _load(Attention(AttentionConfig(**kw), "cpu"), p)
    assert (mod.cfg.window, mod.cfg.qkv_bias, mod.cfg.qk_norm) == (
        kind.window, cfg.qkv_bias, cfg.qk_norm)
    jp = {k: (jnp.asarray(v) if not isinstance(v, dict) else
              {kk: jnp.asarray(vv) for kk, vv in v.items()})
          for k, v in p.items()}
    s = 40
    x = _x((2, s, cfg.d_model), 9)
    want = jmod.apply(jp, jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        got = mod(_t(x))
    want = _np(want.astype(jnp.float32))
    tol = ULPS * np.abs(want).max()
    err = np.abs(got.float().numpy() - want).max()
    assert err < tol, (err, tol)
    cache, jcache = mod.init_cache(2, s), jmod.init_cache(2, s)
    assert tuple(cache["k"].shape) == tuple(jcache["k"].shape)
    outs, jouts = [], []
    with torch.no_grad():
        for i in range(s):
            y, cache = mod.decode(_t(x[:, i:i + 1]), cache, i)
            jy, jcache = jmod.decode(jp, jnp.asarray(x[:, i:i + 1],
                                                     jnp.bfloat16),
                                     jcache, jnp.int32(i))
            outs.append(y.float().numpy())
            jouts.append(_np(jy.astype(jnp.float32)))
    dec = np.concatenate(outs, 1)
    assert np.abs(dec - np.concatenate(jouts, 1)).max() < tol
    assert np.abs(dec - got.float().numpy()).max() < tol


@pytest.mark.parametrize("i", [0, 2])
def test_sandwich_norm_layer(jax_mods, i):
    """gemma3-smoke's layer i (0: local, window 16; 2: global) with its
    zero-centered sandwich norms, forward and decode, against the
    reference's DecoderLayer on the same (perturbed) weights."""
    jax, jnp = jax_mods
    from repro.configs import get_config as jget
    from repro.models.blocks import DecoderLayer as JLayer
    from repro.models.blocks import LayerStack as JStack
    jcfg, cfg = jget("gemma3-27b", smoke=True), get_config("gemma3-27b",
                                                           smoke=True)
    tree = _perturb(JStack(jcfg, jcfg.n_layers).init(jax.random.PRNGKey(2)),
                    3)
    p = jax_tree_index(tree["groups"][f"l{i}"], 0)
    jlayer = JLayer(jcfg, jcfg.pattern[i])
    layer = _load(DecoderLayer(cfg, cfg.pattern[i], "cpu"), p)
    assert layer.ln1_post.zero_centered and layer.ln2_post.zero_centered
    assert not layer.mixer.q_norm.zero_centered
    jp = jax.tree.map(jnp.asarray, p)
    s = 24
    x = _x((2, s, cfg.d_model), 10, 3.0)
    want, _ = jlayer.apply(jp, jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        got = layer(_t(x))
    scale = float(np.abs(x).max())
    err = np.abs(got.float().numpy() - _np(want.astype(jnp.float32))).max()
    assert err < 2e-2 * scale, err
    cache, jcache = layer.init_cache(2, s, torch.bfloat16), \
        jlayer.init_cache(2, s)
    outs, jouts = [], []
    with torch.no_grad():
        for t in range(s):
            y, cache = layer.decode(_t(x[:, t:t + 1]), cache, t)
            jy, jcache = jlayer.decode(jp, jnp.asarray(x[:, t:t + 1],
                                                       jnp.bfloat16),
                                       jcache, jnp.int32(t))
            outs.append(y.float().numpy())
            jouts.append(_np(jy.astype(jnp.float32)))
    dec = np.concatenate(outs, 1)
    assert np.abs(dec - np.concatenate(jouts, 1)).max() < 2e-2 * scale
    assert np.abs(dec - got.float().numpy()).max() < 2e-2 * scale


def test_untied_head(jax_mods):
    """qwen1.5-smoke's untied head: fp32 logits of the final hidden
    state through ``lm_head.kernel``, equal to the reference's
    ``_logits`` (both fp32 products of the same inputs)."""
    jax, jnp = jax_mods
    from repro.configs import get_config as jget
    from repro.models import make_model as jmake
    jcfg, cfg = jget("qwen1.5-4b", smoke=True), get_config("qwen1.5-4b",
                                                           smoke=True)
    jmodel = jmake(jcfg)
    tree = _perturb(jmodel.init(jax.random.PRNGKey(4)), 5)
    model = CausalLM(cfg, "cpu")
    model.load_state_dict(params_from_reference(tree, cfg))
    assert model.lm_head is not None
    assert tuple(model.lm_head.kernel.shape) == (cfg.d_model,
                                                 cfg.padded_vocab)
    x = _x((2, 7, cfg.d_model), 11)
    want = jmodel._logits(jax.tree.map(jnp.asarray, tree),
                          jnp.asarray(x, jnp.bfloat16))
    got = model.logits(_t(x))
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - _np(want)).max() < 1e-4
    # not the tied product
    tied = model.embed.attend(_t(x))
    assert np.abs(tied.numpy() - _np(want)).max() > 1.0


# --- whole models ----------------------------------------------------------------
def test_dense_fp32_structure(jax_mods, dense, monkeypatch):
    """In fp32 the port's logits equal the reference's to 1e-4, and its
    decode steps (through the ring buffers) reproduce its forward to
    1e-4."""
    import repro.models.common as jcommon
    jnp = jax_mods[1]
    _jcfg, jmodel, params, cfg, model = dense
    monkeypatch.setattr(jcommon, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(model, "compute_dtype", torch.float32)
    toks = _tokens(cfg, 2, 40, 12)
    want, _ = jmodel.apply(params, jnp.asarray(toks, jnp.int32), remat=False)
    got = make_prefill_step(model, cfg)(torch.as_tensor(toks))
    assert np.abs(got.numpy() - _np(want)).max() < 1e-4
    step, caches = make_serve_step(model, cfg), model.init_caches(2, 40)
    assert caches[0]["k"].dtype == torch.float32
    outs = []
    for i in range(40):
        lg, caches = step(torch.as_tensor(toks[:, i:i + 1]), caches, i)
        outs.append(lg)
    assert (torch.cat(outs, 1) - got).abs().max().item() < 1e-4


def test_dense_bf16_logits(jax_mods, dense):
    jnp = jax_mods[1]
    _jcfg, jmodel, params, cfg, model = dense
    toks = _tokens(cfg, 2, 40, 13)
    want, _ = jmodel.apply(params, jnp.asarray(toks, jnp.int32), remat=False)
    got = make_prefill_step(model, cfg)(torch.as_tensor(toks))
    assert got.shape == (2, 40, cfg.padded_vocab)
    gap, agree = _logsoftmax_gap(want, got)
    assert gap < LOGSOFTMAX_TOL and agree >= AGREE, (gap, agree)


def _decode(model, cfg, toks):
    step, caches = make_serve_step(model, cfg), model.init_caches(*toks.shape)
    outs = []
    for i in range(toks.shape[1]):
        lg, caches = step(torch.as_tensor(toks[:, i:i + 1]), caches, i)
        outs.append(lg)
    return torch.cat(outs, 1)


def einsum_attention(q, k, v, *, causal, window, scale):
    """The reference's dense prefill arithmetic (and the port's decode's):
    fp32 logits, normalised probabilities cast to v's type, then P.V;
    q already scaled."""
    assert causal and scale == 1.0
    b, s, hq, d = q.shape
    qg = q.reshape(b, s, k.shape[2], hq // k.shape[2], d)
    logits = torch.einsum("bskgh,btkh->bkgst", qg, k).float()
    i = torch.arange(s)
    ok = i[None, :] <= i[:, None]
    if window is not None:
        ok &= i[:, None] - i[None, :] < window
    probs = torch.softmax(logits.masked_fill(~ok, float("-inf")), -1)
    out = torch.einsum("bkgst,btkh->bskgh", probs.to(v.dtype), v)
    return out.reshape(b, s, hq, d)


def test_dense_decode_gap_is_rounding(jax_mods, dense, monkeypatch):
    """The port's bf16 decode-vs-forward gap lies within
    DECODE_GAP_MARGIN of the reference's own gap with its TPU kernel (the
    Pallas kernel in interpret mode in place of its einsum attention);
    with einsum attention in the port's forward the gap is the reference's
    dense bound's business (< 5e-2), so the rest is the kernel's rounding.
    24 tokens (past gemma3-smoke's window of 16); the numbers print with
    ``pytest -s``."""
    jnp = jax_mods[1]
    import repro.models.attention as jattention
    from repro.kernels.flash_attention.flash_attention import (
        flash_attention_fwd)
    _jcfg, jmodel, params, cfg, model = dense
    b, s = 2, 24
    toks = _tokens(cfg, b, s, 14)
    jtoks = jnp.asarray(toks, jnp.int32)
    jcaches, jouts = jmodel.init_caches(b, s), []
    for i in range(s):
        lg, jcaches = jmodel.decode_step(params, jtoks[:, i:i + 1], jcaches,
                                         jnp.int32(i))
        jouts.append(_np(lg))
    jdec = np.concatenate(jouts, 1)
    jfwd, _ = jmodel.apply(params, jtoks, remat=False)
    ref_einsum = _logsoftmax_gap(jdec, jfwd)
    calls = []

    def attend_kernel(self, q, k, v, mask):
        del mask                   # causal + window, from the kernel's iota
        calls.append(q.shape)
        pad = (-q.shape[1]) % 128  # the kernel's default blocks
        t = [jnp.pad(x, ((0, 0), (0, pad), (0, 0), (0, 0))).transpose(
            0, 2, 1, 3) for x in (q, k, v)]
        o = flash_attention_fwd(*t, causal=True, window=self.cfg.window,
                                scale=1.0, interpret=True)
        return o.transpose(0, 2, 1, 3)[:, :q.shape[1]]
    monkeypatch.setattr(jattention.Attention, "_attend_dense", attend_kernel)
    jfwd_kernel, _ = jmodel.apply(params, jtoks, remat=False)
    assert calls
    ref_kernel = _logsoftmax_gap(jdec, jfwd_kernel)
    dec = _decode(model, cfg, toks)
    port = _logsoftmax_gap(dec, make_prefill_step(model, cfg)(
        torch.as_tensor(toks)))
    monkeypatch.setattr(port_attention, "flash_attention", einsum_attention)
    port_einsum = _logsoftmax_gap(dec, make_prefill_step(model, cfg)(
        torch.as_tensor(toks)))
    print(f"{cfg.name}: max |d log-softmax| (greedy agreement), decode vs "
          f"forward, bf16: port {port[0]:.3g} ({port[1]:.3g}), port with "
          f"einsum attention {port_einsum[0]:.3g} ({port_einsum[1]:.3g}); "
          f"reference with its TPU kernel {ref_kernel[0]:.3g} "
          f"({ref_kernel[1]:.3g}), with its einsum attention "
          f"{ref_einsum[0]:.3g} ({ref_einsum[1]:.3g})")
    assert abs(port[0] - ref_kernel[0]) <= DECODE_GAP_MARGIN(ref_kernel[0])
    assert port_einsum[0] < DENSE_DECODE_TOL
    assert ref_einsum[0] < DENSE_DECODE_TOL
    assert min(port[1], ref_kernel[1], port_einsum[1]) >= AGREE


# --- serving -----------------------------------------------------------------------
def test_engine_generate_matches_reference(jax_mods, dense):
    """Greedy generation keeps the prompt, launches nothing on the CPU,
    and agrees with the reference engine's tokens."""
    jnp = jax_mods[1]
    jcfg, jmodel, params, cfg, model = dense
    prompt = _tokens(cfg, 3, 5, 15)
    out = Engine(model, cfg, max_len=64, track_transfers=False).generate(
        torch.as_tensor(prompt), 8)
    assert out.shape == (3, 13)
    assert torch.equal(out[:, :5], torch.as_tensor(prompt))
    from repro.serving import Engine as JEngine
    want = JEngine(jmodel, jcfg, max_len=64, track_transfers=False).generate(
        params, jnp.asarray(prompt, jnp.int32), 8)
    agree = float((out.numpy() == np.asarray(want)).mean())
    assert agree >= AGREE, agree


def test_make_model_builds_the_dense_family():
    """``make_model`` builds each dense smoke config from a seed (biases
    zero, the untied head within +-2 sigma of its fan-in init); the full
    configs build on the meta device (shapes only)."""
    from repro_torch.models import make_model
    for arch in DENSE:
        cfg = get_config(arch, smoke=True)
        a, b = (make_model(cfg, device="cpu", seed=3) for _ in range(2))
        for (name, x), y in zip(a.state_dict().items(),
                                b.state_dict().values()):
            assert torch.equal(x, y), name
        if cfg.qkv_bias:
            assert a.stack.layers[0].mixer.bq.abs().max().item() == 0.0
        if not cfg.tie_embeddings:
            bound = 2.0 / cfg.d_model ** 0.5
            assert a.lm_head.kernel.abs().max().item() <= bound
        full = CausalLM(get_config(arch), "meta")
        assert full.cfg.n_layers == len(full.stack.layers)


def test_serve_launcher_lists_every_arch():
    """``--arch`` takes the ten archs; a dense one serves, one not
    ported yet raises ``check_supported``'s NotImplementedError."""
    from repro_torch.launch.serve import main
    out = main(["--arch", "gemma3-27b", "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "3", "--new-tokens", "2"])
    assert out.shape == (2, 5)
    for arch in ("whisper-small", "paligemma-3b", "qwen3-moe-235b-a22b",
                 "phi3.5-moe-42b-a6.6b"):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            main(["--arch", arch, "--smoke", "--device", "cpu"])
    with pytest.raises(SystemExit):
        main(["--arch", "no-such-arch", "--smoke", "--device", "cpu"])
