"""Port parity for the encoder-decoder and VLM families and for GELU / ReLU
experts under the grouped dispatch, on reduced configs in f32 on the CPU
(the kernels on their plain versions), against the JAX package on the same
converted weights:

  * seamless-m4t-medium: the cross attention layer at prefill and decode
    (and its full-precision cross cache under ``kv_bits=8``), ``encode``,
    ``forward`` / ``prefill`` / ``decode_step`` with ``memory``, and
    ``Engine(memory=...)`` greedy tokens (fp and int8 KV caches);
  * internvl2-1b: ``forward`` and ``prefill`` logits with
    ``prefix_embeds``, ``Engine(prefix_embeds=...)`` greedy tokens, and the
    continuous engine serving the text tokens alone, as JAX's does;
  * the weight loader: ``encoder/...`` and ``frontend_proj`` carried leaf
    for leaf from a numpy tree and from a JAX checkpoint;
  * GELU / ReLU grouped experts, fp and int8, against
    ``grouped_mlp_ref`` / ``grouped_mlp_quant_ref`` (also in blocks of
    tiles), and nlg-350m-moe128 under ``moe_impl="grouped"`` through
    ``Engine`` against the JAX engine.

Tolerances (f32 on both sides, summation order differs): layer outputs and
logits within 1e-5 absolute and relative, the encoder memory within 1e-5,
expert outputs within 1e-5; greedy tokens exact.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import make_reduced as jax_make_reduced
from repro.kernels import expert_mlp_grouped as jk
from repro.models import attention as jattn
from repro.models import model as jm
from repro.quant import qarrays as jq
from repro.serving.continuous import ContinuousEngine as JaxContinuous
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import Request as JaxRequest
from repro_torch import convert
from repro_torch.configs.registry import get_config, make_reduced
from repro_torch.core import dispatch_grouped as tdg
from repro_torch.core import gating as tgating
from repro_torch.core import moe as tmoe
from repro_torch.models import attention as tattn
from repro_torch.models import model as tm
from repro_torch.quant import qarrays as tq
from repro_torch.serving.continuous import ContinuousEngine
from repro_torch.serving.engine import Engine, EngineConfig, Request
from _torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

TOL = dict(atol=1e-5, rtol=1e-5)
SEAMLESS, INTERNVL = "seamless-m4t-medium", "internvl2-1b"
PROMPTS = [[5, 9, 2, 7, 1, 3, 8], [11, 4, 6], [2, 2, 9, 14, 3]]
NEW = 6


@functools.lru_cache(maxsize=None)
def load(name, moe_impl=None):
    """(JAX cfg, port cfg, JAX params, port params converted from them)."""
    jcfg = jax_make_reduced(jax_get_config(name))
    tcfg = make_reduced(get_config(name))
    if moe_impl:
        jcfg, tcfg = jcfg.replace(moe_impl=moe_impl), tcfg.replace(moe_impl=moe_impl)
    jparams = jax.jit(lambda k: jm.init_params(jcfg, k))(jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


@functools.lru_cache(maxsize=None)
def inputs(name, B=len(PROMPTS), seed=0):
    """Seeded stub frontend embeddings [B, n, embed_dim]: 11 source frames
    (seamless) or the frontend's n_tokens patches (internvl2)."""
    cfg = make_reduced(get_config(name))
    n = 11 if cfg.encoder is not None else cfg.frontend.n_tokens
    return np.random.default_rng(seed).standard_normal((B, n, cfg.frontend.embed_dim)).astype(
        np.float32)


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def close(a, b, **tol):
    np.testing.assert_allclose(a.numpy() if torch.is_tensor(a) else a, np.asarray(b),
                               **(tol or TOL))


@functools.lru_cache(maxsize=None)
def memories(B=len(PROMPTS)):
    jcfg, tcfg, jparams, tparams = load(SEAMLESS)
    src = inputs(SEAMLESS, B)
    return jm.encode(jcfg, jparams, jnp.asarray(src)), tm.encode(tcfg, tparams, t(src))


# ---------------------------------------------------------------------------
# seamless-m4t-medium: cross attention and the encoder
# ---------------------------------------------------------------------------


def test_cross_kind_is_taken():
    from repro_torch.configs.base import AttnSpec

    tattn.check_spec(AttnSpec(kind="cross", causal=False, use_rope=False))
    with pytest.raises(ValueError, match="memory"):
        cfg = make_reduced(get_config(SEAMLESS))
        p = tattn.init_attention(None, cfg, cfg.layer_specs()[0].cross, torch.float32, "meta")
        tattn.attention(cfg, cfg.layer_specs()[0].cross, p, torch.zeros(1, 2, cfg.d_model),
                        torch.zeros(1, 2), mode="train")


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_cross_attention_layer_matches_jax(kv_bits):
    """One cross layer at prefill (K/V projected from the memory, attended
    without a mask through kernel 6's plain version, the cross cache
    written) and at decode (the cache read): outputs and caches against
    JAX's ``attention``.  Under ``kv_bits=8`` the cross cache stays full
    precision, as in JAX."""
    jcfg, tcfg, jparams, tparams = load(SEAMLESS)
    spec = tcfg.layer_specs()[0].cross
    jp = jax.tree.map(lambda a: a[0], jparams["segments"]["seg0"]["pos0"]["cross"])
    tp = {k: v[0] for k, v in tparams["segments"]["seg0"]["pos0"]["cross"].items()}
    rng = np.random.default_rng(1)
    B, S, T = 2, 5, 9
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((B, T, tcfg.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)[None]
    caches = tm.init_caches(tcfg, B, 16, cross_len=T, kv_bits=kv_bits, device="cpu")
    tc = {k: v[0] for k, v in caches["seg0"]["pos0"]["cross"].items()}
    assert tc["k"].dtype == torch.float32 and tc["k"].shape == (B, T, tcfg.num_kv_heads,
                                                                 tcfg.head_dim)
    jy, jc = jattn.attention(jcfg, spec, jp, jnp.asarray(x), jnp.asarray(pos),
                             memory=jnp.asarray(mem), cache=None, mode="prefill")
    ty, _ = tattn.attention(tcfg, spec, tp, t(x), t(pos), memory=t(mem), cache=tc, mode="prefill")
    close(ty, jy)
    for key in ("k", "v", "pos"):
        close(tc[key], jc[key])
    xd = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    jy, _ = jattn.attention(jcfg, spec, jp, jnp.asarray(xd), jnp.full((B, 1), S, jnp.int32),
                            cache=jc, mode="decode")
    ty, _ = tattn.attention(tcfg, spec, tp, t(xd), torch.full((B, 1), S, dtype=torch.int32),
                            cache=tc, mode="decode", index=S)
    close(ty, jy)


def test_encode_matches_jax():
    jmem, tmem = memories()
    assert tmem.shape == (len(PROMPTS), 11, make_reduced(get_config(SEAMLESS)).d_model)
    close(tmem, jmem)


def test_forward_prefill_decode_with_memory_match_jax():
    """Teacher-forced logits with ``memory``, then a prefill (cross caches
    written) and two decode steps (cross caches read): every logit against
    JAX's."""
    jcfg, tcfg, jparams, tparams = load(SEAMLESS)
    jmem, tmem = memories()
    toks = np.array([p + [0] * (7 - len(p)) for p in PROMPTS], np.int32)
    jl, _ = jm.forward(jcfg, jparams, jnp.asarray(toks), memory=jmem)
    tl, _ = tm.forward(tcfg, tparams, t(toks).long(), memory=tmem)
    close(tl, jl)
    B, S, cap, T = toks.shape[0], toks.shape[1], 12, tmem.shape[1]
    jc = jm.init_caches(jcfg, B, cap, cross_len=T)
    tc = tm.init_caches(tcfg, B, cap, cross_len=T, device="cpu")
    jl, jc = jm.prefill(jcfg, jparams, jnp.asarray(toks), jc, memory=jmem)
    tl, tc = tm.prefill(tcfg, tparams, t(toks).long(), tc, memory=tmem)
    close(tl, jl)
    cur = np.asarray(jl).argmax(-1).astype(np.int32)
    for step in range(2):
        jl, jc = jm.decode_step(jcfg, jparams, jnp.asarray(cur[:, None]),
                                jnp.asarray(S + step, jnp.int32), jc, memory=jmem)
        tl, tc = tm.decode_step(tcfg, tparams, t(cur[:, None]).long(), S + step, tc, memory=tmem)
        close(tl, jl)
        cur = np.asarray(jl).argmax(-1).astype(np.int32)


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_seamless_engine_matches_jax(kv_bits):
    """``Engine(memory=encode(...))`` against the JAX engine with the JAX
    memory: greedy tokens equal."""
    jcfg, tcfg, jparams, tparams = load(SEAMLESS)
    jmem, tmem = memories()
    je = JaxEngine(jcfg, jparams, JaxEngineConfig(max_batch=3, max_prefill=7, max_decode=NEW,
                                                  kv_cache_bits=kv_bits), memory=jmem)
    te = Engine(tcfg, tparams, EngineConfig(max_batch=3, max_prefill=7, max_decode=NEW,
                                            kv_cache_bits=kv_bits), memory=tmem, device="cpu")
    want = [r.tokens for r in je.generate([JaxRequest(p, NEW) for p in PROMPTS])]
    got = [r.tokens for r in te.generate([Request(p, NEW) for p in PROMPTS])]
    assert got == want and all(len(g) == NEW for g in got)


# ---------------------------------------------------------------------------
# internvl2-1b: prefix embeddings
# ---------------------------------------------------------------------------


def test_prefix_embeds_logits_match_jax():
    """``forward`` over [patches ++ tokens] and ``prefill`` with
    ``prefix_embeds``: logits against JAX's (forward's [B, P + S, V])."""
    jcfg, tcfg, jparams, tparams = load(INTERNVL)
    pe = inputs(INTERNVL)
    toks = np.array([p + [0] * (7 - len(p)) for p in PROMPTS], np.int32)
    jl, _ = jm.forward(jcfg, jparams, jnp.asarray(toks), prefix_embeds=jnp.asarray(pe))
    tl, _ = tm.forward(tcfg, tparams, t(toks).long(), prefix_embeds=t(pe))
    assert tl.shape == (3, pe.shape[1] + 7, tcfg.vocab_size)
    close(tl, jl)
    jc = jm.init_caches(jcfg, 3, 32)
    tc = tm.init_caches(tcfg, 3, 32, device="cpu")
    jl, _ = jm.prefill(jcfg, jparams, jnp.asarray(toks), jc, prefix_embeds=jnp.asarray(pe))
    tl, _ = tm.prefill(tcfg, tparams, t(toks).long(), tc, prefix_embeds=t(pe))
    close(tl, jl)


def test_internvl_engine_matches_jax():
    """``Engine(prefix_embeds=...)``: capacity grown by the frontend's
    n_tokens, decode index S + n_tokens + t; greedy tokens equal JAX's."""
    jcfg, tcfg, jparams, tparams = load(INTERNVL)
    pe = inputs(INTERNVL)
    ec = dict(max_batch=3, max_prefill=7, max_decode=NEW)
    je = JaxEngine(jcfg, jparams, JaxEngineConfig(**ec), prefix_embeds=jnp.asarray(pe))
    te = Engine(tcfg, tparams, EngineConfig(**ec), prefix_embeds=t(pe), device="cpu")
    assert te._capacity == 7 + NEW + tcfg.frontend.n_tokens
    want = [r.tokens for r in je.generate([JaxRequest(p, NEW) for p in PROMPTS])]
    got = [r.tokens for r in te.generate([Request(p, NEW) for p in PROMPTS])]
    assert got == want


@pytest.mark.parametrize("paged", [True, False])
def test_internvl_continuous_serves_text_tokens_as_jax(paged):
    """The continuous engines take no patch embeddings: a vlm config serves
    its text tokens, with JAX's tokens."""
    jcfg, tcfg, jparams, tparams = load(INTERNVL)
    kw = dict(slots=2, capacity=32, **(dict(paged=True, page_size=4) if paged else {}))
    je = JaxContinuous(jcfg, jparams, **kw)
    te = ContinuousEngine(tcfg, tparams, device="cpu", **kw)
    out = []
    for eng, req in ((je, JaxRequest), (te, Request)):
        ids = [eng.submit(req(prompt=p, max_new_tokens=NEW)) for p in PROMPTS]
        done = eng.run_until_done()
        out.append([done[i].tokens for i in ids])
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# The weight loader
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", [SEAMLESS, INTERNVL])
def test_encoder_and_frontend_leaves_convert(name, tmp_path):
    """Every leaf of the converted tree equals the JAX tree's, the
    ``encoder/...`` and ``frontend_proj`` leaves among them, from numpy and
    from a checkpoint the JAX package saved."""
    _, tcfg, jparams, tparams = load(name)
    ckpt.save(str(tmp_path), jparams)
    loaded = convert.load_checkpoint(str(tmp_path), tcfg, "cpu")
    flat = dict(convert._flatten(tparams))
    names = [k for k in flat if k.startswith(("encoder/", "frontend_proj"))]
    assert "frontend_proj" in names
    assert (tcfg.encoder is not None) == any(k.startswith("encoder/segments/") for k in names)
    jflat = {"/".join(str(p.key) for p in path): v
             for path, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert set(flat) == set(jflat)
    lflat = dict(convert._flatten(loaded))
    for k, v in flat.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jflat[k]))
        assert torch.equal(lflat[k], v)


# ---------------------------------------------------------------------------
# GELU / ReLU experts under the grouped dispatch
# ---------------------------------------------------------------------------


def grouped_inputs(T=13, K=2, E=5, D=16, F=24, seed=3):
    rng = np.random.default_rng(seed)
    logits = torch.from_numpy(rng.standard_normal((T, E)).astype(np.float32))
    lay = tdg.grouped_layout(tgating.top_k_gating(logits, K, T * K), E)
    Ct = lay.tile_expert.shape[0] * tdg.GROUPED_TILE
    xg = np.zeros((Ct, D), np.float32)
    xg[lay.dst.numpy()] = rng.standard_normal((T * K, D)).astype(np.float32)
    w = {"wi": (rng.standard_normal((E, D, F)) / 4).astype(np.float32),
         "wo": (rng.standard_normal((E, F, D)) / 5).astype(np.float32)}
    return xg, lay, w


@pytest.mark.parametrize("act", ["gelu", "relu"])
@pytest.mark.parametrize("bits", [0, 8])
@pytest.mark.parametrize("block_bytes", [None, 1], ids=["one_block", "tile_blocks"])
@pytest.mark.parametrize("T,K", [(13, 2), (3, 1)])
def test_grouped_act_experts_match_jax_ref(act, bits, block_bytes, T, K, monkeypatch):
    """``grouped_experts_ffn`` for GELU / ReLU experts against JAX's
    ``grouped_mlp_ref`` (fp) / ``grouped_mlp_quant_ref`` (int8, the same
    quantized values) within 1e-5, every tile of JAX's against the port's
    live prefix of at most T*K tiles (3 of 4 at T*K = 3); with
    ``GATHER_BYTES`` at 1 every tile is its own block, with the same
    result."""
    if block_bytes is not None:
        monkeypatch.setattr(tmoe, "GATHER_BYTES", block_bytes)
    xg, lay, w = grouped_inputs(T, K)
    te = jnp.asarray(lay.tile_expert.numpy())
    if bits:
        jw = {n: jq.QuantizedArray.quantize(jnp.asarray(v), bits=bits) for n, v in w.items()}
        tw = {n: tq.QuantizedArray.quantize(t(v), bits=bits) for n, v in w.items()}
        for n in w:
            np.testing.assert_array_equal(tw[n].q.numpy(), np.asarray(jw[n].q))
        ref = jk.grouped_mlp_quant_ref(jnp.asarray(xg), te, jw["wi"], None, jw["wo"], act)
    else:
        tw = {n: t(v) for n, v in w.items()}
        ref = jk.grouped_mlp_ref(jnp.asarray(xg), te, jnp.asarray(w["wi"]), None,
                                 jnp.asarray(w["wo"]), act)
    out = tmoe.grouped_experts_ffn(tw, t(xg), lay.tile_expert, lay.rows_used, act, T * K)
    close(out, ref)
    dead = np.arange(out.shape[0]) >= int(lay.rows_used)
    assert (out.numpy()[dead] == 0).all()


def test_nlg_grouped_engine_matches_jax():
    """The paper's nlg-350m-moe128 (GELU experts) under
    ``moe_impl="grouped"``: the static engine's greedy tokens equal the JAX
    grouped engine's, and the gating kernel is never called."""
    jcfg, tcfg, jparams, tparams = load("nlg-350m-moe128", "grouped")
    ec = dict(max_batch=3, max_prefill=7, max_decode=NEW)
    je = JaxEngine(jcfg, jparams, JaxEngineConfig(**ec))
    te = Engine(tcfg, tparams, EngineConfig(**ec), device="cpu")
    want = [r.tokens for r in je.generate([JaxRequest(p, NEW) for p in PROMPTS])]
    calls = []
    gating = tmoe.gating
    tmoe.gating = lambda *a, **k: calls.append(1) or gating(*a, **k)
    try:
        got = [r.tokens for r in te.generate([Request(p, NEW) for p in PROMPTS])]
    finally:
        tmoe.gating = gating
    assert got == want and not calls
