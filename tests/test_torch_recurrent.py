"""Port parity for the recurrent mixers: Mamba-2 SSD (``models/ssm.py``) and
RG-LRU (``models/rglru.py``) against the JAX package's, and the cases of
``tests/test_ssm_rglru.py`` and ``tests/test_arch_smoke.py`` for mamba2-370m,
recurrentgemma-2b and gemma3-27b, on the CPU in f32.

Inputs are drawn with numpy from fixed seeds and handed to both packages;
the JAX side is jitted.  Tolerances: the SSD against the sequential oracle
and against JAX 1e-4 (absolute and relative, as ``test_ssm_rglru.py``); the
LRU scan 1e-5; the layers' outputs 1e-4 against JAX; whole-model logits
2e-4 against JAX.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.base import LRUSpec as JLRUSpec
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import SSMSpec as JSSMSpec
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import make_reduced as jax_make_reduced
from repro.models import model as jm
from repro.models import rglru as jlru
from repro.models import ssm as jssm
from repro_torch import convert
from repro_torch.configs.base import LRUSpec, ModelConfig, SSMSpec, count_params
from repro_torch.configs.registry import get_config, make_reduced
from repro_torch.models import model as tm
from repro_torch.models import rglru as tlru
from repro_torch.models import ssm as tssm
from _torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

ARCHS = ["mamba2-370m", "recurrentgemma-2b", "gemma3-27b"]
TOL = dict(atol=1e-4, rtol=1e-4)


def _cfgs(d=64):
    kw = dict(name="t", family="ssm", source="x", d_model=d, num_heads=4, num_kv_heads=4,
              head_dim=16, vocab_size=64, segments=(), param_dtype="float32",
              compute_dtype="float32")
    return JModelConfig(**kw), ModelConfig(**kw)


def _ssd_inputs(B=2, L=64, H=4, P=8, G=1, N=16, seed=0):
    """numpy f32 inputs of ``ssd_chunked``: x, dt (after softplus), A < 0, B, C."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)) - 1.0)).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    Bm = (rng.standard_normal((B, L, G, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, L, G, N)) * 0.5).astype(np.float32)
    return x, dt, A, Bm, Cm


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(tol or TOL))


# ---------------------------------------------------------------------------
# SSD (the cases of test_ssm_rglru.py::TestSSD, and the JAX function)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_ssd_chunked_matches_sequential_and_jax(chunk):
    args = _ssd_inputs()
    y1, s1 = tssm.ssd_chunked(*_t(*args), chunk)
    y2, s2 = tssm.ssd_reference(*_t(*args))
    _close(y1, y2)
    _close(s1, s2)
    jy, js = jax.jit(jssm.ssd_chunked, static_argnums=5)(*args, chunk)
    _close(y1, jy)
    _close(s1, js)


def test_ssd_nondivisible_length_pads():
    args = _ssd_inputs(L=50)
    y1, s1 = tssm.ssd_chunked(*_t(*args), 16)
    y2, s2 = tssm.ssd_reference(*_t(*args))
    _close(y1, y2)
    _close(s1, s2)


def test_ssd_initial_state_carried():
    x, dt, A, Bm, Cm = _t(*_ssd_inputs(L=32))
    y_full, s_full = tssm.ssd_reference(x, dt, A, Bm, Cm)
    y1, s1 = tssm.ssd_chunked(x[:, :16], dt[:, :16], A, Bm[:, :16], Cm[:, :16], 8)
    y2, s2 = tssm.ssd_chunked(x[:, 16:], dt[:, 16:], A, Bm[:, 16:], Cm[:, 16:], 8, init_state=s1)
    _close(torch.cat([y1, y2], 1), y_full)
    _close(s2, s_full)


def test_ssd_grouped_heads():
    args = _ssd_inputs(H=8, G=2)
    y1, _ = tssm.ssd_chunked(*_t(*args), 16)
    y2, _ = tssm.ssd_reference(*_t(*args))
    _close(y1, y2)
    jy, _ = jax.jit(jssm.ssd_reference)(*args)
    _close(y2, jy)


@pytest.mark.parametrize("L,chunk,seed", [(4, 4, 0), (17, 8, 3), (33, 16, 11), (48, 4, 29)])
def test_ssd_chunk_invariance(L, chunk, seed):
    """``test_property_chunk_invariance`` at fixed draws."""
    args = _ssd_inputs(L=L, seed=seed)
    y1, _ = tssm.ssd_chunked(*_t(*args), chunk)
    y2, _ = tssm.ssd_reference(*_t(*args))
    _close(y1, y2, atol=2e-4, rtol=2e-3)


@pytest.mark.parametrize("valid", [None, [5, 0, 9]])
def test_causal_conv_matches_jax(valid):
    """The depthwise conv and its prefix, with per-row valid lengths (a
    batched chunk; 0: the incoming prefix comes back)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 9, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    prefix = rng.standard_normal((3, 3, 6)).astype(np.float32)
    vl = None if valid is None else np.asarray(valid, np.int32)
    out, pre = tssm._causal_conv(*_t(x, w, prefix), None if vl is None else torch.from_numpy(vl))
    jout, jpre = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(prefix),
                                   None if vl is None else jnp.asarray(vl))
    _close(out, jout, atol=1e-6)
    np.testing.assert_array_equal(pre.numpy(), np.asarray(jpre))
    if valid is not None:
        np.testing.assert_array_equal(pre[1].numpy(), prefix[1])


def _ssm_pair(d=64, seed=0):
    jcfg, tcfg = _cfgs(d)
    kw = dict(d_inner=2 * d, head_dim=16, state_dim=16, conv_dim=4, chunk=8)
    jspec, tspec = JSSMSpec(**kw), SSMSpec(**kw)
    jp = jssm.init_ssm(jax.random.PRNGKey(seed), jcfg, jspec, jnp.float32)
    # the norm scale and dt bias drawn too, so they are exercised
    rng = np.random.default_rng(seed)
    jp = dict(jp, norm_scale=jnp.asarray(rng.standard_normal(2 * d) * 0.1, jnp.float32),
              dt_bias=jnp.asarray(rng.standard_normal(jspec.num_heads) * 0.3, jnp.float32))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jcfg, tcfg, jspec, tspec, jp, tp


def _lru_pair(d=32, seed=0):
    jcfg, tcfg = _cfgs(d)
    kw = dict(lru_width=d, conv_dim=4, num_heads=2)
    jspec, tspec = JLRUSpec(**kw), LRUSpec(**kw)
    jp = jlru.init_lru(jax.random.PRNGKey(seed), jcfg, jspec, jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jcfg, tcfg, jspec, tspec, jp, tp


def test_ssm_layer_prefill_then_decode_equals_full_and_jax():
    jcfg, tcfg, jspec, tspec, jp, tp = _ssm_pair()
    x = (np.random.default_rng(1).standard_normal((2, 20, 64)) * 0.5).astype(np.float32)
    tx = torch.from_numpy(x)
    y_full, _ = tssm.ssm_layer(tcfg, tspec, tp, tx, mode="train")
    jy, _ = jax.jit(lambda p, x: jssm.ssm_layer(jcfg, jspec, p, x, mode="train"))(jp, x)
    _close(y_full, jy)
    cache = tssm.init_ssm_cache(2, tspec, torch.float32, "cpu")
    y1, cache = tssm.ssm_layer(tcfg, tspec, tp, tx[:, :16], cache=cache, mode="prefill")
    _close(y1, y_full[:, :16], atol=1e-3)
    jlayer = jax.jit(lambda p, x, c, mode: jssm.ssm_layer(jcfg, jspec, p, x, cache=c, mode=mode),
                     static_argnums=3)
    _, jc = jlayer(jp, x[:, :16], jssm.init_ssm_cache(2, jspec, jnp.float32), "prefill")
    for t in range(16, 20):
        yt, cache = tssm.ssm_layer(tcfg, tspec, tp, tx[:, t : t + 1], cache=cache, mode="decode")
        _close(yt[:, 0], y_full[:, t], atol=1e-3)
        jyt, jc = jlayer(jp, x[:, t : t + 1], jc, "decode")
        _close(yt, jyt)
    for name in ("state", "conv"):
        _close(cache[name], jc[name])
    assert cache["pos"].tolist() == np.asarray(jc["pos"]).tolist()


@pytest.mark.parametrize("mixer", ["ssm", "lru"])
def test_batched_chunk_padding_is_inert(mixer):
    """``prefill_chunk_batched``: rows of 6, 3 and 0 valid tokens then
    padding (positions -1) resume from per-row states; outputs at valid
    positions and the new states match JAX's (dt = 0 / a = 1, b = 0 on
    padding, the conv prefix at each row's last valid input), and a row of
    no valid token keeps its state."""
    if mixer == "ssm":
        jcfg, tcfg, jspec, tspec, jp, tp = _ssm_pair()
        jlayer, tlayer, init = jssm.ssm_layer, tssm.ssm_layer, tssm.init_ssm_cache
    else:
        jcfg, tcfg, jspec, tspec, jp, tp = _lru_pair()
        jlayer, tlayer, init = jlru.lru_layer, tlru.lru_layer, tlru.init_lru_cache
    rng = np.random.default_rng(4)
    d = tcfg.d_model
    cache = init(3, tspec, torch.float32, "cpu")
    for name in ("state", "conv"):
        cache[name].copy_(torch.from_numpy(rng.standard_normal(cache[name].shape).astype(np.float32)))
    jc = {k: jnp.asarray(v.numpy().copy()) for k, v in cache.items()}  # no alias of the port's
    x = rng.standard_normal((3, 6, d)).astype(np.float32) * 0.5
    pos = np.full((3, 6), -1, np.int32)
    pos[0] = np.arange(10, 16)
    pos[1, :3] = np.arange(4, 7)
    before = cache["state"][2].clone()
    y, cache = tlayer(tcfg, tspec, tp, torch.from_numpy(x), cache=cache, mode="prefill_chunk_batched",
                      positions=torch.from_numpy(pos))
    jy, jc = jax.jit(lambda p, x, c, pos: jlayer(jcfg, jspec, p, x, cache=c, mode="prefill_chunk_batched",
                                                 positions=pos))(jp, x, jc, pos)
    valid = pos >= 0
    _close(y.numpy()[valid], np.asarray(jy)[valid])
    for name in ("state", "conv"):
        _close(cache[name], jc[name])
    assert torch.equal(cache["state"][2], before)


# ---------------------------------------------------------------------------
# RG-LRU (the cases of test_ssm_rglru.py::TestLRU, and the JAX function)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("L", [1, 32, 37])
def test_lru_scan_matches_loop_and_jax(L):
    rng = np.random.default_rng(L)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((2, L, 16))))).astype(np.float32)
    b = rng.standard_normal((2, L, 16)).astype(np.float32)
    h0 = rng.standard_normal((2, 16)).astype(np.float32)
    hs = tlru.lru_scan(*_t(a, b, h0))
    h = torch.from_numpy(h0)
    for t in range(L):
        h = torch.from_numpy(a[:, t]) * h + torch.from_numpy(b[:, t])
        _close(hs[:, t], h, atol=1e-5, rtol=1e-5)
    _close(hs, jax.jit(jlru.lru_scan)(a, b, h0), atol=1e-5, rtol=1e-5)


def test_lru_layer_prefill_then_decode_equals_full_and_jax():
    jcfg, tcfg, jspec, tspec, jp, tp = _lru_pair()
    x = (np.random.default_rng(1).standard_normal((2, 20, 32)) * 0.5).astype(np.float32)
    tx = torch.from_numpy(x)
    y_full, _ = tlru.lru_layer(tcfg, tspec, tp, tx, mode="train")
    jy, _ = jax.jit(lambda p, x: jlru.lru_layer(jcfg, jspec, p, x, mode="train"))(jp, x)
    _close(y_full, jy)
    cache = tlru.init_lru_cache(2, tspec, torch.float32, "cpu")
    y1, cache = tlru.lru_layer(tcfg, tspec, tp, tx[:, :16], cache=cache, mode="prefill")
    _close(y1, y_full[:, :16])
    for t in range(16, 20):
        yt, cache = tlru.lru_layer(tcfg, tspec, tp, tx[:, t : t + 1], cache=cache, mode="decode")
        _close(yt[:, 0], y_full[:, t])


def test_lru_forget_gate_bounds():
    """a_t in (0, 1): the state stays bounded for a bounded input."""
    rng = np.random.default_rng(0)
    a = torch.sigmoid(torch.from_numpy(rng.standard_normal((1, 256, 8)).astype(np.float32)) + 2.0)
    hs = tlru.lru_scan(a, torch.ones((1, 256, 8)))
    assert torch.isfinite(hs).all()
    assert (hs <= 1.0 / (1.0 - a.amax()) + 1e-3).all()


class _Ops(TorchDispatchMode):
    """Counts the aten operators a call issues (each a launch on the card)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _ops(fn) -> int:
    with _Ops() as ops:
        fn()
    return ops.n


def test_prefill_launches_do_not_grow_with_tokens():
    """No loop over tokens: a 2500-token LRU prefill issues fewer than twice
    a 250-token one's operators (log-step rounds), and the SSD prefill grows
    by at most 8 operators per further 256-token chunk (the inter-chunk
    state pass)."""
    jcfg, tcfg, _, tspec, _, tp = _lru_pair(d=16)
    x = {L: torch.randn((1, L, 16)) for L in (250, 2500)}
    lru = {L: _ops(lambda: tlru.lru_layer(tcfg, tspec, tp, x[L], mode="train")) for L in x}
    assert lru[2500] < 2 * lru[250], lru
    _, tcfg, _, _, _, _ = _ssm_pair(d=16)
    spec = SSMSpec(d_inner=32, head_dim=16, state_dim=16, conv_dim=4, chunk=256)
    sp = tssm.init_ssm(None, tcfg.replace(d_model=16), spec, torch.float32, "meta")
    sp = {k: torch.randn(v.shape) * 0.1 for k, v in sp.items()}
    ssd = {L: _ops(lambda: tssm.ssm_layer(tcfg.replace(d_model=16), spec, sp, torch.randn((1, L, 16)),
                                          mode="train")) for L in (256, 2560)}
    assert ssd[2560] - ssd[256] <= 8 * 9, ssd


# ---------------------------------------------------------------------------
# The archs (test_arch_smoke.py for mamba2, recurrentgemma, gemma3)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def reduced(arch):
    """(JAX cfg, port cfg, JAX params) of a reduced arch."""
    jcfg = jax_make_reduced(jax_get_config(arch))
    return jcfg, make_reduced(get_config(arch)), jax.jit(
        lambda k: jm.init_params(jcfg, k))(jax.random.PRNGKey(0))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    """Reduced forward: shapes, no NaN, logits within 2e-4 of JAX's from the
    same weights (converted leaf for leaf, the f32 leaves kept f32)."""
    jcfg, tcfg, jp = reduced(arch)
    tp = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size, (2, 16)).astype(np.int32)
    logits, aux = tm.forward(tcfg, tp, torch.from_numpy(toks).long())
    assert logits.shape == (2, 16, tcfg.vocab_size)
    assert torch.isfinite(logits).all() and torch.isfinite(aux)
    jlogits, _ = jax.jit(lambda p, t: jm.forward(jcfg, p, t))(jp, toks)
    _close(logits, jlogits, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("arch,target,tol", [("gemma3-27b", 27e9, 0.1), ("mamba2-370m", 370e6, 0.1),
                                             ("recurrentgemma-2b", 2.7e9, 0.15)])
def test_full_config_param_count(arch, target, tol):
    """The full config's parameters on ``device="meta"`` (no memory): the
    JAX tree's count (from its shapes alone) and the assigned scale."""
    params = tm.init_params(get_config(arch), device="meta")
    n = sum(b.numel() for b in params.buffers())
    jcfg = jax_get_config(arch)
    shapes = jax.eval_shape(lambda k: jm.init_params(jcfg, k), jax.random.PRNGKey(0))
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert abs(n - target) / target < tol, (arch, n)
    assert abs(count_params(get_config(arch)) - n) / n < 1e-3  # the config's own estimate


def test_f32_leaves_survive_a_cast():
    """``params_from_numpy(dtype=bf16)`` casts every leaf but the SSD and
    RG-LRU f32 leaves, as the JAX package keeps them."""
    for arch, leaves in (("mamba2-370m", ("dt_bias", "A_log", "D")),
                         ("recurrentgemma-2b", ("Lambda",))):
        _, tcfg, jp = reduced(arch)
        tp = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu",
                                       dtype=torch.bfloat16)
        seg = tp["segments"]["seg0"]["pos0"]
        mixer = seg["ssm"] if "ssm" in seg._keys else seg["lru"]
        for name in leaves:
            assert mixer[name].dtype == torch.float32, name
        assert seg["norm_mixer"]["scale"].dtype == torch.bfloat16
