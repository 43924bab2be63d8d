"""Port parity for kernel 6 (``repro_torch.kernels.flash_attention``) and the
attention it carries (``attend_full`` / ``attend_chunked`` and the prefill
mode of ``attention``), against the JAX package, in f32 on the CPU (bf16
where stated).

On the CPU the wrapper takes its plain version; the JAX kernel runs in
interpret mode, as ``tests/test_flash_attention.py`` runs it.  Inputs are
drawn with numpy from a seed and handed to both sides.  Tolerances: f32
``atol 2e-5, rtol 1e-4`` (the JAX kernel's own test's; only the order of
summation and the online softmax's rescaling differ), bf16 ``2e-2`` (both
sides round the probabilities to bf16, at different points).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import AttnSpec as JAttnSpec
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import make_reduced as jax_make_reduced
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention import flash_attention_ref
from repro.models import attention as jattn
from repro_torch.configs.base import AttnSpec
from repro_torch.configs.registry import get_config, make_reduced
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention as tattn

TOL = dict(atol=2e-5, rtol=1e-4)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


def _qkv(BH, S, T, dh, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in ((BH, S, dh), (BH, T, dh), (BH, T, dh)))


def _t(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


@pytest.mark.parametrize("BH,S,T,dh,causal", [
    (2, 256, 256, 64, True),
    (3, 128, 384, 16, False),
    (2, 128, 128, 128, True),
])
def test_index_form_matches_jax_kernel_and_ref(BH, S, T, dh, causal):
    q, k, v = _qkv(BH, S, T, dh, seed=S + T)
    scale = dh ** -0.5
    got = fa.flash_attention(*_t(q, k, v), scale=scale, causal=causal).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_flash(q, k, v, scale=scale, causal=causal)), **TOL)
    np.testing.assert_allclose(got, np.asarray(flash_attention_ref(q, k, v, scale=scale, causal=causal)),
                               **TOL)


def test_index_form_bf16():
    q, k, v = (jnp.asarray(x, jnp.bfloat16) for x in _qkv(2, 128, 128, 64, seed=4))
    want = np.asarray(jax_flash(q, k, v, scale=0.125, causal=True), np.float32)
    tq, tk, tv = (torch.from_numpy(np.asarray(x, np.float32)).bfloat16() for x in (q, k, v))
    got = fa.flash_attention(tq, tk, tv, scale=0.125, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)


def test_causal_is_top_left_when_s_differs_from_t():
    """S = 128 queries over T = 256 keys, causal: the port computes the TPU
    kernel's function (query i sees keys 0 .. i), not the oracle's
    bottom-right ``tril(k=T-S)``."""
    q, k, v = _qkv(2, 128, 256, 32, seed=11)
    got = fa.flash_attention(*_t(q, k, v), scale=0.2, causal=True).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_flash(q, k, v, scale=0.2, causal=True)), **TOL)
    oracle = np.asarray(flash_attention_ref(q, k, v, scale=0.2, causal=True))
    assert np.abs(got - oracle).max() > 0.1  # the two alignments differ


# (G, dh, S, T, variant): G query heads per kv-head; T > S is a prefill that
# continues a cache (queries at T - S .. T - 1)
GQA_CASES = [
    (1, 32, 64, 64, "plain"),
    (4, 64, 64, 64, "offset"),
    (5, 112, 50, 50, "plain"),
    (16, 32, 64, 64, "empty_slots"),
    (4, 32, 50, 50, "softcap"),
    (5, 64, 64, 64, "offset_empty_softcap"),
    (4, 112, 64, 80, "continue"),
]


def _gqa_inputs(G, dh, S, T, variant, seed=0, Hkv=2, B=2):
    rng = np.random.default_rng(seed)
    H = G * Hkv
    q = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, dh)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, dh)).astype(np.float32)
    base = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    if "offset" in variant:
        base += np.array([[7], [300]], np.int32)
    q_pos = np.ascontiguousarray(base[:, T - S:])
    k_pos = base.copy()
    if "empty" in variant:
        # empty cache slots, never slot 0, so every row keeps a valid key
        k_pos[:, np.arange(T) % 7 == 3] = -1
        k_pos[1, 40:45] = -1
    softcap = 5.0 if "softcap" in variant else 0.0
    return q, k, v, q_pos, k_pos, softcap


@pytest.mark.parametrize("G,dh,S,T,variant", GQA_CASES)
def test_attend_chunked_and_full_match_jax(G, dh, S, T, variant):
    q, k, v, q_pos, k_pos, cap = _gqa_inputs(G, dh, S, T, variant)
    spec, jspec = AttnSpec(logit_softcap=cap), JAttnSpec(logit_softcap=cap)
    scale = dh ** -0.5
    jfull = jax.jit(lambda *a: jattn.attend_full(*a, jspec, scale))(q, k, v, q_pos, k_pos)
    jchunk = jax.jit(lambda *a: jattn.attend_chunked(*a, jspec, scale, q_chunk=16))(q, k, v, q_pos, k_pos)
    args = _t(q, k, v, q_pos, k_pos)
    tfull = tattn.attend_full(*args, spec, scale)
    tchunk = tattn.attend_chunked(*args, spec, scale)
    # the plain version's own query chunks, 16 at a time as JAX's above
    tplain = fa.flash_attention_plain(*args, scale=scale, causal=True, softcap=cap, q_chunk=16)
    for got in (tfull, tchunk, tplain):
        for want in (jfull, jchunk):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("G,dh", [(4, 32), (16, 64)])
def test_window_matches_jax(G, dh):
    """A sliding window (kind "local"): the port's ``attend_full`` against
    JAX's ``attend_full`` and its local ``attend_chunked``, which reads only
    the window's K/V per chunk.  The port's ``attend_chunked`` is its
    ``attend_full``; ``check_spec`` takes local layers."""
    q, k, v, q_pos, k_pos, _ = _gqa_inputs(G, dh, 64, 64, "plain", seed=5)
    spec, jspec = AttnSpec(kind="local", window=13), JAttnSpec(kind="local", window=13)
    scale = dh ** -0.5
    jfull = jax.jit(lambda *a: jattn.attend_full(*a, jspec, scale))(q, k, v, q_pos, k_pos)
    jchunk = jax.jit(lambda *a: jattn.attend_chunked(*a, jspec, scale, q_chunk=16))(q, k, v, q_pos, k_pos)
    got = tattn.attend_full(*_t(q, k, v, q_pos, k_pos), spec, scale).numpy()
    np.testing.assert_allclose(got, np.asarray(jfull), **TOL)
    np.testing.assert_allclose(got, np.asarray(jchunk), **TOL)
    np.testing.assert_allclose(tattn.attend_chunked(*_t(q, k, v, q_pos, k_pos), spec, scale).numpy(),
                               np.asarray(jchunk), **TOL)
    tattn.check_spec(spec)


# Head dim 256: recurrentgemma-2b's 10 query heads over one kv-head (its
# local layers' window is 2048; reduced here)
RG_H, RG_DH = 10, 256


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_at_head_dim_256_matches_jax_kernel(dtype):
    """The port's ``flash_attention_gqa`` at dh 256, causal, 10 heads over
    one kv-head, against the JAX package's ``flash_attention`` (the Pallas
    kernel in interpret mode, as its own tests run it) per head over the
    shared kv-head, and against its oracle; bf16 inputs within
    ``BF16_TOL``."""
    rng = np.random.default_rng(256)
    B, S = 2, 128
    q = rng.standard_normal((B, S, RG_H, RG_DH)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, 1, RG_DH)).astype(np.float32) for _ in range(2))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    scale = RG_DH ** -0.5
    jq = q.transpose(0, 2, 1, 3).reshape(B * RG_H, S, RG_DH)
    jk, jv = (np.repeat(x.transpose(0, 2, 1, 3), RG_H, axis=1).reshape(B * RG_H, S, RG_DH)
              for x in (k, v))
    unflat = lambda y: np.asarray(y, np.float32).reshape(B, RG_H, S, RG_DH).transpose(0, 2, 1, 3)
    tq, tk, tv = _t(q, k, v)
    if dtype == "bfloat16":
        jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (jq, jk, jv))
        tq, tk, tv = (x.bfloat16() for x in (tq, tk, tv))
    got = fa.flash_attention_gqa(tq, tk, tv, *_t(pos, pos), scale=scale, causal=True)
    assert got.dtype == tq.dtype
    want = unflat(jax_flash(jq, jk, jv, scale=scale, causal=True))
    tol = BF16_TOL if dtype == "bfloat16" else TOL
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), unflat(flash_attention_ref(jq, jk, jv, scale=scale,
                                                                           causal=True)), **TOL)


@pytest.mark.parametrize("window,variant", [(13, "plain"), (40, "offset_empty_softcap")])
def test_window_at_head_dim_256_matches_jax(window, variant):
    """A local layer at dh 256 (recurrentgemma's heads, its window reduced
    to fit 96 tokens): ``flash_attention_gqa`` with the window and the
    port's ``attend_full`` against JAX's ``attend_full`` and its local
    ``attend_chunked``, as ``test_window_matches_jax`` at smaller head
    dims."""
    q, k, v, q_pos, k_pos, cap = _gqa_inputs(RG_H, RG_DH, 96, 96, variant, seed=window, Hkv=1)
    spec = AttnSpec(kind="local", window=window, logit_softcap=cap)
    jspec = JAttnSpec(kind="local", window=window, logit_softcap=cap)
    scale = RG_DH ** -0.5
    jfull = jax.jit(lambda *a: jattn.attend_full(*a, jspec, scale))(q, k, v, q_pos, k_pos)
    jchunk = jax.jit(lambda *a: jattn.attend_chunked(*a, jspec, scale, q_chunk=32))(q, k, v, q_pos, k_pos)
    args = _t(q, k, v, q_pos, k_pos)
    direct = fa.flash_attention_gqa(*args, scale=scale, causal=True, window=window, softcap=cap)
    for got in (direct, tattn.attend_full(*args, spec, scale)):
        for want in (jfull, jchunk):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_row_without_valid_key_gives_zero():
    """Batch row 1's keys are all empty (k_pos = -1): the port gives 0 there,
    as kernels 7-9 do, where the JAX ``_sdpa`` gives the uniform average of
    the values; row 0, which has valid keys, agrees."""
    q, k, v, q_pos, k_pos, _ = _gqa_inputs(4, 32, 16, 16, "plain", seed=6)
    k_pos[1] = -1
    spec, jspec = AttnSpec(), JAttnSpec()
    got = tattn.attend_full(*_t(q, k, v, q_pos, k_pos), spec, 0.2).numpy()
    want = np.asarray(jattn.attend_full(q, k, v, q_pos, k_pos, jspec, 0.2))
    np.testing.assert_allclose(got[0], want[0], **TOL)
    assert np.all(got[1] == 0)
    uniform = np.repeat(v[1].mean(0), 4, axis=0)  # [H, dh]: head h reads kv-head h // 4
    np.testing.assert_allclose(want[1], np.broadcast_to(uniform, want[1].shape), atol=1e-5)


def test_attention_prefill_2048_matches_jax():
    """A reduced llama4-maverick attention layer prefills 2048 tokens: JAX
    takes its chunked path (2048 > Q_CHUNK = 1024, divisible), the port its
    plain version in 1024-query chunks; the outputs and the filled cache
    agree."""
    name = "llama4-maverick-400b-a17b"
    jcfg, tcfg = jax_make_reduced(jax_get_config(name)), make_reduced(get_config(name))
    jspec, tspec = jcfg.segments[0].pattern[0].mixer, tcfg.segments[0].pattern[0].mixer
    rng = np.random.default_rng(7)
    D, H, Hkv, dh = jcfg.d_model, jcfg.num_heads, jcfg.num_kv_heads, jcfg.head_dim
    shapes = {"wq": (D, H, dh), "wk": (D, Hkv, dh), "wv": (D, Hkv, dh), "wo": (H, dh, D)}
    p = {n: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32) for n, s in shapes.items()}
    B, S, cap = 1, 2048, 2056
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)[None]
    # op by op: under jax.jit XLA evaluates RoPE's sin / cos of the large
    # angles of positions near 2048 differently, and the cached k moves by up
    # to 2.4e-4 (run eagerly, JAX's and the port's RoPE agree within 5e-7)
    jy, jc = jattn.attention(jcfg, jspec, {n: jnp.asarray(w) for n, w in p.items()}, jnp.asarray(x),
                             jnp.asarray(pos), cache=jattn.init_kv_cache(B, cap, Hkv, dh, jnp.float32),
                             mode="prefill")
    ty, tc = tattn.attention(tcfg, tspec, {n: torch.from_numpy(w) for n, w in p.items()},
                             torch.from_numpy(x), torch.from_numpy(pos), mode="prefill",
                             cache=tattn.init_kv_cache(B, cap, Hkv, dh, torch.float32, "cpu"))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]), **TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_wrapper_takes_the_plain_version_on_the_cpu_and_raises_elsewhere():
    q, k, v, q_pos, k_pos, _ = _gqa_inputs(4, 32, 20, 20, "plain", seed=8)
    args = _t(q, k, v, q_pos, k_pos)
    before = dict(fa.launches)
    got = fa.flash_attention_gqa(*args, scale=0.2, causal=True)
    want = fa.flash_attention_plain(*args, scale=0.2, causal=True, q_chunk=7)
    torch.testing.assert_close(got, want, rtol=0, atol=0)  # chunking leaves each row as it was
    assert fa.launches == before  # the plain version launches nothing
    meta = [t.to("meta") for t in args]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fa.flash_attention_gqa(*meta, scale=0.2)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fa.flash_attention(meta[0][:, :, 0], meta[1][:, :, 0], meta[2][:, :, 0], scale=0.2)


def test_kernel_argument_checks():
    """What the card's wrapper refuses before a launch, checked on CPU
    tensors: head dims without an instance, mixed types, float positions,
    strided inputs, mismatched shapes."""
    q, k, v, q_pos, k_pos, _ = _gqa_inputs(4, 32, 8, 8, "plain", seed=9)
    q, k, v, q_pos, k_pos = _t(q, k, v, q_pos, k_pos)
    fa._check("fa", q, k, v, q_pos, k_pos)  # well-formed
    with pytest.raises(ValueError, match="head dim 16"):
        fa._check("fa", q[..., :16].contiguous(), k[..., :16].contiguous(), v[..., :16].contiguous(),
                  q_pos, k_pos)
    with pytest.raises(TypeError, match="share one dtype"):
        fa._check("fa", q, k.bfloat16(), v, q_pos, k_pos)
    with pytest.raises(TypeError, match="int32"):
        fa._check("fa", q, k, v, q_pos.long(), k_pos)
    with pytest.raises(ValueError, match="contiguous"):
        fa._check("fa", q.transpose(1, 2).contiguous().transpose(1, 2), k, v, q_pos, k_pos)
    with pytest.raises(ValueError, match="do not match"):
        fa._check("fa", q, k, v, q_pos[:, :4].contiguous(), k_pos)
