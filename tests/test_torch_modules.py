"""Port parity: primitive modules and attention (``repro_torch.models``)
against the JAX package, on reduced llama4-maverick, in f32 on the CPU.

Inputs and parameters are drawn with numpy from a seed and handed to both
sides.  Tolerance ``atol = rtol = 1e-5``: both sides compute in f32 (the
JAX side at "highest" matmul precision, see conftest.py), so only the order
of summation differs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import make_reduced as jax_make_reduced
from repro.models import attention as jattn
from repro.models import modules as jmod
from repro_torch.configs.registry import get_config, make_reduced
from repro_torch.models import attention as tattn
from repro_torch.models import modules as tmod

ARCH = "llama4-maverick-400b-a17b"
TOL = dict(atol=1e-5, rtol=1e-5)


def close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **(tol or TOL))


@pytest.fixture(scope="module")
def cfgs():
    return (jax_make_reduced(jax_get_config(ARCH)),
            make_reduced(get_config(ARCH)))


def test_rmsnorm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = (0.1 * rng.standard_normal(64)).astype(np.float32)
    j = jmod.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6)
    t = tmod.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x), 1e-6)
    close(t, j)


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_apply_rope(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    pos = np.arange(3, 10, dtype=np.int32)[None].repeat(2, 0)
    j = jmod.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    t = tmod.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    close(t, j)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp(act):
    rng = np.random.default_rng(2)
    d, f = 32, 48
    p = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("wi", (d, f)), ("wg", (d, f)), ("wo", (f, d)))}
    x = rng.standard_normal((2, 3, d)).astype(np.float32)
    j = jmod.mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), act)
    t = tmod.mlp({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x), act)
    close(t, j)


def test_attention_prefill_then_decode(cfgs):
    """Prefill 6 tokens into a 10-slot cache, then two decode steps: the
    outputs and the cache (k, v, pos) agree after every call."""
    jcfg, tcfg = cfgs
    spec = jcfg.segments[0].pattern[0].mixer
    tspec = tcfg.segments[0].pattern[0].mixer
    rng = np.random.default_rng(3)
    D, H, Hkv, dh = jcfg.d_model, jcfg.num_heads, jcfg.num_kv_heads, jcfg.head_dim
    shapes = {"wq": (D, H, dh), "wk": (D, Hkv, dh), "wv": (D, Hkv, dh), "wo": (H, dh, D)}
    p = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32) for k, s in shapes.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    B, S, cap = 2, 6, 10
    jc = jattn.init_kv_cache(B, cap, Hkv, dh, jnp.float32)
    tc = tattn.init_kv_cache(B, cap, Hkv, dh, torch.float32, "cpu")

    def check_cache():
        for key in ("k", "v"):
            close(tc[key], jc[key])
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))

    # jitted: one compile per mode costs less than compiling op by op
    jattend = jax.jit(lambda p, x, pos, c, mode: jattn.attention(jcfg, spec, p, x, pos, cache=c, mode=mode),
                      static_argnames="mode")
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)[None]
    jy, jc = jattend(jp, jnp.asarray(x), jnp.asarray(pos), jc, mode="prefill")
    ty, tc = tattn.attention(tcfg, tspec, tp, torch.from_numpy(x), torch.from_numpy(pos),
                             cache=tc, mode="prefill")
    close(ty, jy)
    check_cache()
    for index in (S, S + 1):
        x = rng.standard_normal((B, 1, D)).astype(np.float32)
        pos = np.full((B, 1), index, np.int32)
        jy, jc = jattend(jp, jnp.asarray(x), jnp.asarray(pos), jc, mode="decode")
        ty, tc = tattn.attention(tcfg, tspec, tp, torch.from_numpy(x), torch.from_numpy(pos),
                                 cache=tc, mode="decode", index=index)
        close(ty, jy)
        check_cache()


def test_unported_attention_raises():
    from repro_torch.configs.base import AttnSpec

    tattn.check_spec(AttnSpec(kind="local", window=8))  # sliding windows are ported
    tattn.check_spec(AttnSpec(kind="cross", causal=False))  # and cross attention
    with pytest.raises(ValueError, match="unknown attention kind"):
        tattn.check_spec(AttnSpec(kind="bidirectional"))
    with pytest.raises(ValueError, match="block table"):  # a paged layer's paged mode
        tattn.attention(None, AttnSpec(), {}, torch.zeros(1, 1, 4), torch.zeros(1, 1), mode="decode_paged")


@pytest.mark.parametrize("top_k,top_p", [(5, 0.0), (0, 0.7), (8, 0.5)])
def test_sampling_masks(top_k, top_p):
    """Top-k / top-p filtering keeps exactly the JAX package's token sets
    (the draws themselves come from different generators and are not
    compared); a draw only ever lands in the kept set."""
    from repro.serving import sampling as jsamp
    from repro_torch.serving import sampling as tsamp

    logits = np.random.default_rng(4).standard_normal((3, 40)).astype(np.float32)
    j, t = jnp.asarray(logits), torch.from_numpy(logits)
    if top_k:
        j, t = jsamp._top_k_mask(j, top_k), tsamp._top_k_mask(t, top_k)
    if top_p:
        j, t = jsamp._top_p_mask(j, top_p), tsamp._top_p_mask(t, top_p)
    kept = np.asarray(j) > -1e29
    np.testing.assert_array_equal(t.numpy() > -1e29, kept)
    gen = torch.Generator().manual_seed(0)
    for _ in range(5):
        tok = tsamp.sample(torch.from_numpy(logits), gen, temperature=1.0, top_k=top_k, top_p=top_p)
        assert kept[np.arange(3), tok.numpy()].all()
    greedy = tsamp.sample(torch.from_numpy(logits))
    np.testing.assert_array_equal(greedy.numpy(), logits.argmax(-1))
