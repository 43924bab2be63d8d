"""Port parity for the dense global archs (reduced glm4-9b, llama3-8b and
deepseek-67b: GQA attention with RoPE and a dense SwiGLU FFN, no MoE) and
for a long static prompt, served by the JAX package and by ``repro_torch``
from the same parameters, in f32 on the CPU.

Their static prefill attends through kernel 6's plain version on the CPU
(``kernels/flash_attention.py``).  Tolerance for logits: ``atol = rtol =
1e-4``, as ``tests/test_torch_engine.py`` (f32 products over 128-wide
contractions, summed in another order on each side).  Greedy tokens must be
identical.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import make_reduced as jax_make_reduced
from repro.models import model as jm
from repro.serving import engine as je
from repro_torch import convert
from repro_torch.configs.registry import get_config, make_reduced
from repro_torch.models import model as tm
from repro_torch.serving import engine as te
from _torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

ARCHS = ["glm4-9b", "llama3-8b", "deepseek-67b"]
TOL = dict(atol=1e-4, rtol=1e-4)


def _pair(name):
    jcfg = jax_make_reduced(jax_get_config(name))
    tcfg = make_reduced(get_config(name))
    jparams = jax.jit(lambda k: jm.init_params(jcfg, k))(jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _pair(request.param)


def test_dense_archs_are_dense_global_gqa(pair):
    _, tcfg, _, _ = pair
    specs = tcfg.layer_specs()
    assert all(ls.ffn.kind == "dense" and ls.mixer.kind == "global" for ls in specs)
    assert tcfg.num_heads % tcfg.num_kv_heads == 0


def test_prefill_and_decode_logits(pair):
    jcfg, tcfg, jparams, tparams = pair
    B, S, cap = 2, 6, 12
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jprefill = jax.jit(lambda p, t, c: jm.prefill(jcfg, p, t, c))
    jdecode = jax.jit(lambda p, t, i, c: jm.decode_step(jcfg, p, t, i, c))
    jl, jc = jprefill(jparams, jax.numpy.asarray(toks), jm.init_caches(jcfg, B, cap))
    tl, tc = tm.prefill(tcfg, tparams, torch.from_numpy(toks).long(),
                        tm.init_caches(tcfg, B, cap, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for index in (S, S + 1):
        cur = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
        jl, jc = jdecode(jparams, jax.numpy.asarray(cur), jax.numpy.asarray(index), jc)
        tl, tc = tm.decode_step(tcfg, tparams, torch.from_numpy(cur).long(), index, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_generate_greedy_tokens_identical(pair):
    """3 requests of unequal prompt lengths (left pads in the batch) x 8
    tokens: the port's Engine emits exactly the JAX Engine's tokens."""
    jcfg, tcfg, jparams, tparams = pair
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, jcfg.vocab_size, n).tolist() for n in (5, 9, 3)]
    kw = dict(max_batch=4, max_prefill=12, max_decode=8)
    jout = je.Engine(jcfg, jparams, je.EngineConfig(**kw)).generate(
        [je.Request(p, 8) for p in prompts])
    tout = te.Engine(tcfg, tparams, te.EngineConfig(**kw), device="cpu").generate(
        [te.Request(p, 8) for p in prompts])
    assert [r.tokens for r in tout] == [r.tokens for r in jout]
    assert all(len(r.tokens) == 8 for r in tout)


def test_long_prompt_greedy_tokens_identical():
    """One reduced llama4-maverick request with a 2048-token prompt: the JAX
    Engine attends through its real chunked path (``attend_chunked`` at its
    default Q_CHUNK = 1024), the port through kernel 6's plain version in
    1024-query chunks; the greedy tokens are identical."""
    jcfg, tcfg, jparams, tparams = _pair("llama4-maverick-400b-a17b")
    prompt = np.random.default_rng(2).integers(1, jcfg.vocab_size, 2048).tolist()
    kw = dict(max_batch=1, max_prefill=2048, max_decode=4)
    jout = je.Engine(jcfg, jparams, je.EngineConfig(**kw)).generate([je.Request(prompt, 4)])
    tout = te.Engine(tcfg, tparams, te.EngineConfig(**kw), device="cpu").generate(
        [te.Request(prompt, 4)])
    assert tout[0].tokens == jout[0].tokens
    assert len(tout[0].tokens) == 4
