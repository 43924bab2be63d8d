"""Port parity for the whole capacity-dispatch slice: the static ``Engine``
of the JAX package and of ``repro_torch`` on reduced configs served with
each config's OWN ``moe_impl`` (no ``.replace``): llama4-maverick and
kimi-k2 ("ep", which without a mesh is the dense mapping table; top-1 and
top-2 with a shared expert), and the paper's ``nlg-350m-moe128`` (GELU
experts, tied embeddings) and ``nlg-350m-prmoe-32-64`` (Residual-MoE), in
f32 on the CPU from the same parameters.

Tolerance for logits: ``atol = rtol = 1e-4`` (a few layers of f32 products
over 128-wide contractions, summed in another order on each side).  Greedy
tokens must be identical.  Under capacity routing every row of the batch
competes for its expert's slots in token-major order, left pads included,
so the two engines must feed the MoE layers the same rows, as they do.
"""
import functools

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

ARCHS = ["llama4-maverick-400b-a17b", "kimi-k2-1t-a32b", "nlg-350m-moe128", "nlg-350m-prmoe-32-64"]
TOL = dict(atol=1e-4, rtol=1e-4)
ENGINE = dict(max_batch=4, max_prefill=12, max_decode=8)


@functools.lru_cache(maxsize=None)
def load(name):
    jcfg = jax_make_reduced(jax_get_config(name))
    tcfg = make_reduced(get_config(name))
    assert tcfg.moe_impl == jcfg.moe_impl
    jparams = jax.jit(lambda k: jm.init_params(jcfg, k))(jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return load(request.param)


def greedy(jcfg, tcfg, jparams, tparams, prompts, n_new=8, **kw):
    """The same requests through both static engines."""
    jout = je.Engine(jcfg, jparams, je.EngineConfig(**ENGINE, **kw)).generate(
        [je.Request(p, n_new) for p in prompts])
    tout = te.Engine(tcfg, tparams, te.EngineConfig(**ENGINE, **kw), device="cpu").generate(
        [te.Request(p, n_new) for p in prompts])
    return [r.tokens for r in jout], [r.tokens for r in tout]


def test_capacity_dispatch_is_the_configs_own(pair):
    jcfg, tcfg, _, _ = pair
    assert tcfg.moe_impl in ("ep", "dense")
    assert any(ls.ffn.kind == "moe" for seg in tcfg.segments for ls in seg.pattern)


def test_prefill_and_decode_logits(pair):
    jcfg, tcfg, jparams, tparams = pair
    B, S, cap = 2, 6, 12
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    # jitted: one compile per entry point costs less than compiling op by op
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
    """3 requests of unequal prompt lengths (left pads in the batch, which
    compete for capacity too) x 8 tokens."""
    jt, tt = greedy(*pair, [np.random.default_rng(1).integers(1, 500, n).tolist() for n in (5, 9, 3)])
    assert tt == jt
    assert all(len(r) == 8 for r in tt)
