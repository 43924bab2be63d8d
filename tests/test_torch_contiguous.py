"""Port parity for the contiguous continuous engine (``paged=False``): the
model entries ``prefill_into_slot`` and ``ragged_decode_step`` (per-row
cache writes at per-row positions; kernel 9's plain version over an int8
cache, the plain ``_sdpa`` over an fp one) against JAX's, and the engine
against the JAX engine and the static engine (the cases of
``tests/test_continuous.py``), on reduced glm4-9b and, under its own
capacity dispatch, reduced llama4-maverick, in f32 on the CPU.

Tolerances: logits and written K/V agree to 1e-5 (f32, the same products
summed in another order; 2e-4 against a prefill + uniform decode, as
``test_continuous.py``); positions, untouched rows and engine records are
exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as jm
from repro_torch.models import model as tm
from repro_torch.serving.continuous import ContinuousEngine
from repro_torch.serving.engine import Engine, EngineConfig, Request
from test_torch_prefix import both, leaves_like, load, serve
from _torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def glm4():
    return load("glm4-9b")


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


# admissions (slot, prompt): row 2 first holds a longer sequence, then a
# 3-token one; row 1 stays unused
ADMISSIONS = [(2, list(range(20, 31))), (0, [3, 5, 7, 9, 11, 13, 15, 17]), (2, [2, 4, 6])]


def admit_both(pair, kv_bits, admissions=ADMISSIONS, cap=20):
    """Three slot rows; each (slot, prompt) of ``admissions`` prefilled into
    its row on both sides.  Returns (JAX caches, port caches, logits
    pairs)."""
    jcfg, tcfg, jparams, tparams = pair
    jc = jm.init_caches(jcfg, 3, cap, kv_bits=kv_bits)
    tc = tm.init_caches(tcfg, 3, cap, kv_bits=kv_bits, device="cpu")
    logits = []
    for slot, p in admissions:
        toks = np.asarray([p], np.int32)
        pos = np.arange(len(p), dtype=np.int32)[None]
        jl, jc = jm.prefill_into_slot(jcfg, jparams, jnp.asarray(toks), jnp.asarray(pos),
                                      jnp.asarray(slot, jnp.int32), jc)
        tl, tc = tm.prefill_into_slot(tcfg, tparams, t(toks).long(), t(pos), slot, tc)
        logits.append((jl, tl))
    return jc, tc, logits


def assert_caches_close(tc, jc):
    for tt, jj in leaves_like(tc, jc):
        if tt.dtype in (torch.int8, torch.int32):
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jj))
        else:
            np.testing.assert_allclose(tt.numpy(), np.asarray(jj), **TOL)


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_prefill_into_slot_matches_jax(glm4, kv_bits):
    """``ADMISSIONS``: logits and the whole pool as JAX's (row 2, reused, is
    reset past its new 3-token prompt), row 1 untouched."""
    jc, tc, logits = admit_both(glm4, kv_bits)
    for jl, tl in logits:
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert_caches_close(tc, jc)
    pos = tc["seg0"]["pos0"]["self"]["pos"]
    assert (pos[:, 1] == -1).all() and (pos[:, 2, 3:] == -1).all()


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_ragged_decode_matches_jax(glm4, kv_bits):
    """Rows 0 and 2 decode at their own positions (8 and 3); row 1 is
    inactive.  Active logits and the whole cache as JAX's masked merge
    gives them; the inactive row is bit-identical to before the step."""
    jcfg, tcfg, jparams, tparams = glm4
    jc, tc, _ = admit_both(glm4, kv_bits)
    before = [x.clone() for x in tm._tensors(tc)]
    tok = np.asarray([[1], [42], [5]], np.int32)
    pos = np.asarray([8, 0, 3], np.int32)
    active = np.asarray([True, False, True])
    jl, jc = jm.ragged_decode_step(jcfg, jparams, jnp.asarray(tok), jnp.asarray(pos),
                                   jnp.asarray(active), jc)
    tl, tc = tm.ragged_decode_step(tcfg, tparams, t(tok).long(), t(pos), t(active), tc)
    np.testing.assert_allclose(tl.numpy()[active], np.asarray(jl)[active], **TOL)
    assert_caches_close(tc, jc)
    for a, b in zip(tm._tensors(tc), before):
        assert torch.equal(a[:, 1], b[:, 1])
    assert tc["seg0"]["pos0"]["self"]["pos"][0, 0, 8] == 8


def test_ragged_decode_at_uniform_positions_is_decode_step(glm4):
    """Per-row positions that happen to be equal give the uniform decode."""
    _, tcfg, _, tparams = glm4
    toks = torch.randint(1, tcfg.vocab_size, (3, 11), generator=torch.Generator().manual_seed(1))
    out = []
    for ragged in (False, True):
        caches = tm.init_caches(tcfg, 3, 14, device="cpu")
        _, caches = tm.prefill(tcfg, tparams, toks[:, :10], caches)
        if ragged:
            lg, caches = tm.ragged_decode_step(tcfg, tparams, toks[:, 10:], torch.full((3,), 10),
                                               torch.ones(3, dtype=torch.bool), caches)
        else:
            lg, caches = tm.decode_step(tcfg, tparams, toks[:, 10:], 10, caches)
        out.append((lg, list(tm._tensors(caches))))
    torch.testing.assert_close(out[0][0], out[1][0], **TOL)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, **TOL)


def test_staggered_rows_match_independent_decoding(glm4):
    """Two requests at different positions decoded in one ragged step give
    each one's logits decoded alone."""
    _, tcfg, _, tparams = glm4
    p0, p1 = [3, 5, 7, 9, 11], [2, 4, 6]
    singles = []
    for p in (p0, p1):
        c = tm.init_caches(tcfg, 1, 20, device="cpu")
        _, c = tm.prefill(tcfg, tparams, torch.tensor([p]), c)
        lg, _ = tm.decode_step(tcfg, tparams, torch.tensor([[1]]), len(p), c)
        singles.append(lg[0])
    pool = tm.init_caches(tcfg, 2, 20, device="cpu")
    for i, p in enumerate((p0, p1)):
        _, pool = tm.prefill_into_slot(tcfg, tparams, torch.tensor([p]),
                                       torch.arange(len(p), dtype=torch.int32)[None], i, pool)
    lg, _ = tm.ragged_decode_step(tcfg, tparams, torch.tensor([[1], [1]]),
                                  torch.tensor([len(p0), len(p1)]), torch.ones(2, dtype=torch.bool),
                                  pool)
    for i in range(2):
        torch.testing.assert_close(lg[i], singles[i], atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_contiguous_engine_matches_jax(glm4, kv_bits):
    """Five requests through 2 slots: later ones admitted as slots free; the
    same greedy tokens as the JAX contiguous engine."""
    prompts = [[1, 2, 3, 4], [9, 8, 7], [5, 5, 5, 5, 5], [6, 1], [4, 4, 2, 9, 9, 1, 3]]
    jr, tr, _ = both(glm4, serve(prompts, 5), slots=2, capacity=32, kv_cache_bits=kv_bits)
    assert tr == jr and all(len(x) == 5 for x in tr["tokens"])


def test_contiguous_engine_matches_static_engine(glm4):
    _, tcfg, _, tparams = glm4
    prompts = [[1, 2, 3, 4], [9, 8, 7], [5, 5, 5, 5, 5]]
    static = Engine(tcfg, tparams, EngineConfig(max_batch=1, max_prefill=16, max_decode=5),
                    device="cpu")
    want = [static.generate([Request(prompt=p, max_new_tokens=5)])[0].tokens for p in prompts]
    got = serve(prompts, 5)(ContinuousEngine(tcfg, tparams, device="cpu", slots=2, capacity=32),
                            Request)
    assert got["tokens"] == want


@pytest.mark.parametrize("paged", [False, True])
def test_prefix_options_need_paged(glm4, paged):
    """Prefix sharing and the batched tick need block tables, as in JAX;
    with them the engine builds."""
    _, tcfg, _, tparams = glm4
    for opt in (dict(prefix_sharing=True), dict(prefill_mode="batched")):
        if paged:
            ContinuousEngine(tcfg, tparams, device="cpu", paged=True, capacity=16, **opt)
        else:
            with pytest.raises(ValueError, match="paged"):
                ContinuousEngine(tcfg, tparams, device="cpu", capacity=16, **opt)


def test_contiguous_capacity_dispatch_matches_jax():
    """Reduced llama4 under its own capacity dispatch: every row of a ragged
    step, the idle ones at position 0 included, competes for capacity in
    token-major order; an idle row attends over its one written key on both
    sides, so the JAX engine's default path is the reference."""
    pair = load("llama4-maverick-400b-a17b")
    prompts = [[1, 2, 3, 4, 5], [9, 8, 7], [5, 5, 5, 5, 5, 2], [6, 1]]

    def script(eng, req):
        ids = [eng.submit(req(prompt=p, max_new_tokens=2 + 2 * i)) for i, p in enumerate(prompts)]
        done = eng.run_until_done()
        return [done[i].tokens for i in ids]

    jt, tt, _ = both(pair, script, slots=3, capacity=24)
    assert tt == jt
