"""Two training steps of every assigned arch in both packages, the port's
counterpart of ``tests/test_arch_smoke.py::test_one_train_step``: the
registry's ``ASSIGNED`` list at ``make_reduced`` size in f32, the JAX
package's initial weights carried across by ``convert.params_from_numpy``,
two AdamW steps (lr 1e-3, warmup 1, decay 10) on the first two batches of
``data_stream(vocab, 4, 16, seed=0)``; llama4-maverick under ``grouped``
too (its registry ``moe_impl`` is ``ep``, the capacity table without a
mesh).  seamless-m4t-medium refuses in both (neither train step passes the
encoder's ``memory``); internvl2-1b's two steps are
``tests/test_torch_training.py::test_unused_leaf_gets_a_zero_gradient_and_is_decayed_as_in_jax``.

Tolerances: losses 1e-6 relative (the same f32 arithmetic, summed in other
orders); parameters as ``test_train_steps_match_jax`` holds them, within
1e-5 of JAX's but for at most one value in 10^4 and none past 2 lr per step
(Adam's first steps move a value by about lr sign(g), and a gradient that
is about 0 in both packages can take opposite signs).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import ASSIGNED as JAX_ASSIGNED
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import make_reduced as jax_make_reduced
from repro.data import pipeline as jpipe
from repro.models import model as jm
from repro.training import optimizer as jopt
from repro.training import trainer as jtrain
from repro_torch import convert
from repro_torch.configs.registry import ASSIGNED, get_config, make_reduced
from repro_torch.data import pipeline as tpipe
from repro_torch.models import model as tm
from repro_torch.training import optimizer as topt
from repro_torch.training import trainer as ttrain
from _torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

LR, STEPS = 1e-3, 2
PARAM_TOL = 2 * LR * STEPS
B, S = 4, 16
# trained in tests/test_torch_training.py (its unused frontend leaf)
ELSEWHERE = {"internvl2-1b"}
REFUSED = {"seamless-m4t-medium"}
CASES = [(a, None) for a in ASSIGNED if a not in ELSEWHERE | REFUSED] + \
    [("llama4-maverick-400b-a17b", "grouped")]


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, (dict, tm.ParamTree)):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def configs(arch, impl):
    jcfg, tcfg = jax_make_reduced(jax_get_config(arch)), make_reduced(get_config(arch))
    if impl is not None:
        jcfg, tcfg = jcfg.replace(moe_impl=impl), tcfg.replace(moe_impl=impl)
    assert jcfg.param_dtype == tcfg.param_dtype == "float32" and jcfg.moe_impl == tcfg.moe_impl
    return jcfg, tcfg


def test_the_lists_name_every_assigned_arch():
    assert ASSIGNED == list(JAX_ASSIGNED)
    assert {a for a, _ in CASES} | ELSEWHERE | REFUSED == set(ASSIGNED)
    texts = {a for a in ASSIGNED if get_config(a).family not in ("encdec", "vlm")}
    assert {a for a, impl in CASES if impl is None} == texts and len(texts) == 8


@pytest.mark.parametrize("arch,impl", CASES, ids=[a + (f"-{i}" if i else "") for a, i in CASES])
def test_two_train_steps_match_jax(arch, impl):
    jcfg, tcfg = configs(arch, impl)
    jparams = jax.jit(lambda k: jm.init_params(jcfg, k))(jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    jtc = jtrain.TrainConfig(lr=LR, warmup_steps=1, decay_steps=10)
    tc = ttrain.TrainConfig(lr=LR, warmup_steps=1, decay_steps=10)
    jstep = jax.jit(jtrain.make_train_step(jcfg, jtc))
    tstep = ttrain.make_train_step(tcfg, tc)
    jst, tst = jopt.init_adamw(jparams), topt.init_adamw(tm.trainable(tparams))
    jdata = jpipe.data_stream(jcfg.vocab_size, B, S, seed=0)
    tdata = tpipe.data_stream(tcfg.vocab_size, B, S, seed=0, device="cpu")
    jp = jparams
    for step in range(STEPS):
        toks, labels = (np.asarray(a) for a in next(jdata))
        ttoks, tlabels = next(tdata)
        np.testing.assert_array_equal(ttoks.numpy(), toks)
        np.testing.assert_array_equal(tlabels.numpy(), labels)
        jp, jst, jmet = jstep(jp, jst, toks, labels)
        tparams, tst, tmet = tstep(tparams, tst, ttoks, tlabels)
        assert np.isfinite(float(jmet["loss"]))
        assert rel(tmet["loss"].detach(), jmet["loss"]) <= 1e-6, (step, float(tmet["loss"]),
                                                                  float(jmet["loss"]))
    assert tst.step == int(jst.step) == STEPS
    tl = tm.param_leaves(tparams)
    jl = flat(jp)
    assert set(tl) == set(jl)
    d = np.concatenate([np.abs(tl[k].detach().numpy() - np.asarray(v)).ravel() for k, v in jl.items()])
    assert d.max() <= PARAM_TOL and (d > 1e-5).sum() <= d.size // 10_000, (d.max(), (d > 1e-5).sum())
    moved = max(np.abs(np.asarray(v) - np.asarray(flat(jparams)[k])).max() for k, v in jl.items())
    assert moved > 0.0


def test_seamless_refuses_in_both_packages():
    """Neither train step passes the encoder's memory: JAX's forward
    asserts it, the port's raises a ValueError."""
    arch = "seamless-m4t-medium"
    jcfg, tcfg = configs(arch, None)
    jparams = jax.jit(lambda k: jm.init_params(jcfg, k))(jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    toks, labels = (np.array(a) for a in next(jpipe.data_stream(jcfg.vocab_size, B, S, seed=0)))
    jtc = jtrain.TrainConfig(lr=LR, warmup_steps=1, decay_steps=10)
    with pytest.raises(AssertionError):
        jtrain.make_train_step(jcfg, jtc)(jparams, jopt.init_adamw(jparams), toks, labels)
    tstep = ttrain.make_train_step(tcfg, ttrain.TrainConfig(lr=LR, warmup_steps=1, decay_steps=10))
    with pytest.raises(ValueError, match="cross attention needs the encoder memory"):
        tstep(tparams, topt.init_adamw(tm.trainable(tparams)), torch.from_numpy(toks).long(),
              torch.from_numpy(labels).long())
