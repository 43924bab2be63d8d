"""Port parity for training and Mixture-of-Students (``repro_torch.training``,
``data``, ``checkpoint``, ``launch/train.py``) against the JAX package on
the CPU, from the same numpy weights and batches.

Tolerances (f32):
- batches: exact; schedules 1e-6 relative (f32 cosines of two libraries
  may differ in the last bit); AdamW's moments and f32 parameters 1e-6
  relative (the same expression; ``b ** step`` and the clip factor may
  round differently in the last bit); bf16 parameters at most one bf16 ulp
  apart (an f32 update one ulp apart can round to the neighbouring bf16);
- cross entropy, KL: 1e-6 relative (logsumexp over a 512-wide vocab);
- gating gradients (kernel 1b's plain version): 1e-6 of the largest;
- loss and every leaf's gradient on reduced nlg-350m-prmoe-32-64: loss 1e-5
  relative, each leaf within 1e-4 of its largest value (four layers of f32
  products summed in other orders; the routing is the same);
- after train / distill steps: losses 1e-5 relative; parameters within
  1e-5 of JAX's but for at most one value in 10^4 (``assert_params_close``),
  and none past ``PARAM_TOL``.  Adam's first steps move a value by about lr
  * sign(g), so where a gradient is about 0 in both packages (within their
  f32 roundings) the two updates may take opposite signs: a step may part
  such a value by up to 2 lr.
"""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import make_reduced as jax_make_reduced
from repro.core import gating as jgating
from repro.data import pipeline as jpipe
from repro.data import synthetic as jsyn
from repro.models import model as jm
from repro.training import distill as jdist
from repro.training import optimizer as jopt
from repro.training import schedule as jsched
from repro.training import trainer as jtrain
from repro_torch import convert
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs.registry import get_config, make_reduced
from repro_torch.core import gating as tgating
from repro_torch.data import pipeline as tpipe
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import moe_gating as k1
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as tm
from repro_torch.models import transformer as ttr
from repro_torch.training import distill as tdist
from repro_torch.training import optimizer as topt
from repro_torch.training import schedule as tsched
from repro_torch.training import trainer as ttrain
from _torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

ARCH, MOS = "nlg-350m-prmoe-32-64", "nlg-350m-prmoe-mos"
LR, STEPS = 1e-3, 3
PARAM_TOL = 2 * LR * STEPS
B, S = 2, 16


def flat(tree, prefix=""):
    """{path: leaf} of a nested dict (JAX trees) or ParamTree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, (dict, tm.ParamTree)):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def np32(x):
    return np.asarray(x.detach().float() if torch.is_tensor(x) else x, np.float32)


def rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def assert_params_close(tparams, jparams):
    tl = tm.param_leaves(tparams)
    d = np.concatenate([np.abs(np32(tl[k]) - np.asarray(v)).ravel() for k, v in flat(jparams).items()])
    assert d.max() <= PARAM_TOL and (d > 1e-5).sum() <= d.size // 10_000, (d.max(), (d > 1e-5).sum())
    return d.max()


@pytest.fixture(scope="module", params=["einsum", "dense"])
def pair(request):
    impl = request.param
    jcfg = jax_make_reduced(jax_get_config(ARCH)).replace(moe_impl=impl)
    tcfg = make_reduced(get_config(ARCH)).replace(moe_impl=impl)
    jparams = jax.jit(lambda k: jm.init_params(jcfg, k))(jax.random.PRNGKey(0))
    return impl, jcfg, tcfg, jparams


def port_params(tcfg, jparams):
    return convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")


def batch(vocab, step=0, seed=0):
    toks, labels = jsyn.batches(vocab, B, S, seed=seed, start_step=step).__next__()
    return toks, labels


# ---------------------------------------------------------------------------
# schedules, AdamW, losses, data
# ---------------------------------------------------------------------------


def test_schedules_match_jax():
    for step in range(0, 40):
        kw = dict(warmup_steps=7, decay_steps=30, min_ratio=0.1)
        assert rel(tsched.warmup_cosine(step, **kw), jsched.warmup_cosine(step, **kw)) <= 1e-6
        for ramp in (0, 10):
            assert float(tsched.batch_rampup(step, rampup_steps=ramp)) == float(
                jsched.batch_rampup(step, rampup_steps=ramp))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip_active", [True, False])
def test_adamw_update_matches_jax(dtype, clip_active):
    """One AdamW step from nonzero moments (the second step) over a matrix,
    a vector and a 3-D leaf: decay on matrices only, the clip on or off."""
    rng = np.random.default_rng(1)
    shapes = {"w": (4, 3), "b": (3,), "e": (2, 3, 4)}
    p = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    g = {k: (rng.standard_normal(s) * (30.0 if clip_active else 0.01)).astype(np.float32)
         for k, s in shapes.items()}
    m = {k: (rng.standard_normal(s) * 0.1).astype(np.float32) for k, s in shapes.items()}
    v = {k: np.abs(rng.standard_normal(s) * 0.1).astype(np.float32) for k, s in shapes.items()}
    cfg = jopt.AdamWConfig(lr=1e-2, weight_decay=0.1, grad_clip=1.0)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp = {k: jnp.asarray(x, jd) for k, x in p.items()}
    jg = {k: jnp.asarray(x, jd) for k, x in g.items()}
    jst = jopt.AdamWState(jnp.asarray(1, jnp.int32), {k: jnp.asarray(x) for k, x in m.items()},
                          {k: jnp.asarray(x) for k, x in v.items()})
    jp2, jst2, jstats = jopt.adamw_update(cfg, jg, jst, jp, jnp.asarray(0.7, jnp.float32))
    td = getattr(torch, dtype)
    tp = {k: torch.from_numpy(x).to(td) for k, x in p.items()}
    tg = {k: torch.from_numpy(x).to(td) for k, x in g.items()}
    tst = topt.AdamWState(1, {k: torch.from_numpy(x.copy()) for k, x in m.items()},
                          {k: torch.from_numpy(x.copy()) for k, x in v.items()})
    tp2, tst2, tstats = topt.adamw_update(topt.AdamWConfig(*cfg), tg, tst, tp,
                                          torch.tensor(0.7, dtype=torch.float32))
    assert tst2.step == 2 and tp2 is tp  # updated in place
    assert rel(tstats["grad_norm"], jstats["grad_norm"]) <= 1e-6
    assert rel(topt.global_norm(tg), jopt.global_norm(jg)) <= 1e-6
    assert (float(jstats["grad_norm"]) > 1.0) == clip_active
    for k in shapes:
        np.testing.assert_allclose(tst2.m[k].numpy(), np.asarray(jst2.m[k]), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(tst2.v[k].numpy(), np.asarray(jst2.v[k]), rtol=1e-6, atol=1e-12)
        got, want = tp2[k], np.asarray(jp2[k])
        assert got.dtype == td
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
        else:  # at most one bf16 ulp apart
            ulps = np.abs(got.view(torch.int16).numpy().astype(np.int32)
                          - want.view(np.int16).astype(np.int32))
            assert ulps.max() <= 1, (k, ulps)
    # decoupled weight decay reaches matrices only: with a zero gradient and
    # zero moments a vector stays, a matrix shrinks by lr * wd
    z = {"w": torch.ones(2, 2), "b": torch.ones(2)}
    st = topt.init_adamw(z)
    topt.adamw_update(topt.AdamWConfig(lr=0.1, weight_decay=0.5, grad_clip=0.0),
                      {k: torch.zeros_like(t) for k, t in z.items()}, st, z, 1.0)
    assert torch.equal(z["b"], torch.ones(2)) and torch.allclose(z["w"], torch.full((2, 2), 0.95))


def test_losses_and_kd_match_jax():
    rng = np.random.default_rng(2)
    s = rng.standard_normal((2, 5, 512)).astype(np.float32) * 3
    t = rng.standard_normal((2, 5, 512)).astype(np.float32) * 3
    labels = rng.integers(0, 512, (2, 5)).astype(np.int32)
    assert rel(ttrain.cross_entropy(torch.from_numpy(s), torch.from_numpy(labels)),
               jtrain.cross_entropy(s, labels)) <= 1e-6
    for tau in (1.0, 2.0):
        assert rel(tdist.kd_kl(torch.from_numpy(s), torch.from_numpy(t), tau),
                   jdist.kd_kl(s, t, tau)) <= 1e-6
    assert float(tdist.kd_kl(torch.from_numpy(s), torch.from_numpy(s), 1.0)) == pytest.approx(0, abs=1e-6)
    for stop in (-1, 0, 3):
        kdc, jkdc = tdist.KDConfig(alpha=0.5, kd_stop_step=stop), jdist.KDConfig(alpha=0.5, kd_stop_step=stop)
        for step in range(6):
            assert float(tdist.kd_alpha(kdc, step)) == float(jdist.kd_alpha(jkdc, jnp.asarray(step)))
    assert ttrain.moe_aux_coef(get_config(ARCH)) == jtrain.moe_aux_coef(jax_get_config(ARCH)) == 0.01


@pytest.mark.parametrize("arch", ["nlg-350m-prmoe-32-64", "nlg-1.3b-prmoe-64-128", "nlg-350m-moe128"])
def test_make_student_config_matches_jax(arch):
    got = tdist.make_student_config(get_config(arch))
    want = jdist.make_student_config(jax_get_config(arch))
    assert got.name == want.name and got.num_layers == want.num_layers == 21
    assert [(len(s.pattern), s.repeats, [ls.ffn.num_experts for ls in s.pattern])
            for s in got.segments] == [(len(s.pattern), s.repeats,
                                        [ls.ffn.num_experts for ls in s.pattern])
                                       for s in want.segments]


def test_batches_and_data_stream_match_jax():
    a = tsyn.batches(97, 3, 11, seed=4, start_step=2)
    b = jsyn.batches(97, 3, 11, seed=4, start_step=2)
    for _ in range(3):
        (ta, la), (tb, lb) = next(a), next(b)
        np.testing.assert_array_equal(ta, tb)
        np.testing.assert_array_equal(la, lb)
    assert tsyn.MarkovLM(50, 1).conditional_entropy() == jsyn.MarkovLM(50, 1).conditional_entropy()
    ts, js = tpipe.data_stream(97, 2, 9, seed=1, device="cpu"), jpipe.data_stream(97, 2, 9, seed=1)
    for _ in range(2):
        (tt, tl), (jt, jl) = next(ts), next(js)
        assert tt.dtype == torch.int64 and tt.device.type == "cpu"
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


# ---------------------------------------------------------------------------
# kernel 1b's plain version (capacity gating's backward)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K,normalize,cap", [(1, True, 4), (2, True, 3), (2, False, 3), (3, True, 16)])
def test_gating_backward_matches_autograd_and_jax(K, normalize, cap):
    """d logits from the gradients of combine_w and probs: through
    ``gating`` (the autograd function, 1b's plain version here), torch
    autograd of ``top_k_gating``, and ``jax.grad`` of JAX's ``top_k_gating``;
    the capacities drop slots."""
    T, E = 24, 6
    rng = np.random.default_rng(K + cap)
    logits = rng.standard_normal((T, E)).astype(np.float32)
    logits[:, 0] += 1.0  # crowd expert 0 past its capacity
    w1 = rng.standard_normal((T, K)).astype(np.float32)
    w2 = rng.standard_normal((T, E)).astype(np.float32)

    def port(fn):
        lg = torch.from_numpy(logits).requires_grad_()
        out = fn(lg)
        g = out if isinstance(out, tgating.Gating) else out[0]
        loss = (g.combine_w * torch.from_numpy(w1)).sum() + (g.probs * torch.from_numpy(w2)).sum()
        return torch.autograd.grad(loss, lg)[0].numpy(), g

    got, g = port(lambda lg: k1.gating(lg, K, cap, normalize=normalize))
    if cap <= 4:
        assert (~g.keep).any()  # the small capacities drop slots
    ref, _ = port(lambda lg: tgating.top_k_gating(lg, K, cap, normalize=normalize))

    def jloss(lg):
        jg = jgating.top_k_gating(lg, K, cap, normalize=normalize)
        return jnp.sum(jg.combine_w * w1) + jnp.sum(jg.probs * w2)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(logits)))
    for other in (ref, want):
        assert np.abs(got - other).max() <= 1e-6 * np.abs(other).max()
    # the plain version called directly, with no probs gradient
    direct = k1.gating_backward_plain(g.probs.detach(), g.expert_idx, g.keep, torch.from_numpy(w1),
                                      None, normalize=normalize)
    lg = torch.from_numpy(logits).requires_grad_()
    rg = tgating.top_k_gating(lg, K, cap, normalize=normalize)
    d = torch.autograd.grad((rg.combine_w * torch.from_numpy(w1)).sum(), lg)[0]
    torch.testing.assert_close(direct, d, atol=1e-6, rtol=0)


def test_routing_stats_and_summary_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((40, 8)).astype(np.float32)
    tg = tgating.top_k_gating(torch.from_numpy(logits), 2, 8)
    jg = jgating.top_k_gating(jnp.asarray(logits), 2, 8)
    ts, js = tgating.routing_stats(tg, 8), jgating.routing_stats(jg, 8)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    stack = lambda st, n: type(st)(*(np.stack([np.asarray(x)] * n) for x in st))
    tsum = tgating.summarize_routing({"seg0": {"pos1": tgating.stack_stats([ts, ts])}})
    jsum = jgating.summarize_routing({"seg0": {"pos1": stack(js, 2)}})
    assert tsum["per_layer"].keys() == jsum["per_layer"].keys()
    assert tsum["moe_layers"] == jsum["moe_layers"] == 2
    for key in ("dropped_frac", "entropy", "imbalance"):
        assert tsum[key] == pytest.approx(jsum[key], rel=1e-6)
    z = torch.from_numpy(logits)
    assert rel(tgating.router_z_loss(z), jgating.router_z_loss(logits)) <= 1e-6


# ---------------------------------------------------------------------------
# the model under grad: loss_fn, train and distill steps, remat, train_loop
# ---------------------------------------------------------------------------


def test_loss_and_every_gradient_match_jax(pair):
    impl, jcfg, tcfg, jparams = pair
    toks, labels = batch(tcfg.vocab_size)
    (jl, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtrain.loss_fn(jcfg, p, toks, labels), has_aux=True))(jparams)
    tparams = port_params(tcfg, jparams)
    leaves = tm.trainable(tparams)
    assert list(leaves) == list(flat(jparams))  # the JAX tree's order
    with torch.enable_grad():
        loss, met = ttrain.loss_fn(tcfg, tparams, torch.from_numpy(toks).long(),
                                   torch.from_numpy(labels).long())
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert rel(loss.detach(), jl) <= 1e-5 and rel(met["ce"].detach(), jmet["ce"]) <= 1e-5
    assert rel(met["aux"].detach(), jmet["aux"]) <= 1e-5
    for key, want in flat(jgrads).items():
        want = np.asarray(want)
        err = np.abs(np32(grads[key]) - want).max() / max(np.abs(want).max(), 1e-30)
        assert err <= 1e-4, f"{impl} {key}: {err:.3e} of the leaf's largest"


def test_train_steps_match_jax(pair):
    impl, jcfg, tcfg, jparams = pair
    tc = ttrain.TrainConfig(lr=LR, warmup_steps=1, decay_steps=STEPS)
    jtc = jtrain.TrainConfig(lr=LR, warmup_steps=1, decay_steps=STEPS)
    jstep = jax.jit(jtrain.make_train_step(jcfg, jtc))
    tstep = ttrain.make_train_step(tcfg, tc)
    tparams = port_params(tcfg, jparams)
    jst, tst = jopt.init_adamw(jparams), topt.init_adamw(tm.trainable(tparams))
    jp = jparams
    for step in range(STEPS):
        toks, labels = batch(tcfg.vocab_size, step)
        jp, jst, jmet = jstep(jp, jst, toks, labels)
        tparams, tst, tmet = tstep(tparams, tst, torch.from_numpy(toks).long(),
                                   torch.from_numpy(labels).long())
        for key in ("loss", "ce", "aux", "grad_norm", "lr_scale"):
            assert rel(tmet[key].detach(), jmet[key]) <= 1e-5, (step, key, float(tmet[key]), float(jmet[key]))
    assert tst.step == int(jst.step) == STEPS
    worst = assert_params_close(tparams, jp)
    moved = max(np.abs(np.asarray(v) - np.asarray(flat(jparams)[k])).max() for k, v in flat(jp).items())
    assert moved > 10 * worst  # the steps moved the weights further than the packages part


def test_distill_step_matches_jax():
    """One staged-KD step of the reduced MoS student from a reduced PR-MoE
    teacher, and a second past kd_stop_step (α = 0)."""
    jt, tt = jax_make_reduced(jax_get_config(ARCH)), make_reduced(get_config(ARCH))
    js, ts = jax_make_reduced(jax_get_config(MOS)), make_reduced(get_config(MOS))
    jteach = jax.jit(lambda k: jm.init_params(jt, k))(jax.random.PRNGKey(1))
    jstud = jax.jit(lambda k: jm.init_params(js, k))(jax.random.PRNGKey(2))
    tteach, tstud = port_params(tt, jteach), port_params(ts, jstud)
    tc = ttrain.TrainConfig(lr=LR, warmup_steps=1, decay_steps=4)
    jtc = jtrain.TrainConfig(lr=LR, warmup_steps=1, decay_steps=4)
    kdc, jkdc = tdist.KDConfig(alpha=0.7, kd_stop_step=1), jdist.KDConfig(alpha=0.7, kd_stop_step=1)
    jstep = jax.jit(jdist.make_distill_step(js, jt, jtc, jkdc))
    tstep = tdist.make_distill_step(ts, tt, tc, kdc)
    jst, tst = jopt.init_adamw(jstud), topt.init_adamw(tm.trainable(tstud))
    for step, alpha in enumerate((0.7, 0.0)):
        toks, labels = batch(ts.vocab_size, step, seed=3)
        jstud, jst, jmet = jstep(jstud, jst, jteach, toks, labels)
        tstud, tst, tmet = tstep(tstud, tst, tteach, torch.from_numpy(toks).long(),
                                 torch.from_numpy(labels).long())
        assert float(tmet["kd_alpha"]) == float(jmet["kd_alpha"]) == pytest.approx(alpha)
        for key in ("loss", "ce", "kl", "aux", "grad_norm"):
            assert rel(tmet[key], jmet[key]) <= 1e-5, (step, key)
    assert not any(t.requires_grad for t in tm.param_leaves(tteach).values())
    assert_params_close(tstud, jstud)


def test_unused_leaf_gets_a_zero_gradient_and_is_decayed_as_in_jax():
    """Reduced internvl2-1b trained two steps on text alone: the loss never
    reaches ``frontend_proj`` (it projects prefix embeddings), so JAX gives
    it a zero gradient and AdamW only decays it; the port's step does the
    same instead of raising."""
    arch = "internvl2-1b"
    jcfg, tcfg = jax_make_reduced(jax_get_config(arch)), make_reduced(get_config(arch))
    assert jcfg.param_dtype == tcfg.param_dtype == "float32"
    jparams = jax.jit(lambda k: jm.init_params(jcfg, k))(jax.random.PRNGKey(0))
    tparams = port_params(tcfg, jparams)
    toks, labels = next(jpipe.data_stream(jcfg.vocab_size, 2, 16, seed=0))
    toks, labels = np.array(toks), np.array(labels)
    tc = ttrain.TrainConfig(lr=1e-3, warmup_steps=1, decay_steps=10)
    jtc = jtrain.TrainConfig(lr=1e-3, warmup_steps=1, decay_steps=10)
    jstep = jax.jit(jtrain.make_train_step(jcfg, jtc))
    tstep = ttrain.make_train_step(tcfg, tc)
    jst, tst = jopt.init_adamw(jparams), topt.init_adamw(tm.trainable(tparams))
    jp = jparams
    for _ in range(2):
        jp, jst, jmet = jstep(jp, jst, toks, labels)
        tparams, tst, tmet = tstep(tparams, tst, torch.from_numpy(toks).long(),
                                   torch.from_numpy(labels).long())
    assert float(jmet["loss"]) == pytest.approx(6.2182, abs=1e-4)
    assert rel(tmet["loss"], jmet["loss"]) <= 1e-5
    got = np32(tm.param_leaves(tparams)["frontend_proj"])
    want, start = np.asarray(flat(jp)["frontend_proj"]), np.asarray(flat(jparams)["frontend_proj"])
    assert got.shape == (32, 128)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    assert not np.array_equal(want, start)  # decayed, though its gradient is 0
    np.testing.assert_allclose(tst.m["frontend_proj"].numpy(), 0.0, atol=0)


def test_remat_gives_the_same_loss_and_grads():
    tcfg = make_reduced(get_config(ARCH))
    tparams = tm.init_params(tcfg, seed=0, device="cpu")
    leaves = tm.trainable(tparams)
    toks, labels = (torch.from_numpy(x).long() for x in batch(tcfg.vocab_size))
    out = []
    for remat in (False, True):
        with torch.enable_grad():
            loss, _ = ttrain.loss_fn(tcfg, tparams, toks, labels, remat=remat)
        out.append((loss.detach(), torch.autograd.grad(loss, list(leaves.values()))))
    torch.testing.assert_close(out[0][0], out[1][0], atol=0, rtol=0)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)


def test_bf16_backward_switch_keeps_loss_and_grads():
    """``grad_cast`` (``set_bf16_bwd``): an identity whose backward casts the
    gradient to the primal's type, at every layer boundary; in f32 the loss
    and gradients are unchanged."""
    x = torch.ones(3, dtype=torch.bfloat16, requires_grad=True)
    y = ttr.grad_cast(x)
    assert torch.equal(y.detach(), x.detach())
    (g,) = torch.autograd.grad(y.float().sum() * 3.0, x)
    assert g.dtype == torch.bfloat16 and torch.equal(g, torch.full((3,), 3.0, dtype=torch.bfloat16))
    tcfg = make_reduced(get_config(ARCH))
    tparams = tm.init_params(tcfg, seed=1, device="cpu")
    leaves = tm.trainable(tparams)
    toks, labels = (torch.from_numpy(x).long() for x in batch(tcfg.vocab_size))
    res = []
    for on in (False, True):
        ttr.set_bf16_bwd(on)
        try:
            with torch.enable_grad():
                loss, _ = ttrain.loss_fn(tcfg, tparams, toks, labels)
            res.append(torch.autograd.grad(loss, list(leaves.values())))
        finally:
            ttr.set_bf16_bwd(False)
    for a, b in zip(*res):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_forward_routing_matches_jax(pair):
    impl, jcfg, tcfg, jparams = pair
    toks, _ = batch(tcfg.vocab_size)
    _, _, jr = jax.jit(lambda p, t: jm.forward(jcfg, p, t, return_routing=True))(jparams, toks)
    with torch.no_grad():
        _, _, tr = tm.forward(tcfg, port_params(tcfg, jparams), torch.from_numpy(toks).long(),
                              return_routing=True)
    assert tr.keys() == jr.keys() and all(tr[s].keys() == jr[s].keys() for s in tr)
    for s in tr:
        for p in tr[s]:
            np.testing.assert_array_equal(tr[s][p].tokens_per_expert.numpy(),
                                          np.asarray(jr[s][p].tokens_per_expert))
            np.testing.assert_allclose(tr[s][p].imbalance.numpy(), np.asarray(jr[s][p].imbalance),
                                       rtol=1e-5)


def test_train_loop_reduces_loss_with_jax_routing_rows():
    """``train_loop(routing_stats=True)`` from the JAX tree's weights and the
    JAX stream's batches: the loss falls, and the logged rows (loss, and the
    routing summary: tokens per expert, dropped share) are JAX's."""
    jcfg = jax_make_reduced(jax_get_config(ARCH)).replace(vocab_size=128)
    tcfg = make_reduced(get_config(ARCH)).replace(vocab_size=128)
    jparams = jax.jit(lambda k: jm.init_params(jcfg, k))(jax.random.PRNGKey(5))
    tc = ttrain.TrainConfig(lr=3e-3, warmup_steps=2, decay_steps=12)
    jtc = jtrain.TrainConfig(lr=3e-3, warmup_steps=2, decay_steps=12)
    jlog, tlog = [], []
    _, _, jh = jtrain.train_loop(jcfg, jtc, jpipe.data_stream(128, 8, 32, seed=2), 12,
                                 params=jparams, log_every=4, log_fn=jlog.append,
                                 routing_stats=True)
    _, _, th = ttrain.train_loop(tcfg, tc, tpipe.data_stream(128, 8, 32, seed=2, device="cpu"), 12,
                                 params=port_params(tcfg, jparams), log_every=4,
                                 log_fn=tlog.append, routing_stats=True, device="cpu")
    assert [r["step"] for r in th] == [r["step"] for r in jh] == [0, 4, 8, 11]
    assert th[-1]["loss"] < th[0]["loss"] - 0.1
    for a, b in zip(th, jh):
        assert rel(a["loss"], b["loss"]) <= 1e-4
        assert a["routing"]["per_layer"].keys() == b["routing"]["per_layer"].keys()
        for layer, ra in a["routing"]["per_layer"].items():
            rb = b["routing"]["per_layer"][layer]
            assert ra["tokens_per_expert"] == rb["tokens_per_expert"]
            assert ra["dropped_frac"] == pytest.approx(rb["dropped_frac"], abs=1e-7)
    assert all(line.startswith("step") and "drop" in line for line in tlog)


def test_train_loop_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.train_loop(make_reduced(get_config(ARCH)), ttrain.TrainConfig(), iter(()), 1)


# ---------------------------------------------------------------------------
# checkpoints and the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_bytes_equal_jax_and_load_both_ways(dtype, tmp_path):
    jcfg = jax_make_reduced(jax_get_config(ARCH)).replace(param_dtype=dtype)
    tcfg = make_reduced(get_config(ARCH)).replace(param_dtype=dtype)
    shapes = jax.eval_shape(lambda: jm.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(6)
    jparams = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(a.dtype), shapes)
    tparams = port_params(tcfg, jparams)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jckpt.save(str(jdir), jparams, step=7)
    n = tckpt.save(str(tdir), tparams, step=7)
    files = sorted(os.listdir(jdir))
    assert files == sorted(os.listdir(tdir)) and "manifest.json" in files
    assert n == sum(os.path.getsize(tdir / f) for f in files if f.endswith(".npy"))
    for f in files:
        assert (jdir / f).read_bytes() == (tdir / f).read_bytes(), f
    # each side loads the other's
    back, step = tckpt.load(str(jdir), tparams)
    assert step == 7 and isinstance(back, tm.ParamTree)
    for k, t in tm.param_leaves(back).items():
        assert t.dtype == tm.param_leaves(tparams)[k].dtype
        assert torch.equal(t, tm.param_leaves(tparams)[k])
    if dtype == "float32":
        jback, jstep = jckpt.load(str(tdir), jparams)
        assert jstep == 7
        for k, v in flat(jback).items():
            np.testing.assert_array_equal(np.asarray(v), np.asarray(flat(jparams)[k]))
    else:
        # the JAX package's load reads a bf16 leaf back as 2-byte records it
        # cannot cast (numpy without ml_dtypes' type in the header): it
        # refuses its own files and the port's alike (the bytes are equal)
        for d in (jdir, tdir):
            with pytest.raises(ValueError, match="cast"):
                jckpt.load(str(d), jparams)
    loaded = convert.load_checkpoint(str(tdir), tcfg, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(tm.param_leaves(loaded).values(),
                                                 tm.param_leaves(tparams).values()))
    # params_to_numpy: the other direction of params_from_numpy
    out = convert.params_to_numpy(tparams, bf16=ml_dtypes.bfloat16)
    for k, v in flat(out).items():
        np.testing.assert_array_equal(v.view(np.uint8), np.asarray(flat(jparams)[k]).view(np.uint8))
    with pytest.raises(ValueError, match="missing"):
        tckpt.load(str(tdir), tm.init_params(make_reduced(get_config("glm4-9b")), device="cpu"))


def test_launch_train_cli_on_cpu(tmp_path, capsys):
    tlaunch.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "3", "--batch", "2",
                  "--seq", "16", "--moe-impl", "ep", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "final loss:" in out and "saved checkpoint" in out and out.count("step ") == 2
    manifest = json.loads((tmp_path / "params" / "manifest.json").read_text())
    assert manifest["step"] == 3 and manifest["leaves"][0]["key"] == "embed"
    assert len(json.loads((tmp_path / "history.json").read_text())) == 2
