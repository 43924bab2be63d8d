"""The backward of the SwiGLU expert MLP (kernels 2b and 4b) on the CPU:
the plain backwards ``expert_mlp_backward_plain`` and
``grouped_mlp_backward_plain`` against ``jax.vjp`` of the JAX package's
``experts_ffn`` and ``grouped_mlp_ref`` and against torch autograd of the
port's plain forwards, on the same numpy inputs, f32; dead rows and
experts; and ``moe_layer`` under grad taking ``ExpertMlpFn`` /
``GroupedMlpFn``.

Tolerances: against JAX, rtol 1e-5 / atol 1e-6 (the plain backward sums in
f64, so only JAX's own f32 sums of at most 48 terms part the two; the
formulas equal the einsums' derivatives exactly); against torch autograd
of the plain forwards, rtol 1e-5 and an atol of 1e-6 of each tensor's
largest value (autograd's f32 sums of up to 32 rows of values up to about
5 cancel to a few ulps of that value where a gradient is near 0).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import moe as jmoe
from repro.kernels import expert_mlp_grouped as jgk
from repro_torch.configs.registry import get_config, make_reduced
from repro_torch.core import moe as tmoe
from repro_torch.kernels import expert_mlp as k2
from repro_torch.kernels import expert_mlp_grouped as gk
from repro_torch.models.model import init_params
from _torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

E, C, D, F = 4, 16, 32, 48
RTOL, ATOL = 1e-5, 1e-6
FILL = [16, 11, 0, 5]  # expert 2 has no row; rows past fill are zero, as the dispatch leaves them


def weights(seed):
    rng = np.random.default_rng(seed)
    w = lambda *s: (rng.standard_normal(s) / np.sqrt(s[-2])).astype(np.float32)
    return w(E, D, F), w(E, D, F), w(E, F, D)


def capacity_inputs(seed=0):
    rng = np.random.default_rng(seed + 10)
    xe = rng.standard_normal((E, C, D)).astype(np.float32)
    for e, n in enumerate(FILL):
        xe[e, n:] = 0.0
    dy = rng.standard_normal((E, C, D)).astype(np.float32)
    return xe, dy


# 7 tiles: experts 0, 0, 1, 3, 3 live (expert 2 has none), then 2 dead
# tiles clamped to expert E-1 with zero rows, as the dispatch lays them out
TE = np.array([0, 0, 1, 3, 3, 3, 3], np.int32)
LIVE_TILES = 5


def grouped_inputs(seed=0):
    rng = np.random.default_rng(seed + 20)
    xg = rng.standard_normal((len(TE) * 8, D)).astype(np.float32)
    xg[LIVE_TILES * 8:] = 0.0
    dy = rng.standard_normal(xg.shape).astype(np.float32)
    return xg, dy


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def close_f32(got, want):
    """Against an f32 autograd result: atol 1e-6 of its largest value."""
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL * max(1.0, want.abs().max().item()))


def test_capacity_backward_plain_matches_jax_vjp():
    wi, wg, wo = weights(0)
    xe, dy = capacity_inputs()
    f = lambda x, a, b, c: jmoe.experts_ffn({"wi": a, "wg": b, "wo": c}, x, "swiglu")
    _, vjp = jax.vjp(f, xe, wi, wg, wo)
    want = vjp(jnp.asarray(dy))
    got = k2.expert_mlp_backward_plain(t(xe), t(wi), t(wg), t(wo), t(dy),
                                       torch.tensor(FILL, dtype=torch.int32))
    for g, w in zip(got, want):
        close(g, w)


def test_grouped_backward_plain_matches_jax_vjp():
    wi, wg, wo = weights(1)
    xg, dy = grouped_inputs()
    f = lambda x, a, b, c: jgk.grouped_mlp_ref(x, jnp.asarray(TE), a, b, c)
    _, vjp = jax.vjp(f, xg, wi, wg, wo)
    want = vjp(jnp.asarray(dy))
    got = gk.grouped_mlp_backward_plain(t(xg), t(TE), t(wi), t(wg), t(wo), t(dy),
                                        torch.tensor([LIVE_TILES * 8], dtype=torch.int32))
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("layout", ["capacity", "grouped"])
def test_backward_plain_matches_autograd_of_the_plain_forward(layout):
    wi, wg, wo = (t(w).requires_grad_() for w in weights(2))
    if layout == "capacity":
        xe, dy = capacity_inputs(2)
        x = t(xe).requires_grad_()
        fill = torch.tensor(FILL, dtype=torch.int32)
        y = k2.expert_mlp_plain(x, wi, wg, wo, fill)
        got = k2.expert_mlp_backward_plain(x.detach(), wi.detach(), wg.detach(), wo.detach(),
                                           t(dy), fill)
    else:
        xg, dy = grouped_inputs(2)
        x = t(xg).requires_grad_()
        rows = torch.tensor([LIVE_TILES * 8], dtype=torch.int32)
        y = gk.grouped_mlp_plain(x, t(TE), wi, wg, wo, rows)
        got = gk.grouped_mlp_backward_plain(x.detach(), t(TE), wi.detach(), wg.detach(),
                                            wo.detach(), t(dy), rows)
    want = torch.autograd.grad(y, (x, wi, wg, wo), t(dy))
    for g, w in zip(got, want):
        close_f32(g, w)


def test_dead_rows_and_empty_experts_get_exact_zeros():
    """Rows past fill (capacity) or past rows_used (grouped) get dx = 0
    whatever they hold, and an expert no live row reaches gets dW = 0
    exactly; the grouped buffer's dead tiles, clamped to expert E-1, add
    nothing to its gradients."""
    wi, wg, wo = (t(w) for w in weights(3))
    rng = np.random.default_rng(3)
    xe = t(rng.standard_normal((E, C, D)).astype(np.float32))  # nonzero past fill too
    dy = t(rng.standard_normal((E, C, D)).astype(np.float32))
    fill = torch.tensor([20, 11, 0, 5], dtype=torch.int32)  # 20: an overflowing count, cut to C
    dx, dwi, dwg, dwo = k2.expert_mlp_backward_plain(xe, wi, wg, wo, dy, fill)
    for e, n in enumerate((16, 11, 0, 5)):
        assert torch.count_nonzero(dx[e, n:]) == 0 and torch.count_nonzero(dx[e, :n]) == n * D
    for g in (dwi, dwg, dwo):
        assert torch.count_nonzero(g[2]) == 0 and all(torch.count_nonzero(g[e]) > 0 for e in (0, 1, 3))
    xg = t(rng.standard_normal((len(TE) * 8, D)).astype(np.float32))
    dyg = t(rng.standard_normal(xg.shape).astype(np.float32))
    rows = torch.tensor([LIVE_TILES * 8], dtype=torch.int32)
    dx, dwi, dwg, dwo = gk.grouped_mlp_backward_plain(xg, t(TE), wi, wg, wo, dyg, rows)
    assert torch.count_nonzero(dx[LIVE_TILES * 8:]) == 0
    for g in (dwi, dwg, dwo):
        assert torch.count_nonzero(g[2]) == 0
    # expert 3's gradients come from its two live tiles alone
    live3 = gk.grouped_mlp_backward_plain(xg[:LIVE_TILES * 8], t(TE[:LIVE_TILES]), wi, wg, wo,
                                          dyg[:LIVE_TILES * 8])
    for g, w in zip((dwi, dwg, dwo), live3[1:]):
        torch.testing.assert_close(g[3], w[3], atol=0, rtol=0)


def test_backward_variant_and_tables():
    """The tensor-core rule (bf16 with D and F multiples of 128: the wgmma
    passes) and the table and scratch sizes, as the library computes
    them."""
    assert gk.backward_variant(torch.bfloat16, 5120, 8192) == "wgmma"
    assert gk.backward_variant(torch.bfloat16, 7168, 2048) == "wgmma"
    assert gk.backward_variant(torch.bfloat16, 128, 96) == "fma"
    assert gk.backward_variant(torch.float32, 5120, 8192) == "fma"
    # llama4's capacity buffer at 2048 tokens over 16 experts: C = 160
    assert gk.backward_max_runs(16 * 160 // 8, 16) == 56
    assert gk.backward_max_runs(3, 16) == 3 and gk.backward_max_runs(1, 1) == 1
    assert gk.backward_max_windows(16 * 160 // 8, 16) == 29
    assert gk.backward_max_windows(3, 16) == 3 and gk.backward_max_windows(1, 1) == 1
    assert gk.backward_packed_rows(16 * 160 // 8, 16) == 2560 + 56 * 16
    assert gk.backward_table_size(7, 4) == 3 * 7 + 3 * 5 + 3 * 5 + 3 * 4 + (56 + 4 * 56) + 3
    assert gk.backward_scratch_size(7, 4, 256, 384) == (56 + 4 * 56) * (3 * 384 + 2 * 256)


def counting(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("impl", ["ep", "grouped"])
def test_moe_layer_under_grad_takes_the_autograd_functions(monkeypatch, impl):
    """Reduced llama4-maverick's MoE layer under grad on the CPU: the
    experts' gradients come from the plain backward of 2b (``ep``, the
    capacity table without a mesh) or 4b (``grouped``), once per call, and
    equal autograd through the plain forward."""
    cfg = make_reduced(get_config("llama4-maverick-400b-a17b")).replace(moe_impl=impl)
    params = init_params(cfg, seed=0, device="cpu")
    spec = next(ls.ffn for ls in cfg.layer_specs() if ls.ffn.kind == "moe")
    moe = {k: v for k, v in params["segments"]["seg0"]["pos1"]["moe"].items()}
    moe = {k: (v[0] if torch.is_tensor(v) else {kk: vv[0] for kk, vv in v.items()})
           for k, v in moe.items()}
    leaves = [moe["wi"], moe["wg"], moe["wo"]]
    for w in leaves:
        w.requires_grad_()
    x = torch.randn((2, 8, cfg.d_model), generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    module, name = (k2, "expert_mlp_backward_plain") if impl == "ep" else \
        (gk, "grouped_mlp_backward_plain")
    calls = counting(monkeypatch, module, name)
    with torch.enable_grad():
        y, aux = tmoe.moe_layer(cfg, spec, moe, x)
        got = torch.autograd.grad((y * y).sum() + aux, [x, *leaves])
    assert len(calls) == 1
    fn = k2.ExpertMlpFn if impl == "ep" else gk.GroupedMlpFn
    with torch.enable_grad():
        y2, _ = tmoe.moe_layer(cfg, spec, moe, x)
    assert y2.grad_fn is not None
    # autograd through the plain forwards gives the same gradients
    monkeypatch.setattr(fn, "apply", staticmethod(
        (lambda xe, wi, wg, wo, fill: k2.expert_mlp_plain(xe, wi, wg, wo, fill)) if impl == "ep"
        else (lambda xg, te, wi, wg, wo, rows: gk.grouped_mlp_plain(xg, te, wi, wg, wo, rows))))
    with torch.enable_grad():
        y3, aux3 = tmoe.moe_layer(cfg, spec, moe, x)
        want = torch.autograd.grad((y3 * y3).sum() + aux3, [x, *leaves])
    assert len(calls) == 1
    torch.testing.assert_close(y3, y, atol=0, rtol=0)
    for g, w in zip(got, want):
        close_f32(g, w)
