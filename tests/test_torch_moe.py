"""Port parity: gating, grouped dispatch, the grouped expert MLP's plain
version and the MoE layer (``repro_torch.core``, ``repro_torch.kernels``)
against the JAX package, in f32 on the CPU.

Tolerances: integer outputs (expert ids, positions, layouts) are exact; f32
gate weights agree to 1e-6 (one softmax, one division); expert outputs to
1e-5 (f32 products over at most 64-wide contractions, summed in another
order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FFNSpec as JFFNSpec
from repro.core import dispatch_grouped as jdg
from repro.core import gating as jgating
from repro.core import moe as jmoe
from repro.kernels import expert_mlp_grouped as jk
from repro_torch.configs.base import FFNSpec
from repro_torch.core import dispatch_grouped as tdg
from repro_torch.core import gating as tgating
from repro_torch.core import moe as tmoe
from repro_torch.kernels import expert_mlp_grouped as tk
from test_grouped import make, tiny_cfg

TOL = dict(atol=1e-5, rtol=1e-5)


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def logits_with_ties(T, E, seed):
    """Router logits rounded to a coarse grid so equal probabilities (ties
    between experts) occur in most rows."""
    rng = np.random.default_rng(seed)
    return np.round(rng.standard_normal((T, E)), 1).astype(np.float32)


@pytest.mark.parametrize("K", [1, 2])
def test_top_k_gating(K):
    T, E = 40, 8
    logits = logits_with_ties(T, E, K)
    for capacity in (T * K, 6):  # dropless, and one that drops
        j = jgating.top_k_gating(jnp.asarray(logits), K, capacity)
        g = tgating.top_k_gating(t(logits), K, capacity)
        np.testing.assert_array_equal(g.expert_idx.numpy(), np.asarray(j.expert_idx))
        np.testing.assert_array_equal(g.position.numpy(), np.asarray(j.position))
        np.testing.assert_array_equal(g.keep.numpy(), np.asarray(j.keep))
        np.testing.assert_allclose(g.combine_w.numpy(), np.asarray(j.combine_w), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(
        tgating.load_balance_loss(g.probs, g.expert_idx, E).item(),
        float(jgating.load_balance_loss(j.probs, j.expert_idx, E)), rtol=1e-6)


@pytest.mark.parametrize("K,skew", [(2, 0.0), (1, 50.0), (2, 50.0)])
def test_grouped_layout(K, skew):
    """dst / tile_expert / counts exact, on the routing of
    tests/test_grouped.py::make, including its total skew toward expert 0."""
    _, _, params, x, jg = make(T=24, E=8, K=K, skew=skew)
    logits = np.array(x.astype(jnp.float32) @ params["router"])
    logits[:, 0] += skew
    g = tgating.top_k_gating(t(logits), K, 24 * K)
    np.testing.assert_array_equal(g.expert_idx.numpy(), np.asarray(jg.expert_idx))
    jl = jdg.grouped_layout(jg, 8)
    tl = tdg.grouped_layout(g, 8)
    np.testing.assert_array_equal(tl.dst.numpy(), np.asarray(jl.dst))
    np.testing.assert_array_equal(tl.tile_expert.numpy(), np.asarray(jl.tile_expert))
    np.testing.assert_array_equal(tl.counts.numpy(), np.asarray(jl.counts))
    padded = (np.asarray(jl.counts) + 7) // 8 * 8
    assert tl.rows_used.item() == padded.sum()


def grouped_inputs(seed, E=4, D=32, F=64, T=12, K=2):
    """A dispatch layout and weights for the grouped MLP, from numpy."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((T, E)).astype(np.float32)
    g = tgating.top_k_gating(t(logits), K, T * K)
    layout = tdg.grouped_layout(g, E)
    Ct = layout.tile_expert.shape[0] * tdg.GROUPED_TILE
    xg = np.zeros((Ct, D), np.float32)
    xg[layout.dst.numpy()] = rng.standard_normal((T * K, D)).astype(np.float32)
    w = {n: (rng.standard_normal(s) / np.sqrt(s[1])).astype(np.float32)
         for n, s in (("wi", (E, D, F)), ("wg", (E, D, F)), ("wo", (E, F, D)))}
    return xg, layout, w


@pytest.mark.parametrize("seed", [0, 1])
def test_grouped_mlp_plain_vs_jax(seed):
    """The plain version against the JAX oracle and the Pallas kernel run in
    interpret mode, on the same inputs."""
    xg, layout, w = grouped_inputs(seed)
    te = layout.tile_expert.numpy()
    jargs = (jnp.asarray(xg), jnp.asarray(te), *(jnp.asarray(w[n]) for n in ("wi", "wg", "wo")))
    ref = np.asarray(jk.grouped_mlp_ref(*jargs))
    kern = np.asarray(jk.grouped_mlp_kernel(*jargs, interpret=True))
    targs = (t(xg), layout.tile_expert, t(w["wi"]), t(w["wg"]), t(w["wo"]))
    for rows_used in (None, layout.rows_used):
        out = tk.grouped_mlp_plain(*targs, rows_used=rows_used).numpy()
        np.testing.assert_allclose(out, ref, **TOL)
        np.testing.assert_allclose(out, kern, **TOL)


def test_wrapper_on_cpu_takes_the_plain_version():
    xg, layout, w = grouped_inputs(2)
    args = (t(xg), layout.tile_expert, t(w["wi"]), t(w["wg"]), t(w["wo"]), layout.rows_used)
    before = dict(tk.launches)
    out = tk.grouped_mlp(*args)
    assert tk.launches == before and tk.launches["grouped_mlp"] == 0
    torch.testing.assert_close(out, tk.grouped_mlp_plain(*args), rtol=0, atol=0)


@pytest.mark.parametrize("K,residual", [(1, True), (2, False)])
def test_moe_layer_grouped(K, residual):
    """moe_layer(impl="grouped") with and without the Residual-MoE branch,
    JAX parameters converted leaf for leaf."""
    jcfg = tiny_cfg()
    from repro_torch.configs.base import ModelConfig

    tcfg = ModelConfig(name="t", family="moe", source="x", d_model=32, num_heads=2,
                       num_kv_heads=2, head_dim=16, vocab_size=64, segments=(),
                       param_dtype="float32", compute_dtype="float32")
    kw = dict(kind="moe", d_ff=64, num_experts=8, top_k=K, capacity_factor=1.25,
              residual=residual, residual_d_ff=48)
    jspec, tspec = JFFNSpec(**kw), FFNSpec(**kw)
    jp = jmoe.init_moe(jax.random.PRNGKey(K), jcfg, jspec, jnp.float32)
    tp = jax.tree.map(lambda a: t(np.asarray(a)), jp)
    x = np.random.default_rng(K).standard_normal((2, 9, 32)).astype(np.float32)
    # jitted: one compile of the layer costs less than compiling its ops one by one
    jy, jaux = jax.jit(lambda p, x: jmoe.moe_layer(jcfg, jspec, p, x, impl="grouped"))(jp, jnp.asarray(x))
    ty, taux = tmoe.moe_layer(tcfg, tspec, tp, t(x), impl="grouped")
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-6)


def test_unported_dispatch_raises():
    """Expert parallelism is not ported, and the port has no mesh: its names
    resolve as the JAX package resolves them without one ("ep" and
    "ep_serve" give the dense mapping table's output, "ep_grouped" the
    grouped kernel's), and a name no package knows raises."""
    from repro_torch.configs.base import ModelConfig

    cfg = ModelConfig(name="t", family="moe", source="x", d_model=32, num_heads=2,
                      num_kv_heads=2, head_dim=16, vocab_size=64, segments=(),
                      param_dtype="float32", compute_dtype="float32")
    spec = FFNSpec(kind="moe", d_ff=64, num_experts=8, top_k=2, capacity_factor=1.25)
    jp = jmoe.init_moe(jax.random.PRNGKey(5), tiny_cfg(), JFFNSpec(**spec.__dict__), jnp.float32)
    tp = jax.tree.map(lambda a: t(np.asarray(a)), jp)
    x = t(np.random.default_rng(5).standard_normal((2, 9, 32)).astype(np.float32))
    out = {impl: tmoe.moe_layer(cfg, spec, tp, x, impl=impl)
           for impl in ("dense", "grouped", "ep", "ep_serve", "ep_grouped")}
    for name, same in (("ep", "dense"), ("ep_serve", "dense"), ("ep_grouped", "grouped")):
        for a, b in zip(out[name], out[same]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(tmoe.moe_layer(cfg.replace(moe_impl="ep"), spec, tp, x)[0],
                               out["dense"][0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="moe_impl"):
        tmoe.moe_layer(cfg, spec, tp, x, impl="sparse")
