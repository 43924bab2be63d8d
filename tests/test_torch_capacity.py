"""Port parity for the capacity dispatch (``moe_impl`` "dense" / "einsum"):
the gating kernel's plain version (kernel 1), the capacity-buffer expert
MLPs' plain versions (kernels 2 and 3), the mapping-table and einsum
dispatches and the MoE layer, against the JAX package on the same numpy
inputs, on the CPU.

Tolerances:
- gating: expert ids, positions, keep and counts are exact; gate weights
  and probabilities agree to 1e-6 (one f32 softmax, one division);
- dispatch: the scatter moves values, so the buffers are exact; the
  combine agrees to 1e-6 (f32 products and a K-term sum);
- expert MLPs and the layer in f32: 1e-5 for the kernels' plain versions
  (products over at most 64-wide contractions, summed in another order),
  1e-4 for the layer (router, experts and residual branch in sequence);
- bf16 expert MLP against JAX's kernel and oracle: both round the
  activation once and the output once, so outputs may differ by a bf16 ulp
  where an f32 sum of another order rounds the other way: 2e-2 of the
  largest output;
- bf16 layer against JAX's ``dense`` path: JAX's fp ``experts_ffn`` rounds
  h = x·wi and g = x·wg to bf16 before ``silu(g) * h`` while the port (as
  ``expert_mlp_ref``, the repo's kernel oracle) keeps them in f32 and rounds
  the activation once; each rounding is up to 2^-9 relative, and three of
  them plus the output's compound through a 64-wide sum: 3e-2 of the
  largest output.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FFNSpec as JFFNSpec
from repro.core import dispatch as jdispatch
from repro.core import dispatch_einsum as jeinsum
from repro.core import gating as jgating
from repro.core import moe as jmoe
from repro.kernels import expert_mlp as jk2
from repro.kernels import expert_mlp_quant as jk3
from repro.kernels.moe_gating import gating_kernel as jgating_kernel
from repro.kernels.ref import expert_mlp_ref, gating_ref
from repro.quant import qarrays as jq
from repro_torch.configs.base import FFNSpec, ModelConfig
from repro_torch.core import dispatch as tdispatch
from repro_torch.core import dispatch_einsum as teinsum
from repro_torch.core import moe as tmoe
from repro_torch.core.gating import Gating, expert_capacity
from repro_torch.kernels import expert_mlp as tk2
from repro_torch.kernels import expert_mlp_quant as tk3
from repro_torch.kernels import moe_gating as tk1
from repro_torch.quant import qarrays as tq
from test_grouped import tiny_cfg
from test_torch_moe import t
from _torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

F32 = dict(atol=1e-5, rtol=1e-5)


def routed_logits(T, E, seed, ties=True, bias=0.0):
    """Router logits; ``ties`` rounds them to a coarse grid so equal
    probabilities occur in most rows, ``bias`` pushes tokens to expert 0 so
    that a small capacity drops."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, E)).astype(np.float32)
    if ties:
        x = np.round(x, 1)
        x[::7] = 0.5  # whole rows of equal logits
    x[:, 0] += bias
    return x


def assert_gating_equal(g, counts, jaxg, E, *, probs=True):
    eidx, w, pos, keep = (np.asarray(a) for a in jaxg[:4])
    np.testing.assert_array_equal(g.expert_idx.numpy(), eidx)
    np.testing.assert_array_equal(g.position.numpy(), pos)
    np.testing.assert_array_equal(g.keep.numpy(), keep)
    np.testing.assert_allclose(g.combine_w.numpy(), w, atol=1e-6, rtol=1e-6)
    if probs:
        np.testing.assert_allclose(g.probs.numpy(), np.asarray(jaxg[4]), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(counts.numpy(), np.bincount(eidx.reshape(-1), minlength=E))


# ---------------------------------------------------------------------------
# Kernel 1: gating
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,E,K", [(4, 4, 2), (256, 128, 1), (384, 8, 2), (128, 16, 8)])
def test_gating_plain_vs_jax_kernel(T, E, K):
    """Against the Pallas kernel in interpret mode (T = 384 spans three
    128-token tiles, so its count carry is exercised) and ``gating_ref``,
    with ties, for a capacity that drops and one that does not."""
    logits = routed_logits(T, E, T + E + K, bias=1.0)
    for cap in (2, expert_capacity(T, E, K, 1.25), T * K):
        g, counts = tk1.gating_plain(t(logits), K, cap)
        assert_gating_equal(g, counts, jgating_kernel(jnp.asarray(logits), K, cap, interpret=True), E)
        assert_gating_equal(g, counts, gating_ref(jnp.asarray(logits), K, cap), E)
        if cap == 2:
            assert not g.keep.all()  # the case drops
    # without renormalisation, as the kernel's normalize=False
    g, _ = tk1.gating_plain(t(logits), K, T * K, normalize=False)
    jw = jgating_kernel(jnp.asarray(logits), K, T * K, normalize=False, interpret=True)[1]
    np.testing.assert_allclose(g.combine_w.numpy(), np.asarray(jw), atol=1e-6, rtol=1e-6)


def test_gating_ties_go_to_the_lowest_id():
    """A row of equal logits picks experts 0, 1, ... in order."""
    g, counts = tk1.gating_plain(torch.zeros(3, 6), 3, 8)
    assert g.expert_idx.tolist() == [[0, 1, 2]] * 3
    assert g.position.tolist() == [[0, 0, 0], [1, 1, 1], [2, 2, 2]]
    assert counts.tolist() == [3, 3, 3, 0, 0, 0]


def test_gating_wrapper_on_cpu_takes_the_plain_version():
    logits = t(routed_logits(40, 8, 3))
    before = dict(tk1.launches)
    g, counts = tk1.gating(logits, 2, 8)
    assert tk1.launches == before and tk1.launches["moe_gating"] == 0
    pg, pc = tk1.gating_plain(logits, 2, 8)
    for a, b in zip((*g, counts), (*pg, pc)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Kernels 2 and 3: expert MLPs over the capacity buffer
# ---------------------------------------------------------------------------


def capacity_inputs(seed, E=6, C=8, D=32, F=64, dtype=np.float32):
    """A buffer with two empty experts, partly filled ones and a full one
    (rows past each expert's fill are zero, as the dispatch leaves them),
    its fill, and weights."""
    rng = np.random.default_rng(seed)
    fill = np.array([0, 3, C, 0, 1, 5][:E], np.int32)
    xe = np.zeros((E, C, D), np.float32)
    for e in range(E):
        xe[e, : fill[e]] = rng.standard_normal((fill[e], D))
    w = {n: (rng.standard_normal(s) / np.sqrt(s[1])).astype(np.float32)
         for n, s in (("wi", (E, D, F)), ("wg", (E, D, F)), ("wo", (E, F, D)))}
    return xe.astype(dtype), fill, w


def test_expert_mlp_plain_vs_jax():
    """f32: the plain version against ``expert_mlp_ref`` and the Pallas
    kernel in interpret mode; ``fill`` does not change the result."""
    xe, fill, w = capacity_inputs(0)
    jargs = (jnp.asarray(xe), *(jnp.asarray(w[n]) for n in ("wi", "wg", "wo")))
    ref = np.asarray(expert_mlp_ref(*jargs))
    kern = np.asarray(jk2.expert_mlp_kernel(*jargs, interpret=True))
    targs = (t(xe), t(w["wi"]), t(w["wg"]), t(w["wo"]))
    full = tk2.expert_mlp_plain(*targs)
    filled = tk2.expert_mlp_plain(*targs, torch.from_numpy(fill))
    torch.testing.assert_close(filled, full, rtol=0, atol=0)
    for out in (full, filled):
        np.testing.assert_allclose(out.numpy(), ref, **F32)
        np.testing.assert_allclose(out.numpy(), kern, **F32)
    assert not filled[0].any() and not filled[3].any() and not filled[1, 3:].any()
    before = dict(tk2.launches)
    torch.testing.assert_close(tk2.expert_mlp(*targs, torch.from_numpy(fill)), filled, rtol=0, atol=0)
    assert tk2.launches == before and tk2.launches["expert_mlp"] == 0


def test_expert_mlp_plain_vs_jax_bf16():
    """bf16: the same function, both sides rounding the activation once."""
    xe, fill, w = capacity_inputs(1)
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    jargs = (bf(xe), *(bf(w[n]) for n in ("wi", "wg", "wo")))
    ref = np.asarray(expert_mlp_ref(*jargs).astype(jnp.float32))
    kern = np.asarray(jk2.expert_mlp_kernel(*jargs, interpret=True).astype(jnp.float32))
    tb = lambda a: t(np.asarray(bf(a).astype(jnp.float32))).to(torch.bfloat16)
    out = tk2.expert_mlp_plain(tb(xe), tb(w["wi"]), tb(w["wg"]), tb(w["wo"]),
                               torch.from_numpy(fill)).float().numpy()
    tol = 2e-2 * np.abs(ref).max()
    np.testing.assert_allclose(out, ref, atol=tol, rtol=0)
    np.testing.assert_allclose(out, kern, atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_mlp_quant_plain_vs_jax(dtype):
    """int8 per-channel experts quantized from the same weights on both
    sides (byte-exact): the plain version against ``expert_mlp_quant_ref``
    and the Pallas kernel in interpret mode."""
    xe, fill, w = capacity_inputs(2)
    jdt = getattr(jnp, dtype)
    jw = {n: jq.QuantizedArray.quantize(jnp.asarray(w[n]).astype(jdt), bits=8) for n in w}
    tw = {n: tq.QuantizedArray.quantize(t(np.asarray(jnp.asarray(w[n]).astype(jdt).astype(jnp.float32)))
                                        .to(getattr(torch, dtype)), bits=8) for n in w}
    jx = jnp.asarray(xe).astype(jdt)
    ref = np.asarray(jk3.expert_mlp_quant_ref(jx, jw["wi"], jw["wg"], jw["wo"]).astype(jnp.float32))
    kern = np.asarray(jk3.expert_mlp_quant(jx, jw["wi"], jw["wg"], jw["wo"], interpret=True)
                      .astype(jnp.float32))
    tx = t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    full = tk3.expert_mlp_quant_plain(tx, tw["wi"], tw["wg"], tw["wo"])
    out = tk3.expert_mlp_quant(tx, tw["wi"], tw["wg"], tw["wo"], torch.from_numpy(fill))
    assert tk3.launches["expert_mlp_quant"] == 0  # CPU tensors take the plain version
    torch.testing.assert_close(out, full, rtol=0, atol=0)
    out = out.float().numpy()
    tol = F32 if dtype == "float32" else dict(atol=2e-2 * np.abs(ref).max(), rtol=0)
    np.testing.assert_allclose(out, ref, **tol)
    np.testing.assert_allclose(out, kern, **tol)


def test_check_kernel_compat_takes_every_int8_channel_layout():
    """The port takes kernel 3 for every int8 per-channel layout, as the JAX
    package does, but not for int4 or group-wise scales.  JAX's rule also
    refuses a capacity past its 128-row block that the block does not divide
    (C = 136): that rule is the TPU grid's, and the card's kernel takes any
    C that is a multiple of 8."""
    rng = np.random.default_rng(4)
    w = {n: rng.standard_normal(s).astype(np.float32)
         for n, s in (("wi", (2, 32, 64)), ("wg", (2, 32, 64)), ("wo", (2, 64, 32)))}
    for bits, gs in ((8, 0), (4, 0), (8, 8)):
        jw = [jq.QuantizedArray.quantize(jnp.asarray(w[n]), bits=bits, group_size=gs) for n in w]
        tw = [tq.QuantizedArray.quantize(t(w[n]), bits=bits, group_size=gs) for n in w]
        for C in (8, 136, 256):
            jx, tx = jnp.zeros((2, C, 32)), torch.zeros(2, C, 32)
            layout = bits == 8 and gs == 0
            assert jk3._check_kernel_compat(jx, *jw) == (layout and C != 136), (bits, gs, C)
            assert tk3.check_kernel_compat(tx, *tw) == layout, (bits, gs, C)


# ---------------------------------------------------------------------------
# The dispatches
# ---------------------------------------------------------------------------


def shared_gating(T=20, E=4, K=2, cap=8, seed=5):
    """One gating (with drops), in JAX and as the port's tuple."""
    logits = routed_logits(T, E, seed, ties=False, bias=1.5)
    jg = jgating.top_k_gating(jnp.asarray(logits), K, cap)
    tg = Gating(*(t(np.asarray(a)) for a in jg))
    assert not tg.keep.all()
    return jg, tg


def scale_experts(xe):
    """A stand-in expert function: expert e scales its rows by e + 1."""
    return xe * (torch.arange(xe.shape[0], dtype=xe.dtype)[:, None, None] + 1)


@pytest.mark.parametrize("K", [1, 2])
def test_dispatch_dense_and_combine_vs_jax(K):
    jg, tg = shared_gating(K=K)
    E, cap = 4, 8
    x = np.random.default_rng(6).standard_normal((20, 16)).astype(np.float32)
    jbuf = np.asarray(jdispatch.dispatch_dense(jnp.asarray(x), jg, cap, E))
    tbuf = tdispatch.dispatch_dense(t(x), tg, cap, E)
    np.testing.assert_array_equal(tbuf.numpy(), jbuf)
    np.testing.assert_array_equal(tdispatch.flat_slot(tg, cap, E).numpy(),
                                  np.asarray(jdispatch.flat_slot(jg, cap, E)))
    ye = np.random.default_rng(7).standard_normal((E, cap, 16)).astype(np.float32)
    np.testing.assert_allclose(tdispatch.combine_dense(t(ye), tg, cap, E).numpy(),
                               np.asarray(jdispatch.combine_dense(jnp.asarray(ye), jg, cap, E)),
                               atol=1e-6, rtol=1e-6)
    jf = lambda xe: xe * (jnp.arange(E, dtype=xe.dtype)[:, None, None] + 1)
    want = np.asarray(jdispatch.moe_dense(jnp.asarray(x), jg, cap, E, jf))
    np.testing.assert_allclose(tdispatch.moe_dense(t(x), tg, cap, E, scale_experts).numpy(), want,
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("K", [1, 2])
def test_moe_einsum_vs_jax(K):
    """The one-hot einsum dispatch: tensors exact, output within 1e-6, and
    the same as the mapping table's; the dropless oracle with capacity T*K."""
    jg, tg = shared_gating(K=K)
    E, cap = 4, 8
    x = np.random.default_rng(8).standard_normal((20, 16)).astype(np.float32)
    jd, jc = jeinsum.dispatch_combine_tensors(jg, cap)
    td, tc = teinsum.dispatch_combine_tensors(tg, cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-7)
    jf = lambda xe: xe * (jnp.arange(E, dtype=xe.dtype)[:, None, None] + 1)
    y = teinsum.moe_einsum(t(x), tg, cap, scale_experts)
    np.testing.assert_allclose(y.numpy(), np.asarray(jeinsum.moe_einsum(jnp.asarray(x), jg, cap, jf)),
                               atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(y, tdispatch.moe_dense(t(x), tg, cap, E, scale_experts),
                               atol=1e-6, rtol=1e-6)
    logits = routed_logits(20, E, 9, ties=False)
    jg = jgating.top_k_gating(jnp.asarray(logits), K, 20 * K)
    tg = Gating(*(t(np.asarray(a)) for a in jg))
    np.testing.assert_allclose(teinsum.moe_einsum_dropless(t(x), tg, scale_experts).numpy(),
                               np.asarray(jeinsum.moe_einsum_dropless(jnp.asarray(x), jg, jf)),
                               atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# The MoE layer
# ---------------------------------------------------------------------------


def torch_cfg():
    return ModelConfig(name="t", family="moe", source="x", d_model=32, num_heads=2,
                       num_kv_heads=2, head_dim=16, vocab_size=64, segments=(),
                       param_dtype="float32", compute_dtype="float32")


def layer_pair(K, residual, act, weights, seed, dtype=jnp.float32):
    """JAX and port parameters of one MoE layer (8 experts, d_ff 64), the
    experts fp or quantized on both sides from the same values."""
    kw = dict(kind="moe", d_ff=64, num_experts=8, top_k=K, capacity_factor=1.25, act=act,
              residual=residual, residual_d_ff=48)
    jspec, tspec = JFFNSpec(**kw), FFNSpec(**kw)
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), tiny_cfg(), jspec, dtype)
    to_t = lambda a: t(np.asarray(jnp.asarray(a).astype(jnp.float32))).to(
        torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32)
    tp = jax.tree.map(to_t, jp)
    if weights != "fp":
        bits = {"int8": 8, "int4": 4}[weights]
        for n in ("wi", "wg", "wo"):
            if n in jp:
                tp[n] = tq.QuantizedArray.quantize(tp[n], bits=bits)
                jp[n] = jq.QuantizedArray.quantize(jp[n], bits=bits)
    return jspec, tspec, jp, tp


LAYER_CASES = {
    # name: (impl, K, residual, act, weights, router bias toward expert 0)
    "dense-k1-residual": ("dense", 1, True, "swiglu", "fp", 0.0),
    "dense-k2-drops": ("dense", 2, False, "swiglu", "fp", 3.0),
    "einsum-k1-drops": ("einsum", 1, False, "swiglu", "fp", 3.0),
    "einsum-k2-gelu-residual": ("einsum", 2, True, "gelu", "fp", 0.0),
    "dense-k1-gelu-drops": ("dense", 1, False, "gelu", "fp", 3.0),
    "dense-k2-relu": ("dense", 2, False, "relu", "fp", 0.0),
    "dense-k2-int8-residual-drops": ("dense", 2, True, "swiglu", "int8", 3.0),
    "einsum-k1-int8": ("einsum", 1, False, "swiglu", "int8", 0.0),
    "dense-k1-int4-drops": ("dense", 1, False, "swiglu", "int4", 3.0),
    "dense-k2-gelu-int8": ("dense", 2, False, "gelu", "int8", 0.0),
}


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_moe_layer_capacity_vs_jax(case):
    """moe_layer under the capacity dispatch against the JAX layer in f32:
    output within 1e-4 and the aux loss; a biased router drops tokens."""
    impl, K, residual, act, weights, bias = LAYER_CASES[case]
    jspec, tspec, jp, tp = layer_pair(K, residual, act, weights, seed=len(case))
    jp["router"] = jp["router"].at[:, 0].add(bias / 4)
    tp["router"] = t(np.asarray(jp["router"]))
    x = np.random.default_rng(len(case)).standard_normal((2, 9, 32)).astype(np.float32)
    if bias:
        x += np.abs(x).mean()  # a positive mean, so the bias routes most tokens to expert 0
    jy, jaux = jax.jit(lambda p, x: jmoe.moe_layer(tiny_cfg(), jspec, p, x, impl=impl))(
        jp, jnp.asarray(x))
    ty, taux = tmoe.moe_layer(torch_cfg(), tspec, tp, t(x), impl=impl)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-6)
    cap = expert_capacity(18, 8, K, 1.25)
    g, _ = tk1.gating_plain(t(x).reshape(18, 32) @ tp["router"], K, cap)
    if bias:
        assert not g.keep.all(), case  # the biased router overflows expert 0's buffer


def test_moe_layer_dense_bf16_vs_jax():
    """bf16 against JAX's ``dense`` path; the tolerance is the h/g rounding
    difference of the module docstring."""
    jspec, tspec, jp, tp = layer_pair(2, True, "swiglu", "fp", seed=11, dtype=jnp.bfloat16)
    x = np.random.default_rng(11).standard_normal((2, 9, 32)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jy, _ = jax.jit(lambda p, x: jmoe.moe_layer(tiny_cfg(), jspec, p, x, impl="dense"))(jp, jx)
    jy = np.asarray(jy.astype(jnp.float32))
    ty, _ = tmoe.moe_layer(torch_cfg(), tspec, tp, t(np.asarray(jx.astype(jnp.float32))).bfloat16(),
                           impl="dense")
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(ty.float().numpy(), jy, atol=3e-2 * np.abs(jy).max(), rtol=0)
