"""Port parity for MoQ weight quantization: ``QuantizedArray``, the PTQ
policies, the plain version of the quantized grouped expert kernel (kernel
5), the MoE layer and the static ``Engine`` with int8 / int4 experts, and
quantized checkpoints, against the JAX package on the same numpy inputs, on
the CPU.

Tolerances: quantized values, scales, leaf paths and byte counts are exact
(the same f32 amax, division and round-half-to-even on both sides).  f32
expert outputs agree to 1e-5 (f32 products over at most 64-wide
contractions, summed in another order); greedy tokens are identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt
from repro.configs.base import QuantConfig as JQuantConfig
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import make_reduced as jax_make_reduced
from repro.core import moe as jmoe
from repro.kernels import expert_mlp_grouped as jk
from repro.models import model as jm
from repro.quant import qarrays as jq
from repro.quant import quantize_params as jquantize_params
from repro.quant import quantized_leaf_paths as jquantized_leaf_paths
from repro.quant import tree_bytes as jtree_bytes
from repro.serving import engine as je
from repro.treepath import path_names
from repro_torch import convert
from repro_torch.configs.base import QuantConfig
from repro_torch.configs.registry import get_config, make_reduced
from repro_torch.core import moe as tmoe
from repro_torch.kernels import expert_mlp_grouped as tk
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tm
from repro_torch.quant import qarrays as tq
from repro_torch.quant import quantize_params, quantized_leaf_paths, tree_bytes
from repro_torch.serving import engine as te
from test_grouped import tiny_cfg
from test_torch_moe import TOL, grouped_inputs, t
from _torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

ARCH = "llama4-maverick-400b-a17b"


def jquantize(params, qcfg):
    """The JAX package's PTQ, run op by op as its engines and launcher run
    it.  (Under ``jax.jit`` XLA computes ``max(amax, 1e-8) / qmax`` as a
    product with the reciprocal, so jitted scales can differ from these in
    the last bit; the port matches the function as written.)"""
    return jquantize_params(params, qcfg)


def jax_leaves(tree) -> dict:
    """'/'-joined key path -> numpy array of every leaf of a JAX tree (a
    quantized leaf gives ``.../q`` and ``.../scale``, as in the manifest)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(path_names(p)): np.asarray(v) for p, v in flat}


def nested(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        node = out
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def torch_leaves(tree) -> dict:
    """The same view of a ParamTree: buffers by their dotted names."""
    return {k.replace(".", "/"): v for k, v in tree.named_buffers()}


def assert_same_bytes(tq_arr: tq.QuantizedArray, jq_arr):
    np.testing.assert_array_equal(tq_arr.q.numpy(), np.asarray(jq_arr.q))
    np.testing.assert_array_equal(tq_arr.scale.numpy(), np.asarray(jq_arr.scale))
    assert (tq_arr.bits, tq_arr.group_size, tq_arr.axis) == (jq_arr.bits, jq_arr.group_size, jq_arr.axis)
    assert tq_arr.shape == jq_arr.shape


# ---------------------------------------------------------------------------
# QuantizedArray: byte-exact with JAX
# ---------------------------------------------------------------------------


CASES = {
    # name: (shape, bits, group_size, reduce_axes)
    "int8_experts": ((3, 32, 16), 8, 0, (-2,)),
    "int4_experts": ((3, 32, 16), 4, 0, (-2,)),
    "int8_groupwise": ((2, 3, 32, 16), 8, 8, (-2,)),
    "int4_groupwise": ((3, 32, 16), 4, 8, (-2,)),
    "int8_attn_wo": ((4, 8, 32), 8, 0, (-3, -2)),
    "int4_attn_wo": ((2, 4, 8, 32), 4, 0, (-3, -2)),
    "int8_attn_qkv": ((32, 4, 8), 8, 0, (-3,)),
    "int4_unembed": ((32, 40), 4, 0, (-2,)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_quantized_array_bytes_match_jax(case, dtype):
    """q, scale and the dequantized weight equal the JAX package's, for
    int8 / int4, per channel / group-wise, the attention out-projection
    (two contraction axes) and stacked leaves (quantized slice by slice)."""
    shape, bits, gs, axes = CASES[case]
    w = np.random.default_rng(len(case)).standard_normal(shape).astype(np.float32)
    w[0, 0] = 0.0  # an all-zero row of a slice: the 1e-8 amax floor
    jw = jnp.asarray(w).astype(dtype)
    tw = t(jw.astype(jnp.float32)).to(getattr(torch, dtype))
    ja = jq.QuantizedArray.quantize(jw, bits=bits, group_size=gs, reduce_axes=axes)
    ta = tq.QuantizedArray.quantize(tw, bits=bits, group_size=gs, reduce_axes=axes)
    assert_same_bytes(ta, ja)
    assert ta.dtype == tw.dtype and ta.nbytes == ja.nbytes
    np.testing.assert_array_equal(ta.dequantize().float().numpy(),
                                  np.asarray(ja.dequantize().astype(jnp.float32)))


def test_int4_pack_unpack_every_byte():
    """All 256 byte values unpack as JAX's ``_unpack_int4`` does, and every
    pair of nibbles in [-8, 7] packs back to the same byte."""
    b = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    tu = tq._unpack_int4(torch.from_numpy(b), -2)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(jq._unpack_int4(jnp.asarray(b), -2)))
    np.testing.assert_array_equal(tq._pack_int4(tu, -2).numpy(), b)


def test_quantized_array_module_surface():
    """A ParamTree nests it: keys ``.../wi/q`` and ``.../wi/scale``, ``.to()``
    moves both buffers, ``take`` gives one expert of a stacked leaf."""
    w = torch.randn(2, 3, 8, 6)
    qa = tq.QuantizedArray.quantize(w, bits=4)
    tree = tm.ParamTree({"moe": {"wi": qa, "router": torch.zeros(8, 3)}})
    assert sorted(torch_leaves(tree)) == ["moe/router", "moe/wi/q", "moe/wi/scale"]
    assert tree["moe"]["wi"] is qa and qa.shape == (2, 3, 8, 6) and qa.q.shape == (2, 3, 4, 6)
    moved = tree.to(torch.float64)  # buffers keep their types: int8 q, and scale follows
    assert moved["moe"]["wi"].q.dtype == torch.int8
    one = qa.take(1).take(2)
    torch.testing.assert_close(one.dequantize(), qa.dequantize()[1, 2], rtol=0, atol=0)
    with pytest.raises(ValueError, match="contraction"):
        one.take(0)
    for bad in (dict(bits=3), dict(bits=4, group_size=3), dict(bits=8, group_size=5)):
        with pytest.raises(ValueError):
            tq.QuantizedArray.quantize(torch.ones(8, 8), **bad)


# ---------------------------------------------------------------------------
# PTQ policies on a model tree
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_make_reduced(jax_get_config(ARCH)).replace(moe_impl="grouped")
    tcfg = make_reduced(get_config(ARCH)).replace(moe_impl="grouped")
    jparams = jax.jit(lambda k: jm.init_params(jcfg, k))(jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("policy,bits,gs", [("experts", 8, 0), ("experts_attn", 4, 16),
                                            ("all", 8, 0)])
def test_quantize_params_matches_jax(pair, policy, bits, gs):
    """The same leaves are quantized, to the same bytes, and ``tree_bytes``
    agrees; unquantized leaves are the input's own tensors."""
    _, _, jparams, tparams = pair
    jqp = jquantize(jparams, JQuantConfig(bits=bits, group_size=gs, policy=policy))
    tqp = quantize_params(tparams, QuantConfig(bits=bits, group_size=gs, policy=policy))
    assert quantized_leaf_paths(tqp) == jquantized_leaf_paths(jqp)
    jl, tl = jax_leaves(jqp), torch_leaves(tqp)
    assert sorted(jl) == sorted(tl)
    for key, arr in jl.items():
        np.testing.assert_array_equal(tl[key].numpy(), arr)
    assert tree_bytes(tqp) == jtree_bytes(jqp)
    assert tree_bytes(tqp, only_quantized=True) == jtree_bytes(jqp, only_quantized=True)
    assert tqp["embed"] is tparams["embed"]
    with pytest.raises(ValueError, match="policy"):
        quantize_params(tparams, QuantConfig(policy="everything"))


def test_params_from_numpy_of_a_jax_quantized_tree(pair):
    """A tree the JAX package quantized, handed over as numpy ({q, scale} per
    quantized leaf), equals the port's own quantization of the fp tree."""
    jcfg, tcfg, jparams, tparams = pair
    qcfg = dict(bits=4, group_size=8, policy="experts_attn")
    jqp = jquantize(jparams, JQuantConfig(**qcfg))
    got = convert.params_from_numpy(tcfg, nested(jax_leaves(jqp)), "cpu", qcfg=QuantConfig(**qcfg))
    want = quantize_params(tparams, QuantConfig(**qcfg))
    assert quantized_leaf_paths(got) == quantized_leaf_paths(want)
    for key, v in torch_leaves(want).items():
        torch.testing.assert_close(torch_leaves(got)[key], v, rtol=0, atol=0)
    wo = got["segments"]["seg0"]["pos0"]["attn"]["wo"]
    assert (wo.bits, wo.group_size, wo.axis, wo.dtype) == (4, 0, -3, torch.float32)
    with pytest.raises(ValueError, match="does not match"):  # quantized leaves, no qcfg
        convert.params_from_numpy(tcfg, nested(jax_leaves(jqp)), "cpu")


def test_quantized_checkpoint_round_trip(pair, tmp_path, capsys):
    """A directory the JAX package saved from a quantized tree loads into the
    port without JAX, serves the same logits as the port's own PTQ, and the
    CLI serves from it with the same quant flags."""
    jcfg, tcfg, jparams, tparams = pair
    ckpt.save(str(tmp_path), jquantize(jparams, JQuantConfig(bits=8, policy="all")))
    loaded = convert.load_checkpoint(str(tmp_path), tcfg, "cpu", qcfg=QuantConfig(bits=8, policy="all"))
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, tcfg.vocab_size, (2, 5)))
    a, _ = tm.forward(tcfg, loaded, toks)
    b, _ = tm.forward(tcfg, quantize_params(tparams, QuantConfig(bits=8, policy="all")), toks)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="has shape"):  # int4 halves the packed axis
        convert.load_checkpoint(str(tmp_path), tcfg, "cpu", qcfg=QuantConfig(bits=4, policy="all"))
    tserve.main(["--arch", ARCH, "--reduced", "--moe-impl", "grouped", "--device", "cpu",
                 "--ckpt", str(tmp_path), "--quant-bits", "8", "--quant-policy", "all",
                 "--requests", "2", "--batch", "2", "--prompt-len", "6", "--new-tokens", "3"])
    assert "served 2 requests, 6 tokens" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Kernel 5 (plain version) and the MoE layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [8, 4])
def test_grouped_mlp_quant_plain_vs_jax(bits):
    """The plain version against ``grouped_mlp_quant_ref`` and the Pallas
    kernel in interpret mode, on the same quantized weights; the port's
    compatibility rule picks the kernel where JAX's does."""
    xg, layout, w = grouped_inputs(bits)
    te_ = layout.tile_expert.numpy()
    jw = {n: jq.QuantizedArray.quantize(jnp.asarray(w[n]), bits=bits) for n in w}
    tw = {n: tq.QuantizedArray.quantize(t(w[n]), bits=bits) for n in w}
    jargs = (jnp.asarray(xg), jnp.asarray(te_), jw["wi"], jw["wg"], jw["wo"])
    ref = np.asarray(jk.grouped_mlp_quant_ref(*jargs))
    kern = np.asarray(jk.grouped_mlp_quant(*jargs, interpret=True))
    for rows_used in (None, layout.rows_used):
        out = tk.grouped_mlp_quant_plain(t(xg), layout.tile_expert, tw["wi"], tw["wg"], tw["wo"],
                                         rows_used).numpy()
        np.testing.assert_allclose(out, ref, **TOL)
        np.testing.assert_allclose(out, kern, **TOL)
    out = tk.grouped_mlp_quant(t(xg), layout.tile_expert, tw["wi"], tw["wg"], tw["wo"], layout.rows_used)
    assert tk.launches["grouped_mlp_quant"] == 0  # CPU tensors take the plain version
    assert tk.check_grouped_quant_compat(tw["wi"], tw["wg"], tw["wo"])
    assert jk._check_grouped_quant_compat(jw["wi"], jw["wg"], jw["wo"])
    gw = {n: tq.QuantizedArray.quantize(t(w[n]), bits=bits, group_size=8) for n in w}
    jgw = {n: jq.QuantizedArray.quantize(jnp.asarray(w[n]), bits=bits, group_size=8) for n in w}
    assert not tk.check_grouped_quant_compat(gw["wi"], gw["wg"], gw["wo"])
    assert not jk._check_grouped_quant_compat(jgw["wi"], jgw["wg"], jgw["wo"])


@pytest.mark.parametrize("bits,gs", [(8, 0), (4, 16)])
def test_moe_layer_quantized_experts(bits, gs):
    """moe_layer(impl="grouped") with quantized experts and the fp
    Residual-MoE branch against the JAX layer; group-wise scales take the
    plain dequantize path on both sides."""
    from repro.configs.base import FFNSpec as JFFNSpec
    from repro_torch.configs.base import FFNSpec, ModelConfig

    jcfg = tiny_cfg()
    tcfg = ModelConfig(name="t", family="moe", source="x", d_model=32, num_heads=2,
                       num_kv_heads=2, head_dim=16, vocab_size=64, segments=(),
                       param_dtype="float32", compute_dtype="float32")
    kw = dict(kind="moe", d_ff=64, num_experts=8, top_k=2, capacity_factor=1.25,
              residual=True, residual_d_ff=48)
    jspec, tspec = JFFNSpec(**kw), FFNSpec(**kw)
    jp = jmoe.init_moe(jax.random.PRNGKey(bits), jcfg, jspec, jnp.float32)
    jqp = {k: (jq.QuantizedArray.quantize(v, bits=bits, group_size=gs) if k in ("wi", "wg", "wo") else v)
           for k, v in jp.items()}
    tp = {k: (tq.QuantizedArray.quantize(t(np.asarray(v)), bits=bits, group_size=gs)
              if k in ("wi", "wg", "wo") else jax.tree.map(lambda a: t(np.asarray(a)), v))
          for k, v in jp.items()}
    x = np.random.default_rng(bits).standard_normal((2, 9, 32)).astype(np.float32)
    jy, _ = jax.jit(lambda p, x: jmoe.moe_layer(jcfg, jspec, p, x, impl="grouped"))(jqp, jnp.asarray(x))
    ty, _ = tmoe.moe_layer(tcfg, tspec, tp, t(x), impl="grouped")
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)


# ---------------------------------------------------------------------------
# The static Engine with quantized experts and an int8 KV cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [8, 4])
def test_engine_greedy_tokens_identical(pair, bits):
    """Reduced llama4-maverick with int8 / int4 experts and kv_cache_bits=8:
    the port's Engine (kernels 5 and 9 through their plain versions) emits
    exactly the JAX Engine's greedy tokens."""
    jcfg, tcfg, jparams, tparams = pair
    jqp = jquantize(jparams, JQuantConfig(bits=bits))
    tqp = quantize_params(tparams, QuantConfig(bits=bits))
    rng = np.random.default_rng(bits)
    prompts = [rng.integers(1, jcfg.vocab_size, n).tolist() for n in (5, 9, 3)]
    kw = dict(max_batch=4, max_prefill=12, max_decode=8, kv_cache_bits=8)
    jout = je.Engine(jcfg, jqp, je.EngineConfig(**kw)).generate([je.Request(p, 8) for p in prompts])
    tout = te.Engine(tcfg, tqp, te.EngineConfig(**kw), device="cpu").generate(
        [te.Request(p, 8) for p in prompts])
    assert [r.tokens for r in tout] == [r.tokens for r in jout]
    assert all(len(r.tokens) == 8 for r in tout)


def test_cli_quantized_on_cpu(capsys):
    tserve.main(["--arch", ARCH, "--reduced", "--moe-impl", "grouped", "--device", "cpu",
                 "--quant-bits", "4", "--kv-bits", "8", "--requests", "2", "--batch", "2",
                 "--prompt-len", "6", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert "PTQ int4/experts" in out and "KV cache int8" in out
    assert "served 2 requests, 8 tokens" in out and "device=cpu" in out
