"""Port parity for the whole slice: reduced llama4-maverick (top-1 routed
expert + shared expert) and reduced kimi-k2 (top-2 + shared, dense first
layer), both with ``moe_impl="grouped"``, served by the JAX package and by
``repro_torch`` from the same parameters, in f32 on the CPU.

Tolerance for logits: ``atol = rtol = 1e-4`` (two to three layers of f32
products over 128-wide contractions, summed in another order on each side).
Greedy tokens must be identical.
"""
import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import make_reduced as jax_make_reduced
from repro.models import model as jm
from repro.serving import engine as je
from repro_torch import convert
from repro_torch.configs.registry import get_config, make_reduced
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tm
from repro_torch.serving import engine as te
from _torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

ARCHS = ["llama4-maverick-400b-a17b", "kimi-k2-1t-a32b"]
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    name = request.param
    jcfg = jax_make_reduced(jax_get_config(name)).replace(moe_impl="grouped")
    tcfg = make_reduced(get_config(name)).replace(moe_impl="grouped")
    jparams = jax.jit(lambda k: jm.init_params(jcfg, k))(jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return name, jcfg, tcfg, jparams, tparams


def test_prefill_and_decode_logits(pair):
    _, jcfg, tcfg, jparams, tparams = pair
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
    """3 requests of unequal prompt lengths (left pads in the batch) x 8
    tokens: the port's Engine emits exactly the JAX Engine's tokens."""
    _, jcfg, tcfg, jparams, tparams = pair
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, jcfg.vocab_size, n).tolist() for n in (5, 9, 3)]
    kw = dict(max_batch=4, max_prefill=12, max_decode=8)
    jout = je.Engine(jcfg, jparams, je.EngineConfig(**kw)).generate(
        [je.Request(p, 8) for p in prompts])
    tout = te.Engine(tcfg, tparams, te.EngineConfig(**kw), device="cpu").generate(
        [te.Request(p, 8) for p in prompts])
    assert [r.tokens for r in tout] == [r.tokens for r in jout]
    assert all(len(r.tokens) == 8 for r in tout)


def test_checkpoint_round_trip(pair, tmp_path):
    """A checkpoint saved by the JAX package loads into the port without JAX
    and gives the same logits as the directly converted parameters."""
    _, _, tcfg, jparams, tparams = pair
    ckpt.save(str(tmp_path), jparams)
    loaded = convert.load_checkpoint(str(tmp_path), tcfg, "cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, tcfg.vocab_size, (2, 5)))
    a, _ = tm.forward(tcfg, loaded, toks)
    b, _ = tm.forward(tcfg, tparams, toks)
    torch.testing.assert_close(a, b, rtol=0, atol=0)  # and b matches JAX (tests above)
    wrong = make_reduced(get_config("glm4-9b"))
    with pytest.raises(ValueError, match="does not match"):
        convert.load_checkpoint(str(tmp_path), wrong, "cpu")


def test_checkpoint_bf16_leaves_bit_exact(tmp_path):
    """bf16 leaves (stored by numpy as 2-byte records) load bit for bit."""
    jcfg = jax_make_reduced(jax_get_config(ARCHS[0])).replace(param_dtype="bfloat16")
    tcfg = make_reduced(get_config(ARCHS[0])).replace(param_dtype="bfloat16")
    # the JAX tree's structure and types, filled from numpy (no compile)
    shapes = jax.eval_shape(lambda: jm.init_params(jcfg, jax.random.PRNGKey(3)))
    rng = np.random.default_rng(3)
    jparams = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(a.dtype), shapes)
    ckpt.save(str(tmp_path), jparams)
    loaded = convert.load_checkpoint(str(tmp_path), tcfg, "cpu")
    wi = loaded["segments"]["seg0"]["pos1"]["moe"]["wi"]
    assert wi.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        wi.view(torch.int16).numpy(),
        np.asarray(jparams["segments"]["seg0"]["pos1"]["moe"]["wi"]).view(np.int16))


def test_cli_runs_on_cpu(pair, capsys):
    name = pair[0]
    tserve.main(["--arch", name, "--reduced", "--moe-impl", "grouped", "--device", "cpu",
                 "--requests", "3", "--batch", "2", "--prompt-len", "6", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out and "device=cpu" in out


def test_cli_rejects_unported_flags(capsys):
    # --ep-devices serves (test_torch_ep_serving.py); a mesh of three axes,
    # and speculation over a mesh, the JAX launcher refuses too
    with pytest.raises(SystemExit):
        tserve.main(["--arch", ARCHS[0], "--reduced", "--device", "cpu", "--ep-devices", "2x2x2"])
    assert "bad --ep-devices '2x2x2'" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        tserve.main(["--arch", ARCHS[0], "--reduced", "--device", "cpu", "--ep-devices", "2",
                     "--paged", "--spec-draft", "self"])
    assert "--spec-draft is not implemented over an expert-parallel" in capsys.readouterr().err


def test_engine_rejects_unported_options(pair):
    _, _, tcfg, _, tparams = pair
    with pytest.raises(ValueError, match="kv_cache_bits"):  # 0 and 8 only, as in JAX
        te.Engine(tcfg, tparams, te.EngineConfig(kv_cache_bits=4), device="cpu")
    # a mesh needs one process per rank in a default process group
    with pytest.raises(RuntimeError, match="process group"):
        te.Engine(tcfg.replace(ep_mesh=(2,)), tparams, te.EngineConfig(), device="cpu")
