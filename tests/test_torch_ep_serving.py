"""Expert-parallel serving of the port (``cfg.ep_mesh``) against the JAX
package's one-device engines, on meshes (4,) and (2, 2).

One module fixture spawns 4 gloo ranks (``serving.ep.launch``) that serve
every case through both engines on both meshes, while the JAX engines serve
the same requests on one device in this process.  Greedy tokens must be
identical, on every rank:

  * reduced ``nlg-350m-moe128`` with 8 experts and capacity factor 8.0
    (GELU experts; JAX's own EP case: the chunked prefill takes the a2a
    exchange, flat on (4,) and hierarchical on (2, 2), decode the replicated
    capacity schedule) through the paged ``ContinuousEngine`` and the static
    ``Engine``;
  * reduced llama4-maverick under ``grouped`` (``ep_grouped``: SwiGLU
    experts, the shared expert, one expert a rank) through both engines.

Also: a pool too small for the trace preempts on every rank as on one
device and drains; int8 experts are dequantized once under EP (no quantized
routed-expert leaf left, each rank's slice only) and serve the tokens of the
dequantized tree; ``spec_draft`` under a mesh is refused; the CLI serves
``--ep-devices 2x2 --device cpu`` on 4 gloo ranks and refuses ``--ep-devices
4`` on the card with fewer GPUs than ranks.
"""
import concurrent.futures
import functools
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import _torch_ep_ranks as ranks
from repro.configs.registry import all_configs as jax_configs
from repro.configs.registry import make_reduced as jax_make_reduced
from repro.configs.registry import with_moe_ffn as jax_with_moe_ffn
from repro.models import model as jm
from repro.serving import continuous as jc
from repro.serving import engine as je
from repro_torch import convert
from repro_torch.configs.base import QuantConfig
from repro_torch.configs.registry import get_config, make_reduced, with_moe_ffn
from repro_torch.launch import serve as tserve
from repro_torch.quant import quantize_params
from repro_torch.quant.qarrays import QuantizedArray
from repro_torch.serving import ep
from repro_torch.serving.continuous import ContinuousEngine
from repro_torch.serving.engine import Engine, EngineConfig, Request
from _torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

pytestmark = pytest.mark.dist

ROOT = os.path.join(os.path.dirname(__file__), "..")
NLG, LLAMA4 = "nlg-350m-moe128", "llama4-maverick-400b-a17b"
PRE = [7, 7, 3, 5, 1, 2, 9, 4]
PROMPTS = [PRE + [3, 5, 1], PRE + [8, 2], [11, 2, 3, 7, 5, 6, 1, 9, 2, 3], [5]]
NEW = 8
PAGED = dict(slots=4, capacity=64, paged=True, page_size=8)
STATIC = dict(max_batch=4, max_prefill=32, max_decode=8)
# 10 pages of 4 cannot hold 4 slots' prompts and decode: the pool preempts
PREEMPT = dict(slots=4, capacity=32, paged=True, page_size=4, n_pages=10)


@functools.lru_cache(maxsize=None)
def configs(name):
    """(JAX cfg, port cfg, JAX params, the params as numpy) of a case."""
    if name == NLG:
        jcfg = jax_with_moe_ffn(jax_make_reduced(jax_configs()[NLG]), num_experts=8,
                                capacity_factor=8.0)
        tcfg = with_moe_ffn(make_reduced(get_config(NLG)), num_experts=8, capacity_factor=8.0)
    else:
        jcfg = jax_make_reduced(jax_configs()[LLAMA4]).replace(moe_impl="grouped")
        tcfg = make_reduced(get_config(LLAMA4)).replace(moe_impl="grouped")
    jparams = jax.jit(lambda k: jm.init_params(jcfg, k))(jax.random.PRNGKey(0))
    return jcfg, tcfg, jparams, jax.tree.map(np.asarray, jparams)


def jax_tokens(name, engine, kw):
    jcfg, _, jparams, _ = configs(name)
    if engine == "static":
        out = je.Engine(jcfg, jparams, je.EngineConfig(**kw)).generate(
            [je.Request(p, NEW) for p in PROMPTS])
        return [r.tokens for r in out]
    eng = jc.ContinuousEngine(jcfg, jparams, **kw)
    ids = [eng.submit(je.Request(prompt=p, max_new_tokens=NEW)) for p in PROMPTS]
    done = eng.run_until_done()
    return [done[i].tokens for i in ids]


CASES = {
    "nlg_continuous": (NLG, "continuous", PAGED),
    "nlg_static": (NLG, "static", STATIC),
    "llama4_continuous": (LLAMA4, "continuous", PAGED),
    "llama4_static": (LLAMA4, "static", STATIC),
}
INT8 = QuantConfig(bits=8, policy="experts")


def dequantized_experts(params):
    """``params`` with the routed experts' quantized leaves dequantized, each
    by its own ``dequantize`` (the shared expert keeps its quantized leaves)."""
    from repro_torch.models.model import ParamTree

    def visit(tree, path):
        return ParamTree({k: visit(v, path + [k]) if isinstance(v, ParamTree)
                          else v.dequantize() if isinstance(v, QuantizedArray) and path[-1:] == ["moe"]
                          else v for k, v in tree.items()})

    return visit(params, [])


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    cases = {name: dict(cfg=configs(arch)[1], params=configs(arch)[3], engine=engine, kw=kw,
                        prompts=PROMPTS, new=NEW)
             for name, (arch, engine, kw) in CASES.items()}
    cases["nlg_preempt"] = dict(cases["nlg_continuous"], kw=PREEMPT)
    cases["llama4_int8"] = dict(cases["llama4_static"], quant=INT8)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        run = pool.submit(ep.launch, ranks.serve_engines, 4, backend="gloo", args=(cases,),
                          timeout_s=400, rendezvous_dir=tmp_path_factory.mktemp("ep"))
        jax_out = {name: jax_tokens(arch, engine, kw) for name, (arch, engine, kw) in CASES.items()}
        port = run.result()
    return dict(port=port, jax=jax_out, cases=cases)


@pytest.mark.parametrize("mesh", ["flat4", "hier22"])
@pytest.mark.parametrize("case", list(CASES))
def test_engine_tokens_equal_jax_one_device(served, case, mesh):
    want = served["jax"][case]
    assert all(len(t) == NEW for t in want)
    for r in range(4):
        assert served["port"][r][f"{mesh}/{case}"] == want, (r, served["port"][r][f"{mesh}/{case}"])
    impl = "ep_grouped" if case.startswith("llama4") else "ep_serve"
    assert served["port"][0][f"{mesh}/{case}/impl"] == impl
    # each rank holds its own E / 4 experts
    E = max(ls.ffn.num_experts for ls in configs(CASES[case][0])[1].layer_specs())
    shapes = served["port"][0][f"{mesh}/{case}/experts"]
    assert shapes and all(s[1] == E // 4 for s in shapes), shapes  # [repeats, E_loc, D, F]


@pytest.mark.parametrize("mesh", ["flat4", "hier22"])
def test_sharded_pool_preempts_and_drains(served, mesh):
    _, tcfg, _, tree = configs(NLG)
    eng = ContinuousEngine(tcfg, convert.params_from_numpy(tcfg, tree, "cpu"), device="cpu",
                           **PREEMPT)
    ids = [eng.submit(Request(p, NEW)) for p in PROMPTS]
    done = eng.run_until_done()
    assert eng.preemptions > 0, "the trace did not preempt"
    for r in range(4):
        got = served["port"][r]
        assert got[f"{mesh}/nlg_preempt"] == [done[i].tokens for i in ids]
        preemptions, free, used, n_pages = got[f"{mesh}/nlg_preempt/pool"]
        assert (preemptions, free, used) == (eng.preemptions, n_pages, 0)


@pytest.mark.parametrize("mesh", ["flat4", "hier22"])
def test_int8_experts_materialized_once(served, mesh):
    _, tcfg, _, tree = configs(LLAMA4)
    q = quantize_params(convert.params_from_numpy(tcfg, tree, "cpu"), INT8)
    want = Engine(tcfg, dequantized_experts(q), EngineConfig(**STATIC), device="cpu").generate(
        [Request(p, NEW) for p in PROMPTS])
    for r in range(4):
        got = served["port"][r]
        assert got[f"{mesh}/llama4_int8"] == [x.tokens for x in want]
        left = got[f"{mesh}/llama4_int8/quantized"]
        assert not [p for p in left if p.split("/")[-2] == "moe"], left
        shapes = got[f"{mesh}/llama4_int8/experts"]
        assert shapes and all(s[1] == 1 for s in shapes), shapes


def test_spec_draft_refused_under_a_mesh():
    _, tcfg, _, tree = configs(NLG)
    params = convert.params_from_numpy(tcfg, tree, "cpu")
    with pytest.raises(NotImplementedError, match="expert-parallel.*spec"):
        ContinuousEngine(tcfg.replace(ep_mesh=(4,)), params, device="cpu", slots=2, capacity=32,
                         paged=True, page_size=4, spec_draft=(tcfg, params))


def test_engine_needs_a_process_group_for_a_mesh():
    _, tcfg, _, tree = configs(NLG)
    with pytest.raises(RuntimeError, match="process group"):
        Engine(tcfg.replace(ep_mesh=(2,)), convert.params_from_numpy(tcfg, tree, "cpu"),
               EngineConfig(), device="cpu")


def test_cli_ep_devices_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", LLAMA4, "--reduced",
         "--moe-impl", "grouped", "--device", "cpu", "--ep-devices", "2x2", "--paged",
         "--page-size", "4", "--requests", "3", "--batch", "3", "--prompt-len", "6",
         "--new-tokens", "4"], capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = res.stdout
    assert "EP serving mesh {'pod': 2, 'data': 2} (gloo): moe_impl=ep_grouped" in out, out
    assert out.count("served 3 requests, 12 tokens") == 1, out  # rank 0 prints
    one = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", LLAMA4, "--reduced",
         "--moe-impl", "grouped", "--device", "cpu", "--paged", "--page-size", "4",
         "--requests", "3", "--batch", "3", "--prompt-len", "6", "--new-tokens", "4"],
        capture_output=True, text=True, env=env, timeout=300)
    sample = [line for line in out.splitlines() if line.startswith("sample:")]
    assert sample and sample == [line for line in one.stdout.splitlines()
                                 if line.startswith("sample:")]


def test_cli_ep_devices_on_the_card_needs_a_gpu_per_rank(capsys):
    import torch

    if torch.cuda.device_count() >= 4:
        pytest.skip("this machine has a GPU for each of the 4 ranks")
    with pytest.raises(SystemExit):
        tserve.main(["--arch", NLG, "--reduced", "--ep-devices", "4"])
    assert "needs 4 GPUs, one per rank" in capsys.readouterr().err
