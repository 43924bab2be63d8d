"""Expert-parallel collectives and MoE layer of the port on
``torch.distributed`` against the JAX package's, on meshes (4,) and (2, 2).

One module fixture spawns 4 gloo ranks (``serving.ep.launch``, a
``file://`` rendezvous under ``tmp_path``, one intra-op thread each) that
compute every case, while one subprocess runs the JAX package under
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` on the same inputs
and writes its per-device results to an npz.

  * the flat and hierarchical all-to-all and their inverses equal JAX's
    exactly (data movement), and so do ``all_gather`` and ``psum``; under
    skewed routing at fixed seeds no token is lost or duplicated, each
    expert row lands on its owner, and the hierarchical exchange equals the
    flat one;
  * ``moe_layer`` under ``ep_serve`` / ``ep_grouped`` takes each schedule
    (replicated dense, replicated grouped, the flat and the hierarchical
    a2a, an a2a with drops at the published capacity factor 1.25) and equals
    JAX's ``moe_layer_ep_serve`` on the same mesh: ``y`` and the aux loss
    at ``test_torch_moe.py``'s ``TOL`` (JAX jitted: eager ``shard_map``
    takes minutes); the replicated schedules also equal the one-device
    layer bit for bit, the drop-free a2a its ``y`` at ``TOL``;
  * the dense mapping table refuses a multi-rank mesh.

A rank that fails or hangs ends the run within its deadline (the launcher's
own tests, at the end).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_ep_ranks as ranks
from repro_torch.core import moe as tmoe
from repro_torch.core.gating import expert_capacity, top_k_gating
from repro_torch.serving import ep
from _torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

pytestmark = pytest.mark.dist

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TOL = dict(atol=1e-5, rtol=1e-5)  # test_torch_moe.py's
E, K, D, F = 8, 2, 32, 64
ROUTING_SEEDS = (0, 1, 2)
# name -> (x shape, kernel, capacity factor, skewed router)
LAYER_CASES = {
    "replicated_dense": ((1, 4), "dense", 1.25, False),  # T*K = E: decode
    "replicated_grouped": ((2, 5), "grouped", 1.25, False),
    "a2a": ((2, 7), "dense", 8.0, False),  # headroom: nothing drops
    "a2a_drops": ((4, 16), "dense", 1.25, True),  # the published factor, a hot expert
}

JAX_SCRIPT = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
jax.config.update("jax_default_matmul_precision", "highest")
from jax.sharding import PartitionSpec as P
from repro.configs.base import FFNSpec
from repro.core.moe_serve import moe_layer_ep_serve
from repro.parallel.collectives import (flat_all_to_all, flat_all_to_all_back,
    hierarchical_all_to_all, hierarchical_all_to_all_back)
from repro.parallel.compat import shard_map
from repro.parallel.sharding import use_mesh
from repro.serving.ep import build_serving_mesh

inp = dict(np.load(sys.argv[1], allow_pickle=True))
out = {}
experts = {k[len("param/"):]: jnp.asarray(v) for k, v in inp.items() if k.startswith("param/")}
for key, shape in (("flat4", (4,)), ("hier22", (2, 2))):
    mesh, rules = build_serving_mesh(shape)
    names = mesh.axis_names
    xg = jnp.asarray(inp[f"buf/{key}"])
    spec4 = P(names if len(names) > 1 else names[0], None, None, None)
    def run(fn):
        body = lambda xs: fn(xs[0])[None]
        return np.asarray(jax.jit(shard_map(body, mesh=mesh, in_specs=spec4, out_specs=spec4))(xg))
    axes = names if len(names) > 1 else names
    out[f"{key}/flat"] = run(lambda b: flat_all_to_all(b, axes))
    out[f"{key}/flat_back"] = run(lambda b: flat_all_to_all_back(flat_all_to_all(b, axes), axes))
    out[f"{key}/gather"] = run(lambda b: jax.lax.all_gather(b[:1], axes, axis=0, tiled=True))
    out[f"{key}/psum"] = run(lambda b: jax.lax.psum(b, axes))
    if len(names) == 2:
        out[f"{key}/hier"] = run(lambda b: hierarchical_all_to_all(b, names[1], names[0]))
        out[f"{key}/hier_back"] = run(lambda b: hierarchical_all_to_all_back(
            hierarchical_all_to_all(b, names[1], names[0]), names[1], names[0]))
    for case in [k[len("x/"):] for k in inp if k.startswith("x/")]:
        kernel, cf = str(inp[f"kernel/{case}"]), float(inp[f"cf/{case}"])
        params = dict(experts, router=jnp.asarray(inp[f"router/{case}"]))
        spec = FFNSpec(kind="moe", d_ff=params["wi"].shape[-1], num_experts=params["wi"].shape[0],
                       top_k=int(inp["K"]), capacity_factor=cf, act="swiglu")
        with use_mesh(mesh, rules):
            y, aux = jax.jit(lambda p, x: moe_layer_ep_serve(None, spec, p, x, kernel=kernel))(
                params, jnp.asarray(inp[f"x/{case}"]))
        out[f"{key}/{case}/y"] = np.asarray(y)
        out[f"{key}/{case}/aux"] = np.asarray(aux)
np.savez(sys.argv[2], **out)
"""


def layer_inputs():
    rng = np.random.default_rng(7)
    router = rng.normal(0, D ** -0.5, (D, E)).astype(np.float32)
    params = {"wi": rng.normal(0, D ** -0.5, (E, D, F)).astype(np.float32),
              "wg": rng.normal(0, D ** -0.5, (E, D, F)).astype(np.float32),
              "wo": rng.normal(0, F ** -0.5, (E, F, D)).astype(np.float32)}
    skew = router.copy()
    skew[:, 3] += 0.6  # expert 3 takes most tokens' first choice
    cases = {}
    for name, (shape, kernel, cf, skewed) in LAYER_CASES.items():
        x = rng.normal(0, 1, (*shape, D)).astype(np.float32)
        if skewed:
            x += 1.0
        cases[name] = dict(x=x, kernel=kernel, cf=cf, E=E, K=K, F=F,
                           router=skew if skewed else router)
    return params, cases


def skewed_logits(seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(4, 8, E)).astype(np.float32)
    hot = rng.choice(E, size=int(rng.integers(1, 3)), replace=False)
    logits[..., hot] += 4.0
    return logits


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep")
    rng = np.random.default_rng(3)
    bufs = {"flat4": rng.normal(size=(4, E, 3, 5)).astype(np.float32),
            "hier22": rng.normal(size=(4, 2 * E, 2, 3)).astype(np.float32)}
    routing = {s: skewed_logits(s) for s in ROUTING_SEEDS}
    params, cases = layer_inputs()
    np.savez(tmp / "in.npz", K=np.int64(K), **{f"buf/{k}": v for k, v in bufs.items()},
             **{f"param/{k}": v for k, v in params.items()},
             **{f"{what}/{k}": np.asarray(c[what]) for k, c in cases.items()
                for what in ("x", "router", "kernel", "cf")})
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    jax_run = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, str(tmp / "in.npz"),
                                str(tmp / "out.npz")], env=env, stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
    try:
        port = ep.launch(ranks.collectives_and_layers, 4, backend="gloo",
                         args=(bufs, routing, cases, params), timeout_s=240, rendezvous_dir=tmp)
        _, err = jax_run.communicate(timeout=300)
        assert jax_run.returncode == 0, err[-3000:]
    finally:
        jax_run.kill()
    jax = dict(np.load(tmp / "out.npz"))
    return dict(port=port, jax=jax, bufs=bufs, routing=routing, params=params, cases=cases)


@pytest.mark.parametrize("mesh,what", [
    (m, w) for m in ("flat4", "hier22")
    for w in ("flat", "flat_back", "hier", "hier_back", "gather", "psum")
    if m == "hier22" or not w.startswith("hier")])  # the two hops need two axes
def test_collectives_equal_jax(results, mesh, what):
    for r in range(4):
        got, want = results["port"][r][f"{mesh}/{what}"], results["jax"][f"{mesh}/{what}"][r]
        if what == "psum":  # the four terms summed in another order
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        else:  # data movement
            np.testing.assert_array_equal(got, want)
    if what.endswith("_back"):  # the inverse restores each rank's buffer
        for r in range(4):
            np.testing.assert_array_equal(results["port"][r][f"{mesh}/{what}"],
                                          results["bufs"][mesh][r])


def test_ep_rank_is_outer_major(results):
    assert [results["port"][r]["hier22/ep_rank"] for r in range(4)] == [0, 1, 2, 3]
    assert [results["port"][r]["flat4/ep_rank"] for r in range(4)] == [0, 1, 2, 3]


@pytest.mark.parametrize("seed", ROUTING_SEEDS)
@pytest.mark.parametrize("mesh", ["flat4", "hier22"])
def test_a2a_token_conservation(results, mesh, seed):
    """Skewed routing: per-rank received counts equal the routing to its
    experts and sum to the global dispatch, every token arrives K times,
    rows land only in their owner's buffer, hierarchical == flat."""
    logits = results["routing"][seed]
    T_loc, E_loc = logits.shape[1], E // 4
    flat = np.stack([results["port"][r][f"{mesh}/route{seed}/flat"] for r in range(4)])
    if mesh == "hier22":
        hier = np.stack([results["port"][r][f"{mesh}/route{seed}/hier"] for r in range(4)])
        np.testing.assert_array_equal(flat, hier)
    counts, ids = flat[..., 1], flat[..., 0]
    assert set(np.unique(counts)) <= {0.0, 1.0}
    eidx = np.stack([top_k_gating(torch.from_numpy(logits[r]), K, T_loc * K).expert_idx.numpy()
                     for r in range(4)])
    for r in range(4):
        lo = r * E_loc
        assert int(counts[r].sum()) == int(((eidx >= lo) & (eidx < lo + E_loc)).sum())
    assert int(counts.sum()) == 4 * T_loc * K
    arrived = np.sort(ids[counts > 0].astype(np.int64))
    np.testing.assert_array_equal(arrived, np.repeat(np.arange(1, 4 * T_loc + 1), K))
    for r in range(4):
        for e_loc in range(E_loc):
            e = r * E_loc + e_loc
            want = sorted(int(t + 1 + s * T_loc) for s in range(4) for t in range(T_loc)
                          for k in range(K) if eidx[s, t, k] == e)
            got = sorted(ids[r, e_loc][counts[r, e_loc] > 0].astype(np.int64).tolist())
            assert got == want, (e, got, want)


@pytest.mark.parametrize("mesh", ["flat4", "hier22"])
@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_layer_schedule_equals_jax(results, mesh, case):
    c = results["cases"][case]
    want = {"replicated_dense": "replicated_dense", "replicated_grouped": "replicated_grouped",
            "a2a": "a2a", "a2a_drops": "a2a"}[case]
    jy, jaux = results["jax"][f"{mesh}/{case}/y"], results["jax"][f"{mesh}/{case}/aux"]
    for r in range(4):
        got = results["port"][r]
        assert got[f"{mesh}/{case}/schedule"] == want
        # every rank returns the same replicated output
        np.testing.assert_array_equal(got[f"{mesh}/{case}/y"], results["port"][0][f"{mesh}/{case}/y"])
        np.testing.assert_allclose(got[f"{mesh}/{case}/y"], jy, **TOL)
        np.testing.assert_allclose(got[f"{mesh}/{case}/aux"], jaux, **TOL)
    if case == "a2a_drops":
        # the published capacity factor drops at a shard's hot expert
        T_loc = c["x"].shape[0] * c["x"].shape[1] // 4
        x = torch.from_numpy(c["x"]).reshape(4, T_loc, D)
        cap = expert_capacity(T_loc, E, K, c["cf"])
        g = [top_k_gating(x[r] @ torch.from_numpy(c["router"]), K, cap) for r in range(4)]
        assert sum(int((~gi.keep).sum()) for gi in g) > 0
        return
    # the replicated schedules and the drop-free a2a are the one-device layer
    p = {k: torch.from_numpy(v) for k, v in results["params"].items()}
    p["router"] = torch.from_numpy(c["router"])
    y, aux = tmoe.moe_layer(None, ranks.ffn_spec(c), p, torch.from_numpy(c["x"]),
                            impl="grouped" if c["kernel"] == "grouped" else "dense")
    if case == "a2a":
        # per-shard gating: the same routes, but the aux counts the pad
        # tokens and pmeans per-shard statistics (JAX's too)
        np.testing.assert_allclose(results["port"][0][f"{mesh}/{case}/y"], y.numpy(), **TOL)
        return
    np.testing.assert_array_equal(results["port"][0][f"{mesh}/{case}/y"], y.numpy())
    np.testing.assert_allclose(results["port"][0][f"{mesh}/{case}/aux"], aux.numpy(), **TOL)


@pytest.mark.parametrize("mesh", ["flat4", "hier22"])
def test_routing_stats_under_ep(results, mesh):
    """``with_stats`` re-runs the gating on the replicated tokens: at decode
    it is the dispatch's own gating, the one-device layer's statistics."""
    c = results["cases"]["replicated_dense"]
    p = {k: torch.from_numpy(v) for k, v in results["params"].items()}
    p["router"] = torch.from_numpy(c["router"])
    _, _, stats = tmoe.moe_layer(None, ranks.ffn_spec(c), p, torch.from_numpy(c["x"]),
                                 impl="dense", with_stats=True)
    for r in range(4):
        np.testing.assert_array_equal(
            results["port"][r][f"{mesh}/replicated_dense/tokens_per_expert"],
            stats.tokens_per_expert.numpy())


@pytest.mark.parametrize("mesh", ["flat4", "hier22"])
def test_dense_impl_refused_under_multi_rank_mesh(results, mesh):
    msg = results["port"][0][f"{mesh}/dense_refusal"]
    assert "numerically unsafe" in msg and "multi-device mesh" in msg, msg


def test_launcher_reports_a_failing_rank(tmp_path):
    with pytest.raises(RuntimeError, match="(?s)rank 1 failed.*fails on purpose"):
        ep.launch(ranks.raise_on, 2, backend="gloo", args=(1,), timeout_s=60,
                  rendezvous_dir=tmp_path)


def test_launcher_deadline_ends_a_hung_rank(tmp_path):
    with pytest.raises(TimeoutError, match="did not finish within"):
        ep.launch(ranks.sleep_forever, 1, backend="gloo", timeout_s=8, rendezvous_dir=tmp_path)


def test_ep_phase_imports_without_jax_or_repro():
    """``scripts/ep_phase.py`` (phase 18 alone, and its ranks) stands apart
    from JAX as ``chip_smoke.py`` does."""
    from test_torch_isolation import BLOCKED_IMPORTS

    root = os.path.join(os.path.dirname(__file__), "..")
    res = subprocess.run([sys.executable, "-c", BLOCKED_IMPORTS,
                          os.path.join(root, "scripts", "ep_phase.py")], capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=SRC), timeout=120)
    assert res.returncode == 0, res.stderr
