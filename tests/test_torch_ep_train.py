"""Expert-parallel training of the port on ``torch.distributed`` against the
JAX package's sharded training, on meshes (2, 2) ``data`` x ``model``, (2, 2)
``pod`` x ``data`` under ``ep_pod`` and (4,) ``data``.

One module fixture spawns 4 gloo ranks (``serving.ep.launch``, one intra-op
thread each) that compute every port case, while one subprocess runs the
JAX package under ``--xla_force_host_platform_device_count=4`` on the same
inputs and writes its results to an npz (jitted: eager ``shard_map`` takes
minutes; two such processes side by side, one for the train steps).

  * ``moe_layer(impl="ep")`` (``core/moe_parallel.py``): each rank's
    output rows, the aux loss and the gradients of ``sum(y * w) + C_AUX *
    aux`` in x, the router (summed over the batch ranks) and the rank's
    expert slices against JAX's ``moe_layer_ep`` under ``jax.grad``: the a2a
    schedule on every mesh (the flat exchange, and the two hops under
    ``ep_pod``), the all-gather one at ``t_loc * K <= E``, SwiGLU and GELU
    experts, at the published capacity factor 1.25 (a hot expert drops
    assignments per shard) and at the headroom E / K; its routing stats
    (``with_stats``, the replicated token set) too;
  * three AdamW steps (``training/ep.py::train_rank``, ZeRO-1) of reduced
    llama4-maverick on (2, 2) ``data`` x ``model`` and reduced
    nlg-350m-prmoe-32-64 on (4,), at 1.25 and at the headroom, against JAX's
    ``make_train_step`` under ``use_mesh`` with ``param_pspecs(mode="train")``:
    each step's loss, every leaf after step 3 (the first step's learning
    rate is 0, so only later steps show an update), the ZeRO-1 moments
    gathered back against JAX's ``m`` / ``v``, and each rank's moment bytes;
  * the data pipeline's rows per rank against JAX's addressable shards;
  * ``launch/steps.py::make_train_entry`` with ``accum_steps=2`` on one
    device against JAX's, on reduced llama4 and seamless-m4t-medium (whose
    encoder must receive gradients through ``encode_train``).

Measured on this CPU (f32): layer outputs within 7.2e-7 of JAX's, the
gradients in x within 1.5e-6 and in the experts within 9.6e-6; step losses
within 9.6e-7; leaves after step 3 within 5.4e-7, but for 12 values of
llama4's embedding at the headroom (1.1e-4: AdamW's m / sqrt(v) over
near-zero gradients, whose first-step values are within 5.3e-9 of JAX's);
moments within 7.6e-7 (m) and 9.4e-9 (v); the accumulating entry's losses
within 4.8e-7, leaves 5.2e-8, moments 1.2e-8.  The bounds are JAX's own:
1e-4 on outputs, 5e-4 on gradients, 1e-5 on losses, 2e-4 on leaves; 2e-6 on
moments (m is 0.1 of a gradient, v 0.05 of its square).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_ep_ranks as ranks
from repro_torch.configs.registry import get_config, make_reduced, with_capacity_factor
from repro_torch.data.pipeline import local_rows
from repro_torch.parallel.sharding import EpMesh, RULESETS, coords_of
from repro_torch.serving import ep
from _torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

pytestmark = pytest.mark.dist

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
OUT_TOL, GRAD_TOL, LOSS_TOL, LEAF_TOL, MOMENT_TOL = 1e-4, 5e-4, 1e-5, 2e-4, 2e-6
E, K, D, F = 8, 2, 32, 64
HEADROOM = E / K  # the shard's capacity takes every assignment
C_AUX = 0.5
LAYER_CASES = {
    f"{mesh}/{sched}/{act}/{cf}": (mesh, sched, act, cf)
    for mesh in ranks.TRAIN_MESHES for act in ("swiglu", "gelu")
    for sched, cfs in (("a2a", (1.25, HEADROOM)), ("allgather", (1.25,)))
    for cf in cfs if not (sched == "allgather" and mesh == "pd22")}
# the all-gather schedule gathers over 'data' only: JAX has no case for it
# under ep_pod, whose experts are spread over ('pod', 'data')
TRAIN_ARCHS = {"llama4": ("llama4-maverick-400b-a17b", "dm22"),
               "prmoe": ("nlg-350m-prmoe-32-64", "d4")}
TRAIN_CASES = {f"{a}/{cf}": (arch, mesh, cf) for a, (arch, mesh) in TRAIN_ARCHS.items()
               for cf in (1.25, 4.0)}  # reduced: 4 experts top-1, so 4.0 is the headroom
STEPS, TB, TS, LR = 3, 8, 16, 1e-3
ENTRY_ARCHS = ("llama4-maverick-400b-a17b", "seamless-m4t-medium")
ENTRY_B, ENTRY_S, ENTRY_STEPS = 4, 16, 2
# make_train_entry under (2, 2) data x model, against the port's one-device
# entry at the headroom (E / K of the reduced config: nothing drops)
MESH_ENTRY_ARCH, MESH_ENTRY_CF = "llama4-maverick-400b-a17b", 4.0
ROW_BATCHES = (8, 6, 2)

JAX_SCRIPT = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
jax.config.update("jax_default_matmul_precision", "highest")
from jax.sharding import NamedSharding
from repro.configs.base import FFNSpec
from repro.configs.registry import get_config, make_reduced, with_capacity_factor
from repro.core import moe_parallel
from repro.core.moe import moe_layer
from repro.data.pipeline import data_stream, device_put_batch
from repro.launch.steps import make_train_entry
from repro.parallel.compat import make_mesh
from repro.parallel.params import param_pspecs
from repro.parallel.sharding import RULESETS, use_mesh
from repro.training.optimizer import init_adamw
from repro.training.trainer import TrainConfig, make_train_step

inp = dict(np.load(sys.argv[1], allow_pickle=True))
meta = inp["meta"].item()
part = sys.argv[3]  # "train": the train steps; "rest": everything else
out = {}

def flat(tree, prefix=""):
    res = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            res.update(flat(v, prefix + k + "/"))
        else:
            res[prefix + k] = np.asarray(v)
    return res

def nest(d):
    tree = {}
    for path, v in d.items():
        node = tree
        *head, last = path.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = jnp.asarray(v)
    return tree

meshes = {name: (make_mesh(shape, names), RULESETS[rs]) for name, (shape, names, rs)
          in meta["meshes"].items()}

# the layer cases
for name, (mname, sched, act, cf) in (meta["layer_cases"] if part == "rest" else {}).items():
    mesh, rules = meshes[mname]
    moe_parallel.set_ep_pod(meta["meshes"][mname][2] == "ep_pod")
    spec = FFNSpec(kind="moe", d_ff=meta["F"], num_experts=meta["E"], top_k=meta["K"],
                   capacity_factor=cf, act=act)
    params = {k: jnp.asarray(inp[f"expert/{k}"]) for k in ("wi", "wg", "wo")
              if act == "swiglu" or k != "wg"}
    params["router"] = jnp.asarray(inp[f"layer/{name}/router"])
    x = jnp.asarray(inp[f"layer/{name}/x"])
    w = jnp.asarray(inp[f"layer/{name}/w"])

    def f(p, x):
        y, aux, stats = moe_layer(None, spec, p, x, impl="ep", with_stats=True)
        return jnp.sum(y * w) + meta["c_aux"] * aux, (y, aux, stats)

    with use_mesh(mesh, rules):
        (_, (y, aux, stats)), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
            params, x)
    out[f"layer/{name}/y"] = np.asarray(y)
    out[f"layer/{name}/aux"] = np.asarray(aux)
    out[f"layer/{name}/d_x"] = np.asarray(gx)
    for k, g in gp.items():
        out[f"layer/{name}/d_{k}"] = np.asarray(g)
    out[f"layer/{name}/tokens_per_expert"] = np.asarray(stats.tokens_per_expert)
    out[f"layer/{name}/dropped_frac"] = np.asarray(stats.dropped_frac)
moe_parallel.set_ep_pod(False)

# the train-step cases
for name, (arch, mname, cf) in (meta["train_cases"] if part == "train" else {}).items():
    mesh, rules = meshes[mname]
    cfg = with_capacity_factor(make_reduced(get_config(arch)), cf).replace(moe_impl="ep")
    init = nest({k[len(f"train/{name}/init/"):]: v for k, v in inp.items()
                 if k.startswith(f"train/{name}/init/")})
    step = make_train_step(cfg, TrainConfig(lr=meta["lr"], warmup_steps=1, decay_steps=10))
    with use_mesh(mesh, rules):
        pspecs = param_pspecs(mesh, init, mode="train")
        p = jax.tree.map(lambda t, s: jax.device_put(t, NamedSharding(mesh, s)), init, pspecs)
        st = init_adamw(p)
        data = data_stream(cfg.vocab_size, meta["tb"], meta["ts"], seed=0)
        fn = jax.jit(step)
        losses, norms = [], []
        for _ in range(meta["steps"]):
            toks, labels = next(data)
            p, st, m = fn(p, st, toks, labels)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    out[f"train/{name}/loss"] = np.asarray(losses)
    out[f"train/{name}/grad_norm"] = np.asarray(norms)
    for what, tree in (("params", p), ("m", st.m), ("v", st.v)):
        for k, v in flat(tree).items():
            out[f"train/{name}/{what}/{k}"] = v

# the pipeline's rows on every mesh
for mname, (mesh, rules) in (meshes if part == "rest" else {}).items():
    for B in meta["row_batches"]:
        arr = np.arange(B * 2, dtype=np.int32).reshape(B, 2)
        with use_mesh(mesh, rules):
            a, _ = device_put_batch(arr, arr)
        rows = np.zeros((mesh.devices.size, 2), np.int64)
        shape = mesh.devices.shape
        for shard in a.addressable_shards:
            coords = tuple(int(c) for c in np.argwhere(mesh.devices == shard.device)[0])
            rank = int(np.ravel_multi_index(coords, shape))
            r = shard.index[0]
            rows[rank] = (r.start or 0, B if r.stop is None else r.stop)
        out[f"rows/{mname}/{B}"] = rows

# make_train_entry, one device, two steps of two microbatches
for arch in (meta["entry_archs"] if part == "rest" else ()):
    cfg = make_reduced(get_config(arch))
    init = nest({k[len(f"entry/{arch}/init/"):]: v for k, v in inp.items()
                 if k.startswith(f"entry/{arch}/init/")})
    batch = {k[len(f"entry/{arch}/batch/"):]: jnp.asarray(v) for k, v in inp.items()
             if k.startswith(f"entry/{arch}/batch/")}
    fn = jax.jit(make_train_entry(cfg, accum_steps=2))
    p, st = init, init_adamw(init)
    losses = []
    for _ in range(meta["entry_steps"]):
        p, st, m = fn(p, st, batch)
        losses.append(float(m["loss"]))
    out[f"entry/{arch}/loss"] = np.asarray(losses)
    for what, tree in (("params", p), ("m", st.m)):
        for k, v in flat(tree).items():
            out[f"entry/{arch}/{what}/{k}"] = v
np.savez(sys.argv[2], **out)
"""


def layer_inputs():
    rng = np.random.default_rng(11)
    experts = {"wi": rng.normal(0, D ** -0.5, (E, D, F)).astype(np.float32),
               "wg": rng.normal(0, D ** -0.5, (E, D, F)).astype(np.float32),
               "wo": rng.normal(0, F ** -0.5, (E, F, D)).astype(np.float32)}
    router = rng.normal(0, D ** -0.5, (D, E)).astype(np.float32)
    skew = router.copy()
    skew[:, 3] += 0.6  # expert 3 takes most tokens' first choice
    cases = {}
    for name, (mesh, sched, act, cf) in LAYER_CASES.items():
        shape = (8, 8) if sched == "a2a" else (4, 1)
        x = rng.normal(0, 1, (*shape, D)).astype(np.float32)
        skewed = cf == 1.25 and sched == "a2a"
        if skewed:
            x += 1.0
        cases[name] = dict(mesh=mesh, act=act, cf=cf, E=E, K=K, F=F, x=x,
                           w=rng.normal(0, 1, x.shape).astype(np.float32),
                           router=skew if skewed else router)
    return experts, cases


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def jax_init(cfg_name, cf=None):
    """The JAX package's initial tree of a reduced config (numpy leaves)."""
    from repro.configs.registry import get_config as jget
    from repro.configs.registry import make_reduced as jreduced
    from repro.configs.registry import with_capacity_factor as jcf
    from repro.models.model import init_params
    import jax

    cfg = jreduced(jget(cfg_name))
    if cf is not None:
        cfg = jcf(cfg, cf)
    return flat(jax.device_get(jax.jit(lambda k: init_params(cfg, k))(jax.random.PRNGKey(0))))


def nest(d):
    tree = {}
    for path, v in d.items():
        node = tree
        *head, last = path.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


def entry_batch(arch):
    cfg = make_reduced(get_config(arch))
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (ENTRY_B, ENTRY_S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        fe = cfg.frontend
        batch["source"] = rng.normal(0, 1, (ENTRY_B, fe.n_tokens, fe.embed_dim)).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep_train")
    experts, cases = layer_inputs()
    inits = {name: jax_init(arch, cf) for name, (arch, _, cf) in TRAIN_CASES.items()}
    entry_inits = {arch: jax_init(arch) for arch in ENTRY_ARCHS}
    batches = {arch: entry_batch(arch) for arch in ENTRY_ARCHS}
    meta = dict(meshes=ranks.TRAIN_MESHES, layer_cases=LAYER_CASES, train_cases=TRAIN_CASES,
                E=E, K=K, F=F, c_aux=C_AUX, lr=LR, tb=TB, ts=TS, steps=STEPS,
                row_batches=ROW_BATCHES, entry_archs=ENTRY_ARCHS, entry_steps=ENTRY_STEPS)
    arrays = {f"expert/{k}": v for k, v in experts.items()}
    for name, c in cases.items():
        arrays.update({f"layer/{name}/{k}": c[k] for k in ("x", "w", "router")})
    for name, init in inits.items():
        arrays.update({f"train/{name}/init/{k}": v for k, v in init.items()})
    for arch in ENTRY_ARCHS:
        arrays.update({f"entry/{arch}/init/{k}": v for k, v in entry_inits[arch].items()})
        arrays.update({f"entry/{arch}/batch/{k}": v for k, v in batches[arch].items()})
    np.savez(tmp / "in.npz", meta=np.array(meta, dtype=object), **arrays)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    # two JAX processes side by side: the train steps' compiles take most
    jax_runs = [subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, str(tmp / "in.npz"),
                                  str(tmp / f"{part}.npz"), part], env=env,
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for part in ("train", "rest")]
    try:
        train_cases = {name: dict(arch=arch, mesh=mesh, cf=cf, init=nest(inits[name]))
                       for name, (arch, mesh, cf) in TRAIN_CASES.items()}
        port = ep.launch(run_ranks, 4, backend="gloo",
                         args=(cases, experts, train_cases, nest(entry_inits[MESH_ENTRY_ARCH]),
                               batches[MESH_ENTRY_ARCH]), timeout_s=300, rendezvous_dir=tmp)
        entry = {arch: port_entry(arch, entry_inits[arch], batches[arch]) for arch in ENTRY_ARCHS}
        entry["one_device_headroom"] = port_entry(MESH_ENTRY_ARCH, entry_inits[MESH_ENTRY_ARCH],
                                                  batches[MESH_ENTRY_ARCH], MESH_ENTRY_CF)
        for run in jax_runs:
            _, err = run.communicate(timeout=400)
            assert run.returncode == 0, err[-3000:]
    finally:
        for run in jax_runs:
            run.kill()
    jax_out = {**np.load(tmp / "train.npz"), **np.load(tmp / "rest.npz")}
    return dict(port=port, jax=jax_out, cases=cases, entry=entry, inits=inits)


def run_ranks(rank, cases, experts, train_cases, entry_init, entry_batch):
    return {"layer": ranks.ep_layer_grads(rank, cases, experts, C_AUX),
            "train": ranks.ep_train_steps(rank, train_cases, STEPS, TB, TS, LR),
            "entry": ranks.ep_train_entry(rank, MESH_ENTRY_ARCH, MESH_ENTRY_CF, entry_init,
                                          entry_batch, ENTRY_STEPS)}


def port_entry(arch, init, batch, cf=None):
    """``make_train_entry`` (accum_steps=2) on the CPU: losses, leaves and
    first moments after ``ENTRY_STEPS`` steps (at capacity factor ``cf``,
    or the reduced config's)."""
    from repro_torch import convert
    from repro_torch.launch.steps import make_train_entry
    from repro_torch.models.model import param_leaves
    from repro_torch.training.trainer import init_opt_state

    cfg = make_reduced(get_config(arch))
    if cf is not None:
        cfg = with_capacity_factor(cfg, cf)
    params = convert.params_from_numpy(cfg, nest(init), "cpu")
    step = make_train_entry(cfg, accum_steps=2)
    state = init_opt_state(params)
    tb = {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v)
          for k, v in batch.items()}
    losses = []
    for _ in range(ENTRY_STEPS):
        params, state, m = step(params, state, tb)
        losses.append(float(m["loss"]))
    return {"loss": losses, "params": {k: v.detach().numpy() for k, v in param_leaves(params).items()},
            "m": {k: v.numpy() for k, v in state.m.items()}}


def maxdiff(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)))) \
        if np.size(a) else 0.0


# ---------------------------------------------------------------------------
# The layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_layer_output_and_grads_equal_jax(results, case):
    port = [r["layer"][case] for r in results["port"]]
    jx = {k[len(f"layer/{case}/"):]: v for k, v in results["jax"].items()
          if k.startswith(f"layer/{case}/")}
    mesh, sched, act, cf = LAYER_CASES[case]
    data_ranks = {}
    for r, res in enumerate(port):
        lo, hi = res["rows"]
        assert maxdiff(res["y"], jx["y"][lo:hi]) <= OUT_TOL, (r, maxdiff(res["y"], jx["y"][lo:hi]))
        assert abs(res["aux"] - float(jx["aux"])) <= OUT_TOL
        assert maxdiff(res["d_x"], jx["d_x"][lo:hi]) <= GRAD_TOL
        e0, ne = res["experts"]
        f0, nf = res["f"]
        for k in ("wi", "wg", "wo"):
            if k == "wg" and act != "swiglu":
                continue
            want = jx[f"d_{k}"][e0:e0 + ne]
            want = want[:, f0:f0 + nf] if k == "wo" else want[..., f0:f0 + nf]
            assert maxdiff(res[f"d_{k}"], want) <= GRAD_TOL, (r, k, maxdiff(res[f"d_{k}"], want))
        np.testing.assert_array_equal(res["tokens_per_expert"], jx["tokens_per_expert"])
        assert abs(res["dropped_frac"] - float(jx["dropped_frac"])) <= 1e-6
        data_ranks.setdefault((lo, hi), []).append(res["d_router"])
    # the router's gradient: the sum over the batch ranks (each row block
    # once), the same on ranks that share their rows
    for same in data_ranks.values():
        for g in same[1:]:
            np.testing.assert_array_equal(g, same[0])
    total = sum(same[0] for same in data_ranks.values())
    assert maxdiff(total, jx["d_router"]) <= GRAD_TOL, maxdiff(total, jx["d_router"])


def test_layer_cases_drop_and_take_both_schedules(results):
    """cf 1.25 drops assignments per shard in every a2a case (the hot
    expert), the headroom drops none, and JAX reports the same drops."""
    jx = results["jax"]
    for case, (mesh, sched, act, cf) in LAYER_CASES.items():
        drop = float(jx[f"layer/{case}/dropped_frac"])
        if sched == "a2a" and cf == 1.25:
            assert drop > 0, case
        if cf == HEADROOM:
            assert drop == 0, case
    assert {s for _, s, _, _ in LAYER_CASES.values()} == {"a2a", "allgather"}


def test_allgather_refused_under_ep_pod():
    """The all-gather schedule gathers over 'data' only; under ep_pod the
    layer refuses it, as JAX's cannot run it."""
    import repro_torch.core.moe_parallel as mp
    from repro_torch.configs.base import FFNSpec

    mesh = EpMesh((2, 2), ("pod", "data"), 0, (0, 0), None)
    spec = FFNSpec(kind="moe", d_ff=F, num_experts=E, top_k=K, capacity_factor=1.25)
    from repro_torch.parallel.sharding import use_mesh

    with use_mesh(mesh, RULESETS["ep_pod"]):
        w = {"router": torch.zeros(D, E), "wi": torch.zeros(E, D, F),
             "wg": torch.zeros(E, D, F), "wo": torch.zeros(E, F, D)}
        with pytest.raises(ValueError, match="all-gather schedule"):
            mp.moe_layer_ep(None, spec, w, torch.zeros(1, 1, D))


def test_remat_recomputes_under_the_forward_mesh(monkeypatch):
    """A layer that ``remat`` recomputes sees the mesh of its forward, also
    where the backward runs on a thread of its own (as the autograd engine
    runs a CUDA backward) outside the caller's ``use_mesh``."""
    import threading

    from repro_torch.configs.base import FFNSpec, LayerSpec, Segment
    from repro_torch.models import transformer
    from repro_torch.parallel.sharding import get_mesh, get_rules, use_mesh

    seen = []

    def layer(cfg, ls, p, x, positions, **kw):
        seen.append((get_mesh(), get_rules()))
        return x * p["w"], None, torch.zeros(())

    monkeypatch.setattr(transformer, "apply_layer", layer)
    mesh = EpMesh((2, 2), ("pod", "data"), 0, (0, 0), None)
    w = torch.full((1, 3), 2.0, requires_grad=True)
    seg = Segment((LayerSpec(mixer=None, ffn=FFNSpec(kind="dense", d_ff=3)),), 1)
    with use_mesh(mesh, RULESETS["ep_pod"]):
        y, _, _ = transformer.apply_segment(None, seg, {"pos0": {"w": w}}, torch.ones(3), None,
                                            remat=True)
    grads = []
    t = threading.Thread(target=lambda: grads.append(torch.autograd.grad(y.sum(), w)[0]))
    t.start()
    t.join()
    assert len(seen) == 2, seen  # the forward and its recomputation
    assert all(m is mesh and r is RULESETS["ep_pod"] for m, r in seen), seen
    torch.testing.assert_close(grads[0], torch.ones(1, 3))


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------


def rank_slice(cfg, path, full_shape, mname, rank):
    """The index of the slice of an expert leaf that ``rank`` holds:
    experts over the ruleset's expert axes, d_ff over ``model``."""
    from repro_torch.parallel.params import f_dim, layer_ffn

    shape, names, ruleset = ranks.TRAIN_MESHES[mname]
    coords = dict(zip(names, coords_of(rank, shape)))
    sizes = dict(zip(names, shape))
    rule = RULESETS[ruleset]["expert"]
    ep, idx = 1, 0
    for a in (rule,) if isinstance(rule, str) else rule:
        ep *= sizes[a]
        idx = idx * sizes[a] + coords[a]
    keys = path.split("/")
    E_loc = layer_ffn(cfg, keys).num_experts // ep
    sl = [slice(None)] * len(full_shape)
    sl[1] = slice(idx * E_loc, (idx + 1) * E_loc)  # stacked: [repeats, E, ...]
    if "model" in sizes:
        fd = f_dim(keys, len(full_shape))
        nf = full_shape[fd] // sizes["model"]
        sl[fd] = slice(coords["model"] * nf, (coords["model"] + 1) * nf)
    return tuple(sl)


def jax_leaves(results, prefix):
    return {k[len(prefix):]: v for k, v in results["jax"].items() if k.startswith(prefix)}


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_step_losses_equal_jax(results, case):
    want = results["jax"][f"train/{case}/loss"]
    port = [r["train"][case] for r in results["port"]]
    for res in port:
        assert res["loss"] == port[0]["loss"]  # the global loss, the same on every rank
        assert maxdiff(res["loss"], want) <= LOSS_TOL, (res["loss"], want)
        assert maxdiff(res["grad_norm"], results["jax"][f"train/{case}/grad_norm"]) <= LOSS_TOL


@pytest.mark.parametrize("what", ["params", "m", "v"])
@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_step_leaves_and_moments_equal_jax(results, case, what):
    """After step 3 every leaf (2e-4) and, gathered back from the ZeRO-1
    slices over the batch ranks, every first and second moment."""
    arch, mname, cf = TRAIN_CASES[case]
    cfg = with_capacity_factor(make_reduced(get_config(arch)), cf)
    port = [r["train"][case] for r in results["port"]]
    want_all = jax_leaves(results, f"train/{case}/{what}/")
    assert set(want_all) == set(port[0]["params"])
    tol = LEAF_TOL if what == "params" else MOMENT_TOL
    for path, want in want_all.items():
        for r, res in enumerate(port):
            zero, _, _, numel, dp, index, size = res["parts"][path]
            got = res[what][path]
            if not zero:  # an expert shard: this rank's slice, whole moments
                want_r = want[rank_slice(cfg, path, want.shape, mname, r)]
                assert maxdiff(got, want_r) <= tol, (path, r, maxdiff(got, want_r))
            elif what == "params":  # replicated
                assert maxdiff(got, want) <= tol, (path, r, maxdiff(got, want))
            else:  # this rank's ZeRO-1 slice
                assert got.shape == (size,) and size == -(-numel // dp)
                ref = want.reshape(-1)[index * size:(index + 1) * size]
                assert maxdiff(got[:ref.size], ref) <= tol, (path, r, maxdiff(got[:ref.size], ref))
    if what == "params":  # the steps after the first moved the leaves
        init = results["inits"][case]
        assert max(maxdiff(v, init[k]) for k, v in want_all.items()) > 1e-4


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_zero1_moment_bytes(results, case):
    """A replicated leaf's moments take 1/dp of its f32 bytes on each rank
    (ceil), an expert shard's its whole slice's; the batch ranks' slices
    tile the leaf."""
    for res in (r["train"][case] for r in results["port"]):
        total = 0
        for path, (zero, axes, _, numel, dp, index, size) in res["parts"].items():
            local = res["params"][path].size
            want = size if zero else local
            assert res["m"][path].size == res["v"][path].size == want
            if zero:
                assert dp == 4 // (2 if case.startswith("llama4") else 1) and size * dp >= numel
            total += 2 * 4 * want
        assert res["moment_bytes"] == total
    index = {r["train"][case]["parts"][p][5] for r in results["port"]
             for p in r["train"][case]["parts"] if r["train"][case]["parts"][p][0]}
    assert index == set(range(2 if case.startswith("llama4") else 4))


# ---------------------------------------------------------------------------
# The pipeline and the accumulating entry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mname", list(ranks.TRAIN_MESHES))
def test_pipeline_rows_equal_jax_shards(results, mname):
    shape, names, ruleset = ranks.TRAIN_MESHES[mname]
    for B in ROW_BATCHES:
        want = results["jax"][f"rows/{mname}/{B}"]
        for rank in range(4):
            mesh = EpMesh(shape, names, rank, coords_of(rank, shape), None)
            rows = local_rows(mesh, RULESETS[ruleset], B)
            assert (rows.start, rows.stop) == tuple(want[rank]), (mname, B, rank)


@pytest.mark.parametrize("arch", ENTRY_ARCHS)
def test_train_entry_accumulates_as_jax(results, arch):
    """Two steps of two microbatches: losses, every leaf and every first
    moment (the accumulated gradient) against JAX's ``make_train_entry``;
    seamless's encoder leaves get gradients."""
    port = results["entry"][arch]
    jx = results["jax"]
    assert maxdiff(port["loss"], jx[f"entry/{arch}/loss"]) <= LOSS_TOL
    for what, tol in (("params", LEAF_TOL), ("m", MOMENT_TOL)):
        want = jax_leaves(results, f"entry/{arch}/{what}/")
        assert set(want) == set(port[what])
        for k, v in want.items():
            assert maxdiff(port[what][k], v) <= tol, (k, maxdiff(port[what][k], v))
    if arch.startswith("seamless"):
        enc = [k for k in port["m"] if k.startswith("encoder/")]
        assert enc and all(np.abs(port["m"][k]).max() > 0 for k in enc
                           if not k.endswith("scale"))


def test_train_entry_under_a_mesh_equals_one_device(results):
    """``make_train_entry`` with two microbatches under (2, 2) data x model,
    every rank given the global batch: the losses, every leaf (a rank's
    expert slice) and every first moment (gathered from the ZeRO-1 slices)
    equal the one-device entry's at the headroom."""
    want = results["entry"]["one_device_headroom"]
    cfg = with_capacity_factor(make_reduced(get_config(MESH_ENTRY_ARCH)), MESH_ENTRY_CF)
    for r, res in enumerate(r["entry"] for r in results["port"]):
        assert maxdiff(res["loss"], want["loss"]) <= LOSS_TOL, (res["loss"], want["loss"])
        for what, tol in (("params", LEAF_TOL), ("m", MOMENT_TOL)):
            for path, w in want[what].items():
                zero, _, _, numel, dp, index, size = res["parts"][path]
                got = res[what][path]
                if not zero:
                    w = w[rank_slice(cfg, path, w.shape, "dm22", r)]
                elif what == "m":
                    w = w.reshape(-1)[index * size:(index + 1) * size]
                    got = got[:w.size]
                assert maxdiff(got, w) <= tol, (what, path, r, maxdiff(got, w))
