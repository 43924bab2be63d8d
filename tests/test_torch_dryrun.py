"""The port's dry run (``launch/steps.py``'s abstract specs on the meta device,
``launch/dryrun.py``, ``launch/report.py``) and the analysis CLI:

* ``SHAPES`` / ``shape_applicable`` equal JAX's for every arch x shape;
* for every assigned arch at full size, ``abstract_params`` has JAX's leaf
  paths, shapes, dtypes and byte total (``jax.eval_shape(init_params)``),
  nothing allocated;
* under a 4-rank mesh a rank's abstract parameter and ZeRO-1 moment bytes
  equal those of the real tree ``shard_params`` cuts from a reduced config
  and of the moments ``init_adamw`` gives it; at full size the abstract
  moments are ``init_adamw``'s (f32) past JAX's bf16 threshold too;
* the CLIs: ``analyze --arch nlg-350m-moe128 --device cpu --no-ep`` exits 1
  with ROADMAP item 10's host syncs as its only errors, ``dryrun --arch
  llama4-maverick-400b-a17b --shape decode_32k`` and ``report`` over its
  JSON exit 0.
"""
import json

import jax
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401

from repro_torch.configs.registry import ASSIGNED, get_config, make_reduced
from repro_torch.configs.shapes import SHAPES, shape_applicable
from repro_torch.launch import steps
from repro_torch.models.model import init_params, param_leaves


def test_shapes_match_jax():
    from repro.configs.registry import get_config as jget
    from repro.configs.shapes import SHAPES as JSHAPES
    from repro.configs.shapes import shape_applicable as japplicable

    assert {k: (s.seq_len, s.global_batch, s.kind) for k, s in SHAPES.items()} == \
        {k: (s.seq_len, s.global_batch, s.kind) for k, s in JSHAPES.items()}
    for arch in ASSIGNED:
        for name in SHAPES:
            assert shape_applicable(get_config(arch), SHAPES[name]) == \
                japplicable(jget(arch), JSHAPES[name])


@pytest.mark.parametrize("arch", ASSIGNED)
def test_abstract_params_match_jax(arch):
    from repro.configs.registry import get_config as jget
    from repro.models.model import init_params as jinit

    shapes = jax.eval_shape(lambda: jinit(jget(arch), jax.random.PRNGKey(0)))
    want = {"/".join(str(k.key) for k in path): (tuple(v.shape), str(v.dtype))
            for path, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    params = steps.abstract_params(get_config(arch))
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in param_leaves(params).items()}
    assert all(v.device.type == "meta" for v in param_leaves(params).values())
    assert got == want
    jbytes = sum(v.size * v.dtype.itemsize for v in jax.tree.leaves(shapes))
    from repro_torch.quant import tree_bytes

    assert tree_bytes(params) == jbytes


@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b", "kimi-k2-1t-a32b"])
def test_rank_bytes_match_the_real_shards(arch):
    from repro_torch.parallel.params import shard_params, zero_partition
    from repro_torch.parallel.sharding import DEFAULT_RULES
    from repro_torch.training.optimizer import init_adamw
    from repro_torch.quant import tree_bytes

    cfg = make_reduced(get_config(arch))
    real = init_params(cfg, seed=0, device="cpu")
    for rank in range(4):
        mesh = steps.paper_mesh((4,), rank=rank)
        for mode in ("serve", "train"):
            cut = shard_params(mesh, DEFAULT_RULES, real, cfg, mode=mode)
            ab = steps.abstract_params(cfg, mesh, mode=mode)
            assert {k: tuple(v.shape) for k, v in param_leaves(ab).items()} == \
                {k: tuple(v.shape) for k, v in param_leaves(cut).items()}
            assert tree_bytes(ab) == tree_bytes(cut) < tree_bytes(real)
        leaves = param_leaves(cut)
        moments = init_adamw(leaves, zero_partition(mesh, DEFAULT_RULES, leaves, cfg))
        opt = steps.abstract_opt_state(cfg, ab, mesh)
        assert tree_bytes(opt.m) + tree_bytes(opt.v) == tree_bytes(moments.m) + \
            tree_bytes(moments.v)


@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b", "kimi-k2-1t-a32b"])
def test_abstract_moments_are_what_the_trainer_allocates(arch):
    """Past ``_BF16_OPT_THRESHOLD`` parameters too (both archs at full size
    are), the dry run's moments have the shapes and dtype (f32) of the ones
    ``init_adamw`` allocates, on meta."""
    from repro_torch.configs.base import count_params
    from repro_torch.training.optimizer import init_adamw

    cfg = get_config(arch)
    assert count_params(cfg) > steps._BF16_OPT_THRESHOLD
    ab = steps.abstract_params(cfg)
    real = init_adamw(param_leaves(ab))
    opt = steps.abstract_opt_state(cfg, ab)
    for got, want in ((opt.m, real.m), (opt.v, real.v)):
        assert {k: (tuple(t.shape), t.dtype) for k, t in got.items()} == \
            {k: (tuple(t.shape), t.dtype) for k, t in want.items()}


def test_dryrun_reckons_the_train_state():
    """The bytes the llama4 training phase reckons its peak from: bf16
    parameters and gradients, f32 moments (no accumulation: the trainer's
    own step)."""
    from repro_torch.configs.base import count_params
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.dryrun import state_bytes

    cfg = make_reduced(get_config("llama4-maverick-400b-a17b"))
    n = count_params(cfg)
    b = state_bytes(cfg, InputShape("t", 64, 4, "train"), accumulate=False)
    assert (b["params"], b["grads"], b["moments"]) == (4 * n, 4 * n, 8 * n)  # f32 reduced config
    assert b["inputs"] == 2 * 4 * 64 * 8


def test_dryrun_and_report_cli(tmp_path, capsys):
    from repro_torch.launch import dryrun, report

    out = tmp_path / "dry.json"
    assert dryrun.main(["--arch", "llama4-maverick-400b-a17b", "--shape", "decode_32k",
                        "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert [(r["mesh"], r["status"]) for r in res] == [("single", "ok"), ("ep4", "ok"),
                                                       ("ep8", "ok")]
    single, ep8 = res[0], res[2]
    assert single["bytes"]["params"] > 6 * ep8["bytes"]["params"]  # experts dominate
    assert ep8["collective_bytes"] > 0 == single["collective_bytes"]
    assert "ZeRO-1" in ep8["layout"] and single["card"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert report.main([str(out)]) == 0
    text = capsys.readouterr().out
    assert "| llama4-maverick-400b-a17b | decode_32k |" in text and "EP over 8 ranks" in text


def test_analyze_cli_gate(capsys):
    """The gate's stated exit code: 1 while ROADMAP item 10's host syncs (the
    engines' pageable uploads) stay active lint errors; every other pass
    (contracts, in place, graphs, the fused-tick engine) is clean."""
    from repro_torch.launch import analyze

    assert analyze.main(["--arch", "nlg-350m-moe128", "--device", "cpu", "--no-ep"]) == 1
    text = capsys.readouterr().out
    errors = [ln for ln in text.splitlines() if ln.startswith("[error]")]
    assert errors and all(" host-asarray @ serving/" in ln and "pageable" in ln for ln in errors)
    assert "predicted-signatures @ nlg-350m-moe128.continuous" in text
    assert "graph.nlg-350m-moe128+fused.continuous.prefill_chunk_batched.kernels" in text
    assert "analyze: FAIL" in text


def test_analyze_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable here")
    from repro_torch.launch import analyze

    with pytest.raises(RuntimeError, match="CUDA"):
        analyze.main(["--arch", "glm4-9b", "--no-ep"])
