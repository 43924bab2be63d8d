"""The port stands alone: no module of ``repro_torch``, nor ``chip_smoke.py``,
imports JAX or the JAX package, and its entry points default to the card."""
import os
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

BLOCKED_IMPORTS = textwrap.dedent(r"""
    import importlib, importlib.util, pkgutil, sys

    class Refuse:
        # refuses jax, jaxlib and the JAX package (repro, repro.*);
        # repro_torch is a different top-level name and passes
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    import repro_torch
    names = ["repro_torch"]
    for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        importlib.import_module(m.name)
        names.append(m.name)
    spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    leaked = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "repro"))
    assert not leaked, leaked
    assert {"repro_torch.quant.qarrays", "repro_torch.quant.kv", "repro_torch.quant.ptq",
            "repro_torch.kernels.attention_quant", "repro_torch.kernels.moe_gating",
            "repro_torch.kernels.expert_mlp", "repro_torch.kernels.expert_mlp_quant",
            "repro_torch.kernels.flash_attention", "repro_torch.models.ssm",
            "repro_torch.models.rglru",
            "repro_torch.core.dispatch", "repro_torch.core.dispatch_einsum",
            "repro_torch.kernels.no_backward", "repro_torch.training.schedule",
            "repro_torch.training.optimizer", "repro_torch.training.trainer",
            "repro_torch.training.distill", "repro_torch.data.synthetic",
            "repro_torch.data.pipeline", "repro_torch.checkpoint.ckpt",
            "repro_torch.launch.train", "repro_torch.launch.training_kernels",
            "repro_torch.core.moe_parallel", "repro_torch.launch.steps",
            "repro_torch.training.ep", "repro_torch.parallel.collectives"} <= set(names), names
    print(len(names), "modules")
""")


def test_port_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run(
        [sys.executable, "-c", BLOCKED_IMPORTS, os.path.join(ROOT, "chip_smoke.py")],
        capture_output=True, text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    n = int(res.stdout.split()[0])
    assert n >= 60, res.stdout  # every package and module was walked, the trainer's included


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable here")
    from repro_torch.configs.registry import get_config, make_reduced
    from repro_torch.models.model import init_caches, init_paged_caches, init_params
    from repro_torch.serving.continuous import ContinuousEngine
    from repro_torch.serving.engine import Engine, EngineConfig

    cfg = make_reduced(get_config("llama4-maverick-400b-a17b")).replace(moe_impl="grouped")
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, params, EngineConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_caches(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousEngine(cfg, params, paged=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_paged_caches(cfg, 1, 16, n_pages=2, page_size=8)
