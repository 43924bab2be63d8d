"""Phase 17b-d of ``chip_smoke.py`` alone, from any checkout of the port:
nlg-350m-prmoe-32-64 trained 8 steps at its published size, its MoS
student distilled, checkpointed and served, with every launch count
checked (``slice10_train``).  Built for holding two trees against each
other on one card in one call, in turns:

  python3 scripts/train_phase.py build/parent   # the parent, unpacked with git archive
  python3 scripts/train_phase.py                # this checkout

Prints the tree's phase-17 lines and, last, one JSON line with its
training summary (step ms, AdamW ms, tokens/s, MoS step ms) and the card's
name and power limit.  Needs the card; imports nothing of JAX.

With ``--swiglu``, phases 17g-h instead (``slice14_train``: llama4-maverick
at its published widths, 2 layers and 16 experts, 4 steps under ``ep``
and 4 under ``grouped``; ``slice14_reference_checks``: reduced f32 llama4
and kimi-k2 card vs CPU), and the JSON line holds their summary:

  python3 scripts/train_phase.py --swiglu [tree]

The launch counters and backend flags come from the tree's own
``chip_smoke.kernel_setup``.  An older tree, from before that function,
gets them from ``_setup_before_kernel_setup``, a copy of what its
``chip_smoke.main`` built.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

import torch


def _setup_before_kernel_setup() -> tuple:
    """The counters and flags an older ``chip_smoke.main`` built, for its tree."""
    from repro_torch.kernels import attention_paged as k7
    from repro_torch.kernels import attention_prefill_paged as k8
    from repro_torch.kernels import attention_quant as k9
    from repro_torch.kernels import expert_mlp as k2
    from repro_torch.kernels import expert_mlp_grouped as gk
    from repro_torch.kernels import expert_mlp_quant as k3
    from repro_torch.kernels import flash_attention as k6
    from repro_torch.kernels import moe_gating as k1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return (gk.launches, k7.launches, k8.launches, k9.launches, k1.launches, k2.launches,
            k3.launches, k6.launches)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    swiglu = "--swiglu" in argv
    argv = [a for a in argv if a != "--swiglu"]
    root = Path(argv[0] if argv else Path(__file__).resolve().parents[1]).resolve()
    if not torch.cuda.is_available():
        print("train_phase: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from repro_torch.kernels import build

    counters = (cs.kernel_setup() if hasattr(cs, "kernel_setup")
                else _setup_before_kernel_setup())
    if swiglu:
        build.build(["flash_attention", "flash_attention_bwd", "moe_gating", "grouped_mlp",
                     "grouped_mlp_mma", "grouped_mlp_bwd"])
        _, summary = cs.slice14_train(counters)
        for line in cs.slice14_reference_checks():
            print(line, flush=True)
        print(json.dumps({"tree": str(root), "card": cs.nvidia_smi_line(), **summary}), flush=True)
        return 0
    build.build(["flash_attention", "flash_attention_bwd", "moe_gating"])
    _, summary = cs.slice10_train(counters)
    train, mos = summary["train"], summary["mos"]
    print(json.dumps({"tree": str(root), "card": cs.nvidia_smi_line(),
                      "train_step_ms": train["step_ms_median"],
                      "train_adamw_ms": train["adamw_ms_median"],
                      "train_tokens_per_s": train["tokens_per_s"],
                      "train_launches": train["launches"], "mos_step_ms": mos["step_ms_median"],
                      "mos_adamw_ms": mos["adamw_ms_median"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
