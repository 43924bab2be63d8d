"""Phase 4d of ``chip_smoke.py`` alone: llama4-maverick at full width (phase
3's weights), phase 4's continuous trace for the launch counts and
preemptions every run must repeat, then ``obs_phase`` ``--repeats`` times
(each time six runs in turns: ``Obs.disabled()``, ``Obs()``,
``Obs(trace=True, routing=True)``, full, default, disabled, and a profile
of 5 steady decode ticks under each setting).  For reading what the
instruments cost with more turns than one ``chip_smoke.py`` run gives:

  python3 scripts/obs_phase.py --repeats 3

Prints the phase's lines and, last, one JSON line with every repeat's
steady decode-tick medians and host syncs per tick, and the card's name
and power limit.  Needs the card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("obs_phase: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.configs.base import Segment
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import build
    from repro_torch.models.model import init_params

    counters = cs.kernel_setup()
    build.build(["grouped_mlp_mma", "grouped_mlp", "paged_decode_attention",
                 "paged_prefill_attention"])
    full = get_config(cs.ARCH)
    cfg = full.replace(moe_impl="grouped", segments=(Segment(full.segments[0].pattern, 1),))
    params = init_params(cfg, seed=cs.SEED, device="cuda")
    lines, launches, _, eng = cs.continuous_serve(cfg, params, counters)
    preemptions = eng.preemptions
    del eng
    for line in lines:
        cs.log(line)
    repeats = []
    for _ in range(args.repeats):
        lines, _, summary = cs.obs_phase(cfg, params, counters, launches, preemptions)
        for line in lines:
            cs.log(line)
        repeats.append({"steady_tick_ms": summary["steady_tick_ms"],
                        "syncs": {k: v["syncs"] for k, v in summary["profile"].items()}})
    cs.log(json.dumps({"repeats": repeats, "card": cs.nvidia_smi_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
