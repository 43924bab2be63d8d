"""Training launcher of the port (``repro/launch/train.py``), on the card
unless ``--device cpu``:

  python -m repro_torch.launch.train --arch nlg-350m-prmoe-32-64 --steps 8 --batch 8 --seq 512
  python -m repro_torch.launch.train --arch nlg-350m-prmoe-32-64 --reduced --device cpu

The same flags as the JAX launcher; ``--moe-impl ep`` without a mesh is the
dense capacity dispatch, as everywhere in the port (``core/moe.py``
``NO_MESH_IMPL``).  ``--ckpt-dir`` writes the parameters in the JAX
package's checkpoint format and the history as JSON.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.checkpoint import ckpt
from repro_torch.configs.registry import get_config, make_reduced
from repro_torch.data.pipeline import data_stream
from repro_torch.models.model import resolve_device
from repro_torch.training.trainer import TrainConfig, train_loop


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", help="2-layer tiny variant (CPU)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--vocab", type=int, default=0, help="override vocab (synthetic data)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--moe-impl", default=None, choices=[None, "einsum", "dense", "ep"])
    ap.add_argument("--device", default="cuda", help="cuda (the card, default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    if args.vocab:
        cfg = cfg.replace(vocab_size=args.vocab)
    if args.moe_impl:
        cfg = cfg.replace(moe_impl=args.moe_impl)

    tc = TrainConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1), decay_steps=args.steps)
    it = data_stream(cfg.vocab_size, args.batch, args.seq, seed=args.seed, device=device)
    params, _, history = train_loop(cfg, tc, it, args.steps, seed=args.seed, device=device)

    if args.ckpt_dir:
        ckpt.save(os.path.join(args.ckpt_dir, "params"), params, step=args.steps)
        with open(os.path.join(args.ckpt_dir, "history.json"), "w") as f:
            json.dump(history, f, indent=1)
        print(f"saved checkpoint to {args.ckpt_dir}")
    print(f"final loss: {history[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
