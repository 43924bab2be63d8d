"""Roofline terms of a step on the H100 (``repro/launch/roofline.py``).

  compute    = operations / (chips × peak rate of their type)
  memory     = bytes / (chips × memory rate)
  collective = collective bytes / (chips × link rate)

The rates are the NVIDIA H100 80GB HBM3's at its 700 W limit (NVIDIA data
sheet, dense): 989e12 bf16 and 67e12 f32 operations a second, 3.35e12 bytes
a second of HBM, and, for the collective term of an EP mesh with one GPU a
rank, NVLink at 450e9 bytes a second each way.  A measured number is to be
read beside the name and power limit of the card it was taken on.

``analyze(account, chips)`` builds a ``Roofline`` from an ``op_account``
result; ``parse_collectives`` reads the collectives of an op capture (the
port has no HLO text).  ``score_dims_for`` has no counterpart: the port's
attention kernels never write scores, and their formulas already count only
what they move.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

PEAK_OPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BW = 3.35e12
NVLINK_BW = 450e9
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


@dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int] = field(default_factory=dict)
    count_by_kind: Dict[str, int] = field(default_factory=dict)
    group_sizes: List[int] = field(default_factory=list)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


def parse_collectives(cap) -> CollectiveStats:
    """Bytes (each call's input) and counts by kind over a capture's
    collectives, with each call's group size where its mesh is known."""
    from repro_torch.launch.op_account import meta_bytes

    stats = CollectiveStats()
    for r in cap.records:
        if r.kind not in ("collective", "c10d"):
            continue
        n = sum(meta_bytes(m) for m in r.inputs[:1])
        stats.bytes_by_kind[r.name] = stats.bytes_by_kind.get(r.name, 0) + n
        stats.count_by_kind[r.name] = stats.count_by_kind.get(r.name, 0) + 1
        mesh, axes = r.args.get("mesh"), r.args.get("axes")
        if hasattr(mesh, "axes_size") and axes is not None:
            stats.group_sizes.append(mesh.axes_size(axes))
    return stats


@dataclass
class Roofline:
    ops_by_dtype: Dict[str, float]  # operations of the whole step, all chips
    hbm_bytes: float  # bytes a chip moves
    collective_bytes: float  # bytes a chip sends
    chips: int
    stats: CollectiveStats = field(default_factory=CollectiveStats)

    @property
    def flops(self) -> float:
        return sum(self.ops_by_dtype.values())

    @property
    def t_compute(self) -> float:
        return sum(n / PEAK_OPS.get(dt, PEAK_OPS["float32"])
                   for dt, n in self.ops_by_dtype.items()) / self.chips

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / NVLINK_BW

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "ops_by_dtype": dict(self.ops_by_dtype),
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "chips": self.chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "collectives": {
                "bytes_by_kind": self.stats.bytes_by_kind,
                "count_by_kind": self.stats.count_by_kind,
                "max_group": max(self.stats.group_sizes or [1]),
            },
            "card": CARD,
        }


def analyze(acct, chips: int = 1, stats: CollectiveStats = None) -> Roofline:
    """The roofline of one chip's step from its ``op_account.Account``
    (operations summed over ``chips`` identical ranks)."""
    stats = stats or CollectiveStats(bytes_by_kind={k: int(v) for k, v in acct.coll_bytes.items()},
                                     count_by_kind=dict(acct.coll_count))
    return Roofline(ops_by_dtype={k: v * chips for k, v in acct.ops_by_dtype.items()},
                    hbm_bytes=acct.traffic, collective_bytes=float(stats.total_bytes),
                    chips=chips, stats=stats)


def model_flops(cfg, shape, *, active: bool = True) -> float:
    """MODEL_FLOPS: 6·N·D for training, 2·N·D for inference (N = activated
    params for MoE — the paper's critical-path measure)."""
    from repro_torch.configs.base import count_active_params, count_params

    n = count_active_params(cfg) if active else count_params(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch  # decode: one token per row
