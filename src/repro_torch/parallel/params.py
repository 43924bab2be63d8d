"""Which parameter leaves shard under expert-parallel serving
(``repro/parallel/params.py``, ``param_pspecs(mode="serve")``), and each
rank's slice of them.

Serving shards the routed experts' ``wi`` / ``wg`` / ``wo`` (the leaves
directly under ``moe``, not its ``residual`` branch) along the expert dim,
over every mesh axis of the ``expert`` rule, and replicates every other leaf:
attention, norms, embeddings, the router, the shared expert (paper §5.1,
aggregate memory bandwidth).  A leaf under ``segments`` carries a leading
stacked ``[repeats]`` dim, so its expert dim is 1.  The ``expert`` rule is
all-or-nothing, as JAX's ``_pick``: every axis it names must be in the mesh,
and their product must be above 1 and divide the expert count.

Train mode (tensor-parallel and ZeRO specs) is not here: expert-parallel
training is ROADMAP.md, queue 1 item 7b.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

from repro_torch.parallel.sharding import EpMesh

EXPERT_KEYS = ("wi", "wg", "wo")


def expert_dim(names: Sequence[str]) -> Optional[int]:
    """The expert dim of the leaf at path ``names``, or None for a leaf that
    replicates."""
    if len(names) >= 2 and names[-2] == "moe" and names[-1] in EXPERT_KEYS:
        return 1 if "segments" in names[:-1] else 0
    return None


def expert_axes(mesh: Optional[EpMesh], rules: dict, num_experts: int) -> Optional[Tuple[str, ...]]:
    """The mesh axes ``num_experts`` experts shard over, or None where the
    mesh cannot shard them (no mesh, no ``expert`` rule, an axis it names
    missing, a product of 1 or one that does not divide the count)."""
    if mesh is None:
        return None
    axes = rules.get("expert")
    if axes is None:
        return None
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    sizes = mesh.sizes()
    ep = 1
    for a in axes:
        if a not in sizes:
            return None
        ep *= sizes[a]
    if ep <= 1 or num_experts % ep != 0:
        return None
    return axes


def ep_rank(mesh: EpMesh, axes: Sequence[str]) -> int:
    """Linear rank within the EP group over ``axes``, major-first: shard r
    owns experts ``[r * E_loc, (r + 1) * E_loc)``."""
    r = 0
    for a in axes:
        r = r * mesh.axis_size(a) + mesh.axis_index(a)
    return r


def layer_experts(cfg, names: Sequence[str]) -> Optional[int]:
    """The expert count of the MoE layer that the leaf at path ``names``
    (``[encoder/]segments/seg{i}/pos{j}/moe/...``) belongs to, from ``cfg``."""
    segs = cfg.encoder.segments if names[0] == "encoder" else cfg.segments
    i = names.index("segments")
    seg, pos = names[i + 1], names[i + 2]
    return segs[int(seg[3:])].pattern[int(pos[3:])].ffn.num_experts


def shard_params(mesh: EpMesh, rules: dict, params, cfg=None):
    """A new ParamTree with each expert leaf cut to this rank's experts (a
    copy of the slice, so the full leaf can be freed) and every other leaf
    the input's own tensor.  Given ``cfg``, a leaf that already holds this
    rank's ``E_loc`` experts of its layer's E (a tree placed before) is
    kept as it is."""
    from repro_torch.models.model import ParamTree
    from repro_torch.quant.qarrays import QuantizedArray

    def visit(tree, path):
        out = {}
        for k, v in tree.items():
            names = path + [k]
            if isinstance(v, ParamTree):
                out[k] = visit(v, names)
                continue
            dim = expert_dim(names)
            if dim is None:
                out[k] = v
                continue
            if isinstance(v, QuantizedArray):
                raise TypeError(f"shard_params: expert leaf {'/'.join(names)} is quantized; "
                                "expert-parallel serving dequantizes it first "
                                "(quant.ptq.prepare_params_for_serving)")
            E = v.shape[dim] if cfg is None else layer_experts(cfg, names)
            axes = expert_axes(mesh, rules, E)
            if axes is None:
                out[k] = v
                continue
            E_loc = E // mesh.axes_size(axes)
            if v.shape[dim] == E_loc:
                out[k] = v  # placed already
                continue
            if v.shape[dim] != E:
                raise ValueError(f"shard_params: {'/'.join(names)} holds {v.shape[dim]} experts, "
                                 f"expected {E} or this rank's {E_loc}")
            lo = ep_rank(mesh, axes) * E_loc
            out[k] = v.narrow(dim, lo, E_loc).clone()
        return ParamTree(out)

    return visit(params, [])
