"""Which parameter leaves shard under expert parallelism
(``repro/parallel/params.py``, ``param_pspecs``), each rank's slice of them,
and the ZeRO-1 partition of the optimizer state.

Both modes shard the routed experts' ``wi`` / ``wg`` / ``wo`` (the leaves
directly under ``moe``, not its ``residual`` branch) along the expert dim,
over every mesh axis of the ``expert`` rule, and replicate every other leaf:
attention, norms, embeddings, the router, the shared expert (paper §5.1,
aggregate memory bandwidth).  ``mode="train"`` also slices each expert's
d_ff (``wi`` / ``wg`` along F, ``wo`` along its F dim) over the axis that
``expert_mlp`` (then ``mlp``) names, where it is in the mesh, above 1 and
divides F: the paper's expert-slicing (§5.2), JAX's ``_leaf_spec``.  A leaf
under ``segments`` carries a leading stacked ``[repeats]`` dim, so its
expert dim is 1.  The rules are all-or-nothing, as JAX's ``_pick``: every
axis a rule names must be in the mesh and untaken, and their product must be
above 1 and divide the dim.

JAX's train layout also shards attention and the dense FFN over ``model``
and every leaf over the data axes (ZeRO-3, ``_extend_for_train``); the port
replicates those leaves (the same function, more memory; ROADMAP item 7d)
and shards their optimizer state instead (ZeRO-1, ``zero_partition``).

Caches (``cache_pspecs``, JAX's function of the same name, its serving
branch): a cache leaf ``[repeats, batch, ...]`` whose slot dim holds the
batch shards that dim over the ``batch`` rule's axes where they divide it
(``sharding.batch_shard``); every other leaf (the paged pools ``[repeats,
n_pages + 1, ...]``) is replicated.  JAX shards the slot dim only over the
whole of ``("pod", "data")``; the port takes the axes as its activations
take them (JAX's ``_filter_axes``), so a rank's cache rows are always the
rows it computes.  A serving mesh has no ``model`` axis, so JAX's kv-head
and sequence rules for the caches are not ported (training's layout, 7d).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

from repro_torch.parallel.sharding import EpMesh, batch_shard

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


def expert_mlp_axis(mesh: Optional[EpMesh], rules: dict, d_ff: int,
                    taken: Sequence[str] = ()) -> Optional[str]:
    """The mesh axis an expert's d_ff is sliced over in training (JAX's
    ``_pick`` over ``("expert_mlp", "mlp")`` on the F dim), or None."""
    if mesh is None:
        return None
    sizes = mesh.sizes()
    for name in ("expert_mlp", "mlp"):
        axes = rules.get(name)
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if len(axes) != 1:
            raise ValueError(f"rule {name!r} -> {axes}: expert-slicing takes one mesh axis")
        a = axes[0]
        if a in taken or a not in sizes or sizes[a] == 1:
            continue
        if d_ff % sizes[a] == 0:
            return a
    return None


def batch_axes(mesh: EpMesh, rules: dict) -> Tuple[str, ...]:
    """The mesh axes of the ``batch`` rule that are in the mesh, in its
    order: the axes the global batch's rows shard over in training, and the
    axes a replicated leaf's gradient sums over."""
    axes = rules.get("batch") or ()
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return tuple(a for a in mesh.axis_names if a in axes)


def ep_rank(mesh: EpMesh, axes: Sequence[str]) -> int:
    """Linear rank within the EP group over ``axes``, major-first: shard r
    owns experts ``[r * E_loc, (r + 1) * E_loc)``."""
    r = 0
    for a in axes:
        r = r * mesh.axis_size(a) + mesh.axis_index(a)
    return r


def layer_ffn(cfg, names: Sequence[str]):
    """The FFNSpec of the layer that the leaf at path ``names``
    (``[encoder/]segments/seg{i}/pos{j}/...``) belongs to, from ``cfg``."""
    segs = cfg.encoder.segments if names[0] == "encoder" else cfg.segments
    i = names.index("segments")
    seg, pos = names[i + 1], names[i + 2]
    return segs[int(seg[3:])].pattern[int(pos[3:])].ffn


def layer_experts(cfg, names: Sequence[str]) -> Optional[int]:
    """The expert count of the MoE layer that the leaf at path ``names``
    belongs to, from ``cfg``."""
    return layer_ffn(cfg, names).num_experts


def f_dim(names: Sequence[str], ndim: int) -> int:
    """The d_ff dim of expert leaf ``names``: last of ``wi`` / ``wg``,
    next to last of ``wo``."""
    return ndim - 2 if names[-1] == "wo" else ndim - 1


def shard_params(mesh: EpMesh, rules: dict, params, cfg=None, *, mode: str = "serve"):
    """A new ParamTree with each expert leaf cut to this rank's experts (a
    copy of the slice, so the full leaf can be freed) and every other leaf
    the input's own tensor; ``mode="train"`` also cuts each expert's d_ff
    to this rank's slice over the ``expert_mlp`` axis.  Given ``cfg``, a
    leaf that already holds this rank's ``E_loc`` experts of its layer's E
    (a tree placed before) is kept as it is."""
    if mode not in ("serve", "train"):
        raise ValueError(f"shard_params: mode {mode!r}, expected 'serve' or 'train'")
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
            v = v.narrow(dim, lo, E_loc)
            tp = expert_mlp_axis(mesh, rules, v.shape[f_dim(names, v.dim())], axes) \
                if mode == "train" else None
            if tp is not None:
                fd = f_dim(names, v.dim())
                F_loc = v.shape[fd] // mesh.axis_size(tp)
                v = v.narrow(fd, mesh.axis_index(tp) * F_loc, F_loc)
            out[k] = v.clone()
        return ParamTree(out)

    return visit(params, [])


def cache_pspecs(mesh: EpMesh, rules: dict, caches, batch: int):
    """The caches' tree with each tensor replaced by the ``RowShard`` of its
    slot dim (dim 1, after the stacked ``[repeats]``), or None for a leaf
    that replicates: JAX's shape test, a leaf whose dim 1 is ``batch`` holds
    a slot per row (``batch = -1``: none does).  An int8 ``QuantizedKV``
    leaf maps its ``q`` and ``scale`` alike."""
    from repro_torch.quant.kv import QuantizedKV

    shard = batch_shard(batch, mesh, rules) if batch > 0 else None

    def visit(node):
        if isinstance(node, QuantizedKV):
            return QuantizedKV(visit(node.q), visit(node.scale), node.orig_dtype)
        if isinstance(node, dict):
            return {k: visit(v) for k, v in node.items()}
        return shard if node.dim() > 1 and node.shape[1] == batch else None

    return visit(caches)


# ---------------------------------------------------------------------------
# ZeRO-1: the optimizer state of a replicated leaf, 1/dp a data rank
# ---------------------------------------------------------------------------


class ZeroPart(NamedTuple):
    """How the optimizer treats one leaf on this rank.

    ``zero``: a replicated leaf, whose f32 moments this rank keeps for its
    slice only: values ``[index * size, (index + 1) * size)`` of the
    flattened leaf (the last slice cut at ``numel``), ``size = ceil(numel /
    dp)``, ``index`` this rank's linear index over ``axes`` (the batch
    axes, ``dp`` ranks).  Otherwise an expert shard with whole local
    moments, whose gradient sums over ``axes`` (the batch axes that do not
    shard it; usually none).  ``norm_axes``: the axes over which the ranks
    hold distinct parts of the leaf (for the global norm: every part once,
    never again on a rank that only replicates it)."""

    zero: bool
    axes: Tuple[str, ...]
    norm_axes: Tuple[str, ...]
    numel: int
    dp: int
    index: int
    size: int


def zero_partition(mesh: EpMesh, rules: dict, leaves: Dict[str, object],
                   cfg) -> Dict[str, ZeroPart]:
    """``{path: ZeroPart}`` for this rank's leaves (``param_leaves`` of a
    tree placed by ``shard_params(mode="train")``: an expert leaf already
    holds this rank's slice; ``cfg`` gives each expert layer's E and F)."""
    baxes = batch_axes(mesh, rules)
    out = {}
    for path, t in leaves.items():
        names = path.split("/")
        numel = t.numel()
        dim = expert_dim(names)
        eaxes = None
        if dim is not None:
            eaxes = expert_axes(mesh, rules, layer_experts(cfg, names))
        if eaxes is None:  # replicated: ZeRO-1 over the batch axes
            dp = mesh.axes_size(baxes) if baxes else 1
            index = ep_rank(mesh, baxes) if baxes else 0
            out[path] = ZeroPart(True, baxes, baxes, numel, dp, index, -(-numel // dp))
            continue
        shard = list(eaxes)
        tp = expert_mlp_axis(mesh, rules, layer_ffn(cfg, names).d_ff, eaxes)
        if tp is not None:
            shard.append(tp)
        shard = tuple(a for a in mesh.axis_names if a in shard)
        rest = tuple(a for a in baxes if a not in shard)
        out[path] = ZeroPart(False, rest, shard, numel, 1, 0, numel)
    return out
