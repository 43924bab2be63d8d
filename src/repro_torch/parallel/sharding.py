"""The ambient mesh (``repro/parallel/sharding.py``) on ``torch.distributed``.

JAX runs expert parallelism as one process over a device mesh; the port runs
one process per rank (SPMD).  An ``EpMesh`` is this rank's view of the mesh:
its shape and axis names, this rank's coordinates, and the process groups
the collectives run over, one for the whole mesh and one per axis.

Global rank <-> coordinates are outer-major (``rank = sum_i coord_i *
prod(shape[i+1:])``), the order in which ``params.ep_rank`` numbers the
shards: shard r owns experts ``[r * E_loc, (r + 1) * E_loc)``, and a
collective over several axes concatenates in that order.

The groups are taken from the initialized default process group, with its
backend; nothing here initializes one.  Every rank must build the same
meshes in the same order (``dist.new_group`` is collective), which the
engines do, since every rank builds the same engines from the same config.

``use_mesh`` makes a mesh ambient for the calling thread, as in JAX;
``get_mesh`` / ``get_rules`` read it.

Rows of a batch (JAX's ``spec("batch", ...)`` with a shape):
``row_axes`` are the ``batch`` rule's axes that shard a dim of n rows, kept
greedily, outer first, while their product divides n (``_filter_axes``);
``batch_shard`` is this rank's block of them, a ``RowShard`` (rows ``[lo,
hi)``, contiguous, in mesh order: JAX's shard of that dim on the device at
this rank's coordinates; ranks that differ only along the other axes hold
the same rows).  A serving step that runs data-parallel over its slots
makes its ``RowShard`` ambient (``use_rows``): ``shard_hint(x, "batch")``
cuts a replicated tensor to the rank's rows, the MoE layer gathers rows
before its replicated-token schedules, and the writes into a replicated
page pool take every row (``models/attention.py``).  The rules kept are those the port's
expert parallelism reads: ``batch`` (the axes the global batch's rows shard
over), ``expert`` (the axes experts shard over), and for training
``expert_mlp`` / ``mlp`` (the axis an expert's d_ff is sliced over: the
paper's expert-slicing, §5.2), with JAX's ``RULESETS`` entries ``default``
and ``ep_pod`` (experts over ``("pod", "data")``, the two-hop exchange).
Tensor parallelism of attention and the dense FFN over ``model`` is not
ported (ROADMAP item 7d): those leaves are replicated over it and computed
on every ``model`` rank.
"""
from __future__ import annotations

import contextlib
import datetime
import threading
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch.distributed as dist

_state = threading.local()

DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "expert": "data",
    "mlp": "model",
    "expert_mlp": "model",  # expert-slicing (paper §5.2)
}

RULESETS = {
    "default": DEFAULT_RULES,
    # cross-pod expert parallelism with the hierarchical exchange (Fig. 8)
    "ep_pod": {**DEFAULT_RULES, "expert": ("pod", "data")},
}

# every process group a mesh makes waits at most this long in a collective
# whose peers do not arrive, then raises
GROUP_TIMEOUT = datetime.timedelta(seconds=300)


@dataclass(frozen=True, eq=False)
class EpMesh:
    """This rank's view of a device mesh of ``shape`` over ``axis_names``.

    ``rank`` is the outer-major linear index of ``coords``; ``group`` holds
    every rank of the mesh in that order, ``axis_groups[name]`` the ranks
    that differ from this one along ``name`` only, in coordinate order."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    rank: int
    coords: Tuple[int, ...]
    group: object
    axis_groups: Dict[str, object] = field(default_factory=dict)
    backend: str = "gloo"

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)]

    def axis_index(self, name: str) -> int:
        return self.coords[self.axis_names.index(name)]

    def axes_size(self, axes) -> int:
        """The ranks of a group over ``axes`` (one name or several)."""
        n = 1
        for a in (axes,) if isinstance(axes, str) else axes:
            n *= self.axis_size(a)
        return n

    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))


def coords_of(rank: int, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """Outer-major coordinates of a linear rank."""
    out = []
    for n in reversed(shape):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


def rank_of(coords: Tuple[int, ...], shape: Tuple[int, ...]) -> int:
    r = 0
    for c, n in zip(coords, shape):
        r = r * n + c
    return r


def axis_lines(shape: Tuple[int, ...], axis: int):
    """The rank lists along ``axis``, one per setting of the other
    coordinates, in outer-major order of those settings."""
    others = [i for i in range(len(shape)) if i != axis]
    n_lines = 1
    for i in others:
        n_lines *= shape[i]
    lines = []
    for line in range(n_lines):
        fixed = coords_of(line, tuple(shape[i] for i in others))
        coords = [0] * len(shape)
        for i, c in zip(others, fixed):
            coords[i] = c
        ranks = []
        for c in range(shape[axis]):
            coords[axis] = c
            ranks.append(rank_of(tuple(coords), shape))
        lines.append(ranks)
    return lines


# meshes built in this process, by (default group, shape, names): engines
# built one after another on the same mesh share its groups
_MESHES: Dict[tuple, EpMesh] = {}


def make_ep_mesh(shape, axis_names, *, timeout: datetime.timedelta = GROUP_TIMEOUT) -> EpMesh:
    """This rank's ``EpMesh`` of ``shape`` over the default process group,
    whose world size must be the mesh's size.  Collective: every rank of the
    group calls it with the same arguments."""
    shape = tuple(int(n) for n in shape)
    axis_names = tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} and axis names {axis_names} differ in length")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"an expert-parallel mesh {shape} needs an initialized torch.distributed default "
            "process group, one process per rank (serving.ep.launch starts them)")
    size = 1
    for n in shape:
        size *= n
    world = dist.get_world_size()
    if world != size:
        raise ValueError(f"mesh {shape} has {size} ranks but the default process group has "
                         f"{world}: start one process per rank of the mesh")
    key = (id(dist.group.WORLD), shape, axis_names)
    mesh = _MESHES.get(key)
    if mesh is not None:
        return mesh
    rank = dist.get_rank()
    coords = coords_of(rank, shape)
    backend = dist.get_backend()
    # the same calls, in the same order, on every rank
    whole = dist.new_group(list(range(size)), timeout=timeout)
    axis_groups = {}
    for a, name in enumerate(axis_names):
        if len(shape) == 1:
            axis_groups[name] = whole
            continue
        for ranks in axis_lines(shape, a):
            g = dist.new_group(ranks, timeout=timeout)
            if rank in ranks:
                axis_groups[name] = g
    mesh = EpMesh(shape, axis_names, rank, coords, whole, axis_groups, backend)
    _MESHES[key] = mesh
    return mesh


@contextlib.contextmanager
def use_mesh(mesh: Optional[EpMesh], rules: Optional[dict] = None):
    """Make ``mesh`` (and its sharding ``rules``) ambient in this thread."""
    prev = getattr(_state, "mesh", None)
    prev_rules = getattr(_state, "rules", None)
    _state.mesh = mesh
    _state.rules = rules or DEFAULT_RULES
    try:
        yield mesh
    finally:
        _state.mesh = prev
        _state.rules = prev_rules


def get_mesh() -> Optional[EpMesh]:
    return getattr(_state, "mesh", None)


def get_rules() -> dict:
    return getattr(_state, "rules", None) or DEFAULT_RULES


# ---------------------------------------------------------------------------
# Rows of a batch over the ``batch`` rule's axes
# ---------------------------------------------------------------------------


def row_axes(mesh: EpMesh, rules: dict, n: int) -> Tuple[str, ...]:
    """The mesh axes a dim of ``n`` rows shards over (JAX's ``_filter_axes``
    of the ``batch`` rule): the rule's axes in its order, each kept while the
    product of the kept ones still divides n; () where none does."""
    axes = rules.get("batch") or ()
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    picked, prod = [], 1
    for a in axes:
        if a not in mesh.axis_names:
            continue
        if n % (prod * mesh.axis_size(a)) == 0:
            picked.append(a)
            prod *= mesh.axis_size(a)
    return tuple(picked)


@dataclass(frozen=True, eq=False)
class RowShard:
    """This rank's rows ``[lo, hi)`` of a batch of ``n`` rows sharded over
    ``axes`` of ``mesh`` (outer first; the block index is the rank's linear
    index over them)."""

    mesh: EpMesh
    axes: Tuple[str, ...]
    n: int
    lo: int
    hi: int

    @property
    def rows(self) -> int:
        return self.hi - self.lo

    def take(self, x, dim: int = 0):
        """x's rows of this rank along ``dim`` (a view)."""
        return x.narrow(dim, self.lo, self.rows)

    def block(self, row: int) -> int:
        """The block index (over ``axes``) of the ranks holding global row
        ``row``."""
        return int(row) // self.rows

    def holds(self, row: int) -> bool:
        return self.lo <= int(row) < self.hi


def batch_shard(n: int, mesh: Optional[EpMesh] = None,
                rules: Optional[dict] = None) -> Optional[RowShard]:
    """This rank's ``RowShard`` of a batch of ``n`` rows under ``mesh`` (the
    ambient one by default), or None where no axis shards it (no mesh, or
    rows that no axis of the rule divides)."""
    mesh = mesh if mesh is not None else get_mesh()
    if mesh is None:
        return None
    axes = row_axes(mesh, rules if rules is not None else get_rules(), n)
    if not axes:
        return None
    parts, index = 1, 0
    for a in axes:
        parts *= mesh.axis_size(a)
        index = index * mesh.axis_size(a) + mesh.axis_index(a)
    per = n // parts
    return RowShard(mesh, axes, n, index * per, (index + 1) * per)


@contextlib.contextmanager
def use_rows(rows: Optional[RowShard]):
    """Make ``rows`` the ambient step's rows in this thread (None: every row
    on every rank)."""
    prev = getattr(_state, "rows", None)
    _state.rows = rows
    try:
        yield rows
    finally:
        _state.rows = prev


def get_rows() -> Optional[RowShard]:
    """The ambient step's ``RowShard``, None outside a step sharded by rows."""
    return getattr(_state, "rows", None)


def shard_hint(x, *logical_axes):
    """``x`` with each dim named ``"batch"`` cut to the ambient step's rows
    (a view), where that dim holds the step's whole batch; the identity
    outside such a step.  The port's counterpart of JAX's hint for the
    ``batch`` axis of a serving step (every other name is replicated)."""
    rows = get_rows()
    if rows is None or x is None:
        return x
    for d, name in enumerate(logical_axes):
        if name == "batch" and x.shape[d] == rows.n:
            x = rows.take(x, d)
    return x
