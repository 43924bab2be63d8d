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
``get_mesh`` / ``get_rules`` read it.  The rules kept are those the port's
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
