"""In-place auditor: the port's counterpart of the donation audit
(``repro/analysis/donation.py``).

JAX donates a step's mutated state (the caches of prefill and decode, the
parameters and optimizer state of train: ``repro/launch/dryrun.py``) so
that XLA aliases each donated buffer to its output instead of allocating a
second copy.  The port has nothing to donate: its steps write those tensors
in place.  What can go wrong is the same, though: a step that builds a new
tensor for a leaf it should have written (``caches["k"] = torch.cat(...)``,
an out-of-place ``p = p - lr * g``) holds two copies of it for a moment and
copies it every step, silently.  ``audit_inplace`` runs a step once and
checks, leaf by leaf, that every leaf of each mutated argument still lives
in the storage it had (``untyped_storage().data_ptr()``), in the input's
tree and in the tree the step returns in its place, and counts the leaves
the step wrote (their version counter moved).

``audit_donated_rebinds`` has no counterpart: it guards the host side of a
donation (the old Python reference is a dead buffer after the call), and
nothing here is donated, so an old reference stays valid.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.analysis.findings import Report


def leaves(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """``{path: tensor}`` of a nested dict / list / tuple / ParamTree /
    NamedTuple (a QuantizedKV's or QuantizedArray's tensors included)."""
    out: Dict[str, torch.Tensor] = {}
    if torch.is_tensor(tree):
        out[prefix or "."] = tree
    elif hasattr(tree, "_asdict"):
        for k, v in tree._asdict().items():
            out.update(leaves(v, f"{prefix}{k}/"))
    elif hasattr(tree, "items"):
        for k, v in tree.items():
            out.update(leaves(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(leaves(v, f"{prefix}{i}/"))
    elif hasattr(tree, "named_buffers"):
        for k, v in tree.named_buffers():
            out[f"{prefix}{k}"] = v
    return out


def _storage(t: torch.Tensor) -> Tuple[int, int]:
    return t.untyped_storage().data_ptr(), t.storage_offset()


def audit_inplace(name: str, step, args: Sequence, mutated: Sequence[int],
                  report: Optional[Report] = None, *,
                  returns: Optional[Dict[int, int]] = None, kwargs: Optional[dict] = None):
    """Run ``step(*args, **kwargs)`` once and check that every leaf of each
    ``args[i]``, ``i`` in ``mutated``, keeps its storage: in the input tree
    (a leaf rebound to a new tensor) and, where ``returns[i] = j`` names the
    step's output ``j`` that hands that tree back, in the returned tree.
    Returns ``(report, the step's output)``; ``report.metrics`` holds
    ``inplace.<name>.kept`` and ``.written`` (leaves whose version counter
    moved) as ``n/total``."""
    report = report if report is not None else Report()
    returns = returns or {}
    before = {i: {p: (_storage(t), t._version) for p, t in leaves(args[i]).items()}
              for i in mutated}
    out = step(*args, **(kwargs or {}))
    outs = out if isinstance(out, tuple) else (out,)
    kept = total = written = 0
    for i in mutated:
        now = leaves(args[i])
        back = leaves(outs[returns[i]]) if i in returns else {}
        moved = []
        for p, (where, version) in before[i].items():
            total += 1
            t = now.get(p)
            r = back.get(p, t) if i in returns else t
            if t is None or r is None or _storage(t) != where or _storage(r) != where:
                moved.append(p)
                continue
            kept += 1
            written += t._version != version
        if moved:
            shown = ", ".join(moved[:4]) + ("..." if len(moved) > 4 else "")
            report.add("inplace-reallocated", "error", name,
                       f"arg {i}: {len(moved)}/{len(before[i])} leaves left their storage "
                       f"({shown}): the step copies a tensor it should write in place")
    report.metrics[f"inplace.{name}.kept"] = f"{kept}/{total}"
    report.metrics[f"inplace.{name}.written"] = f"{written}/{total}"
    return report, out
