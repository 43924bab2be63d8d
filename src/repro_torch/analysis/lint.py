"""AST host-sync lint over ``src/repro_torch`` (``repro/analysis/lint.py``
on the port's eager PyTorch code).

A serving step on the card runs as fast as the host can issue its kernels;
every point where the Python thread waits for the device drains that queue,
and every such point inside a step breaks a CUDA graph capture of it
(ROADMAP item 10).  This pass finds the syntactic shapes those waits take,
under JAX's rule names:

  * ``host-item``     — ``x.item()``: always a device->host sync.
  * ``host-cast``     — ``int()/float()/bool()`` over an expression that
                        involves a device value (a ``torch.*`` call, a call
                        to a function imported from the model/kernel layers,
                        an engine's ``self._*`` call, or a local bound to
                        one).  Blocks until the value is ready.
  * ``host-asarray``  — ``.tolist()``, ``.cpu()``, ``.numpy()``,
                        ``.to("cpu")`` or ``np.asarray()/np.array()`` of a
                        device value: the copy back to the host, which waits
                        for every kernel before it; and its torch twin, the
                        upload of a pageable host tensor (``torch.from_numpy
                        (a).to(dev)``, ``torch.tensor(..., device=dev)``
                        without ``non_blocking``), which waits as well.
  * ``tracer-branch`` — a tensor in ``if``/``while``/``assert``/``and``/
                        ``or`` inside the traced layers (models / core /
                        kernels / quant).  In JAX this is a tracer leak under
                        ``jit``; in torch it is ``bool(tensor)``: a sync,
                        and a capture breaker.
  * ``debug-call``    — ``print`` of a device value, ``breakpoint()``.
  * ``block-sync``    — ``torch.cuda.synchronize`` and ``.synchronize()`` on
                        a stream or an event; legitimate only as a deliberate
                        fence (pragma it with the justification).

Device-ness is inferred per function with a single in-order pass, as JAX
infers it: calls rooted at ``torch.`` / ``F.`` that return tensors are
device values, as are names imported from modules matching
``device_import_re`` (the model / kernel layers), ``self._*`` calls in
engine modules, and parameters annotated ``torch.Tensor``; assignment
propagates it to the bound names.  ``.shape`` / ``.dtype`` / ``.device`` /
``.ndim`` and ``.numel()`` / ``.size()`` / ``.dim()`` are host reads, as are
``torch.cuda.is_available``, ``torch.device``, ``torch.Size``,
``torch.finfo`` / ``torch.iinfo`` and the like (``_HOST_CALLS``); a value
that went through ``.cpu()`` / ``.tolist()`` / ``.item()`` is a host value.

A finding's line is the line the interpreter reports for the call: for a
method call over several lines, the line of the method's name.

Severity comes from the module map: findings in hot modules (serving /
models / kernels / core / quant) are **errors**, in cold modules (launch
CLIs, training drivers, data, obs, ...) **warnings**.

Suppression: ``# analysis: allow(<rule>[, <rule>...]) — <one-line why>`` on
the offending line, or alone on the line above it.  Suppressed findings are
still reported (inert), so the card's sync locator (``analysis/syncs.py``)
can hold every sync it sees against a finding, active or suppressed.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set

from repro_torch.analysis.findings import Report

PRAGMA_RE = re.compile(r"#\s*analysis:\s*allow\(\s*([\w\-*,\s]+?)\s*\)")

RULES = ("host-item", "host-cast", "host-asarray", "tracer-branch",
         "debug-call", "block-sync")

# attribute reads that are static metadata, not device values
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "is_meta", "layout",
                 "requires_grad", "grad_fn", "is_leaf", "names", "cuda_stream"}
# method calls that read host metadata of a tensor
_STATIC_METHODS = {"numel", "size", "dim", "stride", "element_size", "data_ptr",
                   "is_contiguous", "get_device", "is_floating_point", "is_complex",
                   "untyped_storage", "storage_offset", "nelement"}
# method calls whose result is a host value (the sync itself is its own rule)
_TO_HOST = {"cpu", "tolist", "numpy", "item"}

# torch-rooted calls that return HOST values (platform probes, static
# metadata, dtype arithmetic): not device tensors
_HOST_CALLS = {
    "torch.cuda.is_available", "torch.cuda.device_count", "torch.cuda.current_device",
    "torch.cuda.get_device_name", "torch.cuda.get_device_properties",
    "torch.cuda.get_device_capability", "torch.cuda.current_stream", "torch.cuda.device",
    "torch.cuda.stream", "torch.cuda.Stream", "torch.cuda.Event", "torch.cuda.memory_allocated",
    "torch.cuda.max_memory_allocated", "torch.cuda.is_current_stream_capturing",
    "torch.device", "torch.Size", "torch.finfo", "torch.iinfo", "torch.dtype",
    "torch.is_tensor", "torch.is_floating_point", "torch.is_grad_enabled",
    "torch.is_inference_mode_enabled", "torch.get_num_threads", "torch.set_num_threads",
    "torch.promote_types", "torch.result_type", "torch.can_cast", "torch.Generator",
    "torch.no_grad", "torch.enable_grad", "torch.inference_mode", "torch.set_grad_enabled",
    "torch.get_default_dtype", "torch.distributed.get_rank", "torch.distributed.get_world_size",
    "torch.distributed.is_initialized", "torch.distributed.get_backend",
    "torch.utils.checkpoint.checkpoint",
}
_DEVICE_ROOTS = ("torch", "F")
# torch calls that make a HOST tensor unless given a device
_HOST_TENSOR_CALLS = {"torch.from_numpy", "torch.as_tensor", "torch.tensor"}
# builtins whose value follows their arguments (``max(t.sum(), 1)``)
_ARG_BUILTINS = {"max", "min", "abs", "sum", "round", "pow"}
_SYNC_CALLS = {"torch.cuda.synchronize"}


@dataclass
class LintConfig:
    # module-path regexes (matched against the path relative to the scan
    # root, forward slashes): hot findings are errors, cold are warnings
    hot_re: str = r"(serving|models|kernels|core|quant)/"
    # the traced layers: code that runs inside a model step, where a branch
    # on a tensor is a sync (tracer-branch applies here)
    traced_re: str = r"(models|kernels|core|quant)/"
    # imports from these modules are device-producing callables
    device_import_re: str = (
        r"repro_torch\.(models|kernels|core|quant|serving\.sampling)")
    # calls to self.<attr> matching this, in engine modules, produce device
    # values (the engines' model-step calls, samplers and cache makers)
    jit_attr_re: str = r"^_(decode|prefill|reset|copy|make_caches|sample|verify|propose)"
    engine_re: str = r"serving/"
    # boolean predicates and host helpers by naming convention
    # (is_/has_/check_/spec_is_..., num_/n_..., ..._plan / ..._size) return host values
    # even when imported from device modules
    host_fn_re: str = (r"(^_?(is|has|check|can|supports|num|n|resolve|arch|spec)_)"
                       r"|(^spec_is_)|(_is_)"
                       r"|(_plan$)|(_splits$)|(_capacity$)|(_rows$)|(_variant$)|(_size$)")
    skip_re: str = r"analysis/"  # don't lint the linter's own fixtures

    def severity_for(self, relpath: str, rule: str) -> Optional[str]:
        hot = re.search(self.hot_re, relpath) is not None
        if rule == "tracer-branch":
            return "error" if re.search(self.traced_re, relpath) else None
        return "error" if hot else "warning"


def _pragmas(source: str) -> Dict[int, Set[str]]:
    """line number (1-based) -> set of allowed rules on that line.  A pragma
    on a comment-only line also covers the next line."""
    out: Dict[int, Set[str]] = {}
    lines = source.splitlines()
    for i, line in enumerate(lines, 1):
        m = PRAGMA_RE.search(line)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        out.setdefault(i, set()).update(rules)
        if line.strip().startswith("#"):
            out.setdefault(i + 1, set()).update(rules)
    return out


def _dotted(node: ast.AST) -> Optional[str]:
    """'torch.einsum' / 'self._decode' / 'np.asarray' for an attr chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _device_arg(call: ast.Call) -> Optional[ast.AST]:
    """The ``device=`` argument of a call, or None."""
    for k in call.keywords:
        if k.arg == "device":
            return k.value
    return None


def _is_cpu(node: Optional[ast.AST]) -> bool:
    return isinstance(node, ast.Constant) and node.value == "cpu"


def _moves_to_device(call: ast.Call) -> bool:
    """``x.cuda()`` or ``x.to(dev)`` with a device other than the CPU (an
    argument that is not a ``torch.<dtype>``), without ``non_blocking=True``."""
    if any(k.arg == "non_blocking" and not (isinstance(k.value, ast.Constant)
                                            and not k.value.value) for k in call.keywords):
        return False
    if call.func.attr == "cuda":
        return True
    args = list(call.args) + [k.value for k in call.keywords if k.arg == "device"]
    return any(not _is_cpu(a) and not (_dotted(a) or "").startswith("torch.") for a in args)


def _tensor_annotation(ann: Optional[ast.AST]) -> bool:
    """``torch.Tensor``, ``Tensor`` or ``Optional[torch.Tensor]``."""
    if ann is None:
        return False
    text = ast.unparse(ann)
    return re.fullmatch(r"(Optional\[)?(torch\.)?Tensor\]?", text) is not None


class _FileLinter(ast.NodeVisitor):
    def __init__(self, relpath: str, source: str, cfg: LintConfig, report: Report):
        self.relpath = relpath
        self.cfg = cfg
        self.report = report
        self.pragmas = _pragmas(source)
        self.device_fns: Set[str] = set()  # module-level device-producing names
        self.scopes: List[Set[str]] = []  # per-function device-bound names
        self.host_tensors: List[Set[str]] = []  # per-function names of host tensors
        self.engine = re.search(cfg.engine_re, relpath) is not None
        self._tests: Set[int] = set()  # BoolOps already checked as a branch test
        # functions defined in this module: their value follows their arguments
        self.local_fns: Set[str] = {n.name for n in ast.parse(source).body
                                    if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}

    # -- imports: which names are device-producing callables ---------------
    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module and re.search(self.cfg.device_import_re, node.module):
            for a in node.names:
                self.device_fns.add(a.asname or a.name)
        self.generic_visit(node)

    # -- device-ness --------------------------------------------------------
    def _call_is_device(self, call: ast.Call) -> bool:
        name = _dotted(call.func)
        if name is None:
            return False
        last = name.split(".")[-1]
        if re.search(self.cfg.host_fn_re, last):
            return False  # host helper by naming convention
        root = name.split(".")[0]
        if root in _DEVICE_ROOTS:
            if name in _HOST_CALLS or name in _SYNC_CALLS:
                return False
            return not name.startswith(("torch.cuda.", "torch.distributed.", "torch.backends.",
                                        "torch.testing.", "torch.profiler."))
        if name in self.device_fns:
            return True
        if self.engine and name.startswith("self.") and name.count(".") == 1:
            if re.match(self.cfg.jit_attr_re, name.split(".", 1)[1]):
                return True
        return False

    def _is_host_tensor(self, node: ast.AST) -> bool:
        """A tensor made on the host: ``torch.from_numpy(...)`` and the like
        (through any chain of methods), or a name bound to one."""
        while True:
            if isinstance(node, ast.Name):
                return bool(self.host_tensors) and node.id in self.host_tensors[-1]
            if isinstance(node, ast.Call):
                name = _dotted(node.func)
                if name in _HOST_TENSOR_CALLS:
                    return _device_arg(node) is None or _is_cpu(_device_arg(node))
                if isinstance(node.func, ast.Attribute) and node.func.attr not in ("to", "cuda"):
                    node = node.func.value
                    continue
                return False
            if isinstance(node, ast.Subscript):
                node = node.value
                continue
            return False

    def _call_is_host(self, call: ast.Call) -> bool:
        """A call whose result is a host value whatever its arguments."""
        if isinstance(call.func, ast.Attribute) and call.func.attr in _STATIC_METHODS | _TO_HOST:
            return True
        name = _dotted(call.func)
        if name is None:
            return False
        if name in _HOST_TENSOR_CALLS and _device_arg(call) is None:
            return True
        return (name in _HOST_CALLS or name in ("len", "isinstance", "range")
                or re.search(self.cfg.host_fn_re, name.split(".")[-1]) is not None)

    def _is_device(self, node: ast.AST) -> bool:
        """Does this expression involve a device value?  Host reads
        (``.shape``, ``.numel()``, ``.cpu()`` ...) cut the search."""
        for sub in self._walk_non_static(node):
            if isinstance(sub, ast.Call) and self._call_is_device(sub):
                return True
            if isinstance(sub, ast.Name) and self.scopes and sub.id in self.scopes[-1]:
                return True
        return False

    def _walk_non_static(self, node: ast.AST) -> Iterable[ast.AST]:
        if isinstance(node, ast.Attribute) and node.attr in _STATIC_ATTRS:
            return
        if isinstance(node, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            return  # an identity test is a host bool
        if isinstance(node, ast.Call):
            if self._call_is_host(node):
                return  # x.numel() / x.cpu() / is_paged(x): a host value
            yield node
            # a method's value follows its receiver (x.sum()); a function of
            # this module follows its arguments; any other call (a ctypes
            # entry point, a lambda) returns what the host gives it
            if isinstance(node.func, ast.Attribute):
                yield from self._walk_non_static(node.func.value)
            elif isinstance(node.func, ast.Name) and node.func.id in self.local_fns | _ARG_BUILTINS:
                for a in list(node.args) + [k.value for k in node.keywords]:
                    yield from self._walk_non_static(a)
            return
        yield node
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            # a comprehension's value is its ELEMENT
            yield from self._walk_non_static(node.elt)
            return
        for child in ast.iter_child_nodes(node):
            yield from self._walk_non_static(child)

    # -- scope handling ------------------------------------------------------
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        scope: Set[str] = set()
        a = node.args
        for arg in a.posonlyargs + a.args + a.kwonlyargs:
            if _tensor_annotation(arg.annotation):
                scope.add(arg.arg)
        self.scopes.append(scope)
        self.host_tensors.append(set())
        self.generic_visit(node)
        self.scopes.pop()
        self.host_tensors.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def _bind_targets(self, targets: Sequence[ast.AST]) -> None:
        if not self.scopes:
            return
        for t in targets:
            if isinstance(t, (ast.Tuple, ast.List)):
                self._bind_targets(t.elts)
            elif isinstance(t, ast.Name):
                self.scopes[-1].add(t.id)
            elif isinstance(t, ast.Starred):
                self._bind_targets([t.value])

    def _unbind_targets(self, targets: Sequence[ast.AST]) -> None:
        if not self.scopes:
            return
        for t in targets:
            if isinstance(t, (ast.Tuple, ast.List)):
                self._unbind_targets(t.elts)
            elif isinstance(t, ast.Name):
                self.scopes[-1].discard(t.id)

    def visit_Assign(self, node: ast.Assign) -> None:
        # visit RHS first: `x = x_dev.cpu()` must flag the OLD x
        self.visit(node.value)
        for t in node.targets:  # subscript/attr targets can hold calls too
            if not isinstance(t, (ast.Name, ast.Tuple, ast.List, ast.Starred)):
                self.visit(t)
        if self.host_tensors:
            for t in node.targets:
                if isinstance(t, ast.Name):
                    if self._is_host_tensor(node.value):
                        self.host_tensors[-1].add(t.id)
                    else:
                        self.host_tensors[-1].discard(t.id)
        root = _dotted(node.value.func) if isinstance(node.value, ast.Call) else None
        if root and root.split(".")[0] == "np":
            self._unbind_targets(node.targets)  # np.* results are host values
        elif self._is_device(node.value):
            self._bind_targets(node.targets)
        else:
            self._unbind_targets(node.targets)  # rebinding to a host value clears it

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self.visit(node.value)
            if self._is_device(node.value):
                self._bind_targets([node.target])
            else:
                self._unbind_targets([node.target])

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self.visit(node.value)
        if self._is_device(node.value):
            self._bind_targets([node.target])

    def visit_For(self, node: ast.For) -> None:
        # iterating a device value binds device rows; iterating .tolist() a host one
        self.visit(node.iter)
        if self._is_device(node.iter):
            self._bind_targets([node.target])
        else:
            self._unbind_targets([node.target])
        for stmt in node.body + node.orelse:
            self.visit(stmt)

    # -- findings ------------------------------------------------------------
    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        sev = self.cfg.severity_for(self.relpath, rule)
        if sev is None:
            return
        line = getattr(node, "lineno", 0)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            line = node.func.end_lineno  # the line the interpreter reports for the call
        allowed = self.pragmas.get(line, set())
        suppressed = rule in allowed or "*" in allowed
        self.report.add(rule, sev, f"{self.relpath}:{line}", message,
                        suppressed=suppressed)

    def visit_Call(self, node: ast.Call) -> None:
        name = _dotted(node.func)
        method = node.func.attr if isinstance(node.func, ast.Attribute) else None
        recv = node.func.value if isinstance(node.func, ast.Attribute) else None
        if method == "item" and not node.args:
            self._emit("host-item", node, "`.item()` forces a device->host sync")
        elif name in ("int", "float", "bool") and node.args and self._is_device(node.args[0]):
            self._emit("host-cast", node,
                       f"`{name}()` over a device value blocks on the result")
        elif method in ("cpu", "tolist", "numpy") and recv is not None and self._is_device(recv):
            self._emit("host-asarray", node,
                       f"`.{method}()` of a device value is a blocking transfer")
        elif method == "to" and recv is not None and self._to_cpu(node) and self._is_device(recv):
            self._emit("host-asarray", node,
                       "`.to('cpu')` of a device value is a blocking transfer")
        elif method in ("to", "cuda") and recv is not None and self._is_host_tensor(recv) \
                and _moves_to_device(node):
            self._emit("host-asarray", node,
                       f"`.{method}()` of a pageable host tensor waits for the stream")
        elif name in _HOST_TENSOR_CALLS and _device_arg(node) is not None \
                and not _is_cpu(_device_arg(node)):
            self._emit("host-asarray", node,
                       f"`{name}(..., device=)` copies from pageable memory and waits for "
                       "the stream")
        elif name in ("np.asarray", "np.array", "numpy.asarray", "numpy.array") \
                and node.args and self._is_device(node.args[0]):
            self._emit("host-asarray", node,
                       f"`{name}` of a device value is a blocking transfer")
        elif name == "breakpoint" or (name == "print" and any(
                self._is_device(a) for a in node.args)):
            self._emit("debug-call", node,
                       f"`{name}` in a step waits on the host; remove before serving")
        elif name in _SYNC_CALLS or method == "synchronize":
            self._emit("block-sync", node,
                       "explicit device fence in a hot module")
        self.generic_visit(node)

    @staticmethod
    def _to_cpu(call: ast.Call) -> bool:
        args = list(call.args) + [k.value for k in call.keywords if k.arg == "device"]
        return any(isinstance(a, ast.Constant) and a.value == "cpu" for a in args)

    def _check_branch(self, test: ast.AST, kind: str) -> None:
        # `x is None` / `x is not None` on a device name is a host-side
        # identity test, not a sync — common and fine
        if isinstance(test, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops):
            return
        # `isinstance(x, QuantizedKV)` is a type dispatch, not a sync
        if isinstance(test, ast.Call) and _dotted(test.func) == "isinstance":
            return
        if isinstance(test, ast.BoolOp):
            self._tests.add(id(test))
            for v in test.values:
                self._check_branch(v, kind)
            return
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            self._check_branch(test.operand, kind)
            return
        if self._is_device(test):
            self._emit("tracer-branch", test,
                       f"Python `{kind}` on a device value is `bool(tensor)`: a sync, and a "
                       "break in a CUDA graph capture")

    def visit_If(self, node: ast.If) -> None:
        self._check_branch(node.test, "if")
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        self._check_branch(node.test, "while")
        self.generic_visit(node)

    def visit_Assert(self, node: ast.Assert) -> None:
        self._check_branch(node.test, "assert")
        self.generic_visit(node)

    def visit_IfExp(self, node: ast.IfExp) -> None:
        self._check_branch(node.test, "if-expression")
        self.generic_visit(node)

    def visit_BoolOp(self, node: ast.BoolOp) -> None:
        # `a and b` outside a branch test: every operand but the last is
        # tested for truth
        if id(node) not in self._tests:
            self._tests.add(id(node))
            for v in node.values[:-1]:
                self._check_branch(v, "and/or")
        self.generic_visit(node)


def lint_source(source: str, relpath: str, cfg: Optional[LintConfig] = None,
                report: Optional[Report] = None) -> Report:
    report = report if report is not None else Report()
    cfg = cfg if cfg is not None else LintConfig()
    tree = ast.parse(source, filename=relpath)
    _FileLinter(relpath, source, cfg, report).visit(tree)
    return report


def lint_tree(root: str, cfg: Optional[LintConfig] = None) -> Report:
    """Lint every ``.py`` under ``root`` (the ``src/repro_torch`` package)."""
    cfg = cfg if cfg is not None else LintConfig()
    report = Report()
    rootp = Path(root)
    for path in sorted(rootp.rglob("*.py")):
        rel = path.relative_to(rootp).as_posix()
        if re.search(cfg.skip_re, rel):
            continue
        lint_source(path.read_text(), rel, cfg, report)
    counts: Dict[str, int] = {}
    for f in report.findings:
        if not f.suppressed:
            counts[f.rule] = counts.get(f.rule, 0) + 1
    report.metrics["lint.files"] = sum(1 for _ in rootp.rglob("*.py"))
    report.metrics["lint.findings_by_rule"] = counts
    return report
