"""Step-signature contract checker (``repro/analysis/contracts.py`` on the
port's eager steps).

Under XLA every distinct (shape, dtype) signature of a jitted function is
one compile, so a serving engine must call its functions with a CLOSED and
SMALL signature set.  The port compiles nothing, but the same set matters
to it: each distinct signature of a step is one CUDA graph capture that
ROADMAP item 10 would make (a captured graph replays one fixed shape), so
a steady-state step must keep one signature, and admission may add one per
chunk length drawn from a bounded, page-aligned family.  This pass checks
that property from a declared contract (``engine_contract``, built from the
same config values that size the real buffers):

  1. **run check** — every declared signature runs: the step is called
     once per sample point on fresh tensors of that signature (reduced
     configs on the CPU: "abstract-trace" becomes one eager run).  The
     entries' ``mutated`` arguments feed the in-place audit
     (``analysis.donation``, the port's counterpart of JAX's donation
     checks).
  2. **closure check** — signatures reachable from scheduler states
     (chunk boundaries +-1 around every prompt length, preemption replays
     that grow the context by generated tokens, fork admissions) stay inside
     the declared family, and every non-final chunk length is page-aligned.
  3. **signature-count prediction** — a host-side replay of the scheduler's
     admission arithmetic (``ContinuousEngine._advance_prefill``'s chunk
     splitting) yields the distinct signatures each step function will be
     called with.  ``observe_steps`` wraps the engine modules' step
     functions and records the signatures a run actually makes; the tests
     hold the two equal, as JAX's hold the prediction equal to the retrace
     watchdog's compile counts.  ``obs/retrace.py`` registers nothing in the
     port (item 10's work).

The pure arithmetic (``chunk_lengths``, ``Workload``,
``reachable_chunk_lengths``, ``check_closure``, ``predict_compiles``) is a
copy of JAX's, kept in sync by hand.
"""
from __future__ import annotations

import contextlib
import importlib
import sys
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from repro_torch.analysis.findings import Report


@dataclass
class ContractEntry:
    """One step function's declared signature family.

    ``points`` is the closed domain (tuples of family parameters, e.g.
    ``(chunk_len,)``); ``sample`` the representative points that are run
    (boundaries, page multiples +-1).  ``primary`` marks steady-state steps:
    their family must be a singleton.  ``mutated``: the positional arguments
    the step writes in place (JAX's ``donate_argnums``), each checked to keep
    its storage; ``returns`` maps such an argument to the output that hands
    it back."""

    name: str
    fn: Callable
    make: Callable[..., tuple]  # (*point) -> positional args (fresh tensors)
    points: Tuple[tuple, ...]
    sample: Tuple[tuple, ...]
    primary: bool = False
    mutated: Tuple[int, ...] = ()
    returns: Optional[Dict[int, int]] = None


def check_contract(entries: Sequence[ContractEntry],
                   report: Optional[Report] = None) -> Report:
    """Pass 1: primary-singleton + one run per sample point (the in-place
    audit of the mutated arguments is ``analyze_inplace``'s pass)."""
    report = report if report is not None else Report()
    total_sigs = 0
    for e in entries:
        total_sigs += len(e.points)
        if e.primary and len(e.points) != 1:
            report.add(
                "contract-open", "error", e.name,
                f"steady-state step declares {len(e.points)} admissible signatures: the "
                "fixed-shape tick contract requires exactly one (every extra signature is "
                "another graph capture in steady state)")
        for pt in e.sample:
            args = e.make(*pt)
            try:
                with torch.no_grad():
                    e.fn(*args)
            except Exception as exc:
                report.add(
                    "contract-trace-failed", "error", f"{e.name}{pt}",
                    f"declared signature does not run: {exc!r}".replace("\n", " ")[:300])
    report.metrics["contract.functions"] = len(entries)
    report.metrics["contract.declared_signatures"] = total_sigs
    return report


# ---------------------------------------------------------------------------
# Chunk arithmetic (mirrors ContinuousEngine._advance_prefill)
# ---------------------------------------------------------------------------


def chunk_lengths(ctx_len: int, start: int, budget: int, page_size: int) -> List[int]:
    """Chunk lengths one uninterrupted application of ``budget`` tokens emits
    for a context of ``ctx_len`` beginning at page-aligned ``start`` — the
    same alignment rules as the scheduler: a non-final chunk ends on a page
    boundary, and leftover budget smaller than a page defers."""
    out: List[int] = []
    pos = start
    left = budget
    while pos < ctx_len and left > 0:
        end = min(ctx_len, pos + left)
        if end < ctx_len:
            end -= end % page_size
            if end <= pos:
                break  # sub-page leftover defers to the next tick
        out.append(end - pos)
        left -= end - pos
        pos = end
    return out


@dataclass
class Workload:
    """The scenario the prediction replays: ``prompt_lens`` submitted
    upfront in order, each decoding ``max_new`` tokens, the engine stepped
    ``ticks`` times.  ``forks`` > 0 marks the first request as a
    ``submit_n(req, forks + 1)`` parallel-sample base."""

    prompt_lens: Sequence[int]
    max_new: int
    ticks: int
    forks: int = 0


def reachable_chunk_lengths(capacity: int, page_size: int, prefill_chunk: int,
                            workload: Workload, *, perturb: int = 1,
                            preempt_generated: Iterable[int] = (0, 1)) -> set:
    """Every chunk length any reachable scheduler state can emit: prompt
    lengths +-``perturb``, preemption replays (context grows by generated
    tokens), all page-aligned resume starts, all partial tick budgets."""
    keep = capacity - max(1, min(workload.max_new, capacity - 1))
    ctxs = set()
    for p in workload.prompt_lens:
        for d in range(-perturb, perturb + 1):
            for g in list(preempt_generated) + [workload.max_new]:
                ctxs.add(min(max(1, p + d) + g, max(keep, 1), capacity))
    out = set()
    for ctx in ctxs:
        for start in range(0, ctx, page_size):
            for budget in (page_size, prefill_chunk, max(1, prefill_chunk // 2)):
                out.update(chunk_lengths(ctx, start, budget, page_size))
    return out


def check_closure(entries: Sequence[ContractEntry], *, capacity: int,
                  page_size: int, prefill_chunk: int, workload: Workload,
                  report: Optional[Report] = None) -> Report:
    """Pass 2: reachable signatures stay inside the declared family."""
    report = report if report is not None else Report()
    reach = reachable_chunk_lengths(capacity, page_size, prefill_chunk, workload)
    declared = {e.name: {pt[0] for pt in e.points} for e in entries
                if e.name in ("prefill_chunk_first", "prefill_chunk_cont")}
    for name, domain in declared.items():
        escaped = sorted(reach - domain)
        if escaped:
            report.add(
                "contract-escape", "error", name,
                f"reachable chunk lengths {escaped[:8]} are outside the "
                f"declared family (|domain|={len(domain)}) — each escape is "
                "an unplanned compilation",
            )
    bad_align = sorted(l for l in reach
                       if l > page_size and l % page_size and l != max(reach))
    # non-final chunks must be page multiples; the only unaligned length a
    # context can emit is its own final remainder, which is <= prefill_chunk
    over = sorted(l for l in reach if l > prefill_chunk or l <= 0)
    if over:
        report.add("contract-escape", "error", "chunk-budget",
                   f"reachable chunk lengths {over[:8]} exceed the per-tick "
                   f"budget {prefill_chunk}")
    report.metrics["contract.reachable_chunk_lengths"] = len(reach)
    report.metrics["contract.unaligned_reachable"] = len(bad_align)
    return report


# ---------------------------------------------------------------------------
# Compile-count prediction (host-side scheduler replay)
# ---------------------------------------------------------------------------


def predict_compiles(*, slots: int, capacity: int, page_size: int,
                     prefill_chunk: int, workload: Workload,
                     prefill_mode: str = "chunked",
                     skip_shared_compute: bool = True,
                     spec: Optional[dict] = None) -> Dict[str, int]:
    """Per-function compile counts the workload will pay, by replaying the
    scheduler's admission/decode arithmetic host-side (no tracing, no
    device).  Keys match the JAX engine's jit registry; in the port each count is
    the number of distinct step signatures (``observe_steps``), one CUDA
    graph capture each under ROADMAP item 10.

    Scope (documented, asserted by the callers): requests submitted upfront,
    pool provisioned so the replayed workload never preempts, no prefix
    overlap between distinct prompts.  Forks model ``submit_n``: the base
    admits normally, each fork shares its pages (one ``copy_slot``
    signature) and CoWs its boundary page at the first divergent append
    (one ``copy_page`` signature).

    ``prefill_mode`` selects the admission state machine being replayed and
    with it the OUTPUT KEY SET (keys mirror the engine's jit registry for
    that mode): "chunked" predicts per-chunk-length first/cont compiles;
    "batched" replaces them with a single ``prefill_chunk_batched`` key that
    is 1 iff any chunk ran — the batched entry's shapes are fixed at
    ``[slots, prefill_chunk]``, so it compiles at most once no matter the
    workload (admission itself launches no compute; every mid-prefill slot
    advances one chunk per tick); "scatter" predicts one ``prefill`` compile
    per distinct context length.

    ``spec`` (a dict, ``{"commit_pass": bool}``) switches the decode side to
    draft-then-verify speculation: every decode tick becomes one fixed-shape
    ``verify`` + ``draft_propose`` + ``spec_reset_tail`` call (plus one
    ``spec_commit`` when the target arch carries non-paged recurrent state —
    ``commit_pass``), so each key compiles at most once; the one-token
    ``decode`` entry stays registered but is never called.  The drafter's
    lazy per-slot prefill traces one signature per distinct context length.
    Compile counts are accept-rate-INDEPENDENT (every per-tick shape is
    fixed at ``[slots, k+1]``), but tick/completion TIMING is not — callers
    asserting predicted==observed live must use a drafter whose accept
    pattern they control (the self-draft oracle: full accepts, no rollback,
    which also keeps ``reset_pages`` = "1 iff completions" exact, since
    completions are the only page-freeing events left)."""
    budget_tokens = max(1, min(workload.max_new, capacity - 1))
    keep = capacity - budget_tokens

    first_lens: set = set()
    cont_lens: set = set()
    scatter_sigs: set = set()

    class Slot:
        def __init__(self, ctx):
            self.ctx = ctx
            self.done = 0
            self.generated = 0
            self.started = False
            self.prefilling = True

    queue: List[int] = [min(max(p, 1), max(keep, 1)) for p in workload.prompt_lens]
    forks_waiting = workload.forks
    active: List[Slot] = []
    completions = 0
    fork_admitted = 0
    cow_events = 0
    decode_ran = False

    def advance(s: Slot, budget: int) -> int:
        spent = 0
        for n in chunk_lengths(s.ctx, s.done, budget, page_size):
            (cont_lens if s.started else first_lens).add(n)
            s.started = True
            s.done += n
            spent += n
        if s.done >= s.ctx:
            s.prefilling = False
            s.generated = 1  # last-chunk logits seed the first token
        return spent

    def admit(budget: Optional[int]) -> int:
        """Admit from the queue head into free slots; returns budget spent."""
        nonlocal fork_admitted
        spent = 0
        while queue and len(active) < slots:
            ctx = queue.pop(0)
            s = Slot(ctx)
            active.append(s)
            if prefill_mode == "chunked":
                spent += advance(s, prefill_chunk if budget is None
                                 else max(budget - spent, 0))
            elif prefill_mode == "batched":
                pass  # first chunk joins the NEXT tick's single batched call
            else:
                scatter_sigs.add(ctx)
                s.prefilling = False
                s.generated = 1
        # forks of the first request share it once it finishes prefilling
        nonlocal forks_waiting
        while (forks_waiting and active and not active[0].prefilling
               and len(active) < slots):
            f = Slot(active[0].ctx)
            f.prefilling = False
            f.started = True
            f.done = f.ctx
            f.generated = active[0].generated
            active.append(f)
            forks_waiting -= 1
            fork_admitted += 1
        return spent

    batched_ran = False
    admit(None)  # submit() admissions: one full chunk budget each
    for _ in range(workload.ticks):
        budget = prefill_chunk
        if prefill_mode == "batched":
            # every mid-prefill slot advances ONE chunk in the tick's single
            # batched call (per-ROW budget, fixed [slots, chunk] shapes)
            for s in [s for s in active if s.prefilling]:
                ch = chunk_lengths(s.ctx, s.done, prefill_chunk, page_size)
                if not ch:
                    continue
                batched_ran = True
                s.started = True
                s.done += ch[0]
                if s.done >= s.ctx:
                    s.prefilling = False
                    s.generated = 1
        else:
            for s in [s for s in active if s.prefilling]:
                if budget <= 0:
                    break
                budget -= advance(s, budget)
        decoders = [s for s in active if not s.prefilling]
        if decoders:
            decode_ran = True
            if fork_admitted and cow_events == 0:
                cow_events = 1  # first divergent append CoWs the shared page
            for s in decoders:
                s.generated += 1
        finished = [s for s in active if not s.prefilling
                    and s.generated >= budget_tokens]
        for s in finished:
            active.remove(s)
            completions += 1
        if finished:
            budget -= admit(budget)

    out = {
        "decode": 1 if decode_ran else 0,
        "prefill": len(scatter_sigs),
        "reset_pages": 1 if completions else 0,
        "copy_slot": 1 if fork_admitted else 0,
        "copy_page": 1 if cow_events else 0,
    }
    # key set mirrors the engine's jit registry for the mode — the observed
    # side compares EVERY registered fn's cache size, unfiltered
    if prefill_mode == "batched":
        out["prefill_chunk_batched"] = 1 if batched_ran else 0
    else:
        out["prefill_chunk_first"] = len(first_lens)
        out["prefill_chunk_cont"] = len(cont_lens)
    if spec is not None:
        # speculation replaces the one-token decode step with the fixed-shape
        # verify/propose/reset-tail triple; `decode` stays in the registry
        # (shape-contracted, never dispatched).  The drafter lazily prefills
        # each slot's context once — one compile per distinct context length
        # (clamped the same way the queue above was).
        v = out["decode"]
        out["decode"] = 0
        out["verify"] = v
        out["draft_propose"] = v
        out["spec_reset_tail"] = v
        if spec.get("commit_pass"):
            out["spec_commit"] = v
        out["draft_prefill"] = (
            len({min(max(p, 1), max(keep, 1)) for p in workload.prompt_lens})
            if v else 0)
    return out


# ---------------------------------------------------------------------------
# The port's engines: declared contracts and observed signatures
# ---------------------------------------------------------------------------


def engine_contract(engine) -> List[ContractEntry]:
    """The declared contract of a ``ContinuousEngine`` (paged) or a static
    ``Engine``, as JAX's ``shape_contract()`` declares it; every sample
    point runs on fresh caches, so the engine's own are never touched."""
    from repro_torch.models import model as M

    cfg, params, dev = engine.cfg, engine.params, engine.device
    i32 = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=dev)
    tok = lambda *shape: torch.zeros(shape, dtype=torch.long, device=dev)
    boolv = lambda *shape: torch.ones(shape, dtype=torch.bool, device=dev)

    def entry(name, fn, make, points, sample, primary=False, mutated=(), returns=None):
        return ContractEntry(name=name, fn=fn, make=make, points=tuple(points),
                             sample=tuple(sample), primary=primary, mutated=tuple(mutated),
                             returns=returns)

    if not hasattr(engine, "n_slots"):  # the static engine
        ec = engine.ec
        batches = sorted({1, 2, ec.max_batch} & set(range(1, ec.max_batch + 1)) | {ec.max_batch})
        lens = sorted({1, 16, ec.max_prefill} & set(range(1, ec.max_prefill + 1))
                      | {ec.max_prefill})
        return [
            entry("prefill", lambda p, t, c: M.prefill(cfg, p, t, c, memory=engine.memory,
                                                         prefix_embeds=engine.prefix_embeds),
                  lambda b, s: (params, tok(b, s), engine._make_caches(b)),
                  [(b, s) for b in range(1, ec.max_batch + 1)
                   for s in range(1, ec.max_prefill + 1)],
                  [(b, s) for b in batches for s in lens], mutated=(2,), returns={2: 1}),
            entry("decode", lambda p, t, c: M.decode_step(cfg, p, t, 1, c, memory=engine.memory),
                  lambda b: (params, tok(b, 1), engine._make_caches(b)),
                  [(b,) for b in range(1, ec.max_batch + 1)], [(b,) for b in batches],
                  mutated=(2,), returns={2: 1}),
        ]
    if not engine.paged:
        raise ValueError("engine_contract: the contiguous continuous engine declares no contract "
                         "(as in JAX, only the paged one is checked)")
    S, MP, C, cap = engine.n_slots, engine.max_pages, engine.prefill_chunk, engine.capacity

    def caches():
        return M.init_paged_caches(cfg, S, cap, n_pages=engine.n_pages,
                                   page_size=engine.page_size,
                                   kv_bits=engine.kv_cache_bits, device=dev)

    table = lambda *shape: torch.full(shape, -1, dtype=torch.int32, device=dev)
    ctx_lens = range(1, cap)
    ctx_sample = sorted({1, 2, min(16, cap - 1), cap - 1})
    out = [
        entry("decode", lambda p, t, pos, a, c, tb: M.paged_ragged_decode_step(
                  cfg, p, t, pos, c, tb, a),
              lambda: (params, tok(S, 1), i32(S), boolv(S), caches(), table(S, MP)),
              [()], [()], primary=True, mutated=(4,), returns={4: 1}),
        entry("prefill", lambda p, t, pos, c, tb: M.paged_prefill_into_slot(
                  cfg, p, t, pos, c, tb, slot=0),
              lambda n: (params, tok(1, n), torch.arange(n, dtype=torch.int32, device=dev)[None],
                         caches(), table(MP)),
              [(n,) for n in ctx_lens], [(n,) for n in ctx_sample], mutated=(3,), returns={3: 1}),
    ]
    if engine.prefill_mode == "batched":
        out.append(entry(
            "prefill_chunk_batched",
            lambda p, t, pos, r, a, last, c, tb: M.paged_prefill_chunk_batched(
                cfg, p, t, pos, r, a, last, c, tb),
            lambda: (params, tok(S, C), torch.arange(C, dtype=torch.int32, device=dev).expand(S, C),
                     boolv(S), boolv(S), i32(S) + C - 1, caches(), table(S, MP)),
            [()], [()], primary=True, mutated=(6,), returns={6: 1}))
    else:
        chunk_lens = range(1, C + 1)
        chunk_sample = sorted({1, max(1, engine.page_size - 1), engine.page_size,
                               min(engine.page_size + 1, C), C})
        for nm, reset in (("prefill_chunk_first", True), ("prefill_chunk_cont", False)):
            out.append(entry(
                nm, lambda p, t, pos, c, tb, reset=reset: M.paged_prefill_chunk(
                    cfg, p, t, pos, c, tb, slot=0, reset=reset),
                lambda n: (params, tok(1, n), torch.arange(n, dtype=torch.int32, device=dev)[None],
                           caches(), table(MP)),
                [(n,) for n in chunk_lens], [(n,) for n in chunk_sample],
                mutated=(3,), returns={3: 1}))
    out.append(entry("reset_pages", lambda c, m: M.paged_reset_pages(cfg, c, m),
                     lambda: (caches(), boolv(engine.n_pages + 1)), [()], [()],
                     mutated=(0,), returns={0: 0}))
    out.append(entry("copy_page", lambda c: M.paged_copy_page(cfg, c, 0, 1),
                     lambda: (caches(),), [()], [()], mutated=(0,), returns={0: 0}))
    out.append(entry("copy_slot", lambda c: M.paged_copy_slot_leaves(cfg, c, 0, 1),
                     lambda: (caches(),), [()], [()], mutated=(0,), returns={0: 0}))
    if getattr(engine, "drafter", None) is not None:
        K1 = engine.spec_k + 1
        out.append(entry(
            "verify", lambda p, t, pos, a, c, tb: M.paged_verify_chunk_batched(
                cfg, p, t, pos, a, c, tb),
            lambda: (params, tok(S, K1), i32(S, K1), boolv(S), caches(), table(S, MP)),
            [()], [()], primary=True, mutated=(4,), returns={4: 1}))
        out.append(entry(
            "spec_reset_tail", lambda c, pg, so: M.paged_reset_page_tails(cfg, c, pg, so),
            lambda: (caches(), i32(S), i32(S)), [()], [()], primary=True,
            mutated=(0,), returns={0: 0}))
    return out


# (engine module, model function) -> the contract name of its calls; a
# callable takes (kwargs, calling function's name)
_CALLS = {
    "continuous": {
        "paged_ragged_decode_step": "decode",
        "ragged_decode_step": "decode",
        "paged_prefill_into_slot": "prefill",
        "prefill_into_slot": "prefill",
        "paged_prefill_chunk": lambda kw, caller: (
            "prefill_chunk_first" if kw.get("reset") else "prefill_chunk_cont"),
        "paged_prefill_chunk_batched": lambda kw, caller: (
            "spec_commit" if caller == "_spec_commit" else "prefill_chunk_batched"),
        "paged_reset_pages": "reset_pages",
        "paged_copy_page": "copy_page",
        "paged_copy_slot_leaves": "copy_slot",
        "paged_verify_chunk_batched": "verify",
        "paged_reset_page_tails": "spec_reset_tail",
    },
    "spec": {"ragged_decode_step": "draft_propose", "prefill_into_slot": "draft_prefill"},
    "engine": {"prefill": "prefill", "decode_step": "decode"},
}


def _signature(args, kwargs) -> tuple:
    return tuple((tuple(a.shape), str(a.dtype))
                 for a in list(args) + list(kwargs.values()) if torch.is_tensor(a))


@contextlib.contextmanager
def observe_steps(engines: Sequence[str] = ("continuous", "spec")):
    """Wrap the model-step functions the engine modules call (``_CALLS``)
    for the block; yields ``{contract name: set of signatures}`` (the
    shapes and dtypes of each call's tensor arguments)."""
    seen: Dict[str, set] = {}
    saved = []
    for mod_name in engines:
        mod = importlib.import_module(f"repro_torch.serving.{mod_name}")
        for fn_name, key in _CALLS[mod_name].items():
            fn = getattr(mod, fn_name, None)
            if fn is None:
                continue

            def wrapped(*args, __fn=fn, __key=key, **kwargs):
                name = __key if isinstance(__key, str) else __key(
                    kwargs, sys._getframe(1).f_code.co_name)
                seen.setdefault(name, set()).add(_signature(args, kwargs))
                return __fn(*args, **kwargs)

            saved.append((mod, fn_name, fn))
            setattr(mod, fn_name, wrapped)
    try:
        yield seen
    finally:
        for mod, fn_name, fn in saved:
            setattr(mod, fn_name, fn)


def observed_counts(seen: Dict[str, set], keys: Iterable[str]) -> Dict[str, int]:
    """Distinct signatures per contract name, over ``keys`` (a prediction's
    key set) and every name observed."""
    return {k: len(seen.get(k, ())) for k in sorted(set(keys) | set(seen))}
