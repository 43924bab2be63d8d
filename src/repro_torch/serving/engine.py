"""Static batched serving engine (``repro/serving/engine.py``; paper §5):
batched prefill + decode over contiguous KV caches.

Requests are right-aligned into a ``[B, S]`` prompt buffer padded with
``pad_id``; as in the JAX engine the left pads are not masked, and decode
writes every row at the uniform index ``S + t``.  Each decode step reads the
sampled tokens back to the host (the stop check needs them), so the host
clock between two reads is one step's time; ``last_timings`` keeps those
times for the batch served last.

Each config serves through its own ``moe_impl``: the capacity dispatch
(``dense`` / ``einsum``, and ``ep`` without a mesh) or the grouped one.
Under capacity routing every row of the batch, left pads included, competes
for its expert's slots in token-major order; the engine feeds the MoE
layers the rows the JAX engine feeds them, so the same tokens drop.

``params`` may be full precision or the output of
``repro_torch.quant.quantize_params`` (MoQ int8 / int4 weights, dequantized
inside the grouped expert kernel or at their product sites), and
``EngineConfig.kv_cache_bits=8`` keeps the caches in int8, quantized on
write and read by the int8 decode kernel.

An encoder-decoder config serves with ``memory`` (the output of
``models.model.encode``, [B, T, d_model]): every prefill writes the cross
caches of ``T`` entries from it, and decode steps read them.  A vlm config
takes ``prefix_embeds`` [B, P, embed_dim] (patch embeddings, prepended to
every batch's prompts after ``frontend_proj``): its capacity grows by the
frontend's ``n_tokens`` and its decode index is ``S + n_tokens + t``, as in
the JAX engine (with or without ``prefix_embeds``).  Either tensor holds one
row per request of a batch.

``obs`` (``repro_torch.obs.Obs``, a default one when None) records what
the JAX engine records: ``serve.batch_prefill_s`` (prefill to the first
token read), ``serve.decode_step_s`` (between two token reads),
``serve.decode_tokens``, ``serve.requests_completed``, ``serve.retraces``
(0: the port compiles nothing) and, with ``obs.routing``, the
``routing.*`` gauges and ``last_routing`` (``summarize_routing`` of the
most recent decode step).  The clock reads happen at the token reads the
loop makes anyway: no instrument adds a sync.  Routing statistics cost one
device-to-host copy a step, made after the next token read, when the
device has finished the step; as in JAX, the step that takes the last
generated token runs too, so ``last_routing`` covers it.

Under ``cfg.ep_mesh`` (expert-parallel serving, serving/ep.py) the engine
runs as one rank of an SPMD group: every rank builds it from the same config
and requests, the config's ``moe_impl`` becomes its EP schedule, the routed
experts are cut to this rank's slice (quantized ones dequantized first) and
the model calls run under the mesh.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.gating import routing_to_host, summarize_routing
from repro_torch.models.model import decode_step, init_caches, prefill, resolve_device
from repro_torch.obs import Obs
from repro_torch.quant.ptq import prepare_params_for_serving
from repro_torch.serving.ep import init_engine_mesh, mesh_scope, place_params
from repro_torch.serving.sampling import sample


@dataclass
class EngineConfig:
    max_batch: int = 8
    max_prefill: int = 256
    max_decode: int = 64
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 0.0  # nucleus sampling mass; 0 = off
    eos_id: int = -1  # -1: never stop early
    pad_id: int = 0
    kv_cache_bits: int = 0  # 0 = fp cache, 8 = int8 QuantizedKV (quant/kv.py)


@dataclass
class Request:
    prompt: Sequence[int]
    max_new_tokens: int = 16


@dataclass
class Response:
    tokens: List[int]
    prompt_len: int


class Engine:
    """Synchronous batched engine: one prefill, then one decode step per
    token, on ``device`` (the card unless the caller passes ``"cpu"``)."""

    def __init__(self, cfg: ModelConfig, params, ec: EngineConfig, *, memory=None,
                 prefix_embeds=None, obs=None, device="cuda"):
        if ec.kv_cache_bits not in (0, 8):
            raise ValueError(f"kv_cache_bits must be 0 (fp) or 8 (int8), got {ec.kv_cache_bits}")
        self.device = resolve_device(device)
        # the EP serving mesh (cfg.ep_mesh) rewrites moe_impl to its schedule
        self._mesh, self._mesh_rules, cfg = init_engine_mesh(cfg)
        with mesh_scope(self._mesh, self._mesh_rules):
            params = prepare_params_for_serving(cfg, params)
        if self._mesh is not None:
            params = place_params(self._mesh, self._mesh_rules, params, cfg)
        leaf = params["embed"]
        if leaf.device != self.device:
            raise ValueError(f"Engine: parameters are on {leaf.device}, the engine on {self.device}")
        for what, t in (("memory", memory), ("prefix_embeds", prefix_embeds)):
            if t is not None and t.device != self.device:
                raise ValueError(f"Engine: {what} is on {t.device}, the engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.ec = ec
        self.memory = memory
        self.prefix_embeds = prefix_embeds
        # a vlm's patch positions come first: its decode index is S + offset + t
        self._offset = cfg.frontend.n_tokens if (cfg.frontend is not None
                                                 and cfg.family == "vlm") else 0
        self._capacity = ec.max_prefill + ec.max_decode + self._offset
        self._cross_len = memory.shape[1] if memory is not None else 0
        self.last_timings: dict = {}
        # the JAX engine's instruments: metrics on, tracer off, routing off
        # unless the caller's Obs says otherwise
        self.obs = obs if obs is not None else Obs()
        self._tr = self.obs.tracer if self.obs.tracer.enabled else None
        M = self.obs.metrics
        self._h_prefill = M.histogram("serve.batch_prefill_s")
        self._h_step = M.histogram("serve.decode_step_s", lo=1e-5, hi=10.0)
        self._c_decode_toks = M.counter("serve.decode_tokens", unit="tok")
        self._c_completed = M.counter("serve.requests_completed", unit="req")
        self._c_retraces = M.counter("serve.retraces", unit="compile")
        self._g_r_drop = M.gauge("routing.dropped_frac")
        self._g_r_ent = M.gauge("routing.entropy", unit="nat")
        self._g_r_imb = M.gauge("routing.imbalance")
        # summarize_routing of the most recent decode step, with obs.routing
        self.last_routing = None

    def _make_caches(self, batch: int) -> dict:
        return init_caches(self.cfg, batch, self._capacity, cross_len=self._cross_len,
                           kv_bits=self.ec.kv_cache_bits, device=self.device)

    def generate(self, requests: Sequence[Request], *, seed: int = 0) -> List[Response]:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        out: List[Response] = []
        with mesh_scope(self._mesh, self._mesh_rules):
            for start in range(0, len(requests), self.ec.max_batch):
                out.extend(self._generate_batch(requests[start : start + self.ec.max_batch], gen))
        return out

    def _routing(self, stats) -> None:
        """``last_routing`` and the routing gauges from a step's stats tree
        (one device-to-host copy)."""
        self.last_routing = summarize_routing(routing_to_host(stats)) if stats else None
        if self.last_routing:
            self._g_r_drop.set(self.last_routing["dropped_frac"])
            self._g_r_ent.set(self.last_routing["entropy"])
            self._g_r_imb.set(self.last_routing["imbalance"])

    def _sample(self, logits, gen):
        ec = self.ec
        return sample(logits, gen, temperature=ec.temperature, top_k=ec.top_k, top_p=ec.top_p)

    @torch.no_grad()
    def _generate_batch(self, reqs: Sequence[Request], gen) -> List[Response]:
        ec, cfg = self.ec, self.cfg
        B = len(reqs)
        # right-align prompts so the last prefill position is each row's
        # final prompt token
        S = min(max(len(r.prompt) for r in reqs), ec.max_prefill)
        toks = np.full((B, S), ec.pad_id, np.int64)
        for i, r in enumerate(reqs):
            p = list(r.prompt)[-S:]
            toks[i, S - len(p):] = p

        caches = self._make_caches(B)
        tr, routing = self._tr, self.obs.routing
        t0 = time.perf_counter()
        if tr:
            tr.begin(("engine", 0), "prefill", ts=t0, args={"batch": B, "prompt_len": S})
        logits, caches = prefill(cfg, self.params, torch.from_numpy(toks).to(self.device), caches,
                                 memory=self.memory, prefix_embeds=self.prefix_embeds)
        cur = self._sample(logits, gen)

        max_new = min(max(r.max_new_tokens for r in reqs), ec.max_decode)
        generated = np.zeros((B, max_new), np.int64)
        done = np.zeros((B,), bool)
        step_s = []
        prefill_s = None
        t_prev = t0
        stats = None  # the last step's routing tree, copied once that step is done
        for t in range(max_new):
            # analysis: allow(host-asarray) — the sampled tokens, for the stop decisions
            generated[:, t] = cur.cpu().numpy()  # waits for the step in flight
            now = time.perf_counter()
            if t:
                step_s.append(now - t_prev)
                self._h_step.observe(now - t_prev)
            else:
                prefill_s = now - t0
                self._h_prefill.observe(prefill_s)
                if tr:
                    tr.end(("engine", 0), ts=now)
                    tr.begin(("engine", 0), "decode", ts=now, args={"batch": B})
            t_prev = now
            if stats is not None:
                self._routing(stats)
                stats = None
            self._c_decode_toks.inc(int((~done).sum()))
            done |= generated[:, t] == ec.eos_id
            last = t == max_new - 1
            if done.all() or (last and not routing):
                generated = generated[:, : t + 1]
                break
            out = decode_step(cfg, self.params, cur[:, None].long(), S + self._offset + t, caches,
                              memory=self.memory, return_routing=routing)
            logits, caches = out[:2]
            fresh = self.obs.watchdog.tick()
            if fresh:
                self._c_retraces.inc(fresh)
            if last:  # the last token's step, run for its routing only
                self._routing(out[2])
                break
            stats = out[2] if routing else None
            cur = self._sample(logits, gen)
        if tr:
            tr.end(("engine", 0))
        self._c_completed.inc(B)
        self.last_timings = {"prefill_s": prefill_s, "decode_step_s": step_s,
                             "batch": B, "prompt_len": S}

        res = []
        for i, r in enumerate(reqs):
            g = generated[i].tolist()
            if ec.eos_id >= 0 and ec.eos_id in g:
                g = g[: g.index(ec.eos_id)]
            res.append(Response(tokens=g[: r.max_new_tokens], prompt_len=len(r.prompt)))
        return res
