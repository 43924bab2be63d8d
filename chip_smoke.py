"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

  python3 chip_smoke.py

Phases, each printed on its own line; any failure raises and exits non-zero:

1. card: name and power limit (nvidia-smi); TF32 off for the f32 checks.
2. build: every kernel of the port, one nvcc per source, started together.
3. static serve: llama4-maverick-400b-a17b at full width (d_model 5120, 128
   experts of d_ff 8192, vocab 202048), depth cut to one repeat of its
   (dense, MoE) pattern, bf16 random weights drawn on the card from a seed,
   ``moe_impl="grouped"``.  The port's ``Engine`` serves 4 requests (prompt
   64, 16 new tokens, greedy); the kernels' launch counts are set to 0 just
   before and read just after.  A torch.profiler account of 5 decode steps
   (kernels' device time, host operators, launches, syncs, idle share).
   Then a small-input reference: reduced llama4 in f32 served on the card
   (kernels) and on the CPU (plain versions) from the same weights.
4. continuous serve: the same weights through ``ContinuousEngine`` (paged,
   page size 16, 8 slots, capacity 2048, prefill chunk 256, 344 pages: a
   third of the slots' worst case, see CONT), 12 greedy requests of 32 new
   tokens with prompts of 60-1777 tokens; counts set to 0 before, read
   after; TTFT per request, median decode tick, tokens/s, preemptions (at
   least one), pool drained.  A torch.profiler account of 5 decode ticks of
   8 decoding slots.
4b. prefix trace: the same weights and pool (CONT, ``prefix_sharing=True``),
   ``submit_n`` of 4 samples of a 700-token prompt, then 8 requests whose
   prompts share a 1024-token prefix (64 pages) and end in suffixes of
   40-400 tokens, 32 new tokens each, greedy; run under
   ``prefill_mode="chunked"``, under ``"batched"`` (kernel 8's batched
   entry, once per layer per tick that prefills; the single-row entry
   never), under ``"batched"`` over an int8 pool, then unshared (chunked):
   prefix hits, hit tokens, prefill tokens computed and skipped, CoW copies
   (both above 0 when shared), TTFT per request, tok/s, decode-tick median,
   launches (set to 0 before, read after, each against its expected
   count); pool and index drained.  Each request's first-token logits of
   the shared bf16 runs within BF16_LOGITS_TOL of the unshared run's.
4c. contiguous engine: ``ContinuousEngine(paged=False, slots=8,
   capacity=2048)`` on the phase-4 trace, bf16 and an int8 cache: kernel 6
   once per layer per admission, kernel 9 (int8) once per layer per decode
   tick, no paged kernel; TTFT, tick median, tok/s.
4d. observability (slice 13): the phase-4 trace (weights, pool, prompts)
   through a fresh ``ContinuousEngine`` six times, in turns under
   ``Obs.disabled()``, the default ``Obs()``, ``Obs(trace=True,
   routing=True)``, full, default, disabled (kernels 4, 7, 8): the tokens
   and every kernel's launches identical across the six and equal to phase
   4's; the steady decode-tick median of each run; TTFT / TPOT / queue-wait
   / tick p50 and p99 from the snapshots, the trace's event count, the
   routing gauges; the default and full snapshots appended to
   ``chiprun_out/obs_metrics.jsonl`` and the first full run's trace written
   to ``chiprun_out/obs_trace.json``; a torch.profiler account of 5 steady
   decode ticks under off, default and full: the default's host syncs per
   tick equal the disabled one's, routing adds at most one.  Phase 11 adds
   ``Engine`` under ``Obs(routing=True)`` on nlg-350m-moe128 (kernels 1, 6):
   ``last_routing``'s MoE layers, dropped share and imbalance.
5. chunked prefill at full width: a 512-token prompt through two 256-token
   ``paged_prefill_chunk`` calls (kernel 8) against the static prefill of the
   same prompt, both bf16: logits within BF16_LOGITS_TOL, same argmax.
6. reduced f32 continuous, card vs CPU: the same trace through the engine on
   the card (kernels) and on the CPU (plain versions), from the same weights,
   with a pool small enough to preempt: identical tokens and preemption
   count, last tick's logits within 1e-5 relative.
6c. the same card against CPU for prefix sharing under the chunked, batched
   and scatter modes with ``submit_n``, the contiguous engine (fp and int8
   cache), and the batched tick under llama4's own capacity dispatch:
   identical tokens, preemptions, prefix hits, CoW copies, drained pools.
6d. speculative decoding: the phase-4 weights, pool and trace with the
   target as its own drafter (``spec_draft=(cfg, params)``, k = 4; the
   drafter's only memory is its contiguous cache) over a bf16 and an int8
   pool, each after the non-speculative run of the same trace: windows,
   drafted, accepted, emitted, the accept share, the median tick split into
   plan, draft, verify and commit, tok/s against the baseline's, TTFT,
   preemptions, CoW copies, the share of requests whose tokens equal the
   baseline's, and launches against their counts (kernel 7 never; the
   batched kernel 8 / 8q once per layer per verify tick; kernel 4 per MoE
   call of target and drafter; kernel 6 once per drafter layer per sync);
   pools drained.  Then reduced f32 card vs CPU (llama4 grouped with a
   seed-1 drafter, prefix sharing and ``submit_n``, and over an int8 pool;
   llama4 under its own capacity dispatch with itself as the drafter;
   glm4-9b with a seed-1 drafter under batched prefill; pools that
   preempt): identical tokens, per-tick spec records, preemptions and CoW
   copies.
7. quantized serving (MoQ): the bf16 tree's experts quantized to int8 on the
   card (``quantize_params``, one expert matrix at a time; every other
   tensor shared), then (a) ``Engine(kv_cache_bits=8)`` on the same 4
   requests, launch counts set to 0 before and read after (kernel 5 once per
   MoE call, kernel 9 once per layer and decode step, no fp kernel), expert
   and KV-cache bytes beside bf16's, a profile of 5 decode steps naming the
   quantize-on-write operators; (b) the continuous trace through
   ``ContinuousEngine(kv_cache_bits=8)`` (kernels 5, 7q, 8q; the same
   preemption count as the bf16 run, pool drained); (c) reduced f32 llama4
   card vs CPU with int8 and int4 experts and an int8 KV cache (static
   logits and tokens; the continuous trace's tokens and preemptions), and
   policy ``all`` through ``Engine``.
8. kernels: each kernel against its plain PyTorch version on the same inputs
   at the served path's shapes, in bf16 and f32 (the grouped MLP, kernels 4
   and 5, per token row: the served MoE layer at T = 256, 4 and the
   continuous engine's 8 slots (4 also at 40 tokens, the speculative
   verify pass's 8 x 5), bf16, int8 and int4 weights, and for 5 at a
   16384-token prefill (kernel 4 there on the long prefill's own MoE inputs,
   phase 6b); at kimi-k2-1t-a32b's expert width, D 7168, F 2048, top-8 over
   32 random experts, T = 64; on tile -> expert maps cycling over three
   experts, with more runs than the tensor-core kernel's grid has rows; and
   at reduced size in f32 and in bf16 (bf16, int8 and int4 weights), which
   take the CUDA-core variant; each check asserts the variant it took, and
   every served bf16 call of 4 and 5 must have taken the tensor-core
   variant, counted per run; paged decode: B = 8 slots with the
   table, positions and pool of the continuous serve mid-run, fp and int8;
   paged prefill: 256 query chunks
   over 0 and 1008 tokens of pool history, fp and int8; int8 decode: the
   served static cache, 4 rows x 80 slots, and 8 rows x 2048 slots half
   filled, and in bf16 a cache of 4 x 2112 slots with 80 filled, a
   16392-slot cache with 8 keys filled, a ring whose live slots wrap under
   a window, glm4-9b's and nlg-350m-moe128's heads), and once more at a reduced size with a window and a softcap
   (with a row that has no valid key, which must give 0); kernels 7, 7q, 8
   and 8q also in bf16 over 8 slots of about 1800 tokens (one all-trash row,
   one row of a single key), a chunk of 256 and of 40 queries over 1777
   tokens of history, with glm4-9b's heads (G = 16, dh = 128) and
   nlg-350m-moe128's (G = 1, dh = 64) at small sizes, and over tables of 800
   and 1400 entries (several compaction windows); the batched kernel 8 /
   8q at 8 rows of 256-query chunks over 0, 256, 1008 and 1777 tokens of
   history, one row inactive and one of 40 queries and padding (exactly 0),
   timed beside SDPA over the gathered rows and the same rows as 8
   single-row launches, and at reduced heads with a window and a softcap in
   bf16 and f32; the batched kernel 8 / 8q at the verify pass's C = 5 over
   8 rows of the trace's histories (timed the same way), and at glm4-9b's,
   nlg-350m-moe128's and the reduced heads; kernel 9 at the contiguous engine's served shape (layer
   0's int8 cache of 8 x 2048 slots mid-run, rows at their own positions,
   the idle ones at 0; and 7 rows at the trace's positions beside one
   inactive row).  The attention kernels
   are held per query row (a row with no valid key must be exactly 0).  Then
   each is timed beside its bound and, for attention, beside
   scaled_dot_product_attention: kernels 4, 5, the attention kernels and
   SDPA from CUDA graphs, beside CUDA events and (4, 5) the wrapper's host
   time.
9. capacity dispatch: the same weights under llama4's own ``moe_impl``
   ("ep", which without a mesh is the dense mapping table; kernels 1 and 2
   in place of 4): (a) ``Engine`` on the same 4 requests, counts set to 0
   before and read after (kernels 1 and 2 once per MoE call, 4 and 5 not
   at all), the share of assignments kernel 1 drops at the 256-token
   prefill, a profile of 5 decode steps; (b) ``moe_layer`` dense against
   grouped on the served layer at T = 4 (same expert ids, outputs within
   BF16_TOL); (c) the continuous trace (the bf16 run's preemptions, pool
   drained); (d) int8 experts and an int8 KV cache through ``Engine``
   (kernels 1, 3 and 9; every call of kernel 3 on the tensor-core kernel,
   prefill and decode-step ms and the tokens printed); every served call of
   kernel 1 must have taken its one-launch path; (e) reduced f32 card vs
   CPU under ``dense``,
   ``einsum``, capacity factor 0.25 (the prefill drops, counted), int8 and
   int4 experts, and the continuous trace.
10. kernels 1, 2 and 3 against their plain versions: gating on the served
   router's logits at T = 4, 8 and 256, on f32 logits at kimi-k2's width (E
   384, K 8), with rows of equal logits, with logits biased past a
   capacity, and at 13926 tokens, past the one-launch slot bound (integer
   outputs identical; the path each took asserted), and its one-launch
   path from two streams and two CUDA graphs at once; the expert MLPs per
   token row on the served layer at T = 256, 4 and 8 (bf16, fp and int8;
   int8 on the tensor-core kernel, also against its order's plain
   version), int8 at a 13926-token prefill (C = 136, which the TPU
   kernel's grid would refuse) and at reduced size in f32 and bf16 (the
   CUDA-core kernel); each timed beside its bound from a CUDA graph of its
   calls, beside CUDA events and the wrapper's host time.
11. nlg-350m-moe128, the paper's model, at its published size and full
   depth (24 layers, 128 GELU experts on every other layer, 13.1 G
   parameters in bf16) once the llama4 trees are deleted: ``Engine`` with
   its own ``moe_impl="dense"`` on 4 requests (kernel 1 once per MoE layer
   call; GELU experts are plain products, so no expert kernel), and a
   profile of 5 decode steps; then the same tree and requests under
   ``moe_impl="grouped"`` (kernel 1 never; GELU experts over the grouped
   layout are plain products over each tile's gathered weights, in blocks
   under 1 GB), a profile of 5 decode steps, and the reduced f32 model
   under grouped, card against CPU.
11b. the paper's pairing, speculative, at published sizes: nlg-350m (dense,
   bf16) drafting for nlg-350m-moe128 through the paged engine (8 slots,
   pages of 16, 8 requests of 32 new tokens with prompts of 64-512 tokens,
   k = 4) beside the non-speculative run, reported as in 6d.
12. glm4-9b, a dense global arch, at its published size once nlg's tree is
   freed (40 layers, 32 query heads over 2 kv-heads, 9.4 G parameters in
   bf16): ``Engine`` on 4 requests (kernel 6 once per layer at the prefill,
   no MoE kernel), a profile of 5 decode steps, and reduced f32 glm4-9b
   card vs CPU.
13. kernel 6 against its plain version at the static serves' shapes
   (llama4, nlg-350m-moe128 and glm4-9b: 4 x 64 tokens, bf16), at a reduced
   size in f32 and bf16 with offset positions, empty slots, a window, a
   softcap and a row with no valid key (which must give 0), the same masks
   at each bf16 head-dim instance (dh 64 and 128 on wgmma with 128- and
   64-row query tiles, each case's tile height asserted, 32 and 112 on
   mma.sync) and at 4500 tokens on wgmma, nlg-350m-moe128's heads over
   a 4096-token causal prompt, and in the TPU kernel's index form at S != T,
   causal; the served shapes and the long prompts timed beside their bounds
   and beside scaled_dot_product_attention.
14. slice 8, once glm4's tree is freed: gemma3-27b (d_model 5376, 32 heads
   over 16 kv-heads, dh 128, vocab 262144, qk-norm; depth cut to one period
   of its 5 local : 1 global pattern plus the 2-layer local tail, 8 of 62
   layers), recurrentgemma-2b (26 layers: RG-LRU and sliding-window
   attention of dh 256) and mamba2-370m (48 Mamba-2 SSD layers), each at
   its published widths, one tree at a time: ``Engine`` on 4 prompts of
   1500 tokens (past gemma3's window of 1024), bf16 and int8 KV (kernel 6
   once per attention layer, the local ones with their window; kernel 9
   once per attention layer and decode step over the int8 caches, rings
   included); a profile of 5 static decode steps; the paged engine on the
   phase-4 trace (gemma3 chunked and batched over bf16 and int8 pools;
   recurrentgemma with a 2500-token prompt, so a ring of 2048 wraps inside
   a prefill, over bf16 and int8 rings; mamba2): global layers on kernels 7
   / 8 / batched 8, rings on kernel 9 over int8, SSD and LRU layers on no
   kernel, launches counted against that; gemma3's prefix trace shared and
   unshared (the shared prefix is recomputed: the same prefill tokens);
   recurrentgemma's and mamba2's prefill launches at 250 and 2500 tokens
   (no loop over tokens); the reduced f32 models card vs CPU (static, paged
   with preemption, the batched tick with sharing and forks, scatter,
   int8 rings, the contiguous engine).  Slice 9: gemma3 (over bf16 and
   int8 pools) and recurrentgemma drafting for themselves at k = 4 on the
   same paged trace beside the plain run, reported as in 6d (the commit time
   now includes the committed recurrent-state pass, which launches the
   batched kernel 8 once per global layer per verify tick, as the verify
   does; resyncs); then reduced f32 card vs CPU for recurrentgemma with a
   seed-1 recurrentgemma drafter (resyncs) and gemma3 drafting for glm4-9b
   (cross family), over pools that preempt.  Then kernel 6 with a window at
   gemma3's local shape (4 x 2048 and 1 x 8192 tokens) and at dh 256
   (recurrentgemma's 10 heads over 1, window 2048: 1 x 4096 tokens and the
   served 4 x 1500, each bit for bit over two launches; and with every mask
   in f32 and bf16), and kernel 9 over wrapped int8 rings at dh
   128 and 256, each against its plain version, timed beside its bound and
   SDPA with the window-causal mask.
15. slice 9, once slice 8's trees are freed: seamless-m4t-medium (12
   encoder + 12 decoder layers, d_model 1024, 16 heads over 16, vocab
   256206, 0.88 G parameters) at its published size: ``encode`` of 4 stub
   sources of 1024 frames (kernel 6 once per encoder layer, non-causal),
   then ``Engine(memory=...)`` on 4 prompts of 64 tokens for 16 (per
   prefill kernel 6 once per decoder layer, causal, and once per cross
   attention, non-causal, 64 queries over 1024 keys; decode reads the cross
   caches through ``_sdpa``); internvl2-1b (24 layers, 14 heads over 2: G =
   7) at its published size through ``Engine(prefix_embeds=...)``, 256 stub
   patches + 64 prompt tokens (kernel 6 once per layer, S = 320); each
   kernel-6 call recorded by (causal, S, T, G) and held against those
   counts; a profile of 5 decode steps each; the reduced f32 models card vs
   CPU (memory, logits, tokens).  Then kernel 6 against its plain version in
   bf16 and f32 at those shapes (non-causal 4 x 1024 at G = 1; non-causal
   64 queries at position 0 over 1024 keys; causal 4 x 320 at G = 7), timed
   beside its bound and SDPA, and non-causal with empty keys (a row with no
   valid key gives 0).
17. slice 10 (runs after 15, once slice 9's trees are freed; its lines
   come before 16's): (a) kernel 6b (flash attention backward) and kernel
   1b (capacity gating backward) against their plain versions, per row, in
   bf16 and f32, at ``launch/training_kernels.py``'s cases (nlg-350m-prmoe's
   8 x 512 training shape, G = 4 at dh 128, a window, a softcap,
   non-causal, dh 256 / 32 / 112; gating at T = 4096 over 32 and 64
   experts, top-1, and top-2 with drops), timed from CUDA graphs beside
   their bounds and the SDPA backward, with kernel 6's forward with and
   without its L output; 6b (bf16 on the tensor cores) also
   bit for bit over two launches, its blocks per pass beside the SM count; (b) nlg-350m-prmoe-32-64 at its published size
   (4.11 G parameters, bf16, ``moe_impl="dense"``) trained 8 AdamW steps
   of 8 x 512 Markov tokens: loss, ce, aux and grad norm per step, median
   step ms, tokens/s, AdamW ms, peak memory, launches of 6 / 6b / 1 / 1b
   against their counts (24 / 24 / 12 / 12 a step, nothing else), the last
   loss below the first, a profile of one step; (c) the MoS student
   nlg-350m-prmoe-mos (21 layers) distilled from it for 6 steps with
   ``kd_stop_step`` 3 (α 1 then 0); (d) the student saved with the port's
   checkpoint ``save``, loaded with ``load_checkpoint`` and served, 4
   requests x 16 tokens through ``Engine``: the same tokens as the
   in-memory tree; (e) reduced f32 card vs CPU: first-step gradients, 3
   train steps under einsum and dense, 2 distill steps; (f) a grad-enabled
   forward of reduced llama4 under ``grouped`` with int8 experts raises
   before kernel 5 launches (MoQ weights are post-training: no backward).
   Slice 14 (phase 17 too): (a) also kernels 2b and 4b (the SwiGLU expert
   MLP's backward over the capacity and the grouped buffer) against their
   plain versions per row of dx, dwi, dwg and dwo, bf16 and f32, at
   llama4-maverick's width (16 experts, top-1, T = 2048: C = 160), kimi-k2's
   (32 experts, top-8, T = 1024), a capacity buffer with an empty expert,
   a grouped one with trailing dead tiles holding garbage and a grouped one
   at D 384, F 640 (pass C's ragged last 256-column tile); bf16 through
   the wgmma passes (``variant_launches``); dead rows and empty
   experts exactly 0, bit for bit over two launches, timed beside their
   bounds, the plain versions and a cuBLAS composite; and kernel 6b at
   llama4's G = 5 (40 heads over 8, dh 128, 4 x 512); (g) llama4-maverick at
   its published widths cut to 2 layers and 16 of 128 experts (4.59 G
   parameters, bf16) trained 4 AdamW steps of 4 x 512 Markov tokens under
   its own ``moe_impl="ep"`` (kernels 1, 1b, 2, 2b, 6, 6b) and 4 under
   ``"grouped"`` (4, 4b, 6, 6b): the peak reckoned first, losses, ce, aux
   and grad norm per step (finite), median step ms, tokens/s, AdamW ms,
   peak memory, launches against their counts (2 / 2b or 4 / 4b once per
   MoE layer a step), a profile of one step each; (h) reduced f32
   llama4-maverick (``ep`` and ``grouped``) and kimi-k2 (``ep``, top-2)
   card vs CPU: first-step gradients, 3 train steps.
18. expert-parallel serving (slice 15; ``scripts/ep_phase.py``, which also
   runs it alone): llama4-maverick at its published widths, one (dense,
   MoE) repeat, 32 experts, on 4 ranks (one GPU each over NCCL where 4 are
   visible, else four processes time-sharing ``cuda:0`` over gloo, which
   measures correctness, not EP speed): ``Engine`` under ``ep_grouped`` on
   (4,) and ``ep_serve`` on (2, 2) (the a2a prefill over the two hops),
   ``ContinuousEngine`` under ``ep_grouped`` on (4,), paged and (slice 18)
   contiguous with int8 caches; the slots laid out as JAX's ``place_caches``
   lays them out (each rank runs attention, the dense layers and the logits
   on its rows and holds only their caches; the pool replicated); every
   rank's tokens and launches of kernels 1, 2, 4, 6, 7, 8 and 9 (equal to
   the one-device run's), the rows kernels 7 and 9 saw per launch (a
   quarter of one device's), each rank's per-slot cache bytes (a quarter of
   one device's) and pool bytes (all of them), the MoE layer's output
   against one device at the served inputs, each rank's kernels 1, 2 and 4
   against their plain versions at the EP shapes and 7 and 9 at its row
   count, reduced f32 card vs CPU under EP, a one-rank NCCL group driving
   every schedule on device tensors, per-rank bytes and the host-staged
   bytes and collectives a step.
19. expert-parallel training (slice 16; ``scripts/ep_train_phase.py``, which
   also runs it alone): llama4-maverick at its published widths, one (dense,
   MoE) repeat, 8 experts, on 2 ranks over ``data``, and
   nlg-350m-prmoe-32-64 at its published size on (2, 2) over (``data``,
   ``model``), one GPU a rank over NCCL where enough are visible, else
   time-sharing ``cuda:0`` over gloo (correctness, not EP speed): AdamW
   steps with ZeRO-1 at a headroom capacity factor against a one-device run
   of the same weights (losses, grad norms, three leaves' digests and their
   updates; PR-MoE recomputing every layer in the backward) and at the
   published 1.25 (the per-shard dropped share; PR-MoE one step there);
   every rank's launches
   of 1, 1b, 2, 2b, 6 and 6b against the one-device counts; each llama4
   rank's 1 / 1b / 2 / 2b against their plain versions at the EP shapes (2
   / 2b at d_ff 8192 and the 4096 slice); reduced f32 card vs CPU under EP;
   per-rank bytes, peak memory, staged bytes; the phase's wall time.
Slice 17 (the analysis and dry-run tooling, ``repro_torch.analysis`` and
``launch/{op_account,roofline,dryrun}.py``) checks inside the phases that
hold the trees, each raising on failure: phase 3 locates the host syncs of
its 5 profiled decode steps and of one ``generate`` (``sync sites:``
lines: every sync the profiler counts at a ``src/repro_torch`` line that is
a lint finding), prints one decode step's ``roofline:`` (the op capture's
kernel entries equal to the launch counters of the same step, its bound
beside the profiled device ms and the unprofiled wall ms), audits its graph
(no collective, no dtype drift) and holds the dry run's parameter bytes
within 1% of what the tree took; phase 4 the same syncs and roofline for a
tick; phase 6b the roofline of the 16384-token prefill; phase 7 the int8
decode step's dtype drift; phase 9 the capacity prefill's padded share
against kernel 1's keep; phase 17g a llama4 step's syncs, roofline and
in-place audit of its parameters and moments (its reckoned peak now the
dry run's bytes); phase 18 each rank's decode steps held to their
schedule's collectives; and 20, the dry-run table on meta
(``chiprun_out/dryrun.json``).

16. each phase's wall time on a line of its own ("phase time:"), the
   script's own time ("script time:", from ``main``'s start, the
   build included), a ``{"kernels": [...]}`` line (with
   ``flash_attention_window``,
   ``flash_attention_dh256``, ``decode_attention_quant_ring``,
   ``flash_attention_noncausal``, ``flash_attention_g7`` and, from phase
   17, ``flash_attention_backward``, ``moe_gating_backward``,
   ``expert_mlp_backward`` and ``grouped_mlp_backward``), the training
   summary lines, the nvidia-smi line, and last the ``{"ok": true,
   "device": ...}`` line.

Every static prefill and forward (phases 3, 5, 6b, 7, 9, 11, 12, 14, 15,
17 and the reduced references) and every encoder layer attends through kernel
6 (flash attention), once per layer call (a training step's backward
through kernel 6b, once per layer) (a cross attention's prefill
too), and so does every admission of the contiguous engine (4c); the
paged continuous phases prefill through kernel 8 (4b's batched runs through
its batched entry) and launch kernel 6 never, but for the speculative
drafter's syncs (6d, 11b: once per drafter layer per sync).  Phase 6b, between 6 and 7 while the card holds only the bf16 tree:
a long static prefill at full width, ``Engine(max_batch=1,
max_prefill=16384, max_decode=8)`` on one 16384-token prompt (kernel 6
twice, kernel 4 once per MoE call, the first time past T = 256), where the
plain path's f32 logits alone would take 42.9 GB per layer call; then
kernel 6 against its plain version (chunked, on the card) on layer 0's q,
k and v of that prompt, and kernel 4 on its MoE layer's inputs.

It imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import contextlib
import copy
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ARCH = "llama4-maverick-400b-a17b"
BATCH, PROMPT, NEW = 4, 64, 16
SEED = 0
# continuous serve: 12 requests, prompts mostly not page-aligned.  Admission
# reserves a request's prompt pages up front (by free-block count), so only
# decode growth can run the pool dry: on this trace a pool of 512 pages (half
# the slots' worst case of 8 x 128) keeps at least 114 pages free and never
# preempts.  The scheduler is deterministic in the prompt lengths (no EOS),
# and 336-352 pages preempt; 344 pages (a third of the worst case) preempt
# twice.
CONT = dict(slots=8, capacity=2048, page_size=16, n_pages=344, prefill_chunk=256)
CONT_PROMPTS = [1500, 1200, 900, 700, 512, 300, 200, 100, 1000, 60, 333, 1777]
CONT_NEW = 32
PROFILE_PROMPT = 512  # the decode-tick profile: 8 slots at 512-560 tokens of context
# the long static prefill (phase 6b): one prompt past anything the plain
# path could attend over at full width
LONG_PROMPT, LONG_NEW = 16384, 8
NLG_LONG = 4096  # kernel 6 at nlg-350m-moe128's heads (dh 64) past the served prompt

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# bf16 kernel checks: kernel and plain version read the same bf16 values and
# sum in f32 in different orders (the tensor-core attention kernels also
# round P to bf16 before P.V, 2^-9 of each term), so outputs may round to
# neighbouring bf16 values: one ulp is 2^-7 of the output's magnitude at
# most; allow two, relative to the largest output and, for attention, to
# each query row's own largest (compare_rows).  f32: only the summation
# order differs.
BF16_TOL = 2e-2
F32_TOL = 1e-5
# full-width logits, static prefill vs chunked paged prefill, both bf16: the
# two paths round attention differently (kernels 6 and 8 round P to bf16
# against running maxima over different key tiles) and cuBLAS sums the dense
# products of 512 and of 256 rows in different orders; each rounding is up
# to 2^-8 relative and a few compound over two layers: allow 3% of the
# largest logit (a reduced bf16 model on the CPU differs by 0.8%).
BF16_LOGITS_TOL = 3e-2


def log(*a):
    print(*a, flush=True)


class PhaseClock:
    """Each phase's wall time, logged on a line of its own ("phase time:")
    when the next phase starts (``mark``) or the script ends (``mark(None)``)."""

    def __init__(self, t0: float):
        self.t, self.label = t0, "1-2 card and build"

    def mark(self, label) -> None:
        now = time.perf_counter()
        log(f"phase time: {self.label}: {now - self.t:.1f} s")
        self.t, self.label = now, label


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, n=10, reps=5, warmup=3) -> float:
    """Device time of one call of ``fn``, CUDA events: ``n`` calls issued back
    to back between two events, so the card never waits for the host's
    per-call work; the median over ``reps`` such windows, divided by ``n``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def graph_ms(fn, n=20, reps=5) -> float:
    """Device time of one call of ``fn`` without the host's per-call work:
    ``n`` calls captured into one CUDA graph, the graph replayed between two
    CUDA events; the median over ``reps`` replays, divided by ``n``.  For a
    kernel whose device time is below its wrapper's host time, where
    ``time_ms`` reads the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the default stream, as capture asks
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    del graph
    return statistics.median(times)


# the per-variant launches of kernels 4, 5 and 3 (tensor-core "mma", CUDA-core
# "fma"), of the backwards 2b and 4b ("wgmma", "fma") and of kernel 1 (one
# launch, or two) in each served run, by the run's name (``read``)
VARIANTS_SEEN = {}


def variant_counters():
    from repro_torch.kernels import expert_mlp_grouped as gk
    from repro_torch.kernels import expert_mlp_quant as k3
    from repro_torch.kernels import moe_gating as k1

    return gk.variant_launches, k3.variant_launches, k1.variant_launches


def reset(*counters):
    """Zero every launch count, and the per-variant ones."""
    for c in (*counters, *variant_counters()):
        for k in c:
            c[k] = 0


def read(counters, path) -> dict:
    """Every kernel's launches since the last ``reset``.  Each caller is a
    served or trained run at full width in bf16, so every call of kernels 4,
    5 and 3 must have taken the tensor-core variant, every call of the
    backwards 2b and 4b the wgmma passes, and every call of kernel 1 its
    one-launch path (the served T*K are within its slot bound): their
    per-variant counts are checked against the launches and kept in
    VARIANTS_SEEN[path]."""
    got = {k: v for c in counters for k, v in c.items()}
    v = VARIANTS_SEEN[path] = {k: n for c in variant_counters() for k, n in c.items()}
    for name, fast in (("grouped_mlp", "mma"), ("grouped_mlp_quant", "mma"),
                       ("expert_mlp_quant", "mma"), ("grouped_mlp_backward", "wgmma"),
                       ("expert_mlp_backward", "wgmma")):
        if v[f"{name}_{fast}"] != got[name] or v[f"{name}_fma"]:
            raise AssertionError(f"{path}: {name} launched {got[name]} times, variants {v}: a "
                                 f"served bf16 call left the tensor-core kernel")
    if v["moe_gating_one_launch"] != got["moe_gating"] or v["moe_gating_two_launches"]:
        raise AssertionError(f"{path}: moe_gating called {got['moe_gating']} times, variants {v}: "
                             f"a served call took two launches")
    return got


def compare(name, out, plain, tol) -> dict:
    """max|out - plain| relative to max|plain|, which must be within tol."""
    assert out.shape == plain.shape and torch.isfinite(out.float()).all(), name
    err = (out.float() - plain.float()).abs().max().item()
    scale = plain.float().abs().max().item()
    rel = err / max(scale, 1e-30)
    if rel > tol:
        raise AssertionError(f"{name} disagrees with its plain version: max|d|={err:.3e}, "
                             f"max|plain|={scale:.3e}, rel {rel:.3e} > {tol}")
    return {"max_abs_err": err, "max_rel_err": rel}


def compare_rows(name, out, plain, tol) -> dict:
    """``compare``, and per row of the last axis (one query of one head in
    attention): max|out - plain| over the row relative to the row's own
    max|plain|, which must be within tol for every row.  A row that attends
    over n random keys is about sqrt(e / n) of one value's size, so past a
    few thousand keys it is far below the largest output, and a check
    against that largest output alone would pass a kernel that zeroed it."""
    res = compare(name, out, plain, tol)
    o, p = out.float().flatten(0, -2), plain.float().flatten(0, -2)
    rel = (o - p).abs().amax(-1) / p.abs().amax(-1).clamp_min(1e-30)
    worst = int(rel.argmax().item())
    res["max_row_rel_err"] = rel[worst].item()
    res["median_row_rel_err"] = rel.median().item()
    res["worst_row"] = []
    for n in reversed(out.shape[:-1]):
        worst, i = divmod(worst, n)
        res["worst_row"].insert(0, i)
    if res["max_row_rel_err"] > tol:
        raise AssertionError(f"{name} disagrees with its plain version in row {res['worst_row']}: "
                             f"max|d| {res['max_row_rel_err']:.3e} of the row's max|plain| > {tol}")
    return res


def bound(need_bytes, ops, dtype) -> dict:
    b, o = need_bytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return {"bound_ms": max(b, o) * 1e3, "bound_by": "bytes" if b >= o else "operations",
            "bytes": need_bytes, "ops": ops}


# ---------------------------------------------------------------------------
# Grouped expert MLP (kernel 4)
# ---------------------------------------------------------------------------


def quant_experts(params) -> bool:
    """Whether the served MoE layer's experts are quantized."""
    from repro_torch.quant.qarrays import QuantizedArray

    return isinstance(params["segments"]["seg0"]["pos1"]["moe"]["wi"], QuantizedArray)


def grouped_case(moe, T, K, gen, dtype):
    """Inputs of the grouped MLP as the MoE layer builds them: T random
    tokens routed by the layer's router, sorted into the tile-padded buffer.
    ``moe``'s experts may be quantized (kernel 5)."""
    from repro_torch.core.dispatch_grouped import grouped_layout
    from repro_torch.core.gating import top_k_gating
    from repro_torch.launch.expert_kernels import grouped_bound

    E, D, F = moe["wi"].shape
    x = torch.randn((T, D), generator=gen, device="cuda").to(dtype)
    g = top_k_gating(x.float() @ moe["router"], K, T * K)
    lay = grouped_layout(g, E)
    Ct = lay.tile_expert.shape[0] * 8
    xg = torch.zeros((Ct, D), dtype=dtype, device="cuda")
    xg[lay.dst] = x[torch.arange(T * K, device="cuda") // K]
    info = {"T": T, "K": K, **grouped_bound(moe, xg, lay.tile_expert, lay.rows_used, T * K)}
    args = (xg, lay.tile_expert, moe["wi"], moe["wg"], moe["wo"], lay.rows_used)
    return args, info


def check_grouped(args, tol, variant, quant=False, timed=False, n=20):
    """Kernel 4 (or 5) against its plain version, per token row
    (``compare_rows``: a dead or padding row must come out 0 as the plain
    version's), and the variant it took, which must be ``variant`` ("mma"
    at the served widths in bf16, "fma" in f32 and at widths the
    tensor-core kernel does not take); timed: ``ms`` its device time from a
    CUDA graph of ``n`` calls, ``events_ms`` CUDA events around calls issued
    back to back, ``host_ms`` one wrapper call on the host's clock."""
    from repro_torch.kernels import expert_mlp_grouped as gk
    from repro_torch.launch.attention_kernels import host_ms

    kernel, plain_fn = ((gk.grouped_mlp_quant, gk.grouped_mlp_quant_plain) if quant
                        else (gk.grouped_mlp, gk.grouped_mlp_plain))
    before = dict(gk.variant_launches)
    out = kernel(*args)
    torch.cuda.synchronize()
    took = [k.rsplit("_", 1)[1] for k, v in gk.variant_launches.items() if v != before[k]]
    if took != [variant]:
        raise AssertionError(f"{kernel.__name__}: took the {took} kernel, expected {variant}")
    t0 = time.perf_counter()
    plain = plain_fn(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    res = {**compare_rows(kernel.__name__, out, plain, tol), "plain_ms": plain_ms,
           "variant": variant}
    del out, plain
    if timed:
        fn = lambda: kernel(*args)
        res["ms"] = graph_ms(fn, n=n)
        res["events_ms"] = time_ms(fn, n=min(10, n), warmup=1)
        res["host_ms"] = host_ms(fn, n=n)
    return res


def cycled_checks(moe, gen, quant) -> dict:
    """Kernel 4 / 5 at the served width on tile -> expert maps no dispatch
    makes, cycling over experts 0, 1, 2 so every tile is its own run: 400
    tiles all live (runs of 8: 400 runs on the grid's 178 rows) and 112
    tiles with 20 live (the decode buffer's plan, 7 rows, split down pass: the
    runs past the grid's first pass summed whole); each per row against its
    plain version."""
    out = {}
    D = moe["wi"].shape[1]
    for nt, live in ((400, 400), (112, 20)):
        xg = torch.randn((nt * 8, D), generator=gen, device="cuda").to(torch.bfloat16)
        te = (torch.arange(nt, device="cuda") % 3).to(torch.int32)
        used = torch.tensor([live * 8], dtype=torch.int32, device="cuda")
        out[f"cycled_{nt}_tiles_{live}_live"] = check_grouped(
            (xg, te, moe["wi"], moe["wg"], moe["wo"], used), BF16_TOL, "mma", quant=quant)
        del xg
    return out


def reduced_bf16_checks(rmoe) -> dict:
    """Kernels 4 and 5 in bf16 at the reduced width (D 128, F 64), which the
    tensor-core kernel does not take, so the CUDA-core kernels of
    ``grouped_mlp.cu``: the reduced layer's experts in bf16, and int8 and
    int4 of them, T = 64, per row against the plain versions, from a
    generator of their own: {label: check}."""
    from repro_torch.quant.qarrays import QuantizedArray

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    m = {n: rmoe[n].to(torch.bfloat16) for n in ("wi", "wg", "wo")}
    out = {}
    for bits in (0, 8, 4):
        w = m if not bits else {n: QuantizedArray.quantize(m[n], bits=bits) for n in m}
        kargs, info = grouped_case({**w, "router": rmoe["router"]}, 64, 1, gen, torch.bfloat16)
        info.update(check_grouped(kargs, BF16_TOL, "fma", quant=bits > 0))
        out[f"int{bits}_bf16_reduced" if bits else "bf16_reduced"] = info
    return out


def reduced_capacity_bf16_check(rmoe) -> dict:
    """Kernel 3 in bf16 at the reduced width (D 128, F 64), which the
    tensor-core kernel does not take, so the CUDA-core capacity kernel of
    ``grouped_mlp.cu``: int8 of the reduced layer's experts in bf16, T = 64,
    per row against both plain versions, from a generator of its own."""
    from repro_torch.quant.qarrays import QuantizedArray

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    q = {n: QuantizedArray.quantize(rmoe[n].to(torch.bfloat16), bits=8) for n in ("wi", "wg", "wo")}
    kargs, info = capacity_expert_case({**q, "router": rmoe["router"]}, 64, 1, gen, torch.bfloat16,
                                       2.0)
    info.update(check_capacity_experts(kargs, BF16_TOL, quant=True, variant="fma"))
    return info


def kimi_width_checks(gen) -> dict:
    """Kernels 4 and 5 at another expert width: kimi-k2-1t-a32b's d_model
    and expert d_ff, top-k and SwiGLU, over 32 of its 384 experts (random
    bf16 weights and router from the seed, 2.8 GB; int8 and int4 of the
    same), on 64 random tokens: {format: check}."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.modules import dense_init
    from repro_torch.quant.qarrays import QuantizedArray

    kcfg = get_config("kimi-k2-1t-a32b")
    spec = next(ls.ffn for ls in kcfg.layer_specs() if ls.ffn.kind == "moe")
    D, F, E = kcfg.d_model, spec.d_ff, 32
    wgen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    moe = {"wi": dense_init(wgen, D, F, torch.bfloat16, "cuda", lead=(E,)),
           "wg": dense_init(wgen, D, F, torch.bfloat16, "cuda", lead=(E,)),
           "wo": dense_init(wgen, F, D, torch.bfloat16, "cuda", lead=(E,)),
           "router": dense_init(wgen, D, E, torch.float32, "cuda")}
    out = {}
    for fmt, bits in (("bf16", 0), ("int8", 8), ("int4", 4)):
        m = moe if not bits else {**{n: QuantizedArray.quantize(moe[n], bits=bits)
                                     for n in ("wi", "wg", "wo")}, "router": moe["router"]}
        kargs, info = grouped_case(m, 64, spec.top_k, gen, torch.bfloat16)
        info.update({"E": E, "D": D, "F": F})
        info.update(check_grouped(kargs, BF16_TOL, "mma", quant=bits > 0, timed=True))
        out[fmt] = info
        del kargs, m
    return out


# ---------------------------------------------------------------------------
# Paged attention (kernels 7 and 8)
# ---------------------------------------------------------------------------


def key_bytes(k) -> int:
    """Bytes of one key (or value) and kv-head: dh values, plus one f32 scale
    in an int8 cache."""
    return k.shape[-1] + 4 if k.dtype == torch.int8 else k.shape[-1] * k.element_size()


def paged_bytes(k_pool, table, needed) -> int:
    """The pool bytes the function must read: the positions of every live
    (non-trash) table entry, and K and V only of the keys it attends to,
    ``needed`` [..., nt, ps] over the table's entries (each key once).  A
    fresh page of the chunk itself (pos -1) or a key past the query is
    read for its position only."""
    Pt, ps, Hkv, dh = k_pool.shape
    live = table != Pt - 1
    slots = table.long()[..., None] * ps + torch.arange(ps, device=table.device)
    keys = int(torch.unique(slots[needed & live[..., None]]).numel())
    return int(live.sum().item()) * ps * 4 + keys * 2 * Hkv * key_bytes(k_pool)


def decode_case(pool, table, qpos, G, dtype, gen):
    """Kernel 7's inputs: a pool (k, v, pos), a clamped table [B, nt] and
    query positions, with random queries; the bound counts the live entries'
    positions, the K/V of the keys at 0 <= pos <= qpos, q, out, table and
    qpos, and 4*H*dh operations per unmasked (query, key).  An int8 pool
    (kernel 7q) keeps its values; its scales go to ``info["kw"]``."""
    if "k_scale" in pool:
        k, v, kpos = pool["k"], pool["v"], pool["pos"]
    else:
        k, v, kpos = pool["k"].to(dtype), pool["v"].to(dtype), pool["pos"]
    Pt, ps, Hkv, dh = k.shape
    B = table.shape[0]
    q = torch.randn((B, Hkv, G, dh), generator=gen, device="cuda").to(dtype)
    kp = kpos[table.long()]  # [B, nt, ps]
    needed = (kp >= 0) & (kp <= qpos[:, None, None])
    pairs = int(needed.sum().item())
    b = q.element_size()
    need = paged_bytes(k, table, needed) + 2 * q.numel() * b + table.numel() * 4 + B * 4
    args = (q, k, v, kpos, table, qpos)
    info = {"B": B, "Hkv": Hkv, "G": G, "dh": dh, "ps": ps, "nt": table.shape[1],
            "live_entries": int((table != Pt - 1).sum().item()),
            "all_trash_rows": int((table == Pt - 1).all(1).sum().item()), "pairs": pairs,
            **bound(need, 4 * Hkv * G * dh * pairs, dtype)}
    if "k_scale" in pool:
        info["kw"] = dict(k_scale=pool["k_scale"], v_scale=pool["v_scale"])
    return args, info


def prefill_case(n_hist, C, Hkv, G, dh, ps, Pt, nt, dtype, gen, kv_int8=False):
    """Kernel 8's inputs: a random pool where a random set of pages holds
    positions 0 .. n_hist - 1, the table maps them and the chunk's fresh pages
    (pos -1) and is trash beyond; a chunk of C queries at n_hist .. + C - 1.
    The bound reads K/V only of the pool keys at 0 <= pos < qpos[0].
    ``kv_int8``: the pool is quantized (kernel 8q), its scales in
    ``info["kw"]``; the chunk's own K/V stay in ``dtype``."""
    k = torch.randn((Pt, ps, Hkv, dh), generator=gen, device="cuda").to(dtype)
    v = torch.randn((Pt, ps, Hkv, dh), generator=gen, device="cuda").to(dtype)
    kw = {}
    if kv_int8:
        from repro_torch.quant.kv import kv_quantize_values

        (k, ks), (v, vs) = kv_quantize_values(k), kv_quantize_values(v)
        kw = dict(k_scale=ks, v_scale=vs)
    kpos = torch.full((Pt, ps), -1, dtype=torch.int32, device="cuda")
    n_pages = -(-(n_hist + C) // ps)
    pages = torch.randperm(Pt - 1, generator=torch.Generator().manual_seed(SEED))[:n_pages].cuda()
    table = torch.full((nt,), Pt - 1, dtype=torch.int32, device="cuda")
    table[:n_pages] = pages.to(torch.int32)
    hist = torch.arange(n_hist, device="cuda")
    kpos[pages[hist // ps], hist % ps] = hist.to(torch.int32)
    qpos = torch.arange(n_hist, n_hist + C, dtype=torch.int32, device="cuda")
    q = torch.randn((C, Hkv, G, dh), generator=gen, device="cuda").to(dtype)
    ck = torch.randn((C, Hkv, dh), generator=gen, device="cuda").to(dtype)
    cv = torch.randn((C, Hkv, dh), generator=gen, device="cuda").to(dtype)
    pairs = C * n_hist + C * (C + 1) // 2
    b = q.element_size()
    kp = kpos[table.long()]  # [nt, ps]
    need = (paged_bytes(k, table, (kp >= 0) & (kp < qpos[0])) + (2 * q.numel() + 2 * ck.numel()) * b
            + nt * 4 + C * 4)
    args = (q, k, v, kpos, table, qpos, ck, cv)
    info = {"C": C, "history": n_hist, "Hkv": Hkv, "G": G, "dh": dh, "ps": ps, "nt": nt,
            "live_entries": n_pages, "pairs": pairs,
            **bound(need, 4 * Hkv * G * dh * pairs, dtype)}
    if kv_int8:
        info["kw"] = kw
    return args, info


def gathered(x, scale, idx, dtype):
    """x[idx], dequantized to ``dtype`` when ``scale`` is given (int8)."""
    return x[idx] if scale is None else (x[idx].float() * scale[idx]).to(dtype)


def sdpa_decode(q, k, v, kpos, table, qpos, scale, k_scale=None, v_scale=None):
    """The library yardstick: K/V gathered (and dequantized, for an int8
    pool) into a contiguous [B, Hkv, T, dh] beforehand, then one
    scaled_dot_product_attention with GQA and the same boolean mask."""
    import torch.nn.functional as F

    B, Hkv, G, dh = q.shape
    idx = table.long()

    def gather():
        kg = gathered(k, k_scale, idx, q.dtype).reshape(B, -1, Hkv, dh).transpose(1, 2).contiguous()
        vg = gathered(v, v_scale, idx, q.dtype).reshape(B, -1, Hkv, dh).transpose(1, 2).contiguous()
        return kg, vg

    kg, vg = gather()
    kp = kpos[idx].reshape(B, 1, 1, -1)
    mask = (kp >= 0) & (kp <= qpos.reshape(B, 1, 1, 1))
    qh = q.reshape(B, Hkv * G, 1, dh)
    call = lambda: F.scaled_dot_product_attention(qh, kg, vg, attn_mask=mask, scale=scale,
                                                  enable_gqa=True)
    return call, gather


def sdpa_prefill(q, k, v, kpos, table, qpos, ck, cv, scale, k_scale=None, v_scale=None):
    import torch.nn.functional as F

    C, Hkv, G, dh = q.shape
    idx = table.long()

    def gather():
        kg = torch.cat([gathered(k, k_scale, idx, q.dtype).reshape(-1, Hkv, dh), ck])
        vg = torch.cat([gathered(v, v_scale, idx, q.dtype).reshape(-1, Hkv, dh), cv])
        return kg.transpose(0, 1)[None].contiguous(), vg.transpose(0, 1)[None].contiguous()

    kg, vg = gather()
    hist = kpos[idx].reshape(-1)
    kp = torch.cat([torch.where(hist >= qpos[0], -1, hist), qpos])
    mask = ((kp[None, :] >= 0) & (kp[None, :] <= qpos[:, None]))[None, None]
    qh = q.permute(1, 2, 0, 3).reshape(1, Hkv * G, C, dh)
    call = lambda: F.scaled_dot_product_attention(qh, kg, vg, attn_mask=mask, scale=scale,
                                                  enable_gqa=True)
    return call, gather


def synthetic_pool(lens, Hkv, dh, ps, Pt, nt, gen, kv_int8=False):
    """A random pool holding one sequence of ``lens[b]`` tokens per slot b, on
    randomly drawn pages (positions 0 .. lens[b] - 1; the table trash past
    them, so a length 0 gives an all-trash row), the query at the last
    position: (pool dict as the engine's, clamped table [B, nt], qpos [B]),
    for ``decode_case``.  ``kv_int8``: K/V quantized as the cache writes
    them."""
    pool = {n: torch.randn((Pt, ps, Hkv, dh), generator=gen, device="cuda") for n in ("k", "v")}
    if kv_int8:
        from repro_torch.quant.kv import kv_quantize_values

        for n in ("k", "v"):
            pool[n], pool[f"{n}_scale"] = kv_quantize_values(pool[n].bfloat16())
    pool["pos"] = torch.full((Pt, ps), -1, dtype=torch.int32, device="cuda")
    table = torch.full((len(lens), nt), Pt - 1, dtype=torch.int32, device="cuda")
    perm = torch.randperm(Pt - 1, generator=torch.Generator().manual_seed(SEED)).cuda()
    used = 0
    for b, n in enumerate(lens):
        pages = perm[used:used + -(-n // ps)]
        used += pages.numel()
        table[b, :pages.numel()] = pages.to(torch.int32)
        hist = torch.arange(n, device="cuda")
        pool["pos"][pages[hist // ps], hist % ps] = hist.to(torch.int32)
    qpos = torch.tensor([max(n - 1, 0) for n in lens], dtype=torch.int32, device="cuda")
    return pool, table, qpos


def check_paged(name, kernel, plain, args, kw, tol, timed=False, library=None) -> dict:
    """The kernel against its plain version per query row (``compare_rows``;
    a row with no valid key must be exactly 0); ``timed``: the kernel's and
    SDPA's device time from a CUDA graph of their calls (``ms``,
    ``library_ms``) beside the CUDA-event time of calls issued back to back
    (``events_ms``, ``library_events_ms``), which reads the host's per-call
    work where it exceeds the device time."""
    out = kernel(*args, **kw)
    ref = plain(*args, **kw)
    torch.cuda.synchronize()
    res = compare_rows(name, out, ref, tol)
    if timed:
        res["ms"] = graph_ms(lambda: kernel(*args, **kw))
        res["events_ms"] = time_ms(lambda: kernel(*args, **kw))
        res["plain_ms"] = time_ms(lambda: plain(*args, **kw), n=3)
        call, gather = library(*args, kw["scale"],
                               **{n: kw[n] for n in ("k_scale", "v_scale") if n in kw})
        res["library_ms"] = graph_ms(call)
        res["library_events_ms"] = time_ms(call)
        res["library_gather_ms"] = time_ms(gather, n=3)
    return res


# 8 slots of about 1800 tokens (the trace's longest prompt is 1777), one of
# them empty (an all-trash row) and one holding a single key
LONG_SLOTS = [1800, 1790, 0, 1750, 1, 1777, 1801, 1795]


def redesign_checks(cfg, k7, k8, gen, kv_int8=False) -> tuple:
    """Kernels 7 and 8 (7q and 8q over an int8 pool) in bf16 where their
    tiles and splits have the most to do: decode over LONG_SLOTS (each split
    several 64-key tiles), a chunk of 256 and of 40 queries (not a multiple of
    the 64-row tile) over 1777 tokens of history, at small sizes glm4's heads
    (G = 16, dh = 128) and nlg-350m-moe128's (G = 1, dh = 64), and tables of
    800 and 1400 entries of page size 4 (several of the kernels' 256-entry
    compaction windows, which the served 128-entry tables never leave).  Each
    is held per query row; the served width's decode and C = 256 are timed.
    Returns ({label: reading} of kernel 7, of kernel 8)."""
    sfx = "_int8" if kv_int8 else ""
    ps, nt = CONT["page_size"], CONT["capacity"] // CONT["page_size"]
    G, Hkv, dh = cfg.num_heads // cfg.num_kv_heads, cfg.num_kv_heads, cfg.head_dim
    dec, pre = {}, {}
    for label, lens, hkv, g, d, pg, Pt, width, timed in (
            ("bf16_slots1800", LONG_SLOTS, Hkv, G, dh, ps, 8 * 113 + 2, nt, True),
            ("bf16_glm4_heads", [300, 0, 7], 2, 16, 128, ps, 60, 32, False),
            ("bf16_nlg_heads", [300, 0, 7], 4, 1, 64, ps, 60, 32, False),
            ("bf16_table800_ps4", [3000, 10, 0], 2, 5, 64, 4, 800, 800, False)):
        pool, table, qpos = synthetic_pool(lens, hkv, d, pg, Pt, width, gen, kv_int8)
        args, info = decode_case(pool, table, qpos, g, torch.bfloat16, gen)
        kw = dict(scale=d ** -0.5, **info.pop("kw", {}))
        info.update(check_paged(f"paged_decode_attention{sfx}", k7.paged_decode_attention,
                                k7.paged_decode_attention_plain, args, kw, BF16_TOL, timed=timed,
                                library=sdpa_decode))
        dec[label] = info
        log(f"kernel paged_decode_attention{sfx} {label}: {json.dumps(info)}")
    for label, n_hist, C, hkv, g, d, pg, Pt, width, timed in (
            ("bf16_history1777", 1777, 256, Hkv, G, dh, ps, CONT["n_pages"] + 1, nt, True),
            ("bf16_history1777_c40", 1777, 40, Hkv, G, dh, ps, CONT["n_pages"] + 1, nt, False),
            ("bf16_glm4_heads", 300, 40, 2, 16, 128, ps, 60, 32, False),
            ("bf16_nlg_heads", 300, 40, 4, 1, 64, ps, 60, 32, False),
            ("bf16_table1400_ps4", 5000, 64, 2, 5, 64, 4, 1400, 1400, False)):
        args, info = prefill_case(n_hist, C, hkv, g, d, pg, Pt, width, torch.bfloat16, gen,
                                  kv_int8=kv_int8)
        kw = dict(scale=d ** -0.5, **info.pop("kw", {}))
        info.update(check_paged(f"paged_prefill_attention{sfx}", k8.paged_prefill_attention,
                                k8.paged_prefill_attention_plain, args, kw, BF16_TOL, timed=timed,
                                library=sdpa_prefill))
        pre[label] = info
        log(f"kernel paged_prefill_attention{sfx} {label}: {json.dumps(info)}")
    return dec, pre


# ---------------------------------------------------------------------------
# Flash attention (kernel 6)
# ---------------------------------------------------------------------------


def flash_pairs(q_pos, k_pos, causal, window, chunk=1024) -> int:
    """Unmasked (query, key) pairs of one head: k_pos >= 0, causal, window,
    counted over query chunks so no [S, T] mask is built whole."""
    n = 0
    kp = k_pos[:, None, :]
    for s0 in range(0, q_pos.shape[1], chunk):
        qp = q_pos[:, s0 : s0 + chunk, None]
        valid = (kp >= 0).expand(-1, qp.shape[1], -1)
        if causal:
            valid = valid & (kp <= qp)
        if window > 0:
            valid = valid & (qp - kp < window)
        n += int(valid.sum().item())
    return n


def flash_info(q, k, q_pos, k_pos, kw) -> dict:
    """Kernel 6's bound: q, k, v and out once each and both position rows;
    4*H*dh operations per unmasked (query, key) pair."""
    B, S, H, dh = q.shape
    pairs = flash_pairs(q_pos, k_pos, kw.get("causal", True), kw.get("window", 0))
    need = (2 * q.numel() + 2 * k.numel()) * q.element_size() + (q_pos.numel() + k_pos.numel()) * 4
    return {"B": B, "S": S, "T": k.shape[1], "H": H, "Hkv": k.shape[2], "dh": dh,
            "dtype": str(q.dtype).replace("torch.", ""), "pairs": pairs,
            **bound(need, 4 * H * dh * pairs, q.dtype)}


def flash_case(B, S, H, Hkv, dh, dtype, gen):
    """Random q, k, v of a static prefill of S tokens at the layer's heads,
    positions 0 .. S - 1 in every row."""
    q = torch.randn((B, S, H, dh), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, S, Hkv, dh), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, S, Hkv, dh), generator=gen, device="cuda").to(dtype)
    pos = torch.arange(S, dtype=torch.int32, device="cuda").expand(B, S).contiguous()
    return (q, k, v, pos, pos), dict(scale=1.0 / math.sqrt(dh), causal=True)


def sdpa_full(q, k, v, scale, causal=True):
    """The library yardstick for a causal static prefill (``causal``; an
    encoder's or a cross attention's, every key valid, without): one
    scaled_dot_product_attention(is_causal=causal, enable_gqa=True) over
    [B, heads, tokens, dh] copies of the model's layouts (the copies, and
    the output's copy back, timed apart as the layout).  The math backend,
    which would build the [S, T] logits, is excluded.  In f32 no fused
    backend takes grouped heads, so there K and V are repeated to every
    query head as part of the layout."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    fused = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION]
    G = q.shape[2] // k.shape[2]
    rep = G if q.dtype == torch.float32 else 1
    to_heads = lambda: (q.transpose(1, 2).contiguous(),
                        *(t.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
                          for t in (k, v)))
    qh, kh, vh = to_heads()

    def call():
        with sdpa_kernel(fused):
            return F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal, scale=scale,
                                                  enable_gqa=rep == 1)

    out = call()
    return call, lambda: (to_heads(), out.transpose(1, 2).contiguous())


def q_tile_of(q) -> int:
    """The query rows per block that kernel 6's wgmma path takes for q."""
    from repro_torch.kernels import flash_attention as k6

    B, S, H, dh = q.shape
    return k6.q_tile_rows(S, H, B, torch.cuda.get_device_properties(0).multi_processor_count, dh)


def check_flash(args, kw, tol, timed=True, n=20, plain_n=3, library=None) -> dict:
    """Kernel 6 (``flash_attention_gqa``) against its plain version on the
    same inputs, then timed: ``ms`` is its device time and ``library_ms``
    SDPA's, each from a CUDA graph of its calls (``graph_ms``: at the served
    4 x 64 tokens the wrapper's host work exceeds the kernel), ``host_ms`` one
    wrapper call as the layer pays it (``time_ms``), ``plain_ms`` the plain
    version's; ``n`` and ``plain_n`` calls per timed window.  ``library()``
    gives SDPA's (call, layout) where a mask is needed (``sdpa_window``);
    by default the causal ``sdpa_full``."""
    from repro_torch.kernels import flash_attention as k6

    out = k6.flash_attention_gqa(*args, **kw)
    ref = k6.flash_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    res = compare_rows("flash_attention", out, ref, tol)
    del out, ref
    if timed:
        kernel = lambda: k6.flash_attention_gqa(*args, **kw)
        res["ms"] = graph_ms(kernel, n=n)
        res["host_ms"] = time_ms(kernel, n=min(10, n))
        res["plain_ms"] = time_ms(lambda: k6.flash_attention_plain(*args, **kw), n=plain_n,
                                  reps=3, warmup=1)
        call, layout = library() if library else sdpa_full(args[0], args[1], args[2], kw["scale"])
        res["library_ms"] = graph_ms(call, n=n)
        res["library_layout_ms"] = time_ms(layout, n=plain_n)
    return res


# ---------------------------------------------------------------------------
# Profiles
# ---------------------------------------------------------------------------


def profile_account(run, steps, what, named_ops=(), into=None) -> list:
    """torch.profiler account of ``run(prof)`` (which runs ``steps`` steps
    and returns wall ms per step), beside an unprofiled ``run(None)`` of the
    same steps: device time of the kernels by name, host operators, launches
    and host syncs per step, and the idle share measured under the profiler
    and derived (profiled kernel time over the unprofiled wall time).  The
    per-step syncs and launches also go into the dict ``into``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    plain_wall = run(None)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    wall = run(prof)
    evs = prof.key_averages()
    kern = sorted(((ev.self_device_time_total, ev.key, ev.count) for ev in evs
                   if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0), reverse=True)
    host = sorted(((ev.self_cpu_time_total, ev.key, ev.count) for ev in evs
                   if ev.device_type == DeviceType.CPU), reverse=True)
    syncs = sum(ev.count for ev in evs if ev.key in ("aten::_local_scalar_dense", "cudaStreamSynchronize",
                                                       "cudaDeviceSynchronize"))
    n_launch = sum(ev.count for ev in evs if ev.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                                         "cudaLaunchKernelExC", "cuLaunchKernelEx"))
    n_kern = sum(c for _, _, c in kern)
    if into is not None:
        into.update(syncs=syncs / steps, launches=n_launch / steps, wall_ms=plain_wall)
    if not kern or n_kern < n_launch:
        # CUPTI can drop device records: then the device time is not measured
        return [f"{what} profile: the profiler recorded {n_kern} kernels for {n_launch} launches; "
                "device time not measured"]
    dev = sum(d for d, _, _ in kern) / steps / 1e3
    if into is not None:
        into["device_ms"] = dev
    per = lambda d: f"{d / steps / 1e3:.3f} ms"
    named = []
    if named_ops:
        counts = {ev.key: ev for ev in evs if ev.device_type == DeviceType.CPU}
        named = [f"{what} profile, quantize-on-write operators (host self CPU per step): " + "; ".join(
            f"{k} x{counts[k].count / steps:g} {per(counts[k].self_cpu_time_total)}"
            for k in named_ops if k in counts)]
    return [
        f"{what} profile: kernels {dev:.3f} device ms/step; wall {wall:.3f} ms/step with the "
        f"profiler on (device idle {100 * (1 - dev / wall):.1f}%, measured), {plain_wall:.3f} ms/step "
        f"with it off (device idle {100 * (1 - dev / plain_wall):.1f}%, derived: profiled kernel "
        f"time over unprofiled wall time); {n_launch / steps:.0f} kernel launches, "
        f"{n_kern / steps:.0f} kernels on the device and {syncs / steps:.1f} host syncs per step",
        f"{what} profile, kernels: " + "; ".join(f"{k[:70]} {per(d)} x{c / steps:g}"
                                                 for d, k, c in kern[:8]),
        f"{what} profile, host ops (self CPU): " + "; ".join(
            f"{k} {per(d)} x{c // steps}" for d, k, c in host[:10]),
    ] + named


# the operators that quantize a token's K/V on write (quant/kv.py) and
# scatter it into the cache
QUANT_WRITE_OPS = ("aten::abs", "aten::amax", "aten::clamp_min", "aten::div", "aten::round",
                   "aten::clamp", "aten::_to_copy", "aten::copy_")


def profile_decode(eng, cfg, params, steps=5, what="decode", named_ops=(), into=None) -> list:
    """Where a static decode step's time goes, as the engine runs it (greedy
    token read back every step; the engine's encoder memory and patch
    embeddings, and its decode index)."""
    from repro_torch.models.model import decode_step, prefill

    toks = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), device="cuda")

    def run(prof):
        caches = eng._make_caches(BATCH)
        logits, caches = prefill(cfg, params, toks, caches, memory=eng.memory,
                                 prefix_embeds=eng.prefix_embeds)
        cur = logits.argmax(-1)[:, None]
        cur.cpu()
        with prof or contextlib.nullcontext():
            t0 = time.perf_counter()
            for t in range(steps):
                logits, caches = decode_step(cfg, params, cur, PROMPT + eng._offset + t, caches,
                                             memory=eng.memory)
                cur = logits.argmax(-1)[:, None]
                cur.cpu()
            return (time.perf_counter() - t0) / steps * 1e3

    return profile_account(run, steps, what, named_ops, into=into)


def profile_ticks(eng, cfg, steps=5, what="tick", into=None) -> list:
    """Where a continuous decode tick's time goes: every slot decoding (each
    prefill done), one ``step()`` per tick."""
    from repro_torch.serving.engine import Request

    rng = torch.Generator().manual_seed(SEED + 3)
    prompts = [torch.randint(0, cfg.vocab_size, (PROFILE_PROMPT,), generator=rng).tolist()
               for _ in range(eng.n_slots)]

    def run(prof):
        for p in prompts:
            # enough tokens to outlast the other slots' prefill ticks
            eng.submit(Request(p, 48))
        while any(s.prefilling for s in eng.slots) or eng.queue:
            eng.step()
        assert sum(s.active for s in eng.slots) == len(prompts)
        with prof or contextlib.nullcontext():
            t0 = time.perf_counter()
            for _ in range(steps):
                eng.step()
            wall = (time.perf_counter() - t0) / steps * 1e3
        eng.run_until_done()
        return wall

    return profile_account(run, steps, what, into=into)


# ---------------------------------------------------------------------------
# Reference checks
# ---------------------------------------------------------------------------


def reference_check(cfg, on_card=None) -> str:
    """The static path on a small input against a reference: the same f32
    weights (``on_card``, or drawn from the seed) served on the card
    (through the kernels) and on the CPU (through their plain versions) give
    the same logits within 1e-4 (f32, TF32 off; only summation order
    differs) and the same greedy tokens."""
    from repro_torch.models.model import forward, init_params
    from repro_torch.serving.engine import Engine, EngineConfig, Request

    if on_card is None:
        on_card = init_params(cfg, seed=SEED, device="cuda")
    on_cpu = copy.deepcopy(on_card).to("cpu")
    toks = torch.randint(0, cfg.vocab_size, (3, 12), generator=torch.Generator().manual_seed(SEED))
    with torch.no_grad():  # a serving reference: no graph
        a, _ = forward(cfg, on_card, toks.cuda())
        b, _ = forward(cfg, on_cpu, toks)
    assert a.shape == b.shape and torch.isfinite(a).all()
    err = (a.cpu() - b).abs().max().item()
    if not torch.allclose(a.cpu(), b, atol=1e-4, rtol=1e-4):
        raise AssertionError(f"reduced {cfg.name}: card logits differ from the CPU's by {err:.3e}")
    ec = EngineConfig(max_batch=4, max_prefill=12, max_decode=8)
    reqs = [Request(toks[i, : 12 - 3 * i].tolist(), 8) for i in range(3)]
    card = [r.tokens for r in Engine(cfg, on_card, ec, device="cuda").generate(reqs)]
    cpu = [r.tokens for r in Engine(cfg, on_cpu, ec, device="cpu").generate(reqs)]
    if card != cpu:
        raise AssertionError(f"reduced {cfg.name}: greedy tokens on the card {card} != CPU {cpu}")
    return (f"reference: reduced {cfg.name} f32, card (kernels) vs CPU (plain versions): "
            f"logits max|d| {err:.3e} (tolerance 1e-4), greedy tokens identical {card}")


def continuous_reference_check(cfg, on_card=None, kv_cache_bits=0) -> str:
    """The continuous path on a small input: reduced f32 weights (``on_card``,
    or drawn from the seed), one trace through the engine on the card and on
    the CPU, with 14 pages for 3 slots of capacity 48 (under half their worst
    case) so that it preempts."""
    from repro_torch.models.model import init_params
    from repro_torch.serving.continuous import ContinuousEngine
    from repro_torch.serving.engine import Request

    if on_card is None:
        on_card = init_params(cfg, seed=SEED, device="cuda")
    on_cpu = copy.deepcopy(on_card).to("cpu")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (13, 6, 9, 3, 17, 25, 40)]
    kw = dict(slots=3, capacity=48, paged=True, page_size=4, n_pages=14, prefill_chunk=8,
              kv_cache_bits=kv_cache_bits)
    out = {}
    for dev, params in (("cuda", on_card), ("cpu", on_cpu)):
        eng = ContinuousEngine(cfg, params, device=dev, **kw)
        ids = [eng.submit(Request(p, 7)) for p in prompts]
        done = eng.run_until_done()
        assert eng.pool.free_count == eng.n_pages, dev
        out[dev] = ([done[i].tokens for i in ids], eng.preemptions, eng.last_logits.cpu())
    (ta, pa, la), (tb, pb, lb) = out["cuda"], out["cpu"]
    rel = (la - lb).abs().max().item() / lb.abs().max().item()
    if ta != tb or pa != pb or pa < 1 or rel > F32_TOL:
        raise AssertionError(f"reduced {cfg.name} continuous: card tokens {ta} preemptions {pa}; "
                             f"CPU {tb} / {pb}; last-tick logits rel {rel:.3e}")
    what = "int8 experts + int8 KV, " if kv_cache_bits else ""
    return (f"continuous reference: reduced {cfg.name} f32, {what}card (kernels) vs CPU (plain "
            f"versions): greedy tokens identical {ta}, preemptions {pa} on both, last tick's "
            f"logits max|d| {rel:.3e} of max|logit| (tolerance {F32_TOL}), pool drained")


def chunked_prefill_check(cfg, params) -> str:
    """One 512-token prompt: the paged path (two 256-token chunks through
    kernel 8) against the static prefill (contiguous cache), bf16."""
    from repro_torch.models.model import init_caches, init_paged_caches, paged_prefill_chunk, prefill

    S, C, ps = 512, CONT["prefill_chunk"], CONT["page_size"]
    toks = torch.randint(0, cfg.vocab_size, (1, S), generator=torch.Generator().manual_seed(SEED + 2)).cuda()
    ref, _ = prefill(cfg, params, toks, init_caches(cfg, 1, S, device="cuda"))
    caches = init_paged_caches(cfg, 1, S, n_pages=S // ps, page_size=ps, device="cuda")
    row = torch.arange(S // ps, dtype=torch.int32, device="cuda").flip(0).contiguous()  # pages in reverse
    for s0 in range(0, S, C):
        pos = torch.arange(s0, s0 + C, dtype=torch.int32, device="cuda")[None]
        got, caches = paged_prefill_chunk(cfg, params, toks[:, s0 : s0 + C], pos, caches, row)
    ref, got = ref.float()[0], got.float()[0]
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    a_ref, a_got = int(ref.argmax()), int(got.argmax())
    if err > BF16_LOGITS_TOL * scale or a_ref != a_got:
        raise AssertionError(f"chunked prefill: logits max|d| {err:.4f} of max|logit| {scale:.4f} "
                             f"(tolerance {BF16_LOGITS_TOL}), argmax {a_got} vs static {a_ref}")
    top2 = ref.topk(2).values
    return (f"chunked prefill: {cfg.name} bf16, 512-token prompt, paged (2 x 256 chunks, kernel 8) "
            f"vs static prefill: logits max|d| {err:.4f} = {err / scale:.2e} of max|logit| "
            f"{scale:.4f} (tolerance {BF16_LOGITS_TOL}); argmax {a_got} equal (static top-2 gap "
            f"{(top2[0] - top2[1]).item():.4f})")


# ---------------------------------------------------------------------------
# Continuous serve
# ---------------------------------------------------------------------------


def continuous_serve(cfg, params, counters, kv_cache_bits=0, preemptions=None, what=None):
    """The trace through the paged engine; returns (lines, launches, the
    decode snapshot for kernel 7, the engine).  Quantized experts and
    ``kv_cache_bits=8`` run kernels 5, 7q and 8q and no fp kernel; a config
    under the capacity dispatch runs kernels 1 and 2 in place of 4;
    ``preemptions``: the count the fp run gave, which this run must repeat
    (the scheduler depends on prompt lengths only)."""
    from repro_torch.serving.continuous import ContinuousEngine
    from repro_torch.serving.engine import Request

    what = what or "continuous serve" + (" int8" if kv_cache_bits else "")
    eng = ContinuousEngine(cfg, params, paged=True, device="cuda", kv_cache_bits=kv_cache_bits,
                           **CONT)
    rng = torch.Generator().manual_seed(SEED + 1)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist() for n in CONT_PROMPTS]
    eng.submit(Request(prompts[0][:300], 4))  # warm-up: both chunk shapes, decode
    eng.run_until_done()
    eng.done.clear()
    eng.metrics_log.clear()
    eng.preemptions = eng.prefill_tokens_total = eng.prefill_calls_total = 0
    torch.cuda.synchronize()
    snap = None
    first = {}

    def seen(now):
        for s in eng.slots:
            if s.active and not s.prefilling and s.request_id not in first:
                first[s.request_id] = now
        for rid in eng.done:
            first.setdefault(rid, now)

    reset(*counters)
    t0 = time.perf_counter()
    ids = []
    for p in prompts:
        ids.append(eng.submit(Request(p, CONT_NEW)))
        seen(time.perf_counter())
    while True:
        n = eng.step()
        seen(time.perf_counter())
        decoding = np.asarray([s.active and not s.prefilling for s in eng.slots])
        if snap is None and 3 <= decoding.sum() < len(eng.slots):
            # kernel 7's inputs as the next tick would see them: layer 0's
            # pool, the decoding rows' tables (others all -1), positions
            # (an int8 pool gives its values and scales as separate entries)
            layer = eng.caches["seg0"]["pos0"]["self"]
            pool = {"pos": layer["pos"][0].clone()}
            for n in ("k", "v"):
                if kv_cache_bits:
                    pool[n], pool[f"{n}_scale"] = layer[n].q[0].clone(), layer[n].scale[0].clone()
                else:
                    pool[n] = layer[n][0].clone()
            tbl = np.where(decoding[:, None] & (eng.tables.table >= 0), eng.tables.table,
                           eng.n_pages)  # clamped: unmapped -> trash
            qpos = np.asarray([s.pos if s.active else 0 for s in eng.slots], np.int32)
            snap = (pool, torch.from_numpy(tbl.astype(np.int32)).cuda(), torch.from_numpy(qpos).cuda())
        if n == 0 and not eng.queue:
            break
    wall = time.perf_counter() - t0
    launches = read(counters, what)
    done = eng.done
    assert sorted(done) == sorted(ids) and all(len(done[i].tokens) == CONT_NEW for i in ids)
    assert all(0 <= t < cfg.vocab_size for i in ids for t in done[i].tokens)
    if eng.pool.free_count != eng.n_pages:
        raise AssertionError(f"the pool did not drain: {eng.pool.free_count} of {eng.n_pages} free")
    if eng.preemptions < 1:
        raise AssertionError("the continuous serve preempted no request; the pool was meant to run dry")
    if preemptions is not None and eng.preemptions != preemptions:
        raise AssertionError(f"{what}: {eng.preemptions} preemptions, the fp run {preemptions}")
    n_layers = cfg.num_layers
    n_moe = sum(ls.ffn.kind == "moe" for ls in cfg.layer_specs())
    ticks = [m for m in eng.metrics_log if m["tokens_this_tick"]]
    sfx = "_int8" if kv_cache_bits else ""
    want = {k: 0 for k in launches}
    n_calls = n_moe * (len(ticks) + eng.prefill_calls_total)
    want.update({f"paged_decode_attention{sfx}": n_layers * len(ticks),
                 f"paged_prefill_attention{sfx}": n_layers * eng.prefill_calls_total,
                 expert_kernel(cfg, params): n_calls})
    if capacity(cfg):
        want["moe_gating"] = n_calls
    if launches != want:
        raise AssertionError(f"{what} launches {launches}, expected {want}")
    if snap is None:
        raise AssertionError("no tick had between 3 and 7 decoding slots to snapshot")
    n_tok = sum(len(done[i].tokens) for i in ids)
    tick_ms = statistics.median(m["decode_s"] for m in ticks) * 1e3
    ttft = [round((first[i] - t0) * 1e3, 3) for i in ids]
    lines = [
        f"{what}: {len(ids)} requests x {CONT_NEW} tokens (prompts {CONT_PROMPTS}) in "
        f"{wall * 1e3:.3f} ms ({n_tok / wall:.1f} tok/s); {len(eng.metrics_log)} ticks, "
        f"{len(ticks)} with decode, decode phase median {tick_ms:.3f} ms; "
        f"{eng.prefill_tokens_total} prefill tokens in {eng.prefill_calls_total} chunks; "
        f"preemptions {eng.preemptions}; launches {launches}; pool drained "
        f"(free {eng.pool.free_count} == n_pages {eng.n_pages}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB",
        f"{what}: TTFT ms per request {ttft} (median {statistics.median(ttft):.3f})",
        f"{what}: tokens of request 0: {done[ids[0]].tokens}",
    ]
    return lines, launches, snap, eng


# ---------------------------------------------------------------------------
# Prefix sharing, the batched prefill tick and the contiguous engine
# ---------------------------------------------------------------------------

# the prefix trace (phase 4b): 8 requests whose prompts share a 1024-token
# prefix (64 pages of 16) and end in distinct suffixes of 40-400 tokens,
# after one submit_n of FORK_N samples of a 700-token prompt (admitted first,
# so its forks share every page of its base, the partial boundary page too)
PREFIX_LEN = 1024
PREFIX_SUFFIXES = [40, 400, 123, 256, 77, 311, 190, 64]
FORK_PROMPT, FORK_N = 700, 4


def expected_launches(cfg, params, launches, eng, ticks, kv8=False) -> dict:
    """Every kernel's launches in one engine run: each global attention
    layer of each decode tick launches kernel 7 (paged) or, over an int8
    contiguous cache, 9, each sliding-window layer (its ring beside the
    pool) kernel 9 over an int8 ring and nothing over a bf16 one; each
    prefill call launches per global layer kernel 8 (chunked) or the batched
    kernel 8 (batched), and per attention layer kernel 6 (scatter,
    contiguous; a ring's paged chunk launches nothing); every MoE layer call
    its expert kernel (and kernel 1 under the capacity dispatch); SSD and
    RG-LRU layers launch none."""
    n_global, n_local = layer_counts(cfg)
    n_attn = n_global + n_local
    n_moe = sum(ls.ffn.kind == "moe" for ls in cfg.layer_specs())
    sfx = "_int8" if kv8 else ""
    calls = eng.prefill_calls_total
    want = {k: 0 for k in launches}
    if eng.paged:
        want[f"paged_decode_attention{sfx}"] = n_global * ticks
        if eng.prefill_mode == "scatter":
            want["flash_attention"] = n_attn * calls
        else:
            prefill = {"chunked": f"paged_prefill_attention{sfx}",
                       "batched": f"paged_prefill_attention_batched{sfx}"}[eng.prefill_mode]
            want[prefill] = n_global * calls
        if kv8:
            want["decode_attention_quant"] = n_local * ticks
    else:
        want["flash_attention"] = n_attn * calls
        if kv8:
            want["decode_attention_quant"] = n_attn * ticks
    if n_moe:
        want[expert_kernel(cfg, params)] = n_moe * (ticks + calls)
    if capacity(cfg):
        want["moe_gating"] = n_moe * (ticks + calls)
    return want


def clear_run_state(eng) -> None:
    """Forget a warm-up run's results and counts (the pool is drained)."""
    eng.done.clear()
    eng.metrics_log.clear()
    for name in ("preemptions", "prefill_tokens_total", "prefill_tokens_skipped",
                 "prefill_calls_total", "prefix_hits", "prefix_hit_tokens", "cow_copies"):
        setattr(eng, name, 0)


def timed_run(eng, submit, on_tick=None) -> tuple:
    """``submit()`` (returns request ids), then ticks until the engine is
    idle; returns (ids, wall seconds, TTFT ms per id from the submission)."""
    first = {}

    def seen(now):
        for s in eng.slots:
            if s.active and not s.prefilling and s.request_id not in first:
                first[s.request_id] = now
        for rid in eng.done:
            first.setdefault(rid, now)

    t0 = time.perf_counter()
    ids = submit()
    seen(time.perf_counter())
    while True:
        n = eng.step()
        seen(time.perf_counter())
        if on_tick is not None:
            on_tick()
        if n == 0 and not eng.queue:
            break
    wall = time.perf_counter() - t0
    return ids, wall, [round((first[i] - t0) * 1e3, 3) for i in ids]


def capture_first_logits(eng) -> dict:
    """{request id: the logits its first token was drawn from}, kept on the
    card (no read-back): the engine's prefill completions and fork
    admissions wrapped."""
    firsts = {}
    finish, admit_fork = eng._finish_prefill, eng._admit_fork

    def finish_prefill(i, first, logits):
        firsts.setdefault(eng.slots[i].request_id, logits.detach().float().clone())
        finish(i, first, logits)

    def fork(i, b, item):
        firsts.setdefault(item.rid, eng.slots[b].prefill_logits.detach().float().clone())
        admit_fork(i, b, item)

    eng._finish_prefill, eng._admit_fork = finish_prefill, fork
    return firsts


def prefix_trace(cfg, params, counters, prefill_mode="chunked", sharing=True, kv_cache_bits=0):
    """The prefix trace through the paged engine (CONT's pool; sharing on or
    off; chunked or batched; an int8 pool); returns (lines, launches, first-
    token logits by request id, the engine)."""
    from repro_torch.serving.continuous import ContinuousEngine
    from repro_torch.serving.engine import Request

    what = (f"prefix trace {prefill_mode}" + ("" if sharing else " unshared")
            + (" int8 KV" if kv_cache_bits else ""))
    eng = ContinuousEngine(cfg, params, paged=True, device="cuda", prefill_mode=prefill_mode,
                           prefix_sharing=sharing, kv_cache_bits=kv_cache_bits, **CONT)
    rng = torch.Generator().manual_seed(SEED + 3)
    draw = lambda n: torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()
    prefix = draw(PREFIX_LEN)
    prompts = [prefix + draw(n) for n in PREFIX_SUFFIXES]
    fork = draw(FORK_PROMPT)
    eng.submit(Request(draw(300), 4))  # warm-up
    eng.run_until_done()
    clear_run_state(eng)
    firsts = capture_first_logits(eng)
    torch.cuda.synchronize()
    reset(*counters)
    ids, wall, ttft = timed_run(eng, lambda: eng.submit_n(Request(fork, CONT_NEW), FORK_N)
                                + [eng.submit(Request(p, CONT_NEW)) for p in prompts])
    launches = read(counters, what)
    done = eng.done
    assert sorted(done) == sorted(ids) and all(len(done[i].tokens) == CONT_NEW for i in ids)
    assert all(0 <= t < cfg.vocab_size for i in ids for t in done[i].tokens)
    if eng.pool.free_count != eng.n_pages or (sharing and len(eng.prefix)):
        raise AssertionError(f"{what}: the pool or the prefix index did not drain")
    if sharing and (eng.prefix_hits < 1 or eng.cow_copies < 1):
        raise AssertionError(f"{what}: {eng.prefix_hits} prefix hits, {eng.cow_copies} CoW copies")
    ticks = [m for m in eng.metrics_log if m["tokens_this_tick"]]
    want = expected_launches(cfg, params, launches, eng, len(ticks), kv8=bool(kv_cache_bits))
    if launches != want:
        raise AssertionError(f"{what} launches {launches}, expected {want}")
    prefill_ticks = [m for m in eng.metrics_log if m["prefill_calls"]]
    if prefill_mode == "batched" and (len(prefill_ticks) != eng.prefill_calls_total
                                      or any(m["prefill_calls"] != 1 for m in prefill_ticks)):
        raise AssertionError(f"{what}: {eng.prefill_calls_total} batched calls over "
                             f"{len(prefill_ticks)} ticks that prefilled")
    n_tok = sum(len(done[i].tokens) for i in ids)
    tick_ms = statistics.median(m["decode_s"] for m in ticks) * 1e3
    lines = [
        f"{what}: {len(ids)} requests x {CONT_NEW} tokens ({FORK_N} samples of a {FORK_PROMPT}-"
        f"token prompt, then {len(prompts)} prompts of a shared {PREFIX_LEN}-token prefix and "
        f"suffixes {PREFIX_SUFFIXES}) in {wall * 1e3:.3f} ms ({n_tok / wall:.1f} tok/s); "
        f"{len(eng.metrics_log)} ticks, {len(ticks)} with decode, decode phase median "
        f"{tick_ms:.3f} ms; prefill tokens computed {eng.prefill_tokens_total}, skipped "
        f"{eng.prefill_tokens_skipped}, in {eng.prefill_calls_total} calls "
        f"({len(prefill_ticks)} ticks prefilled); prefix hits {eng.prefix_hits}, hit tokens "
        f"{eng.prefix_hit_tokens}; CoW copies {eng.cow_copies}; preemptions {eng.preemptions}; "
        f"launches {launches}; pool drained",
        f"{what}: TTFT ms per request {ttft} (median {statistics.median(ttft):.3f})",
    ]
    return lines, launches, firsts, eng


def compare_first_logits(what, got, ref) -> str:
    """Each request's first-token logits within BF16_LOGITS_TOL of the
    reference run's, relative to that request's largest reference logit."""
    worst, same = 0.0, 0
    for rid, r in ref.items():
        g = got[rid]
        worst = max(worst, (g - r).abs().max().item() / r.abs().max().item())
        same += int(g.argmax().item() == r.argmax().item())
    if worst > BF16_LOGITS_TOL:
        raise AssertionError(f"{what}: first-token logits differ by {worst:.3e} of the "
                             f"unshared run's largest (tolerance {BF16_LOGITS_TOL})")
    return (f"{what} vs unshared: first-token logits of {len(ref)} requests within {worst:.3e} "
            f"of max|logit| (tolerance {BF16_LOGITS_TOL}); first tokens equal for {same}")


def contiguous_trace(cfg, params, counters, kv_cache_bits=0):
    """The phase-4 trace (CONT_PROMPTS) through the contiguous engine: every
    admission prefills its whole prompt into its slot's row (kernel 6), every
    tick decodes the 8 rows (kernel 9 over an int8 cache, the plain ``_sdpa``
    over a bf16 one).  Returns (lines, launches, kernel 9's inputs at a
    tick with an inactive row (int8), the engine)."""
    from repro_torch.serving.continuous import ContinuousEngine
    from repro_torch.serving.engine import Request

    what = "contiguous serve" + (" int8 KV" if kv_cache_bits else "")
    eng = ContinuousEngine(cfg, params, paged=False, slots=CONT["slots"],
                           capacity=CONT["capacity"], kv_cache_bits=kv_cache_bits, device="cuda")
    rng = torch.Generator().manual_seed(SEED + 1)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist() for n in CONT_PROMPTS]
    eng.submit(Request(prompts[0][:300], 4))  # warm-up
    eng.run_until_done()
    clear_run_state(eng)
    snap = []

    def on_tick():
        active = [s.active for s in eng.slots]
        if kv_cache_bits and not snap and 3 <= sum(active) < len(active):
            c = eng.caches["seg0"]["pos0"]["self"]
            kv = [(c[n].q[0].clone(), c[n].scale[0].clone()) for n in ("k", "v")]
            qpos = torch.tensor([s.pos if s.active else 0 for s in eng.slots], dtype=torch.int32,
                                device="cuda")
            snap.append((kv, c["pos"][0].clone(), qpos))

    torch.cuda.synchronize()
    reset(*counters)
    ids, wall, ttft = timed_run(eng, lambda: [eng.submit(Request(p, CONT_NEW)) for p in prompts],
                                on_tick)
    launches = read(counters, what)
    done = eng.done
    assert sorted(done) == sorted(ids) and all(len(done[i].tokens) == CONT_NEW for i in ids)
    assert all(0 <= t < cfg.vocab_size for i in ids for t in done[i].tokens)
    ticks = [m for m in eng.metrics_log if m["tokens_this_tick"]]
    want = expected_launches(cfg, params, launches, eng, len(ticks), kv8=bool(kv_cache_bits))
    if launches != want or eng.prefill_calls_total != len(prompts):
        raise AssertionError(f"{what} launches {launches} in {eng.prefill_calls_total} "
                             f"admissions, expected {want}")
    if kv_cache_bits and not snap:
        raise AssertionError(f"{what}: no tick had an inactive row beside 3 active ones")
    n_tok = sum(len(done[i].tokens) for i in ids)
    tick_ms = statistics.median(m["decode_s"] for m in ticks) * 1e3
    lines = [
        f"{what}: {len(ids)} requests x {CONT_NEW} tokens (prompts {CONT_PROMPTS}), "
        f"{CONT['slots']} slots x {CONT['capacity']} in {wall * 1e3:.3f} ms ({n_tok / wall:.1f} "
        f"tok/s); {len(ticks)} decode ticks, median {tick_ms:.3f} ms; {eng.prefill_calls_total} "
        f"admissions ({eng.prefill_tokens_total} prefill tokens); launches {launches}",
        f"{what}: TTFT ms per request {ttft} (median {statistics.median(ttft):.3f})",
    ]
    return lines, launches, (snap[0] if snap else None), eng


# ---------------------------------------------------------------------------
# Slice 13: observability (phase 4d)
# ---------------------------------------------------------------------------

# the six runs of the phase-4 trace, in turns, so that a drift of the host
# over the phase falls on every setting alike
OBS_ORDER = ("disabled", "default", "full", "full", "default", "disabled")
# where the trace and the metrics go: the output directory beside the script
# (listed in .gitignore), which holds the run logs too
OBS_DIR = Path(__file__).resolve().parent / "chiprun_out"
OBS_HISTOGRAMS = ("serve.ttft_s", "serve.tpot_s", "serve.queue_wait_s", "serve.tick_s")


def make_obs(kind):
    from repro_torch.obs import Obs

    return {"disabled": Obs.disabled, "default": Obs,
            "full": lambda: Obs(trace=True, routing=True)}[kind]()


def obs_percentiles(snap) -> dict:
    """{histogram: (p50 ms, p99 ms, count)} of the SLO histograms."""
    return {n: (snap["histograms"][n]["p50"] * 1e3, snap["histograms"][n]["p99"] * 1e3,
                snap["histograms"][n]["count"])
            for n in OBS_HISTOGRAMS if snap["histograms"].get(n, {}).get("count")}


def obs_phase(cfg, params, counters, want_launches, want_preemptions) -> tuple:
    """Phase 4d: the phase-4 trace through a fresh paged engine per run
    under ``OBS_ORDER``'s settings; returns (lines, launches, summary).
    Fails unless every run gives the same tokens and the launches and
    preemptions of phase 4, the counters agree with the engine's own
    attributes, and a steady decode tick's host syncs (torch.profiler over
    5 ticks of 8 decoding slots) are the disabled run's under the default
    ``Obs()`` and at most one more with routing."""
    from repro_torch.serving.continuous import ContinuousEngine
    from repro_torch.serving.engine import Request

    rng = torch.Generator().manual_seed(SEED + 1)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist() for n in CONT_PROMPTS]
    OBS_DIR.mkdir(exist_ok=True)
    metrics_path, trace_path = OBS_DIR / "obs_metrics.jsonl", OBS_DIR / "obs_trace.json"
    metrics_path.unlink(missing_ok=True)
    lines, runs, tokens = [], [], None
    for n, kind in enumerate(OBS_ORDER):
        obs = make_obs(kind)
        eng = ContinuousEngine(cfg, params, paged=True, device="cuda", obs=obs, **CONT)
        torch.cuda.synchronize()
        reset(*counters)
        ids, wall, _ = timed_run(eng, lambda: [eng.submit(Request(p, CONT_NEW)) for p in prompts])
        launches = read(counters, f"obs {kind} {n}")
        got = [eng.done[i].tokens for i in ids]
        tokens = tokens or got
        if got != tokens:
            raise AssertionError(f"obs run {n} ({kind}): the tokens differ from run 0's")
        if launches != want_launches or eng.preemptions != want_preemptions:
            raise AssertionError(f"obs run {n} ({kind}): launches {launches}, preemptions "
                                 f"{eng.preemptions}; phase 4: {want_launches}, "
                                 f"{want_preemptions}")
        if eng.pool.free_count != eng.n_pages:
            raise AssertionError(f"obs run {n} ({kind}): the pool did not drain")
        snap = obs.metrics.snapshot()
        c = snap["counters"]
        decoded = sum(m["tokens_this_tick"] for m in eng.metrics_log)
        if kind != "disabled" and (
                c["serve.preemptions"] != eng.preemptions
                or c["serve.prefill_tokens_computed"] != eng.prefill_tokens_total
                or c["serve.decode_tokens"] != decoded
                or c["serve.requests_completed"] != len(ids)
                or snap["histograms"]["serve.tick_s"]["count"] != len(eng.metrics_log)
                or c["serve.retraces"] != 0):
            raise AssertionError(f"obs run {n} ({kind}): counters {c} disagree with the engine")
        if kind == "disabled" and (snap != {"counters": {}, "gauges": {}, "histograms": {}}
                                   or obs.tracer.n_events):
            raise AssertionError(f"obs run {n}: Obs.disabled() recorded {snap}")
        steady = [m["tick_s"] for m in eng.metrics_log
                  if m["tokens_this_tick"] and not m["prefill_tokens"]]
        run = {"run": n, "kind": kind, "steady_tick_ms": statistics.median(steady) * 1e3,
               "steady_ticks": len(steady), "ticks": len(eng.metrics_log), "wall_ms": wall * 1e3,
               "tok_per_s": sum(map(len, got)) / wall}
        line = (f"obs run {n} ({kind}): steady decode tick median {run['steady_tick_ms']:.3f} ms "
                f"over {len(steady)} of {len(eng.metrics_log)} ticks; {wall * 1e3:.3f} ms, "
                f"{run['tok_per_s']:.1f} tok/s; launches and tokens as phase 4")
        if kind != "disabled":
            run["percentiles_ms"] = obs_percentiles(snap)
            line += "; " + "; ".join(f"{h} p50 {a:.3f} / p99 {b:.3f} ms (n {k})"
                                     for h, (a, b, k) in run["percentiles_ms"].items())
            obs.metrics.write_jsonl(str(metrics_path), extra={"run": n, "kind": kind,
                                                              "arch": cfg.name})
        if kind == "full":
            routed = [m["routing"] for m in eng.metrics_log if "routing" in m]
            if len(routed) != sum(1 for m in eng.metrics_log if m["tokens_this_tick"]):
                raise AssertionError(f"obs run {n}: {len(routed)} routing summaries")
            run["routing_gauges"] = {g: snap["gauges"][g] for g in
                                     ("routing.dropped_frac", "routing.entropy",
                                      "routing.imbalance")}
            run["trace_events"] = obs.tracer.n_events
            line += (f"; trace {obs.tracer.n_events} events; routing gauges (last tick) "
                     f"{run['routing_gauges']}; summaries on {len(routed)} decode ticks, mean "
                     f"entropy {statistics.mean(r['entropy'] for r in routed):.4f}, mean "
                     f"imbalance {statistics.mean(r['imbalance'] for r in routed):.4f}")
            if not trace_path.exists():
                obs.tracer.export(str(trace_path))
                line += f" -> {trace_path.relative_to(OBS_DIR.parent)}"
        runs.append(run)
        lines.append(line)
        del eng
    by_kind = {k: [r["steady_tick_ms"] for r in runs if r["kind"] == k] for k in OBS_ORDER}
    syncs = {}
    for kind in ("disabled", "default", "full"):
        eng = ContinuousEngine(cfg, params, paged=True, device="cuda", obs=make_obs(kind), **CONT)
        into = {}
        lines += profile_ticks(eng, cfg, what=f"obs {kind} tick", into=into)
        syncs[kind] = into
        del eng
    if syncs["default"]["syncs"] != syncs["disabled"]["syncs"] or (
            syncs["full"]["syncs"] > syncs["disabled"]["syncs"] + 1):
        raise AssertionError(f"host syncs per steady decode tick: {syncs}")
    summary = {"steady_tick_ms": by_kind, "profile": syncs, "runs": runs}
    lines.append(f"obs: steady decode tick medians (ms) in turns, disabled / default / full: "
                 f"{by_kind['disabled']} / {by_kind['default']} / {by_kind['full']}; host syncs "
                 f"per steady tick {syncs['disabled']['syncs']:g} / {syncs['default']['syncs']:g} "
                 f"/ {syncs['full']['syncs']:g}; metrics -> "
                 f"{metrics_path.relative_to(OBS_DIR.parent)}")
    return lines, launches, summary


def slice6_reference_checks(red, red_cap) -> list:
    """Reduced f32 llama4, the same weights on the card (kernels) and on the
    CPU (plain versions), through prefix sharing under the chunked, batched
    and scatter modes, ``submit_n``, the contiguous engine with an fp and an
    int8 cache, and the batched tick under the capacity dispatch: identical
    tokens, preemptions, prefix hits, CoW copies and drained pools."""
    from repro_torch.models.model import init_params
    from repro_torch.serving.continuous import ContinuousEngine
    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(SEED + 6)
    draw = lambda n: rng.integers(1, red.vocab_size, n).tolist()
    pre = draw(8)  # two pages of 4
    prompts = [pre + draw(5), pre + draw(9), draw(6), pre + draw(17), pre + draw(30), draw(13)]
    fork = pre + draw(3)
    paged = dict(paged=True, slots=3, capacity=48, page_size=4, n_pages=14, prefill_chunk=8)
    cases = [(f"prefix {m}", red, dict(paged, prefix_sharing=True, prefill_mode=m))
             for m in ("chunked", "batched", "scatter")]
    cases += [("contiguous", red, dict(slots=3, capacity=48)),
              ("contiguous int8 KV", red, dict(slots=3, capacity=48, kv_cache_bits=8)),
              ("batched capacity dispatch", red_cap, dict(paged, prefill_mode="batched"))]
    trees = {}
    lines = []
    for label, cfg, kw in cases:
        if cfg.name + cfg.moe_impl not in trees:
            on_card = init_params(cfg, seed=SEED, device="cuda")
            trees[cfg.name + cfg.moe_impl] = (on_card, copy.deepcopy(on_card).to("cpu"))
        recs = []
        for dev, params in zip(("cuda", "cpu"), trees[cfg.name + cfg.moe_impl]):
            eng = ContinuousEngine(cfg, params, device=dev, **kw)
            ids = eng.submit_n(Request(fork, 7), 2) + [eng.submit(Request(p, 7)) for p in prompts]
            done = eng.run_until_done()
            rec = {"tokens": [done[i].tokens for i in ids], "preemptions": eng.preemptions,
                   "prefix_hits": eng.prefix_hits, "cow_copies": eng.cow_copies,
                   "drained": not eng.paged or eng.pool.free_count == eng.n_pages}
            recs.append(rec)
        if recs[0] != recs[1] or not recs[0]["drained"]:
            raise AssertionError(f"reduced {red.name} {label}: card {recs[0]}, CPU {recs[1]}")
        r = recs[0]
        lines.append(f"slice-6 reference: reduced {cfg.name} f32 ({cfg.moe_impl}), {label}, card "
                     f"(kernels) vs CPU (plain versions): tokens identical, preemptions "
                     f"{r['preemptions']}, prefix hits {r['prefix_hits']}, CoW copies "
                     f"{r['cow_copies']} on both; pools drained")
    return lines


def sdpa_prefill_batched(q, k, v, kpos, tables, qpos, ck, cv, scale, k_scale=None, v_scale=None):
    """The batched kernel 8's yardstick: each row's pages (dequantized, for
    an int8 pool) and chunk K/V gathered into [B, Hkv, T, dh] beforehand,
    then one scaled_dot_product_attention over the batch with each row's
    mask (a padded query's row is all masked: its output is not used)."""
    import torch.nn.functional as F

    B, C, Hkv, G, dh = q.shape
    idx = tables.long()

    def gather():
        kg = torch.cat([gathered(k, k_scale, idx, q.dtype).reshape(B, -1, Hkv, dh), ck], 1)
        vg = torch.cat([gathered(v, v_scale, idx, q.dtype).reshape(B, -1, Hkv, dh), cv], 1)
        return kg.transpose(1, 2).contiguous(), vg.transpose(1, 2).contiguous()

    kg, vg = gather()
    hist = kpos[idx].reshape(B, -1)
    kp = torch.cat([torch.where(hist >= qpos[:, :1], -1, hist), qpos], 1)  # [B, T]
    mask = ((kp[:, None, :] >= 0) & (kp[:, None, :] <= qpos[:, :, None]))[:, None]
    qh = q.permute(0, 2, 3, 1, 4).reshape(B, Hkv * G, C, dh)
    call = lambda: F.scaled_dot_product_attention(qh, kg, vg, attn_mask=mask, scale=scale,
                                                  enable_gqa=True)
    return call, gather


def batched_kernel_checks(cfg, red, k8, kv_int8=False) -> dict:
    """The batched kernel 8 (8q over an int8 pool) against its plain version
    per query row: at the served width, 8 rows of 256-query chunks over 0,
    256, 1008 and 1777 tokens of history, one row inactive and one of 40
    queries and padding (timed from CUDA graphs beside its bound, SDPA over
    gathered K/V and the same rows as 8 single-row launches); at the
    reduced heads with a window and a softcap in bf16 and f32.  Padded
    queries and the inactive row must be exactly 0."""
    from repro_torch.launch.paged_kernels import (BATCHED, BATCHED_VALID, batched_case,
                                                  single_row_launches)

    name = "paged_prefill_attention_batched" + ("_int8" if kv_int8 else "")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    G, rG = cfg.num_heads // cfg.num_kv_heads, red.num_heads // red.num_kv_heads
    served = dict(scale=1.0 / math.sqrt(cfg.head_dim))
    ws = dict(scale=1.0 / math.sqrt(red.head_dim), window=37, softcap=20.0)
    small = ([30, None, 0, 9], [40, 0, 13, 40], 40, red.num_kv_heads, rG, red.head_dim, 8, 30, 16)
    out = {}
    for label, case, dt, kw, tol, timed in (
            ("bf16_served", (BATCHED, BATCHED_VALID, 256, cfg.num_kv_heads, G, cfg.head_dim, 16,
                             8 * 128 + 1, 128), torch.bfloat16, served, BF16_TOL, True),
            ("bf16_window_softcap", small, torch.bfloat16, ws, BF16_TOL, False),
            ("f32_window_softcap", small, torch.float32, ws, F32_TOL, False)):
        args, qkw, info = batched_case(gen, *case, dt, kv_int8)
        kwa = dict(kw, **qkw)
        info.update(check_paged(name, k8.paged_prefill_attention_batched,
                                k8.paged_prefill_attention_batched_plain, args, kwa, tol,
                                timed=timed, library=sdpa_prefill_batched))
        pad = args[5] < 0
        if k8.paged_prefill_attention_batched(*args, **kwa)[pad].abs().max().item() != 0:
            raise AssertionError(f"{name}: a padded query or an inactive row is not exactly 0")
        if timed:
            info["single_row_launches_ms"] = graph_ms(single_row_launches(args, kwa), n=5)
        out[label] = info
        log(f"kernel {name} {label}: {json.dumps(info)}")
    return out


# ---------------------------------------------------------------------------
# Speculative decoding
# ---------------------------------------------------------------------------

# drafted tokens per verify window in every speculative phase
SPEC_K = 4
# phase 11b, the paper's pairing at published sizes: 8 requests of CONT_NEW
# new tokens with prompts of 64-512 tokens on a paged pool of 16-token pages
NLG_SPEC_PROMPTS = [64, 512, 300, 128, 450, 200, 96, 384]
NLG_SPEC_POOL = dict(slots=8, capacity=1024, page_size=16, prefill_chunk=256)
# the verify pass's batched kernel 8 at C = SPEC_K + 1: 8 rows, one per slot,
# over the phase-4 trace's histories, one row inactive
VERIFY_HISTS = [1500, 1200, None, 700, 512, 300, 1777, 100]


def swiglu_experts(cfg) -> bool:
    """Whether the config's MoE layers have SwiGLU experts, which launch an
    expert kernel (GELU experts are plain products, as in JAX)."""
    return any(ls.ffn.kind == "moe" and ls.ffn.act == "swiglu" for ls in cfg.layer_specs())


def moe_launches(cfg, params, n_calls, want) -> None:
    """Add ``n_calls`` MoE layer calls of ``cfg`` to ``want``: kernel 1 under
    the capacity dispatch, and the expert kernel for SwiGLU experts."""
    if not n_calls:
        return
    if capacity(cfg):
        want["moe_gating"] += n_calls
    if swiglu_experts(cfg):
        want[expert_kernel(cfg, params)] += n_calls


def spec_expected_launches(cfg, params, dcfg, dparams, launches, eng, kv8=False) -> dict:
    """Every kernel's launches in a speculative run (chunked admission): per
    global (paged) layer, the batched kernel 8 once per verify tick, and
    once more per tick for the committed recurrent-state pass of a target
    with per-slot state, and the single-row kernel 8 once per admission
    chunk; kernel 7 never, and no kernel for a ring's chunk or an SSD / LRU
    layer; per MoE layer call of the target (one per verify, commit pass and
    chunk) and of the drafter (one per sync and per propose step, k + 1 a
    propose) kernel 1 under the capacity dispatch and the SwiGLU expert
    kernel; the drafter's kernel 6 once per attention layer per sync (its
    decode steps attend through the plain ``_sdpa``)."""
    from repro_torch.models.model import arch_fully_paged

    sfx = "_int8" if kv8 else ""
    verifies = sum("spec" in m for m in eng.metrics_log)
    passes = verifies * (1 if arch_fully_paged(cfg) else 2)
    calls = eng.prefill_calls_total
    d = eng.drafter
    n_moe = lambda c: sum(ls.ffn.kind == "moe" for ls in c.layer_specs())
    n_global = layer_counts(cfg)[0]
    want = {k: 0 for k in launches}
    want[f"paged_prefill_attention_batched{sfx}"] = n_global * passes
    want[f"paged_prefill_attention{sfx}"] = n_global * calls
    want["flash_attention"] = sum(layer_counts(dcfg)) * d.syncs
    moe_launches(cfg, params, n_moe(cfg) * (passes + calls), want)
    moe_launches(dcfg, dparams, n_moe(dcfg) * (d.syncs + d.proposes * (SPEC_K + 1)), want)
    return want


def spec_trace(cfg, params, dcfg, dparams, counters, pool, lens, kv_cache_bits=0, what="spec",
               seed=SEED + 1):
    """One trace (prompts of ``lens`` tokens drawn from ``seed``, CONT_NEW new
    tokens each) through the paged engine twice: without speculation (the
    baseline: kernel 7 every decode tick) and with the drafter (``dcfg``,
    ``dparams``) at k = SPEC_K (kernel 7 never; the batched kernel 8 once per
    layer per verify tick).  Counts set to 0 before each run and read after,
    each against its expected count; both pools drain.  Returns (lines, the
    spec run's launches, the baseline's, a summary)."""
    from repro_torch.serving.continuous import ContinuousEngine
    from repro_torch.serving.engine import Request

    rng = torch.Generator().manual_seed(seed)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist() for n in lens]
    sfx = "_int8" if kv_cache_bits else ""
    runs = {}
    for label, spec in (("baseline", {}),
                        ("spec", dict(spec_draft=(dcfg, dparams), spec_k=SPEC_K))):
        eng = ContinuousEngine(cfg, params, paged=True, device="cuda", kv_cache_bits=kv_cache_bits,
                               **pool, **spec)
        eng.submit(Request(prompts[0][:300], 2 * SPEC_K))  # warm-up
        eng.run_until_done()
        clear_run_state(eng)
        if eng.drafter is not None:
            eng.drafter.syncs = eng.drafter.proposes = 0
        torch.cuda.synchronize()
        reset(*counters)
        ids, wall, ttft = timed_run(eng, lambda: [eng.submit(Request(p, CONT_NEW)) for p in prompts])
        launches = read(counters, f"{what} {label}")
        done = eng.done
        toks = [done[i].tokens for i in ids]
        assert sorted(done) == sorted(ids) and all(len(t) == CONT_NEW for t in toks), toks
        assert all(0 <= t < cfg.vocab_size for r in toks for t in r)
        if eng.pool.free_count != eng.n_pages or (eng.prefix is not None and len(eng.prefix)):
            raise AssertionError(f"{what} {label}: the pool or the prefix index did not drain")
        ticks = [m for m in eng.metrics_log if m["tokens_this_tick"]]
        if spec:
            want = spec_expected_launches(cfg, params, dcfg, dparams, launches, eng,
                                          kv8=bool(kv_cache_bits))
        else:
            want = expected_launches(cfg, params, launches, eng, len(ticks), kv8=bool(kv_cache_bits))
            if any(ls.ffn.kind == "moe" for ls in cfg.layer_specs()) and not swiglu_experts(cfg):
                want[expert_kernel(cfg, params)] = 0
        if launches != want:
            raise AssertionError(f"{what} {label} launches {launches}, expected {want}")
        runs[label] = dict(eng=eng, wall=wall, ttft=ttft, toks=toks, launches=launches,
                           ticks=ticks, n_tok=sum(len(t) for t in toks))
    base, sp = runs["baseline"], runs["spec"]
    eng = sp["eng"]
    recs = [m["spec"] for m in eng.metrics_log if "spec" in m]
    tot = {k: sum(r.get(k, 0) for r in recs) for k in ("windows", "drafted", "accepted",
                                                       "emitted", "resyncs")}
    if sp["launches"][f"paged_decode_attention{sfx}"] or not recs:
        raise AssertionError(f"{what}: kernel 7 launched in the speculative run, or no verify tick")
    spec_ticks = [m for m in eng.metrics_log if "spec" in m]
    med = {k: statistics.median(m[k] for m in spec_ticks) * 1e3
           for k in ("decode_s", "plan_s", "draft_s", "verify_s", "commit_s")}
    same = sum(a == b for a, b in zip(sp["toks"], base["toks"]))
    summary = {
        **tot, "accept_share": tot["accepted"] / max(tot["drafted"], 1),
        "tokens_per_verify": tot["emitted"] / max(tot["windows"], 1),
        "verify_ticks": len(recs), "drafter_syncs": eng.drafter.syncs,
        "drafter_proposes": eng.drafter.proposes,
        "tick_ms": med["decode_s"], "plan_ms": med["plan_s"], "draft_ms": med["draft_s"],
        "verify_ms": med["verify_s"], "commit_ms": med["commit_s"],
        "tok_s": sp["n_tok"] / sp["wall"], "baseline_tok_s": base["n_tok"] / base["wall"],
        "baseline_tick_ms": statistics.median(m["decode_s"] for m in base["ticks"]) * 1e3,
        "ttft_median_ms": statistics.median(sp["ttft"]),
        "baseline_ttft_median_ms": statistics.median(base["ttft"]),
        "preemptions": eng.preemptions, "baseline_preemptions": base["eng"].preemptions,
        "cow_copies": eng.cow_copies, "requests_equal_to_baseline": same,
        "requests": len(sp["toks"]),
    }
    lines = [
        f"{what}: {len(lens)} requests x {CONT_NEW} tokens (prompts {lens}), k = {SPEC_K}, drafter "
        f"{dcfg.name}{' (the target itself)' if dparams is params else ''}: {tot['windows']} "
        f"windows, {tot['drafted']} drafted, {tot['accepted']} accepted (share "
        f"{summary['accept_share']:.3f}), {tot['emitted']} emitted "
        f"({summary['tokens_per_verify']:.3f} per verify) over {len(recs)} verify ticks; "
        f"{eng.drafter.syncs} drafter syncs ({eng.spec_resyncs} resyncs), "
        f"{eng.drafter.proposes} proposes",
        f"{what}: {sp['wall'] * 1e3:.3f} ms ({summary['tok_s']:.1f} tok/s) against the baseline's "
        f"{base['wall'] * 1e3:.3f} ms ({summary['baseline_tok_s']:.1f} tok/s); spec tick median "
        f"{med['decode_s']:.3f} ms = plan {med['plan_s']:.3f} + draft {med['draft_s']:.3f} + "
        f"verify {med['verify_s']:.3f} + commit {med['commit_s']:.3f} (medians of each), "
        f"baseline decode tick median {summary['baseline_tick_ms']:.3f} ms; TTFT median "
        f"{summary['ttft_median_ms']:.3f} ms (baseline {summary['baseline_ttft_median_ms']:.3f}); "
        f"preemptions {eng.preemptions} (baseline {base['eng'].preemptions}); CoW copies "
        f"{eng.cow_copies}; pools drained",
        f"{what}: launches {sp['launches']} (baseline {base['launches']}); requests whose tokens "
        f"equal the baseline's: {same} of {len(sp['toks'])}",
        f"{what}: TTFT ms per request {sp['ttft']}",
        f"{what}: tokens of request 0: {sp['toks'][0]} (baseline {base['toks'][0]})",
    ]
    return lines, sp["launches"], base["launches"], summary


def spec_reference_checks(red_grouped, red_cap, red_glm4) -> list:
    """Speculative decoding on a small input: reduced f32 weights on the card
    (kernels) and on the CPU (plain versions), 14 pages for 3 slots of 48 so
    that the pool preempts, k = SPEC_K: llama4 grouped with a seed-1
    drafter, prefix sharing and ``submit_n``; the same over an int8 pool;
    llama4 under its own capacity dispatch with itself as the drafter;
    glm4-9b with a seed-1 drafter.  Identical tokens, per-tick spec records,
    preemptions and CoW copies; drained pools and indexes."""
    from repro_torch.models.model import init_params
    from repro_torch.serving.continuous import ContinuousEngine
    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(SEED + 7)
    draw = lambda n: rng.integers(1, red_grouped.vocab_size, n).tolist()
    pre = draw(8)  # two pages of 4
    prompts = [pre + draw(5), pre + draw(9), draw(6), pre + draw(17), draw(30), draw(13)]
    fork = pre + draw(3)
    paged = dict(paged=True, slots=3, capacity=48, page_size=4, n_pages=14, prefill_chunk=8,
                 spec_k=SPEC_K)
    cases = [("llama4 grouped, seed-1 drafter, prefix sharing", red_grouped, 1,
              dict(paged, prefix_sharing=True)),
             ("llama4 grouped, seed-1 drafter, int8 pool", red_grouped, 1,
              dict(paged, kv_cache_bits=8)),
             ("llama4 own capacity dispatch, self drafter", red_cap, 0, paged),
             ("glm4-9b, seed-1 drafter, batched prefill", red_glm4, 1,
              dict(paged, prefill_mode="batched"))]
    lines, preempted = [], 0
    for label, cfg, dseed, kw in cases:
        target = init_params(cfg, seed=SEED, device="cuda")
        draft = target if dseed == 0 else init_params(cfg, seed=SEED + dseed, device="cuda")
        recs = []
        for dev in ("cuda", "cpu"):
            tp = target if dev == "cuda" else copy.deepcopy(target).to("cpu")
            dp = (draft if dev == "cuda" else copy.deepcopy(draft).to("cpu")) if dseed else tp
            eng = ContinuousEngine(cfg, tp, device=dev, spec_draft=(cfg, dp), **kw)
            ids = eng.submit_n(Request(fork, 9), 2) + [eng.submit(Request(p, 9)) for p in prompts]
            done = eng.run_until_done()
            eng.pool.check()
            recs.append({"tokens": [done[i].tokens for i in ids],
                         "spec": [m["spec"] for m in eng.metrics_log if "spec" in m],
                         "preemptions": eng.preemptions, "cow_copies": eng.cow_copies,
                         "drained": eng.pool.free_count == eng.n_pages
                         and (eng.prefix is None or not len(eng.prefix))})
        if recs[0] != recs[1] or not recs[0]["drained"]:
            raise AssertionError(f"spec reference {label}: card {recs[0]}, CPU {recs[1]}")
        r = recs[0]
        preempted += r["preemptions"]
        drafted = sum(s["drafted"] for s in r["spec"])
        accepted = sum(s["accepted"] for s in r["spec"])
        lines.append(f"spec reference: reduced {cfg.name} f32 ({cfg.moe_impl}), {label}, card "
                     f"(kernels) vs CPU (plain versions): tokens and {len(r['spec'])} per-tick "
                     f"spec records identical ({accepted} of {drafted} drafts accepted), "
                     f"preemptions {r['preemptions']}, CoW copies {r['cow_copies']} on both; pools "
                     f"drained")
    if not preempted:
        raise AssertionError("no spec reference case preempted; the pool was meant to run dry")
    return lines


def nlg_spec_serve(counters) -> tuple:
    """The paper's pairing at published sizes: the dense nlg-350m (the
    student) drafting for nlg-350m-moe128 (the MoE teacher, 24 layers, 128
    GELU experts, its own ``moe_impl="dense"``: kernel 1 on every MoE call),
    bf16 random weights from seeds, both vocabularies 51200, through the
    paged engine on NLG_SPEC_PROMPTS at k = SPEC_K beside the non-speculative
    run (``spec_trace``)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import init_params

    cfg, dcfg = get_config("nlg-350m-moe128"), get_config("nlg-350m")
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=SEED, device="cuda")
    dparams = init_params(dcfg, seed=SEED + 1, device="cuda")
    lines, launches, base, summary = spec_trace(cfg, params, dcfg, dparams, counters,
                                                NLG_SPEC_POOL, NLG_SPEC_PROMPTS,
                                                what="spec nlg pairing", seed=SEED + 17)
    lines.append(f"spec nlg pairing: peak memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    return lines, launches, base, summary


def verify_kernel_checks(cfg, red, k8, kv_int8=False) -> dict:
    """The batched kernel 8 (8q) at the verify pass's shape, C = SPEC_K + 1
    queries a row, against its plain version per query row: at the served
    width over VERIFY_HISTS (timed from CUDA graphs beside its bound, SDPA
    over gathered K/V and the same rows as single-row launches), and at
    glm4-9b's heads (G = 16, dh 128), nlg-350m-moe128's (G = 1, dh 64) and
    the reduced heads with a window and a softcap, where G * C query rows
    fill part of a tile.  Padded queries and the inactive row must be 0."""
    from repro_torch.launch.paged_kernels import batched_case, single_row_launches

    name = "paged_prefill_attention_batched" + ("_int8" if kv_int8 else "")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    C = SPEC_K + 1
    G = cfg.num_heads // cfg.num_kv_heads
    valid = [0 if h is None else C for h in VERIFY_HISTS]
    valid[-1] = 2  # a window clamped by the budget: 2 queries and padding
    ws = dict(scale=1.0 / math.sqrt(red.head_dim), window=37, softcap=20.0)
    rG = red.num_heads // red.num_kv_heads
    out = {}
    for label, case, kw, timed in (
            ("bf16_verify_c5", (VERIFY_HISTS, valid, C, cfg.num_kv_heads, G, cfg.head_dim, 16,
                                8 * 128 + 1, 128), dict(scale=1.0 / math.sqrt(cfg.head_dim)), True),
            ("bf16_verify_c5_glm4_heads", ([300, None, 17], [C, 0, 3], C, 2, 16, 128, 16, 60, 32),
             dict(scale=128 ** -0.5), False),
            ("bf16_verify_c5_nlg_heads", ([300, 9, None], [C, C, 0], C, 16, 1, 64, 16, 60, 32),
             dict(scale=64 ** -0.5), False),
            ("bf16_verify_c5_window_softcap", ([30, None, 0, 9], [C, 0, 2, C], C, red.num_kv_heads,
                                               rG, red.head_dim, 8, 30, 16), ws, False)):
        args, qkw, info = batched_case(gen, *case, torch.bfloat16, kv_int8)
        kwa = dict(kw, **qkw)
        info.update(check_paged(name, k8.paged_prefill_attention_batched,
                                k8.paged_prefill_attention_batched_plain, args, kwa, BF16_TOL,
                                timed=timed, library=sdpa_prefill_batched))
        pad = args[5] < 0
        if k8.paged_prefill_attention_batched(*args, **kwa)[pad].abs().max().item() != 0:
            raise AssertionError(f"{name} {label}: a padded query or an inactive row is not 0")
        if timed:
            info["single_row_launches_ms"] = graph_ms(single_row_launches(args, kwa), n=5)
        out[label] = info
        log(f"kernel {name} {label}: {json.dumps(info)}")
    return out


# ---------------------------------------------------------------------------
# Quantized serving (MoQ int8 / int4 experts, int8 KV cache)
# ---------------------------------------------------------------------------


def quant_static_serve(cfg, params, qparams, reqs, counters, fp_tokens,
                       what="quantized serve", profile=True) -> list:
    """The static path with int8 experts and an int8 KV cache: the same 4
    requests; kernel 5 on every MoE call (under the capacity dispatch
    kernels 1 and 3), kernel 9 on every decode layer, no fp kernel."""
    from repro_torch.models.model import init_caches
    from repro_torch.quant import kv_cache_bytes, tree_bytes
    from repro_torch.serving.engine import Engine, EngineConfig

    torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, qparams, EngineConfig(max_batch=BATCH, max_prefill=PROMPT, max_decode=NEW,
                                            kv_cache_bits=8), device="cuda")
    eng.generate(reqs)  # warm-up
    torch.cuda.synchronize()
    reset(*counters)
    t0 = time.perf_counter()
    out = eng.generate(reqs)
    wall = time.perf_counter() - t0
    got = read(counters, what)
    assert len(out) == BATCH and all(len(r.tokens) == NEW for r in out)
    assert all(0 <= tok < cfg.vocab_size for r in out for tok in r.tokens)
    n_moe = sum(ls.ffn.kind == "moe" for ls in cfg.layer_specs())
    want = {k: 0 for k in got}
    want.update({expert_kernel(cfg, qparams): n_moe * NEW, "flash_attention": cfg.num_layers,
                 "decode_attention_quant": cfg.num_layers * (NEW - 1)})
    if capacity(cfg):
        want["moe_gating"] = n_moe * NEW
    if got != want:
        raise AssertionError(f"{what} launches {got}, expected {want}")
    tm = eng.last_timings
    step_ms = statistics.median(tm["decode_step_s"]) * 1e3
    fp_experts = sum(v.numel() * v.element_size() for k, v in params.named_buffers()
                     if ".moe.w" in k)
    q_experts = tree_bytes(qparams, only_quantized=True)
    kv = [kv_cache_bytes(init_caches(cfg, BATCH, PROMPT + NEW, kv_bits=b, device="meta"))
          for b in (0, 8)]
    same = sum(a == b for r, f in zip(out, fp_tokens) for a, b in zip(r.tokens, f))
    lines = [
        f"{what} (int8 experts, int8 KV): {BATCH} requests x {NEW} tokens in "
        f"{wall * 1e3:.3f} ms ({BATCH * NEW / wall:.1f} tok/s); prefill {tm['prefill_s'] * 1e3:.3f} ms; "
        f"decode step median {step_ms:.3f} ms over {len(tm['decode_step_s'])} steps; launches {got}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB",
        f"{what}: expert bytes {q_experts / 1e9:.3f} GB int8 vs {fp_experts / 1e9:.3f} GB "
        f"bf16 ({fp_experts / q_experts:.2f}x); KV cache {kv[1] / 1e6:.3f} MB int8 vs "
        f"{kv[0] / 1e6:.3f} MB bf16 ({kv[0] / kv[1]:.2f}x); greedy tokens equal to the bf16 "
        f"serve's at {same} of {BATCH * NEW} positions",
        f"{what}: tokens of request 0: {out[0].tokens}",
    ]
    if profile:
        lines += profile_decode(eng, cfg, qparams, what="quantized decode", named_ops=QUANT_WRITE_OPS)
        lines.append(drift_check(eng, cfg, qparams, what))
    return lines, got


def drift_check(eng, cfg, qparams, what) -> str:
    """Phase 7: one decode step of the int8 engine captured; no int8 / int4
    -> float cast of 4096 elements or more outside the kernel entries."""
    from repro_torch.analysis.graph import audit_dtype_drift, capture

    fn, args = decode_capture_args(eng, cfg, qparams)
    cap = capture(fn, *args)
    rep = audit_dtype_drift(cap, what)
    casts = [r for r in cap.of("aten") if r.name == "aten._to_copy.default" and r.inputs
             and r.inputs[0].dtype == torch.int8]
    if rep.errors:
        raise AssertionError(f"{what}: {rep.render()}")
    return (f"graph audit: {what} decode step: no int8 / int4 -> float cast of 4096 elements or "
            f"more outside the kernels ({len(casts)} smaller int8 casts); kernel entries "
            f"{cap.kernels()}")


def quant_reference_checks(cfg) -> list:
    """Reduced f32 llama4 with quantized experts and an int8 KV cache, card
    (kernels 5, 9, 7q, 8q) against the CPU (plain versions), from the same
    weights: int8 and int4 experts through the static path (logits of a
    prefill and 3 decode steps within F32_TOL relative, greedy tokens of
    ``Engine`` identical), int8 through the continuous trace (tokens and
    preemptions identical), and policy ``all`` through ``Engine`` (the
    materialize sites: attention projections, dense FFN, residual expert,
    unembed)."""
    from repro_torch.configs.base import QuantConfig
    from repro_torch.models.model import decode_step, init_caches, init_params, prefill
    from repro_torch.quant import quantize_params
    from repro_torch.serving.engine import Engine, EngineConfig, Request

    fp = init_params(cfg, seed=SEED, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (3, 12), generator=torch.Generator().manual_seed(SEED))
    reqs = [Request(toks[i, : 12 - 3 * i].tolist(), 8) for i in range(3)]
    ec = EngineConfig(max_batch=4, max_prefill=12, max_decode=8, kv_cache_bits=8)
    lines = []
    for bits, policy in ((8, "experts"), (4, "experts"), (8, "all")):
        on_card = quantize_params(fp, QuantConfig(bits=bits, policy=policy))
        on_cpu = copy.deepcopy(on_card).to("cpu")
        rel = 0.0
        if policy == "experts":
            caches = {d: init_caches(cfg, 3, 16, kv_bits=8, device=d) for d in ("cuda", "cpu")}
            a, caches["cuda"] = prefill(cfg, on_card, toks.cuda(), caches["cuda"])
            b, caches["cpu"] = prefill(cfg, on_cpu, toks, caches["cpu"])
            for step in range(4):
                rel = max(rel, (a.cpu() - b).abs().max().item() / b.abs().max().item())
                cur = b.argmax(-1)[:, None]
                if step < 3:
                    a, caches["cuda"] = decode_step(cfg, on_card, cur.cuda(), 12 + step, caches["cuda"])
                    b, caches["cpu"] = decode_step(cfg, on_cpu, cur, 12 + step, caches["cpu"])
            if rel > F32_TOL:
                raise AssertionError(f"reduced int{bits} {policy}: card logits differ from the CPU's "
                                     f"by {rel:.3e} relative")
        card = [r.tokens for r in Engine(cfg, on_card, ec, device="cuda").generate(reqs)]
        cpu = [r.tokens for r in Engine(cfg, on_cpu, ec, device="cpu").generate(reqs)]
        if card != cpu:
            raise AssertionError(f"reduced int{bits} {policy}: greedy tokens on the card {card} != CPU {cpu}")
        lines.append(f"quantized reference: reduced {cfg.name} f32, int{bits} {policy} + int8 KV, "
                     f"static, card (kernels) vs CPU (plain versions): "
                     + (f"prefill + 3 decode logits max|d| {rel:.3e} of max|logit| (tolerance "
                        f"{F32_TOL}), " if policy == "experts" else "")
                     + f"greedy tokens identical {card}")
    q8 = quantize_params(fp, QuantConfig(bits=8))
    lines.append(continuous_reference_check(cfg, q8, kv_cache_bits=8))
    return lines


def int4_experts(moe) -> dict:
    """The served MoE layer's experts quantized to int4 (per output column),
    beside its router."""
    from repro_torch.quant.qarrays import QuantizedArray

    out = {n: QuantizedArray.quantize(moe[n], bits=4) for n in ("wi", "wg", "wo")}
    out["router"] = moe["router"]
    return out


def decode_quant_case(B, T, filled, Hkv, G, dh, dtype, gen, kpos=None, qpos=None, kv=None):
    """Kernel 9's inputs: random queries over a contiguous int8 cache (``kv``,
    or random K/V quantized as the cache writes them) whose first ``filled``
    slots of every row hold positions 0 .. filled - 1, the query at position
    filled - 1; the bound reads K/V of the keys at 0 <= pos <= qpos, every
    position, q, out and qpos."""
    from repro_torch.quant.kv import kv_quantize_values

    if kv is None:
        kv = [kv_quantize_values(torch.randn((B, T, Hkv, dh), generator=gen, device="cuda").to(dtype))
              for _ in range(2)]
    (kq, ks), (vq, vs) = kv
    if kpos is None:
        kpos = torch.full((B, T), -1, dtype=torch.int32, device="cuda")
        kpos[:, :filled] = torch.arange(filled, dtype=torch.int32, device="cuda")
    if qpos is None:
        qpos = torch.full((B,), filled - 1, dtype=torch.int32, device="cuda")
    q = torch.randn((B, Hkv, G, dh), generator=gen, device="cuda").to(dtype)
    needed = (kpos >= 0) & (kpos <= qpos[:, None])
    keys = int(needed.sum().item())
    b = q.element_size()
    need = keys * 2 * Hkv * key_bytes(kq) + kpos.numel() * 4 + 2 * q.numel() * b + B * 4
    info = {"B": B, "T": T, "Hkv": Hkv, "G": G, "dh": dh, "pairs": keys,
            **bound(need, 4 * Hkv * G * dh * keys, dtype)}
    return (q, kq, ks, vq, vs, kpos, qpos), info


def decode_quant_redesign_checks(cfg, G, k9) -> dict:
    """Kernel 9 in bf16 where its split-K walk over live tiles has the most
    to do: a static cache sized for 64-token prompts and 2048 new tokens at
    its first decode step (4 x 2112 slots, 80 filled) and a 16392-slot cache
    with 8 keys filled (every split but one finds no live tile), both timed
    from CUDA graphs beside SDPA; a ring whose live slots wrap with a window
    (row 1 has no valid key and must give 0), glm4-9b's heads (G = 16) and
    nlg-350m-moe128's (G = 1, dh 64); each held per query row.  Its inputs
    come from a generator of its own, so the checks after it see the same
    inputs whatever it draws."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    out = {}
    for case, (B, T, filled, Hkv, g, dh, timed) in (
            ("2112_filled80", (4, 2112, 80, cfg.num_kv_heads, G, cfg.head_dim, True)),
            ("16392_filled8", (1, LONG_PROMPT + 8, 8, cfg.num_kv_heads, G, cfg.head_dim, True)),
            ("glm4_heads", (3, 300, 50, 2, 16, 128, False)),
            ("nlg_heads", (3, 300, 50, 16, 1, 64, False))):
        args, info = decode_quant_case(B, T, filled, Hkv, g, dh, torch.bfloat16, gen)
        info.update(check_paged("decode_attention_quant", k9.decode_attention_quant,
                                k9.decode_attention_quant_plain, args,
                                dict(scale=1.0 / math.sqrt(dh)), BF16_TOL, timed=timed,
                                library=sdpa_contiguous))
        out[f"bf16_{case}"] = info
        log(f"kernel decode_attention_quant bf16 {case}: {json.dumps(info)}")
    ring = torch.roll(torch.arange(1000, 1300, dtype=torch.int32, device="cuda"), 123)
    kpos = torch.stack([ring, torch.full_like(ring, -1), ring]).contiguous()
    qpos = torch.tensor([1299, 5, 1250], dtype=torch.int32, device="cuda")
    kw = dict(scale=1.0 / math.sqrt(cfg.head_dim), window=200, softcap=20.0)
    args, info = decode_quant_case(3, 300, 0, cfg.num_kv_heads, G, cfg.head_dim, torch.bfloat16,
                                   gen, kpos=kpos, qpos=qpos)
    info.update(check_paged("decode_attention_quant", k9.decode_attention_quant,
                            k9.decode_attention_quant_plain, args, kw, BF16_TOL))
    if k9.decode_attention_quant(*args, **kw)[1].abs().max().item() != 0:
        raise AssertionError("kernel 9: a row with no valid key must give 0")
    out["bf16_ring_window_softcap"] = info
    log(f"kernel decode_attention_quant bf16 ring (live slots wrap at slot 123), window 200, "
        f"softcap 20, a row with no valid key: {json.dumps(info)}")
    return out


def sdpa_contiguous(q, kq, ks, vq, vs, kpos, qpos, scale, window=0):
    """Kernel 9's yardstick: the cache dequantized into [B, Hkv, T, dh]
    beforehand, then scaled_dot_product_attention with the same mask (the
    window included)."""
    import torch.nn.functional as F

    B, Hkv, G, dh = q.shape

    def gather():
        kg = (kq.float() * ks).to(q.dtype).transpose(1, 2).contiguous()
        vg = (vq.float() * vs).to(q.dtype).transpose(1, 2).contiguous()
        return kg, vg

    kg, vg = gather()
    mask = (kpos >= 0) & (kpos <= qpos[:, None])
    if window > 0:
        mask = mask & (qpos[:, None] - kpos < window)
    mask = mask[:, None, None, :]
    qh = q.reshape(B, Hkv * G, 1, dh)
    call = lambda: F.scaled_dot_product_attention(qh, kg, vg, attn_mask=mask, scale=scale,
                                                  enable_gqa=True)
    return call, gather


# ---------------------------------------------------------------------------
# Capacity dispatch (kernels 1, 2, 3)
# ---------------------------------------------------------------------------


def capacity(cfg) -> bool:
    """Whether the config's MoE layers take the capacity dispatch (the
    gating kernel and the [E, C, D] expert kernels)."""
    from repro_torch.core.moe import NO_MESH_IMPL

    return NO_MESH_IMPL.get(cfg.moe_impl, cfg.moe_impl) != "grouped"


def expert_kernel(cfg, params) -> str:
    """The counter of the expert kernel the config's MoE layers launch."""
    if capacity(cfg):
        return "expert_mlp_quant" if quant_experts(params) else "expert_mlp"
    return "grouped_mlp_quant" if quant_experts(params) else "grouped_mlp"


@contextlib.contextmanager
def recorded_gating():
    """Record the (keep, capacity) of every capacity gating call the MoE
    layers make inside the block."""
    import repro_torch.core.moe as cm

    real, seen = cm.gating, []

    def rec(logits, top_k, cap, **kw):
        g, counts = real(logits, top_k, cap, **kw)
        seen.append((g.keep, cap))
        return g, counts

    cm.gating = rec
    try:
        yield seen
    finally:
        cm.gating = real


def dropped_share(seen):
    """(dropped assignments, all assignments) over the recorded calls."""
    dropped = sum(int((~keep).sum().item()) for keep, _ in seen)
    return dropped, sum(keep.numel() for keep, _ in seen)


def capacity_static_serve(cfg, params, reqs, counters, what="capacity serve"):
    """The 4 requests through ``Engine`` under the capacity dispatch; the
    launch counts set to 0 before and read after: kernel 1 and the expert
    kernel once per MoE call.  Returns (lines, launches, tokens, engine)."""
    from repro_torch.analysis.graph import audit_dead_compute, capture
    from repro_torch.models.model import init_caches, prefill
    from repro_torch.serving.engine import Engine, EngineConfig

    eng = Engine(cfg, params, EngineConfig(max_batch=BATCH, max_prefill=PROMPT, max_decode=NEW),
                 device="cuda")
    eng.generate(reqs)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset(*counters)
    t0 = time.perf_counter()
    out = eng.generate(reqs)
    wall = time.perf_counter() - t0
    got = read(counters, what)
    assert len(out) == BATCH and all(len(r.tokens) == NEW for r in out)
    assert all(0 <= tok < cfg.vocab_size for r in out for tok in r.tokens)
    n_moe = sum(ls.ffn.kind == "moe" for ls in cfg.layer_specs())
    want = {k: 0 for k in got}
    want.update({"moe_gating": n_moe * NEW, expert_kernel(cfg, params): n_moe * NEW,
                 "flash_attention": cfg.num_layers})
    if got != want:
        raise AssertionError(f"{what} launches {got}, expected {want}")
    tm = eng.last_timings
    step_ms = statistics.median(tm["decode_step_s"]) * 1e3
    # kernel 1's keep at the 256-token prefill of the same prompts
    toks = torch.tensor([r.prompt for r in reqs], device="cuda")
    with recorded_gating() as seen:
        cap = capture(prefill, cfg, params, toks, init_caches(cfg, BATCH, PROMPT + NEW,
                                                                device="cuda"))
    dropped, total = dropped_share(seen)
    ffn = next(ls.ffn for ls in cfg.layer_specs() if ls.ffn.kind == "moe")
    dead = audit_dead_compute(cap, what, num_tokens=BATCH * PROMPT, num_experts=ffn.num_experts,
                              top_k=ffn.top_k, capacity_factor=ffn.capacity_factor, impl="ep")
    E = ffn.num_experts
    seen_pad = 1 - sum(int(keep.sum().item()) for keep, _ in seen) / sum(E * c for _, c in seen)
    measured = dead.metrics[f"graph.{what}.padded_fraction_measured"]
    if dead.errors or abs(measured - seen_pad) > 1e-12:
        raise AssertionError(f"{what}: dead compute {dead.render()}, the gating's fill "
                             f"{seen_pad}")
    del cap
    lines = [
        f"{what}: {cfg.name} moe_impl={cfg.moe_impl!r} (the config's own; without a mesh the "
        f"dense mapping table), {BATCH} requests x {NEW} tokens in {wall * 1e3:.3f} ms "
        f"({BATCH * NEW / wall:.1f} tok/s); prefill {tm['prefill_s'] * 1e3:.3f} ms (batch {BATCH} x "
        f"{PROMPT}); decode step median {step_ms:.3f} ms over {len(tm['decode_step_s'])} steps; "
        f"launches {got}; peak memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB",
        f"{what}: prefill of {BATCH * PROMPT} tokens, capacity {seen[0][1]} per expert: kernel 1 "
        f"dropped {dropped} of {total} assignments ({100 * dropped / total:.2f}%)",
        f"graph audit: {what} prefill: {dead.metrics[f'graph.{what}.expert_dots']} expert calls "
        f"over [E={E}, C={seen[0][1]}]; padded share {measured:.6f} measured from kernel 2's fill, "
        f"{seen_pad:.6f} from kernel 1's keep, {dead.metrics[f'graph.{what}.padded_fraction']} "
        f"analytic (every assignment routed)",
        f"{what}: tokens of request 0: {out[0].tokens}",
    ]
    return lines, got, [r.tokens for r in out], eng


def dense_vs_grouped_check(cfg, moe, gen) -> str:
    """The served MoE layer's routed experts (the shared expert left out),
    ``moe_layer`` under the dense dispatch against the grouped one on the
    same bf16 decode input (T = 4: capacity 8, nothing can drop): outputs
    within BF16_TOL of the largest, the same expert ids."""
    import dataclasses

    from repro_torch.core.gating import expert_capacity, top_k_gating
    from repro_torch.core.moe import moe_layer
    from repro_torch.kernels.moe_gating import gating

    spec = dataclasses.replace(cfg.layer_specs()[1].ffn, residual=False)
    x = torch.randn((1, BATCH, cfg.d_model), generator=gen, device="cuda").bfloat16()
    yd, _ = moe_layer(cfg, spec, moe, x, impl="dense")
    yg, _ = moe_layer(cfg, spec, moe, x, impl="grouped")
    torch.cuda.synchronize()
    res = compare("moe_layer dense vs grouped", yd, yg, BF16_TOL)
    logits = x[0].float() @ moe["router"]
    gd, _ = gating(logits, spec.top_k, expert_capacity(BATCH, spec.num_experts, spec.top_k,
                                                       spec.capacity_factor))
    gg = top_k_gating(logits, spec.top_k, BATCH * spec.top_k)
    if not torch.equal(gd.expert_idx, gg.expert_idx) or not bool(gd.keep.all()):
        raise AssertionError(f"dense vs grouped: expert ids {gd.expert_idx.tolist()} vs "
                             f"{gg.expert_idx.tolist()}, keep {gd.keep.tolist()}")
    return (f"dense vs grouped: the served MoE layer's routed experts, bf16, T = {BATCH}: "
            f"moe_layer(dense) vs moe_layer(grouped) max|d| {res['max_abs_err']:.3e} = "
            f"{res['max_rel_err']:.2e} of max|y| (tolerance {BF16_TOL}); expert ids identical "
            f"{gd.expert_idx.flatten().tolist()}, none dropped")


def capacity_reference_checks(red) -> list:
    """Reduced f32 llama4 under the capacity dispatch, card (kernels 1, 2, 3)
    against the CPU (plain versions), from the same weights: the static
    path under the config's own ``moe_impl`` and under ``einsum``, and at
    capacity factor 0.25, where the prefill drops (counted on the card);
    int8 and int4 experts (kernel 3; int4 takes the plain dequantize path
    on both); the continuous trace."""
    from repro_torch.configs.base import QuantConfig
    from repro_torch.configs.registry import with_capacity_factor
    from repro_torch.models.model import forward, init_params
    from repro_torch.quant import quantize_params

    lines = []
    fp = init_params(red, seed=SEED, device="cuda")
    toks = torch.randint(0, red.vocab_size, (3, 12), generator=torch.Generator().manual_seed(SEED))
    for label, cfg, params in (
            (f"moe_impl={red.moe_impl}", red, fp),
            ("moe_impl=einsum", red.replace(moe_impl="einsum"), fp),
            ("capacity factor 0.25", with_capacity_factor(red, 0.25), fp),
            ("int8 experts", red, quantize_params(fp, QuantConfig(bits=8))),
            ("int4 experts", red, quantize_params(fp, QuantConfig(bits=4)))):
        with recorded_gating() as seen, torch.no_grad():
            a, _ = forward(cfg, params, toks.cuda())
        dropped, total = dropped_share(seen)
        with torch.no_grad():
            b, _ = forward(cfg, copy.deepcopy(params).to("cpu"), toks)
        rel = (a.cpu() - b).abs().max().item() / b.abs().max().item()
        if rel > F32_TOL:
            raise AssertionError(f"reduced {label}: card logits differ from the CPU's by {rel:.3e}")
        if label.startswith("capacity") and dropped == 0:
            raise AssertionError("capacity factor 0.25: the reference dropped no assignment")
        line = reference_check(cfg, params)
        lines.append(f"capacity reference, {label}: forward logits max|d| {rel:.3e} of max|logit| "
                     f"(tolerance {F32_TOL}), {dropped} of {total} assignments dropped on the card; "
                     + line)
    lines.append("capacity " + continuous_reference_check(red))
    return lines


def gating_case(logits, K, cap):
    """Kernel 1's inputs and bound: the logits in, probs and the [T, K]
    outputs and the counts out; softmax and K masked argmaxes over each row
    as f32 operations."""
    T, E = logits.shape
    need = 2 * T * E * 4 + T * K * (4 + 4 + 4 + 1) + E * 4
    info = {"T": T, "E": E, "K": K, "capacity": cap, **bound(need, T * E * (4 + 2 * K), torch.float32)}
    return (logits.contiguous(), K, cap), info


def gating_agrees(g, counts, pg, pcounts) -> float:
    """Kernel 1's outputs against its plain version's: integer outputs
    identical, w and probs within 1e-6 (returned)."""
    torch.cuda.synchronize()
    for name in ("expert_idx", "position", "keep"):
        if not torch.equal(getattr(g, name), getattr(pg, name)):
            raise AssertionError(f"moe_gating {name} differs from its plain version")
    if not torch.equal(counts, pcounts):
        raise AssertionError(f"moe_gating counts {counts.tolist()} vs {pcounts.tolist()}")
    err = max((g.combine_w - pg.combine_w).abs().max().item(), (g.probs - pg.probs).abs().max().item())
    if err > 1e-6:
        raise AssertionError(f"moe_gating w / probs differ from the plain version by {err:.3e}")
    return err


def concurrent_gating_check(E, gen, T=256, calls=40) -> dict:
    """Kernel 1's one-launch path with more than one block (so its ticket
    counter) run at once: two streams issuing ``calls`` calls each without
    waiting, then two CUDA graphs of 10 calls replayed on the two streams
    ``calls`` times each; every output against its plain version
    (``gating_agrees``)."""
    from repro_torch.core.gating import expert_capacity
    from repro_torch.kernels import moe_gating as k1

    cap = expert_capacity(T, E, 1, 1.25)
    logits = [torch.randn((T, E), generator=gen, device="cuda") for _ in range(2)]
    plain = [k1.gating_plain(lg, 1, cap) for lg in logits]
    streams = [torch.cuda.Stream() for _ in logits]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(calls):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                outs[i].append(k1.gating(logits[i], 1, cap))
    torch.cuda.synchronize()
    err = max(gating_agrees(*o, *plain[i]) for i in range(2) for o in outs[i])
    del outs
    graphs, gouts = [], []
    for i, lg in enumerate(logits):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            gouts.append([k1.gating(lg, 1, cap) for _ in range(10)])
        graphs.append(graph)
    torch.cuda.synchronize()
    for _ in range(calls):
        for graph, s in zip(graphs, streams):
            with torch.cuda.stream(s):
                graph.replay()
    torch.cuda.synchronize()
    err = max(err, *(gating_agrees(*o, *plain[i]) for i in range(2) for o in gouts[i]))
    del graphs, gouts
    return {"T": T, "E": E, "K": 1, "capacity": cap, "blocks": -(-T // 8),
            "eager_calls": 2 * calls, "graph_replays": 2 * calls, "max_abs_err": err,
            "max_rel_err": err}


def check_gating(args, timed=False) -> dict:
    """Kernel 1 against its plain version: integer outputs identical, w and
    probs within 1e-6; and the path it took: one launch up to
    ``ONE_LAUNCH_SLOTS`` slots, two past it."""
    from repro_torch.kernels import moe_gating as k1

    before = dict(k1.variant_launches)
    g, counts = k1.gating(*args)
    took = [k for k, v in k1.variant_launches.items() if v != before[k]]
    T, E = args[0].shape
    want = "moe_gating_one_launch" if T * args[1] <= k1.ONE_LAUNCH_SLOTS else "moe_gating_two_launches"
    if took != [want]:
        raise AssertionError(f"moe_gating at T*K = {T * args[1]} took {took}, expected {want}")
    err = gating_agrees(g, counts, *k1.gating_plain(*args))
    res = {"max_abs_err": err, "max_rel_err": err, "dropped": int((~g.keep).sum().item()),
           "variant": want}
    if timed:
        # ms: the two passes' device time, from a CUDA graph of wrapper
        # calls; host_ms: one wrapper call as the MoE layer pays it (its
        # outputs' allocations and the ctypes call), which CUDA events
        # around back-to-back calls read
        res["ms"] = graph_ms(lambda: k1.gating(*args))
        res["host_ms"] = time_ms(lambda: k1.gating(*args))
        res["plain_ms"] = time_ms(lambda: k1.gating_plain(*args), n=3)
    return res


def capacity_expert_case(moe, T, K, gen, dtype, cf):
    """Kernel 2's (or 3's, for quantized ``moe``) inputs as the MoE layer
    builds them: T random tokens routed by the layer's router with
    ``expert_capacity``, scattered into the [E, C, D] buffer; the counts as
    fill (kernel 3 is also told the T*K assignments, as the layer tells
    it).  The bound counts the weights of the experts with tokens, the kept
    rows, the whole output and the fill, and 2*kept*3*D*F operations."""
    from repro_torch.core.dispatch import dispatch_dense
    from repro_torch.core.gating import expert_capacity
    from repro_torch.kernels.moe_gating import gating_plain
    from repro_torch.launch.expert_kernels import expert_bytes

    E, D, F = moe["wi"].shape
    cap = expert_capacity(T, E, K, cf)
    x = torch.randn((T, D), generator=gen, device="cuda").to(dtype)
    g, counts = gating_plain(x.float() @ moe["router"], K, cap)
    xe = dispatch_dense(x, g, cap, E)
    kept = int(counts.clamp(max=cap).sum().item())
    live = int((counts > 0).sum().item())
    b = xe.element_size()
    need = live * expert_bytes(moe) + (kept + E * cap) * D * b + E * 4
    info = {"T": T, "K": K, "C": cap, "kept": kept, "dropped": T * K - kept, "live_experts": live,
            **bound(need, 2 * kept * 3 * D * F, dtype)}
    args = (xe, moe["wi"], moe["wg"], moe["wo"], counts)
    if not torch.is_tensor(moe["wi"]):
        args += (T * K,)
    return args, info


def check_capacity_experts(args, tol, quant=False, variant=None, timed=False, n=20) -> dict:
    """Kernel 2 (or 3) against its plain version, per token row (a row past
    an expert's fill must come out 0 as the plain version's); kernel 3 also
    against the tensor-core order's plain version, and the variant it took
    must be ``variant`` ("mma" at the served widths in bf16, "fma" in f32);
    timed: ``ms`` from a CUDA graph of ``n`` calls, ``events_ms`` CUDA events
    around calls issued back to back, ``host_ms`` one wrapper call on the
    host's clock."""
    from repro_torch.kernels import expert_mlp as k2
    from repro_torch.kernels import expert_mlp_quant as k3
    from repro_torch.launch.attention_kernels import host_ms

    kernel, plain_fn = ((k3.expert_mlp_quant, k3.expert_mlp_quant_plain) if quant
                        else (k2.expert_mlp, k2.expert_mlp_plain))
    before = dict(k3.variant_launches)
    out = kernel(*args)
    torch.cuda.synchronize()
    if quant:
        took = [k.rsplit("_", 1)[1] for k, v in k3.variant_launches.items() if v != before[k]]
        if took != [variant]:
            raise AssertionError(f"expert_mlp_quant: took the {took} kernel, expected {variant}")
    t0 = time.perf_counter()
    plain = plain_fn(*args[:5])
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    res = {**compare_rows(kernel.__name__, out, plain, tol), "plain_ms": plain_ms}
    if quant:
        res["variant"] = variant
        res["vs_mma_plain"] = compare_rows(kernel.__name__ + " (tensor-core order)", out,
                                           k3.expert_mlp_quant_mma_plain(*args[:5]), tol)
    del out, plain
    if timed:
        fn = lambda: kernel(*args)
        res["ms"] = graph_ms(fn, n=n)
        res["events_ms"] = time_ms(fn, n=min(10, n), warmup=1)
        res["host_ms"] = host_ms(fn, n=n)
    return res


def nlg_serve(counters) -> tuple:
    """The paper's nlg-350m-moe128 at its published size, full depth (24
    layers, 128 GELU experts of d_ff 4096 on every other layer), bf16 random
    weights from the seed, through ``Engine`` with its own
    ``moe_impl="dense"``: kernel 1 once per MoE layer call, no expert kernel
    (GELU experts are plain products, as in the JAX package); then the same
    tree and requests under ``moe_impl="grouped"``: no kernel 1 and no
    expert kernel (GELU experts over the grouped layout are plain products
    over gathered tile weights, as JAX's ``grouped_mlp_ref``), kernel 6 once
    per layer; each with a profile of 5 decode steps; and the reduced f32
    model under grouped, card against CPU; and the dense engine under
    ``Obs(routing=True)`` (phase 4d).  Returns (lines, launches of the dense
    run, of the grouped run, of the routing run)."""
    from repro_torch.configs.registry import get_config, make_reduced
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import Engine, EngineConfig, Request

    cfg = get_config("nlg-350m-moe128")  # bf16, moe_impl "dense"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(b.numel() for b in params.buffers())
    init_s = time.perf_counter() - t0
    rng = torch.Generator().manual_seed(SEED + 4)
    reqs = [Request(torch.randint(0, cfg.vocab_size, (PROMPT,), generator=rng).tolist(), NEW)
            for _ in range(BATCH)]
    n_moe = sum(ls.ffn.kind == "moe" for ls in cfg.layer_specs())
    lines, runs = [], {}
    for impl in ("dense", "grouped"):
        rcfg = cfg.replace(moe_impl=impl)
        what = "nlg serve" + (" grouped" if impl == "grouped" else "")
        eng = Engine(rcfg, params, EngineConfig(max_batch=BATCH, max_prefill=PROMPT,
                                                max_decode=NEW), device="cuda")
        eng.generate(reqs)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset(*counters)
        t0 = time.perf_counter()
        out = eng.generate(reqs)
        wall = time.perf_counter() - t0
        got = read(counters, what)
        assert len(out) == BATCH and all(len(r.tokens) == NEW for r in out)
        assert all(0 <= tok < cfg.vocab_size for r in out for tok in r.tokens)
        want = {k: 0 for k in got}
        want["flash_attention"] = cfg.num_layers
        if impl == "dense":
            want["moe_gating"] = n_moe * NEW
        if got != want:
            raise AssertionError(f"{what} launches {got}, expected {want}")
        runs[impl] = (got, [r.tokens for r in out])
        tm = eng.last_timings
        step_ms = statistics.median(tm["decode_step_s"]) * 1e3
        peak = torch.cuda.max_memory_allocated() / 1e9
        lines += [
            f"{what}: {cfg.name} at its published size, {cfg.num_layers} layers ({n_moe} MoE, "
            f"{cfg.layer_specs()[1].ffn.num_experts} GELU experts of d_ff "
            f"{cfg.layer_specs()[1].ffn.d_ff}), d_model {cfg.d_model}, {n_params / 1e9:.2f} G "
            f"parameters bf16 drawn in {init_s:.1f} s, moe_impl={impl!r}: {BATCH} requests x "
            f"{NEW} tokens in {wall * 1e3:.3f} ms ({BATCH * NEW / wall:.1f} tok/s); prefill "
            f"{tm['prefill_s'] * 1e3:.3f} ms (batch {BATCH} x {PROMPT}); decode step median "
            f"{step_ms:.3f} ms over {len(tm['decode_step_s'])} steps; launches {got}; peak memory "
            f"{peak:.1f} GB",
            f"{what}: tokens of request 0: {out[0].tokens}",
        ] + profile_decode(eng, rcfg, params, what=what.replace("serve", "decode"))
        del eng
    same = sum(a == b for a, b in zip(runs["dense"][1], runs["grouped"][1]))
    lines.append(f"nlg serve grouped: requests whose tokens equal the dense dispatch's: {same} of "
                 f"{BATCH} (the capacity dispatch drops past each expert's slots; grouped is "
                 f"dropless)")
    # phase 4d's static part: the dense engine under Obs(routing=True), which
    # also runs the last token's step (for its routing, as the JAX engine)
    from repro_torch.obs import Obs

    eng = Engine(cfg, params, EngineConfig(max_batch=BATCH, max_prefill=PROMPT, max_decode=NEW),
                 obs=Obs(routing=True), device="cuda")
    reset(*counters)
    out = eng.generate(reqs)
    routed = read(counters, "nlg serve routing")
    want = {k: 0 for k in routed}
    want.update(flash_attention=cfg.num_layers, moe_gating=n_moe * (NEW + 1))
    if routed != want or [r.tokens for r in out] != runs["dense"][1]:
        raise AssertionError(f"nlg serve routing: launches {routed}, expected {want}, or tokens "
                             f"that differ from the dense run's")
    lr = eng.last_routing
    if lr["moe_layers"] != n_moe:
        raise AssertionError(f"nlg serve routing: last_routing over {lr['moe_layers']} layers")
    step_ms = statistics.median(eng.last_timings["decode_step_s"]) * 1e3
    lines.append(f"nlg serve routing: Engine under Obs(routing=True), the dense run's tokens; "
                 f"last_routing: {lr['moe_layers']} MoE layers, mean dropped share "
                 f"{lr['dropped_frac']:.6f}, imbalance {lr['imbalance']:.6f}, entropy "
                 f"{lr['entropy']:.6f} nats; decode step median {step_ms:.3f} ms (one routing "
                 f"copy a step); launches {routed}")
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    lines.append(reference_check(make_reduced(cfg).replace(moe_impl="grouped")))
    return lines, runs["dense"][0], runs["grouped"][0], routed


def flash_checks(full, red, gen) -> dict:
    """Kernel 6 against its plain version: at the static serves' shapes
    (llama4-maverick, nlg-350m-moe128 and glm4-9b heads, 4 x 64 tokens,
    bf16), at reduced size in f32 and bf16 with every mask and a row with
    no valid key, at every head-dim instance in bf16 (wgmma at dh 64 and 128
    with both query-tile heights and at 256 with 128-row tiles, mma.sync at
    32 and 112), at
    nlg-350m-moe128's heads over a 4096-token prompt, and in the TPU kernel's
    index form at S != T; timed beside their bounds, plain versions and
    SDPA."""
    import torch.nn.functional as F

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as k6

    fshapes = {}
    for label, arch in (("static_llama4", full), ("static_nlg", get_config("nlg-350m-moe128")),
                        ("static_glm4", get_config("glm4-9b"))):
        args, kw = flash_case(BATCH, PROMPT, arch.num_heads, arch.num_kv_heads, arch.head_dim,
                              torch.bfloat16, gen)
        info = flash_info(args[0], args[1], args[3], args[4], kw)
        info.update(check_flash(args, kw, BF16_TOL))
        fshapes[label] = info
        log(f"kernel flash_attention bf16 {label} ({arch.name}'s heads, {BATCH} x {PROMPT}): "
            f"{json.dumps(info)}")
    # reduced size, S = T = 300 (not a multiple of any tile), positions
    # offset per row, empty slots, a window and a softcap, in f32 (the
    # CUDA-core path) and bf16 (the tensor-core path, partial tiles); row 2's
    # keys are all empty, so it has no valid key and must give 0
    for dt, tol, label in ((torch.float32, F32_TOL, "f32"), (torch.bfloat16, BF16_TOL, "bf16")):
        args, _ = flash_case(3, 300, red.num_heads, red.num_kv_heads, red.head_dim, dt, gen)
        q, k, v, _, _ = args
        pos = (torch.arange(300, dtype=torch.int32, device="cuda")[None]
               + torch.tensor([[5], [400], [0]], dtype=torch.int32, device="cuda")).contiguous()
        kpos = pos.clone()
        kpos[:, 3::7] = -1
        kpos[2] = -1
        kw = dict(scale=1.0 / math.sqrt(red.head_dim), causal=True, window=37, softcap=20.0)
        info = flash_info(q, k, pos, kpos, kw)
        info.update(check_flash((q, k, v, pos, kpos), kw, tol, timed=False))
        if k6.flash_attention_gqa(q, k, v, pos, kpos, **kw)[2].abs().max().item() != 0:
            raise AssertionError(f"kernel 6 {label}: a row with no valid key must give 0")
        fshapes[f"{label}_reduced_window_softcap"] = info
        log(f"kernel flash_attention {label} reduced, S = T = 300, offset positions, empty slots, "
            f"window 37, softcap 20 (a row with no valid key gives 0): {json.dumps(info)}")
    # past 2048 keys (one 32-bit word of the bf16 path's tile bitmasks):
    # S = T = 4500, positions offset per row, every 7th slot empty, and in
    # row 1 slots 1984-2239 (key tiles 31-34, across the first word
    # boundary) all empty; with and without a window of 1500, whose first
    # live tile lies past word 0 for the last 950 queries.  Held per row.
    # At the reduced head dim (f32; bf16 on mma.sync) and in bf16 at dh 64
    # and 128 (wgmma, 128-row query tiles over 128-key tiles, the last one
    # ragged).
    for dt, tol, label, dh in ((torch.float32, F32_TOL, "f32", red.head_dim),
                               (torch.bfloat16, BF16_TOL, "bf16", red.head_dim),
                               (torch.bfloat16, BF16_TOL, "bf16_dh64", 64),
                               (torch.bfloat16, BF16_TOL, "bf16_dh128", 128)):
        for window, cap in ((0, 0.0), (1500, 20.0)):
            args, _ = flash_case(2, 4500, red.num_heads, red.num_kv_heads, dh, dt, gen)
            q, k, v, _, _ = args
            pos = (torch.arange(4500, dtype=torch.int32, device="cuda")[None]
                   + torch.tensor([[0], [37]], dtype=torch.int32, device="cuda")).contiguous()
            kpos = pos.clone()
            kpos[:, 3::7] = -1
            kpos[1, 1984:2240] = -1
            kw = dict(scale=1.0 / math.sqrt(dh), causal=True, window=window, softcap=cap)
            info = flash_info(q, k, pos, kpos, kw)
            if dt == torch.bfloat16 and dh in k6.WGMMA_HEAD_DIMS:
                info["q_tile"] = q_tile_of(q)
                if info["q_tile"] != 128:
                    raise AssertionError(f"kernel 6 {label} at 4500 tokens: q_tile {info['q_tile']}")
            info.update(check_flash((q, k, v, pos, kpos), kw, tol, timed=False))
            fshapes[f"{label}_reduced_4500_window{window}"] = info
            log(f"kernel flash_attention {label} reduced, S = T = 4500, offset positions, empty "
                f"slots and tiles 31-34 of row 1, window {window}, softcap {cap}: {json.dumps(info)}")
    # every head-dim instance in bf16 with every mask and a row with no valid
    # key: wgmma at dh 64 and 128 with 128-row query tiles (S = 300, 32 heads
    # over 2 kv-heads: 288 blocks; the last key tile ragged) and 64-row ones
    # (S = 40, 4 heads over 2), at dh 256 with 128-row tiles at both,
    # mma.sync at dh 32 and 112
    for dh in k6.HEAD_DIMS:
        for S, H, want in ((300, 32, 128), (40, 4, 128 if dh == 256 else 64)):
            args, _ = flash_case(3, S, H, 2, dh, torch.bfloat16, gen)
            q, k, v, _, _ = args
            pos = (torch.arange(S, dtype=torch.int32, device="cuda")[None]
                   + torch.tensor([[5], [400], [0]], dtype=torch.int32, device="cuda")).contiguous()
            kpos = pos.clone()
            kpos[:, 3::7] = -1
            kpos[2] = -1
            kw = dict(scale=1.0 / math.sqrt(dh), causal=True, window=37, softcap=20.0)
            info = flash_info(q, k, pos, kpos, kw)
            if dh in k6.WGMMA_HEAD_DIMS:
                info["q_tile"] = q_tile_of(q)
                if info["q_tile"] != want:
                    raise AssertionError(f"kernel 6 dh {dh} S {S}: q_tile {info['q_tile']}, "
                                         f"want {want}")
            info.update(check_flash((q, k, v, pos, kpos), kw, BF16_TOL, timed=False))
            if k6.flash_attention_gqa(q, k, v, pos, kpos, **kw)[2].abs().max().item() != 0:
                raise AssertionError(f"kernel 6 dh {dh}: a row with no valid key must give 0")
            fshapes[f"bf16_dh{dh}_S{S}_window_softcap"] = info
            log(f"kernel flash_attention bf16 dh {dh}, S = T = {S}, {H} heads over 2 kv-heads, offset "
                f"positions, empty slots, window 37, softcap 20 (a row with no valid key gives 0): "
                f"{json.dumps(info)}")
    # nlg-350m-moe128's heads (G = 1, dh 64) at a long causal prompt, timed
    nlg = get_config("nlg-350m-moe128")
    args, kw = flash_case(1, NLG_LONG, nlg.num_heads, nlg.num_kv_heads, nlg.head_dim,
                          torch.bfloat16, gen)
    info = flash_info(args[0], args[1], args[3], args[4], kw)
    info.update(check_flash(args, kw, BF16_TOL))
    fshapes[f"static_nlg_{NLG_LONG}"] = info
    log(f"kernel flash_attention bf16 nlg-350m-moe128's heads, one {NLG_LONG}-token causal prompt: "
        f"{json.dumps(info)}")
    # the TPU kernel's own contract: [BH, S, dh], causal by index, S != T
    BH, S, T = full.num_heads, 128, 384
    q, k, v = (torch.randn((BH, n, full.head_dim), generator=gen, device="cuda").bfloat16()
               for n in (S, T, T))
    ipos = lambda n: torch.arange(n, dtype=torch.int32, device="cuda").expand(BH, n).contiguous()
    iargs = (q[:, :, None], k[:, :, None], v[:, :, None], ipos(S), ipos(T))
    kw = dict(scale=1.0 / math.sqrt(full.head_dim), causal=True)
    out6 = k6.flash_attention(q, k, v, **kw)
    ref6 = k6.flash_attention_plain(*iargs, **kw)[:, :, 0]
    info = flash_info(*iargs[:2], *iargs[3:], kw)
    info.update(compare_rows("flash_attention", out6, ref6, BF16_TOL))
    info["ms"] = graph_ms(lambda: k6.flash_attention(q, k, v, **kw))
    info["host_ms"] = time_ms(lambda: k6.flash_attention(q, k, v, **kw))
    info["plain_ms"] = time_ms(lambda: k6.flash_attention_plain(*iargs, **kw), n=3)
    # SDPA's is_causal is top-left aligned too: the same function, on views
    # of q, k, v (no layout copy)
    info["library_ms"] = graph_ms(lambda: F.scaled_dot_product_attention(
        q[:, None], k[:, None], v[:, None], is_causal=True, scale=kw["scale"]))
    info["library_layout_ms"] = 0.0
    fshapes["index_causal_S128_T384"] = info
    log(f"kernel flash_attention bf16 index form ({BH} x [{S}, {full.head_dim}] over {T} keys, "
        f"causal top-left): {json.dumps(info)}")
    return fshapes


def long_prefill(cfg, params, counters):
    """One 16384-token prompt through ``Engine(max_batch=1,
    max_prefill=16384, max_decode=8)`` at full width: kernel 6 once per
    layer at the prefill, kernel 4 once per MoE call.  The warm-up run
    records layer 0's attention inputs; kernel 6 is then held against its
    plain version (chunked, on the card) on them and timed.  Returns
    (lines, launches, the check)."""
    import repro_torch.core.moe as mm
    import repro_torch.models.attention as am
    from repro_torch.launch.expert_kernels import grouped_bound
    from repro_torch.models.model import prefill
    from repro_torch.serving.engine import Engine, EngineConfig, Request

    eng = Engine(cfg, params, EngineConfig(max_batch=1, max_prefill=LONG_PROMPT, max_decode=LONG_NEW),
                 device="cuda")
    rng = torch.Generator().manual_seed(SEED + 5)
    reqs = [Request(torch.randint(0, cfg.vocab_size, (LONG_PROMPT,), generator=rng).tolist(), LONG_NEW)]
    real, seen = am.flash_attention_gqa, []
    real_g, seen_g = mm.grouped_mlp, []

    def rec(*a, **kw):
        if not seen:
            seen.append((a, kw))
        return real(*a, **kw)

    def rec_g(*a):
        if not seen_g:
            seen_g.append(a)
        return real_g(*a)

    am.flash_attention_gqa, mm.grouped_mlp = rec, rec_g
    try:
        eng.generate(reqs)  # warm-up, recording layer 0's q, k, v and the MoE layer's xg, te
    finally:
        am.flash_attention_gqa, mm.grouped_mlp = real, real_g
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset(*counters)
    t0 = time.perf_counter()
    out = eng.generate(reqs)
    wall = time.perf_counter() - t0
    got = read(counters, "long prefill")
    peak = torch.cuda.max_memory_allocated() / 1e9
    assert len(out) == 1 and len(out[0].tokens) == LONG_NEW, out[0].tokens
    assert all(0 <= tok < cfg.vocab_size for tok in out[0].tokens)
    n_moe = sum(ls.ffn.kind == "moe" for ls in cfg.layer_specs())
    want = {k: 0 for k in got}
    want.update({"flash_attention": cfg.num_layers, "grouped_mlp": n_moe * LONG_NEW})
    if got != want:
        raise AssertionError(f"long prefill launches {got}, expected {want}")
    tm = eng.last_timings
    step_ms = statistics.median(tm["decode_step_s"]) * 1e3
    plain_gb = cfg.num_heads * LONG_PROMPT ** 2 * 4 / 1e9
    toks = torch.tensor([reqs[0].prompt], device="cuda")

    def run(prof):
        caches = eng._make_caches(1)
        torch.cuda.synchronize()
        with prof or contextlib.nullcontext():
            t0 = time.perf_counter()
            prefill(cfg, params, toks, caches)[0].cpu()
            return (time.perf_counter() - t0) * 1e3

    p6 = {}
    profile = profile_account(run, 1, "long prefill", into=p6)  # which kernels set the prefill
    profile.append(roofline_line(f"long prefill ({LONG_PROMPT} tokens, grouped, bf16)",
                                 lambda c: prefill(cfg, params, toks, c), (eng._make_caches(1),),
                                 counters, p6)[0])
    del toks
    (args, kw), = seen
    info = flash_info(args[0], args[1], args[3], args[4], kw)
    info.update(check_flash(args, kw, BF16_TOL, n=3, plain_n=1))
    (gargs,) = seen_g
    del seen_g
    K = next(ls.ffn.top_k for ls in cfg.layer_specs() if ls.ffn.kind == "moe")
    ginfo = {"T": LONG_PROMPT, "K": K,
             **grouped_bound(dict(zip(("wi", "wg", "wo"), gargs[2:5])), gargs[0], gargs[1], gargs[5],
                             LONG_PROMPT * K)}
    ginfo.update(check_grouped(gargs, BF16_TOL, "mma", timed=True, n=3))
    del gargs
    lines = [
        f"long prefill: {cfg.name} at full width, one {LONG_PROMPT}-token prompt x {LONG_NEW} new "
        f"tokens in {wall * 1e3:.3f} ms; prefill {tm['prefill_s'] * 1e3:.3f} ms; decode step median "
        f"{step_ms:.3f} ms over {len(tm['decode_step_s'])} steps; launches {got}; peak memory "
        f"{peak:.1f} GB (the plain path's f32 logits alone would take {cfg.num_heads} x "
        f"{LONG_PROMPT}^2 x 4 B = {plain_gb:.1f} GB per layer call; it was not run at this size)",
        f"long prefill: tokens: {out[0].tokens}",
        *profile,
        f"kernel flash_attention bf16 long prefill (layer 0's q, k, v of the {LONG_PROMPT}-token "
        f"prompt, against its plain version in 1024-query chunks on the card): {json.dumps(info)}",
        f"kernel grouped_mlp bf16 long prefill (the MoE layer's xg, te, rows_used of the "
        f"{LONG_PROMPT}-token prompt): {json.dumps(ginfo)}",
    ]
    return lines, got, info, ginfo


def glm4_serve(counters) -> tuple:
    """glm4-9b at its published size (40 layers, d_model 4096, 32 query
    heads over 2 kv-heads: G = 16), bf16 random weights from the seed,
    through ``Engine`` on 4 requests: kernel 6 once per layer at the
    prefill, no MoE kernel (a dense arch); and a profile of 5 decode
    steps."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import Engine, EngineConfig, Request

    cfg = get_config("glm4-9b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(b.numel() for b in params.buffers())
    init_s = time.perf_counter() - t0
    eng = Engine(cfg, params, EngineConfig(max_batch=BATCH, max_prefill=PROMPT, max_decode=NEW),
                 device="cuda")
    rng = torch.Generator().manual_seed(SEED + 6)
    reqs = [Request(torch.randint(0, cfg.vocab_size, (PROMPT,), generator=rng).tolist(), NEW)
            for _ in range(BATCH)]
    eng.generate(reqs)  # warm-up
    torch.cuda.synchronize()
    reset(*counters)
    t0 = time.perf_counter()
    out = eng.generate(reqs)
    wall = time.perf_counter() - t0
    got = read(counters, "glm4 serve")
    assert len(out) == BATCH and all(len(r.tokens) == NEW for r in out)
    assert all(0 <= tok < cfg.vocab_size for r in out for tok in r.tokens)
    want = {k: 0 for k in got}
    want["flash_attention"] = cfg.num_layers
    if got != want:
        raise AssertionError(f"glm4 serve launches {got}, expected {want}")
    tm = eng.last_timings
    step_ms = statistics.median(tm["decode_step_s"]) * 1e3
    return [
        f"glm4 serve: {cfg.name} at its published size, {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads} query heads over {cfg.num_kv_heads} kv-heads (G = "
        f"{cfg.num_heads // cfg.num_kv_heads}), vocab {cfg.vocab_size}, {n_params / 1e9:.2f} G "
        f"parameters bf16 drawn in {init_s:.1f} s: {BATCH} requests x {NEW} tokens in "
        f"{wall * 1e3:.3f} ms ({BATCH * NEW / wall:.1f} tok/s); prefill {tm['prefill_s'] * 1e3:.3f} ms "
        f"(batch {BATCH} x {PROMPT}); decode step median {step_ms:.3f} ms over "
        f"{len(tm['decode_step_s'])} steps; launches {got}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB",
        f"glm4 serve: tokens per request: {[r.tokens for r in out]}",
    ] + profile_decode(eng, cfg, params, what="glm4 decode"), got


# ---------------------------------------------------------------------------
# Slice 8: sliding-window rings, RG-LRU and Mamba-2 SSD (phase 14)
# ---------------------------------------------------------------------------

# the static serve of each arch: 4 requests of 1500-token prompts (past
# gemma3's window of 1024), 16 new tokens
MIXED_PROMPT, MIXED_NEW = 1500, 16
# recurrentgemma's continuous trace adds one 2500-token prompt, so that a
# 2048-slot ring wraps inside a prefill; its slots are sized for it
MIXED_LONG = 2500
MIXED_CONT = dict(CONT, capacity=2560, n_pages=None)
# the prefill launch counts (recurrentgemma, mamba2): a short and a long prompt
LAUNCH_PROMPTS = (250, 2500)


def slice8_config(name):
    """The full config served in phase 14: gemma3-27b cut to one period of
    its 5 local : 1 global pattern plus its 2-layer local tail (8 of 62
    layers, at its published widths), the others at their published depth."""
    from repro_torch.configs.base import Segment
    from repro_torch.configs.registry import get_config

    full = get_config(name)
    if name == "gemma3-27b":
        return full.replace(segments=(Segment(full.segments[0].pattern, 1), full.segments[1]))
    return full


def layer_counts(cfg) -> tuple:
    """(global attention layers, sliding-window layers) of a config."""
    from repro_torch.configs.base import AttnSpec

    specs = [ls.mixer for ls in cfg.layer_specs()]
    local = sum(isinstance(m, AttnSpec) and m.kind == "local" for m in specs)
    return sum(isinstance(m, AttnSpec) for m in specs) - local, local


def mixed_static_serve(cfg, params, counters, kv_cache_bits=0) -> tuple:
    """``Engine`` on 4 requests of MIXED_PROMPT tokens, MIXED_NEW new ones:
    kernel 6 once per attention layer at the prefill (the local layers with
    their window), kernel 9 once per attention layer per decode step over an
    int8 cache (rings included), nothing else.  Returns (lines, launches,
    the engine, the tokens)."""
    from repro_torch.serving.engine import Engine, EngineConfig, Request

    what = f"{cfg.name} static serve" + (" int8 KV" if kv_cache_bits else "")
    eng = Engine(cfg, params, EngineConfig(max_batch=BATCH, max_prefill=MIXED_PROMPT,
                                           max_decode=MIXED_NEW, kv_cache_bits=kv_cache_bits),
                 device="cuda")
    rng = torch.Generator().manual_seed(SEED + 20)
    reqs = [Request(torch.randint(0, cfg.vocab_size, (MIXED_PROMPT,), generator=rng).tolist(),
                    MIXED_NEW) for _ in range(BATCH)]
    eng.generate(reqs)  # warm-up
    torch.cuda.synchronize()
    reset(*counters)
    t0 = time.perf_counter()
    out = eng.generate(reqs)
    wall = time.perf_counter() - t0
    got = read(counters, what)
    assert len(out) == BATCH and all(len(r.tokens) == MIXED_NEW for r in out)
    assert all(0 <= t < cfg.vocab_size for r in out for t in r.tokens)
    n_global, n_local = layer_counts(cfg)
    want = {k: 0 for k in got}
    want["flash_attention"] = n_global + n_local
    if kv_cache_bits:
        want["decode_attention_quant"] = (n_global + n_local) * (MIXED_NEW - 1)
    if got != want:
        raise AssertionError(f"{what} launches {got}, expected {want}")
    tm = eng.last_timings
    step_ms = statistics.median(tm["decode_step_s"]) * 1e3
    lines = [f"{what}: {BATCH} requests x {MIXED_NEW} tokens (prompts of {MIXED_PROMPT}) in "
             f"{wall * 1e3:.3f} ms ({BATCH * MIXED_NEW / wall:.1f} tok/s); prefill "
             f"{tm['prefill_s'] * 1e3:.3f} ms; decode step median {step_ms:.3f} ms ({BATCH / step_ms * 1e3:.1f} "
             f"tok/s) over {len(tm['decode_step_s'])} steps; launches {got}; peak memory "
             f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB",
             f"{what}: tokens of request 0: {out[0].tokens}"]
    return lines, got, eng, [r.tokens for r in out]


def mixed_continuous(cfg, params, counters, prefill_mode="chunked", kv_cache_bits=0, long=False):
    """The phase-4 trace (CONT_PROMPTS, and MIXED_LONG with ``long``)
    through the paged engine (MIXED_CONT: no preemption): the global layers'
    paged kernels 7 / 8 (or the batched 8), kernel 9 once per sliding-window
    layer per decode tick over an int8 ring, no kernel for a ring's chunk
    (the plain ``_sdpa`` over ``cat(ring, chunk)``) nor for an SSD / LRU
    layer.  Returns (lines, launches)."""
    from repro_torch.serving.continuous import ContinuousEngine
    from repro_torch.serving.engine import Request

    what = (f"{cfg.name} continuous {prefill_mode}" + (" int8 KV" if kv_cache_bits else ""))
    eng = ContinuousEngine(cfg, params, paged=True, device="cuda", prefill_mode=prefill_mode,
                           kv_cache_bits=kv_cache_bits, **MIXED_CONT)
    rng = torch.Generator().manual_seed(SEED + 1)
    lens = CONT_PROMPTS + ([MIXED_LONG] if long else [])
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist() for n in lens]
    eng.submit(Request(prompts[0][:300], 4))  # warm-up
    eng.run_until_done()
    clear_run_state(eng)
    torch.cuda.synchronize()
    reset(*counters)
    ids, wall, ttft = timed_run(eng, lambda: [eng.submit(Request(p, CONT_NEW)) for p in prompts])
    launches = read(counters, what)
    done = eng.done
    assert sorted(done) == sorted(ids) and all(len(done[i].tokens) == CONT_NEW for i in ids)
    assert all(0 <= t < cfg.vocab_size for i in ids for t in done[i].tokens)
    if eng.pool.free_count != eng.n_pages:
        raise AssertionError(f"{what}: the pool did not drain")
    ticks = [m for m in eng.metrics_log if m["tokens_this_tick"]]
    want = expected_launches(cfg, params, launches, eng, len(ticks), kv8=bool(kv_cache_bits))
    if launches != want:
        raise AssertionError(f"{what} launches {launches}, expected {want}")
    n_tok = sum(len(done[i].tokens) for i in ids)
    tick_ms = statistics.median(m["decode_s"] for m in ticks) * 1e3
    return [
        f"{what}: {len(ids)} requests x {CONT_NEW} tokens (prompts {lens}), {MIXED_CONT['slots']} "
        f"slots, pages of {MIXED_CONT['page_size']} in {wall * 1e3:.3f} ms ({n_tok / wall:.1f} "
        f"tok/s); {len(ticks)} decode ticks, median {tick_ms:.3f} ms; {eng.prefill_tokens_total} "
        f"prefill tokens in {eng.prefill_calls_total} calls; preemptions {eng.preemptions}; "
        f"launches {launches}; pool drained",
        f"{what}: TTFT ms per request {ttft} (median {statistics.median(ttft):.3f}); tokens of "
        f"request 0: {done[ids[0]].tokens}",
    ], launches


def prefill_launches(cfg, params, S) -> tuple:
    """(kernel launches, kernels on the device) of one ``prefill`` of S
    tokens (batch 1), from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.model import init_caches, prefill

    toks = torch.randint(0, cfg.vocab_size, (1, S), device="cuda")
    prefill(cfg, params, toks, init_caches(cfg, 1, S, device="cuda"))  # warm-up
    caches = init_caches(cfg, 1, S, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prefill(cfg, params, toks, caches)
        torch.cuda.synchronize()
    evs = prof.key_averages()
    n_launch = sum(ev.count for ev in evs if ev.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                                         "cudaLaunchKernelExC", "cuLaunchKernelEx"))
    n_kern = sum(ev.count for ev in evs
                 if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0)
    return n_launch, n_kern


def prefill_launch_check(cfg, params) -> str:
    """No prefill loops over tokens: recurrentgemma's launches at 2500
    tokens under twice those at 250 (``lru_scan``'s log-step rounds), and
    mamba2's growing by at most 8 per layer for each further 256-token
    chunk (the inter-chunk state pass)."""
    from repro_torch.configs.base import SSMSpec

    got = {S: prefill_launches(cfg, params, S) for S in LAUNCH_PROMPTS}
    short, long_ = (max(got[S]) for S in LAUNCH_PROMPTS)
    ssm = [ls.mixer for ls in cfg.layer_specs() if isinstance(ls.mixer, SSMSpec)]
    if ssm:
        chunk = ssm[0].chunk
        extra = -(-LAUNCH_PROMPTS[1] // chunk) - -(-LAUNCH_PROMPTS[0] // chunk)
        limit = short + 8 * len(ssm) * extra
        rule = f"at most {short} + 8 x {len(ssm)} layers x {extra} chunks = {limit}"
        ok = long_ <= limit
    else:
        limit, rule = 2 * short, f"under twice the {LAUNCH_PROMPTS[0]}-token count ({2 * short})"
        ok = long_ < limit
    line = (f"{cfg.name} prefill launches (kernel launches, kernels on the device) at "
            f"{LAUNCH_PROMPTS[0]} tokens {got[LAUNCH_PROMPTS[0]]}, at {LAUNCH_PROMPTS[1]} tokens "
            f"{got[LAUNCH_PROMPTS[1]]}: {rule}")
    if not ok:
        raise AssertionError(line)
    return line


def slice8_reference_checks(red) -> list:
    """A reduced f32 arch with per-slot state, the same weights on the card
    (kernels) and on the CPU (plain versions): the static path
    (``reference_check``), the paged engine that preempts
    (``continuous_reference_check``), and the batched tick with prefix
    sharing and ``submit_n`` forks, the scatter mode, the contiguous engine
    and int8 rings: identical tokens, preemptions, prefix hits and CoW
    copies, drained pools."""
    from repro_torch.models.model import init_params
    from repro_torch.serving.continuous import ContinuousEngine
    from repro_torch.serving.engine import Request

    on_card = init_params(red, seed=SEED, device="cuda")
    on_cpu = copy.deepcopy(on_card).to("cpu")
    lines = [reference_check(red, on_card), continuous_reference_check(red, on_card)]
    rng = np.random.default_rng(SEED + 21)
    draw = lambda n: rng.integers(1, red.vocab_size, n).tolist()
    pre = draw(8)  # two pages of 4
    prompts = [pre + draw(5), pre + draw(9), draw(6), pre + draw(17), pre + draw(30), draw(13)]
    fork = pre + draw(3)
    paged = dict(paged=True, slots=3, capacity=48, page_size=4, n_pages=14, prefill_chunk=8)
    cases = [("prefix batched", dict(paged, prefix_sharing=True, prefill_mode="batched")),
             ("prefix scatter int8 KV", dict(paged, prefix_sharing=True, prefill_mode="scatter",
                                             kv_cache_bits=8)),
             ("chunked int8 KV", dict(paged, kv_cache_bits=8)),
             ("contiguous int8 KV", dict(slots=3, capacity=48, kv_cache_bits=8))]
    for label, kw in cases:
        recs = []
        for dev, params in (("cuda", on_card), ("cpu", on_cpu)):
            eng = ContinuousEngine(red, params, device=dev, **kw)
            ids = eng.submit_n(Request(fork, 7), 2) + [eng.submit(Request(p, 7)) for p in prompts]
            done = eng.run_until_done()
            recs.append({"tokens": [done[i].tokens for i in ids], "preemptions": eng.preemptions,
                         "prefix_hits": eng.prefix_hits, "cow_copies": eng.cow_copies,
                         "drained": not eng.paged or eng.pool.free_count == eng.n_pages})
        if recs[0] != recs[1] or not recs[0]["drained"]:
            raise AssertionError(f"reduced {red.name} {label}: card {recs[0]}, CPU {recs[1]}")
        r = recs[0]
        lines.append(f"slice-8 reference: reduced {red.name} f32, {label}, card (kernels) vs CPU "
                     f"(plain versions): tokens identical, preemptions {r['preemptions']}, prefix "
                     f"hits {r['prefix_hits']}, CoW copies {r['cow_copies']} on both; pools drained")
    return lines


def sdpa_window(q, k, v, q_pos, k_pos, scale, window):
    """Kernel 6's yardstick with a window: one scaled_dot_product_attention
    with the window-causal boolean mask and ``enable_gqa`` over [B, heads,
    tokens, dh] copies of the model's layouts (the copies timed apart as the
    layout); torch picks the backend that takes the mask."""
    import torch.nn.functional as F

    to_heads = lambda: tuple(t.transpose(1, 2).contiguous() for t in (q, k, v))
    qh, kh, vh = to_heads()
    qp, kp = q_pos[:, None, :, None], k_pos[:, None, None, :]
    mask = (kp >= 0) & (kp <= qp) & (qp - kp < window)  # [B, 1, S, T]

    def call():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask, scale=scale,
                                              enable_gqa=True)

    out = call()
    return call, lambda: (to_heads(), out.transpose(1, 2).contiguous())


def slice8_kernel_checks(gen) -> tuple:
    """Kernel 6 with a window at gemma3's local shape (4 x 2048 and 1 x 8192
    tokens, window 1024, dh 128 on wgmma) and at recurrentgemma's (dh 256 on
    wgmma, 10 heads over 1, window 2048: 1 x 4096 tokens and the served
    static prefill of 4 x 1500, each also checked bit for bit over two
    launches), and at dh 256 with every mask and a row with no valid key
    (f32 and bf16); kernel 9 over a wrapped int8 ring at gemma3's (8 x 1024,
    16 kv-heads, G 2, dh 128) and recurrentgemma's shape (8 x 2048, 1
    kv-head, G 10, dh 256), rows at their own positions past the ring (the
    newest key before the oldest in memory), one row not yet wrapped, and at
    dh 256 in f32, in bf16 with window 37, softcap 20, empty slots and a row
    with no valid key, and in bf16 over 72 rows (one split a row: the split
    kernel writes the output itself).  Each held per query row against its
    plain version, the served shapes timed beside their bound and SDPA.
    Returns ({shape: info} of the windowed 6, of the dh-256 6, of the ring
    9)."""
    from repro_torch.kernels import attention_quant as k9
    from repro_torch.kernels import flash_attention as k6

    win, d256, ring = {}, {}, {}
    for store, label, (B, S, H, Hkv, dh, window) in (
            (win, "gemma3_local_4x2048", (4, 2048, 32, 16, 128, 1024)),
            (win, "gemma3_local_1x8192", (1, 8192, 32, 16, 128, 1024)),
            (d256, "recurrentgemma_local_1x4096", (1, 4096, 10, 1, 256, 2048)),
            (d256, "recurrentgemma_local_4x1500", (4, 1500, 10, 1, 256, 2048))):
        args, kw = flash_case(B, S, H, Hkv, dh, torch.bfloat16, gen)
        kw["window"] = window
        info = flash_info(args[0], args[1], args[3], args[4], kw)
        q, k, v, qp, kp = args
        info.update(check_flash(args, kw, BF16_TOL, n=10,
                                library=lambda: sdpa_window(q, k, v, qp, kp, kw["scale"], window)))
        info["window"] = window
        if store is d256:
            info["deterministic"] = bool(torch.equal(k6.flash_attention_gqa(*args, **kw),
                                                     k6.flash_attention_gqa(*args, **kw)))
            if not info["deterministic"]:
                raise AssertionError(f"kernel 6 dh 256 {label}: two launches differ")
        store[label] = info
        log(f"kernel flash_attention bf16 windowed {label} (window {window}): {json.dumps(info)}")
        del args, q, k, v
    for dt, tol, label in ((torch.float32, F32_TOL, "f32"), (torch.bfloat16, BF16_TOL, "bf16")):
        args, _ = flash_case(3, 300, 10, 1, 256, dt, gen)
        q, k, v, _, _ = args
        pos = (torch.arange(300, dtype=torch.int32, device="cuda")[None]
               + torch.tensor([[5], [400], [0]], dtype=torch.int32, device="cuda")).contiguous()
        kpos = pos.clone()
        kpos[:, 3::7] = -1
        kpos[2] = -1
        kw = dict(scale=1.0 / 16.0, causal=True, window=37, softcap=20.0)
        info = flash_info(q, k, pos, kpos, kw)
        info.update(check_flash((q, k, v, pos, kpos), kw, tol, timed=False))
        if k6.flash_attention_gqa(q, k, v, pos, kpos, **kw)[2].abs().max().item() != 0:
            raise AssertionError(f"kernel 6 dh 256 {label}: a row with no valid key must give 0")
        d256[f"{label}_window_softcap"] = info
        log(f"kernel flash_attention {label} dh 256, S = T = 300, offset positions, empty slots, "
            f"window 37, softcap 20 (a row with no valid key gives 0): {json.dumps(info)}")
    masks = dict(window=37, softcap=20.0, holes=True, empty_row=1)
    for label, (B, cap, Hkv, G, dh, dt, timed), extra in (
            ("gemma3_ring_8x1024", (8, 1024, 16, 2, 128, torch.bfloat16, True), {}),
            ("recurrentgemma_ring_8x2048", (8, 2048, 1, 10, 256, torch.bfloat16, True), {}),
            ("f32_dh256_ring_3x300", (3, 300, 1, 10, 256, torch.float32, False), {}),
            ("bf16_dh256_ring_3x300_window_softcap", (3, 300, 1, 10, 256, torch.bfloat16, False),
             masks),
            ("bf16_dh256_ring_72x300_one_split", (72, 300, 1, 10, 256, torch.bfloat16, False),
             dict(masks, window=300, empty_row=5))):
        # row b's newest key at qpos[b], in slot qpos[b] % cap; the last row
        # has not wrapped (its slots past qpos empty); with ``extra``, every
        # 7th slot empty and one row with no valid key
        qpos = torch.tensor([cap + 37 * b + 11 for b in range(B - 1)] + [cap // 3], dtype=torch.int32,
                            device="cuda")
        slot = torch.arange(cap, device="cuda")[None]
        newest = qpos[:, None].long()
        kpos = (newest - (newest % cap - slot) % cap).to(torch.int32)
        kpos[-1, cap // 3 + 1:] = -1
        if extra:
            kpos[:, 3::7] = -1
            kpos[extra["empty_row"]] = -1
        args, info = decode_quant_case(B, cap, 0, Hkv, G, dh, dt, gen, kpos=kpos.contiguous(),
                                       qpos=qpos)
        kw = dict(scale=1.0 / math.sqrt(dh), window=extra.get("window", cap))
        if "softcap" in extra:
            kw["softcap"] = extra["softcap"]
        info.update(check_paged("decode_attention_quant", k9.decode_attention_quant,
                                k9.decode_attention_quant_plain, args, kw,
                                BF16_TOL if dt == torch.bfloat16 else F32_TOL, timed=timed,
                                library=lambda *a, **_: sdpa_contiguous(*a, window=cap)))
        info["window"] = kw["window"]
        if dt == torch.bfloat16:
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            info["splits"] = k9.decode_splits(cap, 1, B, Hkv, sms, dh)
        if extra and k9.decode_attention_quant(*args, **kw)[extra["empty_row"]].abs().max().item():
            raise AssertionError(f"kernel 9 {label}: a row with no valid key must give 0")
        ring[label] = info
        log(f"kernel decode_attention_quant {label} (a wrapped int8 ring, window {kw['window']}"
            f"{', softcap 20, every 7th slot empty, a row with no valid key' if extra else ''}): "
            f"{json.dumps(info)}")
    return win, d256, ring


def slice9_spec_reference_checks() -> list:
    """Speculative decoding with per-slot state on a small input: reduced f32
    weights on the card (kernels) and on the CPU (plain versions), 14 pages
    for 3 slots of 48 so that the pool preempts, k = SPEC_K: recurrentgemma
    with a seed-1 recurrentgemma drafter (the commit pass, and a resync after
    every partial accept) and the cross-family pair of JAX's tests, gemma3
    (rings) drafting for glm4-9b.  Identical tokens, per-tick spec records (resyncs
    included), preemptions and CoW copies; drained pools."""
    from repro_torch.configs.registry import get_config, make_reduced
    from repro_torch.models.model import init_params
    from repro_torch.serving.continuous import ContinuousEngine
    from repro_torch.serving.engine import Request

    rg, g3, glm = (make_reduced(get_config(n)) for n in ("recurrentgemma-2b", "gemma3-27b",
                                                         "glm4-9b"))
    rng = np.random.default_rng(SEED + 23)
    draw = lambda n: rng.integers(1, rg.vocab_size, n).tolist()
    pre = draw(8)  # two pages of 4
    prompts = [pre + draw(5), pre + draw(9), draw(6), pre + draw(17), draw(30), draw(13)]
    paged = dict(paged=True, slots=3, capacity=48, page_size=4, n_pages=14, prefill_chunk=8,
                 spec_k=SPEC_K)
    cases = [("recurrentgemma, seed-1 recurrentgemma drafter", rg, rg),
             ("glm4-9b, seed-1 gemma3 drafter (cross family)", glm, g3)]
    lines, preempted = [], 0
    for label, cfg, dcfg in cases:
        target = init_params(cfg, seed=SEED, device="cuda")
        draft = init_params(dcfg, seed=SEED + 1, device="cuda")
        recs = []
        for dev in ("cuda", "cpu"):
            tp, dp = ((target, draft) if dev == "cuda" else
                      (copy.deepcopy(target).to("cpu"), copy.deepcopy(draft).to("cpu")))
            eng = ContinuousEngine(cfg, tp, device=dev, spec_draft=(dcfg, dp), **paged)
            ids = [eng.submit(Request(p, 9)) for p in prompts]
            done = eng.run_until_done()
            eng.pool.check()
            recs.append({"tokens": [done[i].tokens for i in ids],
                         "spec": [m["spec"] for m in eng.metrics_log if "spec" in m],
                         "preemptions": eng.preemptions, "cow_copies": eng.cow_copies,
                         "resyncs": eng.spec_resyncs,
                         "drained": eng.pool.free_count == eng.n_pages})
        if recs[0] != recs[1] or not recs[0]["drained"]:
            raise AssertionError(f"slice-9 spec reference {label}: card {recs[0]}, CPU {recs[1]}")
        r = recs[0]
        preempted += r["preemptions"]
        drafted = sum(s["drafted"] for s in r["spec"])
        accepted = sum(s["accepted"] for s in r["spec"])
        if dcfg is rg and not r["resyncs"]:
            raise AssertionError(f"slice-9 spec reference {label}: no resync after {accepted} of "
                                 f"{drafted} drafts accepted")
        lines.append(f"slice-9 spec reference: reduced {cfg.name} f32, {label}, card (kernels) vs "
                     f"CPU (plain versions): tokens and {len(r['spec'])} per-tick spec records "
                     f"identical ({accepted} of {drafted} drafts accepted, {r['resyncs']} "
                     f"resyncs), preemptions {r['preemptions']}, CoW copies {r['cow_copies']} on "
                     f"both; pools drained")
    if not preempted:
        raise AssertionError("no slice-9 spec reference case preempted; the pool was meant to run "
                             "dry")
    return lines


def slice8_serve(counters, gen) -> tuple:
    """Phase 14: gemma3-27b (cut to 8 layers), recurrentgemma-2b and
    mamba2-370m at their published widths, one after the other (each tree
    freed before the next): the static engine (bf16, and int8 KV where the
    arch has attention), the paged continuous engine on the phase-4 trace
    (gemma3: chunked and batched over bf16 and int8 pools, and the prefix
    trace shared and unshared; recurrentgemma: with a 2500-token prompt,
    over bf16 and int8 rings; mamba2), a profile of the static decode step,
    the prefill launch counts (recurrentgemma, mamba2), and the reduced f32
    card-vs-CPU references.  Slice 9 adds gemma3 (bf16 and int8 pools) and
    recurrentgemma drafting for themselves on the paged trace beside the
    plain run (``spec_trace``), and the reduced speculative references
    (``slice9_spec_reference_checks``).  Returns (launches by path, the
    kernel checks' shapes, the speculative runs)."""
    from repro_torch.configs.registry import make_reduced
    from repro_torch.models.model import init_params

    paths, spec = {}, {}
    for name in ("gemma3-27b", "recurrentgemma-2b", "mamba2-370m"):
        cfg = slice8_config(name)
        short = name.split("-")[0]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = init_params(cfg, seed=SEED, device="cuda")
        torch.cuda.synchronize()
        n_params = sum(b.numel() for b in params.buffers())
        n_global, n_local = layer_counts(cfg)
        cut = (f", depth cut to {cfg.num_layers} of 62 layers (one period of 5 local : 1 global "
               "plus the 2-layer local tail)" if name == "gemma3-27b" else ", full depth")
        log(f"slice 8: {cfg.name} d_model {cfg.d_model}, {cfg.num_layers} layers ({n_global} global "
            f"attention, {n_local} sliding-window){cut}; {cfg.num_heads} heads over "
            f"{cfg.num_kv_heads}, dh {cfg.head_dim}, vocab {cfg.vocab_size}; {n_params / 1e9:.2f} G "
            f"parameters ({torch.cuda.memory_allocated() / 1e9:.1f} GB) drawn on the card in "
            f"{time.perf_counter() - t0:.1f} s")
        for kv in ((0, 8) if n_global + n_local else (0,)):
            lines, got, eng, _ = mixed_static_serve(cfg, params, counters, kv)
            paths[f"{short}_static" + ("_int8" if kv else "")] = got
            for line in lines:
                log(line)
            if not kv:
                for line in profile_decode(eng, cfg, params, what=f"{short} decode"):
                    log(line)
            del eng
        runs = [("chunked", 0), ("batched", 0), ("chunked", 8), ("batched", 8)]
        if name != "gemma3-27b":
            runs = [("chunked", 0), ("batched", 8)] if n_local else [("chunked", 0), ("batched", 0)]
        for mode, kv in runs:
            lines, got = mixed_continuous(cfg, params, counters, mode, kv,
                                          long=name == "recurrentgemma-2b")
            paths[f"{short}_continuous_{mode}" + ("_int8" if kv else "")] = got
            for line in lines:
                log(line)
        if name != "mamba2-370m":
            # slice 9: the arch drafting for itself on the same trace, beside
            # the plain run; the verify and commit passes on the batched 8
            lens = CONT_PROMPTS + ([MIXED_LONG] if name == "recurrentgemma-2b" else [])
            for kv in ((0, 8) if name == "gemma3-27b" else (0,)):
                key = short + ("_int8" if kv else "")
                lines, sl, bl, summary = spec_trace(cfg, params, cfg, params, counters, MIXED_CONT,
                                                    lens, kv, what=f"spec {key}")
                spec[key] = (sl, bl, summary)
                for line in lines:
                    log(line)
        if name == "gemma3-27b":
            # the prefix trace: the shared prefix is recomputed (rings are
            # rebuilt), its pages still shared
            computed = {}
            for sharing in (True, False):
                lines, got, _, peng = prefix_trace(cfg, params, counters, "chunked", sharing)
                key = "shared" if sharing else "unshared"
                paths[f"{short}_prefix_{key}"] = got
                computed[key] = (peng.prefill_tokens_total, peng.prefill_tokens_skipped,
                                 peng.prefix_hit_tokens)
                del peng
                for line in lines:
                    log(line)
            if computed["shared"][1] != 0:
                raise AssertionError(f"gemma3 prefix trace: prefill tokens (computed, skipped, hit) "
                                     f"{computed}; the shared prefix must be recomputed")
            log(f"gemma3 prefix trace: prefill tokens computed shared {computed['shared'][0]}, "
                f"unshared {computed['unshared'][0]}, skipped 0 ({computed['shared'][2]} context "
                f"tokens on shared pages, recomputed to rebuild the rings; only the forks, which "
                f"take their base's rows, compute less)")
        if name != "gemma3-27b":
            log(prefill_launch_check(cfg, params))
        del params
        gc.collect()
        torch.cuda.empty_cache()
        for line in slice8_reference_checks(make_reduced(cfg)):
            log(line)
    for line in slice9_spec_reference_checks():
        log(line)
    return paths, slice8_kernel_checks(gen), spec


# ---------------------------------------------------------------------------
# Slice 9: the encoder-decoder and VLM families (phase 15)
# ---------------------------------------------------------------------------

# seamless-m4t-medium: 4 stub sources of 1024 frames; both families serve
# BATCH prompts of PROMPT tokens for NEW new ones; internvl2-1b prepends
# 256 stub patches to each
ENC_FRAMES = 1024


@contextlib.contextmanager
def recorded_flash():
    """Record (causal, S, T, G) of every kernel-6 call the attention layers
    make inside the block; each call goes on to the wrapper, which counts
    the launch."""
    import repro_torch.models.attention as ma

    seen, real = [], ma.flash_attention_gqa

    def rec(q, k, v, q_pos, k_pos, **kw):
        seen.append((bool(kw.get("causal", True)), q.shape[1], k.shape[1], q.shape[2] // k.shape[2]))
        return real(q, k, v, q_pos, k_pos, **kw)

    ma.flash_attention_gqa = rec
    try:
        yield seen
    finally:
        ma.flash_attention_gqa = real


def flash_calls(seen) -> dict:
    """{"causal S x T G g" or "non-causal ...": calls} of a recorded run."""
    out = {}
    for causal, S, T, G in seen:
        key = f"{'causal' if causal else 'non-causal'} {S}x{T} G{G}"
        out[key] = out.get(key, 0) + 1
    return out


def slice9_reference_check(cfg) -> str:
    """A reduced f32 encoder-decoder or vlm config, the same weights and stub
    embeddings on the card (kernels) and on the CPU (plain versions): the
    encoder memory (seamless) and the teacher-forced logits within 1e-4
    (f32, TF32 off), and ``Engine`` greedy tokens identical."""
    from repro_torch.models.model import encode, forward, init_params
    from repro_torch.serving.engine import Engine, EngineConfig, Request

    on_card = init_params(cfg, seed=SEED, device="cuda")
    on_cpu = copy.deepcopy(on_card).to("cpu")
    g = torch.Generator().manual_seed(SEED + 24)
    toks = torch.randint(0, cfg.vocab_size, (3, 12), generator=g)
    n = 37 if cfg.encoder is not None else cfg.frontend.n_tokens
    emb = torch.randn((3, n, cfg.frontend.embed_dim), generator=g)
    kw, errs = {}, {}
    for dev, params in (("cuda", on_card), ("cpu", on_cpu)):
        e = emb.to(dev)
        if cfg.encoder is not None:
            kw[dev] = dict(memory=encode(cfg, params, e))
        else:
            kw[dev] = dict(prefix_embeds=e)
    if cfg.encoder is not None:
        errs["memory"] = (kw["cuda"]["memory"].cpu() - kw["cpu"]["memory"]).abs().max().item()
    with torch.no_grad():
        a, _ = forward(cfg, on_card, toks.cuda(), **kw["cuda"])
        b, _ = forward(cfg, on_cpu, toks, **kw["cpu"])
    assert a.shape == b.shape and torch.isfinite(a).all()
    errs["logits"] = (a.cpu() - b).abs().max().item()
    if not (torch.allclose(a.cpu(), b, atol=1e-4, rtol=1e-4) and errs.get("memory", 0) <= 1e-4):
        raise AssertionError(f"reduced {cfg.name}: card against CPU max|d| {errs}")
    ec = EngineConfig(max_batch=3, max_prefill=12, max_decode=8)
    reqs = [Request(toks[i, : 12 - 3 * i].tolist(), 8) for i in range(3)]
    card = [r.tokens for r in Engine(cfg, on_card, ec, device="cuda", **kw["cuda"]).generate(reqs)]
    cpu = [r.tokens for r in Engine(cfg, on_cpu, ec, device="cpu", **kw["cpu"]).generate(reqs)]
    if card != cpu:
        raise AssertionError(f"reduced {cfg.name}: greedy tokens on the card {card} != CPU {cpu}")
    return (f"slice-9 reference: reduced {cfg.name} f32, card (kernels) vs CPU (plain versions): "
            + ", ".join(f"{k} max|d| {v:.3e}" for k, v in errs.items())
            + f" (tolerance 1e-4), greedy tokens identical {card}")


def slice9_serve(counters) -> tuple:
    """Phase 15: seamless-m4t-medium and internvl2-1b at their published
    sizes, bf16 random weights and seeded stub embeddings, one tree at a
    time.  seamless: ``encode`` of 4 sources of ENC_FRAMES frames (kernel 6
    once per encoder layer, non-causal, S = T = 1024), then ``Engine(
    memory=...)`` on 4 prompts of PROMPT tokens for NEW (per prefill kernel
    6 once per decoder layer causal and once per cross attention,
    non-causal, 64 queries over 1024 keys; decode steps read the cross
    caches through ``_sdpa``: no kernel).  internvl2: ``Engine(
    prefix_embeds=...)``, 256 patches + PROMPT tokens (kernel 6 once per
    layer, causal, S = 320, G = 7).  Launches counted against those; a
    profile of 5 decode steps each; the reduced f32 models card vs CPU.
    Returns (launches by path, kernel-6 calls by path)."""
    from repro_torch.configs.registry import get_config, make_reduced
    from repro_torch.models.model import encode, init_params
    from repro_torch.serving.engine import Engine, EngineConfig, Request

    paths, calls = {}, {}
    for name in ("seamless-m4t-medium", "internvl2-1b"):
        cfg = get_config(name)
        short = name.split("-")[0]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = init_params(cfg, seed=SEED, device="cuda")
        torch.cuda.synchronize()
        n_params = sum(b.numel() for b in params.buffers())
        G = cfg.num_heads // cfg.num_kv_heads
        n_enc = sum(s.num_layers for s in cfg.encoder.segments) if cfg.encoder is not None else 0
        enc = f"{n_enc} encoder + " if n_enc else ""
        log(f"slice 9: {cfg.name} at its published size, {enc}{cfg.num_layers} decoder layers, "
            f"d_model {cfg.d_model}, {cfg.num_heads} heads over {cfg.num_kv_heads} (G = {G}), dh "
            f"{cfg.head_dim}, vocab {cfg.vocab_size}; {n_params / 1e9:.3f} G parameters "
            f"({torch.cuda.memory_allocated() / 1e9:.2f} GB) drawn on the card in "
            f"{time.perf_counter() - t0:.1f} s")
        egen = torch.Generator(device="cuda").manual_seed(SEED + 25)
        rng = torch.Generator().manual_seed(SEED + 26)
        reqs = [Request(torch.randint(0, cfg.vocab_size, (PROMPT,), generator=rng).tolist(), NEW)
                for _ in range(BATCH)]
        kw = {}
        if cfg.encoder is not None:
            src = torch.randn((BATCH, ENC_FRAMES, cfg.frontend.embed_dim), generator=egen,
                              device="cuda").bfloat16()
            encode(cfg, params, src)  # warm-up
            torch.cuda.synchronize()
            reset(*counters)
            with recorded_flash() as seen:
                t0 = time.perf_counter()
                memory = encode(cfg, params, src)
                torch.cuda.synchronize()
                enc_ms = (time.perf_counter() - t0) * 1e3
            got = read(counters, f"{short} encode")
            want = {k: 0 for k in got}
            want["flash_attention"] = n_enc
            ref_calls = {f"non-causal {ENC_FRAMES}x{ENC_FRAMES} G{G}": n_enc}
            if got != want or flash_calls(seen) != ref_calls:
                raise AssertionError(f"{short} encode launches {got} ({flash_calls(seen)}), expected "
                                     f"{want} ({ref_calls})")
            assert memory.shape == (BATCH, ENC_FRAMES, cfg.d_model) and torch.isfinite(memory).all()
            paths[f"{short}_encode"], calls[f"{short}_encode"] = got, flash_calls(seen)
            log(f"{short} encode: {BATCH} sources x {ENC_FRAMES} frames through {n_enc} encoder "
                f"layers in {enc_ms:.3f} ms; memory {tuple(memory.shape)} finite; launches {got}; "
                f"kernel-6 calls {flash_calls(seen)}")

            def run_encode(prof):
                with prof or contextlib.nullcontext():
                    t0 = time.perf_counter()
                    encode(cfg, params, src)
                    torch.cuda.synchronize()
                    return (time.perf_counter() - t0) * 1e3

            for line in profile_account(run_encode, 1, f"{short} encode"):
                log(line)
            kw = dict(memory=memory)
            prefill_calls = {f"causal {PROMPT}x{PROMPT} G{G}": cfg.num_layers,
                             f"non-causal {PROMPT}x{ENC_FRAMES} G{G}": cfg.num_layers}
        else:
            P = cfg.frontend.n_tokens
            kw = dict(prefix_embeds=torch.randn((BATCH, P, cfg.frontend.embed_dim), generator=egen,
                                                device="cuda").bfloat16())
            prefill_calls = {f"causal {P + PROMPT}x{P + PROMPT} G{G}": cfg.num_layers}
        eng = Engine(cfg, params, EngineConfig(max_batch=BATCH, max_prefill=PROMPT, max_decode=NEW),
                     device="cuda", **kw)
        eng.generate(reqs)  # warm-up
        torch.cuda.synchronize()
        reset(*counters)
        with recorded_flash() as seen:
            t0 = time.perf_counter()
            out = eng.generate(reqs)
            wall = time.perf_counter() - t0
        got = read(counters, f"{short} serve")
        assert len(out) == BATCH and all(len(r.tokens) == NEW for r in out)
        assert all(0 <= tok < cfg.vocab_size for r in out for tok in r.tokens)
        want = {k: 0 for k in got}
        want["flash_attention"] = sum(prefill_calls.values())
        if got != want or flash_calls(seen) != prefill_calls:
            raise AssertionError(f"{short} serve launches {got} ({flash_calls(seen)}), expected "
                                 f"{want} ({prefill_calls})")
        paths[f"{short}_static"], calls[f"{short}_static"] = got, flash_calls(seen)
        tm = eng.last_timings
        step_ms = statistics.median(tm["decode_step_s"]) * 1e3
        given = (f"a memory of {ENC_FRAMES} frames" if cfg.encoder is not None
                 else f"{cfg.frontend.n_tokens} patches before each")
        log(f"{short} serve: {BATCH} requests x {NEW} tokens (prompts of {PROMPT}, {given}) in "
            f"{wall * 1e3:.3f} ms ({BATCH * NEW / wall:.1f} tok/s); prefill "
            f"{tm['prefill_s'] * 1e3:.3f} ms; decode step median {step_ms:.3f} ms over "
            f"{len(tm['decode_step_s'])} steps; launches {got}; kernel-6 calls {flash_calls(seen)}; "
            f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        log(f"{short} serve: tokens of request 0: {out[0].tokens}")
        for line in profile_decode(eng, cfg, params, what=f"{short} decode"):
            log(line)
        del eng, params, kw
        gc.collect()
        torch.cuda.empty_cache()
        log(slice9_reference_check(make_reduced(cfg)))
    return paths, calls


def slice9_kernel_checks(gen) -> dict:
    """Kernel 6 against its plain version at the slice-9 shapes, in bf16 and
    f32, each timed from CUDA graphs beside its bound and SDPA: non-causal
    4 x 1024 at 16 heads over 16 (G = 1, dh 64: seamless's encoder),
    non-causal 64 queries at position 0 over 1024 keys (its cross
    attention), causal 4 x 320 at 14 heads over 2 (G = 7, dh 64:
    internvl2's prefill); and untimed, non-causal with empty keys (k_pos
    -1: every 5th key, and all of row 2's, which must give 0).  Returns
    ({shape: info} non-causal, {shape: info} G = 7)."""
    from repro_torch.kernels import flash_attention as k6

    nc, g7 = {}, {}
    for dt, tol, dl in ((torch.bfloat16, BF16_TOL, "bf16"), (torch.float32, F32_TOL, "f32")):
        for store, label, (B, S, T, H, Hkv, causal, qzero) in (
                (nc, "encoder_4x1024", (BATCH, ENC_FRAMES, ENC_FRAMES, 16, 16, False, False)),
                (nc, "cross_64x1024", (BATCH, PROMPT, ENC_FRAMES, 16, 16, False, True)),
                (g7, "internvl2_4x320", (BATCH, 256 + PROMPT, 256 + PROMPT, 14, 2, True, False))):
            q = torch.randn((B, S, H, 64), generator=gen, device="cuda").to(dt)
            k, v = (torch.randn((B, T, Hkv, 64), generator=gen, device="cuda").to(dt)
                    for _ in range(2))
            qpos = (torch.zeros((B, S), dtype=torch.int32, device="cuda") if qzero else
                    torch.arange(S, dtype=torch.int32, device="cuda").expand(B, S).contiguous())
            kpos = torch.arange(T, dtype=torch.int32, device="cuda").expand(B, T).contiguous()
            kw = dict(scale=0.125, causal=causal)
            info = flash_info(q, k, qpos, kpos, kw)
            if dt == torch.bfloat16:
                info["q_tile"] = q_tile_of(q)
            info.update(check_flash((q, k, v, qpos, kpos), kw, tol, n=10,
                                    library=lambda: sdpa_full(q, k, v, kw["scale"], causal)))
            info.update(causal=causal, G=H // Hkv)
            store[f"{dl}_{label}"] = info
            log(f"kernel flash_attention {dl} {label} ({'causal' if causal else 'non-causal'}, "
                f"{H} heads over {Hkv}, dh 64{', queries at position 0' if qzero else ''}): "
                f"{json.dumps(info)}")
            del q, k, v
        # empty keys, non-causal: every 5th key empty, row 2's all
        q = torch.randn((3, PROMPT, 16, 64), generator=gen, device="cuda").to(dt)
        k, v = (torch.randn((3, 300, 16, 64), generator=gen, device="cuda").to(dt) for _ in range(2))
        qpos = torch.zeros((3, PROMPT), dtype=torch.int32, device="cuda")
        kpos = torch.arange(300, dtype=torch.int32, device="cuda").expand(3, 300).contiguous()
        kpos[:, ::5] = -1
        kpos[2] = -1
        kw = dict(scale=0.125, causal=False)
        info = flash_info(q, k, qpos, kpos, kw)
        info.update(check_flash((q, k, v, qpos, kpos), kw, tol, timed=False))
        if k6.flash_attention_gqa(q, k, v, qpos, kpos, **kw)[2].abs().max().item() != 0:
            raise AssertionError(f"kernel 6 non-causal {dl}: a row with no valid key must give 0")
        nc[f"{dl}_empty_keys_64x300"] = info
        log(f"kernel flash_attention {dl} non-causal, 64 queries over 300 keys, every 5th key "
            f"and all of row 2 empty (row 2 gives 0): {json.dumps(info)}")
    return nc, g7


# ---------------------------------------------------------------------------
# Slice 10: training and Mixture-of-Students (phase 17)
# ---------------------------------------------------------------------------

TRAIN_ARCH, MOS_ARCH = "nlg-350m-prmoe-32-64", "nlg-350m-prmoe-mos"
TRAIN_BATCH, TRAIN_SEQ = 8, 512  # 4096 tokens a step
TRAIN_STEPS, MOS_STEPS, KD_STOP = 8, 6, 3
# peak LR, warmup of one step, cosine over the run: at 1e-3 (the launcher's
# default) the full-size loss rose from 11.42 to 11.74 over 8 steps on the
# H100 (Adam's first steps move every weight by about lr at once)
TRAIN_LR = 1e-4
# reduced f32, card against CPU: steps, and the parameters' tolerance after
# them.  Adam's first steps move a value by about lr * sign(g), so a
# gradient that is about 0 on both sides (within their f32 rounding) can
# take opposite signs: each step may then part the two trees by up to 2 lr
# (times the schedule's multiplier, at most 1).
REF_STEPS, REF_LR = 3, 1e-3
REF_PARAM_TOL = 2 * REF_LR * REF_STEPS


@contextlib.contextmanager
def timed_adamw(times):
    """CUDA-event time of every AdamW update the trainer makes inside the
    block (the name ``training/trainer.py`` imported, wrapped)."""
    import repro_torch.training.trainer as tr

    real = tr.adamw_update

    def timed(*a, **kw):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = real(*a, **kw)
        e1.record()
        times.append((e0, e1))
        return out

    tr.adamw_update = timed
    try:
        yield times
    finally:
        tr.adamw_update = real


def train_want(cfg, launches, steps, remat=False, teacher=None) -> dict:
    """Launches of ``steps`` training steps: per step kernel 6 once per
    attention layer (twice under remat) and 6b once; per MoE layer under
    the capacity dispatch kernel 1 once (twice under remat) and 1b once,
    under ``grouped`` neither (its gating is plain); SwiGLU experts through
    kernel 2 and 2b (capacity) or 4 and 4b (grouped) as often (GELU experts
    are products); a teacher's no-grad forward adds its kernel 6, 1 and
    expert calls; nothing else."""
    from repro_torch.configs.base import AttnSpec
    from repro_torch.core.moe import NO_MESH_IMPL

    def counts(c):
        moe = [ls.ffn for ls in c.layer_specs() if ls.ffn.kind == "moe"]
        grouped = NO_MESH_IMPL.get(c.moe_impl, c.moe_impl) == "grouped"
        swiglu = sum(f.act == "swiglu" for f in moe)
        return (sum(isinstance(ls.mixer, AttnSpec) for ls in c.layer_specs()),
                0 if grouped else len(moe), "grouped_mlp" if grouped else "expert_mlp", swiglu)

    n_attn, n_gate, expert, n_swiglu = counts(cfg)
    fwd = 2 if remat else 1
    want = {k: 0 for k in launches}
    want["flash_attention"] = fwd * n_attn * steps
    want["flash_attention_backward"] = n_attn * steps
    want["moe_gating"] = fwd * n_gate * steps
    want["moe_gating_backward"] = n_gate * steps
    want[expert] = fwd * n_swiglu * steps
    want[expert + "_backward"] = n_swiglu * steps
    if teacher is not None:
        t_attn, t_gate, t_expert, t_swiglu = counts(teacher)
        want["flash_attention"] += t_attn * steps
        want["moe_gating"] += t_gate * steps
        want[t_expert] += t_swiglu * steps
    return want


def run_steps(step_fn, params, opt, data, steps, counters, what, extra=()):
    """``steps`` calls of a train or distill step, each on the host clock
    ending in a sync; launches counted over them.  Returns (rows, ms per
    step, AdamW ms per step, launches, params, opt)."""
    rows, ms, adam = [], [], []
    reset(*counters)
    with timed_adamw(adam):
        for _ in range(steps):
            toks, labels = next(data)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step_fn(params, opt, *extra, toks, labels)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            rows.append({k: float(v) for k, v in m.items()})
    got = read(counters, what)
    adam_ms = [a.elapsed_time(b) for a, b in adam]
    return rows, ms, adam_ms, got, params, opt


def slice10_train(counters) -> tuple:
    """Phase 17b-d.  b: nlg-350m-prmoe-32-64 at its published size (4.11 G
    parameters, bf16, moe_impl "dense") trained TRAIN_STEPS AdamW steps of
    TRAIN_BATCH x TRAIN_SEQ tokens of the Markov data (seed 0): loss, ce,
    aux and grad norm per step, median step ms, tokens/s, AdamW ms, peak
    memory, launches of 6 / 6b / 1 / 1b against their counts (nothing else),
    a profile of one step.  c: the MoS student nlg-350m-prmoe-mos (21
    layers) distilled from the trained tree for MOS_STEPS steps with
    kd_stop_step KD_STOP (α from 1 to 0).  d: the student saved with the
    port's checkpoint ``save``, loaded back with ``load_checkpoint`` and
    served (4 requests x 16 tokens) through ``Engine``: the tokens equal the
    in-memory tree's.  Returns (launches by path, summary)."""
    import shutil

    from repro_torch.checkpoint import ckpt
    from repro_torch.configs.base import count_params
    from repro_torch.configs.registry import get_config
    from repro_torch.convert import load_checkpoint
    from repro_torch.data.pipeline import data_stream
    from repro_torch.models.model import init_params, param_leaves, trainable
    from repro_torch.serving.engine import Engine, EngineConfig, Request
    from repro_torch.training.distill import KDConfig, make_distill_step
    from repro_torch.training.optimizer import init_adamw
    from repro_torch.training.trainer import TrainConfig, make_train_step

    paths, summary = {}, {}
    cfg = get_config(TRAIN_ARCH).replace(moe_impl="dense")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in param_leaves(params).values())
    if n_params != count_params(cfg):
        raise AssertionError(f"{cfg.name}: {n_params} parameters, count_params {count_params(cfg)}")
    n_moe = sum(ls.ffn.kind == "moe" for ls in cfg.layer_specs())
    log(f"train: {cfg.name} at its published size, {cfg.num_layers} layers ({n_moe} MoE: "
        f"{', '.join(str(s.pattern[1].ffn.num_experts) + ' experts x ' + str(s.repeats) for s in cfg.segments)}; "
        f"top-1, residual MLP), d_model {cfg.d_model}, {cfg.num_heads} heads, dh {cfg.head_dim}, "
        f"vocab {cfg.vocab_size}: {n_params} parameters (= count_params), bf16, drawn on the card "
        f"in {time.perf_counter() - t0:.1f} s; moe_impl 'dense', no remat")
    tc = TrainConfig(lr=TRAIN_LR, warmup_steps=1, decay_steps=TRAIN_STEPS)
    opt = init_adamw(trainable(params))
    data = data_stream(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=SEED, device="cuda")
    step = make_train_step(cfg, tc)
    rows, ms, adam_ms, got, params, opt = run_steps(step, params, opt, data, TRAIN_STEPS, counters,
                                                    "train")
    peak = torch.cuda.max_memory_allocated() / 1e9
    for i, r in enumerate(rows):
        log(f"train step {i}: loss {r['loss']:.5f} ce {r['ce']:.5f} aux {r['aux']:.5f} grad norm "
            f"{r['grad_norm']:.4f} lr_scale {r['lr_scale']:.4f}; {ms[i]:.3f} ms (AdamW "
            f"{adam_ms[i]:.3f} ms)")
    want = train_want(cfg, got, TRAIN_STEPS)
    if got != want:
        raise AssertionError(f"train launches {got}, expected {want}")
    if not all(math.isfinite(r["loss"]) for r in rows) or not rows[-1]["loss"] < rows[0]["loss"]:
        raise AssertionError(f"train: losses {[r['loss'] for r in rows]}: the last is not below "
                             "the first")
    paths["train"] = got
    med = statistics.median(ms[1:])
    summary["train"] = {"step_ms_median": med, "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / med * 1e3,
                        "adamw_ms_median": statistics.median(adam_ms[1:]), "peak_gb": peak,
                        "first_step_ms": ms[0], "losses": [r["loss"] for r in rows],
                        "params": n_params, "launches": got}
    log(f"train summary: {json.dumps(summary['train'])}")

    def run_profile(prof):
        toks, labels = next(data)
        nonlocal params, opt
        torch.cuda.synchronize()
        with prof or contextlib.nullcontext():
            t0 = time.perf_counter()
            params, opt, _ = step(params, opt, toks, labels)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

    for line in profile_account(run_profile, 1, "train step"):
        log(line)

    # c. Mixture-of-Students: the trained tree as teacher, its moments freed
    teacher = params
    trainable(teacher, False)
    del opt, params
    gc.collect()
    torch.cuda.empty_cache()
    scfg = get_config(MOS_ARCH).replace(moe_impl="dense")
    torch.cuda.reset_peak_memory_stats()
    student = init_params(scfg, seed=SEED + 1, device="cuda")
    n_student = sum(t.numel() for t in param_leaves(student).values())
    if n_student != count_params(scfg):
        raise AssertionError(f"{scfg.name}: {n_student} parameters, count_params {count_params(scfg)}")
    kdc = KDConfig(alpha=1.0, temperature=1.0, kd_stop_step=KD_STOP)
    mtc = TrainConfig(lr=TRAIN_LR, warmup_steps=1, decay_steps=MOS_STEPS)
    sopt = init_adamw(trainable(student))
    dstep = make_distill_step(scfg, cfg, mtc, kdc)
    rows, ms, adam_ms, got, student, sopt = run_steps(dstep, student, sopt, data, MOS_STEPS,
                                                      counters, "mos", extra=(teacher,))
    want = train_want(scfg, got, MOS_STEPS, teacher=cfg)
    alphas = [r["kd_alpha"] for r in rows]
    if got != want or alphas != [1.0] * KD_STOP + [0.0] * (MOS_STEPS - KD_STOP):
        raise AssertionError(f"mos launches {got} (expected {want}), kd_alpha {alphas}")
    if not all(math.isfinite(r["loss"]) for r in rows):
        raise AssertionError(f"mos: losses {[r['loss'] for r in rows]}")
    paths["mos"] = got
    log(f"mos: student {scfg.name}, {scfg.num_layers} layers, {n_student} parameters (= "
        f"count_params), bf16, from the trained teacher; KD alpha 1.0, tau 1.0, kd_stop_step "
        f"{KD_STOP}; launches {got}")
    for i, r in enumerate(rows):
        log(f"mos step {i}: loss {r['loss']:.5f} ce {r['ce']:.5f} kl {r['kl']:.5f} aux "
            f"{r['aux']:.5f} kd_alpha {r['kd_alpha']:.1f} grad norm {r['grad_norm']:.4f}; "
            f"{ms[i]:.3f} ms (AdamW {adam_ms[i]:.3f} ms)")
    summary["mos"] = {"step_ms_median": statistics.median(ms[1:]),
                      "adamw_ms_median": statistics.median(adam_ms[1:]),
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "kd_alpha": alphas,
                      "ce": [r["ce"] for r in rows], "kl": [r["kl"] for r in rows],
                      "params": n_student, "launches": got}
    log(f"mos summary: {json.dumps(summary['mos'])}")

    # d. checkpoint the student, load it back, serve both trees
    trainable(student, False)
    del sopt, teacher
    gc.collect()
    torch.cuda.empty_cache()
    ck = Path(__file__).resolve().parent / "build" / "slice10_student_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    ck.parent.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(ck.parent).free
    t0 = time.perf_counter()
    nbytes = ckpt.save(str(ck), student, step=MOS_STEPS)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = load_checkpoint(str(ck), scfg, "cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    shutil.rmtree(ck, ignore_errors=True)
    rng = torch.Generator().manual_seed(SEED + 30)
    reqs = [Request(torch.randint(0, scfg.vocab_size, (PROMPT,), generator=rng).tolist(), NEW)
            for _ in range(BATCH)]
    ec = EngineConfig(max_batch=BATCH, max_prefill=PROMPT, max_decode=NEW)
    mem = [r.tokens for r in Engine(scfg, student, ec, device="cuda").generate(reqs)]
    back = [r.tokens for r in Engine(scfg, loaded, ec, device="cuda").generate(reqs)]
    if mem != back:
        raise AssertionError(f"checkpoint: the loaded student serves {back}, the in-memory {mem}")
    summary["checkpoint"] = {"bytes": nbytes, "save_s": save_s, "load_s": load_s,
                             "disk_free_before_gb": free / 1e9}
    log(f"checkpoint: the student saved ({nbytes} bytes in {save_s:.2f} s, "
        f"{nbytes / save_s / 1e9:.2f} GB/s; disk free before {free / 1e9:.1f} GB) and loaded "
        f"back onto the card in {load_s:.2f} s (load_checkpoint); {BATCH} requests x {NEW} "
        f"tokens through Engine give identical tokens from both trees; request 0: {mem[0]}")
    del student, loaded
    gc.collect()
    torch.cuda.empty_cache()
    return paths, summary


def slice10_reference_checks() -> list:
    """Phase 17e: reduced f32 nlg-350m-prmoe-32-64 from the same weights and
    batches on the card (kernels 6, 6b, 1, 1b) and on the CPU (plain
    versions): first-step gradients per leaf within 1e-4 of the leaf's
    largest; REF_STEPS train steps under einsum and under dense, losses per
    step within 1e-5 relative, parameters after them within REF_PARAM_TOL;
    then 2 distill steps of the reduced MoS student from the trained trees,
    losses within 1e-5 relative."""
    from repro_torch.configs.registry import get_config, make_reduced
    from repro_torch.data.synthetic import batches
    from repro_torch.models.model import init_params, param_leaves, trainable
    from repro_torch.training.distill import KDConfig, make_distill_step
    from repro_torch.training.optimizer import init_adamw
    from repro_torch.training.trainer import TrainConfig, loss_fn, make_train_step

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)

    red = make_reduced(get_config(TRAIN_ARCH))
    data = batches(red.vocab_size, 4, 32, seed=SEED + 5)
    bat = [next(data) for _ in range(REF_STEPS + 2)]
    on = lambda arr, dev: torch.from_numpy(arr.astype(np.int64)).to(dev)
    tc = TrainConfig(lr=REF_LR, warmup_steps=1, decay_steps=REF_STEPS)
    lines, trees = [], {}
    for impl in ("einsum", "dense"):
        cfg = red.replace(moe_impl=impl)
        cpu = init_params(cfg, seed=SEED + 6, device="cpu")
        card = copy.deepcopy(cpu).to("cuda")
        grads = {}
        for dev, p in (("cuda", card), ("cpu", cpu)):
            leaves = trainable(p)
            with torch.enable_grad():
                loss, _ = loss_fn(cfg, p, on(bat[0][0], dev), on(bat[0][1], dev))
            grads[dev] = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        worst = max((grads["cuda"][k].cpu() - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
                    for k, g in grads["cpu"].items())
        if worst > 1e-4:
            raise AssertionError(f"reduced train {impl}: a first-step gradient differs by {worst:.3e} "
                                 "of its leaf's largest")
        losses = {}
        for dev, p in (("cuda", card), ("cpu", cpu)):
            opt = init_adamw(trainable(p))
            step = make_train_step(cfg, tc)
            losses[dev] = []
            for toks, labels in bat[:REF_STEPS]:
                p, opt, m = step(p, opt, on(toks, dev), on(labels, dev))
                losses[dev].append(float(m["loss"]))
        lw = max(rel(a, b) for a, b in zip(losses["cuda"], losses["cpu"]))
        pc, pp = param_leaves(card), param_leaves(cpu)
        dp = max((pc[k].detach().cpu() - v.detach()).abs().max().item() for k, v in pp.items())
        n_far = sum(int(((pc[k].detach().cpu() - v.detach()).abs() > 1e-5).sum()) for k, v in pp.items())
        n_all = sum(v.numel() for v in pp.values())
        if lw > 1e-5 or dp > REF_PARAM_TOL:
            raise AssertionError(f"reduced train {impl}: losses {losses} (worst rel {lw:.3e}), params "
                                 f"apart by {dp:.3e} (tolerance {REF_PARAM_TOL})")
        lines.append(f"reduced f32 train ({impl}), card vs CPU: first-step gradients within "
                     f"{worst:.3e} of each leaf's largest; losses {losses['cuda']} vs "
                     f"{losses['cpu']} (worst rel {lw:.3e}); params after {REF_STEPS} steps within "
                     f"{dp:.3e} (tolerance {REF_PARAM_TOL:g}), {n_far} of {n_all} values apart by "
                     f"more than 1e-5")
        trees[impl] = (cfg, card, cpu)
    cfg, card, cpu = trees["dense"]
    scfg = make_reduced(get_config(MOS_ARCH))
    s_cpu = init_params(scfg, seed=SEED + 7, device="cpu")
    s_card = copy.deepcopy(s_cpu).to("cuda")
    kdc = KDConfig(kd_stop_step=1)
    losses = {}
    for dev, s, t in (("cuda", s_card, card), ("cpu", s_cpu, cpu)):
        trainable(t, False)
        opt = init_adamw(trainable(s))
        step = make_distill_step(scfg, cfg, tc, kdc)
        losses[dev] = []
        for toks, labels in bat[REF_STEPS:REF_STEPS + 2]:
            s, opt, m = step(s, opt, t, on(toks, dev), on(labels, dev))
            losses[dev].append((float(m["loss"]), float(m["kl"]), float(m["kd_alpha"])))
    lw = max(rel(a[0], b[0]) for a, b in zip(losses["cuda"], losses["cpu"]))
    if lw > 1e-5 or [a[2] for a in losses["cuda"]] != [1.0, 0.0]:
        raise AssertionError(f"reduced distill: (loss, kl, kd_alpha) {losses} (worst rel {lw:.3e})")
    lines.append(f"reduced f32 distill (dense), card vs CPU: (loss, kl, kd_alpha) per step "
                 f"{losses['cuda']} vs {losses['cpu']} (worst rel {lw:.3e})")
    return lines


def slice10_guard() -> str:
    """Phase 17f: a grad-enabled forward of reduced llama4-maverick under
    ``grouped`` with int8 experts (kernel 5, MoQ weights: post-training, no
    backward) raises before it launches."""
    from repro_torch.configs.base import QuantConfig
    from repro_torch.configs.registry import get_config, make_reduced
    from repro_torch.kernels import expert_mlp_grouped as gk
    from repro_torch.models.model import forward, init_params, trainable
    from repro_torch.quant import quantize_params

    cfg = make_reduced(get_config(ARCH)).replace(moe_impl="grouped")
    params = init_params(cfg, seed=SEED, device="cuda")
    trainable(params)  # every other leaf of the quantized tree is one of these
    qparams = quantize_params(params, QuantConfig(bits=8, policy="experts"))
    toks = torch.randint(0, cfg.vocab_size, (2, 16), device="cuda")
    before = dict(gk.launches)
    try:
        with torch.enable_grad():
            forward(cfg, qparams, toks)
    except RuntimeError as e:
        if "no backward" not in str(e) or gk.launches != before:
            raise
        return (f"guard: a grad-enabled forward of reduced {cfg.name} under grouped with int8 "
                f"experts raises before kernel 5 launches: {e}")
    raise AssertionError("guard: a grad-enabled forward through kernel 5 ran without a backward")


def slice10_kernel_checks(gen) -> tuple:
    """Phase 17a: kernels 6b, 1b, 2b and 4b against their plain versions at
    ``launch/training_kernels.py``'s cases (bf16 and f32), timed from CUDA
    graphs beside their bounds and the SDPA backward (6b) or the cuBLAS
    composite (2b, 4b), with kernel 6's forward with and without its L
    output; 6b, 2b and 4b also bit for bit over two launches on the same
    inputs (``deterministic``), 6b with its blocks per pass beside the SM
    count (``blocks``), 2b and 4b with dead rows and empty experts exactly
    0.  Returns ({case: info} 6b, {case: info} 1b, {case: info} 2b, {case:
    info} 4b)."""
    from repro_torch.launch import training_kernels as tk

    fb, gb, cb, ob = {}, {}, {}, {}
    for name, case in tk.EXPERT_BWD_CASES.items():
        for dt in (torch.bfloat16, torch.float32):
            res = tk.check_expert_bwd(name, *case, dt, gen)
            key = f"{'bf16' if dt == torch.bfloat16 else 'f32'}_{name}"
            kname = "expert_mlp_backward" if case[0] == "capacity" else "grouped_mlp_backward"
            (cb if case[0] == "capacity" else ob)[key] = res
            log(f"kernel {kname} {key}: {json.dumps(res)}")
            want = ["wgmma"] if dt == torch.bfloat16 else ["fma"]  # the wgmma passes at bf16
            if not res["ok"] or res["variant"] != want:
                raise AssertionError(f"kernel {kname} {key} disagrees with its plain version, two "
                                     f"launches differ, a dead row or empty expert is not 0, or it "
                                     f"took {res['variant']} (expected {want})")
    for name, case in tk.FLASH_BWD_CASES.items():
        for dt in (torch.bfloat16, torch.float32):
            res = tk.check_flash_bwd(name, *case, dt, gen, empty_key=name == "window")
            key = f"{str(dt).split('.')[-1].replace('bfloat16', 'bf16').replace('float32', 'f32')}_{name}"
            fb[key] = res
            log(f"kernel flash_attention_backward {key}: {json.dumps(res)}")
            if not res["ok"]:
                raise AssertionError(f"kernel 6b {key} disagrees with its plain version, or two "
                                     f"launches differ (deterministic: {res['deterministic']})")
    for name, (T, E, K, cf, bias) in tk.GATING_BWD_CASES.items():
        res = tk.check_gating_bwd(name, T, E, K, cf, bias, gen)
        gb[name] = res
        log(f"kernel moe_gating_backward {name}: {json.dumps(res)}")
        if not res["ok"]:
            raise AssertionError(f"kernel 1b {name} disagrees with its plain version")
    return fb, gb, cb, ob


# ---------------------------------------------------------------------------
# Slice 14: SwiGLU-MoE training (phases 17g, 17h)
# ---------------------------------------------------------------------------

S14_BATCH, S14_SEQ, S14_STEPS, S14_EXPERTS = 4, 512, 4, 16


def slice14_config():
    """llama4-maverick-400b-a17b at its published widths (d_model 5120, 40
    heads over 8 at dh 128, expert d_ff 8192 top-1 with capacity factor
    1.25, dense d_ff 16384, a shared expert of d_ff 8192, vocab 202048),
    cut in depth from 48 layers to one (dense, MoE) repeat and in experts
    from 128 to S14_EXPERTS, so its weights, gradients and f32 moments fit
    one card."""
    import dataclasses

    from repro_torch.configs.base import Segment
    from repro_torch.configs.registry import get_config

    full = get_config(ARCH)
    pat = tuple(dataclasses.replace(ls, ffn=dataclasses.replace(ls.ffn, num_experts=S14_EXPERTS))
                if ls.ffn.kind == "moe" else ls for ls in full.segments[0].pattern)
    return full.replace(segments=(Segment(pat, 1),))


def slice14_train(counters) -> tuple:
    """Phase 17g: ``slice14_config`` trained S14_STEPS AdamW steps of
    S14_BATCH x S14_SEQ tokens of the Markov data (seed 0, bf16 random
    weights from the seed, lr TRAIN_LR), first under the registry's
    ``moe_impl="ep"`` (the capacity table without a mesh: kernels 1, 1b, 2,
    2b, 6, 6b), then from the same weights under ``"grouped"`` (kernels 4,
    4b, 6, 6b): the peak reckoned from the parameter count first; loss, ce,
    aux and grad norm per step (finite), median step ms, tokens/s, AdamW
    ms, peak memory, launches against ``train_want`` (2 / 2b or 4 / 4b once
    per MoE layer per step, nothing else new), a profile of one step.
    Returns (launches by run, summary)."""
    from repro_torch.configs.base import count_params
    from repro_torch.data.pipeline import data_stream
    from repro_torch.models.model import init_params, param_leaves, trainable
    from repro_torch.training.optimizer import init_adamw
    from repro_torch.training.trainer import TrainConfig, make_train_step

    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.dryrun import state_bytes

    base = slice14_config()
    n_count = count_params(base)
    # the dry run's bytes of the trainer's state (on meta): parameters,
    # gradients (the parameters' dtype: no accumulation), AdamW's moments
    dry = state_bytes(base, InputShape("llama4 train", S14_SEQ, S14_BATCH, "train"),
                      accumulate=False)
    reckon = sum(dry.values()) / 1e9
    logits = 2 * S14_BATCH * S14_SEQ * base.vocab_size * 4 / 1e9
    total = torch.cuda.get_device_properties(0).total_memory / 1e9
    log(f"llama4 train: {base.name} cut to {base.num_layers} layers and {S14_EXPERTS} of 128 "
        f"experts, published widths; {n_count} parameters (count_params): reckoned peak "
        f"{reckon:.1f} GB from the dry run (" + ", ".join(f"{k} {v / 1e9:.2f}" for k, v in dry.items())
        + f" GB) + {logits:.1f} GB of f32 logits (two copies) = {reckon + logits:.1f} GB of the "
        f"card's {total:.1f} GB")
    if reckon + logits > 0.95 * total:
        raise AssertionError("llama4 train: the reckoned peak does not fit the card")
    paths, summary = {}, {}
    for impl in ("ep", "grouped"):
        cfg = base.replace(moe_impl=impl)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = init_params(cfg, seed=SEED, device="cuda")
        n_params = sum(t.numel() for t in param_leaves(params).values())
        if n_params != n_count:
            raise AssertionError(f"{cfg.name}: {n_params} parameters, count_params {n_count}")
        tc = TrainConfig(lr=TRAIN_LR, warmup_steps=1, decay_steps=S14_STEPS)
        opt = init_adamw(trainable(params))
        data = data_stream(cfg.vocab_size, S14_BATCH, S14_SEQ, seed=SEED, device="cuda")
        step = make_train_step(cfg, tc)
        what = f"llama4 train {impl}"
        rows, ms, adam_ms, got, params, opt = run_steps(step, params, opt, data, S14_STEPS, counters,
                                                        what)
        peak = torch.cuda.max_memory_allocated() / 1e9
        for i, r in enumerate(rows):
            log(f"{what} step {i}: loss {r['loss']:.5f} ce {r['ce']:.5f} aux {r['aux']:.5f} grad "
                f"norm {r['grad_norm']:.4f} lr_scale {r['lr_scale']:.4f}; {ms[i]:.3f} ms (AdamW "
                f"{adam_ms[i]:.3f} ms)")
        want = train_want(cfg, got, S14_STEPS)
        if got != want:
            raise AssertionError(f"{what} launches {got}, expected {want}")
        if not all(math.isfinite(r[k]) for r in rows for k in ("loss", "ce", "aux", "grad_norm")):
            raise AssertionError(f"{what}: metrics {rows} are not finite")
        paths[impl] = got
        med = statistics.median(ms[1:])
        summary[impl] = {"step_ms_median": med,
                         "tokens_per_s": S14_BATCH * S14_SEQ / med * 1e3,
                         "adamw_ms_median": statistics.median(adam_ms[1:]),
                         "adamw_share": statistics.median(adam_ms[1:]) / med,
                         "peak_gb": peak, "reckoned_gb": reckon + logits, "first_step_ms": ms[0],
                         "losses": [r["loss"] for r in rows], "params": n_params,
                         "launches": {k: v for k, v in got.items() if v}}
        log(f"{what} summary: {json.dumps(summary[impl])}")

        def run_profile(prof):
            toks, labels = next(data)
            nonlocal params, opt
            torch.cuda.synchronize()
            with prof or contextlib.nullcontext():
                t0 = time.perf_counter()
                params, opt, _ = step(params, opt, toks, labels)
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) * 1e3

        p17 = {}
        for line in profile_account(run_profile, 1, f"{what} step", into=p17):
            log(line)
        log(f"{what}: peak {peak:.2f} GB measured against {reckon + logits:.2f} GB reckoned from "
            f"the dry run's bytes and the f32 logits")
        if impl == "ep":
            lines, params, opt = train_analysis(step, params, opt, data, counters, what, p17)
            for line in lines:
                log(line)
        trainable(params, False)
        del params, opt, step, data
    gc.collect()
    torch.cuda.empty_cache()
    return paths, summary


def train_analysis(step, params, opt, data, counters, what, prof) -> tuple:
    """Phase 17g's checks on one llama4 step under ``ep``: its syncs
    located, its roofline (the backward kernels' entries too), and the
    in-place audit of the parameters and AdamW's moments across it.
    Returns (lines, params, opt)."""
    from repro_torch.analysis.donation import audit_inplace

    toks, labels = next(data)
    st = {"p": params, "o": opt}

    def one():
        st["p"], st["o"], _ = step(st["p"], st["o"], toks, labels)

    lines = [sync_sites(f"{what} step", one, 1)[0]]
    toks, labels = next(data)
    held = {}

    def roofline_step(p, o, t, lab):
        line, cap, _ = roofline_line(f"{what} step", step, (p, o, t, lab), counters, prof)
        held["line"] = line
        return cap.output

    rep, out = audit_inplace(f"{what} step", roofline_step, (st["p"], st["o"], toks, labels),
                             (0, 1), returns={0: 0, 1: 1})
    if rep.errors:
        raise AssertionError(rep.render())
    lines += [held["line"], f"in place: {what} step: parameters and moments kept their storage "
              f"({rep.metrics[f'inplace.{what} step.kept']} leaves, "
              f"{rep.metrics[f'inplace.{what} step.written']} written)"]
    return lines, out[0], out[1]


def slice14_reference_checks() -> list:
    """Phase 17h: reduced f32 llama4-maverick under ``ep`` and ``grouped``
    and kimi-k2 under ``ep`` (top-2 after reduction), from the same weights
    and batches on the card (kernels 1 / 1b / 2 / 2b or 4 / 4b, 6 / 6b, f32)
    and on the CPU (plain versions): first-step gradients per leaf within
    1e-4 of the leaf's largest; REF_STEPS train steps, losses within 1e-5
    relative, parameters after them within REF_PARAM_TOL."""
    from repro_torch.configs.registry import get_config, make_reduced
    from repro_torch.data.synthetic import batches
    from repro_torch.models.model import init_params, param_leaves, trainable
    from repro_torch.training.optimizer import init_adamw
    from repro_torch.training.trainer import TrainConfig, loss_fn, make_train_step

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)

    on = lambda arr, dev: torch.from_numpy(arr.astype(np.int64)).to(dev)
    tc = TrainConfig(lr=REF_LR, warmup_steps=1, decay_steps=REF_STEPS)
    lines = []
    for arch, impl in ((ARCH, "ep"), (ARCH, "grouped"), ("kimi-k2-1t-a32b", "ep")):
        cfg = make_reduced(get_config(arch)).replace(moe_impl=impl)
        data = batches(cfg.vocab_size, 4, 32, seed=SEED + 8)
        bat = [next(data) for _ in range(REF_STEPS)]
        cpu = init_params(cfg, seed=SEED + 9, device="cpu")
        card = copy.deepcopy(cpu).to("cuda")
        grads = {}
        for dev, p in (("cuda", card), ("cpu", cpu)):
            leaves = trainable(p)
            with torch.enable_grad():
                loss, _ = loss_fn(cfg, p, on(bat[0][0], dev), on(bat[0][1], dev))
            grads[dev] = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        worst = max((grads["cuda"][k].cpu() - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
                    for k, g in grads["cpu"].items())
        losses = {}
        for dev, p in (("cuda", card), ("cpu", cpu)):
            opt = init_adamw(trainable(p))
            step = make_train_step(cfg, tc)
            losses[dev] = []
            for toks, labels in bat:
                p, opt, m = step(p, opt, on(toks, dev), on(labels, dev))
                losses[dev].append(float(m["loss"]))
        lw = max(rel(a, b) for a, b in zip(losses["cuda"], losses["cpu"]))
        pc, pp = param_leaves(card), param_leaves(cpu)
        dp = max((pc[k].detach().cpu() - v.detach()).abs().max().item() for k, v in pp.items())
        what = f"reduced f32 train {arch} ({impl}, top-{cfg.layer_specs()[-1].ffn.top_k})"
        if worst > 1e-4 or lw > 1e-5 or dp > REF_PARAM_TOL:
            raise AssertionError(f"{what}: first-step gradients within {worst:.3e}, losses {losses} "
                                 f"(worst rel {lw:.3e}), params apart by {dp:.3e} (tolerance "
                                 f"{REF_PARAM_TOL})")
        lines.append(f"{what}, card vs CPU: first-step gradients within {worst:.3e} of each "
                     f"leaf's largest; losses {losses['cuda']} vs {losses['cpu']} (worst rel "
                     f"{lw:.3e}); params after {REF_STEPS} steps within {dp:.3e} (tolerance "
                     f"{REF_PARAM_TOL:g})")
    return lines


# ---------------------------------------------------------------------------
# Slice 17: the analysis and dry-run tooling on the card (inside the phases
# that hold the trees: 3, 4, 6b, 7, 9, 17g, 18, and the dry-run table)
# ---------------------------------------------------------------------------

LINT = []  # the lint report of src/repro_torch, made once


def lint_report():
    from repro_torch.analysis import lint_tree

    if not LINT:
        LINT.append(lint_tree(str(Path(__file__).resolve().parent / "src" / "repro_torch")))
    return LINT[0]


def sync_sites(what, run, steps) -> tuple:
    """``run()`` (``steps`` steps) under ``analysis/syncs.py``'s locator:
    every sync point the profiler counts located at its ``src/repro_torch``
    line (or the caller's), each such line a lint finding (raises
    otherwise).  Returns (the "sync sites:" line, the log)."""
    from repro_torch.analysis.syncs import SyncLog, check_against_lint, locate_syncs

    log = SyncLog()
    with locate_syncs(log):
        run()
    found = check_against_lint(log, lint_report(), what)
    line = (f"sync sites: {what}: {log.located / steps:g} host syncs a step "
            f"({dict(log.by_event)} over {steps} steps; {log.not_syncs / steps:g} CPU scalar reads "
            f"a step, no sync): {log.per_step(steps)}; lint: {'; '.join(found) or 'none in the package'}")
    return line, log


def roofline_line(what, fn, args, counters, prof, check=None) -> tuple:
    """One step ``fn(*args)`` captured (``analysis/graph.py``), its kernel
    entries held equal to the launch counters of the same step, and its
    ``op_account`` bound beside the profiled device ms and the unprofiled
    wall ms of the same step (``prof``, from ``profile_account``).  Returns
    (the "roofline:" line, the capture, its account)."""
    from repro_torch.analysis.graph import capture
    from repro_torch.launch.op_account import account
    from repro_torch.launch.roofline import analyze

    torch.cuda.synchronize()
    reset(*counters)
    cap = capture(fn, *args)
    torch.cuda.synchronize()
    got = {k: v for k, v in read(counters, f"roofline {what}").items() if v}
    if cap.kernels() != got:
        raise AssertionError(f"roofline {what}: kernel entries {cap.kernels()}, launches {got}")
    acct = account(cap)
    roof = analyze(acct)
    bound = roof.t_bound * 1e3
    dev, wall = prof.get("device_ms"), prof["wall_ms"]
    # a bound is the least time the card could take: above a measured time
    # it counts bytes or operations the step does not have
    if bound > min(t for t in (dev, wall) if t):
        raise AssertionError(f"roofline {what}: bound {bound:.4f} ms above the measured "
                             f"device {dev} ms / wall {wall:.4f} ms")
    dev_s = (f"device {dev:.3f} ms (profiler; the bound {100 * bound / dev:.1f}% of it)"
             if dev else "device ms not measured")
    line = (f"roofline: {what}: {acct.ops:.4g} operations ({', '.join(f'{k} {v:.4g}' for k, v in acct.ops_by_dtype.items())}), "
            f"{acct.traffic:.4g} bytes: bound {bound:.4f} ms ({roof.dominant}); {dev_s}, wall "
            f"{wall:.3f} ms (unprofiled; the bound {100 * bound / wall:.1f}% of it); kernel entries "
            f"{cap.kernels()} = launches; kernels' share of the bytes "
            f"{100 * sum(acct.kernel_bytes.values()) / max(acct.traffic, 1):.1f}%")
    return line, cap, acct


def decode_capture_args(eng, cfg, params):
    """(fn, args) of one static decode step at position PROMPT after a fresh
    prefill of BATCH x PROMPT tokens, as ``profile_decode`` steps it."""
    from repro_torch.models.model import decode_step, prefill

    toks = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(SEED + 17))
    caches = eng._make_caches(BATCH)
    logits, caches = prefill(cfg, params, toks, caches, memory=eng.memory,
                             prefix_embeds=eng.prefix_embeds)
    cur = logits.argmax(-1)[:, None]
    return (lambda c, t: decode_step(cfg, params, t, PROMPT + eng._offset, c, memory=eng.memory),
            (caches, cur))


def static_analysis(eng, cfg, params, reqs, counters, prof, drawn_bytes) -> list:
    """Phase 3's checks: the syncs of the 5 profiled decode steps and of one
    ``generate`` located, one decode step's roofline, its graph audit (no
    collective, no dtype drift), and the dry run's parameter bytes against
    the bytes the tree took when drawn (within 1%)."""
    from repro_torch.analysis.graph import audit_graph
    from repro_torch.launch.steps import abstract_params
    from repro_torch.quant import tree_bytes
    from repro_torch.models.model import decode_step, prefill

    toks = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), device="cuda")
    caches = eng._make_caches(BATCH)
    logits, caches = prefill(cfg, params, toks, caches)
    cur = [logits.argmax(-1)[:, None]]
    cur[0].cpu()

    def steps():
        for t in range(5):
            logits, _ = decode_step(cfg, params, cur[0], PROMPT + t, caches)
            cur[0] = logits.argmax(-1)[:, None]
            cur[0].cpu()

    lines = [sync_sites("static decode (the profiled loop: its read-back is the caller's)",
                        steps, 5)[0],
             sync_sites(f"static generate ({BATCH} x {PROMPT}, {NEW} new: a prefill and "
                        f"{NEW - 1} decode steps, per decode step)",
                        lambda: eng.generate(reqs), NEW - 1)[0]]
    fn, args = decode_capture_args(eng, cfg, params)
    line, cap, _ = roofline_line("static decode step (grouped, bf16)", fn, args, counters, prof)
    lines.append(line)
    rep = audit_graph("static decode", None, (), captured=cap)
    if rep.findings or rep.metrics["graph.static decode.collectives"]:
        raise AssertionError(f"graph audit of the static decode step: {rep.render()}")
    lines.append(f"graph audit: static decode step: no collective, no int8 -> float cast, "
                 f"{len(cap.records)} ops and kernel entries {cap.kernels()}")
    want = tree_bytes(abstract_params(cfg))
    err = abs(want - drawn_bytes) / drawn_bytes
    if err > 0.01:
        raise AssertionError(f"dry run: abstract_params {want} bytes, the tree took {drawn_bytes}")
    lines.append(f"dry run: abstract_params of {cfg.name} ({cfg.num_layers} layers) on meta "
                 f"{want / 1e9:.4f} GB, memory_allocated gained while drawing it "
                 f"{drawn_bytes / 1e9:.4f} GB ({100 * err:.3f}% apart)")
    return lines


def tick_analysis(eng, cfg, counters, prof) -> list:
    """Phase 4's checks: every slot decoding (each prefill done), the syncs
    of 5 ticks located, and one tick's roofline."""
    from repro_torch.serving.engine import Request

    rng = torch.Generator().manual_seed(SEED + 3)
    for _ in range(eng.n_slots):
        eng.submit(Request(torch.randint(0, cfg.vocab_size, (PROFILE_PROMPT,),
                                         generator=rng).tolist(), 48))
    while any(s.prefilling for s in eng.slots) or eng.queue:
        eng.step()
    lines = [sync_sites("continuous tick (every slot decoding)",
                        lambda: [eng.step() for _ in range(5)], 5)[0]]
    lines.append(roofline_line("continuous tick (8 slots decoding, paged bf16)", eng.step, (),
                               counters, prof)[0])
    eng.run_until_done()
    return lines


def dryrun_table() -> list:
    """Every assigned arch x shape on one card and EP meshes of 4 and 8
    ranks, on meta; the JSON beside the script in chiprun_out/dryrun.json."""
    from repro_torch.launch.dryrun import run_all, summary

    t0 = time.perf_counter()
    res = run_all()
    out = Path(__file__).resolve().parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "dryrun.json").write_text(json.dumps(res, indent=1))
    if any(r["status"] == "error" for r in res):
        raise AssertionError(f"dry run: {[r for r in res if r['status'] == 'error']}")
    fits = sorted(f"{r['arch']} x {r['shape']} ({r['mesh']}) {r['total_bytes'] / 1e9:.1f} GB"
                  for r in res if r["status"] == "ok" and r["fits"])
    return [f"dry run: {summary(res)} in {time.perf_counter() - t0:.1f} s on meta "
            f"(chiprun_out/dryrun.json); fits: {'; '.join(fits)}"]


# ---------------------------------------------------------------------------


def kernel_setup() -> tuple:
    """The launch counters of every kernel wrapper, in the order each phase
    takes them (``slice10_train`` among them), with TF32 off in PyTorch's
    products on the card (the plain versions and library calls are f32 or
    bf16 exactly).  ``src`` must be on the path."""
    from repro_torch.kernels import attention_paged as k7
    from repro_torch.kernels import attention_prefill_paged as k8
    from repro_torch.kernels import attention_quant as k9
    from repro_torch.kernels import expert_mlp as k2
    from repro_torch.kernels import expert_mlp_grouped as gk
    from repro_torch.kernels import expert_mlp_quant as k3
    from repro_torch.kernels import flash_attention as k6
    from repro_torch.kernels import moe_gating as k1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return (gk.launches, k7.launches, k8.launches, k9.launches, k1.launches, k2.launches,
            k3.launches, k6.launches)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    t_main = time.perf_counter()
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs.base import Segment
    from repro_torch.configs.registry import get_config, make_reduced
    from repro_torch.kernels import attention_paged as k7
    from repro_torch.kernels import attention_prefill_paged as k8
    from repro_torch.kernels import build
    from repro_torch.configs.base import QuantConfig
    from repro_torch.kernels import attention_quant as k9
    from repro_torch.kernels import expert_mlp as k2
    from repro_torch.kernels import expert_mlp_grouped as gk
    from repro_torch.kernels import expert_mlp_quant as k3
    from repro_torch.kernels import flash_attention as k6
    from repro_torch.kernels import moe_gating as k1
    from repro_torch.core.gating import expert_capacity
    from repro_torch.models.model import decode_step, init_caches, init_params, prefill
    from repro_torch.quant import quantize_params
    from repro_torch.quant.qarrays import QuantizedArray
    from repro_torch.serving.engine import Engine, EngineConfig, Request

    counters = kernel_setup()
    clock = PhaseClock(t_main)

    # 1. card
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    secs = build.build()
    log(f"build: {len(build.sources())} source(s) ready in {time.perf_counter() - t0:.2f} s "
        f"(compiled, started together: {', '.join(f'{k} {v:.2f} s' for k, v in secs.items()) or 'none'})")
    for src in build.sources():
        for line in build.build_log(src).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {src}: {line.strip()}")

    clock.mark("3")
    # 3. static serve at full width, depth cut to one (dense, MoE) repeat
    full = get_config(ARCH)
    cfg = full.replace(moe_impl="grouped", segments=(Segment(full.segments[0].pattern, 1),))
    red = make_reduced(full).replace(moe_impl="grouped")
    t0 = time.perf_counter()
    mem0 = torch.cuda.memory_allocated()
    params = init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    drawn = torch.cuda.memory_allocated() - mem0
    n_params = sum(b.numel() for b in params.buffers())
    log(f"init: {cfg.name} d_model {cfg.d_model}, {cfg.num_layers} layers, "
        f"{n_params / 1e9:.2f} G parameters ({torch.cuda.memory_allocated() / 1e9:.1f} GB) "
        f"drawn on the card in {time.perf_counter() - t0:.1f} s")
    eng = Engine(cfg, params, EngineConfig(max_batch=BATCH, max_prefill=PROMPT, max_decode=NEW),
                 device="cuda")
    rng = torch.Generator().manual_seed(SEED)
    reqs = [Request(torch.randint(0, cfg.vocab_size, (PROMPT,), generator=rng).tolist(), NEW)
            for _ in range(BATCH)]
    eng.generate(reqs)  # warm-up: cuBLAS handles, allocator pools
    torch.cuda.synchronize()
    reset(*counters)
    t0 = time.perf_counter()
    out = eng.generate(reqs)
    wall = time.perf_counter() - t0
    static_launches = read(counters, "serve")
    assert len(out) == BATCH and all(len(r.tokens) == NEW for r in out), [r.tokens for r in out]
    assert all(0 <= tok < cfg.vocab_size for r in out for tok in r.tokens)
    n_moe = sum(ls.ffn.kind == "moe" for ls in cfg.layer_specs())
    expected = {k: 0 for k in static_launches}
    expected["grouped_mlp"] = n_moe * (1 + NEW - 1)
    expected["flash_attention"] = cfg.num_layers  # the prefill's layers
    if static_launches != expected:
        raise AssertionError(f"static serve launches {static_launches}, expected {expected}")
    tm = eng.last_timings
    step_ms = statistics.median(tm["decode_step_s"]) * 1e3
    log(f"serve: {BATCH} requests x {NEW} tokens in {wall * 1e3:.3f} ms "
        f"({BATCH * NEW / wall:.1f} tok/s); prefill {tm['prefill_s'] * 1e3:.3f} ms "
        f"(batch {BATCH} x {PROMPT}); decode step median {step_ms:.3f} ms "
        f"({BATCH / step_ms * 1e3:.1f} tok/s) over {len(tm['decode_step_s'])} steps; "
        f"launches {static_launches}; peak memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    log(f"serve: tokens of request 0: {out[0].tokens}")
    p3 = {}
    for line in profile_decode(eng, cfg, params, into=p3):
        log(line)
    t_an = time.perf_counter()
    for line in static_analysis(eng, cfg, params, reqs, counters, p3, drawn):
        log(line)
    analysis_s = time.perf_counter() - t_an
    log(reference_check(red))

    clock.mark("4")
    # 4. continuous serve, same weights
    lines, cont_launches, snap, ceng = continuous_serve(cfg, params, counters)
    cont_preemptions = ceng.preemptions  # before the tick profile serves more
    for line in lines:
        log(line)
    p4 = {}
    for line in profile_ticks(ceng, cfg, into=p4):
        log(line)
    t_an = time.perf_counter()
    for line in tick_analysis(ceng, cfg, counters, p4):
        log(line)
    analysis_s += time.perf_counter() - t_an

    clock.mark("4b")
    # 4b. the prefix trace: prefix sharing and copy-on-write through the
    # chunked and the batched tick (bf16, and the batched tick over an int8
    # pool), then the same requests without sharing, whose first-token
    # logits the shared runs are held against
    prefix_runs = {}
    for key, mode, sharing, kv in (("chunked", "chunked", True, 0), ("batched", "batched", True, 0),
                                   ("batched_int8", "batched", True, 8),
                                   ("unshared", "chunked", False, 0)):
        lines, launches, firsts, peng = prefix_trace(cfg, params, counters, mode, sharing, kv)
        del peng
        for line in lines:
            log(line)
        prefix_runs[key] = (launches, firsts)
    for key in ("chunked", "batched"):
        log(compare_first_logits(f"prefix trace {key}", prefix_runs[key][1],
                                 prefix_runs["unshared"][1]))
    del firsts
    prefix_runs = {k: v[0] for k, v in prefix_runs.items()}

    clock.mark("4c")
    # 4c. the contiguous engine on the phase-4 trace, bf16 and an int8 cache
    contig = {}
    for kv in (0, 8):
        lines, contig[kv], snap9, e = contiguous_trace(cfg, params, counters, kv_cache_bits=kv)
        del e
        for line in lines:
            log(line)

    clock.mark("4d")
    # 4d. observability: the phase-4 trace under Obs off / default / full, in
    # turns, and the host syncs of a steady decode tick under each
    lines, obs_launches, obs_summary = obs_phase(cfg, params, counters, cont_launches,
                                                 cont_preemptions)
    for line in lines:
        log(line)

    clock.mark("5")
    # 5. full-width chunked prefill against the static prefill
    log(chunked_prefill_check(cfg, params))

    clock.mark("6")
    # 6. reduced f32 continuous serve, card vs CPU
    log(continuous_reference_check(red))
    clock.mark("6c")
    # 6c. the same for prefix sharing, the batched tick, the scatter oracle and
    # the contiguous engine, and the batched tick under the capacity dispatch
    for line in slice6_reference_checks(red, make_reduced(full)):
        log(line)
    clock.mark("6d")
    # 6d. speculative decoding at full width: phase 4's weights, pool and
    # trace, the target as its own drafter, over a bf16 and an int8 pool,
    # each beside the non-speculative run; then reduced f32 card vs CPU
    spec_runs = {}
    for kv in (0, 8):
        lines, sl, bl, summary = spec_trace(cfg, params, cfg, params, counters, CONT, CONT_PROMPTS,
                                            kv_cache_bits=kv,
                                            what="spec llama4" + (" int8 KV" if kv else ""))
        for line in lines:
            log(line)
        spec_runs["llama4" + ("_int8" if kv else "")] = (sl, bl, summary)
    for line in spec_reference_checks(red, make_reduced(full), make_reduced(get_config("glm4-9b"))):
        log(line)

    clock.mark("6b")
    # 6b. a long static prefill at full width, while only the bf16 tree is held
    lines, long_launches, long_check, long_grouped = long_prefill(cfg, params, counters)
    for line in lines:
        log(line)

    clock.mark("7")
    # 7. quantized serving: int8 experts (PTQ on the card, slice by slice) and
    # an int8 KV cache through both engines, then the reduced references
    t0 = time.perf_counter()
    qparams = quantize_params(params, QuantConfig(bits=8, policy="experts"))
    torch.cuda.synchronize()
    log(f"quantize: int8 experts of {cfg.name} in {time.perf_counter() - t0:.2f} s; "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated (bf16 tree kept for the phases above)")
    lines, qstatic_launches = quant_static_serve(cfg, params, qparams, reqs, counters,
                                                 [r.tokens for r in out])
    for line in lines:
        log(line)
    torch.cuda.reset_peak_memory_stats()
    lines, qcont_launches, qsnap, qceng = continuous_serve(cfg, qparams, counters, kv_cache_bits=8,
                                                           preemptions=cont_preemptions)
    del qceng
    for line in lines:
        log(line)
    for line in quant_reference_checks(red):
        log(line)

    clock.mark("8")
    # 8. kernels against their plain versions, then timed beside their bounds
    moe = {k: v[0] for k, v in params["segments"]["seg0"]["pos1"]["moe"].items() if torch.is_tensor(v)}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    # kernels 4 and 5 at the static prefill (T = 256) and decode (T = 4), then,
    # from a generator of their own (the other cases keep their inputs), the
    # continuous engine's 8 slots and, for 5, a 16384-token prefill (4 at that
    # size: the long prefill's own MoE inputs, phase 6b)
    gen8 = torch.Generator(device="cuda").manual_seed(SEED + 8)
    shapes = {}
    for label, T, g_ in (("prefill", BATCH * PROMPT, gen), ("decode", BATCH, gen),
                         ("continuous_decode", CONT["slots"], gen8)):
        kargs, info = grouped_case(moe, T, 1, g_, torch.bfloat16)
        info.update(check_grouped(kargs, BF16_TOL, "mma", timed=True))
        shapes[label] = info
        log(f"kernel grouped_mlp bf16 {label}: {json.dumps(info)}")
    shapes["long_prefill"] = long_grouped
    # the verify pass's MoE input (phase 6d): T = slots x (SPEC_K + 1), from a
    # generator of its own
    T = CONT["slots"] * (SPEC_K + 1)
    kargs, info = grouped_case(moe, T, 1, torch.Generator(device="cuda").manual_seed(SEED + 18),
                               torch.bfloat16)
    info.update(check_grouped(kargs, BF16_TOL, "mma", timed=True))
    shapes["spec_verify"] = info
    log(f"kernel grouped_mlp bf16 spec_verify (T = {T}): {json.dumps(info)}")
    # tile -> expert maps with more runs than the grid has rows, from a
    # generator of their own
    cgen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    cycled = cycled_checks(moe, cgen, quant=False)
    shapes.update(cycled)
    log(f"kernel grouped_mlp bf16, te cycling over 3 experts: {json.dumps(cycled)}")
    rp = init_params(red, seed=SEED, device="cuda")
    rmoe = {k: v[0] for k, v in rp["segments"]["seg0"]["pos1"]["moe"].items() if torch.is_tensor(v)}
    kargs, info = grouped_case(rmoe, 64, 1, gen, torch.float32)
    info.update(check_grouped(kargs, F32_TOL, "fma"))
    shapes["f32_reduced"] = info
    log(f"kernel grouped_mlp f32 reduced: {json.dumps(info)}")

    G = cfg.num_heads // cfg.num_kv_heads
    scale = 1.0 / math.sqrt(cfg.head_dim)
    attn = {"paged_decode_attention": {}, "paged_prefill_attention": {}}
    pool, tbl, qpos = snap
    for dt, tol, label in ((torch.bfloat16, BF16_TOL, "bf16"), (torch.float32, F32_TOL, "f32")):
        args, info = decode_case(pool, tbl, qpos, G, dt, gen)
        info.update(check_paged("paged_decode_attention", k7.paged_decode_attention,
                                k7.paged_decode_attention_plain, args, dict(scale=scale), tol,
                                timed=dt == torch.bfloat16, library=sdpa_decode))
        attn["paged_decode_attention"][f"{label}_served"] = info
        log(f"kernel paged_decode_attention {label} served (table of the continuous serve mid-run): "
            f"{json.dumps(info)}")
        for hist in (0, 1008):
            args, info = prefill_case(hist, CONT["prefill_chunk"], cfg.num_kv_heads, G, cfg.head_dim,
                                      CONT["page_size"], CONT["n_pages"] + 1,
                                      CONT["capacity"] // CONT["page_size"], dt, gen)
            info.update(check_paged("paged_prefill_attention", k8.paged_prefill_attention,
                                    k8.paged_prefill_attention_plain, args, dict(scale=scale), tol,
                                    timed=dt == torch.bfloat16, library=sdpa_prefill))
            attn["paged_prefill_attention"][f"{label}_history{hist}"] = info
            log(f"kernel paged_prefill_attention {label} history {hist}: {json.dumps(info)}")
    dec, pre = redesign_checks(cfg, k7, k8, gen)
    attn["paged_decode_attention"].update(dec)
    attn["paged_prefill_attention"].update(pre)
    battn = {"paged_prefill_attention_batched": batched_kernel_checks(cfg, red, k8)}
    battn["paged_prefill_attention_batched"].update(verify_kernel_checks(cfg, red, k8))
    # reduced size with a window and a softcap (llama4 uses neither)
    kw = dict(scale=1.0 / math.sqrt(red.head_dim), window=37, softcap=20.0)
    rG = red.num_heads // red.num_kv_heads
    for dt, tol, label in ((torch.bfloat16, BF16_TOL, "bf16"), (torch.float32, F32_TOL, "f32")):
        args, _ = prefill_case(50, 40, red.num_kv_heads, rG, red.head_dim, 8, 30, 16, dt, gen)
        q, k, v, kpos, table, qpos_c, _, _ = args
        attn["paged_prefill_attention"][f"{label}_window_softcap"] = check_paged(
            "paged_prefill_attention", k8.paged_prefill_attention, k8.paged_prefill_attention_plain,
            args, kw, tol)
        rows = torch.stack([table, torch.full_like(table, 29), table.roll(3)])  # one all-trash row
        dargs = (q[:3].contiguous(), k, v, kpos, rows.contiguous(), qpos_c[[10, 0, 39]].contiguous())
        attn["paged_decode_attention"][f"{label}_window_softcap"] = check_paged(
            "paged_decode_attention", k7.paged_decode_attention, k7.paged_decode_attention_plain,
            dargs, kw, tol)
    log(f"kernel paged attention reduced with window 37, softcap 20: " + json.dumps(
        {n: {s: v for s, v in d.items() if "window" in s} for n, d in attn.items()}))

    # the quantized kernels: 5 (int8 from the served tree, int4 of the same
    # layer, freed after), 7q and 8q, 9
    qshapes = {}
    qmoe = {k: (v.take(0) if isinstance(v, QuantizedArray) else v[0])
            for k, v in qparams["segments"]["seg0"]["pos1"]["moe"].items()
            if k in ("wi", "wg", "wo", "router")}
    m4 = int4_experts(moe)
    for bits, experts in ((8, qmoe), (4, m4)):
        for label, T, g_ in (("prefill", BATCH * PROMPT, gen), ("decode", BATCH, gen),
                             ("continuous_decode", CONT["slots"], gen8),
                             (f"prefill_{LONG_PROMPT}", LONG_PROMPT, gen8)):
            kargs, info = grouped_case(experts, T, 1, g_, torch.bfloat16)
            info.update(check_grouped(kargs, BF16_TOL, "mma", quant=True, timed=True,
                                      n=3 if T >= LONG_PROMPT else 20))
            qshapes[f"int{bits}_{label}"] = info
            log(f"kernel grouped_mlp_quant int{bits} bf16 {label}: {json.dumps(info)}")
            del kargs
    del m4, experts
    cycled = cycled_checks(qmoe, cgen, quant=True)
    qshapes.update({f"int8_{k}": v for k, v in cycled.items()})
    log(f"kernel grouped_mlp_quant int8 bf16, te cycling over 3 experts: {json.dumps(cycled)}")
    torch.cuda.empty_cache()
    for fmt, info in kimi_width_checks(gen8).items():
        if fmt == "bf16":
            shapes["kimi_width"] = info
        else:
            qshapes[f"{fmt}_kimi_width"] = info
        log(f"kernel grouped_mlp{'' if fmt == 'bf16' else '_quant'} {fmt} at kimi-k2-1t-a32b's "
            f"expert width, 32 random experts, T = 64: {json.dumps(info)}")
    torch.cuda.empty_cache()
    for bits in (8, 4):
        rq = {n: QuantizedArray.quantize(rmoe[n], bits=bits) for n in ("wi", "wg", "wo")}
        kargs, info = grouped_case({**rq, "router": rmoe["router"]}, 64, 1, gen, torch.float32)
        info.update(check_grouped(kargs, F32_TOL, "fma", quant=True))
        qshapes[f"int{bits}_f32_reduced"] = info
        log(f"kernel grouped_mlp_quant int{bits} f32 reduced: {json.dumps(info)}")
    for label, info in reduced_bf16_checks(rmoe).items():
        (shapes if label == "bf16_reduced" else qshapes)[label] = info
        log(f"kernel grouped_mlp{'' if label == 'bf16_reduced' else '_quant'} {label} (CUDA-core "
            f"kernel): {json.dumps(info)}")

    qattn = {"paged_decode_attention_int8": {}, "paged_prefill_attention_int8": {},
             "decode_attention_quant": {}}
    pool, tbl, qpos = qsnap
    # kernel 9 at the served shape: layer 0's int8 cache after the 4 prompts
    # and one decode step (65 of 80 slots filled, the query at 64)
    caches = init_caches(cfg, BATCH, PROMPT + NEW, kv_bits=8, device="cuda")
    ptoks = torch.tensor([r.prompt for r in reqs], device="cuda")
    logits, caches = prefill(cfg, qparams, ptoks, caches)
    _, caches = decode_step(cfg, qparams, logits.argmax(-1)[:, None], PROMPT, caches)
    c0 = caches["seg0"]["pos0"]["self"]
    served_kv = [(c0[n].q[0], c0[n].scale[0]) for n in ("k", "v")]
    for dt, tol, label in ((torch.bfloat16, BF16_TOL, "bf16"), (torch.float32, F32_TOL, "f32")):
        timed = dt == torch.bfloat16
        args, info = decode_case(pool, tbl, qpos, G, dt, gen)
        kw = dict(scale=scale, **info.pop("kw"))
        info.update(check_paged("paged_decode_attention_int8", k7.paged_decode_attention,
                                k7.paged_decode_attention_plain, args, kw, tol, timed=timed,
                                library=sdpa_decode))
        qattn["paged_decode_attention_int8"][f"{label}_served"] = info
        log(f"kernel paged_decode_attention_int8 {label} served (int8 pool of the quantized "
            f"continuous serve mid-run): {json.dumps(info)}")
        for hist in (0, 1008):
            args, info = prefill_case(hist, CONT["prefill_chunk"], cfg.num_kv_heads, G, cfg.head_dim,
                                      CONT["page_size"], CONT["n_pages"] + 1,
                                      CONT["capacity"] // CONT["page_size"], dt, gen, kv_int8=True)
            kw = dict(scale=scale, **info.pop("kw"))
            info.update(check_paged("paged_prefill_attention_int8", k8.paged_prefill_attention,
                                    k8.paged_prefill_attention_plain, args, kw, tol, timed=timed,
                                    library=sdpa_prefill))
            qattn["paged_prefill_attention_int8"][f"{label}_history{hist}"] = info
            log(f"kernel paged_prefill_attention_int8 {label} history {hist}: {json.dumps(info)}")
        for case, (B, T, filled, kv) in (("served", (BATCH, PROMPT + NEW, PROMPT + 1, served_kv)),
                                         ("2048", (8, 2048, 1024, None))):
            kpos = c0["pos"][0] if kv is not None else None
            args, info = decode_quant_case(B, T, filled, cfg.num_kv_heads, G, cfg.head_dim, dt, gen,
                                           kpos=kpos, kv=kv)
            info.update(check_paged("decode_attention_quant", k9.decode_attention_quant,
                                    k9.decode_attention_quant_plain, args, dict(scale=scale), tol,
                                    timed=timed, library=sdpa_contiguous))
            qattn["decode_attention_quant"][f"{label}_{case}"] = info
            log(f"kernel decode_attention_quant {label} {case}: {json.dumps(info)}")
    del caches, served_kv, c0
    qattn["decode_attention_quant"].update(decode_quant_redesign_checks(cfg, G, k9))
    # kernel 9 at the contiguous engine's served shape: 8 rows x 2048 slots of
    # layer 0's int8 cache mid-run, rows at their own positions, idle ones at 0
    (kv9, kpos9c, qpos9c) = snap9
    args, info = decode_quant_case(CONT["slots"], CONT["capacity"], 0, cfg.num_kv_heads, G,
                                   cfg.head_dim, torch.bfloat16,
                                   torch.Generator(device="cuda").manual_seed(SEED + 14),
                                   kpos=kpos9c, qpos=qpos9c, kv=kv9)
    info.update(check_paged("decode_attention_quant", k9.decode_attention_quant,
                            k9.decode_attention_quant_plain, args, dict(scale=scale), BF16_TOL,
                            timed=True, library=sdpa_contiguous))
    info["row_positions"] = qpos9c.tolist()
    qattn["decode_attention_quant"]["bf16_contiguous_served"] = info
    log(f"kernel decode_attention_quant bf16 contiguous served (layer 0's cache of the int8 "
        f"contiguous serve mid-run): {json.dumps(info)}")
    del kv9, kpos9c, qpos9c, snap9
    # the same shape with exactly one inactive row (at position 0, one key
    # written, as an idle slot's decode leaves it) beside 7 rows filled as
    # the trace's first 7 requests at their last decode step
    lens = [n + CONT_NEW - 1 for n in CONT_PROMPTS[:CONT["slots"] - 1]] + [0]
    kpos9r = torch.full((CONT["slots"], CONT["capacity"]), -1, dtype=torch.int32, device="cuda")
    for b, n in enumerate(lens):
        kpos9r[b, : n + 1] = torch.arange(n + 1, dtype=torch.int32, device="cuda")
    args, info = decode_quant_case(CONT["slots"], CONT["capacity"], 0, cfg.num_kv_heads, G,
                                   cfg.head_dim, torch.bfloat16,
                                   torch.Generator(device="cuda").manual_seed(SEED + 15),
                                   kpos=kpos9r, qpos=torch.tensor(lens, dtype=torch.int32,
                                                                  device="cuda"))
    info.update(check_paged("decode_attention_quant", k9.decode_attention_quant,
                            k9.decode_attention_quant_plain, args, dict(scale=scale), BF16_TOL,
                            timed=True, library=sdpa_contiguous))
    info["row_positions"] = lens
    qattn["decode_attention_quant"]["bf16_contiguous_one_inactive"] = info
    log(f"kernel decode_attention_quant bf16 contiguous 8 x 2048, ragged positions, one row "
        f"inactive: {json.dumps(info)}")
    del kpos9r
    qbattn = {"paged_prefill_attention_batched_int8": batched_kernel_checks(cfg, red, k8, True)}
    qbattn["paged_prefill_attention_batched_int8"].update(verify_kernel_checks(cfg, red, k8, True))
    dec, pre = redesign_checks(cfg, k7, k8, gen, kv_int8=True)
    qattn["paged_decode_attention_int8"].update(dec)
    qattn["paged_prefill_attention_int8"].update(pre)
    # reduced size with a window and a softcap, one row with no valid key
    kw = dict(scale=1.0 / math.sqrt(red.head_dim), window=37, softcap=20.0)
    for dt, tol, label in ((torch.bfloat16, BF16_TOL, "bf16"), (torch.float32, F32_TOL, "f32")):
        args, info = prefill_case(50, 40, red.num_kv_heads, rG, red.head_dim, 8, 30, 16, dt, gen,
                                  kv_int8=True)
        qkw = {**kw, **info["kw"]}
        q, k, v, kpos, table, qpos_c, _, _ = args
        qattn["paged_prefill_attention_int8"][f"{label}_window_softcap"] = check_paged(
            "paged_prefill_attention_int8", k8.paged_prefill_attention,
            k8.paged_prefill_attention_plain, args, qkw, tol)
        rows = torch.stack([table, torch.full_like(table, 29), table.roll(3)])  # row 1: all trash
        dargs = (q[:3].contiguous(), k, v, kpos, rows.contiguous(), qpos_c[[10, 0, 39]].contiguous())
        qattn["paged_decode_attention_int8"][f"{label}_window_softcap"] = check_paged(
            "paged_decode_attention_int8", k7.paged_decode_attention,
            k7.paged_decode_attention_plain, dargs, qkw, tol)
        kpos9 = torch.full((3, 64), -1, dtype=torch.int32, device="cuda")
        kpos9[[0, 2], :50] = torch.arange(50, dtype=torch.int32, device="cuda")
        args9, _ = decode_quant_case(3, 64, 50, red.num_kv_heads, rG, red.head_dim, dt, gen, kpos=kpos9,
                                     qpos=torch.tensor([49, 10, 30], dtype=torch.int32, device="cuda"))
        qattn["decode_attention_quant"][f"{label}_window_softcap"] = check_paged(
            "decode_attention_quant", k9.decode_attention_quant, k9.decode_attention_quant_plain,
            args9, kw, tol)
        zero7 = k7.paged_decode_attention(*dargs, **qkw)[1]
        zero9 = k9.decode_attention_quant(*args9, **kw)[1]
        if zero7.abs().max().item() != 0 or zero9.abs().max().item() != 0:
            raise AssertionError("a row with no valid key must give 0 (kernels 7q and 9)")
    log("kernel quantized attention reduced with window 37, softcap 20 (a row with no valid key "
        "gives 0 in 7q and 9): " + json.dumps(
            {n: {s: v for s, v in d.items() if "window" in s} for n, d in qattn.items()}))

    clock.mark("9")
    # 9. capacity dispatch: llama4-maverick with its own moe_impl ("ep", which
    # without a mesh is the dense mapping table), the same bf16 weights and
    # int8 experts; kernels 1, 2 and 3 in place of 4 and 5
    cap_cfg = full.replace(segments=cfg.segments)
    lines, cap_static, cap_tokens, cap_eng = capacity_static_serve(cap_cfg, params, reqs, counters)
    for line in lines:
        log(line)
    for line in profile_decode(cap_eng, cap_cfg, params, what="capacity decode"):
        log(line)
    del cap_eng
    log(dense_vs_grouped_check(cap_cfg, moe, gen))
    lines, cap_cont, _, cap_ceng = continuous_serve(cap_cfg, params, counters,
                                                    preemptions=cont_preemptions,
                                                    what="capacity continuous serve")
    del cap_ceng
    for line in lines:
        log(line)
    lines, cap_qstatic = quant_static_serve(cap_cfg, params, qparams, reqs, counters, cap_tokens,
                                            what="capacity quantized serve", profile=False)
    for line in lines:
        log(line)
    for line in capacity_reference_checks(make_reduced(full)):
        log(line)

    clock.mark("10")
    # 10. kernels 1, 2 and 3 against their plain versions at the served
    # shapes, then timed beside their bounds
    E1 = moe["router"].shape[1]
    gshapes = {}
    for label, T in (("decode", BATCH), ("prefill", BATCH * PROMPT),
                     ("continuous_decode", CONT["slots"])):
        x = torch.randn((T, cfg.d_model), generator=gen, device="cuda").bfloat16()
        args, info = gating_case(x.float() @ moe["router"], 1, expert_capacity(T, E1, 1, 1.25))
        info.update(check_gating(args, timed=True))
        gshapes[f"served_{label}"] = info
        log(f"kernel moe_gating served router {label}: {json.dumps(info)}")
    args, info = gating_case(torch.randn((256, 384), generator=gen, device="cuda"), 8,
                             expert_capacity(256, 384, 8, 1.25))
    info.update(check_gating(args, timed=True))
    gshapes["kimi_width"] = info
    log(f"kernel moe_gating f32 logits T 256, E 384, K 8 (kimi-k2's width): {json.dumps(info)}")
    ties = (torch.randn((256, E1), generator=gen, device="cuda") * 2).round() / 2
    ties[::4] = 0.5  # a quarter of the rows: all logits equal
    args, info = gating_case(ties, 2, expert_capacity(256, E1, 2, 1.25))
    info.update(check_gating(args))
    gshapes["ties"] = info
    skew = torch.randn((256, E1), generator=gen, device="cuda")
    skew[:, 0] += 4.0  # most tokens to expert 0: past its capacity
    args, info = gating_case(skew, 1, expert_capacity(256, E1, 1, 1.25))
    info.update(check_gating(args))
    if info["dropped"] == 0:
        raise AssertionError("the drop case of kernel 1 dropped nothing")
    gshapes["drops"] = info
    # past the one-launch slot bound: the 13926-token prefill's gating (two
    # launches, the rank scan over 14 chunks)
    args, info = gating_case(torch.randn((13926, E1), generator=gen, device="cuda"), 1,
                             expert_capacity(13926, E1, 1, 1.25))
    info.update(check_gating(args, timed=True))
    gshapes["past_one_launch_13926"] = info
    log(f"kernel moe_gating ties (rows of equal logits, K 2), drops (logits biased to expert 0) "
        f"and 13926 tokens (past the one-launch bound of {k1.ONE_LAUNCH_SLOTS} slots): "
        + json.dumps({k: gshapes[k] for k in ("ties", "drops", "past_one_launch_13926")}))
    cgen2 = torch.Generator(device="cuda").manual_seed(SEED + 12)
    gshapes["concurrent"] = concurrent_gating_check(E1, cgen2)
    log(f"kernel moe_gating one launch on two streams and two graphs at once: "
        f"{json.dumps(gshapes['concurrent'])}")
    cshapes = {}
    for label, T in (("prefill", BATCH * PROMPT), ("decode", BATCH),
                     ("continuous_decode", CONT["slots"])):
        kargs, info = capacity_expert_case(moe, T, 1, gen, torch.bfloat16, 1.25)
        info.update(check_capacity_experts(kargs, BF16_TOL, timed=True))
        cshapes[label] = info
        log(f"kernel expert_mlp bf16 {label}: {json.dumps(info)}")
    kargs, info = capacity_expert_case(rmoe, 64, 1, gen, torch.float32, 2.0)
    info.update(check_capacity_experts(kargs, F32_TOL))
    cshapes["f32_reduced"] = info
    log(f"kernel expert_mlp f32 reduced: {json.dumps(info)}")
    cqshapes = {}
    for label, T in (("prefill", BATCH * PROMPT), ("decode", BATCH),
                     ("continuous_decode", CONT["slots"])):
        kargs, info = capacity_expert_case(qmoe, T, 1, gen, torch.bfloat16, 1.25)
        info.update(check_capacity_experts(kargs, BF16_TOL, quant=True, variant="mma", timed=True))
        cqshapes[f"int8_{label}"] = info
        log(f"kernel expert_mlp_quant int8 bf16 {label}: {json.dumps(info)}")
    # a long prefill: C = 136 is past the TPU kernel's 128-row block and not
    # a multiple of it, which JAX's rule refuses; the card's kernel takes it
    kargs, info = capacity_expert_case(qmoe, 13926, 1, gen, torch.bfloat16, 1.25)
    if info["C"] != 136 or not k3.check_kernel_compat(*kargs[:4]):
        raise AssertionError(f"expert_mlp_quant: C={info['C']} is not taken by the kernel")
    info.update(check_capacity_experts(kargs, BF16_TOL, quant=True, variant="mma", timed=True, n=3))
    cqshapes["int8_prefill_c136"] = info
    log(f"kernel expert_mlp_quant int8 bf16 prefill of 13926 tokens (C 136): {json.dumps(info)}")
    rq = {n: QuantizedArray.quantize(rmoe[n], bits=8) for n in ("wi", "wg", "wo")}
    kargs, info = capacity_expert_case({**rq, "router": rmoe["router"]}, 64, 1, gen, torch.float32, 2.0)
    info.update(check_capacity_experts(kargs, F32_TOL, quant=True, variant="fma"))
    cqshapes["int8_f32_reduced"] = info
    log(f"kernel expert_mlp_quant int8 f32 reduced: {json.dumps(info)}")
    cqshapes["int8_bf16_reduced"] = info = reduced_capacity_bf16_check(rmoe)
    log(f"kernel expert_mlp_quant int8 bf16 reduced (CUDA-core kernel): {json.dumps(info)}")
    del kargs, args

    clock.mark("11")
    # 11. the paper's own model at its published size, once the llama4 trees
    # are gone
    del (params, qparams, eng, ceng, out, moe, qmoe, rp, rmoe, rq, snap, qsnap, pool, tbl, qpos,
         dargs, args9, ties, skew)

    gc.collect()
    torch.cuda.empty_cache()
    log(f"llama4 trees deleted: {torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated")
    lines, nlg_launches, nlg_grouped_launches, nlg_routing_launches = nlg_serve(counters)
    for line in lines:
        log(line)
    clock.mark("11b")
    # 11b. the paper's pairing, speculative, at published sizes
    gc.collect()
    torch.cuda.empty_cache()
    lines, sl, bl, summary = nlg_spec_serve(counters)
    for line in lines:
        log(line)
    spec_runs["nlg"] = (sl, bl, summary)

    clock.mark("12")
    # 12. glm4-9b at its published size, once nlg's tree is gone
    gc.collect()
    torch.cuda.empty_cache()
    lines, glm4_launches = glm4_serve(counters)
    for line in lines:
        log(line)
    gc.collect()
    torch.cuda.empty_cache()
    log(reference_check(make_reduced(get_config("glm4-9b"))))

    clock.mark("13")
    # 13. kernel 6 against its plain version at the served shapes, reduced
    # f32 with every mask, and the TPU kernel's index form at S != T
    fshapes = {"long_prefill": long_check, **flash_checks(full, red, gen)}

    clock.mark("14")
    # 14. slice 8: gemma3-27b, recurrentgemma-2b and mamba2-370m served at
    # their published widths, their reduced f32 references, and kernels 6
    # (windowed, and at dh 256) and 9 (over wrapped int8 rings)
    gc.collect()
    torch.cuda.empty_cache()
    s8_paths, (s8_win, s8_d256, s8_ring), s9_spec = slice8_serve(counters, gen)
    spec_runs.update(s9_spec)

    clock.mark("15")
    # 15. slice 9: seamless-m4t-medium (encoder, cross attention) and
    # internvl2-1b (prefix embeddings) at their published sizes, and kernel
    # 6 non-causal and at G = 7
    gc.collect()
    torch.cuda.empty_cache()
    s9_paths, s9_calls = slice9_serve(counters)
    s9_nc, s9_g7 = slice9_kernel_checks(gen)

    clock.mark("17")
    # 17. slice 10, once slice 9's trees are freed: kernels 6b and 1b against
    # their plain versions, the paper's PR-MoE trained at its published size,
    # the MoS student distilled from it, checkpointed and served; reduced f32
    # card vs CPU; the guard of a kernel without a backward
    gc.collect()
    torch.cuda.empty_cache()
    s10_fb, s10_gb, s14_cb, s14_ob = slice10_kernel_checks(gen)
    s10_paths, s10_summary = slice10_train(counters)
    for line in slice10_reference_checks():
        log(line)
    log(slice10_guard())
    # 17g-h. slice 14: llama4-maverick trained at its published widths
    # under the capacity table and grouped (kernels 2b / 4b), and reduced
    # llama4 and kimi-k2 card vs CPU
    s14_paths, s14_summary = slice14_train(counters)
    for line in slice14_reference_checks():
        log(line)
    clock.mark("18")
    # 18. slice 15: expert-parallel serving on 4 ranks (scripts/ep_phase.py)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"ep: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated before the ranks start")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "scripts"))
    import ep_phase

    ep_lines, ep_summary, ep_paths = ep_phase.ep_phase(counters)
    for line in ep_lines:
        log(line)
    clock.mark("19")
    # 19. slice 16: expert-parallel training on 2 and 4 ranks (scripts/ep_train_phase.py)
    gc.collect()
    torch.cuda.empty_cache()
    import ep_train_phase

    _, et_summary, et_paths = ep_train_phase.ep_train_phase(counters)  # logs as it goes
    clock.mark("20")
    # 20. slice 17: the dry-run table over every assigned arch x shape, on meta
    for line in dryrun_table():
        log(line)
    clock.mark("the kernels line")

    dec = shapes["decode"]
    library_call = ("F.scaled_dot_product_attention(enable_gqa=True) with the same boolean mask "
                    "over K/V gathered into a contiguous tensor beforehand (the gather timed on "
                    "its own: library_gather_ms); no single PyTorch call computes a paged "
                    "attention; ms and library_ms are device times from CUDA graphs, "
                    "events_ms and library_events_ms of calls issued back to back")

    qlibrary_call = ("F.scaled_dot_product_attention(enable_gqa=True) with the same boolean mask "
                     "over K/V gathered and dequantized into a contiguous tensor beforehand (that "
                     "preparation timed on its own: library_gather_ms); no single PyTorch call "
                     "computes attention over an int8 cache; ms and library_ms are device times "
                     "from CUDA graphs, events_ms and library_events_ms of calls issued back "
                     "to back")

    def grouped_variants(name):
        """Per served run that launched ``name``: its launches by variant."""
        kinds = ("mma", "fma", "one_launch", "two_launches")
        by_path = {path: {k[len(name) + 1:]: n for k, n in v.items() if k[len(name) + 1:] in kinds
                          and k.startswith(name + "_")} for path, v in VARIANTS_SEEN.items()}
        return {path: v for path, v in by_path.items() if sum(v.values())}

    def attn_entry(name, source, replaces, main, checks=attn, launches=cont_launches,
                   call=library_call):
        m = checks[name][main]
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(s["max_abs_err"] for s in checks[name].values()),
            "max_rel_err": max(s["max_rel_err"] for s in checks[name].values()),
            "max_row_rel_err": max(s["max_row_rel_err"] for s in checks[name].values()),
            "ms": m["ms"], "events_ms": m["events_ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            "library_events_ms": m["library_events_ms"],
            "library_gather_ms": m["library_gather_ms"], "library_call": call,
            "shapes": checks[name],
        }

    kernels = [
        {
            "name": "grouped_mlp",
            "route": "cuda",
            "source": "src/repro_torch/csrc/grouped_mlp_mma.cu",
            "source_f32": "src/repro_torch/csrc/grouped_mlp.cu",
            "replaces": "src/repro/kernels/expert_mlp_grouped.py:88",
            "launches": static_launches["grouped_mlp"],
            "launches_by_path": {"static": static_launches["grouped_mlp"],
                                 "continuous": cont_launches["grouped_mlp"],
                                 "long_prefill": long_launches["grouped_mlp"]},
            "variant_launches_by_path": grouped_variants("grouped_mlp"),
            "max_abs_err": max(v["max_abs_err"] for v in shapes.values()),
            "max_rel_err": max(v["max_rel_err"] for v in shapes.values()),
            "max_row_rel_err": max(v["max_row_rel_err"] for v in shapes.values()),
            "ms": dec["ms"],
            "events_ms": dec["events_ms"],
            "host_ms": dec["host_ms"],
            "plain_ms": dec["plain_ms"],
            "bound_ms": dec["bound_ms"],
            "bound_by": dec["bound_by"],
            "library_ms": None,  # no single PyTorch call computes a grouped SwiGLU MLP
            "shapes": shapes,
        },
        attn_entry("paged_decode_attention", "src/repro_torch/csrc/paged_decode_attention.cu",
                   "src/repro/kernels/attention_paged.py:174", "bf16_served"),
        attn_entry("paged_prefill_attention", "src/repro_torch/csrc/paged_prefill_attention.cu",
                   "src/repro/kernels/attention_prefill_paged.py:207", "bf16_history1008"),
        {
            "name": "grouped_mlp_quant",
            "route": "cuda",
            "source": "src/repro_torch/csrc/grouped_mlp_mma.cu",
            "source_f32": "src/repro_torch/csrc/grouped_mlp.cu",
            "replaces": "src/repro/kernels/expert_mlp_grouped.py:179",
            "launches": qstatic_launches["grouped_mlp_quant"],
            "launches_by_path": {"static": qstatic_launches["grouped_mlp_quant"],
                                 "continuous": qcont_launches["grouped_mlp_quant"]},
            "variant_launches_by_path": grouped_variants("grouped_mlp_quant"),
            "max_abs_err": max(v["max_abs_err"] for v in qshapes.values()),
            "max_rel_err": max(v["max_rel_err"] for v in qshapes.values()),
            "max_row_rel_err": max(v["max_row_rel_err"] for v in qshapes.values()),
            "ms": qshapes["int8_decode"]["ms"],
            "events_ms": qshapes["int8_decode"]["events_ms"],
            "host_ms": qshapes["int8_decode"]["host_ms"],
            "plain_ms": qshapes["int8_decode"]["plain_ms"],
            "bound_ms": qshapes["int8_decode"]["bound_ms"],
            "bound_by": qshapes["int8_decode"]["bound_by"],
            "library_ms": None,  # no single PyTorch call computes a quantized grouped SwiGLU MLP
            "shapes": qshapes,
        },
        attn_entry("paged_decode_attention_int8", "src/repro_torch/csrc/paged_decode_attention.cu",
                   "src/repro/kernels/attention_paged.py:174", "bf16_served", qattn, qcont_launches, qlibrary_call),
        attn_entry("paged_prefill_attention_int8", "src/repro_torch/csrc/paged_prefill_attention.cu",
                   "src/repro/kernels/attention_prefill_paged.py:207", "bf16_history1008", qattn,
                   qcont_launches, qlibrary_call),
        attn_entry("decode_attention_quant", "src/repro_torch/csrc/decode_attention_quant.cu",
                   "src/repro/kernels/attention_quant.py:120", "bf16_served", qattn,
                   qstatic_launches, qlibrary_call),
        attn_entry("paged_prefill_attention_batched", "src/repro_torch/csrc/paged_prefill_attention.cu",
                   "src/repro/kernels/attention_prefill_paged.py:207", "bf16_served", battn,
                   prefix_runs["batched"]),
        attn_entry("paged_prefill_attention_batched_int8",
                   "src/repro_torch/csrc/paged_prefill_attention.cu",
                   "src/repro/kernels/attention_prefill_paged.py:207", "bf16_served", qbattn,
                   prefix_runs["batched_int8"], qlibrary_call),
    ]
    by_name = {k["name"]: k for k in kernels}
    for kname in ("paged_prefill_attention_batched", "paged_prefill_attention_batched_int8"):
        checks = (battn if "int8" not in kname else qbattn)[kname]
        by_name[kname]["single_row_launches_ms"] = checks["bf16_served"]["single_row_launches_ms"]
        # the verify pass's shape: C = SPEC_K + 1 queries a row
        by_name[kname]["verify_c5"] = {k: checks["bf16_verify_c5"][k] for k in (
            "ms", "events_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_gather_ms", "single_row_launches_ms")}
    by_name["paged_prefill_attention"]["launches_by_path"] = {
        "continuous": cont_launches["paged_prefill_attention"],
        "prefix_chunked": prefix_runs["chunked"]["paged_prefill_attention"],
        "prefix_unshared": prefix_runs["unshared"]["paged_prefill_attention"]}
    by_name["paged_decode_attention"]["launches_by_path"] = {
        "continuous": cont_launches["paged_decode_attention"],
        **{f"prefix_{k}": v["paged_decode_attention"] for k, v in prefix_runs.items()}}
    by_name["decode_attention_quant"]["launches_by_path"] = {
        "quantized_static": qstatic_launches["decode_attention_quant"],
        "contiguous_int8": contig[8]["decode_attention_quant"]}
    paths = (("static", cap_static), ("continuous", cap_cont), ("quantized_static", cap_qstatic))
    for kname, source, replaces, launches, checks, main, call in (
            ("moe_gating", "src/repro_torch/csrc/moe_gating.cu", "src/repro/kernels/moe_gating.py:92",
             cap_static, gshapes, "served_decode",
             "none: no single PyTorch call computes capacity gating"),
            ("expert_mlp", "src/repro_torch/csrc/grouped_mlp.cu", "src/repro/kernels/expert_mlp.py:56",
             cap_static, cshapes, "decode", "none: no single PyTorch call computes an expert SwiGLU MLP"),
            ("expert_mlp_quant", "src/repro_torch/csrc/grouped_mlp_mma.cu",
             "src/repro/kernels/expert_mlp_quant.py:66", cap_qstatic, cqshapes, "int8_decode",
             "none: no single PyTorch call computes an int8 expert SwiGLU MLP")):
        m = checks[main]
        by_path = {p: c[kname] for p, c in paths}
        entry = {"name": kname, "route": "cuda", "source": source, "replaces": replaces}
        if kname == "moe_gating":
            by_path["nlg_static"] = nlg_launches[kname]
            entry["variant_launches_by_path"] = grouped_variants("moe_gating")
        if kname == "expert_mlp_quant":
            entry["source_f32"] = "src/repro_torch/csrc/grouped_mlp.cu"
            entry["variant_launches_by_path"] = grouped_variants("expert_mlp_quant")
        kernels.append({
            **entry, "launches": launches[kname], "launches_by_path": by_path,
            "max_abs_err": max(v["max_abs_err"] for v in checks.values()),
            "max_rel_err": max(v["max_rel_err"] for v in checks.values()),
            "ms": m["ms"], "host_ms": m["host_ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"], "library_ms": None,
            "library_call": call, "shapes": checks,
        })
    m6 = fshapes["static_llama4"]
    kernels.append({
        "name": "flash_attention", "route": "cuda", "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:88",
        "launches": static_launches["flash_attention"],
        "launches_by_path": {"static": static_launches["flash_attention"],
                             "continuous": cont_launches["flash_attention"],
                             "long_prefill": long_launches["flash_attention"],
                             "quantized_static": qstatic_launches["flash_attention"],
                             "quantized_continuous": qcont_launches["flash_attention"],
                             "capacity_static": cap_static["flash_attention"],
                             "capacity_continuous": cap_cont["flash_attention"],
                             "capacity_quantized_static": cap_qstatic["flash_attention"],
                             "nlg_static": nlg_launches["flash_attention"],
                             "nlg_grouped_static": nlg_grouped_launches["flash_attention"],
                             **{f"slice9_{p}": c["flash_attention"] for p, c in s9_paths.items()},
                             "glm4_static": glm4_launches["flash_attention"],
                             "contiguous": contig[0]["flash_attention"],
                             "contiguous_int8": contig[8]["flash_attention"]},
        "max_abs_err": max(v["max_abs_err"] for v in fshapes.values()),
        "max_rel_err": max(v["max_rel_err"] for v in fshapes.values()),
        "max_row_rel_err": max(v["max_row_rel_err"] for v in fshapes.values()),
        "ms": m6["ms"], "host_ms": m6["host_ms"], "plain_ms": m6["plain_ms"],
        "bound_ms": m6["bound_ms"], "bound_by": m6["bound_by"], "library_ms": m6["library_ms"],
        "library_layout_ms": m6["library_layout_ms"],
        "library_call": "F.scaled_dot_product_attention(is_causal=True, enable_gqa=True) over "
                        "[B, heads, tokens, dh] copies of the model's layouts, fused backends only "
                        "(the copies timed on their own: library_layout_ms); ms and library_ms "
                        "are device times from CUDA graphs, host_ms a wrapper call's",
        "shapes": fshapes,
    })
    # every kernel's launches in the speculative runs and their baselines
    for path, (sl, bl, _) in spec_runs.items():
        for k in kernels:
            k.setdefault("launches_by_path", {})
            k["launches_by_path"][f"spec_{path}"] = sl[k["name"]]
            k["launches_by_path"][f"spec_{path}_baseline"] = bl[k["name"]]
    # slice 13: the obs phase's runs (each equal to phase 4's) and the nlg
    # engine under Obs(routing=True)
    for k in kernels:
        k["launches_by_path"]["obs_trace"] = obs_launches[k["name"]]
        k["launches_by_path"]["nlg_static_obs_routing"] = nlg_routing_launches[k["name"]]
    # slice 8: every kernel's launches in its runs, then the windowed kernel
    # 6, kernel 6 at dh 256 and kernel 9 over a ring, each with the runs
    # that launched it
    for k in kernels:
        if k["name"] in s8_paths["gemma3_static"]:
            k["launches_by_path"].update({f"slice8_{p}": c[k["name"]] for p, c in s8_paths.items()})
    window_call = ("F.scaled_dot_product_attention(attn_mask=the window-causal boolean mask, "
                   "enable_gqa=True) over [B, heads, tokens, dh] copies of the model's layouts "
                   "(the copies timed on their own: library_layout_ms), any backend that takes "
                   "the mask; ms and library_ms are device times from CUDA graphs")
    for kname, base, source, replaces, checks, main_shape, path, call in (
            ("flash_attention_window", "flash_attention", "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:88", s8_win, "gemma3_local_4x2048",
             "gemma3_static", window_call),
            ("flash_attention_dh256", "flash_attention", "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:88", s8_d256, "recurrentgemma_local_1x4096",
             "recurrentgemma_static", window_call),
            ("decode_attention_quant_ring", "decode_attention_quant",
             "src/repro_torch/csrc/decode_attention_quant.cu", "src/repro/kernels/attention_quant.py:120",
             s8_ring, "recurrentgemma_ring_8x2048", "recurrentgemma_static_int8",
             qlibrary_call.replace("the same boolean mask", "the same boolean mask (window "
                                   "included)"))):
        m = checks[main_shape]
        kernels.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": s8_paths[path][base],
            "launches_by_path": {p: c[base] for p, c in s8_paths.items() if c[base]},
            "max_abs_err": max(v["max_abs_err"] for v in checks.values()),
            "max_rel_err": max(v["max_rel_err"] for v in checks.values()),
            "max_row_rel_err": max(v["max_row_rel_err"] for v in checks.values()),
            "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"], "library_call": call,
            "deterministic": all(v.get("deterministic", True) for v in checks.values()),
            "shapes": checks,
        })
    # slice 9: kernel 6 without a causal mask (seamless's encoder and cross
    # attention) and at G = 7 (internvl2), each with its launches in the
    # slice-9 paths, from the recorded calls
    nc_calls = lambda p: sum(n for key, n in s9_calls[p].items() if key.startswith("non-causal"))
    g7_calls = lambda p: sum(n for key, n in s9_calls[p].items() if key.endswith("G7"))
    for kname, checks, main_shape, by_path, call in (
            ("flash_attention_noncausal", s9_nc, "bf16_encoder_4x1024",
             {p: nc_calls(p) for p in s9_calls if nc_calls(p)},
             "F.scaled_dot_product_attention(is_causal=False, enable_gqa=True) over [B, heads, "
             "tokens, dh] copies of the model's layouts, fused backends only (the copies timed on "
             "their own: library_layout_ms); ms and library_ms are device times from CUDA graphs"),
            ("flash_attention_g7", s9_g7, "bf16_internvl2_4x320",
             {p: g7_calls(p) for p in s9_calls if g7_calls(p)},
             "F.scaled_dot_product_attention(is_causal=True, enable_gqa=True), as for "
             "flash_attention")):
        m = checks[main_shape]
        kernels.append({
            "name": kname, "route": "cuda", "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:88",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(v["max_abs_err"] for v in checks.values()),
            "max_rel_err": max(v["max_rel_err"] for v in checks.values()),
            "max_row_rel_err": max(v["max_row_rel_err"] for v in checks.values()),
            "ms": m["ms"], "host_ms": m["host_ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            "library_layout_ms": m["library_layout_ms"], "library_call": call, "shapes": checks,
        })
    # slice 10: the backward kernels, and the training runs' launches of
    # kernels 6 and 1
    for k in kernels:
        if k["name"] in ("flash_attention", "moe_gating"):
            k["launches_by_path"].update({f"slice10_{p}": c[k["name"]] for p, c in s10_paths.items()})
        if k["name"] == "flash_attention":
            k["training_forward_with_lse"] = {
                key: {"fwd_ms": v["fwd_ms"], "fwd_lse_ms": v["fwd_lse_ms"]} for key, v in s10_fb.items()}
    for kname, source, replaces, checks, main_shape, call in (
            ("flash_attention_backward", "src/repro_torch/csrc/flash_attention_bwd.cu",
             "src/repro/kernels/flash_attention.py:88", s10_fb, "bf16_nlg_train_8x512",
             "the backward of F.scaled_dot_product_attention(is_causal=True, enable_gqa=True) over "
             "[B, heads, tokens, dh] copies (a boolean mask for the window; none takes a softcap): "
             "graph time of its forward and backward less its forward's"),
            ("moe_gating_backward", "src/repro_torch/csrc/moe_gating.cu",
             "src/repro/kernels/moe_gating.py:92", s10_gb, "T4096_E32_K1",
             "none: no single PyTorch call computes the capacity gating's backward")):
        m = checks[main_shape]
        kernels.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "note": "a backward kernel: the TPU kernel has none (JAX differentiates the jnp "
                    "function with XLA); launches from the training run",
            "launches": s10_paths["train"][kname],
            "launches_by_path": {p: c[kname] for p, c in s10_paths.items()},
            "max_abs_err": max(v["max_abs_err"] for v in checks.values()),
            "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"], "library_call": call,
            "deterministic": all(v.get("deterministic", True) for v in checks.values()),
            "shapes": checks,
        })
    # slice 14: the training runs' launches of kernels 1, 2, 4 and 6, and the
    # expert backward kernels
    for k in kernels:
        if k["name"] in ("flash_attention", "moe_gating", "expert_mlp", "grouped_mlp"):
            k["launches_by_path"].update({f"slice14_train_{p}": c[k["name"]]
                                          for p, c in s14_paths.items()})
    for kname, base, checks, main_shape in (
            ("expert_mlp_backward", "expert_mlp", s14_cb, "bf16_llama4_capacity"),
            ("grouped_mlp_backward", "grouped_mlp", s14_ob, "bf16_llama4_grouped")):
        m = checks[main_shape]
        kernels.append({
            "name": kname, "route": "cuda", "source": "src/repro_torch/csrc/grouped_mlp_bwd.cu",
            "replaces": "src/repro/kernels/expert_mlp.py:56" if base == "expert_mlp"
            else "src/repro/kernels/expert_mlp_grouped.py:88",
            "note": "a backward kernel: the TPU kernel has none (JAX differentiates the experts' "
                    "einsums with XLA); launches from the llama4 training runs",
            "launches": s14_paths["ep" if base == "expert_mlp" else "grouped"][kname],
            "launches_by_path": {f"slice14_train_{p}": c[kname] for p, c in s14_paths.items()},
            "max_abs_err": max(v["max_abs_err"] for v in checks.values()),
            "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": None,
            "library_call": "none: no single PyTorch call computes it",
            "composite_ms": m["composite_ms"],
            "composite_call": "not one call: eight torch.bmm (cuBLAS) and the SwiGLU's "
                              "elementwise backward in f32 over the buffer padded per expert to "
                              "[E, R, D]; graph time",
            "deterministic": all(v["deterministic"] for v in checks.values()),
            "shapes": checks,
        })
    # slice 15: every kernel's launches per rank on the EP paths, and each
    # rank's kernels 1, 2 and 4 at the EP shapes (slice 18: 7 and 9 at its rows)
    for k in kernels:
        if k["name"] in next(iter(ep_paths.values())):
            k["launches_by_path"].update({p: c[k["name"]] for p, c in ep_paths.items()})
        if k["name"] in ("moe_gating", "expert_mlp", "grouped_mlp"):
            k["ep_shapes"] = {f"{r}/{mesh}/{case}": v for r, by_mesh in ep_summary["checks"].items()
                              for mesh, cases in by_mesh.items() for case, v in cases.items()
                              if case.startswith(k["name"])}
        if k["name"] in ep_phase.ROW_KERNELS:
            # kernels 7 / 9 at a rank's row count of the slot-sharded runs
            k["ep_rows"] = {r: by_mesh["rows"][k["name"]]
                            for r, by_mesh in ep_summary["checks"].items()}
    log("ep summary: " + json.dumps({k: v for k, v in ep_summary.items() if k != "checks"},
                                    default=str))
    # slice 16: every rank's launches of 1, 1b, 2, 2b, 6 and 6b on the EP
    # training paths, and each llama4 rank's 1 / 1b / 2 / 2b at the EP shapes
    et_checks = {f"{r}/{case}": v for r, cases in et_summary["llama4"]["checks"].items()
                 for case, v in cases.items()}
    for k in kernels:
        if k["name"] in next(iter(et_paths.values())):
            k["launches_by_path"].update({p: c[k["name"]] for p, c in et_paths.items()})
        if k["name"] in ep_train_phase.KERNELS[:4]:
            k["ep_train_shapes"] = {key: v for key, v in et_checks.items()
                                    if key.split("/", 1)[1].startswith(k["name"] + "_")
                                    and (k["name"].endswith("backward")
                                         or "backward" not in key)}
    log("ep train summary: " + json.dumps(
        {m: {k: v for k, v in s.items() if k != "checks"} if isinstance(s, dict) else s
         for m, s in et_summary.items()}, default=str))
    log("slice 14 training summary: " + json.dumps(s14_summary))
    log("slice 10 training summary: " + json.dumps(s10_summary))
    log("obs summary: " + json.dumps(obs_summary))
    log("slice 9 kernel-6 calls by path: " + json.dumps(s9_calls))
    log("spec summary: " + json.dumps({p: s for p, (_, _, s) in spec_runs.items()}))
    clock.mark(None)
    log(f"script time: {time.perf_counter() - t_main:.1f} s from main's start, the build included "
        f"(phases 3 and 4's sync, roofline, graph and dry-run checks {analysis_s:.1f} s)")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
