#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (exit code 1, no result line) on failure:

1. Build the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all started together) into ``build/kernels/``.
2. Hold each kernel against its plain PyTorch version on the card: the main
   paths' shapes in bfloat16 and small float32 shapes (head dims 12/16, GQA
   groups 1-3, ragged lengths with 0, window, softcap, q_len 3; TF32 off).
   Flash has two routes: the CUDA-core kernel (f32, and bf16 at hd 12/16)
   at the old tolerances, also at the 2B/7B shapes when sent there; the
   tensor-core kernel (bf16, hd 64/128) over a sweep (B 2, Sq = Skv in
   {1, 63, 64, 65, 129, 1025}, groups 1/6/7, hd 64/128, windows 0/100,
   softcaps none/30, Sq 65 < Skv 300; the model layout through ``ops``
   and (B, H, S, hd) tensors; K/V views of buffers that are NaN past Skv)
   and at the 2B/7B shapes, each element within 1e-5 + 2^-6·|want| +
   2^-8·attention(q, k, |v|) (it rounds p to bf16 before PV; see
   ``check_wgmma``), and a misaligned view must raise.
   Decode attention has two routes too: the CUDA-core kernels (f32 and hd
   12/16, at the old tolerances; q_len·group past one block's rows in row
   tiles: 33, 35 and 70 rows) and the tensor-core kernel (bf16, hd 64/128,
   ``mma.sync``, one launch a call), held to flash's tensor-core bound
   (``check_mma_decode``) over a sweep (hd 64/128, groups 1-7, q_len 1-16,
   cache_len 0, 1, a partial tile and the whole cache, windows, softcaps;
   the cache NaN past each row's length) and at the 2B/7B decode step,
   where the CUDA-core kernel is held to its own tolerance at the same
   shape; a misaligned view must raise.
   The paged decode kernels: an f32 sweep over page sizes 1-16, windows,
   softcaps, q_len up to 10 (70 rows), rows with cache_len 0 and
   0 < cache_len < q_len; a bf16 sweep of the tensor-core route (pages 1-64,
   q_len up to 10); then (a) the 2B slot step (B 8, KH 2, group 6,
   page 8, table width 257, cache_len 1025-2049, shared prefix pages in
   several rows, trash entries past each row's length), (b) the same at the
   7B width (KH 4, group 7) and (c) the 7B verify at q_len 5 (35 rows,
   B 4), each on both routes, and the 7B verify at γ 9 (q_len 10, 70 rows:
   two row tiles) on both.  The kernels read pools whose trash page is NaN,
   so a read past a row's length would show.  The region score (a warp a
   region) over B 1-70000, R 1-1024 (R 100 and 1023 leave the last block
   partial), Nv 1-3, Ne 1-5, D 8-9000 in f32 and bf16 (its vector path,
   and its scalar path: bf16 at D 300, f32 at D 301, an unaligned base),
   the offload path's (B, R, 1, D) view and D + Ne at the shared-memory
   limit; at the main path's shape it is timed beside an empty kernel on
   its grid (the launch floor).  Tolerances, element by element: attention in
   float32 1e-4 absolute; attention in bfloat16 1e-5 + 2^-6·|want| (two
   bfloat16 ulps of the plain value: both sides round an f32 result to
   bfloat16); region scores (f32 math and output in both) 1e-5 absolute,
   which also covers the Pallas kernel's rsqrt(‖x‖² + 1e-12)
   normalisation.  Then time kernel, plain version and one PyTorch library
   call (for the paged kernel: gathering the pages plus
   ``scaled_dot_product_attention``, two calls) at the main paths' shapes
   (cold L2: a 64 MiB buffer is rewritten before every launch and its own
   time subtracted); the decode kernels' two routes and the library call
   in turns (tensor cores, library, CUDA cores, tensor cores).  The paged
   prefix-append kernel has two routes as well: the CUDA-core kernel over
   an f32 sweep (page sizes 1-16, chunks of 1-64 tokens, q_blk dividing
   them or not, windows, softcaps, groups 1/6/7, rows of length 0, below
   the chunk, the chunk alone and mid-prefill, NaN trash page, pools left
   unchanged) at the old tolerance, and the tensor-core route (bf16, hd
   64/128, the decode kernel's body in its prefix-append mode) held to
   the decode route's bound over a bf16 sweep (page sizes 1-16, chunks of
   1-256 tokens, groups 1/6/7, windows, softcaps, the same kinds of rows)
   and mixed flat steps (decode rows, a prompt row, a fresh stream and
   one mid-prefill, padding; each slot's table entries past its last
   position on the NaN trash page) with and without the tile plan; a
   misaligned view must raise.  Then (d) the 2B engine's flat fused step
   (B 264: 8 decode rows as in (a), one scene's last 256-token chunk as
   256 rows sharing one table row; on the tensor cores with the engine's
   tile plan, 34 row tiles, and without it) and (e) that chunk as one
   q_len-256 row, on both routes, timed as above.  The chunked
   gated-linear-attention scan has two routes, chosen by dtype and dk: the
   CUDA-core kernel over an f32 sweep (S 1, 37, 64, 256; chunk 16, 64; dk
   8, 16, 384; dv 9, 24, 385; zero and carried state; log_g
   -softplus(randn), -2 and -30, where the output must be finite) and the
   tensor-core kernel (bf16, dk % 16 == 0) over a bf16 sweep (dk 16-384,
   dv 9-385, the same kinds of cases), each call through ``ops`` one
   launch on its route; then both at (f) the xLSTM-125m prefill shape (B 4,
   S 4096, H 4, dk 384, dv 385, bf16) and (f') phase 9 (ii)'s B 128 x 512,
   timed in turns, with the cluster plan printed (blocks a cluster,
   m-tiles a block, clusters, clusters resident at once, waves).  The
   sLSTM recurrence has two routes, chosen by P (the cluster
   kernel from P 64 up, the per-row kernel below): both over an f32 sweep
   (B 1-5, 128 and 256, S 1-300, H 1-4 and 16, P 8/64/100/192/256:
   ragged batch groups and units, two waves of clusters at B 256 and
   H 16; zero and carried state, gate pre-activations past
   ±30; h and all four final states), the rule's route through ``ops``,
   then both at (g) B 4, S 4096, H 4, P 192, (g') B 128, S 512, the
   decode launches (S 1 at B 4 and B 128), the dependence floor's shape
   (B 1, H 1, P 8, S 4096) and the rule's crossover (B 4, S 4096, H 4 at
   P 16, 48, 64), timed in turns, with the cluster plan printed (cs, bt,
   clusters, clusters resident at once, waves).  Scan tolerances: outputs
   and states 1e-4 + 1e-4·|want| in f32, a bf16 output 1e-4 +
   2^-6·|want| (on both scan routes: the tensor-core one feeds its f32
   operands as bf16 hi + lo pairs and rounds o once); the sLSTM 2e-4 +
   2e-4·|want|.  (f), (f') and the sLSTM shapes are timed as above; no
   single PyTorch call computes either scan, so their library column is
   null.  The three paged kernels on int8 and fp8 pools
   (``quant_kernel_checks``): the kernels read the 8-bit pages and their
   per-(page, slot, head) scales, and are held against the plain version
   on the dequantized pools, whose trash page has NaN scales (an int8
   page cannot hold NaN) and, in fp8, NaN bytes 0x7F: small sweeps of
   both routes (CUDA cores in f32 at the old tolerance, decode and
   prefix-append, pages 1-16, hd 12-128, q_len up to 10, chunks up to 64
   with q_blk; tensor cores in bf16 at hd 64/128 to the unchanged bound,
   pages 1-64, q_len up to 10, chunks up to 256, a mixed flat step with
   and without its tile plan), then (a)-(e) on both routes, timed as
   above beside gather_pages + dequantize + SDPA; their bound counts the
   8-bit pages and the 4-byte scales once per distinct (page, slot).
   The dense attention configs' shapes (``dense_kernel_checks``): rows 1,
   2 and 4-6 at head dim 256 on their CUDA-core routes (bf16 takes them
   by its shape), f32 and bf16, groups 1 and 4, windows 0 and 512 (past
   512 keys, so they bite), softcaps none and 30, ragged lengths with 0,
   the paged rows over pages 1-16, q_len 1-10 and chunks up to 64 on fp,
   int8 and fp8 pools; gemma3-1b's own shapes (H 4, KH 1: prefill Sq =
   Skv = 1025, dense decode and the slot step at B 8, cache_len
   1025-2049, the chunked engine's flat fused step and a 256-token chunk,
   on bf16 and int8 pools), each at its local layers' window 512 and its
   global layers' none, timed as above beside SDPA (gather + SDPA for
   the paged rows); every hd-256 launch on the CUDA cores.  Then the
   tensor-core routes at the new groups: group 1 (codeqwen1.5-7b, 32/32)
   and 16 (glm4-9b, 32/2) on flash, decode and the slot step's paged
   decode, and gemma2-27b's group 2 with softcap 50 and window 4096 on
   flash at Sq = Skv = 6000 and on the paged decode at cache_len
   5000-6000 (the window floor bites), held to their bound and timed
   beside SDPA, or for gemma2-27b's softcap one compiled
   ``flex_attention`` call (tanh score_mod, causal-window block mask;
   gather + that call for the paged row).  The flash backward (training)
   has two routes.  The CUDA-core kernel against its plain version: an
   f32 sweep (hd 12/16/64/128/256, groups 1/4/6/7 (4: the ground proxy's
   8/2 heads at hd 16), Sq = Skv in {1, 63, 64, 65, 129, 1025} and
   65 < 300, windows 0/100 and softcaps none/30 in turns; K/V views of
   buffers NaN past Skv; every other case through autograd) within
   1e-4·G per element, G the largest |want| over dq, dk and dv, and in
   bf16 at the 2B's training shapes within that plus 2^-6·|want|
   (``check_grads``).  The tensor-core kernel (bf16, hd 64/128; it reads
   the wgmma forward's lse and rounds P and dS to bf16) over a bf16 sweep
   (hd 64/128, groups 1/6/7, Sq = Skv in {1, 63, 64, 65, 1025} and
   65 < 300, windows and softcaps in turns, NaN past Skv, autograd and
   the wrapper) within 1e-4·G + 2^-6·|want| + 2^-8·A (``check_bwd_wgmma``;
   A the products over absolute values), two calls bit-equal, its
   launches counted by route, the forward's lse within 1e-5 of the plain
   logsumexp and its output unchanged by writing lse, a misaligned view
   and a missing lse refused.  At the 2B's training shapes (B 4, 12/2
   heads, hd 128, S 1025 and 2048) both routes are timed in turns with
   the library's backward (SDPA forward and backward less its forward),
   and the dK/dV pass's causal tail is read from a profile (the group's
   heads split over 1, 2, 3 and 6 blocks).
3. End to end on a small proxy pair (flash, decode, prefix-append and the
   chunked scan on their CUDA-core routes alone, counted): the port's
   ``CascadeServer``, its
   ``InferenceEngine.serve`` on the paged slot path, the vmap oracle, a
   γ = 3 speculative engine, and chunked prefill (chunk 8, chunk N_r,
   chunk 8 with γ = 3) on the card, warmed up and captured (and the plain
   engine once more with eager steps), must give the decisions and tokens
   they give on the CPU from the same weights (float32), all equal to the
   plain engine's, the paged ones with the plain engine's prefix hits and
   misses, and no capture after warmup.  So must the batch evaluator
   (``SpaceVerse.run_batch``, vqa/cls/det at B 4), the four baselines at
   their deterministic settings (satellite-only, GS-only without a region
   drop, Tabi, AI-RG at 0.0 and 1.0) and ``CascadeServer(spec_gamma=3)``
   with a det request whose onboard answer rides the downlink as drafts:
   decisions, tokens and predictions equal, bytes and latencies within
   1e-6 relative, scores and probabilities within 1e-4, equal
   ``spec_stats()`` with piggybacked drafts.  The reduced xlstm-125m (f32):
   a 128-token prefill and 16 greedy decode steps give the CPU's tokens.
   The slot path, a γ = 3 speculative engine and a chunked one (chunk 8)
   on int8 and fp8 pools give the CPU's tokens and counters, with the
   stored K/V at most one quantization step apart (the share printed).
   Overload control (``overload_saturation``, the scenario that
   ``tests/test_torch_overload.py`` also runs against the JAX package: 4
   slots, a queue of 4, a pool of 1 + 3P + 3S pages, bulk det on two
   scenes, then urgent vqa, a bulk vqa expired by an explicit ``now`` and
   a burst of bulk cls) on the paged, chunked (8), γ 3 and int8 engines:
   the card gives the CPU's outcomes of every ``submit_many``, rejections
   with reasons, finished order and tokens, overload counts, prefix
   counters and pages, with at least one preemption, one ``queue_full``
   and one expiry, and the pool drained.  The engine's recurrent-state
   admission (``small_recurrent_path``): the reduced xlstm-125m and the
   mixed stack (attention, mLSTM, sLSTM), both with the vision frontend,
   served on the paged, int8-pool and dense engines and the vmap oracle
   (warmed up and captured on the card) give the CPU's tokens and prefix
   hits/misses, with graphs replayed and none captured after warmup.
4. The cascade server: ``CascadeServer.handle`` at the full width and
   depth of the paper's pair (Qwen2-VL-2B on the satellite, Qwen2-VL-7B on
   the ground), bfloat16, random weights from a seed, serving requests
   that reach both tiers.  After the counts are read, flash's tensor-core
   route and the region score are held on the path's own inputs (the
   first call at each shape).
5. Where the time goes: prefill and per-token decode time of each tier,
   flash's in-place device time per launch in a profiled prefill, and the
   device's busy share over decode steps from ``torch.profiler``; the 8
   profiled decode steps must show one decode kernel a layer (the
   tensor-core kernel; no split/combine pair) both in the profiler and in
   the wrappers' launch counts (zeroed before the steps, read after), and
   a failure prints both, so that a dropped profiler event and a missed
   launch are told apart.
6. The slot path: the 2B's ``InferenceEngine.serve`` (8 slots, page 8) on
   24 requests over 4 scenes (per scene 1 det with 1024 answer tokens,
   1 cls, 4 vqa).  Checks: every request answered; 20 prefix hits and 4
   misses; after the drain only the resident prefixes hold pages; the
   shared prefix pages byte-equal from their prefill to the end; the paged
   kernel launched 28 × (slot steps + admission calls).  Prints step time,
   tokens/s and the device busy share.
7. Speculative verify: the 7B's ``EngineCore`` with γ = 4 on 4 slots,
   drafted by the 2B: 6 vqa/cls requests, then one det request carrying
   the 7B's own greedy answer (from a non-speculative slot-path run) as
   piggybacked drafts.  Prints ``spec_stats()`` and how far the det answer
   agrees with the greedy one (bf16 near-ties may flip an argmax; equality
   is asserted in phase 3, in float32).  Checks the launch counts as in 6.
   Then a γ 9 engine (a 70-row verify chunk, past one block's 64 rows)
   serves two of the vqa requests: it must not raise, its launches are
   counted as above, and its answers' agreement with γ 4's is reported.
8. Chunked prefill: phase 6's stream through the 2B's ``InferenceEngine``
   with ``prefill_chunk`` 256 (token budget 264).  Checks: every request
   answered; phase 6's 20 prefix hits and 4 misses; pages after the drain
   = resident prefixes; shared pages byte-equal from publication to the
   end; chunk + prompt prefill tokens = phase 6's prefix + prompt; no stall
   step; every fused step within the budget with a token for every
   decoding slot; the prefix-append kernel launched 28 × fused steps, all
   on its tensor-core route, the paged decode kernel 28 × plain steps, no
   flash prefill and no region scoring; the prefix-append route held to
   its bound on the phase's own inputs (the first layer's call of the
   first fused step with decoding slots, with its tile plan and without).
   Prints fused and plain step time, tokens/s, the device busy share and
   device time over profiled fused steps, agreement with phase 6's
   answers (bf16), and the longest gap between two tokens of a det answer
   here and in phase 6.
9. The xlstm-125m serve step at full width and depth (12 layers: 8 mLSTM,
   4 sLSTM; d 768, 4 heads, vocab 50304, bf16, random weights from a
   seed) through ``transformer.prefill`` and ``decode_step`` with greedy
   decoding in this script: (i) a B 4 × 32768-token prefill (the
   ``prefill_32k`` length, its batch cut from 32 to 4 for time) and 128
   decode steps; (ii) the ``decode_32k`` batch, 128 rows, after a
   512-token prefill, and 64 decode steps.  Checks: every logit finite;
   ``ssm_scan`` launched 8 × prefills and ``slstm_scan`` 4 × (prefills +
   decode steps), every one on the route the rule names (the tensor-core
   scan at bf16, dk 384; the sLSTM's cluster route at P 192), no attention
   kernel; per run, both kernels against
   their plain versions on the inputs the path gives them (the first
   mLSTM and sLSTM layers of the run's prefill, the first sLSTM layer of
   the decode step after it, with its carried state), to phase 2's
   tolerances; prefill(4096) against prefill(4032) + 64 decode steps over
   the same tokens (the chunk form against the sequential path, and the
   sLSTM's initial-state operand) with the weights in float32: logits
   within 1e-3, every state leaf within 1e-3 of its largest magnitude;
   in bf16: logits within 0.5, states within 0.25 of their largest
   magnitude, every argmax equal, each path within 1.0 of the f32 result
   (bf16 rounding, amplified through 12 random-init layers, moves each
   path ~0.5 in the logits; limits set from the H100's readings with
   about twice their room).  Prints prefill ms and
   tokens/s, each kernel's in-place time per launch, decode step ms and
   tokens/s, the device busy share over decode steps, the B 128 step's
   bound, and per run the top device operations of the 8 profiled decode
   steps (name, launches, ms a step).
10. The batch evaluator at full width (run after phase 8, while phase 4's
   pair is loaded): ``SpaceVerse.run_batch`` on cls and vqa at B 16 (the
   quickstart's batch) over phase 4's τ settings and a split at the
   middle of the batch's stage-0 scores, det at B 2 (1024 answer tokens
   on both tiers); ``evaluate("cls", ...)`` over 32 samples in batches of
   16; the four baselines on cls at B 16 (GS-only with a 0.5 random region
   drop and AI-RG at its planned fraction, drawn on the card).  Then a
   ``CascadeServer(spec_gamma=4)`` on phase 4's five vqa/cls requests:
   tiers, exit stages and bytes equal to phase 4's, token agreement
   reported.  Checks: every score and probability finite, the τ rule,
   both routes in the split batches, flash = 28 × prefills on the tensor
   cores, decode on the mma route only, one region score per
   ``multiscale_view``, paged decode/verify launched by the server, one
   verify step per ground request (phase 4's answers are one token long,
   so no draft is verified here: phases 3 and 7 hold the draft stream);
   flash, the region score and the dense decode held on the evaluator's
   first inputs at each shape (B 16 and B 2), the paged decode and verify
   on the server's.  Prints each ``run_batch``'s wall time (host clock,
   synchronised) and samples/s, the modelled mean latency and offload
   rate, and the phase's seconds.
11. Quantized pools at full width (after phase 10, while the pair is
   loaded): phase 6's stream on int8 pools and phase 8's chunked stream
   on fp8 pools, each with its phase's checks (20 hits and 4 misses,
   pages, shared pages byte-equal from their prefill to the end, launches
   per layer on the tensor cores) and every paged launch on the pool's
   storage; phase 8's scenes without their det requests, chunked on int8
   pools (every prefix-append launch on the tensor cores and the int8
   pool); phase 7's γ 4 7B engine drafted by the 2B on its vqa/cls
   requests on int8 pools (verify launches per layer, a verify chunk
   reaching the kernel); a 2B engine given phase 6's bf16 pool bytes as
   ``pool_bytes`` at int8 (its page count the one ``page_nbytes`` gives:
   4224 B a layer page against 8192 B).  Each quantized kernel is held to
   its bound on the path's own first inputs; token agreement with the
   bf16 runs is reported through ``kv_quant.compare_outputs``.
12. Overload control at full width (after phase 11, while the pair is
   loaded, before 9), on the 2B's slot path, bf16, page 8.  (a) A
   saturated ``EngineCore``: 4 slots, ``OverloadConfig(queue_cap=4)``, a
   pool of 1 + 3P + 3S = 772 pages (P = 129 private, S = 128 shared pages
   a slot); 4 bulk det on scenes A, A, B, B, then after 64 steps, with no
   step between, 2 urgent vqa on a new scene C, a bulk vqa on E with a
   1 ms deadline and a burst of 5 bulk cls on D; steps until the queue is
   empty and one slot is left (B's second det, ~950 more steps alone:
   nothing new happens there), whose slot is then released.
   Checks: every request answered (right length, in the answer vocab),
   rejected once with a reason from the three, or the one left in flight
   with tokens committed, none two of these, none lost; a
   preemption, a deferral, a ``queue_full`` and an expiry; each preempted
   det answer whose scene prefix stayed resident until it was admitted
   again begins with the tokens it had committed when it was preempted
   (recorded as ``_preempt_one`` releases the slot; the other case is
   reported); after the release only resident prefix pages in use, no
   prefix entry in use, the block table all trash page; the paged decode
   kernel launched 28 × (steps + admission calls), all on the tensor
   cores, flash 28 × prefix prefills on the wgmma route; the paged decode
   kernel held to its tensor-core bound (``decode_on_path_inputs``) on the
   path's own inputs at the first step after the three submits (B 4, KH
   2, a 257-page table; three rows past the 1024-token prefix, one
   empty), after the counts were read.  Prints the outcomes, rejections, preemptions and finished order, step ms, answer
   tokens/s, the device busy share over 8 profiled steps (from step
   256), ``scheduler_stats()["overload"]`` and the phase's seconds.
   (b) ``InferenceEngine.serve`` with overload on phase 8's chunked engine
   (8 slots, chunk 256, budget 264), ``OverloadConfig(queue_cap=32)``, a
   pool of 1 + 4P + 2S pages (at most four requests at once, new scene
   streams wait for pages): phase 6's 20 cls/vqa requests, priorities
   alternating bulk and urgent.  Checks: all answered, ``last_rejected``
   empty, pages drained to the resident prefixes, prefix-append 28 × fused
   steps and paged decode 28 × plain steps, all on the tensor cores, no
   flash, no region score; token agreement with phase 6 is reported.
   Line ``overload_phase {...}``.
13. Sharded serving at full width (after phase 12, while the 2B is
   loaded, before 9), on the 2B's slot path, bf16, page 8, phase 6's
   stream.  (a) dp 2 × tp 1 in this process: a (2, 1) mesh of ``cuda:0``
   twice, two shard engines of 4 slots with private pools behind the
   scene-affine router.  ``InferenceEngine.serve`` of the 20 cls/vqa
   requests: every one answered in the answer vocab; the router's prefix
   misses/hits (6/14: scene A's fifth request overflows its full shard,
   as the JAX router decides on the CPU); 4 + 4 slots, 20 routed; paged
   decode 28 × (shard steps + admission calls) on the tensor cores.  Then
   the 4 det requests on a ``make_engine_core`` core for 64 steps and no
   drain: both shards step every step, paged decode 28 × (steps +
   admission calls).  Their committed tokens against one ``EngineCore``'s
   run of the same 64 steps and against phase 6's answers, and the 20
   answers against phase 6's, are reported.  (b) dp 1 × tp 2: two rank
   processes (``launch.mesh.spawn_tp``) on ``cuda:0`` over ``gloo``, each
   rebuilding the 2B from phase 4's seed and taking its block of the heads
   and the FFN (``sharded_tp_rank``): the same serve, the same 64 det
   steps (the paged decode's inputs kept from the first step: B 8 × KH 1 ×
   group 6, four rows past the prefix, four empty), the 20 on a chunked
   engine (``prefill_chunk`` 256; the prefix-append inputs kept from the
   first fused step with decoding slots).  Checks: both ranks' answers
   and committed tokens identical and in the answer vocab; 4 misses / 16
   hits; every pool at KH 1; ``kv_bytes_per_slot_device`` × 2 ==
   ``kv_bytes_per_slot``; paged decode per rank 28 × (steps + admission
   calls), prefix-append 28 × fused steps, all on the tensor cores; all-
   reduces 2 × 28 a model call; the backend gloo; each rank holds rows 4
   and 6 to their tensor-core bound on its kept inputs after its counts
   were read.  Prints each rank's step ms and the backend.  Line
   ``sharded_phase {...}``; a failure in a rank fails the phase.  The
   ranks' engines run eager steps (``cuda_graphs=False``): a gloo
   all-reduce crosses the host and is not captured.
14. Captured steps against eager steps at full width (after 13, while
   the pair is loaded): the same requests through two engines that differ
   only in ``cuda_graphs``, each warmed up (the captured one captures
   every step family and admission bucket there), its counts zeroed just
   before its run: (a) phase 6's stream on the 2B to the end; (b) phase
   8's chunked engine over its first 128 steps, and phase 7's γ 4 7B
   engine drafted by the 2B (its vqa/cls requests and a det answer
   drafted locally) over its first 64; (c) phase 6's stream on int8
   pools over its first 128 steps.  Checks: tokens equal both ways (the
   same kernels on the same inputs), launch counts equal both ways, the
   captured engine has graphs and replays and captured nothing after
   warmup.  Prints each run's step ms (host clock, mean and median), the
   device's busy share over 8 profiled steps, the graphs and their pool's
   bytes, beside the card's name and power limit.  (d) the vmap oracle,
   captured, on the 2B for 16 steps at 8 slots: its step ms and how many
   requests' tokens so far equal (a)'s (bf16, other GEMM shapes:
   reported).  Line ``graphs_phase {...}``.
15. The xlstm-125m on the slot path at full width and depth (after 9):
   ``dataclasses.replace(get_config("xlstm-125m"), frontend="vision")``
   (12 layers: 8 mLSTM, 4 sLSTM; d 768, 4 heads, vocab 50304, bf16,
   random weights from a seed) with phase 4's adapter (N_r = 1024), an
   ``EngineCore`` on the paged slot path, each stream through an eager
   engine and a captured one: (a) phase 6's stream (24 requests over 4
   scenes) on 8 slots to the end; (b) 64 vqa/cls requests over 8 scenes
   on 64 slots.  Checks: tokens and launch counts equal both ways, every
   request answered in the answer vocab, nothing captured after warmup;
   ``ssm_scan`` 8 × prefix prefills on the tensor cores, ``slstm_scan``
   4 × (prefix prefills + admission calls + slot steps) on the cluster
   route, no other kernel; a further prefix prefill on (a)'s captured
   engine with its scan inputs kept, both kernels held against their
   plain versions on them at phase 2's tolerances.  Prints step ms (host
   clock), device ms a step and busy share (8 profiled steps), the replay
   ms of each captured prefix-prefill bucket, the admission step and the
   slot step (CUDA events), answer tokens/s, graphs and pool bytes, state
   bytes per slot and per resident prefix, the slot step's bound, beside
   the card's name and power limit.  Line ``xlstm_serve_phase {...}``.
16. The dense attention configs at full width and depth (after 15), each
   in turn and freed before the next: gemma3-1b (26 layers, 4/1 heads, hd
   256, window 512 on 22 layers), codeqwen1.5-7b (32 layers, 32/32, hd
   128), glm4-9b (40 layers, 32/2) and gemma2-27b (46 layers, 32/16,
   softcaps 50 and 30, window 4096 on every other layer), bf16, random
   weights from a seed, ``frontend="vision"`` with phase 4's adapter
   (N_r = 1024), through ``EngineCore``'s paged slot path (8 slots, page
   8, a pool for the stream's four scenes): phase 6's stream over its
   first ``DENSE_STEPS`` steps, eager and captured; one
   ``EngineCore.generate`` (vqa); for gemma3-1b the stream on a chunked
   engine (``prefill_chunk`` 256) and on int8 pools too.  Checks per run:
   tokens and launch counts equal both ways, no capture after warmup,
   answers in the vocab; flash = layers × prefix prefills, paged decode
   = layers × (steps + admission calls) (chunked: prefix-append =
   layers × fused steps, paged decode = layers × plain steps), every
   launch on the route the head dim names (hd 128: tensor cores; hd 256:
   CUDA cores), no other kernel; generate: flash and dense decode once a
   layer; every eager run's attention inputs (first layer, each step
   family and shape) held against the plain versions.  Prints weight
   bytes, prefix-prefill replay ms by bucket, step ms eager and
   captured, device ms a step and busy share, the step's weight-streaming
   bound, answer tokens/s, pool and graph-pool bytes, memory allocated at
   the phase's start and each model's peak.  Line
   ``dense_serve_phase {...}``.
17. Training (after 16, with nothing else resident).  (a) Qwen2-VL-2B at
   full width (28 layers, d 1536, vocab 151936), random bf16 weights from
   seed 0, phase 4's adapter: ``make_train_step`` (AdamW at lr 3e-4, f32
   moments, remat "nothing", ce_chunks 8) takes 4 steps in a row on each
   of three fixed batches (det: B 4 x S 2048, first; vqa, cls: B 4 x S
   1025), counts zeroed just before.  Checks: every loss finite, the det
   batch's loss falls at every step; ``flash_attention_bwd`` 28 launches
   a step, all on the tensor-core route, and the wgmma forward 56 (the
   forward and the remat's recompute), no CUDA-core flash; the
   backward kernel held against its plain version, under its bound, on
   layer 0's inputs of an extra det step, untimed and after the counts.
   Prints step ms by task, one profiled det step (device ms, busy share,
   top device ops, the backward's kernels' device ms) and one profiled
   vqa step (device ms, busy share), tokens/s, peak memory, the step's
   FLOPs beside their bound.  (b) ``core.pipeline.build_system``
   at the test suite's tiny-bundle settings on the card, then on the CPU
   (CPU generators on both: the same draws): first-step losses within
   1e-4 relative, the last within ``TOL_PROXY_FINAL``; a witness, a CPU
   run whose initial weights are one ulp up, whose gaps from the CPU run
   bound the card's largest gaps over the steps (x 4); the card bundle's
   ``spaceverse().evaluate`` on the card; its backward runs on the
   CUDA-core route alone (f32).  Line ``train_phase {...}``;
   paths ``train_full_width`` and ``train_proxies_card`` in the kernels
   line.

The slot-path engines of phases 3, 6-8, 10-12 and 13 (a) capture their
steps as CUDA graphs in ``warmup()`` (``serving/graphs.py``) and replay
them; a replay adds the launches its capture counted, so the counts below
hold for captured steps too.  Where a phase keeps a kernel's inputs from
its path (``capture_inputs``), the steps up to the kept call run their
bodies eagerly.

Phases 3, 4, 6, 7, 8, each run of 9 and each path of 10, 11, 12, 13, 14,
15 and 16
(the batch evaluator, the speculative server; in 13 each rank's runs too)
zero every kernel's launch count just before they run and read it just
after; each kernel of a path must have launched.  In phases 4, 6, 7 and 10
the tensor-core flash route launched once per layer of every model
prefill (28 × prefills: ``transformer.prefill`` calls that launched, and
replays of an engine's captured prefill steps) and the CUDA-core route
never,
as in 12 (a) and 13 (a); in phases 4, 6-8 and 10-13 every decode launch
(dense and paged) took the tensor-core route, in phase 3 the CUDA-core
route; every prefix-append launch took the tensor-core route in phases 8,
12 (b) and 13 (b) and the CUDA-core route in phase 3.
A kernel with two routes counts all its launches under its old name and
the tensor-core ones under ``*_wgmma`` / ``*_mma`` as well; the paged
kernels also count their launches on 8-bit pools under
``"<kernel>[int8]"`` / ``"[fp8]"``, rows of their own in the kernels
line.  Its last lines: the card's name and power limit as ``nvidia-smi``
gives them, one JSON object with every kernel's numbers, then ``{"ok":
true, "device": {...}}``.
"""
from __future__ import annotations

import gc
import json
import math
import pathlib
import subprocess
import sys
import time
from typing import Optional

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SOURCES = ("flash_attention.cu", "flash_attention_wgmma.cu",
           "flash_attention_bwd.cu", "flash_attention_bwd_wgmma.cu",
           "decode_attention.cu", "decode_attention_mma.cu",
           "region_score.cu", "paged_prefill_attention.cu", "ssm_scan.cu",
           "ssm_scan_mma.cu", "slstm_scan.cu")
# decode_attention.cu and decode_attention_mma.cu each hold a dense and a
# paged decode entry point; decode_attention_mma.cu also the prefix-append
# kernel's tensor-core entry
# (absolute, relative to |want|) per element; see the docstring
TOL_F32 = (1e-4, 0.0)
TOL_BF16 = (1e-5, 2.0 ** -6)
TOL_REGION = (1e-5, 0.0)
# the scans, f32 math on both sides in another summation order: outputs
# and states 1e-4 + 1e-4·|want|; a bf16 scan output (both sides round an f32
# result) 1e-4 + 2^-6·|want|; the sLSTM's h and (h, c, n, m) after up to
# 4096 dependent steps 2e-4 + 2e-4·|want| (the JAX package's own parity
# tolerance for its kernel)
TOL_SCAN = (1e-4, 1e-4)
TOL_SCAN_BF16 = (1e-4, 2.0 ** -6)
TOL_SLSTM = (2e-4, 2e-4)
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
REPLACES = {
    # no Pallas kernel: the JAX package's flash backward is the custom VJP
    # of ref.flash_structured (_fs_bwd)
    "flash_attention_bwd": "src/repro/kernels/ref.py:201",
    "flash_attention_bwd_wgmma": "src/repro/kernels/ref.py:201",
    "flash_attention_wgmma": "src/repro/kernels/flash_attention.py:84",
    "flash_attention": "src/repro/kernels/flash_attention.py:84",
    "decode_attention": "src/repro/kernels/decode_attention.py:219",
    "decode_attention_mma": "src/repro/kernels/decode_attention.py:219",
    "region_score": "src/repro/kernels/region_score.py:38",
    "paged_decode_attention": "src/repro/kernels/decode_attention.py:301",
    "paged_decode_attention_mma":
        "src/repro/kernels/decode_attention.py:301",
    "paged_prefill_attention": "src/repro/kernels/decode_attention.py:448",
    "paged_prefill_attention_mma":
        "src/repro/kernels/decode_attention.py:448",
    "ssm_scan_mma": "src/repro/kernels/ssm_scan.py:65",
    "ssm_scan": "src/repro/kernels/ssm_scan.py:65",
    "slstm_scan_cluster": "src/repro/kernels/slstm_scan.py:69",
    "slstm_scan": "src/repro/kernels/slstm_scan.py:69",
}
SOURCE_OF = {
    "flash_attention_bwd": "src/repro_torch/csrc/flash_attention_bwd.cu",
    "flash_attention_bwd_wgmma":
        "src/repro_torch/csrc/flash_attention_bwd_wgmma.cu",
    "flash_attention_wgmma": "src/repro_torch/csrc/flash_attention_wgmma.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    "decode_attention": "src/repro_torch/csrc/decode_attention.cu",
    "decode_attention_mma": "src/repro_torch/csrc/decode_attention_mma.cu",
    "region_score": "src/repro_torch/csrc/region_score.cu",
    "paged_decode_attention": "src/repro_torch/csrc/decode_attention.cu",
    "paged_decode_attention_mma":
        "src/repro_torch/csrc/decode_attention_mma.cu",
    "paged_prefill_attention":
        "src/repro_torch/csrc/paged_prefill_attention.cu",
    "paged_prefill_attention_mma":
        "src/repro_torch/csrc/decode_attention_mma.cu",
    "ssm_scan_mma": "src/repro_torch/csrc/ssm_scan_mma.cu",
    "ssm_scan": "src/repro_torch/csrc/ssm_scan.cu",
    "slstm_scan_cluster": "src/repro_torch/csrc/slstm_scan.cu",
    "slstm_scan": "src/repro_torch/csrc/slstm_scan.cu",
}
# full-width adapter: N_r = 32² = 1024 = cfg.num_patches, 16-px regions
# (the Eq. 3 pyramid pools by 1, 2, 4 and 8, so the side must divide by 8)
FULL_GRID, FULL_IMAGE = 32, 512
# the spec phase's det request carries piggybacked drafts for all but its
# last LOCAL_TAIL answer positions, which the 2B drafts locally
LOCAL_TAIL = 32


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

class ColdTimer:
    """Mean device time of ``fn`` with a cold L2: a 64 MiB buffer (more
    than the 50 MB L2) is rewritten before every launch, and the time of
    the rewrites alone is subtracted.  A spin kernel runs first so that the
    host has queued every launch before the device reaches them: the
    events then time the device, not the host's enqueue."""

    SPIN_CYCLES = 100_000_000          # ~50 ms at H100 clocks

    def __init__(self, torch, reps: int = 20):
        self.torch = torch
        self.reps = reps
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def _loop(self, fn, reps: int):
        torch = self.torch
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(self.SPIN_CYCLES)
        start.record()
        for _ in range(reps):
            self.flush.zero_()
            if fn is not None:
                fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    def __call__(self, fn, reps: Optional[int] = None) -> float:
        """``reps`` (default the timer's) launches of ``fn``, each after an
        L2 flush."""
        reps = reps or self.reps
        fn()
        self.torch.cuda.synchronize()
        both = self._loop(fn, reps)
        flush = self._loop(None, reps)
        return max(both - flush, 0.0) / reps


def bound_ms(n_bytes: float, flops: float, dtype: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def dense_mask(torch, lens, q_len, s, window=0):
    """The (B, 1, T, S) boolean mask of the chunk-causal decode function:
    token t of row b sees columns < cache_len - (q_len - 1) + t, and with a
    window those >= that length less the window (SDPA's operand)."""
    pos = torch.arange(s, device=lens.device)
    eff = (lens[:, None].long() - (q_len - 1)
           + torch.arange(q_len, device=lens.device)[None, :])
    mask = pos[None, None, :] < eff[:, :, None]
    if window > 0:
        mask &= pos[None, None, :] >= (eff - window)[:, :, None]
    return mask[:, None]


def flash_flops(torch, h, hd, sq, skv, window=0):
    """FLOPs of causal attention (QK and PV) over the keys each query row
    sees: bottom-right causal, at most ``window`` with one."""
    i = torch.arange(sq, dtype=torch.float64) + (skv - sq)
    seen = i + 1 if window <= 0 else torch.clamp(i + 1, max=window)
    return 4.0 * hd * h * float(seen.sum())


def timed_rows(timer, kernels, plain, library, n_bytes, flops, shape,
               **extra):
    """The report's rows at one main-path shape, one per route of
    ``kernels`` ({route: (function, max abs error)}): the first route
    timed in turns with the library call and the others (first, library,
    others, first: one card, one call; ``library`` None where no PyTorch
    call computes the function), beside the plain version and the bound
    of ``n_bytes`` and ``flops``.  ``extra`` goes into every row.  Returns
    {route: row}."""
    b_ms, b_by = bound_ms(n_bytes, flops, "bfloat16")
    base = {"plain_ms": timer(plain), "bound_ms": b_ms, "bound_by": b_by,
            "bytes": n_bytes, "flops": flops, "shape": shape, **extra}
    (first, (kernel, err)), *others = kernels.items()
    runs = [timer(kernel)]
    base["library_ms"] = timer(library) if library is not None else None
    ms = {route: timer(fn) for route, (fn, _) in others}
    runs.append(timer(kernel))
    ms[first] = sum(runs) / len(runs)
    rows = {route: dict(base, max_abs_err=err, ms=ms[route], route=route,
                        bound_share=b_ms / ms[route])
            for route, (_, err) in kernels.items()}
    rows[first]["ms_runs"] = runs
    return rows


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check(name, got, want, tol, case, errors):
    """Every element within ``atol + rtol·|want|``; returns the max
    absolute error."""
    atol, rtol = tol
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    err = float(diff.max())
    worst = float((diff / (atol + rtol * want.abs())).max())
    ok = math.isfinite(err) and worst <= 1.0
    log(f"  {name:16s} {case:48s} max_abs_err {err:.3e} tol {atol:.0e}"
        f"+{rtol:.2g}|want| (used {worst:.3f}) {'ok' if ok else 'FAIL'}")
    if not ok:
        errors.append(f"{name} {case}: max_abs_err {err}, {worst:.3f} of "
                      f"the tolerance")
    return err


def check_wgmma(name, got, q, k, v, kw, case, errors):
    """The tensor-core flash route, element by element within
    1e-5 + 2^-6·|want| + 2^-8·A, want the f32 plain version and A =
    attention(q, k, |v|) in f32.  It rounds p to bf16 before PV; bf16's
    unit roundoff is 2^-8, so each p_j moves by at most 2^-8·p_j and an
    output by at most 2^-8·A: the third term is exactly that worst case.
    The output's own rounding to bf16 (2^-9·|want|) falls under 2^-6·|want|,
    the f32 sums' order, the rescales and ex2.approx (relative errors near
    2^-24 a step) under the rest.  The p roundings take both signs, so
    their sum stays well inside the worst case; the shares this prints
    (of the whole bound) are the evidence.  Returns (max absolute error,
    share of the bound used)."""
    from repro_torch.kernels import ref
    qf, kf, vf = q.float(), k.float(), v.float()
    return check_bound(name, got, ref.flash_attention(qf, kf, vf, **kw),
                       ref.flash_attention(qf, kf, vf.abs(), **kw), case,
                       errors)


def check_mma_decode(name, got, q, k, v, lens, kw, case, errors):
    """The tensor-core decode route (it rounds p to bf16 before PV, as the
    flash route does), held to flash's bound: q (B, T, H, hd), k/v (B, S,
    KH, hd) dense (the plain version's operands; paged pools gathered),
    cache_len INCLUDING the chunk.  Returns (max absolute error, share of
    the bound used)."""
    from repro_torch.kernels import ref
    qf, kf, vf = q.float(), k.float(), v.float()
    return check_bound(
        name, got, ref.multi_decode_attention(qf, kf, vf, lens, **kw),
        ref.multi_decode_attention(qf, kf, vf.abs(), lens, **kw), case,
        errors)


def check_bound(name, got, want, a, case, errors):
    """Every element within 1e-5 + 2^-6·|want| + 2^-8·a (``check_wgmma``
    says why); returns (max absolute error, share of the bound used)."""
    diff = (got.float() - want).abs()
    err = float(diff.max())
    share = float((diff / (1e-5 + 2.0 ** -6 * want.abs()
                           + 2.0 ** -8 * a)).max())
    ok = math.isfinite(err) and share <= 1.0
    log(f"  {name:16s} {case:48s} max_abs_err {err:.3e} bound 1e-05+2^-6"
        f"|want|+2^-8A (used {share:.3f}) {'ok' if ok else 'FAIL'}")
    if not ok:
        errors.append(f"{name} {case}: max_abs_err {err}, {share:.3f} of "
                      f"the bound")
    return err, share


def flash_wgmma_sweep(torch, randn, errors):
    """The tensor-core route (bf16, hd 64/128) against the plain version in
    the model layout through ``ops`` and on (B, H, S, hd) tensors straight
    to the wrapper: B 2, Sq = Skv in {1, 63, 64, 65, 129, 1025}, groups
    1/6/7, hd 64 and 128, windows 0/100, softcaps none/30 (in turns), and
    Sq 65 < Skv 300.  K/V are views into buffers whose rows past Skv are
    NaN, so a tensor map sized past Skv would show.  The grids run from 2
    blocks to B 2 x 28 heads x 17 tiles = 952, so both block shapes the
    launcher picks (one or two consumer warpgroups) are held.  A
    misaligned view must raise before any launch.  Returns the largest
    share of the bound any case used."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    bf16, nan = torch.bfloat16, float("nan")
    log("flash_attention vs plain (wgmma route)")
    opts = [(0, None), (100, None), (0, 30.0), (100, 30.0)]
    cases = [(s, s, g, kh, hd) for s in (1, 63, 64, 65, 129, 1025)
             for g, kh, hd in ((1, 2, 64), (6, 2, 128), (7, 4, 128),
                               (7, 1, 64))]
    cases += [(65, 300, 6, 2, 128), (65, 300, 7, 1, 64)]
    shares = []
    for n, (sq, skv, group, kh, hd) in enumerate(cases):
        window, softcap = opts[n % len(opts)]
        kw = {"window": window, "softcap": softcap}
        h = kh * group
        q = randn(2, sq, h, hd, dtype=bf16)
        for layout in ("model", "bhsd"):
            if layout == "model":       # (B, S, KH, hd) views of (B, S+16, ...)
                kb, vb = (randn(2, skv + 16, kh, hd, dtype=bf16)
                          for _ in range(2))
                kb[:, skv:], vb[:, skv:] = nan, nan
                k, v = kb[:, :skv], vb[:, :skv]
                got = ops.flash_attention(q, k, v, **kw)
            else:                       # (B, KH, S, hd) views of (B, KH, S+16, ...)
                kb, vb = (randn(2, kh, skv + 16, hd, dtype=bf16)
                          for _ in range(2))
                kb[:, :, skv:], vb[:, :, skv:] = nan, nan
                k, v = kb[:, :, :skv].transpose(1, 2), vb[:, :, :skv] \
                    .transpose(1, 2)
                got = flash_attention_cuda(
                    q.transpose(1, 2).contiguous(), k.transpose(1, 2),
                    v.transpose(1, 2), **kw).transpose(1, 2)
            shares.append(check_wgmma(
                "flash_attention", got, q, k, v, kw,
                f"bf16 {layout} hd{hd} g{group} Sq{sq} Skv{skv} "
                f"w{window} cap{softcap}", errors)[1])
    log(f"  wgmma sweep: largest share of the bound {max(shares):.3f}")
    buf = randn(1, 70, 4, 136, dtype=bf16)
    try:
        flash_attention_cuda(buf[..., 1:129].transpose(1, 2),
                             buf[:, :, :2, :128].transpose(1, 2),
                             buf[:, :, :2, :128].transpose(1, 2))
        errors.append("flash_attention: a misaligned view was not refused")
        log("  flash_attention  misaligned q view: launched (FAIL)")
    except ValueError as e:
        log(f"  flash_attention  misaligned q view: refused ({e}) ok")
    return max(shares)


def host_us(torch, fn, reps: int = 100, rounds: int = 5) -> float:
    """Host time of one call of ``fn`` (its enqueue), in µs: the least mean
    over ``rounds`` rounds of ``reps`` calls (other work on a shared host
    only adds time)."""
    fn()
    best = math.inf
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        best = min(best, time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e6 * best / reps


def wrapper_us(torch, kernel, fn) -> float:
    """``host_us`` of ``fn`` with ``kernel``'s C entry point swapped for a
    no-op: what the wrapper's Python costs the host a call."""
    kernel.bind()
    real, kernel._fn = kernel._fn, lambda *args: 0
    try:
        return host_us(torch, fn)
    finally:
        kernel._fn = real


def kernel_checks(torch):
    """Returns {kernel: measured numbers at its main-path shape}."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     launch_cuda_cores)

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    errors, report = [], {}
    timer = ColdTimer(torch)
    bf16 = torch.bfloat16

    # -- flash attention: model layout (B, S, H, hd) through ops ------------
    # the CUDA-core route: float32 and the proxies' head dims, also in bf16
    log("flash_attention vs plain (CUDA-core route)")
    for hd, group, kh, sq, skv, window, softcap, dt in [
            (12, 1, 2, 40, 40, 0, None, torch.float32),
            (12, 3, 1, 33, 33, 0, None, torch.float32),
            (16, 2, 2, 70, 70, 0, None, torch.float32),
            (16, 3, 2, 65, 65, 16, None, torch.float32),
            (16, 2, 1, 37, 37, 0, 5.0, torch.float32),
            (12, 2, 2, 9, 50, 0, None, torch.float32),
            (16, 3, 2, 65, 65, 0, None, bf16),
            (12, 2, 1, 33, 70, 16, 5.0, bf16)]:
        q = randn(2, sq, kh * group, hd, dtype=dt)
        k, v = randn(2, skv, kh, hd, dtype=dt), randn(2, skv, kh, hd, dtype=dt)
        tag = "f32" if dt == torch.float32 else "bf16"
        case = (f"{tag} hd{hd} g{group} Sq{sq} Skv{skv} w{window} "
                f"cap{softcap}")
        check("flash_attention",
              ops.flash_attention(q, k, v, window=window, softcap=softcap),
              ref.flash_attention(q, k, v, window=window, softcap=softcap),
              TOL_F32 if dt == torch.float32 else TOL_BF16, case, errors)
    sweep_share = flash_wgmma_sweep(torch, randn, errors)
    for tag, h, kh in (("2B", 12, 2), ("7B", 28, 4)):
        s, hd = 1025, 128
        q, k, v = randn(1, s, h, hd, dtype=bf16), randn(1, s, kh, hd,
                                                          dtype=bf16), \
            randn(1, s, kh, hd, dtype=bf16)
        err, share = check_wgmma("flash_attention",
                                 ops.flash_attention(q, k, v), q, k, v, {},
                                 f"bf16 {tag} H{h} KH{kh} S{s} hd{hd}",
                                 errors)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        # the CUDA-core kernel at the same shape, at its own tolerance
        err_cc = check("flash_attention",
                       launch_cuda_cores(qt, kt, vt).transpose(1, 2),
                       ref.flash_attention(q, k, v), TOL_BF16,
                       f"bf16 {tag} S{s} hd{hd} on CUDA cores",
                       errors)
        rows = timed_rows(
            timer, {"wgmma": (lambda: flash_attention_cuda(qt, kt, vt), err),
                    "cuda_cores": (lambda: launch_cuda_cores(qt, kt, vt),
                                   err_cc)},
            lambda: ref.flash_attention(q, k, v),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True),
            nbytes(q, k, v, q), flash_flops(torch, h, hd, s, s),
            f"B1 H{h} KH{kh} Sq=Skv={s} hd{hd} bf16")
        rows["wgmma"].update(tolerance_share=share,
                             sweep_tolerance_share=sweep_share)
        report.setdefault("flash_attention_wgmma", {})[tag] = rows["wgmma"]
        report.setdefault("flash_attention", {})[tag] = rows["cuda_cores"]
        # what encoding the three tensor maps adds on the host: enqueue
        # time of one launch per route, no L2 flush (the device lags)
        report["flash_attention_wgmma"][tag]["host_us_per_call"] = {
            r: host_us(torch, lambda: launch(qt, kt, vt))
            for r, launch in (("wgmma", flash_attention_cuda),
                              ("cuda_cores", launch_cuda_cores))}

    # -- decode attention: (B, H, hd) / (B, T, H, hd) through ops -----------
    # the CUDA-core route: float32 and the proxies' head dims; 33 and 35
    # rows take two row tiles
    log("decode_attention vs plain (CUDA-core route)")
    for hd, group, q_len, window, softcap in [
            (12, 1, 1, 0, None), (12, 3, 1, 0, None), (16, 2, 1, 0, None),
            (16, 3, 3, 0, None), (12, 2, 3, 0, None), (16, 2, 1, 8, None),
            (16, 3, 1, 0, 3.0), (12, 2, 3, 5, 2.5), (16, 7, 5, 0, None),
            (12, 3, 11, 6, 2.0)]:
        s, kh, b = 150, 2, 4
        q = randn(b, q_len, kh * group, hd)
        k, v = randn(b, s, kh, hd), randn(b, s, kh, hd)
        lens = torch.tensor([0, 1, 77, s], dtype=torch.int32, device="cuda")
        case = f"f32 hd{hd} g{group} q_len{q_len} w{window} cap{softcap}"
        if q_len == 1:
            got = ops.decode_attention(q[:, 0], k, v, lens, window=window,
                                       softcap=softcap)
            qc, kc, vc, lc = q[:, 0].cpu(), k.cpu(), v.cpu(), lens.cpu()
            want = ops.decode_attention(qc, kc, vc, lc, window=window,
                                        softcap=softcap)
        else:
            got = ops.multi_decode_attention(q, k, v, lens, window=window,
                                             softcap=softcap)
            want = ops.multi_decode_attention(q.cpu(), k.cpu(), v.cpu(),
                                              lens.cpu(), window=window,
                                              softcap=softcap)
        check("decode_attention", got.cpu(), want, TOL_F32, case, errors)
    report.update(decode_mma_checks(torch, randn, timer, errors))

    # -- region score --------------------------------------------------------
    report["region_score"] = region_score_checks(torch, randn, timer, errors)

    report.update(paged_kernel_checks(torch, randn, timer, errors))
    report.update(prefill_kernel_checks(torch, randn, timer, errors))
    report.update(quant_kernel_checks(torch, randn, timer, errors))
    for name, rows in dense_kernel_checks(torch, randn, timer,
                                          errors).items():
        report[name].update(rows)
    report.update(scan_kernel_checks(torch, randn, timer, errors))
    report.update(bwd_kernel_checks(torch, randn, timer, errors))

    torch.cuda.synchronize()
    if errors:
        raise RuntimeError("kernel disagrees with its plain version:\n"
                           + "\n".join(errors))
    for name, shapes in report.items():
        for tag, m in shapes.items():
            if "ms" not in m:
                continue                    # held, not timed
            lib = ("none" if m["library_ms"] is None
                   else f"{m['library_ms']:.4f} ms")
            route = f" ({m['route']})" if "route" in m else ""
            log(f"  time {name + route:16s} {tag:4s} {m['shape']:40s} "
                f"kernel {m['ms']:.4f} ms  plain {m['plain_ms']:.4f} ms  "
                f"{m.get('library_is', 'library')} {lib}  "
                f"bound {m['bound_ms']:.5f} ms ({m['bound_by']})")
    return report


def decode_mma_sweep(torch, randn, errors):
    """The tensor-core decode route (bf16, hd 64/128) against the plain
    version through ``ops``: B 4 rows of cache_len 0, 1, 100 (a partial
    tile) and 300 (the whole cache), hd 64 and 128, groups 1-7, q_len 1-16
    (up to 70 rows: two row tiles), windows 0/37 and softcaps none/30 in
    turns.  The cache past each row's length is NaN, so a read past it
    would show; the row of length 0 must be zero.  A misaligned view must
    raise.  Returns the largest share of the bound any case used."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    bf16, nan = torch.bfloat16, float("nan")
    log("decode_attention vs plain (mma route)")
    opts = [(0, None), (37, None), (0, 30.0), (37, 30.0)]
    b, kh, s, lens = 4, 2, 300, [0, 1, 100, 300]
    shares = []
    for n, (hd, group, q_len) in enumerate([
            (128, 7, 1), (64, 1, 1), (128, 6, 3), (64, 7, 10), (128, 2, 4),
            (64, 5, 2), (128, 7, 9), (128, 3, 1), (64, 4, 16)]):
        window, softcap = opts[n % len(opts)]
        kw = {"window": window, "softcap": softcap}
        q = randn(b, q_len, kh * group, hd, dtype=bf16)
        k, v = (randn(b, s, kh, hd, dtype=bf16) for _ in range(2))
        lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
        past = torch.arange(s, device="cuda")[None, :] >= lens_t[:, None]
        kn, vn = k.clone(), v.clone()
        kn[past], vn[past] = nan, nan
        if q_len == 1:
            got = ops.decode_attention(q[:, 0], kn, vn, lens_t, **kw)[:, None]
        else:
            got = ops.multi_decode_attention(q, kn, vn, lens_t, **kw)
        shares.append(check_mma_decode(
            "decode_attention", got, q, k, v, lens_t, kw,
            f"bf16 hd{hd} g{group} q_len{q_len} w{window} cap{softcap}",
            errors)[1])
        if float(got[0].abs().max()) != 0.0:
            errors.append(f"decode_attention mma hd{hd} g{group}: "
                          f"cache_len 0 row not zero")
    log(f"  mma decode sweep: largest share of the bound {max(shares):.3f}")
    buf = randn(1, 2, 8, 136, dtype=bf16)
    try:
        decode_attention_cuda(buf[..., 1:129], buf[..., :128],
                              buf[..., :128], 3)
        errors.append("decode_attention: a misaligned view was not refused")
        log("  decode_attention misaligned q view: launched (FAIL)")
    except ValueError as e:
        log(f"  decode_attention misaligned q view: refused ({e}) ok")
    return max(shares)


# the region score's cases beyond the main path's: (B, R, Nv, Ne, D, dtype)
REGION_CASES = [
    (2, 100, 3, 2, 48, "f32"), (1, 100, 1, 1, 16, "f32"),
    (2, 64, 2, 5, 300, "f32"),
    (2, 100, 1, 1, 1536, "bf16"),          # the paper's N_r 100: 8 ∤ R
    (1, 1023, 1, 1, 1536, "bf16"),         # a partial last block
    (2, 100, 3, 5, 300, "bf16"),           # the scalar path (300 % 8)
    (2, 100, 3, 5, 301, "f32"),            # the scalar path (odd D)
    (1, 1024, 1, 1, 3584, "bf16"),         # the 7B width: two pieces a row
    (2, 37, 3, 5, 3584, "bf16"),           # six pieces over three rows
    (2, 100, 3, 5, 1536, "bf16"),          # Nv 3, Ne 5
    (1, 50, 2, 3, 2100, "f32"),            # three pieces a row, f32
    (1, 8, 2, 2, 9000, "bf16"),            # five pieces a row
    (70000, 1, 1, 1, 8, "f32"),            # past the old grid cap
]


def region_score_checks(torch, randn, timer, errors):
    """The region score against its plain version at ``REGION_CASES``, the
    offload path's (B, R, 1, D) view of (B, R, D) features, an unaligned
    base (the scalar path) and D at the shared-memory limit, then the main
    path's shape (B 1, R 1024, Nv 1, Ne 1, D 1536, bf16), timed beside an
    empty kernel on its grid (the launch floor).  Returns {case: numbers}."""
    import ctypes

    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.build import CudaKernel
    from repro_torch.kernels.region_score import (MAX_SMEM_FLOATS,
                                                  region_score_cuda)
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    log("region_score vs plain")
    out = {}

    def held(case, v, e, fn=ops.region_score):
        out[case] = {"max_abs_err": check(
            "region_score", fn(v, e), ref.region_score(v, e), TOL_REGION,
            case, errors)}

    for b, r, nv, ne, d, dt in REGION_CASES:
        held(f"{dt} B{b} R{r} Nv{nv} Ne{ne} D{d}",
             randn(b, r, nv, d, dtype=dts[dt]), randn(b, ne, d, dtype=dts[dt]))
    feats = randn(2, 1024, 1536, dtype=torch.bfloat16)
    held("bf16 (B2, R1024, 1, D1536) view of (B, R, D)", feats[:, :, None, :],
         randn(2, 1, 1536, dtype=torch.bfloat16), region_score_cuda)
    buf = randn(2, 100, 2, 1537, dtype=torch.bfloat16)
    held("bf16 unaligned base B2 R100 Nv2 Ne3 D1536", buf[..., 1:],
         randn(2, 3, 1536, dtype=torch.bfloat16), region_score_cuda)
    d = MAX_SMEM_FLOATS - 2
    held(f"f32 B1 R9 Nv1 Ne2 D{d} (D + Ne at the limit)",
         randn(1, 9, 1, d), randn(1, 2, d), region_score_cuda)

    vv = randn(1, 1024, 1, 1536, dtype=torch.bfloat16)
    ee = randn(1, 1, 1536, dtype=torch.bfloat16)
    held("bf16 B1 R1024 Nv1 Ne1 D1536", vv, ee)
    err = out["bf16 B1 R1024 Nv1 Ne1 D1536"]["max_abs_err"]
    # one pass: v·ē and v·v a row (4·D), ē once (3·D a text row)
    flops = 1024 * 4 * 1536 + 3 * 1536
    b_ms, b_by = bound_ms(nbytes(vv, ee) + 4 * 1024, flops, "bfloat16")
    empty = CudaKernel("region_score.cu", "region_score_empty",
                       [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    stream = torch.cuda.current_stream().cuda_stream
    m = {"max_abs_err": err,
         "ms": timer(lambda: region_score_cuda(vv, ee)),
         "plain_ms": timer(lambda: ref.region_score(vv, ee)),
         "library_ms": timer(lambda: torch.einsum(
             "brvd,bed->br", F.normalize(vv.float(), dim=-1),
             F.normalize(ee.float(), dim=-1))),
         "launch_floor_ms": timer(lambda: empty(1, 1024, stream)),
         "bound_ms": b_ms, "bound_by": b_by,
         "shape": "B1 R1024 Nv1 Ne1 D1536 bf16"}
    log(f"  region_score main: kernel {m['ms']:.5f} ms, an empty kernel on "
        f"its grid {m['launch_floor_ms']:.5f} ms, bound {b_ms:.5f} ms "
        f"({b_by})")
    out["main"] = m
    return out


def decode_mma_checks(torch, randn, timer, errors):
    """The dense decode kernels at the 2B/7B decode step: the tensor-core
    route held to its bound (and its sweep), the CUDA-core kernel at the
    same shape to its tolerance, then timed in turns with the library call
    (mma, library, CUDA cores, mma).  Returns the report's two rows."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import decode_attention as DA
    bf16 = torch.bfloat16
    sweep_share = decode_mma_sweep(torch, randn, errors)
    out = {"decode_attention_mma": {}, "decode_attention": {}}
    for tag, h, kh, s in (("2B", 12, 2, 1026), ("7B", 28, 4, 2049)):
        hd = 128
        q = randn(1, h, hd, dtype=bf16)
        k, v = randn(1, s, kh, hd, dtype=bf16), randn(1, s, kh, hd,
                                                        dtype=bf16)
        lens = torch.full((1,), s, dtype=torch.int32, device="cuda")
        case = f"bf16 {tag} H{h} KH{kh} S{s} hd{hd}"
        err, share = check_mma_decode(
            "decode_attention", ops.decode_attention(q, k, v, s)[:, None],
            q[:, None], k, v, lens, {}, case, errors)
        qg = q.reshape(1, kh, h // kh, hd)
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        err_cc = check("decode_attention",
                       DA.launch_cuda_cores(qg, kt, vt, lens).reshape(1, h,
                                                                      hd),
                       ref.decode_attention(q, k, v, s), TOL_BF16,
                       case + " on CUDA cores", errors)
        q4 = q.reshape(1, h, 1, hd)
        rows = timed_rows(
            timer, {"mma": (lambda: DA.launch_mma(qg, kt, vt, lens), err),
                    "cuda_cores": (lambda: DA.launch_cuda_cores(
                        qg, kt, vt, lens), err_cc)},
            lambda: ref.decode_attention(q, k, v, lens),
            lambda: F.scaled_dot_product_attention(q4, kt, vt,
                                                   enable_gqa=True),
            nbytes(q, k, v, q), 4.0 * hd * h * s,
            f"B1 H{h} KH{kh} S{s} cache_len{s} hd{hd} bf16")
        rows["mma"].update(tolerance_share=share,
                           sweep_tolerance_share=sweep_share)
        out["decode_attention_mma"][tag] = rows["mma"]
        out["decode_attention"][tag] = rows["cuda_cores"]
    return out


def paged_case(torch, randn, *, b, kh, group, hd, page, width, lens, q_len,
               dtype, shared_blocks=0, scenes=2, scene_of=None):
    """Pools, block table and queries for one paged-attention check.

    Page 0 is the trash page.  Row ``r``'s first ``shared_blocks`` table
    entries map the shared prefix pages of scene ``scene_of[r]`` (default
    ``r % scenes``; read-only, in several rows); its further blocks below
    its length are private; the
    entries past its length point at the trash page.  Returns (q, k_pool,
    v_pool, table, lens, trash_pools): the kernel gets pools whose trash
    page is NaN (so any read past a row's length shows), the plain version
    the same pools with a zero trash page."""
    n_shared = scenes * shared_blocks
    need = [-(-int(n) // page) for n in lens]
    n_priv = sum(max(n - shared_blocks, 0) for n in need)
    n_pages = 1 + n_shared + n_priv
    table = torch.zeros((b, width), dtype=torch.int32)
    nxt = 1 + n_shared
    for r, n in enumerate(need):
        sc = r % scenes if scene_of is None else scene_of[r]
        sh = 1 + sc * shared_blocks
        for j in range(min(n, width)):
            if j < shared_blocks:
                table[r, j] = sh + j
            else:
                table[r, j] = nxt
                nxt += 1
    k_pool = randn(n_pages, page, kh, hd, dtype=dtype)
    v_pool = randn(n_pages, page, kh, hd, dtype=dtype)
    k_pool[0] = 0
    v_pool[0] = 0
    k_nan, v_nan = k_pool.clone(), v_pool.clone()
    k_nan[0] = float("nan")
    v_nan[0] = float("nan")
    q = randn(b, q_len, kh * group, hd, dtype=dtype)
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, k_pool, v_pool, table.cuda(), lens_t, (k_nan, v_nan)


def paged_bytes_and_flops(torch, q, k_pool, table, lens, q_len,
                          scaled=False, window=0):
    """Bytes the function must move (each distinct (page, slot) a row needs
    read once for K and for V, with an 8-bit pool's (``scaled``) 4-byte
    scale per KV head, q, the table entries it reads, lengths, o written
    once) and its FLOPs (QK and PV over the keys each chunk token sees:
    max(cache_len - (q_len - 1) + t, 0) for token t, at most ``window``
    with one).  With a window a row needs only the keys from its first
    token's floor on."""
    b, _, h, hd = q.shape
    page, kh = k_pool.shape[1], k_pool.shape[2]
    s = table.shape[1] * page
    pos = torch.arange(s, device=table.device)
    lens = lens.long()
    valid = pos[None, :] < lens[:, None]
    if window > 0:
        valid &= pos[None, :] >= (lens - (q_len - 1) - window)[:, None]
    slot = table.long()[:, pos // page] * page + pos % page
    n_slots = int(torch.unique(slot[valid]).numel())
    n_entries = int((-(-lens // page)).sum())
    kv = 2 * n_slots * kh * (hd * k_pool.element_size() + 4 * scaled)
    io = 2 * q.numel() * q.element_size() + 4 * (n_entries + b)
    eff = (lens[:, None] - (q_len - 1)
           + torch.arange(q_len, device=lens.device)[None, :]).clamp(min=0)
    if window > 0:
        eff = eff.clamp(max=window)
    flops = 4.0 * hd * h * float(eff.sum())
    return kv + io, flops


def paged_kernel_checks(torch, randn, timer, errors):
    """The paged decode kernels against their plain version: an f32 sweep
    (the CUDA-core route; 70 rows take two row tiles), a bf16 sweep of the
    tensor-core route, then the slot path's shapes in bf16 on both routes,
    the 7B verifier at γ 9 (70 rows) on both, and the times of (a)-(c) in
    turns with the library call (mma, library, CUDA cores, mma).  Returns
    the report's two rows."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_decode_attention as PDA

    def both(q, k_pool, v_pool, table, lens, nan_pools, window=0,
             softcap=None):
        if q.shape[1] == 1:
            got = ops.paged_decode_attention(q[:, 0], *nan_pools, table,
                                             lens, window=window,
                                             softcap=softcap)[:, None]
            want = ref.paged_decode_attention(q[:, 0], k_pool, v_pool, table,
                                              lens, window=window,
                                              softcap=softcap)[:, None]
        else:
            got = ops.paged_multi_decode_attention(
                q, *nan_pools, table, lens, window=window, softcap=softcap)
            want = ref.paged_multi_decode_attention(
                q, k_pool, v_pool, table, lens, window=window,
                softcap=softcap)
        return got, want

    def rows_of(q, kh):             # (B, T, H, hd) → (B, KH, T·group, hd)
        b, t, h, hd = q.shape
        return q.reshape(b, t, kh, h // kh, hd).permute(0, 2, 1, 3, 4) \
            .reshape(b, kh, t * (h // kh), hd)

    def on_cuda_cores(q, kh, nan_pools, table, lens_t):
        b, t, h, hd = q.shape
        o = PDA.launch_cuda_cores(rows_of(q, kh), *(x.transpose(1, 2)
                                                 for x in nan_pools),
                                  table, lens_t, q_len=t)
        return o.reshape(b, kh, t, h // kh, hd).permute(0, 2, 1, 3, 4) \
            .reshape(b, t, h, hd)

    log("paged_decode_attention vs plain (CUDA-core route)")
    for page, hd, group, q_len, window, softcap in [
            (1, 16, 2, 1, 0, None), (4, 12, 3, 3, 0, None),
            (8, 16, 2, 5, 0, None), (16, 16, 3, 1, 0, 3.0),
            (8, 12, 1, 3, 7, None), (4, 16, 2, 5, 5, 2.5),
            (8, 128, 7, 9, 0, None), (16, 64, 6, 1, 0, None),
            (8, 16, 7, 10, 6, None)]:
        lens = [0, 1, 2, 37, 64, 150, 95, 3]
        width = -(-160 // page)
        args = paged_case(torch, randn, b=len(lens), kh=2, group=group,
                          hd=hd, page=page, width=width, lens=lens,
                          q_len=q_len, dtype=torch.float32,
                          shared_blocks=32 // page)
        got, want = both(*args, window=window, softcap=softcap)
        case = (f"f32 page{page} hd{hd} g{group} q_len{q_len} w{window} "
                f"cap{softcap}")
        check("paged_decode", got, want, TOL_F32, case, errors)
        if float(got[0].abs().max()) != 0.0:
            errors.append(f"paged_decode {case}: cache_len 0 row not zero")

    bf16 = torch.bfloat16
    log("paged_decode_attention vs plain (mma route)")
    shares = []
    for n, (page, hd, group, q_len) in enumerate([
            (8, 128, 7, 1), (1, 64, 2, 3), (64, 128, 6, 5), (8, 64, 7, 10),
            (16, 128, 1, 1), (4, 64, 4, 7), (64, 64, 3, 2), (8, 128, 5, 9)]):
        window, softcap = [(0, None), (40, None), (0, 30.0),
                           (40, 30.0)][n % 4]
        lens = [0, 1, 2, 37, 64, 150, 95, 3]
        width = -(-160 // page)
        q, k_pool, v_pool, table, lens_t, nan_pools = paged_case(
            torch, randn, b=len(lens), kh=2, group=group, hd=hd, page=page,
            width=width, lens=lens, q_len=q_len, dtype=bf16,
            shared_blocks=32 // page)
        kw = {"window": window, "softcap": softcap}
        got, _ = both(q, k_pool, v_pool, table, lens_t, nan_pools, **kw)
        shares.append(check_mma_decode(
            "paged_decode", got, q, ref.gather_pages(k_pool, table),
            ref.gather_pages(v_pool, table), lens_t, kw,
            f"bf16 page{page} hd{hd} g{group} q_len{q_len} w{window} "
            f"cap{softcap}", errors)[1])
        if float(got[0].abs().max()) != 0.0:
            errors.append(f"paged_decode mma page{page} hd{hd}: cache_len 0 "
                          f"row not zero")
    log(f"  mma paged sweep: largest share of the bound {max(shares):.3f}")

    out = {"paged_decode_attention_mma": {}, "paged_decode_attention": {}}
    for tag, kh, group, q_len, b in (("a 2B q1", 2, 6, 1, 8),
                                     ("b 7B q1", 4, 7, 1, 8),
                                     ("c 7B q5", 4, 7, 5, 4),
                                     ("c9 7B q10", 4, 7, 10, 4)):
        page, width, hd = 8, 257, 128
        lens = [1025 + (1024 * i) // (b - 1) for i in range(b)]
        q, k_pool, v_pool, table, lens_t, nan_pools = paged_case(
            torch, randn, b=b, kh=kh, group=group, hd=hd, page=page,
            width=width, lens=lens, q_len=q_len, dtype=bf16,
            shared_blocks=1024 // page)
        got, want = both(q, k_pool, v_pool, table, lens_t, nan_pools)
        case = f"bf16 {tag} B{b} KH{kh} g{group} page{page} P{width}"
        err, share = check_mma_decode(
            "paged_decode", got, q, ref.gather_pages(k_pool, table),
            ref.gather_pages(v_pool, table), lens_t, {}, case, errors)
        err_cc = check("paged_decode",
                       on_cuda_cores(q, kh, nan_pools, table, lens_t), want,
                       TOL_BF16, case + " on CUDA cores", errors)
        if tag.startswith("c9"):          # the γ 9 verifier: held, not timed
            for key, e in (("paged_decode_attention_mma", err),
                           ("paged_decode_attention", err_cc)):
                out[key][tag] = {"max_abs_err": e}
            continue
        n_bytes, flops = paged_bytes_and_flops(torch, q, k_pool, table,
                                               lens_t, q_len)
        qr = rows_of(q, kh)
        kt, vt = k_pool.transpose(1, 2), v_pool.transpose(1, 2)
        # the yardstick: gather the pages, then one SDPA call (two calls)
        mask = dense_mask(torch, lens_t, q_len, width * page)
        qh = q.transpose(1, 2)

        def library():
            kg = ref.gather_pages(k_pool, table).transpose(1, 2)
            vg = ref.gather_pages(v_pool, table).transpose(1, 2)
            return F.scaled_dot_product_attention(qh, kg, vg, attn_mask=mask,
                                                  enable_gqa=True)

        lib_err = float((library().transpose(1, 2).float()
                         - want.float()).abs().max())
        if q_len == 1:
            def plain():
                return ref.paged_decode_attention(q[:, 0], k_pool, v_pool,
                                                  table, lens_t)
        else:
            def plain():
                return ref.paged_multi_decode_attention(q, k_pool, v_pool,
                                                        table, lens_t)

        rows = timed_rows(
            timer, {"mma": (lambda: PDA.launch_mma(qr, kt, vt, table, lens_t,
                                                   q_len=q_len), err),
                    "cuda_cores": (lambda: PDA.launch_cuda_cores(
                        qr, kt, vt, table, lens_t, q_len=q_len), err_cc)},
            plain, library, n_bytes, flops,
            f"B{b} KH{kh} g{group} q_len{q_len} hd{hd} page{page} "
            f"P{width} cache_len {lens[0]}..{lens[-1]} bf16",
            library_is="gather_pages + scaled_dot_product_attention (two "
                       "calls)", library_max_abs_err=lib_err)
        rows["mma"].update(tolerance_share=share,
                           sweep_tolerance_share=max(shares))
        out["paged_decode_attention_mma"][tag] = rows["mma"]
        out["paged_decode_attention"][tag] = rows["cuda_cores"]
    return out


def same_bits(a, b) -> bool:
    """Byte-equal, NaN trash pages included."""
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def flat_step(torch, randn, runs, *, tb, n_slots, kh, group, hd, page,
              width, shared, scene_of):
    """One fused step at the engine's flat shape, bf16: ``runs`` are
    (slot, first position, tokens) in flat order, the rest of the ``tb``
    rows padding (the last slot's table row at position 0, as the engine
    clamps them).  Slot ``s`` maps scene ``scene_of[s]``'s ``shared``
    prefix pages, then private pages, up to the page of its last position
    in the step; its entries past that point at page 0, the trash page, as
    ``paged_case``'s do.  Returns (q (tb, 1, H, hd), k_pool, v_pool, table,
    lens, (k, v) with a NaN trash page, the tile plan on the card, the
    scheduled rows)."""
    import numpy as np
    from repro_torch.kernels import paged_prefill_attention as PPA
    srow = np.full((tb,), n_slots, np.int32)
    pos = np.zeros((tb,), np.int32)
    j = 0
    for slot, p0, n in runs:
        srow[j:j + n], pos[j:j + n] = slot, p0 + np.arange(n)
        j += n
    n_scenes = max(scene_of) + 1
    tables = np.zeros((n_slots, width), np.int32)
    nxt = 1 + n_scenes * shared
    for sl in range(n_slots):
        tables[sl, :shared] = 1 + scene_of[sl] * shared + np.arange(shared)
        tables[sl, shared:] = nxt + np.arange(width - shared)
        nxt += width - shared
    rows_slot = np.minimum(srow, n_slots - 1)
    need = np.zeros((n_slots,), np.int64)       # entries below a length
    np.maximum.at(need, rows_slot, -(-(pos + 1) // page))
    tables[np.arange(width)[None, :] >= need[:, None]] = 0
    k_pool = randn(nxt, page, kh, hd, dtype=torch.bfloat16)
    v_pool = randn(nxt, page, kh, hd, dtype=torch.bfloat16)
    k_pool[0], v_pool[0] = 0, 0
    k_nan, v_nan = k_pool.clone(), v_pool.clone()
    k_nan[0], v_nan[0] = float("nan"), float("nan")
    q = randn(tb, 1, kh * group, hd, dtype=torch.bfloat16)
    table = torch.from_numpy(tables[rows_slot]).cuda()
    lens = torch.from_numpy(pos + 1).cuda()
    plan = PPA.tile_plan(srow, pos, n_slots, group,
                         PPA.plan_tiles(tb, n_slots, group))
    return (q, k_pool, v_pool, table, lens, (k_nan, v_nan),
            torch.from_numpy(plan).cuda(), torch.from_numpy(srow < n_slots)
            .cuda())


def plan_rows(torch, plan, b):
    """The rows a tile plan covers, as a (b,) bool mask on the card."""
    rows = torch.zeros((b,), dtype=torch.bool, device=plan.device)
    for j0, n in plan.T.tolist():
        rows[j0:j0 + n] = True
    return rows


def check_mma_rows(name, got, q, k_pool, v_pool, table, lens, rows, kw,
                   case, errors):
    """``check_mma_decode`` on the rows ``rows`` of a paged call."""
    from repro_torch.kernels import ref
    return check_mma_decode(name, got[rows], q[rows],
                            ref.gather_pages(k_pool, table[rows]),
                            ref.gather_pages(v_pool, table[rows]),
                            lens[rows], kw, case, errors)


def prefill_mma_sweep(torch, randn, errors):
    """The prefix-append kernel's tensor-core route (bf16, hd 64/128)
    against the plain version through ``ops``: page sizes 1-16, chunks of
    1-256 tokens, groups 1/6/7, windows and softcaps; rows of length 0,
    below the chunk, the chunk alone and mid-prefill over shared prefix
    pages; NaN trash page; the pools unchanged.  Then mixed flat steps
    (decode rows, a prompt row, a fresh stream and one mid-prefill, then
    padding) with and without the tile plan, and an idle step's plan.  A
    misaligned view must raise.  Returns the largest share of the bound
    any case used."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_prefill_attention as PPA
    bf16 = torch.bfloat16
    log("paged_prefill_attention vs plain (mma route)")
    shares = []
    for n, (page, hd, group, q_len) in enumerate([
            (1, 64, 1, 1), (2, 128, 6, 7), (4, 64, 7, 16), (8, 128, 6, 64),
            (16, 128, 7, 100), (8, 64, 1, 256), (16, 128, 6, 256),
            (4, 128, 7, 33)]):
        window, softcap = [(0, None), (40, None), (0, 30.0),
                           (100, 30.0)][n % 4]
        kw = {"window": window, "softcap": softcap}
        lens = [0, max(q_len - 1, 1), q_len, q_len + 37, q_len + 150, 3]
        q, k_pool, v_pool, table, lens_t, (k_nan, v_nan) = paged_case(
            torch, randn, b=len(lens), kh=2, group=group, hd=hd, page=page,
            width=-(-(q_len + 160) // page), lens=lens, q_len=q_len,
            dtype=bf16, shared_blocks=32 // page)
        k0, v0 = k_nan.clone(), v_nan.clone()
        got = ops.paged_prefill_attention(q, k_nan, v_nan, table, lens_t,
                                          **kw)
        case = (f"bf16 page{page} hd{hd} g{group} q_len{q_len} w{window} "
                f"cap{softcap}")
        shares.append(check_mma_decode(
            "paged_prefill", got, q, ref.gather_pages(k_pool, table),
            ref.gather_pages(v_pool, table), lens_t, kw, case, errors)[1])
        if float(got[0].abs().max()) != 0.0:
            errors.append(f"paged_prefill mma {case}: cache_len 0 row not "
                          f"zero")
        if not (same_bits(k_nan, k0) and same_bits(v_nan, v0)):
            errors.append(f"paged_prefill mma {case}: the pools changed")
    runs = [(0, 300, 1), (1, 150, 1), (2, 64, 1), (3, 0, 23), (4, 40, 50)]
    for hd, group, window, softcap in [(128, 6, 0, None), (64, 7, 40, 30.0),
                                       (128, 1, 0, None)]:
        kw = {"window": window, "softcap": softcap}
        q, k_pool, v_pool, table, lens, nan_pools, plan, rows = flat_step(
            torch, randn, runs, tb=90, n_slots=5, kh=2, group=group, hd=hd,
            page=8, width=48, shared=8, scene_of=[0, 0, 1, 2, 1])
        case = f"bf16 mixed flat step hd{hd} g{group} w{window} cap{softcap}"
        shares.append(check_mma_rows(
            "paged_prefill", ops.paged_prefill_attention(
                q, *nan_pools, table, lens, plan=plan, **kw),
            q, k_pool, v_pool, table, lens, rows, kw, case + " plan",
            errors)[1])
        shares.append(check_mma_rows(
            "paged_prefill", ops.paged_prefill_attention(
                q, *nan_pools, table, lens, **kw),
            q, k_pool, v_pool, table, lens, torch.ones_like(rows), kw, case,
            errors)[1])
        PPA.launch_mma(q.reshape(90, 2, group, hd), *(x.transpose(1, 2)
                       for x in nan_pools), table, lens,
                       plan=torch.zeros_like(plan), **kw)
        torch.cuda.synchronize()          # an idle plan: every entry exits
    log(f"  mma prefill sweep: largest share of the bound {max(shares):.3f}")
    buf = randn(1, 2, 8, 136, dtype=bf16)
    pool = randn(4, 2, 8, 136, dtype=bf16)
    table = torch.zeros((1, 3), dtype=torch.int32, device="cuda")
    try:
        PPA.paged_prefill_attention_cuda(buf[..., 1:129], pool[..., :128],
                                         pool[..., :128], table, 3)
        errors.append("paged_prefill: a misaligned view was not refused")
        log("  paged_prefill misaligned q view: launched (FAIL)")
    except ValueError as e:
        log(f"  paged_prefill misaligned q view: refused ({e}) ok")
    return max(shares)


def prefill_kernel_checks(torch, randn, timer, errors):
    """The paged prefix-append kernel against its plain version: an f32
    sweep of the CUDA-core route (page sizes 1-16, chunks of 1-64 tokens
    with a q_blk that divides the chunk and one that does not, window,
    softcap, groups 1/6/7; rows of length 0, below the chunk, the chunk
    alone and mid-prefill; shared prefix pages in several rows; NaN trash
    page; the pools unchanged), the tensor-core route's bf16 sweep, then
    the chunked path's shapes in bf16 on both routes with their times:
    (d) the 2B engine's flat fused step (B 264: 8 decode rows as in (a),
    then one scene's last 256-token chunk as 256 q_len-1 rows sharing one
    table row at cache_len 769..1024), on the tensor cores with the tile
    plan the engine builds (34 row tiles) and without it, and (e) that
    chunk as one row (q_len 256, cache_len 1024).  Times in turns: mma,
    library, CUDA cores, mma.  Returns the report's two rows."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_prefill_attention as PPA

    log("paged_prefill_attention vs plain (CUDA-core route)")
    for page, hd, group, q_len, q_blk, window, softcap in [
            (1, 16, 1, 4, 2, 0, None), (2, 16, 6, 6, 4, 24, None),
            (8, 64, 7, 16, 8, 0, 3.0), (16, 12, 6, 64, 10, 0, None),
            (8, 128, 6, 1, None, 0, None), (16, 32, 1, 64, 64, 24, None),
            (2, 128, 7, 64, None, 0, 2.5), (8, 16, 6, 16, 3, 24, None)]:
        lens = [0, max(q_len - 1, 1), q_len, q_len + 37, q_len + 150, 3]
        width = -(-(q_len + 160) // page)
        q, k_pool, v_pool, table, lens_t, (k_nan, v_nan) = paged_case(
            torch, randn, b=len(lens), kh=2, group=group, hd=hd, page=page,
            width=width, lens=lens, q_len=q_len, dtype=torch.float32,
            shared_blocks=32 // page)
        k0, v0 = k_nan.clone(), v_nan.clone()
        got = ops.paged_prefill_attention(q, k_nan, v_nan, table, lens_t,
                                          window=window, softcap=softcap,
                                          q_blk=q_blk)
        want = ref.paged_prefill_attention(q, k_pool, v_pool, table, lens_t,
                                           window=window, softcap=softcap)
        case = (f"f32 page{page} hd{hd} g{group} q_len{q_len} q_blk{q_blk} "
                f"w{window} cap{softcap}")
        check("paged_prefill", got, want, TOL_F32, case, errors)
        if float(got[0].abs().max()) != 0.0:
            errors.append(f"paged_prefill {case}: cache_len 0 row not zero")
        if not (same_bits(k_nan, k0) and same_bits(v_nan, v0)):
            errors.append(f"paged_prefill {case}: the pools changed")
    sweep_share = prefill_mma_sweep(torch, randn, errors)

    out = {"paged_prefill_attention_mma": {}, "paged_prefill_attention": {}}
    bf16 = torch.bfloat16
    page, width, hd, kh, group = 8, 257, 128, 2, 6
    # 8 decode rows over two scenes' shared prefixes (cache_len 1025..2049),
    # then the streaming scene's last chunk on slot 8 (positions 768..1023)
    decode = [(i, 1024 + (1024 * i) // 7, 1) for i in range(8)]
    q, k_pool, v_pool, table, lens, nan_pools, plan, _ = flat_step(
        torch, randn, decode + [(8, 768, 256)], tb=264, n_slots=9, kh=kh,
        group=group, hd=hd, page=page, width=width, shared=1024 // page,
        scene_of=[0, 1] * 4 + [2])
    shapes = {"d 2B flat": (q, table, lens, 1, plan),
              "e 2B chunk": (q[8:].reshape(1, 256, kh * group, hd),
                             table[8:9].contiguous(), lens[-1:], 256, None)}
    kt, vt = (x.transpose(1, 2) for x in nan_pools)
    for tag, (q, table, lens_t, q_len, plan) in shapes.items():
        b = q.shape[0]
        case = (f"bf16 {tag} B{b} q_len{q_len} KH{kh} g{group} page{page} "
                f"P{width}")
        kg, vg = (ref.gather_pages(p, table) for p in (k_pool, v_pool))
        err, share = check_mma_decode(
            "paged_prefill", ops.paged_prefill_attention(
                q, *nan_pools, table, lens_t, plan=plan),
            q, kg, vg, lens_t, {}, case + (" plan" if plan is not None
                                           else ""), errors)
        want = ref.paged_prefill_attention(q, k_pool, v_pool, table, lens_t)
        qr = q.reshape(b, q_len, kh, group, hd).permute(0, 2, 1, 3, 4) \
            .reshape(b, kh, q_len * group, hd)
        err_cc = check("paged_prefill", ops._rows_to_chunk(
            PPA.launch_cuda_cores(qr, kt, vt, table, lens_t, q_len=q_len),
            q_len, kh * group), want, TOL_BF16, case + " on CUDA cores",
            errors)
        n_bytes, flops = paged_bytes_and_flops(torch, q, k_pool, table,
                                               lens_t, q_len)
        mask = dense_mask(torch, lens_t, q_len, width * page)
        qh = q.transpose(1, 2)

        def library():
            kg = ref.gather_pages(k_pool, table).transpose(1, 2)
            vg = ref.gather_pages(v_pool, table).transpose(1, 2)
            return F.scaled_dot_product_attention(qh, kg, vg, attn_mask=mask,
                                                  enable_gqa=True)

        def mma(plan=plan):
            return PPA.launch_mma(qr, kt, vt, table, lens_t, q_len=q_len,
                                  plan=plan)

        def cuda_cores():
            return PPA.launch_cuda_cores(qr, kt, vt, table, lens_t,
                                         q_len=q_len)

        lib_err = float((library().transpose(1, 2).float()
                         - want.float()).abs().max())
        rows = timed_rows(
            timer, {"mma": (mma, err), "cuda_cores": (cuda_cores, err_cc)},
            lambda: ref.paged_prefill_attention(q, k_pool, v_pool, table,
                                                lens_t),
            library, n_bytes, flops,
            f"B{b} KH{kh} g{group} q_len{q_len} hd{hd} page{page} "
            f"P{width} cache_len {int(lens_t.min())}..{int(lens_t.max())} "
            f"bf16", library_is="gather_pages + "
            "scaled_dot_product_attention (two calls)",
            library_max_abs_err=lib_err)
        row = rows["mma"]
        row.update(tolerance_share=share, sweep_tolerance_share=sweep_share)
        # the key splits the kernel's plan chose (clusters of that size)
        tile = PPA.tokens_per_tile(group) * group
        clusters = kh * (plan.shape[1] if plan is not None
                         else b * -(-q_len * group // tile))
        row["splits"] = DA.card_cluster_plan(clusters, width * page, 0,
                                             DA.MMA_PREFILL, hd, tile)[0]
        # what each route's wrapper costs the host a call (no L2 flush),
        # and the share of it the wrapper's Python takes (its C entry a
        # no-op)
        row["host_us_per_call"] = {
            "mma": host_us(torch, mma),
            "cuda_cores": host_us(torch, cuda_cores),
            "mma_python": wrapper_us(torch, PPA.MMA_KERNEL, mma),
            "cuda_cores_python": wrapper_us(torch, PPA.KERNEL, cuda_cores)}
        if plan is not None:
            # the same call without the plan: a row tile per batch row
            row["no_plan_ms"] = timer(lambda: mma(None))
            row["no_plan_max_abs_err"], row["no_plan_tolerance_share"] = \
                check_mma_decode("paged_prefill", ops.paged_prefill_attention(
                    q, *nan_pools, table, lens_t), q, kg, vg, lens_t, {},
                    case, errors)
            row["plan_tiles"] = int((plan[1] > 0).sum())
        out["paged_prefill_attention_mma"][tag] = row
        out["paged_prefill_attention"][tag] = rows["cuda_cores"]
    # what the split plan reads: clusters of each size the card holds at
    # once, for each mode's instance at the path's row tiles (a decode
    # step's group rows, prefix-append's 60)
    tile = PPA.tokens_per_tile(group) * group
    occupancy = {name: {n: DA.max_clusters(0, mode, hd, rows_, n)
                        for n in range(1, 17)}
                 for name, mode, rows_ in (("dense", DA.MMA_DENSE, group),
                                           ("paged", DA.MMA_PAGED, group),
                                           ("prefix-append", DA.MMA_PREFILL,
                                            tile))}
    rows = out["paged_prefill_attention_mma"]
    log(f"  mma: clusters of 1..16 blocks the card holds at once at hd "
        f"{hd} {occupancy}; prefix-append splits (d) "
        f"{rows['d 2B flat']['splits']}, (e) {rows['e 2B chunk']['splits']}")
    rows["d 2B flat"]["max_clusters_by_size"] = occupancy
    return out


def as_bits(t):
    """A 1-byte leaf as uint8 (the same bits; float8 is not indexed or
    compared on every device), any other leaf as it is."""
    import torch
    return t.view(torch.uint8) if t.element_size() == 1 else t


def quant_pools(torch, k_pool, v_pool, kind):
    """fp pools (trash page 0 zero) → (the quantized leaves, a copy whose
    trash page has NaN scales and, in fp8, NaN bytes 0x7F): the kernel
    reads the second, the plain version the first, so a read of the trash
    page shows (an int8 page cannot hold NaN; its scales can)."""
    from repro_torch.kernels import kv_quant
    pools = kv_quant.quantize_pool(k_pool.float(), v_pool.float(), kind)
    nan = {k: v.clone() for k, v in pools.items()}
    nan["k_scale"][0] = float("nan")
    nan["v_scale"][0] = float("nan")
    if kind == "fp8":
        as_bits(nan["k"])[0] = 0x7F
        as_bits(nan["v"])[0] = 0x7F
    return pools, nan


def scales_of(pools):
    return {"k_scale": pools["k_scale"], "v_scale": pools["v_scale"]}


def dequantized(pools, table):
    """An 8-bit pool pair dequantized and gathered: the dense (B, S, KH,
    hd) K and V the plain version attends to."""
    from repro_torch.kernels import ref
    return tuple(ref.gather_pages(ref.dequantize_pool(pools[n],
                                                      pools[n + "_scale"]),
                                  table) for n in ("k", "v"))


QUANT_POOLS = ("int8", "fp8")


def quant_kernel_checks(torch, randn, timer, errors):
    """The three paged kernels on int8 and fp8 pools, reading the 8-bit
    pages and their per-(page, slot, head) scales themselves, against the
    plain version on the dequantized pools: small sweeps of each route
    (CUDA cores in f32 over page sizes 1-16, hd 12-128, q_len up to 10,
    windows and softcaps, chunks with q_blk; the tensor cores in bf16 at
    hd 64/128 over pages 1-64, q_len up to 10, chunks up to 256 and a mixed
    flat step with and without its tile plan), then (a)-(e) on both routes
    with their times in turns (mma, library, CUDA cores, mma), the library
    call being gather_pages + dequantize + scaled_dot_product_attention.
    Every kernel reads pools whose trash page has NaN scales (and NaN
    bytes in fp8).  Returns the report's rows, named "<kernel>[int8]" and
    "<kernel>[fp8]"."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_decode_attention as PDA
    from repro_torch.kernels import paged_prefill_attention as PPA
    bf16 = torch.bfloat16
    out = {f"{n}[{kind}]": {} for kind in QUANT_POOLS
           for n in ("paged_decode_attention_mma", "paged_decode_attention",
                     "paged_prefill_attention_mma",
                     "paged_prefill_attention")}
    sweep = {}

    def paged(q, nan, table, lens, op, **kw):
        fn = {"decode": ops.paged_multi_decode_attention,
              "prefill": ops.paged_prefill_attention}[op]
        return fn(q, nan["k"], nan["v"], table, lens, **scales_of(nan), **kw)

    for kind in QUANT_POOLS:
        shares = []
        log(f"paged kernels on {kind} pools vs plain (CUDA-core route, f32)")
        for op, page, hd, group, q_len, window, softcap, q_blk in [
                ("decode", 1, 16, 2, 1, 0, None, None),
                ("decode", 8, 12, 3, 3, 0, 3.0, None),
                ("decode", 16, 128, 7, 10, 7, None, None),
                ("decode", 4, 32, 6, 5, 0, None, None),
                ("prefill", 2, 16, 6, 6, 24, None, 4),
                ("prefill", 8, 128, 6, 1, 0, None, None),
                ("prefill", 16, 32, 1, 64, 24, None, 64),
                ("prefill", 8, 64, 7, 16, 0, 2.5, 3)]:
            lens = [0, max(q_len - 1, 1), q_len, q_len + 37, q_len + 150, 3]
            q, k_pool, v_pool, table, lens_t, _ = paged_case(
                torch, randn, b=len(lens), kh=2, group=group, hd=hd,
                page=page, width=-(-(q_len + 160) // page), lens=lens,
                q_len=q_len, dtype=torch.float32, shared_blocks=32 // page)
            pools, nan = quant_pools(torch, k_pool, v_pool, kind)
            before = {k: as_bits(v).clone() for k, v in nan.items()}
            kw = {"window": window, "softcap": softcap}
            got = paged(q, nan, table, lens_t, op,
                        **(kw if op == "decode" else dict(kw, q_blk=q_blk)))
            want = ref.paged_multi_decode_attention(
                q, pools["k"], pools["v"], table, lens_t, **kw,
                **scales_of(pools))
            case = (f"{kind} f32 {op} page{page} hd{hd} g{group} "
                    f"q_len{q_len} w{window} cap{softcap}")
            check(f"paged_{op}", got, want, TOL_F32, case, errors)
            if float(got[0].abs().max()) != 0.0:
                errors.append(f"paged_{op} {case}: cache_len 0 row not zero")
            if not all(same_bits(as_bits(nan[k]).float(), v.float())
                       for k, v in before.items()):
                errors.append(f"paged_{op} {case}: the pools changed")
        log(f"paged kernels on {kind} pools vs plain (mma route, bf16)")
        for op, page, hd, group, q_len, window, softcap in [
                ("decode", 8, 128, 7, 1, 0, None),
                ("decode", 1, 64, 2, 3, 40, None),
                ("decode", 64, 128, 6, 5, 0, 30.0),
                ("decode", 8, 64, 7, 10, 40, 30.0),
                ("prefill", 2, 128, 6, 7, 0, None),
                ("prefill", 8, 64, 7, 16, 40, None),
                ("prefill", 16, 128, 6, 256, 0, 30.0)]:
            lens = [0, max(q_len - 1, 1), q_len, q_len + 37, q_len + 150, 3]
            q, k_pool, v_pool, table, lens_t, _ = paged_case(
                torch, randn, b=len(lens), kh=2, group=group, hd=hd,
                page=page, width=-(-(q_len + 160) // page), lens=lens,
                q_len=q_len, dtype=bf16, shared_blocks=32 // page)
            pools, nan = quant_pools(torch, k_pool, v_pool, kind)
            kw = {"window": window, "softcap": softcap}
            got = paged(q, nan, table, lens_t, op, **kw)
            case = (f"{kind} bf16 {op} page{page} hd{hd} g{group} "
                    f"q_len{q_len} w{window} cap{softcap}")
            shares.append(check_mma_decode(f"paged_{op}", got, q,
                                           *dequantized(pools, table),
                                           lens_t, kw, case, errors)[1])
            if float(got[0].abs().max()) != 0.0:
                errors.append(f"paged_{op} {case}: cache_len 0 row not zero")
        runs = [(0, 300, 1), (1, 150, 1), (2, 64, 1), (3, 0, 23),
                (4, 40, 50)]
        q, k_pool, v_pool, table, lens, _, plan, rows = flat_step(
            torch, randn, runs, tb=90, n_slots=5, kh=2, group=6, hd=128,
            page=8, width=48, shared=8, scene_of=[0, 0, 1, 2, 1])
        pools, nan = quant_pools(torch, k_pool, v_pool, kind)
        kd, vd = (ref.dequantize_pool(pools[n], pools[n + "_scale"])
                  for n in ("k", "v"))
        for tag, p, r in (("plan", plan, rows),
                          ("no plan", None, torch.ones_like(rows))):
            shares.append(check_mma_rows(
                "paged_prefill", paged(q, nan, table, lens, "prefill",
                                       plan=p),
                q, kd, vd, table, lens, r, {},
                f"{kind} bf16 mixed flat step, {tag}", errors)[1])
        sweep[kind] = max(shares)
        log(f"  mma sweep on {kind} pools: largest share of the bound "
            f"{max(shares):.3f}")

    # (a)-(c): the slot path's decode and verify shapes; (d), (e): the
    # chunked path's, as the fp pools' rows in paged_kernel_checks and
    # prefill_kernel_checks
    page, width, hd = 8, 257, 128
    cases = {}
    for tag, kh, group, q_len, b in (("a 2B q1", 2, 6, 1, 8),
                                     ("b 7B q1", 4, 7, 1, 8),
                                     ("c 7B q5", 4, 7, 5, 4)):
        lens = [1025 + (1024 * i) // (b - 1) for i in range(b)]
        q, k_pool, v_pool, table, lens_t, _ = paged_case(
            torch, randn, b=b, kh=kh, group=group, hd=hd, page=page,
            width=width, lens=lens, q_len=q_len, dtype=bf16,
            shared_blocks=1024 // page)
        cases[tag] = ("decode", q, k_pool, v_pool, table, lens_t, q_len,
                      None)
    decode = [(i, 1024 + (1024 * i) // 7, 1) for i in range(8)]
    q, k_pool, v_pool, table, lens, _, plan, _ = flat_step(
        torch, randn, decode + [(8, 768, 256)], tb=264, n_slots=9, kh=2,
        group=6, hd=hd, page=page, width=width, shared=1024 // page,
        scene_of=[0, 1] * 4 + [2])
    cases["d 2B flat"] = ("prefill", q, k_pool, v_pool, table, lens, 1,
                          plan)
    cases["e 2B chunk"] = ("prefill", q[8:].reshape(1, 256, 12, hd), k_pool,
                           v_pool, table[8:9].contiguous(), lens[-1:], 256,
                           None)
    for tag, (op, q, k_pool, v_pool, table, lens_t, q_len,
              plan) in cases.items():
        b, _, h, _ = q.shape
        kh = k_pool.shape[2]
        group = h // kh
        name = ("paged_decode_attention" if op == "decode"
                else "paged_prefill_attention")
        W = PDA if op == "decode" else PPA
        qr = q.reshape(b, q_len, kh, group, hd).permute(0, 2, 1, 3, 4) \
            .reshape(b, kh, q_len * group, hd)
        mask = dense_mask(torch, lens_t, q_len, width * page)
        qh = q.transpose(1, 2)
        for kind in QUANT_POOLS:
            pools, nan = quant_pools(torch, k_pool, v_pool, kind)
            kt, vt = nan["k"].transpose(1, 2), nan["v"].transpose(1, 2)
            sc = {"k_scale": nan["k_scale"].transpose(1, 2),
                  "v_scale": nan["v_scale"].transpose(1, 2)}
            case = (f"{kind} {tag} B{b} KH{kh} g{group} q_len{q_len} "
                    f"page{page} P{width}")
            extra = {} if plan is None else {"plan": plan}
            got = paged(q, nan, table, lens_t, op, **extra)
            kg, vg = dequantized(pools, table)
            err, share = check_mma_decode(
                f"paged_{op}", got, q, kg, vg, lens_t, {},
                case + (" plan" if plan is not None else ""), errors)
            want = ref.paged_multi_decode_attention(
                q, pools["k"], pools["v"], table, lens_t, **scales_of(pools))

            def cuda_cores():
                return W.launch_cuda_cores(qr, kt, vt, table, lens_t,
                                           q_len=q_len, **sc)

            err_cc = check(f"paged_{op}", ops._rows_to_chunk(
                cuda_cores(), q_len, h), want, TOL_BF16,
                case + " on CUDA cores", errors)
            n_bytes, flops = paged_bytes_and_flops(
                torch, q, pools["k"], table, lens_t, q_len, scaled=True)

            def library():
                kg = ref.gather_pages(as_bits(pools["k"]), table).view(
                    pools["k"].dtype)
                vg = ref.gather_pages(as_bits(pools["v"]), table).view(
                    pools["v"].dtype)
                ksg = ref.gather_pages(pools["k_scale"], table)
                vsg = ref.gather_pages(pools["v_scale"], table)
                kd = (kg.to(bf16) * ksg[..., None].to(bf16)).transpose(1, 2)
                vd = (vg.to(bf16) * vsg[..., None].to(bf16)).transpose(1, 2)
                return F.scaled_dot_product_attention(
                    qh, kd, vd, attn_mask=mask, enable_gqa=True)

            def plain():
                return ref.paged_multi_decode_attention(
                    q, pools["k"], pools["v"], table, lens_t,
                    **scales_of(pools))

            def mma():
                return W.launch_mma(qr, kt, vt, table, lens_t, q_len=q_len,
                                    **sc, **extra)

            lib_err = float((library().transpose(1, 2).float()
                             - want.float()).abs().max())
            rows = timed_rows(
                timer, {"mma": (mma, err), "cuda_cores": (cuda_cores,
                                                          err_cc)},
                plain, library, n_bytes, flops,
                f"B{b} KH{kh} g{group} q_len{q_len} hd{hd} page{page} "
                f"P{width} cache_len {int(lens_t.min())}.."
                f"{int(lens_t.max())} bf16 q, {kind} pool",
                library_is="gather_pages + dequantize + "
                           "scaled_dot_product_attention",
                library_max_abs_err=lib_err, pool=kind)
            rows["mma"].update(tolerance_share=share,
                               sweep_tolerance_share=sweep[kind])
            out[f"{name}_mma[{kind}]"][tag] = rows["mma"]
            out[f"{name}[{kind}]"][tag] = rows["cuda_cores"]
    return out


# ---------------------------------------------------------------------------
# phase 2: the dense attention configs' shapes (head dim 256, new groups)
# ---------------------------------------------------------------------------

#: gemma3-1b's local-layer window, which bites on its 1024-region prefix
G3_WINDOW = 512
#: gemma2-27b's local layers: window 4096 and attention softcap 50, held
#: at a length past the window (the serving path never reaches it)
G2_WINDOW, G2_SOFTCAP, G2_SKV = 4096, 50.0, 6000


def hd256_sweep(torch, randn, errors):
    """Rows 1, 2 and 4-6 at head dim 256 (the CUDA-core routes; bf16 takes
    them by its shape) against their plain versions, f32 at ``TOL_F32``
    and bf16 at ``TOL_BF16``: groups 1 and 4, windows 0 and 512 (lengths
    past 512, so the window bites), softcaps none and 30, ragged lengths
    with 0.  Flash at Sq = Skv and Sq < Skv; dense decode at q_len 1 and
    3; paged decode over pages 1-16 and q_len 1-10 and prefix-append over
    chunks of 1-64 tokens (q_blk dividing the chunk or not), both over
    shared prefix pages with a NaN trash page, on fp pools and on int8 and
    fp8 pools (held against the plain version on the dequantized pools,
    whose trash page has NaN scales).  Every launch is on the CUDA-core
    route (counted by the caller)."""
    from repro_torch.kernels import ops, ref
    f32, bf16, hd = torch.float32, torch.bfloat16, 256
    opts = [(0, None), (G3_WINDOW, None), (0, 30.0), (G3_WINDOW, 30.0)]
    log("hd 256 vs plain (CUDA-core routes)")
    for j, dt in enumerate((f32, bf16)):
        tol, tag = (TOL_F32, "f32") if dt == f32 else (TOL_BF16, "bf16")
        for i, (group, kh, sq, skv) in enumerate(
                ((1, 2, 65, 65), (4, 1, 600, 600), (4, 2, 33, 700),
                 (1, 1, 1, 530))):
            window, softcap = opts[(i + j) % 4]
            kw = {"window": window, "softcap": softcap}
            q = randn(2, sq, kh * group, hd, dtype=dt)
            k, v = (randn(2, skv, kh, hd, dtype=dt) for _ in range(2))
            check("flash_attention", ops.flash_attention(q, k, v, **kw),
                  ref.flash_attention(q, k, v, **kw), tol,
                  f"{tag} hd256 g{group} Sq{sq} Skv{skv} w{window} "
                  f"cap{softcap}", errors)
        s = 700
        lens = torch.tensor([0, 1, 600, s], dtype=torch.int32, device="cuda")
        for i, (group, kh, q_len) in enumerate(((1, 2, 1), (4, 1, 1),
                                                (4, 1, 3), (1, 2, 3))):
            window, softcap = opts[(i + j + 1) % 4]
            kw = {"window": window, "softcap": softcap}
            q = randn(4, q_len, kh * group, hd, dtype=dt)
            k, v = (randn(4, s, kh, hd, dtype=dt) for _ in range(2))
            if q_len == 1:
                got = ops.decode_attention(q[:, 0], k, v, lens, **kw)[:, None]
            else:
                got = ops.multi_decode_attention(q, k, v, lens, **kw)
            case = (f"{tag} hd256 g{group} q_len{q_len} w{window} "
                    f"cap{softcap}")
            check("decode_attention", got, ref.multi_decode_attention(
                q, k, v, lens, **kw), tol, case, errors)
            if float(got[0].abs().max()) != 0.0:
                errors.append(f"decode_attention {case}: cache_len 0 row "
                              f"not zero")
        for i, (op, page, group, q_len, q_blk) in enumerate((
                ("decode", 1, 4, 1, None), ("decode", 8, 1, 3, None),
                ("decode", 16, 4, 10, None), ("prefill", 4, 4, 16, 3),
                ("prefill", 8, 1, 64, None), ("prefill", 16, 4, 1, None))):
            window, softcap = opts[(i + j) % 4]
            kw = {"window": window, "softcap": softcap}
            lens = [0, max(q_len - 1, 1), q_len, q_len + 37, q_len + 600, 3]
            kh = 2 if group == 1 else 1
            q, k_pool, v_pool, table, lens_t, nan_pools = paged_case(
                torch, randn, b=len(lens), kh=kh, group=group, hd=hd,
                page=page, width=-(-(q_len + 640) // page), lens=lens,
                q_len=q_len, dtype=dt, shared_blocks=32 // page)
            for kind in ("fp",) + QUANT_POOLS:
                if kind == "fp":
                    pools = {"k": k_pool, "v": v_pool}
                    nan, scales = {"k": nan_pools[0], "v": nan_pools[1]}, {}
                    want_sc = {}
                else:
                    pools, nan = quant_pools(torch, k_pool, v_pool, kind)
                    scales, want_sc = scales_of(nan), scales_of(pools)
                if op == "prefill":
                    got = ops.paged_prefill_attention(
                        q, nan["k"], nan["v"], table, lens_t, q_blk=q_blk,
                        **kw, **scales)
                elif q_len == 1:
                    got = ops.paged_decode_attention(
                        q[:, 0], nan["k"], nan["v"], table, lens_t, **kw,
                        **scales)[:, None]
                else:
                    got = ops.paged_multi_decode_attention(
                        q, nan["k"], nan["v"], table, lens_t, **kw, **scales)
                want = ref.paged_multi_decode_attention(
                    q, pools["k"], pools["v"], table, lens_t, **kw,
                    **want_sc)
                case = (f"{kind} {tag} {op} hd256 page{page} g{group} "
                        f"q_len{q_len} q_blk{q_blk} w{window} cap{softcap}")
                check(f"paged_{op}", got, want, tol, case, errors)
                if float(got[0].abs().max()) != 0.0:
                    errors.append(f"paged_{op} {case}: cache_len 0 row not "
                                  f"zero")


def gemma3_kernel_checks(torch, randn, timer, errors):
    """Rows 1, 2 and 4-6 at gemma3-1b's own shapes (H 4, KH 1, hd 256, bf16,
    the CUDA-core routes), each held to ``TOL_BF16`` at its local layers'
    window (512) and its global layers' (none), and timed at the one that
    does the most work (the global layers' for the decode rows, the local
    layers' for prefill and prefix-append: 22 of the 26 layers): (g3
    prefill) Sq = Skv = 1025; (g3 decode) dense decode B 8 at cache_len
    1025..2049; (g3 q1) the slot step, B 8, page 8, table width 257, on
    bf16 and int8 pools; (g3 flat) the chunked engine's flat fused step,
    8 decode rows and a scene's last 256-token chunk as 256 q_len-1 rows,
    and (g3 chunk) that chunk as one q_len-256 row, on bf16 and int8
    pools.  Returns the report's rows."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    bf16, hd, h, kh = torch.bfloat16, 256, 4, 1
    out = {n: {} for n in ("flash_attention", "decode_attention",
                           "paged_decode_attention",
                           "paged_decode_attention[int8]",
                           "paged_prefill_attention",
                           "paged_prefill_attention[int8]")}
    log("gemma3-1b's shapes (hd 256, CUDA-core routes)")
    # (g3 prefill)
    s = 1025
    q = randn(1, s, h, hd, dtype=bf16)
    k, v = (randn(1, s, kh, hd, dtype=bf16) for _ in range(2))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    for window in (0, G3_WINDOW):
        kw = {"window": window}
        err = check("flash_attention", ops.flash_attention(q, k, v, **kw),
                    ref.flash_attention(q, k, v, **kw), TOL_BF16,
                    f"bf16 g3 prefill H{h} KH{kh} S{s} hd{hd} w{window}",
                    errors)
        if window == 0:
            continue
        mask = ref._attn_mask(s, s, window, True, 0, q.device)
        out["flash_attention"]["g3 prefill"] = timed_rows(
            timer, {"cuda_cores": (
                lambda: ops.flash_attention(q, k, v, **kw), err)},
            lambda: ref.flash_attention(q, k, v, **kw),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True),
            nbytes(q, k, v, q), flash_flops(torch, h, hd, s, s, window),
            f"B1 H{h} KH{kh} Sq=Skv={s} hd{hd} window {window} bf16"
        )["cuda_cores"]
    # (g3 decode)
    b, s = 8, 2049
    lens = torch.tensor([1025 + (1024 * i) // (b - 1) for i in range(b)],
                        dtype=torch.int32, device="cuda")
    q = randn(b, h, hd, dtype=bf16)
    k, v = (randn(b, s, kh, hd, dtype=bf16) for _ in range(2))
    for window in (G3_WINDOW, 0):
        kw = {"window": window}
        err = check("decode_attention", ops.decode_attention(q, k, v, lens,
                                                             **kw),
                    ref.decode_attention(q, k, v, lens, **kw), TOL_BF16,
                    f"bf16 g3 decode B{b} H{h} KH{kh} S{s} w{window}",
                    errors)
    n_keys = int(lens.long().sum())
    mask = dense_mask(torch, lens, 1, s)
    q4, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    out["decode_attention"]["g3 decode"] = timed_rows(
        timer, {"cuda_cores": (lambda: ops.decode_attention(q, k, v, lens),
                               err)},
        lambda: ref.decode_attention(q, k, v, lens),
        lambda: F.scaled_dot_product_attention(q4, kt, vt, attn_mask=mask,
                                               enable_gqa=True),
        2 * nbytes(q) + 2 * n_keys * kh * hd * 2 + 4 * b,
        4.0 * hd * h * n_keys,
        f"B{b} H{h} KH{kh} S{s} cache_len {int(lens[0])}..{int(lens[-1])} "
        f"hd{hd} bf16")["cuda_cores"]
    # (g3 q1): the slot step's paged decode
    page, width = 8, 257
    lens_l = [1025 + (1024 * i) // (b - 1) for i in range(b)]
    q, k_pool, v_pool, table, lens_t, nan_pools = paged_case(
        torch, randn, b=b, kh=kh, group=h // kh, hd=hd, page=page,
        width=width, lens=lens_l, q_len=1, dtype=bf16,
        shared_blocks=1024 // page)
    cases = {"g3 q1": ("decode", q, k_pool, v_pool, nan_pools, table,
                       lens_t, 1, None)}
    decode = [(i, 1024 + (1024 * i) // 7, 1) for i in range(8)]
    qf, kf, vf, tf, lf, nf, plan, _ = flat_step(
        torch, randn, decode + [(8, 768, 256)], tb=264, n_slots=9, kh=kh,
        group=h // kh, hd=hd, page=page, width=width, shared=1024 // page,
        scene_of=[0, 1] * 4 + [2])
    cases["g3 flat"] = ("prefill", qf, kf, vf, nf, tf, lf, 1, plan)
    cases["g3 chunk"] = ("prefill", qf[8:].reshape(1, 256, h, hd), kf, vf,
                         nf, tf[8:9].contiguous(), lf[-1:], 256, None)
    for tag, (op, q, k_pool, v_pool, nan_pools, table, lens_t, q_len,
              plan) in cases.items():
        name = ("paged_decode_attention" if op == "decode"
                else "paged_prefill_attention")
        fn = (ops.paged_multi_decode_attention if op == "decode"
              else ops.paged_prefill_attention)
        bq = q.shape[0]
        s = width * page
        for kind in ("fp", "int8"):
            if kind == "fp":
                pools = {"k": k_pool, "v": v_pool}
                nan = {"k": nan_pools[0], "v": nan_pools[1]}
                scales, want_sc = {}, {}
            else:
                pools, nan = quant_pools(torch, k_pool, v_pool, kind)
                scales, want_sc = scales_of(nan), scales_of(pools)
            extra = {} if plan is None else {"plan": plan}
            windows = (G3_WINDOW, 0) if op == "decode" else (0, G3_WINDOW)
            for window in windows:
                kw = {"window": window}
                err = check(f"paged_{op}", fn(q, nan["k"], nan["v"], table,
                                              lens_t, **kw, **scales,
                                              **extra),
                            ref.paged_multi_decode_attention(
                                q, pools["k"], pools["v"], table, lens_t,
                                **kw, **want_sc), TOL_BF16,
                            f"{kind} bf16 {tag} B{bq} q_len{q_len} "
                            f"w{window}", errors)
            if tag == "g3 chunk" and kind == "int8":
                continue                  # held, not timed
            # timed at the last window held
            mask = dense_mask(torch, lens_t, q_len, s, window)
            qh = q.transpose(1, 2)

            def library(pools=pools, mask=mask, qh=qh, table=table):
                kd, vd = (ref.gather_pages(ref.dequantize_pool(
                    pools[n], pools.get(n + "_scale")), table).to(bf16)
                    .transpose(1, 2) for n in ("k", "v"))
                return F.scaled_dot_product_attention(
                    qh, kd, vd, attn_mask=mask, enable_gqa=True)

            n_bytes, flops = paged_bytes_and_flops(
                torch, q, pools["k"], table, lens_t, q_len,
                scaled=kind != "fp", window=window)
            key = name if kind == "fp" else f"{name}[{kind}]"
            out[key][tag] = timed_rows(
                timer, {"cuda_cores": (
                    lambda: fn(q, nan["k"], nan["v"], table, lens_t, **kw,
                               **scales, **extra), err)},
                lambda: ref.paged_multi_decode_attention(
                    q, pools["k"], pools["v"], table, lens_t, **kw,
                    **want_sc),
                library, n_bytes, flops,
                f"B{bq} KH{kh} g{h // kh} q_len{q_len} hd{hd} page{page} "
                f"P{width} cache_len {int(lens_t.min())}.."
                f"{int(lens_t.max())} window {window} bf16 q, {kind} pool",
                library_is=(
                    "gather_pages + scaled_dot_product_attention (two "
                    "calls)" if kind == "fp" else "gather_pages + "
                    "dequantize + scaled_dot_product_attention"),
                pool=kind)["cuda_cores"]
    return out


def flex_softcap(torch, q, k, v, softcap, mask_mod, batch=None):
    """The library call for softcapped attention: one ``flex_attention``
    call with ``softcap * tanh(score / softcap)`` as its ``score_mod`` and
    ``mask_mod``'s block mask (per batch row with ``batch``), on q (B, H,
    Sq, hd) and k, v (B, KH, Skv, hd).  Compiled here on these operands,
    so that a timing sees the compiled call alone.  Returns the call,
    which takes (q, k, v)."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    block_mask = create_block_mask(mask_mod, batch, None, q.shape[2],
                                   k.shape[2], device=q.device)
    flex = torch.compile(flex_attention, dynamic=False)

    def score_mod(score, b, h, q_idx, kv_idx):
        return softcap * torch.tanh(score / softcap)

    def call(q, k, v):
        return flex(q, k, v, score_mod=score_mod, block_mask=block_mask,
                    enable_gqa=True)

    call(q, k, v)
    return call


def dense_mma_checks(torch, randn, timer, errors):
    """The tensor-core routes (bf16, hd 128) at the dense configs' new
    groups, held to their bound (``check_wgmma`` / ``check_mma_decode``)
    and timed: group 1 (codeqwen1.5-7b, 32/32 heads) and group 16
    (glm4-9b, 32/2) on flash (Sq = Skv = 1025), dense decode (B 1,
    cache_len 2049) and the slot step's paged decode (B 8, page 8, table
    width 257, cache_len 1025..2049), beside SDPA (gather + SDPA for the
    paged rows); gemma2-27b's group 2 (32/16) with softcap 50 and window
    4096 on flash at Sq = Skv = 6000 and on the paged decode at B 8,
    cache_len 5000..6000, so that the window floor bites, beside one
    compiled ``flex_attention`` call with the softcap as its score_mod and
    the window as its block mask (gather + that call for the paged row).
    Each library call's distance from the plain version is kept beside
    it.  Returns the report's rows."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    bf16, hd = torch.bfloat16, 128
    out = {n: {} for n in ("flash_attention_wgmma", "decode_attention_mma",
                           "paged_decode_attention_mma")}
    log("the dense configs' groups on the tensor-core routes")
    for tag, h, kh, s, window, softcap in (
            ("codeqwen", 32, 32, 1025, 0, None),
            ("glm4", 32, 2, 1025, 0, None),
            ("gemma2", 32, 16, G2_SKV, G2_WINDOW, G2_SOFTCAP)):
        kw = {"window": window, "softcap": softcap}
        q = randn(1, s, h, hd, dtype=bf16)
        k, v = (randn(1, s, kh, hd, dtype=bf16) for _ in range(2))
        err, share = check_wgmma("flash_attention",
                                 ops.flash_attention(q, k, v, **kw), q, k, v,
                                 kw, f"bf16 {tag} H{h} KH{kh} S{s} hd{hd} "
                                     f"w{window} cap{softcap}", errors)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if softcap:
            flex = flex_softcap(torch, qt, kt, vt, softcap,
                                lambda b, h, i, j: (j <= i) & (
                                    i - j < window))

            def library(qt=qt, kt=kt, vt=vt, flex=flex):
                return flex(qt, kt, vt)
            library_is = ("flex_attention (compiled; softcap score_mod, "
                          "causal window block mask)")
        else:
            def library(qt=qt, kt=kt, vt=vt):
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)
            library_is = "scaled_dot_product_attention"
        lib_err = float((library().transpose(1, 2).float()
                         - ref.flash_attention(q, k, v, **kw)).abs().max())
        row = timed_rows(
            timer, {"wgmma": (lambda: ops.flash_attention(q, k, v, **kw),
                              err)},
            lambda: ref.flash_attention(q, k, v, **kw), library,
            nbytes(q, k, v, q), flash_flops(torch, h, hd, s, s, window),
            f"B1 H{h} KH{kh} Sq=Skv={s} hd{hd} window {window} softcap "
            f"{softcap} bf16", library_is=library_is,
            library_max_abs_err=lib_err)["wgmma"]
        out["flash_attention_wgmma"][tag] = dict(row, tolerance_share=share)
        if tag == "gemma2":
            continue
        # dense decode, B 1 at cache_len 2049 (the batch path's)
        s = 2049
        q = randn(1, h, hd, dtype=bf16)
        k, v = (randn(1, s, kh, hd, dtype=bf16) for _ in range(2))
        lens = torch.full((1,), s, dtype=torch.int32, device="cuda")
        err, share = check_mma_decode(
            "decode_attention", ops.decode_attention(q, k, v, s)[:, None],
            q[:, None], k, v, lens, {}, f"bf16 {tag} H{h} KH{kh} S{s}",
            errors)
        q4, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
        row = timed_rows(
            timer, {"mma": (lambda: ops.decode_attention(q, k, v, lens),
                            err)},
            lambda: ref.decode_attention(q, k, v, lens),
            lambda: F.scaled_dot_product_attention(q4, kt, vt,
                                                   enable_gqa=True),
            nbytes(q, k, v, q), 4.0 * hd * h * s,
            f"B1 H{h} KH{kh} S{s} cache_len {s} hd{hd} bf16")["mma"]
        out["decode_attention_mma"][tag] = dict(row, tolerance_share=share)
    page = 8
    for tag, h, kh, lo, hi, window, softcap in (
            ("codeqwen q1", 32, 32, 1025, 2049, 0, None),
            ("glm4 q1", 32, 2, 1025, 2049, 0, None),
            ("gemma2 q1", 32, 16, 5000, G2_SKV, G2_WINDOW, G2_SOFTCAP)):
        b, width = 8, -(-hi // page)
        kw = {"window": window, "softcap": softcap}
        lens_l = [lo + ((hi - lo) * i) // (b - 1) for i in range(b)]
        q, k_pool, v_pool, table, lens_t, nan_pools = paged_case(
            torch, randn, b=b, kh=kh, group=h // kh, hd=hd, page=page,
            width=width, lens=lens_l, q_len=1, dtype=bf16,
            shared_blocks=1024 // page)
        kg, vg = (ref.gather_pages(x, table) for x in (k_pool, v_pool))
        err, share = check_mma_decode(
            "paged_decode", ops.paged_decode_attention(
                q[:, 0], *nan_pools, table, lens_t, **kw)[:, None],
            q, kg, vg, lens_t, kw, f"bf16 {tag} B{b} KH{kh} g{h // kh} "
                                    f"P{width} w{window} cap{softcap}",
            errors)
        qh = q.transpose(1, 2)
        if softcap:
            # the block mask reads the lengths; gather + flex_attention
            flex = flex_softcap(
                torch, qh, kg.transpose(1, 2), vg.transpose(1, 2), softcap,
                lambda b, h, i, j, lens=lens_t: (j < lens[b]) & (
                    j >= lens[b] - window), batch=b)

            def attend(kd, vd, flex=flex, qh=qh):
                return flex(qh, kd, vd)
            library_is = ("gather_pages + flex_attention (compiled; "
                          "softcap score_mod, window block mask)")
        else:
            mask = dense_mask(torch, lens_t, 1, width * page, window)

            def attend(kd, vd, mask=mask, qh=qh):
                return F.scaled_dot_product_attention(
                    qh, kd, vd, attn_mask=mask, enable_gqa=True)
            library_is = "gather_pages + scaled_dot_product_attention"
        library_is += " (two calls)"

        def library(k_pool=k_pool, v_pool=v_pool, table=table,
                    attend=attend):
            kd, vd = (ref.gather_pages(x, table).transpose(1, 2)
                      for x in (k_pool, v_pool))
            return attend(kd, vd)

        def plain(q=q, k_pool=k_pool, v_pool=v_pool, table=table,
                  lens_t=lens_t, kw=kw):
            return ref.paged_decode_attention(q[:, 0], k_pool, v_pool,
                                              table, lens_t, **kw)

        lib_err = float((library()[:, :, 0].float() - plain()).abs().max())
        n_bytes, flops = paged_bytes_and_flops(torch, q, k_pool, table,
                                               lens_t, 1, window=window)
        row = timed_rows(
            timer, {"mma": (lambda: ops.paged_decode_attention(
                q[:, 0], k_pool, v_pool, table, lens_t, **kw), err)},
            plain, library, n_bytes, flops,
            f"B{b} KH{kh} g{h // kh} q_len1 hd{hd} page{page} P{width} "
            f"cache_len {lo}..{hi} window {window} softcap {softcap} bf16",
            library_is=library_is, library_max_abs_err=lib_err)["mma"]
        out["paged_decode_attention_mma"][tag] = dict(row,
                                                      tolerance_share=share)
    return out


def dense_kernel_checks(torch, randn, timer, errors):
    """Phase 2's checks for the dense attention configs: the hd-256
    sweep, gemma3-1b's shapes and the new groups on the tensor cores.
    Every hd-256 launch must be on a CUDA-core route, none of them on a
    tensor-core one.  Returns the report's rows."""
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    hd256_sweep(torch, randn, errors)
    out = gemma3_kernel_checks(torch, randn, timer, errors)
    counts = ops.launch_counts()
    routes = {n: ops.launches_by_route(counts, n)
              for n in ("flash_attention", "decode_attention",
                        "paged_decode_attention", "paged_prefill_attention")}
    log(f"  hd 256 launches by route: {routes}")
    for n, r in routes.items():
        if r["cuda_cores"] == 0 or min(v for k, v in r.items()
                                       if k != "cuda_cores") != 0:
            errors.append(f"{n} at hd 256: launches {r}, want every one on "
                          f"the CUDA-core route")
    for name, rows in dense_mma_checks(torch, randn, timer, errors).items():
        out.setdefault(name, {}).update(rows)
    return out


# ---------------------------------------------------------------------------
# phase 2: the flash backward (training)
# ---------------------------------------------------------------------------

#: the backward kernel's tolerance per element: f32 sums in another order
#: than the plain version's, whose error an element that cancels keeps from
#: the terms it sums, which scale with the gradients: 1e-4·G, G the largest
#: |want| over dq, dk and dv (no absolute floor: a dO scaled by c scales G,
#: the errors and the tolerance by c, so layer 0's gradients of a mean CE,
#: ~1e-7, are held as tightly as randn's); in bf16 also 2^-6·|want| (two
#: bf16 ulps: both sides round an f32 result).  A kernel that wrote zeros
#: would use 1e4 of it at the largest element in f32, ~60 in bf16.  Both sides recompute p in
#: f32 from the same q and k; the forward route's bf16 p reaches them only
#: through o, an input both take.
BWD_RTOL_F32 = 1e-4
BWD_RTOL_BF16 = 2.0 ** -6
#: the f32 sweep: (hd, group, KH) per sequence length, windows and softcaps
#: in turns
BWD_HEADS = ((12, 1, 2), (16, 6, 1), (16, 4, 2), (64, 7, 1), (128, 6, 2),
             (256, 1, 1), (256, 7, 1))
BWD_SEQS = (1, 63, 64, 65, 129, 1025)
#: the 2B's training shapes (B 4, 12/2 heads, hd 128, bf16): the vqa/cls
#: batches (S 1025) and the det batch (S 2048)
BWD_TIMED = {"2B train": 1025, "det": 2048}


def check_grads(name, got, want, case, errors):
    """(dq, dk, dv) against the plain version's, each element within
    ``BWD_RTOL_F32·G`` (G the largest |want| over the three; +
    ``BWD_RTOL_BF16·|want|`` in bf16); returns (max absolute error, share
    of the tolerance used)."""
    want = [w.float() for w in want]
    scale = max(float(w.abs().max()) for w in want)
    errs, shares = [], []
    for g, w in zip(got, want):
        diff = (g.float() - w).abs()
        rtol = BWD_RTOL_BF16 if g.element_size() == 2 else 0.0   # bf16
        tol = BWD_RTOL_F32 * scale + rtol * w.abs()
        errs.append(float(diff.max()))
        shares.append(float(tolerance_share(diff, tol)))
    err, share = max(errs), max(shares)
    ok = math.isfinite(err) and share <= 1.0
    log(f"  {name:16s} {case:52s} max_abs_err {err:.3e} G {scale:.2e} "
        f"(dq/dk/dv used "
        f"{'/'.join(f'{x:.3f}' for x in shares)}) {'ok' if ok else 'FAIL'}")
    if not ok:
        errors.append(f"{name} {case}: max_abs_err {err}, {share:.3f} of the "
                      f"tolerance")
    return err, share


def tolerance_share(diff, tol):
    """The largest diff / tol: 0 / 0 counts 0, any other error over a
    zero tolerance fails (inf becomes the largest float)."""
    return (diff / tol).nan_to_num(nan=0.0).max()


def bwd_inputs(torch, randn, b, sq, skv, h, kh, hd, dtype, **kw):
    """q, do (B, Sq, H, hd) and k, v (B, Skv, KH, hd) views of buffers whose
    rows past Skv are NaN (a read past the keys would show), and o, the
    forward's output on the card (its route by dtype and head dim) at the
    window and softcap of ``kw``."""
    from repro_torch.kernels import ops
    q, do = randn(b, sq, h, hd, dtype=dtype), randn(b, sq, h, hd, dtype=dtype)
    kb, vb = (randn(b, skv + 16, kh, hd, dtype=dtype) for _ in range(2))
    kb[:, skv:], vb[:, skv:] = float("nan"), float("nan")
    k, v = kb[:, :skv], vb[:, :skv]
    with torch.no_grad():
        o = ops.flash_attention(q, k, v, **kw)
    return q, k, v, o, do


#: the tensor-core backward's bf16 sweep: (hd, group, KH) per sequence
#: length, windows and softcaps in turns
BWD_WGMMA_HEADS = ((64, 1, 2), (128, 6, 2), (128, 7, 1), (64, 6, 1),
                   (128, 1, 4))
BWD_WGMMA_SEQS = (1, 63, 64, 65, 1025)


def check_bwd_wgmma(name, got, q, k, v, o, do, kw, case, errors):
    """The tensor-core backward's (dq, dk, dv) against the f32 plain
    version's, element by element within 1e-4·G + 2^-6·|want| + 2^-8·A: G
    the largest |want| over the three (f32 sums in another order, as
    ``check_grads``), 2^-6·|want| two bf16 ulps (the gradients' own
    rounding), A the same products over absolute values
    (``ref.flash_attention_bwd_abs``: A_dv = Σ_group Pᵀ·|dO|, A_dk =
    scale·Σ_group |dS|ᵀ·|Q|, A_dq = scale·|dS|·|K|).  It rounds P and dS
    to bf16 before those products; bf16's unit roundoff is 2^-8, so
    2^-8·A is exactly the worst case of the two roundings alone, and the
    shares printed are the evidence of room.  q, k, v, o, do in the model
    layout.  Returns (max absolute error, share of the bound used)."""
    from repro_torch.kernels import ref
    f32 = [t.float() for t in (q, k, v, o, do)]
    want = ref.flash_attention_bwd(*f32, **kw)
    a = ref.flash_attention_bwd_abs(*f32, **kw)
    big = max(float(w.abs().max()) for w in want)
    errs, shares = [], []
    for g, w, x in zip(got, want, a):
        diff = (g.float() - w).abs()
        errs.append(float(diff.max()))
        shares.append(float(tolerance_share(
            diff, 1e-4 * big + 2.0 ** -6 * w.abs() + 2.0 ** -8 * x)))
    err, share = max(errs), max(shares)
    ok = math.isfinite(err) and share <= 1.0
    log(f"  {name:16s} {case:52s} max_abs_err {err:.3e} G {big:.2e} bound "
        f"1e-4G+2^-6|want|+2^-8A (dq/dk/dv used "
        f"{'/'.join(f'{x:.3f}' for x in shares)}) {'ok' if ok else 'FAIL'}")
    if not ok:
        errors.append(f"{name} {case}: max_abs_err {err}, {share:.3f} of the "
                      f"bound")
    return err, share


def bwd_wgmma_sweep(torch, randn, errors):
    """The tensor-core backward (bf16, hd 64/128) against the plain
    version: ``BWD_WGMMA_HEADS`` x ``BWD_WGMMA_SEQS`` and Sq 65 < Skv 300,
    windows 0/100 and softcaps none/30 in turns, K/V views of buffers NaN
    past Skv; every other case through autograd (``ops.flash_attention``
    on leaves that require grad: ``FlashAttentionFn`` saves the forward's
    lse), the rest straight to the wrapper with ``launch_wgmma``'s lse.
    Also: two calls are bit-equal, each call counts one launch under
    ``flash_attention_bwd_wgmma`` and none on the CUDA cores, the forward's
    lse equals the plain logsumexp within 1e-5, the forward with a null
    lse writes the same output bits as with one, and a misaligned view or
    a missing lse raises before any launch.  Returns the largest share of
    the bound any case used."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops, ref
    bf16 = torch.bfloat16
    log("flash_attention_bwd vs plain (wgmma route)")
    opts = [(0, None), (100, None), (0, 30.0), (100, 30.0)]
    cases = [(s, s, hd, g, kh) for s in BWD_WGMMA_SEQS
             for hd, g, kh in BWD_WGMMA_HEADS]
    cases += [(65, 300, 128, 6, 2), (65, 300, 64, 7, 1)]
    shares, lse_err = [], 0.0
    for n, (sq, skv, hd, group, kh) in enumerate(cases):
        window, softcap = opts[n % len(opts)]
        kw = {"window": window, "softcap": softcap}
        q, k, v, o, do = bwd_inputs(torch, randn, 2, sq, skv, kh * group, kh,
                                    hd, bf16, **kw)
        before = ops.launch_counts()
        if n % 2:
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            with torch.enable_grad():
                out = ops.flash_attention(*leaves, **kw)
            got = torch.autograd.grad(out, leaves, do)
            o, path = out.detach(), "autograd"
        else:
            tr = [t.transpose(1, 2) for t in (q, k, v)]
            o2, lse = FA.launch_wgmma(*tr, with_lse=True, **kw)
            if not same_bits(o2.transpose(1, 2), o):
                errors.append(f"flash_attention_wgmma Sq{sq} hd{hd}: the "
                              f"forward with lse wrote other bits")
            want_lse = ref.flash_attention_lse(q.float(), k.float(), **kw)
            lse_err = max(lse_err, float((lse - want_lse).abs().max()))
            got = [t.transpose(1, 2) for t in FA.flash_attention_bwd_cuda(
                *tr, o.transpose(1, 2), do.transpose(1, 2), lse=lse, **kw)]
            again = [t.transpose(1, 2) for t in FA.flash_attention_bwd_cuda(
                *tr, o.transpose(1, 2), do.transpose(1, 2), lse=lse, **kw)]
            if not all(same_bits(x, y) for x, y in zip(got, again)):
                errors.append(f"flash_attention_bwd_wgmma Sq{sq} hd{hd}: two "
                              f"calls differ")
            path = "wrapper x2"
        after = ops.launch_counts()
        runs = ops.launches_by_route(after, "flash_attention_bwd")
        was = ops.launches_by_route(before, "flash_attention_bwd")
        calls = 1 if n % 2 else 2
        if (runs["wgmma"] - was["wgmma"] != calls
                or runs["cuda_cores"] != was["cuda_cores"]):
            errors.append(f"flash_attention_bwd Sq{sq} hd{hd}: launches "
                          f"{was} -> {runs}, want {calls} wgmma")
        shares.append(check_bwd_wgmma(
            "flash_attention_bwd", got, q, k, v, o, do, kw,
            f"bf16 {path} hd{hd} g{group} Sq{sq} Skv{skv} w{window} "
            f"cap{softcap}", errors)[1])
    log(f"  wgmma sweep: largest share of the bound {max(shares):.3f}; "
        f"forward lse vs plain max_abs_err {lse_err:.3e}")
    if not lse_err <= 1e-5:
        errors.append(f"flash_attention_wgmma: lse max_abs_err {lse_err}")
    q, k, v, o, do = bwd_inputs(torch, randn, 1, 70, 70, 2, 1, 128, bf16)
    tr = [t.transpose(1, 2) for t in (q, k, v, o, do)]
    _, lse = FA.launch_wgmma(*tr[:3], with_lse=True)
    buf = randn(1, 70, 2, 136, dtype=bf16)
    for what, args, kw in (
            ("misaligned do view", tr[:4] + [buf[..., 1:129].transpose(1, 2)],
             {"lse": lse}),
            ("missing lse", tr, {})):
        try:
            FA.flash_attention_bwd_cuda(*args, **kw)
            errors.append(f"flash_attention_bwd_wgmma: a {what} was not "
                          f"refused")
        except ValueError as e:
            log(f"  flash_attention_bwd  {what}: refused ({e}) ok")
    return max(shares)


def bwd_kernel_checks(torch, randn, timer, errors):
    """The flash backward against its plain version: the CUDA-core route's
    f32 sweep (``BWD_HEADS`` x ``BWD_SEQS``, windows 0/100 and softcaps
    none/30 in turns, and Sq 65 < Skv 300), every other case through
    autograd (``ops.flash_attention`` on inputs that require grad, so
    ``FlashAttentionFn``), the rest straight to the wrapper on (B, H, S, hd)
    views; the tensor-core route's bf16 sweep (``bwd_wgmma_sweep``); then
    bf16 at ``BWD_TIMED``, both routes and the library's backward
    (``scaled_dot_product_attention`` forward and backward less its
    forward) timed in turns (wgmma, library, CUDA cores, wgmma) beside the
    plain version and the bound (five S x S x hd products over the causal
    half, 2.5x the forward's, whatever a route executes).  Returns the
    report's rows, the CUDA-core route under ``flash_attention_bwd`` and
    the tensor-core route under ``flash_attention_bwd_wgmma``."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops, ref
    log("flash_attention_bwd vs plain (CUDA-core route)")
    opts = [(0, None), (100, None), (0, 30.0), (100, 30.0)]
    cases = [(s, s, hd, g, kh) for s in BWD_SEQS for hd, g, kh in BWD_HEADS]
    cases += [(65, 300, 64, 6, 1), (65, 300, 16, 7, 1)]
    shares = []
    for n, (sq, skv, hd, group, kh) in enumerate(cases):
        window, softcap = opts[n % len(opts)]
        kw = {"window": window, "softcap": softcap}
        q, k, v, o, do = bwd_inputs(torch, randn, 2, sq, skv, kh * group, kh,
                                    hd, torch.float32, **kw)
        want = ref.flash_attention_bwd(q, k, v, o, do, **kw)
        if n % 2:
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            with torch.enable_grad():
                out = ops.flash_attention(*leaves, **kw)
            got = torch.autograd.grad(out, leaves, do)
            path = "autograd"
        else:
            got = [t.transpose(1, 2) for t in FA.flash_attention_bwd_cuda(
                *(t.transpose(1, 2) for t in (q, k, v, o, do)), **kw)]
            path = "wrapper"
        shares.append(check_grads(
            "flash_attention_bwd", got, want,
            f"f32 {path} hd{hd} g{group} Sq{sq} Skv{skv} w{window} "
            f"cap{softcap}", errors)[1])
    log(f"  f32 sweep: largest share of the tolerance {max(shares):.3f}")
    try:
        q, k, v, o, do = bwd_inputs(torch, randn, 1, 8, 8, 2, 1, 12,
                                    torch.float32)
        FA.flash_attention_bwd_cuda(*(t.transpose(1, 2) for t in
                                      (q, k, v, o, do[..., :8])))
        errors.append("flash_attention_bwd: a bad shape was not refused")
    except ValueError as e:
        log(f"  flash_attention_bwd  bad do shape: refused ({e}) ok")
    wgmma_share = bwd_wgmma_sweep(torch, randn, errors)

    out = {"flash_attention_bwd": {}, "flash_attention_bwd_wgmma": {}}
    b, h, kh, hd = 4, 12, 2, 128
    for tag, s in BWD_TIMED.items():
        q, k, v, _, do = bwd_inputs(torch, randn, b, s, s, h, kh, hd,
                                    torch.bfloat16)
        k, v = k.contiguous(), v.contiguous()
        tr = [t.transpose(1, 2) for t in (q, k, v)]
        o, lse = FA.launch_wgmma(*tr, with_lse=True)
        tr += [o, do.transpose(1, 2)]
        o = o.transpose(1, 2)
        shape = f"B{b} H{h} KH{kh} S{s} hd{hd} bf16"
        got = [t.transpose(1, 2) for t in FA.launch_bwd_wgmma(*tr, lse)]
        err, share = check_bwd_wgmma("flash_attention_bwd", got, q, k, v, o,
                                     do, {}, f"bf16 wgmma {tag} {shape}",
                                     errors)
        got = [t.transpose(1, 2) for t in FA.launch_bwd_cuda_cores(*tr)]
        err_cc, share_cc = check_grads(
            "flash_attention_bwd", got, ref.flash_attention_bwd(q, k, v, o,
                                                                do),
            f"bf16 CUDA cores {tag} {shape}", errors)
        qt, kt, vt = (t.detach().requires_grad_() for t in tr[:3])
        dot = tr[4]

        def lib_fwd():
            with torch.no_grad():
                F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True)

        def lib_both():
            with torch.enable_grad():
                lo = F.scaled_dot_product_attention(qt, kt, vt,
                                                    is_causal=True,
                                                    enable_gqa=True)
            torch.autograd.grad(lo, (qt, kt, vt), dot)

        wgmma = lambda: FA.launch_bwd_wgmma(*tr, lse)  # noqa: E731
        runs = [timer(wgmma)]
        lib = timer(lib_both) - timer(lib_fwd)
        cc_ms = timer(lambda: FA.launch_bwd_cuda_cores(*tr))
        runs.append(timer(wgmma))
        ms = sum(runs) / len(runs)
        n_bytes = nbytes(q, k, v, o, do, q, k, v)
        flops = 2.5 * b * flash_flops(torch, h, hd, s, s)
        b_ms, b_by = bound_ms(n_bytes, flops, "bfloat16")
        base = {"plain_ms": timer(lambda: ref.flash_attention_bwd(
                    q, k, v, o, do), reps=3),
                "library_ms": lib, "library_is": "SDPA fwd+bwd - fwd",
                "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes,
                "flops": flops, "shape": shape}
        out["flash_attention_bwd_wgmma"][tag] = dict(
            base, ms=ms, ms_runs=runs, max_abs_err=err,
            tolerance_share=share, route="wgmma", bound_share=b_ms / ms,
            vs_library=ms / lib, sweep_tolerance_share=wgmma_share)
        out["flash_attention_bwd"][tag] = dict(
            base, ms=cc_ms, max_abs_err=err_cc, tolerance_share=share_cc,
            route="cuda_cores", bound_share=b_ms / cc_ms,
            vs_library=cc_ms / lib, sweep_tolerance_share=max(shares))
        log(f"  flash_attention_bwd {tag}: wgmma {ms:.4f} ms "
            f"({b_ms / ms:.4f} of the bound, {ms / lib:.2f}x SDPA's "
            f"{lib:.4f} ms), CUDA cores {cc_ms:.4f} ms ({b_ms / cc_ms:.4f})"
            f", bound {b_ms:.5f} ms")
    out["flash_attention_bwd_wgmma"]["2B train"]["tail"] = bwd_tail(
        torch, randn, errors)
    return out


BWD_KERNELS = ("bwd_delta_kernel", "bwd_dkdv_kernel", "bwd_dkdv_sum_kernel",
               "bwd_dq_kernel")


def bwd_tail(torch, randn, errors):
    """The dK/dV pass's causal tail at the 2B's shapes: each kernel's
    device ms a launch (profiler, 5 launches) with the group's 6 heads
    split over d = 1, 2, 3, 6 blocks (``bwd_splits`` forced), each run held
    to the bound.  Unsplit, the pass lasts as long as its heaviest block;
    1 - (the best split's dK/dV kernel) / (the unsplit one) is the share of
    the unsplit pass that was tail.  Returns {S: {d: per-kernel ms},
    "chosen": ..., "tail_share": ...}."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import flash_attention as FA
    b, h, kh, hd = 4, 12, 2, 128
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    real, out = FA.bwd_splits, {}
    try:
        for s in BWD_TIMED.values():
            q, k, v, _, do = bwd_inputs(torch, randn, b, s, s, h, kh, hd,
                                        torch.bfloat16)
            k, v = k.contiguous(), v.contiguous()
            tr = [t.transpose(1, 2) for t in (q, k, v)]
            o, lse = FA.launch_wgmma(*tr, with_lse=True)
            args = tr + [o, do.transpose(1, 2), lse]
            res = {}
            for d in (1, 2, 3, 6):
                FA.bwd_splits = lambda *a, d=d: d  # noqa: E731
                got = [t.transpose(1, 2) for t in FA.launch_bwd_wgmma(*args)]
                check_bwd_wgmma("flash_attention_bwd", got, q, k, v,
                                o.transpose(1, 2), do, {},
                                f"bf16 S{s} heads split over {d}", errors)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(5):
                        FA.launch_bwd_wgmma(*args)
                    torch.cuda.synchronize()
                res[d] = {n: ms for n, (c, ms) in kernel_device_ms(
                    torch, prof, BWD_KERNELS).items() if c}
            best = min(res[d]["bwd_dkdv_kernel"] for d in res)
            chosen = real(b, kh, h // kh, hd, s, s, True, 0, sms)
            out[f"S{s}"] = {"by_split": res, "chosen": chosen,
                            "tail_share":
                                1 - best / res[1]["bwd_dkdv_kernel"]}
            log(f"  flash_attention_bwd wgmma S{s} device ms a launch by "
                f"heads split: {res}; chosen {chosen}; unsplit dK/dV tail "
                f"share {out[f'S{s}']['tail_share']:.3f}")
    finally:
        FA.bwd_splits = real
    return out


def ssm_flops(b, h, s, dk, dv, chunk):
    """FLOPs of the chunk form: per chunk and (row, head) q·kᵀ and score·v
    over the full C×C block, q·S and the state update."""
    c = min(chunk, s)
    per = 2 * c * c * dk + 2 * c * c * dv + 4 * c * dk * dv
    return float(b * h * (s // c) * per)


def slstm_flops(b, s, heads, p_dim):
    """FLOPs of the recurrence: the h·R matvec (2·P·4P a head and step) and
    ~30 per unit for the gates and the state update."""
    return float(b * s * heads * (8 * p_dim * p_dim + 30 * p_dim))


def ssm_check(case, got, want, errors):
    """The scan's output and f32 final state; an output in another dtype
    than the state (bf16) is held to ``TOL_SCAN_BF16``."""
    tol = TOL_SCAN_BF16 if got[0].dtype != got[1].dtype else TOL_SCAN
    e = check("ssm_scan o", got[0], want[0], tol, case, errors)
    e = max(e, check("ssm_scan state", got[1], want[1], TOL_SCAN, case,
                     errors))
    if not all(bool(x.isfinite().all()) for x in got):
        errors.append(f"ssm_scan {case}: non-finite output")
    return e


def slstm_check(case, got, want, tol, errors):
    """The sLSTM's h over the sequence and its four final states."""
    e = check("slstm_scan out", got[0], want[0], tol, case, errors)
    for name, a, w in zip("hcnm", got[1], want[1]):
        e = max(e, check(f"slstm_scan {name}", a, w, tol, case, errors))
    if not all(bool(x.isfinite().all()) for x in (got[0], *got[1])):
        errors.append(f"slstm_scan {case}: non-finite output")
    return e


#: the chunked scan's timed shapes (B, S, H) at the xlstm-125m widths
#: (dk 384, dv 385, bf16): (f) the prefill scan at 4096 tokens, (f') phase 9
#: (ii)'s B 128 x 512 prefill
SSM_TIMED = {"f xLSTM": (4, 4096, 4), "f' xLSTM B128": (128, 512, 4)}


def ssm_plan(b, h, dk, dv):
    """The tensor-core scan's cluster plan at a shape: blocks a cluster,
    m-tiles a block (at most), clusters, clusters resident at once, waves."""
    from repro_torch.kernels import ssm_scan as SS
    cs = SS.card_cluster_plan(b * h, dk, dv, 0)
    resident = SS.max_clusters(0, dk, dv, cs)
    return {"cs": cs, "m_tiles_per_block": -(-SS.m_tiles(dv) // cs),
            "clusters": b * h, "resident": resident,
            "waves": -(-(b * h) // resident)}


def scan_kernel_checks(torch, randn, timer, errors):
    """The two recurrent kernels against their plain versions.  ssm_scan,
    through ``ops``, each call one launch on the route ``route`` names: an
    f32 sweep on the CUDA cores (S 1, 37 (chunk = S), 64, 256; chunk 16 and
    64; dk 8, 16, 384; dv 9, 24, 385; zero and carried state; log_g =
    -softplus(randn), -2 and -30, where the output must be finite) and a
    bf16 sweep on the tensor cores (S 1, 37, 64, 256; chunk 16 and 64; dk
    16, 32, 48, 384; dv 9, 24, 100, 385; zero and carried state; log_g
    soft and -30); then ``SSM_TIMED`` with the model's operands (k scaled
    by a sigmoid gate, v's column of ones, log_f = log_sigmoid(3 + noise)),
    both routes held and timed in turns (tensor cores, CUDA cores, CUDA
    cores, tensor cores), the cluster plan printed.  slstm_scan:
    ``slstm_kernel_checks``.  No single PyTorch call computes either scan:
    the rows' library column is null."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssm_scan as SS
    out = {"ssm_scan": {}, "ssm_scan_mma": {}}

    def ssm_inputs(b, s, h, dk, dv, dtype=torch.float32, g_const=None,
                   carried=False):
        q = randn(b, s, h, dk) * dk ** -0.5
        k, v = randn(b, s, h, dk), randn(b, s, h, dv)
        g = (-F.softplus(randn(b, s, h)) if g_const is None
             else torch.full((b, s, h), g_const, device="cuda"))
        st = randn(b, h, dk, dv) if carried else None
        return q.to(dtype), k.to(dtype), v.to(dtype), g, st

    def through_ops(case, args, chunk, route):
        """``ops.ssm_scan`` against the plain version: one launch, on
        ``route``; returns the max abs error."""
        before = ops.launches_by_route(ops.launch_counts(), "ssm_scan")
        got = ops.ssm_scan(*args, chunk=chunk)
        after = ops.launches_by_route(ops.launch_counts(), "ssm_scan")
        if {r: after[r] - before[r] for r in after} != {
                r: int(r == route) for r in after}:
            errors.append(f"ssm_scan {case}: not one launch on the {route} "
                          f"route ({before} -> {after})")
        return ssm_check(case, got, ref.ssm_scan(*args, chunk=chunk), errors)

    log("ssm_scan vs plain (CUDA-core route: f32)")
    for s, chunk, dk, dv, carried, g_const in [
            (1, 64, 8, 9, False, None), (37, 64, 16, 24, True, None),
            (64, 16, 8, 9, True, None), (256, 64, 16, 24, False, None),
            (256, 16, 384, 385, True, None), (64, 64, 384, 385, False, None),
            (37, 64, 384, 385, True, None), (256, 64, 16, 9, True, -30.0),
            (128, 64, 8, 24, False, -2.0)]:
        case = (f"f32 S{s} chunk{chunk} dk{dk} dv{dv} "
                f"{'carried' if carried else 'zero'} g{g_const or 'soft'}")
        args = ssm_inputs(2, s, 2, dk, dv, g_const=g_const, carried=carried)
        out["ssm_scan"][case] = {"max_abs_err": through_ops(
            case, args, chunk, "cuda_cores")}
    log("ssm_scan vs plain (tensor-core route: bf16, dk % 16 == 0)")
    for s, chunk, dk, dv, carried, g_const in [
            (1, 64, 16, 9, False, None), (37, 64, 32, 24, True, None),
            (64, 16, 16, 9, True, None), (256, 64, 48, 100, False, None),
            (256, 16, 384, 385, True, None), (64, 64, 384, 385, False, None),
            (37, 64, 384, 385, True, None), (256, 64, 16, 9, True, -30.0),
            (256, 16, 32, 385, True, -30.0)]:
        case = (f"bf16 S{s} chunk{chunk} dk{dk} dv{dv} "
                f"{'carried' if carried else 'zero'} g{g_const or 'soft'}")
        args = ssm_inputs(2, s, 2, dk, dv, dtype=torch.bfloat16,
                          g_const=g_const, carried=carried)
        out["ssm_scan_mma"][case] = {"max_abs_err": through_ops(
            case, args, chunk, "mma")}

    # (f), (f'): the xLSTM-125m scan's operands, both routes in turns
    for tag, (b, s, h) in SSM_TIMED.items():
        dk, dv = 384, 385
        q, k, v, _, _ = ssm_inputs(b, s, h, dk, dv, dtype=torch.bfloat16)
        k = (k.float() * torch.sigmoid(randn(b, s, h))[..., None]).to(
            torch.bfloat16)
        v[..., -1] = 1.0
        g = ref.log_sigmoid(3.0 + randn(b, s, h))
        shape = f"B{b} S{s} H{h} dk{dk} dv{dv} chunk64 bf16"
        want = ref.ssm_scan(q, k, v, g)
        args = [x.transpose(1, 2) for x in (q, k, v, g)]
        args.append(torch.zeros((b, h, dk, dv), device="cuda"))
        errs = {}
        for route, launch in (("mma", SS.launch_mma),
                              ("cuda_cores", SS.launch_cuda_cores)):
            o, sf = launch(*args)
            errs[route] = ssm_check(f"bf16 ({tag}) {route} {shape}",
                                    (o.transpose(1, 2), sf), want, errors)
        del o, sf, want
        ms_m = timer(lambda: SS.launch_mma(*args), reps=5)
        ms_c = timer(lambda: SS.launch_cuda_cores(*args), reps=3)
        ms_c = (ms_c + timer(lambda: SS.launch_cuda_cores(*args), reps=3)) / 2
        ms_m = (ms_m + timer(lambda: SS.launch_mma(*args), reps=5)) / 2
        # q, k, v, log_g and the state read, o and the final state written
        n_bytes = nbytes(*args) + nbytes(q) // dk * dv + nbytes(args[-1])
        b_ms, b_by = bound_ms(n_bytes, ssm_flops(b, h, s, dk, dv, 64),
                              "bfloat16")
        common = {"plain_ms": timer(lambda: ref.ssm_scan(q, k, v, g),
                                    reps=3),
                  "library_ms": None, "library_is": "no single library call",
                  "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes,
                  "shape": shape}
        plan = ssm_plan(b, h, dk, dv)
        out["ssm_scan_mma"][tag] = dict(common, max_abs_err=errs["mma"],
                                        ms=ms_m, route="mma", plan=plan,
                                        bound_share=b_ms / ms_m)
        out["ssm_scan"][tag] = dict(common, max_abs_err=errs["cuda_cores"],
                                    ms=ms_c, route="cuda_cores",
                                    bound_share=b_ms / ms_c)
        log(f"  ssm_scan ({tag}) {shape}: tensor cores {ms_m:.4f} ms, CUDA "
            f"cores {ms_c:.4f} ms (in turns; {ms_c / ms_m:.2f}x), plain "
            f"{common['plain_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by}; "
            f"share {b_ms / ms_m:.4f}); plan {plan}")

    # what the plan reads: clusters of each size the card holds at once
    occupancy = {cs: SS.max_clusters(0, 384, 385, cs)
                 for cs in SS.cluster_sizes(385)}
    out["ssm_scan_mma"]["f xLSTM"]["max_clusters_by_size"] = occupancy
    log(f"  ssm_scan tensor cores: clusters of each size the card holds at "
        f"once at dk 384, dv 385: {occupancy}")

    log("slstm_scan vs plain")
    out.update(slstm_kernel_checks(torch, randn, timer, errors))
    return out


#: the sLSTM's timed shapes (B, S, H, P): (g) the xLSTM-125m prefill scan
#: at 4096 tokens, (g') phase 9 (ii)'s B 128 x 512 prefill, the two decode
#: launches (S 1 at B 4 and B 128), the dependence floor's shape, where a
#: step is nearly all exchange, and the route rule's crossover: the reduced
#: proxies' P 16, and P 48 / 64 on either side of ``CLUSTER_MIN_P``
SLSTM_TIMED = {"g xLSTM": (4, 4096, 4, 192), "g' xLSTM B128": (128, 512, 4, 192),
               "decode B4": (4, 1, 4, 192), "decode B128": (128, 1, 4, 192),
               "floor B1 P8": (1, 4096, 1, 8), "P16 B4": (4, 4096, 4, 16),
               "P48 B4": (4, 4096, 4, 48), "P64 B4": (4, 4096, 4, 64)}


def slstm_kernel_checks(torch, randn, timer, errors):
    """The sLSTM's two routes against the plain version: an f32 sweep (B
    1-5, 128 and 256, S 1, 2, 5, 20, 33, 37, 50, 300; H 1-4 and 16; P 8,
    64, 100, 192, 256; zero and carried state; gate pre-activations ~N(0,
    10²), past ±30; B 256 and H 16 take two waves of clusters),
    comparing h and all four final states on both routes, the rule's
    through ``ops`` (which must count one launch on that route); then the
    ``SLSTM_TIMED`` shapes with model-scale gates, both routes held and
    timed in turns (cluster, per-row, per-row, cluster), the cluster plan
    (cs, bt, clusters, clusters resident at once, waves) printed.  No single
    PyTorch call computes the scan: the library column is null."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import slstm_scan as SL
    launch = {"cluster": SL.launch_cluster, "per_row": SL.launch_per_row}
    out = {"slstm_scan": {}, "slstm_scan_cluster": {}}

    def inputs(b, s, heads, p_dim, scale, carried):
        d = heads * p_dim
        gx = randn(b, s, 4 * d) * scale
        if scale == 1.0:                      # model-scale: forget bias 3
            gx[..., 2 * d:3 * d] += 3.0
        r = randn(heads, p_dim, 4 * p_dim) * p_dim ** -0.5
        st = None
        if carried:
            st = (torch.tanh(randn(b, heads, p_dim)),
                  randn(b, heads, p_dim) * 3,
                  torch.rand((b, heads, p_dim), device="cuda") * 5 + 0.5,
                  randn(b, heads, p_dim) * 10)
        return gx, r, st

    def plan_of(b, heads, p_dim):
        cs, bt = SL.card_cluster_plan(b, heads, p_dim, 0)
        clusters = heads * -(-b // bt)
        resident = SL.max_clusters(0, p_dim, cs, bt)
        return {"cs": cs, "bt": bt, "clusters": clusters,
                "resident": resident, "waves": -(-clusters // resident)}

    def both(case, gx, r, st):
        """Both routes against the plain version; the rule's through ops.
        Returns ({route: max_abs_err}, the rule's route, the plan)."""
        b, s, _ = gx.shape
        heads, p_dim = r.shape[:2]
        want = ref.slstm_scan(gx, r, st)
        rule = SL.route(p_dim)
        before = ops.launches_by_route(ops.launch_counts(), "slstm_scan")
        errs = {rule: slstm_check(f"{case} {rule} (rule)",
                                  ops.slstm_scan(gx, r, st), want, TOL_SLSTM,
                                  errors)}
        after = ops.launches_by_route(ops.launch_counts(), "slstm_scan")
        if after[rule] != before[rule] + 1:
            errors.append(f"slstm_scan {case}: ops did not launch the "
                          f"{rule} route the rule names")
        other = "per_row" if rule == "cluster" else "cluster"
        errs[other] = slstm_check(f"{case} {other}",
                                  launch[other](gx, r, st), want, TOL_SLSTM,
                                  errors)
        plan = plan_of(b, heads, p_dim)
        log(f"    rule: {rule}; cluster plan {plan}")
        return errs, rule, plan

    for b, s, heads, p_dim, carried in [
            (1, 1, 1, 8, False), (2, 2, 4, 8, True), (3, 37, 1, 64, True),
            (2, 300, 4, 64, False), (1, 300, 4, 192, True),
            (3, 1, 4, 192, True), (2, 37, 4, 192, False),
            (3, 20, 4, 8, True), (5, 37, 2, 64, True),
            (2, 50, 3, 100, True), (1, 50, 1, 256, False),
            (5, 2, 4, 192, True), (4, 1, 4, 192, True),
            (128, 1, 4, 192, True), (256, 5, 4, 192, True),
            (4, 33, 16, 192, False)]:
        gx, r, st = inputs(b, s, heads, p_dim, 10.0, carried)
        both(f"f32 B{b} S{s} H{heads} P{p_dim} "
             f"{'carried' if carried else 'zero'}", gx, r, st)

    for tag, (b, s, heads, p_dim) in SLSTM_TIMED.items():
        decode = s == 1
        gx, r, st = inputs(b, s, heads, p_dim, 1.0, decode)
        shape = f"B{b} S{s} H{heads} P{p_dim} f32"
        errs, rule, plan = both(f"f32 ({tag}) {shape}", gx, r, st)
        reps = 50 if decode else 5
        ms = {"cluster": [], "per_row": []}
        for name in ("cluster", "per_row", "per_row", "cluster"):
            ms[name].append(timer(lambda: launch[name](gx, r, st),
                                  reps=reps))
        st0 = st or ref.slstm_zero_state(b, heads, p_dim, gx.device)
        # gates, R and the state read once; h and the final state written
        n_bytes = nbytes(gx, r, *st0) + 4 * (b * s + 4 * b) * heads * p_dim
        b_ms, b_by = bound_ms(n_bytes, slstm_flops(b, s, heads, p_dim),
                              "float32")
        plain_ms = timer(lambda: ref.slstm_scan(gx, r, st),
                         reps=2 if s > 1 else 10)
        for name, key in (("cluster", "slstm_scan_cluster"),
                          ("per_row", "slstm_scan")):
            t = sum(ms[name]) / 2
            out[key][tag] = {
                "max_abs_err": errs[name], "ms": t, "ms_in_turns": ms[name],
                "plain_ms": plain_ms, "library_ms": None,
                "library_is": "no single library call", "bound_ms": b_ms,
                "bound_by": b_by, "bytes": n_bytes, "sequential_steps": s,
                "us_per_step": 1e3 * t / s, "shape": shape,
                "rule_route": rule, "cluster_plan": plan}
        log(f"  sLSTM ({tag}) {shape}: cluster {ms['cluster']} ms, per-row "
            f"{ms['per_row']} ms (rule: {rule}), plain {plain_ms:.3f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}); plan {plan}")
    floor = out["slstm_scan_cluster"]["floor B1 P8"]["us_per_step"]
    steps_g = SLSTM_TIMED["g xLSTM"][1]
    for key in out:
        out[key]["g xLSTM"]["dependence_floor_ms"] = 1e-3 * floor * steps_g
    log(f"  sLSTM dependence floor: {floor:.3f} us a step on the cluster "
        f"route at (B 1, H 1, P 8); x {steps_g} steps = "
        f"{1e-3 * floor * steps_g:.3f} ms at (g)")
    return out


# ---------------------------------------------------------------------------
# phases 3-4: the request server
# ---------------------------------------------------------------------------

def make_requests(task_taus, image_size: int, grid: int, seed: int = 0):
    """(taus, Request) pairs from the numpy ``make_dataset``."""
    from repro_torch.data import synthetic
    from repro_torch.serving import Request
    cfg = synthetic.EOTaskConfig(image_size=image_size, grid=grid)
    out = []
    for i, (task, taus) in enumerate(task_taus):
        data = synthetic.make_dataset(task, 1, seed=seed + i, cfg=cfg)
        out.append((taus, Request(task=task, image=data["images"][0],
                                  prompt=int(data["prompts"][0]),
                                  t_arrival=float(i))))
    return out


def build_system(sat_cfg, gs_cfg, ac, device, seed: int = 0):
    from repro_torch.core import confidence as C
    from repro_torch.core import eo_adapter as EO
    from repro_torch.core.cascade import TierModel
    sat = TierModel(EO.init_adapter(sat_cfg, ac, seed, device=device),
                    sat_cfg)
    gs = TierModel(EO.init_adapter(gs_cfg, ac, seed + 1, device=device),
                   gs_cfg)
    conf = C.init_confidence(sat_cfg.d_model, sat_cfg.d_model, hidden=64,
                             num_stages=2, seed=seed + 2, device=device)
    return sat, gs, conf


def serve(torch, sat, gs, conf, ac, requests, device, answer_vocab):
    """Serve ``requests`` through ``CascadeServer.handle``; one server per
    tau setting.  Returns [(taus, request, response, seconds)]."""
    from repro_torch.core.cascade import CascadeConfig
    from repro_torch.network.orbit import ContactPlan
    from repro_torch.serving import CascadeServer
    servers, out = {}, []
    for taus, req in requests:
        if taus not in servers:
            servers[taus] = CascadeServer(
                sat, gs, ac, conf,
                CascadeConfig(taus=taus, answer_vocab=answer_vocab),
                plan=ContactPlan(contact_fraction_override=1.0),
                device=device)
        t0 = time.perf_counter()
        resp = servers[taus].handle(req, now=req.t_arrival)
        if device != "cpu":
            torch.cuda.synchronize()
        out.append((taus, req, resp, time.perf_counter() - t0))
    return out


def check_response(req, resp, ac, answer_vocab):
    toks = resp.tokens.reshape(-1)
    if len(toks) != ac.answer_len(req.task):
        raise RuntimeError(f"{req.task}: {len(toks)} answer tokens")
    if toks.min() < 0 or toks.max() >= answer_vocab:
        raise RuntimeError(f"{req.task}: token outside the answer vocab")
    if not (math.isfinite(resp.latency_s) and resp.latency_s > 0):
        raise RuntimeError(f"{req.task}: latency {resp.latency_s}")
    if (resp.tier == "ground") != (resp.tx_bytes > 0):
        raise RuntimeError(f"{req.task}: tier {resp.tier} with "
                           f"{resp.tx_bytes} bytes")


SMALL_TASKS = [("vqa", (0.5, 0.4)), ("cls", (0.5, 0.4)),
               ("det", (0.0, 1.01)), ("vqa", (0.0, 1.01)),
               ("cls", (0.0, 0.0)), ("vqa", (1.01, 0.0))]


def small_reference(torch):
    """The proxy pair on the card against the same weights on the CPU."""
    from repro_torch.configs.spaceverse_pair import proxy_pair
    from repro_torch.core import eo_adapter as EO
    from repro_torch.core.cascade import TierModel
    from repro_torch.tree import tree_map
    sat_cfg, gs_cfg = proxy_pair("small")
    ac = EO.EOAdapterConfig()
    sat, gs, conf = build_system(sat_cfg, gs_cfg, ac, "cpu", seed=5)

    def to_card(tree):
        return tree_map(lambda t: t.to("cuda"), tree)

    card = (TierModel(to_card(sat.params), sat_cfg),
            TierModel(to_card(gs.params), gs_cfg), to_card(conf))
    reqs = make_requests(SMALL_TASKS, ac.image_size, ac.grid, seed=50)
    want = serve(torch, sat, gs, conf, ac, reqs, "cpu", 9)
    got = serve(torch, *card, ac, reqs, "cuda", 9)
    for (taus, req, w, _), (_, _, g, _) in zip(want, got):
        check_response(req, g, ac, 9)
        same = (g.tier == w.tier and g.exit_stage == w.exit_stage
                and (g.tokens == w.tokens).all()
                and math.isclose(g.tx_bytes, w.tx_bytes, rel_tol=1e-6))
        log(f"  small {req.task:3s} taus {taus}: card {g.tier}/"
            f"{g.exit_stage} cpu {w.tier}/{w.exit_stage} "
            f"{'equal' if same else 'DIFFERENT'}")
        if not same:
            raise RuntimeError(f"card and CPU disagree on {req.task} {taus}")
    small_slot_path(torch, sat, gs, card[0], card[1], ac)
    small_quant_path(torch, sat, gs, card[0], card[1], ac)
    small_overload_path(torch, sat, gs, card[0], card[1], ac)
    small_batch_path(torch, (sat, gs, conf), card, ac)
    small_xlstm(torch)
    small_recurrent_path(torch)
    return {(w.tier, w.exit_stage) for _, _, w, _ in want}


def scene_stream(tasks_per_scene, n_scenes, image_size, grid, seed):
    """Requests fanning out over ``n_scenes`` captured scenes: per scene
    the tasks in ``tasks_per_scene``, all on the scene's image (numpy data
    from ``make_dataset``), scene by scene."""
    from repro_torch.data import synthetic
    from repro_torch.serving import Request
    cfg = synthetic.EOTaskConfig(image_size=image_size, grid=grid)
    out = []
    for sc in range(n_scenes):
        data = synthetic.make_dataset("vqa", len(tasks_per_scene),
                                      seed=seed + sc, cfg=cfg)
        for i, task in enumerate(tasks_per_scene):
            out.append(Request(task=task, image=data["images"][0],
                               prompt=int(data["prompts"][i]),
                               scene_id=(seed, sc)))
    return out


def clone_requests(reqs, drafts=None):
    from repro_torch.serving import Request
    return [Request(task=r.task, image=r.image, prompt=r.prompt,
                    scene_id=r.scene_id,
                    draft_tokens=None if drafts is None else drafts[i])
            for i, r in enumerate(reqs)]


def served_tokens(responses, reqs):
    by_id = {r.request_id: r.tokens for r in responses}
    return [by_id[r.request_id] for r in reqs]


def small_slot_path(torch, sat, gs, sat_card, gs_card, ac):
    """``InferenceEngine.serve`` on the paged slot path, the vmap oracle, a
    γ = 3 speculative engine drafted by the satellite tier, and chunked
    prefill (chunk 8, the whole N_r, and chunk 8 under γ = 3): the same
    tokens on the card as on the CPU, equal to the plain engine's; the
    paged engines hit the prefix cache as often as the plain one.  Every
    card engine is warmed up and runs captured steps (no capture after
    warmup), and the plain flavour runs once more on the card with eager
    steps."""
    from repro_torch.serving import EngineConfig, InferenceEngine
    reqs = scene_stream(["det", "vqa", "cls", "vqa"], 3, ac.image_size,
                        ac.grid, seed=70)
    greedy, prefix = {}, {}
    for kw in ({}, {"step_impl": "vmap"}, {"spec_gamma": 3},
               {"prefill_chunk": 8}, {"prefill_chunk": ac.n_regions},
               {"prefill_chunk": 8, "spec_gamma": 3}):
        spec = kw.get("spec_gamma", 0)
        runs = [("cpu", gs, sat, True), ("cuda", gs_card, sat_card, True)]
        if not kw:
            runs.append(("cuda", gs_card, sat_card, False))
        for dev, tier, draft, graphs in runs:
            eng = InferenceEngine(
                tier.params, tier.cfg, ac,
                EngineConfig(slots=3, answer_vocab=9, cuda_graphs=graphs,
                             **kw),
                draft=draft if spec else None, device=dev)
            eng.warmup()
            rs = clone_requests(reqs)
            toks = served_tokens(eng.serve(rs), rs)
            st = eng.core.stats
            hits = (st["prefix_hits"], st["prefix_misses"])
            greedy.setdefault(dev, toks)
            prefix.setdefault(dev, hits)
            same = all((a == b).all() for a, b in zip(toks, greedy["cpu"]))
            gst = eng.core.graph_stats()
            recompiles = eng.core.scheduler_stats()["steady_recompiles"]
            log(f"  small slot path {kw or 'plain'} on {dev}"
                f"{'' if graphs else ' (eager steps)'}: {len(toks)} "
                f"requests, prefix hits/misses {hits}, "
                f"{'equal to' if same else 'DIFFERENT from'} the CPU "
                f"greedy tokens; {gst['graphs']} graphs, {gst['replays']} "
                f"replays, {recompiles} captures after warmup")
            if not same:
                raise RuntimeError(f"slot path {kw} on {dev} disagrees with "
                                   "the CPU greedy tokens")
            if hits != prefix[dev] and eng.core.cache_impl == "paged":
                raise RuntimeError(f"slot path {kw} on {dev}: prefix "
                                   f"hits/misses {hits}, the plain engine's "
                                   f"{prefix[dev]}")
            captured = dev == "cuda" and graphs
            if (gst["captured"] != captured or recompiles
                    or (gst["graphs"] > 0) != captured
                    or (gst["replays"] > 0) != captured):
                raise RuntimeError(f"slot path {kw} on {dev}: graphs "
                                   f"{gst}, {recompiles} captures after "
                                   "warmup")


def step_share(a, b, kind):
    """(largest distance, count of values one quantization step or more
    apart) between two stored 8-bit leaves: int8 by value, e4m3 by code in
    value order (+0 and -0 both 0)."""
    import torch
    if kind == "int8":
        d = (a.to(torch.int32) - b.to(torch.int32)).abs()
    else:
        def rank(x):
            u = x.view(torch.uint8).to(torch.int32)
            return torch.where(u >= 128, -(u - 128), u)
        d = (rank(a) - rank(b)).abs()
    return int(d.max()), int((d > 0).sum())


def small_quant_path(torch, sat, gs, sat_card, gs_card, ac):
    """The quantized slot path on the small proxies (f32, so the paged
    kernels run on their CUDA-core route): ``InferenceEngine.serve`` with
    ``kv_dtype`` int8 and fp8, plain, γ = 3 speculative and chunked (chunk
    8), on the card and on the CPU from the same weights: the same tokens
    and prefix counters, the same pages, and stored values at most one
    quantization step apart (the two devices' f32 K/V differ by rounding;
    the share one step apart is printed), the trash page aside."""
    from repro_torch.serving import EngineConfig, InferenceEngine
    reqs = scene_stream(["det", "vqa", "cls", "vqa"], 3, ac.image_size,
                        ac.grid, seed=70)
    for kind in QUANT_POOLS:
        for kw in ({}, {"spec_gamma": 3}, {"prefill_chunk": 8}):
            runs = {}
            for dev, tier, draft in (("cpu", gs, sat),
                                     ("cuda", gs_card, sat_card)):
                eng = InferenceEngine(
                    tier.params, tier.cfg, ac,
                    EngineConfig(slots=3, answer_vocab=9, kv_dtype=kind,
                                 **kw),
                    draft=draft if kw.get("spec_gamma") else None,
                    device=dev)
                rs = clone_requests(reqs)
                toks = served_tokens(eng.serve(rs), rs)
                st, kv = eng.core.stats, eng.core.kv_stats()
                runs[dev] = (toks, (st["prefix_hits"], st["prefix_misses"],
                                    kv["pages_in_use"], kv["n_pages"]),
                             eng.core._slot_cache)
            (ct, cc, cpools), (gt, gc, gpools) = runs["cpu"], runs["cuda"]
            same = all((a == b).all() for a, b in zip(gt, ct))
            worst = apart = total = 0
            for cl, gl in zip(cpools, gpools):
                for name in ("k", "v"):
                    d, n = step_share(cl[name][:, 1:], gl[name][:, 1:].cpu(),
                                      kind)
                    worst, apart = max(worst, d), apart + n
                    total += cl[name][:, 1:].numel()
            log(f"  small quantized slot path {kind} {kw or 'plain'}: "
                f"{len(gt)} requests, tokens {'equal' if same else 'DIFFERENT'}"
                f" on the card and the CPU, counters card {gc} cpu {cc}, "
                f"stored values {apart} of {total} one step apart "
                f"({apart / total:.2e}), largest distance {worst}")
            if not same or gc != cc or worst > 1:
                raise RuntimeError(f"quantized slot path {kind} {kw}: card "
                                   f"and CPU disagree")


# the overload scenario's engines on the small proxies: (tag, config)
SMALL_OVERLOAD = (("paged", {}), ("chunk8", {"prefill_chunk": 8}),
                  ("spec3", {"spec_gamma": 3}), ("int8", {"kv_dtype": "int8"}))


def port_serving(gs, sat, ac):
    """The port's serving API as ``overload_saturation`` takes it: the
    engine classes, the urgent priority, the trash page, the ground tier
    ``gs``, its draft ``sat`` and the adapter config ``ac``."""
    import types
    from repro_torch import serving
    from repro_torch.serving.kv_pool import TRASH_PAGE
    return types.SimpleNamespace(
        Request=serving.Request, Core=serving.EngineCore,
        CoreConfig=serving.EngineCoreConfig, Overload=serving.OverloadConfig,
        PRIORITY_URGENT=serving.PRIORITY_URGENT, TRASH_PAGE=TRASH_PAGE,
        gs=gs, sat=sat, ac=ac)


def overload_saturation(pkg, images, kw, answer_vocab: int = 9):
    """The overload scenario on one engine of ``pkg`` (``port_serving``'s
    namespace, or the same API of another package): 4 slots of the tier
    ``pkg.gs`` (drafted by ``pkg.sat`` when ``kw`` asks for ``spec_gamma``),
    a queue of 4, a pool of 1 + 3P + 3S pages (P private, S shared pages a
    slot; a dense engine has none); 4 bulk det (2 on scene 0, 2 on 1),
    6 steps, then 2 urgent vqa on scene 2, a bulk vqa on scene 4 whose
    deadline only an explicit ``now`` reaches, a burst of 5 bulk cls on
    scene 3, a pump past that deadline, and the drain.  Each preempted
    request's committed tokens are recorded as ``_preempt_one`` releases
    its slot.  Returns what two runs must agree on: each submit call's
    outcomes, the rejections with reasons after each call and step, the
    finished order and tokens, the engine counters, the overload counts
    (no milliseconds) and the pages, the preempted requests' tokens, each
    request's (task, scene, prompt), and whether the paged pool drained
    to its resident prefixes (refcount 1 each) with the block table all
    trash page."""
    import numpy as np
    cfg = dict(slots=4, answer_vocab=answer_vocab, **kw)
    draft = pkg.sat if kw.get("spec_gamma") else None
    if kw.get("cache_impl") != "dense":
        probe = pkg.Core(pkg.gs, pkg.ac, pkg.CoreConfig(**cfg), draft=draft)
        cfg["pool_pages"] = (1 + 3 * probe._private_per_slot
                             + 3 * probe._n_shared_pages)
    core = pkg.Core(pkg.gs, pkg.ac, pkg.CoreConfig(
        overload=pkg.Overload(queue_cap=4), **cfg), draft=draft)
    preempted, release, preempt = [], core._release_slot, core._preempt_one

    def preempt_one(above, now):
        def release_and_record(i):
            sl = core._slots[i]
            preempted.append((sl.request.request_id,
                              [int(x) for x in sl.tokens]))
            release(i)
        core._release_slot = release_and_record
        try:
            return preempt(above, now)
        finally:
            core._release_slot = release

    core._preempt_one = preempt_one

    def req(rid, task, scene, prompt=0, priority=0, deadline_s=None):
        return pkg.Request(task=task, image=images[scene], prompt=prompt,
                           scene_id=scene, request_id=rid, priority=priority,
                           deadline_s=deadline_s)

    def took():
        return [(r.request_id, why) for r, why in core.take_rejected()]

    far, t0 = 1e5, 1000.0
    det = [req(100 + i, "det", i // 2, i % 2) for i in range(4)]
    calls = [core.submit_many(det, now=t0)]
    finished, tokens = [], {}

    def step():
        for r, t in core.step():
            finished.append(r.request_id)
            tokens[r.request_id] = [int(x) for x in t]

    for _ in range(6):
        step()
    urgent = [req(110 + i, "vqa", 2, i, pkg.PRIORITY_URGENT)
              for i in range(2)]
    late = req(120, "vqa", 4, deadline_s=far)
    burst = [req(130 + i, "cls", 3, i % 3) for i in range(5)]
    calls += [core.submit_many(urgent, now=t0 + 1),
              core.submit_many([late], now=t0 + 1),
              core.submit_many(burst, now=t0 + 1)]
    rejected = [took()]
    calls.append(core.submit_many([], now=t0 + 1 + 2 * far))  # 120 expires
    rejected.append(took())
    for _ in range(2000):
        step()
        rejected.append(took())
        if core.active_count() == 0 and core.queue_depth() == 0:
            break
    else:
        raise RuntimeError(f"overload scenario {kw}: the engine did not "
                           f"drain")
    ol = dict(core.scheduler_stats()["overload"])
    ol["readmit_wait_ms"] = ol["readmit_wait_ms"]["n"]
    ol["ttft_by_priority"] = {p: v["n"]
                              for p, v in ol["ttft_by_priority"].items()}
    state = {k: core.stats[k] for k in (
        "prefix_hits", "prefix_misses", "prefill_tokens", "prefill_by_kind",
        "mid_stream_refills", "admitted", "finished")}
    state.update(overload=ol, steps=core.stats["sched"]["steps"],
                 fused_steps=core.stats["sched"]["fused_steps"])
    drained = True
    if core.cache_impl == "paged":
        kv, prefix = core.kv_stats(), core._prefix
        state.update({k: kv[k] for k in (
            "pages_in_use", "n_pages", "prefix_entries",
            "prefix_entries_in_use", "prefix_shared_pages")})
        drained = (kv["prefix_entries_in_use"] == 0
                   and kv["pages_in_use"] == kv["prefix_shared_pages"]
                   and all(core._pool.refcount(p) == 1
                           for e in prefix._entries.values()
                           for p in e.pages)
                   and bool((np.asarray(core._bt_np)
                             == pkg.TRASH_PAGE).all()))
    asked = {r.request_id: (r.task, r.scene_id, r.prompt)
             for r in det + urgent + [late] + burst}
    return {"calls": calls, "rejected": rejected, "finished": finished,
            "tokens": tokens, "state": state, "preempted": preempted,
            "asked": asked, "drained": drained}


def small_overload_path(torch, sat, gs, sat_card, gs_card, ac):
    """Overload control on the small proxies (f32): the saturation scenario
    (``overload_saturation``) on the paged, chunked (8), γ 3 speculative
    and int8 engines of the ground tier (the satellite tier drafts), on
    the card and on the CPU from the same weights: equal outcomes,
    rejections, finished order and tokens, overload counts, counters and
    pages; at least one preemption, one ``queue_full`` and one
    ``expired``, and the pool drained."""
    from repro_torch.data import synthetic
    images = synthetic.make_dataset(
        "cls", 5, seed=90, cfg=synthetic.EOTaskConfig(
            image_size=ac.image_size, grid=ac.grid))["images"]
    cpu, card = port_serving(gs, sat, ac), port_serving(gs_card, sat_card, ac)
    for tag, kw in SMALL_OVERLOAD:
        want = overload_saturation(cpu, images, kw)
        got = overload_saturation(card, images, kw)
        ol, same = got["state"]["overload"], got == want
        log(f"  small overload {tag}: card "
            f"{'equal to' if same else 'DIFFERENT from'} the CPU; "
            f"finished {got['finished']}, preemptions "
            f"{ol['preemptions']}, rejections {ol['rejections']}, deferred "
            f"{ol['admissions_deferred']}, pages in use "
            f"{got['state']['pages_in_use']} of {got['state']['n_pages']}")
        if not same:
            raise RuntimeError(f"overload {tag}: card and CPU disagree: "
                               f"{got} against {want}")
        if not (ol["preemptions"] >= 1 and ol["rejections"]["queue_full"] >= 1
                and ol["rejections"]["expired"] == 1 and got["drained"]):
            raise RuntimeError(f"overload {tag}: no preemption, queue_full "
                               f"or expiry, or the pool did not drain: {ol}")


def weights_device(tier) -> str:
    return tier.params["patch_proj"].device.type


def to_np(x):
    import numpy as np
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


#: how the card's batch-path results are held to the CPU's (phase 3):
#: decisions, tokens and predictions exact; bytes, latencies and kept
#: fractions 1e-6 relative; scores, probabilities and region scores to
#: float32 attention's tolerance
BATCH_EXACT = ("pred", "offload", "exit_stage", "sat_pred", "gs_pred")
BATCH_RELATIVE = ("tx_bytes", "latency_s", "kept_frac")
BATCH_CLOSE = ("conf_scores", "sat_probs", "gs_probs", "region_scores")


def batch_diffs(got, want):
    """{key: problem} of a card run against the CPU run of the same batch;
    empty when they agree."""
    import numpy as np
    bad = {}
    if set(got) != set(want):
        bad["keys"] = sorted(set(got) ^ set(want))
    for key in set(got) & set(want):
        g, w = to_np(got[key]), to_np(want[key])
        if g.shape != w.shape:
            bad[key] = f"shape {g.shape} against {w.shape}"
        elif key in BATCH_EXACT:
            if not np.array_equal(g, w):
                bad[key] = f"{int((g != w).sum())} elements differ"
        elif key in BATCH_RELATIVE:
            if not np.allclose(g, w, rtol=1e-6, atol=0):
                bad[key] = f"max rel {np.max(np.abs(g - w) / np.abs(w))}"
        elif key in BATCH_CLOSE:
            err = float(np.max(np.abs(g.astype(np.float64) - w)))
            if not err <= TOL_F32[0]:
                bad[key] = f"max abs {err}"
    return bad


SMALL_SPEC_TASKS = [("vqa", (0.0, 1.01)), ("det", (0.0, 1.01)),
                    ("cls", (1.01, 0.0)), ("det", (0.5, 0.4))]


def small_batch_path(torch, cpu, card, ac, b: int = 4):
    """The batch evaluator (``SpaceVerse.run_batch``, vqa/cls/det at B
    ``b``), the four baselines at their deterministic settings and the
    speculative cascade server (γ 3; a det request offloaded at stage 1,
    whose onboard answer rides the downlink as drafts) on the card against
    the same weights on the CPU (``batch_diffs``; for the server: tiers,
    exit stages and tokens equal, bytes and latencies within 1e-6
    relative, equal ``spec_stats()`` with piggybacked drafts)."""
    from repro_torch.baselines import AIRG, GSOnly, SatelliteOnly, Tabi
    from repro_torch.core.cascade import CascadeConfig, SpaceVerse
    from repro_torch.data import synthetic
    from repro_torch.network.orbit import ContactPlan
    from repro_torch.serving import CascadeServer
    cc = CascadeConfig(answer_vocab=9)
    systems = {"cpu": cpu, "card": card}
    for i, task in enumerate(("vqa", "cls", "det")):
        data = synthetic.make_dataset(task, b, seed=60 + i)
        outs = {}
        for where, (sat, gs, conf) in systems.items():
            dev = weights_device(sat)
            im = torch.from_numpy(data["images"]).to(dev)
            pr = torch.from_numpy(data["prompts"]).to(dev)
            outs[where] = {
                "SpaceVerse": SpaceVerse(sat, gs, ac, conf, cc, device=dev)
                .run_batch(task, im, pr),
                "SatelliteOnly": SatelliteOnly(sat, ac, cc, device=dev)
                .run_batch(im, pr, task),
                "GSOnly": GSOnly(gs, ac, cc, device=dev)
                .run_batch(im, pr, task),
                "Tabi": Tabi(sat, gs, ac, cc, device=dev)
                .run_batch(im, pr, task),
                **{f"AIRG {rho}": AIRG(sat, gs, ac, cc, offload_fraction=rho,
                                       device=dev).run_batch(im, pr, task)
                   for rho in (0.0, 1.0)}}
        for name, want in outs["cpu"].items():
            bad = batch_diffs(outs["card"][name], want)
            log(f"  small batch {name} {task} B{b}: offloads "
                f"{int(to_np(want.get('offload', [])).sum())}, card "
                f"{'equal to' if not bad else 'DIFFERENT from'} the CPU "
                f"{bad or ''}")
            if bad:
                raise RuntimeError(f"batch path {name} {task}: card and CPU "
                                   f"disagree: {bad}")
    reqs = make_requests(SMALL_SPEC_TASKS, ac.image_size, ac.grid, seed=80)
    served, stats = {}, {}
    for where, (sat, gs, conf) in systems.items():
        server = CascadeServer(
            sat, gs, ac, conf, cc, spec_gamma=3, device=weights_device(sat),
            plan=ContactPlan(contact_fraction_override=1.0))
        server.warmup()
        served[where] = []
        for taus, req in reqs:
            server.cc = CascadeConfig(taus=taus, answer_vocab=9)
            served[where].append(server.handle(req, now=req.t_arrival))
        stats[where] = server._gs_spec_core.spec_stats()
    for (taus, req), g, w in zip(reqs, served["card"], served["cpu"]):
        check_response(req, g, ac, 9)
        same = (g.tier == w.tier and g.exit_stage == w.exit_stage
                and (g.tokens == w.tokens).all()
                and math.isclose(g.tx_bytes, w.tx_bytes, rel_tol=1e-6)
                and math.isclose(g.latency_s, w.latency_s, rel_tol=1e-6))
        log(f"  small spec server (γ 3) {req.task:3s} taus {taus}: card "
            f"{g.tier}/{g.exit_stage} cpu {w.tier}/{w.exit_stage} "
            f"{'equal' if same else 'DIFFERENT'}")
        if not same:
            raise RuntimeError(f"spec server: card and CPU disagree on "
                               f"{req.task} {taus}")
    log(f"  small spec server spec_stats card {stats['card']}")
    if stats["card"] != stats["cpu"] or not stats["card"]["piggybacked"]:
        raise RuntimeError(f"spec server: spec_stats card {stats['card']}, "
                           f"cpu {stats['cpu']} (piggybacked drafts wanted)")


def small_xlstm(torch, steps: int = 16):
    """The reduced xlstm-125m (6 layers, d 64, f32) on the card against
    the same weights on the CPU: a 128-token prefill (two 64-token chunks)
    and ``steps`` greedy decode steps give the same tokens."""
    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    cfg = configs.get_config("xlstm-125m", reduced=True)
    params = T.init_params(cfg, seed=3, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 128),
                         generator=torch.Generator().manual_seed(4),
                         dtype=torch.int32)
    outs = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        logits, cache, idx = T.prefill(p, cfg, {"tokens": toks.to(dev)},
                                       128 + steps)
        first = logits.cpu()
        seq = [logits.argmax(-1).to(torch.int32)]
        for i in range(steps):
            logits, cache = T.decode_step(p, cfg, cache,
                                          {"tokens": seq[-1][:, None]},
                                          idx + i)
            seq.append(logits.argmax(-1).to(torch.int32))
        outs[dev] = (first, torch.stack(seq, 1).cpu())
    diff = float((outs["cuda"][0] - outs["cpu"][0]).abs().max())
    same = bool((outs["cuda"][1] == outs["cpu"][1]).all())
    log(f"  small xlstm (reduced, f32): prefill logits max |card - cpu| "
        f"{diff:.2e}; {steps} greedy tokens "
        f"{'equal' if same else 'DIFFERENT'}")
    if not same:
        raise RuntimeError("xlstm greedy tokens differ between card and CPU")


#: phase 3's recurrent tiers (reduced xlstm-125m overrides, vision
#: frontend, f32): the xLSTM alone, and attention beside mLSTM and sLSTM
SMALL_RECURRENT = {"xlstm": {},
                   "mixed": {"num_layers": 3,
                             "block_pattern": ("attn", "mlstm", "slstm")}}
#: the engines phase 3 serves them on
SMALL_RECURRENT_ENGINES = ({}, {"kv_dtype": "int8"}, {"cache_impl": "dense"},
                           {"step_impl": "vmap"})


def recurrent_cfg(name, **over):
    """The reduced xlstm-125m with the vision frontend and the overrides of
    ``SMALL_RECURRENT[name]`` (block kinds by name)."""
    from repro_torch import configs
    from repro_torch.configs.base import BlockSpec
    over = dict(SMALL_RECURRENT[name], frontend="vision", **over)
    if "block_pattern" in over:
        over["block_pattern"] = tuple(BlockSpec(kind=k)
                                      for k in over["block_pattern"])
    return configs.reduced_config(configs.get_config("xlstm-125m"), **over)


def small_recurrent_path(torch):
    """The engine's recurrent-state admission on the small tiers (f32, so
    the scans take their CUDA-core and per-row routes, the mixed stack's
    attention its CUDA-core routes): ``InferenceEngine.serve`` of a
    det/vqa/cls stream over three scenes on 3 slots, on the paged,
    int8-pool and dense engines and the vmap oracle, on the card (warmed
    up, captured) and on the CPU from the same weights: the same tokens
    and prefix hits/misses, and on the card graphs replayed and none
    captured after warmup."""
    from repro_torch.core import eo_adapter as EO
    from repro_torch.serving import EngineConfig, InferenceEngine
    from repro_torch.tree import tree_map
    ac = EO.EOAdapterConfig()
    reqs = scene_stream(["det", "vqa", "cls", "vqa"], 3, ac.image_size,
                        ac.grid, seed=80)
    for name in SMALL_RECURRENT:
        cfg = recurrent_cfg(name)
        params = EO.init_adapter(cfg, ac, 11, device="cpu")
        on = {"cpu": params,
              "cuda": tree_map(lambda t: t.to("cuda"), params)}
        for kw in SMALL_RECURRENT_ENGINES:
            runs = {}
            for dev, p in on.items():
                eng = InferenceEngine(p, cfg, ac, EngineConfig(
                    slots=3, answer_vocab=9, **kw), device=dev)
                eng.warmup()
                rs = clone_requests(reqs)
                toks = served_tokens(eng.serve(rs), rs)
                st = eng.core.stats
                runs[dev] = (toks, (st["prefix_hits"], st["prefix_misses"]),
                             eng.core.graph_stats(),
                             eng.core.scheduler_stats()["steady_recompiles"])
            (ct, cc, _, _), (gt, gc, gst, rec) = runs["cpu"], runs["cuda"]
            same = (all((a == b).all() for a, b in zip(gt, ct))
                    and len(gt) == len(reqs))
            log(f"  small recurrent {name} {kw or 'paged'}: {len(gt)} "
                f"requests, tokens {'equal' if same else 'DIFFERENT'} on "
                f"the card and the CPU, prefix hits/misses card {gc} cpu "
                f"{cc}; {gst['graphs']} graphs, {gst['replays']} replays, "
                f"{rec} captures after warmup")
            if not (same and gc == cc and gst["graphs"] > 0
                    and gst["replays"] > 0 and rec == 0):
                raise RuntimeError(f"recurrent slot path {name} {kw}: card "
                                   "and CPU disagree, or the card's steps "
                                   "were not captured in warmup")


MAIN_TASKS = [("vqa", (0.5, 0.4)), ("cls", (0.5, 0.4)),
              ("vqa", (0.0, 1.01)), ("cls", (0.0, 0.0)),
              ("vqa", (1.01, 0.0)), ("det", (1.01, 0.0))]


def main_path(torch):
    from repro_torch.configs.spaceverse_pair import GS_CONFIG, SAT_CONFIG
    from repro_torch.core import eo_adapter as EO
    from repro_torch.kernels import ops
    from repro_torch.tree import tree_leaves
    ac = EO.EOAdapterConfig(grid=FULL_GRID, image_size=FULL_IMAGE)
    assert ac.n_regions == SAT_CONFIG.num_patches == GS_CONFIG.num_patches
    t0 = time.perf_counter()
    sat, gs, conf = build_system(SAT_CONFIG, GS_CONFIG, ac, "cuda")
    torch.cuda.synchronize()
    n_sat = sum(t.numel() for t in tree_leaves(sat.params))
    n_gs = sum(t.numel() for t in tree_leaves(gs.params))
    log(f"init {SAT_CONFIG.name} {n_sat / 1e9:.3f} B params, "
        f"{GS_CONFIG.name} {n_gs / 1e9:.3f} B params, bf16, "
        f"{time.perf_counter() - t0:.1f} s; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    reqs = make_requests(MAIN_TASKS, FULL_IMAGE, FULL_GRID, seed=100)
    answer_vocab = ac.num_classes + 1

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with PrefillCounter() as prefills:
        results, path_in = capture_inputs(
            torch, lambda: serve(torch, sat, gs, conf, ac, reqs, "cuda",
                                 answer_vocab),
            ["flash_attention", "region_score"])
    torch.cuda.synchronize()
    counts = ops.launch_counts()

    for taus, req, resp, sec in results:
        check_response(req, resp, ac, answer_vocab)
        log(f"  main {req.task:3s} taus {taus}: tier {resp.tier:9s} "
            f"exit {resp.exit_stage:2d} tokens {len(resp.tokens.reshape(-1))}"
            f" tx_bytes {resp.tx_bytes:.0f} wall {sec:.3f} s")
    tiers = {resp.tier for _, _, resp, _ in results}
    if tiers != {"satellite", "ground"}:
        raise RuntimeError(f"main path reached only {tiers}")
    log(f"  launches in the main path: {counts}")
    missing = [k for k in ("flash_attention_wgmma", "decode_attention_mma",
                           "region_score") if counts[k] == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the main path: "
                           f"{missing}")
    prefills.check(counts, "main path")
    ok, by_route = decode_routes(counts, "mma", need=("decode_attention",))
    log(f"  main path: decode launches by route {by_route}")
    if not ok:
        raise RuntimeError(f"main path: decode left the tensor-core route: "
                           f"{by_route}")
    held = {"flash_attention_wgmma": flash_on_path_inputs(
                path_in["flash_attention"]),
            "region_score": region_on_path_inputs(path_in["region_score"])}
    return sat, gs, conf, ac, counts, held, results


def flash_on_path_inputs(calls, phase: int = 4):
    """The tensor-core flash route held to its bound on the path's own
    prefill inputs (the first layer's Q/K/V at each shape the path gave
    it), after the path's counts were read.  Returns {case: numbers}."""
    from repro_torch.kernels import ops
    errors, out = [], {}
    log(f"flash_attention on phase {phase}'s own prefill inputs (wgmma "
        f"route)")
    for (q, k, v), kw in calls:
        case = (f"phase {phase} prefill B{q.shape[0]} H{q.shape[2]} "
                f"KH{k.shape[2]} Sq{q.shape[1]} Skv{k.shape[1]}")
        err, share = check_wgmma("flash_attention",
                                 ops.flash_attention(q, k, v, **kw), q, k, v,
                                 kw, case, errors)
        out[case] = {"max_abs_err": err, "tolerance_share": share}
    if errors:
        raise RuntimeError(f"phase {phase}: flash outside its bound on the "
                           f"path's own inputs: {errors}")
    return out


def region_on_path_inputs(calls, phase: int = 4):
    """The region score held against its plain version on the path's own
    Eq. 2 inputs (the offload's (B, R, 1, D) view of the region features
    and the text features, the first call at each shape), after the path's
    counts were read.  Returns {case: numbers}."""
    from repro_torch.kernels import ops, ref
    errors, out = [], {}
    log(f"region_score on phase {phase}'s own offload inputs")
    for (v, e), kw in calls:
        case = (f"phase {phase} offload B{v.shape[0]} R{v.shape[1]} "
                f"Nv{v.shape[2]}"
                f" Ne{e.shape[1]} D{v.shape[3]} strides {v.stride()}")
        out[case] = {"max_abs_err": check(
            "region_score", ops.region_score(v, e), ref.region_score(v, e),
            TOL_REGION, case, errors)}
    if not calls:
        errors.append("no region score call was captured")
    if errors:
        raise RuntimeError(f"phase {phase}: region score outside its "
                           f"tolerance on the path's own inputs: {errors}")
    return out


#: the ``ops`` entries of the dense and the paged decode kernels
DENSE_DECODE_OPS = ("decode_attention", "multi_decode_attention")
PAGED_DECODE_OPS = ("paged_decode_attention", "paged_multi_decode_attention")


def decode_on_path_inputs(calls, phase: int, what: str,
                          need=DENSE_DECODE_OPS[:1]):
    """The tensor-core decode route held to its bound on a path's own
    inputs: the first call of each decode op in ``calls`` ({op: captured
    calls}) at each shape the path gave it, paged pools gathered into the
    plain version's dense operands, after the path's counts were read.
    Fails unless some op of ``need`` was captured.  Returns {case:
    numbers}."""
    from repro_torch.kernels import ops, ref
    errors, out = [], {}
    log(f"decode attention on phase {phase}'s own {what} inputs (mma "
        f"route)")
    for name, got_calls in calls.items():
        for args, kw in got_calls:
            got = getattr(ops, name)(*args, **kw)
            kw = dict(kw)
            ks, vs = kw.pop("k_scale", None), kw.pop("v_scale", None)
            q, *rest = args
            if q.dim() == 3:            # one token a row: (B, H, hd)
                q, got = q[:, None], got[:, None]
            if name in PAGED_DECODE_OPS:
                # an 8-bit pool dequantized: the plain version's operands
                k_pool, v_pool, table, lens = rest
                k = ref.gather_pages(ref.dequantize_pool(k_pool, ks), table)
                v = ref.gather_pages(ref.dequantize_pool(v_pool, vs), table)
            else:
                k, v, lens = rest
            case = (f"phase {phase} {what} B{q.shape[0]} T{q.shape[1]} "
                    f"H{q.shape[2]} KH{k.shape[2]} S{k.shape[1]}")
            err, share = check_mma_decode(name, got, q, k, v, lens, kw, case,
                                          errors)
            out[f"{name} {case}"] = {"max_abs_err": err,
                                     "tolerance_share": share}
    if not any(calls.get(n) for n in need):
        errors.append(f"none of {need} was captured")
    if errors:
        raise RuntimeError(f"phase {phase}: decode outside its bound on the "
                           f"{what}'s own inputs: {errors}")
    return out


#: the engines' step families that run a model prefill: the tier's, or
#: the drafter's
PREFILL_FAMILIES = {"prefix_prefill": "tier", "dense_admit": "tier",
                    "draft_prefill": "draft"}


class PrefillCounter:
    """While active, counts the model prefills that ran and the attention
    layers they ran (every layer of the Qwen2-VL tiers is one): the calls
    of ``transformer.prefill`` that launched their kernels (not those a
    CUDA-graph capture records), and the replays of an engine's captured
    prefill steps (``PREFILL_FAMILIES``; a replay runs no Python).
    ``check`` holds a path's flash launches to them: the tensor-core route
    once per prefill layer (bf16, hd 128), the CUDA-core route never."""

    def __enter__(self):
        import torch
        from repro_torch.models import transformer as T
        from repro_torch.serving import graphs
        self.T, self.orig = T, T.prefill
        self.graphs, self.orig_run = graphs, graphs.StepGraphs.run
        self.calls = self.layers = 0

        def prefill(params, cfg, *a, **kw):
            if not (torch.cuda.is_available()
                    and torch.cuda.is_current_stream_capturing()):
                self.calls += 1
                self.layers += cfg.num_layers
            return self.orig(params, cfg, *a, **kw)

        counter, orig_run = self, self.orig_run

        def run(self, name, key, body):
            fam = self.families[name]
            replays = fam.replays
            orig_run(self, name, key, body)
            if name in PREFILL_FAMILIES and fam.replays > replays:
                core = body.func.__self__          # partial(core._..._body)
                model = (core.tier if PREFILL_FAMILIES[name] == "tier"
                         else core.draft)
                counter.calls += 1
                counter.layers += model.cfg.num_layers

        T.prefill = prefill
        graphs.StepGraphs.run = run
        return self

    def __exit__(self, *exc):
        self.T.prefill = self.orig
        self.graphs.StepGraphs.run = self.orig_run

    def check(self, counts, path):
        from repro_torch.kernels import ops
        by_route = ops.launches_by_route(counts, "flash_attention")
        wg, cc = by_route["wgmma"], by_route["cuda_cores"]
        log(f"  {path}: {self.calls} prefills over {self.layers} layers; "
            f"flash launches wgmma {wg}, CUDA cores {cc}")
        if not (self.calls > 0 and wg == self.layers and cc == 0):
            raise RuntimeError(f"{path}: flash launched {wg} times on the "
                               f"tensor cores and {cc} on the CUDA cores, "
                               f"want {self.layers} (layers x prefills) and "
                               f"0")


DECODE_KERNELS = ("decode_attention", "paged_decode_attention")


def decode_routes(counts, route, need=DECODE_KERNELS):
    """The decode kernels' launches in ``counts`` by route, and whether the
    path kept to ``route`` ("mma" at full width, bf16 hd 128; "cuda_cores"
    on phase 3's f32 proxies): none on the other route, some on ``route``
    for each kernel in ``need``."""
    from repro_torch.kernels import ops
    by_route = {n: ops.launches_by_route(counts, n) for n in DECODE_KERNELS}
    other = "cuda_cores" if route == "mma" else "mma"
    ok = (all(r[other] == 0 for r in by_route.values())
          and all(by_route[n][route] > 0 for n in need))
    return ok, by_route


class StepProbe:
    """Instruments one ``EngineCore`` for a phase: counts admission calls,
    times every step on the host clock (each step ends in its one token
    fetch, so the clock covers the device work), notes per step whether it
    was a fused (chunked-prefill) step and how many slots were decoding
    before it, stamps the host time at which each request received tokens,
    and profiles steps [``first``, ``first + n``) with ``torch.profiler``."""

    def __init__(self, torch, core, first: int = 64, n: int = 8):
        from torch.profiler import ProfilerActivity, profile
        self.torch, self.core = torch, core
        self.admissions, self.step_s = 0, []
        self.fused, self.decoding, self.emitted = [], [], {}
        self.first, self.n = first, n
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.window_s = 0.0
        step, admit = core.step, core.admit_many

        def admit_many(requests):
            self.admissions += 1
            return admit(requests)

        def timed_step():
            k = len(self.step_s)
            if k == self.first:
                torch.cuda.synchronize()
                self.prof.start()
            before = {sl.request.request_id: len(sl.tokens)
                      for sl in core._slots if sl.active}
            self.decoding.append(sum(sl.active and sl.phase == "decode"
                                     for sl in core._slots))
            fused0 = core.stats["sched"]["fused_steps"]
            t0 = time.perf_counter()
            out = step()
            t1 = time.perf_counter()
            self.step_s.append(t1 - t0)
            self.fused.append(core.stats["sched"]["fused_steps"] > fused0)
            got = {r.request_id for r, _ in out}
            got.update(sl.request.request_id for sl in core._slots
                       if sl.active and len(sl.tokens)
                       > before.get(sl.request.request_id, 0))
            for rid in got:
                self.emitted.setdefault(rid, []).append((t1, k))
            if self.first <= k < self.first + self.n:
                self.window_s += self.step_s[-1]
            if k == self.first + self.n - 1:
                torch.cuda.synchronize()
                self.prof.stop()
            return out

        core.admit_many, core.step = admit_many, timed_step

    def max_token_gap_ms(self, requests):
        """The longest host-clock gap between two consecutive token
        emissions of any of ``requests`` (an admission between two steps
        counts in it).  Gaps that end in a profiled step, or just after
        the window (the profiler's start and stop fall there), are left
        out."""
        skip = range(self.first, self.first + self.n + 1)
        gaps = [tb - ta for r in requests
                for (ta, _), (tb, kb) in zip(self.emitted.get(r.request_id, []),
                                             self.emitted.get(r.request_id,
                                                              [])[1:])
                if kb not in skip]
        return 1e3 * max(gaps) if gaps else None

    def profile(self):
        """``profile_summary`` of the profiled steps; None when fewer steps
        ran."""
        if len(self.step_s) < self.first + self.n:
            return None
        return profile_summary(self.torch, self.prof, self.n, self.window_s)


def profile_summary(torch, prof, n_steps: int, seconds: float, k: int = 6):
    """From a ``torch.profiler`` run over ``n_steps`` steps that took
    ``seconds`` on the host clock: the device's busy share, the device's
    time per step, the ``k`` device operations (kernels, copies) with the
    most device time as [name, launches, ms a step], longest first, and
    the top host operations in ms per step."""
    events = prof.key_averages()

    def dev_us(e):   # the attribute's name differs across versions
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    # Only the device's own events (kernels, copies): a CPU op such as
    # aten::mm also carries its kernels' time as self device time, so
    # summing every event would count that work twice.
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    top_dev = sorted(kernels, key=lambda e: -dev_us(e))[:k]
    top_host = sorted(events, key=lambda e: -e.self_cpu_time_total)[:6]
    per = 1e3 * n_steps
    return {"device_busy_share":
            sum(dev_us(e) for e in kernels) / 1e6 / seconds,
            "device_ms_per_step": sum(dev_us(e) for e in kernels) / per,
            "top_device_ops": [[e.key[:90], e.count, dev_us(e) / per]
                               for e in top_dev],
            "top_host_ms_per_step": {e.key[:60]: e.self_cpu_time_total / per
                                     for e in top_host}}


def slot_phase(torch, sat, ac, kv_dtype=None):
    """``InferenceEngine.serve`` of the satellite tier (Qwen2-VL-2B) at full
    width on the paged slot path: 24 requests over 4 scenes (per scene 1
    det with 1024 answer tokens, 1 cls, 4 vqa) on 8 slots; with
    ``kv_dtype`` on 8-bit pools (phase 11), every paged launch counted
    under that storage."""
    from repro_torch.kernels import ops
    from repro_torch.serving import EngineConfig, InferenceEngine
    av = ac.num_classes + 1
    tag = "slot path" + (f" {kv_dtype}" if kv_dtype else "")
    eng = InferenceEngine(sat.params, sat.cfg, ac,
                          EngineConfig(slots=8, page_size=8, answer_vocab=av,
                                       kv_dtype=kv_dtype),
                          device="cuda")
    core = eng.core
    eng.warmup()
    reqs = scene_stream(["det", "cls", "vqa", "vqa", "vqa", "vqa"], 4,
                        FULL_IMAGE, FULL_GRID, seed=300)
    # snapshot each scene's shared pages the moment they are written
    snaps, prefill = {}, core._prefill_prefixes

    def prefill_and_snapshot(miss):
        prefill(miss)
        for scene, _ in miss:
            pages = torch.tensor(core._prefix.get(scene).pages,
                                 device="cuda")
            snaps[scene] = (pages, [{k: as_bits(v)[:, pages].clone()
                                     for k, v in layer.items()}
                                    for layer in core._slot_cache])

    core._prefill_prefixes = prefill_and_snapshot
    probe = StepProbe(torch, core)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with PrefillCounter() as prefills:
        out = eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    prefills.check(counts, tag)

    toks = served_tokens(out, reqs)
    for r, t in zip(reqs, toks):
        if len(t) != ac.answer_len(r.task) or t.min() < 0 or t.max() >= av:
            raise RuntimeError(f"{tag}: {r.task} answered {len(t)} "
                               "tokens or outside the answer vocab")
    st, kv = core.stats, core.kv_stats()
    steps = st["sched"]["steps"]
    n_layers = sat.cfg.num_layers
    resident = kv["prefix_shared_pages"]
    checks = {
        "every request answered": len(out) == len(reqs) == 24,
        "prefix_hits == 20": st["prefix_hits"] == 20,
        "prefix_misses == 4": st["prefix_misses"] == 4,
        "pages_in_use == resident prefix pages":
            kv["pages_in_use"] == resident == 4 * ac.n_regions // 8,
        "shared pages unchanged": len(snaps) == 4 and all(
            all(torch.equal(v, as_bits(layer[k])[:, pages])
                for saved, layer in zip(saved_layers, core._slot_cache)
                for k, v in saved.items())
            for pages, saved_layers in snaps.values()),
        "paged launches == layers x (steps + admissions)":
            counts["paged_decode_attention"]
            == n_layers * (steps + probe.admissions),
        "every paged launch on the pool's storage":
            kv_dtype is None or counts[f"paged_decode_attention[{kv_dtype}]"]
            == counts["paged_decode_attention"],
        "paged decode on the tensor cores only": decode_routes(
            counts, "mma", need=("paged_decode_attention",))[0],
        "flash launched": counts["flash_attention_wgmma"] > 0,
    }
    n_tok = sum(len(t) for t in toks)
    step_ms = 1e3 * sum(probe.step_s) / len(probe.step_s)
    prof = probe.profile()
    busy = prof and prof["device_busy_share"]
    res = {"requests": len(out), "slot_steps": steps,
           "admission_calls": probe.admissions,
           "prefix_hits": st["prefix_hits"],
           "prefix_misses": st["prefix_misses"],
           "mid_stream_refills": st["mid_stream_refills"],
           "pages_in_use": kv["pages_in_use"], "n_pages": kv["n_pages"],
           "answer_tokens": n_tok, "wall_s": wall,
           "tokens_per_s": n_tok / wall, "step_ms_mean": step_ms,
           "step_ms_median": 1e3 * sorted(probe.step_s)[steps // 2],
           "det_max_token_gap_ms": probe.max_token_gap_ms(
               [r for r in reqs if r.task == "det"]),
           "prefill_by_kind": dict(st["prefill_by_kind"]),
           "kv_dtype": kv_dtype, "kv_bytes_total": kv["kv_bytes_total"],
           "page_bytes": kv["page_bytes"],
           "device_busy_share": busy, "profile": prof, "launches": counts}
    log(f"  {tag}: {len(out)} requests in {wall:.2f} s, {steps} slot "
        f"steps + {probe.admissions} admission calls, step {step_ms:.2f} ms"
        f" (mean), {n_tok / wall:.1f} answer tokens/s, device busy "
        f"{busy if busy is None else round(busy, 3)}")
    log(f"  {tag} checks: {checks}")
    if kv_dtype is None:
        log("slot_phase " + json.dumps(res))
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise RuntimeError(f"{tag} failed: {bad}")
    return dict(res, tokens=toks)


def chunked_phase(torch, sat, ac, slot, kv_dtype=None):
    """Phase 6's stream through the 2B's ``InferenceEngine`` with chunked
    prefill (``prefill_chunk`` 256, token budget 264 = 8 slots + 256): no
    admission runs a model forward; each scene's 1024 region tokens stream
    into its shared pages 256 at a time inside fused steps, beside the
    decoding slots.  Checked against phase 6's run (``slot``).  With
    ``kv_dtype`` on 8-bit pools (phase 11), every paged launch counted
    under that storage."""
    from repro_torch.kernels import ops
    from repro_torch.serving import EngineConfig, InferenceEngine
    av = ac.num_classes + 1
    tag = "chunked" + (f" {kv_dtype}" if kv_dtype else "")
    eng = InferenceEngine(sat.params, sat.cfg, ac,
                          EngineConfig(slots=8, page_size=8, answer_vocab=av,
                                       prefill_chunk=256, kv_dtype=kv_dtype),
                          device="cuda")
    core = eng.core
    eng.warmup()
    budget = core.stats["sched"]["budget"]
    reqs = scene_stream(["det", "cls", "vqa", "vqa", "vqa", "vqa"], 4,
                        FULL_IMAGE, FULL_GRID, seed=300)
    # snapshot each scene's shared pages the moment its stream publishes
    snaps, put = {}, core._prefix.put

    def put_and_snapshot(scene, pages, state):
        entry = put(scene, pages, state)
        idx = torch.tensor(pages, device="cuda")
        snaps[scene] = (idx, [{k: as_bits(v)[:, idx].clone() for k, v in
                               layer.items()} for layer in core._slot_cache])
        return entry

    core._prefix.put = put_and_snapshot
    probe = StepProbe(torch, core, first=2, n=4)

    def mixed():                      # a fused step with decoding slots
        return bool(core._streaming) and any(
            sl.active and sl.phase == "decode" for sl in core._slots)

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    # the first layer's prefix-append inputs of the first mixed fused step
    out, held = capture_inputs(torch, lambda: eng.serve(reqs),
                               ["paged_prefill_attention"], when=mixed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()

    toks = served_tokens(out, reqs)
    for r, t in zip(reqs, toks):
        if len(t) != ac.answer_len(r.task) or t.min() < 0 or t.max() >= av:
            raise RuntimeError(f"{tag}: {r.task} answered {len(t)} "
                               "tokens or outside the answer vocab")
    st, kv, sched = core.stats, core.kv_stats(), core.scheduler_stats()
    steps, fused = sched["steps"], sched["fused_steps"]
    n_layers = sat.cfg.num_layers
    by_kind, by_kind6 = st["prefill_by_kind"], slot["prefill_by_kind"]
    log_ = st["sched"]["step_log"]
    decoding = [d for d, f in zip(probe.decoding, probe.fused) if f]
    checks = {
        "every request answered": len(out) == len(reqs) == 24,
        "prefix hits/misses == phase 6's":
            (st["prefix_hits"], st["prefix_misses"])
            == (slot["prefix_hits"], slot["prefix_misses"]) == (20, 4),
        "pages_in_use == resident prefix pages":
            kv["pages_in_use"] == kv["prefix_shared_pages"]
            == 4 * ac.n_regions // 8,
        "shared pages unchanged": len(snaps) == 4 and all(
            all(torch.equal(v, as_bits(layer[k])[:, pages])
                for saved, layer in zip(saved_layers, core._slot_cache)
                for k, v in saved.items())
            for pages, saved_layers in snaps.values()),
        "every paged launch on the pool's storage": kv_dtype is None or all(
            counts[f"{n}[{kv_dtype}]"] == counts[n]
            for n in ("paged_decode_attention", "paged_prefill_attention")),
        "chunk + prompt == phase 6's prefix + prompt":
            by_kind.get("chunk", 0) + by_kind.get("prompt", 0)
            == by_kind6.get("prefix", 0) + by_kind6.get("prompt", 0),
        "stall_steps == 0": sched["stall_steps"] == 0,
        "every fused step within the budget":
            len(log_) == fused and all(sum(e) <= budget for e in log_),
        "a decode token for every decoding slot in every fused step":
            [e[0] for e in log_] == decoding,
        "prefill launches == layers x fused steps":
            counts["paged_prefill_attention"] == n_layers * fused,
        "prefix-append on the tensor cores only":
            ops.launches_by_route(counts, "paged_prefill_attention")
            == {"mma": n_layers * fused, "cuda_cores": 0},
        "decode launches == layers x plain steps":
            counts["paged_decode_attention"] == n_layers * (steps - fused),
        "paged decode on the tensor cores only": decode_routes(
            counts, "mma", need=("paged_decode_attention",))[0],
        "no flash prefill (either route), no region scoring":
            ops.launches_by_route(counts, "flash_attention")
            == {"wgmma": 0, "cuda_cores": 0} and counts["region_score"] == 0,
    }
    agree = [bool((a == b).all()) for a, b in zip(toks, slot["tokens"])]
    det_pos = [float((a == b).mean()) for a, b, r in
               zip(toks, slot["tokens"], reqs) if r.task == "det"]
    n_tok = sum(len(t) for t in toks)
    fused_s = [t for t, f in zip(probe.step_s, probe.fused) if f]
    plain_s = [t for t, f in zip(probe.step_s, probe.fused) if not f]
    prof = probe.profile()
    busy = prof and prof["device_busy_share"]
    res = {"requests": len(out), "steps": steps, "fused_steps": fused,
           "budget": budget, "budget_utilization":
           sched["budget_utilization"], "chunk_tokens": sched["chunk_tokens"],
           "prompt_tokens": sched["prompt_tokens"],
           "decode_tokens": sched["decode_tokens"],
           "stall_steps": sched["stall_steps"],
           "prefill_by_kind": dict(by_kind),
           "admission_calls": probe.admissions,
           "prefix_hits": st["prefix_hits"],
           "prefix_misses": st["prefix_misses"],
           "pages_in_use": kv["pages_in_use"],
           "answers_equal_to_phase_6": sum(agree),
           "det_answers_equal_to_phase_6": sum(
               a for a, r in zip(agree, reqs) if r.task == "det"),
           "det_positions_equal_to_phase_6": det_pos,
           "answer_tokens": n_tok, "wall_s": wall,
           "tokens_per_s": n_tok / wall,
           "fused_step_ms_mean": 1e3 * sum(fused_s) / max(len(fused_s), 1),
           "fused_step_ms_median": 1e3 * sorted(fused_s)[len(fused_s) // 2],
           "plain_step_ms_mean": 1e3 * sum(plain_s) / max(len(plain_s), 1),
           "plain_step_ms_median": 1e3 * sorted(plain_s)[len(plain_s) // 2],
           "det_max_token_gap_ms": probe.max_token_gap_ms(
               [r for r in reqs if r.task == "det"]),
           "phase_6_det_max_token_gap_ms": slot["det_max_token_gap_ms"],
           "profiled_steps_fused": all(probe.fused[2:6]),
           "device_busy_share": busy, "profile": prof, "launches": counts,
           "prefill_launches_by_route": ops.launches_by_route(
               counts, "paged_prefill_attention"),
           "kv_dtype": kv_dtype,
           "prefill_on_path_inputs": prefill_on_path_inputs(
               torch, held["paged_prefill_attention"],
               phase=11 if kv_dtype else 8)}
    log(f"  {tag}: {len(out)} requests in {wall:.2f} s, {steps} steps "
        f"({fused} fused), fused step {res['fused_step_ms_mean']:.2f} ms, "
        f"plain step {res['plain_step_ms_mean']:.2f} ms, "
        f"{n_tok / wall:.1f} answer tokens/s, det token gap "
        f"{res['det_max_token_gap_ms']} ms (phase 6: "
        f"{slot['det_max_token_gap_ms']} ms), {sum(agree)}/{len(agree)} "
        f"answers equal to phase 6's, device busy "
        f"{busy if busy is None else round(busy, 3)}, device "
        f"{prof and round(prof['device_ms_per_step'], 3)} ms a profiled "
        f"fused step")
    log(f"  {tag} checks: {checks}")
    if kv_dtype is None:
        log("chunked_phase " + json.dumps(res))
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise RuntimeError(f"{tag} failed: {bad}")
    return dict(res, tokens=toks)


def prefill_on_path_inputs(torch, calls, phase: int = 8):
    """The prefix-append kernel's tensor-core route held to its bound on a
    chunked phase's own inputs: the first layer's call of the first fused
    step with decoding slots, with its tile plan (the rows the plan covers)
    and without it (every row), after the phase's counts were read; an
    8-bit pool against its dequantized plain version."""
    from repro_torch.kernels import ops, ref
    errors, out = [], {}
    log(f"paged_prefill_attention on phase {phase}'s own inputs (mma "
        f"route)")
    if not calls:
        raise RuntimeError(f"phase {phase}: no fused step with decoding "
                           "slots reached the prefix-append op")
    (q, k_pool, v_pool, table, lens), kw = calls[0]
    kw = dict(kw)
    plan = kw.pop("plan")
    scales = {k: kw.pop(k) for k in ("k_scale", "v_scale") if k in kw}
    kd = ref.dequantize_pool(k_pool, scales.get("k_scale"))
    vd = ref.dequantize_pool(v_pool, scales.get("v_scale"))
    tiles = int((plan[1] > 0).sum())
    for tag, p, rows in (("plan", plan, plan_rows(torch, plan, q.shape[0])),
                         ("no plan", None,
                          torch.ones(q.shape[0], dtype=torch.bool,
                                     device=q.device))):
        case = (f"phase {phase} fused step B{q.shape[0]} {int(rows.sum())} "
                f"rows {tiles} tiles, {tag}")
        err, share = check_mma_rows(
            "paged_prefill", ops.paged_prefill_attention(
                q, k_pool, v_pool, table, lens, plan=p, **kw, **scales),
            q, kd, vd, table, lens, rows, kw, case, errors)
        out[tag] = {"max_abs_err": err, "tolerance_share": share,
                    "rows": int(rows.sum()), "tiles": tiles}
    if errors:
        raise RuntimeError(f"phase {phase}: prefix-append outside its "
                           f"bound on the path's own inputs: {errors}")
    return out


def drain(core, requests):
    """Admit ``requests`` into free slots as they free up and step ``core``
    until every one is answered; their tokens in request order."""
    out, queue = {}, list(requests)
    while queue or core.active_count():
        n = min(len(queue), len(core.free_slots()))
        if n:
            core.admit_many(queue[:n])
            del queue[:n]
        for r, t in core.step():
            out[r.request_id] = t
    return [out[r.request_id] for r in requests]


def spec_small_requests():
    """Phase 7's vqa/cls requests: two scenes of vqa, cls, vqa."""
    return scene_stream(["vqa", "cls", "vqa"], 2, FULL_IMAGE, FULL_GRID,
                        seed=400)


def spec_phase(torch, sat, gs, ac):
    """The 7B ground tier's speculative ``EngineCore`` (γ = 4, 4 slots)
    drafted by the 2B satellite tier: 6 vqa/cls requests (1-token answers
    need no drafts, so the engine verifies them without drafting), then
    one det request whose piggybacked drafts are the 7B's own greedy answer
    from a non-speculative slot-path run, all but the last ``LOCAL_TAIL``
    positions: verify-only steps first, then local drafting by the 2B for
    the tail (and for everything after a first disagreement, which drops
    the piggybacked stream)."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.serving import EngineCore, EngineCoreConfig
    av = ac.num_classes + 1
    gamma, n_layers = 4, gs.cfg.num_layers
    small = spec_small_requests()
    det = scene_stream(["det"], 1, FULL_IMAGE, FULL_GRID, seed=500)[0]

    # the 7B's greedy det answer on the non-speculative slot path
    plain = EngineCore(gs, ac, EngineCoreConfig(slots=4, answer_vocab=av))
    plain.warmup()
    plain_probe = StepProbe(torch, plain)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with PrefillCounter() as prefills:
        greedy = drain(plain, clone_requests([det]))[0]
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    plain_counts = ops.launch_counts()
    prefills.check(plain_counts, "spec phase, greedy 7B")
    plain_steps = plain.stats["sched"]["steps"]

    spec = EngineCore(gs, ac, EngineCoreConfig(slots=4, answer_vocab=av,
                                               spec_gamma=gamma),
                      draft=sat)
    spec.warmup()
    probe = StepProbe(torch, spec, first=4, n=8)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with PrefillCounter() as prefills:
        small_toks = drain(spec, clone_requests(small))
        small_steps = spec.stats["spec"]["steps"]
        det_req = clone_requests([det], [greedy[:-LOCAL_TAIL]])
        got = drain(spec, det_req)[0]
    torch.cuda.synchronize()
    t_spec = time.perf_counter() - t0
    counts = ops.launch_counts()
    prefills.check(counts, "spec phase, 7B drafted by 2B")
    sp = spec.spec_stats()
    agree = got == greedy
    first_diff = None if agree.all() else int(np.argmin(agree))
    verify_steps = sp["steps"]
    checks = {
        "small answered": all(len(t) == 1 for t in small_toks),
        "det answered": len(got) == ac.answer_len("det")
                        and got.min() >= 0 and got.max() < av,
        "verify-only steps ran": sp["verify_only_steps"] > 0,
        "local drafting ran": sp["steps"] > sp["verify_only_steps"],
        "paged launches == layers x (verify steps + admissions)":
            counts["paged_decode_attention"]
            == n_layers * (verify_steps + probe.admissions),
        "plain paged launches == layers x (steps + admissions)":
            plain_counts["paged_decode_attention"]
            == n_layers * (plain_steps + plain_probe.admissions),
        "drafter's dense decode launched": counts["decode_attention"] > 0,
        "decode on the tensor cores only (verifier, drafter, greedy)":
            decode_routes(counts, "mma")[0] and decode_routes(
                plain_counts, "mma", need=("paged_decode_attention",))[0],
    }
    g9 = spec_gamma9(torch, sat, gs, ac, small, small_toks, drain)
    checks.update(g9.pop("checks"))
    res = {"spec_stats": sp, "verify_steps": verify_steps,
           "local_draft_steps": sp["steps"] - sp["verify_only_steps"],
           "small_request_steps": small_steps,
           "admission_calls": probe.admissions,
           "det_agreement_share": float(agree.mean()),
           "det_first_disagreement": first_diff,
           "spec_wall_s": t_spec, "greedy_det_wall_s": t_plain,
           "greedy_slot_steps": plain_steps,
           "greedy_step_ms": 1e3 * sum(plain_probe.step_s)
           / max(len(plain_probe.step_s), 1),
           "spec_step_ms": 1e3 * sum(probe.step_s) / max(len(probe.step_s),
                                                         1),
           "spec_profile": probe.profile(),
           "greedy_profile": plain_probe.profile(),
           "launches": counts, "greedy_launches": plain_counts,
           "gamma_9": g9}
    log(f"  spec: {verify_steps} verify steps ({sp['verify_only_steps']} "
        f"verify-only), accept rate {sp['accept_rate']:.3f}, "
        f"{sp['tokens_per_slot_step']:.2f} tokens per slot step; det "
        f"agrees with the greedy answer on {agree.mean():.4f} of "
        f"{len(greedy)} positions (first disagreement: {first_diff}); spec "
        f"{t_spec:.2f} s vs greedy det {t_plain:.2f} s")
    log(f"  spec checks: {checks}")
    log("spec_phase " + json.dumps(res))
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise RuntimeError(f"spec phase failed: {bad}")
    return dict(res, small_tokens=small_toks)


def spec_gamma9(torch, sat, gs, ac, small, small_toks, drain):
    """The 7B's speculative engine at γ 9, drafted by the 2B: the verify
    chunk is 10 tokens × group 7 = 70 query rows, past one block's 64 (two
    row tiles).  Two of phase 7's vqa requests; their answers against the
    γ 4 engine's (reported, not asserted).  Returns the run's numbers and
    its checks: launch counts per layer and route, every answer in the
    vocabulary."""
    from repro_torch.kernels import ops
    from repro_torch.serving import EngineCore, EngineCoreConfig
    av, n_layers = ac.num_classes + 1, gs.cfg.num_layers
    vqa = [i for i, r in enumerate(small) if r.task == "vqa"][:2]
    spec = EngineCore(gs, ac, EngineCoreConfig(slots=4, answer_vocab=av,
                                               spec_gamma=9), draft=sat)
    spec.warmup()
    probe = StepProbe(torch, spec, first=1 << 30)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with PrefillCounter() as prefills:
        toks = drain(spec, clone_requests([small[i] for i in vqa]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    prefills.check(counts, "spec phase, γ 9")
    steps = spec.stats["spec"]["steps"]
    agree = sum(bool((a == small_toks[i]).all()) for a, i in zip(toks, vqa))
    ok, by_route = decode_routes(counts, "mma",
                                 need=("paged_decode_attention",))
    res = {"requests": len(toks), "verify_rows": 10 * gs.cfg.num_heads
           // gs.cfg.num_kv_heads, "verify_steps": steps,
           "admission_calls": probe.admissions,
           "answers_equal_to_gamma_4": agree, "wall_s": wall,
           "decode_launches_by_route": by_route, "launches": counts}
    log(f"  spec γ 9: {len(toks)} vqa answers in {steps} verify steps of "
        f"{res['verify_rows']} rows, {agree}/{len(toks)} equal to γ 4's")
    res["checks"] = {
        "γ 9 answered": len(toks) == 2 and all(
            len(t) == 1 and 0 <= t.min() and t.max() < av for t in toks),
        "γ 9 paged launches == layers x (verify steps + admissions)":
            counts["paged_decode_attention"]
            == n_layers * (steps + probe.admissions),
        "γ 9 paged decode on the tensor cores only": ok}
    return res


def quant_phase(torch, sat, gs, ac, slot, spec, chunked):
    """Phase 11: the slot path on 8-bit pools at full width, while the
    2B/7B pair is loaded.  (i) Phase 6's stream through the 2B's
    ``InferenceEngine`` with int8 pools (row 4), (ii) phase 8's chunked
    stream with fp8 pools (rows 4 and 6), each with its phase's checks
    (prefix hits and misses, pages, shared pages byte-unchanged, launches
    per layer and route) and every paged launch counted under the pool's
    storage; (ii') phase 8's scenes without their det requests, chunked on
    int8 pools (row 6 on int8: every prefix-append launch on the tensor
    cores and the int8 pool); (iii) phase 7's γ 4 7B engine drafted by the
    2B on its vqa/cls
    requests with int8 pools (row 5): verify launches per layer, on the
    tensor cores, all on the int8 pool; (iv) a 2B engine given phase 6's
    bf16 pool bytes as ``pool_bytes`` at int8: its page count is what
    ``page_nbytes`` gives (4224 B a layer page against 8192 B in bf16).
    Each quantized kernel is held to its bound on the path's own first
    inputs.  Token agreement with the bf16 runs is reported through
    ``kv_quant.compare_outputs``, not asserted (bf16 near-ties flip)."""
    from repro_torch.kernels import kv_quant, ops
    from repro_torch.serving import (EngineConfig, EngineCore,
                                     EngineCoreConfig, InferenceEngine)
    from repro_torch.serving.kv_pool import page_nbytes
    t_phase = time.perf_counter()
    av, res, checks = ac.num_classes + 1, {}, {}

    def agreement(want, got):
        return kv_quant.compare_outputs(dict(enumerate(want)),
                                        dict(enumerate(got)))

    # (i) row 4 on int8 pools; its first decode inputs held afterwards
    int8, held = capture_inputs(
        torch, lambda: slot_phase(torch, sat, ac, kv_dtype="int8"),
        ["paged_decode_attention"])
    res["slot_int8"] = {k: v for k, v in int8.items()
                        if k not in ("tokens", "profile", "launches")}
    res["slot_int8"]["agreement_with_phase_6"] = agreement(
        slot["tokens"], int8["tokens"])
    res["slot_int8"]["on_path_inputs"] = decode_on_path_inputs(
        held, 11, "int8 slot path", need=("paged_decode_attention",))
    checks["int8 slot path: prefix hits/misses == phase 6's"] = (
        (int8["prefix_hits"], int8["prefix_misses"])
        == (slot["prefix_hits"], slot["prefix_misses"]))

    # (ii) rows 4 and 6 on fp8 pools
    fp8 = chunked_phase(torch, sat, ac, slot, kv_dtype="fp8")
    res["chunked_fp8"] = {k: v for k, v in fp8.items()
                          if k not in ("tokens", "profile", "launches")}
    res["chunked_fp8"]["agreement_with_phase_8"] = agreement(
        chunked["tokens"], fp8["tokens"])

    # (ii') row 6 on int8 pools: phase 8's scenes without their det
    # requests (one-token answers), so every fused step streams a chunk
    eng = InferenceEngine(sat.params, sat.cfg, ac,
                          EngineConfig(slots=8, page_size=8, answer_vocab=av,
                                       prefill_chunk=256, kv_dtype="int8"),
                          device="cuda")
    eng.warmup()
    reqs = scene_stream(["cls", "vqa", "vqa", "vqa", "vqa"], 4, FULL_IMAGE,
                        FULL_GRID, seed=300)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    short = served_tokens(eng.serve(reqs), reqs)
    torch.cuda.synchronize()
    short_counts = ops.launch_counts()
    sched, st = eng.core.scheduler_stats(), eng.core.stats
    checks.update({
        "int8 chunked: answered": all(len(t) == 1 for t in short),
        "int8 chunked: 16 hits, 4 misses":
            (st["prefix_hits"], st["prefix_misses"]) == (16, 4),
        "int8 chunked: prefill launches == layers x fused steps, all on "
        "the tensor cores and the int8 pool":
            short_counts["paged_prefill_attention_mma[int8]"]
            == short_counts["paged_prefill_attention"]
            == sat.cfg.num_layers * sched["fused_steps"] > 0})
    res["chunked_int8_short"] = {
        "requests": len(short), "fused_steps": sched["fused_steps"],
        "steps": sched["steps"], "prefix_hits": st["prefix_hits"],
        "prefix_misses": st["prefix_misses"]}
    del eng

    # (iii) row 5: the 7B's verify on int8 pools
    small = spec_small_requests()
    eng = EngineCore(gs, ac, EngineCoreConfig(slots=4, answer_vocab=av,
                                              spec_gamma=4, kv_dtype="int8"),
                     draft=sat)
    eng.warmup()
    probe = StepProbe(torch, eng, first=1 << 30)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with PrefillCounter() as prefills:
        toks, held = capture_inputs(torch, lambda: drain(
            eng, clone_requests(small)), list(PAGED_DECODE_OPS))
    torch.cuda.synchronize()
    spec_counts = ops.launch_counts()
    prefills.check(spec_counts, "phase 11, 7B γ 4 on int8 pools")
    n_layers, verify_steps = gs.cfg.num_layers, eng.stats["spec"]["steps"]
    ok, by_route = decode_routes(spec_counts, "mma",
                                 need=("paged_decode_attention",))
    checks.update({
        "int8 spec: answered": all(len(t) == 1 and 0 <= t.min()
                                   and t.max() < av for t in toks),
        "int8 spec: paged launches == layers x (verify steps + admissions)":
            spec_counts["paged_decode_attention"]
            == n_layers * (verify_steps + probe.admissions),
        "int8 spec: every paged launch on the int8 pool":
            spec_counts["paged_decode_attention[int8]"]
            == spec_counts["paged_decode_attention"],
        "int8 spec: decode on the tensor cores only": ok,
        "int8 spec: a verify chunk reached the kernel":
            bool(held["paged_multi_decode_attention"])})
    res["spec_int8"] = {
        "verify_steps": verify_steps, "admission_calls": probe.admissions,
        "spec_stats": eng.spec_stats(), "decode_launches_by_route": by_route,
        "agreement_with_phase_7": agreement(spec["small_tokens"], toks),
        "on_path_inputs": decode_on_path_inputs(
            held, 11, "int8 verify", need=PAGED_DECODE_OPS[1:])}

    # (iv) pool_bytes: phase 6's bf16 pool bytes buy ~2x the int8 pages
    budget = slot["kv_bytes_total"]
    layer_page = {kind: page_nbytes(8, sat.cfg.num_kv_heads,
                                    sat.cfg.resolved_head_dim, kv_dtype=kind,
                                    fp_bytes=2) for kind in (None, "int8")}
    sized = EngineCore(sat, ac, EngineCoreConfig(
        slots=8, page_size=8, answer_vocab=av, kv_dtype="int8",
        pool_bytes=budget))
    kv = sized.kv_stats()
    want = budget // (sat.cfg.num_layers * layer_page["int8"])
    checks.update({
        "layer page: 8192 B bf16, 4224 B int8":
            (layer_page[None], layer_page["int8"]) == (8192, 4224),
        "pool_bytes buys page_nbytes' count":
            sized._n_pages == kv["n_pages"] == want,
        "the live int8 pools fit the budget": kv["kv_bytes_total"] <= budget})
    res["pool_bytes"] = {"budget": budget, "bf16_pages": slot["n_pages"],
                         "int8_pages": kv["n_pages"],
                         "layer_page_bytes": {str(k): v for k, v in
                                              layer_page.items()},
                         "int8_kv_bytes_total": kv["kv_bytes_total"],
                         "int8_kv_scale_bytes": kv["kv_scale_bytes"]}
    del sized
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 11 checks: {checks}")
    log("quant_phase " + json.dumps(res))
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise RuntimeError(f"phase 11 failed: {bad}")
    return {"launches": {"slot_serve_int8": int8["launches"],
                         "chunked_serve_fp8": fp8["launches"],
                         "chunked_serve_int8_short": short_counts,
                         "spec_int8": spec_counts}}


OVERLOAD_STEPS = 64          # phase 12 (a): steps before the urgent burst
OVERLOAD_REASONS = ("queue_full", "expired", "infeasible")


def overload_core_phase(torch, sat, ac):
    """Phase 12 (a): a saturated 2B ``EngineCore`` under overload control
    (4 slots, ``OverloadConfig(queue_cap=4)``, page 8, a pool of 1 + 3P +
    3S pages, P private and S shared pages a slot: 772 at full width).
    Traffic: 4 bulk det (2 on scene A, 2 on B); after ``OVERLOAD_STEPS``
    steps and with no step between them, 2 urgent vqa on scene C, 1 bulk
    vqa on scene E with a 1 ms deadline and a burst of 5 bulk cls on
    scene D; then steps until the queue is empty and at most one slot is
    active (B's second det, which would run ~950 steps alone), whose slot
    is released unfinished.  Each preempted
    request's committed tokens are recorded as ``_preempt_one`` releases
    its slot, with whether its scene's prefix stayed resident until it
    was admitted again."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.serving import (PRIORITY_URGENT, EngineCore,
                                     EngineCoreConfig, OverloadConfig)
    from repro_torch.serving.kv_pool import TRASH_PAGE
    from repro_torch.serving.request import scene_key
    av = ac.num_classes + 1
    t_phase = time.perf_counter()
    probe = EngineCore(sat, ac, EngineCoreConfig(slots=4, page_size=8,
                                                 answer_vocab=av))
    n_priv, n_shared = probe._private_per_slot, probe._n_shared_pages
    pool = 1 + 3 * n_priv + 3 * n_shared
    core = EngineCore(sat, ac, EngineCoreConfig(
        slots=4, page_size=8, answer_vocab=av, pool_pages=pool,
        overload=OverloadConfig(queue_cap=4)))
    core.warmup()
    det = scene_stream(["det", "det"], 2, FULL_IMAGE, FULL_GRID, seed=1200)
    urgent = scene_stream(["vqa", "vqa"], 1, FULL_IMAGE, FULL_GRID,
                          seed=1210)
    late = scene_stream(["vqa"], 1, FULL_IMAGE, FULL_GRID, seed=1220)
    burst = scene_stream(["cls"] * 5, 1, FULL_IMAGE, FULL_GRID, seed=1230)
    for r in urgent:
        r.priority = PRIORITY_URGENT
    late[0].deadline_s = 1e-3
    submitted = det + urgent + late + burst

    # each preemption: (request id, slot, committed tokens, the scene's
    # prefix entry); each re-admission: whether that entry was still the
    # resident one
    preempted, resident, release = {}, {}, core._release_slot
    preempt, admit = core._preempt_one, core.admit_many

    def preempt_one(above, now):
        def release_and_record(i):
            sl = core._slots[i]
            preempted[sl.request.request_id] = (
                i, list(sl.tokens),
                core._prefix._entries.get(sl.scene))
            release(i)
        core._release_slot = release_and_record
        try:
            return preempt(above, now)
        finally:
            core._release_slot = release

    def admit_many(requests):
        for r in requests:
            rec = preempted.get(r.request_id)
            if rec is not None:
                resident[r.request_id] = (
                    core._prefix._entries.get(scene_key(r)) is rec[2])
        return admit(requests)

    core._preempt_one, core.admit_many = preempt_one, admit_many
    probe_steps = StepProbe(torch, core, first=256, n=8)
    answers, order, rejected, outcomes = {}, [], [], []

    def step():
        for r, t in core.step():
            answers[r.request_id] = t
            order.append(r.request_id)
        rejected.extend(core.take_rejected())

    def snapshot():
        return {"active": [sl.request.request_id if sl.active else None
                           for sl in core._slots],
                "queue": [e.request.request_id for e in core._admq],
                "pages_in_use": core._pool.pages_in_use}

    # the paged decode's inputs are kept from the first step after the
    # submits: three slots decoding at mixed lengths and one empty
    trace, capture = {}, {"on": False}

    def run():
        outcomes.append(core.submit_many(det))
        for _ in range(OVERLOAD_STEPS):
            step()
        trace["before_urgent"] = snapshot()
        for group in (urgent, late, burst):
            outcomes.append(core.submit_many(group))
        rejected.extend(core.take_rejected())
        trace["after_submits"] = snapshot()
        capture["on"] = True
        step()
        capture["on"] = False
        while core.queue_depth() or core.active_count() > 1:
            step()

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with PrefillCounter() as prefills:
        _, held = capture_inputs(torch, run, ["paged_decode_attention"],
                                 when=lambda: capture["on"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    prefills.check(counts, "phase 12 (a)")
    on_path = decode_on_path_inputs(held, 12, "overload core",
                                    need=("paged_decode_attention",))

    # the one request left in flight: its committed tokens, then its slot
    # released (the engine's own release path, as at a finish)
    in_flight = {sl.request.request_id: list(sl.tokens)
                 for sl in core._slots if sl.active}
    for i, sl in enumerate(core._slots):
        if sl.active:
            core._release_slot(i)
    ids = {r.request_id: r for r in submitted}
    why = {}
    for r, reason in rejected:
        why.setdefault(r.request_id, []).append(reason)
    bad_answers = [rid for rid, t in answers.items()
                   if len(t) != ac.answer_len(ids[rid].task)
                   or t.min() < 0 or t.max() >= av]
    ol = core.scheduler_stats()["overload"]
    kv, steps = core.kv_stats(), core.stats["sched"]["steps"]
    n_layers = sat.cfg.num_layers
    kept = {rid: bool((answers[rid][:len(rec[1])]
                       == np.asarray(rec[1], np.int32)).all())
            for rid, rec in preempted.items() if rid in answers}
    checks = {
        "every answer the right length, in the answer vocab":
            not bad_answers,
        "every request answered, rejected once or left in flight with "
        "tokens committed, none two of these, none lost":
            set(answers) | set(why) | set(in_flight) == set(ids)
            and len(answers) + len(why) + len(in_flight) == len(ids)
            and all(len(v) == 1 for v in why.values())
            and len(in_flight) <= 1 and all(
                0 < len(t) < ac.answer_len(ids[rid].task)
                for rid, t in in_flight.items()),
        "reasons from the three": all(v[0] in OVERLOAD_REASONS
                                      for v in why.values()),
        "a preemption": ol["preemptions"] >= 1
            and ol["preemptions"] == len(preempted),
        "a deferral": ol["admissions_deferred"] >= 1,
        "a queue_full": ol["rejections"].get("queue_full", 0) >= 1,
        "an expiry": ol["rejections"].get("expired", 0) >= 1,
        "each preempted answer re-emits its tokens where its prefix "
        "stayed resident": all(kept[rid] for rid, res in resident.items()
                               if res),
        "drained: only resident prefix pages":
            kv["pages_in_use"] == kv["prefix_shared_pages"],
        "drained: no prefix entry in use": kv["prefix_entries_in_use"] == 0,
        "drained: block table all trash page":
            bool((core._bt_np == TRASH_PAGE).all()),
        "paged launches == layers x (steps + admissions)":
            counts["paged_decode_attention"]
            == n_layers * (steps + probe_steps.admissions),
        "paged decode on the tensor cores only": decode_routes(
            counts, "mma", need=("paged_decode_attention",))[0],
    }
    n_tok = sum(len(t) for t in answers.values())
    prof = probe_steps.profile()
    busy = prof and prof["device_busy_share"]
    step_ms = 1e3 * sum(probe_steps.step_s) / len(probe_steps.step_s)
    res = {"pool_pages": pool, "private_per_slot": n_priv,
           "shared_pages": n_shared, "outcomes": outcomes,
           "rejected": [(r.request_id, w) for r, w in rejected],
           "finished_order": order, "trace": trace,
           "left_in_flight": {rid: len(t) for rid, t in in_flight.items()},
           "preempted": {rid: {"slot": rec[0], "tokens_committed":
                               len(rec[1]),
                               "prefix_stayed_resident":
                               resident.get(rid),
                               "answer_begins_with_them": kept.get(rid)}
                         for rid, rec in preempted.items()},
           "steps": steps, "admission_calls": probe_steps.admissions,
           "prefix_prefills": prefills.calls,
           "prefix_hits": core.stats["prefix_hits"],
           "prefix_misses": core.stats["prefix_misses"],
           "answer_tokens": n_tok, "wall_s": wall,
           "tokens_per_s": n_tok / wall, "step_ms_mean": step_ms,
           "step_ms_median": 1e3 * sorted(probe_steps.step_s)[
               len(probe_steps.step_s) // 2],
           "device_busy_share": busy, "profile": prof,
           "scheduler_overload": ol, "on_path_inputs": on_path,
           "launches": counts,
           "seconds": time.perf_counter() - t_phase}
    log(f"  phase 12 (a): {len(answers)} answered, {len(why)} rejected "
        f"{ol['rejections']}, "
        f"{ol['preemptions']} preemptions, {steps} steps + "
        f"{probe_steps.admissions} admission calls, step {step_ms:.2f} ms "
        f"(mean), {n_tok / wall:.1f} answer tokens/s, device busy "
        f"{busy if busy is None else round(busy, 3)}")
    log(f"  phase 12 (a) checks: {checks}")
    del core, probe
    torch.cuda.empty_cache()
    return res, checks, counts


def overload_serve_phase(torch, sat, ac, slot):
    """Phase 12 (b): ``InferenceEngine.serve`` with overload control on
    phase 8's chunked engine (8 slots, ``prefill_chunk`` 256, budget 264),
    ``OverloadConfig(queue_cap=32)`` and a pool of 1 + 4P + 2S pages: every
    slot reserves P private pages, so at most four requests run at once,
    and new scene streams wait for pages.  Traffic: phase 6's 20 cls/vqa
    requests (its stream without the det requests), priorities
    alternating bulk and urgent."""
    from repro_torch.kernels import ops
    from repro_torch.serving import (PRIORITY_URGENT, EngineConfig,
                                     InferenceEngine, OverloadConfig)
    from repro_torch.serving.kv_pool import TRASH_PAGE
    av = ac.num_classes + 1
    t_phase = time.perf_counter()
    cfg = dict(slots=8, page_size=8, answer_vocab=av, prefill_chunk=256)
    probe = InferenceEngine(sat.params, sat.cfg, ac, EngineConfig(**cfg),
                            device="cuda").core
    pool = 1 + 4 * probe._private_per_slot + 2 * probe._n_shared_pages
    eng = InferenceEngine(sat.params, sat.cfg, ac, EngineConfig(
        pool_pages=pool, overload=OverloadConfig(queue_cap=32), **cfg),
        device="cuda")
    core = eng.core
    eng.warmup()
    stream = scene_stream(["det", "cls", "vqa", "vqa", "vqa", "vqa"], 4,
                          FULL_IMAGE, FULL_GRID, seed=300)
    keep = [i for i, r in enumerate(stream) if r.task != "det"]
    reqs = [stream[i] for i in keep]
    for j, r in enumerate(reqs):
        if j % 2:
            r.priority = PRIORITY_URGENT
    probe_steps = StepProbe(torch, core, first=2, n=4)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    toks = served_tokens(out, reqs)
    bad = [r.task for r, t in zip(reqs, toks)
           if len(t) != ac.answer_len(r.task) or t.min() < 0
           or t.max() >= av]
    sched, kv = core.scheduler_stats(), core.kv_stats()
    steps, fused = sched["steps"], sched["fused_steps"]
    n_layers = sat.cfg.num_layers
    agree = [bool((a == slot["tokens"][i]).all())
             for a, i in zip(toks, keep)]
    checks = {
        "every request answered": len(out) == len(reqs) == 20 and not bad,
        "last_rejected == []": eng.last_rejected == [],
        "drained: only resident prefix pages":
            kv["pages_in_use"] == kv["prefix_shared_pages"]
            and kv["prefix_entries_in_use"] == 0
            and bool((core._bt_np == TRASH_PAGE).all()),
        "prefill launches == layers x fused steps, on the tensor cores":
            ops.launches_by_route(counts, "paged_prefill_attention")
            == {"mma": n_layers * fused, "cuda_cores": 0} and fused > 0,
        "decode launches == layers x plain steps, on the tensor cores":
            counts["paged_decode_attention"] == n_layers * (steps - fused)
            and decode_routes(counts, "mma",
                              need=("paged_decode_attention",))[0],
        "no flash prefill, no region scoring":
            ops.launches_by_route(counts, "flash_attention")
            == {"wgmma": 0, "cuda_cores": 0} and counts["region_score"] == 0,
    }
    ol = sched["overload"]
    res = {"pool_pages": pool, "requests": len(out), "steps": steps,
           "fused_steps": fused, "admission_calls": probe_steps.admissions,
           "prefix_hits": core.stats["prefix_hits"],
           "prefix_misses": core.stats["prefix_misses"],
           "answers_equal_to_phase_6": sum(agree), "wall_s": wall,
           "step_ms_mean": 1e3 * sum(probe_steps.step_s)
           / max(len(probe_steps.step_s), 1),
           "scheduler_overload": ol, "launches": counts,
           "seconds": time.perf_counter() - t_phase}
    log(f"  phase 12 (b): {len(out)} answered in {wall:.2f} s, {steps} steps"
        f" ({fused} fused), {ol['preemptions']} preemptions, "
        f"{ol['admissions_deferred']} deferred, prefix hits/misses "
        f"{res['prefix_hits']}/{res['prefix_misses']}, {sum(agree)}/"
        f"{len(agree)} answers equal to phase 6's")
    log(f"  phase 12 (b) checks: {checks}")
    del eng, core, probe
    torch.cuda.empty_cache()
    return res, checks, counts


def overload_phase(torch, sat, ac, slot):
    """Phase 12: overload control at full width on the 2B's slot path,
    (a) a saturated ``EngineCore`` and (b) an overload-controlled chunked
    ``InferenceEngine.serve``; fails on any check of either."""
    t0 = time.perf_counter()
    res_a, checks_a, counts_a = overload_core_phase(torch, sat, ac)
    res_b, checks_b, counts_b = overload_serve_phase(torch, sat, ac, slot)
    log("overload_phase " + json.dumps(
        {"a": res_a, "b": res_b, "seconds": time.perf_counter() - t0},
        default=str))
    bad = [k for k, ok in {**{f"(a) {k}": v for k, v in checks_a.items()},
                           **{f"(b) {k}": v for k, v in checks_b.items()}
                           }.items() if not ok]
    if bad:
        raise RuntimeError(f"phase 12 failed: {bad}")
    return {"launches": {"overload_core": counts_a,
                         "overload_serve_chunked": counts_b}}


# ---------------------------------------------------------------------------
# phase 13: sharded serving (a data-parallel router, tensor-parallel ranks)
# ---------------------------------------------------------------------------

#: phase 13: steps of the det requests' core-level runs (no drain)
SHARD_DET_STEPS = 64
#: phase 13 (a): prefix misses / hits of the router on phase 6's 20 cls/vqa
#: requests at 4 slots a shard: scene A's fifth request overflows its full
#: shard, so A's prefix is prefilled on both (the JAX router's decisions:
#: ``tests/test_torch_sharded.py::test_dp2_phase_13_stream_routes_as_jax``)
SHARD_DP_MISSES, SHARD_DP_HITS = 6, 14


def shard_stream():
    """Phase 6's stream (4 scenes: 1 det, 1 cls, 4 vqa each) with the
    indices of its cls/vqa and of its det requests."""
    stream = scene_stream(["det", "cls", "vqa", "vqa", "vqa", "vqa"], 4,
                          FULL_IMAGE, FULL_GRID, seed=300)
    keep = [i for i, r in enumerate(stream) if r.task != "det"]
    dets = [i for i, r in enumerate(stream) if r.task == "det"]
    return stream, keep, dets


class AdmissionCounter:
    """Counts the ``admit_many`` calls of each of ``cores`` (every call of
    a paged, unchunked engine runs one model step)."""

    def __init__(self, cores):
        self.calls = 0
        for core in cores:
            admit = core.admit_many

            def counted(requests, admit=admit):
                self.calls += 1
                return admit(requests)
            core.admit_many = counted


def det_steps(core, reqs, steps, mark=None):
    """Admit ``reqs`` in one call, then ``steps`` steps of ``core`` and no
    drain (``mark["on"]`` holds during the first step); returns (each
    request's committed tokens, the host seconds of each step, each ending
    in its token fetch)."""
    core.admit_many(reqs)
    times = []
    for k in range(steps):
        if mark is not None:
            mark["on"] = k == 0
        t0 = time.perf_counter()
        core.step()
        times.append(time.perf_counter() - t0)
    if mark is not None:
        mark["on"] = False
    got = {sl.request.request_id: [int(t) for t in sl.tokens]
           for sl in core._slots if sl.active}
    return [got[r.request_id] for r in reqs], times


def in_answer_vocab(reqs, toks, ac, av):
    return all(len(t) == ac.answer_len(r.task) and min(t) >= 0
               and max(t) < av for r, t in zip(reqs, toks))


def sharded_dp_phase(torch, sat, ac, slot):
    """Phase 13 (a): a (2, 1) mesh on the one card, two shard engines of 4
    slots with private pools behind the scene-affine router.
    ``InferenceEngine.serve`` of phase 6's 20 cls/vqa requests, then a
    core-level run of its 4 det requests for ``SHARD_DET_STEPS`` steps,
    held against one engine's run of the same steps and phase 6's
    answers."""
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serving import (EngineConfig, EngineCore,
                                     EngineCoreConfig, InferenceEngine,
                                     make_engine_core)
    av, n_layers = ac.num_classes + 1, sat.cfg.num_layers
    mesh = make_host_mesh(model=1, data=2, devices=["cuda:0"] * 2)
    stream, keep, dets = shard_stream()
    eng = InferenceEngine(sat.params, sat.cfg, ac, EngineConfig(
        slots=8, page_size=8, answer_vocab=av, mesh=mesh), device="cuda")
    core = eng.core
    eng.warmup()
    adm = AdmissionCounter(core.shards)
    reqs = clone_requests([stream[i] for i in keep])
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with PrefillCounter() as prefills:
        out = eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    prefills.check(counts, "phase 13 (a) serve")
    toks = [t.tolist() for t in served_tokens(out, reqs)]
    st, kv = core.stats, core.kv_stats()
    steps = sum(sh.stats["sched"]["steps"] for sh in core.shards)
    per = kv["per_shard"]

    dcore = make_engine_core(sat, ac, EngineCoreConfig(
        slots=8, page_size=8, answer_vocab=av, mesh=mesh))
    dcore.warmup()
    dadm = AdmissionCounter(dcore.shards)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with PrefillCounter() as dprefills:
        got, step_s = det_steps(dcore, clone_requests(
            [stream[i] for i in dets]), SHARD_DET_STEPS)
    torch.cuda.synchronize()
    dcounts = ops.launch_counts()
    dprefills.check(dcounts, "phase 13 (a) det core")
    dsteps = sum(sh.stats["sched"]["steps"] for sh in dcore.shards)
    one = EngineCore(sat, ac, EngineCoreConfig(slots=8, page_size=8,
                                               answer_vocab=av))
    one.warmup()
    want, one_s = det_steps(one, clone_requests([stream[i] for i in dets]),
                            SHARD_DET_STEPS)
    phase6_det = [slot["tokens"][i][:SHARD_DET_STEPS].tolist() for i in dets]
    checks = {
        "every request answered in the answer vocab":
            len(out) == len(reqs) == 20 and in_answer_vocab(reqs, toks, ac,
                                                            av),
        f"prefix misses/hits == the router's {SHARD_DP_MISSES}/"
        f"{SHARD_DP_HITS}": (st["prefix_misses"], st["prefix_hits"])
            == (SHARD_DP_MISSES, SHARD_DP_HITS),
        "per shard 4 + 4 slots, 20 routed":
            [r["slots"] for r in per] == [4, 4]
            and sum(r["routed"] for r in per) == 20,
        "paged launches == layers x (steps + admissions), tensor cores":
            counts["paged_decode_attention"] == n_layers * (steps + adm.calls)
            and decode_routes(counts, "mma",
                              need=("paged_decode_attention",))[0],
        "det core: both shards stepped every step":
            dsteps == 2 * SHARD_DET_STEPS,
        "det core: paged launches == layers x (steps + admissions)":
            dcounts["paged_decode_attention"]
            == n_layers * (dsteps + dadm.calls),
        "det core: every request committed a token a step":
            all(len(t) == SHARD_DET_STEPS for t in got),
    }
    res = {"requests": len(out), "steps": steps, "admission_calls": adm.calls,
           "prefix_misses": st["prefix_misses"],
           "prefix_hits": st["prefix_hits"], "per_shard": per,
           "answers_equal_to_phase_6": sum(
               t == slot["tokens"][i].tolist() for t, i in zip(toks, keep)),
           "wall_s": wall,
           "det_core": {"steps": dsteps, "admission_calls": dadm.calls,
                        "equal_to_one_engine": sum(
                            a == b for a, b in zip(got, want)),
                        "equal_to_phase_6": sum(
                            a == b for a, b in zip(got, phase6_det)),
                        "step_ms_mean": 1e3 * sum(step_s) / len(step_s),
                        "one_engine_step_ms_mean":
                            1e3 * sum(one_s) / len(one_s)},
           "launches": counts, "det_launches": dcounts, "tokens": toks,
           "det_tokens": got, "one_det_tokens": want}
    log(f"  phase 13 (a) dp 2 x tp 1: {len(out)} answered in {wall:.2f} s, "
        f"{steps} shard steps + {adm.calls} admission calls, prefix "
        f"misses/hits {st['prefix_misses']}/{st['prefix_hits']}, routed "
        f"{[r['routed'] for r in per]}, {res['answers_equal_to_phase_6']}/20 "
        f"answers equal to phase 6's; det core {SHARD_DET_STEPS} steps at "
        f"{res['det_core']['step_ms_mean']:.2f} ms (one engine "
        f"{res['det_core']['one_engine_step_ms_mean']:.2f} ms), committed "
        f"tokens equal to one engine's on "
        f"{res['det_core']['equal_to_one_engine']}/4, to phase 6's on "
        f"{res['det_core']['equal_to_phase_6']}/4")
    log(f"  phase 13 (a) checks: {checks}")
    del eng, core, dcore, one
    torch.cuda.empty_cache()
    return res, checks


def sharded_tp_rank(rank):
    """A rank of phase 13 (b)'s tp-2 world on ``cuda:0``: the 2B's weights
    rebuilt from phase 4's seed on the card, the (1, 2) mesh over the
    world's group, then (i) ``InferenceEngine.serve`` of phase 6's 20
    cls/vqa requests, (ii) its 4 det requests on an ``EngineCore`` for
    ``SHARD_DET_STEPS`` steps, the paged decode's inputs kept from the
    first step, (iii) the 20 on a chunked engine (``prefill_chunk`` 256),
    the prefix-append inputs kept from the first fused step with decoding
    slots.  Each run's counts are zeroed just before it and read just
    after; the kernels are held on the kept inputs after that.  Returns
    plain data for the parent."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.spaceverse_pair import SAT_CONFIG
    from repro_torch.core import eo_adapter as EO
    from repro_torch.core.cascade import TierModel
    from repro_torch.distributed import collectives as CO
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serving import (EngineConfig, EngineCore,
                                     EngineCoreConfig, InferenceEngine)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_rank = time.perf_counter()
    ac = EO.EOAdapterConfig(grid=FULL_GRID, image_size=FULL_IMAGE)
    sat = TierModel(EO.init_adapter(SAT_CONFIG, ac, 0, device="cuda"),
                    SAT_CONFIG)
    av, n_layers = ac.num_classes + 1, SAT_CONFIG.num_layers
    mesh = make_host_mesh(model=2, data=1, devices=["cuda:0"] * 2)
    stream, keep, dets = shard_stream()
    out = {"rank": rank, "backend": dist.get_backend(), "layers": n_layers,
           "init_s": time.perf_counter() - t_rank}

    def pool_heads(core):
        return sorted({layer["k"].shape[3] for layer in core._slot_cache})

    def run(tag, core, fn, names=(), when=None):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        CO.reset_all_reduce_counts()
        t0 = time.perf_counter()
        res, held = capture_inputs(torch, fn, list(names), when=when)
        torch.cuda.synchronize()
        out[tag] = {"wall_s": time.perf_counter() - t0,
                    "launches": ops.launch_counts(),
                    "all_reduces": CO.all_reduce_counts(),
                    "pool_kv_heads": pool_heads(core)}
        return res, held

    # (i) serve
    # a gloo all-reduce crosses the host: the ranks' steps run eagerly
    eng = InferenceEngine(sat.params, sat.cfg, ac, EngineConfig(
        slots=8, page_size=8, answer_vocab=av, mesh=mesh,
        cuda_graphs=False), device="cuda")
    eng.warmup()
    adm = AdmissionCounter([eng.core])
    reqs = clone_requests([stream[i] for i in keep])
    resp, _ = run("serve", eng.core, lambda: eng.serve(reqs))
    kv = eng.core.kv_stats()
    out["serve"].update(
        tokens=[t.tolist() for t in served_tokens(resp, reqs)],
        steps=eng.core.stats["sched"]["steps"], admission_calls=adm.calls,
        prefix_hits=eng.core.stats["prefix_hits"],
        prefix_misses=eng.core.stats["prefix_misses"],
        kv={k: kv[k] for k in ("kv_bytes_per_slot", "kv_bytes_per_slot_device",
                               "kv_bytes_total", "kv_bytes_total_device",
                               "tp_kv_shards", "mesh")})
    del eng

    # (ii) the det requests, SHARD_DET_STEPS steps
    core = EngineCore(sat, ac, EngineCoreConfig(slots=8, page_size=8,
                                                answer_vocab=av, mesh=mesh,
                                                cuda_graphs=False))
    core.warmup()
    mark = {"on": False}
    (toks, step_s), held = run(
        "det_core", core, lambda: det_steps(core, clone_requests(
            [stream[i] for i in dets]), SHARD_DET_STEPS, mark),
        ["paged_decode_attention"], when=lambda: mark["on"])
    out["det_core"].update(tokens=toks, steps=core.stats["sched"]["steps"],
                           admission_calls=1,
                           step_ms=[1e3 * s for s in step_s])
    out["det_core"]["held"] = decode_on_path_inputs(
        held, 13, f"tp-2 rank {rank} det core",
        need=("paged_decode_attention",))
    del core

    # (iii) chunked serve
    eng = InferenceEngine(sat.params, sat.cfg, ac, EngineConfig(
        slots=8, page_size=8, answer_vocab=av, prefill_chunk=256,
        mesh=mesh, cuda_graphs=False), device="cuda")
    eng.warmup()
    core = eng.core

    def mixed():                      # a fused step with decoding slots
        return bool(core._streaming) and any(
            sl.active and sl.phase == "decode" for sl in core._slots)

    reqs = clone_requests([stream[i] for i in keep])
    resp, held = run("chunked", core, lambda: eng.serve(reqs),
                     ["paged_prefill_attention"], when=mixed)
    sched = core.scheduler_stats()
    out["chunked"].update(
        tokens=[t.tolist() for t in served_tokens(resp, reqs)],
        steps=sched["steps"], fused_steps=sched["fused_steps"],
        prefix_hits=core.stats["prefix_hits"],
        prefix_misses=core.stats["prefix_misses"])
    out["chunked"]["held"] = prefill_on_path_inputs(
        torch, held["paged_prefill_attention"], phase=13)
    del eng, core
    out["seconds"] = time.perf_counter() - t_rank
    return out


def sharded_tp_phase(torch, ac, slot, dp):
    """Phase 13 (b): two rank processes (``spawn_tp``) on ``cuda:0`` over
    ``gloo``, each running ``sharded_tp_rank``; the parent holds them to
    each other and to the counts the path must give."""
    from repro_torch.launch.mesh import spawn_tp
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    ranks = spawn_tp(sharded_tp_rank, 2, backend="gloo", timeout_s=600)
    world_s = time.perf_counter() - t0
    av = ac.num_classes + 1
    stream, keep, dets = shard_stream()
    kept = [stream[i] for i in keep]
    r0, r1 = ranks
    n_layers = r0["layers"]

    def model_calls(r, tag):
        return r[tag]["steps"] + r[tag].get("admission_calls", 0)

    checks = {
        "both ranks' answers and committed tokens identical": all(
            r0[t]["tokens"] == r1[t]["tokens"]
            for t in ("serve", "det_core", "chunked")),
        "both ranks took the same steps": all(
            model_calls(r0, t) == model_calls(r1, t)
            for t in ("serve", "det_core", "chunked")),
        "serve: prefix misses/hits 4/16": all(
            (r["serve"]["prefix_misses"], r["serve"]["prefix_hits"])
            == (4, 16) for r in ranks),
        "every request answered in the answer vocab, 64 det tokens": all(
            in_answer_vocab(kept, r["serve"]["tokens"], ac, av)
            and in_answer_vocab(kept, r["chunked"]["tokens"], ac, av)
            and all(len(t) == SHARD_DET_STEPS
                    for t in r["det_core"]["tokens"]) for r in ranks),
        "each rank's pools hold KH 1": all(
            r[t]["pool_kv_heads"] == [1] for r in ranks
            for t in ("serve", "det_core", "chunked")),
        "kv_bytes_per_slot_device x 2 == kv_bytes_per_slot": all(
            r["serve"]["kv"]["kv_bytes_per_slot_device"] * 2
            == r["serve"]["kv"]["kv_bytes_per_slot"] for r in ranks),
        "paged launches per rank == layers x (steps + admissions)": all(
            r[t]["launches"]["paged_decode_attention"]
            == n_layers * model_calls(r, t)
            for r in ranks for t in ("serve", "det_core")),
        "chunked: prefix-append == layers x fused, decode == layers x "
        "plain steps, tensor cores": all(
            ops.launches_by_route(r["chunked"]["launches"],
                                  "paged_prefill_attention")
            == {"mma": n_layers * r["chunked"]["fused_steps"],
                "cuda_cores": 0}
            and r["chunked"]["fused_steps"] > 0
            and r["chunked"]["launches"]["paged_decode_attention"]
            == n_layers * (r["chunked"]["steps"]
                           - r["chunked"]["fused_steps"])
            for r in ranks),
        "paged decode on the tensor cores only": all(
            decode_routes(r[t]["launches"], "mma",
                          need=("paged_decode_attention",))[0]
            for r in ranks for t in ("serve", "det_core", "chunked")),
        "all-reduces == 2 x layers a model call": all(
            r[t]["all_reduces"] == {"attn": n_layers * model_calls(r, t),
                                    "mlp": n_layers * model_calls(r, t)}
            for r in ranks for t in ("serve", "det_core", "chunked")),
        "backend gloo": all(r["backend"] == "gloo" for r in ranks),
    }
    det6 = [slot["tokens"][i][:SHARD_DET_STEPS].tolist() for i in dets]
    res = {
        "world_s": world_s, "backend": r0["backend"],
        "rank_seconds": [r["seconds"] for r in ranks],
        "rank_init_s": [r["init_s"] for r in ranks],
        "det_step_ms_mean": [sum(r["det_core"]["step_ms"])
                             / len(r["det_core"]["step_ms"]) for r in ranks],
        "det_step_ms_median": [sorted(r["det_core"]["step_ms"])[
            SHARD_DET_STEPS // 2] for r in ranks],
        "serve_wall_s": [r["serve"]["wall_s"] for r in ranks],
        "chunked_wall_s": [r["chunked"]["wall_s"] for r in ranks],
        "serve_steps": r0["serve"]["steps"],
        "serve_admission_calls": r0["serve"]["admission_calls"],
        "chunked_steps": r0["chunked"]["steps"],
        "chunked_fused_steps": r0["chunked"]["fused_steps"],
        "all_reduces": {t: r0[t]["all_reduces"]
                        for t in ("serve", "det_core", "chunked")},
        "kv": r0["serve"]["kv"],
        "answers_equal_to_phase_6": sum(
            t == slot["tokens"][i].tolist()
            for t, i in zip(r0["serve"]["tokens"], keep)),
        "chunked_answers_equal_to_phase_6": sum(
            t == slot["tokens"][i].tolist()
            for t, i in zip(r0["chunked"]["tokens"], keep)),
        "det_equal_to_phase_6": sum(
            a == b for a, b in zip(r0["det_core"]["tokens"], det6)),
        "det_equal_to_dp2": sum(
            a == b for a, b in zip(r0["det_core"]["tokens"],
                                   dp["det_tokens"])),
        "det_equal_to_one_engine": sum(
            a == b for a, b in zip(r0["det_core"]["tokens"],
                                   dp["one_det_tokens"])),
        "held": {"paged_decode_attention_mma": r0["det_core"]["held"],
                 "paged_prefill_attention_mma": {
                     f"phase 13 tp-2 fused step, {k}": v
                     for k, v in r0["chunked"]["held"].items()}},
        "rank1_held": {"det_core": r1["det_core"]["held"],
                       "chunked": r1["chunked"]["held"]},
        "launches": {f"sharded_tp2_{t} rank {r['rank']}": r[t]["launches"]
                     for r in ranks for t in ("serve", "det_core",
                                              "chunked")}}
    log(f"  phase 13 (b) dp 1 x tp 2 over {res['backend']}: world "
        f"{world_s:.1f} s (ranks {[round(s, 1) for s in res['rank_seconds']]}"
        f" s, weights {[round(s, 1) for s in res['rank_init_s']]} s); det "
        f"step ms by rank {[round(m, 2) for m in res['det_step_ms_mean']]} "
        f"(median {[round(m, 2) for m in res['det_step_ms_median']]}); "
        f"serve {res['serve_steps']} steps + "
        f"{res['serve_admission_calls']} admission calls, chunked "
        f"{res['chunked_steps']} steps ({res['chunked_fused_steps']} fused); "
        f"answers equal to phase 6's {res['answers_equal_to_phase_6']}/20, "
        f"chunked {res['chunked_answers_equal_to_phase_6']}/20; det tokens "
        f"equal to phase 6's on {res['det_equal_to_phase_6']}/4, to (a)'s "
        f"on {res['det_equal_to_dp2']}/4, to one engine's on "
        f"{res['det_equal_to_one_engine']}/4")
    log(f"  phase 13 (b) checks: {checks}")
    return res, checks


def sharded_phase(torch, sat, ac, slot):
    """Phase 13: sharded serving at full width on the 2B, (a) dp 2 x tp 1
    in this process and (b) dp 1 x tp 2 in two rank processes; fails on
    any check of either."""
    t0 = time.perf_counter()
    res_a, checks_a = sharded_dp_phase(torch, sat, ac, slot)
    res_b, checks_b = sharded_tp_phase(torch, ac, slot, res_a)
    held = res_b.pop("held")
    launches = {"sharded_dp2_serve": res_a.pop("launches"),
                "sharded_dp2_det_core": res_a.pop("det_launches"),
                **res_b.pop("launches")}
    for k in ("tokens", "det_tokens", "one_det_tokens"):
        res_a.pop(k)
    res = {"a": res_a, "b": res_b, "seconds": time.perf_counter() - t0}
    log("sharded_phase " + json.dumps(res, default=str))
    bad = [k for k, ok in {**{f"(a) {k}": v for k, v in checks_a.items()},
                           **{f"(b) {k}": v for k, v in checks_b.items()}
                           }.items() if not ok]
    if bad:
        raise RuntimeError(f"phase 13 failed: {bad}")
    return {"launches": launches, "held": held}


# ---------------------------------------------------------------------------
# phase 14: the slot path's captured steps against its eager steps
# ---------------------------------------------------------------------------

#: phase 14: steps of the partial runs ((b) chunked and γ 4, (c) int8)
GRAPH_STEPS = {"chunked": 128, "spec": 64, "int8": 128}
#: phase 14 (d): the vmap oracle's steps at 8 slots
VMAP_STEPS = 16


def stream_steps(core, reqs, steps=None):
    """Admit ``reqs`` as slots free and step ``core`` ``steps`` times (None:
    until every request is answered); returns each request's tokens so far
    (finished or still in a slot) and the number of admission calls."""
    out, queue, admissions = {}, list(reqs), 0
    k = 0
    while (queue or core.active_count()) and (steps is None or k < steps):
        n = min(len(queue), len(core.free_slots()))
        if n:
            core.admit_many(queue[:n])
            admissions += 1
            del queue[:n]
        for r, t in core.step():
            out[r.request_id] = [int(x) for x in t]
        k += 1
    for sl in core._slots:
        if sl.active:
            out[sl.request.request_id] = [int(x) for x in sl.tokens]
    return [out.get(r.request_id, []) for r in reqs], admissions


def eager_and_captured(torch, tag, make, reqs, steps=None, first=16,
                       inspect=None, keep=()):
    """The same requests through two engines from ``make(cuda_graphs)``:
    eager steps, then captured ones.  Each is warmed up, its counts zeroed
    just before its run and read just after; steps [first, first + 8) are
    profiled.  Returns {"eager": ..., "captured": ...} with the tokens,
    launches, step ms on the host clock, the device's busy share, the
    graphs, the pool's bytes and the captures after warmup, and what
    ``inspect(mode, core)`` returns after the counts were read.  The eager
    run keeps the inputs of the ``ops`` functions ``keep`` at every (step
    family, operand shapes) it meets (``capture_inputs(by_family=True)``)
    under "kept": the clones are made the first time each is met, in the
    admissions and first steps, before the profiled window."""
    from repro_torch.kernels import ops
    out = {}
    for mode, graphs in (("eager", False), ("captured", True)):
        core = make(graphs)
        t0 = time.perf_counter()
        core.warmup()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        probe = StepProbe(torch, core, first=first, n=8)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        kept = None
        if keep and not graphs:
            (toks, admissions), kept = capture_inputs(
                torch, lambda: stream_steps(core, clone_requests(reqs),
                                            steps), list(keep),
                by_family=True)
        else:
            toks, admissions = stream_steps(core, clone_requests(reqs),
                                            steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        prof = probe.profile()
        gst = core.graph_stats()
        n_steps = len(probe.step_s)
        out[mode] = {
            "tokens": toks, "launches": counts, "steps": n_steps,
            "admission_calls": admissions, "wall_s": wall,
            "warmup_s": warm_s,
            "step_ms_mean": 1e3 * sum(probe.step_s) / max(n_steps, 1),
            "step_ms_median": 1e3 * sorted(probe.step_s)[n_steps // 2],
            "device_busy_share": prof and prof["device_busy_share"],
            "device_ms_per_step": prof and prof["device_ms_per_step"],
            "top_device_ops": prof and prof["top_device_ops"],
            "graphs": gst["graphs"], "graphs_by_family": gst["by_family"],
            "replays": gst["replays"], "pool_bytes": gst["pool_bytes"],
            "steady_recompiles":
                core.scheduler_stats()["steady_recompiles"]}
        if kept is not None:
            out[mode]["kept"] = kept
        if inspect is not None:
            out[mode].update(inspect(mode, core))
        r = out[mode]
        log(f"  {tag} {mode}: {n_steps} steps + {admissions} admission "
            f"calls in {wall:.2f} s, step {r['step_ms_mean']:.3f} ms mean "
            f"{r['step_ms_median']:.3f} ms median (host clock), device "
            f"busy {r['device_busy_share']}, {r['graphs']} graphs "
            f"({r['pool_bytes']} pool bytes), {r['replays']} replays, "
            f"{r['steady_recompiles']} captures after warmup, warmup "
            f"{warm_s:.2f} s")
        # an engine sits in reference cycles (its wrapped methods): free
        # its pools and graphs before the next engine allocates its own
        del core
        gc.collect()
        torch.cuda.empty_cache()
    e, c = out["eager"], out["captured"]
    out["checks"] = {
        f"{tag}: tokens equal eager and captured": e["tokens"] == c["tokens"],
        f"{tag}: launches equal eager and captured":
            e["launches"] == c["launches"] and e["steps"] == c["steps"],
        f"{tag}: every family captured, none after warmup":
            c["graphs"] > 0 and c["steady_recompiles"] == 0
            and c["replays"] > 0 and e["graphs"] == 0}
    if e["tokens"] != c["tokens"]:
        diff = [i for i, (a, b) in enumerate(zip(e["tokens"], c["tokens"]))
                if a != b]
        log(f"  {tag}: tokens differ on requests {diff}")
    if e["launches"] != c["launches"]:
        log(f"  {tag}: launches differ: "
            f"{ {k: (v, c['launches'][k]) for k, v in e['launches'].items() if v != c['launches'][k]} }")
    return out


def graphs_phase(torch, sat, gs, ac, smi):
    """Phase 14: the slot path's steps eager against captured at full
    width (the 2B and the 7B, full depth, bf16, page 8): (a) phase 6's
    stream (24 requests over 4 scenes, 8 slots) to the end; (b) phase 8's
    chunked engine (chunk 256) and phase 7's γ 4 7B engine drafted by the
    2B (its vqa/cls requests and a det answer drafted locally), each over
    its first steps; (c) phase 6's stream on int8 pools over its first
    steps; (d) the vmap oracle on the 2B for ``VMAP_STEPS`` steps at 8
    slots, its tokens against (a)'s (reported: other GEMM shapes in
    bf16).  Tokens and launches must be equal both ways, and no step
    captured after warmup."""
    from repro_torch.serving import EngineCore, EngineCoreConfig
    av = ac.num_classes + 1
    stream = scene_stream(["det", "cls", "vqa", "vqa", "vqa", "vqa"], 4,
                          FULL_IMAGE, FULL_GRID, seed=300)

    def core_of(tier, draft=None, **kw):
        def make(graphs):
            return EngineCore(tier, ac, EngineCoreConfig(
                slots=8, page_size=8, answer_vocab=av, cuda_graphs=graphs,
                **kw), draft=draft)
        return make

    res = {"card": smi}
    log(f"  card: {smi}")
    res["a_slot"] = eager_and_captured(torch, "(a) 2B slot path",
                                       core_of(sat), stream)
    res["b_chunked"] = eager_and_captured(
        torch, "(b) 2B chunked", core_of(sat, prefill_chunk=256), stream,
        steps=GRAPH_STEPS["chunked"])
    spec_reqs = spec_small_requests() + scene_stream(
        ["det"], 1, FULL_IMAGE, FULL_GRID, seed=500)

    def spec_make(graphs):
        return EngineCore(gs, ac, EngineCoreConfig(
            slots=4, page_size=8, answer_vocab=av, spec_gamma=4,
            cuda_graphs=graphs), draft=sat)

    res["b_spec"] = eager_and_captured(
        torch, "(b) 7B γ 4", spec_make, spec_reqs,
        steps=GRAPH_STEPS["spec"], first=8)
    res["c_int8"] = eager_and_captured(
        torch, "(c) 2B slot path int8", core_of(sat, kv_dtype="int8"),
        stream, steps=GRAPH_STEPS["int8"])
    # (d) the vmap oracle, captured
    vm = EngineCore(sat, ac, EngineCoreConfig(
        slots=8, answer_vocab=av, step_impl="vmap"))
    vm.warmup()
    probe = StepProbe(torch, vm, first=1 << 30)
    first8 = stream[:8]
    toks, _ = stream_steps(vm, clone_requests(first8), VMAP_STEPS)
    torch.cuda.synchronize()
    batched = res["a_slot"]["captured"]["tokens"][:8]
    agree = sum(a == b[:len(a)] for a, b in zip(toks, batched))
    res["d_vmap"] = {
        "steps": len(probe.step_s),
        "step_ms_mean": 1e3 * sum(probe.step_s) / len(probe.step_s),
        "requests_agreeing_with_batched": agree, "requests": len(toks),
        "graphs": vm.graph_stats()["graphs"],
        "steady_recompiles": vm.scheduler_stats()["steady_recompiles"]}
    log(f"  (d) vmap oracle, captured: {len(probe.step_s)} steps at "
        f"{res['d_vmap']['step_ms_mean']:.3f} ms (host clock); {agree} of "
        f"{len(toks)} requests' tokens so far equal to the batched "
        "engine's (bf16, other GEMM shapes: reported)")
    del vm
    torch.cuda.empty_cache()
    checks = {}
    for key in ("a_slot", "b_chunked", "b_spec", "c_int8"):
        checks.update(res[key].pop("checks"))
    checks["(d) vmap: captured, none after warmup"] = (
        res["d_vmap"]["graphs"] > 0
        and res["d_vmap"]["steady_recompiles"] == 0)
    summary = {k: {m: {f: r[m][f] for f in (
        "steps", "step_ms_mean", "step_ms_median", "device_busy_share",
        "device_ms_per_step", "graphs", "pool_bytes", "steady_recompiles",
        "warmup_s", "wall_s")} for m in ("eager", "captured")}
        for k, r in res.items() if k in ("a_slot", "b_chunked", "b_spec",
                                         "c_int8")}
    log("graphs_phase " + json.dumps({"card": smi, **summary,
                                      "d_vmap": res["d_vmap"]}))
    log(f"  phase 14 checks: {checks}")
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise RuntimeError(f"phase 14 failed: {bad}")
    return {"launches": {
        f"graphs_{k}_{m}": res[k][m]["launches"]
        for k in ("a_slot", "b_chunked", "b_spec", "c_int8")
        for m in ("eager", "captured")}}


class FlashOnCudaCores:
    """While active, the model's flash prefill goes to the CUDA-core kernel
    instead of the route ``route`` names: phase 5's yardstick for what the
    tensor-core route moves end to end.  Launches here are not counted on
    any path."""

    def __enter__(self):
        from repro_torch.kernels import ops
        from repro_torch.kernels.flash_attention import launch_cuda_cores
        self.ops, self.orig = ops, ops.flash_attention

        def flash(q, k, v, **kw):
            return launch_cuda_cores(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                **kw).transpose(1, 2)

        ops.flash_attention = flash
        return self

    def __exit__(self, *exc):
        self.ops.flash_attention = self.orig


def breakdown(torch, sat, gs, ac, n_steps: int = 32):
    """Prefill and per-token decode time of each tier (host clock around
    synchronised work); the prefill again with flash on the CUDA-core
    kernel, in turns with the tensor-core route (wgmma, CUDA cores, CUDA
    cores, wgmma); the device time of a profiled prefill and flash's
    in-place time per launch in it; the device's busy share over decode
    steps."""
    import contextlib
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import eo_adapter as EO
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    rng = torch.Generator(device="cuda").manual_seed(7)
    images = torch.rand((1, ac.image_size, ac.image_size, 3), generator=rng,
                        device="cuda")
    prompts = torch.tensor([3], dtype=torch.int32, device="cuda")
    out = {}
    for name, tier in (("sat", sat), ("gs", gs)):
        ptok = ac.prompt_token("vqa", prompts)

        def prefill():
            return EO.prefill_tokens(tier.params, tier.cfg, ac, images, ptok,
                                     1100)

        by_route = {"wgmma": [], "cuda_cores": []}
        for route in ("wgmma", "cuda_cores", "cuda_cores", "wgmma"):
            with (FlashOnCudaCores() if route == "cuda_cores"
                  else contextlib.nullcontext()):
                prefill()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, cache, idx = prefill()
                torch.cuda.synchronize()
                by_route[route].append(1e3 * (time.perf_counter() - t0))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            prefill()
            torch.cuda.synchronize()
            t_prof = time.perf_counter() - t0
        n_flash, flash_ms = kernel_device_ms(
            torch, prof, ["flash_wgmma_kernel"])["flash_wgmma_kernel"]
        busy_prefill = profile_summary(torch, prof, 1, t_prof)
        del prof
        tok = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
        t0 = time.perf_counter()
        for i in range(n_steps):
            logits, cache = T.decode_step(tier.params["backbone"], tier.cfg,
                                          cache, {"tokens": tok}, idx + i)
        torch.cuda.synchronize()
        t_step = (time.perf_counter() - t0) / n_steps
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(8):
                logits, cache = T.decode_step(tier.params["backbone"],
                                              tier.cfg, cache,
                                              {"tokens": tok},
                                              idx + n_steps + i)
            torch.cuda.synchronize()
        # one decode kernel a layer: the tensor-core kernel, no split /
        # combine pair, as the profiler sees the device and as the
        # wrappers count their launches: a short profiler count beside a
        # full launch count is a dropped profiler event, a short launch
        # count a missed launch
        wrapped = ops.launches_by_route(ops.launch_counts(),
                                        "decode_attention")
        dec = kernel_device_ms(torch, prof, ["decode_mma_kernel",
                                             "decode_split_kernel",
                                             "decode_combine_kernel"])
        n_dec = {k.split("_")[1]: v[0] for k, v in dec.items()}
        want = 8 * tier.cfg.num_layers
        log(f"  {name}: 8 profiled decode steps: profiler kernels {n_dec}, "
            f"wrapper launches by route {wrapped}, want {want} on mma")
        if (n_dec != {"mma": want, "split": 0, "combine": 0}
                or wrapped != {"mma": want, "cuda_cores": 0}):
            raise RuntimeError(f"{name}: 8 profiled decode steps: the "
                               f"profiler saw decode kernels {n_dec}, the "
                               f"wrappers launched {wrapped}; want one "
                               f"decode_mma_kernel a layer and step "
                               f"({want})")
        # a decode step streams every layer's weights and the unembedding
        bb = tier.params["backbone"]
        head = bb["embed"].get("head", bb["embed"]["tok"])
        step_bytes = nbytes(*tree_leaves(bb["blocks"]), head)
        out[name] = {
            "prefill_ms": sum(by_route["wgmma"]) / 2,
            "prefill_ms_by_route": by_route,
            "prefill_device_ms": busy_prefill["device_busy_share"]
            * 1e3 * t_prof,
            "prefill_flash_launches": n_flash,
            "prefill_flash_ms_per_launch": flash_ms,
            "decode_step_ms": 1e3 * t_step,
            "decode_kernels_per_step": n_dec["mma"] / 8,
            "decode_launches_by_route": wrapped,
            "decode_kernel_ms_per_launch": dec["decode_mma_kernel"][1],
            "decode_bound_ms": 1e3 * step_bytes / HBM_BYTES_PER_S,
            **profile_summary(torch, prof, 8, 8 * t_step)}
        log(f"  {name}: prefill {out[name]['prefill_ms']:.2f} ms (runs "
            f"{by_route['wgmma']}; with flash on the CUDA cores "
            f"{by_route['cuda_cores']}; device "
            f"{out[name]['prefill_device_ms']:.2f} ms, flash {n_flash} "
            f"launches, {flash_ms:.4f} ms each in place), decode "
            f"step {out[name]['decode_step_ms']:.3f} ms ({n_dec['mma'] // 8}"
            f" decode kernels a step, {dec['decode_mma_kernel'][1]:.4f} ms "
            f"each in place; weight-streaming "
            f"bound {out[name]['decode_bound_ms']:.3f} ms), device busy "
            f"{out[name]['device_busy_share']:.3f}")
    log("breakdown " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 10: the batch evaluator, the baselines and the speculative server
# ---------------------------------------------------------------------------

#: phase 4's threshold settings; cls and vqa then take a median split
BATCH_TAUS = [(0.5, 0.4), (0.0, 1.01), (0.0, 0.0), (1.01, 0.0)]
#: batch per task: the quickstart's 16 for cls and vqa, det at B 2 (1024
#: answer tokens on both tiers, one threshold setting)
BATCH_RUNS = {"cls": 16, "vqa": 16, "det": 2}
#: ``evaluate("cls", ...)`` over EVAL_SAMPLES samples in batches of
#: EVAL_BATCH
EVAL_SAMPLES, EVAL_BATCH = 32, 16
#: the speculative server's γ (phase 7's)
SERVER_GAMMA = 4


def split_tau(scores) -> float:
    """A threshold between the middle two distinct ``scores``: a split
    batch whatever ties the scores hold."""
    import numpy as np
    u = np.unique(scores)
    if len(u) < 2:
        raise RuntimeError(f"stage-0 scores all equal: {u}")
    return float((u[len(u) // 2 - 1] + u[len(u) // 2]) / 2)


def tau_rule_broken(out, taus):
    """Samples of a ``run_batch`` result whose decisions break the τ rule
    (as ``tests/test_cascade.py`` states it): exit at stage s iff the
    scores pass every τ before s and fall below τ_s; no exit iff every
    score passes."""
    scores = to_np(out["conf_scores"])
    off, stage = to_np(out["offload"]), to_np(out["exit_stage"])

    def passes(i, j):
        return scores[i, j] >= taus[min(j, len(taus) - 1)]

    bad = []
    for i, s in enumerate(stage):
        if s >= 0:
            ok = (off[i] and all(passes(i, j) for j in range(s))
                  and not passes(i, s))
        else:
            ok = not off[i] and all(passes(i, j)
                                    for j in range(scores.shape[1]))
        if not ok:
            bad.append(i)
    return bad


class MultiscaleCounter:
    """While active, counts ``OffloadPipeline.multiscale_view`` calls (one
    Eq. 2 region score each)."""

    def __enter__(self):
        from repro_torch.serving.offload import OffloadPipeline
        self.cls, self.orig = OffloadPipeline, OffloadPipeline.multiscale_view
        self.calls = 0

        def view(pipeline, *a, **kw):
            self.calls += 1
            return self.orig(pipeline, *a, **kw)

        OffloadPipeline.multiscale_view = view
        return self

    def __exit__(self, *exc):
        self.cls.multiscale_view = self.orig


def batch_phase(torch, sat, gs, conf, ac, served):
    """Algorithm 1's batch evaluator at full width: ``SpaceVerse.run_batch``
    on cls and vqa at B 16 over ``BATCH_TAUS`` and a median split, det at
    B 2; ``evaluate("cls", ...)`` over 32 samples in batches of 16; the four
    baselines on cls at B 16 (GS-only with a 0.5 random region drop, AI-RG
    at its planned fraction: their draws on the card).  Then a
    ``CascadeServer(spec_gamma=4)`` on phase 4's five vqa/cls requests
    (``served``): tiers, exit stages and bytes must equal phase 4's; token
    agreement is reported (bf16 near-ties may flip an argmax).  Checks:
    every score and probability finite, the τ rule, both routes in the
    split batch, launch counts per path (flash = 28 × prefills on the
    tensor cores, decode on the mma route only, one region score per
    ``multiscale_view``, paged decode for the server, one verify step per
    ground request: phase 4's answers are one token long, so no draft is
    verified here; phases 3 and 7 hold the draft stream); flash, the region
    score and the dense decode held on the evaluator's own first inputs at
    each shape, and the paged decode and verify on the server's."""
    import numpy as np
    from repro_torch.baselines import AIRG, GSOnly, SatelliteOnly, Tabi
    from repro_torch.core.cascade import CascadeConfig, SpaceVerse
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops
    from repro_torch.network.orbit import ContactPlan
    from repro_torch.serving import CascadeServer
    t_phase = time.perf_counter()
    dev = weights_device(sat)
    av = ac.num_classes + 1
    cfg = synthetic.EOTaskConfig(image_size=FULL_IMAGE, grid=FULL_GRID)
    data = {task: synthetic.make_dataset(
                task, EVAL_SAMPLES if task == "cls" else b, seed=600 + i,
                cfg=cfg)
            for i, (task, b) in enumerate(BATCH_RUNS.items())}

    def on_card(task):
        b = BATCH_RUNS[task]
        return (torch.from_numpy(data[task]["images"][:b]).to(dev),
                torch.from_numpy(data[task]["prompts"][:b]).to(dev))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def spaceverse(taus):
        return SpaceVerse(sat, gs, ac, conf,
                          CascadeConfig(taus=taus, answer_vocab=av),
                          device=dev)

    cc = CascadeConfig(answer_vocab=av)
    baselines = {
        "SatelliteOnly": lambda: SatelliteOnly(sat, ac, cc, device=dev),
        "GSOnly keep 0.5": lambda: GSOnly(gs, ac, cc, keep_frac=0.5,
                                          device=dev),
        "Tabi": lambda: Tabi(sat, gs, ac, cc, device=dev),
        "AIRG": lambda: AIRG(sat, gs, ac, cc, device=dev)}

    def drive():
        runs = []
        for task in BATCH_RUNS:
            im, pr = on_card(task)
            s0 = None
            for taus in (BATCH_TAUS + ["median"] if task != "det"
                         else BATCH_TAUS[:1]):
                split = taus == "median"
                if split:
                    taus = (split_tau(s0), 0.0)
                out, sec = timed(
                    lambda: spaceverse(taus).run_batch(task, im, pr))
                s0 = to_np(out["conf_scores"])[:, 0]
                runs.append((task, taus, out, sec, split))
        ev = timed(lambda: spaceverse(BATCH_TAUS[0]).evaluate(
            "cls", data["cls"], batch_size=EVAL_BATCH))
        im, pr = on_card("cls")
        base = {name: timed(lambda: make().run_batch(im, pr, "cls"))
                for name, make in baselines.items()}
        return runs, ev, base

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with PrefillCounter() as prefills, MultiscaleCounter() as views:
        (runs, (ev, ev_s), base), path_in = capture_inputs(
            torch, drive, ["flash_attention", "region_score",
                           *DENSE_DECODE_OPS])
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    prefills.check(counts, "phase 10 batch evaluator")
    ok_decode, decode_by_route = decode_routes(counts, "mma",
                                               need=("decode_attention",))

    res = {"runs": [], "baselines": {}}
    finite, tau_rule, answers, split = True, [], True, []
    for task, taus, out, sec, is_split in runs:
        b = BATCH_RUNS[task]
        off, lat = to_np(out["offload"]), out["latency_s"]
        for key in ("conf_scores", "sat_probs", "gs_probs", "region_scores"):
            finite &= bool(np.isfinite(to_np(out[key])).all())
        finite &= bool(np.isfinite(lat).all() and (lat > 0).all())
        tau_rule += [(task, taus, i) for i in tau_rule_broken(out, taus)]
        for key in ("sat_pred", "gs_pred", "pred"):
            p = to_np(out[key])
            answers &= bool(p.min() >= 0 and p.max() < av)
        if is_split:
            split.append(0 < off.sum() < b)
        r = {"task": task, "taus": list(taus), "batch": b, "wall_s": sec,
             "samples_per_s": b / sec,
             "modelled_mean_latency_s": float(lat.mean()),
             "offload_rate": float(off.mean()),
             "exit_stages": to_np(out["exit_stage"]).tolist()}
        res["runs"].append(r)
        log(f"  run_batch {task} B{b} taus {tuple(round(t, 4) for t in taus)}"
            f": wall {sec:.3f} s ({b / sec:.2f} samples/s), modelled mean "
            f"latency {r['modelled_mean_latency_s']:.4f} s, offload rate "
            f"{r['offload_rate']:.3f}")
    res["evaluate"] = {k: ev[k] for k in ("performance", "latency_s",
                                          "offload_rate")}
    res["evaluate"].update(wall_s=ev_s, samples_per_s=EVAL_SAMPLES / ev_s)
    log(f"  evaluate cls {EVAL_SAMPLES} samples in batches of {EVAL_BATCH}: "
        f"{json.dumps(res['evaluate'])}")
    for name, (out, sec) in base.items():
        p, lat = to_np(out["pred"]), out["latency_s"]
        answers &= bool(p.min() >= 0 and p.max() < av)
        finite &= bool(np.isfinite(lat).all() and (lat > 0).all())
        off = to_np(out.get("offload", np.zeros(len(p), bool)))
        res["baselines"][name] = {
            "wall_s": sec, "samples_per_s": len(p) / sec,
            "modelled_mean_latency_s": float(lat.mean()),
            "offload_rate": float(off.mean())}
        log(f"  baseline {name} cls B{len(p)}: "
            f"{json.dumps(res['baselines'][name])}")

    # the speculative server on phase 4's vqa/cls requests
    server = CascadeServer(sat, gs, ac, conf, cc, spec_gamma=SERVER_GAMMA,
                           plan=ContactPlan(contact_fraction_override=1.0),
                           device=dev)
    server.warmup()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    def serve_spec():
        spec = []
        for taus, req, want, _ in served[:5]:
            server.cc = CascadeConfig(taus=taus, answer_vocab=av)
            got, sec = timed(lambda: server.handle(req, now=req.t_arrival))
            spec.append((taus, req, want, got, sec))
        return spec


    with PrefillCounter() as spec_prefills, MultiscaleCounter() as spec_views:
        spec, spec_in = capture_inputs(
            torch, serve_spec, [*DENSE_DECODE_OPS, *PAGED_DECODE_OPS])
    torch.cuda.synchronize()
    spec_counts = ops.launch_counts()
    spec_prefills.check(spec_counts, "phase 10 spec server")
    ok_spec_decode, spec_by_route = decode_routes(
        spec_counts, "mma", need=("paged_decode_attention",))
    same_route, tokens_equal = True, 0
    for taus, req, want, got, sec in spec:
        check_response(req, got, ac, av)
        same = (got.tier == want.tier and got.exit_stage == want.exit_stage
                and math.isclose(got.tx_bytes, want.tx_bytes, rel_tol=1e-6))
        same_route &= same
        agree = bool((got.tokens == want.tokens).all())
        tokens_equal += agree
        log(f"  spec server (γ {SERVER_GAMMA}) {req.task} taus {taus}: "
            f"{got.tier}/{got.exit_stage} tx_bytes {got.tx_bytes:.0f} "
            f"(phase 4: {want.tier}/{want.exit_stage} "
            f"{want.tx_bytes:.0f}), tokens {'equal' if agree else 'differ'}"
            f", wall {sec:.3f} s")
    sp = server._gs_spec_core.spec_stats()
    log(f"  spec server (γ {SERVER_GAMMA}) stats: {json.dumps(sp)}")
    held = {"flash_attention_wgmma": flash_on_path_inputs(
                path_in["flash_attention"], phase=10),
            "region_score": region_on_path_inputs(path_in["region_score"],
                                                  phase=10),
            "decode_attention_mma": decode_on_path_inputs(
                {n: path_in[n] for n in DENSE_DECODE_OPS}, 10,
                "batch evaluator"),
            "paged_decode_attention_mma": decode_on_path_inputs(
                spec_in, 10, "spec server", need=PAGED_DECODE_OPS)}
    checks = {
        "scores, probabilities and latencies finite": finite,
        "decisions obey the τ rule": not tau_rule,
        "median splits take both routes": bool(split) and all(split),
        "answers in the answer vocabulary": answers,
        "region score once per multiscale_view":
            views.calls > 0 and counts["region_score"] == views.calls,
        "decode on the tensor cores only": ok_decode,
        "spec server: tiers, exit stages, bytes equal to phase 4's":
            same_route,
        "spec server: paged decode/verify launched":
            spec_counts["paged_decode_attention"] > 0,
        "spec server: one verify step per ground request":
            sp["steps"] == sum(got.tier == "ground"
                               for _, _, _, got, _ in spec),
        "spec server: decode on the tensor cores only": ok_spec_decode,
        "spec server: region score once per multiscale_view":
            spec_counts["region_score"] == spec_views.calls,
    }
    res.update(
        spec_server={"tokens_equal_to_phase_4": tokens_equal,
                     "requests": len(spec), "spec_stats": sp,
                     "wall_s": [x[-1] for x in spec]},
        multiscale_views=views.calls, tau_rule_broken=tau_rule,
        decode_launches_by_route=decode_by_route,
        spec_decode_launches_by_route=spec_by_route,
        launches=counts, spec_launches=spec_counts,
        seconds=time.perf_counter() - t_phase)
    log(f"  batch phase: {len(runs)} run_batch calls, {views.calls} "
        f"multiscale views; spec server tokens equal to phase 4's on "
        f"{tokens_equal}/{len(spec)}; phase {res['seconds']:.1f} s")
    log(f"  batch phase checks: {checks}")
    log("batch_phase " + json.dumps(res))
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise RuntimeError(f"batch phase failed: {bad}")
    res["held"] = held
    return res


# ---------------------------------------------------------------------------
# phase 9: the xlstm-125m serve step (prefill + decode) at full width
# ---------------------------------------------------------------------------

#: (B, prompt, decode steps): (i) the prefill_32k length with the batch cut
#: from 32 to 4 for time; (ii) the decode_32k batch of 128 rows after a
#: 512-token prompt
XLSTM_RUNS = {"i prefill_32k B4": (4, 32768, 128),
              "ii decode_32k B128": (128, 512, 64)}
#: the state-continuation check: prefill(CONT_LEN) against
#: prefill(CONT_LEN - CONT_STEPS) + CONT_STEPS decode steps, B 4, at full
#: width with the phase's weights in float32 (TF32 off): last-token logits
#: (std ~1 at random init) within 1e-3 absolute, every recurrent-state leaf
#: within 1e-3 of its largest magnitude, two orders above f32 rounding
#: through 12 layers and far below what a wrong chunk boundary or state
#: operand gives (O(1)).  The same in bf16 is reported beside each path's
#: distance from the f32 result: the two bf16 paths round the hidden
#: states at different places (prefill and decode GEMM shapes, the chunk
#: form's sums against the per-token update), and random-init weights
#: amplify that drift through the 12 layers.
CONT_LEN, CONT_STEPS = 4096, 64
TOL_CONT_LOGITS = 1e-3
TOL_CONT_STATE = 1e-3
#: the same continuation in bf16, limits set from the H100 readings (logits
#: 0.234, states 0.137, argmax 4/4, each path 0.47-0.49 from f32) with about
#: twice their room, so that a change to the port's bf16 casts shows
TOL_CONT_BF16 = {"max_abs_logit_diff": 0.5, "max_state_diff_rel_to_max": 0.25,
                 "prefill_vs_f32_max_abs": 1.0, "decode_vs_f32_max_abs": 1.0}


def kernel_device_ms(torch, prof, names):
    """{name: (launches, device ms per launch)} of the device kernels whose
    name contains each of ``names``, from a ``torch.profiler`` run."""
    out = {}
    for name in names:
        n, us = 0, 0.0
        for e in prof.key_averages():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and name in e.key):
                n += e.count
                us += getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0))
        out[name] = (n, us / 1e3 / max(n, 1))
    return out


def xlstm_greedy(torch, T, params, cfg, tokens, steps):
    """``T.prefill`` on ``tokens`` then ``steps`` greedy ``T.decode_step``s,
    timed on the host clock around synchronised work.  Returns the
    per-phase times, the generated tokens and whether every logit was
    finite (reduced on the device: no host sync inside the loop)."""
    b, s = tokens.shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache, idx = T.prefill(params, cfg, {"tokens": tokens},
                                   s + steps)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    finite = logits.isfinite().all()
    nxt = logits.argmax(-1).to(torch.int32)
    out = [nxt]
    t0 = time.perf_counter()
    for i in range(steps):
        logits, cache = T.decode_step(params, cfg, cache,
                                      {"tokens": nxt[:, None]}, idx + i)
        finite &= logits.isfinite().all()
        nxt = logits.argmax(-1).to(torch.int32)
        out.append(nxt)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    return {"prefill_s": t_prefill, "decode_s": t_decode,
            "finite": bool(finite), "tokens": torch.stack(out, 1),
            "cache": cache, "index": idx + steps}


def xlstm_continuation(torch, T, params, cfg, toks, n_steps):
    """prefill(toks) against prefill(toks[:, :-n_steps]) + n_steps decode
    steps over the same tokens, in float32 (``TOL_CONT_LOGITS``,
    ``TOL_CONT_STATE``) and in the weights' bf16 (``TOL_CONT_BF16``, every
    argmax equal)."""
    import dataclasses
    from repro_torch.tree import tree_map
    s_len = toks.shape[1]

    def both(p, c):
        want, wcache, _ = T.prefill(p, c, {"tokens": toks}, s_len)
        got, cache, idx = T.prefill(p, c, {"tokens": toks[:, :-n_steps]},
                                    s_len)
        for i in range(n_steps):
            t = s_len - n_steps + i
            got, cache = T.decode_step(p, c, cache,
                                       {"tokens": toks[:, t:t + 1]}, idx + i)
        d_state = max(float((a.float() - w.float()).abs().max())
                      / max(float(w.float().abs().max()), 1e-30)
                      for cc, wc in zip(cache, wcache)
                      for a, w in zip(cc.values(), wc.values()))
        return got, want, d_state

    out = {"prompt": s_len, "decode_steps": n_steps}
    f32 = {}
    runs = [("float32", tree_map(lambda t: t.float(), params),
             dataclasses.replace(cfg, dtype="float32"))]
    if cfg.dtype != "float32":
        runs.append((cfg.dtype, params, cfg))
    for name, p, c in runs:
        got, want, d_state = both(p, c)
        r = {"max_abs_logit_diff": float((got - want).abs().max()),
             "argmax_agreement": float((got.argmax(-1) == want.argmax(-1))
                                       .float().mean()),
             "max_state_diff_rel_to_max": d_state}
        if name == "float32":
            f32 = {"prefill": want, "decode": got}
        else:
            r["prefill_vs_f32_max_abs"] = float(
                (want - f32["prefill"]).abs().max())
            r["decode_vs_f32_max_abs"] = float(
                (got - f32["decode"]).abs().max())
        out[name] = r
        log(f"  xlstm continuation {name}: prefill({s_len}) vs prefill("
            f"{s_len - n_steps}) + {n_steps} decode steps: logits max "
            f"|diff| {r['max_abs_logit_diff']:.3e}, argmax agreement "
            f"{r['argmax_agreement']:.3f}, state max |diff| / max |state| "
            f"{d_state:.3e}"
            + ("" if name == "float32" else
               f"; each bf16 path against f32: prefill "
               f"{r['prefill_vs_f32_max_abs']:.3e}, decode "
               f"{r['decode_vs_f32_max_abs']:.3e}"))
    r = out["float32"]
    if not (r["max_abs_logit_diff"] <= TOL_CONT_LOGITS
            and r["max_state_diff_rel_to_max"] <= TOL_CONT_STATE):
        raise RuntimeError(f"xlstm: the prefill state does not continue "
                           f"into decode within {TOL_CONT_LOGITS} (logits) "
                           f"/ {TOL_CONT_STATE} (states) in float32: {r}")
    r = out.get("bfloat16")
    if r and not (r["argmax_agreement"] == 1.0
                  and all(r[k] <= v for k, v in TOL_CONT_BF16.items())):
        raise RuntimeError(f"xlstm: the bf16 continuation is outside "
                           f"{TOL_CONT_BF16} or an argmax differs: {r}")
    return out


def capture_inputs(torch, fn, names, when=None, by_family=False):
    """Runs ``fn()`` with the ``ops`` functions ``names`` wrapped so that
    the first call of each at each set of operand shapes keeps a copy of
    its arguments (the first layer's inputs at that shape on the path),
    counting only calls made while ``when()`` holds if it is given;
    returns (``fn()``'s result, {name: [(args, kwargs), ...]} in call
    order).  A replayed CUDA graph calls no ``ops`` function, so while
    ``when()`` holds and some name has no call kept yet, the engines' steps
    run their bodies eagerly (the same kernels on the same persistent
    tensors; the wrappers count their launches), and replay again after
    that.  With ``by_family`` a call is kept at each (engine step family,
    operand shapes), the family being the ``StepGraphs.run`` step it came
    from (None outside one), and the kept calls come back as {name:
    {(family, shapes): (args, kwargs)}}: meant for an engine that runs
    every step eagerly, so that every step of the run is seen."""
    from repro_torch.kernels import ops
    from repro_torch.serving import graphs
    saved = {n: getattr(ops, n) for n in names}
    got = {n: {} for n in names}
    orig_run = graphs.StepGraphs.run
    family = [None]

    def run(self, name, key, body):
        family[0] = name
        try:
            if (when is None or when()) and not all(got[n] for n in names):
                body()
                return
            orig_run(self, name, key, body)
        finally:
            family[0] = None

    def copy(x):
        if isinstance(x, tuple):
            return tuple(copy(y) for y in x)
        return x.clone() if torch.is_tensor(x) else x

    def shapes(x):
        if isinstance(x, tuple):
            return tuple(shapes(y) for y in x)
        return tuple(x.shape) if torch.is_tensor(x) else None

    def wrap(name):
        def call(*args, **kw):
            key = shapes(args) if when is None or when() else None
            if key is not None and by_family:
                key = (family[0], key)
            if key is not None and key not in got[name]:
                got[name][key] = (copy(args),
                                  {k: copy(v) for k, v in kw.items()})
            return saved[name](*args, **kw)
        return call

    try:
        for n in saved:
            setattr(ops, n, wrap(n))
        graphs.StepGraphs.run = run
        res = fn()
    finally:
        for n, f in saved.items():
            setattr(ops, n, f)
        graphs.StepGraphs.run = orig_run
    if by_family:
        return res, got
    return res, {n: list(g.values()) for n, g in got.items()}


def xlstm_kernels_vs_plain(torch, T, params, cfg, toks, tag):
    """Both scan kernels against their plain versions at one run's sizes,
    on the inputs the path gives them: the first mLSTM and sLSTM layers of
    a prefill over ``toks``, and the first sLSTM layer of the decode step
    after it (carried (h, c, n, m)).  Launches here are not counted: the
    run's counts were read before.  Returns {kernel: {case: max_abs_err}}."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import slstm_scan as SL
    from repro_torch.kernels import ssm_scan as SS
    b, s = toks.shape
    scans = ["ssm_scan", "slstm_scan"]
    (logits, cache, idx), pre = capture_inputs(
        torch, lambda: T.prefill(params, cfg, {"tokens": toks}, s + 1),
        scans)
    nxt = logits.argmax(-1).to(torch.int32)[:, None]
    _, dec = capture_inputs(
        torch, lambda: T.decode_step(params, cfg, cache, {"tokens": nxt},
                                     idx), scans)
    del cache
    sl_key = ("slstm_scan_cluster" if SL.route(
        pre["slstm_scan"][0][0][1].shape[1]) == "cluster" else "slstm_scan")
    args = pre["ssm_scan"][0][0]
    ss_key = ("ssm_scan_mma" if SS.route(args[0].dtype, args[0].shape[-1])
              == "mma" else "ssm_scan")
    errors, out = [], {ss_key: {}, sl_key: {}}
    case = f"xlstm {tag} prefill B{b} S{s}"
    out[ss_key][case] = ssm_check(case, ops.ssm_scan(*args),
                                  ref.ssm_scan(*args), errors)
    for case, args in ((case, pre["slstm_scan"][0][0]),
                       (f"xlstm {tag} decode B{b} carried state",
                        dec["slstm_scan"][0][0])):
        out[sl_key][case] = slstm_check(
            case, ops.slstm_scan(*args), ref.slstm_scan(*args), TOL_SLSTM,
            errors)
    if errors:
        raise RuntimeError(f"xlstm {tag}: kernels disagree with their plain "
                           f"versions: {errors}")
    return out


def xlstm_phase(torch, cfg=None, runs=None, cont=(CONT_LEN, CONT_STEPS)):
    """The serve step of xlstm-125m (12 layers: 8 mLSTM, 4 sLSTM; d 768,
    4 heads, vocab 50304, bf16, random weights from a seed) through the
    port's ``transformer.prefill`` and ``decode_step``, greedy decoding in
    this loop.  Checks every logit finite; per run, with the counts zeroed
    just before it, ``ssm_scan`` = 8 × prefills and ``slstm_scan`` = 4 ×
    (prefills + decode steps) and no attention kernel; both kernels
    against their plain versions at the run's sizes; the state
    continuation within its tolerance.  Prints prefill ms and tokens/s,
    each kernel's in-place time per launch (profiled prefill), decode step
    ms and tokens/s, the device busy share over 8 profiled decode steps
    and the decode step's bound (the recurrent states read and written
    once, every weight read once)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.configs.base import MLSTM, SLSTM
    from repro_torch.kernels import ops
    from repro_torch.kernels import slstm_scan as SL
    from repro_torch.kernels import ssm_scan as SS
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    cfg = cfg or configs.get_config("xlstm-125m")
    runs = runs or XLSTM_RUNS
    n_m = cfg.n_super * sum(sp.kind == MLSTM for sp in cfg.block_pattern)
    n_s = cfg.n_super * sum(sp.kind == SLSTM for sp in cfg.block_pattern)
    sl_route = SL.route(cfg.d_model // cfg.resolved_ssm_heads)
    sl_kernels = ["slstm_scan_kernel", "slstm_cluster_kernel"]
    # the mLSTM's scan: dk = 2·d / heads, in the weights' dtype
    ss_route = SS.route(getattr(torch, cfg.dtype),
                        2 * cfg.d_model // cfg.resolved_ssm_heads)
    ss_kernels = ["ssm_scan_kernel", "ssm_scan_mma_kernel"]
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=9, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    weight_bytes = nbytes(*tree_leaves(params))
    log(f"  init {cfg.name}: {n_params / 1e6:.1f} M params ({n_m} mLSTM, "
        f"{n_s} sLSTM layers), {weight_bytes / 1e9:.3f} GB, "
        f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(90)

    def tokens(b, s):
        return torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                             device="cuda", dtype=torch.int32)

    xlstm_greedy(torch, T, params, cfg, tokens(2, 64), 2)     # warm-up
    res, launches = {}, {}
    for tag, (b, s, steps) in runs.items():
        toks = tokens(b, s)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        g = xlstm_greedy(torch, T, params, cfg, toks, steps)
        counts = ops.launch_counts()
        launches[tag] = counts
        want = {"ssm_scan": n_m, "slstm_scan": n_s * (1 + steps),
                "ssm_scan_mma": n_m if ss_route == "mma" else 0,
                "slstm_scan_cluster": (n_s * (1 + steps)
                                       if sl_route == "cluster" else 0)}
        bad = {k: v for k, v in counts.items() if v != want.get(k, 0)}
        if bad:
            raise RuntimeError(f"xlstm {tag}: launches {counts}, want "
                               f"{want} and no other kernel")
        if not g["finite"]:
            raise RuntimeError(f"xlstm {tag}: non-finite logits")
        # device busy share over 8 more decode steps, and the kernels'
        # in-place times in a profiled prefill of the same shape
        cache, idx = g["cache"], g["index"]
        nxt = g["tokens"][:, -1]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            for i in range(8):
                logits, cache = T.decode_step(params, cfg, cache,
                                              {"tokens": nxt[:, None]},
                                              idx + i)
                nxt = logits.argmax(-1).to(torch.int32)
            torch.cuda.synchronize()
            t_prof = time.perf_counter() - t1
        busy = profile_summary(torch, prof, 8, t_prof, k=10)
        dec_kernels = kernel_device_ms(torch, prof, sl_kernels)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            T.prefill(params, cfg, {"tokens": toks}, s + 1)
            torch.cuda.synchronize()
        pre_kernels = kernel_device_ms(torch, prof,
                                       [*ss_kernels, *sl_kernels])
        del prof
        vs_plain = xlstm_kernels_vs_plain(torch, T, params, cfg, toks, tag)
        state_bytes = nbytes(*(leaf for c in cache for leaf in c.values()))
        step_bytes = 2 * state_bytes + weight_bytes
        r = {"batch": b, "prompt": s, "decode_steps": steps,
             "prefill_ms": 1e3 * g["prefill_s"],
             "prefill_tokens_per_s": b * s / g["prefill_s"],
             "decode_step_ms": 1e3 * g["decode_s"] / steps,
             "decode_tokens_per_s": b * steps / g["decode_s"],
             "decode_bound_ms": 1e3 * step_bytes / HBM_BYTES_PER_S,
             "decode_bound_bytes": step_bytes,
             "state_bytes_per_row": state_bytes / b,
             "device_busy_share": busy["device_busy_share"],
             "decode_top_device_ops": busy["top_device_ops"],
             "prefill_kernel_ms_per_launch": {
                 k: v[1] for k, v in pre_kernels.items()},
             "decode_slstm_ms_per_launch": {
                 k: v[1] for k, v in dec_kernels.items()},
             "slstm_launches_by_route": ops.launches_by_route(
                 counts, "slstm_scan"),
             "ssm_launches_by_route": ops.launches_by_route(
                 counts, "ssm_scan"),
             "kernel_vs_plain_max_abs_err": vs_plain,
             "launches": counts}
        res[tag] = r
        pk = r["prefill_kernel_ms_per_launch"]
        dk = r["decode_slstm_ms_per_launch"]
        log(f"  xlstm {tag}: prefill {r['prefill_ms']:.1f} ms "
            f"({r['prefill_tokens_per_s']:.0f} tokens/s; in place per "
            f"launch: ssm_scan tensor cores {pk['ssm_scan_mma_kernel']:.3f} / "
            f"CUDA cores {pk['ssm_scan_kernel']:.3f} ms, sLSTM "
            f"cluster {pk['slstm_cluster_kernel']:.3f} / per-row "
            f"{pk['slstm_scan_kernel']:.3f} ms), "
            f"decode step {r['decode_step_ms']:.3f} ms "
            f"({r['decode_tokens_per_s']:.0f} tokens/s, bound "
            f"{r['decode_bound_ms']:.3f} ms, device busy "
            f"{r['device_busy_share']:.3f}; sLSTM cluster "
            f"{dk['slstm_cluster_kernel']:.4f} / per-row "
            f"{dk['slstm_scan_kernel']:.4f} ms a launch); sLSTM launches by "
            f"route {r['slstm_launches_by_route']} (rule: {sl_route}), scan "
            f"launches by route {r['ssm_launches_by_route']} (rule: "
            f"{ss_route})")
        log(f"  xlstm {tag}: top device operations of a decode step "
            f"(name, launches in 8 steps, ms a step):")
        for op, n, ms in r["decode_top_device_ops"]:
            log(f"    {ms:9.4f} ms {n:5d}  {op}")

    # state continuation: the chunk form + the sLSTM state operand against
    # the sequential decode path
    res["continuation"] = xlstm_continuation(torch, T, params, cfg,
                                             tokens(4, cont[0]), cont[1])
    res["launches"] = launches
    log("xlstm_phase " + json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# phase 15: the xlstm-125m on the slot path, eager against captured
# ---------------------------------------------------------------------------

#: phase 15 (b): the 64-slot engine's requests over 8 scenes (each scene
#: one image, these tasks on it): det answers are N_r tokens long, so all
#: 64 rows stay live for the ``XLSTM_WIDE_STEPS`` slot steps the stream is
#: cut at, which cover the profiled steps [16, 24)
XLSTM_WIDE_TASKS = ["det"] * 8
XLSTM_WIDE_SCENES = 8
XLSTM_WIDE_STEPS = 32
#: replays a captured step is timed over (CUDA events, after one more)
REPLAYS = 10


def replay_ms(torch, graph, n: int = REPLAYS) -> float:
    """Device ms of one replay of a captured step: CUDA events around ``n``
    replays, after one warm replay."""
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def xlstm_serve_phase(torch, smi):
    """Phase 15: the vision xlstm-125m (12 layers: 8 mLSTM, 4 sLSTM; d 768,
    4 heads, vocab 50304, bf16, random weights from a seed; N_r = 1024
    region tokens) served by ``EngineCore``'s paged slot path, each stream
    through an eager engine and a captured one (``eager_and_captured``):
    (a) phase 6's stream (24 requests over 4 scenes) on 8 slots to the
    end; (b) 64 det requests over 8 scenes on 64 slots (one admission,
    then ``XLSTM_WIDE_STEPS`` slot steps over 64 live rows' states).
    Checks: tokens and launch counts equal both ways, every request
    answered (in (b): the same number of tokens each) in the answer vocab,
    nothing captured after warmup; ``ssm_scan`` 8 × prefix prefills on its
    tensor-core route, ``slstm_scan`` 4 × (prefix prefills + admission
    calls + slot steps) on its cluster route, no other kernel.  Both
    kernels are held against their plain versions (``TOL_SCAN_BF16`` /
    ``TOL_SCAN``, ``TOL_SLSTM``) on the inputs of every (step family,
    shape) each eager run launched them at (every prefix bucket, the
    admission and the slot step at 8 and at 64 rows), and on (a)'s
    captured engine on one more scene's prefix prefill (``capture_inputs``,
    the body run eagerly on the engine's own buffers).  Prints step ms
    (host clock), device ms a step and the busy share over 8 profiled
    steps, replay ms of each captured prefix prefill bucket, of the
    admission step and of the slot step (CUDA events), answer tokens/s,
    graphs and pool bytes, state bytes per slot and per resident prefix,
    the slot step's bound, beside the card's name and power limit.  Line
    ``xlstm_serve_phase {...}``."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.configs.base import MLSTM, SLSTM
    from repro_torch.core import eo_adapter as EO
    from repro_torch.core.cascade import TierModel
    from repro_torch.kernels import ops, ref
    from repro_torch.serving import EngineCore, EngineCoreConfig
    from repro_torch.serving.kv_pool import TRASH_PAGE
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(configs.get_config("xlstm-125m"),
                              frontend="vision")
    ac = EO.EOAdapterConfig(grid=FULL_GRID, image_size=FULL_IMAGE)
    av = ac.num_classes + 1
    t0 = time.perf_counter()
    tier = TierModel(EO.init_adapter(cfg, ac, 15, device="cuda"), cfg)
    torch.cuda.synchronize()
    weight_bytes = nbytes(*tree_leaves(tier.params))
    n_m = cfg.n_super * sum(sp.kind == MLSTM for sp in cfg.block_pattern)
    n_s = cfg.n_super * sum(sp.kind == SLSTM for sp in cfg.block_pattern)
    log(f"  init {cfg.name} (vision frontend, N_r {ac.n_regions}): "
        f"{weight_bytes / 1e9:.3f} GB of weights, "
        f"{time.perf_counter() - t0:.1f} s; card: {smi}")
    prefix_calls = {}

    def make(slots):
        def make_core(graphs):
            core = EngineCore(tier, ac, EngineCoreConfig(
                slots=slots, page_size=8, answer_vocab=av,
                cuda_graphs=graphs))
            calls, prefill = [], core._prefill_prefixes
            prefix_calls[(slots, graphs)] = calls

            def counted(miss):
                calls.append(len(miss))
                prefill(miss)

            core._prefill_prefixes = counted
            return core
        return make_core

    held = {"ssm_scan_mma": {}, "slstm_scan_cluster": {}}
    errors = []

    @torch.inference_mode()
    def inspect(mode, core):
        slots = core.cfg.slots
        calls = prefix_calls[(slots, mode == "captured")]
        entry = next(iter(core._prefix._entries.values()))
        out = {"prefix_prefill_calls": len(calls),
               "prefix_prefill_rows": sum(calls),
               "state_bytes_per_slot": nbytes(*core._state_leaves) / slots,
               "state_bytes_per_prefix": nbytes(*(
                   x for t in entry.state if t for x in t.values())),
               "slot_step_bound_ms": 1e3 * (
                   weight_bytes + 2 * nbytes(*core._state_leaves))
               / HBM_BYTES_PER_S}
        if mode != "captured":
            return out
        # device ms of each captured step, replayed on inert inputs: the
        # prefix buckets write the trash page, no row is admitted; (a)'s
        # engine is drained, (b)'s cut with its 64 rows live (it is
        # dropped after this)
        fam = core._graphs.families
        core._sync_tables()
        for b in core._buckets.values():
            b["pages"].dev.fill_(TRASH_PAGE)
        core._admit_in.dev.zero_()
        out["replay_ms"] = {
            "prefix_prefill": {kp: replay_ms(torch, g) for kp, (g, _) in
                               sorted(fam["prefix_prefill"].graphs.items())},
            "paged_admit": replay_ms(torch, fam["paged_admit"].graphs[None][0]),
            "slot_step": replay_ms(torch, fam["slot_step"].graphs[None][0])}
        if slots != 8:
            return out
        # one more scene's prefix prefill, its scan inputs kept
        new = scene_stream(["vqa"], 1, FULL_IMAGE, FULL_GRID, seed=900)
        _, kept = capture_inputs(torch, lambda: core.admit_many(new),
                                 ["ssm_scan", "slstm_scan"])
        for args, kw in kept["ssm_scan"]:
            case = f"xlstm serve B{args[0].shape[0]} S{args[0].shape[1]}"
            held["ssm_scan_mma"][case] = {"max_abs_err": ssm_check(
                case, ops.ssm_scan(*args, **kw), ref.ssm_scan(*args, **kw),
                errors)}
        for args, kw in kept["slstm_scan"]:
            case = f"xlstm serve B{args[0].shape[0]} S{args[0].shape[1]}"
            held["slstm_scan_cluster"][case] = {"max_abs_err": slstm_check(
                case, ops.slstm_scan(*args, **kw),
                ref.slstm_scan(*args, **kw), TOL_SLSTM, errors)}
        out["held_on_path"] = {k: {c: v["max_abs_err"] for c, v in d.items()}
                               for k, d in held.items()}
        return out

    def hold_kept(key, kept, slots):
        """Both scans against their plain versions on the eager run's
        inputs at every (family, shape); True if every family that launches
        them, and every prefix bucket the run took, was held."""
        fams = {n: {} for n in kept}
        for name, calls in kept.items():
            dst = held["ssm_scan_mma" if name == "ssm_scan"
                       else "slstm_scan_cluster"]
            for (fam, _), (args, kw) in calls.items():
                b, n_tok = args[0].shape[:2]
                fams[name].setdefault(fam, set()).add(b)
                case = f"xlstm serve {key} {fam} B{b} S{n_tok}"
                if name == "ssm_scan":
                    err = ssm_check(case, ops.ssm_scan(*args, **kw),
                                    ref.ssm_scan(*args, **kw), errors)
                else:
                    err = slstm_check(case, ops.slstm_scan(*args, **kw),
                                      ref.slstm_scan(*args, **kw),
                                      TOL_SLSTM, errors)
                dst[case] = {"max_abs_err": err}
        # the engine's admission buckets: next power of two, capped
        buckets = {min(1 << (n - 1).bit_length(), slots)
                   for n in prefix_calls[(slots, False)]}
        log(f"  ({key}) eager run's scan inputs held at {fams}; prefix "
            f"buckets taken {sorted(buckets)}")
        return (set(fams["ssm_scan"]) == {"prefix_prefill"}
                and set(fams["slstm_scan"]) == {"prefix_prefill",
                                                "paged_admit", "slot_step"}
                and fams["ssm_scan"]["prefix_prefill"] == buckets
                and fams["slstm_scan"]["prefix_prefill"] == buckets
                and fams["slstm_scan"]["paged_admit"] == {slots}
                and fams["slstm_scan"]["slot_step"] == {slots})

    stream = scene_stream(["det", "cls", "vqa", "vqa", "vqa", "vqa"], 4,
                          FULL_IMAGE, FULL_GRID, seed=300)
    wide = scene_stream(XLSTM_WIDE_TASKS, XLSTM_WIDE_SCENES, FULL_IMAGE,
                        FULL_GRID, seed=700)
    scans = ("ssm_scan", "slstm_scan")
    res, checks = {}, {}
    t_phase = time.perf_counter()
    res["a_slot8"] = eager_and_captured(torch, "(a) xlstm-125m 8 slots",
                                        make(8), stream, inspect=inspect,
                                        keep=scans)
    res["b_slot64"] = eager_and_captured(
        torch, "(b) xlstm-125m 64 slots", make(64), wide,
        steps=XLSTM_WIDE_STEPS, inspect=inspect, keep=scans)
    for key, slots in (("a_slot8", 8), ("b_slot64", 64)):
        checks[f"({key}) eager: the scans held against their plain "
               "versions at every prefix bucket, the admission and the "
               f"slot step at {slots} rows"] = hold_kept(
            key, res[key]["eager"].pop("kept"), slots)
    for key, reqs in (("a_slot8", stream), ("b_slot64", wide)):
        r = res[key]
        checks.update(r.pop("checks"))
        for mode in ("eager", "captured"):
            m = r[mode]
            n_pre = m["prefix_prefill_calls"]
            want = {"ssm_scan": n_m * n_pre, "ssm_scan_mma": n_m * n_pre,
                    "slstm_scan": n_s * (n_pre + m["admission_calls"]
                                         + m["steps"])}
            want["slstm_scan_cluster"] = want["slstm_scan"]
            bad = {k: v for k, v in m["launches"].items()
                   if v != want.get(k, 0)}
            if bad:
                log(f"  ({key}) {mode}: launches {bad} against {want}")
            checks[f"{key} {mode}: ssm_scan = {n_m} x prefix prefills on "
                   f"the tensor cores, slstm_scan = {n_s} x (prefills + "
                   "admissions + steps) on the cluster route, no other "
                   "kernel"] = not bad and n_pre > 0
            lens = {len(t) for t in m["tokens"]}
            whole = (all(len(t) == ac.answer_len(q.task)
                         for q, t in zip(reqs, m["tokens"]))
                     if key == "a_slot8" else
                     len(lens) == 1 and min(lens) >= XLSTM_WIDE_STEPS)
            checks[f"{key} {mode}: every request answered (b: the same "
                   "tokens each, at least one a step) in the answer "
                   "vocab"] = whole and all(0 <= x < av for t in m["tokens"]
                                            for x in t)
    checks["the path's scan inputs within their tolerances"] \
        = not errors and all(held.values())
    launches = {f"xlstm_serve_{key}_{mode}": res[key][mode]["launches"]
                for key in ("a_slot8", "b_slot64")
                for mode in ("eager", "captured")}
    summary = {}
    for key in ("a_slot8", "b_slot64"):
        r = res[key]
        summary[key] = {}
        for mode in ("eager", "captured"):
            m = r[mode]
            n_tok = sum(len(t) for t in m.pop("tokens"))
            m.pop("launches")
            m["answer_tokens"] = n_tok
            m["answer_tokens_per_s"] = n_tok / m["wall_s"]
            summary[key][mode] = m
            log(f"  {key} {mode}: step {m['step_ms_mean']:.3f} ms mean "
                f"(host clock), device {m['device_ms_per_step']} ms a step, "
                f"busy {m['device_busy_share']}, {n_tok} answer tokens at "
                f"{m['answer_tokens_per_s']:.1f}/s, {m['prefix_prefill_calls']}"
                f" prefix prefills, state "
                f"{m['state_bytes_per_slot'] / 1e6:.2f} MB a slot and "
                f"{m['state_bytes_per_prefix'] / 1e6:.2f} MB a resident "
                f"prefix, slot step bound {m['slot_step_bound_ms']:.3f} ms"
                + (f"; replays (device ms): {m['replay_ms']}"
                   if "replay_ms" in m else "") + f" [{smi}]")
    res["seconds"] = time.perf_counter() - t_phase
    log("xlstm_serve_phase " + json.dumps({"card": smi, **summary,
                                           "seconds": res["seconds"]}))
    log(f"  phase 15 checks: {checks}")
    bad = [k for k, ok in checks.items() if not ok]
    if bad or errors:
        raise RuntimeError(f"phase 15 failed: {bad} {errors}")
    del tier
    torch.cuda.empty_cache()
    return {"held": held, "launches": launches}


#: phase 16: the dense attention configs, in the order they are served
DENSE_MODELS = ("gemma3-1b", "codeqwen1.5-7b", "glm4-9b", "gemma2-27b")
#: slot steps of each run, eager and captured: phase 6's stream admits its
#: four scenes within them, and steps [16, 24) are profiled
DENSE_STEPS = 24
#: gemma3-1b's further engines: chunked (row 6 at hd 256) and int8 pools
DENSE_G3_RUNS = {"chunked": {"prefill_chunk": 256},
                 "int8": {"kv_dtype": "int8"}}
#: scenes the stream brings: the pool holds their shared prefix pages
#: beside every slot's worst-case private pages, which admission reserves
#: (gemma2-27b's 54 GB of weights leave no room for the engine's default
#: pool, which also counts 8 cache-only prefixes)
DENSE_SCENES = 4
#: the attention ops whose inputs each eager run keeps (first layer, each
#: step family and shape) and holds against their plain versions
DENSE_KEEP = ("flash_attention", "paged_decode_attention",
              "paged_prefill_attention")


def route_of(name, dtype, hd):
    """The route ``ops`` sends a call of kernel ``name`` at (dtype, head
    dim) to: flash's rule for flash, the decode rule for the dense and
    paged decode kernels and prefix-append."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    return (FA if name == "flash_attention" else DA).route(dtype, hd)


def hold_attention(name, args, kw, case, errors):
    """One kept attention call through ``ops`` against its plain version,
    on the route ``route_of`` names: the tensor-core routes to their
    bound (``check_wgmma``, ``check_mma_decode``: paged pools dequantized
    and gathered), the CUDA-core routes to ``TOL_BF16``.  Returns (the
    kernels line's row it belongs to, the max absolute error)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.build import POOL_NAMES
    got = getattr(ops, name)(*args, **kw)
    kw = {k: v for k, v in kw.items() if k not in ("plan", "q_blk")}
    q, *rest = args
    cuda_cores = route_of(name, q.dtype, q.shape[-1]) == "cuda_cores"
    row = name if cuda_cores else ops.ROUTES[name][0]
    if rest[0].dtype in POOL_NAMES:
        row += f"[{POOL_NAMES[rest[0].dtype]}]"
    if cuda_cores:
        return row, check(name, got, getattr(ref, name)(*args, **kw),
                          TOL_BF16, case, errors)
    if name == "flash_attention":
        return row, check_wgmma(name, got, *args, kw, case, errors)[0]
    ks, vs = kw.pop("k_scale", None), kw.pop("v_scale", None)
    if name.startswith("paged"):
        k_pool, v_pool, table, lens = rest
        k = ref.gather_pages(ref.dequantize_pool(k_pool, ks), table)
        v = ref.gather_pages(ref.dequantize_pool(v_pool, vs), table)
    else:
        k, v, lens = rest
    if q.dim() == 3:                    # one token a row: (B, H, hd)
        q, got = q[:, None], got[:, None]
    return row, check_mma_decode(name, got, q, k, v, lens, kw, case,
                                 errors)[0]


def dense_launch_check(ops, counts, dtype, hd, want, kv_dtype):
    """Whether a run's launches are ``want`` ({kernel: count}), each
    wholly on the route ``route_of`` names at (dtype, hd), and no other
    kernel launched (an 8-bit run also counts its paged launches by
    pool).  Returns (ok, what to log)."""
    routes = {k: route_of(k, dtype, hd) for k in want}
    got = {k: counts[k] for k in want}
    on = {k: ops.launches_by_route(counts, k)[r] for k, r in routes.items()}
    allowed = set(want) | {ops.ROUTES[k][0] for k in want}
    if kv_dtype:
        allowed |= {f"{k}[{kv_dtype}]" for k in allowed}
    rest = {k: v for k, v in counts.items() if v and k not in allowed}
    ok = got == want and on == want and not rest
    return ok, f"launches {got} want {want}, on the routes {routes} " \
               f"{on}, other kernels {rest}"


def dense_serve_phase(torch, smi):
    """Phase 16: the dense attention configs (codeqwen1.5-7b, glm4-9b,
    gemma2-27b, gemma3-1b) served at full width and depth, each in turn,
    bf16, random weights from a seed, with the vision frontend and phase
    4's adapter (N_r = 1024 = ``num_patches``), through ``EngineCore``'s
    paged slot path (8 slots, page 8, a pool for the stream's 4 scenes):
    phase 6's stream over its first ``DENSE_STEPS`` steps through an eager
    engine and a captured one (``eager_and_captured``); one
    ``EngineCore.generate`` (vqa, the batch path: flash and dense decode);
    for gemma3-1b the same stream on a chunked engine (``prefill_chunk``
    256) and on int8 pools too.  Each model, its engines and their graph
    pools are freed before the next is built.  Checks, per model: tokens
    and launch counts equal eager and captured, nothing captured after
    warmup, every answer in the answer vocab; flash = layers × prefix
    prefills, paged decode = layers × (steps + admission calls) (chunked:
    prefix-append = layers × fused steps, paged decode = layers × plain
    steps, no flash), each on the route its kernel's ``route()`` gives
    the model's dtype and head dim (``route_of``; bf16 at hd 128: the
    tensor cores, at hd 256: the CUDA cores) and none on the other, no
    other kernel; generate: flash and dense decode once a layer; every kept
    input held against the plain version.  Prints weight bytes, the
    prefix prefill's replay ms by bucket, step ms (host clock) eager and
    captured, device ms a step and busy share (8 profiled steps), the
    step's weight-streaming bound, answer tokens/s, pool and graph-pool
    bytes, memory allocated at the phase's start and each model's peak,
    beside the card's name and power limit.  Line
    ``dense_serve_phase {...}``."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.core import eo_adapter as EO
    from repro_torch.core.cascade import TierModel
    from repro_torch.kernels import ops
    from repro_torch.serving import EngineCore, EngineCoreConfig
    from repro_torch.serving.kv_pool import TRASH_PAGE, page_nbytes
    from repro_torch.tree import tree_leaves
    ac = EO.EOAdapterConfig(grid=FULL_GRID, image_size=FULL_IMAGE)
    av = ac.num_classes + 1
    stream = scene_stream(["det", "cls", "vqa", "vqa", "vqa", "vqa"],
                          DENSE_SCENES, FULL_IMAGE, FULL_GRID, seed=300)
    t_phase = time.perf_counter()
    gc.collect()                    # engines of earlier phases in cycles
    torch.cuda.empty_cache()
    start_bytes = torch.cuda.memory_allocated()
    log(f"  {start_bytes / 1e9:.3f} GB allocated at the phase's start "
        f"[{smi}]")
    summary, checks, launches, held, errors = {}, {}, {}, {}, []
    for n_model, name in enumerate(DENSE_MODELS):
        log(f"  {torch.cuda.memory_allocated() / 1e9:.3f} GB allocated "
            f"before {name}")
        torch.cuda.reset_peak_memory_stats()
        t_model = time.perf_counter()
        cfg = dataclasses.replace(configs.get_config(name),
                                  frontend="vision")
        hd, n_l = cfg.resolved_head_dim, cfg.num_layers
        dtype = getattr(torch, cfg.dtype)
        attn = "/".join(sorted({route_of(k, dtype, hd) for k in DENSE_KEEP}))
        t0 = time.perf_counter()
        tier = TierModel(EO.init_adapter(cfg, ac, 16 + n_model,
                                         device="cuda"), cfg)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        weight_bytes = nbytes(*tree_leaves(tier.params))
        embed = tier.params["backbone"]["embed"]
        # a decode step streams every weight but an untied input table
        streamed = weight_bytes - (0 if cfg.tie_embeddings
                                   else nbytes(embed["tok"]))
        m = {"weight_bytes": weight_bytes, "init_s": init_s,
             "step_bound_ms": 1e3 * streamed / HBM_BYTES_PER_S,
             "layers": n_l, "heads": (cfg.num_heads, cfg.num_kv_heads),
             "head_dim": hd, "runs": {}}
        log(f"  {name}: {weight_bytes / 1e9:.2f} GB of weights in "
            f"{init_s:.1f} s, {n_l} layers, heads {cfg.num_heads}/"
            f"{cfg.num_kv_heads}, hd {hd}; card: {smi}")
        prefix_calls = {}
        # the stream's pages: trash + 8 slots' private pages (past the
        # N_r-token prefix: the prompt and the longest answer) + the
        # scenes' shared pages
        shared = ac.n_regions // 8
        private = -(-(2 * ac.n_regions + 1) // 8) - shared
        n_pages = 1 + 8 * private + DENSE_SCENES * shared

        def make(key, **kw):
            page_bytes = cfg.num_layers * page_nbytes(
                8, cfg.num_kv_heads, hd, kv_dtype=kw.get("kv_dtype"),
                fp_bytes=getattr(torch, cfg.dtype).itemsize)

            def make_core(graphs):
                core = EngineCore(tier, ac, EngineCoreConfig(
                    slots=8, page_size=8, answer_vocab=av,
                    prefix_cache_scenes=DENSE_SCENES,
                    pool_bytes=n_pages * page_bytes, cuda_graphs=graphs,
                    **kw))
                calls, prefill = [], core._prefill_prefixes
                prefix_calls[(key, graphs)] = calls

                def counted(miss):
                    calls.append(len(miss))
                    prefill(miss)

                core._prefill_prefixes = counted
                return core
            return make_core

        @torch.inference_mode()
        def inspect(mode, core, key):
            out = {"kv_bytes_total": core.kv_stats()["kv_bytes_total"],
                   "n_pages": core._n_pages,
                   "fused_steps": core.stats["sched"]["fused_steps"],
                   "prefix_prefill_calls": len(
                       prefix_calls[(key, mode == "captured")])}
            if mode == "captured" and key == "paged":
                # device ms of the captured prefix prefill (each bucket),
                # the admission and the slot step, replayed on inert
                # inputs (the buckets write the trash page)
                fam = core._graphs.families
                core._sync_tables()
                for b in core._buckets.values():
                    b["pages"].dev.fill_(TRASH_PAGE)
                core._admit_in.dev.zero_()
                # three replays a bucket: gemma2-27b's bucket 8 is ~0.7 s
                out["replay_ms"] = {
                    "prefix_prefill": {
                        kp: replay_ms(torch, g, 3) for kp, (g, _)
                        in sorted(fam["prefix_prefill"].graphs.items())},
                    "paged_admit": replay_ms(
                        torch, fam["paged_admit"].graphs[None][0]),
                    "slot_step": replay_ms(
                        torch, fam["slot_step"].graphs[None][0])}
            if mode == "eager" and key == "paged":
                # the batch path: one vqa answer (prefill + one decode
                # step), its attention inputs kept
                req = stream[2]
                image = torch.from_numpy(req.image[None]).cuda()
                prompt = torch.tensor([req.prompt], dtype=torch.int32,
                                      device="cuda")
                ops.reset_launch_counts()
                (toks, _), kept = capture_inputs(
                    torch, lambda: core.generate("vqa", image, prompt, av),
                    ["flash_attention", "decode_attention"])
                torch.cuda.synchronize()
                out["generate"] = {"launches": ops.launch_counts(),
                                   "tokens": toks.tolist(), "kept": kept}
            return out

        runs = {"paged": {}}
        if name == "gemma3-1b":
            runs.update(DENSE_G3_RUNS)
        for key, kw in runs.items():
            tag = f"(16) {name} {key}"
            r = eager_and_captured(
                torch, tag, make(key, **kw), stream, steps=DENSE_STEPS,
                inspect=lambda mode, core, key=key: inspect(mode, core, key),
                keep=DENSE_KEEP)
            checks.update(r.pop("checks"))
            kept = r["eager"].pop("kept")
            for op, d in kept.items():
                for (fam, shapes), (args, kwargs) in d.items():
                    case = f"phase 16 {name} {key} {fam} {shapes[0]}"
                    row, err = hold_attention(op, args, kwargs, case, errors)
                    held.setdefault(row, {})[case] = {"max_abs_err": err}
            checks[f"{tag}: inputs kept for every attention op it ran"] = (
                bool(kept["paged_decode_attention"])
                and bool(kept["paged_prefill_attention" if "prefill_chunk"
                              in kw else "flash_attention"]))
            kept = None
            for mode in ("eager", "captured"):
                e = r[mode]
                c = e.pop("launches")
                launches[f"dense_{name}_{key}_{mode}"] = c
                n_pre, steps = e["prefix_prefill_calls"], e["steps"]
                fused = e["fused_steps"]
                want = {"flash_attention": n_l * n_pre,
                        "paged_decode_attention": n_l * (
                            steps - fused + (0 if fused
                                             else e["admission_calls"])),
                        "paged_prefill_attention": n_l * fused}
                ok, what = dense_launch_check(ops, c, dtype, hd, want,
                                              kw.get("kv_dtype"))
                log(f"  {tag} {mode}: {what}")
                checks[f"{tag} {mode}: flash = {n_l} x prefix prefills, "
                       f"paged decode = {n_l} x (plain steps + admissions),"
                       f" prefix-append = {n_l} x fused steps, all on the "
                       f"{attn} route, no other kernel"] = (
                    ok and steps > 0 and (n_pre > 0 or fused > 0))
                toks = e.pop("tokens")
                checks[f"{tag} {mode}: every token in the answer vocab"] = (
                    all(0 <= x < av for t in toks for x in t)
                    and sum(map(len, toks)) > 0)
                e["answer_tokens"] = sum(len(t) for t in toks)
                e["answer_tokens_per_s"] = e["answer_tokens"] / e["wall_s"]
                gen = e.pop("generate", None)
                if gen is None:
                    continue
                c = gen["launches"]
                launches[f"dense_{name}_generate"] = c
                for op, calls in gen["kept"].items():
                    for i, (args, kwargs) in enumerate(calls):
                        case = f"phase 16 {name} generate {op} {i}"
                        row, err = hold_attention(op, args, kwargs, case,
                                                  errors)
                        held.setdefault(row, {})[case] = {"max_abs_err": err}
                ok, what = dense_launch_check(
                    ops, c, dtype, hd, {"flash_attention": n_l,
                                        "decode_attention": n_l}, None)
                log(f"  (16) {name} generate: {what}")
                checks[f"(16) {name} generate: flash and dense decode "
                       f"{n_l} times each on the {attn} route, one answer "
                       f"token in the vocab"] = (
                    ok and len(gen["tokens"][0]) == 1
                    and 0 <= gen["tokens"][0][0] < av)
                e["generate_tokens"] = gen["tokens"]
                gen = None
            m["runs"][key] = r
        m["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        m["seconds"] = time.perf_counter() - t_model
        summary[name] = m
        for key, r in m["runs"].items():
            for mode in ("eager", "captured"):
                e = r[mode]
                log(f"  {name} {key} {mode}: step {e['step_ms_mean']:.3f} ms "
                    f"mean {e['step_ms_median']:.3f} median (host clock), "
                    f"device {e['device_ms_per_step']} ms a step, busy "
                    f"{e['device_busy_share']}, bound "
                    f"{m['step_bound_ms']:.3f} ms, {e['answer_tokens']} "
                    f"answer tokens at {e['answer_tokens_per_s']:.1f}/s, "
                    f"pool {e['kv_bytes_total'] / 1e9:.2f} GB, graph pool "
                    f"{e['pool_bytes'] / 1e9:.2f} GB"
                    + (f"; replays (device ms): {e['replay_ms']}"
                       if "replay_ms" in e else "") + f" [{smi}]")
        log(f"  {name}: peak {m['max_memory_allocated'] / 1e9:.2f} GB "
            f"allocated, {m['seconds']:.1f} s [{smi}]")
        del tier
        gc.collect()
        torch.cuda.empty_cache()
    checks["the path's attention inputs within their tolerances"] = (
        not errors and bool(held))
    res = {"card": smi, "start_memory_allocated": start_bytes,
           "models": summary, "seconds": time.perf_counter() - t_phase}
    log("dense_serve_phase " + json.dumps(res, default=str))
    log(f"  phase 16 checks: {checks}")
    bad = [k for k, ok in checks.items() if not ok]
    if bad or errors:
        raise RuntimeError(f"phase 16 failed: {bad} {errors}")
    return {"held": held, "launches": launches}


# ---------------------------------------------------------------------------
# phase 17: training (the 2B at full width, the proxies' build_system)
# ---------------------------------------------------------------------------

#: (a): a fixed teacher-forced batch per task, B 4: S 2048 (det), 1025
#: (vqa, cls); TRAIN_ROUNDS steps on each in a row, det first from the
#: fresh weights (its answers, 0/1 region tokens, are what the vqa steps
#: teach too: after them the det loss starts near 0 and only moves with
#: the other tasks' steps); remat "nothing"
TRAIN_TASKS = ("det", "vqa", "cls")
TRAIN_B = 4
TRAIN_ROUNDS = 4
#: (b): ``build_system`` at the test suite's tiny-bundle settings
TRAIN_PROXY = {"scale": "small", "n_train": 64, "n_test": 32,
               "proxy_steps": 60, "conf_steps": 80, "tasks": ("vqa", "cls")}
#: card against CPU in (b): the first step's losses (the same weights,
#: batch and draws, f32 on both, TF32 off: only the sums' order differs)
#: within 1e-4 relative; the last losses, whose gaps grow step by step,
#: within ``TOL_PROXY_FINAL`` relative, 4x a reading on an H100 (NVIDIA
#: H100 80GB HBM3, 700 W; the gaps repeat bit for bit run to run: the
#: satellite tier after 60 steps 3.6e-7, the ground tier after 90 4.2e-3,
#: the confidence net, trained on targets made by both tiers and so
#: carrying the ground tier's gap, 0.133), rounded up.  The growth is the
#: training's own: a CPU run whose initial weights are one ulp up
#: (``nudged_init``) drifts from the CPU run about as far (its readings
#: are in PERF.md), and each card gap's largest over the steps must stay
#: within ``WITNESS_FACTOR`` times the witness's
TOL_PROXY_FIRST = 1e-4
TOL_PROXY_FINAL = {"sat_losses": 1.5e-6, "gs_losses": 0.02,
                   "conf_losses": 0.55}
WITNESS_FACTOR = 4.0


def train_step_flops(cfg, b, s):
    """(model FLOPs of one train step: forward + backward of the matmuls
    (3 x 2 per weight per token), the attention forward and its backward
    (2.5x); FLOPs executed: that plus the remat's second forward of the
    blocks and of the CE chunks' unembedding)."""
    import torch
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    per_layer = d * (2 * nq + 2 * nkv) + 3 * d * cfg.d_ff
    blocks = 2.0 * b * s * per_layer * cfg.num_layers
    head = 2.0 * b * s * d * cfg.vocab_size
    attn = b * cfg.num_layers * flash_flops(torch, cfg.num_heads, hd, s, s)
    model = 3 * (blocks + head) + attn * (1 + 2.5)
    return model, model + blocks + attn + head


def train_batches(torch, params, cfg, ac, seed: int = 0):
    """The fixed full-width batch of each task: ``make_dataset`` images at
    the full adapter, answers from the labels, ``EO.build_batch``."""
    from repro_torch.core import eo_adapter as EO
    from repro_torch.data import synthetic
    eo = synthetic.EOTaskConfig(image_size=ac.image_size, grid=ac.grid,
                                num_classes=ac.num_classes)
    out = {}
    for i, task in enumerate(TRAIN_TASKS):
        d = synthetic.make_dataset(task, TRAIN_B, seed=seed + i, cfg=eo)
        t = {k: torch.from_numpy(d[k]).to("cuda")
             for k in ("images", "prompts", "labels", "region_rel")}
        answers = EO.answers_from_labels(ac, task, t["labels"],
                                         t["region_rel"])
        with torch.no_grad():
            out[task] = EO.build_batch(params, cfg, ac, task, t["images"],
                                       t["prompts"], answers)
    return out


def train_full_width(torch, smi):
    """(a) ``make_train_step`` on the 2B at full width (random bf16 weights
    from seed 0), remat "nothing", ce_chunks 8, ``TRAIN_ROUNDS`` steps in a
    row on each task's fixed batch, counts zeroed just before.  Checks:
    every loss finite; the det batch's loss falls at every step;
    ``flash_attention_bwd`` 28 launches a step, all on the tensor-core
    route (``flash_attention_bwd_wgmma``), none on the CUDA cores; the
    wgmma forward 56 (the forward and the remat's recompute), no CUDA-core
    flash; the backward kernel held against its plain version, under its
    bound (``check_bwd_wgmma``), on layer 0's inputs of an extra det step
    after the profiled one (neither timed nor counted: the capture clones
    each call's inputs).  Reports step ms by task, one profiled det step
    (device ms, busy share, the backward's kernels' device ms) and, last,
    one profiled vqa step (device ms, busy share), tokens/s, peak memory
    and the step's FLOPs beside their bound."""
    from repro_torch.configs.spaceverse_pair import SAT_CONFIG
    from repro_torch.core import eo_adapter as EO
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops, ref
    from repro_torch.train import optimizer as O
    from repro_torch.train import trainer as TR
    from repro_torch.tree import tree_leaves
    cfg = SAT_CONFIG
    ac = EO.EOAdapterConfig(grid=FULL_GRID, image_size=FULL_IMAGE)
    t_phase = time.perf_counter()
    adapter = EO.init_adapter(cfg, ac, 0, device="cuda")
    batches = train_batches(torch, adapter, cfg, ac)
    params = adapter["backbone"]
    del adapter
    # the JAX package's default AdamW (lr 3e-4) without its warmup
    opt_cfg = O.OptConfig(warmup_steps=1, total_steps=1000)
    step = TR.make_train_step(cfg, opt_cfg, TR.TrainConfig(
        remat=True, remat_policy="nothing", ce_chunks=8))
    opt_state = O.init_opt_state(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = {t: [] for t in TRAIN_TASKS}
    ms = {t: [] for t in TRAIN_TASKS}
    n_steps = TRAIN_ROUNDS * len(TRAIN_TASKS)
    ops.reset_launch_counts()
    for task in TRAIN_TASKS:
        for _ in range(TRAIN_ROUNDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt_state, m = step(params, opt_state, batches[task])
            torch.cuda.synchronize()
            ms[task].append(1e3 * (time.perf_counter() - t0))
            losses[task].append(float(m["loss"]))
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    flash = ops.launches_by_route(counts, "flash_attention")
    bwd = ops.launches_by_route(counts, "flash_attention_bwd")

    # one profiled det step
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batches["det"])
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    prof_sum = profile_summary(torch, prof, 1, prof_s, k=8)
    bwd_prof = kernel_device_ms(torch, prof, BWD_KERNELS)
    prof_sum["bwd_device_ms"] = {n: c * ms for n, (c, ms) in bwd_prof.items()}
    losses["det"].append(float(m["loss"]))

    # the backward kernel on the path's own inputs: an extra det step, after
    # the counts and the timings, keeps its last backward call's (layer 0)
    held = {}
    real_bwd = FA.flash_attention_bwd_cuda

    def keep_last(*args, **kw):
        held["args"] = tuple(a.clone() for a in args)
        held["kw"] = dict(kw)           # lse: the forward's own buffer
        return real_bwd(*args, **kw)

    FA.flash_attention_bwd_cuda = keep_last
    try:
        params, opt_state, _ = step(params, opt_state, batches["det"])
    finally:
        FA.flash_attention_bwd_cuda = real_bwd
    errors = []
    q, k, v, o, do = held["args"]
    got = [t.transpose(1, 2) for t in real_bwd(q, k, v, o, do,
                                               **held["kw"])]
    kw = {n: x for n, x in held["kw"].items() if n != "lse"}
    err, share = check_bwd_wgmma(
        "flash_attention_bwd", got,
        *(t.transpose(1, 2) for t in (q, k, v, o, do)), kw,
        f"phase 17 det step layer 0 B{q.shape[0]} H{q.shape[1]} "
        f"S{q.shape[2]}", errors)

    # one profiled vqa step last (S 1025): where its step time goes
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt_state, _ = step(params, opt_state, batches["vqa"])
        torch.cuda.synchronize()
        vqa_s = time.perf_counter() - t0
    vqa_sum = profile_summary(torch, prof, 1, vqa_s, k=4)

    n_params = sum(t.numel() for t in tree_leaves(params))
    steps = {}
    for task in TRAIN_TASKS:
        s = batches[task]["targets"].shape[1]
        model, executed = train_step_flops(cfg, TRAIN_B, s)
        mean = sum(ms[task][1:]) / len(ms[task][1:])
        # bytes: the weights read in the forward, the recompute and the
        # backward, the gradients written, and the AdamW pass over params,
        # grads and the f32 moments (read and written)
        n_bytes = n_params * (3 * 2 + 2 + (2 + 2 + 8) + (2 + 8))
        b_ms, b_by = bound_ms(n_bytes, model, "bfloat16")
        steps[task] = {"seq": s, "tokens": TRAIN_B * s,
                       "step_ms": ms[task], "step_ms_mean_after_first": mean,
                       "tokens_per_s": TRAIN_B * s / (mean / 1e3),
                       "model_flops": model, "executed_flops": executed,
                       "bound_ms": b_ms, "bound_by": b_by,
                       "model_tflops_per_s": model / (mean / 1e3) / 1e12,
                       "losses": losses[task]}
    checks = {
        "losses finite": all(math.isfinite(x) for v in losses.values()
                             for x in v),
        "det loss falls": all(b < a for a, b in zip(
            losses["det"][:TRAIN_ROUNDS], losses["det"][1:TRAIN_ROUNDS])),
        "flash_attention_bwd 28 a step":
            counts["flash_attention_bwd"] == cfg.num_layers * n_steps,
        "backward on the tensor cores alone":
            bwd == {"wgmma": cfg.num_layers * n_steps, "cuda_cores": 0},
        "wgmma forward 56 a step":
            flash["wgmma"] == 2 * cfg.num_layers * n_steps,
        "no CUDA-core flash": flash["cuda_cores"] == 0,
        "backward kernel on the path's inputs": not errors}
    res = {"model": cfg.name, "params": n_params, "batch": TRAIN_B,
           "steps": steps, "launches": counts, "peak_bytes": peak,
           "profiled_det_step": {"host_ms": 1e3 * prof_s, **prof_sum},
           "profiled_vqa_step": {"host_ms": 1e3 * vqa_s, **vqa_sum},
           "layer0_bwd_max_abs_err": err, "layer0_bwd_tolerance_share": share,
           "card": smi, "seconds": time.perf_counter() - t_phase}
    for task, st in steps.items():
        log(f"  phase 17 (a) {task} S {st['seq']}: step "
            f"{st['step_ms_mean_after_first']:.1f} ms (steps "
            f"{', '.join(f'{x:.1f}' for x in st['step_ms'])}), "
            f"{st['tokens_per_s']:.0f} tokens/s, "
            f"{st['model_flops'] / 1e12:.1f} TFLOP a step ({st['model_tflops_per_s']:.1f} TFLOP/s; bound "
            f"{st['bound_ms']:.1f} ms, {st['bound_by']}), losses "
            f"{[round(x, 4) for x in st['losses']]} [{smi}]")
    log(f"  phase 17 (a) profiled det step: host {1e3 * prof_s:.1f} ms, "
        f"device {prof_sum['device_ms_per_step']:.1f} ms, busy "
        f"{prof_sum['device_busy_share']:.3f}; peak "
        f"{peak / 1e9:.2f} GB; backward kernels' device ms "
        f"{prof_sum['bwd_device_ms']}; launches bwd {bwd}, flash {flash} "
        f"over {n_steps} steps [{smi}]")
    log(f"  phase 17 (a) top device ops: {prof_sum['top_device_ops']}")
    log(f"  phase 17 (a) profiled vqa step (last): host {1e3 * vqa_s:.1f} "
        f"ms, device {vqa_sum['device_ms_per_step']:.1f} ms, busy "
        f"{vqa_sum['device_busy_share']:.3f} [{smi}]")
    log(f"  phase 17 (a) checks: {checks}")
    del params, opt_state, batches, held
    gc.collect()
    torch.cuda.empty_cache()
    return res, checks, counts, {"phase 17 det layer 0": {
        "max_abs_err": err, "tolerance_share": share}}


def nudged_init(init_tier):
    """``init_tier`` with every float weight moved one ulp up: a difference
    of the size of one rounding, for the witness run."""
    import torch
    from repro_torch.tree import tree_map

    def init(*args, **kw):
        return tree_map(lambda t: torch.nextafter(
            t, torch.full_like(t, math.inf)) if t.is_floating_point()
            else t, init_tier(*args, **kw))
    return init


def loss_gaps(a, b):
    """Relative gaps of loss history ``a`` from ``b``: first, last, most."""
    rel = [abs(x - y) / abs(y) for x, y in zip(a, b)]
    return {"first": rel[0], "last": rel[-1], "max_rel": max(rel)}


def train_proxies(torch):
    """(b) ``build_system`` at ``TRAIN_PROXY`` on the card, then on the CPU
    (the draws come from CPU generators in both, so they are the same):
    first-step losses within ``TOL_PROXY_FIRST``, the last losses within
    ``TOL_PROXY_FINAL`` relative, each history's largest gap within
    ``WITNESS_FACTOR`` times that of a witness (a CPU run from weights one
    ulp up, against the CPU run), and the card bundle's
    ``spaceverse().evaluate`` on the card.  The card run's launches are the
    path ``train_proxies_card``."""
    import numpy as np
    from repro_torch.core import pipeline as P
    from repro_torch.kernels import ops
    from repro_torch.tree import tree_leaves
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    card = P.build_system(**TRAIN_PROXY, device="cuda")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = P.build_system(**TRAIN_PROXY, device="cpu")
    cpu_s = time.perf_counter() - t0
    real_init = P.init_tier
    P.init_tier = nudged_init(real_init)
    try:
        witness = P.build_system(**TRAIN_PROXY, device="cpu")
    finally:
        P.init_tier = real_init
    rel, wit = {}, {}
    for k in ("sat_losses", "gs_losses", "conf_losses"):
        a, b = card.history[k], cpu.history[k]
        rel[k] = {**loss_gaps(a, b), "card_first_last": [a[0], a[-1]],
                  "cpu_first_last": [b[0], b[-1]]}
        wit[k] = loss_gaps(witness.history[k], b)
    evals = {}
    for task in TRAIN_PROXY["tasks"]:
        out = card.spaceverse().evaluate(task, card.datasets[task], 16)
        ref_out = cpu.spaceverse().evaluate(task, cpu.datasets[task], 16)
        evals[task] = {"card_performance": float(out["performance"]),
                       "cpu_performance": float(ref_out["performance"]),
                       "card_offload_rate": float(out["offload_rate"]),
                       "cpu_offload_rate": float(ref_out["offload_rate"]),
                       "finite": bool(np.isfinite(np.asarray(
                           out["per_sample_simi"])).all())}
    checks = {
        "first-step losses within 1e-4": all(
            r["first"] <= TOL_PROXY_FIRST for r in rel.values()),
        "last losses within the bound": all(
            r["last"] <= TOL_PROXY_FINAL[k] for k, r in rel.items()),
        "largest gaps within the witness's x 4": all(
            r["max_rel"] <= WITNESS_FACTOR * wit[k]["max_rel"]
            for k, r in rel.items()),
        "losses finite": all(np.isfinite(card.history[k]).all()
                             for k in card.history),
        "weights on the card": all(t.device.type == "cuda"
                                   for t in tree_leaves(card.sat.params)),
        "evaluate on the card finite": all(e["finite"]
                                            for e in evals.values()),
        "backward kernel launched on the CUDA cores alone":
            counts["flash_attention_bwd"] > 0
            and ops.launches_by_route(counts, "flash_attention_bwd")[
                "wgmma"] == 0}
    res = {"relative_loss_gaps": rel, "witness_gaps": wit, "evaluate": evals,
           "card_seconds": card_s, "cpu_seconds": cpu_s, "launches": counts}
    gaps = {k: {n: r[n] for n in ("first", "last", "max_rel")}
            for k, r in rel.items()}
    log(f"  phase 17 (b) build_system card {card_s:.1f} s, CPU {cpu_s:.1f} "
        f"s; loss gaps card vs CPU (relative) {gaps}")
    log(f"  phase 17 (b) witness (CPU from weights one ulp up) vs CPU: {wit}")
    log(f"  phase 17 (b) evaluate: {evals}")
    log(f"  phase 17 (b) checks: {checks}")
    return res, checks, counts


def train_phase(torch, smi):
    """Phase 17: (a) ``train_full_width``, (b) ``train_proxies``.  Line
    ``train_phase {...}``; raises if a check fails."""
    t0 = time.perf_counter()
    res_a, checks_a, counts_a, held = train_full_width(torch, smi)
    res_b, checks_b, counts_b = train_proxies(torch)
    res = {"full_width": res_a, "proxies": res_b,
           "seconds": time.perf_counter() - t0}
    log("train_phase " + json.dumps(res, default=str))
    bad = [k for k, v in {**checks_a, **checks_b}.items() if not v]
    if bad:
        raise RuntimeError(f"phase 17 failed: {bad}")
    return {"launches": {"train_full_width": counts_a,
                         "train_proxies_card": counts_b},
            "held": {"flash_attention_bwd_wgmma": held}}


def main() -> int:
    import torch
    t_start = time.perf_counter()

    def phase(title):
        log(f"{title} [{time.perf_counter() - t_start:.0f} s]")

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; the port's smoke run needs the card")
        return 1
    import numpy as np  # noqa: F401  (the port's data path needs numpy)
    from repro_torch.kernels import build, ops

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("phase 1: build")
    t0 = time.perf_counter()
    rep = build.build_all(SOURCES)
    for src, r in rep.items():
        info = [ln.strip() for ln in r["log"].splitlines()
                if "registers" in ln or "spill" in ln
                or "entry function" in ln]
        log(f"  {src}: {r['path']} ({r['seconds']:.1f} s)")
        for ln in info:
            log(f"    {ln}")
    log(f"  built in {time.perf_counter() - t0:.1f} s")

    phase("phase 2: kernels vs plain")
    kernels = kernel_checks(torch)

    phase("phase 3: small proxy pair, card vs CPU")
    ops.reset_launch_counts()
    small_reference(torch)
    torch.cuda.synchronize()
    small_counts = ops.launch_counts()
    log(f"  launches on the small proxies (f32): {small_counts}")
    small_flash = ops.launches_by_route(small_counts, "flash_attention")
    if not (small_flash["cuda_cores"] > 0 and small_flash["wgmma"] == 0):
        raise RuntimeError("small proxies: flash must run on the CUDA-core "
                           "route alone (float32, hd 12/16)")
    ok, small_decode = decode_routes(small_counts, "cuda_cores")
    if not ok:
        raise RuntimeError(f"small proxies: decode must run on the CUDA-core "
                           f"route alone (float32, hd 12/16): {small_decode}")
    small_prefill = ops.launches_by_route(small_counts,
                                          "paged_prefill_attention")
    if not (small_prefill["cuda_cores"] > 0 and small_prefill["mma"] == 0):
        raise RuntimeError(f"small proxies: prefix-append must run on the "
                           f"CUDA-core route alone (float32, hd 12/16): "
                           f"{small_prefill}")
    small_ssm = ops.launches_by_route(small_counts, "ssm_scan")
    if not (small_ssm["cuda_cores"] > 0 and small_ssm["mma"] == 0):
        raise RuntimeError(f"small proxies: the chunked scan must run on the "
                           f"CUDA-core route alone (float32): {small_ssm}")

    phase("phase 4: main path at full width")
    sat, gs, conf, ac, counts, held, served = main_path(torch)
    for name, cases in held.items():
        kernels[name].update(cases)

    phase("phase 5: where the time goes")
    breakdown(torch, sat, gs, ac)

    phase("phase 6: slot path at full width (InferenceEngine.serve, 2B)")
    slot = slot_phase(torch, sat, ac)

    phase("phase 7: speculative verify at full width (7B, drafted by 2B)")
    spec = spec_phase(torch, sat, gs, ac)

    phase("phase 8: chunked prefill at full width (InferenceEngine.serve, 2B)")
    chunked = chunked_phase(torch, sat, ac, slot)

    phase("phase 10: batch evaluator, baselines and speculative server at "
          "full width")
    batch = batch_phase(torch, sat, gs, conf, ac, served)
    for name, cases in batch.pop("held").items():
        kernels[name].update(cases)

    phase("phase 11: the slot path on int8 and fp8 pools at full width")
    quant = quant_phase(torch, sat, gs, ac, slot, spec, chunked)

    phase("phase 12: overload control at full width (2B slot path)")
    overload = overload_phase(torch, sat, ac, slot)

    phase("phase 13: sharded serving at full width (2B: dp 2 x tp 1 in this "
          "process, dp 1 x tp 2 in two rank processes)")
    sharded = sharded_phase(torch, sat, ac, slot)
    for name, cases in sharded.pop("held").items():
        kernels[name].update(cases)

    phase("phase 14: captured steps against eager steps at full width (2B "
          "and 7B slot paths)")
    graphs = graphs_phase(torch, sat, gs, ac, smi)
    del sat, gs, conf
    torch.cuda.empty_cache()

    phase("phase 9: xlstm-125m serve step at full width (prefill + decode)")
    xlstm = xlstm_phase(torch)
    torch.cuda.empty_cache()

    phase("phase 15: xlstm-125m (vision) on the slot path at full width, "
          "eager and captured")
    xlstm_serve = xlstm_serve_phase(torch, smi)
    for name, cases in xlstm_serve.pop("held").items():
        kernels[name].update(cases)

    phase("phase 16: the dense attention configs (gemma3-1b, codeqwen1.5-7b, "
        "glm4-9b, gemma2-27b) on the slot path at full width, eager and "
          "captured")
    dense = dense_serve_phase(torch, smi)
    for name, cases in dense.pop("held").items():
        kernels[name].update(cases)
    torch.cuda.empty_cache()

    phase("phase 17: training (qwen2-vl-2b at full width: make_train_step "
          "with the flash backward kernel; the proxies' build_system, card "
          "vs CPU)")
    train = train_phase(torch, smi)
    for name, cases in train.pop("held").items():
        kernels[name].update(cases)

    # each path drove the kernels with the counts zeroed just before it
    by_path = {"small_proxies_f32": small_counts,
               "cascade_server": counts, "slot_serve": slot["launches"],
               "spec_greedy": spec["greedy_launches"],
               "spec": spec["launches"],
               "spec_gamma_9": spec["gamma_9"]["launches"],
               "chunked_serve": chunked["launches"],
               "batch_evaluator": batch["launches"],
               "cascade_server_spec": batch["spec_launches"],
               **quant["launches"], **overload["launches"],
               **sharded["launches"], **graphs["launches"],
               **{f"xlstm {tag}": c for tag, c in xlstm["launches"].items()},
               **xlstm_serve["launches"], **dense["launches"],
               **train["launches"]}
    for tag, r in xlstm.items():
        for name, cases in r.get("kernel_vs_plain_max_abs_err", {}).items():
            kernels[name].update({c: {"max_abs_err": e}
                                  for c, e in cases.items()})
    # the line's "flash_attention", "decode_attention",
    # "paged_decode_attention" and "paged_prefill_attention" are the
    # CUDA-core kernels alone, "slstm_scan" the per-row one; each row of a
    # two-route kernel carries the launches by route
    two_route = ops.ROUTES
    routes = {p: {n: ops.launches_by_route(c, n) for n in two_route}
              for p, c in by_path.items()}
    by_path = {p: dict(c, **{n: routes[p][n][first]
                             for n, (_, _, first) in two_route.items()})
               for p, c in by_path.items()}
    by_route = {n: {r: sum(rt[n][r] for rt in routes.values())
                    for r in (second, first)}
                for n, (_, second, first) in two_route.items()}
    base_of = {key: n for n, (key, _, _) in two_route.items()}
    base_of.update({n: n for n in two_route})
    # each row's headline shape stays where earlier slices put it (the
    # hd-256 shapes, "g3 ...", are in its by_shape)
    headline = {"flash_attention_wgmma": "7B", "flash_attention": "7B",
                "decode_attention_mma": "7B", "decode_attention": "7B",
                "region_score": "main",
                "paged_decode_attention_mma": "a 2B q1",
                "paged_decode_attention": "a 2B q1",
                "paged_prefill_attention_mma": "d 2B flat",
                "paged_prefill_attention": "d 2B flat",
                **{f"{n}[{kind}]": tag for kind in QUANT_POOLS
                   for n, tag in (("paged_decode_attention_mma", "a 2B q1"),
                                  ("paged_decode_attention", "a 2B q1"),
                                  ("paged_prefill_attention_mma",
                                   "d 2B flat"),
                                  ("paged_prefill_attention",
                                   "d 2B flat"))},
                "flash_attention_bwd_wgmma": "det",
                "flash_attention_bwd": "det",
                "ssm_scan_mma": "f xLSTM", "ssm_scan": "f xLSTM",
                "slstm_scan_cluster": "g xLSTM",
                "slstm_scan": "g xLSTM"}
    line = []
    for name, tag in headline.items():
        shapes = kernels[name]
        m = shapes[tag]
        base = name.split("[")[0]
        line.append({
            "name": name, "route": "cuda", "source": SOURCE_OF[base],
            "replaces": REPLACES[base],
            "launches": sum(c[name] for c in by_path.values()),
            "launches_by_path": {p: c[name] for p, c in by_path.items()},
            "max_abs_err": max(s["max_abs_err"] for s in shapes.values()),
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"], "shape": m["shape"],
            "by_shape": shapes,
            **({"launches_by_route": by_route[base_of[name]]}
               if name in base_of else {})})
    log(smi)
    log(json.dumps({"kernels": line}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
