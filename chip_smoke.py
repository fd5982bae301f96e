#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's GNN serve paths (GraphSAGE under two
routings, GAT, GatedGCN and MeshGraphNet, keysort and reservoir
selection, graph updates through the captured step), its engine
service, its sampled GNN training, its gemma2-9b prefill, its LM
serving (gemma2-9b, granite-moe-1b-a400m and codeqwen1.5-7b at full
width, qwen1.5-32b and grok-1-314b with their depth cut), its LM
training (gemma2-9b, codeqwen1.5-7b, qwen1.5-32b and grok-1-314b
depth-cut, granite-moe-1b-a400m at full width), its dlrm-rm2 recommender
(trained, served and retrieving at full width) and its multi-device
engine (rank by rank, and on NCCL at world 1) on one H100.

  python3 chip_smoke.py

Phases, in order; any failure exits non-zero and nothing is wrapped in a
``try`` that carries on:

1. device  — the card's name and power limit (nvidia-smi) and the torch
   device name; no card → exit 2 before any result.
2. build   — nvcc compiles every ``src/repro_torch/csrc/*.cu`` for sm_90a,
   one process per source, all in parallel (ptxas usage is printed); each
   head width's bf16 flash forward, dq and dk/dv kernel must show one
   tile's MMAs as HMMA instructions in its SASS and no local-memory
   traffic (no spills).
3. kernels — each of the nine kernels of the GNN paths (the tenth, the
   span sum, in phase 5) and the reference design's digit-pass pair
   (and the keys-only, shuffled and
   D = 1 variants) against its plain-torch twin on the card at the serve
   paths' shapes (the card's digit pass, ``digit_hist`` and
   ``digit_scatter``, at a request's 2^19 pairs and its widest digit, 7
   bits), with its time (CUDA events after a warm-up, the timed
   launches queued behind a device sleep so that the device, not the
   host's launch cost, is timed), the twin's time, one PyTorch library
   call's time as a yardstick, and its bound. Integer kernels must match
   element for element; the segment sum (on a synthetic stream at D 602,
   70 and 1, and through a gather index with the mean) must be within
   its derived tolerance of the twin (``segment_agg.twin_tolerance``),
   give the same bits on two launches and the pointer segment sum's bits
   on the same spans (one span-sum body). The
   rank epilogue on adversarial streams (long duplicate runs, a SENTINEL
   tail, an unaligned view; sorted, almost sorted and shuffled queries).
   The chunk sort also at the MERGE_CFG convert's 2^27 pairs and keys
   (the twin in slices of 2^24), with ptxas registers and spills of its
   instantiations. The merge kernels (``csrc/merge.cu``: the fused
   merge's rungs 4096 → 65,536 and one rung above, 65,536 → 131,072, each
   as merge-path passes) at a request's 2^19 and the convert's 2^27,
   pairs and keys (the twin on one 2^24 slice at 2^27), beside a per-block
   stable ``torch.sort`` + gather.
4. slice path — launch counters set to 0; the Reddit-scale ``convert``
   (232,965 nodes, 114,615,892 synthetic power-law edges in a 2^27 COO)
   under ``SLICE_CFG``, then ``GnnServeEngine`` serving 16 requests of
   1..1024 seeds at full graphsage-reddit width (602 features, 2 × 128
   hidden, fanouts 25-10, 41 classes, 4 slots); counters read: the
   convert's two sorts ran 3 ``digit_hist`` and 3 ``digit_scatter``
   launches each (digits of 7, 7 and 6 bits), and the path no
   ``digit_partition_hist`` or ``digit_rank_gather``. The engine runs
   every step as one step over all 4 slots, a ``slot_fn`` lane each: the
   warm-up request's step eagerly (host syncs made errors), then captured
   once as a CUDA graph that every later step replays. The counted run
   is traced (``torch.profiler``); the same 16 requests once more,
   untraced, give the timings and the peak memory. Checked: one step
   program after the warm-up and after the 16 requests; one eager
   ``slot_fn``'s counted launches are the hand-written kernels its trace
   shows (9 + 9 digit-pass launches and 2 ``ptr_seg_sum``, the span
   sum with GraphSAGE's gather and mean folded in); a capture counted 4
   lanes of them; the counted run counted that for every step, and its
   trace shows every step's 4 lanes of the eager lane's kernels, so the
   replays' counted launches happened.
5. slice checks — convert bit-identical to the torch.sort strategy on the
   same COO; every request bit-identical to a sequential per-request
   slot_fn loop; the convert-scale pointer rank (232,966 queries over
   2^27) against its twin; the digit pass (``digit_phase``): the card's
   pair against its twins bit for bit at 2^19 and 2^24, pairs and keys,
   4- and 7-bit digits, timed at 2^19 and 2^27 beside its bounds, the
   reference design's pair (against its twins at 2^24) and its whole
   pass (against a stable ``torch.sort`` by the digit at 2^24), and
   ``torch.sort``; at 2^27 one key everywhere, the card tile
   swept (2048 to 16384) and the whole 18-bit sort on the own schedule and on 4-bit
   passes against ``torch.sort(stable=True)`` + a gather; a small graph
   served on the card equal to the CPU path; four requests' subgraphs and logits with the rank-epilogue
   kernels equal, bit for bit, to those with the twins in their place.
   The rank epilogue at the main path's five calls, on copies of the
   arrays the path hands it (one convert: its pointer build over 2^27;
   the largest request: its first-occurrence rank, prefix-sum rank, edge
   rename and subgraph pointer build), each equal to its twin and timed
   in turns (twin, kernel, kernel, ``torch.searchsorted``). The span sum
   (``csrc/ptr_scan.cu``) on copies of the two calls of the largest
   request's forward (per layer the node states read through the edge
   sources, the mean), on a request's layer-1 shape with every row in a
   segment, on a ragged E and D, and on one span of 2^17 rows at D 1 and
   602: within ``twin_tolerance`` (derived from float32 rounding) of the
   twin, the same bits twice, timed beside its bound for the data, the
   twin and ``torch.segment_reduce(msgs, "sum", offsets=ptr)`` (the one
   library call of the sum; on the gathered stream for the path's calls),
   with each version's distance from a float64 prefix; the path's layer 1
   also as the unfused composition it replaced (the gather, the span sum,
   the division). Then
   the largest request once more (eager ``slot_fn``) under
   ``torch.profiler``: its wall time, its kernels' device time, the ops
   that take the most of it, the rank and span-sum kernels' time by name
   and the copy kernels' (less than one [524288, 602] copy could take: no
   transposing copy); one replayed step with the 4 largest requests
   seated (its rows equal to what they were served): wall and device
   span (CUDA events), and under ``torch.profiler`` (its hand-written
   kernels 4 lanes of the eager lane's, its counted launches the
   capture's); and
   one more ``SLICE_CFG`` convert under ``torch.profiler``: the
   hand-written kernels by name (6 ``digit_scatter_kernel`` launches, no
   ``rank_gather_kernel``) and the rest.
6. merge path — launch counters set to 0; ``convert`` under ``MERGE_CFG``
   (chunked_merge sorts, unfused set-count pointer build) of Reddit's
   114,615,892 synthetic power-law edges in a 2^27 COO, as the slice path
   converts them, then the same 16 requests served under ``MERGE_CFG``
   with ``use_pallas_agg`` on the slice path's CSC through its captured
   step; counters read: every rung of the convert's two sorts above the
   fused merge's 65,536 went through one ``merge_rung`` launch (2 × 11);
   the step checks of phase 4 (a lane aggregates on 2
   ``segment_sum_sorted`` launches, the gather and the mean folded in,
   no span sum).
7. merge checks — that convert bit-identical to the torch.sort strategy;
   ``set_count_less`` at the convert's shape (232,966 targets over the
   2^27 sorted dst, then shuffled) equal to ``torch.searchsorted`` and to
   its twin on every 256th target (the twin is all-pairs: 3e13 compares
   for all of them); batched == sequential; four requests' subgraphs
   equal to the slice path's and their logits bit-equal to the slice
   path's forward (the segment sum and the span sum share one body); the
   segment sum on copies of the largest request's two calls
   (``merge_sum_phase``: layer 1 at D 602 and layer 2 at D 128, each
   through the edge sources with the mean) held as in phase 3 and timed
   beside its bound, twin and ``index_add_``; a small graph under
   ``MERGE_CFG`` on the card equal to the CPU path; the profile of one
   request and of one replayed step; one more MERGE_CFG convert under
   ``torch.profiler``: the
   hand-written kernels by name, the rest, the device spans of the merge
   rungs above the fused merge's block, and no ``searchsorted`` or
   ``scatter`` op (the plain ladder's) in the trace.
7a. service — the serve engines freed (no CUDA graph is captured while a
   prefetch producer runs); launch counters set to 0; the engine service
   (``repro_torch.engine``) on the library with the kernels routed
   (``use_pallas`` on every entry of ``bitstream_library()``): the bare
   chunk-sort wrapper refuses 65,536 pairs a chunk, and every entry
   converts 2^20 pairs (two-pass, Reddit's VID space) under chunked_merge
   and global_radix equal to the torch.sort strategy (chunks wider than a
   CTA sort as sub-chunks and one merge rung). A ``Calibration`` fitted on
   the card: converts under each pinned strategy at 2^20, 2^24 and 2^27
   edges (the last the merge path's Reddit COO) for two entries of
   different w_upe, each bit-equal to torch.sort, and the reindex epilogue
   fused and unfused at 1,024 and 128 seeds; non-negative least squares on
   the cost model's own columns (constants the readings do not identify
   keep the reference's); each reading beside its prediction under the
   fitted and the default Calibration; ``choose_config`` under both beside
   the fastest measured. DynPre (one service a Calibration) over a 2^14-edge
   graph at degree 4, a 2^20-edge one at degree 32 and Reddit, 1,024 seeds
   each: every subgraph bit-equal to ``pipeline.preprocess`` under
   ``SLICE_CFG``; a fresh service re-dispatching the Reddit pair adds no
   dispatch entry and loads no library. ``sample_batched`` on the Reddit
   CSC, rows of 1..1,024 seeds bucketed to a power of two, each row equal
   to ``sample_subgraph``. ``apply_delta`` on the Reddit CSC (4,096
   inserts, 4,096 deletes of existing edges, 1,024 of them twice) in merge
   and rebuild modes under the service's configuration and ``SLICE_CFG``,
   timed, each bit-equal to the torch.sort convert of the post-update edge
   list built with numpy on the host, then a chain of 3 such deltas. 16
   batches of a request's sampling and feature gather through a
   ``Prefetcher`` (side stream) into the full-width graphsage-reddit
   forward: logits bit-equal to ``SyncBatches``, both timed, the launch
   counters (bumped from two threads) equal. ``train/loop.py`` with and
   without prefetch, 3 steps of the gemma2-9b smoke config: bit-equal.
   Counters read: every kernel of the phase launched.
7b. families — on the slice path's Reddit CSC, at the reference's
   minibatch_lg fanout (15, 10), 1,024 seeds a request, 4 slots, each
   with launch counters set to 0 and read after: graphsage-reddit (at
   this fanout, Floyd's side of 7c's keysort), gat-cora (2 layers, 8
   heads x 8), gatedgcn (16 layers, d 70) and meshgraphnet (15 layers, d
   128, 2-layer MLPs, d_out 3, head to 41) at their published widths,
   602 features in, 41 classes out, served under ``SLICE_CFG``, and
   gatedgcn again under ``MERGE_CFG`` with ``use_pallas_agg`` (the
   segment-sum kernel on D = 70): the checks of phase 4 (one captured
   step program; the counters against a trace; a lane's 2 / 4 / 32 / 15
   span sums or 32 segment sums), batched == sequential, the largest
   request's logits finite; every span-sum or segment-sum call of
   that request (D = 8, 64 and 1 for GAT's softmax denominators and
   aggregations, 70, 128) against its twin within its derived tolerance,
   the first of each width timed beside its bound, twin and library
   call; the family's smoke config on a small graph card == CPU; one
   replayed step profiled.
7c. selections — graphsage-reddit served under ``SLICE_CFG`` with
   keysort selection (the checks of 7b) and 4 requests' subgraphs (ptr,
   idx, order) equal, bit for bit, to the same sampling run on the host
   from the card's CSC copied over; reservoir selection (a sequential
   step a neighbour slot, about 1,000 a layer: run eagerly through
   ``pipeline.sample_subgraph``, not captured) on 4 requests, counters
   set to 0 and read, each subgraph equal to the host's; one 1,024-seed
   sample under each selection timed.
7d. updates — a stream of 12 items on the Reddit CSC under
   ``SLICE_CFG`` (graphsage-reddit, fanout (15, 10)), every third an
   update of 4,096 inserts and 4,096 deletes of existing edges
   (``delta_cap`` 4,096), the rest queries, submitted at once to one
   engine whose step was captured before; counters set to 0 before the
   engine is built and read after the stream. Every prediction equals
   the eager ``slot_fn`` on the oracle's graph (``apply_delta_jit``
   chained where the updates sat); the final CSC equals the oracle's bit
   for bit; one step program; every bound tensor at its address. Each
   update's latency from submit to finish.
7e. GNN training — Reddit's synthetic graph (``launch/train.gnn_data``:
   232,965 nodes, 114,615,892 edges, 602 features, 41 classes) built once
   on the host and timed; a ``SampledDataset`` on the card (the service's
   pick from the kernel library printed, with its sort strategies) and
   one batch (sampling, reindexing, the subgraph convert and the
   transposed layout on the card's kernels); one graphsage-reddit step
   at full width (fanouts 25-10, batch 1024): counters read, the span sum
   2 launches forward and 1 backward and no other kernel; every
   parameter's gradient, and the gradient into layer 1's output
   (non-zero), against the float64 twins (``_ptr_seg_sum_plain`` and
   ``take`` / ``index_add_`` under autograd) within GNN_GRAD_TOL; the
   backward's span sum on the batch's own arrays against its twin within
   ``twin_tolerance``, timed beside its bound and ``index_add_``; one
   model step profiled: its kernels, and no index_add_ or scatter kernel
   or op; GNN_TRAIN_TIMED prefetched steps timed (seconds, seeds/s, peak
   memory), one step with its batch profiled; ``run_gnn`` for
   GNN_TRAIN_STEPS steps clean, crashed at GNN_TRAIN_FAIL_AT and resumed
   from its step-10 checkpoint: the same parameters and losses bit for
   bit, finite; the smoke config's loss falls over its 12 steps; gat-cora,
   gatedgcn and meshgraphnet at their published widths (fanouts 5-3)
   two steps each, twice: the same bits, finite losses, and one batch's
   gradients against the float64 twins.
8. LM kernels — the GNN paths' memory freed; the flash-attention forward
   (bf16 on tensor cores, float32 on scalar FMAs) against its twin at
   gemma2-9b's head shapes (16 heads over 8 kv heads,
   dh 256, bf16, 8192 tokens) as a global layer (causal, cap 50) and a
   local one (window 4096), queries scaled by FLASH_Q_SCALE so that the
   cap acts, within one bf16 ulp (FLASH_RTOL, FLASH_ATOL), a planted
   fault (no cap; window + 1) rejected, and FLASH_SWEEP more draws held
   to the same tolerance; in float32 at 2048 tokens within
   2e-5; ``prefix_partition`` and ``filter_tree_lookup``
   (no path runs them) equal to their twins at the reference tests'
   shapes, ``prefix_partition`` also at ragged blocks (96, 1000, 4100),
   and at their timed sizes (2^24 values in blocks of 1024;
   65,536 keys × 65,536 targets and a request's reindex, 282,624 keys ×
   563,200 targets, where the all-pairs twin runs once). Yardsticks the
   port never calls:
   ``scaled_dot_product_attention`` (causal, no cap: a near function), a
   per-block stable ``torch.sort`` + gather, ``torch.searchsorted`` (on
   presorted keys, and after a ``torch.sort`` of the keys).
9. LM path — launch counters set to 0; ``lm_prefill_cell`` builds
   gemma2-9b at full width (42 layers, d 3584, vocab 256,000, bf16,
   random weights from ``--seed``) and prefills one sequence of 8192
   tokens (the ``prefill_32k`` cell with its sequence cut from 32,768 and
   its batch from 32 to 1); counters read: 42 flash launches, no other
   kernel. A second prefill gives the same bits; the logits are finite;
   each of the 42 launches of a third is within one bf16 ulp of the twin
   on its own inputs; the same prefill with the flash twin in every layer
   agrees within PATH_TOL, and three planted faults of the twin (no cap,
   window + 1, the next kv head) are read; the smoke model on the card
   gives the CPU's logits. Then a
   profiled prefill (device busy share, top ops) and, when the run has
   room, one prefill at 32,768 tokens. The prefill model is freed.
9a. LM serve — gemma2-9b at full width (bf16 weights from ``--seed``, an
   int8 KV cache) in ``ServeEngine(n_slots=8, max_len=1024,
   prompt_cap=512)``: the ``decode_32k`` cell (32,768 positions, batch
   128) cut to 1,024 positions and 8 slots. A warm-up request (the step
   captured once as a CUDA graph), launch counters set to 0, 16 requests
   from the seed (prompts of 16..512 tokens, budgets of 8..64 new ones)
   served with one step in flight, counters read: 84 ``decode_attention``
   launches a step (the splits and their combine, 42 layers), no flash
   or other kernel; every request retires with its budget of tokens in
   [0, 256000); one step program, still one after more streams. The
   replayed step's wall and device time, one replay profiled (busy share,
   top ops), tok/s processed and generated, admission and request
   latency p50/p99, peak memory. The first 4 requests served alone give
   the stream's tokens bit for bit; the 2 shortest served together with
   each replay's logits read, and a batch-1 ``lm_decode_step`` loop
   teacher-forced on their tokens: logits within B1_LOGIT_TOL at every
   step, the argmax the engine's token wherever the top-2 margin clears
   it. One decode step on the engine's own cache: each layer's launch
   within ``twin_tolerance`` (derived from float32 rounding) of the twin
   on its own inputs; the step's logits within DECODE_PATH_TOL of the
   same step with the twin in every layer, the next-kv-head twin outside;
   on the first local and global layers' inputs (float32 q) the cap left
   out, the dequantization without its bf16 rounding (q x 8), one
   position more and the next kv head (q x 1) read outside the tolerance.
   Row 15 timed on the first global layer's inputs beside its bound (the
   live rows' int8 bytes and scales), the twin and
   ``scaled_dot_product_attention`` on the dequantized bf16 cache (no
   cap: a near function), with the split kernel's registers, static
   shared memory and spills and its SASS conversion and arithmetic
   counts. decode_32k's length: one step at position
   32,767, batch 8, a random int8 cache of 25 GiB from the seed, timed
   and profiled, its first global layer's kernel timed and held against
   the twin on 2 slots. The ring: gemma2-9b cut to one (local, global)
   pair serves one request of 4,200 prompt tokens and 16 new ones in a
   cache of 8,192 positions (the local ring of 4,096 wraps), then the
   decode-step checks above on its cache. The smoke model served on the
   card gives the CPU's tokens, bf16 and int8 caches.
9b. LM configs — for each of LM_CONFIG_RUNS, after the model before it
   is freed: granite-moe-1b-a400m (24 layers, d 1024, 16 heads over 8, dh
   64, 32 experts top-8, vocab 49,155, tied, bf16 cache) and
   codeqwen1.5-7b (32 layers, d 4096, MHA 32 heads, dh 128, qkv bias,
   vocab 92,416, bf16 cache) at full width and depth, qwen1.5-32b (MHA 40
   heads, qkv bias, int8 cache) cut to 16 layers and grok-1-314b (48
   heads over 8, 8 experts top-2, int8 cache) cut to 2, weights from the
   seed (the qkv biases too, N(0, 0.5^2)). Launch counters to 0, one
   prefill (8,192 tokens, 4,096 for the cut models; batch 1), counters
   read: a flash launch a layer, no other kernel; a second prefill
   bit-equal, finite logits; a third with each flash launch within one
   bf16 ulp of the twin on its own inputs (each launch's share of the
   tolerance printed); row 12 on the first layer's inputs beside its
   bound, the twin and SDPA (the same function: no cap, no window); under
   MoE a profiled prefill and the rank scan down the one-hot's leading
   axis against the port's along its transpose (equal integers, timed).
   Then the serve path of 9a
   (``ServeEngine`` of 8 slots, 1,024 positions, 16 requests, counters to
   0 and read: 2 decode launches a layer a step, one step program), its
   replayed step timed and profiled; for the dense configs 2 requests
   alone equal the stream's tokens (MoE capacity couples a step's slots,
   in the reference too); the decode checks of 9a on the engine's cache
   (each launch within ``twin_tolerance``; the step's logits with the
   kernel against the twin's, the next kv head outside; the planted
   faults the config has); row 15 on the first layer's inputs; for
   granite and codeqwen decode_32k's length, one step at position 32,767
   with its batch cut to 8 and 2, a random bf16 cache from the seed.
10. LM backward kernels — flash_dq_kernel and flash_dkv_kernel against
   the twin ``flash_attention_bwd_plain`` on the forward kernel's own out
   and lse, at gemma2-9b's head shapes in bf16 with queries x
   FLASH_Q_SCALE: a global layer at 4096 and 8192 tokens and a local one
   (window 4096) at 8192, within BWD_RTOL / BWD_ATOL, two launches
   bit-equal, and four planted faults (no (1 - t²) factor, window + 1,
   the next kv head's dk / dv, a group sum missing a head) read outside
   the tolerance; float32 at 2048 tokens within BWD_F32_TOL, and the
   forward's lse against the twin's. Timed at 4096 tokens against their
   bounds, the twin and the backward of ``scaled_dot_product_attention``
   (a yardstick the port never calls).
10a. delta — at gemma2-9b's heads and 4096 tokens (bf16, queries x
   FLASH_Q_SCALE): the forward's bf16 out with lse and the float32 out
   equal, bit for bit, to a launch without them; the backward from the
   float32 out within BWD_RTOL / BWD_ATOL of the twin run in float32 with
   its own float32 out (the reference's semantics); from the bf16 out (a
   planted fault) outside.
10b. ragged lengths — every flash kernel (forward with lse, dq, dk/dv;
   float32 and bf16) at gemma2-9b's head shapes and lengths that are no
   multiple of any tile (Sq = Skv of 1, 100, 500 and 4000, also with a
   window of 1024; 100 queries at q_offset 128 over 228 keys, with and
   without a window of 48) against the twins at the tolerances above.
11. train path — launch counters set to 0; ``lm_train_cell`` builds
   gemma2-9b at full width cut to 16 layers (the ``train_4k`` cell with
   batch 256 cut to one sequence of 4096 tokens; bf16 weights from
   ``--seed``, AdamW with float32 moments) and runs three steps; counters
   read: 32 forward, 16 dq and 16 dk/dv launches a step, no other
   kernel; finite losses, the first near ln(256000); the peak memory
   (the flash residual is the float32 out). One more step under
   ``torch.profiler``.
12. train checks — on the cell's own tokens, each of the 16 backward
   launches against the twin; the step's gradients against the same step
   with the twin backward in every layer within TRAIN_GRAD_TOL (relative
   L2 per parameter), two planted faults read outside it; the smoke
   model's step on the card against the CPU; ``launch/train.run_lm`` on
   the card, crashed at a step and resumed from its checkpoint, against
   an uninterrupted run.
12b. LM train configs — for each of LM_TRAIN_RUNS: the ``train_4k``
   cell at full width (granite-moe-1b-a400m at full depth with the
   largest batch of LM_TRAIN_BATCHES whose reckoned peak,
   ``reckoned_train_gib``, stays under LM_TRAIN_PEAK_GIB; codeqwen1.5-7b
   cut to 16 layers, qwen1.5-32b to 4, one sequence), counters to 0,
   LM_TRAIN_STEPS AdamW steps with each of the first step's backward
   launches against the twin, counters read (2 forward, 1 dq, 1 dk/dv a
   layer, no other kernel); finite losses, the first near ln(vocab); the
   peak. granite also: the step's gradients against the twin backward's
   (two planted faults outside), two steps from one saved state
   bit-equal, a profiled step, ``run_lm`` on its smoke config crashed
   and resumed bit-equal. Then rows 12, 13a, 13b at each config's head
   shapes and 4,096 tokens.
12c. recsys — dlrm-rm2 at full width (26 float32 tables of 1,000,000 x
   64 drawn on the card; AdamW, float32 moments): the train_batch cell's
   lookup layout (``models/dlrm.py`` ``lookup_layout``, SLICE_CFG) equal
   to a stable ``torch.sort`` bit for bit; counters to 0, RECSYS_STEPS
   steps (4 digit_hist, 4 digit_scatter, 1 rank_search, 1 span sum a
   step and no other kernel), a profiled step; one step's table gradient
   within ``twin_tolerance`` of the plain route (``GatherRows`` with the
   twin's sum), the span sum, the digit pass and the rank search timed
   at this path's shapes, autograd through ``index_select`` timed beside
   it; serve_p99, serve_bulk and retrieval_cand timed, retrieval's top
   100 against a stable sort of the same scores; ``run_recsys`` with the
   tables cut to RECSYS_RESUME_VOCAB rows crashed and resumed bit-equal;
   the smoke model's step card vs CPU.
13. the multi-device engine — the collectives at world sizes above 1
   are held on the CPU only (gloo groups in the tests: one card cannot
   hold two NCCL ranks); here every stage runs rank by rank in one
   process, and the real entry points on NCCL at world 1.
   a. sharded convert: Reddit's 2^27 COO under SLICE_CFG and MERGE_CFG
      at worlds 2 and 4 (``engine/shard.py`` ``shard_convert_ranks``:
      each rank's sorted run and pointer block, the cross-rank merge
      rounds), counters to 0 first; each stage timed, the launches read;
      bit-equal to single-device ``convert``; a 1,024-seed (25, 10)
      sample on it equal to the sample on ``convert``'s CSC.
   b. the decode kernel's partial mode at gemma2-9b's decode_32k shapes
      (8 slots, 16 query heads over 8 KV heads, dh 256, 32,768 int8
      positions, cap 50; one slot's cache short enough that whole slices
      are dead), counters to 0, the sequence cut into 2 and 4 slices
      (``dist/collectives.py`` ``sharded_decode_attention_seq_ranks``),
      counters read: each slice's partial against its twin on
      MESH_DECODE_CHECKED's slots (the live normalised output within
      ``twin_tolerance``, m within the scores' bound, a dead slice (-inf,
      0, 0)), the combined output against the dense kernel within
      ``twin_tolerance`` on every slot; the head split (2 and 4 groups)
      bit-equal to the dense kernel; the partial mode's row.
   c. NCCL at world 1 (``launch/mesh.py`` ``make_local_mesh("cuda")``,
      made before 9a, whose gemma2-9b engine is served again with
      ``mesh=``: the same tokens, one captured step program; at world 1
      the engine holds no cache shard and issues no collective, so the
      shard path runs apart: one decode step of that model with the
      cache cut into 2 and 4 ranks' slices, the ranks in turn, each
      layer's owned-position inserts bit-equal to the whole-cache
      insert, its combined attention within ``twin_tolerance`` of the
      dense kernel, the logits within DECODE_PATH_TOL of the whole-cache
      step's):
      ``PreprocService(mesh)`` and ``launch/steps.py``
      ``preprocess_cells(mesh)`` at Reddit's size equal to the pipeline;
      ``compressed_psum_tree`` over a gradient tree of granite-moe's
      shapes bit-equal to quantize then dequantize, twice;
      ``moe_apply_local`` (``moe_apply`` on one rank) and
      ``moe_apply_groups`` at 8 x 4,096 granite tokens in 2 and 4 groups
      against ``moe_apply`` on each group.
   d. grok-1-314b trained on the card: ``train_4k``'s cell cut to
      LM_TRAIN_GROK (one layer, 1,024 tokens) through the sliced AdamW
      when its reckoned peak stays under LM_TRAIN_PEAK_GIB (else the
      reckoning is printed and it stays on the CPU): 12b's steps and
      checks, the peak against the reckoning, two steps from one saved
      state bit-equal.
14. the analysis (``src/repro_torch/analysis``, the baselines, the dry
   run):
   a. ``checker.check_all(grid="smoke", device="cuda")`` under both
      routings: every contract's census on the card, the launch
      counters' change equal to the launches the kernel scopes declared
      and, where a contract prices them, to the cost model's; under
      ``use_pallas`` every convert, shard and delta case launches.
   b. Reddit's 2^27 COO: ``convert_xla`` (the paper's GPU baseline: two
      stable ``torch.sort``s and ``searchsorted``) bit-equal to
      ``convert`` under SLICE_CFG and MERGE_CFG, the three timed
      (``cuda_ms``); one 1,024-seed (15, 10) ``preprocess_xla_baseline``
      request equal to ``preprocess`` under SLICE_CFG with keysort
      selection, timed beside it and beside SLICE_CFG's own request.
   c. one Reddit convert under each config in a census: its launches
      equal ``costmodel.convert_launch_count`` and PERF.md's launch
      columns (6 + 6 digit passes and a rank search; 2 chunk sorts, 2
      fused merges, 22 rungs and a set count), the counters equal.
      One ``convert_xla`` under ``torch.profiler``: its ops by device
      time.
   d. the dry run (``launch/dryrun.py``) over all 40 cells and the
      engine's 3 on meta on the described (16, 16) mesh, one line a cell.
15. report — every kernel of each path launched in its run; the kernels
   JSON line (all nineteen; digit_partition_hist, digit_rank_gather,
   prefix_partition and filter_tree_lookup with 0 launches), then the last line ``{"ok": true, "device": {...}}``.

Weights and data are random, made from ``--seed``. Details go to
``chiprun_out/chip_smoke.json``. Float32 matmuls run in full precision
(TF32 off).
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# Peak 32-bit rate outside the tensor cores (the data sheet's float32
# figure); the integer kernels here are far below it, bound by bytes.
ALU_OPS_PER_S = 67e12
SERVE_CAP = 524_288  # pow2 VID list / subgraph edge bucket of one request
SERVE_NODES = 282_624  # 1024 + 1024·25 + 1024·25·10 VIDs per request
SERVE_EDGES = 281_600  # 1024·25 + 1024·25·10 sampled edges
REDDIT = dict(nodes=232_965, edges=114_615_892, feats=602, classes=41)
TILE, RADIX_BITS = 4096, 4
CONVERT_CAP = 1 << 27  # pow2 COO capacity of the Reddit edge list
SEED_CAP, N_SLOTS = 1024, 4  # the batch Workload.b prices; engine slots
# the digit pass's pairs: the card's (digit_hist, digit_scatter) against
# their twins at DIGIT_CHECKED and timed at DIGIT_TIMED, at digit widths
# DIGIT_WIDTHS (the reference's 4; 7, the own schedule's widest), pairs and
# keys; the reference's one-to-one pair checked at 2^24, timed at both;
# the scatter's card tile timed at SCATTER_TILES (2^27, 7 bits, pairs)
DIGIT_CHECKED = (1 << 19, 1 << 24)
DIGIT_TIMED = (1 << 19, 1 << 27)
DIGIT_WIDTHS = (4, 7)
SCATTER_TILES = (2048, 4096, 8192, 16384)
# the chunk sort at the MERGE_CFG convert's shape, checked against the
# twin in slices of 2^24 elements (its one-hot partition: 64 bytes an
# element a pass)
CHUNK_SORT_BIG, CHUNK_SORT_TWIN_SLICE = 1 << 27, 1 << 24
MERGE_CONVERT_CAP = CONVERT_CAP  # the merge path converts Reddit too
CONVERT_TWIN_STRIDE = 256  # targets the all-pairs twin checks at 2^27
SLICE_KERNELS = ("digit_hist", "digit_scatter", "rank_search", "rename",
                 "ptr_seg_sum")
# segment sums of one MERGE_CFG GraphSAGE request: one a layer, the node
# states read through the edge sources, the mean folded in
MERGE_SUMS = 2
# digit-pass launches of one SLICE_CFG request: its three sorts (the
# reindex sort, the subgraph convert's two) on 3 passes each (7, 7 and
# 6 bits, ``global_radix_schedule``)
REQUEST_DIGIT_PASSES = 9
# one [524288, 602] float32 copy (a request's layer-1 messages, read and
# written once) cannot take less: 2.53 GB at 3.35 TB/s
COPY_BOUND_MS = 0.75
# a small graph's logits card vs CPU, as a share of their largest
# magnitude (at least 1): the span sum against its cumsum twin, cuBLAS
# against the CPU's GEMMs. On the CPU the pointer sum against index_add_
# (another order) moves the smoke families' logits by at most 6e-6 of it
# (GatedGCN; graphsage 1.2e-6 absolute), so 1e-4 holds 15x that
SMALL_LOGIT_TOL = 1e-4
MERGE_KERNELS = ("chunk_sort", "fused_merge", "merge_rung",
                 "set_count_less", "segment_sum_sorted")
LM_KERNELS = ("flash_attention_fwd",)
# no path runs these: the reference's digit pass one to one (the slice
# path's sorts run digit_hist and digit_scatter), and two kernels only the
# reference's tests call
OFF_PATH_KERNELS = ("digit_partition_hist", "digit_rank_gather",
                    "prefix_partition", "filter_tree_lookup")
BF16_FLOPS_PER_S = 989e12  # H100 SXM data sheet, dense bf16 tensor cores
LM_ARCH, LM_SEQ, LM_BATCH, LM_LONG_SEQ = "gemma2-9b", 8192, 1, 32768
# flash kernel against its twin in bf16: both work in float32 and round
# once to bf16, so they may differ by one bf16 ulp of the output (2^-7 of
# it at most) plus float32 sums that cancel near zero (1e-5). The queries
# are scaled by FLASH_Q_SCALE, so that the scores (about N(0, 8^2)) reach
# the range where gemma2's cap of 50 acts; float32 at 2048 tokens: 2e-5
FLASH_RTOL, FLASH_ATOL, FLASH_Q_SCALE = 2 ** -7, 1e-5, 8.0
FLASH_F32_TOL, FLASH_F32_SEQ = 2e-5, 2048
FLASH_SWEEP = 4  # more bf16 draws checked (global and local), untimed
# test_kernels.py's shapes, then ragged blocks (the kernel's tile is 1024)
PARTITION_SHAPES = ((128, 128), (512, 128), (2048, 512), (96 * 37, 96),
                    (1000 * 17, 1000), (4100 * 9, 4100))
PARTITION_TIMED = (1 << 24, 1024)
FILTER_SHAPES = ((2048, 256), (4096, 128))  # test_kernels.py
# (keys, targets) timed: the earlier size, and a request's reindex
# (282,624 VIDs, 563,200 edge endpoints); the all-pairs twin is timed in a
# loop up to FILTER_TWIN_TIMED compares and once beyond
FILTER_TIMED = ((65536, 65536), (282_624, 563_200))
FILTER_TWIN_TIMED = 1 << 33
# the full-width prefill with the kernel against the same prefill with the
# flash twin in every layer (bf16 activations round after every op, so
# one flipped ulp in one layer travels through the rest): about twice the
# 0.121 and 0.109 read on seeds 0 and 1, a thirtieth of the 7.5 and 7.9
# that the twin with every query head on the next kv head reads (NVIDIA
# H100 80GB HBM3, 700 W). A cap left off or a window one key too wide
# reads like the sound twin there (0.125, 0.117; 0.125, 0.114): the
# per-launch check is the one that sees those
PATH_TOL = 0.25
# the 32,768-token prefill (9.6 s on the card) runs if the script is not
# yet this far; the whole script must end within 1200 s
LONG_PREFILL_BY_S = 600
# the train path: the train_4k cell cut to 16 layers (8 local / global
# pairs) and one sequence of 4096 tokens (reference: 42 layers, batch
# 256), every width kept; three AdamW steps
TRAIN_KERNELS = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")
# the bf16 tensor-core kernels whose SASS the build phase reads: (library,
# kernel); each is instantiated per head width with its tile rows
MMA_KERNELS = (("flash_attention", "flash_fwd_mma_kernel"),
               ("flash_attention_bwd", "flash_dq_mma_kernel"),
               ("flash_attention_bwd", "flash_dkv_mma_kernel"))
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 16, 4096, 1, 3
# flash backward launches per step: the forward runs twice per layer (the
# step's forward and the remat recompute), dq and dk/dv once
TRAIN_LAUNCHES = {"flash_attention_fwd": 2 * TRAIN_LAYERS,
                  "flash_attention_bwd_dq": TRAIN_LAYERS,
                  "flash_attention_bwd_dkv": TRAIN_LAYERS}
# the backward kernels against their twin at gemma2's head shapes (bf16):
# a global layer at 4096 and 8192 tokens, a local one (window 4096, which
# masks a pair only past 4096 tokens) at 8192
BWD_CASES = ((4096, None), (8192, None), (8192, 4096))
# both sum in float32 in other orders and round once to bf16: one bf16 ulp
# (2^-7 of the value) plus 1e-3 of the tensor's largest value, where sums
# cancel. Read on the card: at most 0.73 of this tolerance (max error
# 0.125 on dk values up to 45), every planted fault 77 times it or more
# (NVIDIA H100 80GB HBM3, 700 W). float32 at 2048 tokens: 1e-5 of the
# largest value (read: 2.5e-6)
BWD_RTOL, BWD_ATOL = 2 ** -7, 1e-3
BWD_F32_TOL, BWD_F32_SEQ = 1e-5, 2048
# the step's gradients with the kernels against the same step with the
# twin backward in every layer, relative L2 per parameter (bf16: a flipped
# ulp in one layer's backward travels through the layers below): read
# 0.0127 at worst (layers.0.wq); the next-kv-head and missing-head faults
# read 1.53 and 0.84
TRAIN_GRAD_TOL = 0.05
# (Sq, Skv, q_offset, window) the flash kernels take at ragged lengths:
# squares that are no multiple of any tile (4000 also with a window), and
# a chunk of 100 queries at positions 128..227 over 228 keys
RAGGED_CASES = ((1, 1, 0, None), (100, 100, 0, None), (500, 500, 0, None),
                (4000, 4000, 0, None), (4000, 4000, 0, 1024),
                (100, 228, 128, None), (100, 228, 128, 48))
RUN_LM_STEPS, RUN_LM_FAIL_AT = 24, 13  # checkpoints at 10, 20, 24
# phase 9a, LM serving: gemma2-9b at full width through ServeEngine, the
# reference's decode_32k cell (32,768 positions, batch 128) cut to a cache
# of 1,024 positions and 8 slots; 16 requests from the seed, prompts of
# 16..512 tokens, budgets of 8..64 new tokens
LM_SERVE_SLOTS, LM_SERVE_MAX_LEN, LM_SERVE_PROMPT_CAP = 8, 1024, 512
LM_SERVE_REQUESTS, LM_SERVE_PROMPTS, LM_SERVE_GEN = 16, (16, 512), (8, 64)
LM_SERVE_ALONE = 4  # the first requests served alone: slot independence
LM_SERVE_B1 = 2  # requests held against a batch-1 lm_decode_step loop
LM_SERVE_TIMED = 20  # replays of the captured step timed
LM_SERVE_KERNELS = ("decode_attention",)
DECODE_KERNEL_RE = r"decode_(?:split|combine)_kernel"
DECODE_LAUNCHES = 2  # a decode attention call: the splits, their combine
# the split kernel's SASS read beside its row: conversions, the
# dequantization's integer and float32 ops, local memory (spills)
DECODE_SASS_OPS = ("I2F", "I2FP", "F2F", "F2FP", "PRMT", "FMUL", "FADD",
                   "FFMA", "LDL", "STL")
# the decode kernel's planted faults, read on a layer's own inputs with a
# float32 q: the cap and the dequantization's bf16 rounding at q x 8
# (scores where a cap of 50 acts), one position more and the next kv head
# at q x 1 (a spread softmax)
DECODE_Q_SCALE = 8.0
# a decode step's logits with the kernel against the same step with the
# twin in every layer, and the engine's batched logits against a batch-1
# loop's: bf16 activations round after every op, so one flipped ulp in
# one layer travels through the rest; the prefill's PATH_TOL
DECODE_PATH_TOL = B1_LOGIT_TOL = PATH_TOL
# the ring wrap at full widths: gemma2-9b cut to one (local, global) pair,
# one request of 4,200 prompt tokens and 16 new ones in a cache of 8,192
# positions; the local layer's ring holds 4,096
RING_PROMPT, RING_GEN, RING_MAX_LEN = 4200, 16, 8192
# decode_32k's length: one lm_decode_step at scalar position 32,767, the
# batch cut from 128 to 8, the cache random int8 and scales from the
# seed; the kernel held against the twin on DECODE_32K_CHECKED of its 8
# slots (the float64 tolerance of all 8 does not fit beside the cache)
DECODE_32K_LEN, DECODE_32K_BATCH, DECODE_32K_CHECKED = 32768, 8, 2
DECODE_32K_TIMED = 5  # decode steps timed on the host clock
# phase 9b, the other LM configs through the prefill cell's model and the
# ServeEngine of 9a (8 slots, 1,024 positions, 16 requests): (arch, layers
# kept, None for the published depth; prefill tokens, batch 1; the
# decode_32k step's batch, None for none; requests served alone to hold
# slot independence, 0 under MoE, whose capacity couples a step's slots).
# granite-moe-1b-a400m and codeqwen1.5-7b at full width and depth (the
# prefill_32k cell cut to 8,192 tokens; decode_32k's batch of 128 cut to 8
# and, codeqwen's 524,288 B of bf16 cache a position, 2); qwen1.5-32b and
# grok-1-314b at full width, their depth cut to fit one card beside their
# caches (64 layers of 70 GB and 629 GB of bf16 weights → 16 and 2)
LM_CONFIG_ALONE = 2
LM_CONFIG_RUNS = (("granite-moe-1b-a400m", None, 8192, 8, 0),
                  ("codeqwen1.5-7b", None, 8192, 2, LM_CONFIG_ALONE),
                  ("qwen1.5-32b", 16, 4096, None, LM_CONFIG_ALONE),
                  ("grok-1-314b", 2, 4096, None, 0))
# the qkv biases of codeqwen1.5-7b and qwen1.5-32b, which lm_init leaves
# zero, drawn N(0, QKV_BIAS_STD^2) from the seed (the projections' outputs
# are about N(0, 1))
QKV_BIAS_STD = 0.5


def log(*a):
    print(*a, flush=True)


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, iters=20, warmup=3, queued=True):
    """Mean device time of ``fn`` in ms: CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls. The timed calls queue
    behind a device sleep longer than their enqueueing takes the host (as
    the last warm-up call took it), so that a kernel shorter than its
    launch's host cost (a ctypes launch costs the host 10-25 us, a rank
    kernel runs 5-30 us) is timed on the device, not on the host.
    ``queued=False`` leaves the sleep out: the way earlier runs timed."""
    import torch
    for _ in range(warmup - 1):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # cycles at up to 2 GHz: half as long again as the enqueueing, at most
    # 0.2 s (a call that waits for the device inside is host-bound anyway)
    if queued:
        torch.cuda._sleep(int(min(1.5 * iters * host_s + 1e-4, 0.2) * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, ops, ops_per_s=ALU_OPS_PER_S):
    b, o = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def max_err(got, want):
    import torch
    return max(float((g.cpu().to(torch.int64) - w.cpu().to(torch.int64)
                      ).abs().max()) if g.numel() else 0.0
               for g, w in zip(got, want))


def set_count_readings(el, targets, want, iters=20):
    """One ``set_count_less`` call on these inputs through its two C
    entries: the time of both launches and of each alone, and the work its
    kernels count (csrc/set_count.cu ``work``) in one more call, whose
    counts must equal ``want``."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import set_count as tsc
    lib = _build.load("set_count", tsc._SIGNATURES)
    tiles, bounds = tsc.set_count_scratch(el.shape[0], el.device)
    out = torch.empty_like(targets)

    def sort(work=None):
        _build.check(tsc.tile_sort_c(lib, el, tiles, bounds, work),
                     "set_count_less (tile sort)")

    def count(work=None):
        _build.check(tsc.count_c(lib, el.shape[0], targets, out, tiles,
                                 bounds, work), "set_count_less (count)")
    r = dict(ms=cuda_ms(lambda: (sort(), count()), iters),
             sort_ms=cuda_ms(sort, iters), count_ms=cuda_ms(count, iters))
    work = torch.zeros(4, dtype=torch.int64, device=el.device)
    out.zero_()
    sort(work)
    count(work)
    check(torch.equal(out, want), "set_count_less: the launches that count "
          "their work compute the same counts")
    r.update(zip(("sort_compares", "count_compares", "bisections",
                  "tile_copies"), work.tolist()))
    r["compares"] = r["sort_compares"] + r["count_compares"]
    return r


def mma_per_tile(kernel, dh, n):
    """The MMAs of one tile of a bf16 flash kernel (``n``: its kv tile in
    the forward and dq, its query tile in dk/dv), each m16n8k16: a product
    over dh is (dh / 16) (n / 8), one over the tile's n rows
    (n / 16) (columns / 8), twice with the hi / lo split. From dh 128 on
    the backward kernels' warps work in pairs: each computes one of S, dP
    and half of the output columns."""
    over_dh = dh // 16 * (n // 8)
    over_n = n // 16 * (dh // 8)
    if kernel == "flash_fwd_mma_kernel":  # S; P V
        return over_dh + 2 * over_n
    pairs = dh >= 128
    outputs = 1 if kernel == "flash_dq_mma_kernel" else 2  # dQ; dV, dK
    return ((1 if pairs else 2) * over_dh
            + 2 * outputs * over_n // (2 if pairs else 1))


def ptxas_usage(name, kernel):
    """{dh: {"registers", "spill_stores", "spill_loads"}} of each function
    named ``kernel`` from this process's ptxas output for library
    ``name`` (empty for a library an earlier process built)."""
    from repro_torch.kernels import _build
    out, dh = {}, None
    for line in _build.BUILD_LOG.get(name, "").splitlines():
        if "Compiling entry function" in line:
            m = re.search(kernel + r"ILi(\d+)E", line)
            dh = int(m.group(1)) if m else None
        elif dh is not None:
            use = out.setdefault(dh, {})
            m = re.search(r"(\d+) registers", line)
            if m:
                use["registers"] = int(m.group(1))
            for n, what in re.findall(r"(\d+) bytes spill (stores|loads)",
                                      line):
                use["spill_" + what] = int(n)
    return out


def sass_summary(lib_path, kernel):
    """{mangled name: (HMMA instructions, local-memory loads and stores)}
    of each compiled function named ``kernel`` in a built library, from
    ``cuobjdump -sass``. LDL / STL are where ptxas spills registers."""
    from repro_torch.kernels import _build
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()),
                             "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for block in sass.split("Function :")[1:]:
        name, body = block.split("\n", 1)
        if kernel in name:
            out[name.strip()] = (body.count("HMMA"), len(re.findall(
                r"\b(?:LDL|STL)\b", body)))
    return out


def rank_adversarial(dev, seed):
    """The rank kernels bit for bit against their twins on adversarial
    non-decreasing streams: duplicate runs of 150,000 and 50,000 and a
    SENTINEL tail of 40,000, at the request's length, one element shorter
    and unaligned (a view from element 1) and at 400,000; queries sorted,
    sorted with one element out of place, and shuffled, below, inside and
    above the stream and SENTINEL; both sides and the rename. Returns the
    cases checked."""
    import torch
    from repro_torch.core.graph import SENTINEL
    from repro_torch.kernels import reindex_epilogue as tre

    g = torch.Generator(device=dev).manual_seed(seed + 5)
    i32 = dict(dtype=torch.int32, device=dev)
    cases = []
    for n in (SERVE_NODES, 400_000):
        vals = torch.randint(0, 3000, (n,), generator=g, **i32)
        vals[:150_000] = 777
        vals[150_000:200_000] = 2999
        vals[-40_000:] = SENTINEL
        arr = torch.sort(vals).values
        q = torch.cat([torch.arange(-3, 3004, **i32).repeat(90),
                       torch.full((500,), SENTINEL, **i32)])
        qs = torch.sort(q).values
        one_off = qs.clone()
        one_off[qs.numel() // 2] = -7
        shuffled = q[torch.randperm(q.numel(), generator=g, device=dev)]
        for tag, a in (("", arr), ("_unaligned", arr[1:])):
            if n != SERVE_NODES and tag:
                continue
            table = torch.arange(a.numel(), **i32) * 3
            for qname, qq in (("sorted", qs), ("one_off", one_off),
                              ("shuffled", shuffled)):
                for side in ("left", "right"):
                    check(torch.equal(tre.rank_search(a, qq, side),
                                      tre._unrolled_rank(a, qq, side)),
                          f"rank_search {side} on {n}{tag} long runs, "
                          f"{qname} queries == twin")
                check(torch.equal(tre.rename(a, table, qq),
                                  tre._rename_plain(a, table, qq)),
                      f"rename on {n}{tag} long runs, {qname} queries == "
                      "twin")
                cases.append(f"{a.numel()}{tag} {qname}")
    return cases


# ---------------------------------------------------------------- phase 3
def kernel_phase(dev, seed):
    """The slice path's digit-pass kernels against their twins at its
    shapes, and the rank epilogue's on adversarial streams (its five
    calls are timed on the path's own arrays in ``rank_phase``)."""
    import torch
    from repro_torch.core.set_partition import rank_gather_sources
    from repro_torch.kernels import radix_sort as trs
    from repro_torch.kernels import _build

    g = torch.Generator(device=dev).manual_seed(seed)
    nb, n = 1 << RADIX_BITS, SERVE_CAP
    n_tiles = n // TILE
    rows, extra = {}, {}

    # the reindex sort's pair stream: VIDs of one request (< bound), then
    # the SENTINEL padding clipped to the key bound
    bound_vid = REDDIT["nodes"]
    keys = torch.full((n,), bound_vid, dtype=torch.int32, device=dev)
    keys[:SERVE_NODES] = torch.randint(0, bound_vid, (SERVE_NODES,),
                                       generator=g, device=dev,
                                       dtype=torch.int32)
    vals = torch.arange(n, dtype=torch.int32, device=dev)
    lib = trs._lib()
    for with_vals in (True, False):
        v = vals if with_vals else None
        got = trs.digit_partition_hist(keys, v, 0, TILE, RADIX_BITS)
        want = trs._partition_hist_plain(keys, v, 0, TILE, RADIX_BITS)
        torch.cuda.synchronize()
        err = max_err([x for x in got if x is not None],
                      [x for x in want if x is not None])
        check(err == 0, f"digit_partition_hist (vals={with_vals}) == twin")
        pk, pv, lbase, hist = got
        ms = cuda_ms(lambda: lib.digit_partition_hist(
            keys.data_ptr(), None if v is None else v.data_ptr(),
            pk.data_ptr(), None if pv is None else pv.data_ptr(),
            lbase.data_ptr(), hist.data_ptr(), n_tiles, TILE, 0, nb,
            _build.stream_of(keys)))
        plain_ms = cuda_ms(lambda: trs._partition_hist_plain(
            keys, v, 0, TILE, RADIX_BITS), iters=5)
        digit2 = (keys & (nb - 1)).view(n_tiles, TILE)

        def library():
            order = torch.sort(digit2, dim=1, stable=True).indices
            out = keys.view(n_tiles, TILE).gather(1, order)
            return out, (None if v is None
                         else v.view(n_tiles, TILE).gather(1, order))
        lib_ms = cuda_ms(library, iters=5)
        streams = 2 if with_vals else 1
        b_ms, b_by = bound(4 * n * streams * 2 + 2 * 4 * n_tiles * nb, 4 * n)
        # the main path sorts pairs only; the keys-only variant is checked
        # and timed here and reported beside the kernels line
        name = "digit_partition_hist" + ("" if with_vals else "/keys_only")
        rows[name] = dict(
            name="digit_partition_hist", route="cuda",
            source="src/repro_torch/csrc/digit_pass.cu",
            replaces="src/repro/kernels/radix_sort.py:"
                     + ("195" if with_vals else "185"),
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms,
            shape=f"{n} {'pairs' if with_vals else 'keys'}, tile {TILE}, "
                  f"{nb} buckets")

    incl = torch.cumsum(hist, 0, dtype=torch.int32)
    excl = incl - hist
    gbase = (torch.cumsum(incl[-1], 0, dtype=torch.int32) - incl[-1]
             ).contiguous()
    src = trs.digit_rank_gather(gbase, incl, excl, lbase, TILE)
    want = rank_gather_sources(gbase, incl, excl, lbase, TILE)
    torch.cuda.synchronize()
    err = max_err([src], [want])
    check(err == 0, "digit_rank_gather == twin")
    ms = cuda_ms(lambda: lib.digit_rank_gather(
        gbase.data_ptr(), incl.data_ptr(), excl.data_ptr(), lbase.data_ptr(),
        src.data_ptr(), n, n_tiles, TILE, nb, _build.stream_of(src)))
    plain_ms = cuda_ms(lambda: rank_gather_sources(gbase, incl, excl, lbase,
                                                   TILE), iters=5)
    b_ms, b_by = bound(4 * (3 * n_tiles * nb + nb + n),
                       n * (RADIX_BITS + max(1, n_tiles.bit_length())))
    # the same sources: a stable sort of the partitioned layout's digits
    part_digit = pk & (nb - 1)
    lib_ms = cuda_ms(lambda: torch.sort(part_digit, stable=True).indices,
                     iters=5)
    rows["digit_rank_gather"] = dict(
        name="digit_rank_gather", route="cuda",
        source="src/repro_torch/csrc/digit_pass.cu",
        replaces="src/repro/kernels/radix_sort.py:208", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms, shape=f"{n} slots, [{n_tiles}, {nb}] tables; "
        "library: torch.sort(digit of the partitioned keys, stable=True)"
        ".indices")

    # the card's pass at the request's shape and the main path's widest
    # digit (7 bits: every request sort runs 7, 7, 6)
    width, shift = 7, 7
    rows.update(card_digit_rows(keys, vals, width, shift))
    extra["digit_pass_resources"] = resource_usage(
        "digit_pass", "digit_hist_kernel|digit_scatter_kernel")

    # the whole digit pass against one library sort + gather
    digit = keys & (nb - 1)
    extra["digit_pass_pairs_ms"] = cuda_ms(
        lambda: trs.global_digit_pass(keys, vals, 0, TILE, RADIX_BITS))
    extra["torch_sort_digit_plus_gather_ms"] = cuda_ms(
        lambda: (lambda o: (keys[o], vals[o]))(
            torch.sort(digit, stable=True).indices))

    extra["rank_adversarial"] = rank_adversarial(dev, seed)
    return rows, extra


def card_digit_rows(keys, vals, width, shift):
    """The ``digit_hist`` and ``digit_scatter`` rows (pairs) at these
    inputs: each against its twin, bit for bit, and timed beside its
    bound and twin; the histogram beside one ``torch.bincount`` of the
    bucket-major index (the same counts), the scatter beside a stable
    ``torch.sort`` of the digits + gathers (the same permutation)."""
    import torch
    from repro_torch.kernels import radix_sort as trs

    n, tile, nb = keys.numel(), trs.SCATTER_TILE, 1 << width
    n_tiles = trs.n_card_tiles(n, tile)
    counts = trs.digit_hist(keys, shift, tile, width)
    want = trs._digit_hist_plain(keys, shift, tile, width)
    offs = trs.digit_offsets(counts)
    got = trs.digit_scatter(keys, vals, offs, shift, tile, width)
    want_s = trs._digit_scatter_plain(keys, vals, offs, shift, tile, width)
    torch.cuda.synchronize()
    err_h = max_err([counts], [want])
    err_s = max_err(got, want_s)
    check(err_h == 0 and err_s == 0,
          f"digit_hist / digit_scatter == twins at {n} pairs, {width} bits")
    shape = f"{n} pairs, card tile {tile}, {nb} buckets"
    h_ms, h_by = bound(4 * n + 4 * nb * n_tiles, n)
    s_ms, s_by = bound(4 * (4 * n + nb * n_tiles), 4 * n)
    digit = (keys >> shift) & (nb - 1)
    # the histogram's library call: one bincount of digit * T + tile gives
    # the same bucket-major counts
    bucket = (digit.to(torch.int64) * n_tiles
              + torch.arange(n, device=keys.device) // tile)
    check(torch.equal(torch.bincount(bucket, minlength=nb * n_tiles).to(
        torch.int32), counts), f"torch.bincount == digit_hist at {n} pairs")
    common = dict(route="cuda", source="src/repro_torch/csrc/digit_pass.cu")
    return {
        "digit_hist": dict(
            name="digit_hist", replaces="src/repro/kernels/radix_sort.py:195",
            max_abs_err=err_h,
            ms=cuda_ms(lambda: trs.digit_hist(keys, shift, tile, width)),
            plain_ms=cuda_ms(lambda: trs._digit_hist_plain(
                keys, shift, tile, width), iters=5),
            bound_ms=h_ms, bound_by=h_by,
            library_ms=cuda_ms(lambda: torch.bincount(
                bucket, minlength=nb * n_tiles)),
            shape=shape + "; library: torch.bincount(digit * T + tile)",
            **common),
        "digit_scatter": dict(
            name="digit_scatter",
            replaces="src/repro/kernels/radix_sort.py:208",
            max_abs_err=err_s,
            ms=cuda_ms(lambda: trs.digit_scatter(keys, vals, offs, shift,
                                                 tile, width)),
            plain_ms=cuda_ms(lambda: trs._digit_scatter_plain(
                keys, vals, offs, shift, tile, width), iters=3),
            bound_ms=s_ms, bound_by=s_by,
            library_ms=cuda_ms(lambda: (lambda o: (keys[o], vals[o]))(
                torch.sort(digit, stable=True).indices)),
            shape=shape + "; library: torch.sort(digit, stable=True) + "
            "two gathers", **common)}


def resource_usage(name, kernel):
    """{function[<template arguments>]: {"registers", "stack", "shared",
    "local"}} of each function whose name matches the regex ``kernel`` in
    built library ``name``, from ``cuobjdump --dump-resource-usage``
    (cached builds too); LOCAL is where ptxas spills registers, SHARED the
    static shared memory (dynamic shared memory is the launch's)."""
    from repro_torch.kernels import _build
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()),
                             "cuobjdump")
    text = subprocess.run([cuobjdump, "--dump-resource-usage",
                           str(_build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for m in re.finditer(r"(" + kernel + r")(?:I(\w+?)E(?:Ev|v))?\S*:\s*\n"
                         r"\s*REG:(\d+) STACK:(\d+) SHARED:(\d+) "
                         r"LOCAL:(\d+)", text):
        key = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
        out[key] = dict(registers=int(m.group(3)), stack=int(m.group(4)),
                        shared=int(m.group(5)), local=int(m.group(6)))
    return out


def sass_ops(name, kernel, ops):
    """{mangled name: {op: instructions}} of each compiled function whose
    name contains ``kernel`` in built library ``name``: the static count
    of SASS instructions whose opcode is each of ``ops`` (with any
    suffix, e.g. F2F counts F2F.BF16.F32), from ``cuobjdump -sass``."""
    from repro_torch.kernels import _build
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()),
                             "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass",
                           str(_build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for block in sass.split("Function :")[1:]:
        fn, body = block.split("\n", 1)
        if kernel in fn:
            out[fn.strip()] = {op: len(re.findall(
                r"\*/\s+(?:@!?U?P\w+\s+)?" + op + r"\b[.\w]*", body))
                for op in ops}
    return out


def chunk_sort_reading(keys, with_vals, key_bits, twin_slice=None):
    """The chunk sort of ``keys`` (and arange values) in chunks of TILE
    against its twin (run on ``twin_slice`` elements at a time when given:
    the twin's one-hot partition takes 64 bytes an element a pass), timed
    through its C entry with the twin, ``torch.sort`` + gather and the
    bound. Returns (row, the kernel's output)."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import radix_sort as trs
    n = keys.numel()
    v = torch.arange(n, dtype=torch.int32, device=keys.device) \
        if with_vals else None
    got = trs.chunk_sort(keys, v, TILE, key_bits, RADIX_BITS)
    step = twin_slice or n
    want = [trs._chunk_sort(keys[i:i + step], None if v is None
                            else v[i:i + step], TILE, key_bits, RADIX_BITS)
            for i in range(0, n, step)]
    want = [torch.cat([w[0] for w in want])] + (
        [] if v is None else [torch.cat([w[1] for w in want])])
    torch.cuda.synchronize()
    err = max_err([x for x in got if x is not None], want)
    check(err == 0, f"chunk_sort ({n} {'pairs' if with_vals else 'keys'}) "
          "== twin")
    del want
    ok, ov = (x.clone() if x is not None else None for x in got)
    n_bits = trs.chunk_sort_bits(key_bits, RADIX_BITS)
    sched = trs.chunk_digit_schedule(n_bits)
    lib = trs._lib()
    ms = cuda_ms(lambda: _build.check(lib.chunk_sort(
        keys.data_ptr(), None if v is None else v.data_ptr(),
        ok.data_ptr(), None if ov is None else ov.data_ptr(), n // TILE,
        TILE, n_bits, _build.stream_of(keys)), "chunk_sort"))
    if twin_slice:  # one twin call on one slice, scaled to the whole
        plain_ms = cuda_ms(lambda: trs._chunk_sort(
            keys[:step], None if v is None else v[:step], TILE, key_bits,
            RADIX_BITS), iters=1, warmup=1) * n / step
    else:
        plain_ms = cuda_ms(lambda: trs._chunk_sort(
            keys, v, TILE, key_bits, RADIX_BITS), iters=3, warmup=1)

    def library():
        st = torch.sort(keys.view(-1, TILE), dim=1, stable=True)
        return st.values, (None if v is None else
                           v.view(-1, TILE).gather(1, st.indices))
    streams = 2 if with_vals else 1
    b_ms, b_by = bound(2 * 4 * n * streams, n * len(sched))
    row = dict(
        name="chunk_sort", route="cuda",
        source="src/repro_torch/csrc/digit_pass.cu",
        replaces="src/repro/kernels/radix_sort.py:"
                 + ("65" if with_vals else "98"),
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=cuda_ms(library, iters=5),
        shape=f"{n} {'pairs' if with_vals else 'keys'}, chunk {TILE}, "
              f"{key_bits}-bit keys sorted by bits [0, {n_bits}) in "
              f"{len(sched)} passes of {[w for _, w in sched]} bits"
              + (f" (twin: one {step}-element slice, scaled)"
                 if twin_slice else ""))
    return row, got


def merge_reading(ks, vs, run, fan_ins, rung, twin_slice=None):
    """``fused_merge_rounds`` (the rungs ``fan_ins`` over sorted runs of
    ``run``) or, with ``rung``, ``merge_rung`` (the one rung ``fan_ins``)
    against the twin (``merge_ladder`` on ``twin_slice`` elements at a
    time when given: whole super-blocks, which merge apart), timed through
    the C entry with the twin (one slice, scaled), a per-block stable
    ``torch.sort`` + gather and the bound. Returns (row, the kernel's
    output)."""
    import torch
    from repro_torch.kernels import merge as tm
    n = ks.numel()
    block = run * math.prod(fan_ins)
    if rung:
        got = tm.merge_rung(ks, vs, run, fan_ins[0])
    else:
        *got, new_run = tm.fused_merge_rounds(ks, vs, run)
        check(new_run == block == min(n, tm.DEFAULT_MAX_BLOCK),
              f"merged run {new_run}")
    step = twin_slice or n
    want = [tm.merge_ladder(ks[i:i + step], None if vs is None
                            else vs[i:i + step], run, fan_ins)
            for i in range(0, n, step)]
    want = [torch.cat([w[0] for w in want])] + (
        [] if vs is None else [torch.cat([w[1] for w in want])])
    torch.cuda.synchronize()
    name = "merge_rung" if rung else "fused_merge"
    err = max_err([x for x in got if x is not None], want)
    check(err == 0, f"{name} ({n} {'keys' if vs is None else 'pairs'}, "
          f"runs {run} → {block}) == twin")
    del want
    ms = cuda_ms(lambda: tm.merge_passes_c(ks, vs, run, fan_ins))
    plain_ms = cuda_ms(lambda: tm.merge_ladder(
        ks[:step], None if vs is None else vs[:step], run, fan_ins),
        iters=3 if step == n else 1, warmup=1) * n / step

    def library():
        st = torch.sort(ks.view(-1, block), dim=1, stable=True)
        return st.values, (None if vs is None else
                           vs.view(-1, block).gather(1, st.indices))
    passes = tm.merge_passes(run, fan_ins)
    b_ms, b_by = bound(2 * 4 * n * (1 if vs is None else 2),
                       n * len(passes))
    row = dict(
        name=name, route="cuda", source="src/repro_torch/csrc/merge.cu",
        # the reference's fused kernel (pairs, keys), or its jnp rungs
        replaces=("src/repro/core/ordering.py:236" if rung else
                  "src/repro/kernels/merge.py:"
                  + ("109" if vs is None else "118")),
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=cuda_ms(library, iters=5),
        shape=f"{n} {'keys' if vs is None else 'pairs'}, runs {run} → "
              f"{block} (fan-ins {fan_ins}: {len(passes)} merge-path "
              "passes; library: per-block torch.sort + gather)"
              + (f" (twin: one {step}-element slice, scaled)"
                 if step < n else ""))
    return row, got


def merge_kernel_phase(dev, seed):
    """The merge path's five kernels against their twins at its shapes:
    the sub-convert's 2^19-pair sort (chunk 4096, a 19-bit bound: key bits
    [0, 20) in 3 passes) and the chunk sort at the MERGE_CFG convert's
    2^27, the fused merge and one rung above it on those chunk sorts'
    runs, the subgraph pointer build's set count (282,625 targets over
    the 524,288-long sorted dst), and the segment sum on that dst (the
    path's own calls in ``merge_sum_phase``)."""
    import torch
    from repro_torch.core.graph import SENTINEL
    from repro_torch.core.set_count import count_less_than
    from repro_torch.kernels import merge as tm
    from repro_torch.kernels import radix_sort as trs
    from repro_torch.kernels import set_count as tsc

    g = torch.Generator(device=dev).manual_seed(seed + 10)
    n = SERVE_CAP
    rows, runs, extra = {}, {}, {}
    key_bits = SERVE_NODES.bit_length()
    keys = torch.full((n,), SERVE_NODES, dtype=torch.int32, device=dev)
    keys[:SERVE_EDGES] = torch.randint(0, SERVE_NODES, (SERVE_EDGES,),
                                       generator=g, device=dev,
                                       dtype=torch.int32)
    for with_vals in (True, False):
        r, runs[with_vals] = chunk_sort_reading(keys, with_vals, key_bits)
        rows["chunk_sort" + ("" if with_vals else "/keys_only")] = r
    # the MERGE_CFG convert's shape: 2^27 pairs of keys below Reddit's
    # node count (the two-pass Ordering's clipped src / dst, 18 bits)
    big = torch.randint(0, REDDIT["nodes"], (CHUNK_SORT_BIG,), generator=g,
                        device=dev, dtype=torch.int32)
    big_runs = {}
    for with_vals in (True, False):
        r, big_runs[with_vals] = chunk_sort_reading(
            big, with_vals, REDDIT["nodes"].bit_length(),
            twin_slice=CHUNK_SORT_TWIN_SLICE)
        extra["chunk_sort" + ("" if with_vals else "/keys_only")
              + f"_{CHUNK_SORT_BIG}"] = r
    del big
    extra["chunk_sort_resources"] = resource_usage("digit_pass",
                                                   "chunk_sort_kernel")

    # the merge kernels on the chunk sorts' runs of 4096: the fused merge's
    # rungs to 65,536, then one rung above them (65,536 → 131,072)
    for size, sorted_runs in ((n, runs), (CHUNK_SORT_BIG, big_runs)):
        tag = "" if size == n else f"/{size}"
        for with_vals in (True, False):
            kind = "" if with_vals else "/keys_only"
            ks, vs = sorted_runs[with_vals]
            sorted_runs[with_vals] = None
            fans = tm._round_fan_ins(size, TILE, tm.DEFAULT_MAX_BLOCK, 2)
            r, (fk, fv) = merge_reading(ks, vs, TILE, fans, rung=False,
                                        twin_slice=None if size == n
                                        else CHUNK_SORT_TWIN_SLICE)
            rows["fused_merge" + kind + tag] = r
            del ks, vs
            r, _ = merge_reading(fk, fv, tm.DEFAULT_MAX_BLOCK, [2],
                                 rung=True, twin_slice=None if size == n
                                 else CHUNK_SORT_TWIN_SLICE)
            rows["merge_rung" + kind + tag] = r
            del fk, fv
    del big_runs
    extra["merge_resources"] = resource_usage(
        "merge", "merge_(?:tile|partition)_kernel")

    # set count: the subgraph pointer build, the sorted dst with its
    # SENTINEL tail, then the same elements shuffled
    sdst = torch.full((n,), SENTINEL, dtype=torch.int32, device=dev)
    sdst[:SERVE_EDGES] = torch.sort(torch.randint(
        0, SERVE_NODES, (SERVE_EDGES,), generator=g, device=dev,
        dtype=torch.int32)).values
    targets = torch.arange(SERVE_NODES + 1, dtype=torch.int32, device=dev)
    q = targets.numel()
    rank = torch.searchsorted(sdst, targets, out_int32=True)
    for shuffled in (False, True):
        tag = "/shuffled" if shuffled else ""
        el = sdst[torch.randperm(n, generator=g, device=dev)] if shuffled \
            else sdst
        got = tsc.set_count_less(el, targets)
        want = count_less_than(el, targets)
        again = tsc.set_count_less(el, targets)
        torch.cuda.synchronize()
        err = max_err([got], [want])
        check(err == 0 and torch.equal(got, rank),
              f"set_count_less (shuffled={shuffled}) == twin == rank")
        check(torch.equal(got, again), f"set_count_less (shuffled="
              f"{shuffled}): two launches give the same bits")
        r = set_count_readings(el, targets, rank)
        for k in ("sort_ms", "count_ms", "sort_compares", "count_compares",
                  "bisections", "tile_copies"):
            extra[f"set_count_less{tag}_{k}"] = r[k]
        plain_ms = cuda_ms(lambda: count_less_than(el, targets), iters=2,
                           warmup=1)
        # bytes: each input read once, the output written once; the
        # compares the kernels counted on these inputs go in their own field
        b_ms, b_by = bound(4 * (n + 2 * q), 0)
        rows["set_count_less" + tag] = dict(
            name="set_count_less", route="cuda",
            source="src/repro_torch/csrc/set_count.cu",
            replaces="src/repro/kernels/set_count.py:44", max_abs_err=err,
            ms=r["ms"], plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=cuda_ms(lambda: torch.searchsorted(sdst, targets)),
            compares=r["compares"],
            shape=f"{q} targets over {n} {'shuffled' if shuffled else 'sorted'}"
                  " elements; ms covers both launches of one call (tile "
                  "sort, count; each alone in extra); compares: counted by "
                  "the kernels in one more call (library: torch.searchsorted "
                  "on the sorted elements, which assumes the order)")

    # segment sum on the synthetic stream (SERVE_EDGES live edges over
    # SERVE_NODES rows, the SENTINEL tail): a request's layer-1 width, the
    # families' D 70 and the degree width 1, then layer 1 as GraphSAGE's
    # MERGE_CFG forward calls it (node states read through the edge
    # sources, the mean); the path's own two calls in merge_sum_phase
    for d in (REDDIT["feats"], 70, 1):
        msgs = torch.randn((n, d), generator=g, device=dev)
        r = seg_sum_reading(sdst, msgs, SERVE_NODES)
        rows[f"segment_sum_sorted/synthetic_d{d}"] = seg_sum_row(
            r, "synthetic stream")
        del msgs
    x = torch.randn((SERVE_NODES, REDDIT["feats"]), generator=g, device=dev)
    src = torch.randint(0, SERVE_NODES, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    r = seg_sum_reading(sdst, x, SERVE_NODES, src, True)
    rows["segment_sum_sorted/synthetic_rows_mean"] = seg_sum_row(
        r, "synthetic stream")
    del x, src, sdst
    torch.cuda.empty_cache()
    extra["segment_sum_resources"] = resource_usage(
        "segment_agg", r"segment_\w+_kernel")
    check(extra["segment_sum_resources"] and all(
        u["local"] == 0 for u in extra["segment_sum_resources"].values()),
        f"the segment-sum kernels spill no registers: "
        f"{extra['segment_sum_resources']}")
    return rows, extra


def flash_close(got, want):
    """(within FLASH_RTOL / FLASH_ATOL, max abs error, largest share of
    the tolerance) of a bf16 flash output against its twin's."""
    import torch
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    share = float((diff / (FLASH_ATOL + FLASH_RTOL * w.abs())).max())
    return (share <= 1.0 and bool(torch.isfinite(g).all()),
            float(diff.max()), share)


def float64_witness(q, k, v, cap, got, want, heads=2, near=1e-3):
    """Largest |error| of the kernel's and of the twin's bf16 outputs
    against a float64 causal, capped attention of the first ``heads``
    query heads, over the outputs whose witness lies within ``near`` of
    zero: there the tolerance's 1e-5 is all there is."""
    import torch
    g = q.shape[1] // k.shape[1]
    seq, dh = q.shape[2], q.shape[3]
    pos = torch.arange(seq, device=q.device)
    live = pos[:, None] >= pos[None, :]
    errs = {"kernel": 0.0, "twin": 0.0}
    for h in range(heads):
        s = (q[0, h].double() * dh ** -0.5) @ k[0, h // g].double().T
        s = torch.where(live, cap * torch.tanh(s / cap), -1e30)
        ref = torch.softmax(s, -1) @ v[0, h // g].double()
        del s
        small = ref.abs() < near
        for name, out in (("kernel", got), ("twin", want)):
            errs[name] = max(errs[name], float(
                (out[0, h].double() - ref).abs()[small].max()))
    return errs


def causal_pairs(seq, window=None):
    """Live (query, key) pairs of one head under the causal mask with an
    optional window: query q sees min(q + 1, window) keys."""
    if window is None or window >= seq:
        return seq * (seq + 1) // 2
    return window * (window + 1) // 2 + (seq - window) * window


def lm_kernel_phase(dev, seed):
    """The LM slice's three kernels against their twins: the flash forward
    at gemma2-9b's head shapes, prefix_partition and filter_tree_lookup at
    the reference tests' shapes and one timed size each."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.set_count import filter_lookup
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import prefix_partition as tpp
    from repro_torch.kernels import set_count as tsc
    from repro_torch.models.attention import flash_attention_plain

    from repro_torch.configs import get_config

    g = torch.Generator(device=dev).manual_seed(seed + 20)
    rows, extra = {}, {}
    cfg = get_config(LM_ARCH)  # the attention shapes of its layers
    h, hkv, dh, cap = cfg.n_heads, cfg.n_kv_heads, cfg.dh, cfg.attn_logit_cap
    flib = _build.load("flash_attention", tfa._SIGNATURES)

    def qkv(seq, dtype):
        q, k, v = (torch.randn(shape, generator=g, device=dev)
                   for shape in ((1, h, seq, dh), (1, hkv, seq, dh),
                                 (1, hkv, seq, dh)))
        return [t.to(dtype) for t in (q * FLASH_Q_SCALE, k, v)]

    # float32 at FLASH_F32_SEQ tokens: the kernel's arithmetic against the
    # twin's without bf16 output rounding in the way
    q, k, v = qkv(FLASH_F32_SEQ, torch.float32)
    for window in (None, cfg.sliding_window // 4):
        kw = dict(causal=True, window=window, logit_cap=cap)
        err = float((tfa.flash_attention_bhsd(q, k, v, **kw)
                     - flash_attention_plain(q, k, v, **kw)).abs().max())
        extra[f"flash_f32_{FLASH_F32_SEQ}_window_{window}_max_abs_err"] = err
        check(err <= FLASH_F32_TOL, f"flash float32 (window {window}) within "
              f"{FLASH_F32_TOL} of the twin ({err})")

    q, k, v = qkv(LM_SEQ, cfg.dtype)
    k_rep = k.repeat_interleave(h // hkv, dim=1)
    v_rep = v.repeat_interleave(h // hkv, dim=1)
    # each layer kind with the planted fault the tolerance must reject:
    # the cap left off (global), the window one key too wide (local)
    for name, window, fault in (
            ("", None, dict(logit_cap=None)),
            ("/local", cfg.sliding_window,
             dict(window=cfg.sliding_window + 1))):
        kw = dict(causal=True, window=window, logit_cap=cap)
        got = tfa.flash_attention_bhsd(q, k, v, **kw)
        want = flash_attention_plain(q, k, v, **kw)
        ok, err, share = flash_close(got, want)
        extra[f"flash{name}_share_of_tol"] = share
        check(ok, f"flash_attention_fwd{name} within rtol {FLASH_RTOL} atol "
              f"{FLASH_ATOL} of the twin ({err}, {share:.3f} of the "
              "tolerance)")
        bad, fault_err, _ = flash_close(
            flash_attention_plain(q, k, v, **{**kw, **fault}), want)
        extra[f"flash{name}_fault_{next(iter(fault))}_max_abs_err"] = (
            fault_err)
        check(not bad, f"the flash tolerance rejects the twin with {fault} "
              f"({fault_err})")
        ms = cuda_ms(lambda: flib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), got.data_ptr(), None,
            None, 1, h, hkv, LM_SEQ, LM_SEQ, dh, 1, 1, int(window is not None),
            window or 0, 1, cap, dh ** -0.5, 0,
            _build.stream_of(q)), iters=5, warmup=1)
        plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, **kw),
                           iters=3, warmup=1)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k_rep, v_rep, is_causal=True), iters=5, warmup=1)
        pairs = causal_pairs(LM_SEQ, window)
        b_ms, b_by = bound(2 * LM_SEQ * dh * (2 * h + 2 * hkv),
                           4 * dh * pairs * h, BF16_FLOPS_PER_S)
        rows["flash_attention_fwd" + name] = dict(
            name="flash_attention_fwd", route="cuda",
            source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:80",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms,
            tflops=4 * dh * pairs * h / (ms * 1e-3) / 1e12,
            shape=f"B 1, H {h} over Hkv {hkv}, dh {dh}, {LM_SEQ} tokens, "
                  f"bf16, q x {FLASH_Q_SCALE}, causal, window {window}, "
                  f"cap {cap}; "
                  f"{4 * dh * pairs * h:.3e} FLOPs (library: "
                  "scaled_dot_product_attention, causal, no cap, no "
                  "window: a near function)")
        del got, want

    # FLASH_SWEEP more draws at the same shapes: on outputs near zero the
    # tolerance's 1e-5 sits near the float32 noise of the scores (the twin
    # itself lies up to ~1e-5 from a float64 witness there), so one draw
    # is thin evidence of the kernel's arithmetic
    shares = []
    for i in range(FLASH_SWEEP):
        q, k, v = qkv(LM_SEQ, cfg.dtype)
        for window in (None, cfg.sliding_window):
            kw = dict(causal=True, window=window, logit_cap=cap)
            got = tfa.flash_attention_bhsd(q, k, v, **kw)
            want = flash_attention_plain(q, k, v, **kw)
            ok, err, share = flash_close(got, want)
            shares.append(share)
            if i == 0 and window is None:
                extra["flash_vs_float64_near_zero"] = float64_witness(
                    q, k, v, cap, got, want)
            check(ok, f"flash_attention_fwd (window {window}, draw "
                  f"{len(shares) // 2}) within the bf16 tolerance of the "
                  f"twin ({err}, {share:.4f} of it)")
    extra["flash_sweep_share_of_tol"] = shares
    del q, k, v, k_rep, v_rep

    # prefix_partition: the reference test shapes, then the timed size
    plib = _build.load("prefix_partition", tpp._SIGNATURES)
    for n, block in PARTITION_SHAPES + (PARTITION_TIMED,):
        vals = torch.randint(-2**31, 2**31 - 1, (n,), generator=g,
                             device=dev, dtype=torch.int32)
        cond = torch.rand((n,), generator=g, device=dev) < 0.4
        got = tpp.prefix_partition(vals, cond, block)
        want = tpp._partition_plain(vals, cond, block)
        torch.cuda.synchronize()
        err = max_err(got, want)
        check(err == 0, f"prefix_partition ({n}, block {block}) == twin")
        if (n, block) != PARTITION_TIMED:
            continue
        out, nsel = got
        ms = cuda_ms(lambda: plib.prefix_partition(
            vals.data_ptr(), cond.data_ptr(), n, block, out.data_ptr(),
            nsel.data_ptr(), _build.stream_of(vals)))
        plain_ms = cuda_ms(lambda: tpp._partition_plain(vals, cond, block),
                           iters=3, warmup=1)
        v2, c2 = vals.view(-1, block), (~cond).view(-1, block).to(torch.uint8)

        def library():
            order = torch.sort(c2, dim=1, stable=True).indices
            return v2.gather(1, order), cond.view(-1, block).sum(1)
        b_ms, b_by = bound(9 * n + 4 * (n // block), n)
        rows["prefix_partition"] = dict(
            name="prefix_partition", route="cuda",
            source="src/repro_torch/csrc/prefix_partition.cu",
            replaces="src/repro/kernels/prefix_partition.py:36",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=cuda_ms(library, iters=5),
            shape=f"{n} int32 values, block {block}, 40% selected (also "
                  f"checked at {list(PARTITION_SHAPES)}; library: per-block "
                  "stable torch.sort of the condition + gather)")

    # filter_tree_lookup: the reference test shapes, then the timed sizes
    for e, t in FILTER_SHAPES + FILTER_TIMED:
        keys = torch.randperm(10 * e, generator=g, device=dev)[:e].to(
            torch.int32)
        pays = torch.arange(e, dtype=torch.int32, device=dev)
        tgts = torch.randint(0, 10 * e, (t,), generator=g, device=dev,
                             dtype=torch.int32)
        tgts[:t // 4] = keys[torch.randint(0, e, (t // 4,), generator=g,
                                           device=dev)]
        got = tsc.filter_tree_lookup(keys, pays, tgts)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = filter_lookup(keys, pays, tgts)  # all pairs, on the card
        end.record()
        torch.cuda.synchronize()
        err = max_err(got, want)
        check(err == 0 and 0 < int(got[1].sum()) < t,
              f"filter_tree_lookup ({e} keys, {t} targets) == twin")
        if (e, t) not in FILTER_TIMED:
            continue
        out, hit = got
        table = tsc.filter_scratch(e, dev)
        flt = _build.load("set_count", tsc._SIGNATURES)

        def build():
            _build.check(tsc.build_c(flt, keys, pays, table),
                         "filter_tree_lookup (build)")

        def probe():
            _build.check(tsc.probe_c(flt, e, table, tgts, out, hit),
                         "filter_tree_lookup (probe)")
        ms = cuda_ms(lambda: (build(), probe()))
        torch.cuda.synchronize()
        check(torch.equal(out, want[0]) and torch.equal(hit, want[1]),
              f"filter_tree_lookup ({e} keys, {t} targets): the timed "
              "launches give the twin's bits")
        if e * t <= FILTER_TWIN_TIMED:
            plain_ms = cuda_ms(lambda: filter_lookup(keys, pays, tgts),
                               iters=3, warmup=1)
        else:  # the check's one call above, timed by its events
            plain_ms = start.elapsed_time(end)
        sk, order = torch.sort(keys)
        sp = pays[order]

        def lookup(sk, sp):
            i = torch.clamp(torch.searchsorted(sk, tgts), max=e - 1)
            hit_ = sk[i] == tgts
            return torch.where(hit_, sp[i], -1), hit_

        def from_unsorted():
            sk, order = torch.sort(keys)
            return lookup(sk, pays[order])
        # bytes: keys and payloads read once, targets read once, out and
        # hit written once; the table's traffic stays in L2
        b_ms, b_by = bound(4 * 2 * e + (4 + 4 + 1) * t, e + t)
        r = dict(
            name="filter_tree_lookup", route="cuda",
            source="src/repro_torch/csrc/set_count.cu",
            replaces="src/repro/kernels/set_count.py:73", max_abs_err=err,
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=cuda_ms(lambda: lookup(sk, sp)),
            library_from_unsorted_ms=cuda_ms(from_unsorted),
            build_ms=cuda_ms(build), probe_ms=cuda_ms(probe),
            resources=resource_usage("set_count",
                                     r"filter_(?:build|probe)_kernel"),
            shape=f"{t} targets over {e} unique keys, a quarter hit (also "
                  f"checked at {list(FILTER_SHAPES)}); ms: the table's fill "
                  "and both launches (build, probe) through the C entries; "
                  "library: torch.searchsorted on keys sorted outside the "
                  "timed call + gathers; library_from_unsorted: "
                  "torch.sort of the keys + the same")
        if (e, t) == FILTER_TIMED[0]:
            rows["filter_tree_lookup"] = r
        else:
            extra[f"filter_tree_lookup_{e}x{t}"] = r
        del want
    return rows, extra


# ------------------------------------------------------------- phases 4-5
def main_path(dev, seed, n_requests):
    """Launch counters to 0, the Reddit-scale convert, the serve run,
    counters read. Returns what the checks need."""
    import numpy as np
    import torch
    from repro_torch.configs.graphsage_reddit import config
    from repro_torch.core import pipeline
    from repro_torch.core.graph import synthetic_coo
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import SLICE_CFG
    from repro_torch.models.gnn import GraphSAGE
    from repro_torch.serve import GnnServeEngine

    out = {}
    t0 = time.perf_counter()
    coo = synthetic_coo(REDDIT["nodes"], REDDIT["edges"], CONVERT_CAP, seed,
                        device=dev)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    feats = torch.randn((REDDIT["nodes"], REDDIT["feats"]), generator=g,
                        device=dev)
    model = GraphSAGE(config(), d_in=REDDIT["feats"],
                      n_classes=REDDIT["classes"],
                      generator=torch.Generator().manual_seed(seed + 2),
                      device=dev)
    torch.cuda.synchronize()
    out["setup_s"] = time.perf_counter() - t0

    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    csc = pipeline.convert(coo, SLICE_CFG, device=dev)
    torch.cuda.synchronize()
    out["convert_s"] = time.perf_counter() - t0
    out["convert_launches"] = launch_counts()

    eng = GnnServeEngine(model, csc, feats, n_slots=N_SLOTS,
                         seed_cap=SEED_CAP, cfg=SLICE_CFG, device=dev)
    rng = np.random.default_rng(seed)
    eng.submit(rng.choice(REDDIT["nodes"], 16, replace=False).tolist())
    eng.close_submissions()
    eng.run()  # warm-up request: the step's eager first run, its capture
    torch.cuda.synchronize()
    out["step_programs_after_warmup"] = eng.step_cache_size()
    eng.reopen()
    reqs = [rng.choice(REDDIT["nodes"], int(k), replace=False).tolist()
            for k in rng.integers(1, SEED_CAP + 1, n_requests)]
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    counted, handles = serve_run(eng, reqs, traced=True)
    out.update(counted)
    out.update(serve_run(eng, reqs)[0])
    out["peak_mem_gib"] = max(out["peak_mem_gib"], out["serve_peak_mem_gib"])
    return out, coo, csc, eng, reqs, handles, feats


def serve_run(eng, reqs, traced=False):
    """A serve run of ``reqs`` on a warmed engine (its step captured): the
    requests submitted, served and read. ``traced``, the main path's
    counted run: the launches the counters took over it (every step a
    replay, counted as the captured step's launches), the steps, and the
    hand-written kernels a ``torch.profiler`` trace of the same run shows
    (``serve_launch_checks`` holds the one against the other); else the
    timed run: predictions/s, latencies, the peak memory allocated over
    it and the peak reserved (the graph's pool included). Returns the
    readings and the requests' handles."""
    import torch
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.serve import percentile

    def serve():
        handles = [eng.submit(s) for s in reqs]
        eng.close_submissions()
        completed = eng.run()
        torch.cuda.synchronize()
        eng.reopen()
        check(len(completed) == len(reqs), "every request retired")
        return handles, completed

    steps = eng.stats.steps
    if traced:
        before = launch_counts()
        got = {}
        prof = profile_call(lambda: got.update(run=serve()), 0,
                            kernels=SERVE_KERNEL_RE)
        launches = launch_counts()
        return dict(
            serve_launches={k: launches[k] - before[k] for k in launches},
            launches=launches, serve_steps=eng.stats.steps - steps,
            serve_trace={k: v["count"] for k, v in prof["kernels"].items()}
        ), got["run"][0]
    out = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    handles, completed = serve()
    dt = time.perf_counter() - t0
    out["serve_peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    # the captured step's intermediates live in its graph's pool, which
    # the allocator counts as reserved, not allocated
    out["serve_peak_reserved_gib"] = torch.cuda.max_memory_reserved() / 2**30
    lat = [r.total_latency_s for r in completed]
    out["serve"] = dict(
        requests=len(reqs), seeds=sum(map(len, reqs)),
        steps=eng.stats.steps - steps, step_programs=eng.step_cache_size(),
        wall_s=dt, preds_per_s=sum(map(len, reqs)) / dt,
        p50_ms=percentile(lat, 0.5) * 1e3, p99_ms=percentile(lat, 0.99) * 1e3)
    return out, handles


def checks(dev, seed, coo, csc, eng, reqs, handles, extra):
    """Everything held against a reference, after the counted run."""
    import torch
    from repro_torch.core import pipeline
    from repro_torch.core.costmodel import EngineConfig
    from repro_torch.core.graph import SENTINEL
    from repro_torch.kernels import radix_sort as trs
    from repro_torch.kernels import reindex_epilogue as tre
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import SLICE_CFG
    from repro_torch.configs.graphsage_reddit import smoke_config

    # (a) convert == the torch.sort strategy on the same COO
    t0 = time.perf_counter()
    ref = pipeline.convert(coo, EngineConfig(sort_strategy="xla_sort",
                                             reindex_strategy="fused"),
                           device=dev)
    torch.cuda.synchronize()
    extra["convert_torch_sort_s"] = time.perf_counter() - t0
    check(torch.equal(csc.ptr, ref.ptr), "convert ptr == torch.sort strategy")
    check(torch.equal(csc.idx, ref.idx), "convert idx == torch.sort strategy")
    check(int(csc.ptr[-1]) == REDDIT["edges"], "ptr[-1] == edge count")
    del ref

    # (b) batched serving == the sequential per-request slot_fn loop
    batched_equals_sequential(eng, reqs, handles, "slice")

    # (c) the convert-scale pointer rank (232,966 queries over 2^27)
    n = REDDIT["nodes"]
    deg = torch.diff(csc.ptr)
    sorted_dst = torch.full((coo.capacity,), SENTINEL, dtype=torch.int32,
                            device=dev)
    sorted_dst[:REDDIT["edges"]] = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int32, device=dev), deg)
    targets = torch.arange(n + 1, dtype=torch.int32, device=dev)
    got = tre.rank_search(sorted_dst, targets, "left")
    check(torch.equal(got, tre._unrolled_rank(sorted_dst, targets, "left")),
          "convert-scale rank_search == twin")
    check(torch.equal(got, csc.ptr), "rank of the sorted stream == ptr")
    del sorted_dst

    # (d) the digit pass: both designs against their twins and timed, up
    # to the convert's 2^27 pairs
    extra["digit_pass"] = digit_phase(dev, seed)

    # (e) a small graph served on the card equals the CPU path
    small_graph_check(dev, seed, SLICE_CFG, smoke_config(), extra, "slice")

    # (f) four requests' subgraphs and logits with the rank-epilogue
    # kernels equal, bit for bit, those with their twins in their place
    # (the first port's search, which its kernels equalled bit for bit)
    rank_epilogue_is_invisible(eng, reqs[:4], handles[:4])


def digit_phase(dev, seed):
    """The global_radix digit pass on Reddit-like keys (uniform in [0,
    232,965], the convert's clipped dst / src): the card's pair against
    its twins bit for bit at DIGIT_CHECKED, pairs and keys, DIGIT_WIDTHS,
    and timed at DIGIT_TIMED beside its bounds, the reference's
    one-to-one pair and its whole pass (both checked at 2^24), and
    ``torch.sort``; at 2^27 the card tile swept, the whole 18-bit sort on
    the own schedule and on the reference's 4-bit passes against
    ``torch.sort(stable=True)`` + a gather."""
    import torch
    from repro_torch.core.set_partition import rank_gather_sources
    from repro_torch.kernels import radix_sort as trs
    from repro_torch.kernels import _build

    g = torch.Generator(device=dev).manual_seed(seed + 3)
    out = {}
    for n_pairs in sorted(set(DIGIT_CHECKED + DIGIT_TIMED)):
        keys = torch.randint(0, REDDIT["nodes"] + 1, (n_pairs,), generator=g,
                             device=dev, dtype=torch.int32)
        vals = torch.arange(n_pairs, dtype=torch.int32, device=dev)
        r = out[n_pairs] = {}
        timed = n_pairs in DIGIT_TIMED
        tile_of = (torch.arange(n_pairs, device=dev) // trs.SCATTER_TILE
                   if timed else None)
        for width in DIGIT_WIDTHS:
            shift = width  # the second digit
            for with_vals in (True, False):
                v = vals if with_vals else None
                tag = f"{width}bit_{'pairs' if with_vals else 'keys'}"
                counts = trs.digit_hist(keys, shift, trs.SCATTER_TILE, width)
                offs = trs.digit_offsets(counts)
                got = trs.digit_scatter(keys, v, offs, shift,
                                        trs.SCATTER_TILE, width)
                if n_pairs in DIGIT_CHECKED:
                    want_c = trs._digit_hist_plain(keys, shift,
                                                   trs.SCATTER_TILE, width)
                    check(torch.equal(counts, want_c),
                          f"digit_hist == twin at {n_pairs}, {tag}")
                    want = trs._digit_scatter_plain(keys, v, offs, shift,
                                                    trs.SCATTER_TILE, width)
                    check(torch.equal(got[0], want[0])
                          and (v is None or torch.equal(got[1], want[1])),
                          f"digit_scatter == twin at {n_pairs}, {tag}")
                    del want, want_c
                if not timed:
                    continue
                nb, nt = 1 << width, trs.n_card_tiles(n_pairs,
                                                      trs.SCATTER_TILE)
                streams = 2 if with_vals else 1
                if with_vals:
                    r[f"digit_hist_{width}bit_ms"] = cuda_ms(
                        lambda: trs.digit_hist(keys, shift, trs.SCATTER_TILE,
                                               width), iters=5)
                    r[f"digit_hist_{width}bit_bound_ms"] = bound(
                        4 * n_pairs + 4 * nb * nt, n_pairs)[0]
                    # the histogram's library call: one bincount of
                    # digit * T + tile gives the same bucket-major counts
                    def bucket():
                        return (((keys >> shift) & (nb - 1)).to(torch.int64)
                                * nt + tile_of)
                    index = bucket()
                    lib = torch.bincount(index, minlength=nb * nt)
                    check(torch.equal(lib.to(torch.int32), counts),
                          f"torch.bincount == digit_hist at {n_pairs}, {tag}")
                    r[f"library_hist_{width}bit_bincount_ms"] = cuda_ms(
                        lambda: torch.bincount(index, minlength=nb * nt),
                        iters=5)
                    r[f"library_hist_{width}bit_with_index_ms"] = cuda_ms(
                        lambda: torch.bincount(bucket(), minlength=nb * nt),
                        iters=5)
                    del index, lib
                    # the scatter's: a stable sort by the digit + gathers
                    digit = (keys >> shift) & (nb - 1)
                    r[f"library_scatter_{width}bit_pairs_ms"] = cuda_ms(
                        lambda: (lambda o: (keys[o], vals[o]))(
                            torch.sort(digit, stable=True).indices), iters=3)
                    del digit
                r[f"digit_scatter_{tag}_ms"] = cuda_ms(
                    lambda: trs.digit_scatter(keys, v, offs, shift,
                                              trs.SCATTER_TILE, width),
                    iters=5)
                r[f"digit_scatter_{tag}_bound_ms"] = bound(
                    4 * (2 * streams * n_pairs + nb * nt), n_pairs)[0]
                r[f"digit_pass_{tag}_ms"] = cuda_ms(
                    lambda: trs.digit_pass(keys, v, shift, width), iters=5)
                r[f"digit_pass_{tag}_bound_ms"] = bound(
                    4 * (2 * streams * n_pairs + n_pairs), n_pairs)[0]
            del got, counts, offs
        # the reference's one-to-one pair (4 bits, its tile), as before
        if n_pairs == 1 << 24 or timed:
            pk, pv, lbase, hist = trs.digit_partition_hist(
                keys, vals, 4, TILE, RADIX_BITS)
            if n_pairs == 1 << 24:
                want = trs._partition_hist_plain(keys, vals, 4, TILE,
                                                 RADIX_BITS)
                check(all(torch.equal(a, b) for a, b in
                          zip((pk, pv, lbase, hist), want)),
                      f"digit_partition_hist == twin at {n_pairs}")
                del want
            nt, nb = n_pairs // TILE, 1 << RADIX_BITS
            incl = torch.cumsum(hist, 0, dtype=torch.int32)
            excl = incl - hist
            gbase = (torch.cumsum(incl[-1], 0, dtype=torch.int32)
                     - incl[-1]).contiguous()
            src = trs.digit_rank_gather(gbase, incl, excl, lbase, TILE)
            if n_pairs == 1 << 24:
                check(torch.equal(src, rank_gather_sources(
                    gbase, incl, excl, lbase, TILE)),
                    f"digit_rank_gather == twin at {n_pairs}")
                # the whole old pass: a stable sort by the digit
                rk, rv = reference_design_pass(keys, vals)
                order = torch.sort((keys >> 4) & ((1 << RADIX_BITS) - 1),
                                   stable=True).indices
                check(torch.equal(rk, keys[order])
                      and torch.equal(rv, vals[order]),
                      f"the reference design's pass == a stable torch.sort "
                      f"by the digit at {n_pairs}")
                del rk, rv, order
        if timed:
            r["digit_partition_hist_ms"] = cuda_ms(
                lambda: trs._lib().digit_partition_hist(
                    keys.data_ptr(), vals.data_ptr(), pk.data_ptr(),
                    pv.data_ptr(), lbase.data_ptr(), hist.data_ptr(), nt,
                    TILE, 4, nb, _build.stream_of(keys)), iters=5)
            r["digit_rank_gather_ms"] = cuda_ms(
                lambda: trs._lib().digit_rank_gather(
                    gbase.data_ptr(), incl.data_ptr(), excl.data_ptr(),
                    lbase.data_ptr(), src.data_ptr(), n_pairs, nt, TILE, nb,
                    _build.stream_of(src)), iters=5)
            # the reference's pass: partition, table scan, rank-gather and
            # two takes (the pass every earlier run of this script timed)
            r["reference_design_pass_4bit_pairs_ms"] = cuda_ms(
                lambda: reference_design_pass(keys, vals), iters=3)
            r["torch_sort_pairs_ms"] = cuda_ms(
                lambda: torch.sort(keys, stable=True), iters=3, warmup=1)
        if n_pairs == max(DIGIT_TIMED):
            # one key everywhere (a SENTINEL-clipped stream): every item
            # of a warp adds to one counter
            same = torch.full_like(keys, REDDIT["nodes"])
            r["digit_hist_7bit_one_key_ms"] = cuda_ms(
                lambda: trs.digit_hist(same, 7, trs.SCATTER_TILE, 7), iters=5)
            r["digit_pass_7bit_pairs_one_key_ms"] = cuda_ms(
                lambda: trs.digit_pass(same, vals, 7, 7), iters=5)
            del same
            # the card tile, swept on the widest digit
            for tile in SCATTER_TILES:
                r[f"digit_pass_7bit_pairs_tile{tile}_ms"] = cuda_ms(
                    lambda: trs.digit_pass(keys, vals, 7, 7, tile), iters=5)
            # the whole sort of 18-bit keys: own schedule (7, 7, 6), the
            # reference's five 4-bit passes on the new kernels, torch.sort
            own = trs.make_radix_sort_fn(RADIX_BITS)
            key_bits = REDDIT["nodes"].bit_length()
            sk, sv = own(keys, vals, key_bits)
            ts, order = torch.sort(keys, stable=True)
            check(torch.equal(sk, ts) and torch.equal(sv, vals[order]),
                  f"the own-schedule sort == torch.sort at {n_pairs}")
            del sk, sv, ts, order

            def four_bit_passes():
                k, v = keys, vals
                for p in range(-(-key_bits // RADIX_BITS)):
                    k, v = trs.digit_pass(k, v, p * RADIX_BITS, RADIX_BITS)
                return k, v
            r["sort_own_schedule_ms"] = cuda_ms(
                lambda: own(keys, vals, key_bits), iters=3)
            r["sort_4bit_passes_ms"] = cuda_ms(four_bit_passes, iters=3)
            r["torch_sort_stable_plus_gather_ms"] = cuda_ms(
                lambda: (lambda s: (s.values, vals[s.indices]))(
                    torch.sort(keys, stable=True)), iters=3)
            r["own_schedule"] = trs.global_radix_schedule(key_bits,
                                                          RADIX_BITS)
        del keys, vals, tile_of
        if timed or n_pairs == 1 << 24:
            del pk, pv, lbase, hist, incl, excl, gbase, src
        log(f"[digit pass] {n_pairs} pairs: {r}")
    return {str(k): v for k, v in out.items()}


def reference_design_pass(keys, vals):
    """The reference's digit pass on its one-to-one kernels (4 bits, tile
    TILE): ``radix_sort.reference_digit_pass``; no path runs it."""
    from repro_torch.kernels import radix_sort as trs

    return trs.reference_digit_pass(keys, vals, 4, TILE, RADIX_BITS)


def rank_epilogue_is_invisible(eng, reqs, handles):
    """The SLICE_CFG subgraph (ptr, idx, order) and GraphSAGE logits of
    each request, sampled with the rank-epilogue kernels and again with
    ``rank_fn`` / ``rename_fn`` running the twins on the card: equal bit
    for bit."""
    import torch
    from repro_torch.core import pipeline
    from repro_torch.kernels import reindex_epilogue as tre
    from repro_torch.launch.serve import SLICE_CFG
    from repro_torch.models.gnn import subgraph_batch

    bundle = eng.params

    def run(seeds, key):
        with torch.inference_mode():
            sub = pipeline.sample_subgraph(bundle["csc"], seeds, eng.fanouts,
                                           key, SLICE_CFG)
            return sub, bundle["gnn"](subgraph_batch(sub, bundle["features"]))
    kernels = (tre.rank_fn, tre.rename_fn)
    for h, seeds in zip(handles, reqs):
        row, key = seed_row(eng, seeds), eng.request_key(h.rid)
        before = tre.rank_search.launches + tre.rename.launches
        sub_k, logits_k = run(row, key)
        check(tre.rank_search.launches + tre.rename.launches > before,
              "the kernel run launched the rank-epilogue kernels")
        tre.rank_fn = lambda a, q, side="left": tre._unrolled_rank(
            a.contiguous(), q.contiguous(), side)
        tre.rename_fn = lambda a, t, q: tre._rename_plain(
            a.contiguous(), t.contiguous(), q.contiguous())
        pipeline._KERNEL_FNS.clear()  # routing is built once a config
        try:
            sub_t, logits_t = run(row, key)
        finally:
            tre.rank_fn, tre.rename_fn = kernels
            pipeline._KERNEL_FNS.clear()
        check(all(torch.equal(a, b) for a, b in (
            (sub_k.csc.ptr, sub_t.csc.ptr), (sub_k.csc.idx, sub_t.csc.idx),
            (sub_k.order, sub_t.order), (logits_k, logits_t))),
            f"request {h.rid}: subgraph and logits with the rank kernels == "
            "with their twins, bit for bit")


RANK_CALLS = ("a_convert_ptr", "b_first_occurrence", "c_prefix_sum",
              "e_rename", "d_subgraph_ptr")  # in the order the path calls


def rank_calls_of_the_path(dev, coo, eng, seeds, rid):
    """{name: (sorted stream, queries, side, slot table or None)}: copies
    of what the SLICE_CFG main path hands the rank-epilogue wrappers, taken
    by wrapping ``rank_fn`` / ``rename_fn`` (as check (f) swaps them) over
    one convert of the main path's COO, (a) its pointer build, and one
    request of ``seeds`` through ``slot_fn``: (b) the first-occurrence
    rank, (c) the prefix-sum rank, (e) the rename of the edges'
    endpoints, (d) the subgraph pointer build."""
    import torch
    from repro_torch.core import pipeline
    from repro_torch.kernels import reindex_epilogue as tre
    from repro_torch.launch.serve import SLICE_CFG

    calls = []
    kernels = (tre.rank_fn, tre.rename_fn)

    def rank(a, q, side="left"):
        calls.append((a.contiguous().clone(), q.contiguous().clone(), side,
                      None))
        return kernels[0](a, q, side)

    def rename(a, t, q):
        calls.append((a.contiguous().clone(), q.contiguous().clone(), None,
                      t.contiguous().clone()))
        return kernels[1](a, t, q)
    row = seed_row(eng, seeds)
    tre.rank_fn, tre.rename_fn = rank, rename
    try:
        pipeline.convert(coo, SLICE_CFG, device=dev)
        check(len(calls) == 1, f"one rank call in a convert: {len(calls)}")
        eng.slot_fn(eng.params, row, eng.request_key(rid))
        torch.cuda.synchronize()
    finally:
        tre.rank_fn, tre.rename_fn = kernels
    check(len(calls) == len(RANK_CALLS)
          and [c[3] is not None for c in calls] == [
              k == "e_rename" for k in RANK_CALLS],
          f"a convert and a request hand the rank epilogue {RANK_CALLS}: "
          f"{[(c[0].numel(), c[1].numel(), c[2]) for c in calls]}")
    return dict(zip(RANK_CALLS, calls))


def rank_phase(dev, coo, eng, seeds, rid):
    """The rank epilogue on the arrays of the main path's five calls
    (``rank_calls_of_the_path``), each bit for bit against its twin and
    timed in turns: twin, kernel, kernel, ``torch.searchsorted``, then the
    kernel and the library without the queueing sleep (the host's cost).
    Returns the kernels' rows and the readings per call."""
    import torch
    from repro_torch.core.graph import SENTINEL
    from repro_torch.kernels import reindex_epilogue as tre

    timed = {}
    for key, (arr, qs, side, table) in rank_calls_of_the_path(
            dev, coo, eng, seeds, rid).items():
        if table is None:
            def kernel():
                return tre.rank_search(arr, qs, side)

            def plain():
                return tre._unrolled_rank(arr, qs, side)
        else:
            def kernel():
                return tre.rename(arr, table, qs)

            def plain():
                return tre._rename_plain(arr, table, qs)

        def library():
            return torch.searchsorted(
                arr, qs, side="left" if table is not None else side)
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = max_err([got], [want])
        check(err == 0, f"{key}: the kernel == twin")
        plain_ms = cuda_ms(plain, iters=5)
        ms = cuda_ms(kernel)
        ms_again = cuda_ms(kernel)
        lib_ms = cuda_ms(library)
        n, q = arr.numel(), qs.numel()
        # queries read and ranks written once; of the stream (and the
        # table), what the queries can need: a 32-byte sector each, at
        # most the whole stream
        need = min(4 * n, 32 * q)
        b_ms, b_by = bound(8 * q + need * (1 if table is None else 2),
                           q * max(1, n.bit_length()))
        timed[key] = dict(
            max_abs_err=err, ms=ms, ms_again=ms_again, plain_ms=plain_ms,
            library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
            unqueued_ms=cuda_ms(kernel, queued=False),
            library_unqueued_ms=cuda_ms(library, queued=False),
            # the queries' shape: sorted or not, how many differ from the
            # one before (the rename's edge_dst half repeats each frontier
            # node k times), how many are SENTINEL
            sorted_queries=bool((qs[1:] >= qs[:-1]).all()) if q else True,
            query_runs=1 + int((qs[1:] != qs[:-1]).sum()) if q else 0,
            sentinel_queries=int((qs == SENTINEL).sum()),
            shape=f"{q} queries over {n}"
                  + (" (rename)" if table is not None else f", {side}"))
        log(f"[rank] {key}: {timed[key]}")
    rows = {}
    for name, key, line in (
            ("rank_search", "b_first_occurrence", 57),
            ("rename", "e_rename", 93)):
        r = timed[key]
        rows[name] = dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/reindex_epilogue.cu",
            replaces=f"src/repro/kernels/reindex_epilogue.py:{line}",
            **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms")},
            shape=f"{key}, the path's own arrays: {r['shape']}")
    return rows, timed


# a GraphSAGE request's pointer sums: a layer's mean of the node states
# read through the edge sources, one call each
SCAN_CALLS = ("layer1", "layer2")
# (E, D, N, pointers) of the span sum's synthetic cases: a request's
# layer-1 shape with every row in a segment ("full"), a ragged E and D
# and a ragged E at the feature width ("ragged"), and one span of 2^17
# rows among short ones at D 1 and at the feature width ("long")
SCAN_CASES = {"full_stream": (SERVE_CAP, REDDIT["feats"], SERVE_NODES,
                              "full"),
              "ragged": (100_003, 37, 20_011, "ragged"),
              "ragged_wide": (300_001, REDDIT["feats"], 150_007, "ragged"),
              "long_d1": (1 << 18, 1, 4096, "long"),
              "long_wide": (1 << 18, REDDIT["feats"], 4096, "long")}
LONG_SPAN = 1 << 17


def recorded_calls(eng, seeds, rid, module, name):
    """Copies of the arguments of every call one request (``slot_fn`` on
    ``seeds``, eager) makes to ``module.name``, in order, taken by
    wrapping it for that request."""
    import torch

    calls = []
    fn = getattr(module, name)

    def recording(*args):
        calls.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a
                           for a in args))
        return fn(*args)
    setattr(module, name, recording)
    try:
        eng.slot_fn(eng.params, seed_row(eng, seeds), eng.request_key(rid))
        torch.cuda.synchronize()
    finally:
        setattr(module, name, fn)
    return calls


def scan_calls_of_the_path(eng, seeds, rid):
    """{name: (ptr, x, rows, mean)}: copies of what one SLICE_CFG request
    (``slot_fn`` on ``seeds``) hands the span sum, taken by wrapping
    ``models.gnn.ptr_seg_sum``: per layer the node states, the edge
    sources to read them through, and the mean flag, in the order the
    forward calls them."""
    from repro_torch.models import gnn as tgnn

    calls = recorded_calls(eng, seeds, rid, tgnn, "ptr_seg_sum")
    check(len(calls) == len(SCAN_CALLS)
          and [c[1].shape[1] for c in calls] == [REDDIT["feats"], 128]
          and all(len(c) == 4 and c[2] is not None and c[3] is True
                  for c in calls),
          f"a request hands the span sum {SCAN_CALLS}, each with the edge "
          f"sources and the mean: "
          f"{[(tuple(c[1].shape), len(c)) for c in calls]}")
    return dict(zip(SCAN_CALLS, calls))


def scan_case(dev, seed, e, d, n, kind):
    """Sorted pointers [n + 1] in [0, e] over N(0, 1) messages [e, d]:
    ``full`` from 0 to e, every message row inside a segment; ``ragged`` a
    first pointer past 0 and a last short of e, with empty segments;
    ``long`` as ragged over e - LONG_SPAN rows, with one span of
    LONG_SPAN rows in the middle."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    msgs = torch.randn((e, d), generator=g, device=dev)
    top = e - LONG_SPAN if kind == "long" else e
    ptr = torch.sort(torch.randint(0, top + 1, (n + 1,), generator=g,
                                   device=dev, dtype=torch.int32)).values
    ptr[n // 4:n // 4 + 50] = ptr[n // 4].clone()
    if kind == "full":
        ptr[0], ptr[-1] = 0, e
    if kind == "long":
        ptr[n // 2 + 1:] += LONG_SPAN
    return ptr, msgs


def scan_reading(ptr, x, rows=None, mean=False, twin=True, timed=True):
    """The span sum on (ptr, x, rows, mean) against its twin within
    ``twin_tolerance``, the same bits on two launches, and timed: the
    kernel, the twin (``torch.cumsum`` along dim 0 and two
    ``index_select``s, after the gather when ``rows`` is given), the one
    PyTorch call that computes the sum (``torch.segment_reduce(msgs,
    "sum", offsets=ptr)``: the library yardstick, on the gathered stream
    when ``rows`` is given, the gather and the mean's division untimed),
    and the bound for this data: the rows the spans name read once (the
    distinct ones through ``rows``, and the index below ptr[N]), the
    pointers, the output written. ``twin=False``: the bound and the kernel
    alone (a check elsewhere holds it); ``timed=False``: the checks
    alone."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ptr_scan

    e = x.shape[0] if rows is None else rows.shape[0]
    d = x.shape[1]
    n = ptr.shape[0] - 1

    def kernel():
        return ptr_scan.ptr_seg_sum(ptr, x, rows, mean)
    got, again = kernel(), kernel()
    torch.cuda.synchronize()
    what = (f"ptr_seg_sum [{e}, {d}]" + (" through rows" if rows is not None
                                         else "") + (", mean" if mean else ""))
    check(torch.equal(got, again), f"{what}: the same bits on two launches")
    lim = min(e, int(ptr[-1]))
    if rows is None:
        read = lim * d
    else:
        read = (int(torch.unique(rows[:lim].clamp(0, x.shape[0] - 1)).numel())
                * d + lim)
    b_ms, b_by = bound(4 * (read + n * d + n + 1),
                       lim * d + (n * d if mean else 0))
    r = dict(bound_ms=b_ms, bound_by=b_by, rows_read=lim,
             shape=f"[{e}, {d}] -> {n} rows, ptr[N] = {lim}"
             + (f", x [{x.shape[0]}, {d}] through rows" if rows is not None
                else "") + (", mean" if mean else ""))
    if timed:
        r["ms"] = cuda_ms(kernel)
    if not twin:
        return r

    def plain():
        return ptr_scan._ptr_seg_sum_plain(ptr, x, rows, mean)
    p = ptr.to(torch.int64)
    msgs = ptr_scan._rows_of(x, rows)

    def library():
        return torch.segment_reduce(msgs, "sum", offsets=p, axis=0,
                                    unsafe=True)
    want = plain()
    tol = ptr_scan.twin_tolerance(ptr, x, rows, mean)
    err = (got.double() - want.double()).abs()
    share = float((err / tol.clamp_min(1e-300)).max()) if err.numel() else 0.0
    check(bool((err <= tol).all()),
          f"{what} within twin_tolerance of the twin (worst {share:.3f} of "
          f"it)")
    r.update(max_abs_err=float(err.max()) if err.numel() else 0.0,
             share_of_tolerance=share)
    if not timed:
        return r
    cs64 = F.pad(torch.cumsum(msgs.double(), 0), (0, 0, 1, 0))
    exact = cs64.index_select(0, p[1:]) - cs64.index_select(0, p[:-1])
    if mean:
        exact = exact / (p[1:] - p[:-1]).clamp(min=1).double()[:, None]
    lib_out = library()
    if mean:
        lib_out = lib_out / (p[1:] - p[:-1]).clamp(min=1).float()[:, None]
    r.update(kernel_vs_float64=float((got.double() - exact).abs().max()),
             twin_vs_float64=float((want.double() - exact).abs().max()),
             library_vs_float64=float((lib_out.double() - exact).abs().max()),
             plain_ms=cuda_ms(plain, iters=2, warmup=1),
             library_ms=cuda_ms(library, iters=5))
    del want, tol, err, cs64, exact, lib_out, msgs
    return r


def scan_phase(dev, seed, eng, seeds, rid):
    """The span sum (``ptr_seg_sum``) on the two calls of one full-width
    SLICE_CFG request (``scan_calls_of_the_path``), on every message row
    valid at a request's layer-1 shape (ptr from 0 to E: the whole stream
    read), on a ragged E and D, and on one span of 2^17 rows; each against
    its twin within the derived tolerance and timed. The request's layer 1
    also as the composition the fused call replaced: the [E, D] gather,
    the span sum of the stream, the division by the degrees. Returns the
    kernel's row (the request's layer 1) and every reading."""
    import torch
    from repro_torch.kernels import ptr_scan

    readings = {}
    for key, call in scan_calls_of_the_path(eng, seeds, rid).items():
        readings[key] = scan_reading(*call)
        if key == "layer1":
            ptr, x, rows, _ = call
            deg = (ptr[1:] - ptr[:-1]).clamp(min=1).float()[:, None]

            def unfused():
                msgs = ptr_scan._rows_of(x, rows)
                return ptr_scan.ptr_seg_sum(ptr, msgs) / deg
            readings[key]["unfused_ms"] = cuda_ms(unfused)
        log(f"[scan] {key}: {readings[key]}")
        del call
    for key, (e, d, n, kind) in SCAN_CASES.items():
        ptr, msgs = scan_case(dev, seed + e + d, e, d, n, kind)
        readings[key] = scan_reading(ptr, msgs)
        log(f"[scan] {key}: {readings[key]}")
        del ptr, msgs
    torch.cuda.empty_cache()
    readings["resources"] = resource_usage("ptr_scan", r"\w+_kernel")
    check(readings["resources"] and all(
        u["local"] == 0 for u in readings["resources"].values()),
        f"the span-sum kernel spills no registers: {readings['resources']}")
    r = readings["layer1"]
    row = dict(name="ptr_seg_sum", route="cuda",
               source="src/repro_torch/csrc/ptr_scan.cu",
               replaces="src/repro/models/gnn.py:80 (_ptr_seg_sum in jnp, no "
                        "Pallas call)",
               **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms")},
               shape="a request's layer-1 call, the path's own arrays: "
                     + r["shape"] + f"; launches a lane: {len(SCAN_CALLS)}; "
                     "library: segment_reduce on the gathered stream")
    check(ptr_scan.ptr_seg_sum.launches > 0, "the span sum launched")
    return {"ptr_seg_sum": row}, readings


def lane_launches(eng, seeds, rid):
    """The kernel launches of one request through ``slot_fn`` (eager),
    what one lane of the captured step launches: as the counters took
    them, and the hand-written kernels of a trace of the same call."""
    from repro_torch.kernels import launch_counts
    before = launch_counts()
    prof = profile_call(lambda: eng.slot_fn(eng.params, seed_row(eng, seeds),
                                            eng.request_key(rid)), 0,
                        kernels=SERVE_KERNEL_RE)
    after = launch_counts()
    return ({k: after[k] - before[k] for k in after if after[k] != before[k]},
            {k: v["count"] for k, v in prof["kernels"].items()})


def counters_match_trace(what, counts, trace):
    """The launches the wrappers counted against the kernels a trace of
    the same run shows: one kernel a counted launch for the 1:1 wrappers
    (ptr_seg_sum among them: its span-sum kernel, one a call), the set
    count's two counted launches its two kernels, and one partition and
    one tile kernel a pass of the merge pair's calls (one pass or more a
    call)."""
    def n(kernel):
        return trace.get(kernel, 0)
    merges = counts.get("fused_merge", 0) + counts.get("merge_rung", 0)
    ok = (all(counts.get(w, 0) == n(k) for w, k in TRACE_OF_WRAPPER.items())
          and counts.get("set_count_less", 0)
          == n("tile_sort_kernel") + n("set_count_kernel")
          and n("merge_tile_kernel") == n("merge_partition_kernel")
          and merges <= n("merge_tile_kernel") and (merges > 0)
          == (n("merge_tile_kernel") > 0))
    check(ok, f"{what}: the counted launches {counts} are the kernels its "
          f"trace shows {trace}")


def serve_launch_checks(tag, eng, out, reqs, handles):
    """The captured step after the 16 requests: one step program. One
    eager slot_fn's counted launches match its trace; a capture counted
    n_slots lanes of them; and the main path's counted serve run (every
    step a replay) counted steps x the capture's launches and its trace
    shows steps x n_slots lanes of the eager lane's kernels, so every
    launch the counters took in it happened on the card."""
    check(out["step_programs_after_warmup"] == eng.step_cache_size() == 1,
          f"{tag}: one captured step program after warm-up "
          f"({out['step_programs_after_warmup']}) and after the "
          f"{len(reqs)} requests ({eng.step_cache_size()})")
    lane, lane_trace = lane_launches(eng, reqs[0], handles[0].rid)
    counters_match_trace(f"{tag}: an eager slot_fn", lane, lane_trace)
    step = eng.captured_launches()
    check(step == {k: eng.n_slots * v for k, v in lane.items()},
          f"{tag}: a replay launches {eng.n_slots} lanes of slot_fn's "
          f"kernels: {step} against {lane} a lane")
    steps = out["serve_steps"]
    served = {k: v for k, v in out["serve_launches"].items() if v}
    check(steps > 0 and served == {k: steps * v for k, v in step.items()},
          f"{tag}: {steps} replays counted {steps} x {step}: {served}")
    want = {k: steps * eng.n_slots * v for k, v in lane_trace.items()}
    check(out["serve_trace"] == want,
          f"{tag}: the counted serve run's trace shows {steps} replays of "
          f"{eng.n_slots} lanes' kernels: {out['serve_trace']} against "
          f"{want}")
    counters_match_trace(f"{tag}: the counted serve run", served,
                         out["serve_trace"])
    out["lane_launches"], out["step_launches"] = lane, step
    out["lane_trace"] = lane_trace
    return lane


def step_profile(eng, reqs, handles, lane_trace, top=10):
    """One replayed step with every slot seated (the n_slots largest
    requests, under their own request ids): its emission equals what
    those requests were served; its host wall time (replay + the emission
    read back, median of 5), its device span (CUDA events around the
    replay, median of 5), and once more under ``torch.profiler``: wall,
    kernel time, busy share, the top ops and the hand-written kernels by
    name, which must be ``n_slots`` times ``lane_trace`` (an eager
    slot_fn's), while the counters advance by the captured launches."""
    import statistics
    import torch
    from repro_torch.kernels import launch_counts
    from repro_torch.serve.feeder import PreparedAdmission
    from repro_torch.serve.request import Request

    big = sorted(range(len(reqs)), key=lambda i: -len(reqs[i]))[:eng.n_slots]

    def seat():
        wave = []
        for slot, i in enumerate(big):
            row = seed_row(eng, reqs[i]).cpu().numpy()
            wave.append((slot, PreparedAdmission(
                Request(rid=handles[i].rid, prompt=reqs[i]), row)))
        eng._admit_many(wave)
        torch.cuda.synchronize()
    seat()
    em = eng._step()
    for slot, i in enumerate(big):
        check(em[slot, 0] == 1 and em[slot, 1:1 + len(reqs[i])].tolist()
              == handles[i].tokens_out,
              f"the profiled step's slot {slot} == request "
              f"{handles[i].rid} as served")
    walls, spans = [], []
    for _ in range(5):
        seat()
        t0 = time.perf_counter()
        eng._step()
        walls.append((time.perf_counter() - t0) * 1e3)
        seat()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        eng._graph.replay()
        ev[1].record()
        ev[1].synchronize()
        spans.append(ev[0].elapsed_time(ev[1]))
    seat()
    before = launch_counts()
    prof = profile_call(eng._step, top, kernels=PATH_KERNEL_RE)
    after = launch_counts()
    counted = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    traced = {k: v["count"] for k, v in prof["kernels"].items()
              if re.fullmatch(SERVE_KERNEL_RE, k)}
    check(counted == eng.captured_launches() and traced == {
        k: eng.n_slots * v for k, v in lane_trace.items()},
          f"the profiled replay counted {counted} and its trace shows "
          f"{traced}: {eng.n_slots} lanes of an eager slot_fn's {lane_trace}")
    return dict(seeds=sum(len(reqs[i]) for i in big), slots=eng.n_slots,
                step_wall_ms=statistics.median(walls),
                step_device_span_ms=statistics.median(spans),
                step_walls_ms=walls, step_spans_ms=spans, **prof)


def padded_row(seeds, cap=None):
    """A request's row of ``cap`` (default SEED_CAP) on the host,
    SENTINEL after its seeds."""
    import torch
    from repro_torch.core.graph import SENTINEL
    row = torch.full((SEED_CAP if cap is None else cap,), SENTINEL,
                     dtype=torch.int32)
    row[:len(seeds)] = torch.tensor(seeds, dtype=torch.int32)
    return row


def seed_row(eng, seeds):
    """A request's SENTINEL-padded seed row on the engine's device."""
    return padded_row(seeds, eng.seed_cap).to(eng.device)


def batched_equals_sequential(eng, reqs, handles, tag):
    """Every served request equals the sequential per-request slot_fn."""
    for h, seeds in zip(handles, reqs):
        seq = eng.slot_fn(eng.params, seed_row(eng, seeds),
                          eng.request_key(h.rid))
        check(h.tokens_out == seq[:len(seeds)].tolist(),
              f"{tag} request {h.rid}: batched == sequential")
        check(all(0 <= p < REDDIT["classes"] for p in h.tokens_out),
              f"{tag} request {h.rid}: predictions are class ids")


def small_graph_check(dev, seed, cfg, gnn_cfg, extra, tag):
    """A small graph converted, sampled and run through the forward of
    ``gnn_cfg``'s family on the card under ``cfg`` equals the CPU path:
    integers exact, logits within SMALL_LOGIT_TOL of their largest
    magnitude (at least 1; cuBLAS and the card's sums add in another order
    than the CPU)."""
    import numpy as np
    import torch
    from repro_torch.core import pipeline
    from repro_torch.core.graph import COO, random_coo
    from repro_torch.models.gnn import gnn_model, subgraph_batch

    d, s = random_coo(np.random.default_rng(seed), 3000, 20000)
    small = COO.from_arrays(d, s, 3000, capacity=1 << 15, device="cpu")
    feats = torch.from_numpy(np.random.default_rng(seed + 1).normal(
        size=(3000, 24)).astype(np.float32))
    model = gnn_model(gnn_cfg, d_in=24, n_classes=5,
                      generator=torch.Generator().manual_seed(seed),
                      device="cpu")
    csc_c = pipeline.convert(small, cfg, device="cpu")
    csc_g = pipeline.convert(small, cfg, device=dev)
    check(torch.equal(csc_g.ptr.cpu(), csc_c.ptr) and
          torch.equal(csc_g.idx.cpu(), csc_c.idx),
          f"{tag} small convert: card == CPU")
    seeds = np.random.default_rng(seed + 2).choice(3000, 64, replace=False)
    from repro_torch.core import prng
    key = prng.fold_in(prng.PRNGKey(0), 0)
    row = torch.from_numpy(seeds.astype(np.int32))
    sub_c = pipeline.sample_subgraph(csc_c, row, (25, 10), key, cfg)
    sub_g = pipeline.sample_subgraph(csc_g, row.to(dev), (25, 10), key, cfg)
    for a, b, what in ((sub_g.csc.ptr, sub_c.csc.ptr, "ptr"),
                       (sub_g.csc.idx, sub_c.csc.idx, "idx"),
                       (sub_g.order, sub_c.order, "order")):
        check(torch.equal(a.cpu(), b),
              f"{tag} small subgraph {what}: card == CPU")
    with torch.no_grad():
        lc = model(subgraph_batch(sub_c, feats))
        lg = model.to(dev)(subgraph_batch(sub_g, feats.to(dev)))
    err = float((lg.cpu() - lc).abs().max())
    tol = SMALL_LOGIT_TOL * max(1.0, float(lc.abs().max()))
    extra[f"{tag}_small_logit_max_abs_err"] = err
    check(err <= tol, f"{tag} small logits card vs CPU within {tol:.3g} "
          f"(max err {err})")
    check(bool(torch.isfinite(lg).all()), f"{tag} finite logits")


# ------------------------------------------------------------- phases 6-7
def merge_path(dev, seed, n_requests, csc, feats):
    """Launch counters to 0, the MERGE_CFG convert at Reddit scale, then the
    slice path's requests served under MERGE_CFG with use_pallas_agg on
    the slice path's CSC (same weights), counters read."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.graphsage_reddit import config
    from repro_torch.core import pipeline
    from repro_torch.core.graph import synthetic_coo
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import MERGE_CFG
    from repro_torch.models.gnn import GraphSAGE
    from repro_torch.serve import GnnServeEngine

    out = {}
    coo = synthetic_coo(REDDIT["nodes"], REDDIT["edges"], MERGE_CONVERT_CAP,
                        seed + 5, device=dev)
    model = GraphSAGE(dataclasses.replace(config(), use_pallas_agg=True),
                      d_in=REDDIT["feats"], n_classes=REDDIT["classes"],
                      generator=torch.Generator().manual_seed(seed + 2),
                      device=dev)
    torch.cuda.synchronize()

    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    csc_m = pipeline.convert(coo, MERGE_CFG, device=dev)
    torch.cuda.synchronize()
    out["convert_s"] = time.perf_counter() - t0
    out["convert_launches"] = launch_counts()

    eng = GnnServeEngine(model, csc, feats, n_slots=N_SLOTS,
                         seed_cap=SEED_CAP, cfg=MERGE_CFG, device=dev)
    rng = np.random.default_rng(seed)  # the slice path's requests and ids
    eng.submit(rng.choice(REDDIT["nodes"], 16, replace=False).tolist())
    eng.close_submissions()
    eng.run()  # warm-up request: the step's eager first run, its capture
    torch.cuda.synchronize()
    out["step_programs_after_warmup"] = eng.step_cache_size()
    eng.reopen()
    reqs = [rng.choice(REDDIT["nodes"], int(k), replace=False).tolist()
            for k in rng.integers(1, SEED_CAP + 1, n_requests)]
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    counted, handles = serve_run(eng, reqs, traced=True)
    out.update(counted)
    out.update(serve_run(eng, reqs)[0])
    out["peak_mem_gib"] = max(out["peak_mem_gib"], out["serve_peak_mem_gib"])
    return out, coo, csc_m, eng, reqs, handles


def merge_checks(dev, seed, coo, csc_m, eng, reqs, handles, eng_s, extra):
    """The merge path held against the torch.sort convert, its own
    sequential loop, the slice path's subgraphs and logits, and the CPU."""
    import dataclasses
    import torch
    from repro_torch.configs.graphsage_reddit import smoke_config
    from repro_torch.core import pipeline
    from repro_torch.core.costmodel import EngineConfig
    from repro_torch.core.set_count import count_less_than
    from repro_torch.kernels import _build
    from repro_torch.kernels import set_count as tsc
    from repro_torch.launch.serve import MERGE_CFG, SLICE_CFG
    from repro_torch.models.gnn import subgraph_batch

    # (a) the Reddit-scale convert == the torch.sort strategy on the COO
    t0 = time.perf_counter()
    ref = pipeline.convert(coo, EngineConfig(sort_strategy="xla_sort",
                                             reindex_strategy="fused"),
                           device=dev)
    torch.cuda.synchronize()
    extra["merge_convert_torch_sort_s"] = time.perf_counter() - t0
    check(torch.equal(csc_m.ptr, ref.ptr) and torch.equal(csc_m.idx, ref.idx),
          "merge convert (Reddit scale) == torch.sort strategy")
    check(int(csc_m.ptr[-1]) == REDDIT["edges"], "merge ptr[-1] == edges")

    # (a2) the convert's set count on its own shape: the sorted dst, then
    # shuffled, against searchsorted and the twin on every
    # CONVERT_TWIN_STRIDE-th target
    sdst = torch.sort(coo.dst).values  # the SENTINEL padding sorts last
    del ref
    targets = torch.arange(REDDIT["nodes"] + 1, dtype=torch.int32,
                           device=dev)
    rank = torch.searchsorted(sdst, targets, out_int32=True)
    sample = torch.cat([targets[::CONVERT_TWIN_STRIDE], targets[-1:]])
    g = torch.Generator(device=dev).manual_seed(seed + 6)
    for shuffled in (False, True):
        el = sdst[torch.randperm(sdst.shape[0], generator=g, device=dev)] \
            if shuffled else sdst
        got = tsc.set_count_less(el, targets)
        again = tsc.set_count_less(el, targets)
        twin = count_less_than(el, sample)
        torch.cuda.synchronize()
        check(torch.equal(got, rank) and torch.equal(got, again)
              and torch.equal(got[sample.long()], twin),
              f"set_count_less at the convert shape (shuffled={shuffled}) =="
              f" searchsorted, == the twin on {sample.numel()} targets, "
              "same bits twice")
        r = set_count_readings(el, targets, rank, iters=5)
        for k in ("ms", "sort_ms", "count_ms", "compares", "sort_compares",
                  "count_compares", "bisections", "tile_copies"):
            extra[f"set_count_convert_{'shuffled' if shuffled else 'sorted'}"
                  f"_{k}"] = r[k]
        del el, got, again
    extra["set_count_convert_searchsorted_ms"] = cuda_ms(
        lambda: torch.searchsorted(sdst, targets), iters=5)
    del sdst, rank

    # (b) batched == sequential
    batched_equals_sequential(eng, reqs, handles, "merge")

    # (c) four requests: the same subgraph as SLICE_CFG samples, and the
    # slice path's logits bit for bit: the segment sum sums the spans it
    # finds in edge_dst with the span sum's body, in the span sum's order
    big = sorted(range(len(reqs)), key=lambda i: -len(reqs[i]))[:4]
    errs = []
    for i in big:
        row, key = seed_row(eng, reqs[i]), eng.request_key(handles[i].rid)
        check(key == eng_s.request_key(handles[i].rid), "same request key")
        sub_m = pipeline.sample_subgraph(eng.params["csc"], row, eng.fanouts,
                                         key, MERGE_CFG)
        sub_s = pipeline.sample_subgraph(eng_s.params["csc"], row,
                                         eng_s.fanouts, key, SLICE_CFG)
        for a, b, what in ((sub_m.order, sub_s.order, "order"),
                           (sub_m.csc.ptr, sub_s.csc.ptr, "ptr"),
                           (sub_m.csc.idx, sub_s.csc.idx, "idx")):
            check(torch.equal(a, b), f"merge subgraph {what} == slice "
                  f"(request {handles[i].rid})")
        batch = subgraph_batch(sub_m, eng.params["features"])
        with torch.no_grad():
            lm = eng.params["gnn"](batch)
            ls = eng_s.params["gnn"](batch)
        err = float((lm - ls).abs().max())
        errs.append(err)
        check(torch.equal(lm, ls), f"merge logits == slice logits, bit for "
              f"bit (request {handles[i].rid}: max abs diff {err})")
    extra["merge_vs_slice_logit_max_abs_err"] = max(errs)

    # (d) a small graph under MERGE_CFG on the card equals the CPU path
    small_graph_check(dev, seed, MERGE_CFG,
                      dataclasses.replace(smoke_config(), use_pallas_agg=True),
                      extra, "merge")


# ------------------------------------------------------------- phases 7b-7d
# the slice-13 paths on the Reddit CSC, at the reference's minibatch_lg
# fanout: the three other GNN families served at their published widths
# (GatedGCN also under MERGE_CFG with use_pallas_agg), graphsage-reddit
# served under keysort selection, reservoir selection run eagerly, and a
# stream of queries and graph updates through one captured step
FAMILY_FANOUTS = (15, 10)
# (graphsage-reddit at this fanout too: Floyd's side of keysort's step)
FAMILIES = (("graphsage-reddit", "slice"), ("gat-cora", "slice"),
            ("gatedgcn", "slice"), ("gatedgcn", "merge"),
            ("meshgraphnet", "slice"))
# pointer or segment sums of one request's forward: GAT a softmax
# denominator and an aggregation a layer, GatedGCN a numerator and a
# denominator a layer, MeshGraphNet an aggregation a layer, GraphSAGE a
# mean a layer (the gather and the degrees folded into the span sum)
FAMILY_SUMS = {"gat-cora": 4, "gatedgcn": 32, "meshgraphnet": 15,
               "graphsage-reddit": 2}
HOST_CHECKED = 4  # requests whose subgraphs are held against the host's
RESERVOIR_REQUESTS = 4
# the update stream: every UPDATE_EVERY-th of UPDATE_ITEMS items is an
# update of UPDATE_EDGES inserts and as many deletes of existing edges
UPDATE_ITEMS, UPDATE_EVERY, UPDATE_EDGES = 12, 3, 4096


def family_path(dev, seed, arch, which, csc, feats, n_requests,
                selection="floyd"):
    """Launch counters to 0; ``arch`` at its published width (602
    features in, 41 classes out, random weights from ``--seed``) served on
    the Reddit CSC under ``which``'s engine configuration
    (``launch/serve.ENGINE_CFGS``, with its use_pallas_agg) and
    ``selection``, on FAMILY_FANOUTS with SEED_CAP seeds and N_SLOTS
    slots: a warm-up request (the step's eager first run, its capture),
    then ``n_requests`` requests of 1..SEED_CAP seeds twice, traced (the
    counted run) and timed; counters read. Returns the readings, the
    engine, the requests and their handles."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.launch.serve import ENGINE_CFGS
    from repro_torch.models.gnn import gnn_model
    from repro_torch.serve import GnnServeEngine

    engine_cfg, agg = ENGINE_CFGS[which]
    engine_cfg = dataclasses.replace(engine_cfg, selection=selection)
    gcfg = dataclasses.replace(get_config(arch), use_pallas_agg=agg)
    model = gnn_model(gcfg, d_in=REDDIT["feats"], n_classes=REDDIT["classes"],
                      generator=torch.Generator().manual_seed(seed + 2),
                      device=dev)
    out = dict(arch=arch, engine_cfg=engine_cfg.key,
               params=sum(p.numel() for p in model.parameters()))
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    eng = GnnServeEngine(model, csc, feats, fanouts=FAMILY_FANOUTS,
                         n_slots=N_SLOTS, seed_cap=SEED_CAP, cfg=engine_cfg,
                         device=dev)
    rng = np.random.default_rng(seed + 13)
    eng.submit(rng.choice(REDDIT["nodes"], 16, replace=False).tolist())
    eng.close_submissions()
    eng.run()  # warm-up request: the step's eager first run, its capture
    torch.cuda.synchronize()
    out["step_programs_after_warmup"] = eng.step_cache_size()
    eng.reopen()
    reqs = [rng.choice(REDDIT["nodes"], int(k), replace=False).tolist()
            for k in rng.integers(1, SEED_CAP + 1, n_requests)]
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    counted, handles = serve_run(eng, reqs, traced=True)
    out.update(counted)
    out.update(serve_run(eng, reqs)[0])
    out["peak_mem_gib"] = max(out["peak_mem_gib"], out["serve_peak_mem_gib"])
    return out, eng, reqs, handles


def seg_sum_reading(dst, x, n, rows=None, mean=False, timed=True):
    """The segment-sum kernel on one call's (dst, x, rows, mean) against
    its twin (the unfused composition: the gather, the float64 sum rounded
    once, the degrees, the division) within ``segment_agg.twin_tolerance``
    (derived from float32 rounding), the same bits on two launches, and
    the pointer segment sum's bits on the same spans (``ptr_seg_sum`` over
    ``searchsorted(dst, arange(n + 1))``: one span-sum body); ``timed``:
    the kernel, the twin, ``index_add_`` (the library yardstick, on the
    gathered stream when ``rows`` is given, the gather and the division
    untimed) and the bound for this data (the live dst entries, the live
    rows the spans name, the distinct ones through ``rows`` and the
    index, read once; the output written once)."""
    import torch
    from repro_torch.kernels import ptr_scan
    from repro_torch.kernels import segment_agg as tsa

    e, d = dst.shape[0], x.shape[1]

    def kernel():
        return tsa.segment_sum_sorted(dst, x, n, rows, mean)
    got, again = kernel(), kernel()
    want = tsa._segment_twin(dst, x, n, rows, mean)
    tol = tsa.twin_tolerance(dst, x, n, rows, mean)
    ptr = torch.searchsorted(dst, torch.arange(n + 1, dtype=torch.int32,
                                               device=dst.device),
                             out_int32=True)
    spans = ptr_scan.ptr_seg_sum(ptr, x, rows, mean)
    err = (got.double() - want.double()).abs()
    share = float((err / tol.clamp_min(1e-300)).max()) if err.numel() else 0.0
    what = (f"segment_sum_sorted [{e}, {d}]" + (" through rows" if rows
                                                is not None else "")
            + (", mean" if mean else ""))
    check(bool((err <= tol).all()) and torch.equal(got, again),
          f"{what} within its tolerance of the twin (worst {share:.3f} of "
          "it) and the same bits twice")
    check(torch.equal(got, spans), f"{what}: the bits of ptr_seg_sum on the "
          "same spans")
    r = dict(max_abs_err=float(err.max()) if err.numel() else 0.0,
             share_of_tolerance=share, equals_ptr_seg_sum=True,
             shape=f"[{e}, {d}] -> [{n}, {d}]"
             + (f", x [{x.shape[0]}, {d}] through rows" if rows is not None
                else "") + (", mean" if mean else ""))
    if timed:
        live = int((dst < n).sum())
        msgs = x if rows is None else x.index_select(
            0, rows.clamp(0, x.shape[0] - 1))
        read = live * d if rows is None else (int(torch.unique(
            rows[:live].clamp(0, x.shape[0] - 1)).numel()) * d + live)
        r["bound_ms"], r["bound_by"] = bound(4 * (live + read + n * d),
                                             live * d + (n * d if mean
                                                         else 0))
        dst_lib = torch.clamp(dst, max=n).to(torch.int64)
        r.update(ms=cuda_ms(kernel),
                 plain_ms=cuda_ms(lambda: tsa._segment_twin(
                     dst, x, n, rows, mean), iters=5),
                 library_ms=cuda_ms(lambda: torch.zeros(
                     (n + 1, d), device=x.device).index_add_(0, dst_lib,
                                                             msgs)),
                 rows_read=live)
        del msgs
    del got, again, want, tol, err, ptr, spans
    return r


def seg_sum_row(r, what):
    """A kernel-table row of ``segment_sum_sorted`` from a timed
    ``seg_sum_reading``."""
    return dict(name="segment_sum_sorted", route="cuda",
                source="src/repro_torch/csrc/segment_agg.cu",
                replaces="src/repro/kernels/segment_agg.py:63",
                **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")},
                shape=f"{what}: {r['shape']} (error against the twin, "
                      f"{r['share_of_tolerance']:.3f} of twin_tolerance; "
                      "library: index_add_ on the (gathered) stream)")


def merge_sum_phase(eng, seeds, rid):
    """The segment sum on copies of the two calls one MERGE_CFG GraphSAGE
    request (``slot_fn`` on ``seeds``, eager) makes to
    ``segment_sum_padded``: per layer the node states, read through the
    edge sources, with the mean (the gather and the degrees folded in),
    each held by ``seg_sum_reading`` and timed. Returns the kernel's row
    (the request's layer 1) and both readings."""
    import torch
    from repro_torch.kernels import segment_agg as tsa

    calls = recorded_calls(eng, seeds, rid, tsa, "segment_sum_padded")
    check(len(calls) == MERGE_SUMS
          and [c[1].shape[1] for c in calls] == [REDDIT["feats"], 128]
          and all(len(c) == 5 and c[3] is not None and c[4] is True
                  for c in calls),
          f"a MERGE_CFG request hands the segment sum {MERGE_SUMS} calls, "
          f"each through the edge sources with the mean: "
          f"{[(tuple(c[1].shape), len(c)) for c in calls]}")
    readings = {}
    for layer, (dst, x, n, rows, mean) in zip(("layer1", "layer2"), calls):
        readings[layer] = seg_sum_reading(dst, x, n, rows, mean)
        log(f"[merge sums] {layer}: {readings[layer]}")
    del calls
    torch.cuda.empty_cache()
    return seg_sum_row(readings["layer1"], "a MERGE_CFG request's layer-1 "
                       f"call, the path's own arrays; launches a lane: "
                       f"{MERGE_SUMS}"), readings


def family_sum_readings(tag, eng, seeds, rid):
    """Every pointer (span-sum) and segment-sum call of one request of
    the family's forward, recorded, each held against its twin within its
    derived tolerance; the first call of each width timed. Returns
    {call: reading}."""
    import torch
    from repro_torch.kernels import segment_agg as tsa
    from repro_torch.models import gnn as tgnn

    scans = recorded_calls(eng, seeds, rid, tgnn, "ptr_seg_sum")
    sums = recorded_calls(eng, seeds, rid, tsa, "segment_sum_padded")
    out, widths = {}, set()
    for i, call in enumerate(scans):
        d = call[1].shape[1]
        out[f"scan{i}_d{d}"] = scan_reading(*call,
                                            timed=("scan", d) not in widths)
        widths.add(("scan", d))
    for i, (dst, msgs, n, *rest) in enumerate(sums):
        d = msgs.shape[1]
        out[f"segsum{i}_d{d}"] = seg_sum_reading(
            dst.contiguous(), msgs.to(torch.float32).contiguous(), n, *rest,
            timed=("segsum", d) not in widths)
        widths.add(("segsum", d))
    del scans, sums
    torch.cuda.empty_cache()
    for key, r in out.items():
        if "ms" in r:
            log(f"[{tag} sums] {key}: {r}")
    return out


def family_checks(dev, seed, tag, arch, which, eng, out, reqs, handles,
                  extra):
    """One family's served run held: one step program, the counters
    against a trace (``serve_launch_checks``), a lane's pointer or segment
    sums, batched == sequential, finite logits of the expected shape for
    the largest request, the sums of that request against their twins,
    a small graph under the same routing card == CPU, and one replayed
    step profiled (``step_profile``)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import pipeline
    from repro_torch.launch.serve import ENGINE_CFGS
    from repro_torch.models.gnn import subgraph_batch

    lane = serve_launch_checks(tag, eng, out, reqs, handles)
    kernel = "segment_sum_sorted" if which == "merge" else "ptr_seg_sum"
    check(lane.get(kernel, 0) == FAMILY_SUMS[arch],
          f"{tag}: a lane runs {FAMILY_SUMS[arch]} {kernel} launches: {lane}")
    batched_equals_sequential(eng, reqs, handles, tag)
    big = max(range(len(reqs)), key=lambda i: len(reqs[i]))
    with torch.inference_mode():
        sub = pipeline.sample_subgraph(
            eng.params["csc"], seed_row(eng, reqs[big]), eng.fanouts,
            eng.request_key(handles[big].rid), eng.engine_cfg)
        logits = eng.params["gnn"](subgraph_batch(sub,
                                                  eng.params["features"]))
    check(tuple(logits.shape) == (sub.order.shape[0], REDDIT["classes"])
          and bool(torch.isfinite(logits).all()),
          f"{tag}: finite logits [{sub.order.shape[0]}, {REDDIT['classes']}]"
          f" for the largest request: {tuple(logits.shape)}")
    out["largest_logit_abs_max"] = float(logits.abs().max())
    del sub, logits
    out["sums"] = family_sum_readings(tag, eng, reqs[big], handles[big].rid)
    small_graph_check(dev, seed, eng.engine_cfg, dataclasses.replace(
        get_config(arch, smoke=True), use_pallas_agg=ENGINE_CFGS[which][1]),
        extra, tag)
    out["step_profile"] = step_profile(eng, reqs, handles, out["lane_trace"])
    return lane


def host_csc(csc):
    """The card's CSC copied to the host."""
    from repro_torch.core.graph import CSC
    return CSC(csc.ptr.cpu(), csc.idx.cpu(), csc.n_edges.cpu(), csc.n_nodes)


def same_as_host(tag, csc, csc_h, seeds, key, cfg):
    """One request's subgraph sampled on the card equals, bit for bit, the
    same sampling run on the host from the card's CSC copied over."""
    import torch
    from repro_torch.core import pipeline
    row = padded_row(seeds)
    got = pipeline.sample_subgraph(csc, row.to(csc.idx.device),
                                   FAMILY_FANOUTS, key, cfg)
    want = pipeline.sample_subgraph(csc_h, row, FAMILY_FANOUTS, key, cfg)
    for a, b, what in ((got.csc.ptr, want.csc.ptr, "ptr"),
                       (got.csc.idx, want.csc.idx, "idx"),
                       (got.order, want.order, "order"),
                       (got.csc.n_edges, want.csc.n_edges, "n_edges")):
        check(torch.equal(a.cpu(), b), f"{tag}: subgraph {what} card == host")
    return int(want.n_sub_nodes)


def selection_phase(dev, seed, csc, csc_h):
    """Reservoir selection (the reference's baseline, a sequential step a
    neighbour slot of the window: run eagerly, not captured) under
    SLICE_CFG: launch counters to 0, RESERVOIR_REQUESTS requests sampled
    on the card, counters read, each subgraph equal to the host's; then
    one request of SEED_CAP seeds sampled under each selection, wall
    seconds (median of 3, synchronised)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import pipeline, prng
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import SLICE_CFG

    rng = np.random.default_rng(seed + 17)
    cfg = dataclasses.replace(SLICE_CFG, selection="reservoir")
    reqs = [rng.choice(REDDIT["nodes"], int(k), replace=False).tolist()
            for k in rng.integers(1, SEED_CAP + 1, RESERVOIR_REQUESTS)]
    keys = [prng.fold_in(prng.PRNGKey(seed), 100 + i)
            for i in range(len(reqs))]
    reset_launch_counts()
    for seeds, key in zip(reqs, keys):
        pipeline.sample_subgraph(csc, padded_row(seeds).to(dev),
                                 FAMILY_FANOUTS, key, cfg)
    torch.cuda.synchronize()
    out = dict(launches=launch_counts(), seeds=[len(r) for r in reqs])
    out["sub_nodes"] = [same_as_host("reservoir", csc, csc_h, seeds, key,
                                     cfg) for seeds, key in zip(reqs, keys)]
    full = torch.from_numpy(rng.choice(REDDIT["nodes"], SEED_CAP,
                                       replace=False).astype(np.int32))
    out["sample_s"] = {
        sel: wall_s(lambda: pipeline.sample_subgraph(
            csc, full.to(dev), FAMILY_FANOUTS, keys[0],
            dataclasses.replace(SLICE_CFG, selection=sel)), dev)
        for sel in ("floyd", "keysort", "reservoir")}
    return out


def keysort_checks(eng, reqs, handles, csc_h):
    """The keysort-served requests: HOST_CHECKED of them sampled again on
    the card equal the host's sampling of the card's CSC."""
    return [same_as_host("keysort", eng.params["csc"], csc_h, seeds,
                         eng.request_key(h.rid), eng.engine_cfg)
            for seeds, h in zip(reqs[:HOST_CHECKED], handles[:HOST_CHECKED])]


def existing_edges(csc, rng, k):
    """``k`` edges of the graph (uniform positions of its live index
    slots) as host (dst, src) arrays: src from ``idx``, dst the node whose
    pointer span holds the position."""
    import numpy as np
    import torch
    pos = torch.from_numpy(rng.integers(0, int(csc.n_edges), k).astype(
        np.int32)).to(csc.idx.device)
    src = csc.idx[pos.to(torch.int64)]
    dst = torch.searchsorted(csc.ptr, pos, right=True) - 1
    return dst.to(torch.int32).cpu().numpy(), src.cpu().numpy()


def update_phase(dev, seed, csc, feats):
    """A stream of UPDATE_ITEMS items on the Reddit CSC under SLICE_CFG
    (graphsage-reddit at full width, FAMILY_FANOUTS, SEED_CAP, N_SLOTS,
    ``delta_cap`` UPDATE_EDGES): every UPDATE_EVERY-th item an update of
    UPDATE_EDGES inserts and as many deletes of existing edges, the rest
    queries of 1..SEED_CAP seeds. The oracle chains ``apply_delta_jit``
    over the stream first; then launch counters to 0, an engine, a
    warm-up query (its capture), the stream submitted at once and served,
    counters read. Checked: every prediction equals the eager ``slot_fn``
    on the oracle's graph at the query's place in the stream; updates
    finish with no predictions; the engine's final CSC equals the
    oracle's bit for bit; one step program; every bound tensor at its
    address. Read: each update's latency from submit to finish and the
    host time of its apply."""
    import numpy as np
    import torch
    from repro_torch.configs.graphsage_reddit import config
    from repro_torch.core.delta import EdgeDelta
    from repro_torch.engine.service import apply_delta_jit
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import SLICE_CFG
    from repro_torch.models.gnn import gnn_model
    from repro_torch.serve import GnnServeEngine

    n = REDDIT["nodes"]
    cap = int(csc.idx.shape[0])
    rng = np.random.default_rng(seed + 19)
    stream, cur = [], csc
    t0 = time.perf_counter()
    for i in range(UPDATE_ITEMS):
        if i % UPDATE_EVERY == UPDATE_EVERY - 1:
            dels = existing_edges(cur, rng, UPDATE_EDGES)
            ins = (rng.integers(0, n, UPDATE_EDGES).astype(np.int32),
                   rng.integers(0, n, UPDATE_EDGES).astype(np.int32))
            delta = EdgeDelta.from_arrays(*ins, *dels, n_nodes=n,
                                          capacity=UPDATE_EDGES, device=dev)
            cur = apply_delta_jit(cur, delta, cfg=SLICE_CFG,
                                  out_capacity=cap)
            stream.append(("u", ins, dels))
        else:
            seeds = rng.choice(n, int(rng.integers(1, SEED_CAP + 1)),
                               replace=False).tolist()
            stream.append(("q", seeds, cur))
    torch.cuda.synchronize()
    out = dict(oracle_s=time.perf_counter() - t0)

    model = gnn_model(config(), d_in=REDDIT["feats"],
                      n_classes=REDDIT["classes"],
                      generator=torch.Generator().manual_seed(seed + 2),
                      device=dev)
    reset_launch_counts()
    eng = GnnServeEngine(model, csc, feats, fanouts=FAMILY_FANOUTS,
                         n_slots=N_SLOTS, seed_cap=SEED_CAP, cfg=SLICE_CFG,
                         device=dev, delta_cap=UPDATE_EDGES)
    warm = rng.choice(n, 16, replace=False).tolist()
    eng.submit(warm)
    eng.close_submissions()
    eng.run()
    torch.cuda.synchronize()
    eng.reopen()
    bound = eng._bindings()
    handles = []
    t0 = time.perf_counter()
    for item in stream:
        if item[0] == "q":
            handles.append(eng.submit(item[1]))
        else:
            _, ins, dels = item
            handles.append(eng.submit_update(zip(*ins), zip(*dels)))
    eng.close_submissions()
    done = eng.run()
    torch.cuda.synchronize()
    out["stream_s"] = time.perf_counter() - t0
    out["launches"] = launch_counts()
    check(len(done) == len(stream), "every item of the stream finished")
    check(eng.step_cache_size() == 1 and eng._bindings() == bound,
          f"one step program ({eng.step_cache_size()}) and every bound "
          "tensor at its address across the updates")
    fin = eng.params["csc"]
    check(torch.equal(fin.ptr, cur.ptr) and torch.equal(fin.idx, cur.idx)
          and int(fin.n_edges) == int(cur.n_edges),
          "the engine's CSC after the stream == the oracle's chain")
    for h, item in zip(handles, stream):
        if item[0] == "u":
            check(h.tokens_out == [], f"update {h.rid} emits nothing")
            continue
        seeds, graph = item[1], item[2]
        bundle = {**eng.params, "csc": graph}
        seq = eng.slot_fn(bundle, seed_row(eng, seeds),
                          eng.request_key(h.rid))
        check(h.tokens_out == seq[:len(seeds)].tolist(),
              f"query {h.rid} == the eager slot_fn on the graph at its place "
              "in the stream")
    ups = [h for h, item in zip(handles, stream) if item[0] == "u"]
    out.update(
        updates=len(ups), queries=len(stream) - len(ups),
        steps=eng.stats.steps, n_edges_after=int(fin.n_edges),
        update_latency_ms=[h.total_latency_s * 1e3 for h in ups],
        update_apply_host_ms=[(h.finish_t - h.admit_t) * 1e3 for h in ups],
        query_latency_ms=[h.total_latency_s * 1e3 for h, item
                          in zip(handles, stream) if item[0] == "q"])
    del eng, stream, cur
    return out


# ------------------------------------------------------------- phase 7e
# GNN training: run_gnn's steps at full width (ckpt_every max(12 // 4, 10)
# = 10), the crash that resumes from the step-10 checkpoint, the steady
# steps timed after two warm-up steps, and the other families' steps
GNN_TRAIN_STEPS, GNN_TRAIN_FAIL_AT, GNN_TRAIN_TIMED = 12, 11, 8
GNN_TRAIN_FAMILIES, GNN_FAMILY_STEPS = ("gat-cora", "gatedgcn",
                                        "meshgraphnet"), 2
# span-sum launches of a GraphSAGE training step: one a layer forward; one
# backward, layer 2's (layer 1 reads the feature batch, which needs none)
GNN_STEP_SUMS = {"forward": 2, "backward": 1}
# what the model's step must not run: index_add_'s kernels (indexFunc*),
# scatter kernels, index_put's, and host ops of the same. torch's gather
# and scatter share one kernel (_scatter_gather_elementwise_kernel): the
# ops that launch a kernel so named must all be gathers
GNN_STEP_KERNEL_RE = r"span_sum_kernel|indexFunc\w*|\w*[Ss]catter\w*|index_put\w*"
GNN_SCATTER_OP_RE = (r"^aten::(?:index_add|scatter|scatter_add|scatter_reduce|"
                     r"index_put)_?$")
GNN_GATHER_OP_RE = r"^aten::(?:gather|index_select|take|take_along_dim)$"
# a float32 step's gradients against the float64 twins, per parameter, as
# a share of the twin gradient's largest |value| (at least GNN_GRAD_FLOOR
# of the largest over all parameters: a gradient the math makes zero, as
# GAT's a_dst, is rounding noise in both). float32 rounds each operation
# by at most u = 2^-24 of its result; a gradient here ends a chain of
# 2 L sums (forward and backward through L layers) of up to 2^19 terms,
# whose roundings add like a random walk, about sqrt(2^19) u = 4.3e-5 of
# the terms' magnitude a sum (cuBLAS's long K, the span sums' pieces):
# 2 L sums give 1.7e-4 at L = 2 and 1.4e-3 at L = 16. Terms that cancel
# make a gradient smaller than its terms: GNN_GRAD_TOL allows a factor of
# 20 at L = 2 (GraphSAGE, GAT) and 2.5 at L = 16, 15 (GatedGCN,
# MeshGraphNet), where the tolerance is the deeper chain's 2^-6 share
GNN_GRAD_TOL = {2: 2 ** -8, 16: 2 ** -6, 15: 2 ** -6}
GNN_GRAD_FLOOR = 1e-4


def gnn_loss64(model, batch):
    """``gnn_loss`` in float64 (the port's casts the logits to float32):
    classification's cross entropy or MeshGraphNet's squared error, over
    the masked-in rows."""
    import torch
    out = model(batch).to(torch.float64)
    m = batch.label_mask.to(torch.float64)
    if model.cfg.kind == "meshgraphnet":
        err = out - batch.labels.to(torch.float64)
        return torch.sum(err * err * m[:, None]) / torch.clamp(m.sum(), min=1)
    ll = out.gather(-1, batch.labels.to(torch.int64)[:, None])[:, 0]
    nll = torch.logsumexp(out, -1) - ll
    return torch.sum(nll * m) / torch.clamp(m.sum(), min=1.0)


def _plain64_seg_sum(ptr, x, rows=None, mean=False, batch=None):
    """models.gnn's ``_ptr_seg_sum`` as its float64 plain twin under
    autograd (``cumsum`` and ``index_select`` after the gather: backward
    by ``index_add_``)."""
    import torch
    from repro_torch.kernels import ptr_scan
    flat = x.reshape(x.shape[0], -1)
    p = torch.clamp(ptr, 0, x.shape[0] if rows is None else rows.shape[0])
    seg = ptr_scan._ptr_seg_sum_plain(p, flat, rows, mean)
    return seg.reshape((p.shape[0] - 1,) + x.shape[1:])


def gnn_grads(model, batch, loss_fn, seg_fn):
    """(loss, {name: float64 gradient}, the gradient into every node-state
    tensor a fused sum reads through the edge sources that needs one (for
    GraphSAGE: layer 1's output)), with ``models.gnn._ptr_seg_sum``
    swapped for ``seg_fn`` while the loss is computed."""
    import torch
    from repro_torch.models import gnn as tgnn
    states = []

    def recording(ptr, x, rows=None, mean=False, batch=None):
        if rows is not None and x.requires_grad:
            x.retain_grad()
            states.append(x)
        return seg_fn(ptr, x, rows, mean, batch)
    for p in model.parameters():
        p.grad = None
    real = tgnn._ptr_seg_sum
    tgnn._ptr_seg_sum = recording
    try:
        loss = loss_fn(model, batch)
    finally:
        tgnn._ptr_seg_sum = real
    loss.backward()
    torch.cuda.synchronize()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)
                 ).detach().to(torch.float64)
             for n, p in model.named_parameters()}
    return float(loss.detach()), grads, [s.grad.detach().to(torch.float64)
                                for s in states]


def gnn_twin_check(tag, model, batch):
    """Every parameter gradient of one batch through the kernels (float32,
    the transposed layout) against the float64 twins on the card (the
    same parameters in float64, ``_plain64_seg_sum`` and ``take`` /
    ``index_add_`` without the layout, ``gnn_loss64``), within
    GNN_GRAD_TOL; the same for the gradient into layer 1's output
    (GraphSAGE), which must not be zero. Returns the readings."""
    import copy
    import dataclasses
    import torch
    from repro_torch.models import gnn as tgnn
    loss, got, got_h = gnn_grads(model, batch, tgnn.gnn_loss,
                                 tgnn._ptr_seg_sum)
    twin = copy.deepcopy(model).double()
    twin.cfg = dataclasses.replace(model.cfg, dtype=torch.float64)
    b64 = dataclasses.replace(
        batch, node_feat=batch.node_feat.double(), rev_perm=None,
        rev_ptr=None, labels=(batch.labels.double()
                              if batch.labels.is_floating_point()
                              else batch.labels))
    loss64, want, want_h = gnn_grads(twin, b64, gnn_loss64,
                                     _plain64_seg_sum)
    tol = GNN_GRAD_TOL[model.cfg.n_layers]
    top = max(float(w.abs().max()) for w in want.values())
    worst, worst_name = 0.0, None
    for n, w in want.items():
        scale = max(float(w.abs().max()), GNN_GRAD_FLOOR * top)
        ratio = float((got[n] - w).abs().max()) / (tol * scale)
        if ratio > worst:
            worst, worst_name = ratio, n
    check(worst <= 1.0, f"{tag}: every gradient within {tol} of the float64 "
          f"twins' (worst {worst:.3f} of it, {worst_name})")
    check(abs(loss - loss64) <= tol * max(1.0, abs(loss64)),
          f"{tag}: loss {loss} against the twins' {loss64}")
    r = dict(loss=loss, loss64=loss64, tol=tol, worst_share=worst,
             worst_param=worst_name)
    check(len(got_h) == len(want_h), f"{tag}: the same states recorded")
    for i, (g, w) in enumerate(zip(got_h, want_h)):
        gmax = float(g.abs().max())
        share = float((g - w).abs().max()) / (tol * float(w.abs().max()))
        check(gmax > 0 and share <= 1.0,
              f"{tag}: the gradient into layer {i + 1}'s output is non-zero "
              f"({gmax}) and within {tol} of the twins' ({share:.3f} of it)")
        r[f"layer{i + 1}_out_grad_abs_max"] = gmax
        r[f"layer{i + 1}_out_grad_share"] = share
    del twin, b64, got, want
    return r


def span_sum_backward_reading(model, batch):
    """The span sum's backward on one training batch's own arrays: the call
    layer 2's ``SpanSum`` makes (recorded by wrapping
    ``kernels.ptr_scan.ptr_seg_sum`` for one backward) held and timed as
    ``scan_reading`` holds the forward's, with ``index_add_`` of the
    gathered gradient into [N, D] as the library call (timed here, never
    called on the path)."""
    import torch
    from repro_torch.kernels import ptr_scan
    from repro_torch.models import gnn as tgnn
    calls = []
    real = ptr_scan.ptr_seg_sum

    def recording(*args):
        if torch.is_grad_enabled():  # a backward runs with grad off
            return real(*args)
        calls.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a
                           for a in args))
        return real(*args)
    loss = tgnn.gnn_loss(model, batch)
    # the wrapper stands in for the counted function: counts go on it
    recording.launches = real.launches
    ptr_scan.ptr_seg_sum = recording
    try:
        loss.backward()
        torch.cuda.synchronize()
    finally:
        ptr_scan.ptr_seg_sum = real
        real.launches = recording.launches
    for p in model.parameters():
        p.grad = None
    check(len(calls) == 1 and calls[0][2] is not None,
          f"one backward span sum, through rows: {len(calls)}")
    rev_ptr, g, rows = calls[0][:3]
    r = scan_reading(rev_ptr, g, rows)
    lim = int(rev_ptr[-1])
    n = rev_ptr.shape[0] - 1
    # the same sum by index_add_: the gathered gradient rows (in the
    # transposed order) added into each edge's source node
    src = torch.repeat_interleave(torch.arange(n, device=g.device),
                                  (rev_ptr[1:] - rev_ptr[:-1]).long())
    msgs = g.index_select(0, rows[:lim].long())

    def library():
        return torch.zeros((n, g.shape[1]), device=g.device).index_add_(
            0, src, msgs)
    want = real(rev_ptr, g, rows)
    check(bool((library() - want).abs().max() <= 1e-4 * max(
        1.0, float(want.abs().max()))), "index_add_ computes the same sum")
    r.update(library_ms=cuda_ms(library, iters=5),
             library="index_add_ of the gathered gradient into "
                     f"[{n}, {g.shape[1]}]")
    return r


def gnn_train_phase(dev, seed):
    """GNN training on the card (phase 7e): Reddit's synthetic graph built
    once on the host (timed); a SampledDataset at full size (its picked
    EngineConfig printed); one batch's launches and one graphsage-reddit
    step's (span sums 2 forward, 1 backward); every gradient against the
    float64 twins (``gnn_twin_check``); the backward span sum timed
    (``span_sum_backward_reading``); a profiled model step with no
    index_add_ or scatter; GNN_TRAIN_TIMED steady prefetched steps timed;
    ``run_gnn`` clean, crashed at GNN_TRAIN_FAIL_AT and resumed: the same
    bits; the smoke config's loss falls; each other family two steps at
    full width, twice, the same bits, and its gradients against the
    twins. Returns the readings; ``launches`` counts the whole phase."""
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.costmodel import Workload, resolve_sort_strategy
    from repro_torch.core.graph import COO, next_pow2
    from repro_torch.data.sampler import SampledDataset
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.steps import gnn_train_step
    from repro_torch.launch.train import (GNN_DATA, gnn_data,
                                          regression_targets, run_gnn)
    from repro_torch.models.gnn import gnn_loss, gnn_model
    from repro_torch.train.optim import AdamWConfig, adamw_init

    out = {}
    t0 = time.perf_counter()
    data = gnn_data(seed, False)
    out["dataset_host_s"] = time.perf_counter() - t0
    n_nodes, n_edges, d_feat, n_classes, batch_size = GNN_DATA[False]
    totals = dict.fromkeys(launch_counts(), 0)

    def add_counts():
        for k, v in launch_counts().items():
            totals[k] += v
        reset_launch_counts()

    def dataset(fanouts):
        dst, src, feats, labels = data
        return SampledDataset(
            coo=COO.from_arrays(dst, src, n_nodes, device=dev),
            features=torch.from_numpy(feats).to(dev),
            labels=torch.from_numpy(labels).to(dev), fanouts=fanouts,
            batch_size=batch_size, seed=seed)

    def model_of(arch):
        return gnn_model(get_config(arch), d_feat, d_edge=4,
                         n_classes=0 if arch == "meshgraphnet" else n_classes,
                         generator=torch.Generator().manual_seed(seed),
                         device=dev)

    reset_launch_counts()
    cfg = get_config("graphsage-reddit")
    t0 = time.perf_counter()
    ds = dataset(cfg.sample_sizes)
    sync(dev)
    out["dataset_device_s"] = time.perf_counter() - t0
    ec = ds.engine_cfg
    out["engine_cfg"] = ec.key
    f1, f2 = cfg.sample_sizes
    n_cap = batch_size * (1 + f1 + f1 * f2)
    out["sort_strategy"] = {
        "graph": resolve_sort_strategy(ec, Workload(n=n_nodes,
                                                    e=ds.coo.capacity)),
        "subgraph": resolve_sort_strategy(ec, Workload(
            n=n_cap, e=next_pow2(n_cap - batch_size)))}
    out["convert_launches"] = {k: v for k, v in launch_counts().items() if v}
    add_counts()
    batch = ds.batch(0)
    sync(dev)
    out["batch_launches"] = {k: v for k, v in launch_counts().items() if v}
    check(sum(out["batch_launches"].values()) > 0
          and "ptr_seg_sum" not in out["batch_launches"],
          f"a batch's sampling and transposed layout ran on the card's "
          f"kernels: {out['batch_launches']}")
    out["batch_shape"] = dict(nodes=batch.n_nodes,
                              edges=int(batch.edge_dst.shape[0]),
                              live_edges=int(batch.ptr[-1]))
    add_counts()

    # one step's span sums, forward and backward; the gradients
    model = model_of("graphsage-reddit")
    loss = gnn_loss(model, batch)
    sync(dev)
    fwd = launch_counts()
    add_counts()
    loss.backward()
    sync(dev)
    bwd = launch_counts()
    add_counts()
    out["step_launches"] = dict(
        forward={k: v for k, v in fwd.items() if v},
        backward={k: v for k, v in bwd.items() if v})
    check(fwd["ptr_seg_sum"] == GNN_STEP_SUMS["forward"]
          and bwd["ptr_seg_sum"] == GNN_STEP_SUMS["backward"]
          and sum(fwd.values()) + sum(bwd.values()) == sum(
              GNN_STEP_SUMS.values()),
          f"a graphsage step runs {GNN_STEP_SUMS} span sums and no other "
          f"kernel: {out['step_launches']}")
    for p in model.parameters():
        p.grad = None
    del loss
    out["twins"] = gnn_twin_check("graphsage-reddit", model, batch)
    out["span_sum_backward"] = span_sum_backward_reading(model, batch)
    add_counts()

    # a profiled model step: no index_add_, no scatter
    opt_cfg = AdamWConfig(lr=1e-3)
    opt = adamw_init(dict(model.named_parameters()))
    gnn_train_step(model, opt_cfg, opt, batch)
    add_counts()
    out["profile"] = dict(seeds=batch_size, **profile_call(
        lambda: gnn_train_step(model, opt_cfg, opt, batch), top=10,
        kernels=GNN_STEP_KERNEL_RE, ops=GNN_SCATTER_OP_RE,
        owners=GNN_STEP_KERNEL_RE))
    out["profile"]["launches"] = {k: v for k, v in launch_counts().items()
                                  if v}
    named = out["profile"]["kernels"]
    owners = out["profile"]["owners"]
    # the counters count the launches; the trace shows what else ran (a
    # trace can miss records: the host ops are recorded on the host)
    check(out["profile"]["launches"] == {
              "ptr_seg_sum": sum(GNN_STEP_SUMS.values())}
          and not out["profile"]["ops"]
          and all(k in owners and "indexFunc" not in k and "index_put" not in k
                  and all(re.search(GNN_GATHER_OP_RE, op) for op in owners[k])
                  for k in named if k != "span_sum_kernel"),
          f"the profiled model step launched {sum(GNN_STEP_SUMS.values())} "
          f"span sums ({out['profile']['launches']}), no index_add_ or "
          f"index_put kernel, no scatter op, and a scatter-named kernel only "
          f"from a gather: {named}, launched by {owners}; ops "
          f"{out['profile']['ops']}")
    out["iteration_profile"] = dict(seeds=batch_size, **profile_call(
        lambda: gnn_train_step(model, opt_cfg, opt, ds.batch(1)), top=10))
    add_counts()

    # steady steps, the batches prefetched on the side stream
    torch.cuda.reset_peak_memory_stats()
    losses = []
    with ds.iter_batches(start=2, stop=4 + GNN_TRAIN_TIMED) as it:
        for i, (_, b) in enumerate(it):
            if i == 2:
                sync(dev)
                t0 = time.perf_counter()
            losses.append(gnn_train_step(model, opt_cfg, opt, b)["loss"])
        sync(dev)
    step_s = (time.perf_counter() - t0) / GNN_TRAIN_TIMED
    out["timed"] = dict(
        step_s=step_s, seeds_per_s=batch_size / step_s,
        peak_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
        peak_reserved_gib=torch.cuda.max_memory_reserved() / 2**30,
        losses=[float(x) for x in losses])
    add_counts()
    del model, opt, batch, ds, losses
    gc.collect()
    torch.cuda.empty_cache()

    # run_gnn clean, crashed and resumed; the smoke config's loss falls
    root = tempfile.mkdtemp(prefix="gnn_train_")
    try:
        kw = dict(steps=GNN_TRAIN_STEPS, smoke=False, device=dev, data=data,
                  seed=seed, log_every=1)
        t0 = time.perf_counter()
        m1, _, h1 = run_gnn("graphsage-reddit", ckpt_dir=f"{root}/clean",
                            fail_at=None, **kw)
        sync(dev)
        out["run_gnn_clean_s"] = time.perf_counter() - t0
        crashed = False
        try:
            run_gnn("graphsage-reddit", ckpt_dir=f"{root}/crash",
                    fail_at=GNN_TRAIN_FAIL_AT, **kw)
        except RuntimeError as e:
            crashed = "injected failure" in str(e)
        check(crashed, f"run_gnn crashed at step {GNN_TRAIN_FAIL_AT}")
        m2, _, h2 = run_gnn("graphsage-reddit", ckpt_dir=f"{root}/crash",
                            fail_at=None, **kw)
        same = all(torch.equal(p, q) for p, q in zip(m1.parameters(),
                                                     m2.parameters()))
        at = max(GNN_TRAIN_STEPS // 4, 10)  # run_gnn's checkpoint interval
        check(same and h2 == h1[at:] and [h["step"] for h in h2] == list(
                  range(at, GNN_TRAIN_STEPS)),
              f"the resumed run's parameters and losses equal the clean "
              f"run's bit for bit: {h2} against {h1[at:]}")
        check(all(math.isfinite(h["loss"]) for h in h1),
              f"finite losses: {h1}")
        out["loss_curve"] = [h["loss"] for h in h1]
        out["resumed_losses"] = [h["loss"] for h in h2]
        del m1, m2
        _, _, hs = run_gnn("graphsage-reddit", GNN_TRAIN_STEPS, True,
                           f"{root}/smoke", None, seed=seed, device=dev,
                           log_every=1)
        out["smoke_loss_curve"] = [h["loss"] for h in hs]
        check(hs[-1]["loss"] < hs[0]["loss"],
              f"the smoke config's loss falls over {GNN_TRAIN_STEPS} steps: "
              f"{out['smoke_loss_curve']}")
        add_counts()

        # the other families: two steps at full width, twice; the twins
        out["families"] = {}
        for arch in GNN_TRAIN_FAMILIES:
            runs, run_s = [], []
            for i in range(2):
                t0 = time.perf_counter()
                runs.append(run_gnn(arch, GNN_FAMILY_STEPS, False,
                                    f"{root}/{arch}{i}", None, seed=seed,
                                    device=dev, data=data, log_every=1))
                sync(dev)
                run_s.append(time.perf_counter() - t0)
            (ma, _, ha), (mb, _, hb) = runs
            check(ha == hb and all(math.isfinite(h["loss"]) for h in ha)
                  and all(torch.equal(p, q) for p, q in zip(
                      ma.parameters(), mb.parameters())),
                  f"{arch}: two runs of {GNN_FAMILY_STEPS} steps give the "
                  f"same bits and finite losses: {ha}, {hb}")
            fds = dataset(get_config(arch).sample_sizes or (5, 3))
            fb = fds.batch(0)
            if arch == "meshgraphnet":
                fb = regression_targets(fb, get_config(arch).d_out)
            r = gnn_twin_check(arch, model_of(arch), fb)
            r.update(losses=[h["loss"] for h in ha],
                     engine_cfg=fds.engine_cfg.key, run_s=run_s,
                     batch=dict(nodes=fb.n_nodes,
                                edges=int(fb.edge_dst.shape[0])))
            out["families"][arch] = r
            del runs, ma, mb, fds, fb
            gc.collect()
            torch.cuda.empty_cache()
        add_counts()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["launches"] = totals
    return out


def log_gnn_train(out):
    log(f"[gnn train] Reddit's synthetic graph built on the host in "
        f"{out['dataset_host_s']:.2f}s; dataset on the card "
        f"{out['dataset_device_s']:.2f}s; picked EngineConfig "
        f"{out['engine_cfg']} (sort strategies {out['sort_strategy']}); "
        f"convert launches {out['convert_launches']}")
    log(f"[gnn train] a batch ({out['batch_shape']}) launches "
        f"{out['batch_launches']}; a graphsage step {out['step_launches']}")
    log(f"[gnn train] gradients against the float64 twins: {out['twins']}")
    log_row("span sum backward", {**out["span_sum_backward"],
                                  "shape": out["span_sum_backward"]["shape"]})
    t = out["timed"]
    log(f"[gnn train] steady step (prefetched): {t['step_s'] * 1e3:.2f} ms, "
        f"{t['seeds_per_s']:.1f} seeds/s; peak {t['peak_allocated_gib']:.2f} "
        f"GiB allocated, {t['peak_reserved_gib']:.2f} GiB reserved")
    log_profile("gnn train step profile", out["profile"])
    log_profile("gnn train iteration profile", out["iteration_profile"])
    log(f"[gnn train] run_gnn clean {GNN_TRAIN_STEPS} steps in "
        f"{out['run_gnn_clean_s']:.2f}s, loss curve {out['loss_curve']}; "
        f"resumed at 10: {out['resumed_losses']} (bit-equal); smoke "
        f"{out['smoke_loss_curve']}")
    for arch, r in out["families"].items():
        log(f"[gnn train] {arch}: {GNN_FAMILY_STEPS} steps twice bit-equal, "
            f"losses {r['losses']}; gradients within {r['tol']} of the "
            f"twins (worst {r['worst_share']:.3f} of it, "
            f"{r['worst_param']}); batch {r['batch']}, {r['engine_cfg']}")
    log(f"[gnn train] phase launches {out['launches']}")


# ------------------------------------------------------------- phase 7a
# the engine service's phase: fanouts and seeds a dispatch, the convert
# sizes and library entries the Calibration fit reads (two of different
# w_upe: their n_upe, the model's lanes, differ too), the request sizes
# of the reindex readings, DynPre's graphs (nodes, edges: 2^14 at degree
# 4, 2^20 at degree 32, then Reddit), the batched rows' seed counts, the
# delta's size and chain, the prefetched batches, the train loop's steps
SERVICE_FANOUTS, SERVICE_SEEDS = (25, 10), 1024
CAL_SIZES = (1 << 20, 1 << 24, 1 << 27)
CAL_ENTRIES = ((65536, 4), (4096, 64))  # (w_upe, n_upe), SCR 2048 x 2048
CAL_STRATEGIES = ("global_radix", "chunked_merge", "xla_sort")
REINDEX_READ_SEEDS = (1024, 128)
DYNPRE_GRAPHS = ((4096, 1 << 14), (32_768, 1 << 20))  # then Reddit
SAMPLE_ROWS = ((1, 3, 200, 300), (17, 1024))
DELTA_EDGES, DELTA_DUPLICATES, DELTA_CHAIN = 4096, 1024, 3
PREFETCH_BATCHES, LOOP_STEPS = 16, 3
# the service phase's kernels: the calibration converts (both sort
# strategies on the kernels), the reindex readings, the delta splice (its
# event rung), the prefetched sampling and forward, the train loop
SERVICE_KERNELS = ("digit_hist", "digit_scatter", "rank_search", "rename",
                   "chunk_sort", "fused_merge", "merge_rung",
                   "set_count_less", "ptr_seg_sum",
                   "flash_attention_fwd", "flash_attention_bwd_dq",
                   "flash_attention_bwd_dkv")
# the Calibration constants the readings fit: Ordering from the converts,
# the reindex epilogue from its readings; sel_nodes_per_s has no reading
ORDER_FIT = ("upe_elems_per_s", "merge_step", "hbm_bytes_per_s",
             "xla_cmp_per_s", "sort_dispatch_s")
REINDEX_FIT = ("scr_cmps_per_s", "reidx_elems_per_s", "unroll_bytes_per_s",
               "loop_trip_s")


def sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def wall_s(fn, dev, iters=3):
    """Median wall seconds of ``fn`` (synchronised) after one warm-up."""
    fn()
    sync(dev)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        sync(dev)
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def basis_cal(name):
    """A Calibration in which the model's time is the column of one
    constant: its inverse (or itself, for the two in seconds) at 1, every
    other rate infinite and every other seconds constant 0.
    ``merge_step`` is merge_step_weight / upe_elems_per_s."""
    from repro_torch.core.costmodel import Calibration
    inf = float("inf")
    c = dict(upe_elems_per_s=inf, scr_cmps_per_s=inf, sel_nodes_per_s=inf,
             reidx_elems_per_s=inf, hbm_bytes_per_s=inf,
             merge_step_weight=0.0, xla_cmp_per_s=inf, sort_dispatch_s=0.0,
             loop_trip_s=0.0, unroll_bytes_per_s=inf)
    if name == "merge_step":
        c.update(upe_elems_per_s=1.0, merge_step_weight=1.0)
    else:
        c[name] = 1.0
    return Calibration(**c)


def model_columns(price, names):
    """The model's time as a linear form in the constants ``names``:
    ``price(cal)`` under each one's basis (``merge_step`` less the digit
    term it carries)."""
    cols = {n: price(basis_cal(n)) for n in names}
    if "merge_step" in cols:
        cols["merge_step"] -= price(basis_cal("upe_elems_per_s"))
    return [cols[n] for n in names]


def nnls_fit(rows, times, names):
    """Non-negative least squares of the readings on the model's columns
    (each scaled to unit norm); returns {name: coefficient} (0: the
    readings do not identify it) and the design's rank."""
    import numpy as np
    from scipy.optimize import nnls
    a = np.asarray(rows, np.float64)
    b = np.asarray(times, np.float64)
    scale = np.linalg.norm(a, axis=0)
    scale[scale == 0] = 1.0
    x, _ = nnls(a / scale, b)
    return ({n: float(v) for n, v in zip(names, x / scale)},
            int(np.linalg.matrix_rank(a / scale, tol=1e-9)))


def fitted_calibration(order_coef, reindex_coef):
    """The default Calibration with every constant the readings identify
    (a positive coefficient) replaced; returns it and the names kept."""
    import dataclasses
    from repro_torch.core.costmodel import Calibration
    fit, kept = {}, []
    coef = {**order_coef, **reindex_coef}
    for name, v in coef.items():
        if name == "merge_step":
            continue
        if v <= 0:
            kept.append(name)
        elif name in ("sort_dispatch_s", "loop_trip_s"):  # seconds
            fit[name] = v
        else:
            fit[name] = 1.0 / v
    if coef.get("merge_step", 0) > 0 and coef["upe_elems_per_s"] > 0:
        fit["merge_step_weight"] = coef["merge_step"] / coef[
            "upe_elems_per_s"]
    else:
        kept.append("merge_step_weight")
    kept.append("sel_nodes_per_s")
    return dataclasses.replace(Calibration(), **fit), sorted(kept)


def calibration_phase(dev, seed, coo27, csc27, lib):
    """Convert readings under each pinned strategy at CAL_SIZES for the two
    CAL_ENTRIES (each convert bit-equal to the torch.sort strategy's), and
    the reindex epilogue fused and unfused at REINDEX_READ_SEEDS; the fit;
    each reading beside the model's prediction under the fitted and the
    default Calibration; choose_config under both beside the fastest
    measured."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import costmodel as tcm
    from repro_torch.core import pipeline, prng
    from repro_torch.core.graph import next_pow2, synthetic_coo
    from repro_torch.core.reindexing import build_reindex_map, reindex_edges
    from repro_torch.core.ordering import stable_sort_by_key
    from repro_torch.core.sampling import sample_khop

    n = REDDIT["nodes"]
    entries = [next(c for c in lib if (c.w_upe, c.n_upe, c.w_scr, c.n_scr)
                    == (wu, nu, 2048, 2048)) for wu, nu in CAL_ENTRIES]
    readings, rows, times = [], [], []
    for size in CAL_SIZES:
        coo = coo27 if size == CONVERT_CAP else synthetic_coo(
            n, size, size, seed + size.bit_length(), device=dev)
        want = pipeline.convert(coo, tcm.EngineConfig(
            sort_strategy="xla_sort", reindex_strategy="fused"), device=dev)
        w = tcm.Workload(n=n, e=coo.capacity)
        for entry in entries:
            for s in CAL_STRATEGIES:
                cfg = dataclasses.replace(entry, sort_strategy=s,
                                          reindex_strategy="fused")
                got = pipeline.convert(coo, cfg, device=dev)
                check(torch.equal(got.ptr, want.ptr)
                      and torch.equal(got.idx, want.idx),
                      f"calibration convert {cfg.key} at {size} == the "
                      "torch.sort strategy")
                del got
                t = wall_s(lambda: pipeline.convert(coo, cfg, device=dev),
                           dev)
                readings.append(dict(what="convert", key=cfg.key, e=size,
                                     strategy=s, seconds=t))
                rows.append(model_columns(
                    lambda cal: tcm._ordering_seconds(cfg, w, cal, s),
                    ORDER_FIT))
                times.append(t)
        del want, coo
    order_coef, order_rank = nnls_fit(rows, times, ORDER_FIT)
    for rd, row in zip(readings, rows):
        rd["fit_s"] = sum(c * order_coef[k] for c, k in zip(row, ORDER_FIT))

    # the reindex epilogue at a request's shape: one sample_khop on the
    # Reddit CSC, then build_reindex_map + reindex_edges (the shared sort
    # on global_radix, as SLICE_CFG) fused and unfused
    rrows, rtimes = [], []
    rng = np.random.default_rng(seed + 40)
    for b in REINDEX_READ_SEEDS:
        seeds = torch.from_numpy(rng.choice(n, b, replace=False).astype(
            np.int32)).to(dev)
        nodes, e_dst, e_src = sample_khop(csc27, seeds, SERVICE_FANOUTS,
                                          prng.PRNGKey(seed + b))
        n_cap = nodes.shape[0]
        w = tcm.Workload(n=n, e=CONVERT_CAP, l=len(SERVICE_FANOUTS),
                         k=max(SERVICE_FANOUTS), b=b)
        want = None
        for r in ("fused", "unfused"):
            cfg = dataclasses.replace(entries[1], sort_strategy="global_radix",
                                      reindex_strategy=r)
            kf = pipeline.kernel_fns(cfg)
            fused = r == "fused"

            def sort_fn(k, v, bound, cfg=cfg, kf=kf):
                return stable_sort_by_key(
                    k, v, bound, chunk=min(cfg.w_upe, k.shape[0]),
                    strategy="global_radix",
                    **pipeline._sort_kwargs(cfg, kf, kf.chunk_sort_fn))

            def epilogue():
                rmap = build_reindex_map(
                    nodes, vid_bound=n, strategy=r, sort_fn=sort_fn,
                    rank_fn=kf.rank_fn if fused else None,
                    rename_fn=kf.rename_fn if fused else None)
                return rmap, reindex_edges(rmap, e_dst, e_src,
                                           n_nodes_cap=n_cap)

            rmap, sub = epilogue()
            got = (rmap.order, sub.dst, sub.src)
            if want is None:
                want = got
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"reindex epilogue {r} == fused at {b} seeds")
            t = wall_s(epilogue, dev, iters=5)
            readings.append(dict(what="reindex", key=cfg.key, seeds=b,
                                 strategy=r, n_cap=n_cap, seconds=t))
            rrows.append((cfg, w))
            rtimes.append(t)
        del nodes, e_dst, e_src
    # the shared sort priced under the fitted Ordering constants comes off
    # each reindex reading before its own constants are fitted
    order_cal, _ = fitted_calibration(order_coef, {k: 0 for k in
                                                    REINDEX_FIT})
    cols, rest = [], []
    for (cfg, w), t in zip(rrows, rtimes):
        wsub = tcm.Workload(n=w.n, e=next_pow2(tcm.sample_vid_capacity(w)))
        t_sort = tcm._ordering_seconds(cfg, wsub, order_cal, "global_radix") \
            / tcm.sort_pass_count(cfg, wsub)
        cols.append(model_columns(
            lambda cal, cfg=cfg, w=w: tcm._reindex_seconds(cfg, w, cal),
            REINDEX_FIT))
        rest.append(max(0.0, t - t_sort))
    reindex_coef, reindex_rank = nnls_fit(cols, rest, REINDEX_FIT)
    # the fit's own prediction: a constant whose best coefficient is 0
    # costs nothing there, while the fitted Calibration keeps its
    # reference value
    for rd, col, t_rest, t in zip(
            [r for r in readings if r["what"] == "reindex"], cols, rest,
            rtimes):
        rd["fit_s"] = (t - t_rest) + sum(
            c * reindex_coef[k] for c, k in zip(col, REINDEX_FIT))
    fitted, kept = fitted_calibration(order_coef, reindex_coef)
    default = tcm.Calibration()

    # each reading beside the model's prediction under both calibrations
    for rd in readings:
        cfg = next(c for c in [dataclasses.replace(
            e, sort_strategy=s, reindex_strategy=r) for e in entries
            for s in CAL_STRATEGIES for r in ("fused", "unfused")]
            if c.key == rd["key"])
        if rd["what"] == "convert":
            w = tcm.Workload(n=n, e=rd["e"])
            price = lambda cal: tcm._ordering_seconds(  # noqa: E731
                cfg, w, cal, rd["strategy"])
        else:
            w = tcm.Workload(n=n, e=CONVERT_CAP, l=len(SERVICE_FANOUTS),
                             k=max(SERVICE_FANOUTS), b=rd["seeds"])
            price = lambda cal: tcm._reindex_seconds(  # noqa: E731
                cfg, w, cal)
        rd["predicted_fitted_s"] = price(fitted)
        rd["predicted_default_s"] = price(default)
    picks = {}
    for size in CAL_SIZES:
        w = tcm.Workload(n=n, e=size, l=len(SERVICE_FANOUTS),
                         k=max(SERVICE_FANOUTS), b=SERVICE_SEEDS)
        fastest = min((r for r in readings if r["what"] == "convert"
                       and r["e"] == size), key=lambda r: r["seconds"])
        picks[size] = dict(
            fitted=tcm.choose_config(w, lib, fitted).key,
            default=tcm.choose_config(w, lib, default).key,
            fastest_measured=fastest["key"],
            fastest_measured_s=fastest["seconds"])
    return dict(readings=readings, fitted=dataclasses.asdict(fitted),
                kept_reference=kept, order_coef=order_coef,
                reindex_coef=reindex_coef, order_rank=order_rank,
                reindex_rank=reindex_rank, picks=picks), fitted


def same_subgraph(a, b):
    import torch
    return all(torch.equal(x, y) for x, y in (
        (a.csc.ptr, b.csc.ptr), (a.csc.idx, b.csc.idx), (a.order, b.order),
        (a.csc.n_edges, b.csc.n_edges), (a.n_sub_nodes, b.n_sub_nodes)))


def dynpre_phase(dev, seed, coo27, lib, cals):
    """DynPre over diverse graphs (the paper's Fig. 28a): one service per
    Calibration, 1,024 seeds and a key a graph; each subgraph bit-equal to
    ``pipeline.preprocess`` under SLICE_CFG on the same inputs. Then a
    fresh service dispatches the Reddit pair and another fresh one
    re-dispatches it: no new entry, no library loaded."""
    import numpy as np
    from repro_torch.core import pipeline, prng
    from repro_torch.core.graph import synthetic_coo
    from repro_torch.engine import PreprocService, preprocess_cache_size
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import SLICE_CFG

    graphs = [synthetic_coo(nn, e, e, seed + 50 + i, device=dev)
              for i, (nn, e) in enumerate(DYNPRE_GRAPHS)] + [coo27]
    rng = np.random.default_rng(seed + 51)
    inputs = [(g, rng.choice(g.n_nodes, SERVICE_SEEDS, replace=False).astype(
        np.int32), prng.fold_in(prng.PRNGKey(seed), 51 + i))
        for i, g in enumerate(graphs)]
    out = {}
    for name, cal in cals.items():
        svc = PreprocService(SERVICE_FANOUTS, library=lib, cal=cal)
        runs = []
        for g, seeds, key in inputs:
            sync(dev)
            t0 = time.perf_counter()
            sub = svc.preprocess(g, seeds, key)
            sync(dev)
            secs = time.perf_counter() - t0
            want = pipeline.preprocess(g, seeds, SERVICE_FANOUTS, key,
                                       SLICE_CFG, device=dev)
            check(same_subgraph(sub, want),
                  f"DynPre ({name}) subgraph of a {g.n_nodes}-node graph == "
                  "SLICE_CFG's, bit for bit")
            runs.append(dict(nodes=g.n_nodes, capacity=g.capacity,
                             key=svc.active_cfg.key,
                             bucket=(g.capacity, SERVICE_SEEDS),
                             n_reconfigs=svc.stats.n_reconfigs,
                             seconds=secs))
            del sub, want
        out[name] = dict(runs=runs, stats=dict(vars(svc.stats)))
    g, seeds, key = inputs[-1]
    first = PreprocService(SERVICE_FANOUTS, library=lib)
    first.preprocess(g, seeds, key)
    size, libs = preprocess_cache_size(), dict(_build._LIBS)
    fresh = PreprocService(SERVICE_FANOUTS, library=lib)
    fresh.preprocess(g, seeds, key)
    sync(dev)
    check(preprocess_cache_size() == size and _build._LIBS == libs
          and fresh._keys_seen == first._keys_seen,
          f"a fresh service re-dispatching the Reddit pair "
          f"{sorted(fresh._keys_seen)} adds no entry ({size} → "
          f"{preprocess_cache_size()}) and loads no library")
    out["redispatch"] = dict(pair=sorted(fresh._keys_seen), entries=size,
                             libraries=sorted(libs))
    return out


def sample_batched_phase(dev, seed, csc, lib):
    """Batched rows of 1..1,024 seeds (each call's rows SENTINEL-padded to
    the widest, then bucketed to the next power of two) on the Reddit CSC:
    each row equal to sample_subgraph on it."""
    import numpy as np
    import torch
    from repro_torch.core import pipeline, prng
    from repro_torch.core.graph import SENTINEL
    from repro_torch.engine import PreprocService
    from repro_torch.engine.service import bucket_seed_rows

    svc = PreprocService(SERVICE_FANOUTS, library=lib)
    rng = np.random.default_rng(seed + 60)
    out = []
    for c, counts in enumerate(SAMPLE_ROWS):
        width = max(counts)
        rows = np.full((len(counts), width), SENTINEL, np.int32)
        for i, k in enumerate(counts):
            rows[i, :k] = rng.choice(REDDIT["nodes"], k, replace=False)
        keys = prng.split(prng.fold_in(prng.PRNGKey(seed), 60 + c),
                          len(counts))
        sync(dev)
        t0 = time.perf_counter()
        sub = svc.sample_batched(csc, torch.from_numpy(rows).to(dev), keys)
        sync(dev)
        secs = time.perf_counter() - t0
        padded = bucket_seed_rows(torch.from_numpy(rows).to(dev))
        for i in range(len(counts)):
            one = pipeline.sample_subgraph(csc, padded[i], SERVICE_FANOUTS,
                                           keys[i], svc.active_cfg)
            check(all(torch.equal(a, b) for a, b in (
                (sub.csc.ptr[i], one.csc.ptr), (sub.csc.idx[i], one.csc.idx),
                (sub.order[i], one.order))),
                f"sample_batched row {i} ({counts[i]} seeds) == "
                "sample_subgraph on it")
        out.append(dict(counts=counts, bucket=tuple(padded.shape),
                        key=svc.active_cfg.key, seconds=secs))
    return dict(calls=out, stats=dict(vars(svc.stats)))


def delta_oracle(dst, src, ins, dels, bits):
    """The post-update edge list on the host (numpy): each delete kills one
    remaining copy of its edge (duplicates: one copy each), misses are
    no-ops, the inserts are appended."""
    import numpy as np
    keys = (dst.astype(np.int64) << bits) | src
    dk = (dels[0].astype(np.int64) << bits) | dels[1]
    uniq, cnt = np.unique(dk, return_counts=True)
    at = np.minimum(np.searchsorted(uniq, keys), uniq.shape[0] - 1)
    pos = np.nonzero(uniq[at] == keys)[0]
    kp = keys[pos]
    order = np.argsort(kp, kind="stable")
    pos, kp = pos[order], kp[order]
    occ = np.arange(kp.shape[0]) - np.searchsorted(kp, kp, side="left")
    kill = pos[occ < cnt[np.searchsorted(uniq, kp)]]
    keep = np.ones(keys.shape[0], bool)
    keep[kill] = False
    return (np.concatenate([dst[keep], ins[0]]),
            np.concatenate([src[keep], ins[1]]))


def draw_delta(rng, dst, src, n):
    """DELTA_EDGES inserts and deletes: the deletes hit existing edges,
    DELTA_DUPLICATES of them twice; an eighth of the inserts re-insert a
    deleted edge."""
    import numpy as np
    hit = rng.integers(0, dst.shape[0], DELTA_EDGES - DELTA_DUPLICATES)
    hit = np.concatenate([hit, hit[:DELTA_DUPLICATES]])
    dels = (dst[hit], src[hit])
    k = DELTA_EDGES // 8
    ins = (np.concatenate([rng.integers(0, n, DELTA_EDGES - k), dst[hit[:k]]]
                          ).astype(np.int32),
           np.concatenate([rng.integers(0, n, DELTA_EDGES - k), src[hit[:k]]]
                          ).astype(np.int32))
    return ins, dels


def delta_service_phase(dev, seed, coo, csc, lib):
    """apply_delta through the service on the Reddit CSC: DELTA_EDGES
    inserts and deletes from ``--seed``, in merge and rebuild modes under
    the service's own configuration and under SLICE_CFG, each
    bit-identical to the torch.sort convert of the post-update edge list
    built with numpy on the host, timed; the mode auto picks; then a
    chain of DELTA_CHAIN deltas, checked the same way."""
    import numpy as np
    import torch
    from repro_torch.core import costmodel as tcm
    from repro_torch.core import pipeline
    from repro_torch.core.delta import EdgeDelta
    from repro_torch.core.graph import COO
    from repro_torch.engine import PreprocService
    from repro_torch.launch.serve import SLICE_CFG

    n = REDDIT["nodes"]
    bits = n.bit_length()
    ne = int(coo.n_edges)
    h_dst = coo.dst[:ne].cpu().numpy()
    h_src = coo.src[:ne].cpu().numpy()
    rng = np.random.default_rng(seed + 70)
    ref_cfg = tcm.EngineConfig(sort_strategy="xla_sort",
                               reindex_strategy="fused")

    def oracle_csc(nd, ns, cap):
        return pipeline.convert(COO.from_arrays(nd, ns, n, capacity=cap,
                                                device=dev), ref_cfg,
                                device=dev)

    def same(a, b):
        return (torch.equal(a.ptr, b.ptr) and torch.equal(a.idx, b.idx)
                and int(a.n_edges) == int(b.n_edges))

    svc = PreprocService(SERVICE_FANOUTS, library=lib)
    ins, dels = draw_delta(rng, h_dst, h_src, n)
    delta = EdgeDelta.from_arrays(*ins, *dels, n_nodes=n, device=dev)
    nd, ns = delta_oracle(h_dst, h_src, ins, dels, bits)
    want = oracle_csc(nd, ns, csc.idx.shape[0])
    out = dict(n_edges_after=int(nd.shape[0]),
               deleted=int(ne + DELTA_EDGES - nd.shape[0]), modes={})
    for tag, cfg in (("service", None), ("slice", SLICE_CFG)):
        for mode in ("merge", "rebuild"):
            got = svc.apply_delta(csc, delta, cfg=cfg, mode=mode)
            check(same(got, want), f"apply_delta ({tag}, {mode}) on the "
                  "Reddit CSC == the torch.sort convert of the post-update "
                  "edge list")
            del got
            t = wall_s(lambda: svc.apply_delta(csc, delta, cfg=cfg,
                                               mode=mode), dev)
            out["modes"][f"{tag}_{mode}"] = dict(
                seconds=t, key=(cfg or svc.active_cfg).key)
    if dev.type == "cuda":  # where one merge's time goes
        out["merge_profile"] = profile_call(
            lambda: svc.apply_delta(csc, delta, cfg=SLICE_CFG, mode="merge"),
            top=10)
    w = tcm.Workload(n=n, e=csc.idx.shape[0])
    out["auto_picks"] = {
        tag: tcm.resolve_delta_mode(cfg, w, delta.capacity)
        for tag, cfg in (("service", svc.active_cfg), ("slice", SLICE_CFG))}
    del want
    chain, cd, cs = [], nd, ns
    cur = svc.apply_delta(csc, delta)  # the chain starts after the first
    for step in range(DELTA_CHAIN):
        ins, dels = draw_delta(rng, cd, cs, n)
        delta = EdgeDelta.from_arrays(*ins, *dels, n_nodes=n, device=dev)
        cur = svc.apply_delta(cur, delta)
        cd, cs = delta_oracle(cd, cs, ins, dels, bits)
        check(same(cur, oracle_csc(cd, cs, cur.idx.shape[0])),
              f"chained delta {step} == the torch.sort convert of the "
              "post-update edge list")
        chain.append(int(cd.shape[0]))
    out["chain_n_edges"] = chain
    out["stats"] = dict(vars(svc.stats))
    return out


def prefetch_phase(dev, seed, csc, feats):
    """PREFETCH_BATCHES batches of a request's sampling (1,024 seeds,
    fanouts 25-10, SLICE_CFG) and feature gather made by a Prefetcher's
    producer on its side stream, consumed by the graphsage-reddit forward
    at full width on the main stream: every logit bit-equal to
    SyncBatches's, wall times of both, and the launch counters of the
    prefetched run (bumped from two threads) equal to the synchronous
    run's."""
    import numpy as np
    import torch
    from repro_torch.configs.graphsage_reddit import config
    from repro_torch.core import prng
    from repro_torch.engine import Prefetcher, SyncBatches, sample_jit
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.serve import SLICE_CFG
    from repro_torch.models.gnn import GraphSAGE, subgraph_batch

    model = GraphSAGE(config(), d_in=REDDIT["feats"],
                      n_classes=REDDIT["classes"],
                      generator=torch.Generator().manual_seed(seed + 2),
                      device=dev)

    def batch_fn(step):
        rng = np.random.default_rng(seed + 100 + step)
        seeds = torch.from_numpy(rng.choice(
            REDDIT["nodes"], SERVICE_SEEDS, replace=False).astype(
            np.int32)).to(dev)
        sub = sample_jit(csc, seeds, SERVICE_FANOUTS,
                         prng.fold_in(prng.PRNGKey(seed), 100 + step),
                         SLICE_CFG)
        return subgraph_batch(sub, feats)

    def consume(it, want=None):
        got = []
        with torch.inference_mode():
            for step, batch in it:
                logits = model(batch)
                del batch  # its memory goes back to the allocator at once
                if want is None:
                    got.append(logits)
                else:
                    check(torch.equal(logits, want[step]),
                          f"prefetched batch {step}: logits == sync")
        return got

    def counted(run):
        before = launch_counts()
        sync(dev)
        t0 = time.perf_counter()
        got = run()
        sync(dev)
        secs = time.perf_counter() - t0
        after = launch_counts()
        return got, secs, {k: after[k] - before[k] for k in after
                           if after[k] != before[k]}

    def prefetched():
        with Prefetcher(batch_fn, stop=PREFETCH_BATCHES) as pf:
            out["side_stream"] = pf.stream is not None
            return consume(pf, want)

    batch_fn(0)  # warm-up
    out = {}
    want, out["sync_s"], out["sync_launches"] = counted(
        lambda: consume(SyncBatches(batch_fn, stop=PREFETCH_BATCHES)))
    # in turns: prefetched twice (the first on a fresh side stream, whose
    # allocator pool starts empty), then synchronous once more
    _, out["prefetch_s"], out["prefetch_launches"] = counted(prefetched)
    _, out["prefetch_again_s"], again = counted(prefetched)
    _, out["sync_again_s"], _ = counted(
        lambda: consume(SyncBatches(batch_fn, stop=PREFETCH_BATCHES), want))
    if dev.type == "cuda":  # the card's busy share, 4 batches each way
        out["profiles"] = {
            "sync": profile_call(lambda: consume(
                SyncBatches(batch_fn, stop=4), want), top=6),
            "prefetched": profile_call(lambda: consume(
                Prefetcher(batch_fn, stop=4), want), top=6)}
    check(out["prefetch_launches"] == out["sync_launches"] == again
          and out["sync_launches"].get("ptr_seg_sum")
          == len(SCAN_CALLS) * PREFETCH_BATCHES,
          f"the prefetched runs' launch counters == the synchronous run's "
          f"({len(SCAN_CALLS)} ptr_seg_sum a batch): "
          f"{out['prefetch_launches']} / {again} / "
          f"{out['sync_launches']}")
    check(all(bool(torch.isfinite(x).all()) for x in want),
          "finite prefetched logits")
    return out


def train_loop_phase(dev, seed):
    """LOOP_STEPS of the gemma2-9b smoke config through train/loop.py
    (``launch/train.run_lm``) on the card, with prefetch (batches made on
    the side stream) and without: the same losses and weights, bit for
    bit."""
    import shutil
    import tempfile
    import torch
    from repro_torch.launch.train import run_lm

    runs = {}
    for prefetch in (False, True):
        d = tempfile.mkdtemp(prefix="chip_smoke_loop_")
        try:
            t0 = time.perf_counter()
            model, _, hist = run_lm(LM_ARCH, LOOP_STEPS, True, d, None,
                                    seed=seed, device=dev, prefetch=prefetch)
            sync(dev)
            runs[prefetch] = (model, hist, time.perf_counter() - t0)
        finally:
            shutil.rmtree(d, ignore_errors=True)
    (m0, h0, s0), (m1, h1, s1) = runs[False], runs[True]
    check(h0 == h1 and all(torch.equal(p, q) for p, q in zip(
        m0.parameters(), m1.parameters())),
        f"train loop with prefetch == without, bit for bit: {h1} / {h0}")
    return dict(history=h1, seconds_sync=s0, seconds_prefetch=s1)


def service_phase(dev, seed, coo27, csc27, feats):
    """The engine service on the card (phase 7a): launch counters to 0,
    every ``_pl`` library entry converting 2^20 pairs, the Calibration
    fit, DynPre, re-dispatch, sample_batched, apply_delta, prefetch and
    the train loop; counters read."""
    import dataclasses
    import torch
    from repro_torch.core import costmodel as tcm
    from repro_torch.core import pipeline
    from repro_torch.core.graph import synthetic_coo
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels import radix_sort as trs

    lib = [dataclasses.replace(c, use_pallas=True)
           for c in tcm.bitstream_library()]
    out = {}
    reset_launch_counts()
    # step 0: the bare chunk-sort wrapper refuses a chunk wider than one CTA
    # holds; the routing sorts it as sub-chunks and one merge rung, so
    # every library entry converts
    keys = torch.zeros(1 << 16, dtype=torch.int32, device=dev)
    refused = False
    try:
        trs.chunk_sort(keys, keys.clone(), 1 << 16, 18)
    except ValueError:
        refused = True
    check(refused or dev.type != "cuda", "chunk_sort refuses 65,536 pairs "
          "a chunk (one CTA holds 16,384)")
    coo = synthetic_coo(REDDIT["nodes"], 1 << 20, 1 << 20, seed + 20,
                        device=dev)
    want = pipeline.convert(coo, tcm.EngineConfig(sort_strategy="xla_sort",
                                                  reindex_strategy="fused"),
                            device=dev)
    for c in lib:
        for s in ("chunked_merge", "global_radix"):
            got = pipeline.convert(coo, dataclasses.replace(
                c, sort_strategy=s), device=dev)
            check(torch.equal(got.ptr, want.ptr)
                  and torch.equal(got.idx, want.idx),
                  f"{c.key} ({s}) converts 2^20 pairs == torch.sort")
    out["library_converts"] = 2 * len(lib)
    del coo, want, got, keys

    t0 = time.perf_counter()
    out["calibration"], fitted = calibration_phase(dev, seed, coo27, csc27,
                                                   lib)
    out["calibration_s"] = time.perf_counter() - t0
    out["dynpre"] = dynpre_phase(dev, seed, coo27, lib,
                                 {"default": tcm.Calibration(),
                                  "fitted": fitted})
    out["sample_batched"] = sample_batched_phase(dev, seed, csc27, lib)
    out["delta"] = delta_service_phase(dev, seed, coo27, csc27, lib)
    out["prefetch"] = prefetch_phase(dev, seed, csc27, feats)
    out["train_loop"] = train_loop_phase(dev, seed)
    out["launches"] = launch_counts()
    return out


def log_service(out):
    cal = out["calibration"]
    log(f"[service] {out['library_converts']} conversions of 2^20 pairs, "
        "every _pl library entry under chunked_merge and global_radix "
        "(w_upe 256 .. 65,536): == torch.sort")
    log(f"[calibration] fitted on the card ({out['calibration_s']:.1f}s): "
        f"{json.dumps(cal['fitted'])}")
    log(f"[calibration] kept the reference's (not identified): "
        f"{cal['kept_reference']}; design rank {cal['order_rank']}/"
        f"{len(ORDER_FIT)} (Ordering), {cal['reindex_rank']}/"
        f"{len(REINDEX_FIT)} (reindex)")
    for r in cal["readings"]:
        log(f"[calibration] {r['what']} {r['key']} "
            f"{r.get('e', r.get('seeds'))}: measured {r['seconds']:.6f}s, "
            f"fit {r['fit_s']:.6f}s, model under the fitted Calibration "
            f"{r['predicted_fitted_s']:.6f}s, default "
            f"{r['predicted_default_s']:.6f}s")
    for size, p in cal["picks"].items():
        log(f"[calibration] choose_config at {size} edges: fitted "
            f"{p['fitted']}, default {p['default']}; fastest measured "
            f"{p['fastest_measured']} ({p['fastest_measured_s']:.6f}s)")
    for name in ("default", "fitted"):
        for r in out["dynpre"][name]["runs"]:
            log(f"[dynpre {name}] {r['nodes']} nodes, bucket {r['bucket']}: "
                f"{r['key']}, n_reconfigs {r['n_reconfigs']}, "
                f"{r['seconds']:.4f}s")
    log(f"[dynpre] re-dispatch of {out['dynpre']['redispatch']['pair']}: "
        "no new entry, no library loaded")
    for c in out["sample_batched"]["calls"]:
        log(f"[sample_batched] rows of {c['counts']} seeds → bucket "
            f"{c['bucket']} ({c['key']}): {c['seconds']:.4f}s, each row == "
            "sample_subgraph")
    d = out["delta"]
    log(f"[delta] {DELTA_EDGES} inserts, {DELTA_EDGES} deletes "
        f"({DELTA_DUPLICATES} twice): {d['deleted']} edges deleted in "
        f"effect; " + ", ".join(f"{k} {v['seconds']:.4f}s ({v['key']})"
                               for k, v in d["modes"].items())
        + f"; auto picks {d['auto_picks']}; chain of {DELTA_CHAIN}: "
        f"{d['chain_n_edges']} edges, each == a fresh convert")
    for tag, prof in ([("delta merge (SLICE_CFG)", d["merge_profile"])]
                      if "merge_profile" in d else []) + [
            (f"prefetch {k}, 4 batches", v)
            for k, v in out["prefetch"].get("profiles", {}).items()]:
        log(f"[{tag} profile] wall {prof['wall_ms']:.2f} ms, device "
            f"{prof['device_ms']:.2f} ms (busy share "
            f"{prof['device_busy_share']:.3f}); top by device time: " + "; ".join(
                f"{r['name'][:60]} {r['device_ms']:.3f} ms x{r['count']}"
                for r in prof["top"]))
    p = out["prefetch"]
    log(f"[prefetch] {PREFETCH_BATCHES} batches in turns: sync "
        f"{p['sync_s']:.3f}s, prefetched {p['prefetch_s']:.3f}s and "
        f"{p['prefetch_again_s']:.3f}s, sync {p['sync_again_s']:.3f}s (side "
        f"stream {p['side_stream']}); logits bit-equal; launches "
        f"{p['prefetch_launches']}")
    t = out["train_loop"]
    log(f"[train loop] {LOOP_STEPS} smoke steps through train/loop.py, "
        f"prefetch == sync bit for bit: {t['history']} "
        f"({t['seconds_sync']:.2f}s / {t['seconds_prefetch']:.2f}s)")
    log(f"[service] launches {out['launches']}")


def profile_phase(eng, seeds, rid, top=8):
    """One full-width request (``slot_fn``) under ``torch.profiler``, with
    the count of the plain merge ladder's ops (a MERGE_CFG request runs
    them only outside the ladder)."""
    import torch
    from repro_torch.core.graph import SENTINEL

    row = torch.full((eng.seed_cap,), SENTINEL, dtype=torch.int32)
    row[:len(seeds)] = torch.tensor(seeds, dtype=torch.int32)
    row = row.to(eng.device)
    key = eng.request_key(rid)
    eng.slot_fn(eng.params, row, key)
    torch.cuda.synchronize()
    return dict(seeds=len(seeds),
                **profile_call(lambda: eng.slot_fn(eng.params, row, key), top,
                               kernels=PATH_KERNEL_RE, ops=LADDER_OP_RE))


# the hand-written kernels of a convert in a trace, by path. MERGE_CFG: the
# chunk sort, the merge-path partition and tile kernels (the fused merge's
# and the rungs' passes), the set count's two. SLICE_CFG: the card's digit
# pass, the reference design's pair (which must be absent) and the rank
# kernel of the pointer build
CONVERT_KERNEL_RE = {
    "merge": (r"\b(?:chunk_sort_kernel|merge_partition_kernel|"
              r"merge_tile_kernel|tile_sort_kernel|set_count_kernel)\b"),
    "slice": (r"\b(?:digit_hist_kernel|digit_scatter_kernel|"
              r"partition_hist_kernel|rank_gather_kernel|rank_kernel)\b")}
# the plain merge ladder's ops (``core/ordering.py`` ``merge_sorted_k``),
# which a MERGE_CFG convert on the card must not run
LADDER_OP_RE = r"^aten::(?:searchsorted|scatter_?)$"


def convert_profile(dev, coo, path="merge"):
    """One convert of ``coo`` under ``torch.profiler``, on the ``path``'s
    config (``ENGINE_CFGS``: "merge" or "slice"): its wall and device time,
    split into the hand-written kernels by name and the rest, and the
    count of the plain ladder's ops in the trace; on the merge path the
    device span of each merge rung above the fused merge's block
    (``kernels/merge.py`` ``merge_rung``, timed by CUDA events around each
    call)."""
    import torch
    from repro_torch.core import pipeline
    from repro_torch.kernels import merge as tm
    from repro_torch.launch.serve import ENGINE_CFGS

    cfg = ENGINE_CFGS[path][0]
    if path != "merge":
        prof = profile_call(lambda: pipeline.convert(coo, cfg, device=dev),
                            top=12, kernels=CONVERT_KERNEL_RE[path],
                            ops=LADDER_OP_RE)
        named = sum(r["device_ms"] for r in prof["kernels"].values())
        prof["other_device_ms"] = prof["device_ms"] - named
        return prof
    spans = []
    rung = tm.merge_rung

    def timed_rung(ks, vs, run, k):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = rung(ks, vs, run, k)
        ev[1].record()
        spans.append((ev, k))
        return out
    # kernel_fns imports merge_rung when it builds a config's routing
    # (cleared here, so it is built again around the swap); the wrapper
    # counts its launch on the module's name, so the stand-in carries the
    # count
    timed_rung.launches = rung.launches
    tm.merge_rung = timed_rung
    pipeline._KERNEL_FNS.clear()
    try:
        prof = profile_call(lambda: pipeline.convert(coo, cfg, device=dev),
                            top=12, kernels=CONVERT_KERNEL_RE[path],
                            ops=LADDER_OP_RE)
    finally:
        tm.merge_rung = rung
        rung.launches = timed_rung.launches
        pipeline._KERNEL_FNS.clear()
    named = sum(r["device_ms"] for r in prof["kernels"].values())
    prof["other_device_ms"] = prof["device_ms"] - named
    prof["merge_rung_spans_ms"] = [ev[0].elapsed_time(ev[1])
                                   for ev, _ in spans]
    prof["merge_rung_fan_ins"] = [k for _, k in spans]
    return prof


# the hand-written kernels of the GNN serve step in a trace, and the one
# a counted launch of each 1:1 wrapper runs
SERVE_KERNEL_RE = (r"\b(?:digit_hist|digit_scatter|chunk_sort|rank|rename|"
                   r"span_sum|merge_partition|merge_tile|tile_sort|set_count|"
                   r"segment_sum|segment_bounds)_kernel\b")
TRACE_OF_WRAPPER = {"digit_hist": "digit_hist_kernel",
                    "digit_scatter": "digit_scatter_kernel",
                    "rank_search": "rank_kernel", "rename": "rename_kernel",
                    "ptr_seg_sum": "span_sum_kernel",
                    "chunk_sort": "chunk_sort_kernel",
                    "segment_sum_sorted": "segment_sum_kernel"}
# spin kernels (torch.cuda._sleep) that begin and end every profiled
# call's trace: TRACE_TAIL short ones and one of TRACE_GUARD_CYCLES
# (about 50 ms at the H100's 1.98 GHz) on each side of the call
TRACE_TAIL, TRACE_TAIL_KERNEL = 256, "spin_kernel"
TRACE_GUARD_CYCLES = 100_000_000
# each profiled call's short guard spins kept before and after the call,
# and how far its last kernel's end lies past its last host event's end,
# in µs (negative: before it)
TRACE_CLOCK = []
# a request's or a step's trace: those kernels by name, and every copy
# kernel as one ("copy": the transposing copies of the port's earlier
# pointer segment sum were ones)
PATH_KERNEL_RE = SERVE_KERNEL_RE + "|copy"


def profile_call(fn, top=8, kernels=None, ops=None, owners=None):
    """``fn()`` once under ``torch.profiler``: the host wall time, the
    device time summed over every op's own kernels, and the ops and
    kernels that take the most device time; with ``kernels`` (a regex),
    the device time and count of each kernel whose name it matches; with
    ``ops`` (a regex), the count of each host op whose name it matches;
    with ``owners`` (a regex), for each kernel whose name it matches, the
    host ops that launched it, counted."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # kernel records next to either end of a trace can miss, more
        # the longer the process has run (read on an H100: a train
        # step's first two span sums; the last 2 segment or span sums of
        # a 4-replay run; behind a tail of 256 short spins alone, an
        # eager slot_fn's last 2 segment-bounds and 2 segment sums; with
        # the 50 ms spins, the first 1 to 286 of 2,048 short head spins
        # and never a record nearer the call): a head and a tail of spin
        # kernels, each with a 50 ms one next to the call, left out below
        for _ in range(TRACE_TAIL):
            torch.cuda._sleep(1000)
        torch.cuda._sleep(TRACE_GUARD_CYCLES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda._sleep(TRACE_GUARD_CYCLES)
        for _ in range(TRACE_TAIL):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    averages = prof.key_averages()
    ends, spins = {}, []
    for e in prof.events():
        ends[e.device_type] = max(ends.get(e.device_type, 0.0),
                                  e.time_range.end)
        if e.device_type == DeviceType.CUDA and TRACE_TAIL_KERNEL in e.name:
            spins.append(e.time_range)
    lead_us = (ends[DeviceType.CUDA] - ends[DeviceType.CPU]
               if DeviceType.CUDA in ends else None)
    # the short guard spins kept before the first long one and after the
    # last (None when a long one is missing)
    longs = sorted((t for t in spins if t.elapsed_us() > 1000),
                   key=lambda t: t.start)
    head = tail = None
    if len(longs) == 2:
        head = sum(1 for t in spins if t.end <= longs[0].start)
        tail = sum(1 for t in spins if t.start >= longs[1].end)
    TRACE_CLOCK.append([head, tail, lead_us])
    if (head, tail, len(spins)) != (TRACE_TAIL, TRACE_TAIL,
                                    2 * (TRACE_TAIL + 1)):
        log(f"[profile] the trace kept {len(spins)} of the "
            f"{2 * (TRACE_TAIL + 1)} guard spins ({head} short ones "
            f"before the call, {tail} after); its last kernel ends "
            f"{lead_us} µs past its last host event")
    events = [e for e in averages if TRACE_TAIL_KERNEL not in e.key]
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in events]
    # an op's own device time is its kernels' time: sum the kernels alone
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA) / 1e3
    rows.sort(key=lambda r: -r[1])
    named = {}
    for e in events:
        m = (re.search(kernels, e.key) if kernels is not None
             and e.device_type == DeviceType.CUDA else None)
        if m:
            ms, n = named.get(m.group(0), (0.0, 0))
            named[m.group(0)] = (ms + e.self_device_time_total / 1e3,
                                 n + e.count)
    launched_by = {}
    for e in (prof.events() if owners is not None else ()):
        for k in e.kernels:
            m = re.search(owners, k.name)
            if m and e.device_type == DeviceType.CPU:
                by = launched_by.setdefault(m.group(0), {})
                by[e.name] = by.get(e.name, 0) + 1
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                device_busy_share=device_ms / wall_ms,
                guard_spins_kept=len(spins),
                **({} if owners is None else dict(owners=launched_by)),
                top=[dict(name=k[:120], device_ms=t, count=c)
                     for k, t, c in rows[:top]],
                **({} if kernels is None else dict(kernels={
                    k: dict(device_ms=t, count=c)
                    for k, (t, c) in sorted(named.items())})),
                **({} if ops is None else dict(ops={
                    e.key: e.count for e in events
                    if e.device_type == DeviceType.CPU
                    and re.search(ops, e.key)})))


# ------------------------------------------------------------- phase 9
def lm_path(dev, seed):
    """Launch counters to 0, the full-width gemma2-9b prefill cell at
    LM_SEQ tokens, one prefill, counters read; a second prefill for the
    bits and the steady time."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.steps import lm_prefill_cell

    out = {}
    t0 = time.perf_counter()
    cell = lm_prefill_cell(LM_ARCH, seq_len=LM_SEQ, batch=LM_BATCH,
                           device=dev, seed=seed)
    torch.cuda.synchronize()
    out["setup_s"] = time.perf_counter() - t0
    out["params"] = sum(p.numel() for p in cell.model.parameters())
    out["weights_gib"] = torch.cuda.memory_allocated() / 2**30

    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits = cell.step()
    torch.cuda.synchronize()
    out["first_s"] = time.perf_counter() - t0
    out["launches"] = launch_counts()
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    t0 = time.perf_counter()
    again = cell.step()
    torch.cuda.synchronize()
    out["steady_s"] = time.perf_counter() - t0
    out["tokens_per_s"] = LM_BATCH * LM_SEQ / out["steady_s"]
    check(torch.equal(logits, again), "two prefills give the same bits")
    return out, cell, logits


def lm_checks(dev, seed, cell, logits, extra):
    """Each flash launch of a prefill held against the twin on its own
    inputs; the prefill's logits against the same prefill with the twin
    in every layer (and the readings of three planted faults); the smoke
    model on the card against the CPU."""
    import torch
    from repro_torch.launch.steps import lm_prefill_cell
    from repro_torch.models import transformer
    from repro_torch.models.attention import flash_attention_plain

    cfg = cell.model.cfg
    check(tuple(logits.shape) == (LM_BATCH, cfg.vocab)
          and logits.dtype == cfg.dtype, f"logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits.float()).all()), "finite logits")
    check(float(logits.float().abs().max()) <= cfg.final_logit_cap,
          "logits within the final softcap")

    # every launch of a prefill against the twin on that launch's inputs
    kernel_fn = transformer.flash_attention_bhsd
    layers, faults = [], {}

    def checked(q, k, v, **kw):
        got = kernel_fn(q, k, v, **kw)
        want = flash_attention_plain(q, k, v, **kw)
        layers.append(flash_close(got, want))
        if len(layers) <= 2:  # the first local and global layers' inputs:
            # would the kernel phase's planted faults show here?
            fault = (dict(window=kw["window"] + 1) if kw["window"]
                     else dict(logit_cap=None))
            faults[f"layer{len(layers) - 1}_{next(iter(fault))}"] = (
                flash_close(flash_attention_plain(q, k, v, **{**kw, **fault}),
                            want)[2])
        return got
    transformer.flash_attention_bhsd = checked
    again = cell.step()
    transformer.flash_attention_bhsd = kernel_fn
    extra["lm_layers_max_abs_err"] = max(e for _, e, _ in layers)
    extra["lm_layers_share_of_tol"] = max(sh for _, _, sh in layers)
    check(len(layers) == cfg.n_layers and all(ok for ok, _, _ in layers),
          f"each of the prefill's {cfg.n_layers} flash launches within rtol "
          f"{FLASH_RTOL} atol {FLASH_ATOL} of the twin on its own inputs "
          f"({len(layers)} checked, max {extra['lm_layers_max_abs_err']}, "
          f"{extra['lm_layers_share_of_tol']:.3f} of the tolerance)")
    check(torch.equal(again, logits), "the checked prefill gives the bits")
    extra["lm_layer_fault_share_of_tol"] = faults
    check(len(faults) == 2 and all(v > 1 for v in faults.values()),
          f"the per-launch check rejects the planted faults on the path's "
          f"own inputs: {faults}")
    del again

    # the whole prefill with the twin in every layer, and with the twin
    # carrying a planted fault: the cap left off, the window one key too
    # wide, every query head on the next kv head
    def twin(cap=True, window_plus=0, kv_shift=0):
        def fn(q, k, v, *, window=None, logit_cap=None, **kw):
            return flash_attention_plain(
                q, k.roll(kv_shift, dims=1), v.roll(kv_shift, dims=1),
                window=None if window is None else window + window_plus,
                logit_cap=logit_cap if cap else None, **kw)
        return fn
    runs = {"twin": twin(), "no_cap": twin(cap=False),
            "window_plus_1": twin(window_plus=1), "kv_shift": twin(kv_shift=1)}
    errs = {}
    for key, fn in runs.items():
        transformer.flash_attention_bhsd = fn
        t0 = time.perf_counter()
        plain = cell.step()
        torch.cuda.synchronize()
        extra[f"lm_{key}_prefill_s"] = time.perf_counter() - t0
        transformer.flash_attention_bhsd = kernel_fn
        errs[key] = float((logits.float() - plain.float()).abs().max())
        extra[f"lm_kernel_vs_{key}_logit_max_abs_err"] = errs[key]
        extra[f"lm_kernel_vs_{key}_argmax_equal"] = bool(torch.equal(
            logits.argmax(-1), plain.argmax(-1)))
        del plain
    check(errs["twin"] <= PATH_TOL < errs["kv_shift"],
          f"prefill logits with the kernel within {PATH_TOL} of the twin's "
          f"({errs['twin']}), the next-kv-head fault outside "
          f"({errs['kv_shift']})")

    # the smoke model (float32) at 64 tokens: card == CPU within 1e-4
    small = lm_prefill_cell(LM_ARCH, seq_len=64, batch=2, device="cpu",
                            seed=seed, smoke=True)
    want = small.step()
    got = transformer.lm_prefill(small.model.to(dev), small.tokens.to(dev))
    err = float((got.cpu() - want).abs().max())
    extra["lm_smoke_card_vs_cpu_max_abs_err"] = err
    check(torch.allclose(got.cpu(), want, rtol=1e-4, atol=1e-4)
          and torch.equal(got.argmax(-1).cpu(), want.argmax(-1)),
          f"smoke prefill card vs CPU within 1e-4 ({err})")


def long_prefill(cell, seed):
    """One prefill of LM_LONG_SEQ tokens on the same model (the cell's
    full sequence), timed on the host clock."""
    import numpy as np
    import torch
    from repro_torch.launch.steps import PrefillCell

    toks = np.random.default_rng(seed).integers(
        0, cell.model.cfg.vocab, (LM_BATCH, LM_LONG_SEQ)).astype(np.int32)
    long = PrefillCell(cell.arch_id, cell.model,
                       torch.from_numpy(toks).to(cell.tokens.device))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits = long.step()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(bool(torch.isfinite(logits.float()).all()), "finite long logits")
    return dict(tokens=LM_LONG_SEQ, seconds=dt,
                tokens_per_s=LM_BATCH * LM_LONG_SEQ / dt,
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)


# ------------------------------------------------------------ phase 9a
def decode_ratio(got, want, tol):
    """The worst |got − want| / tol (0 where they are equal)."""
    import torch
    diff = (got.double() - want.double()).abs()
    return float(torch.where(diff == 0, 0.0, diff / tol).max())


def decode_fault(q, k, v, lens, kw, fault):
    """The decode twin with one planted fault: the cap left out, one
    position more, every query head on the next kv head, or the int8
    cache widened to float32 without the bf16 rounding."""
    from repro_torch.models.attention import decode_attention_plain
    if fault == "no_cap":
        return decode_attention_plain(q, k, v, lens,
                                      **{**kw, "logit_cap": None})
    if fault == "len_plus_1":
        return decode_attention_plain(q, k, v, lens + 1, **kw)
    if fault == "next_kv_head":
        return decode_attention_plain(
            q, k.roll(1, 1), v.roll(1, 1), lens, logit_cap=kw["logit_cap"],
            **{n: None if kw[n] is None else kw[n].roll(1, 1)
               for n in ("k_scale", "v_scale")})
    return decode_attention_plain(q, k.float() * kw["k_scale"],
                                  v.float() * kw["v_scale"], lens,
                                  logit_cap=kw["logit_cap"])


class swapped_decode:
    """``models.transformer.decode_attention`` replaced by ``fn`` inside a
    ``with`` block."""

    def __init__(self, fn):
        self.fn = fn

    def __enter__(self):
        from repro_torch.models import transformer
        self.real = transformer.decode_attention
        transformer.decode_attention = self.fn

    def __exit__(self, *exc):
        from repro_torch.models import transformer
        transformer.decode_attention = self.real


def lm_serve_requests(seed, vocab):
    import numpy as np
    rng = np.random.default_rng(seed + 1)
    return [(rng.integers(0, vocab, int(rng.integers(
        LM_SERVE_PROMPTS[0], LM_SERVE_PROMPTS[1] + 1))).tolist(),
        int(rng.integers(LM_SERVE_GEN[0], LM_SERVE_GEN[1] + 1)))
        for _ in range(LM_SERVE_REQUESTS)]


def serve_lm(eng, reqs):
    """``reqs`` ((prompt, max_new) pairs) served to the end of the stream
    through ``eng``, which is reopened after; (handles, wall seconds)."""
    import torch
    t0 = time.perf_counter()
    handles = [eng.submit(p, g) for p, g in reqs]
    eng.close_submissions()
    completed = eng.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    eng.reopen()
    check(len(completed) == len(reqs), "every LM request retired")
    return handles, dt


def lm_serve_path(dev, seed, model=None):
    """An LM in a ServeEngine (gemma2-9b at full width, its weights from
    the seed, unless ``model`` is given): a warm-up request (the step
    captured), launch counters to 0, the 16 requests served, counters
    read."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import percentile
    from repro_torch.models.transformer import LM
    from repro_torch.serve import ServeEngine

    out = {}
    t0 = time.perf_counter()
    if model is None:
        model = LM(get_config(LM_ARCH), seed=seed, device=dev)
    cfg = model.cfg
    out["params"] = sum(p.numel() for p in model.parameters())
    out["weights_gib"] = torch.cuda.memory_allocated() / 2**30
    eng = ServeEngine(cfg, model, n_slots=LM_SERVE_SLOTS,
                      max_len=LM_SERVE_MAX_LEN,
                      prompt_cap=LM_SERVE_PROMPT_CAP, device=dev)
    out["cache_gib"] = sum(t.numel() * t.element_size()
                           for c in eng.state["cache"].values()
                           for t in c.values()) / 2**30
    serve_lm(eng, [([1, 2, 3], 2)])  # the warm-up: the step captured
    torch.cuda.synchronize()
    out["setup_s"] = time.perf_counter() - t0
    check(eng.step_cache_size() == 1, "one step program after warm-up")
    out["captured_launches"] = eng.captured_launches()

    reqs = lm_serve_requests(seed, cfg.vocab)
    # the counted run, each step between two CUDA events: a step's events
    # measure its replay alone (the start fires when the stream reaches
    # it), so their sum over the run is the device's busy time (a
    # profiler trace of the run's ~10^6 kernels costs minutes to read)
    st0 = dataclasses.replace(eng.stats)
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    pairs, step = [], eng._step

    def timed():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        emitted = step()
        end.record()
        pairs.append((start, end))
        return emitted
    eng._step = timed
    try:
        handles, dt = serve_lm(eng, reqs)
    finally:
        del eng._step
    out["launches"] = launch_counts()
    out["stream_device_ms"] = sum(a.elapsed_time(b) for a, b in pairs)
    out["stream_busy_share"] = out["stream_device_ms"] / (dt * 1e3)
    out["peak_alloc_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["peak_reserved_gib"] = torch.cuda.max_memory_reserved() / 2**30
    steps = eng.stats.steps - st0.steps
    proc = eng.stats.tokens_processed - st0.tokens_processed
    gen = eng.stats.tokens_generated - st0.tokens_generated
    adm = [h.admission_latency_s for h in handles]
    tot = [h.total_latency_s for h in handles]
    out["serve"] = dict(
        requests=len(reqs), prompt_tokens=sum(len(p) for p, _ in reqs),
        new_tokens=sum(g for _, g in reqs), steps=steps, wall_s=dt,
        tokens_processed=proc, tokens_generated=gen,
        tok_s_processed=proc / dt, tok_s_generated=gen / dt,
        admission_p50_ms=percentile(adm, 0.5) * 1e3,
        admission_p99_ms=percentile(adm, 0.99) * 1e3,
        latency_p50_ms=percentile(tot, 0.5) * 1e3,
        latency_p99_ms=percentile(tot, 0.99) * 1e3,
        step_programs=eng.step_cache_size())
    check(all(len(h.tokens_out) == g for h, (_, g) in zip(handles, reqs))
          and all(0 <= t < cfg.vocab for h in handles for t in h.tokens_out),
          "every request retired with its budget of tokens, each in "
          f"[0, {cfg.vocab})")
    check(eng.step_cache_size() == 1, "one step program after the stream")
    want = DECODE_LAUNCHES * cfg.n_layers
    check(out["captured_launches"] == {"decode_attention": want}
          and out["launches"]["decode_attention"] == want * steps,
          f"{want} decode_attention launches a step ({steps} steps): "
          f"{out['captured_launches']}, {out['launches']}")
    check(all(v == 0 for k, v in out["launches"].items()
              if k not in LM_SERVE_KERNELS),
          f"no other kernel on the LM serve path (flash included): "
          f"{out['launches']}")
    return out, eng, reqs, handles


def lm_step_timing(eng, out):
    """The captured step replayed LM_SERVE_TIMED times on the state the
    stream left (each slot at its last occupant's position): its wall time
    (host clock, a synchronise each), its device time (CUDA events around
    back-to-back replays), one replay under the profiler."""
    import statistics

    import torch
    walls = []
    for _ in range(LM_SERVE_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._run_step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(LM_SERVE_TIMED):
        eng._run_step()
    end.record()
    end.synchronize()
    out["step_wall_ms"] = statistics.median(walls)
    out["step_device_ms"] = start.elapsed_time(end) / LM_SERVE_TIMED
    prof = profile_call(eng._run_step, top=10, kernels=DECODE_KERNEL_RE)
    out["step_profile"] = dict(tokens=eng.n_slots, **prof)
    trace = {k: v["count"] for k, v in prof["kernels"].items()}
    n = eng.cfg.n_layers
    check(trace == {"decode_split_kernel": n, "decode_combine_kernel": n},
          f"a replay's trace shows both decode kernels {n} times, the "
          f"launches a replay counts ({eng.captured_launches()}): {trace}")


def lm_slot_independence(eng, reqs, handles, n=LM_SERVE_ALONE):
    """The first ``n`` requests, each served alone through the same
    engine: the stream's tokens, bit for bit; still one program."""
    for i in range(n):
        [alone], _ = serve_lm(eng, [reqs[i]])
        check(alone.tokens_out == handles[i].tokens_out,
              f"request {i} alone gives the stream's tokens")
    check(eng.step_cache_size() == 1, "one step program after the "
          "requests served alone")


def lm_batch1_check(eng, reqs, extra):
    """The LM_SERVE_B1 shortest requests served together through the
    engine, each replay's logits read after it (a synchronise a step);
    then a batch-1 lm_decode_step loop a request, teacher-forced on the
    prompt and the engine's tokens: its logits within B1_LOGIT_TOL of the
    engine's at every step, its argmax the engine's token wherever its
    top-2 margin exceeds that."""
    import torch
    from repro_torch.models.transformer import lm_decode_step, make_cache

    idx = sorted(range(len(reqs)),
                 key=lambda i: len(reqs[i][0]) + reqs[i][1])[:LM_SERVE_B1]
    rows = {}
    step = eng._step

    def traced():
        emitted = step()
        torch.cuda.synchronize()
        logits = eng.last_logits()
        for slot, req in enumerate(eng.scheduler._slots):
            if req is not None:
                rows.setdefault(req.rid, []).append(logits[slot].clone())
        return emitted
    eng._step = traced
    try:
        handles, _ = serve_lm(eng, [reqs[i] for i in idx])
    finally:
        del eng._step
    worst, compared, skipped = 0.0, 0, 0
    for h, i in zip(handles, idx):
        prompt = reqs[i][0]
        seq = prompt + h.tokens_out[:-1]
        got = rows[h.rid][:len(seq)]
        check(len(got) == len(seq), f"the engine ran request {i} "
              f"{len(seq)} steps ({len(got)})")
        cache = make_cache(eng.cfg, batch=1, max_len=eng.max_len,
                           device=eng.device)
        for t, tok in enumerate(seq):
            _, lg = lm_decode_step(
                eng.params, cache, torch.tensor([[tok]], dtype=torch.int32,
                                                device=eng.device), t,
                return_logits=True)
            lg = lg[0].float()
            worst = max(worst, float((lg - got[t].float()).abs().max()))
            if t < len(prompt) - 1:
                continue
            top = torch.topk(lg, 2).values
            if float(top[0] - top[1]) > B1_LOGIT_TOL:
                compared += 1
                check(int(lg.argmax()) == h.tokens_out[t - len(prompt) + 1],
                      f"request {i} step {t}: the batch-1 argmax is the "
                      "engine's token where the margin clears the tolerance")
            else:
                skipped += 1
    extra["lm_b1_logit_max_abs_err"] = worst
    extra["lm_b1_tokens_compared"] = compared
    extra["lm_b1_tokens_within_margin"] = skipped
    check(worst <= B1_LOGIT_TOL, f"batch-1 logits within {B1_LOGIT_TOL} of "
          f"the engine's at every step ({worst})")


def lm_decode_checks(eng, tag, extra):
    """One decode step on the engine's own cache (the slots' last tokens at
    their positions): each layer's kernel launch against the twin on its
    own inputs within ``twin_tolerance``; the step's logits against the
    same step with the twin in every layer within DECODE_PATH_TOL, and
    with every query head on the next kv head outside it; on the first
    local and global layers' inputs, with a float32 q and the lengths one
    less, the kernel within the tolerance and the four planted faults
    outside it (the cap's and the int8 cache's faults where the config
    has a cap and an int8 cache). Returns the first two layers' recorded
    inputs (gemma2: the first local and global layers)."""
    import torch
    from repro_torch.kernels.decode_attention import decode_attention as kernel
    from repro_torch.kernels.decode_attention import twin_tolerance
    from repro_torch.models.attention import decode_attention_plain
    from repro_torch.models.transformer import lm_decode_step

    st = eng.state
    toks, pos = st["last_tok"][:, None].clone(), st["pos"].clone()
    layers, saved = [], []

    def step(fn):
        with swapped_decode(fn):
            _, logits = lm_decode_step(eng.params, st["cache"], toks, pos,
                                       return_logits=True)
        return logits.float()

    def checked(q, k, v, cache_len, **kw):
        got = kernel(q, k, v, cache_len, **kw)
        want = decode_attention_plain(q, k, v, cache_len, **kw)
        tol = twin_tolerance(q, k, v, cache_len, **kw)
        layers.append((decode_ratio(got, want, tol),
                       float((got.float() - want.float()).abs().max())))
        if len(saved) < 2:
            saved.append((q.clone(), k.clone(), v.clone(), cache_len.clone(),
                          {n: t.clone() if torch.is_tensor(t) else t
                           for n, t in kw.items()}))
        return got
    logits = step(checked)
    n_layers = eng.cfg.n_layers
    extra[f"{tag}_layers_share_of_tol"] = max(r for r, _ in layers)
    extra[f"{tag}_layers_max_abs_err"] = max(e for _, e in layers)
    check(len(layers) == n_layers and all(r <= 1.0 for r, _ in layers),
          f"{tag}: each of the step's {n_layers} decode launches within "
          f"twin_tolerance of the twin on its own inputs ({len(layers)} "
          f"checked, worst {extra[f'{tag}_layers_share_of_tol']:.4f} of it)")
    twin = step(decode_attention_plain)
    shifted = step(lambda q, k, v, cl, **kw: decode_fault(
        q, k, v, cl, kw, "next_kv_head"))
    err = float((logits - twin).abs().max())
    fault = float((logits - shifted).abs().max())
    extra[f"{tag}_kernel_vs_twin_logit_max_abs_err"] = err
    extra[f"{tag}_kernel_vs_twin_argmax_equal"] = bool(torch.equal(
        logits.argmax(-1), twin.argmax(-1)))
    extra[f"{tag}_kernel_vs_kv_shift_logit_max_abs_err"] = fault
    check(err <= DECODE_PATH_TOL < fault,
          f"{tag}: decode step logits with the kernel within "
          f"{DECODE_PATH_TOL} of the twin's ({err}), the next-kv-head fault "
          f"outside ({fault})")
    shares = {}
    for li, (q, k, v, cl, kw) in enumerate(saved):
        # one position less, so that one more reads a row of the current
        # occupant; with several slots the first at length 1 (a request's
        # first token: the output is v's row itself)
        lens = torch.clamp(cl - 1, min=1)
        if lens.numel() > 1:
            lens[0] = 1
        # the cap's and the int8 cache's faults where the config has them
        scaled = tuple(f for f, has in (("no_cap", kw["logit_cap"]),
                                        ("dequant_f32", kw["k_scale"]))
                       if has is not None)
        for scale, faults in ((DECODE_Q_SCALE, scaled),
                              (1.0, ("len_plus_1", "next_kv_head"))):
            qf = q.float() * scale
            got = kernel(qf, k, v, lens, **kw)
            tol = twin_tolerance(qf, k, v, lens, **kw)
            sound = decode_ratio(
                got, decode_attention_plain(qf, k, v, lens, **kw), tol)
            shares[f"layer{li}_q{scale:g}_sound"] = sound
            check(sound <= 1.0, f"{tag} layer {li} (float32 q x {scale}): "
                  f"the kernel within the tolerance ({sound})")
            for f in faults:
                shares[f"layer{li}_{f}"] = r = decode_ratio(
                    got, decode_fault(qf, k, v, lens, kw, f), tol)
                check(r > 1.0, f"{tag} layer {li}: the tolerance rejects "
                      f"the planted fault {f} ({r})")
    extra[f"{tag}_fault_share_of_tol"] = shares
    return saved


def decode_row(q, k, v, cl, kw, err):
    """Row 15 at these inputs (a layer's own): the kernel, the twin and
    scaled_dot_product_attention on the (dequantized) bf16 cache with a
    boolean mask, each timed (without a cap SDPA on a bf16 cache is the
    same function, else a near one); the bound from the live positions'
    cache bytes (and int8 scales), q read, the output written."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.models.attention import (decode_attention_plain,
                                              decode_mask, dequantize_kv)
    b, h, _, dh = q.shape
    hkv, s = k.shape[1], k.shape[2]
    ms = cuda_ms(lambda: decode_attention(q, k, v, cl, **kw))
    plain_ms = cuda_ms(lambda: decode_attention_plain(q, k, v, cl, **kw),
                       iters=3, warmup=1)
    int8 = kw["k_scale"] is not None
    kd, vd = ((dequantize_kv(c, kw[f"{n}_scale"]) if int8 else c)
              .to(q.dtype).repeat_interleave(h // hkv, 1)
              for c, n in ((k, "k"), (v, "v")))
    mask = decode_mask(cl, s)[:, None, None, :]
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, kd, vd, attn_mask=mask))
    del kd, vd
    live = int(torch.clamp(cl, max=s).sum())
    row_bytes = 2 * dh * k.element_size() + (2 * 4 if int8 else 0)
    nbytes = live * hkv * row_bytes + 2 * q.numel() * q.element_size()
    exact = not int8 and kw["logit_cap"] is None
    b_ms, b_by = bound(nbytes, 4 * dh * (h // hkv) * live * hkv)
    return dict(name="decode_attention", route="cuda",
                source="src/repro_torch/csrc/decode_attention.cu",
                replaces="src/repro/models/attention.py:207",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms,
                gbytes_per_s=nbytes / (ms * 1e-3) / 1e9,
                ptxas=resource_usage("decode_attention",
                                     "decode_split_kernel"),
                sass=sass_ops("decode_attention", "decode_split_kernel",
                              DECODE_SASS_OPS),
                shape=f"B {b}, H {h} over Hkv {hkv}, dh {dh}, "
                      f"{'int8' if int8 else 'bf16'} cache of "
                      f"{s} positions, {live} live ({cl.tolist()}), {q.dtype}"
                      f" q, cap {kw['logit_cap']}; {nbytes / 1e6:.2f} MB "
                      "(library: scaled_dot_product_attention on the "
                      + ("bf16 cache, a boolean mask: the same function)"
                         if exact else "dequantized bf16 cache, a boolean "
                         "mask, no cap: a near function)"))


def lm_smoke_serve(dev, seed, extra):
    """The smoke model served on the card and on the CPU, bf16 and int8
    caches: the same tokens for the same requests."""
    import copy

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import LM
    from repro_torch.serve import ServeEngine
    rng = np.random.default_rng(seed + 3)
    reqs = [(rng.integers(0, 256, int(rng.integers(1, 17))).tolist(),
             int(rng.integers(1, 20))) for _ in range(9)]
    for kv in ("bf16", "int8"):
        cfg = dataclasses.replace(get_config(LM_ARCH, smoke=True),
                                  kv_cache_dtype=kv)
        base = LM(cfg, seed=seed, device="cpu")
        outs = []
        for d in ("cpu", dev):
            eng = ServeEngine(cfg, copy.deepcopy(base).to(d), n_slots=4,
                              max_len=64, prompt_cap=16, device=d)
            for p, g in reqs:
                eng.submit(p, g)
            eng.close_submissions()
            outs.append({r.rid: r.tokens_out for r in eng.run()})
        extra[f"lm_serve_smoke_{kv}_tokens"] = sum(map(len, outs[0].values()))
        check(outs[0] == outs[1], f"the smoke model ({kv} cache) served on "
              "the card gives the CPU's tokens")


def lm_ring_phase(dev, seed, extra):
    """gemma2-9b cut to one (local, global) pair: one request of
    RING_PROMPT prompt tokens and RING_GEN new ones in a cache of
    RING_MAX_LEN positions, so the local ring (4,096) wraps; then the
    checks of ``lm_decode_checks`` on the wrapped cache."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import LM
    from repro_torch.serve import ServeEngine
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=2)
    eng = ServeEngine(cfg, LM(cfg, seed=seed + 5, device=dev), n_slots=1,
                      max_len=RING_MAX_LEN, prompt_cap=RING_MAX_LEN,
                      device=dev)
    ring = eng.state["cache"]["local"]["k"].shape[3]
    prompt = np.random.default_rng(seed + 7).integers(
        0, cfg.vocab, RING_PROMPT).tolist()
    [h], dt = serve_lm(eng, [(prompt, RING_GEN)])
    pos = int(eng.state["pos"][0])
    out = dict(ring=ring, steps=eng.stats.steps, wall_s=dt, final_pos=pos,
               step_programs=eng.step_cache_size())
    check(ring == cfg.sliding_window < pos and len(h.tokens_out) == RING_GEN
          and eng.step_cache_size() == 1,
          f"the local ring ({ring}) wrapped: the request reached position "
          f"{pos} and got {len(h.tokens_out)} tokens through one program")
    saved = lm_decode_checks(eng, "lm_ring", extra)
    local_len = int(saved[0][3][0])
    check(saved[0][1].shape[2] == ring and local_len == ring,
          f"the local layer attends its whole ring ({local_len} of {ring})")
    out["local_len"], out["global_len"] = local_len, int(saved[1][3][0])
    extra["lm_ring"] = out
    del eng, saved
    torch.cuda.empty_cache()


def fill_cache(cache, cfg, g):
    """A cache made random by the generator ``g``: int8 values and scales
    in [0.005, 0.03), or bf16 N(0, 1)."""
    for c in cache.values():
        for name in ("k", "v"):
            if cfg.kv_cache_dtype != "int8":
                c[name].normal_(generator=g)
                continue
            c[name].random_(-127, 128, generator=g)
            c[f"{name}_scale"].uniform_(0.005, 0.03, generator=g)


def decode_32k_phase(dev, seed, model, extra, batch=DECODE_32K_BATCH,
                     tag="decode_32k"):
    """One lm_decode_step at scalar position DECODE_32K_LEN - 1, ``batch``
    rows, the cache random from the seed (int8 values and scales, or bf16
    N(0, 1)): the step timed (host clock and profiler), the kernel on its
    first layer of the full length timed beside its bound, the twin and
    SDPA, and held against the twin on DECODE_32K_CHECKED slots."""
    import statistics

    import torch
    from repro_torch.kernels.decode_attention import decode_attention as kernel
    from repro_torch.kernels.decode_attention import twin_tolerance
    from repro_torch.models.attention import decode_attention_plain
    from repro_torch.models.transformer import lm_decode_step, make_cache
    cfg = model.cfg
    b, pos = batch, DECODE_32K_LEN - 1
    cache = make_cache(cfg, batch=b, max_len=DECODE_32K_LEN, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed + 32)
    fill_cache(cache, cfg, g)
    toks = torch.randint(0, cfg.vocab, (b, 1), generator=g, device=dev,
                         dtype=torch.int32)
    out = dict(cache_gib=sum(t.numel() * t.element_size()
                             for c in cache.values()
                             for t in c.values()) / 2**30)
    saved = []

    def rec(q, k, v, cl, **kw):
        if not saved and k.shape[2] == DECODE_32K_LEN:
            saved.append((q.clone(), k, v, cl.clone(), kw))
        return kernel(q, k, v, cl, **kw)
    with swapped_decode(rec):
        lm_decode_step(model, cache, toks, pos)
    torch.cuda.synchronize()
    walls = []
    for _ in range(DECODE_32K_TIMED):
        t0 = time.perf_counter()
        lm_decode_step(model, cache, toks, pos)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    out["step_wall_ms"] = statistics.median(walls)
    out["step_profile"] = dict(tokens=b, **profile_call(
        lambda: lm_decode_step(model, cache, toks, pos), top=10))
    q, k, v, cl, kw = saved[0]
    got = kernel(q, k, v, cl, **kw)
    n = DECODE_32K_CHECKED
    sub = {k_: t[:n] if torch.is_tensor(t) else t for k_, t in kw.items()}
    want = decode_attention_plain(q[:n], k[:n], v[:n], cl[:n], **sub)
    share = decode_ratio(got[:n], want, twin_tolerance(q[:n], k[:n], v[:n],
                                                       cl[:n], **sub))
    err = float((got[:n].float() - want.float()).abs().max())
    out["kernel_share_of_tol"] = share
    check(share <= 1.0, f"{tag}: the kernel within twin_tolerance of "
          f"the twin on {n} slots ({share})")
    del want, got
    out["row"] = decode_row(q, k, v, cl, kw, err)
    extra[tag] = out
    del cache, saved
    torch.cuda.empty_cache()
    return out


def lm_serve_phase(dev, seed, extra, mesh=None):
    """Phase 9a: the LM serve path and its checks (see the docstring);
    with ``mesh``, 13c's serve on it."""
    import torch
    out, eng, reqs, handles = lm_serve_path(dev, seed)
    lm_step_timing(eng, out)
    lm_slot_independence(eng, reqs, handles)
    lm_batch1_check(eng, reqs, extra)
    if mesh is not None:
        lm_mesh_serve(eng, seed, reqs, handles, mesh, out)
    saved = lm_decode_checks(eng, "lm_decode", extra)
    q, k, v, cl, kw = saved[1]  # the first global layer
    out["row"] = decode_row(q, k, v, cl, kw,
                            extra["lm_decode_layers_max_abs_err"])
    model = eng.params
    del eng, saved, q, k, v
    gc.collect()
    torch.cuda.empty_cache()
    out["decode_32k"] = decode_32k_phase(dev, seed, model, extra)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    lm_ring_phase(dev, seed, extra)
    lm_smoke_serve(dev, seed, extra)
    return out


# ------------------------------------------------------------ phase 9b
def flash_row(q, k, v, kw, err):
    """Row 12 at these inputs (a prefill layer's own, bf16): the forward
    kernel, the twin and scaled_dot_product_attention (causal; without a
    cap or a window the same function), each timed; the bound from the
    causal pairs' bf16 FLOPs or q, k, v read and the output written."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.models.attention import flash_attention_plain
    b, h, seq, dh = q.shape
    hkv = k.shape[1]
    mask = dict(causal=True, window=kw["window"],
                logit_cap=kw["logit_cap"], q_offset=0)
    ms = cuda_ms(lambda: tfa._fwd_kernel(q, k, v, lse=False, **mask),
                 iters=5, warmup=1)
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, **kw),
                       iters=3, warmup=1)
    k_rep = k.repeat_interleave(h // hkv, dim=1)
    v_rep = v.repeat_interleave(h // hkv, dim=1)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k_rep, v_rep, is_causal=True), iters=5, warmup=1)
    del k_rep, v_rep
    pairs = b * causal_pairs(seq, kw["window"])
    flops = 4 * dh * pairs * h
    b_ms, b_by = bound(2 * b * seq * dh * (2 * h + 2 * hkv), flops,
                       BF16_FLOPS_PER_S)
    exact = kw["window"] is None and kw["logit_cap"] is None
    return dict(name="flash_attention_fwd", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:80",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms,
                tflops=flops / (ms * 1e-3) / 1e12,
                shape=f"B {b}, H {h} over Hkv {hkv}, dh {dh}, {seq} tokens, "
                      f"{q.dtype}, causal, window {kw['window']}, cap "
                      f"{kw['logit_cap']}; {flops:.3e} FLOPs (library: "
                      "scaled_dot_product_attention, causal"
                      + (": the same function)" if exact else
                         ", no cap, no window: a near function)"))


def rank_scan_row(dev, seed, pairs, experts):
    """``moe_route``'s rank scan at a prefill's (token, expert) pairs: the
    exclusive prefix sum of the [pairs, E] int32 one-hot down its leading
    axis (the reference's form) against the same scan along the
    transpose's last axis (the port's): equal integers, each timed. The
    expert ids are random from the seed (the scan's work does not depend
    on them)."""
    import torch
    from repro_torch.core.set_partition import prefix_sum
    g = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(0, experts, (pairs,), generator=g, device=dev)
    onehot = (ids[:, None] == torch.arange(experts, device=dev)[None, :]
              ).to(torch.int32)

    def leading():
        return prefix_sum(onehot, axis=0, exclusive=True)

    def transposed():
        return prefix_sum(onehot.t().contiguous(), axis=1,
                          exclusive=True).t()
    check(torch.equal(leading(), transposed()),
          f"the rank scan along the transpose equals the leading-axis scan "
          f"at {pairs} pairs x {experts} experts")
    return dict(pairs=pairs, experts=experts,
                leading_ms=cuda_ms(leading, iters=3, warmup=1),
                transposed_ms=cuda_ms(transposed, iters=20, warmup=3))


def lm_config_prefill(dev, seed, model, seq, tag, extra):
    """Launch counters to 0, one prefill of ``seq`` tokens (batch 1, tokens
    from the seed), counters read; a second prefill for the bits and the
    steady time; a third with each flash launch held against the twin on
    its own inputs (within FLASH_RTOL / FLASH_ATOL), the first launch's
    inputs kept for row 12; under MoE one more prefill profiled."""
    import numpy as np
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import transformer
    from repro_torch.models.attention import flash_attention_plain

    cfg = model.cfg
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (1, seq)).astype(np.int32)).to(dev)
    out = dict(tokens=seq)
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits = transformer.lm_prefill(model, toks)
    torch.cuda.synchronize()
    out["first_s"] = time.perf_counter() - t0
    out["launches"] = launch_counts()
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    t0 = time.perf_counter()
    again = transformer.lm_prefill(model, toks)
    torch.cuda.synchronize()
    out["steady_s"] = time.perf_counter() - t0
    out["tokens_per_s"] = seq / out["steady_s"]
    check(torch.equal(logits, again), f"{tag}: two prefills give the same "
          "bits")
    check(tuple(logits.shape) == (1, cfg.vocab)
          and bool(torch.isfinite(logits.float()).all()),
          f"{tag}: finite prefill logits [1, {cfg.vocab}]")
    check(out["launches"]["flash_attention_fwd"] == cfg.n_layers
          and all(v == 0 for k, v in out["launches"].items()
                  if k not in LM_KERNELS),
          f"{tag}: {cfg.n_layers} flash launches in one prefill and no "
          f"other kernel: {out['launches']}")

    kernel_fn = transformer.flash_attention_bhsd
    layers, first = [], []

    def checked(q, k, v, **kw):
        got = kernel_fn(q, k, v, **kw)
        layers.append(flash_close(got, flash_attention_plain(q, k, v, **kw)))
        if not first:
            first.append((q.clone(), k.clone(), v.clone(), kw))
        return got
    transformer.flash_attention_bhsd = checked
    try:
        third = transformer.lm_prefill(model, toks)
    finally:
        transformer.flash_attention_bhsd = kernel_fn
    err = max(e for _, e, _ in layers)
    extra[f"{tag}_prefill_layers_max_abs_err"] = err
    extra[f"{tag}_prefill_layers_share_of_tol"] = max(
        sh for _, _, sh in layers)
    # each launch's share of the tolerance in layer order: how close the
    # new head shapes come to its edge
    extra[f"{tag}_prefill_layers_shares"] = [round(sh, 4)
                                             for _, _, sh in layers]
    check(len(layers) == cfg.n_layers and all(ok for ok, _, _ in layers)
          and torch.equal(third, logits),
          f"{tag}: each of the prefill's {cfg.n_layers} flash launches "
          f"within rtol {FLASH_RTOL} atol {FLASH_ATOL} of the twin on its "
          f"own inputs ({len(layers)} checked, max {err}, "
          f"{extra[f'{tag}_prefill_layers_share_of_tol']:.3f} of the "
          "tolerance), the same bits")
    del logits, again, third
    if cfg.is_moe:  # where the MoE dispatch's time goes at full length
        out["profile"] = dict(tokens=seq, **profile_call(
            lambda: transformer.lm_prefill(model, toks), top=10))
        out["rank_scan"] = rank_scan_row(dev, seed, seq * cfg.moe_top_k,
                                         cfg.moe_experts)
    q, k, v, kw = first[0]
    out["row"] = flash_row(q, k, v, kw, err)
    return out


def lm_config_phase(dev, seed, arch, layers, seq, batch_32k, alone, extra):
    """Phase 9b for one LM config (see LM_CONFIG_RUNS): the model built
    from the seed at full width (its depth cut to ``layers`` when given),
    the prefill path, the serve path of phase 9a with its step timing, a
    profiled replay, slot independence on ``alone`` requests, the decode
    checks and row 15 on the first layer's inputs, and decode_32k's
    length at ``batch_32k`` rows. The model is freed after."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import LM

    tag = "lm_" + arch.split("-")[0].replace(".", "")
    cfg = get_config(arch)
    published = cfg.n_layers
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    out = dict(arch=arch, tag=tag, layers=cfg.n_layers,
               published_layers=published, prefill_tokens=seq,
               decode_32k_batch=batch_32k, served_alone=alone,
               heads=f"{cfg.n_heads} over {cfg.n_kv_heads}, dh {cfg.dh}",
               kv_cache=cfg.kv_cache_dtype, moe=cfg.is_moe,
               qkv_bias=cfg.qkv_bias)
    t0 = time.perf_counter()
    model = LM(cfg, seed=seed, device=dev)
    if cfg.qkv_bias:  # lm_init's zero biases would leave the adds unseen
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        with torch.no_grad():
            for blk in model.layers:
                for b in (blk.bq, blk.bk, blk.bv):
                    b.copy_(QKV_BIAS_STD * torch.randn(
                        b.shape, generator=g, device=dev))
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    out["params"] = sum(p.numel() for p in model.parameters())
    out["weights_gib"] = torch.cuda.memory_allocated() / 2**30
    out["prefill"] = lm_config_prefill(dev, seed, model, seq, tag, extra)
    gc.collect()
    torch.cuda.empty_cache()

    sout, eng, reqs, handles = lm_serve_path(dev, seed, model=model)
    lm_step_timing(eng, sout)
    if alone:
        lm_slot_independence(eng, reqs, handles, alone)
    saved = lm_decode_checks(eng, tag, extra)
    q, k, v, cl, kw = saved[0]
    sout["row"] = decode_row(q, k, v, cl, kw,
                             extra[f"{tag}_layers_max_abs_err"])
    out["serve"] = sout
    del eng, saved, q, k, v
    gc.collect()
    torch.cuda.empty_cache()
    if batch_32k:
        out["decode_32k"] = decode_32k_phase(dev, seed, model, extra,
                                             batch=batch_32k,
                                             tag=f"{tag}_decode_32k")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def log_lm_config(out, extra):
    tag, pf, sv = out["tag"], out["prefill"], out["serve"]
    cut = ("at its published depth" if out["layers"] == out["published_layers"]
           else f"depth cut from {out['published_layers']} to "
                f"{out['layers']} layers")
    bias = (f"; qkv biases drawn N(0, {QKV_BIAS_STD}^2) from the seed"
            if out["qkv_bias"] else "")
    log(f"[{tag}] {out['arch']} at full width, {cut}: {out['params']:,} "
        f"parameters ({out['weights_gib']:.2f} GiB), heads {out['heads']}, "
        f"{out['kv_cache']} KV cache, MoE {out['moe']}{bias}; built in "
        f"{out['build_s']:.2f}s")
    log(f"[{tag}] prefill of 1 x {pf['tokens']} tokens (prefill_32k cut "
        f"from 32 x 32,768): first {pf['first_s']:.3f}s, second "
        f"{pf['steady_s']:.3f}s ({pf['tokens_per_s']:.1f} tokens/s); peak "
        f"{pf['peak_mem_gib']:.2f} GiB; flash launches "
        f"{pf['launches']['flash_attention_fwd']}; each within the bf16 "
        f"tolerance of the twin (max "
        f"{extra[f'{tag}_prefill_layers_max_abs_err']}, "
        f"{extra[f'{tag}_prefill_layers_share_of_tol']:.3f} of it)")
    shares = sorted(extra[f"{tag}_prefill_layers_shares"])
    log(f"[{tag}] the flash launches' shares of the tolerance, in layer "
        f"order: {extra[f'{tag}_prefill_layers_shares']}; min "
        f"{shares[0]}, median {shares[len(shares) // 2]}, max {shares[-1]},"
        f" {sum(sh >= 0.99 for sh in shares)} of {len(shares)} at 0.99 or "
        "more")
    log_row(f"flash_attention_fwd ({tag})", pf["row"])
    if "profile" in pf:
        log_profile(f"{tag} prefill profile", pf["profile"])
        rs = pf["rank_scan"]
        log(f"[{tag} prefill profile] moe_route's rank scan at "
            f"{rs['pairs']} pairs x {rs['experts']} experts (int32 one-hot),"
            f" one layer: down the leading axis {rs['leading_ms']:.4f} ms, "
            f"along the transpose's last axis {rs['transposed_ms']:.4f} ms "
            "(the port's), equal integers")
    st = sv["serve"]
    log(f"[{tag} serve] {st['requests']} requests ({st['prompt_tokens']} "
        f"prompt tokens, {st['new_tokens']} new) through "
        f"ServeEngine({LM_SERVE_SLOTS} slots, {LM_SERVE_MAX_LEN} positions, "
        f"prompt_cap {LM_SERVE_PROMPT_CAP}; decode_32k cut from 128 x "
        f"32,768), cache {sv['cache_gib']:.3f} GiB, in {st['steps']} steps, "
        f"{st['wall_s']:.3f}s: {st['tok_s_processed']:.1f} tok/s processed, "
        f"{st['tok_s_generated']:.1f} tok/s generated; admission latency "
        f"p50 {st['admission_p50_ms']:.1f} ms p99 "
        f"{st['admission_p99_ms']:.1f} ms; request latency p50 "
        f"{st['latency_p50_ms']:.1f} ms p99 {st['latency_p99_ms']:.1f} ms; "
        f"{st['step_programs']} step program; peak "
        f"{sv['peak_alloc_gib']:.2f} GiB allocated, "
        f"{sv['peak_reserved_gib']:.2f} GiB reserved; decode launches "
        f"{sv['launches']['decode_attention']} "
        f"({sv['captured_launches']} a replay)")
    log(f"[{tag} serve] a replayed step: wall {sv['step_wall_ms']:.3f} ms "
        f"(median of {LM_SERVE_TIMED}), device {sv['step_device_ms']:.3f} ms"
        f" (mean of {LM_SERVE_TIMED} back to back); the counted run: "
        f"{sv['stream_device_ms']:.1f} ms of steps on the device, busy share"
        f" {sv['stream_busy_share']:.3f}")
    log_profile(f"{tag} serve step profile", sv["step_profile"])
    alone = (f"{out['served_alone']} requests alone == the stream's tokens"
             if out["served_alone"] else "MoE: slots share the experts' "
             "capacity, no slot-independence check")
    log(f"[{tag} serve checks] {alone}; each decode launch within "
        f"twin_tolerance (worst {extra[f'{tag}_layers_share_of_tol']:.4f} of"
        f" it, max abs {extra[f'{tag}_layers_max_abs_err']}); step logits "
        f"kernel vs twin {extra[f'{tag}_kernel_vs_twin_logit_max_abs_err']} "
        f"(argmax equal {extra[f'{tag}_kernel_vs_twin_argmax_equal']}; next "
        f"kv head {extra[f'{tag}_kernel_vs_kv_shift_logit_max_abs_err']}); "
        f"planted faults, shares of the tolerance "
        f"{extra[f'{tag}_fault_share_of_tol']}: ok")
    log_row(f"decode_attention ({tag})", sv["row"])
    if "decode_32k" in out:
        d32 = out["decode_32k"]
        log(f"[{tag} decode_32k] one step at position {DECODE_32K_LEN - 1}, "
            f"batch {out['decode_32k_batch']} (cut from 128), cache "
            f"{d32['cache_gib']:.2f} GiB: wall {d32['step_wall_ms']:.3f} ms "
            f"(median of {DECODE_32K_TIMED}); kernel within "
            f"{d32['kernel_share_of_tol']:.4f} of its tolerance")
        log_profile(f"{tag} decode_32k step profile", d32["step_profile"])
        log_row(f"decode_attention ({tag} decode_32k)", d32["row"])


# ------------------------------------------------------------ phase 10
def grad_close(got, want):
    """(within BWD_RTOL · |want| + BWD_ATOL · max |want|, max abs error,
    largest share of that tolerance) of a flash gradient against the
    twin's."""
    import torch
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    tol = BWD_ATOL * max(float(w.abs().max()), 1e-30) + BWD_RTOL * w.abs()
    share = float((diff / tol).max())
    return (share <= 1.0 and bool(torch.isfinite(g).all()),
            float(diff.max()), share)


def grads_close(got, want):
    """grad_close over (dq, dk, dv): (all within, max error, max share)."""
    res = [grad_close(g, w) for g, w in zip(got, want)]
    return (all(ok for ok, _, _ in res), max(e for _, e, _ in res),
            max(sh for _, _, sh in res))


def bwd_twin_no_cap_factor(q, k, v, out, lse, dout, *, causal, window,
                           logit_cap, q_offset=0, kv_block=512):
    """A planted fault: the backward twin without the softcap's (1 - t²)
    factor (``models.attention._flash_bwd_scan`` less that line)."""
    import torch
    from repro_torch.models import attention as ta

    b, h, sq, dh = q.shape
    hkv = k.shape[1]
    qg, kb, vb, blk = ta._blocks(q, k, v, kv_block)
    og = ta._group_q(out, hkv).float()
    dog = ta._group_q(dout, hkv).float()
    lse = lse.reshape(b, hkv, h // hkv, sq)
    delta = (dog * og).sum(-1)
    dq = torch.zeros_like(qg)
    dks, dvs = [], []
    for j in range(kb.shape[0]):
        kj, vj = kb[j].float(), vb[j].float()
        s = ta._softcap(torch.einsum("bkgqd,bkcd->bkgqc", qg, kj), logit_cap)
        mask = ta._blk_mask(sq, blk, j, q_offset, causal, window, q.device)
        p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
        ds = p * (torch.einsum("bkgqd,bkcd->bkgqc", dog, vj)
                  - delta[..., None])
        dq += torch.einsum("bkgqc,bkcd->bkgqd", ds, kj)
        dks.append(torch.einsum("bkgqc,bkgqd->bkcd", ds, qg))
        dvs.append(torch.einsum("bkgqc,bkgqd->bkcd", p, dog))
    return ((dq * dh ** -0.5).reshape(q.shape).to(q.dtype),
            torch.movedim(torch.stack(dks), 0, 2).reshape(k.shape).to(
                k.dtype),
            torch.movedim(torch.stack(dvs), 0, 2).reshape(v.shape).to(
                v.dtype))


def bwd_faults(q, k, v, out, lse, dout, want, mask):
    """The backward twin with each planted fault, as (dq, dk, dv): no
    (1 - t²) factor; window + 1 (local layers); every kv head's dk / dv
    taken from the next kv head; each group's sum missing its last query
    head."""
    from repro_torch.models.attention import flash_attention_bwd_plain

    g = q.shape[1] // k.shape[1]
    short = dout.clone()
    short[:, g - 1::g] = 0
    faults = {
        "no_cap_factor": bwd_twin_no_cap_factor(q, k, v, out, lse, dout,
                                                **mask),
        "next_kv_head": (want[0], want[1].roll(1, dims=1),
                         want[2].roll(1, dims=1)),
        "group_missing_a_head": flash_attention_bwd_plain(
            q, k, v, out, lse, short, **mask)}
    if mask["window"] is not None:
        faults["window_plus_1"] = flash_attention_bwd_plain(
            q, k, v, out, lse, dout, **{**mask, "window": mask["window"] + 1})
    return faults


def lm_bwd_kernel_phase(dev, seed):
    """The two flash backward kernels against the twin at gemma2-9b's head
    shapes: float32 at BWD_F32_SEQ tokens, then bf16 (queries ×
    FLASH_Q_SCALE so that the cap acts) as a global layer at 4096 and
    8192 tokens and a local one at 8192, each within BWD_RTOL / BWD_ATOL
    of the twin on the forward kernel's own out and lse, bit-equal over
    two launches, with its planted faults read outside the tolerance;
    timed against their bounds, the twin and the backward of
    ``scaled_dot_product_attention`` at the train path's 4096 tokens."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.models.attention import (flash_attention_bwd_plain,
                                              flash_attention_plain)

    g = torch.Generator(device=dev).manual_seed(seed + 30)
    rows, extra = {}, {}
    cfg = get_config(LM_ARCH)
    h, hkv, dh, cap = cfg.n_heads, cfg.n_kv_heads, cfg.dh, cfg.attn_logit_cap
    blib = _build.load("flash_attention_bwd", tfa._BWD_SIGNATURES)
    flib = _build.load("flash_attention", tfa._SIGNATURES)

    def case(seq, dtype, window):
        q, k, v, dout = (torch.randn(shape, generator=g, device=dev)
                         for shape in ((1, h, seq, dh), (1, hkv, seq, dh),
                                       (1, hkv, seq, dh), (1, h, seq, dh)))
        q, k, v, dout = (t.to(dtype) for t in (q * FLASH_Q_SCALE, k, v,
                                                dout))
        mask = dict(causal=True, window=window, logit_cap=cap, q_offset=0)
        _, lse, out_f32 = tfa._fwd_kernel(q, k, v, lse=True, **mask)
        return (q, k, v, out_f32, lse, dout), mask

    # float32: the kernels' arithmetic against the twin's, and the
    # forward's lse against the twin's
    args, mask = case(BWD_F32_SEQ, torch.float32, None)
    q, k, v, out, lse, dout = args
    _, want_lse = flash_attention_plain(q, k, v, return_lse=True, **mask)
    lse_err = float(((lse - want_lse).abs() / (1 + want_lse.abs())).max())
    extra[f"flash_lse_f32_{BWD_F32_SEQ}_max_rel_err"] = lse_err
    check(lse_err <= FLASH_F32_TOL, f"forward lse within {FLASH_F32_TOL} "
          f"(relative to 1 + |lse|) of the twin's ({lse_err})")
    got = tfa.flash_attention_bwd(*args, **mask)
    want = flash_attention_bwd_plain(*args, **mask)
    for name, gt, w in zip(("dq", "dk", "dv"), got, want):
        err = float((gt - w).abs().max() / w.abs().max())
        extra[f"flash_bwd_f32_{BWD_F32_SEQ}_{name}_err_over_max"] = err
        check(err <= BWD_F32_TOL, f"float32 {name} within {BWD_F32_TOL} of "
              f"the twin's largest value ({err})")
    del args, got, want, out, lse, dout, q, k, v

    for seq, window in BWD_CASES:
        tag = f"flash_bwd_{seq}_" + ("local" if window else "global")
        args, mask = case(seq, cfg.dtype, window)
        q, k, v, out, lse, dout = args
        got = tfa.flash_attention_bwd(*args, **mask)
        want = flash_attention_bwd_plain(*args, **mask)
        again = tfa.flash_attention_bwd(*args, **mask)
        torch.cuda.synchronize()
        for name, gt, w in zip(("dq", "dk", "dv"), got, want):
            ok, err, share = grad_close(gt, w)
            extra[f"{tag}_{name}_max_abs_err"] = err
            extra[f"{tag}_{name}_share_of_tol"] = share
            extra[f"{tag}_{name}_max_abs"] = float(w.float().abs().max())
        faults = {key: grads_close(f, want)[2]
                  for key, f in bwd_faults(*args, want, mask).items()}
        extra[f"{tag}_fault_share_of_tol"] = faults
        ok, err, share = grads_close(got, want)
        check(ok, f"{tag}: dq, dk, dv within rtol {BWD_RTOL} + atol "
              f"{BWD_ATOL} x max of the twin ({err}, {share:.3f} of the "
              "tolerance)")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"{tag}: two launches give the same bits")
        check(all(v > 1 for v in faults.values()),
              f"{tag}: the tolerance rejects every planted fault {faults}")
        delta = torch.sum(dout.float() * out.float(), dim=-1)
        opts = (1, h, hkv, seq, seq, dh, int(q.dtype == torch.bfloat16), 1,
                int(window is not None), window or 0, 1, cap, dh ** -0.5, 0,
                _build.stream_of(q))
        dq, dk, dv = got
        ms_dq = cuda_ms(lambda: blib.flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *opts),
            iters=5, warmup=1)
        ms_dkv = cuda_ms(lambda: blib.flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *opts), iters=5, warmup=1)
        extra[f"{tag}_dq_ms"], extra[f"{tag}_dkv_ms"] = ms_dq, ms_dkv
        log(f"[bwd kernels] {tag}: dq {ms_dq:.3f} ms, dk/dv {ms_dkv:.3f} ms; "
            f"max error {err}, share {share:.3f}; faults {faults}")
        if (seq, window) != (TRAIN_SEQ, None):
            del args, got, want, again, q, k, v, out, lse, dout, delta
            continue
        # the train path's shape: forward with and without lse, the twin
        # and the library's backward
        o2 = torch.empty_like(q)
        o32 = torch.empty(q.shape, dtype=torch.float32, device=dev)
        # the prefill's forward; the train path's, which also writes lse
        # and the float32 out
        for key, ptrs in (("", (None, None)),
                          ("_lse", (lse.data_ptr(), o32.data_ptr()))):
            extra[f"flash_fwd{key}_{seq}_ms"] = cuda_ms(
                lambda: flib.flash_attention_fwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o2.data_ptr(),
                    *ptrs, *opts), iters=5, warmup=1)
        plain_ms = cuda_ms(lambda: flash_attention_bwd_plain(*args, **mask),
                           iters=2, warmup=1)
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                           enable_gqa=True)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(
            o, (qs, ks, vs), dout, retain_graph=True), iters=5, warmup=1)
        pairs = causal_pairs(seq, window) * h
        elt = q.element_size()
        rd = elt * seq * dh * (2 * h + 2 * hkv) + 8 * seq * h  # q, dO, k, v,
        # lse, delta read once
        for key, kernel, ms, flops, wr, what in (
                ("flash_attention_bwd_dq", "flash_dq_mma_kernel", ms_dq,
                 6 * dh * pairs, elt * seq * dh * h, "S, dP, dQ: 6 dh"),
                ("flash_attention_bwd_dkv", "flash_dkv_mma_kernel", ms_dkv,
                 8 * dh * pairs, 2 * elt * seq * dh * hkv,
                 "S, dP, dV, dK: 8 dh")):
            b_ms, b_by = bound(rd + wr, flops, BF16_FLOPS_PER_S)
            rows[key] = dict(
                name=key, route="cuda",
                source="src/repro_torch/csrc/flash_attention_bwd.cu",
                replaces="src/repro/kernels/flash_attention.py:" + (
                    "193" if key.endswith("dq") else "229"),
                max_abs_err=extra[f"{tag}_" + ("dq" if key.endswith("dq")
                                               else "dk") + "_max_abs_err"],
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, tflops=flops / (ms * 1e-3) / 1e12,
                ptxas=ptxas_usage("flash_attention_bwd", kernel).get(dh),
                shape=f"B 1, H {h} over Hkv {hkv}, dh {dh}, {seq} tokens, "
                      f"bf16, q x {FLASH_Q_SCALE}, causal, cap {cap}; "
                      f"{flops:.3e} FLOPs ({what} per live pair and head; "
                      "plain: the twin of both kernels; library: the "
                      "backward of scaled_dot_product_attention, causal, "
                      "GQA, no cap, all of dq, dk, dv: a near function)")
        del args, got, want, again, q, k, v, out, lse, dout, delta, o, qs, ks
        del vs, o2, o32
    return rows, extra


def delta_phase(dev, seed):
    """The backward's delta from the forward's float32 out, at gemma2-9b's
    head shapes, TRAIN_SEQ tokens, bf16, queries x FLASH_Q_SCALE: the
    forward with lse writes the float32 out beside the bf16 one, whose
    bits equal those of a launch without lse; the backward kernels on it
    lie within BWD_RTOL / BWD_ATOL of the twin run in float32 on the same
    values with its own float32 out and lse (the reference's semantics);
    delta taken from the bf16 out, a planted fault, lies outside."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.models.attention import (flash_attention_bwd_plain,
                                              flash_attention_plain)

    g = torch.Generator(device=dev).manual_seed(seed + 35)
    cfg = get_config(LM_ARCH)
    h, hkv, dh, cap = cfg.n_heads, cfg.n_kv_heads, cfg.dh, cfg.attn_logit_cap
    seq = TRAIN_SEQ
    q, k, v, dout = (torch.randn(shape, generator=g, device=dev)
                     for shape in ((1, h, seq, dh), (1, hkv, seq, dh),
                                   (1, hkv, seq, dh), (1, h, seq, dh)))
    q, k, v, dout = (t.to(cfg.dtype) for t in (q * FLASH_Q_SCALE, k, v,
                                                dout))
    mask = dict(causal=True, window=None, logit_cap=cap, q_offset=0)
    out, lse, out_f32 = tfa._fwd_kernel(q, k, v, lse=True, **mask)
    out_inf = tfa._fwd_kernel(q, k, v, lse=False, **mask)[0]
    check(torch.equal(out, out_inf) and torch.equal(
        out, out_f32.to(cfg.dtype)), "the forward's bf16 out with lse and "
          "the float32 out is the bits of a launch without them, and the "
          "rounding of its float32 out")
    qf, kf, vf, df = (t.float() for t in (q, k, v, dout))
    ref_out, ref_lse = flash_attention_plain(qf, kf, vf, return_lse=True,
                                             **mask)
    want = flash_attention_bwd_plain(qf, kf, vf, ref_out, ref_lse, df,
                                     **mask)
    got = tfa.flash_attention_bwd(q, k, v, out_f32, lse, dout, **mask)
    fault = tfa.flash_attention_bwd(q, k, v, out.float(), lse, dout, **mask)
    torch.cuda.synchronize()
    res = {}
    for tag, grads in (("f32_out", got), ("bf16_out_fault", fault)):
        per = [grad_close(gt, w) for gt, w in zip(grads, want)]
        res[tag] = dict(share_of_tol={n: sh for n, (_, _, sh)
                                      in zip(("dq", "dk", "dv"), per)},
                        max_abs_err=max(e for _, e, _ in per))
    res["f32_out_vs_twin_out_max_abs_err"] = float(
        (out_f32 - ref_out).abs().max())
    ok, err, share = grads_close(got, want)
    f_share = max(res["bf16_out_fault"]["share_of_tol"].values())
    check(ok, f"delta from the float32 out: dq, dk, dv within rtol "
          f"{BWD_RTOL} + atol {BWD_ATOL} x max of the float32 twin ({err}, "
          f"{share:.3f} of the tolerance)")
    check(f_share > 1.0, f"delta from the bf16 out (a planted fault) reads "
          f"outside the tolerance ({f_share:.3f})")
    return res


def largest_block(n, most=512):
    """The twins' kv_block for ``n`` keys: the largest divisor of n up to
    ``most`` (the reference needs kv_block | Skv; the block changes only
    the order of float sums)."""
    return max(d for d in range(1, min(n, most) + 1) if n % d == 0)


def ragged_phase(dev, seed):
    """Every flash kernel at lengths that are no multiple of any tile,
    against its twin at the unchanged tolerances, at gemma2-9b's head
    shapes with queries x FLASH_Q_SCALE: float32 and bf16, the forward
    (out and, in float32, lse) on random q, k, v, and the two backward
    kernels on the forward kernel's own out and lse."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.models.attention import (flash_attention_bwd_plain,
                                              flash_attention_plain)

    g = torch.Generator(device=dev).manual_seed(seed + 40)
    cfg = get_config(LM_ARCH)
    h, hkv, dh, cap = cfg.n_heads, cfg.n_kv_heads, cfg.dh, cfg.attn_logit_cap
    out = {}
    for sq, skv, q_offset, window in RAGGED_CASES:
        mask = dict(causal=True, window=window, logit_cap=cap,
                    q_offset=q_offset)
        blk = largest_block(skv)
        for dtype in (torch.float32, cfg.dtype):
            tag = (f"{sq}x{skv}+{q_offset}_w{window}_"
                   + ("f32" if dtype == torch.float32 else "bf16"))
            q, k, v, dout = (torch.randn(shape, generator=g, device=dev)
                             for shape in ((1, h, sq, dh), (1, hkv, skv, dh),
                                           (1, hkv, skv, dh),
                                           (1, h, sq, dh)))
            q, k, v, dout = (t.to(dtype) for t in (q * FLASH_Q_SCALE, k, v,
                                                    dout))
            o, lse, o32 = tfa._fwd_kernel(q, k, v, lse=True, **mask)
            want, want_lse = flash_attention_plain(
                q, k, v, return_lse=True, kv_block=blk, **mask)
            got_g = tfa.flash_attention_bwd(q, k, v, o32, lse, dout, **mask)
            want_g = flash_attention_bwd_plain(q, k, v, o32, lse, dout,
                                               kv_block=blk, **mask)
            torch.cuda.synchronize()
            # one key: p = 1, so dS = dP - delta and dq = dk = 0 but for
            # float32 rounding on both sides, which no tolerance relative
            # to their own largest value holds: they are held to the atol
            # term against dv's largest value, and dv alone to the rest
            held = (got_g, want_g) if skv > 1 else (got_g[2:], want_g[2:])
            noise = 0.0 if skv > 1 else max(
                float((gt.float() - w.float()).abs().max())
                for gt, w in zip(got_g[:2], want_g[:2])) / float(
                    want_g[2].float().abs().max())
            if dtype == torch.float32:
                fwd = float((o - want).abs().max())
                lse_err = float(((lse - want_lse).abs()
                                 / (1 + want_lse.abs())).max())
                bwd = max(float((gt - w).abs().max() / w.abs().max())
                          for gt, w in zip(*held))
                out[tag] = dict(fwd_max_abs_err=fwd, lse_max_rel_err=lse_err,
                                bwd_err_over_max=max(bwd, noise))
                check(fwd <= FLASH_F32_TOL and lse_err <= FLASH_F32_TOL
                      and max(bwd, noise) <= BWD_F32_TOL,
                      f"ragged {tag}: float32 forward, lse and backward "
                      f"within {FLASH_F32_TOL} / {BWD_F32_TOL} of the twin "
                      f"({out[tag]})")
            else:
                ok, _, fwd = flash_close(o, want)
                ok_g, _, bwd = grads_close(*held)
                out[tag] = dict(fwd_share_of_tol=fwd, bwd_share_of_tol=bwd,
                                single_key_noise_over_dv=noise)
                check(ok and ok_g and noise <= BWD_ATOL,
                      f"ragged {tag}: bf16 forward and backward within "
                      f"their tolerances of the twin ({out[tag]})")
            del q, k, v, dout, o, o32, lse, want, want_lse, got_g, want_g
    return out


# ------------------------------------------------------------ phases 11-12
def train_path(dev, seed):
    """Launch counters to 0, the gemma2-9b train cell at full width cut to
    TRAIN_LAYERS layers and TRAIN_BATCH x TRAIN_SEQ tokens, TRAIN_STEPS
    AdamW steps, counters read."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.steps import lm_train_cell

    out = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cell = lm_train_cell(LM_ARCH, n_layers=TRAIN_LAYERS, seq_len=TRAIN_SEQ,
                         batch=TRAIN_BATCH, device=dev, seed=seed)
    torch.cuda.synchronize()
    out["setup_s"] = time.perf_counter() - t0
    out["params"] = sum(p.numel() for p in cell.model.parameters())
    out["state_gib"] = torch.cuda.memory_allocated() / 2**30
    out["moments"] = str(cell.opt_cfg.mom_dtype)
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    out["steps"] = []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        m = cell.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        out["steps"].append(dict(seconds=dt, **{k: float(v)
                                               for k, v in m.items()}))
        if i == 0:
            out["launches_first_step"] = launch_counts()
    out["launches"] = launch_counts()
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["first_s"] = out["steps"][0]["seconds"]
    out["steady_s"] = out["steps"][-1]["seconds"]
    out["tokens_per_s"] = TRAIN_BATCH * TRAIN_SEQ / out["steady_s"]
    return out, cell


def train_checks(dev, seed, cell, extra):
    """On the cell's own tokens: each layer's backward launches against
    the twin; the whole step's gradients against the same step with the
    twin backward in every layer (and with two planted faults); then the
    smoke model's step card against CPU and ``run_lm``'s
    fail-and-resume on the card."""
    import copy

    import torch
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.launch.steps import lm_train_cell, lm_train_step
    from repro_torch.models.attention import flash_attention_bwd_plain
    from repro_torch.models.transformer import lm_loss

    model, tokens = cell.model, cell.tokens
    cell.opt_state = None  # the moments' 30 GiB make room for two grad sets
    gc.collect()
    torch.cuda.empty_cache()

    def grads(bwd):
        """(loss, {name: grad}) with ``bwd`` as every layer's backward."""
        kernel_bwd = tfa.flash_attention_bwd
        tfa.flash_attention_bwd = bwd
        try:
            for p in model.parameters():
                p.grad = None
            loss = lm_loss(model, tokens)
            loss.backward()
        finally:
            tfa.flash_attention_bwd = kernel_bwd
        out = {n: p.grad for n, p in model.named_parameters()}
        for p in model.parameters():
            p.grad = None
        return float(loss.detach()), out

    kernel_bwd = tfa.flash_attention_bwd
    layers = []

    def checked(*a, **kw):
        got = kernel_bwd(*a, **kw)
        layers.append(grads_close(got, flash_attention_bwd_plain(*a, **kw)))
        return got
    loss_k, g_k = grads(checked)
    extra["train_layers_max_abs_err"] = max(e for _, e, _ in layers)
    extra["train_layers_share_of_tol"] = max(sh for _, _, sh in layers)
    check(len(layers) == TRAIN_LAYERS and all(ok for ok, _, _ in layers),
          f"each of the step's {TRAIN_LAYERS} backward launches within the "
          f"kernel tolerance of the twin on its own inputs ({len(layers)} "
          f"checked, max {extra['train_layers_max_abs_err']}, "
          f"{extra['train_layers_share_of_tol']:.3f} of the tolerance)")

    def twin(fault=None):
        def fn(q, k, v, out, lse, dout, **kw):
            if fault == "group_missing_a_head":
                dout = dout.clone()
                g = q.shape[1] // k.shape[1]
                dout[:, g - 1::g] = 0
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                                   **kw)
            if fault == "next_kv_head":
                dk, dv = dk.roll(1, dims=1), dv.roll(1, dims=1)
            return dq, dk, dv
        return fn

    t0 = time.perf_counter()
    loss_t, g_t = grads(twin())
    extra["train_twin_backward_s"] = time.perf_counter() - t0
    extra["train_kernel_vs_twin_loss_diff"] = abs(loss_k - loss_t)

    def rel_l2(got):
        return {n: float((got[n].float() - g_t[n].float()).norm()
                         / g_t[n].float().norm().clamp(min=1e-30))
                for n in g_t}
    errs = rel_l2(g_k)
    worst = max(errs, key=errs.get)
    extra["train_kernel_vs_twin_worst_rel_l2"] = [worst, errs[worst]]
    del g_k
    readings = {}
    for fault in ("next_kv_head", "group_missing_a_head"):
        _, g_f = grads(twin(fault))
        errs_f = rel_l2(g_f)
        readings[fault] = max(errs_f.values())
        del g_f
    extra["train_fault_worst_rel_l2"] = readings
    check(abs(loss_k - loss_t) <= 1e-6 * abs(loss_t), f"the loss does not "
          f"depend on the backward ({loss_k} vs {loss_t})")
    check(errs[worst] <= TRAIN_GRAD_TOL < min(readings.values()),
          f"the step's gradients with the kernels within relative L2 "
          f"{TRAIN_GRAD_TOL} of the twin backward's (worst {worst}: "
          f"{errs[worst]}), every planted fault outside ({readings})")
    del g_t

    # the smoke model's train step: card against CPU, float32
    small = lm_train_cell(LM_ARCH, seq_len=64, batch=2, device="cpu",
                          seed=seed, smoke=True)
    model_d = copy.deepcopy(small.model).to(dev)
    state_d = {key: ({n: t.to(dev, copy=True)
                      for n, t in small.opt_state[key].items()}
                     if key != "step" else small.opt_state[key].clone())
               for key in small.opt_state}
    params_c = dict(small.model.named_parameters())
    loss_c = lm_loss(small.model, small.tokens)
    loss_c.backward()
    grads_c = {n: p.grad.clone() for n, p in params_c.items()}
    loss_d = lm_loss(model_d, small.tokens.to(dev))
    loss_d.backward()
    loss_c, loss_d = float(loss_c.detach()), float(loss_d.detach())
    g_err = max(float((p.grad.cpu() - grads_c[n]).abs().max()
                      / grads_c[n].abs().max().clamp(min=1e-30))
                for n, p in model_d.named_parameters())
    m_c = small.step()
    m_d = lm_train_step(model_d, small.opt_cfg, state_d,
                        small.tokens.to(dev))
    p_err = max(float((p.detach().cpu() - params_c[n].detach()).abs().max())
                for n, p in model_d.named_parameters())
    extra["train_smoke_card_vs_cpu"] = dict(
        loss=abs(loss_d - loss_c), grad_err_over_max=g_err,
        param_max_abs_err=p_err, loss_after=[float(m_c["loss"]),
                                             float(m_d["loss"])])
    lr0 = m_c["lr"]
    check(abs(loss_d - loss_c) <= 1e-5 and g_err <= 1e-4
          and p_err <= 2 * lr0 + 1e-6,
          f"smoke train step card vs CPU: loss within 1e-5, grads within "
          f"1e-4 of each parameter's largest, parameters after one AdamW "
          f"step within 2 lr + 1e-6 = {2 * lr0 + 1e-6} "
          f"({extra['train_smoke_card_vs_cpu']})")
    del model_d, state_d

    extra["run_lm_resume"] = run_lm_resume(dev, seed, LM_ARCH, exact=False)


def run_lm_resume(dev, seed, arch, exact=True):
    """``launch/train.run_lm`` on ``arch``'s smoke config on the card: a
    crash at step RUN_LM_FAIL_AT and a resume from the last checkpoint
    against an uninterrupted run, in a temp dir; ``exact``: the history
    and the parameters bit-equal, else the losses within rtol 1e-6."""
    import shutil
    import tempfile

    import torch
    from repro_torch.launch import train as tlaunch
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        kw = dict(arch=arch, steps=RUN_LM_STEPS, smoke=True,
                  fail_at=None, seed=seed, device=dev)
        try:
            tlaunch.run_lm(ckpt_dir=os.path.join(tmp, "a"),
                           **{**kw, "fail_at": RUN_LM_FAIL_AT})
        except RuntimeError as e:
            check("injected failure" in str(e), f"run_lm failed: {e}")
        else:
            check(False, "run_lm did not stop at the injected failure")
        m1, _, resumed = tlaunch.run_lm(ckpt_dir=os.path.join(tmp, "a"),
                                        **kw)
        m2, _, clean = tlaunch.run_lm(ckpt_dir=os.path.join(tmp, "b"), **kw)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    tail = [h for h in clean if h["step"] >= resumed[0]["step"]]
    same = all(torch.equal(p, q) for p, q in zip(m1.parameters(),
                                                 m2.parameters()))
    out = dict(resumed=resumed, clean=clean,
               bit_equal=resumed == tail and same)
    check(resumed[0]["step"] > 0 and len(resumed) == len(tail) and (
        out["bit_equal"] if exact else all(
            r["step"] == c["step"] and abs(r["loss"] - c["loss"])
            <= 1e-6 * abs(c["loss"]) for r, c in zip(resumed, tail))),
        f"run_lm ({arch}) resumed at step {resumed[0]['step']} gives the "
        f"uninterrupted run's " + ("bits" if exact else
                                   "history within rtol 1e-6")
        + f": {resumed} vs {tail}")
    return out


# ------------------------------------------------------------ phase 12b
# LM training of the other configs (A.7's training half): (arch, layers
# kept or None for the published depth, tokens a sequence, sequences a
# step or None for the largest of LM_TRAIN_BATCHES whose reckoned peak
# stays under LM_TRAIN_PEAK_GIB, the full checks). granite-moe-1b-a400m at
# full width and depth (train_4k's batch of 256 cut); codeqwen1.5-7b cut
# to 16 of 32 layers and qwen1.5-32b to 4 of 64 (their bf16 weights and
# grads and their moments beside one sequence's activations); grok-1-314b
# trains in phase 13d (one layer, ``LM_TRAIN_GROK``) where its reckoned
# peak stays under LM_TRAIN_PEAK_GIB
LM_TRAIN_RUNS = (("granite-moe-1b-a400m", None, 4096, None, True),
                 ("codeqwen1.5-7b", 16, 4096, 1, False),
                 ("qwen1.5-32b", 4, 4096, 1, False))
LM_TRAIN_BATCHES = (1, 2, 4, 8, 16)
LM_TRAIN_PEAK_GIB = 60
LM_TRAIN_STEPS = 3
# what the reckoning may reach on the card (80 GiB less the context and
# the allocator's slack)
LM_TRAIN_CARD_GIB = 72
LM_TRAIN_GROK = ("grok-1-314b", 1, 1024)


def lm_param_count(cfg):
    """(parameters, the largest leaf's elements) of ``cfg``'s LM."""
    d, dh, h, hkv = cfg.d_model, cfg.dh, cfg.n_heads, cfg.n_kv_heads
    attn = d * dh * (2 * h + 2 * hkv) + (dh * (h + 2 * hkv)
                                         if cfg.qkv_bias else 0)
    mlp = (d * cfg.moe_experts + 3 * cfg.moe_experts * d * cfg.d_ff
           if cfg.is_moe else 3 * d * cfg.d_ff)
    norms = (4 if cfg.post_norm else 2) * d
    embed = cfg.vocab * d * (1 if cfg.tied_embed else 2)
    leaf = max(cfg.vocab * d, (cfg.moe_experts or 1) * d * cfg.d_ff)
    return cfg.n_layers * (attn + mlp + norms) + embed + d, leaf


def lm_train_grok_cfg():
    """grok-1-314b's published config cut to LM_TRAIN_GROK's layers."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(LM_TRAIN_GROK[0]),
                               n_layers=LM_TRAIN_GROK[1])


def largest_slice(cfg):
    """Elements of the largest slice AdamW updates at once: the largest
    leaf cut as ``train/optim.py`` ``leaf_slices`` cuts it (grok-1's
    expert leaf [8, 6144, 32768]: one expert)."""
    from repro_torch.train.optim import SLICE_ELEMS, leaf_slices
    d, e = cfg.d_model, cfg.moe_experts or 1
    shapes = [(cfg.vocab, d)] + ([(e, d, cfg.d_ff)] if cfg.is_moe
                                 else [(d, cfg.d_ff)])
    out = 0
    for shape in shapes:
        sl = leaf_slices(shape, SLICE_ELEMS)[0]
        rows = shape[0] if sl is None else sl.stop - sl.start
        out = max(out, rows * math.prod(shape[1:]))
    return out


def reckoned_train_gib(cfg, seq, batch, mom_bytes):
    """An LM train step's reckoned peak, GiB: bf16 weights and grads and
    the moments; AdamW's four float32 temporaries of the largest slice it
    updates at once (``largest_slice``; the global norm reads each leaf
    in place and adds none); a sequence's float32 logits three
    times over and its bf16 ones once (14 B a logit), each layer's bf16
    input kept for the recompute, and one layer's recompute, 24 B a token
    and unit of its widest activation (under MoE the k · 1.25 slots a
    token of d_ff)."""
    n, _ = lm_param_count(cfg)
    wide = max(cfg.d_model, cfg.d_ff * (cfg.moe_top_k * 1.25
                                         if cfg.is_moe else 1))
    act = seq * (14 * cfg.vocab + 2 * cfg.n_layers * cfg.d_model + 24 * wide)
    return (n * (4 + 2 * mom_bytes) + 16 * largest_slice(cfg)
            + batch * act) / 2**30


def flash_vs_float64(q, k, v, cap, got, want, heads=2):
    """Shares of the one-bf16-ulp tolerance (``flash_close``) that the
    kernel's and the twin's outputs reach against a float64 causal (and
    capped) attention, on the ``heads`` query heads where the two differ
    most against that tolerance: {"kernel", "twin", "heads"}."""
    import torch
    g = q.shape[1] // k.shape[1]
    seq, dh = q.shape[2], q.shape[3]
    d = (got.float() - want.float()).abs() / (
        FLASH_ATOL + FLASH_RTOL * want.float().abs())
    worst = d[0].amax(dim=(1, 2)).argsort(descending=True)[:heads].tolist()
    pos = torch.arange(seq, device=q.device)
    live = pos[:, None] >= pos[None, :]
    out = {"kernel": 0.0, "twin": 0.0, "heads": worst}
    for h in worst:
        s = (q[0, h].double() * dh ** -0.5) @ k[0, h // g].double().T
        if cap is not None:
            s = cap * torch.tanh(s / cap)
        ref = torch.softmax(torch.where(live, s, -1e30), -1) @ v[
            0, h // g].double()
        del s
        for name, o in (("kernel", got), ("twin", want)):
            out[name] = max(out[name], flash_close(o[0, h], ref)[2])
    return out


def train_kernel_rows(dev, seed, cfg, seq, tag):
    """Rows 12, 13a and 13b at ``cfg``'s head shapes (bf16, B 1, ``seq``
    tokens, causal, the config's cap, no window; queries × FLASH_Q_SCALE):
    the forward with lse and the float32 out, dq and dk/dv, each held
    against the twin (the forward within one bf16 ulp, the backward within
    BWD_RTOL / BWD_ATOL), then timed beside the twin and the library
    (scaled_dot_product_attention and its backward, causal, GQA)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.models.attention import (flash_attention_bwd_plain,
                                              flash_attention_plain)
    g = torch.Generator(device=dev).manual_seed(seed + 40)
    h, hkv, dh, cap = cfg.n_heads, cfg.n_kv_heads, cfg.dh, cfg.attn_logit_cap
    q, k, v, dout = (torch.randn(s, generator=g, device=dev).to(cfg.dtype)
                     for s in ((1, h, seq, dh), (1, hkv, seq, dh),
                               (1, hkv, seq, dh), (1, h, seq, dh)))
    q = (q.float() * FLASH_Q_SCALE).to(cfg.dtype)
    mask = dict(causal=True, window=None, logit_cap=cap, q_offset=0)
    out, lse, out_f32 = tfa._fwd_kernel(q, k, v, lse=True, **mask)
    want_o = flash_attention_plain(q, k, v, kv_block=512, **mask)
    _, fwd_err, fwd_share = flash_close(out, want_o)
    witness = None
    if fwd_share > 1.0:
        # past one ulp of the twin: hold both against a float64 witness on
        # the heads that read worst before calling it a kernel fault
        witness = flash_vs_float64(q, k, v, cap, out, want_o)
    args = (q, k, v, out_f32, lse, dout)
    got = tfa.flash_attention_bwd(*args, **mask)
    want = flash_attention_bwd_plain(*args, **mask)
    ok, bwd_err, share = grads_close(got, want)
    check((fwd_share <= 1.0 or witness["kernel"] <= 1.0) and ok,
          f"{tag}: the forward within one bf16 ulp of the twin "
          f"({fwd_share:.3f} of it; of a float64 witness: {witness}) and "
          f"dq, dk, dv within the backward's tolerance ({share:.3f})")
    fwd_ms = cuda_ms(lambda: tfa._fwd_kernel(q, k, v, lse=True, **mask),
                     iters=5, warmup=1)
    delta = torch.sum(dout.float() * out_f32, dim=-1)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    bwd = dict(
        dq=cuda_ms(lambda: tfa.flash_dq(q, k, v, dout, lse, delta, dq,
                                        **mask), iters=5, warmup=1),
        dkv=cuda_ms(lambda: tfa.flash_dkv(q, k, v, dout, lse, delta, dk, dv,
                                          **mask), iters=5, warmup=1))
    fwd_plain = cuda_ms(lambda: flash_attention_plain(q, k, v, kv_block=512,
                                                      **mask), iters=2,
                        warmup=1)
    bwd_plain = cuda_ms(lambda: flash_attention_bwd_plain(*args, **mask),
                        iters=2, warmup=1)
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    fwd_lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), iters=5, warmup=1)
    o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                       enable_gqa=True)
    bwd_lib = cuda_ms(lambda: torch.autograd.grad(
        o, (qs, ks, vs), dout, retain_graph=True), iters=5, warmup=1)
    pairs = causal_pairs(seq) * h
    elt = q.element_size()
    qkv = elt * seq * dh * (2 * h + 2 * hkv)
    shape = (f"B 1, H {h} over Hkv {hkv}, dh {dh}, {seq} tokens, bf16, q x "
             f"{FLASH_Q_SCALE}, causal, cap {cap}")
    rows = {}
    for key, ms, flops, nbytes, plain, lib, err in (
            ("flash_attention_fwd", fwd_ms, 4 * dh * pairs,
             qkv + 4 * seq * h + 4 * seq * h * dh, fwd_plain, fwd_lib,
             fwd_err),
            ("flash_attention_bwd_dq", bwd["dq"], 6 * dh * pairs,
             qkv + 8 * seq * h, bwd_plain, bwd_lib, bwd_err),
            ("flash_attention_bwd_dkv", bwd["dkv"], 8 * dh * pairs,
             qkv + 8 * seq * h + 2 * elt * seq * dh * hkv, bwd_plain,
             bwd_lib, bwd_err)):
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
        src = ("flash_attention.cu" if key.endswith("fwd")
               else "flash_attention_bwd.cu")
        line = {"flash_attention_fwd": 80, "flash_attention_bwd_dq": 193,
                "flash_attention_bwd_dkv": 229}[key]
        rows[f"{key} ({tag})"] = dict(
            name=key, route="cuda", source=f"src/repro_torch/csrc/{src}",
            replaces=f"src/repro/kernels/flash_attention.py:{line}",
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib,
            tflops=flops / (ms * 1e-3) / 1e12,
            shape=f"{shape}; {flops:.3e} FLOPs" + (
                " (with lse and the float32 out; library: "
                "scaled_dot_product_attention, causal, GQA)"
                if key.endswith("fwd") else " (plain: the twin of both "
                "kernels; library: the backward of "
                "scaled_dot_product_attention, all of dq, dk, dv)"))
    del q, k, v, dout, out, lse, out_f32, got, want, o, qs, ks, vs, delta
    del dq, dk, dv
    return rows, dict(fwd_share_of_tol=fwd_share, bwd_share_of_tol=share,
                      fwd_vs_float64=witness)


def lm_train_config_phase(dev, seed, arch, layers, seq, batch, full, extra,
                          two_steps=False):
    """One LM config's training on the card: the train_4k cell (cut to
    ``layers`` and ``batch`` sequences of ``seq`` tokens; the batch by the
    reckoning when None), launch counters to 0, LM_TRAIN_STEPS AdamW steps
    with each of the first step's backward launches held against the twin
    on its own inputs, counters read; the losses; the peak. With ``full``:
    the step's gradients against the same step with the twin backward
    (and two planted faults), two steps from one saved state bit-equal,
    and one step profiled; with ``two_steps`` only the two steps. Then
    rows 12, 13a, 13b at its head shapes."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.steps import lm_train_cell, train_moments_dtype
    from repro_torch.models.attention import flash_attention_bwd_plain

    base = get_config(arch)
    cfg = base if layers is None else dataclasses.replace(base,
                                                          n_layers=layers)
    mom_bytes = torch.finfo(train_moments_dtype(base)).bits // 8
    reckon = {b: reckoned_train_gib(cfg, seq, b, mom_bytes)
              for b in LM_TRAIN_BATCHES}
    if batch is None:
        batch = max(b for b, gib in reckon.items()
                    if gib <= LM_TRAIN_PEAK_GIB)
    tag = f"{arch} train" + (f" {layers}L" if layers else "")
    out = dict(tag=tag, arch=arch, layers=cfg.n_layers, seq=seq,
               batch=batch, reckoned_gib=reckon[batch],
               reckoned_by_batch=reckon)
    check(reckon[batch] <= LM_TRAIN_CARD_GIB,
          f"{tag}: the reckoned peak {reckon[batch]:.1f} GiB fits the card")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cell = lm_train_cell(arch, n_layers=layers, seq_len=seq, batch=batch,
                         device=dev, seed=seed)
    torch.cuda.synchronize()
    out["setup_s"] = time.perf_counter() - t0
    out["params"] = sum(p.numel() for p in cell.model.parameters())
    check(out["params"] == lm_param_count(cfg)[0],
          f"{tag}: {out['params']} parameters as reckoned "
          f"({lm_param_count(cfg)[0]})")
    out["state_gib"] = torch.cuda.memory_allocated() / 2**30
    out["moments"] = str(cell.opt_cfg.mom_dtype)

    real_bwd = tfa.flash_attention_bwd
    shares = []

    def checked(*a, **kw):
        got = real_bwd(*a, **kw)
        shares.append(grads_close(got, flash_attention_bwd_plain(*a, **kw)))
        return got
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    out["steps"] = []
    for i in range(LM_TRAIN_STEPS):
        tfa.flash_attention_bwd = checked if i == 0 else real_bwd
        try:
            t0 = time.perf_counter()
            m = cell.step()
            torch.cuda.synchronize()
        finally:
            tfa.flash_attention_bwd = real_bwd
        out["steps"].append(dict(seconds=time.perf_counter() - t0,
                                 **{k: float(v) for k, v in m.items()}))
    out["launches"] = launch_counts()
    out["peak_allocated_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["peak_reserved_gib"] = torch.cuda.max_memory_reserved() / 2**30
    out["steady_s"] = out["steps"][-1]["seconds"]
    out["tokens_per_s"] = batch * seq / out["steady_s"]
    out["bwd_max_abs_err"] = max(e for _, e, _ in shares)
    out["bwd_share_of_tol"] = max(sh for _, _, sh in shares)
    n = cfg.n_layers
    want = {"flash_attention_fwd": 2 * n, "flash_attention_bwd_dq": n,
            "flash_attention_bwd_dkv": n}
    check(len(shares) == n and all(ok for ok, _, _ in shares),
          f"{tag}: each of the first step's {n} backward launches within "
          f"the kernel tolerance of the twin on its own inputs "
          f"({len(shares)} checked, {out['bwd_share_of_tol']:.3f} of it)")
    check(all(out["launches"][k] == LM_TRAIN_STEPS * v
              for k, v in want.items())
          and all(v == 0 for k, v in out["launches"].items()
                  if k not in want),
          f"{tag}: {want} launches a step and no other kernel: "
          f"{out['launches']} in {LM_TRAIN_STEPS} steps")
    ln_v = math.log(cfg.vocab)
    first = out["steps"][0]["loss"]
    check(all(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"])
              for s in out["steps"]) and ln_v <= first <= ln_v + 2,
          f"{tag}: finite losses and grad norms, the first near "
          f"ln({cfg.vocab}) = {ln_v:.2f}: {out['steps']}")
    if full:
        lm_train_full_checks(cell, tag, out)
        out["run_lm_resume"] = run_lm_resume(dev, seed, arch)
    elif two_steps:
        two_steps_bit_equal(cell, tag, out, digest=True)
    del cell
    gc.collect()
    torch.cuda.empty_cache()
    rows, out["kernel_shares"] = train_kernel_rows(dev, seed, cfg, seq, tag)
    out["rows"] = rows
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lm_train_full_checks(cell, tag, out):
    """On the cell's own tokens: the step's gradients with the kernels
    against the same step with the twin backward in every layer, and with
    the twin's two planted faults; two steps from one saved state (the
    parameters and the moments copied to the host and back) bit-equal;
    one step profiled."""
    import torch
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.models.attention import flash_attention_bwd_plain
    from repro_torch.models.transformer import lm_loss

    model, tokens = cell.model, cell.tokens

    def grads(bwd):
        real = tfa.flash_attention_bwd
        tfa.flash_attention_bwd = bwd
        try:
            for p in model.parameters():
                p.grad = None
            loss = lm_loss(model, tokens)
            loss.backward()
        finally:
            tfa.flash_attention_bwd = real
        g = {n: p.grad for n, p in model.named_parameters()}
        for p in model.parameters():
            p.grad = None
        return float(loss.detach()), g

    def twin(fault=None):
        def fn(q, k, v, o, lse, dout, **kw):
            if fault == "group_missing_a_head":
                dout = dout.clone()
                grp = q.shape[1] // k.shape[1]
                dout[:, grp - 1::grp] = 0
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, o, lse, dout,
                                                   **kw)
            if fault == "next_kv_head":
                dk, dv = dk.roll(1, dims=1), dv.roll(1, dims=1)
            return dq, dk, dv
        return fn

    loss_k, g_k = grads(tfa.flash_attention_bwd)
    loss_t, g_t = grads(twin())

    def rel_l2(got):
        return {n: float((got[n].float() - g_t[n].float()).norm()
                         / g_t[n].float().norm().clamp(min=1e-30))
                for n in g_t}
    errs = rel_l2(g_k)
    worst = max(errs, key=errs.get)
    del g_k
    faults = {}
    for fault in ("next_kv_head", "group_missing_a_head"):
        _, g_f = grads(twin(fault))
        faults[fault] = max(rel_l2(g_f).values())
        del g_f
    del g_t
    out["kernel_vs_twin_worst_rel_l2"] = [worst, errs[worst]]
    out["fault_worst_rel_l2"] = faults
    check(abs(loss_k - loss_t) <= 1e-6 * abs(loss_t)
          and errs[worst] <= TRAIN_GRAD_TOL < min(faults.values()),
          f"{tag}: the step's gradients with the kernels within relative L2 "
          f"{TRAIN_GRAD_TOL} of the twin backward's (worst {worst}: "
          f"{errs[worst]}), every planted fault outside ({faults}); loss "
          f"{loss_k} vs {loss_t}")

    two_steps_bit_equal(cell, tag, out)
    out["profile"] = dict(tokens=tokens.numel(),
                          **profile_call(cell.step, top=16))


DIGEST_CHUNK = 1 << 26


def bits_digest(t):
    """Two int64 sums over a tensor's bits, on its device in chunks: the
    plain sum and one weighted by position (mod 65521, plus 1)."""
    import torch
    flat = t.detach().reshape(-1)
    flat = flat.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                      8: torch.int64}[flat.element_size()])
    a = b = 0
    for i in range(0, flat.numel(), DIGEST_CHUNK):
        x = flat[i:i + DIGEST_CHUNK].to(torch.int64)
        w = torch.arange(i, i + x.numel(), device=x.device) % 65521 + 1
        a += int(x.sum())
        b += int((x * w).sum())
    return a, b


def two_steps_bit_equal(cell, tag, out, digest=False):
    """Two steps from one saved state (the parameters and the moments
    copied to the host and back) give the same bits: every tensor equal,
    or with ``digest`` (a state too large to hold twice more on the host)
    every tensor's ``bits_digest`` equal."""
    import torch
    model = cell.model
    state = {n: p.detach() for n, p in model.named_parameters()}
    state.update({f"{k}.{n}": t for k in ("m", "v")
                  for n, t in cell.opt_state[k].items()})
    saved = {n: t.to("cpu", copy=True) for n, t in state.items()}
    step0 = cell.opt_state["step"].clone()
    results = []
    for _ in range(2):
        with torch.no_grad():
            for n, t in state.items():
                t.copy_(saved[n])
        cell.opt_state["step"].copy_(step0)
        m = cell.step()
        results.append(({n: bits_digest(t) if digest else
                         t.to("cpu", copy=True) for n, t in state.items()},
                        float(m["loss"]), float(m["grad_norm"])))
    (a, la, ga), (b, lb, gb) = results
    same = [n for n in a if (a[n] == b[n] if digest
                             else torch.equal(a[n], b[n]))]
    out["two_steps_bit_equal"] = len(same) == len(a) and (la, ga) == (lb, gb)
    out["two_steps_by"] = "bits_digest" if digest else "every bit"
    check(out["two_steps_bit_equal"],
          f"{tag}: two steps from one saved state give the same bits "
          f"({len(same)} of {len(a)} tensors equal"
          f"{' by their bits digest' if digest else ''}; loss {la} / {lb}, "
          f"grad norm {ga} / {gb})")
    del saved, results, a, b


def log_lm_train_config(out):
    tag = out["tag"]
    log(f"[{tag}] {out['params']:,} parameters, {out['layers']} layers, "
        f"{out['batch']} x {out['seq']} tokens a step (reckoned peak "
        f"{out['reckoned_gib']:.1f} GiB; by batch "
        f"{ {b: round(v, 1) for b, v in out['reckoned_by_batch'].items()} }),"
        f" {out['moments']} moments, {out['state_gib']:.2f} GiB of state, "
        f"built in {out['setup_s']:.2f}s")
    for i, st in enumerate(out["steps"]):
        log(f"[{tag}] step {i}: {st['seconds']:.3f}s, loss {st['loss']}, "
            f"grad_norm {st['grad_norm']}, lr {st['lr']}")
    log(f"[{tag}] steady {out['steady_s']:.3f}s ({out['tokens_per_s']:.1f} "
        f"tokens/s); peak {out['peak_allocated_gib']:.2f} GiB allocated, "
        f"{out['peak_reserved_gib']:.2f} GiB reserved; launches "
        f"{out['launches']}; first step's backward launches vs the twin: "
        f"max {out['bwd_max_abs_err']}, {out['bwd_share_of_tol']:.3f} of "
        "the tolerance")
    if "profile" in out:
        log(f"[{tag}] gradients vs the twin backward's: worst "
            f"{out['kernel_vs_twin_worst_rel_l2']}, faults "
            f"{out['fault_worst_rel_l2']}; two steps from one state "
            f"bit-equal: {out['two_steps_bit_equal']}; run_lm (smoke) "
            f"resumed == uninterrupted bit for bit: "
            f"{out['run_lm_resume']['bit_equal']}")
        log_profile(f"{tag} profile", out["profile"])
    for key, r in out["rows"].items():
        log_row(key, r)


# ------------------------------------------------------------ phase 12c
# the recommender substrate (A.8): dlrm-rm2 at full width (26 tables of
# 1,000,000 rows x 64, float32), train_batch's 65,536 samples a step,
# RECSYS_STEPS AdamW steps; serve_p99 (512) and serve_bulk (262,144) and
# retrieval_cand (1 query against 1,000,000 candidates, top 100), each
# timed over RECSYS_TIMED calls. Crash and resume: run_recsys with the
# tables cut to RECSYS_RESUME_VOCAB rows (a full-width commit writes 26.6
# GB), checkpoints at 10 and RECSYS_RESUME_STEPS, a crash at
# RECSYS_RESUME_FAIL_AT
RECSYS_ARCH = "dlrm-rm2"
RECSYS_STEPS, RECSYS_TIMED = 3, 5
RECSYS_RESUME_VOCAB, RECSYS_RESUME_STEPS, RECSYS_RESUME_FAIL_AT = (
    1 << 16, 12, 11)
RECSYS_KERNELS = ("digit_hist", "digit_scatter", "rank_search",
                  "ptr_seg_sum")


def span_sum_share(got, want, ptr, x, rows, chunk=1 << 21):
    """The largest share of ``kernels.ptr_scan.twin_tolerance(ptr, x,
    rows)`` that |got − want| reaches, taken a chunk of rows at a time (the
    tolerance of a 26,000,000-row output does not fit beside it in
    float64): the same bound, (2 len + 4) U_c a row."""
    import torch
    p = ptr.to(torch.int64)
    lim = int(p[-1])
    msgs = x.index_select(0, rows[:lim].to(torch.int64).clamp(
        0, x.shape[0] - 1)).double()
    m = torch.cumsum(msgs, dim=0).abs().amax(dim=0)
    _, exp = torch.frexp(2 * m)
    ulp = torch.where(m > 0, torch.ldexp(torch.ones_like(m), exp - 24),
                      torch.zeros_like(m))
    del msgs
    share, worst = 0.0, 0.0
    for i in range(0, got.shape[0], chunk):
        hi = min(i + chunk, got.shape[0])
        seg = (p[i + 1:hi + 1] - p[i:hi]).double()
        tol = (2 * seg + 4)[:, None] * ulp[None, :]
        err = (got[i:hi].double() - want[i:hi].double()).abs()
        worst = max(worst, float(err.max()))
        share = max(share, float((err / tol.clamp_min(1e-300)).max()))
    return share, worst


def recsys_phase(dev, seed, extra):
    """dlrm-rm2 on the card: the train cell, its batch's lookup layout
    against a stable ``torch.sort`` bit for bit, launch counters to 0,
    RECSYS_STEPS steps (each: the layout's digit passes and rank search,
    the table gradient's span sum), counters read, a profiled step; one
    step's table gradient against the plain route's (``GatherRows`` with
    the twin's sum) within ``twin_tolerance``, and against the library
    route's time (autograd through ``index_select``); rows 1b, 3 and 14
    at this path's shapes; the serve and retrieval cells timed, retrieval
    against a stable sort of the same scores; ``run_recsys`` crashed and
    resumed against a clean run; the smoke model's step card vs CPU."""
    import copy
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.ordering import _bits_for
    from repro_torch.kernels import launch_counts, ptr_scan
    from repro_torch.kernels import reindex_epilogue as tre
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.kernels.radix_sort import global_radix_schedule
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch import train as tlaunch
    from repro_torch.models import dlrm as td

    cfg = get_config(RECSYS_ARCH)
    f, v = cfg.n_sparse, cfg.vocab_size
    out = dict(rows={})
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cell = tsteps._recsys_cell(RECSYS_ARCH, "train_batch", device=dev,
                               seed=seed)
    torch.cuda.synchronize()
    out["setup_s"] = time.perf_counter() - t0
    model = cell.model
    out["params"] = sum(p.numel() for p in model.parameters())
    out["state_gib"] = torch.cuda.memory_allocated() / 2**30
    dense, idx, labels = cell.inputs
    b = idx.shape[0]

    # the batch's lookup layout against a stable sort, bit for bit
    layout = td.lookup_layout(idx, v)
    sk, order = torch.sort(layout.keys, stable=True)
    targets = torch.arange(f * v + 1, dtype=torch.int32, device=dev)
    want_ptr = torch.searchsorted(sk, targets)
    check(torch.equal(layout.rev_perm.to(torch.int64), order)
          and torch.equal(layout.rev_ptr.to(torch.int64), want_ptr),
          f"the lookup layout of {layout.keys.numel()} keys over {f * v} "
          "rows equals a stable torch.sort and its searchsorted pointers")
    out["lookups"] = layout.keys.numel()
    out["distinct_rows"] = int(torch.unique(layout.keys).numel())
    out["row0_share"] = float((idx == 0).float().mean())
    out["layout_ms"] = cuda_ms(lambda: td.lookup_layout(idx, v), iters=5,
                               warmup=1)
    out["layout_library_ms"] = cuda_ms(lambda: torch.searchsorted(
        torch.sort(layout.keys, stable=True).values, targets), iters=5,
        warmup=1)
    # rows 1b and 3 at this path's shapes: a 7-bit pass over the lookups'
    # (key, position) pairs, the pointer build's rank search
    pos = torch.arange(out["lookups"], dtype=torch.int32, device=dev)
    for key, r in card_digit_rows(layout.keys, pos, 7, 0).items():
        r["shape"] = "dlrm-rm2 train_batch's lookups: " + r["shape"]
        out["rows"][f"{key} (dlrm-rm2 layout)"] = r
    sk32 = sk.to(torch.int32)
    got = tre.rank_fn(sk32, targets)
    check(torch.equal(got.to(torch.int64), want_ptr),
          "the rank search's pointers equal searchsorted's")
    r_ms, r_by = bound(4 * (2 * targets.numel() + sk32.numel()), 0)
    out["rows"]["rank_search (dlrm-rm2 layout)"] = dict(
        name="rank_search", route="cuda",
        source="src/repro_torch/csrc/reindex_epilogue.cu",
        replaces="src/repro/kernels/reindex_epilogue.py:57", max_abs_err=0,
        ms=cuda_ms(lambda: tre.rank_fn(sk32, targets), iters=5),
        plain_ms=cuda_ms(lambda: tre._unrolled_rank(sk32, targets, "left"),
                         iters=2, warmup=1),
        bound_ms=r_ms, bound_by=r_by,
        library_ms=cuda_ms(lambda: torch.searchsorted(sk32, targets),
                           iters=5),
        shape=f"{targets.numel()} queries (every table row) over "
              f"{sk32.numel()} sorted keys; bytes: queries, keys and output "
              "once; library: searchsorted")
    del sk, order, want_ptr, got, sk32, pos

    # counted steps
    passes = len(global_radix_schedule(_bits_for(f * v), RADIX_BITS))
    want = {"digit_hist": passes, "digit_scatter": passes, "rank_search": 1,
            "ptr_seg_sum": 1}
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    out["steps"] = []
    for i in range(RECSYS_STEPS):
        t0 = time.perf_counter()
        m = cell.step()
        torch.cuda.synchronize()
        out["steps"].append(dict(seconds=time.perf_counter() - t0,
                                 **{k: float(x) for k, x in m.items()}))
        if i == 0:
            out["launches_first_step"] = launch_counts()
    out["launches"] = launch_counts()
    out["peak_allocated_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["peak_reserved_gib"] = torch.cuda.max_memory_reserved() / 2**30
    out["steady_s"] = out["steps"][-1]["seconds"]
    out["samples_per_s"] = b / out["steady_s"]
    check(all(out["launches_first_step"][k] == n for k, n in want.items())
          and all(out["launches"][k] == RECSYS_STEPS * n
                  for k, n in want.items())
          and all(n == 0 for k, n in out["launches"].items()
                  if k not in want),
          f"{want} launches a step and no other kernel: "
          f"{out['launches_first_step']} in the first, {out['launches']} in "
          f"{RECSYS_STEPS}")
    first = out["steps"][0]["loss"]
    check(all(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"])
              for s in out["steps"]) and abs(first - math.log(2)) <= 0.5,
          f"finite losses and grad norms, the first near ln 2: "
          f"{out['steps']}")
    out["profile"] = dict(samples=b, **profile_call(cell.step, top=12))

    # one step's table gradient, kernel route against the plain route
    cell.opt_state = None  # the moments' 13.3 GB make room for two grads
    gc.collect()
    torch.cuda.empty_cache()
    real = ptr_scan.ptr_seg_sum

    def table_grad(fn):
        calls = []

        def recording(*args):
            calls.append(args)
            return fn(*args)
        recording.launches = real.launches
        ptr_scan.ptr_seg_sum = recording
        try:
            for p in model.parameters():
                p.grad = None
            loss = td.dlrm_loss(model, dense, idx, labels, layout)
            loss.backward()
            torch.cuda.synchronize()
        finally:
            ptr_scan.ptr_seg_sum = real
            if fn is real:
                real.launches = recording.launches
        g = model.tables.grad
        for p in model.parameters():
            p.grad = None
        return float(loss.detach()), g, calls
    loss_k, g_k, calls = table_grad(real)
    loss_p, g_p, calls_p = table_grad(ptr_scan._ptr_seg_sum_plain)
    check(len(calls) == len(calls_p) == 1 and torch.equal(calls[0][1],
                                                          calls_p[0][1]),
          "one span sum a backward, on the same upstream gradient in both "
          "routes")
    rev_ptr, gout, rows = calls[0][:3]
    share, err = span_sum_share(g_k.view(f * v, -1), g_p.view(f * v, -1),
                                rev_ptr, gout, rows)
    out["table_grad"] = dict(loss_kernel=loss_k, loss_plain=loss_p,
                             max_abs_err=err, share_of_tolerance=share)
    check(loss_k == loss_p and share <= 1.0,
          f"the step's table gradient within twin_tolerance of the plain "
          f"route's ({share:.4f} of it, max error {err})")
    del g_k, g_p, calls_p
    gc.collect()
    torch.cuda.empty_cache()
    # row 14 at this path's shape, and the lookup's routes: the port's
    # (GatherRows: index_select, then the span sum over the layout)
    # against autograd through index_select (index_add_'s float atomics)
    again = real(rev_ptr, gout, rows)
    check(torch.equal(again, real(rev_ptr, gout, rows)),
          "the table gradient's span sum gives the same bits twice")
    del again
    n_rows, d = f * v, gout.shape[1]
    lim = int(rev_ptr[-1])
    keys64 = layout.keys.to(torch.int64)
    s_ms, s_by = bound(4 * (lim * d + lim + n_rows + 1 + n_rows * d),
                       lim * d)
    out["rows"]["ptr_seg_sum (dlrm-rm2 table gradient)"] = dict(
        name="ptr_seg_sum", route="cuda",
        source="src/repro_torch/csrc/ptr_scan.cu",
        replaces="src/repro/models/gnn.py:80 (_ptr_seg_sum in jnp, no "
                 "Pallas call)", max_abs_err=err,
        ms=cuda_ms(lambda: real(rev_ptr, gout, rows), iters=5, warmup=1),
        plain_ms=cuda_ms(lambda: ptr_scan._ptr_seg_sum_plain(
            rev_ptr, gout, rows), iters=2, warmup=1),
        bound_ms=s_ms, bound_by=s_by,
        library_ms=cuda_ms(lambda: torch.zeros(
            (n_rows, d), device=dev).index_add_(0, keys64, gout), iters=5,
            warmup=1),
        shape=f"[{lim}, {d}] gradient rows through rev_perm into "
              f"{n_rows} table rows ({out['distinct_rows']} live); "
              "library: index_add_ into zeros")
    flat = model.tables.view(n_rows, d)

    def port_route():
        return torch.autograd.grad(td.GatherRows.apply(
            flat, keys64, layout.rev_ptr, layout.rev_perm), flat, gout)

    def library_route():
        return torch.autograd.grad(flat.index_select(0, keys64), flat, gout)
    out["lookup_port_ms"] = cuda_ms(port_route, iters=5, warmup=1)
    out["lookup_library_ms"] = cuda_ms(library_route, iters=5, warmup=1)
    del calls, rev_ptr, gout, rows, keys64, flat, layout
    gc.collect()
    torch.cuda.empty_cache()

    # serving and retrieval on the same model
    torch.cuda.reset_peak_memory_stats()
    for shape in ("serve_p99", "serve_bulk"):
        sc = tsteps._recsys_cell(RECSYS_ARCH, shape, device=dev, seed=seed,
                                 model=model)
        logits = sc.step()
        n = sc.inputs[1].shape[0]
        check(tuple(logits.shape) == (n,) and bool(
            torch.isfinite(logits).all()), f"{shape}: {n} finite logits")
        ms = cuda_ms(sc.step, iters=RECSYS_TIMED, warmup=1)
        out[shape] = dict(batch=n, ms=ms, predictions_per_s=n / ms * 1e3)
        del sc, logits
    rc = tsteps._recsys_cell(RECSYS_ARCH, "retrieval_cand", device=dev,
                             seed=seed, model=model)
    top, ix = rc.step()
    d1, uidx, cidx = rc.inputs
    n = cidx.shape[0]
    with torch.no_grad():
        scores = td.dlrm_forward(model, d1.expand(n, -1), torch.cat(
            [uidx.expand(n, -1, -1), cidx], dim=1)).cpu().numpy()
    order = np.argsort(-scores, kind="stable")[:top.shape[0]]
    check(np.array_equal(ix.cpu().numpy(), order)
          and np.array_equal(top.cpu().numpy(), scores[order]),
          f"retrieval's top {top.shape[0]} of {n} equals a stable sort of "
          "the same scores")
    ms = cuda_ms(rc.step, iters=RECSYS_TIMED, warmup=1)
    out["retrieval"] = dict(candidates=n, top_k=int(top.shape[0]), ms=ms,
                            candidates_per_s=n / ms * 1e3,
                            ties_in_top=int(len(order) - len(set(
                                scores[order].tolist()))))
    out["serve_peak_allocated_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del rc, top, ix, scores, cell, model
    gc.collect()
    torch.cuda.empty_cache()

    # run_recsys: a crash and a resume against an uninterrupted run
    tmp = tempfile.mkdtemp(prefix="chip_smoke_recsys_")
    kw = dict(arch=RECSYS_ARCH, steps=RECSYS_RESUME_STEPS, smoke=False,
              seed=seed, device=dev, vocab_size=RECSYS_RESUME_VOCAB,
              log_every=1)
    try:
        t0 = time.perf_counter()
        try:
            tlaunch.run_recsys(ckpt_dir=os.path.join(tmp, "a"),
                               fail_at=RECSYS_RESUME_FAIL_AT, **kw)
        except RuntimeError as e:
            check("injected failure" in str(e), f"run_recsys failed: {e}")
        else:
            check(False, "run_recsys did not stop at the injected failure")
        m1, _, resumed = tlaunch.run_recsys(ckpt_dir=os.path.join(tmp, "a"),
                                            fail_at=None, **kw)
        m2, _, clean = tlaunch.run_recsys(ckpt_dir=os.path.join(tmp, "b"),
                                          fail_at=None, **kw)
        out["resume_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    start = resumed[0]["step"]
    same = all(torch.equal(p, q) for p, q in zip(m1.parameters(),
                                                 m2.parameters()))
    out["resume"] = dict(resumed_at=start, resumed=resumed,
                         clean_losses=[h["loss"] for h in clean],
                         bit_equal=same and resumed == clean[start:])
    check(start == 10 and out["resume"]["bit_equal"],
          f"run_recsys resumed at step {start} ends with the uninterrupted "
          f"run's bits and history: {resumed} vs {clean[start:]}")
    del m1, m2

    # the smoke model's train step: card against CPU, float32
    small = tsteps._recsys_cell(RECSYS_ARCH, "train_batch", device="cpu",
                                seed=seed, smoke=True, batch=256)
    model_d = copy.deepcopy(small.model).to(dev)
    state_d = {key: ({n: t.to(dev, copy=True)
                      for n, t in small.opt_state[key].items()}
                     if key != "step" else small.opt_state[key].clone())
               for key in small.opt_state}
    batch_d = tuple(t.to(dev) for t in small.inputs)
    loss_c = td.dlrm_loss(small.model, *small.inputs)
    loss_c.backward()
    grads_c = {n: p.grad.clone() for n, p in small.model.named_parameters()}
    loss_d = td.dlrm_loss(model_d, *batch_d)
    loss_d.backward()
    g_err = max(float((p.grad.cpu() - grads_c[n]).abs().max()
                      / grads_c[n].abs().max().clamp(min=1e-30))
                for n, p in model_d.named_parameters())
    for mdl in (small.model, model_d):
        for p in mdl.parameters():
            p.grad = None
    m_c = small.step()
    tsteps.recsys_train_step(model_d, small.opt_cfg, state_d, batch_d)
    p_err = max(float((p.detach().cpu() - q.detach()).abs().max())
                for p, q in zip(model_d.parameters(),
                                small.model.parameters()))
    out["smoke_card_vs_cpu"] = dict(
        loss=abs(float(loss_d.detach()) - float(loss_c.detach())),
        grad_err_over_max=g_err, param_max_abs_err=p_err)
    check(out["smoke_card_vs_cpu"]["loss"] <= 1e-5 and g_err <= 1e-4
          and p_err <= 2 * m_c["lr"] + 1e-6,
          f"smoke recsys step card vs CPU: {out['smoke_card_vs_cpu']}")
    extra["recsys_table_grad"] = out["table_grad"]
    return out


def log_recsys(out):
    log(f"[recsys] {RECSYS_ARCH} at full width: {out['params']:,} "
        f"parameters, {out['state_gib']:.2f} GiB with the AdamW moments, "
        f"built in {out['setup_s']:.2f}s; a batch's {out['lookups']} lookups"
        f" hit {out['distinct_rows']} rows ({out['row0_share']:.3f} of them "
        f"row 0); layout {out['layout_ms']:.3f} ms (torch.sort + "
        f"searchsorted {out['layout_library_ms']:.3f} ms)")
    for i, st in enumerate(out["steps"]):
        log(f"[recsys] step {i}: {st['seconds']:.4f}s, loss {st['loss']}, "
            f"grad_norm {st['grad_norm']}, lr {st['lr']}")
    log(f"[recsys] steady step {out['steady_s'] * 1e3:.2f} ms "
        f"({out['samples_per_s']:.1f} samples/s); peak "
        f"{out['peak_allocated_gib']:.2f} GiB allocated, "
        f"{out['peak_reserved_gib']:.2f} GiB reserved; launches "
        f"{out['launches']}")
    log_profile("recsys step profile", out["profile"])
    log(f"[recsys] table gradient vs the plain route: {out['table_grad']}; "
        f"the lookup's forward + backward: port {out['lookup_port_ms']:.3f} "
        f"ms (the layout apart), autograd through index_select "
        f"{out['lookup_library_ms']:.3f} ms")
    for shape in ("serve_p99", "serve_bulk"):
        r = out[shape]
        log(f"[recsys] {shape}: {r['batch']} samples in {r['ms']:.3f} ms, "
            f"{r['predictions_per_s']:.1f} predictions/s")
    r = out["retrieval"]
    log(f"[recsys] retrieval: 1 query against {r['candidates']} candidates, "
        f"top {r['top_k']}, {r['ms']:.3f} ms ({r['candidates_per_s']:.1f} "
        f"candidates/s) == a stable sort of the scores; peak "
        f"{out['serve_peak_allocated_gib']:.2f} GiB")
    log(f"[recsys] run_recsys with {RECSYS_RESUME_VOCAB}-row tables "
        f"resumed at step {out['resume']['resumed_at']} == uninterrupted "
        f"(bit-equal: {out['resume']['bit_equal']}) in "
        f"{out['resume_s']:.1f}s; losses {out['resume']['clean_losses']}; "
        f"smoke card vs CPU {out['smoke_card_vs_cpu']}")
    for key, r in out["rows"].items():
        log_row(key, r)


# ------------------------------------------------------------------ main
# ------------------------------------------------------------ phase 13
# the multi-device engine, rank by rank on one card: worlds of the sharded
# convert and of the sequence-sharded decode; the sample on the sharded
# CSC (the reference's shard_preprocess fanouts); decode_32k's slots, the
# last two short (lengths below a slice: whole slices dead); the MoE
# groups at granite's 8 x 4,096 train tokens
MESH_WORLDS = (2, 4)
MESH_SEEDS, MESH_FANOUTS = 1024, (25, 10)
MESH_DECODE_LENS = (32768,) * 6 + (9000, 100)
# the slots whose slices are held against the twin (a full cache, one
# with a dead slice at world 4, one with dead slices at 2 and 4); the
# combined output is held on every slot
MESH_DECODE_CHECKED = (0, 6, 7)
MESH_HEAD_SPLITS = (2, 4)
MESH_KERNELS = ("decode_attention_partial",)
MOE_LOCAL_TOKENS, MOE_LOCAL_GROUPS = 8 * 4096, (2, 4)
# 13c's rank-by-rank decode step of 9a's engine (LM_SERVE_SLOTS slots of
# LM_SERVE_MAX_LEN positions): a position a slot, on both sides of the
# slice edges at worlds 2 and 4 (slices of 512 and 256), so that every
# rank owns some slot's insert and short slots leave whole slices dead
MESH_STEP_POS = (0, 255, 256, 511, 512, 700, 1022, 1023)
COMPRESS_ARCH = "granite-moe-1b-a400m"


def timed_stages(module, names):
    """Wrap ``module``'s functions ``names`` to add each call's time (a
    synchronise after it) to a dict; returns (the dict, the restore)."""
    import torch
    real = {n: getattr(module, n) for n in names}
    spent = {n: 0.0 for n in names}

    def wrap(n):
        def fn(*a, **kw):
            t0 = time.perf_counter()
            got = real[n](*a, **kw)
            torch.cuda.synchronize()
            spent[n] += time.perf_counter() - t0
            return got
        return fn
    for n in names:
        setattr(module, n, wrap(n))

    def restore():
        for n in names:
            setattr(module, n, real[n])
    return spent, restore


def same_sub(a, b):
    import torch
    return (torch.equal(a.csc.ptr, b.csc.ptr)
            and torch.equal(a.csc.idx, b.csc.idx)
            and torch.equal(a.order, b.order)
            and int(a.n_sub_nodes) == int(b.n_sub_nodes))


def mesh_convert_phase(dev, seed, coo):
    """13a: the sharded convert rank by rank at Reddit's 2^27 COO."""
    import numpy as np
    import torch
    from repro_torch.core import pipeline, prng
    from repro_torch.core.costmodel import MERGE_CFG
    from repro_torch.engine import shard
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import SLICE_CFG
    out = {}
    seeds = torch.from_numpy(np.random.default_rng(seed + 13).choice(
        REDDIT["nodes"], MESH_SEEDS, replace=False).astype(np.int32)).to(dev)
    key = prng.PRNGKey(seed + 13)
    for tag, cfg in (("slice", SLICE_CFG), ("merge", MERGE_CFG)):
        want = pipeline.convert(coo, cfg, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = pipeline.convert(coo, cfg, device=dev)
        torch.cuda.synchronize()
        single_s = time.perf_counter() - t0
        want_sub = pipeline.sample_subgraph(want, seeds, MESH_FANOUTS, key,
                                            cfg)
        for world in MESH_WORLDS:
            spent, restore = timed_stages(
                shard, ("local_sorted_run", "merge_runs", "pointer_block"))
            reset_launch_counts()
            t0 = time.perf_counter()
            try:
                csc = shard.shard_convert_ranks(coo, cfg, world)
                torch.cuda.synchronize()
            finally:
                restore()
            wall = time.perf_counter() - t0
            launches = {k: v for k, v in launch_counts().items() if v}
            equal = (torch.equal(csc.ptr, want.ptr)
                     and torch.equal(csc.idx, want.idx))
            check(equal, f"13a {tag} world {world}: the rank-by-rank "
                  "sharded convert equals convert bit for bit")
            sub = pipeline.sample_subgraph(csc, seeds, MESH_FANOUTS, key,
                                           cfg)
            check(same_sub(sub, want_sub),
                  f"13a {tag} world {world}: the {MESH_SEEDS}-seed "
                  f"{MESH_FANOUTS} sample on the sharded CSC equals the "
                  "sample on convert's")
            out[f"{tag} world {world}"] = dict(
                wall_s=wall, single_convert_s=single_s,
                stage_s=dict(spent), launches=launches, bit_equal=equal,
                sample_edges=int(sub.csc.n_edges))
            del csc, sub
        del want, want_sub
        gc.collect()
        torch.cuda.empty_cache()
    return out


def partial_bounds(q, k, cl, kw):
    """(the scores' bound for m, [B, Hkv, G, 1]) of a slice: twice the
    largest score's float32 error, dh·u·Σ|q_d k_d| + 4u|score|, over the
    live positions, and 8u of |m| (``twin_tolerance``'s E)."""
    import torch
    from repro_torch.models.attention import (_group_q, decode_mask,
                                              dequantize_kv)
    u = 2.0 ** -24
    b, h, _, dh = q.shape
    hkv, s = k.shape[1], k.shape[2]
    if kw.get("k_scale") is not None:
        k = dequantize_kv(k, kw["k_scale"])
    qg = (_group_q(q, hkv).float() * dh ** -0.5).double()
    kf = k.double()
    sc = torch.einsum("bkgqd,bkcd->bkgqc", qg, kf)
    cap = kw.get("logit_cap")
    if cap is not None:
        sc = cap * torch.tanh(sc / cap)
    err = dh * u * torch.einsum("bkgqd,bkcd->bkgqc", qg.abs(), kf.abs()) + (
        4 * u * sc.abs())
    mask = decode_mask(cl, s)[:, None, None, None, :]
    m = torch.where(mask, sc, -math.inf).amax(dim=-1)
    return 2 * torch.where(mask, err, 0.0).amax(dim=-1) + 8 * u * m.abs()


def partial_row(q, k, v, cl, kw, err):
    """The partial mode's row at one slice of the world-2 cut: the kernel,
    its twin and SDPA on the dequantized bf16 slice with a boolean mask (a
    near function: the normalised output, no (m, l)), each timed; the
    bound from the live rows' bytes (and int8 scales), q read, (m, l, acc)
    written."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (
        decode_attention_partial, decode_partial_plain)
    from repro_torch.models.attention import decode_mask, dequantize_kv
    b, h, _, dh = q.shape
    hkv, s = k.shape[1], k.shape[2]
    ms = cuda_ms(lambda: decode_attention_partial(q, k, v, cl, **kw))
    plain_ms = cuda_ms(lambda: decode_partial_plain(q, k, v, cl, **kw),
                       iters=3, warmup=1)
    kd, vd = (dequantize_kv(c, kw[f"{n}_scale"]).to(q.dtype)
              .repeat_interleave(h // hkv, 1) for c, n in ((k, "k"),
                                                           (v, "v")))
    mask = decode_mask(cl, s)[:, None, None, :]
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, kd, vd, attn_mask=mask))
    del kd, vd
    live = int(torch.clamp(cl, 0, s).sum())
    nbytes = (live * hkv * (2 * dh + 2 * 4) + q.numel() * q.element_size()
              + b * h * (2 + dh) * 4)
    b_ms, b_by = bound(nbytes, 4 * dh * (h // hkv) * live * hkv)
    return dict(name="decode_attention_partial", route="cuda",
                source="src/repro_torch/csrc/decode_attention.cu",
                replaces="src/repro/models/attention.py:240",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms,
                gbytes_per_s=nbytes / (ms * 1e-3) / 1e9,
                shape=f"one slice of 2: B {b}, H {h} over Hkv {hkv}, dh "
                      f"{dh}, int8 cache of {s} positions, {live} live "
                      f"({cl.tolist()}), {q.dtype} q, cap "
                      f"{kw['logit_cap']}; {nbytes / 1e6:.2f} MB (library: "
                      "scaled_dot_product_attention on the dequantized "
                      "bf16 slice, a boolean mask, no cap: a near "
                      "function, normalised, no (m, l))")


def mesh_decode_phase(dev, seed, extra):
    """13b: the partial mode at decode_32k's shapes, the sequence cut into
    2 and 4 slices and the heads into 2 and 4 groups, rank by rank."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.dist.collectives import (
        sharded_decode_attention_seq_ranks)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_partial, decode_partial_plain,
        twin_tolerance)
    cfg = get_config(LM_ARCH)
    b, h, hkv, dh = (len(MESH_DECODE_LENS), cfg.n_heads, cfg.n_kv_heads,
                     cfg.dh)
    s = DECODE_32K_LEN
    g = torch.Generator(device=dev).manual_seed(seed + 31)
    k = torch.randint(-127, 128, (b, hkv, s, dh), generator=g, device=dev,
                      dtype=torch.int8)
    v = torch.randint(-127, 128, (b, hkv, s, dh), generator=g, device=dev,
                      dtype=torch.int8)
    ks, vs = (torch.empty((b, hkv, s, 1), device=dev).uniform_(
        0.005, 0.03, generator=g) for _ in range(2))
    q = (torch.randn((b, h, 1, dh), generator=g, device=dev)
         * DECODE_Q_SCALE).to(torch.bfloat16)
    cl = torch.tensor(MESH_DECODE_LENS, dtype=torch.int32, device=dev)
    kw = dict(logit_cap=cfg.attn_logit_cap, k_scale=ks, v_scale=vs)
    out = {}

    # the path: counters to 0, the sequence-sharded decode at each world
    reset_launch_counts()
    combined = {w: sharded_decode_attention_seq_ranks(q, k, v, cl, w, **kw)
                for w in MESH_WORLDS}
    torch.cuda.synchronize()
    out["launches"] = launch_counts()
    want_l = 2 * sum(MESH_WORLDS)
    check(out["launches"]["decode_attention_partial"] == want_l
          and all(n == 0 for name, n in out["launches"].items()
                  if name != "decode_attention_partial"),
          f"13b: {want_l} partial-mode launches (2 a slice) and no other "
          f"kernel: {out['launches']}")
    dense = decode_attention(q, k, v, cl, **kw)
    idx = torch.tensor(MESH_DECODE_CHECKED, device=dev)

    def pick(t):
        return t.index_select(0, idx)
    # the tolerance a slot at a time (its float64 cache is 1 GiB a slot)
    tol = torch.cat([twin_tolerance(
        q[i:i + 1], k[i:i + 1], v[i:i + 1], cl[i:i + 1],
        logit_cap=kw["logit_cap"], k_scale=ks[i:i + 1],
        v_scale=vs[i:i + 1]) for i in range(b)])
    for w, got in combined.items():
        share = decode_ratio(got, dense, tol)
        out[f"combined_world_{w}_share_of_tol"] = share
        check(share <= 1.0 and not torch.isnan(got).any(),
              f"13b: the {w}-slice combine within twin_tolerance of the "
              f"dense kernel on all {b} slots ({share}) and no NaN")
    del tol

    # each slice against its twin, on the checked slots
    worst = {"m": 0.0, "out": 0.0}
    err = 0.0
    for w in MESH_WORLDS:
        s_l = s // w
        for r in range(w):
            sl = slice(r * s_l, (r + 1) * s_l)
            kr, vr = k[:, :, sl].contiguous(), v[:, :, sl].contiguous()
            kwr = dict(kw, k_scale=ks[:, :, sl].contiguous(),
                       v_scale=vs[:, :, sl].contiguous())
            lr = torch.clamp(cl - r * s_l, 0, s_l).to(torch.int32)
            m, l, acc = decode_attention_partial(q, kr, vr, lr, **kwr)
            subr = {n: pick(t) if torch.is_tensor(t) else t
                    for n, t in kwr.items()}
            pm, pl_, pacc = decode_partial_plain(pick(q), pick(kr),
                                                 pick(vr), pick(lr), **subr)
            m, l, acc = pick(m), pick(l), pick(acc)
            live = pick(lr) > 0
            dead = ~live
            check(bool(torch.all(m[dead] == -math.inf))
                  and bool(torch.all(l[dead] == 0))
                  and bool(torch.all(acc[dead] == 0)),
                  f"13b: world {w} rank {r}: a dead slice gives (-inf, 0, 0)")
            if not live.any():
                continue
            lv = live.nonzero()[:, 0]
            mt = partial_bounds(pick(q)[lv], pick(kr)[lv], pick(lr)[lv],
                                {n: t[lv] if torch.is_tensor(t) else t
                                 for n, t in subr.items()})
            m_share = decode_ratio(m[lv], pm[lv], mt)
            o = (acc / l[..., None])[lv].reshape(len(lv), h, 1, dh)
            po = (pacc / pl_[..., None])[lv].reshape(len(lv), h, 1, dh)
            otol = twin_tolerance(pick(q)[lv].float(), pick(kr)[lv],
                                  pick(vr)[lv], pick(lr)[lv],
                                  logit_cap=kw["logit_cap"],
                                  k_scale=subr["k_scale"][lv],
                                  v_scale=subr["v_scale"][lv])
            o_share = decode_ratio(o, po, otol)
            err = max(err, float((o - po).abs().max()))
            worst["m"] = max(worst["m"], m_share)
            worst["out"] = max(worst["out"], o_share)
            check(m_share <= 1.0 and o_share <= 1.0,
                  f"13b: world {w} rank {r}: the slice's m within the "
                  f"scores' bound ({m_share}) and its normalised output "
                  f"within twin_tolerance ({o_share}) of the twin")
            del kr, vr, kwr
    out["slice_worst_share"] = worst

    # the head split: each group of KV heads alone, then concatenated
    for n in MESH_HEAD_SPLITS:
        hl, gq = hkv // n, h // hkv
        parts = []
        for r in range(n):
            hs = slice(r * hl, (r + 1) * hl)
            qr = q.reshape(b, hkv, gq, dh)[:, hs].reshape(b, hl * gq, 1, dh)
            parts.append(decode_attention(
                qr.contiguous(), k[:, hs].contiguous(),
                v[:, hs].contiguous(), cl, logit_cap=kw["logit_cap"],
                k_scale=ks[:, hs].contiguous(),
                v_scale=vs[:, hs].contiguous()))
        same = torch.equal(torch.cat(parts, dim=1), dense)
        out[f"head_split_{n}_bit_equal"] = same
        check(same, f"13b: the head split in {n} groups equals the dense "
              "kernel bit for bit")
    s_l = s // 2
    kw0 = dict(kw, k_scale=ks[:, :, :s_l].contiguous(),
               v_scale=vs[:, :, :s_l].contiguous())
    out["row"] = partial_row(q, k[:, :, :s_l].contiguous(),
                             v[:, :, :s_l].contiguous(),
                             torch.clamp(cl, 0, s_l).to(torch.int32), kw0,
                             err)
    extra["mesh_decode"] = {k_: v_ for k_, v_ in out.items() if k_ != "row"}
    del k, v, ks, vs, dense, combined
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lm_step_ranks(eng, seed, out):
    """13c, inside 9a: one decode step of the engine's model at
    MESH_STEP_POS on a random cache, every cache stack cut into each of
    MESH_WORLDS ranks' sequence slices and the ranks run in turn (the
    mesh engine's step at that world, the all-reduces folded in one
    process): ``lm_decode_step`` through each stack's ``CacheShard``;
    each layer's insert made rank by rank (``models/transformer.py``
    ``_cache_insert`` with each rank's ``CacheShard`` on its slice, only
    the owned positions written) and held bit for bit against the
    whole-cache insert of the same k and v; each layer's combined
    attention (``sharded_decode_attention_seq_ranks``) within
    ``twin_tolerance`` of the dense kernel; counters to 0 first, 2
    partial-mode launches a rank and layer; the step's logits within
    DECODE_PATH_TOL of the whole-cache step's, its tokens the same where
    the margin clears that."""
    import torch
    from repro_torch.dist.collectives import (
        sharded_decode_attention_seq_ranks)
    from repro_torch.kernels import (add_launch_counts, launch_counts,
                                     reset_launch_counts)
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      twin_tolerance)
    from repro_torch.models import transformer as tt
    model, cfg, dev = eng.params, eng.cfg, eng.device
    n_layers = len(model.layers)
    g = torch.Generator(device=dev).manual_seed(seed + 17)
    cache = tt.make_cache(cfg, batch=eng.n_slots, max_len=eng.max_len,
                          device=dev)
    fill_cache(cache, cfg, g)
    pos = torch.tensor(MESH_STEP_POS, dtype=torch.int32, device=dev)
    toks = torch.randint(0, cfg.vocab, (eng.n_slots, 1), generator=g,
                         device=dev, dtype=torch.int32)

    def clone(c):
        return {st: {n: t.clone() for n, t in v.items()}
                for st, v in c.items()}
    _, want = tt.lm_decode_step(model, clone(cache), toks, pos,
                                return_logits=True)
    want = want.float()
    real = tt._cache_insert
    res = {}
    t0 = time.perf_counter()
    for world in MESH_WORLDS:
        seen = dict(inserts=0, insert_equal=True, attn_calls=0,
                    attn_share=0.0)

        def insert(cfg_, lc, k, v, p_, shard=None):
            ref = {n: t.clone() for n, t in lc.items()}
            real(cfg_, ref, k, v, p_)
            s_l = shard.length // world
            for r in range(world):
                view = {n: t[:, :, r * s_l:(r + 1) * s_l]
                        for n, t in lc.items()}
                real(cfg_, view, k, v, p_,
                     tt.CacheShard(shard.length, r * s_l, 0, None))
            seen["inserts"] += 1
            seen["insert_equal"] &= all(torch.equal(lc[n], ref[n])
                                        for n in lc)

        def attn(q, k, v, cl, *, window=None, logit_cap=None, k_scale=None,
                 v_scale=None):
            kw = dict(logit_cap=logit_cap, k_scale=k_scale, v_scale=v_scale)
            got = sharded_decode_attention_seq_ranks(q, k, v, cl, world,
                                                     **kw)
            path = launch_counts()  # the comparison's launches not counted
            tol = twin_tolerance(q, k, v, cl, **kw)
            share = decode_ratio(got, decode_attention(q, k, v, cl, **kw),
                                 tol)
            reset_launch_counts()
            add_launch_counts(path)
            seen["attn_calls"] += 1
            seen["attn_share"] = max(seen["attn_share"], share)
            return got

        c = clone(cache)
        shards = {st: tt.CacheShard(t["k"].shape[3], 0, 0, attn)
                  for st, t in c.items()}
        tt._cache_insert = insert
        reset_launch_counts()
        try:
            nxt, logits = tt.lm_decode_step(model, c, toks, pos,
                                            return_logits=True,
                                            shards=shards)
            torch.cuda.synchronize()
        finally:
            tt._cache_insert = real
        launches = {k_: v_ for k_, v_ in launch_counts().items() if v_}
        logits = logits.float()
        err = float((logits - want).abs().max())
        top = torch.topk(want, 2, dim=-1).values
        clear = (top[:, 0] - top[:, 1]) > DECODE_PATH_TOL
        same = bool(torch.all((logits.argmax(-1) == want.argmax(-1))
                              | ~clear))
        res[world] = dict(seen, launches=launches, logit_max_abs_err=err,
                          tokens_compared=int(clear.sum()), same_tokens=same)
        want_l = 2 * world * n_layers
        check(seen["inserts"] == n_layers and seen["insert_equal"],
              f"13c: world {world}: every layer's insert made rank by rank "
              "through CacheShard equals the whole-cache insert bit for bit")
        check(seen["attn_calls"] == n_layers and seen["attn_share"] <= 1.0,
              f"13c: world {world}: every layer's combined attention within "
              f"twin_tolerance of the dense kernel ({seen['attn_share']})")
        check(launches == {"decode_attention_partial": want_l},
              f"13c: world {world}: {want_l} partial-mode launches and no "
              f"other kernel in the step: {launches}")
        check(err <= DECODE_PATH_TOL and same,
              f"13c: world {world}: the rank-by-rank step's logits within "
              f"{DECODE_PATH_TOL} of the whole-cache step's ({err}), the "
              f"same tokens on the {int(clear.sum())} slots whose margin "
              "clears it")
        del c, logits
    res["seconds"] = time.perf_counter() - t0
    out["mesh_step_ranks"] = res
    del cache, want
    gc.collect()
    torch.cuda.empty_cache()


def lm_mesh_serve(eng, seed, reqs, handles, mesh, out):
    """13c, inside 9a: the same requests served by a ServeEngine of the
    same model with ``mesh`` (NCCL at world 1): the same tokens, one
    captured step program. At world 1 the mesh engine holds no cache
    shard and issues no collective (its step is the single-device one);
    ``lm_step_ranks`` runs the shard path rank by rank."""
    import torch
    from repro_torch.serve import ServeEngine
    meng = ServeEngine(eng.cfg, eng.params, n_slots=eng.n_slots,
                       max_len=eng.max_len, prompt_cap=eng.prompt_cap,
                       mesh=mesh, device=eng.device)
    serve_lm(meng, [([1, 2, 3], 2)])
    got, dt = serve_lm(meng, reqs)
    same = [h.tokens_out for h in got] == [h.tokens_out for h in handles]
    out["mesh_serve"] = dict(wall_s=dt, same_tokens=same,
                             step_programs=meng.step_cache_size(),
                             shards=sorted(meng.shards))
    check(same and meng.step_cache_size() == 1,
          "13c: ServeEngine(mesh=) at world 1 serves the same tokens as "
          f"without a mesh in one captured step program "
          f"({meng.step_cache_size()})")
    del meng
    gc.collect()
    torch.cuda.empty_cache()
    lm_step_ranks(eng, seed, out)


def mesh_entry_phase(dev, seed, mesh, coo):
    """13c: the real entry points on the NCCL world-1 mesh."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import pipeline, prng
    from repro_torch.dist.hints import layout
    from repro_torch.engine import PreprocService
    from repro_torch.launch.serve import SLICE_CFG
    from repro_torch.launch.steps import (PREPROCESS_FANOUTS,
                                          PREPROCESS_SEEDS, preprocess_cells)
    from repro_torch.models.moe import (moe_apply, moe_apply_groups,
                                        moe_apply_local, moe_init)
    from repro_torch.models.transformer import LM
    from repro_torch.train.compress import (compressed_psum_tree, dequantize,
                                            quantize_ef, zeros_like_error)
    out = {"mesh": str(mesh), "backend": torch.distributed.get_backend()}
    seeds = torch.from_numpy(np.random.default_rng(seed + 14).choice(
        REDDIT["nodes"], PREPROCESS_SEEDS, replace=False).astype(
            np.int32)).to(dev)
    key = prng.PRNGKey(seed + 14)

    # the service on the mesh (dp 1: the single-device table)
    t0 = time.perf_counter()
    sub = PreprocService(PREPROCESS_FANOUTS, mesh=mesh).preprocess(
        coo, seeds, key, cfg=SLICE_CFG)
    torch.cuda.synchronize()
    out["service_s"] = time.perf_counter() - t0
    want = pipeline.preprocess(coo, seeds, PREPROCESS_FANOUTS, key,
                               SLICE_CFG, device=dev)
    check(same_sub(sub, want), "13c: PreprocService(mesh) at Reddit size "
          "equals pipeline.preprocess")

    # the paper-technique steps over the mesh
    conv, samp, e2e = preprocess_cells(mesh)
    from repro_torch.core.costmodel import EngineConfig
    ecfg = EngineConfig(w_upe=8192, n_upe=0)
    steps = {}
    t0 = time.perf_counter()
    csc = conv.step(coo)
    torch.cuda.synchronize()
    steps[conv.arch_id] = time.perf_counter() - t0
    ref = pipeline.convert(coo, ecfg, device=dev)
    check(torch.equal(csc.ptr, ref.ptr) and torch.equal(csc.idx, ref.idx),
          "13c: preprocess_cells' convert equals pipeline.convert")
    t0 = time.perf_counter()
    a = samp.step(csc, seeds, key)
    torch.cuda.synchronize()
    steps[samp.arch_id] = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = e2e.step(coo, seeds, key)
    torch.cuda.synchronize()
    steps[e2e.arch_id] = time.perf_counter() - t0
    check(same_sub(a, b), "13c: preprocess_cells' sample on the converted "
          "CSC equals its end-to-end step")
    out["preprocess_cells_s"] = steps
    del csc, ref, a, b, sub, want
    gc.collect()
    torch.cuda.empty_cache()

    # the int8 all-reduce over a gradient tree of granite's shapes
    gcfg = get_config(COMPRESS_ARCH)
    model = LM(gcfg, seed=seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 15)
    grads = {n: (torch.randn(p.shape, generator=gen, device=dev) * 1e-3)
             .to(p.dtype) for n, p in model.named_parameters()}
    del model
    errs = zeros_like_error(grads)
    want_err = zeros_like_error(grads)
    group = mesh.get_group("data")
    t0 = time.perf_counter()
    equal = True
    for _ in range(2):
        red, errs = compressed_psum_tree(grads, errs, group)
        for n, g in grads.items():
            q, scale, e = quantize_ef(g, want_err[n])
            equal &= torch.equal(red[n], dequantize(q, scale).to(g.dtype))
            equal &= torch.equal(errs[n], e)
            want_err[n] = e
    torch.cuda.synchronize()
    out["compress"] = dict(leaves=len(grads),
                           elements=sum(g.numel() for g in grads.values()),
                           seconds=time.perf_counter() - t0, bit_equal=equal)
    check(equal, "13c: compressed_psum_tree on NCCL at world 1 equals "
          "quantize then dequantize, values and error buffers, twice")
    del grads, errs, want_err, red
    gc.collect()
    torch.cuda.empty_cache()

    # shard-local MoE at granite's train tokens
    from types import SimpleNamespace
    w = SimpleNamespace(**moe_init(torch.Generator(device=dev).manual_seed(
        seed + 16), gcfg.d_model, gcfg.d_ff, gcfg.moe_experts, gcfg.dtype,
        dev))
    x = torch.randn((MOE_LOCAL_TOKENS, gcfg.d_model), generator=gen,
                    device=dev).to(gcfg.dtype)
    k = gcfg.moe_top_k
    with torch.no_grad(), layout(mesh):
        y1, aux1 = moe_apply_local(w, x, top_k=k)
        y0, aux0 = moe_apply(w, x, top_k=k)
        check(torch.equal(y1, y0) and torch.equal(aux1, aux0),
              "13c: moe_apply_local on one rank is moe_apply")
        moe = {}
        for n in MOE_LOCAL_GROUPS:
            t0 = time.perf_counter()
            y, aux = moe_apply_groups(w, x, n, top_k=k)
            torch.cuda.synchronize()
            per = [moe_apply(w, xg, top_k=k)[0] for xg in x.chunk(n)]
            same = torch.equal(y, torch.cat(per))
            moe[n] = dict(seconds=time.perf_counter() - t0, aux=float(aux),
                          y_equal=same)
            check(same and math.isfinite(float(aux)),
                  f"13c: moe_apply_groups in {n} groups: each group's y "
                  "equals moe_apply on its tokens; a finite aux")
    out["moe_local"] = moe
    return out


def grok_train_phase(dev, seed, extra):
    """13d: grok-1-314b's one-layer train cell on the card, when its
    reckoned peak stays under LM_TRAIN_PEAK_GIB."""
    arch, layers, seq = LM_TRAIN_GROK
    gib = reckoned_train_gib(lm_train_grok_cfg(), seq, 1, 2)
    if gib > LM_TRAIN_PEAK_GIB:
        log(f"[{arch} train] held on the CPU: one layer at {seq} tokens "
            f"reckons {gib:.1f} GiB, past {LM_TRAIN_PEAK_GIB} GiB")
        return None
    out = lm_train_config_phase(dev, seed, arch, layers, seq, 1, False,
                                extra, two_steps=True)
    log_lm_train_config(out)
    log(f"[{out['tag']}] peak {out['peak_allocated_gib']:.2f} GiB allocated "
        f"({out['peak_reserved_gib']:.2f} reserved) against the reckoned "
        f"{out['reckoned_gib']:.2f} GiB; two steps from one saved state "
        f"bit-equal ({out['two_steps_by']}): {out['two_steps_bit_equal']}")
    return out


def log_mesh(aout, dout, cout, mserve, mstep):
    for key, r in aout.items():
        log(f"[mesh convert] {key}: bit-equal {r['bit_equal']}, wall "
            f"{r['wall_s']:.3f}s (single-device convert "
            f"{r['single_convert_s']:.3f}s), stages {r['stage_s']}, "
            f"launches {r['launches']}, sample edges {r['sample_edges']}")
    log(f"[mesh decode] launches {dout['launches']}; combined shares of "
        "twin_tolerance "
        f"{ {k: v for k, v in dout.items() if k.startswith('combined')} }; "
        f"slices' worst shares {dout['slice_worst_share']}; head splits "
        f"bit-equal { {k: v for k, v in dout.items() if 'head' in k} }")
    log_row("decode_attention_partial", dout["row"])
    log(f"[mesh nccl] {cout['mesh']} ({cout['backend']}): service "
        f"{cout['service_s']:.3f}s, preprocess_cells "
        f"{cout['preprocess_cells_s']}, compress {cout['compress']}, moe "
        f"{cout['moe_local']}; ServeEngine(mesh=) {mserve}")
    log(f"[mesh step] a decode step rank by rank (worlds {MESH_WORLDS}): "
        f"{mstep}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=16)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build  # the port must be importable

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0].strip()
    log(f"[device] nvidia-smi: {smi}")
    log(f"[device] torch: {torch.cuda.get_device_name(0)} "
        f"(torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} visible)")

    # 2. build
    t0 = time.perf_counter()
    built = _build.build()
    log(f"[build] {sorted(_build.SOURCES)} in "
        f"{time.perf_counter() - t0:.2f}s wall ({built})")
    for name, text in sorted(_build.BUILD_LOG.items()):
        fn = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1] if "'" in line else line
            elif "registers" in line or "spill" in line:
                log(f"[build] {name} {fn}: {line.strip()}")
    # the bf16 flash kernels, from their SASS (cached builds too): one
    # instantiation per head width, each with every product of one tile on
    # the tensor cores and no local-memory traffic, so no spills
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    for lib, kernel in MMA_KERNELS:
        sass = sass_summary(_build.library_path(lib), kernel)
        log(f"[build] {kernel} (cuobjdump -sass): {{name: (HMMA, "
            f"LDL + STL)}} {sass}")
        widths = []
        for name, (hmma, local) in sass.items():
            dh, n = map(int, re.search(kernel + r"ILi(\d+)ELi(\d+)E",
                                       name).groups())
            widths.append(dh)
            want = mma_per_tile(kernel, dh, n)
            check(hmma >= want and local == 0,
                  f"{kernel}<{dh}, {n}>: {hmma} HMMA (at least {want}) and "
                  f"{local} local loads and stores (none)")
        check(sorted(widths) == sorted(HEAD_DIMS),
              f"{kernel} is built for every head width: {widths}")

    # 3. kernels
    rows, extra = kernel_phase(dev, args.seed)
    merge_rows, merge_extra = merge_kernel_phase(dev, args.seed)
    rows.update(merge_rows)
    extra.update(merge_extra)
    for key, r in rows.items():
        log_row(key, r)

    # 4. the slice path
    out, coo, csc, eng, reqs, handles, feats = main_path(dev, args.seed,
                                                         args.requests)
    log(f"[convert] Reddit scale ({REDDIT['nodes']} nodes, "
        f"{REDDIT['edges']} edges, capacity 2^27): {out['convert_s']:.3f}s; "
        f"launches {out['convert_launches']}")
    log_serve("serve", out)
    check(all(out["launches"][k] > 0 for k in SLICE_KERNELS),
          f"every kernel of the slice path launched: {out['launches']}")
    lane = serve_launch_checks("slice", eng, out, reqs, handles)
    check(lane["digit_hist"] == lane["digit_scatter"] == REQUEST_DIGIT_PASSES
          and lane["ptr_seg_sum"] == len(SCAN_CALLS),
          f"a slice request (lane) runs {REQUEST_DIGIT_PASSES} digit_hist "
          f"and digit_scatter launches and {len(SCAN_CALLS)} ptr_seg_sum: "
          f"{lane}")
    log(f"[serve] captured step: {out['serve']['steps']} replays, "
        f"{out['step_launches']} launches a replay, {lane} a lane")
    # the two-pass Ordering's two sorts, each on the card's own schedule;
    # the reference design's pair held off the path
    from repro_torch.kernels.radix_sort import global_radix_schedule
    passes = 2 * len(global_radix_schedule(REDDIT["nodes"].bit_length(),
                                           RADIX_BITS))
    cl = out["convert_launches"]
    check(cl["digit_hist"] == cl["digit_scatter"] == passes
          and out["launches"]["digit_partition_hist"] == 0
          and out["launches"]["digit_rank_gather"] == 0,
          f"the convert ran {passes} digit_hist and digit_scatter launches "
          f"and the path no digit_partition_hist or digit_rank_gather: "
          f"{cl}; {out['launches']}")

    # 5. slice checks and profile
    checks(dev, args.seed, coo, csc, eng, reqs, handles, extra)
    log("[checks] convert == torch.sort strategy, batched == sequential, "
        "kernels == twins at convert scale, card == CPU on a small graph: ok")
    big = max(range(len(reqs)), key=lambda i: len(reqs[i]))
    rank_rows, extra["rank_epilogue"] = rank_phase(
        dev, coo, eng, reqs[big], handles[big].rid)
    for key, r in rank_rows.items():
        log_row(key, r)
    rows.update(rank_rows)
    scan_rows, extra["ptr_scan"] = scan_phase(dev, args.seed, eng, reqs[big],
                                              handles[big].rid)
    for key, r in scan_rows.items():
        log_row(key, r)
    rows.update(scan_rows)
    out["profile"] = profile_phase(eng, reqs[big], handles[big].rid)
    log_profile("profile", out["profile"])
    copy = out["profile"]["kernels"].get("copy", {}).get("device_ms", 0.0)
    scans = out["profile"]["kernels"].get("span_sum_kernel", {})
    check(copy < COPY_BOUND_MS and scans.get("count") == len(SCAN_CALLS),
          f"the profiled slice request ran {len(SCAN_CALLS)} span sums "
          f"({scans}) and copies of {copy:.3f} ms, less than one transposing"
          f" copy of its layer-1 messages could take ({COPY_BOUND_MS} ms)")
    out["step_profile"] = step_profile(eng, reqs, handles, out["lane_trace"])
    log_profile("step profile", out["step_profile"])
    log(f"[step profile] a replayed step: wall {out['step_profile']['step_wall_ms']:.2f} "
        f"ms, device span {out['step_profile']['step_device_span_ms']:.2f} ms "
        "(medians of 5, unprofiled)")
    out["convert_profile"] = sprof = convert_profile(dev, coo, "slice")
    log_profile("slice convert profile", sprof)
    log(f"[slice convert profile] kernels other than the hand-written "
        f"ones {sprof['other_device_ms']:.3f} ms")
    check(sprof["kernels"].get("digit_scatter_kernel", {}).get("count")
          == passes and "rank_gather_kernel" not in sprof["kernels"]
          and "partition_hist_kernel" not in sprof["kernels"],
          f"the profiled slice convert ran {passes} digit_scatter_kernel "
          f"launches and no rank_gather_kernel: {sprof['kernels']}")
    del coo

    # 6. the merge path
    mout, mcoo, mcsc, meng, mreqs, mhandles = merge_path(dev, args.seed,
                                                         args.requests, csc,
                                                         feats)
    log(f"[merge convert] {REDDIT['nodes']} nodes, {REDDIT['edges']} "
        f"edges (capacity 2^27) under MERGE_CFG: {mout['convert_s']:.3f}s; "
        f"launches {mout['convert_launches']}")
    log_serve("merge serve", mout)
    check(all(mout["launches"][k] > 0 for k in MERGE_KERNELS),
          f"every kernel of the merge path launched: {mout['launches']}")
    mlane = serve_launch_checks("merge", meng, mout, mreqs, mhandles)
    check(mlane.get("ptr_seg_sum", 0) == 0
          and mlane["segment_sum_sorted"] == MERGE_SUMS,
          f"a merge request (lane) aggregates on {MERGE_SUMS} "
          f"segment_sum_sorted launches, not the span sum: {mlane}")
    log(f"[merge serve] captured step: {mout['serve']['steps']} replays, "
        f"{mout['step_launches']} launches a replay, {mlane} a lane")
    # two sorts (the two-pass Ordering), each: the fused merge to 65,536,
    # then one merge_rung launch a rung
    from repro_torch.core.ordering import merge_round_fan_ins
    from repro_torch.kernels.merge import DEFAULT_MAX_BLOCK
    from repro_torch.launch.serve import MERGE_CFG
    rungs = 2 * len(merge_round_fan_ins(MERGE_CONVERT_CAP, DEFAULT_MAX_BLOCK,
                                        MERGE_CFG.merge_fan_in))
    check(mout["convert_launches"]["merge_rung"] == rungs
          and mout["convert_launches"]["fused_merge"] == 2,
          f"the merge convert ran its {rungs} upper rungs as merge_rung "
          f"launches and 2 fused merges: {mout['convert_launches']}")

    # 7. merge checks and profile
    merge_checks(dev, args.seed, mcoo, mcsc, meng, mreqs, mhandles, eng,
                 extra)
    log("[merge checks] convert == torch.sort strategy, batched == "
        "sequential, subgraphs == slice path's, logits == the slice path's "
        "bit for bit, card == CPU on a small graph: ok")
    rows["segment_sum_sorted"], extra["merge_sums"] = merge_sum_phase(
        meng, mreqs[big], mhandles[big].rid)
    log_row("segment_sum_sorted", rows["segment_sum_sorted"])
    mout["profile"] = profile_phase(meng, mreqs[big], mhandles[big].rid)
    log_profile("merge profile", mout["profile"])
    mout["step_profile"] = step_profile(meng, mreqs, mhandles,
                                        mout["lane_trace"])
    log_profile("merge step profile", mout["step_profile"])
    log(f"[merge step profile] a replayed step: wall "
        f"{mout['step_profile']['step_wall_ms']:.2f} ms, device span "
        f"{mout['step_profile']['step_device_span_ms']:.2f} ms (medians of "
        "5, unprofiled)")
    mout["convert_profile"] = cprof = convert_profile(dev, mcoo, "merge")
    log_profile("merge convert profile", cprof)
    log(f"[merge convert profile] kernels other than the hand-written "
        f"ones {cprof['other_device_ms']:.3f} ms; the merge rungs' device "
        f"spans {cprof['merge_rung_spans_ms']} ms (sum "
        f"{sum(cprof['merge_rung_spans_ms']):.3f}) over rungs of fan-in "
        f"{cprof['merge_rung_fan_ins']}; plain ladder ops: convert "
        f"{cprof['ops']}, request {mout['profile']['ops']}")
    check(not cprof["ops"] and len(cprof["merge_rung_spans_ms"]) == rungs,
          f"the profiled convert ran no plain ladder op ({cprof['ops']}) "
          f"and {rungs} merge_rung calls")
    del meng, eng, handles, mhandles
    gc.collect()
    torch.cuda.empty_cache()


    # 7a. the engine service: no serve engine is alive (no CUDA graph is
    # captured while a prefetch producer runs)
    t0 = time.perf_counter()
    sout = service_phase(dev, args.seed, mcoo, mcsc, feats)
    log_service(sout)
    check(all(sout["launches"][k] > 0 for k in SERVICE_KERNELS),
          f"every kernel of the service phase launched: {sout['launches']}")
    log(f"[service] phase done in {time.perf_counter() - t0:.1f}s")
    del mcoo, mcsc
    gc.collect()
    torch.cuda.empty_cache()

    # 7b. the GAT, GatedGCN and MeshGraphNet families served
    fouts = {}
    for arch, which in FAMILIES:
        tag = f"{arch} {which}"
        fout, feng, freqs, fhandles = family_path(
            dev, args.seed, arch, which, csc, feats, args.requests)
        log_serve(tag, fout)
        kernels = SLICE_KERNELS if which == "slice" else MERGE_KERNELS
        check(all(fout["launches"][k] > 0 for k in kernels),
              f"{tag}: every kernel of its routing launched: "
              f"{fout['launches']}")
        flane = family_checks(dev, args.seed, tag, arch, which, feng, fout,
                              freqs, fhandles, extra)
        log(f"[{tag}] {fout['params']:,} parameters; captured step: "
            f"{fout['serve']['steps']} replays, {fout['step_launches']} "
            f"launches a replay, {flane} a lane; largest request's logits "
            f"up to {fout['largest_logit_abs_max']:.4g}; batched == "
            "sequential, sums == twins, small graph card == CPU: ok")
        log_profile(f"{tag} step profile", fout["step_profile"])
        log(f"[{tag} step profile] a replayed step: wall "
            f"{fout['step_profile']['step_wall_ms']:.2f} ms, device span "
            f"{fout['step_profile']['step_device_span_ms']:.2f} ms")
        fouts[tag] = fout
        del feng, fhandles
        gc.collect()
        torch.cuda.empty_cache()

    # 7c. keysort served; reservoir run eagerly; both against the host
    t0 = time.perf_counter()
    csc_h = host_csc(csc)
    kout, keng, kreqs, khandles = family_path(
        dev, args.seed, "graphsage-reddit", "slice", csc, feats,
        args.requests, selection="keysort")
    log_serve("keysort serve", kout)
    check(all(kout["launches"][k] > 0 for k in SLICE_KERNELS),
          f"keysort: every kernel of the slice path launched: "
          f"{kout['launches']}")
    klane = family_checks(dev, args.seed, "keysort", "graphsage-reddit",
                          "slice", keng, kout, kreqs, khandles, extra)
    kout["host_sub_nodes"] = keysort_checks(keng, kreqs, khandles, csc_h)
    log_profile("keysort step profile", kout["step_profile"])
    log(f"[keysort] captured step: {kout['serve']['steps']} replays, "
        f"{klane} a lane; batched == sequential; {HOST_CHECKED} requests' "
        f"subgraphs ({kout['host_sub_nodes']} nodes) card == host: ok")
    del keng, khandles
    gc.collect()
    torch.cuda.empty_cache()
    rout = selection_phase(dev, args.seed, csc, csc_h)
    check(all(rout["launches"][k] > 0 for k in SLICE_KERNELS
              if k != "ptr_seg_sum"),
          f"reservoir sampling: every sampling kernel of the slice path "
          f"launched: {rout['launches']}")
    log(f"[reservoir] {RESERVOIR_REQUESTS} requests ({rout['seeds']} seeds, "
        f"{rout['sub_nodes']} subgraph nodes) card == host: ok; one "
        f"{SEED_CAP}-seed sample, wall s: {rout['sample_s']}; phase "
        f"{time.perf_counter() - t0:.1f}s")
    del csc_h

    # 7d. graph updates streamed through the captured step
    uout = update_phase(dev, args.seed, csc, feats)
    check(all(uout["launches"][k] > 0 for k in SLICE_KERNELS),
          f"updates: every kernel of the slice path launched: "
          f"{uout['launches']}")
    log(f"[updates] {uout['queries']} queries and {uout['updates']} updates "
        f"of {UPDATE_EDGES} + {UPDATE_EDGES} edges in {uout['stream_s']:.3f}"
        f"s ({uout['steps']} steps): every prediction == the chained oracle,"
        f" final CSC == oracle, one step program, bindings kept; update "
        f"latency ms {uout['update_latency_ms']}, apply host ms "
        f"{uout['update_apply_host_ms']}")
    del csc, feats
    gc.collect()
    torch.cuda.empty_cache()

    # 7e. GNN training: run_gnn at full width, resumed bit for bit, the
    # backward through the span sum against the float64 twins
    t0 = time.perf_counter()
    gout = gnn_train_phase(dev, args.seed)
    log_gnn_train(gout)
    extra["span_sum_backward"] = gout["span_sum_backward"]
    log(f"[gnn train] phase done in {time.perf_counter() - t0:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[time] GNN phases done at {time.perf_counter() - t_start:.1f}s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated")

    # 8. the LM slice's kernels
    lm_rows, lm_extra = lm_kernel_phase(dev, args.seed)
    extra.update(lm_extra)
    for key, r in lm_rows.items():
        log_row(key, r)
    rows.update(lm_rows)
    log(f"[lm kernels] flash float32 at {FLASH_F32_SEQ} tokens within "
        f"{FLASH_F32_TOL} of the twin: {lm_extra}")

    # 9. the LM prefill path
    lout, cell, logits = lm_path(dev, args.seed)
    n_layers = cell.model.cfg.n_layers
    log(f"[lm] {LM_ARCH} at full width: {lout['params']:,} parameters "
        f"({lout['weights_gib']:.2f} GiB on the card), built in "
        f"{lout['setup_s']:.2f}s")
    log(f"[lm] prefill of {LM_BATCH} x {LM_SEQ} tokens: first "
        f"{lout['first_s']:.3f}s, second {lout['steady_s']:.3f}s "
        f"({lout['tokens_per_s']:.1f} tokens/s); peak "
        f"{lout['peak_mem_gib']:.2f} GiB; launches {lout['launches']}")
    check(lout["launches"]["flash_attention_fwd"] == n_layers,
          f"{n_layers} flash launches in one prefill: {lout['launches']}")
    check(all(v == 0 for k, v in lout["launches"].items()
              if k not in LM_KERNELS),
          f"no other kernel on the LM path: {lout['launches']}")
    lm_checks(dev, args.seed, cell, logits, extra)
    log("[lm checks] two prefills bit-equal, finite logits within the "
        f"softcap, each flash launch within one bf16 ulp of the twin on its "
        f"inputs (max {extra['lm_layers_max_abs_err']}), kernel path within "
        f"{PATH_TOL} of the twin path "
        f"({extra['lm_kernel_vs_twin_logit_max_abs_err']}, argmax equal: "
        f"{extra['lm_kernel_vs_twin_argmax_equal']}; planted faults: no cap "
        f"{extra['lm_kernel_vs_no_cap_logit_max_abs_err']}, window + 1 "
        f"{extra['lm_kernel_vs_window_plus_1_logit_max_abs_err']}, next kv "
        f"head {extra['lm_kernel_vs_kv_shift_logit_max_abs_err']}), smoke "
        "card == CPU: ok")
    lout["profile"] = dict(tokens=LM_BATCH * LM_SEQ,
                           **profile_call(cell.step, top=10))
    log_profile("lm profile", lout["profile"])
    elapsed = time.perf_counter() - t_start
    if elapsed < LONG_PREFILL_BY_S:
        lout["long"] = long_prefill(cell, args.seed)
        log(f"[lm long] prefill of {LM_BATCH} x {LM_LONG_SEQ} tokens: "
            f"{lout['long']['seconds']:.3f}s "
            f"({lout['long']['tokens_per_s']:.1f} tokens/s), peak "
            f"{lout['long']['peak_mem_gib']:.2f} GiB")
    else:
        log(f"[lm long] skipped: the run was at {elapsed:.0f}s, past "
            f"{LONG_PREFILL_BY_S}s")
    del cell, logits
    gc.collect()
    torch.cuda.empty_cache()

    # 9a. the LM serve path: gemma2-9b at full width through ServeEngine
    # (and again on the NCCL world-1 mesh of phase 13c)
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh("cuda")
    t0 = time.perf_counter()
    lsout = lm_serve_phase(dev, args.seed, extra, mesh=mesh)
    rows["decode_attention"] = lsout["row"]
    log_lm_serve(lsout, extra)
    log(f"[lm serve] phase done in {time.perf_counter() - t0:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()

    # 9b. the other LM configs: prefill and serve at full width
    cfg_outs = {}
    for arch, layers, seq, b32, alone in LM_CONFIG_RUNS:
        t0 = time.perf_counter()
        cout = lm_config_phase(dev, args.seed, arch, layers, seq, b32, alone,
                               extra)
        log_lm_config(cout, extra)
        log(f"[{cout['tag']}] phase done in {time.perf_counter() - t0:.1f}s")
        cfg_outs[arch] = cout
    rows.update({f"flash_attention_fwd ({o['tag']})": o["prefill"]["row"]
                 for o in cfg_outs.values()})
    rows.update({f"decode_attention ({o['tag']})": o["serve"]["row"]
                 for o in cfg_outs.values()})
    rows.update({f"decode_attention ({o['tag']} decode_32k)":
                 o["decode_32k"]["row"] for o in cfg_outs.values()
                 if "decode_32k" in o})

    # 10. the flash backward kernels
    bwd_rows, bwd_extra = lm_bwd_kernel_phase(dev, args.seed)
    extra.update(bwd_extra)
    for key, r in bwd_rows.items():
        log_row(key, r)
    rows.update(bwd_rows)
    gc.collect()
    torch.cuda.empty_cache()

    # 10a. the backward's delta from the float32 out
    extra["delta"] = delta_phase(dev, args.seed)
    log(f"[delta] at {TRAIN_SEQ} tokens, gemma2's heads, bf16: the "
        "forward's bf16 out with the float32 out == without; the backward "
        "from the float32 out against the float32 twin, and from the bf16 "
        f"out (a planted fault), shares of the tolerance: {extra['delta']}")
    gc.collect()
    torch.cuda.empty_cache()

    # 10b. ragged lengths
    extra["ragged"] = ragged_phase(dev, args.seed)
    log(f"[ragged] every flash kernel at {len(RAGGED_CASES)} ragged "
        f"(Sq, Skv, q_offset, window) cases, float32 and bf16, within its "
        f"tolerance of the twin: {extra['ragged']}")
    gc.collect()
    torch.cuda.empty_cache()

    # 11. the train path
    tout, tcell = train_path(dev, args.seed)
    log(f"[train] {LM_ARCH} at full width, {TRAIN_LAYERS} layers: "
        f"{tout['params']:,} parameters, {tout['state_gib']:.2f} GiB with "
        f"{tout['moments']} AdamW moments, built in {tout['setup_s']:.2f}s")
    for i, st in enumerate(tout["steps"]):
        log(f"[train] step {i}: {st['seconds']:.3f}s, loss {st['loss']}, "
            f"grad_norm {st['grad_norm']}, lr {st['lr']}")
    log(f"[train] {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step: first "
        f"{tout['first_s']:.3f}s, steady {tout['steady_s']:.3f}s "
        f"({tout['tokens_per_s']:.1f} tokens/s); peak "
        f"{tout['peak_mem_gib']:.2f} GiB; launches {tout['launches']}")
    check(all(tout["launches_first_step"][k] == v
              for k, v in TRAIN_LAUNCHES.items())
          and all(tout["launches"][k] == TRAIN_STEPS * v
                  for k, v in TRAIN_LAUNCHES.items()),
          f"{TRAIN_LAUNCHES} launches a step: {tout['launches_first_step']} "
          f"in the first, {tout['launches']} in {TRAIN_STEPS}")
    check(all(v == 0 for k, v in tout["launches"].items()
              if k not in TRAIN_LAUNCHES),
          f"no other kernel on the train path: {tout['launches']}")
    first = tout["steps"][0]
    check(all(math.isfinite(st["loss"]) and math.isfinite(st["grad_norm"])
              for st in tout["steps"]) and 12.0 <= first["loss"] <= 20.0,
          f"finite losses and grad norms, the first loss near or above "
          f"ln(256000) = 12.45 as random weights give: {tout['steps']}")

    # 11b. one train step under the profiler
    tout["profile"] = dict(tokens=TRAIN_BATCH * TRAIN_SEQ,
                           **profile_call(tcell.step, top=16))
    log_profile("train profile", tout["profile"])

    # 12. train checks
    train_checks(dev, args.seed, tcell, extra)
    log("[train checks] each backward launch of a step within the kernel "
        f"tolerance of the twin (max {extra['train_layers_max_abs_err']}, "
        f"{extra['train_layers_share_of_tol']:.3f} of it); the step's "
        f"gradients within relative L2 {TRAIN_GRAD_TOL} of the twin "
        f"backward's (worst {extra['train_kernel_vs_twin_worst_rel_l2']}; "
        f"faults {extra['train_fault_worst_rel_l2']}); smoke step card vs "
        f"CPU {extra['train_smoke_card_vs_cpu']}; run_lm resumed == "
        f"uninterrupted (bit-equal: {extra['run_lm_resume']['bit_equal']}): "
        "ok")
    del tcell
    gc.collect()
    torch.cuda.empty_cache()

    # 12b. LM training of the other configs
    train_outs = {}
    for arch, layers, seq, batch, full in LM_TRAIN_RUNS:
        t0 = time.perf_counter()
        tco = lm_train_config_phase(dev, args.seed, arch, layers, seq, batch,
                                    full, extra)
        log_lm_train_config(tco)
        rows.update(tco["rows"])
        log(f"[{tco['tag']}] phase done in {time.perf_counter() - t0:.1f}s")
        train_outs[arch] = tco

    # 12c. the recommender substrate
    t0 = time.perf_counter()
    dout = recsys_phase(dev, args.seed, extra)
    log_recsys(dout)
    rows.update(dout["rows"])
    log(f"[recsys] phase done in {time.perf_counter() - t0:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()

    # 13. the multi-device engine (rank by rank; NCCL at world 1)
    from repro_torch.core.graph import synthetic_coo
    t0 = time.perf_counter()
    coo = synthetic_coo(REDDIT["nodes"], REDDIT["edges"], CONVERT_CAP,
                        args.seed, device=dev)
    aout = mesh_convert_phase(dev, args.seed, coo)
    dout13 = mesh_decode_phase(dev, args.seed, extra)
    rows["decode_attention_partial"] = dout13["row"]
    cout = mesh_entry_phase(dev, args.seed, mesh, coo)
    del coo
    gc.collect()
    torch.cuda.empty_cache()
    log_mesh(aout, dout13, cout, lsout["mesh_serve"],
             lsout["mesh_step_ranks"])
    log(f"[mesh] 13a-c done in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    grok = grok_train_phase(dev, args.seed, extra)
    if grok is not None:
        rows.update(grok["rows"])
        log(f"[{grok['tag']}] phase done in {time.perf_counter() - t0:.1f}s")
    mout13 = dict(convert=aout, decode=dout13, nccl=cout, grok_train=grok)
    gc.collect()
    torch.cuda.empty_cache()
    # 14. the analysis: census contracts, baselines, launch census, dry run
    t0 = time.perf_counter()
    anout = analysis_phase(dev, args.seed)
    log_analysis(anout)
    log(f"[analysis] phase done in {time.perf_counter() - t0:.1f}s")
    log(f"[extra] {json.dumps(extra)}")

    # 15. report
    new_paths = list(fouts.values()) + [kout, rout, uout, gout, dout]
    launches = {k: out["launches"][k] + mout["launches"][k]
                + sout["launches"][k]
                + sum(p["launches"][k] for p in new_paths)
                for k in SLICE_KERNELS + MERGE_KERNELS}
    check(all(v > 0 for v in launches.values()),
          f"all ten GNN kernels launched across the two paths: {launches}")
    launches.update({k: lout["launches"][k] + tout["launches"][k]
                     + sout["launches"][k]
                     + sum(o["prefill"]["launches"][k]
                           for o in cfg_outs.values())
                     + sum(o["launches"][k] for o in train_outs.values())
                     for k in LM_KERNELS + TRAIN_KERNELS})
    launches.update({k: lsout["launches"][k]
                     + sum(o["serve"]["launches"][k]
                           for o in cfg_outs.values())
                     for k in LM_SERVE_KERNELS})
    launches.update({k: dout13["launches"][k] for k in MESH_KERNELS})
    launches.update({k: sum(p["launches"][k] for p in [out, mout, sout, lout,
                                                       tout, lsout]
                            + new_paths + list(train_outs.values())
                            + [o[part] for o in cfg_outs.values()
                               for part in ("prefill", "serve")])
                     for k in OFF_PATH_KERNELS})
    kernels = []
    for key in (SLICE_KERNELS + MERGE_KERNELS + LM_KERNELS + TRAIN_KERNELS
                + LM_SERVE_KERNELS + MESH_KERNELS + OFF_PATH_KERNELS):
        r = {k: v for k, v in rows[key].items() if k != "shape"}
        r["launches"] = launches[key]
        kernels.append(r)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(dict(card=smi, rows=rows, main_path=out, merge_path=mout,
                       families=fouts, keysort=kout, reservoir=rout,
                       updates=uout, gnn_train=gout,
                       service=sout, lm_path=lout, lm_serve=lsout,
                       lm_configs=cfg_outs, train_path=tout,
                       lm_train_configs=train_outs, recsys=dout,
                       multi_device=mout13, analysis=anout,
                       extra=extra, trace_clock=TRACE_CLOCK,
                       seconds=time.perf_counter() - t_start), f, indent=1)
    torch.distributed.destroy_process_group()  # phase 13c's NCCL group
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    log(smi)
    log(json.dumps({"kernel_launches": launches}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


ANALYSIS_SEEDS, ANALYSIS_FANOUTS = 1024, (15, 10)
# PERF.md's launch columns of one Reddit convert (rows 1b, 3; 5, 7, 7b, 8)
REDDIT_CONVERT_LAUNCHES = {
    "slice": {"digit_hist": 6, "digit_scatter": 6, "rank_search": 1},
    "merge": {"chunk_sort": 2, "fused_merge": 2, "merge_rung": 22,
              "set_count_less": 2}}


def analysis_phase(dev, seed):
    """14: the census contracts on the card, the GPU baselines at Reddit
    scale, the Reddit converts' launch census and the dry run."""
    import numpy as np
    import torch
    from repro_torch.analysis import checker, contracts
    from repro_torch.analysis.census import census
    from repro_torch.configs import all_cells
    from repro_torch.core import pipeline, prng
    from repro_torch.core.costmodel import (MERGE_CFG, SLICE_CFG, Workload,
                                            convert_launch_count)
    from repro_torch.core.graph import synthetic_coo
    from repro_torch.launch import dryrun
    out = {}

    # (a) the smoke contracts on the card, both routings
    t0 = time.perf_counter()
    rep = checker.check_all(grid="smoke", device=dev)
    check(rep.ok, "14a: the census contracts hold on the card: "
          + "; ".join(map(str, rep.violations)))
    bad = [r for r in rep.runs if r["launch_delta"] != r["launches"]]
    check(not bad, f"14a: the launch counters moved as the kernel scopes "
          f"declared on every run: {bad}")
    idle = [r["label"] for r in rep.runs if r["use_pallas"] and r[
        "contract"] in ("convert", "shard", "delta_update")
        and "xla_sort" not in r["label"] and not r["launch_delta"]]
    check(not idle, f"14a: every routed convert, shard and delta case "
          f"launched kernels: {idle}")
    out["contracts"] = dict(checks=rep.checks, groups=rep.groups,
                            runs=len(rep.runs),
                            launches=sum(sum(r["launch_delta"].values())
                                         for r in rep.runs),
                            seconds=time.perf_counter() - t0)

    # (b) the baselines at Reddit scale
    coo = synthetic_coo(REDDIT["nodes"], REDDIT["edges"], CONVERT_CAP, seed,
                        device=dev)
    base = pipeline.convert_xla(coo, device=dev)
    times = {"convert_xla_ms": cuda_ms(
        lambda: pipeline.convert_xla(coo, device=dev), iters=3, warmup=2)}
    for tag, cfg in (("slice", SLICE_CFG), ("merge", MERGE_CFG)):
        csc = pipeline.convert(coo, cfg, device=dev)
        check(torch.equal(csc.ptr, base.ptr) and torch.equal(csc.idx,
                                                             base.idx),
              f"14b: convert_xla's CSC is bit-equal to {tag}'s at 2^27")
        del csc
        times[f"convert_{tag}_ms"] = cuda_ms(
            lambda cfg=cfg: pipeline.convert(coo, cfg, device=dev),
            iters=3, warmup=2)
    del base
    out["convert_xla_profile"] = profile_call(
        lambda: pipeline.convert_xla(coo, device=dev), top=8)
    seeds = torch.from_numpy(np.random.default_rng(seed + 14).choice(
        REDDIT["nodes"], ANALYSIS_SEEDS, replace=False).astype(np.int32)
    ).to(dev)
    key = prng.PRNGKey(seed + 14)
    keysort = dataclasses.replace(SLICE_CFG, selection="keysort")
    got = pipeline.preprocess_xla_baseline(coo, seeds, ANALYSIS_FANOUTS, key,
                                           device=dev)
    want = pipeline.preprocess(coo, seeds, ANALYSIS_FANOUTS, key, keysort,
                               device=dev)
    e = got.csc.idx.shape[0]
    check(torch.equal(got.csc.ptr, want.csc.ptr)
          and torch.equal(got.order, want.order)
          and torch.equal(got.csc.idx, want.csc.idx[:e])
          and int(got.n_sub_nodes) == int(want.n_sub_nodes),
          "14b: the baseline's 1,024-seed request equals preprocess under "
          "SLICE_CFG with keysort selection")
    out["request_sub_nodes"] = int(got.n_sub_nodes)
    out["request_sub_edges"] = int(got.csc.n_edges)
    del got, want
    for tag, fn in (
            ("preprocess_xla_baseline", lambda: pipeline.
             preprocess_xla_baseline(coo, seeds, ANALYSIS_FANOUTS, key,
                                     device=dev)),
            ("preprocess_slice_keysort", lambda: pipeline.preprocess(
                coo, seeds, ANALYSIS_FANOUTS, key, keysort, device=dev)),
            ("preprocess_slice", lambda: pipeline.preprocess(
                coo, seeds, ANALYSIS_FANOUTS, key, SLICE_CFG, device=dev))):
        times[f"{tag}_ms"] = cuda_ms(fn, iters=3, warmup=2)
    out["times"] = times

    # (c) the Reddit converts' launch census
    w = Workload(n=REDDIT["nodes"], e=CONVERT_CAP)
    out["convert_census"] = {}
    for tag, cfg in (("slice", SLICE_CFG), ("merge", MERGE_CFG)):
        with census(dev) as c:
            pipeline.convert(coo, cfg, device=dev)
        model = convert_launch_count(cfg, w, cfg.sort_strategy, "cuda")
        case = contracts.Case(
            "convert", f"reddit {tag}", cfg, w, cfg.sort_strategy, (),
            contracts.convert_expectation(cfg, w, cfg.sort_strategy))
        vios = checker.evaluate_census(c, case)
        check(not vios, f"14c: the {tag} Reddit convert's census: "
              + "; ".join(map(str, vios)))
        check(dict(c.launches) == c.launch_delta == model
              == REDDIT_CONVERT_LAUNCHES[tag],
              f"14c: the {tag} Reddit convert launched {c.launch_delta}, "
              f"its scopes declared {dict(c.launches)}, the model prices "
              f"{model}, PERF.md's columns say "
              f"{REDDIT_CONVERT_LAUNCHES[tag]}")
        out["convert_census"][tag] = dict(
            launches=c.launch_delta, calls=dict(c.calls),
            ops_outside=sum(c.ops.values()), sorts=c.sort_count)
    del coo
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the dry run on meta
    t0 = time.perf_counter()
    before = torch.cuda.memory_allocated()
    records = dryrun.run(all_cells(), True, ["single"],
                         out=lambda s: log(f"[dryrun] {s}"))
    status = {}
    for r in records:
        status[r["status"]] = status.get(r["status"], 0) + 1
    check(status == {"ok": 39, "skipped": 4}
          and torch.cuda.memory_allocated() == before,
          f"14d: the dry run built every cell on meta, the reference's 4 "
          f"skipped, nothing allocated on the card: {status}")
    out["dryrun"] = dict(status=status, seconds=time.perf_counter() - t0)
    return out


def log_analysis(out):
    c, t = out["contracts"], out["times"]
    log(f"[analysis] smoke contracts on the card (both routings): "
        f"{c['checks']} checks over {c['groups']} groups, {c['runs']} "
        f"censuses, {c['launches']} kernel launches, counters == scopes, "
        f"no violation; {c['seconds']:.1f}s")
    log(f"[analysis] Reddit 2^27 convert: convert_xla "
        f"{t['convert_xla_ms']:.3f} ms, SLICE_CFG {t['convert_slice_ms']:.3f}"
        f" ms, MERGE_CFG {t['convert_merge_ms']:.3f} ms (bit-equal CSCs)")
    log_profile("convert_xla profile", out["convert_xla_profile"])
    log(f"[analysis] one {ANALYSIS_SEEDS}-seed {ANALYSIS_FANOUTS} request "
        f"with its convert ({out['request_sub_nodes']} subgraph nodes, "
        f"{out['request_sub_edges']} edges): preprocess_xla_baseline "
        f"{t['preprocess_xla_baseline_ms']:.3f} ms, SLICE_CFG + keysort "
        f"{t['preprocess_slice_keysort_ms']:.3f} ms (equal subgraph), "
        f"SLICE_CFG {t['preprocess_slice_ms']:.3f} ms")
    for tag, r in out["convert_census"].items():
        log(f"[analysis] {tag} Reddit convert census: launches "
            f"{r['launches']}, wrapper calls {r['calls']}, "
            f"{r['ops_outside']} aten ops outside the scopes, {r['sorts']} "
            "native sorts: == convert_launch_count == PERF.md's columns")
    log(f"[analysis] dry run on meta: {out['dryrun']['status']} in "
        f"{out['dryrun']['seconds']:.1f}s")


def log_lm_serve(out, extra):
    sv, d32 = out["serve"], out["decode_32k"]
    log(f"[lm serve] {LM_ARCH} at full width: {out['params']:,} parameters "
        f"({out['weights_gib']:.2f} GiB), cache {out['cache_gib']:.3f} GiB "
        f"({LM_SERVE_SLOTS} slots x {LM_SERVE_MAX_LEN} positions, int8); "
        f"set up and warmed in {out['setup_s']:.2f}s")
    log(f"[lm serve] {sv['requests']} requests ({sv['prompt_tokens']} prompt"
        f" tokens, {sv['new_tokens']} new) in {sv['steps']} steps, "
        f"{sv['wall_s']:.3f}s: {sv['tok_s_processed']:.1f} tok/s processed, "
        f"{sv['tok_s_generated']:.1f} tok/s generated; admission latency p50 "
        f"{sv['admission_p50_ms']:.1f} ms p99 {sv['admission_p99_ms']:.1f} "
        f"ms; request latency p50 {sv['latency_p50_ms']:.1f} ms p99 "
        f"{sv['latency_p99_ms']:.1f} ms; {sv['step_programs']} step "
        f"program; peak {out['peak_alloc_gib']:.2f} GiB allocated, "
        f"{out['peak_reserved_gib']:.2f} GiB reserved; launches "
        f"{out['launches']} ({out['captured_launches']} a replay)")
    log(f"[lm serve] a replayed step: wall {out['step_wall_ms']:.3f} ms "
        f"(median of {LM_SERVE_TIMED}), device {out['step_device_ms']:.3f} "
        f"ms (mean of {LM_SERVE_TIMED} back to back); the counted run: "
        f"{out['stream_device_ms']:.1f} ms of steps on the device, busy "
        f"share {out['stream_busy_share']:.3f}")
    log_profile("lm serve step profile", out["step_profile"])
    log(f"[lm serve checks] {LM_SERVE_ALONE} requests alone == the stream's"
        f" tokens; batch-1 loop logits within {B1_LOGIT_TOL} "
        f"({extra['lm_b1_logit_max_abs_err']}; tokens compared "
        f"{extra['lm_b1_tokens_compared']}, within the margin "
        f"{extra['lm_b1_tokens_within_margin']}); each decode launch within "
        f"twin_tolerance (worst {extra['lm_decode_layers_share_of_tol']:.4f} "
        f"of it, max abs {extra['lm_decode_layers_max_abs_err']}); step "
        f"logits kernel vs twin {extra['lm_decode_kernel_vs_twin_logit_max_abs_err']}"
        f" (next kv head {extra['lm_decode_kernel_vs_kv_shift_logit_max_abs_err']}"
        f"); planted faults, shares of the tolerance "
        f"{extra['lm_decode_fault_share_of_tol']}: ok")
    log(f"[lm ring] {extra['lm_ring']}; kernel vs twin logits "
        f"{extra['lm_ring_kernel_vs_twin_logit_max_abs_err']}, faults "
        f"{extra['lm_ring_fault_share_of_tol']}: ok")
    log(f"[decode_32k] one step at position {DECODE_32K_LEN - 1}, batch "
        f"{DECODE_32K_BATCH}, cache {d32['cache_gib']:.2f} GiB: wall "
        f"{d32['step_wall_ms']:.3f} ms (median of {DECODE_32K_TIMED}); "
        f"kernel within {d32['kernel_share_of_tol']:.4f} of its tolerance")
    log_profile("decode_32k step profile", d32["step_profile"])
    log_row("decode_attention (decode_32k)", d32["row"])
    log("[lm serve smoke] the smoke model served card == CPU, bf16 and "
        "int8 caches: ok")


def log_row(key, r):
    log(f"[kernel] {key} ({r['shape']}): {r['ms']:.4f} ms, plain "
        f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms, bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max_abs_err "
        f"{r['max_abs_err']}"
        + (f", {r['tflops']:.1f} TFLOP/s" if "tflops" in r else "")
        + (f", {r['compares']:.4g} compares" if "compares" in r else ""))


def log_serve(tag, out):
    sv = out["serve"]
    log(f"[{tag}] {sv['requests']} requests, {sv['seeds']} predictions in "
        f"{sv['wall_s']:.3f}s: {sv['preds_per_s']:.1f} pred/s, request "
        f"latency p50 {sv['p50_ms']:.1f} ms p99 {sv['p99_ms']:.1f} ms, "
        f"{sv['steps']} steps; launches {out['serve_launches']}"
        + (f"; peak {out['peak_mem_gib']:.2f} GiB" if "peak_mem_gib" in out
           else "")
        + (f" allocated, {out['serve_peak_reserved_gib']:.2f} GiB reserved "
           "over the run" if "serve_peak_reserved_gib" in out else ""))


def log_profile(tag, prof):
    what = (f"one replayed step of {prof['slots']} slots, {prof['seeds']} "
            "seeds" if "slots" in prof
            else f"one request of {prof['seeds']} seeds" if "seeds" in prof
            else f"one train step of {prof['samples']} samples"
            if "samples" in prof
            else "one convert" if "convert" in tag
            else f"one decode step of {prof['tokens']} rows" if "decode" in tag
            or "serve" in tag
            else f"one {'train step' if 'train' in tag else 'prefill'} of "
                 f"{prof['tokens']} tokens")
    log(f"[{tag}] {what}: wall "
        f"{prof['wall_ms']:.2f} ms, device {prof['device_ms']:.2f} ms "
        f"(busy share {prof['device_busy_share']:.3f}); top by device time:")
    for r in prof["top"]:
        log(f"[{tag}]   {r['device_ms']:10.3f} ms  x{r['count']:<5d} "
            f"{r['name']}")
    for name, r in prof.get("kernels", {}).items():
        log(f"[{tag}] kernel {name}: {r['device_ms']:.4f} ms in "
            f"{r['count']} launches")


if __name__ == "__main__":
    sys.exit(main())
