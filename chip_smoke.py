#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

The main paths are the paper's from-scratch k-core decomposition
(``repro_torch.launch.kcore_run``, whose superstep runs the ``kcore_hindex``
and ``segment_sum`` kernels, in its jacobi and block_gs modes), the
streaming engine (``repro_torch.streaming``: churn batches re-converged on
``segment_sum``), the temporal path (``repro_torch.temporal``: a window
sliding over a timestamped edge stream, each advance one streaming batch,
checkpointed through ``repro_torch.checkpoint``), k-core serving (``repro_torch.streaming``'s
``KCoreServer`` behind ``ConcurrentKCoreServer`` and ``obs.http``, and ``launch.kcore_serve``:
reads of a published snapshot while the engine re-converges on the kernels), the
out-of-core decomposition (``repro_torch.core.outofcore``: arc blocks cycled from a
disk store through the card, each block's superstep on ``segment_sum``), the sharded and
multi-process paths (``kcore_decompose_sharded`` and the streaming engine on a mesh of
shards, and across gloo processes, each round's h-index and receivers on ``segment_sum``
over the stacked local shards), LM serving
(``launch.serve``, prefill attention
on the flash-attention kernel, MoE and windowed models among them: the MoE
dispatch's backward on the float form of the segment-sum kernel), LM training (``launch.train``'s pieces through
``runtime.TrainDriver``: the embedding gather's backward on the float form of
the segment-sum kernel, the trained weights served on the flash kernel), DIN (``launch.din_serve``, the context bag
on the embedding-bag kernel) and the GNN family, forward and training
(``models/gnn``: GraphCast's weather rollout and training loop through
``launch.graphcast_weather``, GraphCast's generic mode, SchNet, EGNN and MACE
and their train steps, every message aggregation on the float form of the
segment-sum kernel, whose backward is a gather); each
kernel is hand-written CUDA under ``src/repro_torch/kernels``. Phases, each
of which must pass:

1. Card: the card's name and power limit, as ``nvidia-smi`` gives them.
2. Build: the four kernels, for sm_90a, from the sources in this checkout, with
   the compiler's register, shared-memory and spill report and its warnings
   (a serialised wgmma among them).
3. Kernel against plain: each kernel bit-equal to its plain PyTorch version
   on edge cases (for ``kcore_hindex`` every variant's border width, probe
   counts that stop a pass part way, and rows that take several passes) and
   at the main path's real shapes (every ELL bucket of the soc-pokec
   analogue, each timed, and the segment sum over its 59.7M arcs), with
   times from CUDA events and device times from ``torch.profiler`` beside
   the bytes bound and a library call. The segment sum's edge cases include
   one 98,432-arc row among 10^6 empty rows, a ``vals`` view 4 bytes off a
   16-byte boundary, E not a multiple of 4, E = 0 and rows of one arc; two
   more timed cases split its SPR time by degree: the widest row alone, and
   the arcs without the rows wider than 2,048.
4. The BZ-checked Table-I suite (EEN, G31, FC, PTBR, MGF at scale 0.05): host
   loop and fused on the card, cores equal to BZ, bills equal between the two,
   and ``benchmarks/static_baseline.json``'s message ratios reproduced.
5. The masked route (segment-sum binary search, no ELL) with the same bills.
6. Full size: ``snap_analogue("SPR", 1.0)`` through the CLI's entry point,
   fused and then host loop, equal to each other and to BZ, with the kernels'
   launch counters read around these runs only.
7. The other static modes on the Table-I set at 0.05: ``--backend ell`` and
   ``ell_pallas`` (cores equal BZ, rounds and per-round bills equal the
   segment backend's of phase 4, ``kcore_hindex`` launched) and
   ``--mode block_gs`` at ``configs/kcore_paper.CONFIG_BEYOND``'s 16 blocks
   (cores equal BZ, ``segment_sum`` launched), printed against the Jacobi
   rounds and messages as ``benchmarks/beyond_block_gs.py`` prints them.
8. Full size, block_gs: SPR at scale 1.0 through ``kcore_run --mode
   block_gs`` (8 blocks), cores equal BZ, wall, ms a round, rounds and
   messages against the Jacobi run of phase 6; then ``segment_sum`` held
   bit-exact against its plain version on every block's staged slices
   (local row pointer, the widest row's block among them).
9. The streaming gate: ``benchmarks/streaming_baseline.json``'s nine mean
   message ratios reproduced exactly at its settings (the loop of
   ``benchmarks/streaming_maintenance.py`` on the port's dense engine, every
   batch BZ-checked), with the benchmark's sharded twin beside it on a
   4-shard mesh: its cores and per-round bills equal the dense engine's every
   batch.
10. Full size, streaming: one engine built on SPR at scale 1.0 with a fused
   initial decomposition, cloned through ``state_dict`` into ``dense``,
   ``compact``, ``fused`` and ``auto`` engines; a churn batch of 0.002 of
   the edges (``STREAM_CHURN``) applied to each: equal cores and
   per-round bills across the four, cores equal BZ after each batch,
   ``segment_sum`` launched in every mode; per mode and batch the phase
   walls and the staging share, rounds, messages and the ratio against a
   fused from-scratch run, the seed, the flag reads, launches and peak
   device memory; after each batch ``segment_sum`` held bit-exact against
   its plain version on a compact frontier subproblem.
11. The temporal gate: ``benchmarks/temporal_baseline.json``'s four mean
   message ratios (EEN, FC, ba, contact) reproduced exactly at its settings
   (the loop of ``benchmarks/temporal_replay.py::run_records`` on the port's
   ``replay``, fused frontier, every boundary BZ-checked, each window graph's
   scratch bill from ``kcore_decompose`` on the card), with each trace's
   mean ms a round, ``patch_ms`` and ``converge_ms``.
12. Full size, temporal: SPR's temporal log (``temporal_snap_analogue("SPR",
   1.0, remove_frac=0.15)``, made from phase 6's graph), a count window of
   750,000 events sliding 75,000 at a time in ``fused`` mode: filled in
   one advance of 10 strides, each boundary checked by ``check_step`` (edge
   set, engine graph, cores against BZ); per step the batch, rounds and
   messages against a fused from-scratch run, the phase walls, the
   ``window.diff`` wall and the step wall, CSR health, launches and peak
   device memory. ``segment_sum`` is held bit-exact against its plain
   version on the fill's staged live arcs (2,097,152 rows, most empty).
   After the fill the window is checkpointed and restored into a fresh
   engine, and both take one sliding advance: equal cores, bills and every
   ``BatchResult`` accounting field.
13. Flash attention against its plain version: the serve shape (bf16,
   B*H 128, S 2048, d 64, causal), a ragged S, GQA and MQA, a window, d 128,
   float32, Sq != Sk, rows masked everywhere, head slices of one fused
   projection read in place, and ``yi-34b``'s heads (56 over 8, d 128, S
   2048), within 2e-2 (bf16) and 2e-5 (float32); at the serve shape and at
   ``yi-34b``'s heads its time beside the plain version's,
   ``scaled_dot_product_attention``'s and the FLOP bound.
14. LM serving: ``qwen1.5-0.5b`` at full width (24 layers, d_model 1024,
   vocab 151,936; weights drawn from seed 0) through
   ``repro_torch.launch.serve.generate``: batch 8, prompt 2048, 32 tokens,
   with the flash kernel's launch counter read around that run only (24, one
   a layer of the prefill), and the same run once more under
   ``torch.profiler`` (``serve.profile_serve``: device busy and idle time,
   the costliest kernels). Then batch 1, prompt 128 on the card and on the
   CPU from the same weights, and in float32 on the CPU: the prefill logits
   and 4 teacher-forced decode steps of the card within ``tol`` of the CPU's
   and of the float32 evaluation, where ``tol`` is twice the CPU bf16
   route's own distance from the float32 evaluation (the bf16 model's
   rounding noise: two routes each that close to it are within twice that
   of each other), and at least two bf16 units in the last place of the
   largest logit.

15. The embedding-bag kernel against its plain version: the reference's sweep
   (indices in [-1, V)), bags that are all padding, L = 1, B = 0, L = 0, a
   bf16 table, DIN's context bag at ``serve_p99`` and ``serve_bulk`` (table
   10,000 x 18, indices (B, 16)), and the 1,000,000 x 18 item table under
   Zipf indices (65,536, 100) with -1 padding, every row-read width the
   kernel picks (D = 17, 18, 32; table views one element and one row into
   their buffers), L = 1, 15, 17 and 100, bf16 at D = 18 and B not a
   multiple of the bags a block takes; within rtol = atol = 1e-5 in
   float32 (``tests/test_kernels.py:202``) and one bf16 unit in the last
   place of the output in bf16. At the two DIN shapes its time a call and
   on the device beside the plain version's, ``F.embedding_bag``'s and the
   bytes bound.
16. DIN at full width (``configs/din.py``: 10^6 x 18 item table, history of
   100, MLPs 80-40 and 200-80; weights drawn from seed 0 on the card)
   through ``repro_torch.launch.din_serve``'s functions: 3 train steps at
   ``train_batch`` (65,536), serving at ``serve_p99`` (512) and
   ``serve_bulk`` (262,144), retrieval at ``retrieval_cand`` (10^6
   candidates, padded to 1,000,448, top 100), with the bag kernel's launch
   counter read around each part (one launch a serve step and a train
   forward, none in retrieval) and the peak device memory, and the same
   calls once more under ``torch.profiler`` (``obs.profile``). Then the card
   against the CPU from the same weights and batches, and both against a
   float64 evaluation on the CPU: serve logits at batch 512, one train step
   at batch 4,096 (loss, grad norm, updated parameters) and retrieval
   scores at 65,536 candidates, each within ``tol`` = max(2 x the CPU float32
   route's distance from float64, 4 float32 units in the last place of the
   largest magnitude compared); the top 100 are compared allowing for ties
   (``checks.check_topk``).

17. The serving gate: ``benchmarks/serving_baseline.json``'s ``mixed`` ratio
   (1.2018) reproduced exactly at its settings (``benchmarks/serving_mixed.py``'s
   ``run_records`` and ``summarize`` on the port: one writer advancing a
   window over the EEN trace in ``fused`` mode through the concurrent front
   end while 4 readers hammer the snapshot with the benchmark's read mix),
   every read bit-equal to its version's registered fixpoint (checked after
   the readers join), checked boundaries BZ-exact, and the benchmark's
   acceptance check: read p99 below max(mean update wall, 0.05 s).
18. Full size, served: SPR (phase 6's graph and BZ cores) behind
   ``KCoreServer(..., StreamingConfig(frontier="fused"))``,
   ``ConcurrentKCoreServer`` (4 read workers) and the HTTP endpoint; a tick
   of churn 0.002 (``kcore_serve._tick_rng``), applied by a writer
   thread while 4 readers hammer the snapshot (no ``core_asof``: a static
   server has no boundaries) and the main thread polls ``/query/core``,
   ``/query/stats``, ``/metrics`` and ``/healthz``; after the tick the
   snapshot equals BZ, every read and HTTP read equals its version's
   snapshot, and reads completed during re-convergence. Then a drain to a
   checkpoint, a restore into a fresh server, and tick 1 on both: equal in
   cores and every ``BatchResult`` accounting field; ``segment_sum``
   bit-exact on the served live arcs. Prints the init wall, each tick's
   phase walls, rounds and messages against a fused scratch run, the flip
   walls, read p50/p99 under load and idle, the longest stale window, HTTP
   p50, the checkpoint's bytes and walls, peak device memory and launches.
19. ``python -m repro_torch.launch.kcore_serve --graph EEN --scale 0.05
   --batches 2 --queries 10000 --frontier fused --concurrent 2 --listen 0
   --verify --trace build/traces/kcore_serve.json`` in a subprocess on the
   card: exit 0, every tick verified (the trace is phase 26's).
20. Full size, out of core (``repro_torch.core.outofcore``): the scale
   benchmark's headline configuration (``benchmarks/scale_decomposition.py``:
   the LJ1 analogue at a 10^6-vertex target under a 64 MiB block-cache
   budget) and SPR (phase 6's graph) under 256 MiB, each through
   ``outofcore_decompose`` on the card. LJ1 runs to convergence: its cores
   equal BZ and its cores, rounds and per-round bills the in-memory fused
   run's. SPR stops after ``OOC_ROUNDS`` (5) of its 50 rounds: its
   estimates and per-round bills equal an in-memory fused run stopped
   there, its bills the first rounds of phase 6's converged run; at least one
   eviction, ``device_block_bytes`` below the arc arrays'
   bytes and the card's measured peak (``max_memory_allocated`` less the
   allocation at entry) below them too, ``segment_sum`` launched; per graph
   the geometry, the I/O bill, rounds, messages and walls, a split of round 1
   into host materialisation, host-to-device copies and the superstep, and
   ``segment_sum`` bit-exact on the widest block's shipped slice. Then
   ``python -m repro_torch.launch.kcore_run --graph FC --scale 0.05
   --out-of-core --mem-budget 4194304 --json`` in a subprocess on the card:
   exit 0, ``correct_vs_BZ`` and an ``out_of_core`` block.
21. The sharded and multi-process paths: SPR at scale 1.0 (phase 6's graph)
   on a 4-shard mesh through ``kcore_run``'s entry point with ``--mesh 4``,
   host loop then ``--fused``: cores equal BZ, rounds and every per-round
   bill equal phase 6's fused run, ``segment_sum`` launched; the shards'
   balance, the walls, ms a round, the peak and the launches printed; then
   ``segment_sum`` bit-exact on the widest shard's staged slice. Phase 10's
   first SPR batch (churn 0.002) replayed from its state in ``sharded`` and
   ``fused_sharded`` on the mesh: every ``BatchResult`` accounting field
   equals phase 10's dense batch. Two gloo processes on the card (CUDA
   tensors, 2 shards each, a 4-shard global mesh) run EEN at 0.05 fused:
   cores and bills equal the single-process run, the host loop refuses the
   mesh, each rank on ``cuda`` with ``segment_sum`` launched, under a
   240 s limit. Then ``kcore_run --graph FC --scale 0.05 --mesh 2 --fused
   --json --trace build/traces/kcore_run.json`` (the trace is phase 26's)
   and ``kcore_serve --graph EEN --scale 0.05 --mesh 2 --frontier sharded
   --batches 2 --queries 10000 --verify`` in subprocesses.
22. GNN forward. (a) The float segment-sum kernel against its plain
   version on the CPU tests' cases (float32 and bf16, F 1 to 1,152, empty
   rows, E = 0, rows of one arc, masked pad arcs, a non-contiguous view, a
   base 4 bytes off 16, (E,) values, and rows of 0, 1, S - 1, S, S + 1, 2S,
   2S + 1 and 5S + 3 arcs about the stretch S = ``ops.STRETCH``, where the
   summation order changes) and at the main path's shapes, each timed: the weather processor's scatter (327,660 arcs, F 512, float32,
   40,962 rows), MACE's a2 scatter of one SPR chunk (1,865,728 arcs, F
   1,152, bf16, 2,097,152 rows) and the widest SPR row alone at that width;
   within twice the float32 summation bound of the plain version on the
   card, bit-equal to it on the CPU (but the SPR chunk), the same bits run
   to run. (b) GraphCast weather at full ``CONFIG`` through
   ``launch.graphcast_weather``'s functions: a 3-step rollout (18 kernel
   launches a step), ms a step, the peak, the TF32 setting and one step
   under ``torch.profiler``; one step held against the plain scatter on the
   card and a float64 evaluation (``checks.hold``). (c) SchNet, EGNN, MACE
   and GraphCast at full width on ``full_graph_sm`` (node logits) and
   ``molecule`` (energies; GraphCast's embeddings), the card against the CPU
   from the same weights: float32 by ``checks.hold``, bf16 by
   ``checks.hold_bf16`` against a float64 evaluation. (d) GraphCast-generic
   node logits at full width over ``minibatch_lg``'s geometry sampled from
   SPR (1,024 seeds, fanout (15, 10)). (e) MACE at full width over SPR with
   ``ogb_products``' 100 features, arcs padded to 59,703,296: 32 chunks, 192
   launches; the first chunk's three scatters held against the plain
   version, the kernel route against the plain-scatter route and a float32
   evaluation (float64 would not fit) by the bf16 rule.
23. GNN training. (a) The float segment sum's backward (``grad_out[ids]``,
   no kernel) against autograd through the plain version on the card, bit
   for bit, float32 and bf16, at the weather processor's shape (327,660 x
   512, the gather timed), ragged rows with empty ones, (E,) values and E =
   0; the forward is one launch. (b) GraphCast weather at full ``CONFIG``:
   5 AdamW steps of the example's next-state loss through
   ``launch.graphcast_weather.train``, processor blocks checkpointed: ms a
   step, the peak (below 40 GB), 34 float kernel launches a step (18 in the
   forward, 16 in the recomputed blocks), the losses; then, the AdamW
   moments freed, one step's loss, grad norm and six named gradient leaves
   held by ``checks.hold`` against the plain scatter on the card and a
   float64 evaluation on the card (with fewer processor blocks if twice
   the training peak passes 70 GB). (c) A train step of SchNet, EGNN, MACE
   and GraphCast at full width on ``full_graph_sm`` and ``molecule`` (GraphCast
   at 4 of its 16 layers, which take 20-31 s a step on the CPU), the
   card against the CPU from the same weights: loss, grad norm and the
   updated parameters, float32 by ``checks.hold``, bf16 by
   ``checks.hold_bf16`` against a float64 evaluation. (d) The seed-prefix
   loss: a GraphCast-generic train step over phase 22's ``minibatch_lg``
   batch, two launches a layer, held against the plain scatter and float64
   on the card by the bf16 rule.
24. LM training at ``qwen1.5-0.5b``'s full width (24 layers, d_model 1,024,
   vocab 151,936; float32 weights drawn from seed 0). (a) One train step at
   batch 1 x 128 on the card, in float32 on the card and on the CPU's bf16
   route (in a thread of 6, beside (b) and (c)), from the same weights: the
   loss, the grad norm and the updated parameters held by
   ``checks.hold_bf16``, six named gradient leaves by the LM rule
   (``checks.hold_bf16_noise``); ``steps.make_train_step`` gives the bits of
   its parts. (b) The embedding gather's backward on the float kernel at the
   step's shape (32,768 token rows of 1,024 into 151,936 table rows) and its
   hottest row alone, timed as phase 22 times its shapes; then
   ``TrainDriver`` at batch 8 x 4,096 (``train_4k``'s sequence): 2 steps, a
   checkpoint after each, a failure injected after the first, a relaunch
   that restores it and finishes, and the first run's in-memory state
   stepped on with no save or restore: parameters, AdamW moments and count
   and the step's loss bit-equal; ms a step, the peak, the losses, the
   checkpoint's bytes and save and restore walls, one float kernel launch a
   step. (c) The trained
   weights through ``launch.serve``'s prefill on the flash kernel (24
   launches) at 2 x 1,024: the last position's logits against
   ``forward_hidden``'s and a float32 evaluation by the bf16 rule.
25. MoE and sliding-window attention (budget 75 s). (a) ``qwen2-moe-a2.7b``
   at full width and depth (24 layers, 60 experts padded to 64, top 4, 4
   shared; 15.15B weights drawn on the card in bf16) through
   ``launch.serve``: batch 8, prompt 2,048, 32 tokens; prefill ms, decode
   ms a token, tok/s, the peak, 24 flash launches, the selections capacity
   dropped, and the same run under ``torch.profiler``. (b) The same widths
   at 2 layers, batch 1 x 128, prefill and 4 decode steps on the card, on
   the CPU's bf16 route and in float32 on the card, the latter two on the
   card's experts (``generate(forced_routes=)``): the router's log-
   probabilities by the LM rule and the top-K experts call by call (a token
   whose experts differ must be a near-tie: the card's logit margin there
   within that rule's tolerance; ``route_check``), the logits by the LM
   rule; at 1 layer a train step's loss, aux and gradient norm by
   ``checks.hold_bf16`` (no AdamW update: at count 0 it moves no weight by
   a bf16 ulp), the CPU's in a thread beside (c) and (d). (c)
   ``mixtral-8x22b`` at full width, 2 of 56 layers: a prompt of 9,000 (P %
   4,096 = 808) into a 4,096-slot rolling cache, every slot held bit for
   bit against the k and v prefill computed for its position, 16 decode
   steps past the roll, layer 0's decode attention against the plain
   windowed attention over all positions' k and v; the windowed flash
   kernel at this shape held against ``attention_ref`` (one key-value
   head's group of query heads at a time) and its float32 evaluation by the
   bf16 rule in blocks of 1,000 query rows, timed beside SDPA with the same
   boolean mask and its kernels' names. (d) One Mixtral train step at full
   width, 1 layer, 1 x 9,216 (loss and gradient, no optimizer; 2 float
   kernel launches), its sliced training attention against the unsliced
   masked one and float32, and the float kernel timed at the step's
   dispatch backward.
26. The paper's example launchers, the trace gates and the dry-run's cells
   (budget 30 s). (a) ``launch.paper_experiments.report`` on phase 6's SPR
   graph with its BZ cores given: cores equal BZ, ``total_messages`` and
   every per-round bill equal phase 6's fused run, the k-core kernels'
   launches read around it. (b) ``launch.quickstart`` and
   ``launch.paper_experiments --graph FC --scale 0.05`` through their
   ``main``, stdout captured: the card named first, every section of the
   examples present. (c) ``obs.validate`` on the traces phases 19 and 21
   exported (``--trace``), the reference CI's gates: ``kcore.decompose``
   required of ``kcore_run``, ``batch`` at coverage 0.95 of ``kcore_serve``.
   (d) ``launch.dryrun``'s ``--run`` on ``din serve_bulk`` (the bag),
   ``graphcast full_graph_sm`` (the float segment sum, a train step) and
   ``qwen1.5-0.5b prefill_32k`` cut to batch 1 (flash at S 32,768, d 64):
   the FLOPs and bytes counted on the card equal the ``meta`` count, each
   kernel's booked calls equal its launch counter, and the roofline share
   is at most 100 %; wall, peak, dominant term and share printed; the flash
   kernel at that shape held against ``attention_ref`` and its float32
   evaluation on its first and last 512 query rows, in blocks of 64 rows,
   each by the bf16 rule at its own largest magnitude.
27. GNN message passing on a flat mesh (budget 45 s). (a) The float
   kernel's unrounded form (``segment_sum_float_partial``, a shard's
   partial) on one shard's slice of a GraphCast block's messages, bf16 and
   float32 in, float32 out: within the float32 summation bound of its plain
   version and of float64, and rounded once bit for bit the float form's
   output. (b) GraphCast at full ``CONFIG`` (d 512, 16 layers) on
   full_graph_sm's sizes (2,708 nodes, 10,556 arcs, 1,433 features) on
   one-process meshes of 2 and 4 shards, and SchNet, EGNN and MACE at full
   ``CONFIG`` on 128 molecules of 30 atoms on 4 shards: one train step each
   after a warm-up, its loss, grad norm and gradients held against the
   one-device step on the card (and a float64 step) by phase 23's rule; the
   float kernel's launches a step and a shard, the sharded and unsharded
   branch counts, the step walls beside the one-device walls and the
   collectives' bytes printed. (c) Two gloo ranks of 2 shards each on the
   card: GraphCast's scatter and gather probes, forward and backward, bit
   for bit the 4-shard one-process run's, and its train step held to the
   one-device step by the same rule.
28. The ``kernels`` JSON line, after each phase's wall: each kernel's
   launches in the main path's runs, its largest error against its plain
   version, its time a call and on the device (flash attention's under
   ``timed``), the plain version's, the library call's and the bound, each
   bound from the kernel's cost function (``ops.cost``,
   ``launch/roofline.py``'s peaks); the float form of the segment sum as
   its own entry, ``segment_sum_float`` (the weather shape's numbers; every
   timed shape under ``timed``; its launches include the training runs',
   GNN and LM, the Mixtral train step's dispatch backward, phase 26's cell
   and phase 27's mesh steps, a launch a local shard for each scatter).

It then prints the card line, the ``kernels`` JSON line and, last, the ``ok``
line. It exits non-zero, without the ``ok`` line, if any check fails, if no
CUDA device is present, or if ``src/repro_torch`` is not beside it. It imports neither
``jax`` nor the reference package.
"""

from __future__ import annotations

import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TABLE_I = ("EEN", "G31", "FC", "PTBR", "MGF")
TABLE_I_SCALE = 0.05
SPR_SCALE = 1.0
KERNEL_FILES = {
    "kcore_hindex": ("src/repro_torch/kernels/kcore_hindex/csrc/kcore_hindex.cu",
                     "src/repro/kernels/kcore_hindex/kernel.py:46"),
    "segment_sum": ("src/repro_torch/kernels/segment_sum/csrc/segment_sum.cu",
                    "src/repro/kernels/segment_sum/kernel.py:45"),
    "flash_attention": ("src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:85"),
    "embedding_bag": ("src/repro_torch/kernels/embedding_bag/csrc/embedding_bag.cu",
                      "src/repro/kernels/embedding_bag/kernel.py:38"),
    # the float form of the segment sum: the same source and TPU kernel, its own entry points
    "segment_sum_float": ("src/repro_torch/kernels/segment_sum/csrc/segment_sum.cu",
                          "src/repro/kernels/segment_sum/kernel.py:45"),
}
# tests/test_kernels.py:160's tolerances: a bf16 output ulp is 1.6e-2 in [2, 4) and the
# kernel rounds p to bf16 before PV, as the TPU kernel does; float32 rounds nothing narrower
FLASH_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
SERVE = {"arch": "qwen1.5-0.5b", "batch": 8, "prompt": 2048, "gen": 32, "seed": 0}
BAG_TOL = 1e-5   # rtol = atol for float32, tests/test_kernels.py:202-203
# DIN's RECSYS_SHAPES, and the smaller batches at which the card is held against the CPU
DIN = {"train_batch": 65536, "train_steps": 3, "serve": (512, 262_144), "n_candidates": 1_000_000,
       "top_k": 100, "seed": 0, "check_serve": 512, "check_train": 4096,
       "check_retrieval": 65536}

failures: list[str] = []


def check(cond: bool, what: str) -> bool:
    print(f"  [{'ok' if cond else 'FAIL'}] {what}", flush=True)
    if not cond:
        failures.append(what)
    return cond


phase_walls: list = []       # [title, start, wall], the wall set when the next phase starts


def phase(title: str) -> None:
    """Start a phase: print its title and record the wall of the one that ends."""
    now = time.perf_counter()
    if phase_walls:
        phase_walls[-1][2] = now - phase_walls[-1][1]
    phase_walls.append([title, now, None])
    print(f"\n== {title}", flush=True)


def time_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` calls, from CUDA
    events around the whole run (host clock on the CPU)."""
    for _ in range(warmup):
        fn()
    if not torch.cuda.is_available():
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps: int, kernel: str):
    """Mean device milliseconds per call of ``fn`` spent in the kernels whose
    name holds ``kernel`` (``torch.profiler``'s CUDA activity, after a warm-up
    call), or None off the card. Unlike ``time_ms`` it leaves out the host's
    time to enqueue a launch, which sets the pace of a kernel faster than
    that. The trace may miss the first launches of a window (it held 4 of 5
    or 7 of 10 on the H100), so the calls are counted as the launches of the
    most launched of those kernels that it holds; a short trace is reported,
    and an empty one taken again, up to three times."""
    if not torch.cuda.is_available():
        return None
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        found = [e for e in prof.key_averages() if kernel in e.key and e.device_time_total > 0]
        calls = max((e.count for e in found), default=0)
        if calls != reps:
            print(f"  (the trace holds {calls} of {reps} calls' launches of {kernel!r})")
        if calls:
            return sum(e.device_time_total for e in found) / calls / 1e3
    return None


def bound_ms(nbytes: float, flops: float = 0.0) -> float:
    """The least milliseconds the card needs to move ``nbytes`` and do
    ``flops`` bf16 products (``launch/roofline.py``'s H100 peaks)."""
    from repro_torch.launch import roofline

    return roofline.bound_ms(nbytes, flops)


def max_err(torch, a, b) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0


def flash_cases(torch, np, dev, st, small: bool = False) -> None:
    """Phase 13: the flash kernel against its plain version (``attention_ref``).
    ``small`` (the CPU rehearsal) cuts every length and window by 8."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa

    rng = np.random.default_rng(1)

    def qkv(B, Sq, Sk, Hq, Hkv, d, dtype):
        return [torch.as_tensor(rng.standard_normal(shape, dtype=np.float32), device=dev).to(dtype)
                for shape in [(B, Sq, Hq, d), (B, Sk, Hkv, d), (B, Sk, Hkv, d)]]

    def plain(q, k, v, causal, window):
        B, Sq, Hq, d = q.shape
        _, Sk, Hkv, _ = k.shape
        out = fa.attention_ref(q.transpose(1, 2).reshape(B * Hq, Sq, d),
                               k.transpose(1, 2).reshape(B * Hkv, Sk, d),
                               v.transpose(1, 2).reshape(B * Hkv, Sk, d),
                               causal=causal, window=window)
        return out.reshape(B, Hq, Sq, d).transpose(1, 2)

    cases = [  # B, Sq, Sk, Hq, Hkv, d, causal, window, dtype, label
        (8, 2048, 2048, 16, 16, 64, True, None, torch.bfloat16, "serve shape"),
        (2, 1000, 1000, 16, 16, 64, True, None, torch.bfloat16, "ragged S"),
        (2, 512, 512, 16, 8, 64, True, None, torch.bfloat16, "GQA rep 2"),
        (2, 512, 512, 16, 1, 64, True, None, torch.bfloat16, "MQA"),
        (2, 2048, 2048, 8, 8, 64, True, 256, torch.bfloat16, "window 256"),
        (2, 1024, 1024, 8, 2, 128, True, None, torch.bfloat16, "d 128, GQA rep 4"),
        (1, 777, 777, 8, 8, 128, False, 100, torch.bfloat16, "d 128, window, not causal"),
        (2, 512, 512, 8, 8, 64, True, None, torch.float32, "float32"),
        (1, 300, 300, 4, 2, 128, True, 64, torch.float32, "float32 d 128, window"),
        (2, 512, 1024, 16, 16, 64, False, None, torch.bfloat16, "Sq < Sk"),
        (2, 1024, 384, 16, 16, 64, True, None, torch.bfloat16, "Sq > Sk"),
        (1, 600, 200, 16, 4, 64, True, 64, torch.bfloat16, "rows masked everywhere"),
        (1, 300, 100, 4, 4, 64, True, 32, torch.float32, "float32, rows masked everywhere"),
        (2, 333, 333, 8, 2, 64, True, None, torch.bfloat16, "views of one fused projection"),
        (2, 2048, 2048, 56, 8, 128, True, None, torch.bfloat16, "yi-34b heads, d 128"),
    ]
    for B, Sq, Sk, Hq, Hkv, d, causal, window, dtype, label in cases:
        if small:
            Sq, Sk, window = Sq // 8, Sk // 8, window and window // 8
        if label == "views of one fused projection":   # read in place through the strides
            x = torch.as_tensor(rng.standard_normal((B, Sq, Hq + 2 * Hkv, d), dtype=np.float32),
                                device=dev).to(dtype)
            q, k, v = x[:, :, :Hq], x[:, :, Hq:Hq + Hkv], x[:, :, Hq + Hkv:]
            check(all(fa._kernel_layout(t) is t for t in (q, k, v)),
                  "the fused projection's head slices go to the kernel without a copy")
        else:
            q, k, v = qkv(B, Sq, Sk, Hq, Hkv, d, dtype)
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        want = plain(q, k, v, causal, window)
        err = float((got.float() - want.float()).abs().max())
        key = "err" if dtype == torch.bfloat16 else "err_f32"
        st[key] = max(st[key], err)
        tol = FLASH_TOL[str(dtype).split(".")[1]]
        msg = (f"flash_attention {label}: B={B} Sq={Sq} Sk={Sk} Hq={Hq} Hkv={Hkv} d={d} "
               f"causal={causal} window={window} {str(dtype).split('.')[1]}: max|err| {err:.3g} "
               f"< {tol}")
        ok = err < tol and bool(torch.isfinite(got).all())
        if "masked everywhere" in label:
            first = Sk + window - 1
            mean_v = v.float().mean(dim=1).repeat_interleave(Hq // Hkv, dim=1)   # (B, Hq, d)
            row_err = float((got[:, first:].float() - mean_v[:, None]).abs().max())
            msg += f"; rows >= {first} are the mean of v (max|err| {row_err:.3g})"
            ok = ok and row_err < tol
        if label in ("serve shape", "yi-34b heads, d 128"):
            flop, nbytes = fa.cost(B, Sq, Sk, Hq, Hkv, d, q.element_size(), causal, window)
            bnd = bound_ms(nbytes, flop)
            ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, causal=True), 20)
            dev_ms = device_ms(torch, lambda: fa.flash_attention(q, k, v, causal=True), 5,
                               "flash_")
            plain_ms = time_ms(torch, lambda: plain(q, k, v, True, None), 3, warmup=1)
            # the yardstick reads k and v repeated to Hq heads beforehand (its GQA path is not
            # what is compared)
            qt, kt, vt = (t.transpose(1, 2) for t in
                          (q, k.repeat_interleave(Hq // Hkv, dim=2),
                           v.repeat_interleave(Hq // Hkv, dim=2)))
            lib = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
                          20)
            lib_dev = device_ms(
                torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), 5, "")
            lib_err = float((F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
                             .transpose(1, 2).float() - want.float()).abs().max())
            st.setdefault("timed", {})[label] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                                                     library_ms=lib, library_device_ms=lib_dev,
                                                     bound_ms=bnd, tflops=flop / ms / 1e9)
            if label == "serve shape":
                st.update(ms=ms, plain_ms=plain_ms, library_ms=lib, bound_ms=bnd)
            msg += (f"; {ms:.4f} ms ({flop / ms / 1e9:.1f} TFLOP/s; {dev_ms or 0.0:.4f} ms on the "
                    f"device), plain {plain_ms:.3f} ms, scaled_dot_product_attention {lib:.4f} ms "
                    f"({flop / lib / 1e9:.1f} TFLOP/s; {lib_dev or 0.0:.4f} ms on the device; its "
                    f"max|err| {lib_err:.3g}), bound {bnd:.4f} ms ({flop:.4g} FLOP, {nbytes} "
                    f"bytes), {bnd / ms:.1%} of it")
            del qt, kt, vt
        check(ok, msg)
        del q, k, v, got, want


def serve_full_width(torch, dev, small: bool = False) -> int:
    """Phase 14: serve the full-width model on the card through the serve loop,
    then hold the card's route against the CPU's plain route at batch 1.
    Returns the flash kernel's launches in the measured serve run. ``small``
    (the CPU rehearsal) serves the SMOKE config at a short prompt instead."""
    from repro_torch import checks
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch import serve
    from repro_torch.models.transformer.model import cast_params, init_params, params_to
    from repro_torch.obs.profile import format_profile

    cfg = (get_smoke if small else get_config)(SERVE["arch"])
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    f32_params = init_params(cfg, SERVE["seed"], device=cpu)
    cpu_params = cast_params(f32_params)
    params = params_to(cpu_params, dev)
    n_params = sum(t.numel() for t in params["layers"]["attn"].values()) \
        + sum(t.numel() for t in params["layers"]["mlp"].values()) + params["embed"].numel()
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, heads {cfg.n_heads} "
          f"(kv {cfg.n_kv_heads}), d_head {cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; "
          f"{n_params} weights drawn and cast to bf16 in {time.perf_counter() - t0:.1f} s")
    B, P, G = SERVE["batch"], SERVE["prompt"] // (16 if small else 1), SERVE["gen"]
    prompts = serve.make_prompts(cfg, B, P, dev)
    serve.generate(params, cfg, prompts, 2)          # warm-up: cuBLAS handles, the allocator
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    fa.launches = 0
    res = serve.generate(params, cfg, prompts, G)
    launches = fa.launches
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    wall = res.prefill_s + res.decode_s
    print(f"  prefill {res.prefill_s * 1e3:.3f} ms ({B * P / res.prefill_s:.1f} prompt tok/s); "
          f"decode {res.decode_ms_per_token:.3f} ms per token ({B * (G - 1) / res.decode_s:.1f} "
          f"tok/s over {G - 1} steps); {B * G / wall:.1f} tok/s end to end ({wall:.3f} s); "
          f"peak device memory {peak} bytes; flash launches {launches}")
    print(f"  sample: {res.tokens[0][:12].tolist()}")
    if dev.type == "cuda":
        prof = serve.profile_serve(params, cfg, prompts, min(G, 9))
        print("  under torch.profiler (same shapes, after the measured run; 8 decode steps):")
        print("\n".join("    " + line for line in format_profile(prof).splitlines()))
    logits = res.prefill_logits
    check(res.tokens.shape == (B, G) and bool(((res.tokens >= 0) & (res.tokens < cfg.vocab)).all())
          and tuple(logits.shape) == (B, cfg.vocab) and bool(torch.isfinite(logits).all()),
          f"served {B} x {G} tokens in range, prefill logits ({B}, {cfg.vocab}) finite")
    if dev.type == "cuda":
        check(launches == cfg.n_layers,
              f"the prefill launched the flash kernel once a layer ({launches} == {cfg.n_layers})")
    del res, logits, prompts

    # the card's route against the CPU's plain route, from the same weights, and
    # both against a float32 evaluation of those weights
    prompt1 = serve.make_prompts(cfg, 1, 128, cpu)
    card = serve.generate(params, cfg, prompt1.to(dev), 5, keep_logits=True)
    t0 = time.perf_counter()
    plain = serve.generate(cpu_params, cfg, prompt1, 5, forced=card.tokens, keep_logits=True)
    exact = serve.generate(f32_params, cfg, prompt1, 5, forced=card.tokens, keep_logits=True,
                           dtype=torch.float32)
    print(f"  batch 1, prompt 128 on the CPU in bf16 and in float32 (plain versions) in "
          f"{time.perf_counter() - t0:.1f} s")

    for i, (got, want, ref) in enumerate(zip([card.prefill_logits] + card.step_logits,
                                             [plain.prefill_logits] + plain.step_logits,
                                             [exact.prefill_logits] + exact.step_logits)):
        r = checks.hold_bf16_noise(got, want, ref)
        ulp = r["ulp"]
        check(r["ok"],
              f"{'prefill' if i == 0 else f'decode step {i}'} logits in bf16 ulps of max|logit| "
              f"{float(ref.abs().max()):.4g}: card vs CPU {r['err'] / ulp:.2f}, card vs float32 "
              f"{r['err64'] / ulp:.2f}, CPU vs float32 {r['noise'] / ulp:.2f}; tolerance "
              f"{r['tol'] / ulp:.2f}")
    del params, cpu_params, f32_params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return launches


def bag_cases(torch, np, dev, st, small: bool = False) -> None:
    """Phase 15: the embedding-bag kernel against its plain version
    (``embedding_bag_sum_ref``). ``small`` (the CPU rehearsal) cuts the DIN
    shapes by 64."""
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_bag import ops as bag

    rng = np.random.default_rng(2)
    cut = 64 if small else 1

    def table(V, D, dtype=torch.float32):
        return torch.as_tensor(rng.standard_normal((V, D), dtype=np.float32), device=dev).to(dtype)

    def ints(lo, hi, shape):
        return torch.as_tensor(rng.integers(lo, hi, shape).astype(np.int32), device=dev)

    def zipf_hist(V, B, L):
        """Zipf(1.3) item ids clipped at V - 1, padded with -1 past a length
        drawn from [L/4, L], as ``synth_batch`` draws DIN's history."""
        idx = rng.zipf(1.3, (B, L)).clip(max=V - 1)
        lens = rng.integers(L // 4, L + 1, B)
        idx = np.where(np.arange(L)[None, :] < lens[:, None], idx, -1)
        return torch.as_tensor(idx.astype(np.int32), device=dev)

    def offset_view(flat, V, D):
        """A (V, D) view whose base lies one element into ``flat``'s buffer."""
        return flat.view(-1)[1:1 + V * D].view(V, D)

    all_pad = ints(-1, 50, (9, 6))
    all_pad[::3] = -1
    cases = [  # table, indices, label, timed
        (table(100, 8), ints(-1, 100, (4, 5)), "sweep", False),
        (table(500, 24), ints(-1, 500, (13, 7)), "sweep", False),
        (table(1000, 32), ints(-1, 1000, (32, 20)), "sweep", False),
        (table(50, 18), all_pad, "bags all padding", False),
        (table(100, 18), ints(-1, 100, (33, 1)), "L = 1", False),
        (table(100, 18), ints(-1, 100, (0, 5)), "B = 0", False),
        (table(100, 18), ints(-1, 100, (7, 0)), "L = 0", False),
        (table(1000, 32, torch.bfloat16), ints(-1, 1000, (64, 20)), "bf16 table", False),
        (table(1000, 18, torch.bfloat16), ints(0, 1000, (512, 16)), "bf16 table, DIN widths",
         False),
        (table(10_000, 18), ints(0, 10_000, (512 // cut, 16)), "DIN context bag, serve_p99", True),
        (table(10_000, 18), ints(0, 10_000, (262_144 // cut, 16)), "DIN context bag, serve_bulk",
         True),
        (table(1_000_000 // cut, 18), zipf_hist(1_000_000 // cut, 65_536 // cut, 100),
         "item table, Zipf history", False),
        # rows read 4, 8 and 16 bytes at a time, and bases that allow only 4 or 16; L around the
        # unrolled step and the staged tile; bf16 at DIN's width; B not a multiple of the 24
        # bags a block takes at D = 18
        (table(1000, 17), ints(-1, 1000, (301, 16)), "D = 17", False),
        (table(1000, 18), ints(-1, 1000, (301, 16)), "D = 18", False),
        (table(1000, 32), ints(-1, 1000, (301, 16)), "D = 32", False),
        (offset_view(table(1001 * 18 + 1, 1), 1000, 18), ints(-1, 1000, (301, 16)),
         "a table view 4 bytes off its buffer", False),
        (table(1000, 32)[1:], ints(-1, 999, (99, 16)), "a table view one row in", False),
        (table(1000, 18), ints(-1, 1000, (97, 1)), "L = 1", False),
        (table(1000, 18), ints(-1, 1000, (97, 15)), "L = 15", False),
        (table(1000, 18), ints(-1, 1000, (97, 17)), "L = 17", False),
        (table(1000, 18), ints(-1, 1000, (97, 100)), "L = 100", False),
        (table(10_000, 18, torch.bfloat16), ints(-1, 10_000, (1001, 16)), "bf16, D = 18", False),
        (table(10_000, 18), ints(0, 10_000, (24 * 41 + 1, 16)), "B = 24 * 41 + 1", False),
    ]
    for tab, idx, label, timed in cases:
        got = bag.embedding_bag_sum(tab, idx)
        want = bag.embedding_bag_sum_ref(tab, idx)
        diff = (got.float() - want.float()).abs()
        B, L = idx.shape
        msg = f"embedding_bag {label}: V={tab.shape[0]} D={tab.shape[1]} B={B} L={L} " \
              f"{str(tab.dtype).split('.')[1]}: "
        if tab.dtype == torch.bfloat16:
            # the two sum in float32 in other orders, so their roundings to bf16 may differ by one
            # unit in the last place of the output
            ulp = torch.exp2(torch.floor(torch.log2(want.float().abs().clamp(min=2.0**-126))) - 7)
            ulps = float((diff / ulp).max()) if diff.numel() else 0.0
            st["err_bf16_ulps"] = max(st["err_bf16_ulps"], ulps)
            ok = ulps <= 1.0
            msg += f"max|err| {ulps:.3g} bf16 ulps of the output <= 1"
        else:
            excess = float((diff - BAG_TOL * want.abs()).max()) if diff.numel() else -BAG_TOL
            err = float(diff.max()) if diff.numel() else 0.0
            st["err"] = max(st["err"], err)
            st["excess"] = max(st["excess"], excess)
            ok = excess <= BAG_TOL
            msg += (f"max|err| {err:.3g}, max(|err| - rtol |want|) {excess:.3g} <= atol "
                    f"(rtol = atol = {BAG_TOL})")
        ok = ok and got.shape == (B, tab.shape[1]) and got.dtype == tab.dtype \
            and bool(torch.isfinite(got).all())
        if label == "bags all padding":
            ok = ok and not bool(got[::3].any())
            msg += "; the padded bags are 0"
        if label == "L = 0":
            ok = ok and not bool(got.any())
            msg += "; all 0"
        if timed:
            safe, weight = idx.clamp(min=0), (idx >= 0).to(tab.dtype)   # for F.embedding_bag
            lib_out = F.embedding_bag(safe, tab, mode="sum", per_sample_weights=weight)
            lib_err = float((lib_out - want).abs().max())
            reps = 200 if B < 10_000 else 50
            ms = time_ms(torch, lambda: bag.embedding_bag_sum(tab, idx), reps)
            dev_ms = device_ms(torch, lambda: bag.embedding_bag_sum(tab, idx), 10, "bag_sum")
            plain = time_ms(torch, lambda: bag.embedding_bag_sum_ref(tab, idx), 10)
            lib = time_ms(torch, lambda: F.embedding_bag(safe, tab, mode="sum",
                                                         per_sample_weights=weight), reps)
            rows = int(torch.unique(idx[idx >= 0]).numel())
            nbytes = bag.cost(*idx.shape, tab.shape[1], tab.shape[0], tab.element_size(), rows)[1]
            bnd = bound_ms(nbytes)
            st.setdefault("timed", {})[label] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain,
                                                     library_ms=lib, bound_ms=bnd)
            if "serve_bulk" in label:
                st.update(ms=ms, device_ms=dev_ms, plain_ms=plain, library_ms=lib, bound_ms=bnd)
            msg += (f"; {ms:.4f} ms a call, {dev_ms or 0.0:.4f} ms on the device, plain "
                    f"{plain:.4f} ms, F.embedding_bag {lib:.4f} ms (its max|err| {lib_err:.3g}; "
                    f"indices clamped and masked beforehand), bound {bnd:.4f} ms ({nbytes} bytes: "
                    f"indices, output, {rows} table rows), {bnd / ms:.1%} of the call, "
                    f"{bnd / (dev_ms or ms):.1%} of the device time")
        check(ok, msg)
        del got, want, diff


def hold(what: str, card, cpu, f64) -> bool:
    """Check the card's ``card`` within ``checks.tolerance`` of the CPU
    route and of the float64 evaluation (``checks.hold``)."""
    from repro_torch import checks

    r = checks.hold(card, cpu, f64)
    ulp = r["ulp"]
    return check(r["ok"],
                 f"{what}, in float32 ulps ({ulp:.3g}) of the largest magnitude: card vs CPU "
                 f"{r['err'] / ulp:.2f}, card vs float64 {r['err64'] / ulp:.2f}, CPU vs float64 "
                 f"{r['noise'] / ulp:.2f}; tolerance {r['tol'] / ulp:.2f}")


def din_full_width(torch, dev, small: bool = False) -> int:
    """Phase 16: DIN at full width on the card through the launcher's
    functions, then the card against the CPU and a float64 evaluation.
    Returns the bag kernel's launches in the measured train, serve and
    retrieval runs. ``small`` (the CPU rehearsal) runs the SMOKE config at
    small batches."""
    from repro_torch import checks
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.kernels.embedding_bag import ops as bag
    from repro_torch.launch import din_serve
    from repro_torch.models.recsys import din, steps
    from repro_torch.obs.profile import format_profile, profile_call
    from repro_torch.optim import adamw_init
    from repro_torch.tree import leaves

    cfg = (get_smoke if small else get_config)("din")
    cut = 64 if small else 1
    cpu = torch.device("cpu")
    on_card = dev.type == "cuda"

    def peak():
        return torch.cuda.max_memory_allocated(dev) if on_card else 0

    def reset():
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)

    check(not torch.backends.cuda.matmul.allow_tf32, "float32 products are full float32 (no TF32)")
    t0 = time.perf_counter()
    params = din.init_params(cfg, DIN["seed"], dev)
    n_params = sum(p.numel() for p in leaves(params))
    print(f"  {cfg.name}: embed_dim {cfg.embed_dim}, seq_len {cfg.seq_len}, attention MLP "
          f"{cfg.attn_mlp}, prediction MLP {cfg.mlp}, {cfg.n_items} items, {cfg.n_cates} "
          f"categories; {n_params} weights drawn on {dev} in {time.perf_counter() - t0:.2f} s")
    launches = 0

    # 1. train
    B = DIN["train_batch"] // cut
    reset()
    bag.launches = 0
    tr = din_serve.train(params, adamw_init(params), cfg, DIN["train_steps"], B, dev)
    launches += bag.launches
    print(f"  train: {DIN['train_steps']} steps at batch {B}: losses "
          f"{[round(x, 6) for x in tr.losses]}, {tr.ms_per_step:.3f} ms a step (the first "
          f"included); peak device memory {peak()} bytes; bag launches {bag.launches}")
    check(all(math.isfinite(x) for x in tr.losses), "train losses finite")
    if on_card:
        check(bag.launches == DIN["train_steps"],
              f"one bag launch a train forward ({bag.launches} == {DIN['train_steps']})")

    # 2. serve
    serve_batches = {}
    for B in DIN["serve"]:
        B //= cut
        batch = serve_batches[B] = din_serve.make_batch(cfg, "serve", B, 99, dev)
        din_serve.serve(tr.params, cfg, batch)                  # warm-up
        reps = 10 if B <= 512 else 3
        reset()
        bag.launches = 0
        times = []
        for _ in range(reps):
            probs, ms = din_serve.serve(tr.params, cfg, batch)
            times.append(ms)
        launches += bag.launches
        print(f"  serve batch {B}: {sum(times) / reps:.3f} ms a batch (min {min(times):.3f}, "
              f"{reps} batches; {B * reps / sum(times) * 1e3:.1f} requests/s), mean ctr "
              f"{float(probs.mean()):.6f}; peak device memory {peak()} bytes; bag launches "
              f"{bag.launches}")
        check(probs.shape == (B,) and bool(((probs > 0) & (probs < 1)).all()),
              f"serve batch {B}: probabilities in (0, 1)")
        if on_card:
            check(bag.launches == reps, f"serve batch {B}: one bag launch a step "
                                        f"({bag.launches} == {reps})")
        del probs

    # 3. retrieval
    N = DIN["n_candidates"] // cut
    rb = din_serve.make_batch(cfg, "retrieval", N, 7, dev)
    din_serve.retrieve(tr.params, cfg, rb, DIN["top_k"])        # warm-up
    reset()
    bag.launches = 0
    vals, idx, ms = din_serve.retrieve(tr.params, cfg, rb, DIN["top_k"])
    launches += bag.launches
    n_pad = rb["cand_items"].numel()
    print(f"  retrieval over {n_pad} candidates (padded from {N}), top {DIN['top_k']}: {ms:.3f} "
          f"ms; peak device memory {peak()} bytes; bag launches {bag.launches}; best "
          f"{idx[:5].tolist()}")
    check(n_pad == -(-N // 512) * 512 and vals.shape == idx.shape == (DIN["top_k"],)
          and bool(torch.isfinite(vals).all()) and bool(((idx >= 0) & (idx < n_pad)).all())
          and bool((vals[:-1] >= vals[1:]).all()),
          f"retrieval: {DIN['top_k']} finite scores, best first, of {n_pad} candidates")
    if on_card:
        check(bag.launches == 0, "retrieval launched no bag kernel")
        # the same calls once more under torch.profiler
        prof = {}
        train_step = steps.make_train_step(cfg)
        tb = din_serve.make_batch(cfg, "train", DIN["train_batch"], 0, dev)
        _, prof[f"train step, batch {DIN['train_batch']}"] = profile_call(
            lambda: train_step(tr.params, tr.opt_state, tb), dev)
        serve_step = steps.make_serve_step(cfg)
        for B, batch in serve_batches.items():
            _, prof[f"serve, batch {B}"] = profile_call(lambda: serve_step(tr.params, batch), dev)
        retrieval_step = steps.make_retrieval_step(cfg, DIN["top_k"])
        _, prof[f"retrieval, {n_pad} candidates"] = profile_call(
            lambda: retrieval_step(tr.params, rb), dev)
        print("  under torch.profiler (the same shapes, after the measured runs):")
        print("\n".join("    " + line for line in format_profile(prof).splitlines()))
        del tb
    del rb, vals, idx, serve_batches

    # 4. the card against the CPU's float32 route and a float64 evaluation on the CPU
    t0 = time.perf_counter()
    p32 = din.params_to(tr.params, cpu)
    p64 = din.params_to(p32, dtype=torch.float64)
    sb = steps.synth_batch(cfg, din_serve.shape_spec("serve", DIN["check_serve"] // cut), seed=99)
    with torch.no_grad():
        hold(f"serve logits at batch {DIN['check_serve'] // cut}",
             *(din.logits(p, cfg, steps.batch_to(sb, d)) for p, d in
               [(tr.params, dev), (p32, cpu), (p64, cpu)]))

    tb = steps.synth_batch(cfg, din_serve.shape_spec("train", DIN["check_train"] // cut), seed=123)
    step = steps.make_train_step(cfg)
    o32 = din.params_to(tr.opt_state, cpu)
    o64 = {"m": din.params_to(o32["m"], dtype=torch.float64),
           "v": din.params_to(o32["v"], dtype=torch.float64), "count": o32["count"]}
    outs = [step(p, o, steps.batch_to(tb, d)) for p, o, d in
            [(tr.params, tr.opt_state, dev), (p32, o32, cpu), (p64, o64, cpu)]]
    B = DIN["check_train"] // cut
    hold(f"train step at batch {B}: loss", *(o[2]["loss"] for o in outs))
    hold(f"train step at batch {B}: grad norm", *(o[2]["grad_norm"] for o in outs))
    hold(f"train step at batch {B}: updated parameters (all {n_params})",
         *(leaves(o[0]) for o in outs))
    del outs, o32, o64

    rb = steps.synth_batch(cfg, din_serve.shape_spec("retrieval", DIN["check_retrieval"] // cut),
                           seed=7)
    with torch.no_grad():
        scores = [din.retrieval_scores(p, cfg, steps.batch_to(rb, d)) for p, d in
                  [(tr.params, dev), (p32, cpu), (p64, cpu)]]
    ok = hold(f"retrieval scores over {scores[1].numel()} candidates", *scores)
    tol, _ = checks.tolerance(scores[1], scores[2])
    vals, idx = torch.topk(scores[0], DIN["top_k"])
    for name, ref in [("CPU", scores[1]), ("float64", scores[2])]:
        res = checks.check_topk(vals, idx, ref, tol)
        check(ok and res["ok"], f"retrieval top {DIN['top_k']} of the card against the {name} "
              f"scores (tol {tol:.3g}): values {res['value_err']:.3g}, each index's score "
              f"{res['index_err']:.3g}, {res['sure']} candidates clear of ties all present "
              f"(missing {res['missing']}), unique {res['unique']}")
    print(f"  card against CPU and float64 in {time.perf_counter() - t0:.1f} s")
    del params, tr, p32, p64, scores
    if on_card:
        torch.cuda.empty_cache()
    return launches


STATS = ("messages_per_round", "active_per_round", "changed_per_round")
STREAM_MODES = ("dense", "compact", "fused", "auto")
# the full-size stream's batches, as fractions of the edges: a second, 0.01, was cut to keep the
# smoke inside 1,200 s on a slow host (PERF.md section 4)
STREAM_CHURN = (0.002,)


def same_bills(a, b) -> bool:
    """Equal rounds and per-round messages, active and changed counts."""
    import numpy as np

    return a.rounds == b.rounds and all(
        np.array_equal(getattr(a.stats, k), getattr(b.stats, k)) for k in STATS)


def other_static_modes(torch, dev, table1, launches) -> None:
    """Phase 7: the ELL backends and block_gs on the Table-I set, held
    against phase 4's segment-backend runs and BZ."""
    import numpy as np

    from repro_torch.configs.kcore_paper import CONFIG_BEYOND
    from repro_torch.core.kcore import KCoreConfig, kcore_decompose
    from repro_torch.kernels.kcore_hindex import ops as hk
    from repro_torch.kernels.segment_sum import ops as sk

    on_card = dev.type == "cuda"
    print(f"  {'graph':6} {'jacobi_msgs':>12} {'gs_msgs':>10} {'msg_reduction':>14} "
          f"{'jacobi_rounds':>14} {'gs_rounds':>10}   (block_gs at {CONFIG_BEYOND.n_blocks} blocks)")
    for abbrev, (ga, bz, seg) in table1.items():
        for backend in ("ell", "ell_pallas"):
            hk.launches = sk.launches = 0
            res = kcore_decompose(ga, KCoreConfig(backend=backend), device=dev)
            launches["kcore_hindex"] += hk.launches
            launches["segment_sum"] += sk.launches
            check(np.array_equal(res.core, bz) and res.converged and same_bills(res, seg),
                  f"{abbrev} --backend {backend}: cores equal BZ, rounds and per-round bills equal "
                  f"the segment backend's ({res.rounds} rounds, {res.stats.total_messages} "
                  f"messages; launches kcore_hindex {hk.launches}, segment_sum {sk.launches})")
            if on_card:
                check(hk.launches > 0, f"{abbrev} --backend {backend} launched kcore_hindex")
        hk.launches = sk.launches = 0
        gs = kcore_decompose(ga, CONFIG_BEYOND, device=dev)
        launches["kcore_hindex"] += hk.launches
        launches["segment_sum"] += sk.launches
        jac, gsm = seg.stats.total_messages, gs.stats.total_messages
        print(f"  {abbrev:6} {jac:>12} {gsm:>10} {round(1 - gsm / max(jac, 1), 3):>14} "
              f"{seg.rounds:>14} {gs.rounds:>10}   block_gs "
              f"{gs.phase_s['converge'] * 1e3 / max(gs.rounds, 1):.3f} ms a round; launches "
              f"segment_sum {sk.launches}, kcore_hindex {hk.launches}")
        check(np.array_equal(gs.core, bz) and gs.converged,
              f"{abbrev} --mode block_gs ({CONFIG_BEYOND.n_blocks} blocks): cores equal BZ")
        if on_card:
            check(sk.launches > 0 and hk.launches == 0,
                  f"{abbrev} block_gs ran on the segment_sum kernel alone")


def segsum_held(torch, cases, what: str) -> int:
    """Hold the segment_sum kernel bit-exact against its plain version on
    ``cases``, a list of ``(label, vals, row_ptr)``. These launches only
    compare and are taken off the count again. Returns the largest error."""
    from repro_torch.kernels.segment_sum import ops as sk

    counted, worst = sk.launches, 0
    for label, vals, row_ptr in cases:
        err = max_err(torch, sk.segment_sum(vals, row_ptr), sk.segment_sum_ref(vals, row_ptr))
        worst = max(worst, err)
        check(err == 0, f"segment_sum {what}, {label}: E={vals.numel()} "
                        f"n={row_ptr.numel() - 1} bit-equal")
    sk.launches = counted
    return worst


def first_probe_hits(torch, est_u, est_dst, src):
    """The hit vector of ``_hindex_by_bsearch``'s first probe."""
    mid_src = ((est_u + 1) // 2).index_select(0, src)
    return ((est_dst >= mid_src) & (mid_src > 0)).to(torch.int32)


def block_gs_full(torch, dev, g, core_bz, jacobi, spr_scale, launches) -> int:
    """Phase 8: SPR through ``kcore_run --mode block_gs``, against the
    Jacobi host loop of phase 6; then the segment sums at the shapes of its
    blocks, kernel against plain. Returns the largest segment_sum error."""
    import numpy as np

    from repro_torch.core import dispatch
    from repro_torch.core.kcore import KCoreConfig
    from repro_torch.kernels.kcore_hindex import ops as hk
    from repro_torch.kernels.segment_sum import ops as sk
    from repro_torch.launch import kcore_run

    on_card = dev.type == "cuda"
    args = kcore_run.parse_args(["--graph", "SPR", "--scale", str(spr_scale), "--device",
                                 dev.type, "--json", "--mode", "block_gs"])
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    hk.launches = sk.launches = 0
    report, res = kcore_run.decompose_report(g, args, core_ref=core_bz)
    launches["kcore_hindex"] += hk.launches
    launches["segment_sum"] += sk.launches
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    jac_ms = jacobi.phase_s["converge"] * 1e3 / max(jacobi.rounds, 1)
    gs_ms = res.phase_s["converge"] * 1e3 / max(res.rounds, 1)
    print(f"  block_gs, {res.rounds} rounds, {res.stats.total_messages} messages, wall_s "
          f"{report['wall_s']}, phase_s {report['phase_s']}, {gs_ms:.3f} ms a round, peak_bytes "
          f"{peak}; launches segment_sum {sk.launches}, kcore_hindex {hk.launches}")
    print(f"  jacobi host loop (phase 6): {jacobi.rounds} rounds, {jacobi.stats.total_messages} "
          f"messages, {jac_ms:.3f} ms a round; block_gs saves "
          f"{1 - res.stats.total_messages / max(jacobi.stats.total_messages, 1):.3%} of the "
          f"messages and {jacobi.rounds - res.rounds} rounds")
    check(report["correct_vs_BZ"] and report["converged"], "SPR block_gs: cores equal BZ")
    if on_card:
        check(sk.launches > 0 and hk.launches == 0, "SPR block_gs ran on the segment_sum kernel")
    # every block's staged slices (local row pointer shifted by the block's
    # first arc) with the hits of round 1's first probe from the degree seed
    st = dispatch.stage_blocks(g.n, g.src, g.dst, KCoreConfig().n_blocks, dev)
    deg = torch.as_tensor(g.deg, dtype=torch.int32, device=dev)
    est = torch.cat([deg, deg.new_zeros(st.n_pad - g.n)])
    wide = int(np.argmax(g.deg)) // st.V
    cases = [(f"block {b}{' (the widest row)' if b == wide else ''}",
              first_probe_hits(torch, est[v0:v0 + st.V], est.index_select(0, b_dst), b_src),
              b_ptr) for b, (v0, b_src, b_dst, b_ptr) in enumerate(st.blocks)]
    err = segsum_held(torch, cases, "at the block_gs slices")
    del st, cases
    return err


def streaming_gate(torch, dev, launches) -> None:
    """Phase 9: ``benchmarks/streaming_baseline.json``'s mean ratios at its
    settings (``benchmarks/streaming_maintenance.py``'s loop), with its
    sharded twin beside the dense engine, here on a 4-shard mesh."""
    import numpy as np

    from repro_torch.core.bz import bz_core_numbers
    from repro_torch.core.kcore import kcore_decompose
    from repro_torch.distribution.compat import make_mesh
    from repro_torch.graph import generators
    from repro_torch.kernels.kcore_hindex import ops as hk
    from repro_torch.kernels.segment_sum import ops as sk
    from repro_torch.streaming import StreamingConfig, StreamingKCoreEngine, random_churn_batch

    base = json.loads((ROOT / "benchmarks" / "streaming_baseline.json").read_text())
    cfg = base["settings"]
    mesh = make_mesh((SHARDS,), ("data",), device=dev)
    print(f"  settings {cfg}; the sharded twin on a {SHARDS}-shard mesh beside the dense engine")
    for abbrev in cfg["graphs"]:
        for churn in cfg["churn_rates"]:
            g = generators.snap_analogue(
                abbrev, scale=cfg["target_n"] / generators.SNAP_BY_ABBREV[abbrev].n, seed=0)
            t0 = time.perf_counter()
            hk.launches = sk.launches = 0
            eng = StreamingKCoreEngine(g, device=dev)
            twin = StreamingKCoreEngine(g, StreamingConfig(frontier="sharded"), mesh=mesh)
            launches["kcore_hindex"] += hk.launches
            launches["segment_sum"] += sk.launches
            rng = np.random.default_rng(1)
            ratios, ok, twin_ok = [], True, bool((twin.core == eng.core).all())
            for _ in range(cfg["batches"]):
                g_before = eng.graph
                b = max(2, int(churn * g_before.m))
                batch = random_churn_batch(g_before, b // 2, b - b // 2, rng)
                hk.launches = sk.launches = 0
                res = eng.apply_batch(batch)
                res_sh = twin.apply_batch(batch)
                launches["kcore_hindex"] += hk.launches
                launches["segment_sum"] += sk.launches
                twin_ok = (twin_ok and res_sh.mode == "sharded" and same_bills(res_sh, res)
                           and np.array_equal(res_sh.core, res.core))
                scratch = kcore_decompose(eng.graph, device=dev)
                ok = ok and bool((res.core == bz_core_numbers(eng.graph)).all())
                ratios.append(round(res.total_messages / max(scratch.stats.total_messages, 1), 4))
            key = f"{abbrev}/{churn}"
            mean = round(float(np.mean(ratios)), 4)
            check(ok and mean == base["mean_ratio"][key],
                  f"streaming gate {key}: n={g.n} m={g.m}, every batch BZ-exact, mean ratio "
                  f"{mean} == {base['mean_ratio'][key]} ({time.perf_counter() - t0:.2f} s)")
            check(twin_ok, f"streaming gate {key}: the {SHARDS}-shard sharded twin equals the "
                           f"dense engine in cores, rounds and per-round bills, every batch")


def streaming_full(torch, dev, g, core_bz, launches):
    """Phase 10: one SPR stream through the four frontier modes; after each
    batch the segment sums of a compact subproblem, kernel against plain.
    Returns the largest segment_sum error and ``(state, batch, result)``:
    the engine's state before the stream, its first batch and the dense
    engine's result of it, which phase 21 replays on a mesh."""
    import numpy as np

    from repro_torch.core import dispatch
    from repro_torch.core.bz import bz_core_numbers
    from repro_torch.core.kcore import KCoreConfig, _receivers, kcore_decompose
    from repro_torch.kernels.kcore_hindex import ops as hk
    from repro_torch.kernels.segment_sum import ops as sk
    from repro_torch.streaming import StreamingConfig, StreamingKCoreEngine, random_churn_batch
    from repro_torch.streaming.engine import compact_subproblem

    on_card = dev.type == "cuda"
    err = 0
    t0 = time.perf_counter()
    hk.launches = sk.launches = 0
    base = StreamingKCoreEngine(g, kcore_config=KCoreConfig(fused=True), device=dev)
    launches["kcore_hindex"] += hk.launches
    launches["segment_sum"] += sk.launches
    state = base.state_dict()
    engines = {mode: StreamingKCoreEngine.from_state_dict(state, StreamingConfig(frontier=mode),
                                                         device=dev)
               for mode in STREAM_MODES}
    print(f"  engine on SPR (n={g.n}, m={g.m}, CSR capacity {base.csr.capacity}) with a fused "
          f"initial decomposition, {base.init_result.rounds} rounds, and 4 clones through "
          f"state_dict in {time.perf_counter() - t0:.1f} s")
    check(np.array_equal(base.core, core_bz), "streaming engine: initial cores equal BZ")
    del base
    rng = np.random.default_rng(1)
    g_cur = g
    for i, churn in enumerate(STREAM_CHURN):
        b = max(2, int(churn * g_cur.m))
        batch = random_churn_batch(g_cur, b // 2, b - b // 2, rng)
        results, seen = {}, {}
        for mode, eng in engines.items():
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            hk.launches = sk.launches = 0
            results[mode] = eng.apply_batch(batch)
            launches["kcore_hindex"] += hk.launches
            launches["segment_sum"] += sk.launches
            seen[mode] = (sk.launches, hk.launches,
                          torch.cuda.max_memory_allocated() if on_card else 0)
        g_cur = engines["dense"].graph
        if i == 0:
            first = (state, batch, results["dense"])
        t0 = time.perf_counter()
        bz = bz_core_numbers(g_cur)
        t_bz = time.perf_counter() - t0
        scratch = kcore_decompose(g_cur, fused=True, device=dev)
        print(f"  batch {i}: churn {churn}, {b} edges asked ({batch.insert.shape[0]} inserts, "
              f"{batch.delete.shape[0]} deletes), n={g_cur.n} m={g_cur.m}; BZ {t_bz:.1f} s; "
              f"from scratch (fused) {scratch.rounds} rounds, {scratch.stats.total_messages} "
              f"messages, {scratch.phase_s['device-converge']:.4f} s on the device")
        dense = results["dense"]
        for mode, res in results.items():
            busy = res.seed_s + res.converge_s
            sk_n, hk_n, peak = seen[mode]
            print(f"    {mode:8} ran {res.mode:8} patch_s {res.patch_s:.4f} seed_s {res.seed_s:.4f} "
                  f"converge_s {res.converge_s:.4f} reconstruct_s {res.reconstruct_s:.4f} "
                  f"stage_s {res.stage_s:.4f} ({res.stage_s / max(busy, 1e-12):.1%} of seed + "
                  f"converge); rounds {res.rounds}, messages {res.total_messages} "
                  f"({res.total_messages / max(scratch.stats.total_messages, 1):.4f} of scratch); "
                  f"region {res.region_size}, seed {res.seed_strategy}, est. passes "
                  f"{res.seed_est_passes}, seed_changed {res.seed_changed}; flag reads "
                  f"{res.flag_reads}; launches segment_sum {sk_n}, kcore_hindex {hk_n}; "
                  f"peak_bytes {peak}")
            check(np.array_equal(res.core, dense.core) and same_bills(res, dense)
                  and res.converged, f"streaming batch {i}: {mode} equals dense in cores, "
                                     f"rounds and per-round bills")
            if on_card:
                check(sk_n > 0, f"streaming batch {i}: {mode} launched segment_sum")
        check(np.array_equal(dense.core, bz), f"streaming batch {i}: cores equal BZ")
        # compact subproblems over the live arcs at the new cores: a small
        # frontier (the batch's touched vertices) and a wide one (and their
        # receivers)
        src, dst, row_ptr = dispatch.stage_arcs(g_cur.src, g_cur.dst, g_cur.n, dev)
        core = torch.as_tensor(results["compact"].core, device=dev)
        act = torch.zeros(g_cur.n, dtype=torch.bool, device=dev)
        touched = results["compact"].delta.touched
        act[torch.as_tensor(touched[touched < g_cur.n], device=dev)] = True
        for frontier in ("touched", "touched and receivers"):
            if frontier != "touched":
                act |= _receivers(act, dst, row_ptr)
            _, sub_src, sub_ptr, est_u, est_dst = compact_subproblem(core, act, src, dst)
            err = max(err, segsum_held(
                torch, [(f"batch {i}, {frontier}, {est_u.numel()} active rows",
                         first_probe_hits(torch, est_u, est_dst, sub_src), sub_ptr)],
                "at a compact subproblem"))
        del src, dst, row_ptr, core, act, sub_src, sub_ptr, est_u, est_dst
    del engines, results, g_cur
    return err, first


# the full-size temporal run: SPR's log with 15 % link-decay removals, a count window of 750,000
# events (about 2 % of the stream) sliding 75,000 at a time (0.25 % of SPR's edges), filled in one
# advance of 10 strides and checkpointed, then one sliding advance taken by the window and by its
# warm restart (so the whole smoke keeps inside its 1,200 s on a slow host: the window was
# 3,000,000 and then 1,500,000 events before, PERF.md section 4)
TEMPORAL = {"remove_frac": 0.15, "window": 750_000, "stride": 75_000, "frontier": "fused"}
# BatchResult fields that are walls (or builds) rather than accounting
WALLS = ("patch_s", "seed_s", "converge_s", "reconstruct_s", "recompiles", "compile_s", "stage_s")


def same_batch(a, b, skip=()) -> bool:
    """Equal cores, per-round bills, delta and every accounting field but
    those in ``skip``."""
    import dataclasses

    import numpy as np

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name in WALLS or f.name == "stats" or f.name in skip:
            continue
        if f.name == "delta":
            if not all(np.array_equal(getattr(x, k), getattr(y, k))
                       for k in ("inserted", "deleted", "touched")) or x.compacted != y.compacted:
                return False
        elif isinstance(x, np.ndarray):
            if not np.array_equal(x, y):
                return False
        elif x != y:
            return False
    return same_bills(a, b)


def gate_trace(name: str, cfg: dict):
    """``benchmarks/temporal_replay.py::traces`` at the baseline's settings
    ``cfg``, on the port's generators: (log, window, stride, by)."""
    from repro_torch.graph import generators
    from repro_torch.temporal import (contact_bursts, temporal_barabasi_albert,
                                      temporal_snap_analogue)

    n, steps, strides = cfg["target_n"], cfg["steps"], cfg["window_strides"]
    if name in ("EEN", "FC"):
        log = temporal_snap_analogue(name, scale=n / generators.SNAP_BY_ABBREV[name].n, seed=0,
                                     remove_frac=cfg["snap_remove_frac"])
    elif name == "ba":
        log = temporal_barabasi_albert(n, 3, seed=0, remove_frac=cfg["ba_remove_frac"])
    else:
        log = contact_bursts(max(n // 10, 20), n_bursts=4 * steps, seed=0)
        stride = max((log.t_max - log.t_min) / (steps + 2), 1e-9)
        return log, strides * stride, stride, "time"
    stride = max(len(log) // (steps + 2), 1)
    return log, strides * stride, stride, "count"


def temporal_gate(torch, dev, launches) -> None:
    """Phase 11: ``benchmarks/temporal_baseline.json``'s four mean ratios at
    its settings (``benchmarks/temporal_replay.py::run_records`` on the
    port: every boundary BZ-checked, each window graph's scratch bill from
    ``kcore_decompose`` on the card)."""
    import numpy as np

    from repro_torch.core.kcore import kcore_decompose
    from repro_torch.kernels.kcore_hindex import ops as hk
    from repro_torch.kernels.segment_sum import ops as sk
    from repro_torch.streaming import StreamingConfig
    from repro_torch.temporal import replay

    base = json.loads((ROOT / "benchmarks" / "temporal_baseline.json").read_text())
    cfg = base["settings"]
    print(f"  settings {cfg}")
    for name in cfg["traces"]:
        log, window, stride, by = gate_trace(name, cfg)
        t0 = time.perf_counter()
        hk.launches = sk.launches = 0
        traj = replay(log, window, stride, by=by, oracle_every=1,
                      config=StreamingConfig(frontier=cfg["frontier"]), max_steps=cfg["steps"],
                      device=dev)
        launches["kcore_hindex"] += hk.launches
        launches["segment_sum"] += sk.launches
        seg = sk.launches
        ratios = []
        for rec in traj.records:
            scratch = kcore_decompose(log.graph_between(rec.lo, rec.hi), device=dev)
            ratios.append(round(rec.messages / max(scratch.stats.total_messages, 1), 4))
        mean = round(float(np.mean(ratios)), 4)
        per_round = np.mean([r.step_ms / max(r.rounds, 1) for r in traj.records])
        check(all(r.oracle_ok for r in traj.records) and len(ratios) == cfg["steps"]
              and mean == base["mean_ratio"][name],
              f"temporal gate {name}: n={log.n} events={len(log)} {by} window, every boundary "
              f"BZ-exact, mean ratio {mean} == {base['mean_ratio'][name]}; mean ms_per_round "
              f"{per_round:.3f}, patch_ms {traj.series('patch_ms').mean():.3f}, converge_ms "
              f"{traj.series('converge_ms').mean():.3f}; segment_sum launches {seg} "
              f"({time.perf_counter() - t0:.2f} s)")
        if dev.type == "cuda":
            check(seg > 0, f"temporal gate {name} launched segment_sum")


def temporal_full(torch, dev, g, spr_scale, launches) -> int:
    """Phase 12: a window over SPR's temporal log filled, BZ-checked,
    checkpointed and restored into a fresh engine; the segment sum over the
    fill's staged arcs, kernel against plain; then one slide taken by both
    engines. Returns the largest segment_sum error."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.core import dispatch
    from repro_torch.core.kcore import kcore_decompose
    from repro_torch.kernels.kcore_hindex import ops as hk
    from repro_torch.kernels.segment_sum import ops as sk
    from repro_torch.obs import trace
    from repro_torch.streaming import StreamingConfig
    from repro_torch.temporal import WindowedKCoreEngine, check_step, events

    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    log = events._snap_events(g, seed=0, remove_frac=TEMPORAL["remove_frac"])
    window = max(int(TEMPORAL["window"] * spr_scale), 10)
    stride = max(window // 10, 1)
    config = StreamingConfig(frontier=TEMPORAL["frontier"])
    print(f"  SPR temporal log: n={log.n}, {len(log)} events ({len(log) - log.num_adds} removes), "
          f"made from the phase-6 graph in {time.perf_counter() - t0:.1f} s; count window "
          f"{window} events, stride {stride}, {config.frontier}")
    weng = WindowedKCoreEngine(log, window, stride, config=config, device=dev)
    print(f"  window engine: min_slack {weng.config.min_slack}, CSR capacity "
          f"{weng.engine.csr.capacity}")

    def step(eng, k, label):
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        trace.reset()
        trace.enable()
        hk.launches = sk.launches = 0
        t0 = time.perf_counter()
        ws = eng.advance(k)
        wall = time.perf_counter() - t0
        trace.disable()
        launches["kcore_hindex"] += hk.launches
        launches["segment_sum"] += sk.launches
        diff_s = sum(e["dur"] for e in trace.events() if e["name"] == "window.diff") / 1e6
        trace.reset()
        res, seg, hin = ws.result, sk.launches, hk.launches
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        t0 = time.perf_counter()
        check(check_step(eng, ws), f"{label}: the edge set equals edges_between, the engine "
                                   f"graph the window graph, the cores BZ "
                                   f"({time.perf_counter() - t0:.1f} s)")
        wg = eng.window_graph()
        scratch = kcore_decompose(wg, fused=True, device=dev)
        print(f"    {label}: [{ws.lo}, {ws.hi}) inserted {res.delta.inserted.shape[0]} deleted "
              f"{res.delta.deleted.shape[0]} m {ws.m}; rounds {res.rounds}, messages "
              f"{res.total_messages} ({res.total_messages / max(scratch.stats.total_messages, 1):.4f}"
              f" of a fused scratch run: {scratch.rounds} rounds, {scratch.stats.total_messages} "
              f"messages); patch_s {res.patch_s:.4f} seed_s {res.seed_s:.4f} (stage_s "
              f"{res.stage_s:.4f}) converge_s {res.converge_s:.4f} flag_reads {res.flag_reads}; "
              f"window.diff {diff_s:.4f} s, step wall {wall:.4f} s; compactions "
              f"{res.csr_compactions}, dead {res.csr_dead_frac:.4f}, occupancy "
              f"{res.csr_occupancy:.4f}; seed {res.seed_strategy}, region {res.region_size}; "
              f"segment_sum launches {seg}, kcore_hindex {hin}; peak_bytes {peak}")
        check(res.converged, f"{label}: converged")
        if on_card:
            check(seg > 0, f"{label} launched segment_sum")
        return ws, wg

    fill, wg = step(weng, window // stride, f"fill ({window // stride} strides)")
    # the segment sum over the window graph's staged live arcs, at the hits
    # of a from-scratch round 1's first probe (degree seed)
    csr = weng.engine.csr
    src, dst, row_ptr = dispatch.stage_arcs(csr.src[csr.live], csr.dst[csr.live], log.n, dev)
    deg = torch.as_tensor(wg.deg, dtype=torch.int32, device=dev)
    err = segsum_held(torch, [(f"the fill's window graph, {int((wg.deg > 0).sum())} rows not "
                               f"empty", first_probe_hits(torch, deg, deg.index_select(0, dst),
                                                          src), row_ptr)],
                      "at a window graph's staged arcs")
    del src, dst, row_ptr, deg, wg, fill

    tmp = tempfile.mkdtemp(prefix="kcore_ckpt_")
    try:
        t0 = time.perf_counter()
        path = save_checkpoint(tmp, weng.steps_taken, weng.state_dict())
        save_s = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in Path(path).iterdir())
        t0 = time.perf_counter()
        warm = WindowedKCoreEngine(log, window, stride, config=config, device=dev)
        state, ckpt_step = restore_checkpoint(tmp, warm.state_dict())
        warm.load_state_dict(state)
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"  checkpoint at step {ckpt_step}: {nbytes} bytes, saved in {save_s:.2f} s, restored "
          f"into a fresh window engine in {restore_s:.2f} s")
    check(ckpt_step == weng.steps_taken and np.array_equal(warm.core, weng.core)
          and warm.bounds == weng.bounds, "the restored window holds the checkpointed cores "
                                          "and bounds")
    a, _ = step(weng, 1, "slide 1")
    b, _ = step(warm, 1, "slide 1, warm restart")
    check(same_batch(a.result, b.result) and (a.lo, a.hi, a.m) == (b.lo, b.hi, b.m),
          "warm restart: the next advance equals the uninterrupted window's in cores, per-round "
          "bills and every BatchResult accounting field")
    del warm, state, a, b
    print(f"  phase wall {time.perf_counter() - t_phase:.1f} s")
    del weng, log
    return err


# the serving phases: the gate's readers (benchmarks/serving_mixed.py) and its acceptance floor;
# the served SPR's churn a tick (phase 10's first batch) and the CLI run on the card
P99_WALL_FLOOR_S = 0.05
# one tick under readers before the drain, so the whole smoke keeps inside its 1,200 s
SERVED = {"churn": 0.002, "ticks": 1, "readers": 4, "ids_per_read": 32, "seed": 0}
SERVE_CLI = ("--graph", "EEN", "--scale", "0.05", "--batches", "2", "--queries", "10000",
             "--frontier", "fused", "--concurrent", "2", "--listen", "0", "--verify")


def hammer(front, seed: int, stop, busy, out: dict, ids_per_read: int) -> None:
    """``benchmarks/serving_mixed.py::_reader``: sampled reads of the published
    snapshot until stopped, recording each read's wall, the snapshot's age,
    whether the writer was busy, the read's end on the host clock, and the
    (request, response) pair that is checked after the threads join."""
    import numpy as np

    from repro_torch.streaming import Request

    rng = np.random.default_rng(seed)
    n = front.server.engine.n
    walls, ages, ends, pairs, during = [], [], [], [], 0
    while not stop.is_set():
        p = rng.random()
        v = rng.integers(0, n, size=ids_per_read)
        snap = front.snapshot
        if p < 0.55:
            req = Request(op="core", vertices=v)
        elif p < 0.75:
            req = Request(op="in_kcore", vertices=v, k=max(snap.max_k - 1, 1))
        elif p < 0.9 and len(snap.asof):
            req = Request(op="core_asof", t=float(rng.choice(snap.asof.times)), vertices=v)
        else:
            req = Request(op="members", k=max(snap.max_k, 1))
        resp = front.read(req)
        if busy.is_set():
            during += 1
        walls.append(resp.wall_s)
        ages.append(front.snapshot_age_s())
        ends.append(time.perf_counter())
        pairs.append((req, resp))
    out.update(walls=walls, ages=ages, ends=ends, during=during, pairs=pairs)


def start_readers(front, n_readers: int, ids_per_read: int):
    import threading

    stop, busy = threading.Event(), threading.Event()
    outs = [{} for _ in range(n_readers)]
    threads = [threading.Thread(target=hammer, args=(front, 1000 + i, stop, busy, outs[i],
                                                     ids_per_read), daemon=True)
               for i in range(n_readers)]
    for th in threads:
        th.start()
    return stop, busy, outs, threads


def join_readers(stop, threads) -> bool:
    stop.set()
    for th in threads:
        th.join(timeout=60)
    return not any(th.is_alive() for th in threads)


def verify_reads(pairs, registry) -> tuple[int, int]:
    """``benchmarks/serving_mixed.py::_verify_responses``, after the readers
    joined: every response bit-equal to the registered fixpoint of its
    version (a members answer computed once a version and k). Returns
    (checked, failures); only an as-of miss may fail, as there."""
    import numpy as np

    checked, bad, members = 0, 0, {}
    for req, resp in pairs:
        if not resp.ok:
            bad += req.op != "core_asof"
            continue
        snap = registry.get(resp.version)
        if snap is None:
            bad += 1
            continue
        if req.op == "core":
            ok = np.array_equal(resp.payload, snap.core[np.asarray(req.vertices)])
        elif req.op == "in_kcore":
            ok = np.array_equal(resp.payload, snap.core[np.asarray(req.vertices)] >= req.k)
        elif req.op == "members":
            key = (resp.version, req.k)
            if key not in members:
                members[key] = np.flatnonzero(snap.core >= req.k)
            ok = np.array_equal(resp.payload, members[key])
        else:
            bt, core = snap.asof.asof(req.t)
            ok = resp.payload[0] == bt and np.array_equal(resp.payload[1],
                                                          core[np.asarray(req.vertices)])
        checked += 1
        bad += not ok
    return checked, bad


def reader_summary(outs) -> dict:
    import numpy as np

    walls = np.concatenate([np.asarray(o.get("walls", ()), float) for o in outs])
    ages = np.concatenate([np.asarray(o.get("ages", ()), float) for o in outs])
    return {"reads": int(walls.size), "during": int(sum(o.get("during", 0) for o in outs)),
            "p50_ms": float(np.percentile(walls, 50)) * 1e3 if walls.size else 0.0,
            "p99_ms": float(np.percentile(walls, 99)) * 1e3 if walls.size else 0.0,
            "stale_ms_max": float(ages.max()) * 1e3 if ages.size else 0.0,
            "ends": [t for o in outs for t in o.get("ends", ())],
            "pairs": [p for o in outs for p in o.get("pairs", ())]}


def serving_gate(torch, dev, launches) -> None:
    """Phase 17: ``benchmarks/serving_baseline.json``'s ``mixed`` ratio at its
    settings (``benchmarks/serving_mixed.py::run_records`` and ``summarize``):
    one writer replays the EEN trace through the windowed server while the
    benchmark's readers hammer the published snapshot; every read checked
    against its version's fixpoint after the readers join, and the
    benchmark's acceptance check on the read p99."""
    import numpy as np

    from repro_torch.core.bz import bz_core_numbers
    from repro_torch.core.kcore import kcore_decompose
    from repro_torch.graph import generators
    from repro_torch.kernels.kcore_hindex import ops as hk
    from repro_torch.kernels.segment_sum import ops as sk
    from repro_torch.streaming import ConcurrentKCoreServer, KCoreServer, StreamingConfig
    from repro_torch.temporal import WindowedKCoreEngine, temporal_snap_analogue

    t_phase = time.perf_counter()
    base = json.loads((ROOT / "benchmarks" / "serving_baseline.json").read_text())
    cfg = base["settings"]
    print(f"  settings {cfg}")
    log = temporal_snap_analogue(cfg["trace"], scale=cfg["target_n"]
                                 / generators.SNAP_BY_ABBREV[cfg["trace"]].n, seed=0,
                                 remove_frac=cfg["snap_remove_frac"])
    stride = max(len(log) // (cfg["ticks"] + 2), 1)
    weng = WindowedKCoreEngine(log, cfg["window_strides"] * stride, stride, by="count",
                               config=StreamingConfig(frontier=cfg["frontier"]), device=dev)
    front = ConcurrentKCoreServer(KCoreServer(windowed=weng, asof_capacity=cfg["ticks"] + 2),
                                  read_workers=cfg["readers"])
    registry = {front.snapshot.version: front.snapshot}
    stop, busy, outs, threads = start_readers(front, cfg["readers"], cfg["ids_per_read"])
    ratios, walls, bz_ok, seg, tick = [], [], True, 0, 0
    try:
        while not weng.done and tick < cfg["ticks"]:
            hk.launches = sk.launches = 0
            t0 = time.perf_counter()
            busy.set()
            ws = front.advance_window()
            busy.clear()
            walls.append(time.perf_counter() - t0)
            launches["kcore_hindex"] += hk.launches
            launches["segment_sum"] += sk.launches
            seg += sk.launches
            snap = front.snapshot
            registry[snap.version] = snap
            scratch = kcore_decompose(weng.window_graph(), device=dev)
            ratios.append(round(ws.result.total_messages
                                / max(scratch.stats.total_messages, 1), 4))
            if tick % cfg["verify_every"] == 0:
                bz_ok = bz_ok and bool((snap.core == bz_core_numbers(weng.window_graph())).all())
            print(f"    tick {tick}: m {ws.m}, {ws.result.rounds} rounds, "
                  f"{ws.result.total_messages} messages, ratio {ratios[-1]}, update "
                  f"{walls[-1] * 1e3:.2f} ms, version {snap.version}")
            tick += 1
    finally:
        joined = join_readers(stop, threads)
    rs = reader_summary(outs)
    checked, bad = verify_reads(rs["pairs"], registry)
    mean_update_s = sum(walls) / max(len(walls), 1)
    mixed = round(float(np.mean(ratios)), 4)
    print(f"  reads {rs['reads']} ({rs['during']} during re-convergence), p50 "
          f"{rs['p50_ms']:.4f} ms, p99 {rs['p99_ms']:.4f} ms, longest stale window "
          f"{rs['stale_ms_max']:.2f} ms; mean update {mean_update_s * 1e3:.2f} ms; flips "
          f"{front.box.flips}; segment_sum launches {seg}")
    check(joined and bz_ok and tick == cfg["ticks"] and mixed == base["mean_ratio"]["mixed"],
          f"serving gate mixed: every checked tick BZ-exact, mean ratio {mixed} == "
          f"{base['mean_ratio']['mixed']}")
    check(checked > 0 and bad == 0, f"serving gate: {checked} reads bit-equal to the registered "
                                    f"fixpoint of their version (checked after the join)")
    check(rs["p99_ms"] / 1e3 < max(mean_update_s, P99_WALL_FLOOR_S),
          f"serving gate: read p99 {rs['p99_ms']:.4f} ms below max(mean update wall, "
          f"{P99_WALL_FLOOR_S} s)")
    if dev.type == "cuda":
        check(seg > 0, "serving gate launched segment_sum")
    front.drain(save=False)
    print(f"  phase wall {time.perf_counter() - t_phase:.1f} s")


def http_get(url: str):
    """(status, body, wall) of one GET; an HTTP error's status and body."""
    import urllib.error
    import urllib.request

    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, resp.read(), time.perf_counter() - t0
    except urllib.error.HTTPError as err:
        return err.code, err.read(), time.perf_counter() - t0


def serving_full(torch, dev, g, core_bz, smi, launches) -> int:
    """Phase 18: SPR served at full size. A static server on the card behind
    the concurrent front end and the HTTP endpoint; per tick a churn batch
    applied by a writer thread while 4 readers hammer the snapshot and the
    main thread polls the HTTP routes; the snapshot BZ-checked and every
    read checked against its version after each tick; then a drain to a
    checkpoint, a restore into a fresh server, and one more tick on both.
    Returns the largest segment_sum error on the served live arcs."""
    import shutil
    import tempfile
    import threading

    import numpy as np

    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.core import dispatch
    from repro_torch.core.bz import bz_core_numbers
    from repro_torch.core.kcore import kcore_decompose
    from repro_torch.graph.structs import Graph
    from repro_torch.kernels.kcore_hindex import ops as hk
    from repro_torch.kernels.segment_sum import ops as sk
    from repro_torch.launch.kcore_serve import _tick_rng
    from repro_torch.obs.http import start_server
    from repro_torch.streaming import (ConcurrentKCoreServer, KCoreServer, Request,
                                       StreamingConfig, random_churn_batch)

    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    config = StreamingConfig(frontier="fused")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    hk.launches = sk.launches = 0
    t0 = time.perf_counter()
    server = KCoreServer(g, config, device=dev)
    init_s = time.perf_counter() - t0
    launches["kcore_hindex"] += hk.launches
    launches["segment_sum"] += sk.launches
    seen = {"kcore_hindex": hk.launches, "segment_sum": sk.launches}
    check(np.array_equal(server.core, core_bz), "served SPR: the initial cores equal BZ")
    tmp = tempfile.mkdtemp(prefix="kcore_serve_ckpt_")
    front = ConcurrentKCoreServer(server, read_workers=SERVED["readers"], checkpoint_dir=tmp)
    httpd = start_server(port=0)
    httpd.add_registry(server.metrics)
    httpd.attach_query_backend(front)
    flips = []
    flip = front._flip

    def timed_flip():
        t = time.perf_counter()
        snap = flip()
        flips.append(time.perf_counter() - t)
        return snap

    front._flip = timed_flip
    print(f"  server on SPR (n={g.n}, m={g.m}) with its initial decomposition in {init_s:.2f} s "
          f"(launches kcore_hindex {hk.launches}, segment_sum {sk.launches}); HTTP on "
          f"{httpd.url}")
    registry = {front.snapshot.version: front.snapshot}
    err, http_walls, http_pairs = 0, [], []
    try:
        for tick in range(SERVED["ticks"]):
            rng = _tick_rng(SERVED["seed"], tick)
            b = max(2, int(SERVED["churn"] * server.engine.m))
            batch = random_churn_batch(server.engine.graph, b // 2, b - b // 2, rng)
            qrng = np.random.default_rng(tick)
            stop, busy, outs, threads = start_readers(front, SERVED["readers"],
                                                      SERVED["ids_per_read"])
            box = {}

            def write():
                box["res"] = front.update(batch)

            hk.launches = sk.launches = 0
            writer = threading.Thread(target=write, daemon=True)
            t0 = time.perf_counter()
            busy.set()
            writer.start()
            codes = set()
            while True:
                v = qrng.integers(0, g.n, 8)
                code, body, wall = http_get(f"{httpd.url}/query/core?v="
                                            f"{','.join(map(str, v.tolist()))}")
                codes.add(code)
                http_walls.append(wall)
                http_pairs.append((v, json.loads(body)))
                for route in ("/query/stats", "/metrics", "/healthz"):
                    codes.add(http_get(httpd.url + route)[0])
                if not writer.is_alive():
                    break
            writer.join()
            busy.clear()
            wall = time.perf_counter() - t0
            joined = join_readers(stop, threads)
            tick_launches = {"kcore_hindex": hk.launches, "segment_sum": sk.launches}
            for k, c in tick_launches.items():
                launches[k] += c
                seen[k] += c
            res = box["res"]
            old_version = front.snapshot.version - 1
            snap = front.snapshot
            registry[snap.version] = snap
            t1 = time.perf_counter()
            cur = server.engine.graph
            bz_ok = bool((snap.core == bz_core_numbers(cur)).all())
            t_bz = time.perf_counter() - t1
            scratch = kcore_decompose(cur, fused=True, device=dev)
            rs = reader_summary(outs)
            checked, bad = verify_reads(rs["pairs"], registry)
            # the longest a reader was still answered from the previous
            # fixpoint after the writer had begun the batch
            stale_s = max((t - t0 for t, (_, resp) in zip(rs["ends"], rs["pairs"])
                           if resp.version == old_version and t > t0), default=0.0)
            hbad = sum(not (out.get("ok") and out["payload"]
                            == registry[out["version"]].core[v].tolist())
                       for v, out in http_pairs)
            print(f"    tick {tick}: {b} edges asked ({batch.insert.shape[0]} inserts, "
                  f"{batch.delete.shape[0]} deletes), m {cur.m}; update wall {wall:.4f} s = "
                  f"patch_s {res.patch_s:.4f} + seed_s {res.seed_s:.4f} (stage_s "
                  f"{res.stage_s:.4f}) + converge_s {res.converge_s:.4f} + the rest; "
                  f"{res.rounds} rounds, {res.total_messages} messages "
                  f"({res.total_messages / max(scratch.stats.total_messages, 1):.4f} of a fused "
                  f"scratch run: {scratch.rounds} rounds, {scratch.stats.total_messages}); "
                  f"flip {flips[-1] * 1e3:.3f} ms; reads {rs['reads']} ({rs['during']} during "
                  f"re-convergence), p50 {rs['p50_ms']:.4f} ms, p99 {rs['p99_ms']:.4f} ms, "
                  f"longest stale read {stale_s * 1e3:.1f} ms after the writer began; HTTP "
                  f"polls {len(http_pairs)}; BZ {t_bz:.1f} s; the server's launches "
                  f"segment_sum {tick_launches['segment_sum']}, kcore_hindex "
                  f"{tick_launches['kcore_hindex']}")
            check(joined and bz_ok and res.converged,
                  f"served SPR tick {tick}: the published snapshot equals BZ")
            check(checked == rs["reads"] > 0 and bad == 0 and hbad == 0,
                  f"served SPR tick {tick}: {checked} reads and {len(http_pairs)} HTTP reads "
                  f"bit-equal to their version's snapshot")
            check(rs["during"] > 0, f"served SPR tick {tick}: {rs['during']} reads completed "
                                    f"during re-convergence")
            check(codes == {200}, f"served SPR tick {tick}: /query/core, /query/stats, /metrics "
                                  f"and /healthz answered 200 ({sorted(codes)})")
            if on_card:
                check(tick_launches["segment_sum"] > 0,
                      f"served SPR tick {tick} launched segment_sum")
            http_pairs.clear()
        # idle reads: one reader, the writer idle
        idle = np.asarray([front.read(Request(op="core", vertices=np.arange(i, i + 32))).wall_s
                           for i in range(2000)]) * 1e3
        t0 = time.perf_counter()
        path = front.drain(step=SERVED["ticks"])
        save_s = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in Path(path).iterdir())
        code_drained = http_get(f"{httpd.url}/query/max_k")[0]
        t0 = time.perf_counter()
        fresh = KCoreServer(Graph.from_edges(np.zeros((0, 2), np.int64), n=g.n), config,
                            device=dev)
        state, step = restore_checkpoint(tmp, like=fresh.state_dict())
        fresh.load_state_dict(state)
        restore_s = time.perf_counter() - t0
    finally:
        httpd.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"  idle reads (one reader, no writer): p50 {np.percentile(idle, 50):.4f} ms, p99 "
          f"{np.percentile(idle, 99):.4f} ms; HTTP /query/core p50 "
          f"{np.percentile(http_walls, 50) * 1e3:.3f} ms over {len(http_walls)} polls")
    print(f"  drain to a checkpoint at step {step}: {nbytes} bytes, {save_s:.2f} s; restored into "
          f"a fresh server (built on an empty graph, so no decomposition of SPR) in "
          f"{restore_s:.2f} s; a read after the drain answered {code_drained}")
    check(code_drained == 503, "served SPR: a drained front end answers 503")
    check(np.array_equal(fresh.core, server.core) and fresh.engine.m == server.engine.m,
          "served SPR: the restored server holds the drained cores and graph")
    rng = _tick_rng(SERVED["seed"], SERVED["ticks"])
    b = max(2, int(SERVED["churn"] * server.engine.m))
    batch = random_churn_batch(server.engine.graph, b // 2, b - b // 2, rng)
    hk.launches = sk.launches = 0
    t0 = time.perf_counter()
    a = server.update(batch)
    wall_a = time.perf_counter() - t0
    seg_a = sk.launches
    launches["kcore_hindex"] += hk.launches
    launches["segment_sum"] += seg_a
    seen["segment_sum"] += seg_a
    t0 = time.perf_counter()
    c = fresh.update(batch)
    wall_c = time.perf_counter() - t0
    cur = server.engine.graph
    check(same_batch(a, c) and np.array_equal(a.core, bz_core_numbers(cur)),
          f"served SPR tick {SERVED['ticks']}: the restored server equals the uninterrupted one "
          f"in cores, per-round bills and every BatchResult accounting field, and BZ "
          f"({a.rounds} rounds, {a.total_messages} messages, {seg_a} segment_sum "
          f"launches; no readers: update wall {wall_a:.4f} / {wall_c:.4f} s = patch_s "
          f"{a.patch_s:.4f} / {c.patch_s:.4f} + seed_s {a.seed_s:.4f} / {c.seed_s:.4f} + "
          f"converge_s {a.converge_s:.4f} / {c.converge_s:.4f} + the rest)")
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    # the segment sum over the served graph's live arcs at the degree seed
    csr = server.engine.csr
    src, dst, row_ptr = dispatch.stage_arcs(csr.src[csr.live], csr.dst[csr.live], csr.n, dev)
    deg = torch.as_tensor(csr.deg, dtype=torch.int32, device=dev)
    err = segsum_held(torch, [(f"the served graph after tick {SERVED['ticks']}",
                               first_probe_hits(torch, deg, deg.index_select(0, dst), src),
                               row_ptr)], "at the served graph's live arcs")
    print(f"  {smi}: init {init_s:.2f} s; flips {', '.join(f'{x * 1e3:.3f}' for x in flips)} "
          f"ms; peak_bytes {peak}; the server's launches in this phase kcore_hindex "
          f"{seen['kcore_hindex']}, segment_sum {seen['segment_sum']}; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s")
    del server, fresh, front, src, dst, row_ptr, deg
    return err


def serve_cli(dev) -> None:
    """Phase 19: ``repro_torch.launch.kcore_serve`` in a subprocess on the card."""
    import os
    import subprocess

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    argv = [sys.executable, "-m", "repro_torch.launch.kcore_serve", *SERVE_CLI,
            "--trace", str(TRACE_DIR / "kcore_serve.json")]
    if dev.type != "cuda":
        argv += ["--device", "cpu"]
    t0 = time.perf_counter()
    out = subprocess.run(argv, capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    wall = time.perf_counter() - t0
    lines = out.stdout.splitlines()
    for line in lines:
        if not line.startswith("# final_stats="):
            print(f"    {line}")
    cols = next((line.split(",") for line in lines if line.startswith("tick,")), [])
    rows = [dict(zip(cols, line.split(","))) for line in lines if line[:1].isdigit()]
    check(out.returncode == 0 and len(rows) == 2 and all(r["verified"] == "True" for r in rows),
          f"kcore_serve {' '.join(SERVE_CLI)}: exit {out.returncode}, {len(rows)} ticks, every "
          f"one verified ({wall:.1f} s){'' if out.returncode == 0 else ': ' + out.stderr[-2000:]}")


# the out-of-core phase: the scale benchmark's headline configuration
# (benchmarks/scale_decomposition.py:55-60: LJ1 at a 10^6-vertex target under a 64 MiB
# budget), SPR at scale 1.0 under 256 MiB (its 64 MiB plan pads 1,024 blocks to a 3.34M-slot
# A), and the CLI on the card
OOC_LJ1 = {"abbrev": "LJ1", "vertices": 1_000_000, "mem_budget": 64 << 20}
OOC_SPR_BUDGET = 256 << 20
# SPR out of core stops after this many of its 50 rounds (1.8-2.6 s each; LJ1 runs its 36 to
# convergence, still checked against BZ); its estimates and bills are held against an in-memory
# fused run stopped there, and against the first rounds of phase 6's converged run
OOC_ROUNDS = 5
OOC_CLI = ("--graph", "FC", "--scale", "0.05", "--out-of-core", "--mem-budget", "4194304",
           "--json")


def ooc_round_split(torch, dev, store, deg, mem_budget):
    """Round 1 of an out-of-core run once more, block by block, the card
    synchronised between the parts: host materialisation (``BlockCache.get``),
    the host-to-device copies, the superstep with its receivers on the card.
    Returns the three walls summed over the blocks, and the widest block's
    first-probe hit counts with its row offsets."""
    import numpy as np

    from repro_torch.core import outofcore as ooc
    from repro_torch.core.kcore import _bs_iters
    from repro_torch.graph.blockstore import BlockCache

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    cache = BlockCache(store, budget_bytes=mem_budget)
    deg_pad = np.zeros(store.n_pad, np.int32)
    deg_pad[:store.n] = deg
    est = torch.tensor(deg_pad, device=dev)
    active = est > 0
    recv = torch.zeros(store.n_pad + 1, dtype=torch.bool, device=dev)
    n_iters = _bs_iters(int(deg_pad.max()))
    live = active.view(store.n_blocks, store.V).any(1).cpu().numpy()
    widest = int(np.argmax(store.arcs_per_block))
    walls, held = {"get": 0.0, "copy": 0.0, "superstep": 0.0}, None
    sync()
    for b in np.flatnonzero(live):
        lo = int(b) * store.V
        t0 = time.perf_counter()
        blk = cache.get(int(b))
        t1 = time.perf_counter()
        src_e, dst_e, mask_e = ooc.ship_block(blk, ooc._bucket(int(store.arcs_per_block[b]),
                                                               store.A), dev)
        sync()
        t2 = time.perf_counter()
        row_off = ooc.block_row_offsets(src_e, store.V)
        _new, ch_u = ooc.block_superstep(est, active, lo, store.V, src_e, dst_e, mask_e, row_off,
                                         n_iters)
        ooc.mark_receivers(recv, ch_u, src_e, dst_e, mask_e)
        sync()
        t3 = time.perf_counter()
        walls["get"] += t1 - t0
        walls["copy"] += t2 - t1
        walls["superstep"] += t3 - t2
        if b == widest:
            halo = torch.where(mask_e, est.index_select(0, dst_e), 0)
            held = (f"the widest block's shipped slice (block {b}, a_eff {src_e.numel()})",
                    first_probe_hits(torch, est[lo:lo + store.V], halo, src_e), row_off)
    return walls, int(live.sum()), held


def ooc_run(torch, dev, label, g, core_bz, inmem, mem_budget, launches,
            max_rounds: int | None = None) -> int:
    """One full-size out-of-core run on the card: cores against BZ, rounds and
    bills against the in-memory fused run ``inmem``, the I/O bill, the card's
    measured peak against the arc arrays' bytes, then a round split and
    ``segment_sum`` held on the widest block's slice. With ``max_rounds`` the
    run stops there: its estimates and bills are held against an in-memory
    fused run stopped at the same round, and its bills against the first
    rounds of the converged run ``inmem``. Returns its error."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.core.outofcore import outofcore_decompose
    from repro_torch.graph.blockstore import BlockStore
    from repro_torch.kernels.kcore_hindex import ops as hk
    from repro_torch.kernels.segment_sum import ops as sk

    on_card = dev.type == "cuda"
    tmp = tempfile.mkdtemp(prefix="ooc_", dir=ROOT / "build")
    try:
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() if on_card else 0
        hk.launches = sk.launches = 0
        t0 = time.perf_counter()
        res = outofcore_decompose(g, mem_budget=mem_budget, max_rounds=max_rounds,
                                  store_dir=tmp, keep_store=True, device=dev)
        wall = time.perf_counter() - t0
        launches["segment_sum"] += sk.launches
        launches["kcore_hindex"] += hk.launches
        peak = torch.cuda.max_memory_allocated() - base if on_card else 0
        st = res.block_stats
        conv = res.phase_s["converge"]
        print(f"  {label}: n={g.n} m={g.m} arcs={g.num_arcs} max_deg={g.max_deg}, budget "
              f"{mem_budget}: n_blocks {st.n_blocks}, V {st.V}, A {st.A}, device_block_bytes "
              f"{st.device_block_bytes}, total_arc_bytes {st.total_arc_bytes}, device_frac "
              f"{st.device_block_bytes / st.total_arc_bytes:.4f}, measured device peak {peak} "
              f"({peak / st.total_arc_bytes:.4f} of the arc bytes), imbalance {st.imbalance:.3f}")
        print(f"    loads {st.blocks_loaded}, hits {st.cache_hits}, skips {st.blocks_skipped} "
              f"(skip rate {st.skip_rate:.4f}), block rounds {st.block_rounds}, evictions "
              f"{st.evictions}, cache_peak_bytes {st.cache_peak_bytes}, peak_rss_bytes "
              f"{st.peak_rss_bytes}; rounds {res.rounds}, messages {res.stats.total_messages}, "
              f"ms_per_round {st.ms_per_round:.3f}, converge {conv:.3f} s, wall {wall:.3f} s "
              f"(store written and set up in {wall - conv:.3f} s); launches segment_sum "
              f"{sk.launches}, kcore_hindex {hk.launches}")
        print(f"    in-memory fused run: {inmem.rounds} rounds, {inmem.stats.total_messages} "
              f"messages, phase_s {({k: round(v, 4) for k, v in inmem.phase_s.items()})}")
        if max_rounds is None:
            check(np.array_equal(res.core, core_bz) and res.converged,
                  f"{label} out of core: cores equal BZ")
            check(np.array_equal(res.core, inmem.core) and same_bills(res, inmem),
                  f"{label} out of core: cores, rounds and per-round bills equal the in-memory "
                  f"fused run's")
        else:
            from repro_torch.core.kcore import KCoreConfig, kcore_decompose

            t0 = time.perf_counter()
            cut = kcore_decompose(g, KCoreConfig(max_rounds=max_rounds), fused=True, device=dev)
            print(f"    in-memory fused run stopped at round {max_rounds} in "
                  f"{time.perf_counter() - t0:.1f} s; the converged run took {inmem.rounds} rounds")
            check(res.rounds == cut.rounds == max_rounds and not res.converged
                  and np.array_equal(res.core, cut.core) and same_bills(res, cut),
                  f"{label} out of core stopped at round {max_rounds} of {inmem.rounds}: "
                  f"estimates and per-round bills equal an in-memory fused run stopped there")
            check(all(np.array_equal(getattr(res.stats, k), getattr(inmem.stats, k)
                                     [:len(getattr(res.stats, k))]) for k in STATS),
                  f"{label} out of core: its {max_rounds} rounds' bills equal the first rounds of "
                  f"the converged in-memory run")
        check(st.evictions >= 1 and st.device_block_bytes < st.total_arc_bytes,
              f"{label} out of core: {st.evictions} evictions, device_block_bytes "
              f"{st.device_block_bytes} < total_arc_bytes {st.total_arc_bytes}")
        if on_card:
            check(0 < peak < st.total_arc_bytes,
                  f"{label} out of core: the card's measured peak {peak} < total_arc_bytes "
                  f"{st.total_arc_bytes}")
            check(sk.launches > 0 and res.dispatch == "kernel",
                  f"{label} out of core launched segment_sum")
        (store_dir,) = Path(tmp).iterdir()
        store = BlockStore.open(store_dir / "store")
        walls, hit, held = ooc_round_split(torch, dev, store, g.deg, mem_budget)
        total = sum(walls.values())
        print(f"    round 1 again, {hit} blocks, synchronised between the parts: "
              + ", ".join(f"{k} {v:.3f} s ({v / total:.1%})" for k, v in walls.items())
              + f"; {total * 1e3 / hit:.3f} ms a block")
        return segsum_held(torch, [held], f"out of core, {label}") if held else 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def out_of_core_full(torch, dev, g_spr, core_spr, spr_fused, spr_scale, launches) -> int:
    """Phase 20: LJ1 at the scale benchmark's headline configuration and SPR
    out of core on the card, then ``kcore_run --out-of-core`` in a subprocess.
    Returns the largest segment_sum error."""
    import os
    import subprocess

    from repro_torch.core.bz import bz_core_numbers
    from repro_torch.core.kcore import kcore_decompose
    from repro_torch.graph import generators
    from repro_torch.kernels.kcore_hindex import ops as hk
    from repro_torch.kernels.segment_sum import ops as sk

    t_phase = time.perf_counter()
    small = dev.type != "cuda"     # the CPU rehearsal cuts sizes and budgets by spr_scale
    cut = spr_scale if small else 1.0
    entry = generators.SNAP_BY_ABBREV[OOC_LJ1["abbrev"]]
    t0 = time.perf_counter()
    g = generators.snap_analogue(OOC_LJ1["abbrev"], OOC_LJ1["vertices"] * cut / entry.n, seed=0)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    core_bz = bz_core_numbers(g)
    t_bz = time.perf_counter() - t0
    hk.launches = sk.launches = 0
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
    fused = kcore_decompose(g, fused=True, device=dev)
    peak = torch.cuda.max_memory_allocated() - base if dev.type == "cuda" else 0
    launches["segment_sum"] += sk.launches
    launches["kcore_hindex"] += hk.launches
    print(f"  LJ1 analogue at scale {OOC_LJ1['vertices'] * cut / entry.n:.6f}: generated in "
          f"{t_gen:.1f} s, BZ in {t_bz:.1f} s; in-memory fused run {fused.rounds} rounds, device "
          f"peak {peak}, launches kcore_hindex {hk.launches}, segment_sum {sk.launches}")
    check(fused.converged and (fused.core == core_bz).all(),
          "LJ1 in memory (fused): cores equal BZ")
    err = ooc_run(torch, dev, "LJ1", g, core_bz, fused, int(OOC_LJ1["mem_budget"] * cut), launches)
    del g, core_bz, fused
    err = max(err, ooc_run(torch, dev, "SPR", g_spr, core_spr, spr_fused,
                           int(OOC_SPR_BUDGET * cut), launches, max_rounds=OOC_ROUNDS))

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    argv = [sys.executable, "-m", "repro_torch.launch.kcore_run", *OOC_CLI]
    if small:
        argv += ["--device", "cpu"]
    t0 = time.perf_counter()
    out = subprocess.run(argv, capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    wall = time.perf_counter() - t0
    text = out.stdout
    report = json.loads(text[text.index("{"):text.rindex("}") + 1]) if "{" in text else {}
    block = report.get("out_of_core", {})
    print(f"    kcore_run {' '.join(OOC_CLI)}: rounds {report.get('rounds')}, n_blocks "
          f"{block.get('n_blocks')}, device {report.get('device')}, dispatch "
          f"{report.get('dispatch')}, wall_s {report.get('wall_s')} ({wall:.1f} s with start-up)")
    check(out.returncode == 0 and report.get("correct_vs_BZ") is True and bool(block)
          and report.get("dispatch") == ("torch" if small else "kernel"),
          f"kcore_run {' '.join(OOC_CLI)}: exit {out.returncode}, correct_vs_BZ, an out_of_core "
          f"block{'' if out.returncode == 0 else ': ' + out.stderr[-2000:]}")
    print(f"  phase wall {time.perf_counter() - t_phase:.1f} s")
    return err


# the sharded phase: the paper's distributed model on a 4-shard mesh of one card; two gloo
# processes of 2 shards each; the CLIs with --mesh 2
SHARDS = 4
RANKS = 2
SHARDED_CLI_RUN = ("--graph", "FC", "--scale", "0.05", "--mesh", "2", "--fused", "--json")
SHARDED_CLI_SERVE = ("--graph", "EEN", "--scale", "0.05", "--mesh", "2", "--frontier", "sharded",
                     "--batches", "2", "--queries", "10000", "--verify")
# one rank of the two-process run: EEN at 0.05 on a 4-shard global mesh, fused; the host loop
# must refuse the mesh; prints its device, launches and bills
RANK_SCRIPT = r"""
import json, sys, time
from repro_torch.distribution import compat
rank, nproc, port, device = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
compat.init_multiprocess(f"127.0.0.1:{port}", nproc, rank, timeout_s=120)
from repro_torch.core.kcore import kcore_decompose_sharded
from repro_torch.graph import generators
from repro_torch.kernels.segment_sum import ops as sk
mesh = compat.global_mesh("shard", local_shards=2, device=device)
g = generators.snap_analogue("EEN", 0.05, seed=0)
try:
    kcore_decompose_sharded(g, mesh, ("shard",))
    refused = False
except ValueError:
    refused = True
sk.launches = 0
t0 = time.perf_counter()
res = kcore_decompose_sharded(g, mesh, ("shard",), fused=True)
print(json.dumps({"rank": rank, "device": str(mesh.device), "shards": mesh.size,
                  "local_shards": mesh.local_shards, "refused": refused, "launches": sk.launches,
                  "wall_s": time.perf_counter() - t0, "phase_s": res.phase_s,
                  "rounds": res.rounds, "core": res.core.tolist(),
                  "stats": [getattr(res.stats, k).tolist() for k in
                            ("messages_per_round", "active_per_round", "changed_per_round")]}))
"""


def two_ranks(dev, g_een, want, launches) -> None:
    """Phase 21, part 4: two gloo processes on the card, 2 shards each."""
    import os
    import socket
    import subprocess

    import numpy as np

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", RANK_SCRIPT, str(r), str(RANKS), str(port),
                               dev.type], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=ROOT) for r in range(RANKS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    except subprocess.TimeoutExpired:
        outs = [("", "timed out")] * RANKS
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        rep = json.loads(out.strip().splitlines()[-1]) if p.returncode == 0 and out.strip() else {}
        bills = [getattr(want.stats, k).tolist() for k in STATS]
        print(f"    rank {rank}: exit {p.returncode}, device {rep.get('device')}, "
              f"{rep.get('local_shards')} of {rep.get('shards')} shards, rounds {rep.get('rounds')},"
              f" wall_s {rep.get('wall_s')}, phase_s {rep.get('phase_s')}, launches segment_sum "
              f"{rep.get('launches')}")
        check(p.returncode == 0 and rep.get("refused") is True,
              f"rank {rank}: the host loop refuses the multi-process mesh"
              f"{'' if p.returncode == 0 else ': ' + err[-2000:]}")
        launches["segment_sum"] += rep.get("launches", 0)
        check(rep.get("rounds") == want.rounds and np.array_equal(rep.get("core", []), want.core)
              and rep.get("stats") == bills,
              f"rank {rank}: EEN at 0.05 on {RANKS} processes equals the single-process run in "
              f"cores, rounds and per-round bills (n={g_een.n})")
        if dev.type == "cuda":
            check(rep.get("device", "").startswith("cuda") and rep.get("launches", 0) > 0,
                  f"rank {rank} ran on the card and launched segment_sum")
    print(f"    {RANKS} processes, {wall:.1f} s with start-up (time limit 240 s)")


def cli_json(argv: list, small: bool):
    """A CLI of the port in a subprocess: ``(exit code, stdout, stderr, wall)``."""
    import os
    import subprocess

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", *argv, *(["--device", "cpu"] if small else [])],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    return out.returncode, out.stdout, out.stderr, time.perf_counter() - t0


def sharded_full(torch, dev, g, core_bz, spr_fused, stream_first, spr_scale, launches) -> int:
    """Phase 21: the sharded and multi-process paths. Returns the largest
    segment_sum error."""
    import numpy as np

    from repro_torch.core import dispatch
    from repro_torch.core.kcore import _bs_iters, kcore_decompose_sharded
    from repro_torch.distribution.compat import make_mesh
    from repro_torch.graph import generators
    from repro_torch.graph.partition import balance_report, shard_graph
    from repro_torch.kernels.segment_sum import ops as sk
    from repro_torch.launch import kcore_run
    from repro_torch.streaming import StreamingConfig, StreamingKCoreEngine

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    mesh = make_mesh((SHARDS,), ("data",), device=dev)

    # 1. SPR through kcore_run's entry point with --mesh, host loop then --fused
    t0 = time.perf_counter()
    sg = shard_graph(g, SHARDS)
    t_shard = time.perf_counter() - t0
    bal = balance_report(sg)
    padded = sg.src.nbytes + sg.dst.nbytes + sg.arc_mask.nbytes
    print(f"  SPR on {SHARDS} shards: shard_graph {t_shard:.2f} s; V {sg.verts_per_shard}, A "
          f"{sg.arcs_per_shard}, balance {bal}; padded arc blocks {padded} bytes for "
          f"{g.num_arcs} arcs ({SHARDS * sg.arcs_per_shard / max(g.num_arcs, 1):.3f} slots an arc)")
    n_iters = _bs_iters(g.max_deg)
    for label, extra in [("host loop", []), ("fused", ["--fused"])]:
        args = kcore_run.parse_args(["--graph", "SPR", "--scale", str(spr_scale), "--device",
                                     dev.type, "--json", "--mesh", str(SHARDS), *extra])
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        sk.launches = 0
        report, res = kcore_run.decompose_report(g, args, core_ref=core_bz)
        launches["segment_sum"] += sk.launches
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        conv_s = res.phase_s.get("device-converge", res.phase_s.get("converge", 0.0))
        print(f"  --mesh {SHARDS} {label}: rounds={report['rounds']} total_messages="
              f"{report['total_messages']} mesh={report['mesh']} wall_s={report['wall_s']} "
              f"phase_s={report['phase_s']} ms/round={conv_s * 1e3 / max(res.rounds, 1):.3f} "
              f"peak_bytes={peak} launches: segment_sum {sk.launches} ({n_iters + 1} a round "
              f"stacked: {(n_iters + 1) * res.rounds})")
        check(report["correct_vs_BZ"] and report["converged"] and report["mesh"] == SHARDS,
              f"SPR --mesh {SHARDS} {label}: cores equal BZ")
        check(same_bills(res, spr_fused),
              f"SPR --mesh {SHARDS} {label}: rounds and every per-round bill equal phase 6's fused "
              f"run")
        if on_card:
            check(sk.launches > 0, f"SPR --mesh {SHARDS} {label} launched segment_sum")
    # segment_sum on the widest shard's staged slice: round 1's first probe from the degrees
    st = dispatch.stage_shards(sg, mesh, ("data",))
    d = int(np.argmax(sg.arc_mask.sum(axis=1)))
    V, A = sg.verts_per_shard, sg.arcs_per_shard
    est = st.deg
    est_dst = torch.where(st.arc_mask[d * A:(d + 1) * A],
                          est.index_select(0, st.dst[d * A:(d + 1) * A]), 0)
    ptr = st.row_ptr[d * V:(d + 1) * V + 1] - d * A
    hits = first_probe_hits(torch, est[d * V:(d + 1) * V], est_dst, st.src[d * A:(d + 1) * A] - d * V)
    err = segsum_held(torch, [(f"shard {d}, the widest", hits, ptr)],
                      "at the widest shard's staged slice")
    del st, est_dst, ptr, hits, sg

    # 3. SPR stream batch 0 (phase 10's) in sharded and fused_sharded on the mesh
    state, batch, dense = stream_first
    for frontier in ("sharded", "fused"):
        eng = StreamingKCoreEngine.from_state_dict(state, StreamingConfig(frontier=frontier),
                                                   mesh=mesh)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        sk.launches = 0
        res = eng.apply_batch(batch)
        launches["segment_sum"] += sk.launches
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        print(f"    {frontier:8} ran {res.mode:13} patch_s {res.patch_s:.4f} seed_s "
              f"{res.seed_s:.4f} converge_s {res.converge_s:.4f} reconstruct_s "
              f"{res.reconstruct_s:.4f}; rounds {res.rounds}, messages {res.total_messages}; "
              f"shard_A_floor {eng.state_dict()['shard_A_floor']}; launches segment_sum "
              f"{sk.launches}; peak_bytes {peak}")
        check(res.mode == ("sharded" if frontier == "sharded" else "fused_sharded")
              and same_batch(res, dense, skip=("mode",)),
              f"SPR stream batch 0 on {SHARDS} shards, {res.mode}: every BatchResult accounting "
              f"field equals phase 10's dense batch")
        if on_card:
            check(sk.launches > 0, f"SPR stream batch 0, {res.mode}, launched segment_sum")
        del eng, res

    # 4. two processes on the card
    g_een = generators.snap_analogue("EEN", 0.05, seed=0)
    want = kcore_decompose_sharded(g_een, mesh, ("data",), fused=True)
    two_ranks(dev, g_een, want, launches)

    # 5. the CLIs
    small = not on_card
    rc, text, err_text, wall = cli_json(["repro_torch.launch.kcore_run", *SHARDED_CLI_RUN,
                                         "--trace", str(TRACE_DIR / "kcore_run.json")], small)
    report = json.loads(text[text.index("{"):text.rindex("}") + 1]) if "{" in text else {}
    print(f"    kcore_run {' '.join(SHARDED_CLI_RUN)}: rounds {report.get('rounds')}, mesh "
          f"{report.get('mesh')}, dispatch {report.get('dispatch')}, phase_s "
          f"{report.get('phase_s')} ({wall:.1f} s with start-up)")
    check(rc == 0 and report.get("correct_vs_BZ") is True and report.get("mesh") == 2
          and report.get("dispatch") == ("torch" if small else "kernel"),
          f"kcore_run {' '.join(SHARDED_CLI_RUN)}: exit {rc}, correct_vs_BZ, mesh 2"
          f"{'' if rc == 0 else ': ' + err_text[-2000:]}")
    rc, text, err_text, wall = cli_json(["repro_torch.launch.kcore_serve", *SHARDED_CLI_SERVE],
                                        small)
    lines = text.splitlines()
    for line in lines:
        if not line.startswith("# final_stats="):
            print(f"    {line}")
    cols = next((line.split(",") for line in lines if line.startswith("tick,")), [])
    rows = [dict(zip(cols, line.split(","))) for line in lines if line[:1].isdigit()]
    check(rc == 0 and len(rows) == 2 and all(r["verified"] == "True" and r["mode"] == "sharded"
                                             for r in rows)
          and any(line.startswith("# graph=") and " mesh=2 " in line for line in lines),
          f"kcore_serve {' '.join(SHARDED_CLI_SERVE)}: exit {rc}, 2 sharded ticks verified "
          f"({wall:.1f} s){'' if rc == 0 else ': ' + err_text[-2000:]}")
    print(f"  phase wall {time.perf_counter() - t_phase:.1f} s")
    return err


# the GNN phase: configs/base.py GNN_SHAPES (full_graph_sm, minibatch_lg's geometry, ogb_products'
# features and classes, molecule), GraphCast's weather CONFIG (arXiv:2212.12794), seed-0 weights
GNN = {"seed": 0, "weather_steps": 3, "full_graph": (2708, 10556, 1433, 7),
       "molecules": (128, 30, 64), "minibatch": (1024, (15, 10), 602, 41),
       "products": (100, 47)}
# the float kernel's timed shapes: weather's processor scatter, MACE's a2 scatter of one SPR chunk
# (1,865,728 arcs of the padded 59,703,296), and the widest SPR row alone at MACE's width
WEATHER_CASE = "weather mm (processor block)"
FLOAT_TOL = ("|kernel - plain| within twice the float32 summation bound gamma_(d-1) sum|v| of "
             "each row's d terms, plus one output ulp for bf16 (checks.segment_sum_excess); "
             "bit-equal to the plain version on the CPU, which adds as the kernel does: each "
             "stretch of ops.STRETCH arcs in edge order, then a row's stretches in order, "
             "rounded once")


def held(what: str, r: dict, rule: str) -> bool:
    """Check a ``checks.hold`` (``rule`` "float32"), ``checks.hold_bf16``
    ("bf16") or ``checks.hold_bf16_noise`` ("bf16 noise") result ``r``,
    printing its distances in units in the last place."""
    ulp = r["ulp"]
    if rule == "bf16 noise":
        return check(r["ok"], f"{what}, in bf16 ulps ({ulp:.3g}) of the largest magnitude: "
                     f"card vs reference route {r['err'] / ulp:.2f}, card vs the more exact "
                     f"evaluation {r['err64'] / ulp:.2f}, reference route vs it "
                     f"{r['noise'] / ulp:.2f}; tolerance {r['tol'] / ulp:.2f} (twice the "
                     f"reference route's noise, at least 2)")
    if rule == "bf16":
        return check(r["ok"], f"{what}, in bf16 ulps ({ulp:.3g}) of the largest magnitude: "
                     f"card vs the more exact evaluation {r['err64'] / ulp:.2f}, the "
                     f"reference route's {r['ref64'] / ulp:.2f}, card vs reference route "
                     f"{r['err'] / ulp:.2f} (the bf16 rule: at most the reference's + 1)")
    return check(r["ok"], f"{what}, in float32 ulps ({ulp:.3g}) of the largest magnitude: "
                 f"card vs reference route {r['err'] / ulp:.2f}, card vs float64 "
                 f"{r['err64'] / ulp:.2f}, reference route vs float64 {r['noise'] / ulp:.2f}; "
                 f"tolerance {r['tol'] / ulp:.2f}")


def float_case(torch, dev, st, vals, ids, n: int, label: str, timed: bool = False,
               cpu_bits: bool = True):
    """Hold the float segment-sum kernel on ``vals`` by ``ids`` into ``n``
    rows against its plain version on the card (``FLOAT_TOL``), against the
    plain version on the CPU bit for bit (``cpu_bits``), and against its own
    second call bit for bit. ``timed`` adds a call's time, the device time,
    the plain version's, ``index_add_``'s and the bytes bound."""
    from repro_torch import checks
    from repro_torch.kernels.segment_sum import ops as sk

    lay = sk.segment_layout(ids, n, device=dev)
    got = sk.segment_sum_float(vals, lay)
    again = sk.segment_sum_float(vals, lay)
    plain = sk.segment_sum_float_ref(vals, lay.ids, n)
    excess, err = checks.segment_sum_excess(vals, lay.ids, n, got, plain)
    ok = excess <= 0 and torch.equal(got, again)
    E, F = vals.shape[0], vals.shape[1] if vals.dim() == 2 else 1
    msg = (f"segment_sum_float {label}: E={E} n={n} F={F} {str(vals.dtype)[6:]}: max |kernel - "
           f"plain| {err:.3g} (excess over the bound {excess:.3g}), same bits twice")
    if cpu_bits:
        bits = torch.equal(got.cpu(), sk.segment_sum_float(vals.cpu(), sk.segment_layout(
            lay.ids.cpu(), n)))
        ok = ok and bits
        msg += f", bit-equal to the CPU's plain version {bits}"
    del got, again, plain
    st["err"] = max(st["err"], err)
    st["excess"] = max(st["excess"], excess)
    if timed:
        s = vals.element_size()
        ms = time_ms(torch, lambda: sk.segment_sum_float(vals, lay), 20)
        dev_ms = device_ms(torch, lambda: sk.segment_sum_float(vals, lay), 5, "segment_sum_float")
        plain_ms = time_ms(torch, lambda: sk.segment_sum_float_ref(vals, lay.ids, n), 3, warmup=1)
        lib = time_ms(torch, lambda: torch.zeros((n, *vals.shape[1:]), dtype=vals.dtype,
                                                 device=dev).index_add_(0, lay.ids, vals), 5,
                      warmup=1)
        bnd = bound_ms(sk.float_cost(E, n, F, s)[1])
        st["timed"][label] = dict(E=E, n=n, F=F, dtype=str(vals.dtype)[6:], ms=ms,
                                  device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib,
                                  bound_ms=bnd)
        on_dev = (f"{dev_ms:.4f} ms on the device" if dev_ms is not None
                  else "the device time not measured")
        msg += (f": {ms:.4f} ms a call, {on_dev} (plain {plain_ms:.3f} ms, index_add_ {lib:.4f} "
                f"ms, bound {bnd:.4f} ms, {bnd / ms:.1%} of the call"
                + (f", {bnd / dev_ms:.1%} of the device time)" if dev_ms is not None else ")"))
    check(ok, msg)
    return lay


def float_kernel_cases(torch, np, dev, st, g, small: bool) -> None:
    """Phase 22a: the float kernel against its plain version on the CPU
    tests' cases and at the main path's shapes."""
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.kernels.segment_sum import ops as sk
    from repro_torch.models.gnn import graphcast, steps

    rng = np.random.default_rng(22)
    gen = torch.Generator(device=dev).manual_seed(22)

    def rand(E, F, dtype, extra=0):
        return torch.randn((E, F + extra), generator=gen, device=dev).mul_(30).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        for F in (1, 3, 17, 64, 9 * 16, 512, 1152):
            float_case(torch, dev, st, rand(20_000, F, dtype), rng.integers(0, 1_500, 20_000),
                       1_600, f"{name} F={F}, empty rows")
        float_case(torch, dev, st, rand(0, 5, dtype), np.zeros(0, np.int64), 13, f"{name} E = 0")
        float_case(torch, dev, st, rand(3_000, 24, dtype), rng.permutation(5_000)[:3_000], 5_000,
                   f"{name} rows of one arc")
        keep = torch.as_tensor(rng.random(9_000) < 0.7, device=dev)
        ids = rng.integers(0, 300, 9_000)
        float_case(torch, dev, st, rand(9_000, 128, dtype) * keep[:, None].to(dtype),
                   np.where(keep.cpu().numpy(), ids, 0), 300, f"{name} masked pad arcs")
        float_case(torch, dev, st, rand(14_000, 64, dtype, 3)[::2, 3:], rng.integers(0, 200, 7_000),
                   200, f"{name} a non-contiguous view")
        x = rand(4_000 * 16 + 2, 1, dtype)[:, 0]
        off = x[4 // x.element_size():][:4_000 * 16].view(4_000, 16)
        float_case(torch, dev, st, off, rng.integers(0, 90, 4_000), 90,
                   f"{name} base 4 bytes off 16 ({off.data_ptr() % 16})")
        float_case(torch, dev, st, rand(3_840, 1, dtype)[:, 0], np.repeat(np.arange(128), 30), 128,
                   f"{name} (E,) values, 30 a row")
        float_case(torch, dev, st, rand(20_000, 4, dtype), rng.integers(0, 10, 20_000), 10,
                   f"{name} 2,000 arcs a row")
        # rows about the stretch S, where a row's sum becomes a sum of stretch partials
        S = sk.STRETCH
        widths = (0, 1, S - 1, S, S + 1, 2 * S, 2 * S + 1, 5 * S + 3)
        ids = np.repeat(np.arange(len(widths)), widths)
        rng.shuffle(ids)
        for F in (1, 3, 8, 144, 1152):
            float_case(torch, dev, st, rand(ids.size, F, dtype), ids, len(widths) + 3,
                       f"{name} F={F}, rows of {', '.join(map(str, widths))} arcs")

    # the main path's shapes
    wcfg = (get_smoke if small else get_config)("graphcast")
    graph = graphcast.make_weather_graph(wcfg, 0)
    d = wcfg.d_hidden
    float_case(torch, dev, st, rand(graph["mm_dst"].shape[0], d, torch.float32), graph["mm_dst"],
               wcfg.params["mesh_nodes"], WEATHER_CASE, timed=True)
    C = (get_smoke if small else get_config)("mace").d_hidden
    E = steps._pad512(g.num_arcs)
    Ec = E // (32 if not small else 1)
    dst = np.concatenate([g.dst, np.zeros(E - g.num_arcs, np.int32)])[:Ec]
    float_case(torch, dev, st, rand(Ec, 9 * C, torch.bfloat16), dst, g.n,
               "MACE a2 chunk over SPR", timed=True, cpu_bits=small)
    top = int(np.argmax(g.deg))
    float_case(torch, dev, st, rand(int(g.deg[top]), 9 * C, torch.bfloat16),
               np.zeros(int(g.deg[top]), np.int64), 1, "the widest SPR row alone at MACE's a2 width",
               timed=True)
    del graph, dst


def gnn_forward(torch, np, dev, g, st, smi, small: bool = False):
    """Phase 22: the GNN family's forward paths on the float segment-sum
    kernel. Returns the kernel's launches in the main path's runs (the
    weather rollout, the four models, the sampled batch, MACE over SPR) and
    the sampled ``minibatch_lg`` batch (numpy) for phase 23. ``small`` (the
    CPU rehearsal) runs the SMOKE configs and cuts the sampled batch's seeds
    by 16."""
    from repro_torch import checks
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.graph import generators, sampler
    from repro_torch.kernels.segment_sum import ops as sk
    from repro_torch.launch import graphcast_weather as GW
    from repro_torch.models.gnn import common, graphcast, mace, steps
    from repro_torch.obs.profile import format_profile, profile_call

    on_card = dev.type == "cuda"
    card = smi.replace("\n", "; ") if smi else "no card"
    cfg_of = get_smoke if small else get_config
    t_phase = time.perf_counter()
    launches = 0

    def reset():
        if on_card:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        sk.float_launches = 0

    def peak():
        return torch.cuda.max_memory_allocated(dev) if on_card else 0

    def timed(fn):
        if on_card:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = fn()
        if on_card:
            torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t0

    # a. the float kernel against its plain version
    t0 = time.perf_counter()
    float_kernel_cases(torch, np, dev, st, g, small)
    print(f"  (a) the float kernel's cases in {time.perf_counter() - t0:.1f} s ({card})")

    # b. GraphCast weather at CONFIG: a rollout through the launcher's functions
    cfg = cfg_of("graphcast")
    p = cfg.params
    t0 = time.perf_counter()
    graph, layouts = GW.make_graph(cfg, dev)
    params = graphcast.init_weather_params(cfg, GNN["seed"], dev)
    state = GW.initial_state(cfg, dev)
    print(f"  (b) {cfg.name}: {p['grid_lat']} x {p['grid_lon']} grid, {p['mesh_nodes']} mesh "
          f"nodes, g2m/mm/m2g {p['grid2mesh_edges']}/{p['mesh_edges']}/{p['mesh2grid_edges']} "
          f"arcs, d {cfg.d_hidden}, {cfg.n_layers} processor layers, {p['n_vars']} variables; "
          f"graph, layouts and weights on {dev} in {time.perf_counter() - t0:.2f} s")
    GW.rollout(params, cfg, state, graph, layouts, 1)        # warm-up: cuBLAS, the allocator
    reset()
    res = GW.rollout(params, cfg, state, graph, layouts, GNN["weather_steps"])
    n = sk.float_launches
    launches += n
    print(f"  weather rollout: {sum(res.ms_per_step) / len(res.ms_per_step):.3f} ms a step "
          f"(steps {', '.join(f'{t:.3f}' for t in res.ms_per_step)} ms); peak device memory "
          f"{peak()} bytes; TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, cuDNN "
          f"{torch.backends.cudnn.allow_tf32}; float kernel launches {n} ({card})")
    check(tuple(res.state.shape) == (p["grid_lat"] * p["grid_lon"], p["n_vars"])
          and bool(torch.isfinite(res.state).all()),
          f"{GNN['weather_steps']}-step rollout finite, shape {tuple(res.state.shape)}")
    if on_card:
        check(n == GNN["weather_steps"] * (cfg.n_layers + 2),
              f"18 float kernel launches a weather step ({n} == {GNN['weather_steps']} x "
              f"{cfg.n_layers + 2})")
        with torch.inference_mode():
            _, prof = profile_call(
                lambda: graphcast.weather_forward(params, cfg, state, graph, layouts), dev, top=10)
        print("  one weather step under torch.profiler:")
        print("\n".join("    " + line for line in format_profile({"step": prof}).splitlines()))
    with torch.inference_mode():
        one = graphcast.weather_forward(params, cfg, state, graph, layouts)
        with common.plain_scatter():
            plain = graphcast.weather_forward(params, cfg, state, graph, layouts)
            f64 = graphcast.weather_forward(common.params_to(params, dtype=torch.float64), cfg,
                                            state.double(), graph, layouts)
    held("weather step on the card against the plain scatter on the card (reference route) and "
         "a float64 evaluation", checks.hold(one, plain, f64), "float32")
    del graph, layouts, params, state, res, one, plain, f64

    # c. the four models at full width, the card against the CPU from the same weights
    n_nodes, n_edges, d_feat, n_classes = GNN["full_graph"]
    fg = generators.erdos_renyi(n_nodes, n_edges, seed=0)
    full_batch = common.batch_from_graph(fg, d_feat, n_classes, seed=0)
    n_mols = GNN["molecules"][0]
    for arch in ("schnet", "egnn", "mace", "graphcast"):
        cfg = cfg_of(arch)
        rule = "bf16" if arch in ("mace", "graphcast") else "float32"
        batches = {"full_graph_sm": full_batch, "molecule": common.batch_molecules(
            *GNN["molecules"], cfg.params.get("n_species", 10), seed=0)}
        for kind, batch in batches.items():
            full = kind == "full_graph_sm"
            params = steps.init_params(cfg, GNN["seed"], d_in=d_feat if full else None,
                                       n_classes=n_classes if full else 0, device=dev)
            mod = steps.model_module(cfg)
            if full:
                what, fn = "node_logits", lambda p_, b_: steps.node_logits(p_, cfg, b_)
            elif arch == "graphcast":
                what, fn = "node_embeddings", lambda p_, b_: mod.node_embeddings(p_, cfg, b_)
            else:
                what, fn = "energy", lambda p_, b_: mod.energy(p_, cfg, b_, n_mols)
            on = common.batch_to(batch, dev)
            reset()
            out, wall = timed(lambda: fn(params, on))
            n = sk.float_launches
            launches += n
            cpu_out, cpu_wall = timed(lambda: fn(common.params_to(params, "cpu"),
                                                 common.batch_to(batch, "cpu")))
            with common.plain_scatter():
                f64, _ = timed(lambda: fn(common.params_to(params, dtype=torch.float64), on))
            f64 = f64.cpu()
            r = checks.hold_bf16(out, cpu_out, f64) if rule == "bf16" else \
                checks.hold(out, cpu_out, f64)
            print(f"  (c) {cfg.name} {what} on {kind} ({batch['node_mask'].shape[0]} nodes, "
                  f"{batch['src'].shape[0]} arcs): card {wall * 1e3:.1f} ms (first call), CPU "
                  f"{cpu_wall * 1e3:.1f} ms; float kernel launches {n} ({card})")
            check(tuple(out.shape) == tuple(cpu_out.shape) and bool(torch.isfinite(out).all()),
                  f"{cfg.name} {what} on {kind}: shape {tuple(out.shape)}, finite")
            held(f"{cfg.name} {what} on {kind}: card against the CPU (reference route)", r, rule)
            del params, out, cpu_out, f64, on

    # d. minibatch_lg's geometry over phase 6's SPR graph: GraphCast-generic node logits
    seeds, fanout, d_feat, n_classes = GNN["minibatch"]
    seeds //= 16 if small else 1
    t0 = time.perf_counter()
    sub = next(sampler.minibatch_stream(g, seeds, fanout, seed=0))
    mb = common.batch_from_sampled(g, sub, d_feat, n_classes, seed=0)
    mb.pop("n_seeds")
    on = common.batch_to(mb, dev)
    lay = common.dst_layout(on)
    cfg = cfg_of("graphcast")
    params = steps.init_params(cfg, GNN["seed"], d_in=d_feat, n_classes=n_classes, device=dev)
    print(f"  (d) {seeds} seeds, fanout {fanout} over SPR: {mb['node_mask'].shape[0]} nodes "
          f"({int(mb['node_mask'].sum())} real), {mb['src'].shape[0]} arcs "
          f"({int(mb['edge_mask'].sum())} real), d_feat {d_feat}, {n_classes} classes; sampled, "
          f"built and staged in {time.perf_counter() - t0:.2f} s")
    reset()
    logits, wall = timed(lambda: steps.node_logits(params, cfg, on, layout=lay))
    n = sk.float_launches
    launches += n
    print(f"  {cfg.name} node_logits: {wall * 1e3:.1f} ms; peak device memory {peak()} bytes; "
          f"float kernel launches {n} ({card})")
    check(tuple(logits.shape) == (mb["node_mask"].shape[0], n_classes)
          and bool(torch.isfinite(logits).all()), f"sampled batch logits {tuple(logits.shape)} finite")
    if on_card:
        check(n == cfg.n_layers, f"one float kernel launch a layer ({n} == {cfg.n_layers})")
    with common.plain_scatter():
        plain, _ = timed(lambda: steps.node_logits(params, cfg, on, layout=lay))
        f64, _ = timed(lambda: steps.node_logits(common.params_to(params, dtype=torch.float64),
                                                 cfg, on, layout=lay))
    held("sampled batch logits: the kernel route against the plain scatter on the card "
         "(reference route) and a float64 evaluation", checks.hold_bf16(logits, plain, f64),
         "bf16")
    del sub, on, lay, params, logits, plain, f64

    # e. MACE at full width over SPR with ogb_products' features: the chunked branch
    d_feat, n_classes = GNN["products"]
    t0 = time.perf_counter()
    batch = steps.pad_batch(common.batch_from_graph(g, d_feat, n_classes, seed=0))
    on = common.batch_to(batch, dev)
    del batch
    layouts = mace.edge_layouts(on)
    cfg = cfg_of("mace")
    params = steps.init_params(cfg, GNN["seed"], d_in=d_feat, n_classes=n_classes, device=dev)
    E = on["src"].shape[0]
    print(f"  (e) {cfg.name} over SPR: {g.n} nodes, {g.num_arcs} arcs padded to {E}, "
          f"{len(layouts)} chunks of {E // len(layouts)}, d_feat {d_feat}; built, staged and "
          f"laid out in {time.perf_counter() - t0:.2f} s")
    reset()
    h, wall = timed(lambda: mace.node_embeddings(params, cfg, on, layout=layouts))
    n = sk.float_launches
    launches += n
    print(f"  node_embeddings: {wall:.3f} s; peak device memory {peak()} bytes; float kernel "
          f"launches {n} ({card})")
    check(tuple(h.shape) == (g.n, cfg.d_hidden) and bool(torch.isfinite(h).all()),
          f"MACE embeddings {tuple(h.shape)} finite")
    if on_card:
        check(n == 3 * len(layouts) * cfg.n_layers,
              f"3 float kernel launches a chunk a layer ({n} == 3 x {len(layouts)} x "
              f"{cfg.n_layers})")
    # the plain-scatter route; the first chunk's three scatters held against the kernel there
    first = []
    scatter = mace.scatter_sum

    def spy(values, layout):
        out = scatter(values, layout)
        if len(first) < 3:
            got = sk.segment_sum_float(values.reshape(values.shape[0], -1), layout)
            first.append(checks.segment_sum_excess(values, layout.ids, layout.n, got, out)[0])
        return out

    mace.scatter_sum = spy
    try:
        with common.plain_scatter():
            plain, plain_wall = timed(lambda: mace.node_embeddings(params, cfg, on, layout=layouts))
    finally:
        mace.scatter_sum = scatter
    check(len(first) == 3 and max(first) <= 0,
          f"the first chunk's three scatters: kernel against plain on the card, excess over "
          f"the bound {', '.join(f'{x:.3g}' for x in first)}")
    # a float32 evaluation stands in for float64, which would not fit on the card here
    compute, common.COMPUTE_DTYPE = common.COMPUTE_DTYPE, torch.float32
    try:
        with common.plain_scatter():
            ref32, ref_wall = timed(lambda: mace.node_embeddings(params, cfg, on, layout=layouts))
    finally:
        common.COMPUTE_DTYPE = compute
    print(f"  the plain-scatter route {plain_wall:.3f} s, the float32 evaluation {ref_wall:.3f} s; "
          f"peak device memory {peak()} bytes ({card})")
    held("MACE over SPR: the kernel route against the plain-scatter route (reference route) and "
         "a float32 evaluation", checks.hold_bf16(h, plain, ref32), "bf16")
    del on, layouts, params, h, plain, ref32
    if on_card:
        torch.cuda.empty_cache()
    print(f"  phase wall {time.perf_counter() - t_phase:.1f} s")
    return launches, mb


# the GNN training phase: the weather example's AdamW steps at GraphCast's full CONFIG (the
# example takes 25), the peak they may reach, the float64 evaluation's budget on the 80 GB card,
# and the gradient leaves held by name (a path into the weather parameter tree)
GNN_TRAIN = {"weather_steps": 5, "peak_limit": 40e9, "f64_limit": 70e9}
# GraphCast-generic's depth in the card-against-CPU train steps: its 16 layers at d 512 took
# 30.7 s (full_graph_sm) and 19.8 s (molecule) a step on the chip host's CPU, so the phase
# held them at 4 of 16 layers, full width (PERF.md section 4)
CPU_GRAPHCAST_LAYERS = 4
GRAD_LEAVES = (("grid_encode", 0, "w"), ("g2m", "edge_mlp", 0, "w"),
               ("blocks", 0, "edge_mlp", 0, "w"), ("blocks", -1, "node_mlp", 1, "b"),
               ("m2g", "node_mlp", 0, "w"), ("grid_decode", 1, "w"))


def backward_case(torch, dev, gen, vals, ids, n: int, label: str, timed: bool = False) -> None:
    """Phase 23a: the float segment sum's backward on the card against
    autograd through its plain version on the card, bit for bit (both
    gather ``grad_out`` by the segment ids); the forward is the one kernel
    launch. ``timed`` adds the gather's time beside its bytes bound."""
    from repro_torch.kernels.segment_sum import ops as sk

    lay = sk.segment_layout(ids, n, device=dev)
    g = torch.randn((n, *vals.shape[1:]), generator=gen, device=dev).to(vals.dtype)
    a, b = (vals.detach().clone().requires_grad_(True) for _ in range(2))
    before = sk.float_launches
    sk.segment_sum_float(a, lay).backward(g)
    launched = sk.float_launches - before
    sk.segment_sum_float_ref(b, lay.ids, n).backward(g)
    ok = a.grad.dtype == vals.dtype and torch.equal(a.grad, b.grad) and \
        (launched == 1 or dev.type != "cuda")
    E, F = vals.shape[0], vals.shape[1] if vals.dim() == 2 else 1
    msg = (f"segment_sum_float backward, {label}: E={E} n={n} F={F} {str(vals.dtype)[6:]}: the "
           f"gradient bit-equal to autograd through the plain version on the card, "
           f"{launched} forward launch(es)")
    if timed:
        ms = time_ms(torch, lambda: g.index_select(0, lay.ids), 20)
        bnd = bound_ms(sk.float_backward_cost(E, n, F, vals.element_size())[1])
        msg += f"; the gather {ms:.4f} ms a call (bound {bnd:.4f} ms, {bnd / ms:.1%})"
    check(ok, msg)


def gnn_training(torch, np, dev, mb, smi, small: bool = False) -> int:
    """Phase 23: GNN training on the float segment-sum kernel: its backward,
    the weather example's steps at full ``CONFIG``, a train step of each
    model at full width against the CPU, and the seed-prefix loss over phase
    22's sampled batch ``mb``. Returns the kernel's launches in the training
    runs. ``small`` (the CPU rehearsal) runs the SMOKE configs."""
    import dataclasses
    from contextlib import nullcontext

    from repro_torch import checks
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.configs.base import GNN_SHAPES, ShapeSpec
    from repro_torch.graph import generators
    from repro_torch.kernels.segment_sum import ops as sk
    from repro_torch.launch import graphcast_weather as GW
    from repro_torch.models.gnn import common, graphcast, steps
    from repro_torch.optim import adamw_init, global_norm
    from repro_torch.tree import leaves

    on_card = dev.type == "cuda"
    card = smi.replace("\n", "; ") if smi else "no card"
    cfg_of = get_smoke if small else get_config
    shapes = {sp.name: sp for sp in GNN_SHAPES}
    t_phase = time.perf_counter()
    launches = 0

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def reset():
        sync()
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        sk.float_launches = 0

    def peak():
        return torch.cuda.max_memory_allocated(dev) if on_card else 0

    # a. the backward at the weather processor's shape, ragged rows, empty rows and E = 0
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(23)
    rng = np.random.default_rng(23)
    wcfg = cfg_of("graphcast")
    mm_dst = graphcast.make_weather_graph(wcfg, 0)["mm_dst"]
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        vals = torch.randn((mm_dst.shape[0], wcfg.d_hidden), generator=gen, device=dev).to(dtype)
        backward_case(torch, dev, gen, vals, mm_dst, wcfg.params["mesh_nodes"],
                      f"{name} {WEATHER_CASE}", timed=True)
        del vals
        backward_case(torch, dev, gen, torch.randn((20_000, 17), generator=gen, device=dev).to(dtype),
                      rng.integers(0, 1_500, 20_000), 1_600, f"{name} ragged rows, rows 1,500.. empty")
        backward_case(torch, dev, gen, torch.randn(3_840, generator=gen, device=dev).to(dtype),
                      rng.integers(0, 100, 3_840), 128, f"{name} (E,) values, empty rows")
        backward_case(torch, dev, gen, torch.zeros((0, 5), device=dev, dtype=dtype),
                      np.zeros(0, np.int64), 13, f"{name} E = 0")
    print(f"  (a) the backward's cases in {time.perf_counter() - t0:.1f} s ({card})")

    # b. the weather example's training at full CONFIG, processor blocks checkpointed
    t0 = time.perf_counter()
    cfg = wcfg
    graph, layouts = GW.make_graph(cfg, dev)
    params = graphcast.init_weather_params(cfg, GNN["seed"], dev)
    reset()
    tr = GW.train(params, cfg, graph, layouts, GNN_TRAIN["weather_steps"])
    n, pk = sk.float_launches, peak()
    launches += n
    per_step = 2 * cfg.n_layers + 2
    nsteps = len(tr.losses)
    print(f"  (b) {cfg.name}: {nsteps} AdamW steps of the example's loss: "
          f"{sum(tr.ms_per_step) / nsteps:.3f} ms a step (steps "
          f"{', '.join(f'{t:.3f}' for t in tr.ms_per_step)} ms; after the first "
          f"{sum(tr.ms_per_step[1:]) / max(nsteps - 1, 1):.3f}); peak device memory {pk} bytes; "
          f"float kernel launches {n} ({n / nsteps:.1f} a step); losses "
          f"{', '.join(f'{x:.6f}' for x in tr.losses)} ({card})")
    check(all(math.isfinite(x) for x in tr.losses), f"{nsteps} weather training losses finite")
    if on_card:
        check(n == nsteps * per_step, f"{per_step} float kernel launches a training step: "
              f"{cfg.n_layers + 2} forward, {cfg.n_layers} in the recomputed blocks ({n} == "
              f"{nsteps} x {per_step})")
        check(pk < GNN_TRAIN["peak_limit"], f"weather training peak {pk / 1e9:.2f} GB below "
              f"{GNN_TRAIN['peak_limit'] / 1e9:.0f} GB")
    params = tr.params
    del tr                                    # the AdamW moments
    # one step's loss, grad norm and named gradient leaves: the kernel route, the plain-scatter
    # route and a float64 evaluation, each on the card
    keep = cfg.n_layers
    if on_card and 2 * pk > GNN_TRAIN["f64_limit"]:
        keep = max(1, int(cfg.n_layers * GNN_TRAIN["f64_limit"] / (2 * pk)))
    hcfg = dataclasses.replace(cfg, n_layers=keep)
    hparams = dict(params, blocks=params["blocks"][:keep])
    state, target = GW.example_data(cfg, dev)

    def one(p, st, plain):
        with common.plain_scatter() if plain else nullcontext():
            loss, grads = steps.value_and_grad(GW.weather_loss, p, hcfg, st, target, graph, layouts)
        out = [loss.cpu(), global_norm(grads).cpu()]
        for path in GRAD_LEAVES:
            leaf = grads
            for k in path:
                leaf = leaf[k]
            out.append(leaf.cpu())
        return out

    reset()
    kern = one(hparams, state, False)
    n = sk.float_launches
    launches += n
    plain = one(hparams, state, True)
    reset()
    f64 = one(common.params_to(hparams, dtype=torch.float64), state.double(), True)
    pk64 = peak()
    print(f"  one step held at {keep} of {cfg.n_layers} processor blocks (float64 predicted at "
          f"2 x the training peak, {2 * pk / 1e9:.2f} GB, against {GNN_TRAIN['f64_limit'] / 1e9:.0f} "
          f"GB); the float64 step's peak {pk64} bytes; loss {float(kern[0]):.6f}, grad norm "
          f"{float(kern[1]):.6f}; kernel launches {n}")
    for i, name in enumerate(["loss", "grad norm"] + ["grads" + "".join(f"[{k!r}]" for k in p)
                                                      for p in GRAD_LEAVES]):
        held(f"weather step {name}: the kernel route against the plain scatter on the card "
             f"(reference route) and a float64 evaluation", checks.hold(kern[i], plain[i], f64[i]),
             "float32")
    del graph, layouts, params, hparams, state, target, kern, plain, f64
    print(f"  (b) in {time.perf_counter() - t0:.1f} s")

    # c. a train step of each model at full width, the card against the CPU from the same weights
    t0 = time.perf_counter()
    n_nodes, n_edges, d_feat, n_classes = GNN["full_graph"]
    full_batch = common.batch_from_graph(generators.erdos_renyi(n_nodes, n_edges, seed=0), d_feat,
                                         n_classes, seed=0)
    for arch in ("schnet", "egnn", "mace", "graphcast"):
        cfg = cfg_of(arch)
        if arch == "graphcast" and not small:
            cfg = dataclasses.replace(cfg, n_layers=CPU_GRAPHCAST_LAYERS)
        rule = "bf16" if arch in ("mace", "graphcast") else "float32"
        cases = [("full_graph_sm", full_batch),
                 ("molecule", common.batch_molecules(*GNN["molecules"],
                                                     cfg.params.get("n_species", 10), seed=0))]
        for kind, batch in cases:
            full = kind == "full_graph_sm"
            params = steps.init_params(cfg, GNN["seed"], d_in=d_feat if full else None,
                                       n_classes=n_classes if full else 0, device=dev)
            step = steps.make_train_step(cfg, shapes[kind])
            on = common.batch_to(batch, dev)
            reset()
            t1 = time.perf_counter()
            out = step(params, adamw_init(params), on)
            sync()
            wall = time.perf_counter() - t1
            n = sk.float_launches
            launches += n
            p32 = common.params_to(params, "cpu")
            t1 = time.perf_counter()
            cpu = step(p32, adamw_init(p32), common.batch_to(batch, "cpu"))
            cpu_wall = time.perf_counter() - t1
            p64 = common.params_to(params, dtype=torch.float64)
            with common.plain_scatter():
                f64 = step(p64, adamw_init(p64), on)
            print(f"  (c) {cfg.name} ({cfg.n_layers} layers, d {cfg.d_hidden}) train step on "
                  f"{kind}: card {wall * 1e3:.1f} ms (first call), "
                  f"CPU {cpu_wall * 1e3:.1f} ms; float kernel launches {n}; loss "
                  f"{float(out[2]['loss']):.6f} ({card})")
            if on_card:
                check(n > 0, f"{cfg.name} on {kind} launched the float kernel")
            for what, pick in [("loss", lambda o: o[2]["loss"]),
                               ("grad norm", lambda o: o[2]["grad_norm"]),
                               ("updated parameters", lambda o: leaves(o[0]))]:
                args = [common.params_to(pick(o), "cpu") for o in (out, cpu, f64)]
                r = checks.hold_bf16(*args) if rule == "bf16" else checks.hold(*args)
                held(f"{cfg.name} train step on {kind}, {what}: card against the CPU (reference "
                     f"route)", r, rule)
            del params, out, cpu, f64, p32, p64, on
    print(f"  (c) in {time.perf_counter() - t0:.1f} s")

    # d. the seed-prefix loss over phase 22's minibatch_lg batch, GraphCast generic
    t0 = time.perf_counter()
    seeds = GNN["minibatch"][0] // (16 if small else 1)
    shape = ShapeSpec("minibatch_lg", "minibatch",
                      dict(shapes["minibatch_lg"].params, batch_nodes=seeds))
    cfg = cfg_of("graphcast")
    on = common.batch_to(mb, dev)
    lay = common.dst_layout(on)
    d_feat, n_classes = mb["feats"].shape[1], GNN["minibatch"][3]
    params = steps.init_params(cfg, GNN["seed"], d_in=d_feat, n_classes=n_classes, device=dev)
    step = steps.make_train_step(cfg, shape)
    reset()
    t1 = time.perf_counter()
    out = step(params, adamw_init(params), on, layout=lay)
    sync()
    wall = time.perf_counter() - t1
    n, pk = sk.float_launches, peak()
    launches += n
    with common.plain_scatter():
        plain = step(params, adamw_init(params), on, layout=lay)
        p64 = common.params_to(params, dtype=torch.float64)
        f64 = step(p64, adamw_init(p64), on, layout=lay)
    print(f"  (d) {cfg.name} train step over the sampled batch ({seeds} seeds, "
          f"{mb['node_mask'].shape[0]} nodes, {mb['src'].shape[0]} arcs): {wall * 1e3:.1f} ms "
          f"(first call); peak device memory {pk} bytes; float kernel launches {n}; loss "
          f"{float(out[2]['loss']):.6f} ({card})")
    if on_card:
        check(n == 2 * cfg.n_layers, f"two float kernel launches a layer, one recomputed ({n} == "
              f"2 x {cfg.n_layers})")
    for what, pick in [("loss", lambda o: o[2]["loss"]), ("grad norm", lambda o: o[2]["grad_norm"]),
                       ("updated parameters", lambda o: leaves(o[0]))]:
        held(f"sampled batch train step, {what}: the kernel route against the plain scatter on "
             f"the card (reference route) and a float64 evaluation",
             checks.hold_bf16(*(common.params_to(pick(o), "cpu") for o in (out, plain, f64))),
             "bf16")
    del on, lay, params, out, plain, f64, p64
    if on_card:
        torch.cuda.empty_cache()
    print(f"  (d) in {time.perf_counter() - t0:.1f} s; phase wall {time.perf_counter() - t_phase:.1f} s")
    return launches


# the LM phase's shapes: the step held against the CPU; the driver's batch (train_4k's sequence
# on one card's batch), 2 steps with a checkpoint after each and a failure after the first; the
# trained weights' serve shape; the CPU route's threads while the card runs beside it
LM = {"arch": "qwen1.5-0.5b", "seed": 0, "hold": (1, 128), "batch": 8, "seq": 4096, "steps": 2,
      "ckpt_every": 1, "fail_at": 1, "serve": (2, 1024), "cpu_threads": 6}
# gradient leaves held in 24a; ``bk`` is left out: a key bias shifts all of a query's scores
# alike, so its exact gradient is 0 and both routes hold rounding noise there
LM_GRAD_LEAVES = (("embed",), ("layers", "attn", "wq"), ("layers", "attn", "bq"),
                  ("layers", "mlp", "w_down"), ("layers", "norm2"), ("norm_f",))


def lm_training(torch, np, dev, st, smi, small: bool = False) -> tuple[int, int]:
    """Phase 24: LM training at ``qwen1.5-0.5b``'s full width. (a) One
    train step at batch 1 x 128 on the card, on the CPU's bf16 route (in a
    thread, beside (b) and (c)) and in float32 on the card; (b) the
    embedding scatter's timed shapes, then ``TrainDriver`` at 8 x 4096 with a
    failure after its first checkpoint, a relaunch that restores and
    finishes, and the first run's in-memory state stepped on without a save
    or a restore, bit for bit; (c) the trained weights served through prefill
    on the flash kernel against ``forward_hidden``. Returns the float
    segment-sum kernel's launches and the flash kernel's in the main-path
    runs. ``small`` (the CPU rehearsal) runs the SMOKE config at 2 x 64."""
    import shutil
    import tempfile
    import threading

    from repro_torch import checks
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.data import synth_lm_batch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.segment_sum import ops as sk
    from repro_torch.launch import serve, train
    from repro_torch.models.autodiff import value_and_grad
    from repro_torch.models.transformer import model as M, steps
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, cosine_warmup
    from repro_torch.runtime import HostFailure, TrainDriver, TrainDriverConfig, \
        make_failure_injector
    from repro_torch.tree import leaves

    on_card = dev.type == "cuda"
    card = smi.replace("\n", "; ") if smi else "no card"
    cpu = torch.device("cpu")
    cfg = (get_smoke if small else get_config)(LM["arch"])
    t_phase = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False          # the float32 evaluation is float32

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def batch(b, s, step, where):
        t, lab = synth_lm_batch(cfg.vocab, b, s, seed=LM["seed"], step=step)
        return torch.from_numpy(t).to(where), torch.from_numpy(lab).to(where)

    def one_step(p, tok, lab, dtype):
        """``make_train_step``'s body, keeping the gradient: [loss, grad norm,
        the named gradient leaves] and the updated parameters, on p's device."""
        loss, grads = value_and_grad(lambda q: M.lm_loss(q, cfg, tok, lab, dtype=dtype), p)
        opt = adamw_init(p)
        new, _, metrics = adamw_update(p, grads, opt, AdamWConfig(), cosine_warmup(
            opt["count"], warmup=100, total=LM["steps"]))
        out = [loss, metrics["grad_norm"]]
        for path in LM_GRAD_LEAVES:
            leaf = grads
            for k in path:
                leaf = leaf[k]
            out.append(leaf)
        return out, leaves(new)

    # a. one step at 1 x 128 on the card, the CPU bf16 route in a thread, float32 on the card
    t0 = time.perf_counter()
    cpu_params = M.init_params(cfg, LM["seed"], device=cpu)
    params = M.params_to(cpu_params, dev)
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab {cfg.vocab}; "
          f"{sum(t.numel() for t in leaves(params))} float32 weights drawn in "
          f"{time.perf_counter() - t0:.1f} s")
    b1, s1 = LM["hold"]
    tok, lab = batch(b1, s1, 0, cpu)
    plain, threads = {}, torch.get_num_threads()

    def cpu_route():
        t1 = time.perf_counter()
        try:
            plain["out"] = one_step(cpu_params, tok, lab, M.COMPUTE_DTYPE)
        finally:
            plain["s"] = time.perf_counter() - t1

    if on_card:     # leave the card's launches and the driver's I/O cores of their own
        torch.set_num_threads(min(threads, LM["cpu_threads"]))
    worker = threading.Thread(target=cpu_route, daemon=True)
    worker.start()
    t1 = time.perf_counter()
    kern = one_step(params, tok.to(dev), lab.to(dev), M.COMPUTE_DTYPE)
    card_s = time.perf_counter() - t1
    via_step = steps.make_train_step(cfg, total_steps=LM["steps"])(
        params, adamw_init(params), tok.to(dev), lab.to(dev))
    check(all(torch.equal(a, b) for a, b in zip(leaves(via_step[0]), kern[1]))
          and torch.equal(via_step[2]["loss"], kern[0][0]),
          f"steps.make_train_step at {b1} x {s1} gives the bits of value_and_grad + adamw_update")
    del via_step
    t1 = time.perf_counter()
    f32 = one_step(params, tok.to(dev), lab.to(dev), torch.float32)
    f32_s = time.perf_counter() - t1
    print(f"  (a) one train step at {b1} x {s1}: card {card_s:.2f} s, float32 on the card "
          f"{f32_s:.2f} s (the CPU bf16 route runs in a thread beside (b) and (c)); loss "
          f"{float(kern[0][0]):.6f}, grad norm {float(kern[0][1]):.6f} ({card})")

    # b. the embedding scatter's timed shapes, then TrainDriver at full width with a failure
    t0 = time.perf_counter()
    B, S = (2, 64) if small else (LM["batch"], LM["seq"])
    tokens = batch(B, S, 0, dev)[0].reshape(-1)
    counts = torch.bincount(tokens, minlength=cfg.vocab)
    hot = int(counts.argmax())
    gen = torch.Generator(device=dev).manual_seed(24)
    rows = torch.randn((tokens.numel(), cfg.d_model), generator=gen, device=dev)
    float_case(torch, dev, st, rows, tokens, cfg.vocab,
               f"LM embedding backward ({B} x {S} tokens)", timed=True)
    float_case(torch, dev, st, rows[tokens == hot].contiguous(),
               torch.zeros(int(counts[hot]), dtype=torch.int64, device=dev), 1,
               "the LM embedding's hottest row alone", timed=True)
    print(f"  (b) token {hot} takes {int(counts[hot])} of the {tokens.numel()} positions "
          f"({int(counts[hot]) / tokens.numel():.1%}); {int((counts > 0).sum())} rows of "
          f"{cfg.vocab} touched")
    del rows, tokens, counts
    step_fn = train.make_step_fn(cfg, LM["steps"])
    batch_fn = train.make_batch_fn(cfg.vocab, B, S, LM["seed"], dev)
    ckdir = tempfile.mkdtemp(prefix="lm_ckpt_")
    try:
        conf = TrainDriverConfig(total_steps=LM["steps"], checkpoint_every=LM["ckpt_every"],
                                 checkpoint_dir=ckdir, log_every=1)
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        sk.float_launches = 0
        first = TrainDriver(step_fn, [params, adamw_init(params)], batch_fn, conf,
                            failure_injector=make_failure_injector(LM["fail_at"]))
        del params
        failed = False
        try:
            first.run()
        except HostFailure:
            failed = True
        ck_bytes = sum(f.stat().st_size for f in Path(ckdir).rglob("*") if f.is_file())
        second = TrainDriver(step_fn, first.state, batch_fn, conf)   # restores over this
        report = second.run()
        # the uninterrupted run: the first run's in-memory state, stepped on with no save or restore
        sync()
        t1 = time.perf_counter()
        state, m = step_fn(first.state, batch_fn(first.step))
        sync()
        loop_ms = (time.perf_counter() - t1) * 1e3
        n_float = sk.float_launches
        peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
        n_steps = len(first.step_times) + len(second.step_times) + 1
        step_ms = [t * 1e3 for t in first.step_times + second.step_times] + [loop_ms]
        losses = [x["loss"] for x in first.metrics_log + second.metrics_log]
        print(f"  (b) {cfg.name} at {B} x {S} through TrainDriver: a failure injected at step "
              f"{LM['fail_at']} after the checkpoint of step {LM['fail_at']} ({failed}), a relaunch "
              f"restored it and finished step {report['final_step']}; the first run's in-memory "
              f"state stepped on beside it; steps {', '.join(f'{t:.1f}' for t in step_ms)} ms "
              f"({sum(step_ms[1:]) / len(step_ms[1:]):.1f} ms a step after the first); peak device "
              f"memory {peak} bytes; losses {', '.join(f'{x:.6f}' for x in losses)}; checkpoint "
              f"{ck_bytes} bytes, saves {', '.join(f'{t:.2f}' for t in first.save_walls + second.save_walls)} s, "
              f"restore {second.restore_wall or 0.0:.2f} s; float kernel launches {n_float} in "
              f"{n_steps} steps ({n_float / n_steps:.1f} a step) ({card})")
        check(failed and second.restore_wall is not None and report["final_step"] == LM["steps"],
              f"the driver failed at step {LM['fail_at']}, restored step {LM['fail_at']} and "
              f"finished step {LM['steps']}")
        check(all(math.isfinite(x) for x in losses), f"{len(losses)} training losses finite")
        check(second.metrics_log[-1]["loss"] == float(m["loss"]),
              f"the restarted step's logged loss bit-equal to the uninterrupted run's "
              f"({second.metrics_log[-1]['loss']!r} == {float(m['loss'])!r})")
        check(all(a.dtype == b.dtype and torch.equal(a, b)
                  for a, b in zip(leaves(second.state), leaves(state))),
              "after the restart: parameters, AdamW moments and count bit-equal to the "
              "uninterrupted run's")
        if on_card:
            check(n_float == n_steps * max(cfg.train_microbatches, 1),
                  f"one float kernel launch a step, the embedding gather's backward ({n_float} == "
                  f"{n_steps})")
        params = second.state[0]
        del first, second, state, m, report
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    print(f"  (b) in {time.perf_counter() - t0:.1f} s")

    # c. the trained weights served through prefill on the flash kernel
    t0 = time.perf_counter()
    sb, ss = (2, 64) if small else LM["serve"]
    prompts = batch(sb, ss, 99, dev)[0].long()
    fa.launches = 0
    served = serve.generate(M.cast_params(params), cfg, prompts, 1).prefill_logits
    n_flash = fa.launches
    with torch.no_grad():
        h, _ = M.forward_hidden(params, cfg, prompts)
        ref = M.logits_from_hidden(params, cfg, h[:, -1:])[:, 0].float()
        h, _ = M.forward_hidden(params, cfg, prompts, dtype=torch.float32)
        exact = M.logits_from_hidden(params, cfg, h[:, -1:])[:, 0]
    if on_card:
        check(n_flash == cfg.n_layers, f"the trained weights' prefill launched the flash kernel "
              f"once a layer ({n_flash} == {cfg.n_layers})")
    held(f"the trained weights served at {sb} x {ss}: prefill's last-position logits (flash "
         f"kernel) against forward_hidden's (the training attention, reference route) and a "
         f"float32 evaluation", checks.hold_bf16(served, ref, exact), "bf16")
    del params, served, ref, exact, prompts, h
    torch.backends.cuda.matmul.allow_tf32 = tf32
    if on_card:
        torch.cuda.empty_cache()
    print(f"  (c) in {time.perf_counter() - t0:.1f} s")

    # a, held: the CPU route's thread joined
    t0 = time.perf_counter()
    worker.join()
    torch.set_num_threads(threads)
    check("out" in plain, f"the CPU bf16 route's step at {b1} x {s1} ran ({plain['s']:.2f} s, "
          f"in a thread of {LM['cpu_threads'] if on_card else threads} threads)")
    if "out" in plain:      # compared on the card, where the card's results are
        plain["out"] = [[x.to(dev) for x in part] for part in plain["out"]]
        names = ["loss", "grad norm"] + ["grads" + "".join(f"[{k!r}]" for k in p)
                                         for p in LM_GRAD_LEAVES]
        for i, name in enumerate(names):
            what = (f"{cfg.name} train step at {b1} x {s1}, {name}: card against the CPU bf16 "
                    f"route (reference route) and a float32 evaluation")
            if i < 2:
                held(what, checks.hold_bf16(kern[0][i], plain["out"][0][i], f32[0][i]), "bf16")
            else:   # a gradient leaf after 24 bf16 layers: the LM rule (PERF.md section 2)
                held(what, checks.hold_bf16_noise(kern[0][i], plain["out"][0][i], f32[0][i]),
                     "bf16 noise")
        held(f"{cfg.name} train step at {b1} x {s1}, updated parameters: card against the CPU "
             f"bf16 route and a float32 evaluation", checks.hold_bf16(kern[1], plain["out"][1],
                                                                        f32[1]), "bf16")
    del kern, f32, plain, cpu_params
    print(f"  (a) held in {time.perf_counter() - t0:.1f} s; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s")
    return n_float, n_flash


# MoE and the sliding window: qwen2-moe-a2.7b served at full width and depth, then cut to 2 and 1
# layers against the CPU; mixtral-8x22b at full width, 2 of its 56 layers, past its window's roll;
# one Mixtral train step at full width, 1 layer. The phase's budget is 75 s.
MOE = {"arch": "qwen2-moe-a2.7b", "seed": 0, "batch": 8, "prompt": 2048, "gen": 32,
       "hold": (1, 128), "hold_layers": 2, "train_layers": 1, "cpu_threads": 6,
       "swa_arch": "mixtral-8x22b", "swa_layers": 2, "swa_prompt": 9000, "swa_gen": 16,
       "swa_train": (1, 9216), "budget_s": 75.0}


def route_check(torch, card: list, cpu: list, f32: list, K: int, n_experts: int) -> dict:
    """Hold the card's routing against the CPU bf16 route's, call by call
    (``generate``'s ``routes`` records; the CPU route and the float32
    evaluation ran on the card's experts, so no earlier difference moves
    their inputs). The router's log-probabilities over the real experts are held by the LM
    rule: the card within ``tol`` of the CPU route, ``tol`` twice the CPU
    route's distance from the float32 evaluation. A token whose set of top-K
    experts on the CPU (its own top K) differs from the card's is a
    near-tie that rounding may order either way only where the card's logit
    margin log(p_K / p_(K+1)) there is within ``tol``. Returns ``ok``, the
    tokens compared, the largest distance over ``tol``, and the flips as
    (call, row, token, margin, tol)."""
    n, ratio, flips, ok = 0, 0.0, [], True
    for c, (a, b, e) in enumerate(zip(card, cpu, f32)):
        la, lb, le = (torch.log(r["probs"][..., :n_experts].cpu().double()) for r in (a, b, e))
        tol = 2 * float((lb - le).abs().max())
        err = float((la - lb).abs().max())
        ok = ok and err <= tol
        ratio = max(ratio, err / tol) if tol else (math.inf if err > 0 else ratio)
        mine = a["gate_i"].cpu().sort(-1).values
        own = torch.topk(b["probs"].cpu(), K, dim=-1).indices.sort(-1).values
        diff = (mine != own).any(-1)
        n += diff.numel()
        if diff.any():
            top = torch.topk(a["probs"].cpu().double(), K + 1, dim=-1).values
            margin = torch.log(top[..., K - 1] / top[..., K])
            for i, j in diff.nonzero().tolist():
                flips.append((c, i, j, round(float(margin[i, j]), 6), round(tol, 6)))
                ok = ok and float(margin[i, j]) <= tol
    return {"ok": ok, "n": n, "ratio": ratio, "flips": flips}


def moe_and_window(torch, np, dev, st_flash, st_float, smi, small: bool = False) -> tuple[int, int]:
    """Phase 25: MoE and sliding-window attention. (a) ``qwen2-moe-a2.7b`` at
    full width and depth, bf16 weights drawn on the card, served at 8 x 2,048
    + 32 through ``launch.serve``; (b) the same model cut to 2 layers at 1 x
    128 (prefill and 4 decode steps) on the card, the CPU's bf16 route and
    a float32 evaluation on the card, routing compared call by call; cut to 1
    layer, a train step's loss and gradient, the CPU's in a thread beside (c)
    and (d); (c)
    ``mixtral-8x22b`` at full width, 2 of 56 layers: a prompt of 9,000 past
    its window of 4,096, the rolling cache checked slot by slot, 16 decode
    steps past the roll, layer 0's decode attention against the plain
    windowed attention over the whole sequence, the windowed flash kernel
    timed beside SDPA with the same mask; (d) one Mixtral train step at full
    width, 1 layer, 1 x 9,216 (loss and gradient), its sliced training
    attention against the unsliced one, and the float kernel timed at its
    dispatch's backward. Returns the flash kernel's launches and the float
    segment sum's in the main-path runs. ``small`` (the CPU rehearsal) runs
    the SMOKE configs at small shapes."""
    import dataclasses
    import threading

    import torch.nn.functional as F

    from repro_torch import checks
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.data import synth_lm_batch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.segment_sum import ops as sk
    from repro_torch.launch import serve
    from repro_torch.models.autodiff import value_and_grad
    from repro_torch.models.transformer import model as M
    from repro_torch.obs.profile import format_profile, profile_call
    from repro_torch.tree import leaves, map_tree

    on_card = dev.type == "cuda"
    card = smi.replace("\n", "; ") if smi else "no card"
    cpu = torch.device("cpu")
    bf16 = M.COMPUTE_DTYPE
    t_phase = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False     # routes and the float32 evaluations
    n_flash = n_float = 0

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def peak_reset():
        if on_card:
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)

    def peak():
        return torch.cuda.max_memory_allocated(dev) if on_card else 0

    def draw(c, dtype):
        """``c``'s weights from the seed: drawn on the card a layer at a time,
        or on the CPU in the rehearsal (bf16 in ``cast_params``' form)."""
        if on_card:
            return M.init_params(c, MOE["seed"], dtype=dtype, device=dev, on_device=True)
        p = M.init_params(c, MOE["seed"], device=cpu)
        return M.cast_params(p) if dtype == bf16 else p

    # a. qwen2-moe-a2.7b at full width and depth through launch.serve
    t0 = time.perf_counter()
    cfg = (get_smoke if small else get_config)(MOE["arch"])
    params = serve.make_params(cfg, MOE["seed"], dev)
    sync()
    n_weights = sum(t.numel() for t in leaves(params))
    w_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    print(f"  (a) {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.moe.n_experts} "
          f"experts padded to {cfg.moe.e_pad}, top {cfg.moe.top_k}, {cfg.moe.n_shared} shared, "
          f"expert width {cfg.moe.d_ff_expert}, vocab {cfg.vocab}: {n_weights} weights "
          f"({w_bytes} bytes) drawn on the {'card' if on_card else 'CPU'} in "
          f"{time.perf_counter() - t0:.1f} s")
    B, P, G = MOE["batch"], MOE["prompt"] // (16 if small else 1), MOE["gen"]
    prompts = serve.make_prompts(cfg, B, P, dev)
    serve.generate(params, cfg, prompts, 2)          # warm-up: cuBLAS handles, the allocator
    peak_reset()
    fa.launches = 0
    trace = []
    res = serve.generate(params, cfg, prompts, G, routes=trace)
    launches = fa.launches
    n_flash += launches
    pk = peak()
    wall = res.prefill_s + res.decode_s
    pre = trace[:cfg.n_layers]
    dropped = sum(int((~r["keep"]).sum()) for r in pre)
    selected = sum(r["keep"].numel() for r in pre)
    decode_dropped = sum(int((~r["keep"]).sum()) for r in trace[cfg.n_layers:])
    T = P + G
    cache_bytes = 2 * cfg.n_layers * B * cfg.n_kv_heads * T * cfg.d_head * 2
    print(f"  (a) served {B} x {P} + {G}: prefill {res.prefill_s * 1e3:.3f} ms "
          f"({B * P / res.prefill_s:.1f} prompt tok/s); decode {res.decode_ms_per_token:.3f} ms a "
          f"token ({B * (G - 1) / res.decode_s:.1f} tok/s over {G - 1} steps); {B * G / wall:.1f} "
          f"tok/s end to end ({wall:.3f} s); peak device memory {pk} bytes (weights {w_bytes}, a "
          f"{T}-slot cache {cache_bytes}); flash launches {launches}; selections dropped by "
          f"capacity in prefill {dropped} of {selected} ({dropped / selected:.2%}; C = "
          f"{pre[0]['C']} a batch row), in decode {decode_dropped} ({card})")
    print(f"  (a) sample: {res.tokens[0][:12].tolist()}")
    if on_card:
        prof = serve.profile_serve(params, cfg, prompts, 4)
        print("  (a) under torch.profiler (same shapes, after the measured run; 3 decode steps):")
        print("\n".join("    " + line for line in format_profile(prof).splitlines()))
    logits = res.prefill_logits
    check(res.tokens.shape == (B, G) and bool(((res.tokens >= 0) & (res.tokens < cfg.vocab)).all())
          and tuple(logits.shape) == (B, cfg.vocab) and bool(torch.isfinite(logits).all()),
          f"{cfg.name} served {B} x {G} tokens in range, prefill logits ({B}, {cfg.vocab}) finite")
    check(len(trace) == cfg.n_layers * G and decode_dropped == 0,
          f"{cfg.name}: {len(trace)} MoE calls ({cfg.n_layers} a pass), no decode selection "
          f"dropped (C = 1 at S = 1)")
    if on_card:
        check(launches == cfg.n_layers,
              f"{cfg.name}'s prefill launched the flash kernel once a layer ({launches} == "
              f"{cfg.n_layers})")
    del params, res, trace, pre, logits, prompts
    print(f"  (a) in {time.perf_counter() - t0:.1f} s")

    # b. the same widths at 2 layers on the card, the CPU and float32 on the card; 1 layer trained
    t0 = time.perf_counter()
    cfg2 = dataclasses.replace(cfg, n_layers=MOE["hold_layers"])
    params = draw(cfg2, bf16)
    cpu_params = M.params_to(params, cpu)
    f32 = map_tree(lambda t: t.float(), params)
    prompt1 = serve.make_prompts(cfg2, *MOE["hold"], cpu)
    G1 = 5
    # the CPU route and the float32 evaluation take the card's experts and tokens (forced), so
    # that their arithmetic is held like for like; their own routers' choices are compared apart
    got_trace, plain_trace, exact_trace = [], [], []
    got = serve.generate(params, cfg2, prompt1.to(dev), G1, keep_logits=True, routes=got_trace)
    t1 = time.perf_counter()
    plain = serve.generate(cpu_params, cfg2, prompt1, G1, forced=got.tokens, keep_logits=True,
                           routes=plain_trace, forced_routes=got_trace)
    cpu_s = time.perf_counter() - t1
    exact = serve.generate(f32, cfg2, prompt1.to(dev), G1, forced=got.tokens, keep_logits=True,
                           dtype=torch.float32, routes=exact_trace, forced_routes=got_trace)
    K = cfg2.moe.top_k
    r = route_check(torch, got_trace, plain_trace, exact_trace, K, cfg2.moe.n_experts)
    n32 = sum(int((r32["gate_i"].cpu().sort(-1).values != torch.topk(
        r32["probs"].cpu(), K, dim=-1).indices.sort(-1).values).any(-1).sum())
        for r32 in exact_trace)
    check(len(got_trace) == len(plain_trace) == cfg2.n_layers * G1 and r["ok"],
          f"{cfg2.name} at {cfg2.n_layers} layers, {MOE['hold'][0]} x {MOE['hold'][1]} + "
          f"{G1 - 1} steps, {r['n']} token routings: the card's router log-probabilities within "
          f"the LM rule of the CPU bf16 route's ({cpu_s:.1f} s; largest distance {r['ratio']:.2f} "
          f"of its tolerance, twice the CPU route's distance from float32); the top-{K} experts "
          + ("identical" if not r["flips"] else
             f"differ at {len(r['flips'])} token(s), each a near-tie within the tolerance (call, "
             f"row, token, the card's logit margin between its K-th and next expert, tolerance): "
             f"{r['flips'][:12]}") + f"; the float32 evaluation's own top {K} differs from the "
          f"card's at {n32}")
    for i, (a, b, c) in enumerate(zip([got.prefill_logits] + got.step_logits,
                                      [plain.prefill_logits] + plain.step_logits,
                                      [exact.prefill_logits] + exact.step_logits)):
        held(f"{cfg2.name} at {cfg2.n_layers} layers, {'prefill' if i == 0 else f'decode step {i}'}"
             f" logits: card against the CPU bf16 route (reference route) and a float32 "
             f"evaluation on the card, both on the card's experts",
             checks.hold_bf16_noise(a, b, c), "bf16 noise")
    del params, cpu_params, f32, got, plain, exact, got_trace, plain_trace, exact_trace

    cfg1 = dataclasses.replace(cfg, n_layers=MOE["train_layers"])
    p32 = draw(cfg1, torch.float32)
    cpu32 = M.params_to(p32, cpu)
    tok, lab = (torch.from_numpy(a) for a in synth_lm_batch(cfg1.vocab, *MOE["hold"],
                                                            seed=MOE["seed"], step=0))

    def one_step(p, t, lb, dtype):
        """A train step's loss (0.01 x aux included), aux and gradient norm.
        Its AdamW update is left out: at count 0 the warmup scales the
        learning rate to 3e-6, which moves no weight by a bf16 ulp, and on
        the CPU it took as long as the gradient."""
        loss, grads = value_and_grad(lambda q: M.lm_loss(q, cfg1, t, lb, dtype=dtype), p)
        with torch.no_grad():
            aux = M.forward_hidden(p, cfg1, t, dtype)[1]
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                     for g in leaves(grads)]))
        return [loss, aux, norm]

    step_cpu, threads = {}, torch.get_num_threads()

    def cpu_route():
        t1 = time.perf_counter()
        try:
            step_cpu["out"] = one_step(cpu32, tok, lab, bf16)
        finally:
            step_cpu["s"] = time.perf_counter() - t1

    if on_card:     # leave the card's launches their own cores
        torch.set_num_threads(min(threads, MOE["cpu_threads"]))
    worker = threading.Thread(target=cpu_route, daemon=True)
    worker.start()
    step_card = one_step(p32, tok.to(dev), lab.to(dev), bf16)
    step_f32 = one_step(p32, tok.to(dev), lab.to(dev), torch.float32)
    del p32
    print(f"  (b) in {time.perf_counter() - t0:.1f} s, the CPU's train step of {cfg1.name} at "
          f"{cfg1.n_layers} layer in a thread beside (c) and (d); card loss "
          f"{float(step_card[0]):.6f}, aux {float(step_card[1]):.6f}")

    # c. mixtral-8x22b at full width, 2 of its layers, past the roll of its window
    t0 = time.perf_counter()
    cfgm = dataclasses.replace((get_smoke if small else get_config)(MOE["swa_arch"]),
                               n_layers=MOE["swa_layers"])
    win = cfgm.swa_window
    Pm, Gm = (72, MOE["swa_gen"]) if small else (MOE["swa_prompt"], MOE["swa_gen"])
    peak_reset()
    params = draw(cfgm, bf16)
    w_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    prompt = serve.make_prompts(cfgm, 1, Pm, dev)
    cache = M.init_kv_cache(cfgm, 1, Pm + Gm, device=dev)
    T = cache["k"].shape[3]
    fa.launches = 0
    sync()
    t1 = time.perf_counter()
    logits, cache = M.prefill(params, cfgm, prompt, cache=cache)
    sync()
    prefill_ms = (time.perf_counter() - t1) * 1e3
    n_flash += fa.launches
    check(fa.launches == (cfgm.n_layers if on_card else 0) and T == win,
          f"{cfgm.name} at {cfgm.n_layers} layers: prefill of {Pm} ({Pm % win} past a multiple "
          f"of the window {win}) into a {T}-slot rolling cache, {fa.launches} flash launches")
    full = {k: torch.zeros((cfgm.n_layers, 1, cfgm.n_kv_heads, Pm, cfgm.d_head), dtype=bf16,
                           device=dev) for k in ("k", "v")}
    M.prefill(params, cfgm, prompt, cache=full)       # every position at slot p
    held_pos = torch.arange(Pm - T, Pm, device=dev)
    same = all(torch.equal(cache[k][:, :, :, held_pos % T], full[k][:, :, :, held_pos])
               for k in ("k", "v"))
    check(same, f"every layer's slot s of the rolling cache holds, bit for bit, the k and v "
          f"prefill computed for the position p = s (mod {T}) in [{Pm - T}, {Pm - 1}]")
    tok_m = logits.argmax(dim=-1, keepdim=True)
    sync()
    t1 = time.perf_counter()
    for i in range(Gm):
        step, cache = M.decode_step(params, cfgm, tok_m, cache, Pm + i)
        if i < Gm - 1:
            tok_m = step.argmax(dim=-1, keepdim=True)
    sync()
    decode_ms = (time.perf_counter() - t1) * 1e3 / Gm
    pos = Pm + Gm - 1
    check(bool(torch.isfinite(step).all()),
          f"{Gm} decode steps past the roll (positions {Pm}-{pos}, slots {Pm % T}-{pos % T}): "
          f"logits finite; prefill {prefill_ms:.3f} ms, decode {decode_ms:.3f} ms a token, "
          f"weights {w_bytes} bytes, peak device memory {peak()} bytes ({card})")
    # layer 0's decode attention at the last step against the plain windowed attention of the
    # same query over the whole sequence's k and v (prefill's for the prompt, decode's after)
    lp = M.unstack_layers(params["layers"], cfgm.n_layers)[0]
    h = M.rmsnorm(M._embed(params, tok_m, bf16), lp["norm1"], cfgm.norm_eps)
    posb = torch.full((1,), pos, dtype=torch.int32, device=dev)
    dec_slots = torch.arange(Pm, pos + 1, device=dev) % T
    seq = {k: torch.cat([full[k][0], cache[k][0][:, :, dec_slots]], dim=2) for k in ("k", "v")}
    with torch.no_grad():
        dec, _ = M.attention(h, lp["attn"], cfgm, posb, cache_pos=pos,
                             kv_cache={k: cache[k][0].clone() for k in ("k", "v")})
        outs = []
        for dtype in (bf16, torch.float32):
            attn = map_tree(lambda t: t.to(dtype), lp["attn"])
            q, _, _ = M._qkv(h.to(dtype), attn, cfgm, posb)
            o = M._attention_scores(q, seq["k"].transpose(1, 2).to(dtype),
                                    seq["v"].transpose(1, 2).to(dtype), posb,
                                    torch.arange(pos + 1, device=dev), win)
            outs.append(torch.matmul(o.reshape(1, 1, -1), attn["wo"]))
    held(f"layer 0's decode attention at position {pos} over the {T}-slot rolling cache against "
         f"the plain windowed attention of the same query over all {pos + 1} positions' k and v, "
         f"and its float32 evaluation", checks.hold_bf16(dec, outs[0], outs[1]), "bf16")
    del full, seq, cache, params, logits, step, outs, dec
    # the windowed flash kernel at this prefill's shape against its plain version, and timed
    # beside SDPA with the same boolean mask
    gen = torch.Generator(device=dev).manual_seed(25)
    hq, hkv, dh = cfgm.n_heads, cfgm.n_kv_heads, cfgm.d_head
    q = torch.randn((1, Pm, hq, dh), generator=gen, device=dev).to(bf16)
    k = torch.randn((1, Pm, hkv, dh), generator=gen, device=dev).to(bf16)
    v = torch.randn((1, Pm, hkv, dh), generator=gen, device=dev).to(bf16)
    flop, nbytes = fa.cost(1, Pm, Pm, hq, hkv, dh, 2, True, win)
    n_pairs = fa.pairs(Pm, Pm, True, win)
    bnd = bound_ms(nbytes, flop)
    out = fa.flash_attention(q, k, v, causal=True, window=win)
    # held against the plain version on the same inputs: one key-value head's group of query
    # heads at a time ((6, 9000, 9000) float32 scores), in bf16 and in float32, each block of
    # rows by the bf16 rule at its own largest magnitude (a row past the window averages 4,096
    # values of v, and is far smaller than the first rows)
    rep, rows = hq // hkv, 1000
    want, exact = torch.empty_like(out), torch.empty(out.shape, device=dev)
    for h in range(hkv):
        qg = q[0, :, h * rep:(h + 1) * rep].transpose(0, 1)
        kg, vg = k[0, :, h:h + 1].transpose(0, 1), v[0, :, h:h + 1].transpose(0, 1)
        want[0, :, h * rep:(h + 1) * rep] = fa.attention_ref(qg, kg, vg, window=win).transpose(0, 1)
        exact[0, :, h * rep:(h + 1) * rep] = fa.attention_ref(
            qg.float(), kg.float(), vg.float(), window=win).transpose(0, 1)
    r_out, ok_out = None, True
    for b0 in range(0, Pm, rows):
        blk = slice(b0, b0 + rows)
        r = checks.hold_bf16(out[:, blk], want[:, blk], exact[:, blk])
        r.update(ratio=r["err64"] / (r["ref64"] + r["ulp"]), block=f"{b0}-{min(b0 + rows, Pm) - 1}",
                 top=float(exact[:, blk].abs().max()))
        ok_out = ok_out and r["ok"]
        if r_out is None or r["ratio"] > r_out["ratio"]:
            r_out = r
    err = float((out.float() - want.float()).abs().max())
    err_late = float((out[:, win:].float() - want[:, win:].float()).abs().max())
    top_late = float(exact[:, win:].abs().max())
    st_flash["err"] = max(st_flash["err"], err)
    st_flash["rule_ratio"] = max(st_flash.get("rule_ratio", 0.0), r_out["ratio"])
    del want, exact
    ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, causal=True, window=win), 10)
    dev_ms = device_ms(torch, lambda: fa.flash_attention(q, k, v, causal=True, window=win), 5,
                       "flash_")
    qp = torch.arange(Pm, device=dev)
    mask = (qp[None, :] <= qp[:, None]) & (qp[None, :] > qp[:, None] - win)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k.repeat_interleave(hq // hkv, dim=2),
                                              v.repeat_interleave(hq // hkv, dim=2)))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

    lib = time_ms(torch, sdpa, 10)
    lib_dev = device_ms(torch, sdpa, 5, "sdpa")      # its attention kernel alone
    lib_err = float((sdpa().transpose(1, 2).float() - out.float()).abs().max())
    backend = "not measured on the CPU"
    for _ in range(3 if on_card else 0):     # the trace comes back empty now and then
        _, rec = profile_call(sdpa, dev, top=3)
        backend = "; ".join(name[:80] for name, _, _ in rec["top"])
        if backend:
            break
    st_flash.setdefault("timed", {})["mixtral windowed prefill"] = dict(
        ms=ms, device_ms=dev_ms, library_ms=lib, library_device_ms=lib_dev, bound_ms=bnd,
        tflops=flop / ms / 1e9, library_kernels=backend)
    check(ok_out,
          f"flash_attention at {cfgm.name}'s prefill (1 x {Pm}, {hq} over {hkv} heads, d {dh}, "
          f"causal, window {win}; {n_pairs} pairs) against attention_ref and its float32 "
          f"evaluation, in blocks of {rows} query rows, each by the bf16 rule (the kernel's "
          f"distance from float32 at most attention_ref's + 1 bf16 ulp of the block's largest "
          f"magnitude): worst block {r_out['block']} (|out| up to {r_out['top']:.3g}): kernel "
          f"{r_out['err64']:.3g}, attention_ref {r_out['ref64']:.3g}, ulp {r_out['ulp']:.3g} "
          f"({r_out['ratio']:.2f} of its allowance); max|kernel - attention_ref| {err:.3g} over "
          f"all rows, {err_late:.3g} over rows {win} on (|out| up to {top_late:.3g}); "
          f"{ms:.4f} ms a call ({flop / ms / 1e9:.1f} TFLOP/s; {dev_ms or 0.0:.4f} ms on the "
          f"device), scaled_dot_product_attention with the boolean window mask {lib:.4f} ms a "
          f"call ({lib_dev or 0.0:.4f} ms in its attention kernel on the device; the costliest "
          f"kernels of a call: {backend}; max|SDPA - kernel| {lib_err:.3g}), bound {bnd:.4f} ms "
          f"({flop:.4g} FLOP, {nbytes} bytes), {bnd / ms:.1%} of it ({card})")
    del q, k, v, qt, kt, vt, mask, out
    print(f"  (c) in {time.perf_counter() - t0:.1f} s")

    # d. one Mixtral train step at full width, 1 layer: loss and gradient; its sliced attention
    t0 = time.perf_counter()
    cfgt = dataclasses.replace(cfgm, n_layers=1)
    bt, stl = (1, 1024) if small else MOE["swa_train"]
    peak_reset()
    base = torch.cuda.memory_allocated(dev) if on_card else 0
    p32 = draw(cfgt, torch.float32)
    tt, lt = (torch.from_numpy(a).to(dev) for a in synth_lm_batch(cfgt.vocab, bt, stl,
                                                                  seed=MOE["seed"], step=0))
    sk.float_launches = 0
    sync()
    t1 = time.perf_counter()
    loss, grads = value_and_grad(lambda p: M.lm_loss(p, cfgt, tt, lt), p32)
    sync()
    step_ms = (time.perf_counter() - t1) * 1e3
    n_train_float = sk.float_launches
    n_float += n_train_float
    step_peak = peak() - base
    gnorm = float(torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                        for g in leaves(grads)])))
    check(math.isfinite(float(loss)) and math.isfinite(gnorm)
          and n_train_float == (1 + cfgt.n_layers if on_card else 0),
          f"{cfgt.name} train step at full width, {cfgt.n_layers} layer, {bt} x {stl} (no "
          f"optimizer): loss {float(loss):.6f} (0.01 x aux included), grad norm {gnorm:.6f}, "
          f"{step_ms:.1f} ms, peak device memory {step_peak} bytes above the {base} held at entry, "
          f"float kernel launches {n_train_float} (the embedding's and each layer's dispatch "
          f"backward) ({card})")
    del grads
    with torch.no_grad():
        lp = M.unstack_layers(p32["layers"], 1)[0]
        x = M.rmsnorm(M._embed(p32, tt, bf16), lp["norm1"], cfgt.norm_eps)
        posn = torch.arange(stl, device=dev)
        sync()
        t1 = time.perf_counter()
        sliced = M.train_attention(x, lp["attn"], cfgt, posn)
        sync()
        sliced_ms = (time.perf_counter() - t1) * 1e3
        # the unsliced yardstick: every chunk against all S keys, the window as a mask
        q, kk, vv = M._qkv(x, lp["attn"], cfgt, posn)
        rep = cfgt.n_heads // cfgt.n_kv_heads
        kf, vf = kk.repeat_interleave(rep, dim=2), vv.repeat_interleave(rep, dim=2)
        qf = q.reshape(bt, stl, cfgt.n_heads, cfgt.d_head)
        qc = min(512, stl) if stl % min(512, stl) == 0 else stl
        t1 = time.perf_counter()
        whole = torch.cat([M._attention_scores_mha(qf[:, c:c + qc], kf, vf, posn[c:c + qc], posn,
                                                   win) for c in range(0, stl, qc)], dim=1)
        whole = torch.matmul(whole.reshape(bt, stl, -1), lp["attn"]["wo"].to(bf16))
        sync()
        whole_ms = (time.perf_counter() - t1) * 1e3
        exact = M.train_attention(x.float(), lp["attn"], cfgt, posn)
    sliced_keys = M._key_window(1, qc, stl, win)
    held(f"{cfgt.name}'s training attention at {bt} x {stl} (chunks of {qc} queries each against "
         f"{'the ' + str(qc + win) + ' keys its window reaches' if sliced_keys else 'all keys'}; "
         f"{sliced_ms:.1f} ms) against the unsliced masked attention ({whole_ms:.1f} ms) and a "
         f"float32 evaluation", checks.hold_bf16(sliced, whole, exact), "bf16")
    check(sliced_keys is not None or small,
          f"{cfgt.name} at {stl} slices its keys: chunk 1 reads keys {sliced_keys}")
    del x, q, kk, vv, kf, vf, qf, sliced, whole, exact, p32
    # the float kernel at this step's dispatch backward: K x virtual_split rows a token
    per = cfgt.moe.top_k * cfgt.moe.virtual_split
    rows = torch.randn((bt * stl * per, cfgt.d_model), generator=gen, device=dev).to(bf16)
    float_case(torch, dev, st_float, rows,
               torch.arange(bt * stl, device=dev).repeat_interleave(per), bt * stl,
               f"MoE dispatch backward ({cfgt.name}, {bt} x {stl}, {per} slot rows a token)",
               timed=True)
    del rows
    print(f"  (d) in {time.perf_counter() - t0:.1f} s")

    # b, held: the CPU's train step joined
    t0 = time.perf_counter()
    worker.join()
    torch.set_num_threads(threads)
    check("out" in step_cpu, f"the CPU bf16 route's train step of {cfg1.name} at "
          f"{cfg1.n_layers} layer ran ({step_cpu['s']:.2f} s)")
    if "out" in step_cpu:
        for i, name in enumerate(["loss", "aux", "grad norm"]):
            held(f"{cfg1.name} train step at full width, {cfg1.n_layers} layer, {MOE['hold'][0]} x "
                 f"{MOE['hold'][1]}, {name}: card against the CPU bf16 route and a float32 "
                 f"evaluation", checks.hold_bf16(step_card[i], step_cpu["out"][i].to(dev),
                                                 step_f32[i]), "bf16")
    del step_card, step_f32, step_cpu, cpu32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    if on_card:
        torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    print(f"  (b) held in {time.perf_counter() - t0:.1f} s; phase wall {wall:.1f} s (budget "
          f"{MOE['budget_s']} s)")
    return n_flash, n_float


# the launchers' phase: the paper's example suite on phase 6's SPR graph and BZ cores, the two
# example launchers in process, the reference CI's two trace gates on the traces of phases 19 and
# 21, and three dry-run cells on the card, each a kernel's (configs/base.py's shapes; prefill_32k
# cut to batch 1, a shape the flash cases do not run, held on FLASH_ROWS of its rows at each end)
# the GNN mesh phase: GraphCast at full CONFIG on full_graph_sm's sizes (2,708 nodes, 5,278 edges:
# 10,556 arcs, 1,433 features, 7 classes) on one-process meshes of 2 and 4 shards; SchNet, EGNN
# and MACE on 128 molecules of 30 atoms (3,840 nodes, 16,384 arcs) on 4 shards; two gloo ranks of
# 2 shards each with the GraphCast step
MESH = {"shards": (2, 4), "ranks": 2, "seed": 0, "full_graph": (2708, 5278, 1433, 7),
        "molecules": (128, 30, 64), "budget_s": 45, "rank_timeout_s": 240}
# one rank of the two-process GraphCast run: the scatter and gather probes of the parent's inputs,
# forward and backward, and one train step; writes its outputs for the parent to compare
MESH_RANK_SCRIPT = r"""
import json, pickle, sys, time
import numpy as np
import torch
from repro_torch.distribution import collectives, compat
rank, nproc, port, device, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
compat.init_multiprocess(f"127.0.0.1:{port}", nproc, rank, timeout_s=120)
from repro_torch.kernels.segment_sum import ops as sk
from repro_torch.models.gnn import common, steps
from repro_torch.optim import adamw_init
from repro_torch.tree import leaves
inp = pickle.load(open(f"{d}/in.pkl", "rb"))
mesh = compat.global_mesh("shard", local_shards=inp["shards"] // nproc, device=device)
cfg, shape, batch = inp["cfg"], inp["shape"], inp["batch"]
step, _, _, _ = steps.build_train(cfg, shape, mesh)
lays = steps.mesh_layouts(cfg, shape, batch, mesh)
arcs = lays["layout"]
mine = lambda a: common._own_rows(torch.as_tensor(a), mesh).to(mesh.device)
probe = {}
h = mine(inp["h"]).to(torch.bfloat16).requires_grad_(True)
e = mine(inp["e"]).to(torch.bfloat16).requires_grad_(True)
sk.float_launches = 0
y = common.scatter_sum(e, arcs)
a, b = common.gather_rows_multi(h, (arcs.src, arcs.dst))
torch.autograd.backward([y, a, b], [mine(inp["gy"]).to(torch.bfloat16),
                                    mine(inp["ga"]).to(torch.bfloat16),
                                    mine(inp["gb"]).to(torch.bfloat16)])
probe_launches = sk.float_launches
for k, t in (("y", y), ("a", a), ("b", b), ("e_grad", e.grad), ("h_grad", h.grad)):
    probe[k] = t.detach().float().cpu().numpy()
params = {k: v for k, v in inp["params"].items()}
params = common.params_to(params, mesh.device)
staged = steps.stage_batch(batch, mesh)
step(params, adamw_init(params), staged, **lays)       # warm-up
torch.cuda.synchronize() if device == "cuda" else None
common.reset_branches()
sk.float_launches = 0
t0 = time.perf_counter()
with collectives.collective_bytes() as tally:
    new, opt, m = step(params, adamw_init(params), staged, **lays)
    loss = float(m["loss"])
wall = time.perf_counter() - t0
out = {"rank": rank, "device": str(mesh.device), "local_shards": mesh.local_shards,
       "probe": probe, "probe_launches": probe_launches, "wall_s": wall, "loss": loss,
       "grad_norm": float(m["grad_norm"]), "m": [t.cpu() for t in leaves(opt["m"])],
       "launches": sk.float_launches, "branches": json.loads(json.dumps(common.BRANCHES)),
       "collectives": tally}
pickle.dump(out, open(f"{d}/rank{rank}.pkl", "wb"))
print(json.dumps({"rank": rank, "ok": True}))
"""


def cora_sized_batch(np, common, d_feat: int, n_classes: int, n: int, m: int, seed: int):
    """A batch of a random simple graph of exactly ``n`` nodes and ``m``
    edges (2m arcs), as full_graph_sm's sizes need."""
    from repro_torch.graph.structs import Graph

    rng = np.random.default_rng(seed)
    e = rng.integers(0, n, size=(3 * m, 2))
    e = e[e[:, 0] != e[:, 1]]
    key = np.unique(np.minimum(e[:, 0], e[:, 1]) * n + np.maximum(e[:, 0], e[:, 1]))
    key = rng.permutation(key)[:m]
    g = Graph.from_edges(np.stack([key // n, key % n], 1), n=n)
    return common.batch_from_graph(g, d_feat, n_classes, seed=seed)


def gnn_mesh(torch, np, dev, st_float, smi, small: bool = False) -> int:
    """The GNN mesh phase: the float kernel's unrounded shard partial against
    its plain version at the mesh path's shapes, then train steps on flat
    meshes of one process (GraphCast on 2 and 4 shards; SchNet, EGNN and MACE
    on 4) and of two gloo processes (GraphCast, 2 shards each), each held
    against the one-device step on the card by phase 23's rule. Returns the
    float kernel's launches in the mesh steps. ``small`` (the CPU rehearsal)
    runs the SMOKE configs."""
    import os
    import pickle
    import socket
    import subprocess
    import tempfile

    from repro_torch import checks
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.configs.base import GNN_SHAPES, ShapeSpec
    from repro_torch.distribution import collectives, compat
    from repro_torch.kernels.segment_sum import ops as sk
    from repro_torch.models.gnn import common, steps
    from repro_torch.optim import adamw_init
    from repro_torch.tree import leaves

    on_card = dev.type == "cuda"
    card = smi.replace("\n", "; ") if smi else "no card"
    cfg_of = get_smoke if small else get_config
    t_phase = time.perf_counter()
    launches = 0

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    n, m_edges, d_feat, n_classes = MESH["full_graph"]
    full = cora_sized_batch(np, common, d_feat, n_classes, n, m_edges, MESH["seed"])
    full_shape = next(s for s in GNN_SHAPES if s.name == "full_graph_sm")
    B, atoms, bonds = MESH["molecules"]
    mol_shape = ShapeSpec("molecule", "molecule", {"n_nodes": atoms, "n_edges": bonds, "batch": B})

    # a. the kernel's unrounded partial: one shard's slice of a GraphCast block's messages
    t0 = time.perf_counter()
    rng = np.random.default_rng(27)
    gcfg = cfg_of("graphcast")
    E = full["src"].shape[0]
    per = E // 4
    ids = torch.as_tensor(full["dst"][:per].astype(np.int64), device=dev)
    lay = sk.segment_layout(ids, n)
    for dtype in (torch.bfloat16, torch.float32):
        v = torch.as_tensor(rng.standard_normal((per, gcfg.d_hidden)).astype(np.float32),
                            device=dev).to(dtype)
        got = sk.segment_sum_float_partial(v, lay)
        want = sk.segment_sum_float_ref(v.float(), ids, n)
        exact = torch.zeros((n, v.shape[1]), dtype=torch.float64, device=dev).index_add_(
            0, ids, v.double())
        excess, err = checks.segment_sum_excess(v, ids, n, got, want)
        excess64, _ = checks.segment_sum_excess(v, ids, n, got, exact)
        st_float["excess"] = max(st_float["excess"], excess)
        st_float["err"] = max(st_float["err"], err)
        rounded = sk.segment_sum_float(v, lay)
        check(got.dtype == torch.float32 and excess <= 0 and excess64 <= 0,
              f"segment_sum_float_partial {str(dtype)[6:]} shard slice ({per} arcs into {n} rows, "
              f"F {v.shape[1]}): float32 out, max|kernel - plain| {err:.3g} within the float32 "
              f"summation bound (excess {excess:.3g}; against float64 {excess64:.3g})")
        check(torch.equal(got.to(dtype), rounded),
              f"segment_sum_float_partial {str(dtype)[6:]}: rounded once, bit for bit the float "
              f"form's output")
    del v, got, want, exact, rounded
    print(f"  (a) the unrounded partial in {time.perf_counter() - t0:.1f} s ({card})")

    def timed_step(step, *args, **kw):
        step(*args, **kw)                                          # warm-up
        sync()
        common.reset_branches()
        sk.float_launches = 0
        t1 = time.perf_counter()
        with collectives.collective_bytes() as tally:
            res = step(*args, **kw)
            sync()
        return res, time.perf_counter() - t1, sk.float_launches, tally

    def run(cfg, shape, batch, d_in, ncls, shards):
        """One step on each mesh of ``shards`` after a warm-up, held against
        the one-device step (also timed after a warm-up) and a float64
        step from the same weights. Returns the weights, the one-device and
        float64 steps, and the float kernel's launches in the mesh steps."""
        params = steps.init_params(cfg, MESH["seed"], d_in=d_in, n_classes=ncls, device=dev)
        rule = "bf16" if cfg.kind in ("mace", "graphcast") else "float32"
        steps.build_train(cfg, shape, None)
        one_step = steps.make_train_step(cfg, shape)
        on = common.batch_to(batch, dev)
        one, one_wall, one_n, _ = timed_step(one_step, params, adamw_init(params), on)
        p64 = common.params_to(params, dtype=torch.float64)
        with common.plain_scatter():
            f64 = one_step(p64, adamw_init(p64), on)
        del on, p64
        total = 0
        for D in shards:
            mesh = compat.make_mesh((D,), ("data",), device=dev)
            step, _, _, _ = steps.build_train(cfg, shape, mesh)
            staged = steps.stage_batch(batch, mesh)
            lays = steps.mesh_layouts(cfg, shape, batch, mesh)
            res, wall, nl, tally = timed_step(step, params, adamw_init(params), staged, **lays)
            br = {k: dict(v) for k, v in common.BRANCHES.items()}
            total += nl
            print(f"  {cfg.name} ({cfg.n_layers} layers, d {cfg.d_hidden}) on {shape.name}, "
                  f"{D} shards in one process: step {wall * 1e3:.1f} ms (one device "
                  f"{one_wall * 1e3:.1f} ms, {one_n} float kernel launches); float kernel "
                  f"launches {nl} ({nl / D:.1f} a shard); scatters sharded "
                  f"{br['scatter']['sharded']}, unsharded {br['scatter']['unsharded']}; gathers "
                  f"sharded {br['gather']['sharded']}, unsharded {br['gather']['unsharded']}; "
                  f"collectives {tally['counts']}, {tally['total_bytes']:.0f} bytes on the wire "
                  f"(from the shapes); loss {float(res[2]['loss']):.6f} ({card})")
            check(br["scatter"]["sharded"] > 0 and br["gather"]["sharded"] > 0,
                  f"{cfg.name} on {D} shards took the sharded scatter and gather")
            if on_card:
                check(nl > 0, f"{cfg.name} on {D} shards launched the float kernel")
            for what, pick in [("loss", lambda o: o[2]["loss"]),
                               ("grad norm", lambda o: o[2]["grad_norm"]),
                               ("gradients (AdamW's first moments)", lambda o: leaves(o[1]["m"]))]:
                args = [common.params_to(pick(o), "cpu") for o in (res, one, f64)]
                r = checks.hold_bf16(*args) if rule == "bf16" else checks.hold(*args)
                held(f"{cfg.name} on {shape.name}, {D} shards, {what}: against the one-device "
                     f"step on the card (reference route)", r, rule)
            del staged, lays, res
        steps.build_train(cfg, shape, None)
        return params, one, f64, total

    # b. GraphCast at full CONFIG on 2 and 4 shards; SchNet, EGNN and MACE on 4
    t0 = time.perf_counter()
    gparams, gone, gf64, n_launch = run(gcfg, full_shape, full, d_feat, n_classes, MESH["shards"])
    launches += n_launch
    print(f"  (b) GraphCast in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for arch in ("schnet", "egnn", "mace"):
        cfg = cfg_of(arch)
        mol = common.batch_molecules(B, atoms, bonds, cfg.params.get("n_species", 10), seed=0)
        launches += run(cfg, mol_shape, mol, None, 0, (4,))[3]
    print(f"  (b) SchNet, EGNN and MACE in {time.perf_counter() - t0:.1f} s")

    # c. two gloo ranks of 2 shards each: probes bit-equal to 4 shards in one process, the step
    t0 = time.perf_counter()
    D = 4
    mesh = compat.make_mesh((D,), ("data",), device=dev)
    steps.build_train(gcfg, full_shape, mesh)
    arcs = steps.mesh_layouts(gcfg, full_shape, full, mesh)["layout"]
    prng = np.random.default_rng(28)
    E = full["src"].shape[0]
    probe_in = {k: prng.standard_normal(s).astype(np.float32) for k, s in
                (("h", (n, gcfg.d_hidden)), ("e", (E, gcfg.d_hidden)), ("gy", (n, gcfg.d_hidden)),
                 ("ga", (E, gcfg.d_hidden)), ("gb", (E, gcfg.d_hidden)))}
    t = {k: torch.as_tensor(v, device=dev).to(torch.bfloat16) for k, v in probe_in.items()}
    h, e = t["h"].clone().requires_grad_(True), t["e"].clone().requires_grad_(True)
    y = common.scatter_sum(e, arcs)
    a, b = common.gather_rows_multi(h, (arcs.src, arcs.dst))
    torch.autograd.backward([y, a, b], [t["gy"], t["ga"], t["gb"]])
    want = {"y": y, "a": a, "b": b, "e_grad": e.grad, "h_grad": h.grad}
    want = {k: v.detach().float().cpu().numpy() for k, v in want.items()}
    del t, h, e, y, a, b
    steps.build_train(gcfg, full_shape, None)
    ranks = MESH["ranks"]
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        with open(f"{d}/in.pkl", "wb") as f:
            pickle.dump({"shards": D, "cfg": gcfg, "shape": full_shape, "batch": full,
                         "params": common.params_to(gparams, "cpu"), **probe_in}, f)
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        t1 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, "-c", MESH_RANK_SCRIPT, str(r), str(ranks),
                                   str(port), dev.type, d], stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
                 for r in range(ranks)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=MESH["rank_timeout_s"]))
        except subprocess.TimeoutExpired:
            outs = [("", "timed out")] * ranks
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        wall = time.perf_counter() - t1
        reps = []
        for rank, (p, (_, err)) in enumerate(zip(procs, outs)):
            ok = p.returncode == 0 and os.path.exists(f"{d}/rank{rank}.pkl")
            check(ok, f"mesh rank {rank} ran{'' if ok else ': ' + err[-2000:]}")
            if ok:
                with open(f"{d}/rank{rank}.pkl", "rb") as f:
                    reps.append(pickle.load(f))
    if len(reps) == ranks:
        for rep in reps:
            launches += rep["launches"] + rep["probe_launches"]
            print(f"    rank {rep['rank']}: device {rep['device']}, {rep['local_shards']} of {D} "
                  f"shards; step {rep['wall_s'] * 1e3:.1f} ms; float kernel launches "
                  f"{rep['launches']} ({rep['launches'] / rep['local_shards']:.1f} a local shard); "
                  f"branches {rep['branches']}; collectives {rep['collectives']['counts']}, "
                  f"{rep['collectives']['total_bytes']:.0f} bytes; loss {rep['loss']:.6f}")
            if on_card:
                check(rep["device"].startswith("cuda") and rep["launches"] > 0,
                      f"mesh rank {rep['rank']} ran on the card and launched the float kernel")
        for k in want:
            parts = [rep["probe"][k] for rep in reps]
            two = np.concatenate(parts) if parts[0].shape[0] != want[k].shape[0] else parts[0]
            check(np.array_equal(two, want[k]),
                  f"GraphCast probe {k}: {ranks} processes of {D // ranks} shards bit-equal to "
                  f"{D} shards in one process (bf16 (n, {gcfg.d_hidden}) rows, {E} arcs)")
        check(reps[0]["loss"] == reps[1]["loss"], "both ranks report one loss")
        rule = "bf16"
        for what, pick in [("loss", lambda o: o["loss"]), ("grad norm", lambda o: o["grad_norm"]),
                           ("gradients (AdamW's first moments)", lambda o: o["m"])]:
            got = pick(reps[0])
            args = [torch.as_tensor(got) if not isinstance(got, list) else got,
                    common.params_to(gone[2]["loss"] if what == "loss" else
                                     gone[2]["grad_norm"] if what == "grad norm"
                                     else leaves(gone[1]["m"]), "cpu"),
                    common.params_to(gf64[2]["loss"] if what == "loss" else
                                     gf64[2]["grad_norm"] if what == "grad norm"
                                     else leaves(gf64[1]["m"]), "cpu")]
            held(f"{gcfg.name} on {ranks} gloo processes, {what}: against the one-device step on "
                 f"the card (reference route)", checks.hold_bf16(*args), rule)
    print(f"  (c) {ranks} processes in {wall:.1f} s with start-up; (c) in "
          f"{time.perf_counter() - t0:.1f} s")
    del gparams, gone, gf64
    if on_card:
        torch.cuda.empty_cache()
    spent = time.perf_counter() - t_phase
    print(f"  phase wall {spent:.1f} s (budget {MESH['budget_s']} s; {card})")
    return launches


TRACE_DIR = ROOT / "build" / "traces"
LAUNCH = {"budget_s": 30,
          "cells": (("din", "serve_bulk", None), ("graphcast", "full_graph_sm", None),
                    ("qwen1.5-0.5b", "prefill_32k", 1)),
          "flash_rows": 512, "small_cell": ("din", "serve_bulk", 64)}
QUICKSTART = ("Fig-1 cores :", "FC-analogue:", "messages per round:", "block-GS:")
PAPER_SECTIONS = ("=== Table I row (FC) ===", "=== Fig 5: total messages ===",
                  "=== Fig 6/7: messages per round ===", "=== Fig 8/9: active nodes per round ===",
                  "=== termination detection (paper SIII.C vs BSP) ===",
                  "=== Fig 10 analogue: simulated runtime ===")


def captured(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), its stdout, the exception it raised or None)``."""
    import contextlib
    import io

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            return fn(*args, **kwargs), buf.getvalue(), None
    except Exception as e:  # noqa: BLE001 (reported as a failed check)
        return None, buf.getvalue(), e


def flash_rows_held(torch, dev, st, S: int, H: int, d: int, rows: int, block: int = 64) -> None:
    """The flash kernel at (1, S, H, d) bf16, causal, against its plain
    version and its float32 evaluation on its first and last ``rows`` query
    rows (the last against all S keys, from position S - rows), in blocks of
    ``block`` rows, each by the bf16 rule at its own largest magnitude: a
    late row averages about S values of v and is far smaller than the first
    rows, so one tolerance for all rows would let a late row's error pass."""
    from repro_torch import checks
    from repro_torch.kernels.flash_attention import ops as fa

    gen = torch.Generator(device=dev).manual_seed(26)
    q, k, v = (torch.randn((1, S, H, d), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    out = fa.flash_attention(q, k, v, causal=True)
    flat = [t[0].transpose(0, 1) for t in (q, k, v)]               # (H, S, d)
    err, ok, worst = 0.0, bool(torch.isfinite(out).all()), None
    for r0 in (0, S - rows):
        args = (flat[0][:, r0:r0 + rows], flat[1][:, :r0 + rows], flat[2][:, :r0 + rows])
        want = fa.attention_ref(*args, causal=True, q_start=r0)
        exact = fa.attention_ref(*(a.float() for a in args), causal=True, q_start=r0)
        got = out[0, r0:r0 + rows].transpose(0, 1)
        err = max(err, float((got.float() - want.float()).abs().max()))
        for b0 in range(0, rows, block):
            blk = slice(b0, b0 + block)
            r = checks.hold_bf16(got[:, blk], want[:, blk], exact[:, blk])
            r.update(ratio=r["err64"] / (r["ref64"] + r["ulp"]),
                     block=f"{r0 + b0}-{r0 + min(b0 + block, rows) - 1}",
                     top=float(exact[:, blk].abs().max()))
            ok = ok and r["ok"]
            if worst is None or r["ratio"] > worst["ratio"]:
                worst = r
        del want, exact
    st["err"] = max(st["err"], err)
    st["rule_ratio"] = max(st.get("rule_ratio", 0.0), worst["ratio"])
    check(ok, f"flash_attention at 1 x {S}, {H} heads, d {d}, causal, bf16: rows [0, {rows}) and "
              f"[{S - rows}, {S}) against attention_ref and its float32 evaluation, in blocks of "
              f"{block} rows, each by the bf16 rule (the kernel's distance from float32 at most "
              f"attention_ref's + 1 bf16 ulp of the block's largest magnitude): worst block "
              f"{worst['block']} (|out| up to {worst['top']:.3g}): kernel {worst['err64']:.3g}, "
              f"attention_ref {worst['ref64']:.3g}, ulp {worst['ulp']:.3g} ({worst['ratio']:.2f} "
              f"of its allowance); max|kernel - attention_ref| {err:.3g}")


def launchers_and_cells(torch, np, dev, g, core_bz, spr_fused, smi, stats, launches,
                        small: bool = False) -> None:
    """Phase 26: ``launch.paper_experiments.report`` on SPR against phase 6's
    BZ cores and fused bills, ``quickstart`` and ``paper_experiments`` through
    their ``main``, the trace gates, and ``dryrun --run`` on three cells, each
    held to its ``meta`` count, its bookings to the launch counters and its
    roofline share to at most 100 %. ``small`` (the CPU rehearsal) runs one
    cell on the CPU at a cut batch."""
    from repro_torch.kernels.kcore_hindex import ops as hk
    from repro_torch.kernels.segment_sum import ops as sk
    from repro_torch.launch import dryrun, paper_experiments, quickstart
    from repro_torch.obs import validate

    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    # (a) the paper's suite on SPR, BZ's cores given
    hk.launches = sk.launches = 0
    t0 = time.perf_counter()
    res, out, err = captured(paper_experiments.report, g, device=dev, core_ref=core_bz, name="SPR")
    wall = time.perf_counter() - t0
    launches["kcore_hindex"] += hk.launches
    launches["segment_sum"] += sk.launches
    for line in out.splitlines():
        print(f"    {line}")
    total = None if res is None else res.stats.total_messages
    check(err is None and np.array_equal(res.core, core_bz) and same_bills(res, spr_fused)
          and total == spr_fused.stats.total_messages,
          f"(a) paper_experiments.report on SPR: cores equal BZ, total_messages {total} and every "
          f"per-round bill equal to phase 6's fused run ({wall:.1f} s; launches: kcore_hindex {hk.launches}, "
          f"segment_sum {sk.launches}){'' if err is None else ': ' + repr(err)}")
    if on_card:
        check(hk.launches > 0 and sk.launches > 0, "(a) the suite launched both k-core kernels")
    # (b) the two launchers through their main
    dflag = ["--device", dev.type]
    for name, main, argv, want in (("quickstart", quickstart.main, dflag, QUICKSTART),
                                   ("paper_experiments", paper_experiments.main,
                                    ["--graph", "FC", "--scale", "0.05", *dflag], PAPER_SECTIONS)):
        hk.launches = sk.launches = 0
        t0 = time.perf_counter()
        _, out, err = captured(main, argv)
        launches["kcore_hindex"] += hk.launches
        launches["segment_sum"] += sk.launches
        lines = out.splitlines()
        card_line = not on_card or (lines and lines[0].startswith("device: "))
        missing = [w for w in want if not any(line.startswith(w) for line in lines)]
        check(err is None and not missing and card_line,
              f"(b) {name} {' '.join(argv)}: {len(lines)} lines, every section present"
              f"{', the card named first' if on_card else ''} ({time.perf_counter() - t0:.1f} s; "
              f"launches: kcore_hindex {hk.launches}, segment_sum {sk.launches})"
              f"{'' if not missing else ': missing ' + repr(missing)}"
              f"{'' if err is None else ': ' + repr(err)}")
    # (c) the reference CI's trace gates on the traces phases 19 and 21 exported
    for path, flags in ((TRACE_DIR / "kcore_run.json", ["--require-span", "kcore.decompose"]),
                        (TRACE_DIR / "kcore_serve.json",
                         ["--require-span", "batch", "--min-coverage", "0.95"])):
        rc, out, err = captured(validate.main, [str(path), *flags])
        check(rc == 0 and err is None,
              f"(c) python -m repro_torch.obs.validate {path.relative_to(ROOT)} {' '.join(flags)}: "
              f"exit {rc}: {out.strip() or err}")
    # (d) dry-run cells on the card: the count on the card against meta's
    cells = [LAUNCH["small_cell"]] if small else LAUNCH["cells"]
    for arch, shape, batch in cells:
        t0 = time.perf_counter()
        meta = dryrun.meta_count(arch, shape, batch=batch)
        run = dryrun.run_on_card(arch, shape, meta, batch=batch, device=dev)
        cut = f" --batch {batch}" if batch else ""
        if run["status"] != "OK":
            check(False, f"(d) dryrun --run {arch} x {shape}{cut}: {run}")
            continue
        for k, n in run["launches"].items():
            launches[k] = launches.get(k, 0) + n
        booked = {k: v["calls"] for k, v in run["by_kernel"].items()}
        print(f"    {arch} x {shape}{cut}: wall {run['wall_s'] * 1e3:.3f} ms, peak "
              f"{run['peak_bytes']} bytes ({run['peak_above_args_bytes']} above the arguments), "
              f"{run['flops']:.6e} FLOP, {run['bytes']:.6e} bytes, dominant {run['dominant']}, "
              f"bound {run['bound_s'] * 1e3:.3f} ms, share {run['roofline_share']:.2%}; booked "
              f"{booked}, launched {run['launches']} ({smi})")
        check(run["same_count_as_meta"],
              f"(d) {arch} x {shape}{cut}: FLOPs and bytes counted on {dev.type} equal the meta "
              f"count ({run['flops']} / {meta['flops']}, {run['bytes']} / {meta['bytes']})")
        if on_card:
            check(run["bookings_equal_launches"] and booked,
                  f"(d) {arch} x {shape}{cut}: each kernel's booked calls equal its launch "
                  f"counter ({booked} / {run['launches']})")
        check(run["roofline_share"] <= 1.0,
              f"(d) {arch} x {shape}{cut}: {run['roofline_share']:.2%} of the roofline bound, at "
              f"most 100 % ({time.perf_counter() - t0:.1f} s with the build)")
        if arch == "qwen1.5-0.5b" and on_card:
            from repro_torch.configs.registry import get_config, shape_by_name

            cfg = get_config(arch)
            flash_rows_held(torch, dev, stats["flash_attention"],
                            shape_by_name(arch, shape).params["seq_len"], cfg.n_heads,
                            cfg.d_head, LAUNCH["flash_rows"])
    if on_card:
        torch.cuda.empty_cache()
    print(f"  phase wall {time.perf_counter() - t_phase:.1f} s (budget {LAUNCH['budget_s']} s)")


def main(device: str = "cuda", spr_scale: float = SPR_SCALE) -> int:
    import numpy as np
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False: this needs an NVIDIA card")
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"FAIL: {ROOT / 'src' / 'repro_torch'} is missing: run from a checkout of the repo")
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import dispatch
    from repro_torch.core.bz import bz_core_numbers
    from repro_torch.core.kcore import _bs_iters, kcore_decompose
    from repro_torch.core.messages import work_bound
    from repro_torch.core.runtime import fused_converge_dense
    from repro_torch.graph import build_ell, generators
    from repro_torch.kernels import _build
    from repro_torch.kernels.kcore_hindex import ops as hk
    from repro_torch.kernels.segment_sum import ops as sk
    from repro_torch.launch import kcore_run
    from repro_torch.platform import device_summary, nvidia_smi_line

    t_start = time.perf_counter()
    dev = torch.device(device)
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    stats = {name: {"err": 0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": None}
             for name in KERNEL_FILES}
    stats["kcore_hindex"].update(buckets=[], device_ms=0.0)
    stats["segment_sum"].update(device_ms=None, timed={})
    stats["flash_attention"].update(err=0.0, err_f32=0.0, bound_by="operations")
    stats["embedding_bag"].update(err=0.0, excess=-BAG_TOL, err_bf16_ulps=0.0, device_ms=None)
    stats["segment_sum_float"].update(err=0.0, excess=-math.inf, device_ms=None, timed={})

    # ------------------------------------------------------------------ #
    phase("1. card")
    smi = nvidia_smi_line()
    print(smi if smi else "nvidia-smi: unavailable")
    card = device_summary(dev)
    kind, count = card["name"], card["count"]
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; device {kind!r}, "
          f"count {count}, power limit {card['power_limit']}")
    if device == "cuda":
        check(smi is not None, "nvidia-smi reports the card")

    # ------------------------------------------------------------------ #
    phase("2. build")
    if device == "cuda":
        t0 = time.perf_counter()
        secs = _build.build_all()
        print(f"built {sorted(secs)} in {time.perf_counter() - t0:.2f} s wall "
              f"({', '.join(f'{k} {v:.2f} s' for k, v in secs.items())})")
        for name in _build.SOURCES:
            for line in _build.ptxas_log(name).splitlines():
                if any(w in line for w in ("Compiling entry", "registers", "spill", "wgmma",
                                           "arning")):
                    print(f"  {name}: {line.strip()}")
            check("sm_90a" in _build.ptxas_log(name), f"{name} compiled for sm_90a")

    # the main path's graph, made once and used by phases 3 and 6
    t0 = time.perf_counter()
    g = generators.snap_analogue("SPR", spr_scale, seed=0)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    ell = build_ell(g)
    t_ell = time.perf_counter() - t0
    t0 = time.perf_counter()
    core_bz = bz_core_numbers(g)
    t_bz = time.perf_counter() - t0
    print(f"SPR analogue at scale {spr_scale}: n={g.n} m={g.m} arcs={g.num_arcs} "
          f"max_deg={g.max_deg} isolated={int((g.deg == 0).sum())} max_core={int(core_bz.max())}; "
          f"generated in {t_gen:.1f} s, ELL in {t_ell:.1f} s "
          f"({ell.padded_slots} slots), BZ in {t_bz:.1f} s")

    # ------------------------------------------------------------------ #
    phase("3. kernels against their plain versions")

    def hindex_case(nbr, est_u, n_iters, label, timed=False):
        got = hk.hindex_rows(nbr, est_u, n_iters)
        want = hk.hindex_rows_ref(nbr, est_u, n_iters)
        err = max_err(torch, got, want)
        st = stats["kcore_hindex"]
        st["err"] = max(st["err"], err)
        msg = f"kcore_hindex {label} R={nbr.shape[0]} W={nbr.shape[1]} n_iters={n_iters} bit-equal"
        if timed:
            reps = max(3, min(200, int(2e9 // max(nbr.numel() * 4, 1))))
            ms = time_ms(torch, lambda: hk.hindex_rows(nbr, est_u, n_iters), reps)
            dev_ms = device_ms(torch, lambda: hk.hindex_rows(nbr, est_u, n_iters), 5, "hindex")
            plain = time_ms(torch, lambda: hk.hindex_rows_ref(nbr, est_u, n_iters), 3, warmup=1)
            bnd = bound_ms(hk.cost(*nbr.shape)[1])
            st["ms"] += ms
            st["device_ms"] += dev_ms or 0.0
            st["plain_ms"] += plain
            st["bound_ms"] += bnd
            st["buckets"].append({"W": nbr.shape[1], "R": nbr.shape[0], "ms": ms,
                                  "device_ms": dev_ms, "plain_ms": plain, "bound_ms": bnd})
            msg += (f": {ms:.4f} ms a call, {dev_ms or 0.0:.4f} ms on the device (plain "
                    f"{plain:.3f} ms, bound {bnd:.4f} ms, {bnd / ms:.1%} of the call, "
                    f"{bnd / (dev_ms or ms):.1%} of the device time)")
        check(err == 0, msg)

    def ints(lo, hi, shape):
        return torch.as_tensor(rng.integers(lo, hi, shape).astype(np.int32), device=dev)

    # every variant's border width (a thread a row to 8 and to 32 slots, 8 threads to 128, a
    # warp to 512 and to 2048, a block beyond); probe counts that stop the replay part way;
    # rows whose h-index lies above the block variant's 8192-bin window (several passes)
    for rows, width, hi, n_iters in [(1, 8, 50, 7), (1001, 8, 50, 7), (9, 9, 50, 5),
                                     (130, 17, 50, 7), (64, 32, 50, 3), (33, 33, 100, 6),
                                     (65, 128, 300, 9), (65, 129, 300, 9), (17, 512, 1000, 11),
                                     (17, 513, 1000, 11), (77, 2048, 3000, 13), (5, 2049, 3000, 13),
                                     (3, 98432, 100000, 18), (1, 98432, 100000, 0),
                                     (1, 98432, 100000, 1), (1, 98432, 100000, 5),
                                     (1, 98432, 100000, 17), (1, 98432, 100000, 19),
                                     (4, 20000, 30000, 11), (40, 600, 50, 2)]:
        hindex_case(ints(0, hi, (rows, width)), ints(0, hi, rows), n_iters, "edge case")
    nbr = ints(0, 50, (33, 128))
    hindex_case(nbr, torch.zeros(33, dtype=torch.int32, device=dev), 7, "zero estimates")
    hindex_case(torch.zeros((9, 8), dtype=torch.int32, device=dev), ints(0, 9, 9), 5, "zero tiles")

    n_iters = _bs_iters(g.max_deg)
    deg_t = torch.as_tensor(g.deg, device=dev)
    tiles = dispatch._stage_ell(ell, dev)
    for est_name, est in [("degree seed", deg_t), ("cores", torch.as_tensor(core_bz, device=dev))]:
        est_ext = torch.cat([est, est.new_zeros(1)])
        for t in tiles:
            nbr_est = est_ext.index_select(0, t.nbrs).view(t.rows, t.width)
            hindex_case(nbr_est, est.index_select(0, t.ids), n_iters,
                        f"SPR bucket, {est_name},", timed=est_name == "degree seed")
            del nbr_est

    def segsum_case(vals, row_ptr, label, timed=False, seg_ids=None, main=False):
        got = sk.segment_sum(vals, row_ptr)
        want = sk.segment_sum_ref(vals, row_ptr)
        err = max_err(torch, got, want)
        st = stats["segment_sum"]
        st["err"] = max(st["err"], err)
        n = row_ptr.numel() - 1
        msg = f"segment_sum {label} E={vals.numel()} n={n} bit-equal"
        if timed:
            ms = time_ms(torch, lambda: sk.segment_sum(vals, row_ptr), 50)
            dev_ms = device_ms(torch, lambda: sk.segment_sum(vals, row_ptr), 5, "segment_sum")
            plain = time_ms(torch, lambda: sk.segment_sum_ref(vals, row_ptr), 5)
            lib = time_ms(torch, lambda: torch.zeros(n, dtype=torch.int32, device=dev)
                          .index_add_(0, seg_ids, vals), 20)
            bnd = bound_ms(sk.cost(vals.numel(), n)[1])
            st["timed"][label] = dict(E=vals.numel(), n=n, ms=ms, device_ms=dev_ms,
                                      plain_ms=plain, library_ms=lib, bound_ms=bnd)
            if main:
                st.update(ms=ms, device_ms=dev_ms, plain_ms=plain, library_ms=lib, bound_ms=bnd)
                # the wrapper's three kernels: the blocks' starts, the merge path, the carries
                split = {k: device_ms(torch, lambda: sk.segment_sum(vals, row_ptr), 5, k)
                         for k in ("path_search", "merge_path", "carries")}
                st["timed"][label]["device_ms_by_kernel"] = split
                print(f"  segment_sum {label} on the device by kernel: "
                      + ", ".join(f"{k} {v or 0.0:.4f} ms" for k, v in split.items()))
            msg += (f": {ms:.4f} ms a call, {dev_ms or 0.0:.4f} ms on the device (plain "
                    f"{plain:.3f} ms, index_add_ {lib:.4f} ms, bound {bnd:.4f} ms, {bnd / ms:.1%} "
                    f"of the call, {bnd / (dev_ms or ms):.1%} of the device time)")
        check(err == 0, msg)

    def csr(lengths):
        row_ptr = np.zeros(len(lengths) + 1, np.int64)
        np.cumsum(lengths, out=row_ptr[1:])
        return torch.as_tensor(row_ptr, device=dev)

    for e, n in [(1, 17), (0, 5), (33, 1), (1000, 10), (100_001, 70_000), (1_000_000, 3)]:
        layout = sk.csr_layout(np.sort(rng.integers(0, n, e)), n)
        segsum_case(ints(-2**31, 2**31, e), torch.as_tensor(layout.row_ptr, device=dev),
                    "edge case (wrapping sums, empty rows)")
    # one SPR-wide row among 10^6 empty rows; a view 4 bytes off a 16-byte boundary; E not a
    # multiple of 4; no arcs at all; runs of empty rows at both ends; rows of one arc
    wide = np.zeros(1_000_001, np.int64)
    wide[500_000] = 98_432
    segsum_case(ints(-2**31, 2**31, 98_432), csr(wide), "one 98,432-arc row among 10^6 empty rows")
    lengths = rng.integers(0, 40, 30_001)
    lengths[:1000] = lengths[-1000:] = 0
    x = ints(-2**31, 2**31, int(lengths.sum()) + 1)
    segsum_case(x[1:], csr(lengths), "a view of vals 4 bytes off 16, empty rows at both ends")
    odd = lengths.copy()
    odd[15_000] += 3 - int(odd.sum()) % 4 + 4          # E = 3 mod 4
    for lens, label in [(odd, "E not a multiple of 4"), (np.zeros(1_000_000, np.int64), "E = 0"),
                        (np.ones(1_000_003, np.int64), "every row one arc")]:
        segsum_case(ints(-2**31, 2**31, int(lens.sum())), csr(lens), label)
    ids = rng.integers(0, 1000, 5000)
    layout = sk.csr_layout(ids, 1000)
    vals = ints(0, 2**20, 5000)
    got = sk.segment_sum(vals.index_select(0, torch.as_tensor(layout.order, device=dev)),
                         torch.as_tensor(layout.row_ptr, device=dev))
    lib = torch.zeros(1000, dtype=torch.int32, device=dev).index_add_(
        0, torch.as_tensor(ids, device=dev), vals)
    check(torch.equal(got, lib), "segment_sum over unsorted ids (csr_layout) equals index_add_")
    src64 = torch.as_tensor(g.src.astype(np.int64), device=dev)
    spr_vals = ints(0, 2, g.num_arcs)
    segsum_case(spr_vals, torch.as_tensor(g.offsets, device=dev), "SPR arcs", timed=True,
                seg_ids=src64, main=True)
    # the degree skew alone: the widest SPR row by itself, and the SPR arcs without the rows
    # wider than 2,048 (those rows kept, empty)
    top = int(np.argmax(g.deg))
    s, e = int(g.offsets[top]), int(g.offsets[top + 1])
    segsum_case(spr_vals[s:e].clone(), torch.as_tensor([0, e - s], device=dev),
                "the widest SPR row alone", timed=True,
                seg_ids=torch.zeros(e - s, dtype=torch.int64, device=dev))
    narrow = torch.as_tensor(np.repeat(g.deg <= 2048, g.deg), device=dev)
    segsum_case(spr_vals[narrow], csr(np.where(g.deg <= 2048, g.deg, 0)),
                "SPR arcs without the rows wider than 2,048", timed=True, seg_ids=src64[narrow])
    del src64, spr_vals, narrow

    # ------------------------------------------------------------------ #
    phase(f"4. BZ-checked Table-I suite at scale {TABLE_I_SCALE}, host loop and fused")
    baseline = json.loads((ROOT / "benchmarks" / "static_baseline.json").read_text())["mean_ratio"]
    een, table1 = None, {}
    for abbrev in TABLE_I:
        ga = generators.snap_analogue(abbrev, TABLE_I_SCALE, seed=0)
        bz = bz_core_numbers(ga)
        host = kcore_decompose(ga, device=dev)
        fused = kcore_decompose(ga, fused=True, device=dev)
        ratio = round(host.stats.total_messages / max(work_bound(ga, host.core), 1), 4)
        print(f"  {abbrev}: n={ga.n} m={ga.m} rounds={host.rounds} "
              f"messages={host.stats.total_messages} ratio={ratio} (baseline {baseline[abbrev]}); "
              f"host {host.phase_s['converge'] * 1e3 / host.rounds:.3f} ms/round, fused "
              f"{fused.phase_s['device-converge'] * 1e3 / fused.rounds:.3f} ms/round")
        check(np.array_equal(host.core, bz) and np.array_equal(fused.core, bz),
              f"{abbrev} cores equal BZ (host loop and fused)")
        check(same_bills(host, fused) and host.converged and fused.converged,
              f"{abbrev} host loop and fused agree on rounds and per-round bills")
        check(ratio == baseline[abbrev], f"{abbrev} messages/work bound {ratio} == {baseline[abbrev]}")
        table1[abbrev] = (ga, bz, host)
        if abbrev == "EEN":
            een = (ga, host)

    # ------------------------------------------------------------------ #
    phase("5. masked route (segment-sum binary search, no ELL) on EEN")
    ga, host = een
    hk.launches = sk.launches = 0
    t0 = time.perf_counter()
    out = fused_converge_dense(ga.deg, np.ones(ga.n, bool), ga.src, ga.dst,
                               np.ones(ga.num_arcs, bool), ga.deg, n=ga.n,
                               n_iters=_bs_iters(ga.max_deg), max_rounds=ga.n + 1,
                               device=dev, ell=None)
    wall = time.perf_counter() - t0
    print(f"  n={ga.n} arcs={ga.num_arcs} rounds={out.rounds} in {wall * 1e3:.3f} ms "
          f"({wall * 1e3 / max(out.rounds, 1):.3f} ms a round, staging included); launches: "
          f"segment_sum {sk.launches}, kcore_hindex {hk.launches}")
    check(np.array_equal(out.est, host.core) and out.rounds == host.rounds
          and np.array_equal(out.msgs, host.stats.messages_per_round[1:])
          and np.array_equal(out.changed, host.stats.changed_per_round[1:])
          and np.array_equal(out.recv[:-1], host.stats.active_per_round[2:]),
          "masked route: cores, rounds and bills equal the ELL route's")
    if device == "cuda":
        check(sk.launches > 0 and hk.launches == 0,
              "masked route ran on the segment_sum kernel alone")

    # ------------------------------------------------------------------ #
    phase(f"6. full size: SPR at scale {spr_scale} through kcore_run, fused then host loop")
    runs = {}
    launches = {"kcore_hindex": 0, "segment_sum": 0}
    for label, argv in [("fused", ["--fused"]), ("host loop", [])]:
        args = kcore_run.parse_args(["--graph", "SPR", "--scale", str(spr_scale),
                                     "--device", device, "--json", *argv])
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        hk.launches = sk.launches = 0
        report, res = kcore_run.decompose_report(g, args, core_ref=core_bz)
        launches["kcore_hindex"] += hk.launches
        launches["segment_sum"] += sk.launches
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        runs[label] = res
        conv_s = res.phase_s.get("device-converge", res.phase_s.get("converge", 0.0))
        print(f"  {label}: n={report['n']} m={report['m']} rounds={report['rounds']} "
              f"total_messages={report['total_messages']} converged={report['converged']} "
              f"wall_s={report['wall_s']} phase_s={report['phase_s']} "
              f"ms/round={conv_s * 1e3 / max(res.rounds, 1):.3f} peak_bytes={peak} "
              f"launches: kcore_hindex {hk.launches}, segment_sum {sk.launches}")
        check(report["correct_vs_BZ"] and report["converged"], f"SPR {label}: cores equal BZ")
        if device == "cuda":
            check(hk.launches > 0 and sk.launches > 0, f"SPR {label} launched both kernels")
    fused, host = runs["fused"], runs["host loop"]
    check(np.array_equal(fused.core, host.core) and same_bills(fused, host),
          "SPR fused and host loop agree on cores, rounds and per-round bills")

    # where one superstep's time goes, at the degree seed
    plan = dispatch.resolve_plan(dev)
    body = dispatch.masked_round_program(g.n, n_iters, plan, g.src, g.dst, ell=ell)
    live = torch.ones(g.num_arcs, dtype=torch.bool, device=dev)
    everyone = torch.ones(g.n, dtype=torch.bool, device=dev)
    round_ms = time_ms(torch, lambda: body(deg_t, live, everyone), 5)
    ext = torch.cat([deg_t, deg_t.new_zeros(1)])
    gather_ms = time_ms(torch, lambda: [ext.index_select(0, t.nbrs) for t in tiles], 5)
    print(f"  one superstep at the degree seed: {round_ms:.3f} ms, of which ELL gathers "
          f"{gather_ms:.3f} ms, kcore_hindex {stats['kcore_hindex']['ms']:.3f} ms, "
          f"segment_sum {stats['segment_sum']['ms']:.3f} ms")

    jacobi, spr_fused = runs["host loop"], runs["fused"]    # spr_fused stays for phase 20
    del body, live, everyone, ext, tiles, deg_t, runs, fused, host, ell
    # ------------------------------------------------------------------ #
    phase(f"7. the other static modes on the Table-I set at scale {TABLE_I_SCALE}")
    other_static_modes(torch, dev, table1, launches)

    # ------------------------------------------------------------------ #
    phase(f"8. full size: SPR at scale {spr_scale} through kcore_run --mode block_gs")
    err = block_gs_full(torch, dev, g, core_bz, jacobi, spr_scale, launches)
    stats["segment_sum"]["err"] = max(stats["segment_sum"]["err"], err)

    # ------------------------------------------------------------------ #
    phase("9. the streaming gate (benchmarks/streaming_baseline.json)")
    streaming_gate(torch, dev, launches)

    # ------------------------------------------------------------------ #
    phase(f"10. full size, streaming: SPR at scale {spr_scale}, churn "
          f"{' then '.join(map(str, STREAM_CHURN))} in each frontier mode")
    err, stream_first = streaming_full(torch, dev, g, core_bz, launches)
    stats["segment_sum"]["err"] = max(stats["segment_sum"]["err"], err)

    # ------------------------------------------------------------------ #
    phase("11. the temporal gate (benchmarks/temporal_baseline.json)")
    temporal_gate(torch, dev, launches)

    # ------------------------------------------------------------------ #
    phase(f"12. full size, temporal: a window over SPR's log at scale {spr_scale}, checkpointed "
          f"and restarted warm")
    err = temporal_full(torch, dev, g, spr_scale, launches)
    stats["segment_sum"]["err"] = max(stats["segment_sum"]["err"], err)
    del jacobi, table1       # g and core_bz stay for phases 18 and 20
    if device == "cuda":
        torch.cuda.empty_cache()
    # ------------------------------------------------------------------ #
    phase("13. flash_attention against its plain version")
    flash_cases(torch, np, dev, stats["flash_attention"], small=device != "cuda")

    # ------------------------------------------------------------------ #
    phase(f"14. serve {SERVE['arch']} at full width: batch {SERVE['batch']}, prompt "
          f"{SERVE['prompt']}, {SERVE['gen']} tokens")
    launches["flash_attention"] = serve_full_width(torch, dev, small=device != "cuda")

    # ------------------------------------------------------------------ #
    phase("15. embedding_bag against its plain version")
    bag_cases(torch, np, dev, stats["embedding_bag"], small=device != "cuda")

    # ------------------------------------------------------------------ #
    phase(f"16. DIN at full width: train at batch {DIN['train_batch']}, serve at batch "
          f"{' and '.join(map(str, DIN['serve']))}, retrieval over {DIN['n_candidates']} "
          f"candidates")
    launches["embedding_bag"] = din_full_width(torch, dev, small=device != "cuda")
    if device == "cuda":
        torch.cuda.empty_cache()

    # ------------------------------------------------------------------ #
    phase("17. the serving gate (benchmarks/serving_baseline.json)")
    serving_gate(torch, dev, launches)

    # ------------------------------------------------------------------ #
    phase(f"18. full size, served: SPR at scale {spr_scale} behind the concurrent front end and "
          f"the HTTP endpoint, {SERVED['ticks']} tick(s) of churn {SERVED['churn']}, drained and "
          f"restored")
    err = serving_full(torch, dev, g, core_bz, smi, launches)
    stats["segment_sum"]["err"] = max(stats["segment_sum"]["err"], err)

    # ------------------------------------------------------------------ #
    phase("19. the kcore_serve CLI on the card")
    serve_cli(dev)

    # ------------------------------------------------------------------ #
    phase(f"20. full size, out of core: LJ1 at a {OOC_LJ1['vertices']}-vertex target under "
          f"{OOC_LJ1['mem_budget']} bytes to convergence, SPR at scale {spr_scale} under "
          f"{OOC_SPR_BUDGET} bytes for {OOC_ROUNDS} rounds, and kcore_run --out-of-core")
    err = out_of_core_full(torch, dev, g, core_bz, spr_fused, spr_scale, launches)
    stats["segment_sum"]["err"] = max(stats["segment_sum"]["err"], err)

    # ------------------------------------------------------------------ #
    phase(f"21. the sharded and multi-process paths: SPR at scale {spr_scale} on {SHARDS} shards "
          f"through kcore_run --mesh, the SPR stream's first batch on the mesh, {RANKS} processes, "
          f"the CLIs")
    err = sharded_full(torch, dev, g, core_bz, spr_fused, stream_first, spr_scale, launches)
    stats["segment_sum"]["err"] = max(stats["segment_sum"]["err"], err)
    del stream_first      # g, core_bz and spr_fused stay for phases 22 and 26

    # ------------------------------------------------------------------ #
    phase(f"22. GNN forward: the float segment-sum kernel, GraphCast weather at full width, the "
          f"four GNNs at full width, a minibatch_lg batch and MACE over SPR at scale {spr_scale}")
    launches["segment_sum_float"], mb = gnn_forward(torch, np, dev, g, stats["segment_sum_float"],
                                                    smi, small=device != "cuda")

    # ------------------------------------------------------------------ #
    phase(f"23. GNN training: the float segment sum's backward, GraphCast weather training at "
          f"full width, the four GNNs' train steps at full width, the seed-prefix loss over the "
          f"minibatch_lg batch")
    launches["segment_sum_float"] += gnn_training(torch, np, dev, mb, smi,
                                                  small=device != "cuda")
    del mb

    # ------------------------------------------------------------------ #
    phase(f"24. LM training: {LM['arch']} at full width, one step held against the CPU, "
          f"TrainDriver at {LM['batch']} x {LM['seq']} with a failure and a restart, the trained "
          f"weights served through prefill")
    n_float, n_flash = lm_training(torch, np, dev, stats["segment_sum_float"], smi,
                                   small=device != "cuda")
    launches["segment_sum_float"] += n_float
    launches["flash_attention"] += n_flash

    # ------------------------------------------------------------------ #
    phase(f"25. MoE and sliding-window attention: {MOE['arch']} served at full width, held "
          f"against the CPU at {MOE['hold_layers']} layers and trained at "
          f"{MOE['train_layers']}; {MOE['swa_arch']} at full width and {MOE['swa_layers']} layers "
          f"past its window's roll, and its train step")
    n_flash, n_float = moe_and_window(torch, np, dev, stats["flash_attention"],
                                      stats["segment_sum_float"], smi, small=device != "cuda")
    launches["flash_attention"] += n_flash
    launches["segment_sum_float"] += n_float

    # ------------------------------------------------------------------ #
    phase(f"26. the paper's example launchers on SPR at scale {spr_scale}, the trace gates, and "
          f"dryrun --run on {len(LAUNCH['cells'])} cells")
    launchers_and_cells(torch, np, dev, g, core_bz, spr_fused, smi, stats, launches,
                        small=device != "cuda")
    del g, core_bz, spr_fused

    # ------------------------------------------------------------------ #
    phase(f"27. GNN message passing on a flat mesh: GraphCast at full width on "
          f"{' and '.join(map(str, MESH['shards']))} shards, SchNet, EGNN and MACE on 4, "
          f"{MESH['ranks']} gloo processes")
    launches["segment_sum_float"] += gnn_mesh(torch, np, dev, stats["segment_sum_float"], smi,
                                              small=device != "cuda")

    # ------------------------------------------------------------------ #
    phase("28. kernels")
    print("phase walls: " + "; ".join(f"{title.split(':')[0].split('.')[0]} {wall:.1f} s"
                                      for title, _, wall in phase_walls[:-1]))
    kernels = []
    for name, (source, replaces) in KERNEL_FILES.items():
        st = stats[name]
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": st["err"], "ms": st["ms"],
            "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
            "bound_by": st.get("bound_by", "bytes"), "library_ms": st["library_ms"],
            "check": "bit-equal to plain" if st["err"] == 0 else "MISMATCH",
        }
        if name == "kcore_hindex":
            entry.update(device_ms=st["device_ms"], buckets=st["buckets"])
        if name == "segment_sum":
            entry.update(device_ms=st["device_ms"], timed=st["timed"])
        if name == "flash_attention":
            # the absolute tolerance, and the bf16 rule where rows are held block by block
            ok = st["err"] < FLASH_TOL["bfloat16"] and st["err_f32"] < FLASH_TOL["float32"] \
                and st.get("rule_ratio", 0.0) <= 1.0
            entry.update(max_abs_err_f32=st["err_f32"], tolerance=FLASH_TOL, timed=st["timed"],
                         bf16_rule_worst_ratio=st.get("rule_ratio"),
                         check="within tolerance of plain" if ok else "MISMATCH")
        if name == "segment_sum_float":
            w = st["timed"][WEATHER_CASE]
            entry.update(ms=w["ms"], device_ms=w["device_ms"], plain_ms=w["plain_ms"],
                         bound_ms=w["bound_ms"], library_ms=w["library_ms"], max_excess=st["excess"],
                         tolerance=FLOAT_TOL, timed=st["timed"],
                         check="within tolerance of plain" if st["excess"] <= 0 else "MISMATCH")
        if name == "embedding_bag":
            # the per-case test of phase 15: |err| <= atol + rtol |want| for float32
            ok = st["excess"] <= BAG_TOL and st["err_bf16_ulps"] <= 1.0
            entry.update(device_ms=st["device_ms"], max_excess=st["excess"], max_err_bf16_ulps=st["err_bf16_ulps"],
                         tolerance={"float32": f"|err| <= atol + rtol |want|, rtol = atol = "
                                    f"{BAG_TOL}", "bfloat16": "1 ulp of the output"},
                         timed=st["timed"], check="within tolerance of plain" if ok else "MISMATCH")
        check(entry["check"] != "MISMATCH", f"{name}: {entry['check']}")
        kernels.append(entry)
    print(f"smoke wall {time.perf_counter() - t_start:.1f} s")
    if failures:
        print(f"FAILED {len(failures)} check(s):")
        for f in failures:
            print(f"  {f}")
        return 1
    print(smi if smi else "nvidia-smi: unavailable")
    print(json.dumps({"kernels": kernels}))
    if device != "cuda":
        print("rehearsal on the CPU: no result")
        return 3
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
