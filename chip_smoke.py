#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA card. Run from the repository root::

    python3 chip_smoke.py

It needs a CUDA device and the repository's ``src/``; without either it
exits non-zero and prints no result. It imports nothing of JAX. Phases:

1. build the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
   source, in parallel), print ptxas' registers, shared memory and
   spills and a SASS census of the attention kernels (``cuobjdump
   -sass``: tensor-core ``HMMA`` and asynchronous-copy ``LDGSTS``
   instructions), and print the card's name and power limit;
2. hold each kernel against its plain PyTorch version on the card at
   the main path's shapes and a few harder ones (param_stats also on one
   call over a round's leaves of mixed types with a split row, and on
   three replays of a CUDA graph; kmeans_assign also with its
   ``k_active`` operand at the grid's shape, (14,56) against (5,56);
   kmeans_assign also at phase 14's shapes: the pods' (3,56) and (4,56)
   rows against 2 centroids, the global tier's (8,56) summary rows
   against 3, and the scaling axis' (64,56) pod against 2;
   param_stats also over each train stack of the bucketed layout of the
   full Table I at 32 px, rows up to 2.4 M elements, one launch a
   bucket; both over phase 15's first LM uploads and phase 18 (e)'s
   (mamba2 at 37 layers: 335 leaves in 6 launches), K1 also against
   float64 ``torch.var_mean`` and K2 at (6,22)x(2,22), (6,222)x(2,222)
   and (6,670)x(2,670) from their features), and time kernel, plain
   version and a PyTorch yardstick (K1 also at the three LM uploads);
3. drive the main path: ``SwarmTrainer`` on squeezenet-dr at full width
   on the full Table I (3,657 images at 32 px, 14 clinics), adam at lr
   2e-3, batch 8, 12 local steps, k=3, p1=0.9, p2=0.8, 20 k-means
   iterations, 3 rounds, with every kernel's launch count read from
   that run alone (param_stats: one launch a round over all 28 leaves);
   then profile one more round (device time by kernel,
   the device's busy share);
4. run one round from the same state and the same injected draws on
   the card and on the CPU (the plain versions there) and compare;
5. hold the flash_decode kernel against its plain version at the serve
   path's shapes (q (4,32,1,64) against a bf16 cache stored
   (4,S,8,64), S 1024 and 2048, per-row positions), at kimi-k2's
   (4,64,1,112), on fp8 caches under a bf16 q (granite's and kimi's
   shapes, with and without a window), harder ones, and one call
   replayed three times in a CUDA graph on new inputs, and time kernel,
   plain version and ``scaled_dot_product_attention`` (on an fp8 cache:
   the cache upcast to bf16, then SDPA) at both shapes and both caches;
6. drive the serve path: granite-3-2b as registered (40 layers, full
   width, random weights from a seeded generator on the card) through
   ``make_engine`` with the ``ladder_2`` buckets (4x1024, 4x2048) and
   512-position prefill chunks, draining 24 requests of 32 new tokens,
   each bucket's decode one CUDA graph (``compile_counts()`` 1/1 a
   bucket asserted), with the flash_decode launch count read from that
   run alone; then profile one decode tick and time the next;
7. serve the same prompts on the card and on the CPU from the same
   weights (granite's widths cut to 2 layers, prompts padded to 24, so
   that the CPU finishes in time) and compare tokens, in fp32, bf16 and
   fp16 (asserted equal in fp32 and fp16), and logits in fp32 and bf16
   (the CPU's fp16 matmuls ran at ~0.6 GFLOP/s on the card's host), and
   the card's fp16 logits on an e5m2 cache against an fp16 cache (within
   0.2 of max |logit|);
8. hold the flash_attention kernel against its plain version (the
   reference's FLASH_CASES in fp32 and bf16, rows with no valid key, a
   prefill chunk at q_offset 1536, strided (B,S,H,D) input, bf16 at D 32
   and 128, ragged tiles, an unaligned strided view, granite's full
   prefill shape) and time kernel, plain version and
   ``scaled_dot_product_attention`` at granite's shape (B 4, H 32, KV 8,
   S 2048, D 64, bf16, causal);
9. drive flash_attention on its path: one granite-3-2b attention layer
   at full width (B 2, S 2048, bf16) composed as projections -> RoPE ->
   ``ops.flash_attention_bsh`` -> output projection, against the port's
   ``attend_full``, with the launch count read from that phase alone;
10. run the paper's Table II on the card: ``run_sweep_table`` over the
   four methods (benchmarks/table2_methods.py's settings: full Table I at
   20 px, 14 clinics, squeezenet-dr, adam lr 2e-3, batch 8, 12 local
   steps, k 3, p1 0.9, p2 0.8, 20 k-means iterations, 10 rounds, seed
   0) with the coordinator's launch counts read from the sweep alone,
   then ``run_method("bso-sl")`` serially; the accuracies are reported
   beside the paper's;
11. drive the hyper-parameter grid axis: benchmarks/cluster_ablation.py's
   ``run()`` (half of Table I at 20 px, 14 clinics, squeezenet-dr, adam
   lr 2e-3, batch 8, 10 local steps, 20 k-means iterations, 6 rounds,
   seed 0) over its five CASES through ``run_grid_table`` (pad k 5),
   with K1 = 30 and K2 = 630 launches asserted, every K2 launch carrying
   ``k_active``; then a scheduled grid (local_steps 4 and 10 by k 2 and
   3, 2 rounds), and one grid round (k 2 under the pad 5, its own lr and
   step count) on the card and on the CPU from one state and one set of
   draws, compared;
12. drive the churn axis: benchmarks/churn_bench.py's ``run()`` defaults
   (a quarter of Table I at 16 px, 14 clinics, squeezenet-dr, adam lr
   2e-3, batch 8, 6 local steps, 20 k-means iterations, 4 rounds, seed
   0) over its 8 rows (dropout 0, 0.2, 0.4, 0.6 by stale decay 0, 0.5)
   through ``run_grid_table``, with K1 = 32 and K2 = 672 launches
   asserted, all K2 with ``k_active``, and each row's presence share
   asserted (1 at dropout 0, else inside a binomial band); the dropout-0
   row against the churn-free ``run_grid_point`` of its seed; one churn
   round (dropout 0.4, stale decay 0.5) on the card and on the CPU from
   one state and one set of draws, compared, absent clients unchanged on
   the card;
13. drive the bucketed layout on the main path's data (phase 3's
   settings): 2 rounds of ``run_rounds`` on each layout from one state,
   with pad shares, stack bytes and round seconds printed, the first
   local-step batch equal, assignments and centers equal, params within
   1e-4, and K1 = 2 and K2 = 42 launches a layout asserted; then one
   Table-II centralized round (``run_method``) on the bucketed layout;
14. drive the two-tier (pod) coordinator: (a) phase 3's data and
   settings on ``hier_params(14, 4, k_local=2)`` (pods of 3, 4, 3 and 4
   clinics), 3 rounds of ``run_rounds(hier=)`` with K1 = 3 and
   K2 = 3 x (4 + 1) x 21 = 315 launches asserted, timed beside 3 flat
   rounds; one pod against the flat rounds from one state, bitwise; one
   two-tier churn round (dropout 0.4, stale decay 0.5) on the card and
   on the CPU from one state and one set of draws, compared as phase
   12's; (b) benchmarks/hier_bench.py's engine anchor (14 clinics of
   ``TABLE_I // 16``, at least 2 a nonzero cell, 16 px, 4 local steps,
   10 k-means iterations, 3 rounds), flat against 4 pods, final val
   accuracies printed; (c) its pod-tier scaling axis (N 256, 1024,
   4096 in pods of 64, k_local 2, F 56, 10 iterations, stats from a
   seeded generator on the card): summary shapes, counts, host-facing
   bytes and K2 launches asserted, the card's ``pod_summaries`` against
   the CPU's on the same seed rows, first and steady wall printed;
15. drive the swarm over an LM (tests/test_system.py's
   test_swarm_is_model_agnostic_lm settings: 6 token clients of 12
   sequences of 32, k 2, adam lr 2e-3, batch 4, 4 local steps): (a)
   granite-3-2b at full width cut to 2 layers (11 leaves, 222.3 M
   params a client), 2 rounds with K1 = 2 and K2 = 42 launches
   asserted, round seconds and peak device memory printed, then one
   profiled round; (b) launch/train.py's 100m preset uncut (111 leaves,
   F 222), 1 round with K1 = 2 and K2 = 21; (c) one round of granite's
   smoke config on the card and on the CPU from one state and one set of
   draws, compared as phase 4's. The token ids lie below 8,192 (see
   ``LM_DATA_VOCAB``);
16. train -> checkpoint -> serve: (a) phase 15 (a)'s client-stacked
   params saved with the fleet export's extras, restored bitwise,
   loaded by ``serve.load_checkpoint`` (``"mean"`` and ``"client:0"``,
   bitwise the in-memory reductions) and served through the engine with
   the flash_decode launches of the drain asserted, the tokens equal to
   those served from the in-memory params; (b)
   ``repro_torch.launch.train.train_single`` (single mode's trainer,
   on ``main``'s parsed arguments) on the 100m preset,
   30 steps with a checkpoint: the loss falls, the checkpoint restores
   bitwise, tok/s end to end and the step alone printed;
17. serve the moe family: (a) kimi-k2-1t-a32b at full width (d_model
   7168, 64/8 heads of 112, 384 experts top-8 and a shared expert,
   vocab 163,840, bf16) cut to 2 layers (a dense and a moe one), phase
   6's buckets and workload through the graphed engine: 8 graph replays
   of one bucket against an eager ``decode_step`` loop on the card from
   the same prefilled cache (tokens equal), the drain with K3 launches
   and 1/1 ``compile_counts()`` asserted, tok/s, TTFT, ms a decode call
   beside the bytes it reads, peak memory, a profiled tick; (b) the same
   model's decode logits on an fp8 cache against a bf16 one (within 0.2
   of max |logit|, the reference's bound); (c) llama4-maverick's
   ``smoke()`` config through the same engine, drained, 1/1;
18. the ssm and hybrid families: (a) mamba2-370m as registered (48
   layers, d_model 1024, 32 SSD heads of 64, state 128, vocab 50,280,
   bf16 activations, uncut) through ``run_serve(smoke=False,
   engine="auto")``, which takes the per-token loop: 4 prompts of 64
   tokens and 64 new tokens, tok/s, ms a decode step and peak memory, a
   profiled step; (b) zamba2-1.2b as registered (38 layers, d_model
   2048, the shared attention block of 32/32 heads of 64 after every 6th
   layer, window 8,192, uncut) the same way, K3 = 6 launches a decode
   step asserted, its share of a profiled step, positions below the
   window; (c) K3 at zamba2's shape, bf16 and fp32 (4,32,1,64) against
   (4,S,32,64) at S 129 (the loop's cache) and 4,096, per-row and scalar
   positions, held against its plain version (bf16 within 2e-2 of the
   output's largest magnitude) and timed beside SDPA and its bound;
   (d) mamba2's and zamba2's ``smoke()`` configs in fp32 through the
   loop on the card and on the CPU: tokens equal, decode logits within
   1e-3; (e) phase 15's swarm settings on mamba2-370m at full width with
   its depth cut to 37 layers, the deepest one card holds after the
   earlier phases (each cut printed), 2 rounds with K1 and K2 launches
   asserted, round seconds, peak memory, a profiled round; then one
   zamba2 ``smoke()`` round on the card and on the CPU, compared as
   phase 15 (c);
19. the encdec and vlm families: (a) whisper-base as registered (6 + 6
   layers, d_model 512, 8 heads of 64, a 1,500-frame cross cache, vocab
   51,865, bf16 activations, uncut) and (b) internvl2-26b at full width
   (d_model 6144, 48/8 heads of 128, d_ff 16,384, vocab 92,553) cut to
   24 of its 48 layers, each through ``run_serve(smoke=False,
   engine="auto")``'s per-token loop as phase 18's, K3 = 12 and 24
   launches a decode step asserted; (c) K3 at whisper's self (4,8,1,64)
   vs (4,129,8,64) and cross (4,1500,8,64) shapes and internvl's G = 6
   (4,48,1,128) vs (4,S,8,128), S 129 and 4,096, bf16 and fp32, per-row
   and scalar positions, against its plain version and timed beside
   SDPA; (d) both ``smoke()`` configs in fp32 through the loop on the
   card and on the CPU (whisper's logits on a random cross cache); (e)
   whisper-base uncut trained (B 4, audio (4,1500,512), text 448) with
   adamw at lr 3e-4, weight decay 0.1 and 2 microbatches, 3 steps; the
   gradients of one step with 1 and with 2 microbatches from one state
   (within 1e-2 of the largest, and half the batch alone outside it);
   adafactor (lr 1e-3, clip 1.0), 3 steps, its state's bytes against
   adam's; internvl2-26b at full width cut to 2 layers (B 2, vision
   (2,256,6144), text 768), adamw, 2 microbatches, 2 steps; one
   adafactor step of whisper's smoke config on the card and on the CPU,
   the update from the same gradients and the whole step (on the leaves
   whose gradient is above rounding level) within 1e-5;
20. the fleet regime over one NCCL rank (``NCCL_SOCKET_IFNAME=lo``
   unless set), phase 3's data and settings through
   ``launch.fleet_driver.run_fleet``, 3 rounds each: (a) flat, K1 = 3
   and K2 = 63 launches and the Eq. 2 census (2 all-reduces of 4 * (N *
   P + N) bytes a round) asserted, round and coordinator seconds, a
   profiled round step with NCCL's share; (b) churn, K2 = 21 x the
   coordinated rounds; (c) the two-tier surface at k_local 4, K2 = 42 a
   round; K1 over the fleet's stack and K2 at its three assign shapes
   against their plain versions; (d) 2 rounds of 2 local steps at adam
   eps 1e-6 resumed from (a)'s state on the card and on the CPU over a
   gloo group beside the NCCL one: decisions equal, params within 1e-4;
   (e) (a)'s final state exported, restored bitwise and served;
21. the production dry-run's one-card probe: (a) granite-3-2b as
   registered, bf16 (``launch.dryrun.runtime_config``), through
   ``launch.dryrun.probe_on_card`` at depths 1 and 2 for train_4k (16
   sequences of 4,096, 16 microbatches, adamw, remat "full", and remat
   "none" at depth 2 beside it: both peaks printed, the lower one
   asserted, and one sequence's gradients within 1e-5 of the largest),
   prefill_32k (2 x 32,768), decode_32k (8 rows against a 32,768-position
   cache at pos 32,767) and long_500k (1 row, a 524,288-position cache,
   window 8,192): ms a step, peak, FLOPs on the card asserted equal to the
   same step's on ``meta``, the 40-layer extrapolation and the H100
   roofline, K3 launches asserted; (b) K3 at the two decode probes'
   shapes against its plain version, timed beside it and SDPA, with its
   bound in the bytes of the keys the mask keeps; (c) ``kmeans.assign``
   and ``ops.param_stats`` against their plain versions at phase 3's
   shapes;
22. the LM fleet placed by the table (``swarm_fleet.fleet_setup(spmd=
   "auto")`` on a (1,1,1) ``("pod", "data", "model")`` mesh, one NCCL
   rank): granite-3-2b at full width cut to 2 layers with phase 15's
   settings; (d) first, the census of one plain round step on ``meta``
   under a fake world of one; (a) 3 rounds with ``host_coordinator``
   after each, K1 = 3 and K2 = 63 launches asserted, seconds a round
   step, peak memory; (b) the same rounds, inputs and decisions through
   ``spmd="shard_map"``: max |param diff| printed under adam and
   asserted within 1e-6 under sgd at the same lr; (c) the stat upload's
   shard merge on the card, each leaf cut into 2 even and 3 uneven
   shards, against the plain stats of the whole leaf; (d) a plain round
   step's FLOPs on the card asserted equal to the census; (e) a profiled
   round step's busy share and the Eq. 2 census;
23. the kernels' whole input contract: (a) granite-3-2b as registered
   with fp16 activations on an fp8 e5m2 KV cache through phase 6's
   engine, buckets and workload (K3 = 40 launches a decode call, every
   logit of the first decode call finite; tok/s, ms a tick, TTFT p50);
   (b) phase 15 (a)'s LM swarm with fp16 params, 2 rounds (K1 = 2, K2 =
   42; the round-0 upload through K1 on the fp16 leaves against its
   plain version first; a loss that is not finite printed, not
   asserted); (c) each kernel on inputs its Pallas kernel takes and only
   this slice admits, against its plain version and timed beside its
   library call and bound: K1 on (b)'s fp16 and e4m3 leaves and a
   (70,000, 56) stack; K2 on bf16 (4,096, 4,096) against (16, 4,096)
   with and without k_active; K3 at D 80 and 96, MQA G 64, G 48 on an
   e5m2 cache with a (B,) pos and window 1,024, a bf16 q on an fp16
   cache, and three graph replays of the G 48 call; K4 in fp16, bf16 at
   D 96 and 256, q bf16 on fp16 k and v, fp32 at D 80 ragged with
   q_offset;
24. the port complete: (a) K3 at the inputs its last gaps held back, D
   above 256 (D 320 ragged on an fp16 cache with per-row pos, D 512 on
   a 134 MB bf16 cache, D 1,024 with window 512) and an fp8 q (e4m3 and
   e5m2 at granite's (4,32,1,64) on e4m3, e5m2 and bf16 caches,
   kimi-k2's (4,64,1,112) e4m3 on bf16), each against its plain version
   (an fp8 output byte for byte away from fp8's rounding edges, see
   :func:`fp8_check`) and timed beside SDPA and its bound; constant V
   rows past fp8's range, bytes equal to the plain version's (NaN and
   inf included); three replays of a captured D 512 call; (b) K4 the
   same way: bf16 (1,8,1,024,D) at D 320 and 512, causal and with a
   window, e4m3 and e5m2 q, k and v at (4,32,2,048,64), the overflow
   rows; (c) Table III on the card: ``examples/paper_tables_torch.py``'s
   ``table3(full=True)``, BSO-SL over alexnet-dr, vgg-dr, inception-dr
   and squeezenet-dr on the full Table I at 20 px, 8 rounds of 12 local
   steps, K1 and K2 launches asserted (one K1 and 21 K2 a round), each
   architecture's seconds and accuracy printed beside the paper's; one
   round of alexnet-dr, vgg-dr and inception-dr on the card and on the
   CPU from one state and one set of draws, compared as phase 4.

``python3 chip_smoke.py --only-phase 24`` builds the kernels (phase 1)
and runs phase 24 alone, printing no result line.

``python3 chip_smoke.py --ssm-depth-probe 36 37 38 39`` runs only phase
18 (e)'s mamba2 round at each depth, alone, and prints each peak up to
the first depth that runs out of memory.

Any failure raises. The line before the last is one JSON object
``{"kernels": [...]}``; the last is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import statistics
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 non-tensor FLOP/s,
# dense bf16 and fp8 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_TENSOR_FLOPS = 989e12
FP8_TENSOR_FLOPS = 1979e12

# the serve path (phase 6): benchmarks/serve_bench.py's ladder_2 layout at
# max_seq 2048 and its _workload (24 requests, prompts in [2, 2016), 32
# new tokens, greedy, no eos, numpy seed 0)
SERVE_ARCH = "granite-3-2b"
SERVE_BUCKETS = ((4, 1024), (4, 2048))
SERVE_MAX_SEQ = 2048
SERVE_REQUESTS = 24
SERVE_NEW_TOKENS = 32
PREFILL_CHUNK = 512
SERVE_CPU_PROMPT_PAD = 24         # phase 7's prefill width: its longest prompt (23) padded
DECODE_LAUNCHES_PER_CALL = 1      # one wrapper call per layer per decode call

# the moe family served (phase 17): kimi-k2 at full width cut to the
# reference's _probe_layers minimum (src/repro/launch/dryrun.py:218), 1
# dense and 1 moe layer, through phase 6's buckets and workload
MOE_ARCH = "kimi-k2-1t-a32b"
MOE_LAYERS = 2
MOE_EAGER_TICKS = 8               # graph replays held against an eager decode loop
MOE_FP8_STEPS = 4                 # decode steps of the fp8 cache against the bf16 one
MOE_FP8_RTOL = 0.2                # max |logit diff| / max |logit|, tests/test_perf_variants.py:51
MOE_SMOKE_ARCH = "llama4-maverick-400b-a17b"
# the ssm and hybrid families (phase 18): served as registered through
# run_serve's per-token loop, then the swarm over mamba2 with its depth cut
SSM_ARCH = "mamba2-370m"
HYBRID_ARCH = "zamba2-1.2b"
SSM_SERVE_BATCH = 4
SSM_PROMPT_LEN = 64
SSM_NEW_TOKENS = 64
SSM_WINDOW = 8192                 # zamba2's sliding window, which K3 receives
# zamba2's K3 shape held and timed at these cache lengths: the loop's
# (prompt + new tokens + 1 positions, loop_generate) and a long one
SSM_K3_SEQS = (SSM_PROMPT_LEN + SSM_NEW_TOKENS + 1, 4096)
# the deepest mamba2 one card holds for 6 clients with adam after the
# earlier phases: 38 runs out of memory there (alone, 38 fits and 39 does
# not: ``--ssm-depth-probe``; PERF.md §4)
SSM_SWARM_LAYERS = 37
SSM_SWARM_ROUNDS = 2
# the encdec and vlm families (phase 19): served through the per-token loop
# with phase 18's prompts; trained on the reference's input_specs shapes
# (src/repro/models/model.py) with its optimizer choice for an fp32-master
# config (src/repro/launch/dryrun.py optimizer_for)
ENCDEC_ARCH = "whisper-base"
VLM_ARCH = "internvl2-26b"
VLM_SERVE_LAYERS = 24
VLM_TRAIN_LAYERS = 2
ENCDEC_CROSS_SEQ = 1500
VLM_K3_SEQS = (129, 4096)
TRAIN_MICROBATCHES = 2
TRAIN_ADAMW_LR = 3e-4
TRAIN_ADAMW_WD = 0.1
TRAIN_ADAFACTOR_LR = 1e-3
# phase 19 (e): microbatched gradients within this share of the largest
# gradient of the full batch's (each partial sum is rounded to bf16, 2^-8)
MB_GRAD_RTOL = 1e-2
# ... and the card's whole adafactor step is held on the leaves whose CPU
# gradient is above this share of the largest
STEP_GRAD_FLOOR = 1e-6
ENCDEC_TRAIN_BATCH = 4
ENCDEC_TRAIN_SEQ = 448
ENCDEC_TRAIN_STEPS = 3
VLM_TRAIN_BATCH = 2
VLM_TRAIN_TEXT = 768
VLM_TRAIN_STEPS = 2
EAGER_TICK = "234.7 ms, busy 6.6-8.7% (eager decode, PERF.md §5)"

# flash_attention's path (phases 8 and 9): granite-3-2b's prefill shape
ATTN_SHAPE = (4, 32, 8, 2048, 64)  # B, H, KV, S, D
ATTN_PATH_BATCH = 2
ATTN_LAUNCHES_PER_LAYER = 1
ATTN_PATH_RTOL = 2e-2             # of max |out|, phase 9 (bf16)

# Table II (phase 10): benchmarks/table2_methods.py's run() defaults, and
# the paper's accuracies and the slack of its ordering checks (copied)
TABLE2_IMAGE = 20
TABLE2_ROUNDS = 10
TABLE2_SEED = 0
PAPER = {"centralized": 0.4118, "local": 0.1924, "fedavg": 0.3719, "bso-sl": 0.3725}
ORDERING_TOL = 0.02

ROUNDS = 3
LOCAL_STEPS = 12
BATCH = 8
K = 3
KMEANS_ITERS = 20
STATS_PASSES_PER_ROUND = 1        # one swarm_distribution_matrix per bso round
# the grid axis (phase 11): benchmarks/cluster_ablation.py's run()
# defaults and its CASES (copied), and a grid whose rows' step counts
# differ, so that run_grid_table derives a schedule
GRID_IMAGE = 20
GRID_DATA_SCALE = 2
GRID_ROUNDS = 6
GRID_LOCAL_STEPS = 10
GRID_SEED = 0
GRID_CASES = [
    ("k1_fedavg_like", dict(k=1)),
    ("k3_paper", dict(k=3)),
    ("k5", dict(k=5)),
    ("k3_no_brainstorm", dict(k=3, p1=1.0, p2=1.0)),
    ("k3_max_disruption", dict(k=3, p1=0.0, p2=0.0)),
]
GRID_SCHEDULE_AXES = {"local_steps": (4, 10), "k": (2, 3)}
GRID_SCHEDULE_ROUNDS = 2
# K2's operand at the grid's shape: (14,56) against the pad's 5 centroids
GRID_K_MAX = 5
# the churn axis (phase 12): benchmarks/churn_bench.py's run() defaults
# (copied); a row's presence share must lie within CHURN_BAND_SIGMAS
# binomial standard deviations of 1 - dropout
CHURN_IMAGE = 16
CHURN_DATA_SCALE = 4
CHURN_ROUNDS = 4
CHURN_LOCAL_STEPS = 6
CHURN_SEED = 0
CHURN_DROPOUTS = (0.0, 0.2, 0.4, 0.6)
CHURN_STALE_DECAYS = (0.0, 0.5)
CHURN_BAND_SIGMAS = 4.0
# the bucketed layout (phase 13): 2 rounds of phase 3's settings
BUCKET_ROUNDS = 2
BUCKET_SEED = 0
# the two-tier coordinator (phase 14): phase 3's settings on 4 pods, then
# benchmarks/hier_bench.py's _engine_anchor and scaling axis
HIER_PODS = 4
HIER_K_LOCAL = 2
HIER_SEED = 0
HIER_CHURN = {"dropout": 0.4, "stale_decay": 0.5}
HIER_ANCHOR_IMAGE = 16
HIER_ANCHOR_LOCAL_STEPS = 4
HIER_ANCHOR_ITERS = 10
HIER_SCALING_NS = (256, 1024, 4096)
HIER_POD_SIZE = 64
HIER_SCALING_ITERS = 10
# the swarm over an LM (phase 15): tests/test_system.py's
# test_swarm_is_model_agnostic_lm settings on (a) granite-3-2b at full
# width cut to LM_LAYERS layers, (b) launch/train.py's 100m preset uncut,
# (c) granite's smoke config, card against CPU
LM_ARCH = "granite-3-2b"
LM_LAYERS = 2
LM_CLIENTS = 6
LM_CLUSTERS = 2
LM_ROUNDS = 2
LM_PRESET = "100m"
LM_PRESET_ROUNDS = 1
LM_LOCAL_STEPS = 4
LM_BATCH = 4
LM_LR = 2e-3
LM_SEQS = 12
LM_SEQ_LEN = 32
# the fits' token ids lie below the 100m preset's vocab: the generator
# (data/tokens.py) builds a dense (vocab, vocab) float64 transition
# matrix a client, 19.3 GB at granite's 49,155; granite keeps its full
# 49,155-row embedding and read-out
LM_DATA_VOCAB = 8192
# train -> checkpoint -> serve (phase 16)
LM_PROMPT_LENS = (5, 9, 14, 20)
LM_NEW_TOKENS = 16
LM_SERVE_SEQ = 64
TRAIN_STEPS = 30
TRAIN_BATCH = 8
TRAIN_SEQ = 256
TRAIN_TIMED_STEPS = 10
# the fleet regime (phase 20): phase 3's data and settings on one NCCL rank
FLEET_ROUNDS = 3
FLEET_SEED = 0
FLEET_FAULTS = {"drop_rate": 0.2, "straggler_rate": 0.2, "stale_decay": 0.5, "quorum": 8}
FLEET_HIER_K_LOCAL = 4
FLEET_CARD_VS_CPU_ROUNDS = 2
# kernels that phase 1 holds to no stack frame and no spills
NO_SPILL_KERNELS = ("param_stats", "kmeans_assign", "flash_decode", "flash_attention")
# calls captured in one graph for the coordinator kernels' second device time
GRAPH_CALLS = 20
# the coordinator's kernels by name, as the profiled round reports them
COORDINATOR_KERNELS = ("param_stats_kernel", "kmeans_assign_kernel")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip()


def cuda_ms(torch, fn, reps: int = 100, trials: int = 7) -> float:
    """Median over ``trials`` of the mean time of ``reps`` calls,
    between CUDA events, after a warm-up."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def graph_ms(torch, fn, calls: int = 1, reps: int = 100) -> float:
    """Device time of ``fn``'s launches alone: ``calls`` calls of ``fn``
    captured in a CUDA graph, the replay timed as :func:`cuda_ms` times a
    call, over ``calls``. The host's per-call cost (Python, allocation,
    launch) drops out; with ``calls`` > 1 so does most of the replay's own
    cost (:func:`launch_floor_ms`), which a graph of one small kernel
    cannot go below."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(torch, graph.replay, reps=reps) / calls


def launch_floor_ms(torch, dev) -> float:
    """:func:`graph_ms` of one one-element fill: what a replayed graph of
    one small kernel costs whatever the kernel does."""
    one = torch.zeros(1, device=dev)
    return graph_ms(torch, lambda: one.fill_(1.0))


def bound_ms(n_bytes: float, n_ops: float, peak_flops: float = FP32_FLOPS):
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / peak_flops * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def ptxas_report(text: str) -> list:
    """One line a kernel from ``-Xptxas -v`` output: its name with the
    template arguments made readable, its registers and shared memory,
    then its stack and spills."""
    out, name, parts = [], None, []

    def demangle(sym: str) -> str:
        # the kernel's <length><name>I..., its length digits possibly run
        # on from the anonymous namespace's hash before them
        for m in re.finditer(r"(?=(\d+))", sym):
            n, end = int(m.group(1)), m.start() + len(m.group(1))
            base = sym[end:end + n]
            if sym[end + n:end + n + 1] == "I" and base.isidentifier():
                args = sym[end + n + 1:].split("EEv")[0]
                args = args.replace("13__nv_bfloat16", "bf16,").replace("6__half", "fp16,")
                args = re.sub(r"^f(?=L)", "fp32,", args).replace("Li", "").rstrip("E,")
                args = args.replace("Lb1", "true").replace("Lb0", "false")
                return f"{base}<{args}>"
        # a kernel that is not a template: <length><name>E
        for m in re.finditer(r"(?=(\d+))", sym):
            n, end = int(m.group(1)), m.start() + len(m.group(1))
            base = sym[end:end + n]
            if sym[end + n:end + n + 1] == "E" and base.isidentifier() and "_GLOBAL" not in base:
                return base
        return sym

    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            if name:
                out.append(f"{name}: {'; '.join(parts)}")
            name, parts = demangle(m.group(1)), []
        elif name and ("bytes stack" in line or "registers" in line):
            parts.append(line.split(":", 1)[-1].strip())
    if name:
        out.append(f"{name}: {'; '.join(parts)}")
    return out


def assert_no_spills(lib: str, lines: list) -> None:
    """Every kernel of ``lib``'s :func:`ptxas_report` lines has a 0-byte
    stack frame and no spill stores or loads."""
    assert lines, f"no ptxas report for {lib}"
    for line in lines:
        found = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                           r"(\d+) bytes spill loads", line)
        assert found and all(f == ("0", "0", "0") for f in found), \
            f"{lib} spills or uses a stack: {line}"


# census of the attention libraries' SASS: (library, instruction, at least)
SASS_CENSUS = (("flash_attention", "HMMA", 1), ("flash_attention", "LDGSTS", 1),
               ("flash_decode", "LDGSTS", 1))


def sass_census(build_mod) -> dict:
    """``{library: {"HMMA": n, "LDGSTS": n}}`` from ``cuobjdump -sass`` of
    the built libraries (cuobjdump beside nvcc; missing, it raises), and
    asserts :data:`SASS_CENSUS`: the bf16 attention kernel's products on
    the tensor cores, both kernels' tiles by cp.async."""
    tool = Path(build_mod.nvcc_path()).parent / "cuobjdump"
    if not tool.is_file():
        raise RuntimeError(f"cuobjdump not found beside nvcc ({tool})")
    counts = {}
    for name in sorted({lib for lib, _, _ in SASS_CENSUS}):
        sass = subprocess.run([str(tool), "-sass", str(build_mod.library_path(name))],
                              capture_output=True, text=True, check=True, timeout=120).stdout
        counts[name] = {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HMMA", "LDGSTS")}
        log(f"[build] SASS census {name}: {counts[name]}")
    for lib, op, least in SASS_CENSUS:
        assert counts[lib][op] >= least, f"{lib} has {counts[lib][op]} {op} instructions"
    return counts


# ------------------------------------------------------------------ phase 2


def _assert_stats_close(torch, got, expect, name):
    """K1's tolerance: mean rtol 1e-5 / atol 1e-6, var rtol 1e-4 / atol
    1e-6 (fp32 Welford partials merged in another order than the plain
    two-pass sums, up to 1.7e7 elements); NaN where the plain version is
    NaN (an empty row)."""
    torch.testing.assert_close(got[..., 0], expect[..., 0], rtol=1e-5, atol=1e-6,
                               equal_nan=True, msg=lambda s: f"{name} mean: {s}")
    torch.testing.assert_close(got[..., 1], expect[..., 1], rtol=1e-4, atol=1e-6,
                               equal_nan=True, msg=lambda s: f"{name} var: {s}")


def check_param_stats(torch, dev, leaves):
    """K1 against its plain version at :func:`_assert_stats_close`'s
    tolerance: each case through the one-leaf entry, the round's leaves
    as one call, a mixed call (fp32 and bf16 leaves, an empty leaf, a
    row that splits over CTAs) as one launch, and a captured call with
    a split row replayed three times (:func:`check_param_stats_graph`).
    Returns the max abs error over the round's leaves."""
    from repro_torch.kernels import param_stats, ref
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = [("path", x) for x in leaves]
    cases += [("path-bf16", x.to(torch.bfloat16)) for x in leaves]
    cases.append(("cancellation", torch.randn((3, 1 << 20), generator=gen, device=dev)
                  * 0.5 + 1e4))
    cases.append(("ragged", torch.randn((5, 1_000_003), generator=gen, device=dev)))
    cases.append(("ragged-small", torch.randn((14, 7), generator=gen, device=dev)))
    cases.append((">16M", torch.randn((1, (1 << 24) + 5), generator=gen, device=dev) + 0.3))
    for name, x in cases:
        m, v = param_stats.param_stats_batched(x)
        rm, rv = ref.param_stats_batched(x)
        torch.cuda.synchronize()
        _assert_stats_close(torch, torch.stack([m, v], 1), torch.stack([rm, rv], 1), name)
        if name == "cancellation":
            assert (v - 0.25).abs().max().item() < 0.01, f"cancellation var {v.tolist()}"
    m, v = param_stats.param_stats_batched(torch.zeros((2, 0), device=dev))
    assert torch.isnan(m).all() and torch.isnan(v).all(), "empty rows must give NaN"

    # the round's leaves as one call, as swarm_distribution_matrix makes it
    before = param_stats.param_stats_leaves.launches
    got, expect = param_stats.param_stats_leaves(leaves), ref.param_stats_leaves(leaves)
    torch.cuda.synchronize()
    assert param_stats.param_stats_leaves.launches == before + 1, "the round is not one launch"
    _assert_stats_close(torch, got, expect, "path as one call")
    path_err = (got - expect).abs().max().item()

    # mixed: fp32 and bf16 leaves, an empty leaf and the >16M row (split)
    mixed = _mixed_leaves(torch, dev, gen, leaves)
    before = param_stats.param_stats_leaves.launches
    got, expect = param_stats.param_stats_leaves(mixed), ref.param_stats_leaves(mixed)
    torch.cuda.synchronize()
    assert param_stats.param_stats_leaves.launches == before + 1, "the mixed call is not one launch"
    _assert_stats_close(torch, got, expect, "mixed")
    assert torch.isnan(got[:, 1]).all(), "the empty leaf must give NaN"
    log(f"[kernels] param_stats: mixed call of {len(mixed)} leaves ({mixed[-1].shape[1]} "
        f"elements a client in the last, {param_stats.slices(mixed[-1].shape[1])} CTAs a row) "
        f"in one launch, max abs err {(got - expect).nan_to_num().abs().max().item():.3e}")
    del mixed, got, expect
    check_param_stats_graph(torch, dev, gen, leaves)
    log(f"[kernels] param_stats_batched: {len(cases)} one-leaf cases, the round's "
        f"{len(leaves)} leaves as one call, the mixed call and 3 graph replays agree with the "
        f"plain version; max abs err on the path leaves {path_err:.3e}")
    return path_err


def _mixed_leaves(torch, dev, gen, leaves):
    """The round's leaves, every other one in bf16, an empty leaf, and a
    (14, 2^24 + 5) fp32 leaf whose rows split over CTAs."""
    out = [x.to(torch.bfloat16) if i % 2 else x for i, x in enumerate(leaves)]
    out.insert(1, torch.zeros((leaves[0].shape[0], 0), device=dev))
    out.append(torch.randn((leaves[0].shape[0], (1 << 24) + 5), generator=gen, device=dev)
               + 0.3)
    return out


def check_param_stats_graph(torch, dev, gen, leaves):
    """One call over the round's leaves and a split (14, 2^20 + 3) leaf,
    captured in a CUDA graph (its merge counters made before the capture,
    on the capture's stream) and replayed three times on new inputs
    written in place. Each replay equals an eager call bitwise and the
    plain version at K1's tolerance: the last CTA of each split row
    found its counter back at 0."""
    from repro_torch.kernels import param_stats, ref
    xs = [x.clone() for x in leaves]
    xs.append(torch.randn((leaves[0].shape[0], (1 << 20) + 3), generator=gen, device=dev))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        param_stats.param_stats_leaves(xs)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = param_stats.param_stats_leaves(xs)
    for rep in range(3):
        for x in xs:
            x.copy_(torch.randn(x.shape, generator=gen, device=dev) * (rep + 1) + rep)
        graph.replay()
        eager = param_stats.param_stats_leaves(xs)
        expect = ref.param_stats_leaves(xs)
        torch.cuda.synchronize()
        assert torch.equal(out, eager), f"param_stats graph replay {rep} differs from a call"
        _assert_stats_close(torch, out, expect, f"param_stats graph replay {rep}")
        log(f"[kernels] param_stats graph replay {rep}: equal to an eager call, max abs err "
            f"{(out - expect).abs().max().item():.3e}")


def check_param_stats_buckets(torch, dev, clients):
    """K1 over each train stack of the bucketed layout of ``clients``,
    flattened to (N_b, n_max_b * H * W * 3): one launch a bucket, held to
    :func:`_assert_stats_close`'s tolerance. Returns the max abs error."""
    from repro_torch.configs import get_config
    from repro_torch.core.engine import make_bucketed_swarm_data
    from repro_torch.kernels import param_stats, ref
    data = make_bucketed_swarm_data(get_config("squeezenet-dr"), clients, device=dev)
    err = 0.0
    for b, (ids, tr) in enumerate(zip(data.client_ids, data.train)):
        x = tr["images"].reshape(len(ids), -1)
        before = param_stats.param_stats_leaves.launches
        m, v = param_stats.param_stats_batched(x)
        rm, rv = ref.param_stats_batched(x)
        torch.cuda.synchronize()
        assert param_stats.param_stats_leaves.launches == before + 1, f"bucket {b}: not one launch"
        got, expect = torch.stack([m, v], 1), torch.stack([rm, rv], 1)
        _assert_stats_close(torch, got, expect, f"bucket {b}")
        err = max(err, (got - expect).abs().max().item())
        log(f"[kernels] param_stats_batched over bucket {b}'s train stack: {len(ids)} clients, "
            f"rows of {x.shape[1]} elements, {param_stats.slices(x.shape[1])} CTAs a row, one "
            f"launch, max abs err {(got - expect).abs().max().item():.3e}")
    return err


def time_param_stats(torch, leaves):
    """The round's leaves: the kernel and the plain version as one call
    each, beside 28 ``torch.var_mean`` calls."""
    from repro_torch.kernels import param_stats, ref

    def kernel():
        param_stats.param_stats_leaves(leaves)

    def plain():
        ref.param_stats_leaves(leaves)

    def library():
        for x in leaves:
            torch.var_mean(x.view(x.shape[0], -1), 1, correction=0)

    ms, plain_ms, lib_ms = cuda_ms(torch, kernel), cuda_ms(torch, plain), cuda_ms(torch, library)
    log(f"[kernels] param_stats_batched device time alone (CUDA graph of one call over the "
        f"{len(leaves)} leaves; var_mean: of its {len(leaves)} calls): "
        f"kernel {graph_ms(torch, kernel):.4f} ms, plain {graph_ms(torch, plain):.4f} ms, "
        f"var_mean {graph_ms(torch, library):.4f} ms; a call of a graph of {GRAPH_CALLS}: "
        f"kernel {graph_ms(torch, kernel, GRAPH_CALLS):.4f} ms, var_mean "
        f"{graph_ms(torch, library, GRAPH_CALLS):.4f} ms")
    # what sets the one call's time: its few long rows or its many short ones
    longest = sorted(leaves, key=lambda x: x.numel())
    for name, part in (("the 2 longest leaves", longest[-2:]),
                       (f"the other {len(leaves) - 2}", longest[:-2])):
        log(f"[kernels] param_stats_batched on {name} alone ({sum(x.numel() for x in part)} "
            f"elements, {sum(x.shape[0] * param_stats.slices(x[0].numel()) for x in part)} "
            f"CTAs): {graph_ms(torch, lambda: param_stats.param_stats_leaves(part), GRAPH_CALLS):.4f}"
            f" ms a call of a graph of {GRAPH_CALLS}")
    n_el = sum(x.numel() for x in leaves)
    n_bytes = sum(x.numel() * x.element_size() + 2 * x.shape[0] * 4 for x in leaves)
    # 4 fp32 operations an element: a sum for the mean, then subtract,
    # square and add for the squared deviations
    b, by = bound_ms(n_bytes, 4 * n_el)
    return ms, plain_ms, lib_ms, b, by


def _hier_assign_cases(torch, X, rand):
    """K2's operands on phase 14's path, from the path's own (14, 56)
    rows ``X``: each pod of ``hier_params(14, 4, k_local=2)`` ((3, 56)
    and (4, 56)) against its two seed rows and against the means of its
    two halves (a Lloyd step's centroids); the weighted global tier's
    (8, 56) summary rows against 3 of them, also with coinciding rows;
    the scaling axis' (64, 56) pod against 2 of its rows and 2 means."""
    from repro_torch.core import engine

    def halves(x):
        h = (x.shape[0] + 1) // 2
        return torch.stack([x[:h].mean(0), x[h:].mean(0)])

    cases, summary = [], []
    for p, idx in enumerate(engine.hier_params(14, HIER_PODS, HIER_K_LOCAL).pod_index(X.device)):
        rows = X.index_select(0, idx).contiguous()
        cases += [(f"pod {p} {tuple(rows.shape)} vs its seed rows", rows, rows[:2].contiguous()),
                  (f"pod {p} {tuple(rows.shape)} vs its halves' means", rows, halves(rows))]
        summary.append(halves(rows))
    summary = torch.cat(summary)
    coincide = torch.cat([summary[:4], summary[:4]])
    cases += [("global tier (8, 56) vs 3 of its rows", summary, summary[[0, 3, 6]].contiguous()),
              ("global tier, coinciding summary rows", coincide, coincide[[0, 4, 5]].contiguous())]
    pod = rand(HIER_POD_SIZE, X.shape[1])
    cases += [("scaling pod (64, 56) vs 2 of its rows", pod, pod[[5, 40]].contiguous()),
              ("scaling pod (64, 56) vs its halves' means", pod, halves(pod))]
    return cases


def check_kmeans_assign(torch, dev, X, C):
    from repro_torch.kernels import kmeans_assign, ref
    gen = torch.Generator(device=dev).manual_seed(2)
    a, b = torch.randn((2, 56), generator=gen, device=dev)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    cases = [("path", X, C),
             ("wide", rand(1000, 260), rand(37, 260)),
             ("K=64, F=260: C in 8 tiles", rand(4, 260), rand(64, 260)),
             ("K=64, F=191", rand(500, 191), rand(64, 191)),
             ("F=1", rand(300, 1), rand(5, 1)),
             ("F=33", rand(300, 33), rand(7, 33)),
             ("rows equal to two centroids, each twice", torch.stack([a, b] * 20),
              torch.stack([a, b, a, b])),
             ("ties", torch.zeros((130, 4), device=dev), torch.zeros((5, 4), device=dev))]
    cases += _hier_assign_cases(torch, X, rand)
    for name, x, c in cases:
        got = kmeans_assign.kmeans_assign(x, c)
        expect = ref.kmeans_assign(x, c)
        torch.cuda.synchronize()
        if not torch.equal(got, expect):
            bad = int((got != expect).sum())
            raise AssertionError(f"kmeans_assign {name}: {bad} of {got.numel()} ids differ")
    log(f"[kernels] kmeans_assign: {len(cases)} cases equal to the plain version (K=37 and "
        f"K=64 past one C tile)")
    return 0.0


def check_kmeans_assign_k_active(torch, dev, X):
    """K2 with its ``k_active`` operand (a () int32 tensor on the card)
    against the plain version, ids equal: the grid's shape at k_active
    1, 2, 3 and 5 of 5; dead centroids that are copies of rows of X, so
    nearer than every live one; ties; k_active 0, below 0 and above K;
    the streaming variant (F > 128). Each call is one launch that
    carried the operand; a k_active on the host is refused."""
    from repro_torch.kernels import kmeans_assign, ref
    gen = torch.Generator(device=dev).manual_seed(6)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    grid_c = X[torch.randperm(X.shape[0], generator=gen, device=dev)[:GRID_K_MAX]].contiguous()
    grid_c += 0.01 * rand(*grid_c.shape)
    dead = torch.cat([rand(3, X.shape[1]) + 3.0, X[:2]]).contiguous()
    cases = [(f"grid k_active={v}", X, grid_c, v) for v in (1, 2, 3, GRID_K_MAX)]
    cases += [("dead centroids nearest", X, dead, 3),
              ("ties", torch.zeros((130, 4), device=dev), torch.zeros((5, 4), device=dev), 3),
              ("k_active=0", X, grid_c, 0), ("k_active=-2", X, grid_c, -2),
              ("k_active=7 > K", X, grid_c, 7),
              ("F=200 (streaming variant)", rand(300, 200), rand(6, 200), 4)]
    for name, x, c, v in cases:
        ka = torch.tensor(v, dtype=torch.int32, device=dev)
        before = (kmeans_assign.kmeans_assign.launches,
                  kmeans_assign.kmeans_assign.k_active_launches)
        got = kmeans_assign.kmeans_assign(x, c, ka)
        expect = ref.kmeans_assign(x, c, ka)
        torch.cuda.synchronize()
        assert (kmeans_assign.kmeans_assign.launches,
                kmeans_assign.kmeans_assign.k_active_launches) == \
            (before[0] + 1, before[1] + 1), f"kmeans_assign {name}: not one k_active launch"
        if not torch.equal(got, expect):
            bad = int((got != expect).sum())
            raise AssertionError(f"kmeans_assign {name}: {bad} of {got.numel()} ids differ")
        if v <= 0:
            assert not got.any(), f"kmeans_assign {name}: no live centroid must give id 0"
    refused = False
    try:
        kmeans_assign.kmeans_assign(X, grid_c, torch.tensor(3, dtype=torch.int32))
    except ValueError:
        refused = True
    assert refused, "kmeans_assign took a k_active on the host"
    log(f"[kernels] kmeans_assign with k_active: {len(cases)} cases equal to the plain version; "
        f"a k_active on the host refused")
    return grid_c


def time_kmeans_assign_k_active(torch, X, C):
    """K2 at the grid's shape with and without its operand: one call
    through the wrapper, one call replayed in a CUDA graph, and a call of
    a graph of :data:`GRAPH_CALLS`, logged."""
    from repro_torch.kernels import kmeans_assign
    ka = torch.tensor(3, dtype=torch.int32, device=X.device)
    out = {}
    for name, fn in (("without", lambda: kmeans_assign.kmeans_assign(X, C)),
                     ("with", lambda: kmeans_assign.kmeans_assign(X, C, ka))):
        out[name] = (cuda_ms(torch, fn, reps=500), graph_ms(torch, fn),
                     graph_ms(torch, fn, GRAPH_CALLS))
    log(f"[kernels] kmeans_assign ({X.shape[0]},{X.shape[1]})x({C.shape[0]},{C.shape[1]}), "
        f"k_active 3: through the wrapper / one call in a graph / a call of a graph of "
        f"{GRAPH_CALLS}: without the operand "
        f"{' / '.join(f'{t:.4f}' for t in out['without'])} ms, with it "
        f"{' / '.join(f'{t:.4f}' for t in out['with'])} ms")


def time_kmeans_assign(torch, X, C):
    from repro_torch.kernels import kmeans_assign, ref
    ms = cuda_ms(torch, lambda: kmeans_assign.kmeans_assign(X, C), reps=500)
    plain_ms = cuda_ms(torch, lambda: ref.kmeans_assign(X, C), reps=500)
    lib_ms = cuda_ms(torch, lambda: torch.cdist(X, C).argmin(1), reps=500)
    kernel = lambda: kmeans_assign.kmeans_assign(X, C)  # noqa: E731
    library = lambda: torch.cdist(X, C).argmin(1)       # noqa: E731
    log(f"[kernels] kmeans_assign device time alone (CUDA graph of one call): "
        f"kernel {graph_ms(torch, kernel):.4f} ms, "
        f"plain {graph_ms(torch, lambda: ref.kmeans_assign(X, C)):.4f} ms, "
        f"cdist+argmin {graph_ms(torch, library):.4f} ms; a call of a graph of {GRAPH_CALLS}: "
        f"kernel {graph_ms(torch, kernel, GRAPH_CALLS):.4f} ms, cdist+argmin "
        f"{graph_ms(torch, library, GRAPH_CALLS):.4f} ms")
    N, F = X.shape
    Kc = C.shape[0]
    n_bytes = (N * F + Kc * F) * 4 + N * 4
    n_ops = 2 * N * Kc * F + 2 * N * F + 2 * Kc * F + 3 * N * Kc
    b, by = bound_ms(n_bytes, n_ops)
    return ms, plain_ms, lib_ms, b, by


# ------------------------------------------------------------- phases 3, 4


def _coordinator_counts():
    from repro_torch.kernels import kmeans_assign, param_stats
    return {"param_stats_batched": param_stats.param_stats_leaves.launches,
            "kmeans_assign": kmeans_assign.kmeans_assign.launches,
            "kmeans_assign with k_active": kmeans_assign.kmeans_assign.k_active_launches}


def _zero_coordinator_counts():
    from repro_torch.kernels import kmeans_assign, param_stats
    param_stats.param_stats_leaves.launches = 0
    kmeans_assign.kmeans_assign.launches = 0
    kmeans_assign.kmeans_assign.k_active_launches = 0


def _grid_want(rows: int, rounds: int, n_leaves: int) -> dict:
    """The coordinator's launches of ``rows`` rows of ``rounds`` bso
    rounds: one K1 pass a round (a launch for every MAX_LEAVES leaves),
    ``KMEANS_ITERS + 1`` K2 assigns, on a grid row each with
    ``k_active``."""
    from repro_torch.kernels import param_stats
    k2 = rows * rounds * (KMEANS_ITERS + 1)
    return {"param_stats_batched": rows * rounds * math.ceil(n_leaves / param_stats.MAX_LEAVES)
            * STATS_PASSES_PER_ROUND,
            "kmeans_assign": k2, "kmeans_assign with k_active": k2}


def main_path(torch, clients, dev):
    from repro_torch.configs import OptimizerConfig, SwarmConfig, get_config
    from repro_torch.core.swarm import SwarmTrainer
    from repro_torch.models import build_model

    swarm = SwarmConfig(n_clients=14, n_clusters=K, p1=0.9, p2=0.8,
                        kmeans_iters=KMEANS_ITERS, local_steps=LOCAL_STEPS, rounds=ROUNDS)
    tr = SwarmTrainer(build_model(get_config("squeezenet-dr")), clients, swarm,
                      OptimizerConfig(name="adam", lr=2e-3), seed=0, batch_size=BATCH,
                      device=dev)
    imgs = tr.swarm_data.train["images"]
    log(f"[main] squeezenet-dr, 14 clients, train stack {tuple(imgs.shape)} = "
        f"{imgs.numel() * imgs.element_size() / 1e6:.1f} MB on {imgs.device}")

    _zero_coordinator_counts()
    round_s = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        lg = tr.round()
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
        log(f"[main] round {lg.round}: {round_s[-1]:.3f} s  val_acc={lg.mean_val_acc:.4f} "
            f"loss={lg.train_loss:.4f} assignments={lg.assignments.tolist()} "
            f"centers={lg.centers.tolist()} events={lg.events}")
        assert math.isfinite(lg.train_loss), "train loss is not finite"
        assert 0.0 <= lg.mean_val_acc <= 1.0, "val accuracy outside [0, 1]"
    launches = _coordinator_counts()
    # one launch a stats pass for every MAX_LEAVES leaves: 1 for the 28;
    # the plain path's assigns carry no k_active
    want = {**_grid_want(1, ROUNDS, len(_leaves(tr.params))), "kmeans_assign with k_active": 0}
    log(f"[main] launches {launches}, expected {want}")
    assert launches == want, f"launch counts {launches} != {want}"
    test_acc = tr.mean_accuracy("test")
    assert 0.0 <= test_acc <= 1.0
    log(f"[main] Eq. 3 test accuracy after {ROUNDS} rounds: {test_acc:.4f}; "
        f"round seconds {[round(s, 4) for s in round_s]}")
    return tr, launches, round_s


def _leaves(tree):
    from repro_torch.utils.tree import tree_leaves
    return tree_leaves(tree)


def device_busy_us(prof):
    """(microseconds in which at least one kernel ran, the kernel spans)
    of a ``torch.profiler`` trace; the device-side copies of the
    program's ``record_function`` spans are not kernels."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return busy_us, spans


def profile_round(torch, tr) -> None:
    """One more round of the main path under ``torch.profiler``: device
    time by kernel and the device's busy share of the round's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.round()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_us, spans = device_busy_us(prof)
    log(f"[profile] round of {wall_ms:.1f} ms wall: {len(spans)} device events, device busy "
        f"{busy_us / 1e3:.1f} ms ({busy_us / 1e3 / wall_ms:.1%}), idle {1 - busy_us / 1e3 / wall_ms:.1%}")
    for kernel in COORDINATOR_KERNELS:
        us = [e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type == DeviceType.CUDA and kernel in e.name]
        log(f"[profile] {kernel}: {len(us)} launches in the round, "
            f"{statistics.mean(us) if us else float('nan'):.2f} us each on the device "
            f"(min {min(us, default=float('nan')):.2f}, max {max(us, default=float('nan')):.2f})")
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=25)
    for line in table.splitlines():
        log(f"[profile] {line}")


def card_vs_cpu(torch, tr, clients, local_steps: int, eps: float, batch: int = BATCH,
                k: int = K):
    """One round on the card and on the CPU from the trainer's state and
    the same draws (``batch`` rows a client a step, ``k`` seed rows).
    Returns (max |param diff|, card metrics, cpu metrics)."""
    from dataclasses import replace

    from repro_torch.core import engine
    from repro_torch.core.bso import draw_bso
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.configs import OptimizerConfig

    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(11)
    data_cpu = engine.make_swarm_data(tr.cfg, clients, device=cpu)
    n = len(clients)
    draws = engine.RoundDraws(
        batch_idx=torch.stack([engine.draw_batch_idx(gen, data_cpu.train_n, batch)
                               for _ in range(local_steps)]),
        kmeans_init_idx=torch.randperm(n, generator=gen)[:k],
        bso=draw_bso(k, n, gen, cpu))
    cfg = replace(tr.engine_cfg, local_steps=local_steps,
                  opt=make_optimizer(OptimizerConfig(name="adam", lr=2e-3, eps=eps)))
    s_card = engine.copy_state(tr.state)
    s_cpu = _state_on_cpu(torch, s_card)
    new_card, m_card = engine.swarm_round(s_card, tr.swarm_data, cfg, draws=draws)
    new_cpu, m_cpu = engine.swarm_round(s_cpu, data_cpu, cfg, draws=draws)
    torch.cuda.synchronize()
    diff = max((a.cpu() - b).abs().max().item()
               for a, b in zip(_leaves(new_card.params), _leaves(new_cpu.params)))
    return diff, m_card, m_cpu

# ------------------------------------------------------------ phases 5-7


def _decode_case(torch, dev, gen, B, H, KV, S, D, dtype, stored=True):
    """q (B,H,1,D) and k, v (B,KV,S,D); ``stored`` gives k, v as the
    serve cache keeps them, (B,S,KV,D), seen through a transposed view.
    ``dtype`` is one type, or (q's, the cache's)."""
    qdt, kvdt = dtype if isinstance(dtype, tuple) else (dtype, dtype)
    q = torch.randn((B, H, 1, D), generator=gen, device=dev).to(qdt)
    shape = (B, S, KV, D) if stored else (B, KV, S, D)
    k, v = (torch.randn(shape, generator=gen, device=dev).to(kvdt) for _ in range(2))
    return (q, k.transpose(1, 2), v.transpose(1, 2)) if stored else (q, k, v)


def check_flash_decode(torch, dev):
    """K3 against its plain version. Tolerances are the reference's own
    for its kernel against its oracle: 2e-5 in fp32, 2e-2 in bf16/fp16
    (and for a bf16 q on an fp8 cache, which the plain version reads
    upcast as the kernel does). Returns the max abs error over the path's
    cases (per-row pos; granite's and kimi-k2's shapes in bf16, and
    granite's fp16 q on an e5m2 cache, phase 23 (a)'s)."""
    from repro_torch.kernels import flash_decode, ref
    gen = torch.Generator(device=dev).manual_seed(3)
    bf16, f32, fp8 = torch.bfloat16, torch.float32, torch.float8_e4m3fn
    f16, e5m2 = torch.float16, torch.float8_e5m2
    rows = torch.randint(1, 1023, (2,), generator=gen, device=dev).tolist()

    def vec(*p):
        return torch.tensor(p, dtype=torch.int32, device=dev)

    cases = [  # name, (B, H, KV, S, D), dtype, pos, window, stored
        ("path S=1024", (4, 32, 8, 1024, 64), bf16, vec(0, 1023, *rows), 0, True),
        ("path S=2048", (4, 32, 8, 2048, 64), bf16, vec(0, 2047, *[2 * r for r in rows]), 0,
         True),
        ("path S=2048 all full", (4, 32, 8, 2048, 64), bf16, vec(2047, 2047, 2047, 2047), 0,
         True),
        ("fp32 S=2048", (4, 32, 8, 2048, 64), f32, vec(0, 2047, *rows), 0, True),
        ("scalar pos", (4, 32, 8, 2048, 64), bf16, 1234, 0, True),
        ("window 256", (4, 32, 8, 2048, 64), bf16, vec(2047, 3, 700, 255), 256, True),
        ("fp32 window 100", (4, 32, 8, 1024, 64), f32, vec(1023, 99, 500, 0), 100, True),
        ("ragged S=1000", (4, 32, 8, 1000, 64), bf16, vec(999, 0, 640, 321), 0, True),
        ("fp32 ragged S=1000", (4, 32, 8, 1000, 64), f32, 999, 0, True),
        ("G=1", (2, 8, 8, 512, 64), f32, vec(511, 17), 0, False),
        ("G=1 bf16", (2, 8, 8, 512, 64), bf16, vec(0, 300), 0, False),
        ("fp16 D=128", (1, 8, 2, 1024, 128), torch.float16, 1023, 0, False),
        ("D=32 G=2", (2, 4, 2, 96, 32), f32, vec(0, 37), 0, False),
        # kimi-k2's decode shape (phase 17): head_dim 112, G 8
        ("path kimi S=1024", (4, 64, 8, 1024, 112), bf16, vec(0, 1023, *rows), 0, True),
        ("path kimi S=2048", (4, 64, 8, 2048, 112), bf16, vec(2047, 0, *[2 * r for r in rows]),
         0, True),
        ("kimi fp32 window 300", (4, 64, 8, 2048, 112), f32, vec(2047, 5, 900, 299), 300, True),
        # an fp8 cache under a bf16 q, at granite's and kimi's shapes
        ("fp8 granite S=2048", (4, 32, 8, 2048, 64), (bf16, fp8), vec(2047, 0, *rows), 0, True),
        ("fp8 granite window 256", (4, 32, 8, 2048, 64), (bf16, fp8), vec(2047, 3, 700, 255),
         256, True),
        ("fp8 kimi S=2048", (4, 64, 8, 2048, 112), (bf16, fp8), vec(2047, 1535, 1023, 511), 0,
         True),
        ("fp8 kimi window 256", (4, 64, 8, 2048, 112), (bf16, fp8), vec(2047, 3, 700, 255), 256,
         True),
        # phase 23 (a)'s: an fp16 q on an e5m2 cache at granite's shapes
        ("path fp16 on e5m2 S=2048", (4, 32, 8, 2048, 64), (f16, e5m2),
         vec(2047, 0, *[2 * r for r in rows]), 0, True),
        ("path fp16 on e5m2 window 256", (4, 32, 8, 2048, 64), (f16, e5m2),
         vec(2047, 3, 700, 255), 256, True),
        ("path fp16 on e5m2 S=1024", (4, 32, 8, 1024, 64), (f16, e5m2), vec(0, 1023, *rows), 0,
         True),
    ]
    path_err = 0.0
    for name, (B, H, KV, S, D), dtype, pos, window, stored in cases:
        q, k, v = _decode_case(torch, dev, gen, B, H, KV, S, D, dtype, stored)
        got = flash_decode.flash_decode(q, k, v, pos, window)
        expect = ref.decode_attention(q, k, v, pos, window)
        torch.cuda.synchronize()
        tol = 2e-5 if dtype == f32 else 2e-2
        torch.testing.assert_close(got.float(), expect.float(), rtol=tol, atol=tol,
                                   msg=lambda m: f"flash_decode {name}: {m}")
        err = (got.float() - expect.float()).abs().max().item()
        if name.startswith("path"):
            path_err = max(path_err, err)
        log(f"[kernels] flash_decode {name}: max abs err {err:.3e} (tol {tol:g})")
    check_flash_decode_graph(torch, dev, gen)
    log(f"[kernels] flash_decode: {len(cases)} cases and 3 graph replays agree with the plain "
        f"version; max abs err on the path cases {path_err:.3e}")
    return path_err


def check_flash_decode_graph(torch, dev, gen):
    """One serve-shape call captured in a CUDA graph, replayed three
    times on new inputs written in place, each replay against the plain
    version (2e-2, bf16): the fused merge's counters are back at 0 after
    every launch."""
    from repro_torch.kernels import flash_decode, ref
    B, H, KV, S, D = 4, 32, 8, 2048, 64
    q, k, v = _decode_case(torch, dev, gen, B, H, KV, S, D, torch.bfloat16)
    pos = torch.tensor([2047, 1535, 1023, 511], dtype=torch.int32, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        flash_decode.flash_decode(q, k, v, pos)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = flash_decode.flash_decode(q, k, v, pos)
    for rep in range(3):
        for t in (q, k, v):
            t.copy_(torch.randn(t.shape, generator=gen, device=dev))
        pos.copy_(torch.randint(0, S, (B,), generator=gen, device=dev, dtype=torch.int32))
        graph.replay()
        expect = ref.decode_attention(q, k, v, pos)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), expect.float(), rtol=2e-2, atol=2e-2,
                                   msg=lambda m: f"flash_decode graph replay {rep}: {m}")
        log(f"[kernels] flash_decode graph replay {rep} (pos {pos.tolist()}): max abs err "
            f"{(out.float() - expect.float()).abs().max().item():.3e} (tol 0.02)")


def time_flash_decode(torch, dev, H: int = 32, D: int = 64, cache=None, label: str = "granite",
                      KV: int = 8, S: int = 2048, window: int = 0, pos=None):
    """K3 at the larger serve bucket: q (4,H,1,D) bf16 against a cache
    stored (4,S,KV,D) in ``cache``'s dtype (bf16 unless given), rows at
    S, 3S/4, S/2 and S/4 less one (or every row at the scalar ``pos``),
    under ``window`` (0: none; the rows here lie inside any window
    given). The library call is SDPA on the bf16 cache; on an fp8 cache,
    the cache upcast to bf16 and then SDPA (twice the cache's bytes read,
    and a bf16 copy written)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_decode, ref
    gen = torch.Generator(device=dev).manual_seed(4)
    B = 4
    assert window == 0 or window >= S
    cache = cache or torch.bfloat16
    q, k, v = _decode_case(torch, dev, gen, B, H, KV, S, D, (torch.bfloat16, cache))
    if pos is None:
        pos = torch.tensor([S - 1, 3 * S // 4 - 1, S // 2 - 1, S // 4 - 1], dtype=torch.int32,
                           device=dev)
        valid_cols = int((pos + 1).sum())
        mask = torch.arange(S, device=dev)[None, None, None, :] <= pos[:, None, None, None]
    else:
        valid_cols = B * (pos + 1)
        # a 0-d tensor on the card, as attend_decode hands it over: a graph
        # cannot capture the copy of a Python int
        pos = torch.tensor(pos, dtype=torch.int32, device=dev)
        mask = torch.arange(S, device=dev)[None, None, None, :] <= pos

    def kernel():
        flash_decode.flash_decode(q, k, v, pos, window)

    def plain():
        ref.decode_attention(q, k, v, pos, window)

    def library():
        return F.scaled_dot_product_attention(q, k.to(q.dtype), v.to(q.dtype), attn_mask=mask,
                                              enable_gqa=True)

    lib_err = (library().float()
               - ref.decode_attention(q, k, v, pos, window).float()).abs().max().item()
    ms, plain_ms, lib_ms = (cuda_ms(torch, f, reps=200) for f in (kernel, plain, library))
    name = f"flash_decode {label} (4,{H},1,{D}) vs a (4,{S},{KV},{D}) {str(cache)[6:]} cache" + (
        f" at pos {int(pos)}" if pos.dim() == 0 else "")
    log(f"[kernels] {name} device time alone (CUDA graph of one call): "
        f"kernel {graph_ms(torch, kernel):.4f} ms, plain {graph_ms(torch, plain):.4f} ms, "
        f"library {graph_ms(torch, library):.4f} ms (library vs plain max abs err {lib_err:.3e})")
    es = k.element_size()
    kv_bytes = valid_cols * KV * D * 2 * es           # the K and V columns the output reads
    full_bytes = B * S * KV * D * 2 * es
    n_bytes = kv_bytes + 2 * q.numel() * q.element_size() + B * 4   # + q, the output and pos
    # per valid column and query head: D multiply-adds for the score, D
    # for the output, and the softmax's few operations
    n_ops = valid_cols * H * (4 * D + 5)
    b, by = bound_ms(n_bytes, n_ops, BF16_TENSOR_FLOPS)
    log(f"[kernels] {name} bound: {n_bytes} bytes of valid K/V columns, q and output "
        f"-> {b:.5f} ms ({by}); the whole cache is {full_bytes} bytes "
        f"-> {full_bytes / HBM_BYTES_PER_S * 1e3:.5f} ms")
    log(f"[kernels] {name} through the wrapper: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library {lib_ms:.4f} ms, bound {b:.5f} ms ({by})")
    return ms, plain_ms, lib_ms, b, by


def _serve_workload(vocab: int):
    """benchmarks/serve_bench.py's ``_workload(24, 2048, 32, vocab, 0)``."""
    import numpy as np
    rng = np.random.default_rng(0)
    lens = rng.integers(2, SERVE_MAX_SEQ - SERVE_NEW_TOKENS, size=SERVE_REQUESTS)
    return [rng.integers(0, vocab, size=int(n)) for n in lens]


def _pct(xs, p):
    import numpy as np
    return float(np.percentile(np.asarray(xs, np.float64), p))


def serve_path(torch, dev, cfg=None, tag: str = "serve"):
    """Phase 6 (and 23 (a) with its ``cfg``): granite-3-2b at full width
    through the engine. Every logit of the engine's first decode call (the
    eager step before a bucket's capture) is held finite. Returns
    (flash_decode launches in the drain, the engine, a dict of the drain's
    tok/s, TTFT p50 ms, ms a decode call, the profiled tick's busy share
    and the next tick's ms)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode
    from repro_torch.models import build_model
    from repro_torch.serve import BucketSpec, Request, make_engine
    from repro_torch.utils.tree import tree_leaves

    cfg = cfg or get_config(SERVE_ARCH)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    n_params = model.param_count(params)
    eng = make_engine(model, params, buckets=tuple(BucketSpec(b, s) for b, s in SERVE_BUCKETS),
                      prefill_chunk=PREFILL_CHUNK, device=dev)
    del params                                   # the engine keeps its serving copy
    torch.cuda.synchronize()
    cache_types = sorted({str(t.dtype)[6:] for t in tree_leaves(eng.state[0].cache)})
    log(f"[{tag}] {cfg.arch_id}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, {n_params:,} params (fp32 init + {cfg.dtype} "
        f"copy) in {time.perf_counter() - t0:.2f} s; KV cache {cache_types}; buckets "
        f"{SERVE_BUCKETS}, prefill chunk {PREFILL_CHUNK}")

    prefill_s, decode_s = [], []
    prefill_fn, decode_fn, step_fn = eng._prefill, eng._decode, eng._decode_step
    first = {}

    def first_step(bs, tok, pos):
        # the engine's first decode call, eager: its logits held finite
        if first:
            return step_fn(bs, tok, pos)
        logits, bs.cache = eng.model.decode_step(eng.params, tok, bs.cache, pos)
        first.update(finite=bool(torch.isfinite(logits).all()), shape=tuple(logits.shape),
                     dtype=str(logits.dtype)[6:])
        return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)

    def timed_prefill(*a):
        before = flash_decode.flash_decode.launches
        t = time.perf_counter()
        out = prefill_fn(*a)                     # ends in a device-to-host copy
        prefill_s.append(time.perf_counter() - t)
        assert flash_decode.flash_decode.launches == before, "prefill launched flash_decode"
        return out

    def timed_decode(*a):
        t = time.perf_counter()
        out = decode_fn(*a)
        decode_s.append(time.perf_counter() - t)
        return out

    eng._prefill, eng._decode, eng._decode_step = timed_prefill, timed_decode, first_step
    # warm-up (cuBLAS set-up, first launches): one request in each bucket
    for rid, n in ((-1, 8), (-2, 1000)):
        eng.submit(Request(rid=rid, prompt=np.arange(n, dtype=np.int32) % cfg.vocab_size,
                           max_new_tokens=2))
    eng.run_until_drained()
    eng.n_prefill_calls = eng.n_decode_calls = 0
    prefill_s.clear()
    decode_s.clear()
    log(f"[{tag}] the first decode call's logits {first['shape']} {first['dtype']}: all finite "
        f"{first['finite']}")
    assert first["finite"], f"{tag}: a logit of the first decode call is not finite"

    prompts = _serve_workload(cfg.vocab_size)
    flash_decode.flash_decode.launches = 0
    t0 = time.perf_counter()
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=np.asarray(p, np.int32),
                           max_new_tokens=SERVE_NEW_TOKENS))
    eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_decode.flash_decode.launches

    res = [eng.results[i] for i in range(SERVE_REQUESTS)]
    for r in res:
        assert len(r.tokens) == SERVE_NEW_TOKENS, f"request {r.rid}: {len(r.tokens)} tokens"
        assert all(0 <= t < cfg.padded_vocab for t in r.tokens), f"request {r.rid}: bad token"
    want = cfg.n_layers * eng.n_decode_calls * DECODE_LAUNCHES_PER_CALL
    log(f"[{tag}] drained {SERVE_REQUESTS} requests ({sum(len(p) for p in prompts)} prompt "
        f"tokens, buckets {[r.bucket for r in res]}) in {wall:.3f} s: "
        f"{eng.n_prefill_calls} prefill calls, {eng.n_decode_calls} decode calls; flash_decode "
        f"launches {launches}, expected {cfg.n_layers} x {eng.n_decode_calls} x "
        f"{DECODE_LAUNCHES_PER_CALL} = {want}")
    assert launches == want and launches > 0, f"flash_decode launches {launches} != {want}"
    counts = eng.compile_counts()
    log(f"[{tag}] compile_counts() {counts}: one prefill chunk shape and one decode graph a "
        f"bucket")
    assert all(c == {"prefill": 1, "decode": 1} for c in counts.values()), counts
    n_tok = sum(len(r.tokens) for r in res)
    ttft = [r.ttft for r in res]
    lat = [r.latency for r in res]
    log(f"[{tag}] generated {n_tok} tokens: {n_tok / wall:.2f} tok/s; "
        f"TTFT p50 {_pct(ttft, 50) * 1e3:.1f} ms, p95 {_pct(ttft, 95) * 1e3:.1f} ms; "
        f"latency p50 {_pct(lat, 50) * 1e3:.1f} ms, p95 {_pct(lat, 95) * 1e3:.1f} ms; "
        f"mean {statistics.mean(decode_s) * 1e3:.2f} ms per decode call, "
        f"{statistics.mean(prefill_s) * 1e3:.2f} ms per prefill call; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    log(f"[{tag}] sample tokens of request 0: {res[0].tokens[:12]}")
    busy, tick_ms = profile_decode_tick(torch, eng)
    return launches, eng, {"tok_s": n_tok / wall, "ttft_p50_ms": _pct(ttft, 50) * 1e3,
                           "decode_ms": statistics.mean(decode_s) * 1e3, "busy": busy,
                           "tick_ms": tick_ms}


def profile_decode_tick(torch, eng):
    """One engine tick in which both buckets decode and none prefills,
    under ``torch.profiler``: device busy share, top device ops, K3's
    share of the device time; then one more such tick unprofiled, its
    device span between CUDA events beside its wall time. Returns the
    profiled tick's busy share and the unprofiled tick's wall ms."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import Request
    for rid, n in enumerate((100, 200, 300, 400, 1100, 1200, 1300, 1400)):
        eng.submit(Request(rid=1000 + rid, max_new_tokens=8,
                           prompt=np.arange(n, dtype=np.int32) % eng.cfg.vocab_size))
    eng.step()                                   # admissions: prefill and one decode
    assert not eng.scheduler.queue and all(bs.active.all() for bs in eng.state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_us, spans = device_busy_us(prof)
    k3_us = sum(e.self_device_time_total for e in prof.key_averages()
                if "flash_decode_" in e.key)
    n_ops = sum(1 for e in prof.events()
                if e.key.startswith("aten::") and e.cpu_parent is None)
    log(f"[profile] decode tick (2 decode calls, 4 slots each) of {wall_ms:.1f} ms wall: "
        f"{len(spans)} device events, device busy {busy_us / 1e3:.3f} ms "
        f"({busy_us / 1e3 / wall_ms:.1%}), idle {1 - busy_us / 1e3 / wall_ms:.1%}; flash_decode "
        f"{k3_us / 1e3:.3f} ms ({k3_us / max(busy_us, 1e-9):.1%} of the busy time); "
        f"{n_ops} top-level PyTorch ops called from Python (each bucket's decode a CUDA graph; "
        f"before the graphs: {EAGER_TICK})")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    eng.step()
    end.record()
    end.synchronize()
    wall2_ms = (time.perf_counter() - t0) * 1e3
    log(f"[profile] the next decode tick unprofiled: {wall2_ms:.2f} ms wall, device span "
        f"{start.elapsed_time(end):.2f} ms between CUDA events "
        f"({start.elapsed_time(end) / wall2_ms:.1%} of the wall)")
    # the host's cost of one eager op on this machine, unprofiled: 2,000
    # in-place adds on a one-element tensor between synchronisations
    x = torch.zeros(1, device=eng.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        x.add_(1)
    torch.cuda.synchronize()
    log(f"[profile] host cost of one eager op here: {(time.perf_counter() - t0) / 2000 * 1e6:.1f} "
        f"us (2,000 x.add_(1) on a one-element CUDA tensor)")
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=15)
    for line in table.splitlines():
        log(f"[profile] {line}")
    eng.run_until_drained()
    return busy_us / 1e3 / wall_ms, wall2_ms


def card_vs_cpu_serve(torch, dev, dtype: str, fp8_cache: str = "", logits: bool = True):
    """Phase 7: the same prompts served on the card and on the CPU from
    the same weights, granite's widths cut to 2 layers and the prompts
    padded to SERVE_CPU_PROMPT_PAD so that the CPU finishes in time.
    Returns (tokens equal, max |logit diff| over a prefill and 8 decode
    steps fed the same tokens, max |logit|), the two logit numbers None
    without ``logits``; with ``fp8_cache``, also the card's logits on a
    cache of that type against its logits on a ``dtype`` cache
    (:func:`_fp8_vs_bf16`)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import BucketSpec, generate
    from repro_torch.utils.tree import tree_map

    cfg = replace(get_config(SERVE_ARCH), n_layers=2, dtype=dtype)
    model = build_model(cfg)
    params_cpu = model.init(torch.Generator().manual_seed(0))
    params_card = tree_map(lambda t: t.to(dev), params_cpu)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (5, 23)]
    kw = dict(max_new_tokens=8,
              buckets=(BucketSpec(2, 64, prompt_ceiling=SERVE_CPU_PROMPT_PAD),))
    t0 = time.perf_counter()
    toks_card = [r.tokens for r in generate(model, params_card, prompts, device=dev, **kw)]
    t1 = time.perf_counter()
    toks_cpu = [r.tokens for r in generate(model, params_cpu, prompts, device="cpu", **kw)]
    secs = {"card generate": t1 - t0, "cpu generate": time.perf_counter() - t1}

    from repro_torch.serve.engine import serving_params
    diff = scale = None
    said = "logits not compared"
    if logits:
        padded = np.zeros((2, SERVE_CPU_PROMPT_PAD), np.int32)
        for i, p in enumerate(prompts):
            padded[i, :len(p)] = p
        steps = {}
        with torch.no_grad():
            for name, params, d in (("card", params_card, dev), ("cpu", params_cpu, "cpu")):
                t0 = time.perf_counter()
                sp = serving_params(params, getattr(torch, dtype))
                cache = model.init_cache(2, 64, d)
                out, cache = model.prefill(sp, torch.as_tensor(padded, device=d), cache, 0)
                steps[name] = [out.float().cpu()]
                pos = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=d)
                for i in range(8):
                    tok = torch.tensor([[t[i]] for t in toks_cpu], device=d)
                    out, cache = model.decode_step(sp, tok, cache, pos + i)
                    steps[name].append(out.float().cpu())
                secs[f"{name} logits"] = time.perf_counter() - t0
        diff = max((a - b).abs().max().item() for a, b in zip(steps["card"], steps["cpu"]))
        scale = max(b.abs().max().item() for b in steps["cpu"])
        said = (f"max |logit diff| {diff:.3e} over a prefill and 8 decode steps (max |logit| "
                f"{scale:.3f})")
    log(f"[card-vs-cpu serve] {cfg.arch_id} widths, 2 layers, {dtype}: tokens card "
        f"{toks_card} / cpu {toks_cpu}; {said}; seconds "
        f"{ {k: round(v, 2) for k, v in secs.items()} }")
    if not fp8_cache:
        return toks_card == toks_cpu, diff, scale
    t0 = time.perf_counter()
    with torch.no_grad():
        rel = _fp8_vs_bf16(torch, model, serving_params(params_card, getattr(torch, dtype)), dev,
                           cache=fp8_cache)
    log(f"[card-vs-cpu serve] {dtype} on the card, a {fp8_cache} cache against a {dtype} one, "
        f"{MOE_FP8_STEPS} decode steps after a 64-token prefill: max |logit diff| / max |logit| "
        f"{rel:.4f} (bound {MOE_FP8_RTOL}) in {time.perf_counter() - t0:.2f} s")
    return toks_card == toks_cpu, diff, scale, rel


# ---------------------------------------------------------------- phase 17


def _drain(torch, eng, prompts, new_tokens: int):
    """Submit ``prompts`` and drain with K3's count from 0; returns (wall
    s, K3 launches, the results in order)."""
    import numpy as np

    from repro_torch.kernels import flash_decode
    from repro_torch.serve import Request
    eng.n_prefill_calls = eng.n_decode_calls = 0
    flash_decode.flash_decode.launches = 0
    t0 = time.perf_counter()
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=np.asarray(p, np.int32), max_new_tokens=new_tokens))
    eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return wall, flash_decode.flash_decode.launches, [eng.results[i] for i in range(len(prompts))]


def _check_drain(eng, res, launches: int, new_tokens: int, label: str) -> None:
    """Every request drained with its tokens, 1/1 compile counts a bucket,
    K3 once a layer a decode call."""
    cfg = eng.cfg
    for r in res:
        assert len(r.tokens) == new_tokens, f"{label} request {r.rid}: {len(r.tokens)} tokens"
        assert all(0 <= t < cfg.padded_vocab for t in r.tokens), f"{label} {r.rid}: bad token"
    counts = eng.compile_counts()
    want = cfg.n_layers * eng.n_decode_calls
    log(f"[moe] {label}: {len(res)} requests drained, {eng.n_prefill_calls} prefill calls, "
        f"{eng.n_decode_calls} decode calls, flash_decode launches {launches} (expected "
        f"{cfg.n_layers} x {eng.n_decode_calls} = {want}); compile_counts() {counts}")
    assert launches == want and launches > 0, f"{label}: flash_decode launches {launches}"
    assert all(c == {"prefill": 1, "decode": 1} for c in counts.values()), counts


def _graph_vs_eager(torch, eng, model, dev):
    """The first MOE_EAGER_TICKS ticks of bucket 0 (4 requests), replayed
    from its graph, against an eager ``decode_step`` loop on the card
    from the same prefilled cache. Returns (equal, the ticks' tokens)."""
    import numpy as np

    from repro_torch.serve import Request
    from repro_torch.utils.tree import tree_map
    bs0 = eng.state[0]
    snap = {"ticks": []}
    decode = eng._decode

    def spy(bs):
        if bs is bs0 and "cache" not in snap:
            snap.update(cache=tree_map(torch.clone, bs.cache), tok=bs.last_tok.copy(),
                        pos=bs.pos.copy())
        out = decode(bs)
        if bs is bs0:
            snap["ticks"].append(out.copy())
        return out

    eng._decode = spy
    rng = np.random.default_rng(1)
    for rid, n in enumerate((5, 300, 700, 990)):
        eng.submit(Request(rid=-1 - rid, prompt=rng.integers(0, model.cfg.vocab_size, n)
                           .astype(np.int32), max_new_tokens=MOE_EAGER_TICKS + 1))
    eng.run_until_drained()
    eng._decode = decode
    cache = snap["cache"]
    tok = torch.as_tensor(snap["tok"], device=dev)[:, None]
    pos = torch.as_tensor(snap["pos"], device=dev)
    eager = []
    with torch.no_grad():
        for _ in range(MOE_EAGER_TICKS):
            logits, cache = model.decode_step(eng.params, tok, cache, pos)
            nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
            eager.append(nxt.cpu().numpy())
            tok, pos = nxt[:, None], pos + 1
    graphed = snap["ticks"][:MOE_EAGER_TICKS]
    return all(np.array_equal(a, b) for a, b in zip(eager, graphed)), graphed


def _fp8_vs_bf16(torch, model, params, dev, cache: str = "float8_e4m3fn"):
    """Phase 17 (b) (and phase 7's e5m2 against fp16): one prefill of 4
    prompts of 64 tokens into a cache of the model's activation type and
    one of the fp8 type ``cache``, then MOE_FP8_STEPS decode steps on the
    same (greedy, from the first cache) tokens. Returns max |logit diff| /
    max |logit| over the decode steps."""
    from repro_torch.models import build_model

    m8 = build_model(replace(model.cfg, cache_dtype=cache))
    gen = torch.Generator(device=dev).manual_seed(5)
    toks = torch.randint(0, model.cfg.vocab_size, (4, 64), generator=gen, device=dev)
    c16, c8 = model.init_cache(4, 128, dev), m8.init_cache(4, 128, dev)
    diff = scale = 0.0
    with torch.no_grad():
        l16, c16 = model.prefill(params, toks, c16, 0)
        l8, c8 = m8.prefill(params, toks, c8, 0)
        for step in range(MOE_FP8_STEPS):
            tok = torch.argmax(l16[:, -1, :], dim=-1)[:, None]
            l16, c16 = model.decode_step(params, tok, c16, 64 + step)
            l8, c8 = m8.decode_step(params, tok, c8, 64 + step)
            diff = max(diff, (l16.float() - l8.float()).abs().max().item())
            scale = max(scale, l16.float().abs().max().item())
    from repro_torch.utils.tree import tree_leaves
    assert {t.dtype for t in tree_leaves(c8)} == {getattr(torch, cache)}
    return diff / scale


def moe_serve_path(torch, dev):
    """Phase 17 (a) and (b): kimi-k2 at full width, 2 layers, served
    through the graphed engine. Returns (K3 launches of the drain, a
    dict of what the [done] line reports)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.transformer import layer_kinds
    from repro_torch.serve import BucketSpec, Request, make_engine
    from repro_torch.utils.tree import tree_leaves

    full = get_config(MOE_ARCH)
    cfg = replace(full, n_layers=MOE_LAYERS)
    log(f"reduced: {MOE_ARCH} n_layers {full.n_layers} → {MOE_LAYERS} (layer kinds "
        f"{layer_kinds(cfg)})")
    model = build_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tree_leaves(params)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    init_peak = torch.cuda.max_memory_allocated()
    log(f"[moe] {cfg.arch_id}: d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.head_dim}, {cfg.n_experts} experts top-{cfg.top_k} + {cfg.n_shared_experts} "
        f"shared, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}: {model.param_count(params):,} params, "
        f"{param_bytes / 1e9:.2f} GB, drawn in {init_s:.2f} s; peak device memory at init "
        f"{init_peak / 1e9:.2f} GB (the experts drawn 8 at a time)")
    eng = make_engine(model, params, buckets=tuple(BucketSpec(b, s) for b, s in SERVE_BUCKETS),
                      prefill_chunk=PREFILL_CHUNK, device=dev)
    assert eng.params["layers"]["period0"]["moe"]["router"]["w"].dtype == torch.float32

    same, ticks = _graph_vs_eager(torch, eng, model, dev)
    log(f"[moe] bucket {eng.state[0].spec.name}: {MOE_EAGER_TICKS} ticks replayed from its "
        f"graph equal an eager decode_step loop on the card: {same} (tokens of the first rows: "
        f"{[int(t[0]) for t in ticks]})")
    assert same, "the graphed decode and the eager loop give different tokens"
    eng.submit(Request(rid=-9, prompt=np.arange(1100, dtype=np.int32) % cfg.vocab_size,
                       max_new_tokens=2))
    eng.run_until_drained()

    prompts = _serve_workload(cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    decode_s = []
    decode_fn = eng._decode

    def timed_decode(*a):
        t = time.perf_counter()
        out = decode_fn(*a)
        decode_s.append(time.perf_counter() - t)
        return out

    eng._decode = timed_decode
    wall, launches, res = _drain(torch, eng, prompts, SERVE_NEW_TOKENS)
    eng._decode = decode_fn
    _check_drain(eng, res, launches, SERVE_NEW_TOKENS, "kimi-k2 full width")
    n_tok = sum(len(r.tokens) for r in res)
    ttft = [r.ttft for r in res]
    emb = params["embedding"]["table"]
    # every weight but the embedding table is read once a decode call: the
    # expert products read all 384 experts at capacity 8
    tick_bytes = param_bytes - emb.numel() * emb.element_size()
    tick_ms = statistics.mean(decode_s) * 1e3
    info = {"tok_s": n_tok / wall, "ttft_p50_ms": _pct(ttft, 50) * 1e3,
            "tick_ms": tick_ms, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "init_peak_gb": init_peak / 1e9, "tick_gb": tick_bytes / 1e9}
    log(f"[moe] kimi-k2 full width, 2 layers: {n_tok} tokens in {wall:.3f} s, "
        f"{info['tok_s']:.2f} tok/s; TTFT p50 {info['ttft_p50_ms']:.1f} ms, p95 "
        f"{_pct(ttft, 95) * 1e3:.1f} ms; {tick_ms:.2f} ms a decode call (mean of "
        f"{len(decode_s)}); a decode call reads >= {tick_bytes / 1e9:.2f} GB of weights -> "
        f"{tick_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s; "
        f"peak device memory {info['peak_gb']:.2f} GB")
    info["busy"], _ = profile_decode_tick(torch, eng)

    rel = _fp8_vs_bf16(torch, model, eng.params, dev)
    log(f"[moe] (b) fp8 cache against the bf16 cache, {MOE_FP8_STEPS} decode steps after a "
        f"64-token prefill: max |logit diff| / max |logit| {rel:.4f} (bound {MOE_FP8_RTOL})")
    assert rel < MOE_FP8_RTOL, f"fp8 cache logits {rel} off the bf16 cache's"
    info["fp8_rel"] = rel
    del eng, params, leaves, emb
    return launches, info


def moe_smoke_serve(torch, dev):
    """Phase 17 (c): llama4-maverick at its smoke() widths (top-1, a dense
    and a moe layer) through the same engine, buckets and workload.
    Returns the K3 launches of its drain."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import BucketSpec, make_engine

    cfg = get_config(MOE_SMOKE_ARCH).smoke()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    eng = make_engine(model, params, buckets=tuple(BucketSpec(b, s) for b, s in SERVE_BUCKETS),
                      prefill_chunk=PREFILL_CHUNK, device=dev)
    wall, launches, res = _drain(torch, eng, _serve_workload(cfg.vocab_size), SERVE_NEW_TOKENS)
    _check_drain(eng, res, launches, SERVE_NEW_TOKENS, f"{cfg.arch_id} (top-{cfg.top_k}, "
                                                      f"moe_every {cfg.moe_every})")
    log(f"[moe] (c) {cfg.arch_id}: {sum(len(r.tokens) for r in res)} tokens in {wall:.3f} s")
    return launches


# ---------------------------------------------------------------- phase 18


def _profiled_decode_step(torch, model, params, dev, arch: str, pos: int,
                          tag: str = "ssm") -> dict:
    """One decode step of ``model`` (``SSM_SERVE_BATCH`` rows, a fresh
    cache of the loop's length) at position ``pos`` under
    ``torch.profiler``, after one unprofiled step there. The step's device
    work does not depend on what the cache holds (K3 reads the ``pos + 1``
    columns of each row). Returns {step_wall_ms, busy_ms, k3_ms}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train.steps import make_serve_step

    cache = model.init_cache(SSM_SERVE_BATCH, SSM_PROMPT_LEN + SSM_NEW_TOKENS + 1, dev)
    step = make_serve_step(model)
    tok = torch.zeros((SSM_SERVE_BATCH, 1), dtype=torch.int32, device=dev)
    step(params, tok, cache, pos)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, tok, cache, pos)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_us, spans = device_busy_us(prof)
    k3_us = sum(e.time_range.end - e.time_range.start for e in prof.events()
                if e.device_type == DeviceType.CUDA and "flash_decode_" in e.name)
    out = {"step_wall_ms": wall_ms, "busy_ms": busy_us / 1e3, "k3_ms": k3_us / 1e3}
    log(f"[{tag}] {arch}: a profiled decode step at position {pos}, {wall_ms:.2f} ms wall: "
        f"{len(spans)} device events, device busy {out['busy_ms']:.3f} ms "
        f"({out['busy_ms'] / wall_ms:.1%}), idle {1 - out['busy_ms'] / wall_ms:.1%}; "
        f"flash_decode {out['k3_ms']:.4f} ms ({out['k3_ms'] / max(out['busy_ms'], 1e-9):.2%} of "
        f"the busy time)")
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=8)
    for line in table.splitlines():
        log(f"[profile] {line}")
    return out


def k3_per_step(cfg) -> int:
    """flash_decode calls a decode step of ``cfg``'s model: one a shared
    attention block (hybrid), two a decoder layer (encdec: self and
    cross), one a layer (the attention families), none (ssm)."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    if cfg.family == "ssm":
        return 0
    return cfg.n_layers * (2 if cfg.family == "encdec" else 1)


def _served_config_line(cfg) -> str:
    if cfg.family in ("ssm", "hybrid"):
        return (f"{cfg.family}, {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_ssm_heads} "
                f"SSD heads of {cfg.ssm_head_dim}, state {cfg.ssm_state}, vocab {cfg.vocab_size}, "
                f"activations {cfg.dtype}"
                + (f"; the shared block ({cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, "
                   f"d_ff {cfg.d_ff}) after every {cfg.attn_every}th layer, window "
                   f"{cfg.sliding_window}" if cfg.family == "hybrid" else ""))
    enc = (f" + {cfg.n_encoder_layers} encoder layers, cross cache of {cfg.encoder_seq}"
           if cfg.family == "encdec" else "")
    return (f"{cfg.family}, {cfg.n_layers} layers{enc}, d_model {cfg.d_model}, "
            f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim} (G "
            f"{cfg.n_heads // cfg.n_kv_heads}), d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
            f"activations {cfg.dtype}, params {cfg.param_dtype}")


def loop_serve_path(torch, dev, arch: str, card: str, layers: int = 0,
                    tag: str = "ssm") -> tuple:
    """Phase 18 (a) / (b) and 19 (a) / (b): ``arch`` as registered (cut to
    ``layers`` layers at full width if given) through ``run_serve(...,
    smoke=False, engine="auto")``, which must take the per-token loop:
    ``SSM_SERVE_BATCH`` prompts of ``SSM_PROMPT_LEN`` tokens and
    ``SSM_NEW_TOKENS`` new ones, every prompt token and every new token
    but the last one decode step. K3 launches from this run alone:
    :func:`k3_per_step` a step. Before it, on the same model and weights
    as run_serve builds them: a warm-up (cuBLAS set-up, first launches)
    and a profiled decode step at the run's last position. Returns (K3
    launches, {tok_s, step_ms, wall_s, peak_gb, params, and the profiled
    step's})."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode
    from repro_torch.launch.serve import loop_generate, run_serve
    from repro_torch.models import build_model

    cfg = get_config(arch)
    if layers:
        cfg = replace(cfg, n_layers=layers)
    steps = SSM_PROMPT_LEN + SSM_NEW_TOKENS - 1
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    n_params = model.param_count(params)
    loop_generate(model, params, torch.zeros((SSM_SERVE_BATCH, 2), dtype=torch.int32,
                                             device=dev), 2)
    profiled = _profiled_decode_step(torch, model, params, dev, arch, steps - 1, tag)
    del model, params
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_decode.flash_decode.launches = 0
    gen, info = run_serve(arch, batch=SSM_SERVE_BATCH, prompt_len=SSM_PROMPT_LEN,
                          tokens=SSM_NEW_TOKENS, smoke=False, engine="auto", device=dev,
                          layers=layers)
    launches = flash_decode.flash_decode.launches
    per_step = k3_per_step(cfg)
    want = per_step * steps
    out = {"tok_s": info["tok_per_s"], "step_ms": info["wall_s"] / steps * 1e3,
           "wall_s": info["wall_s"], "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "params": n_params}
    log(f"[{tag}] {arch} {'cut to ' + str(layers) + ' layers' if layers else 'as registered'}: "
        f"{_served_config_line(cfg)}; {n_params:,} params")
    log(f"[{tag}] {arch}: run_serve path {info['path']!r}, {SSM_SERVE_BATCH} prompts of "
        f"{SSM_PROMPT_LEN} tokens, {SSM_NEW_TOKENS} new tokens: {steps} decode steps in "
        f"{info['wall_s']:.3f} s, {out['tok_s']:.2f} tok/s (new tokens), {out['step_ms']:.2f} ms "
        f"a decode step; peak device memory {out['peak_gb']:.2f} GB; flash_decode launches "
        f"{launches}, expected {per_step} x {steps} = {want} ({card})")
    log(f"[{tag}] {arch}: tokens of prompt 0: {gen[0, :12].tolist()}")
    assert info["path"] == "loop", f"{arch} served through {info['path']}"
    assert gen.shape == (SSM_SERVE_BATCH, SSM_NEW_TOKENS), gen.shape
    assert ((gen >= 0) & (gen < cfg.padded_vocab)).all(), f"{arch}: a token out of range"
    assert launches == want, f"{arch}: flash_decode launches {launches} != {want}"
    if cfg.family == "hybrid":
        last = steps - 1
        log(f"[{tag}] {arch}: positions 0..{last} stay below the {cfg.sliding_window}-position "
            f"window: K3 receives window={cfg.sliding_window} and masks no key here")
        assert last < cfg.sliding_window
    out.update(profiled)
    torch.cuda.empty_cache()
    return launches, out


def check_flash_decode_shape(torch, dev, label: str, H: int, KV: int, D: int, seqs,
                             window: int = 0, back: int = 3, seed: int = 19) -> float:
    """Phase 18 (c) and 19 (c): K3 at q (4,H,1,D) against a cache stored
    (4,S,KV,D), at each S in ``seqs``, with per-row positions (S-1, 0, S/2, 3S/4-1) and with one
    scalar position, S - ``back`` (3: at 129 the loop's last decode step,
    126, as the loop passes it; 1: the cross cache's last key, as encdec
    decode passes it), against its plain version: fp32 within 2e-5,
    bf16 within 2e-2 of the plain output's largest magnitude (two bf16
    steps at it; the outputs are means of O(1) values over up to S keys,
    so a flat 2e-2 would pass a kernel that dropped keys). Returns the max
    abs error of the bf16 cases."""
    from repro_torch.kernels import flash_decode, ref
    gen = torch.Generator(device=dev).manual_seed(seed)
    err_bf16 = 0.0
    for S in seqs:
        rows = torch.tensor([S - 1, 0, S // 2, 3 * S // 4 - 1], dtype=torch.int32, device=dev)
        for dtype in (torch.bfloat16, torch.float32):
            for pos in (rows, S - back):
                q, k, v = _decode_case(torch, dev, gen, 4, H, KV, S, D, dtype)
                got = flash_decode.flash_decode(q, k, v, pos, window)
                expect = ref.decode_attention(q, k, v, pos, window).float()
                torch.cuda.synchronize()
                scale = expect.abs().max().item()
                tol = 2e-5 if dtype == torch.float32 else 2e-2 * scale
                err = (got.float() - expect).abs().max().item()
                at = f"pos {pos.tolist() if torch.is_tensor(pos) else pos}"
                log(f"[kernels] flash_decode {label} (4,{H},1,{D}) vs (4,{S},{KV},{D}) "
                    f"{str(dtype)[6:]}, {at}, window {window}: max abs err {err:.3e} (tol "
                    f"{tol:.3e}; max |out| {scale:.3f})")
                assert err <= tol, f"flash_decode {label} S={S} {dtype} {at}: {err} > {tol}"
                if dtype == torch.bfloat16:
                    err_bf16 = max(err_bf16, err)
    return err_bf16


def card_vs_cpu_loop_serve(torch, dev, arch: str, tag: str = "ssm"):
    """Phase 18 (d) and 19 (d): ``arch``'s smoke config in fp32 through the
    per-token loop on the card and on the CPU from the same weights: the
    tokens, then the decode logits teacher-forced on the prompt and the
    CPU's tokens (for encdec with the same random non-zero cross cache on
    both, so that the cross-attention reads keys that differ). Returns
    (tokens equal, max |logit diff|, max |logit|)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import loop_generate
    from repro_torch.models import build_model
    from repro_torch.utils.tree import tree_map

    model = build_model(get_config(arch).smoke())
    cfg = model.cfg
    params = model.init(torch.Generator().manual_seed(0))
    params_card = tree_map(lambda t: t.to(dev), params)
    prompts = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 9)))
    card = loop_generate(model, params_card, prompts.to(dev), 8).cpu()
    cpu = loop_generate(model, params, prompts, 8)
    seq = torch.cat([prompts, cpu.long()], 1)
    diff = scale = 0.0
    with torch.no_grad():
        c_card = model.init_cache(2, seq.shape[1], dev)
        c_cpu = model.init_cache(2, seq.shape[1], "cpu")
        if cfg.family == "encdec":
            gen = torch.Generator().manual_seed(8)
            for name in ("cross_k", "cross_v"):
                c_cpu[name].normal_(generator=gen)
                c_card[name].copy_(c_cpu[name])
        for t in range(seq.shape[1]):
            a, _ = model.decode_step(params_card, seq[:, t:t + 1].to(dev), c_card, t)
            b, _ = model.decode_step(params, seq[:, t:t + 1], c_cpu, t)
            diff = max(diff, (a.cpu() - b).abs().max().item())
            scale = max(scale, b.abs().max().item())
    log(f"[card-vs-cpu {tag}] {cfg.arch_id} ({cfg.family}, fp32): tokens card {card.tolist()} / "
        f"cpu {cpu.tolist()}; max |logit diff| {diff:.3e} over {seq.shape[1]} decode steps "
        f"(max |logit| {scale:.3f})" + (", random cross cache" if cfg.family == "encdec" else ""))
    return torch.equal(card, cpu), diff, scale


def ssm_swarm(torch, dev, lm_data, card: str):
    """Phase 18 (e): phase 15's swarm settings on mamba2-370m at full width
    with its depth cut to ``SSM_SWARM_LAYERS``, ``SSM_SWARM_ROUNDS``
    rounds with the coordinator's launch counts asserted (``lm_fit``) and
    a profiled round; then one round of zamba2's smoke config on the card
    and on the CPU from one state and one set of draws. Returns
    (launches, round seconds, peak bytes)."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import make_token_swarm_data

    full, cfg = get_config(SSM_ARCH), _ssm_swarm_config()
    log(f"reduced: {SSM_ARCH} n_layers {full.n_layers} → {SSM_SWARM_LAYERS} in the swarm round "
        f"(6 clients' params, adam state, gradients and transients on one card; "
        f"{SSM_SWARM_LAYERS + 1} run out of memory after the earlier phases)")
    log(f"reduced: token data vocab {full.vocab_size} → {LM_DATA_VOCAB} (phase 15's data; the "
        f"model keeps its {full.vocab_size}-row embedding and read-out)")
    tr, launches, secs, peak = lm_fit(torch, dev, cfg, lm_data, SSM_SWARM_ROUNDS, "ssm")
    log(f"[lm ssm] round seconds {[round(s, 4) for s in secs]}; peak {peak / 1e9:.2f} GB of the "
        f"card's {torch.cuda.get_device_properties(dev).total_memory / 1e9:.1f} GB at "
        f"{SSM_SWARM_LAYERS} layers ({card})")
    profile_round(torch, tr)
    del tr
    torch.cuda.empty_cache()
    smoke_cfg = get_config(HYBRID_ARCH).smoke()
    smoke_data = make_token_swarm_data(LM_CLIENTS, smoke_cfg.vocab_size, n_seqs=LM_SEQS,
                                       seq_len=LM_SEQ_LEN)
    diff, m_card, m_cpu = card_vs_cpu(torch, lm_trainer(dev, smoke_cfg, smoke_data, 1),
                                      smoke_data, local_steps=2, eps=1e-6, batch=LM_BATCH,
                                      k=LM_CLUSTERS)
    log(f"[card-vs-cpu ssm swarm] {smoke_cfg.arch_id}, 2 local steps, adam eps 1e-6: assignments "
        f"{m_card.assignments.tolist()} / {m_cpu.assignments.tolist()}, centers "
        f"{m_card.centers.tolist()} / {m_cpu.centers.tolist()}, max |param diff| {diff:.3e}, "
        f"max |val acc diff| {(m_card.val_acc.cpu() - m_cpu.val_acc).abs().max().item():.3e}")
    assert torch.equal(m_card.assignments.cpu(), m_cpu.assignments), "zamba2 assignments differ"
    assert torch.equal(m_card.centers.cpu(), m_cpu.centers), "zamba2 centers differ"
    # atol 1e-4, as phase 4
    assert diff <= 1e-4, f"card and CPU zamba2 params differ by {diff}"
    return launches, secs, peak


def ssm_depth_probe(torch, dev, depths) -> int:
    """``--ssm-depth-probe N ...``: one round of phase 18 (e)'s mamba2 fit
    at each depth in ascending order, alone in this process, its peak
    device memory printed, up to the first depth that runs out of memory.
    Its reading sets ``SSM_SWARM_LAYERS`` (PERF.md §4)."""
    import gc

    from repro_torch.kernels import _build
    _build.build()
    card = card_line()
    log(card)
    lm_data = lm_clients(LM_DATA_VOCAB)
    total = torch.cuda.get_device_properties(dev).total_memory / 1e9
    for n in sorted(depths):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tr = None
        try:
            tr = lm_trainer(dev, _ssm_swarm_config(n), lm_data, 1)
            tr.round()
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError as e:
            log(f"[depth probe] {SSM_ARCH} at {n} layers: out of memory in the round "
                f"({str(e).splitlines()[0]}) ({card})")
            return 0
        finally:
            tr = None
        log(f"[depth probe] {SSM_ARCH} at {n} layers: one round, peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB of the card's {total:.1f} GB "
            f"({card})")
    return 0


def ssm_phase(torch, dev, lm_data, card: str) -> dict:
    """Phase 18 (a)-(e). Returns what the [done] line and the kernels line
    read: K1 / K2 launch counts of (e), K3 launches of (b), and the
    numbers printed."""
    import gc
    # what earlier phases left in reference cycles (an engine and its
    # graphs) would count in this phase's peak memory
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _, mamba = loop_serve_path(torch, dev, SSM_ARCH, card)
    k3, zamba = loop_serve_path(torch, dev, HYBRID_ARCH, card)
    log(f"[ssm] zamba2 decode step: flash_decode {zamba['k3_ms']:.4f} ms of {zamba['busy_ms']:.3f} "
        f"ms busy ({zamba['k3_ms'] / max(zamba['busy_ms'], 1e-9):.2%}) ({card})")
    # zamba2's shape (G = 1) at the loop's 129-position cache (a ragged
    # last tile) and 4,096, under its window
    k3_err = check_flash_decode_shape(torch, dev, "zamba2", 32, 32, 64, SSM_K3_SEQS, SSM_WINDOW,
                                      seed=18)
    times = {S: time_flash_decode(torch, dev, 32, 64, label="zamba2", KV=32, S=S,
                                  window=SSM_WINDOW) for S in SSM_K3_SEQS}
    for arch in (SSM_ARCH, HYBRID_ARCH):
        same, diff, _ = card_vs_cpu_loop_serve(torch, dev, arch)
        assert same, f"{arch}: card and CPU generate different tokens in fp32"
        # 1e-3, as phase 7
        assert diff <= 1e-3, f"{arch}: card and CPU logits differ by {diff}"
    launches, secs, peak = ssm_swarm(torch, dev, lm_data, card)
    log(f"[ssm] phase 18 in {time.perf_counter() - t0:.1f} s")
    return {"k3": k3, "k3_err": k3_err, "k3_times": times, "mamba": mamba, "zamba": zamba,
            "launches": launches, "round_s": secs, "peak_gb": peak / 1e9}


# ---------------------------------------------------------------- phase 19


def _bytes(tree) -> int:
    from repro_torch.utils.tree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _family_batch(torch, cfg, B: int, S_text: int, dev, seed: int) -> dict:
    """The reference's ``input_specs`` layout for a train batch: tokens and
    labels (B, S_text) int32, plus the frontend stub's rows in the
    activation dtype (encdec: (B, encoder_seq, d) audio frames; vlm:
    (B, n_vision_tokens, d) patches), random from ``seed``."""
    from repro_torch.models.layers import dtype_of
    gen = torch.Generator(device=dev).manual_seed(seed)

    def ids():
        return torch.randint(0, cfg.vocab_size, (B, S_text), generator=gen, device=dev,
                             dtype=torch.int32)

    batch = {"tokens": ids(), "labels": ids()}
    rows = {"encdec": ("audio_embed", cfg.encoder_seq),
            "vlm": ("vision_embed", cfg.n_vision_tokens)}.get(cfg.family)
    if rows:
        batch[rows[0]] = (torch.randn((B, rows[1], cfg.d_model), generator=gen, device=dev)
                          * 0.02).to(dtype_of(cfg.dtype))
    return batch


def timed_train(torch, model, opt, params, batch, steps: int, lr: float, microbatches: int,
                label: str, card: str):
    """``steps`` train steps (``make_train_step(..., microbatches=)``) from
    ``params``, each timed to a synchronize, the loss read after it.
    Returns (params, opt state, seconds a step, losses, peak bytes)."""
    from repro_torch.train.steps import make_train_step
    step = make_train_step(model, opt, microbatches=microbatches)
    state = opt.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        params, state, met = step(params, state, batch, lr)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(met["loss"]))
    peak = torch.cuda.max_memory_allocated()
    log(f"[train] {label}: {opt.name}, microbatches {microbatches}, {steps} steps, seconds "
        f"{[round(x, 4) for x in secs]}, losses {[round(x, 4) for x in losses]}, peak "
        f"{peak / 1e9:.2f} GB ({card})")
    assert all(math.isfinite(x) for x in losses), f"{label}: a loss is not finite"
    return params, state, secs, losses, peak


def _max_tree_diff(a, b):
    """(max |a - b| over every leaf, the path of the leaf that holds it)."""
    from repro_torch.utils.tree import tree_paths_and_leaves
    return max(((x.float().cpu() - y.float().cpu()).abs().max().item(), p)
               for (p, x), (_, y) in zip(tree_paths_and_leaves(a), tree_paths_and_leaves(b)))


def encdec_vlm_train(torch, dev, card: str) -> dict:
    """Phase 19 (e): whisper-base uncut and internvl2-26b at full width cut
    to ``VLM_TRAIN_LAYERS``, trained with gradient accumulation and
    adamw; the accumulation held against the full batch; adafactor on
    whisper-base; one adafactor step of whisper's smoke config on the
    card and on the CPU."""
    from repro_torch.configs import OptimizerConfig, get_config
    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import Optimizer, make_optimizer
    from repro_torch.train.steps import make_train_step
    from repro_torch.utils.tree import tree_leaves, tree_map, tree_paths_and_leaves

    out = {}
    adamw = make_optimizer(OptimizerConfig(name="adamw", lr=TRAIN_ADAMW_LR,
                                           weight_decay=TRAIN_ADAMW_WD))
    adafactor = make_optimizer(OptimizerConfig(name="adafactor", lr=TRAIN_ADAFACTOR_LR,
                                               grad_clip=1.0))
    # whisper-base uncut: adamw with 2 microbatches
    wm = build_model(get_config(ENCDEC_ARCH))
    p0 = wm.init(torch.Generator(device=dev).manual_seed(0))
    wb = _family_batch(torch, wm.cfg, ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ, dev, 1)
    log(f"[train] {ENCDEC_ARCH} uncut ({wm.param_count(p0):,} params, {wm.cfg.param_dtype} "
        f"params, {wm.cfg.dtype} activations): audio_embed {tuple(wb['audio_embed'].shape)}, "
        f"tokens {tuple(wb['tokens'].shape)}")
    _, _, secs, _, peak = timed_train(torch, wm, adamw, p0, wb, ENCDEC_TRAIN_STEPS,
                                      TRAIN_ADAMW_LR, TRAIN_MICROBATCHES, ENCDEC_ARCH, card)
    out["whisper"] = {"step_s": secs, "peak_gb": peak / 1e9}
    # accumulation against the full batch, from one state: an "optimizer"
    # whose update returns the gradients, so the step's output is the
    # averaged gradients that make_train_step hands to the update
    grads_out = Optimizer("grads", lambda p: {}, lambda g, s, p, lr: (g, s))
    g_one, g_mb, g_half = (
        make_train_step(wm, grads_out, microbatches=n)(p0, {}, b, TRAIN_ADAMW_LR)[0]
        for n, b in ((1, wb), (TRAIN_MICROBATCHES, wb),
                     (1, tree_map(lambda x: x[:len(x) // TRAIN_MICROBATCHES], wb))))
    g_scale = max(t.abs().max().item() for t in tree_leaves(g_one))
    mb_diff, mb_at = _max_tree_diff(g_one, g_mb)
    half_diff, _ = _max_tree_diff(g_one, g_half)
    limit = MB_GRAD_RTOL * g_scale
    log(f"[train] {ENCDEC_ARCH}: one step's gradients, microbatches 1 vs {TRAIN_MICROBATCHES}: "
        f"max |diff| {mb_diff:.3e} at {mb_at}, max |grad| {g_scale:.3e}, limit {limit:.3e} "
        f"({MB_GRAD_RTOL} of max |grad|: bf16 rounding of the partial sums); the first "
        f"microbatch alone differs by {half_diff:.3e}, one not divided by the count would by "
        f"{g_scale:.3e}")
    assert mb_diff <= limit, f"microbatched and full-batch whisper gradients differ by {mb_diff}"
    assert half_diff > limit, (f"half the batch gives gradients within {half_diff} of the whole "
                               f"batch's: the accumulation check cannot tell them apart")
    out["mb_diff"] = mb_diff / g_scale
    del g_one, g_mb, g_half
    # adafactor on whisper-base uncut
    _, st, secs, _, peak = timed_train(torch, wm, adafactor, p0, wb, ENCDEC_TRAIN_STEPS,
                                       TRAIN_ADAFACTOR_LR, 1, ENCDEC_ARCH, card)
    adam_bytes = _bytes(adamw.init(p0))
    out["adafactor"] = {"step_s": secs, "peak_gb": peak / 1e9, "state_bytes": _bytes(st),
                        "adam_bytes": adam_bytes}
    log(f"[train] {ENCDEC_ARCH}: adafactor state {_bytes(st):,} bytes against adamw's "
        f"{adam_bytes:,} ({_bytes(st) / adam_bytes:.2%})")
    del p0, st, wb
    torch.cuda.empty_cache()
    # internvl2-26b at full width, cut: adamw with 2 microbatches
    full = get_config(VLM_ARCH)
    vm = build_model(replace(full, n_layers=VLM_TRAIN_LAYERS))
    log(f"reduced: {VLM_ARCH} n_layers {full.n_layers} → {VLM_TRAIN_LAYERS} in training (adamw "
        f"over fp32 params holds params, gradients, m and v and their updated copies at once: "
        f"about 8 x the params' bytes at the update)")
    vp = vm.init(torch.Generator(device=dev).manual_seed(0))
    vb = _family_batch(torch, vm.cfg, VLM_TRAIN_BATCH, VLM_TRAIN_TEXT, dev, 2)
    log(f"[train] {VLM_ARCH} at {VLM_TRAIN_LAYERS} layers: {vm.param_count(vp):,} params "
        f"({_bytes(vp) / 1e9:.2f} GB); vision_embed {tuple(vb['vision_embed'].shape)}, tokens "
        f"{tuple(vb['tokens'].shape)}")
    _, _, secs, _, peak = timed_train(torch, vm, adamw, vp, vb, VLM_TRAIN_STEPS, TRAIN_ADAMW_LR,
                                      TRAIN_MICROBATCHES, VLM_ARCH, card)
    out["internvl"] = {"step_s": secs, "peak_gb": peak / 1e9}
    del vp, vb
    torch.cuda.empty_cache()
    # adafactor on whisper's smoke config, card against CPU
    sm = build_model(get_config(ENCDEC_ARCH).smoke())
    sp = sm.init(torch.Generator().manual_seed(0))
    sb = _family_batch(torch, sm.cfg, 4, 16, "cpu", 3)
    sp_card, sb_card = (tree_map(lambda t: t.to(dev), x) for x in (sp, sb))
    grad_fn = torch.func.grad_and_value(sm.loss, has_aux=True)
    g_card, (l_card, _) = grad_fn(sp_card, sb_card)
    g_cpu, (l_cpu, _) = grad_fn(sp, sb)
    g_diff, g_at = _max_tree_diff(g_card, g_cpu)
    g_scale = max(t.abs().max().item() for t in tree_leaves(g_cpu))
    same_g = tree_map(lambda t: t.to(dev), g_cpu)
    u_card, _ = adafactor.update(same_g, adafactor.init(sp_card), sp_card, TRAIN_ADAFACTOR_LR)
    u_cpu, _ = adafactor.update(g_cpu, adafactor.init(sp), sp, TRAIN_ADAFACTOR_LR)
    u_diff, u_at = _max_tree_diff(u_card, u_cpu)
    step = make_train_step(sm, adafactor)
    s_card, _, _ = step(sp_card, adafactor.init(sp_card), sb_card, TRAIN_ADAFACTOR_LR)
    s_cpu, _, _ = step(sp, adafactor.init(sp), sb, TRAIN_ADAFACTOR_LR)
    # the whole step, on every leaf whose gradient is above rounding level: a
    # gradient that is 0 in exact arithmetic (a key bias's, under softmax)
    # is rounding noise, which adafactor scales up to an update of order lr
    held, left_out = [], []
    for (p, a), (_, b), (_, g) in zip(tree_paths_and_leaves(s_card), tree_paths_and_leaves(s_cpu),
                                      tree_paths_and_leaves(g_cpu)):
        d = (a.float().cpu() - b.float()).abs().max().item()
        g_max = g.abs().max().item()
        (held if g_max > STEP_GRAD_FLOOR * g_scale else left_out).append((d, p, g_max))
    s_diff, s_at, _ = max(held)
    log(f"[card-vs-cpu adafactor] {sm.cfg.arch_id} (fp32): loss {l_card.item():.6f} / "
        f"{l_cpu.item():.6f}; max |grad diff| {g_diff:.3e} at {g_at} (max |grad| {g_scale:.3e}); "
        f"one update from the same gradients: max |param diff| {u_diff:.3e} at {u_at}; the whole "
        f"step: max |param diff| {s_diff:.3e} at {s_at} over {len(held)} leaves (asserted <= "
        f"1e-5); {len(left_out)} leaves left out, their max |grad| <= {STEP_GRAD_FLOOR} x "
        f"{g_scale:.3e}")
    for d, p, g_max in left_out:
        log(f"[card-vs-cpu adafactor]   left out: {p}, max |grad| {g_max:.3e}, "
            f"max |param diff| {d:.3e}")
    # 1e-4 of the largest gradient: fp32 sums in other orders differ by ~1e-6
    assert g_diff <= 1e-4 * g_scale, f"card and CPU whisper gradients differ by {g_diff}"
    assert u_diff <= 1e-5, f"card and CPU adafactor updates differ by {u_diff}"
    assert s_diff <= 1e-5, f"card and CPU adafactor steps differ by {s_diff} at {s_at}"
    out["smoke"] = {"grad_diff": g_diff, "update_diff": u_diff, "step_diff": s_diff}
    return out


def encdec_vlm_phase(torch, dev, card: str) -> dict:
    """Phase 19 (a)-(e). Returns what the [done] line and the kernels line
    read: K3 launches of (a) and (b), and the numbers printed."""
    import gc

    from repro_torch.configs import get_config
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log(f"[encdec] phase 19 starts with {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved")
    k3_w, whisper = loop_serve_path(torch, dev, ENCDEC_ARCH, card, tag="encdec")
    k3_v, internvl = loop_serve_path(torch, dev, VLM_ARCH, card, layers=VLM_SERVE_LAYERS,
                                     tag="vlm")
    full = get_config(VLM_ARCH)
    per_layer = (internvl["params"] - 2 * full.padded_vocab * full.d_model
                 - full.d_model) / VLM_SERVE_LAYERS
    log(f"reduced: {VLM_ARCH} n_layers {full.n_layers} → {VLM_SERVE_LAYERS} when served (all "
        f"{full.n_layers} layers' fp32 params would take "
        f"{4 * (internvl['params'] + (full.n_layers - VLM_SERVE_LAYERS) * per_layer) / 1e9:.1f} "
        f"GB of the card's 80)")
    for name, info in ((ENCDEC_ARCH, whisper), (VLM_ARCH, internvl)):
        log(f"[encdec] {name} decode step: flash_decode {info['k3_ms']:.4f} ms of "
            f"{info['busy_ms']:.3f} ms busy ({info['k3_ms'] / max(info['busy_ms'], 1e-9):.2%}), "
            f"busy {info['busy_ms'] / info['step_wall_ms']:.1%} of the step's wall ({card})")
    err = max(check_flash_decode_shape(torch, dev, "whisper self", 8, 8, 64, (129,)),
              check_flash_decode_shape(torch, dev, "whisper cross", 8, 8, 64,
                                       (ENCDEC_CROSS_SEQ,), back=1),
              check_flash_decode_shape(torch, dev, "internvl2", 48, 8, 128, VLM_K3_SEQS))
    # every row at the cache's last position: the cross call's, and the
    # whole cache read at the others
    shapes = [("whisper self", 8, 8, 64, 129), ("whisper cross", 8, 8, 64, ENCDEC_CROSS_SEQ)] + [
        (f"internvl2 S={S}", 48, 8, 128, S) for S in VLM_K3_SEQS]
    times = {label: time_flash_decode(torch, dev, H, D, label=label, KV=KV, S=S, pos=S - 1)
             for label, H, KV, D, S in shapes}
    for arch in (ENCDEC_ARCH, VLM_ARCH):
        same, diff, _ = card_vs_cpu_loop_serve(torch, dev, arch, tag="encdec")
        assert same, f"{arch}: card and CPU generate different tokens in fp32"
        # 1e-3, as phase 7
        assert diff <= 1e-3, f"{arch}: card and CPU logits differ by {diff}"
    train = encdec_vlm_train(torch, dev, card)
    log(f"[encdec] phase 19 in {time.perf_counter() - t0:.1f} s")
    return {"k3": k3_w + k3_v, "k3_err": err, "k3_times": times, "whisper": whisper,
            "internvl": internvl, "train": train}


# ------------------------------------------------------------ phases 8-11


def _attn_inputs(torch, dev, gen, B, H, KV, Sq, Sk, D, dtype):
    q = torch.randn((B, H, Sq, D), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((B, KV, Sk, D), generator=gen, device=dev).to(dtype) for _ in range(2))
    return q, k, v


def check_flash_attention(torch, dev):
    """K4 against its plain version. Tolerances are the reference's own
    for its kernel against its oracle: 2e-5 in fp32, 2e-2 in bf16.
    Returns the max abs error at granite's prefill shape."""
    from repro_torch.kernels import flash_attention, ref
    gen = torch.Generator(device=dev).manual_seed(8)
    bf16, f32 = torch.bfloat16, torch.float32
    B, H, KV, S, D = ATTN_SHAPE
    # tests/test_kernels.py's FLASH_CASES: B, H, KV, S, D, causal, window, bq, bk
    flash_cases = [(1, 4, 4, 128, 64, True, 0, 64, 64), (2, 8, 2, 256, 64, True, 0, 128, 128),
                   (1, 8, 1, 256, 128, True, 0, 64, 128), (2, 4, 4, 128, 64, False, 0, 64, 64),
                   (1, 4, 2, 256, 64, True, 64, 64, 64), (1, 2, 2, 512, 64, True, 128, 128, 256)]
    cases = []  # name, (B, H, KV, Sq, Sk, D), dtype, causal, window, q_offset, (bq, bk), bsh
    for dt in (f32, bf16):
        for i, (b, h, kv, s, d, causal, win, bq, bk) in enumerate(flash_cases):
            cases.append((f"FLASH_CASES[{i}] {str(dt)[6:]}", (b, h, kv, s, s, d), dt, causal,
                          win, 0, (bq, bk), False))
    cases += [
        ("no valid key in any row", (1, 4, 2, 64, 64, 32), f32, False, 16, 100, (32, 32), False),
        ("no valid key in some rows", (1, 2, 1, 64, 128, 32), bf16, True, 24, 140, (32, 64),
         False),
        ("prefill chunk at q_offset 1536", (B, H, KV, 512, S, D), bf16, True, 0, 1536,
         (128, 128), False),
        ("strided (B,S,H,D) window 256", (2, H, KV, S, S, D), bf16, True, 256, 0, (128, 128),
         True),
        ("bf16 D=32", (2, 8, 2, 256, 256, 32), bf16, True, 0, 0, (256, 256), False),
        ("bf16 D=128 window 100", (1, 8, 1, 512, 512, 128), bf16, True, 100, 0, (512, 512),
         False),
        ("bf16 ragged Sq 100 Sk 200", (1, 4, 2, 100, 200, 64), bf16, True, 0, 100, (100, 200),
         False),
        ("bf16 ragged D=128 non-causal", (2, 8, 1, 200, 200, 128), bf16, False, 0, 0,
         (200, 200), False),
        ("bf16 unaligned strided (B,S,H,D)", (2, 8, 2, 130, 130, 64), bf16, True, 90, 0,
         (130, 130), "unaligned"),
        ("granite prefill", (B, H, KV, S, S, D), bf16, True, 0, 0, (128, 128), False),
    ]
    path_err = 0.0
    for name, (b, h, kv, sq, sk, d), dt, causal, win, off, (bq, bk), bsh in cases:
        q, k, v = _attn_inputs(torch, dev, gen, b, h, kv, sq, sk, d, dt)
        kw = dict(causal=causal, window=win, q_offset=off)
        if bsh == "unaligned":
            # (B,S,H,D) views 2 bytes past a 16-byte boundary with odd
            # strides: the kernel stages its tiles with ordinary loads
            pad = [torch.zeros(t.shape[:3] + (1,), dtype=dt, device=dev) for t in (q, k, v)]
            q, k, v = (torch.cat([z, t], dim=3).transpose(1, 2).contiguous()[..., 1:]
                       .transpose(1, 2) for z, t in zip(pad, (q, k, v)))
            assert q.data_ptr() % 16 and not flash_attention._aligned16(q)
            got = flash_attention.flash_attention_bsh(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), block_q=bq,
                block_k=bk, **kw).transpose(1, 2)
        elif bsh:
            got = flash_attention.flash_attention_bsh(
                q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                v.transpose(1, 2).contiguous(), block_q=bq, block_k=bk, **kw).transpose(1, 2)
        else:
            got = flash_attention.flash_attention(q, k, v, block_q=bq, block_k=bk, **kw)
        expect = ref.attention(q, k, v, **kw)
        torch.cuda.synchronize()
        tol = 2e-5 if dt == f32 else 2e-2
        torch.testing.assert_close(got.float(), expect.float(), rtol=tol, atol=tol,
                                   msg=lambda m: f"flash_attention {name}: {m}")
        err = (got.float() - expect.float()).abs().max().item()
        if name == "granite prefill":
            path_err = err
        log(f"[kernels] flash_attention {name}: max abs err {err:.3e} (tol {tol:g})")
    log(f"[kernels] flash_attention: {len(cases)} cases agree with the plain version; "
        f"max abs err at granite's prefill shape {path_err:.3e}")
    return path_err


def time_flash_attention(torch, dev):
    """K4 at granite's prefill shape: q (4,32,2048,64) against k, v
    (4,8,2048,64), bf16, causal."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, ref
    gen = torch.Generator(device=dev).manual_seed(9)
    B, H, KV, S, D = ATTN_SHAPE
    q, k, v = _attn_inputs(torch, dev, gen, B, H, KV, S, S, D, torch.bfloat16)

    def kernel():
        flash_attention.flash_attention(q, k, v, causal=True)

    def plain():
        ref.attention(q, k, v, causal=True)

    def library():
        F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)

    lib_err = (F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True).float()
               - ref.attention(q, k, v, causal=True).float()).abs().max().item()
    ms, plain_ms, lib_ms = (cuda_ms(torch, f, reps=10) for f in (kernel, plain, library))
    log(f"[kernels] flash_attention device time alone (CUDA graph of one call): "
        f"kernel {graph_ms(torch, kernel):.4f} ms, plain {graph_ms(torch, plain):.4f} ms, "
        f"sdpa {graph_ms(torch, library):.4f} ms (sdpa vs plain max abs err {lib_err:.3e})")
    es = q.element_size()
    n_bytes = (2 * q.numel() + k.numel() + v.numel()) * es        # q, k, v read; out written
    pairs = B * H * S * (S + 1) // 2                                 # causal (row, col) pairs
    # per valid pair and query head: D multiply-adds for the score and D
    # for the output
    n_ops = pairs * 4 * D
    b, by = bound_ms(n_bytes, n_ops, BF16_TENSOR_FLOPS)
    log(f"[kernels] flash_attention bound: {n_ops / 1e9:.2f} GFLOP over {BF16_TENSOR_FLOPS:g} "
        f"FLOP/s -> {n_ops / BF16_TENSOR_FLOPS * 1e3:.5f} ms; {n_bytes / 1e6:.1f} MB over "
        f"{HBM_BYTES_PER_S:g} B/s -> {n_bytes / HBM_BYTES_PER_S * 1e3:.5f} ms; bound by {by}")
    return ms, plain_ms, lib_ms, b, by


def attention_path(torch, dev):
    """Phase 9: one granite-3-2b attention layer at full width composed
    from the kernel, against the port's attend_full on the same weights
    and input. Returns (launches in this phase, max abs diff, max |out|)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, ops
    from repro_torch.models import attention
    from repro_torch.models.layers import apply_rope

    cfg = get_config(SERVE_ARCH)
    gen = torch.Generator(device=dev).manual_seed(10)
    p = attention.init_attention(gen, cfg)
    B, S = ATTN_PATH_BATCH, ATTN_SHAPE[3]
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
    with torch.no_grad():
        expect = attention.attend_full(p, x, cfg)
        flash_attention.flash_attention.launches = 0
        q, k, v = attention._project_qkv(p, x, x, cfg)
        pos = torch.arange(S, device=dev)[None, :]
        q, k = apply_rope(q, pos, cfg.rope_theta), apply_rope(k, pos, cfg.rope_theta)
        o = ops.flash_attention_bsh(q, k, v, causal=True)
        got = o.reshape(B, S, -1) @ p["wo"].to(x.dtype)
        torch.cuda.synchronize()
        launches = flash_attention.flash_attention.launches
    diff = (got.float() - expect.float()).abs().max().item()
    scale = expect.float().abs().max().item()
    log(f"[attention] {cfg.arch_id} attention layer at full width (d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}), B {B}, S {S}, bf16: kernel "
        f"composition vs attend_full max abs diff {diff:.3e} (max |out| {scale:.3e}); "
        f"flash_attention launches {launches}")
    return launches, diff, scale


def table2(torch, dev):
    """Phase 10: the Table-II sweep on the card, then the serial bso-sl
    row. Returns (sweep launch counts, accuracies, serial bso-sl acc,
    seconds of the sweep and of the serial run)."""
    from repro_torch.configs import OptimizerConfig, SwarmConfig, get_config
    from repro_torch.core import baselines
    from repro_torch.core.engine import SWEEP_METHODS, stack_eval_split
    from repro_torch.data.dr import make_dr_swarm_data, scale_table
    from repro_torch.models import build_model

    clients = make_dr_swarm_data(image_size=TABLE2_IMAGE, seed=TABLE2_SEED, table=scale_table(1))
    model = build_model(get_config("squeezenet-dr"))
    swarm = SwarmConfig(n_clients=14, n_clusters=K, p1=0.9, p2=0.8, kmeans_iters=KMEANS_ITERS,
                        local_steps=LOCAL_STEPS, rounds=TABLE2_ROUNDS)
    opt = OptimizerConfig(name="adam", lr=2e-3)
    cfg, data = baselines.make_method_setup(model, clients, swarm, opt, batch_size=BATCH,
                                            device=dev)
    test_stack = stack_eval_split(model.cfg, clients, "test", device=dev)

    _zero_coordinator_counts()
    t0 = time.perf_counter()
    accs, run = baselines.run_sweep_table(model, clients, swarm, opt, TABLE2_SEED,
                                          batch_size=BATCH, cfg=cfg, data=data,
                                          test_stack=test_stack)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    launches = _coordinator_counts()
    M = len(SWEEP_METHODS)
    want = {**_grid_want(M, TABLE2_ROUNDS, len(_leaves(run.state[0].params))),
            "kmeans_assign with k_active": 0}
    log(f"[table2] sweep of {M} methods x {TABLE2_ROUNDS} rounds in {sweep_s:.3f} s; launches "
        f"{launches}, expected {want}")
    assert launches == want, f"sweep launch counts {launches} != {want}"
    for m in SWEEP_METHODS:
        assert math.isfinite(accs[m]) and 0.0 <= accs[m] <= 1.0, f"{m} accuracy {accs[m]}"
    val = run.metrics.mean_val_acc.tolist()
    for i, m in enumerate(SWEEP_METHODS):
        log(f"[table2] {m}: Eq. 3 test acc {accs[m]:.4f} (paper {PAPER[m]:.4f}); val acc by "
            f"round {[round(a, 4) for a in val[i]]}")

    t0 = time.perf_counter()
    serial_acc, _ = baselines.run_method("bso-sl", model, clients, swarm, opt,
                                         baselines.sweep_keys(TABLE2_SEED)[M - 1],
                                         batch_size=BATCH, cfg=cfg, data=data,
                                         test_stack=test_stack)
    torch.cuda.synchronize()
    serial_s = time.perf_counter() - t0
    assert math.isfinite(serial_acc) and 0.0 <= serial_acc <= 1.0
    ordering = {
        "centralized_upper_bounds_global_fedavg": accs["centralized"]
        >= accs["fedavg"] - ORDERING_TOL,
        "bso_over_fedavg": accs["bso-sl"] >= accs["fedavg"] - ORDERING_TOL,
        "federated_above_random_floor": accs["bso-sl"] > 0.25 and accs["fedavg"] > 0.2,
        "local_overfits_protocol_artifact": accs["local"] > accs["centralized"],
    }
    log(f"[table2] serial bso-sl: acc {serial_acc:.4f} in {serial_s:.3f} s (sweep row "
        f"{accs['bso-sl']:.4f}, |diff| {abs(serial_acc - accs['bso-sl']):.2e}); orderings, "
        f"not asserted (ORDERING_TOL {ORDERING_TOL}): {ordering}")
    return launches, accs, serial_acc, sweep_s, serial_s


def grid_path(torch, dev):
    """Phase 11: the CASES ablation through ``run_grid_table`` (pad k 5),
    launch counts read from that call alone; then the scheduled grid.
    Returns (launch counts, results, final states, seconds of the
    ablation and of the scheduled grid, the clients, the data)."""
    from repro_torch.configs import OptimizerConfig, SwarmConfig, get_config
    from repro_torch.core import baselines
    from repro_torch.core.engine import make_swarm_data, stack_eval_split
    from repro_torch.data.dr import make_dr_swarm_data, scale_table
    from repro_torch.models import build_model

    clients = make_dr_swarm_data(image_size=GRID_IMAGE, seed=GRID_SEED,
                                 table=scale_table(GRID_DATA_SCALE))
    model = build_model(get_config("squeezenet-dr"))
    opt = OptimizerConfig(name="adam", lr=2e-3)
    swarm = SwarmConfig(n_clients=14, rounds=GRID_ROUNDS, local_steps=GRID_LOCAL_STEPS,
                        kmeans_iters=KMEANS_ITERS)
    data = make_swarm_data(model.cfg, clients, device=dev)
    test_stack = stack_eval_split(model.cfg, clients, "test", device=dev)
    specs = [spec for _, spec in GRID_CASES]
    log(f"[grid] {len(specs)} cases x {GRID_ROUNDS} rounds, {sum(c['n_train'] for c in clients)} "
        f"train images at {GRID_IMAGE} px in 14 clinics, {GRID_LOCAL_STEPS} local steps")

    _zero_coordinator_counts()
    t0 = time.perf_counter()
    results, run = baselines.run_grid_table(model, clients, swarm, opt, GRID_SEED, specs=specs,
                                            batch_size=BATCH, data=data, test_stack=test_stack)
    torch.cuda.synchronize()
    grid_s = time.perf_counter() - t0
    launches = _coordinator_counts()
    want = _grid_want(len(specs), GRID_ROUNDS, len(_leaves(run.state[0].params)))
    log(f"[grid] ablation in {grid_s:.3f} s; launches {launches}, expected {want}")
    assert launches == want, f"grid launch counts {launches} != {want}"
    ms = run.metrics
    for g, ((name, spec), res) in enumerate(zip(GRID_CASES, results)):
        assert math.isfinite(res["acc"]) and 0.0 <= res["acc"] <= 1.0, f"{name}: {res}"
        assert torch.isfinite(ms.train_loss[g]).all(), f"{name}: train loss not finite"
        assert int(ms.assignments[g].max()) < spec["k"], f"{name}: a client in a pad cluster"
        assert (ms.centers[g][:, spec["k"]:] == -1).all(), f"{name}: a pad cluster has a center"
        if spec.get("p1") == 1.0 and spec.get("p2") == 1.0:
            assert not ms.n_replaced[g].any() and not ms.n_swapped[g].any(), \
                f"{name}: p1 = p2 = 1 must make no brain-storm event"
        log(f"[grid] {name}: Eq. 3 test acc {res['acc']:.4f}; val acc by round "
            f"{[round(a, 4) for a in ms.mean_val_acc[g].tolist()]}; events (replaced, swapped) "
            f"{list(zip(ms.n_replaced[g].tolist(), ms.n_swapped[g].tolist()))}")

    # the scheduled grid: rows of 4 steps compute 4, not 10
    schedules = []
    run_grid = baselines.run_grid

    def spy(*args, **kw):
        schedules.append(args[5] if len(args) > 5 else kw.get("schedule"))
        return run_grid(*args, **kw)

    baselines.run_grid = spy
    try:
        _zero_coordinator_counts()
        t0 = time.perf_counter()
        sched_results, sched_run = baselines.run_grid_table(
            model, clients, replace(swarm, rounds=GRID_SCHEDULE_ROUNDS), opt, GRID_SEED,
            axes=GRID_SCHEDULE_AXES, batch_size=BATCH, data=data, test_stack=test_stack)
        torch.cuda.synchronize()
        sched_s = time.perf_counter() - t0
    finally:
        baselines.run_grid = run_grid
    sched_launches = _coordinator_counts()
    rows = len(sched_results)
    want = _grid_want(rows, GRID_SCHEDULE_ROUNDS, len(_leaves(sched_run.state[0].params)))
    expect_schedule = tuple(r["local_steps"] for r in sched_results)
    log(f"[grid] scheduled grid {GRID_SCHEDULE_AXES} x {GRID_SCHEDULE_ROUNDS} rounds in "
        f"{sched_s:.3f} s, schedule {schedules}; launches {sched_launches}, expected {want}; "
        f"accs {[round(r['acc'], 4) for r in sched_results]}")
    assert schedules == [expect_schedule] and min(expect_schedule) < GRID_LOCAL_STEPS, \
        f"run_grid_table passed the schedule {schedules}, not {expect_schedule}"
    assert sched_launches == want, f"scheduled grid launch counts {sched_launches} != {want}"
    assert torch.isfinite(sched_run.metrics.train_loss).all()
    return launches, results, run.state, grid_s, sched_s, clients, data


def card_vs_cpu_grid(torch, state, clients, data_card):
    """One grid round of the k=2 row under the pad 5, with its own lr
    (1e-3) and 2 of 3 local steps, adam at eps 1e-6, on the card and on
    the CPU from ``state`` and one set of injected draws. Returns (max
    |param diff|, card metrics, cpu metrics, the card round's k_active
    launches)."""
    from repro_torch.configs import OptimizerConfig, get_config
    from repro_torch.core import engine
    from repro_torch.kernels import kmeans_assign
    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import make_optimizer

    cpu = torch.device("cpu")
    model = build_model(get_config("squeezenet-dr"))
    cfg = engine.EngineConfig(model=model,
                              opt=make_optimizer(OptimizerConfig(name="adam", lr=2e-3, eps=1e-6)),
                              local_steps=3, batch_size=BATCH, lr=2e-3, n_clusters=GRID_K_MAX,
                              kmeans_iters=KMEANS_ITERS)
    spec = dict(k=2, lr=1e-3, local_steps=2)
    data_cpu = engine.make_swarm_data(model.cfg, clients, device=cpu)
    draws = engine.draw_round(torch.Generator().manual_seed(12), data_cpu.train_n, cfg)
    s_card = engine.copy_state(state)
    s_cpu = _state_on_cpu(torch, s_card)
    row_card = engine.grid_point(cfg, 14, device=data_card.train_n.device, **spec)
    before = kmeans_assign.kmeans_assign.k_active_launches
    new_card, m_card = engine.swarm_round(s_card, data_card, cfg, row_card, draws=draws)
    torch.cuda.synchronize()
    k2 = kmeans_assign.kmeans_assign.k_active_launches - before
    new_cpu, m_cpu = engine.swarm_round(s_cpu, data_cpu, cfg,
                                        engine.grid_point(cfg, 14, device=cpu, **spec),
                                        draws=draws)
    diff = max((a.cpu() - b).abs().max().item()
               for a, b in zip(_leaves(new_card.params), _leaves(new_cpu.params)))
    return diff, m_card, m_cpu, k2


def _binomial_band(dropout: float, trials: int) -> float:
    p = 1.0 - dropout
    return CHURN_BAND_SIGMAS * math.sqrt(p * (1.0 - p) / trials)


def churn_path(torch, dev):
    """Phase 12: churn_bench's sweep through ``run_grid_table``, launch
    counts read from that call alone, each row's presence share held to
    its binomial band, then the dropout-0 row against the churn-free
    ``run_grid_point`` of its seed. Returns (launch counts, results,
    final states, specs, seconds, the clients, the data)."""
    from repro_torch.configs import OptimizerConfig, SwarmConfig, get_config
    from repro_torch.core import baselines
    from repro_torch.core.engine import make_swarm_data, stack_eval_split
    from repro_torch.data.dr import make_dr_swarm_data, scale_table
    from repro_torch.models import build_model

    clients = make_dr_swarm_data(image_size=CHURN_IMAGE, seed=CHURN_SEED,
                                 table=scale_table(CHURN_DATA_SCALE))
    model = build_model(get_config("squeezenet-dr"))
    opt = OptimizerConfig(name="adam", lr=2e-3)
    swarm = SwarmConfig(n_clients=len(clients), rounds=CHURN_ROUNDS,
                        local_steps=CHURN_LOCAL_STEPS, kmeans_iters=KMEANS_ITERS)
    specs = [{"dropout": d, "stale_decay": g} for g in CHURN_STALE_DECAYS for d in CHURN_DROPOUTS]
    data = make_swarm_data(model.cfg, clients, device=dev)
    test_stack = stack_eval_split(model.cfg, clients, "test", device=dev)
    log(f"[churn] {len(specs)} rows x {CHURN_ROUNDS} rounds, {sum(c['n_train'] for c in clients)} "
        f"train images at {CHURN_IMAGE} px in {len(clients)} clinics, {CHURN_LOCAL_STEPS} local "
        f"steps")

    _zero_coordinator_counts()
    t0 = time.perf_counter()
    results, run = baselines.run_grid_table(model, clients, swarm, opt, CHURN_SEED, specs=specs,
                                            batch_size=BATCH, data=data, test_stack=test_stack)
    torch.cuda.synchronize()
    churn_s = time.perf_counter() - t0
    launches = _coordinator_counts()
    want = _grid_want(len(specs), CHURN_ROUNDS, len(_leaves(run.state[0].params)))
    log(f"[churn] sweep in {churn_s:.3f} s; launches {launches}, expected {want}")
    assert launches == want, f"churn launch counts {launches} != {want}"
    ms = run.metrics
    for g, (spec, res) in enumerate(zip(specs, results)):
        present = ms.present[g]
        share = present.float().mean().item()
        band = _binomial_band(spec["dropout"], present.numel())
        log(f"[churn] dropout {spec['dropout']}, stale decay {spec['stale_decay']}: Eq. 3 test acc "
            f"{res['acc']:.4f}, final val acc {ms.mean_val_acc[g, -1].item():.4f}, presence "
            f"{share:.4f} (band {1 - spec['dropout']:.2f} +- {band:.4f}), present a round "
            f"{present.sum(1).tolist()}, staleness {run.state[g].staleness.tolist()}")
        assert math.isfinite(res["acc"]) and torch.isfinite(ms.train_loss[g]).all(), spec
        if spec["dropout"] == 0.0:
            assert share == 1.0, f"{spec}: presence {share}"
        else:
            assert abs(share - (1.0 - spec["dropout"])) <= band, f"{spec}: presence {share}"

    # the anchor: the dropout-0, stale-decay-0 row is the churn-free row
    g0 = specs.index({"dropout": 0.0, "stale_decay": 0.0})
    acc0, free = baselines.run_grid_point({}, model, clients, swarm, opt,
                                          baselines.sweep_keys(CHURN_SEED, specs)[g0],
                                          batch_size=BATCH, data=data, test_stack=test_stack)
    torch.cuda.synchronize()
    assert torch.equal(ms.assignments[g0], free.metrics.assignments), "anchor assignments differ"
    assert torch.equal(ms.centers[g0], free.metrics.centers), "anchor centers differ"
    pairs = list(zip(_leaves(run.state[g0].params), _leaves(free.state.params)))
    bitwise = all(torch.equal(a, b) for a, b in pairs)
    diff = max((a - b).abs().max().item() for a, b in pairs)
    log(f"[churn] dropout-0 row vs the churn-free run_grid_point: assignments and centers equal, "
        f"params bitwise equal {bitwise} (max |diff| {diff:.3e}), acc {results[g0]['acc']:.4f} / "
        f"{acc0:.4f}")
    # 1e-6 where not bitwise: no churn op moves a value, so only another
    # summation order on the card could, by an ulp a round
    assert bitwise or diff <= 1e-6, f"the dropout-0 row is {diff} from the churn-free row"
    return launches, results, run.state, specs, churn_s, clients, data


def card_vs_cpu_churn(torch, state, clients, data_card):
    """One churn grid round (dropout 0.4, stale decay 0.5, 2 local
    steps, adam at eps 1e-6) on the card and on the CPU from ``state``
    and one set of injected draws (the churn uniforms among them).
    Returns (max |param diff|, card metrics, cpu metrics, new card state,
    new cpu state, whether every absent client's params and optimizer
    state on the card are bitwise as they were)."""
    from repro_torch.configs import OptimizerConfig, get_config
    from repro_torch.core import engine
    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import make_optimizer

    cpu = torch.device("cpu")
    n = len(clients)
    model = build_model(get_config("squeezenet-dr"))
    cfg = engine.EngineConfig(model=model,
                              opt=make_optimizer(OptimizerConfig(name="adam", lr=2e-3, eps=1e-6)),
                              local_steps=2, batch_size=BATCH, lr=2e-3, n_clusters=K,
                              kmeans_iters=KMEANS_ITERS)
    data_cpu = engine.make_swarm_data(model.cfg, clients, device=cpu)
    gen = torch.Generator().manual_seed(13)
    draws = engine.draw_round(gen, data_cpu.train_n, cfg)._replace(
        churn_u=engine.draw_churn(gen, n, cpu))
    s_card = engine.copy_state(state)
    s_cpu = _state_on_cpu(torch, s_card)
    spec = dict(dropout=0.4, stale_decay=0.5)
    new_card, m_card = engine.swarm_round(
        s_card, data_card, cfg, engine.grid_point(cfg, n, device=data_card.train_n.device, **spec),
        draws=draws)
    torch.cuda.synchronize()
    new_cpu, m_cpu = engine.swarm_round(s_cpu, data_cpu, cfg,
                                        engine.grid_point(cfg, n, device=cpu, **spec), draws=draws)
    absent = ~m_card.present
    frozen = all(torch.equal(a[absent], b[absent])
                 for new, old in ((new_card.params, s_card.params),
                                  (new_card.opt_state, s_card.opt_state))
                 for a, b in zip(_leaves(new), _leaves(old)))
    diff = max((a.cpu() - b).abs().max().item()
               for a, b in zip(_leaves(new_card.params), _leaves(new_cpu.params)))
    return diff, m_card, m_cpu, new_card, new_cpu, frozen


def _state_on_cpu(torch, state):
    """``state``'s tensors copied to the CPU, with a fresh generator (the
    round it runs takes injected draws)."""
    from repro_torch.utils.tree import tree_map
    return state._replace(params=tree_map(lambda t: t.cpu(), state.params),
                          opt_state=tree_map(lambda t: t.cpu(), state.opt_state),
                          generator=torch.Generator(), n_samples=state.n_samples.cpu(),
                          staleness=None if state.staleness is None else state.staleness.cpu(),
                          churn_generator=None)


def _stack_mb(stacks) -> float:
    return sum(t.numel() * t.element_size() for s in stacks for t in s.values()) / 1e6


def bucket_path(torch, dev, clients):
    """Phase 13: both layouts of ``clients`` (phase 3's data), their pad
    shares and bytes, 2 rounds of ``run_rounds`` on each from one state
    with launch counts read from each layout's rounds alone, the first
    local-step batch, assignments, centers and params compared; then one
    centralized ``run_method`` round on the bucketed layout. Returns
    (launch counts of the phase, {layout: round seconds}, {layout:
    pad_fraction}, max |param diff| between the layouts)."""
    from repro_torch.configs import OptimizerConfig, SwarmConfig, get_config
    from repro_torch.core import baselines, engine
    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import make_optimizer

    model = build_model(get_config("squeezenet-dr"))
    opt_cfg = OptimizerConfig(name="adam", lr=2e-3)
    cfg = engine.EngineConfig(model=model, opt=make_optimizer(opt_cfg), local_steps=LOCAL_STEPS,
                              batch_size=BATCH, lr=2e-3, n_clusters=K, kmeans_iters=KMEANS_ITERS)
    layouts = {"rect": engine.make_swarm_data(model.cfg, clients, device=dev),
               "bucketed": engine.make_bucketed_swarm_data(model.cfg, clients, device=dev)}
    pads = {}
    for name, data in layouts.items():
        bucketed = isinstance(data, engine.BucketedSwarmData)
        trains = data.train if bucketed else (data.train,)
        vals = data.val if bucketed else (data.val,)
        pads[name] = engine.pad_fraction(data)
        log(f"[bucket] {name}: train stacks {[tuple(t['images'].shape) for t in trains]} = "
            f"{_stack_mb(trains):.1f} MB, eval stacks {_stack_mb(vals):.1f} MB on {dev}; "
            f"pad_fraction {pads[name]}" + (f"; buckets {data.client_ids}" if bucketed else ""))

    s0 = engine.make_swarm_state(model, cfg.opt, clients, BUCKET_SEED, device=dev)
    draws = engine.draw_round(engine.copy_state(s0).generator, layouts["rect"].train_n, cfg)
    first = {name: engine.sample_round_batch(data, draws.batch_idx[0].to(dev).long())
             for name, data in layouts.items()}
    assert all(torch.equal(first["rect"][k], first["bucketed"][k]) for k in first["rect"]), \
        "the layouts' first local-step batches differ"

    finals, metrics, secs, total = {}, {}, {}, {}
    for name, data in layouts.items():
        state = engine.copy_state(s0)
        _zero_coordinator_counts()
        ms, secs[name] = [], []
        for _ in range(BUCKET_ROUNDS):
            t0 = time.perf_counter()
            state, m = engine.run_rounds(state, data, cfg, 1)
            torch.cuda.synchronize()
            secs[name].append(time.perf_counter() - t0)
            ms.append(m)
        launches = _coordinator_counts()
        want = {**_grid_want(1, BUCKET_ROUNDS, len(_leaves(state.params))),
                "kmeans_assign with k_active": 0}
        log(f"[bucket] {name}: rounds {[round(t, 4) for t in secs[name]]} s (after the first: "
            f"{secs[name][1:]}), launches {launches}, expected {want}, val acc "
            f"{[round(m.mean_val_acc.item(), 4) for m in ms]}")
        assert launches == want, f"{name} launch counts {launches} != {want}"
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
        finals[name], metrics[name] = state, ms
    for r, (a, b) in enumerate(zip(metrics["rect"], metrics["bucketed"])):
        assert torch.equal(a.assignments, b.assignments), f"round {r}: assignments differ"
        assert torch.equal(a.centers, b.centers), f"round {r}: centers differ"
    pairs = list(zip(_leaves(finals["rect"].params), _leaves(finals["bucketed"].params)))
    diff = max((a - b).abs().max().item() for a, b in pairs)
    log(f"[bucket] rect vs bucketed after {BUCKET_ROUNDS} rounds: assignments and centers equal, "
        f"params bitwise equal {all(torch.equal(a, b) for a, b in pairs)}, max |diff| {diff:.3e}, "
        f"max |val acc diff| "
        f"{(metrics['rect'][-1].val_acc - metrics['bucketed'][-1].val_acc).abs().max().item():.3e}")
    # 1e-4, as phase 4: the bucketed eval runs cuDNN on fewer clients a
    # call, which may pick other algorithms
    assert diff <= 1e-4, f"the layouts' params differ by {diff}"

    # where a bucketed round's extra time goes: its eval and one local
    # step's batch, each layout timed in turns (rect, bucketed, bucketed,
    # rect) between CUDA events, host time included (the device waits
    # on it)
    params, idx = finals["rect"].params, draws.batch_idx[0].to(dev).long()
    parts = {}
    for name in ("rect", "bucketed", "bucketed", "rect"):
        data = layouts[name]
        parts.setdefault(name, []).append(
            (cuda_ms(torch, lambda: engine.eval_swarm(model, params, data), reps=20),
             cuda_ms(torch, lambda: engine.sample_round_batch(data, idx), reps=50)))
    log(f"[bucket] eval_swarm / one step's batch, ms a call in turns: "
        + "; ".join(f"{name} {' and '.join(f'{e:.3f} / {b:.3f}' for e, b in ts)}"
                    for name, ts in parts.items()))

    swarm = SwarmConfig(n_clients=len(clients), n_clusters=K, kmeans_iters=KMEANS_ITERS,
                        local_steps=LOCAL_STEPS, rounds=1)
    _zero_coordinator_counts()
    t0 = time.perf_counter()
    acc, run = baselines.run_method("centralized", model, clients, swarm, opt_cfg, BUCKET_SEED,
                                    batch_size=BATCH, cfg=cfg, data=layouts["bucketed"])
    torch.cuda.synchronize()
    launches = _coordinator_counts()
    want = {**_grid_want(1, 1, len(_leaves(run.state.params))), "kmeans_assign with k_active": 0}
    loss = run.metrics.train_loss[0].item()
    log(f"[bucket] centralized round on the bucketed layout (pooled gather): "
        f"{time.perf_counter() - t0:.3f} s, loss {loss:.4f}, Eq. 3 test acc {acc:.4f}, "
        f"launches {launches}")
    assert math.isfinite(loss), f"centralized loss {loss}"
    assert launches == want, f"centralized launch counts {launches} != {want}"
    total = {k: total[k] + v for k, v in launches.items()}
    return total, secs, pads, diff


def _timed_rounds(torch, state, data, cfg, rounds: int, **kw):
    """``rounds`` single rounds of ``run_rounds`` from ``state``, each
    timed on the host clock to a device sync. Returns (state, per-round
    metrics, seconds)."""
    from repro_torch.core import engine

    ms, secs = [], []
    for _ in range(rounds):
        t0 = time.perf_counter()
        state, m = engine.run_rounds(state, data, cfg, 1, **kw)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        ms.append(m)
    return state, ms, secs


def hier_fit(torch, dev, clients):
    """Phase 14 (a): phase 3's data and settings on 4 pods, launch
    counts read from the 4-pod fit alone, beside the flat fit from the
    same state; then one pod against the flat fit, bitwise. Returns
    (launch counts of the 4-pod fit, {"flat": s, "hier": s} round
    seconds, the 4-pod fit's final state, the engine config, the
    data)."""
    from repro_torch.configs import OptimizerConfig, get_config
    from repro_torch.core import engine
    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import make_optimizer

    model = build_model(get_config("squeezenet-dr"))
    cfg = engine.EngineConfig(model=model,
                              opt=make_optimizer(OptimizerConfig(name="adam", lr=2e-3)),
                              local_steps=LOCAL_STEPS, batch_size=BATCH, lr=2e-3, n_clusters=K,
                              p1=0.9, p2=0.8, kmeans_iters=KMEANS_ITERS)
    data = engine.make_swarm_data(model.cfg, clients, device=dev)
    n = len(clients)
    hier = engine.hier_params(n, HIER_PODS, k_local=HIER_K_LOCAL)
    assert [len(p) for p in hier.pods] == [3, 4, 3, 4], hier.pods
    s0 = engine.make_swarm_state(model, cfg.opt, clients, HIER_SEED, device=dev)

    _zero_coordinator_counts()
    s_hier, m_hier, hier_s = _timed_rounds(torch, engine.copy_state(s0), data, cfg, ROUNDS,
                                           hier=hier)
    launches = _coordinator_counts()
    want = {"param_stats_batched": ROUNDS * STATS_PASSES_PER_ROUND,
            "kmeans_assign": ROUNDS * (HIER_PODS + 1) * (KMEANS_ITERS + 1),
            "kmeans_assign with k_active": 0}
    log(f"[hier] 4 pods {[len(p) for p in hier.pods]}, k_local {HIER_K_LOCAL}: launches "
        f"{launches}, expected {want}")
    assert launches == want, f"hier launch counts {launches} != {want}"
    s_flat, m_flat, flat_s = _timed_rounds(torch, engine.copy_state(s0), data, cfg, ROUNDS)
    for name, ms, secs in (("flat", m_flat, flat_s), ("hier", m_hier, hier_s)):
        log(f"[hier] {name}: round seconds {[round(t, 4) for t in secs]}, val acc "
            f"{[round(m.mean_val_acc.item(), 4) for m in ms]}, assignments "
            f"{[m.assignments[0].tolist() for m in ms]}, centers "
            f"{[m.centers[0].tolist() for m in ms]}")
        assert all(torch.isfinite(m.train_loss).all() for m in ms), name
        assert all(int(m.assignments.max()) < K for m in ms), name

    # one pod is the flat coordinator: the same rounds from the same state
    s_one, m_one, _ = _timed_rounds(torch, engine.copy_state(s0), data, cfg, ROUNDS,
                                    hier=engine.hier_params(n, 1))
    assert all(torch.equal(a, b) for a, b in zip(_leaves(s_flat.params), _leaves(s_one.params))), \
        "one pod's params differ from the flat rounds'"
    for r, (a, b) in enumerate(zip(m_flat, m_one)):
        assert torch.equal(a.assignments, b.assignments), f"round {r}: one pod's assignments"
        assert torch.equal(a.centers, b.centers), f"round {r}: one pod's centers"
    log(f"[hier] one pod vs flat over {ROUNDS} rounds: params, assignments and centers bitwise "
        f"equal")
    return launches, {"flat": flat_s, "hier": hier_s}, s_hier, cfg, data


def card_vs_cpu_hier(torch, state, clients, data_card, cfg):
    """Phase 14 (a): one two-tier churn round (4 pods, dropout 0.4,
    stale decay 0.5, 2 local steps, adam at eps 1e-6) on the card and on
    the CPU from ``state`` (staleness set to client id mod 3) and one
    set of draws. Returns (max |param diff|, card metrics, cpu metrics,
    new card state, new cpu state, whether every absent client's params
    and optimizer state on the card are bitwise as they were)."""
    from repro_torch.configs import OptimizerConfig
    from repro_torch.core import engine
    from repro_torch.optim.optimizers import make_optimizer

    cpu = torch.device("cpu")
    n = len(clients)
    cfg = replace(cfg, local_steps=2,
                  opt=make_optimizer(OptimizerConfig(name="adam", lr=2e-3, eps=1e-6)))
    hier = engine.hier_params(n, HIER_PODS, k_local=HIER_K_LOCAL)
    data_cpu = engine.make_swarm_data(cfg.model.cfg, clients, device=cpu)
    gen = torch.Generator().manual_seed(17)
    draws = engine.draw_round(gen, data_cpu.train_n, cfg, hier)._replace(
        churn_u=engine.draw_churn(gen, n, cpu))
    s_card = engine.copy_state(state)._replace(
        staleness=torch.arange(n, dtype=torch.int32, device=data_card.train_n.device) % 3)
    s_cpu = _state_on_cpu(torch, s_card)
    churn = engine.churn_params(**HIER_CHURN)
    new_card, m_card = engine.swarm_round(s_card, data_card, cfg, draws=draws, churn=churn,
                                          hier=hier)
    torch.cuda.synchronize()
    new_cpu, m_cpu = engine.swarm_round(s_cpu, data_cpu, cfg, draws=draws, churn=churn, hier=hier)
    absent = ~m_card.present
    frozen = all(torch.equal(a[absent], b[absent])
                 for new, old in ((new_card.params, s_card.params),
                                  (new_card.opt_state, s_card.opt_state))
                 for a, b in zip(_leaves(new), _leaves(old)))
    diff = max((a.cpu() - b).abs().max().item()
               for a, b in zip(_leaves(new_card.params), _leaves(new_cpu.params)))
    return diff, m_card, m_cpu, new_card, new_cpu, frozen


def hier_anchor(torch, dev):
    """Phase 14 (b): benchmarks/hier_bench.py's ``_engine_anchor``, flat
    against 4 pods of k_local 2 from one state. Returns the final mean
    val accuracies {"flat": acc, "hier": acc} (not asserted: one seed
    cannot rank them)."""
    import numpy as np

    from repro_torch.configs import OptimizerConfig, get_config
    from repro_torch.core import engine
    from repro_torch.data.dr import TABLE_I, make_dr_swarm_data
    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import make_optimizer

    n = 14
    table = np.maximum(TABLE_I // 16, (TABLE_I > 0).astype(np.int64) * 2)[:, :n]
    clients = make_dr_swarm_data(image_size=HIER_ANCHOR_IMAGE, seed=HIER_SEED, table=table)
    model = build_model(get_config("squeezenet-dr"))
    cfg = engine.EngineConfig(model=model,
                              opt=make_optimizer(OptimizerConfig(name="adam", lr=2e-3)),
                              local_steps=HIER_ANCHOR_LOCAL_STEPS, batch_size=BATCH, lr=2e-3,
                              n_clusters=K, p1=0.9, p2=0.8, kmeans_iters=HIER_ANCHOR_ITERS)
    data = engine.make_swarm_data(model.cfg, clients, device=dev)
    s0 = engine.make_swarm_state(model, cfg.opt, clients, HIER_SEED, device=dev)
    accs = {}
    for name, hier in (("flat", None),
                       ("hier", engine.hier_params(n, HIER_PODS, k_local=HIER_K_LOCAL))):
        _, ms, secs = _timed_rounds(torch, engine.copy_state(s0), data, cfg, ROUNDS, hier=hier)
        accs[name] = ms[-1].mean_val_acc.item()
        assert 0.0 <= accs[name] <= 1.0, (name, accs[name])
        log(f"[hier anchor] {name}: {sum(c['n_train'] for c in clients)} train images at "
            f"{HIER_ANCHOR_IMAGE} px, {HIER_ANCHOR_LOCAL_STEPS} local steps: val acc "
            f"{[round(m.mean_val_acc.item(), 4) for m in ms]}, round seconds "
            f"{[round(t, 4) for t in secs]}")
    log(f"[hier anchor] final val acc flat {accs['flat']:.4f}, 4 pods {accs['hier']:.4f} "
        f"(delta {accs['hier'] - accs['flat']:+.4f}; not asserted)")
    return accs


def hier_scaling(torch, dev):
    """Phase 14 (c): benchmarks/hier_bench.py's pod-tier scaling axis on
    the card. For each N: ``pod_summaries`` over (N, 56) stats from a
    seeded generator on the card, in pods of 64 with k_local 2 and
    injected seed rows, then the weighted global tier over its summaries;
    shapes, counts, host-facing bytes and K2 launches asserted; the card
    against the CPU on the same inputs. Returns (K2 launches of the
    counted calls, {N: (first s, steady s)})."""
    from repro_torch.core import engine
    from repro_torch.core.bso import draw_bso

    F, kl, iters = 56, HIER_K_LOCAL, HIER_SCALING_ITERS
    cpu = torch.device("cpu")
    total, walls = 0, {}
    for N in HIER_SCALING_NS:
        P = N // HIER_POD_SIZE
        S = P * kl
        hier = engine.hier_params(N, P, k_local=kl)
        gen = torch.Generator(device=dev).manual_seed(N)
        feats = torch.randn((N, F), generator=gen, device=dev)
        val = torch.rand((N,), generator=gen, device=dev)
        weights = torch.ones((N,), device=dev)
        host = torch.Generator().manual_seed(N)
        init = torch.stack([torch.randperm(HIER_POD_SIZE, generator=host)[:kl]
                            for _ in range(P)])

        def pods_on(d):
            return engine.pod_summaries(feats.to(d), val.to(d), weights.to(d), None, kl, iters,
                                        hier.pod_index(d), init_idx=init)

        _zero_coordinator_counts()
        t0 = time.perf_counter()
        out = pods_on(dev)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        k2_pods = _coordinator_counts()["kmeans_assign"]
        t0 = time.perf_counter()
        pods_on(dev)
        torch.cuda.synchronize()
        steady = time.perf_counter() - t0
        C, counts, wsums, valsums, pc_of = out
        assert C.shape == (S, F) and counts.shape == wsums.shape == valsums.shape == (S,)
        assert pc_of.shape == (N,) and int(pc_of.max()) < S
        assert counts.sum().item() == N, f"N={N}: counts sum to {counts.sum().item()}"
        # the summaries the host coordinator would pull: comm.hier_host_bytes' arithmetic
        host_bytes = sum(t.numel() * t.element_size() for t in (C, counts, wsums, valsums))
        assert host_bytes == S * (F + 3) * 4, (N, host_bytes)
        assert k2_pods == P * (iters + 1), f"N={N}: {k2_pods} pod-tier K2 launches"
        _zero_coordinator_counts()
        engine.global_tier(C, counts, valsums, k=K, kmeans_iters=iters, p1=0.9, p2=0.8,
                           init_idx=torch.arange(K) * (S // K),
                           bso=draw_bso(K, S, host, cpu))
        torch.cuda.synchronize()
        k2_global = _coordinator_counts()["kmeans_assign"]
        assert k2_global == iters + 1, f"N={N}: {k2_global} global-tier K2 launches"
        total += k2_pods + k2_global
        ref = pods_on(cpu)
        assert torch.equal(pc_of.cpu(), ref[4]), f"N={N}: pod assignments differ card vs CPU"
        diff = max((a.cpu() - b).abs().max().item() for a, b in zip(out[:4], ref[:4]))
        # atol 1e-5: fp32 sums of up to 64 members, which the card's
        # index_add_ adds with atomics in another order
        for name, a, b in zip(("centroids", "counts", "wsums", "valsums"), out[:4], ref[:4]):
            torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-5,
                                       msg=lambda m, name=name: f"N={N} {name}: {m}")
        walls[N] = (first, steady)
        log(f"[hier scaling] N {N}: {P} pods of {HIER_POD_SIZE}, {S} summary rows, host-facing "
            f"{host_bytes} B (flat (N, F) stats + val: {N * (F + 1) * 4} B); pod tier first "
            f"{first:.4f} s, steady {steady:.4f} s; K2 launches {k2_pods} pod tier + {k2_global} "
            f"global tier; card vs CPU pc_of equal, summaries max |diff| {diff:.3e}")
    return total, walls


# ---------------------------------------------------------- phases 15, 16


def lm_stacks(torch, dev):
    """The LM fits' client stacks as their first round uploads them (phase
    15's two and phase 18 (e)'s mamba2): ``LM_CLIENTS`` models from one
    generator seeded 0, as ``make_swarm_state`` builds them. Returns
    {name: (cfg, stacked)}."""
    from repro_torch.models import build_model
    from repro_torch.utils.tree import tree_stack
    out = {}
    for name, cfg in (("granite", _lm_config()), ("100m", _preset_config()),
                      ("mamba2", _ssm_swarm_config())):
        model = build_model(cfg)
        gen = torch.Generator(device=dev).manual_seed(0)
        out[name] = (cfg, tree_stack([model.init(gen) for _ in range(LM_CLIENTS)]))
    return out


def _lm_config():
    """granite-3-2b as registered, cut to ``LM_LAYERS`` layers."""
    from repro_torch.configs import get_config
    return replace(get_config(LM_ARCH), n_layers=LM_LAYERS)


def _preset_config():
    from repro_torch.launch.train import preset_config
    return preset_config(LM_PRESET)


def _ssm_swarm_config(n_layers: int | None = None):
    """mamba2-370m as registered, cut to ``n_layers`` layers
    (``SSM_SWARM_LAYERS`` unless given)."""
    from repro_torch.configs import get_config
    return replace(get_config(SSM_ARCH), n_layers=n_layers or SSM_SWARM_LAYERS)


def check_lm_coordinator(torch, dev, stacks):
    """K1 and K2 at the LM path's shapes (phase 2). K1 over each fit's
    leaves as one call against the plain version at K1's tolerance and
    against float64 ``torch.var_mean`` (the largest gaps printed: the
    mean's over the row's std, the var's relative); K2 at (6, F) against
    (2, F) from the fit's features (two of its rows, then the means of
    its halves), ids equal. Returns the max abs error of K1 and the
    features of each fit."""
    from repro_torch.core.diststats import swarm_distribution_matrix
    from repro_torch.kernels import kmeans_assign, param_stats, ref
    err, feats = 0.0, {}
    for name, (cfg, stacked) in stacks.items():
        leaves = [x.contiguous() for x in _leaves(stacked)]
        rows = max(x[0].numel() for x in leaves)
        before = param_stats.param_stats_leaves.launches
        got = param_stats.param_stats_leaves(leaves)
        expect = ref.param_stats_leaves(leaves)
        torch.cuda.synchronize()
        n_launch = param_stats.param_stats_leaves.launches - before
        assert n_launch == math.ceil(len(leaves) / param_stats.MAX_LEAVES), \
            f"{name}: {n_launch} K1 launches for {len(leaves)} leaves"
        _assert_stats_close(torch, got, expect, f"LM {name}")
        err = max(err, (got - expect).abs().max().item())
        mean_gap = var_gap = 0.0
        for t, x in enumerate(leaves):
            v64, m64 = torch.var_mean(x.view(x.shape[0], -1).double(), 1, correction=0)
            g = got[:, t].double()
            mean_gap = max(mean_gap, ((g[:, 0] - m64).abs() / v64.sqrt().clamp_min(1e-30))
                           .max().item())
            live = v64 > 0
            if live.any():
                var_gap = max(var_gap, ((g[live, 1] - v64[live]).abs() / v64[live]).max().item())
        log(f"[kernels] param_stats_leaves over the {name} fit's {len(leaves)} leaves x "
            f"{LM_CLIENTS} clients ({sum(x.numel() for x in leaves):,} elements, the longest row "
            f"{rows:,} = {param_stats.slices(rows)} CTAs): {n_launch} launch(es), max abs err "
            f"against the plain version {(got - expect).abs().max().item():.3e}; against float64 "
            f"var_mean: mean gap {mean_gap:.3e} of the row's std, var gap {var_gap:.3e} relative")
        X = swarm_distribution_matrix(stacked)
        feats[name] = X
        F = X.shape[1]
        cents = [X[[0, 3]].contiguous(), torch.stack([X[:3].mean(0), X[3:].mean(0)])]
        for C in cents:
            ids, expect_ids = kmeans_assign.kmeans_assign(X, C), ref.kmeans_assign(X, C)
            torch.cuda.synchronize()
            assert torch.equal(ids, expect_ids), f"kmeans_assign ({LM_CLIENTS},{F}): {ids} vs " \
                f"{expect_ids}"
        log(f"[kernels] kmeans_assign ({LM_CLIENTS},{F})x(2,{F}) from the {name} fit's features "
            f"({'rows streamed through the lanes' if F > 128 else 'rows in registers'}): ids "
            f"equal to the plain version against two seed rows and two half means")
    return err, feats


def time_lm_param_stats(torch, name, leaves):
    """K1 at an LM fit's upload: the wrapper, the device alone (a graph
    of one call), a call of a graph of ``GRAPH_CALLS``, the plain
    version and one ``torch.var_mean`` a leaf (None on fp8 leaves, which
    ``var_mean`` does not take), beside the bound."""
    from repro_torch.kernels import param_stats, ref

    def kernel():
        param_stats.param_stats_leaves(leaves)

    def library():
        for x in leaves:
            torch.var_mean(x.view(x.shape[0], -1), 1, correction=0)

    ms = cuda_ms(torch, kernel, reps=10, trials=5)
    plain_ms = cuda_ms(torch, lambda: ref.param_stats_leaves(leaves), reps=5, trials=3)
    lib_ms = None if any(x.element_size() == 1 for x in leaves) else \
        cuda_ms(torch, library, reps=10, trials=5)
    one = graph_ms(torch, kernel, reps=10)
    many = graph_ms(torch, kernel, GRAPH_CALLS, reps=3)
    n_el = sum(x.numel() for x in leaves)
    n_bytes = sum(x.numel() * x.element_size() + 2 * x.shape[0] * 4 for x in leaves)
    b, by = bound_ms(n_bytes, 4 * n_el)
    launches = math.ceil(len(leaves) / param_stats.MAX_LEAVES)
    log(f"[kernels] param_stats_leaves at the {name} upload ({len(leaves)} leaves, {launches} "
        f"launch(es), {n_bytes / 1e9:.3f} GB): wrapper {ms:.4f} ms, device alone {one:.4f} ms, "
        f"a call of a graph of {GRAPH_CALLS} {many:.4f} ms, bound {b:.4f} ms ({by}; "
        f"{n_bytes / (many * 1e-3) / 1e12:.2f} TB/s achieved); plain {plain_ms:.4f} ms; "
        f"var_mean x {len(leaves)} {_fmt_ms(lib_ms)}")
    return ms, one, many, plain_ms, lib_ms, b, by


def lm_clients(vocab: int):
    from repro_torch.data.tokens import make_token_swarm_data
    t0 = time.perf_counter()
    clients = make_token_swarm_data(LM_CLIENTS, vocab, n_seqs=LM_SEQS, seq_len=LM_SEQ_LEN)
    log(f"[lm] token data: {LM_CLIENTS} clients x {LM_SEQS} train seqs of {LM_SEQ_LEN}, vocab "
        f"{vocab}, made in {time.perf_counter() - t0:.2f} s")
    return clients


def lm_trainer(dev, cfg, clients, rounds: int):
    """A ``SwarmTrainer`` over the LM ``cfg`` at
    test_swarm_is_model_agnostic_lm's settings, seed 0."""
    from repro_torch.configs import OptimizerConfig, SwarmConfig
    from repro_torch.core.swarm import SwarmTrainer
    from repro_torch.models import build_model

    swarm = SwarmConfig(n_clients=LM_CLIENTS, n_clusters=LM_CLUSTERS, rounds=rounds,
                        local_steps=LM_LOCAL_STEPS, kmeans_iters=KMEANS_ITERS)
    return SwarmTrainer(build_model(cfg), clients, swarm, OptimizerConfig(name="adam", lr=LM_LR),
                        seed=0, batch_size=LM_BATCH, device=dev)


def lm_fit(torch, dev, cfg, clients, rounds: int, label: str, finite_loss: bool = True):
    """Phase 15 (a) / (b): ``SwarmTrainer`` over the LM ``cfg`` at
    test_swarm_is_model_agnostic_lm's settings for ``rounds`` rounds,
    with the coordinator's launch counts read from these rounds alone
    (1 K1 pass a round, a launch for every ``MAX_LEAVES`` leaves, and
    ``KMEANS_ITERS + 1`` K2 assigns); each round's loss is asserted
    finite unless ``finite_loss`` is False (then it is printed). Returns
    (trainer, launches, round seconds, peak device bytes)."""
    torch.cuda.reset_peak_memory_stats()
    tr = lm_trainer(dev, cfg, clients, rounds)
    model = tr.model
    n_leaves = len(_leaves(tr.params))
    log(f"[lm {label}] {cfg.arch_id}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{model.param_count(tr.params) // LM_CLIENTS:,} params and {n_leaves} leaves a client "
        f"(F = {2 * n_leaves}), {LM_CLIENTS} clients, activations {cfg.dtype}, params "
        f"{cfg.param_dtype}")
    _zero_coordinator_counts()
    round_s = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        lg = tr.round()
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
        log(f"[lm {label}] round {lg.round}: {round_s[-1]:.3f} s  val_acc={lg.mean_val_acc:.4f} "
            f"loss={lg.train_loss:.4f} assignments={lg.assignments.tolist()} "
            f"centers={lg.centers.tolist()} events={lg.events}")
        assert math.isfinite(lg.train_loss) or not finite_loss, "LM train loss is not finite"
        assert set(lg.assignments.tolist()) <= set(range(LM_CLUSTERS)), "assignment out of range"
        assert 0.0 <= lg.mean_val_acc <= 1.0, "LM val accuracy outside [0, 1]"
    launches = _coordinator_counts()
    want = {**_grid_want(1, rounds, n_leaves), "kmeans_assign with k_active": 0}
    log(f"[lm {label}] launches {launches}, expected {want}")
    assert launches == want, f"LM launch counts {launches} != {want}"
    test_acc = tr.mean_accuracy("test")
    assert 0.0 <= test_acc <= 1.0, f"LM test accuracy {test_acc}"
    peak = torch.cuda.max_memory_allocated()
    log(f"[lm {label}] Eq. 3 test token accuracy {test_acc:.4f}; round seconds "
        f"{[round(s, 4) for s in round_s]}; peak device memory {peak / 1e9:.2f} GB")
    return tr, launches, round_s, peak


def lm_checkpoint_serve(torch, dev, tr, clients):
    """Phase 16 (a): phase 15 (a)'s client-stacked params saved with the
    extras the reference's fleet export writes, restored bitwise, loaded
    with ``client="mean"`` and ``"client:0"`` (bitwise the in-memory
    reductions), and served through the engine; the tokens equal those
    served from ``reduce_clients`` of the in-memory params. Returns
    (flash_decode launches of the drain, {size, save_s, load_s})."""
    import dataclasses
    import tempfile

    from repro_torch import serve
    from repro_torch.checkpoint import restore_into, save_checkpoint
    from repro_torch.kernels import flash_decode
    from repro_torch.serve import BucketSpec
    from repro_torch.serve.api import stacked_example
    from repro_torch.utils.tree import tree_map, tree_paths_and_leaves

    params, model = tr.params, tr.model
    weights = tr.state.n_samples.cpu().tolist()
    extra = {"model_config": dataclasses.asdict(model.cfg), "n_clients": len(weights),
             "client_weights": weights}
    info = {}
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "lm_swarm"
        t0 = time.perf_counter()
        save_checkpoint(path, params, step=tr.state.round, extra=extra)
        info["save_s"] = time.perf_counter() - t0
        info["size"] = path.with_suffix(".npz").stat().st_size
        t0 = time.perf_counter()
        restored, step = restore_into(stacked_example(model, len(weights)), path, device=dev)
        torch.cuda.synchronize()
        info["load_s"] = time.perf_counter() - t0
        assert step == tr.state.round, f"checkpoint step {step}"
        for (p, a), (_, b) in zip(tree_paths_and_leaves(restored), tree_paths_and_leaves(params)):
            assert a.dtype == b.dtype and torch.equal(a, b), f"restored leaf {p} differs"
        del restored
        m_mean, p_mean = serve.load_checkpoint(path, device=dev)
        m_0, p_0 = serve.load_checkpoint(path, client="client:0", device=dev)
    log(f"[ckpt] {len(_leaves(params))} leaves x {len(weights)} clients: {info['size'] / 1e9:.3f} "
        f"GB of npz, saved in {info['save_s']:.2f} s, restored to the card in "
        f"{info['load_s']:.2f} s, every leaf bitwise the saved one")
    assert m_mean is model and m_0 is model, "load_checkpoint rebuilt another model"
    expect_mean = serve.reduce_clients(params, weights, "mean")
    for (p, a), (_, b) in zip(tree_paths_and_leaves(p_mean), tree_paths_and_leaves(expect_mean)):
        assert torch.equal(a, b), f"load_checkpoint mean leaf {p} differs"
    for (p, a), (_, b) in zip(tree_paths_and_leaves(p_0),
                              tree_paths_and_leaves(tree_map(lambda t: t[0], params))):
        assert torch.equal(a, b), f"load_checkpoint client:0 leaf {p} differs"

    test_toks = clients[0]["test"][0]
    prompts = [test_toks[i % len(test_toks), :n] for i, n in enumerate(LM_PROMPT_LENS)]
    kw = dict(max_new_tokens=LM_NEW_TOKENS, buckets=(BucketSpec(len(prompts), LM_SERVE_SEQ),),
              device=dev)
    flash_decode.flash_decode.launches = 0
    res, eng = serve.generate(m_mean, p_mean, prompts, return_engine=True, **kw)
    torch.cuda.synchronize()
    k3 = flash_decode.flash_decode.launches
    want = model.cfg.n_layers * eng.n_decode_calls * DECODE_LAUNCHES_PER_CALL
    log(f"[ckpt] served {len(prompts)} prompts of {list(LM_PROMPT_LENS)} tokens from the "
        f"restored mean model: {eng.n_decode_calls} decode calls, flash_decode launches {k3}, "
        f"expected {want}; tokens of request 0: {res[0].tokens}")
    assert k3 == want > 0, f"flash_decode launches {k3} != {want}"
    mem = serve.generate(model, expect_mean, prompts, **kw)
    assert [r.tokens for r in res] == [r.tokens for r in mem], \
        "the restored model serves other tokens than the in-memory one"
    res0 = serve.generate(m_0, p_0, prompts, **kw)
    mem0 = serve.generate(model, tree_map(lambda t: t[0], params), prompts, **kw)
    assert [r.tokens for r in res0] == [r.tokens for r in mem0], "client:0 serves other tokens"
    log("[ckpt] tokens equal to those served from the in-memory params (mean and client:0)")
    return k3, info


def train_single_path(torch):
    """Phase 16 (b): ``repro_torch.launch.train``'s ``train_single`` (what
    ``main`` runs in single mode) on ``main``'s parsed arguments, the
    ``LM_PRESET`` preset for ``TRAIN_STEPS`` steps with a checkpoint, on
    the card; the loss falls and the checkpoint restores
    bitwise; then the train step alone, timed on one batch. Returns (ce
    of each step, wall seconds, tok/s end to end, seconds a step
    alone)."""
    import tempfile

    from repro_torch.checkpoint import restore_into
    from repro_torch.configs import OptimizerConfig
    from repro_torch.data.tokens import make_lm_batches
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train.steps import make_train_step
    from repro_torch.utils.tree import tree_map, tree_paths_and_leaves

    with tempfile.TemporaryDirectory() as d:
        ckpt = str(Path(d) / "single")
        argv = ["--mode", "single", "--preset", LM_PRESET, "--steps", str(TRAIN_STEPS),
                "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--ckpt", ckpt]
        log(f"[train] python -m repro_torch.launch.train {' '.join(argv[:-1])} <tmp>")
        t0 = time.perf_counter()
        params, ces = train.train_single(train.parse_args(argv))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        restored, step = restore_into(tree_map(torch.empty_like, params), ckpt)
    assert step == TRAIN_STEPS, f"checkpoint step {step}"
    for (p, a), (_, b) in zip(tree_paths_and_leaves(restored), tree_paths_and_leaves(params)):
        assert torch.equal(a, b), f"single-model checkpoint leaf {p} differs"
    assert all(math.isfinite(c) for c in ces), f"non-finite ce {ces}"
    assert ces[-1] < ces[0], f"the loss did not fall: {ces[0]} -> {ces[-1]}"
    tok_s = TRAIN_STEPS * TRAIN_BATCH * TRAIN_SEQ / wall
    log(f"[train] {LM_PRESET}: ce {ces[0]:.4f} at step 0 -> {ces[-1]:.4f} at step "
        f"{TRAIN_STEPS - 1}; {wall:.2f} s for {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"tokens with the checkpoint, {tok_s:,.0f} tok/s end to end; checkpoint restored bitwise")
    # the train step alone: make_lm_batches rebuilds its (vocab, vocab)
    # float64 transition matrix for every batch, as the reference's does
    model = build_model(train.preset_config(LM_PRESET))
    opt = make_optimizer(OptimizerConfig(name="adamw", lr=1e-3))
    step = make_train_step(model, opt)
    t0 = time.perf_counter()
    batch = {k: torch.as_tensor(v, device=params["final_norm"]["scale"].device)
             for k, v in next(make_lm_batches(model.cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, 1))
             .items()}
    batch_s = time.perf_counter() - t0
    state = opt.init(params)
    for _ in range(2):
        params, state, _m = step(params, state, batch, 1e-4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_TIMED_STEPS):
        params, state, _m = step(params, state, batch, 1e-4)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TRAIN_TIMED_STEPS
    log(f"[train] the step alone: {step_s * 1e3:.1f} ms a step "
        f"({TRAIN_BATCH * TRAIN_SEQ / step_s:,.0f} tok/s, mean of {TRAIN_TIMED_STEPS} steps on "
        f"one batch); one make_lm_batches batch takes {batch_s:.2f} s on the host")
    return ces, wall, tok_s, step_s


# ---------------------------------------------------------------- phase 20


def check_fleet_kernels(torch, res, hier_res):
    """K1 over the fleet's final client stack as one call, and K2 at the
    fleet's assign shapes (the coordinator's (14,56) x (3,56), the pod's
    (14,56) x (4,56), the global tier's (4,56) x (3,56)), against their
    plain versions. Returns K1's max abs error."""
    from repro_torch.core.diststats import swarm_distribution_matrix
    from repro_torch.kernels import kmeans_assign, param_stats, ref

    leaves = [x.contiguous() for x in _leaves(res.params)]
    got, expect = param_stats.param_stats_leaves(leaves), ref.param_stats_leaves(leaves)
    torch.cuda.synchronize()
    _assert_stats_close(torch, got, expect, "fleet stack")
    err = (got - expect).abs().max().item()
    X = swarm_distribution_matrix(res.params)
    gen = torch.Generator(device=X.device).manual_seed(20)
    C4 = torch.as_tensor(hier_res.history[-1].stats, device=X.device)
    cases = [("coordinator", X, X[torch.randperm(X.shape[0], generator=gen, device=X.device)[:K]]),
             ("pod", X, C4), ("global tier", C4, X[:K].contiguous())]
    for name, x, c in cases:
        a, b = kmeans_assign.kmeans_assign(x.contiguous(), c.contiguous()), ref.kmeans_assign(x, c)
        torch.cuda.synchronize()
        assert torch.equal(a, b), f"kmeans_assign at the fleet's {name} shape differs"
    log(f"[fleet] K1 over the fleet's {len(leaves)} leaves x {leaves[0].shape[0]} clients: max "
        f"abs err {err:.3e}; K2 equal at {[tuple(x.shape) + tuple(c.shape) for _, x, c in cases]}")
    return err


def profile_fleet_round(torch, fd, mesh, model, opt, clients, res):
    """One more flat fleet round step under ``torch.profiler``, from
    ``res``'s final swarm: the device's busy share of its wall time and
    the NCCL kernels' share of the busy time. Before it, the round's
    host batch draw and its upload are timed apart."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.engine import init_opt_state, stack_eval_split
    from repro_torch.launch.swarm_fleet import fleet_setup

    dev = mesh.device
    step = fleet_setup(model, opt, mesh, k=len(clients), n_local_steps=LOCAL_STEPS,
                       with_eval=True).step
    sp = res.params
    so = init_opt_state(opt, sp)
    val = stack_eval_split(model.cfg, clients, "val", device=dev)
    clusters = torch.as_tensor(res.history[-1].assignments, device=dev)
    w = torch.as_tensor([float(c["n_train"]) for c in clients], device=dev)

    def one(r):
        batch = fd._sample_round_batch(model.cfg, clients, LOCAL_STEPS * BATCH, FLEET_SEED, r,
                                       device=dev)
        return step(sp, so, batch, val, 2e-3, clusters, w)[2].stats.cpu()

    one(100)
    torch.cuda.synchronize()
    draw_ms, up_ms = [], []
    for r in range(102, 105):
        t0 = time.perf_counter()
        host = fd._sample_round_batch(model.cfg, clients, LOCAL_STEPS * BATCH, FLEET_SEED, r)
        t1 = time.perf_counter()
        on_dev = {key: v.to(dev) for key, v in host.items()}
        torch.cuda.synchronize()
        draw_ms.append((t1 - t0) * 1e3)
        up_ms.append((time.perf_counter() - t1) * 1e3)
    nbytes = sum(v.numel() * v.element_size() for v in on_dev.values())
    log(f"[fleet profile] host batch draw {[round(x, 2) for x in draw_ms]} ms, upload of "
        f"{nbytes} B from pageable memory {[round(x, 2) for x in up_ms]} ms")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one(101)
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_us, spans = device_busy_us(prof)
    nccl_us = sum(e.time_range.end - e.time_range.start for e in prof.events()
                  if e.device_type == DeviceType.CUDA and "nccl" in e.name.lower())
    host_nccl = [e.name for e in prof.events()
                 if e.device_type != DeviceType.CUDA and "nccl" in e.name.lower()]
    copies = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA and "memcpy" in e.name.lower()]
    copy_ms = sum(e.time_range.end - e.time_range.start for e in copies) / 1e3
    log(f"[fleet profile] host-side NCCL ops {sorted(set(host_nccl))} x {len(host_nccl)}; "
        f"device copies {len(copies)} ({copy_ms:.3f} ms: {sorted(set(e.name for e in copies))})")
    log(f"[fleet profile] round step of {wall_ms:.1f} ms wall: {len(spans)} device events, busy "
        f"{busy_us / 1e3:.1f} ms ({busy_us / 1e3 / wall_ms:.1%}), NCCL kernels {nccl_us / 1e3:.3f} "
        f"ms ({nccl_us / max(busy_us, 1e-9):.2%} of busy)")
    for kernel in COORDINATOR_KERNELS:
        us = [e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type == DeviceType.CUDA and kernel in e.name]
        log(f"[fleet profile] {kernel}: {len(us)} launches, "
            f"{statistics.mean(us) if us else float('nan'):.2f} us each")
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=12)
    for line in table.splitlines():
        log(f"[fleet profile] {line}")
    return busy_us / 1e3 / wall_ms, nccl_us / max(busy_us, 1e-9)


def _fleet_rounds_line(tag, res) -> None:
    for lg in res.history:
        log(f"[fleet {tag}] round {lg.round}: wall {lg.wall_s:.4f} s, coord {lg.coord_s:.4f} s, "
            f"val acc {lg.mean_val_acc:.4f}, loss {lg.train_loss:.4f}, decision "
            f"{lg.assignments.tolist()}, coordinated {lg.coordinated}, events {lg.events}")
        assert math.isfinite(lg.train_loss), f"fleet {tag}: loss is not finite"
        assert 0.0 <= lg.mean_val_acc <= 1.0, f"fleet {tag}: val accuracy outside [0, 1]"


def fleet_phase(torch, dev, clients, main_round_s) -> dict:
    """Phase 20: the fleet regime on one NCCL rank, phase 3's data and
    settings (squeezenet-dr, 14 clinics at 32 px, adam lr 2e-3, batch 8,
    12 local steps, k 3). (a) ``run_fleet`` flat, 3 rounds: K1 = 3 and
    K2 = 63 launches, the Eq. 2 census (1 + #leaves all-reduces of
    4 * (N * P + N) bytes a round at k = N), a profiled round step; (b) churn
    (``FLEET_FAULTS``), K2 = 21 x the coordinated rounds; (c) the two-tier
    surface at k_local 4 (one pod), K2 = 42 a round; (d) 2 rounds at 2
    local steps and adam eps 1e-6 on the card over NCCL and on the CPU
    over a gloo group beside it: decisions equal every round, params
    within 1e-4; (e) (a)'s final state exported, restored bitwise and
    served. Returns the launches of (a)-(c) and the numbers printed."""
    import os
    import tempfile
    from pathlib import Path as _Path

    import numpy as np

    from repro_torch import serve
    from repro_torch.checkpoint import restore_into
    from repro_torch.configs import OptimizerConfig, get_config
    from repro_torch.launch import fleet_driver as fd
    from repro_torch.launch.mesh import make_fleet_mesh
    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.serve.api import stacked_example

    t0 = time.perf_counter()
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    log(f"[fleet] NCCL_SOCKET_IFNAME={os.environ['NCCL_SOCKET_IFNAME']}")
    N = len(clients)
    model = build_model(get_config("squeezenet-dr"))
    mesh = make_fleet_mesh(N, device=dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    assert mesh.backend == backend and mesh.world == 1, f"fleet mesh {mesh.backend} x {mesh.world}"

    def opt(eps=1e-8):
        return make_optimizer(OptimizerConfig(name="adam", lr=2e-3, eps=eps))

    kw = dict(local_steps=LOCAL_STEPS, batch_size=BATCH, lr=2e-3, n_clusters=K,
              kmeans_iters=KMEANS_ITERS, seed=FLEET_SEED)
    k2_round = KMEANS_ITERS + 1
    out = {"launches": {"param_stats_batched": 0, "kmeans_assign": 0}}

    def counted(tag, **extra):
        _zero_coordinator_counts()
        res = fd.run_fleet(model, opt(), mesh, clients, rounds=FLEET_ROUNDS, **kw, **extra)
        torch.cuda.synchronize()
        n = _coordinator_counts()
        _fleet_rounds_line(tag, res)
        for key in out["launches"]:
            out["launches"][key] += n[key]
        return res, n

    # (a) the flat fleet
    res, n = counted("a")
    want = {**_grid_want(1, FLEET_ROUNDS, len(_leaves(res.params))),
            "kmeans_assign with k_active": 0}
    log(f"[fleet a] launches {n}, expected {want}")
    assert n == want, f"fleet launch counts {n} != {want}"
    P = sum(x[0].numel() for x in _leaves(res.params))
    eq2 = res.comm["eq2_collective_bytes"]
    n_ar = 1 + len(_leaves(res.params))
    assert eq2["op_counts"]["all_reduce"] == n_ar and eq2["total"] == 4 * (N * P + N), \
        f"Eq. 2 census {eq2} != {n_ar} all-reduces of 4 * (N * P + N) = {4 * (N * P + N)} B"
    walls = [lg.wall_s for lg in res.history]
    log(f"[fleet a] ledger: stat_upload_bytes {res.comm['stat_upload_bytes']}, "
        f"eq2_collective_bytes {eq2}, round collectives {res.comm['round_collective_bytes']}, "
        f"coord_reduction_x {res.comm['coord_reduction_x']:.1f}; P = {P} params a client; "
        f"round walls {[round(x, 4) for x in walls]} s beside phase 3's sim rounds "
        f"{[round(x, 4) for x in main_round_s]} s")
    out.update(walls=walls, coord=[lg.coord_s for lg in res.history], eq2=eq2["total"],
               stat_bytes=res.comm["stat_upload_bytes"], P=P)
    out["busy"], out["nccl_share"] = profile_fleet_round(torch, fd, mesh, model, opt(), clients,
                                                         res)

    # (b) churn
    res_b, n = counted("b", faults=fd.FleetFaults(**FLEET_FAULTS))
    coordinated = sum(lg.coordinated for lg in res_b.history)
    assert n["kmeans_assign"] == k2_round * coordinated, \
        f"churn K2 {n['kmeans_assign']} != {k2_round} x {coordinated} coordinated rounds"
    assert n["param_stats_batched"] == FLEET_ROUNDS, f"churn K1 {n['param_stats_batched']}"
    pres = np.mean([lg.present.mean() for lg in res_b.history])
    rep = np.mean([lg.reported.mean() for lg in res_b.history])
    log(f"[fleet b] {FLEET_FAULTS}: presence share {pres:.4f}, report share {rep:.4f}, quorum "
        f"misses {FLEET_ROUNDS - coordinated} of {FLEET_ROUNDS}, launches {n}")
    out.update(presence=pres, reported=rep, misses=FLEET_ROUNDS - coordinated)

    # (c) the two-tier surface, one pod on one rank
    res_c, n = counted("c", hier_k_local=FLEET_HIER_K_LOCAL)
    assert n["kmeans_assign"] == 2 * k2_round * FLEET_ROUNDS, \
        f"two-tier K2 {n['kmeans_assign']} != {2 * k2_round} a round"
    assert n["param_stats_batched"] == FLEET_ROUNDS, f"two-tier K1 {n['param_stats_batched']}"
    log(f"[fleet c] k_local {FLEET_HIER_K_LOCAL}: summary_upload_bytes "
        f"{res_c.comm['summary_upload_bytes']} against flat_upload_bytes "
        f"{res_c.comm['flat_upload_bytes']}, launches {n}")
    out.update(summary_bytes=res_c.comm["summary_upload_bytes"],
               flat_bytes=res_c.comm["flat_upload_bytes"])
    out["k1_err"] = check_fleet_kernels(torch, res, res_c)

    # (d) the card over NCCL against the CPU over a gloo group beside it,
    # both resumed from (a)'s final state (a trained adam state, as phase
    # 4's round starts from the trainer's: from a fresh one adam's first
    # steps are lr * sign(g), and a gradient whose sign differs between
    # cuDNN and the CPU moves its weight by ~lr; PERF.md §6)
    cpu_mesh = make_fleet_mesh(N, device="cpu")
    assert cpu_mesh.backend == "gloo", cpu_mesh.backend
    kw_d = dict(kw, local_steps=2)
    state = (res.params, res.opt_state)
    r_card = fd.run_fleet(model, opt(1e-6), mesh, clients, rounds=FLEET_CARD_VS_CPU_ROUNDS,
                          state=state, **kw_d)
    r_cpu = fd.run_fleet(model, opt(1e-6), cpu_mesh, clients, rounds=FLEET_CARD_VS_CPU_ROUNDS,
                         state=state, **kw_d)
    diff = max((a.cpu() - b).abs().max().item()
               for a, b in zip(_leaves(r_card.params), _leaves(r_cpu.params)))
    for a, b in zip(r_card.history, r_cpu.history):
        log(f"[fleet d] round {a.round}: decisions {a.assignments.tolist()} / "
            f"{b.assignments.tolist()}, val acc {a.mean_val_acc:.4f} / {b.mean_val_acc:.4f}")
        assert np.array_equal(a.assignments, b.assignments), "card and CPU fleet decisions differ"
    log(f"[fleet d] from (a)'s state, 2 rounds of 2 local steps, adam eps 1e-6: max |param diff| "
        f"{diff:.3e}")
    # atol 1e-4, as phase 4
    assert diff <= 1e-4, f"card and CPU fleet params differ by {diff}"
    out["card_cpu_diff"] = diff

    # (e) export (a)'s final state, restore it, serve it
    with tempfile.TemporaryDirectory() as d:
        path = _Path(d) / "fleet"
        t1 = time.perf_counter()
        agg = fd.export_fleet_checkpoint(
            path, model, res.params, res.history[-1].assignments,
            [float(c["n_train"]) for c in clients], round_idx=FLEET_ROUNDS - 1, n_clusters=K,
            mean_val_acc=res.history[-1].mean_val_acc, mesh=mesh)
        save_s = time.perf_counter() - t1
        size = path.with_suffix(".npz").stat().st_size
        t1 = time.perf_counter()
        back, step = restore_into(stacked_example(model, N), path, device=dev)
        load_s = time.perf_counter() - t1
        assert step == FLEET_ROUNDS
        assert all(torch.equal(a, b) for a, b in zip(_leaves(back), _leaves(agg))), \
            "the restored client stack is not the exported one"
        m2, params = serve.load_checkpoint(path, client="mean", device=dev)
        imgs = list(np.concatenate([c["test"][0] for c in clients])[:8])
        served = serve.classify(m2, params, imgs, batch_buckets=(8,), device=dev)
        assert all(0 <= o.label < m2.cfg.vocab_size and math.isfinite(o.confidence)
                   for o in served), "a served label or confidence is off"
    log(f"[fleet e] checkpoint {size} B, exported in {save_s:.3f} s, restored bitwise in "
        f"{load_s:.3f} s, served labels {[o.label for o in served]}")
    out.update(ckpt_bytes=size, save_s=save_s, load_s=load_s)
    mesh.close()
    out["phase_s"] = time.perf_counter() - t0
    log(f"[fleet] phase 20 in {out['phase_s']:.1f} s, launches {out['launches']}")
    return out


# --- phase 21: the production dry-run's one-card probe


DRYRUN_ARCH = "granite-3-2b"
DRYRUN_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
DRYRUN_GRAD_RTOL = 1e-5           # of max |g|: remat "full" against "none"


def _probe_line(rec: dict) -> None:
    for L, d in rec["depths"].items():
        log(f"[dryrun] {rec['arch']} {rec['shape']} depth {L} (remat {rec['remat']}, "
            f"{rec['batch_rows']} rows, {rec['microbatches']} microbatches): "
            f"{d['ms']:.2f} ms a step, peak {d['peak_bytes'] / 1e9:.2f} GB, {d['flops']:.6e} "
            f"FLOPs on the card, {d['meta_flops']:.6e} on meta, {d['bytes']:.6e} op bytes")
        assert d["flops"] == d["meta_flops"], \
            f"{rec['shape']} depth {L}: card FLOPs {d['flops']} != meta {d['meta_flops']}"
    if "full_depth" in rec:
        f, r = rec["full_depth"], rec["roofline"]
        log(f"[dryrun] {rec['arch']} {rec['shape']} at its {f['n_layers']} layers "
            f"(extrapolated from depths {list(rec['depths'])}): {f['ms']:.2f} ms a step, peak "
            f"{f['peak_bytes'] / 1e9:.2f} GB, {f['flops']:.6e} FLOPs; H100 roofline: compute "
            f"{r['t_compute_s'] * 1e3:.3f} ms, memory (op bytes, unfused) "
            f"{r['t_memory_s'] * 1e3:.3f} ms, dominant {r['dominant']}")


def _remat_grads(torch, dev, remat: str):
    """Gradients of one train_4k sequence through granite at depth 2
    under ``remat``, from one seed."""
    from torch.func import grad_and_value

    from repro_torch.configs import INPUT_SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.models import build_model
    cfg = dryrun._probe_cfg(replace(dryrun.runtime_config(DRYRUN_ARCH, INPUT_SHAPES["train_4k"]),
                                    remat=remat), 2)
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen)
    toks = torch.randint(0, cfg.vocab_size, (1, INPUT_SHAPES["train_4k"].seq_len),
                         generator=gen, device=dev, dtype=torch.int32)
    grads, _ = grad_and_value(model.loss, has_aux=True)(params, {"tokens": toks,
                                                                 "labels": toks})
    return _leaves(grads)


def time_flash_decode_probe(torch, dev, B: int, S: int, window: int) -> dict:
    """K3 at a decode probe's shape: q (B,32,1,64) bf16 against a bf16
    cache stored (B,S,8,64), every row at position S - 1, under
    ``window``: held against its plain version (within 2e-2 of its
    largest magnitude), timed through the wrapper beside the plain
    version and SDPA, and bounded by the bytes of the keys the mask keeps
    (the window's, where there is one) beside the whole cache's."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_decode, ref
    H, KV, D = 32, 8, 64
    gen = torch.Generator(device=dev).manual_seed(21)
    q, k, v = _decode_case(torch, dev, gen, B, H, KV, S, D, torch.bfloat16)
    pos = torch.tensor(S - 1, dtype=torch.int32, device=dev)
    got = flash_decode.flash_decode(q, k, v, pos, window)
    expect = ref.decode_attention(q, k, v, pos, window).float()
    torch.cuda.synchronize()
    scale = expect.abs().max().item()
    err = (got.float() - expect).abs().max().item()
    assert err <= 2e-2 * scale, f"flash_decode probe B {B} S {S} window {window}: {err}"
    cols = torch.arange(S, device=dev)
    mask = (cols <= pos) & ((cols > pos - window) if window else True)
    keys = min(S, window) if window else S

    def kernel():
        flash_decode.flash_decode(q, k, v, pos, window)

    def plain():
        ref.decode_attention(q, k, v, pos, window)

    def library():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask[None, None, None, :],
                                              enable_gqa=True)

    lib_err = (library().float() - expect).abs().max().item()
    ms, plain_ms, lib_ms = (cuda_ms(torch, f, reps=20, trials=3) for f in (kernel, plain, library))
    es = k.element_size()
    n_bytes = B * keys * KV * D * 2 * es + 2 * q.numel() * q.element_size() + 4
    full_ms = B * S * KV * D * 2 * es / HBM_BYTES_PER_S * 1e3
    b, by = bound_ms(n_bytes, B * keys * H * (4 * D + 5), BF16_TENSOR_FLOPS)
    name = (f"flash_decode probe (B {B}) (B,32,1,64) vs (B,{S},8,64) bf16, pos {S - 1}, "
            f"window {window}")
    log(f"[kernels] {name}: max abs err {err:.3e} (tol {2e-2 * scale:.3e}); kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms (sdpa vs plain {lib_err:.3e}), bound "
        f"{b:.5f} ms ({by}, the {keys} keys the mask keeps); the whole cache's bytes "
        f"{full_ms:.5f} ms")
    if window:
        log(f"[kernels] {name}: reads only the window's columns: "
            f"{'yes' if ms < full_ms else 'no'} (kernel {ms:.4f} ms against {full_ms:.5f} ms "
            f"to read the whole cache once)")
    return {"err": err, "times": (ms, plain_ms, lib_ms, b, by)}


def dryrun_phase(torch, dev, card: str) -> dict:
    """Phase 21: (a) granite-3-2b as registered through
    ``launch.dryrun.probe_on_card`` at depths 1 and 2 for the four input
    shapes, and train_4k at remat "none" at depth 2 beside "full"
    (peaks, and one sequence's gradients within 1e-5 of the largest);
    (b) K3 at the two decode probes' shapes; (c) ``kmeans.assign`` and
    ``ops.param_stats`` against their plain versions at phase 3's shapes.
    K3 launches are counted over (a)'s decode probes alone."""
    from repro_torch.core import kmeans
    from repro_torch.kernels import flash_decode, ops, ref
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    out = {"records": {}, "k3": 0}
    for shape in DRYRUN_SHAPES:
        flash_decode.flash_decode.launches = 0
        rec = dryrun.probe_on_card(DRYRUN_ARCH, shape, device=dev)
        launches = flash_decode.flash_decode.launches
        # each depth's step runs twice (counted, then timed), one K3 call a layer
        decode = dryrun.INPUT_SHAPES[shape].kind == "decode"
        want = 2 * sum(int(L) for L in rec["depths"]) if decode else 0
        log(f"[dryrun] {DRYRUN_ARCH} {shape}: flash_decode launches {launches} (expected {want}); "
            f"{card}")
        assert launches == want, f"{shape}: flash_decode launches {launches} != {want}"
        out["k3"] += launches
        _probe_line(rec)
        out["records"][shape] = rec
        torch.cuda.empty_cache()
    none = dryrun.probe_on_card(DRYRUN_ARCH, "train_4k", layers=(2,), device=dev,
                                overrides={"remat": "none"})
    _probe_line(none)
    peak_full = out["records"]["train_4k"]["depths"]["2"]["peak_bytes"]
    peak_none = none["depths"]["2"]["peak_bytes"]
    g_full, g_none = (_remat_grads(torch, dev, r) for r in ("full", "none"))
    gmax = max(g.abs().max().item() for g in g_none)
    gdiff = max((a - b).abs().max().item() for a, b in zip(g_full, g_none))
    log(f"[dryrun] train_4k depth 2 peak: remat full {peak_full / 1e9:.2f} GB, none "
        f"{peak_none / 1e9:.2f} GB; one sequence's gradients full vs none max |diff| "
        f"{gdiff:.3e} (max |g| {gmax:.3e}, tol {DRYRUN_GRAD_RTOL} of it)")
    assert peak_full < peak_none, "remat full does not lower the depth-2 train_4k peak"
    assert gdiff <= DRYRUN_GRAD_RTOL * gmax, f"remat full vs none gradients differ by {gdiff}"
    out["peaks"] = (peak_full, peak_none)
    del g_full, g_none
    torch.cuda.empty_cache()

    # (b) K3 at the decode probes' shapes
    dec, lng = dryrun.INPUT_SHAPES["decode_32k"], dryrun.INPUT_SHAPES["long_500k"]
    out["k3_probe"] = {
        "decode_32k": time_flash_decode_probe(torch, dev, dryrun.per_device_batch(dec),
                                              dec.seq_len, 0),
        "long_500k": time_flash_decode_probe(torch, dev, dryrun.per_device_batch(lng),
                                             lng.seq_len, 8192)}
    torch.cuda.empty_cache()

    # (c) the small surface on the card at phase 3's shapes
    from repro_torch.configs import get_config
    from repro_torch.core.diststats import swarm_distribution_matrix
    from repro_torch.models import build_model
    from repro_torch.utils.tree import tree_stack
    model = build_model(get_config("squeezenet-dr"))
    gen = torch.Generator(device=dev).manual_seed(0)
    stacked = tree_stack([model.init(gen) for _ in range(14)])
    feats = swarm_distribution_matrix(stacked)
    cents = feats[torch.randperm(14, generator=gen, device=dev)[:K]].contiguous()
    ids = kmeans.assign(feats, cents)
    assert torch.equal(ids, ref.kmeans_assign(feats, cents)), "kmeans.assign vs its plain version"
    assert torch.equal(kmeans.assign(feats, cents, k_active=2),
                       ref.kmeans_assign(feats, cents, 2)), "kmeans.assign k_active 2"
    err = 0.0
    for leaf in _leaves(stacked):
        m, v = ops.param_stats(leaf[0].contiguous())
        em, ev = ref.param_stats_batched(leaf[:1])
        err = max(err, abs(m.item() - em.item()), abs(v.item() - ev.item()))
    assert err <= 1e-5, f"ops.param_stats vs its plain version: {err}"
    log(f"[dryrun] kmeans.assign (14,56)x(3,56) equal to the plain version (and at k_active 2); "
        f"ops.param_stats on each of one client's {len(_leaves(stacked))} leaves within {err:.3e} "
        f"of the plain version")
    out["seconds"] = time.perf_counter() - t0
    log(f"[dryrun] phase 21 in {out['seconds']:.1f} s")
    return out


# --- phase 22: the LM fleet placed by the table (fleet_setup(spmd="auto"))


PLACED_ROUNDS = 3
PLACED_TOL = 1e-6                 # auto against shard_map, max |param diff| under sgd
PLACED_MERGE_RTOL = 1e-5          # the shard merge against the whole leaf's plain stats
PLACED_SPLITS = ((0.5,), (0.2, 0.5))   # cut points of a leaf's row: 2 even, 3 uneven shards


def _placed_state(torch, model, opt, dev, place=None):
    """A thunk of phase 22's fresh client stack: ``LM_CLIENTS`` models
    from one generator seeded 0 on the card and adam's zero state, each
    passed through ``place`` if given."""
    from repro_torch.core.engine import init_opt_state
    from repro_torch.utils.tree import tree_stack

    def state():
        gen = torch.Generator(device=dev).manual_seed(0)
        sp = tree_stack([model.init(gen) for _ in range(LM_CLIENTS)])
        so = init_opt_state(opt, sp)
        return (sp, so) if place is None else (place(sp), place(so))

    return state


def _placed_rounds(torch, prog, state, batches, w, decisions=None, coordinate=False):
    """``PLACED_ROUNDS`` fleet rounds of ``prog`` (its val stack bound)
    from ``state()``'s fresh (params, optimizer state), which nothing
    else holds: round r applies ``decisions[r]`` (singletons first), or
    with ``coordinate`` the host coordinator's decision from round r-1's
    stats. Returns (sp, so, decisions, stats a round, seconds a round)."""
    import numpy as np

    from repro_torch.launch import fleet_driver as fd
    dev = w.device
    sp, so = state()
    decisions = list(decisions or [np.arange(LM_CLIENTS, dtype=np.int32)])
    stats, secs = [], []
    for r in range(PLACED_ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sp, so, out = prog.step(sp, so, batches[r], LM_LR,
                                torch.as_tensor(decisions[r], device=dev), w)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        stats.append(out.stats.cpu())
        assert math.isfinite(float(out.train_loss)), "placed fleet loss is not finite"
        if coordinate:
            a, _, _ = fd.host_coordinator(out.stats, out.val_acc, k=LM_CLUSTERS, p1=0.9, p2=0.8,
                                          kmeans_iters=KMEANS_ITERS, seed=FLEET_SEED,
                                          round_idx=r)
            decisions.append(a)
    return sp, so, decisions, stats, secs


def _whole(tree):
    from repro_torch.sharding.rules import is_placed
    from repro_torch.utils.tree import tree_map
    return tree_map(lambda x: x.full_tensor() if is_placed(x) else x, tree)


def check_shard_merge(torch, leaves) -> float:
    """Phase 22 (c): each leaf's row cut by hand into 2 even and 3 uneven
    shards, K1 over each shard set on the card (one call a set),
    ``diststats.merge_shard_stats``, against the plain version over the
    whole leaves: |mean gap| within ``PLACED_MERGE_RTOL`` of the row's
    scale (|mean| + std), |var gap| within it of the var. Returns the
    largest gap so scaled."""
    from repro_torch.core.diststats import merge_shard_stats
    from repro_torch.kernels import ops, param_stats, ref
    flat = [x.reshape(x.shape[0], -1) for x in leaves]
    want = ref.param_stats_leaves(flat)
    worst = 0.0
    for cuts in PLACED_SPLITS:
        parts, counts = [], []
        for x in flat:
            n = x.shape[1]
            edges = [0] + [int(n * c) for c in cuts] + [n]
            parts.append([x[:, a:b].contiguous() for a, b in zip(edges, edges[1:])])
            counts.append([b - a for a, b in zip(edges, edges[1:])])
        before = param_stats.param_stats_leaves.launches
        stats = torch.stack([ops.param_stats_leaves([p[i] for p in parts])
                             for i in range(len(cuts) + 1)])
        assert param_stats.param_stats_leaves.launches - before == len(cuts) + 1, \
            "the shard merge's K1 calls did not launch the kernel"
        cnt = torch.tensor(counts, device=stats.device).T[:, None, :].expand(-1, stats.shape[1], -1)
        got = merge_shard_stats(stats, cnt)
        torch.cuda.synchronize()
        scale = want[..., 0].abs() + want[..., 1].clamp_min(0).sqrt()
        gm = ((got[..., 0] - want[..., 0]).abs() / scale.clamp_min(1e-30)).max().item()
        gv = ((got[..., 1] - want[..., 1]).abs()
              / want[..., 1].clamp_min(1e-30)).max().item()
        log(f"[placed c] {len(cuts) + 1} shards a leaf (cuts {cuts}) over {len(flat)} leaves x "
            f"{flat[0].shape[0]} clients: mean gap {gm:.3e} of |mean| + std, var gap {gv:.3e} "
            f"relative")
        assert gm <= PLACED_MERGE_RTOL and gv <= PLACED_MERGE_RTOL, \
            f"shard merge vs the whole leaf: {gm}, {gv}"
        worst = max(worst, gm, gv)
    return worst


def placed_fleet_phase(torch, dev, lm_data, card: str) -> dict:
    """Phase 22: the LM fleet placed by the table on one NCCL rank, a
    (1,1,1) pod mesh, granite-3-2b at full width cut to ``LM_LAYERS``
    layers with phase 15's settings (``LM_CLIENTS`` token clients, k
    ``LM_CLUSTERS``, adam lr ``LM_LR``, batch ``LM_BATCH``,
    ``LM_LOCAL_STEPS`` local steps, ids below ``LM_DATA_VOCAB``).
    (d)'s census first, on ``meta`` under a fake world of one (a process
    group is process-wide); then (a) ``PLACED_ROUNDS`` rounds of
    ``fleet_setup(spmd="auto")`` with ``host_coordinator`` after each:
    K1 = 1 and K2 = ``KMEANS_ITERS + 1`` launches a round asserted, ms a
    round step and peak memory; (b) the same rounds, inputs and
    decisions through ``spmd="shard_map"``: max |param diff| printed
    under adam, and asserted within ``PLACED_TOL`` under sgd at the same
    lr, both layouts run again (the per-client step's GEMMs and the
    vmapped step's round bf16 differently, and adam's first steps, lr *
    sign(g), turn that into moves of up to lr: PERF.md §6); (c)
    the upload's shard merge on the card (:func:`check_shard_merge`);
    (d) a plain round step's FLOPs on the card (``launch.dryrun.Census``)
    equal to the census; (e) a profiled round step's busy share and the
    Eq. 2 census. Returns the launches of (a) and the numbers printed."""
    import os

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import OptimizerConfig
    from repro_torch.core.engine import stack_eval_split
    from repro_torch.launch import dryrun
    from repro_torch.launch import fleet_driver as fd
    from repro_torch.launch.mesh import make_fleet_mesh, make_pod_mesh
    from repro_torch.launch.swarm_fleet import fleet_round_census, fleet_setup
    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.utils.collectives import CENSUS

    t0 = time.perf_counter()
    cfg = _lm_config()
    model = build_model(cfg)
    rows = LM_LOCAL_STEPS * LM_BATCH

    def opt_cfg(name="adam"):
        return OptimizerConfig(name=name, lr=LM_LR)

    # (d) the census of one plain round step on meta, at world 1
    t1 = time.perf_counter()
    with dryrun.fake_world(1):
        rec = fleet_round_census(cfg, opt_cfg(), make_pod_mesh((1, 1, 1)),
                                 n_clients=LM_CLIENTS, per_client_batch=rows, seq=LM_SEQ_LEN,
                                 k=LM_CLIENTS, n_local_steps=LM_LOCAL_STEPS)
    log(f"[placed d] census on meta at world 1: {rec['flops']:.6e} FLOPs, {rec['bytes']:.4e} op "
        f"bytes, tags {rec['tags']}, by axis {json.dumps(rec['by_axis'])}, argument bytes "
        f"{rec['memory']['argument_bytes']:,} ({time.perf_counter() - t1:.1f} s)")

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    fm = make_fleet_mesh(LM_CLIENTS, device=dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    assert fm.backend == backend and fm.world == 1, f"fleet mesh {fm.backend} x {fm.world}"
    dm = make_pod_mesh((1, 1, 1))
    val = stack_eval_split(cfg, lm_data, "val", batch=LM_BATCH, device=dev)
    w = torch.as_tensor([float(c["n_train"]) for c in lm_data], device=dev)
    batches = [fd._sample_round_batch(cfg, lm_data, rows, FLEET_SEED, r, device=dev)
               for r in range(PLACED_ROUNDS)]
    out = {}

    def auto(name):
        return fleet_setup(model, make_optimizer(opt_cfg(name)), dm, k=LM_CLIENTS,
                           n_local_steps=LM_LOCAL_STEPS, with_eval=True, spmd="auto")

    def with_val(prog):
        step = prog.step
        return prog._replace(step=lambda sp, so, b, lr, c, ww: step(sp, so, b, val, lr, c, ww))

    # (a) three coordinated rounds, launch counts from them alone
    prog = auto("adam")
    torch.cuda.reset_peak_memory_stats()
    _zero_coordinator_counts()
    mark = CENSUS.mark()
    sp, so, decisions, stats_a, secs = _placed_rounds(
        torch, with_val(prog), _placed_state(torch, model, make_optimizer(opt_cfg()), dev,
                                             prog.place), batches, w, coordinate=True)
    launches = _coordinator_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {"param_stats_batched": PLACED_ROUNDS, "kmeans_assign": PLACED_ROUNDS *
            (KMEANS_ITERS + 1), "kmeans_assign with k_active": 0}
    entries = CENSUS.since(mark)
    eq2 = [e for e in entries if e.tag == "eq2"]
    n_leaves = len(_leaves(sp))
    log(f"[placed a] {cfg.arch_id} at {cfg.n_layers} layers, {LM_CLIENTS} clients on a (1,1,1) "
        f"pod mesh over {fm.backend}: round steps {[round(x, 4) for x in secs]} s, peak "
        f"{peak / 1e9:.2f} GB, decisions {[list(map(int, d)) for d in decisions]}, launches "
        f"{launches} (expected {want}); {card}")
    assert launches == want, f"placed fleet launch counts {launches} != {want}"
    assert len(eq2) == PLACED_ROUNDS * (1 + n_leaves), f"{len(eq2)} Eq. 2 all-reduces"
    final_a = [x.cpu() for x in _leaves(_whole(sp))]
    out.update(secs=secs, peak=peak, launches=launches,
               eq2_count=len(eq2) // PLACED_ROUNDS,
               eq2_bytes=sum(e.nbytes for e in eq2) // PLACED_ROUNDS,
               merge=[e for e in entries if e.tag == "stats_merge"][:1])

    # (d) one plain round step on the card under the census, FLOPs equal
    plain = fleet_setup(model, make_optimizer(opt_cfg()), dm, k=LM_CLIENTS,
                        n_local_steps=LM_LOCAL_STEPS, spmd="auto")
    census = dryrun.Census()
    with census:
        plain.step(sp, so, batches[0], LM_LR, torch.as_tensor(decisions[-1], device=dev), w)
    torch.cuda.synchronize()
    log(f"[placed d] a plain round step on the card: {census.flops:.6e} FLOPs (census on meta "
        f"{rec['flops']:.6e}), {census.bytes:.4e} op bytes (meta {rec['bytes']:.4e})")
    assert census.flops == rec["flops"], f"card FLOPs {census.flops} != meta {rec['flops']}"
    out["flops"] = census.flops

    # (e) a profiled round step and the Eq. 2 census
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        with_val(prog).step(sp, so, batches[0], LM_LR,
                            torch.as_tensor(decisions[-1], device=dev), w)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    busy_us, spans = device_busy_us(prof)
    out["busy"], out["profiled_ms"] = busy_us / 1e3 / wall_ms, wall_ms
    log(f"[placed e] profiled round step {wall_ms:.1f} ms wall: {len(spans)} device events, busy "
        f"{busy_us / 1e3:.1f} ms ({out['busy']:.1%}); Eq. 2 census {out['eq2_count']} "
        f"all-reduces of {out['eq2_bytes']:,} B a round (world 1: counted, no byte moves), "
        f"stat merge {out['merge']}")
    for line in prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=10).splitlines():
        log(f"[placed e] {line}")
    del sp, so, prof
    torch.cuda.empty_cache()

    # (c) the shard merge over the first round's upload shapes
    fresh = _placed_state(torch, model, make_optimizer(opt_cfg()), dev)()[0]
    out["merge_err"] = check_shard_merge(torch, [x for x in _leaves(fresh)
                                                 if x.is_floating_point()])
    del fresh
    torch.cuda.empty_cache()

    # (b) the same rounds and decisions through shard_map
    def shard_map_rounds(name):
        opt = make_optimizer(opt_cfg(name))
        prog_b = fleet_setup(model, opt, fm, k=LM_CLIENTS, n_local_steps=LM_LOCAL_STEPS,
                             with_eval=True)
        sp, so, _, stats, secs = _placed_rounds(torch, with_val(prog_b),
                                                _placed_state(torch, model, opt, dev), batches,
                                                w, decisions=decisions)
        del so
        return [x.cpu() for x in _leaves(sp)], stats, secs

    def max_diff(a, b):
        return max((x.float() - y.float()).abs().max().item() for x, y in zip(a, b))

    final_b, stats_b, secs_b = shard_map_rounds("adam")
    diff_adam = max_diff(final_a, final_b)
    sdiff = max((x - y).abs().max().item() for x, y in zip(stats_a, stats_b))
    log(f"[placed b] shard_map round steps {[round(x, 4) for x in secs_b]} s; adam (phase 15's "
        f"settings): max |param diff| auto vs shard_map {diff_adam:.3e}, max |stats diff| "
        f"{sdiff:.3e} (not asserted: adam's lr * sign(g) steps amplify bf16 GEMM rounding)")
    del final_a, final_b
    prog_sgd = auto("sgd")
    sp, so, _, _, _ = _placed_rounds(
        torch, with_val(prog_sgd), _placed_state(torch, model, make_optimizer(opt_cfg("sgd")),
                                                 dev, prog_sgd.place),
        batches, w, decisions=decisions)
    final_a = [x.cpu() for x in _leaves(_whole(sp))]
    del sp, so
    torch.cuda.empty_cache()
    final_b, _, _ = shard_map_rounds("sgd")
    diff_sgd = max_diff(final_a, final_b)
    log(f"[placed b] sgd at lr {LM_LR}, the same rounds and decisions: max |param diff| auto vs "
        f"shard_map {diff_sgd:.3e} (tol {PLACED_TOL})")
    assert diff_sgd <= PLACED_TOL, f"placed and shard_map fleets differ by {diff_sgd}"
    out.update(diff_adam=diff_adam, diff_sgd=diff_sgd, shard_map_secs=secs_b)
    fm.close()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    log(f"[placed] phase 22 in {out['phase_s']:.1f} s, launches {out['launches']}")
    return out


# ---------------------------------------------------------------- phase 23

CONTRACT_DTYPE = "float16"        # (a)'s activations and (b)'s params
CONTRACT_CACHE = "float8_e5m2"    # (a)'s KV cache
CONTRACT_K1_CLIENTS = 70_000      # (c): a stack past the old 65,535-client limit
HALF_RTOL = 2e-2                  # of max |out|: K3 / K4 with a half q, as phases 5 and 8


def contract_serve(torch, dev) -> dict:
    """Phase 23 (a): granite-3-2b as registered with fp16 activations and
    an e5m2 KV cache, through phase 6's engine, buckets and workload; K3
    launches 40 a decode call and finite first-call logits asserted."""
    from repro_torch.configs import get_config
    cfg = replace(get_config(SERVE_ARCH), dtype=CONTRACT_DTYPE, cache_dtype=CONTRACT_CACHE)
    launches, eng, info = serve_path(torch, dev, cfg, tag="contract a")
    del eng
    torch.cuda.empty_cache()
    log(f"[contract a] {cfg.arch_id} {cfg.dtype} on a {cfg.cache_dtype} cache: "
        f"{info['tok_s']:.2f} tok/s, {info['tick_ms']:.2f} ms a decode tick (both buckets), "
        f"{info['decode_ms']:.2f} ms a decode call, TTFT p50 {info['ttft_p50_ms']:.1f} ms, "
        f"busy {info['busy']:.1%} of a profiled tick; K3 launches {launches}")
    return {**info, "k3": launches}


def contract_swarm(torch, dev, lm_data) -> dict:
    """Phase 23 (b): phase 15 (a)'s LM swarm with ``param_dtype`` fp16
    for LM_ROUNDS rounds, K1 = 2 and K2 = 42 asserted; first the round-0
    upload (the trainer's initial client stack) through K1 on the fp16
    leaves against its plain version, as :func:`check_lm_coordinator`
    holds the fp32 one. A loss that is not finite is printed, not
    asserted (the reference's fp16 params would give it too). Returns
    the launches, round seconds, peak, K1's error and the fp16 leaves."""
    from repro_torch.models import build_model
    from repro_torch.utils.tree import tree_stack
    cfg = replace(_lm_config(), param_dtype=CONTRACT_DTYPE)
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    stacked = tree_stack([model.init(gen) for _ in range(LM_CLIENTS)])
    k1_err, _ = check_lm_coordinator(torch, dev, {"granite fp16": (cfg, stacked)})
    leaves = [x.contiguous() for x in _leaves(stacked)]
    del stacked
    tr, launches, secs, peak = lm_fit(torch, dev, cfg, lm_data, LM_ROUNDS, "contract b",
                                      finite_loss=False)
    del tr
    torch.cuda.empty_cache()
    log(f"[contract b] {cfg.arch_id} at {cfg.n_layers} layers, params {cfg.param_dtype}: round "
        f"seconds {[round(x, 4) for x in secs]}, peak {peak / 1e9:.2f} GB, launches {launches}, "
        f"K1 on the round-0 upload max abs err {k1_err:.3e}")
    return {"launches": launches, "secs": secs, "peak": peak, "k1_err": k1_err,
            "leaves": leaves}


def _fmt_ms(ms) -> str:
    return "none" if ms is None else f"{ms:.4f} ms"


def _time_line(name, ms, one, plain_ms, lib_ms, lib_name, b, by, card, tag="contract c"):
    log(f"[{tag}] {name}: wrapper {ms:.4f} ms, device alone {one:.4f} ms, bound {b:.5f} ms "
        f"({by}), plain {plain_ms:.4f} ms, {lib_name} {_fmt_ms(lib_ms)}; {card}")


def contract_k1(torch, dev, leaves, card) -> float:
    """Phase 23 (c), K1: (b)'s fp16 leaves and the same in e4m3, each as
    one call against the plain version (K1's tolerance) and timed as
    :func:`time_lm_param_stats`; then a (70,000, 56) fp32 stack against
    the plain version, timed beside ``torch.var_mean``. Returns the max
    abs error."""
    from repro_torch.kernels import param_stats, ref
    err = 0.0
    for name, ls in (("fp16", leaves), ("e4m3", [x.to(torch.float8_e4m3fn) for x in leaves])):
        got, expect = param_stats.param_stats_leaves(ls), ref.param_stats_leaves(ls)
        torch.cuda.synchronize()
        _assert_stats_close(torch, got, expect, f"contract K1 {name}")
        err = max(err, (got - expect).abs().max().item())
        ms, one, many, plain_ms, lib_ms, b, by = time_lm_param_stats(
            torch, f"granite {name} (phase 23)", ls)
        _time_line(f"K1 over the {len(ls)} {name} leaves of {LM_CLIENTS} clients "
                   f"({sum(x.numel() for x in ls):,} elements), max abs err "
                   f"{(got - expect).abs().max().item():.3e}", ms, one, plain_ms, lib_ms,
                   f"var_mean x {len(ls)}", b, by, card)
        del ls, got, expect
    gen = torch.Generator(device=dev).manual_seed(23)
    wide = torch.randn((CONTRACT_K1_CLIENTS, 56), generator=gen, device=dev) * 0.1 + 0.3
    m, v = param_stats.param_stats_batched(wide)
    rm, rv = ref.param_stats_batched(wide)
    got, expect = torch.stack([m, v], 1), torch.stack([rm, rv], 1)
    _assert_stats_close(torch, got, expect, f"contract K1 ({CONTRACT_K1_CLIENTS}, 56)")
    err = max(err, (got - expect).abs().max().item())

    def kernel():
        param_stats.param_stats_batched(wide)

    def plain():
        ref.param_stats_batched(wide)

    def library():
        torch.var_mean(wide, 1, correction=0)

    n_bytes = wide.numel() * 4 + 2 * CONTRACT_K1_CLIENTS * 4
    b, by = bound_ms(n_bytes, 4 * wide.numel())
    _time_line(f"K1 over a ({CONTRACT_K1_CLIENTS}, 56) fp32 stack ({CONTRACT_K1_CLIENTS} CTAs), "
               f"max abs err {(got - expect).abs().max().item():.3e}", cuda_ms(torch, kernel),
               graph_ms(torch, kernel), cuda_ms(torch, plain), cuda_ms(torch, library),
               "var_mean", b, by, card)
    return err


def contract_k2(torch, dev, card) -> None:
    """Phase 23 (c), K2: bf16 X (4,096, 4,096) against bf16 C (16, 4,096)
    (K*F 5.3x one C tile: 2 centroid blocks of 4 feature chunks), with
    and without k_active 11, ids equal to the plain version, timed beside
    ``cdist + argmin`` on the upcast operands and the bound."""
    from repro_torch.kernels import kmeans_assign, ref
    gen = torch.Generator(device=dev).manual_seed(24)
    X = torch.randn((4096, 4096), generator=gen, device=dev).to(torch.bfloat16)
    C = torch.randn((16, 4096), generator=gen, device=dev).to(torch.bfloat16)
    ka = torch.tensor(11, dtype=torch.int32, device=dev)
    for label, k in (("without k_active", None), ("k_active 11", ka)):
        got, expect = kmeans_assign.kmeans_assign(X, C, k), ref.kmeans_assign(X, C, k)
        torch.cuda.synchronize()
        bad = int((got != expect).sum())
        assert bad == 0, f"contract K2 {label}: {bad} of {got.numel()} ids differ"
        Ck = C if k is None else C[:11]

        def kernel(k=k):
            kmeans_assign.kmeans_assign(X, C, k)

        def plain(k=k):
            ref.kmeans_assign(X, C, k)

        def library(Ck=Ck):
            torch.cdist(X.float(), Ck.float()).argmin(1)

        N, F = X.shape
        Kc = Ck.shape[0]
        n_bytes = (N * F + C.shape[0] * F) * 2 + N * 4
        n_ops = 2 * N * Kc * F + 2 * N * F + 2 * Kc * F + 3 * N * Kc
        b, by = bound_ms(n_bytes, n_ops)
        _time_line(f"K2 bf16 (4096,4096) x (16,4096) {label}, c_tiles "
                   f"{kmeans_assign.c_tiles(16, 4096)}, ids equal", cuda_ms(torch, kernel),
                   graph_ms(torch, kernel), cuda_ms(torch, plain), cuda_ms(torch, library),
                   "cdist+argmin (fp32)", b, by, card)


# ------------------------------------------------- fp8 outputs (phases 23, 24)

# constant V rows on both sides of fp8's edges: e4m3 is NaN above 464,
# e5m2 inf from 61,440 (tests/test_torch_cuda.py's OVERFLOW_V)
OVERFLOW_V = [460.0, -466.0, 470.0, -300.0, 61000.0, 62000.0, -62500.0, 1.5]
FP8_REL = 2e-5                    # of max |out|: fp32 sums in other orders (fp8_check)


def _is_fp8(torch, dt) -> bool:
    return dt in (torch.float8_e4m3fn, torch.float8_e5m2)


def fp8_check(torch, got, o32, label: str) -> dict:
    """An fp8 output of K3 or K4 against the plain version's fp32 output
    ``o32`` (the plain version on q upcast; its own fp8 output is
    ``ref.astype(o32)``): every byte must be the reference's rounding of
    a value within FP8_REL of max |o32| of o32, so it equals the plain
    version's byte wherever o32 is farther than that from an fp8
    rounding edge and is its neighbour across the edge otherwise; NaN
    only where an edge rounds to NaN. Returns the count of bytes equal
    to the plain version's and the largest |kernel - plain| among the
    finite outputs."""
    from repro_torch.kernels import ref
    tol = FP8_REL * o32.abs().nan_to_num(posinf=0, neginf=0).max().item()
    lo = ref.astype(o32 - tol, got.dtype).float()
    hi = ref.astype(o32 + tol, got.dtype).float()
    g = got.float()
    nan = torch.isnan(g)
    inside = (g >= lo.nan_to_num(nan=-math.inf)) & (g <= hi.nan_to_num(nan=math.inf))
    ok = torch.where(nan, torch.isnan(lo) | torch.isnan(hi), inside)
    bad = int((~ok).sum())
    assert bad == 0, f"{label}: {bad} of {ok.numel()} fp8 outputs off the plain version"
    plain = ref.astype(o32, got.dtype)
    same = int((got.view(torch.uint8) == plain.view(torch.uint8)).sum())
    finite = torch.isfinite(g) & torch.isfinite(plain.float())
    step = (g - plain.float()).abs()[finite].max().item() if bool(finite.any()) else 0.0
    return {"equal": same, "n": got.numel(), "step": step}


def _err_or_fp8(torch, got, expect, tag, label, tol) -> float:
    """The max abs error of ``got`` against ``expect`` within ``tol``; an
    fp8 output is held by :func:`fp8_check` instead and counts 0.0 (it is
    held by bytes)."""
    if _is_fp8(torch, got.dtype):
        rec = fp8_check(torch, got, expect, label)
        log(f"[{tag}] {label}: fp8 bytes equal to the plain version's {rec['equal']:,} of "
            f"{rec['n']:,}, the rest one rounding step across an edge (largest step "
            f"{rec['step']:.4g})")
        return 0.0
    err = (got.float() - expect).abs().max().item()
    assert err <= tol, f"{label}: max abs err {err} > {tol}"
    return err


def _peak_for(torch, dt) -> float:
    if dt == torch.float32:
        return FP32_FLOPS
    return FP8_TENSOR_FLOPS if _is_fp8(torch, dt) else BF16_TENSOR_FLOPS




def _decode_valid_cols(torch, S, pos, window):
    cols = torch.arange(S, device=pos.device)[None, :]
    p = pos.reshape(-1)[:, None]
    mask = cols <= p
    if window > 0:
        mask = mask & (cols > p - window)
    return mask


def contract_k3_case(torch, dev, gen, label, B, H, KV, S, D, dts, pos, window, card,
                     tag="contract c"):
    """One K3 case of phase 23 (c) or 24 (a): q (B,H,1,D) against a cache
    stored (B,S,KV,D), q / k / v of the types ``dts``, one launch, against
    the plain version (fp32 2e-5, a half q HALF_RTOL of max |out|, an fp8
    q's output by :func:`fp8_check` against the plain version on q
    upcast), then timed: the wrapper, the device alone, the plain
    version, SDPA (``enable_gqa``; the cache cast to q's type first, or
    q, k and v to bf16 where q is fp8, which SDPA does not take), and the
    bound: the bytes of the columns the mask keeps, or their operations
    at the rate of q's type (tensor cores for a half or fp8 q, the fp32
    rate for fp32), as :func:`contract_k4_case`. Returns the max abs
    error (0.0 for an fp8 output, which is held by bytes)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_decode, ref
    q = torch.randn((B, H, 1, D), generator=gen, device=dev).to(dts[0])
    k = torch.randn((B, S, KV, D), generator=gen, device=dev).to(dts[1]).transpose(1, 2)
    v = torch.randn((B, S, KV, D), generator=gen, device=dev).to(dts[2]).transpose(1, 2)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev)
    fp8 = _is_fp8(torch, q.dtype)
    before = flash_decode.flash_decode.launches
    got = flash_decode.flash_decode(q, k, v, pos, window)
    assert flash_decode.flash_decode.launches == before + 1
    expect = ref.decode_attention(q.float() if fp8 else q, k, v, pos, window).float()
    torch.cuda.synchronize()
    tol = 2e-5 if dts == (torch.float32,) * 3 else HALF_RTOL * expect.abs().max().item()
    err = _err_or_fp8(torch, got, expect, tag, f"K3 {label}", tol)
    mask = _decode_valid_cols(torch, S, pos.expand(B), window)        # (B, S)
    valid = int(mask.sum())
    lib_dt = torch.bfloat16 if fp8 else q.dtype

    def kernel():
        flash_decode.flash_decode(q, k, v, pos, window)

    def plain():
        ref.decode_attention(q, k, v, pos, window)

    def library():
        return F.scaled_dot_product_attention(q.to(lib_dt), k.to(lib_dt), v.to(lib_dt),
                                              attn_mask=mask[:, None, None, :], enable_gqa=True)

    n_bytes = valid * KV * D * (k.element_size() + v.element_size()) \
        + 2 * q.numel() * q.element_size() + pos.numel() * 4
    b, by = bound_ms(n_bytes, valid * H * (4 * D + 5), _peak_for(torch, dts[0]))
    chunks = flash_decode.query_chunks(H // KV)
    layout = f"D on {flash_decode.padded_dims(D)}" + (
        f" in {flash_decode.slices(D)} slices" if D > flash_decode.MAX_LAYOUT else "")
    _time_line(f"K3 {label}: q {tuple(q.shape)} {str(dts[0])[6:]}, k {str(dts[1])[6:]}, v "
               f"{str(dts[2])[6:]} ({B},{S},{KV},{D}), pos {pos.tolist()}, window {window}, "
               f"{layout}, query chunks {chunks}, max abs err {err:.3e} (tol {tol:.3e})",
               cuda_ms(torch, kernel, reps=200), graph_ms(torch, kernel),
               cuda_ms(torch, plain, reps=20), cuda_ms(torch, library),
               f"sdpa ({str(lib_dt)[6:]})", b, by, card, tag)
    return err


def contract_k3_graph(torch, dev, gen) -> None:
    """Three replays of one captured G 48 call on an e5m2 cache (6 query
    chunks) on new inputs, each against the plain version: the (row,
    chunk) merge counters are back at 0 after every launch."""
    from repro_torch.kernels import flash_decode, ref
    B, H, KV, S, D, W = 4, 48, 1, 4096, 192, 1024
    q = torch.randn((B, H, 1, D), generator=gen, device=dev).to(torch.float16)
    k, v = (torch.randn((B, S, KV, D), generator=gen, device=dev).to(torch.float8_e5m2)
            .transpose(1, 2) for _ in range(2))
    pos = torch.tensor([4095, 3000, 2047, 1023], dtype=torch.int32, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        flash_decode.flash_decode(q, k, v, pos, W)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = flash_decode.flash_decode(q, k, v, pos, W)
    for rep in range(3):
        q.copy_(torch.randn(q.shape, generator=gen, device=dev))
        k.copy_(torch.randn(k.shape, generator=gen, device=dev))
        v.copy_(torch.randn(v.shape, generator=gen, device=dev))
        pos.copy_(torch.randint(0, S, (B,), generator=gen, device=dev, dtype=torch.int32))
        graph.replay()
        expect = ref.decode_attention(q, k, v, pos, W).float()
        torch.cuda.synchronize()
        err = (out.float() - expect).abs().max().item()
        tol = HALF_RTOL * expect.abs().max().item()
        assert err <= tol, f"contract K3 graph replay {rep}: {err} > {tol}"
        log(f"[contract c] K3 graph replay {rep} (G 48 in 6 chunks, e5m2, pos {pos.tolist()}): "
            f"max abs err {err:.3e} (tol {tol:.3e})")


def contract_k4_case(torch, dev, gen, label, B, H, KV, Sq, Sk, D, dts, causal, window, q_offset,
                     card, tag="contract c"):
    """One K4 case of phase 23 (c) or 24 (b) against the plain version (an
    all-fp32 call 2e-5, else 2e-2, phase 8's; an fp8 q's output by
    :func:`fp8_check` against the plain version on q upcast), timed
    beside SDPA (on k, v cast to q's type where they are of another, or
    on q, k, v cast to bf16 where q is fp8) and the bound: the
    operations on the pairs the mask keeps at the rate of q's type. Returns the max abs
    error (0.0 for an fp8 output, which is held by bytes)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, ops, ref
    q = torch.randn((B, H, Sq, D), generator=gen, device=dev).to(dts[0])
    k = torch.randn((B, KV, Sk, D), generator=gen, device=dev).to(dts[1])
    v = torch.randn((B, KV, Sk, D), generator=gen, device=dev).to(dts[2])
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    fp8 = _is_fp8(torch, q.dtype)
    kernel_name = flash_attention.kernel_for(*dts, D=D)
    before = flash_attention.flash_attention.launches
    got = flash_attention.flash_attention(q, k, v, block_q=Sq, block_k=Sk, **kw)
    assert flash_attention.flash_attention.launches == before + 1
    expect = ref.attention(q.float() if fp8 else q, k, v, **kw).float()
    torch.cuda.synchronize()
    tol = 2e-5 if dts == (torch.float32,) * 3 else 2e-2
    err = _err_or_fp8(torch, got, expect, tag, f"K4 {label}", tol)
    del expect
    rows = q_offset + torch.arange(Sq, device=dev)[:, None]
    cols = torch.arange(Sk, device=dev)[None, :]
    mask = cols <= rows if causal else torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
    if window > 0:
        mask = mask & (cols > rows - window)
    lib_dt = torch.bfloat16 if fp8 else q.dtype

    def kernel():
        flash_attention.flash_attention(q, k, v, block_q=Sq, block_k=Sk, **kw)

    def plain():
        ref.attention(q, k, v, **kw)

    # SDPA's causal form where the mask is its (a square causal tile from
    # position 0), else the mask itself
    plain_causal = causal and window == 0 and q_offset == 0 and Sq == Sk

    def library():
        F.scaled_dot_product_attention(q.to(lib_dt), k.to(lib_dt), v.to(lib_dt),
                                       attn_mask=None if plain_causal else mask,
                                       is_causal=plain_causal, enable_gqa=True)

    n_bytes = sum(t.numel() * t.element_size() for t in (q, k, v)) + q.numel() * q.element_size()
    n_ops = 4 * B * H * D * ops.valid_pairs(Sq, Sk, causal, window, q_offset)
    b, by = bound_ms(n_bytes, n_ops, _peak_for(torch, dts[0]))
    _time_line(f"K4 {label}: q ({B},{H},{Sq},{D}) {str(dts[0])[6:]}, k {str(dts[1])[6:]}, v "
               f"{str(dts[2])[6:]} ({B},{KV},{Sk},{D}), causal {causal}, window {window}, "
               f"q_offset {q_offset}, kernel {kernel_name}, {flash_attention.slices(D)} output "
               f"slices, max abs err {err:.3e} (tol {tol:g})",
               cuda_ms(torch, kernel, reps=10), graph_ms(torch, kernel, reps=10),
               cuda_ms(torch, plain, reps=3, trials=3), cuda_ms(torch, library, reps=10),
               f"sdpa ({str(lib_dt)[6:]})", b, by, card, tag)
    return err


def contract_phase(torch, dev, lm_data, card: str) -> dict:
    """Phase 23: the kernels' whole input contract. (a) fp16 serving on
    an e5m2 cache, (b) the fp16-param LM swarm, each with launch counts
    read from that run alone; (c) each kernel's newly admitted inputs
    against its plain version, timed."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    a = contract_serve(torch, dev)
    b = contract_swarm(torch, dev, lm_data)
    t_c = time.perf_counter()
    err = {"k1": max(b["k1_err"], contract_k1(torch, dev, b.pop("leaves"), card))}
    torch.cuda.empty_cache()
    contract_k2(torch, dev, card)
    gen = torch.Generator(device=dev).manual_seed(25)
    f16, bf16, f32 = torch.float16, torch.bfloat16, torch.float32
    e5m2 = torch.float8_e5m2
    k3_cases = [  # label, B, H, KV, S, D, (q, k, v types), pos, window
        ("D 80", 4, 32, 8, 4096, 80, (f16,) * 3, [4095, 3071, 2047, 1023], 0),
        ("D 96", 4, 32, 8, 2048, 96, (f16,) * 3, [2047, 1535, 1023, 511], 0),
        ("MQA G 64", 2, 64, 1, 8192, 128, (bf16,) * 3, [8191, 6143], 0),
        ("G 48 e5m2 window 1024", 4, 48, 1, 4096, 192, (f16, e5m2, e5m2),
         [4095, 3000, 2047, 1023], 1024),
        ("bf16 q on an fp16 cache", 4, 32, 8, 2048, 64, (bf16, f16, f16),
         [2047, 1535, 1023, 511], 0),
    ]
    err["k3"] = max(contract_k3_case(torch, dev, gen, *c, card) for c in k3_cases)
    contract_k3_graph(torch, dev, gen)
    B, H, KV, S, D = ATTN_SHAPE
    k4_cases = [  # label, B, H, KV, Sq, Sk, D, types, causal, window, q_offset
        ("fp16 granite prefill", B, H, KV, S, S, D, (f16,) * 3, True, 0, 0),
        ("bf16 D 96", 2, 16, 4, 2048, 2048, 96, (bf16,) * 3, True, 0, 0),
        ("bf16 D 256", 2, 16, 4, 2048, 2048, 256, (bf16,) * 3, True, 0, 0),
        ("q bf16, k and v fp16", B, H, KV, S, S, D, (bf16, f16, f16), True, 0, 0),
        ("fp32 D 80 ragged, q_offset 2000", 2, 16, 4, 1000, 3000, 80, (f32,) * 3, True, 0,
         2000),
    ]
    err["k4"] = max(contract_k4_case(torch, dev, gen, *c, card) for c in k4_cases)
    torch.cuda.empty_cache()
    out = {"a": a, "b": b, "err": err, "c_s": time.perf_counter() - t_c,
           "phase_s": time.perf_counter() - t0}
    log(f"[contract] phase 23 in {out['phase_s']:.1f} s ((c) {out['c_s']:.1f} s); max abs err "
        f"K1 {err['k1']:.3e}, K3 {err['k3']:.3e}, K4 {err['k4']:.3e}; K2 ids equal")
    return out


# ------------------------------------------------------------ phase 24


def complete_overflow(torch, dev, gen) -> None:
    """Constant V rows of ``OVERFLOW_V`` under an e4m3 and an e5m2 q, K3
    at D 64 and 320 and K4 at D 64 and 320: the output bytes equal the
    plain version's, NaN (e4m3) and inf (e5m2) where they are."""
    from repro_torch.kernels import flash_attention, flash_decode, ref
    for fp8 in (torch.float8_e4m3fn, torch.float8_e5m2):
        for D in (64, 320):
            vals = torch.tensor(OVERFLOW_V, device=dev).repeat(D // len(OVERFLOW_V) + 1)[:D]
            k = torch.randn((2, 2, 300, D), generator=gen, device=dev).to(torch.bfloat16)
            v = vals.expand(2, 2, 300, D).contiguous()
            q = torch.randn((2, 8, 1, D), generator=gen, device=dev).to(fp8)
            pos = torch.tensor([299, 40], dtype=torch.int32, device=dev)
            got = flash_decode.flash_decode(q, k, v, pos)
            plain = ref.decode_attention(q, k, v, pos)
            q4 = torch.randn((2, 8, 128, D), generator=gen, device=dev).to(fp8)
            got4 = flash_attention.flash_attention(q4, k, v, block_q=128, block_k=300)
            plain4 = ref.attention(q4, k, v)
            torch.cuda.synchronize()
            for name, a, b_ in (("K3", got, plain), ("K4", got4, plain4)):
                same = torch.equal(a.view(torch.uint8), b_.view(torch.uint8))
                n_nan = int(torch.isnan(a.float()).sum())
                n_inf = int(torch.isinf(a.float()).sum())
                log(f"[complete] {name} overflow rows, {str(fp8)[6:]} q, D {D}: bytes equal "
                    f"{same}; NaN {n_nan}, inf {n_inf} of {a.numel()}; row 0's first 8 bytes "
                    f"{a.view(torch.uint8).reshape(-1)[:8].tolist()}")
                assert same, f"{name} {fp8} D {D}: overflow bytes differ from the plain version"
                assert (n_nan if fp8 == torch.float8_e4m3fn else n_inf) > 0


def complete_k3_graph(torch, dev, gen) -> float:
    """Three replays of one captured D 512 call (the wide kernel) on new
    inputs, each against the plain version and against an eager call of
    the same inputs, bitwise: every (row, chunk, slice) merge counter is
    back at 0 after a launch. Returns the max abs err."""
    from repro_torch.kernels import flash_decode, ref
    B, H, KV, S, D = 4, 16, 4, 4096, 512
    q = torch.randn((B, H, 1, D), generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((B, S, KV, D), generator=gen, device=dev).to(torch.bfloat16)
            .transpose(1, 2) for _ in range(2))
    pos = torch.tensor([4095, 3000, 2047, 1023], dtype=torch.int32, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        flash_decode.flash_decode(q, k, v, pos)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = flash_decode.flash_decode(q, k, v, pos)
    err = 0.0
    for rep in range(3):
        q.copy_(torch.randn(q.shape, generator=gen, device=dev))
        v.copy_(torch.randn(v.shape, generator=gen, device=dev))
        pos.copy_(torch.randint(0, S, (B,), generator=gen, device=dev, dtype=torch.int32))
        graph.replay()
        eager = flash_decode.flash_decode(q, k, v, pos)
        expect = ref.decode_attention(q, k, v, pos).float()
        torch.cuda.synchronize()
        e = (out.float() - expect).abs().max().item()
        tol = HALF_RTOL * expect.abs().max().item()
        assert e <= tol, f"complete K3 D 512 graph replay {rep}: {e} > {tol}"
        assert torch.equal(out, eager), f"complete K3 D 512 graph replay {rep} differs from eager"
        err = max(err, e)
        log(f"[complete] K3 D 512 graph replay {rep} (pos {pos.tolist()}): equal to eager, max "
            f"abs err {e:.3e} (tol {tol:.3e})")
    return err


def table3_phase(torch, dev) -> dict:
    """Phase 24 (c): ``examples/paper_tables_torch.table3(full=True)`` on
    the card with K1 / K2 launch counts read from it alone, then one
    round each of alexnet-dr, vgg-dr and inception-dr card vs CPU (phase
    4's comparison; squeezenet-dr's is phase 4 itself)."""
    from repro_torch.configs import OptimizerConfig, SwarmConfig, get_config
    from repro_torch.core.swarm import SwarmTrainer
    from repro_torch.data.dr import make_dr_swarm_data, scale_table
    from repro_torch.models import build_model
    sys.path.insert(0, str(ROOT / "examples"))
    import paper_tables_torch as pt

    scale, rounds = pt.scale_and_rounds(True)
    _zero_coordinator_counts()
    t0 = time.perf_counter()
    res = pt.table3(full=True, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _coordinator_counts()
    want = {"param_stats_batched": 0, "kmeans_assign": 0, "kmeans_assign with k_active": 0}
    for r in res.values():
        for key, n in _grid_want(1, rounds, len(_leaves(r["run"].state.params))).items():
            want[key] += n
    want["kmeans_assign with k_active"] = 0
    log(f"[table3] {len(res)} archs x {rounds} rounds on the full Table I at {pt.IMAGE_SIZE} px "
        f"in {secs:.2f} s; launches {launches}, expected {want}")
    assert launches == want, f"Table III launch counts {launches} != {want}"
    for arch, r in res.items():
        assert math.isfinite(r["acc"]) and 0.0 <= r["acc"] <= 1.0, f"{arch} accuracy {r['acc']}"
        val = r["run"].metrics.mean_val_acc.tolist()
        log(f"[table3] {arch}: {r['seconds']:.3f} s, Eq. 3 test acc {r['acc']:.4f} (paper "
            f"{pt.PAPER_TABLE3[arch]:.4f}), {r['params']:,} params, val acc by round "
            f"{[round(a, 4) for a in val]}")
    clients = make_dr_swarm_data(image_size=pt.IMAGE_SIZE, seed=pt.SEED, table=scale_table(scale))
    diffs = {}
    for arch in ("alexnet-dr", "vgg-dr", "inception-dr"):
        swarm = SwarmConfig(n_clients=14, n_clusters=K, p1=0.9, p2=0.8, kmeans_iters=KMEANS_ITERS,
                            local_steps=pt.LOCAL_STEPS, rounds=1)
        tr = SwarmTrainer(build_model(get_config(arch)), clients, swarm,
                          OptimizerConfig(name="adam", lr=2e-3), seed=pt.SEED,
                          batch_size=pt.BATCH, device=dev)
        t1 = time.perf_counter()
        diff, m_card, m_cpu = card_vs_cpu(torch, tr, clients, local_steps=2, eps=1e-6)
        log(f"[card-vs-cpu table3] {arch}, 2 local steps, adam eps 1e-6: assignments "
            f"{m_card.assignments.tolist()} / {m_cpu.assignments.tolist()}, centers "
            f"{m_card.centers.tolist()} / {m_cpu.centers.tolist()}, max |param diff| {diff:.3e} "
            f"({time.perf_counter() - t1:.1f} s)")
        assert torch.equal(m_card.assignments.cpu(), m_cpu.assignments), f"{arch} assignments"
        assert torch.equal(m_card.centers.cpu(), m_cpu.centers), f"{arch} centers differ"
        # atol 1e-4, as phase 4
        assert diff <= 1e-4, f"card and CPU {arch} params differ by {diff}"
        diffs[arch] = diff
        del tr
    torch.cuda.empty_cache()
    return {"launches": launches, "seconds": secs, "results": res, "diffs": diffs}


def complete_phase(torch, dev, card: str) -> dict:
    """Phase 24: K3 and K4 at D above 256 and an fp8 q, the overflow
    rows, a captured wide call, then Table III on the card."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(27)
    f16, bf16 = torch.float16, torch.bfloat16
    e4, e5 = torch.float8_e4m3fn, torch.float8_e5m2
    g_pos = [2047, 1535, 1023, 511]
    k3_cases = [  # label, B, H, KV, S, D, (q, k, v types), pos, window
        ("D 320 ragged", 2, 8, 2, 1000, 320, (f16,) * 3, [999, 400], 0),
        ("D 512", 4, 16, 4, 4096, 512, (bf16,) * 3, [4095, 4095, 4095, 4095], 0),
        ("D 1024 window 512", 1, 8, 2, 2048, 1024, (bf16,) * 3, [2047], 512),
        ("e4m3 q on e4m3", 4, 32, 8, 2048, 64, (e4,) * 3, g_pos, 0),
        ("e4m3 q on e5m2", 4, 32, 8, 2048, 64, (e4, e5, e5), g_pos, 0),
        ("e4m3 q on bf16", 4, 32, 8, 2048, 64, (e4, bf16, bf16), g_pos, 0),
        ("e5m2 q on e4m3", 4, 32, 8, 2048, 64, (e5, e4, e4), g_pos, 0),
        ("e5m2 q on e5m2", 4, 32, 8, 2048, 64, (e5,) * 3, g_pos, 0),
        ("e5m2 q on bf16", 4, 32, 8, 2048, 64, (e5, bf16, bf16), g_pos, 0),
        ("kimi-k2 e4m3 q on bf16", 4, 64, 8, 2048, 112, (e4, bf16, bf16), g_pos, 0),
    ]
    err = {"k3": max(contract_k3_case(torch, dev, gen, *c, card, tag="complete")
                     for c in k3_cases)}
    complete_overflow(torch, dev, gen)
    err["k3"] = max(err["k3"], complete_k3_graph(torch, dev, gen))
    torch.cuda.empty_cache()
    k4_cases = [  # label, B, H, KV, Sq, Sk, D, types, causal, window, q_offset
        ("bf16 D 320", 1, 8, 2, 1024, 1024, 320, (bf16,) * 3, True, 0, 0),
        ("bf16 D 320 window 256", 1, 8, 2, 1024, 1024, 320, (bf16,) * 3, True, 256, 0),
        ("bf16 D 512", 1, 8, 2, 1024, 1024, 512, (bf16,) * 3, True, 0, 0),
        ("bf16 D 512 window 256", 1, 8, 2, 1024, 1024, 512, (bf16,) * 3, True, 256, 0),
        ("e4m3 q, k, v", 4, 32, 8, 2048, 2048, 64, (e4,) * 3, True, 0, 0),
        ("e5m2 q, k, v", 4, 32, 8, 2048, 2048, 64, (e5,) * 3, True, 0, 0),
    ]
    err["k4"] = max(contract_k4_case(torch, dev, gen, *c, card, tag="complete")
                    for c in k4_cases)
    torch.cuda.empty_cache()
    t_c = time.perf_counter()
    t3 = table3_phase(torch, dev)
    out = {"err": err, "table3": t3, "ab_s": t_c - t0,
           "c_s": time.perf_counter() - t_c, "phase_s": time.perf_counter() - t0}
    log(f"[complete] phase 24 in {out['phase_s']:.1f} s ((a)+(b) {out['ab_s']:.1f} s, (c) "
        f"{out['c_s']:.1f} s); max abs err K3 {err['k3']:.3e}, K4 {err['k4']:.3e} (fp8 outputs "
        f"held by bytes); Table III "
        f"{ {a: round(r['acc'], 4) for a, r in t3['results'].items()} } in "
        f"{t3['seconds']:.2f} s")
    return out


def _kernel_line(name, source, replaces, launches, err, times) -> dict:
    """One entry of the ``{"kernels": [...]}`` line; ``times`` is a
    timing function's (ms, plain_ms, library_ms, bound_ms, bound_by)."""
    ms, plain_ms, lib_ms, b, by = times
    return {"name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{source}.cu",
            "replaces": replaces, "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b, "bound_by": by, "library_ms": lib_ms}


def main() -> int:
    ap = argparse.ArgumentParser(description="Bring-up check of the PyTorch/CUDA port on one "
                                 "card; with no arguments, every phase.")
    ap.add_argument("--ssm-depth-probe", type=int, nargs="+", metavar="LAYERS",
                    help="only phase 18 (e)'s mamba2 round at each depth (ssm_depth_probe)")
    ap.add_argument("--only-phase", type=int, choices=(24,),
                    help="build the kernels (phase 1), then run only this phase; no result line")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository (src/repro_torch "
              "is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    if args.ssm_depth_probe:
        return ssm_depth_probe(torch, torch.device("cuda"), args.ssm_depth_probe)
    from repro_torch.core.diststats import swarm_distribution_matrix
    from repro_torch.data.dr import make_dr_swarm_data, scale_table
    from repro_torch.kernels import _build

    t_all = time.perf_counter()
    starts = {}  # phase -> its start on the host clock
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    # the plain versions and the comparisons run in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    starts[1] = time.perf_counter()
    # --- phase 1: build
    t0 = time.perf_counter()
    build_logs = _build.build()
    build_s = time.perf_counter() - t0
    for k in _build.KERNELS:
        lines = ptxas_report(_build.build_log(k))
        for line in lines:
            log(f"[build] {k}: {line}")
        if k in NO_SPILL_KERNELS:
            assert_no_spills(k, lines)
    sass_census(_build)
    card = card_line()
    log(f"[build] {len(build_logs)} kernel libraries built in {build_s:.2f} s on {name}")
    log(card)
    if args.only_phase == 24:
        complete_phase(torch, dev, card)
        log(f"[done] build and phase 24 alone in {time.perf_counter() - t_all:.1f} s")
        return 0

    starts[2] = time.perf_counter()
    # --- phase 2: kernels against their plain versions, at the path's shapes
    clients = make_dr_swarm_data(image_size=32, seed=0, table=scale_table(1))
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.utils.tree import tree_stack
    model = build_model(get_config("squeezenet-dr"))
    gen = torch.Generator(device=dev).manual_seed(0)
    stacked = tree_stack([model.init(gen) for _ in range(14)])
    leaves = [x.contiguous() for x in _leaves(stacked)]
    feats = swarm_distribution_matrix(stacked)                  # (14, 56), as on the path
    cents = feats[torch.randperm(14, generator=gen, device=dev)[:K]].contiguous()
    k1_err = check_param_stats(torch, dev, leaves)
    k1_err = max(k1_err, check_param_stats_buckets(torch, dev, clients))
    k2_err = check_kmeans_assign(torch, dev, feats, cents)
    grid_cents = check_kmeans_assign_k_active(torch, dev, feats)
    k1 = time_param_stats(torch, leaves)
    k2 = time_kmeans_assign(torch, feats, cents)
    time_kmeans_assign_k_active(torch, feats, grid_cents)
    log(f"[kernels] param_stats_batched, 28 leaves x 14 clients in one call: kernel "
        f"{k1[0]:.4f} ms, plain {k1[1]:.4f} ms, var_mean x 28 {k1[2]:.4f} ms, bound "
        f"{k1[3]:.6f} ms ({k1[4]})")
    log(f"[kernels] launch floor: a CUDA graph of one one-element fill replays in "
        f"{launch_floor_ms(torch, dev):.4f} ms")
    log(f"[kernels] swarm_distribution_matrix (the round's stats upload, through the "
        f"wrapper): {cuda_ms(torch, lambda: swarm_distribution_matrix(stacked)):.4f} ms a call")
    log(f"[kernels] kmeans_assign (14,56)x(3,56): kernel {k2[0]:.4f} ms, plain {k2[1]:.4f} ms, "
        f"cdist+argmin {k2[2]:.4f} ms, bound {k2[3]:.7f} ms ({k2[4]})")
    # the LM paths' shapes (phases 15 and 18 (e)): the fits' first uploads
    lm = lm_stacks(torch, dev)
    k1_lm_err, lm_feats = check_lm_coordinator(torch, dev, lm)
    k1_err = max(k1_err, k1_lm_err)
    X = lm_feats["100m"]
    k2_lm = time_kmeans_assign(torch, X, X[[0, 3]].contiguous())
    log(f"[kernels] kmeans_assign ({LM_CLIENTS},{X.shape[1]})x(2,{X.shape[1]}), the 100m fit's "
        f"shape: kernel {k2_lm[0]:.4f} ms, plain {k2_lm[1]:.4f} ms, cdist+argmin "
        f"{k2_lm[2]:.4f} ms, bound {k2_lm[3]:.7f} ms ({k2_lm[4]})")
    for lm_name, (_, lm_stack) in lm.items():
        time_lm_param_stats(torch, lm_name, [x.contiguous() for x in _leaves(lm_stack)])
    del lm, lm_stack
    torch.cuda.empty_cache()

    starts[3] = time.perf_counter()
    # --- phase 3: the main path, with launch counts from this run alone
    tr, launches, round_s = main_path(torch, clients, dev)

    profile_round(torch, tr)

    starts[4] = time.perf_counter()
    # --- phase 4: the same round on the card and on the CPU
    torch.backends.cudnn.deterministic = True
    diff, m_card, m_cpu = card_vs_cpu(torch, tr, clients, local_steps=2, eps=1e-6)
    log(f"[card-vs-cpu] 2 local steps, adam eps 1e-6: assignments "
        f"{m_card.assignments.tolist()} / {m_cpu.assignments.tolist()}, centers "
        f"{m_card.centers.tolist()} / {m_cpu.centers.tolist()}, max |param diff| {diff:.3e}, "
        f"max |val acc diff| {(m_card.val_acc.cpu() - m_cpu.val_acc).abs().max().item():.3e}")
    assert torch.equal(m_card.assignments.cpu(), m_cpu.assignments), "assignments differ"
    assert torch.equal(m_card.centers.cpu(), m_cpu.centers), "centers differ"
    # atol 1e-4: 5% of one adam step at lr 2e-3 (cuDNN and the CPU sum
    # the convolutions in other orders)
    assert diff <= 1e-4, f"card and CPU params differ by {diff}"
    diff12, _, _ = card_vs_cpu(torch, tr, clients, local_steps=LOCAL_STEPS, eps=1e-8)
    log(f"[card-vs-cpu] main-path config (12 local steps, adam eps 1e-8), not asserted: "
        f"max |param diff| {diff12:.3e}")

    starts[5] = time.perf_counter()
    # --- phase 5: flash_decode against its plain version, at the serve shapes
    k3_err = check_flash_decode(torch, dev)
    k3 = time_flash_decode(torch, dev)
    for H, D, cache, label in ((32, 64, torch.float8_e4m3fn, "granite"),
                               (64, 112, torch.bfloat16, "kimi-k2"),
                               (64, 112, torch.float8_e4m3fn, "kimi-k2")):
        time_flash_decode(torch, dev, H, D, cache, label)

    starts[6] = time.perf_counter()
    # --- phase 6: the serve path at full width, launch counts from the drain alone
    k3_launches, _, _ = serve_path(torch, dev)
    torch.cuda.empty_cache()

    starts[7] = time.perf_counter()
    # --- phase 7: the same serve on the card and on the CPU
    same, diff, _ = card_vs_cpu_serve(torch, dev, "float32")
    assert same, "card and CPU generate different tokens in fp32"
    # 1e-3: logits are O(1) here; fp32 sums of 2,048-8,192 products taken
    # in other orders (cuBLAS vs the CPU's BLAS, the kernel's split softmax
    # vs one pass) differ by ~1e-6 relative, and a wrong mask, position or
    # layout moves logits by O(0.1)
    assert diff <= 1e-3, f"card and CPU logits differ by {diff}"
    same16, diff16, _ = card_vs_cpu_serve(torch, dev, "bfloat16")
    log(f"[card-vs-cpu serve] bf16, not asserted: tokens equal {same16}, "
        f"max |logit diff| {diff16:.3e}")
    # fp16 (phase 23's serving type): tokens asserted equal; its e5m2
    # cache's logits against its fp16 cache's within the reference's 0.2.
    # No logit comparison: on the card's host the CPU's fp16 matmuls run
    # at ~0.6 GFLOP/s (206 s for generate and the logits loop at 64 wide)
    same_h, _, _, rel_e5m2 = card_vs_cpu_serve(torch, dev, CONTRACT_DTYPE, CONTRACT_CACHE,
                                               logits=False)
    assert same_h, "card and CPU generate different tokens in fp16"
    assert rel_e5m2 < MOE_FP8_RTOL, f"e5m2 cache logits {rel_e5m2} off the fp16 cache's"

    starts[8] = time.perf_counter()
    # --- phase 8: flash_attention against its plain version, at granite's prefill shape
    k4_err = check_flash_attention(torch, dev)
    k4 = time_flash_attention(torch, dev)
    log(f"[kernels] flash_attention (4,32,2048,64) vs (4,8,2048,64) bf16 causal: kernel "
        f"{k4[0]:.4f} ms, plain {k4[1]:.4f} ms, sdpa {k4[2]:.4f} ms, bound {k4[3]:.5f} ms "
        f"({k4[4]})")
    torch.cuda.empty_cache()

    starts[9] = time.perf_counter()
    # --- phase 9: flash_attention on its path, launch count from this phase alone
    k4_launches, attn_diff, attn_scale = attention_path(torch, dev)
    assert k4_launches == ATTN_LAUNCHES_PER_LAYER, f"flash_attention launches {k4_launches}"
    # bf16: attend_full rounds its scores and probabilities to bf16
    # (relative 2^-8 each), the kernel keeps them in fp32; a wrong mask,
    # position, head mapping or layout moves the output by its own scale
    assert attn_diff <= ATTN_PATH_RTOL * attn_scale, \
        f"kernel composition and attend_full differ by {attn_diff} (max |out| {attn_scale})"
    torch.cuda.empty_cache()

    starts[10] = time.perf_counter()
    # --- phase 10: Table II on the card, launch counts from the sweep alone
    t2_launches, accs, serial_acc, sweep_s, serial_s = table2(torch, dev)

    starts[11] = time.perf_counter()
    # --- phase 11: the grid axis, launch counts from the ablation alone
    g_launches, g_results, g_states, grid_s, sched_s, g_clients, g_data = grid_path(torch, dev)
    gdiff, gm_card, gm_cpu, g_k2 = card_vs_cpu_grid(torch, g_states[1], g_clients, g_data)
    log(f"[card-vs-cpu grid] k 2 of pad {GRID_K_MAX}, lr 1e-3, 2 of 3 local steps, adam eps "
        f"1e-6: assignments {gm_card.assignments.tolist()} / {gm_cpu.assignments.tolist()}, "
        f"centers {gm_card.centers.tolist()} / {gm_cpu.centers.tolist()}, max |param diff| "
        f"{gdiff:.3e}, max |val acc diff| "
        f"{(gm_card.val_acc.cpu() - gm_cpu.val_acc).abs().max().item():.3e}; {g_k2} k_active "
        f"launches on the card")
    assert g_k2 == KMEANS_ITERS + 1, f"the card's grid round made {g_k2} k_active launches"
    assert torch.equal(gm_card.assignments.cpu(), gm_cpu.assignments), "grid assignments differ"
    assert torch.equal(gm_card.centers.cpu(), gm_cpu.centers), "grid centers differ"
    assert int(gm_card.assignments.max()) < 2, "a client in a pad cluster"
    # atol 1e-4, as phase 4
    assert gdiff <= 1e-4, f"card and CPU grid params differ by {gdiff}"

    starts[12] = time.perf_counter()
    # --- phase 12: the churn axis, launch counts from the sweep alone
    c_launches, c_results, c_states, c_specs, churn_s, c_clients, c_data = churn_path(torch, dev)
    c_row = c_specs.index({"dropout": 0.4, "stale_decay": 0.5})
    cdiff, cm_card, cm_cpu, cs_card, cs_cpu, frozen = card_vs_cpu_churn(
        torch, c_states[c_row], c_clients, c_data)
    log(f"[card-vs-cpu churn] dropout 0.4, stale decay 0.5, 2 local steps, adam eps 1e-6: present "
        f"{cm_card.present.int().tolist()} / {cm_cpu.present.int().tolist()}, staleness "
        f"{cs_card.staleness.tolist()} / {cs_cpu.staleness.tolist()}, assignments "
        f"{cm_card.assignments.tolist()} / {cm_cpu.assignments.tolist()}, centers "
        f"{cm_card.centers.tolist()} / {cm_cpu.centers.tolist()}, max |param diff| {cdiff:.3e}, "
        f"absent clients unchanged on the card: {frozen}")
    assert 0 < int(cm_cpu.present.sum()) < len(c_clients), "the churn round drops no client or all"
    assert torch.equal(cm_card.present.cpu(), cm_cpu.present), "churn presence differs"
    assert torch.equal(cs_card.staleness.cpu(), cs_cpu.staleness), "churn staleness differs"
    assert torch.equal(cm_card.assignments.cpu(), cm_cpu.assignments), "churn assignments differ"
    assert torch.equal(cm_card.centers.cpu(), cm_cpu.centers), "churn centers differ"
    assert frozen, "an absent client's params or optimizer state moved on the card"
    # atol 1e-4, as phase 4
    assert cdiff <= 1e-4, f"card and CPU churn params differ by {cdiff}"

    starts[13] = time.perf_counter()
    # --- phase 13: the bucketed layout on the main path's data
    b_launches, b_secs, b_pads, b_diff = bucket_path(torch, dev, clients)

    starts[14] = time.perf_counter()
    # --- phase 14: the two-tier coordinator, launch counts from the 4-pod fit alone
    t14 = [time.perf_counter()]
    h_launches, h_secs, h_state, h_cfg, h_data = hier_fit(torch, dev, clients)
    t14.append(time.perf_counter())
    hdiff, hm_card, hm_cpu, hs_card, hs_cpu, h_frozen = card_vs_cpu_hier(
        torch, h_state, clients, h_data, h_cfg)
    log(f"[card-vs-cpu hier] 4 pods, dropout 0.4, stale decay 0.5, 2 local steps, adam eps 1e-6: "
        f"present {hm_card.present.int().tolist()} / {hm_cpu.present.int().tolist()}, staleness "
        f"{hs_card.staleness.tolist()} / {hs_cpu.staleness.tolist()}, assignments "
        f"{hm_card.assignments.tolist()} / {hm_cpu.assignments.tolist()}, centers "
        f"{hm_card.centers.tolist()} / {hm_cpu.centers.tolist()}, max |param diff| {hdiff:.3e}, "
        f"absent clients unchanged on the card: {h_frozen}")
    assert 0 < int(hm_cpu.present.sum()) < len(clients), "the hier round drops no client or all"
    assert torch.equal(hm_card.present.cpu(), hm_cpu.present), "hier presence differs"
    assert torch.equal(hs_card.staleness.cpu(), hs_cpu.staleness), "hier staleness differs"
    assert torch.equal(hm_card.assignments.cpu(), hm_cpu.assignments), "hier assignments differ"
    assert torch.equal(hm_card.centers.cpu(), hm_cpu.centers), "hier centers differ"
    assert h_frozen, "an absent client's params or optimizer state moved on the card"
    # atol 1e-4, as phase 4
    assert hdiff <= 1e-4, f"card and CPU hier params differ by {hdiff}"
    t14.append(time.perf_counter())
    h_accs = hier_anchor(torch, dev)
    t14.append(time.perf_counter())
    h_scaling_k2, h_walls = hier_scaling(torch, dev)
    t14.append(time.perf_counter())
    log(f"[hier] phase 14 in {t14[-1] - t14[0]:.1f} s: fits {t14[1] - t14[0]:.1f} s, card vs "
        f"CPU round {t14[2] - t14[1]:.1f} s, anchor {t14[3] - t14[2]:.1f} s, scaling axis "
        f"{t14[4] - t14[3]:.1f} s")
    h_launches = {**h_launches, "kmeans_assign": h_launches["kmeans_assign"] + h_scaling_k2}
    torch.cuda.empty_cache()

    starts[15] = time.perf_counter()
    # --- phase 15: the swarm over an LM, launch counts from each fit alone
    from repro_torch.data.tokens import make_token_swarm_data
    t15 = time.perf_counter()
    lm_cfg = _lm_config()
    assert LM_DATA_VOCAB <= min(lm_cfg.vocab_size, _preset_config().vocab_size)
    log(f"reduced: n_layers {get_config(LM_ARCH).n_layers} → {LM_LAYERS}")
    log(f"reduced: token data vocab {lm_cfg.vocab_size} → {LM_DATA_VOCAB} (the model keeps its "
        f"{lm_cfg.vocab_size}-row embedding and read-out)")
    lm_data = lm_clients(LM_DATA_VOCAB)
    tr_a, la, la_secs, la_peak = lm_fit(torch, dev, lm_cfg, lm_data, LM_ROUNDS, "a")
    profile_round(torch, tr_a)
    tr_b, lb, lb_secs, lb_peak = lm_fit(torch, dev, _preset_config(), lm_data, LM_PRESET_ROUNDS,
                                        "b")
    del tr_b
    torch.cuda.empty_cache()
    smoke_cfg = get_config(LM_ARCH).smoke()
    smoke_data = make_token_swarm_data(LM_CLIENTS, smoke_cfg.vocab_size, n_seqs=LM_SEQS,
                                       seq_len=LM_SEQ_LEN)
    ldiff, lm_card, lm_cpu = card_vs_cpu(torch, lm_trainer(dev, smoke_cfg, smoke_data, 1),
                                         smoke_data, local_steps=2, eps=1e-6, batch=LM_BATCH,
                                         k=LM_CLUSTERS)
    log(f"[card-vs-cpu lm] {smoke_cfg.arch_id}, 2 local steps, adam eps 1e-6: assignments "
        f"{lm_card.assignments.tolist()} / {lm_cpu.assignments.tolist()}, centers "
        f"{lm_card.centers.tolist()} / {lm_cpu.centers.tolist()}, max |param diff| {ldiff:.3e}, "
        f"max |val acc diff| {(lm_card.val_acc.cpu() - lm_cpu.val_acc).abs().max().item():.3e}")
    assert torch.equal(lm_card.assignments.cpu(), lm_cpu.assignments), "LM assignments differ"
    assert torch.equal(lm_card.centers.cpu(), lm_cpu.centers), "LM centers differ"
    # atol 1e-4, as phase 4
    assert ldiff <= 1e-4, f"card and CPU LM params differ by {ldiff}"
    t16 = time.perf_counter()

    starts[16] = time.perf_counter()
    # --- phase 16: train -> checkpoint -> serve, K3 launches from the drain alone
    k3_lm, ck = lm_checkpoint_serve(torch, dev, tr_a, lm_data)
    del tr_a
    torch.cuda.empty_cache()
    ces, train_wall, train_tok_s, train_step_s = train_single_path(torch)
    log(f"[lm] phase 15 in {t16 - t15:.1f} s, phase 16 in {time.perf_counter() - t16:.1f} s")
    torch.cuda.empty_cache()

    starts[17] = time.perf_counter()
    # --- phase 17: the moe family served, K3 launches from each drain alone
    t17 = time.perf_counter()
    k3_moe, moe_info = moe_serve_path(torch, dev)
    torch.cuda.empty_cache()
    k3_moe += moe_smoke_serve(torch, dev)
    log(f"[moe] phase 17 in {time.perf_counter() - t17:.1f} s")
    torch.cuda.empty_cache()

    starts[18] = time.perf_counter()
    # --- phase 18: the ssm and hybrid families served and trained, launch
    # counts from each run alone
    assert get_config(HYBRID_ARCH).sliding_window == SSM_WINDOW
    ssm = ssm_phase(torch, dev, lm_data, card)

    starts[19] = time.perf_counter()
    # --- phase 19: the encdec and vlm families served and trained, K3
    # launches from each run alone
    assert get_config(ENCDEC_ARCH).encoder_seq == ENCDEC_CROSS_SEQ
    ev = encdec_vlm_phase(torch, dev, card)
    torch.cuda.empty_cache()

    starts[20] = time.perf_counter()
    # --- phase 20: the fleet regime over one NCCL rank, launch counts from
    # each run alone
    fl = fleet_phase(torch, dev, clients, round_s)

    starts[21] = time.perf_counter()
    # --- phase 21: the production dry-run's one-card probe, K3 launches
    # from its decode probes alone
    torch.cuda.empty_cache()
    dr = dryrun_phase(torch, dev, card)

    starts[22] = time.perf_counter()
    # --- phase 22: the LM fleet placed by the table, launch counts from
    # its coordinated rounds alone
    torch.cuda.empty_cache()
    pf = placed_fleet_phase(torch, dev, lm_data, card)

    starts[23] = time.perf_counter()
    # --- phase 23: the kernels' whole input contract, launch counts from
    # its serve and swarm runs alone
    ct = contract_phase(torch, dev, lm_data, card)

    starts[24] = time.perf_counter()
    # --- phase 24: the port complete (K3 and K4 at any D and an fp8 q;
    # Table III), K1 and K2 launch counts from Table III alone
    cp = complete_phase(torch, dev, card)
    ends = [*list(starts.values())[1:], time.perf_counter()]
    phase_s = {n: round(e - t, 1) for (n, t), e in zip(starts.items(), ends)}
    log(f"[phases] seconds each: {phase_s}")

    kernels = [
        _kernel_line("param_stats_batched", "param_stats", "src/repro/kernels/param_stats.py:92",
                     sum(n["param_stats_batched"]
                         for n in (launches, g_launches, c_launches, b_launches, h_launches,
                                   la, lb, ssm["launches"], fl["launches"], pf["launches"],
                                   ct["b"]["launches"], cp["table3"]["launches"])),
                     max(k1_err, fl["k1_err"], ct["err"]["k1"]), k1),
        _kernel_line("kmeans_assign", "kmeans_assign", "src/repro/kernels/kmeans_assign.py:44",
                     sum(n["kmeans_assign"]
                         for n in (launches, g_launches, c_launches, b_launches, h_launches,
                                   la, lb, ssm["launches"], fl["launches"], pf["launches"],
                                   ct["b"]["launches"], cp["table3"]["launches"])),
                     k2_err, k2),
        _kernel_line("flash_decode", "flash_decode", "src/repro/kernels/flash_decode.py:93",
                     k3_launches + k3_lm + k3_moe + ssm["k3"] + ev["k3"] + dr["k3"]
                     + ct["a"]["k3"],
                     max(k3_err, ssm["k3_err"], ev["k3_err"], ct["err"]["k3"], cp["err"]["k3"],
                         *(r["err"] for r in dr["k3_probe"].values())), k3),
        _kernel_line("flash_attention", "flash_attention",
                     "src/repro/kernels/flash_attention.py:89", k4_launches,
                     max(k4_err, ct["err"]["k4"], cp["err"]["k4"]), k4),
    ]
    log(f"[done] {time.perf_counter() - t_all:.1f} s in all; "
        f"round seconds {round_s}; Table II sweep {sweep_s:.3f} s, serial bso-sl "
        f"{serial_s:.3f} s; sweep launches {t2_launches}; accuracies {accs}, serial bso-sl "
        f"{serial_acc:.4f}; grid ablation {grid_s:.3f} s, scheduled grid {sched_s:.3f} s, grid "
        f"launches {g_launches}, grid accuracies "
        f"{ {name: round(r['acc'], 4) for (name, _), r in zip(GRID_CASES, g_results)} }; "
        f"churn sweep {churn_s:.3f} s, churn launches {c_launches}, churn accuracies "
        f"{[round(r['acc'], 4) for r in c_results]}; bucketed-layout round seconds {b_secs}, "
        f"pad shares {{'rect': {b_pads['rect']['train']:.4f}, 'bucketed': "
        f"{b_pads['bucketed']['train']:.4f}}}, layouts' max |param diff| {b_diff:.3e}, phase-13 "
        f"launches {b_launches}; two-tier round seconds {h_secs}, anchor final val acc {h_accs}, "
        f"pod-tier walls (first, steady) {h_walls}, phase-14 launches {h_launches}; LM swarm "
        f"round seconds (a) {la_secs}, (b) {lb_secs}, peak device memory (a) "
        f"{la_peak / 1e9:.2f} GB, (b) {lb_peak / 1e9:.2f} GB, phase-15 launches (a) {la}, (b) "
        f"{lb}; checkpoint {ck['size'] / 1e9:.3f} GB, saved in {ck['save_s']:.2f} s, restored in "
        f"{ck['load_s']:.2f} s; single-model train ce {ces[0]:.4f} -> {ces[-1]:.4f}, "
        f"{train_tok_s:,.0f} tok/s end to end, {train_step_s * 1e3:.1f} ms a step alone; "
        f"kimi-k2 served (phase 17): {moe_info['tok_s']:.2f} tok/s, TTFT p50 "
        f"{moe_info['ttft_p50_ms']:.1f} ms, {moe_info['tick_ms']:.2f} ms a decode call reading "
        f"{moe_info['tick_gb']:.2f} GB, busy {moe_info['busy']:.1%} of a profiled tick, peak "
        f"{moe_info['peak_gb']:.2f} GB (init {moe_info['init_peak_gb']:.2f} GB), fp8 vs bf16 "
        f"cache {moe_info['fp8_rel']:.4f}; mamba2-370m served (phase 18): "
        f"{ssm['mamba']['tok_s']:.2f} tok/s, {ssm['mamba']['step_ms']:.2f} ms a decode step, peak "
        f"{ssm['mamba']['peak_gb']:.2f} GB; zamba2-1.2b: {ssm['zamba']['tok_s']:.2f} tok/s, "
        f"{ssm['zamba']['step_ms']:.2f} ms a decode step, peak {ssm['zamba']['peak_gb']:.2f} GB, "
        f"K3 {ssm['zamba']['k3_ms'] / max(ssm['zamba']['busy_ms'], 1e-9):.2%} of a profiled "
        f"step's busy time; K3 at (4,32,1,64) vs (4,S,32,64) bf16 through the wrapper "
        f"{({S: round(t[0], 4) for S, t in ssm['k3_times'].items()})} ms; mamba2 swarm "
        f"({SSM_SWARM_LAYERS} layers) round seconds {ssm['round_s']}, peak "
        f"{ssm['peak_gb']:.2f} GB, launches {ssm['launches']}; whisper-base served (phase 19): "
        f"{ev['whisper']['tok_s']:.2f} tok/s, {ev['whisper']['step_ms']:.2f} ms a decode step, "
        f"peak {ev['whisper']['peak_gb']:.2f} GB; internvl2-26b at {VLM_SERVE_LAYERS} layers: "
        f"{ev['internvl']['tok_s']:.2f} tok/s, {ev['internvl']['step_ms']:.2f} ms a decode step, "
        f"peak {ev['internvl']['peak_gb']:.2f} GB; K3 at phase 19's shapes through the wrapper "
        f"{({k: round(t[0], 4) for k, t in ev['k3_times'].items()})} ms; training seconds a "
        f"step: whisper adamw {[round(x, 4) for x in ev['train']['whisper']['step_s']]}, "
        f"adafactor {[round(x, 4) for x in ev['train']['adafactor']['step_s']]}, internvl "
        f"({VLM_TRAIN_LAYERS} layers) {[round(x, 4) for x in ev['train']['internvl']['step_s']]}, "
        f"peaks {ev['train']['whisper']['peak_gb']:.2f} / "
        f"{ev['train']['internvl']['peak_gb']:.2f} GB; fleet (phase 20): round walls "
        f"{[round(x, 4) for x in fl['walls']]} s, coordinator {[round(x, 4) for x in fl['coord']]} "
        f"s, busy {fl['busy']:.1%} of a profiled round step, NCCL {fl['nccl_share']:.2%} of busy, "
        f"Eq. 2 {fl['eq2']} B a round, card vs CPU {fl['card_cpu_diff']:.3e}, checkpoint "
        f"{fl['ckpt_bytes']} B; dry-run probe (phase 21, {dr['seconds']:.1f} s): train_4k "
        f"depth-2 peaks remat full / none {dr['peaks'][0] / 1e9:.2f} / "
        f"{dr['peaks'][1] / 1e9:.2f} GB, K3 at the decode probes "
        f"{ {k: round(r['times'][0], 4) for k, r in dr['k3_probe'].items()} } ms; "
        f"placed fleet (phase 22, {pf['phase_s']:.1f} s): round steps {[round(x, 4) for x in pf['secs']]} s, peak "
        f"{pf['peak'] / 1e9:.2f} GB, busy {pf['busy']:.1%} of a profiled round step, auto vs "
        f"shard_map {pf['diff_adam']:.3e} under adam, {pf['diff_sgd']:.3e} under sgd; fp16 "
        f"serving card vs CPU (phase 7): tokens equal {same_h}, e5m2 vs fp16 cache "
        f"{rel_e5m2:.4f}; contract (phase 23, {ct['phase_s']:.1f} s): fp16 on "
        f"e5m2 served {ct['a']['tok_s']:.2f} tok/s, {ct['a']['tick_ms']:.2f} ms a tick, TTFT p50 "
        f"{ct['a']['ttft_p50_ms']:.1f} ms; fp16-param LM swarm round seconds "
        f"{[round(x, 4) for x in ct['b']['secs']]}, peak {ct['b']['peak'] / 1e9:.2f} GB; K1 and "
        f"K2 launches in the kernels "
        f"line: phases 3, 11, 12, 13, 14 (its 4-pod fit and scaling axis), 15, 18, 20 (the fleet's "
        f"runs (a)-(c)), 22 (a), 23 (b) and 24 (c); K3: phases "
        f"6, 16, 17, 18, 19, 21 and 23 (a); K3's max_abs_err over phases 5, 18, 19, 21, 23 and "
        f"24, K1's over 23, K4's over 23 and 24 (fp8 outputs held by bytes, not in the error); "
        f"complete (phase 24, {cp['phase_s']:.1f} s): Table III "
        f"{ {a: (round(r['acc'], 4), round(r['seconds'], 3)) for a, r in cp['table3']['results'].items()} } "
        f"(acc, s), card vs CPU {cp['table3']['diffs']}")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
