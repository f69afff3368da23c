#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Phases; any failure exits non-zero and no result line is printed:

1. header: the card's name and power limit, as ``nvidia-smi`` reports them;
2. build: compile the CUDA kernels from ``src/repro_torch/csrc`` with
   ``nvcc`` for ``sm_90a`` (one process per source, started together);
3. kernels vs plain versions: K1 ``pairwise_stats`` and K2
   ``fused_select`` at n = 11 on d in {1, 4095, 100003, 1000000}, on the
   qwen2-1.5b embedding leaf (11, 233373696), on the qwen3-moe-30b-a3b
   embedding leaf (11, 311164928: 3.42e9 elements, the largest leaf any
   phase launches them on) and on one stack carrying the ``inf``
   attack.  Tolerances: K1 distances and norms within
   1e-5 x max(1, max |plain|) on finite entries, with non-finite entries
   (NaN, inf) at the same places; K2 within 1e-6 x max(1, max |plain|).
   The multi-Bulyan plan built from the kernel's distances must equal the
   plan built from the plain distances bit for bit.  K2's theta sweep at
   n = 11: every theta from 1 to 10 with beta in {1, ceil(theta / 2),
   theta}, on one-hot / uniform synthetic plans with ties, over the same
   widths, bit for bit its plain version, each launch on the kernel
   compiled for its theta.
   K5 ``dequant_stats`` on int8 and bf16 payloads at n in {1, 3, 11, 13,
   37, 150} x d in {1, 4095, 100003, 4096, 100004, 2^20} (odd widths load
   element by element, multiples of 4 in packed words), on a payload one
   element into a larger buffer (not 4-byte aligned), on the embedding
   leaf, and on QSGD and bf16 wires forged by ``scale_poison`` (negative
   multipliers):
   within K1's tolerance of its plain version (distances against
   max(1, max |plain|, 2 max norm): a raw distance is formed as
   sq_i + sq_j - 2 g_ij), equal bit for bit to K1 on the decoded stack,
   and the same multi-Bulyan plan from its distances as from the plain
   ones (where n >= 3 makes one);
4. training: ``repro_torch.launch.train`` through its entry point at
   qwen2-1.5b's full width (d_model 1536, 12/2 heads, d_ff 8960, vocab
   151936) cut to 2 layers: 11 workers, f = 2, multi_bulyan, the ``inf``
   attack, SGD with momentum, seq 128, 2 sequences a worker, 3 steps,
   kernels on.  Every loss must be finite, the byzantine selection mass 0
   at every step, and K1 and K2 must each launch once per gradient leaf
   per step, K5 and K3 never, every K2 launch on the kernel compiled for
   theta = 5 (as in phases 5, 6 and 10);
   Then mesh training: the same flags with ``--mesh host``, in the
   one-rank NCCL world (1x1) that the launcher starts and destroys: K6
   (the mesh statistics, every launch on the symmetric grid) and K2 (the
   mesh apply on the rank's column tile, the gathered stack itself) once
   per leaf per step, K1 never; the mesh line printed, no process group
   left up, and every step's loss, per-worker losses, selection and
   byzantine mass and the parameters after the last step bit for bit the
   training phase's.
   Then the streaming trainer (``--trainer stream_global|stream_block``,
   one parameter block's gradient stack at a time): streaming global at
   the training configuration, K1 and K2 once per leaf per step and
   nothing else, bit for bit the training phase (as above), its peak
   device memory at least 2 GiB below the training phase's (the groups
   block's stack it never holds beside the embedding's); streaming mesh,
   the same flags with ``--mesh host`` (K6, all on the symmetric grid,
   and K2, K1 never), bit for bit streaming global; streaming block, K1
   and K2 once per leaf per step, byzantine mass 0; and streaming global
   at 8 layers for 2 steps (K1 and K2 once per leaf per step, finite
   losses, byzantine mass 0; the peak, the largest block's stack and the
   whole stack the stacked trainer would hold logged, not gated);
5. wire training A: the same configuration with ``--codec qsgd:bits=8
   --attack scale_poison``: finite losses, byzantine mass 0 at each step,
   the printed wire line at one byte a coordinate plus 4 a leaf, and K5
   and K2 once per leaf per step, K1 and K3 never;
6. wire training B: ``--codec signsgd:ef=1 --attack payload_flip`` for 2
   steps at 1 layer: finite losses, a finite non-zero error-feedback
   residual after each step, K5 and K2 once per leaf per step, K1 and K3
   never.  Then mesh wire: wire A's flags at 1 layer for 2 steps,
   replicated (K5 and K2 once per leaf per step), then with ``--mesh
   host`` (K7 on the symmetric grid and K2, K5 never), bit for bit alike,
   and on the streaming trainer (``--trainer stream_global``: K5 and K2
   once per leaf per step, K1 never), bit for bit the replicated run;
7. K5 on a real wire-A container (one batch's gradients, QSGD-encoded,
   forged by ``scale_poison``): every leaf checked as in phase 3, and no
   plan mass on the forged rows;
8. K3 ``coord_select`` against its plain version, bit for bit: (theta,
   beta) in {(5,1), (8,2), (16,4), (30,10), (7,7), (32,1)} x d in {1,
   4095, 100003, 1000000}, the embedding leaf at theta = 16 (theta x d >
   2^31), all-ties cases, and beta = theta (also within 1e-6 of the mean);
9. the two-step apply substrate on one batch's real gradients (training
   configuration, ``inf`` attack), ``fused=False`` and ``fused=False,
   coord_chunk=2**24``: K3 once per leaf or per column slice, K2 never,
   every K3 launch bit for bit equal to its plain version on the g_ext /
   g_agr the substrate formed; against the fused apply (K2) every
   coordinate more than 1e-6 x max(1, |fused|) apart must be a near-tie
   (recomputed in float64: the beta-th and (beta+1)-th smallest distances
   to the median, or two neighbouring middle extracted values, within
   1e-5 of each other relative to the values they come from), and their
   number is printed;
10. training with transforms: ``make_train_step(transforms=
   (WorkerMomentum(0.9), NearestNeighborMix(3)))`` at the training
   configuration with the ``inf`` attack, 3 steps: finite losses, finite
   honest momentum rows, the byzantine mass printed (not gated), and per
   step K1 2 x 14 times, K2 14 times, K3 and K5 never;
   After it, the phases of the rest of the single-device trainer, each
   with K1 and K2 once per leaf per step on the theta = 5 kernel and no
   other kernel: adaptive A, ``--attack adaptive_lie`` at the training
   configuration (z after each step recomputed on the host in fp32 from
   the step's recorded selection, exactly); adaptive B, ``--attack
   adaptive_mimic`` for 2 steps at 1 layer (trust within 1e-6 of its EMA
   recomputed from the selection; the copied row logged); the checkpoint:
   adaptive A at 1 layer, 2 steps, ``save`` and ``restore`` onto the card
   (every leaf, ``opt.step`` and ``astate`` bit for bit; the file's bytes
   and the seconds printed beside the card), then step 3 from the
   restored and from the in-memory state (the same losses and selection,
   the parameters within 1e-6 relative); and ``examples/
   quickstart_torch.py`` (multi-Bulyan's cosine above 0.9, 8 finite
   losses).  The byzantine mass of the adaptive attacks is logged, not
   gated: they are built to be selected;
11. timing at the main path's leaf shapes (one launch per leaf, summed over
   the leaves of one step; median of repeats, CUDA events), K5 on int8
   and bf16 payloads beside decode + K1, each payload also checked as in
   phase 3; K3 at theta = 5 on the products of the synthetic stack and
   its plan (checked bit for bit), its plain version, the two products
   and the whole two-step apply beside K2; K2 over the timed leaves for
   every (theta, beta) of the sweep of phase 3, each leaf bit for bit its
   plain version;
12. profile: one more steady-state step of the uncompressed configuration,
   one of wire A and one of adaptive A under ``torch.profiler``: device-busy share and the
   kernels that take the most device time; and (in phase 11) one
   two-step apply over the timed leaves;
13. the ``kernels`` JSON line, then the last line:
   ``{"ok": true, "device": {...}}``.

The mesh-native statistics and apply (after phase 3, 10 and 11 in that
order):

* K6 ``pairwise_stats_rect``, K7 ``dequant_stats_rect`` and K4
  ``pairwise_sqdist`` against the square kernels and their plain
  versions: K6 on every row block of W in {1, 2, 4, 8} rank meshes for n
  in {11, 12, 13, 23, 37} x d in CHECK_WIDTHS, on the ``inf``-attack
  stack, and on the embedding leaf at rank 1 of 4; each block (a view of
  the zero-padded stack: the view path where that stack has at most 16
  rows) and a copy of it (the rectangular grid without the view path)
  bit for bit K1's matching rows and each other, NaN and inf in place,
  and within K1's tolerance of its plain version.  K7 the same on
  int8 and bf16 payloads (n in {11, 13, 37} x d in K5's widths, the
  embedding leaf, QSGD and bf16 wires forged by ``scale_poison``) against
  K5's rows; a mixed-type call must raise.  K4 on fp32 and bf16 stacks
  bit for bit ``finalize_dists`` of K1 (on ``x.float()``), every finite
  row's diagonal exactly 0;
* the mesh statistics of one batch's real gradients (the training
  configuration, ``inf`` attack) in a one-rank NCCL world
  (``make_host_mesh()``, 1x1): ``compute_stats(row_block(...),
  mesh_ctx=, use_kernels=True)`` on the tree, a QSGD int8 and a bf16
  wire forged by ``scale_poison``, each bit for bit the replicated kernel
  path with identical multi-Bulyan, multi-Krum and Krum plans and no
  byzantine mass; launches exactly K6 (tree) or K7 (wires) once per leaf
  and nothing else, each on the square kernel's symmetric grid, since a
  one-rank block is the stack itself.  Then, in one process, the 4 row
  blocks of a 4-rank mesh (3 of 12 rows) through K6 leaf by leaf, and
  through K7 on the int8 wire, each launch on the rectangular grid (every
  K6 launch on its view path), assembled: bit for bit the replicated raw
  (n, n) and norms;
* the mesh apply's tiles: one batch's real gradients (``inf``) and their
  plan, every rank of a 2x2 and a 4x1 mesh emulated in one process: each
  rank's K2 launch on the (n_pad = 12, d/M) tile its worker all-gather
  builds (``core.api.row_block`` and the column tile, the weights
  zero-padded to 12), and its K3 route (the two products on the tile,
  then K3); the ranks of one model index agree bit for bit, the K2 tiles
  assembled over the model index equal the replicated K2 output of every
  leaf bit for bit, W M launches per leaf and nothing else; K3 bit for
  bit its plain version on every tile's products, and the K3 route's
  output bit for bit the replicated route's wherever the tile's cuBLAS
  products equal the replicated ones, elsewhere (only in the leaves of
  ``K3_ROUTE_WIDTHS``, only at M > 1) within 1e-6 x max|x|; one rank's K2 tiles per step timed (CUDA events) beside the
  replicated K2 on the same leaves, with their bounds (the ``kernels``
  line's ``tile_ms``, ``tile_bound_ms`` on the K2 entry);
* timing of K6 at 1x1 and on a 4-rank block (and, logged, a copy of that
  block: the rectangular grid without the view path), K7 (int8, bf16) the
  same, and K4, at the main path's leaf shapes beside their plain
  versions, library calls (``torch.mm``; none for K7) and bounds.  The
  ``kernels``
  line has one entry for each grid of K6 and K7: ``pairwise_stats_rect``
  and ``dequant_stats_rect`` (the symmetric grid, the NCCL world's
  launches) and ``pairwise_stats_rect_block`` and
  ``dequant_stats_rect_block`` (the rectangular grid, the 4 blocks'
  launches).

The serving phases (after the mesh tiles, before phase 11's timing), on
qwen2-1.5b's full width with bf16 activations and bf16 KV caches:

* serving: ``repro_torch.launch.serve`` through its entry point at all 28
  layers (1.54 B fp32 parameters), batch 4, prompt 128, 32 new tokens:
  the three ``[serve]`` lines, every token in [0, 151936), no kernel
  launched.  On the same parameters: prefill seconds (median of 3), the
  decode step's ms a token beside its weight-read bound (the fp32
  parameter bytes over 3.35 TB/s), and the 28-layer prefill logits
  against ``forward_fn``'s (logged, not gated); one decode step traced;
* serving consistency, at 2 layers: prefill and 2 decode steps against
  ``forward_fn(..., logits_tail=1)`` on the grown prompt within 5e-2
  (``tests/test_serving.py``'s bound), on the full cache (prompt 128) and
  the ring buffer (window 64, prompt 96, so every step runs past the
  wrap); one step at ``seq_chunks=4`` against ``seq_chunks=1`` within one
  bf16 ulp of the largest logit, and at fp32 activations within 2e-2 (at
  the full vocabulary the largest bf16 logits reach [4, 8), where one ulp
  is 2**-5);
* robust serving: ``make_robust_serve_step`` over 11 replicas at 2 layers
  (9 identical honest ones; replica 0's embedding table x 1e4, replica
  1's x -1e4), f = 2, multi_bulyan, kernels on, batch 4, prompt 128, 16
  greedy tokens: each replica prefilled and its last logits fused by
  ``aggregate_replica_logits``, then 15 robust decode steps.  K1 and K2
  once per token (16 each, every K2 launch on the theta = 5 kernel), no
  other kernel; byzantine mass 0 at every token; the fused logits the
  honest model's bit for bit at every token and the tokens those of
  ``generate`` on the honest parameters.  Then on the first token's
  (11, 4 x 151936) fp32 stack K1 and K2 held to their plain versions as in
  phase 3 (the plans bit for bit, K2 bit for bit) and timed beside their
  bytes bounds, with the bf16 -> fp32 copy the backend makes first; one
  ensemble step traced after the counted run.

The decoder-family phases (after the serving phases, before phase 11's
timing), each through its entry point at the published widths:

* MoE training: ``launch/train.py --arch qwen3-moe-30b-a3b --layers 1
  --trainer stream_global`` (d_model 2048, 32/4 heads, 128 experts
  top-8, d_expert 768, vocab 151936; 1,236,015,104 parameters), the
  training phase's n, f, attack, optimizer, seq and batch, 2 steps; SSM
  training: ``--arch falcon-mamba-7b --layers 2`` (d_model 4096, d_inner
  8192, d_state 16, dt_rank 256, vocab 65024), stacked, 3 steps; VLM
  training: ``--arch internvl2-1b --layers 2`` (d_model 896, 14/2
  heads, vocab 151655) with a 1024-patch bf16 prefix and 128 text
  tokens, stacked, 2 steps.  Each: finite losses, byzantine mass 0, K1
  and K2 once per leaf per step and nothing else (K2 on the theta = 5
  kernel), steady step seconds and peak memory printed; then its first
  step run twice through the trainer from one state and seed at lr 0.05,
  the parameters and momentum the same bits both times, and a third run
  traced;
* the hybrid: ``--arch jamba-1.5-large-398b --reduced`` (one MoE
  layer's experts at full width are 9.66e9 parameters), stacked and on
  ``stream_global``, 2 steps each, bit for bit alike; then
  ``examples/streaming_at_scale_torch.py`` on the card (diff exactly 0,
  K1 and K2 once per leaf in each of its two steps);
* serving: ``launch/serve.py --arch falcon-mamba-7b`` at all 64 layers
  (7,272,665,088 fp32 parameters) and ``--arch qwen3-moe-30b-a3b
  --layers 2``, batch 4, prompt 128, 32 tokens: no kernel, every
  decoded logit finite, prefill seconds and decode ms a token beside the
  weight-read bound; qwen3-moe's prefill logits the forward's last row
  bit for bit (tokens drop at its capacity factor 1.25, so its decode
  is not held to the forward).  Decode against the forward at 2 layers,
  prefill and 2 steps each within one bf16 ulp of the largest logit,
  for falcon-mamba-7b at full width and the reduced jamba (window 0 and
  64);
* every registered architecture reduced (whisper-tiny's 2 + 2 layers and
  16 frames included): one stacked step (K1 and K2 once per leaf, nothing
  else) and 4 served tokens (no kernel);
* K1 and K2 on the qwen3-moe embedding stack and an (11, 128 x 2048 x
  768) expert stack, timed (median of 3) beside their plain versions,
  ``torch.mm`` for K1 and their bounds (the ``kernels`` line's
  ``moe_leaves``), the expert stack held to the plain versions.

K2 and K3 above theta = 32 (the network variants up to 128, the counted
ones above; after phase 8): K2 at theta in ``select_cases.WIDE_THETAS``
(each side of every bucket boundary, 33 to 129), n = theta + 6 and 256,
beta in {1, ceil(theta / 2), theta}, d in {1, 31, 257, 100003}, on
one-hot / uniform plans with ties and on a stack with NaN, +-inf, +-0
and 1e30; K3 at the same (theta, beta) on normal, all-tied and NaN-laden
inputs: bit for bit the plain versions (NaN in the same places), every
launch counted under its variant (``theta>32``, ``theta>128``).  Then
both timed at each of those theta on one synthetic stack of WIDE_SWEEP_D
columns (K2 at n = theta + 6, K3 on (theta, WIDE_SWEEP_D) inputs, beta =
theta - 4), each held bit for bit to its plain version, beside
``k2_bound_s`` / ``k3_bound_s`` (the ``kernels`` line's ``wide_sweep``).

The encoder-decoder phases (after the decoder families, before phase 11's
timing), whisper-tiny at its published widths and full depth (4 encoder
and 4 decoder layers, d_model 384, 6 heads, d_ff 1536, vocab 51865, 1500
frames; 56,378,112 parameters in 41 leaves):

* training through ``launch/train.py --arch whisper-tiny`` on the training
  phase's flags (n = 11, f = 2, ``inf``, seq 128, 2 sequences a worker, 3
  steps; the frames drawn from ``--seed`` and the step): K1 and K2 once
  per leaf per step (41 each), every K2 launch on the theta = 5 kernel,
  nothing else, byzantine mass 0; the first step run twice bit for bit
  and a third run traced.  Then at n = 40 (theta = 34, beta = 30), 2
  steps: K1 and K2 once per leaf per step, every K2 launch on the network
  variant, byzantine mass 0.  Then one batch's real gradients at n = 40
  (``inf``): the fused apply (K2 41, all ``theta>32``) and ``fused=False``
  (K3 41, all ``theta>32``, each held bit for bit to its plain version on the
  g_ext / g_agr the substrate formed; every coordinate where the two
  applies differ by more than 1e-6 x max(1, |fused|) a float64
  near-tie); both network variants timed over the 41 leaves, each leaf
  bit for bit its plain version, beside their plain versions and bounds
  (the ``theta>32`` entries of K2 and K3 in the ``kernels`` line);
* serving through ``launch/serve.py --arch whisper-tiny`` (batch 4,
  prompt 128 after 1500 frames, 32 tokens; no kernel, the prefill logits
  the forward's last row bit for bit); prefill and 2 decode steps against
  the forward within one bf16 ulp of the largest logit (window 0 and 64);
  the robust ensemble of 11 replicas (9 identical honest; replicas 0 and
  1 their lm_head x 1e4 / x -1e4, each replica with its own cross K/V), 16
  greedy tokens: K1 16 and K2 16 (theta = 5) and nothing else, byzantine
  mass 0, the fused logits the honest model's bit for bit, the tokens
  ``generate``'s with the same frames.

The hierarchical phases (``repro_torch.hier``, after the streaming
phases), kernels on, the ``inf`` attack unless a phase says otherwise:

* H1: ``launch/train.py`` at the training phase's flags with ``--workers
  21 --f 1 --hier g=7`` (3 groups of 7, f_inner = 1, f_outer = 0, the
  outer level ``average``; a 21 x 326,970,880 fp32 stack, 27.47 GB): the
  hier line printed, finite losses, byzantine mass 0 at every step, K1
  and K2 3 times per leaf per step (every K2 launch at theta = 3), K3 and
  K5 never; its peak memory under 60 GiB;
* H2: H1's first batch's gradients after the attack through
  ``hier_aggregate_tree`` with the kernels and with the plain versions on
  the card: every inner plan and the aggregate bit for bit the same
  (NaN-aware); flat multi-Bulyan's apply (n = 21, theta = 17) with the
  kernels and with the plain versions on the same plan, every leaf bit
  for bit, each K2 launch counted under theta = 17's variant; then flat
  and the grouped aggregation timed on that stack (stats + plan + apply, CUDA events,
  median of 5) beside each one's bound (K1 and K2 of every level, each
  input read once, each output written once), each traced once (kernel
  time against wall time), not gated;
* H3: the training phase's flags with ``--hier g=11`` (one group): the
  records and the final parameters bit for bit the training phase's;
* H4: H1 on ``--trainer stream_global`` (bit for bit H1) and
  ``stream_block`` (finite losses, byzantine mass 0, K1 and K2 3 per leaf
  per step);
* H5: ``--hier g=7 --codec qsgd:bits=8 --attack scale_poison`` at n = 21,
  1 layer, 2 steps, stacked and on ``stream_global``: both ``wire[...]``
  lines printed, the leaders' bytes 3 x a worker's, K5 and K2 3 per leaf
  per step, byzantine mass 0, streaming bit for bit stacked; then its
  first step's QSGD container (the launcher's gradients, encoding seed
  and forgery) through ``hier_aggregate_tree`` (the leader re-encode on)
  with the kernels and with the plain versions of K1, K2 and K5: every
  inner plan, the aggregate and the leaders' bytes bit for bit the same,
  and K5 held to its plain version (as the K5 cases above) on every
  group's slice of every leaf's payload, the rows at their offset;
* H6: whisper-tiny whole at n = 49, f = 3, ``--hier g=7``, 2 steps (7
  groups of 7, f_inner = f_outer = 1, the outer level multi-Bulyan): K1
  and K2 8 per leaf per step (7 inner, 1 outer), all at theta = 3,
  byzantine mass 0; on one batch's stack the flat n = 49 apply (theta =
  41) held as H2's, every K2 launch on the network variant; then the
  flat aggregation timed and traced against the grouped one, beside
  their bounds (the flat one's also on the kernels' own slots), not
  gated.

The async service phases (``repro_torch.serve``), kernels on:

* S1 (after the hierarchical phases): ``serve.make_async_train_step`` at
  the training phase's configuration with tau = 1 (its buffer an 11 x
  326,970,880 fp32 stack, 14.39 GB), the launcher's batches, seeds and
  parameters.  3 all-fresh rounds: records and parameters bit for bit the
  training phase's.  Then 5 rounds with rows 8-10 late in rounds 1 and 2
  and row 10 in round 3: ``n_overstale`` [0, 0, 3, 1, 0], ``plan_reused``
  only at round 2, ``f_defended`` [2, 2, 0, 1, 2], round 2's plan round
  1's bit for bit, byzantine mass 0, finite losses, K1 and K2 once per
  leaf a round (theta = 5) and nothing else; round 3's buffer through the
  plan and apply services with the plain versions (plan and aggregate bit
  for bit the kernels'); the last round traced; the peak memory, the
  round seconds against the training phase's and K1 + K2 on the buffer
  against their bounds printed;
* S2 (after robust serving): ``serve.make_microbatch_serve_step`` over
  robust serving's 11 replicas at 2 layers, 8 lanes (6 live at prompts
  32-128, each prefilled alone, 2 padded), 16 greedy tokens each lane at
  its own position: K1 and K2 once a token on the (11, 1,215,488) stack
  and nothing else, byzantine mass 0, the live lanes' fused logits the
  honest model's per-lane decode bit for bit and the padded lanes 0; the
  step at one position for every lane against ``make_robust_serve_step``
  (bits or the largest difference printed); K1 / K2 on the first
  token's stack held to their plain versions and timed, ms a token
  against the 4-lane ensemble's;
* S3: ``serve.run_closed_loop`` in sync and async mode, tau in {1, 2}, at
  d = 65,536 and 16,777,216 (n = 11, f = 2, 40 rounds, microbatch 8): K1
  and K2 once a replayed round and nothing else, every replay's
  per-round accounting equal to a CPU replay of its masks with the plain
  versions; qps, round p50 / p95 / p99, ``agg_us`` and the stale and
  reused rounds printed.

Launch counts are read per phase: every count is set to 0 just before a
training phase, a substrate's apply, a mesh statistics pass, a mesh tile
route or a serving phase and read just after it (``launches_by_phase``
in the ``kernels`` line; ``serving`` and ``robust_serving`` on K1 and
K2).  K4 has no caller on any of those paths.

Run from the repository root, on a machine with one CUDA card and nvcc:
    python3 chip_smoke.py
"""
import collections
import contextlib
import dataclasses
import io
import json
import math
import os
import statistics
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

N, F = 11, 2
#: the main path's theta (n - 2f - 2): K2's variant compiled for it
THETA_MAIN = N - 2 * F - 2
#: K2's theta sweep at n = N: every theta a plan at n can have, beta in
#: {1, ceil(theta / 2), theta}
K2_SWEEP = tuple((t, b) for t in range(1, N)
                 for b in sorted({1, -(-t // 2), t}))
CHECK_WIDTHS = (1, 4095, 100_003, 1_000_000)
EMBED_WIDTH = 151936 * 1536           # qwen2-1.5b's tied embedding leaf
K1_TOL, K2_TOL = 1e-5, 1e-6
HBM_BYTES_PER_S = 3.35e12             # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12               # H100 SXM data sheet, non-tensor fp32
K5_NS = (1, 3, 11, 13, 37, 150)
# odd or 4095: K5 / K7's per-element loads; multiples of 4: the packed words
K5_WIDTHS = (1, 4095, 100_003, 4096, 100_004, 1 << 20)
K3_GRID = ((5, 1), (8, 2), (16, 4), (30, 10), (7, 7), (32, 1))
RECT_NS = (11, 12, 13, 23, 37)
RECT_WS = (1, 2, 4, 8)
K7_NS = (11, 13, 37)
K4_NS = (3, 11, 17, 37)
#: the mesh of the row blocks timed and assembled in one process
MESH_W = 4
#: the training paths launch none of the mesh statistics' kernels (K4 has
#: no caller on any path: the statistics accumulate raw leaf sums)
NO_MESH_KERNELS = {"pairwise_stats_rect": 0, "dequant_stats_rect": 0,
                   "pairwise_sqdist": 0}
COORD_CHUNK = 2 ** 24
TIE_TOL = 1e-5
TRANSFORM_STEPS = 3
TRAIN_ARGS = ["--arch", "qwen2-1.5b", "--layers", "2", "--steps", "3",
              "--seq", "128", "--per-worker-batch", "2", "--workers", str(N),
              "--f", str(F), "--gar", "multi_bulyan", "--attack", "inf",
              "--optimizer", "sgd", "--use-kernels", "--device", "cuda"]


def with_flags(args, **flags):
    """``args`` with each ``--flag`` (underscores as dashes) set anew."""
    out = list(args)
    for k, v in flags.items():
        out[out.index("--" + k.replace("_", "-")) + 1] = str(v)
    return out


WIRE_A_ARGS = with_flags(TRAIN_ARGS, attack="scale_poison") + [
    "--codec", "qsgd:bits=8"]
WIRE_B_ARGS = with_flags(TRAIN_ARGS, attack="payload_flip", layers=1,
                         steps=2) + ["--codec", "signsgd:ef=1"]
ADAPTIVE_A_ARGS = with_flags(TRAIN_ARGS, attack="adaptive_lie")
ADAPTIVE_B_ARGS = with_flags(TRAIN_ARGS, attack="adaptive_mimic", layers=1,
                             steps=2)
#: K1 and K2 once per leaf per step, nothing else: the uncompressed path
K1_K2 = {"pairwise_stats": 1, "fused_select": 1, "dequant_stats": 0,
         "coord_select": 0, **NO_MESH_KERNELS}
#: the checkpoint phase: steps before the save, then one step from the
#: restored state and one from the state in memory
CKPT_STEPS = 2
#: the mesh training phase: the training phase's flags on the host mesh
MESH_TRAIN_ARGS = TRAIN_ARGS + ["--mesh", "host"]
#: the mesh wire phase: wire A's flags at 1 layer for 2 steps, run
#: replicated and on the host mesh
MESH_WIRE_ARGS = with_flags(WIRE_A_ARGS, layers=1, steps=2)
#: K5 and K2 once per leaf per step: the replicated wire path
K5_K2 = {**K1_K2, "pairwise_stats": 0, "dequant_stats": 1}
#: the 1x1 mesh step: the statistics K6 (K7 off the wire) and the apply K2,
#: once per leaf per step, nothing else
MESH_K6_K2 = {**K1_K2, "pairwise_stats": 0, "pairwise_stats_rect": 1}
MESH_K7_K2 = {**K1_K2, "pairwise_stats": 0, "dequant_stats_rect": 1}
#: the streaming phases: the training phase's flags on the streaming
#: trainer's two scopes, global scope at 8 layers, and the mesh wire
#: phase's flags on global scope
STREAM_GLOBAL_ARGS = TRAIN_ARGS + ["--trainer", "stream_global"]
STREAM_BLOCK_ARGS = TRAIN_ARGS + ["--trainer", "stream_block"]
STREAM_DEPTH_ARGS = with_flags(STREAM_GLOBAL_ARGS, layers=8, steps=2)
STREAM_WIRE_ARGS = MESH_WIRE_ARGS + ["--trainer", "stream_global"]
#: streaming global's peak device memory must sit this far below the
#: training phase's
STREAM_PEAK_MARGIN = 2 * 2 ** 30
#: the (W, M) meshes whose ranks the tile phase emulates in one process
TILE_MESHES = ((2, 2), (4, 1))
#: the K3 route on a column tile: the leaf widths where cuBLAS may form a
#: tile's products in another summation order than the whole leaf's (on
#: the H100, the 3072-wide leaves cut into 1536-wide tiles), and the bound
#: on the outputs there, relative to the leaf's largest |x|: one product
#: is a convex sum of n_pad = 12 rows, so any two summation orders differ
#: by at most 12 x 2**-24 x max|x| (< 1e-6 x max|x|, test_spmd's bound)
K3_ROUTE_WIDTHS = (3072,)
K3_ROUTE_TOL = 1e-6
#: the serving phase: launch/serve.py at every layer of qwen2-1.5b
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 128, 32
SERVE_ARGS = ["--arch", "qwen2-1.5b", "--batch", str(SERVE_BATCH),
              "--prompt-len", str(SERVE_PROMPT), "--new-tokens",
              str(SERVE_NEW), "--device", "cuda"]
#: the serving consistency phase: decode against the forward within
#: tests/test_serving.py's bound; the chunked decode against the
#: unchunked within its chunk bound at fp32 activations, and at bf16
#: within one bf16 ulp of the largest logit (at the full vocabulary the
#: largest logits reach [4, 8), where one ulp is 2**-5, above the chunk
#: bound); (window, prompt length) cases, the ring's prompt longer than
#: its window, so decoding runs past the wrap
SERVE_TOL, CHUNK_TOL = 5e-2, 2e-2
CONSISTENCY_CASES = ((0, 128), (64, 96))
CONSISTENCY_STEPS = 2
#: the robust serving phase: N replicas of qwen2-1.5b at the training
#: phase's depth, replicas 0 and 1 corrupted (embedding table x 1e4 and
#: x -1e4), greedy, one fused token per K1 + K2 launch
ROBUST_LAYERS, ROBUST_NEW = 2, 16
ROBUST_CORRUPT = (1e4, -1e4)
#: nothing but K1 and K2, once per generated token
NO_KERNELS = {name: 0 for name in K1_K2}
#: the decoder families at full width: qwen3-moe-30b-a3b cut to 1 layer on
#: the streaming trainer's global scope (the stacked step of one layer
#: would need ~69 GiB), falcon-mamba-7b cut to 2 layers and internvl2-1b
#: to 2 with its 1024-patch prefix (each 128 text tokens) on the stacked
#: trainer; the jamba hybrid reduced (one MoE layer's experts of the full
#: model are 9.66e9 parameters)
MOE_ARGS = with_flags(TRAIN_ARGS, arch="qwen3-moe-30b-a3b", layers=1,
                      steps=2) + ["--trainer", "stream_global"]
SSM_ARGS = with_flags(TRAIN_ARGS, arch="falcon-mamba-7b")
VLM_ARGS = with_flags(TRAIN_ARGS, arch="internvl2-1b", steps=2)
HYBRID_ARGS = with_flags(TRAIN_ARGS, arch="jamba-1.5-large-398b",
                         steps=2) + ["--reduced"]
#: each registered architecture reduced: one step of one sequence a worker
REDUCED_ARGS = with_flags(TRAIN_ARGS, steps=1, seq=16,
                          per_worker_batch=1) + ["--reduced"]
REDUCED_SERVE_NEW = 4
#: the qwen3-moe leaves K1 and K2 are held and timed on: the embedding
#: (and lm_head) and one expert stack
QWEN3_EMBED_WIDTH = 151936 * 2048
QWEN3_EXPERT_WIDTH = 128 * 2048 * 768
#: the families' serving: falcon-mamba-7b at all 64 layers, qwen3-moe at 2
SSM_SERVE_ARGS = with_flags(SERVE_ARGS, arch="falcon-mamba-7b")
MOE_SERVE_LAYERS = 2
MOE_SERVE_ARGS = with_flags(SERVE_ARGS, arch="qwen3-moe-30b-a3b") + [
    "--layers", str(MOE_SERVE_LAYERS)]
#: K2 at theta > 32 (the network and counted variants) on the card tests'
#: cases (kernels/select_cases.py) at n = theta + WIDE_N_EXTRA and 256;
#: then K2 and K3 timed at each of those theta on WIDE_SWEEP_D columns
#: (beta = theta - 2 f at f = 2)
WIDE_N_EXTRA = 6
WIDE_SWEEP_D = 1 << 22
#: the encoder-decoder phases: whisper-tiny at its published widths and
#: full depth (4 encoder and 4 decoder layers, 1500 frames) on the
#: training phase's flags; then at n = 40 (theta = 34, beta = 30: every K2
#: launch on the network variant, ``theta>32``), 2 steps
WHISPER_ARGS = with_flags(TRAIN_ARGS, arch="whisper-tiny", layers=0)
WIDE_N = 40
THETA_WIDE = WIDE_N - 2 * F - 2
WHISPER_WIDE_ARGS = with_flags(WHISPER_ARGS, workers=WIDE_N, steps=2)
WHISPER_LEAVES = 41
WHISPER_SERVE_ARGS = with_flags(SERVE_ARGS, arch="whisper-tiny")
#: the hierarchical phases: n = 21, f = 1 in groups of 7 (3 groups,
#: f_inner = 1, f_outer = 0: the outer level averages), so every K2 launch
#: has theta = 7 - 2 - 2 = 3; whisper at n = 49, f = 3 in 7 groups of 7
#: (f_inner = f_outer = 1: 7 inner launches and one outer a leaf)
HIER_N, HIER_F, HIER_G = 21, 1, 7
THETA_HIER = HIER_G - 2 * 1 - 2
THETA_HIER_FLAT = HIER_N - 2 * HIER_F - 2
HIER_ARGS = with_flags(TRAIN_ARGS, workers=HIER_N, f=HIER_F) + [
    "--hier", f"g={HIER_G}"]
HIER_LINE = "[train] hier: 3 groups [7, 7, 7] f_inner=1 f_outer=0 " \
    "inner=multi_bulyan outer=average"
HIER_K1_K2 = {**K1_K2, "pairwise_stats": 3, "fused_select": 3}
HIER_PEAK_LIMIT = 60 * 2 ** 30
HIER_ONE_GROUP_ARGS = TRAIN_ARGS + ["--hier", f"g={N}"]
HIER_WIRE_ARGS = with_flags(HIER_ARGS, attack="scale_poison", layers=1,
                            steps=2) + ["--codec", "qsgd:bits=8"]
HIER_K5_K2 = {**HIER_K1_K2, "pairwise_stats": 0, "dequant_stats": 3}
HIER_WHISPER_N, HIER_WHISPER_F = 49, 3
THETA_WHISPER_FLAT = HIER_WHISPER_N - 2 * HIER_WHISPER_F - 2
HIER_WHISPER_ARGS = with_flags(WHISPER_ARGS, workers=HIER_WHISPER_N,
                               f=HIER_WHISPER_F, steps=2) + [
    "--hier", f"g={HIER_G}"]
HIER_WHISPER_LINE = "[train] hier: 7 groups [7, 7, 7, 7, 7, 7, 7] " \
    "f_inner=1 f_outer=1 inner=multi_bulyan outer=multi_bulyan"
HIER_WHISPER_K1_K2 = {**K1_K2, "pairwise_stats": 8, "fused_select": 8}
HIER_REPS = 5
#: the async service phases (repro_torch.serve): S1 the async trainer at
#: the training phase's flags, tau = 1, first all fresh (the training
#: phase's 3 steps), then 5 rounds with these worker rows late (rows 8-10
#: twice: overstale the second time, 3 > f, so round 2 reuses round 1's
#: plan; then row 10 once more)
ASYNC_TAU = 1
ASYNC_FRESH_ROUNDS = 3
ASYNC_LATE = ((), (8, 9, 10), (8, 9, 10), (10,), ())
ASYNC_WANT = {"n_overstale": [0, 0, 3, 1, 0],
              "plan_reused": [False, False, True, False, False],
              "f_defended": [2, 2, 0, 1, 2]}
#: S2 microbatched serving: 8 lanes, 6 live at these prompt lengths (each
#: prefilled alone), 2 padded, a 160-slot cache, 16 tokens
MICRO_LANES = 8
MICRO_PROMPTS = (32, 48, 64, 80, 96, 128)
MICRO_CACHE = 160
MICRO_NEW = 16
#: S3 the load model at the JAX serve_bench's defaults, at two widths (the
#: second one 738 MB stack, a leaf's size); the CPU replay of its masks at
#: LOAD_CHECK_D columns
LOAD_WIDTHS = (65_536, 16_777_216)
LOAD_TAUS = (1, 2)
LOAD_CHECK_D = 4096


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


# ------------------------------------------------------------------ phases
def header():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    line = out.stdout.strip().splitlines()[0]
    print(line, flush=True)
    return line


def build_kernels():
    from repro_torch.kernels import build
    seconds, logs = build.build()
    for name, text in logs.items():
        for ln in text.splitlines():
            if "registers" in ln or "spill" in ln or "error" in ln.lower():
                log(f"nvcc {name}: {ln.strip()}")
    log(f"build: {len(logs)} kernel(s) compiled in {seconds:.1f}s")


def rows_stack(torch, d, seed, n=N):
    """(n, d) fp32 on the card: row i is N(0, s_i^2) noise with distinct
    s_i, so pairwise distances (about d (s_i^2 + s_j^2)) are well apart
    and the plan cannot flip on an ulp."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = torch.empty((n, d), dtype=torch.float32, device="cuda")
    x.normal_(generator=gen)
    scale = 1.0 + 0.1 * torch.arange(n, dtype=torch.float32, device="cuda")
    return x.mul_(scale[:, None])


def with_inf_attack(torch, x):
    from repro_torch.core import attacks as ATK
    x[:F] = ATK.inf_attack(x[F:], F)
    return x


def plan_of(raw):
    from repro_torch.core import api
    stats = api.AggStats(n=N, f=F, dists=api.finalize_dists(raw))
    return api.get_aggregator("multi_bulyan").plan(stats)


def synthetic_plan(torch, theta, n, seed):
    """(theta, n) weights on the card as a multi-Bulyan plan shapes them
    (``select_cases.synthetic_plan``: w_ext one-hot with repeated rows,
    w_agr uniform with repeated slots, so values and distances tie)."""
    from repro_torch.kernels import select_cases
    return select_cases.synthetic_plan(theta, n, seed, "cuda")


def k2_variant_check(label, launches, theta=THETA_MAIN):
    """Every K2 launch counted since the last reset took the variant of
    ``theta`` (the kernel compiled for THETA_MAIN on the main path)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_select import variant_name
    got = ops.fused_select_variant_counts()
    want = {variant_name(theta): launches} if launches else {}
    check(got == want, f"{label}: K2 variants {got}, want {want}")
    return got


def compare_k1(torch, got, want):
    """(max abs err, max rel err) over finite entries; non-finite entries
    must sit at the same places."""
    check(torch.equal(torch.isnan(got), torch.isnan(want)),
          "NaN pattern differs")
    fin = torch.isfinite(want)
    check(torch.equal(torch.isfinite(got), fin), "inf pattern differs")
    check(torch.equal(got[~fin & ~torch.isnan(want)],
                      want[~fin & ~torch.isnan(want)]), "inf signs differ")
    if not bool(fin.any()):
        return 0.0, 0.0
    err = float(torch.max(torch.abs(got[fin] - want[fin])))
    scale = max(1.0, float(torch.max(torch.abs(want[fin]))))
    return err, err / scale


def kernels_vs_plain(torch):
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fused_select import fused_select_cuda
    from repro_torch.kernels.pairwise_sqdist import pairwise_stats_cuda
    cases = [(f"d={d}", d, False) for d in CHECK_WIDTHS]
    cases += [(f"embed d={EMBED_WIDTH}", EMBED_WIDTH, False),
              (f"qwen3-moe embed d={QWEN3_EMBED_WIDTH}", QWEN3_EMBED_WIDTH,
               False),
              ("inf attack d=1000000", 1_000_000, True)]
    worst = {"pairwise_stats": 0.0, "fused_select": 0.0}
    for label, d, attacked in cases:
        x = rows_stack(torch, d, seed=d)
        if attacked:
            x = with_inf_attack(torch, x)
        raw_k, sq_k = pairwise_stats_cuda(x)
        raw_p, sq_p = ref.pairwise_stats_ref(x)
        torch.cuda.synchronize()
        e_d, r_d = compare_k1(torch, raw_k, raw_p)
        e_s, r_s = compare_k1(torch, sq_k, sq_p)
        check(r_d <= K1_TOL and r_s <= K1_TOL,
              f"K1 {label}: rel err dists {r_d:.3e} norms {r_s:.3e} "
              f"> {K1_TOL}")
        plan_k, plan_p = plan_of(raw_k), plan_of(raw_p)
        same_plan = torch.equal(plan_k.w_ext, plan_p.w_ext) and \
            torch.equal(plan_k.w_agr, plan_p.w_agr)
        check(same_plan, f"K1 {label}: plan from kernel distances differs")
        if attacked:
            byz = float(torch.sum(plan_k.selection_weights()[:F]))
            check(byz == 0.0, f"inf attack: byzantine plan mass {byz}")
        out_k = fused_select_cuda(x, plan_p.w_ext, plan_p.w_agr,
                                  plan_p.beta)
        out_p = ref.fused_select_ref(x, plan_p.w_ext, plan_p.w_agr,
                                     plan_p.beta)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out_k).all()), f"K2 {label}: non-finite")
        e_2 = float(torch.max(torch.abs(out_k - out_p)))
        scale = max(1.0, float(torch.max(torch.abs(out_p))))
        check(e_2 <= K2_TOL * scale,
              f"K2 {label}: abs err {e_2:.3e} > {K2_TOL} x {scale:.3e}")
        log(f"{label:24s} K1 dists abs {e_d:.3e} rel {r_d:.3e} | norms "
            f"abs {e_s:.3e} rel {r_s:.3e} | plan identical | K2 abs "
            f"{e_2:.3e} bitwise={bool(torch.equal(out_k, out_p))}")
        worst["pairwise_stats"] = max(worst["pairwise_stats"], e_d, e_s)
        worst["fused_select"] = max(worst["fused_select"], e_2)
        del x, raw_k, sq_k, raw_p, sq_p, out_k, out_p
        torch.cuda.empty_cache()
    k2_theta_sweep(torch)
    ops.reset_launch_counts()
    return worst


def k2_theta_sweep(torch):
    """K2 at n = N for every (theta, beta) of K2_SWEEP on synthetic plans
    (:func:`synthetic_plan`) over CHECK_WIDTHS: bit for bit its plain
    version, each launch counted under the variant compiled for its
    theta."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fused_select import fused_select_cuda, \
        variant_name
    for theta, beta in K2_SWEEP:
        we, wa = synthetic_plan(torch, theta, N, seed=theta * 10 + beta)
        ops.reset_launch_counts()
        for d in CHECK_WIDTHS:
            x = rows_stack(torch, d, seed=theta + d)
            got = fused_select_cuda(x, we, wa, beta)
            want = ref.fused_select_ref(x, we, wa, beta)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"K2 sweep theta={theta} "
                  f"beta={beta} d={d}: differs from its plain version (max "
                  f"abs {float(torch.max(torch.abs(got - want))):.3e})")
        variants = ops.fused_select_variant_counts()
        check(variants == {variant_name(theta): len(CHECK_WIDTHS)},
              f"K2 sweep theta={theta}: variants {variants}")
    log(f"K2 theta sweep at n={N}: {len(K2_SWEEP)} (theta, beta) x d in "
        f"{list(CHECK_WIDTHS)} bit for bit equal to the plain version, each "
        f"on the kernel compiled for its theta")


def largest_f(n):
    """The largest f multi-Bulyan takes at n (n >= 4f + 3), or None."""
    return (n - 3) // 4 if n >= 3 else None


def k5_payload(torch, n, d, dtype, seed):
    """(n, d) int8 or bf16 payload on the card and (n,) multipliers: row i
    scaled by 1 + 0.1 i (distances well apart), row 0's multiplier
    negative, as a ``scale_poison`` row sends it."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    if dtype == torch.int8:
        p = torch.randint(-127, 128, (n, d), generator=gen, device="cuda",
                          dtype=torch.int8)
        base = 1.0 / 127.0
    else:
        p = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
        base = 1.0
    mult = base * (1.0 + 0.1 * torch.arange(n, dtype=torch.float32,
                                            device="cuda"))
    mult[0] = -mult[0]
    return p, mult


def compare_k5(torch, label, p, mult, f, worst):
    """K5 against its plain version (K1's tolerance), against K1 on the
    decoded stack (bit for bit) and, with f given, the plans from K5's and
    the plain distances (bit for bit).  Returns the plan from K5."""
    from repro_torch.core import api
    from repro_torch.kernels import ref
    from repro_torch.kernels.dequant_stats import dequant_stats_cuda
    from repro_torch.kernels.pairwise_sqdist import pairwise_stats_cuda
    raw_k, sq_k = dequant_stats_cuda(p, mult)
    raw_p, sq_p = ref.dequant_stats_ref(p, mult)
    raw_1, sq_1 = pairwise_stats_cuda(p.float() * mult[:, None])
    torch.cuda.synchronize()
    check(torch.equal(raw_k, raw_1) and torch.equal(sq_k, sq_1),
          f"K5 {label}: differs from K1 on the decoded stack")
    check(bool(torch.isfinite(raw_p).all()), f"K5 {label}: non-finite")
    e_d = float(torch.max(torch.abs(raw_k - raw_p)))
    e_s = float(torch.max(torch.abs(sq_k - sq_p)))
    s_max = float(torch.max(sq_p))
    r_d = e_d / max(1.0, float(torch.max(torch.abs(raw_p))), 2 * s_max)
    r_s = e_s / max(1.0, s_max)
    check(r_d <= K1_TOL and r_s <= K1_TOL,
          f"K5 {label}: rel err dists {r_d:.3e} norms {r_s:.3e} > {K1_TOL}")
    plan = None
    if f is not None:
        n = p.shape[0]
        agg = api.get_aggregator("multi_bulyan")
        plan = agg.plan(api.AggStats(n=n, f=f,
                                     dists=api.finalize_dists(raw_k)))
        plan_p = agg.plan(api.AggStats(n=n, f=f,
                                       dists=api.finalize_dists(raw_p)))
        check(torch.equal(plan.w_ext, plan_p.w_ext) and
              torch.equal(plan.w_agr, plan_p.w_agr),
              f"K5 {label}: plan from kernel distances differs")
    worst["max_abs"] = max(worst["max_abs"], e_d, e_s)
    worst["max_rel"] = max(worst["max_rel"], r_d, r_s)
    log(f"K5 {label:34s} rel err dists {r_d:.3e} norms {r_s:.3e} | "
        f"== K1 on decoded bitwise | plan "
        f"{'identical' if f is not None else 'not checked'}")
    return plan, raw_k


def k5_vs_plain(torch):
    """Every K5 case of the module docstring; returns the worst errors."""
    from repro_torch.comm import codecs as CC
    from repro_torch.dist import inject_wire
    from repro_torch.kernels import ops
    worst = {"max_abs": 0.0, "max_rel": 0.0}
    for dtype in (torch.int8, torch.bfloat16):
        tag = "int8" if dtype == torch.int8 else "bf16"
        cases = [(n, d) for n in K5_NS for d in K5_WIDTHS]
        cases.append((N, EMBED_WIDTH))
        for n, d in cases:
            p, mult = k5_payload(torch, n, d, dtype, seed=n * 7 + d)
            compare_k5(torch, f"{tag} n={n} d={d}", p, mult, largest_f(n),
                       worst)
            del p, mult
            torch.cuda.empty_cache()
        # one element into a larger buffer: rows off 4-byte words
        p, mult = k5_payload(torch, N, 100_004, dtype, seed=8)
        buf = torch.zeros(p.numel() + 1, dtype=dtype, device="cuda")
        buf[1:] = p.reshape(-1)
        compare_k5(torch, f"{tag} n={N} d=100004 base+1",
                   buf[1:].view(p.shape), mult, F, worst)
        del p, mult, buf
    for spec in ("qsgd:bits=8", "bf16"):
        x = rows_stack(torch, 1_000_000, seed=5)
        enc, _ = CC.get_codec(spec).encode(x, seed=5)
        enc = inject_wire(enc, F, "scale_poison", seed=5)
        p, mult = CC.get_codec(spec).dequant_form(enc.payload, enc.sidecar)
        plan, _ = compare_k5(torch, f"{spec} scale_poison d=1000000",
                             p.contiguous(), mult.float().contiguous(), F,
                             worst)
        byz = float(torch.sum(plan.selection_weights()[:F]))
        check(byz == 0.0, f"{spec} scale_poison: byzantine mass {byz}")
        del x, enc, p, mult
        torch.cuda.empty_cache()
    ops.reset_launch_counts()
    return worst


def real_wire_k5(torch, worst):
    """K5 on one real wire-A container: the 11 workers' gradients of one
    batch at the training phase's configuration, QSGD-encoded and forged
    by ``scale_poison``; every leaf is checked as in :func:`compare_k5`,
    and the plan from the summed distances gives the forged rows no
    mass."""
    from repro_torch import models as MD
    from repro_torch.comm import codecs as CC
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batches
    from repro_torch.dist import inject_wire, per_worker_grads, split_workers
    from repro_torch.kernels import ops
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=2)
    params = MD.init_model(cfg, seed=0, device="cuda")
    batch = {k: v.to("cuda") for k, v in split_workers(
        next(lm_batches(cfg.vocab_size, 2 * N, 128, seed=0)), N).items()}
    _, grads = per_worker_grads(params, cfg, batch, chunk_q=128)
    del params
    codec = CC.get_codec("qsgd:bits=8")
    with torch.no_grad():
        enc, _ = codec.encode(grads, seed=7)
        del grads
        enc = inject_wire(enc, F, "scale_poison", seed=7)
        raw = torch.zeros((N, N), dtype=torch.float32, device="cuda")
        for i, (p, s) in enumerate(zip(tree_leaves(enc.payload),
                                       CC.sidecar_leaves(enc))):
            p2, mult = codec.dequant_form(p, s)
            _, raw_k = compare_k5(
                torch, f"wire A leaf {i} {tuple(p.shape)}", p2.contiguous(),
                mult.float().contiguous(), None, worst)
            raw = raw + raw_k
    plan = plan_of(raw)
    byz = float(torch.sum(plan.selection_weights()[:F]))
    check(byz == 0.0, f"real wire A container: byzantine mass {byz}")
    log(f"real wire A container: {len(enc.shapes)} leaves checked, "
        f"byzantine mass 0")
    del enc, raw
    torch.cuda.empty_cache()
    ops.reset_launch_counts()


def coord_inputs(torch, theta, d, seed, ties=False):
    """(theta, d) g_ext and g_agr on the card, N(0, 1) noise; with
    ``ties`` every g_agr value lies 1 from the median 0 (rows alternate
    +1 / -1, so the tie order shows in the result)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    ge = torch.empty((theta, d), dtype=torch.float32, device="cuda")
    ga = torch.empty_like(ge)
    ge.normal_(generator=gen)
    ga.normal_(generator=gen)
    if ties:
        ge.zero_()
        ga.fill_(1.0)
        ga[1::2] = -1.0
    return ge, ga


def k3_vs_plain(torch):
    """K3 against its plain version, bit for bit: (theta, beta) over
    K3_GRID x d over CHECK_WIDTHS, the embedding leaf at theta = 16
    (theta * d > 2^31), an all-ties case, and beta = theta (the mean, also
    held to ``torch.mean`` within 1e-6).  Returns the largest |K3 - plain|
    (0 when every case is bitwise)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.coord_select import coord_select_cuda
    cases = [(t, b, d, False) for t, b in K3_GRID for d in CHECK_WIDTHS]
    cases += [(16, 4, EMBED_WIDTH, False), (6, 3, 100_003, True),
              (6, 6, 100_003, True)]
    worst = 0.0
    for theta, beta, d, ties in cases:
        ge, ga = coord_inputs(torch, theta, d, seed=theta * 1000 + d,
                              ties=ties)
        got = coord_select_cuda(ge, ga, beta)
        want = ref.coord_select_ref(ge, ga, beta)
        torch.cuda.synchronize()
        err = float(torch.max(torch.abs(got - want)))
        worst = max(worst, err)
        check(torch.equal(got, want), f"K3 theta={theta} beta={beta} d={d}"
              f"{' ties' if ties else ''}: differs from its plain version "
              f"(max abs {err:.3e})")
        if beta == theta:
            mean = torch.mean(ga, dim=0)
            e_m = float(torch.max(torch.abs(got - mean)))
            check(e_m <= K2_TOL * max(1.0, float(torch.max(torch.abs(mean)))),
                  f"K3 beta=theta={theta} d={d}: {e_m:.3e} from the mean")
        del ge, ga, got, want
        torch.cuda.empty_cache()
    log(f"K3: {len(cases)} cases bit for bit equal to the plain version "
        f"(theta, beta in {list(K3_GRID)} x d in {list(CHECK_WIDTHS)}, the "
        f"embedding leaf at theta=16, ties, beta = theta)")
    ops.reset_launch_counts()
    return worst


def real_gradients(torch, layers=2):
    """One batch's (N, ...) gradient stack at the training phase's
    configuration, with the ``inf`` attack on the first F rows."""
    from repro_torch import models as MD
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batches
    from repro_torch.dist import inject_byzantine, per_worker_grads, \
        split_workers
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=layers)
    params = MD.init_model(cfg, seed=0, device="cuda")
    batch = {k: v.to("cuda") for k, v in split_workers(
        next(lm_batches(cfg.vocab_size, 2 * N, 128, seed=0)), N).items()}
    _, grads = per_worker_grads(params, cfg, batch, chunk_q=128)
    del params
    with torch.no_grad():
        inject_byzantine(grads, F, "inf", seed=0)
    return grads


def near_ties(torch, x, plan, idx):
    """For the columns ``idx`` of an (N, m) leaf, recomputed in float64
    from the stack and the plan: True where the selection sits at a
    near-tie, i.e. the beta-th and (beta+1)-th smallest distances to the
    median, or two neighbouring extracted values around the middle, lie
    within TIE_TOL of each other relative to the values they are formed
    from.  Returns a bool tensor over ``idx``."""
    xs = x[:, idx].double()
    ext = plan.w_ext.double() @ xs                          # (theta, k)
    agr = plan.w_agr.double() @ xs
    theta, beta = ext.shape[0], plan.beta
    srt = torch.sort(ext, dim=0).values
    h = theta // 2
    med = srt[h] if theta % 2 else 0.5 * (srt[h - 1] + srt[h])
    tie = torch.zeros(len(idx), dtype=torch.bool, device=x.device)
    lo, hi = (h - 1, h) if theta % 2 else (h - 2, h)
    for a in range(max(lo, 0), min(hi, theta - 1) + 1):
        size = torch.maximum(srt[a].abs(), srt[a + 1].abs())
        tie |= (srt[a + 1] - srt[a]) <= TIE_TOL * size
    if beta < theta:
        dist = torch.sort(torch.abs(agr - med[None]), dim=0).values
        size = torch.maximum(torch.max(agr.abs(), dim=0).values, med.abs())
        tie |= (dist[beta] - dist[beta - 1]) <= TIE_TOL * size
    return tie


def two_step_substrate(torch):
    """The two-step apply on one step's real gradients (the training
    phase's configuration, ``inf`` attack), against the fused one.

    Every launch count is set to 0 just before each apply and read just
    after: ``fused=False`` must launch K3 once per leaf, with
    ``coord_chunk`` once per column slice, and K2 never.  Every K3 launch
    is held bit for bit to ``coord_select_ref`` on the very g_ext / g_agr
    the substrate formed.  Against the fused apply (K2), every coordinate
    more than 1e-6 x max(1, |fused|) apart must be a near-tie
    (:func:`near_ties`).  Returns (the fused=False counts, the number of
    K3 launches held to the plain version)."""
    from repro_torch.core import api
    from repro_torch.kernels import ops, ref
    from repro_torch.tree import tree_leaves
    grads = real_gradients(torch)
    leaves = [x.reshape(N, -1) for x in tree_leaves(grads)]
    numels = [x.shape[1] for x in leaves]
    fused = api.AggregatorBackend("multi_bulyan", F)
    with torch.no_grad():
        plan = fused.plan(fused.stats(grads))
        byz = float(torch.sum(plan.selection_weights()[:F]))
        check(byz == 0.0, f"two-step substrate: byzantine plan mass {byz}")
        out_f = [o.reshape(-1) for o in tree_leaves(fused.apply(plan, grads))]
    real_k3 = ops.coord_select
    held = []

    def k3_held_to_plain(g_ext, g_agr, beta):
        got = real_k3(g_ext, g_agr, beta)
        want = ref.coord_select_ref(g_ext, g_agr, beta)
        check(torch.equal(got, want), f"K3 on the substrate's "
              f"{tuple(g_ext.shape)} inputs differs from its plain version")
        held.append(tuple(g_ext.shape))
        return got

    result = {}
    for label, chunk in (("fused=False", 0),
                         (f"fused=False coord_chunk={COORD_CHUNK}",
                          COORD_CHUNK)):
        backend = api.AggregatorBackend("multi_bulyan", F, fused=False,
                                        coord_chunk=chunk)
        ops.coord_select = k3_held_to_plain
        try:
            with torch.no_grad():
                ops.reset_launch_counts()
                out = backend.apply(plan, grads)
                torch.cuda.synchronize()
                counts = ops.launch_counts()
        finally:
            ops.coord_select = real_k3
        slices = sum(-(-m // chunk) if chunk and m > chunk else 1
                     for m in numels)
        want = {"pairwise_stats": 0, "fused_select": 0, "dequant_stats": 0,
                "coord_select": slices, **NO_MESH_KERNELS}
        check(counts == want, f"{label}: launches {counts}, want {want}")
        n_diff = n_tie = 0
        for x, o2, of in zip(leaves, tree_leaves(out), out_f):
            o2 = o2.reshape(-1)
            check(bool(torch.isfinite(o2).all()), f"{label}: non-finite")
            bad = torch.abs(o2 - of) > K2_TOL * torch.clamp(of.abs(), min=1.0)
            idx = torch.nonzero(bad).reshape(-1)
            n_diff += len(idx)
            for c0 in range(0, len(idx), 1 << 16):
                tie = near_ties(torch, x, plan, idx[c0:c0 + (1 << 16)])
                n_tie += int(tie.sum())
        check(n_diff == n_tie, f"{label}: {n_diff - n_tie} of {n_diff} "
              f"differing coordinates are not near-ties")
        log(f"two-step {label}: launches {counts} ({len(numels)} leaves, "
            f"{slices} column slices), every K3 launch bit for bit equal to "
            f"its plain version; {n_diff} of {sum(numels):,} coordinates "
            f"differ from the fused apply by more than {K2_TOL} x max(1, "
            f"|fused|), all near-ties")
        result[chunk] = (counts, n_diff)
        del out
    del grads, leaves, out_f
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    return result[0][0], len(held), {k: v[1] for k, v in result.items()}


def transform_training(torch):
    """``make_train_step(transforms=(WorkerMomentum(0.9),
    NearestNeighborMix(3)))`` at the training phase's configuration with
    the ``inf`` attack for TRANSFORM_STEPS steps: finite losses, finite
    honest rows of the momentum state, the byzantine mass printed (not
    gated: nn_mix turns a forged row into a mean of honest rows, which the
    rule may pick), and per step K1 twice per leaf (nn_mix's statistics
    and the plan's), K2 once, K3 and K5 never."""
    from repro_torch import models as MD
    from repro_torch.configs import RobustConfig, get_config
    from repro_torch.core import api
    from repro_torch.data import lm_batches
    from repro_torch.dist import (init_train_state, make_train_step,
                                  split_workers)
    from repro_torch.kernels import ops
    from repro_torch.optim import constant, sgd
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=2)
    rcfg = RobustConfig(n_workers=N, f=F, gar="multi_bulyan")
    opt = sgd(momentum=0.9)
    transforms = (api.WorkerMomentum(0.9), api.NearestNeighborMix(3))
    params = MD.init_model(cfg, seed=0, device="cuda")
    leaves = len(tree_leaves(params))
    state = init_train_state(opt, params, transforms, n_workers=N)
    step = make_train_step(cfg, rcfg, opt, constant(0.05), chunk_q=128,
                           attack="inf", transforms=transforms,
                           telemetry=True)
    data = lm_batches(cfg.vocab_size, 2 * N, 128, seed=0)
    torch.cuda.reset_peak_memory_stats()
    losses, byz, secs = [], [], []
    ops.reset_launch_counts()
    for i in range(TRANSFORM_STEPS):
        wb = {k: v.to("cuda") for k, v in split_workers(next(data),
                                                         N).items()}
        t0 = time.perf_counter()
        params, state, m = step(params, state, wb, i)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        byz.append(float(m["telemetry"]["byz_mass"]))
        check(math.isfinite(losses[-1]) and bool(
            torch.isfinite(m["loss_per_worker"]).all()),
            f"transforms step {i}: non-finite loss {losses[-1]}")
        check(all(bool(torch.isfinite(x[F:]).all())
                  for x in tree_leaves(state.tstates[0])),
              f"transforms step {i}: non-finite honest momentum")
    counts = ops.launch_counts()
    want = {"pairwise_stats": 2 * leaves * TRANSFORM_STEPS,
            "fused_select": leaves * TRANSFORM_STEPS, "dequant_stats": 0,
            "coord_select": 0, **NO_MESH_KERNELS}
    check(counts == want, f"transforms: launches {counts}, want {want}")
    variants = k2_variant_check("transforms", counts["fused_select"])
    check(state.tstates[1] is None, "transforms: nn_mix grew a state")
    log(f"transforms (worker_momentum 0.9, nn_mix 3; inf): losses "
        f"{[round(v, 4) for v in losses]}, byz_mass {byz} (logged, not "
        f"gated), launches {counts} = {leaves} leaves x {TRANSFORM_STEPS} "
        f"steps, K2 variants {variants}; step seconds "
        f"{[round(v, 4) for v in secs]}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del params, state, m
    torch.cuda.empty_cache()
    ops.reset_launch_counts()


def same_bits(torch, a, b):
    """Equal bit for bit, NaN in the same places."""
    return tuple(a.shape) == tuple(b.shape) and \
        torch.equal(torch.isnan(a), torch.isnan(b)) and \
        torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


def abs_err(torch, got, want):
    """The largest |got - want|: 0 where the two hold the same value (NaN
    and NaN included), inf where only one is NaN."""
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    diff = torch.where(same, torch.zeros_like(got), torch.abs(got - want))
    return float(torch.nan_to_num(diff, nan=math.inf).max())


def padded(torch, x, W):
    """``x`` with zero rows appended to W ceil(n / W) rows (the worker
    axis of a W-rank mesh), and n_loc = ceil(n / W)."""
    n_loc = -(-x.shape[0] // W)
    if n_loc * W == x.shape[0]:
        return x, n_loc
    full = x.new_zeros((n_loc * W,) + tuple(x.shape[1:]))
    full[:x.shape[0]] = x
    return full, n_loc


def stats_err(torch, got_d, got_s, want_d, want_s):
    """(max abs err, relative err) of raw distances and norms against a
    plain version: non-finite entries at the same places (compare_k1),
    distances against max(1, 2 max finite norm), norms against max(1,
    max finite norm)."""
    e_d, _ = compare_k1(torch, got_d, want_d)
    e_s, _ = compare_k1(torch, got_s, want_s)
    fin = torch.isfinite(want_s)
    s_max = float(torch.max(want_s[fin])) if bool(fin.any()) else 0.0
    return max(e_d, e_s), max(e_d / max(1.0, 2.0 * s_max),
                              e_s / max(1.0, s_max))


def k6_launch(torch, blk, full, n):
    """K6 on one block: (raw block, norms, the path that ran: "symmetric",
    "view" or "rectangular")."""
    from repro_torch.kernels.pairwise_sqdist import pairwise_stats_rect_cuda
    sq = pairwise_stats_rect_cuda.square_launches
    vw = pairwise_stats_rect_cuda.view_launches
    got_d, got_s = pairwise_stats_rect_cuda(blk, full, n=n)
    path = "symmetric" if pairwise_stats_rect_cuda.square_launches > sq \
        else "view" if pairwise_stats_rect_cuda.view_launches > vw \
        else "rectangular"
    return got_d, got_s, path


def k6_blocks(torch, label, x, Ws, worst, ranks=None):
    """Every rank's (or ``ranks``') K6 block of the stack ``x`` on W-rank
    meshes, K1's chunk count for the true n: the block a view of the
    zero-padded stack (at W = 1 the whole stack, which K6 runs on K1's
    symmetric grid; at W > 1 on the rectangular grid, on its view path
    where the padded stack has at most 16 rows), and a copy of it (the
    rectangular grid without the view path).  Each must be K1's matching
    rows bit for bit (NaN and inf in place) and within K1_TOL of its
    plain version, and the view and the copy the same bits on the whole
    block and norms; the worst error is kept by the grid that ran
    (``pairwise_stats_rect`` on the symmetric grid,
    ``pairwise_stats_rect_block`` on the rectangular one).  Returns the
    number of blocks and copies checked."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.pairwise_sqdist import pairwise_stats_cuda
    n = x.shape[0]
    k1_d, k1_s = pairwise_stats_cuda(x)
    count = 0
    for W in Ws:
        full, n_loc = padded(torch, x, W)
        want_path = "symmetric" if W == 1 else \
            "view" if full.shape[0] <= 16 else "rectangular"
        for r in (range(W) if ranks is None else ranks):
            blk = full[r * n_loc:(r + 1) * n_loc]
            got_d, got_s, path = k6_launch(torch, blk, full, n)
            copy = blk.clone()
            copy_d, copy_s, copy_path = k6_launch(torch, copy, full, n)
            del copy
            want_d, want_s = ref.pairwise_stats_rect_ref(blk, full)
            torch.cuda.synchronize()
            check((path, copy_path) == (want_path, "rectangular"),
                  f"K6 {label} W={W} rank {r}: ran {path} / {copy_path} "
                  f"(block / copy), want {want_path} / rectangular")
            check(same_bits(torch, got_d, copy_d) and
                  same_bits(torch, got_s, copy_s),
                  f"K6 {label} W={W} rank {r}: the block and its copy "
                  f"differ")
            rows = max(0, min(n_loc, n - r * n_loc))
            check(same_bits(torch, got_d[:rows, :n],
                            k1_d[r * n_loc:r * n_loc + rows]) and
                  same_bits(torch, got_s[:n], k1_s),
                  f"K6 {label} W={W} rank {r}: differs from K1's rows")
            err, rel = stats_err(torch, got_d[:rows, :n], got_s[:n],
                                 want_d[:rows, :n], want_s[:n])
            check(rel <= K1_TOL, f"K6 {label} W={W} rank {r}: relative "
                  f"error {rel:.3e} > {K1_TOL} against its plain version")
            # the copy ran the rectangular grid, with the block's bits
            worst["pairwise_stats_rect_block"] = max(
                worst["pairwise_stats_rect_block"], err)
            if path == "symmetric":
                worst["pairwise_stats_rect"] = max(
                    worst["pairwise_stats_rect"], err)
            count += 2
            del got_d, got_s, copy_d, copy_s, want_d, want_s
        del full
    return count


def k7_blocks(torch, label, p, mult, Ws, worst, ranks=None):
    """K7 as :func:`k6_blocks`, on a payload and its multipliers (zero
    payload and multiplier in the padding rows), against K5's rows."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.dequant_stats import (dequant_stats_cuda,
                                                   dequant_stats_rect_cuda)
    n = p.shape[0]
    k5_d, k5_s = dequant_stats_cuda(p, mult)
    count = 0
    for W in Ws:
        pf, n_loc = padded(torch, p, W)
        mf, _ = padded(torch, mult, W)
        blocks = [(r, pf[r * n_loc:(r + 1) * n_loc],
                   mf[r * n_loc:(r + 1) * n_loc])
                  for r in (range(W) if ranks is None else ranks)]
        if W == 1:      # the whole payload as a copy: the rectangular grid
            blocks.append((0, pf.clone(), mf.clone()))
        for r, pb, mb in blocks:
            before = dequant_stats_rect_cuda.square_launches
            got_d, got_s = dequant_stats_rect_cuda(pb, mb, pf, mf, n=n)
            grid = "" if dequant_stats_rect_cuda.square_launches > before \
                else "_block"
            want_d, want_s = ref.dequant_stats_rect_ref(pb, mb, pf, mf)
            torch.cuda.synchronize()
            rows = max(0, min(n_loc, n - r * n_loc))
            check(same_bits(torch, got_d[:rows, :n],
                            k5_d[r * n_loc:r * n_loc + rows]) and
                  same_bits(torch, got_s[:n], k5_s),
                  f"K7 {label} W={W} rank {r}: differs from K5's rows")
            err, rel = stats_err(torch, got_d[:rows, :n], got_s[:n],
                                 want_d[:rows, :n], want_s[:n])
            check(rel <= K1_TOL, f"K7 {label} W={W} rank {r}: relative "
                  f"error {rel:.3e} > {K1_TOL} against its plain version")
            key = "dequant_stats_rect" + grid
            worst[key] = max(worst[key], err)
            count += 1
            del got_d, got_s, want_d, want_s
        del pf, mf
    return count


def rect_vs_square(torch):
    """K6, K7 and K4 against the square kernels (bit for bit) and their
    plain versions (within K1_TOL); returns the worst abs errors against
    the plain versions."""
    from repro_torch.comm import codecs as CC
    from repro_torch.core import api
    from repro_torch.dist import inject_wire
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.dequant_stats import dequant_stats_rect_cuda
    from repro_torch.kernels.pairwise_sqdist import (pairwise_sqdist_cuda,
                                                     pairwise_stats_cuda)
    worst = {"pairwise_stats_rect": 0.0, "pairwise_stats_rect_block": 0.0,
             "dequant_stats_rect": 0.0, "dequant_stats_rect_block": 0.0,
             "pairwise_sqdist": 0.0}
    k6 = k7 = k4 = 0
    for n in RECT_NS:
        for d in CHECK_WIDTHS:
            x = rows_stack(torch, d, seed=n * 31 + d, n=n)
            k6 += k6_blocks(torch, f"n={n} d={d}", x, RECT_WS, worst)
            del x
    x = with_inf_attack(torch, rows_stack(torch, 1_000_000, seed=3))
    k6 += k6_blocks(torch, "inf attack d=1000000", x, RECT_WS, worst)
    del x
    x = rows_stack(torch, EMBED_WIDTH, seed=EMBED_WIDTH)
    k6 += k6_blocks(torch, f"embed d={EMBED_WIDTH}", x, (MESH_W,), worst,
                    ranks=(1,))
    del x
    torch.cuda.empty_cache()
    for dtype in (torch.int8, torch.bfloat16):
        tag = "int8" if dtype == torch.int8 else "bf16"
        for n in K7_NS:
            for d in K5_WIDTHS:
                p, mult = k5_payload(torch, n, d, dtype, seed=n * 13 + d)
                k7 += k7_blocks(torch, f"{tag} n={n} d={d}", p, mult, RECT_WS,
                                worst)
        p, mult = k5_payload(torch, N, EMBED_WIDTH, dtype, seed=1)
        k7 += k7_blocks(torch, f"{tag} embed d={EMBED_WIDTH}", p, mult,
                        (MESH_W,), worst, ranks=(1,))
        del p, mult
        torch.cuda.empty_cache()
    for spec in ("qsgd:bits=8", "bf16"):
        x = rows_stack(torch, 1_000_000, seed=5)
        enc, _ = CC.get_codec(spec).encode(x, seed=5)
        enc = inject_wire(enc, F, "scale_poison", seed=5)
        p, mult = CC.get_codec(spec).dequant_form(enc.payload, enc.sidecar)
        k7 += k7_blocks(torch, f"{spec} scale_poison d=1000000",
                        p.contiguous(), mult.float().contiguous(), RECT_WS,
                        worst)
        del x, enc, p, mult
    p8 = torch.zeros((6, 64), dtype=torch.int8, device="cuda")
    m6 = torch.ones(6, device="cuda")
    try:
        dequant_stats_rect_cuda(p8[:3], m6[:3], p8.to(torch.bfloat16), m6)
        check(False, "K7 took an int8 block against a bf16 payload")
    except ValueError as e:
        check("payload dtypes differ" in str(e), f"K7 mixed types: {e}")
    for dtype in (torch.float32, torch.bfloat16):
        cases = [(n, d, False) for n in K4_NS for d in CHECK_WIDTHS]
        cases.append((N, 1_000_000, True))
        for n, d, attacked in cases:
            x = rows_stack(torch, d, seed=n * 17 + d, n=n)
            if attacked:
                x = with_inf_attack(torch, x)
            x = x.to(dtype)
            got = pairwise_sqdist_cuda(x)
            raw, sq = pairwise_stats_cuda(x.float().contiguous())
            plain = ref.pairwise_sqdist_ref(x)
            torch.cuda.synchronize()
            check(same_bits(torch, got, api.finalize_dists(raw)),
                  f"K4 {dtype} n={n} d={d}: differs from finalize_dists(K1)")
            diag = torch.diagonal(got)
            fin = torch.isfinite(sq)
            check(bool((diag[fin] == 0).all()),
                  f"K4 {dtype} n={n} d={d}: a finite row's diagonal is not 0")
            err, rel = stats_err(torch, got, sq, plain, sq)
            check(rel <= K1_TOL, f"K4 {dtype} n={n} d={d}: relative error "
                  f"{rel:.3e} > {K1_TOL} against its plain version")
            worst["pairwise_sqdist"] = max(worst["pairwise_sqdist"], err)
            k4 += 1
            del x, got, raw, sq, plain
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    log(f"K6: {k6} row blocks and copies (n in {list(RECT_NS)}, W in "
        f"{list(RECT_WS)}, d in {list(CHECK_WIDTHS)}; inf attack; embedding "
        f"rank 1 of {MESH_W}) equal K1's rows and each other bit for bit, "
        f"every view block of a stack of at most 16 rows on the view path; "
        f"K7: {k7} row blocks (int8, "
        f"bf16, qsgd and bf16 scale_poison wires) equal K5's rows bit for "
        f"bit, a mixed-type call refused; K4: {k4} stacks (fp32, bf16) equal "
        f"finalize_dists(K1) bit for bit; worst abs err against the plain "
        f"versions {worst}")
    return worst


def mesh_statistics(torch):
    """The mesh-native statistics of one batch's real gradients (the
    training phase's configuration, ``inf`` attack) in a one-rank NCCL
    world (``make_host_mesh()``, 1x1), through ``compute_stats(row_block,
    mesh_ctx=, use_kernels=True)``: the tree, then QSGD int8 and bf16
    wires forged by ``scale_poison``.  Every count is set to 0 just before
    each and read just after: K6 (tree) or K7 (wires) once per leaf, no
    other kernel, every launch on the square kernel's symmetric grid (the
    one rank's block is the gathered stack itself, so K6 / K7 run K1's /
    K5's grid from their own sources).  Dists and norms must equal the
    replicated kernel path bit for bit, with the same multi-Bulyan, multi-Krum and Krum plans and
    no plan mass on the forged rows.  The process group is destroyed
    after.  Then, in this process, the row blocks of a MESH_W-rank mesh
    (n_loc = 3 of n_pad = 12): K6 on each block leaf by leaf, as
    ``sharded_raw_stats`` runs on each rank, assembled into the raw (n, n)
    that must equal the replicated raw sum bit for bit; the same with K7
    on the int8 wire; every launch there on the rectangular grid.  Returns
    {"tree": counts, "wire": counts} of the NCCL world and {"tree_block":
    n, "wire_block": n}, the rectangular-grid launches of the blocks."""
    import torch.distributed as dist
    from repro_torch.comm import codecs as CC
    from repro_torch.core import api
    from repro_torch.dist import inject_wire
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.tree import tree_leaves
    grads = real_gradients(torch)
    leaves = len(tree_leaves(grads))
    with torch.no_grad():
        wires = {}
        for spec in ("qsgd:bits=8", "bf16"):
            enc, _ = CC.get_codec(spec).encode(grads, seed=11)
            wires[spec] = inject_wire(enc, F, "scale_poison", seed=11)
    cases = (("tree (inf)", grads, "pairwise_stats_rect"),
             ("qsgd:bits=8 scale_poison", wires["qsgd:bits=8"],
              "dequant_stats_rect"),
             ("bf16 scale_poison", wires["bf16"], "dequant_stats_rect"))
    counts = {}
    t0 = time.perf_counter()
    mesh = make_host_mesh()
    try:
        ctx = api.MeshContext.for_mesh(mesh)
        check((ctx.worker_size, ctx.model_size) == (1, 1) and
              dist.get_backend() == "nccl",
              f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))} on "
              f"{dist.get_backend()}, want a 1x1 NCCL mesh")
        for label, g, kernel in cases:
            with torch.no_grad():
                want = api.compute_stats(g, F, use_kernels=True)
                block = api.row_block(g, ctx)
                ops.reset_launch_counts()
                got = api.compute_stats(block, F, use_kernels=True,
                                        mesh_ctx=ctx)
                torch.cuda.synchronize()
                c = ops.launch_counts()
                square = ops.square_launch_counts()[kernel]
            want_c = {k: 0 for k in c}
            want_c[kernel] = leaves
            check(c == want_c, f"mesh {label}: launches {c}, want {want_c}")
            check(square == leaves, f"mesh {label}: {square} of {leaves} "
                  f"{kernel} launches on the symmetric grid, want all (the "
                  f"block is the stack)")
            check(same_bits(torch, got.dists, want.dists) and
                  same_bits(torch, got.sq_norms, want.sq_norms),
                  f"mesh {label}: statistics differ from the replicated "
                  f"kernel path")
            for rule in ("multi_bulyan", "multi_krum", "krum"):
                agg = api.get_aggregator(rule)
                pg, pw = agg.plan(got), agg.plan(want)
                same = all(
                    (a is None and b is None) or torch.equal(a, b)
                    for a, b in ((pg.weights, pw.weights),
                                 (pg.w_ext, pw.w_ext), (pg.w_agr, pw.w_agr)))
                check(same and pg.beta == pw.beta,
                      f"mesh {label}: {rule} plan differs")
                byz = float(torch.sum(pg.selection_weights()[:F]))
                check(byz == 0.0, f"mesh {label}: {rule} byzantine mass "
                      f"{byz}")
            counts[label] = c
            log(f"mesh 1x1 NCCL {label}: launches {c}, all {kernel} on the "
                f"symmetric grid; dists and norms "
                f"equal the replicated kernel path bit for bit; multi_bulyan, "
                f"multi_krum and krum plans identical, byzantine mass 0")
            del want, got, block
    finally:
        dist.destroy_process_group()
    wall = time.perf_counter() - t0
    assembled = [("K6 tree (inf)", grads, False),
                 ("K7 qsgd:bits=8 scale_poison", wires["qsgd:bits=8"], True)]
    with torch.no_grad():
        blocks = [mesh_blocks(torch, label, g, wire)
                  for label, g, wire in assembled]
    del grads, wires
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    log(f"mesh statistics phase: {wall:.1f}s for the NCCL world's three "
        f"passes (with the replicated passes they are held to)")
    return {"tree": counts["tree (inf)"],
            "wire": counts["qsgd:bits=8 scale_poison"],
            "tree_block": blocks[0], "wire_block": blocks[1]}


def mesh_blocks(torch, label, g, wire):
    """The MESH_W row blocks of a tree or wire container, each block's
    kernel leaf by leaf into its running (n_loc, n_pad) sum, assembled:
    bit for bit the replicated raw statistics of the square kernel.  The
    counts are set to 0 after the replicated pass: K6 (K7) must launch
    once per block and leaf, each on the rectangular grid, nothing else.
    Returns that launch count."""
    from repro_torch.comm import codecs as CC
    from repro_torch.core import api
    from repro_torch.kernels import ops
    from repro_torch.kernels.dequant_stats import dequant_stats_rect_cuda
    from repro_torch.kernels.pairwise_sqdist import pairwise_stats_rect_cuda
    from repro_torch.tree import tree_leaves
    raw_want, sq_want = api.raw_pairwise_stats(g, use_kernels=True)
    ops.reset_launch_counts()
    n_loc = -(-N // MESH_W)
    tot_d = [torch.zeros((n_loc, n_loc * MESH_W), dtype=torch.float32,
                         device="cuda") for _ in range(MESH_W)]
    tot_s = [torch.zeros((n_loc * MESH_W,), dtype=torch.float32,
                         device="cuda") for _ in range(MESH_W)]
    if wire:
        codec = CC.get_codec(g.spec)
        items = [codec.dequant_form(p, s) for p, s in
                 zip(tree_leaves(g.payload), CC.sidecar_leaves(g))]
    else:
        items = [(x.reshape(N, -1), None) for x in tree_leaves(g)]
    for p, mult in items:
        pf, _ = padded(torch, p.contiguous(), MESH_W)
        mf = None if mult is None else \
            padded(torch, mult.float().contiguous(), MESH_W)[0]
        for r in range(MESH_W):
            rows = slice(r * n_loc, (r + 1) * n_loc)
            if wire:
                dd, sq = dequant_stats_rect_cuda(pf[rows], mf[rows], pf, mf,
                                                 n=N)
            else:
                dd, sq = pairwise_stats_rect_cuda(pf[rows], pf, n=N)
            tot_d[r] = tot_d[r] + dd
            tot_s[r] = tot_s[r] + sq
        del pf, mf
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    kernel = "dequant_stats_rect" if wire else "pairwise_stats_rect"
    want_c = {k: 0 for k in counts}
    want_c[kernel] = MESH_W * len(items)
    check(counts == want_c, f"{label}: launches {counts}, want {want_c}")
    square = ops.square_launch_counts()[kernel]
    check(square == 0, f"{label}: {square} launches on the symmetric grid, "
          f"want none (a block of {n_loc} rows is not the stack)")
    if not wire:
        view = ops.view_launch_counts()[kernel]
        check(view == want_c[kernel], f"{label}: {view} launches on the "
              f"view path, want all {want_c[kernel]} (each block is rows "
              f"of a {n_loc * MESH_W}-row stack)")
    got = torch.cat(tot_d)[:N, :N]
    check(same_bits(torch, got, raw_want) and
          all(same_bits(torch, s[:N], sq_want) for s in tot_s),
          f"{label}: {MESH_W} row blocks assembled differ from the "
          f"replicated raw statistics")
    plan_g, plan_w = plan_of(got), plan_of(raw_want)
    check(torch.equal(plan_g.w_ext, plan_w.w_ext) and
          torch.equal(plan_g.w_agr, plan_w.w_agr),
          f"{label}: the assembled plan differs")
    log(f"{label}: the {MESH_W} row blocks of {len(items)} leaves (n_loc "
        f"{n_loc} of n_pad {n_loc * MESH_W}, {want_c[kernel]} launches of "
        f"the rectangular grid{'' if wire else ', all on its view path'}) "
        f"assembled equal the replicated raw (n, n) and every rank's norms "
        f"bit for bit; plan identical")
    return want_c[kernel]


def rank_tile(torch, x, W, w, M, k):
    """The (n_pad, d/M) tile that rank (w, k) of a W x M mesh gathers for
    the (N, d) leaf rows ``x``: every worker shard's row block
    (``core.api.row_block``) cut to model index k's column tile, as
    ``core.api._sharded_apply_leaf`` cuts it, stacked in worker order as
    the all-gather stacks it."""
    from repro_torch.core import api

    def rank(v):
        return types.SimpleNamespace(worker_size=W, worker_index=v,
                                     model_size=M, model_index=k)

    return torch.cat([api._tile2d(api.row_block(x, rank(v)).rows, rank(v))
                      for v in range(W)])


def tiles_k2(torch, mesh, leaves, want, we_p, wa_p, beta, W, M):
    """Every rank's K2 launch on its tile: the ranks of one model index
    alike, the tiles assembled over the model index bit for bit the
    replicated K2 output ``want`` of every leaf."""
    from repro_torch.kernels import ops
    for i, x in enumerate(leaves):
        parts = []
        for k in range(M):
            outs = [ops.fused_select(rank_tile(torch, x, W, w, M, k), we_p,
                                     wa_p, beta) for w in range(W)]
            check(all(same_bits(torch, o, outs[0]) for o in outs[1:]),
                  f"mesh tiles {mesh} K2 leaf {i}: the ranks of model "
                  f"index {k} disagree")
            parts.append(outs[0])
            del outs
        check(same_bits(torch, torch.cat(parts)[:x.shape[1]], want[i]),
              f"mesh tiles {mesh} K2 leaf {i} ({tuple(x.shape)}): the "
              f"assembled tiles differ from the replicated output")
        del parts


def tiles_k3(torch, mesh, leaves, want, we, wa, we_p, wa_p, beta, W, M):
    """Every rank's K3 route: the two products on its tile (the weights
    zero-padded), then K3, held bit for bit to K3's plain version on those
    products; and K3 on the rank's columns of the replicated route's
    products, which must give the replicated K3 output ``want`` there bit
    for bit.  The route's own output must equal the replicated route's bit
    for bit in every column where the tile's products equal the replicated
    products, and at M = 1 (the zero rows alone, no column tiling) the
    products must be equal everywhere.  At M > 1 cuBLAS may take another
    kernel for the tile's width than for the leaf's, and then sums a
    product in another order (ROADMAP.md queue 3): that is allowed only in
    the leaves of a width in ``K3_ROUTE_WIDTHS``, and there the outputs
    must lie within ``K3_ROUTE_TOL`` x max|x| of the leaf's replicated
    ones.  Returns (columns whose products differ, outputs that differ
    there, the largest absolute output difference, the widths of the
    leaves where they differ)."""
    from repro_torch.kernels import ops, ref
    cols_diff = out_diff = 0
    worst = 0.0
    widths = set()
    for i, x in enumerate(leaves):
        numel = x.shape[1]
        pe, pa = torch.matmul(we, x), torch.matmul(wa, x)
        tol = K3_ROUTE_TOL * float(torch.max(torch.abs(x)))
        for k in range(M):
            first = None
            for w in range(W):
                tile = rank_tile(torch, x, W, w, M, k)
                ge, ga = torch.matmul(we_p, tile), torch.matmul(wa_p, tile)
                del tile
                out = ops.coord_select(ge, ga, beta)
                check(same_bits(torch, out, ref.coord_select_ref(ge, ga,
                                                                 beta)),
                      f"mesh tiles {mesh} K3 leaf {i} rank ({w}, {k}): "
                      f"differs from its plain version")
                m = ge.shape[1]
                cols = slice(k * m, min((k + 1) * m, numel))
                rep = ops.coord_select(pe[:, cols].contiguous(),
                                       pa[:, cols].contiguous(), beta)
                check(same_bits(torch, rep, want[i][cols]),
                      f"mesh tiles {mesh} K3 leaf {i} rank ({w}, {k}): on "
                      f"the replicated products' columns it differs from "
                      f"the replicated launch")
                mc = rep.shape[0]
                same = torch.all(ge[:, :mc] == pe[:, cols], dim=0) & \
                    torch.all(ga[:, :mc] == pa[:, cols], dim=0)
                check(same_bits(torch, out[:mc][same], rep[same]),
                      f"mesh tiles {mesh} K3 leaf {i} rank ({w}, {k}): "
                      f"differs where its products are the replicated ones")
                diff = ~same
                if bool(diff.any()):
                    check(M > 1, f"mesh tiles {mesh} K3 leaf {i}: the "
                          f"zero-padded products differ from the "
                          f"replicated ones")
                    check(numel in K3_ROUTE_WIDTHS, f"mesh tiles {mesh} K3 "
                          f"leaf {i} ({numel} wide): the tile's products "
                          f"differ from the replicated ones in "
                          f"{int(diff.sum())} columns, outside the widths "
                          f"{K3_ROUTE_WIDTHS} where cuBLAS may sum in "
                          f"another order")
                    err = float(torch.max(torch.abs(out[:mc][diff]
                                                    - rep[diff])))
                    check(err <= tol, f"mesh tiles {mesh} K3 leaf {i} rank "
                          f"({w}, {k}): {err:.3e} from the replicated "
                          f"route where the products differ, over "
                          f"{tol:.3e} ({K3_ROUTE_TOL} x max|x|)")
                if first is None:
                    first = out
                    cols_diff += int(diff.sum())
                    out_diff += int((out[:mc][diff] != rep[diff]).sum())
                    if bool(diff.any()):
                        widths.add(numel)
                        worst = max(worst, err)
                check(same_bits(torch, out, first), f"mesh tiles {mesh} K3 "
                      f"leaf {i}: the ranks of model index {k} disagree")
                del ge, ga, out, rep, same, diff
        del pe, pa
    return cols_diff, out_diff, worst, sorted(widths)


def mesh_tiles(torch):
    """The mesh apply's tiles on one batch's real gradients (the training
    phase's configuration, ``inf`` attack) and their plan, every rank of a
    2x2 and a 4x1 mesh emulated in this process (n_pad = 12 of n = 11):
    each rank's K2 launch on its tile (:func:`rank_tile`) with the plan's
    weights zero-padded to n_pad (:func:`tiles_k2`: bit for bit the
    replicated K2), and each rank's K3 route (:func:`tiles_k3`).  Every
    count is set to 0 just before each mesh's K2 and K3 passes and read
    just after: W M K2 launches per leaf; 2 W M K3 launches per leaf (the
    route's, and K3 on the replicated products' columns), nothing else.
    Then one rank's K2 tiles per step are timed (CUDA events) beside the
    replicated K2 on the same leaves, with their bounds.  Returns
    ({"<W>x<M> k2|k3": counts}, {mesh: ms, "replicated": ms}, {mesh:
    bound}, bound_by)."""
    from repro_torch.core import api
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_select import fused_select_cuda
    from repro_torch.tree import tree_leaves
    grads = real_gradients(torch)
    leaves = [x.reshape(N, -1) for x in tree_leaves(grads)]
    backend = api.AggregatorBackend("multi_bulyan", F)
    with torch.no_grad():
        plan = backend.plan(backend.stats(grads))
        byz = float(torch.sum(plan.selection_weights()[:F]))
        check(byz == 0.0, f"mesh tiles: byzantine plan mass {byz}")
        we = plan.w_ext.float().contiguous()
        wa = plan.w_agr.float().contiguous()
        beta, theta = plan.beta, we.shape[0]
        want = {"k2": [ops.fused_select(x, we, wa, beta) for x in leaves],
                "k3": [ops.coord_select(torch.matmul(we, x),
                                        torch.matmul(wa, x), beta)
                       for x in leaves]}
    counts, ms, bound = {}, {}, {}
    b_bytes, b_ops = {}, {}
    for W, M in TILE_MESHES:
        mesh = f"{W}x{M}"
        n_pad = W * -(-N // W)
        we_p = api._pad_cols(we, n_pad).contiguous()
        wa_p = api._pad_cols(wa, n_pad).contiguous()
        for name, kernel, per_leaf in (("k2", "fused_select", W * M),
                                       ("k3", "coord_select", 2 * W * M)):
            ops.reset_launch_counts()
            with torch.no_grad():
                if name == "k2":
                    tiles_k2(torch, mesh, leaves, want["k2"], we_p, wa_p,
                             beta, W, M)
                else:
                    k3_diff = tiles_k3(torch, mesh, leaves, want["k3"], we,
                                       wa, we_p, wa_p, beta, W, M)
                torch.cuda.synchronize()
            c = ops.launch_counts()
            want_c = {key: 0 for key in c}
            want_c[kernel] = per_leaf * len(leaves)
            check(c == want_c, f"mesh tiles {mesh} {name}: launches {c}, "
                  f"want {want_c}")
            if name == "k2":
                k2_variant_check(f"mesh tiles {mesh}", c["fused_select"])
            counts[f"{mesh} {name}"] = c
        # one rank's K2 tiles per step: rank (0, 0); the stack rows read
        # once, the (m,) result written once, the weights read once; fp32
        # operations as the timing phase counts K2's
        ms[mesh] = 0.0
        b_bytes[mesh] = b_ops[mesh] = 0.0
        for x in leaves:
            tile = rank_tile(torch, x, W, 0, M, 0)
            m = tile.shape[1]
            ms[mesh] += time_ms(torch, lambda: fused_select_cuda(
                tile, we_p, wa_p, beta), 5 if m > 10_000_000 else 20)
            b = k2_bound_s(n_pad, m, theta, beta)
            b_bytes[mesh] += b["bytes"]
            b_ops[mesh] += b["operations"]
            del tile
        log(f"mesh tiles {mesh}: {W * M} ranks x {len(leaves)} leaves "
            f"(n_pad {n_pad}, weights zero-padded), the ranks of a model "
            f"index alike; K2 tiles assembled bit for bit the replicated "
            f"K2; K3 bit for bit its plain version on every route's "
            f"products and the replicated launch on the replicated "
            f"products' columns; the route's products differ from the "
            f"replicated ones in {k3_diff[0]} columns (cuBLAS's kernel for "
            f"the tile's width; leaves of width {k3_diff[3]}), its outputs "
            f"in {k3_diff[1]} of them (largest difference "
            f"{k3_diff[2]:.3e}, within {K3_ROUTE_TOL} x max|x|), bit for "
            f"bit elsewhere; "
            f"launches {counts[f'{mesh} k2']} and {counts[f'{mesh} k3']}")
    ms["replicated"] = 0.0
    b_bytes["replicated"] = b_ops["replicated"] = 0.0
    for x in leaves:
        m = x.shape[1]
        ms["replicated"] += time_ms(torch, lambda: fused_select_cuda(
            x, we, wa, beta), 5 if m > 10_000_000 else 20)
        b = k2_bound_s(N, m, theta, beta)
        b_bytes["replicated"] += b["bytes"]
        b_ops["replicated"] += b["operations"]
    for key in ms:
        bound[key] = 1e3 * max(b_bytes[key], b_ops[key])
    bound_by = {key: "bytes" if b_bytes[key] >= b_ops[key] else "operations"
                for key in ms}
    log(f"mesh tiles: one rank's K2 tiles per step (ms, CUDA events, the "
        f"real leaves) {ms}, bounds {bound} ({bound_by})")
    del grads, leaves, want
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    return counts, ms, bound, bound_by


class Tee(io.TextIOBase):
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.kept = out, io.StringIO()

    def write(self, text):
        self.kept.write(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def train_phase(torch, label, argv, want_per_leaf_step, *, zero_byz=True,
                keep_params=False, theta=THETA_MAIN):
    """One ``train.run`` with every launch count set to 0 just before and
    read just after; each kernel must launch ``want_per_leaf_step[name]``
    times per leaf per step (0: never), every K2 launch on the variant of
    ``theta``.  Returns (counts, leaf shapes, records, printed text, the
    final parameters if ``keep_params`` else None)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves
    torch.cuda.reset_peak_memory_stats()
    tee = Tee(sys.stdout)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        params, history = train.run(argv)
    counts = ops.launch_counts()
    wall = time.perf_counter() - t0
    shapes = [(N,) + tuple(p.shape) for p in tree_leaves(params)]
    if not keep_params:
        params = None
        torch.cuda.empty_cache()
    steps = len(history)
    want_steps = int(argv[argv.index("--steps") + 1])
    check(steps == want_steps, f"{label}: {steps} steps, want {want_steps}")
    for i, rec in enumerate(history):
        check(math.isfinite(rec["loss"]) and all(
            math.isfinite(v) for v in rec["loss_per_worker"]),
            f"{label} step {i}: non-finite loss {rec['loss']}")
        if zero_byz:
            check(rec["byz_mass"] == 0.0, f"{label} step {i}: byzantine "
                  f"selection mass {rec['byz_mass']}")
    want = {name: k * len(shapes) * steps
            for name, k in want_per_leaf_step.items()}
    check(counts == want, f"{label}: launches {counts}, want {want} "
          f"({len(shapes)} leaves x {steps} steps)")
    variants = k2_variant_check(label, counts["fused_select"], theta)
    step_s = [rec["seconds"] for rec in history]
    log(f"{label}: {steps} steps, losses "
        f"{[round(r['loss'], 4) for r in history]}, byz_mass "
        f"{[r['byz_mass'] for r in history]}, launches {counts} = "
        f"{len(shapes)} leaves x {steps} steps, K2 variants {variants}; step "
        f"seconds "
        f"{[round(s, 4) for s in step_s]} (first includes warm-up); wall "
        f"{wall:.1f}s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return counts, shapes, history, tee.kept.getvalue(), params


def training(torch):
    """The training phase; returns (counts, leaf shapes, records, the
    final parameters, the peak device memory in bytes), the parameters
    for the mesh training and streaming phases."""
    counts, shapes, history, _, params = train_phase(
        torch, "training", TRAIN_ARGS, K1_K2, keep_params=True)
    return counts, shapes, history, params, torch.cuda.max_memory_allocated()


def to_host(params):
    """A copy of ``params`` in host memory (frees the card's for the next
    phase's peak; :func:`same_run` compares across devices)."""
    from repro_torch.tree import tree_map
    return tree_map(lambda p: p.cpu(), params)


def same_run(torch, label, hist, params, want_hist, want_params):
    """Two runs of ``train.run`` alike bit for bit: every step's loss,
    per-worker losses, selection and byzantine mass, and the parameters
    after the last step."""
    from repro_torch.tree import tree_leaves
    check(len(hist) == len(want_hist), f"{label}: {len(hist)} steps")
    for i, (a, b) in enumerate(zip(hist, want_hist)):
        for key in ("loss", "loss_per_worker", "selection", "byz_mass"):
            check(a[key] == b[key], f"{label} step {i}: {key} {a[key]} "
                  f"against the replicated run's {b[key]}")
    pairs = list(zip(tree_leaves(params), tree_leaves(want_params)))
    check(len(pairs) == len(tree_leaves(want_params)) and
          all(bits_equal(torch, a.cpu(), b.cpu()) for a, b in pairs),
          f"{label}: parameters after {len(hist)} steps differ from the "
          f"replicated run's")


def mesh_run(torch, label, argv, want_per_leaf_step, kernel, want_hist,
             want_params):
    """``train.run`` of ``argv`` with ``--mesh host``: the one-rank NCCL
    world (1x1) that ``run`` starts and destroys, every ``kernel`` launch
    (the mesh statistics) on the square kernel's symmetric grid, the mesh
    line printed, and the run bit for bit the replicated one
    (:func:`same_run`; at 1x1 the gathered tile is the stack itself).
    Returns the counts."""
    import torch.distributed as dist
    from repro_torch.kernels import ops
    check(not dist.is_initialized(), f"{label}: a process group is up")
    counts, _, hist, text, params = train_phase(
        torch, label, argv + ["--mesh", "host"], want_per_leaf_step,
        keep_params=True)
    square = ops.square_launch_counts()[kernel]
    check(square == counts[kernel], f"{label}: {square} of "
          f"{counts[kernel]} {kernel} launches on the symmetric grid, want "
          f"all (the 1x1 block is the stack)")
    check(not dist.is_initialized(), f"{label}: run() left its process "
          f"group up")
    line = "[train] mesh=host shape={'data': 1, 'model': 1} (worker axis " \
        "sharded over data, d over model)"
    check(line in text, f"{label}: no line {line!r}")
    same_run(torch, label, hist, params, want_hist, want_params)
    log(f"{label}: {line}; every {kernel} launch on the symmetric grid; "
        f"losses, per-worker losses, selections, byzantine mass and the "
        f"parameters after {len(hist)} steps bit for bit the replicated "
        f"run's")
    del params
    torch.cuda.empty_cache()
    return counts


def mesh_training(torch, want_hist, want_params):
    """The training phase again with ``--mesh host``: K6 and K2 once per
    leaf per step (K6 on the symmetric grid), K1 never, bit for bit the
    training phase.  Returns the counts."""
    return mesh_run(torch, "mesh training (--mesh host)", TRAIN_ARGS,
                    MESH_K6_K2, "pairwise_stats_rect", want_hist,
                    want_params)


def mesh_wire_training(torch):
    """Wire A's flags at 1 layer for 2 steps, replicated (K5 and K2 once
    per leaf per step), then with ``--mesh host`` (K7 on the symmetric grid
    and K2, K5 never): bit for bit alike.  Returns the mesh run's counts
    and the replicated run's records and final parameters (on the host),
    for the streaming wire phase."""
    label = "mesh wire (qsgd:bits=8, scale_poison)"
    _, _, hist, _, params = train_phase(
        torch, f"{label}, replicated", MESH_WIRE_ARGS, K5_K2,
        keep_params=True)
    params = to_host(params)
    torch.cuda.empty_cache()
    counts = mesh_run(torch, f"{label}, --mesh host", MESH_WIRE_ARGS,
                      MESH_K7_K2, "dequant_stats_rect", hist, params)
    return counts, hist, params


def streaming_training(torch, power, train_hist, train_params, train_peak,
                       wire_hist, wire_params):
    """The streaming trainer's phases through the launcher: global scope
    at the training configuration (K1 and K2 once per leaf per step, bit
    for bit the training phase, its peak at least STREAM_PEAK_MARGIN below
    the training phase's ``train_peak``), then with ``--mesh host`` (K6
    on the symmetric grid and K2, bit for bit streaming global); block
    scope (K1 and K2, byzantine mass 0); global scope on the mesh wire
    phase's flags (K5 and K2, bit for bit its replicated run); global
    scope at 8 layers (:func:`streaming_at_depth`).  Returns {phase:
    counts}."""
    label = "streaming global (--trainer stream_global)"
    counts = {}
    counts["stream_global"], _, hist, _, params = train_phase(
        torch, label, STREAM_GLOBAL_ARGS, K1_K2, keep_params=True)
    peak = torch.cuda.max_memory_allocated()
    params = to_host(params)
    torch.cuda.empty_cache()
    same_run(torch, label, hist, params, train_hist, train_params)
    check(peak <= train_peak - STREAM_PEAK_MARGIN,
          f"{label}: peak memory {peak / 2**30:.2f} GiB, want at least "
          f"{STREAM_PEAK_MARGIN / 2**30:.0f} GiB below the training "
          f"phase's {train_peak / 2**30:.2f}")
    log(f"{label}: losses, per-worker losses, selections, byzantine mass "
        f"and the parameters after {len(hist)} steps bit for bit the "
        f"training phase's; peak memory {peak / 2**30:.2f} GiB against "
        f"the training phase's {train_peak / 2**30:.2f} "
        f"({(train_peak - peak) / 2**30:.2f} GiB less); card {power}")
    counts["stream_mesh"] = mesh_run(
        torch, "streaming mesh (--trainer stream_global --mesh host)",
        STREAM_GLOBAL_ARGS, MESH_K6_K2, "pairwise_stats_rect", hist, params)
    del params
    counts["stream_block"], *_ = train_phase(
        torch, "streaming block (--trainer stream_block)",
        STREAM_BLOCK_ARGS, K1_K2)
    label = "streaming wire (qsgd:bits=8, scale_poison, stream_global)"
    counts["stream_wire"], _, hist, _, params = train_phase(
        torch, label, STREAM_WIRE_ARGS, K5_K2, keep_params=True)
    same_run(torch, label, hist, params, wire_hist, wire_params)
    log(f"{label}: bit for bit the mesh wire phase's replicated run")
    del params
    torch.cuda.empty_cache()
    counts["stream_depth"] = streaming_at_depth(torch, power)
    return counts


def streaming_at_depth(torch, power):
    """Streaming global at 8 layers for 2 steps: K1 and K2 once per leaf
    per step, finite losses, byzantine mass 0; the peak device memory, the
    largest block's fp32 stack and the whole stack the stacked trainer
    would hold are logged.  Returns the counts."""
    from repro_torch.tree import tree_leaves
    label = "streaming at depth (stream_global, 8 layers)"
    counts, _, hist, _, params = train_phase(
        torch, label, STREAM_DEPTH_ARGS, K1_K2, keep_params=True)
    peak = torch.cuda.max_memory_allocated()
    stack = {k: 4 * N * sum(p.numel() for p in tree_leaves(v))
             for k, v in params.items()}
    del params
    torch.cuda.empty_cache()
    big = max(stack, key=stack.get)
    log(f"{label}: peak memory {peak / 2**30:.2f} GiB; the largest "
        f"block's stack ({big}) {stack[big] / 2**30:.2f} GiB, the whole "
        f"stack the stacked trainer would hold "
        f"{sum(stack.values()) / 2**30:.2f} GiB; steady step seconds "
        f"{[round(r['seconds'], 4) for r in hist[1:]]}; card {power}")
    return counts


def wire_training(torch):
    """Phases A and B; returns phase A's counts (the wire's main path)."""
    counts, shapes, history, text, _ = train_phase(
        torch, "wire A (qsgd:bits=8, scale_poison)", WIRE_A_ARGS,
        {"pairwise_stats": 0, "fused_select": 1, "dequant_stats": 1,
         "coord_select": 0, **NO_MESH_KERNELS})
    # qsgd:bits=8: one byte a coordinate plus one fp32 multiplier a leaf
    want = sum(math.prod(s[1:]) + 4 for s in shapes)
    line = next((ln for ln in text.splitlines()
                 if ln.startswith("[train] wire:")), "")
    check(line.startswith(f"[train] wire: {want:,} B/worker/step"),
          f"wire A: printed {line!r}, want {want:,} B/worker/step")
    check(all(rec["wire_bytes_per_worker"] == want for rec in history),
          "wire A: the step's container disagrees with the wire line")
    log(f"wire A: {line}")
    _, _, history_b, _, _ = train_phase(
        torch, "wire B (signsgd:ef=1, payload_flip)", WIRE_B_ARGS,
        {"pairwise_stats": 0, "fused_select": 1, "dequant_stats": 1,
         "coord_select": 0, **NO_MESH_KERNELS}, zero_byz=False)
    res = [rec["residual_max_abs"] for rec in history_b]
    check(all(math.isfinite(r) and r > 0.0 for r in res),
          f"wire B: error-feedback residual max |r| per step {res}")
    log(f"wire B: residual max |r| per step {res} (finite, non-zero)")
    return counts, [rec["seconds"] for rec in history]


def bits_equal(torch, a, b):
    """Same dtype, shape and bits (an integer view of the same width)."""
    if a.dtype != b.dtype or tuple(a.shape) != tuple(b.shape):
        return False
    if a.is_floating_point():
        view = {8: torch.int64, 4: torch.int32, 2: torch.int16,
                1: torch.uint8}[a.element_size()]
        a, b = a.view(view), b.view(view)
    return torch.equal(a, b)


def adaptive_training(torch):
    """Phases adaptive A (``adaptive_lie``) and B (``adaptive_mimic``)
    through the launcher: finite losses, K1 and K2 once per leaf per step
    on the theta = 5 kernel, nothing else; each step's state recomputed on
    the host in fp32 from the selection the step recorded (A: z up by 1.15
    while the byzantine rows hold half their share of the mass, else down
    by 0.7, clipped to [0.25, 16], exactly; B: trust = 0.9 trust + 0.1
    selection[f:] within 1e-6).  The byzantine mass is logged, not gated:
    these attacks are built to be selected.  Returns {phase: counts}."""
    out = {}
    counts, _, hist, _, _ = train_phase(
        torch, "adaptive A (adaptive_lie)", ADAPTIVE_A_ARGS, K1_K2,
        zero_byz=False)
    out["adaptive_lie"] = counts
    z = torch.tensor(1.0)
    share = torch.tensor(F / N)
    zs, picked = [], []
    for i, rec in enumerate(hist):
        sel = torch.tensor(rec["selection"], dtype=torch.float32)
        f_rows = max(int(torch.round(share * sel.shape[0])), 1)
        up = bool(torch.sum(sel[:f_rows]) >= 0.5 * share)
        z = torch.clamp(z * (1.15 if up else 0.7), 0.25, 16.0)
        check(rec["astate"]["z"] == float(z), f"adaptive A step {i}: z "
              f"{rec['astate']['z']!r}, recomputed {float(z)!r}")
        check(rec["astate"]["share"] == float(share),
              f"adaptive A step {i}: share {rec['astate']['share']!r}")
        zs.append(float(z))
        picked.append(up)
    log(f"adaptive A: z after each step {zs} (up: {picked}), byz_mass "
        f"{[r['byz_mass'] for r in hist]} (logged, not gated)")
    counts, _, hist, _, _ = train_phase(
        torch, "adaptive B (adaptive_mimic)", ADAPTIVE_B_ARGS, K1_K2,
        zero_byz=False)
    out["adaptive_mimic"] = counts
    trust = None
    targets, worst = [], 0.0
    for i, rec in enumerate(hist):
        sel = torch.tensor(rec["selection"], dtype=torch.float32)
        if trust is None:
            trust = torch.zeros(sel.shape[0] - F)
        targets.append(int(torch.argmax(trust)))
        trust = 0.9 * trust + 0.1 * sel[F:]
        err = float(torch.max(torch.abs(
            torch.tensor(rec["astate"]["trust"]) - trust)))
        check(err <= 1e-6, f"adaptive B step {i}: trust {rec['astate']} "
              f"against {trust.tolist()} ({err:.3e})")
        worst = max(worst, err)
    log(f"adaptive B: honest row copied at each step {targets}, trust after "
        f"the last {[round(v, 6) for v in hist[-1]['astate']['trust']]} "
        f"(largest difference from the recomputed EMA {worst:.3e}), "
        f"byz_mass {[r['byz_mass'] for r in hist]} (logged, not gated)")
    return out


def checkpoint_phase(torch, power):
    """The adaptive-A configuration at 1 layer: CKPT_STEPS trainer steps,
    then ``save`` of params, momentum and ``astate`` into a temporary
    directory and ``restore`` onto the card, every leaf bit for bit; step
    CKPT_STEPS + 1 from the restored state and from the state in memory
    must give the same losses and selection, the parameters within 1e-6
    relative (the largest difference printed).  K1 and K2 once per leaf
    per step.  Returns the counts and the file's bytes and seconds."""
    import shutil
    import tempfile
    from repro_torch import models as MD
    from repro_torch.checkpoint import restore, save
    from repro_torch.configs import RobustConfig, get_config
    from repro_torch.data import lm_batches
    from repro_torch.dist import (init_train_state, make_train_step,
                                  split_workers)
    from repro_torch.kernels import ops
    from repro_torch.optim import constant, sgd
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=1)
    rcfg = RobustConfig(n_workers=N, f=F, gar="multi_bulyan")
    opt = sgd(momentum=0.9)
    params = MD.init_model(cfg, seed=0, device="cuda")
    leaves = len(tree_leaves(params))
    state = init_train_state(opt, params, n_workers=N,
                             attack="adaptive_lie", attack_f=F)
    step = make_train_step(cfg, rcfg, opt, constant(0.05), chunk_q=128,
                           attack="adaptive_lie", telemetry=True)
    data = lm_batches(cfg.vocab_size, 2 * N, 128, seed=0)

    def batch():
        return {k: v.to("cuda") for k, v in split_workers(next(data),
                                                          N).items()}

    ops.reset_launch_counts()
    for i in range(CKPT_STEPS):
        params, state, _ = step(params, state, batch(), i)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        saved = {"params": params, "state": state}
        t0 = time.perf_counter()
        path = save(tmp, CKPT_STEPS, saved)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        back = restore(tmp, CKPT_STEPS, saved, device="cuda")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    pairs = list(zip(tree_leaves(params), tree_leaves(back["params"])))
    pairs += zip(tree_leaves(state.opt.mu), tree_leaves(back["state"].opt.mu))
    pairs += [(state.astate[k], back["state"].astate[k])
              for k in sorted(state.astate)]
    check(all(b.device == a.device for a, b in pairs),
          "checkpoint: a restored leaf is not on the card")
    check(all(bits_equal(torch, a, b) for a, b in pairs),
          "checkpoint: a restored leaf differs from the saved one")
    check(back["state"].opt.step == state.opt.step == CKPT_STEPS,
          f"checkpoint: opt.step {back['state'].opt.step}")
    wb = batch()
    p_mem, s_mem, m_mem = step(params, state, wb, CKPT_STEPS)
    p_back, s_back, m_back = step(back["params"], back["state"], wb,
                                  CKPT_STEPS)
    counts = ops.launch_counts()
    steps = CKPT_STEPS + 2
    want = {k: v * leaves * steps for k, v in K1_K2.items()}
    check(counts == want, f"checkpoint: launches {counts}, want {want}")
    k2_variant_check("checkpoint", counts["fused_select"])
    check(torch.equal(m_mem["loss_per_worker"], m_back["loss_per_worker"]),
          "checkpoint: the restored state's step gives other losses")
    sel_mem = m_mem["telemetry"]["selection"]
    check(torch.equal(sel_mem, m_back["telemetry"]["selection"]),
          "checkpoint: the restored state's step selects otherwise")
    diff = max(float(torch.max(torch.abs(a - b)) /
                     max(1.0, float(torch.max(torch.abs(a)))))
               for a, b in zip(tree_leaves(p_mem), tree_leaves(p_back)))
    check(diff <= 1e-6, f"checkpoint: parameters after the restored "
          f"state's step differ by {diff:.3e} (relative)")
    check(bits_equal(torch, s_mem.astate["z"], s_back.astate["z"]),
          "checkpoint: z after the restored state's step differs")
    log(f"checkpoint ({cfg.n_layers} layer, adaptive_lie, {CKPT_STEPS} "
        f"steps): {size:,} bytes, save {save_s:.3f}s, restore onto the card "
        f"{restore_s:.3f}s; card {power}; {len(pairs)} leaves and opt.step "
        f"bit for bit; step {CKPT_STEPS + 1} from both states: losses and "
        f"selection equal, largest parameter difference {diff:.3e} "
        f"(relative); launches {counts} = {leaves} leaves x {steps} steps")
    del params, state, back, p_mem, s_mem, p_back, s_back, saved
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    return counts, size, save_s, restore_s


def quickstart(torch):
    """``examples/quickstart_torch.py`` on the card: part 1's multi-Bulyan
    cosine above 0.9; part 2's 8 losses finite, K1 and K2 once per leaf per
    step, nothing else.  Returns part 2's counts."""
    import importlib.util
    from repro_torch import models as MD
    from repro_torch.kernels import ops
    from repro_torch.tree import tree_leaves
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", os.path.join(ROOT, "examples",
                                         "quickstart_torch.py"))
    qs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(qs)
    cosines = qs.part1_gar("cuda")
    check(cosines["multi_bulyan"] > 0.9,
          f"quickstart: multi_bulyan cosine {cosines['multi_bulyan']}")
    leaves = len(tree_leaves(MD.init_model(qs.CFG, device="cpu")))
    ops.reset_launch_counts()
    losses = qs.part2_training("cuda")
    counts = ops.launch_counts()
    check(len(losses) == 8 and all(math.isfinite(v) for v in losses),
          f"quickstart: losses {losses}")
    want = {k: v * leaves * len(losses) for k, v in K1_K2.items()}
    check(counts == want, f"quickstart: launches {counts}, want {want}")
    k2_variant_check("quickstart", counts["fused_select"])
    log(f"quickstart: cosines {cosines}; losses "
        f"{[round(v, 4) for v in losses]}; launches {counts} = {leaves} "
        f"leaves x {len(losses)} steps")
    ops.reset_launch_counts()
    return counts


# ---------------------------------------------------------------- serving
def serving_config(layers=0):
    from repro_torch.configs import get_config
    cfg = get_config("qwen2-1.5b")
    return dataclasses.replace(cfg, n_layers=layers) if layers else cfg


def serve_prompt(torch, batch, length, seed):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return torch.randint(0, 151936, (batch, length), generator=gen,
                         device="cuda", dtype=torch.int32)


def wall_s(torch, fn):
    """Seconds of ``fn()`` on the host clock, the device synchronised
    before and after; returns (seconds, fn's result)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def serve_and_time(torch, power, label, argv, cfg, *, profile=False):
    """``launch/serve.py`` with ``argv`` (batch SERVE_BATCH, prompt
    SERVE_PROMPT, SERVE_NEW new tokens): every token in the vocabulary,
    the three ``[serve]`` lines, no kernel launched.  Then on the same
    parameters (and the VLM prefix, if any): prefill seconds (median of
    3), the decode step's ms a token (SERVE_NEW - 1 greedy steps, every
    logit finite) beside its weight-read bound, and the prefill logits
    against the forward's.  Returns the counts, the numbers and the
    prefill and forward logits."""
    from repro_torch import models as MD
    from repro_torch.dist.serving import make_serve_step
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.tree import tree_leaves
    tee = Tee(sys.stdout)
    ops.reset_launch_counts()
    with contextlib.redirect_stdout(tee):
        rec = serve.run(argv)
    counts = ops.launch_counts()
    check(counts == NO_KERNELS, f"{label}: launches {counts}, want none")
    toks = rec["tokens"]
    check(tuple(toks.shape) == (SERVE_BATCH, SERVE_NEW) and
          toks.dtype == torch.int32 and
          bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          f"{label}: tokens {tuple(toks.shape)} {toks.dtype} out of range")
    text = tee.kept.getvalue()
    for line in (f"[serve] arch={cfg.name} params=",
                 f"[serve] generated ({SERVE_BATCH}, {SERVE_NEW}) tokens",
                 "[serve] first sequence: "):
        check(line in text, f"{label}: no line {line!r}")
    params, prompt = rec["params"], rec["prompt"]
    n_params = sum(p.numel() for p in tree_leaves(params))
    batch = {"tokens": prompt, **(rec["extra"] or {})}
    n_prefix = cfg.n_patches if rec["extra"] else 0
    cache_len = n_prefix + SERVE_PROMPT + SERVE_NEW

    def prefill():
        return MD.prefill_fn(params, cfg, batch, chunk_q=SERVE_PROMPT,
                             cache_len=cache_len)

    times = []
    for _ in range(3):
        dt, (logits, cache) = wall_s(torch, prefill)
        times.append(dt)
    prefill_s = statistics.median(times)
    step = make_serve_step(cfg)

    def decode():
        lg, c, finite = logits, cache, []
        for t in range(SERVE_NEW - 1):
            tok = torch.argmax(lg, dim=-1).int()
            lg, c = step(params, c, tok, n_prefix + SERVE_PROMPT + t)
            finite.append(torch.isfinite(lg).all())
        return torch.stack(finite).all()

    dt, finite = wall_s(torch, decode)
    check(bool(finite), f"{label}: non-finite decoded logits")
    decode_ms = 1e3 * dt / (SERVE_NEW - 1)
    if profile:
        tok = torch.argmax(logits, dim=-1).int()
        profiled(torch, f"{label}: one decode step",
                 lambda: step(params, cache, tok, n_prefix + SERVE_PROMPT))
    bound_ms = 1e3 * 4 * n_params / HBM_BYTES_PER_S
    with torch.no_grad():
        full = MD.forward_fn(params, cfg, batch, chunk_q=SERVE_PROMPT,
                             logits_tail=1)[:, -1]
    diff = float((logits.float() - full.float()).abs().max())
    out = {"seconds": rec["seconds"], "prefill_s": prefill_s,
           "decode_ms": decode_ms, "decode_bound_ms": bound_ms,
           "tok_s": SERVE_BATCH * SERVE_NEW / rec["seconds"],
           "params": n_params, "prefill_vs_forward": diff}
    log(f"{label} (launch/serve.py, {cfg.name}, {cfg.n_layers} layers, "
        f"{n_params:,} fp32 parameters, batch {SERVE_BATCH}, prompt "
        f"{SERVE_PROMPT}{f' after a {n_prefix}-patch prefix' if n_prefix else ''}, "
        f"{SERVE_NEW} new tokens): launches {counts}; "
        f"generate {rec['seconds']:.4f} s ({out['tok_s']:.1f} tok/s, first "
        f"call included); prefill {prefill_s:.4f} s (median of 3, "
        f"{[round(t, 4) for t in times]}); decode {decode_ms:.4f} ms a "
        f"token ({SERVE_NEW - 1} steps, every logit finite) against the "
        f"weight-read bound {bound_ms:.4f} ms ({4 * n_params:,} B at 3.35 "
        f"TB/s); prefill logits against the forward's: max diff {diff:.6g}; "
        f"card {power}")
    del params, rec, cache
    torch.cuda.empty_cache()
    return counts, out, logits, full


def serving(torch, power):
    """``launch/serve.py`` at all 28 layers of qwen2-1.5b, batch 4, prompt
    128, 32 new tokens (:func:`serve_and_time`, one decode step traced;
    the prefill against the forward logged, not gated).  Returns the
    counts and the numbers."""
    counts, out, _, _ = serve_and_time(
        torch, power, "serving", SERVE_ARGS, serving_config(), profile=True)
    return counts, out


def bf16_spacing(torch, x):
    """The bf16 spacing at the largest |x|: 2**(e - 7) for it in
    [2**e, 2**(e + 1))."""
    return 2.0 ** (math.floor(math.log2(float(x.float().abs().max()))) - 7)


def serving_consistency(torch, power):
    """At 2 layers: prefill and 2 decode steps against ``forward_fn`` on
    the grown prompt within SERVE_TOL, on the full cache (prompt 128) and
    the ring buffer (window 64, prompt 96: past the wrap); one decode step
    with ``seq_chunks=4`` against ``seq_chunks=1`` on each, within one
    bf16 ulp of the largest logit, and at fp32 activations within
    CHUNK_TOL.
    Returns the largest differences."""
    from repro_torch import models as MD
    cfg = serving_config(ROBUST_LAYERS)
    params = MD.init_model(cfg, seed=3, device="cuda")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    worst = {"prefill": 0.0, "decode": 0.0, "chunks_bf16": 0.0,
             "chunks_ulp": 0.0, "chunks_fp32": 0.0}
    with torch.no_grad():
        for window, length in CONSISTENCY_CASES:
            label = f"serving consistency (window {window}, prompt {length})"
            cur = {"tokens": serve_prompt(torch, SERVE_BATCH, length,
                                          seed=length + window)}
            last, cache = MD.prefill_fn(params, cfg, cur, window=window,
                                        chunk_q=length)
            full = MD.forward_fn(params, cfg, cur, window=window,
                                 logits_tail=1)[:, -1]
            err = float((last.float() - full.float()).abs().max())
            check(err <= SERVE_TOL, f"{label}: prefill against the "
                  f"forward {err}")
            worst["prefill"] = max(worst["prefill"], err)
            tok = serve_prompt(torch, SERVE_BATCH, 1, seed=7)[:, 0]
            one, _ = MD.decode_fn(params, cfg, tok, cache, length,
                                  window=window)
            four, _ = MD.decode_fn(params, cfg, tok, cache, length,
                                   window=window, seq_chunks=4)
            err = float((one.float() - four.float()).abs().max())
            ulp = bf16_spacing(torch, one)
            check(err <= ulp, f"{label}: seq_chunks=4 against 1 {err}, "
                  f"above one bf16 ulp of the largest logit ({ulp})")
            worst["chunks_bf16"] = max(worst["chunks_bf16"], err)
            worst["chunks_ulp"] = max(worst["chunks_ulp"], ulp)
            _, cache32 = MD.prefill_fn(params, cfg32, cur, window=window,
                                       chunk_q=length)
            one, _ = MD.decode_fn(params, cfg32, tok, cache32, length,
                                  window=window)
            four, _ = MD.decode_fn(params, cfg32, tok, cache32, length,
                                   window=window, seq_chunks=4)
            err = float((one - four).abs().max())
            check(err <= CHUNK_TOL, f"{label}: seq_chunks=4 against 1 at "
                  f"fp32 activations {err}")
            worst["chunks_fp32"] = max(worst["chunks_fp32"], err)
            del cache32
            for step in range(CONSISTENCY_STEPS):
                tok = serve_prompt(torch, SERVE_BATCH, 1,
                                   seed=100 + step)[:, 0]
                cur = {"tokens": torch.cat([cur["tokens"], tok[:, None]],
                                           dim=1)}
                want = MD.forward_fn(params, cfg, cur, window=window,
                                     logits_tail=1)[:, -1]
                got, cache = MD.decode_fn(params, cfg, tok, cache,
                                          length + step, window=window)
                err = float((got.float() - want.float()).abs().max())
                check(err <= SERVE_TOL, f"{label}: decode step {step} "
                      f"against the forward {err}")
                worst["decode"] = max(worst["decode"], err)
    log(f"serving consistency ({cfg.n_layers} layers, batch {SERVE_BATCH}, "
        f"cases {CONSISTENCY_CASES}): largest differences, prefill "
        f"{worst['prefill']:.6g} and decode {worst['decode']:.6g} against "
        f"the forward (bound {SERVE_TOL}); seq_chunks=4 against 1 at bf16 "
        f"{worst['chunks_bf16']:.6g} (bound: one bf16 ulp of the largest "
        f"logit, {worst['chunks_ulp']:.6g} at most), at fp32 activations "
        f"{worst['chunks_fp32']:.6g} (bound {CHUNK_TOL}); card {power}")
    del params
    torch.cuda.empty_cache()
    return worst


def profiled(torch, label, fn, top=8):
    """``fn()`` once under ``torch.profiler`` (after a warm-up call): its
    kernels' device time against the synchronised wall time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    log_profile(torch, prof, label, wall_ms, top)


def recording_backend(rcfg):
    """The ensemble's backend, keeping every plan it makes."""
    from repro_torch.core import api

    @dataclasses.dataclass(frozen=True)
    class Recording(api.AggregatorBackend):
        plans: list = dataclasses.field(default_factory=list, compare=False)

        def plan(self, stats):
            out = super().plan(stats)
            self.plans.append(out)
            return out

    return Recording.for_config(rcfg)


def robust_serving(torch, power):
    """N replicas of qwen2-1.5b at ROBUST_LAYERS layers (N - F identical
    honest ones, replicas 0 and 1 corrupted), batch 4, prompt 128: each
    prefilled, the last logits fused by ``aggregate_replica_logits``, then
    ROBUST_NEW - 1 robust decode steps, greedy.  K1 and K2 once per token
    (K2 on the theta = 5 kernel), no other kernel; byzantine mass 0 at every
    token; the fused logits the honest model's bit for bit and the tokens
    ``generate``'s.  Then, on the first token's stack, K1 and K2 held to
    their plain versions (the plans bit for bit, K2 bit for bit) and timed
    beside their bounds.  Returns the counts and the numbers."""
    from repro_torch import models as MD
    from repro_torch.configs import RobustConfig
    from repro_torch.dist.serving import (aggregate_replica_logits, generate,
                                          make_robust_serve_step)
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fused_select import fused_select_cuda
    from repro_torch.kernels.pairwise_sqdist import pairwise_stats_cuda
    from repro_torch.tree import tree_map
    label = "robust serving"
    cfg = serving_config(ROBUST_LAYERS)
    honest = MD.init_model(cfg, seed=5, device="cuda")
    stack = tree_map(lambda t: torch.stack([t] * N), honest)
    for i, factor in enumerate(ROBUST_CORRUPT):
        stack["embed"]["table"][i] *= factor
    rcfg = RobustConfig(n_workers=N, f=F, gar="multi_bulyan",
                        use_kernels=True)
    backend = recording_backend(rcfg)
    prompt = serve_prompt(torch, SERVE_BATCH, SERVE_PROMPT, seed=11)
    cache_len = SERVE_PROMPT + ROBUST_NEW
    step = make_robust_serve_step(cfg, rcfg, backend=backend)
    ops.reset_launch_counts()
    with torch.no_grad():
        outs = [MD.prefill_fn(tree_map(lambda t: t[i], stack), cfg,
                              {"tokens": prompt}, chunk_q=SERVE_PROMPT,
                              cache_len=cache_len) for i in range(N)]
        first = torch.stack([lg for lg, _ in outs])
        caches = tree_map(lambda *xs: torch.stack(xs), *[c for _, c in outs])
        del outs
        fused = [aggregate_replica_logits(first, rcfg, backend)]
        tokens = []
        step_s = []
        for t in range(ROBUST_NEW):
            tokens.append(torch.argmax(fused[-1], dim=-1).int())
            if t + 1 < ROBUST_NEW:
                dt, (lg, caches) = wall_s(torch, lambda: step(
                    stack, caches, tokens[-1], SERVE_PROMPT + t))
                fused.append(lg)
                step_s.append(dt)
    counts = ops.launch_counts()
    want = {**NO_KERNELS, "pairwise_stats": ROBUST_NEW,
            "fused_select": ROBUST_NEW}
    check(counts == want, f"{label}: launches {counts}, want {want}")
    variants = k2_variant_check(label, ROBUST_NEW)
    byz = [float(p.diagnostics()["byz_mass"]) for p in backend.plans]
    check(len(byz) == ROBUST_NEW and all(b == 0.0 for b in byz),
          f"{label}: byzantine mass {byz}")
    with torch.no_grad():
        profiled(torch, f"{label} ({N} replicas): one step", lambda: step(
            stack, caches, tokens[-1], SERVE_PROMPT + ROBUST_NEW - 1))
    del caches
    with torch.no_grad():
        want_l, hcache = MD.prefill_fn(honest, cfg, {"tokens": prompt},
                                       chunk_q=SERVE_PROMPT,
                                       cache_len=cache_len)
        for t in range(ROBUST_NEW):
            check(fused[t].dtype == want_l.dtype and
                  torch.equal(fused[t], want_l),
                  f"{label} token {t}: fused logits differ from the honest "
                  f"model's (max diff "
                  f"{float((fused[t].float() - want_l.float()).abs().max())})")
            if t + 1 < ROBUST_NEW:
                want_l, hcache = MD.decode_fn(honest, cfg, tokens[t], hcache,
                                              SERVE_PROMPT + t)
    ref_tokens = generate(honest, cfg, prompt, ROBUST_NEW,
                          chunk_q=SERVE_PROMPT)
    got_tokens = torch.stack(tokens, dim=1)
    check(torch.equal(got_tokens, ref_tokens),
          f"{label}: ensemble tokens differ from generate's")
    del stack, fused, hcache
    torch.cuda.empty_cache()
    # K1 and K2 on the first token's stack as the backend gives it to them
    # (core/api.py: the bf16 stack cast to fp32, one (N, B*V) row a replica)
    x = first.reshape(N, -1).float().contiguous()
    m = x.shape[1]
    raw, sq = pairwise_stats_cuda(x)
    raw_p, sq_p = ref.pairwise_stats_ref(x)
    err_d = compare_k1(torch, raw, raw_p)
    err_s = compare_k1(torch, sq, sq_p)
    check(err_d[1] <= K1_TOL and err_s[1] <= K1_TOL,
          f"{label}: K1 rel err dists {err_d[1]:.3e} norms {err_s[1]:.3e} "
          f"> {K1_TOL}")
    plan, plan_p = plan_of(raw), plan_of(raw_p)
    check(plan.beta == plan_p.beta and torch.equal(plan.w_ext, plan_p.w_ext)
          and torch.equal(plan.w_agr, plan_p.w_agr),
          f"{label}: the plan from K1's distances differs from the plain "
          f"one's")
    out_k = fused_select_cuda(x, plan.w_ext, plan.w_agr, plan.beta)
    check(torch.equal(out_k, ref.fused_select_ref(x, plan.w_ext, plan.w_agr,
                                                   plan.beta)),
          f"{label}: K2 differs from its plain version on the logit stack")
    theta = plan.w_ext.shape[0]
    k1_ms = time_ms(torch, lambda: pairwise_stats_cuda(x), 50)
    k2_ms = time_ms(torch, lambda: fused_select_cuda(
        x, plan.w_ext, plan.w_agr, plan.beta), 50)
    cast_ms = time_ms(torch, lambda: first.reshape(N, -1).float()
                      .contiguous(), 50)
    k1_bound = 1e3 * 4 * (N * m + N * N + N) / HBM_BYTES_PER_S
    k2_bound = 1e3 * 4 * (N * m + m + 2 * theta * N) / HBM_BYTES_PER_S
    out = {"token_ms": 1e3 * statistics.mean(step_s),
           "token_ms_all": [round(1e3 * s, 4) for s in step_s],
           "k1_ms": k1_ms, "k2_ms": k2_ms, "cast_ms": cast_ms,
           "k1_bound_ms": k1_bound, "k2_bound_ms": k2_bound,
           "k1_err": max(err_d[0], err_s[0]),
           "k1_rel_err": max(err_d[1], err_s[1]), "width": m}
    log(f"{label} ({N} replicas of qwen2-1.5b at {cfg.n_layers} layers, f = "
        f"{F}, multi_bulyan, replicas 0, 1 embedding x {ROBUST_CORRUPT}, "
        f"batch {SERVE_BATCH}, prompt {SERVE_PROMPT}, {ROBUST_NEW} tokens): "
        f"launches {counts}, K2 variants {variants}; byzantine mass 0 at "
        f"every token; fused logits bit for bit the honest model's at every "
        f"token; tokens generate's; the ensemble's decode step "
        f"{out['token_ms']:.4f} ms a token (mean of {len(step_s)}: "
        f"{out['token_ms_all']}); on the first token's ({N}, {m:,}) fp32 "
        f"stack K1 {k1_ms:.4f} ms (bound {k1_bound:.4f}, bytes) and K2 "
        f"{k2_ms:.4f} ms (bound {k2_bound:.4f}, bytes, theta {theta}), each "
        f"held to its plain version (K1 max abs err {out['k1_err']:.3e}, "
        f"rel {out['k1_rel_err']:.3e}; plans and K2 bit for bit); the bf16 "
        f"-> fp32 copy of the stack "
        f"before each kernel {cast_ms:.4f} ms; card {power}")
    return counts, out


# ------------------------------------------------------- decoder families
def repeated_step(torch, label, argv):
    """The first step of ``argv``'s configuration (the launcher's model,
    batch and seed) run twice through the trainer from the same
    parameters, state, batch and seed, at a constant lr of 0.05 (the
    launcher's warm-up gives step 0 an lr of 0): the parameters and the
    momentum after it must be the same bits both times.  A third run is
    traced (:func:`log_profile`, with K1's and K2's share)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import models as MD
    from repro_torch.dist import init_train_state
    from repro_torch.launch import train
    from repro_torch.optim import constant
    from repro_torch.tree import tree_leaves
    args = train.parse_args(argv)
    cfg = MD.arch_config(args.arch, reduced=args.reduced,
                         layers=args.layers)
    opt, step = train.make_trainer(args, cfg, train.robust_config(args),
                                   constant(0.05),
                                   hier=train.hier_config(args)[0])
    params = MD.init_model(cfg, seed=args.seed, device="cuda")
    batch = next(train.worker_batches(args, cfg, torch.device("cuda")))
    runs = []
    for _ in range(2):
        new, state, _ = step(params, init_train_state(opt, params), batch,
                             args.seed)
        runs.append(tree_leaves(new) + tree_leaves(state.opt.mu))
        del new, state
    moved = any(not torch.equal(a, b) for a, b in
                zip(runs[0], tree_leaves(params)))
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    check(moved, f"{label}: the repeated step left the parameters as "
          f"they were")
    check(same, f"{label}: the first step run twice from the same state "
          f"gave parameters or momentum that differ")
    log(f"{label}: the first step run twice from the same parameters, "
        f"batch and seed: parameters and momentum ({len(runs[0])} leaves) "
        f"the same bits both times")
    del runs
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        new, state, _ = step(params, init_train_state(opt, params), batch,
                             args.seed)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    del new, state
    log_profile(torch, prof, f"{label}: one step", wall_ms, 12)
    del params, batch
    torch.cuda.empty_cache()


def family_training(torch, power):
    """The decoder families' training phases through the launcher: the
    MoE model (qwen3-moe-30b-a3b, 1 layer, full width) on the streaming
    trainer's global scope, the SSM model (falcon-mamba-7b, 2 layers,
    full width) and the VLM (internvl2-1b, 2 layers, full width, a
    1024-patch prefix) on the stacked trainer: finite losses, byzantine
    mass 0, K1 and K2 once per leaf per step and nothing else, and the
    first step repeated bit for bit (:func:`repeated_step`); the hybrid
    (jamba-1.5-large-398b reduced) stacked and on ``stream_global`` bit
    for bit alike; ``examples/streaming_at_scale_torch.py`` on the card.
    Returns ({phase: counts}, {phase: (steady step seconds, peak GiB)})."""
    import importlib.util
    from repro_torch import models as MD
    from repro_torch.kernels import ops
    from repro_torch.tree import tree_leaves
    counts, numbers = {}, {}
    for phase, label, argv in (
            ("moe_training", "MoE training (qwen3-moe-30b-a3b, 1 layer, "
             "stream_global)", MOE_ARGS),
            ("ssm_training", "SSM training (falcon-mamba-7b, 2 layers)",
             SSM_ARGS),
            ("vlm_training", "VLM training (internvl2-1b, 2 layers, "
             "1024-patch prefix)", VLM_ARGS)):
        t0 = time.perf_counter()
        counts[phase], _, hist, _, _ = train_phase(torch, label, argv,
                                                   K1_K2)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        steady = [round(r["seconds"], 4) for r in hist[1:]]
        numbers[phase] = {"steady_step_s": steady, "peak_gib": peak}
        repeated_step(torch, label, argv)
        log(f"{label}: steady step seconds {steady}, peak memory "
            f"{peak:.2f} GiB; phase {time.perf_counter() - t0:.1f} s; card "
            f"{power}")
    label = "hybrid (jamba-1.5-large-398b reduced)"
    counts["hybrid"], _, hist, _, params = train_phase(
        torch, f"{label}, stacked", HYBRID_ARGS, K1_K2, keep_params=True)
    counts["hybrid_stream"], _, s_hist, _, s_params = train_phase(
        torch, f"{label}, stream_global", HYBRID_ARGS + [
            "--trainer", "stream_global"], K1_K2, keep_params=True)
    same_run(torch, f"{label}, stream_global", s_hist, s_params, hist,
             params)
    log(f"{label}: stream_global's losses, per-worker losses, selections, "
        f"byzantine mass and parameters after {len(hist)} steps bit for "
        f"bit the stacked trainer's")
    del params, s_params
    spec = importlib.util.spec_from_file_location(
        "streaming_at_scale_torch", os.path.join(
            ROOT, "examples", "streaming_at_scale_torch.py"))
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    leaves = len(tree_leaves(MD.init_model(ex.CFG, device="cpu")))
    ops.reset_launch_counts()
    diff = ex.main([])
    counts["example"] = ops.launch_counts()
    want = {k: v * 2 * leaves for k, v in K1_K2.items()}
    check(diff == 0.0 and counts["example"] == want,
          f"streaming_at_scale_torch.py: diff {diff}, launches "
          f"{counts['example']}, want {want}")
    k2_variant_check("streaming_at_scale_torch.py",
                     counts["example"]["fused_select"])
    log(f"examples/streaming_at_scale_torch.py (mini-jamba, 4 layers, "
        f"{leaves} leaves): max |param diff| stacked vs streaming-global "
        f"{diff}; launches {counts['example']} (one stacked and one "
        f"streaming step)")
    ops.reset_launch_counts()
    torch.cuda.empty_cache()
    return counts, numbers


def decode_against_forward(torch, label, cfg, params, window, extra=None):
    """Prefill (prompt SERVE_PROMPT, after ``extra``: an encoder-decoder's
    frames) and CONSISTENCY_STEPS decode steps against ``forward_fn`` on
    the grown prompt, each within one bf16 ulp of its largest forward
    logit (:func:`bf16_spacing`); returns the largest difference and the
    largest such ulp."""
    from repro_torch import models as MD
    worst, ulp_max = 0.0, 0.0

    def held(got, want, what):
        nonlocal worst, ulp_max
        err = float((got.float() - want.float()).abs().max())
        ulp = bf16_spacing(torch, want)
        check(err <= ulp, f"{label}: {what} against the forward {err}, "
              f"above one bf16 ulp of the largest logit ({ulp})")
        worst, ulp_max = max(worst, err), max(ulp_max, ulp)

    with torch.no_grad():
        cur = {"tokens": serve_prompt(torch, SERVE_BATCH, SERVE_PROMPT,
                                      seed=11) % cfg.vocab_size,
               **(extra or {})}
        last, cache = MD.prefill_fn(params, cfg, cur, window=window,
                                    chunk_q=SERVE_PROMPT)
        held(last, MD.forward_fn(params, cfg, cur, window=window,
                                 logits_tail=1)[:, -1], "prefill")
        for step in range(CONSISTENCY_STEPS):
            tok = serve_prompt(torch, SERVE_BATCH, 1,
                               seed=200 + step)[:, 0] % cfg.vocab_size
            cur = {**cur, "tokens": torch.cat([cur["tokens"],
                                               tok[:, None]], 1)}
            got, cache = MD.decode_fn(params, cfg, tok, cache,
                                      SERVE_PROMPT + step, window=window)
            held(got, MD.forward_fn(params, cfg, cur, window=window,
                                    logits_tail=1)[:, -1],
                 f"decode step {step}")
    return worst, ulp_max


def family_serving(torch, power):
    """``launch/serve.py`` on falcon-mamba-7b at all 64 layers and on
    qwen3-moe-30b-a3b at 2 layers (full width): no kernel, every decoded
    logit finite, prefill seconds and decode ms a token beside the
    weight-read bound; qwen3-moe's prefill the forward's last row bit for
    bit (tokens drop at its capacity factor, so decode is not held to the
    forward).  Then decode against the forward at 2 layers, within one
    bf16 ulp of the largest logit, for falcon-mamba-7b (full width) and
    the reduced jamba (window 0 and 64) (:func:`decode_against_forward`).
    Returns ({phase: counts}, {phase: numbers})."""
    from repro_torch import models as MD
    counts, numbers = {}, {}
    cfg = MD.arch_config("falcon-mamba-7b")
    counts["ssm_serving"], numbers["ssm_serving"], logits, full = \
        serve_and_time(torch, power, "SSM serving (all 64 layers)",
                       SSM_SERVE_ARGS, cfg)
    del logits, full
    cfg = MD.arch_config("qwen3-moe-30b-a3b", layers=MOE_SERVE_LAYERS)
    counts["moe_serving"], numbers["moe_serving"], logits, full = \
        serve_and_time(torch, power, f"MoE serving ({MOE_SERVE_LAYERS} "
                       f"layers)", MOE_SERVE_ARGS, cfg)
    check(torch.equal(logits, full), "MoE serving: prefill logits differ "
          "from the forward's last row")
    log("MoE serving: prefill logits the forward's last row bit for bit")
    del logits, full
    torch.cuda.empty_cache()
    worst = {}
    for name, cfg in (
            ("falcon-mamba-7b, 2 layers",
             MD.arch_config("falcon-mamba-7b", layers=2)),
            ("jamba-1.5-large-398b reduced",
             MD.arch_config("jamba-1.5-large-398b", reduced=True))):
        params = MD.init_model(cfg, seed=5, device="cuda")
        for window in ((0,) if cfg.is_attention_free else (0, 64)):
            label = f"decode consistency ({name}, window {window})"
            err, ulp = decode_against_forward(torch, label, cfg, params,
                                              window)
            worst[label] = (err, ulp)
            log(f"{label}: prefill and {CONSISTENCY_STEPS} decode steps "
                f"against the forward, largest difference {err:.6g}, each "
                f"within one bf16 ulp of its largest logit (at most "
                f"{ulp:.6g}); card {power}")
        del params
        torch.cuda.empty_cache()
    numbers["decode_consistency"] = worst
    return counts, numbers


def every_config_reduced(torch):
    """Each of the registry's architectures, reduced: one stacked training
    step (K1 and K2 once per leaf, nothing else; finite loss, byzantine
    mass 0) and REDUCED_SERVE_NEW served tokens (no kernel).  Returns
    {"reduced <name>": counts}."""
    from repro_torch.configs import ARCH_NAMES
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    counts = {}
    for name in ARCH_NAMES:
        counts[f"reduced {name}"], *_ = train_phase(
            torch, f"reduced {name}, one step",
            with_flags(REDUCED_ARGS, arch=name), K1_K2)
        ops.reset_launch_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            rec = serve.run(["--arch", name, "--reduced", "--batch", "2",
                             "--prompt-len", "16", "--new-tokens",
                             str(REDUCED_SERVE_NEW), "--device", "cuda"])
        got = ops.launch_counts()
        toks = rec["tokens"]
        check(got == NO_KERNELS and tuple(toks.shape) == (
            2, REDUCED_SERVE_NEW) and bool(((toks >= 0) & (
                toks < 512)).all()),
              f"reduced {name} serving: launches {got}, tokens {toks}")
        log(f"reduced {name}: served {REDUCED_SERVE_NEW} tokens "
            f"{toks[0].tolist()}, no kernel")
        del rec
    torch.cuda.empty_cache()
    return counts


def moe_leaves(torch):
    """K1 and K2 on the largest leaves any phase gives them, the MoE
    training phase's (11, 151936 x 2048) embedding and lm_head stacks and
    (11, 128 x 2048 x 768) expert stacks: each held to its plain version
    as in phase 3 (the embedding stack in :func:`kernels_vs_plain`) and
    timed (median of 3, CUDA events) beside its plain version, the library
    call (``torch.mm`` for K1; none for K2) and its bound.  Returns
    {leaf: {k1_ms, k1_plain_ms, k1_lib_ms, k1_bound_ms, k2_ms, ...}}."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_select import fused_select_cuda
    from repro_torch.kernels.pairwise_sqdist import pairwise_stats_cuda
    out = {}
    for leaf, m in (("embed", QWEN3_EMBED_WIDTH),
                    ("experts", QWEN3_EXPERT_WIDTH)):
        x = rows_stack(torch, m, seed=m)
        raw, _ = pairwise_stats_cuda(x)
        plan = plan_of(raw)
        theta = plan.w_ext.shape[0]
        if leaf == "experts":
            got = fused_select_cuda(x, plan.w_ext, plan.w_agr, plan.beta)
            want = ref.fused_select_ref(x, plan.w_ext, plan.w_agr, plan.beta)
            check(torch.equal(got, want), f"K2 on the {leaf} stack "
                  f"({N}, {m}): differs from its plain version")
            raw_p, _ = ref.pairwise_stats_ref(x)
            _, r_d = compare_k1(torch, raw, raw_p)
            check(r_d <= K1_TOL, f"K1 on the {leaf} stack: rel err {r_d}")
            del got, want, raw_p
        r = {
            "k1_ms": time_ms(torch, lambda: pairwise_stats_cuda(x), 3),
            "k1_plain_ms": time_ms(torch, lambda: ref.pairwise_stats_ref(x),
                                   3),
            "k1_lib_ms": time_ms(torch, lambda: torch.mm(x, x.t()), 3),
            "k2_ms": time_ms(torch, lambda: fused_select_cuda(
                x, plan.w_ext, plan.w_agr, plan.beta), 3),
            "k2_plain_ms": time_ms(torch, lambda: ref.fused_select_ref(
                x, plan.w_ext, plan.w_agr, plan.beta), 1)}
        k1_b = {"bytes": 4 * (N * m + N * N + N) / HBM_BYTES_PER_S,
                "operations": N * (N + 1) * m / FP32_FLOP_PER_S}
        k2_b = k2_bound_s(N, m, theta, plan.beta)
        for k, b in (("k1", k1_b), ("k2", k2_b)):
            r[f"{k}_bound_by"] = max(b, key=b.get)
            r[f"{k}_bound_ms"] = 1e3 * max(b.values())
        out[leaf] = r
        log(f"qwen3-moe {leaf} stack ({N}, {m:,}) = {N * m:,} elements: "
            f"K1 {r['k1_ms']:.4f} ms (plain {r['k1_plain_ms']:.4f}, "
            f"torch.mm {r['k1_lib_ms']:.4f}, bound {r['k1_bound_ms']:.4f} "
            f"{r['k1_bound_by']}), K2 {r['k2_ms']:.4f} ms (plain "
            f"{r['k2_plain_ms']:.4f}, bound {r['k2_bound_ms']:.4f} "
            f"{r['k2_bound_by']}, theta {theta})")
        del x, raw
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------ theta > 32 and whisper
def wide_theta_sweep(torch, power):
    """K2 and K3 at theta > 32 (the network variants up to 128, the
    counted ones above) on the card tests' cases
    (``kernels/select_cases.py``: theta in WIDE_THETAS, beta in {1,
    ceil(theta / 2), theta}, plans and inputs with ties, NaN, +-inf, +-0
    and 1e30), K2 at n = theta + WIDE_N_EXTRA and 256: bit for bit the
    plain versions, NaN in the same places, every launch counted under its
    variant (``fused_select.variant_name``, as the launchers report it).
    Both libraries' network buckets must be ``fused_select.NETWORK_SLOTS``
    (each theta of 32..129 through ``wide_shape``).  Then each theta timed
    (:func:`wide_sweep_timing`).  Returns (the number of cases, the
    timings)."""
    from repro_torch.kernels import ops, ref, select_cases
    from repro_torch.kernels.coord_select import coord_select_cuda
    from repro_torch.kernels.fused_select import (MAX_WIDE_THETA,
                                                  fused_select_cuda,
                                                  variant_name, wide_shape)
    for lib in ("fused_select", "coord_select"):
        thetas = range(32, MAX_WIDE_THETA + 2)
        got = [(wide_shape(t, lib) or {}).get("slots") for t in thetas]
        want = [kernel_slots(t) if 32 < t <= MAX_WIDE_THETA else None
                for t in thetas]
        check(got == want, f"{lib}: the library's network buckets {got} "
              f"are not NETWORK_SLOTS' {want}")
    runs = [(f"K2 theta={theta} n={n}", theta, "fused_select",
             select_cases.k2_cases(theta, n, "cuda"), fused_select_cuda,
             ref.fused_select_ref)
            for theta in select_cases.WIDE_THETAS
            for n in (theta + WIDE_N_EXTRA, 256)]
    runs += [(f"K3 theta={theta} ties={ties}", theta, "coord_select",
              select_cases.k3_cases(theta, ties, "cuda"), coord_select_cuda,
              ref.coord_select_ref)
             for theta in select_cases.WIDE_THETAS for ties in (False, True)]
    cases = 0
    for run, theta, name, run_cases, kernel, plain in runs:
        ops.reset_launch_counts()
        launched = 0
        for label, args, non_finite in run_cases:
            got, want = kernel(*args), plain(*args)
            torch.cuda.synchronize()
            check(same_bits(torch, got, want), f"{label}: differs from its "
                  f"plain version")
            check(not non_finite or bool(torch.isnan(want).any()),
                  f"{label}: no NaN in the plain version's output")
            launched += 1
        variants = ops.fused_select_variant_counts() \
            if name == "fused_select" else ops.coord_select_variant_counts()
        check(variants == {variant_name(theta): launched},
              f"{run}: variants {variants}")
        cases += launched
    ops.reset_launch_counts()
    torch.cuda.empty_cache()
    log(f"K2 and K3 at theta > 32 (the network and counted variants): "
        f"{cases} cases, theta in {list(select_cases.WIDE_THETAS)}, K2 at "
        f"n = theta + {WIDE_N_EXTRA} and 256, beta in {{1, ceil(theta/2), "
        f"theta}}, d in {list(select_cases.WIDE_WIDTHS)}, ties and "
        f"non-finite inputs: bit for bit the plain versions (NaN in the "
        f"same places), every launch counted under its variant")
    return cases, wide_sweep_timing(torch, power)


def wide_sweep_case(torch, kernel, theta):
    """(wrapper, arguments, bound, slots bound) of K2 (``kernel`` "k2") or K3 ("k3") at
    ``theta`` on the sweep's synthetic stack of WIDE_SWEEP_D columns: K2 on
    (theta + WIDE_N_EXTRA, WIDE_SWEEP_D) rows (:func:`rows_stack`) with
    ``select_cases.synthetic_plan``, K3 on (theta, WIDE_SWEEP_D) g_ext /
    g_agr of the same noise; beta = theta - 4 (a multi-Bulyan plan's at f
    = 2); the bound as ``k2_bound_s`` / ``k3_bound_s`` count it, on the
    yardstick's slots and on the kernel's own (:func:`kernel_slots`).
    ``tools/time_k1.py --thetas`` times the same cases."""
    from repro_torch.kernels.coord_select import coord_select_cuda
    from repro_torch.kernels.fused_select import fused_select_cuda
    d, beta, slots = WIDE_SWEEP_D, theta - 4, kernel_slots(theta)
    if kernel == "k2":
        n = theta + WIDE_N_EXTRA
        we, wa = synthetic_plan(torch, theta, n, seed=theta)
        return (fused_select_cuda,
                (rows_stack(torch, d, seed=theta, n=n), we, wa, beta),
                k2_bound_s(n, d, theta, beta),
                k2_bound_s(n, d, theta, beta, slots))
    g = rows_stack(torch, d, seed=theta, n=2 * theta)
    return coord_select_cuda, (g[:theta], g[theta:], beta), \
        k3_bound_s(d, theta, beta), k3_bound_s(d, theta, beta, slots)


def wide_sweep_timing(torch, power):
    """K2 and K3 at each theta of WIDE_THETAS on the sweep's synthetic
    stack (:func:`wide_sweep_case`), each output held bit for bit to its
    plain version; median ms of 5 beside the bound, on the yardstick's
    slots and on the kernel's own.  Returns {"theta=t": {"variant",
    "k2_ms", "k2_bound_ms", "k2_bound_by", "k2_slots_bound_ms", "k3_ms",
    "k3_bound_ms", "k3_bound_by", "k3_slots_bound_ms"}}."""
    from repro_torch.kernels import ref, select_cases
    from repro_torch.kernels.fused_select import variant_name
    out = {}
    for theta in select_cases.WIDE_THETAS:
        r = out[f"theta={theta}"] = {"variant": variant_name(theta)}
        for k, plain in (("k2", ref.fused_select_ref),
                         ("k3", ref.coord_select_ref)):
            fn, args, bound, own = wide_sweep_case(torch, k, theta)
            check(same_bits(torch, fn(*args), plain(*args, chunk=1 << 18)),
                  f"{k} sweep theta={theta}: differs from its plain version")
            r[f"{k}_ms"] = time_ms(torch, lambda: fn(*args), 5)
            r[f"{k}_bound_ms"] = 1e3 * max(bound.values())
            r[f"{k}_bound_by"] = max(bound, key=bound.get)
            r[f"{k}_slots_bound_ms"] = 1e3 * max(own.values())
            del args
            torch.cuda.empty_cache()
    log(f"K2 and K3 over theta > 32 on {WIDE_SWEEP_D:,} columns (K2 at n = "
        f"theta + {WIDE_N_EXTRA}, beta = theta - 4; each bit for bit its "
        f"plain version), median ms of 5: " + "; ".join(
            f"{k} ({r['variant']}): K2 {r['k2_ms']:.4f} (bound "
            f"{r['k2_bound_ms']:.4f} {r['k2_bound_by']}, on its slots "
            f"{r['k2_slots_bound_ms']:.4f}), K3 {r['k3_ms']:.4f} (bound "
            f"{r['k3_bound_ms']:.4f} {r['k3_bound_by']}, on its slots "
            f"{r['k3_slots_bound_ms']:.4f})" for k, r in out.items())
        + f"; card {power}")
    return out


def wide_entry(wide, k, launches):
    """The ``kernels`` line's numbers of K2's or K3's ``theta>32`` variant
    (``k``: "k2" or "k3"), timed over whisper's leaves at n = WIDE_N, and
    its largest difference from its plain version there; the launches
    from the phase that ran it.  ``slots_bound_ms`` is the bound with the
    selection charged on the kernel's own slots (:func:`kernel_slots`)."""
    return {"theta": wide["theta"], "n": WIDE_N, "launches": launches,
            "max_abs_err": wide[f"{k}_err"], "ms": wide[k],
            "plain_ms": wide[f"{k}_plain"],
            "bound_ms": wide[f"{k}_bound"],
            "bound_by": wide[f"{k}_bound_by"],
            "slots_bound_ms": wide[f"{k}_slots_bound"], "library_ms": None}


def whisper_batch(torch, argv):
    """The model's config and step 0's worker batch of ``argv`` (the
    launcher's tokens and frames)."""
    from repro_torch import models as MD
    from repro_torch.launch import train
    args = train.parse_args(argv)
    cfg = MD.arch_config(args.arch, reduced=args.reduced,
                         layers=args.layers)
    return cfg, next(train.worker_batches(args, cfg, torch.device("cuda")))


def wide_two_step(torch, power):
    """One batch's real whisper-tiny gradients at n = WIDE_N (the ``inf``
    attack): the fused apply (K2, every launch on the network variant) and
    ``fused=False`` (K3 once per leaf, every launch on the network variant
    and held bit for bit to ``coord_select_ref`` on the g_ext / g_agr the
    substrate formed; K2 never).  Every coordinate where the two applies
    differ by more than 1e-6 x max(1, |fused|) must be a near-tie
    (:func:`near_ties`).  Then both variants timed over the leaves beside
    their plain versions and bounds.  Returns (the fused apply's counts,
    the fused=False counts, the timing numbers)."""
    from repro_torch import models as MD
    from repro_torch.core import api
    from repro_torch.dist import inject_byzantine, per_worker_grads
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.coord_select import coord_select_cuda
    from repro_torch.kernels.fused_select import fused_select_cuda
    from repro_torch.tree import tree_leaves
    label = f"whisper two-step at n = {WIDE_N}"
    cfg, batch = whisper_batch(torch, WHISPER_WIDE_ARGS)
    params = MD.init_model(cfg, seed=0, device="cuda")
    _, grads = per_worker_grads(params, cfg, batch, chunk_q=128)
    del params, batch
    with torch.no_grad():
        inject_byzantine(grads, F, "inf", seed=0)
    leaves = [x.reshape(WIDE_N, -1) for x in tree_leaves(grads)]
    numels = [x.shape[1] for x in leaves]
    fused = api.AggregatorBackend("multi_bulyan", F)
    with torch.no_grad():
        plan = fused.plan(fused.stats(grads))
        theta, beta = plan.w_ext.shape[0], plan.beta
        check(theta == THETA_WIDE, f"{label}: theta {theta}")
        byz = float(torch.sum(plan.selection_weights()[:F]))
        check(byz == 0.0, f"{label}: byzantine plan mass {byz}")
        ops.reset_launch_counts()
        out_f = [o.reshape(-1) for o in tree_leaves(fused.apply(plan, grads))]
        torch.cuda.synchronize()
        counts_f = ops.launch_counts()
    want = {**NO_KERNELS, "fused_select": len(leaves)}
    check(counts_f == want, f"{label}: fused launches {counts_f}, want {want}")
    k2_variant_check(f"{label}, fused", len(leaves), theta)
    real_k3 = ops.coord_select
    held = []

    def k3_held_to_plain(g_ext, g_agr, b):
        got = real_k3(g_ext, g_agr, b)
        check(torch.equal(got, ref.coord_select_ref(g_ext, g_agr, b)),
              f"{label}: K3 on the substrate's {tuple(g_ext.shape)} inputs "
              f"differs from its plain version")
        held.append(tuple(g_ext.shape))
        return got

    backend = api.AggregatorBackend("multi_bulyan", F, fused=False)
    ops.coord_select = k3_held_to_plain
    try:
        with torch.no_grad():
            ops.reset_launch_counts()
            out = backend.apply(plan, grads)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            variants = ops.coord_select_variant_counts()
    finally:
        ops.coord_select = real_k3
    want = {**NO_KERNELS, "coord_select": len(leaves)}
    check(counts == want, f"{label}: fused=False launches {counts}, want "
          f"{want}")
    check(variants == {"theta>32": len(leaves)},
          f"{label}: K3 variants {variants}")
    n_diff = n_tie = 0
    for x, o2, of in zip(leaves, tree_leaves(out), out_f):
        o2 = o2.reshape(-1)
        check(bool(torch.isfinite(o2).all()), f"{label}: non-finite")
        bad = torch.abs(o2 - of) > K2_TOL * torch.clamp(of.abs(), min=1.0)
        idx = torch.nonzero(bad).reshape(-1)
        n_diff += len(idx)
        for c0 in range(0, len(idx), 1 << 16):
            n_tie += int(near_ties(torch, x, plan, idx[c0:c0 + (1 << 16)])
                         .sum())
    check(n_diff == n_tie, f"{label}: {n_diff - n_tie} of {n_diff} "
          f"differing coordinates are not near-ties")
    log(f"{label} (theta {theta}, beta {beta}): fused launches {counts_f} "
        f"(K2 all on theta>32); fused=False launches {counts}, K3 variants "
        f"{variants}, all {len(held)} K3 launches bit for bit their plain "
        f"version; {n_diff} of {sum(numels):,} coordinates differ from the "
        f"fused apply by more than {K2_TOL} x max(1, |fused|), all "
        f"near-ties")
    del out, out_f
    torch.cuda.empty_cache()
    # both variants over the leaves: K2 on the stack, K3 on the products
    tot = {k: 0.0 for k in ("k2", "k2_plain", "k2_err", "k3", "k3_plain",
                            "k3_err")}
    bound = {k: {"bytes": 0.0, "operations": 0.0} for k in ("k2", "k3")}
    own = {k: {"bytes": 0.0, "operations": 0.0} for k in ("k2", "k3")}
    slots = kernel_slots(theta)
    we, wa = plan.w_ext, plan.w_agr
    for i, x in enumerate(leaves):
        m = x.shape[1]
        reps = 3 if m > 10_000_000 else 10
        got = fused_select_cuda(x, we, wa, beta)
        want = ref.fused_select_ref(x, we, wa, beta)
        tot["k2_err"] = max(tot["k2_err"], abs_err(torch, got, want))
        check(same_bits(torch, got, want), f"{label}: K2 on timed leaf {i} "
              f"d={m} differs from its plain version")
        del got, want
        tot["k2"] += time_ms(torch, lambda: fused_select_cuda(
            x, we, wa, beta), reps)
        tot["k2_plain"] += time_ms(torch, lambda: ref.fused_select_ref(
            x, we, wa, beta), 1)
        ge, ga = torch.matmul(we, x), torch.matmul(wa, x)
        got = coord_select_cuda(ge, ga, beta)
        want = ref.coord_select_ref(ge, ga, beta)
        tot["k3_err"] = max(tot["k3_err"], abs_err(torch, got, want))
        check(same_bits(torch, got, want), f"{label}: K3 on timed leaf {i}'s "
              f"products differs from its plain version")
        del got, want
        tot["k3"] += time_ms(torch, lambda: coord_select_cuda(ge, ga, beta),
                             reps)
        tot["k3_plain"] += time_ms(
            torch, lambda: ref.coord_select_ref(ge, ga, beta), 1)
        del ge, ga
        for k, b, o in (("k2", k2_bound_s(WIDE_N, m, theta, beta),
                         k2_bound_s(WIDE_N, m, theta, beta, slots)),
                        ("k3", k3_bound_s(m, theta, beta),
                         k3_bound_s(m, theta, beta, slots))):
            for key in b:
                bound[k][key] += b[key]
                own[k][key] += o[key]
    for k, b in bound.items():
        tot[f"{k}_bound_by"] = max(b, key=b.get)
        tot[f"{k}_bound"] = 1e3 * max(b.values())
        tot[f"{k}_slots_bound"] = 1e3 * max(own[k].values())
    tot.update(theta=theta, beta=beta, leaves=len(leaves),
               coordinates=sum(numels))
    log(f"{label}: the network variants over the {len(leaves)} leaves "
        f"({sum(numels):,} coordinates x {WIDE_N} workers), ms per step: "
        f"K2 {tot['k2']:.4f} (plain {tot['k2_plain']:.4f}, bound "
        f"{tot['k2_bound']:.4f}, {tot['k2_bound_by']}, on its {slots} slots "
        f"{tot['k2_slots_bound']:.4f}), K3 on the products {tot['k3']:.4f} "
        f"(plain {tot['k3_plain']:.4f}, bound {tot['k3_bound']:.4f}, "
        f"{tot['k3_bound_by']}, on its slots {tot['k3_slots_bound']:.4f}); "
        f"card {power}")
    del grads, leaves
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    return counts_f, counts, tot


def encdec_training(torch, power):
    """whisper-tiny through ``launch/train.py`` at its published widths and
    full depth: at n = 11 (the training phase's flags: K1 and K2 once per
    leaf per step, 41 each, every K2 launch on the theta = 5 kernel,
    nothing else, byzantine mass 0), its first step repeated bit for bit
    and a third run traced (:func:`repeated_step`); at n = WIDE_N (theta =
    34: every K2 launch on the network variant, K1 and K2 once per leaf
    per step, byzantine mass 0); then one batch's real gradients at n =
    WIDE_N through the fused and the two-step applies
    (:func:`wide_two_step`).  Returns ({phase: counts}, {phase: numbers},
    the network variants' timing)."""
    counts, numbers = {}, {}
    for phase, label, argv, theta in (
            ("whisper_training", "whisper training (whisper-tiny, full "
             f"depth, n = {N})", WHISPER_ARGS, THETA_MAIN),
            ("whisper_wide", f"whisper training at n = {WIDE_N} (theta = "
             f"{THETA_WIDE})", WHISPER_WIDE_ARGS, THETA_WIDE)):
        t0 = time.perf_counter()
        counts[phase], shapes, hist, _, _ = train_phase(
            torch, label, argv, K1_K2, theta=theta)
        check(len(shapes) == WHISPER_LEAVES, f"{label}: {len(shapes)} leaves")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        steady = [round(r["seconds"], 4) for r in hist[1:]]
        numbers[phase] = {"steady_step_s": steady, "peak_gib": peak,
                          "losses": [r["loss"] for r in hist]}
        if phase == "whisper_training":
            repeated_step(torch, label, argv)
        log(f"{label}: steady step seconds {steady}, peak memory "
            f"{peak:.2f} GiB; phase {time.perf_counter() - t0:.1f} s; card "
            f"{power}")
    t0 = time.perf_counter()
    counts["whisper_fused"], counts["whisper_two_step"], wide = \
        wide_two_step(torch, power)
    log(f"whisper two-step phase {time.perf_counter() - t0:.1f} s")
    return counts, numbers, wide


def encdec_robust_serving(torch, power):
    """N replicas of whisper-tiny at full depth (N - F identical honest
    ones; replicas 0 and 1 their lm_head x ROBUST_CORRUPT: a layernormed
    decoder scales its embedding away), batch 4, prompt 128 after 1500
    frames, each replica with its own cross K/V: each prefilled, the last
    logits fused, then ROBUST_NEW - 1 robust decode steps, greedy.  K1 and
    K2 once per token (K2 on the theta = 5 kernel), nothing else;
    byzantine mass 0 at every token; the fused logits the honest model's
    bit for bit and the tokens ``generate``'s with the same frames.
    Returns the counts and the ensemble's ms a token."""
    from repro_torch import models as MD
    from repro_torch.configs import RobustConfig
    from repro_torch.dist.serving import (aggregate_replica_logits, generate,
                                          make_robust_serve_step)
    from repro_torch.kernels import ops
    from repro_torch.tree import tree_map
    label = "whisper robust serving"
    cfg = MD.arch_config("whisper-tiny")
    honest = MD.init_model(cfg, seed=5, device="cuda")
    stack = tree_map(lambda t: torch.stack([t] * N), honest)
    for i, factor in enumerate(ROBUST_CORRUPT):
        stack["lm_head"]["w"][i] *= factor
    rcfg = RobustConfig(n_workers=N, f=F, gar="multi_bulyan",
                        use_kernels=True)
    backend = recording_backend(rcfg)
    prompt = serve_prompt(torch, SERVE_BATCH, SERVE_PROMPT,
                          seed=11) % cfg.vocab_size
    extra = {"frames": MD.frames(cfg, SERVE_BATCH, 17, "cuda")}
    batch = {"tokens": prompt, **extra}
    cache_len = SERVE_PROMPT + ROBUST_NEW
    step = make_robust_serve_step(cfg, rcfg, backend=backend)
    ops.reset_launch_counts()
    with torch.no_grad():
        outs = [MD.prefill_fn(tree_map(lambda t: t[i], stack), cfg, batch,
                              chunk_q=SERVE_PROMPT, cache_len=cache_len)
                for i in range(N)]
        first = torch.stack([lg for lg, _ in outs])
        caches = tree_map(lambda *xs: torch.stack(xs), *[c for _, c in outs])
        del outs
        fused = [aggregate_replica_logits(first, rcfg, backend)]
        tokens, step_s = [], []
        for t in range(ROBUST_NEW):
            tokens.append(torch.argmax(fused[-1], dim=-1).int())
            if t + 1 < ROBUST_NEW:
                dt, (lg, caches) = wall_s(torch, lambda: step(
                    stack, caches, tokens[-1], SERVE_PROMPT + t))
                fused.append(lg)
                step_s.append(dt)
    counts = ops.launch_counts()
    want = {**NO_KERNELS, "pairwise_stats": ROBUST_NEW,
            "fused_select": ROBUST_NEW}
    check(counts == want, f"{label}: launches {counts}, want {want}")
    variants = k2_variant_check(label, ROBUST_NEW)
    byz = [float(p.diagnostics()["byz_mass"]) for p in backend.plans]
    check(len(byz) == ROBUST_NEW and all(b == 0.0 for b in byz),
          f"{label}: byzantine mass {byz}")
    del caches, first
    with torch.no_grad():
        want_l, hcache = MD.prefill_fn(honest, cfg, batch,
                                       chunk_q=SERVE_PROMPT,
                                       cache_len=cache_len)
        for t in range(ROBUST_NEW):
            check(fused[t].dtype == want_l.dtype and
                  torch.equal(fused[t], want_l),
                  f"{label} token {t}: fused logits differ from the honest "
                  f"model's (max diff "
                  f"{float((fused[t].float() - want_l.float()).abs().max())})")
            if t + 1 < ROBUST_NEW:
                want_l, hcache = MD.decode_fn(honest, cfg, tokens[t], hcache,
                                              SERVE_PROMPT + t)
    ref_tokens = generate(honest, cfg, prompt, ROBUST_NEW,
                          chunk_q=SERVE_PROMPT, extra_batch=extra)
    check(torch.equal(torch.stack(tokens, dim=1), ref_tokens),
          f"{label}: ensemble tokens differ from generate's")
    token_ms = 1e3 * statistics.mean(step_s)
    log(f"{label} ({N} replicas of whisper-tiny, full depth, f = {F}, "
        f"multi_bulyan, replicas 0, 1 lm_head x {ROBUST_CORRUPT}, batch "
        f"{SERVE_BATCH}, prompt {SERVE_PROMPT} after {cfg.n_frames} frames, "
        f"{ROBUST_NEW} tokens): launches {counts}, K2 variants {variants}; "
        f"byzantine mass 0 at every token; fused logits bit for bit the "
        f"honest model's at every token; tokens generate's; the ensemble's "
        f"decode step {token_ms:.4f} ms a token (mean of {len(step_s)}); "
        f"card {power}")
    del stack, fused, hcache, honest
    torch.cuda.empty_cache()
    return counts, token_ms


def encdec_serving(torch, power):
    """``launch/serve.py --arch whisper-tiny`` at full depth, batch 4,
    prompt 128 after 1500 frames, 32 tokens (:func:`serve_and_time`): no
    kernel, the prefill logits the forward's last row bit for bit; decode
    against the forward, prefill and 2 steps within one bf16 ulp of the
    largest logit (window 0 and 64); the robust ensemble
    (:func:`encdec_robust_serving`).  Returns ({phase: counts},
    {phase: numbers})."""
    from repro_torch import models as MD
    counts, numbers = {}, {}
    cfg = MD.arch_config("whisper-tiny")
    counts["whisper_serving"], numbers["whisper_serving"], logits, full = \
        serve_and_time(torch, power, "whisper serving (full depth)",
                       WHISPER_SERVE_ARGS, cfg)
    check(torch.equal(logits, full), "whisper serving: prefill logits "
          "differ from the forward's last row")
    log("whisper serving: prefill logits the forward's last row bit for bit")
    del logits, full
    params = MD.init_model(cfg, seed=5, device="cuda")
    extra = {"frames": MD.frames(cfg, SERVE_BATCH, 17, "cuda")}
    worst = {}
    for window in (0, 64):
        label = f"decode consistency (whisper-tiny, window {window})"
        err, ulp = decode_against_forward(torch, label, cfg, params, window,
                                          extra=extra)
        worst[label] = (err, ulp)
        log(f"{label}: prefill and {CONSISTENCY_STEPS} decode steps against "
            f"the forward, largest difference {err:.6g}, each within one "
            f"bf16 ulp of its largest logit (at most {ulp:.6g}); card "
            f"{power}")
    numbers["whisper_decode_consistency"] = worst
    del params
    torch.cuda.empty_cache()
    counts["whisper_robust_serving"], numbers["whisper_robust_token_ms"] = \
        encdec_robust_serving(torch, power)
    return counts, numbers



def stack_of(torch, argv, n, f):
    """Step 0's (n, ...) gradient stack of ``argv``'s run, after the
    ``inf`` attack on the first f rows: the stack the launcher's first
    step aggregates."""
    from repro_torch import models as MD
    from repro_torch.dist import inject_byzantine, per_worker_grads
    cfg, batch = whisper_batch(torch, argv)
    params = MD.init_model(cfg, seed=0, device="cuda")
    _, grads = per_worker_grads(params, cfg, batch, chunk_q=128)
    del params, batch
    with torch.no_grad():
        inject_byzantine(grads, f, "inf", seed=0)
    return grads


def level_bound_s(n, m, plan, own_slots=False):
    """The least seconds of one level's kernels on an (n, m) operand: K1
    (the stack read once, the (n, n) result written once; the gram's
    upper triangle in fp32) and K2 (:func:`k2_bound_s`, its selection on
    the kernel's own slots with ``own_slots``), each the larger of its two
    times; for a weighted plan (the average) the stack read once and the
    mean written once."""
    if plan.kind != "bulyan":
        return 4 * (n * m + m) / HBM_BYTES_PER_S
    k1 = max(4 * (n * m + n * n + n) / HBM_BYTES_PER_S,
             n * (n + 1) * m / FP32_FLOP_PER_S)
    theta = plan.w_ext.shape[0]
    return k1 + max(k2_bound_s(n, m, theta, plan.beta, kernel_slots(
        theta) if own_slots else None).values())


def traced(torch, label, fn):
    """``fn()`` once under ``torch.profiler`` (:func:`log_profile`)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    return log_profile(torch, prof, label, wall_ms, 4)


def flat_against_hier(torch, label, grads, n, f, theta_flat, power):
    """Flat multi-Bulyan and the grouped aggregation (groups of HIER_G) on
    one stack, kernels on.  First the flat apply on the flat plan, with
    the kernels (one K2 launch a leaf, each on the variant of theta_flat)
    and with the plain versions on the card: every leaf bit for bit.  Then
    stats + plan + apply, CUDA events, median of HIER_REPS, beside each
    one's bound (:func:`level_bound_s` of every level over the leaves, and
    the flat one's on the kernels' own slots), then each traced once.
    Returns {"flat_ms", "hier_ms", "flat_bound_ms", "flat_slots_bound_ms",
    "hier_bound_ms", "flat_trace", "hier_trace"}."""
    from repro_torch.core import api
    from repro_torch.hier import GroupConfig, hier_aggregate_tree
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_select import variant_name
    from repro_torch.tree import tree_leaves
    flat = api.AggregatorBackend("multi_bulyan", f)
    cfg = GroupConfig(g=HIER_G)
    widths = [x[0].numel() for x in tree_leaves(grads)]
    with torch.no_grad():
        plan = flat.plan(flat.stats(grads))
        check(plan.w_ext.shape[0] == theta_flat,
              f"{label}: flat theta {plan.w_ext.shape[0]}")
        ops.reset_launch_counts()
        got = tree_leaves(flat.apply(plan, grads))
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        want = {**NO_KERNELS, "fused_select": len(widths)}
        check(counts == want, f"{label}: flat apply launches {counts}, want "
              f"{want}")
        k2_variant_check(f"{label}, flat apply", len(widths), theta_flat)
        with plain_versions():
            plain = tree_leaves(flat.apply(plan, grads))
        for i, (a, b) in enumerate(zip(got, plain)):
            check(same_bits(torch, a, b), f"{label}: the flat apply's leaf "
                  f"{i} is {abs_err(torch, a, b)} from the plain one's")
        del got, plain
        ops.reset_launch_counts()
        _, hplan, _ = hier_aggregate_tree(grads, f, cfg, use_kernels=True)
        check(all(p.w_ext.shape[0] == THETA_HIER for p in hplan.inner),
              f"{label}: inner thetas differ from {THETA_HIER}")
        out = {"flat_bound_ms": 1e3 * sum(level_bound_s(n, m, plan)
                                          for m in widths),
               "flat_slots_bound_ms": 1e3 * sum(
                   level_bound_s(n, m, plan, own_slots=True)
                   for m in widths),
               "hier_bound_ms": 1e3 * sum(
                   sum(level_bound_s(e - s, m, p)
                       for p, (s, e) in zip(hplan.inner, hplan.bounds))
                   + level_bound_s(hplan.n_groups, m, hplan.outer)
                   for m in widths)}
        del plan, hplan
        flat_fn = lambda: flat.apply(  # noqa: E731
            flat.plan(flat.stats(grads)), grads)
        hier_fn = lambda: hier_aggregate_tree(  # noqa: E731
            grads, f, cfg, use_kernels=True)
        out["flat_ms"] = time_ms(torch, flat_fn, HIER_REPS)
        out["hier_ms"] = time_ms(torch, hier_fn, HIER_REPS)
        out["flat_trace"] = traced(torch, f"{label}, flat:", flat_fn)
        out["hier_trace"] = traced(torch, f"{label}, grouped:", hier_fn)
    log(f"{label}: the flat apply (theta = {theta_flat}, {len(widths)} K2 "
        f"launches on {variant_name(theta_flat)}) bit for bit its plain "
        f"version; stats + plan + apply on the ({n}, ...) stack, median of "
        f"{HIER_REPS} (CUDA events): flat multi-Bulyan (theta = "
        f"{theta_flat}) {out['flat_ms']:.4f} ms (bound "
        f"{out['flat_bound_ms']:.4f}, on the kernels' slots "
        f"{out['flat_slots_bound_ms']:.4f}), grouped (g = {HIER_G}, theta = "
        f"{THETA_HIER}) {out['hier_ms']:.4f} ms (bound "
        f"{out['hier_bound_ms']:.4f}) "
        f"({out['flat_ms'] / out['hier_ms']:.2f}x); card {power}")
    return out


@contextlib.contextmanager
def plain_versions():
    """K1, K2 and K5's wrappers in ``kernels.ops`` (what ``core.api`` and
    ``comm.codecs`` call) replaced by their plain versions, which run on
    the card too."""
    from repro_torch.kernels import ops, ref
    saved = ops.pairwise_stats, ops.fused_select, ops.dequant_stats
    ops.pairwise_stats, ops.fused_select, ops.dequant_stats = \
        ref.pairwise_stats_ref, ref.fused_select_ref, ref.dequant_stats_ref
    try:
        yield
    finally:
        ops.pairwise_stats, ops.fused_select, ops.dequant_stats = saved


def same_hier_runs(torch, label, got, want):
    """Two ``hier_aggregate_tree`` results, (aggregate, plan, info), with
    every inner plan at theta = THETA_HIER and, like the aggregates and
    the leaders' bytes, bit for bit the same (NaN-aware)."""
    from repro_torch.tree import tree_leaves
    (agg_k, plan_k, info_k), (agg_p, plan_p, info_p) = got, want
    for i, (pk, pp) in enumerate(zip(plan_k.inner, plan_p.inner)):
        check(pk.w_ext.shape[0] == THETA_HIER and pk.beta == pp.beta
              and same_bits(torch, pk.w_ext, pp.w_ext)
              and same_bits(torch, pk.w_agr, pp.w_agr),
              f"{label}: group {i}'s plan differs from the plain one")
    for i, (a, b) in enumerate(zip(tree_leaves(agg_k), tree_leaves(agg_p))):
        check(same_bits(torch, a, b), f"{label}: the aggregate's leaf {i} "
              f"is {abs_err(torch, a, b)} from the plain one's")
    check(info_k["leader_wire_bytes"] == info_p["leader_wire_bytes"],
          f"{label}: leaders' bytes {info_k['leader_wire_bytes']} against "
          f"{info_p['leader_wire_bytes']}")


def hier_kernels_vs_plain(torch, power):
    """H2: H1's first stack through ``hier_aggregate_tree`` with the
    kernels and with their plain versions on the card: every inner plan
    (theta = 3) and the aggregate bit for bit the same; then flat against
    grouped, timed.  Returns (the kernel run's counts, the timing)."""
    from repro_torch.hier import GroupConfig, hier_aggregate_tree
    from repro_torch.kernels import ops
    from repro_torch.tree import tree_leaves
    label = "H2 hier aggregation, kernels vs plain"
    grads = stack_of(torch, HIER_ARGS, HIER_N, HIER_F)
    cfg = GroupConfig(g=HIER_G)
    with torch.no_grad():
        ops.reset_launch_counts()
        run_k = hier_aggregate_tree(grads, HIER_F, cfg, use_kernels=True,
                                    needs_dists=True)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        n_leaves = len(tree_leaves(grads))
        want = {**NO_KERNELS, "pairwise_stats": 3 * n_leaves,
                "fused_select": 3 * n_leaves}
        check(counts == want, f"{label}: launches {counts}, want {want}")
        k2_variant_check(label, counts["fused_select"], THETA_HIER)
        with plain_versions():
            run_p = hier_aggregate_tree(grads, HIER_F, cfg,
                                        use_kernels=True, needs_dists=True)
    same_hier_runs(torch, label, run_k, run_p)
    plan_k = run_k[1]
    byz = float(torch.sum(plan_k.selection_weights()[:HIER_F]))
    check(byz == 0.0, f"{label}: byzantine mass {byz}")
    del run_k, run_p
    log(f"{label}: {plan_k.n_groups} inner plans (theta = {THETA_HIER}) "
        f"and the aggregate bit for bit, launches {counts}")
    timed = flat_against_hier(torch, "H2 flat vs hier (qwen2-1.5b, 2 "
                              "layers)", grads, HIER_N, HIER_F,
                              THETA_HIER_FLAT, power)
    del grads
    torch.cuda.empty_cache()
    return counts, timed


def hier_wire_kernels_vs_plain(torch, worst_k5):
    """H5's first step's QSGD container (the launcher's gradients, its
    encoding seed and its ``scale_poison`` forgery) through
    ``hier_aggregate_tree`` with the leader re-encode, with the kernels
    (K5 and K2, 3 a leaf) and with the plain versions of K1, K2 and K5:
    :func:`same_hier_runs`.  Then K5 on every group's slice of every
    leaf's payload, as ``comm.codecs.slice_workers`` cuts it, against
    its plain version (:func:`compare_k5`, adding to ``worst_k5``).
    Returns the worst |K5 - plain| over those slices."""
    from repro_torch import models as MD
    from repro_torch.comm import codecs as CC
    from repro_torch.core.attacks import fold_seed
    from repro_torch.dist import inject_wire, per_worker_grads
    from repro_torch.dist.trainer import ENCODE_STREAM
    from repro_torch.hier import GroupConfig, hier_aggregate_tree
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves
    label = "H5 hier wire, kernels vs plain"
    args = train.parse_args(HIER_WIRE_ARGS)
    cfg, batch = whisper_batch(torch, HIER_WIRE_ARGS)
    params = MD.init_model(cfg, seed=args.seed, device="cuda")
    _, grads = per_worker_grads(params, cfg, batch,
                                chunk_q=min(args.seq, 512))
    del params, batch
    codec = CC.get_codec(args.codec)
    hcfg = GroupConfig(g=HIER_G)
    with torch.no_grad():
        enc, _ = codec.encode(grads, seed=fold_seed(args.seed,
                                                    ENCODE_STREAM))
        enc = inject_wire(enc, args.f, args.attack, args.seed)
        decoded = codec.decode(enc, out=grads)
        del grads
        kw = dict(codec=codec, seed=args.seed, use_kernels=True,
                  needs_dists=True, decoded=decoded)
        ops.reset_launch_counts()
        run_k = hier_aggregate_tree(enc, args.f, hcfg, **kw)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        n_leaves = len(enc.shapes)
        want = {**NO_KERNELS, "dequant_stats": 3 * n_leaves,
                "fused_select": 3 * n_leaves}
        check(counts == want, f"{label}: launches {counts}, want {want}")
        with plain_versions():
            run_p = hier_aggregate_tree(enc, args.f, hcfg, **kw)
        same_hier_runs(torch, label, run_k, run_p)
        plan_k = run_k[1]
        byz = float(torch.sum(plan_k.selection_weights()[:args.f]))
        check(byz == 0.0, f"{label}: byzantine mass {byz}")
        del run_k, run_p, decoded
        worst = {"max_abs": 0.0, "max_rel": 0.0}
        for s, e in plan_k.bounds:
            sub = CC.slice_workers(enc, s, e)
            for i, (p, sc) in enumerate(zip(tree_leaves(sub.payload),
                                            CC.sidecar_leaves(sub))):
                p2, mult = codec.dequant_form(p, sc)
                compare_k5(torch, f"H5 rows [{s}, {e}) leaf {i}",
                           p2.contiguous(), mult.float().contiguous(),
                           None, worst)
            del sub
    del enc
    for k in worst:
        worst_k5[k] = max(worst_k5[k], worst[k])
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    log(f"{label}: {plan_k.n_groups} inner plans (theta = {THETA_HIER}), "
        f"the aggregate and the leaders' bytes bit for bit, launches "
        f"{counts}; K5 on {plan_k.n_groups} x {n_leaves} group slices, "
        f"worst |K5 - plain| {worst['max_abs']:.3e} (relative "
        f"{worst['max_rel']:.3e})")
    return worst["max_abs"]


def hier_training(torch, power, train_hist, train_params, worst_k5):
    """The hierarchical phases H1-H6 (the module docstring); K5's checks
    on H5's group slices add to ``worst_k5``.  Returns ({phase: counts},
    {phase: numbers})."""
    counts, numbers = {}, {}
    t0 = time.perf_counter()
    label = "H1 hier training (qwen2-1.5b, 2 layers, n = 21, --hier g=7)"
    counts["hier"], _, hist, text, params = train_phase(
        torch, label, HIER_ARGS, HIER_K1_K2, keep_params=True,
        theta=THETA_HIER)
    peak = torch.cuda.max_memory_allocated()
    check(HIER_LINE in text.splitlines(), f"{label}: no line {HIER_LINE!r}")
    check(peak < HIER_PEAK_LIMIT, f"{label}: peak memory "
          f"{peak / 2**30:.2f} GiB")
    params = to_host(params)
    torch.cuda.empty_cache()
    numbers["hier"] = {"steady_step_s": [r["seconds"] for r in hist[1:]],
                       "peak_gib": peak / 2 ** 30}
    log(f"{label}: {HIER_LINE}; steady step seconds "
        f"{numbers['hier']['steady_step_s']}, peak memory "
        f"{peak / 2**30:.2f} GiB; card {power}")
    counts["hier_h2"], numbers["hier_h2"] = hier_kernels_vs_plain(
        torch, power)
    label = "H3 one group (the training phase's flags, --hier g=11)"
    counts["hier_one_group"], _, hist3, _, params3 = train_phase(
        torch, label, HIER_ONE_GROUP_ARGS, K1_K2, keep_params=True)
    same_run(torch, label, hist3, params3, train_hist, train_params)
    log(f"{label}: records and parameters bit for bit the training "
        f"phase's")
    del params3
    torch.cuda.empty_cache()
    label = "H4 hier streaming global"
    counts["hier_stream_global"], _, hist4, _, params4 = train_phase(
        torch, label, HIER_ARGS + ["--trainer", "stream_global"],
        HIER_K1_K2, keep_params=True, theta=THETA_HIER)
    numbers["hier_stream_global"] = {
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "steady_step_s": [r["seconds"] for r in hist4[1:]]}
    same_run(torch, label, hist4, params4, hist, params)
    log(f"{label}: bit for bit H1; peak "
        f"{numbers['hier_stream_global']['peak_gib']:.2f} GiB")
    del params4, params
    torch.cuda.empty_cache()
    counts["hier_stream_block"], *_ = train_phase(
        torch, "H4 hier streaming block", HIER_ARGS + [
            "--trainer", "stream_block"], HIER_K1_K2, theta=THETA_HIER)
    label = "H5 hier wire (qsgd:bits=8, scale_poison, 1 layer)"
    counts["hier_wire"], _, hist5, text5, params5 = train_phase(
        torch, label, HIER_WIRE_ARGS, HIER_K5_K2, keep_params=True,
        theta=THETA_HIER)
    lines = [ln for ln in text5.splitlines() if ln.startswith(
        "[train] wire[")]
    check(len(lines) == 2 and "workers_to_leaders" in lines[0] and
          "leaders_to_server" in lines[1], f"{label}: wire lines {lines}")
    per_worker = [int(ln.split(" x ")[1].split(" B")[0].replace(",", ""))
                  for ln in lines]
    check(lines[0].split(": ")[1].startswith(f"{HIER_N} x ") and
          lines[1].split(": ")[1].startswith("3 x ") and
          per_worker[0] == per_worker[1], f"{label}: wire lines {lines}")
    for i, rec in enumerate(hist5):
        check(rec["leader_wire_bytes"] == 3 * rec["wire_bytes_per_worker"]
              == 3 * per_worker[0], f"{label} step {i}: leader bytes "
              f"{rec['leader_wire_bytes']}, a worker's "
              f"{rec['wire_bytes_per_worker']}")
    params5 = to_host(params5)
    torch.cuda.empty_cache()
    label5 = label + ", stream_global"
    counts["hier_wire_stream"], _, hist5s, _, params5s = train_phase(
        torch, label5, HIER_WIRE_ARGS + ["--trainer", "stream_global"],
        HIER_K5_K2, keep_params=True, theta=THETA_HIER)
    same_run(torch, label5, hist5s, params5s, hist5, params5)
    log(f"{label}: {lines}; leaders' bytes 3 x a worker's "
        f"({3 * per_worker[0]:,}); streaming bit for bit stacked")
    del params5, params5s
    torch.cuda.empty_cache()
    numbers["hier_wire"] = {
        "k5_group_slices_max_abs_err": hier_wire_kernels_vs_plain(
            torch, worst_k5)}
    label = "H6 hier whisper (whisper-tiny whole, n = 49, f = 3, g = 7)"
    counts["hier_whisper"], shapes, hist6, text6, _ = train_phase(
        torch, label, HIER_WHISPER_ARGS, HIER_WHISPER_K1_K2,
        theta=THETA_HIER)
    check(len(shapes) == WHISPER_LEAVES, f"{label}: {len(shapes)} leaves")
    check(HIER_WHISPER_LINE in text6.splitlines(),
          f"{label}: no line {HIER_WHISPER_LINE!r}")
    numbers["hier_whisper"] = {
        "steady_step_s": [r["seconds"] for r in hist6[1:]],
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    grads = stack_of(torch, HIER_WHISPER_ARGS, HIER_WHISPER_N,
                     HIER_WHISPER_F)
    numbers["hier_whisper"].update(flat_against_hier(
        torch, "H6 flat vs hier (whisper-tiny, n = 49)", grads,
        HIER_WHISPER_N, HIER_WHISPER_F, THETA_WHISPER_FLAT, power))
    del grads
    torch.cuda.empty_cache()
    log(f"hier phases: {time.perf_counter() - t0:.1f}s; "
        f"{json.dumps(numbers)}; card {power}")
    return counts, numbers


# ------------------------------------------------- the async service (serve)
def async_run(torch, label, late, steps_flag, keep_round=None,
              trace_round=None):
    """``serve.make_async_train_step`` on the training phase's flags
    (``--steps steps_flag`` for the learning-rate schedule), one round a
    tuple of ``late`` worker rows, its batches, seeds and parameters the
    launcher's.  Every count set to 0 before each round and read after it.
    Returns (records as ``train.run`` makes them plus the staleness fields,
    each round's plan, the summed counts, the final parameters, the state
    after round ``keep_round`` (None: none kept), each round's host
    seconds (round ``trace_round`` under ``torch.profiler``: its numbers
    from :func:`log_profile` in the last record's ``trace``), the
    service)."""
    from repro_torch import models as MD
    from repro_torch.core import api
    from repro_torch.dist import init_train_state
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.optim import make_optimizer, warmup_cosine
    from repro_torch.serve import (AsyncAggService, make_async_train_step,
                                   with_buffer)
    from repro_torch.tree import tree_leaves
    args = train.parse_args(with_flags(TRAIN_ARGS, steps=steps_flag))
    cfg = MD.arch_config(args.arch, layers=args.layers)
    rcfg = train.robust_config(args)
    device = torch.device("cuda")
    lr_fn = warmup_cosine(args.lr, warmup=max(args.steps // 20, 1),
                          total_steps=args.steps)
    opt = make_optimizer(args.optimizer, momentum=0.9)
    step = make_async_train_step(cfg, rcfg, opt, lr_fn, tau=ASYNC_TAU,
                                 chunk_q=min(args.seq, 512),
                                 attack=args.attack, telemetry=True)
    svc = AsyncAggService(api.AggregatorBackend.for_config(
        rcfg, needs_dists=True), ASYNC_TAU)
    params = MD.init_model(cfg, seed=args.seed, device=device)
    state = with_buffer(init_train_state(opt, params), svc, params,
                        args.workers)
    records, plans, seconds, kept = [], [], [], None
    total = collections.Counter()
    variants = collections.Counter()
    for i, wb in zip(range(len(late)), train.worker_batches(args, cfg,
                                                              device)):
        fresh = torch.ones(args.workers, dtype=torch.bool, device=device)
        fresh[list(late[i])] = False
        ops.reset_launch_counts()
        run = lambda: step(params, state, wb, args.seed + i,  # noqa: E731
                           fresh)
        if i == trace_round:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                dt, (params, state, m) = wall_s(torch, run)
            trace = log_profile(torch, prof, f"{label} round {i}",
                                1e3 * dt, 8)
        else:
            dt, (params, state, m) = wall_s(torch, run)
        counts = ops.launch_counts()
        variants.update(ops.fused_select_variant_counts())
        leaves = len(tree_leaves(params))
        want = {**NO_KERNELS, "pairwise_stats": leaves,
                "fused_select": leaves}
        check(counts == want, f"{label} round {i}: launches {counts}, want "
              f"{want}")
        total.update(counts)
        tel = m["telemetry"]
        records.append({
            "loss": float(m["loss"]),
            "loss_per_worker": m["loss_per_worker"].tolist(),
            "byz_mass": float(tel["byz_mass"]),
            "selection": tel["selection"].tolist(),
            "n_overstale": int(tel["n_overstale"]),
            "plan_reused": bool(tel["plan_reused"]),
            "f_defended": int(tel["f_defended"]),
            "seconds": dt})
        if i == trace_round:
            records[-1]["trace"] = trace
        plans.append(state.bstate.plan)
        seconds.append(dt)
        if i == keep_round:
            kept = state
    check(dict(variants) == {f"theta={THETA_MAIN}":
                             total["fused_select"]},
          f"{label}: K2 variants {dict(variants)}")
    return records, plans, dict(total), params, kept, seconds, svc


def async_training(torch, power, train_hist, train_params):
    """S1, the async trainer (``serve.make_async_train_step``) at the
    training phase's configuration, tau = ASYNC_TAU: (a) ASYNC_FRESH_ROUNDS
    all-fresh rounds, bit for bit the training phase (records and
    parameters); (b) the ASYNC_LATE schedule: the staleness fields
    exactly ASYNC_WANT, round 2's plan round 1's bit for bit, byzantine
    mass 0, finite losses, K1 and K2 once per leaf a round (theta = 5);
    round 3's buffer through the plan and apply service with the plain
    versions: the plan and the aggregate bit for bit the kernels'.  Prints
    the peak memory, the steady round seconds against the training
    phase's and K1 + K2 on the buffer against their bounds.  Returns
    ({phase: counts}, numbers)."""
    from repro_torch.tree import tree_leaves
    label = "S1 async trainer (qwen2-1.5b, 2 layers, tau = 1)"
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    hist, _, counts_a, params, _, _, _ = async_run(
        torch, f"{label}, all fresh", [()] * ASYNC_FRESH_ROUNDS,
        ASYNC_FRESH_ROUNDS)
    peak_a = torch.cuda.max_memory_allocated()
    same_run(torch, f"{label}, all fresh", hist, params, train_hist,
             train_params)
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    recs, plans, counts_b, params, state, seconds, svc = async_run(
        torch, f"{label}, schedule", ASYNC_LATE, len(ASYNC_LATE),
        keep_round=3, trace_round=len(ASYNC_LATE) - 1)
    peak_b = torch.cuda.max_memory_allocated()
    del params
    got = {k: [r[k] for r in recs] for k in ASYNC_WANT}
    check(got == ASYNC_WANT, f"{label}: staleness fields {got}, want "
          f"{ASYNC_WANT}")
    check(all(math.isfinite(r["loss"]) for r in recs) and
          all(r["byz_mass"] == 0.0 for r in recs),
          f"{label}: losses {[r['loss'] for r in recs]}, byzantine mass "
          f"{[r['byz_mass'] for r in recs]}")
    check(bits_equal(torch, plans[2].w_ext, plans[1].w_ext) and
          bits_equal(torch, plans[2].w_agr, plans[1].w_agr),
          f"{label}: round 2's plan is not round 1's")
    # round 3's buffer (the state after it) through the plan and apply
    # services: the kernels' apply of round 3's plan against the plain
    # versions' plan and apply (round 3 is admissible: the plan service
    # plans afresh)
    bstate = state.bstate
    with torch.no_grad():
        agg_k = tree_leaves(svc.apply(plans[3], bstate))
        with plain_versions():
            plan_p, info_p = svc.plan(bstate)
            agg_p = tree_leaves(svc.apply(plan_p, bstate))
    check(bool(info_p["admissible"]) and
          bits_equal(torch, plan_p.w_ext, plans[3].w_ext) and
          bits_equal(torch, plan_p.w_agr, plans[3].w_agr),
          f"{label}: the plain versions' plan on round 3's buffer differs "
          f"(admissible {bool(info_p['admissible'])}, selection "
          f"{plan_p.selection_weights().tolist()} against "
          f"{plans[3].selection_weights().tolist()})")
    for i, (a, b) in enumerate(zip(agg_k, agg_p)):
        check(same_bits(torch, a, b), f"{label}: round 3's aggregate leaf "
              f"{i} is {abs_err(torch, a, b)} from the plain versions'")
    del agg_k, agg_p
    # K1 and K2 on the buffer's leaves, one launch a leaf (CUDA events)
    from repro_torch.kernels.fused_select import fused_select_cuda
    from repro_torch.kernels.pairwise_sqdist import pairwise_stats_cuda
    rows = [x.reshape(N, -1) for x in tree_leaves(bstate.grads)]
    plan = plans[3]
    k1_ms = time_ms(torch, lambda: [pairwise_stats_cuda(x) for x in rows], 3)
    k2_ms = time_ms(torch, lambda: [fused_select_cuda(
        x, plan.w_ext, plan.w_agr, plan.beta) for x in rows], 3)
    bound_ms = 1e3 * sum(level_bound_s(N, x.shape[1], plan) for x in rows)
    del rows, bstate, state
    torch.cuda.empty_cache()
    train_s = [r["seconds"] for r in train_hist[1:]]
    out = {"fresh_rounds": ASYNC_FRESH_ROUNDS,
           "schedule": {k: got[k] for k in ASYNC_WANT},
           "round_s": seconds, "steady_round_s": seconds[1:-1],
           "traced_round": recs[-1]["trace"],
           "train_step_s": train_s,
           "peak_gib_fresh": peak_a / 2 ** 30,
           "peak_gib_schedule": peak_b / 2 ** 30,
           "k1_k2_ms": k1_ms + k2_ms, "k1_ms": k1_ms, "k2_ms": k2_ms,
           "k1_k2_bound_ms": bound_ms}
    log(f"{label}: {ASYNC_FRESH_ROUNDS} all-fresh rounds bit for bit the "
        f"training phase (records and parameters); the schedule (late "
        f"rows {list(ASYNC_LATE)}): n_overstale {got['n_overstale']}, "
        f"plan_reused {got['plan_reused']}, f_defended "
        f"{got['f_defended']}; round 2's plan round 1's bit for bit; "
        f"byzantine mass 0; launches {counts_b} over {len(ASYNC_LATE)} "
        f"rounds, all theta = {THETA_MAIN}; round 3's plan and aggregate "
        f"with the plain versions bit for bit the kernels'; peak memory "
        f"{out['peak_gib_fresh']:.2f} / {out['peak_gib_schedule']:.2f} GiB "
        f"(torch.cuda.max_memory_allocated; the buffer alone "
        f"{N * sum(p.numel() for p in tree_leaves(train_params)) * 4 / 1e9:.2f}"
        f" GB); round seconds {[round(s, 4) for s in seconds]} (the last "
        f"traced) against "
        f"the training phase's steady steps {[round(s, 4) for s in train_s]}"
        f"; K1 + K2 on the buffer {k1_ms:.4f} + {k2_ms:.4f} ms a round "
        f"(bound {bound_ms:.4f}); {time.perf_counter() - t0:.1f}s; card "
        f"{power}")
    return {"async_fresh": counts_a, "async_schedule": counts_b}, out


def recording_inputs_backend(rcfg):
    """:func:`recording_backend` that also keeps the first stack it is
    given."""
    base = recording_backend(rcfg)

    @dataclasses.dataclass(frozen=True)
    class Keeping(type(base)):
        inputs: list = dataclasses.field(default_factory=list,
                                         compare=False)

        def plan_stats(self, grads, **kw):
            if not self.inputs:
                self.inputs.append(grads)
            return super().plan_stats(grads, **kw)

    return Keeping.for_config(rcfg)


def micro_caches(torch, MD, cfg, reps, prompts, pad):
    """Each replica of ``reps`` prefilled lane by lane at B = 1 (one
    prompt a lane), the lanes and ``pad`` empty lanes concatenated on the
    cache batch axis; returns (caches a replica, the first replica's
    last logits a lane)."""
    from repro_torch.tree import tree_map
    caches, first = [], None
    for rep in reps:
        lanes, logits = [], []
        for p in prompts:
            lg, c = MD.prefill_fn(rep, cfg, {"tokens": p},
                                  chunk_q=p.shape[1], cache_len=MICRO_CACHE)
            lanes.append(c)
            logits.append(lg)
        lanes += [tree_map(torch.zeros_like, lanes[0])] * pad
        caches.append(tree_map(lambda *xs: torch.cat(xs, dim=1), *lanes))
        if first is None:
            first = torch.cat(logits)
    return caches, first


def microbatch_serving(torch, power, robust_out):
    """S2, ``serve.make_microbatch_serve_step`` over the robust serving
    phase's N replicas (N - F identical honest, replicas 0 and 1 their
    embedding x ROBUST_CORRUPT) at ROBUST_LAYERS layers: MICRO_LANES
    lanes, the first len(MICRO_PROMPTS) live at prompts of those lengths
    (each prefilled alone, cache length MICRO_CACHE), the rest padded;
    MICRO_NEW tokens, each lane fed its own greedy token at its own
    position.  K1 and K2 once a token on the (N, B x V) stack and nothing
    else; byzantine mass 0; the live lanes' fused logits the honest
    model's per-lane decode bit for bit, the padded lanes 0.  Then the
    microbatch step at one position for every lane against
    ``make_robust_serve_step`` (bits or the largest difference printed),
    and K1 / K2 on the first token's stack held to their plain versions and
    timed.  Returns (counts, numbers)."""
    from repro_torch import models as MD
    from repro_torch.configs import RobustConfig
    from repro_torch.dist.serving import make_robust_serve_step
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fused_select import fused_select_cuda
    from repro_torch.kernels.pairwise_sqdist import pairwise_stats_cuda
    from repro_torch.serve import make_microbatch_serve_step, pack_requests
    from repro_torch.tree import tree_map
    label = "S2 microbatch serving"
    t_phase = time.perf_counter()
    cfg = serving_config(ROBUST_LAYERS)
    honest = MD.init_model(cfg, seed=5, device="cuda")
    stack = tree_map(lambda t: torch.stack([t] * N), honest)
    for i, factor in enumerate(ROBUST_CORRUPT):
        stack["embed"]["table"][i] *= factor
    reps = [tree_map(lambda t: t[i], stack) for i in range(F + 1)]
    rcfg = RobustConfig(n_workers=N, f=F, gar="multi_bulyan",
                        use_kernels=True)
    backend = recording_inputs_backend(rcfg)
    live = len(MICRO_PROMPTS)
    pad = MICRO_LANES - live
    prompts = [serve_prompt(torch, 1, s, seed=20 + b)
               for b, s in enumerate(MICRO_PROMPTS)]
    with torch.no_grad():
        distinct, first = micro_caches(torch, MD, cfg, reps, prompts, pad)
        # replicas F.. are the honest model: one cache, stacked N - F times
        caches = tree_map(lambda *xs: torch.stack(xs),
                          *(distinct[:F] + [distinct[F]] * (N - F)))
        hcache = distinct[F]
        del distinct
        tok0 = torch.argmax(first, dim=-1).tolist()
        rb = pack_requests(tok0, list(MICRO_PROMPTS), MICRO_LANES,
                           device="cuda")
    step = make_microbatch_serve_step(cfg, rcfg, backend=backend)
    fused, step_s, wants = [], [], []
    ops.reset_launch_counts()
    with torch.no_grad():
        for t in range(MICRO_NEW):
            dt, (lg, caches) = wall_s(torch, lambda: step(stack, caches, rb))
            fused.append(lg)
            step_s.append(dt)
            rb = dataclasses.replace(rb, tokens=torch.cat([
                torch.argmax(lg[:live], dim=-1).int(),
                torch.zeros(pad, dtype=torch.int32, device="cuda")]),
                pos=rb.pos + rb.active.int())
    counts = ops.launch_counts()
    want = {**NO_KERNELS, "pairwise_stats": MICRO_NEW,
            "fused_select": MICRO_NEW}
    check(counts == want, f"{label}: launches {counts}, want {want}")
    variants = k2_variant_check(label, MICRO_NEW)
    byz = [float(p.diagnostics()["byz_mass"]) for p in backend.plans]
    check(len(byz) == MICRO_NEW and all(b == 0.0 for b in byz),
          f"{label}: byzantine mass {byz}")
    stack0 = backend.inputs[0]
    width = stack0[0].numel()
    check(tuple(stack0.shape) == (N, MICRO_LANES, cfg.vocab_size),
          f"{label}: the fused stack is {tuple(stack0.shape)}")
    # the honest model's own per-lane decode, fed the same tokens
    with torch.no_grad():
        rb = pack_requests(tok0, list(MICRO_PROMPTS), MICRO_LANES,
                           device="cuda")
        for t in range(MICRO_NEW):
            want_l, hcache = MD.decode_fn(honest, cfg, rb.tokens, hcache,
                                          rb.pos)
            check(fused[t].dtype == want_l.dtype and
                  torch.equal(fused[t][:live], want_l[:live]),
                  f"{label} token {t}: live lanes' fused logits differ from "
                  f"the honest model's (max diff "
                  f"{float((fused[t][:live].float() - want_l[:live].float()).abs().max())})")
            check(bool(torch.all(fused[t][live:] == 0)),
                  f"{label} token {t}: padded lanes not 0")
            rb = dataclasses.replace(rb, tokens=torch.cat([
                torch.argmax(fused[t][:live], dim=-1).int(),
                torch.zeros(pad, dtype=torch.int32, device="cuda")]),
                pos=rb.pos + rb.active.int())
    del caches, hcache, fused
    torch.cuda.empty_cache()
    # one position for every lane: the microbatch step against the batched
    # robust serve step
    with torch.no_grad():
        prompt = serve_prompt(torch, MICRO_LANES, SERVE_PROMPT, seed=31)
        ucaches = [MD.prefill_fn(rep, cfg, {"tokens": prompt},
                                 chunk_q=SERVE_PROMPT,
                                 cache_len=MICRO_CACHE) for rep in reps]
        tok = torch.argmax(ucaches[F][0], dim=-1).int()
        ucaches = tree_map(lambda *xs: torch.stack(xs), *(
            [c for _, c in ucaches[:F]] + [ucaches[F][1]] * (N - F)))
        urb = pack_requests([0] * MICRO_LANES, [SERVE_PROMPT] * MICRO_LANES,
                            MICRO_LANES, device="cuda")
        urb = dataclasses.replace(urb, tokens=tok)
        got_u, _ = make_microbatch_serve_step(cfg, rcfg)(stack, ucaches, urb)
        want_u, _ = make_robust_serve_step(cfg, rcfg)(stack, ucaches, tok,
                                                      SERVE_PROMPT)
        uniform_diff = float((got_u.float() - want_u.float()).abs().max())
        uniform_bits = bool(torch.equal(got_u, want_u))
    del ucaches, stack
    torch.cuda.empty_cache()
    # K1 and K2 on the first token's stack as the backend gives it to them
    x = stack0.reshape(N, -1).float().contiguous()
    raw, sq = pairwise_stats_cuda(x)
    raw_p, sq_p = ref.pairwise_stats_ref(x)
    err_d = compare_k1(torch, raw, raw_p)
    err_s = compare_k1(torch, sq, sq_p)
    check(err_d[1] <= K1_TOL and err_s[1] <= K1_TOL,
          f"{label}: K1 rel err dists {err_d[1]:.3e} norms {err_s[1]:.3e}")
    plan, plan_p = plan_of(raw), plan_of(raw_p)
    check(plan.beta == plan_p.beta and torch.equal(plan.w_ext, plan_p.w_ext)
          and torch.equal(plan.w_agr, plan_p.w_agr),
          f"{label}: the plan from K1's distances differs from the plain "
          f"one's")
    check(torch.equal(fused_select_cuda(x, plan.w_ext, plan.w_agr,
                                        plan.beta),
                      ref.fused_select_ref(x, plan.w_ext, plan.w_agr,
                                           plan.beta)),
          f"{label}: K2 differs from its plain version on the logit stack")
    k1_ms = time_ms(torch, lambda: pairwise_stats_cuda(x), 50)
    k2_ms = time_ms(torch, lambda: fused_select_cuda(
        x, plan.w_ext, plan.w_agr, plan.beta), 50)
    theta = plan.w_ext.shape[0]
    out = {"token_ms": 1e3 * statistics.mean(step_s[1:]),
           "token_ms_all": [round(1e3 * s, 4) for s in step_s],
           "ensemble_token_ms": robust_out["token_ms"],
           "k1_ms": k1_ms, "k2_ms": k2_ms,
           "k1_bound_ms": 1e3 * 4 * (N * width + N * N + N)
           / HBM_BYTES_PER_S,
           "k2_bound_ms": 1e3 * max(k2_bound_s(
               N, width, theta, plan.beta).values()),
           "k1_err": max(err_d[0], err_s[0]), "width": width,
           "uniform_bits": uniform_bits, "uniform_max_diff": uniform_diff}
    log(f"{label} ({N} replicas of qwen2-1.5b at {cfg.n_layers} layers, "
        f"{MICRO_LANES} lanes: {live} live at prompts {list(MICRO_PROMPTS)}"
        f", {pad} padded; {MICRO_NEW} tokens): launches {counts}, K2 "
        f"variants {variants}, on the ({N}, {width:,}) stack; byzantine "
        f"mass 0; the live lanes' fused logits the honest model's per-lane "
        f"decode bit for bit and the padded lanes 0 at every token; at one "
        f"position for every lane against make_robust_serve_step: "
        f"{'bit for bit' if uniform_bits else 'largest difference'} "
        f"{uniform_diff:.3e}; {out['token_ms']:.4f} ms a token (mean of "
        f"{MICRO_NEW - 1} after the first: {out['token_ms_all']}) against "
        f"the {SERVE_BATCH}-lane ensemble's {robust_out['token_ms']:.4f}; K1 "
        f"{k1_ms:.4f} ms (bound {out['k1_bound_ms']:.4f}) + K2 {k2_ms:.4f} "
        f"(bound {out['k2_bound_ms']:.4f}) on the first token's stack, "
        f"{100 * (k1_ms + k2_ms) / out['token_ms']:.1f} % of a token, each "
        f"held to its plain version (K1 max abs err {out['k1_err']:.3e}; "
        f"plans and K2 bit for bit); "
        f"{time.perf_counter() - t_phase:.1f}s; card {power}")
    return counts, out


def load_model(torch, power):
    """S3, ``serve.run_closed_loop`` in both modes at the JAX
    ``serve_bench`` defaults (n = N, f = F, 40 rounds, microbatch 8) for
    tau in LOAD_TAUS at each width of LOAD_WIDTHS.  Every replay of an
    arrival schedule (``loadgen.replay_rounds``) is recorded: K1 and K2
    once a round (and once for its warm-up round), nothing else, and its
    per-round accounting (``n_overstale``, ``plan_reused``,
    ``f_defended``) equal to a replay of the same masks on the CPU with
    the plain versions (at LOAD_CHECK_D columns: the accounting reads the
    ages only).  Returns (counts, {cell: result})."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.serve import loadgen as LG
    label = "S3 load model"
    t_phase = time.perf_counter()
    real = LG.replay_rounds
    replays = []

    def recording(cfg, fresh, device=None):
        out = real(cfg, fresh, device)
        replays.append((cfg, fresh.copy(), out))
        return out

    results, total = {}, collections.Counter()
    LG.replay_rounds = recording
    try:
        for d in LOAD_WIDTHS:
            for tau in LOAD_TAUS:
                cfg = LG.LoadConfig(n=N, f=F, d=d, tau=tau, rounds=40,
                                    microbatch=8)
                for mode in ("sync", "async"):
                    replays.clear()
                    ops.reset_launch_counts()
                    res = LG.run_closed_loop(cfg, mode, device="cuda")
                    counts = ops.launch_counts()
                    n_rounds = sum(c.rounds + 1 for c, _, _ in replays)
                    want = {**NO_KERNELS, "pairwise_stats": n_rounds,
                            "fused_select": n_rounds}
                    key = f"d={d} tau={tau} {mode}"
                    check(counts == want, f"{label} {key}: launches "
                          f"{counts}, want {want}")
                    total.update(counts)
                    for c, fresh, rec in replays:
                        cpu = real(dataclasses.replace(c, d=LOAD_CHECK_D),
                                   fresh, "cpu")
                        for k in ("n_overstale", "plan_reused",
                                  "f_defended"):
                            check(np.array_equal(rec[k], cpu[k]),
                                  f"{label} {key}: {k} {rec[k].tolist()} "
                                  f"against the CPU replay's "
                                  f"{cpu[k].tolist()}")
                    results[key] = res
                    log(f"{label} {key}: qps {res['qps']:.2f}, round us "
                        f"p50 {res['round_us_p50']:.1f} p95 "
                        f"{res['round_us_p95']:.1f} p99 "
                        f"{res['round_us_p99']:.1f}, agg_us "
                        f"{res['agg_us']:.1f}, stale rounds "
                        f"{res['stale_rounds']}, reused rounds "
                        f"{res['reused_rounds']}; {len(replays)} replays, "
                        f"launches {counts}, accounting the CPU replay's")
    finally:
        LG.replay_rounds = real
    torch.cuda.empty_cache()
    log(f"{label}: {json.dumps(results)}; "
        f"{time.perf_counter() - t_phase:.1f}s; card {power}")
    return dict(total), results


def network_exchanges(slots):
    """Compare-exchanges of select_tile.cuh's Batcher odd-even merge sort
    on `slots` slots (its Network<N>::size())."""
    c, p = 0, 1
    while p < slots:
        k = p
        while k >= 1:
            for j in range(k % p, slots - k, 2 * k):
                c += sum((i + j) // (2 * p) == (i + j + k) // (2 * p)
                         for i in range(min(k, slots - j - k)))
            k //= 2
        p *= 2
    return c


def kernel_slots(theta):
    """The register slots the kernels' selection runs on at ``theta``:
    theta up to 16, 32 up to 32, the network variant's bucket up to
    ``fused_select.MAX_WIDE_THETA`` (``NETWORK_SLOTS``: 40, 48, 64, 96 or
    128, at or below the next power of two), theta above (the counted
    kernels there rank every pair instead)."""
    from repro_torch.kernels import fused_select
    if theta <= 32:
        return theta if theta <= 16 else 32
    # a checkout without the network variant counts theta above 32
    return next((s for s in getattr(fused_select, "NETWORK_SLOTS", ())
                 if theta <= s), theta)


def select_phase_ops(theta, beta, slots=None):
    """fp32 operations of one coordinate's phase as select_tile.cuh's
    algorithm runs it for K2 and K3 on ``slots`` register slots: the
    median's network, two operations an exchange, and the midpoint for an
    even theta; theta differences and abs values; the threshold (theta -
    1 mins for beta = 1, the network again otherwise); a compare below and
    a compare at it a slot, beta adds and the division.  ``slots``
    defaults to the yardstick that versions of the kernels are compared
    on: theta up to 16, 32 up to 32, the next power of two above.
    :func:`kernel_slots` gives the slots the kernels run on: the same up
    to 32, their bucket's up to 128 (fewer operations, so a tighter
    bound), theta above, where the counted kernels rank every pair (about
    8 theta^2 operations, their algorithm's cost, which neither count
    charges).  Both count this algorithm's operations, not the least any
    algorithm could need."""
    if slots is None:
        slots = theta if theta <= 16 else 32 if theta <= 32 \
            else 1 << (theta - 1).bit_length()
    net = 2 * network_exchanges(slots)
    threshold = theta - 1 if beta == 1 else net
    return net + (0 if theta & 1 else 2) + 2 * theta + threshold \
        + 2 * theta + beta + 1


def k2_bound_s(n, m, theta, beta, slots=None):
    """K2's least seconds on an (n, m) stack, by bytes and by operations:
    the stack read once, the (m,) result written once, the two (theta, n)
    weights read once; the two contractions (a multiply and an add each a
    weight) and the coordinate phase (:func:`select_phase_ops` on
    ``slots``)."""
    return {"bytes": 4 * (n * m + m + 2 * theta * n) / HBM_BYTES_PER_S,
            "operations": (4 * theta * n + select_phase_ops(
                theta, beta, slots)) * m / FP32_FLOP_PER_S}


def k3_bound_s(m, theta, beta, slots=None):
    """K3's least seconds on (theta, m) g_ext and g_agr: both read once,
    the (m,) result written once; the coordinate phase's operations on
    ``slots``."""
    return {"bytes": 4 * (2 * theta * m + m) / HBM_BYTES_PER_S,
            "operations": select_phase_ops(theta, beta, slots) * m
            / FP32_FLOP_PER_S}


def time_ms(torch, fn, reps):
    """Median ms of ``fn()`` over ``reps`` runs after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def timing(torch, shapes, worst_k5):
    """Per-step sums over the main path's leaves of each function's median
    time, with the bound from this run's shapes.  K5 is also checked on
    every payload it is timed on, as in :func:`compare_k5`."""
    from repro_torch.core import api
    from repro_torch.kernels import ref
    from repro_torch.kernels.coord_select import coord_select_cuda
    from repro_torch.kernels.dequant_stats import dequant_stats_cuda
    from repro_torch.kernels.fused_select import fused_select_cuda
    from repro_torch.kernels.pairwise_sqdist import pairwise_stats_cuda
    numels = [math.prod(s[1:]) for s in shapes]
    leaves = [rows_stack(torch, m, seed=i) for i, m in enumerate(numels)]
    raw = torch.zeros((N, N), dtype=torch.float32, device="cuda")
    for x in leaves:
        raw = raw + pairwise_stats_cuda(x)[0]
    plan = plan_of(raw)
    theta = plan.w_ext.shape[0]
    tot = {k: 0.0 for k in ("k1", "k1_plain", "k1_lib", "k2", "k2_plain",
                            "k3", "k3_plain", "matmuls", "two_step")}
    bound = {k: {"bytes": 0.0, "operations": 0.0}
             for k in ("k1", "k2", "k3", "matmuls")}
    we, wa, beta = plan.w_ext, plan.w_agr, plan.beta
    for x in leaves:
        m = x.shape[1]
        reps = 5 if m > 10_000_000 else 20
        tot["k1"] += time_ms(torch, lambda: pairwise_stats_cuda(x), reps)
        tot["k1_plain"] += time_ms(
            torch, lambda: ref.pairwise_stats_ref(x), reps)
        tot["k1_lib"] += time_ms(torch, lambda: torch.mm(x, x.t()), reps)
        tot["k2"] += time_ms(torch, lambda: fused_select_cuda(
            x, plan.w_ext, plan.w_agr, plan.beta), reps)
        tot["k2_plain"] += time_ms(torch, lambda: ref.fused_select_ref(
            x, plan.w_ext, plan.w_agr, plan.beta), min(reps, 3))
        # each input read once, each output written once; fp32 operations
        # outside the tensor cores (the gram's upper triangle for K1; K2's
        # as k2_bound_s counts them)
        bound["k1"]["bytes"] += 4 * (N * m + N * N + N) / HBM_BYTES_PER_S
        bound["k1"]["operations"] += N * (N + 1) * m / FP32_FLOP_PER_S
        for key, v in k2_bound_s(N, m, theta, beta).items():
            bound["k2"][key] += v
        # the two-step apply at theta = 5: the two products, K3 on what
        # they formed (checked against its plain version), and the whole
        # substrate as _bulyan_leaf runs it
        ge, ga = torch.matmul(we, x), torch.matmul(wa, x)
        check(torch.equal(coord_select_cuda(ge, ga, beta),
                          ref.coord_select_ref(ge, ga, beta)),
              f"K3 on timed leaf d={m}: differs from its plain version")
        tot["k3"] += time_ms(torch, lambda: coord_select_cuda(ge, ga, beta),
                             reps)
        tot["k3_plain"] += time_ms(
            torch, lambda: ref.coord_select_ref(ge, ga, beta), min(reps, 3))
        del ge, ga
        tot["matmuls"] += time_ms(
            torch, lambda: (torch.matmul(we, x), torch.matmul(wa, x)), reps)
        tot["two_step"] += time_ms(torch, lambda: api._bulyan_leaf(
            we, wa, beta, x, use_kernels=True, fused=False), reps)
        # K3 as k3_bound_s counts it.  The products: the stack and a
        # weight matrix read, theta rows written, 2 theta n flops a
        # coordinate, each of the two.
        for key, v in k3_bound_s(m, theta, beta).items():
            bound["k3"][key] += v
        bound["matmuls"]["bytes"] += 2 * 4 * (N * m + theta * N
                                              + theta * m) / HBM_BYTES_PER_S
        bound["matmuls"]["operations"] += 2 * 2 * theta * N * m \
            / FP32_FLOP_PER_S
    profile_two_step(torch, leaves, plan)
    tot["k2_sweep"] = k2_sweep_timing(torch, leaves)
    del leaves
    torch.cuda.empty_cache()
    # K5 on the same leaf shapes, int8 then bf16 payloads (one type on the
    # card at a time), beside its plain version and decode + K1
    for dtype in (torch.int8, torch.bfloat16):
        tag = "int8" if dtype == torch.int8 else "bf16"
        for k in ("k5", "k5_plain", "k5_unfused"):
            tot[f"{k}_{tag}"] = 0.0
        b = bound[f"k5_{tag}"] = {"bytes": 0.0, "operations": 0.0}
        for i, m in enumerate(numels):
            p, mult = k5_payload(torch, N, m, dtype, seed=i)
            compare_k5(torch, f"timed {tag} leaf {i} d={m}", p, mult, F,
                       worst_k5)
            reps = 5 if m > 10_000_000 else 20
            tot[f"k5_{tag}"] += time_ms(
                torch, lambda: dequant_stats_cuda(p, mult), reps)
            tot[f"k5_plain_{tag}"] += time_ms(
                torch, lambda: ref.dequant_stats_ref(p, mult), min(reps, 3))
            tot[f"k5_unfused_{tag}"] += time_ms(
                torch, lambda: pairwise_stats_cuda(p.float() * mult[:, None]),
                reps)
            # the payload read once, the multipliers once, the outputs
            # written once; K1's operations plus one decode multiply an
            # element
            b["bytes"] += (N * m * p.element_size() + 4 * N
                           + 4 * (N * N + N)) / HBM_BYTES_PER_S
            b["operations"] += (N * (N + 1) + N) * m / FP32_FLOP_PER_S
            del p, mult
            torch.cuda.empty_cache()
    for k, b in bound.items():
        tot[f"{k}_bound_by"] = max(b, key=b.get)
        tot[f"{k}_bound"] = 1e3 * max(b.values())
    tot["two_step_bound"] = tot["k3_bound"] + tot["matmuls_bound"]
    log(f"timing over {len(shapes)} leaves ({sum(numels):,} coordinates "
        f"x {N} workers), ms per step: " + ", ".join(
            f"{k} {v}" for k, v in tot.items()))
    return tot


def k2_sweep_timing(torch, leaves):
    """K2 per step over the timed leaves for every (theta, beta) of K2_SWEEP
    on its synthetic plan, each leaf held bit for bit to the plain version;
    {"theta=t beta=b": ms}."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_select import fused_select_cuda
    out = {}
    for theta, beta in K2_SWEEP:
        we, wa = synthetic_plan(torch, theta, N, seed=theta * 10 + beta)
        ms = 0.0
        for i, x in enumerate(leaves):
            m = x.shape[1]
            check(torch.equal(fused_select_cuda(x, we, wa, beta),
                              ref.fused_select_ref(x, we, wa, beta)),
                  f"K2 sweep theta={theta} beta={beta} timed leaf {i} "
                  f"d={m}: differs from its plain version")
            ms += time_ms(torch, lambda: fused_select_cuda(x, we, wa, beta),
                          5 if m > 10_000_000 else 20)
        out[f"theta={theta} beta={beta}"] = ms
    log(f"K2 theta sweep at n={N} over the {len(leaves)} timed leaves (each "
        f"bit for bit its plain version), ms per step: " + ", ".join(
            f"{k} {v:.4f}" for k, v in out.items()))
    return out


def mesh_timing(torch, shapes):
    """Per-step sums over the main path's leaves of each mesh kernel's
    median time, beside its plain version, its library call and its bound
    from this run's shapes: K6 at 1x1 (the block is the stack: K1's
    symmetric grid; and, logged, a copy of the stack as the block: the
    rectangular grid at n_loc = n) and on the block of rank 1 of a
    MESH_W-rank mesh (3 of 12 rows, a view of the zero-padded stack: the
    rectangular grid's view path; and, logged, a copy of that block: the
    rectangular grid without it), K7 the same on int8 and bf16 payloads,
    and K4."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.dequant_stats import dequant_stats_rect_cuda
    from repro_torch.kernels.pairwise_sqdist import (pairwise_sqdist_cuda,
                                                     pairwise_stats_rect_cuda)
    numels = [math.prod(s[1:]) for s in shapes]
    tot = collections.defaultdict(float)
    bound = collections.defaultdict(lambda: {"bytes": 0.0, "operations": 0.0})

    def add_bound(key, in_bytes, n_loc, n_full, m, decode=0):
        # every input read once (a block that is a view of the stack is
        # the stack's bytes), the (n_loc, n_full) block and (n_full,)
        # norms written once; fp32 operations: the block's products and
        # the stack's squares (2 a multiply-add; a block that is the whole
        # stack needs only the gram's upper triangle, as K1's bound
        # counts), and a decode multiply an element for a payload
        products = n_full * (n_full + 1) if n_loc == n_full else \
            2 * (n_loc * n_full + n_full)
        b = bound[key]
        b["bytes"] += (in_bytes + 4 * (n_loc * n_full + n_full)) \
            / HBM_BYTES_PER_S
        b["operations"] += (products + decode) * m / FP32_FLOP_PER_S

    for i, m in enumerate(numels):
        reps = 5 if m > 10_000_000 else 20
        x = rows_stack(torch, m, seed=i)
        full, n_loc = padded(torch, x, MESH_W)
        blk = full[n_loc:2 * n_loc]
        tot["k6_1x1"] += time_ms(
            torch, lambda: pairwise_stats_rect_cuda(x, x, n=N), reps)
        tot["k6_1x1_plain"] += time_ms(
            torch, lambda: ref.pairwise_stats_rect_ref(x, x), min(reps, 3))
        tot["k6_1x1_lib"] += time_ms(torch, lambda: torch.mm(x, x.t()), reps)
        add_bound("k6_1x1", 4 * N * m, N, N, m)
        copy = x.clone()
        tot["k6_1x1_copy"] += time_ms(
            torch, lambda: pairwise_stats_rect_cuda(copy, x, n=N), reps)
        del copy
        tot["k6_block"] += time_ms(
            torch, lambda: pairwise_stats_rect_cuda(blk, full, n=N), reps)
        copy = blk.clone()
        tot["k6_block_copy"] += time_ms(
            torch, lambda: pairwise_stats_rect_cuda(copy, full, n=N), reps)
        del copy
        tot["k6_block_plain"] += time_ms(
            torch, lambda: ref.pairwise_stats_rect_ref(blk, full),
            min(reps, 3))
        tot["k6_block_lib"] += time_ms(
            torch, lambda: torch.mm(blk, full.t()), reps)
        add_bound("k6_block", 4 * full.shape[0] * m, n_loc, full.shape[0], m)
        tot["k4"] += time_ms(torch, lambda: pairwise_sqdist_cuda(x), reps)
        tot["k4_plain"] += time_ms(
            torch, lambda: ref.pairwise_sqdist_ref(x), min(reps, 3))
        tot["k4_lib"] += time_ms(torch, lambda: torch.mm(x, x.t()), reps)
        # K4: the stack read once, the (n, n) written once; the gram's
        # upper triangle, as K1's bound counts it
        bound["k4"]["bytes"] += 4 * (N * m + N * N) / HBM_BYTES_PER_S
        bound["k4"]["operations"] += N * (N + 1) * m / FP32_FLOP_PER_S
        del x, full, blk
        torch.cuda.empty_cache()
    for dtype in (torch.int8, torch.bfloat16):
        tag = "int8" if dtype == torch.int8 else "bf16"
        for i, m in enumerate(numels):
            reps = 5 if m > 10_000_000 else 20
            p, mult = k5_payload(torch, N, m, dtype, seed=i)
            pf, n_loc = padded(torch, p, MESH_W)
            mf, _ = padded(torch, mult, MESH_W)
            pb, mb = pf[n_loc:2 * n_loc], mf[n_loc:2 * n_loc]
            tot[f"k7_1x1_{tag}"] += time_ms(
                torch, lambda: dequant_stats_rect_cuda(p, mult, p, mult, n=N),
                reps)
            tot[f"k7_1x1_plain_{tag}"] += time_ms(
                torch, lambda: ref.dequant_stats_rect_ref(p, mult, p, mult),
                min(reps, 3))
            add_bound(f"k7_1x1_{tag}", p.element_size() * N * m + 4 * N, N,
                      N, m, decode=N)
            tot[f"k7_block_{tag}"] += time_ms(
                torch, lambda: dequant_stats_rect_cuda(pb, mb, pf, mf, n=N),
                reps)
            tot[f"k7_block_plain_{tag}"] += time_ms(
                torch, lambda: ref.dequant_stats_rect_ref(pb, mb, pf, mf),
                min(reps, 3))
            add_bound(f"k7_block_{tag}", p.element_size() * pf.shape[0] * m
                      + 4 * pf.shape[0], n_loc, pf.shape[0], m,
                      decode=pf.shape[0])
            del p, mult, pf, mf, pb, mb
            torch.cuda.empty_cache()
    out = dict(tot)
    for k, b in bound.items():
        out[f"{k}_bound_by"] = max(b, key=b.get)
        out[f"{k}_bound"] = 1e3 * max(b.values())
    log(f"mesh kernels over {len(shapes)} leaves, ms per step: " + ", ".join(
        f"{k} {v}" for k, v in out.items()))
    return out


def profile_step(torch, label, attack, codec=None):
    """One steady-state step of the training phase's configuration (with
    ``attack`` and ``codec``), traced: device time summed over the kernels
    the profiler saw, against the step's wall time (synchronised; the
    profiler's own cost included)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import models as MD
    from repro_torch.configs import RobustConfig, get_config
    from repro_torch.data import lm_batches
    from repro_torch.dist import (init_train_state, make_train_step,
                                  split_workers)
    from repro_torch.optim import constant, sgd
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=2)
    rcfg = RobustConfig(n_workers=N, f=F, gar="multi_bulyan")
    opt = sgd(momentum=0.9)
    params = MD.init_model(cfg, seed=0, device="cuda")
    state = init_train_state(opt, params, n_workers=N, attack=attack,
                             attack_f=F, codec=codec)
    step = make_train_step(cfg, rcfg, opt, constant(0.05), chunk_q=128,
                           attack=attack, codec=codec, telemetry=True)
    data = lm_batches(cfg.vocab_size, 2 * N, 128, seed=0)

    def one(params, state, i):
        wb = {k: v.to("cuda") for k, v in split_workers(next(data),
                                                         N).items()}
        return step(params, state, wb, i)

    params, state, _ = one(params, state, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, _ = one(params, state, 1)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    del params, state
    torch.cuda.empty_cache()
    log_profile(torch, prof, f"{label}: one step", wall_ms, 15)


def log_profile(torch, prof, label, wall_ms, top):
    """Device time summed by kernel name over a ``torch.profiler`` trace,
    against ``wall_ms``; the ``top`` kernels by time."""
    per_kernel = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            acc = per_kernel[e.name]
            acc[0] += e.time_range.elapsed_us() / 1e3
            acc[1] += 1
    busy_ms = sum(v[0] for v in per_kernel.values())
    rows = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
    # K1's (and K5's, K6's) stats_tile kernels and K2's
    ours = sum(v[0] for k, v in per_kernel.items()
               if "stats_tile::" in k or "fused_select" in k)
    launches = sum(v[1] for v in per_kernel.values())
    log(f"profile {label} {wall_ms:.1f} ms wall under the profiler, "
        f"kernels busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%), "
        f"{launches} kernel launches; the statistics' and K2's kernels "
        f"{ours:.1f} ms")
    for name, (ms, count) in rows[:top]:
        log(f"  {ms:10.3f} ms {count:6d}x  {name[:100]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "ours_ms": ours,
            "launches": launches}


def profile_two_step(torch, leaves, plan):
    """One two-step apply over the timed leaves, traced: which kernels
    form the products, beside K3."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import api
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for x in leaves:
            api._bulyan_leaf(plan.w_ext, plan.w_agr, plan.beta, x,
                             use_kernels=True, fused=False)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    log_profile(torch, prof, "two-step apply (fused=False), 14 leaves:",
                wall_ms, 6)


def main():
    try:
        import torch
    except ImportError:
        print("[chip_smoke] FAIL: torch is not installed", flush=True)
        return 2
    if not torch.cuda.is_available():
        print("[chip_smoke] FAIL: torch.cuda.is_available() is False; this "
              "smoke run needs a CUDA card", flush=True)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"[chip_smoke] FAIL: no src/repro_torch next to {__file__}; "
              "run from a checkout of the repository", flush=True)
        return 2
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_main = time.perf_counter()
    try:
        power = header()
        build_kernels()
        t0 = time.perf_counter()
        worst = kernels_vs_plain(torch)
        worst_k5 = k5_vs_plain(torch)
        worst_rect = rect_vs_square(torch)
        log(f"kernels vs plain versions: {time.perf_counter() - t0:.1f}s; "
            f"K5 worst relative error {worst_k5['max_rel']:.3e}")
        counts, shapes, history, params, peak = training(torch)
        step_s = [rec["seconds"] for rec in history]
        counts_mesh_train = mesh_training(torch, history, params)
        params = to_host(params)
        torch.cuda.empty_cache()
        counts_wire, wire_s = wire_training(torch)
        counts_mesh_wire, wire_hist, wire_params = mesh_wire_training(torch)
        counts_stream = streaming_training(torch, power, history, params,
                                           peak, wire_hist, wire_params)
        del wire_params
        counts_hier, hier_numbers = hier_training(torch, power, history,
                                                  params, worst_k5)
        counts_async, async_out = async_training(torch, power, history,
                                                 params)
        del params
        real_wire_k5(torch, worst_k5)
        worst_k3 = k3_vs_plain(torch)
        t0 = time.perf_counter()
        _, wide_sweep = wide_theta_sweep(torch, power)
        log(f"theta > 32 sweep: {time.perf_counter() - t0:.1f}s")
        counts_k3, held, n_diff = two_step_substrate(torch)
        transform_training(torch)
        counts_phase = {"training": counts, **adaptive_training(torch)}
        counts_phase["checkpoint"], *_ = checkpoint_phase(torch, power)
        counts_phase["quickstart"] = quickstart(torch)
        counts_phase["mesh_training"] = counts_mesh_train
        counts_phase["mesh_wire"] = counts_mesh_wire
        counts_phase.update(counts_stream)
        counts_phase.update(counts_hier)
        counts_mesh = mesh_statistics(torch)
        counts_tiles, tile_ms, tile_bound, tile_bound_by = mesh_tiles(torch)
        t0 = time.perf_counter()
        counts_phase["serving"], serve_out = serving(torch, power)
        serving_consistency(torch, power)
        counts_phase["robust_serving"], robust_out = robust_serving(torch,
                                                                    power)
        log(f"serving phases: {time.perf_counter() - t0:.1f}s")
        counts_phase["microbatch_serving"], micro_out = microbatch_serving(
            torch, power, robust_out)
        counts_phase["load_model"], load_out = load_model(torch, power)
        counts_phase.update(counts_async)
        t0 = time.perf_counter()
        counts_fam, fam_train = family_training(torch, power)
        log(f"decoder families, training: {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        counts_serve, fam_serve = family_serving(torch, power)
        counts_fam.update(counts_serve)
        log(f"decoder families, serving: {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        counts_fam.update(every_config_reduced(torch))
        log(f"every config reduced: {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        moe_tot = moe_leaves(torch)
        log(f"qwen3-moe leaves: {time.perf_counter() - t0:.1f}s")
        counts_phase.update(counts_fam)
        t0 = time.perf_counter()
        counts_ed, ed_train, wide = encdec_training(torch, power)
        log(f"encoder-decoder, training: {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        counts_serve, ed_serve = encdec_serving(torch, power)
        counts_ed.update(counts_serve)
        log(f"encoder-decoder, serving: {time.perf_counter() - t0:.1f}s")
        counts_phase.update(counts_ed)
        tot = timing(torch, shapes, worst_k5)
        tot_mesh = mesh_timing(torch, shapes)
        log(f"K5 worst relative error over every check: "
            f"{worst_k5['max_rel']:.3e}")
        for t in ("int8", "bf16"):
            log(f"K5 {t} payload, ms per step: kernel {tot[f'k5_{t}']:.4f}, "
                f"bound {tot[f'k5_{t}_bound']:.4f} "
                f"({tot[f'k5_{t}_bound_by']}), plain "
                f"{tot[f'k5_plain_{t}']:.4f}, decode + K1 "
                f"{tot[f'k5_unfused_{t}']:.4f}")
        log(f"two-step apply, ms per step: products {tot['matmuls']:.4f} "
            f"(bound {tot['matmuls_bound']:.4f}) + K3 {tot['k3']:.4f} "
            f"(bound {tot['k3_bound']:.4f}); whole substrate "
            f"{tot['two_step']:.4f} (bound {tot['two_step_bound']:.4f}) "
            f"against K2 {tot['k2']:.4f} (bound {tot['k2_bound']:.4f}): "
            f"fusion win {tot['two_step'] / tot['k2']:.3f}x; {held} K3 "
            f"launches on the real stack held to the plain version; "
            f"coordinates at near-ties {n_diff}")
        log(f"mesh kernels, ms per step: K6 1x1 {tot_mesh['k6_1x1']:.4f} "
            f"(bound {tot_mesh['k6_1x1_bound']:.4f}, torch.mm "
            f"{tot_mesh['k6_1x1_lib']:.4f}) and on a {MESH_W}-rank block "
            f"{tot_mesh['k6_block']:.4f} (bound "
            f"{tot_mesh['k6_block_bound']:.4f}) against K1 {tot['k1']:.4f}; "
            f"K6 1x1 on a copy of the stack (rectangular grid) "
            f"{tot_mesh['k6_1x1_copy']:.4f}, on a copy of the block (no "
            f"view path) {tot_mesh['k6_block_copy']:.4f}; "
            f"K7 int8 {tot_mesh['k7_1x1_int8']:.4f}, bf16 "
            f"{tot_mesh['k7_1x1_bf16']:.4f} against K5 {tot['k5_int8']:.4f}, "
            f"{tot['k5_bf16']:.4f}, on a block int8 "
            f"{tot_mesh['k7_block_int8']:.4f}, bf16 "
            f"{tot_mesh['k7_block_bf16']:.4f}; K4 {tot_mesh['k4']:.4f} (bound "
            f"{tot_mesh['k4_bound']:.4f})")
        profile_step(torch, "uncompressed (inf)", "inf")
        profile_step(torch, "wire A (qsgd:bits=8, scale_poison)",
                     "scale_poison", "qsgd:bits=8")
        profile_step(torch, "adaptive A (adaptive_lie)", "adaptive_lie")
    except SmokeFailure as e:
        print(f"[chip_smoke] FAIL: {e}", flush=True)
        return 1
    kernels = [
        {"name": "pairwise_stats", "route": "cuda",
         "source": "src/repro_torch/csrc/pairwise_stats.cu",
         "replaces": "src/repro/kernels/pairwise_sqdist.py:139",
         "launches": counts["pairwise_stats"],
         "launches_by_phase": {k: c["pairwise_stats"]
                               for k, c in counts_phase.items()},
         "max_abs_err": worst["pairwise_stats"],
         "ms": tot["k1"], "plain_ms": tot["k1_plain"],
         "bound_ms": tot["k1_bound"], "bound_by": tot["k1_bound_by"],
         "library_ms": tot["k1_lib"],
         # one launch on the robust serving phase's (N, B*V) logit stack
         "serving_ms": robust_out["k1_ms"],
         "serving_bound_ms": robust_out["k1_bound_ms"],
         # one launch on each of the MoE phase's largest leaves
         "moe_leaves": {leaf: {k[3:]: v for k, v in r.items()
                               if k.startswith("k1_")}
                        for leaf, r in moe_tot.items()},
         # S1: one launch a leaf over the async buffer's 14 leaves; S2: one
         # launch on the microbatch's (N, 8 x V) logit stack
         "async_buffer_ms": async_out["k1_ms"],
         "microbatch_ms": micro_out["k1_ms"],
         "microbatch_bound_ms": micro_out["k1_bound_ms"]},
        {"name": "fused_select", "route": "cuda",
         "source": "src/repro_torch/csrc/fused_select.cu",
         "replaces": "src/repro/kernels/fused_select.py:142",
         "launches": counts["fused_select"],
         "launches_by_phase": {
             **{k: c["fused_select"] for k, c in counts_phase.items()},
             **{f"mesh_tiles {k.split()[0]}": c["fused_select"]
                for k, c in counts_tiles.items() if k.endswith("k2")}},
         "max_abs_err": worst["fused_select"],
         "ms": tot["k2"], "plain_ms": tot["k2_plain"],
         "bound_ms": tot["k2_bound"], "bound_by": tot["k2_bound_by"],
         "library_ms": None,
         # one rank's launches on its (12, d/M) tiles of the real leaves,
         # per step, beside the replicated launch on the same leaves
         "tile_ms": tile_ms, "tile_bound_ms": tile_bound,
         "tile_bound_by": tile_bound_by,
         "serving_ms": robust_out["k2_ms"],
         "serving_bound_ms": robust_out["k2_bound_ms"],
         "moe_leaves": {leaf: {k[3:]: v for k, v in r.items()
                               if k.startswith("k2_")}
                        for leaf, r in moe_tot.items()},
         "async_buffer_ms": async_out["k2_ms"],
         "microbatch_ms": micro_out["k2_ms"],
         "microbatch_bound_ms": micro_out["k2_bound_ms"],
         # the launches of each variant: the main path's theta = 5 kernel,
         # and the network one (theta > 32) of whisper at n = 40
         "variant_launches": {"theta=5": counts["fused_select"],
                              "theta=3": counts_hier["hier"][
                                  "fused_select"],
                              "theta>32": counts_ed["whisper_wide"][
                                  "fused_select"]},
         "theta>32": wide_entry(wide, "k2", counts_ed["whisper_wide"][
             "fused_select"]),
         # each theta of select_cases.WIDE_THETAS on one synthetic stack
         "wide_sweep": {k: {m[3:]: v for m, v in r.items()
                            if m.startswith("k2_")} | {
                                "variant": r["variant"]}
                        for k, r in wide_sweep.items()},
         # stats + plan + apply, flat against grouped (g = 7), on H1's
         # and H6's stacks
         "hier_ms": {k: hier_numbers[k] for k in ("hier_h2",
                                                  "hier_whisper")}},
        {"name": "dequant_stats", "route": "cuda",
         "source": "src/repro_torch/csrc/dequant_stats.cu",
         "replaces": "src/repro/kernels/dequant_stats.py:90",
         "launches": counts_wire["dequant_stats"],
         "launches_by_phase": {
             "wire_a": counts_wire["dequant_stats"],
             "stream_wire": counts_stream["stream_wire"]["dequant_stats"],
             "hier_wire": counts_hier["hier_wire"]["dequant_stats"],
             "hier_wire_stream":
                 counts_hier["hier_wire_stream"]["dequant_stats"]},
         "max_abs_err": worst_k5["max_abs"],
         # over every group's slice of H5's payload (in max_abs_err too)
         "hier_wire_max_abs_err": hier_numbers["hier_wire"][
             "k5_group_slices_max_abs_err"],
         "ms": tot["k5_int8"], "plain_ms": tot["k5_plain_int8"],
         "bound_ms": tot["k5_int8_bound"],
         "bound_by": tot["k5_int8_bound_by"], "library_ms": None},
        {"name": "coord_select", "route": "cuda",
         "source": "src/repro_torch/csrc/coord_select.cu",
         "replaces": "src/repro/kernels/coord_select.py:50",
         "launches": counts_k3["coord_select"],
         "launches_by_phase": {
             "two_step": counts_k3["coord_select"],
             **{f"mesh_tiles {k.split()[0]}": c["coord_select"]
                for k, c in counts_tiles.items() if k.endswith("k3")}},
         "max_abs_err": worst_k3,
         "ms": tot["k3"], "plain_ms": tot["k3_plain"],
         "bound_ms": tot["k3_bound"], "bound_by": tot["k3_bound_by"],
         "library_ms": None,
         "variant_launches": {"theta=5": counts_k3["coord_select"],
                              "theta>32": counts_ed["whisper_two_step"][
                                  "coord_select"]},
         "theta>32": wide_entry(wide, "k3", counts_ed["whisper_two_step"][
             "coord_select"]),
         "wide_sweep": {k: {m[3:]: v for m, v in r.items()
                            if m.startswith("k3_")} | {
                                "variant": r["variant"]}
                        for k, r in wide_sweep.items()}},
        # K6 and K7 have two grids, one entry each: on the one-rank NCCL
        # mesh the block is the stack, and they run the square kernel's
        # symmetric grid (stats_tile.cuh) from their own sources; a block
        # of a W-rank mesh runs the rectangular grid (stats_rect.cuh),
        # here the MESH_W blocks of the mesh phase
        {"name": "pairwise_stats_rect", "route": "cuda",
         "source": "src/repro_torch/csrc/pairwise_stats_rect.cu",
         "replaces": "src/repro/kernels/pairwise_sqdist.py:221",
         "grid": "symmetric (stats_tile.cuh): 1x1 mesh, the block is the "
                 "stack",
         "launches": counts_mesh["tree"]["pairwise_stats_rect"],
         "launches_by_phase": {
             "mesh_statistics": counts_mesh["tree"]["pairwise_stats_rect"],
             "mesh_training": counts_mesh_train["pairwise_stats_rect"],
             "stream_mesh":
                 counts_stream["stream_mesh"]["pairwise_stats_rect"]},
         "max_abs_err": worst_rect["pairwise_stats_rect"],
         "ms": tot_mesh["k6_1x1"], "plain_ms": tot_mesh["k6_1x1_plain"],
         "bound_ms": tot_mesh["k6_1x1_bound"],
         "bound_by": tot_mesh["k6_1x1_bound_by"],
         "library_ms": tot_mesh["k6_1x1_lib"]},
        {"name": "pairwise_stats_rect_block", "route": "cuda",
         "source": "src/repro_torch/csrc/pairwise_stats_rect.cu",
         "replaces": "src/repro/kernels/pairwise_sqdist.py:221",
         "grid": f"rectangular (stats_rect.cuh): {MESH_W}-rank mesh, "
                 f"{-(-N // MESH_W)} of {-(-N // MESH_W) * MESH_W} rows",
         "path": "view",
         "launches": counts_mesh["tree_block"],
         "max_abs_err": worst_rect["pairwise_stats_rect_block"],
         "ms": tot_mesh["k6_block"], "plain_ms": tot_mesh["k6_block_plain"],
         "bound_ms": tot_mesh["k6_block_bound"],
         "bound_by": tot_mesh["k6_block_bound_by"],
         "library_ms": tot_mesh["k6_block_lib"]},
        {"name": "dequant_stats_rect", "route": "cuda",
         "source": "src/repro_torch/csrc/dequant_stats_rect.cu",
         "replaces": "src/repro/kernels/dequant_stats.py:173",
         "grid": "symmetric (stats_tile.cuh): 1x1 mesh, the block is the "
                 "payload",
         "launches": counts_mesh["wire"]["dequant_stats_rect"],
         "launches_by_phase": {
             "mesh_statistics": counts_mesh["wire"]["dequant_stats_rect"],
             "mesh_wire": counts_mesh_wire["dequant_stats_rect"]},
         "max_abs_err": worst_rect["dequant_stats_rect"],
         "ms": tot_mesh["k7_1x1_int8"],
         "plain_ms": tot_mesh["k7_1x1_plain_int8"],
         "bound_ms": tot_mesh["k7_1x1_int8_bound"],
         "bound_by": tot_mesh["k7_1x1_int8_bound_by"], "library_ms": None},
        {"name": "dequant_stats_rect_block", "route": "cuda",
         "source": "src/repro_torch/csrc/dequant_stats_rect.cu",
         "replaces": "src/repro/kernels/dequant_stats.py:173",
         "grid": f"rectangular (stats_rect.cuh): {MESH_W}-rank mesh, "
                 f"{-(-N // MESH_W)} of {-(-N // MESH_W) * MESH_W} rows",
         "launches": counts_mesh["wire_block"],
         "max_abs_err": worst_rect["dequant_stats_rect_block"],
         "ms": tot_mesh["k7_block_int8"],
         "plain_ms": tot_mesh["k7_block_plain_int8"],
         "bound_ms": tot_mesh["k7_block_int8_bound"],
         "bound_by": tot_mesh["k7_block_int8_bound_by"],
         "library_ms": None},
        # K4 has no caller on the training or mesh paths (they accumulate
        # raw per-leaf statistics and finalise once), so 0 launches there
        {"name": "pairwise_sqdist", "route": "cuda",
         "source": "src/repro_torch/csrc/pairwise_sqdist.cu",
         "replaces": "src/repro/kernels/pairwise_sqdist.py:67",
         "launches": counts["pairwise_sqdist"],
         "max_abs_err": worst_rect["pairwise_sqdist"],
         "ms": tot_mesh["k4"], "plain_ms": tot_mesh["k4_plain"],
         "bound_ms": tot_mesh["k4_bound"],
         "bound_by": tot_mesh["k4_bound_by"],
         "library_ms": tot_mesh["k4_lib"]},
    ]
    log(f"mesh apply tiles, one rank's K2 per step: " + ", ".join(
        f"{k} {tile_ms[k]:.4f} ms (bound {tile_bound[k]:.4f}, "
        f"{tile_bound_by[k]})" for k in tile_ms) + f"; card {power}")
    log(f"serving: prefill {serve_out['prefill_s']:.4f} s, decode "
        f"{serve_out['decode_ms']:.4f} ms a token (weight-read bound "
        f"{serve_out['decode_bound_ms']:.4f}), {serve_out['tok_s']:.1f} "
        f"tok/s; robust ensemble {robust_out['token_ms']:.4f} ms a token, "
        f"K1 + K2 {robust_out['k1_ms'] + robust_out['k2_ms']:.4f} ms of it; "
        f"card {power}")
    log(f"decoder families: training {json.dumps(fam_train)}; serving "
        f"{json.dumps({k: v for k, v in fam_serve.items() if k != 'decode_consistency'})}; "
        f"decode consistency {fam_serve['decode_consistency']}; card {power}")
    log(f"hierarchical (repro_torch.hier): {json.dumps(hier_numbers)}; "
        f"card {power}")
    log(f"async service (repro_torch.serve): S1 {json.dumps(async_out)}; "
        f"S2 {json.dumps(micro_out)}; S3 {json.dumps(load_out)}; card "
        f"{power}")
    log(f"encoder-decoder (whisper-tiny): training {json.dumps(ed_train)}; "
        f"serving {json.dumps(ed_serve)}; the network variants at n = "
        f"{WIDE_N} {json.dumps(wide)}; card {power}")
    log(f"card: {power}; step seconds {step_s}; wire A step seconds "
        f"{wire_s}; whole run {time.perf_counter() - t_main:.1f}s (the "
        f"kernels' build included)")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
