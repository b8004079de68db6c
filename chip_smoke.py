#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root; needs one CUDA card

Phases, each printed on its own line, any failure raising (exit code != 0):

  1. device: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``.
  2. build: ``nvcc`` builds every kernel source of the port (in parallel);
     the ``-Xptxas -v`` summary (registers, shared memory, spills) is printed.
     (The SASS loop sizes the kernel headers quote come from
     ``python -m repro_torch.kernels.sass``, run on demand.)
  3. kernels: K1 and K2 (BEHAV statistics), K3 (dominance counts, and its
     front peel ``constraint_fronts``) and K4 and K5 (table GEMV) are held
     against their plain PyTorch versions on the card at the shapes of the
     paths below -- int channels, counts, fronts and GEMV outputs exactly,
     the f32 channel to 1e-5 relative; K5 against K4 -- and timed with CUDA
     events beside the plain versions and a bound computed from the shapes.
     K1's and K2's records time their register walks beside their first
     designs (``behav_stats_table_first``, ``behav_stats_entry_first``, held
     equal too), at D=258 and at a ragged D=37; K2's also times both of its
     walk's tiers (4 and 1 configs a thread, ``behav_stats_entry_at``)
     there.  K2's bound counts K1's 11 instructions a (config, pair), the
     exact product's and the reciprocal's 5 once a pair and each config's
     plane values once.
     K3's record times the front
     peel beside the round-by-round route it replaces (a
     ``dominance_counts`` launch and a host sync a front).  K4/K5 run at the
     mnist head (D=128, M=250, K=256, N=10), the ffn GEMM1 (M=96, K=64,
     N=128), a ragged K=100 and the two convolutions (ecg M=2,034, K=15;
     gauss M=8,464, K=25; N=1), the apps' own codes; K4 through both of its
     routes (staged and gather), each held equal and timed, and the route its
     ``plan`` picks printed; K5's nibble-plane design beside its first design
     (``entry_gemv_first``), both held equal and timed at every shape, with
     the blocks a config's slabs are split over; K5's bound, as K4's for the
     same function, is one shared-memory word a product at one word a bank a
     clock (beside a load and an add a product at the issue rate, and its
     bytes; the term that sets it is named), and the earlier count (3 ALU
     operations a row a lookup) is printed beside it; their
     yardstick (``library_ms``) is the ``gemm`` route, four cuBLAS f32
     GEMMs.  Then K4's route boundary: both routes, held equal, timed at
     0.25 to 2 lookups per table entry in two shape families, random codes.
  4. main path: the 8x8 signed-multiplier DSE of the paper at full scale
     (2,000 random + pattern training configs characterized exhaustively,
     105-problem MaP battery, NSGA-II at population 64 for 100 generations)
     through ``build_training_dataset``, ``map_solution_pool`` and ``run_dse``
     for ``ga``, ``map`` and ``map+ga``; the last one validates through the
     table-free kernel K2.  Kernel launch counts are zeroed before and read
     after; every kernel must have launched, K3 once per GA ranking.  The
     validated fronts' BEHAV is checked against the numpy backend.  K2's
     path launch is recorded; its D is printed and both of K2's designs, and
     both tiers of its walk, are timed at it afterwards.
  apps: the application-targeted DSE (paper Table 2).  All four apps' BEHAV is
     attached to phase 4's training set with ``characterized_dataset_multi``
     (K4 for the mnist head and the ffn GEMM1), then ``run_dse(...,
     app=DigitClassification())`` runs ``ga`` and ``map`` (K4, K1, K3) and
     ``map+ga`` on ``kernel_impl="entry"`` (K5, K2, K3) at population 64 x 100
     generations.  Launch counts are zeroed before and read after; every
     kernel must have launched, K4 106 times, each app shape on the route
     its ``plan`` picks.  K5's path launch is recorded; its D and shape are
     printed and both of K5's designs are timed at them afterwards.  Then
     the checks: a 64-config subset of the training set's app BEHAV is held
     against the numpy oracle (ecg and mnist
     exactly, gauss and ffn to 1e-6 relative), and each validated front's
     APP_MNIST must equal the numpy oracle exactly, and its PPA too.
     Under the default ``table`` route the ecg and gauss convolutions are
     K4's N=1 table matmul (held and timed at those shapes in phase 3).
  5. GA contract: the device NSGA-II's feasible-archive hypervolume within 2%
     of the numpy NSGA-II on the fitted 8-bit surrogate (population 32, 30
     generations), as a mean over seeds 0-19.
  wide: ``behav_metrics_sampled`` on 64 12-bit and 64 16-bit configs at
     32,768 samples (the accurate config reads 0; an 8-config subset equals
     the CPU path); the unsigned 8-bit training set (2,000 random + pattern
     configs) through K1, a 64-config subset equal to the numpy backend, and
     ``run_dse(..., "ga")`` on it, its validated front's BEHAV equal to
     numpy; 12-bit mnist BEHAV of 64 configs through K5's 12-bit instance
     (its launches counted), a subset equal to the plain route.
  sweep: ``run_dse_sweep(spec_for(8), <phase 4's set>, "map+ga", seeds (0,
     1), const_sf_grid=CONST_SF_GRID)``: 12 lanes at population 64 x 100
     generations in one batched GA; K3 over lanes must launch once a ranking
     (200) and the per-lane K3 never; the (seed 0, const_sf 0.5) lane equals
     phase 4's map+ga run (hv_ppf to 1e-5, the same validated front); every
     lane's validated BEHAV equals numpy.
  service: an ``OperatorStore`` in a temporary directory and a
     ``DSEJobQueue(default_runner(...))`` behind a ``MetricsServer`` with the
     three ``/dse`` routes: 6 mul8 requests (every other const_sf of the
     sweep's grid, both seeds; their fronts equal the sweep's lanes) posted
     over HTTP are one batched sweep (200 K3 launches), and posted again are
     all answered from the library (no GA, no K3 launch); ``/dse/library``,
     ``/metrics`` and ``/healthz`` (the card's name) are read; then
     ``serve.main --metrics-port 0 --dse-smoke 4`` at the reduced granite
     config, its own self-test, with a fresh library.
  serve: AxO serving of granite-3-2b at full width and depth (40 layers, d
     2048, 32/8 heads, d_ff 8192, vocab 49,155, bf16, random weights from a
     seed) through ``repro_torch.launch.serve.main``: batch 4, prompt 128,
     16 generated tokens, exact and with the rank-8 demo operator in every
     projection and the tied head.  Kernel launch counts are zeroed before
     and read after: K7 runs 40 times per prefill, K6 7 x 40 + 1 times per AxO
     forward.  Then the checks: the AxO teacher-forced pass and the exact
     prefill replayed with ``kernel_impl="plain"`` agree with the kernel
     passes within 1e-3 relative norm of the logits, and at the reduced
     config in f32 with the reference test's mild rank-16 operator the AxO
     logits keep its fidelity bounds (top-1 >= 0.5, rel < 0.5).  The warm
     passes are profiled, and K6's share of the device time of a decode step
     and of a prefill is printed.
  serve-ssm: Mamba-2 serving of mamba2-130m at full width and depth (24
     mamba layers, d 768, 24 SSD heads of 64, state 128, vocab 50,280, bf16,
     random weights from a seed) through ``serve.main``: batch 8, prompt 2,000
     (16 chunks of 128, the last ragged), 32 generated tokens, exact and with
     the rank-8 demo operator at the tied head (a mamba layer has no AxO
     entries).  Launch counts are zeroed before and read after: K8 runs 24
     times per prefill, K6 once per AxO forward, K7 never.  Then every K8 call
     of an exact prefill and of the AxO teacher-forced replay is held against
     its plain version (y to one bf16 ulp of its scale, the state to 1e-5),
     the exact prefill's logits against the plain pass's end to end (to
     SERVE_REL, or, where one bf16 ulp of input moves the plain pass by more,
     to twice what re-rounding the plain scan at K8's chunk length does), and
     at the reduced config in f32 (prompt 40 = 3 chunks of 16, ragged) the
     kernel passes' logits against the plain passes' to SERVE_REL.
  serve-dense: internlm2-1.8b (d 2048, 16/8 heads of 128, d_ff 8192, vocab
     92,544) and starcoder2-3b (d 3072, 24/2 heads of 128, gelu, d_ff
     12,288, vocab 49,152) at full width cut to 8 of their 24 and 30 layers
     (to keep the script within its time budget; full depth adds repeats
     of the same layer), and deepseek-67b at full width
     (d 8192, 64/8 heads of 128, d_ff 22,016, vocab 102,400) cut to 8 of its
     95 layers (the bf16 weights of all 95 are ~134 GB), each built with
     ``dataclasses.replace`` and served by ``serve.serve_config``, the run
     ``serve.main`` makes for the config it resolves; each at batch 4, prompt 128, 8 new tokens, exact and with the
     rank-8 demo operator in every projection and the head.  Launch counts
     are zeroed before and read after: K7 at hd 128 in every prefill layer,
     K6 once a deployed projection a forward.  Every K7 call of an exact
     prefill and every K6 and K7 call of the AxO prefill and first decode
     step is held against its plain version; warm prefill and decode times,
     their profiled device time and the peak memory are printed, and each
     model is freed before the next.
  serve-moe: kimi-k2-1t-a32b at full width (d 7168, 64/8 heads of 112, 384
     experts top-8 of d_ff 2,048 + 1 shared, dense d_ff 18,432, vocab
     163,840) cut to its dense layer and one moe layer (2 of 61; ~19.9 G
     parameters, all 384 experts kept), the same way and with the same
     checks: K7 at hd 112, and K6 for each expert's capacity buffer (M = 16
     at the prefill, 8 at decode), 1,167 launches an AxO forward.
  serve-hybrid, serve-mla, serve-encdec, serve-vlm (slice 4): the same run and
     checks for jamba-v0.1-52b at full width cut to one whole 8-layer block
     of 4 (7 mamba + 1 attn, dense and 16-expert top-2 moe MLPs alternating;
     13.27 of 51.5 G parameters): K8 in its 7 mamba layers (tensor-core
     route), K7 causal at hd 128, K6 at the expert buffers (M = 80 at the
     prefill); deepseek-v3-671b cut to its dense stage and one moe layer
     (repeats (3, 1); 15.21 of 671 G parameters, all 256 experts): MLA (q/k
     width 576, v width 512) on the port's plain attention, no K7, K6 at the
     four MLA projections and the expert buffers (M = 24); whisper-medium
     with its 24 encoder layers and 8 of its 24 decoder layers (cut for
     the script's time) and its 1,500 stub frames: K7 non-causal in the encoder and the cross-attention (Sq 128 x
     Skv 1,500), causal in the decoder's self-attention; and
     llama-3.2-vision-90b cut to one whole 5-layer block of 20 (6.38 of 87.7
     G) with its 1,600 stub image tokens: K7 non-causal in the gated
     cross-attention (hd 128, H 64 / G 8).  Launches are counted by head
     width and causality; each K7 call's ``causal`` flag is checked; every
     K8 call is held as in serve-ssm; each MoE arch's (kimi-k2's too)
     capacity drops at the exact prefill are counted; the profiled prefill
     splits its device time by K6, K7 and K8.  Then the four reduced configs
     in f32 (K7's and K8's f32 instances): kernel passes against plain
     passes end to end, exact to SERVE_REL, AxO to SERVE_REL or, where a
     one-ulp nudge of the norm weights moves the plain AxO pass by more, to
     twice that; and MLA's attention at deepseek-v3's prefill timed beside
     SDPA on K/V expanded to the heads.
  train: K7 and K8 under autograd, then training.  ``FlashAttentionFn`` at
     granite-3-2b's train shape (bf16, B=8, H=32, G=8, S=128, hd 64) and a
     reduced f32 shape and ``SSDScanFn`` at mamba2-130m's microbatch (bf16,
     B=4, S=2,000, H=24, P=64, N=128) and a reduced f32 shape: the forward
     equal to the raw kernel call, the gradients against plain autograd to
     one bf16 ulp of each gradient's largest entry (f32: 1e-5 relative
     norm); on grad-requiring inputs ``flash_attention`` and ``ssd_scan``
     take those functions themselves (``ssd_scan_scalar`` refuses).  Every
     reduced arch in f32 takes two train steps on the kernels and on the
     plain versions (``kernel_impl="plain"``): the first step's loss and
     grad norm, the second step's loss and the parameters after both, each
     to SERVE_REL, or, where the kernel run differs by more, to twice the
     most that six one-ulp nudges of the weights do to the plain run (the
     second step's grad norm is printed: from random weights the reduced VLM
     trains chaotically, its second grad norm spreading over 187-1326 across
     nudges); K7 and K8 launch twice a forward (remat).  granite-3-2b at
     full width and depth (2.53 G parameters, remat; the attention
     projections drawn at 1/sqrt(fan-in), ``rescale_attention``): the
     gradient of the first batch's loss on the kernels against the same on
     the plain versions, from the same parameters, in bf16 and in f32 (the
     bf16 parameters upcast): the loss, the grad norm and each leaf's
     gradient a layer, each to SERVE_REL or, where the kernels differ by
     more, to twice the most that two one-ulp nudges of the norm weights do
     to the plain run; a limit of TRAIN_GRAD_CAP or more fails, as it could
     not tell a lost gradient.  Then six bf16 AdamW steps of
     ``make_train_step`` at batch 8 x seq 128, lr 1e-3 cosine with warmup
     5, clip 1.0: finite losses and grad norms, the loss falling by
     TRAIN_MIN_DROP or more, K7 80 launches a step; step time, tokens/s,
     peak memory and the step's bound.  No checkpoint at this width (one
     would be ~25 GB).  mamba2-130m through ``launch.train.main`` (8 steps,
     batch 8 x seq 2,000 in two microbatches, int8 accumulation,
     checkpoints every 4 steps): K8 96 launches a step, each on the
     tensor-core route; then the same run through ``train_loop`` with a
     fault before step 5: the losses after recovery within TRAIN_REPLAY_REL
     of the uninterrupted run's (whether bitwise is printed); then a
     checkpoint of its final state saved and restored, timed.
  shard: the multi-card paths as far as one card allows (PERF.md section 4).
     With one card the DSE shard axes ('configs', 'lanes') are held on the
     CPU only (tests/test_torch_sharding.py) and a line says so; with two or
     more, the training set's characterization (K1), the map+ga front (K2),
     mnist BEHAV (K4, K5) and a 12-lane sweep (K3) run one shard a card,
     bit-identical to one card.  Then a gloo world of 4 ranks sharing cuda:0
     (NCCL refuses two ranks on one card): which gloo collectives take CUDA
     tensors is probed and printed; jamba-v0.1-52b's MoE layer at full width
     (16 experts, top-2, d 4096, expert ff 14336) runs expert-parallel on a (1, 4) mesh
     (``_ep_body``) and a (2, 2) mesh (the weight-stationary body), each
     rank drawing only its block of the expert banks, placed by the arch's
     ``rules_for`` (``init_params(..., mesh=)``), at batch 4 x prompt 128
     and one 4-token decode step, against the single-device ``moe_apply``
     on rank 0, in bf16 where gloo reduces bf16 CUDA tensors and in f32
     (the largest error over the largest entry: SHARD_BF16_LIMIT in bf16,
     1e-5 in f32; the aux loss to 1e-6), with the EP bodies' wall time (a
     second call; the first, which warms gloo's staging, beside it) and the
     second call's all-reduces' count, bytes and host time; ``compressed_psum`` of
     4M f32 a rank, equal to the single-rank quantized sum bit for bit and
     within half a shared step a rank of the exact sum.  Last the DTensor
     train step as an NCCL world of 1 on a (1, 1) mesh: granite-3-2b at
     full width cut to SHARD_TRAIN_LAYERS layers, two bf16 AdamW steps
     against the same steps on plain tensors (loss and parameters to
     SERVE_REL; whether bitwise is printed), K7 launched through
     ``local_call`` twice a layer a step.
  dryrun: the dry-run tools (``launch.dryrun``, ``launch.lowering``,
     ``launch.report``) on this card's PyTorch: ``run_cell`` (its cost
     probes, ``--probe``) on a fake world of 256 ranks for every shape of
     granite-3-2b on the 16x16 mesh and mamba2-130m's long_500k, and of 512
     ranks for granite's decode_32k on 2x16x16, the fake tensors on
     ``cuda`` (no card memory is used); each record's status, per-device
     need, FLOPs, collective bytes by kind and bottleneck on a line, then the
     report's tables over the written records.  Then a one-rank cross-check:
     ``lower_step`` of the train phase's granite step (full width and depth,
     batch 8 x 128, AdamW, remat; no mesh) predicts the peak memory and the
     FLOPs that the card measures for that step in this run (the train
     phase's peak above what was held before, and ``obs.profile_fn``'s FLOP
     count of one step, in which K7 is counted by its op's formula); the
     ratios are printed and the FLOPs must agree to 1%.  Last K7 at
     granite's prefill (B=4, H=32, G=8, S=128, hd 64, bf16) and K8 at
     mamba2's (SSM_SHAPE, bf16) through their wrappers (checks, then the
     custom op), through the ops alone and through the raw launchers: bit for
     bit equal, each timed (the op's host dispatch).
  device-time: K6's and K7's device time per call from torch.profiler, and
     their yardsticks', at phase 3's shapes, beside phase 3's CUDA-event
     times, K8's at mamba2's prefill, and K2's and K5's, both designs, at
     phase 3's D and at their path launches' D, and K2's two tiers at D=258,
     D=37 and its path's D; first, one profiled train step each of
     granite-3-2b and mamba2-130m (the device time split into K7 and K8
     forward, the plain attention and scan backward, the global-norm clip,
     the optimizer and the GEMM kernels, and the device-busy share); after the
     timed phases, because after a profiler session the host issues every
     launch more slowly.
  sync: one ranking (``constraint_ranks``, P=128) under
     ``torch.cuda.set_sync_debug_mode("error")``: it must not sync the host;
     last, since switching the debugger slows later host-issued launches (a
     ranking's time before and after the switch is printed).  Then the
     tapped GA's 100 generations (phase 5's problem, population 64) under
     the debugger: one ``fastmoo.gen`` row a generation, no host sync, and
     ``hv_history`` equal to an untapped run's.
  obs (in phase 4, the serve and service phases and after device-time):
     ``obs_tune`` searches K1 at the training set's 256-config chunks, K2
     at the untuned ``map+ga``'s front and K6 at ``K6_TUNE`` under
     ``tuning="search"`` into ``build/tuning_cache`` (every candidate held
     to its plain version, none rejected; CUDA-event times beside the
     default's), then resolves them under ``"cached"``: all hits, no
     search; the training set is characterized again on ``"cached"``
     tiles (K1 at its tuned a-tile, equal to the untuned set) and the main
     path's ``map+ga`` runs on ``telemetry="on", tuning="cached"``: no
     search, one ``fastmoo.gen`` row a generation, a monotone hv ending at
     ``hv_history``'s, ``hv_history`` and the front equal to the untuned
     run's; K1's and K2's first tuned launches are held to their plain
     versions and timed beside the untuned launch (the kernels line's
     ``path``); granite's serve run writes ``--trace`` (its prefill and
     decode spans), the service's ``/healthz`` carries ``tuning_cache``,
     each serving run's K6 and K7 pad waste (its own telemetry's) and the
     AxO decode steps beside the earlier runs' are printed, and one granite
     AxO prefill's ``trace_capture`` (beside the serve phase's profiled
     windows) must hold K6 and K7 device events; after device-time
     ``profile_registry`` times every kernel at the main paths' shapes
     against its roofline bound on the H100 (the operands' own bytes,
     ``cost_fn``'s FLOPs).  The last ``phase wall:`` line gives each
     section's wall-clock seconds.

Phase 3 also holds K3 over lanes (``constraint_fronts_lanes``) against its
plain version at L=12 x P=128 and a ragged L=5 x P=100, timed beside 12
launches of ``constraint_fronts`` (its yardstick; no PyTorch call computes
it), and K5's 12-bit instance (``entry_gemv_wide``) at the mnist head, the
ffn GEMM1 and the two convolutions on 12-bit codes and 64 configs, counting
the configs whose exact sums leave int32 (the kernel sums modulo 2^32, as
the reference does), with the pair-plane gemm route over the synthesized
planes as its yardstick where that route is exact.

Phase 3 also holds K7 at head widths 128 and 112 at the four new archs'
prefill shapes (B=4, S=128 over a 136-slot cache, their own heads and KV
groups) in bf16 (timed beside SDPA and the bound) and f32, and K6 at kimi-k2's
expert buffers (M = 16 and 8 against 7168 x 2048 and 2048 x 7168, half the
rows padding) and at deepseek-67b's gate/up prefill (512 x 8192 x 22016),
timed beside one cuBLAS f32 GEMM.

Phase 3 also holds K7 with ``causal=False`` at slice 4's shapes (B=4:
whisper's encoder 1,500 x 1,500 and cross-attention 128 x 1,500 at hd 64,
H=G=16; the VLM's cross-attention 128 x 1,600 at hd 128, H 64 / G 8), in bf16
(timed beside SDPA, ``is_causal=False``, and the bound) and f32 (to 2e-6 of
the largest softmax-weighted sum of |v|); K6 at the prefill expert buffers
of jamba (M = 80, 4096 x 14336 and back) and deepseek-v3 (M = 24, 7168 x
2048 and back) on its tensor-core route and at the cross K/V projections
(M = 6,000, 1024 x 1024; M = 6,400, 8192 x 1024), timed beside one cuBLAS
f32 GEMM; and K8 at jamba's prefill scan (B=4, S=128, H=128, P=64, N=128).
The device-time phase adds their profiler times, K8's at jamba's prefill
and MLA's attention.

Phase 3 also holds K6 (AxO matmul) against its plain version at granite's
decode shapes (M=4 against the five weight shapes), a prefill shape (M=512,
2048 x 8192), mamba2's head (M=8), the boundary of its two routes (M=16 on
the GEMV, M=17 on the tensor cores) and, with a random 36-bit config whose
factor part dominates, gate/up at decode and prefill, at rank 8, to 1e-5
relative norm; its bound is the larger of the bytes and the three-pass TF32
work, with the f32-pipe count beside it.  It holds K7 (flash attention) at
the serve prefill (B=4, H=32, G=8, S=128 over a 144-slot cache, hd=64) and a
ragged S, in f32 and bf16.  The yardsticks are one cuBLAS f32 GEMM over the
concatenated ``[A|F_1..F_R]·[B;G_1..G_R]`` (K6) and
``scaled_dot_product_attention`` with K/V repeated to 32 heads (K7); the two
kernels' times in their first design (PR 13) are printed beside.  It
holds K8 (SSD scan) against its plain version at mamba2-130m's prefill (B=8,
S=2,000, H=24, P=64, N=128), at the reduced config's (B=2, S=40, H=16, P=8,
N=16) and at a grouped shape (G=4, with an entering state), in f32 and
bf16: bf16 takes the tensor-core design (two grids a call), f32 the first
design, whose bf16 time at the prefill shape (``ssd_scan_scalar``) is
printed beside the new one.  K8's bound is the larger of its bytes and the
least tensor-core work that holds its contracts (two bf16 passes per product
with an f32 operand); the route's three passes and the f32 pipe are printed
beside it.  No single PyTorch call computes the scan, so K8 has no
yardstick.  Every K8 call of the full-width serve-ssm run must take the
tensor-core design and launch two grids (counted by K8's CUDA library).

The second-to-last lines are the kernels' JSON record (launch counts of K1-K3
from phase 4, of K4 and K5 from phase apps, of K5's 12-bit instance from
phase wide, of K3 over lanes from phase sweep, of K6 and K7 from phase
serve (and whisper's causal hd 64 self-attention), of K8 from phase
serve-ssm, of K7 at hd 128 from serve-dense, serve-hybrid and serve-vlm (its
causal layers) and at hd 112 from serve-moe, of K7 non-causal from
serve-encdec and serve-vlm, of K6 in serve-dense, serve-moe, serve-hybrid +
serve-mla (the expert-buffer record) and serve-encdec + serve-vlm (the cross
K/V record), of K8 at jamba's shape from serve-hybrid, each counted
separately; K7's and K8's records add the train phase's launches, granite's
steps and mamba2's run through ``launch.train.main``, as ``train_launches``) and the card's ``nvidia-smi`` name and power limit; the last line is the
result JSON.  Nothing of JAX or of the reference package is imported.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published rates (NVIDIA data sheet): HBM3 bandwidth, non-tensor
# f32 FMA throughput and the dense bf16 and TF32 tensor-core rates.  The int32
# and the f32 lane rates of the K4-K6 bounds are derived from the SM clock
# (below).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_TENSOR_FLOPS = 989e12
TF32_TENSOR_FLOPS = 495e12
# K6's and K7's times in their first design (PR 13), measured by this script
# on an H100 80GB HBM3 at 700 W (PERF.md section 6), printed beside the new ones
K6_PR13_MS = {"q/o decode": 0.1562, "k/v decode": 0.1077, "gate/up decode": 0.5085,
              "down decode": 0.6691, "head decode": 3.479, "gate/up prefill": 6.370,
              "mamba2 head": 1.3345}
K7_PR13_MS = {"serve prefill": 0.0829, "ragged": 0.0577}
N_SMS = 132
INT32_LANES_PER_SM = 64
F32_LANES_PER_SM = 128
ISSUE_LANES_PER_SM = 128   # 4 warp instructions an SM a clock
SMEM_WORDS_PER_SM = 32     # shared-memory banks: 4-byte words an SM a clock
# the least instructions a BEHAV pair needs: sub, abs, hi/lo split (2), three
# multiply-adds, count, max, sum and the f32 multiply-add (K1, a config and
# pair); K2 adds the exact product, its abs, the clamp to 1, the conversion and
# the reciprocal, which depend on the pair alone: once a pair for all configs
K1_PAIR_OPS = 11
K2_PAIR_ONLY_OPS = 5
# a plane value of K2's and K5's redesigns in closed form: two masks, the
# add, its mask and the two's-complement read (sign xor, sub); the first
# designs' bit-serial chain, ~10 operations a column of W = 10
CHAIN_OPS = 6
FIRST_CHAIN_OPS = 10 * 10
# K5's bound, as K4's for the same function (out[d, m, n] from a config's
# products): one shared-memory word a product, and at least a load and an add
K5_WORDS = 1
K5_PRODUCT_OPS = 2
REL_RTOL = 1e-5
SERVE_REL = 1e-3      # logits of a kernel pass vs the same pass on the plain versions
AXO_RANK = 8
SERVE_ARGS = ["--arch", "granite-3-2b", "--full-config", "--batch", "4", "--prompt-len",
              "128", "--gen", "16", "--axo-rank", str(AXO_RANK)]
SSM_ARGS = ["--arch", "mamba2-130m", "--full-config", "--batch", "8", "--prompt-len", "2000",
            "--gen", "32", "--axo-rank", str(AXO_RANK)]
SSM_SHAPE = (8, 2000, 24, 1, 64, 128)   # mamba2-130m's prefill scan: B, S, H, G, P, N
# serve-dense and serve-moe: batch 4, prompt 128, 8 new tokens, exact and AxO
PROMPT_LEN, GEN_TOKENS = 128, 8
SERVE_NEW_ARGS = ["--full-config", "--batch", "4", "--prompt-len", str(PROMPT_LEN), "--gen",
                  str(GEN_TOKENS), "--axo-rank", str(AXO_RANK)]
DENSE_ARCHS = ("internlm2-1.8b", "starcoder2-3b", "deepseek-67b")
DEPTH_CUTS = {"internlm2-1.8b": (8,),      # layers kept: 8 of 24 and 30, the script's time
              "starcoder2-3b": (8,),
              "deepseek-67b": (8,),        # bf16 weights of all 95 are ~134 GB
              "kimi-k2-1t-a32b": (1, 1),   # a stage's repeats: the dense layer, one moe layer
              "jamba-v0.1-52b": (1,),      # one whole 8-layer block of 4
              "deepseek-v3-671b": (3, 1),  # the dense stage and one moe layer
              "llama-3.2-vision-90b": (1,),  # one whole 5-layer block of 20
              # 8 of 24 decoder layers (each projects the 1,500 frames' cross
              # K/V through K6 at M = 6,000); the encoder's 24 in full
              "whisper-medium": (8,)}
# slice 4's serving phases, each cut in depth above
SLICE4_PHASES = {"serve-hybrid": "jamba-v0.1-52b", "serve-mla": "deepseek-v3-671b",
                 "serve-encdec": "whisper-medium", "serve-vlm": "llama-3.2-vision-90b"}
# K7 at the new head widths: arch -> (query heads, KV groups, hd) of its prefill
K7_WIDE = {"internlm2-1.8b": (16, 8, 128), "starcoder2-3b": (24, 2, 128),
           "deepseek-67b": (64, 8, 128), "kimi-k2-1t-a32b": (64, 8, 112)}
# K6 at the serving shapes of slices 3 and 4: label -> (M, K, N, record, rows
# holding codes; the rest of an expert's capacity buffer is padding, all-zero
# codes).  kimi-k2's expert buffers (GEMV route) and deepseek-67b's gate/up
# prefill; jamba's (M = 80) and deepseek-v3's (M = 24) prefill expert buffers
# (tensor-core route, about a third padding at their loads) and the cross K/V
# projections over whisper's frames and the VLM's image tokens
K6_NEW = {"expert gate/up prefill": (16, 7168, 2048, "K6E", 8),
          "expert down prefill": (16, 2048, 7168, "K6E", 8),
          "expert gate/up decode": (8, 7168, 2048, "K6E", 4),
          "expert down decode": (8, 2048, 7168, "K6E", 4),
          "deepseek-67b gate/up prefill": (512, 8192, 22016, "K6D", 512),
          "jamba expert gate/up prefill": (80, 4096, 14336, "K6M", 53),
          "jamba expert down prefill": (80, 14336, 4096, "K6M", 53),
          "deepseek-v3 expert gate/up prefill": (24, 7168, 2048, "K6M", 16),
          "deepseek-v3 expert down prefill": (24, 2048, 7168, "K6M", 16),
          "whisper cross K/V": (4 * 1500, 1024, 1024, "K6X", 4 * 1500),
          "vlm image K/V": (4 * 1600, 8192, 1024, "K6X", 4 * 1600)}
K6_RECORDS = {"K6E": "axo_matmul_experts", "K6D": "axo_matmul_dense",
              "K6M": "axo_matmul_expert_prefill", "K6X": "axo_matmul_cross_kv"}
# slice 4: K7 non-causal, label -> (query heads, KV groups, Sq, Skv, hd), B=4
K7_NC = {"whisper encoder": (16, 16, 1500, 1500, 64),
         "whisper cross": (16, 16, PROMPT_LEN, 1500, 64),
         "vlm cross": (64, 8, PROMPT_LEN, 1600, 128)}
JAMBA_SSM_SHAPE = (4, PROMPT_LEN, 128, 1, 64, 128)   # jamba's prefill scan: B, S, H, G, P, N
# K6 above this many rows (its tensor-core route at M = 80 .. 6,400) is not
# profiled in the device-time section: torch.profiler handed back no device
# events for those launches in every earlier run, and the empty windows took
# ~80 s of the script; their rows keep their CUDA-event times
K6_PROFILED_MAX_M = 24
K8_Q = 32                               # K8's own chunk length, both designs (csrc/ssd_scan.cu kQ)
# The two GAs draw from different random streams, and one run's hypervolume
# varies by ~1.6% (std over seeds) at this budget, so the 2% contract is held
# on the mean over a fixed set of seeds, and on seed 0 alone as well.
GA_SEEDS = tuple(range(20))
# the largest weight, in codes, the serve checks run K6's plain version on at once
PLAIN_K6_ELEMS = 1 << 28
# the obs phase: K6 shapes tuned, granite-3-2b's decode (M=4) and prefill (M=512)
# projections (q/o, k/v, gate/up, down) and deepseek-v3's 24-row expert buffers
K6_TUNE = [(m, k, n) for m in (4, 512)
           for k, n in ((2048, 2048), (2048, 512), (2048, 8192), (8192, 2048))] + [
    (24, 7168, 2048), (24, 2048, 7168)]
# the AxO decode steps of the first full-width runs of these archs (PERF.md
# section 5, ms a step), printed beside this run's
EARLIER_AXO_DECODE_MS = {"granite-3-2b": "162-189", "kimi-k2-1t-a32b": "283-389"}
# the train phase: granite-3-2b's steps (batch x seq, cosine warmup) and
# mamba2-130m's run through launch.train.main, a fault injected before one step
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_WARMUP = 8, 128, 6, 5
TRAIN_SSM_ARGS = ["--arch", "mamba2-130m", "--full-config", "--steps", "8", "--batch", "8",
                  "--seq", "2000", "--accum", "2", "--int8-accum", "--ckpt-every", "4"]
TRAIN_FAULT_STEP = 5
# losses after recovery vs the uninterrupted run (a replay repeats every
# kernel and GEMM, but an atomic reduction may sum in another order)
TRAIN_REPLAY_REL = SERVE_REL
# granite's full-width gradient, kernels vs plain: a limit this large, set by
# nudges, could not tell a gradient lost through a kernel (relative error 1)
TRAIN_GRAD_CAP = 0.25
# the least granite's loss must fall over its TRAIN_STEPS steps (nats)
TRAIN_MIN_DROP = 1.0
# the shard phase: jamba's MoE layer at full width on a gloo world of
# SHARD_WORLD ranks sharing cuda:0, over these meshes ((1, 4): _ep_body,
# (2, 2): the weight-stationary body), at a prefill (batch x prompt) and one
# decode step; compressed_psum over SHARD_PSUM_ELEMS f32 a rank; the DTensor
# train step of granite-3-2b cut to SHARD_TRAIN_LAYERS layers
SHARD_ARCH = "jamba-v0.1-52b"
SHARD_WORLD = 4
SHARD_MESHES = ((1, 4), (2, 2))
SHARD_TOKENS = {"prefill": (4, PROMPT_LEN), "decode": (4, 1)}
SHARD_SEED = 7
SHARD_PSUM_ELEMS = 1 << 22
SHARD_TRAIN_LAYERS = 2
# bf16 EP vs the single-device bf16 layer, of its largest entry: the
# weight-stationary body rounds its partial pre-activations and outputs to
# bf16 before their all-reduces (the reduced layer on the CPU measured 1.3
# ulps, 2^-7 each); f32 is held to REL_RTOL
SHARD_BF16_LIMIT = 2.0 ** -5


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, warm."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# torch.profiler windows of device_ms that held no device events, of all opened
PROFILER_EMPTY = {"empty": 0, "windows": 0}


def device_ms(torch, fn, calls: int):
    """Device time per call of ``fn``, every kernel it launches summed, from
    torch.profiler over at least ``calls`` warm calls, or None where the
    profiler handed back no device events (counted in ``PROFILER_EMPTY``).
    A secondary figure beside :func:`cuda_ms`, which every kernel's ``ms``
    uses: here the host's time to issue a call does not count where it exceeds
    the kernel's.  The card is kept busy for 50 ms first, so that its clocks
    are up, and the profiled window spans at least 20 ms of the host's time."""
    from torch.profiler import ProfilerActivity, profile

    t0, n = time.perf_counter(), 0
    while n < calls or time.perf_counter() - t0 < 0.05:
        fn()
        n += 1
    torch.cuda.synchronize()
    calls = max(calls, min(2000, int(0.02 / ((time.perf_counter() - t0) / n)) + 1))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type.name == "CUDA")
    PROFILER_EMPTY["windows"] += 1
    if total > 0:
        return total / 1e3 / calls
    PROFILER_EMPTY["empty"] += 1
    return None


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def bound(bytes_moved: float, int_ops: float, f32_ops: float, int_rate: float,
          f32_rate: float = F32_FLOPS, bf16_ops: float = 0.0, tf32_ops: float = 0.0):
    """(bound_ms, bound_by): the larger of the byte time and the op time."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = max(int_ops / int_rate, f32_ops / f32_rate, bf16_ops / BF16_TENSOR_FLOPS,
                tf32_ops / TF32_TENSOR_FLOPS)
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def rel_norm(got, want) -> float:
    """||got - want|| / ||want||, in float64."""
    import torch

    diff = torch.linalg.vector_norm((got.double() - want.double()))
    return float(diff / torch.linalg.vector_norm(want.double()))


def ssd_inputs(torch, shape, dtype, gen):
    """K8's operands at ``shape`` (B, S, H, G, P, N), drawn as the reference's
    kernel test draws them (dt in [0.01, 0.2], a in [-2, -0.5]); x, B and C
    are strided views into one buffer, as the model passes them."""
    b, s, h, g, p, n = shape
    dev = gen.device
    buf = torch.randn((b, s, h * p + 2 * g * n), generator=gen, device=dev).to(dtype)
    x = buf[..., :h * p].reshape(b, s, h, p)
    bm = buf[..., h * p:h * p + g * n].reshape(b, s, g, n)
    cm = buf[..., h * p + g * n:].reshape(b, s, g, n)
    dt = 0.01 + 0.19 * torch.rand((b, s, h), generator=gen, device=dev)
    a = -(0.5 + 1.5 * torch.rand((h,), generator=gen, device=dev))
    return x, dt, a, bm, cm


def ssd_work(shape, itemsize: int, passes: int) -> tuple[float, float, float]:
    """(bytes, f32 FLOPs, bf16 tensor-core FLOPs) of the chunked scan at K8's
    chunk length: each input read and each output written once; the
    intra-chunk terms over the lower triangle of each chunk's valid
    positions, the scores once per group.  The tensor-core count takes the
    scores in one pass (bf16 operands) and every product with an f32 operand
    (M x, C state^T, the state update) in ``passes``, one per bf16 term of
    that operand: 2 (a hi + lo pair, the least that holds K8's contracts) or
    3 (the kernel's route)."""
    b, s, h, g, p, n = shape
    tri = sum(q * (q + 1) // 2 for q in (min(K8_Q, s - t) for t in range(0, s, K8_Q)))
    scores = 2.0 * b * g * n * tri
    per_head = 2.0 * b * h * p * tri + 4.0 * b * h * s * n * p
    moved = (2 * b * s * h * p + 2 * b * s * g * n) * itemsize + (b * s * h + h) * 4 \
        + b * h * p * n * 4
    return moved, scores + per_head, scores + passes * per_head


@contextlib.contextmanager
def checked_calls(torch):
    """Run every K6, K7 and K8 call of a serve path on its plain version too.

    Patches the names the models call the kernels by; yields ``{"K6": [rel
    norms], "K7": [max err / max |plain|], "K8": [(y max err / max |plain y|,
    state rel norm)]}``, one entry per call, and ``"K7 non-causal"``, the
    count of K7 calls with ``causal=False``.
    """
    from repro_torch.axo import deploy
    from repro_torch.kernels import axo_matmul, flash_attention, ssd_scan
    from repro_torch.models import attention, ssm

    calls = {"K6": [], "K7": [], "K8": [], "K7 non-causal": 0}

    def k6(a, b, *tables, **tiles):
        out = axo_matmul.axo_matmul(a, b, *tables, **tiles)
        # the plain version over column slices of a large weight (kimi-k2's
        # head: 7168 x 163840 codes gather 9.4 GB of int64 indices at once)
        step = max(1, PLAIN_K6_ELEMS // b.shape[0])
        want = torch.cat([axo_matmul.axo_matmul_plain(a, b[:, j:j + step], *tables)
                          for j in range(0, b.shape[1], step)], 1)
        calls["K6"].append(rel_norm(out, want))
        return out

    def k7(q, k, v, **kw):
        out = flash_attention.flash_attention(q, k, v, **kw)
        want = flash_attention.flash_attention_plain(q, k, v, **kw).float()
        calls["K7"].append(float((out.float() - want).abs().max() / want.abs().max()))
        calls["K7 non-causal"] += not kw.get("causal", True)
        return out

    def k8(*args, **kw):
        y, st = ssd_scan.ssd_scan(*args, **kw)
        y_p, st_p = ssd_scan.ssd_scan_plain(*args, **kw)
        calls["K8"].append((float((y.float() - y_p.float()).abs().max()
                                  / y_p.float().abs().max()), rel_norm(st, st_p)))
        return y, st

    deploy.axo_matmul, attention.flash_attention, ssm.ssd_scan = k6, k7, k8
    try:
        yield calls
    finally:
        deploy.axo_matmul = axo_matmul.axo_matmul
        attention.flash_attention = flash_attention.flash_attention
        ssm.ssd_scan = ssd_scan.ssd_scan


def _layers(cfg, mode: str):
    """(repeats, mixer, mlp) of every stage of ``cfg``, the encoder's at a prefill."""
    out = [(st.repeats, mixer, mlp) for st in cfg.stages for mixer, mlp in st.layers]
    if cfg.encoder is not None and mode == "prefill":
        out.append((cfg.encoder.n_layers, "attn_nc", "dense"))
    return out


def k6_per_forward(cfg, mode: str = "prefill") -> int:
    """K6 launches of one AxO forward with every layer group deployed: a
    layer's four attention projections (MLA's wq_a, wq_b, wkv_a, wo; a cross
    half's K/V only at the prefill, from the encoder or image states; none for
    a mamba mixer) and its MLP's (two for gelu, three for swiglu), a moe
    layer's shared expert and three for each routed expert (the reference's
    per-expert loop), the encoder's layers at the prefill, and the head."""
    mlp = 3 if cfg.act == "swiglu" else 2
    cross = 4 if mode == "prefill" else 2
    mixers = {"attn": 4, "attn_nc": 4, "mla": 4, "mamba": 0, "xattn": cross,
              "attn_x": 4 + cross}

    def ffn(kind: str) -> int:
        if kind == "moe":
            return 3 * cfg.moe.n_experts + (mlp if cfg.moe.n_shared else 0)
        return mlp if kind == "dense" else 0

    return 1 + sum(r * (mixers[mixer] + ffn(kind)) for r, mixer, kind in _layers(cfg, mode))


def k7_per_prefill(cfg) -> dict:
    """K7 launches of one prefill by (head width, causal): a causal ``attn``
    layer one, ``attn_x`` a causal self and a non-causal cross call, ``xattn``
    and the encoder's ``attn_nc`` one non-causal call; MLA and mamba none."""
    calls = {"attn": (1, 0), "attn_nc": (0, 1), "attn_x": (1, 1), "xattn": (0, 1)}
    out = {}
    for r, mixer, _ in _layers(cfg, "prefill"):
        for causal, n in zip((True, False), calls.get(mixer, (0, 0))):
            if n:
                key = (cfg.resolved_head_dim, causal)
                out[key] = out.get(key, 0) + r * n
    return out


def k8_per_prefill(cfg) -> int:
    """K8 launches of one prefill: one a mamba layer."""
    return sum(r for r, mixer, _ in _layers(cfg, "prefill") if mixer == "mamba")


def nudge_norms(torch, params: dict, seed: int, prefix: str = "norm") -> dict:
    """``params`` with every norm weight (every leaf whose name starts with
    ``prefix``; ``""``: every leaf) moved one ulp up or down at random."""
    gen = torch.Generator(device=params["norm_f"].device).manual_seed(seed)

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if not name.startswith(prefix):
            return tree
        sign = torch.randint(0, 2, tree.shape, generator=gen, device=tree.device) * 2 - 1
        return torch.nextafter(tree, tree + sign.to(tree.dtype))

    return walk(params)


@contextlib.contextmanager
def routed_drops(torch):
    """Tally the capacity drops of every moe layer the model runs: yields
    ``{"dropped", "entries", "layers"}``, the (token, expert) entries routed
    past their expert's capacity, of all routed, over the layers called.
    The routing is recomputed as ``moe_apply`` computes it."""
    from repro_torch.models import model as model_mod, moe

    tally = {"dropped": 0, "entries": 0, "layers": 0}

    def counting(p, x, cfg, axo=None):
        t = x.shape[0] * x.shape[1]
        probs = torch.softmax((x @ p["router"]).to(torch.float32), dim=-1).reshape(t, -1)
        top_i = torch.topk(probs, cfg.moe.top_k, dim=-1).indices
        load = torch.bincount(top_i.reshape(-1), minlength=cfg.moe.n_experts)
        tally["dropped"] += int((load - moe.moe_capacity(t, cfg)).clamp(min=0).sum())
        tally["entries"] += t * cfg.moe.top_k
        tally["layers"] += 1
        return moe.moe_apply(p, x, cfg, axo=axo)

    model_mod.moe_apply = counting
    try:
        yield tally
    finally:
        model_mod.moe_apply = moe.moe_apply


def profile_calls(torch, fn, calls: int):
    """torch.profiler over ``calls`` calls of ``fn``: the device time per call
    against the wall time, K6's, K7's and K8's shares of it, and the top
    kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / calls
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    device = sum(e.self_device_time_total for e in kernels) / 1e3 / calls

    def by_name(part: str) -> float:
        return sum(e.self_device_time_total for e in kernels if part in e.key) / 1e3 / calls

    kernels.sort(key=lambda e: -e.self_device_time_total)
    top = [(e.key[:48], round(e.self_device_time_total / 1e3 / calls, 4), e.count // calls)
           for e in kernels[:5]]
    return {"device_ms": device, "wall_ms": wall, "k6_ms": by_name("::axo_"),
            "k7_ms": by_name("flash_attention_"), "k8_ms": by_name("ssd_")}, top


def profile_decode(torch, prefill, decode, params, toks, steps: int = 2, front=None):
    """:func:`profile_calls` over ``steps`` decode steps after a prefill
    (``front``: the stub frontend's input)."""
    logits, cache = prefill(params, toks, front)
    nxt = logits[:, -1].argmax(-1)[:, None]
    positions = iter(range(toks.shape[1], toks.shape[1] + steps))
    return profile_calls(torch, lambda: decode(params, cache, nxt, next(positions)), steps)


def rescale_attention(torch, params: dict) -> dict:
    """``params`` with every attention projection scaled in place to a
    1/sqrt(fan-in) draw.  ``init_params``, as the reference's, takes a
    leaf's fan-in from its second-to-last axis: the head count for wq, wk,
    wv (d, heads, hd) and the head width for wo (heads, hd, d), so they
    start 5.7-16x too large at granite-3-2b's shapes.  Then the residual
    grows ~10x a layer and at 40 layers a one-ulp nudge of the norm weights
    moves every gradient by more than itself: no check can hold the
    gradient, and clipping sets every step."""

    def walk(tree):
        if not isinstance(tree, dict):
            return
        if "wq" in tree and "wo" in tree:
            with torch.no_grad():
                for name in ("wq", "wk", "wv"):
                    tree[name].mul_((tree[name].shape[-2] / tree[name].shape[-3]) ** 0.5)
                tree["wo"].mul_(tree["wo"].shape[-3] ** -0.5)
            return
        for v in tree.values():
            walk(v)

    walk(params)
    return params


def train_phase(torch, dev, wrappers, gen) -> tuple[dict, dict]:
    """The train phase (module docstring): K7 and K8 under autograd, every
    reduced arch's train step on the kernels against the plain versions,
    granite-3-2b's and mamba2-130m's full-width training.  Returns the
    printed figures and what the device-time phase profiles: each full-width
    model's step function, state and a batch."""
    import tempfile

    from repro_torch.checkpoint import restore_tree, save_tree
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import ARCH_IDS, get_arch
    from repro_torch.core.engine import ExecutionContext
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import flash_attention as k7, ssd_scan as k8
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import compute_loss, model_spec
    from repro_torch.models.spec import count_params, init_params
    from repro_torch.optim import cosine_schedule, make_optimizer, tree_leaves, tree_map
    from repro_torch.train import train_loop

    stats, keep = {}, {}

    def grad_err(got, want) -> float:
        """bf16: max error over the largest entry; f32: relative norm."""
        if want.dtype == torch.bfloat16:
            return float((got.float() - want.float()).abs().max() / want.float().abs().max())
        return rel_norm(got, want)

    def grad_limit(dtype) -> float:
        return 2.0 ** -7 if dtype == torch.bfloat16 else REL_RTOL

    # (1) the autograd functions against plain autograd, at the train shapes
    for label, (b, s, h, g, hd), dtype in (
            ("granite train", (8, 128, 32, 8, 64), torch.bfloat16),
            ("reduced", (2, 32, 4, 2, 16), torch.float32)):
        q = torch.randn((b, s, h, hd), generator=gen, device=dev).to(dtype).transpose(1, 2)
        kk, vv = (torch.randn((b, s, g, hd), generator=gen, device=dev).to(dtype).transpose(1, 2)
                  for _ in range(2))
        w = torch.randn((b, h, s, hd), generator=gen, device=dev)

        def run(fn):
            ins = [t.detach().requires_grad_() for t in (q, kk, vv)]
            out = fn(*ins)
            return out.detach(), torch.autograd.grad((out.float() * w).sum(), ins)

        out_k, g_k = run(lambda *t: k7.FlashAttentionFn.apply(*t, True, None, 0, s))
        out_p, g_p = run(lambda *t: k7.flash_attention_plain(*t, causal=True))
        with torch.no_grad():
            same = torch.equal(out_k, k7.flash_attention(q, kk, vv))
        errs = [grad_err(a, c) for a, c in zip(g_k, g_p)]
        fwd = float((out_k.float() - out_p.float()).abs().max() / out_p.float().abs().max())
        print(f"phase train: FlashAttentionFn at the {label} shape (B={b}, H={h}, G={g}, S={s}, "
              f"hd {hd}, {str(dtype)[6:]}): forward equals the raw K7 call: {same}; forward vs "
              f"plain {fwd:.3g}; q/k/v gradients vs plain autograd {[f'{e:.3g}' for e in errs]} "
              f"(limit {grad_limit(dtype):.3g})", flush=True)
        if not same or max(errs) > grad_limit(dtype):
            raise AssertionError(f"FlashAttentionFn at the {label} shape differs")
    for label, shape, dtype, chunk in (
            ("mamba2 microbatch", (4, 2000, 24, 1, 64, 128), torch.bfloat16, 128),
            ("reduced", (2, 40, 16, 1, 8, 16), torch.float32, 16)):
        x, dt, a, bm, cm = ssd_inputs(torch, shape, dtype, gen)
        w = torch.randn(x.shape, generator=gen, device=dev)

        def run(fn):
            ins = [t.detach().requires_grad_() for t in (x, dt, a, bm, cm)]
            y, st = fn(*ins)
            return (y.detach(), st.detach()), torch.autograd.grad((y.float() * w).sum(), ins)

        (y_k, st_k), g_k = run(lambda *t: k8.SSDScanFn.apply(*t, chunk, None))
        _, g_p = run(lambda *t: k8.ssd_scan_plain(*t, chunk=chunk))
        with torch.no_grad():
            y_r, st_r = k8.ssd_scan(x, dt, a, bm, cm, chunk=chunk)
        same = torch.equal(y_k, y_r) and torch.equal(st_k, st_r)
        errs = [grad_err(c, d) for c, d in zip(g_k, g_p)]
        limit = max(grad_limit(c.dtype) for c in g_p)
        print(f"phase train: SSDScanFn at the {label} shape {shape} ({str(dtype)[6:]}): forward "
              f"equals the raw K8 call: {same}; x/dt/a/B/C gradients vs plain autograd "
              f"{[f'{e:.3g}' for e in errs]} (limit {grad_limit(dtype):.3g}, f32 leaves "
              f"{REL_RTOL})", flush=True)
        if not same or any(e > grad_limit(c.dtype) for e, c in zip(errs, g_p)):
            raise AssertionError(f"SSDScanFn at the {label} shape differs")
        del x, dt, a, bm, cm, w, g_k, g_p
    # on grad-requiring inputs the wrappers take their autograd functions
    # themselves: a kernel launch, a grad_fn, plain autograd's gradient;
    # ssd_scan_scalar, which has no autograd function, refuses them
    routed = []
    q = torch.randn((1, 4, 8, 64), device=dev, requires_grad=True)
    x, dt, a, bm, cm = ssd_inputs(torch, (1, 40, 16, 1, 8, 16), torch.float32, gen)
    a.requires_grad_()
    for name, fn, plain, args, wrt in (
            ("flash_attention", k7.flash_attention, k7.flash_attention_plain, (q, q, q), q),
            ("ssd_scan", k8.ssd_scan, k8.ssd_scan_plain, (x, dt, a, bm, cm), a)):
        before = fn.launches
        outs = [f(*args) for f in (fn, plain)]
        outs = [o[0] if isinstance(o, tuple) else o for o in outs]
        got, want = (torch.autograd.grad(o.float().sum(), wrt)[0] for o in outs)
        if (outs[0].grad_fn is not None and fn.launches == before + 1
                and rel_norm(got, want) <= REL_RTOL):
            routed.append(name)
    try:
        k8.ssd_scan_scalar(x, dt, a, bm, cm)
        scalar_refused = False
    except RuntimeError as exc:
        scalar_refused = "SSDScanFn" in str(exc)
    print(f"phase train: wrappers that took their autograd route on grad-requiring CUDA "
          f"inputs (a launch, a grad_fn, plain autograd's gradient): {routed}; "
          f"ssd_scan_scalar refused them: {scalar_refused}", flush=True)
    if routed != ["flash_attention", "ssd_scan"] or not scalar_refused:
        raise AssertionError(f"grad-requiring inputs reached a raw launch: {routed}, "
                             f"{scalar_refused}")
    del q, x, dt, a, bm, cm

    # (2) every reduced arch in f32: two steps on the kernels vs on the plain
    # versions.  Held: the first step's loss and grad norm (both runs
    # differentiate the same parameters), the second step's loss and the
    # parameters after both; each to SERVE_REL, or where a kernel run differs
    # by more, to twice the most that six one-ulp nudges of the weights (the
    # norm weights, three draws; every weight, three) do to the plain run.
    # The second step's grad norm is printed, not held: from random weights
    # the reduced VLM's spreads over 187-1326 across such nudges (its plain
    # run: 368)
    kernel_ctx, plain_ctx = ExecutionContext(), ExecutionContext(kernel_impl="plain")
    for arch in sorted(ARCH_IDS):
        red = get_arch(arch).reduced()
        batch = train.batch_to_device(SyntheticLM(red, ShapeConfig("train", 32, 2, "train"),
                                                  seed=0).batch(0), dev, torch.float32)
        base = init_params(model_spec(red), seed=0, dtype=torch.float32, device=dev)

        def two_steps(ctx, params):
            opt = make_optimizer(red.optimizer, cosine_schedule(1e-3, warmup_steps=1))
            fn, state = make_train_step(red, opt, ctx=ctx), opt.init(params)
            seen = []
            for t in range(2):
                params, state, m = fn(params, state, t, batch)
                seen.append(m)
            return seen, torch.cat([p.flatten() for p in tree_leaves(params)])

        before = (k7.flash_attention.launches, k8.ssd_scan.launches)
        m_k, p_k = two_steps(kernel_ctx, tree_map(torch.clone, base))
        got = (k7.flash_attention.launches - before[0], k8.ssd_scan.launches - before[1])
        m_p, p_p = two_steps(plain_ctx, tree_map(torch.clone, base))
        want = (2 * 2 * sum(k7_per_prefill(red).values()), 2 * 2 * k8_per_prefill(red))

        def diffs(m, p):
            return [rel_norm(m[0]["loss"], m_p[0]["loss"]),
                    rel_norm(m[0]["grad_norm"], m_p[0]["grad_norm"]),
                    rel_norm(m[1]["loss"], m_p[1]["loss"]), rel_norm(p, p_p)]

        errs, spread = diffs(m_k, p_k), None
        limits = [SERVE_REL] * len(errs)
        if max(errs) > SERVE_REL:
            spread = [max(v) for v in zip(*(
                diffs(*two_steps(plain_ctx, nudge_norms(
                    torch, tree_map(torch.clone, base), seed, "norm" if seed < 3 else "")))
                for seed in range(6)))]
            limits = [max(SERVE_REL, 2 * v) for v in spread]
        print(f"phase train: reduced {red.name} f32 ({red.optimizer}), two steps of batch 2 x "
              f"32 on the kernels vs the plain versions: first loss, first grad norm, second "
              f"loss, parameters {[f'{e:.3g}' for e in errs]} (limits "
              f"{[f'{v:.3g}' for v in limits]}"
              + ("" if spread is None else f": twice the most that one-ulp nudges of the "
                 f"weights do to the plain run where above SERVE_REL, "
                 f"{[f'{v:.3g}' for v in spread]}")
              + f"); second grad norm {float(m_k[1]['grad_norm']):.4g} (plain "
              f"{float(m_p[1]['grad_norm']):.4g}); K7, K8 launches {got} (expected {want}, "
              f"forwards twice under remat)", flush=True)
        if got != want or any(e > v for e, v in zip(errs, limits)) \
                or not torch.isfinite(p_k).all():
            raise AssertionError(f"the reduced {red.name} train step on the kernels differs "
                                 f"from its plain run")
        del base, p_k, p_p

    # (3) granite-3-2b at full width and depth, its attention projections
    # drawn at 1/sqrt(fan-in) (rescale_attention): its loss gradient on the
    # kernels vs on the plain versions, then six AdamW steps, remat on
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    cfg = get_arch("granite-3-2b")
    n_params = count_params(model_spec(cfg))
    t0 = time.perf_counter()
    params = rescale_attention(torch, init_params(model_spec(cfg), seed=0, device=dev))
    data = SyntheticLM(cfg, ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train"), seed=0)
    batches = [train.batch_to_device(data.batch(t), dev, torch.bfloat16)
               for t in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0

    def loss_grads(ctx, params):
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            loss, _ = compute_loss(leaves, cfg, batches[0], ctx=ctx)
            return loss.detach(), torch.autograd.grad(loss, tree_leaves(leaves))

    def grad_diffs(got, want):
        """Relative: the loss, the grad norm and the worst gradient of a
        leaf's layer (a stacked leaf's slice; one under 1e-6 of the grad
        norm is judged against the grad norm)."""
        norm = lambda gs: torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g.double()) for g in gs]))
        n_got, n_want = norm(got[1]), norm(want[1])
        worst = 0.0
        for x, y in zip(got[1], want[1]):
            stacked = x.dim() > 1 and x.shape[0] == cfg.n_layers
            for a, b in (zip(x.unbind(0), y.unbind(0)) if stacked else ((x, y),)):
                b = b.double()
                worst = max(worst, float(torch.linalg.vector_norm(a.double() - b) / torch.clamp(
                    torch.linalg.vector_norm(b), min=1e-6 * float(n_want))))
        return [rel_norm(got[0], want[0]), float(abs(n_got - n_want) / n_want), worst]

    for dtype in (torch.bfloat16, torch.float32):
        at = params if dtype == torch.bfloat16 else tree_map(lambda t: t.float(), params)
        before = k7.flash_attention.launches
        on_k = loss_grads(kernel_ctx, at)
        launched = k7.flash_attention.launches - before
        on_p = loss_grads(plain_ctx, at)
        errs, spread = grad_diffs(on_k, on_p), None
        limits = [SERVE_REL] * len(errs)
        if max(errs) > SERVE_REL:
            spread = [max(v) for v in zip(*(
                grad_diffs(loss_grads(plain_ctx, nudge_norms(torch, at, seed)), on_p)
                for seed in range(2)))]
            limits = [max(SERVE_REL, 2 * v) for v in spread]
        finite = all(bool(torch.isfinite(g).all()) for g in on_k[1]) \
            and bool(torch.isfinite(on_k[0]))
        print(f"phase train: {cfg.name} at full width and depth, {str(dtype)[6:]}: the loss "
              f"gradient of batch 0 on the kernels vs the plain versions, same parameters: "
              f"loss, grad norm, worst leaf a layer {[f'{e:.3g}' for e in errs]} (limits "
              f"{[f'{v:.3g}' for v in limits]}"
              + ("" if spread is None else f": twice the most that two one-ulp nudges of the "
                 f"norm weights do to the plain run, {[f'{v:.3g}' for v in spread]}")
              + f"); loss {float(on_k[0]):.6g} (plain {float(on_p[0]):.6g}); K7 launches "
              f"{launched} (expected {2 * cfg.n_layers}); finite: {finite}", flush=True)
        if launched != 2 * cfg.n_layers or not finite or max(limits) >= TRAIN_GRAD_CAP \
                or any(e > v for e, v in zip(errs, limits)):
            raise AssertionError(f"{cfg.name}'s {str(dtype)[6:]} gradient on the kernels "
                                 f"differs from its plain run's")
        del at, on_k, on_p
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    opt = make_optimizer(cfg.optimizer, cosine_schedule(
        1e-3, warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS))
    state = opt.init(params)
    step_fn = make_train_step(cfg, opt)
    for fn in wrappers.values():
        fn.launches = 0
    losses, norms, step_ms = [], [], []
    for t in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, t, batches[t])
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    got = {k: fn.launches for k, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated(dev) - held
    want = dict.fromkeys(wrappers, 0)
    want["K7"] = 2 * cfg.n_layers * TRAIN_STEPS
    tokens = TRAIN_BATCH * TRAIN_SEQ
    warm = sorted(step_ms[1:])
    flops = (6 + 2) * n_params * tokens          # forward, backward, the remat forward
    print(f"phase train: {cfg.name} at full width and depth ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.kv_heads} heads of {cfg.resolved_head_dim}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab} tied, {n_params / 1e9:.3f} G parameters, bf16, "
          f"attention projections at 1/sqrt(fan-in), AdamW, remat) batch {TRAIN_BATCH} x seq "
          f"{TRAIN_SEQ}, {TRAIN_STEPS} steps, lr 1e-3 cosine warmup {TRAIN_WARMUP}, clip 1.0: "
          f"loss {[round(v, 4) for v in losses]}, grad "
          f"norm {[round(v, 3) for v in norms]}; step ms {[round(v, 1) for v in step_ms]} (the "
          f"first includes the card's warm-up; warm median {warm[len(warm) // 2]:.1f} ms, "
          f"{tokens / warm[len(warm) // 2] * 1e3:.0f} tokens/s); bound {flops / 1e12:.2f} TFLOP "
          f"at the bf16 dense peak {flops / BF16_TENSOR_FLOPS * 1e3:.2f} ms; peak memory "
          f"{peak / 2**30:.3f} GiB ({peak} bytes above the {held} held before); init "
          f"{t_init:.1f} s; launches {got} (expected {want})", flush=True)
    if got != want:
        raise AssertionError(f"granite train launches {got}, expected {want}")
    if not all(math.isfinite(v) for v in losses + norms):
        raise AssertionError("non-finite loss or grad norm in granite's training")
    if not losses[-1] < losses[0] - TRAIN_MIN_DROP:
        raise AssertionError(f"granite's loss fell by less than {TRAIN_MIN_DROP} in "
                             f"{TRAIN_STEPS} steps: {losses}")
    stats["granite"] = {"loss": losses, "grad_norm": norms, "step_ms": step_ms,
                        "peak_bytes": peak, "k7_launches": got["K7"], "bound_tflop": flops / 1e12}
    keep["granite"] = (step_fn, params, state, batches[0], opt, cfg, {})

    # (4) mamba2-130m at full width and depth through launch.train.main, then
    # the same run with a fault at step TRAIN_FAULT_STEP through train_loop
    with tempfile.TemporaryDirectory() as ckpt_root:
        argv = [*TRAIN_SSM_ARGS, "--ckpt-dir", os.path.join(ckpt_root, "clean")]
        for fn in wrappers.values():
            fn.launches = 0
        k8.ssd_scan.route_launches.update(mma=0, scalar=0)
        grids0 = k8.grids()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        clean = train.main(argv)
        torch.cuda.synchronize()
        t_main = time.perf_counter() - t0
        got = {k: fn.launches for k, fn in wrappers.items()}
        routes, grids = dict(k8.ssd_scan.route_launches), k8.grids() - grids0
        peak = torch.cuda.max_memory_allocated(dev) - held
        args = train.parse_args(argv)
        cfg = get_arch("mamba2-130m")
        per_step = 2 * cfg.n_layers * args.accum
        want = dict.fromkeys(wrappers, 0)
        want["K8"] = per_step * args.steps
        history = [v for _, v in clean["history"]]
        print(f"phase train: {cfg.name} through launch.train.main {' '.join(argv[:-2])}: "
              f"{len(history)} steps in {t_main:.1f} s, loss {[round(v, 4) for v in history]}, "
              f"peak memory {peak / 2**30:.3f} GiB ({peak} bytes above the {held} held "
              f"before); launches {got} (expected {want}), K8 calls by route {routes}, {grids} "
              f"grids", flush=True)
        if got != want or routes != {"mma": want["K8"], "scalar": 0} or grids != 2 * want["K8"]:
            raise AssertionError(f"mamba2 train launches {got}, routes {routes}, grids "
                                 f"{grids}: expected {want}, every call on the tensor-core "
                                 f"route, two grids a call")
        if len(history) != args.steps or not all(math.isfinite(v) for v in history):
            raise AssertionError(f"mamba2's training history {history}")
        del clean

        run = train.build(train.parse_args([*TRAIN_SSM_ARGS, "--ckpt-dir",
                                            os.path.join(ckpt_root, "fault")]))
        fired, step_ms = [], []

        def fault(step):
            if step == TRAIN_FAULT_STEP and not fired:
                fired.append(step)
                raise RuntimeError("injected node failure")

        def timed_step(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run.step_fn(*a)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        out = train_loop(timed_step, run.init_state, run.batch_fn, run.loop, fault_hook=fault)
        t_fault = time.perf_counter() - t0
        got_k8 = k8.ssd_scan.launches
        replay = [v for _, v in out["history"]]
        worst = max(abs(a - b) / abs(b) for a, b in zip(replay, history))
        warm = sorted(step_ms[1:])
        tokens = args.batch * args.seq
        print(f"phase train: {cfg.name} through train_loop with a fault at step "
              f"{TRAIN_FAULT_STEP}: restarts {out['restarts']}, {len(step_ms)} steps run in "
              f"{t_fault:.1f} s, loss after recovery {[round(v, 4) for v in replay]}; largest "
              f"relative difference from the uninterrupted run {worst:.3g} (limit "
              f"{TRAIN_REPLAY_REL}; bitwise: {replay == history}); K8 launches {got_k8} "
              f"(expected {per_step * len(step_ms)}); step ms {[round(v, 1) for v in step_ms]} "
              f"(warm median {warm[len(warm) // 2]:.1f} ms, "
              f"{tokens / warm[len(warm) // 2] * 1e3:.0f} tokens/s)", flush=True)
        if (out["restarts"], fired) != (1, [TRAIN_FAULT_STEP]) or len(replay) != args.steps \
                or worst > TRAIN_REPLAY_REL or got_k8 != per_step * len(step_ms):
            raise AssertionError("mamba2's fault-injected run did not recover to the "
                                 "uninterrupted run")
        # the checkpoint's own cost at this state: save and restore
        state = (out["params"], out["opt_state"])
        t0 = time.perf_counter()
        save_tree(os.path.join(ckpt_root, "timed"), args.steps - 1, state)
        t_save = time.perf_counter() - t0
        size = os.path.getsize(os.path.join(ckpt_root, "timed", f"step_{args.steps - 1:08d}.npz"))
        t0 = time.perf_counter()
        back = restore_tree(os.path.join(ckpt_root, "timed"), args.steps - 1, state,
                            device=dev)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        same = all(torch.equal(a, b) for a, b in zip(tree_leaves(back[0]) + tree_leaves(back[1]),
                                                       tree_leaves(state[0]) + tree_leaves(state[1])))
        print(f"phase train: {cfg.name} checkpoint of params + AdamW state ({size} bytes): "
              f"save {t_save:.2f} s, restore onto the card {t_restore:.2f} s, bitwise: {same}",
              flush=True)
        if not same:
            raise AssertionError("mamba2's checkpoint did not restore bit for bit")
        del back
    stats["mamba2"] = {"loss": history, "replay_loss": replay, "step_ms": step_ms,
                       "peak_bytes": peak, "k8_launches": want["K8"], "save_s": t_save,
                       "restore_s": t_restore, "ckpt_bytes": size, "replay_rel": worst}
    keep["mamba2"] = (run.step_fn, out["params"], out["opt_state"], run.batch_fn(0), run.opt,
                      run.cfg, {"accum_steps": args.accum, "int8_accum": args.int8_accum})
    return stats, keep


def profile_train(torch, label, step_fn, params, state, batch, opt, cfg, step_kw) -> dict:
    """torch.profiler over one train step, after a warm one and one timed
    unprofiled: device time against that step's wall time (the busy share),
    K7's and K8's forward kernels, the ranges of the plain attention and scan
    backward, of the global-norm clip and of the optimizer (``opt.update``
    and ``apply_updates``), and GEMM kernels."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.kernels import flash_attention as k7, ssd_scan as k8
    from repro_torch.launch import steps

    ranges = {"attention backward": k7.FlashAttentionFn, "scan backward": k8.SSDScanFn}
    originals = {name: fn.backward for name, fn in ranges.items()}
    apply_updates, clip = steps.apply_updates, steps.clip_by_global_norm

    def ranged(name, fn):
        def call(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return call

    for name, fn in ranges.items():
        fn.backward = staticmethod(ranged(name, originals[name]))
    steps.apply_updates = ranged("optimizer", apply_updates)
    steps.clip_by_global_norm = ranged("clip", clip)
    try:
        fn = steps.make_train_step(cfg, dataclasses.replace(
            opt, update=ranged("optimizer", opt.update)), **step_kw)
        params, state, _ = fn(params, state, 1, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, _ = fn(params, state, 2, batch)
        torch.cuda.synchronize()
        step = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn(params, state, 3, batch)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        for name, fn_cls in ranges.items():
            fn_cls.backward = staticmethod(originals[name])
        steps.apply_updates, steps.clip_by_global_norm = apply_updates, clip
    rows = prof.key_averages()
    names = set(ranges) | {"clip", "optimizer"}
    kernels = [e for e in rows if e.device_type.name == "CUDA" and e.key not in names]
    ms = lambda evs: sum(e.self_device_time_total for e in evs) / 1e3
    out = {"device_ms": ms(kernels), "wall_ms": wall, "step_ms": step,
           "k7_ms": ms(e for e in kernels if "flash_attention_" in e.key),
           "k8_ms": ms(e for e in kernels if "ssd_" in e.key),
           "gemm_ms": ms(e for e in kernels if any(s in e.key.lower() for s in
                                                   ("gemm", "nvjet", "cutlass", "xmma")))}
    for name in names:
        out[name.replace(" ", "_") + "_ms"] = sum(
            e.device_time_total for e in rows
            if e.key == name and e.device_type.name == "CPU") / 1e3
    kernels.sort(key=lambda e: -e.self_device_time_total)
    top = [(e.key[:48], round(e.self_device_time_total / 1e3, 3), e.count) for e in kernels[:6]]
    print(f"phase device-time: {label} train step profiled: device time {out['device_ms']:.2f} "
          f"ms, {out['device_ms'] / step:.1%} of the step before it unprofiled ({step:.2f} "
          f"ms; the profiled step's wall {wall:.2f} ms); K7 forward "
          f"{out['k7_ms']:.3f}, K8 forward {out['k8_ms']:.3f}, plain attention backward "
          f"{out['attention_backward_ms']:.3f}, plain scan backward "
          f"{out['scan_backward_ms']:.3f}, clip {out['clip_ms']:.3f}, optimizer "
          f"{out['optimizer_ms']:.3f}, GEMM kernels "
          f"{out['gemm_ms']:.3f} ms (ranges by their kernels' device time; 0 where the "
          f"profiler attributed none); top kernels {top}", flush=True)
    return out


def obs_tune(torch, tuning, registry, obs, buckets, counted=()) -> float:
    """The obs phase's tuning: every (kernel, shape) of ``buckets`` searched
    under ``tuning="search"`` into a fresh cache under ``build/``, each
    candidate held to its plain version (none may be rejected) and its
    CUDA-event time printed beside the default's and the winner; then the
    same buckets resolved under ``"cached"`` from a fresh state: all hits, no
    search.  Leaves ``REPRO_TUNING_CACHE`` pointing at the cache.  The
    launch counts of the wrappers in ``counted`` are left as they were: the
    search's launches are not a path's.  Returns its seconds."""
    from repro_torch.core.engine import ExecutionContext

    t0 = time.perf_counter()
    held = [fn.launches for fn in counted]
    cache_dir = ROOT / "build" / "tuning_cache"
    shutil.rmtree(cache_dir, ignore_errors=True)
    os.environ["REPRO_TUNING_CACHE"] = str(cache_dir)
    tuning.reset_stats()
    search = ExecutionContext(tuning="search")
    won = []
    for name, shape in buckets:
        tiles = tuning.tiles_for(search, name, **shape)
        spec = registry.get(name)
        rec = tuning.default_cache().get(
            tuning._cache_key(spec, spec.bucket(**shape), tuning.device_key()))
        won.append(tiles)
        times = ", ".join(f"{k} {v:.2f}" for k, v in rec["timings"].items())
        print(f"phase obs: tuned {name} at {shape} (bucket {spec.bucket(**shape)}): "
              f"{rec['candidates']} candidates held to the plain version, {rec['rejected']} "
              f"rejected; us a call {{{times}}}; default {rec['default']['tiles']} "
              f"{rec['default']['us']:.2f} us, winner {rec['tiles']} {rec['us']:.2f} us",
              flush=True)
        if rec["rejected"] or rec["us"] is None:
            raise AssertionError(f"obs: a candidate of {name} at {shape} failed parity with "
                                 f"the plain version: {rec['rejected_tiles']}")
    searched = tuning.STATS["searches"]
    tuning.reset_stats()
    cached = ExecutionContext(tuning="cached")
    again = [tuning.tiles_for(cached, name, **shape) for name, shape in buckets]
    print(f"phase obs: {searched} searches into {cache_dir}; the same {len(buckets)} buckets "
          f"under 'cached' from a fresh state: {tuning.STATS['cache_hits']} hits, "
          f"{tuning.STATS['searches']} searches; cache status {tuning.cache_status()}",
          flush=True)
    if again != won or tuning.STATS["searches"] or tuning.STATS["cache_hits"] != len(buckets):
        raise AssertionError("obs: the cached resolution did not hit every tuned bucket")
    for fn, n in zip(counted, held):
        fn.launches = n
    return time.perf_counter() - t0


# -- the shard phase (module level: the gloo world's ranks import it) --------

def _shard_moe(torch, dist, rank, dev, sync, dev_type, dt, out_rows) -> None:
    """The shard phase's EP MoE in ``dt``: the single-device reference on
    rank 0, then each mesh's EP run on every rank, into ``out_rows``."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_arch, rules_for
    from repro_torch.models import moe
    from repro_torch.models.sharding import set_mesh
    from repro_torch.models.spec import init_params

    cfg = get_arch(SHARD_ARCH)
    e, d = cfg.moe, cfg.d_model
    spec = moe.moe_spec(cfg)
    empty_cache = torch.cuda.empty_cache if dev_type == "cuda" else (lambda: None)
    gen = torch.Generator(device=dev).manual_seed(SHARD_SEED)
    xs = {name: (torch.randn((b, s, d), generator=gen, device=dev) * 0.5).to(dt)
          for name, (b, s) in SHARD_TOKENS.items()}
    want = {}
    t0 = time.perf_counter()
    if rank == 0:   # the single-device moe_apply, full weights on this rank only
        full = init_params(spec, seed=0, dtype=dt, device=dev)
        for name, x in xs.items():
            want[name] = moe.moe_apply(full, x, cfg)
        del full
        empty_cache()
    for name, x in xs.items():
        out = want[name][0] if rank == 0 else torch.empty_like(x)
        aux = want[name][1].reshape(1) if rank == 0 else torch.empty(1, device=dev)
        dist.broadcast(out, 0)
        dist.broadcast(aux, 0)
        want[name] = (out, aux)
    sync()
    reference_s = time.perf_counter() - t0

    for shape in SHARD_MESHES:
        mesh = init_device_mesh(dev_type, shape, mesh_dim_names=("data", "model"))
        ws = shape[0] > 1
        t0 = time.perf_counter()
        # each rank draws its block of every expert bank, placed by the arch's
        # rules; the router is drawn whole on every rank: the rules split it,
        # and gathering it is a DTensor redistribute, whose functional
        # collectives crash under gloo with CUDA tensors (torch 2.11)
        rules = rules_for(cfg, ShapeConfig("shard", PROMPT_LEN, 4, "prefill"),
                          mesh_model=shape[1], mesh_data=shape[0])
        banks = {k: v for k, v in spec.items() if k != "router"}
        p = init_params(banks, seed=0, dtype=dt, device=dev, mesh=mesh, rules=rules)
        local = {k: v.to_local() for k, v in p.items()}
        p["router"] = init_params({"router": spec["router"]}, seed=0, dtype=dt,
                                  device=dev)["router"]
        sync()
        row = {"body": "_ep_decode_body" if ws else "_ep_body", "reference_s": reference_s,
               "init_s": time.perf_counter() - t0, "local_weight_bytes":
               sum(v.numel() * v.element_size() for v in local.values())}
        for name, x in xs.items():
            walls = []
            for _ in range(2):   # the first call warms gloo's CUDA staging
                for k in moe.EP_STATS:
                    moe.EP_STATS[k] = type(moe.EP_STATS[k])(0)
                dist.barrier()
                sync()
                t0 = time.perf_counter()
                with set_mesh(mesh):
                    out, aux = moe.moe_apply(p, x, cfg)
                sync()
                walls.append(time.perf_counter() - t0)
            # this rank's block of the single-device output, by the output's
            # placements (moe_apply constrains its output to the batch over data)
            ref = want[name][0]
            for i, q in enumerate(out.placements):
                if q.is_shard():
                    n = ref.shape[q.dim] // mesh.size(i)
                    ref = ref.narrow(q.dim, mesh.get_local_rank(i) * n, n)
            got, ref = out.to_local().float(), ref.float()
            err = torch.stack([(got - ref).abs().max() / ref.abs().max(),
                               (aux.float() - want[name][1][0].float()).abs()])
            dist.all_reduce(err, op=dist.ReduceOp.MAX)
            row[name] = {"ms": walls[1] * 1e3, "first_ms": walls[0] * 1e3,
                         "max_err_over_max": float(err[0]),
                         "aux_err": float(err[1]), "allreduces": moe.EP_STATS["calls"],
                         "allreduce_bytes": moe.EP_STATS["bytes"],
                         "allreduce_ms": moe.EP_STATS["seconds"] * 1e3,
                         "placements": [str(q) for q in out.placements]}
        out_rows[f"{shape[0]}x{shape[1]} {str(dt)[6:]}"] = row
        del p, local
        empty_cache()

def _shard_world(torch, dist, rank: int, world: int, dev_type: str = "cuda") -> dict:
    """One rank of the shard phase's gloo world (every rank on cuda:0; on
    the host with ``dev_type="cpu"``, a rehearsal)."""
    from repro_torch.optim.compress import compressed_psum

    dev = torch.device(dev_type, 0) if dev_type == "cuda" else torch.device("cpu")
    sync = torch.cuda.synchronize if dev_type == "cuda" else (lambda: None)
    res = {"collectives": {}}
    # which gloo collectives take CUDA tensors (every rank tries each alike)
    probes = {
        "all_reduce f32": lambda: dist.all_reduce(torch.ones(4, device=dev)),
        "all_reduce bf16": lambda: dist.all_reduce(torch.ones(4, dtype=torch.bfloat16,
                                                              device=dev)),
        "all_reduce int32 max": lambda: dist.all_reduce(
            torch.ones(4, dtype=torch.int32, device=dev), op=dist.ReduceOp.MAX),
        "broadcast f32": lambda: dist.broadcast(torch.ones(4, device=dev), 0),
        "all_gather f32": lambda: dist.all_gather(
            [torch.empty(4, device=dev) for _ in range(world)], torch.ones(4, device=dev)),
        "reduce_scatter f32": lambda: dist.reduce_scatter_tensor(
            torch.empty(4, device=dev), torch.ones(4 * world, device=dev)),
    }
    for name, fn in probes.items():
        try:
            fn()
            sync()
            res["collectives"][name] = "ok"
        except Exception as exc:  # noqa: BLE001 -- recorded: the refusal is the finding
            res["collectives"][name] = f"refused: {type(exc).__name__}: " \
                                       f"{str(exc).strip().splitlines()[0][:160]}"
    dist.barrier()
    # bf16 where gloo reduces bf16 CUDA tensors, and always f32
    dtypes = ([torch.bfloat16] if res["collectives"]["all_reduce bf16"] == "ok" else []) \
        + [torch.float32]
    res["dtypes"] = [str(dt)[6:] for dt in dtypes]
    res["meshes"] = {}
    for dt in dtypes:
        _shard_moe(torch, dist, rank, dev, sync, dev_type, dt, res["meshes"])

    # compressed_psum against the single-rank sum of every rank's tensor
    xs_all = [torch.randn(SHARD_PSUM_ELEMS, generator=torch.Generator(device=dev)
                          .manual_seed(SHARD_SEED + 1 + j), device=dev) for j in range(world)]
    dist.barrier()
    sync()
    t0 = time.perf_counter()
    total, err = compressed_psum(xs_all[rank])
    sync()
    psum_s = time.perf_counter() - t0
    gmax = torch.stack([x.abs().max() for x in xs_all]).max()
    scale = torch.clamp(gmax, min=1e-12) / 127.0
    qs = [torch.clamp(torch.round(x / scale), -127, 127).to(torch.int32) for x in xs_all]
    expect = torch.stack(qs).sum(0).to(torch.float32) * scale
    exact = sum(x.double() for x in xs_all)
    ok = torch.tensor([float(torch.equal(total, expect)),
                       float((total.double() - exact).abs().max()),
                       float(torch.equal(err, (xs_all[rank].double() - qs[rank].double()
                                               * scale.double()).float()))], device=dev)
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    res["psum"] = {"elements": SHARD_PSUM_ELEMS, "ms": psum_s * 1e3,
                   "equal_to_single_rank_sum": bool(ok[0]), "err_equal": bool(ok[2]),
                   "max_dev_from_exact_sum": float(ok[1]),
                   "half_step_bound": float(world * scale / 2)}
    return res


def shard_worker(rank: int, world: int, port: int, out_path: str,
                 dev_type: str = "cuda") -> None:
    """Entry of one rank of the shard phase's gloo world."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    if dev_type == "cuda":
        torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        res = _shard_world(torch, dist, rank, world, dev_type)
        if rank == 0:
            Path(out_path).write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dtensor_train_check(torch, dev, wrappers, cfg, backend: str) -> dict:
    """The DTensor train step in a world of 1 on a (1, 1) mesh: two AdamW
    steps of ``cfg`` against the same steps on plain tensors."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import rules_for
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import model_spec
    from repro_torch.models.spec import distribute_params, init_params
    from repro_torch.optim import cosine_schedule, make_optimizer, tree_leaves, tree_map

    dist.init_process_group(backend, init_method=f"tcp://localhost:{_free_port()}", rank=0,
                            world_size=1)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    try:
        mesh = init_device_mesh(dev.type, (1, 1), mesh_dim_names=("data", "model"))
        shape = ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")
        rules = rules_for(cfg, shape, mesh_model=1, mesh_data=1)
        spec = model_spec(cfg)
        params = rescale_attention(torch, init_params(spec, seed=0, device=dev))
        data = SyntheticLM(cfg, shape, seed=0)
        batches = [train.batch_to_device(data.batch(t), dev, torch.bfloat16) for t in range(2)]
        opt = make_optimizer(cfg.optimizer, cosine_schedule(1e-3, warmup_steps=TRAIN_WARMUP,
                                                            total_steps=TRAIN_STEPS))
        runs = {}
        for label in ("dtensor", "plain tensors"):
            p = distribute_params(params, spec, rules, mesh) if label == "dtensor" else \
                tree_map(lambda v: v.clone(), params)   # the in-place step keeps params
            st = opt.init(p)
            step = make_train_step(cfg, opt, mesh=mesh if label == "dtensor" else None,
                                   rules=rules)
            before = wrappers["K7"].launches
            losses, ms = [], []
            for t in range(2):
                sync()
                t1 = time.perf_counter()
                p, st, m = step(p, st, t, batches[t])
                losses.append(float(m["loss"]))
                sync()
                ms.append((time.perf_counter() - t1) * 1e3)
            leaves = [x.to_local() if hasattr(x, "to_local") else x for x in tree_leaves(p)]
            runs[label] = (losses, leaves, wrappers["K7"].launches - before, ms)
    finally:
        dist.destroy_process_group()
    (l_d, p_d, k7_d, ms_d), (l_p, p_p, _, ms_p) = runs["dtensor"], runs["plain tensors"]
    param_err = max(rel_norm(a, b) for a, b in zip(p_d, p_p))
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(l_d, l_p))
    bitwise = all(torch.equal(a, b) for a, b in zip(p_d, p_p))
    want = 2 * 2 * cfg.n_layers   # a forward and its remat forward, two steps
    print(f"phase shard: the DTensor train step ({backend} world of 1, (1, 1) mesh), "
          f"{cfg.name} at full width cut to {cfg.n_layers} layers, bf16, batch "
          f"{TRAIN_BATCH} x seq {TRAIN_SEQ}, two AdamW steps: loss {l_d} (plain tensors "
          f"{l_p}), relative loss error {loss_err:.3g}, parameters' worst relative norm "
          f"{param_err:.3g} (limit {SERVE_REL}), bitwise {bitwise}; K7 launches {k7_d} "
          f"(expected {want}); step ms {[round(v, 1) for v in ms_d]} (plain tensors "
          f"{[round(v, 1) for v in ms_p]})", flush=True)
    if loss_err > SERVE_REL or param_err > SERVE_REL or k7_d != want:
        raise AssertionError("the DTensor train step differs from the plain-tensor step")
    return {"loss": l_d, "plain_loss": l_p, "param_err": param_err, "bitwise": bitwise,
            "k7_launches": k7_d, "step_ms": ms_d, "plain_step_ms": ms_p}


def shard_phase(torch, dev, wrappers, dse_args) -> dict:
    """The shard phase (module docstring).  Returns the printed figures."""
    import numpy as np
    import torch.multiprocessing as mp

    from repro_torch.configs.registry import get_arch
    from repro_torch.core.engine import ExecutionContext
    from repro_torch.core.fastchar import behav_metrics_torch

    stats, wall = {}, {}

    # (1) the DSE shard axes, one shard a card
    t0 = time.perf_counter()
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print(f"phase shard: the DSE shard axes ('configs', 'lanes') were held on the CPU "
              f"only (tests/test_torch_sharding.py): this machine has {n_cards} CUDA device",
              flush=True)
    else:
        spec, train_cfgs, front, app, sweep = dse_args
        sharded = ExecutionContext(n_devices=n_cards)
        for label, cfgs, impl in (("training set", train_cfgs, "table"),
                                  ("map+ga front", front, "entry")):
            a = behav_metrics_torch(spec, cfgs, impl=impl, ctx=ExecutionContext())
            b = behav_metrics_torch(spec, cfgs, impl=impl, ctx=sharded)
            if not all(np.array_equal(a[k], b[k]) for k in a):
                raise AssertionError(f"config-sharded {label} ({impl}) differs")
        for impl in ("table", "entry"):
            a = app.behav(spec, train_cfgs, backend=ExecutionContext(kernel_impl=impl))
            b = app.behav(spec, train_cfgs, backend=ExecutionContext(kernel_impl=impl,
                                                                   n_devices=n_cards))
            if not np.array_equal(a, b):
                raise AssertionError(f"config-sharded {app.name} BEHAV ({impl}) differs")
        runner, args = sweep
        a = runner(ExecutionContext()).run_sweep(*args)
        b = runner(sharded).run_sweep(*args)
        if not all(np.array_equal(x.population, y.population) for x, y in zip(a, b)):
            raise AssertionError("the lane-sharded sweep differs")
        print(f"phase shard: DSE axes on {n_cards} cards: the training set (K1), the map+ga "
              f"front (K2), {app.name} BEHAV (K4, K5) and a {len(args[0])}-lane sweep (K3) "
              f"bit-identical to one card", flush=True)
    wall["dse"] = time.perf_counter() - t0

    # (2) the EP MoE and compressed_psum: a gloo world sharing cuda:0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "shard.json")
        mp.start_processes(shard_worker, args=(SHARD_WORLD, _free_port(), out_path),
                           nprocs=SHARD_WORLD, start_method="spawn")
        res = json.loads(Path(out_path).read_text())
    wall["gloo world"] = time.perf_counter() - t0
    cfg = get_arch(SHARD_ARCH)
    print(f"phase shard: gloo collectives on CUDA tensors (4 ranks on cuda:0): "
          f"{json.dumps(res['collectives'])}", flush=True)
    for mesh_name, row in res["meshes"].items():
        shape, dtype = mesh_name.split()
        limit = SHARD_BF16_LIMIT if dtype == "bfloat16" else REL_RTOL
        print(f"phase shard: {SHARD_ARCH}'s MoE layer at full width ({cfg.moe.n_experts} "
              f"experts, top-{cfg.moe.top_k}, d {cfg.d_model}, expert ff "
              f"{cfg.moe.d_ff_expert}, {dtype}) on a ({shape.replace('x', ', ')}) mesh "
              f"through {row['body']}, against the single-device moe_apply (limit {limit:.3g} "
              f"of its largest entry): {json.dumps(row)}", flush=True)
        for name in SHARD_TOKENS:
            r = row[name]
            if not r["max_err_over_max"] <= limit or r["aux_err"] > 1e-6 \
                    or r["allreduces"] == 0:
                raise AssertionError(f"the EP MoE on {mesh_name} at {name} differs from "
                                     f"the single-device moe_apply: {r}")
    ps = res["psum"]
    print(f"phase shard: compressed_psum of {ps['elements']} f32 a rank over 4 ranks: "
          f"{json.dumps(ps)}", flush=True)
    if not (ps["equal_to_single_rank_sum"] and ps["err_equal"]
            and ps["max_dev_from_exact_sum"] <= ps["half_step_bound"]):
        raise AssertionError(f"compressed_psum differs from the single-rank sum: {ps}")
    stats["gloo"] = res

    # (3) the DTensor train step: an NCCL world of 1 on a (1, 1) mesh
    t0 = time.perf_counter()
    full = get_arch("granite-3-2b")
    stats["dtensor_train"] = dtensor_train_check(torch, dev, wrappers, dataclasses.replace(
        full, stages=(dataclasses.replace(full.stages[0], repeats=SHARD_TRAIN_LAYERS),)),
        "nccl")
    wall["dtensor train"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    stats["wall_s"] = wall
    print(f"phase shard: wall seconds {json.dumps({k: round(v, 1) for k, v in wall.items()})}",
          flush=True)
    return stats


# -- the dryrun phase ---------------------------------------------------------

# (arch, shape, multi-pod) of the dryrun phase's cells, traced by their probes
DRYRUN_CELLS = (("granite-3-2b", "train_4k", False), ("granite-3-2b", "prefill_32k", False),
                ("granite-3-2b", "decode_32k", False), ("granite-3-2b", "long_500k", False),
                ("mamba2-130m", "long_500k", False), ("granite-3-2b", "decode_32k", True))
# the one-rank cross-check's FLOPs, predicted against measured
DRYRUN_FLOPS_REL = 0.01


def dryrun_cells(out_dir: str) -> dict:
    """The dryrun phase's cells (module docstring): records written to
    ``out_dir`` and printed, then the report's tables."""
    import io
    from contextlib import redirect_stdout

    import torch.distributed as dist

    from repro_torch.launch import dryrun, report

    recs, wall = {}, {}
    for arch, shape, multi in DRYRUN_CELLS:
        mesh = "2x16x16" if multi else "16x16"
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, multi, verbose=False, probe=True, device="cuda")
        wall[f"{arch} {shape} {mesh}"] = time.perf_counter() - t0
        with open(os.path.join(out_dir, f"{arch}__{shape}__{mesh}.json"), "w") as f:
            json.dump(rec, f, indent=1, default=str)
        recs[(arch, shape, mesh)] = rec
        if rec["status"] != "ok":
            print(f"phase dryrun: {arch} x {shape} x {mesh}: {rec['status']}", flush=True)
            if not rec["status"].startswith("skip"):
                raise AssertionError(f"the dry-run of {arch} x {shape} x {mesh} failed")
            continue
        coll = {k: int(v) for k, v in rec["coll_breakdown"].items() if v}
        print(f"phase dryrun: {arch} x {shape} x {mesh} ({rec['chips']} fake ranks, probes "
              f"traced in {rec['t_probe_s']:.1f} s): status ok; per-device need "
              f"{rec['hbm_need_bytes'] / 1e9:.3f} GB (arguments "
              f"{rec['argument_size_in_bytes'] / 1e9:.3f} GB; fits 80 GB: "
              f"{rec['fits_h100_hbm']}); FLOPs {rec['hlo_flops']:.4g} a device; bytes "
              f"{rec['hlo_bytes']:.4g}; collective bytes {rec['coll_bytes']:.4g} {coll}; "
              f"t_compute {rec['t_compute_s']:.4g} s, t_memory {rec['t_memory_s']:.4g} s, "
              f"t_collective {rec['t_collective_s']:.4g} s -> {rec['bottleneck']}; MFU bound "
              f"{rec['mfu_bound']:.4f}", flush=True)
    buf = io.StringIO()
    with redirect_stdout(buf):
        report.main(["--dir", out_dir])
    for line in buf.getvalue().splitlines():   # the cells not run here are left out
        if line.strip() and "MISSING" not in line:
            print(f"phase dryrun: report: {line}", flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()   # later phases see no world
    return {"wall_s": wall, "records": {" ".join(k): v for k, v in recs.items()}}


def dryrun_cross_check(torch, dev, kept, measured_peak: int) -> dict:
    """One rank: ``lower_step`` of the train phase's granite step against the
    card's peak memory and ``profile_fn``'s FLOP count of that step."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import rules_for
    from repro_torch.launch.lowering import lower_step
    from repro_torch.obs.profile import profile_fn

    step_fn, params, state, batch, opt, cfg, _ = kept
    shape = ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    t0 = time.perf_counter()
    pred = lower_step(cfg, shape, None, rules_for(cfg, shape), device="cuda")
    t_trace = time.perf_counter() - t0
    prof = profile_fn(step_fn, params, state, TRAIN_STEPS, batch, name="granite_train_step",
                      iters=1, device=dev)
    flops = prof.cost["flops"]
    out = {"predicted_peak_bytes": pred["peak_bytes"],
           "predicted_argument_bytes": pred["argument_size_in_bytes"],
           "measured_peak_bytes": measured_peak, "predicted_flops": pred["flops"],
           "measured_flops": flops, "peak_ratio": measured_peak / pred["peak_bytes"],
           "flops_ratio": flops / pred["flops"], "trace_s": t_trace,
           "predicted_coll_bytes": pred["coll_total"]}
    print(f"phase dryrun: one-rank cross-check, {cfg.name} train step (batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, AdamW, remat) traced on fake cuda tensors in {t_trace:.1f} s: "
          f"predicted peak {pred['peak_bytes'] / 2**30:.3f} GiB (arguments "
          f"{pred['argument_size_in_bytes'] / 2**30:.3f} GiB), measured in the train phase "
          f"{measured_peak / 2**30:.3f} GiB: measured / predicted {out['peak_ratio']:.4f}; "
          f"FLOPs predicted {pred['flops']:.6g}, measured by profile_fn {flops:.6g}: "
          f"{out['flops_ratio']:.6f}; collective bytes {pred['coll_total']:.0f}", flush=True)
    if abs(out["flops_ratio"] - 1) > DRYRUN_FLOPS_REL or pred["coll_total"] != 0:
        raise AssertionError("the one-rank trace's FLOPs differ from the card's count")
    return out


def ops_vs_raw(torch, dev, gen) -> dict:
    """K7 and K8 through their custom ops and through the raw launchers:
    equal bit for bit, both timed by events."""
    from repro_torch.kernels import flash_attention as k7, ssd_scan as k8

    b, h, g, s, hd = 4, 32, 8, PROMPT_LEN, 64
    q = torch.randn((b, s, h, hd), generator=gen, device=dev).bfloat16().transpose(1, 2)
    kv = [torch.randn((b, s, g, hd), generator=gen, device=dev).bfloat16().transpose(1, 2)
          for _ in range(2)]
    scale = 1.0 / math.sqrt(hd)
    with torch.no_grad():
        calls = {   # the wrapper (its checks, then the op), the op alone, the raw launch
            "K7": (lambda: k7.flash_attention(q, *kv),
                   lambda: torch.ops.repro_torch.flash_attention(q, *kv, True, scale, 0, s),
                   lambda: k7.flash_attention_raw(q, *kv, True, scale, 0, s)),
        }
        x, dt, a, bm, cm = ssd_inputs(torch, SSM_SHAPE, torch.bfloat16, gen)
        calls["K8"] = (lambda: k8.ssd_scan(x, dt, a, bm, cm),
                       lambda: torch.ops.repro_torch.ssd_scan(x, dt, a, bm, cm, None, 128),
                       lambda: k8.ssd_scan_raw(x, dt, a, bm, cm))
        out = {}
        for k, fns in calls.items():
            got = [fn() for fn in fns]
            flat = [t if isinstance(t, tuple) else (t,) for t in got]
            same = all(torch.equal(u, v) for f in flat[:2] for u, v in zip(f, flat[2]))
            n = 500 if k == "K7" else 50
            ms = [cuda_ms(torch, fn, n) for fn in fns]
            out[k] = {"wrapper_ms": ms[0], "op_ms": ms[1], "raw_ms": ms[2], "same": same}
    k7r, k8r = out["K7"], out["K8"]
    print(f"phase dryrun: K7 at granite's prefill (B={b}, H={h}, G={g}, S={s}, hd {hd}, bf16): "
          f"flash_attention (its checks, then the op) {k7r['wrapper_ms']:.4f} ms, "
          f"torch.ops.repro_torch.flash_attention {k7r['op_ms']:.4f} ms, the raw launcher "
          f"{k7r['raw_ms']:.4f} ms, by events over back-to-back calls; bit for bit equal: "
          f"{k7r['same']}.  K8 at mamba2's prefill {SSM_SHAPE} (bf16): ssd_scan "
          f"{k8r['wrapper_ms']:.4f} ms, torch.ops.repro_torch.ssd_scan {k8r['op_ms']:.4f} ms, "
          f"raw {k8r['raw_ms']:.4f} ms; bit for bit equal: {k8r['same']}", flush=True)
    if not (k7r.pop("same") and k8r.pop("same")):
        raise AssertionError("a custom op's output differs from its raw launcher's")
    return out


def http_json(url: str, body: dict | None = None) -> dict:
    """GET (or POST ``body`` as JSON to) ``url``; the JSON answer."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: no card, no result",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.apps import APPLICATIONS, characterized_dataset_multi, fastapp
    from repro_torch.axo import AxOOperator, deploy_axo
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import fastchar, fastmoo
    from repro_torch.core.automl import fit_estimators
    from repro_torch.core.dataset import BEHAV_KEY, PPA_KEY, Dataset, build_training_dataset
    from repro_torch import obs
    from repro_torch.core.dse import (
        CONST_SF_GRID, DSESettings, hv_reference, map_solution_pool, run_dse, run_dse_sweep,
    )
    from repro_torch.core.engine import ExecutionContext
    from repro_torch.core.metrics import behav_metrics
    from repro_torch.core.moo import nsga2
    from repro_torch.core.operator_model import accurate_config, config_to_masks, spec_for
    from repro_torch.core.ppa import ppa_metrics
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import (
        app_kernels, axo_matmul, build, char_kernels, flash_attention, moo_kernels, registry,
        ssd_scan, tuning,
    )
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import attention
    from repro_torch.models.layers import rmsnorm
    from repro_torch.models.model import model_spec
    from repro_torch.models.spec import count_params, init_params
    from repro_torch.launch.roofline import HW
    from repro_torch.obs.profile import profile_registry, trace_capture
    from repro_torch.obs.prom import MetricsServer
    from repro_torch.service import DSEJobQueue, DSERequest, OperatorStore, default_runner
    from repro_torch.service.store import store_status

    t_start = time.perf_counter()
    segments = {}   # each section's start, for the wall-clock breakdown
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False   # IEEE f32 products (K6's plain version)
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. device ----------------------------------------------------------
    card = smi("name,power.limit")
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    int_rate = N_SMS * INT32_LANES_PER_SM * clock_mhz * 1e6
    f32_rate = N_SMS * F32_LANES_PER_SM * 2 * clock_mhz * 1e6   # FMA = 2 FLOPs
    issue_rate = N_SMS * ISSUE_LANES_PER_SM * clock_mhz * 1e6
    gather_rate = N_SMS * SMEM_WORDS_PER_SM * clock_mhz * 1e6
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"phase device: nvidia-smi '{card}', torch '{torch.cuda.get_device_name(0)}', "
          f"count {torch.cuda.device_count()}, {n_sms} SMs, max SM clock {clock_mhz:.0f} MHz, "
          f"derived int32 rate {int_rate:.4g} op/s, f32 rate {f32_rate:.4g} FLOP/s, "
          f"torch {torch.__version__} "
          f"cuda {torch.version.cuda}, python {sys.version.split()[0]}", flush=True)

    # -- 2. build -----------------------------------------------------------
    segments["build"] = time.perf_counter()
    t0 = time.perf_counter()
    built = build.build_all()
    print(f"phase build: {sorted(built)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in built:
        for line in build.ptxas_log(name).splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling entry")):
                print(f"  ptxas {name}: {line.strip()}")

    # -- 3. kernels vs plain versions ---------------------------------------
    segments["kernels"] = time.perf_counter()
    spec = spec_for(8)
    rows, b_n = spec.rows, spec.n_inputs
    a_tile = fastchar.default_a_tile(spec)
    n_ta = b_n // a_tile
    rng = np.random.default_rng(0)
    cfgs = np.concatenate([
        rng.integers(0, 2, (256, spec.n_luts)).astype(np.uint8),
        accurate_config(spec)[None], np.zeros((1, spec.n_luts), np.uint8),
    ])
    d = len(cfgs)
    masks = torch.from_numpy(config_to_masks(spec, cfgs).astype(np.int32)).to(dev)
    small = fastchar._gather_small(masks, 8)
    _, exact, w = fastchar._device_tables(8, str(dev))

    i1, r1 = char_kernels.behav_stats_table(small, exact, w, a_tile)
    i1p, r1p = char_kernels.behav_stats_table_plain(small, exact, w, a_tile)
    i0, r0 = char_kernels.behav_stats_table_first(small, exact, w, a_tile)
    i2, r2 = char_kernels.behav_stats_entry(masks, 8, a_tile)
    i2p, r2p = char_kernels.behav_stats_entry_plain(masks, 8, a_tile)
    i20, r20 = char_kernels.behav_stats_entry_first(masks, 8, a_tile)
    # a ragged D (K1's walk's last block holds 1 of its 4 configs; K2's walk
    # takes 1 config a thread there)
    small_r = small[:, :37].contiguous()
    masks_r = masks[:37].contiguous()
    i1r, r1r = char_kernels.behav_stats_table(small_r, exact, w, a_tile)
    i0r, r0r = char_kernels.behav_stats_table_first(small_r, exact, w, a_tile)
    i1rp, r1rp = char_kernels.behav_stats_table_plain(small_r, exact, w, a_tile)
    i2r, r2r = char_kernels.behav_stats_entry(masks_r, 8, a_tile)
    i20r, r20r = char_kernels.behav_stats_entry_first(masks_r, 8, a_tile)
    i2rp, r2rp = char_kernels.behav_stats_entry_plain(masks_r, 8, a_tile)
    torch.cuda.synchronize()
    for name, ik, ip, rk, rp in (("K1", i1, i1p, r1, r1p), ("K2", i2, i2p, r2, r2p),
                                 ("K1 first design", i0, i1p, r0, r1p),
                                 ("K2 first design", i20, i2p, r20, r2p),
                                 ("K1 at D=37", i1r, i1rp, r1r, r1rp),
                                 ("K1 first design at D=37", i0r, i1rp, r0r, r1rp),
                                 ("K2 at D=37", i2r, i2rp, r2r, r2rp),
                                 ("K2 first design at D=37", i20r, i2rp, r20r, r2rp)):
        if not torch.equal(ik, ip):
            raise AssertionError(f"{name} int channels differ from the plain version")
        torch.testing.assert_close(rk, rp, rtol=REL_RTOL, atol=0)
    if not (torch.equal(i1, i2) and torch.equal(i1r, i2r)):
        raise AssertionError("K2 int channels differ from K1's")
    err = {"K1": float((r1 - r1p).abs().max()), "K2": float((r2 - r2p).abs().max())}

    out_bytes = 2 * n_ta * d * 8 * 4

    def k2_bound(n_cfgs: int):
        """K2's bound at D configs: K1_PAIR_OPS a (config, pair),
        K2_PAIR_ONLY_OPS a pair and each config's R x 4 x B plane values once
        (CHAIN_OPS each), at the issue rate; its bytes."""
        ops = (n_cfgs * b_n * b_n * K1_PAIR_OPS + b_n * b_n * K2_PAIR_ONLY_OPS
               + n_cfgs * rows * 4 * b_n * CHAIN_OPS)
        return bound(n_cfgs * rows * 4 + 2 * n_ta * n_cfgs * 8 * 4, ops, 0, issue_rate)

    def k2_old_bound(n_cfgs: int) -> float:
        """K2's earlier bound: 16 instructions a (config, pair) and the
        bit-serial synthesis once a config."""
        ops = (n_cfgs * b_n * b_n * (K1_PAIR_OPS + K2_PAIR_ONLY_OPS)
               + n_cfgs * rows * 4 * b_n * FIRST_CHAIN_OPS)
        return bound(n_cfgs * rows * 4 + 2 * n_ta * n_cfgs * 8 * 4, ops, 0, issue_rate)[0]

    def k2_tiers(args) -> dict:
        """K2's walk at 4 and at 1 configs a thread, CUDA-event ms."""
        return {g: cuda_ms(torch, lambda: char_kernels.behav_stats_entry_at(*args, g), 50)
                for g in (4, 1)}

    rec = {}
    rec["K1"] = dict(
        name="behav_stats_table", source="src/repro_torch/kernels/csrc/char_kernels.cu",
        replaces="src/repro/kernels/char_kernels.py:107",
        ms=cuda_ms(torch, lambda: char_kernels.behav_stats_table(small, exact, w, a_tile), 50),
        # the first design on the same inputs, in this call
        old_ms=cuda_ms(torch, lambda: char_kernels.behav_stats_table_first(
            small, exact, w, a_tile), 50),
        plain_ms=cuda_ms(torch, lambda: char_kernels.behav_stats_table_plain(
            small, exact, w, a_tile), 5),
        bound=bound(small.numel() * 4 + 2 * b_n * b_n * 4 + out_bytes, d * b_n * b_n * K1_PAIR_OPS,
                    0, issue_rate),
    )
    rec["K2"] = dict(
        name="behav_stats_entry", source="src/repro_torch/kernels/csrc/char_kernels.cu",
        replaces="src/repro/kernels/char_kernels.py:226",
        ms=cuda_ms(torch, lambda: char_kernels.behav_stats_entry(masks, 8, a_tile), 50),
        # the first design on the same inputs, in this call
        old_ms=cuda_ms(torch, lambda: char_kernels.behav_stats_entry_first(
            masks, 8, a_tile), 50),
        plain_ms=cuda_ms(torch, lambda: char_kernels.behav_stats_entry_plain(
            masks, 8, a_tile), 5),
        bound=k2_bound(d), bound_term="instructions",
        # the earlier count, both tiers of the walk, and the ragged D
        old_bound_ms=k2_old_bound(d),
        configs_a_thread=char_kernels.entry_configs(d, 8, a_tile, n_sms),
        tiers_ms=k2_tiers((masks, 8, a_tile)),
        ragged={"d": 37, "configs_a_thread": char_kernels.entry_configs(37, 8, a_tile, n_sms),
                "ms": cuda_ms(torch, lambda: char_kernels.behav_stats_entry(
                    masks_r, 8, a_tile), 50),
                "old_ms": cuda_ms(torch, lambda: char_kernels.behav_stats_entry_first(
                    masks_r, 8, a_tile), 50),
                "tiers_ms": k2_tiers((masks_r, 8, a_tile)),
                "bound_ms": k2_bound(37)[0]},
    )
    k2r = rec["K2"]["ragged"]
    print(f"phase kernels: K1/K2 vs plain at D={d} configs, A=B={b_n}, a_tile={a_tile}: "
          f"int channels ==, f32 channel rtol {REL_RTOL} (max abs err K1 {err['K1']:.3g}, "
          f"K2 {err['K2']:.3g}); K2 int == K1 int; both first designs ==, and all at D=37; "
          f"K1 {rec['K1']['ms']:.4f} ms (first design {rec['K1']['old_ms']:.4f}), bound "
          f"{rec['K1']['bound'][0]:.4g} ms by {rec['K1']['bound'][1]} ({K1_PAIR_OPS} "
          f"instructions a pair at {ISSUE_LANES_PER_SM} lanes an SM a clock); K2 "
          f"{rec['K2']['ms']:.4f} ms at {rec['K2']['configs_a_thread']} configs a thread "
          f"(tiers 4 / 1: {rec['K2']['tiers_ms'][4]:.4f} / {rec['K2']['tiers_ms'][1]:.4f}; "
          f"first design {rec['K2']['old_ms']:.4f}), bound {rec['K2']['bound'][0]:.4g} ms "
          f"by instructions ({K1_PAIR_OPS} a config and pair + {K2_PAIR_ONLY_OPS} a pair + "
          f"{CHAIN_OPS} a plane value once a config; earlier count "
          f"{rec['K2']['old_bound_ms']:.4g}); K2 at D=37 "
          f"{k2r['ms']:.4f} ms at {k2r['configs_a_thread']} configs a thread (tiers 4 / 1: "
          f"{k2r['tiers_ms'][4]:.4f} / {k2r['tiers_ms'][1]:.4f}; first design "
          f"{k2r['old_ms']:.4f}, bound {k2r['bound_ms']:.4g})", flush=True)

    for p in (64, 128, 1000):
        g = np.random.default_rng(p)
        objs = g.random((p, 2)).astype(np.float32)
        viol = np.where(g.random(p) < 0.4, g.random(p), 0.0).astype(np.float32)
        active = g.random(p) < 0.7
        pad = (-p) % 128 if p == 1000 else 0   # inactive +inf-violation pad rows
        o = torch.from_numpy(np.concatenate([objs, np.zeros((pad, 2), np.float32)])).to(dev)
        v = torch.from_numpy(np.concatenate([viol, np.full(pad, np.inf, np.float32)])).to(dev)
        a = torch.from_numpy(np.concatenate([active, np.zeros(pad, bool)])).to(dev)
        got = moo_kernels.dominance_counts(o, v, a)
        want = moo_kernels.dominance_counts_plain(o, v, a)
        unpadded = moo_kernels.dominance_counts_plain(o[:p], v[:p], a[:p])
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(got[:p], unpadded)):
            raise AssertionError(f"K3 counts differ from the plain version at P={p}")
        print(f"phase kernels: K3 vs plain at P={p} (+{pad} pad rows): counts ==", flush=True)
        if p == 128:  # the environmental-selection shape of the main path (2 x pop)
            o3, v3, a3 = o, v, a
    # K3's front peel, the main path's ranking: every front in one launch, at
    # the GA's populations, P = 1000 and a chain in which every point is its
    # own front; fronts and their count equal the plain round loop's
    front_cases = {}
    for p in (64, 128, 1000):
        g = np.random.default_rng(p + 1)
        objs = g.random((p, 2)).astype(np.float32)
        viol = np.where(g.random(p) < 0.4, g.random(p), 0.0).astype(np.float32)
        front_cases[p] = (torch.from_numpy(objs).to(dev), torch.from_numpy(viol).to(dev))
    chain = torch.linspace(1.0, 0.0, 128, device=dev)
    front_cases["chain"] = (torch.stack([chain, chain], 1), torch.zeros(128, device=dev))
    for label, (o, v) in front_cases.items():
        got, n_got = moo_kernels.constraint_fronts(o, v)
        want, n_want = moo_kernels.constraint_fronts_plain(o, v)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and int(n_got) == int(n_want)):
            raise AssertionError(f"K3 constraint_fronts differs from its plain version at {label}")
        print(f"phase kernels: K3 constraint_fronts vs plain at P={o.shape[0]} ({label}): fronts "
              f"== ({int(n_got)} feasible fronts)", flush=True)
    o_r, v_r = front_cases[128]
    n_r = int(moo_kernels.constraint_fronts_plain(o_r, v_r)[1])   # rounds of the peel
    words = -(-128 // 32)
    rec["K3"] = dict(
        name="constraint_fronts", source="src/repro_torch/kernels/csrc/moo_kernels.cu",
        replaces="src/repro/kernels/moo_kernels.py:95",
        ms=cuda_ms(torch, lambda: moo_kernels.constraint_fronts(o_r, v_r), 200),
        plain_ms=cuda_ms(torch, lambda: moo_kernels.constraint_fronts_plain(o_r, v_r), 20),
        # the round-by-round route the peel replaces: a dominance_counts launch and a
        # host sync a front
        old_ms=cuda_ms(torch, lambda: moo_kernels.peel_fronts(
            lambda act: moo_kernels.dominance_counts(o_r, v_r, act), v_r <= 0), 50),
        dominance_counts_ms=cuda_ms(
            torch, lambda: moo_kernels.dominance_counts(o3, v3, a3), 200),
        # bytes: objs, viol in, fronts and the count out; operations: the
        # P x P dominance tests (2 compares an objective, 3 logic ops) once,
        # then a word AND and OR a word a point a round
        bound=bound(128 * (4 * 2 + 4 + 8) + 8,
                    128 * 128 * 7 + 128 * words * 2 * n_r, 0, int_rate),
    )
    err["K3"] = 0.0  # integer fronts, held equal above

    # K3 over lanes (the sweep's ranking): held equal to its plain version
    # lane by lane at both of the full sweep's shapes, L=12 x P=64 (the
    # tournament's ranking of population 64) and L=12 x P=128 (environmental
    # selection), and at a ragged L=5 x P=100 with a chain lane; timed beside
    # L launches of constraint_fronts, its yardstick
    lane_cases = {}
    for n_lanes, p in ((12, 64), (12, 128), (5, 100)):
        g = np.random.default_rng(10 * n_lanes + p)
        objs = g.random((n_lanes, p, 2)).astype(np.float32)
        viol = np.where(g.random((n_lanes, p)) < 0.4, g.random((n_lanes, p)), 0.0)
        if n_lanes == 5:
            objs[-1] = np.stack([np.linspace(1, 0, p)] * 2, 1)
            viol[-1] = 0.0
        o = torch.from_numpy(objs).to(dev)
        v = torch.from_numpy(viol.astype(np.float32)).to(dev)
        got, n_got = moo_kernels.constraint_fronts_lanes(o, v)
        want, n_want = moo_kernels.constraint_fronts_lanes_plain(o, v)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(n_got, n_want)):
            raise AssertionError(f"K3 over lanes differs from its plain version at L={n_lanes} "
                                 f"P={p}")
        lane_cases[(n_lanes, p)] = (o, v, n_want)
        print(f"phase kernels: K3 constraint_fronts_lanes vs plain at L={n_lanes} P={p}: "
              f"fronts == ({n_want.tolist()} feasible fronts a lane)", flush=True)
    o_l, v_l, n_l = lane_cases[(12, 128)]
    rounds = int(n_l.sum())
    rec["K3L"] = dict(
        name="constraint_fronts_lanes", source="src/repro_torch/kernels/csrc/moo_kernels.cu",
        replaces="src/repro/kernels/moo_kernels.py:95",
        ms=cuda_ms(torch, lambda: moo_kernels.constraint_fronts_lanes(o_l, v_l), 200),
        plain_ms=cuda_ms(torch, lambda: moo_kernels.constraint_fronts_lanes_plain(o_l, v_l), 5),
        # the yardstick: the same lanes one constraint_fronts launch at a time
        per_lane_ms=cuda_ms(torch, lambda: [moo_kernels.constraint_fronts(o_l[i], v_l[i])
                                            for i in range(12)], 50),
        library_ms=None,
        # K3's per-lane count (bytes in and out; the P x P tests once and a
        # word AND and OR a word a point a round) over the 12 lanes
        bound=bound(12 * (128 * (4 * 2 + 4 + 8) + 8),
                    12 * 128 * 128 * 7 + 128 * words * 2 * rounds, 0, int_rate),
    )
    err["K3L"] = 0.0

    # K4/K5 on 126 random configs + the accurate and the all-zeros config, at
    # the mnist head, the ffn GEMM1, a ragged K and the ecg and gauss
    # convolutions (the apps' own codes); K4 through both of its routes
    app_cfgs = np.concatenate([cfgs[:126], cfgs[-2:]])
    d_app = len(app_cfgs)
    tb = fastapp.table_batch(spec, app_cfgs, ctx=ExecutionContext())
    tflat = tb.tables.reshape(d_app, -1)
    mnist_app, ffn_app = APPLICATIONS["mnist"](), APPLICATIONS["ffn"]()
    ecg_app, gauss_app = APPLICATIONS["ecg"](), APPLICATIONS["gauss"]()
    x_c = np.asarray(ecg_app._x_codes, np.int32)
    img_c = torch.from_numpy(np.asarray(gauss_app._img_codes, np.int32))
    g = np.random.default_rng(1)
    gemv_shapes = {
        "mnist": (mnist_app._x_codes, mnist_app._w_codes),
        "ffn": (ffn_app._x_codes, ffn_app._w1_codes),
        "ragged": (g.integers(0, b_n, (250, 100)), g.integers(0, b_n, (100, 10))),
        "ecg conv1d": (np.lib.stride_tricks.sliding_window_view(x_c, len(ecg_app._h_codes)),
                       np.asarray(ecg_app._h_codes)[:, None]),
        "gauss conv2d": (img_c.unfold(0, 5, 1).unfold(1, 5, 1).reshape(-1, 25).numpy(),
                         np.asarray(gauss_app._k_codes).reshape(-1, 1)),
    }
    def k5_bound(n_cfgs: int, m: int, k: int, n: int):
        """K5's bound, (ms, bound_by, the term that sets it): the largest of
        its shared-memory words (K5_WORDS a product at one word a bank a
        clock), its least instructions (K5_PRODUCT_OPS a product, and each
        config's plane values once) at the issue rate, and its bytes (masks,
        codes, output)."""
        products = n_cfgs * m * k * n
        moved = (n_cfgs * rows + m * k + k * n + n_cfgs * m * n) * 4
        terms = {
            "shared-memory words": bound(0, K5_WORDS * products, 0, gather_rate)[0],
            "instructions": bound(0, K5_PRODUCT_OPS * products
                                  + n_cfgs * rows * 4 * b_n * CHAIN_OPS, 0, issue_rate)[0],
            "bytes": bound(moved, 0, 0, 1)[0],
        }
        term = max(terms, key=terms.get)
        return terms[term], "bytes" if term == "bytes" else "operations", term

    def k5_old_bound(n_cfgs: int, m: int, k: int, n: int) -> float:
        """K5's earlier bound: 3 int32 ALU operations a row a lookup
        and the bit-serial synthesis once a config, at 64 lanes an SM."""
        products = n_cfgs * m * k * n
        moved = (n_cfgs * rows + m * k + k * n + n_cfgs * m * n) * 4
        return bound(moved, 3 * rows * products + n_cfgs * rows * 4 * b_n * FIRST_CHAIN_OPS, 0,
                     int_rate)[0]

    k4_shapes = {}   # label -> (M, K, N) and the route K4's plan picks
    for label, (a_np, b_np) in gemv_shapes.items():
        a = torch.from_numpy(np.ascontiguousarray(a_np, np.int32)).to(dev)
        bb = torch.from_numpy(np.ascontiguousarray(b_np, np.int32)).to(dev)
        (m, k), n = a.shape, bb.shape[1]
        k4 = app_kernels.table_gemv(tflat, a, bb)
        k4_routes = {r: app_kernels.table_gemv(tflat, a, bb, route=r)
                     for r in ("staged", "gather")}
        k5 = app_kernels.entry_gemv(tb.masks, a, bb, 8)
        k5_first = app_kernels.entry_gemv_first(tb.masks, a, bb, 8)
        p4 = app_kernels.table_gemv_plain(tflat, a, bb)
        p5 = app_kernels.entry_gemv_plain(tb.masks, a, bb, 8)
        gemm = fastapp._matmul_gemm(tb.small, a, bb)
        torch.cuda.synchronize()
        if not (torch.equal(k4, p4) and torch.equal(k5, p5)):
            raise AssertionError(f"K4/K5 differ from their plain versions at {label}")
        for r, out in k4_routes.items():
            if not torch.equal(out, p4):
                raise AssertionError(f"K4's {r} route differs from the plain version at {label}")
        if not (torch.equal(k5, k4) and torch.equal(gemm, k4) and torch.equal(k5_first, k4)):
            raise AssertionError(f"K5, its first design or the gemm route differs from K4 "
                                 f"at {label}")
        route = app_kernels.plan(m, k, n, 8).route
        k4_shapes[label] = ((m, k, n), route)
        # K4: the tables' bytes, or the shared-memory gather at one 4-byte word
        # a bank a clock, the larger; K5: k5_bound
        lookups = d_app * m * n * k
        io_bytes = (a.numel() + bb.numel() + d_app * m * n) * 4
        route_ms = {r: cuda_ms(torch, lambda: app_kernels.table_gemv(tflat, a, bb, route=r), 20)
                    for r in ("staged", "gather")}
        k4_rec = dict(
            name="table_gemv", source="src/repro_torch/kernels/csrc/app_kernels.cu",
            replaces="src/repro/kernels/app_kernels.py:74",
            route=route, ms=route_ms[route],
            # the first design (the gather route) on the same inputs, in this call
            old_ms=route_ms["gather"], staged_ms=route_ms["staged"],
            plain_ms=cuda_ms(torch, lambda: app_kernels.table_gemv_plain(tflat, a, bb), 3),
            library_ms=cuda_ms(torch, lambda: fastapp._matmul_gemm(tb.small, a, bb), 20),
            bound=bound(tflat.numel() * 4 + io_bytes, lookups, 0, gather_rate),
        )
        k5_rec = dict(
            name="entry_gemv", source="src/repro_torch/kernels/csrc/app_kernels.cu",
            replaces="src/repro/kernels/app_kernels.py:173",
            ms=cuda_ms(torch, lambda: app_kernels.entry_gemv(tb.masks, a, bb, 8), 20),
            # the first design on the same inputs, in this call
            old_ms=cuda_ms(torch, lambda: app_kernels.entry_gemv_first(tb.masks, a, bb, 8), 20),
            plain_ms=cuda_ms(torch, lambda: app_kernels.entry_gemv_plain(
                tb.masks, a, bb, 8), 3),
            library_ms=k4_rec["library_ms"],
            bound=k5_bound(d_app, m, k, n),
            bound_term=k5_bound(d_app, m, k, n)[2],
            old_bound_ms=k5_old_bound(d_app, m, k, n),
            splits=app_kernels.entry_splits(d_app, m, k, n, 8),
        )
        print(f"phase kernels: K4/K5 vs plain at {label} D={d_app} M={m} K={k} N={n} "
              f"({m * n * k / 4 ** 8:.3g} lookups a table entry): outputs ==, K4's staged and "
              f"gather routes ==, K5 == K4 == gemm route; K4 takes the {route} "
              f"route: {k4_rec['ms']:.4f} ms (staged {route_ms['staged']:.4f}, gather "
              f"{route_ms['gather']:.4f}; plain "
              f"{k4_rec['plain_ms']:.4f}, bound "
              f"{k4_rec['bound'][0]:.4g} by {k4_rec['bound'][1]}: tables' bytes "
              f"{bound(tflat.numel() * 4 + io_bytes, 0, 0, 1)[0]:.4g}, shared-memory gather "
              f"{bound(0, lookups, 0, gather_rate)[0]:.4g}), K5 {k5_rec['ms']:.4f} ms at "
              f"{k5_rec['splits']} block(s) a config (first design {k5_rec['old_ms']:.4f}; "
              f"plain {k5_rec['plain_ms']:.4f}; bound {k5_rec['bound'][0]:.4g} by "
              f"{k5_rec['bound_term']}, earlier count {k5_rec['old_bound_ms']:.4g}), gemm route "
              f"(4 cuBLAS f32 GEMMs) {k4_rec['library_ms']:.4f} ms", flush=True)
        if label == "mnist":   # the shape of the app path's GEMV (mnist's logits)
            rec["K4"], rec["K5"] = k4_rec, k5_rec
            k5_mnist = (tb.masks, a, bb, 8)
        rec["K4"].setdefault("shapes", {})[label] = {
            key: k4_rec[key] for key in ("route", "ms", "old_ms", "staged_ms",
                                         "plain_ms", "library_ms")} | {
                                             "bound_ms": k4_rec["bound"][0]}
        rec["K5"].setdefault("shapes", {})[label] = {
            key: k5_rec[key] for key in ("ms", "old_ms", "plain_ms", "old_bound_ms",
                                         "splits", "bound_term")} | {
                                             "bound_ms": k5_rec["bound"][0],
                                             "bound_by": k5_rec["bound"][1]}
    # K4's route boundary: both routes at 0.25 to 2 lookups per table entry
    # (M*K*N / 4^8) in the convolutions' family (K=15, N=1) and the head's
    # (K=64, N=10), codes of both table halves; plan() stages from
    # STAGED_MIN_REUSE on
    sweep, g_sw = [], np.random.default_rng(2)
    for k_sw, n_sw in ((15, 1), (64, 10)):
        for reuse in (0.25, 0.35, 0.5, 0.6, 0.7, 1.0, 1.4, 2.0):
            m_sw = round(reuse * 4 ** 8 / (k_sw * n_sw))
            a_sw = torch.from_numpy(g_sw.integers(0, b_n, (m_sw, k_sw)).astype(np.int32)).to(dev)
            b_sw = torch.from_numpy(g_sw.integers(0, b_n, (k_sw, n_sw)).astype(np.int32)).to(dev)
            if not torch.equal(app_kernels.table_gemv(tflat, a_sw, b_sw, route="staged"),
                               app_kernels.table_gemv(tflat, a_sw, b_sw, route="gather")):
                raise AssertionError(f"K4's routes differ at M={m_sw} K={k_sw} N={n_sw}")
            t = {r: cuda_ms(torch, lambda: app_kernels.table_gemv(tflat, a_sw, b_sw, route=r), 100)
                 for r in ("staged", "gather")}
            sweep.append({"m": m_sw, "k": k_sw, "n": n_sw, "reuse": m_sw * k_sw * n_sw / 4 ** 8,
                          "plan": app_kernels.plan(m_sw, k_sw, n_sw, 8).route, **t})
    print("phase kernels: K4's route boundary (staged == gather at every shape; "
          f"STAGED_MIN_REUSE {app_kernels.STAGED_MIN_REUSE}): " + ", ".join(
              f"M={p['m']} K={p['k']} N={p['n']} ({p['reuse']:.3g}) staged {p['staged']:.4f} "
              f"gather {p['gather']:.4f} ms, plan {p['plan']}" for p in sweep), flush=True)
    rec["K4"]["boundary"] = sweep
    err["K4"] = err["K5"] = 0.0  # exact int32 outputs, held equal above

    # K5 at 12 bits on 62 random 12-bit configs + the accurate and the
    # all-zeros config, at the mnist head, the ffn GEMM1 and the two
    # convolutions on the apps' own 12-bit codes.  Its sums are int32 modulo
    # 2^32, as the reference's; the configs whose exact (int64) sums leave
    # int32 are counted.  Its bound, as K5's: one shared-memory word a
    # product, beside a load and an add a product and the closed-form
    # synthesis once a (config, product slot) at the issue rate, and its bytes
    spec12 = spec_for(12)
    g12 = np.random.default_rng(12)
    cfgs12 = np.concatenate([g12.integers(0, 2, (62, spec12.n_luts)).astype(np.uint8),
                             accurate_config(spec12)[None],
                             np.zeros((1, spec12.n_luts), np.uint8)])
    tb12 = fastapp.table_batch(spec12, cfgs12, ctx=ExecutionContext())
    apps12 = {name: APPLICATIONS[name]() for name in ("mnist", "ffn", "ecg", "gauss")}
    for app in apps12.values():
        app._prepare(12)
    x12 = np.asarray(apps12["ecg"]._x_codes, np.int32)
    img12 = torch.from_numpy(np.asarray(apps12["gauss"]._img_codes, np.int32))
    wide_shapes = {
        "mnist": (apps12["mnist"]._x_codes, apps12["mnist"]._w_codes),
        "ffn": (apps12["ffn"]._x_codes, apps12["ffn"]._w1_codes),
        "ecg conv1d": (np.lib.stride_tricks.sliding_window_view(
            x12, len(apps12["ecg"]._h_codes)), np.asarray(apps12["ecg"]._h_codes)[:, None]),
        "gauss conv2d": (img12.unfold(0, 5, 1).unfold(1, 5, 1).reshape(-1, 25).numpy(),
                         np.asarray(apps12["gauss"]._k_codes).reshape(-1, 1)),
    }
    planes12 = (spec12.rows + 1) // 2

    def k5w_bound(n_cfgs: int, m: int, k: int, n: int):
        products = n_cfgs * m * k * n
        slots = n_cfgs * k * n * planes12
        moved = (n_cfgs * spec12.rows + m * k + k * n + n_cfgs * m * n) * 4
        terms = {
            "shared-memory words": bound(0, K5_WORDS * products, 0, gather_rate)[0],
            "instructions": bound(0, K5_PRODUCT_OPS * products
                                  + slots * (8 * CHAIN_OPS + 16), 0, issue_rate)[0],
            "bytes": bound(moved, 0, 0, 1)[0],
        }
        term = max(terms, key=terms.get)
        return terms[term], "bytes" if term == "bytes" else "operations", term

    d12 = len(cfgs12)
    for label, (a_np, b_np) in wide_shapes.items():
        a = torch.from_numpy(np.ascontiguousarray(a_np, np.int32)).to(dev)
        bb = torch.from_numpy(np.ascontiguousarray(b_np, np.int32)).to(dev)
        (m, k), n = a.shape, bb.shape[1]
        got = app_kernels.entry_gemv(tb12.masks, a, bb, 12)
        want = app_kernels.entry_gemv_plain(tb12.masks, a, bb, 12)
        exact = app_kernels.entry_gemv_plain(tb12.masks, a, bb, 12, acc_dtype=torch.int64)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K5 at 12 bits differs from its plain version at {label}")
        if not torch.equal(exact.to(torch.int32), want):
            raise AssertionError(f"K5's plain version at 12 bits is not the int64 sum "
                                 f"modulo 2^32 at {label}")
        wrapped = int((exact.abs() >= 2**31).flatten(1).any(1).sum())
        # the yardstick: the pair-plane gemm route over the synthesized planes
        # (R = 6 cuBLAS f32 GEMMs), exact modulo 2^32 where K x 2^13 < 2^24
        gemm_ok = fastapp._gemm_ok(k, 12)
        if gemm_ok and not torch.equal(fastapp._matmul_gemm(tb12.entry_small, a, bb), want):
            raise AssertionError(f"the 12-bit gemm route differs from K5 at {label}")
        w_rec = dict(
            name="entry_gemv_wide", source="src/repro_torch/kernels/csrc/app_kernels.cu",
            replaces="src/repro/kernels/app_kernels.py:173",
            ms=cuda_ms(torch, lambda: app_kernels.entry_gemv(tb12.masks, a, bb, 12), 20),
            plain_ms=cuda_ms(torch, lambda: app_kernels.entry_gemv_plain(
                tb12.masks, a, bb, 12), 3),
            library_ms=cuda_ms(torch, lambda: fastapp._matmul_gemm(
                tb12.entry_small, a, bb), 20) if gemm_ok else None,
            library_reason="the gemm route over the synthesized planes (6 cuBLAS f32 GEMMs)"
                           if gemm_ok else "none: the gemm route is not exact here "
                                           "(K x 2^13 reaches 2^24)",
            bound=k5w_bound(d12, m, k, n), bound_term=k5w_bound(d12, m, k, n)[2],
            splits=app_kernels.entry_wide_splits(d12, m, k, n, 12),
            wrapped_configs=wrapped,
        )
        print(f"phase kernels: K5 at 12 bits vs plain at {label} D={d12} M={m} K={k} N={n}: "
              f"outputs == (sums modulo 2^32; {wrapped} of {d12} configs' exact sums leave "
              f"int32), {w_rec['splits']} block(s) a config: {w_rec['ms']:.4f} ms (plain "
              f"{w_rec['plain_ms']:.4f}; bound {w_rec['bound'][0]:.4g} by "
              f"{w_rec['bound_term']}); yardstick {fmt_ms(w_rec['library_ms'])}: "
              f"{w_rec['library_reason']}", flush=True)
        if label == "mnist":
            rec["K5W"] = w_rec
        rec["K5W"].setdefault("shapes", {})[label] = {
            key: w_rec[key] for key in ("ms", "plain_ms", "library_ms", "splits",
                                        "bound_term", "wrapped_configs")} | {
                                            "bound_ms": w_rec["bound"][0],
                                            "bound_by": w_rec["bound"][1]}
    err["K5W"] = 0.0

    # K6 at granite-3-2b's AxO projections, rank 8: decode (M=4) against the
    # five weight shapes, and the prefill's M = 4 x 128 against gate/up; the
    # two routes' boundary (M=16 GEMV, M=17 tensor cores); and a random 36-bit
    # config, whose factor part dominates the product.  The bound: the larger
    # of the bytes (codes, tables, output) and the three-pass TF32 work,
    # (1 + 3R) 2MNK at the TF32 tensor-core rate, the cheapest route to the
    # 1e-5 contract on this card; the f32-pipe count, 2MNK(1+R), beside it
    op = serve.demo_operator(AXO_RANK)
    op36 = AxOOperator.from_config(
        np.random.default_rng(36).integers(0, 2, 36).astype(np.uint8), rank=AXO_RANK)
    tabs = {name: tuple(torch.from_numpy(np.ascontiguousarray(t, np.float32)).to(dev)
                        for t in (o.f_table, o.g_table, o.signed_vals))
            for name, o in (("demo", op), ("random36", op36))}
    f_t, g_t, sv_t = tabs["demo"]
    r1 = AXO_RANK + 1
    gen = torch.Generator(device=dev).manual_seed(6)
    k6_shapes = {"q/o decode": (4, 2048, 2048), "k/v decode": (4, 2048, 512),
                 "gate/up decode": (4, 2048, 8192), "down decode": (4, 8192, 2048),
                 "head decode": (4, 2048, 49155), "gate/up prefill": (512, 2048, 8192),
                 "mamba2 head": (8, 768, 50280), "M=16 boundary": (16, 2048, 2048),
                 "M=17 boundary": (17, 2048, 2048),
                 "gate/up decode, random36": (4, 2048, 8192),
                 "gate/up prefill, random36": (512, 2048, 8192)}
    for label, (m, k, n) in k6_shapes.items():
        f_t, g_t, sv_t = tabs["random36" if "random36" in label else "demo"]
        a = torch.randint(0, 256, (m, k), generator=gen, device=dev, dtype=torch.uint8)
        bb = torch.randint(0, 256, (k, n), generator=gen, device=dev, dtype=torch.uint8)
        got = axo_matmul.axo_matmul(a, bb, f_t, g_t, sv_t)
        want = axo_matmul.axo_matmul_plain(a, bb, f_t, g_t, sv_t)
        torch.cuda.synchronize()
        rel = rel_norm(got, want)
        if not (torch.isfinite(got).all() and rel <= REL_RTOL):
            raise AssertionError(f"K6 differs from its plain version at {label}: rel {rel:.3g}")
        # the library yardstick: one f32 GEMM over [A|F_1..F_R] . [B;G_1..G_R]
        al, ac = a.long(), bb.long()
        a_cat = torch.cat([sv_t[al]] + [f_t[:, r][al] for r in range(AXO_RANK)], 1)
        b_cat = torch.cat([sv_t[ac]] + [g_t[:, r][ac] for r in range(AXO_RANK)], 0)
        k6_bytes = m * k + k * n + m * n * 4 + 2 * r1 * 256 * 4
        k6_rec = dict(
            name="axo_matmul", source="src/repro_torch/kernels/csrc/axo_matmul.cu",
            replaces="src/repro/kernels/axo_matmul_kernel.py:80",
            ms=cuda_ms(torch, lambda: axo_matmul.axo_matmul(a, bb, f_t, g_t, sv_t), 10),
            plain_ms=cuda_ms(torch, lambda: axo_matmul.axo_matmul_plain(
                a, bb, f_t, g_t, sv_t), 3),
            library_ms=cuda_ms(torch, lambda: a_cat @ b_cat, 10),
            bound=bound(k6_bytes, 0, 0, int_rate,
                        tf32_ops=2.0 * m * n * k * (1 + 3 * AXO_RANK)),
        )
        f32_bound = bound(k6_bytes, 0, 2.0 * m * n * k * r1, int_rate, f32_rate=f32_rate)
        del a_cat, b_cat
        pl = axo_matmul.plan(m, n, k, AXO_RANK, 256)
        was = K6_PR13_MS.get(label)
        print(f"phase kernels: K6 vs plain at {label} M={m} K={k} N={n} R={AXO_RANK} "
              f"({pl.route} route, {pl.splits} splits of {pl.k_split}): rel norm "
              f"{rel:.3g} (limit {REL_RTOL}), max abs err "
              f"{float((got - want).abs().max()):.4g}; K6 {k6_rec['ms']:.4f} ms (PR 13 design "
              f"{fmt_ms(was)}; plain {k6_rec['plain_ms']:.4f}; bound "
              f"{k6_rec['bound'][0]:.4g} by {k6_rec['bound'][1]}, three-pass TF32 or bytes; "
              f"f32-pipe bound {f32_bound[0]:.4g} by {f32_bound[1]}), one cuBLAS f32 GEMM at "
              f"K(1+R) {k6_rec['library_ms']:.4f} ms", flush=True)
        if label == "gate/up prefill":   # the path's heaviest K6 call
            rec["K6"], err["K6"] = k6_rec, float((got - want).abs().max())

    # K7 at the serve prefill: B=4, H=32, G=8, hd=64, S=128 over the 144-slot
    # cache (kv_len 128), and a ragged S=77; bf16 as served, f32 beside it
    for label, (s_q, cap) in {"serve prefill": (128, 144), "ragged": (77, 93)}.items():
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn((4, 32, s_q, 64), generator=gen, device=dev).to(dtype)
            kk, vv = (torch.randn((4, 8, cap, 64), generator=gen, device=dev).to(dtype)
                      for _ in range(2))
            got = flash_attention.flash_attention(q, kk, vv, kv_len=s_q)
            want = flash_attention.flash_attention_plain(q, kk, vv, kv_len=s_q)
            torch.cuda.synchronize()
            # both round one f32 result: f32 to 2e-6, bf16 to one bf16 ulp (2^-7),
            # of the output's largest magnitude
            tol = (2e-6 if dtype == torch.float32 else 2.0 ** -7) * float(
                want.float().abs().max())
            e = float((got.float() - want.float()).abs().max())
            if not (torch.isfinite(got.float()).all() and e <= tol):
                raise AssertionError(f"K7 differs from its plain version at {label} {dtype}: "
                                     f"{e:.3g} > {tol:.3g}")
            msg = f"phase kernels: K7 vs plain at {label} S={s_q} cache {cap} {dtype}: " \
                  f"max abs err {e:.3g} (limit {tol:.3g})"
            if dtype == torch.bfloat16:
                k_rep = kk[:, :, :s_q].repeat_interleave(4, dim=1)
                v_rep = vv[:, :, :s_q].repeat_interleave(4, dim=1)
                pairs = s_q * (s_q + 1) // 2
                k7_rec = dict(
                    name="flash_attention",
                    source="src/repro_torch/kernels/csrc/flash_attention.cu",
                    replaces="src/repro/kernels/flash_attention_kernel.py:87",
                    ms=cuda_ms(torch, lambda: flash_attention.flash_attention(
                        q, kk, vv, kv_len=s_q), 50),
                    plain_ms=cuda_ms(torch, lambda: flash_attention.flash_attention_plain(
                        q, kk, vv, kv_len=s_q), 10),
                    library_ms=cuda_ms(torch, lambda: torch.nn.functional.
                                       scaled_dot_product_attention(
                                           q, k_rep, v_rep, is_causal=True), 50),
                    bound=bound(2 * (2 * q.numel() + 2 * 4 * 8 * s_q * 64), 0, 0, int_rate,
                                bf16_ops=4.0 * 4 * 32 * pairs * 64),
                )
                msg += (f"; K7 {k7_rec['ms']:.4f} ms (PR 13 design {K7_PR13_MS[label]:.4f}; "
                        f"plain {k7_rec['plain_ms']:.4f}, bound {k7_rec['bound'][0]:.4g} by "
                        f"{k7_rec['bound'][1]}), SDPA {k7_rec['library_ms']:.4f} ms")
                if label == "serve prefill":
                    rec["K7"], err["K7"] = k7_rec, e
            print(msg, flush=True)
    # K7 at head widths 128 and 112: the prefill of each new arch (B=4, S=128
    # over a 136-slot cache, kv_len 128) with its own heads and KV groups;
    # bf16 as served, timed beside SDPA (K/V repeated to the query heads) and
    # the bound, f32 beside it (held, not timed)
    for label, (h_q, g_kv, hd) in K7_WIDE.items():
        key = "K7W" if hd == 128 else "K7X"
        s_q, cap = PROMPT_LEN, PROMPT_LEN + GEN_TOKENS
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn((4, h_q, s_q, hd), generator=gen, device=dev).to(dtype)
            kk, vv = (torch.randn((4, g_kv, cap, hd), generator=gen, device=dev).to(dtype)
                      for _ in range(2))
            got = flash_attention.flash_attention(q, kk, vv, kv_len=s_q)
            want = flash_attention.flash_attention_plain(q, kk, vv, kv_len=s_q)
            torch.cuda.synchronize()
            tol = (2e-6 if dtype == torch.float32 else 2.0 ** -7) * float(
                want.float().abs().max())
            e = float((got.float() - want.float()).abs().max())
            if not (torch.isfinite(got.float()).all() and e <= tol):
                raise AssertionError(f"K7 differs from its plain version at {label} hd {hd} "
                                     f"{dtype}: {e:.3g} > {tol:.3g}")
            msg = (f"phase kernels: K7 vs plain at {label}'s prefill B=4 H={h_q} G={g_kv} "
                   f"hd={hd} S={s_q} cache {cap} {dtype}: max abs err {e:.3g} (limit {tol:.3g})")
            if dtype == torch.bfloat16:
                k_rep = kk[:, :, :s_q].repeat_interleave(h_q // g_kv, dim=1)
                v_rep = vv[:, :, :s_q].repeat_interleave(h_q // g_kv, dim=1)
                pairs = s_q * (s_q + 1) // 2
                w_rec = dict(
                    name=f"flash_attention_hd{hd}",
                    source="src/repro_torch/kernels/csrc/flash_attention.cu",
                    replaces="src/repro/kernels/flash_attention_kernel.py:87",
                    ms=cuda_ms(torch, lambda: flash_attention.flash_attention(
                        q, kk, vv, kv_len=s_q), 50),
                    plain_ms=cuda_ms(torch, lambda: flash_attention.flash_attention_plain(
                        q, kk, vv, kv_len=s_q), 10),
                    library_ms=cuda_ms(torch, lambda: torch.nn.functional.
                                       scaled_dot_product_attention(
                                           q, k_rep, v_rep, is_causal=True), 50),
                    bound=bound(2 * (2 * q.numel() + 2 * 4 * g_kv * s_q * hd), 0, 0, int_rate,
                                bf16_ops=4.0 * 4 * h_q * pairs * hd),
                )
                msg += (f"; K7 {w_rec['ms']:.4f} ms (plain {w_rec['plain_ms']:.4f}, bound "
                        f"{w_rec['bound'][0]:.4g} by {w_rec['bound'][1]}), SDPA "
                        f"{w_rec['library_ms']:.4f} ms")
                if key not in rec:
                    rec[key], err[key] = w_rec, e
                rec[key].setdefault("shapes", {})[label] = {
                    "ms": w_rec["ms"], "plain_ms": w_rec["plain_ms"],
                    "library_ms": w_rec["library_ms"], "bound_ms": w_rec["bound"][0],
                    "bound_by": w_rec["bound"][1], "max_abs_err": e}
                err[key] = max(err[key], e)
            print(msg, flush=True)
            del q, kk, vv, got, want
    # K6 at K6_NEW's shapes: kimi-k2's expert buffers, deepseek-67b's gate/up
    # prefill (the heaviest K6 call of serve-dense), jamba's and deepseek-v3's
    # prefill expert buffers and the cross K/V of whisper and the VLM; each
    # beside one cuBLAS f32 GEMM over [A|F_1..F_R] . [B;G_1..G_R] and its bound,
    # as above
    f_t, g_t, sv_t = tabs["demo"]
    for label, (m, k, n, key, filled) in K6_NEW.items():
        a = torch.randint(0, 256, (m, k), generator=gen, device=dev, dtype=torch.uint8)
        a[filled:] = 0
        bb = torch.randint(0, 256, (k, n), generator=gen, device=dev, dtype=torch.uint8)
        got = axo_matmul.axo_matmul(a, bb, f_t, g_t, sv_t)
        want = axo_matmul.axo_matmul_plain(a, bb, f_t, g_t, sv_t)
        torch.cuda.synchronize()
        rel = rel_norm(got, want)
        if not (torch.isfinite(got).all() and rel <= REL_RTOL):
            raise AssertionError(f"K6 differs from its plain version at {label}: rel {rel:.3g}")
        al, ac = a.long(), bb.long()
        a_cat = torch.cat([sv_t[al]] + [f_t[:, r][al] for r in range(AXO_RANK)], 1)
        b_cat = torch.cat([sv_t[ac]] + [g_t[:, r][ac] for r in range(AXO_RANK)], 0)
        del al, ac
        n_rec = dict(
            name=K6_RECORDS[key],
            source="src/repro_torch/kernels/csrc/axo_matmul.cu",
            replaces="src/repro/kernels/axo_matmul_kernel.py:80",
            ms=cuda_ms(torch, lambda: axo_matmul.axo_matmul(a, bb, f_t, g_t, sv_t), 20),
            plain_ms=cuda_ms(torch, lambda: axo_matmul.axo_matmul_plain(
                a, bb, f_t, g_t, sv_t), 3),
            library_ms=cuda_ms(torch, lambda: a_cat @ b_cat, 20),
            bound=bound(m * k + k * n + m * n * 4 + 2 * r1 * 256 * 4, 0, 0, int_rate,
                        tf32_ops=2.0 * m * n * k * (1 + 3 * AXO_RANK)),
        )
        del a_cat, b_cat
        pl = axo_matmul.plan(m, n, k, AXO_RANK, 256)
        e = float((got - want).abs().max())
        print(f"phase kernels: K6 vs plain at {label} M={m} K={k} N={n} R={AXO_RANK} "
              f"({pl.route} route, {pl.splits} splits of {pl.k_split}): rel norm {rel:.3g} "
              f"(limit {REL_RTOL}); K6 {n_rec['ms']:.4f} ms (plain {n_rec['plain_ms']:.4f}; "
              f"bound {n_rec['bound'][0]:.4g} by {n_rec['bound'][1]}), one cuBLAS f32 GEMM "
              f"at K(1+R) {n_rec['library_ms']:.4f} ms ({n_rec['ms'] / n_rec['library_ms']:.2f}x "
              f"its time)", flush=True)
        if key not in rec:
            rec[key], err[key] = n_rec, e
        rec[key].setdefault("shapes", {})[label] = {
            "ms": n_rec["ms"], "plain_ms": n_rec["plain_ms"],
            "library_ms": n_rec["library_ms"], "bound_ms": n_rec["bound"][0],
            "bound_by": n_rec["bound"][1], "route": pl.route, "splits": pl.splits}
        err[key] = max(err[key], e)
        del a, bb, got, want
    # K7 non-causal, at Sq != Skv and Skv off the 64-key tile: whisper's encoder
    # (1,500 frames) and cross-attention (Sq 128 x Skv 1,500, hd 64) and the
    # VLM's gated cross-attention (128 x 1,600, hd 128, H 64 / G 8), B=4; bf16
    # as served, timed beside SDPA (K/V repeated to the query heads,
    # is_causal=False) and the bound; f32 beside it, held and not timed
    for label, (h_q, g_kv, s_q, s_kv, hd) in K7_NC.items():
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn((4, h_q, s_q, hd), generator=gen, device=dev).to(dtype)
            kk, vv = (torch.randn((4, g_kv, s_kv, hd), generator=gen, device=dev).to(dtype)
                      for _ in range(2))
            got = flash_attention.flash_attention(q, kk, vv, causal=False)
            want = flash_attention.flash_attention_plain(q, kk, vv, causal=False).float()
            torch.cuda.synchronize()
            # bf16: one ulp of the output's scale; f32: 2e-6 of the terms summed
            # (the largest softmax-weighted sum of |v|), since over 1,500 keys
            # the output itself cancels to a fraction of them
            tol = (2e-6 * float(flash_attention.flash_attention_plain(
                q, kk, vv.abs(), causal=False).abs().max()) if dtype == torch.float32
                else 2.0 ** -7 * float(want.abs().max()))
            e = float((got.float() - want).abs().max())
            if not (torch.isfinite(got.float()).all() and e <= tol):
                raise AssertionError(f"K7 non-causal differs from its plain version at {label} "
                                     f"{dtype}: {e:.3g} > {tol:.3g}")
            msg = (f"phase kernels: K7 non-causal vs plain at {label} B=4 H={h_q} G={g_kv} "
                   f"Sq={s_q} Skv={s_kv} hd={hd} {dtype}: max abs err {e:.3g} (limit {tol:.3g})")
            if dtype == torch.bfloat16:
                k_rep = kk.repeat_interleave(h_q // g_kv, dim=1)
                v_rep = vv.repeat_interleave(h_q // g_kv, dim=1)
                nc_rec = dict(
                    name="flash_attention_non_causal",
                    source="src/repro_torch/kernels/csrc/flash_attention.cu",
                    replaces="src/repro/kernels/flash_attention_kernel.py:87",
                    ms=cuda_ms(torch, lambda: flash_attention.flash_attention(
                        q, kk, vv, causal=False), 50),
                    plain_ms=cuda_ms(torch, lambda: flash_attention.flash_attention_plain(
                        q, kk, vv, causal=False), 5),
                    library_ms=cuda_ms(torch, lambda: torch.nn.functional.
                                       scaled_dot_product_attention(q, k_rep, v_rep), 50),
                    bound=bound(2 * (2 * q.numel() + 2 * kk.numel()), 0, 0, int_rate,
                                bf16_ops=4.0 * 4 * h_q * s_q * s_kv * hd),
                )
                msg += (f"; K7 {nc_rec['ms']:.4f} ms (plain {nc_rec['plain_ms']:.4f}, bound "
                        f"{nc_rec['bound'][0]:.4g} by {nc_rec['bound'][1]}), SDPA "
                        f"{nc_rec['library_ms']:.4f} ms ({nc_rec['ms'] / nc_rec['library_ms']:.2f}x"
                        f" its time)")
                if "K7N" not in rec:
                    rec["K7N"], err["K7N"] = nc_rec, e
                rec["K7N"].setdefault("shapes", {})[label] = {
                    "ms": nc_rec["ms"], "plain_ms": nc_rec["plain_ms"],
                    "library_ms": nc_rec["library_ms"], "bound_ms": nc_rec["bound"][0],
                    "bound_by": nc_rec["bound"][1], "max_abs_err": e}
                err["K7N"] = max(err["K7N"], e)
                del k_rep, v_rep
            print(msg, flush=True)
            del q, kk, vv, got, want
    # K8 at mamba2-130m's prefill scan, the reduced config's, and a grouped shape
    # with an entering state; bf16 as served, f32 beside it.  Both versions
    # compute in f32 over other chunk lengths and round y once: y in f32 to
    # 1e-5 and in bf16 to one bf16 ulp (2^-7) of the output's largest
    # magnitude, the f32 state to REL_RTOL relative norm
    k8_shapes = {"mamba2 prefill": SSM_SHAPE, "reduced": (2, 40, 16, 1, 8, 16),
                 "grouped": (2, 300, 16, 4, 64, 64), "jamba prefill": JAMBA_SSM_SHAPE}
    for label, shape in k8_shapes.items():
        for dtype in (torch.bfloat16, torch.float32):
            x, dt, a, bm, cm = ssd_inputs(torch, shape, dtype, gen)
            b_, _, h_, g_, p_, n_ = shape
            init = (torch.randn((b_, h_, p_, n_), generator=gen, device=dev) if g_ > 1
                    else None)
            y, st = ssd_scan.ssd_scan(x, dt, a, bm, cm, init_state=init)
            y_p, st_p = ssd_scan.ssd_scan_plain(x, dt, a, bm, cm, init_state=init)
            torch.cuda.synchronize()
            tol = (1e-5 if dtype == torch.float32 else 2.0 ** -7) * float(
                y_p.float().abs().max())
            e = float((y.float() - y_p.float()).abs().max())
            rs = rel_norm(st, st_p)
            if not (torch.isfinite(y.float()).all() and e <= tol and rs <= REL_RTOL):
                raise AssertionError(f"K8 differs from its plain version at {label} {dtype}: "
                                     f"y {e:.3g} > {tol:.3g} or state rel {rs:.3g}")
            msg = (f"phase kernels: K8 vs plain at {label} (B, S, H, G, P, N) = {shape} "
                   f"{dtype}{' with an entering state' if init is not None else ''} "
                   f"({ssd_scan.route(x)} design): y max abs err {e:.3g} (limit "
                   f"{tol:.3g}), state rel norm {rs:.3g} (limit {REL_RTOL})")
            if label == "mamba2 prefill" and dtype == torch.bfloat16:
                # the bound: bytes against the least tensor-core work that holds
                # K8's contracts (two bf16 passes); the route's three passes and
                # the same algebra on the f32 pipe printed beside it
                moved, ops, tc_ops = ssd_work(shape, 2, passes=2)
                tc3_ops = ssd_work(shape, 2, passes=3)[2]
                k8_rec = dict(
                    name="ssd_scan", source="src/repro_torch/kernels/csrc/ssd_scan.cu",
                    replaces="src/repro/kernels/ssd_scan_kernel.py:78",
                    ms=cuda_ms(torch, lambda: ssd_scan.ssd_scan(x, dt, a, bm, cm), 20),
                    # the first design on the same inputs, in this call
                    old_ms=cuda_ms(torch, lambda: ssd_scan.ssd_scan_scalar(x, dt, a, bm, cm), 20),
                    plain_ms=cuda_ms(torch, lambda: ssd_scan.ssd_scan_plain(
                        x, dt, a, bm, cm), 3),
                    library_ms=None,
                    bound=bound(moved, 0, 0, int_rate, bf16_ops=tc_ops),
                )
                tc3_ms = bound(0, 0, 0, int_rate, bf16_ops=tc3_ops)[0]
                f32_ms = bound(0, 0, ops, int_rate, f32_rate=f32_rate)[0]
                msg += (f"; K8 {k8_rec['ms']:.4f} ms (first design {k8_rec['old_ms']:.4f}; plain "
                        f"{k8_rec['plain_ms']:.4f}; bound {k8_rec['bound'][0]:.4g} by "
                        f"{k8_rec['bound'][1]}: {moved / 1e6:.4g} MB, {tc_ops / 1e9:.4g} GFLOP of "
                        f"two bf16 tensor-core passes; the route's three passes "
                        f"{tc3_ops / 1e9:.4g} GFLOP, {tc3_ms:.4g} ms; on the f32 pipe "
                        f"{ops / 1e9:.4g} GFLOP, {f32_ms:.4g} ms); no PyTorch call computes "
                        f"the scan")
                rec["K8"], err["K8"] = k8_rec, e
            if label == "jamba prefill" and dtype == torch.bfloat16:
                # jamba's mamba layers: 128 heads of 64 over a 128-token prompt
                moved, _, tc_ops = ssd_work(shape, 2, passes=2)
                h_rec = dict(
                    name="ssd_scan_hybrid", source="src/repro_torch/kernels/csrc/ssd_scan.cu",
                    replaces="src/repro/kernels/ssd_scan_kernel.py:78",
                    ms=cuda_ms(torch, lambda: ssd_scan.ssd_scan(x, dt, a, bm, cm), 50),
                    plain_ms=cuda_ms(torch, lambda: ssd_scan.ssd_scan_plain(
                        x, dt, a, bm, cm), 5),
                    library_ms=None,
                    bound=bound(moved, 0, 0, int_rate, bf16_ops=tc_ops),
                )
                msg += (f"; K8 {h_rec['ms']:.4f} ms (plain {h_rec['plain_ms']:.4f}; bound "
                        f"{h_rec['bound'][0]:.4g} by {h_rec['bound'][1]})")
                rec["K8H"], err["K8H"] = h_rec, e
            print(msg, flush=True)
            del x, dt, a, bm, cm, y, y_p
    for k, r in rec.items():
        was = f", earlier design {r['old_ms']:.4f} ms" if "old_ms" in r else ""
        print(f"phase kernels: {k} {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} "
              f"ms, bound {r['bound'][0]:.4g} ms by {r.get('bound_term', r['bound'][1])}{was})",
              flush=True)

    # -- 4. main path -------------------------------------------------------
    segments["main"] = time.perf_counter()
    ctx = ExecutionContext()                           # the card, K1 + K3
    ctx_entry = ExecutionContext(kernel_impl="entry")  # the card, K2 + K3
    wrappers = {"K1": char_kernels.behav_stats_table, "K2": char_kernels.behav_stats_entry,
                "K3": moo_kernels.constraint_fronts}
    for fn in wrappers.values():
        fn.launches = 0
    moo_kernels.dominance_counts.launches = 0
    # the GA's rankings, counted where it looks the function up
    rankings = {"calls": 0}
    constraint_ranks = fastmoo.constraint_ranks

    def counted_ranks(*args, **kw):
        rankings["calls"] += 1
        return constraint_ranks(*args, **kw)

    fastmoo.constraint_ranks = counted_ranks
    # K2's inputs on the path, kept where fastchar looks the wrapper up (its
    # count stays the wrapper's own)
    k2_calls = []
    k2_entry = fastchar.behav_stats_entry

    def recorded_k2(*args):
        k2_calls.append(args)   # (masks, n_bits, a_tile), and configs a thread where tuned
        return k2_entry(*args)

    fastchar.behav_stats_entry = recorded_k2
    # K1's likewise: (small, exact, w, a_tile)
    k1_calls = []
    k1_table = fastchar.behav_stats_table

    def recorded_k1(*args):
        k1_calls.append(args)
        return k1_table(*args)

    fastchar.behav_stats_table = recorded_k1
    t0 = time.perf_counter()
    train = build_training_dataset(spec, n_random=2000, seed=0, backend=ctx)
    t_char = time.perf_counter() - t0
    print(f"phase main: training set {len(train)} configs characterized on the card in "
          f"{t_char:.2f} s (K1 launches {wrappers['K1'].launches})", flush=True)
    settings = DSESettings(const_sf=0.5, pop_size=64, n_gen=100, context=ctx)
    t0 = time.perf_counter()
    pool = map_solution_pool(spec, train, settings)
    ref = hv_reference(train, settings)
    print(f"phase main: MaP pool {len(pool)} configs in {time.perf_counter() - t0:.2f} s, "
          f"hv reference {ref.tolist()}", flush=True)
    results = {}
    # map+ga runs twice: untuned ("off"), then, after the obs phase's search of
    # the path's buckets, on a context with telemetry on (the GA's tap) and
    # tuning "cached" -- the main path's map+ga, held to the same contracts.
    # Before it the training set is characterized again on K1's menu under
    # the same policy: K1 at its tuned tiles, on the path's chunks
    ctx_obs = ExecutionContext(kernel_impl="entry", telemetry="on", tuning="cached")
    ctx_obs_k1 = ExecutionContext(telemetry="on", tuning="cached")
    for method in ("ga", "map", "map+ga (off)", "map+ga"):
        if method == "map+ga":
            k2_tuned_from = len(k2_calls)
            # characterize launches K1 on chunks of 256 configs (its last, 212
            # here, falls in the same bucket); K2 validates map+ga's front
            t_obs = obs_tune(torch, tuning, registry, obs, [
                ("fastchar.table", dict(n_bits=8, d=k1_calls[0][0].shape[1])),
                ("fastchar.entry", dict(n_bits=8, d=k2_calls[0][0].shape[0])),
                *(("axo_matmul.kernel", dict(m=m, k=k, n=n, rank=AXO_RANK))
                  for m, k, n in K6_TUNE)], counted=wrappers.values())
            searches0 = tuning.STATS["searches"]
            k1_tuned_from = len(k1_calls)
            train_tuned = build_training_dataset(spec, n_random=2000, seed=0,
                                                 backend=ctx_obs_k1)
            for key in ("AVG_ABS_ERR", "PROB_ERR", "MAX_ABS_ERR", "MSE"):
                np.testing.assert_array_equal(train_tuned.metrics[key], train.metrics[key],
                                              err_msg=f"the tuned training set's {key}")
            np.testing.assert_allclose(train_tuned.metrics[BEHAV_KEY],
                                       train.metrics[BEHAV_KEY], rtol=REL_RTOL)
            print(f"phase obs: the training set characterized again on 'cached' tiles: "
                  f"{len(k1_calls) - k1_tuned_from} K1 launches at a_tile "
                  f"{sorted({c[3] for c in k1_calls[k1_tuned_from:]})} (untuned "
                  f"{sorted({c[3] for c in k1_calls[:k1_tuned_from]})}); 4 metrics == the "
                  f"untuned set's, {BEHAV_KEY} rtol {REL_RTOL}", flush=True)
        st = settings if method in ("ga", "map") else DSESettings(
            const_sf=0.5, pop_size=64, n_gen=100,
            context=ctx_obs if method == "map+ga" else ctx_entry)
        r = run_dse(spec, train, method.split()[0], settings=st, map_pool=pool, ref=ref)
        results[method] = r
        print(f"phase main: {method} hv_ppf {r.hv_ppf!r} hv_vpf {r.hv_vpf!r} n_evals "
              f"{r.n_evals} vpf {len(r.vpf_configs)} timings "
              f"{ {k: round(v, 3) for k, v in r.timings.items()} } launches since start "
              f"K1 {wrappers['K1'].launches} K2 {wrappers['K2'].launches} "
              f"K3 {wrappers['K3'].launches}", flush=True)
    torch.cuda.synchronize()
    # the obs phase's checks of the tuned, tapped map+ga against the untuned one
    t_chk = time.perf_counter()
    obs_tel = ctx_obs.telemetry
    gen_rows = obs_tel.series.get("fastmoo.gen", [])
    gen_hv = [float(row["hv"]) for row in gen_rows]
    tuned, off = results["map+ga"], results["map+ga (off)"]
    print(f"phase obs: map+ga on telemetry 'on', tuning 'cached': searches during the run "
          f"{tuning.STATS['searches'] - searches0}, cache hits {tuning.STATS['cache_hits']}; "
          f"fastmoo.gen rows {len(gen_rows)} (gens {int(gen_rows[0]['gen'])}.."
          f"{int(gen_rows[-1]['gen'])}), hv {gen_hv[0]!r} -> {gen_hv[-1]!r} (hv_history "
          f"{tuned.hv_history[-1][1]!r}), front {int(gen_rows[-1]['front'])} of capacity "
          f"{4 * 64}, archive feasible {int(gen_rows[-1]['arc_feasible'])}; tap.fastmoo.gen "
          f"{obs_tel.counter('tap.fastmoo.gen')}, dispatch counters "
          f"{ {k: v for k, v in obs_tel.counters.items() if k.startswith('dispatch.')} }; "
          f"hv_history tapped == untapped: {tuned.hv_history == off.hv_history}; front "
          f"equal to the 'off' run's: {np.array_equal(tuned.vpf_configs, off.vpf_configs)}",
          flush=True)
    if tuning.STATS["searches"] != searches0:
        raise AssertionError("the cached map+ga searched: a bucket of its path was not tuned")
    if [int(row["gen"]) for row in gen_rows] != list(range(100)):
        raise AssertionError(f"fastmoo.gen holds {len(gen_rows)} rows, not one a generation")
    if any(b < a for a, b in zip(gen_hv, gen_hv[1:])):
        raise AssertionError("the per-generation hypervolume decreased")
    if not np.isclose(gen_hv[-1], tuned.hv_history[-1][1], rtol=1e-6):
        raise AssertionError("the last tapped hv differs from hv_history's")
    if tuned.hv_history != off.hv_history:
        raise AssertionError("hv_history differs between the tapped and the untapped GA")
    np.testing.assert_array_equal(tuned.vpf_configs, off.vpf_configs,
                                  err_msg="the tuned map+ga's front differs from 'off's")
    np.testing.assert_allclose(tuned.vpf_objs, off.vpf_objs, rtol=REL_RTOL)
    t_obs += time.perf_counter() - t_chk
    launches = {k: fn.launches for k, fn in wrappers.items()}
    t_main = time.perf_counter() - t0 + t_char - t_obs
    fastmoo.constraint_ranks = constraint_ranks
    fastchar.behav_stats_entry = k2_entry
    fastchar.behav_stats_table = k1_table
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    # K2 at its path launch (the validation of the tuned map+ga's front, at
    # its tuned tiles, on its own masks): held to the plain version and timed,
    # both designs, after the path's counts were read; the untuned run's
    # launch beside it
    k2_path, k2_untuned = k2_calls[k2_tuned_from], k2_calls[0]
    k2_masks, k2_bits, k2_tile = k2_path[:3]
    k2_d = k2_masks.shape[0]
    k2_cfgs = (k2_path[3] if len(k2_path) > 3
               else char_kernels.entry_configs(k2_d, k2_bits, k2_tile, n_sms))
    ik, rk = char_kernels.behav_stats_entry(*k2_path)
    ip, rp = char_kernels.behav_stats_entry_plain(*k2_path[:3])
    torch.cuda.synchronize()
    if not torch.equal(ik, ip):
        raise AssertionError("K2 at its tuned path launch: int channels differ from plain")
    torch.testing.assert_close(rk, rp, rtol=REL_RTOL, atol=0)
    rec["K2"]["path"] = {
        "d": k2_d, "calls": len(k2_calls) - k2_tuned_from, "a_tile": k2_tile,
        "configs_a_thread": k2_cfgs, "max_abs_err": float((rk - rp).abs().max()),
        "ms": cuda_ms(torch, lambda: char_kernels.behav_stats_entry(*k2_path), 50),
        "plain_ms": cuda_ms(torch, lambda: char_kernels.behav_stats_entry_plain(
            *k2_path[:3]), 5),
        "old_ms": cuda_ms(torch, lambda: char_kernels.behav_stats_entry_first(*k2_path[:3]), 50),
        "tiers_ms": k2_tiers(k2_path[:3]),
        "bound_ms": k2_bound(k2_d)[0],
        "untuned": {"a_tile": k2_untuned[2], "configs_a_thread": char_kernels.entry_configs(
                        k2_d, k2_bits, k2_untuned[2], n_sms),
                    "ms": cuda_ms(torch, lambda: char_kernels.behav_stats_entry(*k2_untuned),
                                  50)}}
    # K1 likewise at its first tuned launch: the training set's first chunk
    k1_path, k1_untuned = k1_calls[k1_tuned_from], k1_calls[0]
    k1_small, k1_tile = k1_path[0], k1_path[3]
    k1_d = k1_small.shape[1]
    ik, rk = char_kernels.behav_stats_table(*k1_path)
    ip, rp = char_kernels.behav_stats_table_plain(*k1_path)
    torch.cuda.synchronize()
    if not torch.equal(ik, ip):
        raise AssertionError("K1 at its tuned path launch: int channels differ from plain")
    torch.testing.assert_close(rk, rp, rtol=REL_RTOL, atol=0)
    rec["K1"]["path"] = {
        "d": k1_d, "calls": len(k1_calls) - k1_tuned_from, "a_tile": k1_tile,
        "max_abs_err": float((rk - rp).abs().max()),
        "ms": cuda_ms(torch, lambda: char_kernels.behav_stats_table(*k1_path), 50),
        "plain_ms": cuda_ms(torch, lambda: char_kernels.behav_stats_table_plain(*k1_path), 5),
        "old_ms": cuda_ms(torch, lambda: char_kernels.behav_stats_table_first(*k1_path), 50),
        "bound_ms": bound(k1_small.numel() * 4 + 2 * b_n * b_n * 4
                          + 2 * (b_n // k1_tile) * k1_d * 8 * 4,
                          k1_d * b_n * b_n * K1_PAIR_OPS, 0, issue_rate)[0],
        "untuned": {"a_tile": k1_untuned[3],
                    "ms": cuda_ms(torch, lambda: char_kernels.behav_stats_table(*k1_untuned),
                                  50)}}
    k1p = rec["K1"]["path"]
    print(f"phase main: K1's path launch (the training set on 'cached' tiles, {k1p['calls']} "
          f"call(s)): D={k1_d} configs, a_tile {k1_tile}: int channels == plain, f32 max abs "
          f"err {k1p['max_abs_err']:.3g} (rtol {REL_RTOL}); {k1p['ms']:.4f} ms (plain "
          f"{k1p['plain_ms']:.4f}; first design {k1p['old_ms']:.4f}, bound "
          f"{k1p['bound_ms']:.4g}); the untuned launch at a_tile {k1p['untuned']['a_tile']}: "
          f"{k1p['untuned']['ms']:.4f} ms", flush=True)
    k2p = rec["K2"]["path"]
    print(f"phase main: K2's path launch (the tuned map+ga's validation, {k2p['calls']} "
          f"call(s)): D={k2_d} configs, a_tile {k2_tile}, {k2_cfgs} configs a thread: int "
          f"channels == plain, f32 max abs err {k2p['max_abs_err']:.3g} (rtol {REL_RTOL}); "
          f"{k2p['ms']:.4f} ms (plain {k2p['plain_ms']:.4f}; tiers 4 / 1 at a_tile "
          f"{k2_tile}: {k2p['tiers_ms'][4]:.4f} / {k2p['tiers_ms'][1]:.4f}; first design "
          f"{k2p['old_ms']:.4f}, bound {k2p['bound_ms']:.4g}); the untuned run's launch at "
          f"a_tile {k2p['untuned']['a_tile']}, {k2p['untuned']['configs_a_thread']} configs "
          f"a thread: {k2p['untuned']['ms']:.4f} ms", flush=True)
    print(f"phase main: {rankings['calls']} GA rankings, K3 constraint_fronts launches "
          f"{launches['K3']}, dominance_counts launches {moo_kernels.dominance_counts.launches}",
          flush=True)
    if launches["K3"] != rankings["calls"]:
        raise AssertionError(f"K3 launched {launches['K3']} times for {rankings['calls']} "
                             f"rankings, expected one launch a ranking")
    for method, r in results.items():
        if not (r.hv_vpf > 0 and np.isfinite(r.vpf_objs).all()):
            raise AssertionError(f"{method}: empty or non-finite validated front")
        fast = behav_metrics(spec, r.vpf_configs, backend=ctx)
        oracle = behav_metrics(spec, r.vpf_configs, backend="numpy")
        for key in ("AVG_ABS_ERR", "PROB_ERR", "MAX_ABS_ERR", "MSE"):
            np.testing.assert_array_equal(fast[key], oracle[key], err_msg=f"{method} {key}")
        np.testing.assert_allclose(fast[BEHAV_KEY], oracle[BEHAV_KEY], rtol=REL_RTOL)
        np.testing.assert_allclose(r.vpf_objs[:, 0], oracle[BEHAV_KEY], rtol=REL_RTOL)
    print(f"phase main: {t_main:.1f} s, launches {launches}; validated fronts' BEHAV == "
          f"numpy backend (4 metrics), AVG_ABS_REL_ERR rtol {REL_RTOL}", flush=True)

    # -- apps: application-targeted DSE ------------------------------------
    segments["apps"] = time.perf_counter()
    apps = [APPLICATIONS[name]() for name in ("ecg", "mnist", "gauss", "ffn")]
    mnist = apps[1]
    app_wrappers = dict(wrappers, K4=app_kernels.table_gemv, K5=app_kernels.entry_gemv)
    for fn in app_wrappers.values():
        fn.launches = 0
    k4_routes_seen = app_kernels.table_gemv.route_launches
    k4_routes_seen.update(dict.fromkeys(k4_routes_seen, 0))
    # K5's inputs on the path, kept by fastapp's view of app_kernels (the
    # wrapper and its count stay the module's own)
    k5_calls = []

    class RecordingAppKernels:
        def __getattr__(self, name):
            return getattr(app_kernels, name)

        def entry_gemv(self, *args):
            k5_calls.append(args)
            return app_kernels.entry_gemv(*args)

    fastapp.app_kernels = RecordingAppKernels()
    t_app0 = time.perf_counter()
    train_app = characterized_dataset_multi(apps, spec, train, backend=ctx)
    t_multi = time.perf_counter() - t_app0
    print(f"phase apps: 4 apps' BEHAV attached to {len(train)} configs on the card in "
          f"{t_multi:.2f} s (K4 launches {app_kernels.table_gemv.launches})", flush=True)
    st_app = DSESettings(behav_key="APP_MNIST", const_sf=0.5, pop_size=64, n_gen=100,
                         context=ctx)
    t0 = time.perf_counter()
    pool_app = map_solution_pool(spec, train_app, st_app)
    ref_app = hv_reference(train_app, st_app)
    print(f"phase apps: APP_MNIST MaP pool {len(pool_app)} configs in "
          f"{time.perf_counter() - t0:.2f} s, hv reference {ref_app.tolist()}", flush=True)
    app_results = {}
    for method in ("ga", "map", "map+ga"):
        st = st_app if method != "map+ga" else DSESettings(
            behav_key="APP_MNIST", const_sf=0.5, pop_size=64, n_gen=100, context=ctx_entry)
        r = run_dse(spec, train_app, method, settings=st, map_pool=pool_app, ref=ref_app,
                    app=mnist)
        app_results[method] = r
        print(f"phase apps: {method} hv_ppf {r.hv_ppf!r} hv_vpf {r.hv_vpf!r} n_evals "
              f"{r.n_evals} vpf {len(r.vpf_configs)} timings "
              f"{ {k: round(v, 3) for k, v in r.timings.items()} } launches since start "
              f"{ {k: fn.launches for k, fn in app_wrappers.items()} }", flush=True)
    torch.cuda.synchronize()
    app_launches = {k: fn.launches for k, fn in app_wrappers.items()}
    k4_by_route = dict(k4_routes_seen)
    t_app = time.perf_counter() - t_app0
    fastapp.app_kernels = app_kernels
    if min(app_launches.values()) <= 0:
        raise AssertionError(f"a kernel of the app path never launched: {app_launches}")
    # K5 at the D of its path launch (the validation of map+ga's front on
    # mnist's head), both designs, after the path's counts were read
    k5_masks, k5_a, k5_b, _ = k5_calls[0]
    k5_d, (k5_m, k5_k), k5_n = k5_masks.shape[0], k5_a.shape, k5_b.shape[1]
    rec["K5"]["path"] = {
        "d": k5_d, "m": k5_m, "k": k5_k, "n": k5_n, "calls": len(k5_calls),
        "splits": app_kernels.entry_splits(k5_d, k5_m, k5_k, k5_n, 8),
        "ms": cuda_ms(torch, lambda: app_kernels.entry_gemv(*k5_calls[0]), 50),
        "old_ms": cuda_ms(torch, lambda: app_kernels.entry_gemv_first(*k5_calls[0]), 50),
        "bound_ms": k5_bound(k5_d, k5_m, k5_k, k5_n)[0]}
    k5p = rec["K5"]["path"]
    print(f"phase apps: K5's path launch (map+ga validation, {k5p['calls']} call(s)): D={k5_d} "
          f"configs, M={k5_m} K={k5_k} N={k5_n}, {k5p['splits']} block(s) a config: "
          f"{k5p['ms']:.4f} ms (first design {k5p['old_ms']:.4f}, bound "
          f"{k5p['bound_ms']:.4g})", flush=True)
    # K4 per 128-config chunk: the mnist head, the ffn GEMM1 and the ecg and
    # gauss convolutions; then one per ga / map validation (mnist's head)
    chunks = -(-len(train) // 128)
    k4_want = 4 * chunks + 2
    if app_launches["K4"] != k4_want:
        raise AssertionError(f"K4 launched {app_launches['K4']} times on the app path, "
                             f"expected {k4_want}")
    # each app shape on the route K4's plan picks for it
    routes_want = dict.fromkeys(k4_by_route, 0)
    for label in ("mnist", "ffn", "ecg conv1d", "gauss conv2d"):
        routes_want[k4_shapes[label][1]] += chunks + 2 * (label == "mnist")
    print(f"phase apps: K4's route by app shape: "
          f"{ {label: k4_shapes[label][1] for label in k4_shapes if label != 'ragged'} }; "
          f"launches by route {k4_by_route} (expected {routes_want})", flush=True)
    if k4_by_route != routes_want:
        raise AssertionError(f"K4's app-path launches by route {k4_by_route}, "
                             f"expected {routes_want}")
    # checks of the app path, after its launch counts and time are read
    pick = np.random.default_rng(2).choice(len(train), 62, replace=False)
    chk = np.concatenate([train.configs[pick], cfgs[-1:], cfgs[-2:-1]])  # + zeros, accurate
    chk_ds = Dataset(configs=chk, metrics={}, source=np.zeros(len(chk), np.uint8))
    fast = characterized_dataset_multi(apps, spec, chk_ds, backend=ctx).metrics
    oracle = characterized_dataset_multi(apps, spec, chk_ds, backend="numpy").metrics
    for app in apps:
        key = app.behav_metric_name()
        np.testing.assert_array_equal(train_app.metrics[key][pick], fast[key][:62])
        if app.name in ("ecg", "mnist"):
            np.testing.assert_array_equal(fast[key], oracle[key], err_msg=key)
        else:
            np.testing.assert_allclose(fast[key], oracle[key], rtol=1e-6, err_msg=key)
    print("phase apps: 64-config subset of the training set's app BEHAV == numpy oracle "
          "(ecg, mnist exactly; gauss, ffn rtol 1e-6)", flush=True)
    for method, r in app_results.items():
        if not (len(r.vpf_configs) > 0 and np.isfinite(r.vpf_objs).all()):
            raise AssertionError(f"app {method}: empty or non-finite validated front")
        np.testing.assert_array_equal(
            r.vpf_objs[:, 0], mnist.behav(spec, r.vpf_configs, backend="numpy"),
            err_msg=f"app {method} APP_MNIST")
        np.testing.assert_array_equal(
            r.vpf_objs[:, 1], ppa_metrics(spec, r.vpf_configs)[PPA_KEY],
            err_msg=f"app {method} {PPA_KEY}")
    print(f"phase apps: {t_app:.1f} s ({t_multi:.2f} s attaching the 4 apps' BEHAV), launches "
          f"{app_launches} (K4 expected {k4_want}); validated fronts' APP_MNIST == numpy "
          f"oracle, {PPA_KEY} == numpy", flush=True)
    launches.update(K4=app_launches["K4"], K5=app_launches["K5"])

    # -- 5. GA hypervolume contract -----------------------------------------
    segments["ga"] = time.perf_counter()
    small_ds = build_training_dataset(spec, n_random=150, seed=0, backend=ctx)
    ests = fit_estimators(
        small_ds.configs.astype(np.float64),
        {BEHAV_KEY: small_ds.metrics[BEHAV_KEY], PPA_KEY: small_ds.metrics[PPA_KEY]},
        n_quad=16, seed=0,
    )
    mb = float(small_ds.metrics[BEHAV_KEY].max())
    mp = float(small_ds.metrics[PPA_KEY].max())
    hv_ref = np.array([1.05 * mb, 1.05 * mp])
    fn = fastchar.compile_surrogate_batch(ests, BEHAV_KEY, PPA_KEY, mb, mp, ctx=ctx)
    ga_problem = (fn.objs_fn, (mb, mp), hv_ref)   # the sync phase's tapped GA
    hv_np, hv_t = [], []
    for seed in GA_SEEDS:
        r_np = nsga2(None, n_bits=spec.n_luts, pop_size=32, n_gen=30, seed=seed,
                     eval_viol_fn=fn, hv_ref=hv_ref, backend="numpy")
        r_t = nsga2(None, n_bits=spec.n_luts, pop_size=32, n_gen=30, seed=seed,
                    backend=ctx, objs_device_fn=fn.objs_fn, max_behav=mb, max_ppa=mp,
                    hv_ref=hv_ref)
        hv_np.append(r_np.hv_history[-1][1])
        hv_t.append(r_t.hv_history[-1][1])
    rel = abs(np.mean(hv_t) - np.mean(hv_np)) / np.mean(hv_np)
    rel0 = abs(hv_t[0] - hv_np[0]) / hv_np[0]
    print(f"phase ga: seeds {list(GA_SEEDS)}: numpy nsga2 hv {hv_np}, device nsga2 hv "
          f"{hv_t}; mean {float(np.mean(hv_np))!r} vs {float(np.mean(hv_t))!r}, rel diff {rel:.3g} "
          f"(limit 0.02); seed-0 rel diff {rel0:.3g} (limit 0.02)", flush=True)
    if not (min(hv_np) > 0 and rel <= 0.02):
        raise AssertionError("device GA mean hypervolume is not within 2% of the numpy GA")
    if not rel0 <= 0.02:
        raise AssertionError("device GA seed-0 hypervolume is not within 2% of the numpy GA")

    # -- wide: sampled 12/16-bit BEHAV, unsigned 8-bit, 12-bit app BEHAV ------
    segments["wide"] = time.perf_counter()
    t_wide0 = time.perf_counter()
    wide_timings = {}
    for n_bits in (12, 16):
        spec_w = spec_for(n_bits)
        g_w = np.random.default_rng(n_bits)
        cfgs_w = np.concatenate([accurate_config(spec_w)[None],
                                 g_w.integers(0, 2, (63, spec_w.n_luts)).astype(np.uint8)])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        met, ci = fastchar.behav_metrics_sampled(spec_w, cfgs_w, n_samples=32768, seed=0,
                                                 ctx=ctx)
        t_w = time.perf_counter() - t0
        wide_timings[f"sampled{n_bits}"] = t_w
        if any(met[k][0] != 0.0 for k in met) or not all(
                np.isfinite(v).all() for v in met.values()):
            raise AssertionError(f"sampled {n_bits}-bit BEHAV: the accurate config does not "
                                 f"read 0, or a metric is not finite")
        # an 8-config subset against the port's CPU path (held against the
        # reference on the CPU by tests/test_torch_wide.py)
        met_c, ci_c = fastchar.behav_metrics_sampled(
            spec_w, cfgs_w[:8], n_samples=32768, seed=0, ctx=ExecutionContext(device="cpu"))
        for k in met_c:
            if k in ("AVG_ABS_REL_ERR", "MSE"):
                np.testing.assert_allclose(met[k][:8], met_c[k], rtol=1e-12, err_msg=k)
            else:
                np.testing.assert_array_equal(met[k][:8], met_c[k], err_msg=k)
        print(f"phase wide: sampled BEHAV of 64 {spec_w.tag} configs (L={spec_w.n_luts}) at "
              f"32,768 samples on the card: {t_w:.3f} s, {64 / t_w:.4g} configs/s; the "
              f"accurate config reads 0; an 8-config subset == the CPU path (integer "
              f"channels exactly, AVG_ABS_REL_ERR and MSE rtol 1e-12)", flush=True)
    # the unsigned 8-bit training set through K1, and a DSE on it
    spec_u = spec_for(8, signed=False)
    char_kernels.behav_stats_table.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_u = build_training_dataset(spec_u, n_random=2000, seed=0, backend=ctx)
    wide_timings["train_u8"] = time.perf_counter() - t0
    k1_u = char_kernels.behav_stats_table.launches
    pick_u = np.random.default_rng(4).choice(len(train_u), 64, replace=False)
    oracle_u = behav_metrics(spec_u, train_u.configs[pick_u], backend="numpy")
    for key in ("AVG_ABS_ERR", "PROB_ERR", "MAX_ABS_ERR", "MSE"):
        np.testing.assert_array_equal(train_u.metrics[key][pick_u], oracle_u[key], err_msg=key)
    np.testing.assert_allclose(train_u.metrics[BEHAV_KEY][pick_u], oracle_u[BEHAV_KEY],
                               rtol=REL_RTOL)
    print(f"phase wide: unsigned training set {len(train_u)} {spec_u.tag} configs "
          f"characterized through K1 ({k1_u} launches) in {wide_timings['train_u8']:.2f} s; "
          f"a 64-config subset == numpy backend (4 metrics, AVG_ABS_REL_ERR rtol "
          f"{REL_RTOL})", flush=True)
    if k1_u <= 0:
        raise AssertionError("the unsigned training set did not run K1")
    t0 = time.perf_counter()
    r_u = run_dse(spec_u, train_u, "ga",
                  settings=DSESettings(const_sf=0.5, pop_size=64, n_gen=100, context=ctx))
    wide_timings["dse_u8"] = time.perf_counter() - t0
    if not (r_u.hv_vpf > 0 and len(r_u.vpf_configs)):
        raise AssertionError("unsigned DSE: empty validated front")
    oracle_u = behav_metrics(spec_u, r_u.vpf_configs, backend="numpy")
    np.testing.assert_allclose(r_u.vpf_objs[:, 0], oracle_u[BEHAV_KEY], rtol=REL_RTOL)
    fast_u = behav_metrics(spec_u, r_u.vpf_configs, backend=ctx)
    for key in ("AVG_ABS_ERR", "PROB_ERR", "MAX_ABS_ERR", "MSE"):
        np.testing.assert_array_equal(fast_u[key], oracle_u[key], err_msg=key)
    print(f"phase wide: run_dse({spec_u.tag}, ga) hv_vpf {r_u.hv_vpf!r}, vpf "
          f"{len(r_u.vpf_configs)}, {wide_timings['dse_u8']:.2f} s; the validated front's "
          f"BEHAV == numpy", flush=True)
    # 12-bit mnist BEHAV of 64 configs through K5's 12-bit instance
    mnist12 = APPLICATIONS["mnist"]()
    app_kernels.entry_gemv_wide.launches = 0
    app_kernels.entry_gemv.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mn12 = fastapp.app_behav_torch(mnist12, spec12, cfgs12, ctx=ctx_entry)
    torch.cuda.synchronize()
    wide_timings["mnist12"] = time.perf_counter() - t0
    launches["K5W"] = app_kernels.entry_gemv_wide.launches
    if launches["K5W"] <= 0 or app_kernels.entry_gemv.launches:
        raise AssertionError(f"12-bit mnist BEHAV: K5's 12-bit instance launched "
                             f"{launches['K5W']} times, the 8-bit design "
                             f"{app_kernels.entry_gemv.launches}")
    plain12 = fastapp.app_behav_torch(mnist12, spec12, cfgs12[:8],
                                      ctx=ExecutionContext(kernel_impl="entry_gather"))
    np.testing.assert_array_equal(mn12[:8], plain12)
    if not np.isfinite(mn12).all():
        raise AssertionError("12-bit mnist BEHAV is not finite")
    print(f"phase wide: 12-bit mnist BEHAV of {len(cfgs12)} configs through K5's 12-bit "
          f"instance ({launches['K5W']} launch(es)) in {wide_timings['mnist12']:.3f} s; an "
          f"8-config subset == the plain route (entry_gather); accurate config "
          f"{mn12[-2]!r}%", flush=True)
    t_wide = time.perf_counter() - t_wide0
    print(f"phase wide: {t_wide:.1f} s ({ {k: round(v, 3) for k, v in wide_timings.items()} })",
          flush=True)

    # -- sweep: run_dse_sweep over the full const_sf grid, one GA for 12 lanes --
    segments["sweep"] = time.perf_counter()
    for fn in (moo_kernels.constraint_fronts, moo_kernels.constraint_fronts_lanes,
               moo_kernels.dominance_counts):
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sweep = run_dse_sweep(spec, train, "map+ga", settings=DSESettings(
        const_sf=0.5, pop_size=64, n_gen=100, context=ctx_entry), seeds=(0, 1),
        const_sf_grid=CONST_SF_GRID)
    torch.cuda.synchronize()
    t_sweep = time.perf_counter() - t0
    launches["K3L"] = moo_kernels.constraint_fronts_lanes.launches
    per_lane = moo_kernels.constraint_fronts.launches + moo_kernels.dominance_counts.launches
    print(f"phase sweep: run_dse_sweep({spec.tag}, map+ga, seeds (0, 1), const_sf "
          f"{list(CONST_SF_GRID)}): {len(sweep)} lanes at population 64 x 100 generations in "
          f"{t_sweep:.1f} s (shared stages {sweep[0].timings}); K3 over lanes launched "
          f"{launches['K3L']} times, per-lane K3 {per_lane}", flush=True)
    if launches["K3L"] != 2 * 100 or per_lane:
        raise AssertionError(f"the sweep's rankings: {launches['K3L']} lane launches (expected "
                             f"200, one a ranking) and {per_lane} per-lane launches")
    lane = next(r for r in sweep if r.settings.seed == 0 and r.settings.const_sf == 0.5)
    single = results["map+ga"]
    np.testing.assert_allclose(lane.hv_ppf, single.hv_ppf, rtol=1e-5)
    np.testing.assert_array_equal(lane.vpf_configs, single.vpf_configs)
    for r in sweep:
        # the tightest constraint (const_sf 0.2) may leave no validated
        # config; from 0.5 up every lane has a front
        if not np.isfinite(r.vpf_objs).all() or (
                r.settings.const_sf >= 0.5 and not (r.hv_vpf > 0 and len(r.vpf_configs))):
            raise AssertionError(f"sweep lane {r.settings.seed, r.settings.const_sf}: empty or "
                                 f"non-finite front")
        if not len(r.vpf_configs):
            continue
        oracle = behav_metrics(spec, r.vpf_configs, backend="numpy")
        np.testing.assert_allclose(r.vpf_objs[:, 0], oracle[BEHAV_KEY], rtol=REL_RTOL)
        fast = behav_metrics(spec, r.vpf_configs, backend=ctx)
        for key in ("AVG_ABS_ERR", "PROB_ERR", "MAX_ABS_ERR", "MSE"):
            np.testing.assert_array_equal(fast[key], oracle[key], err_msg=key)
    print(f"phase sweep: lane (seed 0, const_sf 0.5) == phase 4's map+ga run_dse (hv_ppf "
          f"{lane.hv_ppf!r} vs {single.hv_ppf!r}, rtol 1e-5; the same validated front of "
          f"{len(lane.vpf_configs)}); every lane's validated BEHAV == numpy; hv_vpf by lane "
          f"{[round(r.hv_vpf, 1) for r in sweep]} ({sum(not len(r.vpf_configs) for r in sweep)} "
          f"empty front(s) at const_sf 0.2)", flush=True)

    # -- service: the operator library and the job queue behind HTTP ---------
    segments["service"] = time.perf_counter()
    t_svc0 = time.perf_counter()
    tel_svc = obs.Telemetry("chip-smoke-service", parent=obs.GLOBAL)
    sweeps = {"calls": 0}
    run_sweep = fastmoo.CompiledNSGA2.run_sweep

    def counted_sweep(self, *args, **kw):
        sweeps["calls"] += 1
        return run_sweep(self, *args, **kw)

    fastmoo.CompiledNSGA2.run_sweep = counted_sweep
    with tempfile.TemporaryDirectory() as lib_dir:
        store = OperatorStore(root=lib_dir, tel=tel_svc)
        queue = DSEJobQueue(default_runner(DSESettings(pop_size=64, n_gen=100, context=ctx),
                                           store, n_train=2000), tel=tel_svc, linger_s=0.5)
        srv = MetricsServer(tel=obs.GLOBAL, port=0).start()
        srv.add_route("POST", "/dse", lambda p: {"job_id": queue.submit(
            DSERequest.from_dict(p))})
        srv.add_route("GET", "/dse", lambda p: queue.result(p["id"]) or {"status": "pending"})
        srv.add_route("GET", "/dse/library", lambda p: store_status(store))
        try:
            # half the sweep's grid (every other const_sf, both seeds): the
            # service's batching and library are the same at six lanes, and
            # each const_sf costs a MaP battery (~8 s on the host)
            svc_grid = CONST_SF_GRID[1::2]
            svc_lanes = [r for r in sweep if r.settings.const_sf in svc_grid]
            bursts = []
            for burst in range(2):
                moo_kernels.constraint_fronts_lanes.launches = 0
                moo_kernels.constraint_fronts.launches = 0
                batches0 = tel_svc.counter("service.batches")
                sweeps0 = sweeps["calls"]
                hits0 = tel_svc.counter("service.request_hit")
                t0 = time.perf_counter()
                jobs = [http_json(f"{srv.url}/dse", {"n_bits": 8, "const_sf": sf, "seed": sd,
                                                     "method": "map+ga"})["job_id"]
                        for sf in svc_grid for sd in (0, 1)]
                if not queue.join(timeout=600):
                    raise AssertionError("service: the jobs did not finish in 600 s")
                answers = [http_json(f"{srv.url}/dse?id={j}") for j in jobs]
                bursts.append(dict(
                    s=time.perf_counter() - t0,
                    batches=tel_svc.counter("service.batches") - batches0,
                    ga_dispatches=sweeps["calls"] - sweeps0,
                    hits=tel_svc.counter("service.request_hit") - hits0,
                    k3_lanes=moo_kernels.constraint_fronts_lanes.launches,
                    k3=moo_kernels.constraint_fronts.launches,
                    hv=[a.get("hv_vpf") for a in answers],
                    status=sorted({a["status"] for a in answers})))
                print(f"phase service: burst {burst + 1}: {len(jobs)} mul8 map+ga requests over "
                      f"HTTP -> {bursts[-1]}", flush=True)
                # the service's lanes are the sweep's (the same training set,
                # seeds and grid; validated through K1 there, K2 here)
                if bursts[-1]["status"] != ["done"]:
                    raise AssertionError(f"service burst {burst + 1}: {answers[:2]}")
                np.testing.assert_allclose(bursts[-1]["hv"], [r.hv_vpf for r in svc_lanes],
                                           rtol=1e-5, err_msg="service hv vs the sweep's")
            first, second = bursts
            if not (first["batches"] == 1 and first["ga_dispatches"] == 1
                    and first["k3_lanes"] == 200 and first["k3"] == 0):
                raise AssertionError(f"service: the first burst was not one batched sweep "
                                     f"of one K3 launch a ranking: {first}")
            if not (second["ga_dispatches"] == 0 and second["hits"] == len(jobs)
                    and second["k3_lanes"] == 0 and second["k3"] == 0
                    and second["hv"] == first["hv"]):
                raise AssertionError(f"service: the repeated burst was not answered from the "
                                     f"library: {second}")
            lib = http_json(f"{srv.url}/dse/library")
            with urllib.request.urlopen(f"{srv.url}/metrics") as resp:
                prom = resp.read().decode()
            health = http_json(f"{srv.url}/healthz")
            if not (lib["ok"] and lib["rows"] > 0 and lib["fronts"] >= len(jobs)):
                raise AssertionError(f"service: /dse/library {lib}")
            for name in ("repro_service_jobs_total", "repro_service_batches_total",
                         "repro_service_request_hit_total", "repro_service_batch_lanes"):
                if name not in prom:
                    raise AssertionError(f"service: /metrics lacks {name}")
            if health["status"] != "ok" or health["device"]["kind"] != torch.cuda.get_device_name(0):
                raise AssertionError(f"service: /healthz {health}")
            if not (health.get("tuning_cache", {}).get("ok")
                    and health["tuning_cache"]["entries"] > 0):
                raise AssertionError(f"service: /healthz lacks the tuning cache: {health}")
            print(f"phase service: /dse/library rows {lib['rows']} fronts {lib['fronts']}; "
                  f"/metrics renders the service.* counters; /healthz {health['status']} on "
                  f"'{health['device']['kind']}', tuning_cache {health['tuning_cache']}",
                  flush=True)
        finally:
            queue.close()
            srv.stop()
            fastmoo.CompiledNSGA2.run_sweep = run_sweep
    # the entry point's own self-test, at the reduced granite config, with a
    # fresh library
    with tempfile.TemporaryDirectory() as lib_dir:
        os.environ["REPRO_OPERATOR_LIBRARY"] = lib_dir
        try:
            smoke = serve.main(["--arch", "granite-3-2b", "--gen", "4", "--metrics-port", "0",
                                "--dse-smoke", "4", "--device", "cuda"])
        finally:
            del os.environ["REPRO_OPERATOR_LIBRARY"]
    if len(smoke["dse"]) != 4 or any(a["status"] != "done" for a in smoke["dse"]):
        raise AssertionError("serve --dse-smoke: not every request is done")
    t_svc = time.perf_counter() - t_svc0
    print(f"phase service: serve.main --dse-smoke 4 at the reduced config: 4 fronts, hv "
          f"{[round(a['hv_vpf'], 1) for a in smoke['dse']]}; {t_svc:.1f} s", flush=True)

    # -- serve: granite-3-2b at full width and depth, exact and AxO -----------
    segments["serve"] = time.perf_counter()
    all_wrappers = dict(app_wrappers, K6=axo_matmul.axo_matmul,
                        K7=flash_attention.flash_attention)
    for fn in all_wrappers.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    serve_trace = ROOT / "build" / "serve_trace.json"
    res = serve.main(SERVE_ARGS + ["--trace", str(serve_trace)])
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    serve_launches = {k: fn.launches for k, fn in all_wrappers.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    cfg, axo = res["cfg"], res["axo"]
    n_layers = cfg.n_layers
    k7_want = n_layers * (res["prefills"] + axo["prefills"])
    k6_want = (7 * n_layers + 1) * (axo["prefills"] + axo["decode_steps"])
    steps = res["decode_steps"] // res["prefills"]
    tok_s = 4 * steps / (res["exact_decode_ms"] / 1e3)
    tok_s_axo = 4 * steps / (axo["decode_ms"] / 1e3)
    print(f"phase serve: {cfg.name} ({n_layers} layers, d {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.kv_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}, bf16) in {t_serve:.1f} s; "
          f"exact prefill {res['exact_prefill_ms']:.2f} ms, decode "
          f"{res['exact_decode_ms'] / steps:.3f} ms/step ({tok_s:.1f} tokens/s); AxO rank "
          f"{AXO_RANK} ({axo['deployment'].n_entries} projections) prefill "
          f"{axo['prefill_ms']:.2f} ms, decode {axo['decode_ms'] / steps:.3f} ms/step "
          f"({tok_s_axo:.1f} tokens/s); peak memory {peak / 2**30:.3f} GiB "
          f"({peak} bytes); launches {serve_launches} (K6 expected {k6_want}, K7 {k7_want}); "
          f"free-run match {axo['free_run_match']:.4f}, teacher-forced top-1 "
          f"{axo['top1']:.4f}, logit rel_err {axo['rel_err']:.4f}", flush=True)
    if (serve_launches["K6"], serve_launches["K7"]) != (k6_want, k7_want):
        raise AssertionError(f"serve launches {serve_launches}: expected K6 {k6_want}, "
                             f"K7 {k7_want}")
    # obs: the --trace file, the AxO decode step beside earlier runs', the pad waste
    with open(serve_trace) as f:
        spans = [e["name"] for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    # the serving run's own plans: its kernels record on its telemetry
    pads = {k: (res["telemetry"].gauges.get(f"{k}.pad_waste"),
                res["telemetry"].histogram_summary(f"{k}.pad_waste"))
            for k in ("axo_matmul", "flash_attention")}
    print(f"phase obs: serve --trace {serve_trace}: {len(spans)} spans "
          f"({ {n: spans.count(n) for n in sorted(set(spans))} }); granite AxO decode "
          f"{axo['decode_ms'] / steps:.3f} ms/step (earlier runs: "
          f"{EARLIER_AXO_DECODE_MS['granite-3-2b']}"
          f"); pad waste of the run's plans (last, summary): K6 {pads['axo_matmul'][0]} "
          f"{pads['axo_matmul'][1]}, K7 {pads['flash_attention'][0]} "
          f"{pads['flash_attention'][1]}", flush=True)
    if not {"serve.request", "serve.prefill", "serve.decode"} <= set(spans):
        raise AssertionError(f"serve --trace lacks the prefill and decode spans: {set(spans)}")
    if not all(torch.isfinite(lg.float()).all() for lg in res["exact_logits"] +
               axo["replay_logits"]):
        raise AssertionError("non-finite logits on the serve path")
    launches.update(K6=serve_launches["K6"], K7=serve_launches["K7"])
    # checks, after the counts are read.  (b) Each pass replayed with every K6
    # and K7 call also run on its plain version on the same inputs: K6 to
    # REL_RTOL relative norm, K7 to one bf16 ulp of the call's largest output.
    plain = ExecutionContext(kernel_impl="plain")
    params, toks, max_seq, traj = res["params"], res["tokens"], res["max_seq"], res["trajectory"]
    dep = axo["deployment"]
    t0 = time.perf_counter()
    with checked_calls(torch) as calls:
        pre_k = make_prefill_step(cfg, max_seq)(params, toks)[0]
        rep_k = serve.replay(make_prefill_step(cfg, max_seq, axo=dep),
                             make_decode_step(cfg, axo=dep), params, toks, traj)
    k6_worst = max(calls["K6"])
    k7_worst = max(calls["K7"])
    print(f"phase serve: exact prefill and AxO teacher-forced replay with each kernel call "
          f"also run on its plain version: K6 {len(calls['K6'])} calls, max rel norm "
          f"{k6_worst:.3g} (limit {REL_RTOL}); K7 {len(calls['K7'])} calls, max err / max|out| "
          f"{k7_worst:.3g} (limit 2^-7 = {2.0 ** -7:.4g}) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    if not (k6_worst <= REL_RTOL and k7_worst <= 2.0 ** -7):
        raise AssertionError("a K6 or K7 call on the serve path differs from its plain version")
    # the whole passes on the plain versions, and what one bf16 ulp of input does
    # to the plain pass itself: at full depth with random weights the attention
    # is saturated, so an ulp anywhere moves the logits (printed, not bounded)
    dep_plain = dataclasses.replace(dep, ctx=plain)
    rep_p = serve.replay(make_prefill_step(cfg, max_seq, axo=dep_plain, ctx=plain),
                         make_decode_step(cfg, axo=dep_plain, ctx=plain), params, toks, traj)
    pre_p = make_prefill_step(cfg, max_seq, ctx=plain)(params, toks)[0]
    nudged = dict(params, embed={"tok": params["embed"]["tok"].clone()})
    t_id = int(toks[0, 5])
    nudged["embed"]["tok"][t_id, 7] = (nudged["embed"]["tok"][t_id, 7].float()
                                       * (1 + 2.0 ** -7)).to(torch.bfloat16)
    pre_n = make_prefill_step(cfg, max_seq, ctx=plain)(nudged, toks)[0]
    # layer 0's attention scores (head 0, before rotary): their spread says how
    # saturated the softmax is
    lp, hd = params["stages"]["0"]["0"], cfg.resolved_head_dim
    h0 = rmsnorm(params["embed"]["tok"][toks], lp["norm1"][0], cfg.norm_eps)
    q0, k0 = ((h0 @ lp["mixer"][w][0].reshape(cfg.d_model, -1)).float()[..., :hd]
              for w in ("wq", "wk"))
    score_std = float((q0 @ k0.transpose(1, 2) / hd ** 0.5).std())
    print(f"phase serve: logits of the kernel passes vs the plain passes (rel norm): AxO "
          f"teacher-forced max over {len(rep_p)} steps "
          f"{max(rel_norm(a, b) for a, b in zip(rep_k, rep_p)):.4g}, exact prefill "
          f"{rel_norm(pre_k[:, -1], pre_p[:, -1]):.4g}; the plain exact prefill with one "
          f"embedding element moved by one bf16 ulp {rel_norm(pre_n[:, -1], pre_p[:, -1]):.4g}; "
          f"layer 0 attention score std {score_std:.4g}", flush=True)
    del nudged, rep_p, pre_p, pre_n
    # warm timings and where a decode step's device time goes
    for label, a in (("exact", None), ("AxO", dep)):
        pre_fn, dec_fn = make_prefill_step(cfg, max_seq, axo=a), make_decode_step(cfg, axo=a)
        _, _, (tp, td) = serve.generate(pre_fn, dec_fn, params, toks, 16)
        busy, top = profile_decode(torch, pre_fn, dec_fn, params, toks)
        step_ms = td * 1e3 / 15
        busy_p, _ = profile_calls(torch, lambda: pre_fn(params, toks), 1)
        earlier = (f" (earlier runs: {EARLIER_AXO_DECODE_MS['granite-3-2b']})"
                   if label == "AxO" else "")
        if label == "AxO":
            # obs: one AxO prefill's torch.profiler trace, beside the
            # profiled windows above; it must hold K6 and K7 device events
            t_tr = time.perf_counter()
            prefill_trace = ROOT / "build" / "granite_prefill_trace.json"
            with trace_capture(str(prefill_trace), tel=obs.GLOBAL):
                pre_fn(params, toks)
                torch.cuda.synchronize()
            with open(prefill_trace) as f:
                events = json.load(f)["traceEvents"]
            dev_names = [e["name"] for e in events if e.get("cat") == "kernel"]
            k6_ev = sum("axo_mma_kernel" in n or "axo_gemv_kernel" in n for n in dev_names)
            k7_ev = sum("flash_attention_" in n for n in dev_names)
            t_obs += time.perf_counter() - t_tr
            print(f"phase obs: trace_capture of one granite-3-2b AxO prefill (B=4, S=128) -> "
                  f"{prefill_trace}: {len(events)} events, {len(dev_names)} device kernels, "
                  f"K6 {k6_ev}, K7 {k7_ev}", flush=True)
            if not (k6_ev and k7_ev):
                raise AssertionError("the granite prefill's trace holds no K6 or no K7 "
                                     "device event")
        print(f"phase serve: {label} warm: prefill {tp * 1e3:.2f} ms, decode "
              f"{step_ms:.3f} ms/step{earlier} ({4 * 15 / td:.1f} tokens/s); profiled decode step: "
              f"device time {busy['device_ms']:.3f} ms ({busy['device_ms'] / step_ms:.1%} "
              f"of the unprofiled step; {busy['wall_ms']:.3f} ms wall under the profiler), "
              f"K6 {busy['k6_ms']:.3f} ms of it ({busy['k6_ms'] / busy['device_ms']:.1%}); "
              f"profiled prefill: device time {busy_p['device_ms']:.3f} ms, K6 "
              f"{busy_p['k6_ms']:.3f} ms of it; top decode kernels (name, ms per step, "
              f"launches per step) {top}", flush=True)
    del res, axo, params, dep, dep_plain, rep_k, pre_fn, dec_fn, a, lp, h0, q0, k0
    # (c) at the reduced config in f32, with the reference test's mild rank-16
    # operator: its fidelity bounds, and (b) end to end, where one ulp does not
    # reach the logits
    red = get_arch("granite-3-2b").reduced()
    red_params = init_params(model_spec(red), seed=0, dtype=torch.float32)
    red_toks = torch.from_numpy(SyntheticLM(
        red, ShapeConfig("serve", 14, 2, "train"), seed=0).batch(0)["tokens"][:, :8])
    red_toks = red_toks.long().to(dev)
    mild = accurate_config(spec)
    mild[0] = 0
    red_dep = deploy_axo(red_params, AxOOperator.from_config(mild, rank=16), red)
    red_traj, exact_lgs, _ = serve.generate(make_prefill_step(red, 14),
                                            make_decode_step(red), red_params, red_toks, 6)
    k6_before = axo_matmul.axo_matmul.launches
    red_rep = serve.replay(make_prefill_step(red, 14, axo=red_dep),
                           make_decode_step(red, axo=red_dep), red_params, red_toks, red_traj)
    top1, rel = serve.fidelity(red_rep, exact_lgs)
    red_plain = dataclasses.replace(red_dep, ctx=plain)
    red_rep_p = serve.replay(make_prefill_step(red, 14, axo=red_plain, ctx=plain),
                             make_decode_step(red, axo=red_plain, ctx=plain),
                             red_params, red_toks, red_traj)
    rel_axo = max(rel_norm(a, b) for a, b in zip(red_rep, red_rep_p))
    rel_pre = rel_norm(make_prefill_step(red, 14)(red_params, red_toks)[0],
                       make_prefill_step(red, 14, ctx=plain)(red_params, red_toks)[0])
    print(f"phase serve: reduced {red.name} f32, mild rank-16 operator in every projection: "
          f"teacher-forced top-1 {top1:.4f} (bound >= 0.5), logit rel {rel:.4f} (bound < 0.5), "
          f"K6 launches {axo_matmul.axo_matmul.launches - k6_before}; logits of the kernel "
          f"passes vs plain: AxO teacher-forced {rel_axo:.3g}, exact prefill {rel_pre:.3g} "
          f"(limit {SERVE_REL})", flush=True)
    if not (top1 >= 0.5 and rel < 0.5):
        raise AssertionError("reduced AxO serving misses the reference test's fidelity bounds")
    if not (rel_axo <= SERVE_REL and rel_pre <= SERVE_REL):
        raise AssertionError("a reduced serve pass on the kernels differs from its plain replay")
    del red_params, red_dep, red_plain

    # -- serve-ssm: mamba2-130m at full width and depth, exact and AxO head ---
    segments["serve-ssm"] = time.perf_counter()
    ssm_wrappers = dict(all_wrappers, K8=ssd_scan.ssd_scan)
    for fn in ssm_wrappers.values():
        fn.launches = 0
    ssd_scan.ssd_scan.route_launches.update(mma=0, scalar=0)
    grids0 = ssd_scan.grids()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)   # phase 3's operands, still referenced
    t0 = time.perf_counter()
    res = serve.main(SSM_ARGS)
    torch.cuda.synchronize()
    t_ssm = time.perf_counter() - t0
    ssm_launches = {k: fn.launches for k, fn in ssm_wrappers.items()}
    k8_routes = dict(ssd_scan.ssd_scan.route_launches)
    k8_grids = ssd_scan.grids() - grids0
    peak = torch.cuda.max_memory_allocated(dev) - held
    cfg, axo = res["cfg"], res["axo"]
    dep = axo["deployment"]
    batch, plen = res["tokens"].shape
    steps = res["decode_steps"] // res["prefills"]
    ssm_want = dict.fromkeys(ssm_wrappers, 0)
    ssm_want.update(K6=dep.n_entries * (axo["prefills"] + axo["decode_steps"]),
                    K8=cfg.n_layers * (res["prefills"] + axo["prefills"]))
    print(f"phase serve-ssm: {cfg.name} ({cfg.n_layers} mamba layers, d {cfg.d_model}, "
          f"{cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim} SSD heads of "
          f"{cfg.ssm.head_dim}, state {cfg.ssm.d_state}, vocab {cfg.vocab}, bf16) batch "
          f"{batch} x prompt {plen} + {steps + 1} tokens in {t_ssm:.1f} s; exact prefill "
          f"{res['exact_prefill_ms']:.2f} ms ({batch * plen / res['exact_prefill_ms'] * 1e3:.0f} "
          f"tokens/s), decode {res['exact_decode_ms'] / steps:.3f} ms/step "
          f"({batch * steps / res['exact_decode_ms'] * 1e3:.1f} tokens/s); AxO rank {AXO_RANK} "
          f"({dep.n_entries} projection: the tied head) prefill {axo['prefill_ms']:.2f} ms, "
          f"decode {axo['decode_ms'] / steps:.3f} ms/step "
          f"({batch * steps / axo['decode_ms'] * 1e3:.1f} tokens/s); peak memory "
          f"{peak / 2**30:.3f} GiB ({peak} bytes, above the {held} held before); launches "
          f"{ssm_launches} (expected "
          f"{ssm_want}), K8 calls by route {k8_routes}, {k8_grids} K8 grids; free-run match {axo['free_run_match']:.4f}, teacher-forced top-1 "
          f"{axo['top1']:.4f}, logit rel_err {axo['rel_err']:.4f}", flush=True)
    if ssm_launches != ssm_want:
        raise AssertionError(f"serve-ssm launches {ssm_launches}, expected {ssm_want}")
    if k8_routes != {"mma": ssm_launches["K8"], "scalar": 0}:
        raise AssertionError(f"serve-ssm's K8 calls by route {k8_routes}: every one must take "
                             f"the tensor-core design")
    if k8_grids != 2 * ssm_launches["K8"]:
        raise AssertionError(f"serve-ssm's {ssm_launches['K8']} K8 calls launched {k8_grids} "
                             f"grids, expected two a call")
    rec["K8"]["grids"] = k8_grids / ssm_launches["K8"]
    if not all(torch.isfinite(lg.float()).all() for lg in res["exact_logits"] +
               axo["replay_logits"]):
        raise AssertionError("non-finite logits on the serve-ssm path")
    launches["K8"] = ssm_launches["K8"]
    # checks, after the counts are read: every K8 call of an exact prefill and
    # of the AxO teacher-forced replay also run on its plain version.  y to one
    # bf16 ulp of the call's largest output; the f32 state to REL_RTOL
    params, toks, max_seq, traj = res["params"], res["tokens"], res["max_seq"], res["trajectory"]
    t0 = time.perf_counter()
    with checked_calls(torch) as calls:
        pre_k = make_prefill_step(cfg, max_seq)(params, toks)[0]
        serve.replay(make_prefill_step(cfg, max_seq, axo=dep), make_decode_step(cfg, axo=dep),
                     params, toks, traj)
    y_worst = max(c[0] for c in calls["K8"])
    st_worst = max(c[1] for c in calls["K8"])
    print(f"phase serve-ssm: exact prefill and AxO teacher-forced replay with each kernel call "
          f"also run on its plain version: K8 {len(calls['K8'])} calls, y max err / max|y| "
          f"{y_worst:.3g} (limit 2^-7 = {2.0 ** -7:.4g}), state max rel norm {st_worst:.3g} "
          f"(limit {REL_RTOL}); K6 {len(calls['K6'])} calls, max rel norm "
          f"{max(calls['K6']):.3g} (limit {REL_RTOL}) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    if len(calls["K8"]) != 2 * cfg.n_layers or len(calls["K7"]) != 0:
        raise AssertionError(f"serve-ssm replays made {len(calls['K8'])} K8 and "
                             f"{len(calls['K7'])} K7 calls, expected {2 * cfg.n_layers} and 0")
    if not (y_worst <= 2.0 ** -7 and st_worst <= REL_RTOL and max(calls["K6"]) <= REL_RTOL):
        raise AssertionError("a K8 or K6 call on the serve-ssm path differs from its plain version")
    # warm timings and where a prefill's and a decode step's device time goes
    for label, a in (("exact", None), ("AxO", dep)):
        pre_fn, dec_fn = make_prefill_step(cfg, max_seq, axo=a), make_decode_step(cfg, axo=a)
        _, _, (tp, td) = serve.generate(pre_fn, dec_fn, params, toks, steps + 1)
        busy_p, top_p = profile_calls(torch, lambda: pre_fn(params, toks), 1)
        busy, top = profile_decode(torch, pre_fn, dec_fn, params, toks)
        step_ms = td * 1e3 / steps
        print(f"phase serve-ssm: {label} warm: prefill {tp * 1e3:.2f} ms "
              f"({batch * plen / tp:.0f} tokens/s), decode {step_ms:.3f} ms/step "
              f"({batch * steps / td:.1f} tokens/s); profiled prefill: device time "
              f"{busy_p['device_ms']:.3f} ms ({busy_p['wall_ms']:.3f} ms wall under the "
              f"profiler), top kernels {top_p}; profiled decode step: device time "
              f"{busy['device_ms']:.3f} ms ({busy['device_ms'] / step_ms:.1%} of the "
              f"unprofiled step; {busy['wall_ms']:.3f} ms wall under the profiler), K6 "
              f"{busy['k6_ms']:.3f} ms of it; top kernels (name, ms per step, launches per "
              f"step) {top}", flush=True)
    # the exact prefill on the plain versions end to end, beside two yardsticks
    # of the plain pass's own sensitivity: one bf16 ulp of one embedding element,
    # and the plain scan at K8's chunk length (the same algebra, other f32
    # rounding).  The kernel pass is held to SERVE_REL unless that ulp moves the
    # plain pass by more; then (as with random weights at full width, where 24
    # layers amplify a rounding difference) to twice the chunk yardstick, or
    # SERVE_REL if that is larger: K8 may move the logits no more than
    # re-rounding the plain algebra does
    pre_k = make_prefill_step(cfg, max_seq)(params, toks)[0]
    pre_p = make_prefill_step(cfg, max_seq, ctx=plain)(params, toks)[0]
    cfg_q = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, chunk=K8_Q))
    pre_q = make_prefill_step(cfg_q, max_seq, ctx=plain)(params, toks)[0]
    nudged = dict(params, embed={"tok": params["embed"]["tok"].clone()})
    t_id = int(toks[0, 5])
    nudged["embed"]["tok"][t_id, 7] = (nudged["embed"]["tok"][t_id, 7].float()
                                       * (1 + 2.0 ** -7)).to(torch.bfloat16)
    pre_n = make_prefill_step(cfg, max_seq, ctx=plain)(nudged, toks)[0]
    rel_pre = rel_norm(pre_k[:, -1], pre_p[:, -1])
    rel_q = rel_norm(pre_q[:, -1], pre_p[:, -1])
    rel_ulp = rel_norm(pre_n[:, -1], pre_p[:, -1])
    limit = SERVE_REL if rel_ulp <= SERVE_REL else max(SERVE_REL, 2 * rel_q)
    print(f"phase serve-ssm: exact prefill logits of the kernel pass vs the plain pass (rel "
          f"norm) {rel_pre:.4g} (limit {limit:.4g}); the plain pass with its scan at K8's chunk "
          f"of {K8_Q} {rel_q:.4g}; the plain prefill with one embedding element moved by one "
          f"bf16 ulp {rel_ulp:.4g} (so the limit is "
          f"{'SERVE_REL' if rel_ulp <= SERVE_REL else 'twice the chunk yardstick'})",
          flush=True)
    if rel_pre > limit:
        raise AssertionError("the full-width mamba prefill on K8 differs from the plain pass")
    del nudged, pre_p, pre_n, pre_k, pre_q
    del res, axo, params, dep, pre_fn, dec_fn, a
    # the reduced config in f32, prompt 40 = 3 chunks of 16 (the last ragged):
    # kernel passes vs plain passes end to end, exact and AxO head
    red = get_arch("mamba2-130m").reduced()
    red_params = init_params(model_spec(red), seed=0, dtype=torch.float32)
    red_toks = torch.from_numpy(SyntheticLM(
        red, ShapeConfig("serve", 46, 2, "train"), seed=0).batch(0)["tokens"][:, :40])
    red_toks = red_toks.long().to(dev)
    red_dep = deploy_axo(red_params, serve.demo_operator(AXO_RANK), red)
    k8_before = ssd_scan.ssd_scan.launches
    red_traj, exact_lgs, _ = serve.generate(make_prefill_step(red, 46),
                                            make_decode_step(red), red_params, red_toks, 6)
    red_rep = serve.replay(make_prefill_step(red, 46, axo=red_dep),
                           make_decode_step(red, axo=red_dep), red_params, red_toks, red_traj)
    k8_red = ssd_scan.ssd_scan.launches - k8_before
    red_plain = dataclasses.replace(red_dep, ctx=plain)
    exact_p = serve.replay(make_prefill_step(red, 46, ctx=plain),
                           make_decode_step(red, ctx=plain), red_params, red_toks, red_traj)
    red_rep_p = serve.replay(make_prefill_step(red, 46, axo=red_plain, ctx=plain),
                             make_decode_step(red, axo=red_plain, ctx=plain),
                             red_params, red_toks, red_traj)
    rel_exact = max(rel_norm(a, b) for a, b in zip(exact_lgs, exact_p))
    rel_axo = max(rel_norm(a, b) for a, b in zip(red_rep, red_rep_p))
    print(f"phase serve-ssm: reduced {red.name} f32, prompt 40 (3 chunks of "
          f"{red.ssm.chunk}, ragged) + 5 decode steps: K8 launches {k8_red} (expected "
          f"{2 * red.n_layers}); logits of the kernel passes vs plain, max over steps: exact "
          f"{rel_exact:.3g}, AxO head teacher-forced {rel_axo:.3g} (limit {SERVE_REL})",
          flush=True)
    if k8_red != 2 * red.n_layers:
        raise AssertionError(f"the reduced mamba passes launched K8 {k8_red} times")
    if not (rel_exact <= SERVE_REL and rel_axo <= SERVE_REL):
        raise AssertionError("a reduced mamba pass on the kernels differs from its plain replay")

    # -- serve-dense, serve-moe, serve-hybrid, serve-mla, serve-encdec, serve-vlm
    segments["serve-families"] = time.perf_counter()
    # internlm2-1.8b, starcoder2-3b, deepseek-67b, kimi-k2, jamba,
    # deepseek-v3, whisper's decoder and the VLM cut in depth (DEPTH_CUTS)
    # with dataclasses.replace and served by serve.serve_config, serve.main's
    # run.  Each: batch 4, prompt 128, 8 new
    # tokens, exact and with the rank-8 demo operator in every projection and
    # the head; launch counts zeroed before and read after; every K7 and K8
    # call of an exact prefill and every K6, K7 and K8 call of the AxO prefill
    # and first decode step held against its plain version; a MoE arch's
    # capacity drops at the prefill; warm times, device time by kernel and
    # peak memory; the model freed before the next
    new_serve = {}

    def serve_phase(phase: str, arch: str) -> dict:
        for fn in ssm_wrappers.values():
            fn.launches = 0
        ssd_scan.ssd_scan.route_launches.update(mma=0, scalar=0)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        argv = ["--arch", arch, *SERVE_NEW_ARGS]
        if arch in DEPTH_CUTS:
            full = get_arch(arch)
            cut = dataclasses.replace(full, stages=tuple(
                dataclasses.replace(st, repeats=r) for st, r in zip(full.stages, DEPTH_CUTS[arch])))
            print(f"phase {phase}: {arch} at full width, depth cut {full.n_layers} -> "
                  f"{cut.n_layers} layers (stage repeats "
                  f"{[st.repeats for st in full.stages]} -> {list(DEPTH_CUTS[arch])}): "
                  f"{count_params(model_spec(cut)) / 1e9:.3f} G parameters of "
                  f"{count_params(model_spec(full)) / 1e9:.1f} G", flush=True)
            res = serve.serve_config(cut, serve.parse_args(argv))
        else:
            res = serve.main(argv)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        got = {k: fn.launches for k, fn in ssm_wrappers.items()}
        k8_routes = dict(ssd_scan.ssd_scan.route_launches)
        peak = torch.cuda.max_memory_allocated(dev) - held
        cfg, axo = res["cfg"], res["axo"]
        dep = axo["deployment"]
        hd = cfg.resolved_head_dim
        per_pre, per_dec = k6_per_forward(cfg, "prefill"), k6_per_forward(cfg, "decode")
        k7_pre = k7_per_prefill(cfg)
        k7_n, k8_n = sum(k7_pre.values()), k8_per_prefill(cfg)
        k7_nc = sum(n for (_, causal), n in k7_pre.items() if not causal)
        prefills = res["prefills"] + axo["prefills"]
        want = dict.fromkeys(ssm_wrappers, 0)
        want.update(K6=per_pre * axo["prefills"] + per_dec * axo["decode_steps"],
                    K7=k7_n * prefills, K8=k8_n * prefills)
        steps = res["decode_steps"] // res["prefills"]
        front = res["frontend"]
        extra = ""
        if cfg.moe:
            extra += (f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k}, d_ff_expert "
                      f"{cfg.moe.d_ff_expert}, ")
        if cfg.mla:
            extra += f"MLA q/k width {cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim}, "
        if front is not None:
            extra += f"stub frontend {tuple(front.shape)}, "
        earlier = (f" (earlier runs: {EARLIER_AXO_DECODE_MS[arch]})"
                   if arch in EARLIER_AXO_DECODE_MS else "")
        print(f"phase {phase}: {cfg.name} ({cfg.n_layers} layers"
              f"{' + %d encoder layers' % cfg.encoder.n_layers if cfg.encoder else ''}, d "
              f"{cfg.d_model}, {cfg.n_heads}/{cfg.kv_heads} heads of {hd}, d_ff {cfg.d_ff}, "
              f"{extra}vocab {cfg.vocab}, bf16) batch 4 x prompt {PROMPT_LEN} + {GEN_TOKENS} "
              f"tokens in {t_run:.1f} s; exact prefill {res['exact_prefill_ms']:.2f} ms, decode "
              f"{res['exact_decode_ms'] / steps:.3f} ms/step; AxO rank {AXO_RANK} "
              f"({dep.n_entries} entries, K6 calls a forward {per_pre} prefill / {per_dec} "
              f"decode) prefill {axo['prefill_ms']:.2f} ms, decode "
              f"{axo['decode_ms'] / steps:.3f} ms/step{earlier}; peak memory "
              f"{peak / 2**30:.3f} GiB "
              f"({peak} bytes above the {held} held before); launches {got} (expected {want}), "
              f"K7 a prefill by (hd, causal) {k7_pre}, K8 calls by route {k8_routes}; "
              f"free-run match {axo['free_run_match']:.4f}, teacher-forced top-1 "
              f"{axo['top1']:.4f}, logit rel_err {axo['rel_err']:.4f}; K6 pad waste of the "
              f"run's plans {res['telemetry'].histogram_summary('axo_matmul.pad_waste')}",
              flush=True)
        if got != want:
            raise AssertionError(f"{phase} {cfg.name}: launches {got}, expected {want}")
        if k8_routes != {"mma": got["K8"], "scalar": 0}:
            raise AssertionError(f"{phase}: K8 calls by route {k8_routes}: every one must take "
                                 f"the tensor-core design")
        if not all(torch.isfinite(lg.float()).all() for lg in res["exact_logits"] +
                   axo["replay_logits"]):
            raise AssertionError(f"non-finite logits on the {phase} path ({cfg.name})")
        params, toks, max_seq = res["params"], res["tokens"], res["max_seq"]
        traj = res["trajectory"]
        t0 = time.perf_counter()
        with checked_calls(torch) as calls:
            with routed_drops(torch) as drops:
                make_prefill_step(cfg, max_seq)(params, toks, front)
            serve.replay(make_prefill_step(cfg, max_seq, axo=dep),
                         make_decode_step(cfg, axo=dep), params, toks, traj[:, :2], front)
        k6_worst = max(calls["K6"])
        k7_worst = max(calls["K7"], default=0.0)
        y_worst = max((c[0] for c in calls["K8"]), default=0.0)
        st_worst = max((c[1] for c in calls["K8"]), default=0.0)
        drop = drops["dropped"] / drops["entries"] if drops["entries"] else None
        print(f"phase {phase}: {cfg.name} exact prefill, AxO prefill and first decode step "
              f"with each kernel call also run on its plain version: K6 {len(calls['K6'])} "
              f"calls, max rel norm {k6_worst:.3g} (limit {REL_RTOL}); K7 "
              f"{len(calls['K7'])} calls at hd {hd} ({calls['K7 non-causal']} non-causal), "
              f"max err / max|out| {k7_worst:.3g} (limit 2^-7 = {2.0 ** -7:.4g}); K8 "
              f"{len(calls['K8'])} calls, y max err / max|y| {y_worst:.3g} (limit 2^-7), "
              f"state rel norm {st_worst:.3g} (limit {REL_RTOL}) in "
              f"{time.perf_counter() - t0:.1f} s"
              + (f"; MoE capacity drops at the exact prefill ({4 * PROMPT_LEN} tokens, "
                 f"{drops['layers']} moe layers): {drops['dropped']} of {drops['entries']} "
                 f"routed entries, drop rate {drop:.4%}" if drop is not None else ""),
              flush=True)
        if (len(calls["K6"]), len(calls["K7"]), calls["K7 non-causal"], len(calls["K8"])) != (
                per_pre + per_dec, 2 * k7_n, 2 * k7_nc, 2 * k8_n):
            raise AssertionError(f"{phase} checks made {len(calls['K6'])} K6, "
                                 f"{len(calls['K7'])} K7 ({calls['K7 non-causal']} non-causal) "
                                 f"and {len(calls['K8'])} K8 calls, expected {per_pre + per_dec}, "
                                 f"{2 * k7_n} ({2 * k7_nc}) and {2 * k8_n}")
        if not (k6_worst <= REL_RTOL and k7_worst <= 2.0 ** -7 and y_worst <= 2.0 ** -7
                and st_worst <= REL_RTOL):
            raise AssertionError(f"a kernel call on the {phase} path differs from its plain "
                                 f"version ({cfg.name})")
        stats = {"layers": cfg.n_layers, "head_dim": hd, "peak_bytes": peak, "launches": got,
                 "k7_a_prefill": {f"hd{h} {'causal' if c else 'non-causal'}": n
                                  for (h, c), n in k7_pre.items()},
                 "seconds": t_run, "drop_rate": drop}
        for label, a in (("exact", None), ("AxO", dep)):
            pre_fn, dec_fn = make_prefill_step(cfg, max_seq, axo=a), make_decode_step(cfg, axo=a)
            _, _, (tp, td) = serve.generate(pre_fn, dec_fn, params, toks, GEN_TOKENS,
                                            frontend=front)
            busy_p, top_p = profile_calls(torch, lambda: pre_fn(params, toks, front), 1)
            busy, top = profile_decode(torch, pre_fn, dec_fn, params, toks, front=front)
            step_ms = td * 1e3 / (GEN_TOKENS - 1)
            print(f"phase {phase}: {cfg.name} {label} warm: prefill {tp * 1e3:.2f} ms "
                  f"({4 * PROMPT_LEN / tp:.0f} tokens/s), decode {step_ms:.3f} ms/step"
                  f"{earlier if label == 'AxO' else ''} "
                  f"({4 * (GEN_TOKENS - 1) / td:.1f} tokens/s); profiled prefill: device "
                  f"time {busy_p['device_ms']:.3f} ms, K6 {busy_p['k6_ms']:.3f}, K7 "
                  f"{busy_p['k7_ms']:.3f}, K8 {busy_p['k8_ms']:.3f} ms of it; top kernels "
                  f"{top_p}; profiled decode step: device time {busy['device_ms']:.3f} ms "
                  f"({busy['device_ms'] / step_ms:.1%} of the unprofiled step), K6 "
                  f"{busy['k6_ms']:.3f} ms of it; top kernels {top}", flush=True)
            stats[label] = {"prefill_ms": tp * 1e3, "decode_step_ms": step_ms,
                            "prefill_device_ms": busy_p["device_ms"],
                            "prefill_k6_ms": busy_p["k6_ms"], "prefill_k7_ms": busy_p["k7_ms"],
                            "prefill_k8_ms": busy_p["k8_ms"],
                            "decode_device_ms": busy["device_ms"]}
        new_serve[cfg.name] = stats
        del res, axo, dep, params, toks, traj, calls, pre_fn, dec_fn, a, front
        gc.collect()
        torch.cuda.empty_cache()
        return stats

    t0 = time.perf_counter()
    dense_runs = [serve_phase("serve-dense", arch) for arch in DENSE_ARCHS]
    t_dense = time.perf_counter() - t0
    launches["K6D"] = sum(r["launches"]["K6"] for r in dense_runs)
    t0 = time.perf_counter()
    moe_run = serve_phase("serve-moe", "kimi-k2-1t-a32b")
    t_moe = time.perf_counter() - t0
    launches["K6E"] = moe_run["launches"]["K6"]
    # slice 4: the hybrid, MLA, encoder-decoder and VLM families
    slice4, t_slice4 = {}, {}
    for phase, arch in SLICE4_PHASES.items():
        t0 = time.perf_counter()
        slice4[phase] = serve_phase(phase, arch)
        t_slice4[phase] = time.perf_counter() - t0
    launches["K6M"] = sum(slice4[ph]["launches"]["K6"] for ph in ("serve-hybrid", "serve-mla"))
    launches["K6X"] = sum(slice4[ph]["launches"]["K6"] for ph in ("serve-encdec", "serve-vlm"))
    launches["K8H"] = slice4["serve-hybrid"]["launches"]["K8"]
    # K7's launches of these phases by head width and causality: hd 64 causal
    # beside granite's (K7), hd 128 causal (K7W), hd 112 (K7X), non-causal (K7N)
    k7_at = {}
    for r in (*dense_runs, moe_run, *slice4.values()):
        prefills = r["launches"]["K7"] // max(1, sum(r["k7_a_prefill"].values()))
        for kind, n in r["k7_a_prefill"].items():
            k7_at[kind] = k7_at.get(kind, 0) + n * prefills
    launches["K7"] += k7_at.get("hd64 causal", 0)
    launches["K7W"], launches["K7X"] = k7_at.get("hd128 causal", 0), k7_at.get("hd112 causal", 0)
    launches["K7N"] = sum(n for kind, n in k7_at.items() if kind.endswith("non-causal"))
    print(f"phase serve-vlm: launches of the serving phases since slice 3: K6 serve-dense "
          f"{launches['K6D']}, serve-moe {launches['K6E']}, serve-hybrid + serve-mla "
          f"{launches['K6M']}, serve-encdec + serve-vlm {launches['K6X']}; K7 by kind "
          f"{k7_at}; K8 serve-hybrid {launches['K8H']}; MoE drop rates at full width "
          f"{ {k: v['drop_rate'] for k, v in new_serve.items() if v['drop_rate'] is not None} }; "
          f"serve-dense {t_dense:.1f} s, serve-moe {t_moe:.1f} s, "
          f"{ {k: round(v, 1) for k, v in t_slice4.items()} }; {json.dumps(new_serve)}",
          flush=True)

    # the reduced configs of slice 4 in f32 (K7's and K8's f32 instances; K7
    # non-causal in whisper's encoder and cross-attention): kernel passes vs
    # plain passes, exact to SERVE_REL; AxO to SERVE_REL, or, where a one-ulp
    # nudge of the norm weights moves the plain AxO pass by more (an
    # activation code on a rounding boundary), to twice that nudge's effect
    for arch in SLICE4_PHASES.values():
        red = get_arch(arch).reduced()
        red_params = init_params(model_spec(red), seed=0, dtype=torch.float32)
        batch = SyntheticLM(red, ShapeConfig("serve", 14, 2, "train"), seed=0).batch(0)
        red_toks = torch.from_numpy(batch["tokens"][:, :8]).long().to(dev)
        red_front = next((torch.from_numpy(batch[k]).to(dev) for k in ("enc_embeds",
                                                                        "img_embeds")
                          if k in batch), None)
        red_dep = deploy_axo(red_params, serve.demo_operator(AXO_RANK), red)
        red_plain = dataclasses.replace(red_dep, ctx=plain)
        before = {k: fn.launches for k, fn in ssm_wrappers.items()}
        red_traj, exact_lgs, _ = serve.generate(make_prefill_step(red, 14),
                                                make_decode_step(red), red_params, red_toks,
                                                6, frontend=red_front)
        red_rep = serve.replay(make_prefill_step(red, 14, axo=red_dep),
                               make_decode_step(red, axo=red_dep), red_params, red_toks,
                               red_traj, red_front)
        red_launches = {k: fn.launches - before[k] for k, fn in ssm_wrappers.items()}
        exact_p = serve.replay(make_prefill_step(red, 14, ctx=plain),
                               make_decode_step(red, ctx=plain), red_params, red_toks,
                               red_traj, red_front)
        pre_p = make_prefill_step(red, 14, axo=red_plain, ctx=plain)
        dec_p = make_decode_step(red, axo=red_plain, ctx=plain)
        red_rep_p = serve.replay(pre_p, dec_p, red_params, red_toks, red_traj, red_front)
        spread = max(max(rel_norm(a, b) for a, b in zip(serve.replay(
            pre_p, dec_p, nudge_norms(torch, red_params, seed), red_toks, red_traj, red_front),
            red_rep_p)) for seed in range(2))
        rel_exact = max(rel_norm(a, b) for a, b in zip(exact_lgs, exact_p))
        rel_axo = max(rel_norm(a, b) for a, b in zip(red_rep, red_rep_p))
        limit = max(SERVE_REL, 2 * spread)
        k7_red = sum(k7_per_prefill(red).values()) * 2
        print(f"phase serve-vlm: reduced {red.name} f32, prompt 8 + 5 decode steps: launches "
              f"{red_launches} (K7 expected {k7_red}, K8 {2 * k8_per_prefill(red)}); logits of "
              f"the kernel passes vs plain, max over steps: exact {rel_exact:.3g} (limit "
              f"{SERVE_REL}), AxO teacher-forced {rel_axo:.3g} (limit {limit:.3g}: a one-ulp "
              f"nudge of the norm weights moves the plain AxO pass by {spread:.3g})", flush=True)
        if (red_launches["K7"], red_launches["K8"]) != (k7_red, 2 * k8_per_prefill(red)):
            raise AssertionError(f"the reduced {red.name} passes launched {red_launches}")
        if not (rel_exact <= SERVE_REL and rel_axo <= limit):
            raise AssertionError(f"a reduced {red.name} pass on the kernels differs from its "
                                 f"plain replay")
        del red_params, red_dep, red_plain, red_front

    # MLA's attention at deepseek-v3's prefill: the port's plain direct softmax
    # (q/k width 576, v width 512, one shared KV head, 128 query heads, B=4,
    # S=128 over the 136-slot latent cache), bf16 as served; SDPA beside it
    # on K/V expanded to the 128 heads
    mla = get_arch("deepseek-v3-671b").mla
    qk_w = mla.kv_lora_rank + mla.rope_head_dim
    mla_scale = 1.0 / (mla.nope_head_dim + mla.rope_head_dim) ** 0.5
    mla_q = torch.randn((4, PROMPT_LEN, 128, qk_w), generator=gen, device=dev).to(torch.bfloat16)
    mla_k = torch.randn((4, PROMPT_LEN + GEN_TOKENS, 1, qk_w), generator=gen,
                        device=dev).to(torch.bfloat16)
    mla_v = mla_k[..., :mla.kv_lora_rank]
    mla_pos = torch.arange(PROMPT_LEN, device=dev)

    def mla_attention():
        return attention.direct_attention(mla_q, mla_k, mla_v, causal=True, q_positions=mla_pos,
                                          kv_len=PROMPT_LEN, scale=mla_scale)

    mla_sdpa_args = (mla_q.transpose(1, 2),
                     mla_k[:, :PROMPT_LEN].transpose(1, 2).expand(-1, 128, -1, -1),
                     mla_v[:, :PROMPT_LEN].transpose(1, 2).expand(-1, 128, -1, -1))
    mla_ms = cuda_ms(torch, mla_attention, 20)
    mla_sdpa_ms = cuda_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
        *mla_sdpa_args, is_causal=True, scale=mla_scale), 20)
    mla_bound = bound(2 * (mla_q.numel() + mla_k[:, :PROMPT_LEN].numel()
                           + 4 * PROMPT_LEN * 128 * mla.kv_lora_rank), 0, 0, int_rate,
                      bf16_ops=2.0 * 4 * 128 * (PROMPT_LEN * (PROMPT_LEN + 1) // 2)
                      * (qk_w + mla.kv_lora_rank))
    print(f"phase serve-mla: MLA attention at deepseek-v3's prefill (B=4, H=128, S=128, q/k "
          f"width {qk_w}, v width {mla.kv_lora_rank}, bf16), the port's plain direct softmax: "
          f"{mla_ms:.4f} ms by events (bound {mla_bound[0]:.4g} by {mla_bound[1]}), SDPA on "
          f"K/V expanded to the heads {mla_sdpa_ms:.4f} ms", flush=True)

    # -- train: K7 and K8 under autograd, the reduced archs, granite and mamba2
    segments["train"] = time.perf_counter()
    t0 = time.perf_counter()
    train_stats, train_keep = train_phase(torch, dev, ssm_wrappers, gen)
    t_train = time.perf_counter() - t0
    launches["K7"] += train_stats["granite"]["k7_launches"]
    launches["K8"] += train_stats["mamba2"]["k8_launches"]
    rec["K7"]["train_launches"] = train_stats["granite"]["k7_launches"]
    rec["K8"]["train_launches"] = train_stats["mamba2"]["k8_launches"]
    print(f"phase train: {t_train:.1f} s; {json.dumps(train_stats)}", flush=True)

    # -- shard: the multi-card paths as far as one card allows -----------------
    segments["shard"] = time.perf_counter()
    t0 = time.perf_counter()
    ga_objs, ga_bounds, _ = ga_problem
    shard_stats = shard_phase(torch, dev, ssm_wrappers, (
        spec, train.configs, results["map+ga"].ppf_configs, APPLICATIONS["mnist"](),
        (lambda c: fastmoo.CompiledNSGA2(ga_objs, n_bits=spec.n_luts, pop_size=64, n_gen=20,
                                         ctx=c), (list(range(12)), [ga_bounds] * 12))))
    t_shard = time.perf_counter() - t0
    launches["K7"] += shard_stats["dtensor_train"]["k7_launches"]
    rec["K7"]["shard_launches"] = shard_stats["dtensor_train"]["k7_launches"]
    print(f"phase shard: {t_shard:.1f} s", flush=True)

    # -- dryrun: the dry-run tools on fake worlds, checked against the card ---
    segments["dryrun"] = time.perf_counter()
    t0 = time.perf_counter()
    dryrun_dir = ROOT / "chiprun_out" / "dryrun_torch"
    dryrun_dir.mkdir(parents=True, exist_ok=True)
    dryrun_stats = dryrun_cells(str(dryrun_dir))
    dryrun_stats["cross_check"] = dryrun_cross_check(
        torch, dev, train_keep["granite"], train_stats["granite"]["peak_bytes"])
    dryrun_stats["ops"] = ops_vs_raw(torch, dev, gen)
    for k, v in dryrun_stats["ops"].items():
        rec[k].update(v)
    t_dryrun = time.perf_counter() - t0
    dryrun_stats["phase_s"] = t_dryrun
    (ROOT / "chiprun_out" / "dryrun_phase.json").write_text(json.dumps(
        {k: v for k, v in dryrun_stats.items() if k != "records"}, indent=1, default=str))
    print(f"phase dryrun: {t_dryrun:.1f} s; cells "
          f"{ {k: round(v, 1) for k, v in dryrun_stats['wall_s'].items()} }", flush=True)

    # -- device time of K8, K6 and K7 -----------------------------------------
    segments["device-time"] = time.perf_counter()
    # first, one train step of granite-3-2b and one of mamba2-130m, each after
    # a warm one: the device time split by kernel and range; then their state
    # is freed
    for label, kept in train_keep.items():
        train_stats[label]["profile"] = profile_train(torch, label, *kept)
    del train_keep, kept
    gc.collect()
    torch.cuda.empty_cache()
    # torch.profiler's device time per call, beside the CUDA-event times of
    # phase 3 (which count the host's time to issue a call where it is the
    # longer), taken last: after a profiler session the host issues every
    # launch more slowly, which would move the host-bound times of the phases
    # above.  Fresh codes and inputs of each shape; these launches count nowhere.
    # K8 first, at mamba2's prefill in bf16
    x, dt, a, bm, cm = ssd_inputs(torch, SSM_SHAPE, torch.bfloat16, gen)
    k8_dev = device_ms(torch, lambda: ssd_scan.ssd_scan(x, dt, a, bm, cm), 10)
    print(f"phase device-time: K8 at mamba2 prefill bf16: {fmt_ms(k8_dev)} on the device",
          flush=True)
    rec["K8"]["device_ms"] = k8_dev
    del x, dt, a, bm, cm
    for label, (m, k, n) in k6_shapes.items():
        if m > K6_PROFILED_MAX_M:
            print(f"phase device-time: K6 at {label} M={m} K={k} N={n}: not profiled (M > "
                  f"{K6_PROFILED_MAX_M})", flush=True)
            if label == "gate/up prefill":
                rec["K6"].update(device_ms=None, library_device_ms=None)
            continue
        f_t, g_t, sv_t = tabs["random36" if "random36" in label else "demo"]
        a = torch.randint(0, 256, (m, k), generator=gen, device=dev, dtype=torch.uint8)
        bb = torch.randint(0, 256, (k, n), generator=gen, device=dev, dtype=torch.uint8)
        al, ac = a.long(), bb.long()
        a_cat = torch.cat([sv_t[al]] + [f_t[:, r][al] for r in range(AXO_RANK)], 1)
        b_cat = torch.cat([sv_t[ac]] + [g_t[:, r][ac] for r in range(AXO_RANK)], 0)
        k6_dev = device_ms(torch, lambda: axo_matmul.axo_matmul(a, bb, f_t, g_t, sv_t), 10)
        lib_dev = device_ms(torch, lambda: a_cat @ b_cat, 10)
        del al, ac, a_cat, b_cat
        print(f"phase device-time: K6 at {label} M={m} K={k} N={n}: {fmt_ms(k6_dev)} on "
              f"the device, one cuBLAS f32 GEMM at K(1+R) {fmt_ms(lib_dev)}", flush=True)
        if label == "gate/up prefill":
            rec["K6"].update(device_ms=k6_dev, library_device_ms=lib_dev)
    for label, (s_q, cap) in {"serve prefill": (128, 144), "ragged": (77, 93)}.items():
        q = torch.randn((4, 32, s_q, 64), generator=gen, device=dev).to(torch.bfloat16)
        kk, vv = (torch.randn((4, 8, cap, 64), generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(2))
        k_rep = kk[:, :, :s_q].repeat_interleave(4, dim=1)
        v_rep = vv[:, :, :s_q].repeat_interleave(4, dim=1)
        k7_dev = device_ms(torch, lambda: flash_attention.flash_attention(
            q, kk, vv, kv_len=s_q), 50)
        lib_dev = device_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k_rep, v_rep, is_causal=True), 50)
        print(f"phase device-time: K7 at {label} S={s_q} cache {cap} bf16: {fmt_ms(k7_dev)} "
              f"on the device, SDPA {fmt_ms(lib_dev)}", flush=True)
        if label == "serve prefill":
            rec["K7"].update(device_ms=k7_dev, library_device_ms=lib_dev)
    # K7 at the new head widths: each arch's prefill, bf16
    for label, (h_q, g_kv, hd) in K7_WIDE.items():
        key = "K7W" if hd == 128 else "K7X"
        q = torch.randn((4, h_q, PROMPT_LEN, hd), generator=gen, device=dev).to(torch.bfloat16)
        kk, vv = (torch.randn((4, g_kv, PROMPT_LEN + GEN_TOKENS, hd), generator=gen,
                              device=dev).to(torch.bfloat16) for _ in range(2))
        k_rep = kk[:, :, :PROMPT_LEN].repeat_interleave(h_q // g_kv, dim=1)
        v_rep = vv[:, :, :PROMPT_LEN].repeat_interleave(h_q // g_kv, dim=1)
        k7_dev = device_ms(torch, lambda: flash_attention.flash_attention(
            q, kk, vv, kv_len=PROMPT_LEN), 50)
        lib_dev = device_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k_rep, v_rep, is_causal=True), 50)
        print(f"phase device-time: K7 at {label}'s prefill hd {hd} bf16: {fmt_ms(k7_dev)} on "
              f"the device, SDPA {fmt_ms(lib_dev)}", flush=True)
        rec[key]["shapes"][label].update(device_ms=k7_dev, library_device_ms=lib_dev)
        if "device_ms" not in rec[key]:
            rec[key].update(device_ms=k7_dev, library_device_ms=lib_dev)
    # K7 non-causal at slice 4's three shapes, K6 at K6_NEW's shapes, K8 at
    # jamba's prefill and MLA's plain attention, bf16
    for label, (h_q, g_kv, s_q, s_kv, hd) in K7_NC.items():
        q = torch.randn((4, h_q, s_q, hd), generator=gen, device=dev).to(torch.bfloat16)
        kk, vv = (torch.randn((4, g_kv, s_kv, hd), generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(2))
        k_rep = kk.repeat_interleave(h_q // g_kv, dim=1)
        v_rep = vv.repeat_interleave(h_q // g_kv, dim=1)
        k7_dev = device_ms(torch, lambda: flash_attention.flash_attention(
            q, kk, vv, causal=False), 20)
        lib_dev = device_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k_rep, v_rep), 20)
        print(f"phase device-time: K7 non-causal at {label} bf16: {fmt_ms(k7_dev)} on the "
              f"device, SDPA {fmt_ms(lib_dev)}", flush=True)
        rec["K7N"]["shapes"][label].update(device_ms=k7_dev, library_device_ms=lib_dev)
        if rec["K7N"].get("device_ms") is None:     # the first shape the profiler measured
            rec["K7N"].update(device_ms=k7_dev, library_device_ms=lib_dev)
        del q, kk, vv, k_rep, v_rep
    f_t, g_t, sv_t = tabs["demo"]
    for label, (m, k, n, key, filled) in K6_NEW.items():
        if m > K6_PROFILED_MAX_M:
            print(f"phase device-time: K6 at {label} M={m} K={k} N={n}: not profiled (M > "
                  f"{K6_PROFILED_MAX_M})", flush=True)
            rec[key]["shapes"][label].update(device_ms=None, library_device_ms=None)
            rec[key].setdefault("device_ms", None)
            rec[key].setdefault("library_device_ms", None)
            continue
        a = torch.randint(0, 256, (m, k), generator=gen, device=dev, dtype=torch.uint8)
        a[filled:] = 0
        bb = torch.randint(0, 256, (k, n), generator=gen, device=dev, dtype=torch.uint8)
        al, ac = a.long(), bb.long()
        a_cat = torch.cat([sv_t[al]] + [f_t[:, r][al] for r in range(AXO_RANK)], 1)
        b_cat = torch.cat([sv_t[ac]] + [g_t[:, r][ac] for r in range(AXO_RANK)], 0)
        del al, ac
        k6_dev = device_ms(torch, lambda: axo_matmul.axo_matmul(a, bb, f_t, g_t, sv_t), 10)
        lib_dev = device_ms(torch, lambda: a_cat @ b_cat, 10)
        print(f"phase device-time: K6 at {label} M={m} K={k} N={n}: {fmt_ms(k6_dev)} on the "
              f"device, one cuBLAS f32 GEMM at K(1+R) {fmt_ms(lib_dev)}", flush=True)
        rec[key]["shapes"][label].update(device_ms=k6_dev, library_device_ms=lib_dev)
        if rec[key].get("device_ms") is None:     # the first shape the profiler measured
            rec[key].update(device_ms=k6_dev, library_device_ms=lib_dev)
        del a, bb, a_cat, b_cat
    x, dt, a, bm, cm = ssd_inputs(torch, JAMBA_SSM_SHAPE, torch.bfloat16, gen)
    rec["K8H"]["device_ms"] = device_ms(torch, lambda: ssd_scan.ssd_scan(x, dt, a, bm, cm), 20)
    del x, dt, a, bm, cm
    mla_dev = device_ms(torch, mla_attention, 10)
    mla_sdpa_dev = device_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
        *mla_sdpa_args, is_causal=True, scale=mla_scale), 10)
    print(f"phase device-time: K8 at jamba's prefill bf16: {fmt_ms(rec['K8H']['device_ms'])}; "
          f"MLA attention at deepseek-v3's prefill (plain direct softmax): {fmt_ms(mla_dev)} on "
          f"the device ({mla_ms:.4f} ms by events), SDPA on expanded K/V "
          f"{fmt_ms(mla_sdpa_dev)}", flush=True)
    del mla_q, mla_k, mla_v, mla_sdpa_args
    # K2 and K5, both designs, at phase 3's D and at their path launch's D:
    # where the CUDA-event time exceeds this, the host's issue bounds a call
    for key, label, new_fn, first_fn, args in (
            ("K2", "D=258", char_kernels.behav_stats_entry,
             char_kernels.behav_stats_entry_first, (masks, 8, a_tile)),
            ("K2", f"path D={k2_d}", char_kernels.behav_stats_entry,
             char_kernels.behav_stats_entry_first, k2_path),
            ("K5", "mnist D=128", app_kernels.entry_gemv, app_kernels.entry_gemv_first,
             k5_mnist),
            ("K5", f"path D={k5_d}", app_kernels.entry_gemv, app_kernels.entry_gemv_first,
             k5_calls[0])):
        dev_new = device_ms(torch, lambda: new_fn(*args), 50)
        dev_first = device_ms(torch, lambda: first_fn(*args[:3] if key == "K2" else args), 50)
        print(f"phase device-time: {key} at {label}: {fmt_ms(dev_new)} on the device "
              f"(first design {fmt_ms(dev_first)})", flush=True)
        where = rec[key] if label.startswith(("D=258", "mnist")) else rec[key]["path"]
        where.update(device_ms=dev_new, old_device_ms=dev_first)
    # K2's walk at 4 and at 1 configs a thread: which tier leaves the card
    # less idle at a small D
    for label, args, where in (("D=258", (masks, 8, a_tile), rec["K2"]),
                               ("D=37", (masks_r, 8, a_tile), rec["K2"]["ragged"]),
                               (f"path D={k2_d}", k2_path[:3], rec["K2"]["path"])):
        tiers = {g: device_ms(torch, lambda: char_kernels.behav_stats_entry_at(*args, g), 50)
                 for g in (4, 1)}
        print(f"phase device-time: K2 at {label}: 4 configs a thread {fmt_ms(tiers[4])}, 1 "
              f"config a thread {fmt_ms(tiers[1])} on the device (the rule takes "
              f"{char_kernels.entry_configs(args[0].shape[0], 8, a_tile, n_sms)})", flush=True)
        where["tiers_device_ms"] = tiers
    print(f"phase device-time: torch.profiler windows that held no device events: "
          f"{PROFILER_EMPTY['empty']} of {PROFILER_EMPTY['windows']}", flush=True)

    # -- obs: the registry's profile of every kernel (after the timed phases)
    segments["profile"] = time.perf_counter()
    t0 = time.perf_counter()
    hw = HW.h100_sxm()
    # at the main paths' shapes: K1/K2 at the training set's 1,024-config
    # chunk, K3 at the GA's 128-row ranking, K4/K5 at the mnist head, K6 at
    # granite's gate/up prefill, K7 at granite's prefill, K8 at mamba2's
    prof_shapes = {
        "fastchar": dict(d=1024), "fastmoo": dict(p=128),
        "fastapp": dict(d=128, m=250, k=256, n=10),
        "axo_matmul": dict(m=512, k=2048, n=8192, rank=AXO_RANK),
        "attention": dict(b=4, h=32, g=8, s=128, hd=64),
        "ssd_scan": dict(zip(("b", "s", "h", "g", "p", "n"), SSM_SHAPE), chunk=K8_Q)}
    for r in profile_registry(tel=obs.GLOBAL, device=dev, shapes=prof_shapes):
        if r.name == "fastapp.gemm":
            print(f"phase obs: profile fastapp.gemm (the plain route): FlopCounterMode "
                  f"{r.cost['flops']:.4g} FLOPs vs cost_fn {r.estimate['flops']:.4g} "
                  f"(ratio {r.divergence['flops']:.3g}, flagged {list(r.flagged)})", flush=True)
            continue
        print(f"phase obs: profile {r.name} at {r.extra['shape']}: {r.cost['ms']:.4f} ms (CUDA "
              f"events), cost_fn {r.estimate}; bound on {hw.name} {r.extra['bound_ms']:.5f} ms "
              f"by {r.extra['bound_by']} ({r.extra['bytes_moved']} bytes of operands and "
              f"outputs, cost_fn's FLOPs at the {r.extra['peak_type']} peak), "
              f"{r.extra['bound_share']:.2%} of it reached"
              + (f"; plain version's FlopCounterMode FLOPs {r.cost['plain_flops']:.4g} vs "
                 f"cost_fn (ratio {r.divergence['flops']:.3g}, flagged {list(r.flagged)})"
                 if "plain_flops" in r.cost else ""), flush=True)
    t_obs += time.perf_counter() - t0
    print(f"phase obs: profile.traces {obs.GLOBAL.counter('profile.traces')}; obs phase "
          f"{t_obs:.1f} s", flush=True)

    # -- sync: one ranking under the sync debugger ---------------------------
    segments["sync"] = time.perf_counter()
    # last, because switching the debugger slows every later host-issued
    # launch; a ranking of the main path's shape must not sync the host (the
    # fronts' count stays on the card).  A ranking's time before and after
    # the switch is printed to show that cost
    rank_ms = cuda_ms(torch, lambda: fastmoo.constraint_ranks(o_r, v_r), 200)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rank_r = fastmoo.constraint_ranks(o_r, v_r)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not torch.equal(rank_r, fastmoo.constraint_ranks(o_r, v_r, impl="plain")):
        raise AssertionError("K3's ranking differs from the plain ranking")
    rank_after_ms = cuda_ms(torch, lambda: fastmoo.constraint_ranks(o_r, v_r), 200)
    print(f"phase sync: one constraint_ranks call (P=128) under "
          f"torch.cuda.set_sync_debug_mode('error'): no host sync, ranks == plain; a ranking "
          f"{rank_ms:.4f} ms before the debugger was switched, {rank_after_ms:.4f} ms after",
          flush=True)
    # the tapped GA's generation loop (phase 5's problem, population 64 x 100)
    # under the debugger: its per-generation rows reach the host without a
    # sync.  Its setup (the seed pool and reference copied to the card) and
    # its results (the archive copied back) sync once each, outside the loop
    ga_objs, (ga_mb, ga_mp), ga_ref = ga_problem
    tap_ctx = ExecutionContext(telemetry="on")
    runner = fastmoo.CompiledNSGA2(ga_objs, n_bits=spec.n_luts, pop_size=64, n_gen=100,
                                   hv_ref=ga_ref, ctx=tap_ctx)
    state = runner._setup([0], [(ga_mb, ga_mp)], [None], tapped=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        runner._generations(state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    t_loop = time.perf_counter() - t0
    tapped_run = runner._results(state)[0]
    obs.flush()
    rows = tap_ctx.telemetry.series["fastmoo.gen"]
    untapped_run = fastmoo.CompiledNSGA2(ga_objs, n_bits=spec.n_luts, pop_size=64, n_gen=100,
                                         hv_ref=ga_ref, ctx=ctx).run(0, ga_mb, ga_mp)
    print(f"phase sync: the tapped GA's 100 generations under "
          f"torch.cuda.set_sync_debug_mode('error') in {t_loop:.2f} s: no host sync; "
          f"fastmoo.gen rows {len(rows)}, last hv {float(rows[-1]['hv'])!r} vs hv_history "
          f"{tapped_run.hv_history[-1][1]!r}; hv_history == the untapped run's: "
          f"{tapped_run.hv_history == untapped_run.hv_history}", flush=True)
    if len(rows) != 100 or tapped_run.hv_history != untapped_run.hv_history:
        raise AssertionError("the tapped GA under the sync debugger: rows or hv_history differ")

    kernels = []
    for k, r in rec.items():
        kernels.append({
            "name": r["name"], "route": "cuda", "source": r["source"],
            "replaces": r["replaces"], "launches": launches[k], "max_abs_err": err[k],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r.get("library_ms"),
            **{key: r[key] for key in ("device_ms", "library_device_ms", "old_ms", "grids",
                                       "dominance_counts_ms", "route", "staged_ms", "shapes",
                                       "boundary", "old_bound_ms", "old_device_ms", "splits",
                                       "configs_a_thread", "ragged", "path", "bound_term",
                                       "tiers_ms", "tiers_device_ms", "per_lane_ms",
                                       "wrapped_configs", "library_reason",
                                       "train_launches", "shard_launches", "op_ms",
                                       "raw_ms", "wrapper_ms")
               if key in r},
        })
    print(f"phase done: {time.perf_counter() - t_start:.1f} s (main path {t_main:.1f} s, apps "
          f"{t_app:.1f} s, of which attaching app BEHAV {t_multi:.2f} s; wide {t_wide:.1f} s, "
          f"sweep {t_sweep:.1f} s, service {t_svc:.1f} s, serve-dense {t_dense:.1f} s, "
          f"serve-moe {t_moe:.1f} s, "
          f"{', '.join(f'{k} {v:.1f} s' for k, v in t_slice4.items())}, train "
          f"{t_train:.1f} s, shard {t_shard:.1f} s, dryrun {t_dryrun:.1f} s, obs "
          f"{t_obs:.1f} s)", flush=True)
    ends = [*list(segments.values())[1:], time.perf_counter()]
    print(f"phase wall: wall-clock by section (s): "
          f"{ {k: round(e - b, 1) for (k, b), e in zip(segments.items(), ends)} }", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
