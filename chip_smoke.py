"""On-card smoke run of the PyTorch/CUDA port (one NVIDIA H100).

    python3 chip_smoke.py             # the whole check, as below

Phases, each fatal on failure (the script then exits non-zero and prints
no result line; each logs its seconds, and the summary holds them). The
paths that only check run the UNet at SHALLOW_STAGES (1/1/3/1 blocks per
stack, every width, batch and latent the default's): the fp32 card-vs-CPU
train steps of phases 14-16, phase 14's state round trip and run loop,
and phases 17 and 18; every launch count, pipelined split and state
share there is derived from that config.
  1. build the CUDA kernels from kernels/csrc (one nvcc per source, in
     parallel); print the build seconds and the card's name and power limit;
  2. hold each kernel against its plain PyTorch version at every call
     shape of the sampling path (batch 1 and 4, plus block_core at latent
     64) and, for the two backward kernels and the window MHA and
     ffn_block forwards, of the training path (batch 8), in fp32 with
     TF32 off and in bf16; time kernel, plain version and (window MHA,
     forward and backward) the one-call PyTorch equivalent with a cold
     L2, printing bound/kernel (and kernel/library) per row and per step
     of each path of window MHA and the FFN kernels, and block_core's
     per B=1 step (latent 32 and 64) beside ffn_block plus the plain
     grouped conv at the same shapes; hold block_core's gradients through
     the card path against autograd through its plain version (B=1
     shapes, fp32 and bf16); block_core (full-precision and int8 FFN
     weights, batch 1, latent 32 and 64) and the int8 ffn_block (batch 4)
     in both types, each call rerun bitwise and once more with every
     buffer its wrapper allocates between sentinel guards (ffn_block at
     every shape too); the int8 routes per step beside the same kernel
     with bf16 weights;
  3. sample one 256px image with the default UNet and VAE decoder (seeded
     random weights, 20 DDIM steps, bf16): launch counts must be exactly
     720 block_core and 160 window MHA; then images/s and a profile of
     one sample (device-busy time);
  4. sample 4 images in one call: 720 ffn_block launches, 0 block_core,
     images/s and a profile of one sample;
     then the same two paths with int8 FFN weights (the same seeded
     weights, ffn_quant='int8'): 720 int8 block_core and 160 window MHA
     per B=1 sample, 720 int8 ffn_block per B=4 sample, no weight
     quantized by a sample call, images/s, device-busy time, and the
     final latent's relative L2 distance from full precision's (same x_T
     and routing; reported, not gated);
  5. one full-width denoise step in fp32 on the card against the same
     weights on the CPU (plain versions), for the UNet with full-precision
     and with int8 FFN weights (whose int8 weights and scale-bias rows,
     made on each side, must be equal), at B=1 (block_core) and B=4
     (ffn_block);
  6. train: the default UNet (fp32 parameters, bf16 compute) on B=8
     seeded 32x32x8 latents, AdamW lr 1e-4, EMA 0.999, eps-prediction L1,
     stochastic depth 0.25: one warm-up step, then 5 timed steps that must
     launch exactly 36 ffn_block, 36 ffn_block_bwd, 8 window MHA, 8 window
     MHA backward and 0 block_core per step, with a finite loss, finite
     parameters and a gradient tensor on every parameter; then steps/s,
     images/s and a profile of one step;
  7. one fp32 train step at B=4 on the card against the same step on the
     CPU (plain versions), t, noise, routing and gates injected: the loss
     within 1e-4 relative, each gradient within 1e-3 of its own max abs
     (a ReLU-boundary flip excepted, see FLIP_REL_TOL), and every slice
     that is zero on the CPU zero on the card;
  8. VAE + discriminator training: the default VAEConfig and
     DiscriminatorConfig (fp32 parameters, bf16 compute, Adafactor on
     both nets) on B=8 seeded 512px images cropped to 192: one warm-up
     step, then 5 timed steps that must launch exactly 1 vq and 0 of
     every other kernel per step, with finite metrics and parameters and
     a gradient tensor on every parameter; then steps/s, images/s and a
     profile of one step;
  9. one fp32 VAE train step at B=2, crop 192, on the card against the
     same step on the CPU (plain versions), crop offset and noise
     injected: the five metrics within 1e-4 relative, each gradient
     within 1e-3 of its own max abs (the codebook rows the two sides
     selected differently excepted), and Adafactor on the card over the
     CPU's gradients within 1e-4 of each element's step (plus 1e-6 of
     max abs) of the CPU's updated parameters (see VAE_OPT_STEP_REL); the
     parameters after the two steps are reported.
  10. class-conditional sampling (the default UNet with num_classes=3,
     the conditional operating point of QUALITY_COND_r05.json, and the
     default decoder; 256px, bf16, seeded weights), classifier-free
     guidance at 3.0, 20 DDIM steps: exactly 1440 block_core and 320
     window MHA per B=1 sample; at B=4 one call mixing per-sample scales
     [1, 3, 3, 5], rescales [0, 0, 0.7, 0] and one negative class, 1440
     ffn_block and 320 window MHA; int8 FFN weights at B=1, 1440 int8
     block_core; images/s (3 timed calls after a warm-up) and a profile
     of one sample each; then DPM-Solver++(2M) at 10 steps (360
     block_core, 80 window MHA) and DeepCache at interval 2 over 20 DDIM
     steps (420 block_core, 100 window MHA) on the unconditional UNet of
     phase 3, images/s each;
  11. one guided fp32 prediction of the conditional UNet (both branches
     under one routing plan, rescale 0.7) on the card against the CPU, at
     STEP_REL_TOL of scale;
  12. parameter files: the conditional UNet written (flax msgpack, under
     build/) and read into a fresh UNet on the card, every parameter
     bitwise equal, and a B=1 CFG sample from it bitwise the in-memory
     weights' sample; write and read seconds; then the sampling CLI on
     that file (3 classes, class 1, guidance 3, DPM-Solver++ at 10 steps,
     two 256px PNGs under build/).
  13. serving: the port's SamplerServer over cli/serve.make_variants on
     the conditional UNet of phase 10 with a seeded default encoder
     (256px, bf16, buckets 1 2 4 8, a step tier 10 beside the default 20,
     img2img strength 0.6). Four fixed groups, each queued before its
     server's worker starts: 8 unconditional seeds (one bucket-8
     dispatch, 720 ffn_block, 160 window MHA), 3 guided requests (scales
     3, 3, 5, one rescale 0.7, one negative class; bucket 4 with one
     padded row, 1440 ffn_block, 320 window MHA), one request at tier 10
     (bucket 1, 360 block_core, 80 window MHA), and 2 img2img requests,
     one with a kept region (bucket 2, 36 block_core and 8 window MHA per
     UNet call of the sub-schedule): exact launch counts and stats per
     group, and every served image bitwise the direct LDMPipeline.sample
     or img2img call at that bucket with the same noise rows and padding.
     The img2img path's new work (the Encoder at 256px, q_sample, the mask
     resize, one projected DDIM step) in fp32 on the card against the CPU
     at STEP_REL_TOL of scale. HTTP on loopback with PNG bodies: GET
     /sample decodes to the server's own image for that seed, POST
     /sample_batch with 4 mixed items returns X-Index 0-3, /metrics,
     /healthz, a class_id out of range is 400 and a full queue 503.
     Reported: 64 requests queued at once (images/s, mean batch, which
     must be 8, p50/p99 latency, the card's busy share from a profiled
     second run) and the largest uint8 difference between a seed served
     at bucket 1 and inside bucket 8.
  14. the training surface at full width: the default UNet with 3
     classes, B=8, bf16 compute, AdamW 1e-4, EMA 0.999, labels 0-2 at
     cond-drop 0.1. (1) a warm-up and 5 conditional train steps: exactly
     36 ffn_block, 36 ffn_block_bwd, 8 window MHA and 8 backward per
     step, finite losses, parameters and EMA, a gradient on class_embed;
     steps/s, peak memory and a profile of one step. (4, run next) the
     state of the conditional UNet at SHALLOW_STAGES after two steps:
     TrainCheckpointer writes it (~2.1 GB under build/) and restores it
     into fresh modules on the card: every tensor, the step and the
     generator's state bitwise; one more step from each within the train
     tolerances; bytes, write and read seconds; then the default VAE and
     discriminator with Adafactor after one step, the same round trip,
     bitwise. (2) phase 7 on the conditional UNet at SHALLOW_STAGES with
     class ids (the null class among them) injected. (3) one step with
     remat=True from the same weights and draws as one without: 72
     ffn_block, 36 backward, 16 window MHA and 8 backward; the loss equal
     and each gradient within 1e-3 of its max abs (largest reported); the
     memory the forward keeps for the backward must be lower with remat;
     3 timed steps each (time, peak above their starting memory, a
     profile); one step each at B=32, whose peak of forward and backward
     must be lower with remat (at B=8 the gradients set that peak either
     way). (5) cli/train_ldm.train_loop on the conditional UNet at
     SHALLOW_STAGES over in-memory seeded latents, 12 steps at
     --fused-steps 2 --save-every 6 --val-every 6 --val-batches 2: saves
     at steps 2, 8 and 12 (the JAX trainer's cadence on the batch index),
     the last two checkpoints kept and read back (the last bitwise), the
     parameter and EMA files read back bitwise, one JSON record at step
     10 (with loss_gmax), validations at steps 6 and 12 with finite
     val_loss and val_loss_ema and exactly the launches of 2 x 8 x 2 B=8
     forwards each (parameters and EMA, 8 grid points, 2 batches).
  15. the pixel DDPM and the reference's torch files at full width: the
     default UNet with input_channels=3 at 32px (its maps are the latent
     path's). Phase 2 holds ffn_block, ffn_block_bwd and window MHA both
     ways at every call shape of a B=16 train step (workloads.train_calls
     (16)) as at its other shapes, each call rerun bitwise and once more
     between sentinel guards, with its per-step time and bound. (1) a
     warm-up and 5 train steps at B=16 (seeded images in [-1, 1], bf16
     compute, RAdam 1e-4, EMA 0.999; the 6th step in all RAdam's first
     rectified one): exactly 36 ffn_block, 36 ffn_block_bwd, 8 window MHA
     and 8 backward per step, finite losses, parameters and EMA, a
     gradient on every parameter; steps/s, peak memory and a profile of
     one step; the trainer's save writes the parameter and EMA files.
     (2) cli/sample_ddpm on that file (-n 2 -t 20): the file's weights
     bitwise in its UNet, exactly 720 block_core and 160 window MHA per
     image, two 32px PNGs; then DDPMPipeline at B=1 (DDIM-20), B=4 (720
     ffn_block), DPM-Solver++ 10 steps (360 + 80) and DeepCache interval
     2 (420 + 100), images/s and device busy each. (3) the DDPM UNet
     written with torch_export.export_ddpm and read back through
     sample_ddpm's loader: every parameter bitwise, and its B=1 sample
     bitwise the in-memory weights'; cli/convert .pt -> msgpack ->
     --to-torch bitwise; the same round trip for the default VAE's four
     models through the trainers' loader; write and read seconds. (4)
     phase 7 on the 3-channel UNet at SHALLOW_STAGES with RAdam, then
     RAdam on the card
     over the CPU's gradients for 7 steps (1-5 unrectified, 6-7
     rectified) against the CPU's, at phase 9's per-element tolerance.
  16. training through int8 FFN weights, k-of-E routing, branch ablation
     and KID, at full width. Phase 2 holds every kernel call of the int8
     train steps against its plain version in both types, rerun bitwise
     and between sentinel guards: at B=8 the int8 ffn_block and
     ffn_block_bwd on the int8 round trip of its weights
     (workloads.dequantized_bwd_inputs); at B=2 the int8 block_core,
     window MHA both ways and ffn_block_bwd (round trip); and ffn_block at
     the B=1 shapes of the conv-ablated UNet (the "split" rows). (1)
     phase 6's trainer on the default UNet with ffn_quant='int8': a
     warm-up and 5 steps of exactly 36 int8 ffn_block, 36 ffn_block_bwd,
     8 window MHA, 8 backward and 0 full-precision ffn_block each, and 216
     quantize_cols calls per step; finite losses, fp32 parameters and
     EMA; steps/s, peak memory, a profile of one step; then one remat
     step (72 int8 ffn_block, 16 window MHA, still 216 quantizations: the
     recompute makes none) and one B=2 step (36 int8 block_core, 36
     ffn_block_bwd). (2) phase 7 on the int8 UNet at SHALLOW_STAGES (its own flip budget,
     INT8_FLIP_TENSORS), the int8 weights and scale-bias rows of both
     sides equal, and the straight-through identity: the card's gradients
     against the same step of a full-precision UNet on the card holding
     the dequantized weights, within phase 7's gradient gate. (3) the
     default UNet with each of norm, film, moe, conv and attn skipped and
     with 3 experts per call, beside the full model: the launches of a
     20-step B=1 sample (attn skipped: 720 block_core, 0 window MHA; conv
     skipped: 720 ffn_block, 160 window MHA; the rest: no FFN kernel, 160
     window MHA), and one bf16 denoise step at B=1 and B=4 through
     utils/profiling (chained_time, trace; traces under
     build/chip_smoke_traces/), each branch's cost the full model's time
     less its ablation's; every final latent finite but no_norm's (its
     activations overflow bf16). (4) patched KID (utils/quality.py) of two
     seeded sets of 64 smooth 256px images, the second noised, through
     the default Encoder and through random_conv_features: fp32 card vs
     CPU within 1e-3 relative, seconds per call in bf16 and fp32.
  17. parallel training (PERF.md §4), the UNet at SHALLOW_STAGES but
     the CLI of (f): (a) two spawned ranks sharing the
     card over gloo (one card cannot hold two NCCL ranks), each a
     data-parallel rank of the default UNet's train step at global B=8
     (bf16, AdamW, EMA): a warm-up and 2 timed steps of exactly 36
     ffn_block, 36 ffn_block_bwd, 8 + 8 window MHA per rank, both ranks'
     parameters bitwise equal; an fp32 DP step against the 1-process B=8
     step on the card (loss within 1e-5, gradients by phase 7's rule);
     (b) the same steps with ZeRO-1: parameters and losses bitwise (a)'s,
     each rank's optimizer state at most 0.55 of (a)'s, the state file
     (moments gathered, rank 0 writes) restored into a 1-process state
     bitwise; (c) a step through a 1-rank NCCL group; (d) the default
     UNet pipelined in 3 stages on the card at B=6 (54 block_core, 18
     ffn_block, 72 ffn_block_bwd, 8 + 8 window MHA per step) and an fp32
     pipelined step against the plain one; (e) VAE DP, one vq per rank
     per step, parameters bitwise across ranks; (f) `python -m
     ...cli.train_ldm` in two processes of one group on seeded 256px
     PNGs, rank 0 alone writing. Steps/s, the device-busy ms of one
     profiled step, the all-reduce wall and the peak memory of each,
     beside the card's name and power limit.
  18. the mesh layouts (PERF.md §4), the UNet at SHALLOW_STAGES, in
     one group of 4 processes sharing the card over gloo: (a) TP and (b)
     EP (data 1 x model 2), (c) SP (data 1 x model 2, 16 of the latent's
     32 rows per rank) on a mesh of the first 2, (d) multi-slice (replica
     2 x data 2 x model 1) on all 4. Each: one fp32 step at global B=4
     (TF32 off, phase 7's draws injected) against the 1-process fp32 step
     on the card, (a) and (b) bitwise on every rank (the loss, and the
     rank's slice of every gradient and updated parameter), (c)
     and (d) by phase 17's rules (the ranks' preactivation records merged
     by rows or by height); then a warm-up and 2 timed bf16 steps at
     global B=8 (AdamW, EMA): exactly phase 6's launches per rank for
     (a)-(c), 36 block_core, 36 ffn_block_bwd, 8 + 8 window MHA for (d)'s
     B=2 ranks; finite losses; the whole parameters bitwise equal across
     ranks; steps/s per rank, device busy and the collectives' host spans
     of one profiled step (rank 0), peak memory, and for (a) and (b) the
     parameter and optimizer-state bytes per rank, at most 0.51 of a DP
     rank's.
  19. the data cache: the native decoder's build seconds, or the
     compiler's line where it cannot be built; 64 seeded 512px JPEGs and
     PNGs cached through it and through PIL (images/s each; native within
     0.08 mean of PIL, the pad rows equal), each rebuilt from its cache
     with 0 decodes and the same bits; the latent cache at 256px with the
     default encoder on the card, rebuilt with 0 encoder calls and the
     same bits; `cli/train_vae` for one epoch (8 steps of B=8, 512px, crop
     192) from the image cache, which must exit 0 and decode nothing.
  20. the CLIs' default size, 512px (latent 64x64x8), the default UNet and
     decoder at full width, seeded: (a) cli/sample_ldm at its defaults
     (fp32) in working directories under build/, -n 1, -n 4, --quant int8
     and -n 4 --quant int8: exactly 20 UNet calls' launches at that batch
     each (720 block_core, 720 ffn_block, 720 int8 block_core, 720 int8
     ffn_block, and 160 window MHA) and its 512x512 PNGs, then one more
     call of each under the profiler for the card's busy time in it; (b) LDMPipeline.sample at
     512px, bf16, DDIM-20, B=1 (720 block_core, 160 window MHA) and B=4
     (720 ffn_block), (c) B=1 with int8 FFN weights (720 int8
     block_core): images/s, a profiled call's device busy, peak memory;
     (d) one fp32 UNet call at latent 64 card vs CPU at STEP_REL_TOL of
     scale; (e) cli/train_ldm at its defaults (fp32, -b 1) for one epoch
     of 2 seeded 512px PNGs in a working directory under build/: 2 steps
     of exactly 36 block_core, 36 ffn_block_bwd, 8 + 8 window MHA, finite
     losses, the last step profiled (its device busy); (f) the bf16 train
     step at B=8 (the ffn_block route): a warm-up and 3 steps of exactly
     phase 6's launches, steps/s, device busy, peak; (g) phase 7 at B=1 on 64x64 latents (the block_core
     route, 4,096 rows); (h) one SamplerServer over make_variants(pipe,
     [256, 512]) on the conditional UNet: plain and guided requests of
     both sizes queued together, one dispatch per variant at its bucket
     with exact launches, every 512px image bitwise the direct
     pipe.sample from draw_noise rows.
`--phase 2 17 18 19 20` runs phase 1 and the given phases alone, each
even after another fails; exit 1 on any failure, no result line.
Phase 2 also holds every kernel call of phase 17's paths (one rank's
B=4 train step, the pipelined B=6 step, one rank's VAE step; tags
dp2_train, gpipe3_train, dp2_vae_train) and the FFN calls of an EP rank's
B=8 step (its blocks hold 2 experts; tag ep2_train), rerun bitwise
between guards. These rows and their per-step sums are the default
UNet's, whose call shapes hold those of the same paths at SHALLOW_STAGES
(where only enc_stage_2 pipelines). (TP ranks call the kernels at phase 6's shapes;
multi-slice ranks block_core at the pipelined step's B=2 shapes and
window MHA and ffn_block_bwd at the int8 B=2 step's; an SP rank's FFN
calls have a DP rank's row counts.)
Phase 2 also holds every kernel call of the 512px paths in both types
(tags b1-64: block_core and window MHA of a B=1 sample; b4-64: a B=4
sample, and its int8 ffn_block; train64: the B=8 train step; train64_b1:
the B=1 train step's block_core without residual and its backward
kernels), rerun bitwise between guards, with per-step times and bounds.
Phase 2 times the fp32 calls of the paths that sample_ldm and train_ldm
run at their default precision (FP32_TIMED_TAGS: b1, b1-64, b4-64,
train64_b1, and the B=1 body shapes through ffn_block, split and
split-64; the int8 routes at b1, b1-64, b4-64 and split-64), and the
backward kernels' of the B=8 512px train step (FP32_TIMED_BWD_TAGS:
train64): kernel, plain, library (window MHA:
F.multi_head_attention_forward with TF32 off, and its backward) and
bound per row and per step, every fp32 bound from the least-cost
fp32-accurate product on the tensor cores (workloads.FP32_PRODUCT:
three TF32 passes per product, three bf16 passes on int8 weights).
Then it profiles one fp32 call of
block_core (fp32 and int8 FFN weights) and window MHA at each shape of
a 512px B=1 sample, of ffn_block (both weight types) at each of a 512px
B=4 sample, of ffn_block at the B=1 body shapes (latent 32 and 64), and
of ffn_block_bwd and window MHA's backward at each shape of a 512px B=1
train step: each launches its tensor-core chain (three kernels for
block_core and ffn_block, two for each of the others) and nothing else. The kernels line names each
kernel's route by dtype (ROUTES).
Phase 2 also holds block_core with add_residual=False (every decoder
block of a conditioned UNet) against its plain version at the B=1
decoder shapes, bf16 and int8, rerun bitwise between sentinel guards.
Phase 2 also holds the vq kernel against its plain version at the VAE
step's shape (see workloads.VQ_TIE_REL), with its output between
sentinel guards, and on a near-tie codebook and exact ties across
cluster ranks, warp halves, quad lanes and a lane's code pair
(check_vq_ties), in both types. The last
line is {"ok": true, "device": {...}}; the line before it is the
kernels' JSON record.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import types

import torch

# the card must finish a whole run within this many seconds
TIME_LIMIT_S = 1200
# bf16 kernel vs plain: both round at the same points, so a differing
# fp32 summation order moves a value by at most about one bf16 ulp at a
# rounding point (2**-8 relative), which the later products carry on
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
FP32_TOL = dict(rtol=1e-4, atol=1e-4)
# full-width fp32 step, card vs CPU: 36 blocks of fp32 sums in other
# orders; the error is held against the output's scale
STEP_REL_TOL = 1e-3
# (backward kernels vs plain: workloads.BWD_REL and bwd_scale_err)
# full-width fp32 train step, card vs CPU: loss relative error, and each
# gradient's max abs error over its own max abs
TRAIN_LOSS_REL_TOL = 1e-4
TRAIN_GRAD_REL_TOL = 1e-3
# ...except where a ReLU-boundary flip moved one row's contribution: a
# hidden unit whose pre-activation the CPU and the card may have put on
# opposite sides of 0 (flip_units: the FFN's b, the FiLM tower's first
# layer). A gradient beyond TRAIN_GRAD_REL_TOL passes only if
# explain_flip names such units for it: every offending column of an FFN
# b-path gradient (gwb, gbb, wb, bb) or of the FiLM first layer is a unit
# that may have flipped, and any other such gradient lies in a block with
# an explained one (the flipped row's cotangent reaching the block's FiLM
# output layer). It must stay within FLIP_REL_TOL of its max abs and
# FLIP_COLS columns, and at most FLIP_TENSORS gradients may be touched.
# Measured on the H100 (default UNet, B=4, these seeds; the same in every
# run): 9 of 792 gradients touched, each in 1-6 columns, the worst at
# 1.5e-2 of its max abs. The budget is the measured count plus 3
FLIP_REL_TOL = 2e-2
FLIP_COLS = 6
FLIP_TENSORS = 12
# The same rule for the checks of the UNet at SHALLOW_STAGES (B=4, these
# seeds), measured on the H100, the same in every run: at most 2 of 312-313
# gradients touched (phase 14's conditional step against the CPU, 2;
# phase 18's sp2 against one process, 2; phase 17's DP and pipelined
# steps and phase 18's multi-slice step, 0)
SHALLOW_FLIP_TENSORS = 5
# ...and on the pixel DDPM's 3-channel UNet at SHALLOW_STAGES (phase 15):
# 0 of 312 (at the default depth it was 15 of 792, each in 1-2 columns,
# the worst at 1.15e-2 of its max abs)
DDPM_FLIP_TENSORS = 3
TRAIN_BATCH = 8
TRAIN_STEPS = 5
# phase 15: the pixel DDPM trainer's default batch and image side
DDPM_BATCH = 16
DDPM_SIZE = 32
KERNELS = ("block_core", "ffn_block", "ffn_block_bwd", "window_mha", "window_mha_bwd",
           "vq", "block_core_int8", "ffn_block_int8")
# The depth (blocks per stack, UNetConfig.stages) of the paths that check
# rather than measure: phases 17 and 18 and the fp32 card-vs-CPU checks of
# phases 14-16 (and phase 14's state round trips and run loop). Every
# width, batch and latent is the default's, so each kernel call shape of
# those paths is still checked; each decoder stack keeps an attention
# block, and the 3-block stack pipelines over phase 17's three stages.
# Every launch count and state share of those paths is derived from it.
SHALLOW_STAGES = (1, 1, 3, 1)
# the suffix of those paths' launches_by_path keys
SHALLOW_TAG = "_stages_" + "_".join(map(str, SHALLOW_STAGES))


def unet_cfg(shallow: bool = False, **kw):
    """UNetConfig(**kw), at SHALLOW_STAGES where `shallow`."""
    from ldm_image_generator_tpu_torch.config import UNetConfig

    return UNetConfig(**(dict(kw, stages=SHALLOW_STAGES) if shallow else kw))


def step_launches(batch: int, cfg=None, latent: int = 32, train: bool = False,
                  int8: bool = False, calls: int = 1) -> dict:
    """Launches of `calls` UNet forwards at `batch` (workloads.path_calls:
    the body kernel of every block, window MHA on the attention blocks;
    with `train` their backward kernels too: ffn_block_bwd for the body,
    block_core's included), every kernel named."""
    from ldm_image_generator_tpu_torch.kernels.workloads import path_calls

    counts = dict.fromkeys(KERNELS, 0)
    for c in path_calls(batch, latent, cfg or unet_cfg(), int8=int8):
        counts[c.kernel] += calls * c.per_step
        if train:
            bwd = "window_mha_bwd" if c.kernel == "window_mha" else "ffn_block_bwd"
            counts[bwd] += calls * c.per_step
    return counts


# launches per train step at B=8 on the default UNet (36 ffn_block, 36
# ffn_block_bwd, 8 + 8 window MHA)
TRAIN_LAUNCHES = step_launches(TRAIN_BATCH, train=True)
# the VAE train step (the JAX package's: 512px images, crop 192, batch
# 8) and its launches
VAE_BATCH = 8
VAE_IMAGE = 512
VAE_CROP = 192
VAE_LAUNCHES = dict(block_core=0, ffn_block=0, ffn_block_bwd=0,
                    window_mha=0, window_mha_bwd=0, vq=1, block_core_int8=0,
                    ffn_block_int8=0)
# fp32 VAE step at B=2, card vs CPU: the metrics' relative error, and
# each gradient's max abs error over its own max abs (the codebook rows
# the two sides selected differently excepted)
VAE_CARD_BATCH = 2
VAE_METRIC_REL_TOL = 1e-4
VAE_GRAD_REL_TOL = 1e-3
# The updated parameters are not held to the gradients' tolerance:
# Adafactor divides each gradient element by RMS statistics (its own in
# a tensor it does not factor, its row's and column's in one it does),
# so a row or column of gradients near the rounding floor of their sums
# is rescaled to unit steps and its rounding with it (measured on the
# H100: 6.0e-5 against a max abs of 4.9e-2 in encoder.stage_2.res_0.c1,
# with every element's gradient within 1e-3 of itself). The card's
# optimizer is held instead to the CPU's on the same gradients: Adafactor
# on the card, from the step's starting parameters, applied to the CPU's
# gradients, gives each of the CPU's updated parameters within
# VAE_OPT_STEP_REL of that element's step plus VAE_OPT_REL_TOL of the
# tensor's max abs. Each tensor's steps share one scale, which reads the
# RMS of its update and of its parameters: on the card
# torch._foreach_norm sums the squares in fp32 in another order (measured
# on the H100: every step of encoder.stage_3.res_0.c1, 2.36M elements,
# 1.0000272 times the CPU's); each element adds the rounding of its own
# statistics (a few 1e-7). The parameters after the two real steps are
# reported
VAE_OPT_STEP_REL = 1e-4
VAE_OPT_REL_TOL = 1e-6
VAE_PARAM_REPORT_TOL = 1e-3


def log(*a):
    print(*a, flush=True)


def require(ok, what) -> None:
    """Fail the run (and so the phase) when a check does not hold."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# GPU clock cycles the card spins before each timed call, so the host
# has enqueued the whole call (checks, allocations, every launch of a
# kernel chain or plain version: at most a few dozen ops) before the card
# reaches it: the events then time device work, not the host's enqueue
# (~4 ms at H100 clocks)
SLEEP_CYCLES = 8_000_000


def cold_ms(fn, args, reps: int, flush: torch.Tensor) -> float:
    """Mean device ms of fn(*args), L2 flushed before each call."""
    fn(*args)
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def phase_kernels(dev, reps: int) -> dict:
    """Check and time every kernel at the paths' call shapes."""
    import torch.nn.functional as F

    from ldm_image_generator_tpu_torch.kernels import _build
    from ldm_image_generator_tpu_torch.kernels import block_core as tbc
    from ldm_image_generator_tpu_torch.kernels.block_core import grouped_conv3x3
    from ldm_image_generator_tpu_torch.kernels import ffn_block as tffn
    from ldm_image_generator_tpu_torch.kernels import vq as tvq
    from ldm_image_generator_tpu_torch.kernels import window_attention as tattn
    from ldm_image_generator_tpu_torch.kernels.workloads import (
        BWD_REL,
        VQ_TIE_REL,
        bound_ms,
        bwd_scale_err,
        cond_body_calls,
        dequantized_bwd_inputs,
        make_inputs,
        path_calls,
        train_calls,
        vae_train_calls,
        vq_mismatches,
    )

    def mha_library(x, mask, wq, bq, wk, bk, wv, bv, wo, bo, heads):
        """One PyTorch call computing window MHA (yardstick only)."""
        c = x.shape[-1]
        xt = x.transpose(0, 1)
        return F.multi_head_attention_forward(
            xt, xt, xt, c, heads, None, torch.cat([bq, bk, bv]), None, None,
            False, 0.0, wo.t(), bo, training=False, key_padding_mask=mask,
            need_weights=False, use_separate_proj_weight=True,
            q_proj_weight=wq.t(), k_proj_weight=wk.t(),
            v_proj_weight=wv.t())[0]

    def mha_library_fwd(args):
        """A function running mha_library on args (timing yardstick)."""
        return lambda: mha_library(*args)

    def mha_library_bwd(args):
        """A function running only the backward of mha_library at args,
        its graph built here, out of the timing."""
        x, mask, g, *w, heads = args
        leaves = [t.detach().requires_grad_() for t in (x, *w)]
        out = mha_library(leaves[0], mask, *leaves[1:], heads)
        gt = g.transpose(0, 1)
        return lambda: torch.autograd.grad(out, leaves, gt, retain_graph=True)

    heads_kw = lambda f: (lambda *a: f(*a[:-1], num_heads=a[-1]))
    # int8 FFN weights run with grad mode off (sampling)
    no_grad = lambda f: (lambda *a: torch.no_grad()(f)(*a))
    # name: (kernel, plain version, None or args -> the one PyTorch call
    # computing the same function, to time)
    fns = {
        "block_core": (tbc.block_core, tbc.block_core_plain, None),
        "ffn_block": (tffn.ffn_block, tffn.ffn_block_plain, None),
        "window_mha": (heads_kw(tattn.window_mha),
                       heads_kw(tattn.window_mha_plain), mha_library_fwd),
        "ffn_block_bwd": (tffn.ffn_block_bwd, tffn.ffn_block_bwd_plain, None),
        "window_mha_bwd": (heads_kw(tattn.window_mha_bwd),
                           heads_kw(tattn.window_mha_bwd_plain), mha_library_bwd),
        "vq": (tvq.nearest_codebook_indices, tvq.nearest_codebook_indices_plain,
               None),
        "block_core_int8": (no_grad(tbc.block_core), tbc.block_core_plain, None),
        "ffn_block_int8": (no_grad(tffn.ffn_block), tffn.ffn_block_plain, None),
    }
    sources = {
        "block_core": ("ldm_image_generator_tpu_torch/kernels/csrc/block_core.cu",
                       "ldm_image_generator_tpu/kernels/block_core.py:453"),
        "ffn_block": ("ldm_image_generator_tpu_torch/kernels/csrc/ffn_block.cu",
                      "ldm_image_generator_tpu/kernels/ffn_block.py:221"),
        "window_mha": ("ldm_image_generator_tpu_torch/kernels/csrc/window_attention.cu",
                       "ldm_image_generator_tpu/kernels/window_attention.py:188"),
        "ffn_block_bwd": ("ldm_image_generator_tpu_torch/kernels/csrc/ffn_block_bwd.cu",
                          "ldm_image_generator_tpu/kernels/ffn_block.py:551"),
        "window_mha_bwd": ("ldm_image_generator_tpu_torch/kernels/csrc/window_attention.cu",
                           "ldm_image_generator_tpu/kernels/window_attention.py:402"),
        "vq": ("ldm_image_generator_tpu_torch/kernels/csrc/vq.cu",
               "ldm_image_generator_tpu/kernels/vq.py:56"),
        "block_core_int8": ("ldm_image_generator_tpu_torch/kernels/csrc/block_core.cu",
                            "ldm_image_generator_tpu/kernels/block_core.py:453"),
        "ffn_block_int8": ("ldm_image_generator_tpu_torch/kernels/csrc/ffn_block.cu",
                           "ldm_image_generator_tpu/kernels/ffn_block.py:221"),
    }
    b1, b4 = path_calls(1), path_calls(4)
    # the B=1 body shapes through ffn_block and the B=4 ones through
    # block_core, so the batch split can be re-decided on this card
    swap = lambda c, k: type(c)(k, c.batch, c.hw, c.c, c.per_step)
    cross = [swap(c, "ffn_block") for c in b1 if c.kernel == "block_core"] + [
        swap(c, "block_core") for c in b4 if c.kernel == "ffn_block"]
    latent64 = [c for c in path_calls(1, latent=64) if c.kernel == "block_core"]
    # ...and the latent-64 B=1 body shapes through ffn_block, beside
    # block_core there
    cross64 = [swap(c, "ffn_block") for c in latent64]
    # phase 20, the 512px paths (latent 64): window MHA of a B=1 sample
    # (block_core above), every call of a B=4 sample and of the B=8 train
    # step, and the B=1 train step's block_core (a stochastic-depth gate
    # on every block, so no residual fold) and backward kernels
    b1_64 = [c for c in path_calls(1, latent=64) if c.kernel == "window_mha"]
    train64_b1 = [dataclasses.replace(c, residual=False) for c in latent64] + [
        dataclasses.replace(c, kernel="ffn_block_bwd" if c.kernel == "block_core"
                            else c.kernel + "_bwd") for c in path_calls(1, latent=64)]
    # the backward kernels and the window MHA and ffn_block forwards of a
    # train step
    train = [c for c in train_calls(TRAIN_BATCH)
             if c.kernel.endswith("_bwd") or c.kernel in ("window_mha", "ffn_block")]
    # the int8 routes at their paths' shapes: block_core at B=1 (latent 32
    # and 64), ffn_block at B=4 (latent 32 and 64) and at the latent-64
    # B=1 body shapes (beside fp32 weights' split-64 rows)
    int8_64 = [c for c in path_calls(4, latent=64, int8=True) if c.kernel == "ffn_block_int8"]
    int8 = [(c, "b1") for c in path_calls(1, int8=True) if c.kernel == "block_core_int8"] + [
        (c, "b1-64") for c in path_calls(1, latent=64, int8=True)
        if c.kernel == "block_core_int8"] + [
        (c, "b4") for c in path_calls(4, int8=True) if c.kernel == "ffn_block_int8"] + [
        (c, "b4-64") for c in int8_64] + [
        (swap(c, "ffn_block_int8"), "split-64") for c in latent64]
    # the int8 train step at B=2 (every block carries a stochastic-depth
    # gate, so none folds its residual into block_core; a film per
    # sample) and its backward kernels
    b2 = path_calls(2, int8=True)
    int8_b2 = [dataclasses.replace(c, residual=False, film_batch=2)
               if c.kernel == "block_core_int8" else c for c in b2] + [
        dataclasses.replace(c, kernel="ffn_block_bwd" if c.kernel == "block_core_int8"
                            else c.kernel + "_bwd") for c in b2]
    # block_core without its residual (a conditioned decoder block) at the
    # B=1 decoder shapes, both weight types
    cond = [(c, "b1-cond") for c in cond_body_calls(1) + cond_body_calls(1, int8=True)]
    calls = [(c, "b1") for c in b1] + [(c, "b4") for c in b4] + cond + [
        (c, "b1-64") for c in latent64 + b1_64] + [(c, "split") for c in cross] + [
        (c, "train") for c in train] + [
        (c, "vae_train") for c in vae_train_calls(VAE_BATCH, VAE_CROP)] + int8 + [
        (c, "split-64") for c in cross64] + [
        # phase 15: every call of a pixel DDPM train step at B=16 (its maps
        # are the latent path's: 32/16/8/4)
        (c, "ddpm_train") for c in train_calls(DDPM_BATCH)] + [
        # phase 16: the FFN calls of an int8 train step at B=8 (ffn_block
        # on int8 weights, its backward on their int8 round trip) ...
        (dataclasses.replace(c, kernel="ffn_block_int8", film_batch=c.batch), "int8_train")
        for c in train_calls(TRAIN_BATCH) if c.kernel == "ffn_block"] + [
        (c, "int8_train") for c in train_calls(TRAIN_BATCH) if c.kernel == "ffn_block_bwd"] + [
        # ...and every call of the int8 train step at B=2: block_core on
        # int8 weights, window MHA, and their backward kernels
        (c, "int8_train_b2") for c in int8_b2] + [
        # phase 17: every call of one data-parallel rank's train step
        # (B=4, a film per sample), of the pipelined train step and of one
        # rank's VAE step, at the default depth: phase 17 runs a subset of
        # these shapes (SHALLOW_STAGES), and the default UNet pipelines a
        # block of every stage, so block_core at B=2 is held at all four
        # maps (those of phase 18's multi-slice ranks too)
        (c, "dp2_train") for c in per_sample_film(train_calls(DP_BATCH // DP_WORLD))] + [
        (c, "gpipe3_train") for c in gpipe_calls(unet_cfg())] + [
        (c, "dp2_vae_train") for c in vae_train_calls(VAE_BATCH // DP_WORLD, VAE_CROP)] + [
        # phase 18: the FFN calls of an expert-parallel rank's train step
        # (B=8, a film per sample), whose blocks hold only the 2 routed
        # experts' weights (ids 0 and 1)
        (dataclasses.replace(c, experts=2), "ep2_train")
        for c in per_sample_film(train_calls(MESH_BATCH)) if c.kernel.startswith("ffn_block")] + [
        # phase 20
        (c, "b4-64") for c in path_calls(4, latent=64)] + [
        (c, "train64") for c in per_sample_film(train_calls(TRAIN_BATCH, latent=64))] + [
        (c, "train64_b1") for c in train64_b1] + [
        # the benchmark's cells: ffn_block at a CFG call of B=256 (latent
        # 32) and a served bucket of 32 (latent 64), the bf16 wgmma route's
        (c, tag) for tag, (batch, lat) in CELL_TAGS.items()
        for c in path_calls(batch, latent=lat) if c.kernel == "ffn_block"]
    ffn_lib = _build.load("ffn_block")
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, rows32 = [], []  # the timed bf16 and fp32 calls
    for call, tag in calls:
        kernel, plain, library = fns[call.kernel]
        bwd = call.kernel.endswith("_bwd")
        extra = (call.heads,) if call.kernel.startswith("window_mha") else ()
        for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
            args = make_inputs(call, dtype, dev, gen) + extra
            if tag.startswith("int8_train") and call.kernel == "ffn_block_bwd":
                args = dequantized_bwd_inputs(args)
            got, want = kernel(*args), plain(*args)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            torch.cuda.synchronize()
            if call.kernel == "ffn_block_bwd" and any(
                    bwd_scale_err(g, w) > BWD_REL[dtype] for g, w in zip(got, want)):
                want = ffn_bwd_boundary_plain(kernel, plain, args, got, call.label, dtype)
            err = 0.0  # max |kernel - plain| over the outputs, this dtype
            for g, w in zip(got, want):
                require(torch.isfinite(g.float()).all(), (call, dtype))
                if call.kernel == "vq":
                    n_mis, err = vq_mismatches(*args, g, w)
                    log(f"vq {call.label} {dtype}: {n_mis} indices differ from "
                        f"the plain version's, largest score gap {err:.3e}")
                    require(err <= VQ_TIE_REL, ("vq", dtype, n_mis, err))
                    require(torch.equal(kernel(*args), g), "vq rerun bitwise equal")
                elif bwd:
                    rel = bwd_scale_err(g, w)
                    require(rel <= BWD_REL[dtype], (call.label, dtype, rel))
                    err = max(err, rel)
                else:
                    torch.testing.assert_close(g.float(), w.float(), **tol)
                    err = max(err, (g.float() - w.float()).abs().max().item())
            # (ffn_block at every shape: the B=1 split rows are also the
            # calls of a UNet without its conv branch, the ablation of
            # phase 16)
            if (call.kernel.endswith("_int8") or call.kernel in ("block_core", "ffn_block", "vq")
                    or tag in ("ddpm_train", "int8_train", "int8_train_b2")
                    or tag in PARALLEL_TAGS or tag in LATENT64_TAGS):
                check_guarded_rerun(kernel, args, got)
            if dtype == torch.float32:
                err_fp32 = err
                if not fp32_timed(call, tag):
                    continue
            ms = cold_ms(kernel, args, reps, flush)
            plain_ms = cold_ms(plain, args, reps, flush)
            lib_ms = None if library is None else cold_ms(library(args), (), reps, flush)
            bms, by = bound_ms(call, dtype)
            row = dict(kernel=call.kernel, tag=tag, shape=call.label,
                       per_step=call.per_step, max_abs_err=err,
                       max_abs_err_fp32=err_fp32, ms=ms,
                       plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                       bound_by=by)
            if call.kernel == "ffn_block" and dtype == torch.bfloat16:
                rows_n = call.batch * call.hw * call.hw
                # (a tree without the wgmma route: mma.sync)
                wg = hasattr(ffn_lib, "ffn_wgmma_route") and ffn_lib.ffn_wgmma_route(
                    1, 0, rows_n, call.c, call.c)
                row["route"] = "wgmma" if wg else "mma.sync"
            if lib_ms is not None:
                row["kernel_over_library"] = ms / lib_ms
                row["bound_over_kernel"] = bms / ms
            if bwd:
                row["error_metric"] = "max abs err / max(max |plain|, 1)"
            if call.kernel == "vq":
                row["error_metric"] = ("largest exact score gap between the "
                                       "kernel's and the plain's codes over "
                                       "the scores' magnitude (0: equal)")
            if dtype == torch.float32:
                rows32.append(row)
                log("kernel fp32", json.dumps(row))
                continue
            if call.kernel == "ffn_block":
                # the grouped conv ffn_block leaves outside (plain
                # PyTorch, as the SwinBlock runs it), for the batch split
                c = call.c
                h4 = args[0].reshape(call.batch, call.hw, call.hw, c)
                ck, cb = make_inputs(type(call)("block_core", 1, 1, c, 1),
                                     dtype, dev, gen)[-3:-1]
                row["conv_ms"] = cold_ms(grouped_conv3x3, (h4, ck, cb), reps,
                                         flush)
            rows.append(row)
            log("kernel", json.dumps(row))
    check_block_core_grads(dev, b1)
    check_vq_ties(dev)
    main_tag = {"block_core": "b1", "ffn_block": "b4", "window_mha": "b1",
                "ffn_block_bwd": "train", "window_mha_bwd": "train",
                "vq": "vae_train", "block_core_int8": "b1", "ffn_block_int8": "b4"}
    step_name = {"train": "train step at B=8",
                 "vae_train": f"VAE train step at B={VAE_BATCH}"}
    # window MHA and the FFN kernels per step of every path they are on:
    # kernel, library (where there is one), bound
    for name in ("window_mha", "window_mha_bwd", "ffn_block", "ffn_block_bwd"):
        for tag in ("b1", "b4", "train", "ddpm_train", "int8_train", "int8_train_b2",
                    *PARALLEL_TAGS, *LATENT64_TAGS, *CELL_TAGS):
            rs = [r for r in rows if r["kernel"] == name and r["tag"] == tag]
            if not rs:
                continue
            step = lambda k: sum(r[k] * r["per_step"] for r in rs)
            ms, bms = step("ms"), step("bound_ms")
            lib = ""
            if rs[0]["library_ms"] is not None:
                lib_ms = step("library_ms")
                lib = f", library {lib_ms:.4f} ms (kernel/library {ms / lib_ms:.3f})"
            routes = sorted({r["route"] for r in rs if "route" in r})
            log(f"{name} {tag} per step: kernel {ms:.4f} ms{lib}, bound "
                f"{bms:.5f} ms (bound/kernel {bms / ms:.4f})"
                + (f", plain {step('plain_ms'):.4f} ms, route {'/'.join(routes)}" if routes else ""))
    # block_core per B=1 step (latent 32 and 64) beside ffn_block plus the
    # plain grouped conv at the same shapes, the two calls a SwinBlock
    # would make without it
    for tag, split in (("b1", "split"), ("b1-64", "split-64")):
        rs = [r for r in rows if r["kernel"] == "block_core" and r["tag"] == tag]
        parts = [r for r in rows if r["kernel"] == "ffn_block" and r["tag"] == split]
        step = lambda rr, k: sum(r[k] * r["per_step"] for r in rr)
        ms, bms = step(rs, "ms"), step(rs, "bound_ms")
        ffn_ms, conv_ms = step(parts, "ms"), step(parts, "conv_ms")
        log(f"block_core {tag} per step: kernel {ms:.4f} ms, bound {bms:.5f} ms "
            f"(bound/kernel {bms / ms:.4f}); ffn_block + grouped conv at the same "
            f"shapes {ffn_ms + conv_ms:.4f} ms ({ffn_ms:.4f} + {conv_ms:.4f}; "
            f"block_core/sum {ms / (ffn_ms + conv_ms):.3f})")
    # block_core without the residual, per conditioned B=1 UNet call: the
    # 18 decoder blocks
    for name in ("block_core", "block_core_int8"):
        rs = [r for r in rows if r["kernel"] == name and r["tag"] == "b1-cond"]
        step = lambda k: sum(r[k] * r["per_step"] for r in rs)
        log(f"{name} b1-cond (add_residual=False, decoder blocks) per UNet call: "
            f"kernel {step('ms'):.4f} ms, bound {step('bound_ms'):.5f} ms, plain "
            f"{step('plain_ms'):.4f} ms, max abs err {max(r['max_abs_err'] for r in rs):.3e}")
    # the int8 routes per step of their paths, beside the same kernel with
    # full-precision (bf16) weights at the same shapes in this call
    # (an int8 train step's B=8 forward beside a bf16 one's; B=2 has none)
    for name in ("block_core_int8", "ffn_block_int8"):
        for tag, fp_tag in (("b1", "b1"), ("b1-64", "b1-64"), ("b4", "b4"),
                            ("b4-64", "b4-64"), ("split-64", "split-64"),
                            ("int8_train", "train"), ("int8_train_b2", None)):
            rs = [r for r in rows if r["kernel"] == name and r["tag"] == tag]
            if not rs:
                continue
            step = lambda rr, k: sum(r[k] * r["per_step"] for r in rr)
            ms, bms = step(rs, "ms"), step(rs, "bound_ms")
            line = (f"{name} {tag} per step: kernel {ms:.4f} ms, bound {bms:.5f} ms "
                    f"(bound/kernel {bms / ms:.4f})")
            bf16 = [r for r in rows if r["kernel"] == name[:-5] and r["tag"] == fp_tag]
            if bf16:
                fp_ms = step(bf16, "ms")
                line += (f"; bf16 weights {fp_ms:.4f} ms, bound "
                         f"{step(bf16, 'bound_ms'):.5f} ms (int8/bf16 {ms / fp_ms:.3f})")
            log(line)
    fp32_steps = fp32_per_step(rows32)
    summary = {}
    ddpm_rows = [r for r in rows if r["tag"] == "ddpm_train"]
    for name in fns:
        main = [r for r in rows if r["kernel"] == name and r["tag"] == main_tag[name]]
        per_step = lambda key: sum(r[key] * r["per_step"] for r in main)
        libs = [r["library_ms"] for r in main]
        bound = per_step("bound_ms")
        ops_bound = sum(r["bound_ms"] * r["per_step"] for r in main
                        if r["bound_by"] == "operations")
        step = step_name.get(main_tag[name], "denoise step")
        summary[name] = dict(
            name=name, route="cuda", source=sources[name][0],
            replaces=sources[name][1], routes=ROUTES[name], launches=None,
            max_abs_err=max(r["max_abs_err"] for r in main),
            ms=per_step("ms"), kernel_ms=per_step("ms"),
            plain_ms=per_step("plain_ms"), bound_ms=bound,
            bound_by="operations" if ops_bound > bound / 2 else "bytes",
            library_ms=None if None in libs else per_step("library_ms"),
            per=f"one {step} of its path: sum over its call shapes of calls "
                "x cold-L2 ms per call, bf16")
        for tag, batch in (("int8_train", TRAIN_BATCH), ("int8_train_b2", 2)):
            rs = [r for r in rows if r["kernel"] == name and r["tag"] == tag]
            if not rs:
                continue
            summary[name][tag + "_step"] = dict(
                batch=batch, **{k: sum(r[k] * r["per_step"] for r in rs)
                                for k in ("ms", "plain_ms", "bound_ms")},
                max_abs_err=max(r["max_abs_err"] for r in rs),
                max_abs_err_fp32=max(r["max_abs_err_fp32"] for r in rs))
            if name == "ffn_block_bwd":
                summary[name][tag + "_step"]["weights"] = "the int8 round trip of bf16 weights"
        cells = {tag: batch for tag, (batch, _) in CELL_TAGS.items()}
        for tag, batch in {**PARALLEL_TAGS, **LATENT64_TAGS, **cells}.items():
            rs = [r for r in rows if r["kernel"] == name and r["tag"] == tag]
            if rs:
                summary[name][tag + "_step"] = dict(
                    batch=batch, **{k: sum(r[k] * r["per_step"] for r in rs)
                                    for k in ("ms", "plain_ms", "bound_ms")},
                    max_abs_err=max(r["max_abs_err"] for r in rs),
                    max_abs_err_fp32=max(r["max_abs_err_fp32"] for r in rs),
                    library_ms=(None if rs[0]["library_ms"] is None
                                else sum(r["library_ms"] * r["per_step"] for r in rs)))
        ddpm = [r for r in ddpm_rows if r["kernel"] == name]
        if ddpm:
            summary[name]["ddpm_train_step"] = dict(
                batch=DDPM_BATCH, **{k: sum(r[k] * r["per_step"] for r in ddpm)
                                     for k in ("ms", "plain_ms", "bound_ms")},
                max_abs_err=max(r["max_abs_err"] for r in ddpm),
                max_abs_err_fp32=max(r["max_abs_err_fp32"] for r in ddpm),
                library_ms=(None if ddpm[0]["library_ms"] is None
                            else sum(r["library_ms"] * r["per_step"] for r in ddpm)))
        if name in fp32_steps:
            summary[name]["fp32_steps"] = fp32_steps[name]
    # every fp32 call of the paths sample_ldm and train_ldm run at their
    # defaults (after the timed rows and their per-step sums, so that a
    # tree whose kernels fail it still reports their times)
    check_fp32_chains(dev, latent64 + b1_64 + [c for c in train64_b1 if c.kernel.endswith("_bwd")]
                      + cross + cross64 + [c for c in path_calls(4, latent=64)
                                           if c.kernel == "ffn_block"]
                      + [c for c in path_calls(1, latent=64, int8=True)
                         if c.kernel == "block_core_int8"] + int8_64)
    return summary


# the paths whose fp32 kernel calls phase 2 times (every other fp32 call
# is checked, not timed): the B=1 and B=4 samples at latent 64 (the
# sample_ldm CLI's default precision, -n 1 and -n 4, and with --quant
# int8) and the B=1 sample at latent 32, the B=1 body shapes through
# ffn_block, and the fp32 train_ldm CLI's B=1 step at latent 64; the
# backward kernels also at the B=8 train step at latent 64
FP32_TIMED_TAGS = ("b1", "b1-64", "split", "split-64", "train64_b1", "b4-64")
FP32_TIMED_BWD_TAGS = ("train64",)

# each kernel's route at the UNet's shapes, by dtype (the kernels line
# names them; other shapes take the CUDA-core FMA tiles)
_TF32 = "tensor cores, three TF32 passes"
_TF32_Q = "tensor cores, two TF32 passes on int8 weight tiles"
ROUTES = {
    "block_core": {"bf16": "tensor cores", "fp32": _TF32 + " (csrc/ffn_tf32_fwd.cuh)"},
    "ffn_block": {"bf16": "tensor cores (wgmma, csrc/ffn_wg_fwd.cuh, where ffn_wgmma_route "
                          "takes the call; else mma.sync)",
                  "fp32": _TF32 + " (csrc/ffn_tf32_fwd.cuh)"},
    "window_mha": {"bf16": "tensor cores", "fp32": _TF32 + " (window_attention.cu wtf)"},
    "ffn_block_bwd": {"bf16": "tensor cores", "fp32": _TF32 + " (csrc/ffn_tf32_bwd.cuh)"},
    "window_mha_bwd": {"bf16": "tensor cores",
                       "fp32": _TF32 + " (window_attention.cu wtf)"},
    "vq": {"bf16": _TF32, "fp32": _TF32},
    "block_core_int8": {"bf16": "tensor cores",
                        "fp32": _TF32_Q + ", the conv three (csrc/ffn_tf32_fwd.cuh)"},
    "ffn_block_int8": {"bf16": "tensor cores", "fp32": _TF32_Q + " (csrc/ffn_tf32_fwd.cuh)"},
}


def fp32_timed(call, tag: str) -> bool:
    """Whether phase 2 times the fp32 call (FP32_TIMED_TAGS,
    FP32_TIMED_BWD_TAGS)."""
    return tag in FP32_TIMED_TAGS or (call.kernel.endswith("_bwd")
                                      and tag in FP32_TIMED_BWD_TAGS)


def check_fp32_chains(dev, calls) -> None:
    """The device kernels of one fp32 call of block_core and ffn_block
    (fp32 and int8 FFN weights), window MHA and the two backward kernels
    at each of `calls` (the B=1 and B=4 samples' and a B=1 train step's
    at latent 64, the B=1 body shapes through ffn_block; torch.profiler,
    the card's activity): the tensor-core route's launches (block_core's
    and ffn_block's norm/FiLM, ftc::gate_kernel<float, ...> and
    ftc::out_kernel<float, ...>, none of the FMA chain's
    gate_finish_kernel, out_partial_kernel or finish_kernel; window MHA's
    wtf::fwd_core_kernel and wtf::out_proj_kernel; ffn_block_bwd's
    gate_grad_kernel_f32 and tail_kernel_f32; window MHA backward's
    wtf::bwd_core_kernel and wtf::bwd_tail_kernel), nothing else."""
    from torch.profiler import ProfilerActivity, profile

    from ldm_image_generator_tpu_torch.kernels import block_core as tbc
    from ldm_image_generator_tpu_torch.kernels import ffn_block as tffn
    from ldm_image_generator_tpu_torch.kernels import window_attention as tattn
    from ldm_image_generator_tpu_torch.kernels.workloads import make_inputs

    gen = torch.Generator(device=dev).manual_seed(9)
    ffn = ("norm_film_rows_kernel<float>", "ftc::gate_kernel<float", "ftc::out_kernel<float")
    want = {"block_core": ffn, "ffn_block": ffn, "block_core_int8": ffn, "ffn_block_int8": ffn,
            "window_mha": ("wtf::fwd_core_kernel", "wtf::out_proj_kernel"),
            "ffn_block_bwd": ("gate_grad_kernel_f32", "tail_kernel_f32"),
            "window_mha_bwd": ("wtf::bwd_core_kernel", "wtf::bwd_tail_kernel")}
    for call in calls:
        args = make_inputs(call, torch.float32, dev, gen)
        fn = {"block_core": tbc.block_core, "ffn_block_bwd": tffn.ffn_block_bwd,
              "ffn_block": tffn.ffn_block, "block_core_int8": tbc.block_core,
              "ffn_block_int8": tffn.ffn_block,
              "window_mha": lambda *a: tattn.window_mha(*a, num_heads=call.heads),
              "window_mha_bwd": lambda *a: tattn.window_mha_bwd(*a, num_heads=call.heads),
              }[call.kernel]
        with torch.no_grad():
            fn(*args)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn(*args)
                torch.cuda.synchronize()
        chain = {ev.key: ev.count for ev in prof.key_averages()
                 if (getattr(ev, "self_device_time_total", 0.0) or 0.0) > 0}
        names = want[call.kernel]
        log(f"{call.kernel} {call.label} fp32 launch chain: {json.dumps(chain)}")
        fma = ("gate_finish_kernel", "out_partial_kernel", "finish_kernel")
        require(sum(chain.values()) == len(names)
                and all(any(n in k for k in chain) for n in names)
                and not any(n in k for k in chain for n in fma),
                ("fp32 tensor-core chain", call.kernel, call.label, chain))


def fp32_per_step(rows32: list) -> dict:
    """{kernel: {tag: per-step sums}} of phase 2's timed fp32 rows:
    kernel, plain and library ms, the bound and what sets most of it,
    each logged."""
    out = {}
    for r in rows32:
        out.setdefault(r["kernel"], {}).setdefault(r["tag"], []).append(r)
    for name, tags in out.items():
        for tag, rs in tags.items():
            step = lambda k: sum(r[k] * r["per_step"] for r in rs)
            bound = step("bound_ms")
            ops = sum(r["bound_ms"] * r["per_step"] for r in rs
                      if r["bound_by"] == "operations")
            lib = None if rs[0]["library_ms"] is None else step("library_ms")
            tags[tag] = d = dict(
                ms=step("ms"), plain_ms=step("plain_ms"), library_ms=lib,
                bound_ms=bound, bound_by="operations" if ops > bound / 2 else "bytes",
                max_abs_err=max(r["max_abs_err"] for r in rs))
            lib_s = "" if lib is None else f", library {lib:.4f} ms"
            log(f"{name} {tag} fp32 per step: kernel {d['ms']:.4f} ms, plain "
                f"{d['plain_ms']:.4f} ms{lib_s}, bound {bound:.5f} ms ({d['bound_by']}; "
                f"bound/kernel {bound / d['ms']:.4f}), max abs err {d['max_abs_err']:.3e}")
    return out


def ffn_bwd_boundary_plain(kernel, plain, args, got, label: str, dtype) -> tuple:
    """The plain version of an ffn_block_bwd call that takes the kernel's
    ReLU decision where the two decided a b = h @ wb + bb the other way
    (workloads.ffn_bwd_boundary_plain; measured on the H100: one at the
    pipelined step's [6,8,8,512] in fp32, 2e-2 of the scale; in bf16, 2 of
    12 seeded calls at the EP step's [8,8,8,512], one flip each, 0.045 and
    0.070 of the scale, 0.0040 and 0.0035 with the kernel's decisions). A
    decision apart from the boundary fails the run."""
    from ldm_image_generator_tpu_torch.kernels.workloads import ffn_bwd_boundary_plain as fbp

    want, differ, away, again = fbp(kernel, plain, args)
    require(all(torch.equal(a, b) for a, b in zip(got, again)), "rerun bitwise equal")
    log(f"ffn_block_bwd {label} {dtype}: {differ} ReLU decisions taken the "
        f"other way by the kernel, {away} away from the boundary")
    require(away == 0, (label, "ReLU decisions differ away from the boundary", away))
    return want


def check_guarded_rerun(kernel, args, got) -> None:
    """A kernel call again with every buffer its wrapper allocates between
    sentinel guards (and fresh split counters): no guard written, the
    counters left 0; then a rerun: every output bitwise equal to `got`,
    the first call's."""
    from ldm_image_generator_tpu_torch.kernels import ffn_block as tffn
    from ldm_image_generator_tpu_torch.kernels.workloads import GuardedBuffers

    saved, tffn._counters = tffn._counters, {}
    try:
        with GuardedBuffers() as guarded:
            again = kernel(*args)
            torch.cuda.synchronize()
    finally:
        tffn._counters = saved
    require(guarded.made and guarded.faults() == [], ("guards", guarded.faults()))
    for calls in (again, kernel(*args)):
        calls = calls if isinstance(calls, tuple) else (calls,)
        require(all(torch.equal(a, b) for a, b in zip(got, calls)), "rerun bitwise equal")


def check_vq_ties(dev) -> None:
    """The vq kernel at the VAE step's shape, x in fp32 and bf16, on a
    near-tie codebook (pairs 2**-18 apart, exact duplicates K/2 on: equal
    to the plain version except within VQ_TIE_REL) and on exact
    duplicates placed in the next cluster rank's slice, in the other warp
    half of the same rank's slice, in lanes 2-3 of the quad holding their
    first copy, in the same lane's code pair, and K/2 on: never the second
    copy, and on the halves layout the kernel's answer on the first half
    alone. Every call reruns bitwise."""
    from ldm_image_generator_tpu_torch.kernels import _build
    from ldm_image_generator_tpu_torch.kernels import vq as tvq
    from ldm_image_generator_tpu_torch.kernels.workloads import (
        VQ_TIE_REL,
        near_tie_codebook,
        tie_codebook,
        vae_train_calls,
        vq_mismatches,
    )

    gen = torch.Generator(device=dev).manual_seed(7)
    (call,) = vae_train_calls(VAE_BATCH, VAE_CROP)
    slice_codes = _build.load("vq").vq_slice_codes(call.n, call.l)

    def indices(x, cb):
        got = tvq.nearest_codebook_indices(x, cb)
        require(torch.equal(tvq.nearest_codebook_indices(x, cb), got),
                "vq rerun bitwise equal")
        return got

    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((call.n, call.c), generator=gen, device=dev).to(dtype)
        cb = near_tie_codebook(call.l, call.c, gen, dev)
        n_mis, gap = vq_mismatches(x, cb, indices(x, cb),
                                   tvq.nearest_codebook_indices_plain(x, cb))
        log(f"vq near ties [{call.n},{call.c}] K={call.l} {dtype}: {n_mis} indices "
            f"differ from the plain version's, largest score gap {gap:.3e}")
        require(gap <= VQ_TIE_REL, ("vq near ties", dtype, n_mis, gap))
        for layout in ("halves", "next_rank", "mid", "quad", "pair"):
            cb, copy_of = tie_codebook(call.l, call.c, layout, gen, dev, slice_codes)
            got = indices(x, cb).long()
            n_mis, gap = vq_mismatches(x, cb, got, tvq.nearest_codebook_indices_plain(x, cb))
            require(torch.equal(copy_of[got], got) and gap <= VQ_TIE_REL,
                    ("vq: the first index on exact ties", layout, dtype, n_mis, gap))
            if layout == "halves":
                half = cb[: call.l // 2].contiguous()
                require(torch.equal(got, indices(x, half).long()),
                        ("vq: the first half's answer", dtype))
        log(f"vq exact ties [{call.n},{call.c}] K={call.l} {dtype} (halves, next rank "
            f"of {slice_codes} codes, mid-slice, quad, pair): first index taken")


def check_block_core_grads(dev, calls) -> None:
    """block_core's gradients through the card path (the composed
    backward with the ffn_block_bwd kernel) against autograd through its
    plain version on the card at the B=1 body shapes: fp32 (the forward
    as three TF32 passes on the tensor cores) within BWD_REL[fp32], and
    bf16 (bf16 tensor cores) within BWD_REL[bf16], each of max abs err
    over max(max |plain|, 1)."""
    from ldm_image_generator_tpu_torch.kernels import block_core as tbc
    from ldm_image_generator_tpu_torch.kernels.workloads import (
        BWD_REL,
        bwd_scale_err,
        make_inputs,
    )

    # a generator per type: neither type's inputs depend on the other's
    gens = {dtype: torch.Generator(device=dev).manual_seed(seed)
            for dtype, seed in ((torch.float32, 5), (torch.bfloat16, 6))}
    for call in calls:
        if call.kernel != "block_core":
            continue
        for dtype, gen in gens.items():
            args = make_inputs(call, dtype, dev, gen)
            cot = [torch.randn(args[0].shape, generator=gen, device=dev).to(dtype)
                   for _ in range(2)]
            grads = []
            for fn in (tbc.block_core, tbc.block_core_plain):
                leaves = [a.detach().requires_grad_(a.is_floating_point()) for a in args]
                torch.autograd.backward(fn(*leaves, add_residual=False), cot)
                grads.append([t.grad for t in leaves if t.requires_grad])
            worst = max(bwd_scale_err(g, w) for g, w in zip(*grads))
            log(f"block_core grads {call.label} {dtype}: card path vs plain autograd "
                f"{worst:.3e}")
            require(worst <= BWD_REL[dtype], (call.label, dtype, worst))


def run_path(pipe, batch: int, generator, finite: bool = True):
    """(launch counts, final latent) of one 256px 20-step sample; its
    uint8 images and (with `finite`) finite latents checked."""
    reset_launch_counts()
    img, z = pipe.sample(generator, batch=batch, image_size=256, num_steps=20,
                         return_latent=True)
    torch.cuda.synchronize()
    counts = launch_counts()
    require(img.dtype == torch.uint8
            and tuple(img.shape) == (batch, 256, 256, 3), img.shape)
    require(tuple(z.shape) == (batch, 32, 32, 8)
            and (not finite or torch.isfinite(z).all()),
            "final latent finite and [B, 32, 32, 8]")
    return counts, z


# launches of one 256px 20-step sample by batch: B=1 runs block_core on
# the 36 blocks, B=4 ffn_block; 8 attention blocks each; the int8 UNet
# runs the same on the int8 routes
def path_launches(batch: int, int8: bool = False) -> dict:
    counts = dict.fromkeys(launch_counts(), 0)
    body = ("block_core" if batch == 1 else "ffn_block") + ("_int8" if int8 else "")
    counts.update({body: 720, "window_mha": 160})
    return counts


def phase_path(dev) -> dict:
    from ldm_image_generator_tpu_torch.pipelines import LDMPipeline

    t0 = time.perf_counter()
    pipe = LDMPipeline.random(dtype=torch.bfloat16, device=dev, seed=0)
    n_params = sum(p.numel() for p in pipe.unet.parameters())
    log(f"path: default UNet {n_params} params, built in "
        f"{time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device=dev).manual_seed(0)
    pipe.sample(gen, batch=1, image_size=256, num_steps=20)  # warm-up
    counts, _ = run_path(pipe, 1, gen)
    log("path b1 launches", json.dumps(counts))
    require(counts == path_launches(1), counts)
    out = {"launches_b1": counts}
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.sample(gen, batch=1, image_size=256, num_steps=20)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    out["b1_sample_s"] = times
    out["b1_images_per_s"] = 1.0 / (sum(times) / len(times))
    log("path b1 sample seconds", times, "images/s", out["b1_images_per_s"])
    # the profiles draw from their own generator: gen's draws stay those of
    # the checks
    out["profile_b1"] = profile_sample(pipe, torch.Generator(device=dev).manual_seed(1))

    counts, _ = run_path(pipe, 4, gen)
    log("path b4 launches", json.dumps(counts))
    require(counts == path_launches(4), counts)
    out["launches_b4"] = counts
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.sample(gen, batch=4, image_size=256, num_steps=20)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out["b4_sample_s"] = dt
    out["b4_images_per_s"] = 4.0 / dt
    log("path b4 sample seconds", dt, "images/s", out["b4_images_per_s"])
    out["profile_b4"] = profile_sample(pipe, torch.Generator(device=dev).manual_seed(4), 4)
    return out, pipe


def profile_sample(pipe, gen, batch: int = 1) -> dict:
    """Device time by kernel name over one sample."""
    return profile_fn(lambda: pipe.sample(gen, batch=batch, image_size=256,
                                          num_steps=20))


def phase_int8_path(dev, ref_pipe) -> dict:
    """The int8 sampling path: the default UNet with ffn_quant='int8' (the
    same seeded weights as ref_pipe's, bf16 compute) at B=1 and B=4: exact
    launch counts on the int8 routes, no quantization in a sample call,
    finite latents and uint8 images, images/s and a profile of each; and
    the relative L2 distance of its final latent from ref_pipe's (full
    precision) for the same x_T and routing."""
    from ldm_image_generator_tpu_torch.config import UNetConfig
    from ldm_image_generator_tpu_torch.kernels import ffn_block as tffn
    from ldm_image_generator_tpu_torch.pipelines import LDMPipeline

    t0 = time.perf_counter()
    q0 = tffn.quantizations
    pipe = LDMPipeline.random(UNetConfig(ffn_quant="int8"), dtype=torch.bfloat16,
                              device=dev, seed=0)
    made = tffn.quantizations - q0
    same = all(torch.equal(a, b) for a, b in zip(pipe.unet.parameters(),
                                                 ref_pipe.unet.parameters()))
    require(same, "int8 and full-precision pipelines hold the same weights")
    log(f"int8 path: pipeline built in {time.perf_counter() - t0:.2f} s, "
        f"{made} weight matrices quantized")
    require(made == 6 * 36, made)
    out = {}
    for batch in (1, 4):
        seed = 10 + batch
        gen = torch.Generator(device=dev).manual_seed(seed)
        pipe.sample(gen, batch=batch, image_size=256, num_steps=20)  # warm-up
        q0 = tffn.quantizations
        counts, z = run_path(pipe, batch, torch.Generator(device=dev).manual_seed(seed))
        log(f"int8 path b{batch} launches", json.dumps(counts))
        require(counts == path_launches(batch, int8=True), counts)
        _, z_ref = run_path(ref_pipe, batch, torch.Generator(device=dev).manual_seed(seed))
        times = []
        for _ in range(3 if batch == 1 else 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.sample(gen, batch=batch, image_size=256, num_steps=20)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        require(tffn.quantizations == q0, "a sample call quantized weights")
        rel_l2 = ((z.float() - z_ref.float()).norm() / z_ref.float().norm()).item()
        ips = batch / (sum(times) / len(times))
        log(f"int8 path b{batch}: sample seconds {times}, images/s {ips:.4f}; final "
            f"latent relative L2 distance from full precision {rel_l2:.5f}; "
            "0 weights quantized in the sample calls")
        prof = profile_sample(pipe, gen, batch)
        out[f"b{batch}"] = dict(launches=counts, sample_s=times, images_per_s=ips,
                                latent_rel_l2_vs_bf16_weights=rel_l2,
                                device_busy_ms=prof["device_busy_ms"],
                                profiled_wall_ms=prof["wall_ms"])
    return out


def phase_card_vs_cpu(dev, cfg=None, latent: int = 32, batch: int = 1) -> float:
    """One full-width fp32 denoise step of the UNet of `cfg` (default: the
    default UNet) at `batch` (1: the block_core body; 4: ffn_block's) on a
    latent x latent input, card kernels vs CPU plain versions. A
    class-conditional UNet gives one guided prediction: class 1 and the
    null class under one routing plan, guidance 3.0, rescale 0.7."""
    from ldm_image_generator_tpu_torch.config import UNetConfig
    from ldm_image_generator_tpu_torch.models.layers import RandomMoE
    from ldm_image_generator_tpu_torch.models.unet import UNet
    from ldm_image_generator_tpu_torch.pipelines import guide

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = UNet(cfg or UNetConfig(), device="cpu",
               generator=torch.Generator().manual_seed(1)).eval()
    card = copy.deepcopy(cpu).to(dev)
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((batch, latent, latent, 8), generator=gen)
    t = torch.tensor([526, 31, 260, 999][:batch], dtype=torch.int32)
    plan = torch.randint(0, 6, (cpu.plan_length(),), generator=gen)
    classes = cpu.cfg.num_classes

    def predict(unet, d):
        run = lambda cond: unet(x.to(d), t.to(d), cond, moe_plan=plan.to(d)).float()
        if not classes:
            return run(None)
        ids = lambda c: torch.full((batch,), c, dtype=torch.int32, device=d)
        return guide(run(ids(1)), run(ids(classes)), 3.0, 0.7)

    with torch.no_grad():
        ref = predict(cpu, "cpu")
        got = predict(card, dev).cpu()
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    what = f"guided, {classes} classes" if classes else f"ffn_quant={cpu.cfg.ffn_quant}"
    log(f"card vs cpu fp32 step ({what}, latent {latent}, B={batch}): max abs err "
        f"{err:.3e}, output max {scale:.3e}")
    if cpu.cfg.ffn_quant == "int8":
        # the int8 weights each side made (quantize_cols on its own device)
        made = [(a.ffn_weights(torch.float32)[1][0], b.ffn_weights(torch.float32)[1][0])
                for a, b in zip(cpu.modules(), card.modules()) if isinstance(a, RandomMoE)]
        differ = sum(int((x != y.cpu()).sum()) for w, v in made for x, y in zip(w, v))
        log(f"card vs cpu int8 weights: {differ} of "
            f"{sum(x.numel() for w, _ in made for x in w)} values differ")
        require(differ == 0, "quantize_cols on the card equals the CPU's")
    require(torch.isfinite(got).all(), "card step output finite")
    require(err <= STEP_REL_TOL * scale, (err, scale))
    return err / scale


# the conditional operating point of QUALITY_COND_r05.json
COND_CLASSES = 3
CFG_SCALE = 3.0


def timed_samples(sample, batch: int, calls: int = 3) -> dict:
    """Host seconds of `calls` synchronised sample() calls after one
    warm-up, and images/s over their mean."""
    sample()
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return dict(sample_s=times, images_per_s=batch / (sum(times) / len(times)))


def run_counted(sample, batch: int, want: dict, what: str, image: int = 256,
                latent=(32, 32, 8)) -> dict:
    """Launch counts of one sample() call (counts set to 0 just before and
    read just after), gated to equal `want`; uint8 images [batch, image,
    image, 3] and a finite [batch, *latent] latent (latent None: a
    pixel-space sample, no latent)."""
    torch.cuda.synchronize()
    reset_launch_counts()
    img, z = sample()
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"{what} launches", json.dumps(counts))
    expect = dict.fromkeys(counts, 0)
    expect.update(want)
    require(counts == expect, (what, counts))
    require(img.dtype == torch.uint8 and tuple(img.shape) == (batch, image, image, 3),
            (what, img.shape))
    if latent is not None:
        require(tuple(z.shape) == (batch, *latent) and torch.isfinite(z).all(),
                (what, f"final latent finite and [B, {latent}]"))
    return counts


def measure_path(name: str, make_sample, batch: int, want: dict, **shapes) -> dict:
    """One sampling path: exact launch counts (fatal), images/s over 3
    timed calls after a warm-up, device-busy ms of one profiled call.
    make_sample(seed) -> a call returning (images, latent); `shapes`:
    run_counted's image and latent."""
    counts = run_counted(make_sample(0), batch, want, name, **shapes)
    out = dict(launches=counts, **timed_samples(make_sample(1), batch))
    prof = profile_fn(make_sample(2))
    out.update(device_busy_ms=prof["device_busy_ms"], profiled_wall_ms=prof["wall_ms"])
    log(f"{name}: images/s {out['images_per_s']:.4f} (sample seconds {out['sample_s']}), "
        f"device busy {out['device_busy_ms']:.3f} ms")
    return out


def phase_dpm_deepcache(dev, pipe) -> dict:
    """DPM-Solver++(2M) at 10 steps and DeepCache (interval 2, 20 DDIM
    steps) at B=1 on the unconditional pipeline of phase 3."""
    def make(seed, **kw):
        gen = torch.Generator(device=dev).manual_seed(100 + seed)
        return lambda: pipe.sample(gen, batch=1, image_size=256, return_latent=True, **kw)

    out = {"dpm10_b1": measure_path(
        "dpm++2m 10 steps b1", lambda seed: make(seed, num_steps=10, sampler="dpm++2m"), 1,
        {"block_core": 10 * 36, "window_mha": 10 * 8})}
    # 10 fresh steps run every block, 10 cached ones enc_stage_0 and
    # dec_stage_0 only: 3 + 3 blocks, 2 of them attention blocks
    out["deepcache2_b1"] = measure_path(
        "deepcache interval 2 b1", lambda seed: make(seed, num_steps=20, cache_interval=2),
        1, {"block_core": 10 * 36 + 10 * 6, "window_mha": 10 * 8 + 10 * 2})
    return out


def cfg_sample(pipe, dev, batch: int):
    """make_sample(seed) for phase 10's guided sample at `batch`: class
    ids, guidance CFG_SCALE, rescale 0; at B=4 per-sample scales,
    rescales and one negative class."""
    ids = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    if batch == 1:
        kw = dict(condition=ids([1]), guidance_scale=CFG_SCALE, cfg_rescale=0.0)
    else:
        kw = dict(condition=ids([0, 1, 2, 1]),
                  guidance_scales=torch.tensor([1.0, 3.0, 3.0, 5.0], device=dev),
                  cfg_rescales=torch.tensor([0.0, 0.0, 0.7, 0.0], device=dev),
                  negative_condition=ids([COND_CLASSES] * 3 + [2]))

    def make(seed):
        gen = torch.Generator(device=dev).manual_seed(200 + 10 * batch + seed)
        return lambda: pipe.sample(gen, batch=batch, image_size=256, num_steps=20,
                                   return_latent=True, **kw)
    return make


def phase_cond(dev) -> tuple:
    """Class-conditional sampling with CFG at B=1 and B=4, then with int8
    FFN weights at B=1 (phase 10). Returns (results, the bf16 pipeline,
    its fp32 UNet and decoder)."""
    from ldm_image_generator_tpu_torch.config import UNetConfig, VAEConfig
    from ldm_image_generator_tpu_torch.models.unet import UNet
    from ldm_image_generator_tpu_torch.models.vae import Decoder
    from ldm_image_generator_tpu_torch.pipelines import LDMPipeline

    t0 = time.perf_counter()
    cfg = UNetConfig(num_classes=COND_CLASSES)
    # the weights LDMPipeline.random(cfg, seed=0) makes, kept for phase 12
    gen = torch.Generator(device=dev).manual_seed(0)
    modules = (UNet(cfg, device=dev, generator=gen),
               Decoder(VAEConfig(), device=dev, generator=gen))
    pipe = LDMPipeline(*modules, dtype=torch.bfloat16)
    log(f"cond: default UNet, {COND_CLASSES} classes, "
        f"{sum(p.numel() for p in pipe.unet.parameters())} params, built in "
        f"{time.perf_counter() - t0:.2f} s")
    # two UNet calls per step (the class, then the null or negative class)
    out = {"cfg_b1": measure_path("cfg b1", cfg_sample(pipe, dev, 1), 1,
                                  {"block_core": 20 * 2 * 36, "window_mha": 20 * 2 * 8}),
           "cfg_b4": measure_path("cfg b4 mixed", cfg_sample(pipe, dev, 4), 4,
                                  {"ffn_block": 20 * 2 * 36, "window_mha": 20 * 2 * 8})}
    int8 = LDMPipeline.random(dataclasses.replace(cfg, ffn_quant="int8"),
                              dtype=torch.bfloat16, device=dev, seed=0)
    out["cfg_int8_b1"] = measure_path(
        "cfg int8 b1", cfg_sample(int8, dev, 1), 1,
        {"block_core_int8": 20 * 2 * 36, "window_mha": 20 * 2 * 8})
    del int8
    return out, pipe, modules


def phase_param_files(dev, pipe, unet, decoder) -> dict:
    """`unet` (the fp32 conditional UNet `pipe` samples) written as a flax
    parameter file under build/ and read into a fresh UNet on the card:
    every parameter bitwise equal, and a B=1 CFG sample from it bitwise
    the in-memory weights' sample."""
    from ldm_image_generator_tpu_torch.convert import load_flax_file, save_flax_file
    from ldm_image_generator_tpu_torch.models.unet import UNet
    from ldm_image_generator_tpu_torch.pipelines import LDMPipeline

    os.makedirs("build", exist_ok=True)
    path = os.path.join("build", "chip_smoke_cond_unet.msgpack")
    t0 = time.perf_counter()
    save_flax_file(unet, path)
    write_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    fresh = UNet(unet.cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(99))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    load_flax_file(fresh, path)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    want, got = unet.state_dict(), fresh.state_dict()
    differ = [n for n in want if not torch.equal(want[n], got[n])]
    require(want.keys() == got.keys() and not differ, ("parameters differ", differ[:5]))
    samples = []
    for p in (pipe, LDMPipeline(fresh, decoder, dtype=torch.bfloat16)):
        img, z = cfg_sample(p, dev, 1)(7)()
        samples.append((img, z))
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(*samples))
    log(f"param files: {size} bytes, write {write_s:.3f} s, read into the card "
        f"{read_s:.3f} s; {len(want)} tensors bitwise equal; CFG sample from the "
        f"file bitwise equal: {same}")
    require(same, "the reloaded weights' CFG sample equals the in-memory weights'")
    # the sampling CLI on the file: 3 classes, CFG, DPM-Solver++ at 10 steps
    outdir = os.path.join("build", "chip_smoke_cli")
    argv = [sys.executable, "-m", "ldm_image_generator_tpu_torch.cli.sample_ldm",
            "--num-classes", str(COND_CLASSES), "--class-id", "1", "--guidance-scale",
            str(CFG_SCALE), "--sampler", "dpm++2m", "-t", "10", "-dp", path, "-s", "256",
            "-n", "2", "-fp16", "true", "-o", outdir]
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    cli = subprocess.run(argv, capture_output=True, text=True, timeout=600, env=env)
    cli_s = time.perf_counter() - t0
    os.remove(path)
    log(f"param files: sample_ldm CLI exit {cli.returncode} in {cli_s:.2f} s: "
        f"{cli.stdout.strip()} {cli.stderr.strip()[-2000:]}")
    pngs = [os.path.join(outdir, f"{i}.png") for i in range(2)]
    require(cli.returncode == 0 and f"Loaded checkpoint: {path}" in cli.stdout
            and all(os.path.getsize(p) > 0 for p in pngs), "sample_ldm CLI on the file")
    return dict(bytes=size, write_s=write_s, read_s=read_s, tensors=len(want),
                cli_s=cli_s)


# phase 13: the served model (phase 10's), its buckets, the step tier
# beside the default 20 steps and the img2img strength
SERVE_BUCKETS = (1, 2, 4, 8)
SERVE_TIER = 10
SERVE_STRENGTH = 0.6
SERVE_LOAD = 64


def png_pixels(data: bytes):
    """uint8 [H, W, 3] of an 8-bit RGB PNG whose rows all use filter 0 (the
    files cli/sample_ldm.png_bytes writes)."""
    import struct
    import zlib

    import numpy as np

    require(data[:8] == b"\x89PNG\r\n\x1a\n", "PNG signature")
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        chunks[tag] = chunks.get(tag, b"") + data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h, depth, kind = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    require((depth, kind) == (8, 2), ("PNG type", depth, kind))
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, 1 + 3 * w)
    require(not rows[:, 0].any(), "PNG rows use filter 0")
    return rows[:, 1:].reshape(h, w, 3)


def phase_serving(dev) -> dict:
    """Phase 13 (see the module docstring)."""
    import numpy as np

    from ldm_image_generator_tpu_torch.cli import serve
    from ldm_image_generator_tpu_torch.config import UNetConfig, VAEConfig
    from ldm_image_generator_tpu_torch.diffusion.ddpm import ddim_step_pairs
    from ldm_image_generator_tpu_torch.models.unet import UNet
    from ldm_image_generator_tpu_torch.models.vae import Decoder, Encoder
    from ldm_image_generator_tpu_torch.pipelines import LDMPipeline, img2img_steps
    from ldm_image_generator_tpu_torch.serving import SamplerServer

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    pipe = LDMPipeline(UNet(UNetConfig(num_classes=COND_CLASSES), device=dev, generator=gen),
                       Decoder(VAEConfig(), device=dev, generator=gen),
                       dtype=torch.bfloat16,
                       encoder=Encoder(VAEConfig(), device=dev, generator=gen))
    variants, tiers = serve.make_variants(pipe, [256], num_steps=20, step_tiers=[SERVE_TIER],
                                          img2img_strength=SERVE_STRENGTH)
    log(f"serving: variants {list(variants)}, built in {time.perf_counter() - t0:.2f} s")
    server = lambda **kw: SamplerServer(variants, batch_buckets=SERVE_BUCKETS, max_wait_ms=5,
                                        num_classes=COND_CLASSES, device=dev, **kw)
    null = COND_CLASSES
    rows = lambda seeds: torch.stack([serve.draw_noise(s, (32, 32, 8)) for s in seeds]).to(dev)
    ids = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    routing = lambda: torch.Generator(device=dev).manual_seed(0)
    # two img2img payloads: seeded images in [-1, 1]; the second keeps its
    # left half (keep channel 1 there)
    pix = torch.rand((2, 256, 256, 3), generator=torch.Generator().manual_seed(3)) * 2 - 1
    payloads = np.concatenate([pix.numpy(), np.zeros((2, 256, 256, 1), np.float32)], -1)
    payloads[1, :, :128, 3] = 1.0
    i2i_calls = len(ddim_step_pairs(1000, 20, img2img_steps(1000, SERVE_STRENGTH, 20))[0])

    def direct_i2i(seeds):
        keep = payloads[..., 3:]
        return pipe.img2img(torch.from_numpy(payloads[..., :3]), routing(),
                            strength=SERVE_STRENGTH, num_steps=20,
                            mask=torch.from_numpy(1.0 - keep), condition=ids([null] * 2),
                            fwd_noise=rows(seeds))

    groups = [  # name, variant, bucket, requests, launches, direct call(seeds)
        ("serve_uncond_b8", 256, 8, [dict(seed=100 + i) for i in range(8)],
         {"ffn_block": 720, "window_mha": 160},
         lambda seeds: pipe.sample(routing(), batch=8, image_size=256, num_steps=20,
                                   init_noise=rows(seeds), condition=ids([null] * 8))),
        ("serve_cfg_b4", ("cfg", 256), 4,
         [dict(seed=200, class_id=0, guidance=3.0),
          dict(seed=201, class_id=1, guidance=3.0, cfg_rescale=0.7),
          dict(seed=202, class_id=2, guidance=5.0, negative_class=0)],
         {"ffn_block": 1440, "window_mha": 320},
         lambda seeds: pipe.sample(
             routing(), batch=4, image_size=256, num_steps=20, init_noise=rows(seeds),
             condition=ids([0, 1, 2, null]),
             guidance_scales=torch.tensor([3.0, 3.0, 5.0, 1.0], device=dev),
             cfg_rescales=torch.tensor([0.0, 0.7, 0.0, 0.0], device=dev),
             negative_condition=ids([null, null, 0, null]))),
        ("serve_tier10_b1", ("steps", SERVE_TIER, 256), 1, [dict(seed=300)],
         {"block_core": SERVE_TIER * 36, "window_mha": SERVE_TIER * 8},
         lambda seeds: pipe.sample(routing(), batch=1, image_size=256, num_steps=SERVE_TIER,
                                   init_noise=rows(seeds), condition=ids([null]))),
        ("serve_img2img_b2", ("img2img", 256), 2,
         [dict(seed=400, payload=payloads[0]), dict(seed=401, payload=payloads[1])],
         {"block_core": 36 * i2i_calls, "window_mha": 8 * i2i_calls}, direct_i2i),
    ]
    out, served = {}, {}
    for name, variant, bucket, reqs, want, direct in groups:
        srv = server()
        futs = [srv.submit(variant=variant, **r) for r in reqs]
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        with srv:
            imgs = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        counts = launch_counts()
        expect = dict.fromkeys(counts, 0)
        expect.update(want)
        snap = srv.stats.snapshot()
        log(f"{name}: launches {json.dumps(counts)}; stats batches {snap['batches']} "
            f"images {snap['images']} padded {snap['padded_images']}; {wall:.3f} s")
        require(counts == expect, (name, counts))
        require((snap["batches"], snap["images"], snap["padded_images"])
                == (1, len(reqs), bucket - len(reqs)), (name, snap))
        seeds = [r["seed"] for r in reqs] + [0] * (bucket - len(reqs))
        ref = direct(seeds).cpu().numpy()
        same = all(img.shape == (256, 256, 3) and img.dtype == np.uint8
                   and np.array_equal(img, ref[i]) for i, img in enumerate(imgs))
        log(f"{name}: served images bitwise the direct call's: {same}")
        require(same, (name, "served images equal the direct pipeline call's"))
        out[name] = dict(launches=counts, wall_s=wall, stats=snap)
        served[name] = imgs
    out["img2img_unet_calls"] = i2i_calls
    # the same seed alone at bucket 1 against inside bucket 8
    srv = server()
    fut = srv.submit(100)
    with srv:
        alone = fut.result(timeout=600)
    out["b1_vs_b8_max_uint8_diff"] = int(np.abs(
        alone.astype(np.int32) - served["serve_uncond_b8"][0].astype(np.int32)).max())
    log(f"serving: seed 100 at bucket 1 vs inside bucket 8: max uint8 difference "
        f"{out['b1_vs_b8_max_uint8_diff']}")
    out["http"] = check_http(dev, server, tiers)
    out["load"] = serve_load(server)
    return out


def check_http(dev, server, tiers) -> dict:
    """The HTTP handler on loopback with PNG bodies (phase 13)."""
    import http.client
    import threading
    from http.server import ThreadingHTTPServer

    from ldm_image_generator_tpu_torch.cli import serve
    from ldm_image_generator_tpu_torch.cli.sample_ldm import png_bytes

    def fetch(port, path, method="GET", body=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        try:
            conn.request(method, path, body)
            r = conn.getresponse()
            return r.status, r.getheader("Content-Type"), r.read()
        finally:
            conn.close()

    def serving_http(srv):
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(
            srv, png_bytes, 256, step_tiers=tiers, default_steps=20,
            content_type="image/png"))
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()

        def close():
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=60)
            require(not thread.is_alive(), "HTTP server thread stopped")
        return httpd.server_address[1], close

    out = {}
    srv = server()
    port, close = serving_http(srv)
    srv.start()
    try:
        status, ctype, body = fetch(port, "/sample?seed=500")
        require(status == 200 and ctype == "image/png", ("GET /sample", status, ctype))
        mine = srv.submit(500).result(timeout=600)
        require((png_pixels(body) == mine).all(), "GET /sample PNG equals the served image")
        items = [{"seed": 600}, {"seed": 601, "class_id": 1, "guidance_scale": 3.0},
                 {"seed": 602, "steps": SERVE_TIER}, {"seed": 603, "class_id": 2}]
        status, ctype, raw = fetch(port, "/sample_batch", "POST", json.dumps({"items": items}))
        require(status == 200 and ctype.startswith("multipart/mixed"), ("batch", status))
        index = set()
        for part in raw.split(b"--ldmframe"):
            if b"X-Index: " in part:
                head, data = part.split(b"\r\n\r\n", 1)
                require(b"Content-Type: image/png" in head, head)
                require(png_pixels(data[:-2]).shape == (256, 256, 3), "part image")
                index.add(int(head.split(b"X-Index: ")[1].split(b"\r\n")[0]))
        require(index == {0, 1, 2, 3}, ("X-Index", index))
        status, _, text = fetch(port, "/metrics")
        require(status == 200 and b"ldm_images_total" in text, "/metrics")
        status, _, health = fetch(port, "/healthz")
        require(status == 200 and json.loads(health)["ok"] is True, "/healthz")
        status, _, body = fetch(port, f"/sample?seed=1&class_id={COND_CLASSES + 4}")
        require(status == 400 and b"out of range" in body, ("class_id out of range", status))
        out["images_served"] = srv.stats.images
    finally:
        close()
        srv.stop()
    full = server(max_queue=1)  # no worker: one request fills the queue
    full.submit(0)
    port, close = serving_http(full)
    try:
        status, _, body = fetch(port, "/sample?seed=2&priority=high")
        require(status == 503, ("a full queue is 503", status, body))
    finally:
        close()
    log("serving http: GET /sample PNG equal, POST /sample_batch X-Index 0-3, /metrics, "
        "/healthz, 400 on a class_id out of range, 503 on a full queue")
    return out


def serve_load(server) -> dict:
    """SERVE_LOAD unconditional requests queued at once: images/s from
    the worker's start to the last result, the stats' mean batch (8) and
    latency percentiles; then the same again under the profiler for the
    card's busy share."""
    def run():
        srv = server()
        futs = [srv.submit(1000 + i) for i in range(SERVE_LOAD)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with srv:
            for f in futs:
                f.result(timeout=600)
        return time.perf_counter() - t0, srv.stats.snapshot()

    wall, snap = run()
    require(snap["mean_batch"] == 8.0 and snap["images"] == SERVE_LOAD, snap)
    prof = profile_fn(run)
    out = dict(images_per_s=SERVE_LOAD / wall, wall_s=wall, mean_batch=snap["mean_batch"],
               p50_ms=snap["latency"]["p50_ms"], p99_ms=snap["latency"]["p99_ms"],
               mean_latency_ms=snap["latency"]["mean_ms"],
               device_busy_ms=prof["device_busy_ms"], profiled_wall_ms=prof["wall_ms"],
               busy_share=prof["device_busy_ms"] / prof["wall_ms"],
               busy_share_of_unprofiled_wall=prof["device_busy_ms"] / (wall * 1e3))
    log(f"serving load ({card_line()}): {SERVE_LOAD} requests in {wall:.3f} s, "
        f"{out['images_per_s']:.4f} images/s, mean batch {out['mean_batch']}, latency "
        f"p50 {out['p50_ms']} ms p99 {out['p99_ms']} ms (histogram bucket edges), mean "
        f"{out['mean_latency_ms']} ms; card busy {out['device_busy_ms']:.3f} ms, "
        f"{out['busy_share']:.3f} of the profiled window, "
        f"{out['busy_share_of_unprofiled_wall']:.3f} of the unprofiled one")
    return out


def phase_img2img_card_vs_cpu(dev) -> dict:
    """The img2img path's new work in fp32, card vs CPU: the default
    Encoder at 256px, q_sample to t_start, the mask resize and one
    projected DDIM step (t_start -> 0) of the default UNet under one
    routing plan, each at STEP_REL_TOL of its scale."""
    from ldm_image_generator_tpu_torch.config import DDPMConfig, UNetConfig, VAEConfig
    from ldm_image_generator_tpu_torch.diffusion.ddpm import (
        ddim_sample,
        make_schedule,
        q_sample,
    )
    from ldm_image_generator_tpu_torch.models.unet import UNet
    from ldm_image_generator_tpu_torch.models.vae import Encoder
    from ldm_image_generator_tpu_torch.pipelines import (
        img2img_steps,
        inpaint_projection,
        resize_mask,
    )

    gen = torch.Generator().manual_seed(5)
    enc = Encoder(VAEConfig(), device="cpu", generator=gen).eval()
    unet = UNet(UNetConfig(), device="cpu", generator=gen).eval()
    image = torch.rand((1, 256, 256, 3), generator=gen) * 2 - 1
    mask = torch.zeros((1, 256, 256, 1))
    mask[:, :, 100:] = 1.0
    eps, proj = (torch.randn((1, 32, 32, 8), generator=gen) for _ in range(2))
    plan = torch.randint(0, 6, (unet.plan_length(),), generator=gen)
    schedule = make_schedule(DDPMConfig())
    t_start = img2img_steps(1000, SERVE_STRENGTH, 20)[-1]

    def run(d, enc, unet):
        z0 = enc(image.to(d)).float()
        x = q_sample(schedule, z0, torch.full((1,), t_start, dtype=torch.int32, device=d),
                     eps.to(d))
        m = resize_mask(mask.to(d), 32)
        denoise = lambda x, t: unet(x, torch.tensor([t], dtype=torch.int32, device=d),
                                    moe_plan=plan.to(d)).float()
        z = ddim_sample(denoise, schedule, tuple(z0.shape), steps=[t_start], init_noise=x,
                        device=d, project_fn=inpaint_projection(schedule, z0, m),
                        project_noise=proj[None].to(d))
        return dict(encoder=z0, q_sample=x, mask=m, projected_step=z)

    with torch.no_grad():
        t0 = time.perf_counter()
        ref = run("cpu", enc, unet)
        cpu_s = time.perf_counter() - t0
        got = run(dev, copy.deepcopy(enc).to(dev), copy.deepcopy(unet).to(dev))
    out = {}
    for name, want in ref.items():
        err = (got[name].cpu() - want).abs().max().item()
        scale = want.abs().max().item()
        log(f"img2img card vs cpu fp32 {name}: max abs err {err:.3e}, max {scale:.3e}")
        require(torch.isfinite(got[name]).all() and err <= STEP_REL_TOL * scale,
                (name, err, scale))
        out[name] = err / scale
    out["cpu_s"] = cpu_s
    return out


def launch_counts() -> dict:
    from ldm_image_generator_tpu_torch.kernels import block_core as tbc
    from ldm_image_generator_tpu_torch.kernels import ffn_block as tffn
    from ldm_image_generator_tpu_torch.kernels import vq as tvq
    from ldm_image_generator_tpu_torch.kernels import window_attention as tattn

    return dict(block_core=tbc.launches, ffn_block=tffn.launches,
                ffn_block_bwd=tffn.bwd_launches, window_mha=tattn.launches,
                window_mha_bwd=tattn.bwd_launches, vq=tvq.launches,
                block_core_int8=tbc.int8_launches, ffn_block_int8=tffn.int8_launches)


def reset_launch_counts() -> None:
    from ldm_image_generator_tpu_torch.kernels import block_core as tbc
    from ldm_image_generator_tpu_torch.kernels import ffn_block as tffn
    from ldm_image_generator_tpu_torch.kernels import vq as tvq
    from ldm_image_generator_tpu_torch.kernels import window_attention as tattn

    tbc.launches = tffn.launches = tffn.bwd_launches = 0
    tattn.launches = tattn.bwd_launches = tvq.launches = 0
    tbc.int8_launches = tffn.int8_launches = 0


def make_trainer(dev, seed: int, dtype, ema: bool, cfg=None, optimizer: str = "adamw",
                 dp=None, zero1: bool = False, stages: int = 0, objective=None):
    """(state, step) for the UNet of `cfg` (default: the default UNet) on
    dev: fp32 parameters from `seed`, `optimizer` (AdamW, or the pixel
    DDPM's RAdam) lr 1e-4, eps-prediction L1, stochastic depth on; a
    conditional UNet's step takes labels (dropped to the null class at
    COND_DROP) or class ids (`cond`). dp: a parallel.mesh.DataParallel
    the step is one rank of (zero1: its moments split over it); stages:
    the UNet's deep stacks pipelined in that many stages on dev, one
    microbatch per stage; objective: (prediction, zero terminal SNR,
    Min-SNR gamma or None), default eps-prediction."""
    from ldm_image_generator_tpu_torch.config import DDPMConfig, UNetConfig
    from ldm_image_generator_tpu_torch.diffusion.ddpm import make_schedule
    from ldm_image_generator_tpu_torch.models.unet import UNet
    from ldm_image_generator_tpu_torch.train.steps import (
        LDMTrainState,
        init_ema,
        make_ldm_train_step,
        make_optimizer,
    )

    from ldm_image_generator_tpu_torch.parallel.mesh import Zero1
    from ldm_image_generator_tpu_torch.parallel.pipelined_unet import PipelinedUNet

    cfg = cfg or UNetConfig()
    unet = UNet(cfg, device=dev,
                generator=torch.Generator(device=dev).manual_seed(seed))
    tx = make_optimizer(optimizer, 1e-4,
                        zero1=Zero1(list(unet.parameters()), dp) if zero1 else None)
    state = LDMTrainState(params=unet, opt_state=tx.init(list(unet.parameters())),
                          ema_params=init_ema(unet) if ema else None)
    prediction, zero_snr, gamma = objective or ("eps", False, None)
    step = make_ldm_train_step(unet, make_schedule(DDPMConfig(prediction=prediction,
                                                              zero_terminal_snr=zero_snr)),
                               tx, prediction=prediction, min_snr_gamma=gamma,
                               ema_decay=0.999 if ema else None, dtype=dtype,
                               num_classes=cfg.num_classes, cond_drop=COND_DROP,
                               reduce_grads=dp,
                               apply_fn=PipelinedUNet(unet, [dev] * stages) if stages else None)
    return state, step


def phase_train(dev) -> dict:
    """The training path at B=8: launch counts, finiteness, steps/s."""
    t0 = time.perf_counter()
    state, step = make_trainer(dev, seed=0, dtype=torch.bfloat16, ema=True)
    unet = state.params
    log(f"train: default UNet {sum(p.numel() for p in unet.parameters())} fp32 "
        f"params, AdamW + EMA state built in {time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device=dev).manual_seed(0)
    data = torch.Generator(device=dev).manual_seed(1)
    batch = lambda: torch.randn((TRAIN_BATCH, 32, 32, 8), generator=data, device=dev)
    state, m = step(state, batch(), generator=gen)  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    losses = []
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, m = step(state, batch(), generator=gen)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    log("train launches", json.dumps(counts), f"over {TRAIN_STEPS} steps")
    require(counts == {k: v * TRAIN_STEPS for k, v in TRAIN_LAUNCHES.items()}, counts)
    losses = [x.item() for x in losses]
    log("train losses", losses)
    require(all(math.isfinite(x) for x in losses), losses)
    params = list(unet.named_parameters())
    missing = [n for n, p in params if p.grad is None]
    require(not missing, f"parameters without a gradient: {missing[:5]}")
    require(all(torch.isfinite(p).all() for _, p in params), "finite parameters")
    require(all(torch.isfinite(e).all() for e in state.ema_params.values()),
            "finite EMA")
    out = dict(launches=counts, losses=losses, train_s=dt,
               steps_per_s=TRAIN_STEPS / dt,
               images_per_s=TRAIN_STEPS * TRAIN_BATCH / dt,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    log(f"train: {TRAIN_STEPS} steps in {dt:.4f} s, {out['steps_per_s']:.4f} "
        f"steps/s, {out['images_per_s']:.4f} images/s at B={TRAIN_BATCH}")
    out["profile"] = profile_fn(lambda: step(state, batch(), generator=gen))
    return out


def profile_fn(fn, host_spans: bool = False) -> dict:
    """Device time by kernel name over one call of fn (torch.profiler),
    which must show some. The card's activity only (the host's ops would
    multiply the events the profiler parses after the call), but with
    host_spans, which also sums the host spans of the process group's
    collectives (gloo or nccl ops)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_spans else [])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    rows = []  # device kernels only: CPU ops also carry their kernels' time
    for ev in events:
        dev_us = getattr(ev, "self_device_time_total", 0.0) or 0.0
        if dev_us > 0 and "CUDA" in str(getattr(ev, "device_type", "")):
            rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    require(busy_ms > 0, "the profiler saw no device time")
    collective_ms = sum(ev.cpu_time_total for ev in events
                        if ev.key.startswith(("gloo:", "nccl:"))) / 1e3
    for ms, count, key in rows[:25]:
        log(f"profile {ms:10.3f} ms {count:6d}x {key[:90]}")
    log(f"profile: wall {wall_ms:.3f} ms (profiled), device busy {busy_ms:.3f} ms, "
        f"collectives {collective_ms:.3f} ms")
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms, collective_ms=collective_ms,
                top=[dict(ms=r[0], count=r[1], name=r[2][:90]) for r in rows[:25]])


def record_preactivations(unet, append: bool = False) -> tuple:
    """Forward hooks on every block's MoE FFN and FiLM first layer:
    ({module name: record}, hook handles); with `append` the rows of a
    module's later calls (a pipeline's microbatches, in order) are
    appended to its record. An FFN's record is (b, near,
    ids) for its three towers (general, then the routed experts ids):
    b = h @ wb + bb [3, N, M] (int8 weights: at their dequantized copies)
    and where b lies within C * 2**-23 * (|h| @ |wb| + |bb|) of 0, the
    most two fp32 sums over C terms in other orders can differ (this one
    and a kernel's). A FiLM first layer's record is
    where its output, the ReLU's input, is > 0."""
    from ldm_image_generator_tpu_torch.models.layers import FiLMProj1, RandomMoE

    rec, handles = {}, []

    def moe_hook(m, args, kwargs, out, name):
        h = out[1].detach().float().flatten(0, -2)
        ids = m.expert_ids(kwargs.get("expert_ids"), kwargs.get("pair_id")).tolist()
        bs, near = [], []
        with torch.no_grad():
            gwb, gbb, wbs, bbs = m.gwb, m.gbb, m.wb, m.bb
            if m.quant == "int8":  # the weights the forward ran at
                dq = m.ffn_weights(h.dtype, dequantized=True)[1][1]
                gwb, gbb, wbs, bbs = dq[2], dq[3], dq[8], dq[9]
            for wb, bb in [(gwb, gbb)] + [(wbs[e], bbs[e]) for e in ids]:
                wb, bb = wb.float(), bb.float()
                b = h @ wb + bb
                bound = h.shape[1] * 2.0 ** -23 * (h.abs() @ wb.abs() + bb.abs())
                bs.append(b)
                near.append(b.abs() <= bound)
        new = (torch.stack(bs), torch.stack(near), ids)
        if append and name in rec:
            old = rec[name]
            new = (torch.cat([old[0], new[0]], 1), torch.cat([old[1], new[1]], 1), ids)
        rec[name] = new

    def film_hook(o, name):
        new = o.detach() > 0
        rec[name] = torch.cat([rec[name], new]) if append and name in rec else new

    for name, mod in unet.named_modules():
        if isinstance(mod, RandomMoE):
            handles.append(mod.register_forward_hook(
                lambda m, a, k, o, name=name: moe_hook(m, a, k, o, name),
                with_kwargs=True))
        elif isinstance(mod, FiLMProj1):
            handles.append(mod.register_forward_hook(
                lambda m, a, o, name=name: film_hook(o, name)))
    return rec, handles


def flip_units(cpu_rec: dict, card_rec: dict) -> dict:
    """{module name: bool [towers or 1, units]}: the hidden units whose
    ReLU the CPU and the card may have decided apart on some row. FiLM
    first layer: its output on opposite sides of 0 (exact: both sides'
    ReLU read these values). FFN tower: b from the CPU's h and from the
    card's h on opposite sides of 0, or the card's b near 0 (the card's
    kernel sums in another order than the product here)."""
    units = {}
    for name, cpu in cpu_rec.items():
        card = card_rec[name]
        if isinstance(cpu, torch.Tensor):
            units[name] = (cpu != card.cpu()).flatten(0, -2).any(0)[None]
            continue
        turned = (cpu[0] > 0) != (card[0] > 0).cpu()
        units[name] = (turned | card[1].cpu()).any(1)
    return units


def explain_flip(name: str, over: torch.Tensor, units: dict, cpu_rec: dict,
                 explained_blocks: set):
    """Why the gradient `name` may differ beyond tolerance where `over`
    is True, or None: its offending columns are units that may have
    flipped (FFN b path, FiLM first layer), or it lies in a block with
    such a gradient."""
    mod, leaf = name.rsplit(".", 1)
    if mod.endswith(".ffn") and leaf in ("gwb", "gbb", "wb", "bb"):
        flips, ids = units[mod], cpu_rec[mod][2]
        if leaf in ("gwb", "gbb"):
            parts = [(over, flips[0])]
        else:  # stacked experts: expert e is tower 1 + j where ids[j] == e
            parts = [(over[e], flips[[1 + j for j, i in enumerate(ids) if i == e]].any(0))
                     for e in range(over.shape[0]) if over[e].any()]
        for o, allowed in parts:
            if (o.reshape(-1, o.shape[-1]).any(0) & ~allowed).any():
                return None
        return f"FFN b units that may have flipped in {mod}"
    if mod.endswith(".encodings.proj1"):
        cols = over.reshape(-1, over.shape[-1]).any(0)
        return None if (cols & ~units[mod][0]).any() else f"FiLM unit flip in {mod}"
    block = ".".join(name.split(".")[:2])
    if block in explained_blocks:
        return f"downstream of a flip in {block}"
    return None


def phase_train_card_vs_cpu(dev, cfg=None, optimizer: str = "adamw",
                            flip_tensors: int = FLIP_TENSORS, batch: int = 4,
                            latent: int = 32) -> tuple:
    """One fp32 train step at B=`batch` on latent x latent inputs (default
    4 and 32; B <= 2 takes the block_core route), card kernels vs CPU
    plain versions,
    with t, noise, routing, stochastic-depth gates and (a conditional
    `cfg`) class ids injected (TF32 off, as main sets it), at most
    flip_tensors gradients flip-touched; with RAdam, check_radam_replay
    after it. (result, run): run holds the step's start parameters, both
    states, the card's record_preactivations and loss, x and the injected
    draws, for checks of that same step."""
    cpu_state, cpu_step = make_trainer("cpu", seed=3, dtype=torch.float32,
                                       ema=False, cfg=cfg, optimizer=optimizer)
    card_state, card_step = make_trainer(dev, seed=3, dtype=torch.float32,
                                         ema=False, cfg=cfg, optimizer=optimizer)
    card_state.params.load_state_dict(cpu_state.params.state_dict())
    start = {n: p.detach().clone() for n, p in cpu_state.params.named_parameters()}
    gen = torch.Generator().manual_seed(4)
    b = batch
    x = torch.randn((b, latent, latent, cpu_state.params.cfg.input_channels), generator=gen)
    inject = dict(t=torch.randint(1, 1000, (b,), generator=gen),
                  eps=torch.randn(x.shape, generator=gen),
                  moe_plan=torch.randint(0, 6, (cpu_state.params.plan_length(),),
                                         generator=gen),
                  sd_gates=torch.rand(cpu_state.params.plan_length(),
                                      generator=gen) > 0.25)
    if cpu_state.params.cfg.num_classes:
        # class ids after the drop, the null class among them
        inject["cond"] = torch.arange(b) % (cpu_state.params.cfg.num_classes + 1)
    cpu_rec, hooks = record_preactivations(cpu_state.params)
    card_rec, card_hooks = record_preactivations(card_state.params)
    t0 = time.perf_counter()
    _, m_cpu = cpu_step(cpu_state, x, **inject)
    cpu_s = time.perf_counter() - t0
    _, m_card = card_step(card_state, x.to(dev), **{k: v.to(dev) for k, v in inject.items()})
    for handle in hooks + card_hooks:
        handle.remove()
    units = flip_units(cpu_rec, card_rec)
    l_cpu, l_card = m_cpu["loss"].item(), m_card["loss"].item()
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    log(f"train card vs cpu (B={b}, latent {latent}, stages {tuple(cpu_state.params.cfg.stages)}"
        f"): loss {l_card:.8f} vs {l_cpu:.8f} (rel {loss_rel:.3e}), "
        f"cpu step {cpu_s:.1f} s, gates kept {int(inject['sd_gates'].sum())}"
        f"/{inject['sd_gates'].numel()}, units that may have flipped "
        f"{sum(int(u.sum()) for u in units.values())} of "
        f"{sum(u.numel() for u in units.values())}")
    require(loss_rel <= TRAIN_LOSS_REL_TOL, ("loss", l_card, l_cpu))
    cpu_params = dict(cpu_state.params.named_parameters())
    worst, worst_name, flipped = compare_train_grads(
        cpu_params, dict(card_state.params.named_parameters()), units, cpu_rec,
        flip_tensors, "train card vs cpu")
    out = dict(loss_rel=loss_rel, grad_rel=worst, grad_rel_name=worst_name,
               flip_touched=flipped, stages=list(cpu_state.params.cfg.stages), cpu_s=cpu_s)
    if optimizer == "radam":
        out["radam_replay"] = check_radam_replay(
            dev, start, {n: p.grad for n, p in cpu_params.items()})
    run = dict(start=start, cpu_state=cpu_state, card_state=card_state,
               card_rec=card_rec, l_card=l_card, x=x, inject=inject)
    return out, run


def compare_train_grads(want_params: dict, got_params: dict, units: dict,
                        want_rec: dict, flip_tensors: int, what: str) -> tuple:
    """Each gradient of got_params within TRAIN_GRAD_REL_TOL of its max
    abs of want_params' (the same parameter names), a ReLU-boundary flip
    excepted (explain_flip over `units`, at most flip_tensors gradients,
    each within FLIP_REL_TOL and FLIP_COLS), and every slice that is zero
    in `want` zero in `got`: (worst rel, its name, the flip-touched
    names)."""
    worst, worst_name, beyond = 0.0, "", []
    for name, p in want_params.items():
        want, got = p.grad.cpu(), got_params[name].grad.cpu()
        scale = want.abs().max().item()
        if name.endswith("mha.bk"):
            # zero in exact arithmetic (softmax is invariant to a shift of
            # every key's score): both sides hold rounding noise of the
            # scale of the sibling query-bias gradient
            scale = max(scale, want_params[name[:-2] + "bq"].grad.abs().max().item())
        diff = (got - want).abs()
        if scale == 0.0:
            require(diff.max().item() == 0.0, f"{name}: zero in one, not in the other")
            continue
        if want.ndim >= 2:
            zero = want.flatten(1).abs().amax(1) == 0
            require(bool((got[zero] == 0).all()), f"{name}: zero slices differ")
        rel = diff.max().item() / scale
        if rel > TRAIN_GRAD_REL_TOL:
            beyond.append((name, rel, diff > TRAIN_GRAD_REL_TOL * scale))
        elif rel > worst:
            worst, worst_name = rel, name
    # FFN and FiLM-first-layer gradients first: they explain their blocks
    direct = lambda n: n.rsplit(".", 1)[0].endswith((".ffn", ".encodings.proj1"))
    explained_blocks, flipped = set(), []
    for name, rel, over in sorted(beyond, key=lambda r: not direct(r[0])):
        why = explain_flip(name, over, units, want_rec, explained_blocks)
        cols = int(over.reshape(-1, over.shape[-1]).any(0).sum())
        log(f"{what}: {name} {rel:.3e} of its max abs, "
            f"{int(over.sum())} elements in {cols} columns: {why}")
        require(why is not None, f"{name}: beyond {TRAIN_GRAD_REL_TOL} with no "
                                 "ReLU unit that may have flipped")
        require(rel <= FLIP_REL_TOL and cols <= FLIP_COLS, (name, rel, cols))
        if direct(name):
            explained_blocks.add(".".join(name.split(".")[:2]))
        flipped.append(name)
    log(f"{what}: {len(flipped)} of {len(want_params)} gradients "
        f"flip-touched; the rest within {worst:.3e} of max abs ({worst_name})")
    require(len(flipped) <= flip_tensors, flipped)
    return worst, worst_name, flipped


# RAdam's steps replayed on the card over the CPU's gradients: 1-5 its
# bias-corrected momentum, 6-7 its rectified update
RADAM_REPLAY_STEPS = 7


def check_radam_replay(dev, start: dict, grads: dict) -> dict:
    """RAdam (lr 1e-4) from the parameters `start`, applied to the same
    gradients RADAM_REPLAY_STEPS times on the CPU and on the card: after
    each step every card parameter within VAE_OPT_STEP_REL of that
    element's CPU step plus VAE_OPT_REL_TOL of the tensor's max abs of
    the CPU's (phase 9's optimizer tolerance)."""
    from ldm_image_generator_tpu_torch.train.steps import make_optimizer

    names = list(start)
    cpu = [start[n].clone() for n in names]
    card = [start[n].to(dev) for n in names]
    g_cpu = [grads[n] for n in names]
    g_card = [g.to(dev) for g in g_cpu]
    tx_cpu, tx_card = make_optimizer("radam", 1e-4), make_optimizer("radam", 1e-4)
    st_cpu, st_card = tx_cpu.init(cpu), tx_card.init(card)
    worst, bitwise, rectified = (0.0, ""), 0, []
    for k in range(1, RADAM_REPLAY_STEPS + 1):
        before = [p.clone() for p in cpu]
        st_cpu = tx_cpu.apply(cpu, g_cpu, st_cpu)
        st_card = tx_card.apply(card, g_card, st_card)
        rectified.append(tx_cpu.rectifier(k) is not None)
        for name, b, want, got in zip(names, before, cpu, card):
            got = got.cpu()
            diff = (got - want).abs()
            bound = VAE_OPT_STEP_REL * (want - b).abs() + VAE_OPT_REL_TOL * want.abs().max()
            used = torch.where(diff == 0, 0.0, diff / bound).max().item()
            require(used <= 1.0, ("radam card vs cpu", k, name, diff.max().item(), used))
            bitwise += int(torch.equal(got, want))
            if used > worst[0]:
                worst = (used, f"step {k} {name}")
    require(rectified == [False] * 5 + [True] * (RADAM_REPLAY_STEPS - 5), rectified)
    log(f"radam card vs cpu over the CPU's gradients, {RADAM_REPLAY_STEPS} steps "
        f"(rectified from step 6): at most {worst[0]:.3f} of the bound ({worst[1]}); "
        f"{bitwise} of {RADAM_REPLAY_STEPS * len(names)} tensor-steps bitwise")
    return dict(steps=RADAM_REPLAY_STEPS, bound_used=worst, bitwise=bitwise,
                tensor_steps=RADAM_REPLAY_STEPS * len(names))


def make_vae_trainer(dev, seed: int, dtype, dp=None):
    """(state, step) for the default VAE and discriminator on dev: fp32
    parameters from `seed`, Adafactor on both, crop VAE_CROP, computing
    in dtype; dp: the DataParallel group the step is one rank of."""
    from torch import nn

    from ldm_image_generator_tpu_torch.config import DiscriminatorConfig, VAEConfig
    from ldm_image_generator_tpu_torch.models.vae import (
        Decoder,
        Discriminator,
        Encoder,
        VectorQuantizer,
    )
    from ldm_image_generator_tpu_torch.train.steps import (
        VAETrainState,
        make_optimizer,
        make_vae_train_step,
    )

    cfg = VAEConfig()
    gen = torch.Generator(device=dev).manual_seed(seed)
    vae = nn.ModuleDict({
        "encoder": Encoder(cfg, device=dev, generator=gen),
        "decoder": Decoder(cfg, device=dev, generator=gen),
        "quantizer": VectorQuantizer(cfg.num_embeddings, cfg.embedding_dim,
                                     device=dev, generator=gen)})
    disc = Discriminator(DiscriminatorConfig(), device=dev, generator=gen)
    tx_vae, tx_disc = make_optimizer("adafactor"), make_optimizer("adafactor")
    state = VAETrainState(vae_params=vae, disc_params=disc,
                          opt_state_vae=tx_vae.init(list(vae.parameters())),
                          opt_state_disc=tx_disc.init(list(disc.parameters())))
    step = make_vae_train_step(vae["encoder"], vae["decoder"], vae["quantizer"],
                               disc, tx_vae, tx_disc, crop_size=VAE_CROP, dtype=dtype,
                               reduce_grads=dp)
    return state, step


def vae_named_parameters(state) -> dict:
    """{name: parameter} over the VAE (prefixed by its part) and the
    discriminator ("disc.")."""
    out = dict(state.vae_params.named_parameters())
    out.update({f"disc.{n}": p for n, p in state.disc_params.named_parameters()})
    return out


def phase_vae_train(dev) -> dict:
    """VAE + discriminator training at B=8, crop 192, bf16 compute: launch
    counts, finiteness, steps/s."""
    t0 = time.perf_counter()
    state, step = make_vae_trainer(dev, seed=0, dtype=torch.bfloat16)
    params = vae_named_parameters(state)
    log(f"vae train: {sum(p.numel() for p in params.values())} fp32 params in "
        f"{len(params)} tensors, Adafactor state built in "
        f"{time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device=dev).manual_seed(0)
    data = torch.Generator(device=dev).manual_seed(1)
    shape = (VAE_BATCH, VAE_IMAGE, VAE_IMAGE, 3)
    batch = lambda: torch.rand(shape, generator=data, device=dev) * 2 - 1
    state, m, _ = step(state, batch(), generator=gen)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    metrics = []
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, m, (y, crop) = step(state, batch(), generator=gen)
        metrics.append(m)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    log("vae train launches", json.dumps(counts), f"over {TRAIN_STEPS} steps")
    require(counts == {k: v * TRAIN_STEPS for k, v in VAE_LAUNCHES.items()}, counts)
    require(tuple(y.shape) == tuple(crop.shape) == (VAE_BATCH, VAE_CROP, VAE_CROP, 3),
            (y.shape, crop.shape))
    metrics = [{k: v.item() for k, v in mm.items()} for mm in metrics]
    log("vae train metrics", json.dumps(metrics))
    require(all(math.isfinite(v) for mm in metrics for v in mm.values()), metrics)
    missing = [n for n, p in params.items() if p.grad is None]
    require(not missing, f"parameters without a gradient: {missing[:5]}")
    require(all(torch.isfinite(p).all() for p in params.values()), "finite parameters")
    out = dict(launches=counts, metrics=metrics, train_s=dt,
               steps_per_s=TRAIN_STEPS / dt,
               images_per_s=TRAIN_STEPS * VAE_BATCH / dt,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    log(f"vae train: {TRAIN_STEPS} steps in {dt:.4f} s, {out['steps_per_s']:.4f} "
        f"steps/s, {out['images_per_s']:.4f} images/s at B={VAE_BATCH}, "
        f"peak {out['peak_gib']:.3f} GiB")
    out["profile"] = profile_fn(lambda: step(state, batch(), generator=gen))
    return out


def phase_vae_card_vs_cpu(dev) -> dict:
    """One fp32 VAE train step at B=2, card kernels vs CPU plain versions,
    crop offset and latent noise injected (TF32 off, as main sets it)."""
    from ldm_image_generator_tpu_torch.train.steps import make_optimizer

    cpu_state, cpu_step = make_vae_trainer("cpu", seed=3, dtype=torch.float32)
    card_state, card_step = make_vae_trainer(dev, seed=3, dtype=torch.float32)
    card_state.vae_params.load_state_dict(cpu_state.vae_params.state_dict())
    card_state.disc_params.load_state_dict(cpu_state.disc_params.state_dict())
    start = {n: p.detach().clone() for n, p in vae_named_parameters(card_state).items()}
    gen = torch.Generator().manual_seed(4)
    b, side = VAE_CARD_BATCH, VAE_CROP // 8
    images = torch.rand((b, VAE_IMAGE, VAE_IMAGE, 3), generator=gen) * 2 - 1
    offset = tuple(int(v) for v in torch.randint(0, VAE_IMAGE - VAE_CROP + 1, (2,),
                                                 generator=gen))
    noise = torch.randn((b, side, side, 8), generator=gen)
    picked = {}
    for name, st in (("cpu", cpu_state), ("card", card_state)):
        q = st.vae_params["quantizer"]
        orig = q.quantize
        q.quantize = lambda x, orig=orig, name=name: picked.setdefault(name, orig(x))
    t0 = time.perf_counter()
    _, m_cpu, _ = cpu_step(cpu_state, images, crop_offset=offset, noise=noise)
    cpu_s = time.perf_counter() - t0
    _, m_card, _ = card_step(card_state, images.to(dev), crop_offset=offset,
                             noise=noise.to(dev))
    torch.cuda.synchronize()
    for st in (cpu_state, card_state):
        del st.vae_params["quantizer"].quantize
    idx_cpu, idx_card = picked["cpu"].flatten(), picked["card"].cpu().flatten()
    differ = idx_cpu != idx_card
    rows = sorted(set(idx_cpu[differ].tolist()) | set(idx_card[differ].tolist()))
    log(f"vae card vs cpu: cpu step {cpu_s:.1f} s, {int(differ.sum())} of "
        f"{differ.numel()} latents picked another code, codebook rows {rows}")
    metric_rel = {}
    for k, v in m_cpu.items():
        want, got = v.item(), m_card[k].item()
        metric_rel[k] = abs(got - want) / max(abs(want), 1e-30)
        log(f"vae card vs cpu: {k} {got:.8f} vs {want:.8f} (rel {metric_rel[k]:.3e})")
        require(metric_rel[k] <= VAE_METRIC_REL_TOL, (k, got, want))
    cpu_params = vae_named_parameters(cpu_state)
    card_params = vae_named_parameters(card_state)
    names = list(cpu_params)
    # Adafactor on the card over the CPU's gradients from the starting
    # parameters (per tensor, so one optimizer over both nets is the two)
    replay = [start[n].clone() for n in names]
    tx = make_optimizer("adafactor")
    tx.apply(replay, [cpu_params[n].grad.to(dev) for n in names], tx.init(replay))
    worst = dict(grad=(0.0, ""), optimizer=(0.0, ""), param=(0.0, ""),
                 optimizer_bound=(0.0, ""), step_scale=(1.0, ""))
    beyond = {}
    for name, r in zip(names, replay):
        p = cpu_params[name]
        keep = torch.ones_like(p, dtype=torch.bool)
        if name == "quantizer.embeddings":
            keep[rows] = False
        want = p.detach()
        step = (want - start[name].cpu()).abs()
        for what, ref, got in (("grad", p.grad, card_params[name].grad.cpu()),
                               ("optimizer", want, r.cpu()),
                               ("param", want, card_params[name].detach().cpu())):
            diff = (got - ref).abs()[keep]
            scale = ref.abs().max().item()
            err = diff.max().item()
            if what == "grad":
                require(err <= VAE_GRAD_REL_TOL * scale, (name, what, err, scale))
            elif what == "optimizer":
                bound = VAE_OPT_STEP_REL * step[keep] + VAE_OPT_REL_TOL * scale
                used = torch.where(diff == 0, 0.0, diff / bound).max().item()
                require(used <= 1.0, (name, what, err, scale, used))
                if used > worst["optimizer_bound"][0]:
                    worst["optimizer_bound"] = (used, name)
                # the tensor's shared step scale, card over CPU
                moved = (step > 0) & keep
                if moved.any():
                    ratio = ((got - start[name].cpu())[moved]
                             / (want - start[name].cpu())[moved]).median().item()
                    if abs(ratio - 1) > abs(worst["step_scale"][0] - 1):
                        worst["step_scale"] = (ratio, name)
            else:
                over = int((diff > VAE_PARAM_REPORT_TOL * scale).sum())
                if over:
                    beyond[name] = over
            if scale and err / scale > worst[what][0]:
                worst[what] = (err / scale, name)
    fmt = lambda k: f"{worst[k][0]:.3e} of max abs ({worst[k][1]})"
    top = sorted(beyond.items(), key=lambda kv: -kv[1])[:6]
    log(f"vae card vs cpu: gradients within {fmt('grad')}; Adafactor on the "
        f"card over the CPU's gradients within {fmt('optimizer')}, at most "
        f"{worst['optimizer_bound'][0]:.3f} of its bound "
        f"({worst['optimizer_bound'][1]}), steps {worst['step_scale'][0]:.7f} "
        f"times the CPU's (median, {worst['step_scale'][1]}); parameters "
        f"after the two steps within {fmt('param')}, {sum(beyond.values())} "
        f"elements beyond {VAE_PARAM_REPORT_TOL} of max abs in {len(beyond)} "
        f"tensors, most in {top}")
    return dict(metric_rel=metric_rel, grad_rel=worst["grad"],
                optimizer_rel=worst["optimizer"],
                optimizer_bound_used=worst["optimizer_bound"],
                step_scale=worst["step_scale"], param_rel=worst["param"],
                params_beyond=beyond, codes_differ=int(differ.sum()),
                codebook_rows=rows, cpu_step_s=cpu_s)


# phase 14: the training surface at full width (the default UNet with
# phase 10's 3 classes, B=8, bf16 compute, AdamW 1e-4, EMA 0.999)
COND_DROP = 0.1
# launches of one remat train step at B=8: each stack's forward runs again
# in the backward
REMAT_LAUNCHES = {k: v + step_launches(TRAIN_BATCH)[k] for k, v in TRAIN_LAUNCHES.items()}
REMAT_STEPS = 3
# the batch at which remat's peak of forward and backward is compared. At
# B=8 a plain forward keeps 0.88 GiB for the backward (0.72 of it the bf16
# casts of the weights), below the 1.44 GiB of fp32 gradients, which set
# that peak with or without remat (~1.52-1.59 GiB either way on the
# H100); at B=32 it keeps 1.74 GiB, and remat lowers the peak (1.860 ->
# 1.807 GiB)
REMAT_PEAK_BATCH = 32
# the run loop: cli/train_ldm.train_loop over in-memory seeded latents
RUN_STEPS = 12
RUN_FUSED = 2
RUN_SAVE_EVERY = 6
RUN_VAL_EVERY = 6
RUN_VAL_BATCHES = 2
VAL_NUM_T = 8
# one validation with an EMA evaluates the parameters and the EMA: per
# set, VAL_NUM_T grid points x RUN_VAL_BATCHES batches of one B=8 forward
VAL_CALLS = 2 * VAL_NUM_T * RUN_VAL_BATCHES
# checkpoints the run loop keeps (each ~6.2 GB at full width)
RUN_KEEP = 2
SURFACE_DIR = os.path.join("build", "chip_smoke_train_surface")


def cond_labels(dev) -> torch.Tensor:
    return torch.arange(TRAIN_BATCH, device=dev) % COND_CLASSES


def state_leaves(state) -> dict:
    """{path: tensor or number} over a train state (the checkpoint's tree)."""
    from ldm_image_generator_tpu_torch.utils.checkpoint import state_tree

    out = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{path}.{k}")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, f"{path}[{i}]")
        else:
            out[path] = tree

    walk(state_tree(state), "state")
    return out


def require_bitwise(a, b, what: str) -> None:
    la, lb = state_leaves(a), state_leaves(b)
    require(set(la) == set(lb), f"{what}: other leaves")
    for k, v in la.items():
        w = lb[k]
        same = torch.equal(v, w) if isinstance(v, torch.Tensor) else v == w
        require(same, f"{what}: {k} differs")


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def grad_rel(a: dict, b: dict) -> tuple:
    """(largest max|a - b| over max|a| of any gradient, its name)."""
    worst, name = 0.0, ""
    for n, g in a.items():
        scale = g.abs().max().item()
        diff = (b[n] - g).abs().max().item()
        rel = diff / scale if scale else diff
        if rel > worst:
            worst, name = rel, n
    return worst, name


def grads_of(unet) -> dict:
    return {n: p.grad.detach().clone() for n, p in unet.named_parameters()}


def phase_cond_train(dev) -> dict:
    """14.1: the conditional train step at B=8 (labels 0-2, cond-drop
    COND_DROP): launches, finiteness, a gradient on the class table,
    steps/s, peak memory and a profile."""
    from ldm_image_generator_tpu_torch.config import UNetConfig

    cfg = UNetConfig(num_classes=COND_CLASSES)
    state, step = make_trainer(dev, seed=0, dtype=torch.bfloat16, ema=True, cfg=cfg)
    unet = state.params
    gen = torch.Generator(device=dev).manual_seed(0)
    data = torch.Generator(device=dev).manual_seed(1)
    labels = cond_labels(dev)
    batch = lambda: torch.randn((TRAIN_BATCH, 32, 32, 8), generator=data, device=dev)
    state, _ = step(state, batch(), generator=gen, labels=labels)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses = []
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, m = step(state, batch(), generator=gen, labels=labels)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    log("cond train launches", json.dumps(counts), f"over {TRAIN_STEPS} steps")
    require(counts == {k: v * TRAIN_STEPS for k, v in TRAIN_LAUNCHES.items()}, counts)
    losses = [x.item() for x in losses]
    log("cond train losses", losses)
    require(all(math.isfinite(x) for x in losses), losses)
    require(all(p.grad is not None for p in unet.parameters()), "a gradient everywhere")
    require(unet.class_embed.embedding.grad.abs().max().item() > 0,
            "a gradient on class_embed")
    require(all(torch.isfinite(p).all() for p in unet.parameters()), "finite parameters")
    require(all(torch.isfinite(e).all() for e in state.ema_params.values()), "finite EMA")
    out = dict(launches=counts, losses=losses, train_s=dt,
               steps_per_s=TRAIN_STEPS / dt,
               images_per_s=TRAIN_STEPS * TRAIN_BATCH / dt,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    log(f"cond train: {TRAIN_STEPS} steps in {dt:.4f} s, {out['steps_per_s']:.4f} "
        f"steps/s, peak {out['peak_gib']:.3f} GiB")
    out["profile"] = profile_fn(lambda: step(state, batch(), generator=gen, labels=labels))
    return out


def phase_resume(dev) -> dict:
    """14.4: a conditional train state of the UNet at SHALLOW_STAGES (two
    bf16 B=8 steps from seeded weights) saved with TrainCheckpointer and
    restored into fresh modules on the card, bitwise (every tensor, the
    step, the generator's state); one more step from each within the
    train tolerances. Then the default VAE + discriminator with Adafactor
    through the same round trip, bitwise."""
    import shutil

    from ldm_image_generator_tpu_torch.utils.checkpoint import TrainCheckpointer

    cfg = unet_cfg(shallow=True, num_classes=COND_CLASSES)
    state, step = make_trainer(dev, seed=0, dtype=torch.bfloat16, ema=True, cfg=cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    data = torch.Generator(device=dev).manual_seed(1)
    for _ in range(2):
        state, _ = step(state, torch.randn((TRAIN_BATCH, 32, 32, 8), generator=data,
                                           device=dev), generator=gen, labels=cond_labels(dev))
    root = os.path.join(SURFACE_DIR, "resume")
    shutil.rmtree(root, ignore_errors=True)
    ck = TrainCheckpointer(root, max_to_keep=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = ck.save(state.step, state, [gen])
    write_s = time.perf_counter() - t0
    nbytes = dir_bytes(path)
    fresh, fresh_step = make_trainer(dev, seed=7, dtype=torch.bfloat16, ema=True, cfg=cfg)
    fresh_gen = torch.Generator(device=dev).manual_seed(99)
    t0 = time.perf_counter()
    fresh = ck.restore(fresh, [fresh_gen])
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    require(fresh.step == state.step, (fresh.step, state.step))
    require_bitwise(state, fresh, "LDM resume")
    require(torch.equal(gen.get_state(), fresh_gen.get_state()), "generator state")
    log(f"resume (stages {tuple(cfg.stages)}): {nbytes} bytes at step {state.step}, write "
        f"{write_s:.3f} s, "
        f"read {read_s:.3f} s; every tensor, the step and the generator bitwise")
    x = torch.randn((TRAIN_BATCH, 32, 32, 8), generator=torch.Generator(device=dev)
                    .manual_seed(5), device=dev)
    labels = cond_labels(dev)
    state, m_a = step(state, x, generator=gen, labels=labels)
    grads_a = grads_of(state.params)
    fresh, m_b = fresh_step(fresh, x, generator=fresh_gen, labels=labels)
    grads_b = grads_of(fresh.params)
    la, lb = m_a["loss"].item(), m_b["loss"].item()
    loss_rel = abs(la - lb) / abs(la)
    worst, name = grad_rel(grads_a, grads_b)
    log(f"resume: next step loss {la:.8f} vs {lb:.8f} (rel {loss_rel:.3e}), "
        f"largest gradient difference {worst:.3e} of max abs ({name})")
    require(loss_rel <= TRAIN_LOSS_REL_TOL, ("resume loss", la, lb))
    require(worst <= TRAIN_GRAD_REL_TOL, ("resume grads", worst, name))
    del fresh, grads_a, grads_b
    shutil.rmtree(root)

    vstate, vstep = make_vae_trainer(dev, seed=0, dtype=torch.bfloat16)
    vgen = torch.Generator(device=dev).manual_seed(0)
    images = torch.rand((VAE_BATCH, VAE_IMAGE, VAE_IMAGE, 3), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1)) * 2 - 1
    vstate, _, _ = vstep(vstate, images, generator=vgen)
    vck = TrainCheckpointer(os.path.join(SURFACE_DIR, "vae"), max_to_keep=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vpath = vck.save(vstate.step, vstate, [vgen])
    vwrite_s = time.perf_counter() - t0
    vbytes = dir_bytes(vpath)
    vfresh, _ = make_vae_trainer(dev, seed=3, dtype=torch.bfloat16)
    vfresh_gen = torch.Generator(device=dev).manual_seed(9)
    t0 = time.perf_counter()
    vfresh = vck.restore(vfresh, [vfresh_gen])
    torch.cuda.synchronize()
    vread_s = time.perf_counter() - t0
    require(vfresh.step == vstate.step == 1, vfresh.step)
    require_bitwise(vstate, vfresh, "VAE resume")
    require(torch.equal(vgen.get_state(), vfresh_gen.get_state()), "VAE generator state")
    factored = sum(r is not None for r in vstate.opt_state_vae.v_row)
    log(f"vae resume: {vbytes} bytes, write {vwrite_s:.3f} s, read {vread_s:.3f} s, "
        f"{factored} factored Adafactor tensors; bitwise")
    shutil.rmtree(os.path.join(SURFACE_DIR, "vae"))
    return dict(ckpt_bytes=nbytes, write_s=write_s, read_s=read_s,
                next_loss_rel=loss_rel, next_grad_rel=worst, next_grad_rel_name=name,
                vae_ckpt_bytes=vbytes, vae_write_s=vwrite_s, vae_read_s=vread_s,
                vae_factored=factored)


def memory_marks(unet, marks: dict) -> list:
    """Hooks that record, for a train step of `unet`, the memory its
    forward leaves allocated for the backward ("saved", bytes) and the
    peak of forward and backward above the forward's start ("fwd_bwd_peak",
    read when AdamW.apply begins). Returns the undo callables."""
    from ldm_image_generator_tpu_torch.train import steps as tsteps

    def pre(mod, args):
        marks["start"] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()

    def post(mod, args, out):
        marks["saved"] = torch.cuda.memory_allocated() - marks["start"]

    apply = tsteps.AdamW.apply

    def measured_apply(self, *a, **k):
        marks["fwd_bwd_peak"] = torch.cuda.max_memory_allocated() - marks["start"]
        return apply(self, *a, **k)

    tsteps.AdamW.apply = measured_apply
    hooks = [unet.register_forward_pre_hook(pre), unet.register_forward_hook(post)]
    return [h.remove for h in hooks] + [lambda: setattr(tsteps.AdamW, "apply", apply)]


def phase_remat(dev) -> dict:
    """14.3: one bf16 B=8 conditional step with remat=True against the
    same step without it, from the same weights and draws: launches, the
    loss equal, gradients within TRAIN_GRAD_REL_TOL (largest reported),
    and the memory the forward keeps for the backward lower with remat;
    REMAT_STEPS timed steps of each with their peak above the memory
    they started with; then one step at REMAT_PEAK_BATCH, whose peak of
    forward and backward must be lower with remat (see memory_marks)."""
    from ldm_image_generator_tpu_torch.config import UNetConfig

    cfg = UNetConfig(num_classes=COND_CLASSES)
    x = torch.randn((TRAIN_BATCH, 32, 32, 8), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(2))
    labels = cond_labels(dev)
    out = {}
    for name, remat in (("plain", False), ("remat", True)):
        state, step = make_trainer(dev, seed=0, dtype=torch.bfloat16, ema=False,
                                   cfg=dataclasses.replace(cfg, remat=remat))
        gen = torch.Generator(device=dev).manual_seed(3)
        torch.cuda.synchronize()
        reset_launch_counts()
        marks = {}
        undo = memory_marks(state.params, marks)
        try:
            state, m = step(state, x, generator=gen, labels=labels)
        finally:
            for u in undo:
                u()
        torch.cuda.synchronize()
        counts = launch_counts()
        grads = grads_of(state.params)
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(REMAT_STEPS):
            state, _ = step(state, x, generator=gen, labels=labels)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        out[name] = dict(loss=m["loss"].item(), launches=counts, grads=grads,
                         saved_gib=marks["saved"] / 2 ** 30,
                         fwd_bwd_peak_gib=marks["fwd_bwd_peak"] / 2 ** 30,
                         step_s=dt / REMAT_STEPS, peak_gib=peak / 2 ** 30,
                         step_peak_gib=(peak - start) / 2 ** 30)
        prof = profile_fn(lambda: step(state, x, generator=gen, labels=labels))
        out[name]["device_busy_ms"] = prof["device_busy_ms"]
        big = torch.randn((REMAT_PEAK_BATCH, 32, 32, 8), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(4))
        big_marks = {}
        undo = memory_marks(state.params, big_marks)
        try:
            step(state, big, generator=gen,
                 labels=torch.arange(REMAT_PEAK_BATCH, device=dev) % COND_CLASSES)
        finally:
            for u in undo:
                u()
        out[name]["big_saved_gib"] = big_marks["saved"] / 2 ** 30
        out[name]["big_fwd_bwd_peak_gib"] = big_marks["fwd_bwd_peak"] / 2 ** 30
        del state, step, big
        torch.cuda.empty_cache()
    plain, remat = out["plain"], out["remat"]
    log("remat launches", json.dumps(remat["launches"]))
    require(plain["launches"] == TRAIN_LAUNCHES, plain["launches"])
    require(remat["launches"] == REMAT_LAUNCHES, remat["launches"])
    require(remat["loss"] == plain["loss"], (remat["loss"], plain["loss"]))
    worst, name = grad_rel(plain.pop("grads"), remat.pop("grads"))
    log(f"remat: loss {remat['loss']:.8f} (equal), largest gradient difference "
        f"{worst:.3e} of max abs ({name}); step {plain['step_s']:.4f} -> "
        f"{remat['step_s']:.4f} s, kept for the backward "
        f"{plain['saved_gib']:.3f} -> {remat['saved_gib']:.3f} GiB, forward and "
        f"backward peak {plain['fwd_bwd_peak_gib']:.3f} -> "
        f"{remat['fwd_bwd_peak_gib']:.3f} GiB above the forward's start (at "
        f"B={REMAT_PEAK_BATCH}: kept {plain['big_saved_gib']:.3f} -> "
        f"{remat['big_saved_gib']:.3f}, peak {plain['big_fwd_bwd_peak_gib']:.3f} -> "
        f"{remat['big_fwd_bwd_peak_gib']:.3f} GiB), step "
        f"peak {plain['step_peak_gib']:.3f} -> {remat['step_peak_gib']:.3f} GiB "
        f"above the step's start (peak {plain['peak_gib']:.3f} -> "
        f"{remat['peak_gib']:.3f} GiB), device busy {plain['device_busy_ms']:.3f} "
        f"-> {remat['device_busy_ms']:.3f} ms")
    require(worst <= TRAIN_GRAD_REL_TOL, ("remat grads", worst, name))
    for key in ("saved_gib", "big_fwd_bwd_peak_gib"):
        require(remat[key] < plain[key], (key, remat[key], plain[key]))
    return dict(plain=plain, remat=remat, grad_rel=worst, grad_rel_name=name)


class SeededLatents:
    """n seeded 32x32x8 latents in memory (numpy, as the trainer's
    dataset serves them) with labels i % COND_CLASSES."""

    def __init__(self, n: int, seed: int):
        import numpy as np

        self.items = np.random.default_rng(seed).normal(
            size=(n, 32, 32, 8)).astype(np.float32)
        self.labels = [i % COND_CLASSES for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def phase_run_loop(dev) -> dict:
    """14.5: cli/train_ldm.train_loop on in-memory seeded latents: RUN_STEPS
    steps at --fused-steps RUN_FUSED --save-every RUN_SAVE_EVERY
    --val-every RUN_VAL_EVERY --val-batches RUN_VAL_BATCHES. The save
    cadence is the JAX trainer's, on the batch index (after the first
    group and after batch 7, and at the end: steps 2, 8 and 12; RUN_KEEP
    kept); JSON records at the logger's cadence; two validations with
    exact launches. The UNet at SHALLOW_STAGES (3 classes)."""
    import io
    import shutil

    from ldm_image_generator_tpu_torch.cli.train_ldm import train_loop
    from ldm_image_generator_tpu_torch.config import DDPMConfig
    from ldm_image_generator_tpu_torch.convert import load_flax_file, save_flax_file
    from ldm_image_generator_tpu_torch.data.loader import BatchLoader
    from ldm_image_generator_tpu_torch.diffusion.ddpm import make_schedule
    from ldm_image_generator_tpu_torch.models.unet import UNet
    from ldm_image_generator_tpu_torch.train.eval import Validator
    from ldm_image_generator_tpu_torch.utils.checkpoint import TrainCheckpointer
    from ldm_image_generator_tpu_torch.utils.metrics import MetricLogger

    cfg = unet_cfg(shallow=True, num_classes=COND_CLASSES)
    state, step_fn = make_trainer(dev, seed=0, dtype=torch.bfloat16, ema=True, cfg=cfg)
    unet = state.params
    gen = torch.Generator(device=dev).manual_seed(0)
    val_launches = step_launches(TRAIN_BATCH, cfg, calls=VAL_CALLS)

    def step(state, item):
        x, lb = item
        return step_fn(state, torch.from_numpy(x).to(dev), generator=gen,
                       labels=torch.from_numpy(lb).to(dev))

    shutil.rmtree(SURFACE_DIR, ignore_errors=True)
    ck = TrainCheckpointer(os.path.join(SURFACE_DIR, "ck"), max_to_keep=RUN_KEEP)
    mp = os.path.join(SURFACE_DIR, "ddpm.pt")
    saves = []

    def save_all(state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_flax_file(state.params, mp)
        save_flax_file(state.ema_params, mp + ".ema")
        t1 = time.perf_counter()
        ck.save(state.step, state, [gen])
        saves.append(dict(step=state.step, files_s=t1 - t0,
                          ckpt_s=time.perf_counter() - t1))

    validator = Validator(SeededLatents(RUN_VAL_BATCHES * TRAIN_BATCH, seed=2), unet,
                          make_schedule(DDPMConfig()), batch=TRAIN_BATCH,
                          max_batches=RUN_VAL_BATCHES, num_t=VAL_NUM_T,
                          dtype=torch.bfloat16)
    validations = []
    run_validator = validator.run

    def counted_run(state):
        torch.cuda.synchronize()
        before = launch_counts()
        t0 = time.perf_counter()
        res = run_validator(state)
        after = launch_counts()
        validations.append(dict(res, step=state.step, s=time.perf_counter() - t0,
                                launches={k: after[k] - before[k] for k in after}))
        return res

    validator.run = counted_run
    stream = io.StringIO()
    loader = BatchLoader(SeededLatents(RUN_STEPS * TRAIN_BATCH, seed=1), TRAIN_BATCH,
                         with_labels=True)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    state = train_loop(state, step, loader, epochs=1, batch_size=TRAIN_BATCH,
                       save_all=save_all, save_every=RUN_SAVE_EVERY,
                       fused_steps=RUN_FUSED, validator=validator,
                       val_every=RUN_VAL_EVERY,
                       logger=MetricLogger(log_every=10, stream=stream))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    records = [json.loads(line) for line in stream.getvalue().splitlines()]
    log("run loop records", json.dumps(records))
    log("run loop saves", json.dumps(saves))
    log("run loop validations", json.dumps(validations))
    require(state.step == RUN_STEPS, state.step)
    want = {k: v * RUN_STEPS + 2 * val_launches[k]
            for k, v in step_launches(TRAIN_BATCH, cfg, train=True).items()}
    require(counts == want, (counts, want))
    require([v["step"] for v in validations] == [6, 12], validations)
    for v in validations:
        require(v["launches"] == val_launches, v["launches"])
        require(math.isfinite(v["val_loss"]) and math.isfinite(v["val_loss_ema"]), v)
    train_recs = [r for r in records if "loss" in r]
    require([r["step"] for r in train_recs] == [10], records)
    require({"loss", "loss_gmax", "steps_per_s", "images_per_s"} <= set(train_recs[0]),
            train_recs)
    require([r["step"] for r in records if "val_loss" in r] == [6, 12], records)
    require([s["step"] for s in saves] == [2, 8, 12], saves)
    require(ck.steps() == [8, 12], ck.steps())
    back = UNet(cfg, device=dev)
    load_flax_file(back, mp)
    require(all(torch.equal(p, q) for p, q in zip(back.parameters(), unet.parameters())),
            "the parameter file reads back bitwise")
    ema_back = UNet(cfg, device=dev)
    load_flax_file(ema_back, mp + ".ema")
    require(all(torch.equal(p, state.ema_params[n])
                for n, p in ema_back.named_parameters()), "the EMA file reads back")
    del back, ema_back
    fresh, _ = make_trainer(dev, seed=9, dtype=torch.bfloat16, ema=True, cfg=cfg)
    fresh_gen = torch.Generator(device=dev)
    fresh = ck.restore(fresh, [fresh_gen])
    require_bitwise(state, fresh, "the step-12 checkpoint")
    require(torch.equal(fresh_gen.get_state(), gen.get_state()), "generator state")
    older = torch.load(os.path.join(ck.path(8), "train_state.pt"), map_location="cpu",
                       weights_only=True)
    require(older["step"] == 8 and older["state"]["step"] == 8, older["step"])
    del fresh, older
    shutil.rmtree(SURFACE_DIR)
    return dict(run_s=dt, steps=state.step, launches=counts, records=records,
                saves=saves, validations=validations, stages=list(cfg.stages))


# phase 15: the pixel DDPM (the default UNet with input_channels=3 at
# 32px, seeded) and the reference's torch files
DDPM_DIR = os.path.join("build", "chip_smoke_ddpm")


def ddpm_cfg(shallow: bool = False):
    return unet_cfg(shallow, input_channels=3)


def phase_ddpm_train(dev) -> tuple:
    """DDPM training at B=16 (seeded images in [-1, 1], bf16 compute, fp32
    parameters, RAdam 1e-4, EMA 0.999): a warm-up step, then TRAIN_STEPS
    timed steps, the 6th step in all RAdam's first rectified one, with
    exact launch counts, finite losses, parameters and EMA, a gradient on
    every parameter; steps/s, peak memory, a profile of one step. Then
    the trainer's save (cli/train_ldm.saver) writes the parameter and EMA
    files. Returns (results, state, path of the parameter file)."""
    from ldm_image_generator_tpu_torch.cli.train_ldm import saver

    t0 = time.perf_counter()
    state, step = make_trainer(dev, seed=0, dtype=torch.bfloat16, ema=True,
                               cfg=ddpm_cfg(), optimizer="radam")
    unet = state.params
    log(f"ddpm train: UNet(input_channels=3) "
        f"{sum(p.numel() for p in unet.parameters())} fp32 params, RAdam + EMA "
        f"state built in {time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device=dev).manual_seed(0)
    data = torch.Generator(device=dev).manual_seed(1)
    batch = lambda: torch.rand((DDPM_BATCH, DDPM_SIZE, DDPM_SIZE, 3), generator=data,
                               device=dev) * 2 - 1
    state, m = step(state, batch(), generator=gen)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses = []
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, m = step(state, batch(), generator=gen)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    log("ddpm train launches", json.dumps(counts), f"over {TRAIN_STEPS} steps")
    require(counts == {k: v * TRAIN_STEPS for k, v in TRAIN_LAUNCHES.items()}, counts)
    require(state.opt_state.count == TRAIN_STEPS + 1 and state.step == TRAIN_STEPS + 1,
            ("radam count", state.opt_state.count))
    from ldm_image_generator_tpu_torch.train.steps import RAdam

    radam = RAdam(1e-4)
    require(radam.rectifier(TRAIN_STEPS) is None
            and radam.rectifier(TRAIN_STEPS + 1) is not None,
            "the last timed step is RAdam's first rectified one")
    losses = [x.item() for x in losses]
    log("ddpm train losses", losses)
    require(all(math.isfinite(x) for x in losses), losses)
    params = list(unet.named_parameters())
    missing = [n for n, p in params if p.grad is None]
    require(not missing, f"parameters without a gradient: {missing[:5]}")
    require(all(torch.isfinite(p).all() for _, p in params), "finite parameters")
    require(all(torch.isfinite(e).all() for e in state.ema_params.values()), "finite EMA")
    out = dict(launches=counts, losses=losses, train_s=dt,
               steps_per_s=TRAIN_STEPS / dt, images_per_s=TRAIN_STEPS * DDPM_BATCH / dt,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    log(f"ddpm train: {TRAIN_STEPS} steps in {dt:.4f} s, {out['steps_per_s']:.4f} "
        f"steps/s, {out['images_per_s']:.4f} images/s at B={DDPM_BATCH}, peak "
        f"{out['peak_gib']:.3f} GiB")
    out["profile"] = profile_fn(lambda: step(state, batch(), generator=gen))
    os.makedirs(DDPM_DIR, exist_ok=True)
    path = os.path.join(DDPM_DIR, "ddpm.pt")
    t0 = time.perf_counter()
    saver(path, None, gen)(state)
    out["save_s"] = time.perf_counter() - t0
    return out, state, path


def phase_ddpm_sample(dev, unet, path: str) -> dict:
    """cli/sample_ddpm on the trainer's file (-n 2 -t 20, bf16, 32px): the
    file's weights bitwise in the CLI's UNet, exactly 720 block_core and
    160 window MHA per image, two 32px PNGs; then DDPMPipeline over the
    trained UNet: B=1 DDIM-20, B=4, DPM-Solver++ 10 steps and DeepCache
    interval 2, each with exact launch counts, images/s over 3 timed
    calls after a warm-up and device busy of one profiled call."""
    from ldm_image_generator_tpu_torch.cli import sample_ddpm
    from ldm_image_generator_tpu_torch.pipelines import DDPMPipeline

    flags = ["-dp", path, "-n", "2", "-t", "20", "-o", os.path.join(DDPM_DIR, "png")]
    cli_unet = sample_ddpm.build_pipeline(sample_ddpm.build_parser().parse_args(flags))._src[0]
    want, got = unet.state_dict(), cli_unet.state_dict()
    require(want.keys() == got.keys() and all(torch.equal(want[n], got[n]) for n in want),
            "the CLI's UNet holds the trainer's file bitwise")
    del cli_unet
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    sample_ddpm.main(flags)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    counts = launch_counts()
    log("ddpm sample_ddpm CLI launches", json.dumps(counts), f"in {cli_s:.3f} s")
    expect = dict.fromkeys(counts, 0)
    expect.update(block_core=2 * 720, window_mha=2 * 160)
    require(counts == expect, ("sample_ddpm CLI", counts))
    pngs = []
    for i in range(2):
        with open(os.path.join(DDPM_DIR, "png", f"{i}.png"), "rb") as f:
            pngs.append(png_pixels(f.read()))
    require(all(p.shape == (DDPM_SIZE, DDPM_SIZE, 3) for p in pngs), "32px PNGs")
    out = dict(cli=dict(launches=counts, seconds=cli_s))

    pipe = DDPMPipeline(unet, dtype=torch.bfloat16)

    def make(batch, **kw):
        def make_sample(seed):
            gen = torch.Generator(device=dev).manual_seed(200 + seed)
            return lambda: (pipe.sample(gen, batch=batch, image_size=DDPM_SIZE, **kw), None)
        return make_sample

    pixel = dict(image=DDPM_SIZE, latent=None)
    out["ddpm_sample_b1"] = measure_path("ddpm ddim-20 b1", make(1), 1,
                                         {"block_core": 720, "window_mha": 160}, **pixel)
    out["ddpm_sample_b4"] = measure_path("ddpm ddim-20 b4", make(4), 4,
                                         {"ffn_block": 720, "window_mha": 160}, **pixel)
    out["ddpm_dpm10"] = measure_path(
        "ddpm dpm++2m 10 steps b1", make(1, num_steps=10, sampler="dpm++2m"), 1,
        {"block_core": 10 * 36, "window_mha": 10 * 8}, **pixel)
    out["ddpm_deepcache2"] = measure_path(
        "ddpm deepcache interval 2 b1", make(1, cache_interval=2), 1,
        {"block_core": 10 * 36 + 10 * 6, "window_mha": 10 * 8 + 10 * 2}, **pixel)
    return out


def torch_file_round_trip(kind: str, module, export, read) -> dict:
    """`module` exported with torch_export (`export`: flax tree -> state
    dict) and torch.save'd under DDPM_DIR; read(path) loads it through a
    CLI's loader into a fresh module, every parameter bitwise; then
    cli/convert .pt -> msgpack -> --to-torch, every tensor bitwise. Write
    and read seconds."""
    from ldm_image_generator_tpu_torch.cli import convert as cconvert
    from ldm_image_generator_tpu_torch.convert import flax_tree
    from ldm_image_generator_tpu_torch.utils import torch_export as te

    pt = os.path.join(DDPM_DIR, f"{kind}.pt")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    te.save_state_dict(pt, export(flax_tree(module)))
    write_s = time.perf_counter() - t0
    size = os.path.getsize(pt)
    t0 = time.perf_counter()
    fresh = read(pt)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    want, got = module.state_dict(), fresh.state_dict()
    differ = [n for n in want if not torch.equal(want[n], got[n])]
    require(want.keys() == got.keys() and not differ, (kind, "parameters differ", differ[:5]))
    ckpt, back = pt[:-3] + ".ckpt", pt[:-3] + "_back.pt"
    t0 = time.perf_counter()
    cconvert.main([pt, "--kind", kind, "-o", ckpt])
    cconvert.main([ckpt, "--kind", kind, "--to-torch", "-o", back])
    convert_s = time.perf_counter() - t0
    ref, rt = torch.load(pt, weights_only=True), torch.load(back, weights_only=True)
    require(list(ref) == list(rt) and all(torch.equal(ref[k], rt[k]) for k in ref),
            (kind, "cli/convert round trip bitwise"))
    for f in (pt, ckpt, back):
        os.remove(f)
    log(f"torch file {kind}: {size} bytes, {len(want)} tensors, write {write_s:.3f} s, "
        f"read into the card {read_s:.3f} s (bitwise); cli/convert both ways "
        f"{convert_s:.3f} s (bitwise)")
    return dict(bytes=size, tensors=len(want), write_s=write_s, read_s=read_s,
                convert_s=convert_s)


def phase_torch_files(dev, unet) -> dict:
    """The reference's torch state_dict files at full width
    (torch_file_round_trip): the DDPM UNet (export_ddpm) read back
    through cli/sample_ddpm's loader, whose B=1 sample must then equal the
    in-memory weights' bitwise, and the default VAE's four models read
    back through the trainers' loader (cli/sample_ldm.maybe_load with
    their converters)."""
    from ldm_image_generator_tpu_torch.cli import sample_ddpm
    from ldm_image_generator_tpu_torch.cli.sample_ldm import maybe_load
    from ldm_image_generator_tpu_torch.config import DiscriminatorConfig, VAEConfig
    from ldm_image_generator_tpu_torch.models.vae import (
        Decoder,
        Discriminator,
        Encoder,
        VectorQuantizer,
    )
    from ldm_image_generator_tpu_torch.pipelines import DDPMPipeline
    from ldm_image_generator_tpu_torch.utils import torch_export as te
    from ldm_image_generator_tpu_torch.utils import torch_import as ti

    os.makedirs(DDPM_DIR, exist_ok=True)
    seeded = lambda s: torch.Generator(device=dev).manual_seed(s)
    pipes = []

    def read_cli(pt):
        pipes.append(sample_ddpm.build_pipeline(sample_ddpm.build_parser().parse_args(
            ["-dp", pt, "--seed", "99"])))
        return pipes[-1]._src[0]

    out = {"ddpm": torch_file_round_trip(
        "ddpm", unet, lambda t: te.export_ddpm(t, unet.cfg), read_cli)}
    samples = [p.sample(seeded(7), batch=1, image_size=DDPM_SIZE)
               for p in (DDPMPipeline(unet, dtype=torch.bfloat16), pipes.pop())]
    require(torch.equal(*samples), "the torch file's B=1 sample equals the in-memory one")
    vcfg, dcfg = VAEConfig(), DiscriminatorConfig()
    vae = {  # kind: (module of a seed, export, converter)
        "encoder": (lambda s: Encoder(vcfg, device=dev, generator=seeded(s)),
                    lambda t: te.export_encoder(t, vcfg),
                    lambda sd: ti.convert_encoder(sd, vcfg)),
        "decoder": (lambda s: Decoder(vcfg, device=dev, generator=seeded(s)),
                    lambda t: te.export_decoder(t, vcfg),
                    lambda sd: ti.convert_decoder(sd, vcfg)),
        "quantizer": (lambda s: VectorQuantizer(vcfg.num_embeddings, vcfg.embedding_dim,
                                                device=dev, generator=seeded(s)),
                      te.export_quantizer, ti.convert_quantizer),
        "discriminator": (lambda s: Discriminator(dcfg, device=dev, generator=seeded(s)),
                          lambda t: te.export_discriminator(t, dcfg),
                          lambda sd: ti.convert_discriminator(sd, dcfg))}
    for i, (kind, (make, export, converter)) in enumerate(vae.items()):
        fresh = make(20 + i)

        def read(pt, fresh=fresh, converter=converter):
            require(maybe_load(fresh, pt, converter), (pt, "loaded"))
            return fresh

        out[kind] = torch_file_round_trip(kind, make(10 + i), export, read)
    return out

# phase 16: training through int8 FFN weights (B=8, and B=2 through
# block_core): launches per step, and quantize_cols calls per step (the 6
# matrices of each of the 36 blocks, once: the optimizer changes every
# weight version)
INT8_TRAIN_LAUNCHES = step_launches(TRAIN_BATCH, train=True, int8=True)
INT8_REMAT_LAUNCHES = {k: v + step_launches(TRAIN_BATCH, int8=True)[k]
                       for k, v in INT8_TRAIN_LAUNCHES.items()}
INT8_B2_LAUNCHES = step_launches(2, train=True, int8=True)
INT8_QUANTIZATIONS = 6 * INT8_TRAIN_LAUNCHES["ffn_block_int8"]
# the int8 UNet's fp32 B=4 step at SHALLOW_STAGES, card vs CPU (phase
# 7's check), and the same step against the dequantized weights on the
# card: at most this many gradients flip-touched each. Measured on the
# H100 (these seeds, the same in every run): 0 of 312 against the CPU, 1
# straight-through (one FFN b unit); the budget is the larger count plus
# 3, as FLIP_TENSORS's (at the default depth: 2 of 792 and 1)
INT8_FLIP_TENSORS = 4
# branch ablation: one bf16 denoise step timed as the median of
# ABLATE_CHAINS chains of ABLATE_CHAIN steps (after one warm-up chain),
# its device time from a traced chain of ABLATE_TRACED steps, and the
# launches per 20-step B=1 sample of each ablated UNet
ABLATE_CHAIN = 5
ABLATE_CHAINS = 3
ABLATE_TRACED = 3
ABLATE_CONFIGS = (("full", {}), ("no_norm", dict(ablate_branches=("norm",))),
                  ("no_film", dict(ablate_branches=("film",))),
                  ("no_moe", dict(ablate_branches=("moe",))),
                  ("no_conv", dict(ablate_branches=("conv",))),
                  ("no_attn", dict(ablate_branches=("attn",))),
                  ("k3", dict(experts_per_call=3)))
# KID: two seeded sets of KID_IMAGES smooth 256px images, the second the
# first plus N(0, KID_NOISE) noise; fp32 card vs CPU within KID_REL_TOL of
# the CPU's
# the ablations whose 20-step sample may end non-finite: without the
# channel norm the random-weight activations overflow bf16 (measured on
# the H100); every other configuration's final latent must be finite
ABLATE_OVERFLOWS = ("no_norm",)
KID_IMAGES = 64
KID_NOISE = 0.2
KID_REL_TOL = 1e-3
TRACE_DIR = os.path.join("build", "chip_smoke_traces")


def ablate_launches(name: str) -> dict:
    """Launches of one 256px 20-step B=1 sample of the ablated UNet: the
    kernels take a block only with norm, film and moe on and 2 experts
    per call (block_core with conv on as well, else ffn_block); window
    MHA runs unless attn is skipped."""
    counts = dict.fromkeys(launch_counts(), 0)
    if name in ("full", "no_attn"):
        counts["block_core"] = 720
    elif name == "no_conv":
        counts["ffn_block"] = 720
    counts["window_mha"] = 0 if name == "no_attn" else 160
    return counts


def phase_int8_train(dev) -> dict:
    """16.1: the default UNet with ffn_quant='int8' trained as phase 6
    (B=8, bf16 compute, fp32 parameters, AdamW 1e-4, EMA 0.999): a warm-up
    and TRAIN_STEPS steps with exact launches and quantizations per step,
    finite losses, fp32 parameters and EMA, a gradient on every parameter;
    steps/s, peak memory, a profile of one step. Then one remat step (the
    recompute launches the forward again and quantizes nothing) and one
    step at B=2 (block_core)."""
    from ldm_image_generator_tpu_torch.config import UNetConfig
    from ldm_image_generator_tpu_torch.kernels import ffn_block as tffn

    cfg = UNetConfig(ffn_quant="int8")
    state, step = make_trainer(dev, seed=0, dtype=torch.bfloat16, ema=True, cfg=cfg)
    unet = state.params
    gen = torch.Generator(device=dev).manual_seed(0)
    data = torch.Generator(device=dev).manual_seed(1)
    batch = lambda b=TRAIN_BATCH: torch.randn((b, 32, 32, 8), generator=data, device=dev)
    state, _ = step(state, batch(), generator=gen)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    q0 = tffn.quantizations
    losses = []
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, m = step(state, batch(), generator=gen)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts, made = launch_counts(), tffn.quantizations - q0
    log("int8 train launches", json.dumps(counts), f"over {TRAIN_STEPS} steps, "
        f"{made} quantizations")
    require(counts == {k: v * TRAIN_STEPS for k, v in INT8_TRAIN_LAUNCHES.items()}, counts)
    require(made == INT8_QUANTIZATIONS * TRAIN_STEPS, made)
    losses = [x.item() for x in losses]
    require(all(math.isfinite(x) for x in losses), losses)
    params = list(unet.named_parameters())
    require(all(p.grad is not None for _, p in params), "a gradient on every parameter")
    require(all(p.dtype == torch.float32 and torch.isfinite(p).all() for _, p in params),
            "finite fp32 parameters")
    require(all(torch.isfinite(e).all() for e in state.ema_params.values()), "finite EMA")
    out = dict(launches=counts, quantizations=made, losses=losses, train_s=dt,
               steps_per_s=TRAIN_STEPS / dt,
               images_per_s=TRAIN_STEPS * TRAIN_BATCH / dt,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    log(f"int8 train: {TRAIN_STEPS} steps in {dt:.4f} s, {out['steps_per_s']:.4f} "
        f"steps/s at B={TRAIN_BATCH}, peak {out['peak_gib']:.3f} GiB, losses {losses}")
    out["profile"] = profile_fn(lambda: step(state, batch(), generator=gen))
    for name, b, want, remat in (("remat", TRAIN_BATCH, INT8_REMAT_LAUNCHES, True),
                                 ("b2", 2, INT8_B2_LAUNCHES, False)):
        unet.cfg = dataclasses.replace(cfg, remat=remat)
        torch.cuda.synchronize()
        reset_launch_counts()
        q0 = tffn.quantizations
        state, m = step(state, batch(b), generator=gen)
        torch.cuda.synchronize()
        counts, made = launch_counts(), tffn.quantizations - q0
        log(f"int8 train {name} step at B={b}: launches {json.dumps(counts)}, "
            f"{made} quantizations, loss {m['loss'].item():.6f}")
        require(counts == want, (name, counts))
        require(made == INT8_QUANTIZATIONS, (name, made))
        require(math.isfinite(m["loss"].item()), (name, m["loss"]))
        out[f"{name}_launches"] = counts
    unet.cfg = cfg
    return out


def ffn_modules(unet) -> list:
    from ldm_image_generator_tpu_torch.models.layers import RandomMoE

    return [(n, m) for n, m in unet.named_modules() if isinstance(m, RandomMoE)]


def rec_to_cpu(rec: dict) -> dict:
    """A record_preactivations record with its tensors on the CPU."""
    return {k: v.cpu() if isinstance(v, torch.Tensor) else (v[0].cpu(), v[1].cpu(), v[2])
            for k, v in rec.items()}


def check_int8_card_vs_cpu(dev, run: dict) -> dict:
    """The int8 extras of phase 7's step on an int8 UNet (`run`, from
    phase_train_card_vs_cpu): the int8 weights and scale-bias rows each
    side made are equal, and the straight-through identity: the card's
    gradients are those of the same step (same draws) of a
    full-precision UNet holding the step's starting weights with the
    card's dequantized FFN weights, within phase 7's gradient gate."""
    start, cpu_state, card_state = run["start"], run["cpu_state"], run["card_state"]
    # the step's int8 weights, made again on each side from its start
    made = []
    for state in (cpu_state, card_state):
        with torch.no_grad():
            for n, p in state.params.named_parameters():
                p.copy_(start[n])
        made.append([(n, m.ffn_weights(torch.float32, dequantized=True)[1])
                     for n, m in ffn_modules(state.params)])
    cpu_ffn, card_ffn = made
    for (name, a), (_, b) in zip(cpu_ffn, card_ffn):
        for u, v in zip(a[0], b[0]):
            require(torch.equal(u, v.cpu()), f"{name}: int8 weights differ")
    log(f"int8 train card vs cpu: the int8 weights and scale-bias rows of "
        f"{len(cpu_ffn)} blocks equal on both sides")
    cfg = dataclasses.replace(card_state.params.cfg, ffn_quant="none")
    twin_state, twin_step = make_trainer(dev, seed=3, dtype=torch.float32,
                                         ema=False, cfg=cfg)
    twin = twin_state.params
    names = ("gwa", "gba", "gwb", "gbb", "gwc", "gbc", "wa", "ba", "wb", "bb",
             "wc", "bc")
    with torch.no_grad():
        for n, p in twin.named_parameters():
            p.copy_(start[n])
        for (_, a), (_, b) in zip(card_ffn, ffn_modules(twin)):
            for name, v in zip(names, a[1]):
                getattr(b, name).copy_(v)
    rec, hooks = record_preactivations(twin)
    _, m_twin = twin_step(twin_state, run["x"].to(dev),
                          **{k: v.to(dev) for k, v in run["inject"].items()})
    for handle in hooks:
        handle.remove()
    rec = rec_to_cpu(rec)
    l_card, lt = run["l_card"], m_twin["loss"].item()
    loss_rel = abs(l_card - lt) / abs(lt)
    log(f"int8 straight-through on the card: loss {l_card:.8f} vs {lt:.8f} on "
        f"the dequantized weights (rel {loss_rel:.3e})")
    require(loss_rel <= TRAIN_LOSS_REL_TOL, ("straight-through loss", l_card, lt))
    worst, worst_name, flipped = compare_train_grads(
        dict(twin.named_parameters()), dict(card_state.params.named_parameters()),
        flip_units(rec, run["card_rec"]), rec, INT8_FLIP_TENSORS,
        "int8 straight-through on the card")
    return dict(straight_through=dict(loss_rel=loss_rel, grad_rel=worst,
                                      grad_rel_name=worst_name,
                                      flip_touched=flipped))


def busy_ms(prof, scope: str) -> float:
    """Device-busy ms of a torch.profiler run: the CUDA kernels' self
    time, without the span of the named scope `scope` (a record_function
    range, which the profiler also lists as a device event)."""
    return sum((getattr(ev, "self_device_time_total", 0.0) or 0.0) / 1e3
               for ev in prof.key_averages()
               if "CUDA" in str(getattr(ev, "device_type", "")) and ev.key != scope)


def phase_ablation(dev) -> dict:
    """16.3: the default UNet (seeded, bf16) with each branch skipped and
    with 3 experts per call, beside the full model: the launches of a
    20-step B=1 sample (exact; the final latent finite, but for the
    ABLATE_OVERFLOWS configurations), and one denoise
    step at B=1 and B=4, timed with profiling.chained_time (CUDA events;
    the median of ABLATE_CHAINS chains) and traced (profiling.trace:
    device-busy ms per step). A branch's cost is the full model's time
    less its ablation's."""
    from ldm_image_generator_tpu_torch.config import UNetConfig
    from ldm_image_generator_tpu_torch.pipelines import LDMPipeline
    from ldm_image_generator_tpu_torch.utils import profiling

    out = {}
    for name, over in ABLATE_CONFIGS:
        pipe = LDMPipeline.random(UNetConfig(**over), dtype=torch.bfloat16, device=dev,
                                  seed=0)
        gen = torch.Generator(device=dev).manual_seed(0)
        counts, z = run_path(pipe, 1, gen, finite=name not in ABLATE_OVERFLOWS)
        require(counts == ablate_launches(name), (name, counts))
        index, _ = pipe.film_schedule(32, 20)
        t = next(iter(index))
        row = dict(launches=counts, finite=bool(torch.isfinite(z).all()))
        for b in (1, 4):
            denoise = pipe.denoise_fn(32, 20, generator=gen)
            x0 = torch.randn((b, 32, 32, 8), device=dev, generator=gen)
            step_fn = lambda x: denoise(x, t)
            runs = [profiling.chained_time(step_fn, x0, chain_len=ABLATE_CHAIN, iters=1,
                                           warmup=int(i == 0))
                    for i in range(ABLATE_CHAINS)]
            row[f"b{b}_step_ms"] = 1e3 * sorted(runs)[len(runs) // 2]
            scope = f"{name}_b{b}"
            with profiling.trace(os.path.join(TRACE_DIR, scope)) as prof:
                with profiling.named_scope(scope):
                    profiling.chained_time(step_fn, x0, chain_len=ABLATE_TRACED,
                                           iters=1, warmup=0)
            row[f"b{b}_busy_ms"] = busy_ms(prof, scope) / ABLATE_TRACED
        log(f"ablation {name}: B=1 {row['b1_step_ms']:.3f} ms per step "
            f"(device busy {row['b1_busy_ms']:.3f}), B=4 {row['b4_step_ms']:.3f} ms "
            f"(busy {row['b4_busy_ms']:.3f}); launches {json.dumps(counts)}; "
            f"final latent finite: {row['finite']}")
        out[name] = row
        del pipe
        torch.cuda.empty_cache()
    full = out["full"]
    for name, row in out.items():
        if name != "full":
            row["cost"] = {k: full[k] - row[k] for k in
                           ("b1_step_ms", "b1_busy_ms", "b4_step_ms", "b4_busy_ms")}
            log(f"branch cost {name} (full less ablated, ms per step): " + ", ".join(
                f"{k} {v:.3f}" for k, v in row["cost"].items()))
    return out


def phase_kid(dev) -> dict:
    """16.4: patched KID (utils/quality.py) of two seeded sets of
    KID_IMAGES 256px images, the second the first plus noise, through the
    default VAE Encoder (seeded) and through random_conv_features: fp32
    on the card against the CPU within KID_REL_TOL; seconds per call on
    the card in bf16 and fp32."""
    from ldm_image_generator_tpu_torch.config import VAEConfig
    from ldm_image_generator_tpu_torch.models.vae import Encoder
    from ldm_image_generator_tpu_torch.utils import profiling
    from ldm_image_generator_tpu_torch.utils import quality

    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(5)
    # smooth images (uniform noise at 16px, bilinear to 256px): the added
    # noise then moves every feature's statistics
    real = F.interpolate(torch.rand((KID_IMAGES, 3, 16, 16), generator=gen) * 2 - 1,
                         size=(256, 256), mode="bilinear").permute(0, 2, 3, 1).contiguous()
    fake = real + KID_NOISE * torch.randn(real.shape, generator=gen)
    enc = Encoder(VAEConfig(), device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    enc_cpu = copy.deepcopy(enc).to("cpu")
    conv_kid = lambda a, b: quality.kid(quality.random_conv_features(a),
                                        quality.random_conv_features(b))
    out = {}
    for name, fn, cpu_fn in (
            ("encoder", lambda a, b, dt: quality.kid_from_images(enc, a, b, dtype=dt),
             lambda a, b: quality.kid_from_images(enc_cpu, a, b, dtype=torch.float32)),
            ("random_conv", lambda a, b, dt: conv_kid(a, b), conv_kid)):
        t0 = time.perf_counter()
        want = cpu_fn(real, fake).item()
        cpu_s = time.perf_counter() - t0
        real_d, fake_d = real.to(dev), fake.to(dev)
        got = fn(real_d, fake_d, torch.float32).item()
        rel = abs(got - want) / abs(want)
        # random_conv_features computes in fp32 whatever its input
        types = (torch.bfloat16, torch.float32) if name == "encoder" else (torch.float32,)
        secs = {str(dt).split(".")[-1]: profiling.time_fn(fn, real_d, fake_d, dt,
                                                          iters=3, warmup=1)[0]
                for dt in types}
        log(f"KID {name}: card {got:.6f} vs cpu {want:.6f} (rel {rel:.3e}; cpu "
            f"{cpu_s:.1f} s), card seconds per call {json.dumps(secs)}")
        require(math.isfinite(got) and rel <= KID_REL_TOL, (name, got, want))
        require(want > 0, (name, "KID of the noised set should be above 0", want))
        out[name] = dict(card=got, cpu=want, rel=rel, cpu_s=cpu_s, seconds=secs)
    return out


# phase 17: data parallelism over a process group, ZeRO-1 and the GPipe
# pipeline at full width on the one card. One card cannot hold two NCCL
# ranks, so the two ranks share cuda:0 over gloo (the port picks gloo when
# ranks share a card), NCCL runs one step at world size 1, and the
# pipeline's three stages all live on cuda:0. The times are the card's
# own: two ranks time-slicing one card say nothing about scaling.
PAR_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke_parallel")
DP_WORLD = 2
DP_BATCH = 8        # the global batch: 4 rows per rank
DP_STEPS = 2
# the DP loss (the mean of two 4-row means) against one process's 8-row
# mean: fp32 sums in another order
DP_LOSS_REL_TOL = 1e-5
# each ZeRO-1 rank's optimizer-state bytes over plain DP's (W=2: ~0.5)
ZERO1_STATE_SHARE = 0.55
PIPE_STAGES = 3
PIPE_BATCH = 6      # 3 microbatches of 2: block_core on the pipelined blocks
PIPE_STEPS = 2
VAE_DP_STEPS = 2
# phase 2's tags for the kernel calls of the phase 17 paths, and the
# batch of each (per rank, or the pipelined step's)
PARALLEL_TAGS = {"dp2_train": DP_BATCH // DP_WORLD, "gpipe3_train": PIPE_BATCH,
                 "dp2_vae_train": VAE_BATCH // DP_WORLD, "ep2_train": 8}


def per_sample_film(calls: list) -> list:
    """A train step's forward block calls with a film per sample (t is
    per sample in training)."""
    return [dataclasses.replace(c, film_batch=c.batch)
            if c.kernel in ("block_core", "ffn_block") else c for c in calls]


def gpipe_calls(cfg) -> list:
    """Every distinct kernel call of one pipelined train step of the UNet
    of `cfg` (PIPE_STAGES stages, PIPE_BATCH in PIPE_STAGES microbatches;
    parallel/pipelined_unet.py): the pipelined blocks' block_core at the
    microbatch (a stochastic-depth gate on every block, so no residual
    fold) and its backward on ffn_block_bwd, once per microbatch; every
    other block's ffn_block and the attention blocks' window MHA at
    PIPE_BATCH, and their backward kernels (the default UNet: its encoder
    stacks, 18 blocks, pipeline; the decoder prefixes 1/1/7/1 do not
    divide into 3)."""
    from ldm_image_generator_tpu_torch.kernels.workloads import Call, path_calls
    from ldm_image_generator_tpu_torch.parallel.pipelined_unet import pipelined_blocks

    mb = PIPE_BATCH // PIPE_STAGES
    piped = [pipelined_blocks(nb, False, PIPE_STAGES) + pipelined_blocks(nb, True, PIPE_STAGES)
             for nb in cfg.stages]
    rest = {c: 2 * nb - p for c, nb, p in zip(cfg.channels, cfg.stages, piped)}
    enc = [Call("block_core", mb, 32 >> i, c, per_step=p * PIPE_STAGES, residual=False,
                film_batch=mb) for i, (c, p) in enumerate(zip(cfg.channels, piped)) if p]
    whole = [dataclasses.replace(c, per_step=rest[c.c]) if c.kernel == "ffn_block" else c
             for c in per_sample_film(path_calls(PIPE_BATCH, cfg=cfg))]
    whole = [c for c in whole if c.per_step]
    bwd = lambda c: dataclasses.replace(
        c, kernel="ffn_block_bwd" if c.kernel == "block_core" else c.kernel + "_bwd")
    return enc + whole + [bwd(c) for c in enc + whole]


def calls_launches(calls: list) -> dict:
    """Launches per step of a list of workloads.Call (each per_step times)."""
    counts = dict.fromkeys(KERNELS, 0)
    for c in calls:
        counts[c.kernel] += c.per_step
    return counts
# the trainer CLI over two processes: 4 seeded 256px images, global batch
# 2, one epoch (2 steps)
CLI_IMAGES = 4
CLI_BATCH = 2


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def param_hash(params) -> int:
    """A hash of the parameters' bits (int64 sums, wrapping), equal on two
    ranks whose parameters are bitwise equal."""
    total = None
    for i, p in enumerate(params):
        v = p.detach().reshape(-1).view(torch.int32).to(torch.int64)
        w = torch.arange(1, v.numel() + 1, device=v.device, dtype=torch.int64)
        h = (v * w).sum() * (i + 1)
        total = h if total is None else total + h
    return int(total.item())


def opt_state_bytes(opt_state) -> int:
    return sum(t.numel() * t.element_size() for t in opt_state.mu + opt_state.nu)


def dp_train(dev, dp, rank: int, steps: int, zero1: bool = False) -> tuple:
    """The UNet at SHALLOW_STAGES (bf16 compute, AdamW 1e-4, EMA 0.999) as
    rank `rank` of `dp`: a warm-up step, then `steps` timed steps on this
    rank's rows of seeded global batches of DP_BATCH, each launching
    exactly a train step's kernels at its rows (step_launches); then the
    wall of one all-reduce of the gradients and (rank 0) a profile of one
    more step. (result, state)."""
    torch.cuda.reset_peak_memory_stats()
    cfg = unet_cfg(shallow=True)
    state, step = make_trainer(dev, seed=0, dtype=torch.bfloat16, ema=True, dp=dp,
                               zero1=zero1, cfg=cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    data = torch.Generator(device=dev).manual_seed(1)
    rows = dp.rows(DP_BATCH)
    batch = lambda: torch.randn((DP_BATCH, 32, 32, 8), generator=data, device=dev)[rows]
    state, m = step(state, batch(), generator=gen)  # warm-up
    torch.cuda.synchronize()
    dp.barrier()
    reset_launch_counts()
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, batch(), generator=gen)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    want = step_launches(len(range(DP_BATCH)[rows]), cfg, train=True, calls=steps)
    require(counts == want, (counts, want))
    losses = [x.item() for x in losses]
    require(all(math.isfinite(x) for x in losses), losses)
    params = list(state.params.parameters())
    out = dict(launches=counts, losses=losses, steps_per_s=steps / dt,
               params_hash=param_hash(params),
               opt_state_bytes=opt_state_bytes(state.opt_state))
    grads = [p.grad for p in params]
    torch.cuda.synchronize()
    dp.barrier()
    t0 = time.perf_counter()
    dp(grads)  # identical on every rank already: the mean leaves them as they are
    torch.cuda.synchronize()
    out["allreduce_ms"] = (time.perf_counter() - t0) * 1e3
    fn = lambda: step(state, batch(), generator=gen)
    out["device_busy_ms"] = profile_fn(fn)["device_busy_ms"] if rank == 0 else None
    if rank != 0:
        fn()
    torch.cuda.synchronize()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out, state


def merge_records(recs: list) -> dict:
    """record_preactivations records of the ranks' rows, in rank order,
    as one record of the global batch."""
    out = {}
    for name, first in recs[0].items():
        if isinstance(first, torch.Tensor):
            out[name] = torch.cat([r[name] for r in recs])
        else:
            out[name] = (torch.cat([r[name][0] for r in recs], 1),
                         torch.cat([r[name][1] for r in recs], 1), first[2])
    return out


def fp32_inject(plan_length: int, batch: int) -> tuple:
    """(x, draws) of an fp32 check: seeded latents and t, eps, routing
    plan and stochastic-depth gates, on the CPU (phase 7's draws)."""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((batch, 32, 32, 8), generator=gen)
    return x, dict(t=torch.randint(1, 1000, (batch,), generator=gen),
                   eps=torch.randn(x.shape, generator=gen),
                   moe_plan=torch.randint(0, 6, (plan_length,), generator=gen),
                   sd_gates=torch.rand(plan_length, generator=gen) > 0.25)


def dp_fp32_check(dev, dp, rank: int) -> dict:
    """One fp32 DP step (global B=DP_BATCH, the draws of the global batch
    injected) against the 1-process step at B=DP_BATCH on the card from
    the same weights: the loss within DP_LOSS_REL_TOL, the all-reduced
    gradients by phase 7's rule (rank 1's preactivation record joins rank
    0's through a file). Checked on rank 0."""
    cfg = unet_cfg(shallow=True)
    state, step = make_trainer(dev, seed=3, dtype=torch.float32, ema=False, dp=dp, cfg=cfg)
    x, inject = fp32_inject(state.params.plan_length(), DP_BATCH)
    rec, hooks = record_preactivations(state.params)
    _, m = step(state, x[dp.rows(DP_BATCH)].to(dev),
                **{k: v.to(dev) for k, v in inject.items()})
    for h in hooks:
        h.remove()
    path = os.path.join(PAR_DIR, "rec-1.pt")
    if rank == 1:
        torch.save(rec_to_cpu(rec), path)
    dp.barrier()
    out = {}
    if rank == 0:
        one_state, one_step = make_trainer(dev, seed=3, dtype=torch.float32, ema=False,
                                           cfg=cfg)
        one_rec, hooks = record_preactivations(one_state.params)
        _, m1 = one_step(one_state, x.to(dev), **{k: v.to(dev) for k, v in inject.items()})
        for h in hooks:
            h.remove()
        want_rec = rec_to_cpu(one_rec)
        units = flip_units(want_rec, merge_records([rec_to_cpu(rec),
                                                    torch.load(path, weights_only=False)]))
        l_dp, l_one = m["loss"].item(), m1["loss"].item()
        loss_rel = abs(l_dp - l_one) / abs(l_one)
        log(f"dp fp32: loss {l_dp:.8f} vs 1 process {l_one:.8f} (rel {loss_rel:.3e})")
        require(loss_rel <= DP_LOSS_REL_TOL, ("dp loss", l_dp, l_one))
        worst, worst_name, flipped = compare_train_grads(
            dict(one_state.params.named_parameters()),
            dict(state.params.named_parameters()), units, want_rec, SHALLOW_FLIP_TENSORS,
            "dp fp32 vs 1 process")
        out = dict(loss_rel=loss_rel, grad_rel=worst, grad_rel_name=worst_name,
                   flip_touched=flipped)
        os.remove(path)
    dp.barrier()
    return out


def zero1_state_file(dev, dp, rank: int, state) -> dict:
    """The ZeRO-1 state as a file (moments gathered whole, rank 0 writes),
    restored by each rank into a 1-process state: its parameters and EMA
    bitwise the rank's, and its moments' slices bitwise the rank's."""
    import shutil

    from ldm_image_generator_tpu_torch.parallel.mesh import Zero1
    from ldm_image_generator_tpu_torch.train.steps import make_optimizer
    from ldm_image_generator_tpu_torch.utils.checkpoint import TrainCheckpointer

    params = list(state.params.parameters())
    tx = make_optimizer("adamw", 1e-4, zero1=Zero1(params, dp))
    full = dataclasses.replace(state, opt_state=tx.full_state(state.opt_state))
    ckpt_dir = os.path.join(PAR_DIR, "zero1_ckpt")
    t0 = time.perf_counter()
    if rank == 0:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        TrainCheckpointer(ckpt_dir).save(state.step, full, [torch.Generator(device=dev)])
    del full
    dp.barrier()
    save_s = time.perf_counter() - t0
    one, _ = make_trainer(dev, seed=1, dtype=torch.bfloat16, ema=True, cfg=state.params.cfg)
    one = TrainCheckpointer(ckpt_dir).restore(one, [torch.Generator(device=dev)])
    require(one.step == state.step, (one.step, state.step))
    for (n, p), q in zip(state.params.named_parameters(), one.params.parameters()):
        require(torch.equal(p, q), f"restored parameter {n}")
        require(torch.equal(state.ema_params[n], one.ema_params[n]), f"restored EMA {n}")
    z = tx.zero1
    for i in range(len(params)):
        for mine, whole in ((state.opt_state.mu[i], one.opt_state.mu[i]),
                            (state.opt_state.nu[i], one.opt_state.nu[i])):
            require(torch.equal(mine, z.local(whole, i)), f"restored moment {i}")
    dp.barrier()
    if rank == 0:
        shutil.rmtree(ckpt_dir)
    split = sum(d is not None for d in z.plan)
    return dict(save_s=save_s, split_leaves=split, leaves=len(z.plan),
                restored_bitwise=True)


def vae_dp_train(dev, dp, rank: int) -> dict:
    """The default VAE + discriminator (bf16, Adafactor) at global B=8,
    512px cropped to 192, as rank `rank`: a warm-up, then VAE_DP_STEPS
    steps of exactly one vq launch each; the all-reduce wall of the
    VAE's gradients, a profile of one step on rank 0."""
    torch.cuda.reset_peak_memory_stats()
    state, step = make_vae_trainer(dev, seed=0, dtype=torch.bfloat16, dp=dp)
    gen = torch.Generator(device=dev).manual_seed(0)
    data = torch.Generator(device=dev).manual_seed(1)
    rows = dp.rows(VAE_BATCH)
    shape = (VAE_BATCH, VAE_IMAGE, VAE_IMAGE, 3)
    batch = lambda: (torch.rand(shape, generator=data, device=dev) * 2 - 1)[rows]
    state, m, _ = step(state, batch(), generator=gen)
    torch.cuda.synchronize()
    dp.barrier()
    reset_launch_counts()
    metrics = []
    t0 = time.perf_counter()
    for _ in range(VAE_DP_STEPS):
        state, m, _ = step(state, batch(), generator=gen)
        metrics.append(m)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    require(counts == {k: v * VAE_DP_STEPS for k, v in VAE_LAUNCHES.items()}, counts)
    metrics = [{k: v.item() for k, v in mm.items()} for mm in metrics]
    require(all(math.isfinite(v) for mm in metrics for v in mm.values()), metrics)
    params = list(vae_named_parameters(state).values())
    out = dict(launches=counts, metrics=metrics, steps_per_s=VAE_DP_STEPS / dt,
               params_hash=param_hash(params))
    grads = [p.grad for p in params]
    torch.cuda.synchronize()
    dp.barrier()
    t0 = time.perf_counter()
    dp(grads)
    torch.cuda.synchronize()
    out["allreduce_ms"] = (time.perf_counter() - t0) * 1e3
    fn = lambda: step(state, batch(), generator=gen)
    out["device_busy_ms"] = profile_fn(fn)["device_busy_ms"] if rank == 0 else None
    if rank != 0:
        fn()
    torch.cuda.synchronize()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def parallel_child(rank: int, device: str, port: int, queue) -> None:
    """One rank of (a), (b) and (e) on `device` (both ranks share it): its
    results as one JSON line on `queue` (or its error, and then it exits
    non-zero)."""
    import traceback

    import torch.distributed as dist

    from ldm_image_generator_tpu_torch.parallel.mesh import DataParallel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=DP_WORLD)
    try:
        dp = DataParallel(dev)
        out = {}
        out["dp"], state = dp_train(dev, dp, rank, DP_STEPS)
        del state
        torch.cuda.empty_cache()
        out["dp_fp32"] = dp_fp32_check(dev, dp, rank)
        torch.cuda.empty_cache()
        out["zero1"], state = dp_train(dev, dp, rank, DP_STEPS, zero1=True)
        out["zero1"]["state_file"] = zero1_state_file(dev, dp, rank, state)
        del state
        torch.cuda.empty_cache()
        out["vae"] = vae_dp_train(dev, dp, rank)
        queue.put(json.dumps(dict(rank=rank, ok=True, **out)))
    except BaseException:
        queue.put(json.dumps(dict(rank=rank, ok=False, error=traceback.format_exc())))
        raise
    finally:
        dist.destroy_process_group()


def run_children(target, n: int, args: tuple, timeout_s: float) -> list:
    """Start n spawned processes target(rank, *args, queue); their JSON
    results in rank order. A child that fails or sends no result fails
    the phase; every child is ended before this returns."""
    import multiprocessing as mp
    import queue as queue_mod

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, *args, q)) for r in range(n)]
    for p in procs:
        p.start()
    results, deadline = {}, time.perf_counter() + timeout_s
    try:
        while len(results) < n and time.perf_counter() < deadline:
            try:
                res = json.loads(q.get(timeout=5))
            except queue_mod.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                continue
            if not res["ok"]:
                log(f"rank {res['rank']} failed:\n{res['error']}")
            results[res["rank"]] = res
        for p in procs:
            p.join(timeout=max(deadline - time.perf_counter(), 30))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    require(len(results) == n and all(r["ok"] for r in results.values()),
            f"children: {sorted(results)} of {n} reported, exit codes "
            f"{[p.exitcode for p in procs]}")
    require(all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs])
    return [results[r] for r in range(n)]


def phase_gpipe(dev) -> dict:
    """(d) The UNet at SHALLOW_STAGES pipelined in PIPE_STAGES stages on the card
    (bf16, AdamW, EMA) at B=PIPE_BATCH: exact launches per step, steps/s,
    a profile; then one fp32 pipelined step against the plain step on
    the card (loss within TRAIN_LOSS_REL_TOL, gradients by phase 7's rule;
    block_core at microbatch 2 against ffn_block at 6, so not bitwise)."""
    torch.cuda.reset_peak_memory_stats()
    cfg = unet_cfg(shallow=True)
    state, step = make_trainer(dev, seed=0, dtype=torch.bfloat16, ema=True,
                               stages=PIPE_STAGES, cfg=cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    data = torch.Generator(device=dev).manual_seed(1)
    batch = lambda: torch.randn((PIPE_BATCH, 32, 32, 8), generator=data, device=dev)
    state, m = step(state, batch(), generator=gen)
    torch.cuda.synchronize()
    reset_launch_counts()
    losses = []
    t0 = time.perf_counter()
    for _ in range(PIPE_STEPS):
        state, m = step(state, batch(), generator=gen)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    log("gpipe launches", json.dumps(counts), f"over {PIPE_STEPS} steps")
    want = calls_launches(gpipe_calls(cfg))
    require(counts == {k: v * PIPE_STEPS for k, v in want.items()}, (counts, want))
    losses = [x.item() for x in losses]
    require(all(math.isfinite(x) for x in losses), losses)
    out = dict(launches=counts, losses=losses, steps_per_s=PIPE_STEPS / dt,
               allreduce_ms=None)
    out["device_busy_ms"] = profile_fn(lambda: step(state, batch(), generator=gen))[
        "device_busy_ms"]
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del state, step
    torch.cuda.empty_cache()
    plain, plain_step = make_trainer(dev, seed=3, dtype=torch.float32, ema=False, cfg=cfg)
    piped, piped_step = make_trainer(dev, seed=3, dtype=torch.float32, ema=False,
                                     stages=PIPE_STAGES, cfg=cfg)
    x, inject = fp32_inject(plain.params.plan_length(), PIPE_BATCH)
    x, inject = x.to(dev), {k: v.to(dev) for k, v in inject.items()}
    want_rec, h1 = record_preactivations(plain.params)
    got_rec, h2 = record_preactivations(piped.params, append=True)
    _, m_plain = plain_step(plain, x, **inject)
    _, m_pipe = piped_step(piped, x, **inject)
    for h in h1 + h2:
        h.remove()
    want_rec = rec_to_cpu(want_rec)
    units = flip_units(want_rec, rec_to_cpu(got_rec))
    l_pipe, l_plain = m_pipe["loss"].item(), m_plain["loss"].item()
    loss_rel = abs(l_pipe - l_plain) / abs(l_plain)
    log(f"gpipe fp32: loss {l_pipe:.8f} vs plain {l_plain:.8f} (rel {loss_rel:.3e})")
    require(loss_rel <= TRAIN_LOSS_REL_TOL, ("gpipe loss", l_pipe, l_plain))
    worst, worst_name, flipped = compare_train_grads(
        dict(plain.params.named_parameters()), dict(piped.params.named_parameters()),
        units, want_rec, SHALLOW_FLIP_TENSORS, "gpipe fp32 vs plain")
    out["fp32"] = dict(loss_rel=loss_rel, grad_rel=worst, grad_rel_name=worst_name,
                       flip_touched=flipped)
    return out


def phase_nccl(dev) -> dict:
    """(c) One bf16 train step (after a warm-up) through a 1-rank NCCL
    group, so the NCCL path is formed and called on the card: exact
    launches, the all-reduce's wall."""
    import torch.distributed as dist

    from ldm_image_generator_tpu_torch.parallel.mesh import DataParallel

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            rank=0, world_size=1)
    try:
        require(dist.get_backend() == "nccl", dist.get_backend())
        out, state = dp_train(dev, DataParallel(dev), 0, 1)
        del state
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return out


def phase_cli_parallel(dev) -> dict:
    """(f) `python -m ...cli.train_ldm` in two processes of one group
    (--coordinator, --process-id, --num-processes) on CLI_IMAGES seeded
    256px images, the default config, one epoch of global batch
    CLI_BATCH: both exit 0 over gloo, and only rank 0 writes the file."""
    import numpy as np

    from ldm_image_generator_tpu_torch.cli.sample_ldm import save_png

    imgs = os.path.join(PAR_DIR, "cli_images")
    os.makedirs(imgs, exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(CLI_IMAGES):
        save_png(os.path.join(imgs, f"{i}.png"),
                 rng.integers(0, 255, (256, 256, 3), dtype=np.uint8))
    model = os.path.join(PAR_DIR, "cli_ddpm.msgpack")
    if os.path.exists(model):
        os.remove(model)
    port = free_port()
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ldm_image_generator_tpu_torch.cli.train_ldm", imgs,
         "-s", "256", "-b", str(CLI_BATCH), "-e", "1", "-fp16", "true",
         "-mp", model, "-ep", os.path.join(PAR_DIR, "no_encoder.msgpack"),
         "--coordinator", f"127.0.0.1:{port}", "--process-id", str(r),
         "--num-processes", str(DP_WORLD)],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(DP_WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, out) in enumerate(zip(procs, outs)):
        for line in out.splitlines()[-12:]:
            log(f"cli rank {r}: {line}")
        require(p.returncode == 0, f"cli rank {r} exited {p.returncode}")
        require("backend gloo" in out and "data-parallel over 2 processes" in out, r)
    # rank 0 writes after the first batch and at the end; rank 1 never
    saves = [out.count("saved ") for out in outs]
    require(saves[0] >= 1 and saves[1] == 0 and os.path.getsize(model) > 0, saves)
    os.remove(model)
    return dict(wall_s=wall, saves=saves)


def phase_parallel(dev) -> dict:
    """Phase 17, (a)-(f): see the module docstring."""
    t0 = time.perf_counter()
    os.makedirs(PAR_DIR, exist_ok=True)
    dev = torch.device(dev)
    shared = "cpu" if dev.type == "cpu" else f"cuda:{dev.index or 0}"
    ranks = run_children(parallel_child, DP_WORLD, (shared, free_port()), timeout_s=600)
    out = {}
    for what in ("dp", "zero1", "vae"):
        per = [r[what] for r in ranks]
        require(per[0]["params_hash"] == per[1]["params_hash"],
                f"{what}: the ranks' parameters differ")
        out[what] = dict(per[0], peak_gib=[p["peak_gib"] for p in per],
                         allreduce_ms=[p["allreduce_ms"] for p in per],
                         steps_per_s=[p["steps_per_s"] for p in per])
    require(out["zero1"]["params_hash"] == out["dp"]["params_hash"],
            "ZeRO-1's parameters differ from plain DP's")
    require(out["zero1"]["losses"] == out["dp"]["losses"], "ZeRO-1's losses differ")
    share = [r["zero1"]["opt_state_bytes"] / r["dp"]["opt_state_bytes"] for r in ranks]
    require(all(s <= ZERO1_STATE_SHARE for s in share), share)
    out["zero1"]["opt_state_share"] = share
    out["dp_fp32"] = ranks[0]["dp_fp32"]
    log(f"phase 17 ranks done at {time.perf_counter() - t0:.1f} s")
    out["nccl"] = phase_nccl(dev)
    out["gpipe"] = phase_gpipe(dev)
    torch.cuda.empty_cache()
    out["cli"] = phase_cli_parallel(dev)
    card = card_line()
    for what in ("dp", "zero1", "nccl", "gpipe", "vae"):
        r = out[what]
        log(f"phase 17 {what}: steps/s {r['steps_per_s']}, device busy "
            f"{r['device_busy_ms']} ms (one profiled step, rank 0), all-reduce wall "
            f"{r['allreduce_ms']} ms per step, peak {r['peak_gib']} GiB; {card}")
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 17 (parallel) took {out['seconds']:.1f} s")
    return out


# phase 18: the mesh layouts at full width on the one card. As in phase
# 17, the ranks share cuda:0 over gloo: the numbers show correctness and
# memory per rank, and say nothing about scaling.
MESH_BATCH = 8          # the timed bf16 steps' global batch
MESH_FP32_BATCH = 4     # the fp32 check's global batch
MESH_STEPS = 2
# processes of phase 18's group: tp2, ep2 and sp2 run on the first two
MESH_WORLD = 4
# the layouts (each on the UNet at SHALLOW_STAGES) and each one's batch per
# rank: (a)-(c) at B=8 per rank launch a train step's kernels on the
# ffn_block route; the multi-slice ranks at B=2 take block_core for every
# block (a stochastic-depth gate on each, so no residual fold), whose
# backward is ffn_block_bwd
MESH_RANK_BATCH = {"tp2": MESH_BATCH, "ep2": MESH_BATCH, "sp2": MESH_BATCH,
                   "multislice4": MESH_BATCH // 4}
# a TP or EP rank's parameters + optimizer state over a plain DP rank's may
# exceed the share of the UNet's parameters the rank keeps (mesh_state_share)
# by at most this (the default UNet: 0.503 and 0.501 kept, gated at 0.51)
MESH_STATE_SLACK = 0.007


def mesh_launches(layout: str) -> dict:
    """Launches of one train step of `layout` on a rank."""
    return step_launches(MESH_RANK_BATCH[layout], unet_cfg(shallow=True), train=True)


def mesh_state_share(cfg, expert_parallel: bool) -> float:
    """The share of the UNet's parameters (of `cfg`) one rank keeps on a
    model axis of 2 (parallel/mesh.py kernel_spec: each split parameter
    halved), which is also its share of the AdamW moments."""
    from ldm_image_generator_tpu_torch.models.unet import UNet
    from ldm_image_generator_tpu_torch.parallel.mesh import kernel_spec

    kept = total = 0
    for n, p in UNet(cfg, device="meta").named_parameters():
        split = kernel_spec(n.rsplit(".", 1)[-1], tuple(p.shape), 2, expert_parallel)
        kept += p.numel() if split is None else p.numel() // 2
        total += p.numel()
    return kept / total


def mesh_trainer(dev, layout: str, mesh, seed: int, dtype, ema: bool) -> tuple:
    """(state, step, shards, local): make_trainer's UNet and step as one
    rank of `layout` on `mesh` (tp2 / ep2: shard_params, sp2:
    spatial_parallel, multislice4: the hierarchical data-parallel mean);
    local(x) cuts a global batch to this rank's part."""
    from ldm_image_generator_tpu_torch.config import DDPMConfig
    from ldm_image_generator_tpu_torch.diffusion.ddpm import make_schedule
    from ldm_image_generator_tpu_torch.models.unet import UNet
    from ldm_image_generator_tpu_torch.parallel import mesh as tmesh
    from ldm_image_generator_tpu_torch.train.steps import (
        LDMTrainState,
        init_ema,
        make_ldm_train_step,
        make_optimizer,
    )

    unet = UNet(unet_cfg(shallow=True), device=dev,
                generator=torch.Generator(device=dev).manual_seed(seed))
    shards = None
    if layout in ("tp2", "ep2"):
        shards = tmesh.shard_params(unet, mesh, expert_parallel=layout == "ep2")
    dp = (tmesh.spatial_parallel(unet, mesh, dev) if layout == "sp2"
          else mesh.data_parallel(dev))
    tx = make_optimizer("adamw", 1e-4, shards=shards)
    state = LDMTrainState(params=unet, opt_state=tx.init(list(unet.parameters())),
                          ema_params=init_ema(unet) if ema else None)
    step = make_ldm_train_step(unet, make_schedule(DDPMConfig()), tx,
                               ema_decay=0.999 if ema else None, dtype=dtype,
                               reduce_grads=dp)

    def local(x):
        x = x[tmesh.batch_rows(mesh, x.shape[0])]
        return dp.spatial.own(x) if layout == "sp2" else x

    return state, step, shards, local


def whole_params(unet, shards, grads: bool = False) -> dict:
    """{name: whole parameter (or its gradient)} (shards.gathered where
    the parameters are split: every rank must call this)."""
    if shards is not None:
        return shards.gathered(grads=grads)
    return {n: (p.grad if grads else p).detach() for n, p in unet.named_parameters()}


def merge_spatial_records(recs: list, batch: int) -> dict:
    """record_preactivations records of the ranks' rows of the height, in
    rank order, as one record of the whole map."""
    out = {}
    for name, first in recs[0].items():
        if isinstance(first, torch.Tensor):  # FiLM: [B, h, w, F]
            out[name] = torch.cat([r[name] for r in recs], 1)
            continue
        parts = [[r[name][k].reshape(3, batch, -1, r[name][k].shape[-1]) for r in recs]
                 for k in (0, 1)]
        b, near = (torch.cat(p, 2).reshape(3, -1, p[0].shape[-1]) for p in parts)
        out[name] = (b, near, first[2])
    return out


def mesh_fp32_check(dev, layout: str, mesh, rank: int) -> dict:
    """One fp32 step of `layout` at global B=MESH_FP32_BATCH (phase 7's
    injected draws) against the 1-process step on the card from the same
    weights: tp2 / ep2 bitwise on every rank (the loss, and its slice of
    every gradient and updated parameter against the same slice of the
    1-process step's, which each rank runs), sp2 and multislice4 on rank
    0 by phase 17's rules (the loss within TRAIN_LOSS_REL_TOL, the
    gradients by phase 7's, the ranks' preactivation records merged
    through files)."""
    state, step, shards, local = mesh_trainer(dev, layout, mesh, seed=3,
                                              dtype=torch.float32, ema=False)
    x, inject = fp32_inject(state.params.plan_length(), MESH_FP32_BATCH)
    inject = {k: v.to(dev) for k, v in inject.items()}
    bitwise = layout in ("tp2", "ep2")
    rec, hooks = ({}, []) if bitwise else record_preactivations(state.params)
    _, m = step(state, local(x).to(dev), **inject)
    for h in hooks:
        h.remove()
    path = lambda r: os.path.join(PAR_DIR, f"mesh-rec-{r}.pt")
    if not bitwise and rank:
        torch.save(rec_to_cpu(rec), path(rank))
    mesh.barrier()
    out = {}
    if bitwise or rank == 0:
        one, one_step = make_trainer(dev, seed=3, dtype=torch.float32, ema=False,
                                     cfg=state.params.cfg)
        want_rec, hooks = ({}, []) if bitwise else record_preactivations(one.params)
        _, m1 = one_step(one, x.to(dev), **inject)
        for h in hooks:
            h.remove()
        l_got, l_one = m["loss"].item(), m1["loss"].item()
        loss_rel = abs(l_got - l_one) / abs(l_one)
        log(f"{layout} fp32 (rank {rank}): loss {l_got:.8f} vs 1 process {l_one:.8f} "
            f"(rel {loss_rel:.3e})")
    if bitwise:
        require(torch.equal(m["loss"], m1["loss"]), (layout, "loss", l_got, l_one))
        got = dict(state.params.named_parameters())
        for n, p in one.params.named_parameters():
            d, mine = shards.plan[n], got[n]
            grad, param = p.grad, p.detach()
            if d is not None:  # this rank's slice of the whole tensor
                k = mine.shape[d]
                grad, param = (t.narrow(d, shards.rank * k, k) for t in (grad, param))
            require(torch.equal(mine.grad, grad), f"{layout} gradient {n} (rank {rank})")
            require(torch.equal(mine.detach(), param), f"{layout} parameter {n} (rank {rank})")
        out = dict(bitwise=True, loss=l_got)
    elif rank == 0:
        recs = [rec_to_cpu(rec)] + [torch.load(path(r), weights_only=False)
                                    for r in range(1, mesh.size)]
        got_rec = (merge_spatial_records(recs, MESH_FP32_BATCH) if layout == "sp2"
                   else merge_records(recs))
        want_rec = rec_to_cpu(want_rec)
        units = flip_units(want_rec, got_rec)
        require(loss_rel <= TRAIN_LOSS_REL_TOL, (layout, "loss", l_got, l_one))
        worst, worst_name, flipped = compare_train_grads(
            dict(one.params.named_parameters()), dict(state.params.named_parameters()),
            units, want_rec, SHALLOW_FLIP_TENSORS, f"{layout} fp32 vs 1 process")
        out = dict(loss_rel=loss_rel, grad_rel=worst, grad_rel_name=worst_name,
                   flip_touched=flipped)
        for r in range(1, mesh.size):
            os.remove(path(r))
    mesh.barrier()
    return out


def mesh_train(dev, layout: str, mesh, rank: int) -> dict:
    """A warm-up and MESH_STEPS timed bf16 steps of `layout` (the default
    UNet, AdamW 1e-4, EMA 0.999) at global B=MESH_BATCH: exact launches
    per rank, finite losses, steps/s, the whole parameters' hash (equal
    on every rank, checked by the parent), parameter and optimizer-state
    bytes per rank, a profile of one more step on rank 0 (device busy,
    the collectives' host spans) and the peak memory."""
    torch.cuda.reset_peak_memory_stats()
    state, step, shards, local = mesh_trainer(dev, layout, mesh, seed=0,
                                              dtype=torch.bfloat16, ema=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    data = torch.Generator(device=dev).manual_seed(1)
    batch = lambda: local(torch.randn((MESH_BATCH, 32, 32, 8), generator=data, device=dev))
    state, m = step(state, batch(), generator=gen)  # warm-up
    torch.cuda.synchronize()
    mesh.barrier()
    reset_launch_counts()
    losses = []
    t0 = time.perf_counter()
    for _ in range(MESH_STEPS):
        state, m = step(state, batch(), generator=gen)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    want = {k: v * MESH_STEPS for k, v in mesh_launches(layout).items()}
    require(counts == want, (layout, counts, want))
    losses = [x.item() for x in losses]
    require(all(math.isfinite(x) for x in losses), (layout, losses))
    params = list(state.params.parameters())
    out = dict(launches=counts, losses=losses, steps_per_s=MESH_STEPS / dt,
               params_hash=param_hash(list(whole_params(state.params, shards).values())),
               state_bytes=sum(p.numel() * p.element_size() for p in params)
               + opt_state_bytes(state.opt_state))
    fn = lambda: step(state, batch(), generator=gen)
    if rank == 0:
        prof = profile_fn(fn, host_spans=True)
        out.update(device_busy_ms=prof["device_busy_ms"], collective_ms=prof["collective_ms"])
    else:
        fn()
    torch.cuda.synchronize()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def mesh_child(rank: int, device: str, port: int, queue) -> None:
    """One of phase 18's MESH_WORLD processes sharing `device`: tp2, ep2
    and sp2 on the first two (a mesh of 2, the others waiting), then
    multislice4 on all; each layout's fp32 check and timed steps. Its
    results as one JSON line on `queue` (or its error, and then it exits
    non-zero)."""
    import traceback

    import torch.distributed as dist

    from ldm_image_generator_tpu_torch.parallel import mesh as tmesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=MESH_WORLD)
    try:
        pair = tmesh.make_mesh(2, model_parallel=2)
        slices = tmesh.make_multislice_mesh(MESH_WORLD, replicas=2, model_parallel=1)
        out = {}
        for layout in MESH_RANK_BATCH:
            mesh = slices if layout == "multislice4" else pair
            if mesh.member:
                t0 = time.perf_counter()
                fp32 = mesh_fp32_check(dev, layout, mesh, rank)
                torch.cuda.empty_cache()
                out[layout] = dict(mesh_train(dev, layout, mesh, rank), fp32=fp32,
                                   mesh=mesh.shape, coords=mesh.coords,
                                   seconds=time.perf_counter() - t0)
                torch.cuda.empty_cache()
            dist.barrier()
        queue.put(json.dumps(dict(rank=rank, ok=True, **out)))
    except BaseException:
        queue.put(json.dumps(dict(rank=rank, ok=False, error=traceback.format_exc())))
        raise
    finally:
        dist.destroy_process_group()


def phase_mesh(dev) -> dict:
    """Phase 18 in one group of MESH_WORLD processes: (a) tp2, (b) ep2, (c)
    sp2 on a mesh of the first 2 (data 1 x model 2), (d) multislice4 on
    all 4 (replica 2 x data 2 x model 1); see the module docstring. A plain DP rank's parameter and
    optimizer-state bytes (phase 17 (a)'s: the fp32 parameters and AdamW's
    two moments whole) are the TP and EP ranks' yardstick."""
    from ldm_image_generator_tpu_torch.models.unet import UNet

    t0 = time.perf_counter()
    cfg = unet_cfg(shallow=True)
    dp_state_bytes = 3 * 4 * sum(p.numel() for p in UNet(cfg, device="meta").parameters())
    os.makedirs(PAR_DIR, exist_ok=True)
    shared = f"cuda:{torch.device(dev).index or 0}"
    ranks = run_children(mesh_child, MESH_WORLD, (shared, free_port()), timeout_s=600)
    out = {}
    card = card_line()
    for layout in MESH_RANK_BATCH:
        per = [r[layout] for r in ranks if layout in r]
        if layout in ("tp2", "ep2"):
            require(len(per) == 2 and all(p["fp32"].get("bitwise") for p in per),
                    (layout, "fp32 not bitwise on every rank"))
        require(len({p["params_hash"] for p in per}) == 1,
                f"{layout}: the ranks' whole parameters differ")
        r0 = per[0]
        out[layout] = dict(r0, steps_per_s=[p["steps_per_s"] for p in per],
                           peak_gib=[p["peak_gib"] for p in per],
                           state_bytes=[p["state_bytes"] for p in per])
        if layout in ("tp2", "ep2"):
            share = [b / dp_state_bytes for b in out[layout]["state_bytes"]]
            limit = mesh_state_share(cfg, layout == "ep2") + MESH_STATE_SLACK
            require(all(s <= limit for s in share), (layout, share, limit))
            out[layout]["state_share"] = share
            out[layout]["state_share_limit"] = limit
        log(f"phase 18 {layout} {r0['mesh']}: launches {json.dumps(r0['launches'])} "
            f"over {MESH_STEPS} steps, losses {r0['losses']}, steps/s per rank "
            f"{out[layout]['steps_per_s']}, device busy {r0['device_busy_ms']} ms and "
            f"collectives {r0['collective_ms']} ms (one profiled step, rank 0), peak "
            f"{out[layout]['peak_gib']} GiB, parameter + optimizer-state bytes per rank "
            f"{out[layout]['state_bytes']} (share of DP's "
            f"{out[layout].get('state_share')}), fp32 {json.dumps(r0['fp32'])}; {card}")
    out["dp_state_bytes"] = dp_state_bytes
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 18 (mesh layouts) took {out['seconds']:.1f} s")
    return out


# phase 19: the data cache on the card's machine: 64 seeded 512px images
CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "chip_smoke_cache")
CACHE_IMAGES = 64
CACHE_SIZE = 512
LATENT_SIZE = 256
# native against PIL (the JAX package's tests/test_data.py bound)
NATIVE_PIL_MEAN = 0.08


def write_seeded_images(d: str, n: int) -> None:
    """n seeded 512px-class images, JPEG and PNG in turns, of several
    aspect ratios (smooth content plus noise, as photos are)."""
    import numpy as np
    from PIL import Image

    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(0)
    shapes = [(640, 480), (480, 640), (512, 512), (300, 200), (800, 600)]
    for i in range(n):
        w, h = shapes[i % len(shapes)]
        base = rng.integers(0, 255, (h // 16 + 1, w // 16 + 1, 3)).astype(np.float32)
        img = np.kron(base, np.ones((16, 16, 1)))[:h, :w]
        img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(d, f"{i}.{'jpg' if i % 2 else 'png'}"))


def phase_data_cache(dev) -> dict:
    """Phase 19: the native decoder's build (or why it cannot be built
    here), the image cache of CACHE_IMAGES images at CACHE_SIZE through
    it and through PIL (images/s each; native within NATIVE_PIL_MEAN of
    PIL, the pad rows equal), each rebuilt from its cache with no decode
    and the same bits, the latent cache at LATENT_SIZE with the default
    encoder on the card (a second construction calls it 0 times, the same
    bits), then cli/train_vae for one epoch from the image cache (512px,
    crop 192, B=8), which must exit 0 and decode nothing."""
    import shutil

    import numpy as np

    from ldm_image_generator_tpu_torch.config import VAEConfig
    from ldm_image_generator_tpu_torch.data import dataset as tdataset
    from ldm_image_generator_tpu_torch.data import native_loader
    from ldm_image_generator_tpu_torch.models.vae import Encoder

    t_phase = time.perf_counter()
    card = card_line()
    shutil.rmtree(CACHE_DIR, ignore_errors=True)
    imgs = os.path.join(CACHE_DIR, "images")
    out = {}
    try:
        out["native_build_s"] = native_loader.build()
        out["native"] = native_loader.available()
        log(f"native decoder built in {out['native_build_s']:.2f} s; {card}")
    except RuntimeError as e:
        out.update(native=False, native_error=str(e))
        log(f"native decoder cannot be built on this machine: {e}; the cache "
            "builds through PIL")
    t0 = time.perf_counter()
    write_seeded_images(imgs, CACHE_IMAGES)
    out["write_s"] = time.perf_counter() - t0

    def build(cache: str, use_native: bool):
        # the PIL build: the native library taken out of this one build
        if not use_native:
            saved = native_loader.available
            native_loader.available = lambda: False
        try:
            t0 = time.perf_counter()
            ds = tdataset.ImageDataset([imgs], cache_dir=cache, size=CACHE_SIZE)
            return ds, time.perf_counter() - t0
        finally:
            if not use_native:
                native_loader.available = saved

    runs = [("pil", os.path.join(CACHE_DIR, "pil_cache"), False)]
    if out["native"]:
        runs.insert(0, ("native", os.path.join(CACHE_DIR, "dataset_cache"), True))
    else:
        runs[0] = ("pil", os.path.join(CACHE_DIR, "dataset_cache"), False)
    built = {}
    for name, cache, use_native in runs:
        ds, secs = build(cache, use_native)
        require(ds.built[name] == CACHE_IMAGES, (name, ds.built))
        again, again_s = build(cache, use_native)
        require(sum(again.built.values()) == 0, (name, "rebuilt", again.built))
        for i in range(len(ds)):
            require(np.array_equal(np.asarray(again.load_raw(i)), np.asarray(ds.load_raw(i))),
                    f"{name} cache item {i} served other bits")
        out[f"{name}_images_per_s"] = CACHE_IMAGES / secs
        out[f"{name}_reuse_s"] = again_s
        built[name] = ds
        log(f"image cache ({name}): {CACHE_IMAGES} images at {CACHE_SIZE}px in "
            f"{secs:.3f} s ({CACHE_IMAGES / secs:.1f} images/s); rebuilt from the "
            f"cache in {again_s:.3f} s with 0 decodes, bitwise; {card}")
    if out["native"]:
        nat, pil = built["native"], built["pil"]
        means = []
        for i in range(len(nat)):
            a, b = nat[i], pil[i]
            pad = np.all(b == -1.0, axis=(1, 2))
            require(np.array_equal(a[pad], b[pad]), f"native pad rows of item {i}")
            means.append(float(np.abs(a - b).mean()))
        require(max(means) < NATIVE_PIL_MEAN, ("native vs PIL", max(means)))
        out["native_vs_pil_mean_abs"] = max(means)
    # the latent cache with the default encoder on the card
    enc = Encoder(VAEConfig(), device=dev,
                  generator=torch.Generator(device=dev).manual_seed(0))
    calls = []

    @torch.no_grad()
    def encode(x):
        calls.append(x.shape)
        return enc(torch.from_numpy(x).to(dev), dtype=torch.bfloat16).float().cpu().numpy()

    fp = tdataset.module_fingerprint(enc)
    lat_cache = os.path.join(CACHE_DIR, "latent_cache")
    t0 = time.perf_counter()
    lat = tdataset.LatentImageDataset([imgs], cache_dir=lat_cache, size=LATENT_SIZE,
                                      encode_fn=encode, encoder_fingerprint=fp)
    lat_s = time.perf_counter() - t0
    n_calls = len(calls)
    require(lat.encoded == n_calls == -(-CACHE_IMAGES // lat.encode_batch), lat.encoded)
    again = tdataset.LatentImageDataset([imgs], cache_dir=lat_cache, size=LATENT_SIZE,
                                        encode_fn=encode, encoder_fingerprint=fp)
    require(again.encoded == 0 and len(calls) == n_calls, ("latents re-encoded",
                                                          again.encoded))
    z0 = lat[0]
    require(z0.shape == (LATENT_SIZE // 8, LATENT_SIZE // 8, 8) and np.isfinite(z0).all(),
            z0.shape)
    for i in range(len(lat)):
        require(np.array_equal(np.asarray(again.load_raw(i)), np.asarray(lat.load_raw(i))),
                f"latent item {i} served other bits")
    out.update(latent_images_per_s=CACHE_IMAGES / lat_s, encoder_calls=n_calls)
    log(f"latent cache: {CACHE_IMAGES} images at {LATENT_SIZE}px encoded in {lat_s:.3f} s "
        f"({CACHE_IMAGES / lat_s:.1f} images/s, {n_calls} encoder calls of "
        f"{lat.encode_batch}); rebuilt with 0 encoder calls, bitwise; {card}")
    del enc, lat, again
    torch.cuda.empty_cache()
    # the VAE trainer CLI from the image cache (./dataset_cache under its cwd)
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "ldm_image_generator_tpu_torch.cli.train_vae", imgs,
         "-s", str(CACHE_SIZE), "-b", "8", "-e", "1", "-fp16", "true", "-r", "results",
         "--save-every", "1000"],
        cwd=CACHE_DIR, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, timeout=300)
    cli_s = time.perf_counter() - t0
    for line in res.stdout.splitlines()[-8:]:
        log(f"train_vae: {line}")
    require(res.returncode == 0, f"train_vae exited {res.returncode}")
    require(f"dataset: {CACHE_IMAGES} images at {CACHE_SIZE}px" in res.stdout
            and f"0 of {CACHE_IMAGES} decoded" in res.stdout, "train_vae rebuilt the cache")
    out["train_vae_cli_s"] = cli_s
    shutil.rmtree(CACHE_DIR, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 19 (data cache) took {out['seconds']:.1f} s, train_vae {cli_s:.1f} s; "
        f"{card}")
    return out


# phase 20: the CLIs' default size, 512px (latent 64x64x8), at full width
CLI_SIZE = 512
LATENT64 = CLI_SIZE // 8
P512_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_512")
# (e) the training CLI's images (one epoch at its default -b 1: a step each)
P512_CLI_IMAGES = 2
# (f) timed bf16 train steps at B=8, then one step of the other objective
# (prediction, zero terminal SNR, Min-SNR gamma)
P512_TRAIN_STEPS = 3
P512_OBJECTIVE = ("v", True, 5.0)
# phase 2's tags of the 512px paths' kernel calls and the batch of each
LATENT64_TAGS = {"b1-64": 1, "b4-64": 4, "train64": TRAIN_BATCH, "train64_b1": 1}
# the benchmark's cells' ffn_block calls, {tag: (batch, latent side)}:
# cin256-cfg-b256's B=256 CFG call at 256px, ldm512-serve-poisson's bucket
# 32 at 512px
CELL_TAGS = {"cfg256": (256, 32), "serve32-64": (32, 64)}


def in_dir(path: str, fn):
    """fn() with `path` as the working directory (a CLI writes ./...)."""
    os.makedirs(path, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(path)
    try:
        return fn()
    finally:
        os.chdir(cwd)


def counted(fn) -> tuple:
    """(fn's result, the launches it made: counts set to 0 just before
    and read just after, the card synchronised)."""
    torch.cuda.synchronize()
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, launch_counts()


def sample_cli_512(dev, batch: int = 1, int8: bool = False) -> dict:
    """(a) cli/sample_ldm at its defaults (-s 512, -fp16 false: fp32) with
    -n `batch` (and --quant int8 where `int8`), run in a working directory
    under build/ (no ./ddpm.pt there: seeded weights): exactly 20 UNet
    calls' launches at latent 64 and that batch (block_core at B=1,
    ffn_block at B=4; their int8 routes), `batch` 512x512 PNGs."""
    from ldm_image_generator_tpu_torch.cli import sample_ldm

    argv = ["-n", str(batch), "-o", "out"] + (["--quant", "int8"] if int8 else [])
    what = " ".join(argv[:2] + argv[4:])
    work = os.path.join(P512_DIR, "sample_cli" + (f"_b{batch}" if batch > 1 else "")
                        + ("_int8" if int8 else ""))
    t0 = time.perf_counter()
    _, counts = counted(lambda: in_dir(work, lambda: sample_ldm.main(argv)))
    secs = time.perf_counter() - t0
    log(f"sample_ldm CLI at its defaults (512px, fp32) {what}: launches "
        f"{json.dumps(counts)} in {secs:.2f} s")
    require(counts == step_launches(batch, latent=LATENT64, int8=int8, calls=20),
            ("sample_ldm CLI", what, counts))
    for i in range(batch):
        with open(os.path.join(work, "out", f"{i}.png"), "rb") as f:
            img = png_pixels(f.read())
        require(img.shape == (CLI_SIZE, CLI_SIZE, 3), ("sample_ldm CLI image", what, img.shape))
    # one more call under the profiler: the card's busy time in it (the
    # seeded weights, 20 UNet calls, the decoder)
    prof = profile_fn(lambda: in_dir(work, lambda: sample_ldm.main(argv)))
    log(f"sample_ldm CLI at its defaults {what}: device busy {prof['device_busy_ms']:.3f} ms "
        f"(profiled wall {prof['wall_ms']:.1f} ms); {card_line()}")
    return dict(launches=counts, seconds=secs, device_busy_ms=prof["device_busy_ms"],
                profile=prof)


def train_cli_512(dev) -> dict:
    """(e) cli/train_ldm at its defaults (-s 512, -fp16 false, -b 1, -e 1)
    on P512_CLI_IMAGES seeded 512px PNGs, in a working directory under
    build/ (it writes ./dataset_cache and ./ddpm.pt): one step per image
    with exactly a B=1 train step's launches at latent 64 (block_core, its
    backward on ffn_block_bwd), each loss finite, the file written; the
    last step under the profiler (the card's busy time in one fp32 B=1
    512px train step: every kernel on the tensor cores)."""
    import shutil

    import numpy as np

    from ldm_image_generator_tpu_torch.cli import train_ldm
    from ldm_image_generator_tpu_torch.cli.sample_ldm import save_png
    from ldm_image_generator_tpu_torch.train import steps as tsteps

    work = os.path.join(P512_DIR, "train_cli")
    imgs = os.path.join(work, "images")
    os.makedirs(imgs, exist_ok=True)
    rng = np.random.default_rng(5)
    for i in range(P512_CLI_IMAGES):
        save_png(os.path.join(imgs, f"{i}.png"),
                 rng.integers(0, 255, (CLI_SIZE, CLI_SIZE, 3), dtype=np.uint8))
    losses, make, prof = [], tsteps.make_ldm_train_step, {}

    def recording(*a, **k):  # the CLI's step, its losses kept, its last step profiled
        step = make(*a, **k)

        def run(*sa, **sk):
            if len(losses) < P512_CLI_IMAGES - 1:
                state, m = step(*sa, **sk)
            else:
                out = []
                prof.update(profile_fn(lambda: out.append(step(*sa, **sk))))
                state, m = out[0]
            losses.append(m["loss"])
            return state, m
        return run

    tsteps.make_ldm_train_step = recording
    t0 = time.perf_counter()
    try:
        state, counts = counted(lambda: in_dir(work, lambda: train_ldm.main(["images"])))
    finally:
        tsteps.make_ldm_train_step = make
    secs = time.perf_counter() - t0
    losses = [x.item() for x in losses]
    log(f"train_ldm CLI at its defaults (512px, fp32, B=1) launches {json.dumps(counts)}, "
        f"losses {losses}, {secs:.2f} s")
    want = step_launches(1, latent=LATENT64, train=True, calls=P512_CLI_IMAGES)
    require(counts == want, ("train_ldm CLI", counts, want))
    require(state.step == P512_CLI_IMAGES and len(losses) == P512_CLI_IMAGES
            and all(math.isfinite(x) for x in losses), ("train_ldm CLI losses", losses))
    require(os.path.getsize(os.path.join(work, "ddpm.pt")) > 0, "train_ldm wrote ./ddpm.pt")
    log(f"train_ldm CLI at its defaults: one B=1 512px fp32 train step's device busy "
        f"{prof['device_busy_ms']:.3f} ms (profiled wall {prof['wall_ms']:.1f} ms); "
        f"{card_line()}")
    shutil.rmtree(work)
    return dict(launches=counts, losses=losses, seconds=secs,
                step_device_busy_ms=prof["device_busy_ms"], step_profile=prof)


def sample_512(dev) -> dict:
    """(b), (c): LDMPipeline.sample at 512px, bf16, DDIM-20: B=1 (block_core
    route) and B=4 (ffn_block) on the default UNet, then B=1 with int8 FFN
    weights; exact launches (workloads.path_calls at latent 64),
    images/s, one profiled call's device busy and the peak memory."""
    from ldm_image_generator_tpu_torch.config import UNetConfig
    from ldm_image_generator_tpu_torch.pipelines import LDMPipeline

    out = {}
    for name, cfg, batch in (("b1", UNetConfig(), 1), ("b4", None, 4),
                             ("int8_b1", UNetConfig(ffn_quant="int8"), 1)):
        if cfg is not None:
            pipe = None
            torch.cuda.empty_cache()
            pipe = LDMPipeline.random(cfg, dtype=torch.bfloat16, device=dev, seed=0)

        def make(seed, pipe=pipe, batch=batch):
            gen = torch.Generator(device=dev).manual_seed(500 + seed)
            return lambda: pipe.sample(gen, batch=batch, image_size=CLI_SIZE, num_steps=20,
                                       return_latent=True)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        r = measure_path(f"sample 512px {name}", make, batch,
                         step_launches(batch, latent=LATENT64, calls=20,
                                       int8=name.startswith("int8")),
                         image=CLI_SIZE, latent=(LATENT64, LATENT64, 8))
        r["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"sample 512px {name}: peak {r['peak_gib']:.3f} GiB; {card_line()}")
        out[name] = r
    return out


def train_512(dev) -> dict:
    """(f) the bf16 train step at 512px and B=8 (the default UNet, fp32
    parameters, AdamW 1e-4, EMA 0.999; the ffn_block route): a warm-up
    and P512_TRAIN_STEPS timed steps of exactly a train step's launches at
    latent 64, finite losses; steps/s, a profile of one step, the peak
    memory."""
    state, step = make_trainer(dev, seed=0, dtype=torch.bfloat16, ema=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    data = torch.Generator(device=dev).manual_seed(1)
    batch = lambda: torch.randn((TRAIN_BATCH, LATENT64, LATENT64, 8), generator=data,
                                device=dev)
    state, _ = step(state, batch(), generator=gen)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses = []
    t0 = time.perf_counter()
    for _ in range(P512_TRAIN_STEPS):
        state, m = step(state, batch(), generator=gen)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    want = step_launches(TRAIN_BATCH, latent=LATENT64, train=True, calls=P512_TRAIN_STEPS)
    require(counts == want, ("train 512px", counts, want))
    losses = [x.item() for x in losses]
    require(all(math.isfinite(x) for x in losses), losses)
    out = dict(launches=counts, losses=losses, train_s=dt, steps_per_s=P512_TRAIN_STEPS / dt,
               images_per_s=P512_TRAIN_STEPS * TRAIN_BATCH / dt)
    out["profile"] = profile_fn(lambda: step(state, batch(), generator=gen))
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"train 512px B={TRAIN_BATCH}: {P512_TRAIN_STEPS} steps in {dt:.4f} s, "
        f"{out['steps_per_s']:.4f} steps/s, device busy "
        f"{out['profile']['device_busy_ms']:.3f} ms, peak {out['peak_gib']:.3f} GiB, losses "
        f"{losses}; {card_line()}")
    # the trainers' other objective: v-prediction on the zero-terminal-SNR
    # schedule with Min-SNR weighting (gamma 5), one step from fresh state
    del state, step
    torch.cuda.empty_cache()
    state, step = make_trainer(dev, seed=0, dtype=torch.bfloat16, ema=True,
                               objective=P512_OBJECTIVE)
    (state, m), counts = counted(lambda: step(state, batch(), generator=gen))
    want = step_launches(TRAIN_BATCH, latent=LATENT64, train=True)
    log(f"train 512px B={TRAIN_BATCH} {P512_OBJECTIVE}: launches {json.dumps(counts)}, "
        f"loss {m['loss'].item():.6f}")
    require(counts == want and math.isfinite(m["loss"].item()), ("v, zero SNR, Min-SNR", counts))
    out["v_zero_snr_min_snr"] = dict(launches=counts, loss=m["loss"].item())
    return out


def serve_two_sizes(dev) -> dict:
    """(h) one SamplerServer over cli/serve.make_variants(pipe, [256, 512])
    on the conditional UNet (phase 10's, bf16, buckets SERVE_BUCKETS): 256
    and 512 requests, plain and guided, queued together before the worker
    starts. Each dispatch holds one variant, so one size (its bucket the
    smallest that takes that variant's requests), with exactly the
    launches of its batch and guidance; every 512px image bitwise the
    direct pipe.sample at 512 from draw_noise(seed) rows at that bucket."""
    import numpy as np

    from ldm_image_generator_tpu_torch.cli import serve
    from ldm_image_generator_tpu_torch.config import UNetConfig, VAEConfig
    from ldm_image_generator_tpu_torch.models.unet import UNet
    from ldm_image_generator_tpu_torch.models.vae import Decoder
    from ldm_image_generator_tpu_torch.pipelines import LDMPipeline
    from ldm_image_generator_tpu_torch.serving import SamplerServer

    gen = torch.Generator(device=dev).manual_seed(0)
    pipe = LDMPipeline(UNet(UNetConfig(num_classes=COND_CLASSES), device=dev, generator=gen),
                       Decoder(VAEConfig(), device=dev, generator=gen), dtype=torch.bfloat16)
    variants, _ = serve.make_variants(pipe, [256, CLI_SIZE], num_steps=20)
    null = COND_CLASSES
    reqs = [(256, dict(seed=10)), (CLI_SIZE, dict(seed=20)), (256, dict(seed=11)),
            (("cfg", CLI_SIZE), dict(seed=30, class_id=1, guidance=3.0)),
            (CLI_SIZE, dict(seed=21)), (("cfg", 256), dict(seed=40, class_id=0, guidance=3.0)),
            (CLI_SIZE, dict(seed=22)),
            (("cfg", CLI_SIZE), dict(seed=31, class_id=2, guidance=5.0, negative_class=0))]
    srv = SamplerServer(variants, batch_buckets=SERVE_BUCKETS, max_wait_ms=5,
                        num_classes=COND_CLASSES, device=dev)
    futs = [srv.submit(variant=v, **r) for v, r in reqs]
    dispatches, sample = [], pipe.sample

    def counting(*a, **k):
        img, counts = counted(lambda: sample(*a, **k))
        dispatches.append(dict(size=k["image_size"], batch=k["batch"],
                               guided=k.get("guidance_scales") is not None, launches=counts))
        return img

    pipe.sample = counting
    t0 = time.perf_counter()
    try:
        with srv:
            imgs = [f.result(timeout=600) for f in futs]
    finally:
        del pipe.sample
    wall = time.perf_counter() - t0
    snap = srv.stats.snapshot()
    log(f"serve 256 + 512: {json.dumps(dispatches)}; stats batches {snap['batches']} images "
        f"{snap['images']} padded {snap['padded_images']}; {wall:.3f} s")
    # one dispatch per variant, at the smallest bucket taking its requests
    want = []
    for key in dict.fromkeys(v for v, _ in reqs):
        n = sum(v == key for v, _ in reqs)
        bucket = min(b for b in SERVE_BUCKETS if b >= n)
        guided = isinstance(key, tuple)
        size = key[-1] if guided else key
        want.append(dict(size=size, batch=bucket, guided=guided,
                         launches=step_launches(bucket, calls=20 * (2 if guided else 1))))
    order = lambda ds: sorted(ds, key=lambda d: (d["size"], d["guided"]))
    require(order(dispatches) == order(want), ("serve 256 + 512 dispatches", dispatches, want))
    require((snap["batches"], snap["images"]) == (len(want), len(reqs)), snap)
    for i, ((v, _), img) in enumerate(zip(reqs, imgs)):
        size = v[-1] if isinstance(v, tuple) else v
        require(img.shape == (size, size, 3) and img.dtype == np.uint8, (i, img.shape))
    # the 512px groups against the direct calls (rows in submission order,
    # padding seeded 0)
    side = CLI_SIZE // pipe.decoder.cfg.downscale
    rows = lambda seeds: torch.stack([serve.draw_noise(s, (side, side, 8))
                                      for s in seeds]).to(dev)
    ids = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    routing = lambda: torch.Generator(device=dev).manual_seed(0)
    plain = [i for i, (v, _) in enumerate(reqs) if v == CLI_SIZE]
    guided = [i for i, (v, _) in enumerate(reqs) if v == ("cfg", CLI_SIZE)]
    bucket = min(b for b in SERVE_BUCKETS if b >= len(plain))
    seeds = [reqs[i][1]["seed"] for i in plain] + [0] * (bucket - len(plain))
    direct = {"plain": (plain, pipe.sample(routing(), batch=bucket, image_size=CLI_SIZE,
                                           num_steps=20, init_noise=rows(seeds),
                                           condition=ids([null] * bucket)))}
    g = [reqs[i][1] for i in guided]
    direct["guided"] = (guided, pipe.sample(
        routing(), batch=len(g), image_size=CLI_SIZE, num_steps=20,
        init_noise=rows([r["seed"] for r in g]), condition=ids([r["class_id"] for r in g]),
        guidance_scales=torch.tensor([r["guidance"] for r in g], device=dev),
        cfg_rescales=torch.zeros(len(g), device=dev),
        negative_condition=ids([r.get("negative_class", null) for r in g])))
    for name, (idx, ref) in direct.items():
        ref = ref.cpu().numpy()
        same = all(np.array_equal(imgs[i], ref[j]) for j, i in enumerate(idx))
        log(f"serve 512 {name}: served images bitwise the direct call's: {same}")
        require(same, ("serve 512", name, "served images equal the direct pipeline call's"))
    return dict(dispatches=dispatches, wall_s=wall, stats=snap)


def phase_512(dev) -> dict:
    """Phase 20, (a)-(h): see the module docstring."""
    import shutil

    t0 = time.perf_counter()
    shutil.rmtree(P512_DIR, ignore_errors=True)
    out = {}
    parts = (("sample_cli", lambda: sample_cli_512(dev)),
             ("sample_cli_b4", lambda: sample_cli_512(dev, batch=4)),
             ("sample_cli_int8", lambda: sample_cli_512(dev, int8=True)),
             ("sample_cli_b4_int8", lambda: sample_cli_512(dev, batch=4, int8=True)),
             ("sample", lambda: sample_512(dev)),
             ("card_vs_cpu_latent64", lambda: phase_card_vs_cpu(dev, latent=LATENT64)),
             ("train_cli", lambda: train_cli_512(dev)),
             ("train_b8", lambda: train_512(dev)),
             ("train_card_vs_cpu_b1", lambda: phase_train_card_vs_cpu(
                 dev, batch=1, latent=LATENT64)[0]),
             ("serve", lambda: serve_two_sizes(dev)))
    seconds = {}
    for name, fn in parts:
        t1 = time.perf_counter()
        out[name] = fn()
        seconds[name] = time.perf_counter() - t1
        torch.cuda.empty_cache()
        log(f"phase 20 {name} took {seconds[name]:.1f} s")
    shutil.rmtree(P512_DIR, ignore_errors=True)
    out["part_seconds"] = seconds
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 20 (512px) took {out['seconds']:.1f} s; {card_line()}")
    return out


def main(argv) -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False; nothing to check")
        return 1
    from ldm_image_generator_tpu_torch.config import UNetConfig
    from ldm_image_generator_tpu_torch.kernels import _build

    dev = torch.device("cuda")
    name = card_line()
    log(name)
    build_s = _build.build_all()
    log(f"build: {build_s:.2f} s for {len(_build.SOURCES)} sources")
    for src in _build.SOURCES:
        for line in _build.build_log(src).splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {src}: {line.strip()}")
    seconds = {"1 build": build_s}

    def run(label: str, fn, *a, **k):
        """fn(*a, **k), its seconds logged and kept under `label`."""
        t0 = time.perf_counter()
        out = fn(*a, **k)
        seconds[label] = time.perf_counter() - t0
        log(f"phase {label} took {seconds[label]:.1f} s, done at "
            f"{time.perf_counter() - t_start:.1f} s")
        torch.cuda.empty_cache()
        return out

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if argv[:1] == ["--phase"]:
        # phase 1 and the given ones alone, a quicker check of those
        # paths: each runs even where an earlier one failed, and any
        # failure exits 1. No result line: the whole check is the script
        # without arguments
        runs = {"2": lambda d: phase_kernels(d, reps=10),
                "17": phase_parallel, "18": phase_mesh, "19": phase_data_cache,
                "20": phase_512}
        failed = []
        for p in argv[1:]:
            try:
                log(json.dumps({f"phase{p}": run(p, runs[p], dev)}))
            except Exception:
                import traceback

                log(f"phase {p} failed:\n{traceback.format_exc()}")
                failed.append(p)
        log(json.dumps({"phase_seconds": seconds, "failed": failed}))
        log(name)
        return 1 if failed else 0
    kernels = run("2 kernels", phase_kernels, dev, reps=10)
    path, pipe = run("3-4 sampling", phase_path, dev)
    kernels["block_core"]["launches"] = path["launches_b1"]["block_core"]
    kernels["window_mha"]["launches"] = path["launches_b1"]["window_mha"]
    kernels["ffn_block"]["launches"] = path["launches_b4"]["ffn_block"]
    int8_path = run("4 int8 sampling", phase_int8_path, dev, pipe)
    fast = run("10 dpm++ and deepcache", phase_dpm_deepcache, dev, pipe)
    del pipe
    kernels["block_core_int8"]["launches"] = int8_path["b1"]["launches"]["block_core_int8"]
    kernels["ffn_block_int8"]["launches"] = int8_path["b4"]["launches"]["ffn_block_int8"]
    rel = run("5 card vs cpu", phase_card_vs_cpu, dev)
    rel_int8 = run("5 int8 card vs cpu", phase_card_vs_cpu, dev, UNetConfig(ffn_quant="int8"))
    # B=4: the ffn_block body, on the fp32 tensor-core routes of ffn_block
    rel_b4 = run("5 card vs cpu b4", phase_card_vs_cpu, dev, batch=4)
    rel_int8_b4 = run("5 int8 card vs cpu b4", phase_card_vs_cpu, dev,
                      UNetConfig(ffn_quant="int8"), batch=4)
    cond, cond_pipe, cond_modules = run("10 cond sampling", phase_cond, dev)
    files = run("12 param files", phase_param_files, dev, cond_pipe, *cond_modules)
    del cond_pipe, cond_modules
    rel_cond = run("11 cond card vs cpu", phase_card_vs_cpu, dev,
                   UNetConfig(num_classes=COND_CLASSES))
    serving = run("13 serving", phase_serving, dev)
    img2img_vs_cpu = run("13 img2img card vs cpu", phase_img2img_card_vs_cpu, dev)
    paths = dict(fast, **cond, **{k: v for k, v in serving.items()
                                  if isinstance(v, dict) and "launches" in v})
    for kernel in ("block_core", "window_mha", "ffn_block", "block_core_int8"):
        kernels[kernel]["launches_by_path"] = {
            path: r["launches"][kernel] for path, r in paths.items() if r["launches"][kernel]}
    train = run("6 train", phase_train, dev)
    kernels["ffn_block_bwd"]["launches"] = train["launches"]["ffn_block_bwd"]
    kernels["window_mha_bwd"]["launches"] = train["launches"]["window_mha_bwd"]
    train_vs_cpu = run("7 train card vs cpu", phase_train_card_vs_cpu, dev)[0]
    vae = run("8 vae train", phase_vae_train, dev)
    kernels["vq"]["launches"] = vae["launches"]["vq"]
    vae_vs_cpu = run("9 vae card vs cpu", phase_vae_card_vs_cpu, dev)
    cond_train = run("14.1 cond train", phase_cond_train, dev)
    resume = run("14.4 resume", phase_resume, dev)
    shallow_cond = unet_cfg(shallow=True, num_classes=COND_CLASSES)
    cond_train_vs_cpu = run("14.2 cond train card vs cpu", phase_train_card_vs_cpu, dev,
                            shallow_cond, flip_tensors=SHALLOW_FLIP_TENSORS)[0]
    remat = run("14.3 remat", phase_remat, dev)
    run_loop = run("14.5 run loop", phase_run_loop, dev)
    surface_paths = {f"cond_train_{TRAIN_STEPS}_steps": cond_train["launches"],
                     "remat_step": remat["remat"]["launches"],
                     "validation" + SHALLOW_TAG:
                         run_loop["validations"][0]["launches"]}
    add_paths(kernels, surface_paths)
    ddpm_train, ddpm_state, ddpm_path = run("15.1 ddpm train", phase_ddpm_train, dev)
    ddpm_sample = run("15.2 ddpm sample", phase_ddpm_sample, dev, ddpm_state.params,
                      ddpm_path)
    torch_files = run("15.3 torch files", phase_torch_files, dev, ddpm_state.params)
    del ddpm_state
    ddpm_vs_cpu = run("15.4 ddpm card vs cpu", phase_train_card_vs_cpu, dev,
                      ddpm_cfg(shallow=True), optimizer="radam",
                      flip_tensors=DDPM_FLIP_TENSORS)[0]
    ddpm_paths = {f"ddpm_train_{TRAIN_STEPS}_steps": ddpm_train["launches"]}
    ddpm_paths.update({k: v["launches"] for k, v in ddpm_sample.items() if k != "cli"})
    add_paths(kernels, ddpm_paths)
    int8_train = run("16.1 int8 train", phase_int8_train, dev)

    def int8_card_vs_cpu():
        out, run8 = phase_train_card_vs_cpu(dev, unet_cfg(shallow=True, ffn_quant="int8"),
                                            flip_tensors=INT8_FLIP_TENSORS)
        out.update(check_int8_card_vs_cpu(dev, run8))
        return out

    int8_vs_cpu = run("16.2 int8 card vs cpu", int8_card_vs_cpu)
    ablation = run("16.3 ablation", phase_ablation, dev)
    kid = run("16.4 kid", phase_kid, dev)
    int8_paths = {f"int8_train_{TRAIN_STEPS}_steps": int8_train["launches"],
                  "int8_remat_step": int8_train["remat_launches"],
                  "int8_train_b2_step": int8_train["b2_launches"]}
    int8_paths.update({f"ablate_{k}_b1": v["launches"] for k, v in ablation.items()
                       if k != "full"})
    add_paths(kernels, int8_paths)
    parallel = run("17 parallel", phase_parallel, dev)
    per_step = lambda counts, n: {k: v // n for k, v in counts.items()}
    add_paths(kernels, {
        "dp2_train_step" + SHALLOW_TAG: per_step(parallel["dp"]["launches"], DP_STEPS),
        "zero1_train_step" + SHALLOW_TAG: per_step(parallel["zero1"]["launches"], DP_STEPS),
        "nccl1_train_step" + SHALLOW_TAG: parallel["nccl"]["launches"],
        "gpipe3_train_step" + SHALLOW_TAG: per_step(parallel["gpipe"]["launches"], PIPE_STEPS),
        "dp2_vae_step": per_step(parallel["vae"]["launches"], VAE_DP_STEPS)})
    mesh = run("18 mesh", phase_mesh, dev)
    add_paths(kernels, {f"{k}_train_step{SHALLOW_TAG}": per_step(mesh[k]["launches"], MESH_STEPS)
                        for k in MESH_RANK_BATCH})
    data_cache = run("19 data cache", phase_data_cache, dev)
    p512 = run("20 512px", phase_512, dev)
    add_paths(kernels, {
        "sample_ldm_cli_512px_fp32": p512["sample_cli"]["launches"],
        "sample_ldm_cli_512px_fp32_n4": p512["sample_cli_b4"]["launches"],
        "sample_ldm_cli_512px_fp32_int8": p512["sample_cli_int8"]["launches"],
        "sample_ldm_cli_512px_fp32_n4_int8": p512["sample_cli_b4_int8"]["launches"],
        **{f"sample_512px_{k}": v["launches"] for k, v in p512["sample"].items()},
        f"train_ldm_cli_512px_fp32_b1_{P512_CLI_IMAGES}_steps": p512["train_cli"]["launches"],
        f"train_512px_b8_{P512_TRAIN_STEPS}_steps": p512["train_b8"]["launches"],
        "train_512px_b8_v_zero_snr_min_snr_step":
            p512["train_b8"]["v_zero_snr_min_snr"]["launches"],
        **{f"serve_{d['size']}px_{'cfg_' if d['guided'] else ''}b{d['batch']}": d["launches"]
           for d in p512["serve"]["dispatches"]}})
    elapsed = time.perf_counter() - t_start
    log(json.dumps({"phase_seconds": seconds, "elapsed_s": elapsed}))
    require(elapsed < TIME_LIMIT_S, elapsed)
    log(json.dumps({"summary": {
        "card": name, "build_s": build_s, "elapsed_s": elapsed, "phase_seconds": seconds,
        "shallow_stages": list(SHALLOW_STAGES),
        "b1_images_per_s": path["b1_images_per_s"],
        "b4_images_per_s": path["b4_images_per_s"],
        "b1_device_busy_ms": path["profile_b1"]["device_busy_ms"],
        "b4_device_busy_ms": path["profile_b4"]["device_busy_ms"],
        "card_vs_cpu_rel_err": rel,
        "int8_path": int8_path,
        "int8_card_vs_cpu_rel_err": rel_int8,
        "card_vs_cpu_rel_err_b4": rel_b4,
        "int8_card_vs_cpu_rel_err_b4": rel_int8_b4,
        "paths": paths,
        "cond_card_vs_cpu_rel_err": rel_cond,
        "param_files": files,
        "serving": serving,
        "img2img_card_vs_cpu": img2img_vs_cpu,
        "train_launches": train["launches"],
        "train_steps_per_s": train["steps_per_s"],
        "train_images_per_s": train["images_per_s"],
        "train_peak_gib": train["peak_gib"],
        "train_device_busy_ms": train["profile"]["device_busy_ms"],
        "train_profiled_wall_ms": train["profile"]["wall_ms"],
        "train_card_vs_cpu": train_vs_cpu,
        "vae_train_launches": vae["launches"],
        "vae_train_steps_per_s": vae["steps_per_s"],
        "vae_train_images_per_s": vae["images_per_s"],
        "vae_train_peak_gib": vae["peak_gib"],
        "vae_train_device_busy_ms": vae["profile"]["device_busy_ms"],
        "vae_train_profiled_wall_ms": vae["profile"]["wall_ms"],
        "vae_card_vs_cpu": vae_vs_cpu,
        "cond_train": cond_train,
        "cond_train_card_vs_cpu": cond_train_vs_cpu,
        "remat": remat,
        "resume": resume,
        "run_loop": run_loop,
        "ddpm_train": ddpm_train,
        "ddpm_sample": ddpm_sample,
        "ddpm_train_card_vs_cpu": ddpm_vs_cpu,
        "torch_files": torch_files,
        "int8_train": int8_train,
        "int8_train_card_vs_cpu": int8_vs_cpu,
        "ablation": ablation,
        "kid": kid,
        "parallel": parallel,
        "mesh": mesh,
        "data_cache": data_cache,
        "p512": p512}}))
    log(name)
    log(json.dumps({"kernels": list(kernels.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def add_paths(kernels: dict, paths: dict) -> None:
    """Each path's launch counts into the kernels line's launches_by_path
    (its nonzero ones)."""
    for kernel in kernels:
        by_path = kernels[kernel].setdefault("launches_by_path", {})
        by_path.update({p: c[kernel] for p, c in paths.items() if c[kernel]})

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
