"""Smoke run of the PyTorch port on one NVIDIA GPU (the H100 it targets).

    python3 chip_smoke.py [--seed 0]

Builds the port's CUDA kernels from `mm_unet_tpu_torch/csrc/` (one nvcc
per source, in parallel) and runs, in order (every phase prints its lines;
any failure ends the run non-zero):

1. each forward kernel against its plain PyTorch version on the card, at
   the shapes MM_Net's 512² batch-8 path gives it, in f32 and bf16, forward
   and reverse, with the tolerance stated on the line and both times; then
   each backward kernel against autograd of the plain version at the same
   shapes and kernel 2 also at the Mamba LM's (B 4, D 1536, L 2048), every
   input's gradient compared, kernel 2's lines with its plan (nb blocks of
   Dc channels a chunk) and its passes' resident blocks per SM; then the
   chunked selective scan
   (forward and backward kernels) through `selective_scan` at dkDualNet's
   three grouped scans (512², batch 8, f32 and bf16, every fused flag), the
   bare scan with its last state and a constant (D, N) B/C, its backward
   against autograd of the plain version at every shape;
2. the full-width MM_Net (f32, seeded init) at 1x3x128x128 with the kernels
   on the card against the plain versions on the CPU, same weights; then
   the gradients of every parameter of an MM_Net with full-width channels
   and depths (1,1,1,1) in train mode, card against CPU, in f32 and with
   the bf16 feature path (the tap-conv's tensor cores), in both passes with
   every tap-conv call and every fused-scan call of the card's pass also
   held to its plain version at its own inputs and output gradient
   (`TapCalls`, `FusedCalls`);
3. the serving path: full-width MM_Net in bf16 through `make_predictor`,
   512² sliding windows (overlap 0.5) over a synthetic DRIVE-like batch of 8
   and one 704² image, DiceFocal and the shared metrics through
   `val_one_epoch`; checks finite logits and that each kernel was launched
   exactly as often as the model's modules imply; then times sliding-window
   images/s for the f32 and the bf16 predictor;
4. the training path: full-width MM_Net, bf16 feature path, remat off,
   `train_step`s (DiceFocal, backward, AdamW at lr 1e-3) on a synthetic batch
   of 8 at 512²; checks a finite loss at every step, a last loss below the
   first, and each kernel's forward and backward launches per step against
   the modules' counts (and one step with remat on); times train images/s
   and reads the peak device memory; then, as part of phase 1, times the
   fused Mamba forward and backward alone at every shape one of those
   steps gave them (read by forward hooks on the Mambas), with their bounds
   and launches per step (`phase1 mamba_fused_scan_fwd_step` and
   `phase1 mamba_fused_scan_bwd_step` lines), and the tap-conv forward and
   backward likewise (hooks on the MMConvs; `phase1 tap_conv_fwd_step` and
   `phase1 tap_conv_bwd_step` lines, the backward split into its dfeat and
   dkernel kernels, the first shape's lines with every device operation
   of one call);
5. dkDualNet at full width, f32, the same weights on both of its Mambas'
   routes (a: the fused-scan megakernels; b: the grouped selective scan):
   eval logits at 8x3x512² and every parameter gradient of one train-mode
   pass, a against b; then route b on the card against the plain model on
   the CPU for full-width channels at depths (1,1,1,1), every gradient,
   each relative to its own tensor;
6. dkDualNet's path on route b: `val_one_epoch` over 512² sliding windows
   (two batches of 8), images/s for the f32 and bf16 predictor, six
   `train_step`s at 512² batch 8 (finite, falling losses, train images/s,
   peak memory), each with exact launch counts; then three-step blocks on
   routes a, a and b for the two routes' train rates on one card; after
   phase 7, as part of phase 1, the selective scan's forward and backward
   alone at every shape one route-b train step gave them (forward hooks on
   the Mambas), the backward split into its passes A, B, C and the
   wrapper's partial sums (`phase1 selective_scan_fwd_step` and
   `phase1 selective_scan_bwd_step` lines);
7. MM_Net's two Mamba routes on the card, f32, full-width channels at
   depths (1,1,1,1), 2x3x512²: the megakernels (kernels 1/2) against the
   grouped selective scan (kernels 5/6), eval logits and every parameter
   gradient of one train-mode pass, each relative to its own tensor;
8. UM_Net (f32, seeded init, full width): (a) eval logits at 1x3x128² on
   the card against the plain model on the CPU, per element, then every
   tap-conv call of one train-mode pass there against the plain version at
   its own inputs and output gradient; (b) its two
   Mamba routes against each other at 2x3x512² as phase 7 holds MM_Net's;
   (c) `val_one_epoch` over 512² sliding windows (two batches of 8, f32
   predictor) with exact launch counts, then images/s; (d) six
   `train_step`s at 512² batch 8 (finite, falling losses, exact launch
   counts per step, train images/s, peak memory); (e) kernels 1-4 alone at
   every shape one of those steps gave them (`phase8 ..._step` lines), the
   tap-conv's forward and backward there also against the plain version;
9. the config-driven entry points (`mm_unet_tpu_torch.cli`) at config.yml's
   DRIVE settings (MM_Net at full width, 512², batch 4, the synthetic set
   of 8 train and 2 val images), in a fresh working directory: (a)
   `cli.train.main` for 2 epochs (finite step losses, `best` and
   `checkpoint` with their metadata, every parameter on the card, exact
   launches of kernels 1-4 in training and of 1 and 3 in validation,
   train images/s and peak memory); (b) resume to 3 epochs (it starts at
   epoch 3 with step 4, the model's, optimizer's and dropout generator's
   state bit for bit the file's, the first step at the schedule's lr for
   step 4); (c) a real SIGTERM during the first epoch of a fresh run (exit
   code 0, a `checkpoint` of epoch 0, the signal handlers put back); (d)
   `cli.test.main` on `best` (its f1 and Dice within 1e-3 of those stored
   with it, HD95 finite or NaN); (e) `cli.verify.main` (a warm-up epoch,
   then validation with HD95); (f) three `train_one_epoch` steps and two
   `val_one_epoch` batches under `torch.cuda.set_sync_debug_mode("error")`:
   nothing waits on the whole stream but the epoch's closing synchronise;
10. the Mamba LM (`models/lm.py`) at mamba-130m's published widths (d_model
   768, 24 layers, vocabulary 50280, RMSNorm, fused add+norm; f32, seeded
   weights): (a) kernel 1 at the scoring shape (batch 4, D 1536, L 2048)
   against its plain version, with its time, bound, plan and resident
   blocks per SM, then its plan's launch (each chunk's channels in 6
   blocks behind the x_dbl pass) against the whole-chunk launch in turns,
   bits and times; (b) a depth-2 full-width model at 256 tokens, card
   against CPU; (c)
   the scoring forward at 4 x 2048 tokens, exactly 24 kernel-1 launches,
   tokens/s, device time, busy share, peak memory, then the same weights on
   route b (kernel 5) against route a; (d) `generate` and `generate_scan`
   (CUDA graph) at batch 1 and 8, prompt 100, 100 new tokens: tokens/s,
   greedy and sampled tokens equal between the two, teacher-forced step
   logits against the forward's; (e) training (forward and backward of the
   24 layers at 4 x 2048) on route a (kernels 1/2) and on route b (kernels
   5/6) with the same weights, exact launches, tokens/s, device time, busy
   share and peak memory of each, the output and every parameter gradient
   of a against b; then at mamba-370m's widths (d_model 1024, 48 layers,
   d_inner 2048, dt_rank 64), where kernel 1 splits each chunk over 8
   blocks: kernels 1 and 2 alone at the scoring shape (batch 4, D 2048, L
   2048) in f32 and bf16 against their plain versions, with times, bounds,
   plans and blocks per SM; a depth-2 model card against CPU; the 48-layer
   scoring forward (exactly 48 kernel-1 launches, tokens/s, device time,
   busy share, peak memory); the training pass on routes a and b, a
   against b, as in (e); and AdamW steps of the whole model on route a
   (next-token cross-entropy, 48 + 48 launches a step, finite and falling
   losses, tokens/s, peak memory);
11. the zoo: config.yml's other seven models (UNet, ConvUNeXt, CFPNet,
   UNETR, TransUNet, SWINUNETR, FCBFormer) through `give_model_from_config`
   at config.yml's settings and full width, f32, seeded weights: (a) each
   one's eval logits at 1x3x128² on the card against the same weights on
   the CPU, per element, then every parameter gradient of one train-mode
   pass at 2x3x128² (dropout at the identity), card against CPU, per
   tensor; (b) each one's `val_one_epoch` over sliding windows (two
   synthetic batches of 8, f32 predictor) and serving images/s, then four
   `train_step`s at batch 8 (finite, falling losses), train images/s, peak
   memory and one profiled step's device ms and busy share, at DRIVE's 512²
   (FCBFormer at the polyp sets' 352²), kernels 1-8 launched 0 times over
   (a) and (b); (c) all nine models of config.yml, read unchanged, built on
   the card, each giving (1, 1, 512, 512) logits for a 512² image; (d)
   `cli.train.main` for 2 epochs and `cli.test.main` with `model_choose:
   UNet` at config.yml's DRIVE settings, as phase 9 (a) and (d) check
   MM_Net's. It prints its own seconds and a summary line;
12. the JAX registry's last seven models (HWAUNETR; DuAT, PVT_CASCADE,
   CVC_UNETR, BMANet, CFANet and VANet), f32, at their constructors' widths,
   seeded weights: (a) as 11 (a), card against CPU at 128² in f32 and f64
   (HWAUNETR's Mambas in f32 in both); (b) as 11 (b), each
   one's validation, serving and 10 train steps at batch 8, HWAUNETR at
   DRIVE's 512² and the six polyp models at 352², with exact launches of
   kernels 1-8 on every path: 12 kernel-1 launches per HWAUNETR forward and
   12 kernel-2 launches per train step, none for the other six; (c)
   kernels 1/2 alone at every shape of HWAUNETR's train step, timed and
   held to `mamba_fused_scan_ref` (`phase12 mamba_fused_scan_*_step`),
   every fused-scan call of a 2x3x512² train-mode pass held to it
   (`FusedCalls`), and HWAUNETR's two Mamba routes against each other
   (`mamba_routes_check`); (e) all 18 names of the registry built through
   `give_model` on the card; (f) the backbone warm start: full-width
   `pvt_v2_b2`, `pvt_v2_b3` and Res2Net-50 v1b state_dicts under the
   reference's names, drawn from a numpy seed into a temporary directory;
   FCBFormer (b3, 352²) and DuAT (b2) through `give_model_from_config` with
   their sections' `model_dir` naming the file and `create_train_state`:
   every backbone tensor bit for bit the file's, the count of tensors
   loaded equal to the reference names the backbone holds, every other
   tensor that of a model built from the same generator without the file,
   then one finite `train_step`; and `warm_start` loading the Res2Net file
   into CFANet's encoder, running statistics included. A summary line
   gathers the numbers.
13. the parallel family (`mm_unet_tpu_torch/parallel/`) at world size 1
   (one card holds one NCCL rank; the CPU tests hold the multi-rank
   arithmetic) and the last tools: (a) `cli.train.main` under a one-rank
   NCCL group with torchrun's environment, phase 9's configuration for one
   epoch with ZeRO-1: its step losses against phase 9's, kernels 1-4
   launched exactly half of phase 9's two epochs, train images/s and peak
   memory beside phase 9's; then in a one-rank NCCL group (b) kernels 7/8
   at the sequence-parallel scan's shapes (B 4, Dm 1536, N 16, L 2048 and
   the 2-shard 1024) with the last state's gradient (kernel 8's `dlast`)
   against autograd of the plain scan, kernel 8 timed with and without the
   seed, `selective_scan_sp` through them and the public scan's last state
   taking no gradient; (c) a tensor-parallel Block at d_model 768 on route
   b (kernels 5/6 once each) against the unsplit one; (d)
   `mixer_pipeline_forward` at one stage and 4 microbatches of 4 x 2048:
   mamba-130m's 24 layers forward (24 kernel-1 launches per microbatch),
   then forward and backward (24 kernel-1 and 24 kernel-2 launches per
   microbatch), against the model run straight through; (e) the Switch FFN
   (d_model 768, 8 experts) split against unsplit, `cli.weight_test` on
   UNet and CFPNet, `cli.visualize` on the DRIVE run's two validation
   images.

The last lines are the card's name and power limit, one JSON line of kernel
numbers (each kernel's time, its plain version's, its bound and its launches
on the paths above; kernels 1 and 2 carry the LM's under `lm` and
mamba-370m's under `lm_370m`, rows 1-2
UM_Net's under `um_net` and HWAUNETR's under `hwaunetr`, the parallel
paths' launches under `parallel`, kernel 8's times with and without the
last state's gradient under `sp_dlast`), and
`{"ok": true, "device": {...}}`. Without a CUDA device it exits
non-zero before printing any result. It imports nothing of JAX or of the
JAX package.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# a kernel against its plain version, per element: |kernel - plain| <=
# tol * (|plain| + rms(plain)) (`rel_err`), each element held to its own
# size, floored at the tensor's root mean square where sums cancel to near
# zero. f32 differs only by summation order (largest sound reading 4.4e-6,
# the selective scan's backward); bf16 by at most one output ulp (2^-8 to
# 2^-7 relative) where an f32 sum lands on the other side of a rounding
# boundary (largest 6.4e-3). The selective scan's backward rounds each
# gradient once, at its end, as its plain version does: it is held to these
# limits too
TOL = {torch.float32: 2e-5, torch.bfloat16: 1.6e-2}
# whole model, kernels on the card vs plain on the CPU, f32: conv libraries
# and sums in other orders through ~100 layers
MODEL_TOL = 2e-3
# the fused Mamba and tap-conv backward kernels vs autograd of their plain
# versions, per input gradient, in the same per-element form: f32 sums over
# chunks, blocks and atomics in other orders (largest sound reading 1.8e-5,
# dA of kernel 2 at mamba-370m's D 2048, whose sums run over 16,384 chains
# of 2,048 tokens; 9.4e-6 over phase 2's f32 fused-scan calls);
# bf16 rounds the gradients at other points than the plain version's casts,
# a few ulps (largest 3.5e-2, tap-conv's dfeat)
BWD_TOL = {torch.float32: 3e-5, torch.bfloat16: 1e-1}
# every parameter gradient of MM_Net at depth 1 in train mode, card vs CPU,
# f32, relative to 1 + max |CPU|: the forward's differences (summation
# orders, scan chunking) carried back through ~40-60 layers and batch
# statistics over few values per channel at the deepest stage. The RCG
# Mambas' gradients are small against that scale, so the same pass holds
# every tap-conv and fused-scan call to its plain version (`TapCalls`,
# `FusedCalls` at TOL / BWD_TOL), which a single wrong call fails
GRAD_TOL = 1e-2
# dkDualNet, f32: the logits per element as `rel_err`, and every parameter
# gradient relative to the largest |want| of its own tensor (the layer
# scales of 1e-6 leave the blocks' gradients at 1e-11 to 1e-4), route a vs
# route b (largest sound reading 8.5e-6), and route b on the card vs the
# plain model on the CPU (6.2e-5; other convolution libraries)
ROUTE_TOL = 5e-5
DK_CPU_TOL = 3e-4
# MM_Net, f32, route a (kernels 1/2) vs route b (kernels 5/6) on the card,
# where both run the same torch ops and only the Mambas' summation order
# differs: the logits per element as `rel_err` (largest sound reading
# 3.8e-5), and every parameter gradient relative to the largest |want| of
# its own tensor (largest sound reading 1.6e-2, on the small gradients of
# an offset path's GroupNorm weight, max |grad| 9e-6; route a against
# itself, whose cuDNN and tap-conv backward sum in a varying order, reads
# up to 8.5e-3 on such tensors)
MM_ROUTE_LOGITS_TOL = 2e-4
MM_ROUTE_TOL = 5e-2
# every parameter gradient of MM_Net at depth 1 in train mode with the bf16
# feature path, card vs CPU (both bf16, the card sampling at the CPU's rows),
# relative to the largest |want| of its own tensor or to BF16_GRAD_FLOOR of
# the model's largest gradient where that is larger: bf16 rounds every
# layer's output and gradient to 2^-8 of its size, at other points on the
# two devices, and train-mode BatchNorm's backward cancels most of it, so a
# small gradient carries the rounding of the large ones it is summed from
# (the line's `unfloored` entry). Largest sound reading 2.3 (on
# `encoder4.0.block1.3.gn_offset.weight`); a planted fault
# that skips a tensor-core k-slice of the tap-conv fails it (PERF.md §6).
# The same noise moves the whole gradient vector by 0.39 of its norm
# (relative L2 over the tensors not held to zero; the k-slice fault, 4.7).
# So the model-level check finds faults that move many tensors and passes a
# single wrong small one; `TapCalls` and `FusedCalls` hold every tap-conv
# and every fused-scan call of the pass to its plain version at TOL /
# BWD_TOL, which a single wrong output or input gradient fails
BF16_GRAD_TOL = 4.0
BF16_GRAD_FLOOR = 1e-2
BF16_GRAD_NORM_TOL = 1.0
# UM_Net, f32: the full-width model's eval logits, kernels on the card vs
# plain versions on the CPU, per element as `rel_err` (largest sound
# reading 5.5e-6); route a vs route b on the card, logits per element and
# every parameter gradient relative to its own tensor, the forms and limits
# of phase 7 (largest sound readings 2.1e-6 and 3.6e-4)
UM_MODEL_TOL = 5e-5
UM_ROUTE_LOGITS_TOL = MM_ROUTE_LOGITS_TOL
UM_ROUTE_TOL = MM_ROUTE_TOL
TRAIN_STEPS = 6
# the Mamba LM at mamba-130m's published widths (f32): the depth-2 model's
# logits, kernels on the card vs plain versions on the CPU, per element as
# `rel_err` (UM_Net's limit); the decoders' teacher-forced step logits
# (plain ops, one token at a time) against the kernel-1 forward's at the
# same positions, max |step - forward| over the largest |forward| logit.
# Scoring: one forward at batch 4 x 2048 tokens (mamba-130m's training
# context); decoding: prompt 100, 100 new tokens at batch 1 and 8 (the
# defaults of the reference's benchmark_generation_mamba_simple.py)
LM_CPU_TOL = 5e-5
LM_DECODE_TOL = 1e-4
LM_SCORE = (4, 2048)
LM_PROMPT, LM_NEW, LM_BATCHES = 100, 100, (1, 8)
# sampling: top-k 50, then top-p 0.9, at temperature 8. Random weights tie
# each position's logits to its own token (the head is the embedding: that
# logit is ~sqrt(d_model) = 27.7 against ~N(0, 1) for the rest), so at
# temperature 1 every sample is the argmax; at 8 the samples leave the
# greedy tokens, and the two decoders' agreement means something
LM_SAMPLING = dict(temperature=8.0, top_k=50, top_p=0.9)
# LM training at mamba-130m's widths (phase 10 (e)), f32, 4 x 2048: route
# a (kernels 1/2) against route b (kernels 5/6) with the same weights, the
# backbone's output and every parameter gradient as ||a - b|| / ||b|| of
# its own tensor; both routes compute the same function and differ in
# summation order only, carried through 24 layers (largest reading 2.3e-6,
# a dt_proj weight)
LM_ROUTE_GRAD_TOL = 1e-4
LM_TRAIN_STEPS = 3
# phase 11, the zoo: config.yml's seven models besides MM_Net and UM_Net,
# f32, at config.yml's constructor settings and full width, seeded weights.
# Each trains and serves at its dataset's protocol size: FCBFormer at the
# polyp sets' 352² (config.yml's Kvasir_SEG / CVC_ClinicDB), the rest at
# DRIVE's 512² (`bench.py`'s shape), batch 8
ZOO = ("UNet", "ConvUNeXt", "CFPNet", "UNETR", "TransUNet", "SWINUNETR", "FCBFormer")
# phase 12: the JAX registry's last seven models, which config.yml has no
# section for, at their constructors' widths. HWAUNETR takes RGB images and
# one-class masks (`ZOO12_KWARGS`) and trains and serves at DRIVE's 512²
# (its total stride is 64 and its v3 slices, 64, 32, 16 and 8, divide 128²,
# 64², 32² and 16²); the six polyp models at the Kvasir-SEG / CVC-ClinicDB
# protocol of config.yml, 352²; batch 8
ZOO12 = ("HWAUNETR", "DuAT", "PVT_CASCADE", "CVC_UNETR", "BMANet", "CFANet", "VANet")
ZOO12_KWARGS = {"HWAUNETR": dict(in_chans=3, out_chans=1)}
ZOO_DATA = {"FCBFormer": ("Kvasir_SEG", 352), **{n: ("Kvasir_SEG", 352) for n in ZOO12[1:]}}
CONFIG_MODELS = ("MM_Net", "UM_Net") + ZOO
ZOO_TRAIN_STEPS = 4
ZOO_SERVING_REPS = 5
# phase 12 takes 10 steps at config.yml's lr 1e-3: from its seeded init,
# PVT_CASCADE's loss climbs over its first three steps (1.02 to 2.08 on the
# card, PR 13) and falls below the first from the seventh (1.06, then 0.95
# at step 8 and 0.81 at step 12 in a CPU run of the same init)
ZOO12_TRAIN_STEPS = 10
# card vs CPU at 128²: the eval logits per element as `rel_err` (read at
# f32 resolution), in f32 (largest sound reading 1.0e-5, UNETR) and in
# f64 (5.3e-8, TransUNet; 0 for the rest); every parameter
# gradient of one train-mode pass (2x3x128², DiceFocal, dropout at the
# identity) in f64, relative to the larger of its own tensor's largest
# |CPU| and ZOO_GRAD_FLOOR of the model's largest gradient (a bias or norm
# that feeds a train-mode norm has zero gradient in exact arithmetic). The
# f32 train step is too ill-conditioned to compare (per tensor up to 6e-2
# on UNet and CFPNet, 3.0 on TransUNet); in f64 the largest sound reading
# is 6.0e-7 (TransUNet). TransUNet multiplies its attention logits by
# sqrt(d) (the reference's; d = 256 at full width), which leaves its
# softmax nearly one-hot: its f32 logits read 3.3e-3 and 2.1e-2 in two
# calls and are printed, not held; its f64 ones are
ZOO_CPU_TOL = 5e-5
ZOO_F64_TOL = 1e-5
ZOO_GRAD_FLOOR = 1e-3
# Phase 12 (a) holds the last seven models to the same limits. HWAUNETR's
# Mambas run kernels 1/2 on the card and their plain versions on the CPU,
# in f32 also in the f64 passes (the kernels take f32 and bf16 streams; the
# plain version computes in f32 too); even so its readings stay far inside
# them (f32 logits 1.9e-6, f64 logits 7.8e-8, f64 gradients 9.5e-8 of
# their tensor; the six others up to 4.1e-6, 0 and 1.1e-7)
# `FusedCalls` over a HWAUNETR train-mode pass (f32, 2x3x512²): the
# gradients that reach its stage-1 Mamba calls cancel to ~1e-9 (weights)
# and ~1e-8 (xz) through the near one-hot softmax(qᵀk) and the norms, so
# their f32 sums, kernel against plain version, read up to 9.7e-5 per
# element (dt_b; 1e-13 absolute), where phase 12's random data at the same
# shapes read 9.0e-6; the plain version's own spread there, its gradients
# on the CPU against the card's, reads 1.25e-4 (PR 13), and the line
# prints it beside the reading
HWA_FUSED_BWD_TOL = {torch.float32: 3e-4, torch.bfloat16: BWD_TOL[torch.bfloat16]}
# HWAUNETR's two Mamba routes on the card (`mamba_routes_check`, f32,
# 2x3x512²): the logits per element and every gradient per tensor
HWA_ROUTE_LOGITS_TOL = MM_ROUTE_LOGITS_TOL
HWA_ROUTE_TOL = MM_ROUTE_TOL


# the H100 SXM's published peaks (NVIDIA's data sheet, at 700 W): device
# memory bytes/s, f32 operations/s outside the tensor cores, and the dense
# bf16 tensor-core rate; a kernel's bound is the larger of its bytes (each
# input read once, each output written once) over the first and its
# operations over their rates: the tap-conv's products of a bf16 stream
# (bf16 x bf16 -> f32) at the tensor cores' rate, every other operation and
# every f32 stream at the FMA units' rate; the two units run at once, so
# the operations take the longer of their two times
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12
# dkDualNet's three grouped scans at 512², batch 8: (channels per direction,
# tokens) of stages 2, 3 and 4, two directions each, 16 states
DK_SCANS = ((96, 16384), (192, 4096), (384, 1024))


def bound(nbytes: float, ops: float, tc_ops: float = 0.0) -> tuple[float, str]:
    """(least time in ms, what bounds it) for `nbytes` moved, `ops` done on
    the FMA units and `tc_ops` on the bf16 tensor cores."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / F32_OPS_PER_S, tc_ops / BF16_TC_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mamba_work(B, D, L, N, R, W, es, backward):
    """(bytes, operations) of one fused Mamba scan of one direction: xz and
    the weights in, the gated output out (backward: xz, dout and the
    weights in, dxz and the weights' gradients out); per (b, d, t) the conv,
    projections, softplus and gate, per (b, d, n, t) the scan's exp and
    multiply-adds (the backward: rebuild, local and full adjoint)."""
    E = R + 2 * N
    weights = 4 * (D * W + E * D + D * R + D * N + 3 * D)
    if backward:
        return (es * B * L * 5 * D + 2 * weights,
                B * L * (D * (4 * W + 4 * E + 4 * R + 30) + D * N * 29))
    return es * B * L * 3 * D + weights, B * L * (D * (2 * W + 2 * E + 2 * R + 14) + D * N * 8)


def tap_work(B, H, W, C, F, K, es, backward):
    """(bytes, FMA-unit operations, tensor-core operations) of one tap-conv:
    feat, row coordinates, kernel (in the stream dtype) and bias in, output
    out (backward: feat, rows, kernel and dout in, dfeat, dy, dkernel and
    dbias out, dkernel and dbias f32); per pixel the gathered lerp and the
    (K C) x F product (backward: the lerp, the scatter and dy, and two
    products). A bf16 stream's products run on the tensor cores."""
    px = B * H * W
    if backward:
        nbytes = px * (2 * C * es + 2 * K * 4 + F * es) + K * C * F * (es + 4) + 4 * F
        prod, rest = px * 4 * K * C * F, px * 8 * K * C
    else:
        nbytes = px * (C * es + K * 4 + F * es) + K * C * F * es + 4 * F
        prod, rest = px * 2 * K * C * F, px * 3 * K * C
    return (nbytes, rest, prod) if es == 2 else (nbytes, rest + prod, 0.0)


def scan_work(B, Dm, L, N, G, es, bes, streams, backward, const_bc=False):
    """(bytes, operations) of one selective scan: the `streams` (u, delta[,
    z]) and B/C in, the output out (backward: the streams, B/C and dout in,
    their gradients out); per (b, d, n, t) the exp and multiply-adds of the
    scan (backward: rebuild, local and full adjoint with three sums over the
    states). The chunk states the kernels keep between passes are their
    design's, not the function's, and are not counted."""
    bc = 2 * 4 * Dm * N if const_bc else 2 * bes * B * G * N * L
    if backward:
        return es * B * Dm * L * (2 * streams + 1) + 2 * bc, B * Dm * L * (30 * N + 20)
    return es * B * Dm * L * (streams + 1) + bc, B * Dm * L * (8 * N + 10)


def mamba_inputs(rn, dev, B, D, R, L, N=16, W=4):
    """xz (B, 1, 2D, L) and the seven weights of one fused Mamba scan, the
    A rows those of Mamba's init (-1 .. -N), in that order from `rn`."""
    xz = torch.cat([rn(B, 1, D, L, scale=0.5), rn(B, 1, D, L)], dim=2)
    w = [rn(1, D, W, scale=0.4), rn(1, D, scale=0.1), rn(1, R + 2 * N, D, scale=D ** -0.5),
         rn(1, D, R, scale=R ** -0.5), rn(1, D, scale=0.1) - 4.0,
         -torch.exp(torch.log(torch.arange(1, N + 1.0, device=dev)).repeat(1, D, 1)),
         torch.ones(1, D, device=dev)]
    return xz, w


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() in ms over `reps` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(got, want) -> tuple[float, float]:
    """(max |got - want|, max of |got - want| / (|want| + rms(want))) over
    the elements."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    floor = w.square().mean().sqrt()
    rel = diff / (w.abs() + floor).clamp_min(torch.finfo(torch.float32).tiny)
    return diff.max().item(), rel.max().item()


def compare(got, want, dtype):
    err, rel = rel_err(got, want)
    return err, rel, rel <= TOL[dtype]


def phase1_kernels(gen) -> dict:
    from mm_unet_tpu_torch.ops.mamba_fused import mamba_fused_scan, mamba_fused_scan_ref
    from mm_unet_tpu_torch.ops.tap_conv import tap_conv, tap_conv_ref

    dev = torch.device("cuda")

    def rn(*s, scale=1.0):
        return (torch.randn(*s, generator=gen) * scale).to(dev)

    results = {"mamba_fused_scan": [], "tap_conv": []}
    failed = []
    # Mamba: RCG3 (d_model 64 -> D=128, R=4, L=128²) and the Side2 MMConv
    # (d_model 3 -> D=6, R=1, L=256²), batch 2, N=16, W=4
    for D, R, L in ((128, 4, 16384), (6, 1, 65536)):
        N, W, B = 16, 4, 2
        xz, w = mamba_inputs(rn, dev, B, D, R, L, N, W)
        for dtype in (torch.float32, torch.bfloat16):
            x = xz.to(dtype)
            for rev in (False, True):
                got = mamba_fused_scan(x, *w, reverse=rev)
                torch.cuda.synchronize()
                want = mamba_fused_scan_ref(x, *w, reverse=rev)
                torch.cuda.synchronize()
                err, rel, ok = compare(got, want, dtype)
                ms = cuda_ms(lambda: mamba_fused_scan(x, *w, reverse=rev), reps=20)
                plain_ms = cuda_ms(lambda: mamba_fused_scan_ref(x, *w, reverse=rev), reps=1)
                bms, by = bound(*mamba_work(B, D, L, N, R, W, x.element_size(), False))
                rec = dict(D=D, L=L, B=B, dtype=str(dtype)[6:], reverse=rev, max_abs_err=err,
                           rel_err=rel, tol=TOL[dtype], ms=ms, plain_ms=plain_ms, bound_ms=bms,
                           bound_by=by, ok=ok)
                print(f"phase1 mamba_fused_scan {json.dumps(rec)}", flush=True)
                results["mamba_fused_scan"].append(rec)
                failed += [] if ok else [rec]
                del got, want
        del xz, x
    # tap-conv at 512² batch 8: stage-2 MMConv (128², C=F=64), stage 5
    # (16², C=F=512), a side output at 256² (C=64, F=16), a 1x1 reducer
    # (64², C=128, F=64, K=1)
    for hw, C, F, K in ((128, 64, 64, 3), (16, 512, 512, 3), (256, 64, 16, 3), (64, 128, 64, 1)):
        B = 8
        feat = rn(B, hw, hw, C)
        rows = torch.arange(hw, dtype=torch.float32, device=dev)[None, :, None, None]
        y = rows + rn(B, hw, hw, K, scale=2.0)  # reaches past both edges
        ker, bias = rn(K, 1, C, F, scale=(K * C) ** -0.5), rn(F, scale=0.1)
        shifts = [j - K // 2 for j in range(K)]
        for dtype in (torch.float32, torch.bfloat16):
            f = feat.to(dtype)
            got = tap_conv(f, y, ker, bias, shifts)
            torch.cuda.synchronize()
            want = tap_conv_ref(f, y, ker, bias, shifts)
            torch.cuda.synchronize()
            err, rel, ok = compare(got, want, dtype)
            ms = cuda_ms(lambda: tap_conv(f, y, ker, bias, shifts), reps=20)
            plain_ms = cuda_ms(lambda: tap_conv_ref(f, y, ker, bias, shifts), reps=5)
            bms, by = bound(*tap_work(B, hw, hw, C, F, K, f.element_size(), False))
            rec = dict(HW=hw, C=C, F=F, K=K, B=B, dtype=str(dtype)[6:], max_abs_err=err,
                       rel_err=rel, tol=TOL[dtype], ms=ms, plain_ms=plain_ms, bound_ms=bms,
                       bound_by=by, ok=ok)
            print(f"phase1 tap_conv {json.dumps(rec)}", flush=True)
            results["tap_conv"].append(rec)
            failed += [] if ok else [rec]
    if failed:
        raise SystemExit(f"phase1 FAILED: {len(failed)} kernel comparisons out of tolerance")
    return results


def grads_of(fn, inputs, dout):
    """(out, the inputs that take gradients, their gradients) of fn at
    copies of `inputs`; the graph is kept so that the backward can be timed."""
    ins = [None if t is None else t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*ins)
    live = [t for t in ins if t is not None]
    return out, live, torch.autograd.grad(out, live, dout, retain_graph=True)


def compare_grads(got, want, names, tol):
    """({name: [max_abs_err, rel_err]}, all within `tol`) per gradient."""
    errs = {name: list(rel_err(g, w)) for name, g, w in zip(names, got, want)}
    return errs, all(rel <= tol for _, rel in errs.values())


def grad_errs(got: dict, want: dict) -> tuple[int, list]:
    """(parameters out of GRAD_TOL or not finite, the four worst) for two
    {name: gradient} maps, each error relative to 1 + max |want|."""
    worst, bad = [], 0
    for name, w in want.items():
        g = got[name]
        err = (g.float().cpu() - w.float().cpu()).abs().max().item()
        rel = err / (1.0 + w.float().abs().max().item())
        worst.append((rel, name, err))
        bad += rel > GRAD_TOL or not bool(torch.isfinite(g).all())
    worst.sort(reverse=True)
    return bad, [dict(name=n, max_abs_err=e, relative=r) for r, n, e in worst[:4]]


def bn_fed_biases(model: torch.nn.Module) -> set:
    """Names of the per-channel parameters that feed a BatchNorm directly
    (within an nn.Sequential): a conv's bias, and the weight and bias of the
    GroupNorm that ends an MMConv. In train mode the norm subtracts the batch
    mean, which removes a per-channel shift exactly, and divides by the batch
    deviation, which removes a per-channel scale but for the norm's eps: their
    gradient is zero in exact arithmetic (the scale's, to ~eps / variance)
    and rounding noise in f32. A DSConv ends in a GroupNorm as an MMConv
    does. An InstanceNorm removes each sample's per-channel shift in any
    mode: so do the biases of the convs that HWAUNETR's GMP blocks
    normalise, and of the channel MLPs whose output the next stage's
    downsampling normalises first."""
    from mm_unet_tpu_torch.models.dsconv import DSConv
    from mm_unet_tpu_torch.models.hwaunetr import Encoder, GMPBlock
    from mm_unet_tpu_torch.models.mm_unet import MMConv

    names = {f"{prefix}.{conv}.bias" for prefix, m in model.named_modules()
             if isinstance(m, GMPBlock) for conv in ("proj", "proj2", "proj3", "proj4")}
    names |= {f"{prefix}.mlps.{i}.fc2.bias" for prefix, m in model.named_modules()
              if isinstance(m, Encoder) for i in range(len(m.mlps) - 1)}
    for prefix, m in model.named_modules():
        if isinstance(m, torch.nn.Sequential):
            for i, (conv, norm) in enumerate(zip(m, list(m)[1:])):
                if not isinstance(norm, torch.nn.BatchNorm2d):
                    continue
                name = f"{prefix}.{i}" if prefix else f"{i}"
                if isinstance(conv, torch.nn.Conv2d) and conv.bias is not None:
                    names.add(f"{name}.bias")
                elif isinstance(conv, (MMConv, DSConv)):
                    names.update((f"{name}.gn.weight", f"{name}.gn.bias"))
    return names


def tensor_grad_errs(got: dict, want: dict, tol: float, exact_zero: set,
                     floor: float = 0.0) -> tuple[int, list]:
    """(parameters out of `tol` or not finite, the four worst) for two
    {name: gradient} maps, each error relative to the largest |want| of its
    own tensor, or to `floor` times the largest gradient of the model where
    that is larger. A gradient that is zero in exact arithmetic
    (`exact_zero`) is held to zero instead: its largest |got| and |want|
    relative to the largest gradient of the model."""
    top = max(w.float().abs().max().item() for w in want.values())
    worst, bad = [], 0
    for name, w in want.items():
        g, w = got[name].float().cpu(), w.float().cpu()
        if name in exact_zero:
            err, size = max(g.abs().max().item(), w.abs().max().item()), top
        else:
            err, size = (g - w).abs().max().item(), max(w.abs().max().item(), floor * top)
        rel = err / size if size else (math.inf if err else 0.0)
        worst.append((rel, name, err, size))
        bad += not rel <= tol or not bool(torch.isfinite(g).all())
    worst.sort(reverse=True)
    return bad, [dict(name=n, max_abs_err=e, relative=r, scale=m) for r, n, e, m in worst[:4]]


class RowPins:
    """Sample rows of a model's morph-0 deformable convs (MMConv, DSConv),
    by module name: `record()` keeps each module's row coordinates on the
    next pass; `pin(rows)` makes each module sample at the given rows while
    its gradient still flows through its own (`y + (y_pinned - y).detach()`)
    and keeps the rows' largest difference in `.err`; `release()` restores
    the modules. The gradient of a row sample w.r.t. its row jumps where
    floor() of the row crosses an integer, so two computations whose rows
    differ by rounding are compared at one set of rows."""

    def __init__(self, model):
        from mm_unet_tpu_torch.models.dsconv import DSConv
        from mm_unet_tpu_torch.models.mm_unet import MMConv

        self.modules = {n: m for n, m in model.named_modules()
                        if isinstance(m, (MMConv, DSConv)) and m.morph == 0}
        self.rows, self.err = {}, 0.0

    def _wrap(self, name, m, rows):
        def sample_conv(feat, y):
            if rows is None:
                self.rows[name] = y.detach()
            else:
                want = rows[name].to(y.device)
                self.err = max(self.err, (y - want).abs().max().item())
                y = y + (want - y).detach()
            return type(m)._sample_conv(m, feat, y)
        return sample_conv

    def record(self):
        for name, m in self.modules.items():
            m._sample_conv = self._wrap(name, m, None)

    def pin(self, rows):
        for name, m in self.modules.items():
            m._sample_conv = self._wrap(name, m, rows)

    def release(self):
        for m in self.modules.values():
            m.__dict__.pop("_sample_conv", None)


class KernelCalls:
    """Every call of `module.attr` (a kernel wrapper, where a model's module
    reaches it) while this context is open: the call's arguments and
    output, the gradient of its output, and the gradient the call gave each
    tensor argument (tensor hooks). Subclasses hold each call to the plain
    version at those very inputs (`check`)."""

    def __init__(self, module, attr: str):
        self.module, self.attr, self.calls, self.handles = module, attr, [], []

    def __enter__(self):
        fn = self.plain = getattr(self.module, self.attr)

        def watched(*args, **kwargs):
            out = fn(*args, **kwargs)
            rec = {"args": [a.detach() if isinstance(a, torch.Tensor) else a for a in args],
                   "kwargs": kwargs, "out": out.detach(), "grads": [None] * len(args),
                   "wants_grad": [isinstance(a, torch.Tensor) and a.requires_grad for a in args],
                   "dout": None}
            if out.requires_grad:
                out.register_hook(lambda g: rec.__setitem__("dout", g.detach()))
                for i, a in enumerate(args):
                    if rec["wants_grad"][i]:
                        self.handles.append(a.register_hook(
                            lambda g, i=i: rec["grads"].__setitem__(i, g.detach())))
            self.calls.append(rec)
            return out

        setattr(self.module, self.attr, watched)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.plain)
        for h in self.handles:
            h.remove()


class TapCalls(KernelCalls):
    """Every tap-conv call a model makes while this context is open, where
    the morph-0 sample-conv makes it (`layers.row_sample_conv`).
    `check(tag)` holds each call to the plain version at its own inputs: the
    output (TOL) and each input's gradient against autograd of
    `tap_conv_ref` with the same output gradient (BWD_TOL), per element as
    `rel_err`; the kernels at the data and shapes the model gives them, each
    call on its own, so that a single wrong call fails however little it
    moves the model's gradients. dbias is held to the size of its summands
    (its largest |dbias - plain| over the largest sum of |dout| over the
    pixels): the GroupNorm after every tap-conv makes dout sum to zero over
    each group, so a model's dbias cancels to where summation order moves it
    by a third (0.37, f32, UM_Net), while on phase 1's random data it is
    held per element."""

    def __init__(self):
        from mm_unet_tpu_torch.models import layers

        super().__init__(layers, "tap_conv")

    def check(self, tag: str) -> bool:
        """Prints one line for all calls (the worst forward and backward
        readings, with their shapes) and returns whether every call is within
        its limits; a call whose backward did not run is a miss."""
        from mm_unet_tpu_torch.ops.tap_conv import tap_conv_ref

        names = ["feat", "y", "kernel", "bias"]
        worst_f, worst_b, bad = (-1.0, None), (-1.0, None), 0
        for rec in self.calls:
            feat, y, kernel, bias, shifts = rec["args"]
            dtype = feat.dtype
            shape = dict(B=feat.shape[0], H=feat.shape[1], W=feat.shape[2], C=feat.shape[3],
                         F=kernel.shape[-1], K=kernel.shape[0], dtype=str(dtype)[6:])
            with torch.no_grad():
                _, rel_f = rel_err(rec["out"], tap_conv_ref(*rec["args"]))
            ok = rel_f <= TOL[dtype]
            worst_f = max(worst_f, (rel_f, shape), key=lambda w: w[0])
            if rec["dout"] is None or any(g is None for g in rec["grads"][:4]):
                bad += 1
                continue
            want = grads_of(lambda *a: tap_conv_ref(*a, shifts), rec["args"][:4], rec["dout"])[2]
            errs, _ = compare_grads(rec["grads"][:3], want[:3], names[:3], BWD_TOL[dtype])
            # dbias, a sum of dout over the pixels, against the size of its
            # summands: behind a GroupNorm the sum cancels nearly to zero
            err = (rec["grads"][3].float() - want[3].float()).abs().max().item()
            errs["bias"] = [err, err / rec["dout"].float().abs().sum((0, 1, 2)).max().item()]
            rel_b = max(r for _, r in errs.values())
            ok_b = rel_b <= BWD_TOL[dtype]
            worst_b = max(worst_b, (rel_b, dict(shape, errs=errs)), key=lambda w: w[0])
            bad += not (ok and ok_b)
        ok = bad == 0 and bool(self.calls)
        print(f"{tag} " + json.dumps(dict(
            calls=len(self.calls), out_of_tol=bad, fwd_rel_err=worst_f[0], fwd_worst=worst_f[1],
            bwd_rel_err=worst_b[0], bwd_worst=worst_b[1],
            tol={str(d)[6:]: [TOL[d], BWD_TOL[d]] for d in (torch.float32, torch.bfloat16)},
            ok=ok)), flush=True)
        return ok


class FusedCalls(KernelCalls):
    """Every fused-scan call (kernels 1/2) a model makes while this context
    is open, where Mamba makes it (`models.mamba.mamba_fused_scan`).
    `check(tag)` holds each call to `mamba_fused_scan_ref` at its own
    inputs: the output per element at TOL, and each input's gradient against
    autograd of the plain version with the same output gradient at BWD_TOL,
    per element as `rel_err` (the weights' gradients sum over the call's
    tokens, each element held to its own size, floored at the tensor's
    rms). One wrong call fails it, however little it moves the model's
    gradients."""

    NAMES = ("xz", "conv_w", "conv_b", "x_proj", "dt_w", "dt_b", "A", "D")

    def __init__(self):
        from mm_unet_tpu_torch.models import mamba

        super().__init__(mamba, "mamba_fused_scan")

    def check(self, tag: str, bwd_tol: dict = BWD_TOL) -> bool:
        """Prints one line for all calls (the worst forward and backward
        readings, with their shapes) and returns whether every call is within
        its limits (the backward's `bwd_tol` by dtype); a call whose backward
        did not reach every input that takes a gradient is a miss. Beside
        the worst backward reading the line gives the plain version's own
        spread there: its gradients at the same inputs computed again on the
        CPU, against the card's (`plain_spread`)."""
        from mm_unet_tpu_torch.ops.mamba_fused import mamba_fused_scan_ref

        worst_f, worst_b, bad = (-1.0, None), (-1.0, None, None), 0
        for rec in self.calls:
            xz, dtype, reverse = rec["args"][0], rec["args"][0].dtype, rec["kwargs"]["reverse"]
            shape = dict(B=xz.shape[0], D=xz.shape[2] // 2, L=xz.shape[3],
                         R=rec["args"][4].shape[2], reverse=reverse, dtype=str(dtype)[6:])
            ref = lambda *a: mamba_fused_scan_ref(*a, reverse=reverse)  # noqa: E731
            with torch.no_grad():
                _, rel_f = rel_err(rec["out"], ref(*rec["args"]))
            ok = rel_f <= TOL[dtype]
            worst_f = max(worst_f, (rel_f, shape), key=lambda w: w[0])
            live = [i for i, w in enumerate(rec["wants_grad"]) if w]
            if rec["dout"] is None or any(rec["grads"][i] is None for i in live):
                bad += 1
                continue
            ins = [None if t is None else t.detach().clone().requires_grad_(i in live)
                   for i, t in enumerate(rec["args"])]
            want = torch.autograd.grad(ref(*ins), [ins[i] for i in live], rec["dout"])
            errs, ok_b = compare_grads([rec["grads"][i] for i in live], want,
                                       [self.NAMES[i] for i in live], bwd_tol[dtype])
            rel_b = max(r for _, r in errs.values())
            worst_b = max(worst_b, (rel_b, dict(shape, errs=errs), (rec, live, want)),
                          key=lambda w: w[0])
            bad += not (ok and ok_b)
        spread = None
        if worst_b[2] is not None:
            rec, live, want = worst_b[2]
            reverse = rec["kwargs"]["reverse"]
            ins = [None if t is None else t.detach().cpu().requires_grad_(i in live)
                   for i, t in enumerate(rec["args"])]
            again = torch.autograd.grad(mamba_fused_scan_ref(*ins, reverse=reverse),
                                        [ins[i] for i in live], rec["dout"].cpu())
            spread = max(rel_err(a, w.cpu())[1] for a, w in zip(again, want))
        ok = bad == 0 and bool(self.calls)
        print(f"{tag} " + json.dumps(dict(
            calls=len(self.calls), out_of_tol=bad, fwd_rel_err=worst_f[0], fwd_worst=worst_f[1],
            bwd_rel_err=worst_b[0], bwd_worst=worst_b[1], plain_spread=spread,
            tol={str(d)[6:]: [TOL[d], bwd_tol[d]] for d in (torch.float32, torch.bfloat16)},
            ok=ok)), flush=True)
        return ok


SERVING_REPS = 10
SERVING_PASSES = 2 * (1 + SERVING_REPS)  # per `serving_rates` call: two predictors


def serving_rates(model, inferer, x) -> dict:
    """Sliding-window images/s of the f32 and the bf16 predictor over
    SERVING_REPS passes each, after one warm-up pass each."""
    from mm_unet_tpu_torch.train.predictor import make_predictor

    rates = {}
    for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        predictor = make_predictor(model, dtype)
        inferer(x, predictor)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SERVING_REPS):
            out = inferer(x, predictor)
        torch.cuda.synchronize()
        rates[name] = x.shape[0] * SERVING_REPS / (time.perf_counter() - t0)
        if not bool(torch.isfinite(out).all()):
            raise SystemExit(f"FAILED: non-finite {name} logits")
    return rates


def phase1_backward(gen) -> dict:
    from mm_unet_tpu_torch.ops.mamba_fused import mamba_fused_scan, mamba_fused_scan_ref
    from mm_unet_tpu_torch.ops.tap_conv import tap_conv, tap_conv_ref

    dev = torch.device("cuda")

    def rn(*s, scale=1.0):
        return (torch.randn(*s, generator=gen) * scale).to(dev)

    results = {"mamba_fused_scan_bwd": [], "mamba_fused_scan_bwd_lm": [], "tap_conv_bwd": []}
    failed = []

    def run(kind, shape, fn, ref, inputs, dout, names, dtype, plain_reps, work, into=None):
        out, live, got = grads_of(fn, inputs, dout)
        torch.cuda.synchronize()
        outp, livep, want = grads_of(ref, inputs, dout)
        torch.cuda.synchronize()
        errs, ok = compare_grads(got, want, names, BWD_TOL[dtype])
        call = lambda: torch.autograd.grad(out, live, dout, retain_graph=True)  # noqa: E731
        ms = cuda_ms(call, reps=10)
        kms = {"kernel_ms": kernel_device_ms(call, BWD_KERNELS)} if kind.startswith("mamba") else {}
        plain_ms = cuda_ms(lambda: torch.autograd.grad(outp, livep, dout, retain_graph=True),
                           reps=plain_reps, warmup=0)
        bms, by = bound(*work)
        rec = dict(shape, dtype=str(dtype)[6:], max_abs_err=max(e for e, _ in errs.values()),
                   rel_err=max(r for _, r in errs.values()), tol=BWD_TOL[dtype], errs=errs,
                   ms=ms, **kms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, ok=ok)
        print(f"phase1 {kind} {json.dumps(rec)}", flush=True)
        results[into or kind].append(rec)
        failed.extend([] if ok else [rec])

    # the same shapes as the forward comparison, then the Mamba LM's
    # (mamba-130m's d_inner 1536, dt_rank 48, at the scoring batch 4 x
    # 2048), whose chunk spans a cluster of channel blocks; each line with
    # kernel 2's plan and its passes' resident blocks per SM
    for D, R, L, B, revs in ((128, 4, 16384, 2, (False, True)), (6, 1, 65536, 2, (False, True)),
                             (1536, 48, 2048, 4, (False,))):
        N, W = 16, 4
        xz, w = mamba_inputs(rn, dev, B, D, R, L, N, W)
        dout = rn(B, 1, D, L)
        names = ["xz", "conv_w", "conv_b", "x_proj", "dt_w", "dt_b", "A", "D"]
        for dtype in (torch.float32, torch.bfloat16):
            for rev in revs:
                run("mamba_fused_scan_bwd", dict(D=D, R=R, L=L, B=B, reverse=rev,
                                                 **bwd_plan(D, R, N, dtype)),
                    lambda *a, r=rev: mamba_fused_scan(*a, reverse=r),
                    lambda *a, r=rev: mamba_fused_scan_ref(*a, reverse=r),
                    [xz.to(dtype), *w], dout.to(dtype), names, dtype, plain_reps=1,
                    work=mamba_work(B, D, L, N, R, W, dout.to(dtype).element_size(), True),
                    into="mamba_fused_scan_bwd_lm" if D == 1536 else None)
        del xz, dout
    for hw, C, F, K in ((128, 64, 64, 3), (16, 512, 512, 3), (256, 64, 16, 3), (64, 128, 64, 1)):
        B = 8
        rows = torch.arange(hw, dtype=torch.float32, device=dev)[None, :, None, None]
        inputs = [rn(B, hw, hw, C), rows + rn(B, hw, hw, K, scale=2.0),
                  rn(K, 1, C, F, scale=(K * C) ** -0.5), rn(F, scale=0.1)]
        dout = rn(B, hw, hw, F)
        shifts = [j - K // 2 for j in range(K)]
        for dtype in (torch.float32, torch.bfloat16):
            run("tap_conv_bwd", dict(HW=hw, C=C, F=F, K=K, B=B),
                lambda *a: tap_conv(*a, shifts), lambda *a: tap_conv_ref(*a, shifts),
                [inputs[0].to(dtype), *inputs[1:]], dout.to(dtype),
                ["feat", "y", "kernel", "bias"], dtype, plain_reps=3,
                work=tap_work(B, hw, hw, C, F, K, dout.to(dtype).element_size(), True))
    if failed:
        raise SystemExit(f"phase1 FAILED: {len(failed)} backward comparisons out of tolerance")
    return results


def mamba_step_shapes(model) -> tuple[dict, list]:
    """({shape: fused-scan calls}, hooks): forward hooks on the model's
    megakernel Mambas that count, per forward, one call per direction at
    (batch, d_inner, dt_rank, d_state, conv width, tokens, reverse, stream
    dtype); a train step's backward launches kernel 2 once per call."""
    from mm_unet_tpu_torch.models.mamba import DIRECTIONS, Mamba

    shapes: dict = {}

    def record(mod, inputs, _):
        bsz, length, _ = inputs[0].shape
        dtype = str(mod.dtype or inputs[0].dtype)[6:]
        for sfx in DIRECTIONS[mod.bimamba_type]:
            key = (bsz, mod.d_inner, mod.dt_rank, mod.d_state, mod.conv1d.weight.shape[-1],
                   length, sfx == "_b", dtype)
            shapes[key] = shapes.get(key, 0) + 1

    hooks = [m.register_forward_hook(record) for m in model.modules()
             if isinstance(m, Mamba) and m.use_mega]
    return shapes, hooks


def kernel_device_ms(fn, fragments: tuple, reps: int = 3) -> float:
    """Device time of one call of fn() (already warm) spent in the kernels
    whose names contain one of `fragments`, each launched once per call, by
    torch.profiler over `reps` calls: without the host's share, which
    decides `cuda_ms` at small shapes. Each kernel's time is its mean over
    the launches the profiler recorded, which need not be all of them; a
    window in which it recorded none of them is profiled again (up to six
    windows; late in a long run it has recorded none in three)."""
    return kernel_device_ms_by(fn, {"all": fragments}, reps)["all"]


def kernel_device_ms_by(fn, groups: dict, reps: int = 3, summed: tuple = ()) -> dict:
    """`kernel_device_ms` for several groups of fragments from the same
    windows: {group: device ms per call}; a window is profiled again while
    a group has no recorded launch. A group in `summed` is launched several
    times per call under one name (PyTorch's reductions): its time is the
    window's total over `reps`."""
    from torch.profiler import ProfilerActivity, profile

    ms = {}
    for _ in range(6):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        ms = {g: sum(e.self_device_time_total / (reps if g in summed else e.count)
                     for e in events if any(f in e.key for f in frags)) / 1e3
              for g, frags in groups.items()}
        if all(v > 0 for v in ms.values()):
            break
    return ms


def call_device_ops(fn, reps: int = 3) -> dict:
    """Every operation one call of fn() (already warm) puts on the device,
    by torch.profiler over `reps` calls: kernels, memsets and copies, the
    kernel wrapper's own PyTorch launches included ({"launches": n per
    call, "device_ms": t per call, "names": {name: launches per call}}). A
    window that recorded fewer than `reps` launches of some operation is
    profiled again (up to three windows)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events and all(e.count % reps == 0 for e in events):
            break
    return {"launches": sum(e.count for e in events) / reps,
            "device_ms": sum(e.self_device_time_total for e in events) / 1e3 / reps,
            "names": {e.key[:60]: e.count / reps for e in events}}


def tap_step_shapes(model) -> tuple[dict, list]:
    """({shape: tap-conv calls}, hooks): forward hooks on the model's
    morph-0 MMConvs and DSConvs that count, per forward, the one tap-conv
    each makes at (batch, H, W, C, F, K, stream dtype), read from the
    module's input (B, C, H, W) and its weights; a train step's backward
    launches kernel 4 once per call."""
    from mm_unet_tpu_torch.models.dsconv import DSConv
    from mm_unet_tpu_torch.models.mm_unet import MMConv

    shapes: dict = {}

    def record(mod, inputs, _):
        bsz, c, h, w = inputs[0].shape
        key = (bsz, h, w, c, mod.dsc_conv_x.weight.shape[0], mod.kernel_size,
               str(inputs[0].dtype)[6:])
        shapes[key] = shapes.get(key, 0) + 1

    hooks = [m.register_forward_hook(record) for m in model.modules()
             if isinstance(m, (MMConv, DSConv)) and m.morph == 0]
    return shapes, hooks


def scan_step_shapes(model) -> tuple[dict, list]:
    """({shape: selective-scan calls}, hooks): forward hooks on the model's
    Mambas that count, per forward on the grouped-scan route, the one
    `selective_scan` call each makes at (batch, channels of all directions,
    directions, d_state, dt_rank, tokens, stream dtype); a train step's
    backward launches kernel 6 once per call."""
    from mm_unet_tpu_torch.models.mamba import DIRECTIONS, Mamba

    shapes: dict = {}

    def record(mod, inputs, _):
        if mod.use_mega:
            return
        bsz, length, _ = inputs[0].shape
        g = len(DIRECTIONS[mod.bimamba_type])
        key = (bsz, g * mod.d_inner, g, mod.d_state, mod.dt_rank, length,
               str(mod.dtype or inputs[0].dtype)[6:])
        shapes[key] = shapes.get(key, 0) + 1

    hooks = [m.register_forward_hook(record) for m in model.modules() if isinstance(m, Mamba)]
    return shapes, hooks


# kernel-name fragments of each fused Mamba kernel's launches (kernel 2's
# pass C is `mamba_bwd_chunk_kernel`, which holds neither forward fragment)
FWD_KERNELS = ("mamba_chunk_kernel", "mamba_combine_kernel", "mamba_fwd_xdbl")
BWD_KERNELS = ("mamba_bwd_",)


def fwd_plan(D: int, R: int, N: int, dtype) -> dict:
    """Kernel 1's launch for this shape (`_fwd_plan`: chunk length T, nb
    blocks of Dc channels a chunk) and, by the CUDA
    runtime's occupancy calculator, the resident blocks per SM of its two
    chunk passes (zero-state, final) and of pass X (nb > 1)."""
    import ctypes

    from mm_unet_tpu_torch import _build
    from mm_unet_tpu_torch.ops.mamba_fused import _fwd_plan

    plan = _fwd_plan(D, R + 2 * N, N)
    out = (ctypes.c_int * 3)()
    err = _build.library().mamba_fused_fwd_blocks_per_sm(
        D, R, N, plan["T"], plan["Dc"], int(dtype == torch.bfloat16), out)
    _build.check(err, "mamba_fused_fwd_blocks_per_sm")
    return dict(T=plan["T"], Dc=plan["Dc"], nb=plan["nb"], blocks_per_sm=[out[0], out[1]],
                pass_x_blocks_per_sm=out[2] if plan["nb"] > 1 else None)


def bwd_plan(D: int, R: int, N: int, dtype) -> dict:
    """Kernel 2's launch for this shape (`_bwd_plan`: chunk length T, nb
    blocks of Dc channels a chunk) and, by the CUDA runtime's occupancy
    calculator, the resident blocks per SM of its passes X, A and C and the
    clusters of pass C the card holds at once."""
    import ctypes

    from mm_unet_tpu_torch import _build
    from mm_unet_tpu_torch.ops.mamba_fused import _bwd_plan

    plan = _bwd_plan(D, R + 2 * N, N)
    out = (ctypes.c_int * 4)()
    err = _build.library().mamba_fused_bwd_blocks_per_sm(
        D, R, N, plan["T"], plan["Dc"], int(dtype == torch.bfloat16), out)
    _build.check(err, "mamba_fused_bwd_blocks_per_sm")
    return dict(T=plan["T"], Dc=plan["Dc"], nb=plan["nb"], blocks_per_sm=dict(
        pass_x=out[0] if plan["nb"] > 1 else None, pass_a=out[1], pass_c=out[2]),
        pass_c_clusters=out[3] if plan["nb"] > 1 else None)


def phase1_step_shapes(shapes: dict, seed: int, tag: str = "phase1",
                       check: bool = False) -> tuple[list, list]:
    """Kernels 1 and 2 alone at every shape that a train step gives them
    (from `mamba_step_shapes`): kernel 1 as a forward-only call of
    `mamba_fused_scan` under `torch.no_grad()`, kernel 2 as
    `torch.autograd.grad` through it; each the mean of 3 calls after one
    (`ms`, CUDA events, host included) and the device time of its kernels in
    3 more (`kernel_ms`); random inputs made on the card. Kernel 1's lines
    also carry its plan and the resident blocks per SM of its passes
    (`fwd_plan`), kernel 2's its plan (T, nb blocks of Dc channels) and the
    resident blocks per SM of its passes X, A and C (`bwd_plan`). Where
    the profiler records none of a kernel's launches, `kernel_ms` is the
    events time and the line says so (`kernel_ms_by`). With
    `check`, each shape's output is also held to `mamba_fused_scan_ref`'s on
    the same inputs (TOL) and each input's gradient to autograd of it
    (BWD_TOL), per element as `rel_err`, and a miss fails the run after
    every shape is printed; without it the comparisons are phase 1's.
    Returns (forward, backward) records."""
    from mm_unet_tpu_torch.ops.mamba_fused import mamba_fused_scan, mamba_fused_scan_ref

    dev = torch.device("cuda")
    cgen = torch.Generator(device=dev).manual_seed(seed)

    def rn(*s, scale=1.0):
        return torch.randn(*s, generator=cgen, device=dev) * scale

    fwd, bwd, failed = [], [], []
    for (B, D, R, N, W, L, rev, dt), calls in sorted(shapes.items()):
        dtype = getattr(torch, dt)
        xz, w = mamba_inputs(rn, dev, B, D, R, L, N, W)
        x = xz.to(dtype)
        shape = dict(B=B, D=D, R=R, N=N, W=W, L=L, reverse=rev, dtype=dt)
        call = lambda: mamba_fused_scan(x, *w, reverse=rev)  # noqa: E731
        with torch.no_grad():
            ms = cuda_ms(call, reps=3)
            kms = kernel_device_ms(call, FWD_KERNELS)
            if check:
                err, rel, ok = compare(call(), mamba_fused_scan_ref(x, *w, reverse=rev), dtype)
                checked = dict(max_abs_err=err, rel_err=rel, tol=TOL[dtype], ok=ok)
        bms, by = bound(*mamba_work(B, D, L, N, R, W, x.element_size(), False))
        rec = dict(shape, ms=ms, kernel_ms=kms or ms,
                   kernel_ms_by="profiler" if kms else "events",
                   bound_ms=bms, bound_by=by, launches_per_step=calls,
                   **fwd_plan(D, R, N, x.dtype), **(checked if check else {}))
        print(f"{tag} mamba_fused_scan_fwd_step {json.dumps(rec)}", flush=True)
        fwd.append(rec)
        failed += [] if rec.get("ok", True) else [rec]

        dout = rn(B, 1, D, L).to(dtype)
        out, live, got = grads_of(lambda *a: mamba_fused_scan(*a, reverse=rev), [x, *w], dout)
        if check:
            want = grads_of(lambda *a: mamba_fused_scan_ref(*a, reverse=rev), [x, *w], dout)[2]
            errs, ok = compare_grads(got, want, FusedCalls.NAMES, BWD_TOL[dtype])
            checked = dict(max_abs_err=max(e for e, _ in errs.values()),
                           rel_err=max(r for _, r in errs.values()), tol=BWD_TOL[dtype],
                           errs=errs, ok=ok)
            del want
        del got
        call = lambda: torch.autograd.grad(out, live, dout, retain_graph=True)  # noqa: E731
        ms = cuda_ms(call, reps=3)
        kms = kernel_device_ms(call, BWD_KERNELS)
        bms, by = bound(*mamba_work(B, D, L, N, R, W, dout.element_size(), True))
        rec = dict(shape, ms=ms, kernel_ms=kms or ms, kernel_ms_by="profiler" if kms else "events",
                   bound_ms=bms, bound_by=by, launches_per_step=calls,
                   **bwd_plan(D, R, N, x.dtype), **(checked if check else {}))
        print(f"{tag} mamba_fused_scan_bwd_step {json.dumps(rec)}", flush=True)
        bwd.append(rec)
        failed += [] if rec.get("ok", True) else [rec]
        del xz, x, w, dout, out, live
    if failed:
        raise SystemExit(f"{tag} FAILED: {len(failed)} fused-scan step shapes disagree with "
                         "mamba_fused_scan_ref")
    return fwd, bwd


# kernel-name fragments of the tap-conv kernels' launches: the forward, and
# the backward's dfeat part (dtap, its scatter, dy) and dkernel part
TAP_FWD_KERNELS = ("tap_conv_kernel",)
TAP_BWD_GROUPS = {"dfeat": ("tap_dfeat",), "dkernel": ("tap_dkernel",)}


def phase1_tap_step_shapes(shapes: dict, seed: int, tag: str = "phase1",
                           check: bool = False) -> tuple[list, list]:
    """Kernels 3 and 4 alone at every shape that a train step gives them
    (from `tap_step_shapes`): kernel 3 as a forward-only call of `tap_conv`
    under `torch.no_grad()`, kernel 4 as `torch.autograd.grad` through it,
    rows reaching past both edges as in phase 1; each the mean of 3 calls
    after one (`ms`, CUDA events, host included) and the device time of its
    kernels in 3 more (`kernel_ms`; kernel 4's also split into its dfeat and
    dkernel parts). Random inputs made on the card. With `check`, each
    shape's output is also held to `tap_conv_ref`'s on the same inputs (TOL)
    and each input's gradient to autograd of it (BWD_TOL), per element as
    `rel_err`, and a miss fails the run after every shape is printed;
    without it the comparisons are phase 1's. The first shape's lines also
    carry every device operation of one call (`call_ops`: the wrapper's own
    launches beside the kernels'). Returns (forward, backward) records."""
    from mm_unet_tpu_torch.ops.tap_conv import tap_conv, tap_conv_ref

    dev = torch.device("cuda")
    cgen = torch.Generator(device=dev).manual_seed(seed)

    def rn(*s, scale=1.0):
        return torch.randn(*s, generator=cgen, device=dev) * scale

    fwd, bwd, failed = [], [], []
    for i, ((B, H, W, C, F, K, dt), calls) in enumerate(sorted(shapes.items())):
        dtype = getattr(torch, dt)
        rows = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None, None]
        inputs = [rn(B, H, W, C).to(dtype), rows + rn(B, H, W, K, scale=2.0),
                  rn(K, 1, C, F, scale=(K * C) ** -0.5), rn(F, scale=0.1)]
        shifts = [j - K // 2 for j in range(K)]
        shape = dict(B=B, H=H, W=W, C=C, F=F, K=K, dtype=dt)
        call = lambda: tap_conv(*inputs, shifts)  # noqa: E731
        with torch.no_grad():
            ms = cuda_ms(call, reps=3)
            kms = kernel_device_ms(call, TAP_FWD_KERNELS)
            ops = call_device_ops(call) if i == 0 else None
            if check:
                err, rel, ok = compare(call(), tap_conv_ref(*inputs, shifts), dtype)
                checked = dict(max_abs_err=err, rel_err=rel, tol=TOL[dtype], ok=ok)
        bms, by = bound(*tap_work(B, H, W, C, F, K, inputs[0].element_size(), False))
        rec = dict(shape, ms=ms, kernel_ms=kms, bound_ms=bms, bound_by=by, launches_per_step=calls,
                   **(checked if check else {}), **({"call_ops": ops} if ops else {}))
        print(f"{tag} tap_conv_fwd_step {json.dumps(rec)}", flush=True)
        fwd.append(rec)
        failed += [] if rec.get("ok", True) else [rec]

        dout = rn(B, H, W, F).to(dtype)
        out, live, got = grads_of(lambda *a: tap_conv(*a, shifts), inputs, dout)
        if check:
            want = grads_of(lambda *a: tap_conv_ref(*a, shifts), inputs, dout)[2]
            errs, ok = compare_grads(got, want, ["feat", "y", "kernel", "bias"], BWD_TOL[dtype])
            checked = dict(max_abs_err=max(e for e, _ in errs.values()),
                           rel_err=max(r for _, r in errs.values()), tol=BWD_TOL[dtype],
                           errs=errs, ok=ok)
            del want
        del got
        call = lambda: torch.autograd.grad(out, live, dout, retain_graph=True)  # noqa: E731
        ms = cuda_ms(call, reps=3)
        parts = kernel_device_ms_by(call, TAP_BWD_GROUPS)
        ops = call_device_ops(call) if i == 0 else None
        bms, by = bound(*tap_work(B, H, W, C, F, K, dout.element_size(), True))
        rec = dict(shape, ms=ms, kernel_ms=sum(parts.values()), dfeat_kernel_ms=parts["dfeat"],
                   dkernel_kernel_ms=parts["dkernel"], bound_ms=bms, bound_by=by,
                   launches_per_step=calls, **(checked if check else {}),
                   **({"call_ops": ops} if ops else {}))
        print(f"{tag} tap_conv_bwd_step {json.dumps(rec)}", flush=True)
        bwd.append(rec)
        failed += [] if rec.get("ok", True) else [rec]
        del inputs, dout, out, live
    if failed:
        raise SystemExit(f"{tag} FAILED: {len(failed)} tap-conv step shapes disagree with "
                         "tap_conv_ref")
    return fwd, bwd


# kernel-name fragments of the selective scan's launches: the forward's two
# chunk passes and its combine; the backward's three passes, and the
# wrapper's sums of the per-block partials (PyTorch's reductions)
SCAN_FWD_KERNELS = ("scan_fwd_", "scan_combine_kernel")
SCAN_BWD_GROUPS = {"pass_a": ("scan_bwd_local",), "pass_b": ("scan_bwd_combine",),
                   "pass_c": ("scan_bwd_chunk",), "partial_sums": ("reduce_kernel",)}


def phase1_scan_step_shapes(shapes: dict, seed: int) -> tuple[list, list]:
    """Kernels 5 and 6 alone at every shape that a dkDualNet route-b train
    step gives them (from `scan_step_shapes`), every fused flag on and B/C
    the views of one x_dbl as the Mamba passes them: kernel 5 as a
    forward-only call of `selective_scan` under `torch.no_grad()`, kernel 6
    as `torch.autograd.grad` through it; each the mean of 3 calls after one
    (`ms`, CUDA events, host included) and the device time of its kernels in
    3 more (`kernel_ms`; kernel 6's split into passes A, B, C and the
    wrapper's partial sums). Random inputs made on the card. The first
    shape's lines also carry every device operation of one call
    (`call_ops`). Timing only: the comparisons are phase 1's. Returns
    (forward, backward) records."""
    from mm_unet_tpu_torch.ops.selective_scan import selective_scan

    dev = torch.device("cuda")
    cgen = torch.Generator(device=dev).manual_seed(seed)

    def rn(*s, scale=1.0):
        return torch.randn(*s, generator=cgen, device=dev) * scale

    fwd, bwd = [], []
    for i, ((B, Dm, G, N, R, L, dt), calls) in enumerate(sorted(shapes.items())):
        dtype = getattr(torch, dt)
        A = -torch.exp(torch.log(torch.arange(1, N + 1.0, device=dev)).repeat(Dm, 1))
        inputs = [rn(B, Dm, L).to(dtype), rn(B, Dm, L, scale=0.5).to(dtype), A,
                  rn(B, G, R + 2 * N, L).to(dtype), rn(Dm, scale=0.5) + 1.0,
                  rn(B, Dm, L).to(dtype), rn(Dm, scale=0.1) - 4.0]

        def scan(u, delta, A, x_dbl, D, z, bias):
            return selective_scan(u, delta, A, x_dbl[:, :, R:R + N], x_dbl[:, :, R + N:], D=D,
                                  z=z, delta_bias=bias, delta_softplus=True)

        shape = dict(B=B, Dm=Dm, G=G, N=N, L=L, dtype=dt)
        call = lambda: scan(*inputs)  # noqa: E731
        with torch.no_grad():
            ms = cuda_ms(call, reps=3)
            kms = kernel_device_ms(call, SCAN_FWD_KERNELS)
            ops = call_device_ops(call) if i == 0 else None
        es = inputs[0].element_size()
        bms, by = bound(*scan_work(B, Dm, L, N, G, es, es, 3, False))
        rec = dict(shape, ms=ms, kernel_ms=kms, bound_ms=bms, bound_by=by, launches_per_step=calls,
                   **({"call_ops": ops} if ops else {}))
        print(f"phase1 selective_scan_fwd_step {json.dumps(rec)}", flush=True)
        fwd.append(rec)

        dout = rn(B, Dm, L).to(dtype)
        out, live, _ = grads_of(scan, inputs, dout)
        call = lambda: torch.autograd.grad(out, live, dout, retain_graph=True)  # noqa: E731
        ms = cuda_ms(call, reps=3)
        parts = kernel_device_ms_by(call, SCAN_BWD_GROUPS, summed=("partial_sums",))
        ops = call_device_ops(call) if i == 0 else None
        bms, by = bound(*scan_work(B, Dm, L, N, G, es, es, 3, True))
        rec = dict(shape, ms=ms, kernel_ms=sum(parts.values()),
                   **{f"{k}_kernel_ms": v for k, v in parts.items()}, bound_ms=bms, bound_by=by,
                   launches_per_step=calls, **({"call_ops": ops} if ops else {}))
        print(f"phase1 selective_scan_bwd_step {json.dumps(rec)}", flush=True)
        bwd.append(rec)
        del inputs, dout, out, live
    return fwd, bwd


def phase1_scan(gen) -> dict:
    """The chunked selective scan (kernels 5-8 of the TPU package) through
    the `selective_scan` entry point against its plain version on the card:
    dkDualNet's three grouped scans at 512² batch 8 with every fused flag on,
    B/C the views of x_dbl that the Mamba passes, in f32 and bf16; the bare
    scan (no bias, softplus, D or z) with its last state, B/C (B, N, L); a
    constant (D, N) B/C. The forward, and the backward against autograd of
    the plain version, every input's gradient, at every shape."""
    import torch.nn.functional as F

    from mm_unet_tpu_torch.ops.selective_scan import selective_scan, selective_scan_ref

    dev = torch.device("cuda")

    def rn(*s, scale=1.0):
        return (torch.randn(*s, generator=gen) * scale).to(dev)

    results = {"selective_scan": [], "selective_scan_bwd": []}
    failed = []
    B, N = 8, 16
    names = ["u", "delta", "A", "B", "C", "D", "z", "delta_bias"]
    cases = [("fused", dg, 2, L) for dg, L in DK_SCANS] + [("bare", 384, 1, 4096),
                                                         ("const", 384, 1, 4096)]
    for kind, dg, G, L in cases:
        dm, fused = dg * G, kind != "bare"
        R = -(-dg // 32)  # the dkDualNet Mamba's dt_rank: ceil(d_model / 16), d_model = dg / 2
        u, z = rn(B, dm, L), rn(B, dm, L)
        delta = rn(B, dm, L, scale=0.5) if fused else F.softplus(rn(B, dm, L, scale=0.5) - 4.0)
        A = -torch.exp(torch.log(torch.arange(1, N + 1.0, device=dev)).repeat(dm, 1))
        D, bias = rn(dm, scale=0.5) + 1.0, rn(dm, scale=0.1) - 4.0
        x_dbl = rn(B, G, R + 2 * N, L) if kind == "fused" else None
        bc = (rn(dm, N), rn(dm, N)) if kind == "const" else (rn(B, N, L), rn(B, N, L))
        dout = rn(B, dm, L)
        for dtype in ((torch.float32, torch.bfloat16) if kind == "fused" else (torch.float32,)):
            if kind == "fused":
                xd = x_dbl.to(dtype)
                Bm, Cm = xd[:, :, R:R + N], xd[:, :, R + N:]
            elif kind == "bare":
                Bm, Cm = bc[0].to(dtype), bc[1].to(dtype)
            else:
                Bm, Cm = bc
            args = [u.to(dtype), delta.to(dtype), A, Bm, Cm] + (
                [D, z.to(dtype), bias] if fused else [None, None, None])

            def call(fn, *a):
                a = a or args
                res = fn(*a[:5], D=a[5], z=a[6], delta_bias=a[7], delta_softplus=fused,
                         return_last_state=not fused)
                return res if fused else res[0]

            with torch.no_grad():
                got = selective_scan(*args[:5], D=args[5], z=args[6], delta_bias=args[7],
                                     delta_softplus=fused, return_last_state=not fused)
                want = selective_scan_ref(*args[:5], D=args[5], z=args[6], delta_bias=args[7],
                                          delta_softplus=fused, return_last_state=not fused)
                torch.cuda.synchronize()
                got, got_last = (got, None) if fused else got
                want, want_last = (want, None) if fused else want
                err, rel, ok = compare(got, want, dtype)
                last = {}
                if not fused:  # the last state, f32
                    e2, r2, ok2 = compare(got_last, want_last, torch.float32)
                    ok = ok and ok2
                    last = dict(last_state_err=e2, last_state_rel_err=r2)
                ms = cuda_ms(lambda: call(selective_scan), reps=20)
                plain_ms = cuda_ms(lambda: call(selective_scan_ref), reps=1, warmup=0)
            es, bes = args[0].element_size(), Bm.element_size()
            streams = 3 if fused else 2
            g = dm if kind == "const" else G
            shape = dict(kind=kind, G=G, D_per_group=dg, L=L, B=B, dtype=str(dtype)[6:])
            bms, by = bound(*scan_work(B, dm, L, N, g, es, bes, streams, False, kind == "const"))
            rec = dict(shape, max_abs_err=err, rel_err=rel, tol=TOL[dtype], **last, ms=ms,
                       plain_ms=plain_ms, bound_ms=bms, bound_by=by, ok=ok)
            print(f"phase1 selective_scan {json.dumps(rec)}", flush=True)
            results["selective_scan"].append(rec)
            failed += [] if ok else [rec]
            del got, want

            d_out = dout.to(dtype)
            out, live, got_g = grads_of(lambda *a: call(selective_scan, *a), args, d_out)
            torch.cuda.synchronize()
            ms = cuda_ms(lambda: torch.autograd.grad(out, live, d_out, retain_graph=True), reps=10)
            bms, by = bound(*scan_work(B, dm, L, N, g, es, bes, streams, True, kind == "const"))
            outp, livep, want_g = grads_of(lambda *a: call(selective_scan_ref, *a), args, d_out)
            torch.cuda.synchronize()
            live_names = [nm for nm, t in zip(names, args) if t is not None]
            errs, ok = compare_grads(got_g, want_g, live_names, TOL[dtype])
            plain_ms = cuda_ms(lambda: torch.autograd.grad(outp, livep, d_out, retain_graph=True),
                               reps=1, warmup=0)
            rec = dict(shape, max_abs_err=max(e for e, _ in errs.values()),
                       rel_err=max(r for _, r in errs.values()), tol=TOL[dtype], errs=errs,
                       ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, ok=ok)
            failed += [] if ok else [rec]
            del outp, livep, want_g
            print(f"phase1 selective_scan_bwd {json.dumps(rec)}", flush=True)
            results["selective_scan_bwd"].append(rec)
            del out, live, got_g
    if failed:
        raise SystemExit(f"phase1 FAILED: {len(failed)} selective-scan comparisons out of tolerance")
    return results


def phase2_model(seed: int) -> None:
    from mm_unet_tpu_torch.models import give_model

    cpu_model = give_model("MM_Net", device="cpu", generator=torch.Generator().manual_seed(seed),
                           mamba_dtype=None)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal((1, 3, 128, 128),
                                                                      np.float32))
    t0 = time.perf_counter()
    with torch.inference_mode():
        got = gpu_model(x.cuda())
        torch.cuda.synchronize()
        t_gpu = time.perf_counter() - t0
        want = cpu_model(x)
    t_cpu = time.perf_counter() - t0 - t_gpu
    err = (got.cpu() - want).abs().max().item()
    scale = 1.0 + want.abs().max().item()
    ok = bool(torch.isfinite(got).all()) and err <= MODEL_TOL * scale
    print("phase2 " + json.dumps(dict(shape=list(got.shape), max_abs_err=err,
                                      tol=MODEL_TOL * scale, gpu_s=t_gpu, cpu_s=t_cpu, ok=ok)),
          flush=True)
    if not ok:
        raise SystemExit("phase2 FAILED: kernel model disagrees with the plain model")


def phase2_gradients(seed: int) -> None:
    """Every parameter gradient of one train-mode forward and backward, the
    kernels on the card against the plain versions on the CPU (whose scan
    walks tokens one by one, hence the small depth and input), relative to
    1 + the largest gradient of the CPU (GRAD_TOL); and every tap-conv and
    fused-scan call of the card's pass held to its plain version at its own
    inputs and output gradient (`TapCalls`, `FusedCalls`; TOL, BWD_TOL),
    where one wrong call fails however small the gradients it reaches (the
    RCG Mambas' are, which the model-level check cannot see). The lines are
    printed before a failure ends the run."""
    from mm_unet_tpu_torch.models import give_model
    from mm_unet_tpu_torch.train.losses import dice_focal_loss

    cpu_model = give_model("MM_Net", device="cpu", generator=torch.Generator().manual_seed(seed),
                           mamba_dtype=None, depths=(1, 1, 1, 1), num_slices_list=(4, 4, 4, 4),
                           remat=False, sideout_drop=0.0).train()
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    rng = np.random.default_rng(seed + 1)
    x = torch.from_numpy(rng.standard_normal((2, 3, 64, 64)).astype(np.float32))
    y = torch.from_numpy((rng.random((2, 1, 64, 64)) < 0.2).astype(np.float32))
    t0 = time.perf_counter()
    with TapCalls() as calls, FusedCalls() as fused:
        dice_focal_loss(gpu_model(x.cuda()), y.cuda()).backward()
        torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    dice_focal_loss(cpu_model(x), y).backward()
    t_cpu = time.perf_counter() - t0 - t_gpu
    want = {k: p.grad for k, p in cpu_model.named_parameters()}
    bad, worst = grad_errs({k: p.grad for k, p in gpu_model.named_parameters()}, want)
    ok = bad == 0
    print("phase2 gradients " + json.dumps(dict(
        params=len(want), out_of_tol=bad, tol_relative=GRAD_TOL, worst=worst,
        gpu_s=t_gpu, cpu_s=t_cpu, ok=ok)), flush=True)
    tap_ok = calls.check("phase2 f32 tap-conv calls")
    fused_ok = fused.check("phase2 f32 fused-scan calls")
    if not (ok and tap_ok and fused_ok):
        raise SystemExit("phase2 FAILED: f32 card gradients disagree with the plain model's "
                         f"(model {ok}, tap-conv calls {tap_ok}, fused-scan calls {fused_ok})")


def phase2_bf16_gradients(seed: int) -> None:
    """Every parameter gradient of MM_Net with full-width channels, depths
    (1,1,1,1) and the bf16 feature path (the tap-conv's tensor-core path) in
    train mode, the kernels on the card against the plain versions on the
    CPU, both bf16: each relative to its own tensor (floored at
    BF16_GRAD_FLOOR of the model's largest gradient), the biases and norms
    that feed a train-mode BatchNorm held to zero, and the whole gradient
    vector's relative norm. The card samples at the CPU's rows (`RowPins`:
    the two devices' bf16 offsets differ by rounding, and a row that crosses
    an integer moves its offset path's gradients by far more). bf16 noise
    leaves a model-level comparison coarse (module comment at
    BF16_GRAD_TOL), so each tap-conv call and each fused-scan call of the
    card's passes is also held to its plain version at its own inputs
    (`TapCalls`, `FusedCalls`), where a single wrong output or gradient
    fails. An unpinned card pass, and the pinned one without
    the floor, are reported beside the check and gate nothing but their
    calls. The lines are printed before a failure ends the run."""
    from mm_unet_tpu_torch.models import give_model
    from mm_unet_tpu_torch.train.losses import dice_focal_loss

    cpu_model = give_model("MM_Net", device="cpu", generator=torch.Generator().manual_seed(seed),
                           mamba_dtype="bfloat16", depths=(1, 1, 1, 1),
                           num_slices_list=(4, 4, 4, 4), remat=False, sideout_drop=0.0).train()
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    rng = np.random.default_rng(seed + 1)
    x = torch.from_numpy(rng.standard_normal((2, 3, 64, 64)).astype(np.float32))
    y = torch.from_numpy((rng.random((2, 1, 64, 64)) < 0.2).astype(np.float32))
    cpu_pins, gpu_pins = RowPins(cpu_model), RowPins(gpu_model)
    cpu_pins.record()
    t0 = time.perf_counter()
    dice_focal_loss(cpu_model(x), y).backward()
    t_cpu = time.perf_counter() - t0
    cpu_pins.release()
    want = {k: p.grad for k, p in cpu_model.named_parameters()}
    zero = bn_fed_biases(cpu_model)
    grads, calls_ok = {}, True
    for pinned in (True, False):
        gpu_model.zero_grad(set_to_none=True)
        if pinned:
            gpu_pins.pin(cpu_pins.rows)
        t0 = time.perf_counter()
        with TapCalls() as calls, FusedCalls() as fused:
            dice_focal_loss(gpu_model(x.cuda()), y.cuda()).backward()
            torch.cuda.synchronize()
        t_gpu = time.perf_counter() - t0
        gpu_pins.release()
        grads[pinned] = {k: p.grad.detach().clone() for k, p in gpu_model.named_parameters()}
        kind = "pinned" if pinned else "unpinned"
        calls_ok = calls.check(f"phase2 bf16 tap-conv calls {kind}") and calls_ok
        calls_ok = fused.check(f"phase2 bf16 fused-scan calls {kind}") and calls_ok
        del calls, fused
    bad, worst = tensor_grad_errs(grads[True], want, BF16_GRAD_TOL, zero, BF16_GRAD_FLOOR)
    n_free, worst_free = tensor_grad_errs(grads[False], want, BF16_GRAD_TOL, zero,
                                          BF16_GRAD_FLOOR)
    n_bare, worst_bare = tensor_grad_errs(grads[True], want, BF16_GRAD_TOL, zero)
    live = [k for k in want if k not in zero]
    norm_rel = math.sqrt(
        sum((grads[True][k].float().cpu() - want[k].float()).square().sum().item() for k in live)
        / sum(want[k].float().square().sum().item() for k in live))
    print("phase2 bf16 gradients " + json.dumps(dict(
        params=len(want), out_of_tol=bad, tol_relative=BF16_GRAD_TOL,
        floor_of_largest=BF16_GRAD_FLOOR, worst=worst,
        norm_rel_err=norm_rel, norm_tol=BF16_GRAD_NORM_TOL,
        sample_rows_max_abs_err=gpu_pins.err,
        unpinned=dict(grads_out_of_tol=n_free, worst=worst_free[:2]),
        unfloored=dict(grads_out_of_tol=n_bare, worst=worst_bare[:2]),
        gpu_s=t_gpu, cpu_s=t_cpu, ok=bad == 0 and norm_rel <= BF16_GRAD_NORM_TOL)), flush=True)
    if bad or norm_rel > BF16_GRAD_NORM_TOL or not calls_ok:
        raise SystemExit("phase2 FAILED: bf16 card gradients disagree with the plain model's")


def phase3_serving(seed: int, profile: bool = False) -> dict:
    from mm_unet_tpu_torch.data import synthetic_batch
    from mm_unet_tpu_torch.evaluate import val_one_epoch
    from mm_unet_tpu_torch.models import give_model
    from mm_unet_tpu_torch.ops.mamba_fused import mamba_fused_scan
    from mm_unet_tpu_torch.ops.tap_conv import tap_conv
    from mm_unet_tpu_torch.train.inferers import SlidingWindowInferer
    from mm_unet_tpu_torch.train.metrics import build_metrics
    from mm_unet_tpu_torch.train.predictor import make_predictor
    from mm_unet_tpu_torch.train.trainer import make_loss_fn

    model = give_model("MM_Net", device="cuda", generator=torch.Generator().manual_seed(seed))
    per_forward = model.kernel_launches_per_forward()
    batches = [synthetic_batch(8, 512, seed), synthetic_batch(1, 704, seed + 1)]
    inferer = SlidingWindowInferer(roi_size=(512, 512), overlap=0.5)
    loss_fn = make_loss_fn({"dice_focal_loss": {}}, {"dice_focal_loss": 1.0})
    logits = []

    def infer(images, predictor):
        out = inferer(images, predictor)
        logits.append(out)
        return out

    # 512² batch 8: 8 windows in one group; 704²: 4 windows in one group
    forwards = 2
    mamba_fused_scan.launches = tap_conv.launches = 0
    t0 = time.perf_counter()
    f1, metric, losses = val_one_epoch(model, loss_fn, infer, batches, build_metrics())
    torch.cuda.synchronize()
    t_val = time.perf_counter() - t0
    launches = {"mamba_fused_scan": mamba_fused_scan.launches, "tap_conv": tap_conv.launches}
    expect = {k: v * forwards for k, v in per_forward.items()}
    shapes = [list(x.shape) for x in logits]
    finite = all(bool(torch.isfinite(x).all()) for x in logits)
    ok = (finite and launches == expect and shapes == [[8, 1, 512, 512], [1, 1, 704, 704]]
          and all(np.isfinite(losses)))
    print("phase3 val " + json.dumps(dict(
        logits=shapes, finite=finite, losses=losses, launches=launches, expected=expect,
        metrics={k: (v if v == v else None) for k, v in metric.items()}, seconds=t_val,
        ok=ok)), flush=True)
    if not ok:
        raise SystemExit("phase3 FAILED: serving path")

    x = torch.from_numpy(batches[0]["image"]).cuda()
    rates = serving_rates(model, inferer, x)
    print("phase3 throughput " + json.dumps(dict(
        roi=512, batch=8, overlap=0.5, images_per_sec_f32_predictor=rates["f32"],
        images_per_sec_bf16_predictor=rates["bf16"], card=smi())), flush=True)
    if profile:
        predictor = make_predictor(model, torch.bfloat16)
        profile_step("serve", lambda: inferer(x, predictor))
    return launches


def phase4_training(seed: int, profile: bool = False) -> tuple[dict, dict]:
    """Train steps of the full-width bf16 MM_Net at 512² batch 8. Returns
    each kernel's launches over the run (forward and backward), the fused
    scans' shapes in one step (`mamba_step_shapes`) and the tap-conv's
    (`tap_step_shapes`)."""
    from mm_unet_tpu_torch.data import synthetic_batch
    from mm_unet_tpu_torch.models import give_model
    from mm_unet_tpu_torch.ops.mamba_fused import mamba_fused_scan
    from mm_unet_tpu_torch.ops.tap_conv import tap_conv
    from mm_unet_tpu_torch.train.trainer import create_train_state, make_loss_fn, train_step

    model = give_model("MM_Net", device="cuda", generator=torch.Generator().manual_seed(seed),
                       remat=False)
    batch = synthetic_batch(8, 512, seed + 2)
    x, y = torch.from_numpy(batch["image"]).cuda(), torch.from_numpy(batch["label"]).cuda()
    # lr 1e-3 held constant: warmup 1 epoch of a million steps
    config = {"trainer": dict(lr=1e-3, warmup=1, num_epochs=2, steps_per_epoch=10**6,
                              weight_decay=0.05, optimizer="adamw")}
    state = create_train_state(model, config, seed=seed)
    loss_fn = make_loss_fn({"dice_focal_loss": {}}, {"dice_focal_loss": 1.0})
    counters = ((mamba_fused_scan, "mamba_fused_scan"), (tap_conv, "tap_conv"))

    def step():
        for fn, _ in counters:
            fn.launches = fn.bwd_launches = 0
        t0 = time.perf_counter()
        scalars, _ = train_step(state, x, y, loss_fn)
        loss = float(scalars["total_loss"])  # waits for the step
        dt = time.perf_counter() - t0
        got = {name: {"fwd": fn.launches, "bwd": fn.bwd_launches} for fn, name in counters}
        return loss, dt, got

    totals = {"mamba_fused_scan": 0, "mamba_fused_scan_bwd": 0, "tap_conv": 0, "tap_conv_bwd": 0}
    expect = model.kernel_launches_per_train_step()
    torch.cuda.reset_peak_memory_stats()
    losses, times, counts_ok = [], [], True
    shapes, hooks = mamba_step_shapes(model)
    tap_shapes, tap_hooks = tap_step_shapes(model)
    for i in range(TRAIN_STEPS):
        loss, dt, got = step()
        if i == 0:  # the shapes of one step
            for h in hooks + tap_hooks:
                h.remove()
        losses.append(loss)
        times.append(dt)
        counts_ok = counts_ok and got == expect
        for name, c in got.items():
            totals[name] += c["fwd"]
            totals[name + "_bwd"] += c["bwd"]
    peak = torch.cuda.max_memory_allocated()
    rate = x.shape[0] * (TRAIN_STEPS - 1) / sum(times[1:])  # the first step warms up
    model.remat = True
    loss_r, dt_r, got_r = step()
    expect_r = model.kernel_launches_per_train_step()
    shapes_ok = (sum(shapes.values()) == expect["mamba_fused_scan"]["bwd"]
                 and sum(tap_shapes.values()) == expect["tap_conv"]["bwd"])
    ok = (all(np.isfinite(losses)) and np.isfinite(loss_r) and losses[-1] < losses[0]
          and counts_ok and got_r == expect_r and state.step == TRAIN_STEPS + 1 and shapes_ok)
    print("phase4 train " + json.dumps(dict(
        batch=8, size=512, dtype="bfloat16", losses=losses, launches_per_step=expect,
        mamba_shapes=len(shapes), tap_conv_shapes=len(tap_shapes),
        shapes_cover_launches=shapes_ok,
        counts_ok=counts_ok, remat_step=dict(loss=loss_r, seconds=dt_r, launches=got_r,
                                             expected=expect_r),
        step_seconds=times, train_images_per_sec=rate, max_memory_allocated_bytes=peak,
        card=smi(), ok=ok)), flush=True)
    if not ok:
        raise SystemExit("phase4 FAILED: training path")
    if profile:
        model.remat = False
        profile_step("train", lambda: train_step(state, x, y, loss_fn))
    return totals, shapes, tap_shapes


def phase5_dkdualnet(seed: int) -> None:
    """dkDualNet at full width (dims 48/96/192/384, depths 2/2/2/2), f32, the
    same weights on both of its Mambas' routes: route a (the megakernels,
    kernels 1/2) against route b (the grouped selective scan, kernels 5/6),
    eval logits at 8x3x512², then one train-mode forward and backward
    (drop_path_rate 0) with every parameter gradient; then route b on the
    card against the plain model on the CPU for full-width channels with
    depths (1,1,1,1) at 2x3x64², every parameter gradient. Both are printed
    before either failure ends the run."""
    from mm_unet_tpu_torch.data import synthetic_batch
    from mm_unet_tpu_torch.models import give_model
    from mm_unet_tpu_torch.train.losses import dice_focal_loss

    model = give_model("dkDualNet", device="cuda", generator=torch.Generator().manual_seed(seed),
                       drop_path_rate=0.0)
    batch = synthetic_batch(8, 512, seed + 3)
    x, y = torch.from_numpy(batch["image"]).cuda(), torch.from_numpy(batch["label"]).cuda()
    routes = (("a", None), ("b", "pallas"))
    logits, grads, secs = {}, {}, {}
    for route, impl in routes:  # eval first: a train pass moves the running statistics
        model.scan_impl = impl
        with torch.inference_mode():
            logits[route] = model.eval()(x)
    for route, impl in routes:
        model.scan_impl = impl
        model.train().zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        dice_focal_loss(model(x), y).backward()
        torch.cuda.synchronize()
        secs[route] = time.perf_counter() - t0
        grads[route] = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    err, rel = rel_err(logits["b"], logits["a"])
    bad, worst = tensor_grad_errs(grads["b"], grads["a"], ROUTE_TOL, bn_fed_biases(model))
    routes_ok = bool(torch.isfinite(logits["b"]).all()) and rel <= ROUTE_TOL and bad == 0
    print("phase5 routes " + json.dumps(dict(
        shape=list(logits["a"].shape), logits_max_abs_err=err, logits_rel_err=rel,
        params=len(grads["a"]), grads_out_of_tol=bad, tol_relative=ROUTE_TOL, worst=worst,
        train_pass_seconds=secs, ok=routes_ok)), flush=True)
    del model, logits, grads

    cpu_model = give_model("dkDualNet", device="cpu", generator=torch.Generator().manual_seed(seed),
                           depths=(1, 1, 1, 1), drop_path_rate=0.0, scan_impl="pallas").train()
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    rng = np.random.default_rng(seed + 1)
    x = torch.from_numpy(rng.standard_normal((2, 3, 64, 64)).astype(np.float32))
    y = torch.from_numpy((rng.random((2, 1, 64, 64)) < 0.2).astype(np.float32))
    t0 = time.perf_counter()
    dice_focal_loss(gpu_model(x.cuda()), y.cuda()).backward()
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    dice_focal_loss(cpu_model(x), y).backward()
    t_cpu = time.perf_counter() - t0 - t_gpu
    bad, worst = tensor_grad_errs({k: p.grad for k, p in gpu_model.named_parameters()},
                                  {k: p.grad for k, p in cpu_model.named_parameters()},
                                  DK_CPU_TOL, bn_fed_biases(cpu_model))
    print("phase5 gradients " + json.dumps(dict(
        params=sum(1 for _ in cpu_model.parameters()), out_of_tol=bad,
        tol_relative=DK_CPU_TOL, worst=worst, gpu_s=t_gpu, cpu_s=t_cpu, ok=bad == 0)),
        flush=True)
    if not routes_ok:
        raise SystemExit("phase5 FAILED: dkDualNet's two routes disagree")
    if bad:
        raise SystemExit("phase5 FAILED: dkDualNet's card gradients disagree with the plain model's")


def phase6_dkdualnet_path(seed: int, profile: bool = False) -> dict:
    """dkDualNet's path on route b (the grouped selective scan), each part
    with exact launch counts: the serving path (`val_one_epoch` over 512²
    sliding windows, overlap 0.5, two synthetic batches of 8; then images/s
    for the f32 and the bf16 predictor) and the training path (six
    `train_step`s, DiceFocal, AdamW lr 1e-3, 512² batch 8, f32: finite and
    falling losses, train images/s, peak memory). Then blocks of three train
    steps on route a, route a and route b, after the checked route-b steps,
    so that the two routes' rates are read in turns on one card. Returns the
    launches of each kernel on each path and the selective scan's shapes in
    one train step (`scan_step_shapes`)."""
    from mm_unet_tpu_torch.data import synthetic_batch
    from mm_unet_tpu_torch.evaluate import val_one_epoch
    from mm_unet_tpu_torch.models import give_model
    from mm_unet_tpu_torch.ops.chunked_scan import selective_scan_chunked
    from mm_unet_tpu_torch.ops.mamba_fused import mamba_fused_scan
    from mm_unet_tpu_torch.train.inferers import SlidingWindowInferer
    from mm_unet_tpu_torch.train.metrics import build_metrics
    from mm_unet_tpu_torch.train.trainer import create_train_state, make_loss_fn, train_step

    counters = ((selective_scan_chunked, "selective_scan"), (mamba_fused_scan, "mamba_fused_scan"))

    def reset():
        for fn, _ in counters:
            fn.launches = fn.bwd_launches = 0

    def read():
        return {name: {"fwd": fn.launches, "bwd": fn.bwd_launches} for fn, name in counters}

    def expected(per_step: dict, times: int = 1) -> dict:
        out = {name: {"fwd": 0, "bwd": 0} for _, name in counters}
        for name, c in per_step.items():
            out[name] = {k: v * times for k, v in c.items()}
        return out

    model = give_model("dkDualNet", device="cuda", generator=torch.Generator().manual_seed(seed),
                       scan_impl="pallas")
    per_forward = {k: {"fwd": v, "bwd": 0} for k, v in model.kernel_launches_per_forward().items()}
    batches = [synthetic_batch(8, 512, seed + 4), synthetic_batch(8, 512, seed + 5)]
    inferer = SlidingWindowInferer(roi_size=(512, 512), overlap=0.5)
    loss_fn = make_loss_fn({"dice_focal_loss": {}}, {"dice_focal_loss": 1.0})
    logits = []

    def infer(images, predictor):
        out = inferer(images, predictor)
        logits.append(out)
        return out

    reset()
    t0 = time.perf_counter()
    f1, metric, losses = val_one_epoch(model, loss_fn, infer, batches, build_metrics())
    torch.cuda.synchronize()
    t_val = time.perf_counter() - t0
    got = read()
    want = expected(per_forward, len(batches))  # one forward per batch of eight windows
    finite = all(bool(torch.isfinite(x).all()) for x in logits)
    shapes = [list(x.shape) for x in logits]
    ok = finite and got == want and shapes == [[8, 1, 512, 512]] * 2 and all(np.isfinite(losses))
    print("phase6 val " + json.dumps(dict(
        route="b", logits=shapes, finite=finite, losses=losses, launches=got, expected=want,
        metrics={k: (v if v == v else None) for k, v in metric.items()}, seconds=t_val,
        ok=ok)), flush=True)
    if not ok:
        raise SystemExit("phase6 FAILED: dkDualNet serving path")
    serve = {"selective_scan": got["selective_scan"]["fwd"], "selective_scan_bwd": 0}

    x = torch.from_numpy(batches[0]["image"]).cuda()
    reset()
    rates = serving_rates(model, inferer, x)
    if read() != expected(per_forward, SERVING_PASSES):
        raise SystemExit(f"phase6 FAILED: serving launches {read()}")
    print("phase6 throughput " + json.dumps(dict(
        route="b", roi=512, batch=8, overlap=0.5, images_per_sec_f32_predictor=rates["f32"],
        images_per_sec_bf16_predictor=rates["bf16"], card=smi())), flush=True)

    batch = synthetic_batch(8, 512, seed + 2)
    x, y = torch.from_numpy(batch["image"]).cuda(), torch.from_numpy(batch["label"]).cuda()
    config = {"trainer": dict(lr=1e-3, warmup=1, num_epochs=2, steps_per_epoch=10**6,
                              weight_decay=0.05, optimizer="adamw")}
    state = create_train_state(model, config, seed=seed)

    def steps(n):
        losses, times, counts_ok = [], [], True
        want = expected(model.kernel_launches_per_train_step())
        for _ in range(n):
            reset()
            t0 = time.perf_counter()
            scalars, _ = train_step(state, x, y, loss_fn)
            losses.append(float(scalars["total_loss"]))  # waits for the step
            times.append(time.perf_counter() - t0)
            counts_ok = counts_ok and read() == want
        return losses, times, counts_ok

    torch.cuda.reset_peak_memory_stats()
    reset()
    train_counts = {"selective_scan": 0, "selective_scan_bwd": 0}
    losses, times, counts_ok = [], [], True
    scan_shapes, hooks = scan_step_shapes(model)
    for i in range(TRAIN_STEPS):
        lo, ti, ok1 = steps(1)
        if i == 0:  # the shapes of one step
            for h in hooks:
                h.remove()
        losses += lo
        times += ti
        counts_ok = counts_ok and ok1
        train_counts["selective_scan"] += selective_scan_chunked.launches
        train_counts["selective_scan_bwd"] += selective_scan_chunked.bwd_launches
    peak = torch.cuda.max_memory_allocated()
    rate = x.shape[0] * (TRAIN_STEPS - 1) / sum(times[1:])  # the first step warms up
    blocks = []
    for route, impl in (("a", None), ("a", None), ("b", "pallas")):
        model.scan_impl = impl
        lo, ti, ok1 = steps(3)
        counts_ok = counts_ok and ok1
        blocks.append(dict(route=route, losses=lo, step_seconds=ti,
                           train_images_per_sec=x.shape[0] * len(ti) / sum(ti)))
    shapes_ok = (sum(scan_shapes.values())
                 == model.kernel_launches_per_train_step()["selective_scan"]["bwd"])
    ok = (all(np.isfinite(losses)) and losses[-1] < losses[0] and counts_ok and shapes_ok
          and all(np.isfinite(b["losses"]).all() for b in blocks))
    print("phase6 train " + json.dumps(dict(
        route="b", batch=8, size=512, dtype="float32", losses=losses,
        launches_per_step=model.kernel_launches_per_train_step(), counts_ok=counts_ok,
        scan_shapes=len(scan_shapes), shapes_cover_launches=shapes_ok,
        step_seconds=times, train_images_per_sec=rate, max_memory_allocated_bytes=peak,
        route_blocks_after=blocks, card=smi(), ok=ok)), flush=True)
    if not ok:
        raise SystemExit("phase6 FAILED: dkDualNet training path")
    if profile:
        for route, impl in (("b", "pallas"), ("a", None)):
            model.scan_impl = impl
            profile_step(f"dkdualnet train (route {route})",
                         lambda: train_step(state, x, y, loss_fn))
    return {"serve": serve, "train": train_counts}, scan_shapes


def mamba_routes_check(tag: str, model, x, y, logits_tol: float, tol: float,
                       extra: dict) -> bool:
    """`model` (on the card, f32, dropout off) on both routes of its Mambas,
    the same weights: route a, the megakernels (kernels 1/2), against route
    b, the grouped selective scan (kernels 5/6, `scan_impl="pallas"` on every
    Mamba). Eval logits, per element as `rel_err` within `logits_tol`, then
    every parameter gradient of one train-mode forward and backward
    (DiceFocal), each relative to its own tensor within `tol`, with each
    route's kernel launches (one forward and one backward per call).

    The gradient of a deformable conv's row sampling w.r.t. its rows jumps
    where floor() of a row crosses an integer, so a row within rounding of
    one (which the two routes' Mamba outputs, equal to ~1e-7, can put on
    either side) moves its offset path's gradients by far more than the
    routes differ. So the train passes after route a's first sample at its
    rows (`RowPins`), and the line reports the rows' largest difference.
    Two more passes are reported beside the check and gate nothing: route a
    again (the run-to-run spread of the card's sums) and route b unpinned.
    Prints the line; returns whether the check passed."""
    from mm_unet_tpu_torch.models.mamba import Mamba
    from mm_unet_tpu_torch.ops.chunked_scan import selective_scan_chunked
    from mm_unet_tpu_torch.ops.mamba_fused import mamba_fused_scan
    from mm_unet_tpu_torch.train.losses import dice_focal_loss

    mambas = [m for m in model.modules() if isinstance(m, Mamba)]
    counters = {"mamba_fused_scan": mamba_fused_scan, "selective_scan": selective_scan_chunked}
    pins = RowPins(model)

    def set_route(impl):
        for m in mambas:
            m.scan_impl = impl

    logits, grads, launches = {}, {}, {}
    for route, impl in (("a", None), ("b", "pallas")):  # eval first: a train pass moves
        set_route(impl)                                 # the running statistics
        with torch.inference_mode():
            logits[route] = model.eval()(x)
    launches_ok = True
    for route, impl, pin in (("a", None, "record"), ("a again", None, "pin"),
                             ("b", "pallas", "pin"), ("b unpinned", "pallas", None)):
        set_route(impl)
        want = {name: 0 for name in counters}
        for m in mambas:
            for name, n in m.kernel_launches_per_forward().items():
                want[name] += n
        for fn in counters.values():
            fn.launches = fn.bwd_launches = 0
        if pin == "record":
            pins.record()
        elif pin == "pin":
            pins.pin(pins.rows)
        model.train().zero_grad(set_to_none=True)
        dice_focal_loss(model(x), y).backward()
        torch.cuda.synchronize()
        pins.release()
        grads[route] = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
        # the route's own kernels, one forward and one backward launch per call
        launches[route] = {name: [fn.launches, fn.bwd_launches] for name, fn in counters.items()}
        launches_ok = launches_ok and all(launches[route][name] == [n, n]
                                          for name, n in want.items())
    set_route(None)
    err, rel = rel_err(logits["b"], logits["a"])
    zero = bn_fed_biases(model)
    bad, worst = tensor_grad_errs(grads["b"], grads["a"], tol, zero)
    beside = {}
    for route in ("a again", "b unpinned"):
        n_out, w = tensor_grad_errs(grads[route], grads["a"], tol, zero)
        beside[route] = dict(grads_out_of_tol=n_out, worst=w[:2])
    ok = (bool(torch.isfinite(logits["a"]).all()) and bool(torch.isfinite(logits["b"]).all())
          and rel <= logits_tol and bad == 0 and launches_ok)
    print(f"{tag} " + json.dumps(dict(
        shape=list(logits["a"].shape), **extra, logits_max_abs_err=err,
        logits_rel_err=rel, logits_tol=logits_tol, sample_rows_max_abs_err=pins.err,
        params=len(grads["a"]), grads_out_of_tol=bad, tol_relative=tol, worst=worst,
        beside=beside, launches=launches, launches_ok=launches_ok, ok=ok)), flush=True)
    return ok


def phase7_mm_routes(seed: int) -> None:
    """MM_Net with full-width channels and depths (1,1,1,1), f32
    (`mamba_dtype=None`), remat and side-output dropout off, at 2x3x512²,
    through `mamba_routes_check`: its Mambas (all of d_state 16) at
    MM_Net's own shapes (D = 128, 6 and 2)."""
    from mm_unet_tpu_torch.data import synthetic_batch
    from mm_unet_tpu_torch.models import give_model

    model = give_model("MM_Net", device="cuda", generator=torch.Generator().manual_seed(seed),
                       mamba_dtype=None, depths=(1, 1, 1, 1), remat=False, sideout_drop=0.0)
    batch = synthetic_batch(2, 512, seed + 6)
    x, y = torch.from_numpy(batch["image"]).cuda(), torch.from_numpy(batch["label"]).cuda()
    if not mamba_routes_check("phase7 mm_net routes", model, x, y, MM_ROUTE_LOGITS_TOL,
                              MM_ROUTE_TOL, dict(depths=[1, 1, 1, 1])):
        raise SystemExit("phase7 FAILED: MM_Net's two Mamba routes disagree")


def make_um_net(seed: int, device: str = "cuda"):
    from mm_unet_tpu_torch.models import give_model

    return give_model("UM_Net", device=device, generator=torch.Generator().manual_seed(seed))


def phase8_um_card_vs_cpu(seed: int) -> None:
    """The full-width UM_Net (f32, seeded init) at 1x3x128² in eval mode,
    kernels on the card against the plain versions on the CPU, the same
    weights; the logits per element as `rel_err`. Then one train-mode pass
    on the card (DiceFocal, backward) with each of its 16 tap-conv calls
    held to the plain version at its own inputs (`TapCalls`): kernels 3 and
    4 at 9 taps on UM_Net's data."""
    from mm_unet_tpu_torch.train.losses import dice_focal_loss

    cpu_model = make_um_net(seed, "cpu")
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    x = torch.from_numpy(np.random.default_rng(seed + 7).standard_normal((1, 3, 128, 128),
                                                                         np.float32))
    t0 = time.perf_counter()
    with torch.inference_mode():
        got = gpu_model(x.cuda()).cpu()
        t_gpu = time.perf_counter() - t0
        want = cpu_model(x)
    t_cpu = time.perf_counter() - t0 - t_gpu
    err, rel = rel_err(got, want)
    ok = bool(torch.isfinite(got).all()) and rel <= UM_MODEL_TOL
    print("phase8 um_net card vs cpu " + json.dumps(dict(
        shape=list(got.shape), max_abs_err=err, rel_err=rel, tol=UM_MODEL_TOL, gpu_s=t_gpu,
        cpu_s=t_cpu, ok=ok)), flush=True)
    y = (torch.rand((1, 1, 128, 128), generator=torch.Generator().manual_seed(seed + 7))
         < 0.2).float()
    with TapCalls() as calls:
        dice_focal_loss(gpu_model.train()(x.cuda()), y.cuda()).backward()
        torch.cuda.synchronize()
    calls_ok = calls.check("phase8 um_net tap-conv calls")
    if not (ok and calls_ok):
        raise SystemExit("phase8 FAILED: UM_Net on the card disagrees with the plain model")


def phase8_um_routes(seed: int) -> None:
    """The full-width UM_Net, f32, dropout off (p = 0 at its two sites, so
    that both routes' train passes draw nothing), at 2x3x512², through
    `mamba_routes_check`: its three RCG Mambas (d_model 64, one direction)
    at D = 128, L = 4,096, 16,384 and 65,536."""
    from mm_unet_tpu_torch.data import synthetic_batch
    from mm_unet_tpu_torch.models.layers import Dropout2d

    model = make_um_net(seed)
    for m in model.modules():
        if isinstance(m, Dropout2d):
            m.p = 0.0
    batch = synthetic_batch(2, 512, seed + 8)
    x, y = torch.from_numpy(batch["image"]).cuda(), torch.from_numpy(batch["label"]).cuda()
    if not mamba_routes_check("phase8 um_net routes", model, x, y, UM_ROUTE_LOGITS_TOL,
                              UM_ROUTE_TOL, {}):
        raise SystemExit("phase8 FAILED: UM_Net's two Mamba routes disagree")


def phase8_um_path(seed: int, profile: bool = False) -> tuple[dict, dict, dict, dict]:
    """UM_Net's serving and training paths on the card (route a), each with
    exact launch counts: `val_one_epoch` over 512² sliding windows (overlap
    0.5, two synthetic batches of 8, f32 predictor: one forward per batch),
    then the f32 predictor's images/s; six `train_step`s at 512² batch 8,
    f32, DiceFocal, AdamW lr 1e-3 (finite losses, the last below the first,
    train images/s, peak memory), with forward hooks during the first step
    that read the shapes kernels 1-4 are given and must cover the step's
    launches. Returns (launches per forward and per train step, the
    launches of each kernel on each path, the fused scans' step shapes, the
    tap-conv's step shapes)."""
    from mm_unet_tpu_torch.data import synthetic_batch
    from mm_unet_tpu_torch.evaluate import val_one_epoch
    from mm_unet_tpu_torch.ops.mamba_fused import mamba_fused_scan
    from mm_unet_tpu_torch.ops.tap_conv import tap_conv
    from mm_unet_tpu_torch.train.inferers import SlidingWindowInferer
    from mm_unet_tpu_torch.train.metrics import build_metrics
    from mm_unet_tpu_torch.train.predictor import make_predictor
    from mm_unet_tpu_torch.train.trainer import create_train_state, make_loss_fn, train_step

    counters = ((mamba_fused_scan, "mamba_fused_scan"), (tap_conv, "tap_conv"))

    def reset():
        for fn, _ in counters:
            fn.launches = fn.bwd_launches = 0

    def read():
        return {name: {"fwd": fn.launches, "bwd": fn.bwd_launches} for fn, name in counters}

    model = make_um_net(seed)
    per_forward = model.kernel_launches_per_forward()
    per_step = model.kernel_launches_per_train_step()
    batches = [synthetic_batch(8, 512, seed + 9), synthetic_batch(8, 512, seed + 10)]
    inferer = SlidingWindowInferer(roi_size=(512, 512), overlap=0.5)
    loss_fn = make_loss_fn({"dice_focal_loss": {}}, {"dice_focal_loss": 1.0})
    logits = []

    def infer(images, predictor):
        out = inferer(images, predictor)
        logits.append(out)
        return out

    reset()
    t0 = time.perf_counter()
    f1, metric, losses = val_one_epoch(model, loss_fn, infer, batches, build_metrics())
    torch.cuda.synchronize()
    t_val = time.perf_counter() - t0
    got = read()
    want = {k: {"fwd": v * len(batches), "bwd": 0} for k, v in per_forward.items()}
    finite = all(bool(torch.isfinite(x).all()) for x in logits)
    shapes = [list(x.shape) for x in logits]
    x = torch.from_numpy(batches[0]["image"]).cuda()
    predictor = make_predictor(model)
    inferer(x, predictor)  # warm-up
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SERVING_REPS):
        out = inferer(x, predictor)
    torch.cuda.synchronize()
    rate = x.shape[0] * SERVING_REPS / (time.perf_counter() - t0)
    rate_launches = read()
    rate_want = {k: {"fwd": v * SERVING_REPS, "bwd": 0} for k, v in per_forward.items()}
    ok = (finite and got == want and shapes == [list(b["label"].shape) for b in batches]
          and all(np.isfinite(losses)) and rate_launches == rate_want
          and bool(torch.isfinite(out).all()))
    print("phase8 um_net val " + json.dumps(dict(
        logits=shapes, finite=finite, losses=losses, launches=got, expected=want,
        metrics={k: (v if v == v else None) for k, v in metric.items()}, seconds=t_val,
        roi=list(inferer.roi_size), batch=x.shape[0], overlap=inferer.overlap,
        images_per_sec_f32_predictor=rate,
        rate_launches_ok=rate_launches == rate_want, card=smi(), ok=ok)), flush=True)
    if not ok:
        raise SystemExit("phase8 FAILED: UM_Net serving path")
    serve = {name: c["fwd"] for name, c in got.items()}

    batch = synthetic_batch(8, 512, seed + 2)
    x, y = torch.from_numpy(batch["image"]).cuda(), torch.from_numpy(batch["label"]).cuda()
    # lr 1e-3 held constant: warmup 1 epoch of a million steps
    config = {"trainer": dict(lr=1e-3, warmup=1, num_epochs=2, steps_per_epoch=10**6,
                              weight_decay=0.05, optimizer="adamw")}
    state = create_train_state(model, config, seed=seed)
    train = {name: 0 for _, name in counters} | {f"{name}_bwd": 0 for _, name in counters}
    mamba_shapes, hooks = mamba_step_shapes(model)
    tap_shapes, tap_hooks = tap_step_shapes(model)
    torch.cuda.reset_peak_memory_stats()
    losses, times, counts_ok = [], [], True
    for i in range(TRAIN_STEPS):
        reset()
        t0 = time.perf_counter()
        scalars, _ = train_step(state, x, y, loss_fn)
        losses.append(float(scalars["total_loss"]))  # waits for the step
        times.append(time.perf_counter() - t0)
        if i == 0:  # the shapes of one step
            for h in hooks + tap_hooks:
                h.remove()
        got = read()
        counts_ok = counts_ok and got == per_step
        for name, c in got.items():
            train[name] += c["fwd"]
            train[f"{name}_bwd"] += c["bwd"]
    peak = torch.cuda.max_memory_allocated()
    rate = x.shape[0] * (TRAIN_STEPS - 1) / sum(times[1:])  # the first step warms up
    shapes_ok = (sum(mamba_shapes.values()) == per_step["mamba_fused_scan"]["bwd"]
                 and sum(tap_shapes.values()) == per_step["tap_conv"]["bwd"])
    ok = (all(np.isfinite(losses)) and losses[-1] < losses[0] and counts_ok and shapes_ok
          and state.step == TRAIN_STEPS)
    print("phase8 um_net train " + json.dumps(dict(
        batch=x.shape[0], size=x.shape[-1], dtype="float32", losses=losses,
        launches_per_step=per_step,
        counts_ok=counts_ok, mamba_shapes=len(mamba_shapes), tap_conv_shapes=len(tap_shapes),
        shapes_cover_launches=shapes_ok, step_seconds=times, train_images_per_sec=rate,
        max_memory_allocated_bytes=peak, card=smi(), ok=ok)), flush=True)
    if not ok:
        raise SystemExit("phase8 FAILED: UM_Net training path")
    if profile:
        profile_step("um_net train", lambda: train_step(state, x, y, loss_fn))
    counts = {"per_forward": per_forward, "per_train_step": per_step}
    return counts, {"serve": serve, "train": train}, mamba_shapes, tap_shapes


class Capture:
    """Tees sys.stdout into a buffer while open (the entry points' Logger
    tees on top of it and puts it back when they close)."""

    def __enter__(self):
        import io

        self.prev, self.buf = sys.stdout, io.StringIO()
        sys.stdout = self
        return self

    def write(self, data):
        self.prev.write(data)
        self.buf.write(data)

    def flush(self):
        self.prev.flush()

    def __exit__(self, *exc):
        sys.stdout = self.prev

    @property
    def text(self) -> str:
        return self.buf.getvalue()


def cli_config(name: str, epochs: int, resume: bool = False, model: str = "MM_Net"):
    """config.yml's trainer and DRIVE sections as a ConfigDict: `model`
    (MM_Net at full width with its default depths, `mamba_dtype` and remat)
    at 512², batch 4, DRIVE's mean and std, no data root (the synthetic
    set: 8 train images, 2 steps per epoch, 2 val)."""
    from mm_unet_tpu_torch.utils import ConfigDict

    return ConfigDict(
        trainer=dict(num_epochs=epochs, warmup=1, train_ratio=0.8, lr=1e-3, min_lr=1e-7,
                     optimizer="adamw", weight_decay=0.05, resume=resume, seed=50,
                     dataset_choose="DRIVE"),
        dataset=dict(DRIVE=dict(data_root="", batch_size=4, num_workers=4, image_size=512,
                                image_mean=[0.485, 0.456, 0.406],
                                image_std=[0.229, 0.224, 0.225])),
        finetune=dict(checkpoint=name, model_choose=model),
        models={model: dict(branch1=dict(num_classes=1), branch5=dict(num_classes=5))},
    )


def run_scalars(prefix: str) -> list:
    """The scalar events of the one run under logs/ whose name starts with
    `prefix` (the working directory's)."""
    import glob
    import os

    from mm_unet_tpu_torch.utils.tracker import read_scalars

    (path,) = glob.glob(os.path.join("logs", f"{prefix}*", "scalars.jsonl"))
    return read_scalars(path)


def store_meta(name: str, tag: str) -> dict:
    import os

    with open(os.path.join("model_store", name, f"{tag}_meta.json")) as f:
        return json.load(f)


def same_tensors(a, b) -> bool:
    """Bit-for-bit equality of two nested dicts/lists of tensors and values."""
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(same_tensors(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(same_tensors(x, y) for x, y in zip(a, b)))
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.cpu(), b.cpu()))
    return a == b


def phase9_cli(seed: int) -> dict:
    """The config-driven entry points at config.yml's DRIVE settings, in a
    fresh working directory: (a) `cli.train.main` for 2 epochs; (b) resume
    to 3 epochs through `setup` + `fit` (what `main` runs); (c) a real
    SIGTERM during the first epoch of a fresh run; (d) `cli.test.main` on
    the best checkpoint; (e) `cli.verify.main`. Returns each kernel's
    launches in (a)'s training and validation."""
    import os
    import shutil
    import signal
    import tempfile
    import threading

    from mm_unet_tpu_torch.cli import test as cli_test
    from mm_unet_tpu_torch.cli import train as cli_train
    from mm_unet_tpu_torch.cli import verify as cli_verify
    from mm_unet_tpu_torch.ops.mamba_fused import mamba_fused_scan
    from mm_unet_tpu_torch.ops.tap_conv import tap_conv

    counters = ((mamba_fused_scan, "mamba_fused_scan"), (tap_conv, "tap_conv"))

    def reset():
        for fn, _ in counters:
            fn.launches = fn.bwd_launches = 0

    def read() -> dict:
        return {**{name: fn.launches for fn, name in counters},
                **{f"{name}_bwd": fn.bwd_launches for fn, name in counters}}

    scalars, meta = run_scalars, store_meta

    def report(tag: str, ok: bool, **fields):
        print(f"phase9 {tag} " + json.dumps(dict(**fields, ok=ok)), flush=True)
        if not ok:
            raise SystemExit(f"phase9 FAILED: {tag}")

    train_fn, val_fn = cli_train.train_one_epoch, cli_train.val_one_epoch
    home, synth_n = os.getcwd(), os.environ.get("MMU_SYNTH_N")
    os.environ.pop("MMU_SYNTH_N", None)  # the default synthetic set: max(2 * batch, 8)
    work = tempfile.mkdtemp(prefix="mmu_phase9_")
    os.chdir(work)
    try:
        # (a) train 2 epochs; the wrappers read the counters around each
        # validation (train = the run's launches less validation's) and see
        # the model and the loaders the loop was given
        seen = {"val": {k: 0 for k in read()}, "pipelines": set()}

        def counted_val(model, loss_fn, inferer, val_loader, *args, **kwargs):
            before = read()
            seen["on_card"] = all(t.is_cuda for t in (*model.parameters(), *model.buffers()))
            seen["per_forward"] = model.kernel_launches_per_forward()
            seen["per_step"] = model.kernel_launches_per_train_step()
            out = val_fn(model, loss_fn, inferer, val_loader, *args, **kwargs)
            seen["val"] = {k: seen["val"][k] + v - before[k] for k, v in read().items()}
            seen["pipelines"].add(f"val {val_loader.pipeline}")
            return out

        def seen_train(state, loss_fn, train_loader, *args, **kwargs):
            out = train_fn(state, loss_fn, train_loader, *args, **kwargs)
            seen["pipelines"].add(f"train {train_loader.pipeline}")
            return out

        cli_train.val_one_epoch, cli_train.train_one_epoch = counted_val, seen_train
        torch.cuda.reset_peak_memory_stats()
        reset()
        t0 = time.perf_counter()
        rc = cli_train.main(cli_config("MM_Net", 2), "cuda")
        t_a = time.perf_counter() - t0
        cli_train.val_one_epoch, cli_train.train_one_epoch = val_fn, train_fn
        total = read()
        val = seen["val"]
        train = {k: v - val[k] for k, v in total.items()}
        per_fwd, per_step = seen["per_forward"], seen["per_step"]
        # 2 epochs x 2 steps; 2 epochs x 2 val images, one 512² window each
        want_train = {**{k: 4 * per_step[k]["fwd"] for k in per_fwd},
                      **{f"{k}_bwd": 4 * per_step[k]["bwd"] for k in per_fwd}}
        want_val = {**{k: 4 * v for k, v in per_fwd.items()}, **{f"{k}_bwd": 0 for k in per_fwd}}
        events = scalars("MM_Net")
        step_losses = [e["Train/total_loss"] for e in events if "Train/total_loss" in e]
        rates = [e["Train/images_per_sec"] for e in events if "Train/images_per_sec" in e]
        store = os.path.join("model_store", "MM_Net")
        files = {f: os.path.exists(os.path.join(store, f))
                 for f in ("best", "best_meta.json", "checkpoint", "checkpoint_meta.json")}
        ok = (rc == 0 and len(step_losses) == 4 and all(map(math.isfinite, step_losses))
              and all(files.values()) and meta("MM_Net", "checkpoint")["epoch"] == 2
              and seen["on_card"] and train == want_train and val == want_val)
        peak_a = torch.cuda.max_memory_allocated()
        report("train", ok, rc=rc, step_losses=step_losses, files=files,
               best_meta=meta("MM_Net", "best") if files["best_meta.json"] else None,
               launches=dict(train=train, val=val), expected=dict(train=want_train, val=want_val),
               params_on_card=seen["on_card"], pipelines=sorted(seen["pipelines"]),
               train_images_per_sec=rates, max_memory_allocated_bytes=peak_a,
               seconds=t_a, card=smi())

        # (b) resume to 3 epochs: the state as the file holds it, step 4, and
        # the first step at the schedule's lr for step 4
        t0 = time.perf_counter()
        with Capture() as out:  # opened before the run's log tee, closed after it
            s = cli_train.setup(cli_config("MM_Net", 3, resume=True), "cuda")
            saved = s.manager.read("checkpoint")
            restored = dict(
                step=s.state.step, starting_epoch=s.starting_epoch,
                model=same_tensors(s.state.model.state_dict(), saved["model"]),
                optimizer=same_tensors(s.state.optimizer.state_dict(), saved["optimizer"]),
                generator=same_tensors(s.state.generator.get_state(), saved["generator"]))
            lrs = []
            s.state.optimizer.register_step_pre_hook(
                lambda opt, args, kwargs: lrs.append(opt.param_groups[0]["lr"]))
            rc = cli_train.fit(s)
        epochs = [ln.split("]")[0] + "]" for ln in out.text.splitlines() if ln.startswith("Epoch [")]
        ok = (rc == 0 and restored["step"] == 4 and restored["starting_epoch"] == 2
              and restored["model"] and restored["optimizer"] and restored["generator"]
              and epochs and set(epochs) == {"Epoch [3/3]"} and lrs[:1] == [s.state.schedule(4)]
              and len(lrs) == 2)
        report("resume", ok, rc=rc, restored=restored, epochs=sorted(set(epochs)),
               first_lr=lrs[:1], schedule_4=s.state.schedule(4), steps=len(lrs),
               seconds=time.perf_counter() - t0)

        # (c) SIGTERM from a timer thread once the first epoch's first step
        # is done; the epoch stops at the next step boundary
        handlers = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM, signal.SIGINT)}

        def signalled_train(state, *args, **kwargs):
            def after_step(*_):
                hook.remove()
                threading.Timer(0.0, os.kill, (os.getpid(), signal.SIGTERM)).start()

            hook = state.optimizer.register_step_post_hook(after_step)
            cli_train.train_one_epoch = train_fn
            return train_fn(state, *args, **kwargs)

        cli_train.train_one_epoch = signalled_train
        t0 = time.perf_counter()
        with Capture() as out:
            rc = cli_train.main(cli_config("MM_Net_preempt", 2), "cuda")
        cli_train.train_one_epoch = train_fn
        after = {sig: signal.getsignal(sig) for sig in handlers}
        steps_run = [e for e in scalars("MM_Net_preempt") if "Train/total_loss" in e]
        ok = (rc == 0 and "[preempt] checkpoint saved at epoch 0" in out.text
              and after == handlers and meta("MM_Net_preempt", "checkpoint")["epoch"] == 0
              and 1 <= len(steps_run) <= 2
              and not os.path.exists(os.path.join("model_store", "MM_Net_preempt", "best")))
        report("preempt", ok, rc=rc, saved_line="[preempt] checkpoint saved at epoch 0" in out.text,
               handlers_restored=after == handlers, steps_before_stop=len(steps_run),
               seconds=time.perf_counter() - t0)

        # (d) test on the best checkpoint: its metrics as the run stored them
        t0 = time.perf_counter()
        with Capture() as out:
            rc = cli_test.main(cli_config("MM_Net", 3), "cuda")
        got = scalars("test_MM_Net")[-1]
        best = meta("MM_Net", "best")["best_class"]
        diffs = {k: abs(got[k] - best[k]) for k in ("Val/mean f1", "Val/mean dice_metric")}
        hd95 = got.get("Val/mean hd95")
        ok = (rc == 0 and "loaded best checkpoint" in out.text and "test: dice" in out.text
              and max(diffs.values()) <= 1e-3 and isinstance(hd95, float)
              and (math.isfinite(hd95) or math.isnan(hd95)))
        report("test", ok, rc=rc, diffs=diffs, tol=1e-3, hd95=hd95 if hd95 == hd95 else None,
               dice=got["Val/mean dice_metric"], seconds=time.perf_counter() - t0)

        # (e) verify: one warm-up epoch from the best checkpoint, then validation
        t0 = time.perf_counter()
        reset()
        with Capture() as out:
            rc = cli_verify.main(cli_config("MM_Net", 3), "cuda")
        got = scalars("verify_MM_Net")
        warm = [e["Train/total_loss"] for e in got if "Train/total_loss" in e]
        ok = (rc == 0 and "verify: best dice" in out.text and len(warm) == 2
              and all(map(math.isfinite, warm)) and "Val/mean hd95" in got[-1]
              and read()["mamba_fused_scan_bwd"] == 2 * per_step["mamba_fused_scan"]["bwd"])
        report("verify", ok, rc=rc, warmup_losses=warm, launches=read(),
               seconds=time.perf_counter() - t0)
    finally:
        cli_train.val_one_epoch, cli_train.train_one_epoch = val_fn, train_fn
        os.chdir(home)
        if synth_n is not None:
            os.environ["MMU_SYNTH_N"] = synth_n
        shutil.rmtree(work, ignore_errors=True)
    return {"train": train, "val": val, "step_losses": step_losses, "rates": rates,
            "max_memory": peak_a}


class StreamWaits:
    """Runs its block under `torch.cuda.set_sync_debug_mode("error")`, so
    that a call that waits on the whole stream (a blocking copy, `.item()`
    of a card tensor, a stream or device synchronise) raises; an event's
    synchronise waits on that event alone and passes. `torch.cuda.
    synchronize` is let through and counted (`synchronizes`)."""

    def __enter__(self):
        self.real, self.synchronizes = torch.cuda.synchronize, 0

        def counted(device=None):
            self.synchronizes += 1
            torch.cuda.set_sync_debug_mode(0)
            try:
                self.real(device)
            finally:
                torch.cuda.set_sync_debug_mode("error")

        torch.cuda.synchronize = counted
        torch.cuda.set_sync_debug_mode("error")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize = self.real


def phase9_stream_waits(seed: int) -> None:
    """F1: `train_one_epoch` over three batches and `val_one_epoch` over two
    of MM_Net at phase 9's settings (full width, its default bf16 feature
    path and remat, 512², batch 4, numpy batches), inside `StreamWaits`: no
    call may wait on the whole stream but the training epoch's closing
    synchronise. On a miss the line names the call's last frames."""
    import traceback

    from mm_unet_tpu_torch.data import synthetic_batch
    from mm_unet_tpu_torch.evaluate import val_one_epoch
    from mm_unet_tpu_torch.models import give_model
    from mm_unet_tpu_torch.train.inferers import SlidingWindowInferer
    from mm_unet_tpu_torch.train.loop import train_one_epoch
    from mm_unet_tpu_torch.train.metrics import build_metrics
    from mm_unet_tpu_torch.train.trainer import create_train_state, make_loss_fn

    model = give_model("MM_Net", device="cuda", generator=torch.Generator().manual_seed(seed))
    config = {"trainer": dict(lr=1e-3, warmup=1, num_epochs=2, weight_decay=0.05)}
    state = create_train_state(model, config, seed=seed)
    loss_fn = make_loss_fn({"dice_focal_loss": {}}, {"dice_focal_loss": 1.0})
    batches = [synthetic_batch(4, 512, seed + 20 + i) for i in range(5)]
    inferer = SlidingWindowInferer(roi_size=(512, 512), overlap=0.5)
    miss, train_syncs, t0 = None, None, time.perf_counter()
    with Capture() as out, StreamWaits() as waits:
        try:
            train_one_epoch(state, loss_fn, batches[:3], build_metrics())
            train_syncs = waits.synchronizes
            val_one_epoch(model, loss_fn, inferer, batches[3:], build_metrics())
        except RuntimeError:
            miss = traceback.format_exc().strip().splitlines()[-12:]
    steps = sum(ln.startswith("Epoch [1/1] Training [") for ln in out.text.splitlines())
    vals = sum(ln.startswith("Epoch [1/1] Validation [") for ln in out.text.splitlines())
    ok = miss is None and waits.synchronizes == train_syncs == 1 and steps == 3 and vals == 2
    print("phase9 stream waits " + json.dumps(dict(
        train_steps=steps, val_batches=vals, synchronizes=waits.synchronizes, miss=miss,
        seconds=time.perf_counter() - t0, ok=ok)), flush=True)
    if not ok:
        raise SystemExit("phase9 FAILED: the loops wait on the whole stream")


def lm_card_vs_cpu(cfg: dict, seed: int, rng, report) -> None:
    """A depth-2 model at `cfg`'s full width (weights from `seed`) at 256
    tokens from `rng`: the logits with the kernels on the card against the
    plain versions on the CPU, per element as `rel_err` (LM_CPU_TOL)."""
    from mm_unet_tpu_torch.models.lm import give_lm

    cpu_lm = give_lm(dict(cfg, n_layer=2), device="cpu",
                     generator=torch.Generator().manual_seed(seed))
    gpu_lm = copy.deepcopy(cpu_lm).to("cuda")
    ids = torch.from_numpy(rng.integers(0, cfg["vocab_size"], (1, 256)))
    with torch.inference_mode():
        got = gpu_lm(ids.cuda())
        want = cpu_lm(ids)
    err, rel = rel_err(got.cpu(), want)
    report("depth-2 card vs cpu", bool(torch.isfinite(got).all()) and rel <= LM_CPU_TOL,
           shape=list(got.shape), max_abs_err=err, rel_err=rel, tol=LM_CPU_TOL)


def lm_scoring(cfg: dict, seed: int, rng, report, tag: str) -> tuple:
    """The LM of `cfg` built on the card (weights from `seed`) and its
    scoring forward at LM_SCORE on tokens from `rng`, counted from zero:
    exactly one kernel-1 launch per layer and none of kernel 5, tokens/s
    over three forwards, device ms and operations, busy share and peak
    memory (the `scoring` line; `tag` names its profile). Returns (the
    model, the tokens, the logits, the launches)."""
    from mm_unet_tpu_torch.models.lm import give_lm
    from mm_unet_tpu_torch.ops.chunked_scan import selective_scan_chunked
    from mm_unet_tpu_torch.ops.mamba_fused import mamba_fused_scan

    (B, L), n_layer = LM_SCORE, cfg["n_layer"]
    t0 = time.perf_counter()
    lm = give_lm(cfg, device="cuda", generator=torch.Generator().manual_seed(seed))
    t_build = time.perf_counter() - t0
    ids = torch.from_numpy(rng.integers(0, cfg["vocab_size"], (B, L))).cuda()
    per_fwd = lm.kernel_launches_per_forward()
    with torch.inference_mode():
        lm(ids)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mamba_fused_scan.launches = selective_scan_chunked.launches = 0
        logits = lm(ids)
        torch.cuda.synchronize()
        launches = {"mamba_fused_scan": mamba_fused_scan.launches,
                    "selective_scan": selective_scan_chunked.launches}
        peak = torch.cuda.max_memory_allocated()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            lm(ids)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        ops = call_device_ops(lambda: lm(ids), reps=2)
        prof = profile_step(f"{tag} scoring forward", lambda: lm(ids))
    wall = sum(times) / len(times)
    report("scoring", bool(torch.isfinite(logits).all())
           and launches == {"mamba_fused_scan": n_layer, "selective_scan": 0}
           and per_fwd == {"mamba_fused_scan": n_layer},
           batch=B, tokens=L, logits=list(logits.shape), launches=launches, expected=per_fwd,
           tokens_per_s=B * L / wall, wall_ms=wall * 1e3, device_ms=ops["device_ms"],
           busy_share=prof["busy_share"], device_launches=ops["launches"],
           max_memory_allocated_bytes=peak, build_s=t_build, card=smi())
    return lm, ids, logits, launches


def phase10_lm(seed: int) -> dict:
    """The Mamba LM (`models/lm.py`) at mamba-130m's published widths, f32:
    (a) kernel 1 at the LM's shape against its plain version, with its plan
    (6 blocks of 256 channels behind pass X); (b) a depth-2
    full-width model, card against CPU; (c) the 24-layer scoring forward at
    LM_SCORE, exact kernel-1 launches, tokens/s, device time, busy share and
    peak memory, then the same weights on route b (kernel 5) against route
    a; (d) both decoders at each of LM_BATCHES: tokens/s, greedy and sampled
    tokens equal between them, and the teacher-forced step logits against
    the forward's; (e) training on both routes (`phase10_lm_train`).
    Returns the kernel record and the launches."""
    from mm_unet_tpu_torch.models.lm import (
        MAMBA_130M, _caches, generate, generate_scan, token_step)
    from mm_unet_tpu_torch.models.mamba import Mamba
    from mm_unet_tpu_torch.ops.chunked_scan import selective_scan_chunked
    from mm_unet_tpu_torch.ops.mamba_fused import mamba_fused_scan, mamba_fused_scan_ref

    dev, f32 = torch.device("cuda"), torch.float32
    cfg, (B, L) = MAMBA_130M, LM_SCORE
    D, R, N, W = 2 * cfg["d_model"], math.ceil(cfg["d_model"] / 16), 16, 4
    failed = []

    def report(tag, ok, **fields):
        print(f"phase10 {tag} " + json.dumps(dict(**fields, ok=ok)), flush=True)
        failed.extend([] if ok else [tag])

    # (a) kernel 1 alone at the scoring forward's shape
    gen = torch.Generator().manual_seed(seed + 30)
    xz, w = mamba_inputs(lambda *sh, scale=1.0: (torch.randn(*sh, generator=gen) * scale).to(dev),
                         dev, B, D, R, L, N, W)
    call = lambda: mamba_fused_scan(xz, *w)  # noqa: E731
    got = call()
    torch.cuda.synchronize()
    want = mamba_fused_scan_ref(xz, *w)
    err, rel, ok = compare(got, want, f32)
    del got, want
    ms, kms = cuda_ms(call, reps=10), kernel_device_ms(call, FWD_KERNELS)
    plain_ms = cuda_ms(lambda: mamba_fused_scan_ref(xz, *w), reps=1)
    bms, by = bound(*mamba_work(B, D, L, N, R, W, 4, False))
    kernel = dict(B=B, D=D, R=R, N=N, W=W, L=L, dtype="float32", max_abs_err=err, rel_err=rel,
                  tol=TOL[f32], ms=ms, kernel_ms=kms, plain_ms=plain_ms, bound_ms=bms,
                  bound_by=by, **fwd_plan(D, R, N, f32))
    report("mamba_fused_scan", ok, **kernel, card=smi())
    del xz, w

    # (b) the depth-2 full-width model, card against CPU; (c) scoring, then
    # the same weights on route b
    rng = np.random.default_rng(seed + 31)
    lm_card_vs_cpu(cfg, seed, rng, report)
    lm, ids, logits, launches = lm_scoring(cfg, seed, rng, report, "lm")
    with torch.inference_mode():
        mambas = [m for m in lm.modules() if isinstance(m, Mamba)]
        for m in mambas:
            m.scan_impl = "pallas"
        mamba_fused_scan.launches = selective_scan_chunked.launches = 0
        t0 = time.perf_counter()
        logits_b = lm(ids)
        torch.cuda.synchronize()
        t_b = time.perf_counter() - t0
        launches_b = {"mamba_fused_scan": mamba_fused_scan.launches,
                      "selective_scan": selective_scan_chunked.launches}
        for m in mambas:
            m.scan_impl = None
    err_b, rel_b = rel_err(logits_b, logits)
    report("scoring route b", bool(torch.isfinite(logits_b).all()) and rel_b <= MM_ROUTE_LOGITS_TOL
           and launches_b == {"mamba_fused_scan": 0, "selective_scan": cfg["n_layer"]},
           launches=launches_b, logits_max_abs_err=err_b, logits_rel_err=rel_b,
           logits_tol=MM_ROUTE_LOGITS_TOL, wall_ms=t_b * 1e3)
    del logits, logits_b

    # (d) both decoders, greedy, sampled and teacher-forced
    decoders = {"generate": generate, "generate_scan": generate_scan}
    for bsz in LM_BATCHES:
        prompt = torch.from_numpy(rng.integers(0, cfg["vocab_size"], (bsz, LM_PROMPT))).to(dev)
        rates, greedy, sampled, step_err = {}, {}, {}, {}
        for name, dec in decoders.items():
            dec(lm, prompt[:, :2], 2)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            greedy[name] = dec(lm, prompt, LM_NEW)
            torch.cuda.synchronize()
            t = time.perf_counter() - t0
            rates[name] = dict(tokens_per_s=bsz * LM_NEW / t, seconds=t,
                               ms_per_token_step=t * 1e3 / (LM_PROMPT + LM_NEW))
            sampled[name] = dec(lm, prompt, LM_NEW, **LM_SAMPLING,
                                generator=torch.Generator(device=dev).manual_seed(seed + 33))
        # the device operations of one eager token step: what a replay runs
        conv, ssm = _caches(lm, bsz, dev)
        with torch.no_grad():
            step_ops = call_device_ops(lambda: token_step(lm, prompt[:, 0], conv, ssm))
        teacher = greedy["generate"]
        with torch.inference_mode():
            want = lm(teacher)
        top = want.abs().max().item()
        for name, dec in decoders.items():
            tokens, lg = dec(lm, prompt, LM_NEW, teacher_outputs=teacher, return_logits=True)
            step_err[name] = (lg - want).abs().max().item() / top
            step_err[name + " tokens"] = torch.equal(tokens, teacher)
        same_greedy = torch.equal(greedy["generate"], greedy["generate_scan"])
        same_sampled = torch.equal(sampled["generate"], sampled["generate_scan"])
        left_greedy = (sampled["generate"] != teacher).float().mean().item()
        report(f"decode batch {bsz}", same_greedy and same_sampled and left_greedy > 0
               and all(step_err[f"{n} tokens"] and step_err[n] <= LM_DECODE_TOL
                       for n in decoders),
               prompt=LM_PROMPT, new_tokens=LM_NEW, rates=rates,
               token_step=dict(launches=step_ops["launches"], device_ms=step_ops["device_ms"]),
               greedy_equal=same_greedy,
               sampled_equal=same_sampled, sampling=LM_SAMPLING,
               sampled_share_off_greedy=left_greedy,
               teacher_forced_rel_err=step_err, tol=LM_DECODE_TOL, card=smi())
    train = phase10_lm_train(lm, ids, rng, report)
    if failed:
        raise SystemExit(f"phase10 FAILED: {failed}")
    return {"kernel": kernel, "launches": launches, "route_b_launches": launches_b,
            "train": train}


def phase10_lm_train(lm, ids, rng, report) -> dict:
    """(e) The LM's training pass at mamba-130m's widths (the backbone's
    output y, the loss (y * w).sum() of phase 13, backward) on route a and
    on route b (every Mamba `scan_impl="pallas"`) with the same weights:
    exact launches of kernels 1/2 (a) and 5/6 (b) per step, each route's
    forward + backward tokens/s over LM_TRAIN_STEPS steps after a warm-up,
    device ms and busy share of one profiled step and peak memory; then the
    output and every parameter gradient, route a against route b, relative
    to its own norm (LM_ROUTE_GRAD_TOL). Returns each route's launches."""
    from mm_unet_tpu_torch.models.mamba import Mamba
    from mm_unet_tpu_torch.ops.chunked_scan import selective_scan_chunked
    from mm_unet_tpu_torch.ops.mamba_fused import mamba_fused_scan

    bb = lm.backbone
    (B, L), d_model, n_layer = ids.shape, lm.d_model, len(bb.layers)
    w = torch.from_numpy(rng.standard_normal((B, L, d_model)).astype(np.float32)).to(ids.device)
    mambas = [m for m in bb.modules() if isinstance(m, Mamba)]
    params = dict(bb.named_parameters())
    counters = (mamba_fused_scan, selective_scan_chunked)

    def step():
        bb.zero_grad(set_to_none=True)
        y = bb(ids)
        (y * w).sum().backward()
        return y.detach()

    runs = {}
    for route, impl in (("a", None), ("b", "pallas")):
        for m in mambas:
            m.scan_impl = impl
        step()  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters:
            fn.launches = fn.bwd_launches = 0
        y = step()
        torch.cuda.synchronize()
        launches = {"mamba_fused_scan": mamba_fused_scan.launches,
                    "mamba_fused_scan_bwd": mamba_fused_scan.bwd_launches,
                    "selective_scan": selective_scan_chunked.launches,
                    "selective_scan_bwd": selective_scan_chunked.bwd_launches}
        peak = torch.cuda.max_memory_allocated()
        grads = {k: p.grad.clone() for k, p in params.items()}
        t0 = time.perf_counter()
        for _ in range(LM_TRAIN_STEPS):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / LM_TRAIN_STEPS
        prof = profile_step(f"lm train route {route}", step)
        runs[route] = dict(y=y, grads=grads, numbers=dict(
            launches=launches, tokens_per_s=B * L / wall, wall_ms=wall * 1e3,
            device_ms=prof["device_ms"], busy_share=prof["busy_share"],
            device_launches=prof["launches"], max_memory_allocated_bytes=peak))
    for m in mambas:
        m.scan_impl = None
    a, b = runs["a"], runs["b"]
    errs = {"y": ((a["y"] - b["y"]).norm() / b["y"].norm()).item()}
    errs.update({k: ((a["grads"][k] - g).norm() / g.norm()).item()
                 for k, g in b["grads"].items()})
    worst = max(errs.items(), key=lambda kv: kv[1])
    finite = all(bool(torch.isfinite(t).all()) for r in runs.values()
                 for t in (r["y"], *r["grads"].values()))
    want = {"a": {"mamba_fused_scan": n_layer, "mamba_fused_scan_bwd": n_layer,
                  "selective_scan": 0, "selective_scan_bwd": 0},
            "b": {"mamba_fused_scan": 0, "mamba_fused_scan_bwd": 0,
                  "selective_scan": n_layer, "selective_scan_bwd": n_layer}}
    report("train routes", finite and worst[1] <= LM_ROUTE_GRAD_TOL
           and all(runs[r]["numbers"]["launches"] == want[r] for r in runs),
           batch=B, tokens=L, d_model=d_model, n_layer=n_layer,
           route_a=a["numbers"], route_b=b["numbers"], expected=want,
           y_rel_norm_err=errs["y"], worst_grad=list(worst), tensors=len(errs) - 1,
           tol=LM_ROUTE_GRAD_TOL, card=smi())
    return {r: runs[r]["numbers"]["launches"] for r in runs}


def lm_kernels(seed: int, D: int, R: int, tag: str) -> dict:
    """Kernels 1 and 2 alone at the Mamba LM's scoring shape (LM_SCORE) at
    width D and dt_rank R, f32 and bf16: kernel 1 against its plain version
    (TOL), kernel 2 against autograd of it (BWD_TOL), each input's gradient,
    per element as `rel_err`; events ms, device ms, the plain version's ms,
    the bound, and each kernel's plan with its passes' resident blocks per
    SM. Prints a line per kernel and dtype; fails after all of them if one
    disagrees. Returns {"fwd": [...], "bwd": [...]}."""
    from mm_unet_tpu_torch.ops.mamba_fused import mamba_fused_scan, mamba_fused_scan_ref

    dev, (B, L), N, W = torch.device("cuda"), LM_SCORE, 16, 4
    gen = torch.Generator().manual_seed(seed)
    rn = lambda *sh, scale=1.0: (torch.randn(*sh, generator=gen) * scale).to(dev)  # noqa: E731
    xz, w = mamba_inputs(rn, dev, B, D, R, L, N, W)
    dout = rn(B, 1, D, L)
    shape = dict(B=B, D=D, R=R, N=N, W=W, L=L)
    out_recs, failed = {"fwd": [], "bwd": []}, []
    for dtype in (torch.float32, torch.bfloat16):
        x, d = xz.to(dtype), dout.to(dtype)
        call = lambda: mamba_fused_scan(x, *w)  # noqa: E731
        with torch.no_grad():
            err, rel, ok = compare(call(), mamba_fused_scan_ref(x, *w), dtype)
            ms, kms = cuda_ms(call, reps=10), kernel_device_ms(call, FWD_KERNELS)
            plain_ms = cuda_ms(lambda: mamba_fused_scan_ref(x, *w), reps=1)
        bms, by = bound(*mamba_work(B, D, L, N, R, W, x.element_size(), False))
        rec = dict(shape, dtype=str(dtype)[6:], max_abs_err=err, rel_err=rel, tol=TOL[dtype],
                   ms=ms, kernel_ms=kms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                   **fwd_plan(D, R, N, dtype), ok=ok)
        print(f"{tag} mamba_fused_scan {json.dumps(rec)}", flush=True)
        out_recs["fwd"].append(rec)
        failed += [] if ok else [rec]

        out, live, got = grads_of(mamba_fused_scan, [x, *w], d)
        outp, livep, want = grads_of(mamba_fused_scan_ref, [x, *w], d)
        errs, ok = compare_grads(got, want, FusedCalls.NAMES, BWD_TOL[dtype])
        del got, want
        call = lambda: torch.autograd.grad(out, live, d, retain_graph=True)  # noqa: E731
        ms, kms = cuda_ms(call, reps=10), kernel_device_ms(call, BWD_KERNELS)
        plain_ms = cuda_ms(lambda: torch.autograd.grad(outp, livep, d, retain_graph=True),
                           reps=1, warmup=0)
        bms, by = bound(*mamba_work(B, D, L, N, R, W, d.element_size(), True))
        rec = dict(shape, dtype=str(dtype)[6:], max_abs_err=max(e for e, _ in errs.values()),
                   rel_err=max(r for _, r in errs.values()), tol=BWD_TOL[dtype], errs=errs,
                   ms=ms, kernel_ms=kms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                   **bwd_plan(D, R, N, dtype), ok=ok)
        print(f"{tag} mamba_fused_scan_bwd {json.dumps(rec)}", flush=True)
        out_recs["bwd"].append(rec)
        failed += [] if ok else [rec]
        del out, live, outp, livep, x, d
    if failed:
        raise SystemExit(f"{tag} FAILED: {len(failed)} kernel comparisons out of tolerance")
    return out_recs


def phase10_lm_fit(lm, ids, report, tag: str) -> dict:
    """One warm-up and LM_TRAIN_STEPS timed AdamW steps (config.yml's lr
    1e-3, weight decay 0.05) of the whole LM on route a at `ids`' shape,
    next-token cross-entropy over the tied head: exact launches of kernels
    1 and 2 in the warm-up step (one of each per layer), finite losses, the
    last below the first, tokens/s and peak memory. Returns the launches."""
    import torch.nn.functional as F

    from mm_unet_tpu_torch.ops.mamba_fused import mamba_fused_scan
    from mm_unet_tpu_torch.train.optim import build_optimizer

    (B, L), n_layer = ids.shape, lm.n_layer
    lm.train()
    opt = build_optimizer(lm, "adamw", lr=1e-3, weight_decay=0.05)

    def step():
        opt.zero_grad(set_to_none=True)
        logits = lm(ids[:, :-1])
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), ids[:, 1:].reshape(-1))
        loss.backward()
        opt.step()
        return loss.detach()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mamba_fused_scan.launches = mamba_fused_scan.bwd_launches = 0
    losses = [step()]
    torch.cuda.synchronize()
    launches = {"mamba_fused_scan": mamba_fused_scan.launches,
                "mamba_fused_scan_bwd": mamba_fused_scan.bwd_launches}
    t0 = time.perf_counter()
    for _ in range(LM_TRAIN_STEPS):
        losses.append(step())
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / LM_TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated()
    losses = [v.item() for v in losses]
    lm.eval()
    del opt
    want = {"mamba_fused_scan": n_layer, "mamba_fused_scan_bwd": n_layer}
    report(f"{tag}train", launches == want and all(math.isfinite(v) for v in losses)
           and losses[-1] < losses[0],
           batch=B, tokens=L - 1, n_layer=n_layer, losses=losses, launches=launches,
           expected=want, tokens_per_s=B * (L - 1) / wall, wall_ms=wall * 1e3,
           max_memory_allocated_bytes=peak, card=smi())
    return launches


def phase10_lm_370m(seed: int) -> dict:
    """The Mamba LM at mamba-370m's published widths (`MAMBA_370M`: d_model
    1024, 48 layers, d_inner 2048, dt_rank 64; f32, seeded weights), where
    kernel 1 splits each chunk's channels over 8 blocks behind pass X: (a)
    kernels 1 and 2 alone at the scoring shape, f32 and bf16, against their
    plain versions (`lm_kernels`); (b) a depth-2 full-width model, card
    against CPU; (c) the 48-layer scoring forward at LM_SCORE, exactly 48
    kernel-1 launches, tokens/s, device ms, busy share, peak memory; (d)
    the training pass on routes a and b with the same weights, output and
    every gradient a against b (`phase10_lm_train`); (e) AdamW steps on
    route a (`phase10_lm_fit`). Returns the kernel records and the
    launches of each path."""
    from mm_unet_tpu_torch.models.lm import MAMBA_370M

    cfg = MAMBA_370M
    D, R = 2 * cfg["d_model"], math.ceil(cfg["d_model"] / 16)
    failed = []

    def report(tag, ok, **fields):
        print(f"phase10 370m {tag} " + json.dumps(dict(**fields, ok=ok)), flush=True)
        failed.extend([] if ok else [tag])

    kernels = lm_kernels(seed + 40, D, R, "phase10 370m")

    # (b) the depth-2 full-width model, card against CPU; (c) scoring
    rng = np.random.default_rng(seed + 41)
    lm_card_vs_cpu(cfg, seed, rng, report)
    lm, ids, logits, launches = lm_scoring(cfg, seed, rng, report, "lm 370m")
    del logits

    # (d) the training pass on both routes, (e) AdamW steps on route a
    train = phase10_lm_train(lm, ids, rng, report)
    fit = phase10_lm_fit(lm, ids, report, "")
    del lm
    torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"phase10 370m FAILED: {failed}")
    return {"kernels": kernels, "launches": launches, "train": train, "fit": fit}


# kernel-name fragments -> the layer that launched the kernel
def zoo_config(name: str, size: int | None = None):
    """config.yml as `load_config` reads it, `name` chosen, its dataset at
    its protocol (ZOO_DATA, else DRIVE); with `size`, the dataset's image
    size and a section's own `img_size` set to it."""
    from mm_unet_tpu_torch.utils import load_config

    config = load_config("config.yml")
    dataset = ZOO_DATA.get(name, ("DRIVE", 512))[0]
    config.trainer.dataset_choose = dataset
    config.finetune.model_choose = name
    if size is not None:
        config.dataset[dataset].image_size = size
        section = config.models[name].branch1
        if "img_size" in section:
            section.img_size = size
    return config


def zoo_model(name: str, seed: int, device: str, size: int | None = None):
    """`name` with seeded weights: a model of config.yml as the file sets it
    (`zoo_config`), a phase-12 model (no section) at its constructor's
    widths with `ZOO12_KWARGS`."""
    from mm_unet_tpu_torch.models import give_model, give_model_from_config

    gen = torch.Generator().manual_seed(seed)
    if name in ZOO12:
        return give_model(name, device, gen, **ZOO12_KWARGS.get(name, {}))
    return give_model_from_config(zoo_config(name, size), device, gen)


def zoo_forward_flops(name: str, seed: int) -> int:
    """Operations of one forward of `name` at its protocol size, batch 8,
    counted by `torch.utils.flop_counter` on the meta device (convolutions
    and matmuls; norms and elementwise operations are not counted). A train
    step is taken as three forwards. Mambas take their plain route there
    (the kernels take no meta tensors), whose projections are counted."""
    from torch.utils.flop_counter import FlopCounterMode

    from mm_unet_tpu_torch.models.mamba import Mamba

    size = ZOO_DATA.get(name, ("DRIVE", 512))[1]
    model = zoo_model(name, seed, "cpu").to("meta").eval()
    for m in model.modules():
        if isinstance(m, Mamba):
            m.scan_impl = "ref"
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(torch.zeros(8, 3, size, size, device="meta"))
    return counter.get_total_flops()


def kernel_counters() -> tuple:
    from mm_unet_tpu_torch.ops.chunked_scan import selective_scan_chunked
    from mm_unet_tpu_torch.ops.mamba_fused import mamba_fused_scan
    from mm_unet_tpu_torch.ops.tap_conv import tap_conv

    return (mamba_fused_scan, tap_conv, selective_scan_chunked)


def kernel_launches() -> dict:
    return {**{fn.__name__: fn.launches for fn in kernel_counters()},
            **{f"{fn.__name__}_bwd": fn.bwd_launches for fn in kernel_counters()}}


def phase11_card_vs_cpu(seed: int, names: tuple = ZOO, tag: str = "phase11") -> dict:
    """(a) Each zoo model at 128² (TransUNet and UNETR built for it), the
    same weights on the card and the CPU: the eval logits at 1x3x128² in
    f32 and in f64, per element; then, in f64, every parameter gradient of
    one train-mode pass (DiceFocal, dropout and drop path at the identity)
    at 2x3x128², per tensor. A model's Mambas compute in f32 in the f64
    passes (the kernels' stream dtypes)."""
    from mm_unet_tpu_torch.models.layers import Dropout, DropPath
    from mm_unet_tpu_torch.models.mamba import Mamba
    from mm_unet_tpu_torch.train.losses import dice_focal_loss

    rng = np.random.default_rng(seed + 11)
    x = torch.from_numpy(rng.standard_normal((2, 3, 128, 128)))
    y = torch.from_numpy((rng.random((2, 1, 128, 128)) < 0.2).astype(np.float64))
    out = {}
    for name in names:
        t0 = time.perf_counter()
        models = {"cpu": zoo_model(name, seed, "cpu", size=128)}
        models["cuda"] = copy.deepcopy(models["cpu"]).cuda()
        logits = {}
        for dtype in (torch.float32, torch.float64):
            for model in models.values():
                model.to(dtype)
                for m in model.modules():
                    if isinstance(m, Mamba):
                        m.dtype = torch.float32 if dtype == torch.float64 else None
            with torch.inference_mode():
                got, want = (models[dev](x[:1].to(dev, dtype)).cpu() for dev in ("cuda", "cpu"))
            logits[str(dtype)[6:]] = (*rel_err(got, want), bool(torch.isfinite(got).all()))
        grads = {}
        for dev, model in models.items():
            model.train()
            for m in model.modules():
                if isinstance(m, (Dropout, DropPath)):
                    m.eval()
            dice_focal_loss(model(x.to(dev)), y.to(dev)).backward()
            grads[dev] = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
        bad, worst = tensor_grad_errs(grads["cuda"], grads["cpu"], ZOO_F64_TOL, set(),
                                      ZOO_GRAD_FLOOR)
        f32_tol = None if name == "TransUNet" else ZOO_CPU_TOL
        ok = (all(finite for *_, finite in logits.values())
              and (f32_tol is None or logits["float32"][1] <= f32_tol)
              and logits["float64"][1] <= ZOO_F64_TOL and bad == 0)
        out[name] = dict(logits_rel_err_f32=logits["float32"][1],
                         logits_rel_err_f64=logits["float64"][1],
                         grad_worst_f64=worst[0]["relative"])
        print(f"{tag} {name} card vs cpu " + json.dumps(dict(
            shape=[1, 1, 128, 128], logits={k: dict(max_abs_err=e, rel_err=r)
                                           for k, (e, r, _) in logits.items()},
            tol=dict(float32=f32_tol, float64=ZOO_F64_TOL), grads=len(grads["cpu"]),
            grads_out_of_tol=bad, grad_tol=ZOO_F64_TOL, grad_floor=ZOO_GRAD_FLOOR,
            grad_worst=worst, seconds=time.perf_counter() - t0, ok=ok)), flush=True)
        if not ok:
            raise SystemExit(f"{tag} FAILED: {name} on the card disagrees with the CPU")
    return out


def phase11_path(name: str, seed: int, tag: str = "phase11", exact: bool = False,
                 steps: int = ZOO_TRAIN_STEPS) -> dict:
    """(b) `name` at full width on the card: `val_one_epoch` over sliding
    windows of its protocol size (overlap 0.5, two synthetic batches of 8,
    f32 predictor), then the f32 predictor's images/s over
    ZOO_SERVING_REPS batches; `steps` `train_step`s at batch 8
    (finite losses, the last below the first), train images/s over the
    steps after the first, peak memory, and one profiled step's device ms
    and busy share.

    With `exact`, kernels 1-8's launches are counted on each path and must
    be what the model's `kernel_launches_per_forward` implies (none for a
    model without one): one forward per validation batch and per served
    batch, one forward and one backward per train step; forward hooks on
    the Mambas during the first step read the shapes kernels 1/2 are given
    (`mamba_step_shapes`, returned as `mamba_shapes` with the launches)."""
    from mm_unet_tpu_torch.data import synthetic_batch
    from mm_unet_tpu_torch.evaluate import val_one_epoch
    from mm_unet_tpu_torch.train.inferers import SlidingWindowInferer
    from mm_unet_tpu_torch.train.metrics import build_metrics
    from mm_unet_tpu_torch.train.predictor import make_predictor
    from mm_unet_tpu_torch.train.trainer import create_train_state, make_loss_fn, train_step

    size = ZOO_DATA.get(name, ("DRIVE", 512))[1]
    t0 = time.perf_counter()
    flop = zoo_forward_flops(name, seed)
    model = zoo_model(name, seed, "cuda")
    params = sum(p.numel() for p in model.parameters())
    counters = {"mamba_fused_scan": "mamba_fused_scan", "tap_conv": "tap_conv",
                "selective_scan": "selective_scan_chunked"}
    per_forward = (model.kernel_launches_per_forward()
                   if hasattr(model, "kernel_launches_per_forward") else {})

    def reset():
        for fn in kernel_counters():
            fn.launches = fn.bwd_launches = 0

    def want(n_fwd, n_bwd):
        return {**{fn: per_forward.get(k, 0) * n_fwd for k, fn in counters.items()},
                **{f"{fn}_bwd": per_forward.get(k, 0) * n_bwd for k, fn in counters.items()}}

    launches, launches_ok = {}, True
    if exact:
        reset()
    batches = [synthetic_batch(8, size, seed + 9), synthetic_batch(8, size, seed + 10)]
    inferer = SlidingWindowInferer(roi_size=(size, size), overlap=0.5)
    loss_fn = make_loss_fn({"dice_focal_loss": {}}, {"dice_focal_loss": 1.0})
    logits = []

    def infer(images, predictor):
        logits.append(inferer(images, predictor))
        return logits[-1]

    f1, metric, losses = val_one_epoch(model, loss_fn, infer, batches, build_metrics())
    if exact:
        launches["val"] = kernel_launches()
        launches_ok = launches["val"] == want(len(batches), 0)
    finite = all(bool(torch.isfinite(t).all()) for t in logits)
    shapes_ok = [list(t.shape) for t in logits] == [list(b["label"].shape) for b in batches]
    x = torch.from_numpy(batches[0]["image"]).cuda()
    predictor = make_predictor(model)
    inferer(x, predictor)  # warm-up
    if exact:
        reset()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(ZOO_SERVING_REPS):
        served = inferer(x, predictor)
    torch.cuda.synchronize()
    serve_rate = x.shape[0] * ZOO_SERVING_REPS / (time.perf_counter() - t1)
    if exact:
        launches["serve"] = kernel_launches()
        launches_ok = launches_ok and launches["serve"] == want(ZOO_SERVING_REPS, 0)
    finite = finite and bool(torch.isfinite(served).all()) and all(np.isfinite(losses))

    batch = synthetic_batch(8, size, seed + 2)
    x, y = torch.from_numpy(batch["image"]).cuda(), torch.from_numpy(batch["label"]).cuda()
    # lr 1e-3 held constant: warmup 1 epoch of a million steps
    config = {"trainer": dict(lr=1e-3, warmup=1, num_epochs=2, steps_per_epoch=10**6,
                              weight_decay=0.05, optimizer="adamw")}
    state = create_train_state(model, config, seed=seed)
    mamba_shapes, hooks = mamba_step_shapes(model) if exact else ({}, [])
    torch.cuda.reset_peak_memory_stats()
    step_losses, times, step_launches = [], [], []
    for _ in range(steps):
        if exact:
            reset()
        t1 = time.perf_counter()
        scalars, _ = train_step(state, x, y, loss_fn)
        step_losses.append(float(scalars["total_loss"]))  # waits for the step
        times.append(time.perf_counter() - t1)
        for h in hooks:  # the shapes of one step
            h.remove()
        hooks = []
        if exact:
            step_launches.append(kernel_launches())
            launches_ok = launches_ok and step_launches[-1] == want(1, 1)
    peak = torch.cuda.max_memory_allocated()
    if exact:
        launches["train"] = {k: sum(c[k] for c in step_launches) for k in step_launches[0]}
        launches_ok = launches_ok and sum(mamba_shapes.values()) == per_forward.get(
            "mamba_fused_scan", 0)
    train_rate = x.shape[0] * (steps - 1) / sum(times[1:])
    prof = profile_step(f"zoo {name} train", lambda: train_step(state, x, y, loss_fn))
    ok = (finite and shapes_ok and all(map(math.isfinite, step_losses))
          and step_losses[-1] < step_losses[0] and launches_ok)
    if exact:
        launches = dict(per_forward=per_forward, by_path=launches, ok=launches_ok)
    result = dict(size=size, batch=8, params=params, forward_flop=flop,
                  train_tflop_per_s=3 * flop * (steps - 1) / sum(times[1:]) / 1e12,
                  serve_tflop_per_s=flop / 8 * serve_rate / 1e12, val_losses=losses,
                  metrics={k: (v if v == v else None) for k, v in metric.items()},
                  serve_images_per_sec_f32=serve_rate, train_losses=step_losses,
                  step_seconds=times, train_images_per_sec=train_rate,
                  max_memory_allocated_bytes=peak, device_ms=prof["device_ms"],
                  wall_ms=prof["wall_ms"], busy_share=prof["busy_share"],
                  device_launches=prof["launches"], seconds=time.perf_counter() - t0,
                  **({"kernel_launches": launches} if exact else {}))
    print(f"{tag} {name} path " + json.dumps(dict(**result, card=smi(), ok=ok)), flush=True)
    if not ok:
        raise SystemExit(f"{tag} FAILED: {name}'s serving or training path")
    return dict(result, mamba_shapes=mamba_shapes) if exact else result


def phase11_config_models(seed: int) -> None:
    """(c) `give_model_from_config` on config.yml unchanged, for each of its
    nine models, on the card: each builds, and a 1x3x512² forward gives
    (1, 1, 512, 512) finite logits."""
    from mm_unet_tpu_torch.models import give_model_from_config
    from mm_unet_tpu_torch.utils import load_config

    x = torch.from_numpy(np.random.default_rng(seed + 12).standard_normal(
        (1, 3, 512, 512), np.float32)).cuda()
    shapes = {}
    for name in CONFIG_MODELS:
        config = load_config("config.yml")
        config.finetune.model_choose = name
        model = give_model_from_config(config, "cuda", torch.Generator().manual_seed(seed))
        with torch.inference_mode():
            out = model(x)
        shapes[name] = list(out.shape) if bool(torch.isfinite(out).all()) else None
        del model, out
    ok = sorted(load_config("config.yml").models) == sorted(CONFIG_MODELS) and all(
        s == [1, 1, 512, 512] for s in shapes.values())
    print("phase11 config.yml models " + json.dumps(dict(shapes=shapes, ok=ok)), flush=True)
    if not ok:
        raise SystemExit("phase11 FAILED: a model of config.yml does not build or run")


def phase11_cli(seed: int) -> dict:
    """(d) `cli.train.main` for 2 epochs with `model_choose: UNet` at
    config.yml's DRIVE settings (512², batch 4, the synthetic set), then
    `cli.test.main` on its best checkpoint, in a fresh working directory:
    finite step losses, `best` and `checkpoint` written, the test's f1 and
    Dice within 1e-3 of those stored with `best`, epoch 2's
    `Train/images_per_sec`."""
    import os
    import shutil
    import tempfile

    from mm_unet_tpu_torch.cli import test as cli_test
    from mm_unet_tpu_torch.cli import train as cli_train

    home, synth_n = os.getcwd(), os.environ.pop("MMU_SYNTH_N", None)
    work = tempfile.mkdtemp(prefix="mmu_phase11_")
    os.chdir(work)
    try:
        t0 = time.perf_counter()
        rc_train = cli_train.main(cli_config("UNet", 2, model="UNet"), "cuda")
        events = run_scalars("UNet")
        step_losses = [e["Train/total_loss"] for e in events if "Train/total_loss" in e]
        rates = [e["Train/images_per_sec"] for e in events if "Train/images_per_sec" in e]
        files = {f: os.path.exists(os.path.join("model_store", "UNet", f))
                 for f in ("best", "best_meta.json", "checkpoint", "checkpoint_meta.json")}
        with Capture() as out:
            rc_test = cli_test.main(cli_config("UNet", 2, model="UNet"), "cuda")
        got = run_scalars("test_UNet")[-1]
        best = store_meta("UNet", "best")["best_class"] if files["best_meta.json"] else {}
        diffs = {k: abs(got[k] - best[k]) for k in ("Val/mean f1", "Val/mean dice_metric")
                 if k in best}
        ok = (rc_train == 0 and rc_test == 0 and len(step_losses) == 4
              and all(map(math.isfinite, step_losses)) and all(files.values())
              and "loaded best checkpoint" in out.text and len(diffs) == 2
              and max(diffs.values()) <= 1e-3 and len(rates) == 2)
        result = dict(rc=[rc_train, rc_test], step_losses=step_losses, files=files,
                      test_diffs=diffs, tol=1e-3, train_images_per_sec=rates,
                      seconds=time.perf_counter() - t0)
    finally:
        os.chdir(home)
        if synth_n is not None:
            os.environ["MMU_SYNTH_N"] = synth_n
        shutil.rmtree(work, ignore_errors=True)
    print("phase11 cli UNet " + json.dumps(dict(**result, card=smi(), ok=ok)), flush=True)
    if not ok:
        raise SystemExit("phase11 FAILED: the entry points with model_choose UNet")
    return result


def phase11_zoo(seed: int) -> None:
    """Phase 11, (a)-(d); kernels 1-8 must not launch over (a) and (b)."""
    t0 = time.perf_counter()
    for fn in kernel_counters():
        fn.launches = fn.bwd_launches = 0
    card = phase11_card_vs_cpu(seed)
    paths = {name: phase11_path(name, seed) for name in ZOO}
    launches = kernel_launches()
    print("phase11 zoo kernel launches " + json.dumps(dict(
        launches=launches, ok=not any(launches.values()))), flush=True)
    if any(launches.values()):
        raise SystemExit("phase11 FAILED: a zoo model launched a kernel of kernels 1-8")
    phase11_config_models(seed)
    cli = phase11_cli(seed)
    keys = ("serve_images_per_sec_f32", "train_images_per_sec", "max_memory_allocated_bytes",
            "device_ms", "busy_share", "forward_flop", "train_tflop_per_s")
    print("phase11 zoo summary " + json.dumps(dict(
        models={name: {**card[name], **{k: paths[name][k] for k in keys}} for name in ZOO},
        cli_train_images_per_sec=cli["train_images_per_sec"],
        seconds=time.perf_counter() - t0, card=smi())), flush=True)


def phase12_hwaunetr_kernels(seed: int) -> None:
    """(c) HWAUNETR (f32, full width, `ZOO12_KWARGS`) at 2x3x512²: every
    fused-scan call of one train-mode pass held to `mamba_fused_scan_ref` at
    its own inputs and output gradient (`FusedCalls`), then its two Mamba
    routes against each other (`mamba_routes_check`: kernels 1/2 against
    kernels 5/6, logits and every gradient)."""
    from mm_unet_tpu_torch.data import synthetic_batch
    from mm_unet_tpu_torch.train.losses import dice_focal_loss

    model = zoo_model("HWAUNETR", seed, "cuda")
    batch = synthetic_batch(2, 512, seed + 13)
    x, y = torch.from_numpy(batch["image"]).cuda(), torch.from_numpy(batch["label"]).cuda()
    with FusedCalls() as calls:
        dice_focal_loss(model.train()(x), y).backward()
        torch.cuda.synchronize()
    calls_ok = (calls.check("phase12 hwaunetr fused-scan calls", HWA_FUSED_BWD_TOL)
                and len(calls.calls) == 12)
    model.zero_grad(set_to_none=True)
    routes_ok = mamba_routes_check("phase12 hwaunetr routes", model, x, y, HWA_ROUTE_LOGITS_TOL,
                                   HWA_ROUTE_TOL, {})
    if not (calls_ok and routes_ok):
        raise SystemExit("phase12 FAILED: HWAUNETR's fused scans or its two Mamba routes")


def phase12_registry(seed: int) -> None:
    """(e) Every name of the JAX package's registry (18, the CPU tests hold
    the names to it) built through `give_model` on the card, at its
    constructor's defaults: every parameter and buffer on the card."""
    from mm_unet_tpu_torch.models import give_model
    from mm_unet_tpu_torch.models.registry import _constructors

    built = {}
    for name in sorted(_constructors()):
        model = give_model(name, "cuda", torch.Generator().manual_seed(seed))
        tensors = [*model.parameters(), *model.buffers()]
        built[name] = dict(params=sum(p.numel() for p in model.parameters()),
                           on_card=all(t.is_cuda for t in tensors), eval=not model.training)
        del model, tensors
    ok = len(built) == 18 and all(b["on_card"] and b["eval"] for b in built.values())
    print("phase12 registry " + json.dumps(dict(models=built, ok=ok)), flush=True)
    if not ok:
        raise SystemExit("phase12 FAILED: a name of the registry does not build on the card")


# phase 12 (f): the reference checkpoints' widths (`pvt_v2.py`'s b2 and b3:
# dims 64, 128, 320, 512, MLP ratios 8, 8, 4, 4, spatial reductions 8, 4,
# 2, 1; Res2Net-50 v1b 26w 4s), written independently of the port's modules
PVT_V2_DIMS = (64, 128, 320, 512)
PVT_V2_MLPS = (8, 8, 4, 4)
PVT_V2_SRS = (8, 4, 2, 1)
PVT_V2_DEPTHS = {"pvt_v2_b2": (3, 4, 6, 3), "pvt_v2_b3": (3, 4, 18, 3)}
RES2NET50_BLOCKS = (3, 4, 6, 3)
# (model, its config section, the file its section names, the module that
# takes it): FCBFormer's backbone is the b3's children in a Sequential
WARM_MODELS = (("FCBFormer", "FCBFormer", "pvt_v2_b3", "TB.backbone"),
               ("DuAT", "duat", "pvt_v2_b2", "backbone"))


def reference_pvt_v2_state_dict(rng, depths) -> dict:
    """A reference `pvt_v2.py` state_dict at `depths`, with its classifier
    head, drawn from `rng` (norm weights about 1)."""
    sd = {}

    def put(name, *shape):
        module, param = name.rsplit(".", 1)
        norm = param == "weight" and module.rsplit(".", 1)[-1].startswith("norm")
        v = rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)
        sd[name] = torch.from_numpy(v + np.float32(norm))

    def linear(name, cout, *cin):
        put(f"{name}.weight", cout, *cin)
        put(f"{name}.bias", cout)

    cin = 3
    for i, (c, r, sr) in enumerate(zip(PVT_V2_DIMS, PVT_V2_MLPS, PVT_V2_SRS)):
        k = 7 if i == 0 else 3
        linear(f"patch_embed{i + 1}.proj", c, cin, k, k)
        linear(f"patch_embed{i + 1}.norm", c)
        for j in range(depths[i]):
            b = f"block{i + 1}.{j}"
            linear(f"{b}.norm1", c)
            linear(f"{b}.attn.q", c, c)
            linear(f"{b}.attn.kv", 2 * c, c)
            linear(f"{b}.attn.proj", c, c)
            if sr > 1:
                linear(f"{b}.attn.sr", c, c, sr, sr)
                linear(f"{b}.attn.norm", c)
            linear(f"{b}.norm2", c)
            linear(f"{b}.mlp.fc1", c * r, c)
            linear(f"{b}.mlp.dwconv.dwconv", c * r, 1, 3, 3)
            linear(f"{b}.mlp.fc2", c, c * r)
        linear(f"norm{i + 1}", c)
        cin = c
    linear("head", 1000, PVT_V2_DIMS[-1])
    return sd


def reference_res2net50_state_dict(rng) -> dict:
    """A reference Res2Net-50 v1b (26w, 4s) state_dict with BatchNorm
    running statistics, `num_batches_tracked` and the classifier, drawn from
    `rng`."""
    sd = {}

    def w(name, *shape):
        sd[name] = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                    * np.float32(0.02))

    def bn(name, c):
        w(f"{name}.weight", c)
        sd[f"{name}.weight"] += 1.0
        w(f"{name}.bias", c)
        w(f"{name}.running_mean", c)
        sd[f"{name}.running_var"] = torch.from_numpy(
            rng.uniform(0.5, 2.0, c).astype(np.float32))
        sd[f"{name}.num_batches_tracked"] = torch.tensor(1000, dtype=torch.int64)

    w("conv1.0.weight", 32, 3, 3, 3)
    bn("conv1.1", 32)
    w("conv1.3.weight", 32, 32, 3, 3)
    bn("conv1.4", 32)
    w("conv1.6.weight", 64, 32, 3, 3)
    bn("bn1", 64)
    cin = 64
    for i, (n, planes) in enumerate(zip(RES2NET50_BLOCKS, (64, 128, 256, 512))):
        width = planes * 26 // 64
        for j in range(n):
            b = f"layer{i + 1}.{j}"
            w(f"{b}.conv1.weight", 4 * width, cin, 1, 1)
            bn(f"{b}.bn1", 4 * width)
            for s in range(3):
                w(f"{b}.convs.{s}.weight", width, width, 3, 3)
                bn(f"{b}.bns.{s}", width)
            w(f"{b}.conv3.weight", 4 * planes, 4 * width, 1, 1)
            bn(f"{b}.bn3", 4 * planes)
            if j == 0:
                w(f"{b}.downsample.1.weight", 4 * planes, cin, 1, 1)
                bn(f"{b}.downsample.2", 4 * planes)
            cin = 4 * planes
    w("fc.weight", 1000, 2048)
    w("fc.bias", 1000)
    return sd


def reference_named(backbone: torch.nn.Module) -> dict:
    """A PVTv2's tensors under the reference's names; in FCBFormer's
    Sequential of its children, child 3i + s is stage i + 1's patch_embed,
    block, norm (s = 0, 1, 2)."""
    if not isinstance(backbone, torch.nn.Sequential):
        return backbone.state_dict()
    return {f"{('patch_embed', 'block', 'norm')[k % 3]}{k // 3 + 1}.{name}": t
            for k, child in enumerate(backbone) for name, t in child.state_dict().items()}


def warm_config(name: str, section: str, path: str):
    """A config choosing `name` whose section names `path` as `model_dir`
    (empty: no file), at the polyp sets' 352², lr 1e-3 held."""
    from mm_unet_tpu_torch.utils import ConfigDict

    return ConfigDict(
        finetune=dict(model_choose=name, checkpoint=name),
        trainer=dict(dataset_choose="Kvasir_SEG", lr=1e-3, warmup=1, num_epochs=2,
                     steps_per_epoch=10**6, weight_decay=0.05, optimizer="adamw"),
        dataset={"Kvasir_SEG": dict(image_size=352)},
        models={section: dict(branch1=dict(model_dir=path))})


def warm_checks(model, plain, prefix: str, tensors: dict, sd: dict, printed: str) -> dict:
    """`model` warm-started from `sd` into its module at `prefix` (whose
    tensors under the reference's names are `tensors`), against `plain`,
    built from the same generator without the file: every tensor the file
    holds at its shape equal to the file's, every other the plain model's,
    and the count `warm_start` printed equal to the reference names the
    module holds."""
    import re

    mapped = {k: v for k, v in tensors.items() if k in sd and sd[k].shape == v.shape}
    file_ok = all(torch.equal(v, sd[k].to(v.device)) for k, v in mapped.items())
    ours = {f"{prefix}.{k}" for k in model.get_submodule(prefix).state_dict()}
    theirs = plain.state_dict()
    rest = {k: v for k, v in model.state_dict().items() if k not in ours}
    rest_ok = all(torch.equal(v, theirs[k]) for k, v in rest.items())
    counts = [int(n) for n in re.findall(r"warm_start: loaded (\d+) tensors", printed)]
    on_card = all(t.is_cuda for t in [*model.parameters(), *model.buffers()])
    return dict(loaded=counts, mapped=len(mapped), file_equal=file_ok, others=len(rest),
                others_equal=rest_ok, on_card=on_card,
                ok=file_ok and rest_ok and on_card and counts == [len(mapped)] and len(mapped) > 0)


def phase12_warm_start(seed: int) -> dict:
    """(f) The backbone warm start from reference checkpoints on the card:
    a full-width `pvt_v2_b2`, `pvt_v2_b3` and Res2Net-50 v1b state_dict
    drawn from a numpy seed into a temporary directory; FCBFormer (b3,
    352²) and DuAT (b2) through `give_model_from_config` with their
    sections' `model_dir` naming the file, and `create_train_state`
    (`warm_checks`: the backbone bit for bit the file's, the count, the rest
    a model built without the file), then one `train_step` at batch 4
    (finite loss); `warm_start` on CFANet, whose Res2Net50Encoder takes the
    Res2Net file with its running statistics (`num_batches_tracked` left
    alone)."""
    import os
    import tempfile

    from mm_unet_tpu_torch.data import synthetic_batch
    from mm_unet_tpu_torch.models import give_model, give_model_from_config
    from mm_unet_tpu_torch.train.trainer import create_train_state, make_loss_fn, train_step
    from mm_unet_tpu_torch.utils.torch_convert import warm_start

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 17)
    loss_fn = make_loss_fn({"dice_focal_loss": {}}, {"dice_focal_loss": 1.0})
    batch = synthetic_batch(4, 352, seed + 18)
    x, y = torch.from_numpy(batch["image"]).cuda(), torch.from_numpy(batch["label"]).cuda()
    results = {}
    with tempfile.TemporaryDirectory(prefix="mmu_phase12f_") as tmp:
        files = {}
        for ref, depths in PVT_V2_DEPTHS.items():
            files[ref] = (os.path.join(tmp, f"{ref}.pth"), reference_pvt_v2_state_dict(rng, depths))
        files["res2net50"] = (os.path.join(tmp, "res2net50_v1b_26w_4s.pth"),
                              reference_res2net50_state_dict(rng))
        for path, sd in files.values():
            torch.save(sd, path)
        for name, section, ref, prefix in WARM_MODELS:
            path, sd = files[ref]
            model = give_model_from_config(warm_config(name, section, path), "cuda",
                                           torch.Generator().manual_seed(seed))
            plain = give_model_from_config(warm_config(name, section, ""), "cuda",
                                           torch.Generator().manual_seed(seed))
            with Capture() as out:
                state = create_train_state(model, warm_config(name, section, path), seed=seed)
            tensors = reference_named(model.get_submodule(prefix))
            r = warm_checks(model, plain, prefix, tensors, sd, out.text)
            r["backbone_tensors"] = len(tensors)
            r["ok"] = r["ok"] and r["mapped"] == len(tensors) == len(sd) - 2  # all but the head
            del plain
            scalars, _ = train_step(state, x, y, loss_fn)
            r["loss"] = float(scalars["total_loss"])
            r["ok"] = r["ok"] and math.isfinite(r["loss"])
            results[name] = r
            del model, state
        path, sd = files["res2net50"]
        model = give_model("CFANet", "cuda", torch.Generator().manual_seed(seed))
        plain = give_model("CFANet", "cuda", torch.Generator().manual_seed(seed))
        with Capture() as out:
            warm_start(model, warm_config("CFANet", "cfa_net", path))
        tensors = model.resnet.state_dict()
        r = warm_checks(model, plain, "resnet", {k: v for k, v in tensors.items()
                                                 if not k.endswith("num_batches_tracked")},
                        sd, out.text)
        tracked = [k for k in tensors if k.endswith("num_batches_tracked")]
        r["num_batches_tracked_as_built"] = all(
            torch.equal(tensors[k], plain.resnet.state_dict()[k]) for k in tracked)
        r["ok"] = (r["ok"] and r["num_batches_tracked_as_built"]
                   and r["mapped"] == len(tensors) - len(tracked) == len(sd) - 2 - len(tracked))
        results["CFANet"] = r
        del model, plain
    torch.cuda.empty_cache()
    ok = all(r["ok"] for r in results.values())
    seconds = time.perf_counter() - t0
    print("phase12 warm start " + json.dumps(dict(models=results, seconds=seconds, card=smi(),
                                                  ok=ok)), flush=True)
    if not ok:
        raise SystemExit("phase12 FAILED: the backbone warm start")
    return dict(seconds=seconds, **{n: r["loaded"] for n, r in results.items()})


def phase12_zoo(seed: int) -> dict:
    """Phase 12, (a)-(e): the JAX registry's last seven models. (a) card vs
    CPU (`phase11_card_vs_cpu`); (b) each one's serving and training path
    (`phase11_path`) with exact launches of kernels 1-8: HWAUNETR's 12
    kernel-1 launches per forward and 12 kernel-2 launches per train step,
    (d) none for the other six; (c) kernels 1/2 at every shape of
    HWAUNETR's train step against the plain version (`phase1_step_shapes`,
    checked), every fused-scan call of a train-mode pass, its two routes;
    (e) the registry. Returns HWAUNETR's launches and step shapes' records
    for the `kernels` line."""
    t0 = time.perf_counter()
    card = phase11_card_vs_cpu(seed, ZOO12, "phase12")
    paths = {name: phase11_path(name, seed, "phase12", exact=True, steps=ZOO12_TRAIN_STEPS)
             for name in ZOO12}
    hwa = paths["HWAUNETR"]
    fwd, bwd = phase1_step_shapes(hwa["mamba_shapes"], seed, "phase12", check=True)
    phase12_hwaunetr_kernels(seed)
    phase12_registry(seed)
    warm = phase12_warm_start(seed)
    keys = ("serve_images_per_sec_f32", "train_images_per_sec", "max_memory_allocated_bytes",
            "device_ms", "busy_share", "forward_flop", "train_tflop_per_s")
    print("phase12 zoo summary " + json.dumps(dict(
        models={name: {**card[name], **{k: paths[name][k] for k in keys}} for name in ZOO12},
        hwaunetr_launches=hwa["kernel_launches"], warm_start=warm,
        seconds=time.perf_counter() - t0,
        card=smi())), flush=True)
    return {"launches": hwa["kernel_launches"], "fwd_steps": fwd, "bwd_steps": bwd}


# phase 13: the parallel family at world size 1 on the card (one H100 holds
# one NCCL rank; the multi-rank arithmetic is the CPU tests'), then the
# last tools
# (B, Dm, N, L) of the sequence-parallel scan: the LM's scoring width, the
# whole sequence and one of two shards
SP_SHAPES = ((4, 1536, 16, 2048), (4, 1536, 16, 1024))
# phase 13 (a)'s step losses against phase 9's, relative: the first step
# (the same arithmetic but BatchNorm's moments as sums over the group); the
# second, after an AdamW step, where the bf16 trajectory is chaotic: phase
# 9's own second loss moved by 3.3e-3 between two calls on the same code
# (1.14873, 1.15249) and phase 13's read 8.2e-3 from it in its first call
DP_LOSS_TOL = (1e-5, 2e-2)
# the pipelined 24-layer LM against the same model run straight through:
# microbatches of one sequence take other GEMM algorithms than a batch of
# four; gradients as ||pp - seq|| / ||seq|| per tensor
PP_TOL = LM_CPU_TOL
PP_GRAD_TOL = 1e-3
EP_SHAPE = (4, 512)  # tokens of the Switch FFN: batch, length
EP_WIDTHS = dict(d_model=768, d_ff=3072, n_experts=8)


def free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def phase13_dp(seed: int, p9: dict) -> dict:
    """(a) `cli.train.main` under a one-rank NCCL group, the environment
    torchrun gives a rank (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT): phase 9's configuration (config.yml's DRIVE run, MM_Net
    bf16 with remat at 512², batch 4) for one epoch with ZeRO-1 on. Its
    step losses against phase 9's first two, kernels 1-4 launched exactly
    half of phase 9's two epochs, train images/s and peak memory beside
    phase 9's. Returns the launches."""
    import os
    import shutil
    import tempfile

    import torch.distributed as dist

    from mm_unet_tpu_torch.cli import train as cli_train
    from mm_unet_tpu_torch.parallel.zero import ZeroAdamW

    train_fn, val_fn = cli_train.train_one_epoch, cli_train.val_one_epoch
    seen = {}

    def counted_val(*args, **kwargs):
        before = kernel_launches()
        out = val_fn(*args, **kwargs)
        seen["val"] = {k: v - before[k] for k, v in kernel_launches().items()}
        return out

    def seen_train(state, *args, **kwargs):
        seen["zero1"] = isinstance(state.optimizer, ZeroAdamW)
        seen["dp"] = None if state.dp is None else [state.dp.rank, state.dp.world]
        seen["backend"] = dist.get_backend()
        return train_fn(state, *args, **kwargs)

    env = {"RANK": "0", "LOCAL_RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(free_port())}
    saved = {k: os.environ.get(k) for k in (*env, "MMU_SYNTH_N")}
    home, work = os.getcwd(), tempfile.mkdtemp(prefix="mmu_phase13_")
    os.chdir(work)
    os.environ.pop("MMU_SYNTH_N", None)
    os.environ.update(env)
    try:
        cfg = cli_config("MM_Net_dp", 1)
        cfg.trainer.zero1 = True
        cli_train.val_one_epoch, cli_train.train_one_epoch = counted_val, seen_train
        for fn in kernel_counters():
            fn.launches = fn.bwd_launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rc = cli_train.main(cfg, "cuda")
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        total = kernel_launches()
        events = run_scalars("MM_Net_dp")
        files = sorted(os.listdir(os.path.join("model_store", "MM_Net_dp")))
    finally:
        cli_train.val_one_epoch, cli_train.train_one_epoch = val_fn, train_fn
        os.chdir(home)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(work, ignore_errors=True)
    val = seen["val"]
    train = {k: v - val[k] for k, v in total.items()}
    want_train = {k: p9["train"].get(k, 0) // 2 for k in train}
    want_val = {k: p9["val"].get(k, 0) // 2 for k in val}
    losses = [e["Train/total_loss"] for e in events if "Train/total_loss" in e]
    rates = [e["Train/images_per_sec"] for e in events if "Train/images_per_sec" in e]
    diffs = [abs(a - b) / abs(b) for a, b in zip(losses, p9["step_losses"])]
    ok = (rc == 0 and seen["zero1"] and seen["dp"] == [0, 1] and seen["backend"] == "nccl"
          and len(losses) == 2 and all(d <= t for d, t in zip(diffs, DP_LOSS_TOL))
          and train == want_train and val == want_val and not dist.is_initialized()
          and "checkpoint" in files)
    print("phase13 dp " + json.dumps(dict(
        rc=rc, zero1=seen["zero1"], rank_world=seen["dp"], backend=seen["backend"],
        step_losses=losses, phase9_step_losses=p9["step_losses"][:2], rel_diffs=diffs,
        tol=DP_LOSS_TOL, launches=dict(train=train, val=val),
        expected=dict(train=want_train, val=want_val), files=files,
        train_images_per_sec=rates, phase9_train_images_per_sec=p9["rates"],
        max_memory_allocated_bytes=peak, phase9_max_memory_allocated_bytes=p9["max_memory"],
        seconds=seconds, card=smi(), ok=ok)), flush=True)
    if not ok:
        raise SystemExit("phase13 FAILED: dp")
    return {"train": train, "val": val}


def phase13_sp(seed: int) -> dict:
    """(b) Kernels 7/8 at the sequence-parallel scan's shapes (SP_SHAPES):
    the bare scan with its differentiable last state against autograd of
    the plain scan, values and every gradient with a random gradient of the
    last state (kernel 8's `dlast` seed), and kernel 8 alone with and
    without the seed, in turns; then `selective_scan_sp` at world size 1
    through them, and the public `selective_scan`'s last state, which takes
    no gradient. Returns the records and the launches."""
    import torch.nn.functional as F

    from mm_unet_tpu_torch.ops import chunked_scan as cs
    from mm_unet_tpu_torch.ops.selective_scan import selective_scan, selective_scan_ref
    from mm_unet_tpu_torch.parallel.sp import selective_scan_sp

    dev, f32 = torch.device("cuda"), torch.float32
    gen = torch.Generator().manual_seed(seed + 130)

    def rn(*sh, scale=1.0):
        return (torch.randn(*sh, generator=gen) * scale).to(dev)

    recs, failed = [], []
    for B, Dm, N, L in SP_SHAPES:
        u, delta = rn(B, Dm, L), F.softplus(rn(B, Dm, L, scale=0.5) - 4.0)
        A = -torch.exp(torch.log(torch.arange(1, N + 1.0, device=dev)).repeat(Dm, 1))
        Bm, Cm, wy, wh = rn(B, N, L), rn(B, N, L), rn(B, Dm, L), rn(B, Dm, N)
        ins = [t.clone().requires_grad_() for t in (u, delta, A, Bm, Cm)]
        y, h = cs.selective_scan_chunked_last(*ins)
        ((y * wy).sum() + (h * wh).sum()).backward()
        ref = [t.clone().requires_grad_() for t in (u, delta, A, Bm, Cm)]
        yr, hr = selective_scan_ref(*ref, return_last_state=True)
        ((yr * wy).sum() + (hr * wh).sum()).backward()
        torch.cuda.synchronize()
        errs = {"y": rel_err(y, yr), "last": rel_err(h, hr)}
        errs.update({f"d{n}": rel_err(a.grad, b.grad)
                     for n, a, b in zip(("u", "delta", "A", "B", "C"), ins, ref)})
        ok = (errs["y"][1] <= TOL[f32] and errs["last"][1] <= TOL[f32]
              and all(e[1] <= BWD_TOL[f32] for k, e in errs.items() if k.startswith("d")))
        del y, h, yr, hr, ins, ref

        def plain():
            p = [t.clone().requires_grad_() for t in (u, delta, A, Bm, Cm)]
            a, b = selective_scan_ref(*p, return_last_state=True)
            ((a * wy).sum() + (b * wh).sum()).backward()

        plan = cs._plan(u, A, Bm, Cm)
        with torch.no_grad():
            _, state, dtsum, _ = cs._launch_fwd(u, delta, None, A, Bm, Cm, None, None, False,
                                                True, plan)

        def bwd(dlast):
            return cs._launch_bwd(wy, u, delta, None, A, Bm, Cm, None, None, state, dtsum,
                                  False, plan, dlast)

        # in turns: without, with, with, without
        t = [cuda_ms(lambda: bwd(None), reps=10), cuda_ms(lambda: bwd(wh), reps=10),
             cuda_ms(lambda: bwd(wh), reps=10), cuda_ms(lambda: bwd(None), reps=10)]
        nbytes, ops = scan_work(B, Dm, L, N, 1, 4, 4, 2, True)
        bms, by = bound(nbytes + 4 * B * Dm * N, ops)
        rec = dict(B=B, Dm=Dm, N=N, L=L, dtype="float32", max_abs_err=max(e[0] for e in errs.values()),
                   rel_errs={k: e[1] for k, e in errs.items()}, tol=TOL[f32], bwd_tol=BWD_TOL[f32],
                   bwd_ms_with_dlast=(t[1] + t[2]) / 2, bwd_ms_without_dlast=(t[0] + t[3]) / 2,
                   turns_ms=t, plain_fwd_bwd_ms=cuda_ms(plain, reps=1), bound_ms=bms, bound_by=by)
        print(f"phase13 sp kernel {json.dumps(dict(rec, card=smi(), ok=ok))}", flush=True)
        recs.append(rec)
        failed.extend([] if ok else [f"sp kernel L {L}"])
        del state, dtsum

    # selective_scan_sp at world size 1 through kernels 7/8, counted from zero
    B, Dm, N, L = SP_SHAPES[0]
    u, delta = rn(B, Dm, L), rn(B, Dm, L, scale=0.5)
    A = -torch.exp(torch.log(torch.arange(1, N + 1.0, device=dev)).repeat(Dm, 1))
    Bm, Cm, D, z, bias = rn(B, N, L), rn(B, N, L), rn(Dm), rn(B, Dm, L), rn(Dm, scale=0.1) - 4.0
    w = rn(B, Dm, L)
    ins = [t.clone().requires_grad_() for t in (u, delta, A, Bm, Cm, D, z, bias)]
    cs.selective_scan_chunked.launches = cs.selective_scan_chunked.bwd_launches = 0
    out = selective_scan_sp(*ins[:7], delta_bias=ins[7], delta_softplus=True)
    (out * w).sum().backward()
    torch.cuda.synchronize()
    launches = {"fwd": cs.selective_scan_chunked.launches,
                "bwd": cs.selective_scan_chunked.bwd_launches}
    with torch.no_grad():
        want = selective_scan_ref(u, delta, A, Bm, Cm, D, z, bias, delta_softplus=True)
    err, rel, ok_v = compare(out.detach(), want, f32)
    _, last = selective_scan(u, delta, A, Bm, Cm, return_last_state=True)
    ok = (launches == {"fwd": 1, "bwd": 1} and ok_v and not last.requires_grad
          and all(torch.isfinite(t.grad).all() for t in ins))
    print("phase13 sp " + json.dumps(dict(
        B=B, Dm=Dm, N=N, L=L, launches=launches, max_abs_err=err, rel_err=rel, tol=TOL[f32],
        public_last_state_requires_grad=last.requires_grad, card=smi(), ok=ok)), flush=True)
    failed.extend([] if ok else ["sp world 1"])
    if failed:
        raise SystemExit(f"phase13 FAILED: {failed}")
    return {"kernel": recs, "launches": launches}


def phase13_tp(seed: int) -> dict:
    """(c) A Block at mamba-130m's widths (d_model 768, RMSNorm, fused
    add+norm, d_state 16) on route b (`scan_impl="pallas"`), split by
    `shard_params` over the one-rank group: one forward and backward at
    2 x 2048 tokens, kernels 5/6 launched once each, its output and every
    gradient against the unsplit module's. Returns the launches."""
    from mm_unet_tpu_torch.models.mamba import Block
    from mm_unet_tpu_torch.ops.chunked_scan import selective_scan_chunked
    from mm_unet_tpu_torch.parallel.tp import shard_params

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(seed + 131)
    blk = Block(768, 1e-5, rms_norm=True, fused_add_norm=True,
                mamba_kwargs={"d_state": 16, "scan_impl": "pallas"}, generator=g).to(dev)
    whole = copy.deepcopy(blk)
    shard_params(blk)
    x = (torch.randn(2, 2048, 768, generator=g) * 0.5).to(dev)
    w = torch.randn(2, 2048, 768, generator=g).to(dev)
    selective_scan_chunked.launches = selective_scan_chunked.bwd_launches = 0
    h, res = blk(x)
    (h * w).sum().backward()
    torch.cuda.synchronize()
    launches = {"fwd": selective_scan_chunked.launches, "bwd": selective_scan_chunked.bwd_launches}
    h2, _ = whole(x)
    (h2 * w).sum().backward()
    torch.cuda.synchronize()
    errs = {"out": rel_err(h, h2)}
    errs.update({k: rel_err(p.grad, dict(whole.named_parameters())[k].grad)
                 for k, p in blk.named_parameters()})
    ok = (launches == {"fwd": 1, "bwd": 1} and blk.mixer.tp is not None
          and all(e[1] <= TOL[torch.float32] for e in errs.values()))
    worst = max(errs.items(), key=lambda kv: kv[1][1])
    print("phase13 tp " + json.dumps(dict(
        d_model=768, tokens=[2, 2048], launches=launches, out_rel_err=errs["out"][1],
        worst=[worst[0], worst[1][1]], tol=TOL[torch.float32], card=smi(), ok=ok)), flush=True)
    if not ok:
        raise SystemExit("phase13 FAILED: tp")
    return launches


def phase13_pp(seed: int) -> dict:
    """(d) `mixer_pipeline_forward` at one stage and 4 microbatches of
    phase 10's scoring batch (4 x 2048): mamba-130m's 24-layer MixerModel
    (d_model 768, f32) forward, exactly 24 kernel-1 launches per
    microbatch, its output against the model run straight through; then
    the same 24 layers forward and backward, 24 kernel-1 and 24 kernel-2
    launches per microbatch (kernel 2 at D 1536 splits each chunk's
    channels over a cluster of blocks), output and the gradients of the
    embedding and of the first and last Blocks' in_proj against the model
    straight through. Returns the launches."""
    from mm_unet_tpu_torch.models.lm import MAMBA_130M, give_lm
    from mm_unet_tpu_torch.ops.mamba_fused import mamba_fused_scan
    from mm_unet_tpu_torch.parallel.pp import mixer_pipeline_forward

    dev, (B, L), M = torch.device("cuda"), LM_SCORE, 4
    d_model = MAMBA_130M["d_model"]
    rng = np.random.default_rng(seed + 132)
    ids = torch.from_numpy(rng.integers(0, MAMBA_130M["vocab_size"], (B, L))).to(dev)
    out, failed = {}, []
    backbone = give_lm(MAMBA_130M, device="cuda",
                       generator=torch.Generator().manual_seed(seed)).backbone
    w = torch.from_numpy(rng.standard_normal((B, L, d_model)).astype(np.float32)).to(dev)
    names = ("embedding.weight", "layers.0.mixer.in_proj.weight", "layers.23.mixer.in_proj.weight")
    params = dict(backbone.named_parameters())
    for path, train in (("forward", False), ("train", True)):
        backbone.zero_grad(set_to_none=True)
        mamba_fused_scan.launches = mamba_fused_scan.bwd_launches = 0
        t0 = time.perf_counter()
        with torch.set_grad_enabled(train):
            y = mixer_pipeline_forward(backbone, ids, num_microbatches=M)
            fwd = mamba_fused_scan.launches
            if train:
                (y * w).sum().backward()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {"fwd": fwd, "bwd": mamba_fused_scan.bwd_launches}
        got = {k: params[k].grad.clone() for k in names} if train else {}
        y_pp = y.detach()
        del y
        backbone.zero_grad(set_to_none=True)
        with torch.set_grad_enabled(train):
            y2 = backbone(ids)
            if train:
                (y2 * w).sum().backward()
        torch.cuda.synchronize()
        err, rel = rel_err(y_pp, y2.detach())
        gerr = {k: ((got[k] - params[k].grad).norm() / params[k].grad.norm()).item()
                for k in got}
        want = {"fwd": 24 * M, "bwd": 24 * M if train else 0}
        ok = launches == want and rel <= PP_TOL and all(v <= PP_GRAD_TOL for v in gerr.values())
        print("phase13 pp " + json.dumps(dict(
            d_model=d_model, n_layer=24, backward=train, stages=1, microbatches=M,
            batch=[B, L], launches=launches, expected=want, max_abs_err=err, rel_err=rel,
            tol=PP_TOL, grad_rel_norm_errs=gerr, grad_tol=PP_GRAD_TOL, seconds=seconds,
            card=smi(), ok=ok)), flush=True)
        failed.extend([] if ok else [path])
        out[path] = launches
        del y2, y_pp
    del backbone
    if failed:
        raise SystemExit(f"phase13 FAILED: pp {failed}")
    return {"fwd": out["forward"]["fwd"] + out["train"]["fwd"], "bwd": out["train"]["bwd"],
            "by_path": out}


def phase13_ep_tools(seed: int) -> None:
    """(e) `SwitchFFN` at d_model 768, 8 experts, split by
    `shard_moe_params` over the one-rank group, against the unsplit module
    (output, aux), with its time; `cli.weight_test` on UNet and CFPNet;
    `cli.visualize` on config.yml's DRIVE run (MM_Net at init, the
    synthetic validation set's two 512² images), its PNGs read back."""
    import os
    import shutil
    import tempfile

    from mm_unet_tpu_torch.cli import visualize, weight_test
    from mm_unet_tpu_torch.parallel.ep import SwitchFFN, shard_moe_params

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(seed + 133)
    ffn = SwitchFFN(**EP_WIDTHS, generator=g).to(dev)
    whole = copy.deepcopy(ffn)
    shard_moe_params(ffn)
    x = torch.randn(*EP_SHAPE, EP_WIDTHS["d_model"], generator=g).to(dev)
    with torch.no_grad():
        (y, aux), (y2, aux2) = ffn(x), whole(x)
        ms = cuda_ms(lambda: ffn(x), reps=10)
    err, rel = rel_err(y, y2)
    ok = (bool(torch.isfinite(y).all()) and rel <= TOL[torch.float32]
          and abs(aux.item() - aux2.item()) <= 1e-6 and ffn.ep is not None)
    print("phase13 ep " + json.dumps(dict(**EP_WIDTHS, tokens=list(EP_SHAPE), rel_err=rel,
                                          aux=aux.item(), ms=ms, card=smi(), ok=ok)), flush=True)
    if not ok:
        raise SystemExit("phase13 FAILED: ep")

    profiles = {n: weight_test.profile(n, weight_test.ZOO[n], "cuda") for n in ("UNet", "CFPNet")}
    ok = all(p["params"] > 0 and p["flops"] > 0 and p["images_per_sec"] > 0
             for p in profiles.values())
    print("phase13 weight_test " + json.dumps(dict(profiles=profiles, card=smi(), ok=ok)),
          flush=True)
    if not ok:
        raise SystemExit("phase13 FAILED: weight_test")

    home, work = os.getcwd(), tempfile.mkdtemp(prefix="mmu_phase13_vis_")
    os.chdir(work)
    try:
        cfg = cli_config("MM_Net_vis", 1)
        cfg.visualization = {"save_dir": "vis"}
        t0 = time.perf_counter()
        rc = visualize.main(cfg, "cuda")
        pngs = sorted(os.listdir("vis"))
        shapes = {f: list(visualize.read_png(os.path.join("vis", f)).shape) for f in pngs}
    finally:
        os.chdir(home)
        shutil.rmtree(work, ignore_errors=True)
    want = sorted(f"{i}_{k}.png" for i in range(2) for k in ("mask", "error", "contour"))
    ok = rc == 0 and pngs == want and all(s[:2] == [512, 512] for s in shapes.values())
    print("phase13 visualize " + json.dumps(dict(rc=rc, pngs=shapes,
                                                 seconds=time.perf_counter() - t0, card=smi(),
                                                 ok=ok)), flush=True)
    if not ok:
        raise SystemExit("phase13 FAILED: visualize")


def phase13(seed: int, p9: dict) -> dict:
    """Phase 13: (a) data parallelism through `cli.train`; then, in a
    one-rank NCCL group, (b) sequence, (c) tensor, (d) pipeline and (e)
    expert parallelism and the tools. Returns each path's launches."""
    import torch.distributed as dist

    dp = phase13_dp(seed, p9)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1)
    try:
        sp = phase13_sp(seed)
        tp = phase13_tp(seed)
        pp = phase13_pp(seed)
        phase13_ep_tools(seed)
    finally:
        dist.destroy_process_group()
    return {"dp": dp, "sp": sp, "tp": tp, "pp": pp}


def profile_step(path: str, step) -> dict:
    """One profiled call of `step` (already warm): device time by layer and
    the top kernels, the share of the wall time in which some device
    operation ran (the union of their intervals, read by the benchmark's
    `portbench/harness/trace.py::Trace`), and the intervals of the port's
    spans (`utils/spans.py`) by name, in ms from the trace's first event
    (printed; returns wall_ms, device_ms, busy_share and launches)."""
    from torch.profiler import ProfilerActivity, profile

    from mm_unet_tpu_torch.utils.spans import NAMES
    from portbench.harness.trace import Trace, group_of

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    trace = Trace(prof, wall_s)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    events = prof.events()
    origin = min(e.time_range.start for e in events)
    spans: dict[str, list] = {}
    for e in events:
        if e.name in NAMES:
            spans.setdefault(e.name, []).append(
                [(e.time_range.start - origin) / 1e3, (e.time_range.end - origin) / 1e3])
    numbers = dict(wall_ms=wall_s * 1e3, device_ms=sum(trace.group_ms.values()),
                   busy_share=trace.busy_s / wall_s, launches=trace.launches)
    print(f"profile {path} " + json.dumps(dict(
        **numbers, by_layer_ms=dict(sorted(trace.group_ms.items(), key=lambda kv: -kv[1])),
        top_kernels=[dict(name=e.key[:90], group=group_of(e.key),
                          ms=e.self_device_time_total / 1e3, calls=e.count) for e in top],
        spans_ms={k: sorted(v) for k, v in spans.items()},
        card=smi())), flush=True)
    return numbers


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also profile one bf16 sliding-window pass and one train step of "
                         "MM_Net, one route-b train step of dkDualNet and one train step of "
                         "UM_Net (device time by layer)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this run needs the GPU")
    from mm_unet_tpu_torch import _build

    print(smi(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}; TF32 off for matmul and cuDNN", flush=True)
    t0 = time.perf_counter()
    lib = _build.build()
    print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)

    gen = torch.Generator().manual_seed(args.seed)
    t_all = time.perf_counter()
    k = phase1_kernels(gen)
    k.update(phase1_backward(gen))
    k.update(phase1_scan(gen))
    print(f"phase1 done at {time.perf_counter() - t_all:.1f} s", flush=True)
    phase2_model(args.seed)
    phase2_gradients(args.seed)
    phase2_bf16_gradients(args.seed)
    serve = phase3_serving(args.seed, args.profile)
    train, shapes, tap_shapes = phase4_training(args.seed, args.profile)
    print(f"phases 2-4 done at {time.perf_counter() - t_all:.1f} s", flush=True)
    fwd_steps, bwd_steps = phase1_step_shapes(shapes, args.seed)
    tap_fwd_steps, tap_bwd_steps = phase1_tap_step_shapes(tap_shapes, args.seed)
    print(f"phase1 step shapes done at {time.perf_counter() - t_all:.1f} s", flush=True)
    phase5_dkdualnet(args.seed)
    dk, scan_shapes = phase6_dkdualnet_path(args.seed, args.profile)
    phase7_mm_routes(args.seed)
    print(f"phases 5-7 done at {time.perf_counter() - t_all:.1f} s", flush=True)
    scan_fwd_steps, scan_bwd_steps = phase1_scan_step_shapes(scan_shapes, args.seed)
    print(f"phase1 scan step shapes done at {time.perf_counter() - t_all:.1f} s", flush=True)
    phase8_um_card_vs_cpu(args.seed)
    phase8_um_routes(args.seed)
    um_counts, um, um_shapes, um_tap_shapes = phase8_um_path(args.seed, args.profile)
    um_fwd, um_bwd = phase1_step_shapes(um_shapes, args.seed, "phase8")
    um_tap_fwd, um_tap_bwd = phase1_tap_step_shapes(um_tap_shapes, args.seed, "phase8",
                                                    check=True)
    print(f"phase8 done at {time.perf_counter() - t_all:.1f} s", flush=True)
    cli = phase9_cli(args.seed)
    phase9_stream_waits(args.seed)
    print(f"phase9 done at {time.perf_counter() - t_all:.1f} s", flush=True)
    lm = phase10_lm(args.seed)
    lm370 = phase10_lm_370m(args.seed)
    print(f"phase10 done at {time.perf_counter() - t_all:.1f} s", flush=True)
    phase11_zoo(args.seed)
    print(f"phase11 done at {time.perf_counter() - t_all:.1f} s", flush=True)
    hwa = phase12_zoo(args.seed)
    print(f"phase12 done at {time.perf_counter() - t_all:.1f} s", flush=True)
    par = phase13(args.seed, cli)
    print(f"phase13 done at {time.perf_counter() - t_all:.1f} s", flush=True)
    if any(m.split(".")[0] in ("jax", "flax", "mm_unet_tpu") for m in sys.modules):
        raise SystemExit("chip_smoke: JAX or the JAX package was imported")
    unlaunched = [name for name, n in train.items() if n == 0]
    unlaunched += [f"{name} (dkDualNet {path})" for path, name in (
        ("serve", "selective_scan"), ("train", "selective_scan"), ("train", "selective_scan_bwd"))
        if dk[path][name] == 0]
    unlaunched += [f"{name} (UM_Net {path})" for path, names in (
        ("serve", ("mamba_fused_scan", "tap_conv")),
        ("train", ("mamba_fused_scan", "mamba_fused_scan_bwd", "tap_conv", "tap_conv_bwd")))
        for name in names if um[path][name] == 0]
    unlaunched += [f"{name} (entry points' {path})" for path, names in (
        ("val", ("mamba_fused_scan", "tap_conv")),
        ("train", ("mamba_fused_scan", "mamba_fused_scan_bwd", "tap_conv", "tap_conv_bwd")))
        for name in names if cli[path][name] == 0]
    unlaunched += [f"{name} (the LM's scoring forward)" for name in ("mamba_fused_scan",)
                   if lm["launches"][name] == 0]
    unlaunched += [f"{name} (the LM's route-b forward)" for name in ("selective_scan",)
                   if lm["route_b_launches"][name] == 0]
    unlaunched += [f"{name} (the LM's route-{r} training)" for r, names in (
        ("a", ("mamba_fused_scan", "mamba_fused_scan_bwd")),
        ("b", ("selective_scan", "selective_scan_bwd"))) for name in names
        if lm["train"][r][name] == 0]
    both = ("mamba_fused_scan", "mamba_fused_scan_bwd")
    unlaunched += [f"{name} (mamba-370m {path})" for path, counts, names in (
        ("scoring", lm370["launches"], both[:1]), ("route-a training", lm370["train"]["a"], both),
        ("AdamW steps", lm370["fit"], both)) for name in names if counts[name] == 0]
    unlaunched += [f"{name} (HWAUNETR {path})" for path, names in (
        ("serve", ("mamba_fused_scan",)), ("train", ("mamba_fused_scan", "mamba_fused_scan_bwd")))
        for name in names if hwa["launches"]["by_path"][path][name] == 0]
    unlaunched += [f"{name} (data parallel {path})" for path, names in (
        ("val", ("mamba_fused_scan", "tap_conv")),
        ("train", ("mamba_fused_scan", "mamba_fused_scan_bwd", "tap_conv", "tap_conv_bwd")))
        for name in names if par["dp"][path][name] == 0]
    unlaunched += [f"selective_scan{sfx} ({path} parallel)" for path in ("sp", "tp")
                   for part, sfx in (("fwd", ""), ("bwd", "_bwd"))
                   if (par[path]["launches"] if path == "sp" else par[path])[part] == 0]
    unlaunched += [f"mamba_fused_scan{sfx} (pipeline parallel)"
                   for part, sfx in (("fwd", ""), ("bwd", "_bwd")) if par["pp"][part] == 0]
    if unlaunched:
        raise SystemExit(f"chip_smoke: the main paths launched no {unlaunched}")

    def summary(name, source, replaces, paths, **extra):
        # times and bounds summed over the phase-1 bf16 shapes
        bf = [r for r in k[name] if r["dtype"] == "bfloat16"]
        top = max(bf, key=lambda r: r["bound_ms"])
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces, **extra,
                "launches": paths["train"][name],
                "launches_by_path": {"serve": paths["serve"].get(name, 0),
                                     "train": paths["train"][name]},
                **({"cli": {"train": cli["train"][name], "val": cli["val"][name]}}
                   if name in cli["train"] else {}),
                "max_abs_err": max(r["max_abs_err"] for r in k[name]),
                "ms": sum(r["ms"] for r in bf), "plain_ms": sum(r["plain_ms"] for r in bf),
                "bound_ms": sum(r["bound_ms"] for r in bf), "bound_by": top["bound_by"],
                "library_ms": None,  # no single PyTorch call computes this function
                "timed": "sum over the phase-1 bf16 shapes"}

    def step_sums(steps, keys=("D", "L", "reverse"), extra=()):
        # per train step: each shape's time and bound times its launches
        sums = ("ms", "kernel_ms", "bound_ms", *extra)
        return {**{f"step_{k}": sum(r[k] * r["launches_per_step"] for r in steps) for k in sums},
                "step_shapes": [{k: r[k] for k in (*keys, *sums, "launches_per_step")}
                                for r in steps]}

    def um_entry(name, steps, keys=("D", "L", "reverse"), extra=()):
        # UM_Net's launches of this kernel, and its times and bounds at the
        # shapes one UM_Net train step gives it
        kernel, part = (name[:-4], "bwd") if name.endswith("_bwd") else (name, "fwd")
        return {"um_net": {
            "launches_per_forward": um_counts["per_forward"][kernel] if part == "fwd" else 0,
            "launches_per_train_step": um_counts["per_train_step"][kernel][part],
            "launches_by_path": {"serve": um["serve"].get(name, 0), "train": um["train"][name]},
            **step_sums(steps, keys, extra)}}

    def hwa_entry(name, steps):
        # HWAUNETR's launches of this kernel, and its times and bounds at
        # the shapes one HWAUNETR train step gives it
        part = "bwd" if name.endswith("_bwd") else "fwd"
        per = hwa["launches"]["per_forward"]["mamba_fused_scan"]
        return {"hwaunetr": {
            "launches_per_forward": per if part == "fwd" else 0,
            "launches_per_train_step": per,
            "launches_by_path": {p: hwa["launches"]["by_path"][p][name]
                                 for p in ("val", "serve", "train")},
            **step_sums(steps)}}

    tap_keys = ("H", "W", "C", "F", "K")
    scan_keys = ("Dm", "G", "L")
    scan_parts = tuple(f"{k}_kernel_ms" for k in SCAN_BWD_GROUPS)

    mm = {"serve": serve, "train": train}
    print(smi(), flush=True)
    print(json.dumps({"kernels": [
        summary("mamba_fused_scan", "mm_unet_tpu_torch/csrc/mamba_fused_fwd.cu",
                "mm_unet_tpu/ops/mamba_fused.py:240", mm, **step_sums(fwd_steps),
                **um_entry("mamba_fused_scan", um_fwd),
                **hwa_entry("mamba_fused_scan", hwa["fwd_steps"]),
                lm=dict(lm["kernel"], launches_per_scoring_forward=lm["launches"][
                    "mamba_fused_scan"]),
                lm_370m=dict(shapes=lm370["kernels"]["fwd"],
                             launches_per_scoring_forward=lm370["launches"]["mamba_fused_scan"],
                             launches_per_train_step=lm370["fit"]["mamba_fused_scan"]),
                parallel={"dp": {p: par["dp"][p]["mamba_fused_scan"] for p in ("train", "val")},
                          "pp": par["pp"]["fwd"]}),
        summary("mamba_fused_scan_bwd", "mm_unet_tpu_torch/csrc/mamba_fused_bwd.cu",
                "mm_unet_tpu/ops/mamba_fused.py:288", mm, **step_sums(bwd_steps),
                **um_entry("mamba_fused_scan_bwd", um_bwd),
                **hwa_entry("mamba_fused_scan_bwd", hwa["bwd_steps"]),
                lm=dict(shapes=k["mamba_fused_scan_bwd_lm"],
                        launches_per_train_step=lm["train"]["a"]["mamba_fused_scan_bwd"]),
                lm_370m=dict(shapes=lm370["kernels"]["bwd"],
                             launches_per_train_step=lm370["fit"]["mamba_fused_scan_bwd"]),
                parallel={"dp": par["dp"]["train"]["mamba_fused_scan_bwd"],
                          "pp": par["pp"]["bwd"]}),
        summary("tap_conv", "mm_unet_tpu_torch/csrc/tap_conv_fwd.cu",
                "mm_unet_tpu/ops/tap_conv.py:110", mm,
                **step_sums(tap_fwd_steps, tap_keys), **um_entry("tap_conv", um_tap_fwd, tap_keys),
                parallel={"dp": {p: par["dp"][p]["tap_conv"] for p in ("train", "val")}}),
        summary("tap_conv_bwd", "mm_unet_tpu_torch/csrc/tap_conv_bwd.cu",
                "mm_unet_tpu/ops/tap_conv.py:133", mm,
                **step_sums(tap_bwd_steps, tap_keys, ("dfeat_kernel_ms", "dkernel_kernel_ms")),
                **um_entry("tap_conv_bwd", um_tap_bwd, tap_keys,
                         ("dfeat_kernel_ms", "dkernel_kernel_ms")),
                parallel={"dp": par["dp"]["train"]["tap_conv_bwd"]}),
        summary("selective_scan", "mm_unet_tpu_torch/csrc/selective_scan_fwd.cu",
                "mm_unet_tpu/ops/pallas_scan.py:242", dk,
                also_replaces="mm_unet_tpu/ops/pallas_scan.py:128",
                **step_sums(scan_fwd_steps, scan_keys),
                lm_route_b={"launches_per_scoring_forward": lm["route_b_launches"][
                    "selective_scan"], "launches_per_train_step": lm["train"]["b"][
                    "selective_scan"]},
                parallel={"sp": par["sp"]["launches"]["fwd"], "tp": par["tp"]["fwd"]}),
        summary("selective_scan_bwd", "mm_unet_tpu_torch/csrc/selective_scan_bwd.cu",
                "mm_unet_tpu/ops/pallas_scan.py:278", dk,
                also_replaces="mm_unet_tpu/ops/pallas_scan.py:169",
                **step_sums(scan_bwd_steps, scan_keys, scan_parts),
                lm_route_b={"launches_per_train_step": lm["train"]["b"]["selective_scan_bwd"]},
                parallel={"sp": par["sp"]["launches"]["bwd"], "tp": par["tp"]["bwd"]},
                sp_dlast=[{k: r[k] for k in ("B", "Dm", "N", "L", "bwd_ms_with_dlast",
                                             "bwd_ms_without_dlast", "bound_ms", "bound_by",
                                             "plain_fwd_bwd_ms", "rel_errs")}
                          for r in par["sp"]["kernel"]]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
