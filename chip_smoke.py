#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`open_genie_tpu_torch/`) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a Hopper card:

    python3 chip_smoke.py [--seed N]

Each phase seeds its generators (one on the host for weights and data, one
on the card for noise) from `--seed` (default 0).

Phases, in order (any failure raises and the exit code is non-zero):
  1. device: the card's name and power limit;
  2. build: the CUDA kernels from `open_genie_tpu_torch/csrc/`, and the
     registers and spills of the tensor-core flash kernels (none at D <= 64);
  3. kernel K1 (flash-attention forward) against its plain PyTorch twin:
     f32 (TF32 off, the CUDA-core variant) at the rollout's shapes and
     ragged edges; bf16 (the tensor-core variant) at every shape of the
     three paths, ragged N and D = 128, o and lse, two calls bit-identical;
     times at the rollout's and the session's shapes beside SDPA's flash
     forward;
  4. kernel K2 (fused LFQ head) against its plain twin at the paths' calls
     and edges (`LFQ_HEAD_CASES`), two calls bit-identical; both times at the
     paths' two calls as CUDA graphs, the eager call and an empty kernel's
     launch beside;
  4b. kernel K7 (the MaskGIT commit after the noise draw) against its plain
     twin at `MASKGIT_CASES` (every shape a path of this script or the
     benchmark's session runs it at, a V that no split divides, both noise
     kinds, temperatures, top_k, HW past one block), two calls
     bit-identical; the kernel pair, the plain twin and the uniform draw
     timed at `MASKGIT_PATH_SHAPES` beside the bound. Every later phase
     counts K7's launches with the other kernels' (`_counters`), and the
     last one holds K7 to its twin at any shape a phase ran that 4b did not
     (`phase_maskgit_seen`);
  5. the compact rollout model on the card against the same model on the
     CPU (plain twins there), same weights and Gumbel noise, f32 (K7 twice a
     refinement);
  6. the full-width rollout (`genie_rollout_config()`, bf16, 64x64 prompt,
     4 frames at 25 MaskGIT steps): output checks, the kernels' launch
     counts on that run (K7 twice a refinement at (1, 256, 2^10)) (every K1 on the tensor cores, at the shapes that
     phase 3 checked), determinism, and
     the time per generated frame;
  7. kernels K3 and K4 (flash-attention backward) against the plain
     backward: f32 (TF32 off, the CUDA-core variants) at the training
     step's shapes and ragged edges, bf16 (the tensor-core variants) at
     every shape of the paths, two calls bit-identical; then K1, K3 and K4
     timed at (512, 256, 64) and (256, 4096, 16) beside the plain twins,
     PyTorch's flash forward and aten's flash backward, and their bounds,
     and K3 + K4 beside aten's backward;
  8. one compact Genie training step on the card against the same step on
     the CPU (plain twins there): loss, every gradient, and the parameters
     after AdamW, f32;
  9. three full-width Genie training steps (`genie_train_config()`, batch
     4 x 16 frames x 64x64, bf16 compute on f32 weights): finite loss and
     grad norm, a gradient on every trainable parameter, the tokenizer
     unchanged, the kernels' launch counts per step (every K1, K3 and K4 on
     the tensor cores, at the shapes that phases 3 and 7 checked), ms per
     step and peak memory;
 10. kernels K5 and K6 (LFQ entropy over 2^d codes, forward and gradient)
     against their plain twins at d 13, 15, 18 and 21, gentle and trained
     feature scales, ragged token counts, and against a float64 sweep over
     every code at (512, 18); determinism; both times at (512, 18) as CUDA
     graphs beside the twins and the same algorithm on stock f32 matmuls,
     the eager calls beside; then K1, K3 and K4 at head dim 32
     at the frame discriminator's two calls in full, and each one's time
     beside PyTorch's calls;
 11. one compact tokenizer training step on the card against the same step
     on the CPU: loss, every gradient, the parameters after AdamW, f32;
 12. full-width tokenizer training steps (`tokenizer_train_config()`, the
     JAX benchmark's MAGVIT2 d=18 full-loss step, batch 4 x 8 frames x
     64x64, bf16 on f32 weights): finite loss terms and grad norm, the
     kernels' launch counts per step (every K1, K3 and K4 on the tensor
     cores, at checked shapes), the VGG unchanged; a gradient on every
     trainable parameter in the first three; the median ms per step of ten
     more, frames/s and peak memory; one profiled step's device time and
     its largest ops;
 13. K3 and K4 in bf16 at every shape of the two training paths, as CUDA
     graphs with the eager calls beside: times beside aten's flash backward,
     the plain backward where it is cheap, the bounds, each path's launches
     of the shape per step and launches x (time - bound), at every shape
     that a path's backward launches (the long calls that phases 7 and 10
     timed keep those times);
 14. the compact model's interactive session (`serve.InteractiveSession`,
     streaming decode) on the card against the same session on the CPU:
     same weights and Gumbel noise, f32, four steps at a horizon of three,
     so the last one rebases: tokens equal, pixels within PIX_TOL;
 15. the full-width session (`genie_serve_config()`, bf16, a (1, 4, 64, 64,
     3) prompt, 8 MaskGIT steps a frame, a horizon of SERVE_STEPS + 4): the
     kernels' launches per reset (K1 at (8, 64, 64), K2 once at (64, 512,
     18)), per step and at a rebase (K7 twice a refinement at (1, 64, 2^18));
     the tokens against `rollout_tokens`
     with a generator of the same seed; each decoder layer streamed over
     the batch decode's own input to it, within `bf16_excess` (and in f32
     within the JAX package's stream pin); the streamed frames' distance
     from the batch decode and that decode's from the f32 one, printed;
     finite pixels after the rebase; ms per frame of `step` (p50, p95 over
     SERVE_STEPS), of
     `step_nosync` chained and synced once, `reset` ms, peak memory, and
     one profiled step's device time and largest kernels;
 16. stage 1 of the staged training: `TokenizerTrainModule` of
     `tokenize_yaml_config()` (`configs/tokenize.yaml`: the LFQ's input
     projection, 10 bits) on batch 8 x 16 x 64x64, bf16 on f32 weights,
     AdamW lr 1e-3: a warm-up step (a gradient on every trainable
     parameter) and 3 timed steps, finite loss terms, the launches per
     step at the shapes of `PATH_CASES["stage1_train"]`, peak memory, one
     profiled step; then `evaluate_tokenizer` of a bf16 copy over 2
     batches (PSNR, SSIM, usage);
 17. stages 2 and 3: `ActionTrainModule` at `genie_train_config()`'s latent
     action (4 x 16 x 64x64, 3 steps), its weights into a Genie whose
     `tokenize_with_actions` turns 32 clips into tokens (32, 16, 16, 16)
     and actions (32, 16) (K2 once per chunk of 4), `DynamicsTrainModule`
     of `dynamics_yaml_config()` on that batch (3 steps, lr 3e-4, one
     more profiled), cached
     `generate` of 10 steps onto 15 frames and `evaluate_dynamics` over two
     batches of 16, each with its launches, shapes, ms and peak memory;
 18. `rollout_tokens_full` at `genie_rollout_config()` (2 frames at spf 8):
     tokens in range, the share equal to the cached `rollout_tokens` under
     the same noise printed;
 19. K1, and K3 and K4 where trained, at every shape that phases 16 to 18
     brought, as CUDA graphs beside SDPA's flash forward, aten's flash
     backward, the plain twins where cheap, and the bounds, with each
     path's launches of the shape. Phases 3 and 7 hold those shapes to the
     plain twins (`FLASH_BF16_CASES`);
 20. the trainer through its CLI (`open_genie_tpu_torch.cli.main`) on a copy
     of `configs/tokenize.yaml` (the copies of phases 20 to 22 override only
     where checkpoints and logs go, a log line per step, the run's length,
     validation and checkpoint cadence, and what each phase names): 6 steps
     with a validation and a save at step 3, then `--resume` to 8; finite
     logged terms, the log lines' cadence, the step directories and
     `best/`, phase 16's launches in every step, the VGG unchanged; ms per
     step beside phase 16's bare step, save times and sizes, peak memory;
 21. `cli tokenize-data` on `configs/genie.yaml` (32 train and 8 validation
     shards, one clip at a time: K2 once a clip), then `cli train dynamics`
     on a copy of `configs/dynamics.yaml` reading them (warm-up 2, cosine
     to 8): the logged lr equal to the schedule, the launches of every
     step, and a run resumed at step 4 ending on an uninterrupted 8-step
     run's parameters;
 22. `cli train tokenizer` on a copy of `configs/r05b_tokenizer.yaml`
     (synthetic 4 x 8 x 64x64 clips, the bit-balance anneal from step 2
     over 4, warm-up 2, cosine to 8): the scale each step's loss received,
     the logged lr equal to the schedule, the EMA against its recursion
     (and moved far beyond its f32 bound), no kernel launch (no attention,
     no critic); the 5.6 GiB
     checkpoint's size and write time;
 23. the native `.gvid` loader (`data/native.py`, its library built from
     `native/gvid_loader.cpp` into `build/gvid/`): GVID_CLIPS synthetic
     clips at tokenize.yaml's 16 x 64x64, the first epoch against the clips
     and starts it documents, batches per second beside `BatchLoader`; then
     `cli train tokenizer` on a tokenize.yaml copy reading the file, 4 steps
     and `--resume` to 6: each step trained on an uninterrupted run's batch,
     phase 16's launches per step;
 24. `cli eval tokenizer` on phase 20's checkpoint and with `--ema` on phase
     22's: the JAX package's keys, finite values, f32 K1 at the stage-1
     evaluation's shapes held to its twin, ms per batch;
 25. `cli train genie` (3 steps, EMA 0.999) on a genie.yaml copy, then the
     functions behind `generate` and `play` (the card has no OpenCV to write
     an mp4): `generate --ema --top-k 1` in f32 beside the same call on the
     CPU (the share of equal tokens printed; the compact model's equal),
     `--actions-from-data`, `play` past `--max-frames` (a rebase), launches
     per frame, ms per frame, play's p50/p95;
 26. `cli eval genie --controllability-frames 4` on phase 25's checkpoint and
     `cli eval dynamics` on phase 21's: the JAX package's keys, finite
     values, f32 K1 held to its twin at its shapes, ms;
 27. the video discriminator: the compact tokenizer step with
     `COMPACT_VIDEO_DISC_KWARGS` on the card against the CPU in f32, then
     phase 12's MAGVIT2 d=18 step with `VIDEO_DISC_KWARGS` judging whole 4 x
     8 x 64x64 clips (K1, K3, K4 6 a step on the tensor cores, K5, K6 once),
     every term finite, a gradient on every trainable parameter, the VGG
     unchanged; ms per step beside phase 12's, peak memory, one profiled
     step, and the blur's grouped conv3d timed alone at its two inputs;
 28. the alternative resamplers (`alt_tokenizers`): the compact twins'
     tokens and pixels on the card against the CPU's in f32; at MAGVIT2 d=18
     width on `ALT_BATCH` clips in bf16, `ALT_ENC`'s tokenize (K1 twice at
     the new shapes of `PATH_CASES["alt_tokenize"]`, K2 once at (512, 512,
     18)), a decode with `ALT_STREAM_DEC` and with `ALT_TCONV_DEC`, the stream
     of the 4 token frames (each layer within `bf16_excess` of the batch
     decode's input to it, in f32 within STREAM_EXACT; the f32 stream
     within PIX_TOL of the f32 batch decode), three training steps at r05's objective (rec, commit,
     bit balance); then K1, K3 and K4 at the two new shapes as CUDA graphs
     beside SDPA, aten and the bounds.
Phase 29 (`open_genie_tpu_torch/parallel/`): 29a, the distributed step
on a one-rank NCCL group at full width, phase 12's MAGVIT2 step and phase
9's Genie step: loss, every metric, every applied gradient and every
parameter after the step bit-identical to the bare step's (else the first
that differs is named); ms per step beside the bare step's, the bytes of
gradient all-reduced a step, peak memory. 29b, two ranks on the one card
over gloo, each a process of this script (`--dp-rank-of`): K5/K6 at (512,
18) split 256 + 256, the all-reduced q and the gradient against K5/K6 over
all 512 rows and within phase 10's float64-sweep bound; `cli train
tokenizer` on a copy of tokenize.yaml with `trainer.n_data: 2` (f32, lr
1e-4, 6 steps) against one process on the same global batches with the
same frame picks, losses and parameters within PIX_TOL; one checkpoint
directory, written by rank 0 alone; a run resumed at step 3 ending
bit-identical to the uninterrupted one; the ranks' parameters bit-equal;
K1, K3 and K4 in f32 at the ranks' shapes held to their twins; ms per step
on each rank beside the one-process step.
Phase 30 (`parallel/tensor.py`): two ranks on the one card over gloo, a
mesh of data 1 x model 2, each a process of this script (`--tp-rank-of`).
30a, `genie_train_config()` at genie.yaml's batch (4 x 16 x 64x64) with
the weights split over the model axis: one f32 step (TF32 off) held to
the one-process step of the same weights, batch and noise (loss within
1e-5 relative, each gathered gradient within 1e-4 of its norm, the
parameters within 2.1 lr), then one bf16 step whose every K1, K3 and K4
launch takes the tensor cores at the per-rank shapes
(`PATH_CASES["tp_train_step"]`, held to the twins by phases 3 and 7), the
bytes all-reduced and all-gathered and the peak memory of a rank step,
and ms per rank step beside the one-process step in turns. 30b, the
flagship split of the JAX package's dry run (`genie_tp_flagship_config()`:
a 512 x 262144 head and a 262144 x 512 token embedding split in two), one
f32 step held to one process. 30c, `cli train genie` on a genie.yaml copy
with `trainer.n_model: 2` (f32, lr 1e-5, 3 steps): one checkpoint, by
rank 0, in the one-process layout, which `cli train genie --resume` on
one process continues to the TP run's step 3 within 1e-5 relative; the
validation at step 3 writes the sample video, by rank 0 alone from the
gathered weights. Then K1, K3 and K4 at the per-rank shapes as CUDA graphs
beside SDPA, aten and the bounds (with phase 28's).
Phases 31 to 33 run after 26 (they read phase 22's checkpoint). 31: `cli
train genie` on a copy of configs/r05b_genie.yaml whose `tokenizer_ckpt`
is phase 22's checkpoint (the flagship joint step: 2^18 tokens over the
frozen MAGVIT2 d=18, 2 x 16 x 64x64, bf16): 4 steps with a save at 3,
then a run resumed from it whose step 4 equals the uninterrupted one's
(loss and grad norm); K1 to K4 every step (K1, K3, K4 on the tensor cores
at `PATH_CASES["r05b_genie_train"]`, K2 at a shape phase 4 checks). 32:
`cli train tokenizer` on configs/r05_tokenizer.yaml as phase 22 (no
kernel on its path). 33: phase 22's weights written as a reference
(open-genie) `state_dict` (`reference_state_dict`), `cli import-ckpt`
(bit for bit) and one step of `cli train tokenizer --resume` from it.
Every line of a time or a memory size in phases 16 to 33 carries the
card's name and power limit. The line before the last is a JSON summary
of the kernels (`launches` on one step or call of the newest path that
runs each, and the counts by path; the variant, and the kernel's, the
plain twin's and the library call's ms beside the bound at one shape of
the paths, and for K1, K3 and K4 the shapes of phase 19), the session's
times, each stage path's, the trainer's and the CLI's; the last line is `{"ok":
true, "device": {...}}`. Without a CUDA device it exits 1 at once.
"""
from __future__ import annotations

import argparse
import copy
import functools
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
SEED = 0
K1_TOL_F32 = 1e-5  # the same f32 math reordered
# bf16 K1's lse against the f32 twin on the same bf16 inputs: its logits are
# exact bf16 products summed in f32, so only the order of the sums and the
# exp2/log2 rounding are left; K3 and K4 read it.
K1_LSE_TOL_BF16 = 1e-4
# K3/K4 against the plain backward on the same inputs in f32: the same math
# summed in another order over up to 4096 terms.
K3K4_TOL_F32 = dict(atol=1e-4, rtol=1e-5)
# A bf16 output of K1, K3 or K4 against the f32 result on the same inputs
# (the backward's twin rounds p and ds where the kernels do) may differ at
# each value by BF16_RTOL |ref| + BF16_ATOL_RMS rms(ref) + BF16_ATOL: one
# to two bf16 ulps of the value (its own rounding is half of one), 1/32 of
# the output's RMS for p rounded to bf16 and sums taken in another order, and
# a floor for outputs that cancel to about zero (dk at N = 1). It scales with
# the output: at N = 4096, where a value is about 0.026, it is about 1e-3,
# and a kernel that skips one 64-row tile misses by far more
# (tests/test_torch_smoke_checks.py).
BF16_RTOL, BF16_ATOL_RMS, BF16_ATOL = 2 ** -7, 2 ** -5, 1e-4
LFQ_UNDECIDED = 1e-5  # |z| below this is a sign decided by rounding
PIX_TOL = dict(atol=2e-3, rtol=2e-2)  # the repo's parity bound for stacks
STREAM_EXACT = dict(atol=2e-5, rtol=1e-5)  # stream against batch decode, f32
TOK_TIMED_STEPS = 10  # full-width tokenizer steps timed after the three checked
SERVE_STEPS = 24  # full-width session steps timed, as bench.py::section_serve
# (clips, frames) of 64x64 video: the stage-1 tokenizer step's batch, the
# stage-2 latent action's, and the clips that stage 2 tokenizes (chunks of
# STAGE3_CHUNK) for the stage-3 dynamics.
STAGE1_BATCH = (8, 16)
STAGE2_BATCH = (4, 16)
STAGE3_BATCH, STAGE3_CHUNK = (32, 16), 4
# Calls shorter than this are timed as CUDA graphs: their eager time would
# hold the host's launch.
GRAPH_BELOW_MS = 0.1
# Every (B*H, N, D, causal) that each full-width path gives K1 in bf16 (K3
# and K4 take those of them that are trained); phases 6, 9 and 12 assert
# that their paths launch exactly these.
PATH_CASES = {
    # dynamics spatial; tokenizer encoder and decoder spatial and temporal.
    "rollout": [(8, 256, 64, False), (8, 256, 16, False), (40, 256, 16, False),
                (2048, 1, 16, True), (2048, 5, 16, True)],
    # latent action spatial at 64x64, 32x32 and 16x16 and temporal; dynamics
    # spatial and temporal; the frozen tokenizer's spatial and temporal.
    "train_step": [(256, 4096, 16, False), (256, 1024, 16, False), (256, 256, 16, False),
                   (65536, 16, 16, True), (16384, 16, 16, True), (4096, 16, 16, True),
                   (512, 256, 64, False), (8192, 16, 64, True)],
    # the frame discriminator's two spatial attentions.
    "tokenizer_train": [(64, 4096, 32, False), (64, 1024, 32, False)],
    # the dynamics' spatial attention over the 8x8 token grid (the MAGVIT2
    # tokenizer has no attention; cached temporal attention is masked).
    "serve": [(8, 64, 64, False)],
    # Stage 1, `tokenize_yaml_config()` at batch 8 x 16 x 64x64: the
    # tokenizer's spatial (8 heads over 32x32) and temporal attention, and
    # the frame discriminator's two spatial attentions over 8 x 4 frames;
    # its evaluation runs the tokenizer alone.
    "stage1_train": [(1024, 1024, 64, False), (65536, 16, 64, True),
                     (128, 4096, 32, False), (128, 1024, 32, False)],
    "stage1_eval": [(1024, 1024, 64, False), (65536, 16, 64, True)],
    # Stage 2, `genie_train_config()`'s latent action at batch 4 x 16 x
    # 64x64: spatial at 64x64 and 32x32, temporal self- and cross-attention.
    "action_train": [(256, 4096, 16, False), (65536, 16, 16, True),
                     (256, 1024, 16, False), (16384, 16, 16, True)],
    # `tokenize_with_actions` over chunks of 4 clips: the frozen tokenizer's
    # attention at 16x16 tokens and the latent action's.
    "tokenize_with_actions": [(256, 256, 16, False), (4096, 16, 16, True),
                              (256, 4096, 16, False), (65536, 16, 16, True),
                              (256, 1024, 16, False), (16384, 16, 16, True)],
    # Stage 3, `dynamics_yaml_config()` on 32 x 16 frames of 16x16 tokens:
    # spatial and temporal; cached `generate` (spatial per frame, 32 clips;
    # its cached temporal attention is masked); `evaluate_dynamics` over two
    # batches of 16.
    "dynamics_train": [(4096, 256, 64, False), (65536, 16, 64, True)],
    "generate": [(256, 256, 64, False)],
    "eval_dynamics": [(2048, 256, 64, False), (32768, 16, 64, True)],
    # `rollout_tokens_full` at `genie_rollout_config()`: the prompt frame's
    # tokenizer attention, then the dynamics over the whole 3-frame buffer.
    "rollout_full": [(8, 256, 16, False), (2048, 1, 16, True), (24, 256, 64, False),
                     (2048, 3, 64, True)],
    # `cli tokenize-data` on `configs/genie.yaml`, one 16-frame clip at a
    # time: the tokenizer's spatial and temporal attention over 16x16
    # tokens, the latent action's at 64x64 and at 32x32.
    "tokenize_data": [(64, 256, 16, False), (1024, 16, 16, True), (64, 4096, 16, False),
                      (16384, 16, 16, True), (64, 1024, 16, False), (4096, 16, 16, True)],
    # `cli train dynamics` on `configs/dynamics.yaml`: the stage-3 step's
    # shapes, and its validation's over a batch of the 8 validation shards.
    "trainer_dynamics": [(4096, 256, 64, False), (65536, 16, 64, True),
                         (1024, 256, 64, False), (16384, 16, 64, True)],
    # `cli train tokenizer` on `configs/r05b_tokenizer.yaml` (and r05's,
    # phase 32): the MAGVIT2 stacks have no attention and the YAML turns the
    # discriminator off.
    "r05b_train": [],
    # Phase 31, `cli train genie` on `configs/r05b_genie.yaml` at 2 x 16 x
    # 64x64: the latent action's spatial at 64x64 and 32x32 and temporal,
    # the dynamics' over 4 frames of 8x8 tokens (the frozen MAGVIT2 has no
    # attention).
    "r05b_genie_train": [(128, 4096, 16, False), (128, 1024, 16, False),
                         (32768, 16, 16, True), (8192, 16, 16, True), (64, 64, 64, False),
                         (1024, 4, 64, True)],
    # `cli train tokenizer` on tokenize.yaml reading the .gvid file of
    # phase 23 (the stage-1 step's shapes), and `cli eval tokenizer` on its
    # checkpoint (in f32, on the CUDA cores, at the stage-1 evaluation's).
    "gvid_train": [(1024, 1024, 64, False), (65536, 16, 64, True),
                   (128, 4096, 32, False), (128, 1024, 32, False)],
    "eval_tokenizer": [(1024, 1024, 64, False), (65536, 16, 64, True)],
    # Phase 27: `VIDEO_DISC_KWARGS`' two spatial attentions over 4 clips of
    # 8 x 64x64 and, blurred, of 4 x 32x32.
    "video_disc_train": [(128, 4096, 32, False), (64, 1024, 32, False)],
    # Phase 28 at `ALT_BATCH` (4 x 8x8 token frames a clip): `ALT_ENC`'s
    # `space_attn` and causal `time_attn`, in `tokenize` and in its
    # training step (with remat: K1 twice); the decoders have none.
    "alt_tokenize": [(64, 64, 64, False), (1024, 4, 64, True)],
    "alt_decode": [],
    "alt_stream": [],
    "alt_train": [(64, 64, 64, False), (1024, 4, 64, True)],
    # Phase 30a: the train step's attentions on one of two model ranks,
    # each holding half of every attention's heads: the latent action's
    # spatial at 64x64 and 32x32 and temporal, the frozen tokenizer's at
    # 16x16 tokens, the dynamics' spatial and temporal.
    "tp_train_step": [(128, 4096, 16, False), (128, 1024, 16, False), (128, 256, 16, False),
                      (32768, 16, 16, True), (8192, 16, 16, True), (2048, 16, 16, True),
                      (256, 256, 64, False), (4096, 16, 64, True)],
}
# The paths this checkout added last (phases 16 to 18): their new shapes are
# timed in phase 19.
STAGE_PATHS = ("stage1_train", "stage1_eval", "action_train", "tokenize_with_actions",
               "dynamics_train", "generate", "eval_dynamics", "rollout_full")
# The module library's paths (phases 27 and 28): their new shapes are timed
# at the end of phase 28.
MODULE_PATHS = ("video_disc_train", "alt_tokenize", "alt_decode", "alt_stream", "alt_train")
# (N, C, d) of K2 on the paths: the rollout's prompt frame (256 tokens of a
# 128-wide tokenizer), the Genie step's frozen tokenizer (4 x 16 frames of
# 16x16 tokens, 64 wide), both with 10 bits, the session's prompt (one 8x8
# token frame of the 512-wide MAGVIT2 encoder, 18 bits), and `cli
# tokenize-data`'s clip (16 frames of 16x16 tokens, 64 wide, 10 bits); all
# in bf16.
LFQ_HEAD_PATH_SHAPES = [(256, 128, 10), (16384, 64, 10), (64, 512, 18), (4096, 64, 10)]
# (N, C, d, offset of x in elements) at which phase 4 and the card tests hold
# K2 to its plain twin: the paths' calls (and the prompt frame of `cli
# generate` and `play` at genie.yaml, and `cli eval tokenizer`'s batch of
# 4 x 8 frames on r05b), the tokenizer's 18-bit codebook, the
# instance for any d up to 31, C no multiple of the 16-byte vector, one token
# of one bit, and x at a 2-element offset (not 16-byte aligned).
LFQ_HEAD_CASES = [(n, c, d, 0) for n, c, d in LFQ_HEAD_PATH_SHAPES] + [
    (256, 64, 10, 0), (512, 512, 18, 0), (4096, 512, 18, 0), (4099, 512, 31, 0), (33, 37, 7, 0), (7, 3, 31, 0), (1, 8, 1, 0),
    (256, 128, 10, 2), (33, 64, 18, 2),
]
# (B, HW, V) of K7's calls, timed in phase 4b: the benchmark's session (32
# players, 8x8 token frames, the 2^18 codebook), phase 15's session (one
# player: 66 splits of a row, the last one shorter), phase 17's `generate`
# (32 clips of 16x16 tokens, 2^10 codes), the rollouts of phases 6 and 18
# and the CLI's (one clip), the compact phases'. Then the cases at which
# phase 4b and the card tests hold K7 to its plain twin: (B, HW, V, logits
# dtype, noise: "u" uniforms or Gumbel values in "f32" / "bf16", temp,
# top_k): every path shape in the dtype and noise that its path gives (the
# CLI's f32 rollouts with --top-k 1), then V = 1000 (no split of 1024
# elements divides it), temperatures, top_k, HW 1100 (more positions than
# the commit block's 1024 threads). The kernel takes V a multiple of 4 only
# (`test_maskgit_sample_kernel_refuses_unaligned`).
MASKGIT_PATH_SHAPES = [(32, 64, 2 ** 18), (1, 64, 2 ** 18), (32, 256, 2 ** 10),
                       (1, 256, 2 ** 10), (2, 64, 2 ** 8)]
MASKGIT_CASES = [
    (32, 64, 2 ** 18, torch.bfloat16, "u", 1.0, None),
    (1, 64, 2 ** 18, torch.bfloat16, "u", 1.0, None),
    (32, 256, 2 ** 10, torch.bfloat16, "u", 1.0, None),
    (1, 256, 2 ** 10, torch.bfloat16, "u", 1.0, None),
    (1, 256, 2 ** 10, torch.float32, "u", 1.0, 1),
    (1, 256, 2 ** 10, torch.float32, "f32", 1.0, 1),
    (2, 64, 2 ** 8, torch.float32, "f32", 1.0, None),
    (1, 64, 2 ** 8, torch.float32, "u", 1.0, 1),
    (32, 64, 2 ** 18, torch.float32, "u", 0.8, None),
    (8, 64, 2 ** 18, torch.bfloat16, "bf16", 1.0, None),
    (8, 64, 2 ** 18, torch.bfloat16, "u", 1.0, 50),
    (2, 64, 2 ** 8, torch.bfloat16, "u", 0.8, 3),
    (16, 128, 1000, torch.bfloat16, "u", 1.0, None),
    (16, 128, 1000, torch.float32, "f32", 1.0, None),
    (4, 16, 1000, torch.bfloat16, "bf16", 0.8, None),
    (1, 1100, 4096, torch.float32, "u", 1.0, None),
]
MASKGIT_CHECKED = {(b, hw, v) for b, hw, v, *_ in MASKGIT_CASES}
# K7's confidence against the plain twin's: both sum exp(x - max) over V in
# f32, in another order, so log-sum-exp and conf (about -13 at V = 2^18)
# differ by a few ulps of their size. Where the plain twin's confidences at
# a player's threshold lie within MASKGIT_NEAR_TIE, that rounding may pick
# the other position, so the player's mask and code are not compared.
MASKGIT_CONF_ATOL = 2e-6
MASKGIT_NEAR_TIE = 1e-5
# K1 and K3 in bf16 are held to their twins at every path case, then at tile
# edges, ragged N and D = 128.
FLASH_BF16_CASES = sorted({c for cases in PATH_CASES.values() for c in cases}) + [
    (2048, 17, 16, True), (3, 1, 32, True), (8, 17, 16, False), (2, 130, 128, True),
    (4, 1000, 64, True), (4, 1000, 64, False), (8, 256, 128, False),
]


def bf16_excess(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest |got - ref| of a bf16 output against its f32 reference
    over what is allowed there (BF16_RTOL, BF16_ATOL_RMS, BF16_ATOL): at
    most 1 where they agree."""
    ref = ref.float()
    allow = (BF16_RTOL * ref.abs() + BF16_ATOL_RMS * ref.pow(2).mean().sqrt() + BF16_ATOL)
    return ((got.float() - ref).abs() / allow).max().item()


# Phases 27 and 28: the module library that no repo YAML reaches, at the
# widths of MAGVIT2 d=18 (`tokenizer_train_config()`, `configs/r05_tokenizer.yaml`).
# The frame discriminator's widths as a `VideoDiscriminator` over whole 8 x
# 64x64 clips (blur downsampling, attention and a conv FFN in both blocks),
# and its compact twin at `tokenizer_compact_train_config()`'s widths.
VIDEO_DISC_KWARGS = dict(inp_size=(8, 64, 64), model_dim=64, dim_mults=(1, 2, 4),
                         down_step=(None, 2, 2), num_groups=8, use_attn=True, num_heads=4,
                         dim_head=32)
COMPACT_VIDEO_DISC_KWARGS = dict(inp_size=(4, 32, 32), model_dim=8, dim_mults=(1, 2, 4),
                                 down_step=(None, 2, 2), num_groups=4, use_attn=True,
                                 num_heads=2, dim_head=16)
VIDEO_DISC_BATCH = (4, 8)  # clips x frames of 64x64, phase 12's batch
ALT_BATCH = (2, 16)  # clips x frames of 64x64: 4 x 8x8 token frames a clip
# What replaces the MAGVIT2 encoder's three `spacetime_downsample` stages
# (time, space factors (1, 2), (2, 2), (2, 2)): a residual block that blurs,
# one with strided causal convs padded by edge replication, and one that
# blurs with an int `downsample`.
ALT_ENC_STAGES = (
    ((1, 2), {"downsample": [1, 2]}),
    ((2, 2), {"downsample": [2, 2], "use_blur": False, "use_causal": True,
              "pad_mode": "replicate"}),
    ((2, 2), {"downsample": 2}),
)
ALT_ENC_HEADS = {"n_head": 8, "d_head": 64}
_WIDTH_KEYS = ("in_channels", "out_channels", "num_channels", "d_inp", "d_out")


def video_disc_train_config(cfg: dict, disc_kwargs: dict) -> dict:
    """`TokenizerTrainModule` kwargs `cfg` with a video discriminator of
    `disc_kwargs` judging whole clips."""
    return dict(cfg, gan_discriminate="video", disc_kwargs=dict(disc_kwargs))


def scale_widths(desc, div: int, keep=(3, 18)) -> tuple:
    """A blueprint with every channel width divided by `div`, but those in
    `keep` (the pixels' 3 and the codebook's 18)."""
    return tuple((name, {k: v // div if k in _WIDTH_KEYS and v not in keep else v
                         for k, v in kw.items()}) for name, kw in desc)


def alt_encoder(enc_desc) -> tuple:
    """`ALT_ENC` from a MAGVIT2 encoder: its `spacetime_downsample` stages
    become the residual blocks of `ALT_ENC_STAGES` at the stage's width,
    and a `space_attn` and a causal `time_attn` (`ALT_ENC_HEADS`, the
    running width in and out) come before its last `group_norm`."""
    out, stages = [], iter(ALT_ENC_STAGES)
    last_norm = max((i for i, (name, _) in enumerate(enc_desc) if name == "group_norm"),
                    default=-1)
    for i, (name, kw) in enumerate(enc_desc):
        if name == "spacetime_downsample":
            factors, extra = next(stages)
            assert (kw["time_factor"], kw["space_factor"]) == factors, (name, kw)
            out.append(("video-residual", {"in_channels": kw["in_channels"], **extra}))
            continue
        if i == last_norm:
            width = {"d_inp": kw["num_channels"], "d_out": kw["num_channels"]}
            out += [("space_attn", {**ALT_ENC_HEADS, **width}),
                    ("time_attn", {**ALT_ENC_HEADS, **width, "causal": True})]
        out.append((name, dict(kw)))
    assert next(stages, None) is None, "the encoder has fewer downsampling stages"
    return tuple(out)


def alt_stream_decoder(dec_desc) -> tuple:
    """`ALT_STREAM_DEC` from a MAGVIT2 decoder: each
    `depth2spacetime_upsample` of width C becomes a `depth2time_upsample`
    (where its time factor is above 1), then a `depth2space_upsample`."""
    out = []
    for name, kw in dec_desc:
        if name != "depth2spacetime_upsample":
            out.append((name, dict(kw)))
            continue
        c, tf, sf = kw["in_channels"], kw.get("time_factor", 2), kw.get("space_factor", 2)
        if tf > 1:
            out.append(("depth2time_upsample", {"in_channels": c, "factor": tf}))
        out.append(("depth2space_upsample", {"in_channels": c, "factor": sf}))
    return tuple(out)


def alt_tconv_decoder(dec_desc) -> tuple:
    """`ALT_TCONV_DEC` from a MAGVIT2 decoder: each
    `depth2spacetime_upsample` (tf, sf, C) becomes a 3x3x3
    `causal-conv3d-transpose` C -> C of stride (tf, sf, sf)."""
    return tuple(
        ("causal-conv3d-transpose", {
            "in_channels": kw["in_channels"], "out_channels": kw["in_channels"],
            "kernel_size": 3,
            "stride": [kw.get("time_factor", 2)] + [kw.get("space_factor", 2)] * 2})
        if name == "depth2spacetime_upsample" else (name, dict(kw))
        for name, kw in dec_desc)


def alt_tokenizers(div: int = 1) -> dict:
    """The tokenizer kwargs of phase 28 at the widths of MAGVIT2 d=18
    divided by `div` (16: the compact twin, widths 8 to 32): `ALT_ENC`
    with `ALT_STREAM_DEC` ("stream") and with `ALT_TCONV_DEC` ("tconv")."""
    from open_genie_tpu_torch.models.blueprints import (
        MAGVIT2_DEC_DESC,
        MAGVIT2_ENC_DESC,
        MAGVIT2_STREAM_DEC_DESC,
    )

    enc = alt_encoder(scale_widths(MAGVIT2_ENC_DESC, div))
    return {"stream": dict(enc_desc=enc, d_codebook=18,
                           dec_desc=alt_stream_decoder(scale_widths(MAGVIT2_STREAM_DEC_DESC, div))),
            "tconv": dict(enc_desc=enc, d_codebook=18,
                          dec_desc=alt_tconv_decoder(scale_widths(MAGVIT2_DEC_DESC, div)))}


# The card's peaks (NVIDIA's H100 SXM data sheet, dense, at 700 W) for the
# least time the same work could take.
PEAK_BF16_FLOPS = 989e12   # tensor cores
PEAK_F32_FLOPS = 67e12     # CUDA cores
PEAK_HBM_BYTES = 3.35e12
# Exponentials: 132 SMs x 16 ex2 per clock on the special-function units at
# the 1.83 GHz of the 989 TFLOP/s figure.
PEAK_EXP = 132 * 16 * 1.83e9


def bound(flops: float, nbytes: float, peak: float, exps: float = 0.0) -> dict:
    """The least time of a kernel: the larger of its operations over the
    peak for their type and its bytes (each input read once, each output
    written once) over the memory rate; beside it, the exponentials' own
    floor on the special-function units."""
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "exp_floor_ms": exps / PEAK_EXP * 1e3}


def flash_bound(kernel: str, bh: int, n: int, d: int, causal: bool = False) -> dict:
    """`bound` of K1 ("fwd"), K3 ("dkv") or K4 ("dq") on bf16 `(bh, n, d)`:
    4, 8 or 6 d operations per (query, key) pair that the mask keeps, one
    exponential each; q, k, v (and dO, lse, delta) read, o and lse (dk and
    dv, dq) written."""
    pairs = bh * (n * (n + 1) // 2 if causal else n * n)
    rows, elt = bh * n, 2
    flops = {"fwd": 4, "dkv": 8, "dq": 6}[kernel] * d * pairs
    nbytes = {"fwd": 4 * rows * d * elt + 4 * rows,
              "dkv": 6 * rows * d * elt + 8 * rows,
              "dq": 5 * rows * d * elt + 8 * rows}[kernel]
    return bound(flops, nbytes, PEAK_BF16_FLOPS, exps=pairs)


def _import_port():
    sys.path.insert(0, str(HERE))
    import open_genie_tpu_torch

    pkg_dir = Path(open_genie_tpu_torch.__file__).resolve().parent
    if pkg_dir.parent != HERE:
        raise RuntimeError(f"open_genie_tpu_torch imported from {pkg_dir}, not this checkout")


@functools.lru_cache(maxsize=None)
def _capture_stream():
    """The one side stream that CUDA graphs are warmed up and captured on
    (phase 3 only): each stream keeps a cuBLAS workspace of its own."""
    return torch.cuda.Stream()


def _release_capture_stream() -> None:
    """Drop the side stream and the cuBLAS workspaces, so that the side
    stream's adds nothing to a later phase's peak memory."""
    _capture_stream.cache_clear()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()


def cuda_ms(fn, iters: int = 50, warmup: int = 5, graph: bool = False) -> float:
    """Mean time of `fn` in ms, by CUDA events over `iters` calls launched
    one after another; with `graph`, over one replay of a CUDA graph that
    holds the `iters` calls, which leaves out the host's cost of launching
    them (what bounds a call of a few microseconds)."""
    stream = _capture_stream() if graph else torch.cuda.current_stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()

    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=stream):
            run()
        run = g.replay
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def alternate(calls: dict, graph: bool = False) -> dict:
    """Mean ms of each `name: (fn, iters)` of `calls`, timed once in the
    given order and once in the reverse order, so that a drift of the
    card's clocks falls on all of them alike."""
    runs = {name: [] for name in calls}
    for name in list(calls) + list(calls)[::-1]:
        fn, iters = calls[name]
        runs[name].append(cuda_ms(fn, iters, warmup=min(5, iters), graph=graph))
    return {name: sum(r) / len(r) for name, r in runs.items()}


def in_turns(plain, kernel, plain_iters: int = 50, library=None, iters: int = 50,
             graph: bool = False) -> dict:
    """Times of the kernel, its plain version and, where given, one library
    call that computes the same function: run plain, kernel, kernel, plain,
    then library, kernel, kernel, library; each the mean of its runs."""
    t = alternate({"plain": (plain, plain_iters), "kernel": (kernel, iters)}, graph)
    ks, lib = [t["kernel"]], None
    if library is not None:
        t_lib = alternate({"library": (library, iters), "kernel": (kernel, iters)}, graph)
        ks.append(t_lib["kernel"])
        lib = t_lib["library"]
    return {"ms": sum(ks) / len(ks), "plain_ms": t["plain"], "library_ms": lib}


def _as_heads(*ts) -> tuple:
    """`(B*H, N, D)` tensors viewed as `(B, H, N, D)` with H the largest
    divisor of B*H that is at most 65535, the grid limit of PyTorch's flash
    kernels."""
    bh = ts[0].shape[0]
    h = next(h for h in range(min(bh, 65535), 0, -1) if bh % h == 0)
    return tuple(t.view(bh // h, h, *t.shape[1:]) for t in ts)


def sdpa_forward(q, k, v, scale: float, causal: bool):
    """PyTorch's flash-backend SDPA forward on `(BH, N, D)` tensors: K1's
    yardstick (`library_ms`). Timed here, called nowhere in the port."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        return torch.nn.functional.scaled_dot_product_attention(
            *_as_heads(q, k, v), is_causal=causal, scale=scale)


def aten_flash_backward(q, k, v, do, scale: float, causal: bool):
    """A call of aten's flash-attention backward, which computes dq, dk and
    dv together, on the saved forward of aten's flash forward on the same
    inputs: the yardstick of K3 and K4 (`library_ms`)."""
    q4, k4, v4, do4 = _as_heads(q, k, v, do)
    o4, lse4, cq, ck, mq, mk, seed, offset, _ = \
        torch.ops.aten._scaled_dot_product_flash_attention(q4, k4, v4, 0.0, causal, False,
                                                           scale=scale)
    return lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
        do4, q4, k4, v4, o4, lse4, cq, ck, mq, mk, 0.0, causal, seed, offset, scale=scale)


# (B*H, N, D, causal) -> K3's, K4's and aten's backward's ms where phases
# 7 and 10 timed them, for phase 13.
_BACKWARD_MS = {}


def _print_backward_sum(label: str, case, k3: dict, k4: dict) -> None:
    """K3 + K4 against aten's flash backward, which computes dq, dk and dv
    in one call: the fair comparison of the port's backward. Kept in
    `_BACKWARD_MS` for phase 13."""
    print(f"[{label}] bf16 (BH,N,D,causal)={tuple(case)} K3 + K4: "
          f"{k3['ms'] + k4['ms']:.4f} ms, aten flash backward (dq, dk, dv) "
          f"{k3['library_ms']:.4f} ms")
    _BACKWARD_MS[tuple(case)] = {"K3": k3["ms"], "K4": k4["ms"], "aten": k3["library_ms"]}


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    print(f"[device] {name}, capability {torch.cuda.get_device_capability(0)}, "
          f"torch {torch.__version__}, cuda {torch.version.cuda}")
    return {"platform": "gpu", "kind": name, "count": torch.cuda.device_count(), "smi": smi}


def phase_build():
    from open_genie_tpu_torch.ops import kernels

    kernels.library()
    b = kernels.BUILD
    verb = f"built in {b['seconds']:.1f} s" if b["built"] else "reused"
    print(f"[build] {verb}: {b['path'].relative_to(HERE)} from "
          f"{[str(s.relative_to(HERE)) for s in kernels.sources()]}")
    # The tensor-core flash kernels, one line per (D, warps[, keys per
    # tile]) instance; no spill at the paths' head dims.
    report = ptxas_report(b["log"])
    for r in report:
        keys = f" keys={r['params'][2]}" if len(r["params"]) > 2 else ""
        print(f"[build] {r['kernel']} D={r['params'][0]} warps={r['params'][1]}{keys}: "
              f"{r['registers']} registers, spills {r['spill_stores']} B stored, "
              f"{r['spill_loads']} B loaded")
    assert report, "no ptxas report of the tensor-core kernels"
    spilled = [r for r in report if r["params"][0] <= 64 and r["spill_stores"] + r["spill_loads"]]
    assert not spilled, f"tensor-core kernels spill at D <= 64: {spilled}"
    hmma = _hmma_counts(b["path"])
    if hmma is None:
        print("[build] no cuobjdump in the CUDA toolkit: tensor-core instructions not counted")
        return
    for kernel in sorted({name for name, _ in hmma}):
        per = {params: c for (name, params), c in sorted(hmma.items()) if name == kernel}
        print(f"[build] {kernel}: HMMA (tensor-core) instructions in the SASS of each "
              f"instance {per}")
    assert hmma and all(c > 0 for c in hmma.values()), (
        "a tensor-core flash kernel has no HMMA instruction")


# A tensor-core flash kernel instance in a mangled symbol: the kernel's name
# after its length and its integer template arguments, `<D, warps>` (K4's
# `<D, warps, keys per tile>`).
_MMA_INSTANCE = re.compile(r"\d(flash_[a-z_]+_mma_kernel)I((?:Li\d+E)+)")


def mma_instance(symbol: str):
    """`(name, (D, warps, ...))` of a tensor-core flash kernel's symbol, else None."""
    m = _MMA_INSTANCE.search(symbol)
    return m and (m.group(1), tuple(int(x) for x in re.findall(r"\d+", m.group(2))))


def ptxas_report(log: str) -> list:
    """Registers and spills of each tensor-core flash kernel instance in an
    `-Xptxas=-v` log: dicts of `kernel`, `params` (D, warps, ...), `registers`,
    `spill_stores` and `spill_loads` (bytes)."""
    report, current = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            inst = mma_instance(m.group(1))
            current = inst and {"kernel": inst[0], "params": inst[1]}
            if current:
                report.append(current)
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            current["spill_stores"], current["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
    return report


def _hmma_counts(lib: Path):
    """HMMA (tensor-core) instructions per tensor-core flash kernel
    instance in the library's SASS from `cuobjdump -sass`; None where the
    toolkit has no cuobjdump."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "cuobjdump"
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts, key = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            key = mma_instance(m.group(1))
            if key:
                counts[key] = 0
        elif key and "HMMA" in line:
            counts[key] += 1
    return counts


def phase_flash(dev) -> dict:
    from open_genie_tpu_torch.ops.kernels.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(SEED)
    counts = flash_attention.launches_by_variant
    # f32: the CUDA-core variant, against the twin in true f32.
    err_f32 = 0.0
    for bh, n, d, causal in [(8, 256, 16, False), (8, 256, 64, False), (2048, 5, 16, True),
                             (2048, 17, 16, True), (4, 1000, 64, False), (4, 1000, 64, True)]:
        q, k, v = (torch.randn(bh, n, d, generator=g, device=dev) for _ in range(3))
        simt = counts["simt"]
        o, lse = flash_attention(q, k, v, d ** -0.5, causal)
        o_ref, lse_ref = flash_attention_plain(q, k, v, d ** -0.5, causal)
        e_o = (o - o_ref).abs().max().item()
        e_lse = (lse - lse_ref).abs().max().item()
        torch.cuda.synchronize()
        print(f"[K1] f32 (BH,N,D)=({bh},{n},{d}) causal={causal}: |do|={e_o:.3g} "
              f"|dlse|={e_lse:.3g}")
        assert e_o <= K1_TOL_F32 and e_lse <= K1_TOL_F32, "K1 f32 disagrees"
        assert counts["simt"] == simt + 1, "f32 K1 did not take the CUDA-core variant"
        err_f32 = max(err_f32, e_o, e_lse)

    # bf16: the tensor-core variant at every shape of the paths, against the
    # f32 result on the same bf16-rounded inputs, so that the error is the
    # kernel's own rounding of p and of o; two calls bit-identical.
    err_bf16 = excess_bf16 = 0.0
    for bh, n, d, causal in FLASH_BF16_CASES:
        q, k, v = (torch.randn(bh, n, d, generator=g, device=dev).bfloat16() for _ in range(3))
        mma = counts["mma"]
        o, lse = flash_attention(q, k, v, d ** -0.5, causal)
        again = flash_attention(q, k, v, d ** -0.5, causal)
        o_ref, lse_ref = _by_heads(flash_attention_plain, (q.float(), k.float(), v.float()),
                                   d ** -0.5, causal)
        torch.cuda.synchronize()
        e_o = (o.float() - o_ref).abs().max().item()
        x_o = bf16_excess(o, o_ref)
        e_lse = (lse - lse_ref).abs().max().item()
        same = torch.equal(o, again[0]) and torch.equal(lse, again[1])
        print(f"[K1] bf16 (BH,N,D)=({bh},{n},{d}) causal={causal}: |do|={e_o:.3g} "
              f"({x_o:.3g} of its limit) |dlse|={e_lse:.3g}, repeat bit-identical {same}")
        assert x_o <= 1 and e_lse <= K1_LSE_TOL_BF16, "K1 bf16 disagrees"
        assert same, "K1 bf16 not deterministic"
        assert counts["mma"] == mma + 2, "bf16 K1 did not take the tensor-core variant"
        err_bf16, excess_bf16 = max(err_bf16, e_o), max(excess_bf16, x_o)
        del q, k, v, o, lse, again, o_ref, lse_ref

    # The full-width rollout's calls, in its bf16: dynamics spatial (1 frame
    # x 8 heads, 256 tokens, d 64); tokenizer spatial (1 prompt frame or 5
    # decoded frames x 8 heads, d 16); decoder temporal (256 tubes x 8
    # heads, 5 frames, causal); and the session's dynamics spatial (8 heads,
    # 64 tokens, d 64). Each call takes microseconds, so they are timed as
    # CUDA graphs of 50 calls, without the host's launch cost; the kernel's
    # wrapper called eagerly, one call after another, beside.
    for bh, n, d, causal in [(8, 256, 64, False), (8, 256, 16, False),
                             (40, 256, 16, False), (2048, 5, 16, True), (8, 64, 64, False)]:
        q, k, v = (torch.randn(bh, n, d, generator=g, device=dev, dtype=torch.bfloat16)
                   for _ in range(3))
        kernel = lambda: flash_attention(q, k, v, d ** -0.5, causal)  # noqa: E731
        t = in_turns(lambda: flash_attention_plain(q, k, v, d ** -0.5, causal), kernel,
                     library=lambda: sdpa_forward(q, k, v, d ** -0.5, causal), graph=True)
        eager = cuda_ms(kernel)
        b = flash_bound("fwd", bh, n, d, causal)
        print(f"[K1 time] bf16 (BH,N,D)=({bh},{n},{d}) causal={causal}, CUDA graphs: kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, SDPA flash forward "
              f"{t['library_ms']:.4f} ms, bound {b['bound_ms']:.6f} ms ({b['bound_by']}); "
              f"eager calls of the kernel {eager:.4f} ms each")
    _release_capture_stream()
    return {"name": "flash_attention_fwd", "route": "cuda", "variant": "mma",
            "source": "open_genie_tpu_torch/csrc/flash_attention_mma.cu",
            "simt_source": "open_genie_tpu_torch/csrc/flash_attention.cu",
            "replaces": "open_genie_tpu/ops/pallas/flash_attention.py:46",
            "max_abs_err": err_bf16, "max_err_over_limit": excess_bf16,
            "max_abs_err_f32": err_f32}


def lfq_head_inputs(g, n: int, c: int, d: int, offset: int, dtype, dev) -> tuple:
    """K2's inputs: x (n, c) at `offset` elements into its storage; in bf16
    W and b in bf16, W the transposed view of a (d, c) tensor, as the
    tokenizer's 1x1x1 conv gives them; in f32 W (c, d) contiguous, in f32."""
    x = torch.randn(n * c + offset, generator=g, device=dev).to(dtype)[offset:].view(n, c)
    w = torch.randn(d, c, generator=g, device=dev) * c ** -0.5
    b = torch.randn(d, generator=g, device=dev) * 0.1
    if dtype == torch.bfloat16:
        return x, w.to(dtype).t(), b.to(dtype)
    return x, w.t().contiguous(), b


def lfq_head_check(x, w, b) -> tuple:
    """K2 against its plain twin: codes equal wherever |z| >= LFQ_UNDECIDED,
    ids equal on rows where every code is so decided, two calls
    bit-identical. Returns (max |d code| over decided codes, decided codes,
    decided rows)."""
    from open_genie_tpu_torch.ops.kernels.lfq_head import lfq_head, lfq_head_plain

    codes, idx = lfq_head(x, w, b)
    again = lfq_head(x, w, b)
    codes_ref, idx_ref = lfq_head_plain(x, w, b)
    decided = (x.float() @ w.float() + b.float()).abs() >= LFQ_UNDECIDED
    rows = decided.all(dim=1)
    torch.cuda.synchronize()
    e = (codes.float() - codes_ref.float())[decided].abs().max().item()
    assert e == 0.0 and torch.equal(idx[rows], idx_ref[rows]), (
        f"K2 {tuple(x.shape)} x {w.shape[1]} {x.dtype} disagrees with its plain twin")
    assert torch.equal(codes, again[0]) and torch.equal(idx, again[1]), "K2 not deterministic"
    return e, int(decided.sum()), int(rows.sum())


def phase_lfq(dev) -> dict:
    from open_genie_tpu_torch.ops.kernels.lfq_head import lfq_head, lfq_head_plain

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    err = 0.0
    for n, c, d, offset in LFQ_HEAD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            x, w, b = lfq_head_inputs(g, n, c, d, offset, dtype, dev)
            e, n_codes, n_rows = lfq_head_check(x, w, b)
            print(f"[K2] (N,C,d)=({n},{c},{d}) {dtype} x at offset {offset}: |dcodes|={e:.3g} "
                  f"on {n_codes}/{n * d} decided codes, idx equal on {n_rows}/{n} decided "
                  f"rows, repeat bit-identical")
            err = max(err, e)
    # The paths' calls in bf16, a few microseconds each: timed as CUDA
    # graphs of 50 calls (the wrapper's allocations included), the eager
    # call beside; and an empty kernel's launch as CUDA graphs, the floor of
    # a kernel that fills less than one wave of the card.
    floor = cuda_ms(lambda: torch.cuda._sleep(0), graph=True)
    rows = []
    for n, c, d in LFQ_HEAD_PATH_SHAPES:
        x, w, b = lfq_head_inputs(g, n, c, d, 0, torch.bfloat16, dev)
        t = in_turns(lambda: lfq_head_plain(x, w, b), lambda: lfq_head(x, w, b), graph=True)
        t["eager_ms"] = cuda_ms(lambda: lfq_head(x, w, b))
        # x, W, b read and codes (bf16) and ids (int32) written once; a
        # multiply-add per (token, channel, bit), in f32 on the CUDA cores.
        t.update(bound(2 * n * c * d, 2 * (n * c + c * d + d + n * d) + 4 * n, PEAK_F32_FLOPS))
        print(f"[K2 time] bf16 (N,C,d)=({n},{c},{d}), CUDA graphs: kernel {t['ms']:.4f} ms, "
              f"plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.6f} ms ({t['bound_by']}), "
              f"empty kernel launch {floor:.4f} ms; eager calls of the kernel "
              f"{t['eager_ms']:.4f} ms each")
        rows.append({**t, "shape": [n, c, d], "empty_launch_ms": floor})
    _release_capture_stream()
    # No one PyTorch call projects, takes signs and packs them into ids. The
    # row's numbers are the rollout's call; `by_shape` has both paths' calls.
    return {"name": "lfq_head", "route": "cuda", "variant": "warp_row",
            "source": "open_genie_tpu_torch/csrc/lfq_head.cu",
            "replaces": "open_genie_tpu/ops/pallas/lfq_head.py:37",
            "max_abs_err": err, **rows[0], "by_shape": rows}


def maskgit_inputs(g, b: int, hw: int, v: int, dtype, noise: str, dev) -> tuple:
    """K7's inputs: logits at the scale of a trained head's (std 3), the
    noise (uniforms, or Gumbel values in f32 or bf16), a mask with about 60%
    of the positions masked, an int64 code."""
    from open_genie_tpu_torch.ops.kernels.maskgit_sample import gumbel_of_uniform

    logits = (torch.randn(b, hw, v, generator=g, device=dev) * 3).to(dtype)
    u = torch.rand(b, hw, v, generator=g, device=dev)
    if noise != "u":
        u = gumbel_of_uniform(u).to(torch.float32 if noise == "f32" else torch.bfloat16)
    mask = torch.rand(b, hw, generator=g, device=dev) < 0.6
    code = torch.randint(0, v, (b, hw), generator=g, device=dev)
    return logits, u, mask, code


def maskgit_check(logits, noise, mask, code, num_tokens: int, temp: float, uniform: bool,
                  top_k=None, conf_atol: float = MASKGIT_CONF_ATOL) -> dict:
    """K7 against its plain twin on the same tensors (with `top_k`, both
    after `maskgit_commit`'s pre-mask): pred equal, conf within
    `conf_atol`, mask and code equal for every player whose plain
    confidences at the threshold are more than MASKGIT_NEAR_TIE apart or
    all equal the kernel's; two calls bit-identical. Returns the largest |d conf|, the players compared
    and the players."""
    from open_genie_tpu_torch.ops.kernels.maskgit_sample import (
        maskgit_sample,
        maskgit_sample_plain,
    )

    if top_k is not None:
        logits = logits.float() / temp
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits, temp = logits.masked_fill(logits < kth, float("-inf")), 1.0
    got = maskgit_sample(logits, noise, mask, code, num_tokens, temp, uniform)
    again = maskgit_sample(logits, noise, mask, code, num_tokens, temp, uniform)
    want = maskgit_sample_plain(logits, noise, mask, code, num_tokens, temp, uniform)
    torch.cuda.synchronize()
    shape = tuple(logits.shape)
    assert all(torch.equal(a, b) for a, b in zip(got, again)), f"K7 {shape} not deterministic"
    assert torch.equal(got[2], want[2]), (
        f"K7 {shape}: pred differs at {int((got[2] != want[2]).sum())} positions")
    live = mask
    dconf = (got[3][live] - want[3][live]).abs().max().item() if live.any() else 0.0
    assert dconf <= conf_atol and torch.equal(torch.isinf(got[3]), ~mask), (
        f"K7 {shape}: |d conf| {dconf:.3g} > {conf_atol}")
    hw = shape[1]
    k = min(max(num_tokens - 1, 0), hw - 1)
    sorted_conf = torch.sort(want[3], dim=-1, descending=True).values
    decided = (torch.ones_like(mask[:, 0]) if k + 1 >= hw else
               (sorted_conf[:, k] - sorted_conf[:, k + 1] > MASKGIT_NEAR_TIE)
               | torch.isinf(sorted_conf[:, k + 1]))
    decided |= (got[3] == want[3]).all(-1)  # the same confidences select the same
    assert torch.equal(got[0][decided], want[0][decided]) and torch.equal(
        got[1][decided], want[1][decided]), f"K7 {shape}: mask or code differs"
    return {"max_abs_dconf": dconf, "players_compared": int(decided.sum()),
            "players": shape[0]}


def maskgit_bound(b: int, hw: int, v: int, logit_bytes: int = 2) -> dict:
    """`bound` of K7 on `(b, hw, v)` logits and float32 uniforms: logits and
    uniforms read once, mask and int64 code read, mask, code, pred (int64)
    and conf (f32) written; per element a few f32 operations and three
    transcendentals (two logs, one exp) on the special-function units."""
    n, rows = b * hw * v, b * hw
    return bound(6 * n, n * (logit_bytes + 4) + rows * (1 + 8 + 1 + 8 + 8 + 4),
                 PEAK_F32_FLOPS, exps=3 * n)


def phase_maskgit(dev) -> dict:
    """Phase 4b: K7 against its plain twin at MASKGIT_CASES; the kernel
    pair, the plain twin and the draw timed at the paths' shapes."""
    from open_genie_tpu_torch.ops import kernels
    from open_genie_tpu_torch.ops.kernels.maskgit_sample import (
        maskgit_sample,
        maskgit_sample_plain,
        splits,
    )

    # ptxas's report of each instance: its entry, spills, then registers.
    entry, spills = None, ""
    for ln in kernels.BUILD["log"].splitlines():
        found = re.search(r"entry function '(\w*maskgit\w*)'", ln)
        if found:
            entry = found.group(1)
        elif entry and "spill" in ln:
            spills = ln.strip()
        elif entry and "registers" in ln:
            print(f"[K7 build] {entry}: {ln.split(':', 1)[1].strip()}; {spills}")
            entry = None
    g = torch.Generator(device=dev).manual_seed(SEED + 41)
    worst = 0.0
    for b, hw, v, dtype, noise, temp, top_k in MASKGIT_CASES:
        x, u, mask, code = maskgit_inputs(g, b, hw, v, dtype, noise, dev)
        n = max(1, int(mask[0].sum()) // 2)
        r = maskgit_check(x, u, mask, code, n, temp, noise == "u", top_k)
        worst = max(worst, r["max_abs_dconf"])
        print(f"[K7] (B,HW,V)=({b},{hw},{v}) {dtype} noise {noise} temp {temp} top_k {top_k}, "
              f"{n} tokens: pred equal, |dconf| {r['max_abs_dconf']:.3g}, mask and code equal "
              f"on {r['players_compared']}/{r['players']} players, repeat bit-identical")
        del x, u, mask, code
    rows = []
    floor = cuda_ms(lambda: torch.cuda._sleep(0), graph=True)
    for b, hw, v in MASKGIT_PATH_SHAPES:
        x, u, mask, code = maskgit_inputs(g, b, hw, v, torch.bfloat16, "u", dev)
        n = hw // 8
        kernel = lambda: maskgit_sample(x, u, mask, code, n)  # noqa: E731
        plain = lambda: maskgit_sample_plain(x, u, mask, code, n)  # noqa: E731
        draw = lambda: torch.rand(x.shape, device=dev)  # noqa: E731
        small = b * hw * v < 2 ** 24
        iters = 50 if small else 20
        t = in_turns(plain, kernel, plain_iters=iters, iters=iters, graph=small)
        t["draw_ms"] = cuda_ms(draw, iters, graph=small)
        t.update(maskgit_bound(b, hw, v))
        s = splits(b * hw, v, torch.cuda.get_device_properties(dev).multi_processor_count)
        gbs = (b * hw * v * 6) / (t["ms"] * 1e-3) / 1e9
        print(f"[K7 time] bf16 (B,HW,V)=({b},{hw},{v}), {s} split(s) a row"
              f"{', CUDA graphs' if small else ''}: kernel pair {t['ms']:.4f} ms "
              f"({gbs:.0f} GB/s of logits and uniforms), plain {t['plain_ms']:.4f} ms, "
              f"the uniform draw {t['draw_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}), exp floor {t['exp_floor_ms']:.4f} ms, empty kernel launch "
              f"{floor:.4f} ms")
        rows.append({**t, "shape": [b, hw, v], "splits": s})
        del x, u, mask, code
    _release_capture_stream()
    by_shape = {str(k): c for k, c in maskgit_sample.launches_by_shape.items()}
    print(f"[K7] launches by (B, HW, V) in this phase: {by_shape}")
    return {"name": "maskgit_sample", "route": "cuda", "variant": "split_combine",
            "source": "open_genie_tpu_torch/csrc/maskgit_sample.cu", "replaces": None,
            "library_ms": None, "max_abs_err": worst, **rows[0], "by_shape": rows}


def phase_maskgit_seen(dev) -> dict:
    """The last phase: K7 against its plain twin, as in phase 4b, at every
    (B, HW, V) that a phase since 4b launched it at and MASKGIT_CASES lacks
    (`K7_SEEN`), in bf16 and f32 logits with uniforms. Returns every
    shape seen with its launches."""
    _reset_counts()  # folds the last phase's shapes into K7_SEEN
    seen = {str(k): c for k, c in sorted(K7_SEEN.items())}
    g = torch.Generator(device=dev).manual_seed(SEED + 42)
    for b, hw, v in sorted(set(K7_SEEN) - MASKGIT_CHECKED):
        for dtype in (torch.bfloat16, torch.float32):
            x, u, mask, code = maskgit_inputs(g, b, hw, v, dtype, "u", dev)
            r = maskgit_check(x, u, mask, code, max(1, int(mask[0].sum()) // 2), 1.0, True)
            print(f"[K7 seen] (B,HW,V)=({b},{hw},{v}) {dtype}: pred equal, |dconf| "
                  f"{r['max_abs_dconf']:.3g}, mask and code equal on "
                  f"{r['players_compared']}/{r['players']} players")
            del x, u, mask, code
    print(f"[K7 seen] launches by (B, HW, V) over the run: {seen}; held to the twin in phase "
          f"4b: {sorted(set(K7_SEEN) & MASKGIT_CHECKED)}, here: "
          f"{sorted(set(K7_SEEN) - MASKGIT_CHECKED)}")
    return seen


def phase_flash_bwd(dev) -> tuple:
    """K3 and K4 against the plain backward on the same inputs and the
    same saved forward: f32 at every attention shape of the training step,
    bf16 at every shape of the paths; determinism; then K1, K3 and K4 timed
    against their plain twins and PyTorch's flash-attention calls."""
    from open_genie_tpu_torch.ops.kernels.flash_attention import (
        flash_attention,
        flash_attention_bwd,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_bwd_plain,
        flash_attention_plain,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    counts = (flash_attention_bwd_dkv.launches_by_variant,
              flash_attention_bwd_dq.launches_by_variant)

    def inputs(bh, n, d, causal, dtype):
        q, k, v, do = (torch.randn(bh, n, d, generator=g, device=dev).to(dtype)
                       for _ in range(4))
        o, lse = flash_attention(q, k, v, d ** -0.5, causal)
        return q, k, v, o, lse, do

    def check(case, dtype, variant) -> tuple:
        """Max |error| of dq, dk, dv, and in bf16 each one's share of its
        limit (`bf16_excess`)."""
        bh, n, d, causal = case
        q, k, v, o, lse, do = inputs(bh, n, d, causal, dtype)
        before = [c[variant] for c in counts]
        got = flash_attention_bwd(q, k, v, o, lse, do, d ** -0.5, causal)
        again = flash_attention_bwd(q, k, v, o, lse, do, d ** -0.5, causal)
        ref = _by_heads(flash_attention_bwd_plain, (q, k, v, o, lse, do), d ** -0.5, causal)
        torch.cuda.synchronize()
        excess = []
        for a, b, name in zip(got, ref, ("dq", "dk", "dv")):
            if dtype == torch.float32:
                torch.testing.assert_close(
                    a, b, **K3K4_TOL_F32, msg=lambda m, name=name: f"K3/K4 {name} {case}: {m}")
            else:
                excess.append(bf16_excess(a, b))
                assert excess[-1] <= 1, f"K3/K4 {name} {case} bf16: {excess[-1]:.3g} of its limit"
        assert all(torch.equal(a, b) for a, b in zip(got, again)), f"K3/K4 {case} not deterministic"
        assert [c[variant] for c in counts] == [b + 2 for b in before], (
            f"{dtype} K3 or K4 did not take the {variant} variant")
        return [(a.float() - b.float()).abs().max().item() for a, b in zip(got, ref)], excess

    # f32 (the CUDA-core variants) at the training step's calls (B*H, N, D):
    # latent-action spatial at 64x64 (a slice of its 256 heads) and 32x32,
    # its temporal self- and cross-attention (causal), the dynamics' spatial
    # and temporal calls; then ragged N.
    err_f32 = 0.0
    for case in [(8, 4096, 16, False), (64, 1024, 16, False), (65536, 16, 16, True),
                 (16384, 16, 16, True), (512, 256, 64, False), (8192, 16, 64, True),
                 (4, 1000, 64, False), (4, 1000, 64, True), (2048, 17, 16, True),
                 (8, 17, 16, False)]:
        errs, _ = check(case, torch.float32, "simt")
        err_f32 = max(err_f32, *errs)
        print(f"[K3/K4] f32 (BH,N,D,causal)={case}: max |d(dq,dk,dv)| "
              f"{[f'{e:.3g}' for e in errs]}, repeat bit-identical")
    # bf16 (the tensor-core variants) at every shape of the three paths.
    err_bf16, excess_bf16 = [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]
    for case in FLASH_BF16_CASES:
        errs, excess = check(case, torch.bfloat16, "mma")
        err_bf16 = [max(a, b) for a, b in zip(err_bf16, errs)]
        excess_bf16 = [max(a, b) for a, b in zip(excess_bf16, excess)]
        print(f"[K3/K4] bf16 (BH,N,D,causal)={case}: max |d(dq,dk,dv)| "
              f"{[f'{e:.3g}' for e in errs]} ({[f'{x:.3g}' for x in excess]} of their "
              f"limits), repeat bit-identical")

    # Times in bf16 at the dynamics' spatial call and the latent action's
    # (the plain twins over slices of heads there).
    rows = {}
    for bh, n, d, iters in [(512, 256, 64, 50), (256, 4096, 16, 10)]:
        q, k, v, o, lse, do = inputs(bh, n, d, False, torch.bfloat16)
        delta = (do.float() * o.float()).sum(-1)
        s = d ** -0.5
        big = n * n * bh > 2 ** 27
        plain_iters = 3 if big else 50
        plain_fwd = lambda: _by_heads(flash_attention_plain, (q, k, v), s)  # noqa: E731
        plain_bwd = lambda: _by_heads(flash_attention_bwd_plain, (q, k, v, o, lse, do), s)  # noqa: E731
        library = aten_flash_backward(q, k, v, do, s, False)
        t = {"flash_attention_fwd": in_turns(
                plain_fwd, lambda: flash_attention(q, k, v, s), plain_iters,
                library=lambda: sdpa_forward(q, k, v, s, False), iters=iters),
             "flash_attention_bwd_dkv": in_turns(
                plain_bwd, lambda: flash_attention_bwd_dkv(q, k, v, do, lse, delta, s),
                plain_iters, library=library, iters=iters),
             "flash_attention_bwd_dq": in_turns(
                plain_bwd, lambda: flash_attention_bwd_dq(q, k, v, do, lse, delta, s),
                plain_iters, library=library, iters=iters)}
        bounds = {"flash_attention_fwd": flash_bound("fwd", bh, n, d),
                  "flash_attention_bwd_dkv": flash_bound("dkv", bh, n, d),
                  "flash_attention_bwd_dq": flash_bound("dq", bh, n, d)}
        for name, label in (("flash_attention_fwd", "K1"), ("flash_attention_bwd_dkv", "K3"),
                            ("flash_attention_bwd_dq", "K4")):
            tt, b = t[name], bounds[name]
            print(f"[K1/K3/K4 time] bf16 (BH,N,D)=({bh},{n},{d}) {label}: kernel "
                  f"{tt['ms']:.4f} ms, plain {tt['plain_ms']:.4f} ms, library "
                  f"{tt['library_ms']:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}), "
                  f"exponentials {b['exp_floor_ms']:.4f} ms")
            rows[name] = {**tt, **b, "shape": [bh, n, d]}
        _print_backward_sum("K1/K3/K4 time", (bh, n, d, False), t["flash_attention_bwd_dkv"],
                            t["flash_attention_bwd_dq"])
        del q, k, v, o, lse, do, delta, library

    common = {"route": "cuda", "plain_computes": "dq, dk and dv together",
              "library_computes": "dq, dk and dv together (aten flash-attention backward)"}
    return (rows["flash_attention_fwd"],
            {"name": "flash_attention_bwd_dkv", **common, "variant": "mma",
             "source": "open_genie_tpu_torch/csrc/flash_attention_bwd_mma.cu",
             "simt_source": "open_genie_tpu_torch/csrc/flash_attention_bwd.cu",
             "replaces": "open_genie_tpu/ops/pallas/flash_attention.py:164",
             "max_abs_err": max(err_bf16[1:]), "max_err_over_limit": max(excess_bf16[1:]),
             "max_abs_err_f32": err_f32, **rows["flash_attention_bwd_dkv"]},
            {"name": "flash_attention_bwd_dq", **common, "variant": "mma",
             "source": "open_genie_tpu_torch/csrc/flash_attention_bwd_dq_mma.cu",
             "simt_source": "open_genie_tpu_torch/csrc/flash_attention_bwd.cu",
             "replaces": "open_genie_tpu/ops/pallas/flash_attention.py:237",
             "max_abs_err": err_bf16[0], "max_err_over_limit": excess_bf16[0],
             "max_abs_err_f32": err_f32, **rows["flash_attention_bwd_dq"]})


def lfq_sweep_f64(x, w, beta: float, chunk: int = 4096) -> tuple:
    """`q` and `2 beta (tanh(2 beta x) S - T)` of `(n, d)` features and
    `(2^d,)` weights in float64 over every code, chunk by chunk, by the
    Pallas kernels' formula `2 beta <x, c> - logZ` (its cancellation costs
    about 1e-12 in float64): a check of K5/K6 that shares nothing with the
    factorized twins."""
    n, d = x.shape
    chunk = min(chunk, 2 ** d)
    a = 2.0 * beta * x.double()
    log_z = (a.abs() + torch.log1p(torch.exp(-2.0 * a.abs()))).sum(-1, keepdim=True)
    shifts = torch.arange(d - 1, -1, -1, device=x.device)
    q = torch.empty(2 ** d, dtype=torch.float64, device=x.device)
    s = torch.zeros(n, 1, dtype=torch.float64, device=x.device)
    t = torch.zeros(n, d, dtype=torch.float64, device=x.device)
    for start in range(0, 2 ** d, chunk):
        j = torch.arange(start, start + chunk, device=x.device)
        codes = 2.0 * ((j[:, None] >> shifts) & 1).double() - 1.0
        p = torch.exp(a @ codes.T - log_z)
        q[start:start + chunk] = p.mean(0)
        pw = p * w[start:start + chunk].double()
        s += pw.sum(1, keepdim=True)
        t += pw @ codes
    return q, 2.0 * beta * (torch.tanh(a) * s - t)


def lfq_entropy_bounds(n: int, d: int) -> tuple:
    """`bound` of K5 and K6 at `(n, d)` for the factorized work: the tables'
    adds (dh per high entry, dl per low one) and n (2^dh + 2^dl)
    exponentials, then 2 n 2^d flops in K5's product and 4 n 2^d in K6's
    two; x and q, or x, w and dx, cross memory once. Beside each,
    `sweep_bound_ms`: the bound of the sweep over every (token, code) pair
    that the kernels did before (d adds and one exp a pair for K5, 3 d for
    K6)."""
    dh, dl = (d + 1) // 2, d // 2
    table_adds, exps = n * (dh * 2 ** dh + dl * 2 ** dl), n * (2 ** dh + 2 ** dl)
    pairs = n * 2 ** d
    k5 = bound(2 * pairs + table_adds, 4 * (n * d + 2 ** d), PEAK_F32_FLOPS, exps=exps)
    k6 = bound(4 * pairs + table_adds, 4 * (2 * n * d + 2 ** d), PEAK_F32_FLOPS, exps=exps)
    k5["sweep_bound_ms"] = bound(d * pairs, 4 * (n * d + 2 ** d), PEAK_F32_FLOPS)["bound_ms"]
    k6["sweep_bound_ms"] = bound(3 * d * pairs, 4 * (2 * n * d + 2 ** d),
                                 PEAK_F32_FLOPS)["bound_ms"]
    return k5, k6


def phase_lfq_entropy(dev) -> tuple:
    """K5 and K6 against their plain twins on the same inputs, at d 13, 15,
    18 and 21 and token counts 512 (the tokenizer's), ragged 1000 and 33,
    gentle (beta 5) and trained (beta 100, |x| about 1 and 3); against a
    float64 sweep over every code at (512, 18), beta 100, |x| about 1 and 3;
    determinism; bf16 features; both times at the full-width call (512, 18)
    beside the twins and the same algorithm on stock f32 matmuls. Then K1,
    K3 and K4 at head dim 32, the frame discriminator's."""
    from open_genie_tpu_torch.ops.kernels.lfq_entropy import (
        avg_probs_plain,
        entropy_grad_plain,
        entropy_of,
        lfq_avg_probs,
        lfq_entropy_grad,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    eps = 1e-6

    def weights(q):
        return torch.where(q > eps, 1.0 + torch.log(q.clamp_min(eps)), math.log(eps))

    errs = {"q": 0.0, "q_rel": 0.0, "dx": 0.0, "dx_cos": 1.0}
    for d in (13, 15, 18, 21):
        for n in (512, 1000, 33):
            for beta, scale in ((5.0, 0.1), (100.0, 1.0), (100.0, 3.0)):
                x = torch.randn(n, d, generator=g, device=dev) * scale
                q, q_ref = lfq_avg_probs(x, beta), avg_probs_plain(x, beta)
                w = weights(q_ref)
                dx = lfq_entropy_grad(x, w, beta) / n
                dx_ref = entropy_grad_plain(x, w, beta) / n
                torch.cuda.synchronize()
                e_q = ((q - q_ref).abs().max() / q_ref.abs().max()).item()
                h, h_ref = entropy_of(q, eps).item(), entropy_of(q_ref, eps).item()
                e_h = abs(h - h_ref) / abs(h_ref)
                cos = torch.nn.functional.cosine_similarity(
                    dx.flatten().double(), dx_ref.flatten().double(), dim=0).item()
                print(f"[K5/K6] (n,d)=({n},{d}) beta={beta} |x|~{scale}: q rel {e_q:.3g}, "
                      f"H {h:.6g} rel {e_h:.3g}, dx cos {cos:.7f} "
                      f"max|d dx| {(dx - dx_ref).abs().max().item():.3g}")
                assert e_q <= 1e-3 and e_h <= 1e-3, "K5 disagrees with its plain twin"
                assert cos > 0.999 or dx_ref.abs().max() == 0, "K6 direction disagrees"
                if beta == 5.0:
                    torch.testing.assert_close(dx, dx_ref, atol=2e-4, rtol=2e-2)
                errs["q"] = max(errs["q"], (q - q_ref).abs().max().item())
                errs["q_rel"] = max(errs["q_rel"], e_q)
                errs["dx"] = max(errs["dx"], (dx - dx_ref).abs().max().item())
                errs["dx_cos"] = min(errs["dx_cos"], cos)
    for scale in (1.0, 3.0):
        x = torch.randn(512, 18, generator=g, device=dev) * scale
        q = lfq_avg_probs(x, 100.0)
        w = weights(q)
        q_ref, dx_ref = lfq_sweep_f64(x, w, 100.0)
        e_q = ((q.double() - q_ref).abs().max() / q_ref.max()).item()
        e_dx = ((lfq_entropy_grad(x, w, 100.0).double() - dx_ref).abs().max()
                / dx_ref.abs().max()).item()
        print(f"[K5/K6 float64 sweep] (n,d)=(512,18) beta=100 |x|~{scale}: q off by {e_q:.3g} "
              f"of max q, dx by {e_dx:.3g} of max|dx|")
        assert e_q <= 1e-5 and e_dx <= 1e-4, "K5/K6 disagree with the float64 sweep"
        errs[f"sweep_q_rel_x{scale:g}"], errs[f"sweep_dx_rel_x{scale:g}"] = e_q, e_dx
    x = torch.randn(512, 18, generator=g, device=dev)
    xb = x.bfloat16()
    torch.testing.assert_close(lfq_avg_probs(xb, 100.0), lfq_avg_probs(xb.float(), 100.0),
                               atol=0, rtol=0)
    w = weights(lfq_avg_probs(x, 100.0))
    same = (torch.equal(lfq_avg_probs(x, 100.0), lfq_avg_probs(x, 100.0))
            and torch.equal(lfq_entropy_grad(x, w, 100.0), lfq_entropy_grad(x, w, 100.0)))
    assert same, "K5/K6 not deterministic"
    print("[K5/K6] bf16 features give the f32 result of their values; two calls at "
          "(512,18) bit-identical q and dx")
    # Each as CUDA graphs (device time without the host's launch of the
    # wrapper's casts and the kernel), the eager call beside. No one PyTorch
    # call computes either function: `library_ms` is the same factorized
    # algorithm on stock ops, the tables elementwise and the products as f32
    # torch.matmul with TF32 off, a composite of several calls.
    k5 = in_turns(lambda: avg_probs_plain(x, 100.0), lambda: lfq_avg_probs(x, 100.0),
                  plain_iters=5, graph=True,
                  library=lambda: avg_probs_plain(x, 100.0, dtype=torch.float32))
    k6 = in_turns(lambda: entropy_grad_plain(x, w, 100.0), lambda: lfq_entropy_grad(x, w, 100.0),
                  plain_iters=5, graph=True,
                  library=lambda: entropy_grad_plain(x, w, 100.0, dtype=torch.float32))
    k5["eager_ms"] = cuda_ms(lambda: lfq_avg_probs(x, 100.0))
    k6["eager_ms"] = cuda_ms(lambda: lfq_entropy_grad(x, w, 100.0))
    _release_capture_stream()
    b5, b6 = lfq_entropy_bounds(512, 18)
    k5.update(b5)
    k6.update(b6)
    library = "composite: tables + f32 torch.matmul, TF32 off"
    k5["library"] = k6["library"] = library
    print(f"[K5/K6 time] (n,d)=(512,18) f32, CUDA graphs: K5 {k5['ms']:.4f} ms, plain "
          f"{k5['plain_ms']:.4f} ms, library {k5['library_ms']:.4f} ms, bound "
          f"{k5['bound_ms']:.4f} ms ({k5['bound_by']}), sweep's bound "
          f"{k5['sweep_bound_ms']:.4f} ms; K6 {k6['ms']:.4f} ms, plain {k6['plain_ms']:.4f} ms, "
          f"library {k6['library_ms']:.4f} ms, bound {k6['bound_ms']:.4f} ms "
          f"({k6['bound_by']}), sweep's bound {k6['sweep_bound_ms']:.4f} ms; exponentials "
          f"{k5['exp_floor_ms']:.6f} ms each; eager calls K5 {k5['eager_ms']:.4f} ms, "
          f"K6 {k6['eager_ms']:.4f} ms ({library})")
    _flash_head_dim_32(dev)
    common = {"route": "cuda", "variant": "factorized",
              "source": "open_genie_tpu_torch/csrc/lfq_entropy.cu", "shape": [512, 18]}
    return ({"name": "lfq_entropy_fwd", **common, "max_abs_err": errs["q"],
             "max_rel_err": errs["q_rel"], "sweep_rel_err": [errs["sweep_q_rel_x1"],
                                                             errs["sweep_q_rel_x3"]], **k5,
             "replaces": "open_genie_tpu/ops/pallas/lfq_entropy.py:41"},
            {"name": "lfq_entropy_bwd", **common, "max_abs_err": errs["dx"],
             "min_cos": errs["dx_cos"], "sweep_rel_err": [errs["sweep_dx_rel_x1"],
                                                          errs["sweep_dx_rel_x3"]], **k6,
             "replaces": "open_genie_tpu/ops/pallas/lfq_entropy.py:74"})


def _by_heads(fn, tensors, *args) -> tuple:
    """`fn(*tensors, *args)` over slices of the leading B*H axis with at
    most 2^27 logits each (8 heads at N = 4096), concatenated: the plain
    twins' (N, N) matrices of a few heads at a time."""
    n = tensors[0].shape[1]
    heads = max(1, 2 ** 27 // (n * n))
    parts = [fn(*(t[i:i + heads] for t in tensors), *args)
             for i in range(0, tensors[0].shape[0], heads)]
    return tuple(torch.cat(p) for p in zip(*parts))


def _flash_head_dim_32(dev) -> None:
    """K1, K3 and K4 at the frame discriminator's head dim 32, at both of
    its calls in full, (64, 4096, 32) and (64, 1024, 32), f32 and bf16,
    against the plain twins run over slices of 8 heads; then each timed on
    the bf16 tensors at (64, 4096, 32) that were checked, beside PyTorch's
    flash-attention forward and backward."""
    from open_genie_tpu_torch.ops.kernels.flash_attention import (
        flash_attention,
        flash_attention_bwd,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_bwd_plain,
        flash_attention_plain,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    s = 32 ** -0.5
    for bh, n in ((64, 4096), (64, 1024)):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (torch.randn(bh, n, 32, generator=g, device=dev).to(dtype)
                           for _ in range(4))
            o, lse = flash_attention(q, k, v, s)
            o_ref, lse_ref = _by_heads(flash_attention_plain, (q.float(), k.float(), v.float()), s)
            got = flash_attention_bwd(q, k, v, o, lse, do, s)
            ref = _by_heads(flash_attention_bwd_plain, (q, k, v, o, lse, do), s)
            torch.cuda.synchronize()
            e_o = (o.float() - o_ref).abs().max().item()
            e_lse = (lse - lse_ref).abs().max().item()
            e_g = [(a.float() - b.float()).abs().max().item() for a, b in zip(got, ref)]
            print(f"[K1/K3/K4 D=32] (BH,N)=({bh},{n}) {dtype}: |do| {e_o:.3g}, |dlse| "
                  f"{e_lse:.3g}, |d(dq,dk,dv)| {[f'{e:.3g}' for e in e_g]}")
            if dtype == torch.float32:
                assert e_o <= K1_TOL_F32 and e_lse <= K1_TOL_F32, "K1 D=32"
                for a, b in zip(got, ref):
                    torch.testing.assert_close(a, b, **K3K4_TOL_F32)
            else:
                assert bf16_excess(o, o_ref) <= 1 and e_lse <= K1_LSE_TOL_BF16, "K1 D=32"
                assert all(bf16_excess(a, b) <= 1 for a, b in zip(got, ref)), "K3/K4 D=32"
            if (n, dtype) == (4096, torch.bfloat16):
                timed = (q, k, v, o, lse, do)
    q, k, v, o, lse, do = timed
    delta = (do.float() * o.float()).sum(-1)
    plain_bwd = lambda: _by_heads(flash_attention_bwd_plain, (q, k, v, o, lse, do), s)  # noqa: E731
    library = aten_flash_backward(q, k, v, do, s, False)
    times = {}
    for label, kind, plain, kernel, lib in (
            ("K1", "fwd", lambda: _by_heads(flash_attention_plain, (q, k, v), s),
             lambda: flash_attention(q, k, v, s), lambda: sdpa_forward(q, k, v, s, False)),
            ("K3", "dkv", plain_bwd,
             lambda: flash_attention_bwd_dkv(q, k, v, do, lse, delta, s), library),
            ("K4", "dq", plain_bwd,
             lambda: flash_attention_bwd_dq(q, k, v, do, lse, delta, s), library)):
        t, b = in_turns(plain, kernel, 3, library=lib, iters=20), flash_bound(kind, 64, 4096, 32)
        times[label] = t
        print(f"[K1/K3/K4 D=32 time] bf16 (64,4096,32) {label}: kernel {t['ms']:.4f} ms, "
              f"plain {t['plain_ms']:.4f} ms (over 8 slices of 8 heads), library "
              f"{t['library_ms']:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}), "
              f"exponentials {b['exp_floor_ms']:.4f} ms")
    _print_backward_sum("K1/K3/K4 D=32 time", (64, 4096, 32, False), times["K3"], times["K4"])


def phase_backward_shapes(dev, launches: dict) -> None:
    """K3 and K4 in bf16 at every shape that a training path launches them
    at, beside aten's flash backward (dq, dk and dv in one call), the plain
    backward where one slice of at most 2^27 logits holds it, the bounds,
    and each path's launches of the shape per step (`launches`: path ->
    kernel -> shape -> count, from phases 9 and 12). Times are CUDA graphs
    (device time), the eager calls beside; calls of at least
    `GRAPH_BELOW_MS` that phases 7 and 10 timed keep those eager times."""
    from open_genie_tpu_torch.ops.kernels.flash_attention import (
        flash_attention,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_bwd_plain,
    )

    g = torch.Generator(device=dev).manual_seed(SEED + 14)
    paths = ("train_step", "tokenizer_train")
    names = ("flash_attention_bwd_dkv", "flash_attention_bwd_dq")
    per_step = {case: {path: [launches[path][name].get(case, 0) for name in names]
                       for path in paths}
                for path in paths for case in PATH_CASES[path]}
    for case, counts in per_step.items():
        if not any(c for pair in counts.values() for c in pair):
            continue
        bh, n, d, causal = case
        timed = _BACKWARD_MS.get(case)
        if timed and min(timed["K3"], timed["K4"]) >= GRAPH_BELOW_MS:
            ms, how = timed, "eager, from phase 7 or 10"
        else:
            q, k, v, do = (torch.randn(bh, n, d, generator=g, device=dev, dtype=torch.bfloat16)
                           for _ in range(4))
            s = d ** -0.5
            o, lse = flash_attention(q, k, v, s, causal)
            delta = (do.float() * o.float()).sum(-1)
            fns = {"K3": lambda: flash_attention_bwd_dkv(q, k, v, do, lse, delta, s, causal),
                   "K4": lambda: flash_attention_bwd_dq(q, k, v, do, lse, delta, s, causal),
                   "aten": aten_flash_backward(q, k, v, do, s, causal)}
            if bh * n * n <= 2 ** 27:
                fns["plain"] = lambda: flash_attention_bwd_plain(q, k, v, o, lse, do, s, causal)
            iters = 10 if bh * n * n > 2 ** 30 else 50
            ms = alternate({name: (fn, iters) for name, fn in fns.items()}, graph=True)
            eager = {name: cuda_ms(fns[name], iters) for name in ("K3", "K4", "aten")}
            _release_capture_stream()
            plain = f", plain {ms['plain']:.4f} ms" if "plain" in ms else ""
            how = (f"CUDA graphs{plain}; eager K3 {eager['K3']:.4f}, K4 {eager['K4']:.4f}, "
                   f"aten {eager['aten']:.4f} ms")
            del q, k, v, do, o, lse, delta, fns
        b3, b4 = flash_bound("dkv", bh, n, d, causal), flash_bound("dq", bh, n, d, causal)
        gap = {path: (c3 * (ms["K3"] - b3["bound_ms"]), c4 * (ms["K4"] - b4["bound_ms"]))
               for path, (c3, c4) in counts.items()}
        print(f"[backward shapes] bf16 (BH,N,D,causal)={case}: K3 {ms['K3']:.4f} ms, K4 "
              f"{ms['K4']:.4f} ms, K3 + K4 {ms['K3'] + ms['K4']:.4f} ms, aten flash backward "
              f"{ms['aten']:.4f} ms ({how}); bound K3 {b3['bound_ms']:.5f} "
              f"({b3['bound_by']}), K4 {b4['bound_ms']:.5f} ({b4['bound_by']}), exponentials "
              f"{b4['exp_floor_ms']:.5f} ms each; launches (K3, K4) per Genie step "
              f"{tuple(counts['train_step'])}, per tokenizer step "
              f"{tuple(counts['tokenizer_train'])}; launches x (ms - bound) (K3, K4) per "
              f"Genie step ({gap['train_step'][0]:.3f}, {gap['train_step'][1]:.3f}) ms, per "
              f"tokenizer step ({gap['tokenizer_train'][0]:.3f}, "
              f"{gap['tokenizer_train'][1]:.3f}) ms")


def phase_compact_parity(dev):
    """Compact model: the card (kernels) against the CPU (plain twins)."""
    from open_genie_tpu_torch.models.configs import genie_compact_config
    from open_genie_tpu_torch.models.dynamics import gumbel_noise
    from open_genie_tpu_torch.models.genie import Genie
    from open_genie_tpu_torch.ops.kernels.flash_attention import flash_attention
    from open_genie_tpu_torch.ops.kernels.lfq_head import lfq_head
    from open_genie_tpu_torch.ops.kernels.maskgit_sample import maskgit_sample
    from open_genie_tpu_torch.utils import init_weights

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _reset_counts()
    g = torch.Generator().manual_seed(SEED + 2)
    cpu = init_weights(Genie(**genie_compact_config()), g).eval()
    gpu = copy.deepcopy(cpu).to(dev)
    b, frames, steps = 2, 3, 8
    prompt = torch.rand(b, 1, 32, 32, 3, generator=g)
    actions = torch.randint(0, gpu.act_vocab, (b, 1 + frames), generator=g)
    gumbel = gumbel_noise((frames, steps, b, 64, 2 ** 8), g)

    tok_cpu = cpu.generate_tokens(prompt, actions, frames, steps, gumbel=gumbel)
    pix_cpu = cpu.tokenizer.decode_tokens(tok_cpu)
    k1, k2, k7 = flash_attention.launches, lfq_head.launches, maskgit_sample.launches
    tok_gpu = gpu.generate_tokens(prompt.to(dev), actions.to(dev), frames, steps,
                                  gumbel=gumbel.to(dev))
    pix_gpu = gpu.tokenizer.decode_tokens(tok_gpu).cpu()
    launched = (flash_attention.launches - k1, lfq_head.launches - k2,
                maskgit_sample.launches - k7)
    same = torch.equal(tok_gpu.cpu(), tok_cpu)
    err = (pix_gpu - pix_cpu).abs().max().item()
    print(f"[compact] tokens {tuple(tok_gpu.shape)} equal CUDA vs CPU: {same}; "
          f"pixels max |d| {err:.3g}; launches K1 {launched[0]}, K2 {launched[1]}, "
          f"K7 {launched[2]}")
    assert same, "CUDA rollout tokens differ from the CPU plain rollout"
    torch.testing.assert_close(pix_gpu, pix_cpu, **PIX_TOL)
    assert launched[0] > 0 and launched[1] == 1 and launched[2] == 2 * frames * steps
    k7 = _assert_k7_checked("compact")
    assert k7 == {(b, 64, 2 ** 8): 2 * frames * steps}, f"K7 launched at {k7}"
    return launched[2]


def phase_full_width(dev) -> tuple:
    from open_genie_tpu_torch.models.configs import genie_rollout_config
    from open_genie_tpu_torch.models.genie import Genie
    from open_genie_tpu_torch.utils import init_weights

    torch.backends.cudnn.deterministic = True
    g = torch.Generator().manual_seed(SEED + 3)
    genie = init_weights(Genie(**genie_rollout_config()), g).to(dev, torch.bfloat16).eval()
    frames, spf = 4, 25
    prompt = torch.rand(1, 1, 64, 64, 3, generator=g).to(dev, torch.bfloat16)
    actions = torch.randint(0, genie.act_vocab, (1, 1 + frames), generator=g).to(dev)
    gen = lambda: torch.Generator(device=dev).manual_seed(SEED + 4)  # noqa: E731

    _reset_counts()
    video = genie(prompt, actions, frames, spf, generator=gen())
    torch.cuda.synchronize()
    launches = _read_counts()
    variants = _assert_path_kernels("full", "rollout")
    assert variants["flash_attention_fwd"]["mma"] == launches["flash_attention_fwd"]

    n_layers = len(genie.dynamics.layers)
    n_tok_attn = sum(1 for m in genie.tokenizer.modules()
                     if type(m).__name__ == "Attention")
    expect_k1 = n_tok_attn + n_layers * (1 + frames * (spf + 1))
    k7 = _assert_k7_checked("full")
    print(f"[full] video {tuple(video.shape)} {video.dtype}; launches "
          f"K1 {launches['flash_attention_fwd']} (expected {expect_k1} = "
          f"{n_tok_attn} tokenizer + {n_layers} x (1 + {frames} x {spf + 1})), "
          f"K2 {launches['lfq_head']}, K7 by (B, HW, V) {k7}")
    assert tuple(video.shape) == (1, 1 + frames, 64, 64, 3)
    assert torch.isfinite(video.float()).all(), "non-finite pixels"
    assert launches["flash_attention_fwd"] == expect_k1 == 638
    assert launches["lfq_head"] == 1
    assert launches["flash_attention_bwd_dkv"] == launches["flash_attention_bwd_dq"] == 0
    assert k7 == {(1, 256, 2 ** 10): 2 * frames * spf}, f"K7 launched at {k7}"

    tok_a = genie.generate_tokens(prompt, actions, frames, spf, generator=gen())
    tok_b = genie.generate_tokens(prompt, actions, frames, spf, generator=gen())
    assert torch.equal(tok_a, tok_b), "same seed, different tokens"
    assert int(tok_a.min()) >= 0 and int(tok_a.max()) < 2 ** 10
    assert torch.equal(genie.tokenizer.decode_tokens(tok_a), video), (
        "forward's pixels are not the decode of its tokens"
    )
    print(f"[full] rerun with the same seed: identical tokens {tuple(tok_a.shape)}, "
          f"ids in [{int(tok_a.min())}, {int(tok_a.max())}]")

    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        genie(prompt, actions, frames, spf, generator=gen())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    per_frame = min(times) / frames * 1e3
    print(f"[full] warm rollout: {per_frame:.2f} ms per generated frame "
          f"(best of {[round(t, 4) for t in times]} s for {frames} frames, spf {spf})")
    return launches


def _counters() -> dict:
    from open_genie_tpu_torch.ops.kernels.flash_attention import (
        flash_attention,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
    )
    from open_genie_tpu_torch.ops.kernels.lfq_entropy import lfq_avg_probs, lfq_entropy_grad
    from open_genie_tpu_torch.ops.kernels.lfq_head import lfq_head
    from open_genie_tpu_torch.ops.kernels.maskgit_sample import maskgit_sample

    return {"flash_attention_fwd": flash_attention, "lfq_head": lfq_head,
            "flash_attention_bwd_dkv": flash_attention_bwd_dkv,
            "flash_attention_bwd_dq": flash_attention_bwd_dq,
            "lfq_entropy_fwd": lfq_avg_probs, "lfq_entropy_bwd": lfq_entropy_grad,
            "maskgit_sample": maskgit_sample}


# K7's launches by (B, HW, V) over the whole run, gathered at each
# `_reset_counts`; `phase_maskgit_seen` checks the shapes phase 4b did not.
K7_SEEN = Counter()


def _reset_counts() -> None:
    K7_SEEN.update(_counters()["maskgit_sample"].launches_by_shape)
    for fn in _counters().values():
        fn.launches = 0
        for variant in getattr(fn, "launches_by_variant", {}):
            fn.launches_by_variant[variant] = 0
        if hasattr(fn, "launches_by_shape"):
            fn.launches_by_shape.clear()


def _read_counts() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


_FLASH = ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq")


def _read_shapes() -> dict:
    """Launches of K1, K3 and K4 by (B*H, N, D, causal) since the last
    `_reset_counts`."""
    fns = _counters()
    return {name: dict(fns[name].launches_by_shape) for name in _FLASH}


def _read_k2_shapes() -> dict:
    """Launches of K2 by (N, C, d) since the last `_reset_counts`."""
    return dict(_counters()["lfq_head"].launches_by_shape)


def _assert_k7_checked(label: str) -> dict:
    """K7 ran, since the last `_reset_counts`, only at shapes that phase 4b
    holds to its twin (`MASKGIT_CASES`); its launches by (B, HW, V)."""
    k7 = dict(_counters()["maskgit_sample"].launches_by_shape)
    assert set(k7) <= MASKGIT_CHECKED, f"{label}: K7 at {sorted(set(k7) - MASKGIT_CHECKED)}"
    return k7


def _assert_path_kernels(label: str, path: str, show: bool = True) -> dict:
    """The bf16 K1, K3 and K4 launches since the last `_reset_counts` all
    took the tensor-core variant, K1 ran at exactly the shapes
    `PATH_CASES[path]` and K3 and K4 at some of them: phases 3 and 7
    checked every shape that the path launched."""
    fns = _counters()
    by_variant = {name: dict(fns[name].launches_by_variant) for name in _FLASH}
    by_shape = _read_shapes()
    if show:
        print(f"[{label}] K1, K3 and K4 launches by variant: {by_variant}")
        for name, shapes in by_shape.items():
            print(f"[{label}] {name} launches by (B*H, N, D, causal): {shapes}")
    for name, c in by_variant.items():
        assert c["simt"] == 0, f"{label}: a bf16 {name} launch took the CUDA-core variant"
    cases = set(PATH_CASES[path])
    assert set(by_shape["flash_attention_fwd"]) == cases, (
        f"{label}: K1 launched at {sorted(by_shape['flash_attention_fwd'])}, "
        f"PATH_CASES[{path!r}] lists {sorted(cases)}")
    backward = set(by_shape["flash_attention_bwd_dkv"]) | set(by_shape["flash_attention_bwd_dq"])
    assert backward <= cases, f"{label}: K3/K4 launched at {sorted(backward - cases)}, unchecked"
    return by_variant


def phase_compact_train(dev):
    """One compact Genie training step on the card (K1, K3, K4) against the
    same step on the CPU (plain twins): same weights, video and mask, f32
    with TF32 off. Loss, every gradient, and the parameters after AdamW."""
    from open_genie_tpu_torch.models.configs import genie_compact_config
    from open_genie_tpu_torch.train.losses import GenieTrainModule, frozen_param_mask
    from open_genie_tpu_torch.train.loop import make_optimizer
    from open_genie_tpu_torch.utils import init_weights

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(SEED + 6)
    cpu = init_weights(GenieTrainModule(genie_compact_config()), g)
    gpu = copy.deepcopy(cpu).to(dev)
    video = torch.rand(2, 4, 32, 32, 3, generator=g)
    _, tok = cpu.model.tokenizer.tokenize_frozen(video)
    mask = torch.rand(tok.shape, generator=g) < 0.75
    out = {}
    for name, module, d in (("cpu", cpu, "cpu"), ("cuda", gpu, dev)):
        opt = make_optimizer(module, lr=1e-4, weight_decay=0.01, grad_clip=1.0,
                             frozen_mask=frozen_param_mask(module, ("model/tokenizer",)))
        _reset_counts()
        loss, _ = module(video.to(d), mask=mask.to(d))
        loss.backward()
        counts = _read_counts()
        # A copy: the optimizer clips the gradients in place.
        grads = {n: p.grad.detach().cpu().clone()
                 for n, p in module.named_parameters() if p.grad is not None}
        opt.step()
        params = {n: p.detach().cpu() for n, p in module.named_parameters()}
        out[name] = (loss.item(), grads, params, counts)
    (l_cpu, g_cpu, p_cpu, _), (l_gpu, g_gpu, p_gpu, counts) = out["cpu"], out["cuda"]
    assert set(g_cpu) == set(g_gpu) and len(g_gpu) > 0
    g_err = max((g_gpu[n] - g_cpu[n]).abs().max().item() for n in g_cpu)
    p_err = max((p_gpu[n] - p_cpu[n]).abs().max().item() for n in p_cpu)
    print(f"[compact train] loss CUDA {l_gpu:.6f} vs CPU {l_cpu:.6f}; max |d grad| "
          f"{g_err:.3g} over {len(g_gpu)} gradients; max |d param| after AdamW "
          f"{p_err:.3g}; launches {counts}")
    assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu), "compact loss differs"
    for n in g_cpu:
        torch.testing.assert_close(g_gpu[n], g_cpu[n], **PIX_TOL, msg=lambda m, n=n: f"{n}: {m}")
    # One AdamW step moves each weight by about lr (1e-4): a gradient near
    # zero whose sign differs between the two runs moves it the other way.
    assert p_err <= 2.1e-4, "parameters after the step differ"
    assert all(counts[k] > 0 for k in ("flash_attention_fwd", "flash_attention_bwd_dkv",
                                       "flash_attention_bwd_dq", "lfq_head"))


def phase_train_full_width(dev) -> dict:
    """`genie_train_config()` at full width: batch 4 x 16 frames x 64x64,
    bf16 compute on f32 master weights, AdamW, the tokenizer frozen; three
    steps through `make_train_step`."""
    from open_genie_tpu_torch.models.configs import genie_train_config
    from open_genie_tpu_torch.modules.attention import Attention
    from open_genie_tpu_torch.train.losses import GenieTrainModule, frozen_param_mask
    from open_genie_tpu_torch.train.loop import make_optimizer, make_train_step
    from open_genie_tpu_torch.utils import init_weights

    torch.backends.cudnn.deterministic = True
    g = torch.Generator().manual_seed(SEED + 7)
    module = init_weights(GenieTrainModule(genie_train_config()), g).to(dev)
    genie = module.model
    frozen = frozen_param_mask(module, ("model/tokenizer",))
    opt = make_optimizer(module, lr=1e-4, weight_decay=0.01, b1=0.9, b2=0.999,
                         grad_clip=1.0, frozen_mask=frozen)
    step = make_train_step(module, opt, compute_dtype=torch.bfloat16)
    video = torch.rand(4, 16, 64, 64, 3, generator=g).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    tok_before = {n: p.detach().clone() for n, p in genie.tokenizer.named_parameters()}

    def n_attn(m):
        return sum(isinstance(x, Attention) for x in m.modules())

    n_tok = sum(n_attn(layer) for layer in genie.tokenizer.enc_layers)
    n_la, n_dyn = n_attn(genie.latent_action), n_attn(genie.dynamics)
    n_cross = sum(isinstance(x, Attention) and x.key_dim is not None for x in module.modules())
    # The latent action's layers are rematerialized: K1 runs again for each
    # of its attentions in the backward. The frozen tokenizer has no backward.
    expect = {"flash_attention_fwd": n_tok + 2 * n_la + n_dyn,
              "flash_attention_bwd_dkv": n_la + n_dyn,
              "flash_attention_bwd_dq": n_la + n_dyn, "lfq_head": 1,
              "lfq_entropy_fwd": 0, "lfq_entropy_bwd": 0,  # codebooks of <= 4096 codes
              "maskgit_sample": 0}
    print(f"[train] {sum(p.numel() for p in module.parameters()) / 1e6:.1f}M parameters, "
          f"{sum(p.numel() for p in opt.params) / 1e6:.1f}M trainable; attentions: "
          f"tokenizer encoder {n_tok}, latent action {n_la}, dynamics {n_dyn}")

    nonzero = {}
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, n=n: nonzero.__setitem__(n, p.grad.count_nonzero()))
        for n, p in module.named_parameters() if frozen[n]]
    torch.cuda.reset_peak_memory_stats()
    times, counts = [], None
    for i in range(3):
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        metrics = step(video, generator=gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts, shapes = _read_counts(), _read_shapes()
        variants = _assert_path_kernels("train", "train_step", show=i == 0)
        assert all(variants[name]["mma"] == counts[name] for name in _FLASH)
        if i == 0:
            for h in hooks:
                h.remove()
        loss, norm = metrics["loss"].item(), metrics["grad_norm"].item()
        print(f"[train] step {i}: loss {loss:.4f} (act {metrics['act_loss'].item():.4f}, "
              f"dyn {metrics['dyn_loss'].item():.4f}), grad_norm {norm:.4f}, "
              f"{times[-1] * 1e3:.1f} ms, launches {counts}")
        assert math.isfinite(loss) and math.isfinite(norm), "non-finite loss or grad_norm"
        assert counts == expect, f"launches {counts}, expected {expect}"
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    trainable = [n for n in frozen if frozen[n]]
    zero = [n for n in trainable if int(nonzero.get(n, 0)) == 0]
    proj = [n for n in trainable if n.rsplit(".", 2)[-2] in ("to_qkv", "to_q", "to_k", "to_v")]
    print(f"[train] nonzero gradient on {len(trainable) - len(zero)}/{len(trainable)} "
          f"trainable parameters, among them all {len(proj)} attention projections "
          f"(to_qkv / to_q / to_k / to_v) of the latent action and the dynamics")
    assert not zero, f"no gradient reached {zero}"
    assert len(proj) == n_la + n_dyn + 2 * n_cross  # a cross-attention has three
    assert all(torch.equal(p, tok_before[n]) for n, p in genie.tokenizer.named_parameters()), (
        "a frozen tokenizer parameter changed")
    print(f"[train] tokenizer parameters bit-unchanged after 3 steps; "
          f"{(times[1] + times[2]) / 2 * 1e3:.1f} ms per step (mean of steps 1-2, "
          f"step 0 {times[0] * 1e3:.1f} ms); peak memory {peak:.2f} GiB")
    return counts, shapes


def phase_compact_tokenizer_train(dev, cfg=None, label="compact tokenizer"):
    """One compact tokenizer training step on the card (K1, K3, K4 in the
    discriminator, K5/K6 for the 13-bit codebook's entropy) against the
    same step on the CPU (plain twins): same weights, video and frame
    indices, f32 with TF32 off. Loss, every gradient, the parameters after
    AdamW. `cfg`: `TokenizerTrainModule` kwargs (default
    `tokenizer_compact_train_config()`)."""
    from open_genie_tpu_torch.models.configs import tokenizer_compact_train_config
    from open_genie_tpu_torch.train.losses import TokenizerTrainModule, frozen_param_mask
    from open_genie_tpu_torch.train.loop import make_optimizer
    from open_genie_tpu_torch.utils import init_weights, random_frame_idxs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True  # the GAN's two D passes cancel exactly
    g = torch.Generator().manual_seed(SEED + 11)
    cfg = cfg or tokenizer_compact_train_config()
    cpu = init_weights(TokenizerTrainModule(**cfg), g)
    gpu = copy.deepcopy(cpu).to(dev)
    video = torch.rand(2, 4, 32, 32, 3, generator=g)
    k = cfg["gan_frames_per_batch"]
    idxs = {"perc_idxs": random_frame_idxs(g, 2, 4, k), "gan_idxs": random_frame_idxs(g, 2, 4, k)}
    out = {}
    for name, module, d in (("cpu", cpu, "cpu"), ("cuda", gpu, dev)):
        opt = make_optimizer(module, lr=1e-4, frozen_mask=frozen_param_mask(module, ("perc_crit",)))
        _reset_counts()
        loss, _ = module(video.to(d), **{n: i.to(d) for n, i in idxs.items()})
        loss.backward()
        counts = _read_counts()
        grads = {n: p.grad.detach().cpu().clone()
                 for n, p in module.named_parameters() if p.grad is not None}
        opt.step()
        params = {n: p.detach().cpu() for n, p in module.named_parameters()}
        out[name] = (loss.item(), grads, params, counts)
    (l_cpu, g_cpu, p_cpu, _), (l_gpu, g_gpu, p_gpu, counts) = out["cpu"], out["cuda"]
    assert set(g_cpu) == set(g_gpu) and len(g_gpu) > 0
    g_err = max((g_gpu[n] - g_cpu[n]).abs().max().item() for n in g_cpu)
    p_err = max((p_gpu[n] - p_cpu[n]).abs().max().item() for n in p_cpu)
    print(f"[{label}] loss CUDA {l_gpu:.6f} vs CPU {l_cpu:.6f}; max |d grad| "
          f"{g_err:.3g} over {len(g_gpu)} gradients; max |d param| after AdamW {p_err:.3g}; "
          f"launches {counts}")
    assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu), f"{label} loss differs"
    for n in g_cpu:
        torch.testing.assert_close(g_gpu[n], g_cpu[n], **PIX_TOL, msg=lambda m, n=n: f"{n}: {m}")
    assert p_err <= 2.1e-4, "parameters after the step differ"
    assert all(counts[k] > 0 for k in ("flash_attention_fwd", "flash_attention_bwd_dkv",
                                       "flash_attention_bwd_dq", "lfq_entropy_fwd",
                                       "lfq_entropy_bwd"))


def phase_tokenizer_train_full_width(dev, cfg=None, label="tokenizer train",
                                     path="tokenizer_train") -> dict:
    """`tokenizer_train_config()` (the JAX benchmark's MAGVIT2 d=18
    full-loss step; or `cfg`) at batch 4 x 8 frames x 64x64, bf16 compute
    on f32 master weights, the benchmark's AdamW defaults, the VGG frozen;
    three checked steps through `make_train_step`, ten timed, one
    profiled. Returns the launches and shapes of a step and its times."""
    from open_genie_tpu_torch.models.configs import tokenizer_train_config
    from open_genie_tpu_torch.modules.attention import Attention
    from open_genie_tpu_torch.modules.quantization import LookupFreeQuantization
    from open_genie_tpu_torch.train.losses import TokenizerTrainModule, frozen_param_mask
    from open_genie_tpu_torch.train.loop import make_optimizer, make_train_step
    from open_genie_tpu_torch.utils import init_weights

    torch.backends.cudnn.deterministic = True
    g = torch.Generator().manual_seed(SEED + 12)
    module = init_weights(TokenizerTrainModule(**(cfg or tokenizer_train_config())), g).to(dev)
    frozen = frozen_param_mask(module, ("perc_crit",))
    opt = make_optimizer(module, frozen_mask=frozen)  # lr 1e-3, as bench.py's make_optimizer()
    step = make_train_step(module, opt, compute_dtype=torch.bfloat16)
    video = torch.rand(4, 8, 64, 64, 3, generator=g).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    vgg_before = {n: p.detach().clone() for n, p in module.perc_crit.named_parameters()}

    # The discriminator runs three times (d_fs, d_f, d_r), each with a
    # backward; the tokenizer has no attention. One entropy per codebook.
    n_attn = sum(isinstance(m, Attention) for m in module.gan_crit.modules())
    n_lfq = sum(isinstance(m, LookupFreeQuantization) for m in module.modules())
    expect = {"flash_attention_fwd": 3 * n_attn, "flash_attention_bwd_dkv": 3 * n_attn,
              "flash_attention_bwd_dq": 3 * n_attn, "lfq_head": 0,
              "lfq_entropy_fwd": n_lfq, "lfq_entropy_bwd": n_lfq, "maskgit_sample": 0}
    print(f"[{label}] {sum(p.numel() for p in module.parameters()) / 1e6:.1f}M "
          f"parameters, {sum(p.numel() for p in opt.params) / 1e6:.1f}M trainable; "
          f"discriminator attentions {n_attn}, LFQ codebooks {n_lfq}")

    nonzero = {}
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, n=n: nonzero.__setitem__(n, nonzero.get(n, 0) + int(p.grad.count_nonzero())))
        for n, p in module.named_parameters() if frozen[n]]
    torch.cuda.reset_peak_memory_stats()
    times, counts = [], None
    terms = ("rec_loss", "gen_loss", "dis_loss", "perc_loss", "quant_loss",
             "lfq_sample_entropy", "lfq_avg_entropy", "lfq_commit_loss", "lfq_bit_entropy")
    # Steps 0-2 are checked in full; the gradient hooks sync the host once
    # per parameter, so they come off before steps 3-12, which are timed.
    for i in range(3 + TOK_TIMED_STEPS):
        if i == 3:
            for h in hooks:
                h.remove()
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        metrics = step(video, generator=gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts, shapes = _read_counts(), _read_shapes()
        variants = _assert_path_kernels(label, path, show=i == 0)
        assert all(variants[name]["mma"] == counts[name] for name in _FLASH)
        loss, norm = metrics["loss"].item(), metrics["grad_norm"].item()
        assert math.isfinite(loss) and math.isfinite(norm), "non-finite loss or grad_norm"
        assert all(math.isfinite(metrics[k].item()) for k in terms), "a non-finite loss term"
        assert counts == expect, f"launches {counts}, expected {expect}"
        if i >= 3:
            continue
        parts = ", ".join(f"{k} {metrics[k].item():.4f}" for k in terms)
        print(f"[{label}] step {i}: loss {loss:.4f} ({parts}), grad_norm {norm:.4f}, "
              f"{times[-1] * 1e3:.1f} ms, launches {counts}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    # The hinge loss gives D's output bias the gradient (#fake scores above
    # -1 - #real scores below 1) / N: exactly zero while every score lies
    # inside the margin, as from a random init.
    head_bias = "gan_crit.disc.head.bias"
    trainable = [n for n in frozen if frozen[n]]
    zero = [n for n in trainable if nonzero.get(n, 0) == 0]
    n_disc = sum(n.startswith("gan_crit.") for n in trainable)
    print(f"[{label}] nonzero gradient in steps 0-2 on {len(trainable) - len(zero)}/"
          f"{len(trainable)} trainable parameters ({n_disc} of them the discriminator's); "
          f"{head_bias}: {nonzero.get(head_bias, 0)} nonzero entries")
    assert not set(zero) - {head_bias}, f"no gradient reached {zero}"
    assert all(torch.equal(p, vgg_before[n]) for n, p in module.perc_crit.named_parameters()), (
        "a frozen VGG parameter changed")
    timed = sorted(t * 1e3 for t in times[3:])
    ms = statistics.median(timed)
    frames = video.shape[0] * video.shape[1]
    print(f"[{label}] VGG parameters bit-unchanged after {len(times)} steps; "
          f"{ms:.1f} ms per step, {frames / ms * 1e3:.1f} frames/s (median of steps 3-"
          f"{len(times) - 1}, min {timed[0]:.1f}, max {timed[-1]:.1f}; step 0 "
          f"{times[0] * 1e3:.1f} ms); peak memory {peak:.2f} GiB")
    _profile_step(label, lambda: step(video, generator=gen), ms)
    return counts, shapes, {"ms": ms, "min_ms": timed[0], "max_ms": timed[-1], "peak_gib": peak}


def _profile_step(label: str, run, step_ms: float, top: int = 10) -> None:
    """One more call of `run` under `torch.profiler`: the device time of
    its kernels against the unprofiled step time `step_ms`, the kernels
    that took the most of it, and the host ops whose own kernels did (a
    kernel's name does not say which op launched it)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    # Kernels only: an op on the host, or a range annotated on the device
    # (the optimizer's step), is charged its kernels' time as well.
    kern = sorted((e for e in prof.key_averages() if e.device_type.name == "CUDA"
                   and not getattr(e, "is_user_annotation", False)),
                  key=lambda e: e.self_device_time_total, reverse=True)
    device = sum(e.self_device_time_total for e in kern) / 1e3
    if device == 0:
        print(f"[{label} profile] the profiler recorded no device time")
        return
    print(f"[{label} profile] one step: {device:.1f} ms of device time in "
          f"{sum(e.count for e in kern)} kernels, {device / step_ms:.1%} of the "
          f"{step_ms:.1f} ms median step")
    for e in kern[:top]:
        t = e.self_device_time_total / 1e3
        print(f"[{label} profile] {t:9.3f} ms {t / device:6.1%} x{e.count:<5} {e.key[:90]}")
    ops = sorted((e for e in prof.key_averages() if e.device_type.name == "CPU"
                  and not getattr(e, "is_user_annotation", False)),
                 key=lambda e: e.self_device_time_total, reverse=True)
    for e in ops[:top]:
        t = e.self_device_time_total / 1e3
        print(f"[{label} profile] op {t:9.3f} ms {t / device:6.1%} x{e.count:<5} {e.key[:60]}")


def phase_compact_serve(dev) -> None:
    """The compact model's session on the card (kernels) against the same
    session on the CPU (plain twins): same weights, prompt, actions and
    Gumbel noise, f32 with TF32 off; four steps at a horizon of three, so
    the fourth rebases."""
    from open_genie_tpu_torch.models.configs import genie_compact_config
    from open_genie_tpu_torch.models.dynamics import gumbel_noise
    from open_genie_tpu_torch.models.genie import Genie
    from open_genie_tpu_torch.serve import InteractiveSession
    from open_genie_tpu_torch.utils import init_weights

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(SEED + 12)
    cpu = init_weights(Genie(**genie_compact_config()), g).eval()
    gpu = copy.deepcopy(cpu)
    b, spf, n = 2, 4, 4
    prompt = torch.rand(b, 1, 32, 32, 3, generator=g)
    acts = torch.randint(0, cpu.act_vocab, (n, b), generator=g)
    gumbel = gumbel_noise((n, spf, b, 64, 2 ** 8), g)
    runs = {}
    for name, model, device in (("cpu", cpu, "cpu"), ("card", gpu, dev)):
        sess = InteractiveSession(model, max_frames=3, steps_per_frame=spf, device=device)
        assert sess.stream, "the compact decoder streams"
        _reset_counts()
        first = sess.reset(prompt, seed=0)
        frames = [sess.step(acts[i], gumbel=gumbel[i]) for i in range(n)]
        runs[name] = (sess.tokens, first, torch.stack(frames, 1), _read_counts(),
                      sess._rebases)
    (tok_c, first_c, pix_c, _, _), (tok_g, first_g, pix_g, launched, rebases) = runs.values()
    same = torch.equal(tok_g, tok_c)
    err = max((first_g - first_c).abs().max().item(), (pix_g - pix_c).abs().max().item())
    print(f"[compact serve] tokens {tuple(tok_g.shape)} equal CUDA vs CPU: {same}; pixels "
          f"max |d| {err:.3g}; rebases {rebases}; launches K1 "
          f"{launched['flash_attention_fwd']}, K2 {launched['lfq_head']}, "
          f"K7 {launched['maskgit_sample']}")
    assert same, "CUDA session tokens differ from the CPU session's"
    torch.testing.assert_close(first_g, first_c, **PIX_TOL)
    torch.testing.assert_close(pix_g, pix_c, **PIX_TOL)
    assert rebases == 1 and launched["flash_attention_fwd"] > 0 and launched["lfq_head"] == 1
    assert launched["maskgit_sample"] == 2 * spf * n
    k7 = _assert_k7_checked("compact serve")
    assert k7 == {(b, 64, 2 ** 8): 2 * spf * n}, f"K7 launched at {k7}"
    return launched["maskgit_sample"]


def _stream_layers_forced(tok, idxs: torch.Tensor, err) -> list:
    """`err(streamed, batch)` of each decoder layer of `tok`: the layer run
    on the batch decode's input to it, whole and streamed one token frame's
    chunk at a time against fresh stream states. No error carries over
    from the layers before it."""
    b, t, h, w = idxs.shape
    cache = tok.init_stream_cache(b, h, w, t)
    lat = tok.quant.decode_entries(idxs).to(tok.stream_dtype())
    x, out = lat, []
    with torch.inference_mode():
        for i, (layer, has_ext) in enumerate(zip(tok.dec_layers, tok.dec_ext)):
            y = layer(x, lat) if has_ext else layer(x)
            m = x.shape[1] // t
            streamed = torch.cat([tok.stream_layer(i, x[:, p * m:(p + 1) * m], lat[:, p:p + 1],
                                                   cache[i], p) for p in range(t)], 1)
            out.append(err(streamed.float(), y.float()))
            x = y
    return out


def phase_serve_full_width(dev, smi: str) -> dict:
    """`genie_serve_config()` in bf16: the session's launches, its tokens
    against `rollout_tokens`, its frames against the batch decode, a
    rebase, then its times (`bench.py::section_serve`'s loops)."""
    from open_genie_tpu_torch.models.configs import genie_serve_config
    from open_genie_tpu_torch.models.genie import Genie
    from open_genie_tpu_torch.ops.kernels.lfq_head import lfq_head
    from open_genie_tpu_torch.serve import InteractiveSession
    from open_genie_tpu_torch.utils import init_weights

    torch.backends.cudnn.deterministic = True
    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 checks
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(SEED + 13)
    genie = init_weights(Genie(**genie_serve_config()), g).to(dev, torch.bfloat16).eval()
    steps, spf, seed = SERVE_STEPS, 8, SEED + 14
    sess = InteractiveSession(genie, max_frames=steps + 4, steps_per_frame=spf, device=dev)
    assert sess.stream, "genie_serve_config()'s decoder must stream"
    prompt = torch.rand(1, 4, 64, 64, 3, generator=g).to(dev, torch.bfloat16)
    acts = torch.randint(0, genie.act_vocab, (steps + 1,), generator=g).tolist()
    n_dyn = len(genie.dynamics.layers)

    _reset_counts()
    first = sess.reset(prompt, seed=seed)
    per_reset, k2_shapes = _read_counts(), dict(lfq_head.launches_by_shape)
    _assert_path_kernels("serve", "serve")
    frames, lat = [sess.step(acts[0])], []
    per_step = {k: v - per_reset[k] for k, v in _read_counts().items()}
    k7_shapes = _assert_k7_checked("serve")
    for a in acts[1:]:
        t0 = time.perf_counter()
        frames.append(sess.step(a))  # the copy to the host syncs
        lat.append((time.perf_counter() - t0) * 1e3)
    launches = _read_counts()
    variants = _assert_path_kernels("serve", "serve")
    print(f"[serve] launches per reset {per_reset}, K2 by (N, C, d) {k2_shapes}; per step "
          f"{per_step}; reset + {len(frames)} steps {launches}")
    assert variants["flash_attention_fwd"]["mma"] == launches["flash_attention_fwd"]
    assert per_reset["flash_attention_fwd"] == n_dyn and per_reset["lfq_head"] == 1
    assert k2_shapes == {(64, 512, 18): 1}, f"K2 launched at {k2_shapes}"
    assert per_step["flash_attention_fwd"] == n_dyn * (spf + 1) and per_step["lfq_head"] == 0
    assert launches["flash_attention_fwd"] == n_dyn + len(frames) * n_dyn * (spf + 1)
    assert all(launches[k] == 0 for k in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq",
                                          "lfq_entropy_fwd", "lfq_entropy_bwd"))
    print(f"[serve] K7 launches per reset {per_reset['maskgit_sample']}, per step "
          f"{per_step['maskgit_sample']}, by (B, HW, V) {k7_shapes}")
    assert per_reset["maskgit_sample"] == 0 and per_step["maskgit_sample"] == 2 * spf
    assert k7_shapes == {(1, 64, 2 ** 18): 2 * spf}, f"K7 launched at {k7_shapes}"

    # The session's noise is one generator seeded `seed`: the rollout with
    # a generator of that seed gives the same tokens (the horizons round to
    # the same cache length, so every call has the same shapes).
    tokens = sess.tokens.to(dev)
    actions = torch.tensor([[0] + acts], device=dev)
    want = genie.rollout_tokens(tokens[:, :1], actions, len(frames), spf,
                                generator=torch.Generator(device=dev).manual_seed(seed))
    assert torch.equal(tokens, want), "session tokens differ from rollout_tokens"
    # The frames the session streamed against the batch decode of its
    # tokens, and that decode against the f32 decode (weights upcast, TF32
    # off): printed, not held to the bf16 limit, which bounds one op on its
    # inputs. Over the decoder's 31 layers the last-bit differences of other
    # cuDNN algorithms (a 4-frame window against the clip) and of bf16
    # rounding itself grow past it; each layer is held to it below.
    tok32 = copy.deepcopy(genie.tokenizer).float()
    batch = genie.tokenizer.decode_tokens(tokens)
    batch32 = tok32.decode_tokens(tokens)
    tf = batch.shape[1] // tokens.shape[1]
    streamed = torch.cat([first, torch.stack(frames, 1)], 1)
    pick = lambda v: torch.cat([v[:, :tf], v[:, 2 * tf - 1::tf]], 1).cpu()  # noqa: E731
    cache32 = tok32.init_stream_cache(1, 8, 8, tokens.shape[1])
    stream32 = torch.cat([tok32.decode_stream(tokens[:, p], cache32, p)[0]
                          for p in range(tokens.shape[1])], 1)
    print(f"[serve] {streamed.shape[1]} streamed frames against the batch decode of the "
          f"tokens: {bf16_excess(streamed, pick(batch)):.3g} of the bf16 limit; the bf16 batch "
          f"decode against the f32 one: {bf16_excess(batch, batch32):.3g}; f32 stream against "
          f"f32 batch decode: max |d| {(stream32 - batch32).abs().max().item():.3g} "
          f"(rms {batch32.pow(2).mean().sqrt().item():.3g})")
    assert tf == 4 and torch.isfinite(streamed.float()).all()
    del batch, batch32, stream32, cache32
    # Each decoder layer streamed over the batch decode's own input to it,
    # one token frame's chunk at a time: bf16 within the bf16 limit, f32
    # within the JAX package's stream pin.
    worst = _stream_layers_forced(genie.tokenizer, tokens, bf16_excess)
    f32 = _stream_layers_forced(tok32, tokens, lambda a, b: (
        (a - b).abs() / (STREAM_EXACT["atol"] + STREAM_EXACT["rtol"] * b.abs())).max().item())
    print(f"[serve] each of the {len(worst)} decoder layers streamed on the batch decode's "
          f"input to it, {tokens.shape[1]} token frames: bf16 at most {max(worst):.3g} of the "
          f"bf16 limit (layer {worst.index(max(worst))}), f32 at most {max(f32):.3g} of "
          f"atol 2e-5 + rtol 1e-5 (layer {f32.index(max(f32))})")
    assert max(worst) <= 1 and max(f32) <= 1, "a streamed decoder layer disagrees with the batch"
    del tok32

    while sess._t - sess._t0 < sess.max_frames:
        sess.step(0)
    before = _read_counts()
    after_rebase = sess.step(1)
    at_rebase = {k: v - before[k] for k, v in _read_counts().items()}
    keep = sess._keep
    print(f"[serve] rebase onto {keep} frames: launches at that step {at_rebase}")
    assert sess._rebases == 1 and torch.isfinite(after_rebase.float()).all()
    assert at_rebase["flash_attention_fwd"] == n_dyn * (keep + spf + 1)
    assert at_rebase["maskgit_sample"] == 2 * spf

    # step_nosync chained, one sync at the end (fresh horizon: no rebase);
    # the peak memory is the session's own from here on, without the checks.
    torch.cuda.reset_peak_memory_stats()
    sess.reset(prompt, seed=seed + 1)
    sess.step_nosync(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        frame = sess.step_nosync(i % 4)
    torch.cuda.synchronize()
    chained = (time.perf_counter() - t0) * 1e3 / steps
    resets = []
    for i in range(3):
        t0 = time.perf_counter()
        sess.reset(prompt, seed=seed + 2 + i)  # the copy to the host syncs
        resets.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    lat.sort()
    out = {"step_ms_p50": statistics.median(lat),
           "step_ms_p95": lat[min(len(lat) - 1, round(0.95 * len(lat)))],
           "step_ms_min": lat[0], "step_ms_max": lat[-1], "nosync_chained_ms": chained,
           "reset_ms": statistics.median(resets), "peak_gib": peak}
    print(f"[serve] {smi}: step {out['step_ms_p50']:.2f} ms p50, {out['step_ms_p95']:.2f} ms p95 "
          f"(min {lat[0]:.2f}, max {lat[-1]:.2f}) per frame over {steps} host-synced steps; "
          f"step_nosync chained {chained:.2f} ms per frame; reset {out['reset_ms']:.1f} ms "
          f"(median of {[round(r, 1) for r in resets]}); peak memory {peak:.2f} GiB")
    assert torch.isfinite(frame.float()).all()
    _profile_step("serve step", lambda: sess.step(1), out["step_ms_p50"])
    return {"launches": launches, "per_reset": per_reset, "per_step": per_step,
            "at_rebase": at_rebase, "times": out}


def _attn_count(module) -> int:
    from open_genie_tpu_torch.modules.attention import Attention

    return sum(isinstance(m, Attention) for m in module.modules())


def _train_steps(label: str, path: str, step, batch, expect: dict, module, trainable,
                 steps: int, smi: str, allowed_zero=(), **kwargs) -> dict:
    """`steps` calls of the train step `step(batch, **kwargs)` after a
    warm-up call: finite loss and grad norm, launches per step equal to
    `expect` and at the shapes of `PATH_CASES[path]` (every K1, K3 and K4
    on the tensor cores), and a nonzero gradient on every parameter named in
    `trainable` (but `allowed_zero`) in the warm-up call (whose hooks sync
    the host, so it is not timed). Returns the times, peak memory,
    launches and shapes of the last step."""
    nonzero = {}
    params = dict(module.named_parameters())
    hooks = [params[n].register_post_accumulate_grad_hook(
        lambda p, n=n: nonzero.__setitem__(n, nonzero.get(n, 0) + int(p.grad.count_nonzero())))
        for n in trainable]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(1 + steps):
        if i == 1:
            for h in hooks:
                h.remove()
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        metrics = step(batch, **kwargs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        counts, shapes = _read_counts(), _read_shapes()
        variants = _assert_path_kernels(label, path, show=i == 0)
        assert all(variants[name]["mma"] == counts[name] for name in _FLASH)
        loss, norm = metrics["loss"].item(), metrics["grad_norm"].item()
        terms = {k: round(v.item(), 4) for k, v in metrics.items()
                 if k not in ("loss", "grad_norm") and v.numel() == 1}
        print(f"[{label}] step {i}{' (warm-up)' if i == 0 else ''}: loss {loss:.4f}, grad_norm "
              f"{norm:.4f}, {times[-1]:.1f} ms, terms {terms}, launches {counts}")
        assert math.isfinite(loss) and math.isfinite(norm), "non-finite loss or grad_norm"
        assert all(math.isfinite(v) for v in terms.values()), "a non-finite loss term"
        assert counts == expect, f"launches {counts}, expected {expect}"
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    zero = [n for n in trainable if nonzero.get(n, 0) == 0 and n not in allowed_zero]
    print(f"[{label}] nonzero gradient in the warm-up step on "
          f"{sum(nonzero.get(n, 0) > 0 for n in trainable)}/{len(trainable)} trainable "
          f"parameters")
    assert not zero, f"no gradient reached {zero}"
    ms = statistics.median(times[1:])
    print(f"[{label}] {smi}: {ms:.1f} ms per step (median of steps 1-{steps}, min "
          f"{min(times[1:]):.1f}, max {max(times[1:]):.1f}; warm-up {times[0]:.1f} ms); peak "
          f"memory {peak:.2f} GiB; launches per step {counts}")
    for name in _FLASH:
        print(f"[{label}] {name} launches per step by (B*H, N, D, causal): {shapes[name]}")
    return {"ms": ms, "warmup_ms": times[0], "peak_gib": peak, "launches": counts,
            "shapes": shapes}


def _inference(label: str, path: str, run, expect: dict, smi: str) -> tuple:
    """`run()` once with the counts at 0: its result, ms, peak memory,
    launches (equal to `expect`) at the shapes of `PATH_CASES[path]`, all
    on the tensor cores."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts, shapes = _read_counts(), _read_shapes()
    variants = _assert_path_kernels(label, path, show=False)
    assert variants["flash_attention_fwd"]["mma"] == counts["flash_attention_fwd"]
    k7 = _assert_k7_checked(label)
    print(f"[{label}] {smi}: {ms:.1f} ms, peak memory {peak:.2f} GiB; launches {counts}; "
          f"K1 by (B*H, N, D, causal) {shapes['flash_attention_fwd']}"
          f"{f'; K7 by (B, HW, V) {k7}' if k7 else ''}")
    assert counts == expect, f"launches {counts}, expected {expect}"
    return out, {"ms": ms, "peak_gib": peak, "launches": counts, "shapes": shapes}


def phase_stage1(dev, smi: str) -> dict:
    """Stage 1: `TokenizerTrainModule(**tokenize_yaml_config())` (the
    repo's `configs/tokenize.yaml`: a 64-wide encoder into the 10-bit
    codebook through the LFQ's projection) on its own batch, 8 x 16 frames
    x 64x64, bf16 compute on f32 weights, AdamW lr 1e-3, wd 0.01, the VGG
    frozen; a warm-up step and 3 steps; then `evaluate_tokenizer` of a bf16
    copy over 2 batches."""
    from open_genie_tpu_torch.eval import evaluate_tokenizer
    from open_genie_tpu_torch.models.configs import tokenize_yaml_config
    from open_genie_tpu_torch.train.losses import TokenizerTrainModule, frozen_param_mask
    from open_genie_tpu_torch.train.loop import make_optimizer, make_train_step
    from open_genie_tpu_torch.utils import init_weights

    torch.backends.cudnn.deterministic = True
    g = torch.Generator().manual_seed(SEED + 16)
    module = init_weights(TokenizerTrainModule(**tokenize_yaml_config()), g).to(dev)
    assert module.model.quant.project and not module.model.head_fusable()
    frozen = frozen_param_mask(module, ("perc_crit",))
    opt = make_optimizer(module, lr=1e-3, weight_decay=0.01, frozen_mask=frozen)
    step = make_train_step(module, opt, compute_dtype=torch.bfloat16)
    video = torch.rand(*STAGE1_BATCH, 64, 64, 3, generator=g).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    n_tok, n_disc = _attn_count(module.model), _attn_count(module.gan_crit)
    # remat: each tokenizer attention runs K1 again in the backward; the
    # discriminator runs three times (d_fs, d_f, d_r), each with a backward.
    # d = 10: the entropy takes the direct softmax, not K5/K6.
    expect = {"flash_attention_fwd": 2 * n_tok + 3 * n_disc,
              "flash_attention_bwd_dkv": n_tok + 3 * n_disc,
              "flash_attention_bwd_dq": n_tok + 3 * n_disc, "lfq_head": 0,
              "lfq_entropy_fwd": 0, "lfq_entropy_bwd": 0, "maskgit_sample": 0}
    print(f"[stage1] {sum(p.numel() for p in module.parameters()) / 1e6:.1f}M parameters, "
          f"{sum(p.numel() for p in opt.params) / 1e6:.1f}M trainable; attentions: tokenizer "
          f"{n_tok}, discriminator {n_disc}")
    vgg_before = {n: p.detach().clone() for n, p in module.perc_crit.named_parameters()}
    out = _train_steps("stage1", "stage1_train", step, video, expect, module,
                       [n for n in frozen if frozen[n]], 3, smi,
                       # the hinge gives D's output bias no gradient while
                       # every score lies in the margin (see phase 12)
                       allowed_zero=("gan_crit.disc.head.bias",), generator=gen)
    assert all(torch.equal(p, vgg_before[n]) for n, p in module.perc_crit.named_parameters())
    frames = video.shape[0] * video.shape[1]
    out["frames_per_s"] = frames / out["ms"] * 1e3
    print(f"[stage1] {smi}: {out['frames_per_s']:.1f} frames/s; VGG parameters bit-unchanged")
    _profile_step("stage1", lambda: step(video, generator=gen), out["ms"])

    tok16 = copy.deepcopy(module.model).to(torch.bfloat16).eval()
    del module, opt, step
    torch.cuda.empty_cache()
    loader = [torch.rand(*STAGE1_BATCH, 64, 64, 3, generator=g) for _ in range(2)]
    scores, ev = _inference(
        "stage1 eval", "stage1_eval", lambda: evaluate_tokenizer(tok16, loader),
        {"flash_attention_fwd": 2 * n_tok, "flash_attention_bwd_dkv": 0,
         "flash_attention_bwd_dq": 0, "lfq_head": 0, "lfq_entropy_fwd": 0,
         "lfq_entropy_bwd": 0, "maskgit_sample": 0}, smi)
    print(f"[stage1 eval] {smi}: PSNR {scores['psnr']:.3f} dB, SSIM {scores['ssim']:.4f}, "
          f"usage {scores['usage']:.4f} ({scores['distinct_codes']:.0f} of 1024 codes), "
          f"perplexity {scores['perplexity']:.1f}, over {scores['num_batches']} batches")
    assert scores["num_batches"] == 2 and all(math.isfinite(v) for v in scores.values())
    assert scores["num_tokens"] == 2 * math.prod(STAGE1_BATCH) * 32 * 32
    out["eval"] = {**ev, "scores": scores}
    return out


def phase_stage2_3(dev, smi: str) -> dict:
    """Stage 2 -> 3: `ActionTrainModule` at `genie_train_config()`'s latent
    action (batch 4 x 16 x 64x64, bf16, AdamW lr 1e-4); its weights into a
    `Genie(**genie_train_config())` whose `tokenize_with_actions` turns 32
    clips of 16 frames (chunks of 4) into tokens (32, 16, 16, 16) and
    actions (32, 16), K2 once a chunk; `DynamicsTrainModule(
    **dynamics_yaml_config())` on that batch, 3 steps at a constant lr 3e-4
    (the YAML's warm-up and cosine schedule wait for the trainer stack);
    cached `generate` of a bf16 copy, 10 steps, one frame onto 15; and
    `evaluate_dynamics` over two batches of 16."""
    from open_genie_tpu_torch.eval import evaluate_dynamics
    from open_genie_tpu_torch.models.configs import dynamics_yaml_config, genie_train_config
    from open_genie_tpu_torch.models.genie import Genie
    from open_genie_tpu_torch.ops.kernels.lfq_head import lfq_head
    from open_genie_tpu_torch.train.losses import ActionTrainModule, DynamicsTrainModule
    from open_genie_tpu_torch.train.loop import make_optimizer, make_train_step
    from open_genie_tpu_torch.utils import init_weights

    torch.backends.cudnn.deterministic = True
    g = torch.Generator().manual_seed(SEED + 18)
    cfg = genie_train_config()
    none = dict.fromkeys(_counters(), 0)
    act = init_weights(ActionTrainModule(cfg["latent_action"]), g).to(dev)
    opt = make_optimizer(act, lr=1e-4, weight_decay=0.01)
    n_la = _attn_count(act)
    # Remat: K1 twice per attention; d = 8, so no K5/K6.
    out = {"action": _train_steps(
        "action train", "action_train", make_train_step(act, opt, compute_dtype=torch.bfloat16),
        torch.rand(*STAGE2_BATCH, 64, 64, 3, generator=g).to(dev),
        {**none, "flash_attention_fwd": 2 * n_la, "flash_attention_bwd_dkv": n_la,
         "flash_attention_bwd_dq": n_la}, act, list(dict(act.named_parameters())), 3, smi)}

    genie = init_weights(Genie(**cfg), g)
    genie.latent_action.load_state_dict(act.model.state_dict())
    genie = genie.to(dev, torch.bfloat16).eval()
    del act, opt
    clips = torch.rand(*STAGE3_BATCH, 64, 64, 3, generator=g)
    n_chunks = STAGE3_BATCH[0] // STAGE3_CHUNK
    n_tok = sum(_attn_count(layer) for layer in genie.tokenizer.enc_layers)
    n_la = _attn_count(genie.latent_action)

    def tokenize():
        parts = [genie.tokenize_with_actions(c.to(dev, torch.bfloat16))
                 for c in clips.split(STAGE3_CHUNK)]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])

    (tokens, actions), tw = _inference(
        "tokenize_with_actions", "tokenize_with_actions", tokenize,
        {**none, "flash_attention_fwd": n_chunks * (n_tok + n_la), "lfq_head": n_chunks}, smi)
    k2 = dict(lfq_head.launches_by_shape)
    print(f"[tokenize_with_actions] tokens {tuple(tokens.shape)} in [{int(tokens.min())}, "
          f"{int(tokens.max())}], actions {tuple(actions.shape)} in [{int(actions.min())}, "
          f"{int(actions.max())}]; K2 by (N, C, d) {k2}")
    assert tuple(tokens.shape) == (*STAGE3_BATCH, 16, 16)
    assert tuple(actions.shape) == STAGE3_BATCH
    assert 0 <= int(tokens.min()) and int(tokens.max()) < 1024
    assert 0 <= int(actions.min()) and int(actions.max()) < 256
    assert k2 == {(STAGE3_CHUNK * STAGE3_BATCH[1] * 256, 64, 10): n_chunks}, (
        f"K2 launched at {k2}")
    out["tokenize_with_actions"] = {**tw, "k2_shapes": {str(k): v for k, v in k2.items()}}
    del genie
    torch.cuda.empty_cache()

    dyn = init_weights(DynamicsTrainModule(**dynamics_yaml_config()), g).to(dev)
    opt = make_optimizer(dyn, lr=3e-4, weight_decay=0.01)
    n_dyn, n_layers = _attn_count(dyn), len(dyn.model.layers)
    batch = {"tokens": tokens, "actions": actions}
    step = make_train_step(dyn, opt, compute_dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)  # the stage-3 masks and noise
    out["dynamics"] = _train_steps(
        "dynamics train", "dynamics_train", step, batch,
        {**none, "flash_attention_fwd": n_dyn, "flash_attention_bwd_dkv": n_dyn,
         "flash_attention_bwd_dq": n_dyn}, dyn, list(dict(dyn.named_parameters())), 3, smi,
        generator=gen)
    _profile_step("dynamics train", lambda: step(batch, generator=gen),
                  out["dynamics"]["ms"])

    dyn16 = copy.deepcopy(dyn.model).to(torch.bfloat16).eval()
    del dyn, opt, step
    assert dyn16.supports_cached_decode()
    steps, hist = 10, STAGE3_BATCH[1] - 1
    new, gen_out = _inference(
        "generate", "generate",
        lambda: dyn16.generate(tokens[:, :hist], actions[:, :hist], steps, generator=gen),
        {**none, "flash_attention_fwd": n_layers * (hist + steps), "maskgit_sample": 2 * steps},
        smi)
    print(f"[generate] {tuple(new.shape)}, new frame's ids in [{int(new[:, hist].min())}, "
          f"{int(new[:, hist].max())}]")
    assert tuple(new.shape) == (STAGE3_BATCH[0], hist + 1, 16, 16)
    assert torch.equal(new[:, :hist], tokens[:, :hist])
    assert 0 <= int(new.min()) and int(new.max()) < 1024
    out["generate"] = gen_out

    half = STAGE3_BATCH[0] // 2
    loader = [{"tokens": tokens[:half], "actions": actions[:half]},
              {"tokens": tokens[half:], "actions": actions[half:]}]
    scores, ev = _inference(
        "eval dynamics", "eval_dynamics",
        lambda: evaluate_dynamics(dyn16, loader, generator=gen),
        {**none, "flash_attention_fwd": 2 * n_dyn}, smi)
    print(f"[eval dynamics] {smi}: loss {scores['loss']:.4f}, masked_acc "
          f"{scores['masked_acc']:.4f}, masked_frac {scores['masked_frac']:.4f} over "
          f"{scores['num_batches']} batches")
    assert scores["num_batches"] == 2 and all(math.isfinite(v) for v in scores.values())
    out["eval_dynamics"] = {**ev, "scores": scores}
    return out


def phase_rollout_full(dev, smi: str) -> dict:
    """`rollout_tokens_full` at `genie_rollout_config()` in bf16: a 64x64
    prompt frame, 2 frames at 8 MaskGIT steps, each step re-forwarding the
    dynamics over the whole 3-frame buffer. Its tokens in range; the share
    equal to the cached `rollout_tokens` under the same noise is printed,
    not held (bf16 can flip a tied commit)."""
    from open_genie_tpu_torch.models.configs import genie_rollout_config
    from open_genie_tpu_torch.models.genie import Genie
    from open_genie_tpu_torch.utils import init_weights

    torch.backends.cudnn.deterministic = True
    g = torch.Generator().manual_seed(SEED + 20)
    genie = init_weights(Genie(**genie_rollout_config()), g).to(dev, torch.bfloat16).eval()
    frames, spf = 2, 8
    prompt = torch.rand(1, 1, 64, 64, 3, generator=g).to(dev, torch.bfloat16)
    actions = torch.randint(0, genie.act_vocab, (1, 1 + frames), generator=g).to(dev)
    n_tok = sum(_attn_count(layer) for layer in genie.tokenizer.enc_layers)
    n_dyn = _attn_count(genie.dynamics)
    # Both rollouts draw the same noise: a generator of the same seed each.
    noise = lambda: torch.Generator(device=dev).manual_seed(SEED + 21)  # noqa: E731

    def run():
        tokens = genie.tokenize_prompt(prompt)
        return tokens, genie.rollout_tokens_full(tokens, actions, frames, spf, generator=noise())

    (tokens, full), out = _inference(
        "rollout full", "rollout_full", run,
        {"flash_attention_fwd": n_tok + frames * spf * n_dyn, "flash_attention_bwd_dkv": 0,
         "flash_attention_bwd_dq": 0, "lfq_head": 1, "lfq_entropy_fwd": 0,
         "lfq_entropy_bwd": 0, "maskgit_sample": 2 * frames * spf}, smi)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cached = genie.rollout_tokens(tokens, actions, frames, spf, generator=noise())
    torch.cuda.synchronize()
    cached_ms = (time.perf_counter() - t0) * 1e3
    same = (cached[:, 1:] == full[:, 1:]).float().mean().item()
    print(f"[rollout full] tokens {tuple(full.shape)} in [{int(full.min())}, "
          f"{int(full.max())}]; {same:.4f} of the generated tokens equal the cached "
          f"rollout_tokens' under the same noise; {smi}: {out['ms'] / frames:.1f} ms per "
          f"generated frame (with the prompt's tokenize), cached {cached_ms / frames:.1f}")
    assert tuple(full.shape) == (1, 1 + frames, 16, 16)
    assert torch.equal(full[:, :1], tokens)
    assert 0 <= int(full.min()) and int(full.max()) < 2 ** 10
    return {**out, "equal_to_cached": same, "cached_ms": cached_ms}


def phase_stage_shapes(dev, launches: dict, paths=STAGE_PATHS, tag="stage shapes",
                       extra=()) -> list:
    """K1, and K3 and K4 where a training path of `paths` (phases 16 to 18,
    27 and 28, or 30) launched them, in bf16 at every shape that those
    paths brought and no other path has (and at the shapes `extra`), as
    CUDA graphs: beside PyTorch's flash forward (SDPA) and aten's flash
    backward, the plain twins where one call holds at most 2^27 logits, the
    bounds and each path's launches of the shape (`launches`: path ->
    kernel -> shape -> count, one step or one call)."""
    from open_genie_tpu_torch.ops.kernels.flash_attention import (
        flash_attention,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_bwd_plain,
        flash_attention_plain,
    )

    older = {c for path, cases in PATH_CASES.items() if path not in paths for c in cases}
    new = sorted({c for path in paths for c in PATH_CASES[path]} - older | set(extra))
    g = torch.Generator(device=dev).manual_seed(SEED + 22)
    rows = []
    for case in new:
        bh, n, d, causal = case
        per_path = {path: [launches[path][name].get(case, 0) for name in _FLASH]
                    for path in paths if case in PATH_CASES[path]}
        trained = any(c[1] for c in per_path.values())
        q, k, v, do = (torch.randn(bh, n, d, generator=g, device=dev, dtype=torch.bfloat16)
                       for _ in range(4))
        s = d ** -0.5
        o, lse = flash_attention(q, k, v, s, causal)
        fns = {"K1": lambda: flash_attention(q, k, v, s, causal),
               "sdpa": lambda: sdpa_forward(q, k, v, s, causal)}
        small = bh * n * n <= 2 ** 27
        if small:
            fns["K1 plain"] = lambda: flash_attention_plain(q, k, v, s, causal)
        if trained:
            delta = (do.float() * o.float()).sum(-1)
            fns["K3"] = lambda: flash_attention_bwd_dkv(q, k, v, do, lse, delta, s, causal)
            fns["K4"] = lambda: flash_attention_bwd_dq(q, k, v, do, lse, delta, s, causal)
            fns["aten"] = aten_flash_backward(q, k, v, do, s, causal)
            if small:
                fns["bwd plain"] = lambda: flash_attention_bwd_plain(q, k, v, o, lse, do, s,
                                                                     causal)
        iters = 10 if bh * n * n > 2 ** 30 else 50
        ms = alternate({name: (fn, iters) for name, fn in fns.items()}, graph=True)
        _release_capture_stream()
        row = {"shape": list(case), "launches": per_path, "K1": {
            "ms": ms["K1"], "library_ms": ms["sdpa"], "plain_ms": ms.get("K1 plain"),
            **flash_bound("fwd", bh, n, d, causal)}}
        text = (f"K1 {ms['K1']:.4f} ms, SDPA flash forward {ms['sdpa']:.4f}, plain "
                f"{ms['K1 plain']:.4f}" if small else
                f"K1 {ms['K1']:.4f} ms, SDPA flash forward {ms['sdpa']:.4f}, plain not timed "
                f"(over 2^27 logits)")
        text += f", bound {row['K1']['bound_ms']:.5f} ({row['K1']['bound_by']})"
        if trained:
            for label, kind in (("K3", "dkv"), ("K4", "dq")):
                row[label] = {"ms": ms[label], "library_ms": ms["aten"],
                              "plain_ms": ms.get("bwd plain"),
                              **flash_bound(kind, bh, n, d, causal)}
            text += (f"; K3 {ms['K3']:.4f}, K4 {ms['K4']:.4f}, K3 + K4 "
                     f"{ms['K3'] + ms['K4']:.4f} ms, aten flash backward {ms['aten']:.4f}"
                     + (f", plain backward {ms['bwd plain']:.4f}" if small else "")
                     + f", bound K3 {row['K3']['bound_ms']:.5f} ({row['K3']['bound_by']}), "
                     f"K4 {row['K4']['bound_ms']:.5f} ({row['K4']['bound_by']})")
        print(f"[{tag}] bf16 (BH,N,D,causal)={case}, CUDA graphs: {text}; launches "
              f"(K1, K3, K4) per step or call {per_path}")
        rows.append(row)
        del q, k, v, do, o, lse, fns
    return rows


# --------------------------------------------------------------------- #
# Phases 20 to 22: the trainer through its CLI, on the repo's YAMLs
# --------------------------------------------------------------------- #

def yaml_copy(name: str, out_dir: Path, overrides: dict) -> str:
    """`configs/<name>` with `overrides` merged into it (nested dicts merge
    key by key), written to `out_dir`; returns the copy's path."""
    import yaml

    def merge(raw, over):
        for k, v in over.items():
            if isinstance(v, dict) and isinstance(raw.get(k), dict):
                merge(raw[k], v)
            else:
                raw[k] = v
        return raw

    with open(HERE / "configs" / name) as f:
        raw = yaml.safe_load(f)
    path = out_dir / f"{Path(name).stem}_{len(list(out_dir.glob('*.yaml')))}.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(merge(raw, copy.deepcopy(overrides)), f, sort_keys=False)
    return str(path)


def trainer_overrides(run_dir: Path, **trainer) -> dict:
    """The `trainer:` keys a phase's copy overrides: where checkpoints and
    logs go, a log line per step (the per-step checks read them), and the
    phase's run length, validation and checkpoint cadence."""
    return {"trainer": {"ckpt_dir": str(run_dir / "ckpt"), "log_dir": str(run_dir / "logs"),
                        "log_every_n_steps": 1, **trainer}}


def read_jsonl(log_dir) -> list:
    with open(Path(log_dir) / "train_metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def dir_bytes(path) -> int:
    return sum(p.stat().st_size for p in Path(path).rglob("*") if p.is_file())


def _diff(now: dict, before: dict) -> dict:
    return {k: now[k] - before.get(k, 0) for k in now}


class _Tf32Off:
    """TF32 off and cuDNN deterministic inside, restored after."""

    def __enter__(self):
        b = torch.backends
        self.saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.deterministic)
        b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
        b.cudnn.deterministic = True

    def __exit__(self, *exc):
        b = torch.backends
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.deterministic = self.saved
        return False


class TrainerWatch:
    """While a trainer runs through the CLI: the kernels' counts start at 0,
    and each call of its `MetricLogger.log` or `CheckpointWriter.save`
    marks a point (after a device sync). The launches, their shapes and
    the host time since the previous mark go to what ended there: a train
    step at a train record (`steps`), a validation at a `val_` record
    (`vals`), a save at its return (`saves`, with its seconds and bytes).
    The first step of a run also carries the run's set-up."""

    def __init__(self):
        self.steps, self.vals, self.saves, self._run_starts = [], [], [], []

    def _mark(self) -> tuple:
        torch.cuda.synchronize()
        now = (time.perf_counter(), _read_counts(), _read_shapes())
        t, counts, shapes = self._last
        self._last = now
        return ((now[0] - t) * 1e3, _diff(now[1], counts),
                {k: _diff(now[2][k], shapes[k]) for k in now[2]})

    def __enter__(self):
        from open_genie_tpu_torch.train.loop import CheckpointWriter
        from open_genie_tpu_torch.train.metrics import MetricLogger

        self._patched = [(MetricLogger, "log", MetricLogger.log),
                         (CheckpointWriter, "save", CheckpointWriter.save)]
        log, save = MetricLogger.log, CheckpointWriter.save
        watch = self

        def watched_log(logger, step, metrics):
            ms, counts, shapes = watch._mark()
            val = any(k.startswith("val_") for k in metrics)
            (watch.vals if val else watch.steps).append(
                {"step": step, "ms": ms, "launches": counts,
                 "shapes": {k: {c: n for c, n in v.items() if n} for k, v in shapes.items()}})
            return log(logger, step, metrics)

        def watched_save(writer, state, step=None, **kwargs):
            seconds = save(writer, state, step, **kwargs)
            step = state.step if step is None else step
            watch._mark()
            watch.saves.append({"step": step, "seconds": seconds, "dir": writer.dir,
                                "bytes": dir_bytes(Path(writer.dir) / str(step))})
            return seconds

        MetricLogger.log, CheckpointWriter.save = watched_log, watched_save
        _reset_counts()
        torch.cuda.synchronize()
        self._last = (time.perf_counter(), _read_counts(), _read_shapes())
        return self

    def __exit__(self, *exc):
        for cls, name, fn in self._patched:
            setattr(cls, name, fn)
        return False

    def new_run(self) -> None:
        """The next step carries a new run's set-up: not a steady step."""
        self._run_starts.append(len(self.steps))

    def steady_ms(self) -> list:
        return [s["ms"] for i, s in enumerate(self.steps) if i not in self._run_starts]


def assert_trainer_launches(label: str, path: str, steps: list, expect: dict) -> None:
    """Every train step launched `expect`; over the whole watch (steps and
    validations) every bf16 K1, K3 and K4 took the tensor cores, K1 at
    exactly the shapes of `PATH_CASES[path]`."""
    _assert_path_kernels(label, path)
    for s in steps:
        assert s["launches"] == expect, f"{label} step {s['step']}: {s['launches']} != {expect}"


def assert_tokenize_launches(counts: dict, k2: dict, n_clips: int, per_clip: int) -> None:
    """`cli tokenize-data` launched K2 once a clip at (4096, 64, 10) and K1
    `per_clip` times a clip, on the tensor cores at the shapes of
    `PATH_CASES["tokenize_data"]`."""
    _assert_path_kernels("tokenize-data", "tokenize_data")
    assert k2 == {(4096, 64, 10): n_clips}, f"K2 launched at {k2}"
    assert counts == {"flash_attention_fwd": n_clips * per_clip, "lfq_head": n_clips,
                      "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq": 0,
                      "lfq_entropy_fwd": 0, "lfq_entropy_bwd": 0, "maskgit_sample": 0}, counts


def anneal_scales(steps: int, start: int, ramp: int, floor: float) -> list:
    """The scale a linear anneal from 1 to `floor` over `ramp` steps from
    `start` gives at steps 0 to `steps` - 1 (the trainer's
    `bit_balance_scale`), in float64."""
    return [min(max(1.0 - (s - start) / ramp, floor), 1.0) for s in range(steps)]


def ema_recursion_error(trace: list, decay: float) -> tuple:
    """The recursion `ema_k = decay * ema_(k-1) + (1 - decay) * p_k` in
    float64 from the first update's parameters (the EMA starts as a copy of
    them), over `trace` (per update: `before`, the parameters before it,
    `after` and `ema` after it, each `{name: tensor}`): `(largest
    |difference| from the EMA each update left, in units of its value's
    bound, the recursion's last EMA, the bound of each value, the median
    motion of that EMA from the first update's parameters in units of the
    bound)`. Each f32 update rounds twice, and `decay` and `1 - decay` once
    each, by at most 2^-24 of the value's largest magnitude in the run: the
    bound is 4 * 2^-24 * that magnitude per update. The check has teeth
    where the EMA moves far beyond it: an update skipped or taken from the
    parameters before it, or an EMA left at its start, is then off by
    about that motion."""
    names = list(trace[0]["before"])
    mag = {n: torch.stack([trace[0]["before"][n].double().abs()]
                          + [t[k][n].double().abs() for t in trace for k in ("after", "ema")]
                          ).amax(0) for n in names}
    bound = {n: (4 * 2 ** -24 * len(trace) * mag[n]).clamp_min(1e-30) for n in names}
    ema = {n: trace[0]["before"][n].double() for n in names}
    err = 0.0
    for t in trace:
        ema = {n: decay * ema[n] + (1 - decay) * t["after"][n].double() for n in names}
        err = max(err, max(((ema[n] - t["ema"][n].double()).abs() / bound[n]).max().item()
                           for n in names))
    moved = torch.cat([((ema[n] - trace[0]["before"][n].double()).abs() / bound[n]).flatten()
                       for n in names]).median().item()
    return err, ema, bound, moved


def _finite_records(label: str, records: list) -> None:
    bad = [(r["step"], k) for r in records for k, v in r.items()
           if k != "time" and not math.isfinite(v)]
    assert not bad, f"{label}: non-finite logged values {bad}"


def phase_trainer_tokenizer(dev, smi: str, bare_ms: float, work: Path) -> dict:
    """`cli train tokenizer --config configs/tokenize.yaml` at full width
    (synthetic 8 x 16 x 64x64 clips, bf16 on f32 weights, the VGG frozen):
    6 steps with a validation and a save at step 3, then `--resume` to
    step 8. Finite logged terms, the cadence of the log lines, the step
    directories `max_to_keep` leaves and `best/`, the launches of every
    step (phase 16's), the VGG of the last checkpoint the one the seed drew;
    the trainer's ms per step beside phase 16's bare step, save times and
    sizes, peak memory."""
    from open_genie_tpu_torch.cli import main as cli
    from open_genie_tpu_torch.models.configs import tokenize_yaml_config
    from open_genie_tpu_torch.train.config import load_config
    from open_genie_tpu_torch.train.losses import TokenizerTrainModule
    from open_genie_tpu_torch.train.loop import all_steps, load_checkpoint
    from open_genie_tpu_torch.train.trainer import build_tokenizer_module, init_module

    run = work / "tokenizer"
    cfg = yaml_copy("tokenize.yaml", work, trainer_overrides(
        run, max_steps=6, val_check_interval=3, limit_val_batches=1, ckpt_every_n_steps=3))
    with torch.device("meta"):
        meta = TokenizerTrainModule(**tokenize_yaml_config())
    n_tok, n_disc = _attn_count(meta.model), _attn_count(meta.gan_crit)
    expect = {"flash_attention_fwd": 2 * n_tok + 3 * n_disc,
              "flash_attention_bwd_dkv": n_tok + 3 * n_disc,
              "flash_attention_bwd_dq": n_tok + 3 * n_disc, "lfq_head": 0,
              "lfq_entropy_fwd": 0, "lfq_entropy_bwd": 0, "maskgit_sample": 0}
    torch.cuda.reset_peak_memory_stats()
    with TrainerWatch() as watch:
        watch.new_run()
        cli(["train", "tokenizer", "--config", cfg])
        watch.new_run()
        state = cli(["train", "tokenizer", "--config", cfg, "--resume", "--max-steps", "8"])
        assert_trainer_launches("trainer tokenizer", "stage1_train", watch.steps, expect)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    records = read_jsonl(run / "logs")
    _finite_records("trainer tokenizer", records)
    train = [r["step"] for r in records if "loss" in r]
    val = [r["step"] for r in records if "val_loss" in r]
    assert train == list(range(1, 9)) and val == [3, 6], (train, val)
    assert all_steps(str(run / "ckpt")) == [6, 8], all_steps(str(run / "ckpt"))
    best = all_steps(str(run / "ckpt" / "best"))
    assert len(best) == 1 and best[0] in (3, 6), best
    assert state.step == 8
    ckpt, _ = load_checkpoint(str(run / "ckpt"))
    mcfg = load_config(cfg, "tokenizer")
    fresh = init_module(build_tokenizer_module(mcfg.model), mcfg.trainer.seed, "cpu")
    vgg = {n: p for n, p in fresh.state_dict().items() if n.startswith("perc_crit.")}
    assert vgg and all(torch.equal(ckpt["params"][n], p) for n, p in vgg.items())
    steady = watch.steady_ms()
    ms = statistics.median(steady)
    saves = [(s["step"], round(s["seconds"], 3), round(s["bytes"] / 2 ** 20, 1))
             for s in watch.saves]
    print(f"[trainer tokenizer] {smi}: launches per step {watch.steps[-1]['launches']}; logged "
          f"steps {train}, validations {val}; step dirs {all_steps(str(run / 'ckpt'))}, "
          f"best/{best[0]}; VGG of the last checkpoint equal to the seed's")
    print(f"[trainer tokenizer] {smi}: {ms:.1f} ms per step through the CLI (median of "
          f"{len(steady)} steps, min {min(steady):.1f}, max {max(steady):.1f}) against phase "
          f"16's bare step {bare_ms:.1f} ms: {ms - bare_ms:+.1f} ms of loader and loop; "
          f"saves (step, s, MiB) {saves}; validations "
          f"{[round(v['ms'], 1) for v in watch.vals]} ms; peak memory {peak:.2f} GiB")
    return {"ms": ms, "bare_ms": bare_ms, "peak_gib": peak, "saves": watch.saves,
            "launches": watch.steps[-1]["launches"], "shapes": watch.steps[-1]["shapes"],
            "val_ms": [v["ms"] for v in watch.vals]}


def phase_trainer_dynamics(dev, smi: str, work: Path) -> dict:
    """`cli tokenize-data` on `configs/genie.yaml` (random weights from the
    seed): 32 train and 8 validation shards of 16 frames, one clip at a
    time (K2 once a clip at (4096, 64, 10)); then `cli train dynamics
    --config configs/dynamics.yaml` at full width (6 x 512, batch 32) on
    them, warm-up 2 and cosine to step 8: the lr each step logged is the
    schedule's, the launches of every step (phase 17's), and a run resumed
    at step 4 ends on the parameters of an uninterrupted 8-step run
    (cuDNN deterministic, TF32 off)."""
    from open_genie_tpu_torch.cli import main as cli
    from open_genie_tpu_torch.data.tokens import TokenClipDataset
    from open_genie_tpu_torch.models.configs import dynamics_yaml_config, genie_train_config
    from open_genie_tpu_torch.models.genie import Genie
    from open_genie_tpu_torch.ops.kernels.lfq_head import lfq_head
    from open_genie_tpu_torch.train.config import load_config
    from open_genie_tpu_torch.train.loop import load_checkpoint
    from open_genie_tpu_torch.train.losses import DynamicsTrainModule

    tokens = work / "tokens"
    with torch.device("meta"):
        genie = Genie(**genie_train_config())
    per_clip = sum(_attn_count(layer) for layer in genie.tokenizer.enc_layers) + _attn_count(
        genie.latent_action)
    clips = {"train": 32, "val": 8}
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    for split, n in clips.items():
        assert cli(["tokenize-data", "--config", yaml_copy("genie.yaml", work, {}),
                    "--allow-random-params", "--out", str(tokens), "--splits", split,
                    "--limit", str(n)]) == {split: n}
    torch.cuda.synchronize()
    tok_s = time.perf_counter() - t0
    counts, n_clips = _read_counts(), sum(clips.values())
    k2 = dict(lfq_head.launches_by_shape)
    assert_tokenize_launches(counts, k2, n_clips, per_clip)
    shard = TokenClipDataset(str(tokens))[0]
    assert shard["tokens"].shape == (16, 16, 16) and shard["actions"].shape == (16,)
    print(f"[tokenize-data] {smi}: {n_clips} clips in {tok_s:.2f} s ({tok_s / n_clips * 1e3:.1f} "
          f"ms a clip with the model's set-up), launches {counts}, K2 by (N, C, d) {k2}, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    tokenize = {"launches": {k: v // n_clips for k, v in counts.items()},
                "ms_per_clip": tok_s / n_clips * 1e3}

    over = {"data": {"root": str(tokens)}, "model": {"optimizer": {"warmup_steps": 2,
                                                                  "decay_steps": 8}}}
    runs = {}
    with torch.device("meta"):
        n_dyn = _attn_count(DynamicsTrainModule(**dynamics_yaml_config()))
    expect = {"flash_attention_fwd": n_dyn, "flash_attention_bwd_dkv": n_dyn,
              "flash_attention_bwd_dq": n_dyn, "lfq_head": 0, "lfq_entropy_fwd": 0,
              "lfq_entropy_bwd": 0, "maskgit_sample": 0}
    torch.cuda.reset_peak_memory_stats()
    with _Tf32Off(), TrainerWatch() as watch:
        for name in ("whole", "resumed"):
            runs[name] = work / f"dynamics_{name}"
            cfg = yaml_copy("dynamics.yaml", work, {**over, **trainer_overrides(
                runs[name], max_steps=8, val_check_interval=4, limit_val_batches=1,
                ckpt_every_n_steps=4)})
            watch.new_run()
            if name == "whole":
                cli(["train", "dynamics", "--config", cfg])
            else:
                cli(["train", "dynamics", "--config", cfg, "--max-steps", "4"])
                watch.new_run()
                cli(["train", "dynamics", "--config", cfg, "--resume"])
        assert_trainer_launches("trainer dynamics", "trainer_dynamics", watch.steps, expect)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    sched = load_config(cfg, "dynamics").model.optimizer.schedule()
    for name, run in runs.items():
        records = read_jsonl(run / "logs")
        _finite_records(f"trainer dynamics {name}", records)
        lrs = [(r["step"], r["lr"]) for r in records if "loss" in r]
        assert [s for s, _ in lrs] == list(range(1, 9)), lrs
        assert all(lr == sched(s - 1) for s, lr in lrs), (lrs, [sched(s) for s in range(8)])
    whole = load_checkpoint(str(runs["whole"] / "ckpt"), 8)[0]
    resumed = load_checkpoint(str(runs["resumed"] / "ckpt"), 8)[0]
    diff = max((whole["params"][k].float() - resumed["params"][k].float()).abs().max().item()
               for k in whole["params"])
    scale = max(p.float().abs().max().item() for p in whole["params"].values())
    ema_none = whole["train_state"]["optimizer"]["ema"] is None
    steady = watch.steady_ms()
    ms = statistics.median(steady)
    saves = [(s["step"], round(s["seconds"], 3), round(s["bytes"] / 2 ** 20, 1))
             for s in watch.saves]
    print(f"[trainer dynamics] {smi}: lr of steps 1-8 {[f'{sched(s):.3g}' for s in range(8)]} "
          f"as logged; launches per step {watch.steps[-1]['launches']}; resumed at step 4 "
          f"against uninterrupted, step 8: largest |parameter difference| {diff:.3g} (largest "
          f"|parameter| {scale:.3g}); EMA {'off' if ema_none else 'on'}")
    print(f"[trainer dynamics] {smi}: {ms:.1f} ms per step through the CLI (median of "
          f"{len(steady)} steps, min {min(steady):.1f}, max {max(steady):.1f}); saves (step, s, "
          f"MiB) {saves}; peak memory {peak:.2f} GiB")
    assert diff <= 1e-6 * scale, f"the resumed run ends {diff} off the uninterrupted one"
    return {"ms": ms, "peak_gib": peak, "saves": watch.saves, "resume_max_diff": diff,
            "launches": watch.steps[-1]["launches"], "shapes": watch.steps[-1]["shapes"],
            "tokenize_data": tokenize}


# Phase 22's copy of configs/r05b_tokenizer.yaml (phase 24 evaluates its
# checkpoint): synthetic 4 x 8 x 64x64 clips, the bit-balance anneal from
# step 2 over 4 steps, warm-up 2 and cosine to 8.
R05B_OVERRIDES = {
    "data": {"source": "synthetic", "root": "", "num_frames": 8, "batch_size": 4,
             "height": 64, "width": 64},
    "model": {"lfq_bit_balance_anneal_start": 2, "lfq_bit_balance_anneal_steps": 4,
              "optimizer": {"warmup_steps": 2, "decay_steps": 8}}}


# Phase 32's copy of configs/r05_tokenizer.yaml (r05b's without the
# bit-balance anneal): phase 22's clips, warm-up and decay.
R05_OVERRIDES = {"data": R05B_OVERRIDES["data"],
                 "model": {"optimizer": R05B_OVERRIDES["model"]["optimizer"]}}


def phase_trainer_r05b(dev, smi: str, work: Path, name: str = "r05b_tokenizer.yaml",
                       overrides: dict = R05B_OVERRIDES, label: str = "r05b") -> dict:
    """`cli train tokenizer --config configs/r05b_tokenizer.yaml` at full
    width (MAGVIT2 d = 18, the streaming decoder, EMA 0.999, cosine with
    `end_lr_scale` over warm-up 2 and decay 8, the bit-balance anneal from
    step 2 over 4 steps to its floor 0.05) on synthetic 4 x 8 x 64x64
    clips: 4 steps, then `--resume` to 8. The `bit_balance_scale` each
    step's loss received, the logged lr against the schedule, the EMA of
    the checkpoint against the recursion over the steps' parameters (a few
    tensors, recorded after each update; it must move far beyond its f32
    bound for that to catch a fault), no launch of K5/K6 (the entropy
    weight is 0) nor of K1, K3, K4 (no attention, no discriminator); the
    checkpoint's size and write time. Phase 32 runs `configs/r05_tokenizer.yaml`
    the same way (`name`, `overrides`, `label`): r05b's model and objective
    without the anneal, so every step's `bit_balance_scale` is 1."""
    from open_genie_tpu_torch.cli import main as cli
    from open_genie_tpu_torch.train.config import load_config
    from open_genie_tpu_torch.train.loop import AdamW, load_checkpoint
    from open_genie_tpu_torch.train.losses import TokenizerTrainModule

    run = work / label
    cfg = yaml_copy(name, work, {**overrides, **trainer_overrides(
        run, max_steps=8, ckpt_every_n_steps=4)})
    mcfg = load_config(cfg, "tokenizer").model
    decay = mcfg.optimizer.ema_decay
    scales, trace = [], []
    forward, opt_step = TokenizerTrainModule.forward, AdamW.step

    @functools.wraps(forward)  # its signature: the step passes it the generator
    def watched_forward(module, video, *args, **kwargs):
        if kwargs.get("train", True):
            scales.append(kwargs.get("bit_balance_scale", 1.0))
        return forward(module, video, *args, **kwargs)

    def watched_step(opt, *args, **kwargs):
        # A few parameters (their first 4096 values) and their EMA after
        # each update; the update's parameters before it.
        names = [n for n, p in opt.named if p.dim() > 1][:2] + [opt.named[-1][0]]
        pick = lambda t: t.detach().flatten()[:4096].double().cpu()  # noqa: E731
        params = dict(opt.named)
        before = {n: pick(params[n]) for n in names}
        ema_before = {n: pick(opt.ema[n]) for n in names}
        norm = opt_step(opt, *args, **kwargs)
        trace.append({"before": before, "ema_before": ema_before,
                      "after": {n: pick(params[n]) for n in names},
                      "ema": {n: pick(opt.ema[n]) for n in names}})
        return norm

    TokenizerTrainModule.forward, AdamW.step = watched_forward, watched_step
    torch.cuda.reset_peak_memory_stats()
    try:
        with TrainerWatch() as watch:
            watch.new_run()
            cli(["train", "tokenizer", "--config", cfg, "--max-steps", "4"])
            watch.new_run()
            state = cli(["train", "tokenizer", "--config", cfg, "--resume"])
            assert_trainer_launches(f"trainer {label}", "r05b_train", watch.steps, {
                "flash_attention_fwd": 0, "flash_attention_bwd_dkv": 0,
                "flash_attention_bwd_dq": 0, "lfq_head": 0, "lfq_entropy_fwd": 0,
                "lfq_entropy_bwd": 0, "maskgit_sample": 0})
    finally:
        TokenizerTrainModule.forward, AdamW.step = forward, opt_step
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    records = read_jsonl(run / "logs")
    _finite_records(f"trainer {label}", records)
    floor = mcfg.lfq_bit_balance_anneal_floor
    if mcfg.lfq_bit_balance_anneal_start is None:
        want = [1.0] * 8
    else:
        want = anneal_scales(8, mcfg.lfq_bit_balance_anneal_start,
                             mcfg.lfq_bit_balance_anneal_steps, floor)
        assert floor == 0.05 and want[-1] == floor and want[-2] == floor
    assert scales == want, f"bit_balance_scale {scales}, the anneal gives {want}"
    sched = mcfg.optimizer.schedule()
    lrs = [(r["step"], r["lr"]) for r in records if "loss" in r]
    assert [s for s, _ in lrs] == list(range(1, 9)), lrs
    assert all(lr == sched(s - 1) for s, lr in lrs), (lrs, [sched(s) for s in range(8)])
    err, ema, bound, moved = ema_recursion_error(trace, decay)
    ckpt, at = load_checkpoint(str(run / "ckpt"))
    saved = ckpt["train_state"]["optimizer"]["ema"]
    ck_err = max(((saved[n].flatten()[:4096].double() - ema[n]).abs() / bound[n]).max().item()
                 for n in ema)
    size = dir_bytes(run / "ckpt" / str(at))
    n_params = sum(v.numel() for v in ckpt["params"].values())
    saves = [(s["step"], round(s["seconds"], 3), round(s["bytes"] / 2 ** 30, 3))
             for s in watch.saves]
    steady = watch.steady_ms()
    ms = statistics.median(steady)
    print(f"[trainer {label}] bit_balance_scale of steps 0-7 {scales}; the EMA (decay {decay}) "
          f"after each of {len(trace)} updates against its float64 recursion: largest "
          f"|difference| {err:.3g} of its f32 bound, the checkpoint's (step {at}) "
          f"{ck_err:.3g}; the EMA moved a median {moved:.3g} bounds from the first update's "
          f"parameters; no K1-K6 launch")
    print(f"[trainer {label}] {smi}: {ms:.1f} ms per step through the CLI (median of "
          f"{len(steady)} steps, min {min(steady):.1f}, max {max(steady):.1f}); checkpoint "
          f"{size / 2 ** 30:.3f} GiB for {n_params / 1e6:.1f}M parameters (saves (step, s, GiB) "
          f"{saves}); peak memory {peak:.2f} GiB")
    assert state.step == 8 and at == 8 and len(trace) == 8
    assert err <= 1 and ck_err <= 1, f"EMA off its recursion by {err}, {ck_err} bounds"
    assert moved > 10, f"the EMA moved {moved} bounds: too little for the check to catch a fault"
    return {"ms": ms, "peak_gib": peak, "saves": watch.saves, "ema_err": err,
            "ema_moved": moved,
            "checkpoint_gib": size / 2 ** 30, "launches": watch.steps[-1]["launches"]}


# Phase 31's copy of configs/r05b_genie.yaml: phase 22's checkpoint as its
# frozen tokenizer (`tokenizer_ckpt`), synthetic clips of the YAML's 2 x 16
# x 64x64, its bf16 and learning-rate schedule. The uninterrupted run takes
# R05B_GENIE_STEPS steps and saves at R05B_GENIE_SAVE_AT; a second run
# resumes that checkpoint for the steps after it.
R05B_GENIE_STEPS, R05B_GENIE_SAVE_AT = 4, 3


def phase_trainer_r05b_genie(dev, smi: str, work: Path) -> dict:
    """Phase 31: `cli train genie` on a copy of configs/r05b_genie.yaml, the
    flagship joint step: a 2^18-token dynamics (6 x 512) over the frozen
    MAGVIT2 d=18 tokenizer of phase 22's checkpoint (its EMA), the latent
    action at 64x64, bf16 on f32 weights, cuDNN deterministic and TF32 off.
    R05B_GENIE_STEPS steps with a save at R05B_GENIE_SAVE_AT, then that
    checkpoint resumed by a second run: its steps' losses and grad norms
    equal to the uninterrupted run's. Every step launches K1, K3 and K4
    (bf16, on the tensor cores, K1 at `PATH_CASES["r05b_genie_train"]`) and
    K2 once (the frozen tokenize, at a shape phase 4 checks), no K5/K6;
    finite logged terms; the checkpoint's tokenizer is phase 22's EMA. ms
    per step, peak memory, the save's seconds and bytes."""
    from open_genie_tpu_torch.cli import main as cli
    from open_genie_tpu_torch.train.loop import all_steps, load_checkpoint
    from open_genie_tpu_torch.train.trainer import checkpoint_ema

    run, resumed = work / "r05b_genie", work / "r05b_genie_resumed"
    tok_ckpt = work / "r05b" / "ckpt"
    over = {"data": {"source": "synthetic", "root": ""},
            "model": {"tokenizer_ckpt": str(tok_ckpt)}}
    common = dict(max_steps=R05B_GENIE_STEPS, ckpt_every_n_steps=R05B_GENIE_SAVE_AT,
                  save_last=False)
    cfg = yaml_copy("r05b_genie.yaml", work, {**over, **trainer_overrides(run, **common)})
    cfg_resumed = yaml_copy("r05b_genie.yaml", work, {**over, **trainer_overrides(
        resumed, **common)})
    torch.cuda.reset_peak_memory_stats()
    with _Tf32Off(), TrainerWatch() as watch:
        watch.new_run()
        cli(["train", "genie", "--config", cfg])
        _assert_path_kernels("trainer r05b genie", "r05b_genie_train")
        k2 = _assert_k2_checked("trainer r05b genie")
        first = len(watch.steps)
        (resumed / "ckpt").mkdir(parents=True)
        shutil.copytree(run / "ckpt" / str(R05B_GENIE_SAVE_AT),
                        resumed / "ckpt" / str(R05B_GENIE_SAVE_AT))
        shutil.copy(run / "ckpt" / "config.yaml", resumed / "ckpt" / "config.yaml")
        watch.new_run()
        state = cli(["train", "genie", "--config", cfg_resumed, "--resume"])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    per_step = watch.steps[1]["launches"]
    assert all(s["launches"] == per_step for s in watch.steps), [
        s["launches"] for s in watch.steps]
    assert all(per_step[k] > 0 for k in _FLASH) and per_step["lfq_head"] == 1 and (
        per_step["lfq_entropy_fwd"] == per_step["lfq_entropy_bwd"] == 0
        == per_step["maskgit_sample"]), per_step
    assert state.step == R05B_GENIE_STEPS and first == R05B_GENIE_STEPS
    assert all_steps(str(run / "ckpt")) == [R05B_GENIE_SAVE_AT]
    records, again = read_jsonl(run / "logs"), read_jsonl(resumed / "logs")
    _finite_records("trainer r05b genie", records + again)
    steps = {r["step"]: r for r in records if "loss" in r}
    later = {r["step"]: r for r in again if "loss" in r}
    assert sorted(steps) == list(range(1, R05B_GENIE_STEPS + 1)), sorted(steps)
    assert sorted(later) == list(range(R05B_GENIE_SAVE_AT + 1, R05B_GENIE_STEPS + 1))
    diffs = {s: (later[s]["loss"] - steps[s]["loss"], later[s]["grad_norm"]
                 - steps[s]["grad_norm"]) for s in later}
    ckpt, _ = load_checkpoint(str(run / "ckpt"), params_only=True)
    src, src_step = load_checkpoint(str(tok_ckpt))
    ema = checkpoint_ema(src)
    assert ema is not None
    tok = {k: v for k, v in ckpt["params"].items() if k.startswith("model.tokenizer.")}
    same = all(torch.equal(v, ema["model." + k[len("model.tokenizer."):]]) for k, v in tok.items())
    steady = watch.steady_ms()
    ms = statistics.median(steady)
    save = watch.saves[0]
    print(f"[trainer r05b genie] {smi}: cli train genie on r05b_genie.yaml (2 x 16 x 64x64, "
          f"bf16, 2^18 tokens over phase 22's MAGVIT2 step {src_step} EMA): losses "
          f"{[round(steps[s]['loss'], 5) for s in sorted(steps)]}, lr "
          f"{[steps[s]['lr'] for s in sorted(steps)]}; launches per step {per_step}, K2 at "
          f"{k2}; {ms:.1f} ms per step through the CLI (median of {len(steady)} steps, min "
          f"{min(steady):.1f}, max {max(steady):.1f}); peak memory {peak:.2f} GiB; save at step "
          f"{save['step']} {save['seconds']:.2f} s, {save['bytes'] / 2 ** 30:.3f} GiB; the "
          f"checkpoint's {len(tok)} tokenizer tensors equal to phase 22's EMA: {same}")
    print(f"[trainer r05b genie] resumed at step {R05B_GENIE_SAVE_AT}: (loss, grad norm) "
          f"minus the uninterrupted run's at steps {sorted(diffs)}: {list(diffs.values())}")
    assert same, "the frozen tokenizer is not phase 22's EMA"
    assert all(d == (0.0, 0.0) for d in diffs.values()), f"the resumed run parts: {diffs}"
    return {"ms": ms, "peak_gib": peak, "save_s": save["seconds"],
            "checkpoint_gib": save["bytes"] / 2 ** 30, "launches": per_step,
            "shapes": watch.steps[-1]["shapes"], "losses": [steps[s]["loss"] for s in sorted(steps)]}


def reference_keys(tok) -> tuple:
    """How a reference (open-genie) `VideoTokenizer` of the port's `tok`'s
    blueprints lays out its `state_dict`: `({reference key: port key},
    {reference buffer key: array})`. The reference nests each causal conv's
    `conv3d`, names a downsampler `go_down` and an upsampler `go_up`, holds a
    residual block as the indexed Sequentials `main` (GN, act, conv, [down],
    GN, act, conv) and `res` ([down], 1x1 conv), and keeps its blur kernels
    and the LFQ's bit mask as buffers. `utils/torch_import.py` inverts it
    (`tests/test_torch_ref_import.py` holds both to the JAX package's
    importer)."""
    from open_genie_tpu_torch.modules.norm import AdaptiveGroupNorm, GroupNorm
    from open_genie_tpu_torch.modules.video import (
        BlurPooling3d,
        CausalConv3d,
        CausalConvTranspose3d,
        DepthToSpaceTimeUpsample,
        DepthToSpaceUpsample,
        DepthToTimeUpsample,
        SpaceTimeDownsample,
        SpaceTimeUpsample,
        VideoResidualBlock,
    )

    def params(mod, ref: str, port: str) -> dict:
        return {f"{ref}{n}": f"{port}{n}" for n, _ in mod.named_parameters()}

    def conv(mod, ref: str, port: str) -> dict:
        if isinstance(mod, CausalConv3d):
            return params(mod.conv3d, f"{ref}conv3d.", f"{port}conv3d.")
        return params(mod, ref, port)

    def residual(blk, port: str) -> tuple:
        keys, buffers, j = {}, {}, 0
        down = blk.down_main is not None
        for part in ("norm1", "act", "conv1", "down", "norm2", "act", "conv2"):
            if part == "down" and not down:
                continue
            if part.startswith("norm"):
                keys.update(params(getattr(blk, part), f"main.{j}.", f"{port}{part}."))
            elif part.startswith("conv"):
                keys.update(conv(getattr(blk, part), f"main.{j}.", f"{port}{part}."))
            elif isinstance(blk.down_main, BlurPooling3d):
                buffers[f"main.{j}.blur"] = np.ones((3, 3, 3), np.float32)
            elif part == "down":
                keys.update(conv(blk.down_main.down, f"main.{j}.go_down.",
                                 f"{port}down_main.down."))
            j += 1
        if down and isinstance(blk.down_res, BlurPooling3d):
            buffers["res.0.blur"] = np.ones((3, 3, 3), np.float32)
        elif down:
            keys.update(conv(blk.down_res.down, "res.0.go_down.", f"{port}down_res.down."))
        keys.update(conv(blk.res_proj, f"res.{int(down)}.", f"{port}res_proj."))
        return keys, buffers

    keys, buffers = {}, {"quant.bit_mask": 2 ** np.arange(8)[::-1]}
    for stack in ("enc_layers", "dec_layers"):
        for i, layer in enumerate(getattr(tok, stack)):
            ref, port = f"{stack}.{i}.", f"{stack}.{i}."
            if isinstance(layer, VideoResidualBlock):
                k, b = residual(layer, port)
                keys.update({ref + rk: pk for rk, pk in k.items()})
                buffers.update({ref + rk: v for rk, v in b.items()})
            elif isinstance(layer, GroupNorm):
                keys.update(params(layer.gn, ref, f"{port}gn."))
            elif isinstance(layer, AdaptiveGroupNorm):
                keys.update(params(layer.std, f"{ref}std.", f"{port}std."))
                keys.update(params(layer.avg, f"{ref}avg.", f"{port}avg."))
                keys.update(params(layer.gn, ref, f"{port}gn."))
            elif isinstance(layer, CausalConv3d):
                keys.update(conv(layer, ref, port))
            elif isinstance(layer, CausalConvTranspose3d):
                keys.update(params(layer.conv_transpose3d, ref, f"{port}conv_transpose3d."))
            elif isinstance(layer, SpaceTimeDownsample):
                keys.update(conv(layer.down, f"{ref}go_down.", f"{port}down."))
            elif isinstance(layer, DepthToSpaceTimeUpsample):
                keys.update(conv(layer.conv, f"{ref}go_up.0.", f"{port}conv."))
            elif isinstance(layer, SpaceTimeUpsample):
                keys.update(params(layer.up, f"{ref}go_up.", f"{port}up."))
            elif isinstance(layer, (DepthToSpaceUpsample, DepthToTimeUpsample)):
                keys.update(params(layer.proj, f"{ref}go_up.0.", f"{port}proj."))
            else:
                assert not list(layer.parameters()), f"{stack}.{i}: {type(layer).__name__}"
    keys.update(params(tok.quant, "quant.", "quant."))
    return keys, buffers


def reference_state_dict(tok, values=None, seed: int = 0) -> dict:
    """A reference `VideoTokenizer` `state_dict` (`{key: array}`) for the
    port's `tok`: each parameter's value from `values` (`{port key:
    tensor}`), else drawn from a numpy `seed`; a depth-to-space (time)
    upsampler's pointwise weight as the reference's Conv2d (Conv1d), the
    reference's buffers, and a loss module's key beside them."""
    keys, buffers = reference_keys(tok)
    shapes = {k: tuple(p.shape) for k, p in tok.named_parameters()}
    owners = dict(tok.named_modules())
    pointwise = {"DepthToSpaceUpsample": (1, 1), "DepthToTimeUpsample": (1,)}
    rng = np.random.default_rng(seed)
    out = {}
    for ref, port in keys.items():
        shape = shapes[port]
        owner = owners.get(port.rsplit(".", 2)[0]) if port.endswith(".proj.weight") else None
        if type(owner).__name__ in pointwise:
            shape = shape[:2] + pointwise[type(owner).__name__]
        if values is None:
            out[ref] = rng.standard_normal(shape).astype(np.float32)
        else:
            out[ref] = values[port].detach().cpu().numpy().reshape(shape)
    out.update(buffers)
    out["gan_crit.disc.proj_in.weight"] = np.zeros((4, 3, 3, 3), np.float32)
    return out


def phase_import_ckpt(dev, smi: str, work: Path) -> dict:
    """Phase 33: `cli import-ckpt` (on the host) of phase 22's r05b
    tokenizer at its last step, written as a reference (open-genie)
    `state_dict` in an `.npz` (`reference_state_dict`): the step-0
    checkpoint's tokenizer equal to phase 22's parameters bit for bit; then
    `cli train tokenizer --resume` takes one step from it on the card (step
    1 written beside the kept step 0, finite terms, no kernel launch: the
    MAGVIT2 step has none). The import's seconds, the step's ms (with its
    run's set-up) and peak memory."""
    from open_genie_tpu_torch.cli import main as cli
    from open_genie_tpu_torch.models.tokenizer import VideoTokenizer
    from open_genie_tpu_torch.train.config import load_config
    from open_genie_tpu_torch.train.loop import all_steps, load_checkpoint

    run = work / "import"
    cfg = yaml_copy("r05b_tokenizer.yaml", work, {**R05B_OVERRIDES, **trainer_overrides(
        run, max_steps=1, ckpt_every_n_steps=1)})
    src, src_step = load_checkpoint(str(work / "r05b" / "ckpt"), params_only=True)
    want = {k[len("model."):]: v for k, v in src["params"].items() if k.startswith("model.")}
    with torch.device("meta"):
        tok = VideoTokenizer(**load_config(cfg, "tokenizer").model.tokenizer_kwargs())
    run.mkdir(parents=True)
    npz = run / "reference.npz"
    np.savez(npz, **reference_state_dict(tok, want))
    t0 = time.perf_counter()
    cli(["import-ckpt", "--ckpt", str(npz), "--config", cfg, "--out", str(run / "ckpt")])
    import_s = time.perf_counter() - t0
    step0, at = load_checkpoint(str(run / "ckpt"), params_only=True)
    bad = [k for k, v in want.items() if not torch.equal(step0["params"]["model." + k], v)]
    torch.cuda.reset_peak_memory_stats()
    with TrainerWatch() as watch:
        watch.new_run()
        state = cli(["train", "tokenizer", "--config", cfg, "--resume"])
        assert_trainer_launches("import resume", "r05b_train", watch.steps, {
            name: 0 for name in _read_counts()})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    records = read_jsonl(run / "logs")
    _finite_records("import resume", records)
    ms = watch.steps[0]["ms"]
    print(f"[import ckpt] {smi}: phase 22's r05b tokenizer (step {src_step}, {len(want)} "
          f"tensors, {npz.stat().st_size / 2 ** 30:.3f} GiB of .npz) imported in {import_s:.1f} s "
          f"to step {at}; tensors not bit-equal to phase 22's: {len(bad)}; resumed on the card "
          f"to step {state.step} ({ms:.1f} ms with the run's set-up, loss "
          f"{records[-1].get('loss')}); steps kept {all_steps(str(run / 'ckpt'))}; peak "
          f"memory {peak:.2f} GiB")
    assert at == 0 and not bad, f"imported tensors differ from phase 22's: {bad[:5]}"
    assert state.step == 1 and all_steps(str(run / "ckpt")) == [0, 1]
    return {"import_s": import_s, "ms": ms, "peak_gib": peak, "launches": watch.steps[0]["launches"]}


# Keys of the JAX package's reports (`open_genie_tpu/eval.py`):
# `evaluate_tokenizer` (:378-394), `evaluate_genie` (:237-272),
# `action_controllability` (:197-207) and `evaluate_dynamics` (:313);
# `tests/test_torch_smoke_checks.py` holds them to the JAX functions.
EVAL_TOKENIZER_KEYS = frozenset({
    "psnr", "ssim", "rec_mse", "usage", "distinct_codes", "usage_of_sampled_ceiling",
    "perplexity", "entropy_bits", "factorized_entropy_bits", "factorized_perplexity",
    "num_tokens", "num_batches"})
EVAL_GENIE_KEYS = frozenset({
    "loss", "act_loss", "dyn_loss", "act_rec_loss", "act_q_loss", "dyn_masked_acc",
    "dyn_masked_frac", "act_code_usage", "act_code_perplexity", "act_code_entropy_bits",
    "num_batches"})
CONTROLLABILITY_KEYS = frozenset({
    "action_divergence", "seed_divergence", "action_to_noise_ratio", "controllability_frames",
    "controllability_branches", "controllability_pool"})
EVAL_DYNAMICS_KEYS = frozenset({"loss", "masked_acc", "masked_frac", "num_batches"})
# Phase 23's .gvid file: synthetic clips of tokenize.yaml's 16 x 64x64 frames.
GVID_CLIPS, GVID_SHAPE = 64, (16, 64, 64)
GENERATE_FRAMES, PLAY_FRAMES, PLAY_MAX_FRAMES = 16, 40, 32


def check_report(label: str, report: dict, keys: frozenset) -> None:
    """A CLI's printed report has exactly the JAX package's keys, every
    value finite."""
    assert set(report) == set(keys), (
        f"{label}: keys {sorted(set(report) ^ set(keys))} differ from the JAX package's")
    bad = [k for k, v in report.items() if not math.isfinite(float(v))]
    assert not bad, f"{label}: non-finite {bad}"


def native_epoch_matches(loader, ds) -> int:
    """The native loader's first epoch, batch by batch, against `ds.read`
    of the specs `loader.epoch_specs(1)` documents (its clips and start
    frames in the JAX package's draw order). Returns the batches compared."""
    specs = loader.epoch_specs(1)
    n = 0
    for spec, batch in zip(specs, loader):
        want = ds.read(spec.reshape(-1, 2), torch.empty(batch.shape))
        assert torch.equal(batch, want), f"native batch {n} differs from its documented clips"
        n += 1
    assert n == len(specs) == len(loader)
    return n


def f32_path_check(label: str, shapes: dict, dev) -> float:
    """K1 in f32 (the CUDA-core variant) against its plain twin at every
    `(B*H, N, D, causal)` that an f32 path launched it at, on random
    inputs of that shape (the twin over slices of 8 heads); returns the
    largest |difference| of o and lse."""
    from open_genie_tpu_torch.ops.kernels.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )

    g = torch.Generator(device=dev).manual_seed(SEED + 23)
    err = 0.0
    for bh, n, d, causal in sorted(shapes):
        q, k, v = (torch.randn(bh, n, d, generator=g, device=dev) for _ in range(3))
        o, lse = flash_attention(q, k, v, d ** -0.5, causal)
        o_ref, lse_ref = _by_heads(flash_attention_plain, (q, k, v), d ** -0.5, causal)
        torch.cuda.synchronize()
        e = max((o - o_ref).abs().max().item(), (lse - lse_ref).abs().max().item())
        print(f"[{label}] K1 f32 at {(bh, n, d, causal)} against its twin: |d| {e:.3g}")
        assert e <= K1_TOL_F32, f"{label}: f32 K1 at {(bh, n, d, causal)} disagrees"
        err = max(err, e)
        del q, k, v, o, lse, o_ref, lse_ref
    return err


def _assert_k2_checked(label: str) -> dict:
    """K2 ran, since the last `_reset_counts`, only at shapes that phase 4
    holds to its twin in f32 and bf16 (`LFQ_HEAD_CASES`)."""
    k2 = _read_k2_shapes()
    checked = {(n, c, d) for n, c, d, _ in LFQ_HEAD_CASES}
    assert set(k2) <= checked, f"{label}: K2 at {sorted(set(k2) - checked)}, unchecked"
    return k2


def _f32_launches(label: str) -> dict:
    """Since the last `_reset_counts`: every K1 launch took the CUDA-core
    (f32) variant, none of K3-K6 ran; returns K1's launches by shape."""
    fns = _counters()
    counts = _read_counts()
    k1 = fns["flash_attention_fwd"]
    assert k1.launches_by_variant["simt"] == counts["flash_attention_fwd"], (
        f"{label}: an f32 path's K1 launch took the tensor cores")
    assert all(counts[n] == 0 for n in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq",
                                        "lfq_entropy_fwd", "lfq_entropy_bwd")), counts
    return dict(k1.launches_by_shape)


def phase_gvid(dev, smi: str, work: Path) -> dict:
    """The native `.gvid` loader at tokenize.yaml's shape: GVID_CLIPS
    synthetic clips of 16 x 64x64x3 uint8 written with `write_gvid` (the
    loader builds `libgvid` from `native/gvid_loader.cpp` into `build/` at
    first use); its first epoch against `GVidDataset` reads of the clips
    and starts it documents; batches per second with 2 threads beside
    `BatchLoader` (2 workers) over the same file, both into pinned memory;
    then `cli train tokenizer` on a tokenize.yaml copy reading the file
    (4 steps, `--resume` to 6): the batches each step trained on are an
    uninterrupted run's (through `seek`), and phase 16's launches per step
    (K1 70, K3 38, K4 38) on the tensor cores."""
    from open_genie_tpu_torch.cli import main as cli
    from open_genie_tpu_torch.data import native
    from open_genie_tpu_torch.data.loader import BatchLoader
    from open_genie_tpu_torch.data.video import SyntheticVideo
    from open_genie_tpu_torch.models.configs import tokenize_yaml_config
    from open_genie_tpu_torch.train.config import load_config
    from open_genie_tpu_torch.train.losses import TokenizerTrainModule
    from open_genie_tpu_torch.train.trainer import _compute_dtype

    path = work / "clips.gvid"
    t0 = time.perf_counter()
    t, h, w = GVID_SHAPE
    clips = SyntheticVideo(num_videos=GVID_CLIPS, num_frames=t, height=h, width=w, seed=SEED)
    videos = (np.stack([clips[i] for i in range(GVID_CLIPS)]) * 255).round().astype(np.uint8)
    native.write_gvid(str(path), videos)
    print(f"[gvid] libgvid {'built' if native.BUILD['built'] else 'reused'} at "
          f"{native.BUILD['path'].relative_to(HERE)} in {native.BUILD['seconds']:.2f} s; "
          f"{GVID_CLIPS} clips {videos.shape[1:]} uint8 ({path.stat().st_size / 1e6:.1f} MB) "
          f"made and written in {time.perf_counter() - t0:.2f} s")
    ds = native.GVidDataset(str(path))
    batch = 8
    n = native_epoch_matches(native.NativeBatchLoader(ds, batch, num_threads=2, seed=SEED), ds)
    np.testing.assert_array_equal(ds[5], videos[5].astype(np.float32) * np.float32(1 / 255))

    def rate(loader, epochs: int = 3) -> float:
        t = time.perf_counter()
        served = sum(1 for _ in range(epochs) for _ in loader)
        return served / (time.perf_counter() - t)

    rates, pin = {}, dev.type == "cuda"
    for name in ("native", "BatchLoader", "native", "BatchLoader"):
        loader = (native.NativeBatchLoader(ds, batch, num_threads=2, seed=SEED, pin_memory=pin)
                  if name == "native" else
                  BatchLoader(ds, batch, num_workers=2, seed=SEED, pin_memory=pin))
        rates.setdefault(name, []).append(rate(loader))
    print(f"[gvid] first epoch ({n} batches of {batch}) equal to the documented clips; pinned "
          f"batches per second over 3 epochs, in turns: native loader (2 threads) "
          f"{[round(r, 1) for r in rates['native']]}, BatchLoader (2 workers) "
          f"{[round(r, 1) for r in rates['BatchLoader']]} (host: "
          f"{os.cpu_count()} cores)")

    run = work / "gvid_tokenizer"
    cfg = yaml_copy("tokenize.yaml", work, {"data": {"source": "gvid", "root": str(path)},
                                            **trainer_overrides(run, max_steps=6,
                                                                ckpt_every_n_steps=4)})
    with torch.device("meta"):
        meta = TokenizerTrainModule(**tokenize_yaml_config())
    n_tok, n_disc = _attn_count(meta.model), _attn_count(meta.gan_crit)
    expect = {"flash_attention_fwd": 2 * n_tok + 3 * n_disc,
              "flash_attention_bwd_dkv": n_tok + 3 * n_disc,
              "flash_attention_bwd_dq": n_tok + 3 * n_disc, "lfq_head": 0,
              "lfq_entropy_fwd": 0, "lfq_entropy_bwd": 0, "maskgit_sample": 0}
    seen, forward = [], TokenizerTrainModule.forward

    @functools.wraps(forward)
    def watched(module, video, *args, **kwargs):
        if kwargs.get("train", True):
            seen.append(video[:, :, ::16, ::16].detach().float().cpu())
        return forward(module, video, *args, **kwargs)

    TokenizerTrainModule.forward = watched
    torch.cuda.reset_peak_memory_stats()
    try:
        with TrainerWatch() as watch:
            watch.new_run()
            cli(["train", "tokenizer", "--config", cfg, "--max-steps", "4"])
            watch.new_run()
            state = cli(["train", "tokenizer", "--config", cfg, "--resume"])
            assert_trainer_launches("gvid train", "gvid_train", watch.steps, expect)
    finally:
        TokenizerTrainModule.forward = forward
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    assert state.step == 6 and len(seen) == 6, (state.step, len(seen))
    # The uninterrupted order, and the same through `seek(4)`.
    tcfg = load_config(cfg, "tokenizer")
    dtype = _compute_dtype(tcfg.trainer.precision) or torch.float32  # the step's cast

    def served(seek: int, n: int) -> list:
        loader = native.NativeBatchLoader(ds, tcfg.data.batch_size, seed=tcfg.trainer.seed)
        loader.seek(seek)
        epochs = itertools.chain.from_iterable(loader for _ in range(n))
        return [b[:, :, ::16, ::16].to(dtype).float() for b in itertools.islice(epochs, n)]

    want, tail = served(0, 6), served(4, 2)
    assert all(torch.equal(a, b) for a, b in zip(tail, want[4:]))
    same = [torch.equal(a, b) for a, b in zip(seen, want)]
    records = read_jsonl(run / "logs")
    _finite_records("gvid train", records)
    steady = watch.steady_ms()
    ms = statistics.median(steady)
    print(f"[gvid train] {smi}: steps 1-6 trained on the uninterrupted run's batches {same} "
          f"(steps 5-6 after --resume at 4; seek(4) serves the same); launches per step "
          f"{watch.steps[-1]['launches']}; {ms:.1f} ms per step (median of {len(steady)}, min "
          f"{min(steady):.1f}, max {max(steady):.1f}); peak memory {peak:.2f} GiB")
    assert all(same), "a step trained on another batch than an uninterrupted run's"
    ds.close()
    return {"ms": ms, "peak_gib": peak, "launches": watch.steps[-1]["launches"],
            "batches_per_s": {k: statistics.median(v) for k, v in rates.items()},
            "build_s": native.BUILD["seconds"]}


def _timed_cli(label: str, argv: list) -> tuple:
    """`cli.main(argv)` with the counts at 0: its return value, ms,
    launches and K1's launches by shape."""
    from open_genie_tpu_torch.cli import main as cli

    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    out = cli(argv)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out, ms, _read_counts(), _f32_launches(label)


def phase_eval_tokenizer(dev, smi: str, work: Path) -> dict:
    """`cli eval tokenizer --max-batches 2` on phase 20's checkpoint
    (tokenize.yaml) and `--ema` on phase 22's (r05b): the JAX package's
    JSON keys, finite values; f32, as the JAX package's: K1 on the CUDA
    cores at `PATH_CASES["eval_tokenizer"]` (phase 16's evaluation's), one
    launch per tokenizer attention per batch, held to its twin there; ms
    per batch."""
    from open_genie_tpu_torch.models.configs import tokenize_yaml_config
    from open_genie_tpu_torch.train.losses import TokenizerTrainModule

    with torch.device("meta"):
        n_tok = _attn_count(TokenizerTrainModule(**tokenize_yaml_config()).model)
    out = {}
    runs = (("tokenize.yaml", "tokenize.yaml", {}, work / "tokenizer", []),
            ("r05b --ema", "r05b_tokenizer.yaml", R05B_OVERRIDES, work / "r05b", ["--ema"]))
    for name, yaml_name, over, run, flags in runs:
        cfg = yaml_copy(yaml_name, work, {**over, **trainer_overrides(run)})
        ckpt = str(run / "ckpt")
        report, ms, counts, shapes = _timed_cli(
            f"eval tokenizer {name}", ["eval", "tokenizer", "--config", cfg, "--ckpt", ckpt,
                                       "--max-batches", "2"] + flags)
        check_report(f"eval tokenizer {name}", report, EVAL_TOKENIZER_KEYS)
        batches = int(report["num_batches"])
        per_batch = {k: v / batches for k, v in counts.items()}
        print(f"[eval tokenizer] {smi}: {name}: {ms / batches:.1f} ms per batch ({batches} "
              f"batches, f32, the model's set-up and the checkpoint's load included: {ms:.1f} "
              f"ms); PSNR {report['psnr']:.3f} dB, SSIM {report['ssim']:.4f}, usage "
              f"{report['usage']:.4f}; launches per batch {per_batch}; K1 by shape {shapes}")
        assert batches == 2
        if name == "tokenize.yaml":
            assert set(shapes) == set(PATH_CASES["eval_tokenizer"]), shapes
            assert counts["flash_attention_fwd"] == n_tok * batches and counts["lfq_head"] == 0
            f32_path_check("eval tokenizer", set(shapes), dev)
            out.update(ms_per_batch=ms / batches, launches={k: int(v) for k, v in
                                                             per_batch.items()})
        else:  # MAGVIT2: no attention; its 1x1 head into 18 bits fuses into K2
            k2 = _assert_k2_checked(f"eval tokenizer {name}")
            print(f"[eval tokenizer] {name}: K2 by (N, C, d) {k2}")
            assert counts["flash_attention_fwd"] == 0 and counts["lfq_head"] == batches, counts
            out["r05b_ema_ms_per_batch"] = ms / batches
    return out


def _genie_args(argv: list):
    from open_genie_tpu_torch.cli import build_parser

    return build_parser().parse_args(argv)


def _watch_tokens():
    """Record the token videos `Genie.generate_tokens` returns, and its
    seconds (the prompt's tokenization and the rollout, synced)."""
    from open_genie_tpu_torch.models.genie import Genie

    got, seconds, real = [], [], Genie.generate_tokens

    @functools.wraps(real)
    def watched(self, prompt, *args, **kwargs):
        t0 = time.perf_counter()
        out = real(self, prompt, *args, **kwargs)
        got.append(out.cpu())
        seconds.append(time.perf_counter() - t0)
        return out

    Genie.generate_tokens = watched
    return got, seconds, lambda: setattr(Genie, "generate_tokens", real)


def phase_generate_play(dev, smi: str, work: Path, train_launches: dict) -> dict:
    """`generate` and `play` at genie.yaml's full width, through the
    functions behind the commands (`cli.generate_video`, `cli.play_video`:
    the card has no OpenCV to write the mp4): `cli train genie` takes 3
    steps on a genie.yaml copy with `ema_decay: 0.999` (phase 9's launches
    per step); `generate --ema --top-k 1` with scripted actions in f32
    (TF32 off): the share of its tokens equal to the same call on the CPU,
    printed (one moved commit cascades at full width), K1 and K2 per
    generated frame against the rollout's structure; the compact model's
    `generate` on the card and on the CPU, tokens equal; `--actions-from-data`;
    `play` of PLAY_FRAMES scripted frames at `--max-frames` PLAY_MAX_FRAMES
    (one rebase): launches per reset, step and rebase against the
    session's structure, p50/p95 ms per frame."""
    import yaml

    from open_genie_tpu_torch.cli import generate_video, main as cli, play_video
    from open_genie_tpu_torch.models.configs import genie_compact_config, genie_train_config
    from open_genie_tpu_torch.models.genie import Genie
    from open_genie_tpu_torch.serve import InteractiveSession

    run = work / "genie"
    cfg = yaml_copy("genie.yaml", work, trainer_overrides(run, max_steps=3,
                                                         ckpt_every_n_steps=3))
    # genie.yaml's optimizer is in the class_path/init_args form, which
    # carries no EMA: the copy's is the plain form with the same rates.
    with open(cfg) as f:
        raw = yaml.safe_load(f)
    raw["model"]["optimizer"] = {**raw["model"]["optimizer"]["init_args"], "ema_decay": 0.999}
    with open(cfg, "w") as f:
        yaml.safe_dump(raw, f, sort_keys=False)
    torch.cuda.reset_peak_memory_stats()
    with TrainerWatch() as watch:
        watch.new_run()
        cli(["train", "genie", "--config", cfg])
        assert_trainer_launches("trainer genie", "train_step", watch.steps, train_launches)
    ckpt = str(run / "ckpt")
    with torch.device("meta"):
        genie = Genie(**genie_train_config())
    n_enc, n_dec = _attn_count(genie.tokenizer.enc_layers), _attn_count(genie.tokenizer.dec_layers)
    n_dyn = _attn_count(genie.dynamics) // 2  # a spatial and a temporal one per block;
    # the cached temporal attention is masked and takes the plain path
    spf, frames = 25, GENERATE_FRAMES
    actions = ",".join(str(i % 4) for i in range(frames + 1))
    argv = ["generate", "--config", cfg, "--ckpt", ckpt, "--ema", "--frames", str(frames),
            "--steps-per-frame", str(spf), "--top-k", "1", "--actions", actions]
    out = {}
    tokens, rollout_s, restore = _watch_tokens()
    try:
        with _Tf32Off():
            torch.cuda.synchronize()
            _reset_counts()
            t0 = time.perf_counter()
            video = generate_video(_genie_args(argv))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts, shapes = _read_counts(), _f32_launches("generate")
            k2 = _assert_k2_checked("generate")
            t0 = time.perf_counter()
            video_cpu = generate_video(_genie_args(argv + ["--device", "cpu"]))
            cpu_s = time.perf_counter() - t0
        share = (tokens[0] == tokens[1]).float().mean().item()
        first = next((f for f in range(1, frames + 1)
                      if not torch.equal(tokens[0][:, f], tokens[1][:, f])), None)
        want_k1 = n_enc + n_dyn * (1 + frames * (spf + 1)) + n_dec
        per_frame = rollout_s[0] * 1e3 / frames
        print(f"[generate] {smi}: genie.yaml --ema --top-k 1, {frames} frames at spf {spf}, "
              f"f32: {per_frame:.1f} ms per generated frame in `Genie.generate_tokens` (the "
              f"prompt's tokens and the rollout), {ms:.1f} ms for the whole call (the model's "
              f"set-up, the checkpoint's load and the decode included); video {video.shape}; "
              f"tokens equal to the "
              f"CPU's same call ({cpu_s:.1f} s): {share:.4f} (first frame that differs: "
              f"{first}); pixels max |d| {np.abs(video - video_cpu).max():.3g}; launches "
              f"{counts} (K1 expected {want_k1}: {n_enc} prompt + {n_dyn} x (1 + {frames} x "
              f"{spf + 1}) + {n_dec} decode), K2 by (N, C, d) {k2}")
        assert video.shape == (frames + 1, 64, 64, 3) and np.isfinite(video).all()
        assert counts["flash_attention_fwd"] == want_k1 and k2 == {(256, 64, 10): 1}, counts
        k7 = _assert_k7_checked("generate")
        assert k7 == {(1, 256, 2 ** 10): 2 * frames * spf}, f"K7 launched at {k7}"
        f32_path_check("generate", set(shapes), dev)
        out.update(ms=ms, ms_per_frame=per_frame, equal_to_cpu=share,
                   launches={k: counts[k] for k in counts})

        # The compact model, random weights from the seed: tokens exact.
        tokens.clear()
        compact = work / "compact_genie.yaml"
        with open(compact, "w") as f:
            yaml.safe_dump({"seed_everything": SEED, "model": json.loads(json.dumps(
                genie_compact_config())), "data": {"source": "synthetic", "height": 32,
                                                    "width": 32}}, f)
        # scripted actions: drawn ones would come from each device's generator
        small = ["generate", "--config", str(compact), "--frames", "3", "--steps-per-frame", "8",
                 "--top-k", "1", "--size", "32", "--actions", "1,0,1,1"]
        with _Tf32Off():
            pix_gpu = generate_video(_genie_args(small))
            pix_cpu = generate_video(_genie_args(small + ["--device", "cpu"]))
        same = torch.equal(tokens[0], tokens[1])
        print(f"[generate compact] tokens {tuple(tokens[0].shape)} equal CUDA vs CPU: {same}; "
              f"pixels max |d| {np.abs(pix_gpu - pix_cpu).max():.3g}")
        assert same, "the CLI's compact generate differs between the card and the CPU"
        np.testing.assert_allclose(pix_gpu, pix_cpu, atol=PIX_TOL["atol"], rtol=PIX_TOL["rtol"])
    finally:
        restore()

    _reset_counts()
    t0 = time.perf_counter()
    replay = generate_video(_genie_args(["generate", "--config", cfg, "--ckpt", ckpt, "--ema",
                                         "--frames", "8", "--actions-from-data"]))
    torch.cuda.synchronize()
    print(f"[generate --actions-from-data] {smi}: video {replay.shape} in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms; launches {_read_counts()}")
    assert replay.shape[0] == 9 and np.isfinite(replay).all()  # a validation clip's size

    # play: counts and times per reset and per step, through the session.
    marks, reset, step = [], InteractiveSession.reset, InteractiveSession.step

    def mark(kind, fn):
        @functools.wraps(fn)
        def wrapped(sess, *args, **kwargs):
            torch.cuda.synchronize()
            before, t = _read_counts(), time.perf_counter()
            res = fn(sess, *args, **kwargs)
            torch.cuda.synchronize()
            marks.append((kind, (time.perf_counter() - t) * 1e3, _diff(_read_counts(), before),
                          sess._rebases))
            return res
        return wrapped

    InteractiveSession.reset, InteractiveSession.step = mark("reset", reset), mark("step", step)
    script = ",".join(str(i % 4) for i in range(PLAY_FRAMES))
    try:
        _reset_counts()
        frames_out = play_video(_genie_args(
            ["play", "--config", cfg, "--ckpt", ckpt, "--ema", "--actions", script,
             "--max-frames", str(PLAY_MAX_FRAMES)]))
        shapes = _f32_launches("play")
        _assert_k2_checked("play")
    finally:
        InteractiveSession.reset, InteractiveSession.step = reset, step
    assert frames_out.shape == (1 + PLAY_FRAMES, 64, 64, 3) and np.isfinite(frames_out).all()
    (_, reset_ms, at_reset, _), steps = marks[0], marks[1:]
    k1 = [s[2]["flash_attention_fwd"] for s in steps]
    rebased = [i for i in range(1, len(steps)) if steps[i][3] > steps[i - 1][3]]
    dec_frame = at_reset["flash_attention_fwd"] - n_enc - n_dyn  # one prompt frame
    per_step, keep = n_dyn * (8 + 1) + dec_frame, (1 + PLAY_MAX_FRAMES) // 2
    step_ms = sorted(s[1] for i, s in enumerate(steps) if i not in rebased)
    p50, p95 = step_ms[len(step_ms) // 2], step_ms[min(len(step_ms) - 1,
                                                       int(0.95 * len(step_ms)))]
    print(f"[play] {smi}: {PLAY_FRAMES} frames at --max-frames {PLAY_MAX_FRAMES}, spf 8, f32, "
          f"streaming decode: rebased at step(s) {[i + 1 for i in rebased]}; per frame p50 "
          f"{p50:.1f} ms, p95 {p95:.1f} ms; reset {reset_ms:.1f} ms, the rebasing step "
          f"{[round(steps[i][1], 1) for i in rebased]} ms; K1 per reset "
          f"{at_reset['flash_attention_fwd']}, K2 per reset {at_reset['lfq_head']}, K1 per step "
          f"{sorted(set(k1))} (expected {per_step}; {per_step + keep * (n_dyn + dec_frame)} "
          f"at the rebase)")
    assert len(rebased) == 1 and at_reset["lfq_head"] == 1
    assert all(k1[i] == (per_step + keep * (n_dyn + dec_frame) if i in rebased else per_step)
               for i in range(len(steps))), k1
    assert all(s[2]["lfq_head"] == 0 for s in steps)
    assert at_reset["maskgit_sample"] == 0 and all(s[2]["maskgit_sample"] == 2 * 8
                                                   for s in steps), [s[2] for s in steps]
    print(f"[play] K7 by (B, HW, V) {_assert_k7_checked('play')}")
    f32_path_check("play", set(shapes), dev)
    out["play"] = {"p50_ms": p50, "p95_ms": p95, "reset_ms": reset_ms,
                   "per_reset": at_reset, "per_step": steps[0][2],
                   "at_rebase": steps[rebased[0]][2]}
    return out, cfg


def phase_eval_genie_dynamics(dev, smi: str, work: Path, genie_cfg: str) -> dict:
    """`cli eval genie --controllability-frames 4 --max-batches 2` on phase
    25's checkpoint and `cli eval dynamics` on phase 21's shards and
    checkpoint: the JAX package's JSON keys (with the controllability
    ones), finite values, K1 in f32 held to its twin at every shape it ran;
    ms per batch."""
    out = {}
    ckpt = str(work / "genie" / "ckpt")
    report, ms, counts, shapes = _timed_cli("eval genie", [
        "eval", "genie", "--config", genie_cfg, "--ckpt", ckpt, "--max-batches", "2",
        "--controllability-frames", "4"])
    check_report("eval genie", report, EVAL_GENIE_KEYS | CONTROLLABILITY_KEYS)
    batches = int(report["num_batches"])
    print(f"[eval genie] {smi}: {ms:.1f} ms for {batches} batches and the controllability "
          f"rollouts (4 frames, 4 action and 4 noise branches; set-up included); loss {report['loss']:.4f}, "
          f"action-to-noise ratio {report['action_to_noise_ratio']:.3f} over a pool of "
          f"{report['controllability_pool']:.0f}; launches {counts}; K1 by shape {shapes}")
    assert batches == 2 and counts["lfq_head"] > 0 and counts["maskgit_sample"] > 0
    print(f"[eval genie] K2 by (N, C, d) {_assert_k2_checked('eval genie')}; K7 by (B, HW, V) "
          f"{dict(_counters()['maskgit_sample'].launches_by_shape)}")
    f32_path_check("eval genie", set(shapes), dev)
    out["eval_genie"] = {"ms": ms, "launches": counts}

    tokens = work / "tokens"
    cfg = yaml_copy("dynamics.yaml", work, {"data": {"root": str(tokens)},
                                            **trainer_overrides(work / "dynamics_whole")})
    report, ms, counts, shapes = _timed_cli("eval dynamics", [
        "eval", "dynamics", "--config", cfg, "--ckpt", str(work / "dynamics_whole" / "ckpt"),
        "--max-batches", "2"])
    check_report("eval dynamics", report, EVAL_DYNAMICS_KEYS)
    batches = int(report["num_batches"])
    print(f"[eval dynamics] {smi}: {ms / batches:.1f} ms per batch ({batches} batch(es) of "
          f"phase 21's validation shards, f32, set-up included); loss {report['loss']:.4f}, masked acc "
          f"{report['masked_acc']:.4f}; launches {counts}; K1 by shape {shapes}")
    assert counts["lfq_head"] == counts["maskgit_sample"] == 0 and counts["flash_attention_fwd"] > 0
    f32_path_check("eval dynamics", set(shapes), dev)
    out["eval_dynamics_cli"] = {"ms": ms, "launches": counts}
    return out


# --------------------------------------------------------------------- #
# Phases 27 and 28: the module library at MAGVIT2 d=18 width
# --------------------------------------------------------------------- #

def phase_video_disc(dev, smi: str, tok_train_ms: float) -> dict:
    """Phase 27: the compact twin (`tokenizer_compact_train_config()` with
    `COMPACT_VIDEO_DISC_KWARGS`) on the card against the CPU in f32, then
    the full-loss MAGVIT2 d=18 step with `VIDEO_DISC_KWARGS` judging whole
    clips, as phase 12 runs the frame discriminator's; then the blur's
    grouped conv3d alone (`_blur_report`)."""
    from open_genie_tpu_torch.models.configs import (
        tokenizer_compact_train_config,
        tokenizer_train_config,
    )

    phase_compact_tokenizer_train(
        dev, video_disc_train_config(tokenizer_compact_train_config(),
                                     COMPACT_VIDEO_DISC_KWARGS), "compact video disc")
    counts, shapes, times = phase_tokenizer_train_full_width(
        dev, video_disc_train_config(tokenizer_train_config(), VIDEO_DISC_KWARGS),
        "video disc train", "video_disc_train")
    print(f"[video disc train] {smi}: {times['ms']:.1f} ms per step "
          f"with the video discriminator against {tok_train_ms:.1f} ms with the frame "
          f"discriminator (phase 12, this run); peak memory {times['peak_gib']:.2f} GiB")
    return {"launches": counts, "shapes": shapes, **times, "frame_disc_ms": tok_train_ms,
            "blur": _blur_report(dev, smi)}


def _blur_report(dev, smi: str) -> dict:
    """The blur of `VIDEO_DISC_KWARGS`' second block (`blur_pool_3d`, a
    grouped conv3d with one group per channel, stride 2) at its two bf16
    inputs of a step, the main branch's 256 channels and the residual's
    128: ms forward and forward + backward (CUDA events), and the kernels
    one forward call launches. Three discriminator passes a step call
    each once."""
    from torch.profiler import ProfilerActivity, profile

    from open_genie_tpu_torch.ops.resample import blur_pool_3d

    b, t = VIDEO_DISC_BATCH
    out = {}
    for c in (256, 128):
        x = torch.randn(b, t, 64, 64, c, device=dev, dtype=torch.bfloat16, requires_grad=True)
        fwd = cuda_ms(lambda: blur_pool_3d(x, 3, 2, 2), iters=10)
        both = cuda_ms(lambda: blur_pool_3d(x, 3, 2, 2).sum().backward(), iters=10)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            blur_pool_3d(x, 3, 2, 2)
            torch.cuda.synchronize()
        kernels = sum(e.count for e in prof.key_averages() if e.device_type.name == "CUDA")
        out[c] = {"fwd_ms": fwd, "fwd_bwd_ms": both, "kernels_per_fwd": kernels}
        print(f"[video disc blur] {smi}: blur_pool_3d (grouped conv3d, {c} groups) on "
              f"{tuple(x.shape)} bf16: {fwd:.3f} ms forward, {both:.3f} ms forward + backward, "
              f"{kernels} kernels a forward call")
        del x
    total = 3 * sum(v["fwd_bwd_ms"] for v in out.values())
    print(f"[video disc blur] {smi}: 3 passes x (256 + 128 channels) forward + backward: "
          f"about {total:.1f} ms of a step")
    return {"by_channels": out, "per_step_ms": total}


def _compact_alt_twins(dev) -> None:
    """Phase 28's compact twins (`alt_tokenizers(16)`): the card's f32
    tokens (K1, K2) equal the CPU's wherever every bit is decided, and both
    decoders' pixels within PIX_TOL of the CPU's."""
    from open_genie_tpu_torch.models.tokenizer import VideoTokenizer
    from open_genie_tpu_torch.utils import init_weights

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(SEED + 27)
    alt = alt_tokenizers(16)
    cpu = {kind: init_weights(VideoTokenizer(**kw), g).eval() for kind, kw in alt.items()}
    gpu = {kind: copy.deepcopy(m).to(dev) for kind, m in cpu.items()}
    video = torch.rand(*ALT_BATCH, 64, 64, 3, generator=g)
    _reset_counts()
    _, tok_gpu = gpu["stream"].tokenize(video.to(dev))
    launched = _read_counts()
    _, tok_cpu = cpu["stream"].tokenize(video)
    with torch.no_grad():
        decided = (cpu["stream"].encode(video).abs() >= LFQ_UNDECIDED).all(-1)
    tok_gpu = tok_gpu.cpu()
    same = torch.equal(tok_gpu[decided], tok_cpu[decided])
    errs = {}
    for kind in alt:
        pix_gpu = gpu[kind].decode_tokens(tok_cpu.to(dev)).cpu()
        pix_cpu = cpu[kind].decode_tokens(tok_cpu)
        errs[kind] = (pix_gpu - pix_cpu).abs().max().item()
        torch.testing.assert_close(pix_gpu, pix_cpu, **PIX_TOL)
    print(f"[compact alt] tokens {tuple(tok_cpu.shape)} equal CUDA vs CPU at the "
          f"{int(decided.sum())}/{decided.numel()} decided positions: {same}; pixels max |d| "
          f"stream {errs['stream']:.3g}, tconv {errs['tconv']:.3g}; launches K1 "
          f"{launched['flash_attention_fwd']}, K2 {launched['lfq_head']}")
    assert same, "CUDA tokens differ from the CPU's"
    assert launched["flash_attention_fwd"] == 2 and launched["lfq_head"] == 1


def phase_alt_resamplers(dev, smi: str) -> dict:
    """Phase 28: `ALT_ENC` with `ALT_STREAM_DEC` and `ALT_TCONV_DEC` at
    MAGVIT2 d=18 width on `ALT_BATCH` clips of 64x64 in bf16: tokenize
    (K1 twice, K2 once), each decoder, the stream of the 4 token frames
    (each streamed layer within `bf16_excess` of the batch decode's own
    input, in f32 within STREAM_EXACT; the f32 stream against the f32
    batch decode within PIX_TOL, its error printed), then r05's objective (rec, commit, bit balance; no GAN,
    no VGG) through `make_train_step`."""
    from open_genie_tpu_torch.models.configs import _repo_config
    from open_genie_tpu_torch.models.tokenizer import VideoTokenizer
    from open_genie_tpu_torch.train.losses import TokenizerTrainModule
    from open_genie_tpu_torch.train.loop import make_optimizer, make_train_step
    from open_genie_tpu_torch.utils import init_weights

    _compact_alt_twins(dev)
    torch.backends.cudnn.deterministic = True
    g = torch.Generator().manual_seed(SEED + 28)
    alt = alt_tokenizers(1)
    toks = {kind: init_weights(VideoTokenizer(**kw), g).to(dev, torch.bfloat16).eval()
            for kind, kw in alt.items()}
    video = torch.rand(*ALT_BATCH, 64, 64, 3, generator=g).to(dev, torch.bfloat16)
    none = dict.fromkeys(_counters(), 0)
    out = {"launches": {}, "shapes": {}}

    toks["stream"].tokenize(video)  # warm-up: cuDNN picks its algorithms
    (_, idxs), run = _inference("alt tokenize", "alt_tokenize", lambda: toks["stream"].tokenize(
        video), {**none, "flash_attention_fwd": 2, "lfq_head": 1}, smi)
    k2 = _read_k2_shapes()
    assert k2 == {(512, 512, 18): 1}, f"K2 launched at {k2}"
    assert tuple(idxs.shape) == (ALT_BATCH[0], ALT_BATCH[1] // 4, 8, 8) and int(idxs.max()) < 2 ** 18
    out["launches"]["alt_tokenize"], out["shapes"]["alt_tokenize"] = run["launches"], run["shapes"]
    out["tokenize_ms"] = run["ms"]
    for kind, tok in toks.items():
        tok.decode_tokens(idxs)
        rec, run = _inference(f"alt decode {kind}", "alt_decode",
                              lambda tok=tok: tok.decode_tokens(idxs), none, smi)
        assert tuple(rec.shape) == tuple(video.shape) and torch.isfinite(rec.float()).all()
        out[f"decode_{kind}_ms"] = run["ms"]
    out["launches"]["alt_decode"] = run["launches"]

    stream = toks["stream"]
    assert stream.stream_decodable()
    b, t = idxs.shape[:2]
    cache = stream.init_stream_cache(b, 8, 8, t)
    _reset_counts()
    frames, ms = [], []
    for p in range(t):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames.append(stream.decode_stream(idxs[:, p], cache, p)[0])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    assert _read_counts() == none
    out["launches"]["alt_stream"] = _read_counts()
    streamed = torch.cat(frames, 1)
    batch = stream.decode_tokens(idxs)
    worst = _stream_layers_forced(stream, idxs, bf16_excess)
    tok32 = copy.deepcopy(stream).float()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cache32 = tok32.init_stream_cache(b, 8, 8, t)
    stream32 = torch.cat([tok32.decode_stream(idxs[:, p], cache32, p)[0] for p in range(t)], 1)
    batch32 = tok32.decode_tokens(idxs)
    err32 = (stream32 - batch32).abs().max().item()
    # Each f32 layer streamed on the batch decode's input to it within the
    # JAX package's stream pin; end to end, 33 layers of cuDNN's per-shape
    # algorithms (a token frame's chunk against the clip) within the stack
    # bound, as phase 15's decoder.
    f32 = _stream_layers_forced(tok32, idxs, lambda a, r: (
        (a - r).abs() / (STREAM_EXACT["atol"] + STREAM_EXACT["rtol"] * r.abs())).max().item())
    out["stream_ms"] = statistics.median(ms[1:])
    print(f"[alt stream] {smi}: {t} token frames of {tuple(frames[0].shape)} pixels each, "
          f"{out['stream_ms']:.1f} ms per token frame (median of frames 1-{t - 1}; frame 0 "
          f"{ms[0]:.1f} ms); the streamed frames against the batch decode "
          f"{bf16_excess(streamed, batch):.3g} of the bf16 limit (printed); each of the "
          f"{len(worst)} layers streamed on the batch decode's input to it at most "
          f"{max(worst):.3g} (layer {worst.index(max(worst))}), in f32 at most {max(f32):.3g} "
          f"of atol 2e-5 + rtol 1e-5 (layer {f32.index(max(f32))}); f32 stream against f32 "
          f"batch decode max |d| {err32:.3g} (rms {batch32.pow(2).mean().sqrt().item():.3g})")
    assert tuple(streamed.shape) == tuple(video.shape) and max(worst) <= 1 and max(f32) <= 1
    torch.testing.assert_close(stream32, batch32, **PIX_TOL)
    out["stream_f32_max_err"] = err32
    del tok32, cache32, stream32, batch32, toks

    cfg = _repo_config("r05_tokenizer.yaml", "tokenizer").model.module_kwargs()
    cfg["tokenizer"] = dict(cfg["tokenizer"], **alt["stream"])
    module = init_weights(TokenizerTrainModule(**cfg), g).to(dev)
    assert module.gan_crit is None and module.perc_crit is None
    opt = make_optimizer(module, lr=5e-4)  # r05's peak lr
    step = make_train_step(module, opt, compute_dtype=torch.bfloat16)
    train = _train_steps("alt train", "alt_train", step, video.float(),
                         {**none, "flash_attention_fwd": 4, "flash_attention_bwd_dkv": 2,
                          "flash_attention_bwd_dq": 2},
                         module, [n for n, _ in module.named_parameters()], 3, smi,
                         generator=torch.Generator(device=dev).manual_seed(SEED + 29))
    out["launches"]["alt_train"], out["shapes"]["alt_train"] = train["launches"], train["shapes"]
    out["train_ms"], out["train_peak_gib"] = train["ms"], train["peak_gib"]
    print(f"[alt] {smi}: tokenize {out['tokenize_ms']:.1f} ms, decode stream "
          f"{out['decode_stream_ms']:.1f} ms, decode tconv {out['decode_tconv_ms']:.1f} ms, "
          f"{out['stream_ms']:.1f} ms per streamed token frame, {out['train_ms']:.1f} ms per "
          f"training step, batch {ALT_BATCH[0]} x {ALT_BATCH[1]} x 64x64")
    return out


# --------------------------------------------------------------------- #
# Phase 29: data-parallel training (`open_genie_tpu_torch/parallel/`)
# --------------------------------------------------------------------- #

DP_STEPS, DP_RESUME_AT, DP_TIMED_STEPS = 6, 3, 4
# 29a's clips x frames of 64x64: phase 12's MAGVIT2 batch, phase 9's Genie.
DP_TOK_BATCH, DP_GENIE_BATCH = (4, 8, 64, 64, 3), (4, 16, 64, 64, 3)
# 29b's copy of tokenize.yaml: at its 1e-3, and at 1e-4, the run diverges
# within a few steps (loss 19.6 to 162 in 5 steps at 1e-4; the JAX
# package's diverges alike, tests/test_torch_yaml_divergence.py), and two
# diverging runs part by more than PIX_TOL whatever the order of their sums.
# The later steps are held to PIX_TOL; the first step, which no lr reaches,
# is held tightly (DP_FIRST_STEP_TOL).
DP_LR = 1e-5
# 29b's first step on two ranks against one process on the global batch,
# in f32 with TF32 off: the loss within `loss` relative; the gradients the
# step applies (summed over the ranks, before the clip) within `together`
# of their norm, all tensors as one vector, and each tensor within
# `tensor` of its own norm. The gaps are f32 rounding: an order of sums
# that the ranks' halves change (on an H100, 1.8e-4 together and 5.2e-4 at
# most, on the discriminator's biases, whose first gradient is a
# near-cancelling difference of fake and real frames; PERF.md). A missing
# reduction or a wrong seed moves the gradient by a factor.
DP_FIRST_STEP_TOL = {"loss": 1e-5, "together": 1e-3, "tensor": 2e-3}
# The bit-balance loss's input gradient on two ranks against one process,
# relative to its largest |element| (f32; the statistics nest, so this
# fails if a rank's backward sees only its own rows of rms and the means).
DP_BALANCE_TOL = 1e-5


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spy_applied(opt, trainable, before_clip: bool = False) -> tuple:
    """`({name: gradient}, undo)`: the gradients as AdamW applies them
    (reduced, clipped), filled at each update of `opt` until `undo()`;
    with `before_clip`, as the step has summed them over the ranks (with
    a group or without), before the clip."""
    from open_genie_tpu_torch.parallel import collectives

    applied = {}
    if before_clip:
        reduce = collectives.all_reduce_tensors_

        def spy(tensors, *args, **kwargs):
            out = reduce(tensors, *args, **kwargs)
            if tensors and tensors[0] is trainable[0][1].grad:
                applied.update({n: t.detach().clone() for (n, _), t in zip(trainable, tensors)})
            return out

        def undo():
            collectives.all_reduce_tensors_ = reduce

        collectives.all_reduce_tensors_ = spy
        return applied, undo
    adamw_step = opt.adamw.step

    def spy(*args, **kwargs):
        applied.update({n: p.grad.detach().clone() for n, p in trainable})
        return adamw_step(*args, **kwargs)

    def undo():
        opt.adamw.step = adamw_step

    opt.adamw.step = spy
    return applied, undo


def _trainable(state) -> list:
    """`(name, parameter)` of each parameter a TrainState's optimizer
    steps, in its order."""
    ids = {id(p) for p in state.optimizer.params}
    return [(n, p) for n, p in state.module.named_parameters() if id(p) in ids]


def _grad_rel_errs(got: dict, ref: dict) -> dict:
    """`||got - ref|| / ||ref||` of each tensor (f64 norms), largest first,
    and under "" that of all the tensors together."""
    errs = {n: ((got[n].double() - r.double()).norm() / r.double().norm().clamp_min(1e-30)).item()
            for n, r in ref.items()}
    whole = (sum((got[n].double() - r.double()).square().sum() for n, r in ref.items())
             / sum(r.double().square().sum() for r in ref.values())).sqrt().item()
    return {"": whole, **dict(sorted(errs.items(), key=lambda kv: -kv[1]))}


def _first_difference(a: dict, b: dict) -> str:
    """The first name (in order) whose tensors differ, with the largest
    |difference|; '' when all are bit-identical."""
    for name in a:
        if not torch.equal(a[name], b[name]):
            return f"{name} (max |d| {(a[name].float() - b[name].float()).abs().max().item():.3g})"
    return ""


def _dp_world1_step(label: str, path: str, module, batch, frozen: tuple, opt_kwargs: dict,
                    gen_seed: int, smi: str) -> dict:
    """`module` and a copy of it, one through `make_train_step` without a
    mesh and one through the distributed step on the run's mesh (one NCCL
    rank), each from a generator of `gen_seed`: the first step's loss, metrics,
    applied gradients and parameters after it bit-identical; then
    DP_TIMED_STEPS more of each, timed in turns (bare, dp, dp, bare), with
    each step's peak memory. Returns the DP step's launches, times,
    memory and gradient bytes all-reduced."""
    from open_genie_tpu_torch.parallel.mesh import Mesh, make_mesh
    from open_genie_tpu_torch.train.losses import frozen_param_mask
    from open_genie_tpu_torch.train.loop import make_optimizer, make_train_step

    dev = batch.device
    mask = frozen_param_mask(module, frozen)
    runs = {}
    for name, mesh, m in (("bare", Mesh(1), module), ("dp", make_mesh(), copy.deepcopy(module))):
        opt = make_optimizer(m, frozen_mask=mask, **opt_kwargs)
        applied, undo = _spy_applied(opt, [(n, p) for n, p in m.named_parameters() if mask[n]])
        runs[name] = {"module": m, "applied": applied, "undo": undo, "ms": [], "peak": [],
                      "step": make_train_step(m, opt, compute_dtype=torch.bfloat16, mesh=mesh),
                      "gen": torch.Generator(device=dev).manual_seed(gen_seed)}
    for name, run in runs.items():
        _reset_counts()
        with _CollectiveBytes() as moved:
            run["metrics"] = run["step"](batch, generator=run["gen"])
            torch.cuda.synchronize()
        run["counts"], run["bytes"] = _read_counts(), moved.reduced
        run["undo"]()
        if name == "dp":
            _assert_path_kernels(f"{label} dp", path, show=False)
    bare, dp = runs["bare"], runs["dp"]
    parts = {"metrics": (bare["metrics"], dp["metrics"]),
             "applied gradients": (bare["applied"], dp["applied"]),
             "parameters": (dict(bare["module"].named_parameters()),
                            dict(dp["module"].named_parameters()))}
    for part, (a, b) in parts.items():
        assert set(a) == set(b) and a, f"[{label}] {part}: other names"
        diff = _first_difference(a, b)
        assert not diff, f"[{label}] the distributed step's {part}: {diff} differs"
    sizes = {part: len(a) for part, (a, _) in parts.items()}
    bare["applied"].clear()
    dp["applied"].clear()
    for name in ["bare", "dp", "dp", "bare"] * ((DP_TIMED_STEPS + 1) // 2):
        run = runs[name]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run["step"](batch, generator=run["gen"])
        torch.cuda.synchronize()
        run["ms"].append((time.perf_counter() - t0) * 1e3)
        run["peak"].append(torch.cuda.max_memory_allocated() / 2 ** 30)
    ms = {name: statistics.median(run["ms"]) for name, run in runs.items()}
    peak = {name: max(run["peak"]) for name, run in runs.items()}
    print(f"[{label}] {smi}: one rank on NCCL: loss {dp['metrics']['loss'].item():.6f}, "
          f"{sizes['metrics']} metrics, {sizes['applied gradients']} applied gradients and "
          f"{sizes['parameters']} parameters after the first step bit-identical to the bare "
          f"step's; {ms['dp']:.1f} ms per step against {ms['bare']:.1f} bare (medians of "
          f"{len(dp['ms'])} in turns: {[round(t, 1) for t in dp['ms']]} and "
          f"{[round(t, 1) for t in bare['ms']]}); {dp['bytes'] / 2 ** 20:.1f} MiB of gradient "
          f"all-reduced per step; peak memory {peak['dp']:.2f} GiB against {peak['bare']:.2f} "
          f"(both models resident); launches {dp['counts']}")
    return {"launches": dp["counts"], "ms": ms["dp"], "bare_ms": ms["bare"],
            "reduced_bytes": dp["bytes"], "peak_gib": peak["dp"], "bare_peak_gib": peak["bare"]}


def phase_dp_world1(dev, smi: str) -> dict:
    """Phase 29a: the distributed step on a one-rank NCCL group at full
    width, against the bare step (phases 12's and 9's): MAGVIT2
    `tokenizer_train_config()` at 4 x 8 x 64x64 (K1, K3 to K6) and
    `genie_train_config()` at 4 x 16 x 64x64 (K1 to K4), bf16 compute."""
    import torch.distributed as dist

    from open_genie_tpu_torch.models.configs import genie_train_config, tokenizer_train_config
    from open_genie_tpu_torch.parallel.mesh import init_distributed
    from open_genie_tpu_torch.train.losses import GenieTrainModule, TokenizerTrainModule
    from open_genie_tpu_torch.utils import init_weights

    torch.backends.cudnn.deterministic = True
    init_distributed(f"localhost:{_free_port()}", 1, 0, backend="nccl", device=dev)
    try:
        g = torch.Generator().manual_seed(SEED + 12)
        module = init_weights(TokenizerTrainModule(**tokenizer_train_config()), g).to(dev)
        video = torch.rand(*DP_TOK_BATCH, generator=g).to(dev)
        tok = _dp_world1_step("dp tokenizer train", "tokenizer_train", module, video,
                              ("perc_crit",), {}, SEED + 13, smi)
        del module, video
        g = torch.Generator().manual_seed(SEED + 7)
        module = init_weights(GenieTrainModule(genie_train_config()), g).to(dev)
        video = torch.rand(*DP_GENIE_BATCH, generator=g).to(dev)
        genie = _dp_world1_step("dp train", "train_step", module, video, ("model/tokenizer",),
                                dict(lr=1e-4, weight_decay=0.01, grad_clip=1.0), SEED + 8,
                                smi)
        del module, video
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return {"dp_tokenizer_train": tok, "dp_train_step": genie}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _dp_rank_spec(work: Path) -> dict:
    with open(work / "spec.json") as f:
        return json.load(f)


def dp_rank_main(work: Path) -> int:
    """One rank of phase 29b (`chip_smoke.py --dp-rank-of <work>`, launched by
    the phase with the `OGT_*` variables): K5/K6 on its 256 of 512 rows
    through `lfq_avg_entropy(group=)`, then `cli train tokenizer` on the
    phase's copy of tokenize.yaml (DP_STEPS steps) and on a copy resumed at
    DP_RESUME_AT; writes what it saw to `rank<r>.pt`."""
    import torch.distributed as dist

    _import_port()
    from open_genie_tpu_torch.cli import main as cli
    from open_genie_tpu_torch.ops.lfq import lfq_avg_entropy, lfq_bit_balance_loss
    from open_genie_tpu_torch.parallel import collectives
    from open_genie_tpu_torch.parallel.mesh import batch_sharding, init_distributed, make_mesh
    from open_genie_tpu_torch.train import trainer as ttrainer
    from open_genie_tpu_torch.train.loop import CheckpointWriter

    spec = _dp_rank_spec(work)
    dev = torch.device(spec["device"])
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    assert init_distributed(backend="gloo", device=dev)
    rank, group = dist.get_rank(), dist.group.WORLD
    rows = batch_sharding(make_mesh()).rows(512)
    x = torch.randn(512, 18, generator=torch.Generator(device=dev).manual_seed(spec["seed"]),
                    device=dev)[rows].clone().requires_grad_()
    _reset_counts()
    h = lfq_avg_entropy(x, 100.0, group=group)
    q = h.grad_fn.saved_tensors[1]
    collectives.backward(h, group)
    _sync(dev)
    out = {"q": q.cpu(), "dx": x.grad.cpu(), "h": h.item(), "split_counts": _read_counts()}
    xb = x.detach().clone().requires_grad_()
    balance = lfq_bit_balance_loss(xb, group=group)
    collectives.backward(balance, group)
    out.update(balance=balance.item(), balance_dx=xb.grad.cpu())

    steps, written, first = [], [], {}
    make_step, save = ttrainer.make_train_step, CheckpointWriter.save

    def timed_make_train_step(*args, **kwargs):
        step = make_step(*args, **kwargs)
        # The first run's first step: the gradients it applies, summed
        # over the ranks, before the clip.
        spy = None if first else _spy_applied(step.state.optimizer, _trainable(step.state),
                                              before_clip=True)

        def timed(batch, **kw):
            nonlocal spy
            _sync(dev)
            _reset_counts()
            t0 = time.perf_counter()
            metrics = step(batch, **kw)
            _sync(dev)
            steps.append({"ms": (time.perf_counter() - t0) * 1e3, "launches": _read_counts(),
                          "shapes": _read_shapes()})
            if spy is not None:
                first.update(grads=spy[0], loss=metrics["loss"].item())
                spy[1]()
                spy = None
            return metrics

        return timed

    def spy_save(self, state, step=None, **kwargs):
        written.append((Path(self.dir).name, step))
        return save(self, state, step, **kwargs)

    ttrainer.make_train_step, CheckpointWriter.save = timed_make_train_step, spy_save
    state = cli(["train", "tokenizer", "--config", spec["cfg_a"], "--device", dev.type])
    out["params_a"] = {n: p.detach().cpu() for n, p in state.module.named_parameters()}
    dist.barrier(group)
    if rank == 0:
        for name in (str(DP_RESUME_AT), "config.yaml"):
            src = Path(spec["ckpt_a"]) / name
            (shutil.copytree if src.is_dir() else shutil.copy)(src, Path(spec["ckpt_b"]) / name)
    dist.barrier(group)
    cli(["train", "tokenizer", "--config", spec["cfg_b"], "--resume", "--device", dev.type])
    out.update(steps=steps, written=written,
               first_grads={n: g.cpu() for n, g in first["grads"].items()},
               first_loss=first["loss"])
    torch.save(out, work / f"rank{rank}.pt")
    dist.destroy_process_group()
    return 0


def _dp_reference(cfg_path: str, dev, steps: int) -> tuple:
    """The one-process run that 29b's ranks are held to: `cli train`'s
    module, optimizer and step (`make_train_step`, no group) on the
    concatenation of the two ranks' batches (their loaders, `Mesh(2, 1,
    r)`), with the frame picks each rank's generator draws; f32, TF32
    off. Returns the per-step losses, ms, the parameters after, and the
    loss and gradients of the first step (as
    `_spy_applied(before_clip=True)`)."""
    from open_genie_tpu_torch.parallel.mesh import Mesh, global_batch, rank_seed
    from open_genie_tpu_torch.train.config import load_config
    from open_genie_tpu_torch.train.loop import make_optimizer, make_train_step
    from open_genie_tpu_torch.train.losses import frozen_param_mask
    from open_genie_tpu_torch.train.trainer import (
        _entropy_anneal_kwargs,
        _opt_kwargs,
        build_dataset,
        build_loader,
        build_tokenizer_module,
        init_module,
    )
    from open_genie_tpu_torch.utils import random_frame_idxs

    cfg = load_config(cfg_path, "tokenizer")
    tcfg, mcfg = cfg.trainer, cfg.model
    ds = build_dataset(cfg.data)
    meshes = [Mesh(2, 1, r) for r in range(2)]
    loaders = [build_loader(cfg, ds, dev, mesh=m) for m in meshes]
    gens = [torch.Generator(device=dev).manual_seed(rank_seed(tcfg.seed, m)) for m in meshes]
    module = init_module(build_tokenizer_module(mcfg), tcfg.seed, dev)
    opt = make_optimizer(module, **_opt_kwargs(mcfg.optimizer),
                         frozen_mask=frozen_param_mask(module, ("perc_crit",)))
    step = make_train_step(module, opt, loss_kwargs=_entropy_anneal_kwargs(mcfg))
    k = min(mcfg.gan_frames_per_batch, cfg.data.num_frames)
    losses, times, first = [], [], {}
    for i, parts in enumerate(zip(*loaders)):
        if i == steps:
            break
        b, t = parts[0].shape[:2]
        picks = [(random_frame_idxs(g, b, t, k, dev), random_frame_idxs(g, b, t, k, dev))
                 for g in gens]
        video = global_batch([p.to(dev) for p in parts])
        if i == 0:
            grads, undo = _spy_applied(step.state.optimizer, _trainable(step.state),
                                       before_clip=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(video, perc_idxs=torch.cat([p for p, _ in picks]),
                       gan_idxs=torch.cat([g for _, g in picks]))
        losses.append(metrics["loss"].item())
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            undo()
            first = {"grads": {n: g.cpu() for n, g in grads.items()}, "loss": losses[0]}
    return losses, times, {n: p.detach().cpu() for n, p in module.named_parameters()}, first


def f32_backward_check(label: str, shapes: set, dev) -> float:
    """K3 and K4 in f32 (the CUDA-core variants) against the plain backward
    at every `(B*H, N, D, causal)` an f32 path launched them at (the twin
    over slices of 8 heads); returns the largest |difference|."""
    from open_genie_tpu_torch.ops.kernels.flash_attention import (
        flash_attention,
        flash_attention_bwd,
        flash_attention_bwd_plain,
    )

    g = torch.Generator(device=dev).manual_seed(SEED + 29)
    err = 0.0
    for bh, n, d, causal in sorted(shapes):
        q, k, v, do = (torch.randn(bh, n, d, generator=g, device=dev) for _ in range(4))
        o, lse = flash_attention(q, k, v, d ** -0.5, causal)
        got = flash_attention_bwd(q, k, v, o, lse, do, d ** -0.5, causal)
        ref = _by_heads(flash_attention_bwd_plain, (q, k, v, o, lse, do), d ** -0.5, causal)
        torch.cuda.synchronize()
        for a, b, name in zip(got, ref, ("dq", "dk", "dv")):
            torch.testing.assert_close(a, b, **K3K4_TOL_F32,
                                       msg=lambda m, name=name: f"{label} {name}: {m}")
        e = max((a - b).abs().max().item() for a, b in zip(got, ref))
        print(f"[{label}] K3/K4 f32 at {(bh, n, d, causal)} against the plain backward: "
              f"|d| {e:.3g}")
        err = max(err, e)
        del q, k, v, do, o, lse, got, ref
    return err


def phase_dp_two_ranks(dev, smi: str) -> dict:
    """Phase 29b: two ranks on the one card over gloo, each a process of
    this script: K5/K6 at (512, 18) split 256 + 256 against K5/K6 over all
    512 rows and the float64 sweep; `cli train tokenizer` on a copy of
    tokenize.yaml with `trainer.n_data: 2` (f32, lr DP_LR, DP_STEPS steps,
    a save every DP_RESUME_AT) against the one-process run on the same
    global batches (`_dp_reference`), PIX_TOL; one checkpoint directory,
    written by rank 0 alone; a resumed run ending on the uninterrupted
    run's parameters; the ranks' parameters bit-equal."""
    from open_genie_tpu_torch.ops.kernels.lfq_entropy import (
        entropy_of,
        lfq_avg_probs,
        lfq_entropy_grad,
    )
    from open_genie_tpu_torch.ops.lfq import lfq_bit_balance_loss
    from open_genie_tpu_torch.train.loop import all_steps, load_checkpoint

    (HERE / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_dp_", dir=HERE / "build"))
    try:
        over = {"model": {"optimizer": {"init_args": {"lr": DP_LR}}}}
        runs = {}
        for name in ("a", "b"):
            run = work / name
            runs[name] = (run, yaml_copy("tokenize.yaml", work, {**over, **trainer_overrides(
                run, max_steps=DP_STEPS, precision="32", n_data=2, val_check_interval=DP_RESUME_AT,
                limit_val_batches=1, ckpt_every_n_steps=DP_RESUME_AT, ckpt_max_keep=3)}))
        spec = {"seed": SEED + 29, "device": dev.type, "cfg_a": runs["a"][1],
                "cfg_b": runs["b"][1],
                "ckpt_a": str(runs["a"][0] / "ckpt"), "ckpt_b": str(runs["b"][0] / "ckpt")}
        (work / "spec.json").write_text(json.dumps(spec))
        env = {**os.environ, "OGT_COORDINATOR": f"localhost:{_free_port()}",
               "OGT_NUM_PROCESSES": "2"}
        t0 = time.perf_counter()
        logs = [open(work / f"rank{r}.log", "w") for r in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, str(HERE / "chip_smoke.py"), "--dp-rank-of", str(work)],
            env={**env, "OGT_PROCESS_ID": str(r)}, stdout=log, stderr=subprocess.STDOUT,
            cwd=HERE) for r, log in enumerate(logs)]
        try:
            codes = [p.wait(timeout=600) for p in procs]
        finally:
            for p, log in zip(procs, logs):
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()
        seconds = time.perf_counter() - t0
        logs = [(work / f"rank{r}.log").read_text() for r in range(2)]
        assert codes == [0, 0], f"29b rank exit codes {codes}:\n" + "\n".join(
            f"--- rank {r}\n{log[-3000:]}" for r, log in enumerate(logs))
        ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(2)]

        # K5/K6 split 256 + 256 against all 512 rows and the float64 sweep.
        x = torch.randn(512, 18, generator=torch.Generator(device=dev).manual_seed(spec["seed"]),
                        device=dev)
        q = ranks[0]["q"].to(dev)
        assert torch.equal(ranks[0]["q"], ranks[1]["q"]), "the ranks' all-reduced q differ"
        assert ranks[0]["h"] == ranks[1]["h"]
        dx = torch.cat([r["dx"] for r in ranks]).to(dev)
        q_one = lfq_avg_probs(x, 100.0)
        eps = 1e-6
        w = torch.where(q > eps, 1.0 + torch.log(q.clamp_min(eps)), math.log(eps))
        dx_one = lfq_entropy_grad(x, w, 100.0) / 512
        q_ref, dx_ref = lfq_sweep_f64(x, w, 100.0)
        e_q = ((q.double() - q_ref).abs().max() / q_ref.max()).item()
        e_dx = ((dx.double() * 512 - dx_ref).abs().max() / dx_ref.abs().max()).item()
        e_one = ((q - q_one).abs().max() / q_one.max()).item()
        h_one = entropy_of(q_one, eps).item()
        split_counts = [r["split_counts"] for r in ranks]
        print(f"[dp K5/K6] (512, 18) split 256 + 256 over gloo: q all-reduced, off the "
              f"float64 sweep by {e_q:.3g} of max q and K5 over all 512 rows by {e_one:.3g}; "
              f"dx by {e_dx:.3g} of max|dx| off the sweep, {(dx - dx_one).abs().max().item():.3g}"
              f" off K6 over all rows; H {ranks[0]['h']:.6f} (one process {h_one:.6f}); "
              f"launches per rank {split_counts}")
        assert e_q <= 1e-5 and e_dx <= 1e-4, "the split K5/K6 disagree with the float64 sweep"
        assert all(c["lfq_entropy_fwd"] == 1 and c["lfq_entropy_bwd"] == 1 for c in split_counts)

        # The bit balance, whose statistics nest (rms inside tanh, the means
        # inside the correlations), split 256 + 256 against one process.
        xb = x.clone().requires_grad_()
        balance = lfq_bit_balance_loss(xb)
        balance.backward()
        bal_dx = torch.cat([r["balance_dx"] for r in ranks]).to(dev)
        e_bal = ((bal_dx - xb.grad).abs().max() / xb.grad.abs().max()).item()
        print(f"[dp bit balance] (512, 18) split 256 + 256 over gloo: loss "
              f"{ranks[0]['balance']:.7f} (one process {balance.item():.7f}), input gradient "
              f"{e_bal:.3g} of max|dx| off one process's (tolerance {DP_BALANCE_TOL:g})")
        assert ranks[0]["balance"] == ranks[1]["balance"], "the ranks' bit balances differ"
        assert e_bal <= DP_BALANCE_TOL, f"the split bit balance's gradient is off by {e_bal:.3g}"

        # cli train on two ranks against one process on the same batches.
        steps = [r["steps"] for r in ranks]
        with _Tf32Off():
            ref_losses, ref_ms, ref_params, ref_first = _dp_reference(spec["cfg_a"], dev,
                                                                      DP_STEPS)
        records = read_jsonl(runs["a"][0] / "logs")
        _finite_records("dp trainer", records)
        losses = [r["loss"] for r in records if "loss" in r]
        print(f"[dp trainer] per-step loss on two ranks {[round(v, 5) for v in losses]}, one "
              f"process on the same global batches {[round(v, 5) for v in ref_losses]}")
        # The first step, before any update: loss and reduced gradients.
        grads = ranks[0]["first_grads"]
        for n, g in grads.items():
            assert torch.equal(g, ranks[1]["first_grads"][n]), f"the ranks' first {n} differ"
        errs = _grad_rel_errs(grads, ref_first["grads"])
        top = [n for n in errs if n][:4]
        g_err, l_err = errs[top[0]], abs(ranks[0]["first_loss"] / ref_first["loss"] - 1)
        print(f"[dp trainer] {smi}: first step on two ranks against one process on the global "
              f"batch (f32, TF32 off): loss {l_err:.3g} relative, the {len(grads)} reduced "
              f"gradients before the clip {errs['']:.3g} of their norm together, at most "
              f"{g_err:.3g} tensor by tensor ("
              + ", ".join(f"{n} {errs[n]:.3g}" for n in top)
              + f"); tolerances {DP_FIRST_STEP_TOL}")
        assert set(grads) == set(ref_first["grads"]), "the first step's gradients differ"
        assert l_err <= DP_FIRST_STEP_TOL["loss"], f"first-step loss off by {l_err:.3g}"
        assert errs[""] <= DP_FIRST_STEP_TOL["together"], f"first-step gradients off by {errs['']:.3g}"
        assert g_err <= DP_FIRST_STEP_TOL["tensor"], f"first-step {top[0]} off by {g_err:.3g}"
        np.testing.assert_allclose(losses, ref_losses, **PIX_TOL)
        ckpt, at = load_checkpoint(spec["ckpt_a"])
        assert at == DP_STEPS
        p_err = max((ckpt["params"][n] - p).abs().max().item() for n, p in ref_params.items())
        for n, p in ref_params.items():
            torch.testing.assert_close(ckpt["params"][n], p, **PIX_TOL,
                                       msg=lambda m, n=n: f"dp trainer {n}: {m}")
        for n, p in ranks[0]["params_a"].items():
            assert torch.equal(p, ranks[1]["params_a"][n]), f"the ranks' {n} differ"
        assert ranks[1]["written"] == [], f"rank 1 wrote {ranks[1]['written']}"
        periodic = sorted(w for w in ranks[0]["written"] if w[0] == "ckpt")
        assert all_steps(spec["ckpt_a"]) == [DP_RESUME_AT, DP_STEPS], all_steps(spec["ckpt_a"])
        resumed, _ = load_checkpoint(spec["ckpt_b"])
        diff = _first_difference(ckpt["params"], resumed["params"])
        assert not diff, f"the run resumed at {DP_RESUME_AT} ends off the uninterrupted: {diff}"
        assert "[step" not in logs[1], "rank 1 printed step lines"
        shapes = {}
        for s in steps[0]:
            for name in _FLASH:
                for case in s["shapes"][name]:
                    shapes.setdefault(name, set()).add(case)
        k1_err = f32_path_check("dp trainer", shapes.get("flash_attention_fwd", set()), dev)
        bwd = shapes.get("flash_attention_bwd_dkv", set()) | shapes.get("flash_attention_bwd_dq",
                                                                         set())
        k34_err = f32_backward_check("dp trainer", bwd, dev)
        ms = [statistics.median([s["ms"] for s in st[1:]]) for st in steps]
        one_ms = statistics.median(ref_ms[1:])
        print(f"[dp trainer] {smi}: {ms[0]:.1f} and {ms[1]:.1f} ms per step on ranks 0 and 1 "
              f"(medians of the timed steps after the first, both runs) against {one_ms:.1f} ms "
              f"for the one-process step on the global batch; max |d param| after "
              f"{DP_STEPS} steps {p_err:.3g}; the ranks' parameters bit-equal; checkpoints "
              f"written by rank 0 {periodic}, none by rank 1; the run resumed at "
              f"{DP_RESUME_AT} bit-identical to the uninterrupted one at {DP_STEPS}; launches "
              f"per rank step {steps[0][-1]['launches']}; K1 f32 at the ranks' shapes within "
              f"{k1_err:.3g} of its twin, K3/K4 {k34_err:.3g}; 29b took {seconds:.1f} s with "
              f"both ranks' start-up")
        return {"launches": steps[0][-1]["launches"], "split_launches": split_counts[0],
                "rank_ms": ms, "one_process_ms": one_ms, "q_sweep_rel_err": e_q,
                "dx_sweep_rel_err": e_dx, "param_max_abs_err": p_err, "seconds": seconds,
                "balance_dx_rel_err": e_bal, "first_loss_rel_err": l_err,
                "first_grad_rel_err": errs[""], "first_grad_tensor_rel_err": g_err}
    finally:
        shutil.rmtree(work, ignore_errors=True)


# Phase 30: tensor parallelism over the `model` axis, two gloo ranks on the
# one card (mesh data 1 x model 2), each a process of this script.
TP_LR = 1e-4
TP_GENIE_BATCH = (4, 16, 64, 64, 3)  # genie.yaml's batch
# The flagship dry run's batch (`__graft_entry__.py`: max(n_data, 2) clips
# of 4 x 8x8 frames).
TP_FLAGSHIP_BATCH = (2, 4, 8, 8, 3)
TP_TURNS = 1  # rounds of (one process, TP, TP, one process) timed in 30a
# 30c: `cli train genie` steps, its one checkpoint, and its lr (genie.yaml's
# 1e-4 takes the f32 loss from 15.5 to 1117 in 3 steps; the JAX package's
# step diverges there too, tests/test_torch_yaml_divergence.py, PERF.md).
TP_STEPS, TP_CKPT_AT, TP_CLI_LR = 3, 2, 1e-5
# A TP step in f32 (TF32 off) against one process on the same weights,
# batch and noise: the loss within `loss` relative, each gathered gradient
# (before the clip) within `grad` of its norm, the parameters after the
# step within 2.1 lr. The gap is f32 rounding: partial sums over half the
# heads or half the vocabulary added in another order.
TP_TOL = {"loss": 1e-5, "grad": 1e-4}


class _CollectiveBytes:
    """The bytes handed to `torch.distributed.all_reduce` and, gathered
    (the whole output), to `all_gather` while inside (the collectives call
    them through the module's attributes)."""

    def __enter__(self):
        import torch.distributed as dist

        self.reduced = self.gathered = 0
        self._orig = (dist.all_reduce, dist.all_gather)

        def reduce(t, *args, **kwargs):
            self.reduced += t.numel() * t.element_size()
            return self._orig[0](t, *args, **kwargs)

        def gather(out, t, *args, **kwargs):
            self.gathered += sum(o.numel() * o.element_size() for o in out)
            return self._orig[1](out, t, *args, **kwargs)

        dist.all_reduce, dist.all_gather = reduce, gather
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.all_reduce, dist.all_gather = self._orig
        return False


def _genie_step(module, mesh, dev, video, gen_seed: int, compute_dtype=None) -> dict:
    """One `make_train_step` step of a Genie train module, split over
    `mesh`'s model axis (or, on `Mesh(1)`, in one process): the metrics,
    the trainable gradients before the clip and the parameters after,
    each in the one-process layout on the CPU."""
    from open_genie_tpu_torch.parallel.tensor import gather_split, split_of
    from open_genie_tpu_torch.train.loop import make_optimizer, make_train_step
    from open_genie_tpu_torch.train.losses import frozen_param_mask

    mask = frozen_param_mask(module, ("model/tokenizer",))
    opt = make_optimizer(module, lr=TP_LR, weight_decay=0.01, grad_clip=1.0, frozen_mask=mask)
    grads, undo = _spy_applied(opt, [(n, p) for n, p in module.named_parameters() if mask[n]],
                               before_clip=True)
    step = make_train_step(module, opt, compute_dtype=compute_dtype, mesh=mesh)
    metrics = step(video, generator=torch.Generator(device=dev).manual_seed(gen_seed))
    undo()
    named = dict(module.named_parameters())

    def whole(name, t):
        return gather_split(t, split_of(named[name]), mesh.model_group).cpu()

    return {"metrics": {k: v.item() for k, v in metrics.items()},
            "grads": {n: whole(n, g) for n, g in grads.items()},
            "params": {n: whole(n, p.detach()) for n, p in named.items()}}


def _tp_compare(tp: dict, one: dict) -> dict:
    """A TP step's loss, metrics, gradients and parameters against one
    process's: relative errors, the largest first."""
    errs = _grad_rel_errs(tp["grads"], one["grads"])
    metric_errs = sorted(((abs(v - one["metrics"][k]) / max(abs(one["metrics"][k]), 1e-6), k)
                          for k, v in tp["metrics"].items()), reverse=True)
    return {"loss": abs(tp["metrics"]["loss"] / one["metrics"]["loss"] - 1),
            "metrics": metric_errs[0][0],
            "worst_metrics": [f"{k} {e:.3g}" for e, k in metric_errs[:4]],
            "grads_together": errs[""], "grad": max(v for k, v in errs.items() if k),
            "worst": [k for k in errs if k][:3],
            "param": max((p - one["params"][n]).abs().max().item()
                         for n, p in tp["params"].items())}


def _fingerprint(tensors: dict) -> dict:
    """Each tensor's float64 sum and largest |element|: what two ranks'
    copies are compared by."""
    return {n: (t.double().sum().item(), t.abs().max().item()) for n, t in tensors.items()}


def _code_margin(genie, video: torch.Tensor) -> float:
    """The smallest |value| whose sign is an LFQ code of `genie`'s frozen
    tokenizer or latent action on `video` (f32, no gradient): a code
    within rounding of 0 (LFQ_UNDECIDED) is decided by the order of the
    sums, and a TP step and one process may then see other tokens."""
    tok, la = genie.tokenizer, genie.latent_action
    la.eval()
    with torch.no_grad():
        x = tok.encode(video)
        (_, _, enc), _, _ = la.encode(video)
        z = la.to_act(enc.reshape(*video.shape[:2], -1))
        x, z = (q.proj_inp(v) if q.project else v for q, v in ((tok.quant, x), (la.quant, z)))
    la.train()
    return min(x.abs().min().item(), z.abs().min().item())


def _tp_f32_case(label: str, cfg: dict, batch: tuple, seed: int, mesh, dev) -> dict:
    """30a / 30b on a rank: the f32 TP step and, on rank 0, the one-process
    step of the same weights, batch and noise (TF32 off), compared there
    (`_tp_compare`); the metrics and the gathered gradients' fingerprints,
    the split parameters' shapes, K1-K4's launches and shapes."""
    import torch.distributed as dist

    from open_genie_tpu_torch.parallel.mesh import Mesh
    from open_genie_tpu_torch.parallel.tensor import shard_module, split_of
    from open_genie_tpu_torch.train.losses import GenieTrainModule
    from open_genie_tpu_torch.utils import init_weights

    g = torch.Generator().manual_seed(seed)
    whole = init_weights(GenieTrainModule(cfg), g)
    video = torch.rand(*batch, generator=g).to(dev)
    with _Tf32Off():
        tp = shard_module(copy.deepcopy(whole).to(dev), mesh)
        split = {n: tuple(p.shape) for n, p in tp.named_parameters() if split_of(p)}
        _reset_counts()
        got = _genie_step(tp, mesh, dev, video, seed + 1)
        out = {"metrics": got["metrics"], "grads": _fingerprint(got["grads"]), "split": split,
               "shapes": _read_shapes(), "launches": _read_counts()}
        del tp
        if mesh.rank == 0:
            whole.to(dev)
            out["code_margin"] = _code_margin(whole.model, video)
            out["errs"] = _tp_compare(got, _genie_step(whole, Mesh(1), dev, video, seed + 1))
        del got, whole
        dist.barrier()
    torch.cuda.empty_cache()
    print(f"[{label}] rank {mesh.rank}: {len(split)} split parameters, loss "
          f"{out['metrics']['loss']:.6f}", flush=True)
    return out


def _tp_bf16_turns(mesh, dev) -> dict:
    """30a in bf16 on a rank: the first TP step's launches by variant and
    shape (every K1, K3, K4 launch on the tensor cores at
    `PATH_CASES["tp_train_step"]`), the bytes all-reduced and gathered and
    the peak memory; then, after one untimed one-process step, TP_TURNS
    rounds of (one process, TP, TP, one process), the one-process step on
    rank 0 while rank 1 waits."""
    import torch.distributed as dist

    from open_genie_tpu_torch.models.configs import genie_train_config
    from open_genie_tpu_torch.parallel.mesh import Mesh
    from open_genie_tpu_torch.parallel.tensor import shard_module
    from open_genie_tpu_torch.train.loop import make_optimizer, make_train_step
    from open_genie_tpu_torch.train.losses import GenieTrainModule, frozen_param_mask
    from open_genie_tpu_torch.utils import init_weights

    torch.backends.cudnn.deterministic = True
    g = torch.Generator().manual_seed(SEED + 7)
    whole = init_weights(GenieTrainModule(genie_train_config()), g)
    video = torch.rand(*TP_GENIE_BATCH, generator=g).to(dev)

    def make(module, mesh_):
        mask = frozen_param_mask(module, ("model/tokenizer",))
        opt = make_optimizer(module, lr=TP_LR, weight_decay=0.01, grad_clip=1.0,
                             frozen_mask=mask)
        return make_train_step(module, opt, compute_dtype=torch.bfloat16, mesh=mesh_)

    tp_step = make(shard_module(copy.deepcopy(whole).to(dev), mesh), mesh)
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    with _CollectiveBytes() as moved:
        metrics = tp_step(video, generator=gen)
        torch.cuda.synchronize()
    counts, shapes = _read_counts(), _read_shapes()
    variants = _assert_path_kernels("tp train", "tp_train_step", show=mesh.rank == 0)
    assert all(variants[name]["mma"] == counts[name] for name in _FLASH)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    loss = metrics["loss"].item()
    assert math.isfinite(loss), "non-finite TP loss"
    one_step = make(whole.to(dev), Mesh(1)) if mesh.rank == 0 else None
    if one_step is not None:  # its first call sets up what the TP step's first did
        one_step(video, generator=gen)
    dist.barrier()
    ms = {"one": [], "tp": []}
    for name in ["one", "tp", "tp", "one"] * TP_TURNS:
        if name == "one" and one_step is None:
            dist.barrier()
            continue
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (one_step if name == "one" else tp_step)(video, generator=gen)
        torch.cuda.synchronize()
        ms[name].append((time.perf_counter() - t0) * 1e3)
        if name == "one":
            dist.barrier()
    return {"launches": counts, "shapes": shapes, "loss": loss, "peak_gib": peak,
            "reduced_bytes": moved.reduced, "gathered_bytes": moved.gathered, "ms": ms}


def _tp_rank_spec(work: Path) -> dict:
    with open(work / "spec.json") as f:
        return json.load(f)


def tp_rank_main(work: Path) -> int:
    """One rank of phase 30 (`chip_smoke.py --tp-rank-of <work>`, launched
    by the phase with the `OGT_*` variables, gloo on the one card, mesh 1
    x 2): 30a's f32 and bf16 steps of `genie_train_config()`, 30b's
    flagship step, then 30c's `cli train genie` on the phase's genie.yaml
    copy with `trainer.n_model: 2`; writes what it saw to `rank<r>.pt`."""
    import torch.distributed as dist

    _import_port()
    from open_genie_tpu_torch.cli import main as cli
    from open_genie_tpu_torch.models.configs import genie_tp_flagship_config, genie_train_config
    from open_genie_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from open_genie_tpu_torch.train.loop import CheckpointWriter

    spec = _tp_rank_spec(work)
    dev = torch.device(spec["device"])
    assert init_distributed(backend="gloo", device=dev)
    mesh = make_mesh(1, 2)
    # 30a's draw: at SEED + 30 the seeded init puts one of the frozen
    # tokenizer's codes at |x| = 7.1e-7 (a token that the order of the sums
    # decides), so 30a draws from SEED + 33, whose codes are all at least
    # 1.5e-5 from 0; the phase asserts it.
    out = {"f32": _tp_f32_case("tp f32", genie_train_config(), TP_GENIE_BATCH, SEED + 33,
                               mesh, dev)}
    out["bf16"] = _tp_bf16_turns(mesh, dev)
    out["flagship"] = _tp_f32_case("tp flagship", genie_tp_flagship_config(), TP_FLAGSHIP_BATCH,
                                   SEED + 32, mesh, dev)
    torch.cuda.empty_cache()
    from open_genie_tpu_torch.data import video

    written, save = [], CheckpointWriter.save
    videos, write_mp4 = [], video.write_mp4

    def spy_save(self, state, step=None, **kwargs):
        written.append((Path(self.dir).name, step))
        return save(self, state, step, **kwargs)

    def spy_write(path, frames, *args, **kwargs):
        videos.append((str(path), tuple(frames.shape)))
        return write_mp4(path, frames, *args, **kwargs)

    CheckpointWriter.save, video.write_mp4 = spy_save, spy_write
    t0 = time.perf_counter()
    with _Tf32Off():
        state = cli(["train", "genie", "--config", spec["cfg_tp"], "--device", dev.type])
    out["cli"] = {"written": written, "videos": videos, "step": state.step,
                  "seconds": time.perf_counter() - t0,
                  "split": sum(1 for p in state.module.parameters()
                               if getattr(p, "tp_split", None))}
    torch.save(out, work / f"rank{mesh.rank}.pt")
    dist.destroy_process_group()
    return 0


def phase_tp_two_ranks(dev, smi: str) -> dict:
    """Phase 30: two ranks on the one card over gloo, a mesh of data 1 x
    model 2 (`tp_rank_main`). 30a: `genie_train_config()` at genie.yaml's
    batch, one f32 step held to one process (TP_TOL), one bf16 step with
    every K1, K3 and K4 launch on the tensor cores at the per-rank shapes
    (`PATH_CASES["tp_train_step"]`, held to their twins by phases 3 and 7),
    its collective bytes and peak memory, ms per rank step beside the
    one-process step in turns. 30b: the flagship split
    (`genie_tp_flagship_config()`, a 2^18 head and token embedding split in
    two), one f32 step held to one process. 30c: `cli train genie` on a
    genie.yaml copy with `trainer.n_model: 2` (f32, lr TP_CLI_LR, TP_STEPS
    steps, one checkpoint at TP_CKPT_AT, by rank 0 alone, in the
    one-process layout; a validation at the last step, whose sample video
    rank 0 alone writes); the checkpoint resumed on one process gives the
    TP run's next step within TP_TOL["loss"]."""
    from open_genie_tpu_torch.cli import main as cli
    from open_genie_tpu_torch.models.configs import genie_tp_flagship_config, genie_train_config
    from open_genie_tpu_torch.train.loop import all_steps, load_checkpoint
    from open_genie_tpu_torch.train.losses import GenieTrainModule

    (HERE / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_tp_", dir=HERE / "build"))
    try:
        tp_run, one_run = work / "tp", work / "one"
        common = dict(max_steps=TP_STEPS, precision="32", n_data=1,
                      ckpt_every_n_steps=TP_CKPT_AT, save_last=False,
                      val_check_interval=TP_STEPS, limit_val_batches=1)
        lr = {"model": {"optimizer": {"init_args": {"lr": TP_CLI_LR}}}}
        cfg_tp = yaml_copy("genie.yaml", work, {**lr, **trainer_overrides(tp_run, n_model=2,
                                                                         **common)})
        cfg_one = yaml_copy("genie.yaml", work, {**lr, **trainer_overrides(one_run, n_model=1,
                                                                          **common)})
        (work / "spec.json").write_text(json.dumps({"cfg_tp": cfg_tp, "device": dev.type}))
        env = {**os.environ, "OGT_COORDINATOR": f"localhost:{_free_port()}",
               "OGT_NUM_PROCESSES": "2"}
        t0 = time.perf_counter()
        logs = [open(work / f"rank{r}.log", "w") for r in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, str(HERE / "chip_smoke.py"), "--tp-rank-of", str(work)],
            env={**env, "OGT_PROCESS_ID": str(r)}, stdout=log, stderr=subprocess.STDOUT,
            cwd=HERE) for r, log in enumerate(logs)]
        try:
            codes = [p.wait(timeout=900) for p in procs]
        finally:
            for p, log in zip(procs, logs):
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()
        seconds = time.perf_counter() - t0
        logs = [(work / f"rank{r}.log").read_text() for r in range(2)]
        assert codes == [0, 0], f"30 rank exit codes {codes}:\n" + "\n".join(
            f"--- rank {r}\n{log[-3000:]}" for r, log in enumerate(logs))
        ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(2)]
        print("\n".join(line for line in logs[0].splitlines() if line.startswith("[tp")))

        # 30a and 30b: f32 TP steps against one process.
        for key, label in (("f32", "tp f32"), ("flagship", "tp flagship")):
            e = ranks[0][key]["errs"]
            a, b = (r[key] for r in ranks)
            assert a["metrics"] == b["metrics"], f"[{label}] the ranks' metrics differ"
            assert a["grads"] == b["grads"], f"[{label}] the ranks' gathered gradients differ"
            print(f"[{label}] {smi}: one f32 step on 2 model ranks against one process (TF32 "
                  f"off): loss {e['loss']:.3g} relative, metrics {e['metrics']:.3g}, the "
                  f"{len(a['grads'])} gathered gradients before the clip {e['grads_together']:.3g} "
                  f"of their norm together, {e['grad']:.3g} at most ({', '.join(e['worst'])}); "
                  f"metrics {e['worst_metrics']}; the LFQ codes' smallest |value| before "
                  f"their signs {ranks[0][key]['code_margin']:.3g}; "
                  f"max |d param| after the step {e['param']:.3g}; {len(ranks[0][key]['split'])} "
                  f"split parameters a rank; the ranks' metrics and gradients bit-equal; "
                  f"tolerances {TP_TOL}")
            assert ranks[0][key]["code_margin"] > LFQ_UNDECIDED, (
                f"[{label}] an LFQ code of the draw is decided by rounding: the comparison "
                "has no meaning on it")
            assert e["loss"] <= TP_TOL["loss"], f"[{label}] loss off by {e['loss']:.3g}"
            assert e["grad"] <= TP_TOL["grad"], f"[{label}] {e['worst'][0]} off by {e['grad']:.3g}"
            assert e["param"] <= 2.1 * TP_LR, f"[{label}] parameters off by {e['param']:.3g}"
        flagship = genie_tp_flagship_config()
        vocab, dim = 2 ** flagship["tokenizer"]["d_codebook"], flagship["dynamics"]["embed_dim"]
        head = ranks[0]["flagship"]["split"]["model.dynamics.head.weight"]
        emb = ranks[0]["flagship"]["split"]["model.dynamics.tok_emb.weight"]
        assert head == (vocab // 2, dim) and emb == (vocab, dim // 2), (head, emb)
        print(f"[tp flagship] dynamics head {head} and token embedding {emb} on each rank "
              f"(whole: {(vocab, dim)} each)")
        shapes = {}
        for key in ("f32", "flagship"):
            for name in _FLASH:
                for case in ranks[0][key]["shapes"][name]:
                    shapes.setdefault(name, set()).add(case)
        k1_err = f32_path_check("tp f32", shapes.get("flash_attention_fwd", set()), dev)
        k34_err = f32_backward_check("tp f32", shapes.get("flash_attention_bwd_dkv", set())
                                     | shapes.get("flash_attention_bwd_dq", set()), dev)

        # 30a in bf16: launches, bytes, memory, ms in turns.
        bf = [r["bf16"] for r in ranks]
        assert bf[0]["launches"] == bf[1]["launches"] and bf[0]["shapes"] == bf[1]["shapes"]
        ms_tp = [statistics.median(b["ms"]["tp"]) for b in bf]
        ms_one = statistics.median(bf[0]["ms"]["one"])
        mib = 2 ** 20
        b, t, h, w, _ = TP_GENIE_BATCH
        print(f"[tp train] {smi}: bf16 step of genie_train_config() at {b} x {t} x {h}x{w} on 2 "
              f"model ranks over gloo: loss {bf[0]['loss']:.5f}; "
              f"{ms_tp[0]:.1f} and {ms_tp[1]:.1f} ms per step on ranks 0 and 1 (medians of "
              f"{len(bf[0]['ms']['tp'])} in turns: {[round(t, 1) for t in bf[0]['ms']['tp']]}) "
              f"against {ms_one:.1f} ms for the one-process step "
              f"({[round(t, 1) for t in bf[0]['ms']['one']]}); {bf[0]['reduced_bytes'] / mib:.1f} "
              f"MiB all-reduced and {bf[0]['gathered_bytes'] / mib:.1f} MiB all-gathered a rank "
              f"step; peak memory {bf[0]['peak_gib']:.2f} and {bf[1]['peak_gib']:.2f} GiB on "
              f"ranks 0 and 1; launches a rank {bf[0]['launches']}")

        # 30c: the checkpoint of `cli train genie` on two model ranks.
        cli0, cli1 = (r["cli"] for r in ranks)
        assert cli1["written"] == [], f"rank 1 wrote {cli1['written']}"
        assert cli0["written"] == [("ckpt", TP_CKPT_AT)], cli0["written"]
        # The sample video of the validation at the last step: rank 0 alone
        # rolls out on the gathered weights and writes it.
        mp4 = tp_run / "logs" / f"sample_step{TP_STEPS}.mp4"
        assert cli1["videos"] == [], f"rank 1 wrote {cli1['videos']}"
        assert [p for p, _ in cli0["videos"]] == [str(mp4)], cli0["videos"]
        assert mp4.is_file() and mp4.stat().st_size > 0, f"no sample video at {mp4}"
        assert not any("[eval-hook]" in log for log in logs), "the sample video failed"
        assert all_steps(tp_run / "ckpt") == [TP_CKPT_AT]
        assert "[step" not in logs[1], "rank 1 printed step lines"
        records = read_jsonl(tp_run / "logs")
        _finite_records("tp trainer", records)
        assert [r["step"] for r in records if any(k.startswith("val_") for k in r)] == [
            TP_STEPS], "30c validates at its last step only"
        tp_losses = {r["step"]: r["loss"] for r in records if "loss" in r}
        assert sorted(tp_losses) == list(range(1, TP_STEPS + 1)), sorted(tp_losses)
        ckpt, _ = load_checkpoint(str(tp_run / "ckpt"))
        with torch.device("meta"):
            want = {k: tuple(v.shape)
                    for k, v in GenieTrainModule(genie_train_config()).state_dict().items()}
        assert {k: tuple(v.shape) for k, v in ckpt["params"].items()} == want, (
            "the TP checkpoint is not in the one-process layout")
        (one_run / "ckpt").mkdir(parents=True)
        for name in (str(TP_CKPT_AT), "config.yaml"):
            src = tp_run / "ckpt" / name
            (shutil.copytree if src.is_dir() else shutil.copy)(src, one_run / "ckpt" / name)
        with _Tf32Off():
            cli(["train", "genie", "--config", cfg_one, "--resume", "--device", dev.type])
        one_losses = {r["step"]: r["loss"] for r in read_jsonl(one_run / "logs") if "loss" in r}
        assert sorted(one_losses) == [TP_STEPS], sorted(one_losses)
        l_err = abs(one_losses[TP_STEPS] / tp_losses[TP_STEPS] - 1)
        tp_ms = [1e3 / r["steps_per_sec"] for r in records if "steps_per_sec" in r][1:]
        print(f"[tp trainer] {smi}: cli train genie on 2 model ranks (f32): losses "
              f"{[round(tp_losses[s], 6) for s in sorted(tp_losses)]}, "
              f"{cli0['split']} split parameters a rank, one checkpoint at step {TP_CKPT_AT} "
              f"by rank 0 in the one-process layout ({len(ckpt['params'])} tensors); the "
              f"sample video of step {TP_STEPS} by rank 0 alone, frames "
              f"{cli0['videos'][0][1]}, {mp4.stat().st_size} bytes of mp4; resumed "
              f"on one process, step {TP_STEPS}'s loss {one_losses[TP_STEPS]:.6f} against the "
              f"TP run's {tp_losses[TP_STEPS]:.6f}: {l_err:.3g} relative; TP steps after the "
              f"first {[round(t, 1) for t in tp_ms]} ms; K1 f32 at the ranks' shapes within "
              f"{k1_err:.3g} of its twin, K3/K4 {k34_err:.3g}; phase 30's ranks took "
              f"{seconds:.1f} s with their start-up")
        assert l_err <= TP_TOL["loss"], f"the resumed step 3 is off by {l_err:.3g}"
        return {"launches": bf[0]["launches"], "shapes": bf[0]["shapes"],
                "sample_video_frames": cli0["videos"][0][1],
                "rank_ms": ms_tp, "one_process_ms": ms_one,
                "reduced_mib": bf[0]["reduced_bytes"] / mib,
                "gathered_mib": bf[0]["gathered_bytes"] / mib,
                "peak_gib": [b["peak_gib"] for b in bf],
                "f32_loss_rel_err": ranks[0]["f32"]["errs"]["loss"],
                "f32_grad_rel_err": ranks[0]["f32"]["errs"]["grad"],
                "flagship_loss_rel_err": ranks[0]["flagship"]["errs"]["loss"],
                "flagship_grad_rel_err": ranks[0]["flagship"]["errs"]["grad"],
                "resume_loss_rel_err": l_err, "cli_ms": tp_ms, "seconds": seconds}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    global SEED
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=SEED,
                        help="seed of every phase's weights, data and noise")
    parser.add_argument("--dp-rank-of", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--tp-rank-of", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    SEED = args.seed
    if args.dp_rank_of:  # a rank that phase 29b launched
        return dp_rank_main(Path(args.dp_rank_of))
    if args.tp_rank_of:  # a rank that phase 30 launched
        return tp_rank_main(Path(args.tp_rank_of))
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this runs on an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    _import_port()
    dev = torch.device("cuda")
    device = phase_device()
    phase_build()
    k1 = phase_flash(dev)
    k2 = phase_lfq(dev)
    k7 = phase_maskgit(dev)
    phase_compact_parity(dev)
    rollout = phase_full_width(dev)
    k1_times, k3, k4 = phase_flash_bwd(dev)
    k1.update(k1_times)
    phase_compact_train(dev)
    train, train_shapes = phase_train_full_width(dev)
    k5, k6 = phase_lfq_entropy(dev)
    phase_compact_tokenizer_train(dev)
    tok_train, tok_shapes, tok_times = phase_tokenizer_train_full_width(dev)
    phase_backward_shapes(dev, {"train_step": train_shapes, "tokenizer_train": tok_shapes})
    phase_compact_serve(dev)
    serve = phase_serve_full_width(dev, device["smi"])
    stage1 = phase_stage1(dev, device["smi"])
    stage23 = phase_stage2_3(dev, device["smi"])
    full = phase_rollout_full(dev, device["smi"])
    stage = {"stage1_train": stage1, "stage1_eval": stage1["eval"],
             "action_train": stage23["action"],
             "tokenize_with_actions": stage23["tokenize_with_actions"],
             "dynamics_train": stage23["dynamics"], "generate": stage23["generate"],
             "eval_dynamics": stage23["eval_dynamics"], "rollout_full": full}
    shape_rows = phase_stage_shapes(dev, {path: stage[path]["shapes"] for path in STAGE_PATHS})
    (HERE / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_trainer_", dir=HERE / "build"))
    try:
        trainer = {"tokenizer": phase_trainer_tokenizer(dev, device["smi"], stage1["ms"], work),
                   "dynamics": phase_trainer_dynamics(dev, device["smi"], work),
                   "r05b": phase_trainer_r05b(dev, device["smi"], work)}
        # Phases 23 to 26 read the checkpoints and shards of 20 to 22.
        gvid = phase_gvid(dev, device["smi"], work)
        eval_tok = phase_eval_tokenizer(dev, device["smi"], work)
        gen, genie_cfg = phase_generate_play(dev, device["smi"], work, train)
        evals = phase_eval_genie_dynamics(dev, device["smi"], work, genie_cfg)
        # Phases 31 and 33 read phase 22's checkpoint.
        trainer["r05b_genie"] = phase_trainer_r05b_genie(dev, device["smi"], work)
        for name in ("r05b_genie", "r05b_genie_resumed", "tokenizer", "dynamics"):
            shutil.rmtree(work / name, ignore_errors=True)
        trainer["r05"] = phase_trainer_r05b(dev, device["smi"], work, "r05_tokenizer.yaml",
                                            R05_OVERRIDES, "r05")
        shutil.rmtree(work / "r05", ignore_errors=True)
        trainer["import"] = phase_import_ckpt(dev, device["smi"], work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    vdisc = phase_video_disc(dev, device["smi"], tok_times["ms"])
    alt = phase_alt_resamplers(dev, device["smi"])
    dp = {**phase_dp_world1(dev, device["smi"]), "dp_trainer": phase_dp_two_ranks(
        dev, device["smi"])}
    tp = phase_tp_two_ranks(dev, device["smi"])
    module_paths = {"video_disc_train": vdisc, **{
        path: {"launches": alt["launches"][path], "shapes": alt["shapes"].get(path)}
        for path in MODULE_PATHS if path != "video_disc_train"}}
    shape_rows += phase_stage_shapes(
        dev, {path: module_paths[path]["shapes"] or {name: {} for name in _FLASH}
              for path in MODULE_PATHS}, MODULE_PATHS, "module shapes")
    # Phase 30's halved-head shapes; the dynamics' spatial (256, 256, 64),
    # timed before for `generate`'s forward only, is trained here.
    shape_rows += phase_stage_shapes(dev, {"tp_train_step": tp["shapes"]}, ("tp_train_step",),
                                     "tp shapes", extra=[(256, 256, 64, False)])
    cli_paths = {"gvid_train": gvid["launches"], "eval_tokenizer": eval_tok["launches"],
                 "generate_cli": gen["launches"], "play": gen["play"]["per_step"],
                 "eval_genie": evals["eval_genie"]["launches"],
                 "eval_dynamics_cli": evals["eval_dynamics_cli"]["launches"]}
    k7["launches_by_shape"] = phase_maskgit_seen(dev)
    kernels = [k1, k2, k3, k4, k5, k6, k7]
    for k in kernels:
        name = k["name"]
        # Phases 31 to 33 first: one step of `cli train genie` on
        # r05b_genie.yaml, of `cli train tokenizer` on r05_tokenizer.yaml and
        # of the run resumed from `cli import-ckpt`. Then the CLI's paths of
        # phases 23 to 26 (one gvid-fed train step, one
        # evaluated batch, one `generate` call, one `play` step, one `eval
        # genie` and one `eval dynamics` call), then the trainer's: one step
        # of `cli train tokenizer` on tokenize.yaml, one clip of `cli
        # tokenize-data`, one step of `cli train dynamics` and of `cli train
        # tokenizer` on r05b. First phase 29's: one distributed MAGVIT2 and
        # Genie step on one NCCL rank, one step of rank 0 of `cli train
        # tokenizer` on two ranks, and rank 0's half of the split K5/K6.
        # Before them phase 30's: one bf16 Genie step of rank 0 of two
        # model ranks.
        by_path = {"trainer_r05b_genie": trainer["r05b_genie"]["launches"][name],
                   "trainer_r05": trainer["r05"]["launches"][name],
                   "import_resume": trainer["import"]["launches"][name],
                   "tp_train_step": tp["launches"][name],
                   "dp_tokenizer_train": dp["dp_tokenizer_train"]["launches"][name],
                   "dp_train_step": dp["dp_train_step"]["launches"][name],
                   "dp_trainer_rank0": dp["dp_trainer"]["launches"][name],
                   "dp_lfq_split_rank0": dp["dp_trainer"]["split_launches"][name],
                   **{path: module_paths[path]["launches"][name] for path in
                      ("video_disc_train", "alt_train", "alt_tokenize", "alt_stream",
                       "alt_decode")},
                   **{path: c[name] for path, c in cli_paths.items()},
                   "trainer": trainer["tokenizer"]["launches"][name],
                   "tokenize_data": trainer["dynamics"]["tokenize_data"]["launches"][name],
                   "trainer_dynamics": trainer["dynamics"]["launches"][name],
                   "trainer_r05b": trainer["r05b"]["launches"][name],
                   **{path: stage[path]["launches"][name] for path in STAGE_PATHS},
                   "serve": serve["launches"][name], "tokenizer_train": tok_train[name],
                   "train_step": train.get(name, 0), "rollout": rollout.get(name, 0)}
        # The newest path that runs the kernel, in the order above: phase
        # 31's r05b Genie step for K1 to K4, the distributed MAGVIT2 step
        # for K5 and K6, the CLI's `generate` for K7 (a call; `play` a step).
        k["launches"] = next((c for c in by_path.values() if c > 0), 0)
        k["launches_by_path"] = by_path
        k["serve_launches"] = {"per_reset": serve["per_reset"][name],
                               "per_step": serve["per_step"][name],
                               "at_rebase": serve["at_rebase"][name]}
        label = {"flash_attention_fwd": "K1", "flash_attention_bwd_dkv": "K3",
                 "flash_attention_bwd_dq": "K4"}.get(name)
        if label:
            k["stage_shapes"] = [{"shape": r["shape"], **r[label],
                                  "launches_by_path": {p: c[_FLASH.index(name)]
                                                       for p, c in r["launches"].items()}}
                                 for r in shape_rows if label in r]
        missing = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                   "plain_ms", "bound_ms", "bound_by", "library_ms", "variant"} - set(k)
        assert not missing, f"{k['name']} lacks {missing}"
    stages = {path: {key: v for key, v in stage[path].items()
                     if key in ("ms", "warmup_ms", "peak_gib", "frames_per_s", "scores",
                                "equal_to_cached", "cached_ms")}
              for path in STAGE_PATHS}
    trainer_times = {
        kind: {key: v for key, v in out.items() if key not in ("launches", "shapes")}
        for kind, out in trainer.items()}
    cli_times = {"gvid": {k: v for k, v in gvid.items() if k != "launches"},
                 "eval_tokenizer": {k: v for k, v in eval_tok.items() if k != "launches"},
                 "generate": {k: v for k, v in gen.items() if k not in ("launches", "play")},
                 "play": {k: gen["play"][k] for k in ("p50_ms", "p95_ms", "reset_ms")},
                 **{path: {"ms": evals[path]["ms"]} for path in evals}}
    modules = {"video_disc_train": {k: v for k, v in vdisc.items()
                                    if k not in ("launches", "shapes")},
               "alt": {k: v for k, v in alt.items() if k not in ("launches", "shapes")}}
    dp_times = {path: {k: v for k, v in out.items() if k not in ("launches", "split_launches")}
                for path, out in dp.items()}
    tp_times = {k: v for k, v in tp.items() if k not in ("launches", "shapes")}
    print(json.dumps({"kernels": kernels, "serve": serve["times"], "stages": stages,
                      "trainer": trainer_times, "cli": cli_times, "modules": modules,
                      "dp": dp_times, "tp": tp_times}))
    print(json.dumps({"ok": True, "device": {k: device[k] for k in ("platform", "kind", "count")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
