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
  5. the compact rollout model on the card against the same model on the
     CPU (plain twins there), same weights and Gumbel noise, f32;
  6. the full-width rollout (`genie_rollout_config()`, bf16, 64x64 prompt,
     4 frames at 25 MaskGIT steps): output checks, the kernels' launch
     counts on that run (every K1 on the tensor cores, at the shapes that
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
     18)), per step and at a rebase; the tokens against `rollout_tokens`
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
     plain twins (`FLASH_BF16_CASES`).
Every line of a time or a memory size in phases 16 to 18 carries the
card's name and power limit. The line before the last is a JSON summary
of the kernels (`launches` on one step or call of the newest path that
runs each, and the counts by path; the variant, and the kernel's, the
plain twin's and the library call's ms beside the bound at one shape of
the paths, and for K1, K3 and K4 the shapes of phase 19), the session's
times and each stage path's; the last line is `{"ok": true, "device":
{...}}`. Without a CUDA device it exits 1 at once.
"""
from __future__ import annotations

import argparse
import copy
import functools
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

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
}
# The paths this checkout added last (phases 16 to 18): their new shapes are
# timed in phase 19.
STAGE_PATHS = ("stage1_train", "stage1_eval", "action_train", "tokenize_with_actions",
               "dynamics_train", "generate", "eval_dynamics", "rollout_full")
# (N, C, d) of K2 on the paths: the rollout's prompt frame (256 tokens of a
# 128-wide tokenizer), the Genie step's frozen tokenizer (4 x 16 frames of
# 16x16 tokens, 64 wide), both with 10 bits, and the session's prompt (one
# 8x8 token frame of the 512-wide MAGVIT2 encoder, 18 bits); all in bf16.
LFQ_HEAD_PATH_SHAPES = [(256, 128, 10), (16384, 64, 10), (64, 512, 18)]
# (N, C, d, offset of x in elements) at which phase 4 and the card tests hold
# K2 to its plain twin: the paths' calls, the tokenizer's 18-bit codebook, the
# instance for any d up to 31, C no multiple of the 16-byte vector, one token
# of one bit, and x at a 2-element offset (not 16-byte aligned).
LFQ_HEAD_CASES = [(n, c, d, 0) for n, c, d in LFQ_HEAD_PATH_SHAPES] + [
    (4096, 512, 18, 0), (4099, 512, 31, 0), (33, 37, 7, 0), (7, 3, 31, 0), (1, 8, 1, 0),
    (256, 128, 10, 2), (33, 64, 18, 2),
]
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
    from open_genie_tpu_torch.utils import init_weights

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(SEED + 2)
    cpu = init_weights(Genie(**genie_compact_config()), g).eval()
    gpu = copy.deepcopy(cpu).to(dev)
    b, frames, steps = 2, 3, 8
    prompt = torch.rand(b, 1, 32, 32, 3, generator=g)
    actions = torch.randint(0, gpu.act_vocab, (b, 1 + frames), generator=g)
    gumbel = gumbel_noise((frames, steps, b, 64, 2 ** 8), g)

    tok_cpu = cpu.generate_tokens(prompt, actions, frames, steps, gumbel=gumbel)
    pix_cpu = cpu.tokenizer.decode_tokens(tok_cpu)
    k1, k2 = flash_attention.launches, lfq_head.launches
    tok_gpu = gpu.generate_tokens(prompt.to(dev), actions.to(dev), frames, steps,
                                  gumbel=gumbel.to(dev))
    pix_gpu = gpu.tokenizer.decode_tokens(tok_gpu).cpu()
    launched = (flash_attention.launches - k1, lfq_head.launches - k2)
    same = torch.equal(tok_gpu.cpu(), tok_cpu)
    err = (pix_gpu - pix_cpu).abs().max().item()
    print(f"[compact] tokens {tuple(tok_gpu.shape)} equal CUDA vs CPU: {same}; "
          f"pixels max |d| {err:.3g}; launches K1 {launched[0]}, K2 {launched[1]}")
    assert same, "CUDA rollout tokens differ from the CPU plain rollout"
    torch.testing.assert_close(pix_gpu, pix_cpu, **PIX_TOL)
    assert launched[0] > 0 and launched[1] == 1


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
    print(f"[full] video {tuple(video.shape)} {video.dtype}; launches "
          f"K1 {launches['flash_attention_fwd']} (expected {expect_k1} = "
          f"{n_tok_attn} tokenizer + {n_layers} x (1 + {frames} x {spf + 1})), "
          f"K2 {launches['lfq_head']}")
    assert tuple(video.shape) == (1, 1 + frames, 64, 64, 3)
    assert torch.isfinite(video.float()).all(), "non-finite pixels"
    assert launches["flash_attention_fwd"] == expect_k1 == 638
    assert launches["lfq_head"] == 1
    assert launches["flash_attention_bwd_dkv"] == launches["flash_attention_bwd_dq"] == 0

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

    return {"flash_attention_fwd": flash_attention, "lfq_head": lfq_head,
            "flash_attention_bwd_dkv": flash_attention_bwd_dkv,
            "flash_attention_bwd_dq": flash_attention_bwd_dq,
            "lfq_entropy_fwd": lfq_avg_probs, "lfq_entropy_bwd": lfq_entropy_grad}


def _reset_counts() -> None:
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
              "lfq_entropy_fwd": 0, "lfq_entropy_bwd": 0}  # codebooks of <= 4096 codes
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


def phase_compact_tokenizer_train(dev):
    """One compact tokenizer training step on the card (K1, K3, K4 in the
    discriminator, K5/K6 for the 13-bit codebook's entropy) against the
    same step on the CPU (plain twins): same weights, video and frame
    indices, f32 with TF32 off. Loss, every gradient, the parameters after
    AdamW."""
    from open_genie_tpu_torch.models.configs import tokenizer_compact_train_config
    from open_genie_tpu_torch.train.losses import TokenizerTrainModule, frozen_param_mask
    from open_genie_tpu_torch.train.loop import make_optimizer
    from open_genie_tpu_torch.utils import init_weights, random_frame_idxs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True  # the GAN's two D passes cancel exactly
    g = torch.Generator().manual_seed(SEED + 11)
    cfg = tokenizer_compact_train_config()
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
    print(f"[compact tokenizer] loss CUDA {l_gpu:.6f} vs CPU {l_cpu:.6f}; max |d grad| "
          f"{g_err:.3g} over {len(g_gpu)} gradients; max |d param| after AdamW {p_err:.3g}; "
          f"launches {counts}")
    assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu), "compact tokenizer loss differs"
    for n in g_cpu:
        torch.testing.assert_close(g_gpu[n], g_cpu[n], **PIX_TOL, msg=lambda m, n=n: f"{n}: {m}")
    assert p_err <= 2.1e-4, "parameters after the step differ"
    assert all(counts[k] > 0 for k in ("flash_attention_fwd", "flash_attention_bwd_dkv",
                                       "flash_attention_bwd_dq", "lfq_entropy_fwd",
                                       "lfq_entropy_bwd"))


def phase_tokenizer_train_full_width(dev) -> dict:
    """`tokenizer_train_config()` (the JAX benchmark's MAGVIT2 d=18
    full-loss step) at batch 4 x 8 frames x 64x64, bf16 compute on f32
    master weights, the benchmark's AdamW defaults, the VGG frozen; three
    steps through `make_train_step`."""
    from open_genie_tpu_torch.models.configs import tokenizer_train_config
    from open_genie_tpu_torch.modules.attention import Attention
    from open_genie_tpu_torch.modules.quantization import LookupFreeQuantization
    from open_genie_tpu_torch.train.losses import TokenizerTrainModule, frozen_param_mask
    from open_genie_tpu_torch.train.loop import make_optimizer, make_train_step
    from open_genie_tpu_torch.utils import init_weights

    torch.backends.cudnn.deterministic = True
    g = torch.Generator().manual_seed(SEED + 12)
    module = init_weights(TokenizerTrainModule(**tokenizer_train_config()), g).to(dev)
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
              "lfq_entropy_fwd": n_lfq, "lfq_entropy_bwd": n_lfq}
    print(f"[tokenizer train] {sum(p.numel() for p in module.parameters()) / 1e6:.1f}M "
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
        variants = _assert_path_kernels("tokenizer train", "tokenizer_train", show=i == 0)
        assert all(variants[name]["mma"] == counts[name] for name in _FLASH)
        loss, norm = metrics["loss"].item(), metrics["grad_norm"].item()
        assert math.isfinite(loss) and math.isfinite(norm), "non-finite loss or grad_norm"
        assert all(math.isfinite(metrics[k].item()) for k in terms), "a non-finite loss term"
        assert counts == expect, f"launches {counts}, expected {expect}"
        if i >= 3:
            continue
        parts = ", ".join(f"{k} {metrics[k].item():.4f}" for k in terms)
        print(f"[tokenizer train] step {i}: loss {loss:.4f} ({parts}), grad_norm {norm:.4f}, "
              f"{times[-1] * 1e3:.1f} ms, launches {counts}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    # The hinge loss gives D's output bias the gradient (#fake scores above
    # -1 - #real scores below 1) / N: exactly zero while every score lies
    # inside the margin, as from a random init.
    head_bias = "gan_crit.disc.head.bias"
    trainable = [n for n in frozen if frozen[n]]
    zero = [n for n in trainable if nonzero.get(n, 0) == 0]
    n_disc = sum(n.startswith("gan_crit.") for n in trainable)
    print(f"[tokenizer train] nonzero gradient in steps 0-2 on {len(trainable) - len(zero)}/"
          f"{len(trainable)} trainable parameters ({n_disc} of them the discriminator's); "
          f"{head_bias}: {nonzero.get(head_bias, 0)} nonzero entries")
    assert not set(zero) - {head_bias}, f"no gradient reached {zero}"
    assert all(torch.equal(p, vgg_before[n]) for n, p in module.perc_crit.named_parameters()), (
        "a frozen VGG parameter changed")
    timed = sorted(t * 1e3 for t in times[3:])
    ms = statistics.median(timed)
    frames = video.shape[0] * video.shape[1]
    print(f"[tokenizer train] VGG parameters bit-unchanged after {len(times)} steps; "
          f"{ms:.1f} ms per step, {frames / ms * 1e3:.1f} frames/s (median of steps 3-"
          f"{len(times) - 1}, min {timed[0]:.1f}, max {timed[-1]:.1f}; step 0 "
          f"{times[0] * 1e3:.1f} ms); peak memory {peak:.2f} GiB")
    _profile_step("tokenizer train", lambda: step(video, generator=gen), ms)
    return counts, shapes


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
        runs[name] = (sess.tokens, first, torch.stack(frames, 1), _read_counts(), sess._rebases)
    (tok_c, first_c, pix_c, _, _), (tok_g, first_g, pix_g, launched, rebases) = runs.values()
    same = torch.equal(tok_g, tok_c)
    err = max((first_g - first_c).abs().max().item(), (pix_g - pix_c).abs().max().item())
    print(f"[compact serve] tokens {tuple(tok_g.shape)} equal CUDA vs CPU: {same}; pixels "
          f"max |d| {err:.3g}; rebases {rebases}; launches K1 "
          f"{launched['flash_attention_fwd']}, K2 {launched['lfq_head']}")
    assert same, "CUDA session tokens differ from the CPU session's"
    torch.testing.assert_close(first_g, first_c, **PIX_TOL)
    torch.testing.assert_close(pix_g, pix_c, **PIX_TOL)
    assert rebases == 1 and launched["flash_attention_fwd"] > 0 and launched["lfq_head"] == 1


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
    print(f"[{label}] {smi}: {ms:.1f} ms, peak memory {peak:.2f} GiB; launches {counts}; "
          f"K1 by (B*H, N, D, causal) {shapes['flash_attention_fwd']}")
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
              "lfq_entropy_fwd": 0, "lfq_entropy_bwd": 0}
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
         "lfq_entropy_bwd": 0}, smi)
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
    none = {"flash_attention_fwd": 0, "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq": 0,
            "lfq_head": 0, "lfq_entropy_fwd": 0, "lfq_entropy_bwd": 0}
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
        {**none, "flash_attention_fwd": n_layers * (hist + steps)}, smi)
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
         "lfq_entropy_bwd": 0}, smi)
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


def phase_stage_shapes(dev, launches: dict) -> list:
    """K1, and K3 and K4 where a training path of phases 16 to 18 launched
    them, in bf16 at every shape that those paths brought and no earlier
    path has, as CUDA graphs: beside PyTorch's flash forward (SDPA) and
    aten's flash backward, the plain twins where one call holds at most
    2^27 logits, the bounds and each path's launches of the shape
    (`launches`: path -> kernel -> shape -> count, one step or one call)."""
    from open_genie_tpu_torch.ops.kernels.flash_attention import (
        flash_attention,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_bwd_plain,
        flash_attention_plain,
    )

    older = {c for path, cases in PATH_CASES.items() if path not in STAGE_PATHS for c in cases}
    new = sorted({c for path in STAGE_PATHS for c in PATH_CASES[path]} - older)
    g = torch.Generator(device=dev).manual_seed(SEED + 22)
    rows = []
    for case in new:
        bh, n, d, causal = case
        per_path = {path: [launches[path][name].get(case, 0) for name in _FLASH]
                    for path in STAGE_PATHS if case in PATH_CASES[path]}
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
        print(f"[stage shapes] bf16 (BH,N,D,causal)={case}, CUDA graphs: {text}; launches "
              f"(K1, K3, K4) per step or call {per_path}")
        rows.append(row)
        del q, k, v, do, o, lse, fns
    return rows


def main() -> int:
    global SEED
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=SEED,
                        help="seed of every phase's weights, data and noise")
    SEED = parser.parse_args().seed
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
    phase_compact_parity(dev)
    rollout = phase_full_width(dev)
    k1_times, k3, k4 = phase_flash_bwd(dev)
    k1.update(k1_times)
    phase_compact_train(dev)
    train, train_shapes = phase_train_full_width(dev)
    k5, k6 = phase_lfq_entropy(dev)
    phase_compact_tokenizer_train(dev)
    tok_train, tok_shapes = phase_tokenizer_train_full_width(dev)
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
    kernels = [k1, k2, k3, k4, k5, k6]
    for k in kernels:
        name = k["name"]
        by_path = {**{path: stage[path]["launches"][name] for path in STAGE_PATHS},
                   "serve": serve["launches"][name], "tokenizer_train": tok_train[name],
                   "train_step": train.get(name, 0), "rollout": rollout.get(name, 0)}
        # The newest path that runs the kernel, in the order above: one
        # stage-1 training step (tokenize.yaml) for K1, K3 and K4, the
        # stage-2 tokenize_with_actions of 32 clips for K2, one MAGVIT2
        # tokenizer training step for K5 and K6.
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
    print(json.dumps({"kernels": kernels, "serve": serve["times"], "stages": stages}))
    print(json.dumps({"ok": True, "device": {k: device[k] for k in ("platform", "kind", "count")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
