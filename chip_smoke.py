#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`open_genie_tpu_torch/`) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a Hopper card:

    python3 chip_smoke.py

Phases, in order (any failure raises and the exit code is non-zero):
  1. device: the card's name and power limit;
  2. build: the CUDA kernels from `open_genie_tpu_torch/csrc/`;
  3. kernel K1 (flash-attention forward) against its plain PyTorch twin at
     the rollout's shapes and at ragged edges, f32 (TF32 off) and bf16,
     and both times at the rollout's shapes;
  4. kernel K2 (fused LFQ head) against its plain twin, and both times;
  5. the compact rollout model on the card against the same model on the
     CPU (plain twins there), same weights and Gumbel noise, f32;
  6. the full-width rollout (`genie_rollout_config()`, bf16, 64x64 prompt,
     4 frames at 25 MaskGIT steps): output checks, the kernels' launch
     counts on that run, determinism, and the time per generated frame;
  7. kernels K3 and K4 (flash-attention backward) against the plain
     backward at the training step's shapes and at ragged edges, f32 (TF32
     off) and bf16, determinism, and both times;
  8. one compact Genie training step on the card against the same step on
     the CPU (plain twins there): loss, every gradient, and the parameters
     after AdamW, f32;
  9. three full-width Genie training steps (`genie_train_config()`, batch
     4 x 16 frames x 64x64, bf16 compute on f32 weights): finite loss and
     grad norm, a gradient on every trainable parameter, the tokenizer
     unchanged, the kernels' launch counts per step, ms per step and peak
     memory.
The line before the last is a JSON summary of the kernels (launches on one
training step, and by path); the last line is `{"ok": true, "device":
{...}}`. Without a CUDA device it exits 1 at once.
"""
from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
SEED = 0
K1_TOL_F32, K1_TOL_BF16 = 1e-5, 2e-2  # same f32 math reordered; bf16 rounding
# K3/K4 against the plain backward on the same inputs: in f32 the same math
# summed in another order over up to 4096 terms; in bf16 the plain twin
# rounds p and ds where the kernels do, so what is left is a flip of the
# last bf16 bit of a rounded term or of the output.
K3K4_TOL_F32 = dict(atol=1e-4, rtol=1e-5)
K3K4_TOL_BF16 = dict(atol=2e-2, rtol=2e-2)
LFQ_UNDECIDED = 1e-5  # |z| below this is a sign decided by rounding
PIX_TOL = dict(atol=2e-3, rtol=2e-2)  # the repo's parity bound for stacks


def _import_port():
    sys.path.insert(0, str(HERE))
    import open_genie_tpu_torch

    pkg_dir = Path(open_genie_tpu_torch.__file__).resolve().parent
    if pkg_dir.parent != HERE:
        raise RuntimeError(f"open_genie_tpu_torch imported from {pkg_dir}, not this checkout")


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of `fn` in ms, by CUDA events over `iters` calls."""
    for _ in range(warmup):
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


def in_turns(plain, kernel) -> tuple:
    """Times of the plain version and the kernel, run plain, kernel,
    kernel, plain; each the mean of its two runs."""
    p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel), cuda_ms(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    print(f"[device] {name}, capability {torch.cuda.get_device_capability(0)}, "
          f"torch {torch.__version__}, cuda {torch.version.cuda}")
    return {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}


def phase_build():
    from open_genie_tpu_torch.ops import kernels

    kernels.library()
    b = kernels.BUILD
    verb = f"built in {b['seconds']:.1f} s" if b["built"] else "reused"
    print(f"[build] {verb}: {b['path'].relative_to(HERE)} from "
          f"{[str(s.relative_to(HERE)) for s in kernels.sources()]}")
    for line in b["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")


def phase_flash(dev) -> dict:
    from open_genie_tpu_torch.ops.kernels.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(SEED)
    cases = [(8, 256, 16, False), (8, 256, 64, False), (2048, 5, 16, True),
             (2048, 17, 16, True), (4, 1000, 64, False), (4, 1000, 64, True)]
    err_f32 = 0.0
    for bh, n, d, causal in cases:
        q, k, v = (torch.randn(bh, n, d, generator=g, device=dev) for _ in range(3))
        o, lse = flash_attention(q, k, v, d ** -0.5, causal)
        o_ref, lse_ref = flash_attention_plain(q, k, v, d ** -0.5, causal)
        e_o = (o - o_ref).abs().max().item()
        e_lse = (lse - lse_ref).abs().max().item()
        # bf16: against the f32 result on the same bf16-rounded inputs, so
        # the error is the kernel's own rounding of p and of o.
        qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
        ob, _ = flash_attention(qb, kb, vb, d ** -0.5, causal)
        ob_ref, _ = flash_attention_plain(qb.float(), kb.float(), vb.float(), d ** -0.5, causal)
        e_b = (ob.float() - ob_ref).abs().max().item()
        torch.cuda.synchronize()
        print(f"[K1] (BH,N,D)=({bh},{n},{d}) causal={causal}: f32 |do|={e_o:.3g} "
              f"|dlse|={e_lse:.3g}, bf16 |do|={e_b:.3g}")
        assert e_o <= K1_TOL_F32 and e_lse <= K1_TOL_F32, "K1 f32 disagrees"
        assert e_b <= K1_TOL_BF16, "K1 bf16 disagrees"
        err_f32 = max(err_f32, e_o, e_lse)

    # The full-width rollout's calls, in its bf16: dynamics spatial (1 frame
    # x 8 heads, 256 tokens, d 64); tokenizer spatial (1 prompt frame or 5
    # decoded frames x 8 heads, d 16); decoder temporal (256 tubes x 8
    # heads, 5 frames, causal).
    timed = {}
    for bh, n, d, causal in [(8, 256, 64, False), (8, 256, 16, False),
                             (40, 256, 16, False), (2048, 5, 16, True)]:
        q, k, v = (torch.randn(bh, n, d, generator=g, device=dev, dtype=torch.bfloat16)
                   for _ in range(3))
        ms, plain_ms = in_turns(
            lambda: flash_attention_plain(q, k, v, d ** -0.5, causal),
            lambda: flash_attention(q, k, v, d ** -0.5, causal),
        )
        timed[(bh, n, d, causal)] = (ms, plain_ms)
        print(f"[K1 time] bf16 (BH,N,D)=({bh},{n},{d}) causal={causal}: "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    ms, plain_ms = timed[(8, 256, 64, False)]
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "open_genie_tpu_torch/csrc/flash_attention.cu",
            "replaces": "open_genie_tpu/ops/pallas/flash_attention.py:46",
            "max_abs_err": err_f32, "ms": ms, "plain_ms": plain_ms}


def phase_lfq(dev) -> dict:
    from open_genie_tpu_torch.ops.kernels.lfq_head import lfq_head, lfq_head_plain

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    err = 0.0
    for n, c, d in [(256, 128, 10), (4096, 512, 18)]:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(n, c, generator=g, device=dev).to(dtype)
            w = torch.randn(c, d, generator=g, device=dev) * c ** -0.5
            b = torch.randn(d, generator=g, device=dev) * 0.1
            codes, idx = lfq_head(x, w, b)
            codes_ref, idx_ref = lfq_head_plain(x, w, b)
            decided = (x.float() @ w + b).abs() >= LFQ_UNDECIDED
            rows = decided.all(dim=1)
            e = (codes.float() - codes_ref.float())[decided].abs().max().item()
            same_idx = torch.equal(idx[rows], idx_ref[rows])
            torch.cuda.synchronize()
            print(f"[K2] (N,C,d)=({n},{c},{d}) {dtype}: |dcodes|={e:.3g} on "
                  f"{int(decided.sum())}/{decided.numel()} decided codes, "
                  f"idx equal on {int(rows.sum())}/{n} decided rows: {same_idx}")
            assert e == 0.0 and same_idx, "K2 disagrees with its plain twin"
            err = max(err, e)
    # The full-width rollout's call: one 64x64 prompt frame -> 256 tokens.
    x = torch.randn(256, 128, generator=g, device=dev, dtype=torch.bfloat16)
    w = torch.randn(128, 10, generator=g, device=dev, dtype=torch.bfloat16)
    b = torch.zeros(10, device=dev, dtype=torch.bfloat16)
    ms, plain_ms = in_turns(lambda: lfq_head_plain(x, w, b), lambda: lfq_head(x, w, b))
    print(f"[K2 time] bf16 (N,C,d)=(256,128,10): kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms")
    return {"name": "lfq_head", "route": "cuda",
            "source": "open_genie_tpu_torch/csrc/lfq_head.cu",
            "replaces": "open_genie_tpu/ops/pallas/lfq_head.py:37",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_flash_bwd(dev) -> tuple:
    """K3 and K4 against the plain backward on the same inputs and the
    same saved forward, at every attention shape of the training step."""
    from open_genie_tpu_torch.ops.kernels.flash_attention import (
        flash_attention,
        flash_attention_bwd,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_bwd_plain,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(SEED + 5)

    def inputs(bh, n, d, causal, dtype):
        q, k, v, do = (torch.randn(bh, n, d, generator=g, device=dev).to(dtype)
                       for _ in range(4))
        o, lse = flash_attention(q, k, v, d ** -0.5, causal)
        return q, k, v, o, lse, do

    # The training step's calls (B*H, N, D): latent-action spatial at 64x64
    # and 32x32 (on a slice of B*H: the plain twin's logits at the full 256
    # would take 17 GB each), its temporal self- and cross-attention (causal),
    # the dynamics' spatial and temporal calls; then ragged N.
    cases = [(8, 4096, 16, False), (64, 1024, 16, False), (65536, 16, 16, True),
             (16384, 16, 16, True), (512, 256, 64, False), (8192, 16, 64, True),
             (4, 1000, 64, False), (4, 1000, 64, True), (2048, 17, 16, True),
             (8, 17, 16, False)]
    err_f32 = 0.0
    for bh, n, d, causal in cases:
        errs = {}
        for dtype, tol in ((torch.float32, K3K4_TOL_F32), (torch.bfloat16, K3K4_TOL_BF16)):
            q, k, v, o, lse, do = inputs(bh, n, d, causal, dtype)
            got = flash_attention_bwd(q, k, v, o, lse, do, d ** -0.5, causal)
            ref = flash_attention_bwd_plain(q, k, v, o, lse, do, d ** -0.5, causal)
            torch.cuda.synchronize()
            errs[dtype] = [(a.float() - b.float()).abs().max().item() for a, b in zip(got, ref)]
            ref_max = max(b.float().abs().max().item() for b in ref)
            for a, b, name in zip(got, ref, ("dq", "dk", "dv")):
                torch.testing.assert_close(
                    a.float(), b.float(), **tol,
                    msg=lambda m, name=name: f"K3/K4 {name} {(bh, n, d, causal)} {dtype}: {m}",
                )
        err_f32 = max(err_f32, *errs[torch.float32])
        print(f"[K3/K4] (BH,N,D)=({bh},{n},{d}) causal={causal}: max |d(dq,dk,dv)| "
              f"f32 {[f'{e:.3g}' for e in errs[torch.float32]]}, bf16 "
              f"{[f'{e:.3g}' for e in errs[torch.bfloat16]]} (max |ref| bf16 {ref_max:.3g})")

    q, k, v, o, lse, do = inputs(8, 4096, 16, False, torch.bfloat16)
    first = flash_attention_bwd(q, k, v, o, lse, do, 0.25, False)
    again = flash_attention_bwd(q, k, v, o, lse, do, 0.25, False)
    assert all(torch.equal(a, b) for a, b in zip(first, again)), "K3/K4 not deterministic"
    print("[K3/K4] two calls at (8,4096,16) bf16: bit-identical dq, dk, dv")

    timed = {}
    for bh, n, d, causal in [(512, 256, 64, False), (8, 4096, 16, False)]:
        q, k, v, o, lse, do = inputs(bh, n, d, causal, torch.bfloat16)
        delta = (do.float() * o.float()).sum(-1)
        s = d ** -0.5
        plain = lambda: flash_attention_bwd_plain(q, k, v, o, lse, do, s, causal)  # noqa: E731
        k3_ms, plain_ms = in_turns(
            plain, lambda: flash_attention_bwd_dkv(q, k, v, do, lse, delta, s, causal))
        k4_ms, plain_ms2 = in_turns(
            plain, lambda: flash_attention_bwd_dq(q, k, v, do, lse, delta, s, causal))
        timed[(bh, n, d)] = (k3_ms, k4_ms, (plain_ms + plain_ms2) / 2)
        print(f"[K3/K4 time] bf16 (BH,N,D)=({bh},{n},{d}): K3 {k3_ms:.4f} ms, "
              f"K4 {k4_ms:.4f} ms, plain backward (dq, dk, dv together) "
              f"{timed[(bh, n, d)][2]:.4f} ms")
    # The full latent-action call, kernels alone (the plain twin needs
    # several 17 GB matrices there).
    q, k, v, o, lse, do = inputs(256, 4096, 16, False, torch.bfloat16)
    delta = (do.float() * o.float()).sum(-1)
    full = (cuda_ms(lambda: flash_attention(q, k, v, 0.25), iters=5, warmup=1),
            cuda_ms(lambda: flash_attention_bwd_dkv(q, k, v, do, lse, delta, 0.25), iters=5, warmup=1),
            cuda_ms(lambda: flash_attention_bwd_dq(q, k, v, do, lse, delta, 0.25), iters=5, warmup=1))
    print(f"[K3/K4 time] bf16 (256,4096,16), kernels alone: K1 {full[0]:.3f} ms, "
          f"K3 {full[1]:.3f} ms, K4 {full[2]:.3f} ms")

    k3_ms, k4_ms, plain_ms = timed[(512, 256, 64)]
    common = {"route": "cuda", "source": "open_genie_tpu_torch/csrc/flash_attention_bwd.cu",
              "max_abs_err": err_f32, "plain_ms": plain_ms,
              "plain_computes": "dq, dk and dv together", "shape": [512, 256, 64]}
    return ({"name": "flash_attention_bwd_dkv", **common, "ms": k3_ms,
             "replaces": "open_genie_tpu/ops/pallas/flash_attention.py:164"},
            {"name": "flash_attention_bwd_dq", **common, "ms": k4_ms,
             "replaces": "open_genie_tpu/ops/pallas/flash_attention.py:237"})


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
    from open_genie_tpu_torch.ops.kernels.lfq_head import lfq_head

    return {"flash_attention_fwd": flash_attention, "lfq_head": lfq_head,
            "flash_attention_bwd_dkv": flash_attention_bwd_dkv,
            "flash_attention_bwd_dq": flash_attention_bwd_dq}


def _reset_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0


def _read_counts() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


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
              "flash_attention_bwd_dq": n_la + n_dyn, "lfq_head": 1}
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
        counts = _read_counts()
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
    return counts


def main() -> int:
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
    k3, k4 = phase_flash_bwd(dev)
    phase_compact_train(dev)
    train = phase_train_full_width(dev)
    kernels = [k1, k2, k3, k4]
    for k in kernels:
        k["launches"] = train[k["name"]]  # this slice's main path: one training step
        k["launches_by_path"] = {"train_step": train[k["name"]],
                                 "rollout": rollout.get(k["name"], 0)}
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
