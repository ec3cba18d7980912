#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`open_genie_tpu_torch/`) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a Hopper card:

    python3 chip_smoke.py

Phases, in order (any failure raises and the exit code is non-zero):
  1. device: the card's name and power limit;
  2. build: both CUDA kernels from `open_genie_tpu_torch/csrc/`;
  3. kernel K1 (flash-attention forward) against its plain PyTorch twin at
     the rollout's shapes and at ragged edges, f32 (TF32 off) and bf16,
     and both times at the rollout's shapes;
  4. kernel K2 (fused LFQ head) against its plain twin, and both times;
  5. the compact rollout model on the card against the same model on the
     CPU (plain twins there), same weights and Gumbel noise, f32;
  6. the full-width rollout (`genie_rollout_config()`, bf16, 64x64 prompt,
     4 frames at 25 MaskGIT steps): output checks, the kernels' launch
     counts on that run, determinism, and the time per generated frame.
The line before the last is a JSON summary of the kernels; the last line is
`{"ok": true, "device": {...}}`. Without a CUDA device it exits 1 at once.
"""
from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
SEED = 0
K1_TOL_F32, K1_TOL_BF16 = 1e-5, 2e-2  # same f32 math reordered; bf16 rounding
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
    from open_genie_tpu_torch.ops.kernels.flash_attention import flash_attention
    from open_genie_tpu_torch.ops.kernels.lfq_head import lfq_head
    from open_genie_tpu_torch.utils import init_weights

    torch.backends.cudnn.deterministic = True
    g = torch.Generator().manual_seed(SEED + 3)
    genie = init_weights(Genie(**genie_rollout_config()), g).to(dev, torch.bfloat16).eval()
    frames, spf = 4, 25
    prompt = torch.rand(1, 1, 64, 64, 3, generator=g).to(dev, torch.bfloat16)
    actions = torch.randint(0, genie.act_vocab, (1, 1 + frames), generator=g).to(dev)
    gen = lambda: torch.Generator(device=dev).manual_seed(SEED + 4)  # noqa: E731

    flash_attention.launches = 0
    lfq_head.launches = 0
    video = genie(prompt, actions, frames, spf, generator=gen())
    torch.cuda.synchronize()
    launches = {"flash_attention_fwd": flash_attention.launches,
                "lfq_head": lfq_head.launches}

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
    launches = phase_full_width(dev)
    k1["launches"] = launches["flash_attention_fwd"]
    k2["launches"] = launches["lfq_head"]
    print(json.dumps({"kernels": [k1, k2]}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
