"""Driver `session`: many players in one `InteractiveSession`, closed loop.

Set-up builds the configuration's Genie on the device with the seed's
weights, resets the session from a seeded prompt per player and plays
warm-up steps past one rebase (the first ones at one refinement a frame,
the last ones at the cell's own), so the window meets no shape it has not
run. The window then sends one action per player per step, each step
after the last one's frames are on the host, for the run's seconds.

After the window the program is freed and the plain reference judges a
sample drawn from the seed, on both sides of the window's last rebase:
every served token of every player's frame at those steps, refinement by
refinement (with the same noise: the reference replays the session's
generator, whose seeding and draws are the session's documented
behaviour), the streamed pixels of two players at those steps, and the
prompt's tokens; see `check`.
"""
from __future__ import annotations

import gc
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
from reference import genie_serve as ref  # noqa: E402
import harness  # noqa: E402
import weights  # noqa: E402

REBASE_SEED_STRIDE = 0x9E3779B1  # the session re-seeds s + n * stride at its n-th rebase
UNUSED = ("latent_action.",)     # players give the actions; the latent action never runs


def build_genie(model: dict, seed: int, device, dtype):
    """The program's Genie at the configuration's sizes, built on the meta
    device and filled with the seed's weights (`weights.make`)."""
    from open_genie_tpu_torch.models.genie import Genie

    values = weights.make(ref.param_specs(model), seed, device, dtype)
    with torch.device("meta"):
        genie = Genie(**model)
    genie = genie.to_empty(device=device).to(dtype)
    weights.load_into(genie, values, UNUSED)
    return genie.eval()


class Epochs:
    """Which session epoch, buffer position and noise draws each step has.
    A session rebases onto its last `keep` frames once `max_frames` steps
    have filled its horizon; the tokens are snapshotted just before."""

    def __init__(self, t0: int, keep: int, max_frames: int, actions0: torch.Tensor):
        self.t0, self.keep, self.max_frames = t0, keep, max_frames
        self.epoch, self.j = 0, 0
        self.actions = [actions0[:, i] for i in range(t0)]
        self.snaps = []   # finished epochs, as `record` gives them
        self.steps = []   # per global step: (epoch, j, buffer position)
        self.spfs = []    # per global step: its refinements
        self._first = 0

    def before_step(self, sess) -> None:
        """Snapshot and roll over if this step rebases."""
        if self.j < self.max_frames:
            return
        self.snaps.append(self.record(sess))
        self.actions = self.actions[-self.keep:]
        self.epoch, self.j, self.t0, self._first = self.epoch + 1, 0, self.keep, len(self.steps)

    def after_step(self, action: torch.Tensor, spf: int) -> None:
        self.steps.append((self.epoch, self.j, self.t0 + self.j))
        self.spfs.append(spf)
        self.actions.append(action)
        self.j += 1

    def record(self, sess) -> dict:
        """The epoch so far: its tokens and actions from position 0, its
        first position generated, its first global step and its steps."""
        return {"epoch": self.epoch, "t0": self.t0, "tokens": sess.tokens,
                "actions": torch.stack(self.actions, 1), "first": self._first, "n": self.j,
                "spfs": self.spfs[self._first:]}


def run(cell: dict, config: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        started: float, *, device="cuda", window_steps=None, control: bool = False) -> dict:
    """One run of the cell. `device` and `window_steps` (a window of that
    many steps instead of `seconds`) are for the CPU tests and calibrate.py;
    `control` also judges the float8 control in the program's place."""
    from open_genie_tpu_torch.serve import InteractiveSession

    dev = torch.device(device)
    on_cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    model = config["model"]
    dtype = getattr(torch, config["dtype"])
    b, mf, spf, temp = (traffic[k] for k in ("players", "max_frames", "steps_per_frame", "temp"))
    n_act = 2 ** model["latent_action"]["d_codebook"]
    size, pf = traffic["frame_size"], traffic["prompt_frames"]

    genie = build_genie(model, seed, dev, dtype)
    sess = InteractiveSession(genie, max_frames=mf, steps_per_frame=spf, temp=temp, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    prompt = torch.rand((b, pf, size, size, 3), generator=gen, device=dev).to(dtype)
    table = torch.randint(0, n_act, (traffic["action_table"], b),
                          generator=torch.Generator().manual_seed(seed + 2))
    sess_seed = seed + 3
    sess.reset(prompt, seed=sess_seed)
    tokens0 = sess.tokens
    t0 = tokens0.shape[1]
    ep = Epochs(t0, max(1, (t0 + mf) // 2), mf, torch.zeros(b, t0, dtype=torch.long))
    frames, lat, enq, traced = [], [], [], []
    profiled = []

    def step(timed_enqueue=False):
        act = table[len(ep.steps) % len(table)]
        ep.before_step(sess)
        t = time.perf_counter()
        if timed_enqueue:
            out = sess.step_nosync(act)
            e = time.perf_counter()
            frame = out.cpu()
            enq.append(e - t)
        else:
            frame = sess.step(act)
        lat.append(time.perf_counter() - t)
        frames.append(frame)
        ep.after_step(act, sess.steps_per_frame)

    # Warm-up: the horizon fills at one refinement a frame (the same
    # kernels and shapes, fewer launches), then the cell's own steps run
    # across the rebase.
    for i in range(mf + 1 + traffic["warmup_after_rebase"]):
        sess.steps_per_frame = 1 if i < traffic["warmup_fast_steps"] else spf
        step()
    sess.steps_per_frame = spf
    if trace:  # the profiler's first start (CUPTI) belongs to set-up
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            step()
    sync()
    setup_peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    n_warm = len(ep.steps)
    lat.clear()
    enq.clear()
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    tw = time.perf_counter()
    setup_s = tw - started
    first_traced, n_traced = traffic["trace_steps"]

    def more():
        if window_steps:
            return len(ep.steps) - n_warm < window_steps
        return time.perf_counter() - tw < seconds

    while more():
        i = len(ep.steps) - n_warm
        if trace and i == first_traced:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(n_traced):
                    traced.append(len(ep.steps))
                    step()
            profiled.append(prof)  # read after the window
        else:
            step(timed_enqueue=trace)
    window_s = time.perf_counter() - tw
    window_peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    final = ep.record(sess)
    del sess, genie
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()

    n_win = len(ep.steps) - n_warm
    failed = sum(int((~torch.isfinite(f.float())).flatten(1).any(1).sum())
                 for f in frames[n_warm:])
    out = {
        "attempted": n_win * b,
        "failed": failed,
        "memory_peak_bytes": max(setup_peak, window_peak),
        "e2e": {
            "setup_s": setup_s,
            "frame_ms.p95": harness.percentile(lat, 95) * 1e3 if n_win else None,
            "frames_per_s": b * n_win / window_s,
            "peak_mem_gib": window_peak / 2 ** 30,
        },
        "record": {
            "batch": b, "steps_per_frame": spf, "keep": ep.keep, "model": model,
            "grid": tuple(tokens0.shape[2:]), "window_s": window_s,
            "steps": ep.steps[n_warm:], "latency_s": lat, "enqueue_s": enq,
            "traced": [s - n_warm for s in traced],
            "trace": harness.trace_events(profiled[0]) if profiled else None,
        },
    }
    check_out = check(config, traffic, seed, sess_seed, tokens0, ep.snaps + [final], frames,
                      prompt, dev, control)
    out.update(check_out)
    return out


# --------------------------------------------------------------------------
# The check
# --------------------------------------------------------------------------

def _sample(epochs: list, seed: int, b: int, per_epoch: int):
    """Two players (one of each half) and, of the last two epochs that
    generated frames, `per_epoch` steps each: the last and random ones of
    the earlier, the first and random ones of the later, so both sides of
    a rebase: `(players, {epoch: [j]})`."""
    rng = np.random.default_rng(seed + 4)
    players = [int(rng.integers(0, b // 2)), int(rng.integers(b // 2, b))]
    live = [e for e in epochs if e["n"] > 0][-2:]
    picks = {}
    for k, e in enumerate(live):
        n = e["n"]
        fixed = (n - 1) if (k == 0 and len(live) == 2) else 0
        rest = [int(j) for j in rng.permutation(n) if j != fixed][: per_epoch - 1]
        picks[e["epoch"]] = sorted([fixed] + rest)
    return players, picks


def _draws(sess_seed: int, epoch: dict, js, shape, dev):
    """Yield `(j, [noise])`: the session's draws for every refinement of
    each step `j` in `js` of `epoch`, all players, in bfloat16 (they are
    rounded to it)."""
    g = torch.Generator(device=dev).manual_seed(sess_seed + epoch["epoch"] * REBASE_SEED_STRIDE)
    for j in range(max(js) + 1):
        if j in js:
            yield j, [ref.gumbel(shape, g, dev).to(torch.bfloat16)
                      for _ in range(epoch["spfs"][j])]
        else:  # the same draws, skipped
            for _ in range(epoch["spfs"][j]):
                torch.rand(shape, generator=g, device=dev, dtype=torch.float32)


def judge_frame(f32, past, served, action, noises, temp, grid, near_tie, k=8):
    """Every served token of a frame, refinement by refinement, against the
    float32 reference: `(readings, refinement)`, both `(B, h * w)`.

    At refinement `s` the program gives each masked position its best
    token under `logits / temp + noises[s]` and commits the `counts[s]`
    masked positions whose token has the highest log-probability; the
    positions committed before are the frame's input, the rest token 0.
    The reference looks for an order of commits that explains the served
    frame. A set of positions committed at `s` explains it to within `g`
    if each one's served token's perturbed logit lies at most `g` below
    the best, and its log-probability at most `g` below the least that any
    position left masked could have had: that position's
    lowest-probability token within `near_tie` of its best (the one
    rounding could have put first). From every position masked, at each
    `s`, for each of a ladder of tolerances up to `near_tie`, it takes the
    most probable `counts[s]` positions whose served token lies within the
    tolerance of their best (then, if too few do, those nearest), and
    commits, per player, the set that explains the frame best. A
    position's reading is the least, over the refinement that commits it
    and every one before it, of how far it is from being explained there:
    at an earlier one, against every position left masked but those
    committed there and itself; and those explained at an earlier one hold
    no position back.

    The first refinement's input is known. Later, rounding can make the
    set the reference commits differ from the program's where two
    positions' log-probabilities, or a served token and a near-tied one,
    lie close; the context of every later refinement then differs, which
    a model with random weights answers with other logits, and a few
    tokens read far off although the program is sound (`check` counts
    them as a share).
    """
    b, hw = served.shape
    counts = ref.schedule(len(noises), hw)
    rows = torch.arange(b, device=served.device)[:, None]
    ladder = [0.0] + [near_tie * 2.0 ** -k for k in range(7, -1, -1)]
    mask = torch.ones(b, hw, dtype=torch.bool, device=served.device)
    readings = torch.full((b, hw), float("nan"), device=served.device)
    stage = torch.full((b, hw), -1, dtype=torch.long, device=served.device)
    earlier = torch.full((b, hw), float("inf"), device=served.device)
    for s, (noise, n) in enumerate(zip(noises, counts)):
        lg = f32.next_logits(past, served.masked_fill(mask, 0).view(b, *grid), action) / temp
        lse = torch.logsumexp(lg, -1)
        conf = lg.gather(-1, served[..., None])[..., 0] - lse
        pert = lg + noise.float()
        top = pert.topk(k, -1)
        gap = top.values[..., 0] - pert.gather(-1, served[..., None])[..., 0]
        close = top.values >= top.values[..., :1] - near_tie
        floor = (lg.gather(-1, top.indices) - lse[..., None]).masked_fill(
            ~close, float("inf")).min(-1).values
        del lg, pert, top
        # Positions explained at an earlier refinement may be committed
        # already; they hold no position back.
        waits = mask & (earlier > near_tie)
        best_worst, best_cterm, best_picked = None, None, None
        for g in ladder:
            key = torch.where(gap <= g, conf, -1e4 - gap).masked_fill(~mask, float("-inf"))
            picked = torch.zeros_like(mask)
            picked[rows, key.topk(int(n), -1).indices] = True
            others = floor.masked_fill(~waits | picked, float("-inf")).max(-1).values[:, None]
            cterm = (others - conf).clamp_min(0)
            worst = torch.maximum(gap, cterm).masked_fill(~picked, float("-inf")).max(-1).values
            if best_worst is None:
                best_worst, best_cterm, best_picked = worst, cterm, picked
                continue
            better = (worst < best_worst)[:, None]
            best_cterm = torch.where(better, cterm, best_cterm)
            best_picked = torch.where(better, picked, best_picked)
            best_worst = torch.minimum(worst, best_worst)
        now = torch.minimum(earlier, torch.maximum(gap, best_cterm))
        readings = torch.where(best_picked, now, readings)
        stage = torch.where(best_picked, s, stage)
        mask &= ~best_picked
        if not mask.any():
            break
        # Were each position left masked committed here instead: how far
        # from explained, against the others left masked.
        rest = floor.masked_fill(~(mask & waits), float("-inf")).topk(min(2, hw), -1)
        is_top = torch.arange(hw, device=served.device) == rest.indices[:, :1]
        excl = torch.where(is_top, rest.values[:, -1:], rest.values[:, :1])
        alt = torch.maximum(gap, (excl - conf).clamp_min(0))
        earlier = torch.where(mask, torch.minimum(earlier, alt), earlier)
    return readings, stage


def _bit_gap(feats: torch.Tensor, bits: torch.Tensor) -> float:
    """Widest |reference feature| at a bit whose sign disagrees, over the
    features' RMS."""
    wrong = (feats > 0) != bits
    rms = feats.square().mean().sqrt()
    return (feats.abs().masked_fill(~wrong, 0).amax() / rms).item()


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per frame: RMS of the difference over the RMS of `want`."""
    dims = tuple(range(1, got.dim()))
    return (got - want).square().mean(dims).sqrt() / want.square().mean(dims).sqrt()


def verdict(nums: dict, limits: dict) -> tuple:
    """`(correct, checks)`: every number finite and within its limit."""
    checks = {k: {"value": nums[k], "limit": limits[k]} for k in limits}
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values()), checks


def _tail(values: list, k: int = 8) -> dict:
    """The `k` largest readings and the share (%) over a few levels, for
    calibrate.py."""
    v = torch.cat([t.flatten().cpu() for t in values]) if values else torch.zeros(0)
    return {"top": v.topk(min(k, v.numel())).values.tolist(),
            "pct_over": {str(x): 100.0 * (v > x).sum().item() / max(v.numel(), 1)
                         for x in (0.15, 0.3, 0.6, 1.0, 2.0)}}


def check(config, traffic, seed, sess_seed, tokens0, epochs, frames, prompt, dev, control):
    """The plain reference's judgement of a sample of what the window
    served: `{"correct", "checks": {name: {"value", "limit"}}}`, and with
    `control` the same numbers and verdict for the float8 control in the
    program's place (`"control"`, `"control_correct"`)."""
    model, lim = config["model"], traffic["check"]["limits"]
    b, temp = traffic["players"], traffic["temp"]
    near_tie = traffic["check"]["near_tie"]
    t_check = time.perf_counter()
    players, picks = _sample(epochs, seed, b, traffic["check"]["steps_per_epoch"])
    specs = ref.param_specs(model)
    sides = ("program", "control") if control else ("program",)
    nums = {side: {} for side in sides}
    reads = {side: {"first": [], "later": []} for side in sides}
    with ref.no_tf32(), torch.no_grad():
        P = {k: v.float() for k, v in
             weights.make(specs, seed, dev, getattr(torch, config["dtype"])).items()}
        f32 = ref.SessionModel(model, P, ref.Ops())
        low = ref.SessionModel(model, P, ref.Ops("fp8")) if control else None
        d = model["tokenizer"]["d_codebook"]
        v = 2 ** d
        pidx = torch.tensor(players)
        # The prompt's tokens: the encoder's signs against the served bits.
        feats = f32.encode(prompt[pidx.to(dev)].float())
        t0 = tokens0.shape[1]
        bits = (tokens0[pidx, :t0].to(dev)[..., None].long()
                >> torch.arange(d - 1, -1, -1, device=dev)) & 1
        nums["program"]["prompt_bit_gap"] = _bit_gap(feats, bits.bool())
        if control:
            nums["control"]["prompt_bit_gap"] = _bit_gap(
                feats, low.encode(prompt[pidx.to(dev)].float()) > 0)
        del feats
        pix = {side: 0.0 for side in sides}
        served_tokens = 0
        for e in (r for r in epochs if r["epoch"] in picks):
            js = picks[e["epoch"]]
            toks, acts = e["tokens"].to(dev), e["actions"].to(dev)
            if toks.min() < 0 or toks.max() >= v:
                nums["program"]["maskgit_gap"] = float("inf")
                continue
            grid = tuple(toks.shape[2:])
            shape = (b, grid[0] * grid[1], v)
            for j, noises in _draws(sess_seed, e, js, shape, dev):
                pos = e["t0"] + j
                past = f32.history(toks[:, :pos], acts[:, :pos])
                frame = {"program": toks[:, pos].flatten(1).long()}
                if control:
                    lpast = low.history(toks[:, :pos], acts[:, :pos])
                    frame["control"] = ref.sample_frame(low, lpast, acts[:, pos], noises, temp,
                                                        ref.schedule(len(noises), shape[1]),
                                                        grid)
                    del lpast
                for side in sides:
                    r, st = judge_frame(f32, past, frame[side], acts[:, pos], noises, temp, grid,
                                        near_tie)
                    reads[side]["first"].append(r[st == 0])
                    reads[side]["later"].append(r[st > 0])
                served_tokens += frame["program"].numel()
                del past, noises
            last = e["t0"] + max(js)
            ref_pix = f32.decode(toks[pidx.to(dev), :last + 1])
            tf = ref_pix.shape[1] // (last + 1)
            want = torch.stack([ref_pix[:, tf * (e["t0"] + j) + tf - 1] for j in js], 1)
            got = {"program": torch.stack([frames[e["first"] + j][pidx] for j in js], 1)}
            if control:
                low_pix = low.decode(toks[pidx.to(dev), :last + 1])
                got["control"] = torch.stack([low_pix[:, tf * (e["t0"] + j) + tf - 1]
                                              for j in js], 1)
                del low_pix
            for side in sides:
                err = _rel_err(got[side].to(dev).float().flatten(0, 1), want.flatten(0, 1))
                pix[side] = max(pix[side], err.max().item())
            del ref_pix
        for side in sides:
            first = [t.max().item() for t in reads[side]["first"] if t.numel()]
            nums[side].setdefault("maskgit_gap", max(first, default=0.0))
            later = torch.cat([t.flatten() for t in reads[side]["later"]] or [torch.zeros(0)])
            nums[side]["refine_miss_pct"] = (100.0 * (later > near_tie).sum().item()
                                             / max(later.numel(), 1))
            nums[side]["pixel_rel_err"] = pix[side]
    correct, checks = verdict(nums["program"], lim)
    out = {"correct": correct, "checks": checks, "check_s": time.perf_counter() - t_check,
           "sample": {"players": players, "steps": {str(k): v for k, v in picks.items()},
                      "served_tokens": served_tokens},
           "tails": {side: {part: _tail(reads[side][part]) for part in ("first", "later")}
                     for side in sides}}
    if control:
        out["control"] = nums["control"]
        out["control_correct"] = verdict(nums["control"], lim)[0]
    return out
