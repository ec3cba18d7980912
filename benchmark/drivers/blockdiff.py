"""Driver `blockdiff`: block-diffusion text generation, every row in
lockstep, closed loop.

Set-up builds the configuration's token model (`DynamicsModel`) on the
meta device, puts it on the card in the configuration's dtype and draws
each parameter from the seed (`seeded_weights`); a `BlockSession` then
prefills the first batch of seeded prompts and runs warm-up steps, so the
window meets no shape it has not run. The window asks for the next block
of every row, each step after the last one's ids are on the host. After
`blocks` steps the next batch's prompts are prefilled, inside the step
that generates its first block.

At judged steps, drawn from the seed before the window, the session's
`watch` keeps each pass's input ids and logits for a few rows. After the
window the program is freed and the plain float32 reference
(`reference/sdar_30b_a3b.py`, its weights drawn again layer by layer)
computes the full forward of each kept input after its row's prompt and
served blocks; see `check`.
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
from reference import sdar_30b_a3b as ref  # noqa: E402
import harness  # noqa: E402
import seeded_weights  # noqa: E402

BATCH_SEED_STRIDE = 0x9E3779B1  # batch k's prompts and noise: seeds s + 1 + k * stride, s + 2 + ...


def build(model: dict, seed: int, device, dtype):
    """The program's model at the configuration's sizes, built on the
    meta device, put on `device` in `dtype`, each parameter drawn from the
    seed."""
    from open_genie_tpu_torch.models.dynamics import DynamicsModel

    with torch.device("meta"):
        dyn = DynamicsModel(**model["dynamics"]).to(dtype)
    dyn = dyn.to_empty(device=device)
    seeded_weights.fill(dyn, ref.param_specs(model["dynamics"]), seed)
    return dyn.eval()


def prompts(seed: int, k: int, rows: int, n: int, vocab: int, mask_id: int, device):
    """Batch `k`'s `(rows, n)` prompt ids, uniform over the vocabulary
    without the mask token."""
    g = torch.Generator(device=device).manual_seed(seed + 1 + k * BATCH_SEED_STRIDE)
    ids = torch.randint(0, vocab - 1, (rows, n), generator=g, device=device)
    return ids + (ids >= mask_id).long()


def batch_seed(seed: int, k: int) -> int:
    return seed + 2 + k * BATCH_SEED_STRIDE


class Capture:
    """Keeps rows `rows` of every pass's input ids and logits that the
    session shows its `watch` (`BlockSession.watch`) while set on it."""

    def __init__(self, sess, rows, device):
        self.rows = torch.tensor(rows, device=device)
        self.ids, self.logits = [], []
        self._sess = sess
        sess.watch = self._keep

    def _keep(self, ids, logits):
        self.ids.append(ids[self.rows, 0].clone())
        self.logits.append(logits[self.rows].clone())

    def close(self):
        self._sess.watch = None


def run(cell: dict, config: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        started: float, *, device="cuda", window_steps=None, control: bool = False) -> dict:
    """One run of the cell. `device` and `window_steps` (a window of that
    many steps instead of `seconds`) are for the CPU tests and calibrate.py;
    `control` also judges the float8 control in the program's place."""
    from open_genie_tpu_torch.serve import BlockSession

    dev = torch.device(device)
    on_cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    model = config["model"]
    dyncfg = model["dynamics"]
    dtype = getattr(torch, config["dtype"])
    b, n, blocks = traffic["rows"], traffic["prompt_tokens"], traffic["blocks"]
    vocab, mask_id = dyncfg["tok_vocab"], dyncfg["mask_id"]

    dyn = build(model, seed, dev, dtype)
    sess = BlockSession(dyn, max_blocks=blocks, block_length=model["block_length"],
                        steps_per_block=model["denoising_steps"], temp=traffic["temp"],
                        prefill_chunk=traffic["prefill_chunk"], device=dev)
    rng = np.random.default_rng(seed + 4)
    rows = sorted(int(r) for r in rng.choice(b, traffic["check"]["rows"], replace=False))
    # Global step indices: `warm` warm-up steps (the first a prefill), one
    # profiled step more in set-up with `trace`, then the window.
    warm = traffic["warmup_steps"]
    start = warm + int(trace)
    first_traced, n_traced = traffic["trace_steps"]
    traced_global = set(range(start + first_traced, start + first_traced + n_traced)) \
        if trace else set()
    picks = rng.choice(np.arange(start, start + traffic["check"]["within"]),
                       traffic["check"]["judged"], replace=False)
    # The judged steps: random ones and the first prefill of the window.
    judged = ({int(p) for p in picks} | {blocks}) - traced_global
    served, prompt_ids, kept = [], [], []
    steps, lat = [], []
    state = {"batch": -1, "block": blocks}

    def step():
        i = len(steps)
        t = time.perf_counter()
        prefill = state["block"] == blocks
        if prefill:
            state["batch"] += 1
            state["block"] = 0
            ids = prompts(seed, state["batch"], b, n, vocab, mask_id, dev)
            sess.reset(ids, seed=batch_seed(seed, state["batch"]))
            prompt_ids.append(ids.cpu())
            served.append([])
        cap = Capture(sess, rows, dev) if i in judged else None
        out = sess.step()
        lat.append(time.perf_counter() - t)
        if cap is not None:
            cap.close()
            kept.append({"batch": state["batch"], "block": state["block"], "rows": rows,
                         "ids": [x.cpu() for x in cap.ids], "logits": cap.logits})
        served[-1].append(out)
        steps.append((state["batch"], state["block"], prefill))
        state["block"] += 1

    for _ in range(warm):
        step()
    if trace:  # the profiler's first start (CUPTI) belongs to set-up
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            step()
    sync()
    setup_peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    n_warm = len(steps)
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    tw = time.perf_counter()
    setup_s = tw - started
    profiled, traced = [], []

    def more():
        if window_steps:
            return len(steps) - n_warm < window_steps
        return time.perf_counter() - tw < seconds

    while more():
        i = len(steps) - n_warm
        if trace and i == first_traced:
            from torch.profiler import ProfilerActivity, profile

            mark = span_mark()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(n_traced):
                    traced.append(len(steps) - n_warm)
                    step()
            profiled.append(prof)
        else:
            step()
    window_s = time.perf_counter() - tw
    window_peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    spans, load = program_record(mark) if profiled else (None, None)
    del sess, dyn
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()

    win = steps[n_warm:]
    ids_win = [served[k][j] for k, j, _ in win]
    failed = sum(int(((x < 0) | (x >= vocab)).any(1).sum()) for x in ids_win)
    out = {
        "attempted": len(win) * b,
        "failed": failed,
        "memory_peak_bytes": max(setup_peak, window_peak),
        "e2e": {
            "setup_s": setup_s,
            "frame_ms.p95": harness.percentile(lat[n_warm:], 95) * 1e3 if win else None,
            "frames_per_s": b * len(win) / window_s,
            "peak_mem_gib": window_peak / 2 ** 30,
        },
        "record": {
            "model": model, "rows": b, "prompt_tokens": n, "prefill_chunk":
                traffic["prefill_chunk"], "window_s": window_s, "steps": win,
            "latency_s": lat[n_warm:], "traced": traced, "spans": spans, "expert_load": load,
            "trace": harness.trace_events(profiled[0]) if profiled else None,
        },
    }
    out.update(check(config, traffic, seed, kept, prompt_ids, served, dev, control))
    return out


def span_mark():
    """The id of the newest span the program recorded (-1 for none), or
    None where the program records no spans."""
    try:
        from open_genie_tpu_torch.utils.debug import span_record
    except ImportError:
        return None
    return max((s["id"] for s in span_record(1)), default=-1)


def program_record(mark):
    """The program's spans (with their device ms) of the roots recorded
    after span `mark`, and its expert-load counter over those roots; `(None,
    None)` where the program has neither."""
    if mark is None:
        return None, None
    try:
        from open_genie_tpu_torch.modules.moe import expert_load
        from open_genie_tpu_torch.utils.debug import span_record
    except ImportError:
        return None, None
    spans = [s for s in span_record() if s["step"] > mark]
    roots = {s["id"] for s in spans if s["parent"] is None}
    return spans, expert_load(roots)


# --------------------------------------------------------------------------
# The check
# --------------------------------------------------------------------------

def verdict(nums: dict, limits: dict) -> tuple:
    """`(correct, checks)`: every number finite and within its limit."""
    checks = {k: {"value": nums[k], "limit": limits[k]} for k in limits}
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values()), checks


def _noise(seed: int, rec: dict, shape, steps: int, dev) -> list:
    """The session's Gumbel noise of block `rec["block"]` of batch
    `rec["batch"]`, one `(B, block, V)` draw a refinement, after the draws
    of the blocks before it."""
    g = torch.Generator(device=dev).manual_seed(batch_seed(seed, rec["batch"]))
    for _ in range(rec["block"] * steps):
        torch.rand(shape, generator=g, device=dev, dtype=torch.float32)
    return [ref.gumbel(shape, g, dev) for _ in range(steps)]


def judge(lg, noise, inp, picks, mask_id, near_tie):
    """How far each committed `(position, token)` in `picks` of one row's
    refinement is from what the reference explains: `lg` the reference's
    `(block, V)` logits / temp on input `inp`, `noise` the refinement's
    Gumbel values. A commit is explained if its token's perturbed logit
    lies within `near_tie` of the best, and its log-probability within
    `near_tie` of the least that any position left masked could have had
    (that position's lowest-probability token among those within
    `near_tie` of its best). Returns each commit's distance."""
    pert = lg + noise
    lse = torch.logsumexp(lg, -1)
    top = pert.topk(8, -1)
    close = top.values >= top.values[:, :1] - near_tie
    floor = (lg.gather(-1, top.indices) - lse[:, None]).masked_fill(~close, float("inf"))
    floor = floor.min(-1).values
    chosen = {p for p, _ in picks}
    others = [q for q in range(inp.numel()) if int(inp[q]) == mask_id and q not in chosen]
    out = []
    for p, v in picks:
        gap = float(pert[p].max() - pert[p, v])
        conf = float(lg[p, v] - lse[p])
        short = max([float(floor[q]) - conf for q in others] + [0.0])
        out.append(max(gap, short))
    return out


def check(config, traffic, seed, kept, prompt_ids, served, dev, control):
    """The plain reference's judgement of the kept passes: `{"correct",
    "checks": {name: {"value", "limit"}}}`, and with `control` the same
    numbers and verdict for the float8 control in the program's place, and
    the logit numbers of the witness (the reference on bf16-rounded
    operands: what rounding alone moves the logits by at the program's
    precision).

    A token's error is the RMS over the vocabulary of the program's
    logits' difference from the reference's, over the RMS of the
    reference's, for every kept pass, row and position of the block.
    `logit_rel_err` is the median of those errors: the bf16 program's
    rounding through 48 layers. `logit_far_pct` is the share (%) of tokens
    whose error exceeds `far`: the router's choice among near-tied experts
    may go either way in bf16 and moves that token's logits further, so
    such tokens are counted as a share. `commit_miss_pct`: the share (%) of
    the kept refinements' commits (position and token) that the reference,
    on the same input and noise, explains only from farther than
    `near_tie` (`judge`): a commit that followed a near-tie of the
    program's logits may go either way, so these too are a share."""
    model, lim = config["model"], traffic["check"]["limits"]
    dyncfg = model["dynamics"]
    blk, spb = model["block_length"], model["denoising_steps"]
    mask_id, temp, near_tie = dyncfg["mask_id"], traffic["temp"], traffic["check"]["near_tie"]
    far = traffic["check"]["far"]
    b, vocab = traffic["rows"], dyncfg["tok_vocab"]
    t_check = time.perf_counter()
    specs = ref.param_specs(dyncfg)
    dtype = getattr(torch, config["dtype"])

    def weights(name):  # drawn again at each request: one layer's weights at a time
        return seeded_weights.draw(name, specs[name], seed, dev, dtype)

    sides = ("program", "control", "witness") if control else ("program",)
    rel = {side: [] for side in sides}
    miss = {side: [] for side in sides}
    with ref.no_tf32(), torch.no_grad():
        for rec in kept:
            r = torch.tensor(rec["rows"])
            k, j = rec["batch"], rec["block"]
            prefix = torch.cat([prompt_ids[k][r]] + [x[r] for x in served[k][:j]], 1)
            seqs = torch.cat([torch.cat([prefix, x], 1) for x in rec["ids"]]).to(dev)
            want = ref.forward(dyncfg, weights, seqs, blk, last=blk) / temp
            got = {"program": torch.stack(rec["logits"]).reshape(want.shape).float() / temp}
            if control:
                got["control"] = ref.forward(dyncfg, weights, seqs, blk, ref.Ops("fp8"),
                                             last=blk) / temp
                got["witness"] = ref.forward(dyncfg, weights, seqs, blk, ref.Ops("bf16"),
                                             last=blk) / temp
            for side in sides:
                err = (got[side] - want).square().mean(-1).sqrt() / want.square().mean(-1).sqrt()
                rel[side].append(err.flatten().cpu())
            noises = _noise(seed, rec, (b, blk, vocab), spb, dev)
            nr = len(rec["rows"])
            for s in range(spb):
                inp, nxt = rec["ids"][s], rec["ids"][s + 1]
                for i, row in enumerate(rec["rows"]):
                    lg = want[s * nr + i]
                    g = noises[s][row]
                    committed = [(p, int(nxt[i, p])) for p in range(blk)
                                 if int(inp[i, p]) == mask_id and int(nxt[i, p]) != mask_id]
                    miss["program"] += judge(lg, g, inp[i], committed, mask_id, near_tie)
                    if control:
                        c_lg = got["control"][s * nr + i]
                        pert = c_lg + g
                        pred = pert.argmax(-1)
                        conf = c_lg.gather(-1, pred[:, None])[:, 0] - torch.logsumexp(c_lg, -1)
                        masked = torch.tensor([int(x) == mask_id for x in inp[i]], device=dev)
                        conf = conf.masked_fill(~masked, float("-inf"))
                        pick = conf.topk(max(len(committed), 1)).indices.tolist()
                        miss["control"] += judge(lg, g, inp[i], [(p, int(pred[p])) for p in pick],
                                                 mask_id, near_tie)
            del want, got, seqs, noises
    errs = {side: torch.cat(rel[side]) if rel[side] else torch.full((1,), float("inf"))
            for side in sides}
    nums = {side: {"logit_rel_err": errs[side].median().item(),
                   "logit_far_pct": 100.0 * (errs[side] > far).float().mean().item(),
                   "commit_miss_pct": 100.0 * sum(x > near_tie for x in miss[side])
                   / max(len(miss[side]), 1)} for side in sides}
    if len(kept) < 2:  # too short a window to judge
        nums["program"]["logit_rel_err"] = float("inf")
    correct, checks = verdict(nums["program"], lim)
    out = {"correct": correct, "checks": checks, "check_s": time.perf_counter() - t_check,
           "sample": {"rows": kept[0]["rows"] if kept else [],
                      "steps": [(rec["batch"], rec["block"]) for rec in kept],
                      "commits": len(miss["program"])},
           "tails": {side: {"logit_rel_err": errs[side].sort().values[-8:].tolist(),
                            "commit_miss": sorted(miss[side])[-8:]} for side in sides}}
    if control:
        out["control"] = nums["control"]
        out["control_correct"] = verdict(nums["control"], lim)[0]
        out["witness"] = {k: v for k, v in nums["witness"].items() if k != "commit_miss_pct"}
    return out
