"""mfu.bd: the block-diffusion model's operations per second over the
H100's bf16 peak, for the window's steps outside the profiled part (their
operations over their time, each step from its call until its ids are on
the host). Layer: the model step (`serve.py::BlockSession.step`,
`models/dynamics.py::refine_frame`). Moves `frames_per_s`.

Operations counted from the configuration's shapes (2 per multiply-add),
per token of each pass of every layer: the q, k, v and output
projections, attention over the keys the token sees (the cached prefix to
the end of its block), the router and the `top_k` experts' three
products; the vocabulary head at each refinement (the commit's head output
is not used, so not counted); at a step that carries a prefill, the
prompt's chunks (no head). Norms, RoPE, the sampler count nothing."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from yardstick import PEAK_BF16_FLOPS  # noqa: E402


def token_flops(kw, keys: int) -> float:
    """One layer's operations on one token that attends to `keys` keys."""
    c, dh = kw["n_embd"], kw["d_head"]
    nq, nk = kw["n_head"], kw["n_kv_head"]
    proj = 2 * c * (nq + 2 * nk) * dh + 2 * nq * dh * c
    experts = 2 * c * kw["n_experts"] + kw["top_k"] * 3 * 2 * c * kw["d_expert"]
    return proj + experts + 4 * nq * dh * keys


def step_flops(rec, block_index: int, prefill: bool) -> float:
    model = rec["model"]
    dyn = model["dynamics"]
    (_, kw), = dyn["desc"]
    layers, blk, spb = kw["n_rep"], model["block_length"], model["denoising_steps"]
    n = rec["prompt_tokens"]
    end = n + blk * (block_index + 1)
    per_row = (spb + 1) * layers * token_flops(kw, end) * blk
    per_row += spb * blk * 2 * kw["n_embd"] * dyn["tok_vocab"]
    if prefill:
        chunk = rec["prefill_chunk"]
        for p in range(0, n, chunk):
            c = min(chunk, n - p)
            # token i of the chunk sees the keys to the end of its block
            per_row += layers * sum(token_flops(kw, p + (i // blk + 1) * blk) for i in range(c))
    return rec["rows"] * per_row


def read(rec):
    if not rec.get("steps"):
        return None
    traced = set(rec.get("traced", ()))
    flops = secs = 0.0
    for i, ((_, j, prefill), lat) in enumerate(zip(rec["steps"], rec["latency_s"])):
        if i in traced:
            continue
        flops += step_flops(rec, j, prefill)
        secs += lat
    return 100.0 * flops / secs / PEAK_BF16_FLOPS if secs else None
