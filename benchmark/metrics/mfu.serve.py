"""mfu.serve: the session's model operations per second over the H100's
bf16 peak, for the window's steps outside the profiled part (their
operations over their time, each step from its call until its frames are
on the host). Layer: the model step (`models/genie.py`, `dynamics.py`,
`tokenizer.py`). Moves `frames_per_s`.

Operations counted from the configuration's shapes (2 per multiply-add):
the dynamics trunk at each refinement and the commit (projections,
spatial attention over the frame, temporal attention over the frames so
far, the FFN's conv: one time tap at a refinement, all taps and the next
position's history taps at the commit), the vocabulary head at each
refinement (the commit's head output is not used, so not counted), and
the streaming decoder's convolutions for one token frame; at a rebase,
`keep` commits and the decoder over the kept frames. Norms, activations,
embeddings and the sampler count nothing."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from reference.genie_serve import expand, st_widths  # noqa: E402
from yardstick import PEAK_BF16_FLOPS  # noqa: E402


def _k3(k):
    k = k if isinstance(k, (list, tuple)) else (k, k, k)
    return k[0] * k[1] * k[2]


def decoder_flops(dec_desc, d, h, w) -> float:
    """Operations of the streaming decoder on one token frame of one
    player at token grid (h, w)."""
    m, c, flops = 1, d, 0.0
    for name, kw in expand(dec_desc):
        vox = m * h * w
        if name == "causal-conv3d":
            flops += 2 * _k3(kw.get("kernel_size", 3)) * kw["in_channels"] * kw[
                "out_channels"] * vox
            c = kw["out_channels"]
        elif name == "video-residual":
            cin = kw["in_channels"]
            cout = kw.get("out_channels") or cin
            k = _k3(kw.get("kernel_size", 3))
            flops += 2 * vox * (k * cin * cout + k * cout * cout + cin * cout)
            c = cout
        elif name == "depth2spacetime_upsample":
            tf, sf = kw.get("time_factor", 2), kw.get("space_factor", 2)
            cout = kw.get("out_channels") or kw["in_channels"]
            flops += 2 * _k3(kw.get("kernel_size", 1)) * kw["in_channels"] * cout * tf * sf * sf * vox
            m, h, w, c = m * tf, h * sf, w * sf, cout
    return flops


def trunk_token_flops(desc, n, t, commit) -> float:
    """Operations per token of one pass of the dynamics trunk, `n` tokens
    a frame, `t` keys in the temporal attention."""
    flops = 0.0
    for _, kw in expand(desc):
        d_inp, sh, th, d_out, _, _ = st_widths(kw)
        flops += 2 * d_inp * 3 * sh + 2 * sh * sh + 4 * n * sh
        flops += 2 * sh * 3 * th + 2 * th * th + 4 * t * th
        flops += 2 * th * d_out * (27 + 18 if commit else 9)
    return flops


def step_flops(rec, pos, rebase) -> float:
    model, b, spf = rec["model"], rec["batch"], rec["steps_per_frame"]
    h, w = rec["grid"]
    n = h * w
    desc, tok = model["dynamics"]["desc"], model["tokenizer"]
    vocab = 2 ** tok["d_codebook"]
    width = st_widths(expand(desc)[-1][1])[3]
    dec = decoder_flops(tok["dec_desc"], tok["d_codebook"], h, w)
    per_player = (spf * (trunk_token_flops(desc, n, pos + 1, False) + 2 * width * vocab) * n
                  + trunk_token_flops(desc, n, pos + 1, True) * n + dec)
    if rebase:
        keep = rec["keep"]
        per_player += sum(trunk_token_flops(desc, n, p + 1, True) * n for p in range(keep))
        per_player += keep * dec
    return b * per_player


def read(rec):
    if not rec.get("steps"):
        return None
    traced = set(rec.get("traced", ()))
    flops = secs = 0.0
    for i, ((e, j, pos), lat) in enumerate(zip(rec["steps"], rec["latency_s"])):
        if i in traced:
            continue
        flops += step_flops(rec, pos, j == 0 and e > 0)
        secs += lat
    return 100.0 * flops / secs / PEAK_BF16_FLOPS if secs else None
