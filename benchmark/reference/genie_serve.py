"""Plain float32 reference of the interactive session's model: the video
tokenizer's encoder and LFQ signs, its decoder, the MaskGIT dynamics trunk
and its sampler, written from the configuration file's blueprints in plain
PyTorch (no kernels, no caches, no batching tricks).

It imports nothing of the program. It gets its parameters from the
benchmark (`param_specs` names them as the program's state dict does, so
the same values load into both) and its inputs from the seed.

Departures from the published description, all shared with the program:
RoPE rotates the attention input before its LayerNorm; the FFN of a
space-time block normalises each frame alone and pads time on the left;
the Gumbel noise is drawn in float32 and rounded to bfloat16.

`Ops(low="fp8")` is the control: every matrix product and convolution
takes its operands rounded to float8 e4m3 (one scale per tensor) and
accumulates in float32, the step below the bfloat16 the cell serves in.
Run with TF32 off (`no_tf32`).
"""
from __future__ import annotations

import contextlib
from math import pi

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest float8 e4m3fn value


@contextlib.contextmanager
def no_tf32():
    """True float32 products and convolutions inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Ops:
    """Products in float32, or with `low="fp8"` on float8-rounded operands."""

    def __init__(self, low=None):
        if low not in (None, "fp8"):
            raise ValueError(f"unknown precision {low!r}")
        self.low = low

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if self.low is None:
            return t
        scale = t.abs().amax().clamp_min(1e-30) / FP8_MAX
        return (t / scale).to(torch.float8_e4m3fn).float() * scale

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), b)

    def matmul(self, a, b):
        return torch.matmul(self.q(a), self.q(b))

    def conv3d(self, x, w, b, stride, padding):
        return F.conv3d(self.q(x), self.q(w), b, stride=stride, padding=padding)


# --------------------------------------------------------------------------
# Blueprints and parameters
# --------------------------------------------------------------------------

def expand(blueprint):
    """`[(name, kwargs)]`, one entry per layer, `n_rep` expanded."""
    out = []
    for desc in blueprint:
        name, kw = (desc, {}) if isinstance(desc, str) else desc
        kw = dict(kw)
        kw.pop("has_ext", None)
        for _ in range(int(kw.pop("n_rep", 1))):
            out.append((name, kw))
    return out


def _k3(k):
    return tuple(k) if isinstance(k, (list, tuple)) else (k, k, k)


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


def st_widths(kw):
    """(d_inp, space_hid, time_hid, d_out, heads, d_head) of a space-time block."""
    heads, dh = _pair(kw.get("n_head", 8)), _pair(kw.get("d_head", 64))
    d_inp = kw.get("d_inp") or kw.get("n_embd")
    space_hid, time_hid = heads[0] * dh[0], heads[1] * dh[1]
    d_out = kw.get("d_out") or kw.get("n_embd") or time_hid
    return d_inp, space_hid, time_hid, d_out, heads, dh


def _normal(shape, fan_in):
    return (tuple(shape), ("normal", fan_in ** -0.5))


def _const(shape, value):
    return (tuple(shape), ("const", float(value)))


def _conv_specs(p, cin, cout, k, bias=True):
    kt, kh, kw = _k3(k)
    out = {p + "weight": _normal((cout, cin, kt, kh, kw), cin * kt * kh * kw)}
    if bias:
        out[p + "bias"] = _const((cout,), 0.0)
    return out


def _norm_specs(p, c):
    return {p + "weight": _const((c,), 1.0), p + "bias": _const((c,), 0.0)}


def layer_specs(p, name, kw):
    """The parameters of one blueprint layer, named as the program's state
    dict names them: `{name: (shape, init)}`."""
    if name == "causal-conv3d":
        return _conv_specs(p + "conv3d.", kw["in_channels"], kw["out_channels"],
                           kw.get("kernel_size", 3))
    if name == "video-residual":
        cin = kw["in_channels"]
        cout = kw.get("out_channels") or cin
        k = kw.get("kernel_size", 3)
        inner = "conv3d." if kw.get("use_causal") else ""
        out = {**_norm_specs(p + "norm1.", cin), **_norm_specs(p + "norm2.", cout)}
        out.update(_conv_specs(f"{p}conv1.{inner}", cin, cout, k))
        out.update(_conv_specs(f"{p}conv2.{inner}", cout, cout, k))
        out.update(_conv_specs(f"{p}res_proj.{inner}", cin, cout, 1))
        return out
    if name == "spacetime_downsample":
        return _conv_specs(p + "down.conv3d.", kw["in_channels"],
                           kw.get("out_channels") or kw["in_channels"], kw.get("kernel_size", 3))
    if name == "depth2spacetime_upsample":
        cin = kw["in_channels"]
        cout = (kw.get("out_channels") or cin) * kw.get("time_factor", 2) * kw.get(
            "space_factor", 2) ** 2
        return _conv_specs(p + "conv.conv3d.", cin, cout, kw.get("kernel_size", 1))
    if name == "group_norm":
        return _norm_specs(p + "gn.", kw["num_channels"])
    if name == "adaptive_group_norm":
        c, dc = kw["num_channels"], kw["dim_cond"]
        return {**_norm_specs(p + "gn.", c),
                p + "std.weight": _normal((c, dc), dc), p + "std.bias": _const((c,), 1.0),
                p + "avg.weight": _normal((c, dc), dc), p + "avg.bias": _const((c,), 0.0)}
    if name == "silu":
        return {}
    if name == "space-time_attn":
        d_inp, sh, th, d_out, _, _ = st_widths(kw)
        out = {}
        for attn, cin, cout in (("space_attn", d_inp, sh), ("time_attn", sh, th)):
            a = f"{p}{'temp_attn' if attn == 'time_attn' else attn}.attn."
            out.update(_norm_specs(a + "norm.", cin))
            out[a + "to_qkv.weight"] = _normal((3 * cout, cin), cin)
            out[a + "to_out.weight"] = _normal((cout, cout), cout)
        out.update(_norm_specs(p + "ffn.norm.", th))
        k = kw.get("kernel_size", 3)
        out[p + "ffn.block_0.weight"] = _normal((d_out, th, k, k, k), th * k ** 3)
        for skip, cin, cout in (("space_skip", d_inp, sh), ("time_skip", sh, th),
                                ("ffn_skip", th, d_out)):
            if cin != cout:
                out.update(_conv_specs(f"{p}{skip}.", cin, cout, 1))
        return out
    raise ValueError(f"the reference has no layer {name!r}")


def param_specs(model: dict) -> dict:
    """Every parameter the session's model uses, `{name: (shape, init)}`,
    init `("normal", std)` or `("const", value)`."""
    tok = model["tokenizer"]
    specs = {}
    for part, key in (("enc_layers", "enc_desc"), ("dec_layers", "dec_desc")):
        for i, (name, kw) in enumerate(expand(tok[key])):
            specs.update(layer_specs(f"tokenizer.{part}.{i}.", name, kw))
    dyn = model["dynamics"]
    e, v, a = dyn["embed_dim"], 2 ** tok["d_codebook"], 2 ** model["latent_action"]["d_codebook"]
    specs["dynamics.tok_emb.weight"] = _normal((v, e), e)
    specs["dynamics.act_emb.weight"] = _normal((a, e), e)
    width = e
    for i, (name, kw) in enumerate(expand(dyn["desc"])):
        specs.update(layer_specs(f"dynamics.layers.{i}.", name, kw))
        width = st_widths(kw)[3]
    specs["dynamics.head.weight"] = _normal((v, width), width)
    specs["dynamics.head.bias"] = _const((v,), 0.0)
    return specs


# --------------------------------------------------------------------------
# Layers, channels-last (B, T, H, W, C)
# --------------------------------------------------------------------------

def _cf(x):
    return x.permute(0, 4, 1, 2, 3)


def _cl(x):
    return x.permute(0, 2, 3, 4, 1)


def causal_conv(o, x, w, b=None, stride=(1, 1, 1)):
    """Time padded on the left by `k_t - stride_t`, space by `(k - 1) // 2`
    on both sides, zeros."""
    kt, kh, kw = w.shape[2:]
    tp = kt - 1 + 1 - stride[0]
    xc = F.pad(_cf(x), (0, 0, 0, 0, tp, 0))
    return _cl(o.conv3d(xc, w, b, stride, (0, (kh - 1) // 2, (kw - 1) // 2)))


def same_conv(o, x, w, b=None):
    """Symmetric zero padding `(k - 1) // 2` on every axis."""
    return _cl(o.conv3d(_cf(x), w, b, (1, 1, 1), tuple((k - 1) // 2 for k in w.shape[2:])))


def group_norm(x, w, b, groups, eps, per_frame=False):
    lead = x.shape[0] * x.shape[1] if per_frame else x.shape[0]
    xg = x.reshape(lead, -1, groups, x.shape[-1] // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    return ((xg - mean) / torch.sqrt(var + eps)).reshape(x.shape) * w + b


def depth_to_spacetime(x, p, q):
    b, t, h, w, c = x.shape
    c //= p * q * q
    x = x.reshape(b, t, h, w, c, p, q, q).permute(0, 1, 5, 2, 6, 3, 7, 4)
    return x.reshape(b, t * p, h * q, w * q, c)


def rope_frequencies(dim, kind):
    if kind == "1d":
        return 1.0 / (10000.0 ** (np.arange(0, dim, 2)[: dim // 2] / dim))
    return np.linspace(1.0, 10.0 / 2, dim // 2) * pi  # "2d", over flattened h*w


def rope(x, kind, start=0):
    """Rotate interleaved feature pairs of `(..., N, D)` by position,
    positions `start` to `start + N - 1`."""
    n, d = x.shape[-2:]
    freq = torch.tensor(rope_frequencies(d, kind), dtype=torch.float32, device=x.device)
    pos = torch.arange(start, start + n, dtype=torch.float32, device=x.device)
    phase = (pos[:, None] * freq[None]).repeat_interleave(2, dim=-1)
    pairs = x.unflatten(-1, (-1, 2))
    rot = torch.stack((-pairs[..., 1], pairs[..., 0]), dim=-1).flatten(-2)
    return x * torch.cos(phase) + rot * torch.sin(phase)


def attention(o, P, a, x, heads, dh, kind, causal, past=None):
    """Pre-LayerNorm self-attention over `(B, N, C)`, RoPE on the input.
    `past`, the `(k, v)` of earlier positions, puts `x` after them.
    Returns the output and the `(k, v)` of every position."""
    start = 0 if past is None else past[0].shape[2]
    x = F.layer_norm(rope(x, kind, start), (x.shape[-1],), P[a + "norm.weight"],
                     P[a + "norm.bias"], eps=1e-6)
    b, n, _ = x.shape
    q, k, v = o.linear(x, P[a + "to_qkv.weight"]).view(b, n, 3, heads, dh).permute(
        2, 0, 3, 1, 4).unbind(0)
    if past is not None:
        k, v = torch.cat((past[0], k), 2), torch.cat((past[1], v), 2)
    logits = o.matmul(q, k.transpose(-1, -2)) * dh ** -0.5
    if causal:
        logits = logits.masked_fill(torch.ones(n, start + n, dtype=torch.bool, device=x.device)
                                    .triu(start + 1), float("-inf"))
    out = o.matmul(torch.softmax(logits, dim=-1), v).transpose(1, 2).reshape(b, n, heads * dh)
    return o.linear(out, P[a + "to_out.weight"]), (k, v)


def _skip(o, P, p, x):
    w = P.get(p + "weight")
    return x if w is None else same_conv(o, x, w, P[p + "bias"])


def st_block(o, P, p, kw, x, past=None):
    """Factorized space-time block, causal in time, on `(B, T, H, W, C)`.
    `past` (from an earlier call) puts the frames after the ones it saw.
    Returns the output and the state a later call needs: the time
    attention's keys and values and the FFN's last normalized inputs."""
    _, _, th, _, heads, dh = st_widths(kw)
    b, t, h, w, c = x.shape
    s, _ = attention(o, P, p + "space_attn.attn.", x.reshape(b * t, h * w, c), heads[0], dh[0],
                     "2d", False)
    x = s.reshape(b, t, h, w, -1) + _skip(o, P, p + "space_skip.", x)
    seq = x.permute(0, 2, 3, 1, 4).reshape(b * h * w, t, -1)
    a, kv = attention(o, P, p + "temp_attn.attn.", seq, heads[1], dh[1], "1d", True,
                      None if past is None else past["kv"])
    x = a.reshape(b, h, w, t, -1).permute(0, 3, 1, 2, 4) + _skip(o, P, p + "time_skip.", x)
    hn = group_norm(x, P[p + "ffn.norm.weight"], P[p + "ffn.norm.bias"], heads[1], 1e-6, True)
    conv_w = P[p + "ffn.block_0.weight"]
    ctx = hn if past is None else torch.cat((past["hn"], hn), 1)
    y = causal_conv(o, ctx, conv_w)[:, -t:] + _skip(o, P, p + "ffn_skip.", x)
    return y, {"kv": kv, "hn": ctx[:, ctx.shape[1] - (conv_w.shape[2] - 1):]}


def residual(o, P, p, kw, x):
    causal, per_frame = bool(kw.get("use_causal")), bool(kw.get("per_frame_norm"))
    groups = kw.get("num_groups", 1)
    inner = "conv3d." if causal else ""
    conv = (lambda t, c: causal_conv(o, t, P[c + "weight"], P[c + "bias"])) if causal else (
        lambda t, c: same_conv(o, t, P[c + "weight"], P[c + "bias"]))
    h = F.silu(group_norm(x, P[p + "norm1.weight"], P[p + "norm1.bias"], groups, 1e-6,
                          per_frame))
    h = conv(h, f"{p}conv1.{inner}")
    h = F.silu(group_norm(h, P[p + "norm2.weight"], P[p + "norm2.bias"], groups, 1e-6,
                          per_frame))
    h = conv(h, f"{p}conv2.{inner}")
    return h + conv(x, f"{p}res_proj.{inner}")


def run_layer(o, P, p, name, kw, x, cond=None):
    if name == "causal-conv3d":
        return causal_conv(o, x, P[p + "conv3d.weight"], P[p + "conv3d.bias"])
    if name == "video-residual":
        return residual(o, P, p, kw, x)
    if name == "spacetime_downsample":
        f = (kw.get("time_factor", 2), kw.get("space_factor", 2), kw.get("space_factor", 2))
        return causal_conv(o, x, P[p + "down.conv3d.weight"], P[p + "down.conv3d.bias"], f)
    if name == "depth2spacetime_upsample":
        y = causal_conv(o, x, P[p + "conv.conv3d.weight"], P[p + "conv.conv3d.bias"])
        return depth_to_spacetime(y, kw.get("time_factor", 2), kw.get("space_factor", 2))
    if name == "group_norm":
        return group_norm(x, P[p + "gn.weight"], P[p + "gn.bias"], kw["num_groups"],
                          kw.get("eps", 1e-5), bool(kw.get("per_frame")))
    if name == "adaptive_group_norm":
        per_frame = bool(kw.get("per_frame"))
        norm = group_norm(x, P[p + "gn.weight"], P[p + "gn.bias"], kw["num_groups"], 1e-5,
                          per_frame)
        c = cond.mean(dim=(2, 3)) if per_frame else cond.mean(dim=(1, 2, 3))
        scale = o.linear(c, P[p + "std.weight"], P[p + "std.bias"])
        shift = o.linear(c, P[p + "avg.weight"], P[p + "avg.bias"])
        if per_frame:
            rep = x.shape[1] // scale.shape[1]
            scale, shift = (t.repeat_interleave(rep, dim=1)[:, :, None, None] for t in
                            (scale, shift))
        else:
            scale, shift = (t[:, None, None, None] for t in (scale, shift))
        return norm * scale + shift
    if name == "silu":
        return F.silu(x)
    if name == "space-time_attn":
        return st_block(o, P, p, kw, x)[0]
    raise ValueError(f"the reference has no layer {name!r}")


class SessionModel:
    """The session's model on float32 parameters `P` (the benchmark's
    values, upcast), computing through `Ops`."""

    def __init__(self, model: dict, P: dict, ops: Ops):
        self.model, self.P, self.o = model, P, ops
        self.d = model["tokenizer"]["d_codebook"]

    def encode(self, video: torch.Tensor) -> torch.Tensor:
        """`(B, T, H, W, 3)` video -> `(B, T', h, w, d)` pre-quantization
        features; the token's bits are their signs, the first most
        significant."""
        x = video.float()
        for i, (name, kw) in enumerate(expand(self.model["tokenizer"]["enc_desc"])):
            x = run_layer(self.o, self.P, f"tokenizer.enc_layers.{i}.", name, kw, x)
        return x

    def codes(self, idxs: torch.Tensor) -> torch.Tensor:
        bits = (idxs[..., None].long() >> torch.arange(self.d - 1, -1, -1,
                                                        device=idxs.device)) & 1
        return 2.0 * bits.float() - 1.0

    def decode(self, idxs: torch.Tensor) -> torch.Tensor:
        """`(B, T, h, w)` tokens -> `(B, T * tf, H, W, 3)` pixels."""
        x = cond = self.codes(idxs)
        for i, (name, kw) in enumerate(expand(self.model["tokenizer"]["dec_desc"])):
            x = run_layer(self.o, self.P, f"tokenizer.dec_layers.{i}.", name, kw, x, cond)
        return x

    def _trunk(self, tokens, actions, past=None):
        P = self.P
        x = P["dynamics.tok_emb.weight"][tokens.long()] + P["dynamics.act_emb.weight"][
            actions.long()][:, :, None, None, :]
        states = []
        for i, (_, kw) in enumerate(expand(self.model["dynamics"]["desc"])):
            x, st = st_block(self.o, P, f"dynamics.layers.{i}.", kw, x,
                             None if past is None else past[i])
            states.append(st)
        return x, states

    def _head(self, x):
        out = self.o.linear(x, self.P["dynamics.head.weight"], self.P["dynamics.head.bias"])
        return out.reshape(out.shape[0], -1, out.shape[-1])

    def logits(self, tokens: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
        """Dynamics logits of the last frame, `(B, h * w, V)`, for `(B, T,
        h, w)` tokens and `(B, T)` action ids."""
        return self._head(self._trunk(tokens, actions)[0][:, -1])

    def history(self, tokens: torch.Tensor, actions: torch.Tensor) -> list:
        """The trunk's state after `(B, T, h, w)` frames, for `next_logits`."""
        return self._trunk(tokens, actions)[1]

    def next_logits(self, past: list, frame: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        """`logits` of the frame after `history`'s, `(B, h, w)` tokens with
        `(B,)` action ids: the same as `logits` over all the frames."""
        return self._head(self._trunk(frame[:, None], action[:, None], past)[0][:, -1])


# --------------------------------------------------------------------------
# The MaskGIT sampler's definition
# --------------------------------------------------------------------------

def schedule(steps: int, n: int) -> np.ndarray:
    """Tokens committed at each of `steps` refinements of `n` positions,
    the linear ramp: at least one a step, the remainder on the last."""
    t = np.linspace(1, 0, steps)
    s = 1 - t
    if steps == 1 or s.sum() <= 0:
        s = np.ones(steps)
    out = np.clip(np.round(s / s.sum() * n).astype(np.int32), 1, None)
    out[-1] += n - out.sum()
    return out


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise from `generator`: float32 uniforms, clamped
    above zero, `-log(-log(u))` rounded to bfloat16, returned as float32."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return (-torch.log(-torch.log(u))).to(torch.bfloat16).float()


def sample_frame(model: SessionModel, past: list, action: torch.Tensor, noises, temp: float,
                 counts, grid) -> torch.Tensor:
    """MaskGIT's frame: every position masked (token 0), then at each
    refinement `s` each masked position takes its best token under
    `logits / temp + noises[s]`, and the `counts[s]` masked positions whose
    token has the highest log-probability commit. `(B, h * w)` tokens of
    the `(h, w)` grid."""
    b, hw = noises[0].shape[:2]
    mask = torch.ones(b, hw, dtype=torch.bool, device=action.device)
    code = torch.zeros(b, hw, dtype=torch.long, device=action.device)
    for noise, n in zip(noises, counts):
        lg = model.next_logits(past, code.masked_fill(mask, 0).view(b, *grid), action) / temp
        pred = (lg + noise.float()).argmax(-1)
        conf = lg.gather(-1, pred[..., None])[..., 0] - torch.logsumexp(lg, -1)
        pick = conf.masked_fill(~mask, float("-inf")).topk(int(n), -1).indices
        code.scatter_(1, pick, pred.gather(1, pick))
        mask.scatter_(1, pick, False)
    return code
