"""Plain float32 reference of SDAR-30B-A3B's forward pass
(https://huggingface.co/JetLM/SDAR-30B-A3B-Chat, a block-diffusion model
on a Qwen3-MoE body), written from the published description in plain
PyTorch: no kernels, no cache, no batching tricks, the experts a loop. It
imports nothing of the program; `param_names` names the parameters as the
program's state dict does, so one set of values loads into both.

    logits = forward(cfg, weights.__getitem__, ids, block=4)

`cfg` is the program's configuration dict (`dynamics` of
`sdar_30b_a3b_config()` or a smaller one of the same keys); `weights(name)`
gives a parameter by name (any float dtype; used in float32).

The model: token embedding; 48 layers of `h = x + o(Attn(RMSNorm(x)))`,
`y = h + MoE(RMSNorm(h))`; RMSNorm; an untied head. Attention: `q =
RMSNorm_128(W_q n)`, `k = RMSNorm_128(W_k n)`, `v = W_v n`, RoPE (theta
1e6, the two halves of a head rotated as pairs) on q and k at positions 0,
1, ...; each key/value head serves `n_head / n_kv_head` query heads; scale
`d_head ** -0.5`; token i sees token j iff `j // block <= i // block`.
MoE: `p = softmax(W_r n)`, the 8 largest, `w = p_top / sum p_top`, `sum_e
w_e W_down,e (silu(W_gate,e n) * W_up,e n)`.

Departures from the published description, all shared with the program:
the block length (4) is not in the published config and is assumed; a tie
in the router's top-8 goes to the lower expert index. Sampling (in
`benchmark/reference/sdar_30b_a3b.py`) is MaskGIT's Gumbel-argmax with
the sampled token's log-probability as confidence and a linear schedule,
which for a block of 4 tokens and 4 steps commits one token a step, as
SDAR's static low-confidence remasking does; SDAR's dynamic threshold is
not used.

Run with TF32 off (`no_tf32`).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def no_tf32():
    """True float32 products inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def layer_kwargs(cfg: dict) -> tuple:
    """`(kwargs, n_layers)` of the configuration's one kind of layer."""
    (name, kw), = cfg["desc"]
    if name != "sdar_block":
        raise ValueError(f"not an SDAR configuration: {name}")
    return kw, int(kw["n_rep"])


def param_names(cfg: dict) -> dict:
    """Every parameter's name and shape, as the program's state dict."""
    kw, n_layers = layer_kwargs(cfg)
    c, dh = kw["n_embd"], kw["d_head"]
    nq, nk, e, i = kw["n_head"], kw["n_kv_head"], kw["n_experts"], kw["d_expert"]
    out = {"tok_emb.weight": (cfg["tok_vocab"], cfg["embed_dim"])}
    for layer in range(n_layers):
        p = f"layers.{layer}."
        out.update({
            p + "attn_norm.weight": (c,),
            p + "attn.to_qkv.weight": ((nq + 2 * nk) * dh, c),
            p + "attn.to_out.weight": (c, nq * dh),
            p + "attn.q_norm.weight": (dh,),
            p + "attn.k_norm.weight": (dh,),
            p + "moe_norm.weight": (c,),
            p + "moe.w_gate_up": (e, 2 * i, c),
            p + "moe.w_down": (e, c, i),
            p + "moe.router.weight": (e, c),
        })
    out["norm.weight"] = (c,)
    out["head.weight"] = (cfg["tok_vocab"], c)
    return out


def rms_norm(x, w, eps):
    return w * (x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps))


def rope(x, theta):
    """`(B, N, H, D)` rotated at positions 0 .. N - 1."""
    n, d = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = torch.arange(n, dtype=torch.float32, device=x.device)[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], -1)[None, :, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return x * torch.cos(ang) + torch.cat([-x2, x1], -1) * torch.sin(ang)


def attention(kw, W, p, x, block):
    b, n, _ = x.shape
    nq, nk, dh, eps = kw["n_head"], kw["n_kv_head"], kw["d_head"], kw["eps"]
    qkv = F.linear(x, W(p + "to_qkv.weight").float())
    q = qkv[..., : nq * dh].view(b, n, nq, dh)
    k = qkv[..., nq * dh: (nq + nk) * dh].view(b, n, nk, dh)
    v = qkv[..., (nq + nk) * dh:].view(b, n, nk, dh)
    q = rope(rms_norm(q, W(p + "q_norm.weight").float(), eps), kw["rope_theta"])
    k = rope(rms_norm(k, W(p + "k_norm.weight").float(), eps), kw["rope_theta"])
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    k, v = k.repeat_interleave(nq // nk, 1), v.repeat_interleave(nq // nk, 1)
    scores = torch.matmul(q, k.transpose(-1, -2)) * dh ** -0.5
    pos = torch.arange(n, device=x.device) // block
    scores = scores.masked_fill(pos[None, :] > pos[:, None], float("-inf"))
    out = torch.matmul(torch.softmax(scores, -1), v)
    return F.linear(out.transpose(1, 2).reshape(b, n, nq * dh), W(p + "to_out.weight").float())


def route(logits, top_k, norm_topk_prob=True):
    """`(weights, experts)` of the `top_k` largest softmax probabilities,
    a tie to the lower expert index, renormalised."""
    probs = torch.softmax(logits, -1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top, idx = top[..., :top_k], idx[..., :top_k]
    if norm_topk_prob:
        top = top / top.sum(-1, keepdim=True)
    return top, idx


def moe(kw, W, p, x):
    shape = x.shape
    x = x.reshape(-1, shape[-1])
    i = kw["d_expert"]
    top, idx = route(F.linear(x, W(p + "router.weight").float()), kw["top_k"],
                     kw.get("norm_topk_prob", True))
    w_gate_up, w_down = W(p + "w_gate_up").float(), W(p + "w_down").float()
    out = torch.zeros_like(x)
    for e in range(kw["n_experts"]):
        hit = idx == e
        rows = hit.any(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        xe = x[rows]
        h = F.silu(F.linear(xe, w_gate_up[e, :i])) * F.linear(xe, w_gate_up[e, i:])
        out[rows] += (top * hit).sum(-1)[rows, None] * F.linear(h, w_down[e])
    return out.view(shape)


def forward(cfg: dict, W, ids: torch.Tensor, block: int) -> torch.Tensor:
    """Float32 logits `(B, N, V)` of `(B, N)` token ids, blocks of `block`."""
    kw, n_layers = layer_kwargs(cfg)
    eps = kw["eps"]
    x = W("tok_emb.weight").float()[ids]
    for layer in range(n_layers):
        p = f"layers.{layer}."
        x = x + attention(kw, W, p + "attn.", rms_norm(x, W(p + "attn_norm.weight").float(), eps),
                          block)
        x = x + moe(kw, W, p + "moe.", rms_norm(x, W(p + "moe_norm.weight").float(), eps))
    x = rms_norm(x, W("norm.weight").float(), cfg["final_norm_eps"])
    return F.linear(x, W("head.weight").float())
