"""Attention stack: core, spatial, temporal and factorized space-time blocks.

Twin of `open_genie_tpu.modules.attention`. Self-attention fuses the JAX
package's three `to_q/to_k/to_v` projections into one `to_qkv` Linear, in
the order `[q | k | v]` (see `bridge.py`). Cross-attention (an `Attention`
built with `key_dim`, as the latent-action decoder's temporal attention
is) keeps `to_q` apart from `to_k`/`to_v`, whose inputs are narrower; its
keys and values are used raw, and RoPE and the LayerNorm act on the
queries only. Dropout after the output projection follows the module's
`training` flag.

KV-cached decode: a cache entry of one space-time block is the dict made
by `st_attn_cache`. A commit step (`cache_write=True`) writes the frame's
K/V and FFN window into that dict IN PLACE and returns it (the JAX package
returns updated copies; the rollout drops the old cache anyway, so the
port saves the copy). A refine step (`cache_write=False`) reads it only.

Tensor parallel (`parallel/tensor.py::shard_module`): an `Attention` with
a `tp_group` holds its rank's heads, its input enters through
`copy_to_model` and its `to_out` partials leave through
`reduce_from_model`; the FFN's split follows `ForwardBlock`. The cached
decode paths are not split.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from open_genie_tpu_torch.modules.misc import ForwardBlock, per_frame_group_norm
from open_genie_tpu_torch.modules.norm import RMSNorm, rms_norm
from open_genie_tpu_torch.ops.attention import dot_product_attention
from open_genie_tpu_torch.ops.kernels.block_attention import block_attention
from open_genie_tpu_torch.ops.conv import conv3d_cl, time_valid_conv3d
from open_genie_tpu_torch.ops.rope import apply_rope, rope_frequencies
from open_genie_tpu_torch.parallel import collectives
from open_genie_tpu_torch.utils import default
from open_genie_tpu_torch.utils.debug import span


class Attention(nn.Module):
    """Pre-LayerNorm multi-head attention over `(B, N, C)` sequences.

    Optional RoPE (`rope_kind` '1d' or '2d') rotates the query input before
    the norm, at position offset `cache_pos` in decode mode. With `key_dim`
    it is cross-attention: `forward` takes a `key` input of that width,
    used raw as keys and values, or none, and then its normed input of that
    width is the key (the JAX package's `default(key, qry)`).

    With a `tp_group` (set by `parallel.tensor.shard_module`) the module
    holds `n_head / n_model` heads of the model group: the projections
    into heads are this rank's output slices, `to_out` its input slice.
    """

    tp_group = None

    def __init__(
        self,
        n_head: int,
        d_head: int,
        d_inp: int,
        d_out: Optional[int] = None,
        key_dim: Optional[int] = None,
        bias: bool = False,
        scale: Optional[float] = None,
        causal: bool = False,
        dropout: float = 0.0,
        rope_kind: Optional[str] = None,
    ):
        super().__init__()
        hid = n_head * d_head
        self.n_head, self.d_head = n_head, d_head
        self.scale = default(scale, d_head ** -0.5)
        self.causal = causal
        self.key_dim = key_dim
        self.norm = nn.LayerNorm(d_inp, eps=1e-6)
        if key_dim is None:
            self.to_qkv = nn.Linear(d_inp, 3 * hid, bias=bias)
        else:
            self.to_q = nn.Linear(d_inp, hid, bias=bias)
            self.to_k = nn.Linear(key_dim, hid, bias=bias)
            self.to_v = nn.Linear(key_dim, hid, bias=bias)
        self.to_out = nn.Linear(hid, default(d_out, d_inp), bias=bias)
        self.dropout = nn.Dropout(dropout) if dropout > 0.0 else None
        # Kept in f32 outside the module's buffers, so casting the module
        # to bf16 does not round the frequencies.
        self._freq = None if rope_kind is None else rope_frequencies(d_inp, rope_kind)
        self._freq_on = {}

    def _rope(self, x: torch.Tensor, offset: int) -> torch.Tensor:
        freq = self._freq_on.get(x.device)
        if freq is None:
            freq = self._freq_on[x.device] = torch.from_numpy(self._freq).to(x.device)
        return apply_rope(x, freq, offset=offset)

    def _heads(self, t: torch.Tensor) -> torch.Tensor:
        b, n, _ = t.shape
        return t.view(b, n, -1, self.d_head).transpose(1, 2)

    def _cross_qkv(self, x, key):
        if key.shape[-1] != self.key_dim:
            raise ValueError(
                f"declared key_dim={self.key_dim} but the key input has width "
                f"{key.shape[-1]}"
            )
        return (self._heads(self.to_q(x)), self._heads(self.to_k(key)),
                self._heads(self.to_v(key)))

    def forward(
        self,
        x: torch.Tensor,
        key: Optional[torch.Tensor] = None,
        kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        cache_pos: Optional[int] = None,
        cache_write: bool = True,
        mask: Optional[torch.Tensor] = None,
    ):
        """Full attention, or single-position self-attention decode against
        the `(B, heads, T_max, Dh)` buffers `kv_cache` at position
        `cache_pos` (then returns `(out, (k_buf, v_buf))`). `mask` (bool,
        broadcastable to `(B, heads, N, N)`, True = attend) applies to full
        attention, on top of the causal mask where there is one."""
        decode = kv_cache is not None
        tp = self.tp_group
        if decode and tp is not None:
            raise NotImplementedError("the cached decode of a tensor-parallel attention is not "
                                      "split (no TP rollout); gather the weights first")
        if self._freq is not None:
            x = self._rope(x, cache_pos if decode else 0)
        x = self.norm(x)
        if tp is not None:
            x = collectives.copy_to_model(x, tp)
            if key is not None:
                key = collectives.copy_to_model(key, tp)
        b, n, _ = x.shape
        if self.key_dim is not None:
            if decode and key is not None:
                raise ValueError("cached decode does not support cross-attention")
            # Without a key input the normed queries are the keys, as in the
            # JAX package (a dynamics layer marked `has_ext` runs so).
            q, k, v = self._cross_qkv(x, x if key is None else key)
        else:
            if key is not None:
                raise ValueError("a key input needs an Attention built with key_dim")
            q, k, v = (
                self.to_qkv(x).view(b, n, 3, -1, self.d_head)
                .permute(2, 0, 3, 1, 4).unbind(0)
            )

        if decode and not cache_write:
            k_buf, v_buf = kv_cache
            attn = _read_only_decode(q, k, v, k_buf, v_buf, cache_pos, self.scale)
        elif decode:
            k_buf, v_buf = kv_cache
            k_buf[:, :, cache_pos] = k[:, :, 0].to(k_buf.dtype)
            v_buf[:, :, cache_pos] = v[:, :, 0].to(v_buf.dtype)
            valid = torch.arange(k_buf.shape[2], device=x.device) <= cache_pos
            attn = dot_product_attention(q, k_buf, v_buf, self.scale, mask=valid)
        else:
            attn = dot_product_attention(q, k, v, self.scale, causal=self.causal, mask=mask)

        attn = attn.transpose(1, 2).reshape(b, n, -1)
        if tp is None:
            out = self.to_out(attn)
        else:  # row split: partial sums reduced, the bias added once
            out = collectives.reduce_from_model(F.linear(attn, self.to_out.weight), tp)
            if self.to_out.bias is not None:
                out = out + self.to_out.bias
        if self.dropout is not None:
            out = self.dropout(out)
        if decode:
            return out, (k_buf, v_buf)
        return out


def _read_only_decode(q, k, v, k_buf, v_buf, cache_pos, scale):
    """Decode attention without touching the buffers: history logits from
    `k_buf` masked to `< cache_pos`, the current position's from the live
    K/V, cast to the buffer dtype first so the logits equal the write
    path's bit for bit. f32 logits and accumulation."""
    n_max = k_buf.shape[2]
    k_cur, v_cur = k.to(k_buf.dtype), v.to(v_buf.dtype)
    qf = q.float()
    logits_h = torch.matmul(qf, k_buf.float().transpose(-1, -2)) * scale
    hist = torch.arange(n_max, device=q.device) < cache_pos
    logits_h = logits_h.masked_fill(~hist, float("-inf"))
    logits_s = torch.matmul(qf, k_cur.float().transpose(-1, -2)) * scale
    probs = torch.softmax(torch.cat([logits_h, logits_s], dim=-1), dim=-1)
    probs = probs.to(q.dtype).float()
    attn = torch.matmul(probs[..., :n_max], v_buf.float()) + torch.matmul(
        probs[..., n_max:], v_cur.float()
    )
    return attn.to(q.dtype)


def _attn_width(name: str, d_inp: Optional[int]) -> int:
    if d_inp is None:  # `parse_blueprint` fills it from the width entering the layer
        raise ValueError(f"{name} needs its input width d_inp")
    return d_inp


class SpatialAttention(nn.Module):
    """Registry `space_attn`: attention over the `H * W` grid of each frame
    of a `(B, T, H, W, C)` video, batched over (B, T), or of each `(B, H,
    W, C)` image. An optional `(B, H*W, key_dim)` condition cross-attends
    as keys and values, repeated over time. Not causal unless `causal`."""

    def __init__(self, n_head, d_head, d_inp=None, d_out=None, key_dim=None,
                 bias=False, embed=True, scale=None, causal=False, dropout=0.0):
        super().__init__()
        self.attn = Attention(
            n_head, d_head, _attn_width("SpatialAttention", d_inp), d_out, key_dim=key_dim,
            bias=bias, scale=scale, causal=causal, dropout=dropout,
            rope_kind="2d" if embed else None,
        )

    def forward(self, video: torch.Tensor, cond: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if video.dim() == 4:
            return self.forward(video[:, None], cond, mask)[:, 0]
        b, t, h, w, c = video.shape
        if cond is not None:
            cond = cond.repeat_interleave(t, dim=0)  # (B*T, HW, Ck)
        out = self.attn(video.reshape(b * t, h * w, c), key=cond, mask=mask)
        return out.reshape(b, t, h, w, out.shape[-1])


class TemporalAttention(nn.Module):
    """Registry `time_attn`: attention over time, batched over (B, H, W)
    pixel tubes; causal only with `causal` (the JAX package's default is
    not; the space-time block passes True). An optional `(B, T, key_dim)`
    condition cross-attends as keys and values, repeated over space (how
    latent actions condition the latent-action decoder)."""

    def __init__(self, n_head, d_head, d_inp=None, d_out=None, key_dim=None,
                 bias=False, embed=True, scale=None, causal=False, dropout=0.0):
        super().__init__()
        self.attn = Attention(
            n_head, d_head, _attn_width("TemporalAttention", d_inp), d_out, key_dim=key_dim,
            bias=bias, scale=scale, causal=causal, dropout=dropout,
            rope_kind="1d" if embed else None,
        )

    def forward(self, video, cond=None, kv_cache=None, cache_pos=None, cache_write=True,
                mask=None):
        b, t, h, w, c = video.shape
        seq = video.permute(0, 2, 3, 1, 4).reshape(b * h * w, t, c)
        if cond is not None:
            cond = cond.repeat_interleave(h * w, dim=0)  # (B*H*W, T, Ck)
        out = self.attn(seq, key=cond, kv_cache=kv_cache, cache_pos=cache_pos,
                        cache_write=cache_write, mask=mask)
        if kv_cache is not None:
            out, new_kv = out
        out = out.reshape(b, h, w, t, out.shape[-1]).permute(0, 3, 1, 2, 4)
        return (out, new_kv) if kv_cache is not None else out


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def st_attn_cache(kwargs: dict, batch: int, h: int, w: int, t_max: int,
                  dtype: torch.dtype, device=None) -> dict:
    """Zeroed `{k, v, ffn, fh}` decode cache of ONE `space-time_attn` block,
    with dims read from its blueprint kwargs. `t_max` is rounded up to a
    multiple of 8 (attention masks by position, so slack slots are inert).

    `k`/`v` are `(B*H*W, heads, t_max, Dh)` temporal buffers; `ffn` the
    `(B, k_t - 1, H, W, time_hid)` window of post-GroupNorm FFN inputs;
    `fh` `(B, 1, H, W, d_out)` the window's contribution to the next
    position's FFN output."""
    t_max = -(-t_max // 8) * 8
    heads = _pair(kwargs.get("n_head", 8))[1]
    dh = _pair(kwargs.get("d_head", 64))[1]
    kt = kwargs.get("kernel_size", 3)
    time_hid = heads * dh
    d_out = kwargs.get("d_out") or kwargs.get("n_embd") or time_hid
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)  # noqa: E731
    return {
        "k": z(batch * h * w, heads, t_max, dh),
        "v": z(batch * h * w, heads, t_max, dh),
        "ffn": z(batch, kt - 1, h, w, time_hid),
        "fh": z(batch, 1, h, w, d_out),
    }


class SpaceTimeAttention(nn.Module):
    """Factorized ST-transformer block: spatial attention -> causal temporal
    attention -> causal conv3d FFN, each with a (dim-adapting) skip."""

    cache_kind = "frame"

    def __init__(
        self,
        n_head: Union[int, Tuple[int, int]] = 8,
        d_head: Union[int, Tuple[int, int]] = 64,
        d_inp: Optional[int] = None,
        d_out: Optional[int] = None,
        n_embd: Optional[int] = None,
        hid_dim=None,
        bias: bool = False,
        embed: Union[bool, Tuple[bool, bool]] = True,
        scale: Optional[float] = None,
        dropout: float = 0.0,
        kernel_size: int = 3,
        transpose: bool = False,  # accepted for blueprint compatibility
        time_attn_kw: Optional[Dict[str, Any]] = None,
        space_attn_kw: Optional[Dict[str, Any]] = None,
    ):
        super().__init__()
        n_head, d_head, embed = _pair(n_head), _pair(d_head), _pair(embed)
        d_inp = default(d_inp, n_embd)
        if d_inp is None:  # `parse_blueprint` fills it from the width entering the block
            raise ValueError("SpaceTimeAttention needs its input width: d_inp or n_embd")
        d_out = default(default(d_out, n_embd), n_head[1] * d_head[1])
        space_hid = n_head[0] * d_head[0]
        time_hid = n_head[1] * d_head[1]
        self.hid_dim = hid_dim
        self.space_attn = SpatialAttention(
            n_head[0], d_head[0], d_inp, space_hid, bias=bias, embed=embed[0],
            scale=scale, causal=False, dropout=dropout, **dict(space_attn_kw or {}),
        )
        self.temp_attn = TemporalAttention(
            n_head[1], d_head[1], space_hid, time_hid, bias=bias, embed=embed[1],
            scale=scale, causal=True, dropout=dropout, **dict(time_attn_kw or {}),
        )
        self.ffn = ForwardBlock(
            time_hid, d_out, hid_dim, block="conv3d", num_groups=n_head[1], use_bias=bias,
            kernel_size=kernel_size, causal_time=True,
        )
        self._cache_kw = {"n_head": n_head, "d_head": d_head, "kernel_size": kernel_size,
                          "d_out": d_out}
        skips = (("space_skip", d_inp, space_hid), ("time_skip", space_hid, time_hid),
                 ("ffn_skip", time_hid, d_out))
        for name, c_in, c_out in skips:
            if c_in != c_out:
                self.add_module(name, nn.Conv3d(c_in, c_out, 1))

    def init_cache(self, batch: int, h: int, w: int, t_max: int, dtype: torch.dtype,
                   device=None) -> dict:
        """This block's zeroed decode cache (`st_attn_cache`)."""
        return st_attn_cache(self._cache_kw, batch, h, w, t_max, dtype, device)

    def _skip(self, name: str, x: torch.Tensor) -> torch.Tensor:
        conv = getattr(self, name, None)
        return x if conv is None else conv3d_cl(x, conv.weight, conv.bias)

    def forward(self, video, cond=None, cache=None, cache_pos=None, cache_write=True,
                mask=None):
        """Full forward on `(B, T, H, W, C)`, or cached decode of one frame
        `(B, 1, H, W, C)` at time `cache_pos` (returns `(out, cache)`).

        `cond` is one condition for both attentions or a `(space_cond,
        time_cond)` pair; each needs its attention built with `key_dim`
        (`space_attn_kw` / `time_attn_kw`). `mask` (bool, True = attend)
        goes to both attentions of the full forward, so it must broadcast
        to the spatial and the temporal logits alike."""
        decode = cache is not None
        space_cond, time_cond = cond if isinstance(cond, tuple) else (cond, cond)
        if decode and (space_cond is not None or time_cond is not None):
            raise ValueError("cached decode does not support external conditioning")
        if decode and mask is not None:
            raise ValueError("cached decode does not take a mask")
        video = self.space_attn(video, space_cond, mask) + self._skip("space_skip", video)
        if decode:
            ta, _ = self.temp_attn(  # writes K/V into `cache` on commit
                video, kv_cache=(cache["k"], cache["v"]), cache_pos=cache_pos,
                cache_write=cache_write,
            )
        else:
            ta = self.temp_attn(video, time_cond, mask=mask)
        video = ta + self._skip("time_skip", video)
        if decode:
            ffn = self._ffn_decode(video, cache, cache_write)
        else:
            ffn = self.ffn(video)
        out = ffn + self._skip("ffn_skip", video)
        return (out, cache) if decode else out

    def _ffn_decode(self, video, cache, cache_write):
        """The FFN split at its conv's time taps. The cache holds the
        `(k_t - 1)`-frame post-GroupNorm window (zeros at sequence start are
        exactly the full forward's causal padding) and `fh`, the history
        taps' contribution; a refine step runs GroupNorm and ONE time tap on
        the current frame, a commit runs the full window and precomputes
        the next position's `fh`."""
        if self.hid_dim is not None:
            raise ValueError(
                "cached decode requires a single-conv FFN (hid_dim=None)"
            )
        if self.ffn.tp_group is not None:
            raise NotImplementedError("the cached decode of a tensor-parallel FFN is not split")
        conv = self.ffn.block_0
        kernel, cbias = conv.weight, conv.bias  # (O, I, kt, kh, kw)
        kt = kernel.shape[2]
        xn = per_frame_group_norm(
            video, self.ffn.norm.weight, self.ffn.norm.bias, self.ffn.num_groups
        )
        if not cache_write:
            return cache["fh"].to(xn.dtype) + time_valid_conv3d(
                xn, kernel[:, :, kt - 1:], cbias
            )
        window = torch.cat([cache["ffn"].to(xn.dtype), xn], dim=1)
        ffn = time_valid_conv3d(window, kernel, cbias)
        cache["ffn"] = window[:, 1:].to(cache["ffn"].dtype)
        cache["fh"] = time_valid_conv3d(window[:, 1:], kernel[:, :, : kt - 1]).to(
            cache["fh"].dtype
        )
        return ffn


@functools.lru_cache(maxsize=8)
def _rope_table(theta: float, d_head: int, n: int, dtype: torch.dtype, device: str):
    """`(cos, sin)` `(n, d_head)` of Qwen's rotary embedding (frequencies
    `theta ** (-2 i / d)`, the phases repeated over the two halves of a
    head), computed in f32 and cast to `dtype`, as Qwen3 casts them; `sin`
    negated over the first half (see `_rotate`)."""
    inv = 1.0 / theta ** (torch.arange(0, d_head, 2, dtype=torch.float32) / d_head)
    phase = torch.arange(n, dtype=torch.float32)[:, None] * inv[None, :]
    sin = torch.sin(phase)
    cos, sin = torch.cos(phase).repeat(1, 2), torch.cat([-sin, sin], dim=-1)
    return cos.to(device=device, dtype=dtype), sin.to(device=device, dtype=dtype)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Qwen's rotation of `(..., N, D)` by `(N, D)` tables: the two halves
    of each head turn as a pair, `x * cos + (-x2, x1) * sin`, with the
    sign already in `_rope_table`'s sin: `(-x2, x1) * sin = roll(x) *
    (-sin, sin)`."""
    return torch.addcmul(x * cos, torch.roll(x, x.shape[-1] // 2, -1), sin)


def block_attn_cache(n_kv_head: int, d_head: int, batch: int, tokens: int,
                     dtype: torch.dtype, device=None) -> dict:
    """Zeroed `{k, v}` cache of ONE block-causal attention: `(B, n_kv_head,
    tokens, d_head)` each, over the whole token prefix."""
    z = lambda: torch.zeros(batch, n_kv_head, tokens, d_head, dtype=dtype,  # noqa: E731
                            device=device)
    return {"k": z(), "v": z()}


def block_causal_mask(n_q: int, q_start: int, n_k: int, block: int, device) -> torch.Tensor:
    """`(n_q, n_k)` bool, True = attend: query token `q_start + i` sees key
    token `j` iff `j // block <= (q_start + i) // block`."""
    qb = (torch.arange(n_q, device=device) + q_start) // block
    kb = torch.arange(n_k, device=device) // block
    return kb[None, :] <= qb[:, None]


class BlockCausalAttention(nn.Module):
    """Grouped-query attention over `(B, N, C)` tokens in blocks of `block`
    (given per call): bidirectional inside a block, and a block sees every
    earlier one. As in Qwen3 (SDAR-30B-A3B's body): `q = RMSNorm(W_q x)`
    and `k = RMSNorm(W_k x)` per head, `v = W_v x`, RoPE on q and k at the
    tokens' absolute positions, each of `n_kv_head` key/value heads serving
    `n_head / n_kv_head` query heads, scale `d_head ** -0.5`, no bias. The
    input is not normed here (the block that holds it norms it). The
    port's own: the JAX package has no grouped-query attention.

    With a cache (`block_attn_cache`), the tokens at positions `[pos, pos
    + N)` write their K/V into the cache's slots there and attend over its
    `[0, pos + N)` in bf16 where the model is: one aligned block (a
    refinement or a commit of block diffusion) attends to all of it with
    no mask, through kernel K9 (`ops/kernels/block_attention.py`), which
    reads each cached key and value once and copies nothing; a chunk of
    several blocks (a prefill), and the full forward without a cache, take
    SDPA with the block-causal mask, keys and values repeated over the
    query heads."""

    def __init__(self, d_model: int, n_head: int, n_kv_head: int, d_head: int,
                 rope_theta: float = 1e6, eps: float = 1e-6):
        super().__init__()
        if n_head % n_kv_head:
            raise ValueError(f"BlockCausalAttention: {n_head} query heads over {n_kv_head} "
                             f"key/value heads")
        self.n_head, self.n_kv_head, self.d_head = n_head, n_kv_head, d_head
        self.rope_theta, self.eps = float(rope_theta), eps
        self.to_qkv = nn.Linear(d_model, (n_head + 2 * n_kv_head) * d_head, bias=False)
        self.to_out = nn.Linear(n_head * d_head, d_model, bias=False)
        self.q_norm = RMSNorm(d_head, eps)
        self.k_norm = RMSNorm(d_head, eps)

    def _qkv(self, x: torch.Tensor, pos: int):
        """q `(B, N, n_head, D)`, k and v `(B, N, n_kv_head, D)`."""
        b, n, _ = x.shape
        nq, nk = self.n_head, self.n_kv_head
        qkv = self.to_qkv(x).view(b, n, nq + 2 * nk, self.d_head)
        # q's and k's heads normed and rotated at once (each by its own scale)
        scale = torch.cat([self.q_norm.weight.expand(nq, -1), self.k_norm.weight.expand(nk, -1)])
        qk = rms_norm(qkv[:, :, : nq + nk], None, self.eps) * scale
        size = max(1024, 1 << (pos + n - 1).bit_length())
        cos, sin = _rope_table(self.rope_theta, self.d_head, size, x.dtype, str(x.device))
        qk = _rotate(qk, cos[pos: pos + n, None], sin[pos: pos + n, None])
        return qk[:, :, :nq], qk[:, :, nq:], qkv[:, :, nq + nk:]

    def forward(self, x: torch.Tensor, block: int, cache: Optional[dict] = None,
                pos: int = 0) -> torch.Tensor:
        """`(B, N, C)` tokens at positions `[pos, pos + N)`, `block` tokens
        a block (`pos` and `N` multiples of it); without a cache, `pos` is
        0 and the tokens attend among themselves."""
        b, n, _ = x.shape
        with span("attn.block"):
            q, k, v = self._qkv(x, pos)
            if cache is not None:
                cache["k"][:, :, pos: pos + n] = k.transpose(1, 2)
                cache["v"][:, :, pos: pos + n] = v.transpose(1, 2)
                if n == block:  # one block: every query sees the whole prefix
                    attn = block_attention(q, cache["k"], cache["v"], pos + n,
                                           self.d_head ** -0.5)
                    return self.to_out(attn.reshape(b, n, -1))
                k, v = cache["k"][:, :, : pos + n], cache["v"][:, :, : pos + n]
            else:
                k, v = k.transpose(1, 2), v.transpose(1, 2)
            rep = self.n_head // self.n_kv_head
            mask = block_causal_mask(n, pos, k.shape[2], block, x.device)
            attn = F.scaled_dot_product_attention(
                q.transpose(1, 2), k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1),
                attn_mask=mask)
            return self.to_out(attn.transpose(1, 2).reshape(b, n, -1))
