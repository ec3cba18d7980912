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

from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from open_genie_tpu_torch.modules.misc import ForwardBlock, per_frame_group_norm
from open_genie_tpu_torch.ops.attention import dot_product_attention
from open_genie_tpu_torch.ops.conv import conv3d_cl, time_valid_conv3d
from open_genie_tpu_torch.ops.rope import apply_rope, rope_frequencies
from open_genie_tpu_torch.parallel import collectives
from open_genie_tpu_torch.utils import default


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
        skips = (("space_skip", d_inp, space_hid), ("time_skip", space_hid, time_hid),
                 ("ffn_skip", time_hid, d_out))
        for name, c_in, c_out in skips:
            if c_in != c_out:
                self.add_module(name, nn.Conv3d(c_in, c_out, 1))

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
