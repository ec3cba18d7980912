"""Pre-made model blueprints (a copy of `open_genie_tpu.models.blueprints`,
pinned equal to it by `tests/test_torch_modules.py`).

Counterparts of the reference's stock blueprints:
  * MAGVIT2_ENC/DEC (reference `genie/tokenizer.py:24-173`) -- the
    causal-conv tokenizer; total compression T/4, H/8, W/8 -> 18-bit tokens.
  * REPR_TOK_ENC/DEC (`tokenizer.py:175-205`) -- transformer tokenizer.
  * LATENT_ACT_ENC/DEC (`genie/__init__.py:10-54`) -- latent-action VQ-VAE
    trunks (with the stale `spacetime_upsample` registry entry now actually
    provided, and `n_embd` honored as d_inp/d_out).

Layer kwargs are identical to the reference so its YAML configs load
verbatim.
"""
from open_genie_tpu_torch.utils import Blueprint

MAGVIT2_ENC_DESC: Blueprint = (
    ("causal-conv3d", {"in_channels": 3, "out_channels": 128, "kernel_size": 3}),
    ("video-residual", {"n_rep": 4, "in_channels": 128}),
    ("spacetime_downsample", {
        "in_channels": 128, "out_channels": 128, "kernel_size": 3,
        "time_factor": 1, "space_factor": 2,
    }),
    ("video-residual", {"in_channels": 128, "out_channels": 256}),
    ("video-residual", {"n_rep": 3, "in_channels": 256}),
    ("spacetime_downsample", {
        "in_channels": 256, "out_channels": 256, "kernel_size": 3,
        "time_factor": 2, "space_factor": 2,
    }),
    ("video-residual", {"n_rep": 4, "in_channels": 256}),
    ("spacetime_downsample", {
        "in_channels": 256, "out_channels": 256, "kernel_size": 3,
        "time_factor": 2, "space_factor": 2,
    }),
    ("video-residual", {"in_channels": 256, "out_channels": 512}),
    ("video-residual", {"n_rep": 7, "in_channels": 512}),
    ("group_norm", {"num_groups": 8, "num_channels": 512}),
    ("silu", {}),
    ("causal-conv3d", {"in_channels": 512, "out_channels": 18, "kernel_size": 1}),
)

MAGVIT2_DEC_DESC: Blueprint = (
    ("causal-conv3d", {"in_channels": 18, "out_channels": 512, "kernel_size": 3}),
    ("video-residual", {"n_rep": 4, "in_channels": 512}),
    ("adaptive_group_norm", {
        "dim_cond": 18, "num_groups": 8, "num_channels": 512, "has_ext": True,
    }),
    ("video-residual", {"n_rep": 4, "in_channels": 512}),
    ("depth2spacetime_upsample", {
        "in_channels": 512, "kernel_size": 3, "time_factor": 2, "space_factor": 2,
    }),
    ("adaptive_group_norm", {
        "dim_cond": 18, "num_groups": 8, "num_channels": 512, "has_ext": True,
    }),
    ("video-residual", {"in_channels": 512, "out_channels": 256}),
    ("video-residual", {"n_rep": 3, "in_channels": 256}),
    ("depth2spacetime_upsample", {
        "in_channels": 256, "kernel_size": 3, "time_factor": 2, "space_factor": 2,
    }),
    ("adaptive_group_norm", {
        "dim_cond": 18, "num_groups": 8, "num_channels": 256, "has_ext": True,
    }),
    ("video-residual", {"n_rep": 4, "in_channels": 256}),
    ("depth2spacetime_upsample", {
        "in_channels": 256, "kernel_size": 3, "time_factor": 1, "space_factor": 2,
    }),
    ("adaptive_group_norm", {
        "dim_cond": 18, "num_groups": 8, "num_channels": 256, "has_ext": True,
    }),
    ("video-residual", {"in_channels": 256, "out_channels": 128}),
    ("video-residual", {"n_rep": 3, "in_channels": 128}),
    ("group_norm", {"num_groups": 8, "num_channels": 128}),
    ("silu", {}),
    ("causal-conv3d", {"in_channels": 128, "out_channels": 3, "kernel_size": 3}),
)

# Serving-grade flagship decoder: identical topology/widths to
# MAGVIT2_DEC_DESC (same convs, same adaptive conditioning on the quant
# latents) but strictly TIME-CAUSAL, so `VideoTokenizer.stream_decodable()`
# holds and interactive serving decodes each new frame in O(1) work
# (`decode_stream`) instead of re-decoding a sliding pixel window:
#   * residual blocks use causal convs + per-frame GroupNorm statistics,
#   * adaptive/plain GroupNorms compute per-frame statistics, with the
#     adaptive affine read from the CURRENT token frame's latents only.
# The reference has no serving path at all (its Genie class is
# non-functional, reference `genie/genie.py:39-58`); the stock
# time-pooled-GN decoder (`tokenizer.py:87-173`) is kept above for parity.
MAGVIT2_STREAM_DEC_DESC: Blueprint = (
    ("causal-conv3d", {"in_channels": 18, "out_channels": 512, "kernel_size": 3}),
    ("video-residual", {
        "n_rep": 4, "in_channels": 512, "use_causal": True,
        "per_frame_norm": True,
    }),
    ("adaptive_group_norm", {
        "dim_cond": 18, "num_groups": 8, "num_channels": 512,
        "has_ext": True, "per_frame": True,
    }),
    ("video-residual", {
        "n_rep": 4, "in_channels": 512, "use_causal": True,
        "per_frame_norm": True,
    }),
    ("depth2spacetime_upsample", {
        "in_channels": 512, "kernel_size": 3, "time_factor": 2, "space_factor": 2,
    }),
    ("adaptive_group_norm", {
        "dim_cond": 18, "num_groups": 8, "num_channels": 512,
        "has_ext": True, "per_frame": True,
    }),
    ("video-residual", {
        "in_channels": 512, "out_channels": 256, "use_causal": True,
        "per_frame_norm": True,
    }),
    ("video-residual", {
        "n_rep": 3, "in_channels": 256, "use_causal": True,
        "per_frame_norm": True,
    }),
    ("depth2spacetime_upsample", {
        "in_channels": 256, "kernel_size": 3, "time_factor": 2, "space_factor": 2,
    }),
    ("adaptive_group_norm", {
        "dim_cond": 18, "num_groups": 8, "num_channels": 256,
        "has_ext": True, "per_frame": True,
    }),
    ("video-residual", {
        "n_rep": 4, "in_channels": 256, "use_causal": True,
        "per_frame_norm": True,
    }),
    ("depth2spacetime_upsample", {
        "in_channels": 256, "kernel_size": 3, "time_factor": 1, "space_factor": 2,
    }),
    ("adaptive_group_norm", {
        "dim_cond": 18, "num_groups": 8, "num_channels": 256,
        "has_ext": True, "per_frame": True,
    }),
    ("video-residual", {
        "in_channels": 256, "out_channels": 128, "use_causal": True,
        "per_frame_norm": True,
    }),
    ("video-residual", {
        "n_rep": 3, "in_channels": 128, "use_causal": True,
        "per_frame_norm": True,
    }),
    ("group_norm", {"num_groups": 8, "num_channels": 128, "per_frame": True}),
    ("silu", {}),
    ("causal-conv3d", {"in_channels": 128, "out_channels": 3, "kernel_size": 3}),
)

REPR_TOK_ENC: Blueprint = (
    ("spacetime_downsample", {
        "in_channels": 3, "kernel_size": 3, "out_channels": 512,
        "time_factor": 1, "space_factor": 4,
    }),
    ("space-time_attn", {"n_rep": 8, "n_head": 8, "d_head": 64}),
)

REPR_TOK_DEC: Blueprint = (
    ("space-time_attn", {"n_rep": 8, "n_head": 8, "d_head": 64}),
    ("depth2spacetime_upsample", {
        "in_channels": 512, "kernel_size": 3, "out_channels": 3,
        "time_factor": 1, "space_factor": 4,
    }),
)

LATENT_ACT_ENC: Blueprint = (
    ("space-time_attn", {"n_rep": 2, "n_embd": 256, "n_head": 4, "d_head": 16}),
    ("spacetime_downsample", {
        "in_channels": 256, "kernel_size": 3, "time_factor": 1, "space_factor": 2,
    }),
    ("space-time_attn", {"n_rep": 2, "n_embd": 256, "n_head": 4, "d_head": 16}),
)

LATENT_ACT_DEC: Blueprint = (
    ("space-time_attn", {
        "n_rep": 2, "n_embd": 256, "n_head": 4, "d_head": 16,
        "has_ext": True, "time_attn_kw": {"key_dim": 8},
    }),
    ("spacetime_upsample", {
        "in_channels": 256, "kernel_size": 3, "time_factor": 1, "space_factor": 2,
    }),
    ("space-time_attn", {
        "n_rep": 2, "n_embd": 256, "n_head": 4, "d_head": 16,
        "has_ext": True, "time_attn_kw": {"key_dim": 8},
    }),
)

# Default MaskGIT dynamics trunk (the reference leaves this to an undefined
# `TEST_DESC`, `genie/genie.py:56`; this is the intended ST-transformer).
DYNAMICS_DESC: Blueprint = (
    ("space-time_attn", {"n_rep": 6, "n_embd": 512, "n_head": 8, "d_head": 64}),
)


def get_enc(name: str) -> Blueprint:
    try:
        return {"magvit2": MAGVIT2_ENC_DESC, "repr_tok": REPR_TOK_ENC}[name]
    except KeyError:
        raise ValueError(f"Unknown encoder: {name}")


def get_dec(name: str) -> Blueprint:
    try:
        return {
            "magvit2": MAGVIT2_DEC_DESC,
            "magvit2_stream": MAGVIT2_STREAM_DEC_DESC,
            "repr_tok": REPR_TOK_DEC,
        }[name]
    except KeyError:
        raise ValueError(f"Unknown decoder: {name}")
