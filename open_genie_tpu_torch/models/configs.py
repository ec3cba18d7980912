"""Model configurations of the port."""
from __future__ import annotations

from open_genie_tpu_torch.models.blueprints import LATENT_ACT_DEC, LATENT_ACT_ENC


def genie_compact_config() -> dict:
    """The compact rollout model the repo's parity runs use
    (`tools/parity_check.py::GENIE_CFG`, pinned equal by the tests): the
    same topology as `genie_rollout_config` at a few narrow layers."""
    return dict(
        tokenizer=dict(
            enc_desc=(
                ("spacetime_downsample", {
                    "in_channels": 3, "kernel_size": 3, "out_channels": 32,
                    "time_factor": 1, "space_factor": 4,
                }),
                ("space-time_attn", {"n_rep": 1, "n_embd": 32, "n_head": 2, "d_head": 16}),
                ("causal-conv3d", {"in_channels": 32, "out_channels": 8, "kernel_size": 1}),
            ),
            dec_desc=(
                ("causal-conv3d", {"in_channels": 8, "out_channels": 32, "kernel_size": 3}),
                ("space-time_attn", {"n_rep": 1, "n_embd": 32, "n_head": 2, "d_head": 16}),
                ("depth2spacetime_upsample", {
                    "in_channels": 32, "out_channels": 3, "kernel_size": 3,
                    "time_factor": 1, "space_factor": 4,
                }),
            ),
            d_codebook=8,
        ),
        latent_action=dict(
            enc_desc=(
                ("space-time_attn", {"n_rep": 1, "n_embd": 32, "n_head": 2, "d_head": 16}),
            ),
            dec_desc=(
                ("space-time_attn", {
                    "n_rep": 1, "n_embd": 32, "n_head": 2, "d_head": 16,
                    "has_ext": True, "time_attn_kw": {"key_dim": 4},
                }),
            ),
            d_codebook=4,
            n_embd=32,
            inp_shape=(32, 32),
        ),
        dynamics=dict(
            desc=(("space-time_attn", {"n_rep": 2, "n_embd": 64, "n_head": 4, "d_head": 16}),),
            embed_dim=64,
        ),
    )


def genie_rollout_config() -> dict:
    """The action-conditioned rollout model of the JAX package's benchmark
    (`bench.py::_genie_cfg`, pinned equal by the tests): 64x64 frames
    compressed 4x in space to a 16x16 token grid with a 10-bit codebook
    (128-wide tokenizer, 2+2 ST-attention blocks of 8 heads x 16), and a
    6-block, 512-wide ST-transformer dynamics trunk (8 heads x 64) over
    256 latent actions."""
    return dict(
        tokenizer=dict(
            enc_desc=(
                ("spacetime_downsample", {
                    "in_channels": 3, "kernel_size": 3, "out_channels": 128,
                    "time_factor": 1, "space_factor": 4,
                }),
                ("space-time_attn", {"n_rep": 2, "n_embd": 128, "n_head": 8, "d_head": 16}),
                ("causal-conv3d", {"in_channels": 128, "out_channels": 10, "kernel_size": 1}),
            ),
            dec_desc=(
                ("causal-conv3d", {"in_channels": 10, "out_channels": 128, "kernel_size": 3}),
                ("space-time_attn", {"n_rep": 2, "n_embd": 128, "n_head": 8, "d_head": 16}),
                ("depth2spacetime_upsample", {
                    "in_channels": 128, "kernel_size": 3, "out_channels": 3,
                    "time_factor": 1, "space_factor": 4,
                }),
            ),
            d_codebook=10,
        ),
        latent_action=dict(
            enc_desc=LATENT_ACT_ENC,
            dec_desc=LATENT_ACT_DEC,
            d_codebook=8,
            n_embd=256,
            inp_shape=(64, 64),
        ),
        dynamics=dict(
            desc=(("space-time_attn", {"n_rep": 6, "n_embd": 512, "n_head": 8, "d_head": 64}),),
            embed_dim=512,
        ),
    )


def genie_train_config() -> dict:
    """The Genie joint-training model of `configs/genie.yaml` (its `model:`
    block, pinned equal by the tests): a frozen 64-wide tokenizer
    compressing 64x64 frames 4x in space to a 16x16 grid of 10-bit tokens
    (4 + 4 ST blocks of 4 heads x 16, a 1x1 head, so kernel K2 fuses it),
    the stock latent-action VQ-VAE (256 wide, 4 heads x 16, 8-bit action
    codes, 4096-token spatial attention at 64x64), and a 6-block, 512-wide
    dynamics trunk of 8 heads x 64."""
    st = ("space-time_attn", {"n_rep": 4, "n_head": 4, "d_head": 16, "d_inp": 64, "d_out": 64})
    return dict(
        tokenizer=dict(
            enc_desc=(
                ("spacetime_downsample", {
                    "in_channels": 3, "kernel_size": 3, "out_channels": 64,
                    "time_factor": 1, "space_factor": 4,
                }),
                st,
                ("causal-conv3d", {"in_channels": 64, "out_channels": 10, "kernel_size": 1}),
            ),
            dec_desc=(
                ("causal-conv3d", {"in_channels": 10, "out_channels": 64, "kernel_size": 3}),
                st,
                ("depth2spacetime_upsample", {
                    "in_channels": 64, "kernel_size": 3, "out_channels": 3,
                    "time_factor": 1, "space_factor": 4,
                }),
            ),
            d_codebook=10,
        ),
        latent_action=dict(
            enc_desc=LATENT_ACT_ENC,
            dec_desc=LATENT_ACT_DEC,
            d_codebook=8,
            n_embd=256,
            inp_shape=(64, 64),
        ),
        dynamics=dict(
            desc=(("space-time_attn", {"n_rep": 6, "n_embd": 512, "n_head": 8, "d_head": 64}),),
            embed_dim=512,
        ),
    )
