"""Model configurations of the port."""
from __future__ import annotations

from pathlib import Path

from open_genie_tpu_torch.models.blueprints import (
    LATENT_ACT_DEC,
    LATENT_ACT_ENC,
    MAGVIT2_DEC_DESC,
    MAGVIT2_ENC_DESC,
    MAGVIT2_STREAM_DEC_DESC,
)

CONFIGS = Path(__file__).resolve().parents[2] / "configs"  # the repo's YAMLs


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


def genie_tp_flagship_config() -> dict:
    """The flagship split of the JAX package's multi-device dry run
    (`__graft_entry__.py::_GENIE_FLAGSHIP`, pinned equal by the tests): the
    dynamics trunk at its real 512 width (2 blocks of 8 heads x 64) over
    the real 2^18-token vocabulary, so the tensor-parallel split holds a
    512 x 262144 head and a 262144 x 512 token embedding; a thin 18-bit
    tokenizer without attention and a 32-wide latent action (2 heads x
    16) over 8x8 frames, so 2x2 token frames."""
    return dict(
        tokenizer=dict(
            enc_desc=(
                ("spacetime_downsample", {
                    "in_channels": 3, "kernel_size": 3, "out_channels": 32,
                    "time_factor": 1, "space_factor": 4,
                }),
                ("causal-conv3d", {"in_channels": 32, "out_channels": 18, "kernel_size": 1}),
            ),
            dec_desc=(
                ("causal-conv3d", {"in_channels": 18, "out_channels": 32, "kernel_size": 3}),
                ("depth2spacetime_upsample", {
                    "in_channels": 32, "out_channels": 3, "kernel_size": 3,
                    "time_factor": 1, "space_factor": 4,
                }),
            ),
            d_codebook=18,
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
            inp_shape=(8, 8),
        ),
        dynamics=dict(
            desc=(("space-time_attn", {"n_rep": 2, "n_embd": 512, "n_head": 8, "d_head": 64}),),
            embed_dim=512,
        ),
    )


def genie_serve_config() -> dict:
    """The interactive session's model of the JAX package's benchmark
    (`bench.py::_serve_cfg`, pinned equal by the tests): the full MAGVIT2
    d=18 encoder (64x64 frames, 4 frames to one 8x8 token frame of
    2^18-token vocabulary) with the `magvit2_stream` decoder (the same
    topology with per-frame causal statistics, so it streams exactly), the
    6-block, 512-wide dynamics trunk of 8 heads x 64, and a minimal latent
    action model (serving takes its actions from the user)."""
    return dict(
        tokenizer=dict(
            enc_desc=MAGVIT2_ENC_DESC,
            dec_desc=MAGVIT2_STREAM_DEC_DESC,
            d_codebook=18,
        ),
        latent_action=dict(
            enc_desc=(("space-time_attn", {"n_rep": 1, "n_embd": 64,
                                           "n_head": 2, "d_head": 32}),),
            dec_desc=(("space-time_attn", {"n_rep": 1, "n_embd": 64,
                                           "n_head": 2, "d_head": 32}),),
            d_codebook=8,
            n_embd=64,
            inp_shape=(64, 64),
        ),
        dynamics=dict(
            desc=(("space-time_attn", {"n_rep": 6, "n_embd": 512, "n_head": 8, "d_head": 64}),),
            embed_dim=512,
        ),
    )


def tokenizer_train_config() -> dict:
    """`TokenizerTrainModule` kwargs of the JAX package's tokenizer
    full-loss benchmark (`bench.py::section_tokenizer_train`, pinned equal
    by the tests): MAGVIT2 at d=18 (262,144 codes; 64x64 frames compress to
    an 8x8 grid, 8 frames to 2) with the model's default LFQ weights and
    remat, a 64-wide frame discriminator with spatial attention (4 heads x
    32) over 4 frames per video, and the VGG16 perceptual loss."""
    return dict(
        tokenizer=dict(enc_desc=MAGVIT2_ENC_DESC, dec_desc=MAGVIT2_DEC_DESC, d_codebook=18),
        disc_kwargs=dict(
            inp_size=(64, 64), model_dim=64, dim_mults=(1, 2, 4), down_step=(None, 2, 2),
            num_groups=8, use_attn=True, num_heads=4, dim_head=32,
        ),
        gan_frames_per_batch=4,
    )


def tokenizer_compact_train_config() -> dict:
    """The compact tokenizer training model of the parity checks: every
    module kind of `tokenizer_train_config()` (residual blocks with and
    without a width change, downsamplers in space and in space-time, group
    and adaptive GroupNorm, SiLU, upsamplers in space and in space-time, a
    discriminator with attention, the VGG16 taps) at widths 8 to 32, for (B, 4, 32, 32, 3) video: 2 x 8 x 8 tokens
    per video of a 13-bit codebook, so kernels K5/K6 are on its path."""
    d = 13
    return dict(
        tokenizer=dict(
            enc_desc=(
                ("causal-conv3d", {"in_channels": 3, "out_channels": 16, "kernel_size": 3}),
                ("video-residual", {"n_rep": 1, "in_channels": 16}),
                ("spacetime_downsample", {
                    "in_channels": 16, "out_channels": 16, "kernel_size": 3,
                    "time_factor": 1, "space_factor": 2,
                }),
                ("video-residual", {"in_channels": 16, "out_channels": 32}),
                ("spacetime_downsample", {
                    "in_channels": 32, "out_channels": 32, "kernel_size": 3,
                    "time_factor": 2, "space_factor": 2,
                }),
                ("video-residual", {"n_rep": 1, "in_channels": 32}),
                ("group_norm", {"num_groups": 8, "num_channels": 32}),
                ("silu", {}),
                ("causal-conv3d", {"in_channels": 32, "out_channels": d, "kernel_size": 1}),
            ),
            dec_desc=(
                ("causal-conv3d", {"in_channels": d, "out_channels": 32, "kernel_size": 3}),
                ("video-residual", {"n_rep": 1, "in_channels": 32}),
                ("adaptive_group_norm", {
                    "dim_cond": d, "num_groups": 8, "num_channels": 32, "has_ext": True,
                }),
                ("depth2spacetime_upsample", {
                    "in_channels": 32, "kernel_size": 3, "time_factor": 2, "space_factor": 2,
                }),
                ("adaptive_group_norm", {
                    "dim_cond": d, "num_groups": 8, "num_channels": 32, "has_ext": True,
                }),
                ("video-residual", {"in_channels": 32, "out_channels": 16}),
                ("depth2spacetime_upsample", {
                    "in_channels": 16, "kernel_size": 3, "time_factor": 1, "space_factor": 2,
                }),
                ("group_norm", {"num_groups": 8, "num_channels": 16}),
                ("silu", {}),
                ("causal-conv3d", {"in_channels": 16, "out_channels": 3, "kernel_size": 3}),
            ),
            d_codebook=d,
        ),
        disc_kwargs=dict(
            inp_size=(32, 32), model_dim=8, dim_mults=(1, 2, 4), down_step=(None, 2, 2),
            num_groups=4, use_attn=True, num_heads=2, dim_head=16,
        ),
        gan_frames_per_batch=2,
    )


def _repo_config(name: str, kind: str):
    """`train.config.load_config` of the repo's `configs/<name>`."""
    from open_genie_tpu_torch.train.config import load_config

    return load_config(str(CONFIGS / name), kind)


def tokenize_yaml_config() -> dict:
    """`TokenizerTrainModule` kwargs of the repo's stage-1 training config
    `configs/tokenize.yaml`, as `train tokenizer` builds them: a
    space-downsampling stem (64x64 frames to 32x32, 64 wide), 8 space-time
    blocks of 8 heads x 64 each way, so the 64-wide encoder output enters
    the 10-bit codebook through the LFQ's `proj_inp` (and the decoder takes
    it back through `proj_out`); LFQ weights 0.25 / 0.01 / 1.0; a 64-wide
    frame discriminator with spatial attention (4 heads x 32) over 4 frames
    per video; the VGG16 perceptual loss."""
    return _repo_config("tokenize.yaml", "tokenizer").model.module_kwargs()


def dynamics_yaml_config() -> dict:
    """`DynamicsTrainModule` kwargs of the repo's stage-3 training config
    `configs/dynamics.yaml`, as `train dynamics` builds them: the 6-block,
    512-wide space-time trunk of 8 heads x 64 over token grids of a 10-bit
    tokenizer (`tok_vocab` 1024) with 8-bit latent actions (`act_vocab`
    256)."""
    return {"dynamics": _repo_config("dynamics.yaml", "dynamics").model.dynamics_kwargs()}


def sdar_30b_a3b_config() -> dict:
    """SDAR-30B-A3B-Chat at its published widths
    (https://huggingface.co/JetLM/SDAR-30B-A3B-Chat/blob/main/config.json):
    a block-diffusion language model on a Qwen3-MoE body, run as a
    `DynamicsModel` whose frames are blocks of `block_length` tokens
    (a 1 x `block_length` grid) refined by MaskGIT. 48 `sdar_block`
    layers 2048 wide: grouped-query attention of 32 query and 4 key/value
    heads of 128 with per-head RMSNorm on q and k, RoPE theta 1e6; 128
    SwiGLU experts of 768, top 8 renormalised, no shared expert; RMSNorm
    eps 1e-6; a final RMSNorm and an untied, bias-free head over 151,936
    tokens; no actions. The config gives neither the block length nor the
    denoising steps a block (4 and 4 here) and the mask token is
    SDAR's `<|MASK|>`."""
    return dict(
        dynamics=dict(
            desc=(("sdar_block", {
                "n_rep": 48, "n_embd": 2048, "n_head": 32, "n_kv_head": 4, "d_head": 128,
                "n_experts": 128, "top_k": 8, "d_expert": 768, "norm_topk_prob": True,
                "rope_theta": 1000000.0, "eps": 1e-6,
            }),),
            tok_vocab=151936,
            act_vocab=None,
            embed_dim=2048,
            mask_id=151669,
            head_bias=False,
            final_norm_eps=1e-6,
        ),
        block_length=4,
        denoising_steps=4,
    )


def sdar_compact_config() -> dict:
    """`sdar_30b_a3b_config()`'s topology at test size: 2 layers 64 wide,
    GQA of 4 query and 2 key/value heads of 16, 8 experts of 32 at top 2,
    256 tokens (the last the mask), blocks of 4 tokens."""
    return dict(
        dynamics=dict(
            desc=(("sdar_block", {
                "n_rep": 2, "n_embd": 64, "n_head": 4, "n_kv_head": 2, "d_head": 16,
                "n_experts": 8, "top_k": 2, "d_expert": 32, "norm_topk_prob": True,
                "rope_theta": 1000000.0, "eps": 1e-6,
            }),),
            tok_vocab=256,
            act_vocab=None,
            embed_dim=64,
            mask_id=255,
            head_bias=False,
            final_norm_eps=1e-6,
        ),
        block_length=4,
        denoising_steps=4,
    )
