"""The limit that `chip_smoke.py` and the card tests hold bf16 K1, K3 and K4
to (`chip_smoke.bf16_excess`): it passes an output that differs from the f32
result only by a sound bf16 kernel's rounding, and fails one that skips a
64-row tile, at the sequence lengths of the paths. Plain PyTorch on the CPU.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from open_genie_tpu_torch.ops.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd_plain,
    flash_attention_plain,
)

TILE = 64
CASES = [(256, 64), (1024, 16), (4096, 16)]  # (N, D) of the dynamics and latent action


def _inputs(n, d):
    g = torch.Generator().manual_seed(n + d)
    return [torch.randn(1, n, d, generator=g).bfloat16().float() for _ in range(4)]


def _skip(n, tile):
    keep = torch.ones(n, dtype=torch.bool)
    keep[tile * TILE:(tile + 1) * TILE] = False
    return keep


@pytest.mark.parametrize("n,d", CASES)
def test_bf16_limit_passes_rounding_and_fails_a_skipped_key_tile(n, d):
    """K1's o: p rounded to bf16 before P.V and o rounded to bf16 pass; the
    same with one key tile left out fails."""
    q, k, v, _ = _inputs(n, d)
    scale = d ** -0.5
    ref, _ = flash_attention_plain(q, k, v, scale)

    def kernel_like(keys):
        s = q @ k[:, keys].transpose(-1, -2) * scale
        p = torch.exp(s - s.amax(-1, keepdim=True))
        o = p.bfloat16().float() @ v[:, keys] / p.sum(-1, keepdim=True)
        return o.bfloat16()

    assert chip_smoke.bf16_excess(kernel_like(torch.ones(n, dtype=torch.bool)), ref) <= 1
    for tile in (0, n // TILE - 1):
        assert chip_smoke.bf16_excess(kernel_like(_skip(n, tile)), ref) > 10


@pytest.mark.parametrize("n,d", CASES)
def test_bf16_limit_passes_rounding_and_fails_a_skipped_query_tile(n, d):
    """K3's dk and dv: the twin's result rounded to bf16 passes; the same
    with one query tile's contributions left out (its dO zero) fails."""
    q, k, v, do = _inputs(n, d)
    scale = d ** -0.5
    o, lse = flash_attention_plain(q, k, v, scale)
    o = o.bfloat16().float()
    _, dk, dv = flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
    assert chip_smoke.bf16_excess(dk.bfloat16(), dk) <= 1
    assert chip_smoke.bf16_excess(dv.bfloat16(), dv) <= 1
    for tile in (0, n // TILE - 1):
        skipped = do * _skip(n, tile)[:, None]
        _, dk_s, dv_s = flash_attention_bwd_plain(q, k, v, o, lse, skipped, scale)
        assert chip_smoke.bf16_excess(dk_s.bfloat16(), dk) > 10
        assert chip_smoke.bf16_excess(dv_s.bfloat16(), dv) > 10


# --------------------------------------------------------------------- #
# The trainer phases' checks (20 to 22)
# --------------------------------------------------------------------- #

def test_anneal_scales_follow_the_trainer_schedule():
    """`anneal_scales` is the trainer's `bit_balance_scale` step by step:
    1 until the start, linear over the ramp, then held at the floor."""
    from open_genie_tpu_torch.train.trainer import _entropy_anneal_kwargs

    class Cfg:
        lfq_bit_balance_anneal_start, lfq_bit_balance_anneal_steps = 2, 4
        lfq_bit_balance_anneal_floor = 0.05

    schedule = _entropy_anneal_kwargs(Cfg())["bit_balance_scale"]
    want = chip_smoke.anneal_scales(9, 2, 4, 0.05)
    assert want == [schedule(s) for s in range(9)]
    assert want == [1.0, 1.0, 1.0, 0.75, 0.5, 0.25, 0.05, 0.05, 0.05]


def _ema_trace(decay, steps, skip_at=None, walk=1e-1, fault=None):
    """Per update of a random walk of parameters: the parameters before and
    after and the EMA after, the EMA updated in f32 as `loop.AdamW` does.
    `fault`: "frozen" leaves the EMA at its start, "before" takes it from
    the parameters before the update."""
    g = torch.Generator().manual_seed(0)
    p = torch.randn(64, generator=g)
    ema, trace = p.clone(), []
    for k in range(steps):
        before = p.clone()
        p = p + walk * torch.randn(64, generator=g)
        if k != skip_at and fault != "frozen":  # an update that leaves the EMA behind
            ema.mul_(decay).add_(before if fault == "before" else p, alpha=1.0 - decay)
        trace.append({"before": {"w": before}, "after": {"w": p.clone()},
                      "ema": {"w": ema.clone()}})
    return trace


def _adam_like_trace(fault=None):
    """Phase 22's motion: 8 updates of parameters of magnitude ~0.05, each
    value stepping in a fixed direction by the lr of warm-up 2 then cosine
    to 8 at 5e-4 (Adam's first steps move each value by about the lr)."""
    g = torch.Generator().manual_seed(1)
    p = 0.05 * torch.randn(4096, generator=g)
    direction = torch.randn(4096, generator=g).sign()
    lrs = [5e-4 * min(s / 2, 1.0) * (0.5 + 0.5 * math.cos(math.pi * max(s - 2, 0) / 6))
           for s in range(8)]
    ema, trace = p.clone(), []
    for lr in lrs:
        before = p.clone()
        p = p + lr * direction
        if fault != "frozen":
            ema.mul_(0.999).add_(before if fault == "before" else p, alpha=1.0 - 0.999)
        trace.append({"before": {"w": before}, "after": {"w": p.clone()},
                      "ema": {"w": ema.clone()}})
    return trace


def test_ema_recursion_check_passes_f32_and_catches_a_wrong_update():
    err, ema, _, _ = chip_smoke.ema_recursion_error(_ema_trace(0.999, 8), 0.999)
    assert err <= 1 and ema["w"].dtype == torch.float64
    bad, _, _, _ = chip_smoke.ema_recursion_error(_ema_trace(0.999, 8, skip_at=5), 0.999)
    assert bad > 1
    wrong_decay, _, _, _ = chip_smoke.ema_recursion_error(_ema_trace(0.99, 8), 0.999)
    assert wrong_decay > 1
    for fault in ("frozen", "before"):
        bad, _, _, _ = chip_smoke.ema_recursion_error(_ema_trace(0.999, 8, fault=fault), 0.999)
        assert bad > 1, fault


def test_ema_recursion_check_has_teeth_at_phase_22s_motion():
    """At the motion of phase 22's 8 updates the EMA moves far beyond its
    f32 bound, and an EMA left at its start or taken before the update
    fails."""
    err, _, bound, moved = chip_smoke.ema_recursion_error(_adam_like_trace(), 0.999)
    assert err <= 1 and moved > 10
    for fault in ("frozen", "before"):
        bad, _, _, _ = chip_smoke.ema_recursion_error(_adam_like_trace(fault), 0.999)
        assert bad > 1, fault


def test_yaml_copy_overrides_only_what_it_names(tmp_path):
    import yaml

    path = chip_smoke.yaml_copy("dynamics.yaml", tmp_path, {
        "data": {"root": "shards"}, "model": {"optimizer": {"warmup_steps": 2}},
        **chip_smoke.trainer_overrides(tmp_path / "run", max_steps=8)})
    with open(path) as f:
        got = yaml.safe_load(f)
    with open(chip_smoke.HERE / "configs" / "dynamics.yaml") as f:
        ref = yaml.safe_load(f)
    assert got["data"] == {**ref["data"], "root": "shards"}
    assert got["model"]["optimizer"] == {**ref["model"]["optimizer"], "warmup_steps": 2}
    assert got["model"]["dynamics"] == ref["model"]["dynamics"]
    assert got["trainer"] == {**ref["trainer"], "max_steps": 8, "log_every_n_steps": 1,
                              "ckpt_dir": str(tmp_path / "run" / "ckpt"),
                              "log_dir": str(tmp_path / "run" / "logs")}


def _jax_reports():
    """The report of each JAX harness on the compact model, one batch."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    import numpy as np

    from open_genie_tpu import eval as jeval
    from open_genie_tpu.models.dynamics import DynamicsModel as JDynamics
    from open_genie_tpu.models.genie import Genie as JGenie
    from open_genie_tpu.models.tokenizer import VideoTokenizer as JTokenizer
    from tools.parity_check import GENIE_CFG

    jm = JGenie(**GENIE_CFG)
    key = jax.random.PRNGKey(0)
    video = np.random.default_rng(0).uniform(size=(1, 2, 32, 32, 3)).astype(np.float32)
    params = jax.jit(lambda k: jm.init(k, jnp.zeros((1, 2, 32, 32, 3)), k,
                                       method=jm.init_full))(key)["params"]
    tokens = {"tokens": np.zeros((1, 2, 4, 4), np.int32), "actions": np.zeros((1, 2), np.int32)}
    return {
        "EVAL_TOKENIZER_KEYS": jeval.evaluate_tokenizer(
            JTokenizer(**GENIE_CFG["tokenizer"]), {"params": params["tokenizer_"]}, [video]),
        "EVAL_GENIE_KEYS": jeval.evaluate_genie(jm, params, [video], key),
        "CONTROLLABILITY_KEYS": jeval.action_controllability(
            jm, {"params": params}, jnp.asarray(video[:, :1]), key, num_frames=1,
            steps_per_frame=1, n_branches=2),
        "EVAL_DYNAMICS_KEYS": jeval.evaluate_dynamics(
            JDynamics(**GENIE_CFG["dynamics"], tok_vocab=256, act_vocab=16),
            params["dynamics_"], [tokens], key),
    }


def test_report_keys_are_the_jax_packages_and_check_report_holds_them():
    """Phases 24 and 26 hold the CLI's reports to the JAX harnesses' keys
    (`chip_smoke.EVAL_*_KEYS`): the sets are those keys, and `check_report`
    fails a missing or extra key and a non-finite value."""
    for name, report in _jax_reports().items():
        keys = getattr(chip_smoke, name)
        assert set(report) == keys, name
        chip_smoke.check_report(name, dict(report), keys)
        first = sorted(report)[0]
        for bad in ({k: v for k, v in report.items() if k != first},
                    {**report, "extra": 1.0}, {**report, first: float("nan")}):
            with pytest.raises(AssertionError):
                chip_smoke.check_report(name, bad, keys)


def test_native_epoch_check_catches_a_wrong_or_missing_batch(tmp_path):
    """Phase 23's check of the native loader's first epoch against the
    clips and starts it documents: it passes the loader and fails one that
    serves its batches in another order or stops a batch early."""
    import numpy as np

    from open_genie_tpu_torch.data import native

    path = str(tmp_path / "c.gvid")
    native.write_gvid(path, np.random.default_rng(0).integers(
        0, 256, (6, 5, 4, 4, 3), dtype=np.uint8))
    ds = native.GVidDataset(path, num_frames=3)
    assert chip_smoke.native_epoch_matches(native.NativeBatchLoader(ds, 2, seed=1), ds) == 3

    class Swapped(native.NativeBatchLoader):
        def __iter__(self):
            batches = list(super().__iter__())
            return iter(batches[::-1])

    class Short(native.NativeBatchLoader):
        def __iter__(self):
            return iter(list(super().__iter__())[:-1])

    for bad in (Swapped, Short):
        with pytest.raises(AssertionError):
            chip_smoke.native_epoch_matches(bad(ds, 2, seed=1), ds)


def test_alt_blueprints_are_the_stock_ones_with_the_new_modules():
    """Phase 28's blueprints from MAGVIT2 d=18's: the encoder's three
    downsampling stages become residual blocks (a blur of (1, 2), strided
    causal convs padded by edge replication, a blur of an int 2), with a
    spatial and a causal temporal attention at 512 before its last norm;
    the decoders swap each joint upsampler for depth-to-time then
    depth-to-space, or for a 3x3x3 causal transposed conv. Everything else
    is the stock blueprint's."""
    from open_genie_tpu_torch.models import blueprints as bp

    enc = chip_smoke.alt_encoder(bp.MAGVIT2_ENC_DESC)
    new = [d for d in enc if d not in bp.MAGVIT2_ENC_DESC]
    assert new == [
        ("video-residual", {"in_channels": 128, "downsample": [1, 2]}),
        ("video-residual", {"in_channels": 256, "downsample": [2, 2], "use_blur": False,
                            "use_causal": True, "pad_mode": "replicate"}),
        ("video-residual", {"in_channels": 256, "downsample": 2}),
        ("space_attn", {"n_head": 8, "d_head": 64, "d_inp": 512, "d_out": 512}),
        ("time_attn", {"n_head": 8, "d_head": 64, "d_inp": 512, "d_out": 512, "causal": True}),
    ]
    assert [d for d in bp.MAGVIT2_ENC_DESC if d[0] != "spacetime_downsample"] == [
        d for d in enc if d[0] not in ("space_attn", "time_attn") and d not in new[:3]]
    assert enc[-4][0] == "time_attn" and enc[-3][0] == "group_norm"

    stream = chip_smoke.alt_stream_decoder(bp.MAGVIT2_STREAM_DEC_DESC)
    assert [d for d in stream if "upsample" in d[0]] == [
        ("depth2time_upsample", {"in_channels": 512, "factor": 2}),
        ("depth2space_upsample", {"in_channels": 512, "factor": 2}),
        ("depth2time_upsample", {"in_channels": 256, "factor": 2}),
        ("depth2space_upsample", {"in_channels": 256, "factor": 2}),
        ("depth2space_upsample", {"in_channels": 256, "factor": 2})]
    tconv = chip_smoke.alt_tconv_decoder(bp.MAGVIT2_DEC_DESC)
    assert [d[1]["stride"] for d in tconv if d[0] == "causal-conv3d-transpose"] == [
        [2, 2, 2], [2, 2, 2], [1, 2, 2]]
    for alt, stock in ((stream, bp.MAGVIT2_STREAM_DEC_DESC), (tconv, bp.MAGVIT2_DEC_DESC)):
        assert [d for d in alt if "upsample" not in d[0] and "transpose" not in d[0]] == [
            d for d in stock if d[0] != "depth2spacetime_upsample"]
    with pytest.raises(AssertionError, match="fewer downsampling stages"):
        chip_smoke.alt_encoder(bp.MAGVIT2_ENC_DESC[:3])


def test_compact_twins_divide_every_width_but_pixels_and_codes():
    compact = chip_smoke.alt_tokenizers(16)
    widths = {kw[k] for desc in (compact["stream"]["enc_desc"], compact["tconv"]["dec_desc"])
              for _, kw in desc for k in ("in_channels", "out_channels", "num_channels",
                                          "d_inp", "d_out") if k in kw}
    assert widths == {3, 8, 16, 18, 32}
    assert chip_smoke.scale_widths((("causal-conv3d", {"in_channels": 3, "out_channels": 128,
                                                       "kernel_size": 3}),), 16) == (
        ("causal-conv3d", {"in_channels": 3, "out_channels": 8, "kernel_size": 3}),)
    cfg = chip_smoke.video_disc_train_config({"gan_discriminate": "frames", "disc_kwargs": {}},
                                             chip_smoke.VIDEO_DISC_KWARGS)
    assert cfg["gan_discriminate"] == "video" and cfg["disc_kwargs"]["inp_size"] == (8, 64, 64)
