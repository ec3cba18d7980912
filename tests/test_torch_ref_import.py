"""The port's reference-checkpoint importer (`utils/torch_import.py`, `cli
import-ckpt`) against the JAX package's (`open_genie_tpu/utils/torch_import.py`).

No checkout of the PyTorch reference is needed: a reference `state_dict` is
written from seeded numpy arrays in the reference's key layout (the layout
that the JAX importer's docstrings state; `chip_smoke.reference_state_dict`,
which phase 33 writes phase 22's weights with on the card), for four blueprint
families: the compact tokenizer, residual blocks that downsample by blur or
by a strided conv, the transposed-conv and depth-to-space/time upsamplers,
and an LFQ with `proj_inp` / `proj_out`. JAX's `convert_reference_state_dict`
validates the layout (a wrong key raises there); the port's import must
equal JAX's import followed by `bridge.load_flax_params`, array for array,
exactly (a relayout). The imported tokenizers then encode, quantize and
decode one seeded input alike (ids exact, floats within
`tools/parity_check.py`'s atol 2e-3 / rtol 2e-2). Errors, key order, the
loader's three formats and `cli import-ckpt` -> `cli train tokenizer
--resume` are checked after.
"""
import argparse
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from open_genie_tpu.models.tokenizer import VideoTokenizer as JVideoTokenizer  # noqa: E402
from open_genie_tpu.utils.torch_import import ImportError_  # noqa: E402
from open_genie_tpu.utils.torch_import import (  # noqa: E402
    convert_reference_state_dict as jconvert,
)
from open_genie_tpu_torch import cli as tcli  # noqa: E402
from open_genie_tpu_torch.bridge import state_dict_from_flax  # noqa: E402
from open_genie_tpu_torch.models.configs import tokenizer_compact_train_config  # noqa: E402
from open_genie_tpu_torch.models.tokenizer import VideoTokenizer  # noqa: E402
from open_genie_tpu_torch.train import loop as tloop  # noqa: E402
from open_genie_tpu_torch.utils.torch_import import (  # noqa: E402
    ReferenceImportError,
    convert_reference_state_dict,
    load_reference_state_dict,
)
from chip_smoke import reference_state_dict  # noqa: E402

torch.set_num_threads(1)
PARITY = dict(atol=2e-3, rtol=2e-2)  # tools/parity_check.py
C = 12


def _conv(i, o, k=3, **kw):
    return ("causal-conv3d", {"in_channels": i, "out_channels": o, "kernel_size": k, **kw})


def _res(**kw):
    return ("video-residual", {"in_channels": C, "kernel_size": 3, "act_fn": "silu",
                               "num_groups": 4, **kw})


FAMILIES = {
    "compact": (dict(tokenizer_compact_train_config()["tokenizer"]), (1, 4, 32, 32, 3)),
    "residual_downsample": (dict(
        enc_desc=(_conv(3, C),
                  _res(downsample=(1, 2), use_causal=True, use_blur=True),
                  _res(downsample=(1, 2), use_causal=True, use_blur=False),
                  _res(use_causal=False, act_fn="leaky"),
                  ("group_norm", {"num_groups": 4, "num_channels": C}), ("silu", {}),
                  _conv(C, 4, 1)),
        dec_desc=(_conv(4, C), _res(use_causal=True),
                  ("depth2spacetime_upsample", {"in_channels": C, "kernel_size": 3,
                                                "time_factor": 1, "space_factor": 2}),
                  ("depth2spacetime_upsample", {"in_channels": C, "kernel_size": 3,
                                                "time_factor": 1, "space_factor": 2}),
                  _conv(C, 3)),
        d_codebook=4), (1, 4, 16, 16, 3)),
    "upsamplers": (dict(
        enc_desc=(_conv(3, C),
                  ("spacetime_downsample", {"in_channels": C, "kernel_size": 3,
                                            "time_factor": 2, "space_factor": 2}),
                  ("spacetime_downsample", {"in_channels": C, "kernel_size": 3,
                                            "time_factor": 1, "space_factor": 2}),
                  _conv(C, 4, 1)),
        dec_desc=(_conv(4, C),
                  ("adaptive_group_norm", {"num_groups": 4, "num_channels": C,
                                           "dim_cond": 4, "has_ext": True}),
                  ("causal-conv3d-transpose", {"in_channels": C, "out_channels": C,
                                               "kernel_size": 3, "stride": (2, 1, 1)}),
                  ("depth2space_upsample", {"in_channels": C, "factor": 2}),
                  ("depth2time_upsample", {"in_channels": C, "factor": 2}),
                  ("spacetime_upsample", {"in_channels": C, "kernel_size": 3,
                                          "time_factor": 1, "space_factor": 2}),
                  _conv(C, 3)),
        d_codebook=4), (1, 4, 16, 16, 3)),
    "lfq_projection": (dict(
        enc_desc=(_conv(3, C), _res(use_causal=True),
                  ("spacetime_downsample", {"in_channels": C, "kernel_size": 3,
                                            "time_factor": 2, "space_factor": 2}),
                  ("group_norm", {"num_groups": 4, "num_channels": C}), ("silu", {}),
                  _conv(C, C, 1)),
        dec_desc=(_conv(C, C),
                  ("adaptive_group_norm", {"num_groups": 4, "num_channels": C,
                                           "dim_cond": C, "has_ext": True}),
                  ("depth2spacetime_upsample", {"in_channels": C, "kernel_size": 3,
                                                "time_factor": 2, "space_factor": 2}),
                  _conv(C, 3)),
        d_codebook=4), (1, 4, 16, 16, 3)),
}


# --------------------------------------------------------------------- #
# Both importers
# --------------------------------------------------------------------- #

def _jax_template(cfg, shape):
    jm = JVideoTokenizer(**cfg)
    x = jnp.zeros(shape, jnp.float32)
    return jm, jax.jit(lambda k: jm.init(k, x))(jax.random.PRNGKey(0))["params"]


def _jax_import(sd, cfg, shape, tok):
    jm, template = _jax_template(cfg, shape)
    params, skipped = jconvert(sd, template)
    state, _ = state_dict_from_flax(jax.tree.map(np.asarray, params), tok)
    return jm, params, state, skipped


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    cfg, shape = FAMILIES[request.param]
    tok = VideoTokenizer(**cfg).eval()
    sd = reference_state_dict(tok)
    jm, jparams, jstate, jskipped = _jax_import(sd, cfg, shape, tok)
    return dict(name=request.param, cfg=cfg, shape=shape, tok=tok, sd=sd, jm=jm,
                jparams=jparams, jstate=jstate, jskipped=jskipped)


def test_import_equals_jax_import_then_bridge(family):
    state, skipped = convert_reference_state_dict(family["sd"], family["tok"])
    assert set(state) == set(family["jstate"]) == set(family["tok"].state_dict())
    for k, v in state.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), family["jstate"][k].numpy(), err_msg=k)
    assert sorted(skipped) == sorted(family["jskipped"])
    assert any(k.startswith("gan_crit.") for k in skipped)
    if family["name"] == "residual_downsample":
        assert any(k.endswith(".blur") for k in skipped)
    if family["name"] == "lfq_projection":
        assert {"quant.proj_inp.weight", "quant.proj_out.weight"} <= set(state)


def test_imported_tokenizer_encodes_quantizes_decodes_as_jax(family):
    tok = family["tok"]
    tok.load_state_dict(convert_reference_state_dict(family["sd"], tok)[0])
    jm, v = family["jm"], {"params": family["jparams"]}
    video = np.random.default_rng(3).standard_normal(family["shape"]).astype(np.float32)
    j_enc = jm.apply(v, jnp.asarray(video), method=jm.encode)
    (j_quant, j_idx), _, _ = jm.apply(v, j_enc, method=jm.quantize)
    j_rec = jm.apply(v, j_quant, method=jm.decode)
    with torch.no_grad():
        enc = tok.encode(torch.from_numpy(video))
        (quant, idx), _, _ = tok.quantize(enc)
        rec = tok.decode(quant)
    np.testing.assert_allclose(enc.numpy(), np.asarray(j_enc), **PARITY)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(quant.numpy(), np.asarray(j_quant), **PARITY)
    np.testing.assert_allclose(rec.numpy(), np.asarray(j_rec), **PARITY)


def test_port_weights_round_trip(family):
    """The port's own weights written in the reference layout (as phase 33
    writes phase 22's checkpoint) import back bit for bit."""
    tok = VideoTokenizer(**family["cfg"])
    want = tok.state_dict()
    got, _ = convert_reference_state_dict(reference_state_dict(tok, want), tok)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_key_order_does_not_matter(family):
    """An `.npz` keeps no registration order: sorted and reversed keys
    import identically."""
    want, _ = convert_reference_state_dict(family["sd"], family["tok"])
    for order in (sorted(family["sd"]), sorted(family["sd"], reverse=True)):
        got, _ = convert_reference_state_dict({k: family["sd"][k] for k in order}, family["tok"])
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)


# --------------------------------------------------------------------- #
# Errors: the same cases as JAX's, naming the same key
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def small():
    cfg, shape = FAMILIES["lfq_projection"]
    tok = VideoTokenizer(**cfg)
    _, template = _jax_template(cfg, shape)
    return cfg, shape, tok, template, reference_state_dict(tok)


def _both_raise(sd, tok, template):
    with pytest.raises(ImportError_) as j:
        jconvert(sd, template)
    with pytest.raises(ReferenceImportError) as t:
        convert_reference_state_dict(sd, tok)
    assert issubclass(ReferenceImportError, ValueError)
    return str(j.value), str(t.value)


def test_missing_key_raises_as_jax(small):
    _, _, tok, template, sd = small
    sd = dict(sd)
    del sd["enc_layers.1.main.2.conv3d.weight"]
    j, t = _both_raise(sd, tok, template)
    for msg in (j, t):
        assert "'main.2.conv3d.weight'" in msg or "main.2" in msg, msg
    assert "enc_layers.1" in t and "enc_layers_1" in j


def test_leftover_key_raises_as_jax(small):
    _, _, tok, template, sd = small
    sd = dict(sd, **{"dec_layers.1.extra.weight": np.zeros(3, np.float32)})
    j, t = _both_raise(sd, tok, template)
    for msg in (j, t):
        assert "unconsumed" in msg and "extra.weight" in msg, msg


def test_mismatched_blueprint_raises_as_jax(small):
    cfg, shape, _, _, sd = small
    bad = dict(cfg, enc_desc=cfg["enc_desc"][:1] + cfg["enc_desc"][2:])  # drop a layer
    tok = VideoTokenizer(**bad)
    _, template = _jax_template(bad, shape)
    _both_raise(sd, tok, template)


def test_wrong_shape_raises_as_jax(small):
    _, _, tok, template, sd = small
    sd = dict(sd)
    w = sd["dec_layers.0.conv3d.weight"]
    sd["dec_layers.0.conv3d.weight"] = np.zeros((w.shape[0] + 1,) + w.shape[1:], np.float32)
    j, t = _both_raise(sd, tok, template)
    assert "dec_layers_0/conv3d/kernel" in j and "shape" in j, j
    assert "dec_layers.0.conv3d.weight" in t and "shape" in t, t


# --------------------------------------------------------------------- #
# The loader, and `cli import-ckpt` -> `cli train tokenizer --resume`
# --------------------------------------------------------------------- #

def test_loader_reads_npz_state_dict_and_lightning_checkpoints(small, tmp_path, capsys):
    sd = small[4]
    np.savez(tmp_path / "ref.npz", **sd)
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, tmp_path / "ref.pt")
    # A Lightning checkpoint: tensors under `state_dict`, beside metadata
    # of a class that cannot be imported where it is loaded.
    meta = types.ModuleType("lightning_meta_stub")

    class AttributeDict(dict):
        pass

    AttributeDict.__module__ = meta.__name__
    AttributeDict.__qualname__ = "AttributeDict"
    meta.AttributeDict = AttributeDict
    sys.modules[meta.__name__] = meta
    try:
        torch.save({"state_dict": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                    "hyper_parameters": AttributeDict(lr=1e-3), "epoch": 3},
                   tmp_path / "ref.ckpt")
    finally:
        del sys.modules[meta.__name__]
    for name in ("ref.npz", "ref.pt", "ref.ckpt"):
        got = load_reference_state_dict(str(tmp_path / name))
        assert set(got) == set(sd), name
        for k in sd:
            np.testing.assert_array_equal(got[k], sd[k], err_msg=f"{name}: {k}")
        printed = capsys.readouterr().out
        assert ("weights-only load failed" in printed) == (name == "ref.ckpt"), name


def _tokenizer_kwargs(path):
    from open_genie_tpu_torch.train.config import load_config

    return load_config(path, kind="tokenizer").model.tokenizer_kwargs()


RESUME_YAML = """\
seed_everything: 5
model:
  enc_desc:
    - [causal-conv3d, {{in_channels: 3, out_channels: 8, kernel_size: 3}}]
    - [spacetime_downsample, {{in_channels: 8, kernel_size: 3, time_factor: 1, space_factor: 4}}]
    - [causal-conv3d, {{in_channels: 8, out_channels: 4, kernel_size: 1}}]
  dec_desc:
    - [causal-conv3d, {{in_channels: 4, out_channels: 8, kernel_size: 3}}]
    - [depth2spacetime_upsample, {{in_channels: 8, out_channels: 3, kernel_size: 3, time_factor: 1, space_factor: 4}}]
  d_codebook: 4
  disc_kwargs: {{inp_size: [16, 16], model_dim: 8, dim_mults: [1, 2], down_step: [null, 2], num_groups: 4, use_attn: false}}
  gan_frames_per_batch: 2
  perc_loss_weight: 1.0
  perc_feat_layers: [features.3]
  optimizer: {{lr: 1e-3, ema_decay: 0.9}}
data: {{source: synthetic, num_frames: 4, batch_size: 2, height: 16, width: 16, num_videos: 8, num_workers: 1}}
trainer: {{max_steps: 1, precision: "32", log_every_n_steps: 1, ckpt_every_n_steps: 1, n_data: 1, ckpt_dir: {ckpt}, log_dir: {logs}}}
"""


def test_cli_import_then_resume_continues_from_step0(tmp_path):
    """`import-ckpt` writes step 0 in the trainer's layout (the VGG frozen
    in the optimizer, as `train tokenizer` builds it); `train tokenizer
    --resume` restores it, keeps it, and takes step 1 from the imported
    weights, which step 0 holds bit for bit."""
    ckpt, logs = tmp_path / "ckpt", tmp_path / "logs"
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(RESUME_YAML.format(ckpt=ckpt, logs=logs))
    tok = VideoTokenizer(**_tokenizer_kwargs(str(cfg)))
    sd = reference_state_dict(tok, seed=9)
    np.savez(tmp_path / "ref.npz", **sd)
    want, _ = convert_reference_state_dict(sd, tok)

    tcli.main(["import-ckpt", "--ckpt", str(tmp_path / "ref.npz"), "--config", str(cfg),
               "--out", str(ckpt)])
    step0, step = tloop.load_checkpoint(str(ckpt))
    assert step == 0 and step0["train_state"]["step"] == 0
    for k, v in want.items():
        assert torch.equal(step0["params"]["model." + k], v), k
    ema = step0["train_state"]["optimizer"]["ema"]
    assert all(torch.equal(ema["model." + k], v) for k, v in want.items())

    tcli.main(["train", "tokenizer", "--config", str(cfg), "--resume", "--device", "cpu"])
    assert tloop.all_steps(str(ckpt)) == [0, 1], "the imported step-0 checkpoint was purged"
    step1, _ = tloop.load_checkpoint(str(ckpt), 1)
    assert step1["train_state"]["step"] == 1
    moved = max(float((step1["params"]["model." + k] - v).abs().max()) for k, v in want.items())
    assert 0 < moved <= 2e-3, moved  # one AdamW step of lr 1e-3 from the import
    for k, v in step0["params"].items():
        if k.startswith("perc_crit."):
            assert torch.equal(step1["params"][k], v), k


def test_import_ckpt_help_says_it_runs_on_the_cpu():
    sub = next(a for a in tcli.build_parser()._actions
               if isinstance(a, argparse._SubParsersAction))
    text = " ".join(a.help for a in sub._choices_actions if a.dest == "import-ckpt")
    assert "runs on the CPU" in text, text
