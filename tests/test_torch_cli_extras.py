"""The port's small leftovers against the JAX package on the CPU:
`modules/vgg.py::load_torch_vgg16_npz` on an npz the test writes (the
features of the loaded trunk equal JAX's `VGG16Features` on JAX's own
loader's params at atol 1e-5), `train_tokenizer` with
`model.perc_weights_npz`, and `utils/debug.py`.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from open_genie_tpu.modules import vgg as jvgg  # noqa: E402
from open_genie_tpu_torch.modules import vgg as tvgg  # noqa: E402
from open_genie_tpu_torch.train import config as tconfig  # noqa: E402
from open_genie_tpu_torch.train import trainer as ttrainer  # noqa: E402
from open_genie_tpu_torch.utils import debug  # noqa: E402
from test_torch_trainer_tokenizer import _tokenizer_yaml, _write  # noqa: E402

torch.set_num_threads(1)
TAPS = ("features.6", "features.13", "features.18", "features.25")


@pytest.fixture(scope="module")
def vgg_npz(tmp_path_factory):
    """All 13 convs of torchvision's VGG16 features, OIHW, He-scaled."""
    rng = np.random.default_rng(0)
    arrays = {}
    for idx, kind, width in tvgg.layer_schedule():
        if kind == "conv":
            fan_in = (3 if idx == 0 else prev) * 9
            arrays[f"features.{idx}.weight"] = (rng.standard_normal(
                (width, fan_in // 9, 3, 3)) * np.sqrt(2 / fan_in)).astype(np.float32)
            arrays[f"features.{idx}.bias"] = (0.1 * rng.standard_normal(width)).astype(np.float32)
            prev = width
    path = str(tmp_path_factory.mktemp("vgg") / "vgg16.npz")
    np.savez(path, **arrays)
    return path, arrays


def test_loaded_features_match_jax(vgg_npz):
    path, _ = vgg_npz
    x = np.random.default_rng(1).uniform(size=(2, 16, 16, 3)).astype(np.float32)
    jm = jvgg.VGG16Features(feat_layers=TAPS)
    template = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    loaded = jvgg.load_torch_vgg16_npz(path)["params"]
    want = jm.apply({"params": {k: loaded[k] for k in template}}, jnp.asarray(x))
    tm = tvgg.load_torch_vgg16_npz(path, tvgg.VGG16Features(TAPS))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert set(got) == set(want) == set(TAPS)
    for k in TAPS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, rtol=0,
                                   err_msg=k)


def test_missing_or_misshapen_conv_raises(vgg_npz, tmp_path):
    _, arrays = vgg_npz
    short = dict(arrays)
    del short["features.5.bias"]
    np.savez(tmp_path / "short.npz", **short)
    with pytest.raises(ValueError, match="features.5.bias"):
        tvgg.load_torch_vgg16_npz(str(tmp_path / "short.npz"), tvgg.VGG16Features(TAPS))
    # a shallower trunk takes only its own convs from the same file
    shallow = tvgg.load_torch_vgg16_npz(str(tmp_path / "short.npz"),
                                        tvgg.VGG16Features(("features.3",)))
    assert torch.equal(shallow.conv_2.weight, torch.from_numpy(arrays["features.2.weight"]))
    bad = dict(arrays, **{"features.0.weight": arrays["features.0.weight"][:, :2]})
    np.savez(tmp_path / "bad.npz", **bad)
    with pytest.raises(ValueError, match="features.0.weight has shape"):
        tvgg.load_torch_vgg16_npz(str(tmp_path / "bad.npz"), tvgg.VGG16Features(TAPS))


def test_train_tokenizer_loads_perc_weights_npz(vgg_npz, tmp_path):
    """`model.perc_weights_npz` loads into the perceptual critic, which
    stays frozen through a step; the snapshot records the path."""
    path, arrays = vgg_npz
    text = _tokenizer_yaml(str(tmp_path), "perc").replace(
        "  perc_loss_weight: 0.0\n",
        f"  perc_loss_weight: 1.0\n  perc_feat_layers: [features.6]\n"
        f"  perc_weights_npz: {path}\n")
    cfg = tconfig.load_config(_write(tmp_path / "perc.yaml", text), "tokenizer")
    cfg.trainer.max_steps, cfg.trainer.val_check_interval = 1, 0
    state = ttrainer.train_tokenizer(cfg, device="cpu")
    vgg = state.module.perc_crit.vgg
    for idx in (0, 2, 5):
        conv = getattr(vgg, f"conv_{idx}")
        assert torch.equal(conv.weight, torch.from_numpy(arrays[f"features.{idx}.weight"]))
        assert torch.equal(conv.bias, torch.from_numpy(arrays[f"features.{idx}.bias"]))
    assert ttrainer.perc_weights_status(cfg.model) == path
    with open(os.path.join(cfg.trainer.ckpt_dir, "config.yaml")) as f:
        assert f"perc_weights: {path}" in f.read()


def test_profile_trace_writes_a_trace(tmp_path):
    with debug.profile_trace(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    traces = [f for f in os.listdir(tmp_path / "prof") if f.endswith(".pt.trace.json")]
    assert len(traces) == 1 and os.path.getsize(tmp_path / "prof" / traces[0]) > 0


def test_nan_debug_raises_on_a_nan_backward():
    x = torch.zeros(1, requires_grad=True)
    debug.enable_nan_debug()
    try:
        with pytest.raises(RuntimeError, match="nan"):
            (x.sqrt() * 0).sum().backward()
    finally:
        debug.enable_nan_debug(False)
    assert not torch.is_anomaly_enabled()
    (x.sqrt() * 0).sum().backward()  # off again: the NaN gradient passes
    assert torch.isnan(x.grad).all()
