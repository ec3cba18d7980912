"""The port's `generate` and `play` against the JAX package's CLI on the CPU
(`eval` in `tests/test_torch_cli_eval.py`, on the checkpoints made here).

One tiny genie YAML, one tiny tokenizer YAML and one tiny dynamics YAML
(written here). Each checkpoint holds the same weights twice over: the JAX
package's initialization with an EMA made distinct from the parameters,
saved by the JAX loop, and the same trees through `bridge.load_flax_params`
saved by the port's loop. Both CLIs then run with the same flags. At
`--top-k 1` the sampled tokens do not depend on the noise, so `generate`
and `play` must give JAX's tokens exactly and its pixels within
`tools/parity_check.py`'s tolerances, and print JAX's lines.
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from open_genie_tpu import cli as jcli  # noqa: E402
from open_genie_tpu.models.tokenizer import VideoTokenizer as JTokenizer  # noqa: E402
from open_genie_tpu.train import loop as jloop  # noqa: E402
from open_genie_tpu.train import trainer as jtrainer  # noqa: E402
from open_genie_tpu.train.config import load_config as jload_config  # noqa: E402
from open_genie_tpu.train.losses import GenieTrainModule as JGenieTrainModule  # noqa: E402
from open_genie_tpu.train.losses import frozen_param_mask as jfrozen_param_mask  # noqa: E402
from open_genie_tpu_torch import cli as tcli  # noqa: E402
from open_genie_tpu_torch.bridge import load_flax_params  # noqa: E402
from open_genie_tpu_torch.models.tokenizer import VideoTokenizer  # noqa: E402
from open_genie_tpu_torch.train import loop as tloop  # noqa: E402
from open_genie_tpu_torch.train import trainer as ttrainer  # noqa: E402
from open_genie_tpu_torch.train.config import load_config as tload_config  # noqa: E402
from open_genie_tpu_torch.train.losses import GenieTrainModule  # noqa: E402
from test_torch_trainer_tokenizer import GENIE, TOKENIZER, _write  # noqa: E402
from tools.parity_check import ATOL, RTOL  # noqa: E402

torch.set_num_threads(1)
STEP = 3  # the step both checkpoints are saved at


def _genie_yaml(root):
    return ("seed_everything: 7\nmodel:\n  tokenizer:\n"
            + "".join("  " + line + "\n" for line in TOKENIZER.splitlines()) + GENIE
            + "  optimizer: {lr: 1e-3, ema_decay: 0.9}\n"
            + "data: {source: synthetic, num_frames: 4, batch_size: 2, height: 16, width: 16, "
            + "num_videos: 24, num_workers: 2}\n"
            + f"trainer: {{precision: \"32\", n_data: 1, ckpt_dir: {root}/unused}}\n")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _save_both(root, name, module, sample, kind, cfg_path, frozen, torch_module,
               init_kwargs=None):
    """The JAX module's initialization with an EMA apart from it, saved as
    step STEP by both loops; returns `(jax_dir, port_dir)`."""
    cfg = jload_config(cfg_path, kind=kind)
    key = jax.random.PRNGKey(cfg.trainer.seed)
    opt_kwargs = jtrainer._opt_kwargs(cfg.model.optimizer)
    state = jloop.create_train_state(module, sample, key, jloop.make_optimizer(**opt_kwargs),
                                     init_kwargs=init_kwargs)
    if frozen:
        mask = jfrozen_param_mask(state.params, frozen)
        state = state.replace(opt_state=jloop.make_optimizer(
            **opt_kwargs, frozen_mask=mask).init(state.params))
    rng = np.random.default_rng(11)
    ema = jax.tree.map(lambda p: p + 0.05 * np.std(p) * rng.standard_normal(p.shape)
                       .astype(np.float32), _np(state.params))
    is_ema = lambda n: isinstance(n, jloop.EmaState)  # noqa: E731
    opt_state = jax.tree.map(lambda n: jloop.EmaState(ema=jax.tree.map(jnp.asarray, ema))
                             if is_ema(n) else n, state.opt_state, is_leaf=is_ema)
    state = state.replace(opt_state=opt_state, step=jnp.asarray(STEP, jnp.int32))
    jdir, tdir = str(root / f"{name}_jax"), str(root / f"{name}_port")
    jloop.save_checkpoint(jdir, state, STEP)

    load_flax_params(torch_module, _np(state.params))
    ema_module = copy.deepcopy(torch_module)
    load_flax_params(ema_module, ema)
    opt = tloop.make_optimizer(torch_module, ema_decay=0.9)
    opt.ema = {k: v.clone() for k, v in ema_module.state_dict().items()}
    tloop.save_checkpoint(tdir, tloop.TrainState(torch_module, opt, None, STEP), STEP)
    return jdir, tdir


@pytest.fixture(scope="module")
def genie_ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("genie")
    cfg = _write(root / "genie.yaml", _genie_yaml(root))
    jcfg = jload_config(cfg, kind="genie")
    jmod = JGenieTrainModule(genie=jtrainer.genie_model_kwargs(jcfg.model))
    tmod = GenieTrainModule(ttrainer.genie_model_kwargs(tload_config(cfg, "genie").model))
    jdir, tdir = _save_both(root, "genie", jmod, jnp.zeros((1, 4, 16, 16, 3)), "genie", cfg,
                            ("model/tokenizer_",), tmod, {"method": jmod.full_init})
    return root, cfg, jdir, tdir


class Capture:
    """`write_mp4` of both packages' video modules, recorded; the token
    videos each package decodes, recorded."""

    def __init__(self, monkeypatch):
        import open_genie_tpu.data.video as jvideo
        import open_genie_tpu_torch.data.video as tvideo

        self.videos = {"jax": [], "port": []}
        self.tokens = {"jax": [], "port": []}
        for name, mod in (("jax", jvideo), ("port", tvideo)):
            monkeypatch.setattr(mod, "write_mp4",
                                lambda path, video, fps=30, name=name:
                                self.videos[name].append(np.asarray(video)))
        jdecode, tdecode = JTokenizer.decode_tokens, VideoTokenizer.decode_tokens

        def jspy(module, idxs):
            if not isinstance(idxs, jax.core.Tracer):  # not the template's init
                self.tokens["jax"].append(np.asarray(idxs))
            return jdecode(module, idxs)

        def tspy(module, idxs):
            self.tokens["port"].append(idxs.cpu().numpy())
            return tdecode(module, idxs)

        monkeypatch.setattr(JTokenizer, "decode_tokens", jspy)
        monkeypatch.setattr(VideoTokenizer, "decode_tokens", tspy)


def _run_both(argv_jax, argv_port, capsys):
    """Run the JAX CLI then the port's; their printed lines."""
    jcli.main(argv_jax)
    jout = capsys.readouterr().out.splitlines()
    tcli.main(argv_port + ["--device", "cpu"])
    tout = capsys.readouterr().out.splitlines()
    return jout, tout


def _pixels_close(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("ema", [False, True], ids=["params", "ema"])
@pytest.mark.parametrize("drive", ["actions", "actions_from_data"])
def test_generate_matches_jax(genie_ckpts, monkeypatch, capsys, ema, drive):
    """`generate --top-k 1` on the same weights (the EMA with `--ema`):
    tokens exact, the video within the parity tolerances, the same printed
    lines (the replayed pool with `--actions-from-data`)."""
    root, cfg, jdir, tdir = genie_ckpts
    cap = Capture(monkeypatch)
    flags = ["--frames", "2", "--steps-per-frame", "2", "--size", "16", "--top-k", "1",
             "--out", str(root / "out.mp4")] + (["--ema"] if ema else [])
    flags += ["--actions", "1,3,2"] if drive == "actions" else ["--actions-from-data"]
    jout, tout = _run_both(["generate", "--config", cfg, "--ckpt", jdir] + flags,
                           ["generate", "--config", cfg, "--ckpt", tdir] + flags, capsys)
    assert tout == jout
    if drive == "actions_from_data":
        assert jout[0].startswith("# replaying 4 emitted action ids (pool [")
    (jtok,), (ttok,) = cap.tokens["jax"], cap.tokens["port"]
    assert ttok.shape == (1, 3, 4, 4)
    np.testing.assert_array_equal(ttok, jtok)
    (jvid,), (tvid,) = cap.videos["jax"], cap.videos["port"]
    assert tvid.shape == (3, 16, 16, 3)
    _pixels_close(tvid, jvid)


def test_generate_ema_differs_and_needs_a_checkpoint(genie_ckpts):
    """The EMA is not the parameters; `--ema` without `--ckpt`, or on a
    checkpoint without an EMA, raises."""
    root, cfg, _, tdir = genie_ckpts
    tcfg = tload_config(cfg, "genie")
    _, raw, step = ttrainer.load_genie_params(tcfg, tdir, device="cpu")
    _, ema, ema_step = ttrainer.load_genie_params(tcfg, tdir, device="cpu", use_ema=True)
    assert step == ema_step == STEP
    assert any(not torch.equal(a, b) for a, b in zip(raw.state_dict().values(),
                                                     ema.state_dict().values()))
    with pytest.raises(ValueError, match="--ema requires --ckpt"):
        tcli.main(["generate", "--config", cfg, "--ema", "--device", "cpu"])
    no_ema = root / "no_ema"
    opt = tloop.make_optimizer(raw)
    tloop.save_checkpoint(str(no_ema), tloop.TrainState(raw, opt, None, 1), 1)
    with pytest.raises(ValueError, match="carries no parameter EMA"):
        ttrainer.load_genie_params(tcfg, str(no_ema), device="cpu", use_ema=True)


@pytest.mark.parametrize("stream", [True, False], ids=["stream", "window"])
def test_play_past_max_frames_matches_jax(genie_ckpts, monkeypatch, capsys, stream):
    """A scripted session of 5 frames at `--max-frames 2` (it rebases),
    `--top-k 1`: JAX's printed lines and frames."""
    root, cfg, jdir, tdir = genie_ckpts
    cap = Capture(monkeypatch)
    flags = ["--actions", "0,1,2,3,1", "--max-frames", "2", "--steps-per-frame", "2",
             "--size", "16", "--top-k", "1", "--ema", "--out", str(root / "s.mp4")]
    flags += [] if stream else ["--no-stream"]
    jout, tout = _run_both(["play", "--config", cfg, "--ckpt", jdir] + flags,
                           ["play", "--config", cfg, "--ckpt", tdir] + flags, capsys)
    assert tout == jout
    assert [line for line in tout if line.startswith("[frame")][-1] == \
        "[frame 5] action=1 -> (16, 16, 3)"
    (jvid,), (tvid,) = cap.videos["jax"], cap.videos["port"]
    assert tvid.shape == (6, 16, 16, 3)
    _pixels_close(tvid, jvid)
