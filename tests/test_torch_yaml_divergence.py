"""Does the JAX package diverge where the port does, at the YAMLs' own
learning rates? Five f32 steps of `configs/tokenize.yaml` (lr 1e-3) and of
`configs/genie.yaml` (lr 1e-4), at their own model widths, in both packages.

JAX initializes through its trainer's path (`create_train_state` at the
YAML's seed, the trainer's optimizer and frozen mask); the port loads those
weights through `bridge.load_flax_params` and builds its optimizer from the
same config. Both take the same synthetic 64x64 clips, drawn from a numpy
seed, and the port is fed the noise that JAX draws from its
step key (the perceptual and GAN frame picks, the dynamics' Bernoulli
mask). Every loss term of every step is printed as one JSON line.

The data are cut to `BATCH` clip of `FRAMES` frames (the YAMLs take 8 and
4 clips of 16 frames): on the CPU, JAX's jitted step held more than 29 GiB
for one clip of 16 frames of tokenize.yaml, and 13.5 GiB for one of 4
frames (13.4 GiB for genie.yaml's); its memory grows with the frames.
Model widths, learning rates and every other key are the YAMLs'.

Asserted: the first step's loss (same weights, same batch) agrees within
1e-4 relative, and both packages reach the same verdict: a run diverges
when its fifth loss exceeds twice its first. Marked `slow` (minutes of CPU
and several GiB): `python -m pytest tests/test_torch_yaml_divergence.py -m
slow -s`.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from open_genie_tpu.train import loop as jloop  # noqa: E402
from open_genie_tpu.train import trainer as jtrainer  # noqa: E402
from open_genie_tpu.train.config import load_config as jload_config  # noqa: E402
from open_genie_tpu.train.losses import GenieTrainModule as JGenieTrainModule  # noqa: E402
from open_genie_tpu.train.losses import frozen_param_mask as jfrozen_mask  # noqa: E402
from open_genie_tpu.utils import random_frame_idxs as jrandom_frame_idxs  # noqa: E402
from open_genie_tpu_torch.bridge import load_flax_params  # noqa: E402
from open_genie_tpu_torch.train import trainer  # noqa: E402
from open_genie_tpu_torch.train.config import load_config  # noqa: E402
from open_genie_tpu_torch.train.loop import make_optimizer, make_train_step  # noqa: E402
from open_genie_tpu_torch.train.losses import GenieTrainModule, frozen_param_mask  # noqa: E402

pytestmark = pytest.mark.slow

STEPS = 5
BATCH = 1
FRAMES = 4
DIVERGED = 2.0  # fifth loss over first


def _clips(seed, cfg):
    rng = np.random.default_rng(seed)
    d = cfg.data
    return [rng.uniform(size=(BATCH, FRAMES, d.height, d.width, 3)).astype(np.float32)
            for _ in range(STEPS)]


def _step_key(jstate):
    """The key `make_train_step` hands the module on this step."""
    _, sub, _ = jax.random.split(jstate.key, 3)
    return sub


def _floats(metrics):
    return {k: float(np.asarray(v)) for k, v in metrics.items()
            if np.asarray(v).shape == ()}


def _run(name, jmodule, jstate, jstep, module, step, clips, port_noise):
    """Five steps in each package; `{package: [metrics of each step]}`."""
    runs = {"jax": [], "torch": []}
    for video in clips:
        noise = port_noise(_step_key(jstate), video)
        jstate, jm = jstep(jstate, jnp.asarray(video))
        runs["jax"].append(_floats(jax.device_get(jm)))
        runs["torch"].append(_floats({k: v.detach() for k, v in
                                      step(torch.from_numpy(video), **noise).items()}))
    print(json.dumps({"yaml": name, "batch": BATCH, "frames": FRAMES, "steps": runs}))
    return runs


def _verdict(losses):
    return losses[-1] > DIVERGED * losses[0]


def _check(runs):
    j = [m["loss"] for m in runs["jax"]]
    t = [m["loss"] for m in runs["torch"]]
    assert all(np.isfinite(j[:1])) and all(np.isfinite(t[:1]))
    np.testing.assert_allclose(t[0], j[0], rtol=1e-4)
    assert _verdict(j) == _verdict(t), (j, t)


def test_tokenize_yaml_diverges_alike():
    path = "configs/tokenize.yaml"
    jcfg, cfg = jload_config(path, "tokenizer"), load_config(path, "tokenizer")
    jmodule = jtrainer.build_tokenizer_module(jcfg.model)
    sample = jnp.zeros((BATCH, FRAMES, 64, 64, 3), jnp.float32)
    jstate = jloop.create_train_state(jmodule, sample, jax.random.PRNGKey(jcfg.trainer.seed),
                                      jloop.make_optimizer())
    mask = jfrozen_mask(jstate.params, ("perc_crit",))
    jopt = jloop.make_optimizer(**jtrainer._opt_kwargs(jcfg.model.optimizer), frozen_mask=mask)
    jstate = jstate.replace(opt_state=jopt.init(jstate.params))
    jstep = jloop.make_train_step(jmodule, jopt)

    module = trainer.build_tokenizer_module(cfg.model)
    assert load_flax_params(module, jax.tree.map(np.asarray, jstate.params)) == []
    opt = make_optimizer(module, **trainer._opt_kwargs(cfg.model.optimizer),
                         frozen_mask=frozen_param_mask(module, ("perc_crit",)))
    step = make_train_step(module, opt)
    k = min(cfg.model.gan_frames_per_batch, FRAMES)

    def noise(key, video):
        k_perc, k_gan = jax.random.split(key)
        return {n: torch.from_numpy(np.array(jrandom_frame_idxs(kk, BATCH, video.shape[1], k)))
                for n, kk in (("perc_idxs", k_perc), ("gan_idxs", k_gan))}

    _check(_run("tokenize.yaml", jmodule, jstate, jstep, module, step, _clips(16, cfg), noise))


def test_genie_yaml_diverges_alike():
    path = "configs/genie.yaml"
    jcfg, cfg = jload_config(path, "genie"), load_config(path, "genie")
    jmodule = JGenieTrainModule(genie=jtrainer.genie_model_kwargs(jcfg.model))
    sample = jnp.zeros((BATCH, FRAMES, 64, 64, 3), jnp.float32)
    jstate = jloop.create_train_state(jmodule, sample, jax.random.PRNGKey(jcfg.trainer.seed),
                                      jloop.make_optimizer(),
                                      init_kwargs={"method": jmodule.full_init})
    mask = jfrozen_mask(jstate.params, ("model/tokenizer_",))
    jopt = jloop.make_optimizer(**jtrainer._opt_kwargs(jcfg.model.optimizer), frozen_mask=mask)
    jstate = jstate.replace(opt_state=jopt.init(jstate.params))
    jstep = jloop.make_train_step(jmodule, jopt)

    module = GenieTrainModule(trainer.genie_model_kwargs(cfg.model))
    assert load_flax_params(module.model, jax.tree.map(np.asarray, jstate.params["model"])) == []
    opt = make_optimizer(module, **trainer._opt_kwargs(cfg.model.optimizer),
                         frozen_mask=frozen_param_mask(module, ("model/tokenizer",)))
    step = make_train_step(module, opt)

    def noise(key, video):
        with torch.no_grad():
            _, tok = module.model.tokenizer.tokenize_frozen(torch.from_numpy(video))
        k_rate, k_mask = jax.random.split(key)
        rate = jax.random.uniform(k_rate, (), minval=0.5, maxval=1.0)
        return {"mask": torch.from_numpy(np.array(
            jax.random.bernoulli(k_mask, rate, tuple(tok.shape))))}

    _check(_run("genie.yaml", jmodule, jstate, jstep, module, step, _clips(17, cfg), noise))
