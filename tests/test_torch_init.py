"""The port's seeded init (`utils.init_weights`) against flax's initializers.

Parity tests load JAX's weights through `bridge.py`, so they cannot see the
port's own init. Here each model is built twice, with JAX's `init` and with
`init_weights`, and every leaf (matched through the bridge's key map) is
held to the same distribution:

* weights (dense, 2-D / 3-D / transposed conv, embedding): the port's std
  within `4 / sqrt(numel)` relative of JAX's (four standard errors of the
  difference of two sample stds; at least `SMALL` elements), the mean
  within four standard errors of zero in both, and every dense or conv
  weight inside the two-std truncation of flax's `lecun_normal`
  (`|w| <= 2 std / 0.8796`); embeddings are untruncated in both;
* norm scales, biases and the adaptive norm's constant heads: equal to
  JAX's constants.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from open_genie_tpu.models.genie import Genie as JGenie  # noqa: E402
from open_genie_tpu.train import losses as jlosses  # noqa: E402
from open_genie_tpu_torch.bridge import state_dict_from_flax  # noqa: E402
from open_genie_tpu_torch.models.configs import (  # noqa: E402
    genie_compact_config,
    tokenizer_compact_train_config,
)
from open_genie_tpu_torch.models.genie import Genie  # noqa: E402
from open_genie_tpu_torch.train.losses import (  # noqa: E402
    ActionTrainModule,
    DynamicsTrainModule,
    TokenizerTrainModule,
)
from open_genie_tpu_torch.utils import init_weights  # noqa: E402
from torch import nn  # noqa: E402

TRUNC = 2.0 / 0.87962566103423978  # flax's lecun_normal bound, in stds
SMALL = 64  # fewer elements: the std is not compared (the constants are)


def _compact_genie():
    cfg = genie_compact_config()
    video = np.zeros((1, 4, 32, 32, 3), np.float32)
    jm = JGenie(**cfg)
    params = jax.jit(lambda k: jm.init(k, video, k, method=jm.init_full))(
        jax.random.PRNGKey(0))["params"]
    return params, Genie(**cfg)


def _compact_tokenizer():
    cfg = tokenizer_compact_train_config()
    video = jnp.zeros((2, 4, 32, 32, 3), jnp.float32)
    jm = jlosses.TokenizerTrainModule(**cfg)
    params = jax.jit(lambda k, v: jm.init(k, v, k))(jax.random.PRNGKey(0), video)["params"]
    return params, TokenizerTrainModule(**cfg)


def _dynamics():
    dyn = dict(desc=(("space-time_attn", {"n_rep": 1, "n_embd": 128, "n_head": 4,
                                          "d_head": 32}),),
               embed_dim=128, tok_vocab=1024, act_vocab=16)
    batch = {"tokens": jnp.zeros((1, 2, 4, 4), jnp.int32),
             "actions": jnp.zeros((1, 2), jnp.int32)}
    jm = jlosses.DynamicsTrainModule(dynamics=dyn)
    params = jax.jit(lambda k, b: jm.init(k, b, k))(jax.random.PRNGKey(0), batch)["params"]
    return params, DynamicsTrainModule(dynamics=dyn)


def _latent_action():
    """`configs/genie.yaml`'s latent action at width 32: its space-time
    upsampler is a transposed conv."""
    attn = {"n_rep": 1, "n_embd": 32, "n_head": 2, "d_head": 16}
    ext = dict(attn, has_ext=True, time_attn_kw={"key_dim": 4})
    la = dict(
        enc_desc=(("space-time_attn", attn),
                  ("spacetime_downsample", {"in_channels": 32, "kernel_size": 3,
                                            "time_factor": 1, "space_factor": 2}),
                  ("space-time_attn", attn)),
        dec_desc=(("space-time_attn", ext),
                  ("spacetime_upsample", {"in_channels": 32, "kernel_size": 3,
                                          "time_factor": 1, "space_factor": 2}),
                  ("space-time_attn", ext)),
        d_codebook=4, n_embd=32, inp_shape=(16, 16))
    video = jnp.zeros((1, 3, 16, 16, 3), jnp.float32)
    jm = jlosses.ActionTrainModule(latent_action=la)
    params = jax.jit(lambda k, v: jm.init(k, v, k))(jax.random.PRNGKey(0), video)["params"]
    return params, ActionTrainModule(latent_action=la)


MODELS = {"compact_genie": _compact_genie, "compact_tokenizer": _compact_tokenizer,
          "dynamics": _dynamics, "latent_action": _latent_action}


def _kinds(module: nn.Module):
    """`{parameter name: leaf kind}` of a port module."""
    kinds = {}
    for prefix, mod in module.named_modules():
        dot = f"{prefix}." if prefix else ""
        if getattr(mod, "const_init", None) is not None:
            kinds[dot + "weight"] = kinds[dot + "bias"] = "const"
            continue
        kind = {nn.Linear: "dense", nn.Conv2d: "conv2d", nn.Conv3d: "conv3d",
                nn.ConvTranspose3d: "conv_transpose3d", nn.Embedding: "embedding",
                nn.LayerNorm: "norm", nn.GroupNorm: "norm"}.get(type(mod))
        for name, _ in mod.named_parameters(recurse=False):
            kinds[dot + name] = "bias" if name == "bias" else kind
    return kinds


@pytest.mark.parametrize("model", sorted(MODELS))
def test_init_weights_matches_flax_initializers(model):
    params, module = MODELS[model]()
    ref, skipped = state_dict_from_flax(jax.tree.map(np.asarray, params), module)
    assert skipped == []
    init_weights(module, torch.Generator().manual_seed(0))
    got = module.state_dict()
    assert set(ref) == set(got)
    kinds = _kinds(module)
    seen, beyond = set(), []
    for name, t in got.items():
        kind, a, b = kinds[name], t.double().numpy(), ref[name].double().numpy()
        seen.add(kind)
        assert kind is not None, name
        if kind in ("norm", "bias", "const"):
            np.testing.assert_array_equal(a, b, err_msg=name)
            continue
        n = a.size
        assert n >= SMALL or kind == "embedding", (name, n)
        fan_in = {"embedding": a.shape[-1],
                  "conv_transpose3d": a.shape[0] * math.prod(a.shape[2:])}.get(
            kind, a[0].size)
        std = fan_in ** -0.5
        np.testing.assert_allclose(b.std(), std, rtol=4 / math.sqrt(2 * n), err_msg=name)
        np.testing.assert_allclose(a.std(), b.std(), rtol=4 / math.sqrt(n), err_msg=name)
        for x in (a, b):
            assert abs(x.mean()) <= 4 * std / math.sqrt(n), (name, x.mean())
        widest = [np.abs(a).max() / std, np.abs(b).max() / std]
        if kind == "embedding":  # flax's nn.Embed: an untruncated normal
            assert min(widest) > TRUNC, name
        elif max(widest) > TRUNC * (1 + 1e-6):
            beyond.append((name, widest))
    assert not beyond, f"outside lecun_normal's truncation (in stds, port and JAX): {beyond}"
    want = {"compact_genie": {"dense", "conv3d", "embedding", "norm", "bias"},
            "compact_tokenizer": {"dense", "conv2d", "conv3d", "norm", "bias", "const"},
            "dynamics": {"dense", "embedding", "norm", "bias"},
            "latent_action": {"dense", "conv3d", "conv_transpose3d", "norm", "bias"}}[model]
    assert want <= seen, (model, seen)
