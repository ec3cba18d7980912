"""PyTorch port VideoTokenizer against the JAX VideoTokenizer on the CPU.

Compact rollout tokenizer (`tools/parity_check.py::GENIE_CFG`), JAX weights
through `bridge.py`, numpy inputs from a fixed seed. Token ids and sign
codes must match exactly; pixels within atol 2e-3 / rtol 2e-2, the repo's
parity bound for module stacks (`tools/parity_check.py`).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from open_genie_tpu.models.genie import Genie as JGenie  # noqa: E402
from open_genie_tpu.models.tokenizer import VideoTokenizer as JTokenizer  # noqa: E402
from open_genie_tpu_torch.bridge import load_flax_params  # noqa: E402
from open_genie_tpu_torch.models.genie import Genie  # noqa: E402
from open_genie_tpu_torch.models.tokenizer import VideoTokenizer  # noqa: E402
from tools.parity_check import GENIE_CFG  # noqa: E402

torch.set_num_threads(1)
STACK_TOL = dict(atol=2e-3, rtol=2e-2)  # parity_check.py's bound for stacks
CFG = GENIE_CFG["tokenizer"]


@pytest.fixture(scope="module")
def tokenizers():
    jtok = JTokenizer(**CFG)
    params = jax.jit(
        lambda k: jtok.init(k, jnp.zeros((1, 2, 16, 16, 3)))
    )(jax.random.PRNGKey(0))["params"]
    ttok = VideoTokenizer(**CFG)
    load_flax_params(ttok, jax.tree.map(np.asarray, params))
    return jtok, params, ttok


def _video(seed, *shape):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


@pytest.mark.parametrize("fused", [False, True])
def test_tokenize_matches_jax(tokenizers, fused):
    """The port's tokenize (fused head: kernel K2's plain twin on the CPU)
    against JAX's unfused XLA path and its Pallas head in interpret mode."""
    jtok, params, ttok = tokenizers
    assert ttok.head_fusable() and jtok.head_fusable()
    video = _video(1, 2, 3, 32, 32, 3)
    quant_ref, idxs_ref = jax.jit(
        lambda p, v: jtok.apply({"params": p}, v, fused=fused, method=jtok.tokenize)
    )(params, video)
    quant, idxs = ttok.tokenize(torch.from_numpy(video))
    assert idxs.dtype == torch.int32 and tuple(idxs.shape) == (2, 3, 8, 8)
    np.testing.assert_array_equal(idxs.numpy(), np.asarray(idxs_ref))
    np.testing.assert_array_equal(quant.numpy(), np.asarray(quant_ref))


def test_unfused_path_matches_fused(tokenizers):
    """The port's unfused encoder + LFQ gives the fused head's ids."""
    _, _, ttok = tokenizers
    video = torch.from_numpy(_video(2, 1, 2, 32, 32, 3))
    _, idxs = ttok.tokenize(video)
    with torch.no_grad():
        (_, idxs_unfused), _, _ = ttok.quant(ttok.encode(video))
    assert torch.equal(idxs, idxs_unfused)


def test_decode_tokens_matches_jax(tokenizers):
    jtok, params, ttok = tokenizers
    idxs = np.random.default_rng(3).integers(0, 2 ** CFG["d_codebook"], (2, 3, 4, 4))
    idxs = idxs.astype(np.int32)
    ref = jax.jit(
        lambda p, i: jtok.apply({"params": p}, i, method=jtok.decode_tokens)
    )(params, idxs)
    out = ttok.decode_tokens(torch.from_numpy(idxs))
    assert tuple(out.shape) == (2, 3, 16, 16, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **STACK_TOL)


def test_temporal_front_pad_matches_jax():
    """A time-compressing tokenizer: `temporal_downsampling` and the
    front-padded 1-frame prompt of `tokenize_prompt` match JAX."""
    cfg = dict(GENIE_CFG)
    tok = dict(CFG)
    tok["enc_desc"] = (
        ("spacetime_downsample", {
            "in_channels": 3, "kernel_size": 3, "out_channels": 16,
            "time_factor": 2, "space_factor": 4,
        }),
        ("causal-conv3d", {"in_channels": 16, "out_channels": 8, "kernel_size": 1}),
    )
    tok["dec_desc"] = (
        ("depth2spacetime_upsample", {
            "in_channels": 8, "out_channels": 3, "kernel_size": 3,
            "time_factor": 2, "space_factor": 4,
        }),
    )
    cfg["tokenizer"] = tok
    jm, tm = JGenie(**cfg), Genie(**cfg)
    # 32x32 frames: the latent action's `to_act` is sized by its inp_shape.
    params = jax.jit(
        lambda k: jm.init(k, jnp.zeros((1, 4, 32, 32, 3)), k, method=jm.init_full)
    )(jax.random.PRNGKey(1))["params"]
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    assert tm.tokenizer.temporal_downsampling == 2
    prompt = _video(4, 2, 16, 16, 3)  # an image prompt
    ref = jm.apply({"params": params}, prompt, method=jm.tokenize_prompt)
    out = tm.tokenize_prompt(torch.from_numpy(prompt))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
