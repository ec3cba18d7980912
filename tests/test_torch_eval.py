"""The port's evaluation metrics and harnesses (`open_genie_tpu_torch/eval.py`)
against the JAX package's `open_genie_tpu/eval.py` on the CPU.

`psnr`, `_gaussian_kernel`, `_ssim_blur` and `ssim` on the same arrays
within 1e-5 relative (1e-6 absolute for the blur); `codebook_stats` exact
up to f32 rounding. The harnesses on the compact model
(`tools/parity_check.py::GENIE_CFG`) with JAX's weights through
`bridge.py`: `evaluate_tokenizer` (and on a tokenizer with an LFQ
projection and two codebooks), `evaluate_dynamics` and `evaluate_genie`
with the Bernoulli masks that JAX draws from its keys, and
`action_controllability` with JAX's action sequences and Gumbel noise. Code
counts exact; the metrics of a model's outputs within 1e-4 relative (its
pixels agree within atol 2e-3 / rtol 2e-2, `tools/parity_check.py`, and a
mean over many of them much closer).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from open_genie_tpu import eval as jeval  # noqa: E402
from open_genie_tpu.models.dynamics import DynamicsModel as JDynamics  # noqa: E402
from open_genie_tpu.models.genie import Genie as JGenie  # noqa: E402
from open_genie_tpu.models.tokenizer import VideoTokenizer as JTokenizer  # noqa: E402
from open_genie_tpu_torch import eval as teval  # noqa: E402
from open_genie_tpu_torch.bridge import load_flax_params  # noqa: E402
from open_genie_tpu_torch.models.genie import Genie  # noqa: E402
from open_genie_tpu_torch.models.tokenizer import VideoTokenizer  # noqa: E402
from test_torch_genie import _rollout_gumbel  # noqa: E402
from test_torch_quantization import PROJ_TWO_KW  # noqa: E402
from tools.parity_check import GENIE_CFG  # noqa: E402

torch.set_num_threads(1)
REL = dict(rtol=1e-5, atol=0)
MODEL_REL = dict(rtol=1e-4, atol=1e-7)
B = 2


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(seed, shape):
    rng = np.random.default_rng(seed)
    target = rng.uniform(size=shape).astype(np.float32)
    pred = np.clip(target + 0.1 * rng.standard_normal(shape), 0, 1).astype(np.float32)
    return pred, target


@pytest.mark.parametrize("shape", [(B, 3, 16, 16, 3), (B, 24, 20, 3)], ids=["video", "image"])
def test_psnr_matches_jax(shape):
    pred, target = _pair(1, shape)
    np.testing.assert_allclose(teval.psnr(torch.from_numpy(pred), torch.from_numpy(target)).numpy(),
                               np.asarray(jeval.psnr(pred, target)), **REL)
    same = teval.psnr(torch.from_numpy(target), torch.from_numpy(target))
    np.testing.assert_allclose(same.numpy(), np.asarray(jeval.psnr(target, target)), **REL)


@pytest.mark.parametrize("size,sigma", [(11, 1.5), (7, 1.5), (4, 0.8)])
def test_gaussian_kernel_and_blur_match_jax(size, sigma):
    np.testing.assert_array_equal(teval._gaussian_kernel(size, sigma),
                                  jeval._gaussian_kernel(size, sigma))
    x = np.random.default_rng(2).uniform(size=(3, 16, 12, 4)).astype(np.float32)
    got = teval._ssim_blur(torch.from_numpy(x), size, sigma).numpy()
    want = np.asarray(jeval._ssim_blur(jnp.asarray(x), size, sigma))
    assert got.shape == want.shape == (3, 17 - size, 13 - size, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", [(B, 3, 16, 16, 3), (B, 24, 20, 3), (B, 2, 8, 6, 3)],
                         ids=["video", "image", "window_clamped"])
def test_ssim_matches_jax(shape):
    pred, target = _pair(3, shape)
    got = teval.ssim(torch.from_numpy(pred), torch.from_numpy(target)).numpy()
    assert got.shape == (B,)
    np.testing.assert_allclose(got, np.asarray(jeval.ssim(pred, target)), **REL)
    np.testing.assert_allclose(
        teval.ssim(torch.from_numpy(target), torch.from_numpy(target)).numpy(), 1.0, rtol=1e-5)


def test_codebook_stats_match_jax():
    idxs = np.random.default_rng(4).integers(0, 40, (3, 50)).astype(np.int32)
    got = teval.codebook_stats(torch.from_numpy(idxs), 64)
    want = jeval.codebook_stats(jnp.asarray(idxs), 64)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k].item(), float(want[k]), **REL, err_msg=k)


@pytest.fixture(scope="module")
def genies():
    jm = JGenie(**GENIE_CFG)
    params = jax.jit(
        lambda k: jm.init(k, jnp.zeros((1, 4, 32, 32, 3)), k, method=jm.init_full)
    )(jax.random.PRNGKey(0))["params"]
    tm = Genie(**GENIE_CFG).eval()
    assert load_flax_params(tm, _np_tree(params)) == []
    return jm, params, tm


def _videos(seed, n, shape):
    rng = np.random.default_rng(seed)
    return [rng.uniform(size=shape).astype(np.float32) for _ in range(n)]


def _check(got, want, exact=()):
    assert set(got) == set(want)
    for k, v in got.items():
        if k in exact:
            assert v == float(want[k]), k
        else:
            np.testing.assert_allclose(v, float(want[k]), **MODEL_REL, err_msg=k)


COUNT_KEYS = ("usage", "distinct_codes", "usage_of_sampled_ceiling", "num_tokens",
              "num_batches")


def test_evaluate_tokenizer_matches_jax(genies):
    """PSNR, SSIM and MSE of the round trip over 2 batches; the code
    statistics pooled over both (exact counts)."""
    jm, params, tm = genies
    loader = _videos(5, 2, (B, 4, 32, 32, 3))
    want = jeval.evaluate_tokenizer(JTokenizer(**GENIE_CFG["tokenizer"]),
                                    {"params": params["tokenizer_"]}, loader)
    got = teval.evaluate_tokenizer(tm.tokenizer, loader)
    _check(got, want, exact=COUNT_KEYS)
    assert got["num_batches"] == 2 and got["num_tokens"] == 2 * B * 4 * 64


def test_evaluate_tokenizer_with_projection_and_two_codebooks():
    jm = JTokenizer(**PROJ_TWO_KW)
    loader = _videos(6, 2, (B, 2, 16, 16, 3))
    params = jax.jit(lambda k: jm.init(k, loader[0]))(jax.random.PRNGKey(1))["params"]
    tm = VideoTokenizer(**PROJ_TWO_KW).eval()
    load_flax_params(tm, _np_tree(params))
    want = jeval.evaluate_tokenizer(jm, {"params": params}, loader, max_batches=1)
    got = teval.evaluate_tokenizer(tm, loader, max_batches=1)
    _check(got, want, exact=COUNT_KEYS)
    assert got["num_batches"] == 1


def _eval_masks(key, n, shape):
    """The masks JAX's evaluation loops draw: one split per batch, then
    `DynamicsModel.compute_loss`'s rate and Bernoulli keys."""
    masks = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        k_rate, k_mask = jax.random.split(sub)
        rate = jax.random.uniform(k_rate, (), minval=0.5, maxval=1.0)
        masks.append(np.array(jax.random.bernoulli(k_mask, rate, shape)))
    return masks


def test_evaluate_dynamics_matches_jax(genies):
    jm, params, tm = genies
    rng = np.random.default_rng(7)
    shape = (B, 3, 4, 4)
    loader = [{"tokens": rng.integers(0, 256, shape).astype(np.int32),
               "actions": rng.integers(0, 16, shape[:2]).astype(np.int32)} for _ in range(2)]
    key = jax.random.PRNGKey(8)
    jdyn = JDynamics(**GENIE_CFG["dynamics"], tok_vocab=256, act_vocab=16)
    want = jeval.evaluate_dynamics(jdyn, params["dynamics_"], loader, key)
    tm.dynamics.train()
    got = teval.evaluate_dynamics(tm.dynamics, loader, masks=_eval_masks(key, 2, shape))
    assert tm.dynamics.training  # the caller's mode comes back
    tm.dynamics.eval()
    _check(got, want, exact=("num_batches",))
    drawn = teval.evaluate_dynamics(tm.dynamics, loader, max_batches=1,
                                    generator=torch.Generator().manual_seed(0))
    assert drawn["num_batches"] == 1 and 0.4 < drawn["masked_frac"] <= 1.0


def test_evaluate_genie_matches_jax(genies):
    """The joint objective's eval-mode terms and the pooled action-code
    statistics, with JAX's masks."""
    jm, params, tm = genies
    loader = _videos(9, 2, (B, 4, 32, 32, 3))
    key = jax.random.PRNGKey(10)
    want = jeval.evaluate_genie(jm, params, loader, key)
    got = teval.evaluate_genie(tm, loader, masks=_eval_masks(key, 2, (B, 4, 8, 8)))
    _check(got, want, exact=("act_code_usage", "num_batches"))
    assert got["act_q_loss"] == 0.0  # eval mode: no LFQ loss


@pytest.mark.parametrize("pool", [None, [3, 7, 11]], ids=["vocab", "pool"])
def test_action_controllability_matches_jax(genies, pool):
    """Branch set A (distinct actions, shared noise) and B (shared actions,
    distinct noise) on JAX's action sequences and Gumbel noise."""
    jm, params, tm = genies
    prompt = np.random.default_rng(11).uniform(size=(B, 1, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(12)
    frames, spf, n = 2, 3, 3
    want = jeval.action_controllability(jm, {"params": params}, jnp.asarray(prompt), key,
                                        num_frames=frames, steps_per_frame=spf, n_branches=n,
                                        action_pool=pool)
    k_act, k_sample = jax.random.split(key)
    act_keys = jax.random.split(k_act, n)
    if pool is None:
        seqs = [np.array(jax.random.randint(k, (B, frames + 1), 0, 16)) for k in act_keys]
    else:
        ids = jnp.asarray(pool, jnp.int32)
        seqs = [np.array(ids[jax.random.randint(k, (B, frames + 1), 0, len(pool))])
                for k in act_keys]
    gumbels = [torch.from_numpy(_rollout_gumbel(k, frames, spf))
               for k in jax.random.split(k_sample, n)]
    got = teval.action_controllability(
        tm, torch.from_numpy(prompt), frames, spf, n, action_pool=pool,
        action_seqs=[torch.from_numpy(s) for s in seqs], gumbels=gumbels)
    _check(got, want, exact=("controllability_frames", "controllability_branches",
                             "controllability_pool"))
    drawn = teval.action_controllability(tm, torch.from_numpy(prompt), frames, spf, n,
                                         action_pool=pool,
                                         generator=torch.Generator().manual_seed(0))
    assert drawn["action_divergence"] > 0 and drawn["seed_divergence"] > 0
