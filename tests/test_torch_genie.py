"""PyTorch port dynamics and Genie rollout against the JAX package on the CPU.

Compact rollout model (`tools/parity_check.py::GENIE_CFG`), JAX weights
through `bridge.py`, and the Gumbel noise that JAX draws fed to the port.
Token ids must match exactly (one flipped token cascades through every
later MaskGIT step); logits and pixels within atol 2e-3 / rtol 2e-2, the
repo's parity bound for module stacks (`tools/parity_check.py`).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from open_genie_tpu.models.dynamics import maskgit_commit as jcommit  # noqa: E402
from open_genie_tpu.models.genie import Genie as JGenie  # noqa: E402
from open_genie_tpu_torch.bridge import load_flax_params  # noqa: E402
from open_genie_tpu_torch.models.dynamics import maskgit_commit  # noqa: E402
from open_genie_tpu_torch.models.genie import Genie  # noqa: E402
from tools.parity_check import GENIE_CFG  # noqa: E402

torch.set_num_threads(1)
STACK_TOL = dict(atol=2e-3, rtol=2e-2)  # parity_check.py's bound for stacks
B, F, S = 2, 2, 4  # batch, generated frames, MaskGIT steps per frame
HW, V = 16, 2 ** GENIE_CFG["tokenizer"]["d_codebook"]  # 16x16 frames -> 4x4


@pytest.fixture(scope="module")
def genies():
    jm = JGenie(**GENIE_CFG)
    # 32x32 frames: the latent action's `to_act` is sized by its inp_shape.
    params = jax.jit(
        lambda k: jm.init(k, jnp.zeros((1, 4, 32, 32, 3)), k, method=jm.init_full)
    )(jax.random.PRNGKey(0))["params"]
    tm = Genie(**GENIE_CFG)
    skipped = load_flax_params(tm, jax.tree.map(np.asarray, params))
    assert skipped == []  # the latent-action subtree loads too
    return jm, params, tm


def _gumbel(key, shape):
    return np.array(jax.random.gumbel(key, shape, jnp.bfloat16).astype(jnp.float32))


def _rollout_gumbel(key, num_frames, steps):
    """The noise `Genie.__call__` draws: split per frame, then per step."""
    return np.stack([
        np.stack([_gumbel(sk, (B, HW, V)) for sk in jax.random.split(fk, steps)])
        for fk in jax.random.split(key, num_frames)
    ])


@pytest.mark.parametrize("top_k", [None, 3])
def test_maskgit_commit_matches_jax(top_k):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((B, HW, V)).astype(np.float32) * 3
    mask = rng.uniform(size=(B, HW)) > 0.3
    code = rng.integers(0, V, (B, HW)).astype(np.int32)
    key = jax.random.PRNGKey(7)
    ref_mask, ref_code = jcommit(key, logits, mask, code, 5, 0.8, top_k=top_k)
    out_mask, out_code = maskgit_commit(
        torch.from_numpy(logits), torch.from_numpy(mask), torch.from_numpy(code),
        5, 0.8, top_k=top_k, gumbel=torch.from_numpy(_gumbel(key, (B, HW, V))),
    )
    np.testing.assert_array_equal(out_mask.numpy(), np.asarray(ref_mask))
    np.testing.assert_array_equal(out_code.numpy(), np.asarray(ref_code))


def test_maskgit_commit_tie_commits_both():
    """Greedy sampling (top_k=1) makes every confidence exactly 0: a tie at
    the threshold commits every tied masked position, in both packages."""
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((B, HW, V)).astype(np.float32)
    mask = np.ones((B, HW), bool)
    mask[:, :3] = False
    code = np.zeros((B, HW), np.int32)
    key = jax.random.PRNGKey(2)
    ref_mask, ref_code = jcommit(key, logits, mask, code, 2, top_k=1)
    out_mask, out_code = maskgit_commit(
        torch.from_numpy(logits), torch.from_numpy(mask), torch.from_numpy(code),
        2, top_k=1, gumbel=torch.from_numpy(_gumbel(key, (B, HW, V))),
    )
    assert not out_mask.any()  # all 13 tied positions committed, not 2
    np.testing.assert_array_equal(out_mask.numpy(), np.asarray(ref_mask))
    np.testing.assert_array_equal(out_code.numpy(), np.asarray(ref_code))
    np.testing.assert_array_equal(out_code.numpy()[:, 3:], logits.argmax(-1)[:, 3:])


def test_decode_frame_matches_jax(genies):
    """Cached decode logits (prefill commits, then a read-only refine and a
    commit at the next position) against JAX's `decode_frame`."""
    jm, params, tm = genies
    rng = np.random.default_rng(3)
    toks = rng.integers(0, V, (B, 4, 4, 4)).astype(np.int32)
    acts = rng.integers(0, 16, (B, 4)).astype(np.int32)
    dyn = jm.bind({"params": params}).dynamics_
    jcache = dyn.init_cache(B, 4, 4, 4)
    tcache = tm.dynamics.init_cache(B, 4, 4, 4)
    for pos in range(4):
        commit = pos < 3
        if not commit:
            ref, _ = dyn.decode_frame(toks[:, pos], acts[:, pos], jcache, pos, commit=False)
            out, _ = tm.dynamics.decode_frame(
                torch.from_numpy(toks[:, pos]), torch.from_numpy(acts[:, pos]),
                tcache, pos, commit=False,
            )
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), **STACK_TOL)
        ref, jcache = dyn.decode_frame(toks[:, pos], acts[:, pos], jcache, pos)
        out, tcache = tm.dynamics.decode_frame(
            torch.from_numpy(toks[:, pos]), torch.from_numpy(acts[:, pos]), tcache, pos
        )
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **STACK_TOL)


def test_rollout_matches_jax(genies):
    """`Genie.forward` against `Genie.__call__` with the same weights and
    JAX's own Gumbel noise: exact tokens, pixels within tolerance."""
    jm, params, tm = genies
    prompt = np.random.default_rng(4).uniform(size=(B, 1, 16, 16, 3)).astype(np.float32)
    actions = np.array([[1, 5, 9], [15, 0, 3]], np.int32)
    key = jax.random.PRNGKey(5)

    def jtokens(p, pr, a, k):
        m = jm.bind({"params": p})
        return m.rollout_tokens(m.tokenize_prompt(pr), a, k, F, S)

    ref_tok = jax.jit(jtokens)(params, prompt, actions, key)
    ref_pix = jax.jit(
        lambda p, pr, a, k: jm.apply({"params": p}, pr, a, k, num_frames=F, steps_per_frame=S)
    )(params, prompt, actions, key)

    gumbel = torch.from_numpy(_rollout_gumbel(key, F, S))
    args = (torch.from_numpy(prompt), torch.from_numpy(actions), F, S)
    tok = tm.generate_tokens(*args, gumbel=gumbel)
    pix = tm(*args, gumbel=gumbel)
    assert tuple(tok.shape) == (B, 1 + F, 4, 4)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
    assert tuple(pix.shape) == (B, 1 + F, 16, 16, 3)
    np.testing.assert_allclose(pix.numpy(), np.asarray(ref_pix), **STACK_TOL)


def test_actions_out_of_range_raise_and_short_lists_pad(genies):
    """Ids outside [0, act_vocab) raise (flax's embedding would return NaN
    rows for ids >= vocab and wrap -1); short action lists are zero-padded."""
    jm, params, tm = genies
    emb = np.asarray(jm.bind({"params": params}).dynamics_.act_emb(jnp.array([16, -1, 15])))
    assert np.isnan(emb[0]).all()  # the reference: NaN row past the vocab
    np.testing.assert_array_equal(emb[1], emb[2])  # ... and -1 wraps to 15
    prompt = torch.rand(1, 1, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    for bad in (16, -1):
        with pytest.raises(ValueError, match="action ids"):
            tm(prompt, torch.tensor([[0, bad]]), 1, 2,
               generator=torch.Generator().manual_seed(0))
    short = tm.generate_tokens(prompt, torch.tensor([[3]]), 2, 2,
                               generator=torch.Generator().manual_seed(1))
    padded = tm.generate_tokens(prompt, torch.tensor([[3, 0, 0]]), 2, 2,
                                generator=torch.Generator().manual_seed(1))
    assert torch.equal(short, padded)
    with pytest.raises(ValueError, match="Generator"):
        tm(prompt, torch.tensor([[0]]), 1, 2)
