"""Compact models that the JAX package builds from blueprints the port used
to refuse, held against it on the CPU with the same weights (`bridge.py`).

- The compact Genie of `tests/test_genie.py` (head dim 8, which the flash
  kernels do not take): the rollout with the Gumbel noise that JAX draws.
- A `space-time_attn` that declares no input width: it takes the width
  entering it, as JAX takes the width of its traced input.
- A dynamics trunk whose layers are marked `has_ext`: JAX builds them and
  runs them with no condition.

Token ids must match exactly (one flipped token cascades through every
later MaskGIT step); logits, losses and pixels within atol 2e-3 / rtol
2e-2, the repo's parity bound for module stacks (`tools/parity_check.py`).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from open_genie_tpu.models.dynamics import DynamicsModel as JDynamics  # noqa: E402
from open_genie_tpu.models.genie import Genie as JGenie  # noqa: E402
from open_genie_tpu.modules import attention as jatt  # noqa: E402
from open_genie_tpu_torch.bridge import load_flax_params  # noqa: E402
from open_genie_tpu_torch.models.dynamics import DynamicsModel  # noqa: E402
from open_genie_tpu_torch.models.genie import Genie  # noqa: E402
from open_genie_tpu_torch.models.tokenizer import VideoTokenizer  # noqa: E402
from open_genie_tpu_torch.modules import parse_blueprint  # noqa: E402
from open_genie_tpu_torch.modules.attention import SpaceTimeAttention  # noqa: E402

torch.set_num_threads(1)
STACK_TOL = dict(atol=2e-3, rtol=2e-2)  # parity_check.py's bound for stacks
KEY = jax.random.PRNGKey(0)

# `tests/test_genie.py`'s CFG: 16x16 frames into 4x4 tokens of 6 bits, a
# latent action and a dynamics trunk with 2 heads of dim 8.
GENIE_D8 = dict(
    tokenizer=dict(
        enc_desc=(
            ("spacetime_downsample", {
                "in_channels": 3, "kernel_size": 3, "out_channels": 16,
                "time_factor": 1, "space_factor": 4,
            }),
            ("causal-conv3d", {"in_channels": 16, "out_channels": 6, "kernel_size": 1}),
        ),
        dec_desc=(
            ("causal-conv3d", {"in_channels": 6, "out_channels": 16, "kernel_size": 3}),
            ("depth2spacetime_upsample", {
                "in_channels": 16, "out_channels": 3, "kernel_size": 3,
                "time_factor": 1, "space_factor": 4,
            }),
        ),
        d_codebook=6,
    ),
    latent_action=dict(
        enc_desc=(
            ("space-time_attn", {"n_rep": 1, "n_embd": 16, "n_head": 2, "d_head": 8}),
        ),
        dec_desc=(
            ("space-time_attn", {
                "n_rep": 1, "n_embd": 16, "n_head": 2, "d_head": 8,
                "has_ext": True, "time_attn_kw": {"key_dim": 4},
            }),
        ),
        d_codebook=4,
        n_embd=16,
        inp_shape=(16, 16),
    ),
    dynamics=dict(
        desc=(("space-time_attn", {"n_rep": 1, "n_embd": 32, "n_head": 2, "d_head": 8}),),
        embed_dim=32,
    ),
)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _load(jmod, tmod, *inputs, **kwargs):
    params = jax.jit(lambda k: jmod.init(k, *inputs, **kwargs))(KEY)["params"]
    load_flax_params(tmod, jax.tree.map(np.asarray, params))
    return params


def test_head_dim_8_genie_rollout_matches_jax():
    b, frames, steps, hw, vocab = 2, 2, 3, 16, 2 ** 6
    jm, tm = JGenie(**GENIE_D8), Genie(**GENIE_D8)
    params = _load(jm, tm, jnp.zeros((1, 4, 16, 16, 3)), KEY, method=jm.init_full)
    prompt = np.random.default_rng(1).uniform(size=(b, 1, 16, 16, 3)).astype(np.float32)
    actions = np.array([[1, 3, 0], [2, 0, 3]], np.int32)
    key = jax.random.PRNGKey(2)

    def jtokens(p, pr, a, k):
        m = jm.bind({"params": p})
        return m.rollout_tokens(m.tokenize_prompt(pr), a, k, frames, steps)

    ref_tok = jax.jit(jtokens)(params, prompt, actions, key)
    ref_pix = jax.jit(lambda p, pr, a, k: jm.apply(
        {"params": p}, pr, a, k, num_frames=frames, steps_per_frame=steps))(
        params, prompt, actions, key)
    # The noise `Genie.__call__` draws: split per frame, then per step.
    gumbel = torch.from_numpy(np.stack([
        np.stack([np.array(jax.random.gumbel(sk, (b, hw, vocab), jnp.bfloat16)
                           .astype(jnp.float32)) for sk in jax.random.split(fk, steps)])
        for fk in jax.random.split(key, frames)]))
    args = (torch.from_numpy(prompt), torch.from_numpy(actions), frames, steps)
    tok = tm.generate_tokens(*args, gumbel=gumbel)
    pix = tm(*args, gumbel=gumbel)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
    assert tuple(pix.shape) == (b, 1 + frames, 16, 16, 3)
    np.testing.assert_allclose(pix.numpy(), np.asarray(ref_pix), **STACK_TOL)


def test_space_time_attn_takes_the_width_entering_it():
    """A 24-wide input into 2 x 16 heads, the block declaring no width: as a
    parsed layer, and as the trunk of a dynamics model whose head takes the
    block's 32-wide output."""
    kw = {"n_head": 2, "d_head": 16}
    x = _rand(3, 2, 3, 4, 4, 24)
    layers, _ = parse_blueprint((("space-time_attn", kw),), width=24)
    jmod = jatt.SpaceTimeAttention(**kw)
    params = _load(jmod, layers[0], x)
    with torch.no_grad():
        out = layers[0](torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jmod.apply({"params": params}, x)),
                               **STACK_TOL)

    desc = (("space-time_attn", kw), ("space-time_attn", {**kw, "n_head": 4}))
    jdyn, tdyn = JDynamics(desc, 16, 4, 24), DynamicsModel(desc, 16, 4, 24)
    tokens = np.random.default_rng(4).integers(0, 16, (2, 3, 4, 4)).astype(np.int32)
    acts = np.random.default_rng(5).integers(0, 4, (2, 3)).astype(np.int32)
    params = _load(jdyn, tdyn, tokens, acts)
    with torch.no_grad():
        logits = tdyn(torch.from_numpy(tokens), torch.from_numpy(acts))
    np.testing.assert_allclose(logits.numpy(),
                               np.asarray(jdyn.apply({"params": params}, tokens, acts)),
                               **STACK_TOL)


def test_unknown_block_width_raises():
    with pytest.raises(ValueError, match=r"layer 1 \(space-time_attn\)"):
        parse_blueprint((("silu", {}), ("space-time_attn", {"n_head": 2, "d_head": 16})))
    with pytest.raises(ValueError, match="d_inp or n_embd"):
        SpaceTimeAttention(n_head=2, d_head=16)
    # The video's channels are unknown when a tokenizer is built.
    with pytest.raises(ValueError, match=r"layer 0 \(space-time_attn\)"):
        VideoTokenizer(enc_desc=(("space-time_attn", {"n_head": 2, "d_head": 4}),
                                 ("causal-conv3d", {"in_channels": 8, "out_channels": 4})),
                       dec_desc=(("causal-conv3d", {"in_channels": 4, "out_channels": 3}),),
                       d_codebook=4)


# Two `has_ext` layers; the second declares cross-attention key widths in
# both attentions, which without a condition attend to their own input.
EXT_DESC = (
    ("space-time_attn", {"n_embd": 32, "n_head": 2, "d_head": 16, "has_ext": True}),
    ("space-time_attn", {
        "n_embd": 32, "n_head": 2, "d_head": 16, "has_ext": True,
        "space_attn_kw": {"key_dim": 32}, "time_attn_kw": {"key_dim": 32},
    }),
)


def test_has_ext_dynamics_matches_jax():
    """`forward`, `compute_loss` on JAX's own Bernoulli mask, and the cached
    `decode_frame` (prefill commits, a read-only refine, a commit)."""
    b, t, h, w, vocab = 2, 4, 4, 4, 16
    jm, tm = JDynamics(EXT_DESC, vocab, 4, 32), DynamicsModel(EXT_DESC, vocab, 4, 32)
    tokens = np.random.default_rng(6).integers(0, vocab, (b, t, h, w)).astype(np.int32)
    acts = np.random.default_rng(7).integers(0, 4, (b, t)).astype(np.int32)
    params = _load(jm, tm, tokens, acts)
    tt, ta = torch.from_numpy(tokens), torch.from_numpy(acts)

    with torch.no_grad():
        logits = tm(tt, ta)
    ref = jm.apply({"params": params}, tokens, acts)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), **STACK_TOL)

    key = jax.random.PRNGKey(8)
    key_rate, key_mask = jax.random.split(key)  # as `compute_loss` draws its mask
    rate = jax.random.uniform(key_rate, (), minval=0.5, maxval=1.0)
    mask = np.array(jax.random.bernoulli(key_mask, rate, tokens.shape))
    ref_loss, ref_aux = jm.apply({"params": params}, tokens, acts, key, method=jm.compute_loss)
    with torch.no_grad():
        loss, aux = tm.compute_loss(tt, ta, mask=torch.from_numpy(mask))
    np.testing.assert_allclose(loss.item(), float(ref_loss), **STACK_TOL)
    np.testing.assert_allclose(aux["masked_frac"].item(), float(ref_aux["masked_frac"]))

    dyn = jm.bind({"params": params})
    jcache, tcache = dyn.init_cache(b, h, w, t), tm.init_cache(b, h, w, t)
    for pos in range(t):
        frame, act = tokens[:, pos], acts[:, pos]
        if pos == t - 1:
            ref, _ = dyn.decode_frame(frame, act, jcache, pos, commit=False)
            out, _ = tm.decode_frame(torch.from_numpy(frame), torch.from_numpy(act), tcache,
                                     pos, commit=False)
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), **STACK_TOL)
        ref, jcache = dyn.decode_frame(frame, act, jcache, pos)
        out, tcache = tm.decode_frame(torch.from_numpy(frame), torch.from_numpy(act), tcache, pos)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **STACK_TOL)
