"""The port's `InteractiveSession` against the JAX package's on the CPU.

The JAX session draws each step's MaskGIT noise from
`split(PRNGKey(seed), max_frames)[f]`, split again per refinement step, and
after the n-th rebase from `split(fold_in(PRNGKey(seed), n), max_frames)`.
The port's session takes that noise through `step(..., gumbel=)`, so token
ids must match exactly (one flipped token cascades through every later
step), and pixels within atol 2e-3 / rtol 2e-2, the repo's bound for
module stacks. The port's streamed frames must also equal its own batch
decode of its tokens within f32 rounding (atol 2e-5 / rtol 1e-5, the JAX
package's pin). The model is `tests/test_serve.py`'s (head dim 8: the
plain attention path), weights carried across by `bridge.py`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from open_genie_tpu.models.genie import Genie as JGenie  # noqa: E402
from open_genie_tpu.serve import InteractiveSession as JSession  # noqa: E402
from open_genie_tpu_torch.bridge import load_flax_params  # noqa: E402
from open_genie_tpu_torch.models.genie import Genie  # noqa: E402
from open_genie_tpu_torch.serve import InteractiveSession  # noqa: E402
from test_serve import GENIE_CFG, H, W  # noqa: E402

torch.set_num_threads(1)
EXACT = dict(atol=2e-5, rtol=1e-5)
STACK_TOL = dict(atol=2e-3, rtol=2e-2)

# tests/test_serve.py's tokenizer with a decoder that gives 2 pixel frames
# per token frame (and an encoder that takes 2 per token frame).
TF2_TOKENIZER = dict(
    GENIE_CFG["tokenizer"],
    enc_desc=(
        ("spacetime_downsample", {
            "in_channels": 3, "kernel_size": 3, "out_channels": 8,
            "time_factor": 2, "space_factor": 4,
        }),
        ("causal-conv3d", {"in_channels": 8, "out_channels": 4, "kernel_size": 1}),
    ),
    dec_desc=(
        ("causal-conv3d", {"in_channels": 4, "out_channels": 8, "kernel_size": 3}),
        ("depth2spacetime_upsample", {
            "in_channels": 8, "out_channels": 3, "kernel_size": 3,
            "time_factor": 2, "space_factor": 4,
        }),
    ),
)
MODELS = {"tf1": GENIE_CFG, "tf2": dict(GENIE_CFG, tokenizer=TF2_TOKENIZER)}
_BUILT = {}


def _models(name):
    """(JAX Genie, its params, the port's Genie with the same weights)."""
    if name not in _BUILT:
        cfg = MODELS[name]
        jm = JGenie(**cfg)
        key = jax.random.PRNGKey(0)
        video = jnp.zeros((1, 4, H, W, 3), jnp.float32)
        params = jax.jit(lambda k: jm.init(k, video, k, method=jm.init_full))(key)["params"]
        tm = Genie(**cfg)
        load_flax_params(tm, jax.tree.map(np.asarray, params))
        _BUILT[name] = (jm, params, tm.eval())
    return _BUILT[name]


def _jax_gumbel(sess, seed, steps, vocab):
    """The noise JAX's session draws for the port session's next step."""
    rebases, f = sess._rebases, sess._t - sess._t0
    if f >= sess.max_frames:  # this step rebases first
        rebases, f = rebases + 1, 0
    base = jax.random.PRNGKey(seed)
    if rebases:
        base = jax.random.fold_in(base, rebases)
    key = jax.random.split(base, sess.max_frames)[f]
    b, hw = sess._buf.shape[0], sess._buf.shape[2] * sess._buf.shape[3]
    return torch.from_numpy(np.stack([
        np.asarray(jax.random.gumbel(sk, (b, hw, vocab), jnp.bfloat16).astype(jnp.float32))
        for sk in jax.random.split(key, steps)]))


def _prompt(seed, t=1):
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (1, t, H, W, 3)))


def _play(name, stream, max_frames, n_steps, seed=7, spf=3, top_k=None, pixel_window=2,
          prompt_t=1):
    """The same session in both packages: returns (JAX session, its reset
    pixels and frames, port session, its reset pixels and frames)."""
    jm, params, tm = _models(name)
    kw = dict(max_frames=max_frames, steps_per_frame=spf, pixel_window=pixel_window,
              top_k=top_k, stream=stream)
    js = JSession(jm, {"params": params}, **kw)
    ts = InteractiveSession(tm, device="cpu", **kw)
    prompt = _prompt(1, prompt_t)
    acts = np.random.default_rng(2).integers(0, 4, (1, prompt_t + n_steps)).astype(np.int32)
    j_first = js.reset(prompt, seed=seed, prompt_actions=acts[:, :prompt_t])
    t_first = ts.reset(prompt, seed=seed, prompt_actions=acts[:, :prompt_t])
    vocab = 2 ** tm.tokenizer.d_codebook
    j_frames, t_frames = [], []
    for i in range(n_steps):
        a = int(acts[0, prompt_t + i])
        t_frames.append(ts.step(a, gumbel=_jax_gumbel(ts, seed, spf, vocab)))
        j_frames.append(js.step(a))
    return js, j_first, j_frames, ts, t_first, t_frames


SESSION_CASES = {
    # (model, stream, max_frames, steps): 3 steps inside the horizon, then
    # 5 steps at a horizon of 2 (two rebases), each with the streaming and
    # the sliding-window decode.
    "stream": ("tf1", True, 3, 3),
    "window": ("tf1", False, 3, 3),
    "stream_rebase": ("tf1", True, 2, 5),
    "window_rebase": ("tf1", False, 2, 5),
    "tf2_stream_rebase": ("tf2", True, 2, 4),
    "tf2_window": ("tf2", False, 3, 3),
}


@pytest.mark.parametrize("case", list(SESSION_CASES))
def test_session_replays_jax(case):
    """Tokens exact, prompt pixels and every frame within the stack bound,
    with JAX's noise fed in; the rebase count and live window agree."""
    name, stream, max_frames, n_steps = SESSION_CASES[case]
    js, j_first, j_frames, ts, t_first, t_frames = _play(name, stream, max_frames, n_steps,
                                                        prompt_t=2 if name == "tf2" else 1)
    assert ts.stream is stream and js.stream is stream
    assert ts._rebases == js._rebases and ts._t == js._t and ts._keep == js._keep
    if "rebase" in case:
        assert ts._rebases >= 1
    np.testing.assert_array_equal(ts.tokens.numpy(), np.asarray(js.tokens))
    np.testing.assert_allclose(t_first.numpy(), np.asarray(j_first), **STACK_TOL)
    for got, want in zip(t_frames, j_frames):
        assert tuple(got.shape) == (1, H, W, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **STACK_TOL)


@pytest.mark.parametrize("name", ["tf1", "tf2"])
def test_stream_frames_equal_own_batch_decode(name):
    """Each streamed frame is the batch decode of the live token buffer at
    its position, the last frame after a rebase too; the reset's pixels
    are the prompt's decode."""
    _, _, tm = _models(name)
    sess = InteractiveSession(tm, max_frames=2, steps_per_frame=2, device="cpu")
    assert sess.stream
    first = sess.reset(_prompt(4, 2), seed=0)
    frames = [sess.step(i % 2) for i in range(2)]
    toks = sess.tokens
    batch = tm.decode_window(toks)
    tf = batch.shape[1] // toks.shape[1]
    assert tf == (2 if name == "tf2" else 1)
    np.testing.assert_allclose(first.numpy(), batch[:, : sess._t0 * tf].numpy(), **EXACT)
    for i, f in enumerate(frames):
        np.testing.assert_allclose(f.numpy(), batch[:, (sess._t0 + i + 1) * tf - 1].numpy(),
                                   **EXACT)
    last = [sess.step(i % 2) for i in range(3)][-1]  # rebases after the horizon
    assert sess._rebases >= 1
    toks = sess.tokens
    batch = tm.decode_window(toks)
    np.testing.assert_allclose(last.numpy(), batch[:, sess._t * tf - 1].numpy(), **EXACT)


def test_window_pixel_index_while_window_runs_past_t():
    """With `pixel_window` larger than the frames so far, the window starts
    at 0 and holds zero frames past `t`: the step returns the newest token
    frame's last pixel frame (`min(t, w) * tf - 1`), as JAX's does."""
    _, _, tm = _models("tf2")
    sess = InteractiveSession(tm, max_frames=3, steps_per_frame=2, pixel_window=3,
                              stream=False, device="cpu")
    sess.reset(_prompt(5, 2), seed=0)
    f = sess.step(1)
    t, w = sess._t, 3
    window = tm.decode_window(sess._buf[:, :w])
    assert t == 2 and window.shape[1] == 2 * w
    np.testing.assert_allclose(f.numpy(), window[:, min(t, w) * 2 - 1].numpy(), **EXACT)


def test_step_nosync_matches_step():
    _, _, tm = _models("tf1")
    runs = []
    for nosync in (False, True):
        sess = InteractiveSession(tm, max_frames=2, steps_per_frame=3, device="cpu")
        sess.reset(_prompt(6), seed=11)
        step = sess.step_nosync if nosync else sess.step
        runs.append((torch.stack([step(a) for a in (1, 3, 0, 2)]), sess.tokens))
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


def test_top_k_1_is_independent_of_the_noise():
    """Greedy sessions: two seeds, and JAX's noise, give the same tokens,
    equal to JAX's greedy session."""
    js, _, _, ts, _, _ = _play("tf1", True, 3, 3, seed=0, top_k=1)
    np.testing.assert_array_equal(ts.tokens.numpy(), np.asarray(js.tokens))
    _, _, tm = _models("tf1")
    streams = []
    for seed in (0, 123):
        sess = InteractiveSession(tm, max_frames=3, steps_per_frame=3, top_k=1, device="cpu")
        sess.reset(_prompt(1), seed=seed, prompt_actions=[[int(js._acts[0][0])]])
        for a in js._acts[1:]:
            sess.step(int(a[0]))
        streams.append(sess.tokens)
    assert torch.equal(streams[0], streams[1])
    np.testing.assert_array_equal(streams[0].numpy(), np.asarray(js.tokens))


def test_session_replays_rollout_with_the_same_generator():
    """The session's own noise: seeded like a generator given to
    `rollout_tokens`, it gives the rollout's tokens."""
    _, _, tm = _models("tf1")
    steps, n = 3, 3
    acts = torch.tensor([[2, 1, 0, 3]])
    sess = InteractiveSession(tm, max_frames=n, steps_per_frame=steps, device="cpu")
    prompt = torch.from_numpy(_prompt(8))
    sess.reset(prompt, seed=5, prompt_actions=acts[:, :1])
    for i in range(n):
        sess.step(int(acts[0, 1 + i]))
    want = tm.rollout_tokens(tm.tokenize_prompt(prompt), acts, n, steps,
                             generator=torch.Generator().manual_seed(5))
    assert torch.equal(sess.tokens, want)


def test_session_needs_cuda_unless_asked_for_the_cpu():
    _, _, tm = _models("tf1")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InteractiveSession(tm)
