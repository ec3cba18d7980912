"""The port's `eval {tokenizer,genie,dynamics}` against the JAX package's CLI
on the CPU, on checkpoints that hold the same weights twice over (JAX's
initialization with an EMA apart from it, saved by both loops; see
`tests/test_torch_cli.py`).

`eval` draws noise (the dynamics' Bernoulli masks, the controllability
branches); the port's harnesses take JAX's draws through the hooks that
`tests/test_torch_eval.py` uses. The printed lines and JSON keys must be
JAX's; deterministic metrics within 1e-4 relative, counts exact.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from open_genie_tpu.train.config import load_config as jload_config  # noqa: E402
from open_genie_tpu.train.losses import DynamicsTrainModule as JDynamicsTrainModule  # noqa: E402
from open_genie_tpu_torch import cli as tcli  # noqa: E402
from open_genie_tpu_torch import eval as teval  # noqa: E402
from open_genie_tpu_torch.data.tokens import write_token_shard  # noqa: E402
from open_genie_tpu_torch.train import trainer as ttrainer  # noqa: E402
from open_genie_tpu_torch.train.config import load_config as tload_config  # noqa: E402
from open_genie_tpu_torch.train.losses import DynamicsTrainModule  # noqa: E402
from test_torch_cli import STEP, _run_both, _save_both, genie_ckpts  # noqa: E402,F401
from test_torch_eval import _eval_masks  # noqa: E402
from test_torch_genie import _gumbel  # noqa: E402
from test_torch_trainer_tokenizer import _tokenizer_yaml, _write  # noqa: E402

torch.set_num_threads(1)
MODEL_REL = dict(rtol=1e-4, atol=1e-6)


def _dynamics_yaml(tokens):
    return f"""\
seed_everything: 4
model:
  dynamics:
    desc: [[space-time_attn, {{n_rep: 1, n_embd: 16, n_head: 2, d_head: 8}}]]
    embed_dim: 16
  tok_vocab: 16
  act_vocab: 4
  optimizer: {{lr: 3e-4, ema_decay: 0.9}}
data: {{source: tokens, root: {tokens}, batch_size: 3, num_workers: 2}}
trainer: {{precision: "32", n_data: 1}}
"""


def _report(lines):
    reports = [json.loads(line) for line in lines if line.startswith("{")]
    assert len(reports) == 1
    return reports[0]


def _reports_match(jout, tout, exact=("num_batches",)):
    jrep, trep = _report(jout), _report(tout)
    assert set(trep) == set(jrep)
    for k, v in trep.items():
        if k in exact:
            assert v == jrep[k], k
        else:
            np.testing.assert_allclose(v, jrep[k], **MODEL_REL, err_msg=k)
    assert [line for line in tout if not line.startswith("{")] == \
        [line.replace("_jax", "_port") for line in jout if not line.startswith("{")]
    return trep


@pytest.fixture(scope="module")
def tokenizer_ckpts(tmp_path_factory):
    from open_genie_tpu.train.trainer import build_tokenizer_module as jbuild

    root = tmp_path_factory.mktemp("tok")
    cfg = _write(root / "tok.yaml", _tokenizer_yaml(str(root), "tok"))
    jmod = jbuild(jload_config(cfg, kind="tokenizer").model)
    tmod = ttrainer.build_tokenizer_module(tload_config(cfg, "tokenizer").model)
    jdir, tdir = _save_both(root, "tok", jmod, jnp.zeros((2, 4, 16, 16, 3)), "tokenizer",
                            cfg, (), tmod)
    return root, cfg, jdir, tdir


@pytest.mark.parametrize("ema", [False, True], ids=["params", "ema"])
def test_eval_tokenizer_matches_jax(tokenizer_ckpts, capsys, ema):
    """`eval tokenizer` over the validation batches: the same JSON keys,
    PSNR/SSIM/MSE within 1e-4 relative, the code counts exact."""
    _, cfg, jdir, tdir = tokenizer_ckpts
    flags = ["--max-batches", "2"] + (["--ema"] if ema else [])
    jout, tout = _run_both(["eval", "tokenizer", "--config", cfg, "--ckpt", jdir] + flags,
                           ["eval", "tokenizer", "--config", cfg, "--ckpt", tdir] + flags,
                           capsys)
    rep = _reports_match(jout, tout, exact=("num_batches", "num_tokens", "usage",
                                            "distinct_codes", "usage_of_sampled_ceiling"))
    assert rep["num_batches"] == 1  # 3 validation clips in batches of 2
    assert tout[0] == (f"# restored EMA params at step {STEP} from {tdir}" if ema
                       else f"# restored checkpoint step {STEP} from {tdir}")
    with pytest.raises(ValueError, match="--ema requires --ckpt"):
        tcli.main(["eval", "tokenizer", "--config", cfg, "--ema", "--device", "cpu"])


def _jax_noise_hooks(monkeypatch, seed, mask_shape):
    """The port's `evaluate_genie`/`evaluate_dynamics` fed JAX's Bernoulli
    masks of `PRNGKey(seed)`, and `action_controllability` JAX's action
    sequences and Gumbel noise of `fold_in(PRNGKey(seed), 7)`."""
    key = jax.random.PRNGKey(seed)
    seen = {}

    def masked(fn):
        def run(model, loader, max_batches=None, generator=None, masks=None):
            n_batches = min(len(loader), max_batches or len(loader))
            seen["masks"] = n_batches
            return fn(model, loader, max_batches=max_batches,
                      masks=_eval_masks(key, n_batches, mask_shape))
        return run

    for name in ("evaluate_genie", "evaluate_dynamics"):
        monkeypatch.setattr(teval, name, masked(getattr(teval, name)))
    controllability = teval.action_controllability

    def jax_branches(genie, prompt, num_frames=8, steps_per_frame=8, n_branches=4,
                     action_pool=None, generator=None):
        k_act, k_sample = jax.random.split(jax.random.fold_in(key, 7))
        ids = jnp.asarray(action_pool, jnp.int32)
        seqs = [torch.from_numpy(np.array(ids[jax.random.randint(
            k, (prompt.shape[0], num_frames + 1), 0, len(ids))]))
            for k in jax.random.split(k_act, n_branches)]
        h, w = genie.tokenize_prompt(prompt).shape[-2:]
        shape = (prompt.shape[0], h * w, genie.dynamics.head.out_features)
        # `Genie.__call__`'s draws: split per frame, then per step.
        gumbels = [torch.from_numpy(np.stack([
            np.stack([_gumbel(sk, shape) for sk in jax.random.split(fk, steps_per_frame)])
            for fk in jax.random.split(k, num_frames)]))
            for k in jax.random.split(k_sample, n_branches)]
        seen["pool"] = np.asarray(action_pool).tolist()
        return controllability(genie, prompt, num_frames, steps_per_frame, n_branches,
                               action_pool=action_pool, action_seqs=seqs, gumbels=gumbels)

    monkeypatch.setattr(teval, "action_controllability", jax_branches)
    return seen


@pytest.mark.parametrize("ema", [False, True], ids=["params", "ema"])
def test_eval_genie_with_controllability_matches_jax(genie_ckpts, monkeypatch, capsys, ema):
    _, cfg, jdir, tdir = genie_ckpts
    seen = _jax_noise_hooks(monkeypatch, 7, (2, 4, 4, 4))
    flags = ["--controllability-frames", "2"] + (["--ema"] if ema else [])
    jout, tout = _run_both(["eval", "genie", "--config", cfg, "--ckpt", jdir] + flags,
                           ["eval", "genie", "--config", cfg, "--ckpt", tdir] + flags, capsys)
    rep = _reports_match(jout, tout, exact=(
        "num_batches", "act_code_usage", "controllability_frames",
        "controllability_branches", "controllability_pool"))
    assert {"action_to_noise_ratio", "controllability_pool"} <= set(rep)
    assert seen["masks"] == 1 and rep["controllability_pool"] == len(seen["pool"])
    kind = "EMA params" if ema else "checkpoint"
    assert tout[0] == f"# restored {kind} step {STEP} from {tdir}"


@pytest.fixture(scope="module")
def dynamics_ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("dyn")
    rng = np.random.default_rng(5)
    for split, n in (("train", 3), ("val", 3)):
        for i in range(n):
            write_token_shard(str(root / "tokens" / split / f"{i:06d}.npz"),
                              rng.integers(0, 16, (3, 4, 4)).astype(np.int32),
                              rng.integers(0, 4, (3,)).astype(np.int32))
    cfg = _write(root / "dyn.yaml", _dynamics_yaml(root / "tokens"))
    jcfg = jload_config(cfg, kind="dynamics")
    jmod = JDynamicsTrainModule(dynamics=jcfg.model.dynamics_kwargs())
    tmod = DynamicsTrainModule(dynamics=tload_config(cfg, "dynamics").model.dynamics_kwargs())
    sample = {"tokens": np.zeros((3, 3, 4, 4), np.int32), "actions": np.zeros((3, 3), np.int32)}
    jdir, tdir = _save_both(root, "dyn", jmod, sample, "dynamics", cfg, (), tmod)
    return root, cfg, jdir, tdir


@pytest.mark.parametrize("ema", [False, True], ids=["params", "ema"])
def test_eval_dynamics_matches_jax(dynamics_ckpts, monkeypatch, capsys, ema):
    root, cfg, jdir, tdir = dynamics_ckpts
    seen = _jax_noise_hooks(monkeypatch, 4, (3, 3, 4, 4))
    flags = ["--max-batches", "2"] + (["--ema"] if ema else [])
    jout, tout = _run_both(["eval", "dynamics", "--config", cfg, "--ckpt", jdir] + flags,
                           ["eval", "dynamics", "--config", cfg, "--ckpt", tdir] + flags, capsys)
    rep = _reports_match(jout, tout)
    assert rep["num_batches"] == 1 and seen["masks"] == 1
    synthetic = _write(root / "syn.yaml", _dynamics_yaml(root / "tokens").replace(
        "source: tokens", "source: synthetic"))
    with pytest.raises(ValueError, match="token shards"):
        tcli.main(["eval", "dynamics", "--config", synthetic, "--device", "cpu"])


def test_new_commands_need_cuda_or_an_explicit_cpu(genie_ckpts, tokenizer_ckpts):
    """Without CUDA, `generate`, `play` and `eval` raise unless `--device
    cpu` is given."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the commands would run")
    _, cfg, _, tdir = genie_ckpts
    _, tok_cfg, _, _ = tokenizer_ckpts
    for argv in (["generate", "--config", cfg, "--frames", "1", "--size", "16"],
                 ["play", "--config", cfg, "--actions", "0", "--size", "16"],
                 ["eval", "genie", "--config", cfg],
                 ["eval", "tokenizer", "--config", tok_cfg]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tcli.main(argv)
