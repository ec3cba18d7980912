"""Spans inside the port (`utils/debug.py::span`).

With no profiler recording a span is one shared no-op: nothing is recorded
and no `record_function` range opens. Under a `torch.profiler` an
`InteractiveSession` step emits `session.step` and, as its children, in
order: `session.rebase` (a rebase step only; its stream prefill's
`tokenizer.decode_stream` spans inside it), `dynamics.refine` and
`maskgit.sample` per refinement, `dynamics.commit`,
`tokenizer.decode_stream` and `session.to_host` (`step` only). The spans
of one step share its id, and profiling changes no token and no pixel. The
trainer's profiler window holds `train.forward`, `train.backward` and
`train.optimizer`. On the card (`-m cuda`): the children's event-timed
device milliseconds sum to within 3% of `session.step`'s on the
`genie_serve` session.
"""
import contextlib
import json
import os

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from open_genie_tpu_torch.models.configs import genie_serve_config  # noqa: E402
from open_genie_tpu_torch.models.genie import Genie  # noqa: E402
from open_genie_tpu_torch.serve import InteractiveSession  # noqa: E402
from open_genie_tpu_torch.train import config as tconfig  # noqa: E402
from open_genie_tpu_torch.train import trainer as ttrainer  # noqa: E402
from open_genie_tpu_torch.utils import debug, init_weights  # noqa: E402

torch.set_num_threads(1)
H = W = 16
SPF = 2
# Two frames of 16x16 pixels to two 4x4 token frames of a 16-token
# vocabulary; the decoder streams (causal conv, stateless upsample).
CFG = dict(
    tokenizer=dict(
        enc_desc=(
            ("spacetime_downsample", {"in_channels": 3, "kernel_size": 3, "out_channels": 8,
                                      "time_factor": 1, "space_factor": 4}),
            ("causal-conv3d", {"in_channels": 8, "out_channels": 4, "kernel_size": 1}),
        ),
        dec_desc=(
            ("causal-conv3d", {"in_channels": 4, "out_channels": 8, "kernel_size": 3}),
            ("depth2spacetime_upsample", {"in_channels": 8, "out_channels": 3, "kernel_size": 3,
                                          "time_factor": 1, "space_factor": 4}),
        ),
        d_codebook=4,
    ),
    latent_action=dict(
        enc_desc=(("space-time_attn", {"n_rep": 1, "n_embd": 8, "n_head": 1, "d_head": 8}),),
        dec_desc=(("space-time_attn", {"n_rep": 1, "n_embd": 8, "n_head": 1, "d_head": 8}),),
        d_codebook=2, n_embd=8, inp_shape=(H, W),
    ),
    dynamics=dict(
        desc=(("space-time_attn", {"n_rep": 1, "n_embd": 16, "n_head": 2, "d_head": 8}),),
        embed_dim=16,
    ),
)
TOP = {"session.rebase", "dynamics.refine", "maskgit.sample", "dynamics.commit",
       "tokenizer.decode_stream", "session.to_host"}


@pytest.fixture(scope="module")
def genie():
    return init_weights(Genie(**CFG), torch.Generator().manual_seed(0)).eval()


def _session(genie, max_frames=2):
    sess = InteractiveSession(genie, max_frames=max_frames, steps_per_frame=SPF, device="cpu")
    assert sess.stream
    prompt = torch.rand((2, 2, H, W, 3), generator=torch.Generator().manual_seed(1))
    sess.reset(prompt, seed=3)
    return sess


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _children(spans, parent):
    return [s["name"] for s in spans if s["parent"] == parent]


def test_span_is_a_shared_noop_without_a_profiler(genie, monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: entered.append(name))
    sess = _session(genie)
    before = [s["id"] for s in debug.span_record()]
    assert debug.span("a") is debug.span("b")
    for a in (0, 1, 0):  # the third step rebases
        sess.step(a)
    sess.step_nosync(1)
    assert sess._rebases == 1
    assert [s["id"] for s in debug.span_record()] == before and entered == []


def test_span_record_takes_the_last_roots():
    with _cpu_profile():
        for root in ("r0", "r1", "r2"):
            with debug.span(root):
                with debug.span("child"):
                    with debug.span("grandchild"):
                        pass
    spans = debug.span_record(2)
    assert [s["name"] for s in spans] == ["r1", "child", "grandchild", "r2", "child",
                                          "grandchild"]
    r1, child, grand = spans[:3]
    assert (r1["parent"], child["parent"], grand["parent"]) == (None, r1["id"], child["id"])
    assert {s["step"] for s in spans[:3]} == {r1["id"]} and spans[3]["step"] == spans[3]["id"]
    assert all(s["device_ms"] is None for s in spans)  # no CUDA events on the CPU
    assert debug.span_record(0) == []


def test_session_step_emits_the_spans_as_documented(genie):
    sess = _session(genie)
    with _cpu_profile() as prof:
        for a in (0, 1, 0):  # the third step rebases onto `keep` frames
            sess.step(a)
        sess.step_nosync(1)
    keep = sess._keep
    spans = debug.span_record(4)
    roots = [s for s in spans if s["parent"] is None]
    assert [r["name"] for r in roots] == ["session.step"] * 4
    assert len({r["step"] for r in roots}) == 4
    per_frame = ["dynamics.refine", "maskgit.sample"] * SPF + ["dynamics.commit",
                                                               "tokenizer.decode_stream"]
    for i, root in enumerate(roots):
        mine = [s for s in spans if s["step"] == root["id"]]
        want = (["session.rebase"] if i == 2 else []) + per_frame + (
            ["session.to_host"] if i < 3 else [])
        assert _children(mine, root["id"]) == want
        for s in mine:
            if s["parent"] is not None and s["parent"] != root["id"]:
                parent = next(p for p in mine if p["id"] == s["parent"])
                assert (parent["name"], s["name"]) == ("session.rebase",
                                                       "tokenizer.decode_stream")
        nested = len(mine) - 1 - len(want)
        assert nested == (keep if i == 2 else 0)
    names = {e.name for e in prof.events()}
    assert TOP | {"session.step"} <= names


@pytest.mark.parametrize("method", ["step", "step_nosync"])
def test_profiling_changes_no_token_and_no_pixel(genie, method):
    runs = []
    for traced in (False, True):
        sess = _session(genie)
        with _cpu_profile() if traced else contextlib.nullcontext():
            frames = torch.stack([getattr(sess, method)(a) for a in (1, 0, 1, 0)])
        runs.append((frames, sess.tokens))
    assert sess._rebases == 1
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


TRAIN_YAML = """\
seed_everything: 5
model:
  enc_desc:
    - [spacetime_downsample, {{in_channels: 3, kernel_size: 3, out_channels: 8, time_factor: 1, space_factor: 4}}]
    - [causal-conv3d, {{in_channels: 8, out_channels: 4, kernel_size: 1}}]
  dec_desc:
    - [causal-conv3d, {{in_channels: 4, out_channels: 8, kernel_size: 3}}]
    - [depth2spacetime_upsample, {{in_channels: 8, out_channels: 3, kernel_size: 3, time_factor: 1, space_factor: 4}}]
  d_codebook: 4
  disc_kwargs: {{inp_size: [16, 16], model_dim: 8, dim_mults: [1, 2], down_step: [null, 2], num_groups: 4, use_attn: false}}
  gan_frames_per_batch: 2
  perc_loss_weight: 0.0
  optimizer: {{lr: 1e-3}}
data: {{source: synthetic, num_frames: 4, batch_size: 2, height: 16, width: 16, num_videos: 8, num_workers: 0}}
trainer:
  max_steps: 3
  precision: "32"
  val_check_interval: 0
  ckpt_every_n_steps: 100
  save_last: false
  profile_start_step: 1
  profile_num_steps: 2
  ckpt_dir: {root}/ckpt
  log_dir: {root}/logs
"""


def test_trainer_profile_window_shows_the_train_spans(tmp_path):
    path = tmp_path / "tok.yaml"
    path.write_text(TRAIN_YAML.format(root=tmp_path))
    ttrainer.train_tokenizer(tconfig.load_config(str(path), "tokenizer"), device="cpu")
    prof_dir = tmp_path / "logs" / "profile"
    traces = [f for f in os.listdir(prof_dir) if f.endswith(".pt.trace.json")]
    assert len(traces) == 1
    events = json.loads((prof_dir / traces[0]).read_text())["traceEvents"]
    counts = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            counts[e["name"]] = counts.get(e["name"], 0) + 1
    assert {k: counts.get(k) for k in ("train.forward", "train.backward", "train.optimizer")
            } == {"train.forward": 2, "train.backward": 2, "train.optimizer": 2}


@pytest.mark.cuda
def test_step_children_partition_the_step_on_the_card():
    """`genie_serve` in bf16 at 32 players, 4-frame 64x64 prompts, spf 8:
    over 3 profiled steps (after 2 warm ones) the children of each
    `session.step` take within 3% of its event-timed device time."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    with torch.device("cuda"):
        g = Genie(**genie_serve_config())
    g = g.to(torch.bfloat16).eval()
    sess = InteractiveSession(g, max_frames=64, steps_per_frame=8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    sess.reset(torch.rand((32, 4, 64, 64, 3), generator=gen, device="cuda").to(torch.bfloat16),
               seed=1)
    for a in range(2):
        sess.step(a)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for a in range(3):
            sess.step(a)
    spans = debug.span_record(3)
    roots = [s for s in spans if s["parent"] is None]
    assert [r["name"] for r in roots] == ["session.step"] * 3
    for root in roots:
        kids = [s for s in spans if s["parent"] == root["id"]]
        assert {s["name"] for s in kids} <= TOP and len(kids) == 2 * 8 + 3
        total = sum(s["device_ms"] for s in kids)
        assert root["device_ms"] > 0 and abs(total - root["device_ms"]) <= 0.03 * root["device_ms"]
