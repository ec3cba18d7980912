"""The session driver end to end on the CPU at a tiny configuration of the
cell's layer kinds: the program agrees with the plain reference, the
float8 control does not, and a broken timed path reads `correct` false."""
import json
import time
from pathlib import Path

import pytest
import torch

import harness

BENCH = Path(__file__).resolve().parents[1]
DRIVER = harness.load_module(BENCH / "drivers" / "session.py")
TESTS = Path(__file__).resolve().parent
LIMITS = json.loads((BENCH / "traffic" / "play-b32.json").read_text())["check"]["limits"]


def _config(name):
    if name == "tiny_serve":
        return json.loads((TESTS / "tiny_serve.json").read_text())
    from open_genie_tpu_torch.models import configs

    return {"name": name, "model": json.loads(json.dumps(getattr(configs, name)()))}


def _run(dtype="float32", control=False, steps=12, config="tiny_serve"):
    config = _config(config)
    config["dtype"] = dtype
    traffic = json.loads((TESTS / "tiny_play.json").read_text())
    traffic["check"]["limits"] = dict(LIMITS)
    return DRIVER.run({"name": "tiny"}, config, traffic, 2**31 + 11, 0.0, False,
                      time.perf_counter(), device="cpu", window_steps=steps, control=control)


def test_program_matches_reference_and_control_does_not():
    res = _run(control=True)
    assert res["correct"] and res["failed"] == 0
    assert all(c["value"] == pytest.approx(0.0, abs=1e-5) for c in res["checks"].values())
    # The f32 program computes the same as the reference; the float8
    # control, in its place, fails a limit of the cell.
    assert not res["control_correct"], res["control"]
    assert any(res["control"][k] > LIMITS[k] for k in LIMITS), res["control"]
    assert res["sample"]["served_tokens"] >= 4 * 16 * 4  # players x tokens x steps
    steps = res["sample"]["steps"]
    assert len(steps) == 2 and 0 in steps[max(steps, key=int)], steps  # a rebase between


def test_compact_config_matches_reference():
    """The port's own compact Genie (`genie_compact_config()`), served in
    f32, computes what the plain reference does."""
    res = _run(config="genie_compact_config")
    assert res["correct"]
    assert all(c["value"] == pytest.approx(0.0, abs=1e-5) for c in res["checks"].values())


def test_bf16_program_within_limits():
    res = _run(dtype="bfloat16")
    assert res["correct"], res["checks"]


def _altered(monkeypatch):
    from open_genie_tpu_torch.models.genie import Genie

    orig = Genie.session_step

    def step(self, buf, cache, t, *a, **k):
        buf, cache = orig(self, buf, cache, t, *a, **k)
        buf[:, t, 0, 0] = (buf[:, t, 0, 0] + 1) % self.dynamics.head.out_features
        return buf, cache

    monkeypatch.setattr(Genie, "session_step", step)


def _unchanged(monkeypatch):
    from open_genie_tpu_torch.models.genie import Genie

    monkeypatch.setattr(Genie, "session_step", lambda self, buf, cache, *a, **k: (buf, cache))


def _late_commit(monkeypatch, wrong):
    """From the second refinement of each frame on, `maskgit_commit` with
    `wrong` applied: `(logits, mask, code, n, temp, gumbel) -> (mask, code)`."""
    from open_genie_tpu_torch.models import genie as genie_mod
    from open_genie_tpu_torch.models.dynamics import gumbel_noise

    orig = genie_mod.maskgit_commit
    calls = []

    def commit(logits, mask, code, n, temp=1.0, top_k=None, generator=None, gumbel=None):
        calls.append(1)
        if bool(mask.all()):  # a frame's first refinement
            calls[:] = [1]
        if len(calls) < 2:
            return orig(logits, mask, code, n, temp, top_k, generator, gumbel)
        if gumbel is None:
            gumbel = gumbel_noise(logits.shape, generator, device=logits.device)
        return wrong(logits, mask, code, n, temp, gumbel)

    monkeypatch.setattr(genie_mod, "maskgit_commit", commit)


def _random_token(monkeypatch):
    from open_genie_tpu_torch.models import genie as genie_mod

    orig = genie_mod.maskgit_commit

    def wrong(logits, mask, code, n, temp, gumbel):
        left, code = orig(logits, mask, code, n, temp, gumbel=gumbel)
        new = mask & ~left
        rand = torch.randint_like(code, logits.shape[-1])
        return left, torch.where(new, rand, code)

    _late_commit(monkeypatch, wrong)


FAULTS = {"token_altered": (_altered, "refine_miss_pct"),
          "state_unchanged": (_unchanged, "maskgit_gap"),
          "late_random_token": (_random_token, "refine_miss_pct")}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_broken_timed_path_is_not_correct(monkeypatch, fault):
    plant, caught_by = FAULTS[fault]
    plant(monkeypatch)
    res = _run()
    assert not res["correct"]
    assert res["checks"][caught_by]["value"] > LIMITS[caught_by], res["checks"]


def test_reference_history_continues_the_full_pass():
    """`next_logits` after `history` is the full pass's last frame."""
    from reference import genie_serve as ref

    model = _config("tiny_serve")["model"]
    P = DRIVER.weights.make(ref.param_specs(model), 3, torch.device("cpu"))
    m = ref.SessionModel(model, P, ref.Ops())
    toks = torch.randint(0, 2 ** 10, (2, 5, 4, 4), generator=torch.Generator().manual_seed(1))
    acts = torch.randint(0, 16, (2, 5), generator=torch.Generator().manual_seed(2))
    want = m.logits(toks, acts)
    got = m.next_logits(m.history(toks[:, :4], acts[:, :4]), toks[:, 4], acts[:, 4])
    assert torch.allclose(got, want, atol=1e-4, rtol=1e-4)


def test_epochs_follow_the_session():
    """The epoch bookkeeping of `drivers/session.py` against the session's
    own counters."""
    from open_genie_tpu_torch.serve import InteractiveSession

    config = json.loads((TESTS / "tiny_serve.json").read_text())
    genie = DRIVER.build_genie(config["model"], 5, torch.device("cpu"), torch.float32)
    sess = InteractiveSession(genie, max_frames=3, steps_per_frame=2, device="cpu")
    sess.reset(torch.rand(2, 4, 32, 32, 3), seed=9)
    t0 = sess.tokens.shape[1]
    ep = DRIVER.Epochs(t0, max(1, (t0 + 3) // 2), 3, torch.zeros(2, t0, dtype=torch.long))
    for i in range(10):
        act = torch.tensor([i % 16, (i + 1) % 16])
        ep.before_step(sess)
        sess.step(act)
        ep.after_step(act, 2)
        e, j, pos = ep.steps[-1]
        assert (e, pos + 1) == (sess._rebases, sess._t)
        assert torch.equal(ep.record(sess)["tokens"], sess.tokens)
