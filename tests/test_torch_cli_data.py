"""The port's `make-data` against the JAX package's on the CPU: the
synthetic mp4 tree (layout, seeds, `--motion-scale`) decodes to the same
frames; `--source gym --env-name CartPole-v1` through gymnasium writes the
same layout, frame count and first frame (the random policy's
`action_space.sample()` is unseeded in both, so later frames differ); with
gym and gymnasium both hidden, both CLIs stop with `SystemExit`; without
OpenCV the port's mp4 writer raises, as JAX's does.
"""
import os
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
pytest.importorskip("torch")
pytest.importorskip("jax")

from open_genie_tpu import cli as jcli  # noqa: E402
from open_genie_tpu_torch import cli as tcli  # noqa: E402
from open_genie_tpu_torch.data.video import Platformer2D  # noqa: E402


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def _clips(root, env, split, frames):
    ds = Platformer2D(root=str(root), env_name=env, split=split, num_frames=frames)
    return [ds[i] for i in range(len(ds))]


def test_make_data_synthetic_matches_jax(tmp_path, capsys):
    flags = ["--num-videos", "9", "--timeout", "5", "--size", "16", "--motion-scale", "0.4"]
    jcli.main(["make-data", "--root", str(tmp_path / "jax")] + flags)
    jout = capsys.readouterr().out.replace(str(tmp_path / "jax"), "ROOT")
    tcli.main(["make-data", "--root", str(tmp_path / "port")] + flags)
    tout = capsys.readouterr().out.replace(str(tmp_path / "port"), "ROOT")
    assert tout == jout == ("wrote 9 videos to ROOT/Coinrun/train\n"
                            "wrote 1 videos to ROOT/Coinrun/val\n")
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    for split, n in (("train", 9), ("val", 1)):
        got = _clips(tmp_path / "port", "Coinrun", split, 5)
        want = _clips(tmp_path / "jax", "Coinrun", split, 5)
        assert len(got) == len(want) == n
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_make_data_gym_matches_jax(tmp_path, capsys):
    pytest.importorskip("gymnasium")
    flags = ["--source", "gym", "--env-name", "CartPole-v1", "--num-videos", "2",
             "--timeout", "6", "--size", "32"]
    jcli.main(["make-data", "--root", str(tmp_path / "jax")] + flags)
    jout = capsys.readouterr().out.replace(str(tmp_path / "jax"), "ROOT")
    tcli.main(["make-data", "--root", str(tmp_path / "port")] + flags)
    tout = capsys.readouterr().out.replace(str(tmp_path / "port"), "ROOT")
    assert tout == jout == "wrote 2 gym rollouts to ROOT/CartPole-v1/train\n"
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    got = _clips(tmp_path / "port", "CartPole-v1", "train", 6)
    want = _clips(tmp_path / "jax", "CartPole-v1", "train", 6)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (6, 32, 32, 3)
        np.testing.assert_array_equal(g[0], w[0])


def test_make_data_gym_without_gym_exits(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "gym", None)
    monkeypatch.setitem(sys.modules, "gymnasium", None)
    argv = ["make-data", "--root", str(tmp_path), "--source", "gym", "--env-name", "CartPole-v1"]
    for main in (jcli.main, tcli.main):
        with pytest.raises(SystemExit, match="requires the gym"):
            main(argv)
    assert not os.listdir(tmp_path)


def test_make_data_needs_opencv(tmp_path, monkeypatch):
    import open_genie_tpu_torch.data.video as tvideo

    monkeypatch.setattr(tvideo, "HAS_CV2", False)
    with pytest.raises(AssertionError, match="OpenCV is required"):
        tcli.main(["make-data", "--root", str(tmp_path), "--num-videos", "1", "--timeout", "2",
                   "--size", "16"])
