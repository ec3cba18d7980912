"""The port's native `.gvid` loader (`open_genie_tpu_torch/data/native.py`)
against the JAX package's on the same file.

The port builds its own `libgvid.so` from `native/gvid_loader.cpp` into
`build/gvid/<hash>/` (the JAX package loads `native/libgvid.so`). Both read
the file the port writes: `GVidDataset` items, with and without a random
start, and `NativeBatchLoader` batches, shuffled with random starts, over
two epochs for two seeds, must be equal. `seek` mid-epoch gives the tail
of an uninterrupted run; the loader serves pinned batches when asked, and
stops its C++ threads when the consumer stops early. Six processes that
build at once from a cold cache end with one library.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnative = pytest.importorskip("open_genie_tpu.data.native")

from open_genie_tpu_torch.data import native as tnative  # noqa: E402
from open_genie_tpu_torch.train import config as tconfig  # noqa: E402
from open_genie_tpu_torch.train import trainer as ttrainer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIPS = 7


@pytest.fixture(scope="module")
def gvid(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("gvid") / "clips.gvid")
    videos = np.random.default_rng(0).integers(0, 256, (CLIPS, 9, 8, 12, 3), dtype=np.uint8)
    tnative.write_gvid(path, videos)
    return path, videos


def test_write_and_read_match_jax(gvid, tmp_path):
    path, videos = gvid
    jax_path = str(tmp_path / "jax.gvid")
    jnative.write_gvid(jax_path, videos)
    with open(path, "rb") as a, open(jax_path, "rb") as b:
        assert a.read() == b.read()
    ds, jds = tnative.GVidDataset(path), jnative.GVidDataset(path)
    assert len(ds) == len(jds) == CLIPS
    for i in range(CLIPS):
        np.testing.assert_array_equal(ds[i], jds[i])
    # the C++ side multiplies by the f32 reciprocal of 255
    np.testing.assert_array_equal(ds[2], videos[2].astype(np.float32) * np.float32(1 / 255))


def test_random_start_items_match_jax(gvid):
    path, _ = gvid
    ds = tnative.GVidDataset(path, num_frames=4, randomize=True, seed=5)
    jds = jnative.GVidDataset(path, num_frames=4, randomize=True, seed=5)
    for i in (0, 3, 3, 6, 1):
        got = ds[i]
        assert got.shape == (4, 8, 12, 3)
        np.testing.assert_array_equal(got, jds[i])


@pytest.mark.parametrize("seed", [0, 3])
def test_batches_match_jax_over_two_epochs(gvid, seed):
    """Shuffled clips and random starts (9 frames, clips of 4): JAX's
    batches in JAX's order, epoch after epoch."""
    path, _ = gvid
    ds, jds = tnative.GVidDataset(path, num_frames=4), jnative.GVidDataset(path, num_frames=4)
    loader = tnative.NativeBatchLoader(ds, batch_size=3, num_threads=2, seed=seed)
    jloader = jnative.NativeBatchLoader(jds, batch_size=3, num_threads=2, seed=seed)
    assert len(loader) == len(jloader) == 2
    epochs = []
    for _ in range(2):
        got, want = [b.numpy().copy() for b in loader], list(jloader)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g.shape == (3, 4, 8, 12, 3)
            np.testing.assert_array_equal(g, w)
        epochs.append(got)
    assert not np.array_equal(epochs[0][0], epochs[1][0])


def test_unshuffled_validation_batches_match_jax(gvid):
    path, _ = gvid
    ds, jds = tnative.GVidDataset(path, num_frames=9), jnative.GVidDataset(path, num_frames=9)
    got = list(tnative.NativeBatchLoader(ds, batch_size=2, shuffle=False, seed=1))
    want = list(jnative.NativeBatchLoader(jds, batch_size=2, shuffle=False, seed=1))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert len(got) == 3


@pytest.mark.parametrize("at", [1, 3, 4])
def test_seek_continues_an_uninterrupted_run(gvid, at):
    """`seek(at)` then iterating gives batches `at...` of an uninterrupted
    run, within the epoch and across its end (`BatchLoader.seek`'s
    semantics; JAX's native loader restarts the epoch)."""
    path, _ = gvid
    ds = tnative.GVidDataset(path, num_frames=4)
    whole = tnative.NativeBatchLoader(ds, batch_size=3, seed=2)
    run = [b.numpy().copy() for _ in range(3) for b in whole]
    resumed = tnative.NativeBatchLoader(ds, batch_size=3, seed=2)
    resumed.seek(at)
    tail = [b.numpy().copy() for _ in range(2) for b in resumed]
    assert len(tail) == 4 - at % 2
    for g, w in zip(tail, run[at:]):
        np.testing.assert_array_equal(g, w)


def test_epoch_specs_are_jax_draw_order(gvid):
    """The spec of each batch: the shuffled clip ids, then their start
    frames, from one `default_rng(seed + epoch)`."""
    path, _ = gvid
    loader = tnative.NativeBatchLoader(tnative.GVidDataset(path, num_frames=4), batch_size=3,
                                       seed=4)
    rng = np.random.default_rng(4 + 2)
    order = np.arange(CLIPS)
    rng.shuffle(order)
    specs = loader.epoch_specs(2)
    for bi, spec in enumerate(specs):
        spec = spec.reshape(3, 2)
        np.testing.assert_array_equal(spec[:, 0], order[bi * 3: bi * 3 + 3])
        np.testing.assert_array_equal(spec[:, 1], rng.integers(0, 6, 3))


def test_early_stop_stops_the_prefetcher_and_pins(gvid, monkeypatch):
    path, _ = gvid
    ds = tnative.GVidDataset(path, num_frames=4)
    stops = []

    class Spy:
        def __getattr__(self, name):
            return getattr(tnative.library(), name)

        def gvid_prefetch_stop(self, handle):
            stops.append(handle)
            tnative.library().gvid_prefetch_stop(handle)

    monkeypatch.setattr(ds, "lib", Spy())
    loader = tnative.NativeBatchLoader(ds, batch_size=2, seed=0)
    for batch in loader:
        break
    assert stops == [ds.handle]
    assert not batch.is_pinned()
    if torch.cuda.is_available():
        loader.pin_memory = True
        assert next(iter(loader)).is_pinned()


def test_build_dataset_and_loader_serve_gvid(gvid, tmp_path):
    """`data.source: gvid`: `<root>/<split>.gvid` or one file for both
    splits; `build_loader` returns the native loader (`num_workers`
    threads, shuffled only for train) and the loop's `seek` works on it."""
    path, videos = gvid
    os.symlink(path, tmp_path / "train.gvid")
    os.symlink(path, tmp_path / "val.gvid")
    cfg = tconfig.ExperimentConfig(model=None, data=tconfig.DataConfig(
        source="gvid", num_frames=4, batch_size=2), trainer=tconfig.TrainerConfig())
    for root in (str(tmp_path), path):
        cfg.data.root = root
        for split in ("train", "val"):
            ds = ttrainer.build_dataset(cfg.data, split)
            assert isinstance(ds, tnative.GVidDataset) and len(ds) == CLIPS
            loader = ttrainer.build_loader(cfg, ds, "cpu", split)
            assert isinstance(loader, tnative.NativeBatchLoader)
            assert loader.shuffle == (split == "train")
            assert loader.num_threads == cfg.data.num_workers
    cfg.data.root = str(tmp_path / "missing")
    os.makedirs(cfg.data.root)
    with pytest.raises(FileNotFoundError):
        ttrainer.build_dataset(cfg.data, "val")


def test_cold_build_from_six_processes_yields_one_library(tmp_path):
    """Six processes build a cold cache at once: one compile, one library,
    no temporary file left, and every process loads it."""
    code = ("import sys; from pathlib import Path; from open_genie_tpu_torch.data import native\n"
            "native.BUILD_ROOT = Path(sys.argv[1])\n"
            "native.library(); print(native.BUILD['path'], native.BUILD['built'])\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err for _, err in outs]
    paths = {out.split()[0] for out, _ in outs}
    built = [out.split()[1] == "True" for out, _ in outs]
    assert len(paths) == 1 and sum(built) == 1
    lib_dir = os.path.dirname(paths.pop())
    assert sorted(os.listdir(lib_dir)) == ["build.lock", "libgvid.so"]


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="(?s)bad.cpp failed.*error: expected"):
        tnative._build()
    assert not any(p.name.endswith(".so") for p in (tmp_path / "build").rglob("*"))
