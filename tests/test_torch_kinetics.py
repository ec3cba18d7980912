"""The port's copy of the Kinetics reader (`open_genie_tpu_torch/data/kinetics.py`)
against the JAX package's on the tree `tests/test_data.py` builds (two
classes of two 10-frame mp4s) and on an official annotation CSV: the same
clip index, items, labels and classes, with `step_between_clips`,
`frame_rate` resampling, the single padded clip of a short video, random
crops and `output_format`; and `build_dataset`'s `kinetics` source.
"""
import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
pytest.importorskip("torch")

from open_genie_tpu.data.kinetics import KineticsFolder as JKinetics  # noqa: E402
from open_genie_tpu_torch.data.kinetics import KineticsFolder  # noqa: E402
from open_genie_tpu_torch.data.video import SyntheticVideo, write_mp4  # noqa: E402
from open_genie_tpu_torch.train import config as tconfig  # noqa: E402
from open_genie_tpu_torch.train import trainer as ttrainer  # noqa: E402


@pytest.fixture(scope="module")
def kinetics_tree(tmp_path_factory):
    """root/{train,val}/<class>/*.mp4 (val: one 3-frame video)."""
    root = tmp_path_factory.mktemp("kinetics")
    ds = SyntheticVideo(num_videos=4, num_frames=10, height=16, width=16)
    for ci, cls in enumerate(("jumping", "running")):
        d = root / "train" / cls
        d.mkdir(parents=True)
        for i in range(2):
            write_mp4(str(d / f"v{i}.mp4"), ds[ci * 2 + i])
    (root / "val" / "jumping").mkdir(parents=True)
    write_mp4(str(root / "val" / "jumping" / "short.mp4"), ds[0][:3])
    return str(root)


def _same(kw, root):
    got, want = KineticsFolder(root=root, **kw), JKinetics(root=root, **kw)
    assert len(got) == len(want) and got.labels == want.labels and got.classes == want.classes
    for i in range(len(got)):
        (a, la), (b, lb) = got.get_with_label(i), want.get_with_label(i)
        assert la == lb
        np.testing.assert_array_equal(a, b)
    return got


@pytest.mark.parametrize("kw", [
    dict(frames_per_clip=5),
    dict(frames_per_clip=5, step_between_clips=3),
    dict(frames_per_clip=4, frame_rate=15),
    dict(frames_per_clip=4, frame_rate=15, step_between_clips=2, output_format="c t h w"),
    dict(frames_per_clip=5, randomize=True, seed=3),
], ids=["dense", "step3", "fps15", "fps15_step2_cthw", "random_crop"])
def test_items_labels_and_lengths_match_jax(kinetics_tree, kw):
    ds = _same(dict(split="train", **kw), kinetics_tree)
    assert ds.classes == ["jumping", "running"]
    if not kw.get("randomize"):
        assert sorted(set(ds.labels)) == [0, 1] and len(ds) > 4


def test_short_video_gives_one_padded_clip(kinetics_tree):
    for padding in ("repeat", "zero"):
        ds = _same(dict(split="val", frames_per_clip=6, padding=padding), kinetics_tree)
        assert len(ds) == 1 and ds[0].shape == (6, 16, 16, 3)


def test_annotation_csv_matches_jax(tmp_path):
    root = tmp_path / "k400"
    (root / "annotations").mkdir(parents=True)
    vids = SyntheticVideo(num_videos=3, num_frames=8, height=16, width=16)
    (root / "val" / "abseiling").mkdir(parents=True)
    (root / "val" / "zumba").mkdir(parents=True)
    write_mp4(str(root / "val" / "abseiling" / "ytid00001_000010_000020.mp4"), vids[0])
    write_mp4(str(root / "val" / "ytid00002_000005_000015.mp4"), vids[1])  # flat
    (root / "annotations" / "val.csv").write_text(
        "label,youtube_id,time_start,time_end,split,is_cc\n"
        "abseiling,ytid00001,10,20,val,0\n"
        "zumba,ytid00002,5,15,val,0\n"
        "zumba,ytid_missing,0,10,val,0\n"
    )
    ds = _same(dict(split="val", frames_per_clip=8, num_classes="600"), str(root))
    assert ds.classes == ["abseiling", "zumba"] and ds.labels == [0, 1]


def test_build_dataset_serves_kinetics(kinetics_tree):
    """`data.source: kinetics` builds `KineticsFolder` with JAX's
    arguments; the split `valid` reads `val`."""
    data = tconfig.DataConfig(source="kinetics", root=kinetics_tree, num_frames=5,
                              step_between_clips=2, frame_rate=15)
    ds = ttrainer.build_dataset(data, "train")
    assert isinstance(ds, KineticsFolder) and ds.step_between_clips == 2
    assert ds.frame_rate == 15 and ds.frames_per_clip == 5
    assert ttrainer.build_dataset(data, "valid").split == "val"
    with pytest.raises(FileNotFoundError):
        ttrainer.build_dataset(data, "test")
