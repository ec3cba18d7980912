"""Kinetics dataset with the official torchvision layout semantics (copy of
`open_genie_tpu.data.kinetics`).

Equivalent of the reference's `LightningKinetics`
(its `genie/dataset.py:9-93`), which wraps
`torchvision.datasets.Kinetics`. Beyond a bare class-folder scan this
covers the official dataset's on-disk contract:

- **split dirs** `root/{train,val,test}/<class>/*.{mp4,avi}`;
- **annotation csvs** `root/annotations/{split}.csv` (official download
  layout: `label,youtube_id,time_start,time_end,split,...`) — when present
  they define the sample set: each row resolves to
  `{youtube_id}_{time_start:06d}_{time_end:06d}.mp4` under the labelled
  class dir (or flat in the split dir); rows whose file is absent are
  skipped, since partial mirrors are the norm;
- **clip enumeration**: `frames_per_clip` windows every
  `step_between_clips` frames (torchvision `VideoClips` semantics) when
  `randomize=False`; videos shorter than a clip contribute one padded clip
  instead of being dropped;
- **frame-rate resampling**: `frame_rate` re-samples each video from its
  native fps by integer frame stride;
- `num_classes` ('400'|'600'|'700') and `output_format` accepted for API
  compat ('thwc' is the framework invariant; 'cthw' transposes per-sample).

Download is intentionally unsupported (zero-egress environment; the
reference's `download=True` delegates to torchvision's downloader).
Returns channels-last `(T, H, W, C)` float clips; class labels via
`labels`/`classes`/`get_with_label` for consumers that want them (the
generative models ignore them, as the reference does).
"""
from __future__ import annotations

import csv
import os
from typing import List, Optional, Tuple

import numpy as np

from open_genie_tpu_torch.data.video import HAS_CV2, VideoDataset


def _probe(path: str) -> Tuple[int, float]:
    """(frame_count, native_fps) from the container header."""
    import cv2

    cap = cv2.VideoCapture(path)
    try:
        return (
            int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
            float(cap.get(cv2.CAP_PROP_FPS)) or 0.0,
        )
    finally:
        cap.release()


def _read_clip(
    path: str,
    start: int,
    num_frames: int,
    stride: int,
    padding: str,
    rng: np.random.Generator,
) -> np.ndarray:
    """Decode `num_frames` RGB frames from `start`, one every `stride`,
    padding a short tail per the Platformer2D padding modes."""
    import cv2

    cap = cv2.VideoCapture(path)
    cap.set(cv2.CAP_PROP_POS_FRAMES, start)
    frames: List[np.ndarray] = []
    while len(frames) < num_frames:
        ret, frame = cap.read()
        if not ret:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        for _ in range(stride - 1):
            if not cap.grab():
                break
    cap.release()
    if not frames:
        raise OSError(f"no decodable frames in {path}")
    missing = num_frames - len(frames)
    if missing > 0:
        if padding == "none":
            pass
        elif padding == "repeat":
            frames.extend([frames[-1]] * missing)
        elif padding == "zero":
            frames.extend([np.zeros_like(frames[-1])] * missing)
        elif padding == "random":
            frames.extend(
                (rng.random(frames[-1].shape) * 255).astype(np.uint8)
                for _ in range(missing)
            )
        else:
            raise ValueError(f"Invalid padding type: {padding}")
    return np.stack(frames).astype(np.float32) / 255.0  # (T, H, W, C)


class KineticsFolder(VideoDataset):
    def __init__(
        self,
        root: str,
        split: str = "train",
        frames_per_clip: int = 16,
        step_between_clips: int = 1,
        frame_rate: Optional[int] = None,
        num_classes: str = "400",
        extensions: Tuple[str, ...] = ("avi", "mp4"),
        padding: str = "repeat",
        randomize: bool = False,
        transform=None,
        output_format: str = "thwc",
        seed: int = 0,
    ) -> None:
        assert HAS_CV2, "OpenCV is required for Kinetics-style datasets"
        assert num_classes in ("400", "600", "700"), num_classes
        fmt = output_format.lower().replace(" ", "")
        assert fmt in ("thwc", "cthw"), output_format
        self.root = os.path.join(root, split)
        self.split = split
        self.frames_per_clip = frames_per_clip
        self.step_between_clips = max(1, int(step_between_clips))
        self.frame_rate = frame_rate
        self.padding = padding
        self.randomize = randomize
        self.transform = transform or (lambda x: x)
        self.output_format = fmt
        self.rng = np.random.default_rng(seed)

        ann = os.path.join(root, "annotations", f"{split}.csv")
        if os.path.exists(ann):
            self.classes, self.samples = self._from_annotations(
                ann, extensions
            )
        else:
            self.classes, self.samples = self._from_folders(extensions)
        if not self.samples:
            raise FileNotFoundError(
                f"no video files for split '{split}' under {root}"
            )

        # Clip index (torchvision VideoClips semantics): windows of
        # `frames_per_clip` source frames (x temporal stride when
        # resampling) every `step_between_clips` frames. randomize=True
        # keeps video-level indexing with a random temporal crop instead.
        self._meta = [_probe(p) for p, _ in self.samples]
        self._clips: List[Tuple[int, int]] = []  # (sample idx, start frame)
        if not self.randomize:
            for si, (total, fps) in enumerate(self._meta):
                span = self.frames_per_clip * self._stride(fps)
                n = max(0, (total - span) // self.step_between_clips + 1)
                if n == 0:
                    # Too short for one full window: one padded clip
                    # rather than torchvision's silent drop.
                    self._clips.append((si, 0))
                else:
                    self._clips.extend(
                        (si, k * self.step_between_clips) for k in range(n)
                    )

    def _stride(self, native_fps: float) -> int:
        if self.frame_rate is None or native_fps <= 0:
            return 1
        return max(1, int(round(native_fps / self.frame_rate)))

    def _from_folders(self, extensions) -> Tuple[List[str], list]:
        if not os.path.isdir(self.root):
            raise FileNotFoundError(self.root)
        classes = sorted(
            d for d in os.listdir(self.root)
            if os.path.isdir(os.path.join(self.root, d))
        )
        samples = []
        for ci, cls in enumerate(classes):
            cdir = os.path.join(self.root, cls)
            for f in sorted(os.listdir(cdir)):
                if f.rsplit(".", 1)[-1].lower() in extensions:
                    samples.append((os.path.join(cdir, f), ci))
        return classes, samples

    def _from_annotations(self, ann: str, extensions) -> Tuple[List[str], list]:
        """Official csv -> sample list. Each row's clip file is
        `{youtube_id}_{time_start:06d}_{time_end:06d}.<ext>` under the
        labelled class dir, or flat in the split dir; absent files are
        skipped (partial mirrors)."""
        with open(ann, newline="") as f:
            rows = list(csv.DictReader(f))
        classes = sorted({r["label"] for r in rows})
        cls_idx = {c: i for i, c in enumerate(classes)}
        samples = []
        for r in rows:
            stem = (
                f"{r['youtube_id']}_{int(r['time_start']):06d}"
                f"_{int(r['time_end']):06d}"
            )
            for d in (os.path.join(self.root, r["label"]), self.root):
                hit = next(
                    (
                        os.path.join(d, f"{stem}.{ext}")
                        for ext in extensions
                        if os.path.exists(os.path.join(d, f"{stem}.{ext}"))
                    ),
                    None,
                )
                if hit:
                    samples.append((hit, cls_idx[r["label"]]))
                    break
        return classes, samples

    @property
    def labels(self) -> List[int]:
        if self.randomize:
            return [ci for _, ci in self.samples]
        return [self.samples[si][1] for si, _ in self._clips]

    def __len__(self) -> int:
        return len(self.samples) if self.randomize else len(self._clips)

    def _locate(self, idx: int) -> Tuple[str, int, int, int]:
        """(path, start, stride, label) for dataset index `idx`."""
        if self.randomize:
            path, label = self.samples[idx]
            total, fps = self._meta[idx]
            stride = self._stride(fps)
            span = self.frames_per_clip * stride
            start = int(self.rng.integers(0, max(total - span, 0) + 1))
        else:
            si, start = self._clips[idx]
            path, label = self.samples[si]
            stride = self._stride(self._meta[si][1])
        return path, start, stride, label

    def __getitem__(self, idx: int) -> np.ndarray:
        path, start, stride, _ = self._locate(idx)
        video = _read_clip(
            path, start, self.frames_per_clip, stride, self.padding, self.rng
        )
        if self.output_format == "cthw":
            video = np.transpose(video, (3, 0, 1, 2))
        return self.transform(video)

    def get_with_label(self, idx: int) -> Tuple[np.ndarray, int]:
        return self[idx], self._locate(idx)[3]
