"""Video datasets (copy of `open_genie_tpu.data.video`): mp4 reader
(reference-compatible) + synthetic source.

Host-side equivalents of the reference's `genie/module/data.py:139-233`
(`Platformer2D`: a directory of mp4s at `root/env_name/split/`, fixed-length
frame slices, BGR->RGB, /255, short-video padding modes) and of `sample.py`
(dataset generation -- here a procedural moving-sprites generator that needs
no gym/procgen).

All outputs are channels-last `(T, H, W, C)` float32 in [0, 1]; the loader
stacks them to `(B, T, H, W, C)` batches. OpenCV decode is gated: when cv2
is unavailable the synthetic source still works (and is what the tests use,
removing the reference's machine-local-fixture dependency, SURVEY.md
section 4).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

try:
    import cv2

    HAS_CV2 = True
except ImportError:  # no OpenCV: the synthetic source still works
    cv2 = None
    HAS_CV2 = False


class VideoDataset:
    """Minimal map-style dataset protocol: `__len__` + `__getitem__`."""

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, idx: int) -> np.ndarray:
        raise NotImplementedError


class Platformer2D(VideoDataset):
    """Directory-of-mp4s dataset, reference-compatible.

    Layout `root/env_name/split/*.mp4`; `__getitem__` decodes a
    `num_frames` slice (random start when `randomize`), pads short videos
    per `padding` in {'none', 'repeat', 'zero', 'random'}.
    """

    def __init__(
        self,
        root: str,
        split: str = "train",
        env_name: str = "Coinrun",
        padding: str = "none",
        randomize: bool = False,
        transform=None,
        num_frames: int = 16,
        rng: Optional[np.random.Generator] = None,
    ) -> None:
        assert HAS_CV2, "OpenCV is required for mp4 datasets"
        self.root = os.path.join(root, env_name, split)
        self.padding = padding
        self.randomize = randomize
        self.num_frames = num_frames
        self.transform = transform or (lambda x: x)
        self.rng = rng or np.random.default_rng()
        self.file_names = sorted(
            os.path.join(self.root, f) for f in os.listdir(self.root)
        )

    def __len__(self) -> int:
        return len(self.file_names)

    def __getitem__(self, idx: int) -> np.ndarray:
        start = None if self.randomize else 0
        video = self.load_video_slice(
            self.file_names[idx], self.num_frames, start
        )
        return self.transform(video)

    def load_video_slice(
        self, video_path: str, num_frames: int, start_frame: Optional[int] = None
    ) -> np.ndarray:
        cap = cv2.VideoCapture(video_path)
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        num_frames = min(num_frames, total)
        if start_frame is None:
            start_frame = int(self.rng.integers(0, max(total - num_frames, 0) + 1))
        cap.set(cv2.CAP_PROP_POS_FRAMES, start_frame)

        frames = []
        for _ in range(num_frames):
            ret, frame = cap.read()
            if ret:
                frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            else:
                missing = num_frames - len(frames)
                if self.padding == "none":
                    pass
                elif self.padding == "repeat":
                    frames.extend([frames[-1]] * missing)
                elif self.padding == "zero":
                    frames.extend([np.zeros_like(frames[-1])] * missing)
                elif self.padding == "random":
                    frames.extend(
                        (self.rng.random(frames[-1].shape) * 255).astype(np.uint8)
                        for _ in range(missing)
                    )
                else:
                    raise ValueError(f"Invalid padding type: {self.padding}")
                break
        cap.release()
        video = np.stack(frames).astype(np.float32) / 255.0  # (T, H, W, C)
        return video


class SyntheticVideo(VideoDataset):
    """Procedural moving-sprites videos: bouncing colored rectangles on a
    scrolling background. Deterministic per index; no external deps.

    Serves as the fixture-free data source for tests/benchmarks (the
    reference's data tests silently require a developer-local `.local.yaml`,
    SURVEY.md section 4) and as a stand-in for `sample.py`'s procgen rollouts.
    """

    def __init__(
        self,
        num_videos: int = 64,
        num_frames: int = 16,
        height: int = 64,
        width: int = 64,
        num_sprites: int = 3,
        seed: int = 0,
        motion_scale: float = 1.0,
    ) -> None:
        self.num_videos = num_videos
        self.num_frames = num_frames
        self.h, self.w = height, width
        self.num_sprites = num_sprites
        self.seed = seed
        # Per-frame displacement multiplier. 1.0 keeps the historical
        # fixture statistics (sprites up to 4 px/frame at 64 px -- a 4x
        # fast-forward relative to real 15-30 fps platformer capture,
        # where the player moves ~1-2 px/frame at this resolution).
        # Time-compressing tokenizers are rate-limited by intra-group
        # motion: at 1.0 the r05 flagship (4x time, 144-bit latent per
        # 4-frame group) saturated 0.5 dB above the trivial
        # per-group-MEAN baseline (19.5 vs 19.0 dB PSNR) -- the corpus,
        # not the model, set the ceiling. ~0.4 matches real gameplay.
        self.motion_scale = float(motion_scale)

    def __len__(self) -> int:
        return self.num_videos

    def __getitem__(self, idx: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 100003 + idx)
        t, h, w = self.num_frames, self.h, self.w

        # Scrolling sinusoidal background. The RGB tint is drawn ONCE per
        # clip: a per-frame draw here strobes the global hue every frame,
        # which is temporally-irreducible noise no time-factored tokenizer
        # can represent (it capped flagship reconstruction at ~17 dB PSNR;
        # see PARITY.md round-4 notes and tools/r04_diagnose_decoder.py).
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        phase = rng.uniform(0, 2 * np.pi)
        speed = rng.uniform(0.5, 2.0) * self.motion_scale
        tint = rng.uniform(0.5, 1.0, size=3)
        video = np.zeros((t, h, w, 3), np.float32)
        for ft in range(t):
            bg = 0.25 + 0.15 * np.sin(
                2 * np.pi * (xx / w * 2 + ft * speed / t) + phase
            )
            video[ft] = bg[..., None] * tint

        # Bouncing sprites.
        for _ in range(self.num_sprites):
            sh, sw = rng.integers(h // 8, h // 3, 2)
            pos = rng.uniform(0, [h - sh, w - sw])
            vel = rng.uniform(-4, 4, 2) * self.motion_scale
            color = rng.uniform(0.4, 1.0, 3)
            for ft in range(t):
                y, x = int(pos[0]), int(pos[1])
                video[ft, y : y + sh, x : x + sw] = color
                pos = pos + vel
                for d, lim in ((0, h - sh), (1, w - sw)):
                    if pos[d] < 0 or pos[d] > lim:
                        vel[d] = -vel[d]
                        pos[d] = np.clip(pos[d], 0, lim)
        return np.clip(video, 0.0, 1.0)


def write_mp4(path: str, video: np.ndarray, fps: int = 30) -> None:
    """Save a `(T, H, W, C)` float [0,1] video as mp4 (needs cv2).

    Equivalent of the reference's `save_frames_to_video` (`sample.py:11-25`).
    """
    assert HAS_CV2, "OpenCV is required to write mp4"
    t, h, w, _ = video.shape
    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    out = cv2.VideoWriter(path, fourcc, fps, (w, h))
    for frame in (video * 255).astype(np.uint8):
        out.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    out.release()
