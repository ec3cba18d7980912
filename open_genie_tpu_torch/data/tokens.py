"""Pre-tokenized clip shards (copy of `open_genie_tpu.data.tokens`): the
staged-training data path.

Genie-style systems train in stages (tokenizer -> latent actions ->
dynamics); once the first two are frozen, dynamics training only needs
`(token_grid, action_ids)` pairs. `cli.py tokenize-data` runs the frozen
models over a video dataset once and caches each clip as one `.npz`
shard; `TokenClipDataset` serves them back. Tokens are orders of
magnitude smaller than pixels (18 bits per 4x8x8 pixel block at the
MAGVIT2 compression), so the cached dataset both fits anywhere and
removes tokenizer forward passes from every dynamics epoch. The shards are
the same files the JAX package writes and reads.

Shard format (`write_token_shard`): `tokens (T', H', W') int32`,
`actions (T',) int32`.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


def write_token_shard(
    path: str, tokens: np.ndarray, actions: np.ndarray
) -> None:
    """Write one clip's `(T', H', W')` tokens + `(T',)` actions."""
    tokens = np.asarray(tokens)
    actions = np.asarray(actions)
    assert tokens.ndim == 3, f"tokens must be (T, H, W), got {tokens.shape}"
    assert actions.shape == tokens.shape[:1], (
        f"actions {actions.shape} must match token frames {tokens.shape[:1]}"
    )
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, tokens=tokens.astype(np.int32),
             actions=actions.astype(np.int32))


class TokenClipDataset:
    """Map-style dataset over a directory of token shards.

    `root/<split>/*.npz` when the split subdir exists, else `root/*.npz`
    (mirrors `Platformer2D`'s split layout). Items are
    `{"tokens": (T', H', W') int32, "actions": (T',) int32}` dicts --
    `BatchLoader` stacks dict fields into batched arrays.
    """

    def __init__(self, root: str, split: Optional[str] = "train") -> None:
        base = root
        if split and os.path.isdir(os.path.join(root, split)):
            base = os.path.join(root, split)
        elif split and split != "train":
            # A flat shard dir serves only 'train'; silently reusing it
            # for validation would validate on training data.
            raise FileNotFoundError(
                f"no '{split}' split under {root} (flat shard dirs serve "
                "only the train split)"
            )
        self.root = base
        self.files = sorted(
            os.path.join(base, f) for f in os.listdir(base)
            if f.endswith(".npz")
        )
        if not self.files:
            raise FileNotFoundError(f"no .npz token shards under {base}")
        # All shards must agree on shape (static shapes under jit); shapes
        # are checked per access against shard 0 so a stale mixed-config
        # shard fails with ITS filename, not as an np.stack error inside a
        # loader worker thread mid-epoch.
        self.item_shapes = {k: v.shape for k, v in self._load(0).items()}

    def __len__(self) -> int:
        return len(self.files)

    def _load(self, idx: int) -> Dict[str, np.ndarray]:
        with np.load(self.files[idx]) as z:
            return {"tokens": z["tokens"], "actions": z["actions"]}

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        item = self._load(idx)
        shapes = {k: v.shape for k, v in item.items()}
        if shapes != self.item_shapes:
            raise ValueError(
                f"token shard {self.files[idx]} has shapes {shapes}, but "
                f"this dataset's shards are {self.item_shapes} -- mixed "
                "tokenize-data outputs in one directory?"
            )
        return item
