"""Interactive serving: a stateful action -> frame session over a Genie
(twin of `open_genie_tpu.serve`).

    sess = InteractiveSession(genie, max_frames=64)      # device="cuda"
    first = sess.reset(prompt_video, seed=0)             # prompt's pixels
    frame = sess.step(action_id)                         # (B, H, W, C)

* The dynamics KV caches are allocated for the session's horizon at reset
  and written in place, so a step's work does not grow with history.
* Sessions are unbounded: when the horizon fills, the session rebases onto
  its trailing `_keep` token frames (fresh caches, positions restarting at
  0, exact for RoPE attention) and keeps playing.
* Pixels: when the decoder streams (`VideoTokenizer.stream_decodable`), a
  step decodes only the new token frame against cached decoder state,
  exactly as the batch decode would. Otherwise it re-decodes a sliding
  window of `pixel_window` token frames (the stock MAGVIT2 decoder pools
  GroupNorm statistics over time, so it is not strictly causal).
* Noise: one `torch.Generator` on the session's device, seeded from `seed`
  at reset and re-seeded at each rebase, feeds every MaskGIT step, so a
  session replays `Genie.rollout_tokens` with a generator of the same seed
  token for token until its first rebase. `step(..., gumbel=)` takes the
  step's noise instead (the parity tests feed the JAX package's draws).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from open_genie_tpu_torch.models.genie import Genie
from open_genie_tpu_torch.utils.debug import span

# Re-seeding at a rebase: the n-th rebase of a session of seed s draws from
# a generator seeded s + n * _REBASE_SEED_STRIDE.
_REBASE_SEED_STRIDE = 0x9E3779B1


def _as_tensor(x, device, dtype=None) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    return x.to(device, dtype)


class InteractiveSession:
    """Stateful action -> frame loop over a Genie (in eval mode)."""

    def __init__(
        self,
        genie: Genie,
        max_frames: int = 64,
        steps_per_frame: int = 8,
        temp: float = 1.0,
        which: str = "linear",
        pixel_window: int = 4,
        top_k: Optional[int] = None,
        stream: Optional[bool] = None,
        device="cuda",
    ) -> None:
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "InteractiveSession: CUDA is not available; pass device='cpu' to run on the CPU"
            )
        self.genie = genie.to(self.device).eval()
        self.max_frames = max_frames
        self.steps_per_frame, self.temp, self.which, self.top_k = (
            steps_per_frame, temp, which, top_k)
        self.pixel_window = pixel_window
        if stream is None:
            stream = genie.tokenizer.stream_decodable()
        self.stream = bool(stream)
        self._buf = self._cache = self._dcache = self._gen = None
        self._t = self._t0 = self._keep = 0
        self._acts = []
        self._seed = 0
        self._rebases = 0

    # ---------------------------------------------------------------- #

    def _stream_prefill(self, buf: torch.Tensor, t0: int) -> torch.Tensor:
        """Fresh decoder states, prefilled over `buf[:, :t0]`; returns the
        pixels of those frames `(B, t0 * tf, H', W', C)`."""
        b, horizon, h, w = buf.shape
        self._dcache = self.genie.init_pixel_stream(b, h, w, horizon, device=self.device)
        pix = [self.genie.decode_stream_frame(buf[:, pos], self._dcache, pos)[0]
               for pos in range(t0)]
        return torch.cat(pix, dim=1)

    @torch.inference_mode()
    def reset(self, prompt, seed: int = 0, prompt_actions=None) -> torch.Tensor:
        """Start a session from an image `(B, H, W, C)` or video
        `(B, T, H, W, C)` prompt; returns the prompt's decoded pixels on the
        host. `prompt_actions` `(B, T0)` are the prompt frames' action ids
        (zeros by default)."""
        prompt = _as_tensor(prompt, self.device)
        if prompt.dim() == 4:
            prompt = prompt[:, None]
        if prompt_actions is None:
            prompt_actions = torch.zeros(prompt.shape[:2], dtype=torch.long)
        prompt_actions = _as_tensor(prompt_actions, self.device, torch.long)
        self._buf, self._cache, t0 = self.genie.session_prefill(
            prompt, self.max_frames, actions=prompt_actions
        )
        self._t0 = self._t = t0
        self._seed, self._rebases = seed, 0
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        # Every rebase keeps this many trailing frames, so buffer and cache
        # shapes change at most once.
        self._keep = max(1, (t0 + self.max_frames) // 2)
        self._acts = [prompt_actions[:, i] for i in range(t0)]
        if self.stream:
            pixels = self._stream_prefill(self._buf, t0)
        else:
            self._dcache = None
            pixels = self.genie.decode_window(self._buf[:, :t0])
        return pixels.cpu()

    def step(self, action, gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Advance one frame with `action` (an int or `(B,)` ids); returns
        the new frame's pixels `(B, H', W', C)` on the host."""
        with span("session.step"):
            pix = self._advance(action, gumbel)
            with span("session.to_host"):
                return pix.cpu()

    def step_nosync(self, action, gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`step` without the copy to the host: returns the frame on the
        session's device without waiting for it, so a caller may chain
        steps and sync once. `gumbel` `(steps, B, H'*W', V)` replaces the
        step's draws from the session's generator."""
        with span("session.step"):
            return self._advance(action, gumbel)

    @torch.inference_mode()
    def _advance(self, action, gumbel: Optional[torch.Tensor]) -> torch.Tensor:
        assert self._buf is not None, "call reset() first"
        if self._t - self._t0 >= self.max_frames:
            self._renew()
        b = self._buf.shape[0]
        act = _as_tensor(action, self.device, torch.long).expand(b)
        if gumbel is not None:
            gumbel = gumbel.to(self.device)
        t = self._t
        self._buf, self._cache = self.genie.session_step(
            self._buf, self._cache, t, act, steps_per_frame=self.steps_per_frame,
            temp=self.temp, which=self.which, top_k=self.top_k, generator=self._gen,
            gumbel=gumbel,
        )
        self._t += 1
        self._acts.append(act)
        if self.stream:
            pix, _ = self.genie.decode_stream_frame(self._buf[:, t], self._dcache, t)
            return pix[:, -1]  # the newest of the token frame's tf pixel frames
        return self._decode_last()

    def _decode_last(self) -> torch.Tensor:
        """The newest frame from a sliding-window decode. While `t < w` the
        window starts at 0 and runs past `t` into frames not generated yet,
        so the newest token frame sits at `min(t, w) - 1` in it; a
        time-expanding decoder gives `tf` pixel frames per token frame, and
        the display frame is that token frame's last."""
        t = self._t
        w = min(self.pixel_window, self._buf.shape[1])
        start = max(t - w, 0)
        pixels = self.genie.decode_window(self._buf[:, start: start + w])
        tf = pixels.shape[1] // w
        return pixels[:, min(t, w) * tf - 1]

    def _renew(self) -> None:
        """Rebase onto the trailing `_keep` token frames: fresh caches
        prefilled from them (the decoder stream too), positions restarting
        at 0, the action history trimmed with them, and the generator
        re-seeded."""
        keep = self._keep
        with span("session.rebase"):
            toks = self._buf[:, self._t - keep: self._t]
            acts = torch.stack(self._acts[-keep:], dim=1)
            self._buf, self._cache = self.genie.session_rebase(toks, acts, self.max_frames)
            if self.stream:
                self._stream_prefill(self._buf, keep)
        self._acts = self._acts[-keep:]
        self._t0 = self._t = keep
        self._rebases += 1
        self._gen = torch.Generator(device=self.device).manual_seed(
            self._seed + self._rebases * _REBASE_SEED_STRIDE
        )

    @property
    def tokens(self) -> torch.Tensor:
        """The live token buffer so far `(B, t, H', W')`, on the host."""
        return self._buf[:, : self._t].cpu()
