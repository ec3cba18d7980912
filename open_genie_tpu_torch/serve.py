"""Interactive serving: a stateful action -> frame session over a Genie
(twin of `open_genie_tpu.serve`), and `BlockSession`, block-diffusion
text generation over a token dynamics model (the port's own).

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

from open_genie_tpu_torch.models.dynamics import get_schedule
from open_genie_tpu_torch.models.genie import Genie
from open_genie_tpu_torch.modules.moe import SparseMoE
from open_genie_tpu_torch.utils.debug import count, span

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


class BlockSession:
    """Block-diffusion text generation over a token `DynamicsModel` (one
    with no actions, such as `models/configs.py::sdar_30b_a3b_config()`),
    every row in lockstep.

        sess = BlockSession(dynamics, max_blocks=64, block_length=4)   # device="cuda"
        sess.reset(prompt_ids, seed=0)       # (B, L) ids, L a multiple of block_length
        ids = sess.step()                    # (B, block_length) on the host

    * `reset` allocates the layers' caches for the prompt and `max_blocks`
      blocks (kept for the next reset of the same shape) and prefills the
      prompt in chunks of at least `prefill_chunk` tokens
      (`DynamicsModel.prefill`), inside a `session.prefill` span.
    * `step` generates the next block of every row: it starts fully masked
      (`mask_id`) and takes `steps_per_block` read-only refinements, each
      committing the most confident positions' Gumbel-argmax tokens (at
      `temp`, on the linear schedule), then a commit pass that writes the
      block to the caches (`DynamicsModel.refine_frame`); the ids come
      back to the host.
    * On the card each block position's pass is a CUDA graph, captured at
      the first reset of a cache shape (a pass is the same ops at every
      position but for where it reads and writes, and the same for a
      refinement and a commit, which both write the block's K/V), so a
      step launches 5 graphs and the sampler's few kernels, traced or not
      (the layers' spans open only in eager passes: the prefill, and every
      pass off the card). After a replay the expert layers' `load`
      buffers, which the graph writes, are counted as `moe_expert_load`.
    * `watch`, if set, is called as `watch(ids, logits)` after every pass
      of `step`: the pass's `(B, 1, block_length)` input ids and its
      logits (valid until the next pass).
    * Noise: one `torch.Generator` on the session's device, seeded at
      reset, one float32 uniform draw a refinement.
    """

    def __init__(self, dynamics, max_blocks: int, block_length: int = 4,
                 steps_per_block: int = 4, temp: float = 1.0, prefill_chunk: int = 256,
                 device="cuda") -> None:
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "BlockSession: CUDA is not available; pass device='cpu' to run on the CPU")
        if dynamics.act_emb is not None:
            raise ValueError("BlockSession drives a model without actions")
        self.dynamics = dynamics.to(self.device).eval()
        self._loads = [m.load for m in self.dynamics.modules() if isinstance(m, SparseMoE)]
        self.max_blocks, self.block_length = max_blocks, block_length
        self.temp = temp
        self.schedule = get_schedule(steps_per_block, (1, block_length))
        self.prefill_frames = -(-prefill_chunk // block_length)
        self.watch = None
        self._cache = self._gen = None
        self._graphs, self._ids_in, self._logits = {}, None, None
        self._b = self._t = self._t_end = 0

    @torch.inference_mode()
    def reset(self, prompt_ids, seed: int = 0) -> None:
        """Start every row from its `(B, L)` prompt ids."""
        ids = _as_tensor(prompt_ids, self.device, torch.long)
        b, n = ids.shape
        if n % self.block_length or n == 0:
            raise ValueError(f"prompt of {n} tokens: not a positive multiple of the block "
                             f"length {self.block_length}")
        t0 = n // self.block_length
        frames = ids.view(b, t0, 1, self.block_length)
        with span("session.prefill"):
            if (b, t0) != (self._b, self._t_end - self.max_blocks):
                self._cache, self._graphs = None, {}  # the old go before the new are made
                self._cache = self.dynamics.init_cache(b, 1, self.block_length,
                                                       t0 + self.max_blocks, device=self.device)
            for p in range(0, t0, self.prefill_frames):
                self.dynamics.prefill(frames[:, p: p + self.prefill_frames], None, self._cache, p)
        self._b, self._t, self._t_end = b, t0, t0 + self.max_blocks
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        if self.device.type == "cuda" and not self._graphs:
            self._capture()

    def _capture(self) -> None:
        """A CUDA graph of the pass at every block position, sharing one
        memory pool, its input ids and its logits in fixed buffers. A first
        eager pass (on a side stream) builds what the kernels need; its
        K/V land in the first generated block's slots, which that block's
        own passes write again before they read them."""
        b, blk = self._b, self.block_length
        self._ids_in = torch.full((b, 1, blk), self.dynamics.mask_id, dtype=torch.long,
                                  device=self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            warm, _ = self.dynamics.decode_frame(self._ids_in, None, self._cache, self._t)
        torch.cuda.current_stream(self.device).wait_stream(side)
        self._logits = torch.empty_like(warm)
        del warm
        pool = torch.cuda.graph_pool_handle()
        for pos in range(self._t, self._t_end):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool):
                logits, _ = self.dynamics.decode_frame(self._ids_in, None, self._cache, pos)
                self._logits.copy_(logits)
            self._graphs[pos] = graph

    def _decode(self, ids, act_id, cache, pos, commit=True):
        """One pass at block position `pos` (`DynamicsModel.decode_frame`'s
        signature): its graph's replay, or the eager pass where there is no
        graph (off the card)."""
        graph = self._graphs.get(pos)
        if graph is None:
            logits, _ = self.dynamics.decode_frame(ids, act_id, cache, pos, commit)
        else:
            self._ids_in.copy_(ids)
            graph.replay()
            logits = self._logits
            if self._loads:
                count("moe_expert_load", self._loads)
        if self.watch is not None:
            self.watch(ids, logits)
        return logits, cache

    @torch.inference_mode()
    def step(self) -> torch.Tensor:
        """Generate the next block of every row: `(B, block_length)` ids on
        the host."""
        if self._cache is None or self._t >= self._t_end:
            raise RuntimeError("BlockSession: call reset() first, and again after max_blocks "
                               "steps")
        b = self._b
        with span("session.step"):
            frame, _ = self.dynamics.refine_frame(
                self._cache, self._t, None, self.schedule, self.temp, (b, 1, self.block_length),
                torch.long, self.device, generator=self._gen, decode=self._decode)
            self._t += 1
            with span("session.to_host"):
                return frame.view(b, self.block_length).cpu()
