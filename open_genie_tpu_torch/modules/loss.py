"""Perceptual and hinge GAN losses (twin of `open_genie_tpu.modules.loss`).

Both compare a per-video subset of frames, `idxs` `(B, K)` frame indices
shared by the reconstruction and the input (`utils.random_frame_idxs`
draws them; the parity tests feed the ones JAX drew). Losses are taken in
f32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from open_genie_tpu_torch.modules.discriminator import FrameDiscriminator
from open_genie_tpu_torch.modules.vgg import VGG16Features
from open_genie_tpu_torch.utils import pick_frames


class PerceptualLoss(nn.Module):
    """Frozen-VGG16 feature MSE, averaged over the taps, between the picked
    frames of the reconstruction and of the input. The input's features are
    taken without a graph."""

    def __init__(self, model_name: str = "vgg16", feat_layers: Tuple[str, ...] = (
            "features.6", "features.13", "features.18", "features.25"), num_frames: int = 4):
        super().__init__()
        if model_name != "vgg16":
            raise ValueError(f"Only vgg16 is provided ({model_name} requested)")
        self.num_frames = num_frames
        self.vgg = VGG16Features(feat_layers)

    def forward(self, rec_video: torch.Tensor, inp_video: torch.Tensor,
                idxs: torch.Tensor) -> torch.Tensor:
        fake_feat = self.vgg(pick_frames(rec_video, idxs))
        with torch.no_grad():
            real_feat = self.vgg(pick_frames(inp_video, idxs))
        losses = [((fake_feat[k].float() - real_feat[k].float()) ** 2).mean()
                  for k in self.vgg.feat_layers]
        return torch.stack(losses).mean()


class GANLoss(nn.Module):
    """Hinge GAN loss around a frame discriminator.

    generator: `-mean(D(fake))`, written `-mean(d_f - d_fs + sg(d_fs))` with
    `d_f = D(fake)`, `d_fs = D(sg(fake))`: the same value, the generator's
    gradient into `fake`, and exactly zero gradient into D's parameters
    (the two paths cancel when the two passes agree bit for bit).
    discriminator: `mean(relu(1 + D(sg(fake))) + relu(1 - D(real)))`.
    """

    def __init__(self, discriminate: str = "frames", num_frames: int = 4,
                 disc_kwargs: Optional[dict] = None):
        super().__init__()
        if discriminate != "frames":
            raise NotImplementedError(f"GANLoss discriminate={discriminate!r} is not ported yet")
        kwargs = {k: tuple(v) if isinstance(v, list) else v
                  for k, v in dict(disc_kwargs or {}).items()}
        kwargs.setdefault("inp_size", (64, 64))
        self.num_frames = num_frames
        self.disc = FrameDiscriminator(**kwargs)

    @staticmethod
    def examples(rec_video, inp_video, idxs):
        return pick_frames(rec_video, idxs), pick_frames(inp_video, idxs)

    def forward(self, rec_video: torch.Tensor, inp_video: torch.Tensor, idxs: torch.Tensor,
                train_gen: bool) -> torch.Tensor:
        """The generator loss (`train_gen`) or the discriminator loss."""
        fake, real = self.examples(rec_video, inp_video, idxs)
        d_fs = self.disc(fake.detach())
        if train_gen:
            return self._gen(self.disc(fake), d_fs)
        return self._dis(d_fs, self.disc(real))

    def both(self, rec_video: torch.Tensor, inp_video: torch.Tensor,
             idxs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """`(gen_loss, dis_loss)` with exact gradient separation under one
        optimizer; `d_fs` is shared, so this costs one extra D forward."""
        fake, real = self.examples(rec_video, inp_video, idxs)
        d_fs = self.disc(fake.detach())
        d_f = self.disc(fake)
        d_r = self.disc(real)
        return self._gen(d_f, d_fs), self._dis(d_fs, d_r)

    @staticmethod
    def _gen(d_f, d_fs):
        return -(d_f.float() - d_fs.float() + d_fs.float().detach()).mean()

    @staticmethod
    def _dis(d_fs, d_r):
        return (F.relu(1.0 + d_fs.float()) + F.relu(1.0 - d_r.float())).mean()
