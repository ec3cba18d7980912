"""Training-objective modules (twin of `open_genie_tpu.train.losses`): the
tokenizer's full-loss objective (stage 1), the standalone latent-action
objective (stage 2), the dynamics-only objective over token batches
(stage 3) and the Genie joint objective.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from open_genie_tpu_torch.models.action import LatentAction
from open_genie_tpu_torch.models.dynamics import DynamicsModel
from open_genie_tpu_torch.models.genie import Genie
from open_genie_tpu_torch.models.tokenizer import VideoTokenizer
from open_genie_tpu_torch.modules.loss import GANLoss, PerceptualLoss
from open_genie_tpu_torch.utils import random_frame_idxs


class TokenizerTrainModule(nn.Module):
    """VideoTokenizer plus its training loss: reconstruction MSE, hinge GAN
    on picked frames (frame discriminator), VGG16 perceptual loss on picked
    frames, and the LFQ loss, every term weighted into the total.

    Freeze the VGG in the optimizer with `frozen_param_mask(module,
    ("perc_crit",))`. The GAN's generator and discriminator terms share one
    optimizer with exact gradient separation (`GANLoss.both`).
    """

    def __init__(
        self,
        tokenizer: Dict[str, Any],
        disc_kwargs: Optional[Dict[str, Any]] = None,
        perceptual_model: str = "vgg16",
        perc_feat_layers: Tuple[str, ...] = (
            "features.6", "features.13", "features.18", "features.25"),
        gan_discriminate: str = "frames",
        gan_frames_per_batch: int = 4,
        gan_loss_weight: float = 1.0,
        perc_loss_weight: float = 1.0,
        quant_loss_weight: float = 1.0,
    ):
        super().__init__()
        self.model = VideoTokenizer(**tokenizer)
        self.frames = gan_frames_per_batch
        self.weights = dict(gan=gan_loss_weight, perc=perc_loss_weight, quant=quant_loss_weight)
        self.perc_crit = self.gan_crit = None
        if perc_loss_weight > 0:
            self.perc_crit = PerceptualLoss(perceptual_model, tuple(perc_feat_layers),
                                            gan_frames_per_batch)
        if gan_loss_weight > 0:
            self.gan_crit = GANLoss(gan_discriminate, gan_frames_per_batch, disc_kwargs)

    def forward(
        self,
        video: torch.Tensor,
        beta: float = 100.0,
        train: bool = True,
        gan_branch: str = "both",
        entropy_scale=1.0,
        bit_balance_scale=1.0,
        perc_idxs: Optional[torch.Tensor] = None,
        gan_idxs: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Full training loss on `(B, T, H, W, C)` video in [0, 1]:
        `(loss, metrics)`. The frames the perceptual and GAN losses compare
        are `perc_idxs` / `gan_idxs` `(B, K)`, or drawn from `generator`.
        `gan_branch` in {'both', 'gen', 'dis'}."""
        b, t = video.shape[:2]
        k = min(self.frames, t)

        def idxs(given):
            if given is not None:
                return given
            if generator is None:
                raise ValueError("TokenizerTrainModule needs frame indices or a Generator")
            return random_frame_idxs(generator, b, t, k, video.device)

        perc_idxs, gan_idxs = idxs(perc_idxs), idxs(gan_idxs)
        rec, out = self.model(video, beta=beta, train=train, entropy_scale=entropy_scale,
                              bit_balance_scale=bit_balance_scale)
        rec_loss = ((rec.float() - video.float()) ** 2).mean()
        zero = torch.zeros((), device=video.device)
        gen_loss = dis_loss = perc_loss = zero
        if self.gan_crit is not None:
            if gan_branch == "both":
                gen_loss, dis_loss = self.gan_crit.both(rec, video, gan_idxs)
            elif gan_branch in ("gen", "dis"):
                loss = self.gan_crit(rec, video, gan_idxs, train_gen=gan_branch == "gen")
                gen_loss, dis_loss = (loss, zero) if gan_branch == "gen" else (zero, loss)
            else:
                raise ValueError(f"gan_branch {gan_branch!r} not in both, gen, dis")
        if self.perc_crit is not None:
            perc_loss = self.perc_crit(rec, video, perc_idxs)
        quant_loss = out["quant_loss"] if out["quant_loss"] is not None else zero
        w = self.weights
        loss = (rec_loss + gen_loss * w["gan"] + dis_loss * w["gan"] + perc_loss * w["perc"]
                + quant_loss.float() * w["quant"])
        metrics = {
            "loss": loss, "rec_loss": rec_loss, "gen_loss": gen_loss, "dis_loss": dis_loss,
            "perc_loss": perc_loss, "quant_loss": quant_loss,
            **{f"lfq_{k}": v for k, v in out["lfq_aux"].items()},
        }
        return loss, metrics


class GenieTrainModule(nn.Module):
    """Genie joint training objective; the tokenizer inside is frozen
    (freeze it in the optimizer with `frozen_param_mask(module,
    ("model/tokenizer",))`)."""

    def __init__(self, genie: Dict[str, Any]):
        super().__init__()
        self.model = Genie(**genie)

    def forward(
        self,
        video: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        return self.model.compute_loss(video, mask=mask, generator=generator)

    def full_init(self, video: torch.Tensor, mask: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """`Genie.init_full`: the joint loss plus 0 x the reconstruction."""
        return self.model.init_full(video, mask=mask, generator=generator)

    def generate(self, prompt: torch.Tensor, actions: torch.Tensor, num_frames: int = 16,
                 steps_per_frame: int = 25, temp: float = 1.0, top_k: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The rollout `Genie.forward` of the model being trained."""
        return self.model(prompt, actions, num_frames, steps_per_frame, temp, top_k,
                          generator, gumbel)


class ActionTrainModule(nn.Module):
    """Standalone latent-action VQ-VAE pre-training (stage 2): the pixel
    reconstruction MSE plus the weighted LFQ loss of `LatentAction`. The
    LFQ loss and dropout follow this module's training mode."""

    def __init__(self, latent_action: Dict[str, Any]):
        super().__init__()
        self.model = LatentAction(**latent_action)

    def forward(self, video: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """`(loss, metrics)` on `(B, T, H, W, C)` video: `loss` and the
        model's terms as `act_*`."""
        _, loss, aux = self.model(video, mask)
        return loss, {"loss": loss, **{f"act_{k}": v for k, v in aux.items()}}


class DynamicsTrainModule(nn.Module):
    """Dynamics-only training over pre-tokenized clips (stage 3): batches
    `{"tokens": (B, T', H', W'), "actions": (B, T')}`, the masked-token
    cross-entropy of `DynamicsModel.compute_loss`."""

    def __init__(self, dynamics: Dict[str, Any]):
        super().__init__()
        self.model = DynamicsModel(**dynamics)

    def forward(self, batch: Dict[str, torch.Tensor], mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """`(loss, metrics)`: `loss`, `dyn_loss` (the same value) and the
        model's terms as `dyn_*`. The Bernoulli mask is `mask` or drawn
        from `generator`."""
        loss, aux = self.model.compute_loss(batch["tokens"], batch["actions"], mask=mask,
                                            generator=generator)
        return loss, {"loss": loss, "dyn_loss": loss, **{f"dyn_{k}": v for k, v in aux.items()}}


def frozen_param_mask(module: nn.Module, frozen_prefixes: Sequence[str]) -> Dict[str, bool]:
    """`{parameter name: trainable}` for `module`'s parameters.

    `frozen_prefixes` are `/`-joined sequences of name segments, e.g.
    `("model/tokenizer",)` freezes the tokenizer inside Genie. A prefix
    matches where its segments appear consecutively and whole in a
    parameter's dotted name, so `head` does not freeze `action_head`.
    """
    wants = [tuple(seg for seg in p.split("/") if seg) for p in frozen_prefixes]
    mask = {}
    for name, _ in module.named_parameters():
        path = tuple(name.split("."))
        mask[name] = not any(
            want and any(path[i:i + len(want)] == want for i in range(len(path) - len(want) + 1))
            for want in wants
        )
    return mask
