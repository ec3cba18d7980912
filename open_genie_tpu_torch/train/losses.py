"""Training-objective modules (twin of `open_genie_tpu.train.losses`).

Only the Genie joint objective is ported; the tokenizer, latent-action and
dynamics-only objectives are still to come.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from open_genie_tpu_torch.models.genie import Genie


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
