"""Evaluation metrics and harnesses (twin of `open_genie_tpu.eval`).

Video-reconstruction metrics (PSNR, SSIM) and LFQ codebook health (usage,
perplexity) on channels-last `(B, T, H, W, C)` tensors; action
controllability of a Genie rollout; and harnesses that score a tokenizer,
a dynamics model or a Genie over a data loader. A loader is any iterable of
numpy arrays or tensors (dicts of them for token batches); each batch
moves to the model's device. Codebook counts are pooled over the whole set.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Dict, Iterable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from open_genie_tpu_torch.models.dynamics import gumbel_noise


def psnr(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB, one value per leading-axis item
    (the MSE reduces over every other axis)."""
    pred, target = pred.float(), target.float()
    mse = ((pred - target) ** 2).mean(dim=tuple(range(1, pred.dim())))
    return 10.0 * torch.log10(max_val ** 2 / mse.clamp_min(1e-10))


def _gaussian_kernel(size: int, sigma: float) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _ssim_blur(x: torch.Tensor, size: int, sigma: float) -> torch.Tensor:
    """Separable Gaussian filter over H and W of `(N, H, W, C)`, VALID: two
    grouped (depthwise) convolutions."""
    c = x.shape[-1]
    k = torch.from_numpy(_gaussian_kernel(size, sigma)).to(x.device, x.dtype)
    y = x.permute(0, 3, 1, 2)
    y = F.conv2d(y, k.view(1, 1, size, 1).expand(c, 1, size, 1), groups=c)
    y = F.conv2d(y, k.view(1, 1, 1, size).expand(c, 1, 1, size), groups=c)
    return y.permute(0, 2, 3, 1)


def ssim(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0, window: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Structural similarity (Wang et al. 2004), one value per item: video
    `(B, T, H, W, C)` frame by frame, averaged over T, or images `(B, H, W,
    C)`. A Gaussian window of `window` (clamped to the image) and the
    standard C1/C2 stabilizers; channels averaged."""
    pred, target = pred.float(), target.float()
    batch = pred.shape[0]
    if pred.dim() == 5:
        pred = pred.reshape(-1, *pred.shape[2:])
        target = target.reshape(-1, *target.shape[2:])
    window = min(window, pred.shape[1], pred.shape[2])
    c1, c2 = (0.01 * max_val) ** 2, (0.03 * max_val) ** 2
    mu_p, mu_t = _ssim_blur(pred, window, sigma), _ssim_blur(target, window, sigma)
    mu_pp, mu_tt, mu_pt = mu_p * mu_p, mu_t * mu_t, mu_p * mu_t
    var_p = _ssim_blur(pred * pred, window, sigma) - mu_pp
    var_t = _ssim_blur(target * target, window, sigma) - mu_tt
    cov = _ssim_blur(pred * target, window, sigma) - mu_pt
    score = ((2 * mu_pt + c1) * (2 * cov + c2)) / ((mu_pp + mu_tt + c1) * (var_p + var_t + c2))
    return score.mean(dim=(1, 2, 3)).reshape(batch, -1).mean(dim=1)


def _counts(idxs: torch.Tensor, vocab: int) -> torch.Tensor:
    """Occurrences of each id in `[0, vocab)` (ids outside are dropped)."""
    flat = idxs.reshape(-1).long()
    flat = flat[(flat >= 0) & (flat < vocab)]
    return torch.bincount(flat, minlength=vocab)


def codebook_stats(idxs: torch.Tensor, vocab: int) -> Dict[str, torch.Tensor]:
    """Codebook health of a batch of token ids: `usage` (the share of the
    vocabulary hit at least once), `perplexity` (`exp` of the empirical
    entropy; `vocab` when uniform) and `entropy_bits`."""
    counts = _counts(idxs, vocab)
    p = counts / counts.sum().clamp_min(1)
    logp = torch.where(p > 0, torch.log(p.clamp_min(1e-30)), 0.0)
    entropy = -(p * logp).sum()
    return {"usage": (counts > 0).float().mean(), "perplexity": torch.exp(entropy),
            "entropy_bits": entropy / np.log(2.0)}


def _pooled_entropy(counts: np.ndarray) -> float:
    p = counts / max(counts.sum(), 1)
    nz = p[p > 0]
    return float(-(nz * np.log(nz)).sum())


@contextmanager
def _eval_mode(model: nn.Module):
    """`model` in eval mode (no dropout, no LFQ training loss) and without
    gradients inside; its mode restored after."""
    was = model.training
    model.eval()
    try:
        with torch.no_grad():
            yield
    finally:
        model.train(was)


def _to(x: Any, device) -> torch.Tensor:
    return torch.as_tensor(x).to(device)


def action_controllability(
    genie: nn.Module,
    prompt: torch.Tensor,
    num_frames: int = 8,
    steps_per_frame: int = 8,
    n_branches: int = 4,
    action_pool: Optional[Sequence[int]] = None,
    generator: Optional[torch.Generator] = None,
    action_seqs: Optional[Sequence[torch.Tensor]] = None,
    gumbels: Optional[Sequence[torch.Tensor]] = None,
) -> Dict[str, float]:
    """Do the actions steer the rollout? From one prompt, branch set A
    rolls out `n_branches` distinct action sequences under one shared
    sampling noise (any divergence is the actions'), branch set B the first
    sequence under `n_branches` distinct noises (the sampling floor). Reports
    each set's mean pairwise per-pixel L1 distance and their ratio.

    The action sequences `(B, num_frames + 1)` are `action_seqs`, or drawn
    from `generator`, uniformly over `action_pool` (the ids the latent
    action actually emits) or the whole action vocabulary. The noises are
    `gumbels`, one `(num_frames, steps_per_frame, B, H'*W', V)` tensor per
    branch, or drawn from `generator`; A shares the first.
    """
    if prompt.dim() == 4:
        prompt = prompt[:, None]
    dev = next(genie.parameters()).device
    prompt = prompt.to(dev)
    b = prompt.shape[0]
    act_vocab = genie.act_vocab
    if action_seqs is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or action_seqs and gumbels")
        pool = None if action_pool is None else torch.as_tensor(
            np.asarray(action_pool).reshape(-1), device=generator.device)
        high = act_vocab if pool is None else pool.numel()
        action_seqs = []
        for _ in range(n_branches):
            ids = torch.randint(0, high, (b, num_frames + 1), generator=generator,
                                device=generator.device)
            action_seqs.append(ids if pool is None else pool[ids])
    action_seqs = [_to(a, dev) for a in action_seqs]

    if gumbels is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or gumbels")
        h, w = genie.tokenize_prompt(prompt).shape[-2:]
        shape = (num_frames, steps_per_frame, b, h * w, genie.dynamics.head.out_features)

    def noise(i):
        if gumbels is not None:
            return _to(gumbels[i], dev)
        return gumbel_noise(shape, generator, device=generator.device).to(dev)

    def rollout(actions, g):
        return genie(prompt, actions, num_frames, steps_per_frame, gumbel=g).float().cpu()

    with _eval_mode(genie):
        shared = noise(0)
        pix_act = [rollout(a, shared) for a in action_seqs]
        pix_seed = [pix_act[0]] + [rollout(action_seqs[0], noise(i))
                                   for i in range(1, n_branches)]

    def pairwise_l1(branches):
        return float(np.mean([
            float((branches[i] - branches[j]).abs().mean())
            for i in range(len(branches)) for j in range(i + 1, len(branches))
        ]))

    act_div, seed_div = pairwise_l1(pix_act), pairwise_l1(pix_seed)
    return {
        "action_divergence": act_div,
        "seed_divergence": seed_div,
        "action_to_noise_ratio": act_div / max(seed_div, 1e-8),
        "controllability_frames": float(num_frames),
        "controllability_branches": float(n_branches),
        "controllability_pool": float(
            len(np.asarray(action_pool).reshape(-1)) if action_pool is not None else act_vocab),
    }


def evaluate_genie(
    genie: nn.Module,
    loader: Iterable,
    max_batches: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    masks: Optional[Sequence[torch.Tensor]] = None,
) -> Dict[str, float]:
    """Score a Genie over a loader of `(B, T, H, W, C)` videos: the joint
    objective's eval-mode terms averaged over batches (`loss`, `act_loss`,
    `dyn_loss`, `act_rec_loss`, `act_q_loss`, `dyn_masked_acc`,
    `dyn_masked_frac`), and the usage, perplexity and entropy of the action
    ids the latent action emits, pooled over the set. The dynamics' masks
    are `masks[i]` for batch i, or drawn from `generator`."""
    dev = next(genie.parameters()).device
    act_vocab = genie.act_vocab
    keep = ("act_loss", "dyn_loss", "act_rec_loss", "act_q_loss", "dyn_masked_acc",
            "dyn_masked_frac")
    sums: Dict[str, float] = {}
    counts = np.zeros(act_vocab, np.int64)
    n = 0
    with _eval_mode(genie):
        for i, batch in enumerate(loader):
            if max_batches is not None and i >= max_batches:
                break
            mask = None if masks is None else _to(masks[i], dev)
            loss, aux = genie.compute_loss(_to(batch, dev), mask=mask, generator=generator,
                                           return_act_idxs=True)
            counts += _counts(aux.pop("act_idxs"), act_vocab).cpu().numpy()
            for k, v in {"loss": loss, **{k: aux[k] for k in keep}}.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            n += 1
    if n == 0:
        raise ValueError("evaluate_genie: loader yielded no batches")
    entropy = _pooled_entropy(counts)
    stats = {
        "act_code_usage": float((counts > 0).mean()),
        "act_code_perplexity": float(np.exp(entropy)),
        "act_code_entropy_bits": entropy / float(np.log(2.0)),
    }
    return {k: v / n for k, v in sums.items()} | stats | {"num_batches": n}


def evaluate_dynamics(
    dynamics: nn.Module,
    loader: Iterable,
    max_batches: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    masks: Optional[Sequence[torch.Tensor]] = None,
) -> Dict[str, float]:
    """Score a dynamics model over `{"tokens": (B, T', H', W'), "actions":
    (B, T')}` batches: the eval-mode masked cross-entropy (`loss`),
    `masked_acc` and `masked_frac`, averaged over batches. The masks are
    `masks[i]` for batch i, or drawn from `generator`."""
    dev = next(dynamics.parameters()).device
    sums: Dict[str, float] = {}
    n = 0
    with _eval_mode(dynamics):
        for i, batch in enumerate(loader):
            if max_batches is not None and i >= max_batches:
                break
            mask = None if masks is None else _to(masks[i], dev)
            loss, aux = dynamics.compute_loss(_to(batch["tokens"], dev),
                                              _to(batch["actions"], dev),
                                              mask=mask, generator=generator)
            for k, v in {"loss": loss, **aux}.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            n += 1
    if n == 0:
        raise ValueError("evaluate_dynamics: loader yielded no batches")
    return {k: v / n for k, v in sums.items()} | {"num_batches": n}


def evaluate_tokenizer(
    tokenizer: nn.Module,
    loader: Iterable,
    max_batches: Optional[int] = None,
) -> Dict[str, float]:
    """Score a VideoTokenizer over a loader of `(B, T, H, W, C)` videos in
    [0, 1]: tokenize -> decode, the reconstruction clipped to [0, 1]; PSNR,
    SSIM and the reconstruction MSE averaged over batches; and the code
    statistics pooled over the whole set (usage, distinct codes, the share
    of the sampling ceiling `min(tokens, vocab)` reached, perplexity,
    entropy, and the per-bit `factorized_*` entropy and perplexity, which
    the token count does not cap)."""
    dev = next(tokenizer.parameters()).device
    d = tokenizer.d_codebook
    vocab = 2 ** d
    shifts = torch.arange(d, device=dev)
    sums: Dict[str, float] = {}
    counts = np.zeros(vocab, np.int64)
    bit_ones = np.zeros(d, np.int64)
    n_tokens = n = 0
    with _eval_mode(tokenizer):
        for i, batch in enumerate(loader):
            if max_batches is not None and i >= max_batches:
                break
            video = _to(batch, dev).float()
            _, idxs = tokenizer.tokenize(video)
            rec = tokenizer.decode_tokens(idxs).float().clamp(0.0, 1.0)
            out = {"psnr": psnr(rec, video).mean(), "ssim": ssim(rec, video).mean(),
                   "rec_mse": ((rec - video) ** 2).mean()}
            for k, v in out.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            flat = idxs.reshape(-1).long()
            counts += _counts(flat, vocab).cpu().numpy()
            bit_ones += ((flat[:, None] >> shifts) & 1).sum(0).cpu().numpy()
            n_tokens += flat.numel()
            n += 1
    if n == 0:
        raise ValueError("evaluate_tokenizer: loader yielded no batches")
    entropy = _pooled_entropy(counts)
    pb = bit_ones / max(n_tokens, 1)
    bit_h = -(
        np.where(pb > 0, pb * np.log2(np.maximum(pb, 1e-30)), 0.0)
        + np.where(pb < 1, (1 - pb) * np.log2(np.maximum(1 - pb, 1e-30)), 0.0)
    )
    stats = {
        "usage": float((counts > 0).mean()),
        "distinct_codes": float((counts > 0).sum()),
        "usage_of_sampled_ceiling": float((counts > 0).sum() / max(min(n_tokens, vocab), 1)),
        "perplexity": float(np.exp(entropy)),
        "entropy_bits": entropy / float(np.log(2.0)),
        "factorized_entropy_bits": float(bit_h.sum()),
        "factorized_perplexity": float(2.0 ** bit_h.sum()),
        "num_tokens": float(n_tokens),
    }
    return {k: v / n for k, v in sums.items()} | stats | {"num_batches": n}
