"""Command-line entry points of the port (twin of `open_genie_tpu.cli`):
`train` and `tokenize-data`, with the JAX package's flags plus `--device`.

Usage:
  python -m open_genie_tpu_torch.cli train tokenizer --config configs/tokenize.yaml
  python -m open_genie_tpu_torch.cli train dynamics  --config configs/dynamics.yaml
  python -m open_genie_tpu_torch.cli tokenize-data --config configs/genie.yaml \
      --ckpt checkpoints/genie --out data/tokens

Each runs on the card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import os


def _train(args):
    from open_genie_tpu_torch.train.config import load_config
    from open_genie_tpu_torch.train.trainer import (
        train_action,
        train_dynamics,
        train_genie,
        train_tokenizer,
    )

    cfg = load_config(args.config, kind=args.what)
    if args.max_steps is not None:
        cfg.trainer.max_steps = args.max_steps
    fn = {"tokenizer": train_tokenizer, "genie": train_genie,
          "dynamics": train_dynamics, "action": train_action}[args.what]
    return fn(cfg, resume=args.resume, device=args.device)


def _tokenize_data(args):
    """Pre-tokenize a video dataset with a frozen genie checkpoint: each
    clip's token grid and latent-action ids, tokenized one clip at a time
    by `Genie.tokenize_with_actions` at the config's precision, become one
    npz shard (the staged-training input of `train dynamics`)."""
    import numpy as np
    import torch

    from open_genie_tpu_torch.data.tokens import write_token_shard
    from open_genie_tpu_torch.train.config import load_config
    from open_genie_tpu_torch.train.trainer import (
        _compute_dtype,
        build_dataset,
        load_genie_params,
        resolve_device,
    )

    if not args.ckpt and not args.allow_random_params:
        raise SystemExit(
            "tokenize-data: --ckpt is required (shards written from "
            "randomly initialized models are garbage dynamics training "
            "data); pass --allow-random-params to override for tests"
        )
    cfg = load_config(args.config, kind="genie")
    device = resolve_device(args.device, "tokenize-data")
    dtype = _compute_dtype(cfg.trainer.precision) or torch.float32
    _, module, step = load_genie_params(cfg, args.ckpt, device=device)
    if args.ckpt:
        print(f"# restored checkpoint step {step} from {args.ckpt}")
    genie = module.model.to(dtype).eval()
    written = {}
    for split in args.splits.split(","):
        try:
            dataset = build_dataset(cfg.data, split=split)
        except FileNotFoundError:
            print(f"# split {split!r}: no source data, skipped")
            continue
        n = len(dataset) if args.limit is None else min(args.limit, len(dataset))
        for i in range(n):
            video = torch.from_numpy(np.asarray(dataset[i]))[None].to(device, dtype)
            tokens, acts = genie.tokenize_with_actions(video)
            write_token_shard(
                os.path.join(args.out, split, f"{i:06d}.npz"),
                tokens[0].cpu().numpy(), acts[0].cpu().numpy(),
            )
        print(f"# split {split!r}: wrote {n} shards to {args.out}/{split}")
        written[split] = n
    return written


def main(argv=None):
    p = argparse.ArgumentParser(prog="open-genie-tpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device_flag(parser):
        parser.add_argument("--device", default="cuda",
                            help="torch device to run on (default cuda; cpu for a "
                            "machine without a card)")

    pt = sub.add_parser("train", help="train a model from a YAML config")
    pt.add_argument("what", choices=["tokenizer", "genie", "dynamics", "action"])
    pt.add_argument("--config", required=True)
    pt.add_argument("--resume", action="store_true")
    pt.add_argument("--max-steps", type=int, default=None)
    device_flag(pt)
    pt.set_defaults(fn=_train)

    pk = sub.add_parser(
        "tokenize-data",
        help="cache token/action shards from a frozen genie (staged training)",
    )
    pk.add_argument("--config", required=True)
    pk.add_argument("--ckpt", default=None)
    pk.add_argument(
        "--allow-random-params", action="store_true",
        help="permit writing shards WITHOUT --ckpt (randomly initialized "
        "tokenizer/action models -- garbage shards; tests/debug only)",
    )
    pk.add_argument("--out", required=True)
    pk.add_argument("--splits", default="train,val")
    pk.add_argument("--limit", type=int, default=None)
    device_flag(pk)
    pk.set_defaults(fn=_tokenize_data)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
