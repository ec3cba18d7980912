"""Command-line entry points of the port (twin of `open_genie_tpu.cli`):
`train`, `tokenize-data`, `generate`, `play`, `eval` and `make-data`, with
the JAX package's flags, defaults and printed lines, plus `--device` on
every command that runs a model.

Usage:
  python -m open_genie_tpu_torch.cli train tokenizer --config configs/tokenize.yaml
  python -m open_genie_tpu_torch.cli train dynamics  --config configs/dynamics.yaml
  python -m open_genie_tpu_torch.cli tokenize-data --config configs/genie.yaml \
      --ckpt checkpoints/genie --out data/tokens
  python -m open_genie_tpu_torch.cli generate --config configs/genie.yaml \
      --ckpt checkpoints/genie --frames 16 --out rollout.mp4
  python -m open_genie_tpu_torch.cli play --config configs/genie.yaml \
      --ckpt checkpoints/genie --actions 0,1,0,1
  python -m open_genie_tpu_torch.cli eval tokenizer --config configs/tokenize.yaml \
      --ckpt checkpoints/tokenizer --ema
  python -m open_genie_tpu_torch.cli make-data --root data --num-videos 64

A model runs on the card unless `--device cpu` is given; `make-data` runs
on the host. `train` and `tokenize-data` run on several devices when
launched once per rank with the JAX package's variables: `OGT_COORDINATOR`
(`host:port` of rank 0), `OGT_NUM_PROCESSES` and `OGT_PROCESS_ID`, over
NCCL on the card and gloo on the CPU; rank `r` takes
`cuda:{r % device_count}`. `train` is then data-parallel over the ranks
(only rank 0 prints the step lines and writes checkpoints), and
`tokenize-data` shards the clips over them. `generate`, `play` and `eval` compute in f32, as the JAX
package's do. Their random draws come from `torch.Generator`s seeded as
JAX seeds its keys (`--seed` for `generate` and `play`, `trainer.seed` for
`eval`), so they are not JAX's draws; at `--top-k 1` the sampled tokens do
not depend on the draws.
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
    npz shard (the staged-training input of `train dynamics`). On several
    ranks, rank `r` writes clips `r, r + world, ...`."""
    import numpy as np
    import torch

    from open_genie_tpu_torch.data.tokens import write_token_shard
    from open_genie_tpu_torch.parallel import collectives
    from open_genie_tpu_torch.train.config import load_config
    from open_genie_tpu_torch.train.trainer import (
        _compute_dtype,
        build_dataset,
        load_genie_params,
        resolve_device,
        setup_mesh,
    )

    if not args.ckpt and not args.allow_random_params:
        raise SystemExit(
            "tokenize-data: --ckpt is required (shards written from "
            "randomly initialized models are garbage dynamics training "
            "data); pass --allow-random-params to override for tests"
        )
    cfg = load_config(args.config, kind="genie")
    mesh, device = setup_mesh(cfg.trainer, resolve_device(args.device, "tokenize-data"))
    primary = mesh.rank == 0
    dtype = _compute_dtype(cfg.trainer.precision) or torch.float32
    _, module, step = load_genie_params(cfg, args.ckpt, device=device)
    if args.ckpt and primary:
        print(f"# restored checkpoint step {step} from {args.ckpt}")
    genie = module.model.to(dtype).eval()
    written = {}
    for split in args.splits.split(","):
        try:
            dataset = build_dataset(cfg.data, split=split)
        except FileNotFoundError:
            if primary:
                print(f"# split {split!r}: no source data, skipped")
            continue
        n = len(dataset) if args.limit is None else min(args.limit, len(dataset))
        for i in range(mesh.rank, n, mesh.world):
            video = torch.from_numpy(np.asarray(dataset[i]))[None].to(device, dtype)
            tokens, acts = genie.tokenize_with_actions(video)
            write_token_shard(
                os.path.join(args.out, split, f"{i:06d}.npz"),
                tokens[0].cpu().numpy(), acts[0].cpu().numpy(),
            )
        collectives.barrier(mesh.group)
        if primary:
            print(f"# split {split!r}: wrote {n} shards to {args.out}/{split}")
        written[split] = n
    return written


def _generate(args):
    from open_genie_tpu_torch.data.video import write_mp4

    video = generate_video(args)
    write_mp4(args.out, video)
    print(f"wrote {video.shape[0]} frames to {args.out}")
    return video


def generate_video(args):
    """The body of `generate`: the action-conditioned rollout from a
    synthetic prompt frame (or a validation clip with
    `--actions-from-data`), as `(T, H, W, C)` float32 in [0, 1]."""
    import numpy as np
    import torch

    from open_genie_tpu_torch.data.video import SyntheticVideo
    from open_genie_tpu_torch.models.genie import Genie
    from open_genie_tpu_torch.train.config import load_config
    from open_genie_tpu_torch.train.trainer import build_dataset, load_genie_params, resolve_device

    cfg = load_config(args.config, kind="genie")
    device = resolve_device(args.device, "generate")
    _, module, _ = load_genie_params(cfg, args.ckpt, device=device, use_ema=args.ema)
    module.eval()
    gen = torch.Generator(device).manual_seed(args.seed)
    prompt = torch.from_numpy(
        SyntheticVideo(num_frames=1, height=args.size, width=args.size)[0])[None].to(device)
    if args.actions:
        actions = torch.tensor([[int(a) for a in args.actions.split(",")]], device=device)
    elif args.actions_from_data:
        # Replay a real clip: prompt from its leading frames, actions from
        # the latent-action encoder's ids on it (the ids the dynamics
        # trained against; arbitrary ids index untrained embeddings).
        genie = module.model
        clip = torch.from_numpy(np.asarray(build_dataset(cfg.data, split="val")[0]))[None]
        clip = clip.to(device)
        t_down = genie.tokenizer.temporal_downsampling
        prompt = clip[:, :t_down]
        with torch.no_grad():
            emitted = genie.latent_action(clip)[0]
        t_tok = max(1, clip.shape[1] // t_down)
        aligned = Genie.align_actions(emitted, t_tok)[0].cpu().numpy()
        need = 1 + args.frames  # 1 prompt token frame + generated frames
        reps = int(np.ceil(need / max(len(aligned), 1)))
        actions = torch.from_numpy(np.tile(aligned, reps)[:need]).long()[None].to(device)
        print(f"# replaying {len(aligned)} emitted action ids "
              f"(pool {sorted(set(aligned.tolist()))})")
    else:
        actions = torch.randint(0, 2, (1, args.frames + 1), generator=gen, device=device)
    video = module.generate(prompt, actions, num_frames=args.frames,
                            steps_per_frame=args.steps_per_frame, top_k=args.top_k,
                            generator=gen)
    return video[0].clamp(0, 1).float().cpu().numpy()


def _play(args):
    from open_genie_tpu_torch.data.video import write_mp4

    video = play_video(args)
    write_mp4(args.out, video)
    print(f"wrote {video.shape[0]} frames to {args.out}")
    return video


def play_video(args):
    """The body of `play`, an interactive world-model session (action in,
    frame out): `--actions 0,1,0,2` scripts it; without it, actions are
    read from stdin one per line (blank = 0, 'q' quits). Returns the
    prompt's frames and every played frame, `(T, H, W, C)` in [0, 1]."""
    import numpy as np

    from open_genie_tpu_torch.data.video import SyntheticVideo
    from open_genie_tpu_torch.serve import InteractiveSession
    from open_genie_tpu_torch.train.config import load_config
    from open_genie_tpu_torch.train.trainer import load_genie_params, resolve_device

    cfg = load_config(args.config, kind="genie")
    device = resolve_device(args.device, "play")
    _, module, _ = load_genie_params(cfg, args.ckpt, device=device, use_ema=args.ema)
    sess = InteractiveSession(
        module.model,
        max_frames=args.max_frames,
        steps_per_frame=args.steps_per_frame,
        pixel_window=args.pixel_window,
        top_k=args.top_k,
        stream=(False if args.no_stream else None),
        device=device,
    )
    print(f"pixel decode: {'streaming (exact, O(1)/frame)' if sess.stream else f'sliding window ({args.pixel_window} frames)'}")
    prompt = SyntheticVideo(num_frames=1, height=args.size, width=args.size)[0][None]
    frames = list(sess.reset(prompt, seed=args.seed)[0].float().numpy())
    print(
        f"session ready (unbounded; {args.max_frames}-frame cache window); "
        "prompt decoded"
    )

    # Sessions are unbounded (the session rebases its cache window when
    # the horizon fills), so the scripted/interactive loops have no cap.
    if args.actions:
        script = [int(a) for a in args.actions.split(",")]
        for i, a in enumerate(script):
            frame = sess.step(a)
            frames.append(frame[0].float().numpy())
            print(f"[frame {i + 1}] action={a} -> {tuple(frame.shape[1:])}")
    else:  # pragma: no cover - interactive
        import itertools
        import sys

        print("enter action id per line (blank=0, q=quit):")
        for i in itertools.count():
            line = sys.stdin.readline()
            if not line or line.strip().lower() == "q":
                break
            a = int(line.strip() or 0)
            frame = sess.step(a)
            frames.append(frame[0].float().numpy())
            print(f"[frame {i + 1}] action={a}")
    return np.clip(np.stack(frames), 0, 1)


def _restore_train_module(module, args, what: str) -> None:
    """The checkpoint's parameters, or with `--ema` its EMA, into a train
    module, printing what was restored (`eval tokenizer` and `eval
    dynamics`)."""
    from open_genie_tpu_torch.train.loop import restore_params
    from open_genie_tpu_torch.train.trainer import restore_ema_params

    if args.ema and not args.ckpt:
        raise ValueError(f"eval {what}: --ema requires --ckpt (there is no EMA without a "
                         "checkpoint)")
    if args.ckpt and args.ema:
        ema, step = restore_ema_params(args.ckpt)
        module.load_state_dict(ema)
        print(f"# restored EMA params at step {step} from {args.ckpt}")
    elif args.ckpt:
        _, step = restore_params(args.ckpt, module)
        print(f"# restored checkpoint step {step} from {args.ckpt}")


def _print_report(report: dict) -> dict:
    import json

    print(json.dumps({k: round(float(v), 5) for k, v in report.items()}))
    return report


def _eval(args):
    """Score a checkpoint: tokenizer PSNR/SSIM/codebook health, genie
    validation metrics (joint loss, masked accuracy, action-code usage), or
    a dynamics model's masked CE on token shards. Prints one JSON line and
    returns its report."""
    if args.what == "genie":
        return _eval_genie(args)
    if args.what == "dynamics":
        return _eval_dynamics(args)

    from open_genie_tpu_torch.eval import evaluate_tokenizer
    from open_genie_tpu_torch.train.config import load_config
    from open_genie_tpu_torch.train.trainer import (
        build_dataset,
        build_loader,
        build_tokenizer_module,
        init_module,
        resolve_device,
    )

    cfg = load_config(args.config, kind="tokenizer")
    device = resolve_device(args.device, "eval tokenizer")
    # The TRAIN module, so that its parameters are a training checkpoint's;
    # the evaluation uses only its tokenizer (`model`).
    module = init_module(build_tokenizer_module(cfg.model), cfg.trainer.seed, device)
    dataset = build_dataset(cfg.data, split=args.split)
    loader = build_loader(cfg, dataset, device, split=args.split)
    _restore_train_module(module, args, "tokenizer")
    report = evaluate_tokenizer(module.model, loader, max_batches=args.max_batches)
    return _print_report(report)


def _eval_genie(args):
    import numpy as np
    import torch

    from open_genie_tpu_torch.eval import action_controllability, evaluate_genie
    from open_genie_tpu_torch.train.config import load_config
    from open_genie_tpu_torch.train.trainer import (
        build_dataset,
        build_loader,
        load_genie_params,
        resolve_device,
    )

    cfg = load_config(args.config, kind="genie")
    device = resolve_device(args.device, "eval genie")
    dataset = build_dataset(cfg.data, split=args.split)
    loader = build_loader(cfg, dataset, device, split=args.split)
    _, module, step = load_genie_params(cfg, args.ckpt, device=device, use_ema=args.ema)
    if args.ckpt:
        kind = "EMA params" if args.ema else "checkpoint"
        print(f"# restored {kind} step {step} from {args.ckpt}")
    genie = module.model.eval()
    seed = cfg.trainer.seed
    report = evaluate_genie(genie, loader, max_batches=args.max_batches,
                            generator=torch.Generator(device).manual_seed(seed))
    if args.controllability_frames:
        # Test actions from the ids the latent-action encoder actually emits
        # on real data: ids outside the trained set index embeddings the
        # dynamics never saw.
        batch = next(iter(loader)).to(device)
        with torch.no_grad():
            emitted = genie.latent_action(batch)[0]
        pool = np.unique(emitted.cpu().numpy())
        report.update(action_controllability(
            genie, batch[:1, :1], num_frames=args.controllability_frames, action_pool=pool,
            generator=torch.Generator(device).manual_seed(seed + 7)))
    return _print_report(report)


def _eval_dynamics(args):
    """Score a dynamics-only checkpoint on token shards (masked CE/acc)."""
    import torch

    from open_genie_tpu_torch.eval import evaluate_dynamics
    from open_genie_tpu_torch.train.config import load_config
    from open_genie_tpu_torch.train.losses import DynamicsTrainModule
    from open_genie_tpu_torch.train.trainer import (
        build_dataset,
        build_loader,
        init_module,
        resolve_device,
    )

    cfg = load_config(args.config, kind="dynamics")
    if cfg.data.source != "tokens":
        raise ValueError("eval dynamics consumes token shards; set data.source: tokens")
    device = resolve_device(args.device, "eval dynamics")
    module = init_module(DynamicsTrainModule(dynamics=cfg.model.dynamics_kwargs()),
                         cfg.trainer.seed, device)
    dataset = build_dataset(cfg.data, split=args.split)
    loader = build_loader(cfg, dataset, device, split=args.split)
    _restore_train_module(module, args, "dynamics")
    report = evaluate_dynamics(module.model, loader, max_batches=args.max_batches,
                               generator=torch.Generator(device).manual_seed(cfg.trainer.seed))
    return _print_report(report)


def _make_data(args):
    from open_genie_tpu_torch.data.video import SyntheticVideo, write_mp4

    if args.source == "gym":
        # The reference's `sample.py` path: gym envs under a random policy.
        # Gated: neither gym nor gymnasium is bundled in every environment.
        try:
            import gym  # noqa: F401
        except ImportError:
            try:
                import gymnasium  # noqa: F401
            except ImportError as e:
                raise SystemExit(
                    "--source gym requires the gym (or gymnasium) package "
                    f"(unavailable: {e}); use --source synthetic instead"
                )
        _make_data_gym(args)
        return

    for split, count in (("train", args.num_videos),
                         ("val", max(1, args.num_videos // 8))):
        out_dir = os.path.join(args.root, args.env_name, split)
        os.makedirs(out_dir, exist_ok=True)
        ds = SyntheticVideo(
            num_videos=count, num_frames=args.timeout,
            height=args.size, width=args.size,
            seed=0 if split == "train" else 1,
            motion_scale=args.motion_scale,
        )
        for i in range(count):
            write_mp4(os.path.join(out_dir, f"{i:04d}.mp4"), ds[i])
        print(f"wrote {count} videos to {out_dir}")


def _make_data_gym(args):
    """Gym-environment rollouts under a random policy -> mp4.

    Env resolution:
      * a bare name without a `-vN` suffix (`Coinrun`, ...) takes the
        reference `sample.py:27-53` procgen path: hard mode, one level per
        seed, the observation IS the frame;
      * a registered env id (`CartPole-v1`, ...) runs under gym OR
        gymnasium with `rgb_array` rendering.
    Both the legacy gym 4-tuple and the gymnasium 5-tuple step APIs are
    handled; frames are resized to `--size`.
    """
    try:
        import gym
    except ImportError:
        import gymnasium as gym
    import numpy as np

    from open_genie_tpu_torch.data.video import HAS_CV2, write_mp4

    is_procgen = "-v" not in args.env_name

    def _resize(frame):
        if frame.shape[0] == args.size and frame.shape[1] == args.size:
            return frame
        assert HAS_CV2, "resizing gym frames requires OpenCV"
        import cv2

        return cv2.resize(
            frame, (args.size, args.size), interpolation=cv2.INTER_AREA
        )

    for seed in range(args.num_videos):
        if is_procgen:
            env = gym.make(
                f"procgen:procgen-{args.env_name.lower()}-v0",
                distribution_mode="hard",
                render_mode="rgb_array",
                start_level=seed,
                num_levels=1,
                use_sequential_levels=True,
            )
            out = env.reset()
            frames = [out[0] if isinstance(out, tuple) else out]
            for _ in range(args.timeout - 1):
                frames.append(env.step(env.action_space.sample())[0])
        else:
            env = gym.make(args.env_name, render_mode="rgb_array")
            env.reset(seed=seed)
            frames = [env.render()]
            for _ in range(args.timeout - 1):
                step_out = env.step(env.action_space.sample())
                done = (
                    step_out[2]
                    if len(step_out) == 4
                    else bool(step_out[2]) or bool(step_out[3])
                )
                frames.append(env.render())
                if done:
                    env.reset(seed=seed * 100003 + len(frames))
        env.close()
        out_dir = os.path.join(args.root, args.env_name, "train")
        os.makedirs(out_dir, exist_ok=True)
        video = np.stack([_resize(np.asarray(f)) for f in frames])
        write_mp4(os.path.join(out_dir, f"{seed:04d}.mp4"),
                  video.astype(np.float32) / 255.0)
    print(f"wrote {args.num_videos} gym rollouts to {out_dir}")


def build_parser() -> argparse.ArgumentParser:
    """The CLI's argument parser; `parse_args` gives the namespace that the
    command bodies (`generate_video`, `play_video`, ...) take."""
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

    pg = sub.add_parser("generate", help="action-conditioned video rollout")
    pg.add_argument("--config", required=True)
    pg.add_argument("--ckpt", default=None)
    pg.add_argument("--frames", type=int, default=16)
    pg.add_argument("--steps-per-frame", type=int, default=25)
    pg.add_argument("--top-k", dest="top_k", type=int, default=None,
                    help="restrict sampling to the top-k logits (1 = greedy)")
    pg.add_argument("--ema", action="store_true",
                    help="use the checkpoint's EMA params")
    pg.add_argument("--size", type=int, default=64)
    pg.add_argument("--seed", type=int, default=0)
    pg.add_argument("--actions", default=None,
                    help="comma-separated action ids driving the rollout")
    pg.add_argument("--actions-from-data", action="store_true",
                    help="prompt with a real val clip and replay the "
                    "latent-action encoder's emitted ids (in-distribution "
                    "drive; random ids index untrained embeddings)")
    pg.add_argument("--out", default="rollout.mp4")
    device_flag(pg)
    pg.set_defaults(fn=_generate)

    pp = sub.add_parser(
        "play", help="interactive world-model session (action in, frame out)"
    )
    pp.add_argument("--config", required=True)
    pp.add_argument("--ckpt", default=None)
    pp.add_argument("--actions", default=None,
                    help="comma-separated action ids (else read from stdin)")
    pp.add_argument("--size", type=int, default=64)
    pp.add_argument("--max-frames", dest="max_frames", type=int, default=32)
    pp.add_argument("--steps-per-frame", dest="steps_per_frame", type=int, default=8)
    pp.add_argument("--pixel-window", dest="pixel_window", type=int, default=4)
    pp.add_argument(
        "--no-stream", dest="no_stream", action="store_true",
        help="force sliding-window pixel decode even for streamable decoders",
    )
    pp.add_argument("--top-k", dest="top_k", type=int, default=None,
                    help="restrict sampling to the top-k logits (1 = greedy)")
    pp.add_argument("--ema", action="store_true",
                    help="use the checkpoint's EMA params")
    pp.add_argument("--seed", type=int, default=0)
    pp.add_argument("--out", default="session.mp4")
    device_flag(pp)
    pp.set_defaults(fn=_play)

    pe = sub.add_parser(
        "eval", help="score a checkpoint (tokenizer PSNR/SSIM/codebook, "
        "genie val loss/accuracy)"
    )
    pe.add_argument("what", choices=["tokenizer", "genie", "dynamics"],
                    nargs="?", default="tokenizer")
    pe.add_argument("--config", required=True)
    pe.add_argument("--ckpt", default=None)
    pe.add_argument("--split", default="val")
    pe.add_argument("--max-batches", dest="max_batches", type=int, default=16)
    pe.add_argument("--ema", action="store_true",
                    help="score the EMA params (requires a checkpoint "
                    "trained with optimizer.ema_decay)")
    pe.add_argument("--controllability-frames", dest="controllability_frames",
                    type=int, default=0,
                    help="genie only: also measure action controllability "
                    "(rollout divergence across action branches vs the "
                    "sampling-noise floor) over this many frames (0 = off)")
    device_flag(pe)
    pe.set_defaults(fn=_eval)

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

    pd = sub.add_parser("make-data", help="generate an mp4 dataset")
    pd.add_argument("--root", required=True)
    pd.add_argument("--source", choices=["synthetic", "gym"], default="synthetic")
    pd.add_argument("--env-name", default="Coinrun")
    pd.add_argument("--num-videos", type=int, default=16)
    pd.add_argument("--timeout", type=int, default=100)
    pd.add_argument("--size", type=int, default=64)
    pd.add_argument("--motion-scale", type=float, default=1.0,
                    help="per-frame displacement multiplier for the "
                    "synthetic source (~0.4 matches real 15-30 fps "
                    "gameplay at 64 px; 1.0 = historical fixtures)")
    pd.set_defaults(fn=_make_data)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    try:
        main()
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
