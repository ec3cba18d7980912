"""One rank of `tests/test_torch_distributed.py` (imports no JAX).

Run once per rank, with the JAX package's variables (`OGT_COORDINATOR`,
`OGT_NUM_PROCESSES`, `OGT_PROCESS_ID`) naming the run, over gloo:

    python tests/torch_dp_worker.py <work dir>

The test process has written into the work dir what the ranks run:
`case_<name>.pt` (a train module's kind, config, weights, global batch
and the noise JAX drew for it), `lfq.pt`, `rollout.pt`, the YAMLs of two
`cli train` runs and `genie.yaml`. For each case the rank takes its rows of the batch and of the
noise, runs the naive data-parallel step (local means, gradients averaged
over the ranks: the control) and then `make_train_step(mesh=)`, and
keeps the metrics, the gradients the optimizer applied and the
parameters; then the LFQ losses' value and input gradient on its rows
of `lfq.pt`'s features; then two micro-steps of gradient accumulation on the
dynamics case; then its rows of a rollout; then `cli train tokenizer` for 6
steps and, resumed at step 3 in another directory, to 6 again, recording
which dataset items it loaded and which checkpoints it wrote; then its
stride of `cli tokenize-data` on `genie.yaml` into `tokens/`. Everything
goes to `rank<r>.pt`.
"""
import os
import shutil
import sys

import torch
import torch.distributed as dist

RESUME_AT = 3
DYNAMICS_VOCAB = 64  # the test's dynamics case's tok_vocab


def _module(spec):
    from open_genie_tpu_torch.train.losses import (
        DynamicsTrainModule,
        GenieTrainModule,
        TokenizerTrainModule,
    )

    kind, cfg = spec["kind"], spec["config"]
    module = {"genie": lambda: GenieTrainModule(cfg),
              "tokenizer": lambda: TokenizerTrainModule(**cfg),
              "dynamics": lambda: DynamicsTrainModule(cfg)}[kind]()
    module.load_state_dict(spec["state_dict"])
    return module


def _floats(metrics):
    return {k: torch.as_tensor(v).detach().double() for k, v in metrics.items()}


def run_case(spec, group):
    """The naive control, then one data-parallel step, on this rank's rows."""
    from open_genie_tpu_torch.parallel.mesh import batch_sharding, make_mesh, place_batch
    from open_genie_tpu_torch.train.loop import make_optimizer, make_train_step
    from open_genie_tpu_torch.train.losses import frozen_param_mask

    world = dist.get_world_size(group)
    shard = batch_sharding(make_mesh())
    batch = place_batch(spec["batch"], shard)
    noise = place_batch(spec["noise"], shard)

    module = _module(spec)
    trainable = frozen_param_mask(module, spec["frozen"])
    loss, metrics = module(batch, **noise)
    loss.backward()
    naive = {"metrics": {}, "grads": {}}
    with torch.no_grad():
        for k, v in _floats({**metrics, "loss": loss}).items():
            dist.all_reduce(v, group=group)
            naive["metrics"][k] = v / world
        for n, p in module.named_parameters():
            if trainable[n]:
                g = p.grad.clone() if p.grad is not None else torch.zeros_like(p)
                dist.all_reduce(g, group=group)
                naive["grads"][n] = g / world

    module = _module(spec)
    opt = make_optimizer(module, lr=spec["lr"], frozen_mask=trainable)
    applied = {}
    adamw_step = opt.adamw.step

    def spy(*args, **kwargs):  # the gradients AdamW applies: reduced, clipped
        applied.update({n: p.grad.clone() for n, p in module.named_parameters() if trainable[n]})
        return adamw_step(*args, **kwargs)

    opt.adamw.step = spy
    metrics = make_train_step(module, opt, mesh=make_mesh())(batch, **noise)
    return {"naive": naive, "metrics": _floats(metrics), "grads": applied,
            "params": {n: p.detach().clone() for n, p in module.named_parameters()}}


def run_lfq(spec, group):
    """`lfq_bit_balance_loss` alone and the whole `lfq_loss` on this rank's
    rows of the features: `{name: (loss, input gradient)}`."""
    from open_genie_tpu_torch.ops.lfq import lfq_bit_balance_loss, lfq_loss
    from open_genie_tpu_torch.parallel import collectives
    from open_genie_tpu_torch.parallel.mesh import batch_sharding, make_mesh, place_batch

    x = place_batch(spec["x"], batch_sharding(make_mesh()))
    losses = {"bit_balance": lambda v: lfq_bit_balance_loss(v, group=group),
              "lfq_loss": lambda v: lfq_loss(v, torch.where(v > 0, 1.0, -1.0), group=group,
                                             **spec["lfq_kwargs"])[0]}
    out = {}
    for name, fn in losses.items():
        v = x.clone().requires_grad_()
        loss = fn(v)
        collectives.backward(loss, group)
        out[name] = (loss.detach(), v.grad)
    return out


def run_accumulation(spec, group):
    """Two micro-steps of `accum_steps=2` on this rank's rows of two
    global batches, and on rank 0 the same two on the global batches in
    one process (no group): the gradients each update applies, the
    gradient all-reduces of each micro-step and its metrics' names."""
    from open_genie_tpu_torch.parallel import collectives
    from open_genie_tpu_torch.parallel.mesh import Mesh, batch_sharding, make_mesh, place_batch
    from open_genie_tpu_torch.train.loop import make_optimizer, make_train_step

    second = {**spec["batch"], "tokens": (spec["batch"]["tokens"] + 1) % DYNAMICS_VOCAB}
    micro = [(spec["batch"], spec["noise"]), (second, spec["noise"])]
    reduce = collectives.all_reduce_tensors_
    out = {}
    for name, mesh in (("dp", make_mesh()), ("one", Mesh(1))):
        if name == "one" and dist.get_rank(group) != 0:
            break
        module = _module(spec)
        opt = make_optimizer(module, lr=spec["lr"], accum_steps=2)
        applied, calls = {}, []
        adamw_step = opt.adamw.step

        def spy(*args, **kwargs):
            applied.update({n: p.grad.clone() for n, p in module.named_parameters()})
            return adamw_step(*args, **kwargs)

        def counted(tensors, g, *args, **kwargs):
            calls[-1] += 1
            return reduce(tensors, g, *args, **kwargs)

        opt.adamw.step, collectives.all_reduce_tensors_ = spy, counted
        step = make_train_step(module, opt, mesh=mesh)
        keys = []
        for batch, noise in micro:
            calls.append(0)
            batch, noise = (place_batch(t, batch_sharding(mesh)) for t in (batch, noise))
            keys.append(sorted(step(batch, **noise)))
        collectives.all_reduce_tensors_ = reduce
        out[name] = {"grads": applied, "reduce_calls": calls, "metric_keys": keys}
    return out


def run_rollout(spec):
    """This rank's rows of a rollout, with its rows of the Gumbel noise."""
    from open_genie_tpu_torch.parallel.mesh import batch_sharding, make_mesh

    genie = _module(spec).model.eval()
    rows = batch_sharding(make_mesh()).rows(spec["tokens"].shape[0])
    return genie.rollout_tokens(spec["tokens"][rows], spec["actions"][rows],
                                num_frames=spec["num_frames"],
                                steps_per_frame=spec["steps_per_frame"],
                                gumbel=spec["gumbel"][:, :, rows])


def run_cli(work, group):
    """`cli train tokenizer` for STEPS steps, then resumed at RESUME_AT from
    a copy of that checkpoint, with the dataset items this rank loaded and
    the checkpoints it wrote."""
    from open_genie_tpu_torch import cli
    from open_genie_tpu_torch.data.loader import DatasetShard
    from open_genie_tpu_torch.train.loop import CheckpointWriter

    loaded, written = [], []
    get, save = DatasetShard.__getitem__, CheckpointWriter.save

    def spy_get(self, i):
        loaded.append((len(self.dataset), i * self.num_shards + self.shard))
        return get(self, i)

    def spy_save(self, state, step=None, **kwargs):
        written.append((os.path.basename(self.dir), step))
        return save(self, state, step, **kwargs)

    DatasetShard.__getitem__, CheckpointWriter.save = spy_get, spy_save
    cli.main(["train", "tokenizer", "--config", os.path.join(work, "cli_A.yaml"),
              "--device", "cpu"])
    dist.barrier(group)
    if dist.get_rank(group) == 0:
        for name in (str(RESUME_AT), "config.yaml"):
            src = os.path.join(work, "A_ckpt", name)
            (shutil.copytree if os.path.isdir(src) else shutil.copy)(
                src, os.path.join(work, "B_ckpt", name))
    dist.barrier(group)
    cli.main(["train", "tokenizer", "--config", os.path.join(work, "cli_B.yaml"),
              "--device", "cpu", "--resume"])
    return {"loaded": loaded, "written": written}


def main(work: str) -> None:
    from open_genie_tpu_torch.parallel.mesh import init_distributed

    torch.set_num_threads(1)
    assert init_distributed(device="cpu")
    group = dist.group.WORLD
    rank = dist.get_rank()
    out = {}
    for name in sorted(f[5:-3] for f in os.listdir(work) if f.startswith("case_")):
        out[name] = run_case(torch.load(os.path.join(work, f"case_{name}.pt")), group)
    out["lfq"] = run_lfq(torch.load(os.path.join(work, "lfq.pt")), group)
    out["accumulation"] = run_accumulation(
        torch.load(os.path.join(work, "case_dynamics.pt")), group)
    out["rollout"] = run_rollout(torch.load(os.path.join(work, "rollout.pt")))
    out["cli"] = run_cli(work, group)
    from open_genie_tpu_torch import cli

    cli.main(["tokenize-data", "--config", os.path.join(work, "genie.yaml"), "--device", "cpu",
              "--allow-random-params", "--out", os.path.join(work, "tokens"), "--limit", "5"])
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
