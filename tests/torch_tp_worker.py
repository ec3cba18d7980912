"""One rank of `tests/test_torch_tensor_parallel.py` (imports no JAX).

Run once per rank, with the JAX package's variables (`OGT_COORDINATOR`,
`OGT_NUM_PROCESSES`, `OGT_PROCESS_ID`) naming the run, over gloo:

    python tests/torch_tp_worker.py cases <work dir>     # 4 ranks, mesh 2 x 2
    python tests/torch_tp_worker.py trainer <work dir>   # 2 ranks, mesh 1 x 2

`cases`: for each `case_<name>.pt` the test process wrote (a train
module's kind, config, weights, global batch and the noise JAX drew for
it), the rank builds the module whole, keeps its slices
(`shard_module`), takes its data shard's rows of the batch and of the
noise and runs `make_train_step(mesh=)`: the metrics, the gradients as
AdamW applies them (summed over the data group, clipped) and the
parameters after the step, each gathered into the one-process layout,
plus the replicated parameters as this rank holds them. Then
the two controls on the same step: `copy_to_model` with an identity
backward, and each rank's loss seeded with 1/world. Then
`vocab.pt`'s vocabulary-parallel log-softmax and argmax on the model
group, each rank on its block of the vocabulary.

`trainer`: `cli train genie` on `tp.yaml` (`trainer.n_model: 2`), and on
`resume.yaml` resumed from the one-process checkpoint the test process
put in its directory, recording the checkpoints each rank wrote and the
frames of each sample video it wrote (before the mp4 encode); then
`cli train tokenizer`, `action` and `dynamics` on `<stage>_2.yaml`.

Everything goes to `<mode>_rank<r>.pt`.
"""
import os
import sys

import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from tests.torch_dp_worker import _floats, _module  # noqa: E402


def _spied_step(module, spec, mesh):
    """One `make_train_step(mesh=)` step with the applied gradients
    recorded, gathered."""
    from open_genie_tpu_torch.parallel.mesh import batch_sharding, place_batch
    from open_genie_tpu_torch.parallel.tensor import gather_split, split_of
    from open_genie_tpu_torch.train.loop import make_optimizer, make_train_step
    from open_genie_tpu_torch.train.losses import frozen_param_mask

    shard = batch_sharding(mesh)
    batch, noise = place_batch(spec["batch"], shard), place_batch(spec["noise"], shard)
    trainable = frozen_param_mask(module, spec["frozen"])
    opt = make_optimizer(module, lr=spec["lr"], frozen_mask=trainable)
    applied, adamw_step = {}, opt.adamw.step

    def spy_step(*args, **kwargs):
        applied.update({n: p.grad.clone() for n, p in module.named_parameters() if trainable[n]})
        return adamw_step(*args, **kwargs)

    opt.adamw.step = spy_step
    metrics = make_train_step(module, opt, mesh=mesh)(batch, **noise)
    named = dict(module.named_parameters())

    def whole(tensors):
        return {n: gather_split(t, split_of(named[n]), mesh.model_group)
                for n, t in tensors.items()}

    return {"metrics": _floats(metrics), "grads": whole(applied),
            "params": whole({n: p.detach() for n, p in named.items()}),
            "replicated": {n: p.detach().clone() for n, p in named.items()
                           if split_of(p) is None},
            "split": sorted(n for n, p in named.items() if split_of(p) is not None)}


def run_case(spec, mesh):
    from open_genie_tpu_torch.parallel import collectives
    from open_genie_tpu_torch.parallel.tensor import shard_module

    out = {"tp": _spied_step(shard_module(_module(spec), mesh), spec, mesh)}
    copy_backward, backward = collectives._CopyToModel.backward, collectives.backward

    def identity(ctx, g):
        return g, None

    def seed_world(loss, group):
        (loss / dist.get_world_size()).backward()

    for name, undo in (("copy_identity", lambda: setattr(
            collectives._CopyToModel, "backward", copy_backward)),
                       ("seed_world", lambda: setattr(collectives, "backward", backward))):
        if name == "copy_identity":
            collectives._CopyToModel.backward = staticmethod(identity)
        else:
            collectives.backward = seed_world
        try:
            out[name] = _spied_step(shard_module(_module(spec), mesh), spec, mesh)
        finally:
            undo()
    return out


def run_vocab(spec, mesh):
    """The log-softmax at the targets and the argmax of this rank's block
    of `spec["logits"]`, and the gradient of the sum of the former."""
    from open_genie_tpu_torch.parallel.tensor import (
        slice_of,
        vocab_parallel_argmax,
        vocab_parallel_log_prob,
    )

    local = slice_of(spec["logits"], (1, 1), mesh.model_index, mesh.n_model)
    local = local.clone().requires_grad_()
    logp = vocab_parallel_log_prob(local, spec["target"], mesh.model_group)
    logp.sum().backward()
    return {"logp": logp.detach(), "argmax": vocab_parallel_argmax(local.detach(),
                                                                   mesh.model_group),
            "dlogits": local.grad}


def run_trainer(work, mesh):
    from open_genie_tpu_torch import cli
    from open_genie_tpu_torch.data import video
    from open_genie_tpu_torch.train.loop import CheckpointWriter

    written, save = [], CheckpointWriter.save
    videos, write_mp4 = [], video.write_mp4

    def spy_save(self, state, step=None, **kwargs):
        written.append((os.path.basename(self.dir), step))
        return save(self, state, step, **kwargs)

    def spy_write(path, frames, *args, **kwargs):
        videos.append((os.path.basename(os.path.dirname(path)), os.path.basename(path),
                       frames.copy()))
        return write_mp4(path, frames, *args, **kwargs)

    CheckpointWriter.save = spy_save
    video.write_mp4 = spy_write
    out = {}
    for name, extra in (("tp", []), ("resume", ["--resume"])):
        state = cli.main(["train", "genie", "--config", os.path.join(work, f"{name}.yaml"),
                          "--device", "cpu", *extra])
        out[name] = {"step": state.step, "split": sorted(
            n for n, p in state.module.named_parameters() if getattr(p, "tp_split", None))}
    out["written"], out["videos"] = written, videos
    for what in ("tokenizer", "action", "dynamics"):
        state = cli.main(["train", what, "--config", os.path.join(work, f"{what}_2.yaml"),
                          "--device", "cpu"])
        out[what] = {"step": state.step, "split": sum(
            1 for p in state.module.parameters() if getattr(p, "tp_split", None))}
    return out


def main(mode: str, work: str) -> None:
    from open_genie_tpu_torch.parallel.mesh import init_distributed, make_mesh

    torch.set_num_threads(1)
    assert init_distributed(device="cpu")
    rank = dist.get_rank()
    out = {}
    if mode == "cases":
        mesh = make_mesh(2, 2)
        for name in sorted(f[5:-3] for f in os.listdir(work) if f.startswith("case_")):
            out[name] = run_case(torch.load(os.path.join(work, f"case_{name}.pt")), mesh)
        out["vocab"] = run_vocab(torch.load(os.path.join(work, "vocab.pt")), mesh)
    else:
        out = run_trainer(work, make_mesh(1, 2))
    torch.save(out, os.path.join(work, f"{mode}_rank{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
