"""The port's mesh, batch placement and tensor-parallel rules
(`open_genie_tpu_torch/parallel/mesh.py`) against the JAX package's
(`tests/test_parallel.py`'s cases on the virtual 8-device CPU platform),
and the collectives of one process.

`param_shardings` is held to JAX's specs on the compact Genie's and the
compact tokenizer's bridged parameter trees (shapes traced, not compiled):
each JAX spec, carried into torch's layout, is the port's axis for the
parameter the bridge maps it to; a fused self-attention `to_qkv` takes its
three projections' common spec.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from open_genie_tpu.parallel import mesh as jmesh  # noqa: E402
from open_genie_tpu.train import losses as jlosses  # noqa: E402
from open_genie_tpu_torch.bridge import state_dict_from_flax  # noqa: E402
from open_genie_tpu_torch.models.configs import (  # noqa: E402
    genie_compact_config,
    tokenizer_compact_train_config,
)
from open_genie_tpu_torch.parallel import collectives  # noqa: E402
from open_genie_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from open_genie_tpu_torch.train import losses as tlosses  # noqa: E402
from tools.parity_check import GENIE_CFG  # noqa: E402


def test_mesh_shapes():
    assert tmesh.make_mesh(world=8).shape == jmesh.make_mesh().shape == {"data": 8, "model": 1}
    assert tmesh.make_mesh(n_data=4, n_model=2, world=8).shape == {"data": 4, "model": 2}
    one = tmesh.make_mesh()  # outside a run: one rank, no group
    assert (one.shape, one.rank, one.group, one.world) == ({"data": 1, "model": 1}, 0, None, 1)


def test_mesh_subset_and_oversubscribe():
    assert tmesh.make_mesh(n_data=3, n_model=2, world=8).shape == {"data": 3, "model": 2}
    with pytest.raises(AssertionError) as jerr:
        jmesh.make_mesh(n_data=5, n_model=2)
    with pytest.raises(ValueError) as err:
        tmesh.make_mesh(n_data=5, n_model=2, world=8)
    assert str(err.value) == str(jerr.value) == "mesh 5x2 needs 10 devices, have 8"


def test_batch_sharding_places_shards():
    """Rank i of 8 holds JAX's i-th addressable shard; the ranks' local
    batches, concatenated in rank order, are the global batch."""
    x = np.arange(16 * 4 * 4, dtype=np.float32).reshape(16, 4, 4)
    jx = jax.device_put(jnp.asarray(x), jmesh.batch_sharding(jmesh.make_mesh()))
    parts = []
    for rank in range(8):
        shard = tmesh.batch_sharding(tmesh.Mesh(8, 1, rank))
        local = tmesh.place_batch({"video": torch.from_numpy(x), "ids": [torch.arange(16)]}, shard)
        np.testing.assert_array_equal(local["video"].numpy(),
                                      np.asarray(jx.addressable_shards[rank].data))
        assert local["video"].shape == (2, 4, 4) and local["ids"][0].tolist() == [2 * rank,
                                                                                   2 * rank + 1]
        parts.append(local)
    whole = tmesh.global_batch(parts)
    assert torch.equal(whole["video"], torch.from_numpy(x))
    assert torch.equal(whole["ids"][0], torch.arange(16))
    assert tmesh.place_batch(torch.arange(4), tmesh.replicated(tmesh.Mesh(2, 1, 1))).tolist() == [
        0, 1, 2, 3]
    with pytest.raises(ValueError, match="does not divide over 8 ranks"):
        tmesh.place_batch(torch.zeros(12), tmesh.batch_sharding(tmesh.Mesh(8)))


def test_param_shardings_tp_rules():
    """`tests/test_parallel.py`'s tree in the port's names and layouts."""
    mesh = tmesh.make_mesh(n_data=4, n_model=2, world=8)
    params = {"attn.to_q.weight": torch.zeros(64, 32), "attn.to_out.weight": torch.zeros(32, 64),
              "other.weight": torch.zeros(32, 32)}
    assert tmesh.param_shardings(params, mesh) == {
        "attn.to_q.weight": 0, "attn.to_out.weight": 1, "other.weight": None}


def test_param_shardings_skips_indivisible():
    mesh = tmesh.make_mesh(n_data=4, n_model=2, world=8)
    assert tmesh.param_shardings({"to_q.weight": torch.zeros(63, 32)}, mesh) == {
        "to_q.weight": None}
    # a fused projection splits each of q, k, v: 3 x 21 rows do not divide by 2
    assert tmesh.param_shardings({"to_qkv.weight": torch.zeros(63, 8),
                                  "to_qkv.bias": torch.zeros(64)}, mesh) == {
        "to_qkv.weight": None, "to_qkv.bias": None}


def _torch_axis(jax_axis: int, ndim: int, name: str) -> int:
    """A flax leaf's axis in the torch weight the bridge makes of it."""
    if name == "kernel" and ndim == 2:
        return 1 - jax_axis  # (in, out) -> (out, in)
    if name == "kernel" and ndim == 5:
        return (2, 3, 4, 1, 0)[jax_axis]  # (kt, kh, kw, in, out) -> (out, in, kt, kh, kw)
    return jax_axis  # embeddings keep their layout


@pytest.mark.parametrize("kind", ["genie", "tokenizer"])
@pytest.mark.parametrize("n_model", [2, 3])
def test_param_shardings_match_jax_on_bridged_trees(kind, n_model):
    if kind == "genie":
        jm, tm = jlosses.GenieTrainModule(genie=GENIE_CFG), tlosses.GenieTrainModule(
            genie_compact_config())
        video, kw = jnp.zeros((1, 4, 32, 32, 3)), {"method": jlosses.GenieTrainModule.full_init}
    else:
        cfg = tokenizer_compact_train_config()
        jm, tm = jlosses.TokenizerTrainModule(**cfg), tlosses.TokenizerTrainModule(**cfg)
        video, kw = jnp.zeros((1, 4, 32, 32, 3)), {}
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda k: jm.init(k, video, k, **kw), key)["params"]
    jspecs = jmesh.param_shardings(shapes, jmesh.make_mesh(n_data=2, n_model=n_model))
    leaves, tree = jax.tree_util.tree_flatten_with_path(shapes)
    specs = jax.tree_util.tree_leaves(jspecs, is_leaf=lambda s: hasattr(s, "spec"))
    # Each flax leaf filled with its own number: where it lands in the port.
    probes = [np.full(leaf.shape, i, np.float64) for i, (_, leaf) in enumerate(leaves)]
    mapped, _ = state_dict_from_flax(jax.tree_util.tree_unflatten(tree, probes), tm)
    want = {}
    for name, t in mapped.items():
        axes = set()
        for i in np.unique(t.numpy()).astype(int):
            path, leaf = leaves[i]
            spec = tuple(specs[i].spec)
            axes.add(_torch_axis(spec.index("model"), leaf.ndim, path[-1].key)
                     if "model" in spec else None)
        assert len(axes) == 1, (name, axes)  # q, k and v of a fused projection agree
        want[name] = axes.pop()
    got = tmesh.param_shardings(tm, tmesh.make_mesh(n_data=1, n_model=n_model, world=n_model))
    assert got == want
    ruled = [name for name in got if any(re.search(rule[0], name) for rule in tmesh.TP_RULES)]
    split = [name for name in ruled if got[name] is not None]
    # 2 splits most of these trees' ruled weights, 3 divides fewer of them
    assert bool(split) if n_model == 2 else len(split) < len(ruled)


def test_collectives_without_a_group_are_the_local_ops():
    """With no group (one process) every helper is the plain op, bit for
    bit: the step on one rank is the step without a group."""
    x = torch.randn(5, 7, generator=torch.Generator().manual_seed(0))
    assert torch.equal(collectives.mean(x, None), x.mean())
    assert torch.equal(collectives.mean(x, None, dim=0), x.mean(0))
    assert torch.equal(collectives.global_mean(x.sum(0), 5, None), x.sum(0) / 5)
    assert collectives.global_sums([x, 3], None) == [x, 3]
    before = x.clone()
    collectives.all_reduce_tensors_([x], None)
    assert torch.equal(x, before)
    assert collectives.gather_objects("state", None) == ["state"]
    assert (collectives.world_size(None), collectives.rank(None)) == (1, 0)
    assert collectives.all_reduce_sum(x, None) is x
    w = x.clone().requires_grad_()
    collectives.backward((w * w).sum(), None)  # seeded with 1, as loss.backward()
    assert torch.equal(w.grad, 2 * x)


def test_init_distributed_reads_the_jax_variables(monkeypatch):
    for name in ("OGT_COORDINATOR", "OGT_NUM_PROCESSES", "OGT_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert tmesh.init_distributed() is False  # nothing configured: one process
    monkeypatch.setenv("OGT_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="OGT_COORDINATOR"):
        tmesh.init_distributed()
    assert tmesh.rank_seed(31415, tmesh.Mesh(1)) == 31415
