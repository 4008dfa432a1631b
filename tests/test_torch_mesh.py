"""The port's mesh, sharding rules and sharded streams on the CPU.

- ``repro_torch.launch.mesh`` on four gloo ranks, spawned once
  (``spawn``, a ``FileStore`` in a temporary directory, a join timeout):
  a (2, 2) mesh's coordinates, its all-reduce over each tuple of axes, its
  all-gather in shard order (also over axes given out of mesh order), its
  ring exchange on a ring of two; the (4, 1) host mesh's ring of four and
  its counted bytes; ``make_production_mesh`` refusing a world of four;
  ``shard_fleet`` giving each rank its contiguous block and
  ``unshard_fleet`` the whole fleet back; each rank runs one thread and
  loads neither JAX nor the reference. ``spawn`` fails the call when a
  rank raises (with the rank's traceback) and when a rank outlives the
  timeout, and leaves no rank running.
- ``repro_torch.launch.sharding``'s rules against the reference's
  ``PartitionSpec``s entry by entry, on meshes of the production sizes
  (the rules read only the axis sizes).
- ``make_sharded_streams`` and ``batched`` equal to the reference's, bit
  for bit.
"""
import multiprocessing
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import make_dataset as ref_make_dataset
from repro.data.pipeline import batched as ref_batched
from repro.data.pipeline import make_sharded_streams as ref_make_sharded_streams
from repro.launch import sharding as ref_sharding
from repro.optim.optimizers import OptState as RefOptState
from repro_torch.data import batched, make_dataset, make_sharded_streams
from repro_torch.launch import sharding
from repro_torch.launch.mesh import spawn
from repro_torch.optim import OptState

import torch_mesh_ranks

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn(torch_mesh_ranks.mesh_checks, 4, tmp_path_factory.mktemp("rdv"),
                 device="cpu", timeout=120)


def test_mesh_coordinates_and_collectives(ranks):
    for rank, out in enumerate(ranks):
        data, model = divmod(rank, 2)
        assert out["grid_coords"] == {"data": data, "model": model}
        x = rank + 1
        np.testing.assert_array_equal(out["sum_data"], np.full(3, x + (x + 2 if data == 0 else x - 2)))
        np.testing.assert_array_equal(out["sum_model"], np.full(3, 3.0 if data == 0 else 7.0))
        np.testing.assert_array_equal(out["sum_both"], np.full(3, 10.0))
        # shards along "data" at this rank's "model" coordinate, in order
        np.testing.assert_array_equal(out["gather_data"][:, 0], [model + 1, model + 3])
        # ("model", "data"): shard = model·2 + data, ranks 0, 2, 1, 3
        np.testing.assert_array_equal(out["gather_both"][:, 0], [1, 3, 2, 4])
        assert out["index_md"] == model * 2 + data
        other = (rank + 2) % 4 + 1  # the ring of two: the same neighbour both ways
        np.testing.assert_array_equal(out["ring2"][0][0], np.full(3, 10.0 * other))
        np.testing.assert_array_equal(out["ring2"][1][0], np.full(3, 100.0 * other))


def test_host_mesh_ring_and_counts(ranks):
    for rank, out in enumerate(ranks):
        assert out["host_shape"] == {"data": 4, "model": 1}
        assert out["data_axes"] == ("data",)
        assert out["backend"] == "gloo"
        prev, nxt = (rank - 1) % 4 + 1, (rank + 1) % 4 + 1
        np.testing.assert_array_equal(out["ring4"][0][0], np.full(3, 10.0 * prev))
        np.testing.assert_array_equal(out["ring4"][1][0], np.full(3, 100.0 * nxt))
        assert out["stats"] == (1, 24, 0)  # two 12-byte payloads sent, nothing staged
        assert "256 ranks" in out["production"]
        assert out["threads"] == 1 and out["loaded"] == []  # a rank imports only the port


def test_shard_fleet_blocks(ranks):
    beta = np.arange(8 * 2 * 3, dtype=np.float32).reshape(8, 2, 3)
    for rank, out in enumerate(ranks):
        np.testing.assert_array_equal(out["block"]["beta"], beta[2 * rank : 2 * rank + 2])
        np.testing.assert_array_equal(out["unsharded"]["beta"], beta)
        assert "not divisible by 4 mesh shards" in out["indivisible"]


def test_spawn_fails_on_a_failing_rank_and_stops_the_rest(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        spawn(torch_mesh_ranks.failing_rank, 2, tmp_path, device="cpu", timeout=60)
    assert not multiprocessing.active_children()


def test_spawn_times_out_a_hanging_rank(tmp_path):
    with pytest.raises(TimeoutError, match=r"ranks \[(0, )?1\] of 2 still ran"):
        spawn(torch_mesh_ranks.hanging_rank, 2, tmp_path, device="cpu", args=(120.0,), timeout=8)
    assert not multiprocessing.active_children()


# ------------------------------------------------------------ the rules


def _meshes(shape):
    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    ref = types.SimpleNamespace(axis_names=names, devices=np.empty(shape))
    port = types.SimpleNamespace(shape=dict(zip(names, shape)), axis_names=names)
    return ref, port


def _leaf(*shape):
    """A leaf of the given shape and no data, as both packages' rules take it."""
    return jax.ShapeDtypeStruct(shape, jnp.float32)


def _same(got, want):
    assert tuple(got) == tuple(want), (got, want)


SHAPES = [(16,), (1600,), (1600, 1600), (32001, 1600), (1600, 32001), (32, 1600, 4800),
          (40, 1600, 512), (32, 40, 1600, 512), (64, 1600, 64), (4, 1600, 1600, 3)]


@pytest.mark.parametrize("mesh_shape", [(16, 16), (2, 16, 16), (4, 1)])
def test_spec_for_leaf_matches_reference(mesh_shape):
    ref_mesh, mesh = _meshes(mesh_shape)
    for name in [*sharding.RULES, "unknown"]:
        for shape in SHAPES:
            _same(sharding.spec_for_leaf(name, shape, mesh),
                  ref_sharding.spec_for_leaf(name, shape, ref_mesh))


def test_tree_specs_match_reference():
    ref_mesh, mesh = _meshes((16, 16))
    params = {"embed": _leaf(32001, 1600),
              "layers": {"wq": _leaf(32, 1600, 1600), "down": _leaf(32, 4800, 1600),
                         "w_gate": _leaf(32, 40, 1600, 512), "a_log": _leaf(32, 16)},
              "final": [_leaf(1600), {"up": _leaf(1600, 4800)}]}
    got, want = sharding.param_specs(params, mesh), ref_sharding.param_specs(params, ref_mesh)
    _same(got["embed"], want["embed"])
    for k in params["layers"]:
        _same(got["layers"][k], want["layers"][k])
    _same(got["final"][0], want["final"][0])
    _same(got["final"][1]["up"], want["final"][1]["up"])
    shard = sharding.param_shardings(params, mesh)["layers"]["wq"]
    assert shard.mesh is mesh and shard.spec == got["layers"]["wq"]

    opt = sharding.opt_state_specs(OptState(step=0, mu={"a": 1}, nu=None), got)
    ref_opt = ref_sharding.opt_state_specs(RefOptState(step=0, mu={"a": 1}, nu=None), want)
    _same(opt.step, ref_opt.step)
    assert opt.nu is None and ref_opt.nu is None and opt.mu is got

    for kind in ("train", "prefill"):
        for dp in (("data",), ("pod", "data")):
            a = sharding.batch_specs(kind, dp, mesh)
            b = ref_sharding.batch_specs(kind, dp, ref_mesh)
            assert a.keys() == b.keys()
            for k in a:
                _same(a[k], b[k])
    with pytest.raises(ValueError):
        sharding.batch_specs("decode", ("data",), mesh)

    caches = {"kv": _leaf(32, 16, 4096, 8, 64), "odd": _leaf(32, 3, 4096, 8, 64),
              "ssm": [_leaf(32, 16, 1600, 16), _leaf(32, 5, 7)], "pos": _leaf(4)}
    for shard_seq in (False, True):
        a = sharding.cache_specs_sharding(caches, mesh, ("data",), shard_seq=shard_seq)
        b = ref_sharding.cache_specs_sharding(caches, ref_mesh, ("data",), shard_seq=shard_seq)
        for k in ("kv", "odd", "pos"):
            _same(a[k], b[k])
        for x, y in zip(a["ssm"], b["ssm"]):
            _same(x, y)


def test_fleet_specs_match_reference():
    from repro_torch.convert import oselm_state_from_numpy

    for axes in (("data",), ("pod", "data")):
        _same(sharding.fleet_stack_spec(axes), ref_sharding.fleet_stack_spec(axes))
    _, mesh = _meshes((4, 1))
    fleet = oselm_state_from_numpy(np.ones((3, 2)), np.zeros(2), np.zeros((8, 2, 3)),
                                   np.zeros((8, 2, 2)), activation="identity", forget=1.0,
                                   device="cpu")
    sh = sharding.fleet_shardings(fleet, mesh)
    _same(sh.beta.spec, ref_sharding.fleet_stack_spec(("data",)))
    _same(sh.p.spec, ref_sharding.fleet_stack_spec(("data",)))
    _same(sh.params.alpha.spec, ())  # the port's one shared basis is replicated


# ------------------------------------------------------ sharded streams


@pytest.mark.parametrize("name,shards,steps,seed", [("har", 4, 40, 0), ("driving", 7, 33, 3)])
def test_sharded_streams_are_the_reference_bit_for_bit(name, shards, steps, seed):
    got = make_sharded_streams(make_dataset(name, seed=seed, samples_per_class=60), shards,
                               steps, seed=seed)
    want = ref_make_sharded_streams(ref_make_dataset(name, seed=seed, samples_per_class=60),
                                    shards, steps, seed=seed)
    assert got.xs.dtype == want.xs.dtype and np.array_equal(got.xs, want.xs)
    assert np.array_equal(got.pattern_of_shard, want.pattern_of_shard)
    a, b = list(batched(got.xs[0], 8)), list(ref_batched(want.xs[0], 8))
    assert len(a) == len(b) == steps // 8
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
