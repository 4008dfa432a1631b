"""The port's mesh federation across four gloo ranks on the CPU, one fleet
device a rank, as the reference's own script holds its mesh federation
(``tests/test_distribution.py``: a shared basis of 24 → 12, sigmoid, each
device booted on 32 samples of its own and trained on 32 more, ridge
1e-4); that script fails on this jax, so the port is held to the
reference's single-process ``cooperative_update``.

- ``mesh_cooperative_update`` (one all-reduce each of U and V, then the
  Cholesky solve): β within the reference's own 2e-2 of the reference's
  ``cooperative_update`` of the same trained devices (a ridge-free sum
  against the ridged mesh merge), and the same model on every rank, bit
  for bit.
- ``mesh_federated_train`` with ``merge_every`` (a merge after every
  chunk of 8 samples of the same 32) against the port's
  single-process chain of ``oselm_train_sequential`` and the same ridged
  merge, at twice the spread of that chain over the orders of its sum
  (every rotation of the devices and the reverse order), printed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cooperative_update as ref_cooperative_update
from repro.core import init_oselm as ref_init_oselm
from repro.core import init_slfn as ref_init_slfn
from repro.core import oselm_train_sequential as ref_oselm_train_sequential
from repro.core import to_uv as ref_to_uv
from repro_torch.core import UV, from_uv, oselm_train_sequential, to_uv
from repro_torch.launch.mesh import spawn

import torch_mesh_ranks

torch.set_num_threads(2)

SHARDS, N, NH, RIDGE, MERGE_EVERY, STEPS = 4, 24, 12, 1e-4, 8, 32


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    params = ref_init_slfn(jax.random.PRNGKey(0), N, NH)
    boots, trained, streams = [], [], []
    for s in range(SHARDS):
        x = jax.random.normal(jax.random.PRNGKey(s + 1), (32 + STEPS, N))
        st = ref_init_oselm(params, x[:32], x[:32], activation="sigmoid", ridge=RIDGE)
        boots.append(st)
        trained.append(ref_oselm_train_sequential(st, x[32:64], x[32:64]))
        streams.append(np.array(x[32:]))
    devices = [{"alpha": np.asarray(b.params.alpha), "bias": np.asarray(b.params.bias),
                "beta": np.asarray(b.beta), "p": np.asarray(b.p), "activation": b.activation,
                "forget": b.forget} for b in boots]
    streams = np.stack(streams)
    ranks = spawn(torch_mesh_ranks.federation_checks, SHARDS, tmp_path_factory.mktemp("rdv"),
                  device="cpu", timeout=120, args=(devices, streams, RIDGE, MERGE_EVERY))
    return {"devices": devices, "trained": trained, "streams": streams, "ranks": ranks}


def test_one_shot_update_matches_the_reference(case):
    ref = ref_cooperative_update(case["trained"][0],
                                 *[ref_to_uv(s) for s in case["trained"][1:]])
    first = case["ranks"][0]["one_shot"]
    for r in case["ranks"]:
        assert np.array_equal(r["one_shot"]["beta"], first["beta"])
        assert np.array_equal(r["one_shot"]["p"], first["p"])
    diff = float(jnp.max(jnp.abs(first["beta"][0] - ref.beta)))
    print(f"mesh_cooperative_update against the reference's cooperative_update: beta {diff:.3e}")
    assert diff < 2e-2


def _chain(devices, streams, order):
    """The single-process chain: every device trains a chunk, then all take
    the ridged merge of their (U, V), summed in ``order``."""
    states = [torch_mesh_ranks._state(d) for d in devices]
    xs = torch.from_numpy(streams)
    for c in range(xs.shape[1] // MERGE_EVERY):
        chunk = xs[:, c * MERGE_EVERY : (c + 1) * MERGE_EVERY].contiguous()
        states = [oselm_train_sequential(s, chunk[i], chunk[i]) for i, s in enumerate(states)]
        uvs = [to_uv(s, ridge=RIDGE) for s in states]
        u, v = uvs[order[0]].u, uvs[order[0]].v
        for i in order[1:]:
            u, v = u + uvs[i].u, v + uvs[i].v
        states = [from_uv(s, UV(u=u, v=v), ridge=RIDGE) for s in states]
    return states[0]


def test_federated_train_matches_the_single_process_chain(case):
    ranks = case["ranks"]
    for r in ranks:
        assert np.array_equal(r["chain"]["beta"], ranks[0]["chain"]["beta"])
    orders = [list(np.roll(np.arange(SHARDS), k)) for k in range(SHARDS)]
    orders.append(list(range(SHARDS))[::-1])
    chains = [_chain(case["devices"], case["streams"], o) for o in orders]
    spread = max(float((c.beta - chains[0].beta).abs().max()) for c in chains[1:])
    got = float(np.abs(ranks[0]["chain"]["beta"] - chains[0].beta.numpy()).max())
    print(f"mesh_federated_train against the single-process chain: beta {got:.3e}; the chain "
          f"over the orders of its sum {spread:.3e}")
    assert got <= 2 * spread
