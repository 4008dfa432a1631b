"""The port's unmasked merge and its synchronous train → merge rounds
against the reference on the CPU.

- ``fleet_merge_kernel`` (also exported as ``fleet_merge``), on the plain
  versions of its kernels, against the reference's XLA ``fleet_merge``
  (Cholesky solves) on every topology, with f32, f16 and int8 payloads,
  at D = 13. P is held at 1e-5; β at atol 5e-5, because Gauss-Jordan and
  Cholesky solves differ by up to 1.8e-5 on β at this conditioning. The
  reference's kernel path (``fleet_merge_kernel(interpret=True)``), whose
  Gauss-Jordan sweep updates the pivot row where the port leaves it out of
  its own step, is no oracle for the port's solve: its distance is
  printed. The lossy codecs take the reference's (U, V): across
  frameworks U = P⁻¹ differs in its last bits, and a value at a rounding
  boundary of the codec then moves by a whole step (f16 β up to 5.6e-4
  with each package's own payloads).
- ``fleet_train_rounds`` against the reference's ``fleet_train_rounds``
  (XLA ingest, Cholesky merges), with its tail-drop warning and its
  ``rounds`` check. The chain runs four rounds of ingest and merge on a
  fixture whose U is ill conditioned (uniform(0, 1) inputs, identity
  activation), so last-bit differences grow by κ(U) each round: the
  reference's own chain with its Gauss-Jordan kernel merges in place of
  its Cholesky merges strays up to 5.6e-4 (relative to max |β|) from its
  Cholesky chain. The port is held at twice that spread, measured on the
  same fixture in the same test and printed.
- ``device_state`` and ``fedavg_total_cost`` against the reference.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.fleet.fleet as port_fleet
from repro.fleet import (
    device_state as ref_device_state,
    fedavg_total_cost as ref_fedavg_total_cost,
    fleet_merge as ref_fleet_merge,
    fleet_merge_kernel as ref_fleet_merge_kernel,
    fleet_to_uv as ref_fleet_to_uv,
    fleet_train as ref_fleet_train,
    fleet_train_rounds as ref_fleet_train_rounds,
    init_fleet as ref_init_fleet,
    ring as ref_ring,
)
from repro.fleet.topology import Topology as RefTopology
from repro_torch.core import UV
from repro_torch.fleet import (
    Topology,
    device_state,
    fedavg_total_cost,
    fleet_merge,
    fleet_merge_kernel,
    fleet_train_rounds,
    model_nbytes,
    ring,
)

from test_torch_topology_merge import D_ODD, RIDGE, TOPOS, _custom_mask, _port, trained_fleet  # noqa: F401

torch.set_num_threads(2)

MERGE_TOPOS = dict(TOPOS)
MERGE_TOPOS["ring_closed"] = (lambda d: ring(d, 7), lambda d: ref_ring(d, 7))
MERGE_TOPOS["custom_dense"] = (
    lambda d: Topology(name="custom", n_devices=d, kind="dense", matrix=_custom_mask(d)),
    lambda d: RefTopology(name="custom", n_devices=d, kind="dense", matrix=_custom_mask(d)),
)


def _close(got, want):
    np.testing.assert_allclose(got.p.numpy(), np.asarray(want.p), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.beta.numpy(), np.asarray(want.beta), rtol=1e-5, atol=5e-5)


def _print_kernel_path(what, got, kernel_path):
    print(f"{what}: port against the reference's kernel path, P "
          f"{float(np.abs(got.p.numpy() - np.asarray(kernel_path.p)).max()):.3e}, beta "
          f"{float(np.abs(got.beta.numpy() - np.asarray(kernel_path.beta)).max()):.3e}")


@pytest.fixture
def reference_uv(trained_fleet, monkeypatch):  # noqa: F811
    """The port's merges take the reference's (U, V) of the fleet."""
    uv = jax.jit(lambda s: ref_fleet_to_uv(s, ridge=RIDGE))(trained_fleet)
    ref_uv = UV(u=torch.from_numpy(np.array(uv.u)), v=torch.from_numpy(np.array(uv.v)))
    monkeypatch.setattr(port_fleet, "fleet_to_uv", lambda states, ridge: ref_uv)


@pytest.mark.parametrize("topo_name", sorted(MERGE_TOPOS))
def test_fleet_merge_kernel_matches_reference(trained_fleet, topo_name):  # noqa: F811
    port_fn, ref_fn = MERGE_TOPOS[topo_name]
    got = fleet_merge_kernel(_port(trained_fleet), port_fn(D_ODD), ridge=RIDGE)
    _close(got, ref_fleet_merge(trained_fleet, ref_fn(D_ODD), ridge=RIDGE))
    _print_kernel_path(topo_name, got, ref_fleet_merge_kernel(trained_fleet, ref_fn(D_ODD),
                                                              ridge=RIDGE, interpret=True))
    assert got.p.is_contiguous() and got.beta.is_contiguous()
    assert fleet_merge is fleet_merge_kernel


@pytest.mark.parametrize("precision", ["f16", "int8"])
@pytest.mark.parametrize("topo_name", sorted(MERGE_TOPOS))
def test_one_shot_codec_fleet_merge_kernel_matches_reference(trained_fleet, reference_uv,  # noqa: F811
                                                             topo_name, precision):
    port_fn, ref_fn = MERGE_TOPOS[topo_name]
    got = fleet_merge_kernel(_port(trained_fleet), port_fn(D_ODD), ridge=RIDGE,
                             payload_precision=precision)
    _close(got, ref_fleet_merge(trained_fleet, ref_fn(D_ODD), ridge=RIDGE,
                                payload_precision=precision))
    _print_kernel_path(f"{topo_name} {precision}", got, ref_fleet_merge_kernel(
        trained_fleet, ref_fn(D_ODD), ridge=RIDGE, interpret=True, payload_precision=precision))


@pytest.mark.parametrize("topo_name", sorted(TOPOS))
def test_all_ones_mask_is_the_unmasked_merge_bit_for_bit(trained_fleet, topo_name):  # noqa: F811
    """w·1.0 = w, so the masked merge with every device in is the unmasked
    one to the bit."""
    port_fn, _ = TOPOS[topo_name]
    fleet, topo = _port(trained_fleet), port_fn(D_ODD)
    want = fleet_merge_kernel(fleet, topo, ridge=RIDGE)
    got = port_fleet.fleet_merge_masked_kernel(fleet, topo, torch.ones(D_ODD), ridge=RIDGE)
    assert torch.equal(got.p, want.p) and torch.equal(got.beta, want.beta)


STEPS = 18  # 4 rounds of 4 samples and a tail of 2


@pytest.fixture(scope="module")
def round_inputs():
    rng = np.random.default_rng(4)
    feat, hid = 24, 8
    x_init = rng.uniform(0, 1, (D_ODD, 2 * hid, feat)).astype(np.float32)
    fleet = ref_init_fleet(jax.random.PRNGKey(0), D_ODD, feat, hid, jnp.asarray(x_init),
                           activation="identity", ridge=RIDGE)
    streams = rng.uniform(0, 1, (D_ODD, STEPS, feat)).astype(np.float32)
    return fleet, streams


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def reference_gauss_jordan_rounds(fleet, streams, topo, rounds):
    """The reference's chain with its Gauss-Jordan kernel merges: the
    reference's own yardstick for a chain of Gauss-Jordan solves."""
    xs = jnp.asarray(streams)
    per = xs.shape[1] // rounds
    for r in range(rounds):
        fleet = ref_fleet_train(fleet, xs[:, r * per : (r + 1) * per])
        fleet = ref_fleet_merge_kernel(fleet, topo, ridge=RIDGE, interpret=True)
    return fleet


@pytest.mark.parametrize("topo_name", sorted(TOPOS))
def test_fleet_train_rounds_matches_reference(round_inputs, topo_name, caplog):
    port_fn, ref_fn = TOPOS[topo_name]
    fleet, streams = round_inputs
    want = ref_fleet_train_rounds(fleet, jnp.asarray(streams), ref_fn(D_ODD), rounds=4,
                                  ridge=RIDGE)
    twin = reference_gauss_jordan_rounds(fleet, streams, ref_fn(D_ODD), 4)
    with caplog.at_level(logging.WARNING, logger=port_fleet.__name__):
        got = fleet_train_rounds(_port(fleet), streams, port_fn(D_ODD), rounds=4, ridge=RIDGE)
    assert "dropping the tail 2 samples" in caplog.text
    spread = {k: _rel(getattr(twin, k), getattr(want, k)) for k in ("p", "beta")}
    dev = {k: _rel(getattr(got, k).numpy(), getattr(want, k)) for k in ("p", "beta")}
    print(f"{topo_name}: port vs reference {dev}; the reference's Gauss-Jordan chain vs its "
          f"Cholesky chain {spread}")
    for k in ("p", "beta"):
        assert dev[k] <= 2 * spread[k], (topo_name, k, dev, spread)
    # the tail is dropped: the same streams cut to 16 samples give the same
    # fleet to the bit
    cut = fleet_train_rounds(_port(fleet), streams[:, :16], port_fn(D_ODD), rounds=4,
                             ridge=RIDGE)
    assert torch.equal(cut.p, got.p) and torch.equal(cut.beta, got.beta)


def test_fleet_train_rounds_validation(round_inputs):
    fleet, streams = round_inputs
    for rounds in (0, STEPS + 1):
        with pytest.raises(ValueError, match="rounds"):
            ref_fleet_train_rounds(fleet, jnp.asarray(streams), TOPOS["star"][1](D_ODD),
                                   rounds=rounds)
        with pytest.raises(ValueError, match="rounds"):
            fleet_train_rounds(_port(fleet), streams, TOPOS["star"][0](D_ODD), rounds=rounds)


def test_one_round_is_train_then_merge(round_inputs):
    """rounds = steps // per with no tail: no warning, and one round is
    ``fleet_train`` of the whole stream and one ``fleet_merge_kernel``."""
    fleet, streams = round_inputs
    topo = TOPOS["ring2"][0](D_ODD)
    got = fleet_train_rounds(_port(fleet), torch.from_numpy(streams), topo, rounds=1,
                             ridge=RIDGE)
    want = port_fleet.fleet_train(_port(fleet), torch.from_numpy(streams))
    want = fleet_merge_kernel(want, topo, ridge=RIDGE)
    assert torch.equal(got.p, want.p) and torch.equal(got.beta, want.beta)


def test_device_state_matches_reference(trained_fleet):  # noqa: F811
    for idx in (0, 7, D_ODD - 1):
        got, want = device_state(_port(trained_fleet), idx), ref_device_state(trained_fleet, idx)
        np.testing.assert_array_equal(got.p.numpy(), np.asarray(want.p))
        np.testing.assert_array_equal(got.beta.numpy(), np.asarray(want.beta))
        np.testing.assert_array_equal(got.params.alpha.numpy(), np.asarray(want.params.alpha))
        assert (got.activation, got.forget) == (want.activation, want.forget)


@pytest.mark.parametrize("args", [(128, 10, 561, 32, 561), (13, 1, 24, 8, 24, 2)])
def test_fedavg_total_cost_matches_reference(args):
    from repro.fleet import model_nbytes as ref_model_nbytes

    got, want = fedavg_total_cost(*args), ref_fedavg_total_cost(*args)
    assert (got.topology, got.n_devices, got.payloads, got.bytes_total, got.precision) == (
        want.topology, want.n_devices, want.payloads, want.bytes_total, want.precision)
    assert got.bytes_per_device == want.bytes_per_device
    assert model_nbytes(*args[2:]) == ref_model_nbytes(*args[2:])
