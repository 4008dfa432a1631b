"""The port's plain fused ingest against the reference on the CPU.

``repro_torch.kernels.fleet_ingest_plain`` (what the wrapper runs for a
CPU tensor) is held to the reference Pallas kernel in interpret mode and
to the reference's sequential ``_fleet_train`` chain, on odd D/T/Ñ/n and
with λ < 1, at the edges of the kernel's chunking of the window (one
sample, and a window longer than ``INGEST_CHUNK``), and at wide hidden
layers (Ñ = 256, chunks of ``INGEST_WIDE_CHUNK``; Ñ = 384, past the card's
cluster P chain). Bounds are those of ``tests/test_fleet_ingest.py:80-92``:
losses at rtol 1e-5 / atol 1e-7, state at 1e-5. With sigmoid the fixture
carries the reference's ridge 5e-2: RLS parity in f32 degrades as κ(P)².
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ae_score
from repro.fleet import init_fleet
from repro.fleet.fleet import _fleet_train
from repro.kernels.fleet_ingest import fleet_ingest_kernel
from repro_torch.convert import oselm_state_from_numpy
from repro_torch.kernels import fleet_ingest, fleet_ingest_plain, validate_shared_basis
from repro_torch.kernels.fleet_ingest import (
    INGEST_CHUNK,
    INGEST_WIDE_CHUNK,
    INGEST_WIDE_N,
    ingest_chunk,
    ingest_chunks,
)

torch.set_num_threads(2)

D_ODD, T_ODD, F_ODD, NH_ODD = 13, 17, 37, 10
RIDGE = 1e-3


def _fleet(activation, forget, ridge, seed=0):
    rng = np.random.default_rng(seed)
    x_init = rng.uniform(0, 1, (D_ODD, 4 * NH_ODD, F_ODD)).astype(np.float32)
    return init_fleet(jax.random.PRNGKey(seed), D_ODD, F_ODD, NH_ODD, jnp.asarray(x_init),
                      activation=activation, ridge=ridge, forget=forget)


def _window(seed=1, t=T_ODD):
    return np.random.default_rng(seed).uniform(0, 1, (D_ODD, t, F_ODD)).astype(np.float32)


def _port(fleet):
    return oselm_state_from_numpy(
        fleet.params.alpha, fleet.params.bias, fleet.beta, fleet.p,
        activation=fleet.activation, forget=fleet.forget, device="cpu",
    )


def _assert_state_close(got, ref, *, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(got.p.numpy(), np.asarray(ref.p), rtol=rtol, atol=atol)
    np.testing.assert_allclose(got.beta.numpy(), np.asarray(ref.beta), rtol=rtol, atol=atol)


@pytest.mark.parametrize("activation,forget", [
    ("sigmoid", 1.0), ("identity", 0.95), ("identity", 1.0), ("sigmoid", 0.95),
])
def test_plain_ingest_matches_pallas_interpret(activation, forget):
    ridge = 5e-2 if activation == "sigmoid" else RIDGE
    fleet = _fleet(activation, forget, ridge)
    win = _window()
    ref, ref_loss = fleet_ingest_kernel(fleet, jnp.asarray(win), block_d=4, interpret=True)
    got, loss = fleet_ingest_plain(_port(fleet), torch.from_numpy(win))
    _assert_state_close(got, ref)
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("activation,forget", [("identity", 0.95), ("sigmoid", 1.0)])
def test_plain_ingest_matches_sequential_reference(activation, forget):
    ridge = 5e-2 if activation == "sigmoid" else RIDGE
    fleet = _fleet(activation, forget, ridge, seed=3)
    win = _window(4)
    ref = _fleet_train(fleet, jnp.asarray(win))
    ref_loss = jax.vmap(lambda s, xb: jnp.mean(ae_score(s, xb)))(fleet, jnp.asarray(win))
    got, loss = fleet_ingest(_port(fleet), torch.from_numpy(win))
    _assert_state_close(got, ref)
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss), rtol=1e-5, atol=1e-7)


# one sample (a chunk of one), and a window of two chunks, the second
# ragged: the β of the first chunk is β₀ of the second
@pytest.mark.parametrize("t,activation,forget", [
    (1, "identity", 0.95), (1, "sigmoid", 1.0),
    (INGEST_CHUNK + 6, "identity", 0.95), (INGEST_CHUNK + 6, "sigmoid", 1.0),
])
def test_plain_ingest_at_chunk_edges_matches_reference(t, activation, forget):
    ridge = 5e-2 if activation == "sigmoid" else RIDGE
    fleet = _fleet(activation, forget, ridge, seed=6)
    win = _window(7, t)
    got, loss = fleet_ingest_plain(_port(fleet), torch.from_numpy(win))
    ref, ref_loss = fleet_ingest_kernel(fleet, jnp.asarray(win), block_d=4, interpret=True)
    _assert_state_close(got, ref)
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss), rtol=1e-5, atol=1e-7)
    seq = _fleet_train(fleet, jnp.asarray(win))
    seq_loss = jax.vmap(lambda s, xb: jnp.mean(ae_score(s, xb)))(fleet, jnp.asarray(win))
    _assert_state_close(got, seq)
    np.testing.assert_allclose(loss.numpy(), np.asarray(seq_loss), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("t", [0, 1, INGEST_CHUNK - 1, INGEST_CHUNK, INGEST_CHUNK + 1,
                               3 * INGEST_CHUNK + 5])
def test_ingest_chunks_cover_every_sample_once_in_order(t):
    chunks = ingest_chunks(t)
    covered = [s for c0, c1 in chunks for s in range(c0, c1)]
    assert covered == list(range(t))
    assert all(0 < c1 - c0 <= INGEST_CHUNK for c0, c1 in chunks)
    assert all(c1 - c0 == INGEST_CHUNK for c0, c1 in chunks[:-1])


# a wide hidden layer, Ñ = 256, where the chunk shrinks to 32 samples: one
# chunk, two with the second ragged, and three; n = 300 features so that H
# has full column rank. Identity only: with sigmoid on this fixture κ(P) is
# ~1e6 and the reference's own kernel and sequential chain differ past
# these bounds
@pytest.mark.parametrize("t,activation,forget", [
    (INGEST_WIDE_CHUNK, "identity", 0.95), (INGEST_WIDE_CHUNK + 6, "identity", 1.0),
    (2 * INGEST_WIDE_CHUNK + 6, "identity", 0.95),
])
def test_plain_ingest_on_a_wide_layer_matches_reference(t, activation, forget):
    ridge = 5e-2 if activation == "sigmoid" else RIDGE
    d, n, nh = 3, 300, 256
    rng = np.random.default_rng(11)
    x_init = rng.uniform(0, 1, (d, 2 * nh, n)).astype(np.float32)
    fleet = init_fleet(jax.random.PRNGKey(11), d, n, nh, jnp.asarray(x_init),
                       activation=activation, ridge=ridge, forget=forget)
    win = rng.uniform(0, 1, (d, t, n)).astype(np.float32)
    assert ingest_chunk(nh) == INGEST_WIDE_CHUNK
    got, loss = fleet_ingest_plain(_port(fleet), torch.from_numpy(win))
    ref, ref_loss = fleet_ingest_kernel(fleet, jnp.asarray(win), block_d=4, interpret=True)
    _assert_state_close(got, ref)
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss), rtol=1e-5, atol=1e-7)
    seq = _fleet_train(fleet, jnp.asarray(win))
    _assert_state_close(got, seq)


# past the card's cluster P chain (Ñ > 320: P in global memory, β streamed
# in runs of rows), at Ñ = 384 with n = 400 features: a window across the
# chunk edge, λ 0.95 and 1, ridge 1 (at ridge 1e-3 the boot of a layer this
# wide on 2·Ñ rows is too ill-posed for f32 parity in either package)
@pytest.mark.parametrize("forget", [0.95, 1.0])
def test_plain_ingest_past_the_cluster_chain_matches_reference(forget):
    d, n, nh, t = 2, 400, 384, INGEST_WIDE_CHUNK + 6
    rng = np.random.default_rng(12)
    x_init = rng.uniform(0, 1, (d, 2 * nh, n)).astype(np.float32)
    fleet = init_fleet(jax.random.PRNGKey(12), d, n, nh, jnp.asarray(x_init),
                       activation="identity", ridge=1.0, forget=forget)
    win = rng.uniform(0, 1, (d, t, n)).astype(np.float32)
    got, loss = fleet_ingest_plain(_port(fleet), torch.from_numpy(win))
    ref, ref_loss = fleet_ingest_kernel(fleet, jnp.asarray(win), block_d=2, interpret=True)
    _assert_state_close(got, ref)
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss), rtol=1e-5, atol=1e-7)
    seq = _fleet_train(fleet, jnp.asarray(win))
    _assert_state_close(got, seq)


@pytest.mark.parametrize("nh", [321, 384, 544, 768, 1024])
def test_ingest_chunk_past_the_cluster_chain(nh):
    """The wide kernels take the window in chunks of INGEST_WIDE_CHUNK
    samples, and so does the plain version."""
    assert ingest_chunk(nh) == INGEST_WIDE_CHUNK


def test_ingest_chunk_shrinks_past_the_wide_width():
    """64 samples a chunk up to Ñ = 240, 32 past it, and chunks of 32 cover
    a window once, in order."""
    assert [ingest_chunk(nh) for nh in (1, 128, INGEST_WIDE_N, INGEST_WIDE_N + 1, 320)] == [
        INGEST_CHUNK, INGEST_CHUNK, INGEST_CHUNK, INGEST_WIDE_CHUNK, INGEST_WIDE_CHUNK]
    chunks = ingest_chunks(3 * INGEST_WIDE_CHUNK + 5, INGEST_WIDE_CHUNK)
    assert [s for c0, c1 in chunks for s in range(c0, c1)] == list(range(3 * INGEST_WIDE_CHUNK + 5))
    assert [c1 - c0 for c0, c1 in chunks] == [INGEST_WIDE_CHUNK] * 3 + [5]


def test_plain_ingest_supervised_targets():
    """m ≠ n with explicit targets: one device's chain equals the port's
    own single-sample k=1 steps."""
    from repro_torch import core as tcore

    rng = np.random.default_rng(5)
    n, nh, m, t = 9, 5, 4, 7
    params = tcore.SLFNParams(torch.from_numpy(rng.uniform(-1, 1, (n, nh)).astype(np.float32)),
                              torch.from_numpy(rng.uniform(-1, 1, nh).astype(np.float32)))
    x0 = torch.from_numpy(rng.uniform(0, 1, (3, 12, n)).astype(np.float32))
    t0 = torch.from_numpy(rng.uniform(0, 1, (3, 12, m)).astype(np.float32))
    fleet = tcore.init_oselm(params, x0, t0, activation="identity", ridge=1e-2, forget=0.9)
    xs = torch.from_numpy(rng.uniform(0, 1, (3, t, n)).astype(np.float32))
    ts = torch.from_numpy(rng.uniform(0, 1, (3, t, m)).astype(np.float32))
    got, _ = fleet_ingest_plain(fleet, xs, ts)
    one = fleet.replace(beta=fleet.beta[1], p=fleet.p[1])
    for i in range(t):
        one = tcore.oselm_step_k1(one, xs[1, i], ts[1, i])
    np.testing.assert_allclose(got.p[1].numpy(), one.p.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.beta[1].numpy(), one.beta.numpy(), rtol=1e-5, atol=1e-6)


def test_ingest_rejects_bad_shapes_and_bases():
    fleet = _port(_fleet("identity", 1.0, RIDGE))
    with pytest.raises(ValueError, match="window"):
        fleet_ingest(fleet, torch.zeros(D_ODD, F_ODD))
    with pytest.raises(ValueError, match="m == n"):
        fleet_ingest(fleet.replace(beta=fleet.beta[:, :, :5]), torch.zeros(D_ODD, 2, F_ODD))
    stacked = np.stack([np.zeros((3, 2)), np.ones((3, 2))])
    with pytest.raises(ValueError, match="shared SLFN basis"):
        validate_shared_basis(stacked)
