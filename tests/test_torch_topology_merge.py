"""The port's masked merge against the reference on the CPU.

- The masked segment sum's plain version against the reference's Pallas
  kernel in interpret mode, at 1e-5.
- The two Gauss-Jordan solves' plain versions (``from_uv_solve``,
  ``banded_merge_solve``) update every row but the pivot row by row_k =
  w[k]/w[k,k], leave the pivot row scaled by its pivot and multiply each
  row by its pivot's reciprocal at the end, where the reference's
  ``_gj_sweep`` also updates the pivot row, as w[k] − (w[k,k] − 1)·row_k,
  and so brings row_k's rounding back times w[k,k]. They are held bit for
  bit to a jnp sweep written here (``jnp_gj_solve``: the reference's sweep
  with the pivot row left out of the update), and each test also prints how far the
  reference's interpret-mode kernel, the port's solve and
  ``torch.linalg.solve`` are from an f64 solve of the same system. After
  two star merges of 64 devices at Ñ = 4 (pivots of ~6 100) and on a
  star sum at the har width the port's f32 solve is within 4× of
  ``torch.linalg.solve``'s error against f64.
- ``fleet_merge_masked_kernel``, the port's one merge, on the plain
  versions of its kernels, against the reference's ``fleet_merge_masked``
  (the XLA Cholesky form) on every topology the runtime routes, at
  D = 13 with random masks, one of which empties a whole cluster, and
  with the all-ones mask against the reference's unmasked
  ``fleet_merge``. P is held at 1e-5; β at atol 5e-5, because the
  reference's own Gauss-Jordan and Cholesky solves differ by up to
  1.8e-5 on β at this conditioning (ROADMAP queue 3).
- Non-participants keep their state bit for bit.
- ``dense_mix_plain`` (one fused multiply-add per device, in device
  order, as the CUDA kernel) against the reference's ``dense_mix`` in
  interpret mode, on shapes that straddle its 128 tiles: the reference
  sums each 128-device tile with one dot product, so the two agree to
  f32 rounding of the sum (1e-6 relative here), not bit for bit. A custom
  dense topology merges through it.
- ``_fma``, the plain versions' fused multiply-add, rounds once: on sums
  that lie just off an f32 midpoint, where rounding an f64 sum to f32
  would round twice, it gives the exact sum rounded to nearest.
"""
import functools
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fleet import (
    all_to_all as ref_all_to_all,
    fleet_merge as ref_fleet_merge,
    fleet_merge_masked as ref_fleet_merge_masked,
    fleet_train as ref_fleet_train,
    hierarchical as ref_hierarchical,
    init_fleet as ref_init_fleet,
    ring as ref_ring,
    star as ref_star,
)
from repro.fleet.topology import Topology as RefTopology
from repro.kernels.topology_merge import (
    banded_merge_solve as ref_banded_merge_solve,
    dense_mix as ref_dense_mix,
    from_uv_solve as ref_from_uv_solve,
    masked_segment_sum_mix as ref_masked_segment_sum_mix,
)
from repro_torch.convert import oselm_state_from_numpy
from repro_torch.core import UV
from repro_torch.fleet import (
    Topology,
    all_to_all,
    fleet_from_uv,
    fleet_merge_masked_kernel,
    fleet_to_uv,
    hierarchical,
    ring,
    star,
)
from repro_torch.kernels import (
    banded_merge_solve_plain,
    dense_mix,
    dense_mix_plain,
    from_uv_solve_plain,
    masked_segment_sum_mix_plain,
)

torch.set_num_threads(2)

D_ODD, R_ODD, C_ODD = 13, 10, 37
RIDGE = 1e-3

TOPOS = {
    "star": (star, ref_star),
    "hierarchical": (lambda d: hierarchical(d, 3), lambda d: ref_hierarchical(d, 3)),
    "hierarchical_isolated": (
        lambda d: hierarchical(d, 3, head_exchange=False),
        lambda d: ref_hierarchical(d, 3, head_exchange=False),
    ),
    "all_to_all": (all_to_all, ref_all_to_all),
    "ring1": (lambda d: ring(d, 1), lambda d: ref_ring(d, 1)),
    "ring2": (lambda d: ring(d, 2), lambda d: ref_ring(d, 2)),
}

# cluster ids of hierarchical(13, 3): [0]*5 + [1]*4 + [2]*4; the last mask
# drops every member of cluster 1
MASKS = {
    "all": np.ones(D_ODD, np.float32),
    "random": (np.random.default_rng(0).random(D_ODD) < 0.7).astype(np.float32),
    "cluster1_out": np.array([1] * 5 + [0] * 4 + [1, 0, 1, 1], np.float32),
}


def _spd(rng, s, n):
    a = rng.standard_normal((s, n, 3 * n)).astype(np.float32)
    return (a @ a.transpose(0, 2, 1) / (3 * n)).astype(np.float32)


def _gj_sweep(w, n):
    """n elimination steps on one [A | I | V] block: the reference's
    ``_gj_sweep`` with the pivot row left as it is (scaled by its pivot),
    then each row times its pivot's reciprocal."""
    rows = jax.lax.broadcasted_iota(jnp.int32, (w.shape[0], 1), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (1, w.shape[1]), 1)

    def body(k, carry):
        w, piv = carry
        row_k = jnp.sum(jnp.where(rows == k, w, 0.0), axis=0, keepdims=True)
        pivot = jnp.sum(jnp.where(cols == k, row_k, 0.0))
        col_k = jnp.sum(jnp.where(cols == k, w, 0.0), axis=1, keepdims=True)
        w = jnp.where(rows == k, w, w - col_k * (row_k / pivot))
        return w, jnp.where(rows == k, pivot, piv)

    w, piv = jax.lax.fori_loop(0, n, body, (w, jnp.ones((w.shape[0], 1), w.dtype)))
    return w * (1.0 / piv)


@functools.partial(jax.jit, static_argnums=2)
def _jnp_gj_solve(u, v, ridge):
    s, n, _ = u.shape
    a = u + ridge * jnp.eye(n, dtype=jnp.float32)
    eye = jnp.broadcast_to(jnp.eye(n, dtype=jnp.float32), (s, n, n))
    w = jax.vmap(lambda x: _gj_sweep(x, n))(jnp.concatenate([a, eye, v], axis=2))
    return w[:, :, n : 2 * n], w[:, :, 2 * n :]


def jnp_gj_solve(u, v, ridge=0.0):
    """P = (U+εI)⁻¹ and β = PV per system by the sweep above, jitted on
    the CPU (XLA contracts its update into one fused multiply-add, as the
    port's plain version rounds it), as numpy arrays."""
    p, b = _jnp_gj_solve(jnp.asarray(u, jnp.float32), jnp.asarray(v, jnp.float32), float(ridge))
    return np.asarray(p), np.asarray(b)


def jnp_banded_merge_solve(w, hops, ridge=0.0):
    """The open ring's merge by the sweep above: device d solves the sum of
    the payloads of devices (d − hops .. d + hops) mod D, added in that
    order from the first."""
    w = jnp.asarray(w, jnp.float32)
    n = w.shape[1]
    acc = jnp.roll(w, hops, axis=0)
    for o in range(-hops + 1, hops + 1):
        acc = acc + jnp.roll(w, -o, axis=0)
    return jnp_gj_solve(acc[:, :, :n], acc[:, :, n:], ridge)


def _f64_solve(u, v, ridge):
    """The f32 system U + εI (ridge added in f32) solved in f64."""
    n = u.shape[-1]
    a = (np.asarray(u, np.float32) + np.float32(ridge) * np.eye(n, dtype=np.float32))
    a = a.astype(np.float64)
    return np.linalg.inv(a), np.linalg.solve(a, np.asarray(v, np.float64))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _solve_errors(what, u, v, ridge, **solves) -> dict[str, float]:
    """Each solve's β (and P) against the f64 solve of the same f32 system,
    relative to the largest f64 value, printed."""
    p64, b64 = _f64_solve(u, v, ridge)
    errs = {k: max(_rel(p, p64), _rel(b, b64)) for k, (p, b) in solves.items()}
    print(f"{what}: off an f64 solve " + ", ".join(f"{k} {e:.3e}" for k, e in errs.items()))
    return errs


def _linalg_solve(u, v, ridge):
    ut, vt = torch.as_tensor(np.asarray(u, np.float32)), torch.as_tensor(np.asarray(v, np.float32))
    n = ut.shape[-1]
    a = ut + ridge * torch.eye(n)
    x = torch.linalg.solve(a, torch.cat([torch.eye(n).expand(a.shape), vt], dim=-1))
    return x[..., :n].numpy(), x[..., n:].numpy()


def test_masked_segment_sum_plain_matches_interpret():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((D_ODD, R_ODD, C_ODD)).astype(np.float32)
    cids = np.array([0] * 4 + [2] * 6 + [3] * 3, np.int32)  # cluster 1 empty
    mask = MASKS["random"]
    ref = ref_masked_segment_sum_mix(jnp.asarray(w), cids, jnp.asarray(mask), 4, interpret=True)
    got = masked_segment_sum_mix_plain(torch.from_numpy(w), cids, torch.from_numpy(mask), 4)
    # the reference never writes the block of a cluster without members
    # (it reads as NaN in interpret mode); the port writes zeros there
    live = [0, 2, 3]
    np.testing.assert_allclose(got.numpy()[live], np.asarray(ref)[live], rtol=1e-5, atol=1e-5)
    assert not got[1].any()
    with pytest.raises(ValueError, match="sorted"):
        masked_segment_sum_mix_plain(torch.from_numpy(w), cids[::-1].copy(),
                                     torch.from_numpy(mask), 4)


def _hold_solve(what, u, v, p, b, ref_p, ref_b, want_p, want_b):
    """The port's plain solve bit for bit against the jnp sweep; the
    reference's interpret-mode kernel and the port's solve each against an
    f64 solve, printed (the kernel's pivot row carries its rounding times
    the pivot, so it is no oracle for the port's bits)."""
    assert np.array_equal(p.numpy(), want_p) and np.array_equal(b.numpy(), want_b), what
    errs = _solve_errors(what, u, v, RIDGE, interpret_kernel=(ref_p, ref_b), port=(p, b))
    assert max(errs.values()) < 1e-3, errs


@pytest.mark.parametrize("s", [1, 3])
def test_from_uv_solve_plain_matches_interpret(s):
    rng = np.random.default_rng(2)
    u = _spd(rng, s, R_ODD)
    v = rng.standard_normal((s, R_ODD, 23)).astype(np.float32)
    ref_p, ref_b = ref_from_uv_solve(jnp.asarray(u), jnp.asarray(v), ridge=RIDGE, interpret=True)
    p, b = from_uv_solve_plain(torch.from_numpy(u), torch.from_numpy(v), ridge=RIDGE)
    _hold_solve(f"from_uv_solve S={s}", u, v, p, b, ref_p, ref_b, *jnp_gj_solve(u, v, RIDGE))


def _band_sum(w, hops):
    acc = np.roll(w, hops, axis=0)
    for o in range(-hops + 1, hops + 1):
        acc = acc + np.roll(w, -o, axis=0)
    return acc


@pytest.mark.parametrize("hops", [1, 2])
def test_banded_merge_solve_plain_matches_interpret(hops):
    rng = np.random.default_rng(3 + hops)
    u = _spd(rng, D_ODD, R_ODD)
    v = rng.standard_normal((D_ODD, R_ODD, 23)).astype(np.float32)
    w = np.concatenate([u, v], axis=2) * MASKS["random"][:, None, None]
    ref_p, ref_b = ref_banded_merge_solve(jnp.asarray(w), hops, ridge=RIDGE, interpret=True)
    p, b = banded_merge_solve_plain(torch.from_numpy(w), hops, ridge=RIDGE)
    acc = _band_sum(w, hops)
    _hold_solve(f"banded_merge_solve hops={hops}", acc[:, :, :R_ODD], acc[:, :, R_ODD:], p, b,
                ref_p, ref_b, *jnp_banded_merge_solve(w, hops, RIDGE))
    with pytest.raises(ValueError, match="band"):
        banded_merge_solve_plain(torch.from_numpy(w[:4]), 2, ridge=RIDGE)


# a wide hidden layer, Ñ = 256, which the card's cluster solve takes since
# it holds 10 row registers a slot (Ñ ≤ 320): m and D kept small
@pytest.mark.parametrize("s", [1, 2])
def test_from_uv_solve_plain_matches_interpret_on_a_wide_layer(s):
    rng = np.random.default_rng(40 + s)
    u = _spd(rng, s, 256)
    v = rng.standard_normal((s, 256, 23)).astype(np.float32)
    ref_p, ref_b = ref_from_uv_solve(jnp.asarray(u), jnp.asarray(v), ridge=RIDGE, interpret=True)
    p, b = from_uv_solve_plain(torch.from_numpy(u), torch.from_numpy(v), ridge=RIDGE)
    _hold_solve(f"from_uv_solve Ñ=256 S={s}", u, v, p, b, ref_p, ref_b,
                *jnp_gj_solve(u, v, RIDGE))


@pytest.mark.parametrize("hops", [1, 2])
def test_banded_merge_solve_plain_matches_interpret_on_a_wide_layer(hops):
    rng = np.random.default_rng(44 + hops)
    u = _spd(rng, 5, 256)
    v = rng.standard_normal((5, 256, 23)).astype(np.float32)
    w = np.concatenate([u, v], axis=2)
    ref_p, ref_b = ref_banded_merge_solve(jnp.asarray(w), hops, ridge=RIDGE, interpret=True)
    p, b = banded_merge_solve_plain(torch.from_numpy(w), hops, ridge=RIDGE)
    acc = _band_sum(w, hops)
    _hold_solve(f"banded_merge_solve Ñ=256 hops={hops}", acc[:, :, :256], acc[:, :, 256:], p, b,
                ref_p, ref_b, *jnp_banded_merge_solve(w, hops, RIDGE))


@pytest.fixture(scope="module")
def trained_fleet():
    rng = np.random.default_rng(4)
    feat, hid = 24, 8
    x_init = rng.uniform(0, 1, (D_ODD, 2 * hid, feat)).astype(np.float32)
    fleet = ref_init_fleet(jax.random.PRNGKey(0), D_ODD, feat, hid, jnp.asarray(x_init),
                           activation="identity", ridge=RIDGE)
    streams = rng.uniform(0, 1, (D_ODD, 16, feat)).astype(np.float32)
    return ref_fleet_train(fleet, jnp.asarray(streams))


def _port(fleet):
    return oselm_state_from_numpy(
        fleet.params.alpha, fleet.params.bias, fleet.beta, fleet.p,
        activation=fleet.activation, forget=fleet.forget, device="cpu",
    )


@pytest.mark.parametrize("mask_name", sorted(MASKS))
@pytest.mark.parametrize("topo_name", sorted(TOPOS))
def test_masked_merge_matches_reference(trained_fleet, topo_name, mask_name):
    port_fn, ref_fn = TOPOS[topo_name]
    mask = MASKS[mask_name]
    ref = ref_fleet_merge_masked(trained_fleet, ref_fn(D_ODD), jnp.asarray(mask), ridge=RIDGE)
    before = _port(trained_fleet)
    got = fleet_merge_masked_kernel(before, port_fn(D_ODD), torch.from_numpy(mask), ridge=RIDGE)
    np.testing.assert_allclose(got.p.numpy(), np.asarray(ref.p), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.beta.numpy(), np.asarray(ref.beta), rtol=1e-5, atol=5e-5)
    out = mask == 0
    assert torch.equal(got.p[out], before.p[out])
    assert torch.equal(got.beta[out], before.beta[out])


@pytest.mark.parametrize("topo_name", sorted(TOPOS))
def test_all_ones_mask_is_the_unmasked_merge(trained_fleet, topo_name):
    """With every device taking part, the masked merge is the reference's
    unmasked ``fleet_merge``."""
    port_fn, ref_fn = TOPOS[topo_name]
    ref = ref_fleet_merge(trained_fleet, ref_fn(D_ODD), ridge=RIDGE)
    got = fleet_merge_masked_kernel(_port(trained_fleet), port_fn(D_ODD), torch.ones(D_ODD),
                                    ridge=RIDGE)
    np.testing.assert_allclose(got.p.numpy(), np.asarray(ref.p), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.beta.numpy(), np.asarray(ref.beta), rtol=1e-5, atol=5e-5)


def _custom_mask(d, seed=9):
    """A seeded symmetric 0/1 mask with its diagonal set."""
    m = (np.random.default_rng(seed).random((d, d)) < 0.35).astype(np.float32)
    return np.maximum(np.maximum(m, m.T), np.eye(d, dtype=np.float32))


# (130, 3, 50): 130 devices and 150 columns straddle the reference's
# 128-wide tiles; (13, 10, 37): odd everything
@pytest.mark.parametrize("d,r,c", [(130, 3, 50), (13, 10, 37)])
def test_dense_mix_plain_matches_interpret(d, r, c):
    x = np.random.default_rng(10).standard_normal((d, r, c)).astype(np.float32)
    m = _custom_mask(d)
    want = np.asarray(ref_dense_mix(jnp.asarray(x), jnp.asarray(m), interpret=True))
    got = dense_mix(torch.from_numpy(x), m)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    # a 0/1 mask: every product is exact, so each step rounds once; the
    # sum in device order is what the plain version computes
    order = np.zeros((d, r * c), np.float32)
    for k in range(d):
        order = order + m[:, k : k + 1] * x[k].reshape(1, -1)
    np.testing.assert_array_equal(got.numpy().reshape(d, -1), order)
    with pytest.raises(ValueError, match="matrix"):
        dense_mix_plain(torch.from_numpy(x), m[:-1])


def test_dense_partial_mask_needs_dense_mix(trained_fleet):
    """A dense topology that is not fully connected merges through
    ``dense_mix`` and a solve per device, as the reference's."""
    m = _custom_mask(D_ODD)
    topo = Topology(name="custom", n_devices=D_ODD, kind="dense", matrix=m)
    ref_topo = RefTopology(name="custom", n_devices=D_ODD, kind="dense", matrix=m)
    assert not topo.is_fully_connected
    for mask in MASKS.values():
        ref = ref_fleet_merge_masked(trained_fleet, ref_topo, jnp.asarray(mask), ridge=RIDGE)
        before = _port(trained_fleet)
        got = fleet_merge_masked_kernel(before, topo, torch.from_numpy(mask), ridge=RIDGE)
        np.testing.assert_allclose(got.p.numpy(), np.asarray(ref.p), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.beta.numpy(), np.asarray(ref.beta), rtol=1e-5, atol=5e-5)
        out = mask == 0
        assert torch.equal(got.p[out], before.p[out])


def test_ring_mask_as_a_dense_topology_is_the_banded_merge(trained_fleet):
    """The ring's ±2 mask given as a dense matrix takes the dense route and
    lands on the banded route's merge; the sums differ only in their order
    (device order against the band's), so at f32 rounding."""
    banded = ring(D_ODD, 2)
    dense = Topology(name="ring2_dense", n_devices=D_ODD, kind="dense",
                     matrix=banded.dense_matrix())
    mask = torch.from_numpy(MASKS["random"])
    fleet = _port(trained_fleet)
    want = fleet_merge_masked_kernel(fleet, banded, mask, ridge=RIDGE)
    got = fleet_merge_masked_kernel(fleet, dense, mask, ridge=RIDGE)
    np.testing.assert_allclose(got.p.numpy(), want.p.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.beta.numpy(), want.beta.numpy(), rtol=1e-5, atol=1e-5)


def test_fleet_from_uv_nonfinite_guards(trained_fleet):
    fleet = _port(trained_fleet)
    uv = fleet_to_uv(fleet, ridge=RIDGE)
    u = uv.u.clone()
    u[3, 0, 0] = float("nan")
    with pytest.raises(ValueError, match=r"devices \[3\]"):
        fleet_from_uv(fleet, UV(u=u, v=uv.v), ridge=RIDGE)
    fixed = fleet_from_uv(fleet, UV(u=u, v=uv.v), ridge=RIDGE, nonfinite="repair")
    assert torch.isfinite(fixed.p).all()
    np.testing.assert_allclose(fixed.beta[3].numpy(), 0.0)
    with pytest.raises(ValueError, match="nonfinite"):
        fleet_from_uv(fleet, uv, nonfinite="ignore")


@pytest.mark.parametrize("topo_name", sorted(TOPOS))
def test_topology_and_round_cost_match_reference(topo_name):
    from repro.fleet.comm import topology_round_cost as ref_cost
    from repro_torch.fleet import topology_round_cost

    port_fn, ref_fn = TOPOS[topo_name]
    for d in (D_ODD, 64):
        got, want = port_fn(d), ref_fn(d)
        assert got.name == want.name and got.is_fully_connected == want.is_fully_connected
        assert got.band_closed == want.band_closed
        np.testing.assert_array_equal(got.dense_matrix(), want.dense_matrix())
        a, b = topology_round_cost(got, 128, 561), ref_cost(want, 128, 561)
        assert (a.topology, a.n_devices, a.payloads, a.bytes_total) == (
            b.topology, b.n_devices, b.payloads, b.bytes_total)


def test_fleet_score_matches_reference(trained_fleet):
    from repro.fleet import fleet_score as ref_fleet_score
    from repro_torch.fleet import fleet_score

    x = np.random.default_rng(8).uniform(0, 1, (7, 24)).astype(np.float32)
    want = ref_fleet_score(trained_fleet, jnp.asarray(x))
    got = fleet_score(_port(trained_fleet), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


def _round_to_f32(x: Fraction) -> np.float32:
    """x rounded to the nearest f32, ties to even, from exact arithmetic."""
    f = np.float32(float(x))
    near = [f, np.nextafter(f, np.float32(np.inf)), np.nextafter(f, np.float32(-np.inf))]
    return min(near, key=lambda y: (abs(Fraction(float(y)) - x), int(np.array(y).view(np.int32)) & 1))


# c + a·b = c + ½ulp(c) ∓ 2^-70·2^e: the f64 sum is exactly the midpoint
# between two f32 values, the exact sum is not; c's last bit odd or even
@pytest.mark.parametrize("c0", [1 + 2**-23, 1 + 2**-22, 1.5 + 2**-23, 1.75])
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_plain_fma_rounds_once(c0, sign):
    from repro_torch.kernels.topology_merge import _fma

    scale = 2.0 ** np.arange(-20, 21, 4)
    a = (sign * scale * 2.0**-12 * (1 + 2**-23)).astype(np.float32)
    b = np.float32(2.0**-12 * (1 - 2**-23))
    c = (sign * c0 * scale).astype(np.float32)
    got = _fma(torch.from_numpy(a), torch.tensor(b), torch.from_numpy(c)).numpy()
    for i in range(a.size):
        exact = Fraction(float(a[i])) * Fraction(float(b)) + Fraction(float(c[i]))
        assert got[i] == _round_to_f32(exact), (a[i], b, c[i])


# c + a·b in the f32 subnormal range: c = k·2^-149, a·b = 2^-150·(1 ∓ 2^-46),
# so the f64 sum is a midpoint between two subnormals and the exact sum is
# not; k odd or even, both signs, both sides of the midpoint
@pytest.mark.parametrize("k", [1, 2, 7, 1000, 2**22 - 1, 2**22 + 1])
def test_plain_fma_rounds_once_below_the_normals(k):
    from repro_torch.kernels.topology_merge import _fma

    a = np.array([s * 2.0**-75 * (1 + 2**-23) for s in (1, 1, -1, -1)], np.float32)
    b = np.array([2.0**-75 * (1 - 2**-23), 2.0**-75 * (1 + 2**-23)] * 2, np.float32)
    c = (np.sign(a) * k * 2.0**-149).astype(np.float32)
    got = _fma(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    for i in range(a.size):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        assert got[i] == _round_to_f32(exact), (a[i], b[i], c[i])


def test_plain_solve_matches_an_elimination_rounded_once():
    """A 3 × 3 system whose first update of V's row 1 is (1 + 2^-23) +
    2^-24·(1 − 2^-46): its f64 sum lies on an f32 midpoint. The plain solve
    equals the elimination done in exact arithmetic, each division and each
    update rounded once to f32, the pivot row left out of the update and
    each row times its pivot's reciprocal at the end."""
    from repro_torch.kernels.topology_merge import from_uv_solve_plain

    r = np.float32(1e-3)
    u = np.array([[1 - r, -(2.0**-12) * (1 + 2**-23), 0.25],
                  [-(2.0**-12) * (1 + 2**-23), 1.5, -0.125],
                  [0.25, -0.125, 0.75]], np.float32)
    v = np.array([[2.0**-12 * (1 - 2**-23), 0.5], [1 + 2**-23, -1.25], [0.375, 3.0]], np.float32)
    p, b = from_uv_solve_plain(torch.from_numpy(u)[None], torch.from_numpy(v)[None], ridge=1e-3)

    def rn(x):
        return Fraction(float(_round_to_f32(x)))

    n = 3
    a = [[rn(Fraction(float(u[i, j])) + (Fraction(float(r)) if i == j else 0)) for j in range(n)]
         for i in range(n)]
    w = [a[i] + [Fraction(int(i == j)) for j in range(n)] + [Fraction(float(x)) for x in v[i]]
         for i in range(n)]
    piv = []
    for k in range(n):
        piv.append(w[k][k])
        row = [rn(x / w[k][k]) for x in w[k]]
        w = [w[i] if i == k else [rn(w[i][j] - w[i][k] * row[j]) for j in range(len(row))]
             for i in range(n)]
    w = [[rn(x * rn(1 / piv[i])) for x in w[i]] for i in range(n)]
    want = np.array([[float(x) for x in wi] for wi in w], np.float32)
    assert np.array_equal(p[0].numpy(), want[:, n : 2 * n])
    assert np.array_equal(b[0].numpy(), want[:, 2 * n :])


# past the card's cluster solve (Ñ > 320, the blocked wide solve on the
# card): the plain version is the jnp sweep step for step, so no element
# differs from it (m and S kept small)
@pytest.mark.parametrize("n", [384, 544])
def test_from_uv_solve_plain_is_the_interpret_kernel_past_the_cluster_solve(n):
    rng = np.random.default_rng(50 + n)
    u = _spd(rng, 2, n)
    v = rng.standard_normal((2, n, 16)).astype(np.float32)
    ref_p, ref_b = ref_from_uv_solve(jnp.asarray(u), jnp.asarray(v), ridge=RIDGE, interpret=True)
    p, b = from_uv_solve_plain(torch.from_numpy(u), torch.from_numpy(v), ridge=RIDGE)
    _hold_solve(f"from_uv_solve Ñ={n}", u, v, p, b, ref_p, ref_b, *jnp_gj_solve(u, v, RIDGE))


@pytest.mark.parametrize("n", [384, 544])
def test_banded_merge_solve_plain_is_the_interpret_kernel_past_the_cluster_solve(n):
    rng = np.random.default_rng(60 + n)
    u = _spd(rng, 3, n)
    v = rng.standard_normal((3, n, 16)).astype(np.float32)
    w = np.concatenate([u, v], axis=2)
    ref_p, ref_b = ref_banded_merge_solve(jnp.asarray(w), 1, ridge=RIDGE, interpret=True)
    p, b = banded_merge_solve_plain(torch.from_numpy(w), 1, ridge=RIDGE)
    acc = _band_sum(w, 1)
    _hold_solve(f"banded_merge_solve Ñ={n}", acc[:, :, :n], acc[:, :, n:], p, b, ref_p, ref_b,
                *jnp_banded_merge_solve(w, 1, RIDGE))


# the pivots' size sets the error of the reference's sweep, whose pivot row
# brings its rounding back times the pivot: a star sum of 64 devices at
# Ñ = 4 after one star merge (pivots of ~4e4) and a star sum of 16 devices
# at the har width (n = 561, Ñ = 128; pivots of ~1e4)
@pytest.mark.parametrize("d,feat,nh,merges", [(64, 24, 4, 1), (16, 561, 128, 0)],
                         ids=["d64_second_star_merge", "har_star_sum"])
def test_plain_solve_is_as_close_to_f64_as_the_library_solve(d, feat, nh, merges):
    from repro_torch.fleet import fleet_merge, fleet_train, init_fleet

    rng = np.random.default_rng(0)
    x0 = rng.uniform(0, 1, (d, 2 * nh, feat)).astype(np.float32)
    fleet = init_fleet(torch.Generator().manual_seed(0), d, feat, nh, x0,
                       activation="identity", ridge=RIDGE, device="cpu")
    fleet = fleet_train(fleet, torch.from_numpy(rng.uniform(0, 1, (d, 16, feat)).astype(np.float32)))
    for _ in range(merges):
        fleet = fleet_merge(fleet, star(d), ridge=RIDGE)
    uv = fleet_to_uv(fleet, ridge=RIDGE)
    u, v = uv.u.sum(0, keepdim=True).numpy(), uv.v.sum(0, keepdim=True).numpy()
    p, b = from_uv_solve_plain(torch.from_numpy(u), torch.from_numpy(v), ridge=RIDGE)
    ref_p, ref_b = ref_from_uv_solve(jnp.asarray(u), jnp.asarray(v), ridge=RIDGE, interpret=True)
    print(f"D={d} Ñ={nh}: mean pivot of the summed U {float(np.diag(u[0]).mean()):.1f}")
    errs = _solve_errors(f"star sum D={d} Ñ={nh}", u, v, RIDGE, port=(p, b),
                         linalg=_linalg_solve(u, v, RIDGE), interpret_kernel=(ref_p, ref_b))
    assert errs["port"] <= 4 * errs["linalg"], errs
    want_p, want_b = jnp_gj_solve(u, v, RIDGE)
    assert np.array_equal(p.numpy(), want_p) and np.array_equal(b.numpy(), want_b)
