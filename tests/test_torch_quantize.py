"""The port's quantized payloads against the reference on the CPU.

- Codec: ``quantize_pack_plain`` (what the wrapper runs for CPU tensors),
  ``quantize_tiles``, ``dequantize_tiles``, ``quantize_roundtrip`` and
  ``apply_codec`` against the reference's ``quantize_pack`` (Pallas,
  interpret mode), ``quantize_pack_xla`` and its jitted codec, bit for
  bit: codes, scales, published payloads and residuals. The inputs hold
  an all-zero tile, a NaN, tiles across the U | V seam and a ragged last
  tile.
- Byte accounting: ``payload_precision_nbytes``, ``payload_nbytes`` and
  the round cost of every topology at each precision.
- Merge: ``fleet_merge_quantized`` and the one-shot
  ``fleet_merge_masked_kernel(payload_precision=...)`` against the
  reference's kernel form (``kernel=True, interpret=True``) on every
  topology the runtime routes. Both packages compute (U, V) = (P⁻¹, P⁻¹β)
  with their own Cholesky, which differ in the last bits, so the port is
  handed the reference's (U, V): the residual is then bit-equal, and the
  merged (P, β) are held at the reference's own bound for its kernel
  merge against its XLA merge (rtol 1e-4, atol 1e-4,
  ``tests/test_quantize.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fleet import (
    fleet_merge_masked_kernel as ref_fleet_merge_masked_kernel,
    fleet_merge_quantized as ref_fleet_merge_quantized,
    fleet_to_uv as ref_fleet_to_uv,
    fleet_train as ref_fleet_train,
    init_fleet as ref_init_fleet,
    init_residual as ref_init_residual,
)
from repro.fleet import quantize as ref_q
from repro.fleet.comm import payload_nbytes as ref_payload_nbytes
from repro.fleet.comm import topology_round_cost as ref_round_cost
from repro.kernels.quantize_pack import quantize_pack as ref_quantize_pack
from repro.kernels.quantize_pack import quantize_pack_xla as ref_quantize_pack_xla
from repro_torch.convert import oselm_state_from_numpy
from repro_torch.core import UV
from repro_torch.fleet import (
    apply_codec,
    dequantize_tiles,
    fleet_merge_masked_kernel,
    fleet_merge_quantized,
    init_residual,
    payload_precision_nbytes,
    quantize_roundtrip,
    quantize_tiles,
    topology_round_cost,
    validate_precision,
)
from repro_torch.fleet import fleet as port_fleet
from repro_torch.fleet.comm import payload_nbytes
from repro_torch.kernels import quantize_pack, quantize_pack_plain
from test_torch_topology_merge import D_ODD, MASKS, RIDGE, TOPOS

torch.set_num_threads(2)

# (D, Ñ, m): several tiles with a ragged tail and tile 0 across the seam at
# column Ñ; the har width (tile 0 exactly U, last tile 49 columns); one
# partial tile; a single device
SHAPES = [(5, 16, 209), (3, 128, 561), (4, 8, 29), (1, 7, 300)]


def _payload(d, n, m, *, seed=7, residual=True, nan=True):
    """u, v and a residual at U-vs-V magnitudes, device 0 with an all-zero
    first tile and, where there is a second device, one NaN (a diverged
    payload)."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(d, n, n)).astype(np.float32) * 10
    v = rng.normal(size=(d, n, m)).astype(np.float32) * 0.1
    u[0] = 0.0
    v[0, :, : max(0, 128 - n)] = 0.0
    if nan and d > 1:
        v[1, n // 2, m // 2] = np.nan
    r = None
    if residual:
        r = rng.normal(size=(d, n, n + m)).astype(np.float32) * 0.01
        r[0, :, :128] = 0.0
    return u, v, r


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _equal(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------------ codec


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("with_residual", [False, True])
def test_quantize_pack_plain_matches_reference(shape, with_residual):
    u, v, r = _payload(*shape, residual=with_residual)
    got = quantize_pack_plain(_t(u), _t(v), _t(r))
    pallas = ref_quantize_pack(_j(u), _j(v), _j(r), interpret=True)
    xla = ref_quantize_pack_xla(_j(u), _j(v), _j(r))
    for g, p, x in zip(got, pallas, xla):
        _equal(g, p)
        _equal(g, x)
    assert got[0].dtype == torch.int8 and got[1].dtype == torch.float32
    # the CPU wrapper is the plain version
    for g, w in zip(quantize_pack(_t(u), _t(v), _t(r)), got):
        assert torch.equal(g.nan_to_num(), w.nan_to_num())
    assert float(got[1][0, 0]) == 1.0  # the all-zero tile


def test_scale_is_the_product_with_the_rounded_reciprocal():
    """The reference's scale is amax·fl(1/127), not amax/127: XLA rewrites
    the division by a constant. Values picked where the two differ."""
    amax = np.float32(0.3948497474193573)  # amax/127 and amax·fl(1/127) differ
    x = np.zeros((1, 2, 130), np.float32)
    x[0, 0, 0] = amax
    x[0, 1, 129] = -amax
    _, scales = quantize_tiles(_t(x))
    _, want = jax.jit(ref_q.quantize_tiles)(_j(x))
    _equal(scales, want)
    assert float(scales[0, 0]) != float(amax / np.float32(127))


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_tile_codec_matches_reference(shape):
    u, v, r = _payload(*shape)
    x = np.concatenate([u, v], axis=2) + r
    codes, scales = quantize_tiles(_t(x))
    want_codes, want_scales = jax.jit(ref_q.quantize_tiles)(_j(x))
    _equal(codes, want_codes)
    _equal(scales, want_scales)
    _equal(dequantize_tiles(codes, scales), jax.jit(ref_q.dequantize_tiles)(want_codes, want_scales))
    for precision in ("f32", "f16", "int8"):
        got = quantize_roundtrip(_t(x), precision)
        want = jax.jit(lambda a, p=precision: ref_q.quantize_roundtrip(a, p))(_j(x))
        _equal(got, want)


@pytest.mark.parametrize("precision", ["int8", "f16"])
@pytest.mark.parametrize("with_residual", [False, True])
def test_apply_codec_matches_reference(precision, with_residual):
    d, n, m = 6, 16, 209
    u, v, r = _payload(d, n, m, seed=3, residual=with_residual, nan=False)
    w = np.concatenate([u, v], axis=2)
    rng = np.random.default_rng(4)
    fp = rng.random(d) < 0.4
    part = rng.random(d) < 0.7
    part[0] = True
    ref = jax.jit(lambda w, r, fp, pa: ref_q.apply_codec(
        w, precision, residual=r, fp_mask=fp, participate=pa))
    for fp_mask, participate in ((None, None), (fp, None), (None, part), (fp, part)):
        pub, new_r = apply_codec(_t(w), precision, residual=_t(r), fp_mask=_t(fp_mask),
                                 participate=_t(participate))
        want_pub, want_r = ref(_j(w), _j(r), _j(fp_mask), _j(participate))
        _equal(pub, want_pub)
        _equal(new_r, want_r)
    # the kernel route: quantize_pack's outputs injected as the round trip
    if precision == "int8":
        codes, scales, kr = quantize_pack(_t(u), _t(v), _t(r))
        pub, new_r = apply_codec(_t(w), "int8", residual=_t(r), fp_mask=_t(fp),
                                 participate=_t(part), roundtrip=(dequantize_tiles(codes, scales), kr))
        want_pub, want_r = ref(_j(w), _j(r), _j(fp), _j(part))
        _equal(pub, want_pub)
        _equal(new_r, want_r)


def test_f32_codec_is_the_identity_and_unknown_precisions_raise():
    w = torch.randn(2, 3, 7)
    r = torch.randn(2, 3, 7)
    pub, new_r = apply_codec(w, "f32", residual=r)
    assert pub is w and new_r is r
    for bad in ("bf16", "int4"):
        with pytest.raises(ValueError, match="unknown payload precision"):
            validate_precision(bad)
        with pytest.raises(ValueError, match="unknown payload precision"):
            apply_codec(w, bad)


@pytest.mark.parametrize("n_hidden,n_out", [(8, 48), (16, 561), (128, 561), (32, 784)])
def test_payload_bytes_match_reference(n_hidden, n_out):
    for precision in ("f32", "f16", "int8"):
        assert payload_precision_nbytes(n_hidden, n_out, precision) == (
            ref_q.payload_precision_nbytes(n_hidden, n_out, precision))
        assert payload_nbytes(n_hidden, n_out, precision=precision) == (
            ref_payload_nbytes(n_hidden, n_out, precision=precision))
    assert payload_nbytes(n_hidden, n_out, 8) == ref_payload_nbytes(n_hidden, n_out, 8)
    if (n_hidden, n_out) == (128, 561):   # the har width: 3.999× fewer bytes
        assert payload_precision_nbytes(128, 561, "f32") == 352_768
        assert payload_precision_nbytes(128, 561, "int8") == 88_216


@pytest.mark.parametrize("topo_name", sorted(TOPOS))
def test_round_cost_by_precision_matches_reference(topo_name):
    port_fn, ref_fn = TOPOS[topo_name]
    for precision in ("f32", "f16", "int8"):
        a = topology_round_cost(port_fn(D_ODD), 128, 561, precision=precision)
        b = ref_round_cost(ref_fn(D_ODD), 128, 561, precision=precision)
        assert (a.topology, a.payloads, a.bytes_total, a.precision) == (
            b.topology, b.payloads, b.bytes_total, b.precision)


def test_governor_prices_mixed_rounds_as_reference():
    from repro.runtime.governor import GovernorConfig as RefConfig, MergeGovernor as RefGov
    from repro_torch.runtime import GovernorConfig, MergeGovernor

    port_fn, ref_fn = TOPOS["ring1"]
    rng = np.random.default_rng(5)
    for precision in ("f32", "f16", "int8"):
        got = MergeGovernor(port_fn(D_ODD), 128, 561, GovernorConfig(merge_every=2),
                            payload_precision=precision)
        want = RefGov(ref_fn(D_ODD), 128, 561, RefConfig(merge_every=2),
                      payload_precision=precision)
        for t in range(12):
            mask = rng.random(D_ODD) < 0.8
            fp = None if t % 3 == 0 else rng.random(D_ODD) < 0.3
            a, b = got.decide(t, mask, fp), want.decide(t, mask, fp)
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
            assert got.round_bytes_by_precision(a.participants, a.fp_participants) == (
                want.round_bytes_by_precision(b.participants, b.fp_participants))
        assert dataclasses.asdict(got.state) == dataclasses.asdict(want.state)


# ------------------------------------------------------------------ merge


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


@pytest.fixture
def reference_uv(trained_fleet, monkeypatch):
    """The port's merges take the reference's (U, V) of the fleet."""
    uv = jax.jit(lambda s: ref_fleet_to_uv(s, ridge=RIDGE))(trained_fleet)
    ref_uv = UV(u=_t(np.asarray(uv.u)), v=_t(np.asarray(uv.v)))
    monkeypatch.setattr(port_fleet, "fleet_to_uv", lambda states, ridge: ref_uv)


def _close(got, want):
    np.testing.assert_allclose(got.p.numpy(), np.asarray(want.p), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.beta.numpy(), np.asarray(want.beta), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("precision", ["int8", "f16"])
@pytest.mark.parametrize("topo_name", sorted(TOPOS))
def test_fleet_merge_quantized_matches_reference(trained_fleet, reference_uv, topo_name,
                                                 precision):
    port_fn, ref_fn = TOPOS[topo_name]
    rng = np.random.default_rng(6)
    mask = MASKS["random"]
    fp = rng.random(D_ODD) < 0.3
    resid = np.asarray(ref_init_residual(trained_fleet))
    resid = resid + rng.normal(size=resid.shape).astype(np.float32) * 1e-3
    fleet = _port(trained_fleet)
    for r in (None, resid):
        want, want_r = ref_fleet_merge_quantized(
            trained_fleet, ref_fn(D_ODD), residual=_j(r), payload_precision=precision,
            ridge=RIDGE, mask=jnp.asarray(mask), fp_mask=jnp.asarray(fp), kernel=True,
            interpret=True,
        )
        got, got_r = fleet_merge_quantized(
            fleet, port_fn(D_ODD), residual=_t(r), payload_precision=precision, ridge=RIDGE,
            mask=torch.from_numpy(mask), fp_mask=torch.from_numpy(fp),
        )
        _equal(got_r, want_r)
        _close(got, want)
        out = mask == 0
        assert torch.equal(got.p[out], fleet.p[out]) and torch.equal(got.beta[out], fleet.beta[out])
    assert init_residual(fleet).shape == resid.shape and not init_residual(fleet).any()


@pytest.mark.parametrize("precision", ["f32", "f16", "int8"])
@pytest.mark.parametrize("topo_name", sorted(TOPOS))
def test_one_shot_codec_merge_matches_reference(trained_fleet, reference_uv, topo_name,
                                                precision):
    port_fn, ref_fn = TOPOS[topo_name]
    mask = MASKS["cluster1_out"]
    want = ref_fleet_merge_masked_kernel(trained_fleet, ref_fn(D_ODD), jnp.asarray(mask),
                                         ridge=RIDGE, payload_precision=precision)
    got = fleet_merge_masked_kernel(_port(trained_fleet), port_fn(D_ODD),
                                    torch.from_numpy(mask), ridge=RIDGE,
                                    payload_precision=precision)
    _close(got, want)


def test_all_risk_round_is_the_exact_merge(trained_fleet):
    """Every device at quarantine risk ships f32: the quantized round is
    the exact masked merge bit for bit, and the residual stays zero."""
    fleet = _port(trained_fleet)
    topo = TOPOS["ring1"][0](D_ODD)
    ones = torch.ones(D_ODD)
    exact = fleet_merge_masked_kernel(fleet, topo, ones, ridge=RIDGE)
    merged, r = fleet_merge_quantized(fleet, topo, residual=init_residual(fleet), ridge=RIDGE,
                                      mask=ones, fp_mask=torch.ones(D_ODD, dtype=torch.bool))
    assert torch.equal(merged.beta, exact.beta) and torch.equal(merged.p, exact.p)
    assert not r.any()
