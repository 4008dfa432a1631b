"""The port's E²LM algebra, cooperative update, autoencoder functions and
detector bank against the reference on the CPU.

Bounds are ``tests/test_torch_core.py``'s for ``to_uv``/``from_uv``: U
and V at rtol 1e-5 / atol 1e-4 (U = P⁻¹ is large where P is small), P and
β at 1e-5, scores at rtol 1e-5 / atol 1e-7. The (U, V) sums and
differences are elementwise f32 adds in both packages and are held bit
for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import (
    UV,
    SLFNParams,
    ae_score,
    ae_train_step,
    ae_train_step_guarded,
    ae_train_stream,
    bank_score,
    bank_train_instance,
    cooperative_update,
    init_oselm,
    make_bank,
    to_uv,
    uv_add,
    uv_replace,
    uv_sub,
    uv_sum,
)
from repro_torch import core as tcore
from repro_torch.convert import oselm_state_from_numpy, uv_from_numpy

torch.set_num_threads(2)

N_IN, N_HID, N_INIT = 13, 7, 21


def _state(seed, activation="identity", shift=0.0):
    rng = np.random.default_rng(seed)
    alpha = rng.uniform(-1, 1, (N_IN, N_HID)).astype(np.float32)
    bias = rng.uniform(-1, 1, N_HID).astype(np.float32)
    x = (rng.uniform(-1, 1, (N_INIT + 9, N_IN)) + shift).astype(np.float32)
    ridge = 5e-2 if activation == "sigmoid" else 1e-3
    ref = init_oselm(SLFNParams(jnp.asarray(alpha), jnp.asarray(bias)), jnp.asarray(x[:N_INIT]),
                     jnp.asarray(x[:N_INIT]), activation=activation, ridge=ridge)
    return ref, x[N_INIT:]


def _port(ref):
    return oselm_state_from_numpy(ref.params.alpha, ref.params.bias, ref.beta, ref.p,
                                  activation=ref.activation, forget=ref.forget, device="cpu")


def _port_uv(uv):
    return uv_from_numpy(uv.u, uv.v, device="cpu")


def _close(got, want, *, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


def _equal(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _uvs(n):
    """n payloads of the reference, each also in port form."""
    refs = [to_uv(_state(10 + i)[0]) for i in range(n)]
    return refs, [_port_uv(r) for r in refs]


def test_uv_algebra_matches_reference_bit_for_bit():
    (a, b, c), (ta, tb, tc) = _uvs(3)
    for got, want in ((tcore.uv_add(ta, tb), uv_add(a, b)),
                      (tcore.uv_sub(ta, tb), uv_sub(a, b)),
                      (tcore.uv_replace(ta, tb, tc), uv_replace(a, b, c))):
        _equal(got.u, want.u)
        _equal(got.v, want.v)
    got, want = tcore.uv_sum([ta, tb, tc]), uv_sum([a, b, c])
    _close(got.u, want.u, atol=1e-4)
    _close(got.v, want.v, atol=1e-4)
    assert ta.nbytes == UV(a.u, a.v).nbytes == 4 * (N_HID * N_HID + N_HID * N_IN)


@pytest.mark.parametrize("n_remote", [1, 3])
@pytest.mark.parametrize("activation", ["identity", "sigmoid"])
def test_cooperative_update_matches_reference(n_remote, activation):
    ref, _ = _state(0, activation)
    remotes, tremotes = _uvs(n_remote)
    want = jax.jit(cooperative_update)(ref, *remotes)
    got = tcore.cooperative_update(_port(ref), *tremotes)
    _close(got.p, want.p)
    _close(got.beta, want.beta)


def test_autoencoder_steps_match_reference():
    ref, xs = _state(1, "sigmoid")
    got = _port(ref)
    r1 = ae_train_step(ref, jnp.asarray(xs[0]))
    g1 = tcore.ae_train_step(got, torch.from_numpy(xs[0]))
    _close(g1.p, r1.p)
    _close(g1.beta, r1.beta)
    rs = ae_train_stream(ref, jnp.asarray(xs))
    gs = tcore.ae_train_stream(got, torch.from_numpy(xs))
    _close(gs.p, rs.p)
    _close(gs.beta, rs.beta)
    _close(tcore.ae_score(gs, torch.from_numpy(xs)), ae_score(rs, jnp.asarray(xs)), atol=1e-7)


def test_guarded_step_rejects_what_the_reference_rejects():
    ref, xs = _state(2)
    ref = ae_train_stream(ref, jnp.asarray(xs))
    got = _port(ref)
    thr = float(ae_score(ref, jnp.asarray(xs)).mean()) * 3.0
    for x in (xs[0], xs[0] + 8.0):
        rs, racc = ae_train_step_guarded(ref, jnp.asarray(x), jnp.float32(thr))
        gs, gacc = tcore.ae_train_step_guarded(got, torch.from_numpy(x), thr)
        assert bool(gacc) == bool(racc)
        _close(gs.p, rs.p)
        _close(gs.beta, rs.beta)
    assert bool(racc) is False


def test_detector_bank_matches_reference():
    """Two instances with their own bases, as the reference's test builds
    them; the bank scores by the minimum and trains one instance."""
    ra, xa = _state(3)
    rb, xb = _state(4, shift=3.0)
    rbank = make_bank([ra, rb])
    tbank = tcore.make_bank([_port(ra), _port(rb)])
    assert tbank.n_instances == rbank.n_instances == 2
    x = np.concatenate([xa, xb])
    _close(tcore.bank_score(tbank, torch.from_numpy(x)), bank_score(rbank, jnp.asarray(x)),
           atol=1e-7)
    rbank = bank_train_instance(rbank, 1, jnp.asarray(xb[0]))
    tbank = tcore.bank_train_instance(tbank, 1, torch.from_numpy(xb[0]))
    for i in range(2):
        want = jax.tree.map(lambda leaf, i=i: leaf[i], rbank.states)
        _close(tbank.states[i].p, want.p)
        _close(tbank.states[i].beta, want.beta)
    assert torch.equal(tbank.states[0].beta, _port(ra).beta)


def test_init_autoencoder_draws_its_basis_and_boots():
    """The port draws the basis from a torch generator (it cannot repeat
    jax.random), so the boot is checked against init_oselm on that basis;
    a model without a bottleneck is refused, as in the reference."""
    x0 = np.random.default_rng(5).uniform(-1, 1, (N_INIT, N_IN)).astype(np.float32)
    got = tcore.init_autoencoder(torch.Generator().manual_seed(3), N_IN, N_HID, x0,
                                 activation="sigmoid", ridge=5e-2, device="cpu")
    params = tcore.init_slfn(torch.Generator().manual_seed(3), N_IN, N_HID, device="cpu")
    basis = SLFNParams(jnp.asarray(params.alpha.numpy()), jnp.asarray(params.bias.numpy()))
    want = init_oselm(basis, jnp.asarray(x0), jnp.asarray(x0), activation="sigmoid", ridge=5e-2)
    _close(got.p, want.p)
    _close(got.beta, want.beta)
    with pytest.raises(ValueError, match="bottleneck"):
        tcore.init_autoencoder(torch.Generator(), N_IN, N_IN, x0, device="cpu")
