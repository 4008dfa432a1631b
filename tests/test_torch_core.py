"""Port vs reference for the core OS-ELM algebra (``repro_torch.core``
against ``repro.core``), on the CPU.

Inputs are made with numpy from a seed and handed to both packages, so
the comparison tests the algebra and not the random streams. Bounds:
1e-5 for the sequential k=1 chain (the reference's own bound for its
chain, ``tests/test_differential.py``) and 1e-5 for the Cholesky solves
of Eq. 13 / Eq. 15. Inputs are centred on 0, which keeps κ(HᵀH + εI)
near 30 (identity) and 300 (sigmoid): two f32 Cholesky implementations
differ by about κ·2⁻²⁴ relative, so the fixture stays inside the bound.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import (
    SLFNParams,
    ae_score,
    from_uv,
    init_oselm,
    oselm_step_k1,
    to_uv,
)
from repro_torch import core as tcore
from repro_torch.convert import oselm_state_from_numpy

torch.set_num_threads(2)

N_IN, N_HID, N_INIT, T_STEPS = 13, 7, 21, 11


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    alpha = rng.uniform(-1, 1, (N_IN, N_HID)).astype(np.float32)
    bias = rng.uniform(-1, 1, N_HID).astype(np.float32)
    x0 = rng.uniform(-1, 1, (N_INIT, N_IN)).astype(np.float32)
    xs = rng.uniform(-1, 1, (T_STEPS, N_IN)).astype(np.float32)
    return alpha, bias, x0, xs


def _port(ref, device="cpu"):
    return oselm_state_from_numpy(
        ref.params.alpha, ref.params.bias, ref.beta, ref.p,
        activation=ref.activation, forget=ref.forget, device=device,
    )


def _close(got, ref, *, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(ref), rtol=rtol, atol=atol)


@pytest.mark.parametrize("activation", ["identity", "sigmoid"])
def test_init_oselm_matches_reference(activation):
    alpha, bias, x0, _ = _inputs()
    ridge = 5e-2 if activation == "sigmoid" else 1e-3
    ref = init_oselm(SLFNParams(jnp.asarray(alpha), jnp.asarray(bias)),
                     jnp.asarray(x0), jnp.asarray(x0), activation=activation, ridge=ridge)
    params = tcore.SLFNParams(torch.from_numpy(alpha), torch.from_numpy(bias))
    x0t = torch.from_numpy(x0)
    got = tcore.init_oselm(params, x0t, x0t, activation=activation, ridge=ridge)
    _close(got.p, ref.p)
    _close(got.beta, ref.beta)


@pytest.mark.parametrize("activation,forget", [
    ("identity", 1.0), ("identity", 0.95), ("sigmoid", 1.0), ("sigmoid", 0.95),
])
def test_oselm_step_k1_chain_matches_reference(activation, forget):
    alpha, bias, x0, xs = _inputs(1)
    ridge = 5e-2 if activation == "sigmoid" else 1e-3
    ref = init_oselm(SLFNParams(jnp.asarray(alpha), jnp.asarray(bias)),
                     jnp.asarray(x0), jnp.asarray(x0), activation=activation,
                     ridge=ridge, forget=forget)
    got = _port(ref)
    for x in xs:
        ref = oselm_step_k1(ref, jnp.asarray(x), jnp.asarray(x))
        xt = torch.from_numpy(x)
        got = tcore.oselm_step_k1(got, xt, xt)
    _close(got.p, ref.p)
    _close(got.beta, ref.beta)


def test_to_uv_from_uv_match_reference():
    alpha, bias, x0, _ = _inputs(2)
    ridge = 1e-3
    ref = init_oselm(SLFNParams(jnp.asarray(alpha), jnp.asarray(bias)),
                     jnp.asarray(x0), jnp.asarray(x0), activation="identity", ridge=ridge)
    got = _port(ref)
    ref_uv = to_uv(ref, ridge=ridge)
    got_uv = tcore.to_uv(got, ridge=ridge)
    _close(got_uv.u, ref_uv.u, rtol=1e-5, atol=1e-4)
    _close(got_uv.v, ref_uv.v, rtol=1e-5, atol=1e-4)
    # the transpose of U equals U bit for bit after re-symmetrising
    assert torch.equal(got_uv.u, got_uv.u.T)
    ref_back = from_uv(ref, ref_uv, ridge=ridge)
    got_back = tcore.from_uv(got, got_uv, ridge=ridge)
    _close(got_back.p, ref_back.p)
    _close(got_back.beta, ref_back.beta)


def test_ae_score_matches_reference():
    alpha, bias, x0, xs = _inputs(3)
    ref = init_oselm(SLFNParams(jnp.asarray(alpha), jnp.asarray(bias)),
                     jnp.asarray(x0), jnp.asarray(x0), activation="sigmoid", ridge=5e-2)
    got = _port(ref)
    _close(tcore.ae_score(got, torch.from_numpy(xs)), ae_score(ref, jnp.asarray(xs)),
           rtol=1e-5, atol=1e-7)


def test_init_slfn_draws_uniform_basis_from_generator():
    """The port's own generator is checked by distribution: U(-1, 1)
    entries, and one seed gives one basis."""
    g = torch.Generator().manual_seed(7)
    p1 = tcore.init_slfn(g, 200, 50, device="cpu")
    p2 = tcore.init_slfn(torch.Generator().manual_seed(7), 200, 50, device="cpu")
    assert torch.equal(p1.alpha, p2.alpha) and torch.equal(p1.bias, p2.bias)
    a = p1.alpha.numpy()
    assert a.min() >= -1 and a.max() <= 1
    assert abs(a.mean()) < 0.02 and abs(a.var() - 1 / 3) < 0.02


def test_init_slfn_raises_without_a_card(monkeypatch):
    """Like every entry point, the basis is drawn for the card unless the
    caller asks for the CPU: with no card, no ``device`` raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcore.init_slfn(torch.Generator().manual_seed(7), 20, 5)
    params = tcore.init_slfn(torch.Generator().manual_seed(7), 20, 5, device="cpu")
    assert params.alpha.device.type == "cpu" and params.alpha.shape == (20, 5)

