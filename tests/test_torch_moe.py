"""The MoE FFN (``repro_torch.models.moe``) against the reference's
``repro.models.moe``, on the CPU.

The reference's own cases (``tests/test_models_extra.py:120-158``: d 32,
8 experts of width 16, top 2, weights and x from ``jax.random``, carried
over as numpy) and more: a padded last group, one token a group row as a
decode step routes it, a capacity that drops tokens, a tie in the
router's probabilities. Each dispatch (``einsum``, the config default, and
``scatter``) is held to the reference's same dispatch and to the other:
y at 1e-5 of its largest magnitude (f32; measured ≤ 2.1e-7), the
load-balance and z losses at 1e-5 relative, ``dropped_frac`` exactly
(the same slots, so the same drops). ``stable_top_k`` keeps the lower
index on a tie, as ``jax.lax.top_k`` does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.moe import moe_ffn as ref_moe_ffn
from repro_torch.models.moe import moe_ffn, stable_top_k

torch.set_num_threads(2)

REL = 1e-5
DISPATCHES = ("einsum", "scatter")


def _moe_params(key, d=32, e=8, f=16):
    ks = jax.random.split(key, 4)
    return {
        "router": jax.random.normal(ks[0], (d, e)) * 0.1,
        "w_gate": jax.random.normal(ks[1], (e, d, f)) * 0.1,
        "w_up": jax.random.normal(ks[2], (e, d, f)) * 0.1,
        "w_down": jax.random.normal(ks[3], (e, f, d)) * 0.1,
    }


def _port(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


def _run(p, x, dispatch, **kw):
    """(port y, port aux, reference y, reference aux) on the same inputs."""
    kw = dict(n_experts=8, top_k=2, tokens_per_group=32) | kw
    y, aux = moe_ffn(_port(p), torch.from_numpy(np.array(x)), dispatch=dispatch, **kw)
    want_y, want_aux = jax.jit(lambda p, x: ref_moe_ffn(p, x, dispatch=dispatch, **kw))(
        p, jnp.asarray(x))
    return y, aux, want_y, want_aux


def _check(y, aux, want_y, want_aux):
    assert y.shape == want_y.shape and y.dtype == torch.float32
    assert _rel(y, want_y) <= REL, _rel(y, want_y)
    for name in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(aux[name]), float(want_aux[name]), rtol=REL)
    assert float(aux["dropped_frac"]) == float(want_aux["dropped_frac"])


CASES = {
    "reference": dict(shape=(2, 64, 32)),
    "padded group": dict(shape=(2, 33, 32)),
    "decode step": dict(shape=(4, 1, 32), tokens_per_group=4),
    "drops": dict(shape=(1, 64, 32), tokens_per_group=64, capacity_factor=0.25),
    "no drops": dict(shape=(1, 64, 32), tokens_per_group=64, capacity_factor=4.0),
    "top 3 of 8": dict(shape=(2, 40, 32), top_k=3, tokens_per_group=16, capacity_factor=0.5),
}


@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_matches_reference(case, dispatch):
    kw = dict(CASES[case])
    x = jax.random.normal(jax.random.PRNGKey(1), kw.pop("shape"))
    _check(*_run(_moe_params(jax.random.PRNGKey(0)), x, dispatch, **kw))


@pytest.mark.parametrize("case", sorted(CASES))
def test_dispatches_agree(case):
    """``tests/test_models_extra.py::test_moe_dispatch_parity`` on the port,
    on every case: the scatter dispatch's y and losses are the einsum's, and
    its share of dropped choices is at least the einsum's share of tokens
    with every choice dropped (the same slots, counted two ways)."""
    kw = dict(CASES[case])
    x = jax.random.normal(jax.random.PRNGKey(1), kw.pop("shape"))
    p = _port(_moe_params(jax.random.PRNGKey(0)))
    kw = dict(n_experts=8, top_k=2, tokens_per_group=32) | kw
    y1, a1 = moe_ffn(p, torch.from_numpy(np.array(x)), dispatch="einsum", **kw)
    y2, a2 = moe_ffn(p, torch.from_numpy(np.array(x)), dispatch="scatter", **kw)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(a1["lb_loss"]), float(a2["lb_loss"]), rtol=1e-5)
    assert float(a2["dropped_frac"]) >= float(a1["dropped_frac"])


def test_moe_capacity_drops_tokens():
    """``tests/test_models_extra.py::test_moe_capacity_drops_tokens``:
    capacity_factor ≪ 1 drops tokens, 4.0 drops none."""
    p = _port(_moe_params(jax.random.PRNGKey(0)))
    x = torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(1), (1, 64, 32))))
    kw = dict(n_experts=8, top_k=2, tokens_per_group=64, dispatch="einsum")
    _, a_small = moe_ffn(p, x, capacity_factor=0.25, **kw)
    _, a_big = moe_ffn(p, x, capacity_factor=4.0, **kw)
    assert float(a_small["dropped_frac"]) > 0.0
    assert float(a_big["dropped_frac"]) == 0.0


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_moe_lb_loss_penalizes_imbalance(dispatch):
    """``tests/test_models_extra.py::test_moe_lb_loss_penalizes_imbalance``,
    with each collapsed run also held to the reference's."""
    p = _moe_params(jax.random.PRNGKey(0))
    p_collapsed = dict(p, router=p["router"] * 0.0 + jnp.eye(32, 8) * 50.0)
    x = jax.random.normal(jax.random.PRNGKey(1), (1, 64, 32))
    kw = dict(tokens_per_group=64)
    _, a_bal, _, _ = _run(p, x, dispatch, **kw)
    run = _run(p_collapsed, x, dispatch, **kw)
    _check(*run)
    assert float(run[1]["lb_loss"]) > float(a_bal["lb_loss"])


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_router_ties_route_as_the_reference(dispatch):
    """A zero router: every probability ties at 1/E, and each token takes the
    lowest experts, as ``jax.lax.top_k`` picks them; experts 0 and 1 fill
    their capacity and the rest of the tokens are dropped."""
    p = dict(_moe_params(jax.random.PRNGKey(0)), router=jnp.zeros((32, 8)))
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 32, 32))
    run = _run(p, x, dispatch)
    _check(*run)
    assert float(run[1]["dropped_frac"]) > 0.5


def test_stable_top_k_is_jax_top_k():
    """Values from a handful of levels, so that most rows hold ties."""
    x = np.random.default_rng(0).integers(0, 4, (64, 12)).astype(np.float32)
    for k in (1, 2, 5, 12):
        want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
        got_v, got_i = stable_top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_unknown_dispatch_raises():
    p = _port(_moe_params(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="dispatch"):
        moe_ffn(p, torch.zeros((1, 4, 32)), n_experts=8, top_k=2, tokens_per_group=4,
                dispatch="dense")
