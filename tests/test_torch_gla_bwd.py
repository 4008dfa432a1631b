"""The port's GLA backward against the reference's autodiff, on the CPU.

``gla_backward_plain`` (the backward kernels' plain version, which
``GLAForward`` runs on CPU tensors) is held to ``jax.vjp`` of the
reference's ``models/ssm.py::chunked_linear_attention`` at its default
chunk of 128, on the same numpy inputs, with a cotangent for y alone and
with one for the final state too: S inside one chunk (33, 100), on whole
chunks (256) and with a padded tail (300); dk × dv of hymba-1.5b's Mamba
head (16 × 64), 8 × 64, 64 × 65 (past one 64-column strip of the kernels)
and xLSTM's mLSTM (512 × 513, at S 40). Bound: each gradient within 1e-5
of its own largest magnitude (f32 in both, sums in other orders; the
measured spread is up to 2.1e-6, printed with ``-s``).

The decays are drawn as −softplus(N(0, 1))/4, so that within a chunk
e^{cum_t − cum_τ} stays finite above the diagonal: where it overflows
(a chunk's log decays summing past −88) the reference's autodiff of
``where(tril, exp(rel), 0)`` multiplies the discarded branch's inf by 0 and
returns NaN in dlog a, while the port's gate, by select in the backward too,
stays finite; a test below holds the port there to a token-by-token
recurrence in f64.

In bf16 the plain version widens the inputs to f32 and rounds each
gradient once; it is held to the reference's own run on the same bf16
values at twice the reference's spread between that run and its run on
the values cast to f32. ``torch.autograd.gradcheck`` holds the Function in
f64, the plain backward equals torch's autograd of ``gla_forward_plain`` in
f64 within 1e-12, and either cotangent may be None.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import chunked_linear_attention as ref_engine
from repro_torch.kernels.gla_scan import (
    GLAForward,
    _forward_plain,
    gla_backward_plain,
    gla_forward,
    gla_forward_plain,
)

torch.set_num_threads(2)

GRAD_REL = 1e-5
F64_REL = 1e-12

# (B, S, H, dk, dv)
SHAPES = [(2, 33, 2, 16, 64), (2, 100, 2, 8, 64), (2, 256, 2, 16, 64), (2, 300, 2, 16, 64),
          (2, 300, 2, 64, 65), (1, 40, 2, 512, 513)]


def _inputs(seed, b, s, h, dk, dv, scale=0.25):
    """q, k, v, log a, dy and the final state's cotangent, f32."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, dk)).astype(np.float32)
    k = rng.standard_normal((b, s, h, dk)).astype(np.float32)
    v = rng.standard_normal((b, s, h, dv)).astype(np.float32)
    log_a = (-np.log1p(np.exp(rng.standard_normal((b, s, h)))) * scale).astype(np.float32)
    dy = rng.standard_normal((b, s, h, dv)).astype(np.float32)
    dstate = rng.standard_normal((b, h, dk, dv)).astype(np.float32)
    return q, k, v, log_a, dy, dstate


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.detach().float().numpy() - want).max() / np.abs(want).max())


@functools.cache
def _reference(shape):
    """The inputs and jax.vjp's gradients of (q, k, v, log a) against dy
    alone and against dy and the final state's cotangent."""
    x = _inputs(sum(shape), *shape)
    (_, state), vjp = jax.vjp(lambda *a: ref_engine(*a), *x[:4])
    grads = {with_state: vjp((jnp.asarray(x[4]),
                              jnp.asarray(x[5]) if with_state else jnp.zeros_like(state)))
             for with_state in (False, True)}
    return x, grads


def _plain_grads(x, with_state, dtype=torch.float32):
    q, k, v, log_a, dy, dstate = (torch.from_numpy(a) for a in x)
    q, k, v, dy = (t.to(dtype) for t in (q, k, v, dy))
    _, state, states, decay = _forward_plain(q, k, v, log_a)
    return gla_backward_plain(q, k, v, log_a, dy, dstate if with_state else None, states, decay,
                              state)


@pytest.mark.parametrize("with_state", [False, True], ids=["dy", "dy-dstate"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_plain_backward_matches_jax_autodiff_of_the_reference(shape, with_state):
    x, grads = _reference(shape)
    got = _plain_grads(x, with_state)
    want = grads[with_state]
    assert all(g.dtype == torch.float32 and g.shape == w.shape for g, w in zip(got, want))
    rels = [_rel(g, w) for g, w in zip(got, want)]
    print(f"{shape} {'dy, dS' if with_state else 'dy'}: dq, dk, dv, dlog a {rels} "
          f"(bound {GRAD_REL})")
    assert all(r <= GRAD_REL for r in rels), rels


@pytest.mark.parametrize("shape", [(2, 300, 2, 16, 64), (2, 300, 2, 64, 65)],
                         ids=lambda s: "-".join(map(str, s)))
def test_bf16_backward_matches_the_reference_in_bf16(shape):
    """bf16 q, k, v, dy (log a and the state's cotangent f32): the plain
    version's gradients, rounded to bf16, against the reference's on the
    same values, within twice the reference's own spread between its bf16
    run and its f32 run."""
    x = [np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
         for a in _inputs(sum(shape) + 1, *shape)]
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (x[0], x[1], x[2], x[4])]
    (_, _), vjp = jax.vjp(lambda q, k, v, la: ref_engine(q, k, v, la), *bf[:3],
                          jnp.asarray(x[3]))
    ref_bf16 = vjp((bf[3], jnp.asarray(x[5])))
    (_, _), vjp = jax.vjp(lambda *a: ref_engine(*a), *(jnp.asarray(a) for a in x[:4]))
    ref_f32 = vjp((jnp.asarray(x[4]), jnp.asarray(x[5])))
    spread = [_rel(torch.from_numpy(np.asarray(a, np.float32)), b)
              for a, b in zip(ref_bf16, ref_f32)]
    got = _plain_grads(x, True, torch.bfloat16)
    assert [g.dtype for g in got] == [torch.bfloat16] * 3 + [torch.float32]
    rels = [_rel(g, w) for g, w in zip(got, ref_bf16)]
    print(f"{shape} bf16: dq, dk, dv, dlog a against the reference in bf16 {rels}; its own "
          f"bf16-f32 spread {spread} (bound twice that)")
    assert all(r <= 2 * s for r, s in zip(rels, spread)), (rels, spread)


def _recurrence(q, k, v, log_a):
    """(y, final state) token by token, h_t = a_t·h_{t−1} + k_t v_tᵀ."""
    b, s, h, dk = q.shape
    state = torch.zeros((b, h, dk, v.shape[-1]), dtype=q.dtype)
    ys = []
    for t in range(s):
        state = state * torch.exp(log_a[:, t])[..., None, None] + \
            k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", q[:, t], state))
    return torch.stack(ys, 1), state


def test_strong_decay_stays_finite_where_the_reference_autodiff_does_not():
    """log a = −softplus(N(0, 1)): a chunk of 128 tokens sums its decays
    past −88, so e^{cum_t − cum_τ} overflows above the diagonal. jax's
    gradient of the reference then has NaN in dlog a; the port's is finite
    and matches torch autograd of the token recurrence in f64 within
    GRAD_REL."""
    shape = (1, 256, 2, 16, 64)
    x = _inputs(7, *shape, scale=1.0)
    (_, _), vjp = jax.vjp(lambda *a: ref_engine(*a), *x[:4])
    ref = vjp((jnp.asarray(x[4]), jnp.asarray(x[5])))
    assert not np.isfinite(np.asarray(ref[3])).all()
    got = _plain_grads(x, True)
    leaves = [torch.from_numpy(a).double().requires_grad_(True) for a in x[:4]]
    y, state = _recurrence(*leaves)
    dy, ds = (torch.from_numpy(a).double() for a in x[4:])
    want = torch.autograd.grad((y * dy).sum() + (state * ds).sum(), leaves)
    rels = [_rel(g, w.numpy()) for g, w in zip(got, want)]
    print(f"strong decay: dq, dk, dv, dlog a against the f64 recurrence {rels} (bound {GRAD_REL})")
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert all(r <= GRAD_REL for r in rels), rels


def _f64(seed, b, s, h, dk, dv):
    return [torch.from_numpy(a).double() for a in _inputs(seed, b, s, h, dk, dv)]


@pytest.mark.parametrize("shape", [(2, 33, 2, 4, 3), (1, 300, 2, 8, 5), (1, 130, 1, 70, 9)],
                         ids=lambda s: "-".join(map(str, s)))
def test_plain_backward_is_autograd_of_the_plain_forward_in_f64(shape):
    q, k, v, log_a, dy, ds = _f64(sum(shape), *shape)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, log_a)]
    y, state = gla_forward_plain(*leaves)
    assert y.dtype == state.dtype == torch.float64
    want = torch.autograd.grad((y * dy).sum() + (state * ds).sum(), leaves)
    _, state, states, decay = _forward_plain(q, k, v, log_a)
    got = gla_backward_plain(q, k, v, log_a, dy, ds, states, decay, state)
    rels = [_rel(g, w.numpy()) for g, w in zip(got, want)]
    print(f"{shape} f64: dq, dk, dv, dlog a against autograd {rels} (bound {F64_REL})")
    assert all(g.dtype == torch.float64 for g in got)
    assert all(r <= F64_REL for r in rels), rels


@pytest.mark.parametrize("s", [5, 9])
def test_gradcheck_in_f64(s):
    """One chunk (S 5) and, at a chunk cut to 4 by hand, three chunks with
    a padded tail (S 9)."""
    import repro_torch.kernels.gla_scan as gla

    q, k, v, log_a, _, _ = (t.requires_grad_(True) for t in _f64(s, 1, s, 2, 3, 4))
    saved = gla.CHUNK
    gla.CHUNK = 4 if s == 9 else saved
    try:
        assert torch.autograd.gradcheck(lambda *a: GLAForward.apply(*a), (q, k, v, log_a))
    finally:
        gla.CHUNK = saved


def test_either_cotangent_may_be_none():
    """A loss of y alone (the model's: lm_loss never reads the final state)
    and a loss of the final state alone: the Function's gradients equal the
    plain backward's with the other cotangent zero."""
    q, k, v, log_a, dy, ds = _f64(3, 1, 150, 2, 8, 5)
    _, state, states, decay = _forward_plain(q, k, v, log_a)
    zero_dy, zero_ds = torch.zeros_like(dy), torch.zeros_like(ds)
    for use_y, use_state in ((True, False), (False, True)):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v, log_a)]
        y, st = gla_forward(*leaves)
        assert type(y.grad_fn).__name__ == "GLAForwardBackward"
        loss = (y * dy).sum() if use_y else (st * ds).sum()
        got = torch.autograd.grad(loss, leaves)
        want = gla_backward_plain(q, k, v, log_a, dy if use_y else zero_dy,
                                  ds if use_state else zero_ds, states, decay, state)
        for g, w in zip(got, want):
            assert float((g - w).abs().max()) <= F64_REL * float(w.abs().max())


def test_no_gradient_keeps_the_forward_as_it_was():
    """Without a gradient to take there is no Function: y and the state are
    the plain forward's, bit for bit, with no grad_fn."""
    q, k, v, log_a = (torch.from_numpy(a) for a in _inputs(4, 1, 140, 2, 16, 64)[:4])
    y, state = gla_forward(q, k, v, log_a)
    want_y, want_state = gla_forward_plain(q, k, v, log_a)
    assert y.grad_fn is None and torch.equal(y, want_y) and torch.equal(state, want_state)
    with torch.no_grad():
        assert gla_forward(q.requires_grad_(True), k, v, log_a)[0].grad_fn is None
