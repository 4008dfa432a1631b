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

In bf16 the plain version rounds where the reference's autodiff does (the
scores, P, dP, dS, each gradient's intra and inter terms, and their sum)
and splits the f32 operand of each state product into hi and lo, as the
tensor-core kernels do: on operands on a grid of eighths, where every sum
is exact in f32, it equals a numpy rendering of exactly those roundings,
and misses the renderings with one of them left out by far more. It is
held to the reference's own run on the same bf16 values at twice the
reference's spread between that run and its run on the values cast to f32.
``torch.autograd.gradcheck`` holds the Function in f64, the plain backward
equals torch's autograd of ``gla_forward_plain`` in f64 within 1e-12, and
either cotangent may be None.
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
    _bwd_plain,
    bwd_plan,
    _forward_plain,
    gla_backward_plain,
    gla_forward,
    gla_forward_plain,
)

torch.set_num_threads(2)

GRAD_REL = 1e-5
F64_REL = 1e-12
BF16_REL = 1e-6  # the grid's sums are exact in f32: only the orders' last bits could differ

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
          f"bf16-f32 spread {spread} (bound twice that); ratios "
          f"{[round(r / s, 3) for r, s in zip(rels, spread)]}")
    assert all(r <= 2 * s for r, s in zip(rels, spread)), (rels, spread)


def _bf16_np(x):
    """x (each value exact in f32) rounded to the nearest bf16, ties to even."""
    b = np.asarray(x, np.float64).astype(np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) >> 16 << 16
    return b.astype(np.uint32).view(np.float32).astype(np.float64)


def _render_bf16(q, k, v, dy, ds, *, scores=True, dp=True, intra=True, inter=True, split=True):
    """numpy's dq, dk and dv before their final rounding, log a = 0 (every
    gate and decay 1, so P = bf16(bf16(scores)·1) is one rounding of the
    scores, dS one of dP), chunks of 128: the scores and dP rounded as they
    leave their sums, each gradient's intra and inter terms rounded apart and
    added, the states S_in and G_c taken as hi + lo (``split``) or rounded
    once to bf16; each switch off leaves its rounding out."""
    def rnd(x, on):
        return _bf16_np(x) if on else x

    def state(x):
        hi = _bf16_np(x)
        return hi + _bf16_np(x - hi) if split else hi

    b, s, h, dk = q.shape
    out = [np.zeros(q.shape), np.zeros(k.shape), np.zeros(v.shape)]
    bounds = [(t0, min(t0 + 128, s)) for t0 in range(0, s, 128)]
    for bi in range(b):
        for hh in range(h):
            Q, K, V, Y = (x[bi, :, hh].astype(np.float64) for x in (q, k, v, dy))
            st, s_in = np.zeros((dk, v.shape[-1])), []
            for t0, t1 in bounds:
                s_in.append(st)
                st = st + K[t0:t1].T @ V[t0:t1]
            g, gs = ds[bi, hh].astype(np.float64), [None] * len(bounds)
            for n in reversed(range(len(bounds))):
                gs[n] = g
                g = g + Q[bounds[n][0]:bounds[n][1]].T @ Y[bounds[n][0]:bounds[n][1]]
            for n, (t0, t1) in enumerate(bounds):
                Qc, Kc, Vc, Yc = Q[t0:t1], K[t0:t1], V[t0:t1], Y[t0:t1]
                tri = np.tril(np.ones((t1 - t0, t1 - t0)))
                p = rnd(Qc @ Kc.T, scores) * tri
                dS = rnd(Yc @ Vc.T, dp) * tri
                sx, gx = state(s_in[n]), state(gs[n])
                out[0][bi, t0:t1, hh] = rnd(Yc @ sx.T, inter) + rnd(dS @ Kc, intra)
                out[1][bi, t0:t1, hh] = rnd(dS.T @ Qc, intra) + rnd(Vc @ gx.T, inter)
                out[2][bi, t0:t1, hh] = rnd(p.T @ Yc, intra) + rnd(Kc @ gx, inter)
    return out


@pytest.mark.parametrize("shape", [(1, 200, 2, 16, 64), (1, 200, 2, 24, 40)],
                         ids=lambda s: "-".join(map(str, s)))
def test_bf16_plain_backward_rounds_at_the_reference_points(shape):
    """q, k, v, dy and the final state's cotangent on a grid of eighths in
    [-1, 1] and log a = 0, so that every sum of the backward is exact in f32
    whatever its order: the plain version's dq, dk and dv before their own
    rounding to bf16 equal the rendering with every bf16 point within
    BF16_REL of each one's largest magnitude, and miss the renderings with
    the scores', dP's, the intra terms' or the inter terms' rounding left
    out, or the states rounded once in place of hi and lo, by more than 100
    times that."""
    b, s, h, dk, dv = shape
    rng = np.random.default_rng(sum(shape))
    q, k = (rng.integers(-8, 9, (b, s, h, dk)).astype(np.float32) / 8 for _ in range(2))
    v, dy = (rng.integers(-8, 9, (b, s, h, dv)).astype(np.float32) / 8 for _ in range(2))
    ds = rng.integers(-8, 9, (b, h, dk, dv)).astype(np.float32) / 8
    t = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, dy)]
    log_a = torch.zeros((b, s, h))
    _, state, states, decay = _forward_plain(*t[:3], log_a)
    got = _bwd_plain(*t[:3], log_a, t[3], torch.from_numpy(ds), states, decay, state)
    assert all(g.dtype == torch.float32 for g in got)
    rounded = gla_backward_plain(*t[:3], log_a, t[3], torch.from_numpy(ds), states, decay, state)
    assert all(torch.equal(r, g.to(r.dtype)) for r, g in zip(rounded, got))

    def rels(**off):
        return [_rel(g, w) for g, w in zip(got, _render_bf16(q, k, v, dy, ds, **off))]

    every = rels()
    missing = {name: max(rels(**{name: False})) for name in
               ("scores", "dp", "intra", "inter", "split")}
    print(f"{shape}: dq, dk, dv against the rendering with every bf16 point {every} (bound "
          f"{BF16_REL}); with one left out {missing}")
    assert all(r <= BF16_REL for r in every), every
    assert all(r > 100 * BF16_REL for r in missing.values()), missing
    # one operand in f32: no rounding and no split (the f32 route)
    mixed = _bwd_plain(*t[:3], log_a, t[3].float(), torch.from_numpy(ds), states, decay, state)
    unrounded = _render_bf16(q, k, v, dy, ds, scores=False, dp=False, intra=False, inter=False)
    assert all(_rel(g, w) <= BF16_REL for g, w in zip(mixed, unrounded))


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


def test_bwd_plan_takes_the_sweeps_plans():
    """The bf16 chunk pass's plan on a card of 132 SMs: hymba-1.5b's 16 × 64
    over 400 chunks (B 4, S 512, H 25) and S 200's 30 split, the mLSTM's
    512 × 513 over 16 (B 2, S 256, H 4) paired, as the forced sweep on an
    H100 ranked them; every width takes an instance the kernel has (16 or
    32 × 32 or 64) and pairs only where that fits one wave of two blocks an
    SM and splitting does not."""
    assert bwd_plan(16, 64, 400, 132) == (16, 64, False)
    assert bwd_plan(16, 64, 30, 132) == (16, 64, False)
    assert bwd_plan(512, 513, 16, 132) == (32, 64, True)
    for dk in (1, 8, 16, 17, 24, 64, 512):
        for dv in (1, 32, 33, 40, 65, 513):
            for chunks in (1, 16, 400):
                wk, wv, paired = bwd_plan(dk, dv, chunks, 132)
                assert wk in (16, 32) and wv in (32, 64)
                na, nb = -(-(-(-dk // 8) * 8) // wk), -(-(-(-dv // 8) * 8) // wv)
                assert paired == (chunks * (na + nb) > 264 >= chunks * max(na, nb))
