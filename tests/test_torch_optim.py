"""The port's optimizers against the reference's, on the CPU.

The same numpy trees (a nested dict with an f32 matrix, an f32 vector and a
bf16 matrix, as a model's parameters mix them) and the same gradients go
through ``repro.optim`` and ``repro_torch.optim`` for several steps:
``adam`` with a callable learning rate, with bf16 moments and with weight
decay, ``adamw``, ``sgd`` with and without momentum, and
``clip_by_global_norm`` below and above the norm. Bounds, each leaf at its
own largest magnitude: the f32 leaves at 1e-6 (one f32 rounding of a
different association, where XLA fuses a multiply-add); the bf16 leaves
and bf16 moments at 2^-7, one bf16 step at the largest entry's binade:
torch rounds a bf16 expression after each operation, XLA's CPU fusion
computes it in f32 and rounds once, so an entry may land on the other
neighbour. The gradients are drawn well away from 0,
so Adam's first step, ≈ lr·sign(g), is the same sign in both. The state
carries over from the reference (``convert.opt_state_from_numpy``) and a
port step from it is held to the reference's next step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as ro
from repro_torch import optim as po
from repro_torch.convert import model_params_from_numpy, opt_state_from_numpy

torch.set_num_threads(2)

STEPS = 4
F32_REL = 1e-6
BF16_REL = 2 ** -7


def _trees(seed: int, steps: int = STEPS):
    """(params, [grads a step]) as numpy trees; |g| ≥ 0.1 everywhere."""
    rng = np.random.default_rng(seed)

    def draw(shape, lo=0.0):
        x = rng.standard_normal(shape).astype(np.float32)
        return np.where(np.abs(x) < lo, np.sign(x + 1e-12) * (lo + np.abs(x)), x).astype(np.float32)

    params = {"w": draw((6, 5)), "n": {"b": draw((7,)), "h": draw((4, 3))}}
    grads = [{"w": draw((6, 5), 0.1), "n": {"b": draw((7,), 0.1), "h": draw((4, 3), 0.1)}}
             for _ in range(steps)]
    return params, grads


def _ref_tree(tree):
    """The reference's tree: the 'h' leaf as bf16."""
    return {"w": jnp.asarray(tree["w"]), "n": {"b": jnp.asarray(tree["n"]["b"]),
                                             "h": jnp.asarray(tree["n"]["h"]).astype(jnp.bfloat16)}}


def _port_tree(tree):
    return model_params_from_numpy(jax.tree.map(np.asarray, _ref_tree(tree)), device="cpu")


def _close(got, want, what):
    """Every leaf of a port tree against the reference's at its type's bound."""
    got_leaves = po.tree_leaves(got)
    want_leaves = jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        w = np.asarray(w)
        assert str(g.dtype).split(".")[-1] == w.dtype.name, (what, g.dtype, w.dtype)
        rel = BF16_REL if w.dtype.name == "bfloat16" or g.dtype == torch.bfloat16 else F32_REL
        err = float(np.abs(g.float().numpy() - w.astype(np.float32)).max())
        scale = float(np.abs(w.astype(np.float32)).max())
        assert err <= rel * scale, f"{what}: {err:.3e} > {rel:.1e} · {scale:.3e}"


def _run(ref_opt, port_opt, seed=0):
    params, grads = _trees(seed)
    rp, pp = _ref_tree(params), _port_tree(params)
    rs, ps = ref_opt.init(rp), port_opt.init(pp)
    _close(ps.mu, rs.mu, "init mu") if rs.mu is not None else None
    for i, g in enumerate(grads):
        rp, rs = jax.jit(ref_opt.update)(_ref_tree(g), rs, rp)
        pp, ps = port_opt.update(_port_tree(g), ps, pp)
        _close(pp, rp, f"params after step {i + 1}")
        assert ps.step == int(rs.step) == i + 1
        for name in ("mu", "nu"):
            r, p = getattr(rs, name), getattr(ps, name)
            assert (r is None) == (p is None)
            if r is not None:
                _close(p, r, f"{name} after step {i + 1}")
    return rp, rs, pp, ps


@pytest.mark.parametrize("case", ["lr", "callable_lr", "bf16_moments", "weight_decay", "adamw"])
def test_adam_matches_reference(case):
    ref_kw, port_kw = {}, {}
    lr = 1e-2
    if case == "callable_lr":
        ref_lr, port_lr = (lambda s: 1e-2 / s), (lambda s: 1e-2 / s)
    else:
        ref_lr = port_lr = lr
    if case == "bf16_moments":
        ref_kw["moment_dtype"], port_kw["moment_dtype"] = jnp.bfloat16, torch.bfloat16
    if case == "weight_decay":
        ref_kw["weight_decay"] = port_kw["weight_decay"] = 0.1
    if case == "adamw":
        _run(ro.adamw(lr), po.adamw(lr))
        return
    _run(ro.adam(ref_lr, **ref_kw), po.adam(port_lr, **port_kw))


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_matches_reference(momentum):
    _run(ro.sgd(0.05, momentum), po.sgd(0.05, momentum))


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    _, (g, *_) = _trees(3)
    want = jax.jit(lambda t: ro.clip_by_global_norm(t, max_norm))(_ref_tree(g))
    got = po.clip_by_global_norm(_port_tree(g), max_norm)
    _close(got, want, f"clip at {max_norm}")
    norm = float(po.global_norm(_port_tree(g)))
    if max_norm > norm:  # below the norm: unchanged, bit for bit
        for a, b in zip(po.tree_leaves(got), po.tree_leaves(_port_tree(g))):
            assert torch.equal(a, b)
    else:  # at the norm, but for the bf16 leaf's rounding after the scale
        assert abs(float(po.global_norm(got)) - max_norm) <= BF16_REL / 2 * max_norm


def test_a_step_from_the_reference_state_matches_the_reference():
    params, grads = _trees(5)
    opt_r = ro.adam(1e-2, moment_dtype=jnp.bfloat16)
    rp, rs = _ref_tree(params), None
    rs = opt_r.init(rp)
    for g in grads[:2]:
        rp, rs = opt_r.update(_ref_tree(g), rs, rp)
    ps = opt_state_from_numpy(rs.step, jax.tree.map(np.asarray, rs.mu),
                              jax.tree.map(np.asarray, rs.nu), device="cpu")
    pp = model_params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")
    assert ps.step == 2 and ps.mu["n"]["h"].dtype == torch.bfloat16
    rp, rs = opt_r.update(_ref_tree(grads[2]), rs, rp)
    pp, ps = po.adam(1e-2, moment_dtype=torch.bfloat16).update(_port_tree(grads[2]), ps, pp)
    _close(pp, rp, "a step from the reference's state")
    sgd = opt_state_from_numpy(np.int32(3), None, None, device="cpu")
    assert sgd == po.OptState(step=3, mu=None, nu=None)


def test_bpnn_adam_is_the_plain_f32_update():
    """The BP-NN baselines' update: p − lr·m̂/(√v̂ + ε) in f32, as before."""
    params, grads = _trees(7)
    p = [{"w": torch.from_numpy(params["w"])}]
    opt = po.adam(1e-3)
    st = opt.init(p)
    g = [{"w": torch.from_numpy(grads[0]["w"])}]
    new, st = opt.update(g, st, p)
    m = 0.1 * g[0]["w"]
    v = 0.001 * g[0]["w"] * g[0]["w"]
    bc1, bc2 = float(1 - torch.tensor(0.9) ** 1.0), float(1 - torch.tensor(0.999) ** 1.0)
    want = p[0]["w"] - 1e-3 * (m / bc1) / (torch.sqrt(v / bc2) + 1e-8)
    assert torch.equal(new[0]["w"], want)
