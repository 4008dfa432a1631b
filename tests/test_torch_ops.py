"""The port's paper-level OS-ELM ops against the reference on the CPU:
the k=1 step in the kernel path's order (``oselm_step_k1``, which on the
CPU runs ``oselm_step_k1_plain``), the E²LM batch statistics
(``uv_from_batch_kernel``, ``uv_from_state_kernel``), the k > 1 step, the
batched Eq. 13 boot and ``oselm_train_sequential``.

Bounds: 1e-5 for the chains and solves on ``tests/test_torch_core.py``'s
fixture (13 features, Ñ = 7, 11 steps; the reference's own bound for its
chain, ``tests/test_differential.py``). At the har width (n = 561,
Ñ = 128, 256 steps from a har device, κ(P) ~ 2e7) RLS parity in f32 is
far looser: ``test_k1_chain_at_har_width_stays_within_the_references_own_spread``
measures the spread and prints it; ``chip_smoke.py`` holds the card's
chain against the CPU's at the bound that test sets.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SLFNParams, init_oselm, oselm_step, oselm_step_k1
from repro.core import oselm_train_sequential as ref_train_sequential
from repro.core.oselm import OSELMState as RefState
from repro.kernels import oselm_step_k1_kernel as ref_step_kernel
from repro.kernels import uv_from_state_kernel as ref_uv_from_state
from repro.kernels.rank1_add import rank1_add as ref_rank1_add
from repro.kernels.ops import uv_from_batch_kernel as ref_uv_from_batch
from repro_torch import core as tcore
from repro_torch.convert import oselm_state_from_numpy
from repro_torch.kernels import (
    k1_update,
    k1_update_plain,
    oselm_step_k1_kernel,
    oselm_step_k1_plain,
    uv_from_batch_kernel,
    uv_from_state_kernel,
)
from repro_torch.kernels.rank1_add import lane_sum

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchmarks.torch_common import edge_config, normalized_dataset, train_edge_device  # noqa: E402
from repro_torch.data import make_pattern_stream, train_test_split  # noqa: E402

torch.set_num_threads(2)

N_IN, N_HID, N_INIT, T_STEPS = 13, 7, 21, 11
CASES = [("identity", 1.0), ("identity", 0.95), ("sigmoid", 1.0), ("sigmoid", 0.95)]


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    alpha = rng.uniform(-1, 1, (N_IN, N_HID)).astype(np.float32)
    bias = rng.uniform(-1, 1, N_HID).astype(np.float32)
    x0 = rng.uniform(-1, 1, (N_INIT, N_IN)).astype(np.float32)
    xs = rng.uniform(-1, 1, (T_STEPS, N_IN)).astype(np.float32)
    return alpha, bias, x0, xs


def _ref_state(activation, forget, seed=1):
    alpha, bias, x0, xs = _inputs(seed)
    ridge = 5e-2 if activation == "sigmoid" else 1e-3
    ref = init_oselm(SLFNParams(jnp.asarray(alpha), jnp.asarray(bias)), jnp.asarray(x0),
                     jnp.asarray(x0), activation=activation, ridge=ridge, forget=forget)
    return ref, xs


def _port(ref):
    return oselm_state_from_numpy(ref.params.alpha, ref.params.bias, ref.beta, ref.p,
                                  activation=ref.activation, forget=ref.forget, device="cpu")


def _close(got, want, *, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("activation,forget", CASES)
def test_k1_chain_in_kernel_order_matches_reference_kernel(activation, forget):
    """The plain composition and ``oselm_step_k1`` on the CPU, against the
    reference's ``oselm_step_k1_kernel`` (Pallas in interpret mode), step
    by step over the chain."""
    ref, xs = _ref_state(activation, forget)
    got = _port(ref)
    step = jax.jit(lambda s, x: ref_step_kernel(s, x, x, interpret=True))
    for x in xs:
        ref = step(ref, jnp.asarray(x))
        xt = torch.from_numpy(x)
        plain = oselm_step_k1_plain(got, xt, xt)
        wrapped = oselm_step_k1_kernel(got, xt, xt)  # CPU tensors: the plain versions
        got = tcore.oselm_step_k1(got, xt, xt)
        for other in (plain, wrapped):
            assert torch.equal(got.p, other.p) and torch.equal(got.beta, other.beta)
        _close(got.p, ref.p)
        _close(got.beta, ref.beta)


@pytest.mark.parametrize("n", [1, 10, 37, 128, 129])
def test_lane_sum_is_the_warp_order(n):
    """``lane_sum`` adds in the k=1 kernel's order: lane l sums rows l,
    l + 32, ... from zero (zeros up to a multiple of 32), then each
    xor-butterfly step adds lane l ^ off; every bit equal to that order
    emulated lane by lane in f32."""
    x = np.random.default_rng(n).standard_normal((n, 3)).astype(np.float32)
    lanes = np.zeros((32, 3), np.float32)
    for lane in range(32):
        for i in range(lane, -(-n // 32) * 32, 32):
            lanes[lane] = lanes[lane] + (x[i] if i < n else np.float32(0))
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[np.arange(32) ^ off]
    assert np.array_equal(lane_sum(torch.from_numpy(x)).numpy(), lanes[0])


@pytest.mark.parametrize("activation,forget", CASES)
def test_k1_update_is_the_reference_steps_tail(activation, forget):
    """The k=1 step's tail in one call: from the reference's own P/λ, h
    and ph, (P', β') against the reference's glue (1 + h·ph, t − h·β, the
    two reciprocals) and its two rank1_add kernels in interpret mode, at
    1e-5; the CPU wrapper is the plain version, bit for bit."""
    ref, xs = _ref_state(activation, forget, seed=8)
    x = jnp.asarray(xs[0])
    from repro.kernels import hidden_proj as ref_hidden_proj
    from repro.kernels import matmul_atb as ref_matmul_atb

    h = ref_hidden_proj(x[None, :], ref.params.alpha, ref.params.bias,
                        activation=ref.activation, interpret=True)[0]
    p = ref.p / ref.forget
    ph = ref_matmul_atb(h[:, None], p, interpret=True)[0]
    denom = 1.0 + h @ ph
    want_p = ref_rank1_add(p, ph, ph, -1.0 / denom, interpret=True)
    want_b = ref_rank1_add(ref.beta, ph, x - h @ ref.beta, 1.0 / denom, interpret=True)
    args = [torch.from_numpy(np.array(a)) for a in (p, ref.beta, h, ph, x)]
    got_p, got_b = k1_update_plain(*args)
    _close(got_p, want_p)
    _close(got_b, want_b)
    again = k1_update(*args)
    assert torch.equal(again[0], got_p) and torch.equal(again[1], got_b)
    with pytest.raises(ValueError, match="k1_update"):
        k1_update_plain(args[0], args[1], args[2], args[3], args[4][:-1])


@pytest.mark.parametrize("activation,forget", CASES)
def test_train_sequential_matches_both_reference_routes(activation, forget):
    """The port streams through the fused ingest (plain version on the
    CPU); the reference's XLA scan of k=1 steps and its ingest kernel
    (interpret mode) both agree with it at 1e-5."""
    ref, xs = _ref_state(activation, forget, seed=2)
    got = tcore.oselm_train_sequential(_port(ref), torch.from_numpy(xs), torch.from_numpy(xs))
    for kernel in (False, True):
        want = ref_train_sequential(ref, jnp.asarray(xs), jnp.asarray(xs), kernel=kernel,
                                    interpret=True if kernel else None)
        _close(got.p, want.p)
        _close(got.beta, want.beta)


@pytest.mark.parametrize("activation", ["identity", "sigmoid"])
def test_uv_from_batch_matches_reference(activation):
    alpha, bias, x0, xs = _inputs(3)
    t = np.random.default_rng(4).uniform(-1, 1, (N_INIT, 5)).astype(np.float32)
    u, v = uv_from_batch_kernel(torch.from_numpy(alpha), torch.from_numpy(bias),
                                torch.from_numpy(x0), torch.from_numpy(t), activation=activation)
    ru, rv = ref_uv_from_batch(jnp.asarray(alpha), jnp.asarray(bias), jnp.asarray(x0),
                               jnp.asarray(t), activation=activation, interpret=True)
    _close(u, ru)
    _close(v, rv)
    ref, _ = _ref_state(activation, 1.0, seed=3)
    u, v = uv_from_state_kernel(_port(ref), torch.from_numpy(xs))
    ru, rv = ref_uv_from_state(ref, jnp.asarray(xs), interpret=True)
    _close(u, ru)
    _close(v, rv)


def test_batched_boot_matches_reference_per_device():
    """Eq. 13 for three devices at once (a fleet's boot): U₀ and V₀ come
    from one batched matmul_atb each, and every device equals the
    reference's own init."""
    alpha, bias, _, _ = _inputs(5)
    x0 = np.random.default_rng(6).uniform(-1, 1, (3, N_INIT, N_IN)).astype(np.float32)
    params = tcore.SLFNParams(torch.from_numpy(alpha), torch.from_numpy(bias))
    got = tcore.init_oselm(params, torch.from_numpy(x0), torch.from_numpy(x0),
                           activation="identity", ridge=1e-3)
    for d in range(3):
        ref = init_oselm(SLFNParams(jnp.asarray(alpha), jnp.asarray(bias)), jnp.asarray(x0[d]),
                         jnp.asarray(x0[d]), activation="identity", ridge=1e-3)
        _close(got.p[d], ref.p)
        _close(got.beta[d], ref.beta)


@pytest.mark.parametrize("activation,forget", CASES)
def test_k_step_matches_reference(activation, forget):
    """Eq. 12 with a batch of k = 4 samples (the k×k inverse)."""
    ref, xs = _ref_state(activation, forget, seed=7)
    got = _port(ref)
    for chunk in (xs[:4], xs[4:8]):
        ref = oselm_step(ref, jnp.asarray(chunk), jnp.asarray(chunk))
        got = tcore.oselm_step(got, torch.from_numpy(chunk), torch.from_numpy(chunk))
    _close(got.p, ref.p)
    _close(got.beta, ref.beta)


def test_k1_chain_at_har_width_stays_within_the_references_own_spread():
    """256 k=1 steps of the laying stream on a device trained on walking
    (the har edge config: n = m = 561, Ñ = 128, identity, the boot's ridge
    1e-2), from one state in both packages. The port's chain (kernel
    order) is held to the reference's kernel path; the bound is the
    reference's own spread between its kernel path and its XLA path on the
    same chain, which at κ(P) ~ 2e7 is far above 1e-5."""
    ds = normalized_dataset("har")
    train, _ = train_test_split(ds, 0.8, seed=0)
    dev = train_edge_device(train, "walking", key=0, ecfg=edge_config("har"), seed=1,
                            device="cpu")
    xs = np.concatenate([make_pattern_stream(train, "laying", seed=2)] * 2)[:256]
    ref0 = RefState(params=SLFNParams(jnp.asarray(dev.params.alpha.numpy()),
                                      jnp.asarray(dev.params.bias.numpy())),
                    beta=jnp.asarray(dev.beta.numpy()), p=jnp.asarray(dev.p.numpy()),
                    activation="identity", forget=1.0)
    got = dev
    for x in xs:
        xt = torch.from_numpy(x)
        got = tcore.oselm_step_k1(got, xt, xt)
    kstep = jax.jit(lambda s, x: ref_step_kernel(s, x, x, interpret=True))
    xstep = jax.jit(lambda s, x: oselm_step_k1(s, x, x))
    rk = rx = ref0
    for x in xs:
        rk, rx = kstep(rk, jnp.asarray(x)), xstep(rx, jnp.asarray(x))
    spread = {"P": _rel(rk.p, rx.p), "beta": _rel(rk.beta, rx.beta)}
    port = {"P": _rel(got.p, rk.p), "beta": _rel(got.beta, rk.beta)}
    print(f"har-width k=1 chain, 256 steps, max|diff|/max|ref|: port vs reference kernel"
          f" {port}; reference kernel vs reference XLA {spread} (the bound)")
    for k in port:
        assert port[k] <= spread[k], (k, port, spread)
