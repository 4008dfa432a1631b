"""The two-device evaluations behind the paper's Figs. 6–17 on the port
(``pair_merge_eval``, ``pattern_loss_rows``) against the reference's, on
a small ``har`` dataset on the CPU, and the port's ``train_edge_device``
against the reference's steps on the same basis.

Bounds: AUCs within 1e-3 (a one-shot Cholesky merge in each framework);
the per-pattern losses of the unmerged devices at rtol 1e-5. The merged
model's losses are held to an f64 merge of the same two devices instead:
the merge solves with U = P_A⁻¹ + P_B⁻¹ at κ(U) ~ 1.7e5 and no ridge, so
both f32 merges stray from the f64 one by up to 7e-4 relative and from
each other by up to 1e-3; the port's largest relative distance from the
f64 merge is held at twice the reference's own (measured 3.1e-4 against
6.9e-4, printed). A trained device is held by its scores, to an exact
solution in the same way (its P and β are ill-posed in f32, see the
test).
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.oselm_edge import EdgeConfig as RefEdgeConfig
from repro.core import SLFNParams, ae_train_stream, init_oselm
from repro.core import ae_score as ref_ae_score
from repro.scenarios.evaluate import pair_merge_eval as ref_pair_merge_eval
from repro.scenarios.evaluate import pattern_loss_rows as ref_pattern_loss_rows
from repro_torch.configs import EdgeConfig
from repro_torch.convert import oselm_state_from_numpy
from repro_torch.core import ae_score, init_slfn
from repro_torch.data import make_pattern_stream, train_test_split
from repro_torch.scenarios import pair_merge_eval, pattern_loss_rows

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from benchmarks.common import train_edge_device as ref_train_edge_device  # noqa: E402
from benchmarks.torch_common import normalized_dataset, train_edge_device  # noqa: E402

torch.set_num_threads(2)

N_HID = 32
ECFG = EdgeConfig("har", 561, N_HID, "identity")


def _split():
    ds = normalized_dataset("har", samples_per_class=60)
    return train_test_split(ds, 0.8, seed=0)


def _port(ref):
    return oselm_state_from_numpy(ref.params.alpha, ref.params.bias, ref.beta, ref.p,
                                  activation=ref.activation, forget=ref.forget, device="cpu")


@pytest.fixture(scope="module")
def pair():
    """Device-A on laying and Device-B on walking, trained by the
    reference on one basis, and the same two devices in the port."""
    train, test = _split()
    key = jax.random.PRNGKey(0)
    ecfg = RefEdgeConfig(*ECFG.__dict__.values())
    a = ref_train_edge_device(train, "laying", key=key, ecfg=ecfg, seed=0)
    b = ref_train_edge_device(train, "walking", key=key, ecfg=ecfg, seed=1)
    return test, (a, b), (_port(a), _port(b))


def test_pair_merge_eval_matches_reference(pair):
    test, (ra, rb), (ta, tb) = pair
    patterns = (test.class_names.index("laying"), test.class_names.index("walking"))
    want = ref_pair_merge_eval(ra, rb, test, patterns)
    got = pair_merge_eval(ta, tb, test, patterns)
    print(f"pair_merge_eval AUC before/after: port {got}, reference {want}")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    assert got[1] > got[0]  # the merge teaches A the walking pattern


def _f64_merged_losses(a, b, test, limit):
    """pattern_loss_rows' A_after column for a cooperative update taken in
    f64 from the reference's two f32 states."""
    def uv(s):
        u = np.linalg.inv(np.asarray(s.p, np.float64))
        u = 0.5 * (u + u.T)
        return u, u @ np.asarray(s.beta, np.float64)
    (ua, va), (ub, vb) = uv(a), uv(b)
    beta = np.linalg.solve(ua + ub, va + vb)
    alpha, bias = np.asarray(a.params.alpha, np.float64), np.asarray(a.params.bias, np.float64)
    out = {}
    for pat in test.class_names:
        x = test.pattern(pat)[:limit].astype(np.float64)
        out[pat] = float(np.mean((x - (x @ alpha + bias) @ beta) ** 2))
    return out


def test_pattern_loss_rows_match_reference(pair):
    test, (ra, rb), (ta, tb) = pair
    want = ref_pattern_loss_rows(ra, rb, test, limit=32)
    got = pattern_loss_rows(ta, tb, test, limit=32)
    assert list(got) == list(want) == list(test.class_names)
    for pat, row in got.items():
        for col in ("A_before", "B"):
            np.testing.assert_allclose(row[col], want[pat][col], rtol=1e-5, err_msg=f"{pat} {col}")
    exact = _f64_merged_losses(ra, rb, test, 32)
    port = max(abs(got[p]["A_after"] - exact[p]) / exact[p] for p in exact)
    ref = max(abs(want[p]["A_after"] - exact[p]) / exact[p] for p in exact)
    print(f"A_after, largest relative distance from the f64 merge: port {port:.3e},"
          f" reference {ref:.3e} (bound: twice the reference's)")
    assert port <= 2 * ref
    assert got["walking"]["A_after"] < got["walking"]["A_before"] / 5


def test_train_edge_device_matches_reference_steps():
    """The port's boot (n_init rows, the raised ridge of a short boot) and
    stream, against the reference's init_oselm and ae_train_stream on the
    port's basis, compared by the device's scores on held-out samples of
    every pattern. The boot's U₀ + εI has κ ~ 1e6 (the har features are
    not centred), so each framework's f32 chain strays from the exact
    ridge solution (f64, on all the device's rows, which the RLS chain
    equals in exact arithmetic) by several 1e-3 in the scores; the port's
    largest relative distance from it is held at twice the reference's own
    (measured 3.9e-3 against 6.7e-3, printed)."""
    train, test = _split()
    got = train_edge_device(train, "laying", key=3, ecfg=ECFG, seed=0, device="cpu")
    params = init_slfn(torch.Generator().manual_seed(3), 561, N_HID, device="cpu")
    xs = make_pattern_stream(train, "laying", seed=0)
    n_init = min(max(2 * N_HID, 8), max(len(xs) - 8, len(xs) // 2))
    ridge = 1e-2 if n_init < 2 * N_HID else ECFG.ridge
    basis = SLFNParams(jnp.asarray(params.alpha.numpy()), jnp.asarray(params.bias.numpy()))
    ref = init_oselm(basis, jnp.asarray(xs[:n_init]), jnp.asarray(xs[:n_init]),
                     activation="identity", ridge=ridge)
    ref = ae_train_stream(ref, jnp.asarray(xs[n_init:]))
    alpha, bias = params.alpha.double().numpy(), params.bias.double().numpy()
    h = xs.astype(np.float64) @ alpha + bias
    beta = np.linalg.solve(h.T @ h + ridge * np.eye(N_HID), h.T @ xs.astype(np.float64))
    x = np.concatenate([test.pattern(p)[:16] for p in test.class_names])
    exact = np.mean((x - (x.astype(np.float64) @ alpha + bias) @ beta) ** 2, axis=1)
    port = np.max(np.abs(ae_score(got, torch.from_numpy(x)).numpy() - exact) / exact)
    ours = np.max(np.abs(np.asarray(ref_ae_score(ref, jnp.asarray(x))) - exact) / exact)
    print(f"train_edge_device scores, largest relative distance from the exact ridge"
          f" solution: port {port:.3e}, reference {ours:.3e} (bound: twice the reference's)")
    assert port <= 2 * ours
