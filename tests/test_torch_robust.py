"""The port's robust merge against the reference on the CPU.

- ``robust_segment_sum_mix_plain`` (what the wrapper runs for CPU tensors)
  follows the CUDA kernel's order of operations, which is the order of
  the reference's Pallas kernel, so it is held to that kernel in
  interpret mode at 1e-6 absolute, and to the reference's sort-based XLA
  oracle at the reference's own 1e-5 (``tests/test_robust.py``). An empty
  cluster, which the reference never writes, is zeros in the port.
- ``payload_outlier_scores`` takes two NaN-ignoring medians. With an
  even count ``jnp.nanmedian`` averages the two middle values and
  ``torch.nanmedian`` takes the lower one, so the port has its own; the
  fixtures here have an even participant count.
- ``robust_merge_from_w`` is fed the reference's payloads (numpy) and
  held to the reference's kernel path: P at rtol 1e-5 / atol 1e-5, β at
  atol 5e-5 (ROADMAP queue 3: the reference's own Gauss-Jordan and
  Cholesky solves differ by up to 1.8e-5 absolute on β). The trimmed arm
  solves by Cholesky in both packages and repairs U with ``eigh``; the
  eigenvectors differ between LAPACK builds, their products do not.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fleet import (
    RobustConfig as RefRobustConfig,
    all_to_all as ref_all_to_all,
    fleet_merge_masked as ref_fleet_merge_masked,
    fleet_to_uv as ref_fleet_to_uv,
    hierarchical as ref_hierarchical,
    init_fleet as ref_init_fleet,
    payload_clip as ref_payload_clip,
    payload_outlier_scores as ref_payload_outlier_scores,
    ring as ref_ring,
    star as ref_star,
)
from repro.fleet.robust import _repair_u as ref_repair_u
from repro.fleet.robust import robust_merge_from_w as ref_robust_merge_from_w
from repro.kernels import (
    robust_segment_combine as ref_robust_segment_combine,
    robust_segment_sum_mix as ref_robust_segment_sum_mix,
    robust_segment_sum_xla as ref_robust_segment_sum_xla,
)
from repro.runtime import GovernorConfig as RefGovernorConfig
from repro.runtime import MergeGovernor as RefMergeGovernor
from repro_torch.convert import oselm_state_from_numpy
from repro_torch.fleet import (
    RobustConfig,
    Topology,
    all_to_all,
    finite_payload_mask,
    fleet_merge_masked_kernel,
    fleet_merge_robust,
    hierarchical,
    payload_clip,
    payload_outlier_scores,
    ring,
    robust_merge_from_w,
    star,
)
from repro_torch.fleet.robust import _repair_u, nanmedian
from repro_torch.kernels import (
    robust_segment_combine,
    robust_segment_sum_mix,
    robust_segment_sum_mix_plain,
)
from repro_torch.runtime import GovernorConfig, MergeGovernor

torch.set_num_threads(2)

D, H, N, RIDGE = 8, 6, 10, 1e-3

# cluster ids with a ragged run (3, 1, 4); the mask leaves cluster 1 with
# no participant and cluster 2 with 3; scales below 1 as clipping gives
CIDS = np.array([0, 0, 0, 1, 2, 2, 2, 2], np.int32)
MASK = np.array([1, 1, 0, 0, 1, 1, 1, 0], np.float32)
N_CLUSTERS = 3


def _x(seed=3, d=D, shape=(4, 37)):
    return np.random.default_rng(seed).normal(size=(d,) + shape).astype(np.float32)


def _scale(seed=4):
    return np.random.default_rng(seed).uniform(0.2, 1.0, size=D).astype(np.float32)


def _port(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("trim", [0, 1, 2])
def test_robust_segment_sum_plain_matches_interpret(trim):
    x, scale = _x(), _scale()
    want = ref_robust_segment_sum_mix(jnp.asarray(x), CIDS, jnp.asarray(MASK),
                                      jnp.asarray(scale), N_CLUSTERS, trim, interpret=True)
    xt, mt, st = _port(x, MASK, scale)
    got = robust_segment_sum_mix(xt, CIDS, mt, st, N_CLUSTERS, trim)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    oracle = ref_robust_segment_sum_xla(jnp.asarray(x), CIDS, jnp.asarray(MASK),
                                        jnp.asarray(scale), N_CLUSTERS, trim)
    for g, w in zip(got, oracle):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    counts = np.array([2.0, 0.0, 3.0], np.float32)
    est = robust_segment_combine(*got, torch.from_numpy(counts), trim)
    ref_est = ref_robust_segment_combine(*want, jnp.asarray(counts), trim)
    np.testing.assert_allclose(est.numpy(), np.asarray(ref_est), rtol=0, atol=1e-6)
    assert torch.isfinite(est).all()
    if trim == 0:
        assert torch.equal(est, got[0]) and not got[1].any() and not got[2].any()


def test_robust_segment_sum_empty_cluster_and_limits():
    x, scale = _x(), _scale()
    cids = np.array([0, 0, 0, 2, 2, 2, 3, 3], np.int32)  # cluster 1 has no device
    xt, mt, st = _port(x, MASK, scale)
    tot, lo, hi = robust_segment_sum_mix_plain(xt, cids, mt, st, 4, 2)
    assert not tot[1].any() and not lo[1].any() and not hi[1].any()
    want = ref_robust_segment_sum_mix(jnp.asarray(x), cids, jnp.asarray(MASK),
                                      jnp.asarray(scale), 4, 2, interpret=True)
    for g, w in zip((tot, lo, hi), want):
        np.testing.assert_allclose(g.numpy()[[0, 2, 3]], np.asarray(w)[[0, 2, 3]], atol=1e-6)
    with pytest.raises(ValueError, match="sorted"):
        robust_segment_sum_mix(xt, cids[::-1].copy(), mt, st, 4, 1)
    # no longest chain: trim 5 (more than any cluster's participants here)
    # is the reference's too
    got = robust_segment_sum_mix(xt, cids, mt, st, 4, 5)
    want = ref_robust_segment_sum_mix(jnp.asarray(x), cids, jnp.asarray(MASK),
                                      jnp.asarray(scale), 4, 5, interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy()[[0, 2, 3]], np.asarray(w)[[0, 2, 3]], atol=1e-6)
    with pytest.raises(ValueError, match="trim >= 0"):
        robust_segment_sum_mix(xt, cids, mt, st, 4, -1)


# chains longer than the card's registers hold (trim > 4): a star of 24
# devices and two clusters of 12, with 6 devices masked, so a cluster has
# more participants than 2·trim at trim 5 and as many as trim at trim 8
@pytest.mark.parametrize("n_clusters", [1, 2])
@pytest.mark.parametrize("trim", [5, 8])
def test_long_chains_match_interpret(trim, n_clusters):
    d = 24
    rng = np.random.default_rng(30 + trim)
    x = rng.normal(size=(d, 4, 37)).astype(np.float32)
    scale = rng.uniform(0.2, 1.0, size=d).astype(np.float32)
    mask = np.ones(d, np.float32)
    mask[rng.choice(d, 6, replace=False)] = 0.0
    cids = (np.arange(d) * n_clusters // d).astype(np.int32)
    want = ref_robust_segment_sum_mix(jnp.asarray(x), cids, jnp.asarray(mask),
                                      jnp.asarray(scale), n_clusters, trim, interpret=True)
    xt, mt, st = _port(x, mask, scale)
    got = robust_segment_sum_mix(xt, cids, mt, st, n_clusters, trim)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


def test_robust_segment_sum_keeps_the_extremes():
    """Each coordinate's lo and hi are the sums of its ``trim`` smallest and
    largest participating scaled values, whatever order they arrive in."""
    x, scale = _x(seed=9, shape=(3, 5)), _scale()
    xt, mt, st = _port(x, MASK, scale)
    for trim in (1, 2, 3, 4, 5, 8):
        tot, lo, hi = robust_segment_sum_mix_plain(xt, np.zeros(D, np.int32), mt, st, 1, trim)
        live = (x * scale[:, None, None])[MASK > 0]
        srt = np.sort(live, axis=0)
        k = min(trim, len(live))
        np.testing.assert_allclose(lo[0].numpy(), srt[:k].sum(0), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(hi[0].numpy(), srt[len(live) - k:].sum(0), rtol=1e-6,
                                   atol=1e-6)


# --------------------------------------------------- clip, guard, scores


def test_nanmedian_is_jnp_nanmedian():
    col = np.array([1.0, 2.0, np.nan, 4.0, 8.0], np.float32)
    assert float(nanmedian(torch.from_numpy(col))) == float(jnp.nanmedian(col)) == 3.0
    assert float(torch.nanmedian(torch.from_numpy(col))) == 2.0  # the lower middle value
    x = np.random.default_rng(1).normal(size=(6, 3, 4)).astype(np.float32)
    x[np.random.default_rng(2).random(x.shape) < 0.3] = np.nan
    x[:, 0, 0] = np.nan  # a column with no value
    got = nanmedian(torch.from_numpy(x), 0).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.nanmedian(x, axis=0)))


@pytest.fixture(scope="module")
def fleet():
    """The reference's fleet with large init chunks, so the honest Grams
    concentrate (the fixture of the reference's Byzantine-influence test)."""
    x0 = jax.random.normal(jax.random.PRNGKey(1), (D, 400, N))
    return ref_init_fleet(jax.random.PRNGKey(0), D, N, H, x0, ridge=RIDGE)


def _payload(fleet):
    uv = ref_fleet_to_uv(fleet, ridge=RIDGE)
    return np.array(jnp.concatenate([uv.u, uv.v], axis=-1))


def _state(fleet):
    return oselm_state_from_numpy(fleet.params.alpha, fleet.params.bias, fleet.beta, fleet.p,
                                  activation=fleet.activation, forget=fleet.forget,
                                  device="cpu")


def test_clip_guard_and_scores_match_reference(fleet):
    w = _payload(fleet)
    w[5] *= 1e4
    got, scale = payload_clip(torch.from_numpy(w), 10.0)
    want, ref_scale = ref_payload_clip(jnp.asarray(w), 10.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(scale.numpy(), np.asarray(ref_scale), rtol=1e-6)
    assert payload_clip(torch.from_numpy(w), None)[1] is None
    # an even participant count (6 of 8): both medians average two values
    mask = np.array([1, 1, 0, 1, 1, 1, 0, 1], np.float32)
    scores = payload_outlier_scores(torch.from_numpy(w), torch.from_numpy(mask)).numpy()
    ref_scores = np.asarray(ref_payload_outlier_scores(jnp.asarray(w), jnp.asarray(mask)))
    np.testing.assert_allclose(scores, ref_scores, rtol=1e-5)
    assert scores[5] > 5.0 and np.isfinite(scores).all()
    # with the lower middle value (torch.nanmedian) the scores would move
    assert np.abs(scores - ref_scores).max() < 1e-3 * np.abs(ref_scores).max()
    nanned = torch.from_numpy(w.copy())
    nanned[1, 0, 0] = float("nan")
    nanned[3, 2, 1] = float("inf")
    np.testing.assert_array_equal(finite_payload_mask(nanned).numpy(),
                                  [True, False, True, False, True, True, True, True])


def test_repair_u_matches_reference_on_an_indefinite_estimate():
    rng = np.random.default_rng(5)
    q, _ = np.linalg.qr(rng.normal(size=(3, H, H)))
    evals = np.array([[-2.0, -1e-3, 0.5, 1.0, 3.0, 9.0]] * 3)
    u = (q * evals[:, None, :]) @ q.transpose(0, 2, 1)
    est = np.concatenate([u, rng.normal(size=(3, H, 4))], axis=-1).astype(np.float32)
    got = _repair_u(torch.from_numpy(est), H).numpy()
    want = np.asarray(ref_repair_u(jnp.asarray(est), H))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[..., H:], est[..., H:])
    assert np.linalg.eigvalsh(got[..., :H].astype(np.float64)).min() > 0


# ------------------------------------------------------ robust merges

TOPOS = {
    "star": (star, ref_star),
    "hierarchical": (lambda d: hierarchical(d, 2), lambda d: ref_hierarchical(d, 2)),
    "hierarchical_isolated": (lambda d: hierarchical(d, 2, head_exchange=False),
                              lambda d: ref_hierarchical(d, 2, head_exchange=False)),
    "all_to_all": (all_to_all, ref_all_to_all),
    "ring": (lambda d: ring(d, 1), lambda d: ref_ring(d, 1)),
}
PART = np.array([1, 1, 0, 1, 1, 1, 0, 1], np.float32)
RECEIVE = np.array([1, 1, 1, 1, 1, 1, 0, 1], np.float32)  # device 2 downloads only


def _hold_merge(got, want, before):
    np.testing.assert_allclose(got.p.numpy(), np.asarray(want.p), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.beta.numpy(), np.asarray(want.beta), rtol=1e-5, atol=5e-5)
    kept = np.flatnonzero((np.asarray(want.beta) == np.asarray(before.beta)).all(axis=(1, 2)))
    assert torch.equal(got.beta[kept], torch.from_numpy(np.array(before.beta))[kept])


@pytest.mark.parametrize("receive", [False, True])
@pytest.mark.parametrize("clip", [None, 40.0])
@pytest.mark.parametrize("trim", [0, 1])
@pytest.mark.parametrize("topo_name", sorted(TOPOS))
def test_robust_merge_matches_reference(fleet, topo_name, trim, clip, receive):
    port_topo, ref_topo = TOPOS[topo_name]
    w = _payload(fleet)
    w[2] *= -50.0
    rec = RECEIVE if receive else None
    want, ref_scores = ref_robust_merge_from_w(
        fleet, ref_topo(D), jnp.asarray(PART), jnp.asarray(w),
        RefRobustConfig(trim=trim, clip_norm=clip), RIDGE, kernel=True,
        receive=None if rec is None else jnp.asarray(rec),
    )
    got, scores = robust_merge_from_w(
        _state(fleet), port_topo(D), torch.from_numpy(PART), torch.from_numpy(w),
        RobustConfig(trim=trim, clip_norm=clip), RIDGE,
        receive=None if rec is None else torch.from_numpy(rec),
    )
    _hold_merge(got, want, fleet)
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref_scores), rtol=1e-5, atol=1e-6)
    takes = (rec if receive else PART) > 0
    moved = ~(got.beta == torch.from_numpy(np.array(fleet.beta))).all(dim=2).all(dim=1)
    assert moved.numpy().tolist() == takes.tolist()


@pytest.mark.parametrize("topo_name", sorted(TOPOS))
def test_trim0_no_clip_is_the_masked_merge_bit_for_bit(fleet, topo_name):
    """With the defence off the robust entry point is the port's exact
    masked merge: the same arrays in the same order."""
    topo = TOPOS[topo_name][0](D)
    state = _state(fleet)
    want = fleet_merge_masked_kernel(state, topo, torch.from_numpy(PART), ridge=RIDGE)
    got, scores = fleet_merge_robust(state, topo, config=RobustConfig(trim=0), ridge=RIDGE,
                                     mask=torch.from_numpy(PART))
    assert torch.equal(got.beta, want.beta) and torch.equal(got.p, want.p)
    assert torch.isfinite(scores).all()


def test_custom_dense_mask_with_trim_raises(fleet):
    m = np.eye(D, dtype=np.float32) + np.eye(D, k=1, dtype=np.float32)
    topo = Topology(name="custom", n_devices=D, kind="dense", matrix=m)
    state = _state(fleet)
    with pytest.raises(NotImplementedError, match="custom dense mask"):
        fleet_merge_robust(state, topo, config=RobustConfig(trim=1), ridge=RIDGE)
    # clipping and scores still work there through the trim=0 path
    got, scores = fleet_merge_robust(state, topo, config=RobustConfig(trim=0, clip_norm=40.0),
                                     ridge=RIDGE)
    assert torch.isfinite(got.beta).all() and scores.shape == (D,)


@pytest.mark.parametrize("topo_name", ["star", "ring", "hierarchical"])
def test_robust_merge_bounds_byzantine_influence(fleet, topo_name):
    """One ×−50 attacker: the trimmed merge stays finite and near the
    clean merge, the naive merge is destroyed, and the attacker's outlier
    score dominates every honest one. The reference calls the naive merge
    destroyed when it is non-finite or dragged an order of magnitude
    further than the trimmed one; its naive merge solves by Cholesky,
    which gives NaN on the indefinite sum. The port's one masked merge
    solves by Gauss-Jordan, which inverts the indefinite sum all the same,
    so the port's test also counts an indefinite merged P as destroyed: it
    is no RLS state."""
    port_topo, ref_topo = TOPOS[topo_name]
    w = _payload(fleet)
    attacker = 2
    w_adv = w.copy()
    w_adv[attacker] *= -50.0
    ones = torch.ones(D)
    state = _state(fleet)
    clean = ref_fleet_merge_masked(fleet, ref_topo(D), jnp.ones(D), ridge=RIDGE)
    robust, scores = robust_merge_from_w(state, port_topo(D), ones, torch.from_numpy(w_adv),
                                         RobustConfig(trim=1), RIDGE)
    naive, _ = robust_merge_from_w(state, port_topo(D), ones, torch.from_numpy(w_adv),
                                   RobustConfig(trim=0), RIDGE)
    honest = [d for d in range(D) if d != attacker]
    rb, cb = robust.beta.numpy()[honest], np.asarray(clean.beta)[honest]
    nb = naive.beta.numpy()[honest]
    assert torch.isfinite(robust.beta).all() and torch.isfinite(scores).all()
    robust_err = np.abs(rb - cb).max()
    assert robust_err < 0.5 * np.abs(cb).max(), robust_err
    indefinite = np.linalg.eigvalsh(naive.p.numpy()[honest].astype(np.float64)).min() < 0
    print(f"{topo_name}: β from the clean merge, trimmed {robust_err:.3g}, naive "
          f"{np.abs(nb - cb).max():.3g}; naive P indefinite: {indefinite}")
    assert (not np.isfinite(nb).all() or np.abs(nb - cb).max() > 10.0 * robust_err
            or indefinite)
    assert np.linalg.eigvalsh(robust.p.numpy().astype(np.float64)).min() > 0
    s = scores.numpy()
    assert s[attacker] > 10.0 * max(s[h] for h in honest), s


# ------------------------------------------------ governor and config


def test_governor_escalation_and_readmission_match_reference():
    cfg = dict(trim=1, score_threshold=4.0, score_readmit=2.0, escalate_after=2,
               readmit_after=3)
    gov = MergeGovernor(star(4), H, 10, GovernorConfig(), robust=RobustConfig(**cfg))
    ref = RefMergeGovernor(ref_star(4), H, 10, RefGovernorConfig(),
                           robust=RefRobustConfig(**cfg))
    hot, calm = np.asarray([1.0, 9.0, 1.0, 4.0]), np.asarray([1.0, 1.0, 1.0, 2.0])
    history = []
    for scores in (hot, hot, calm, calm, hot, calm, calm, calm, hot, calm, hot, calm):
        gov.observe_robust(scores)
        ref.observe_robust(scores)
        for name in ("robust_strikes", "robust_calm", "robust_quarantined"):
            np.testing.assert_array_equal(getattr(gov, name), getattr(ref, name))
        drifted = np.array([False, False, True, False])
        np.testing.assert_array_equal(gov.participation(drifted, np.zeros(4)),
                                      ref.participation(drifted, np.zeros(4)))
        history.append(int(gov.robust_quarantined[1]))
    # quarantined after two hot rounds, held through a hot round among calm
    # ones, released after three calm rounds; alternation never escalates
    assert history == [0, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]
    assert not gov.robust_quarantined[[0, 2, 3]].any()
    plain = MergeGovernor(star(4), H, 10, GovernorConfig())
    plain.observe_robust(hot)
    assert not plain.robust_quarantined.any()


@pytest.mark.parametrize("bad", [
    dict(trim=-1), dict(clip_norm=0.0), dict(score_threshold=1.0, score_readmit=2.0),
    dict(escalate_after=0), dict(readmit_after=0),
])
def test_robust_config_validation_matches_reference(bad):
    with pytest.raises(ValueError) as got:
        RobustConfig(**bad)
    with pytest.raises(ValueError) as want:
        RefRobustConfig(**bad)
    assert str(got.value) == str(want.value)
