"""The port's serving loop against the reference's, on the CPU.

``repro_torch.launch.serve.serve`` runs reduced ``hymba-1.5b`` (f32, one
global and one sliding-window hybrid layer) on the reference's weights
(``convert.model_params_from_numpy``). The reference's loop
(``repro/launch/serve.py:42-190``) is run here through ``repro.models``,
``repro.core`` and ``repro.runtime`` on the same numpy prompts
(``serve_prompts``) and with the same monitor basis (the port draws it;
the reference's ``init_oselm`` takes it). Held:

- the drift flags equal, and the greedy tokens equal up to the first
  logit near-tie (top two within 1e-4 of the largest |logit|, where a
  last-bit difference may pick the other);
- the drift scores within 1e-4 relative when the monitor runs exactly:
  the same OS-ELM chain in f64 (numpy, below), fed each package's
  features. Measured: 1.5e-5.
- the f32 scores port against reference. At B = 4 the monitor is
  ill-posed: the Eq. 13 init sees 2·B = 8 distinct warm-up rows for
  Ñ = 16, so 8 of the 16 eigenvalues of U₀ + εI sit at ε = 1e-2 (condition
  number 3.2e4), and a one-ulp change of the reference's own features
  moves its f32 scores by up to 3.7e-4. The scores are held at twice that
  move, measured here and printed (port against reference: 2.7e-4), and
  each package's f32 scores against the f64 chain on its own features at
  twice the larger error of the reference's two paths (its jnp attention
  and XLA k=1 scan, and its Pallas flash and ingest kernels; measured
  2.0e-4, the port 3.2e-4). At B = 12 the warm-up gives 24 rows, U₀ + εI
  is well conditioned (5.8e2), and the f32 scores are held port against
  reference at 1e-4 (measured 1.3e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as rm
from repro.configs import get_config as ref_get_config
from repro.core import ae_score as ref_ae_score
from repro.core import ae_train_stream as ref_ae_train_stream
from repro.core import init_oselm as ref_init_oselm
from repro.core import oselm_step as ref_oselm_step
from repro.core import oselm_train_sequential as ref_oselm_train_sequential
from repro.core.elm import SLFNParams as RefSLFNParams
from repro.runtime import DetectorConfig as RefDetectorConfig
from repro.runtime import detector_update as ref_detector_update
from repro.runtime import init_detector as ref_init_detector
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_numpy
from repro_torch.core.elm import init_slfn
from repro_torch.launch.serve import DRIFT_VOCAB, MONITOR_SEED_OFFSET, main, serve, serve_prompts
from repro_torch.models import prefill

torch.set_num_threads(2)

ARCH = "hymba-1.5b"
RUN = dict(rounds=4, batch=4, prompt_len=200, new_tokens=4, drift_round=2, seed=3)
WELL_POSED = dict(RUN, batch=12, prompt_len=64)   # 24 warm-up rows for Ñ = 16
TIE = 1e-4


def _reference_loop(rcfg, rparams, *, rounds, batch, prompt_len, new_tokens, drift_round, seed,
                    kernels=False):
    """The reference's serving loop, on the port's prompts and monitor basis:
    per round (score, flag, greedy tokens, each step's logits), and the
    features it scored (warm-up rows first). With ``kernels`` the loop
    takes the reference's own second path: its Pallas flash kernel in the
    prefill (interpret mode, in place of the jnp oracle) and its Pallas
    ingest kernel for the monitor's warm-up stream (in place of the XLA
    scan of k=1 steps)."""
    max_seq = prompt_len + new_tokens
    warm, prompts = serve_prompts(rcfg.vocab, rounds=rounds, batch=batch, prompt_len=prompt_len,
                                  drift_round=drift_round, seed=seed)
    prefill_fn = jax.jit(lambda p, t: rm.prefill(p, rcfg, t, cache_len=max_seq))
    decode_fn = jax.jit(lambda p, t, c, pos: rm.decode_step(p, rcfg, t, c, pos, max_seq=max_seq))
    feats = [np.concatenate([np.asarray(prefill_fn(rparams, jnp.asarray(w, jnp.int32))[2])
                             for w in warm])]
    tokens, logits_per_round = [], []
    for prompt in prompts:
        logits, caches, features = prefill_fn(rparams, jnp.asarray(prompt, jnp.int32))
        feats.append(np.asarray(features))
        steps = [np.asarray(logits)]
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        for i in range(new_tokens):
            logits, caches = decode_fn(rparams, tok, caches, jnp.asarray(prompt_len + i, jnp.int32))
            steps.append(np.asarray(logits))
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
        tokens.append(np.stack([s.argmax(-1) for s in steps], 1))
        logits_per_round.append(steps)
    scores, flags = _reference_monitor(feats, seed, rcfg.d_model, rcfg.detector_hidden,
                                       kernels=kernels)
    return list(zip(scores, flags, tokens, logits_per_round, strict=True)), feats


def _reference_monitor(feats, seed, d_model, n_hidden, *, kernels=False):
    """The reference loop's monitor on ``feats`` (warm-up rows, then each
    round's), with the port's basis: (scores, flags)."""
    basis = init_slfn(torch.Generator().manual_seed(seed + MONITOR_SEED_OFFSET), d_model, n_hidden,
                      device="cpu")
    warm = jnp.asarray(feats[0])
    x0 = jnp.tile(warm, (2 * n_hidden // warm.shape[0] + 1, 1))
    detector = ref_init_oselm(RefSLFNParams(jnp.asarray(basis.alpha.numpy()),
                                            jnp.asarray(basis.bias.numpy())),
                              x0, x0, activation="identity", ridge=1e-2)
    if kernels:
        detector = ref_oselm_train_sequential(detector, warm, warm, kernel=True)
    else:
        detector = ref_ae_train_stream(detector, warm)
    monitor = ref_init_detector(1)
    mon_cfg = RefDetectorConfig(alpha=0.7, k_sigma=4.0, warmup=2, patience=1)
    scores, flags = [], []
    for features in feats[1:]:
        features = jnp.asarray(features)
        score = float(ref_ae_score(detector, features).mean())
        monitor, flagged, _ = ref_detector_update(monitor, jnp.asarray([score]), mon_cfg)
        detector = ref_oselm_step(detector, features, features)
        scores.append(score)
        flags.append(bool(flagged[0]))
    return np.array(scores), flags


def _port_features(cfg, params, *, rounds, batch, prompt_len, new_tokens, drift_round, seed):
    """The features ``serve`` scores (warm-up rows, then each round's), by
    the same prefills on the CPU."""
    warm, prompts = serve_prompts(cfg.vocab, rounds=rounds, batch=batch, prompt_len=prompt_len,
                                  drift_round=drift_round, seed=seed)
    run = [prefill(params, cfg, torch.as_tensor(p), cache_len=prompt_len + new_tokens)[2].numpy()
           for p in warm + prompts]
    return [np.concatenate(run[:2])] + run[2:]


def _exact_scores(feats, seed, d_model, n_hidden):
    """The monitor's chain in f64 (identity activation, as ``serve`` runs
    it): the Eq. 13 init on the tiled warm-up rows, k=1 steps over them,
    then per round the score and a batch step."""
    basis = init_slfn(torch.Generator().manual_seed(seed + MONITOR_SEED_OFFSET), d_model, n_hidden,
                      device="cpu")
    alpha, bias = basis.alpha.double().numpy(), basis.bias.double().numpy()
    warm = feats[0].astype(np.float64)
    x0 = np.tile(warm, (2 * n_hidden // warm.shape[0] + 1, 1))
    h0 = x0 @ alpha + bias
    a = h0.T @ h0 + 1e-2 * np.eye(n_hidden)
    p, beta = np.linalg.inv(a), np.linalg.solve(a, h0.T @ x0)
    for x in warm:
        h = x @ alpha + bias
        ph = p @ h
        p = p - np.outer(ph, ph) / (1.0 + h @ ph)
        beta = beta + np.outer(p @ h, x - h @ beta)
    scores = []
    for x in feats[1:]:
        x = x.astype(np.float64)
        h = x @ alpha + bias
        scores.append(np.mean((x - h @ beta) ** 2))
        ph = p @ h.T
        p = p - ph @ np.linalg.inv(np.eye(len(x)) + h @ ph) @ ph.T
        beta = beta + p @ h.T @ (x - h @ beta)
    return np.array(scores)


def _pallas_attention(q, k, v, *, causal=True, chunk=512):
    """The reference's Pallas flash kernel (interpret mode) in place of its
    jnp oracle: the reference's own second path through the prefill."""
    from repro.kernels.flash_attn import flash_attention

    return flash_attention(q, k, v, causal=causal, interpret=True)


@pytest.fixture(scope="module")
def weights():
    """Reduced hymba-1.5b: the reference's config and weights, and the
    port's config and the same weights converted."""
    rcfg = ref_get_config(ARCH).reduced()
    rparams = rm.init_params(jax.random.PRNGKey(RUN["seed"]), rcfg)
    params = model_params_from_numpy(jax.tree.map(np.asarray, rparams), device="cpu")
    return rcfg, rparams, get_config(ARCH).reduced(), params


@pytest.fixture(scope="module")
def runs(weights):
    rcfg, rparams, cfg, params = weights
    port = serve(cfg, device="cpu", params=params, **RUN)
    ref, ref_feats = _reference_loop(rcfg, rparams, **RUN)
    with pytest.MonkeyPatch.context() as mp:
        import repro.models.blocks as ref_blocks

        mp.setattr(ref_blocks, "blockwise_attention", _pallas_attention)
        twin, twin_feats = _reference_loop(rcfg, rparams, kernels=True, **RUN)
    exact = {name: _exact_scores(f, RUN["seed"], cfg.d_model, cfg.detector_hidden)
             for name, f in (("port", _port_features(cfg, params, **RUN)),
                             ("reference", ref_feats), ("twin", twin_feats))}
    return dict(port=port, ref=ref, twin=twin, exact=exact, ref_feats=ref_feats)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want) / np.abs(want)


def test_drift_scores_match_reference_through_an_exact_monitor(runs):
    exact = runs["exact"]
    got = _rel(exact["port"], exact["reference"]).max()
    print(f"the f64 chain on the port's features against it on the reference's: {got:.2e}")
    assert got <= 1e-4


def test_drift_scores_stray_from_exact_as_the_references_do(runs):
    port, ref, twin, exact = (runs[k] for k in ("port", "ref", "twin", "exact"))
    got = _rel([r.score for r in port], exact["port"])
    spread = max(_rel([r[0] for r in ref], exact["reference"]).max(),
                 _rel([r[0] for r in twin], exact["twin"]).max())
    print(f"f32 scores against the f64 chain: port {got.max():.2e}, the reference's paths "
          f"{spread:.2e}")
    assert got.max() <= max(1e-4, 2 * spread)


def test_drift_scores_match_reference_in_f32(runs, weights):
    """Port against reference f32 scores, at twice the most that a one-ulp
    change of the reference's own features moves the reference's f32
    scores (four draws): with 2·B = 8 warm-up rows for Ñ = 16 the monitor
    is ill-posed (8 eigenvalues of U₀ + εI at ε), and its f32 score is a
    draw of that scale around the exact one."""
    cfg = weights[2]
    want = np.array([r[0] for r in runs["ref"]])
    rng = np.random.default_rng(0)
    moved = 0.0
    for _ in range(4):
        nudged = [np.where(rng.random(f.shape) < 0.5, np.nextafter(f, np.inf),
                           np.nextafter(f, -np.inf)) for f in runs["ref_feats"]]
        scores, _ = _reference_monitor(nudged, RUN["seed"], cfg.d_model, cfg.detector_hidden)
        moved = max(moved, _rel(scores, want).max())
    got = _rel([r.score for r in runs["port"]], want).max()
    print(f"f32 scores, port - reference {got:.2e}; a one-ulp change of the reference's features "
          f"moves its scores by up to {moved:.2e}")
    assert got <= max(1e-4, 2 * moved)


def test_drift_scores_match_reference_where_the_monitor_is_well_posed(weights):
    """At B = 12 the warm-up gives 24 rows for Ñ = 16 and U₀ + εI is full
    rank: the f32 scores are held port against reference at 1e-4."""
    rcfg, rparams, cfg, params = weights
    port = serve(cfg, device="cpu", params=params, **WELL_POSED)
    ref, _ = _reference_loop(rcfg, rparams, **WELL_POSED)
    got = _rel([r.score for r in port], [r[0] for r in ref]).max()
    print(f"f32 scores at B = {WELL_POSED['batch']}, port - reference {got:.2e}")
    assert got <= 1e-4
    assert [r.flagged for r in port] == [r[1] for r in ref]


def test_drift_flags_match_reference(runs):
    port, ref = runs["port"], runs["ref"]
    assert [r.flagged for r in port] == [flag for _, flag, _, _ in ref]


def test_greedy_tokens_match_reference_up_to_near_ties(runs):
    port, ref = runs["port"], runs["ref"]
    for got, (_, _, want, steps) in zip(port, ref, strict=True):
        assert got.tokens.shape == want.shape == (RUN["batch"], RUN["new_tokens"] + 1)
        for row in range(want.shape[0]):
            differ = np.flatnonzero(got.tokens[row] != want[row])
            if differ.size:  # from here on the two continue different texts
                lg = np.sort(steps[differ[0]][row])
                assert lg[-1] - lg[-2] <= TIE * np.abs(lg).max(), (row, differ[0])


def test_round_timings_are_reported(runs):
    for r in runs["port"]:
        assert r.seconds > 0 and r.prefill_seconds > 0 and r.decode_seconds > 0
        assert abs(r.prefill_seconds + r.decode_seconds - r.seconds) < 1e-6


def test_serve_prompts_permute_the_drift_round():
    warm, rounds = serve_prompts(512, rounds=3, batch=2, prompt_len=5, drift_round=1, seed=0)
    again, _ = serve_prompts(512, rounds=3, batch=2, prompt_len=5, drift_round=2, seed=0)
    assert len(warm) == 2 and len(rounds) == 3
    assert all(np.array_equal(a, b) for a, b in zip(warm, again))
    _, plain = serve_prompts(512, rounds=3, batch=2, prompt_len=5, drift_round=-1, seed=0)
    assert np.array_equal(rounds[0], plain[0]) and np.array_equal(rounds[2], plain[2])
    assert np.array_equal(rounds[1], (plain[1] % DRIFT_VOCAB * 31 + 17) % 512)


def test_main_runs_the_reduced_loop(capsys):
    out = main(["--arch", ARCH, "--rounds", "2", "--batch", "2", "--prompt-len", "16",
                "--new-tokens", "2", "--device", "cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("round ")]
    assert len(out) == len(lines) == 2
    assert "<< DRIFT" in lines[1] and "2 reqs × 2 tok" in lines[0]


@pytest.mark.parametrize("argv,match", [(["--fleet"], "item 6"),
                                        (["--telemetry-dir", "t"], "item 1")])
def test_unported_routes_raise(argv, match):
    with pytest.raises(NotImplementedError, match=match):
        main(argv + ["--device", "cpu"])


def test_serve_refuses_an_empty_loop():
    with pytest.raises(ValueError, match="rounds >= 1"):
        serve(get_config(ARCH).reduced(), rounds=0, device="cpu")
