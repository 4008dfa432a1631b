"""The port's model zoo serving path against the reference's, on the CPU.

Every config at ``ArchConfig.reduced()`` (f32, 2 layers): reduced
``hymba-1.5b`` (one global ``hymba`` and one ``hymba_swa`` layer),
``gemma3-1b`` (``swa`` then ``dense``), ``xlstm-1.3b`` (``slstm`` then
``mlstm``) and ``granite-moe-3b-a800m`` (two ``moe`` layers, 4 experts, top
2, the einsum dispatch) here; ``arctic-480b``, ``seamless-m4t-medium``
(two ``enc`` and two ``dec`` layers, 16 stub frames) and
``llama-3.2-vision-11b`` (``dense`` then ``xattn``, 16 stub patches) in
``tests/test_torch_models_zoo.py``, through this file's checks. The
reference draws the weights and the stub embeddings;
``convert.model_params_from_numpy`` carries the weights over leaf for
leaf. ``prefill``'s logits, features and every cache leaf (k, v, the
mamba state, the mLSTM memory, the sLSTM's h, c, n, m), then 4 greedy
``decode_step``s, are held at 1e-4 of each tensor's largest magnitude:
the port's attention and GLA run their CUDA kernels' plain versions, the
reference its jnp oracles at chunk 512 and 128; measured, they agree to
3.4e-6 at most (``-s`` prints each spread). ``forward``'s aux vector (the
MoE losses and the dropped fraction) is held to the reference's:
``dropped_frac`` exactly, the losses at 1e-5.
The prefill → decode continuation is held as ``tests/test_archs.py``
holds the reference's (1e-3; not for MoE, whose capacity routing
differs per grouping). The configs are plain data copied from the
reference and are checked field for field.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as rm
from repro.configs import ARCHS as REF_ARCHS
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import (
    decode_step,
    encoder_forward,
    forward,
    init_params,
    param_count,
    prefill,
)

torch.set_num_threads(2)

MODELS = ("hymba-1.5b", "gemma3-1b", "xlstm-1.3b", "granite-moe-3b-a800m")
REL = 1e-4
B, S, STEPS = 2, 33, 4


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max() / np.abs(want).max())


def _t(a) -> torch.Tensor | None:
    return None if a is None else torch.from_numpy(np.array(a, np.float32))


def make_pair(name: str, *, s: int = S, seed: int = 1):
    """(name, config, reference params, port params, tokens, reference run)
    with the reference's stub embeddings, prefill, aux and decode chain
    computed once."""
    cfg = get_config(name).reduced()
    rcfg = REF_ARCHS[name].reduced()
    rparams = rm.init_params(jax.random.PRNGKey(0), rcfg)
    params = model_params_from_numpy(jax.tree.map(np.asarray, rparams), device="cpu")
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)
    fe = enc_out = None
    if rcfg.frontend is not None:
        fe = rng.standard_normal((B, rcfg.n_frontend_tokens, rcfg.d_frontend)).astype(np.float32)
        enc_out = rm.encoder_forward(rparams, rcfg, jnp.asarray(fe))
    # the reference's prefill and aux from one jitted forward (as its serving
    # loop jits it), logits and features taken as its prefill takes them
    fwd = jax.jit(lambda p, t, f: rm.forward(p, rcfg, t, frontend=f, collect_cache=True,
                                             cache_len=s + STEPS))
    hidden, aux, caches = fwd(rparams, jnp.asarray(tokens[:, :s - 1]),
                              None if fe is None else jnp.asarray(fe))
    logits = (hidden[:, -1] @ rparams["embed"].T).astype(jnp.float32)
    feats = hidden.mean(axis=1).astype(jnp.float32)
    ref = {"prefill": (np.asarray(logits), jax.tree.map(np.asarray, caches), np.asarray(feats)),
           "aux": np.asarray(aux), "fe": fe,
           "enc_out": None if enc_out is None else np.asarray(enc_out), "decode": []}
    dec = jax.jit(lambda p, t, c, pos, e: rm.decode_step(p, rcfg, t, c, pos, enc_out=e,
                                                         max_seq=s + STEPS))
    tok = tokens[:, s - 1]
    for i in range(STEPS):
        logits, caches = dec(rparams, jnp.asarray(tok), caches, jnp.asarray(s - 1 + i, jnp.int32),
                             enc_out)
        ref["decode"].append((tok, np.asarray(logits)))
        tok = np.asarray(logits).argmax(-1).astype(np.int32)
    return name, cfg, rparams, params, tokens, ref


@pytest.fixture(scope="module", params=MODELS)
def pair(request):
    return make_pair(request.param)


def _port_prefill(cfg, params, tokens, ref):
    s = tokens.shape[1]
    return prefill(params, cfg, torch.from_numpy(tokens[:, :s - 1]).long(),
                   frontend=_t(ref["fe"]), cache_len=s + STEPS)


def _enc_out(cfg, params, ref):
    return None if ref["fe"] is None else encoder_forward(params, cfg, _t(ref["fe"]))


def check_prefill(pair):
    name, cfg, _, params, tokens, ref = pair
    logits, caches, feats = _port_prefill(cfg, params, tokens, ref)
    want_logits, want_caches, want_feats = ref["prefill"]
    spreads = {"logits": _rel(logits, want_logits), "features": _rel(feats, want_feats)}
    assert set(caches) == set(want_caches)
    for kind, leaves in want_caches.items():
        assert set(caches[kind]) == set(leaves)
        for leaf, want in leaves.items():
            assert caches[kind][leaf].shape == want.shape, (kind, leaf)
            spreads[f"{kind}.{leaf}"] = _rel(caches[kind][leaf], want)
    print(f"{name} S={tokens.shape[1]} prefill, max |port − ref| / max |ref|:",
          ", ".join(f"{k} {v:.1e}" for k, v in spreads.items()))
    assert all(v <= REL for v in spreads.values()), spreads


def check_decode(pair):
    """4 steps from the prefill's caches, each fed the reference's greedy
    token, logits at 1e-4; the port's greedy tokens are the reference's."""
    name, cfg, _, params, tokens, ref = pair
    s = tokens.shape[1]
    _, caches, _ = _port_prefill(cfg, params, tokens, ref)
    enc_out = _enc_out(cfg, params, ref)
    for i, (tok, want) in enumerate(ref["decode"]):
        logits, caches = decode_step(params, cfg, torch.from_numpy(tok).long(), caches,
                                     s - 1 + i, enc_out=enc_out, max_seq=s + STEPS)
        assert _rel(logits, want) <= REL, (name, i, _rel(logits, want))
        assert np.array_equal(logits.argmax(-1).numpy(), want.argmax(-1))


def check_aux(pair):
    """forward's aux vector: the summed MoE losses at 1e-5, the dropped
    fraction exactly; zeros for the kinds without one."""
    _, cfg, _, params, tokens, ref = pair
    _, aux, caches = forward(params, cfg, torch.from_numpy(tokens[:, :-1]).long(),
                             frontend=_t(ref["fe"]))
    assert caches is None and aux.dtype == torch.float32 and aux.shape == (3,)
    want = ref["aux"]
    np.testing.assert_allclose(aux[:2].numpy(), want[:2], rtol=1e-5, atol=1e-7)
    assert float(aux[2]) == float(want[2])


def check_continues_prefill(pair):
    """Prefill S − 1 tokens, decode the last: the logits of a prefill of all
    S (``tests/test_archs.py::test_prefill_decode_smoke``'s check)."""
    _, cfg, _, params, tokens, ref = pair
    s = tokens.shape[1]
    _, caches, _ = _port_prefill(cfg, params, tokens, ref)
    lg, _ = decode_step(params, cfg, torch.from_numpy(tokens[:, s - 1]).long(), caches, s - 1,
                        enc_out=_enc_out(cfg, params, ref), max_seq=s + 4)
    assert lg.shape == (B, cfg.vocab) and bool(torch.isfinite(lg).all())
    if not cfg.n_experts:  # capacity-based MoE routing differs per grouping
        full, _, _ = prefill(params, cfg, torch.from_numpy(tokens).long(), frontend=_t(ref["fe"]))
        np.testing.assert_allclose(lg.numpy(), full.numpy(), rtol=1e-3, atol=1e-3)


def test_prefill_matches_reference(pair):
    check_prefill(pair)


def test_greedy_decode_matches_reference(pair):
    check_decode(pair)


def test_forward_aux_matches_reference(pair):
    check_aux(pair)


def test_decode_continues_prefill(pair):
    check_continues_prefill(pair)


def check_layout(pair):
    """The port draws its own weights with the reference's tree, shapes and
    types, each leaf on the reference's scale."""
    name, cfg, rparams, params, _, _ = pair
    mine = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    flat_ref = jax.tree_util.tree_flatten_with_path(rparams)[0]
    assert param_count(mine) == param_count(params) == sum(int(x.size) for _, x in flat_ref)
    for path, want in flat_ref:
        got = mine
        for p in path:
            got = got[p.key]
        assert tuple(got.shape) == want.shape and str(got.dtype).endswith(str(want.dtype)), path
        w = np.array(want, np.float32)
        if w.std() > 0:
            assert 0.8 < float(got.float().std()) / float(w.std()) < 1.25, path
        else:
            assert torch.equal(got.float(), torch.from_numpy(w)), path


def check_cache_spec(pair):
    """``cache_spec`` gives the reference's shapes, and one layer of the
    prefill's stacked caches has them (types: the model's)."""
    from repro.models.blocks import cache_spec as ref_cache_spec
    from repro_torch.models.blocks import cache_spec

    name, cfg, _, params, tokens, ref = pair
    _, caches, _ = _port_prefill(cfg, params, tokens, ref)
    rcfg = REF_ARCHS[name].reduced()
    for kind, stacked in caches.items():
        spec = cache_spec(kind, cfg, B, S + STEPS)
        want = ref_cache_spec(kind, rcfg, B, S + STEPS)
        assert {k: v[0] for k, v in spec.items()} == {k: v[0] for k, v in want.items()}
        for leaf, (shape, dtype) in spec.items():
            assert tuple(stacked[leaf].shape[1:]) == shape and stacked[leaf].dtype == dtype


def test_init_params_layout_matches_reference(pair):
    check_layout(pair)


def test_cache_spec_matches_reference_and_prefill(pair):
    check_cache_spec(pair)


@pytest.mark.parametrize("name", ["granite-34b", "granite-3-2b", "llama3-405b"])
def test_other_dense_configs_prefill_as_the_reference(name):
    """The other configs the ported kinds serve: GELU-MLP (granite-34b),
    SwiGLU with GQA (granite-3-2b) and rope θ 500k (llama3-405b)."""
    cfg, rcfg = get_config(name).reduced(), REF_ARCHS[name].reduced()
    rparams = rm.init_params(jax.random.PRNGKey(0), rcfg)
    params = model_params_from_numpy(jax.tree.map(np.asarray, rparams), device="cpu")
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    want_logits, _, want_feats = rm.prefill(rparams, rcfg, jnp.asarray(tokens))
    logits, _, feats = prefill(params, cfg, torch.from_numpy(tokens).long())
    assert _rel(logits, want_logits) <= REL and _rel(feats, want_feats) <= REL


def test_bf16_params_convert_bit_for_bit():
    """The reference's bf16 leaves (``ml_dtypes`` arrays) go over by their
    bits, so a full-width checkpoint keeps its type and values."""
    rcfg = dataclasses.replace(REF_ARCHS["hymba-1.5b"].reduced(), param_dtype="bfloat16")
    rparams = rm.init_params(jax.random.PRNGKey(2), rcfg)
    params = model_params_from_numpy(jax.tree.map(np.asarray, rparams), device="cpu")
    want = rparams["layers"]["hymba"]["attn"]["wq"]
    got = params["layers"]["hymba"]["attn"]["wq"]
    assert got.dtype == torch.bfloat16 and params["final_norm"].dtype == torch.float32
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("name", sorted(REF_ARCHS))
def test_configs_are_the_reference_configs(name):
    mine, want = ARCHS[name], REF_ARCHS[name]
    assert dataclasses.asdict(mine) == dataclasses.asdict(want)
    assert mine.layer_pattern() == want.layer_pattern()
    assert dataclasses.asdict(mine.reduced()) == dataclasses.asdict(want.reduced())
    assert mine.reduced().layer_pattern() == want.reduced().layer_pattern()


def test_xlstm_crosses_a_chunk():
    """Reduced xlstm-1.3b at S = 200, past the engine's 128-token chunk:
    prefill (the mLSTM memory carried across the chunk's edge) and 4 decode
    steps against the reference."""
    run = make_pair("xlstm-1.3b", s=200, seed=5)
    check_prefill(run)
    check_decode(run)


def test_full_width_hymba_pattern():
    """Hymba's 32 layers: global attention in layers 0, 15 and 31 only."""
    pat = get_config("hymba-1.5b").layer_pattern()
    assert len(pat) == 32 and [i for i, k in enumerate(pat) if k == "hymba"] == [0, 15, 31]
