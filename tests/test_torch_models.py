"""The port's model zoo serving path against the reference's, on the CPU.

Reduced ``hymba-1.5b`` (one global ``hymba`` and one ``hymba_swa``
layer: attention and the mamba head in parallel) and reduced
``gemma3-1b`` (``swa`` then ``dense``), f32, 2 layers, as
``ArchConfig.reduced()`` makes them. The reference draws the weights;
``convert.model_params_from_numpy`` carries them over leaf for leaf.
``prefill``'s logits, features and every cache leaf (k, v and the mamba
state), then 4 greedy ``decode_step``s, are held at 1e-4 of each
tensor's largest magnitude: the port's attention and GLA run their CUDA
kernels' plain versions, the reference its jnp oracles at chunk 512 and
128; measured, they agree to 3.4e-6 at most (logits, features, caches
and decode logits alike).
The prefill → decode continuation is held as ``tests/test_archs.py``
holds the reference's (1e-3). The configs are plain data copied from the
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
from repro_torch.models import decode_step, init_params, param_count, prefill

torch.set_num_threads(2)

MODELS = ("hymba-1.5b", "gemma3-1b")
REL = 1e-4
B, S, STEPS = 2, 33, 4


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max() / np.abs(want).max())


@pytest.fixture(scope="module", params=MODELS)
def pair(request):
    """(name, config, reference params, port params, tokens, reference run)
    with the reference's prefill and decode chain computed once."""
    name = request.param
    cfg = get_config(name).reduced()
    rcfg = REF_ARCHS[name].reduced()
    rparams = rm.init_params(jax.random.PRNGKey(0), rcfg)
    params = model_params_from_numpy(jax.tree.map(np.asarray, rparams), device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    logits, caches, feats = rm.prefill(rparams, rcfg, jnp.asarray(tokens[:, :S - 1]),
                                       cache_len=S + STEPS)
    ref = {"prefill": (np.asarray(logits), jax.tree.map(np.asarray, caches), np.asarray(feats)),
           "decode": []}
    tok = tokens[:, S - 1]
    for i in range(STEPS):
        logits, caches = rm.decode_step(rparams, rcfg, jnp.asarray(tok), caches,
                                        jnp.asarray(S - 1 + i, jnp.int32), max_seq=S + STEPS)
        ref["decode"].append((tok, np.asarray(logits)))
        tok = np.asarray(logits).argmax(-1).astype(np.int32)
    return name, cfg, rparams, params, tokens, ref


def _port_prefill(cfg, params, tokens):
    return prefill(params, cfg, torch.from_numpy(tokens[:, :S - 1]).long(), cache_len=S + STEPS)


def test_prefill_matches_reference(pair):
    _, cfg, _, params, tokens, ref = pair
    logits, caches, feats = _port_prefill(cfg, params, tokens)
    want_logits, want_caches, want_feats = ref["prefill"]
    assert _rel(logits, want_logits) <= REL
    assert _rel(feats, want_feats) <= REL
    assert set(caches) == set(want_caches)
    for kind, leaves in want_caches.items():
        assert set(caches[kind]) == set(leaves)
        for leaf, want in leaves.items():
            assert caches[kind][leaf].shape == want.shape, (kind, leaf)
            assert _rel(caches[kind][leaf], want) <= REL, (kind, leaf)


def test_greedy_decode_matches_reference(pair):
    """4 steps from the prefill's caches, each fed the reference's greedy
    token, logits at 1e-4; the port's greedy tokens are the reference's."""
    _, cfg, _, params, tokens, ref = pair
    _, caches, _ = _port_prefill(cfg, params, tokens)
    for i, (tok, want) in enumerate(ref["decode"]):
        logits, caches = decode_step(params, cfg, torch.from_numpy(tok).long(), caches,
                                     S - 1 + i, max_seq=S + STEPS)
        assert _rel(logits, want) <= REL, i
        assert np.array_equal(logits.argmax(-1).numpy(), want.argmax(-1))


def test_decode_continues_prefill(pair):
    """Prefill S − 1 tokens, decode the last: the logits of a prefill of all
    S (``tests/test_archs.py::test_prefill_decode_smoke``'s check)."""
    _, cfg, _, params, tokens, _ = pair
    _, caches, _ = _port_prefill(cfg, params, tokens)
    lg, _ = decode_step(params, cfg, torch.from_numpy(tokens[:, S - 1]).long(), caches, S - 1,
                        max_seq=S + 4)
    full, _, _ = prefill(params, cfg, torch.from_numpy(tokens).long())
    np.testing.assert_allclose(lg.numpy(), full.numpy(), rtol=1e-3, atol=1e-3)


def test_init_params_layout_matches_reference(pair):
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


def test_cache_spec_matches_reference_and_prefill(pair):
    """``cache_spec`` gives the reference's shapes, and one layer of the
    prefill's stacked caches has them (types: the model's)."""
    from repro.models.blocks import cache_spec as ref_cache_spec
    from repro_torch.models.blocks import cache_spec

    name, cfg, _, params, tokens, _ = pair
    _, caches, _ = _port_prefill(cfg, params, tokens)
    rcfg = REF_ARCHS[name].reduced()
    for kind, stacked in caches.items():
        spec = cache_spec(kind, cfg, B, S + STEPS)
        want = ref_cache_spec(kind, rcfg, B, S + STEPS)
        assert {k: v[0] for k, v in spec.items()} == {k: v[0] for k, v in want.items()}
        for leaf, (shape, dtype) in spec.items():
            assert tuple(stacked[leaf].shape[1:]) == shape and stacked[leaf].dtype == dtype


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


@pytest.mark.parametrize("name", ["xlstm-1.3b", "granite-moe-3b-a800m", "seamless-m4t-medium",
                                  "llama-3.2-vision-11b"])
def test_unported_block_kinds_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 10"):
        init_params(torch.Generator(), get_config(name).reduced(), device="cpu")


def test_full_width_hymba_pattern():
    """Hymba's 32 layers: global attention in layers 0, 15 and 31 only."""
    pat = get_config("hymba-1.5b").layer_pattern()
    assert len(pat) == 32 and [i for i, k in enumerate(pat) if k == "hymba"] == [0, 15, 31]
