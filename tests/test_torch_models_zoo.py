"""The rest of the model zoo against the reference, on the CPU: the MoE
with a dense residual (``arctic-480b``), the encoder-decoder
(``seamless-m4t-medium``) and the VLM (``llama-3.2-vision-11b``), each at
``ArchConfig.reduced()`` (f32, 2 layers), through
``tests/test_torch_models.py``'s checks (prefill logits, features and
every cache leaf, 4 greedy decode steps, forward's aux vector, the
prefill → decode continuation, the parameter layout, ``cache_spec``) at
its bounds; ``encoder_forward`` on the reference's stub embeddings at
1e-4 of its largest magnitude; and the ``float8_e4m3fn`` KV cache.

The float8 cache is held bit for bit (through ``uint8`` views): ``to_f8``
against jnp's ``astype`` on f32 and bf16 values across the format's range
(subnormals, ties, the ±448 edge, past it, ±inf and NaN), the prefill's
rolled cache and a decode step's slot write on the same values, and, for
reduced ``granite-3-2b``, ``hymba-1.5b`` (a rolling window) and
``seamless-m4t-medium`` on the reference's weights, each package's float8
caches as its f32 caches rounded; where the two packages' f32 values
straddle a rounding midpoint the bytes are one step apart, and the test
checks that each such byte does. 4 decode steps from the reference's
float8 caches give its logits at 1e-4 and its caches bit for bit. ``test_fp8_kv_cache_option``
is ``tests/test_archs.py``'s check on the port: bf16 weights, the float8
cache's decode logits within 0.15 of the bf16 cache's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from test_torch_models import (
    B,
    REL,
    STEPS,
    _rel,
    check_aux,
    check_cache_spec,
    check_continues_prefill,
    check_decode,
    check_layout,
    check_prefill,
    make_pair,
)

import repro.models as rm
from repro.configs import ARCHS as REF_ARCHS
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import decode_step, encoder_forward, init_params, prefill
from repro_torch.models.blocks import F8, to_f8

torch.set_num_threads(2)

MODELS = ("arctic-480b", "seamless-m4t-medium", "llama-3.2-vision-11b")
F8_MODELS = ("granite-3-2b", "hymba-1.5b", "seamless-m4t-medium")
S = 33


@pytest.fixture(scope="module", params=MODELS)
def pair(request):
    return make_pair(request.param)


def test_prefill_matches_reference(pair):
    check_prefill(pair)


def test_greedy_decode_matches_reference(pair):
    check_decode(pair)


def test_forward_aux_matches_reference(pair):
    check_aux(pair)


def test_decode_continues_prefill(pair):
    check_continues_prefill(pair)


def test_init_params_layout_matches_reference(pair):
    check_layout(pair)


def test_cache_spec_matches_reference_and_prefill(pair):
    check_cache_spec(pair)


def test_encoder_forward_matches_reference(pair):
    """The frontend stub's projection, and for the encoder-decoder the
    bidirectional encoder and its norm, at 1e-4; a config without a
    frontend has neither in its parameters, as in the reference's."""
    name, cfg, rparams, params, _, ref = pair
    assert ("frontend_proj" in params) == (ref["fe"] is not None) == ("frontend_proj" in rparams)
    assert ("enc_layers" in params) == cfg.is_encdec == ("enc_layers" in rparams)
    if ref["fe"] is None:
        return
    got = encoder_forward(params, cfg, torch.from_numpy(ref["fe"]))
    assert got.shape == (B, cfg.n_frontend_tokens, cfg.d_model)
    rel = _rel(got, ref["enc_out"])
    print(f"{name} encoder_forward: max |port − ref| / max |ref| {rel:.1e}")
    assert rel <= REL


def test_cross_attention_needs_the_encoder():
    cfg = get_config("llama-3.2-vision-11b").reduced()
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(ValueError, match="frontend="):
        prefill(params, cfg, torch.zeros((1, 4), dtype=torch.long))


# ---------------------------------------------------------------- float8


def _f8_values() -> np.ndarray:
    rng = np.random.default_rng(0)
    edges = [0.0, -0.0, 2.0 ** -10, 2.0 ** -9, 1.5 * 2.0 ** -9, 2.0 ** -6, 447.0, 448.0, 456.0,
             463.99, 464.0, 464.01, 479.0, 480.0, 1e4, np.inf, np.nan]
    grid = np.concatenate([rng.standard_normal(4096) * s for s in (1e-3, 1.0, 30.0, 300.0)])
    return np.concatenate([grid, edges, -np.asarray(edges)]).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_to_f8_rounds_as_jnp(dtype):
    """``to_f8`` gives jnp's float8_e4m3fn bits: ties to even, NaN past
    ±464 and for ±inf (torch alone saturates at ±448)."""
    x = _f8_values()
    if dtype == "bfloat16":  # the same bf16 bits in both (NaN's sign included)
        x = x.astype(ml_dtypes.bfloat16)
        xt = torch.from_numpy(x.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    else:
        xt = torch.from_numpy(x)
    want = np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn)).view(np.uint8)
    got = to_f8(xt)
    assert got.dtype == F8
    np.testing.assert_array_equal(got.view(torch.uint8).numpy(), want)


@pytest.mark.parametrize("s, cache_len", [(33, 37), (33, 16), (8, 8)])
def test_f8_cache_writes_bit_for_bit(s, cache_len):
    """On the same k: the prefill's rolled float8 cache (``_rolled_cache``
    on ``to_f8``; a capacity past S, a window under it) and a decode step's
    slot write through the uint8 view give the reference's bits."""
    from repro.models.blocks import _rolled_cache as ref_rolled_cache
    from repro_torch.models.blocks import _rolled_cache, _write_slot

    rng = np.random.default_rng(s + cache_len)
    k = (rng.standard_normal((B, s, 2, 16)) * 60).astype(np.float32)   # some past ±464
    k1 = (rng.standard_normal((B, 2, 16)) * 60).astype(np.float32)
    want = ref_rolled_cache(jnp.asarray(k).astype(jnp.float8_e4m3fn), cache_len)
    got = _rolled_cache(to_f8(torch.from_numpy(k)), cache_len)
    assert got.dtype == F8
    np.testing.assert_array_equal(got.view(torch.uint8).numpy(), np.asarray(want).view(np.uint8))
    slot = s % cache_len
    want = jax.lax.dynamic_update_slice_in_dim(
        want, jnp.asarray(k1)[:, None].astype(jnp.float8_e4m3fn), slot, 1)
    _write_slot(got, slot, torch.from_numpy(k1))
    np.testing.assert_array_equal(got.view(torch.uint8).numpy(), np.asarray(want).view(np.uint8))


def _f8_pair(name):
    cfg = dataclasses.replace(get_config(name).reduced(), kv_cache_dtype="float8_e4m3fn")
    rcfg = dataclasses.replace(REF_ARCHS[name].reduced(), kv_cache_dtype="float8_e4m3fn")
    rparams = rm.init_params(jax.random.PRNGKey(0), rcfg)
    params = model_params_from_numpy(jax.tree.map(np.asarray, rparams), device="cpu")
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    fe = None
    if rcfg.frontend is not None:
        fe = rng.standard_normal((B, rcfg.n_frontend_tokens, rcfg.d_frontend)).astype(np.float32)
    return cfg, rcfg, rparams, params, tokens, fe


def _from_reference(tree) -> dict:
    """The reference's caches as the port's, float8 leaves by their bits."""
    out = {}
    for kind, leaves in tree.items():
        out[kind] = {}
        for leaf, x in leaves.items():
            x = np.asarray(x)
            if x.dtype == jnp.float8_e4m3fn:
                out[kind][leaf] = torch.from_numpy(x.view(np.uint8).copy()).view(F8)
            else:
                out[kind][leaf] = torch.from_numpy(x.copy())
    return out


def _bits(caches: dict) -> dict:
    """Every float8 leaf's bits, by (kind, leaf)."""
    return {(kind, leaf): x.view(torch.uint8).numpy()
            for kind, leaves in caches.items() for leaf, x in leaves.items() if x.dtype == F8}


@pytest.mark.parametrize("name", F8_MODELS)
def test_f8_caches_match_reference(name):
    """The prefill's float8 caches are its f32 caches rounded by ``to_f8``,
    bit for bit, in both packages; the two differ only where the port's and
    the reference's f32 values (1e-6 apart) lie on either side of a rounding
    midpoint, one float8 step apart (printed with ``-s``: 1 byte of 37 888
    in three of these configs). Decode steps from the reference's float8
    caches, handed over by their bits, then give its logits at 1e-4 and its
    caches bit for bit."""
    cfg, rcfg, rparams, params, tokens, fe = _f8_pair(name)
    fe_j = None if fe is None else jnp.asarray(fe)
    fe_t = None if fe is None else torch.from_numpy(fe)
    ids = torch.from_numpy(tokens[:, :S - 1]).long()

    def ref_prefill(c):
        fn = jax.jit(lambda p, t, f: rm.prefill(p, c, t, frontend=f, cache_len=S + STEPS)[1])
        return fn(rparams, jnp.asarray(tokens[:, :S - 1]), fe_j)

    def port_prefill(c):
        return prefill(params, c, ids, frontend=fe_t, cache_len=S + STEPS)[1]

    plain = dict(kv_cache_dtype="param")
    ref_f8 = ref_prefill(rcfg)
    got, want = port_prefill(cfg), _from_reference(ref_f8)
    got32 = port_prefill(dataclasses.replace(cfg, **plain))
    want32 = _from_reference(ref_prefill(dataclasses.replace(rcfg, **plain)))
    got_bits, want_bits = _bits(got), _bits(want)
    assert set(got_bits) == set(want_bits) and got_bits
    apart = {}
    for (kind, leaf), w in want_bits.items():
        x, y = got32[kind][leaf], want32[kind][leaf]
        np.testing.assert_array_equal(got_bits[kind, leaf], to_f8(x).view(torch.uint8).numpy())
        np.testing.assert_array_equal(w, to_f8(y).view(torch.uint8).numpy())
        assert _rel(x, y.numpy()) <= REL
        diff = np.nonzero(got_bits[kind, leaf].ravel() != w.ravel())[0]
        apart[f"{kind}.{leaf}"] = f"{len(diff)} of {w.size}"
        a, b = got_bits[kind, leaf].ravel()[diff], w.ravel()[diff]
        assert np.all((a >> 7) == (b >> 7)) and np.all(np.abs(a.astype(int) - b.astype(int)) == 1)
        mid = (got[kind][leaf].flatten()[diff].float()
               + want[kind][leaf].flatten()[diff].float()) / 2
        xs, ys = x.flatten()[diff], y.flatten()[diff]
        assert bool(torch.all((xs - mid) * (ys - mid) <= 0)), "a byte apart off a midpoint"
    print(f"{name}: float8 prefill caches, bytes apart from the reference's: {apart}")

    enc_j = None if fe is None else rm.encoder_forward(rparams, rcfg, fe_j)
    enc_t = None if fe is None else encoder_forward(params, cfg, fe_t)
    dec = jax.jit(lambda p, t, c, pos, e: rm.decode_step(p, rcfg, t, c, pos, enc_out=e,
                                                         max_seq=S + STEPS))
    want, caches = ref_f8, _from_reference(ref_f8)
    tok = tokens[:, S - 1]
    for i in range(STEPS):
        lw, want = dec(rparams, jnp.asarray(tok), want, jnp.asarray(S - 1 + i, jnp.int32), enc_j)
        lg, caches = decode_step(params, cfg, torch.from_numpy(tok).long(), caches, S - 1 + i,
                                 enc_out=enc_t, max_seq=S + STEPS)
        assert _rel(lg, lw) <= REL, (i, _rel(lg, lw))
        for key, w in _bits(_from_reference(want)).items():
            np.testing.assert_array_equal(_bits(caches)[key], w, err_msg=f"decode step {i} {key}")
        tok = np.asarray(lw).argmax(-1).astype(np.int32)


def test_fp8_kv_cache_option():
    """``tests/test_archs.py::test_fp8_kv_cache_option`` on the port:
    kv_cache_dtype='float8_e4m3fn' halves the decode cache's bytes and its
    decode logits stay within 0.15 of the bf16 cache's."""
    r = dataclasses.replace(get_config("granite-3-2b").reduced(), param_dtype="bfloat16")
    r8 = dataclasses.replace(r, kv_cache_dtype="float8_e4m3fn")
    params = init_params(torch.Generator().manual_seed(0), r, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, r.vocab, (B, S)))
    outs = {}
    for cfg, name in ((r, "bf16"), (r8, "f8")):
        _, caches, _ = prefill(params, cfg, tokens[:, :S - 1], cache_len=S + 4)
        want = F8 if name == "f8" else torch.bfloat16
        assert caches["dense"]["k"].dtype == want and caches["dense"]["v"].dtype == want
        outs[name] = decode_step(params, cfg, tokens[:, S - 1], caches, S - 1, max_seq=S + 4)[0]
    assert caches["dense"]["k"].element_size() == 1
    rel = float((outs["bf16"] - outs["f8"]).abs().max() / outs["bf16"].abs().max())
    print(f"float8 against bf16 cache, decode logits: {rel:.3e}")
    assert rel < 0.15, rel
