"""xLSTM's four mixers (``repro_torch.models.ssm``) against the reference's
``repro.models.ssm``, on the CPU.

Reduced ``xlstm-1.3b`` widths (D 256, 4 heads of 64), f32, weights drawn
by the reference's ``init_mlstm``/``init_slstm`` and carried over as numpy;
x (B 2, S, D) from a seeded numpy generator. ``mlstm_mix`` (the chunked
engine with v augmented by a ones column: the port's ``gla_forward``
plain version against the reference's jnp scan at chunk 128) and
``slstm_mix`` (the nonlinear recurrence token by token) at S = 33 and at
S = 200, past one 128-token chunk; then 6 decode steps from the final
state (``mlstm_decode_step``, ``slstm_decode_step``). Every output and
state is held at 1e-4 of its largest magnitude; ``-s`` prints the largest
spread (measured ≤ 1.6e-6). With bf16 weights the outputs and states have the
reference's types: jnp promotes an f32 state's product with bf16 weights
to f32, where torch would refuse the mix or keep bf16.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.models.ssm as rssm
from repro.configs import ARCHS as REF_ARCHS
from repro.models.blocks import init_mlstm as ref_init_mlstm
from repro.models.blocks import init_slstm as ref_init_slstm
from repro_torch.models.ssm import mlstm_decode_step, mlstm_mix, slstm_decode_step, slstm_mix

torch.set_num_threads(2)

REL = 1e-4
B, STEPS = 2, 6
CFG = REF_ARCHS["xlstm-1.3b"].reduced()
H = CFG.n_heads


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _port(tree):
    """numpy leaves (bf16 ones by their bits) as torch tensors."""
    def one(a):
        a = np.asarray(a)
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return {k: one(v) for k, v in tree.items()} if isinstance(tree, dict) else one(tree)


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max() / np.abs(want).max())


def _inputs(kind: str, s: int, dtype=jnp.float32):
    init = ref_init_mlstm if kind == "mlstm" else ref_init_slstm
    p = init(jax.random.PRNGKey(1), CFG, dtype)
    rng = np.random.default_rng(s)
    x = rng.standard_normal((B, s + STEPS, CFG.d_model)).astype(np.float32)
    return p, x


MIX = {"mlstm": (rssm.mlstm_mix, mlstm_mix), "slstm": (rssm.slstm_mix, slstm_mix)}
STEP = {"mlstm": (rssm.mlstm_decode_step, mlstm_decode_step),
        "slstm": (rssm.slstm_decode_step, slstm_decode_step)}


def _state_list(st):
    return list(st) if isinstance(st, tuple) else [st]


@pytest.mark.parametrize("s", [33, 200])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_mixer_and_decode_match_reference(kind, s):
    rp, x = _inputs(kind, s)
    p = _port(_np(rp))
    ref_mix, mix = MIX[kind]
    ref_step, step = STEP[kind]
    want_y, want_st = ref_mix(rp, jnp.asarray(x[:, :s]), n_heads=H)
    y, st = mix(p, torch.from_numpy(x[:, :s]), n_heads=H)
    spreads = {"y": _rel(y, want_y)}
    for i, (g, w) in enumerate(zip(_state_list(st), _state_list(want_st), strict=True)):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        spreads[f"state{i}"] = _rel(g, w)
    for t in range(STEPS):
        want_st, want_y = ref_step(rp, want_st, jnp.asarray(x[:, s + t]), n_heads=H)
        st, y = step(p, st, torch.from_numpy(x[:, s + t]), n_heads=H)
        spreads[f"step{t}.y"] = _rel(y, want_y)
        for i, (g, w) in enumerate(zip(_state_list(st), _state_list(want_st), strict=True)):
            spreads[f"step{t}.state{i}"] = _rel(g, w)
    worst = max(spreads, key=spreads.get)
    print(f"{kind} S={s}: max |port − ref| / max |ref| {spreads[worst]:.1e} ({worst})")
    assert all(v <= REL for v in spreads.values()), spreads


def test_mlstm_state_is_the_normalized_memory():
    """The final state is (B, H, dh, dh + 1): the memory and, in its last
    column, the normalizer (v's ones column), as the decode cache holds it."""
    rp, x = _inputs("mlstm", 33)
    _, st = mlstm_mix(_port(_np(rp)), torch.from_numpy(x[:, :33]), n_heads=H)
    dh = CFG.d_model // H
    assert tuple(st.shape) == (B, H, dh, dh + 1)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_bf16_types_follow_the_reference(kind):
    """bf16 weights: the mixer's output in bf16 and its state in f32; a decode
    step's state in f32, its output f32 for the mLSTM (the f32 state's
    product) and bf16 for the sLSTM (h cast back before the projection), as
    jnp types them."""
    rp, x = _inputs(kind, 33, jnp.bfloat16)
    p = _port(rp)
    xb = x.astype(ml_dtypes.bfloat16)
    ref_mix, mix = MIX[kind]
    ref_step, step = STEP[kind]
    want_y, want_st = ref_mix(rp, jnp.asarray(xb[:, :33]), n_heads=H)
    y, st = mix(p, _port(xb[:, :33]), n_heads=H)
    assert str(y.dtype).endswith(str(want_y.dtype))
    want_st, want_y = ref_step(rp, want_st, jnp.asarray(xb[:, 33]), n_heads=H)
    st, y = step(p, st, _port(xb[:, 33]), n_heads=H)
    assert str(y.dtype).endswith(str(want_y.dtype))
    for g, w in zip(_state_list(st), _state_list(want_st), strict=True):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
