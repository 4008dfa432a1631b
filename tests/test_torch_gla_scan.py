"""The port's chunked gated linear attention against the reference's, on
the CPU.

The port's ``gla_forward`` takes its plain version on CPU tensors (the
CUDA kernel's arithmetic, chunk by chunk) and returns y and the final
state. y is held against the reference's Pallas kernel
(``gla_forward(interpret=True)``) and y and the state against its jnp
engine (``chunked_linear_attention``), at the same chunk, on the same
numpy inputs: f32 at rtol 1e-4 / atol 1e-4, the reference's own bound
between its kernel and engine (the cumsum of log a is summed in another
order, and e^cum amplifies its last bit); bf16 at 5e-2 against the f32
engine, the reference's own bf16 bound. The port's chunks are min(128, S)
tokens; S that fill whole chunks and S that leave a padded tail are both
run, and the reference's engine at chunks of 16–64 that do not divide S
is held at its own chunk-invariance bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gla_scan import gla_forward as ref_gla
from repro.models.ssm import chunked_linear_attention as ref_engine
from repro.models.ssm import linear_attention_decode_step as ref_decode_step
from repro_torch.kernels import gla_forward
from repro_torch.kernels.gla_scan import CHUNK, gla_forward_plain
from repro_torch.models.ssm import chunked_linear_attention, linear_attention_decode_step

torch.set_num_threads(2)

F32 = dict(rtol=1e-4, atol=1e-4)


def _inputs(seed, b, s, h, dk, dv):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, dk)).astype(np.float32)
    k = rng.standard_normal((b, s, h, dk)).astype(np.float32)
    v = rng.standard_normal((b, s, h, dv)).astype(np.float32)
    log_a = -np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    return q, k, v, log_a


def _t(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays[:3]] + [torch.from_numpy(arrays[3])]


# one chunk (S ≤ 128), two whole chunks (256), and padded tails (200, 300)
@pytest.mark.parametrize("s", [33, 100, 256, 200, 300])
def test_gla_matches_the_reference_kernel_and_engine(s):
    x = _inputs(s, 2, s, 3, 16, 8)
    y, state = gla_forward_plain(*_t(x))
    kernel = np.asarray(ref_gla(*x, chunk=CHUNK, interpret=True))
    want_y, want_state = ref_engine(*x, chunk=CHUNK)
    np.testing.assert_allclose(y.numpy(), kernel, **F32)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **F32)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_state), **F32)
    # the dispatching wrapper and the model's engine are the same function
    for fn in (gla_forward, chunked_linear_attention):
        got_y, got_state = fn(*_t(x))
        assert torch.equal(got_y, y) and torch.equal(got_state, state)


@pytest.mark.parametrize("s,chunk", [(33, 16), (100, 32), (256, 64)])
def test_gla_is_the_engine_at_other_chunks(s, chunk):
    """The chunked factorisation is exact: the port's 128-token chunks give
    the reference's engine at chunks that do not divide S, within the
    reference's own chunk-invariance bound (``tests/test_models_extra.py``)."""
    x = _inputs(s + chunk, 2, s, 3, 16, 8)
    y, state = gla_forward_plain(*_t(x))
    want_y, want_state = ref_engine(*x, chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_state), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gla_dtypes(dtype):
    x = _inputs(1, 1, 64, 2, 8, 8)
    y, _ = gla_forward_plain(*_t(x, dtype))
    assert y.dtype == dtype
    want, _ = ref_engine(*x, chunk=CHUNK)
    tol = dict(rtol=5e-2, atol=5e-2) if dtype == torch.bfloat16 else F32
    np.testing.assert_allclose(y.float().numpy(), np.asarray(want), **tol)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    kernel = ref_gla(*(jnp.asarray(a).astype(jdt) for a in x[:3]), x[3], chunk=CHUNK,
                     interpret=True)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(kernel, np.float32), **tol)


def test_gla_mamba_widths():
    """The hymba head's widths (dk = ssm_state = 16, dv = 64) at a prompt
    longer than one chunk."""
    x = _inputs(7, 1, 300, 2, 16, 64)
    y, state = gla_forward(*_t(x))
    want_y, want_state = ref_engine(*x, chunk=CHUNK)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **F32)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_state), **F32)


def test_gla_decode_continues_prefill():
    """The decode step continues the prefill's state: as
    ``tests/test_models_extra.py::test_gla_decode_continues_prefill``, in
    the port, and held to the reference's own continuation."""
    ks = jax.random.split(jax.random.PRNGKey(9), 4)
    s0 = 40
    q = np.array(jax.random.normal(ks[0], (1, s0 + 3, 2, 8)))
    k = np.array(jax.random.normal(ks[1], (1, s0 + 3, 2, 8)))
    v = np.array(jax.random.normal(ks[2], (1, s0 + 3, 2, 8)))
    log_a = np.array(-jax.nn.softplus(jax.random.normal(ks[3], (1, s0 + 3, 2))))
    tq, tk, tv, tla = _t((q, k, v, log_a))
    y_full, _ = gla_forward_plain(tq, tk, tv, tla)
    _, state = gla_forward_plain(tq[:, :s0], tk[:, :s0], tv[:, :s0], tla[:, :s0])
    _, ref_state = ref_engine(q[:, :s0], k[:, :s0], v[:, :s0], log_a[:, :s0], chunk=16)
    for t in range(s0, s0 + 3):
        state, y_t = linear_attention_decode_step(state, tq[:, t], tk[:, t], tv[:, t], tla[:, t])
        ref_state, ref_y = ref_decode_step(ref_state, q[:, t], k[:, t], v[:, t], log_a[:, t])
    np.testing.assert_allclose(y_t.numpy(), y_full[:, -1].numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(ref_y), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(state.numpy(), np.asarray(ref_state), rtol=1e-4, atol=1e-5)


def test_gla_refuses_mismatched_shapes():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="must be"):
        gla_forward(q, torch.zeros(1, 8, 2, 8), torch.zeros(1, 8, 2, 4), torch.zeros(1, 8, 2))
    with pytest.raises(ValueError, match="log_a"):
        gla_forward(q, q, torch.zeros(1, 8, 2, 4), torch.zeros(1, 8, 3))
