"""The port's fused attention against the reference's, on the CPU.

The port's ``flash_attention`` takes its plain version on CPU tensors: an
online softmax over the CUDA kernel's tiles of 64 keys, with the kernel's
arithmetic. It is held against the reference's Pallas kernel
(``flash_attention(interpret=True)``, as ``tests/test_kernels.py`` runs
it) and its jnp oracle (``blockwise_attention_fwd_only``) on the same
numpy inputs: f32 at rtol 1e-4 / atol 1e-5, the reference's own bound
between the two; bf16 at 3e-2, the reference's own bf16 bound (p is
rounded to bf16 before p·v, so block sizes move which p round where).
The port's copy of the oracle, ``models.layers.blockwise_attention_fwd_only``,
is held to the reference's oracle at the same bounds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import flash_attention as ref_flash
from repro.models.layers import blockwise_attention_fwd_only as ref_blockwise
from repro_torch.kernels import flash_attention
from repro_torch.models.layers import blockwise_attention, blockwise_attention_fwd_only

torch.set_num_threads(2)

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=3e-2, atol=3e-2)


def _qkv(seed, b, s, h, hd, sk=None):
    rng = np.random.default_rng(seed)
    sk = s if sk is None else sk
    return (rng.standard_normal((b, s, h, hd)).astype(np.float32),
            rng.standard_normal((b, sk, h, hd)).astype(np.float32),
            rng.standard_normal((b, sk, h, hd)).astype(np.float32))


def _port(fn, arrays, dtype=torch.float32, **kw):
    return fn(*(torch.from_numpy(a).to(dtype) for a in arrays), **kw).float().numpy()


# the reference test's grid (tests/test_kernels.py), then head width 256
@pytest.mark.parametrize("s,cq,ck,causal,hd", [
    (64, 32, 32, True, 64), (128, 128, 128, True, 64), (200, 64, 128, False, 64),
    (96, 128, 32, True, 64), (33, 16, 16, True, 64),
    (200, 64, 128, True, 256), (33, 16, 16, False, 256),
])
def test_flash_attention_matches_the_reference_kernel_and_oracle(s, cq, ck, causal, hd):
    q, k, v = _qkv(s + hd, 2, s, 3, hd)
    got = _port(flash_attention, (q, k, v), causal=causal)
    kernel = np.asarray(ref_flash(q, k, v, causal=causal, cq=cq, ck=ck, interpret=True))
    oracle = np.asarray(ref_blockwise(q, k, v, causal=causal, chunk=64))
    np.testing.assert_allclose(got, kernel, **F32)
    np.testing.assert_allclose(got, oracle, **F32)
    # the model's entry point is the same function
    np.testing.assert_allclose(_port(blockwise_attention, (q, k, v), causal=causal), got,
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_dtypes(dtype):
    q, k, v = _qkv(0, 1, 128, 2, 32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    got = _port(flash_attention, (q, k, v), dtype=dtype, causal=True)
    want = np.asarray(ref_flash(jq, jk, jv, causal=True, interpret=True), np.float32)
    oracle = np.asarray(ref_blockwise(jq, jk, jv, causal=True, chunk=128), np.float32)
    tol = BF16 if dtype == torch.bfloat16 else F32
    np.testing.assert_allclose(got, want, **tol)
    np.testing.assert_allclose(got, oracle, **tol)


@pytest.mark.parametrize("s,chunk,causal", [(64, 16, True), (100, 32, True), (100, 32, False),
                                            (33, 512, True)])
def test_blockwise_oracle_matches_the_reference(s, chunk, causal):
    q, k, v = _qkv(s + chunk, 2, s, 3, 64)
    want = np.asarray(ref_blockwise(q, k, v, causal=causal, chunk=chunk))
    np.testing.assert_allclose(
        _port(blockwise_attention_fwd_only, (q, k, v), causal=causal, chunk=chunk), want, **F32)
    np.testing.assert_allclose(_port(flash_attention, (q, k, v), causal=causal), want, **F32)


def test_flash_attention_with_fewer_queries_than_keys():
    """Full attention of 24 queries over 150 keys: the cross-attention shape
    (the reference's ``cross_attention_blockwise``)."""
    q, k, v = _qkv(5, 2, 24, 3, 64, sk=150)
    want = np.asarray(ref_blockwise(q, k, v, causal=False, chunk=32))
    np.testing.assert_allclose(_port(flash_attention, (q, k, v), causal=False), want, **F32)


def test_flash_attention_refuses_mismatched_shapes():
    q = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="must be"):
        flash_attention(q, torch.zeros(1, 8, 2, 64), torch.zeros(1, 9, 2, 64))
    for kv in ((1, 8, 3, 64), (1, 8, 2, 32)):
        with pytest.raises(ValueError, match="differ"):
            flash_attention(q, torch.zeros(kv), torch.zeros(kv))
