"""The plain versions of the port's three core kernels (``hidden_proj``,
``matmul_atb``, ``rank1_add``) against the reference's Pallas kernels in
interpret mode and against their ``kernels/ref.py`` oracles, on the CPU,
over the shape sweep of ``tests/test_kernels.py``.

Bounds: f32 at rtol 1e-5 with an absolute floor of 1e-5 × max |want|
(the products sum in another order than the reference's 128-wide tiles,
so an output near zero keeps an error of the size of the large ones; the
reference holds itself at 1e-3); bf16 inputs at the reference's 2e-2
(both widen bf16 to f32 exactly and differ only in the order of the
sums). ``rank1_add`` is held bit for bit: both round s·u, then one fused
multiply-add.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import hidden_proj as ref_hidden_proj
from repro.kernels import matmul_atb as ref_matmul_atb
from repro.kernels import rank1_add as ref_rank1_add
from repro.kernels import uv_accum as ref_uv_accum
from repro.kernels.ref import atb_ref, hidden_proj_ref, rank1_add_ref
from repro_torch.core.activations import ACTIVATION_CODES
from repro_torch.kernels import (
    hidden_proj,
    hidden_proj_plain,
    matmul_atb,
    matmul_atb_plain,
    rank1_add,
    rank1_add_plain,
    uv_accum,
)

torch.set_num_threads(2)

SHAPES_MM = [
    (8, 16, 8),
    (64, 64, 64),
    (128, 128, 128),
    (200, 150, 100),
    (256, 384, 128),
    (33, 257, 129),
    (1, 561, 128),     # the k=1 step's projection at the har width
]
DTYPES = ["float32", "bfloat16"]


def _rnd(seed, shape, dtype):
    """The same values for both packages: f32 normals, rounded to bf16 by
    each package's own cast (both round to nearest even)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))


def _close(got, want, dtype):
    got = got.numpy()
    want = np.asarray(want, np.float32)
    if dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("m,k,n", SHAPES_MM)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ["sigmoid", "identity", "relu"])
def test_hidden_proj_plain_matches_reference(m, k, n, dtype, act):
    xj, xt = _rnd(1, (m, k), dtype)
    aj, at = _rnd(2, (k, n), dtype)
    bj, bt = _rnd(3, (n,), dtype)
    got = hidden_proj_plain(xt, at, bt, activation=act)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    _close(got, ref_hidden_proj(xj, aj, bj, activation=act, interpret=True), dtype)
    _close(got, hidden_proj_ref(xj, aj, bj, act), dtype)


@pytest.mark.parametrize("act", sorted(ACTIVATION_CODES))
def test_hidden_proj_every_activation(act):
    """All six activations of the registry, with leading axes, through the
    dispatching wrapper (CPU tensors take the plain version)."""
    xj, xt = _rnd(4, (3, 7, 37), "float32")
    aj, at = _rnd(5, (37, 19), "float32")
    bj, bt = _rnd(6, (19,), "float32")
    got = hidden_proj(xt, at, bt, activation=act)
    assert got.shape == (3, 7, 19)
    want = hidden_proj_ref(xj.reshape(21, 37), aj, bj, act).reshape(3, 7, 19)
    _close(got, want, "float32")
    with pytest.raises(ValueError, match="activation"):
        hidden_proj(xt, at, bt, activation="swish")


@pytest.mark.parametrize("k,n1,n2", SHAPES_MM + [(128, 1, 128), (512, 128, 561)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_matmul_atb_plain_matches_reference(k, n1, n2, dtype):
    aj, at = _rnd(7, (k, n1), dtype)
    bj, bt = _rnd(8, (k, n2), dtype)
    got = matmul_atb_plain(at, bt)
    assert got.dtype == torch.float32 and got.shape == (n1, n2)
    _close(got, ref_matmul_atb(aj, bj, interpret=True), dtype)
    _close(got, atb_ref(aj, bj), dtype)


def test_matmul_atb_batches_leading_axes():
    """A fleet's Eq. 13 boot: one product per device."""
    aj, at = _rnd(9, (3, 50, 12), "float32")
    bj, bt = _rnd(10, (3, 50, 20), "float32")
    got = matmul_atb(at, bt)
    assert got.shape == (3, 12, 20)
    for d in range(3):
        _close(got[d], atb_ref(aj[d], bj[d]), "float32")
    with pytest.raises(ValueError, match="leading axes"):
        matmul_atb(at, bt[:2])


@pytest.mark.parametrize("k,n", [(50, 40), (128, 128), (300, 64), (64, 300)])
def test_uv_accum_matches_reference(k, n):
    hj, ht = _rnd(11, (k, n), "float32")
    tj, tt = _rnd(12, (k, 24), "float32")
    u, v = uv_accum(ht, tt)
    ru, rv = ref_uv_accum(hj, tj, interpret=True)
    _close(u, ru, "float32")
    _close(v, rv, "float32")


@pytest.mark.parametrize("n1,n2", [(16, 16), (128, 128), (100, 60), (257, 129), (8, 512),
                                   (128, 561)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rank1_add_plain_is_bit_exact_with_reference(n1, n2, dtype):
    xj, xt = _rnd(13, (n1, n2), dtype)
    uj, ut = _rnd(14, (n1,), dtype)
    vj, vt = _rnd(15, (n2,), dtype)
    got = rank1_add_plain(xt, ut, vt, -0.37)
    want = np.asarray(ref_rank1_add(xj, uj, vj, -0.37, interpret=True))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    _close(got, rank1_add_ref(xj, uj, vj, -0.37), dtype)


def test_rank1_add_takes_a_tensor_scale():
    """The k=1 step passes −1/denom as a 0-d f32 tensor; it rounds as the
    same value passed as a float."""
    xj, xt = _rnd(16, (33, 40), "float32")
    uj, ut = _rnd(17, (33,), "float32")
    vj, vt = _rnd(18, (40,), "float32")
    denom = torch.tensor(3.7, dtype=torch.float32)
    got = rank1_add(xt, ut, vt, -1.0 / denom)
    want = np.asarray(ref_rank1_add(xj, uj, vj, -1.0 / jnp.float32(3.7), interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, rank1_add(xt, ut, vt, float(-1.0 / denom)))
    with pytest.raises(ValueError, match="rank1_add"):
        rank1_add(xt, vt, vt, 1.0)
