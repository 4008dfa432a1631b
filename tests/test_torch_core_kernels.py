"""The plain versions of the port's three core kernels (``hidden_proj``,
``matmul_atb``, ``rank1_add``) against the reference's Pallas kernels in
interpret mode and against their ``kernels/ref.py`` oracles, on the CPU,
over the shape sweep of ``tests/test_kernels.py``; and ``split_plan``, the
cut of the contracted axis that the CUDA ``matmul_atb`` (samples) and
``hidden_proj`` (features) sum side by side.

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
from repro_torch.kernels.matmul_atb import split_plan

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


# (samples a slice, slices) of the split kernel for U = HᵀH (n2 = 128) and
# V = HᵀX (n2 = 561) at Ñ = 128, one device or eight: slices of at least 64
# samples until the grid (32 × 64 tiles × slices × batch) nears 264 blocks
SPLITS = {
    (1, 1): ((16, 1), (16, 1)), (1, 8): ((16, 1), (16, 1)),
    (17, 1): ((32, 1), (32, 1)), (17, 8): ((32, 1), (32, 1)),
    (512, 1): ((64, 8), (64, 8)), (512, 8): ((512, 1), (112, 5)),
    (513, 1): ((80, 7), (64, 9)), (513, 8): ((528, 1), (112, 5)),
    (4097, 1): ((528, 8), (128, 33)), (4097, 8): ((4112, 1), (832, 5)),
}


@pytest.mark.parametrize("k,batch", sorted(SPLITS))
@pytest.mark.parametrize("n2", [561, 128])
def test_split_plan_puts_every_sample_in_one_slice(k, batch, n2):
    length, slices, ws = split_plan(batch, k, 128, n2)
    assert (length, slices) == SPLITS[k, batch][n2 == 128]
    assert length % 16 == 0
    covered = [i for s in range(slices) for i in range(s * length, min((s + 1) * length, k))]
    assert covered == list(range(k))                    # each sample once, in slice order
    assert all(s * length < k for s in range(slices))   # no empty slice
    # one f32 partial product per slice and device, none when one slice
    # writes the output itself
    assert ws == (batch * slices * 128 * n2 if slices > 1 else 0)


def test_split_plan_at_the_har_width():
    """E²LM statistics of 512 samples: 8 slices of 64 samples."""
    assert split_plan(1, 512, 128, 128) == (64, 8, 8 * 128 * 128)  # 4 × 2 tiles: 64 blocks
    assert split_plan(1, 512, 128, 561) == (64, 8, 8 * 128 * 561)  # 4 × 9 tiles: 288 blocks


@pytest.mark.parametrize("n1", [1, 2, 4])
def test_split_plan_leaves_four_rows_or_fewer_to_the_skinny_kernel(n1):
    for batch, k in ((1, 128), (8, 4097)):
        assert split_plan(batch, k, n1, 561) == (k, 1, 0)
    assert split_plan(1, 128, 5, 128) == (64, 2, 2 * 5 * 128)
    # hidden_proj's k=1 shape (x n1 × 561 · α 561 × 128) goes to its k=1
    # kernel, which cuts K across a cluster of blocks itself
    assert split_plan(1, 561, n1, 128) == (561, 1, 0)


# (columns of x a slice, slices) of hidden_proj's split kernel for
# x (m, k)·α (k, 128): slices of at least 64 columns until the grid nears
# 264 blocks; a K shorter than one slice, or rows enough to fill the card
# alone (the fleet ingest's 8 192), is one slice with the epilogue in place
PROJ_SPLITS = {
    (5, 40): (48, 1), (5, 100): (64, 2), (5, 561): (64, 9),
    (33, 40): (48, 1), (33, 257): (64, 5), (33, 561): (64, 9),
    (512, 100): (64, 2), (512, 561): (64, 9), (513, 561): (80, 8),
    (8192, 561): (576, 1),
}


@pytest.mark.parametrize("m,k", sorted(PROJ_SPLITS))
def test_split_plan_for_hidden_proj_puts_every_column_in_one_slice(m, k):
    length, slices, ws = split_plan(1, k, m, 128)
    assert (length, slices) == PROJ_SPLITS[m, k]
    assert length % 16 == 0
    covered = [i for s in range(slices) for i in range(s * length, min((s + 1) * length, k))]
    assert covered == list(range(k))                    # each column of x once, in slice order
    assert all(s * length < k for s in range(slices))   # no empty slice
    assert ws == (slices * m * 128 if slices > 1 else 0)


def test_split_plan_for_hidden_proj_at_the_har_width():
    """E²LM statistics of 512 samples, x 512 × 561 · α 561 × 128: 16 × 2
    tiles of 32 × 64 and 9 slices of 64 features, 288 blocks."""
    assert split_plan(1, 561, 512, 128) == (64, 9, 9 * 512 * 128)


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
