"""The operands the kernel wrappers hand their kernels, on the CPU.

``_lib.operands`` is what every wrapper calls on its CUDA branch: a strided
operand comes back contiguous, a mix of floating types (bf16 with f32,
f16, f64) comes back as f32, the type the reference computes it in, and
operands all of one type the kernel takes keep it. The plain versions,
which the card is held to, compute the same mixes in f32: each is held
here to itself on the operands cast to f32 and made contiguous, bit for
bit (a widening to f32 is exact). And each is held, on the same mixed and
strided operands, to the reference's Pallas kernel in interpret mode,
which takes them too, at the f32 bound (1e-6 of the output's largest
value; 0 for the integer codes). The two Gauss-Jordan solves are held to
the jnp sweep of ``tests/test_torch_topology_merge.py`` instead, since the
port leaves the pivot row out of its own step where the reference's kernel
updates it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as ref
from repro.kernels.topology_merge import (
    banded_mix as ref_banded_mix,
    dense_mix as ref_dense_mix,
    masked_segment_sum_mix as ref_masked_segment_sum_mix,
    segment_broadcast as ref_segment_broadcast,
    segment_sum_mix as ref_segment_sum_mix,
)

from repro_torch.kernels import (
    _lib,
    banded_merge_solve_plain,
    banded_mix_plain,
    dense_mix_plain,
    flash_attention_plain,
    from_uv_solve_plain,
    gla_forward_plain,
    hidden_proj_plain,
    k1_update_plain,
    masked_segment_sum_mix_plain,
    matmul_atb_plain,
    quantize_pack_plain,
    rank1_add_plain,
    robust_segment_sum_mix_plain,
    segment_broadcast_plain,
    segment_sum_mix_plain,
)
from repro_torch.kernels.flash_attn import KV_TILE

from test_torch_topology_merge import jnp_banded_merge_solve, jnp_gj_solve

torch.set_num_threads(2)

BF16, F16, F32, F64 = torch.bfloat16, torch.float16, torch.float32, torch.float64


def _t(*shape, seed=0, dtype=F32):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32)).to(dtype)


def test_a_strided_operand_comes_back_contiguous():
    x = _t(4, 6).t()
    (got,) = _lib.operands("k", x=x)
    assert got.is_contiguous() and torch.equal(got, x)
    dense = _t(4, 6)
    assert _lib.operands("k", x=dense)[0] is dense  # nothing to do: no copy


def test_unit_last_keeps_a_column_slice_and_copies_a_strided_row():
    w = _t(3, 5, 9)
    u = w[:, :, :5]
    assert _lib.operands("k", unit_last=True, u=u)[0] is u
    (got,) = _lib.operands("k", unit_last=True, u=u.transpose(1, 2))
    assert got.stride(-1) == 1 and torch.equal(got, u.transpose(1, 2))


@pytest.mark.parametrize("kinds,dtypes,want", [
    ((BF16, F32), _lib.F32_BF16, F32),
    ((F32, BF16, F32), _lib.F32_BF16, F32),
    ((BF16, BF16), _lib.F32_BF16, BF16),
    ((F32, F32), _lib.F32_BF16, F32),
    ((BF16, BF16), _lib.F32, F32),
    ((F16, F16), _lib.F32_BF16, F32),
    ((F16, BF16), _lib.F32_BF16, F32),
    ((F64,), _lib.F32, F32),
    ((F64, F32), _lib.F32, F32),
])
def test_mixed_types_come_back_as_the_reference_computes_them(kinds, dtypes, want):
    ts = {f"t{i}": _t(2, 3, seed=i, dtype=k) for i, k in enumerate(kinds)}
    got = _lib.operands("k", dtypes, **ts)
    assert [g.dtype for g in got] == [want] * len(kinds)
    for g, t in zip(got, ts.values()):
        assert torch.equal(g, t.to(want))


@pytest.mark.parametrize("bad", [torch.int32, torch.int64, torch.bool, torch.complex64])
def test_a_non_floating_operand_still_raises(bad):
    with pytest.raises(TypeError, match="floating-point"):
        _lib.operands("k", _lib.F32_BF16, x=_t(2, 3), y=torch.zeros(2, 3, dtype=bad))


def test_an_operand_on_another_device_raises():
    with pytest.raises(ValueError, match="meta"):
        _lib.operands("k", x=_t(2, 3), y=torch.empty(2, 3, device="meta"))


def _mixes(*tensors):
    """The operands as a caller may pass them: every other one bf16 (a lone
    one too), the first one strided (a transposed copy transposed back)."""
    out = [t.to(BF16) if i % 2 or len(tensors) == 1 else t for i, t in enumerate(tensors)]
    out[0] = out[0].transpose(-1, -2).contiguous().transpose(-1, -2)
    assert not out[0].is_contiguous()
    return out


def _as_f32(*tensors):
    return [t.float().contiguous() for t in tensors]


def _same(got, want):
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _spd(n, s, seed):
    a = _t(s, 2 * n, n, seed=seed)
    return a.transpose(1, 2) @ a + torch.eye(n)


CIDS = np.array([0, 0, 0, 1, 2, 2], np.int32)
PLAIN = {
    "hidden_proj": (lambda x, a, b: hidden_proj_plain(x, a, b), (_t(5, 7), _t(7, 4, seed=1),
                                                                 _t(4, seed=2))),
    "matmul_atb": (matmul_atb_plain, (_t(6, 4), _t(6, 3, seed=1))),
    "rank1_add": (lambda x, u, v: rank1_add_plain(x, u, v, 0.5),
                  (_t(4, 5), _t(4, seed=1), _t(5, seed=2))),
    "k1_update": (k1_update_plain, (_t(4, 4), _t(4, 3, seed=1), _t(4, seed=2), _t(4, seed=3),
                                    _t(3, seed=4))),
    "flash_attention": (flash_attention_plain, (_t(1, 6, 2, 8), _t(1, 6, 2, 8, seed=1),
                                                _t(1, 6, 2, 8, seed=2))),
    "gla_forward": (gla_forward_plain, (_t(1, 6, 2, 4), _t(1, 6, 2, 4, seed=1),
                                        _t(1, 6, 2, 5, seed=2), -_t(1, 6, 2, seed=3).abs())),
    "quantize_pack": (quantize_pack_plain, (_t(3, 4, 4), _t(3, 4, 5, seed=1),
                                            _t(3, 4, 9, seed=2) * 0.01)),
    "banded_mix": (lambda x: banded_mix_plain(x, 1), (_t(5, 3, 4),)),
    "banded_merge_solve": (lambda w: banded_merge_solve_plain(w, 1, ridge=1e-3),
                           (torch.cat([_spd(4, 5, 0), _t(5, 4, 3, seed=1)], 2),)),
    "dense_mix": (lambda x: dense_mix_plain(x, torch.ones(4, 4)), (_t(4, 3, 5),)),
    "from_uv_solve": (lambda u, v: from_uv_solve_plain(u, v, ridge=1e-3),
                      (_spd(4, 2, 3), _t(2, 4, 3, seed=4))),
    "segment_sum_mix": (lambda w: segment_sum_mix_plain(w, CIDS, 3), (_t(6, 3, 4),)),
    "masked_segment_sum_mix": (
        lambda w, m: masked_segment_sum_mix_plain(w, CIDS, m, 3),
        (_t(6, 3, 4), torch.tensor([1.0, 0.0, 1.0, 1.0, 1.0, 0.0]))),
    "segment_broadcast": (lambda s: segment_broadcast_plain(s, CIDS), (_t(3, 4, 5),)),
    "robust_segment_sum_mix": (
        lambda x, m, s: robust_segment_sum_mix_plain(x, CIDS, m, s, 3, 1),
        (_t(6, 3, 4), torch.tensor([1.0, 1.0, 0.0, 1.0, 1.0, 1.0]), torch.full((6,), 0.5))),
}


@pytest.mark.parametrize("name", sorted(PLAIN))
def test_plain_versions_compute_mixed_and_strided_operands_in_f32(name):
    fn, args = PLAIN[name]
    _same(fn(*_mixes(*args)), fn(*_as_f32(*_mixes(*args))))


def test_fleet_ingest_plain_computes_a_bf16_strided_window_in_f32():
    from repro_torch.fleet import init_fleet
    from repro_torch.kernels import fleet_ingest_plain

    x_init = torch.rand((4, 8, 6), generator=torch.Generator().manual_seed(0))
    fleet = init_fleet(torch.Generator().manual_seed(0), 4, 6, 3, x_init,
                       activation="identity", ridge=1e-3, device="cpu")
    window = _t(4, 5, 6).to(BF16)
    got_s, got_l = fleet_ingest_plain(fleet, window)
    want_s, want_l = fleet_ingest_plain(fleet, window.float())
    _same((got_s.p, got_s.beta, got_l), (want_s.p, want_s.beta, want_l))
    # a strided window goes too; PyTorch's product sums it in another order,
    # which the RLS chain amplifies: held at the ingest's bound against its
    # kernel, 1e-4 of each output's largest value (tests/test_torch_gpu.py)
    strided = window.float().transpose(1, 2).contiguous().transpose(1, 2)
    got_s, got_l = fleet_ingest_plain(fleet, strided)
    for g, w in zip((got_s.p, got_s.beta, got_l), (want_s.p, want_s.beta, want_l)):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


def _jax(t):
    """A torch operand as the reference takes it, of the same type."""
    if t.dtype == BF16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _ref_k1_update(p, beta, h, ph, t):
    """The reference's k=1 update (kernels/ops.py::oselm_step_k1_kernel
    after its products): two rank1_add launches."""
    f32 = jnp.float32
    denom = 1.0 + h.astype(f32) @ ph.astype(f32)
    err = t.astype(f32) - h.astype(f32) @ beta.astype(f32)
    return (ref.rank1_add(p, ph, ph, -1.0 / denom, interpret=True),
            ref.rank1_add(beta, ph, err, 1.0 / denom, interpret=True))


REF = {
    "hidden_proj": lambda x, a, b: ref.hidden_proj(x, a, b, interpret=True),
    "matmul_atb": lambda a, b: ref.matmul_atb(a, b, interpret=True),
    "rank1_add": lambda x, u, v: ref.rank1_add(x, u, v, 0.5, interpret=True),
    "k1_update": _ref_k1_update,
    "flash_attention": lambda q, k, v: ref.flash_attention(q, k, v, ck=KV_TILE, interpret=True),
    "gla_forward": lambda q, k, v, la: (ref.gla_forward(q, k, v, la, interpret=True),),
    "quantize_pack": lambda u, v, r: ref.quantize_pack(u, v, r, interpret=True),
    "banded_mix": lambda x: ref_banded_mix(x, 1, interpret=True),
    "banded_merge_solve": lambda w: jnp_banded_merge_solve(w, 1, ridge=1e-3),
    "dense_mix": lambda x: ref_dense_mix(x, jnp.ones((4, 4)), interpret=True),
    "from_uv_solve": lambda u, v: jnp_gj_solve(u, v, ridge=1e-3),
    "segment_sum_mix": lambda w: ref_segment_sum_mix(w, CIDS, 3, interpret=True),
    "masked_segment_sum_mix": lambda w, m: ref_masked_segment_sum_mix(w, CIDS, m, 3,
                                                                      interpret=True),
    "segment_broadcast": lambda s: ref_segment_broadcast(s, jnp.asarray(CIDS), interpret=True),
    "robust_segment_sum_mix": lambda x, m, s: ref.robust_segment_sum_mix(x, CIDS, m, s, 3, 1,
                                                                         interpret=True),
}


def _close_to_ref(got, want, bound=1e-6):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):  # the reference's gla_forward gives no state
        w = np.asarray(w)
        assert g.shape == w.shape
        if w.dtype == np.int8:
            assert g.dtype == torch.int8 and np.array_equal(g.numpy(), w)
        else:
            w = w.astype(np.float32)
            err = float(np.abs(g.float().numpy() - w).max())
            assert err <= bound * float(np.abs(w).max()), err


@pytest.mark.parametrize("name", sorted(PLAIN))
def test_plain_versions_agree_with_the_reference_on_mixed_and_strided_operands(name):
    """The operands of the test above, through the reference. Its segment
    broadcast refuses a bf16 payload (it stores the payload into an f32
    output), so that one gets the strided f32 payload alone."""
    fn, args = PLAIN[name]
    ops = _mixes(*args) if name != "segment_broadcast" else [args[0].mT.contiguous().mT]
    _close_to_ref(fn(*ops), REF[name](*[_jax(o) for o in ops]))


@pytest.mark.parametrize("kinds", [(F16, F16, F16), (F32, F16, F16), (F32, BF16, BF16),
                                   (BF16, F32, F32), (F32, BF16, F32)])
def test_flash_attention_plain_rounds_p_to_v_as_the_reference_does(kinds):
    """q, k and v of mixed types: p is rounded to v's type before p·v and the
    result has q's type, in the plain version as in the reference's kernel
    at the port's tile of keys (p is rounded relative to its tile's max).
    An f32 result at the f32 bound; a narrower one within one step of its
    type (two f32 results a rounding apart may round to neighbours)."""
    q, k, v = (_t(1, 70, 2, 16, seed=10 + i).to(d) for i, d in enumerate(kinds))
    got = flash_attention_plain(q, k, v)
    want = ref.flash_attention(_jax(q), _jax(k), _jax(v), ck=KV_TILE, interpret=True)
    assert got.dtype == q.dtype and str(want.dtype) == str(q.dtype).split(".")[1]
    step = {F32: 1e-6, F16: 2 ** -10, BF16: 2 ** -7}[q.dtype]
    _close_to_ref(got, want.astype(jnp.float32), step)
    if q.dtype == F32 and v.dtype != F32:  # p unrounded would miss the bound
        unrounded = flash_attention_plain(q, k.float(), v.float())
        assert float((unrounded - got).abs().max()) > 1e-6 * float(got.abs().max())


def test_fleet_ingest_plain_agrees_with_the_reference_on_a_bf16_strided_window():
    """A bf16 window, strided, through the plain ingest and the reference's
    kernel in interpret mode, at the ingest's bound against the reference
    (tests/test_torch_fleet_ingest.py: 1e-5 of each output)."""
    import jax

    from repro.fleet import init_fleet as ref_init_fleet
    from repro.kernels.fleet_ingest import fleet_ingest_kernel
    from repro_torch.convert import oselm_state_from_numpy
    from repro_torch.kernels import fleet_ingest_plain

    d, t, f, nh = 5, 9, 11, 6
    rng = np.random.default_rng(0)
    x_init = rng.uniform(0, 1, (d, 4 * nh, f)).astype(np.float32)
    fleet = ref_init_fleet(jax.random.PRNGKey(0), d, f, nh, jnp.asarray(x_init),
                           activation="identity", ridge=1e-3, forget=0.95)
    port = oselm_state_from_numpy(fleet.params.alpha, fleet.params.bias, fleet.beta, fleet.p,
                                  activation=fleet.activation, forget=fleet.forget, device="cpu")
    window = torch.from_numpy(rng.uniform(0, 1, (d, f, t)).astype(np.float32)).to(BF16).mT
    assert not window.is_contiguous()
    want_s, want_l = fleet_ingest_kernel(fleet, _jax(window.contiguous()), block_d=4,
                                         interpret=True)
    got_s, got_l = fleet_ingest_plain(port, window)
    _close_to_ref((got_s.p, got_s.beta, got_l), (want_s.p, want_s.beta, want_l), 1e-5)
