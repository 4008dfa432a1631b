"""The port's attention backward against the reference's, on the CPU.

``flash_attention_bwd_plain`` (the backward kernel's plain version, which
``FlashAttention`` runs on CPU tensors) is held to the reference's custom
VJP, ``models/layers.py::_fa_backward_impl`` fed its own forward's
statistics, and to ``jax.grad`` of ``blockwise_attention``: causal and
not, Sq ≠ Sk, lengths off the 64-key tile and off the reference's chunk,
head widths 16 and 80, and GQA (the kv heads repeated by
``_expand_kv`` in the reference and ``repeat_interleave`` in the port,
their gradients summed by autograd), and past hd 256 (320 and 512, the
widths of the card's wide pair). Bound: each gradient within 1e-5 of
its own largest magnitude (f32 in both, the products summed in other
orders; ``-s`` prints the measured spread), the forward's row statistics
m within 1e-6 and l within 1e-5 of theirs. ``torch.autograd.gradcheck``
holds the Function in f64 at a tiny size. On the card's branch (reached
through ``_lib.on_cpu``, the wrappers' dispatch seam) an operand that
requires a gradient is refused by every wrapper that calls
``_lib.operands`` outside a Function, while ``flash_attention`` and
``gla_forward`` go to their kernels and raise with no fallback where the
kernels cannot be loaded.

With bf16 operands the plain version takes the bf16 kernels' two
roundings, p and ds to bf16 before the products they enter, and no
others: it is held to a numpy rendering of that arithmetic, and to the
reference's own run on the same bf16 inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import _expand_kv, _fa_backward_impl, _fa_forward
from repro.models.layers import blockwise_attention as ref_attention
from repro_torch.kernels import _lib
from repro_torch.kernels.flash_attn import (
    FlashAttention,
    _bwd_plain,
    flash_attention,
    flash_attention_bwd_plain,
    flash_attention_plain,
)
from repro_torch.kernels.gla_scan import GLAForward, gla_forward

torch.set_num_threads(2)

GRAD_REL = 1e-5
M_REL, L_REL = 1e-6, 1e-5

# (B, Sq, Sk, H, KV, hd, causal, the reference's chunk)
CASES = [
    (2, 64, 64, 2, 2, 16, True, 32),
    (2, 70, 70, 2, 1, 16, True, 64),      # off the tile, GQA
    (1, 33, 130, 3, 3, 16, False, 64),    # Sq ≠ Sk (cross attention), both off the tile
    (2, 96, 96, 4, 2, 80, True, 512),     # an untiled width, the reference's default chunk
    (1, 130, 40, 2, 2, 16, True, 32),     # causal with Sq > Sk
    (1, 100, 100, 2, 2, 16, False, 48),
    # past hd 256, the widths of the card's wide pair
    (1, 40, 40, 2, 2, 320, True, 32),     # causal self-attention
    (1, 20, 70, 2, 2, 512, False, 64),    # Sq ≠ Sk, not causal
    (1, 70, 70, 2, 1, 320, True, 64),     # GQA, off the tile
]


def _inputs(seed, b, sq, sk, h, kv, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, sk, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, sk, kv, hd)).astype(np.float32)
    dout = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    return q, k, v, dout


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.detach().float().numpy() - want).max() / np.abs(want).max())


def _unchunk(stat, sq):
    """The reference's chunked statistics (nq, B, H, cq) as (B, H, Sq)."""
    s = np.asarray(stat)
    nq, b, h, cq = s.shape
    return s.transpose(1, 2, 0, 3).reshape(b, h, nq * cq)[:, :, :sq]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_backward_matches_the_reference_vjp(case):
    b, sq, sk, h, kv, hd, causal, chunk = case
    q, k, v, dout = _inputs(sum(case[:6]), b, sq, sk, h, h, hd)
    out_r, (m_c, l_c) = _fa_forward(q, k, v, causal, chunk)
    want = _fa_backward_impl(q, k, v, out_r, m_c, l_c, dout, causal=causal, chunk=chunk)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    out, m, l = flash_attention_plain(*t, causal=causal, stats=True)
    got = flash_attention_bwd_plain(*t, out, torch.from_numpy(dout), m, l, causal=causal)
    m_rel = float(np.abs(m.numpy() - _unchunk(m_c, sq)).max() / np.abs(m.numpy()).max())
    l_rel = _rel(l, _unchunk(l_c, sq))
    rels = [_rel(g, w) for g, w in zip(got, want)]
    print(f"{case}: dq, dk, dv {rels} (bound {GRAD_REL}); m {m_rel:.2e}, l {l_rel:.2e}")
    assert m_rel <= M_REL and l_rel <= L_REL
    assert all(r <= GRAD_REL for r in rels), rels


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_function_gradients_match_jax_grad(case):
    """The model's path: kv heads repeated to H, then the Function; the
    gradients of q and of the unrepeated k and v against jax.grad of the
    reference's blockwise_attention (its custom VJP) on the same loss."""
    b, sq, sk, h, kv, hd, causal, chunk = case
    q, k, v, dout = _inputs(sum(case[:6]) + 1, b, sq, sk, h, kv, hd)

    def ref_loss(q, k, v):
        g = h // kv
        o = ref_attention(q, _expand_kv(k, g), _expand_kv(v, g), causal=causal, chunk=chunk)
        return jnp.sum(o * dout)

    want = jax.grad(ref_loss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    o = flash_attention(tq, torch.repeat_interleave(tk, h // kv, dim=2),
                        torch.repeat_interleave(tv, h // kv, dim=2), causal=causal)
    assert o.grad_fn is not None and "FlashAttention" in type(o.grad_fn).__name__
    got = torch.autograd.grad((o * torch.from_numpy(dout)).sum(), (tq, tk, tv))
    rels = [_rel(g, w) for g, w in zip(got, want)]
    print(f"{case}: dq, dk, dv against jax.grad {rels} (bound {GRAD_REL})")
    assert all(r <= GRAD_REL for r in rels), rels


@pytest.mark.parametrize("causal", [True, False])
def test_gradcheck_in_f64(causal):
    gen = torch.Generator().manual_seed(3)
    q = torch.randn((1, 5, 2, 4), generator=gen, dtype=torch.float64, requires_grad=True)
    k = torch.randn((1, 7, 2, 4), generator=gen, dtype=torch.float64, requires_grad=True)
    v = torch.randn((1, 7, 2, 4), generator=gen, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda a, b, c: FlashAttention.apply(a, b, c, causal),
                                    (q, k, v))


def test_no_gradient_keeps_the_forward_as_it_was():
    """Without a gradient to take there is no Function: the output is the
    plain forward's, bit for bit, and has no grad_fn."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(9, 1, 20, 20, 2, 2, 16))
    out = flash_attention(q, k, v)
    assert out.grad_fn is None and torch.equal(out, flash_attention_plain(q, k, v))
    with torch.no_grad():
        assert flash_attention(q.requires_grad_(True), k, v).grad_fn is None


def test_card_branch_refuses_gla_gradients(monkeypatch):
    """gla_forward's kernels have a backward now: on the card's branch an
    operand that requires a gradient goes through GLAForward to the kernels,
    so the missing library is what raises, never NotImplementedError; with
    no gradient to take it goes to the kernel as before."""
    monkeypatch.setattr(_lib, "on_cpu", lambda t: False)
    monkeypatch.setattr(_lib, "library", _no_library)
    q = torch.zeros((1, 4, 2, 8), requires_grad=True)
    k, v, log_a = torch.zeros((1, 4, 2, 8)), torch.zeros((1, 4, 2, 8)), torch.zeros((1, 4, 2))
    calls = []
    monkeypatch.setattr(GLAForward, "forward", _recording(GLAForward.forward, calls))
    with pytest.raises(_NoLibrary):
        gla_forward(q, k, v, log_a)
    with pytest.raises(_NoLibrary):
        gla_forward(q.detach(), k, v, log_a.requires_grad_(True))
    assert len(calls) == 2
    with torch.no_grad(), pytest.raises(_NoLibrary):  # no gradient: on to the kernel
        gla_forward(q, k, v, log_a)
    assert len(calls) == 2


def _recording(fn, calls):
    def forward(ctx, *args):
        calls.append(args)
        return fn(ctx, *args)
    return staticmethod(forward)


def test_operands_refuse_an_operand_that_requires_a_gradient():
    x = torch.zeros((2, 3), requires_grad=True)
    with pytest.raises(NotImplementedError, match="hidden_proj.*no backward"):
        _lib.operands("hidden_proj", x=x)
    with torch.no_grad():
        assert _lib.operands("hidden_proj", x=x)[0] is x


class _NoLibrary(RuntimeError):
    pass


def _no_library():
    raise _NoLibrary("the kernels cannot be loaded")


def test_card_branch_of_flash_goes_to_its_kernel_with_no_fallback(monkeypatch):
    monkeypatch.setattr(_lib, "on_cpu", lambda t: False)
    monkeypatch.setattr(_lib, "library", _no_library)
    q = torch.zeros((1, 4, 2, 8), requires_grad=True)
    k = v = torch.zeros((1, 4, 2, 8))
    with pytest.raises(_NoLibrary):
        flash_attention(q, k, v)
    with torch.no_grad(), pytest.raises(_NoLibrary):
        flash_attention(q, k, v)


# ------------------------------------------------- bf16: the rounding points

# off the tile (GQA in CASES, repeated here), Sq ≠ Sk, an untiled width, and
# hd 320 (the wide pair's rounding points)
BF16_CASES = [CASES[1], CASES[2], CASES[3], CASES[6]]
BF16_REL = 1e-6


def _bf16(x: np.ndarray) -> np.ndarray:
    """f32 rounded to the nearest bf16, ties to even, as f32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return u.astype(np.uint32).view(np.float32)


def _render(q, k, v, out, dout, m, l, causal, round_p, round_ds):
    """The backward's arithmetic in numpy f32, (B, S, H, hd) in and out: f32
    sums, exp in f64 rounded once to f32, p and ds rounded to bf16 where
    asked."""
    q, k, v, out, dout = (np.ascontiguousarray(x.transpose(0, 2, 1, 3)) for x in
                          (q, k, v, out, dout))
    sq, hd, sk = q.shape[2], q.shape[3], k.shape[2]
    scale = np.float32(hd ** -0.5)
    delta = (dout * out).sum(-1)
    s = np.matmul(q, k.transpose(0, 1, 3, 2)) * scale
    if causal:
        s = np.where(np.arange(sk)[None, :] <= np.arange(sq)[:, None], s, np.float32(-1e30))
    p = np.exp((s - m[..., None]).astype(np.float64)).astype(np.float32)
    p = p / np.maximum(l, np.float32(1e-30))[..., None]
    ds = p * (np.matmul(dout, v.transpose(0, 1, 3, 2)) - delta[..., None]) * scale
    p = _bf16(p) if round_p else p
    ds = _bf16(ds) if round_ds else ds
    grads = np.matmul(ds, k), np.matmul(ds.transpose(0, 1, 3, 2), q), \
        np.matmul(p.transpose(0, 1, 3, 2), dout)
    return [g.transpose(0, 2, 1, 3) for g in grads]


@pytest.mark.parametrize("case", BF16_CASES, ids=lambda c: "-".join(map(str, c)))
def test_bf16_plain_backward_rounds_p_and_ds_only(case):
    """Operands on a grid of eighths in [-2, 2], so that every score, dp and
    δ is exact in f32 whatever the order of its sum, and the f32 values that
    meet a bf16 rounding are the same bits in both: the plain version's
    gradients (before their own rounding to bf16) equal the rendering with
    p and ds rounded within 1e-6 of each gradient's largest magnitude, and
    miss the renderings with one rounding or none by far more."""
    b, sq, sk, h, _, hd, causal, _ = case
    rng = np.random.default_rng(sum(case[:6]) + 2)
    q, out, dout = (rng.integers(-16, 17, (b, sq, h, hd)).astype(np.float32) / 8
                    for _ in range(3))
    k, v = (rng.integers(-16, 17, (b, sk, h, hd)).astype(np.float32) / 8 for _ in range(2))
    t = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, out, dout)]
    _, m, l = flash_attention_plain(*t[:3], causal=causal, stats=True)
    got = _bwd_plain(*t, m, l, causal)
    assert all(g.dtype == torch.float32 for g in got)
    rounded = flash_attention_bwd_plain(*t, m, l, causal=causal)
    assert all(torch.equal(r, g.to(torch.bfloat16)) for r, g in zip(rounded, got))
    args = (q, k, v, out, dout, m.numpy(), l.numpy(), causal)
    rels = {pd: [_rel(g, w) for g, w in zip(got, _render(*args, *pd))]
            for pd in ((True, True), (True, False), (False, True), (False, False))}
    print(f"{case}: dq, dk, dv against the rendering with p and ds rounded "
          f"{rels[True, True]} (bound {BF16_REL}); p only {rels[True, False]}, ds only "
          f"{rels[False, True]}, neither {rels[False, False]}")
    assert all(r <= BF16_REL for r in rels[True, True]), rels
    assert max(rels[True, False]) > 100 * BF16_REL and max(rels[False, True]) > 100 * BF16_REL
    assert max(rels[False, False]) > 100 * BF16_REL
    # one operand in f32: no rounding (the kernels then compute in f32)
    mixed = _bwd_plain(*t[:3], t[3].float(), t[4], m, l, causal)
    unrounded = _render(*args, False, False)
    assert all(_rel(g, w) <= BF16_REL for g, w in zip(mixed, unrounded))


@pytest.mark.parametrize("case", BF16_CASES, ids=lambda c: "-".join(map(str, c)))
def test_bf16_plain_backward_matches_the_reference_in_bf16(case):
    """The reference's custom VJP on bf16 inputs (it rounds s to bf16 and
    keeps p and ds in f32) against the plain version on the same bf16
    values and the reference's own forward statistics. Bound: twice the
    reference's spread between that run and its run on the same values cast
    to f32. Both of its runs end in its own rounding of the gradients (to
    bf16, to f32), so the plain version's gradients are held to it before
    their final rounding to bf16, which would count that step twice. The
    gradients that callers receive, after that rounding, are held to the
    same bound plus the rounding's own budget: half a bf16 step of the
    binade of the gradient's largest magnitude."""
    b, sq, sk, h, _, hd, causal, chunk = case
    q, k, v, dout = (jnp.asarray(x, jnp.bfloat16) for x in _inputs(sum(case[:6]), b, sq, sk,
                                                                    h, h, hd))
    out, (m_c, l_c) = _fa_forward(q, k, v, causal, chunk)
    ref = _fa_backward_impl(q, k, v, out, m_c, l_c, dout, causal=causal, chunk=chunk)
    f32 = [x.astype(jnp.float32) for x in (q, k, v, out, dout)]
    ref_f32 = _fa_backward_impl(*f32[:4], m_c, l_c, f32[4], causal=causal, chunk=chunk)
    spread = [_rel(torch.from_numpy(np.array(a, np.float32)), w) for a, w in zip(ref, ref_f32)]
    t = [torch.from_numpy(np.array(x)).to(torch.bfloat16) for x in f32]
    m, l = (torch.tensor(_unchunk(s, sq)) for s in (m_c, l_c))
    got = _bwd_plain(*t, m, l, causal)
    rels = [_rel(g, np.asarray(w, np.float32)) for g, w in zip(got, ref)]
    shipped = flash_attention_bwd_plain(*t, m, l, causal=causal)
    shipped_rels = [_rel(g, np.asarray(w, np.float32)) for g, w in zip(shipped, ref)]
    half_steps = [float(np.ldexp(1.0, np.frexp(float(g.abs().max()))[1] - 9))
                  / float(np.abs(np.asarray(w, np.float32)).max()) for g, w in zip(got, ref)]
    print(f"{case}: dq, dk, dv against the reference in bf16 {rels}; its own bf16-f32 spread "
          f"{spread} (bound twice that); rounded to bf16 {shipped_rels} (bound twice the "
          f"spread plus half a bf16 step {half_steps})")
    assert all(r <= 2 * s for r, s in zip(rels, spread)), (rels, spread)
    assert all(r <= 2 * s + e for r, s, e in zip(shipped_rels, spread, half_steps)), \
        (shipped_rels, spread, half_steps)
