"""Chunked gated-linear-attention forward and backward; port of
``repro.kernels.gla_scan`` and of jax's autodiff of the reference's
``models/ssm.py::chunked_linear_attention``.

``gla_forward`` takes ``gla_forward_plain`` for CPU tensors and launches
the kernels of ``csrc/gla_scan.cu`` for CUDA tensors, or raises. q and k
are (B, S, H, dk), v (B, S, H, dv), f32 or bf16 on the card (a mix, or
another floating type, computes in f32: ``_lib.operands``), and log a
(B, S, H) the per-token log decay; it returns y (B, S, H, dv) in
q's type and the final state (B, H, dk, dv) in f32, which the reference's
kernel drops. Chunks are min(128, S) tokens. On the card one call runs
the chunks in parallel: each chunk's state increment, the carry of the
state through the chunks in order, then each chunk's output (three
launches, one count); where dk × dv needs more shared memory than a block
has (``wide_path``: from 128 × 64 or 96 × 96 on), the same three passes run
over 64 × 64 tiles of the state and 64-column tiles of y, streaming q, k and
the state through shared memory. The plain version repeats the kernels' arithmetic
chunk by chunk: f32 inside, the cumsum of log a sequential in token
order, the gate by select, the carry S·e^{tot} + ΔS, padding with
log a = 0 and zeroed q, k, v; its products are PyTorch's, so the two
agree to f32 rounding, not bit for bit.

Where grad mode is on and q, k, v or log a requires a gradient,
``gla_forward`` is a ``torch.autograd.Function`` (``GLAForward``) on
either device: its forward keeps what the kernels leave in their scratch,
the state entering each chunk and each chunk's e^{tot}, and its backward
is ``gla_backward``, the kernels of ``csrc/gla_scan_bwd.cu`` on the card
(four launches, one count; any dk × dv, no atomics): f32 on the CUDA
cores, bf16 on the tensor cores in strips that ``bwd_plan`` picks, with q,
k, v and dy on rows of a multiple of 8 elements on 16-byte boundaries (a
fifth launch pads or moves them where they are not);
``gla_backward_plain`` on the CPU. It takes the cotangents of y and of the
final state (either may be None) and returns dq, dk, dv and dlog a in
their operands' types: the state's gradient carried from the last chunk
to the first, G_{c−1} = G_c·e^{tot_c} + (q ⊙ e^{cum})ᵀ·dy_c, then each
chunk's dq, dk and dv from its own tokens, S_in and G_c, and dlog a_t =
⟨dS_final, S_final⟩ + Σ_{s ≥ t} (q_s·dq_s − k_s·dk_s), a reverse cumsum
within each chunk and then the later chunks' sums carried in chunk order
(``csrc/gla_scan_bwd.cu``'s header has the formulas). Without a gradient
to take, the forward runs as before. The plain versions compute in f64
where every operand is f64 (so that ``torch.autograd.gradcheck`` can hold
the Function), else in f32; for q, k, v and dy all bf16 the backward
rounds to bf16 where the reference's autodiff does (the scores, P, dP,
dS, each gradient's intra and inter terms) and splits the f32 operand of
each state product into hi and lo, as the tensor-core kernels do.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _lib

__all__ = ["CHUNK", "GLAForward", "bwd_plan", "gla_backward", "gla_backward_plain",
           "gla_forward", "gla_forward_plain", "wide_path"]

CHUNK = 128  # tokens per chunk at most, the kernel's kMaxChunk
STRIP = 64   # dk columns a block of the f32 backward's chunk pass owns (the kernel's kTile)


def _padded(n: int) -> int:
    """A bf16 row's width on the tensor-core route: n rounded up to 8 (16 bytes)."""
    return -(-n // 8) * 8


def bwd_plan(dk: int, dv: int, chunks: int, sms: int) -> tuple[int, int, bool]:
    """(wk, wv, paired) of the bf16 backward's chunk pass at dk × dv over
    ``chunks`` chunks on a card of ``sms`` SMs: its dq/dk strips of wk
    columns, its dv strips of wv, and whether one block takes a dv strip and
    then a dq/dk strip (a chunk's blocks max(na, nb), else na + nb). A
    dq/dk strip holds 72 + 2·wk accumulators a thread during its walk, a dv
    strip 72 + wv: 32 and 64 are the widest that keep two blocks an SM,
    narrower strips recompute the scores or dP more often. Paired where that
    alone fits the grid in one wave of two blocks an SM. Set from the plans
    forced at phase 20 (a)'s shapes on an H100 (the chunk pass alone;
    PERF.md §6, row 17): hymba's 16 × 64 over 400 chunks splits (800
    blocks, 1.07–1.28× faster than paired), the mLSTM's 512 × 513 over 16
    pairs (32 × 64, 256 blocks, 1.16–1.17× faster than split), S 200's 30
    chunks split (1.5×)."""
    dkp, dvp = _padded(dk), _padded(dv)
    wk = 16 if dkp <= 16 else 32
    wv = 32 if dvp <= 32 else 64
    na, nb = -(-dkp // wk), -(-dvp // wv)
    return wk, wv, chunks * (na + nb) > 2 * sms >= chunks * max(na, nb)


@functools.lru_cache(maxsize=8)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def wide_path(dk: int, dv: int) -> bool:
    """Whether the card runs dk × dv on the tiled wide path (the chunk
    kernels' shared memory past a block's)."""
    return _lib.library().repro_gla_smem(dk, dv) > _lib.MAX_SMEM


def _check(q, k, v, log_a) -> None:
    if q.ndim != 4 or k.shape != q.shape or v.ndim != 4 or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"gla_forward: q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be (B, S, H, dk), (B, S, H, dk), (B, S, H, dv)")
    if log_a.shape != q.shape[:3]:
        raise ValueError(f"gla_forward: log_a must be {tuple(q.shape[:3])}, got {tuple(log_a.shape)}")


def _check_bwd(q, k, v, log_a, dy, dstate_final, states, decay, state) -> None:
    _check(q, k, v, log_a)
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    n = -(-s // min(CHUNK, s)) if s else 0
    want = {"dy": (dy, v.shape), "states": (states, (b, h, n, dk, dv)),
            "decay": (decay, (b, h, n))}
    if dstate_final is not None:
        if state is None:
            raise ValueError("gla_backward: a final-state cotangent needs the final state")
        want.update(dstate_final=(dstate_final, (b, h, dk, dv)), state=(state, (b, h, dk, dv)))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"gla_backward: {name} must be {tuple(shape)}, got {tuple(t.shape)}")


def _compute_type(*tensors: torch.Tensor) -> torch.dtype:
    """The plain versions' type: f64 where every operand is f64, else f32."""
    return torch.float64 if all(t.dtype == torch.float64 for t in tensors) else torch.float32


def _sequential_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum over the last axis, one token after the other as
    the kernels' scanning thread adds them (``torch.cumsum`` on the CPU sums
    in f64, on the card in a parallel scan)."""
    out = x.clone()
    for t in range(1, x.shape[-1]):
        out[..., t] = out[..., t - 1] + x[..., t]
    return out


def _chunks(x: torch.Tensor, n: int, c: int, ct: torch.dtype) -> torch.Tensor:
    """(B, S, H, ...) → (B, H, n, c, ...) in ``ct``, zero-padded past S."""
    b, s, h = x.shape[:3]
    x = x.to(ct).transpose(1, 2)
    x = torch.nn.functional.pad(x, (0, 0) * (x.ndim - 3) + (0, n * c - s))
    return x.reshape(b, h, n, c, *x.shape[3:])


def _unchunk(x: torch.Tensor, s: int) -> torch.Tensor:
    """(B, H, n, c, ...) → (B, S, H, ...), the padding cut."""
    b, h, n, c = x.shape[:4]
    return x.reshape(b, h, n * c, *x.shape[4:])[:, :, :s].transpose(1, 2)


def _gates(cum: torch.Tensor) -> torch.Tensor:
    """tril(e^{cum_t − cum_τ}) (..., c, c) by select: an exponent that
    overflows above the diagonal never meets a 0."""
    c = cum.shape[-1]
    tri = torch.ones((c, c), dtype=torch.bool, device=cum.device).tril()
    return torch.where(tri, torch.exp(cum[..., :, None] - cum[..., None, :]), 0.0)


def _forward_plain(q, k, v, log_a):
    """(y, final state, the state entering each chunk (B, H, n, dk, dv),
    each chunk's e^{tot} (B, H, n)), the states in the compute type."""
    _check(q, k, v, log_a)
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    ct = _compute_type(q, k, v, log_a)
    state = torch.zeros((b, h, dk, dv), dtype=ct, device=q.device)
    if s == 0:
        return (torch.empty_like(v, dtype=q.dtype), state,
                torch.zeros((b, h, 0, dk, dv), dtype=ct, device=q.device),
                torch.zeros((b, h, 0), dtype=ct, device=q.device))
    c = min(CHUNK, s)
    n = -(-s // c)
    qc, kc, vc, lac = (_chunks(x, n, c, ct) for x in (q, k, v, log_a))
    cum = _sequential_cumsum(lac)                        # (B, H, n, c)
    gates = _gates(cum)
    ys, states, decays = [], [], []
    for i in range(n):
        qi, ki, vi, cu = qc[:, :, i], kc[:, :, i], vc[:, :, i], cum[:, :, i]
        tot = cu[..., -1]
        states.append(state)
        decays.append(torch.exp(tot))
        y = (qi * torch.exp(cu)[..., None]) @ state
        y = y + ((qi @ ki.transpose(-1, -2)) * gates[:, :, i]) @ vi
        ys.append(y)
        w = torch.exp(tot[..., None] - cu)[..., None]
        state = state * decays[-1][..., None, None] + (ki * w).transpose(-1, -2) @ vi
    y = _unchunk(torch.stack(ys, 2), s)
    return y.to(q.dtype), state, torch.stack(states, 2), torch.stack(decays, 2)


def gla_forward_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_a: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    y, state, _, _ = _forward_plain(q, k, v, log_a)
    return y, state


def _forward(q, k, v, log_a, keep: bool):
    """The forward on q's device: (y, final state), with ``keep`` also the
    state entering each chunk and each chunk's e^{tot}, which the backward
    takes."""
    if _lib.on_cpu(q):
        out = _lib.plain("gla_forward", _forward_plain, q, k, v, log_a)
        return out if keep else out[:2]
    _check(q, k, v, log_a)
    dtype = q.dtype
    q, k, v = _lib.operands("gla_forward", _lib.F32_BF16, q=q, k=k, v=v)
    bf16 = int(q.dtype == torch.bfloat16)
    la = log_a.float().contiguous()
    if la.device != q.device:
        raise ValueError(f"gla_forward: log_a is on {la.device}, q on {q.device}")
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    y = torch.empty(v.shape, dtype=q.dtype, device=q.device)
    state = torch.empty((b, h, dk, dv), dtype=torch.float32, device=q.device)
    c = min(CHUNK, s) if s else 1
    n = -(-s // c)
    # the kernels' scratch: each chunk's state increment, then the state
    # entering it, and each chunk's decay e^{tot}; (B, H, n, dk, dv) f32 is
    # 268 MB at B = 4, S = 2048, H = 4 and xLSTM's dk × dv = 512 × 513
    dstate = torch.empty((b, h, n, dk, dv), dtype=torch.float32, device=q.device)
    decay = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    if s == 0:
        state.zero_()
    else:
        status = _lib.library().repro_gla_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), la.data_ptr(), y.data_ptr(),
            state.data_ptr(), dstate.data_ptr(), decay.data_ptr(), b, s, h, dk, dv, c, bf16,
            _lib.stream(),
        )
        _lib.check(status, "gla_forward")
        _lib.count_launch("gla_forward")
    return (y.to(dtype), state, dstate, decay) if keep else (y.to(dtype), state)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest, ties to even) and back."""
    return x.to(torch.bfloat16).to(x.dtype)


def _split_mm(a: torch.Tensor, b: torch.Tensor, split: str) -> torch.Tensor:
    """a @ b with the f32 operand (``split`` names it: "a" or "b") split
    into hi = bf16(x) and lo = bf16(x − hi), each against the other, exact
    bf16 operand, the two products summed in f32 (the tensor-core kernels'
    state products)."""
    x = a if split == "a" else b
    hi = _bf16(x)
    lo = _bf16(x - hi)
    return (hi @ b + lo @ b) if split == "a" else (a @ hi + a @ lo)


def _bwd_plain(q, k, v, log_a, dy, dstate_final, states, decay, state):
    """(dq, dk, dv, dlog a) (B, S, H, ·) in the compute type, before the
    rounding of dq, dk and dv to their operands' types."""
    _check_bwd(q, k, v, log_a, dy, dstate_final, states, decay, state)
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    ct = _compute_type(q, k, v, log_a, dy)
    if s == 0:
        return tuple(torch.zeros(t.shape, dtype=ct, device=q.device) for t in (q, k, v, log_a))
    # q, k, v and dy all bf16: the reference's bf16 rounding points under
    # autodiff (csrc/gla_scan_bwd.cu's header lists them) and the state
    # products' f32 operand split into hi and lo
    rounded = all(t.dtype == torch.bfloat16 for t in (q, k, v, dy))
    c = min(CHUNK, s)
    n = -(-s // c)
    qc, kc, vc, dyc, lac = (_chunks(x, n, c, ct) for x in (q, k, v, dy, log_a))
    cum = _sequential_cumsum(lac)                         # (B, H, n, c)
    eq = torch.exp(cum)[..., None]
    ew = torch.exp(cum[..., -1:] - cum)[..., None]
    states, decay = states.to(ct), decay.to(ct)
    # the gradient of the state leaving each chunk, from the last
    qe_t = (qc * eq).transpose(-1, -2)
    inc = _split_mm(qe_t, dyc, "a") if rounded else qe_t @ dyc   # ΔG (B, H, n, dk, dv)
    g = (torch.zeros((b, h, dk, dv), dtype=ct, device=q.device) if dstate_final is None
         else dstate_final.to(ct))
    gs = [g] * n
    for i in reversed(range(n)):
        gs[i] = g
        g = g * decay[:, :, i, None, None] + inc[:, :, i]
    gc = torch.stack(gs, 2)
    gates = _gates(cum)
    if rounded:
        p = _bf16(_bf16(qc @ kc.transpose(-1, -2)) * gates)
        dp = _bf16(_bf16(dyc @ vc.transpose(-1, -2)) * gates)
        # each gradient's inter and intra terms, f32 sums before any rounding
        qi, qx = _split_mm(dyc, states.transpose(-1, -2), "b") * eq, dp @ kc
        ki, kx = _split_mm(vc, gc.transpose(-1, -2), "b") * ew, dp.transpose(-1, -2) @ qc
        dq, dk_ = _bf16(qi) + _bf16(qx), _bf16(ki) + _bf16(kx)
        dv_ = _bf16(p.transpose(-1, -2) @ dyc) + _bf16(_split_mm(kc, gc, "b") * ew)
        # dC from the sums before the roundings, as the reference's dlog a
        # takes its f32 terms (its bf16 dP and scores times the f32 gate)
        dq_c, dk_c = qi + qx, ki + kx
    else:
        dp = (dyc @ vc.transpose(-1, -2)) * gates
        dq = (dyc @ states.transpose(-1, -2)) * eq + dp @ kc
        dk_ = dp.transpose(-1, -2) @ qc + (vc @ gc.transpose(-1, -2)) * ew
        dv_ = ((qc @ kc.transpose(-1, -2)) * gates).transpose(-1, -2) @ dyc + (kc @ gc) * ew
        dq_c, dk_c = dq, dk_
    dc = None
    for i0 in range(0, dk, STRIP):
        sl = slice(i0, i0 + STRIP)
        part = (qc[..., sl] * dq_c[..., sl]).sum(-1) - (kc[..., sl] * dk_c[..., sl]).sum(-1)
        dc = part if dc is None else dc + part
    local = _sequential_cumsum(dc.flip(-1)).flip(-1)       # Σ_{s ≥ t} within each chunk
    carry = (torch.zeros((b, h), dtype=ct, device=q.device) if dstate_final is None
             else (dstate_final.to(ct) * state.to(ct)).sum((-2, -1)))
    carries = [carry] * n
    for i in reversed(range(n)):
        carries[i] = carry
        carry = carry + local[:, :, i, 0]
    dla = local + torch.stack(carries, 2)[..., None]
    return _unchunk(dq, s), _unchunk(dk_, s), _unchunk(dv_, s), _unchunk(dla, s)


def gla_backward_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_a: torch.Tensor, dy: torch.Tensor,
    dstate_final: torch.Tensor | None, states: torch.Tensor, decay: torch.Tensor,
    state: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv, dlog a) in q's, k's, v's and log a's types, with the
    kernels' arithmetic chunk by chunk: the state's gradient carried from
    the last chunk (G·e^{tot} + ΔG, product and sum rounded apart), each
    dC_t summed over dk in strips of ``STRIP`` taken in order, its reverse
    cumsum token after token within each chunk, then the chunks' carry from
    ⟨dS_final, S_final⟩ in chunk order from the last; for bf16 q, k, v and
    dy the tensor-core kernels' roundings and hi/lo split; its products
    are PyTorch's."""
    dq, dk_, dv_, dla = _bwd_plain(q, k, v, log_a, dy, dstate_final, states, decay, state)
    return dq.to(q.dtype), dk_.to(k.dtype), dv_.to(v.dtype), dla.to(log_a.dtype)


def gla_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_a: torch.Tensor, dy: torch.Tensor,
    dstate_final: torch.Tensor | None, states: torch.Tensor, decay: torch.Tensor,
    state: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv, dlog a) of ``gla_forward``'s y and final
    state against dy and ``dstate_final`` (None: no cotangent), from the
    forward's ``states`` (the state entering each chunk, (B, H, n, dk, dv))
    and ``decay`` (each chunk's e^{tot}, (B, H, n)), and its final
    ``state`` where ``dstate_final`` is given. On the card four launches
    (one count); each gradient element written by one block, in a fixed
    order; bf16 on the tensor cores (the strips of ``bwd_plan``, rows padded
    by ``_rows``), f32 on the CUDA cores."""
    if _lib.on_cpu(q):
        return _lib.plain("gla_backward", gla_backward_plain, q, k, v, log_a, dy, dstate_final,
                          states, decay, state)
    _check_bwd(q, k, v, log_a, dy, dstate_final, states, decay, state)
    dtypes = q.dtype, k.dtype, v.dtype, log_a.dtype
    q, k, v, dy = _lib.operands("gla_backward", _lib.F32_BF16, q=q, k=k, v=v, dy=dy)
    la, states, decay = (t.float().contiguous() for t in (log_a, states, decay))
    ds = st = None
    if dstate_final is not None:
        ds, st = dstate_final.float().contiguous(), state.float().contiguous()
    for name, t in (("log_a", la), ("states", states), ("decay", decay), ("dstate_final", ds),
                    ("state", st)):
        if t is not None and t.device != q.device:
            raise ValueError(f"gla_backward: {name} is on {t.device}, q on {q.device}")
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    bf16 = q.dtype == torch.bfloat16
    chunks = b * h * -(-s // min(CHUNK, s)) if s else 0
    wk, wv, paired = (bwd_plan(dk, dv, chunks, _sm_count(q.device)) if bf16
                      else (STRIP, 0, False))
    if bf16:  # the tensor cores' 16-byte copies: rows of a multiple of 8, aligned
        q, k = _rows(q, k)
        v, dy = _rows(v, dy)
    dq, dk_, dv_ = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dla = torch.empty((b, s, h), dtype=torch.float32, device=q.device)
    if s:
        c = min(CHUNK, s)
        n = -(-s // c)
        lib = _lib.library()
        # the state's gradient G_c (over each chunk's ΔG), and the partial
        # sums of dC and of ⟨dS_final, S_final⟩: (B, H, n, dk, dv) f32 is
        # 16.8 MB at xLSTM's training shape (B 2, S 256, H 4, 512 × 513)
        dgrad = torch.empty((b, h, n, dk, dv), dtype=torch.float32, device=q.device)
        strips = -(-q.shape[-1] // wk)
        parts = _lib.workspace(lib.repro_gla_bwd_parts(b, s, h, dk, dv, c, strips), q.device)
        status = lib.repro_gla_backward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), la.data_ptr(), dy.data_ptr(),
            states.data_ptr(), decay.data_ptr(), _lib.ptr(ds), _lib.ptr(st), dq.data_ptr(),
            dk_.data_ptr(), dv_.data_ptr(), dla.data_ptr(), dgrad.data_ptr(), parts.data_ptr(),
            b, s, h, dk, dv, c, int(bf16), wk, wv, int(paired), _lib.stream(),
        )
        _lib.check(status, "gla_backward")
        _lib.count_launch("gla_backward")
    dq, dk_, dv_ = dq[..., :dk], dk_[..., :dk], dv_[..., :dv]
    return dq.to(dtypes[0]), dk_.to(dtypes[1]), dv_.to(dtypes[2]), dla.to(dtypes[3])


def _rows(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """a and b (contiguous bf16 of one shape) with their rows zero-padded to
    a multiple of 8 elements on 16-byte boundaries: each itself where it is
    both, else a copy, one launch for the two (zero columns add nothing to
    any product of the backward or to dC)."""
    width = a.shape[-1]
    wide = _padded(width)
    out = [t if width == wide and t.data_ptr() % 16 == 0 else
           torch.empty(t.shape[:-1] + (wide,), dtype=t.dtype, device=t.device) for t in (a, b)]
    moved = [(t, o) for t, o in zip((a, b), out) if o is not t]
    if moved:
        (s0, d0), (s1, d1) = moved[0], moved[1] if len(moved) > 1 else (None, None)
        _lib.check(_lib.library().repro_gla_bwd_pad(
            s0.data_ptr(), d0.data_ptr(), _lib.ptr(s1), _lib.ptr(d1), a.numel() // max(width, 1),
            width, _lib.stream()), "gla_backward")
    return out[0], out[1]


class GLAForward(torch.autograd.Function):
    """``gla_forward`` with its backward: the forward keeps q, k, v, log a,
    the state entering each chunk, each chunk's e^{tot} and the final state;
    the backward (``gla_backward``) takes None for either cotangent."""

    @staticmethod
    def forward(ctx, q, k, v, log_a):
        y, state, states, decay = _forward(q, k, v, log_a, keep=True)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, k, v, log_a, states, decay, state)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        q, k, v, log_a, states, decay, state = ctx.saved_tensors
        if dy is None and dstate is None:
            return None, None, None, None
        if dy is None:
            dy = torch.zeros(v.shape, dtype=q.dtype, device=q.device)
        return gla_backward(q, k, v, log_a, dy, dstate, states, decay, state)


def gla_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_a: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(y, final state) of h_t = a_t·h_{t−1} + k_t v_tᵀ, y_t = q_tᵀ h_t.
    Differentiable (``GLAForward``) where a gradient is to be taken."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, log_a)):
        return GLAForward.apply(q, k, v, log_a)
    return _forward(q, k, v, log_a, keep=False)
