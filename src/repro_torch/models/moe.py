"""Mixture-of-Experts FFN: top-k routing with capacity-factor dispatch;
port of ``repro.models.moe``.

Tokens are bucketed into groups of ``tokens_per_group``; each token picks
its top-k experts, and a per-expert capacity ``cap = ts·k/E·cf`` bounds
every expert's buffer: tokens past it are dropped (capacity-based MoE).
Slots are handed out expert by expert in token order, choice k after
choice k − 1, as the reference's cumsum does; a padded last group's
zero tokens are routed too, after the real ones. Two dispatches give the
same slots and the same drops:

- ``"einsum"`` (the config default): the Switch/Flaxformer one-hot
  dispatch and combine tensors (g, ts, E, cap);
- ``"scatter"``: tokens added into their slots (one slot per kept choice,
  a dump slot for the dropped) and gathered back.

The experts run as one batched product over E for every group at once.
The aux dict holds the Switch Transformer load-balance loss, the router
z-loss and the dropped fraction: of tokens with no slot at all (einsum),
of (token, choice) pairs (scatter), as in the reference.

``stable_top_k`` keeps the lower expert on a tie, as ``jax.lax.top_k`` does: a
stable descending sort, not ``torch.topk``, whose order on ties is
unspecified.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["moe_ffn", "stable_top_k"]


def stable_top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, largest
    first, the lower index first among equals."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """One-hot (..., n) int64 by comparison: ``F.one_hot`` checks its input's
    range on the card, which waits for the stream at every layer."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def _route(p: dict, xg: torch.Tensor, n_experts: int, k: int, capacity_factor: float):
    """Router logits (f32), probabilities, normalized top-k gates and their
    experts, the capacity, and each choice's slot within its expert's buffer
    (g, ts, K), counted as the reference counts them."""
    g, ts, _ = xg.shape
    logits = (xg @ p["router"].to(xg.dtype)).float()                 # (g, ts, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = stable_top_k(probs, k)                          # (g, ts, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    cap = max(1, int(ts * k / n_experts * capacity_factor))
    # choice k's tokens after choice k − 1's, each expert's slots counted in
    # that order: one cumsum over the choices' tokens laid end to end
    m = _one_hot(idx.transpose(1, 2).reshape(g, k * ts), n_experts)        # (g, K·ts, E)
    before = torch.cumsum(m, dim=1) - m                                     # slots taken before
    pos = torch.gather(before, 2, idx.transpose(1, 2).reshape(g, k * ts, 1))
    return logits, probs, gate_vals, idx, cap, pos.reshape(g, k, ts).transpose(1, 2)


def _experts(p: dict, expert_in: torch.Tensor) -> torch.Tensor:
    """SwiGLU of each expert on its buffer: (g, E, cap, D) → (g, E, cap, D),
    as one product batched over E (no copy of the weights)."""
    g, e, cap, d = expert_in.shape
    x = expert_in.transpose(0, 1).reshape(e, g * cap, d)
    h_gate = torch.bmm(x, p["w_gate"])
    h_up = torch.bmm(x, p["w_up"])
    h = F.silu(h_gate.float()).to(h_up.dtype) * h_up
    out = torch.bmm(h, p["w_down"])                                  # (E, g·cap, D)
    return out.reshape(e, g, cap, d).transpose(0, 1)


def _dropped(kept: torch.Tensor) -> torch.Tensor:
    """1 − the kept share, as the reference's jitted ``1.0 - mean`` rounds
    it: the count times f32(1/n), subtracted from 1 and rounded once (XLA
    fuses the two into a multiply-add; exact in f64), so that the fraction's
    bits are the reference's."""
    recip = float(torch.tensor(1.0 / kept.numel(), dtype=torch.float32))
    return (1.0 - kept.sum(dtype=torch.float64) * recip).float()


def _aux(logits, probs, idx, n_experts: int, dropped: torch.Tensor) -> dict:
    top1 = _one_hot(idx[:, :, 0], n_experts).float()
    lb_loss = n_experts * torch.mean(torch.sum(top1.mean(dim=1) * probs.mean(dim=1), dim=-1))
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return {"lb_loss": lb_loss, "z_loss": z_loss, "dropped_frac": dropped}


def moe_ffn(
    p: dict,
    x: torch.Tensor,                 # (B, S, D)
    *,
    n_experts: int,
    top_k: int,
    tokens_per_group: int,
    capacity_factor: float = 1.25,
    dispatch: str = "einsum",
) -> tuple[torch.Tensor, dict]:
    """Top-k MoE FFN over x (B, S, D); returns (y (B, S, D), aux)."""
    if dispatch not in ("einsum", "scatter"):
        raise ValueError(f"moe_ffn: dispatch must be 'einsum' or 'scatter', got {dispatch!r}")
    b, s, d = x.shape
    tokens = b * s
    ts = min(tokens_per_group, tokens)
    g = -(-tokens // ts)
    xf = x.reshape(tokens, d)
    if g * ts > tokens:  # a whole number of groups; the padded tokens are dropped on return
        xf = F.pad(xf, (0, 0, 0, g * ts - tokens))
    xg = xf.reshape(g, ts, d)
    logits, probs, gate_vals, idx, cap, pos = _route(p, xg, n_experts, top_k, capacity_factor)
    keep = pos < cap                                                 # (g, ts, K)
    if dispatch == "einsum":
        y, dropped = _dispatch_einsum(p, xg, gate_vals, idx, pos, keep, n_experts, cap)
    else:
        y, dropped = _dispatch_scatter(p, xg, gate_vals, idx, pos, keep, n_experts, cap)
    y = y.reshape(g * ts, d)[:tokens].reshape(b, s, d)
    return y, _aux(logits, probs, idx, n_experts, dropped)


def _dispatch_einsum(p, xg, gate_vals, idx, pos, keep, n_experts: int, cap: int):
    """The one-hot dispatch (g, ts, E·cap) in x's type and combine in f32
    (a token's k choices take k distinct experts, so the sum over the
    choices adds one nonzero a slot); returns (y (g, ts, D), dropped
    fraction of tokens)."""
    g, ts, d = xg.shape
    slots = torch.arange(n_experts * cap, device=xg.device)
    oh = ((idx * cap + pos)[..., None] == slots) & keep[..., None]          # (g, ts, K, E·cap)
    dispatch = oh.any(dim=2).to(xg.dtype)
    combine = (oh.float() * gate_vals[..., None]).sum(dim=2)
    expert_in = torch.bmm(dispatch.transpose(1, 2), xg)                    # (g, E·cap, D)
    expert_out = _experts(p, expert_in.reshape(g, n_experts, cap, d))
    y = torch.bmm(combine.to(expert_out.dtype), expert_out.reshape(g, n_experts * cap, d))
    return y, _dropped(dispatch.sum(dim=2) > 0)


def _dispatch_scatter(p, xg, gate_vals, idx, pos, keep, n_experts: int, cap: int):
    """Each kept choice's token added into its slot, the dropped into a dump
    slot, the experts' outputs gathered back and weighted by the gates;
    returns (y (g, ts, D), dropped fraction of choices)."""
    g, ts, d = xg.shape
    k = idx.shape[-1]
    n_slots = n_experts * cap
    slots = torch.where(keep, idx * cap + torch.clamp(pos, max=cap - 1), n_slots)  # (g, ts, K)
    flat = (slots + (n_slots + 1) * torch.arange(g, device=xg.device)[:, None, None]).reshape(-1)
    buf = torch.zeros((g * (n_slots + 1), d), dtype=xg.dtype, device=xg.device)
    buf.index_add_(0, flat, xg.repeat_interleave(k, dim=1).reshape(-1, d))
    expert_in = buf.reshape(g, n_slots + 1, d)[:, :n_slots].reshape(g, n_experts, cap, d)
    expert_out = _experts(p, expert_in).reshape(g, n_slots, d)
    out = torch.cat([expert_out, expert_out.new_zeros((g, 1, d))], dim=1)
    y_tok = torch.gather(out, 1, slots.reshape(g, ts * k, 1).expand(-1, -1, d))
    w = (gate_vals * keep).to(y_tok.dtype)
    y = (y_tok.reshape(g, ts, k, d) * w[..., None]).sum(dim=2)
    return y, _dropped(keep)
