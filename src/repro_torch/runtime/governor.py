"""Merge governor: when and with whom the resident fleet merges; port of
``repro.runtime.governor``.

Each candidate round (every ``merge_every`` ticks) the governor builds a
participation mask (quarantine drifted devices and, with a robust merge,
robust-quarantined ones, AND any selection policies) and admits the
merge only if enough devices take part and the
average bytes per tick stay within ``budget_bytes_per_tick``. Rounds are
priced with ``repro_torch.fleet.comm``, scaled by the participating
fraction; with a lossy ``payload_precision`` the participants the
detector marks at risk (``fp_mask``) are priced at f32 and the rest at
the wire precision. With ``robust`` set, each round's contribution-outlier
scores feed a strike/calm ledger (``observe_robust``): consecutive hot
rounds quarantine a device, consecutive calm ones re-admit it. All of it
is host-side numpy between ticks.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.federated.selection import FleetMaskFn
from repro_torch.fleet.comm import topology_round_cost
from repro_torch.fleet.robust import RobustConfig
from repro_torch.fleet.topology import Topology


@dataclasses.dataclass(frozen=True)
class GovernorConfig:
    merge_every: int = 16
    budget_bytes_per_tick: float | None = None
    min_participants: int = 2


@dataclasses.dataclass
class GovernorState:
    ticks: int = 0
    merges: int = 0
    deferred_budget: int = 0
    deferred_participants: int = 0
    bytes_spent: int = 0
    deferred_degraded: int = 0

    @property
    def bytes_per_tick(self) -> float:
        return self.bytes_spent / max(self.ticks, 1)


@dataclasses.dataclass(frozen=True)
class MergeDecision:
    merge: bool
    reason: str            # "merge" | "cadence" | "budget" | "participants" | "degraded"
    participants: int
    round_bytes: int
    fp_participants: int = 0   # participants shipping full-precision f32


class MergeGovernor:
    def __init__(
        self,
        topology: Topology,
        n_hidden: int,
        n_out: int,
        cfg: GovernorConfig,
        *,
        policies: tuple[FleetMaskFn, ...] = (),
        payload_precision: str = "f32",
        robust: RobustConfig | None = None,
    ) -> None:
        self.topology = topology
        self.cfg = cfg
        self.policies = policies
        self.payload_precision = payload_precision
        self.robust = robust
        self.state = GovernorState()
        # robust-score quarantine ledger (used when ``robust`` is set)
        d = topology.n_devices
        self.robust_strikes = np.zeros(d, np.int64)
        self.robust_calm = np.zeros(d, np.int64)
        self.robust_quarantined = np.zeros(d, bool)
        self._full_round_bytes = topology_round_cost(topology, n_hidden, n_out).bytes_total
        self._q_round_bytes = topology_round_cost(
            topology, n_hidden, n_out, precision=payload_precision
        ).bytes_total

    def participation(self, drifted: np.ndarray, losses: np.ndarray) -> np.ndarray:
        """Quarantine ∧ robust quarantine ∧ selection policies → (D,) bool
        mask."""
        mask = ~np.asarray(drifted, bool)
        if self.robust is not None:
            mask &= ~self.robust_quarantined
        for policy in self.policies:
            mask &= np.asarray(policy(losses), bool)
        return mask

    def observe_robust(self, scores: np.ndarray) -> None:
        """Feed one merge round's outlier scores (every device's, so a
        quarantined device that returns to normal accrues calm rounds)
        into the strike/calm ledger: ``escalate_after`` consecutive scores
        above ``score_threshold`` quarantine a device, ``readmit_after``
        consecutive ones at or below ``score_readmit`` release it."""
        if self.robust is None:
            return
        cfg = self.robust
        scores = np.asarray(scores, np.float64)
        hot = scores > cfg.score_threshold
        self.robust_strikes = np.where(hot, self.robust_strikes + 1, 0)
        escalated = ~self.robust_quarantined & (self.robust_strikes >= cfg.escalate_after)
        self.robust_quarantined |= escalated
        self.robust_strikes[escalated] = 0
        calm_now = self.robust_quarantined & (scores <= cfg.score_readmit)
        self.robust_calm = np.where(calm_now, self.robust_calm + 1, 0)
        released = self.robust_calm >= cfg.readmit_after
        self.robust_quarantined &= ~released
        self.robust_calm[released] = 0

    def round_bytes(self, participants: int, fp_participants: int = 0) -> int:
        """Round traffic with ``participants`` of D devices live, of which
        ``fp_participants`` ship f32 and the rest the wire precision."""
        d = max(self.topology.n_devices, 1)
        fp = min(fp_participants, participants)
        q = participants - fp
        return int((self._full_round_bytes * fp + self._q_round_bytes * q) / d)

    def round_bytes_by_precision(
        self, participants: int, fp_participants: int = 0
    ) -> dict[str, int]:
        """The same round traffic split by wire format; sums exactly to
        ``round_bytes`` (the quantized share takes the integer floor)."""
        rb = self.round_bytes(participants, fp_participants)
        if self.payload_precision == "f32":
            return {"f32": rb}
        d = max(self.topology.n_devices, 1)
        fp = min(fp_participants, participants)
        fp_part = min(rb, int(self._full_round_bytes * fp / d))
        return {"f32": fp_part, self.payload_precision: rb - fp_part}

    def decide(
        self,
        tick: int,
        mask: np.ndarray,
        fp_mask: np.ndarray | None = None,
        *,
        allow: bool = True,
    ) -> MergeDecision:
        """Admission control for one tick; call exactly once per tick.
        ``fp_mask`` is the detector's quarantine-risk vector: participants
        it covers are priced at f32. ``allow=False`` vetoes the merge
        (skip-merge degraded mode) while the tick ledger keeps advancing."""
        self.state.ticks = tick + 1
        mask = np.asarray(mask)
        participants = int(mask.sum())
        if self.payload_precision == "f32" or fp_mask is None:
            fp = participants if self.payload_precision == "f32" else 0
        else:
            fp = int((mask.astype(bool) & np.asarray(fp_mask, bool)).sum())
        rb = self.round_bytes(participants, fp)
        if not allow:
            if (tick + 1) % self.cfg.merge_every == 0:
                self.state.deferred_degraded += 1
            return MergeDecision(False, "degraded", participants, rb, fp)
        if (tick + 1) % self.cfg.merge_every != 0:
            return MergeDecision(False, "cadence", participants, rb, fp)
        if participants < self.cfg.min_participants:
            self.state.deferred_participants += 1
            return MergeDecision(False, "participants", participants, rb, fp)
        if self.cfg.budget_bytes_per_tick is not None:
            projected = (self.state.bytes_spent + rb) / (tick + 1)
            if projected > self.cfg.budget_bytes_per_tick:
                self.state.deferred_budget += 1
                return MergeDecision(False, "budget", participants, rb, fp)
        self.state.merges += 1
        self.state.bytes_spent += rb
        return MergeDecision(True, "merge", participants, rb, fp)
