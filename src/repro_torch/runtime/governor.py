"""Merge governor: when and with whom the resident fleet merges; port of
``repro.runtime.governor`` for f32 payloads.

Each candidate round (every ``merge_every`` ticks) the governor builds a
participation mask (quarantine drifted devices, AND any selection
policies) and admits the merge only if enough devices take part and the
average bytes per tick stay within ``budget_bytes_per_tick``. Rounds are
priced with ``repro_torch.fleet.comm``, scaled by the participating
fraction. All of it is host-side numpy between ticks.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.federated.selection import FleetMaskFn
from repro_torch.fleet.comm import topology_round_cost
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


class MergeGovernor:
    def __init__(
        self,
        topology: Topology,
        n_hidden: int,
        n_out: int,
        cfg: GovernorConfig,
        *,
        policies: tuple[FleetMaskFn, ...] = (),
    ) -> None:
        self.topology = topology
        self.cfg = cfg
        self.policies = policies
        self.state = GovernorState()
        self._full_round_bytes = topology_round_cost(topology, n_hidden, n_out).bytes_total

    def participation(self, drifted: np.ndarray, losses: np.ndarray) -> np.ndarray:
        """Quarantine ∧ selection policies → (D,) bool mask."""
        mask = ~np.asarray(drifted, bool)
        for policy in self.policies:
            mask &= np.asarray(policy(losses), bool)
        return mask

    def round_bytes(self, participants: int) -> int:
        """Round traffic with ``participants`` of D devices live."""
        d = max(self.topology.n_devices, 1)
        return int(self._full_round_bytes * participants / d)

    def decide(self, tick: int, mask: np.ndarray, *, allow: bool = True) -> MergeDecision:
        """Admission control for one tick; call exactly once per tick.
        ``allow=False`` vetoes the merge (skip-merge degraded mode) while
        the tick ledger keeps advancing."""
        self.state.ticks = tick + 1
        participants = int(np.asarray(mask).sum())
        rb = self.round_bytes(participants)
        if not allow:
            if (tick + 1) % self.cfg.merge_every == 0:
                self.state.deferred_degraded += 1
            return MergeDecision(False, "degraded", participants, rb)
        if (tick + 1) % self.cfg.merge_every != 0:
            return MergeDecision(False, "cadence", participants, rb)
        if participants < self.cfg.min_participants:
            self.state.deferred_participants += 1
            return MergeDecision(False, "participants", participants, rb)
        if self.cfg.budget_bytes_per_tick is not None:
            projected = (self.state.bytes_spent + rb) / (tick + 1)
            if projected > self.cfg.budget_bytes_per_tick:
                self.state.deferred_budget += 1
                return MergeDecision(False, "budget", participants, rb)
        self.state.merges += 1
        self.state.bytes_spent += rb
        return MergeDecision(True, "merge", participants, rb)
