"""Resident streaming fleet runtime, exact-f32 path; port of
``repro.runtime.runtime``.

One ``tick`` runs the paper's loop over the whole fleet:

1. **ingest** — every device scores its incoming batch under its current
   model (the pre-train loss, the drift signal) and trains on it with
   the k=1 sequential updates, in one fused ingest;
2. **detect** — the sequential drift detector updates each device's
   EWMA and baseline band;
3. **govern** — the merge governor builds the participation mask
   (drifted devices are quarantined) and admits or defers the round;
4. **merge** — an admitted round runs the masked Eq. 8 merge on the
   merge kernels (``fleet_merge_masked_kernel``).

The fleet state and the detector bank stay on the device; only the (D,)
losses and flags come back to the host, where the governor decides.
The runtime always takes the kernel family: on a CUDA device every tick
launches the ingest kernel and every admitted round the merge kernels
of its topology.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.oselm import OSELMState
from repro_torch.federated.selection import FleetMaskFn
from repro_torch.fleet.fleet import fleet_merge_masked_kernel
from repro_torch.fleet.topology import Topology
from repro_torch.kernels.fleet_ingest import fleet_ingest
from repro_torch.runtime.detector import (
    DetectorConfig,
    DetectorState,
    detector_update,
    init_detector,
)
from repro_torch.runtime.governor import GovernorConfig, MergeDecision, MergeGovernor


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    topology: Topology
    ridge: float = 1e-3
    detector: DetectorConfig = dataclasses.field(default_factory=DetectorConfig)
    governor: GovernorConfig = dataclasses.field(default_factory=GovernorConfig)


@dataclasses.dataclass(frozen=True)
class TickReport:
    """What one tick did."""

    tick: int
    losses: np.ndarray            # (D,) mean pre-train loss of the incoming batch
    drifted: np.ndarray           # (D,) quarantine flags after detection
    fresh_detections: np.ndarray  # (D,) flags that rose this tick
    decision: MergeDecision
    merge_seconds: float | None   # wall clock of the admitted merge, else None
    ingest_seconds: float | None = None  # wall clock of ingest + detect
    served: np.ndarray | None = None     # (D,) served mask, None = every device


def _where_served(keep: torch.Tensor, new, old):
    """Devices with ``keep`` take the new per-device fields; the rest keep
    their old ones bit for bit (an unserved device must not train, and its
    detector must not observe a padded batch row)."""
    out = {}
    for f in dataclasses.fields(old):
        n, o = getattr(new, f.name), getattr(old, f.name)
        if isinstance(o, torch.Tensor) and o.ndim >= 1 and o.shape[0] == keep.shape[0]:
            out[f.name] = torch.where(keep.reshape(keep.shape + (1,) * (o.ndim - 1)), n, o)
    return old.replace(**out)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class FleetRuntime:
    """A live fleet: stacked OS-ELM states, detector bank and governor on
    one device. ``device`` defaults to the card; the states are moved
    there."""

    def __init__(
        self,
        states: OSELMState,
        config: RuntimeConfig,
        *,
        policies: tuple[FleetMaskFn, ...] = (),
        device: str | torch.device | None = None,
    ) -> None:
        self.device = resolve_device(device)
        n_devices = states.beta.shape[0]
        if config.topology.n_devices != n_devices:
            raise ValueError(
                f"topology is for {config.topology.n_devices} devices, "
                f"fleet has {n_devices}"
            )
        if states.params.alpha.ndim != 2:
            raise ValueError("the fleet must carry one shared basis (α of shape (n, Ñ))")
        dev = self.device
        self.states = states.replace(
            params=type(states.params)(*(t.to(dev).contiguous() for t in states.params)),
            beta=states.beta.to(dev).contiguous(), p=states.p.to(dev).contiguous(),
        )
        self.config = config
        self.det: DetectorState = init_detector(n_devices, device=dev)
        self.governor = MergeGovernor(
            config.topology, states.beta.shape[1], states.beta.shape[2], config.governor,
            policies=policies,
        )
        self.tick_no = 0
        self.detections_total = 0
        self._post_merge = False
        self._merge_mask = np.ones(n_devices, bool)

    @property
    def n_devices(self) -> int:
        return self.det.n_devices

    def _ingest_detect(self, batch: torch.Tensor, served: np.ndarray):
        trained, losses = fleet_ingest(self.states, batch)
        det_new, _, fresh = detector_update(
            self.det, losses, self.config.detector, rebase=self._post_merge,
            participants=torch.as_tensor(self._merge_mask, device=self.device),
        )
        keep = torch.as_tensor(served, device=self.device)
        self.states = _where_served(keep, trained, self.states)
        self.det = _where_served(keep, det_new, self.det)
        return losses, self.det.drifted, fresh & keep

    def _merge(self, mask: np.ndarray) -> None:
        mask_t = torch.as_tensor(mask, dtype=torch.float32, device=self.device)
        self.states = fleet_merge_masked_kernel(
            self.states, self.config.topology, mask_t, ridge=self.config.ridge
        )

    def tick(
        self,
        batch,
        *,
        served: np.ndarray | None = None,
        allow_merge: bool = True,
    ) -> TickReport:
        """Process one tick: ingest + detect, then govern and maybe merge.

        ``batch`` is (n_devices, B, features), a numpy array or a tensor.
        Devices marked False in ``served`` carry padding in their row and
        keep their model and detector state untouched. ``allow_merge=False``
        vetoes any merge this tick while the governor's ledger advances."""
        t = self.tick_no
        d = self.n_devices
        x = torch.as_tensor(batch, dtype=torch.float32, device=self.device)
        if x.ndim != 3 or x.shape[0] != d:
            raise ValueError(
                f"tick batch must be (n_devices={d}, B, features); got shape {tuple(x.shape)}"
            )
        if x.shape[1] < 1:
            raise ValueError("tick batch has zero samples per device (B=0)")
        if served is None:
            served_np = np.ones(d, bool)
        else:
            served_np = np.asarray(served).astype(bool)
            if served_np.shape != (d,):
                raise ValueError(f"served mask must be ({d},); got {served_np.shape}")

        t0 = time.perf_counter()
        losses, drifted, fresh = self._ingest_detect(x.contiguous(), served_np)
        _synchronize(self.device)
        ingest_seconds = time.perf_counter() - t0

        losses_np = losses.cpu().numpy()
        drifted_np = drifted.cpu().numpy()
        fresh_np = fresh.cpu().numpy()
        self.detections_total += int(fresh_np.sum())

        mask = self.governor.participation(drifted_np, losses_np)
        decision = self.governor.decide(t, mask, allow=allow_merge)

        merge_seconds = None
        if decision.merge:
            t0 = time.perf_counter()
            self._merge(mask)
            _synchronize(self.device)
            merge_seconds = time.perf_counter() - t0
            self._merge_mask = mask.copy()
        self._post_merge = decision.merge
        self.tick_no = t + 1
        return TickReport(
            tick=t, losses=losses_np, drifted=drifted_np, fresh_detections=fresh_np,
            decision=decision, merge_seconds=merge_seconds,
            ingest_seconds=ingest_seconds, served=None if served is None else served_np,
        )

    def warmup(self, batch_size: int) -> None:
        """Build the kernels and launch each kernel the tick can reach once,
        on all-zero operands, before live traffic arrives: the first real
        tick then does not pay for ``nvcc``. Every output is discarded — no
        model, detector or governor state changes."""
        saved = (self.states, self.det)
        d, f = self.n_devices, self.states.params.alpha.shape[0]
        batch = torch.zeros((d, batch_size, f), dtype=torch.float32, device=self.device)
        self._ingest_detect(batch, np.zeros(d, bool))
        self._merge(np.zeros(d, bool))
        _synchronize(self.device)
        self.states, self.det = saved
