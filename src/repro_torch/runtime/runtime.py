"""Resident streaming fleet runtime; port of ``repro.runtime.runtime``
(exact-f32 and quantized payloads; no staleness, robust merge, faults,
snapshots or telemetry yet).

One ``tick`` runs the paper's loop over the whole fleet:

1. **ingest** — every device scores its incoming batch under its current
   model (the pre-train loss, the drift signal) and trains on it with
   the k=1 sequential updates, in one fused ingest;
2. **detect** — the sequential drift detector updates each device's
   EWMA and baseline band;
3. **govern** — the merge governor builds the participation mask
   (drifted devices are quarantined) and admits or defers the round;
4. **merge** — an admitted round runs the masked Eq. 8 merge on the
   merge kernels (``fleet_merge_masked_kernel``). With a lossy
   ``payload_precision`` it is the error-feedback round
   (``fleet_merge_quantized``): devices the detector marks at quarantine
   risk ship exact f32, the rest int8 through the ``quantize_pack``
   kernel (or f16), and the residual accumulator advances on admitted
   rounds only.

The fleet state, the residual and the detector bank stay on the device;
only the (D,) losses and flags (and on candidate rounds of a quantized
runtime the risk mask) come back to the host, where the governor
decides. The runtime always takes the kernel family: on a CUDA device
every tick launches the ingest kernel and every admitted round the
merge kernels of its topology.
"""
from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.oselm import OSELMState
from repro_torch.federated.selection import FleetMaskFn
from repro_torch.fleet.fleet import fleet_merge_masked_kernel, fleet_merge_quantized
from repro_torch.fleet.quantize import init_residual, validate_precision
from repro_torch.fleet.topology import Topology
from repro_torch.kernels.fleet_ingest import fleet_ingest
from repro_torch.runtime.detector import (
    DetectorConfig,
    DetectorState,
    detector_update,
    init_detector,
    quarantine_risk,
)
from repro_torch.runtime.feed import TickFeed
from repro_torch.runtime.governor import GovernorConfig, MergeDecision, MergeGovernor

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    topology: Topology
    ridge: float = 1e-3
    detector: DetectorConfig = dataclasses.field(default_factory=DetectorConfig)
    governor: GovernorConfig = dataclasses.field(default_factory=GovernorConfig)
    gate_merges: bool = True          # False: no quarantine, every device merges
    payload_precision: str = "f32"    # merge wire format: "f32" | "f16" | "int8"


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
        validate_precision(config.payload_precision)
        dev = self.device
        self.states = states.replace(
            params=type(states.params)(*(t.to(dev).contiguous() for t in states.params)),
            beta=states.beta.to(dev).contiguous(), p=states.p.to(dev).contiguous(),
        )
        self.config = config
        self.det: DetectorState = init_detector(n_devices, device=dev)
        self.governor = MergeGovernor(
            config.topology, states.beta.shape[1], states.beta.shape[2], config.governor,
            policies=policies, payload_precision=config.payload_precision,
        )
        # error-feedback accumulator of the quantized path (None for f32),
        # advanced only on admitted merge rounds
        self._residual = (
            None if config.payload_precision == "f32" else init_residual(self.states)
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

    def _merge(self, mask: np.ndarray, fp_mask: np.ndarray | None) -> None:
        cfg = self.config
        mask_t = torch.as_tensor(mask, dtype=torch.float32, device=self.device)
        if self._residual is None:
            self.states = fleet_merge_masked_kernel(
                self.states, cfg.topology, mask_t, ridge=cfg.ridge
            )
            return
        self.states, self._residual = fleet_merge_quantized(
            self.states, cfg.topology, residual=self._residual,
            payload_precision=cfg.payload_precision, ridge=cfg.ridge, mask=mask_t,
            fp_mask=torch.as_tensor(fp_mask, dtype=torch.bool, device=self.device),
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

        # detector-gated precision: on candidate rounds of a quantized
        # runtime, devices at quarantine risk are priced and shipped at f32
        fp_mask = None
        if self._residual is not None and (t + 1) % self.config.governor.merge_every == 0:
            fp_mask = quarantine_risk(self.det, self.config.detector).cpu().numpy()

        if self.config.gate_merges:
            mask = self.governor.participation(drifted_np, losses_np)
        else:
            mask = np.ones(d, bool)
        decision = self.governor.decide(t, mask, fp_mask, allow=allow_merge)

        merge_seconds = None
        if decision.merge:
            t0 = time.perf_counter()
            self._merge(mask, fp_mask)
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

    def run(self, feed: TickFeed, *, ticks: int | None = None) -> list[TickReport]:
        """Drive the runtime over a feed (all of it by default). Asking for
        more ticks than the feed holds processes what exists and warns."""
        if ticks is not None and ticks > feed.n_ticks:
            logger.warning(
                "run(ticks=%d) exceeds the feed's %d ticks; truncating", ticks, feed.n_ticks
            )
        n = feed.n_ticks if ticks is None else min(ticks, feed.n_ticks)
        return [self.tick(feed.tick_batch(t)) for t in range(n)]

    def warmup(self, batch_size: int) -> None:
        """Build the kernels and launch each kernel the tick can reach once
        (``quantize_pack`` too when the payloads are int8), on all-zero
        operands, before live traffic arrives: the first real tick then
        does not pay for ``nvcc``. Every output is discarded — no model,
        detector, residual or governor state changes."""
        saved = (self.states, self.det, self._residual)
        d, f = self.n_devices, self.states.params.alpha.shape[0]
        batch = torch.zeros((d, batch_size, f), dtype=torch.float32, device=self.device)
        self._ingest_detect(batch, np.zeros(d, bool))
        self._merge(np.zeros(d, bool), np.zeros(d, bool))
        _synchronize(self.device)
        self.states, self.det, self._residual = saved
