"""Resident streaming fleet runtime; port of ``repro.runtime.runtime``
(exact-f32 and quantized payloads, robust merges and fault injection,
stale merges, telemetry; no snapshots yet).

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
   rounds only. With ``robust`` or ``faults`` set it is the hardened
   round: the tick's faults corrupt the published payloads w = [U | V]
   (``payload_scale``, ``payload_noise``, NaN and Inf markers), and then
   either the naive arm merges whatever came out, or the robust arm
   replaces each non-finite payload by that device's last finite one and
   runs the clipped, trimmed and scored merge (``robust_merge_from_w``),
   whose scores feed the governor's robust quarantine. With a
   ``staleness`` schedule it is the stale round: every device publishes
   its fresh payload into a ring of published versions and merges its own
   fresh (U, V) with each neighbour's payload as old as that neighbour's
   lag (``repro_torch.fleet.staleness.stale_merge_round``, on the
   topology's sparse mix kernels).

The fleet state, the residual and the detector bank stay on the device;
only the (D,) losses and flags (and on candidate rounds of a quantized
runtime the risk mask) come back to the host, where the governor
decides. The runtime always takes the kernel family: on a CUDA device
every tick launches the ingest kernel and every admitted round the
merge kernels of its topology.

With ``RuntimeConfig.telemetry`` set, a ``repro_torch.obs.TelemetrySink``
times each phase of the tick (poison, ingest, quantize, govern, merge),
counts ticks, merge rounds, bytes by wire precision, detections, faults
and rejected payloads, samples the detector's band every
``band_sample_every`` ticks, keeps a flight ring of recent ticks, and
dumps it with the failing tick's post-poison batch when an exception
escapes ``tick`` (or a payload is non-finite, or a tick breaks its SLO).
Telemetry changes no result: the reports are the same with it on or off.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.oselm import OSELMState
from repro_torch.federated.selection import FleetMaskFn
from repro_torch.fleet.faults import FaultInjector
from repro_torch.fleet.fleet import (
    _masked_kernel_merge_from_w,
    _packed_uv,
    fleet_merge_masked_kernel,
    fleet_merge_quantized,
)
from repro_torch.fleet.quantize import init_residual, validate_precision
from repro_torch.fleet.robust import RobustConfig, finite_payload_mask, robust_merge_from_w
from repro_torch.fleet.staleness import StalenessSchedule, init_ring, stale_merge_round
from repro_torch.fleet.topology import Topology
from repro_torch.kernels.fleet_ingest import fleet_ingest
from repro_torch.obs import TelemetryConfig, TelemetrySink
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
    staleness: StalenessSchedule | None = None  # per-device publication lags
                                                # of the stale merge; None: fresh
    payload_precision: str = "f32"    # merge wire format: "f32" | "f16" | "int8"
    robust: RobustConfig | None = None   # clip/trim/score merge and robust
                                         # quarantine; None: the exact merge
    faults: FaultInjector | None = None  # deterministic faults at the payload
                                         # boundary (repro_torch.fleet.faults)
    detections_cap: int = 4096        # length of the detection-event ring
    telemetry: TelemetryConfig | None = None  # metrics, tracing and the flight
                                              # recorder (repro_torch.obs);
                                              # None: no instrumentation


@dataclasses.dataclass(frozen=True)
class TickReport:
    """What one tick did."""

    tick: int
    losses: np.ndarray            # (D,) mean pre-train loss of the incoming batch
    drifted: np.ndarray           # (D,) quarantine flags after detection
    fresh_detections: np.ndarray  # (D,) flags that rose this tick
    decision: MergeDecision
    merge_seconds: float | None   # wall clock of the admitted merge, else None
    robust_scores: np.ndarray | None = None  # (D,) outlier scores of an admitted
                                             # hardened round (zeros on the naive arm)
    nonfinite_payloads: int = 0   # payloads the finite guard saw this tick
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


class _NullPhase:
    """The telemetry phase timer's ``with``/``fence`` surface, measuring
    nothing: one shared instance keeps the uninstrumented tick free of
    per-phase allocations."""

    __slots__ = ()

    def __enter__(self) -> "_NullPhase":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def fence(self, tree) -> None:
        pass


_NULL_PHASE = _NullPhase()


def _host(batch) -> np.ndarray:
    return batch.cpu().numpy() if isinstance(batch, torch.Tensor) else np.asarray(batch)


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
        if config.staleness is not None and len(config.staleness.lags) != n_devices:
            raise ValueError("staleness schedule device count mismatch")
        validate_precision(config.payload_precision)
        if config.payload_precision != "f32" and config.staleness is not None:
            raise ValueError(
                "quantized payloads are not supported with the stale "
                "published-version ring yet (the ring stores exact payloads)"
            )
        if self._hardened(config) and config.staleness is not None:
            raise ValueError(
                "robust/fault-injected merges are not supported with the "
                "stale published-version ring (the ring replays un-guarded "
                "historical payloads)"
            )
        if self._hardened(config) and config.payload_precision != "f32":
            raise ValueError(
                "robust/fault-injected merges require payload_precision='f32' "
                "(the quantized codec path has its own publish boundary)"
            )
        if config.faults is not None and config.faults.n_devices != n_devices:
            raise ValueError(
                f"fault injector is for {config.faults.n_devices} devices, "
                f"fleet has {n_devices}"
            )
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
            robust=config.robust,
        )
        # error-feedback accumulator of the quantized path (None for f32),
        # advanced only on admitted merge rounds
        self._residual = (
            None if config.payload_precision == "f32" else init_residual(self.states)
        )
        # each device's last finite published payload (hardened rounds): the
        # finite guard publishes it in place of a non-finite one
        self._last_good = (
            _packed_uv(self.states, config.ridge)[1] if self._hardened(config) else None
        )
        # the ring of published versions (L, D, Ñ, Ñ+m) of a stale runtime,
        # written in place, one slot per admitted round
        self._hist = (
            None if config.staleness is None
            else init_ring(self.states, config.ridge, config.staleness.max_lag + 1)
        )
        self.tick_no = 0
        self.merge_round = 0
        # the newest (tick, device) detection events, for delay accounting;
        # detections_total keeps the lifetime count
        self.detections: deque[tuple[int, int]] = deque(maxlen=config.detections_cap)
        self.detections_total = 0
        self._post_merge = False
        self._merge_mask = np.ones(n_devices, bool)
        self.telemetry = TelemetrySink(config.telemetry) if config.telemetry is not None else None
        self._tick_inputs = None  # the last post-poison batch, for flight dumps

    @staticmethod
    def _hardened(config: RuntimeConfig) -> bool:
        return config.robust is not None or config.faults is not None

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

    def _merge(
        self, mask: np.ndarray, fp_mask: np.ndarray | None, drifted: np.ndarray, t: int
    ) -> tuple[np.ndarray | None, int]:
        """Run one admitted round; returns the outlier scores and the count
        of non-finite payloads of a hardened round (None, 0 otherwise)."""
        cfg = self.config
        mask_t = torch.as_tensor(mask, dtype=torch.float32, device=self.device)
        if self._last_good is not None:
            return self._merge_hardened(mask, mask_t, drifted, t)
        if self._hist is not None:
            self.states = stale_merge_round(
                self.states, self._hist, cfg.staleness.lags, self.merge_round, cfg.topology,
                cfg.ridge, mask=mask_t,
            )
            return None, 0
        if self._residual is None:
            self.states = fleet_merge_masked_kernel(
                self.states, cfg.topology, mask_t, ridge=cfg.ridge
            )
            return None, 0
        self.states, self._residual = fleet_merge_quantized(
            self.states, cfg.topology, residual=self._residual,
            payload_precision=cfg.payload_precision, ridge=cfg.ridge, mask=mask_t,
            fp_mask=torch.as_tensor(fp_mask, dtype=torch.bool, device=self.device),
        )
        return None, 0

    def _merge_hardened(
        self, mask: np.ndarray, mask_t: torch.Tensor, drifted: np.ndarray, t: int
    ) -> tuple[np.ndarray, int]:
        """The payload boundary of a hardened round: faults in, then the
        naive arm or the finite guard and the robust merge."""
        cfg, dev = self.config, self.device
        injector = cfg.faults
        _, w = _packed_uv(self.states, cfg.ridge)
        if injector is not None:
            mult, nonfin = injector.payload_scale(t)
            if (mult != 1.0).any():
                w = w * torch.as_tensor(mult, device=dev)[:, None, None]
            # built only when a noise schedule is active: adding the
            # reference's all-zero operand changes nothing but the sign of
            # a zero, and at the har width it is a 90 MB copy per round
            noise = injector.payload_noise(t, tuple(w.shape))
            if noise is not None:
                w = w + torch.as_tensor(noise, device=dev)
            for code, value in ((1, torch.nan), (2, torch.inf)):
                if (nonfin == code).any():
                    hit = torch.as_tensor(nonfin == code, device=dev)[:, None, None]
                    w = torch.where(hit, value, w)
        finite = finite_payload_mask(w)
        if cfg.robust is None:
            # naive arm: whatever the faults produced flows into the plain
            # masked Eq. 8 sum, the baseline the robust arm is held against
            self.states = _masked_kernel_merge_from_w(
                self.states, cfg.topology, mask_t, w, cfg.ridge
            )
            scores = np.zeros(self.n_devices, np.float32)
        else:
            # finite guard: a non-finite payload is replaced by the device's
            # last finite one, so it never poisons a neighbourhood sum
            w = torch.where(finite[:, None, None], w, self._last_good)
            self._last_good = w
            # robust-quarantined devices still download the merged model,
            # unless drift-flagged or crashed this tick
            rq = self.governor.robust_quarantined & ~np.asarray(drifted, bool)
            if injector is not None:
                rq &= ~injector.crash_mask(t)
            receive = torch.as_tensor(mask | rq, dtype=torch.float32, device=dev)
            self.states, scores_t = robust_merge_from_w(
                self.states, cfg.topology, mask_t, w, cfg.robust, cfg.ridge, receive=receive
            )
            scores = scores_t.cpu().numpy()
        return scores, int((~finite).sum())

    def _phase(self, name: str):
        """The phase's timer (a shared no-op when telemetry is off)."""
        return _NULL_PHASE if self.telemetry is None else self.telemetry.phase(name)

    def _observe_phase(self, name: str, seconds: float) -> None:
        if self.telemetry is not None:
            self.telemetry._phase_observe[name](seconds)

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
        vetoes any merge this tick while the governor's ledger advances.

        With telemetry on, an exception that escapes the tick dumps the
        flight ring with this tick's post-poison batch before it propagates."""
        try:
            return self._tick(batch, served, allow_merge)
        except Exception:
            tel = self.telemetry
            if tel is not None:
                inputs = None if self._tick_inputs is None else _host(self._tick_inputs)
                tel.maybe_dump(self.tick_no, "exception", inputs=inputs)
                tel.write_outputs()
            raise

    def _tick(self, batch, served: np.ndarray | None, allow_merge: bool) -> TickReport:
        t = self.tick_no
        d = self.n_devices
        injector = self.config.faults
        if not isinstance(batch, torch.Tensor):
            batch = np.asarray(batch)
        shape = tuple(batch.shape)
        if len(shape) != 3 or shape[0] != d:
            raise ValueError(
                f"tick batch must be (n_devices={d}, B, features); got shape {shape}"
            )
        if shape[1] < 1:
            raise ValueError("tick batch has zero samples per device (B=0)")
        if served is None:
            served_np = np.ones(d, bool)
        else:
            served_np = np.asarray(served).astype(bool)
            if served_np.shape != (d,):
                raise ValueError(f"served mask must be ({d},); got {served_np.shape}")
        t_start = time.perf_counter()
        with self._phase("poison"):
            if injector is not None and any(k == "poison" for k, _ in injector.active_faults(t)):
                # data poisoning attacks through training itself, upstream of
                # the payload boundary
                batch = injector.poison_batch(torch.as_tensor(batch).cpu().numpy(), t)
        # the post-poison batch is what reaches the model: what a flight dump
        # must carry for the failing tick to be replayed
        self._tick_inputs = batch
        x = torch.as_tensor(batch, dtype=torch.float32, device=self.device)

        t0 = time.perf_counter()
        losses, drifted, fresh = self._ingest_detect(x.contiguous(), served_np)
        _synchronize(self.device)
        ingest_seconds = time.perf_counter() - t0
        self._observe_phase("ingest", ingest_seconds)

        losses_np = losses.cpu().numpy()
        drifted_np = drifted.cpu().numpy()
        fresh_np = fresh.cpu().numpy()
        n_fresh = int(fresh_np.sum())
        self.detections_total += n_fresh
        for dev in np.flatnonzero(fresh_np):
            self.detections.append((t, int(dev)))

        # detector-gated precision: on candidate rounds of a quantized
        # runtime, devices at quarantine risk are priced and shipped at f32
        with self._phase("quantize"):
            fp_mask = None
            if self._residual is not None and (t + 1) % self.config.governor.merge_every == 0:
                fp_mask = quarantine_risk(self.det, self.config.detector).cpu().numpy()

        with self._phase("govern"):
            if self.config.gate_merges:
                mask = self.governor.participation(drifted_np, losses_np)
            else:
                mask = np.ones(d, bool)
            if injector is not None:
                # crashed devices neither publish nor download, whatever the gating
                mask = mask & ~injector.crash_mask(t)
            decision = self.governor.decide(t, mask, fp_mask, allow=allow_merge)

        merge_seconds, scores, nonfinite = None, None, 0
        if decision.merge:
            t0 = time.perf_counter()
            scores, nonfinite = self._merge(mask, fp_mask, drifted_np, t)
            _synchronize(self.device)
            merge_seconds = time.perf_counter() - t0
            self._observe_phase("merge", merge_seconds)
            if scores is not None:
                self.governor.observe_robust(scores)
            self._merge_mask = mask.copy()
            self.merge_round += 1
        # the tick's serving latency: poison through merge
        tick_seconds = time.perf_counter() - t_start
        if self.telemetry is not None:
            self._record_telemetry(
                t, batch, losses_np, drifted_np, fresh_np, n_fresh, decision, ingest_seconds,
                merge_seconds, tick_seconds, scores, nonfinite,
                None if served is None else served_np,
            )
        self._post_merge = decision.merge
        self.tick_no = t + 1
        return TickReport(
            tick=t, losses=losses_np, drifted=drifted_np, fresh_detections=fresh_np,
            decision=decision, merge_seconds=merge_seconds, robust_scores=scores,
            nonfinite_payloads=nonfinite, ingest_seconds=ingest_seconds,
            served=None if served is None else served_np,
        )

    def _record_telemetry(
        self, t: int, batch, losses: np.ndarray, drifted: np.ndarray, fresh: np.ndarray,
        n_fresh: int, decision: MergeDecision, ingest_seconds: float,
        merge_seconds: float | None, tick_seconds: float, robust_scores: np.ndarray | None,
        nonfinite: int, served: np.ndarray | None,
    ) -> None:
        """Fold one tick into the sink: counters, gauges and histograms,
        the flight-ring record, and the non-finite and SLO dump triggers."""
        tel, cfg = self.telemetry, self.config
        tel.ticks.inc()
        tel.tick_seconds.observe(tick_seconds)
        if n_fresh:
            tel.detections.inc(n_fresh)
        faults = cfg.faults.active_faults(t) if cfg.faults is not None else []
        for kind, n in faults:
            tel.fault_events.labels(kind=kind).inc(n)
        n_quarantined = int(drifted.sum())
        tel.quarantined.set(n_quarantined)
        if cfg.robust is not None:
            tel.robust_quarantined.set(int(self.governor.robust_quarantined.sum()))

        # the detector's band over calibrated devices (detector._sigma, the
        # band the flags fire against), read back from the card every
        # band_sample_every ticks: three reads of detector state per sample
        det_cfg = cfg.detector
        if t % tel.config.band_sample_every == 0:
            calibrated = self.det.count.cpu().numpy() >= det_cfg.warmup
            if calibrated.any():
                mean = self.det.mean.cpu().numpy()
                sigma = np.maximum(
                    np.sqrt(np.maximum(self.det.var.cpu().numpy(), 0.0)) + det_cfg.min_sigma,
                    det_cfg.rel_sigma * mean,
                )
                tel.band_width.observe_many(det_cfg.k_sigma * sigma[calibrated])
                tel.loss_ratio.observe_many(
                    losses[calibrated] / np.maximum(mean[calibrated], det_cfg.min_sigma))

        if decision.merge:
            tel.merge_rounds.inc()
            split = self.governor.round_bytes_by_precision(
                decision.participants, decision.fp_participants)
            for precision, nbytes in split.items():
                tel.merge_bytes.labels(precision=precision).inc(nbytes)
            if self._residual is not None:
                tel.ef_residual_norm.set(float(torch.sqrt(torch.sum(self._residual ** 2))))
        if nonfinite:
            tel.nonfinite.inc(nonfinite)

        # a partly served window: the padded rows scored padding, so the loss
        # statistics take the served devices only
        live = losses if served is None or served.all() else losses[served]
        if live.size == 0:
            live = losses
        rec = {
            "tick": t,
            "loss_mean": float(live.mean()),
            "loss_max": float(live.max()),
            "quarantined": n_quarantined,
            "fresh": np.flatnonzero(fresh).tolist() if n_fresh else [],
            "decision": {
                "merge": decision.merge, "reason": decision.reason,
                "participants": decision.participants,
                "round_bytes": decision.round_bytes,
                "fp_participants": decision.fp_participants,
            },
            "ingest_seconds": ingest_seconds,
            "merge_seconds": merge_seconds,
            "tick_seconds": tick_seconds,
            "nonfinite_payloads": nonfinite,
        }
        if served is not None and not served.all():
            rec["n_served"] = int(served.sum())
        if losses.shape[0] <= 512:
            # small fleets: the whole loss vector and quarantine set, what a
            # replay compares; large fleets keep the ring lean
            rec["losses"] = losses.tolist()
            rec["drifted"] = np.flatnonzero(drifted).tolist() if n_quarantined else []
        if faults:
            rec["faults"] = faults
        if robust_scores is not None and robust_scores.size:
            top = np.argsort(robust_scores)[::-1][:5]
            rec["robust_outliers"] = [(int(d), float(robust_scores[d])) for d in top]
        tel.flight.record(rec)

        if nonfinite:
            tel.maybe_dump(t, "nonfinite", inputs=_host(batch),
                           extra={"nonfinite_payloads": nonfinite})
        slo = tel.config.slo_tick_seconds
        if slo is not None and tick_seconds > slo:
            tel.slo_breaches.inc()
            tel.maybe_dump(t, "slo", inputs=_host(batch),
                           extra={"tick_seconds": tick_seconds, "slo_seconds": slo})

    def finalize_telemetry(self) -> dict | None:
        """Flush the sink's outputs (the trace and the exposition, with a
        directory) and return the end-of-run summary; None when telemetry
        is off."""
        if self.telemetry is None:
            return None
        self.telemetry.close()
        return self.telemetry.summary()

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
        (``quantize_pack`` when the payloads are int8, ``robust_segment_sum_mix``
        when a robust merge routes to it, ``dense_mix`` on a dense mask, the
        stale round's mix kernels when a staleness schedule is set), on
        all-zero operands and an all-zero mask, before live traffic arrives:
        the first real tick then does not pay for ``nvcc``. Every output is
        discarded — no model, detector, residual, payload, ring, governor or
        telemetry state changes."""
        saved = (self.states, self.det, self._residual, self._last_good)
        slot = None
        if self._hist is not None:
            slot = self.merge_round % self._hist.shape[0]
            saved_slot = self._hist[slot].clone()
        d, f = self.n_devices, self.states.params.alpha.shape[0]
        batch = torch.zeros((d, batch_size, f), dtype=torch.float32, device=self.device)
        self._ingest_detect(batch, np.zeros(d, bool))
        none = np.zeros(d, bool)
        self._merge(none, none, none, self.tick_no)
        _synchronize(self.device)
        self.states, self.det, self._residual, self._last_good = saved
        if slot is not None:
            self._hist[slot] = saved_slot
