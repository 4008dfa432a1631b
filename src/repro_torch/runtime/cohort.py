"""Cohort-paged fleet runtime; port of ``repro.runtime.cohort``.

``FleetRuntime`` keeps the whole stacked fleet on the card, which caps D at
the card's memory. This runtime splits the state by how it scales:

- the model state, every device's (P, β), O(D·(Ñ² + Ñm)), lives in a host
  ``FleetArena`` and only the active cohort's page is on the card. Pages
  stream through the fused ingest (``fleet_ingest_paged``): on a CUDA
  device the arena is pinned once when the runtime is built, cohort k+1's
  page is copied in on a copy stream while cohort k's ingest runs, and
  cohort k's trained page is copied back on another without blocking
  (``repro_torch.fleet.arena._Pager``); the tick waits for every copy
  before anything reads the arena on the host.
- the scalar state, O(D): the detector bank stays on the card, and the
  tick's losses are gathered there, page by page, so detection is one
  full-fleet ``detector_update`` a tick and the losses cross to the host
  once a tick.
- merges run as the two-tier tree of ``repro_torch.fleet.arena.CohortMerger``
  on the same pages and copy streams.

One divergence from the resident runtime, the reference's: the host knows
whether a tick rebases, so the fleet median of the common-mode rebase
(``common_mode_ratio``) is taken only on post-merge ticks and handed to
``detector_update`` as ``common=``.

The governor, the telemetry sink and the report are the resident runtime's;
the paging shows up as the ``page_in``/``page_out`` phases and the arena
and cohort gauges. Staleness, robust merges, fault injection, quantized
payloads and snapshots are refused, as in the reference.
"""
from __future__ import annotations

import logging
import time
from collections import Counter, deque

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.fleet.arena import CohortMerger, CohortSchedule, FleetArena, TierCost
from repro_torch.kernels import _lib, launch_counts
from repro_torch.kernels.fleet_ingest import fleet_ingest_paged
from repro_torch.obs import TelemetrySink
from repro_torch.runtime.detector import common_mode_ratio, detector_update, init_detector
from repro_torch.runtime.feed import TickFeed
from repro_torch.runtime.governor import MergeDecision, MergeGovernor
from repro_torch.runtime.runtime import _NULL_PHASE, RuntimeConfig, TickReport, _where_served

__all__ = ["CohortFleetRuntime"]

logger = logging.getLogger(__name__)

_UNSUPPORTED = (
    ("staleness", "the stale published-version ring stores full stacked "
     "payload histories — O(D·lag) device memory, the exact layout the "
     "arena exists to avoid"),
    ("robust", "robust merges score every device's payload jointly; a "
     "paged robust boundary needs its own two-tier scoring pass"),
    ("faults", "the fault injector's payload boundary operates on the "
     "full stacked (U, V) stack"),
)


class CohortFleetRuntime:
    """A paged fleet: host arena, detector bank and merges on ``device``
    (the card unless ``device="cpu"``), governor on the host."""

    def __init__(
        self,
        arena: FleetArena,
        config: RuntimeConfig,
        *,
        cohort_size: int | None = None,
        schedule: CohortSchedule | None = None,
        active_per_tick: int | None = None,
        policies: tuple = (),
        device: str | torch.device | None = None,
    ) -> None:
        d = arena.n_devices
        if config.topology.n_devices != d:
            raise ValueError(
                f"topology is for {config.topology.n_devices} devices, arena has {d}")
        for attr, why in _UNSUPPORTED:
            if getattr(config, attr) is not None:
                raise ValueError(f"cohort-paged runtime does not support {attr}: {why}")
        if config.payload_precision != "f32":
            raise ValueError(
                "cohort-paged runtime requires payload_precision='f32' (the quantized "
                "codec's error-feedback accumulator is a second full-fleet stack; page "
                "it before enabling this)")
        if config.snapshot_dir is not None or config.snapshot_every:
            raise ValueError(
                "cohort-paged runtime has no snapshot path yet — the checkpoint store "
                "serializes stacked fleets; persist the arena's leaves directly instead")
        if schedule is None:
            if cohort_size is None:
                raise ValueError("need cohort_size= (or a full schedule=)")
            schedule = CohortSchedule(d, cohort_size, active_per_tick)
        elif schedule.n_devices != d:
            raise ValueError(f"schedule D={schedule.n_devices} vs arena D={d}")

        self.device = resolve_device(device)
        if self.device.type == "cuda":
            arena._pin()
        self.arena = arena
        self.schedule = schedule
        self.config = config
        self.det = init_detector(d, device=self.device)
        self.governor = MergeGovernor(
            config.topology, arena.n_hidden, arena.n_out, config.governor,
            policies=policies, payload_precision=config.payload_precision,
        )
        self.merger = CohortMerger(config.topology, schedule, ridge=config.ridge,
                                   device=self.device)
        self._pager = self.merger._pager   # the merge's pages move on the same streams
        self.tick_no = 0
        self.merge_round = 0
        self.detections: deque[tuple[int, int]] = deque(maxlen=config.detections_cap)
        self.detections_total = 0
        self.telemetry = TelemetrySink(config.telemetry) if config.telemetry is not None else None
        self._post_merge = False
        self._merge_mask = np.ones(d, bool)
        self._merge_mask_dev = torch.ones(d, dtype=torch.bool, device=self.device)
        self._all_served = np.ones(d, bool)
        self._alpha = arena.alpha.to(self.device)
        self._bias = arena.bias.to(self.device)
        # the kernels this runtime launched in its ticks, and those its route
        # calls for (assert_compile_once)
        self._launched: Counter = Counter()
        self._expected: Counter = Counter()
        self.last_paging: dict[str, float] | None = None  # the last tick's copy times

    @property
    def n_devices(self) -> int:
        return self.arena.n_devices

    # ------------------------------------------------------------- tick loop

    def _phase(self, name: str):
        return _NULL_PHASE if self.telemetry is None else self.telemetry.phase(name)

    def _observe_phase(self, name: str, seconds: float) -> None:
        if self.telemetry is not None:
            self.telemetry._phase_observe[name](seconds)

    def _resolve_batch(self, batch):
        """The tick's data as ``fn(lo, hi) -> (C, B, F)``: a callable as it
        is (at arena scale the full batch would be the second thing that
        does not fit), a full (D, B, F) array or tensor sliced."""
        if callable(batch):
            return batch
        arr = batch if isinstance(batch, torch.Tensor) else np.asarray(batch)
        d = self.n_devices
        if arr.ndim != 3 or arr.shape[0] != d:
            raise ValueError(
                f"tick batch must be (n_devices={d}, B, features) or a callable "
                f"(lo, hi) -> (cohort, B, features); got shape {tuple(arr.shape)}")
        if arr.shape[1] < 1:
            raise ValueError(
                "tick batch has zero samples per device (B=0) — an all-shed tick window "
                "carries no data to ingest")
        return lambda lo, hi: arr[lo:hi]

    def _window(self, win, lo: int, hi: int) -> torch.Tensor:
        if isinstance(win, torch.Tensor):
            win = win.to(torch.float32)
        else:
            win = torch.from_numpy(np.ascontiguousarray(win, np.float32))
        c = self.schedule.cohort_size
        if win.ndim != 3 or win.shape[0] != c or win.shape[1] < 1:
            raise ValueError(
                f"cohort batch for [{lo}, {hi}) must be ({c}, B>=1, features); "
                f"got {tuple(win.shape)}")
        return win

    def _ingest_pages(self, active: list[int], batch_fn, served: np.ndarray) -> torch.Tensor:
        """Stream the active cohorts' pages through the fused ingest; the
        (D,) pre-train losses, NaN off the active cohorts, on the device."""
        arena, sched = self.arena, self.schedule
        losses = torch.full((self.n_devices,), torch.nan, dtype=torch.float32,
                            device=self.device)

        def inputs(lo, hi):
            return (arena.p[lo:hi], arena.beta[lo:hi], self._window(batch_fn(lo, hi), lo, hi),
                    served[lo:hi])

        def ingest(lo, hi, p, beta, window, keep):
            p2, b2, page_losses = fleet_ingest_paged(
                p, beta, self._alpha, self._bias, window,
                activation=arena.activation, forget=arena.forget)
            # an unserved device keeps its page rows bit for bit
            sel = keep[:, None, None]
            losses[lo:hi] = page_losses
            return ((arena.p[lo:hi], torch.where(sel, p2, p)),
                    (arena.beta[lo:hi], torch.where(sel, b2, beta)))

        self._pager.loop([sched.bounds(k) for k in active], inputs, ingest)
        return losses

    def _detect(self, losses: torch.Tensor, served_eff: np.ndarray):
        """One full-fleet detector update on the device; the common-mode
        median only on a rebase tick, from the pre-update bank."""
        cfg = self.config.detector
        if self._post_merge:
            common = common_mode_ratio(self.det, losses, cfg, participants=self._merge_mask_dev)
        else:
            common = 1.0  # unused: no device rebases
        det_new, _, fresh = detector_update(
            self.det, losses, cfg, rebase=self._post_merge,
            participants=self._merge_mask_dev, common=common)
        keep = torch.as_tensor(served_eff, device=self.device)
        self.det = _where_served(keep, det_new, self.det)
        return self.det.drifted, fresh & keep

    def tick(
        self,
        batch,
        *,
        served: np.ndarray | None = None,
        allow_merge: bool = True,
    ) -> TickReport:
        """One paged tick: the active cohorts' pages through ingest, one
        full-fleet detect, then govern and maybe the two-tier merge on the
        arena. ``batch`` is a (D, B, F) array or tensor, or a callable
        ``(lo, hi) -> (cohort, B, F)``. Devices of cohorts outside this
        tick's active window report NaN losses and keep their model and
        detector state."""
        t = self.tick_no
        d = self.n_devices
        sched = self.schedule
        batch_fn = self._resolve_batch(batch)
        if served is None:
            served_np = self._all_served
        else:
            served_np = np.asarray(served).astype(bool)
            if served_np.shape != (d,):
                raise ValueError(f"served mask must be ({d},); got {served_np.shape}")
        active = sched.active(t)
        tel = self.telemetry
        counts0 = launch_counts()
        t_start = time.perf_counter()

        # devices actually serving this tick: served and in an active cohort
        if len(active) == sched.n_cohorts:
            served_eff = served_np
        else:
            served_eff = np.zeros(d, bool)
            for k in active:
                lo, hi = sched.bounds(k)
                served_eff[lo:hi] = served_np[lo:hi]

        t0 = time.perf_counter()
        losses = self._ingest_pages(active, batch_fn, served_np)
        paging = self._pager.times()
        drifted, fresh = self._detect(losses, served_eff)
        losses_np = losses.cpu().numpy()
        drifted_np = drifted.cpu().numpy()
        fresh_np = fresh.cpu().numpy()
        ingest_seconds = time.perf_counter() - t0
        self._observe_phase("page_in", paging["in_s"])
        self._observe_phase("page_out", paging["out_s"])
        self._observe_phase("ingest", ingest_seconds)
        self._expected["fleet_ingest"] += len(active)

        n_fresh = int(fresh_np.sum())
        self.detections_total += n_fresh
        for dev in np.flatnonzero(fresh_np):
            self.detections.append((t, int(dev)))

        with self._phase("govern"):
            if self.config.gate_merges:
                mask = self.governor.participation(drifted_np, losses_np)
            else:
                mask = np.ones(d, bool)
            decision = self.governor.decide(t, mask, None, allow=allow_merge)

        merge_seconds = None
        tier_cost: TierCost | None = None
        if decision.merge:
            t0 = time.perf_counter()
            with self._phase("merge"):
                tier_cost = self.merger.merge(self.arena, mask)
            merge_seconds = time.perf_counter() - t0
            self.merge_round += 1
            self._expected.update(self.merger.launches_per_round())
            merge_paging = self._pager.times()
            paging["merge_in_s"] = merge_paging["in_s"]
            paging["merge_out_s"] = merge_paging["out_s"]
            paging["merge_compute_s"] = merge_paging["compute_s"]
        self.last_paging = paging

        tick_seconds = time.perf_counter() - t_start
        counts1 = launch_counts()
        self._launched.update({k: counts1[k] - counts0[k] for k in counts1})
        if tel is not None:
            self._record_telemetry(
                t, losses_np, drifted_np, fresh_np, n_fresh, decision, tier_cost,
                ingest_seconds, merge_seconds, tick_seconds, served_eff, len(active))

        self._post_merge = decision.merge
        if decision.merge:
            self._merge_mask = mask.copy()
            self._merge_mask_dev = torch.as_tensor(mask, device=self.device)
        self.tick_no = t + 1
        full = served is None and len(active) == sched.n_cohorts
        return TickReport(
            tick=t, losses=losses_np, drifted=drifted_np, fresh_detections=fresh_np,
            decision=decision, merge_seconds=merge_seconds, ingest_seconds=ingest_seconds,
            served=None if full else served_eff,
        )

    # ---------------------------------------------------------- telemetry

    def _record_telemetry(
        self, t: int, losses: np.ndarray, drifted: np.ndarray, fresh: np.ndarray,
        n_fresh: int, decision: MergeDecision, tier_cost: TierCost | None,
        ingest_seconds: float, merge_seconds: float | None, tick_seconds: float,
        served: np.ndarray, n_active: int,
    ) -> None:
        tel = self.telemetry
        tel.ticks.inc()
        tel.tick_seconds.observe(tick_seconds)
        tel.cohort_pages.inc(n_active)
        if n_fresh:
            tel.detections.inc(n_fresh)
        tel.quarantined.set(int(drifted.sum()))
        tel.arena_bytes.set(self.arena.nbytes)
        # residency: the devices of the streaming window
        tel.arena_resident_devices.set(n_active * self.schedule.cohort_size)
        if decision.merge:
            tel.merge_rounds.inc()
            split = self.governor.round_bytes_by_precision(
                decision.participants, decision.fp_participants)
            for precision, nbytes in split.items():
                tel.merge_bytes.labels(precision=precision).inc(nbytes)
            if tier_cost is not None:
                tel.merge_tier_bytes.labels(tier="intra").inc(tier_cost.bytes_tier1)
                tel.merge_tier_bytes.labels(tier="inter").inc(tier_cost.bytes_tier2)
        live = losses[served] if not served.all() else losses
        if live.size == 0:
            live = losses
        rec = {
            "tick": t,
            "loss_mean": float(np.nanmean(live)) if live.size else float("nan"),
            "loss_max": float(np.nanmax(live)) if live.size else float("nan"),
            "quarantined": int(drifted.sum()),
            "fresh": np.flatnonzero(fresh).tolist() if n_fresh else [],
            "decision": {
                "merge": decision.merge, "reason": decision.reason,
                "participants": decision.participants,
                "round_bytes": decision.round_bytes,
            },
            "active_cohorts": n_active,
            "ingest_seconds": ingest_seconds,
            "merge_seconds": merge_seconds,
            "tick_seconds": tick_seconds,
        }
        if tier_cost is not None:
            rec["tier_bytes"] = {"intra": tier_cost.bytes_tier1, "inter": tier_cost.bytes_tier2}
        tel.flight.record(rec)
        slo = tel.config.slo_tick_seconds
        if slo is not None and tick_seconds > slo:
            tel.slo_breaches.inc()
            tel.maybe_dump(t, "slo", extra={"tick_seconds": tick_seconds, "slo_seconds": slo})

    def finalize_telemetry(self) -> dict | None:
        if self.telemetry is None:
            return None
        self.telemetry.close()
        return self.telemetry.summary()

    # ------------------------------------------------------------- driving

    def run(self, feed: TickFeed, *, ticks: int | None = None) -> list[TickReport]:
        """Drive the runtime over a feed (all of it by default)."""
        if ticks is not None and ticks > feed.n_ticks:
            logger.warning("run(ticks=%d) exceeds the feed's %d ticks; truncating",
                           ticks, feed.n_ticks)
        n = feed.n_ticks if ticks is None else min(ticks, feed.n_ticks)
        return [self.tick(feed.tick_batch(t)) for t in range(n)]

    def warmup(self, batch_size: int) -> None:
        """Build the kernels and launch each kernel the tick and the merge
        route to once, on copies of the first page, an all-zero window and
        an all-zero mask, before live traffic arrives; call it on the thread
        that will tick. Every output is discarded: no model, detector,
        governor or telemetry state changes, and its launches are not
        counted as the runtime's."""
        arena = self.arena
        lo, hi = self.schedule.bounds(0)
        p = arena.p[lo:hi].to(self.device)
        b = arena.beta[lo:hi].to(self.device)
        window = torch.zeros((hi - lo, batch_size, arena.n_features), dtype=torch.float32,
                             device=self.device)
        _, _, losses = fleet_ingest_paged(p, b, self._alpha, self._bias, window,
                                          activation=arena.activation, forget=arena.forget)
        full = torch.zeros(self.n_devices, dtype=torch.float32, device=self.device)
        full[lo:hi] = losses
        common_mode_ratio(self.det, full, self.config.detector, participants=self._merge_mask_dev)
        detector_update(self.det, full, self.config.detector, common=1.0)
        self.merger.warmup(arena)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def assert_compile_once(self) -> None:
        """The port's counterpart of the reference's compile-once check:
        on the card the kernel library was loaded once, and this runtime's
        ticks launched ``fleet_ingest`` once per active page a tick and the
        merge kernels once per page or round as its route calls for, and
        nothing else that is counted. On the CPU the plain versions stand
        in and nothing is counted or asserted."""
        if self.device.type != "cuda":
            return
        loads = _lib.library.cache_info().misses
        if loads != 1:
            raise AssertionError(f"the kernel library was loaded {loads} times, not once")
        got = {k: v for k, v in self._launched.items() if v}
        want = {k: v for k, v in self._expected.items() if v}
        if got != want:
            raise AssertionError(f"launches {got}, expected the routed pages and rounds {want}")
