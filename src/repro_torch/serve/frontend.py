"""ServeFrontend — the async ingress tier in front of ``FleetRuntime``;
port of ``repro.serve.frontend``.

Wires the serving pieces into one fault-tolerant loop:

- concurrent clients ``await submit(SampleRequest)`` and get exactly
  one ``Ack`` back;
- an ``AdmissionController`` decides admit/defer/shed/stale per
  submission from live pressure (queue depth, tick p99, the merge
  governor's comm-budget utilization, the degraded ladder);
- admitted requests accumulate in a ``WindowBuilder``; a batch loop
  closes windows on max-batch-or-max-delay deadlines, logs each to the
  ``WriteAheadLog``, and hands it to a single worker thread that runs
  the blocking ``runtime.tick`` off the event loop;
- a watchdog task folds stall/p99/depth pressure into the
  ``DegradedLadder`` (skip-merge → stale-scores → shed) and back out;
- ``recover()`` resumes after a crash: newest runtime snapshot, then
  contiguous WAL replay — the same ticks on the same inputs, so every
  admitted-but-unacked window trains exactly once.

The tick worker owns the runtime's device work. It warms the runtime up
itself (``runtime.warmup``: the kernel library built and loaded, every
kernel the tick reaches launched once) before ``start()`` returns, since
PyTorch keeps its cuBLAS and cuSOLVER handles and the current CUDA stream
per thread: a warm-up on any other thread would leave the first live tick
to create the worker's own. ``warmup_thread`` names the thread that ran it.

A window's batch stays a numpy array until ``runtime.tick`` moves it to
the runtime's device; the runtime's device decides where the fleet
serves. All metrics flow through the runtime's own ``TelemetrySink`` (the
ingress catalog pre-declared in ``repro_torch.obs.sink``): one registry,
one snapshot-riding state blob, no forked accounting.
"""
from __future__ import annotations

import asyncio
import dataclasses
import queue
import random
import threading
import time
from pathlib import Path
from typing import Callable

import numpy as np

from repro_torch.runtime.runtime import FleetRuntime, TickReport
from repro_torch.serve.admission import (
    ADMIT,
    DEFER,
    SHED,
    STALE,
    AdmissionConfig,
    AdmissionController,
)
from repro_torch.serve.batcher import TickWindow, WindowBuilder
from repro_torch.serve.degraded import DegradedLadder, LadderConfig, Mode
from repro_torch.serve.protocol import Ack, SampleRequest
from repro_torch.serve.wal import WriteAheadLog

__all__ = ["RetryConfig", "ServeConfig", "ServeFrontend"]


@dataclasses.dataclass(frozen=True)
class RetryConfig:
    """Jittered exponential backoff for deferred (busy) submissions."""

    max_attempts: int = 4
    base_s: float = 0.005
    max_s: float = 0.25
    jitter: float = 0.5      # uniform ±fraction of the computed delay

    def delay(self, attempt: int, rng: random.Random) -> float:
        d = min(self.base_s * (2.0 ** attempt), self.max_s)
        return d * (1.0 + self.jitter * (2.0 * rng.random() - 1.0))


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Static knobs of one serving front-end."""

    batch: int                       # B — per-device samples per tick window
    max_delay_s: float = 0.01        # deadline: close a non-full window
    close_at_requests: int | None = None  # fullness target (None = n_devices)
    max_inflight_windows: int = 2    # closed-but-unfinished window bound
    admission: AdmissionConfig = dataclasses.field(
        default_factory=AdmissionConfig
    )
    ladder: LadderConfig = dataclasses.field(default_factory=LadderConfig)
    retry: RetryConfig = dataclasses.field(default_factory=RetryConfig)
    wal_dir: str | Path | None = None  # None = no write-ahead log (no replay)
    tick_deadline_s: float = 1.0     # worker stall threshold (watchdog)
    watchdog_interval_s: float = 0.02
    drain_timeout_s: float = 30.0
    warmup: bool = True              # warm the runtime up on the tick worker
                                     # in start(), so the kernel build and the
                                     # worker's first launches can't trip the
                                     # stall watchdog into degraded mode
    seed: int = 0                    # retry-jitter rng seed
    pre_tick: Callable[[TickWindow], None] | None = None  # test/bench hook,
                                     # runs on the worker thread before each
                                     # tick (stall injection)


class ServeFrontend:
    """One ingress tier bound to one resident runtime."""

    def __init__(
        self,
        runtime: FleetRuntime,
        config: ServeConfig,
        *,
        fallback: np.ndarray | None = None,
    ) -> None:
        if runtime.telemetry is None:
            raise ValueError(
                "ServeFrontend requires RuntimeConfig(telemetry=...): the "
                "ingress counters, the degraded watchdog's p99 signal, and "
                "crash-continuity all live in the telemetry sink"
            )
        self.runtime = runtime
        self.config = config
        self.telemetry = runtime.telemetry
        d = runtime.n_devices
        if fallback is None:
            # the fleet's one basis α (F, Ñ) carries the feature dim
            n_features = int(runtime.states.params.alpha.shape[0])
            fallback = np.zeros((d, n_features), np.float32)
        self.builder = WindowBuilder(d, config.batch, fallback)
        self.admission = AdmissionController(
            config.admission, capacity=d * config.admission.max_queue_per_device
        )
        self.ladder = DegradedLadder(config.ladder)
        self.wal = (
            WriteAheadLog(config.wal_dir) if config.wal_dir is not None else None
        )
        self._close_at = (
            config.close_at_requests if config.close_at_requests is not None else d
        )
        self._rng = random.Random(config.seed)
        self._seq = runtime.tick_no
        self._futures: dict[int, asyncio.Future] = {}
        self._submit_t: dict[int, float] = {}
        self._client_inflight: dict[str, int] = {}
        self._last_scores = np.full(d, np.nan, np.float64)
        self._last_drifted = np.zeros(d, bool)
        self._inflight_windows = 0
        self._tick_started: float | None = None
        self._failed: str | None = None
        self._running = False
        self._tasks: list[asyncio.Task] = []
        self._worker: threading.Thread | None = None
        self._dispatch_q: queue.Queue = queue.Queue()
        self._loop: asyncio.AbstractEventLoop | None = None
        self._have_work = asyncio.Event()
        self._full = asyncio.Event()
        self._slots = asyncio.Semaphore(config.max_inflight_windows)
        self._idle = asyncio.Event()
        self._idle.set()
        self.warmup_thread: str | None = None  # the thread runtime.warmup ran on
        self._p99_count = -1   # tick_seconds.count when _p99 was computed
        self._p99: float | None = None

    @property
    def failed(self) -> str | None:
        """Why the front-end stopped admitting (a tick raised), else None."""
        return self._failed

    # ------------------------------------------------------------- lifecycle

    async def start(self) -> None:
        """Start the tick worker, which warms the runtime up before it takes
        a window, then the batch loop and the watchdog. Returns once the
        warm-up has finished; raises what the warm-up raised."""
        if self._running:
            return
        self._loop = asyncio.get_running_loop()
        ready = self._loop.create_future()
        self._worker = threading.Thread(
            target=self._worker_loop, args=(ready,), name="serve-tick-worker",
            daemon=True,
        )
        self._worker.start()
        try:
            await ready
        except BaseException:
            await self._loop.run_in_executor(None, self._worker.join)
            self._worker = None
            raise
        self._running = True
        self._tasks = [
            asyncio.create_task(self._batch_loop(), name="serve-batcher"),
            asyncio.create_task(self._watchdog_loop(), name="serve-watchdog"),
        ]

    async def stop(self, *, drain: bool = True) -> None:
        if drain and self._running:
            try:
                await asyncio.wait_for(
                    self._drained(), timeout=self.config.drain_timeout_s
                )
            except asyncio.TimeoutError:
                pass
        self._running = False
        self._have_work.set()  # wake the batch loop so it can exit
        for task in self._tasks:
            task.cancel()
        for task in self._tasks:
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass
        self._tasks = []
        if self._worker is not None:
            self._dispatch_q.put(None)
            await asyncio.get_running_loop().run_in_executor(
                None, self._worker.join
            )
            self._worker = None

    async def _drained(self) -> None:
        while self.builder.depth > 0 or self._inflight_windows > 0:
            self._idle.clear()
            await self._idle.wait()

    # --------------------------------------------------------------- ingress

    async def submit(self, req: SampleRequest) -> Ack:
        """One submission, one eventual Ack. Shed/busy/stale answer
        immediately; admitted requests resolve when their tick lands."""
        tel = self.telemetry
        t0 = time.perf_counter()
        if self._failed is not None:
            tel.ingress_shed.labels(reason="failed").inc()
            return Ack(req.request_id, "shed", reason=self._failed)
        if not self.builder.can_fit(req):
            tel.ingress_shed.labels(reason="malformed").inc()
            return Ack(
                req.request_id, "shed",
                reason=f"device/burst/features out of range for this fleet "
                       f"(D={self.builder.n_devices}, B={self.builder.batch}, "
                       f"F={self.builder.n_features})",
            )
        verdict, reason = self.admission.decide(
            req,
            mode=self.ladder.mode,
            device_depth=self.builder.device_depth(req.device),
            client_inflight=self._client_inflight.get(req.client, 0),
            total_depth=self.builder.depth,
            tick_p99_s=self._tick_p99(),
            budget_utilization=self.runtime.governor.budget_utilization(),
        )
        tel.ingress_admission_seconds.observe(time.perf_counter() - t0)
        if verdict == SHED:
            tel.ingress_shed.labels(reason=reason).inc()
            return Ack(req.request_id, "shed", reason=reason)
        if verdict == DEFER:
            tel.ingress_deferred.labels(reason=reason).inc()
            return Ack(req.request_id, "busy", reason=reason)
        if verdict == STALE:
            tel.ingress_stale.inc()
            score = self._last_scores[req.device]
            return Ack(
                req.request_id, "stale",
                score=None if np.isnan(score) else float(score),
                drifted=bool(self._last_drifted[req.device]),
                latency_s=time.perf_counter() - t0,
                reason=reason,
            )
        assert verdict == ADMIT
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._futures[req.request_id] = fut
        self._submit_t[req.request_id] = t0
        self._client_inflight[req.client] = (
            self._client_inflight.get(req.client, 0) + 1
        )
        self.builder.add(req)
        tel.ingress_accepted.inc()
        tel.ingress_queue_depth.set(self.builder.depth)
        self._have_work.set()
        self._idle.clear()
        if self.builder.depth >= self._close_at:
            self._full.set()
        return await fut

    def _tick_p99(self) -> float | None:
        """The sink's tick p99, as the reference reads it for every
        submission, recomputed only when a tick has landed since the last
        read: the quantile sorts the sample window (~0.2 ms of the loop's
        time), and the samples change only with the count."""
        t99 = self.telemetry.tick_seconds
        count = t99.count
        if count != self._p99_count:
            self._p99 = t99.quantile(0.99) if count else None
            self._p99_count = count
        return self._p99

    async def submit_with_retries(self, req: SampleRequest) -> Ack:
        """submit() plus jittered exponential backoff on ``busy``."""
        cfg = self.config.retry
        ack = await self.submit(req)
        attempt = 0
        while ack.status == "busy" and attempt + 1 < cfg.max_attempts:
            await asyncio.sleep(cfg.delay(attempt, self._rng))
            attempt += 1
            self.telemetry.ingress_retried.inc()
            ack = await self.submit(req)
        return dataclasses.replace(ack, attempts=attempt + 1)

    # ------------------------------------------------------------ batch loop

    async def _batch_loop(self) -> None:
        cfg = self.config
        while self._running:
            await self._have_work.wait()
            if not self._running:
                break
            try:
                await asyncio.wait_for(
                    self._full.wait(), timeout=cfg.max_delay_s
                )
            except asyncio.TimeoutError:
                pass
            self._full.clear()
            # backpressure on the runtime itself: never more than
            # max_inflight_windows closed-but-unfinished windows
            await self._slots.acquire()
            window = self.builder.close(
                self._seq, allow_merge=self.ladder.mode < Mode.SKIP_MERGE
            )
            if window is None:
                self._slots.release()
                self._have_work.clear()
                continue
            if self.wal is not None:
                self.wal.append(window)
            self._seq += 1
            self._inflight_windows += 1
            self.telemetry.ingress_queue_depth.set(self.builder.depth)
            if self.builder.depth == 0:
                self._have_work.clear()
            self._dispatch_q.put(window)

    def _settle(self, fut: asyncio.Future, err: BaseException | None) -> None:
        if fut.done():
            return
        if err is None:
            fut.set_result(None)
        else:
            fut.set_exception(err)

    def _worker_loop(self, ready: asyncio.Future) -> None:
        """Single consumer of closed windows — runtime.tick is blocking
        and stateful, so it runs here, strictly in seq order, after this
        thread's own warm-up."""
        assert self._loop is not None
        err: BaseException | None = None
        if self.config.warmup:
            try:
                self.runtime.warmup(self.config.batch)
                self.warmup_thread = threading.current_thread().name
            except BaseException as e:  # noqa: BLE001 — start() re-raises it
                err = e
        self._loop.call_soon_threadsafe(self._settle, ready, err)
        if err is not None:
            return
        while True:
            window = self._dispatch_q.get()
            if window is None:
                return
            self._tick_started = time.perf_counter()
            report: TickReport | None = None
            err = None
            try:
                if self.config.pre_tick is not None:
                    self.config.pre_tick(window)
                report = self.runtime.tick(
                    window.batch,
                    served=window.served,
                    allow_merge=window.allow_merge,
                )
                snap_every = self.runtime.config.snapshot_every
                if (
                    self.wal is not None
                    and self.runtime.ckpt is not None
                    and snap_every
                    and self.runtime.tick_no % snap_every == 0
                ):
                    # the runtime just snapshotted: everything below
                    # tick_no is durable, the log can shrink
                    self.wal.gc(self.runtime.tick_no)
            except BaseException as e:  # noqa: BLE001 — must reach the acks
                err = e
            finally:
                self._tick_started = None
            self._loop.call_soon_threadsafe(
                self._complete_window, window, report, err
            )

    def _complete_window(
        self,
        window: TickWindow,
        report: TickReport | None,
        err: BaseException | None,
    ) -> None:
        tel = self.telemetry
        now = time.perf_counter()
        if report is not None:
            served = np.flatnonzero(window.served)
            self._last_scores[served] = report.losses[served]
            self._last_drifted = report.drifted.astype(bool)
        elif err is not None:
            # fail-stop: a raised tick desynchronizes window seq from
            # runtime.tick_no, so this front-end stops admitting; the
            # durable path (snapshot + WAL) is the recovery story
            self._failed = f"tick {window.seq} raised: {err!r}"
        for req in window.requests:
            fut = self._futures.pop(req.request_id, None)
            t0 = self._submit_t.pop(req.request_id, now)
            n = self._client_inflight.get(req.client, 0)
            if n <= 1:
                self._client_inflight.pop(req.client, None)
            else:
                self._client_inflight[req.client] = n - 1
            if fut is None or fut.done():
                continue
            if err is not None:
                fut.set_result(Ack(
                    req.request_id, "failed",
                    latency_s=now - t0, reason=repr(err),
                ))
                continue
            assert report is not None
            latency = now - t0
            tel.ingress_acked.inc()
            tel.ingress_request_seconds.observe(latency)
            fut.set_result(Ack(
                req.request_id, "ok",
                tick=report.tick,
                score=float(report.losses[req.device]),
                drifted=bool(report.drifted[req.device]),
                latency_s=latency,
            ))
        self._inflight_windows -= 1
        self._slots.release()
        if self.builder.depth == 0 and self._inflight_windows == 0:
            self._idle.set()

    # -------------------------------------------------------------- watchdog

    async def _watchdog_loop(self) -> None:
        cfg = self.config
        tel = self.telemetry
        while self._running:
            await asyncio.sleep(cfg.watchdog_interval_s)
            started = self._tick_started
            stalled = (
                started is not None
                and time.perf_counter() - started > cfg.tick_deadline_s
            )
            slo = cfg.admission.slo_p99_s
            t99 = tel.tick_seconds
            p99_over = (
                slo is not None and t99.count > 0 and t99.quantile(0.99) > slo
            )
            depth_high = (
                self.builder.depth / self.admission.capacity
                >= cfg.admission.depth_high_frac
            )
            before = self.ladder.mode
            after = self.ladder.check(stalled or p99_over or depth_high)
            if after != before:
                tel.ingress_degraded_mode.set(int(after))
                tel.ingress_transitions.labels(mode=after.name.lower()).inc()

    # -------------------------------------------------------------- recovery

    def recover(self) -> tuple[int, int]:
        """Crash-restart entry point (call BEFORE ``start()``): restore
        the newest runtime snapshot (either package's file), then replay
        the contiguous WAL suffix (either package's log) — the same
        inputs, so the replayed ticks equal the lost ones and
        admitted-but-unacked windows train exactly once. The replay runs
        on the calling thread. Returns (restored_tick, replayed_windows)."""
        if self._running:
            raise RuntimeError("recover() must run before start()")
        try:
            restored = self.runtime.restore()
        except FileNotFoundError:
            restored = self.runtime.tick_no  # no snapshot yet: cold start
        replayed = 0
        if self.wal is not None:
            self.wal.gc(restored)
            for seq in self.wal.replayable(restored):
                batch, served, allow = self.wal.load(seq)
                report = self.runtime.tick(
                    batch, served=served, allow_merge=allow
                )
                live = np.flatnonzero(served)
                self._last_scores[live] = report.losses[live]
                self._last_drifted = report.drifted.astype(bool)
                self.telemetry.ingress_replayed.inc()
                replayed += 1
        self._seq = self.runtime.tick_no
        return restored, replayed
