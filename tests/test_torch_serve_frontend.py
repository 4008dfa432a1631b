"""The port's serving front-end (``repro_torch.serve``) against the
reference's (``repro.serve``), on the CPU.

(a) The reference's ``tests/test_serve.py`` unit cases — the request
    protocol, the batcher (whole requests, padding, the fallback row,
    misfits, the head-blocked close, the window-partition property as a
    deterministic sweep), the write-ahead log (round trip, gc, a gap,
    stale tmp files, a malformed name), the admission branches and the
    ladder's hysteresis — each run on both packages (``pkg``).
(b) WAL files cross between the packages: an entry written by either
    loads in the other, array for array and dtype for dtype.
(c) ``MergeGovernor.budget_utilization`` equals the reference's on the
    same ledger.
(d) The port's async front-end on its own: every request acked once
    (also under 12 clients with a shortened switch interval), a
    malformed request shed, the warm-up on the tick worker's thread, a
    failed tick acked ``failed`` and the front-end stopped, the skip-merge
    veto, and its own crash recovery bit for bit.
(e) The slice's differential: the reference's files are written without
    asyncio (its ``WindowBuilder``, ``WriteAheadLog`` and
    ``FleetRuntime.tick`` on seeded requests at D = 16, n = 16, Ñ = 8 on
    a ring, snapshots every 4 ticks), and the port's ``ServeFrontend``
    recovers from that directory: the reference's snapshot and WAL. Each
    replayed tick's flags, merge decision and participants equal the
    reference's own replay, losses within ``test_torch_runtime.py``'s
    bounds (1e-5 up to the first merge, 2e-4 after), and the telemetry
    counters carry on. Then both front-ends serve the same waves, each
    wave exactly one full window (``close_at_requests``, a deadline that
    never fires, one request a device), so that no timing decides a
    window: acks' status, tick and drifted flags equal, scores within the
    same bounds. No assertion rests on a wall-clock time.
"""
import asyncio
import dataclasses
import logging
import shutil
import sys
import threading
import types

import jax
import numpy as np
import pytest
import torch

import repro.serve as ref_serve
import repro_torch.serve as port_serve
from repro.fleet import init_fleet as ref_init_fleet
from repro.fleet import ring as ref_ring
from repro.obs import TelemetryConfig as RefTelemetryConfig
from repro.runtime import (
    DetectorConfig as RefDetectorConfig,
    FleetRuntime as RefRuntime,
    GovernorConfig as RefGovernorConfig,
    MergeGovernor as RefMergeGovernor,
    RuntimeConfig as RefRuntimeConfig,
)
from repro_torch.convert import oselm_state_from_numpy
from repro_torch.fleet import init_fleet, ring
from repro_torch.obs import TelemetryConfig
from repro_torch.runtime import (
    DetectorConfig,
    FleetRuntime,
    GovernorConfig,
    MergeGovernor,
    RuntimeConfig,
)

torch.set_num_threads(2)

D, F, H, B = 8, 6, 4, 3
RIDGE = 1e-3
PKGS = {"ref": ref_serve, "port": port_serve}


@pytest.fixture(params=sorted(PKGS))
def pkg(request) -> types.ModuleType:
    return PKGS[request.param]


def _rng(seed=0):
    return np.random.default_rng(seed)


def _req(pkg, device=0, k=1, client="c", seed=1):
    return pkg.SampleRequest(
        device=device, x=_rng(seed).normal(size=(k, F)).astype(np.float32), client=client,
    )


def _builder(pkg):
    return pkg.WindowBuilder(D, B, np.zeros((D, F), np.float32))


# ------------------------------------------------------------------ protocol


def test_request_promotes_1d_and_validates(pkg):
    r = pkg.SampleRequest(device=1, x=np.zeros(F, np.float32))
    assert r.x.shape == (1, F) and r.n_samples == 1
    assert r.x.dtype == np.float32 and isinstance(r.x, np.ndarray)
    with pytest.raises(ValueError, match="k>=1"):
        pkg.SampleRequest(device=0, x=np.zeros((0, F), np.float32))
    with pytest.raises(ValueError):
        pkg.SampleRequest(device=0, x=np.zeros((2, 2, F), np.float32))


def test_request_ids_unique_and_monotone(pkg):
    ids = [_req(pkg, seed=i).request_id for i in range(32)]
    assert len(set(ids)) == 32 and ids == sorted(ids)


def test_ack_statuses(pkg):
    assert pkg.Ack(0, "ok").ok and not pkg.Ack(0, "ok").retryable
    assert pkg.Ack(0, "busy").retryable and pkg.Ack(0, "shed").retryable
    assert not pkg.Ack(0, "failed").ok and not pkg.Ack(0, "stale").retryable


# ------------------------------------------------------------------- batcher


def test_batcher_window_shapes_and_served_mask(pkg):
    wb = _builder(pkg)
    wb.add(_req(pkg, device=2, k=2, seed=1))
    wb.add(_req(pkg, device=5, k=1, seed=2))
    w = wb.close(0)
    assert w.batch.shape == (D, B, F) and w.batch.dtype == np.float32
    assert w.served.tolist() == [d in (2, 5) for d in range(D)]
    assert w.n_requests == 2 and w.n_samples == 3
    assert wb.depth == 0
    # un-served rows padded with the fallback (zeros here)
    np.testing.assert_array_equal(w.batch[0], 0.0)
    # partially-filled served rows pad by cycling their own samples
    np.testing.assert_array_equal(w.batch[2][2], w.batch[2][0])


def test_batcher_takes_whole_requests_only(pkg):
    wb = _builder(pkg)
    wb.add(_req(pkg, device=1, k=2, seed=1))
    wb.add(_req(pkg, device=1, k=2, seed=2))  # 2+2 > B=3: must wait a window
    w = wb.close(0)
    assert w.n_requests == 1 and w.n_samples == 2
    assert wb.depth == 1
    w2 = wb.close(1)
    assert w2.n_requests == 1
    assert wb.close(2) is None  # empty: no window


def test_batcher_fallback_tracks_last_served_sample(pkg):
    wb = _builder(pkg)
    r = _req(pkg, device=3, k=2, seed=5)
    wb.add(r)
    wb.close(0)
    np.testing.assert_array_equal(wb.fallback[3], r.x[1])


def test_batcher_rejects_misfits(pkg):
    wb = _builder(pkg)
    with pytest.raises(ValueError, match="does not fit"):
        wb.add(_req(pkg, device=D, k=1))       # device out of range
    with pytest.raises(ValueError, match="does not fit"):
        wb.add(_req(pkg, device=0, k=B + 1))   # burst over budget
    assert not wb.can_fit(pkg.SampleRequest(device=0, x=np.zeros((1, F + 1), np.float32)))


def test_batcher_head_blocked_close_raises_pre_mutation(pkg):
    """A head request larger than the window budget can never ride any
    window; close() raises before popping anything, so the depth
    invariant (Σ queue lengths == depth) survives the failed close."""
    wb = _builder(pkg)
    wb.add(_req(pkg, device=1, k=1, seed=1))
    wb.add(_req(pkg, device=4, k=2, seed=2))
    oversized = pkg.SampleRequest(device=4, x=_rng(3).normal(size=(B + 2, F)).astype(np.float32))
    wb.pending[4].appendleft(oversized)  # bypasses add()'s burst cap
    wb.depth += 1
    before = [list(q) for q in wb.pending]
    with pytest.raises(ValueError, match="head-blocked"):
        wb.close(0)
    assert [list(q) for q in wb.pending] == before
    assert wb.depth == sum(len(q) for q in wb.pending) == 3
    assert wb.pending[4].popleft() is oversized
    wb.depth -= 1
    w = wb.close(0)
    assert w.n_requests == 2
    assert wb.depth == 0


@pytest.mark.parametrize("seed,n,closes_between", [
    (0, 0, 1), (1, 7, 1), (2, 24, 2), (3, 24, 5), (4, 13, 3), (5, 24, 6),
])
def test_batcher_partition_property(pkg, seed, n, closes_between):
    """Under an admit/close script, depth always equals Σ queue lengths
    and every admitted request lands in exactly one window."""
    rng = _rng(seed)
    script = [(int(rng.integers(0, D)), int(rng.integers(1, B + 1))) for _ in range(n)]
    wb = _builder(pkg)
    admitted, dispatched = [], []
    seq = 0
    while script or wb.depth:
        for device, k in script[:closes_between]:
            r = _req(pkg, device=device, k=k, seed=len(admitted))
            wb.add(r)
            admitted.append(r.request_id)
            assert wb.depth == sum(len(q) for q in wb.pending)
        script = script[closes_between:]
        w = wb.close(seq, allow_merge=bool(seq % 2))
        seq += 1
        if w is not None:
            dispatched.extend(r.request_id for r in w.requests)
            assert w.served.sum() > 0
            assert w.n_samples <= D * B
            assert w.allow_merge == bool(w.seq % 2)
        assert wb.depth == sum(len(q) for q in wb.pending)
        assert len(set(dispatched)) == len(dispatched), "double-dispatch"
    assert wb.close(seq) is None
    assert sorted(dispatched) == sorted(admitted), "lost or dropped request"


def test_batcher_windows_equal_across_packages():
    """The same admit/close script cuts the same windows in both
    packages, bit for bit."""
    builders = {name: _builder(p) for name, p in PKGS.items()}
    rng = _rng(7)
    for seq in range(6):
        burst = [(int(rng.integers(0, D)), int(rng.integers(1, B + 1)), int(rng.integers(99)))
                 for _ in range(5)]
        windows = {}
        for name, p in PKGS.items():
            for device, k, s in burst:
                builders[name].add(_req(p, device=device, k=k, seed=s))
            windows[name] = builders[name].close(seq, allow_merge=seq != 3)
        a, b = windows["ref"], windows["port"]
        assert a.batch.tobytes() == b.batch.tobytes()
        assert np.array_equal(a.served, b.served)
        assert (a.seq, a.allow_merge, a.n_samples, a.n_requests) == (
            b.seq, b.allow_merge, b.n_samples, b.n_requests)
        assert builders["ref"].fallback.tobytes() == builders["port"].fallback.tobytes()


# ----------------------------------------------------------------------- wal


def test_wal_roundtrip_and_gc(pkg, tmp_path):
    wal = pkg.WriteAheadLog(tmp_path)
    wb = _builder(pkg)
    for seq in range(3):
        wb.add(_req(pkg, device=seq, k=1, seed=seq))
        wal.append(wb.close(seq))
    assert wal.entries() == [0, 1, 2]
    batch, served, allow = wal.load(1)
    assert batch.shape == (D, B, F) and served[1] and allow
    assert wal.gc(before=2) == 2
    assert wal.entries() == [2]


def test_wal_contiguity_gap_raises(pkg, tmp_path):
    wal = pkg.WriteAheadLog(tmp_path)
    wb = _builder(pkg)
    for seq in (4, 5, 7):  # hole at 6
        wb.add(_req(pkg, device=0, k=1, seed=seq))
        wal.append(wb.close(seq))
    with pytest.raises(RuntimeError, match="gap"):
        wal.replayable(4)
    # entries below from_seq are covered by the snapshot: not a gap
    assert wal.replayable(7) == [7]


def test_wal_cleans_stale_tmp(pkg, tmp_path):
    (tmp_path / "wal_00000009.npz.123.tmp").write_bytes(b"torn")
    wal = pkg.WriteAheadLog(tmp_path)
    assert wal.entries() == []
    assert not list(tmp_path.glob("*.tmp"))


def test_wal_warns_on_malformed_filename(pkg, tmp_path, caplog):
    wal = pkg.WriteAheadLog(tmp_path)
    wb = _builder(pkg)
    wb.add(_req(pkg, device=0, k=1, seed=0))
    wal.append(wb.close(3))
    (tmp_path / "wal_corrupted.npz").write_bytes(b"junk")
    with caplog.at_level(logging.WARNING, logger=f"{pkg.__name__}.wal"):
        assert wal.entries() == [3]  # junk skipped, real entry kept
    assert any("wal_corrupted.npz" in rec.message for rec in caplog.records)
    assert wal.replayable(3) == [3]


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_wal_files_cross_between_packages(tmp_path, writer, reader):
    """An entry written by either package loads in the other with the
    same file name, keys, arrays and dtypes."""
    w_pkg, r_pkg = PKGS[writer], PKGS[reader]
    wal = w_pkg.WriteAheadLog(tmp_path)
    wb = _builder(w_pkg)
    windows = []
    for seq in range(10, 13):
        for dev in range(seq % 4, D, 3):
            wb.add(_req(w_pkg, device=dev, k=1 + dev % B, seed=seq * D + dev))
        windows.append(wb.close(seq, allow_merge=seq != 11))
        wal.append(windows[-1])
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"wal_{s:08d}.npz" for s in range(10, 13)]
    other = r_pkg.WriteAheadLog(tmp_path)
    assert other.entries() == [10, 11, 12] and other.replayable(10) == [10, 11, 12]
    for w in windows:
        batch, served, allow = other.load(w.seq)
        mine = wal.load(w.seq)
        assert batch.dtype == np.float32 and served.dtype == bool
        assert batch.tobytes() == w.batch.tobytes() == mine[0].tobytes()
        assert np.array_equal(served, w.served) and np.array_equal(served, mine[1])
        assert allow == w.allow_merge == mine[2]
    with np.load(tmp_path / "wal_00000011.npz") as z:
        assert sorted(z.files) == ["allow_merge", "batch", "seq", "served"]
        assert z["seq"].dtype == np.int64 and int(z["seq"]) == 11
        assert z["allow_merge"].dtype == np.int64 and int(z["allow_merge"]) == 0
    assert other.gc(before=12) == 2 and wal.entries() == [12]


# ----------------------------------------------------------------- admission


def test_admission_policy_branches(pkg):
    cfg = pkg.AdmissionConfig(
        max_queue_per_device=2, client_cap=4, depth_high_frac=0.5,
        slo_p99_s=0.1, slo_min_depth_frac=0.25, budget_defer_frac=0.9,
    )
    ctl = pkg.AdmissionController(cfg, capacity=16)
    mode = pkg.Mode
    base = dict(mode=mode.NORMAL, device_depth=0, client_inflight=0, total_depth=0,
                tick_p99_s=None, budget_utilization=0.0)
    req = _req(pkg)
    assert ctl.decide(req, **base) == ("admit", "admit")
    assert ctl.decide(req, **{**base, "mode": mode.SHED}) == ("shed", "degraded")
    assert ctl.decide(req, **{**base, "mode": mode.STALE_SCORES}) == ("stale", "degraded")
    assert ctl.decide(req, **{**base, "device_depth": 2}) == ("defer", "queue_full")
    assert ctl.decide(req, **{**base, "client_inflight": 4}) == ("defer", "client_cap")
    assert ctl.decide(req, **{**base, "total_depth": 8}) == ("defer", "backpressure")
    # a p99 breach alone (quiet queue) does not defer: no deadlock
    assert ctl.decide(req, **{**base, "tick_p99_s": 0.2}) == ("admit", "admit")
    assert ctl.decide(req, **{**base, "tick_p99_s": 0.2, "total_depth": 4}) == ("defer", "slo")
    assert ctl.decide(req, **{**base, "budget_utilization": 0.95}) == ("defer", "comm_budget")
    # the branch order: degraded before queue_full before client_cap ...
    assert ctl.decide(req, **{**base, "mode": mode.SHED, "device_depth": 2}) == (
        "shed", "degraded")
    assert ctl.decide(req, **{**base, "device_depth": 2, "client_inflight": 4}) == (
        "defer", "queue_full")
    assert ctl.decide(req, **{**base, "client_inflight": 4, "total_depth": 8}) == (
        "defer", "client_cap")
    shed_ctl = pkg.AdmissionController(
        pkg.AdmissionConfig(max_queue_per_device=2, overflow="shed"), capacity=16)
    assert shed_ctl.decide(req, **{**base, "device_depth": 2}) == ("shed", "queue_full")
    with pytest.raises(ValueError, match="defer|shed"):
        pkg.AdmissionConfig(overflow="drop")


# -------------------------------------------------------------------- ladder


def test_ladder_hysteresis_one_rung_at_a_time(pkg):
    mode = pkg.Mode
    ladder = pkg.DegradedLadder(pkg.LadderConfig(escalate_after=2, recover_after=3))
    assert ladder.check(True) == mode.NORMAL      # 1 strike: no move
    assert ladder.check(True) == mode.SKIP_MERGE  # 2 strikes: one rung
    assert ladder.check(True) == mode.SKIP_MERGE
    assert ladder.check(True) == mode.STALE_SCORES
    ladder.check(True), ladder.check(True)
    assert ladder.mode == mode.SHED
    ladder.check(True)
    assert ladder.mode == mode.SHED               # ceiling holds
    for _ in range(2):
        ladder.check(False)
    assert ladder.mode == mode.SHED               # 2 calm < recover_after
    assert ladder.check(False) == mode.STALE_SCORES
    ladder.check(True)                            # pressure resets the calm run
    for _ in range(3):
        ladder.check(False)
    assert ladder.mode == mode.SKIP_MERGE
    for _ in range(3):
        ladder.check(False)
    assert ladder.mode == mode.NORMAL
    assert len(ladder.transitions) == 6
    assert [int(m) for _, m in ladder.transitions] == [1, 2, 3, 2, 1, 0]


# ------------------------------------------------------- budget utilization


@pytest.mark.parametrize("budget", [None, 3.0e4, 1.2e5])
def test_budget_utilization_matches_reference(budget):
    """The same decisions on the same ledger: utilization equal to the
    reference's after every tick (0.0 with no budget)."""
    d, nh, m = 12, 8, 16
    cfg = dict(merge_every=3, budget_bytes_per_tick=budget)
    ref = RefMergeGovernor(ref_ring(d, hops=2), nh, m, RefGovernorConfig(**cfg))
    port = MergeGovernor(ring(d, hops=2), nh, m, GovernorConfig(**cfg))
    rng = _rng(3)
    merges = 0
    for t in range(30):
        mask = rng.random(d) < 0.8
        a, b = ref.decide(t, mask), port.decide(t, mask)
        assert (a.merge, a.reason, a.round_bytes) == (b.merge, b.reason, b.round_bytes)
        assert port.budget_utilization() == ref.budget_utilization()
        merges += a.merge
    assert merges > 0
    if budget is None:
        assert port.budget_utilization() == 0.0
    else:
        assert port.budget_utilization() > 0.0


# -------------------------------------------------- the port's front-end


def _port_runtime(tmp_path=None, *, snapshot_every=None, merge_every=4, d=D):
    x_init = _rng(0).normal(size=(d, 2 * H, F)).astype(np.float32)
    fleet = init_fleet(torch.Generator().manual_seed(0), d, F, H, x_init,
                       activation="identity", ridge=RIDGE, device="cpu")
    return FleetRuntime(fleet, RuntimeConfig(
        topology=ring(d, hops=1),
        governor=GovernorConfig(merge_every=merge_every),
        snapshot_dir=None if tmp_path is None else str(tmp_path / "snap"),
        snapshot_every=snapshot_every,
        telemetry=TelemetryConfig(trace=False),
    ), device="cpu")


def _frontend(rt, **kw):
    kw.setdefault("batch", B)
    kw.setdefault("max_delay_s", 0.003)
    kw.setdefault("close_at_requests", 4)
    kw.setdefault("warmup", False)
    return port_serve.ServeFrontend(rt, port_serve.ServeConfig(**kw))


def test_frontend_serves_and_acks_every_request():
    rt = _port_runtime()
    fe = _frontend(rt)
    rng = _rng(3)

    async def drive():
        await fe.start()
        acks = await asyncio.gather(*[
            fe.submit_with_retries(port_serve.SampleRequest(
                device=int(rng.integers(D)), x=rng.normal(size=(1, F)).astype(np.float32),
                client=f"c{i % 3}",
            )) for i in range(24)
        ])
        await fe.stop()
        return acks

    acks = asyncio.run(drive())
    assert all(a.ok for a in acks), {a.status for a in acks}
    assert all(a.score is not None and a.latency_s > 0 for a in acks)
    ing = rt.telemetry.summary()["ingress"]
    assert ing["accepted"] == 24 and ing["acked"] == 24
    assert rt.tick_no > 0 and fe.failed is None
    assert not fe._futures and not fe._client_inflight  # nothing leaked


def test_frontend_rejects_malformed_without_crashing():
    rt = _port_runtime()
    fe = _frontend(rt)

    async def drive():
        await fe.start()
        bad_dev = await fe.submit(_req(port_serve, device=D + 3))
        bad_burst = await fe.submit(_req(port_serve, device=0, k=B + 2))
        bad_width = await fe.submit(port_serve.SampleRequest(
            device=0, x=np.zeros((1, F + 1), np.float32)))
        ok = await fe.submit(_req(port_serve, device=0, k=1))
        await fe.stop()
        return bad_dev, bad_burst, bad_width, ok

    bad_dev, bad_burst, bad_width, ok = asyncio.run(drive())
    assert bad_dev.status == "shed" and "out of range" in bad_dev.reason
    assert bad_burst.status == "shed" and bad_width.status == "shed"
    assert ok.ok
    assert rt.telemetry.summary()["ingress"]["shed"] == {"malformed": 3}


def test_frontend_warms_up_on_the_tick_worker_and_changes_nothing():
    """start() runs runtime.warmup on the worker's own thread (PyTorch's
    cuBLAS/cuSOLVER handles and current stream are per thread) and
    returns after it; the warm-up leaves the fleet as it was."""
    rt = _port_runtime()
    calls = []
    orig = rt.warmup

    def warmup(batch):
        calls.append((threading.current_thread().name, batch))
        orig(batch)

    rt.warmup = warmup
    beta, p = rt.states.beta.clone(), rt.states.p.clone()
    fe = _frontend(rt, warmup=True)

    async def drive():
        await fe.start()
        assert calls == [("serve-tick-worker", B)]  # done before start() returned
        ack = await fe.submit(_req(port_serve, device=1))
        await fe.stop()
        return ack

    ack = asyncio.run(drive())
    assert ack.ok and fe.warmup_thread == "serve-tick-worker"
    # the warm-up itself changed no state: an unserved device is untouched
    assert torch.equal(rt.states.beta[0], beta[0]) and torch.equal(rt.states.p[0], p[0])


def test_frontend_warmup_failure_raises_from_start():
    rt = _port_runtime()

    def broken(batch):
        raise RuntimeError("no kernels")

    rt.warmup = broken
    fe = _frontend(rt, warmup=True)

    async def drive():
        with pytest.raises(RuntimeError, match="no kernels"):
            await fe.start()
        assert fe._worker is None and not fe._running

    asyncio.run(drive())


def test_frontend_failed_tick_is_acked_failed_and_stops_admission():
    """A tick that raises is acked "failed" for every request aboard, sets
    ``failed``, and later submissions are shed: the failure never hides."""
    rt = _port_runtime()

    def pre_tick(window):
        if window.seq == 1:
            raise RuntimeError("launch failed")

    fe = _frontend(rt, pre_tick=pre_tick, close_at_requests=2, max_delay_s=5.0)

    async def drive():
        await fe.start()
        first = await asyncio.gather(*[fe.submit(_req(port_serve, device=d)) for d in (0, 1)])
        second = await asyncio.gather(*[fe.submit(_req(port_serve, device=d)) for d in (2, 3)])
        after = await fe.submit(_req(port_serve, device=4))
        await fe.stop()
        return first, second, after

    first, second, after = asyncio.run(drive())
    assert [a.status for a in first] == ["ok", "ok"]
    assert [a.status for a in second] == ["failed", "failed"]
    assert "launch failed" in second[0].reason
    assert fe.failed is not None and "tick 1 raised" in fe.failed
    assert after.status == "shed" and after.reason == fe.failed


def test_frontend_skip_merge_vetoes_governor():
    rt = _port_runtime(merge_every=2)
    fe = _frontend(rt, ladder=port_serve.LadderConfig(recover_after=10**9))
    fe.ladder.mode = port_serve.Mode.SKIP_MERGE  # pin the ladder: windows veto merges

    async def drive():
        await fe.start()
        for _ in range(8):
            await asyncio.gather(*[fe.submit(_req(port_serve, device=d, k=1, seed=d))
                                   for d in range(D)])
        await fe.stop()

    asyncio.run(drive())
    assert rt.governor.state.merges == 0
    assert rt.governor.state.deferred_degraded > 0
    assert rt.tick_no >= 4


def test_frontend_stress_acks_every_request_once():
    """The loop and the tick worker share the builder's queues, the
    futures and the in-flight counts: under 12 clients with a shortened
    switch interval (the threads swap often), every request is acked once,
    the counts balance and nothing is left in flight."""
    rt = _port_runtime(merge_every=3)
    fe = _frontend(rt, close_at_requests=5, max_delay_s=0.001, tick_deadline_s=600.0,
                   admission=port_serve.AdmissionConfig(max_queue_per_device=64,
                                                        client_cap=1000))
    rng = _rng(21)
    reqs = [[port_serve.SampleRequest(device=int(rng.integers(D)),
                                      x=rng.normal(size=(1, F)).astype(np.float32),
                                      client=f"c{c}") for _ in range(40)] for c in range(12)]

    async def client(batch):
        return [await fe.submit(r) for r in batch]

    async def drive():
        await fe.start()
        nested = await asyncio.wait_for(asyncio.gather(*[client(b) for b in reqs]), 120)
        await fe.stop()
        return [a for acks in nested for a in acks]

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        acks = asyncio.run(drive())
    finally:
        sys.setswitchinterval(before)
    assert fe._worker is None and fe.failed is None
    assert len(acks) == 480 and all(a.ok for a in acks)
    assert sorted(a.request_id for a in acks) == sorted(r.request_id for b in reqs for r in b)
    ing = rt.telemetry.summary()["ingress"]
    assert ing["accepted"] == ing["acked"] == 480
    assert not fe._futures and not fe._submit_t and not fe._client_inflight
    assert fe._inflight_windows == 0 and fe.builder.depth == 0
    assert rt.tick_no == fe._seq


def test_frontend_requires_telemetry():
    x_init = _rng(0).normal(size=(D, 2 * H, F)).astype(np.float32)
    fleet = init_fleet(torch.Generator().manual_seed(0), D, F, H, x_init,
                       activation="identity", ridge=RIDGE, device="cpu")
    bare = FleetRuntime(fleet, RuntimeConfig(topology=ring(D, hops=1)), device="cpu")
    with pytest.raises(ValueError, match="telemetry"):
        port_serve.ServeFrontend(bare, port_serve.ServeConfig(batch=B))


def _waves(pkg, n_waves, per_wave, d, f, seed):
    """Waves of ``per_wave`` one-sample requests on distinct devices: each
    wave fills exactly one window of ``close_at_requests = per_wave``."""
    rng = _rng(seed)
    out = []
    for _ in range(n_waves):
        devs = rng.permutation(d)[:per_wave]
        xs = rng.normal(size=(per_wave, 1, f)).astype(np.float32)
        out.append([pkg.SampleRequest(device=int(dv), x=x, client=f"c{dv}")
                    for dv, x in zip(devs, xs)])
    return out


async def _serve_waves(fe, waves):
    await fe.start()
    acks = []
    for wave in waves:
        acks.append(await asyncio.gather(*[fe.submit(r) for r in wave]))
    await fe.stop()
    return acks


def test_frontend_crash_recovery_restores_exact_state(tmp_path):
    """Snapshot + WAL replay rebuilds the pre-crash fleet bit for bit: six
    one-window waves, a snapshot at tick 4, two ticks in the log only."""
    rt = _port_runtime(tmp_path, snapshot_every=4)
    fe = _frontend(rt, wal_dir=str(tmp_path / "wal"), close_at_requests=6, max_delay_s=30.0)
    acks = asyncio.run(_serve_waves(fe, _waves(port_serve, 6, 6, D, F, 9)))
    assert all(a.ok for wave in acks for a in wave)
    assert rt.tick_no == 6
    beta_ref, p_ref = rt.states.beta.clone(), rt.states.p.clone()
    ewma_ref = rt.det.ewma.clone()

    rt2 = _port_runtime(tmp_path, snapshot_every=4)
    fe2 = _frontend(rt2, wal_dir=str(tmp_path / "wal"))
    restored, replayed = fe2.recover()
    assert (restored, replayed) == (4, 2)
    assert rt2.tick_no == 6 and fe2._seq == 6
    assert torch.equal(rt2.states.beta, beta_ref) and torch.equal(rt2.states.p, p_ref)
    assert torch.equal(rt2.det.ewma, ewma_ref)
    # counters rode the snapshot and advanced through the replay
    assert int(rt2.telemetry.ticks.value) == 6
    assert int(rt2.telemetry.ingress_replayed.value) == replayed
    assert int(rt2.telemetry.ingress_accepted.value) == 24  # the 4 waves in the snapshot


# ----------------------------------------------- the slice's differential

DD, NF, NH = 16, 16, 8     # the differential's fleet: D, n = m, Ñ
DB = 2                     # samples a device a window
D_MERGE_EVERY = 2
D_SNAPSHOT_EVERY = 4
D_TICKS = 15               # snapshots at 4, 8, 12; ticks 12-14 in the log only
SHORT = dict(warmup=3, warmup_skip=1, rel_sigma=0.05, k_sigma=1.0, patience=2)
LOSS_RTOL_PRE, LOSS_RTOL_POST = 1e-5, 2e-4


def _ref_fleet():
    x_init = _rng(11).normal(size=(DD, 2 * NH, NF)).astype(np.float32)
    return ref_init_fleet(jax.random.PRNGKey(0), DD, NF, NH, x_init,
                          activation="identity", ridge=RIDGE)


def _ref_runtime(snap_dir=None):
    return RefRuntime(_ref_fleet(), RefRuntimeConfig(
        topology=ref_ring(DD, hops=2), ridge=RIDGE,
        detector=dataclasses.replace(RefDetectorConfig(), **SHORT),
        governor=RefGovernorConfig(merge_every=D_MERGE_EVERY),
        snapshot_dir=snap_dir, snapshot_every=D_SNAPSHOT_EVERY if snap_dir else None,
        telemetry=RefTelemetryConfig(trace=False),
    ))


def _port_twin(snap_dir=None):
    f = _ref_fleet()
    fleet = oselm_state_from_numpy(f.params.alpha, f.params.bias, f.beta, f.p,
                                   activation=f.activation, forget=f.forget, device="cpu")
    return FleetRuntime(fleet, RuntimeConfig(
        topology=ring(DD, hops=2), ridge=RIDGE,
        detector=dataclasses.replace(DetectorConfig(), **SHORT),
        governor=GovernorConfig(merge_every=D_MERGE_EVERY),
        snapshot_dir=snap_dir, snapshot_every=D_SNAPSHOT_EVERY if snap_dir else None,
        telemetry=TelemetryConfig(trace=False),
    ), device="cpu")


def _record(runtime, sink):
    """Wrap runtime.tick to keep every report it returns."""
    orig = runtime.tick

    def tick(batch, **kw):
        rep = orig(batch, **kw)
        sink.append(rep)
        return rep

    runtime.tick = tick


def _assert_reports_match(got, want):
    """Flags, decisions and participants equal; losses at 1e-5 up to the
    first merge (its own tick included) and 2e-4 after."""
    assert [r.tick for r in got] == [r.tick for r in want]
    merged = False
    for g, w in zip(got, want, strict=True):
        assert np.array_equal(g.drifted, w.drifted), g.tick
        assert np.array_equal(g.fresh_detections, w.fresh_detections), g.tick
        assert (g.decision.merge, g.decision.reason, g.decision.participants,
                g.decision.round_bytes) == (w.decision.merge, w.decision.reason,
                                            w.decision.participants, w.decision.round_bytes)
        rtol = LOSS_RTOL_POST if merged else LOSS_RTOL_PRE
        np.testing.assert_allclose(g.losses, w.losses, rtol=rtol, atol=1e-6)
        merged |= bool(w.decision.merge)


@pytest.fixture(scope="module")
def ref_serving_dir(tmp_path_factory):
    """The reference's snapshot directory and WAL, written without asyncio:
    its WindowBuilder, WriteAheadLog and FleetRuntime.tick run in turn, as
    its front-end's batch loop and worker would (the log gc'd after each
    snapshot)."""
    root = tmp_path_factory.mktemp("ref_serving")
    rt = _ref_runtime(str(root / "snap"))
    x_init = _rng(11).normal(size=(DD, 2 * NH, NF)).astype(np.float32)
    wb = ref_serve.WindowBuilder(DD, DB, x_init[:, -1, :])
    wal = ref_serve.WriteAheadLog(root / "wal")
    rng = _rng(5)
    reports = []
    for seq in range(D_TICKS):
        for _ in range(int(rng.integers(6, 3 * DD))):
            wb.add(ref_serve.SampleRequest(
                device=int(rng.integers(DD)),
                x=rng.normal(size=(int(rng.integers(1, DB + 1)), NF)).astype(np.float32)))
        window = wb.close(seq, allow_merge=seq != 9)
        wal.append(window)
        reports.append(rt.tick(window.batch, served=window.served,
                               allow_merge=window.allow_merge))
        if rt.tick_no % D_SNAPSHOT_EVERY == 0:
            wal.gc(rt.tick_no)
    assert rt.tick_no == D_TICKS and wal.entries() == [12, 13, 14]
    assert sum(r.decision.merge for r in reports) > 0
    assert sum(int(r.fresh_detections.sum()) for r in reports) > 0
    assert any(not r.served.all() for r in reports)
    return root, reports, int(rt.telemetry.ticks.value), rt.governor.state.merges


def test_port_recovers_and_replays_the_references_snapshot_and_wal(ref_serving_dir, tmp_path):
    root, reports, tel_ticks, merges = ref_serving_dir
    # the reference's own replay, on a copy of the directory
    ref_copy = tmp_path / "ref"
    shutil.copytree(root, ref_copy)
    ref_rt = _ref_runtime(str(ref_copy / "snap"))
    ref_fe = ref_serve.ServeFrontend(ref_rt, ref_serve.ServeConfig(
        batch=DB, wal_dir=str(ref_copy / "wal"), warmup=False))
    ref_replay = []
    _record(ref_rt, ref_replay)
    assert ref_fe.recover() == (12, 3)

    port_copy = tmp_path / "port"
    shutil.copytree(root, port_copy)
    rt = _port_twin(str(port_copy / "snap"))
    fe = port_serve.ServeFrontend(rt, port_serve.ServeConfig(
        batch=DB, wal_dir=str(port_copy / "wal"), warmup=False))
    replay = []
    _record(rt, replay)
    assert fe.recover() == (12, 3)
    assert rt.tick_no == ref_rt.tick_no == D_TICKS and fe._seq == D_TICKS

    _assert_reports_match(replay, ref_replay)
    # the replayed ticks are the lost ones: the reference's originals too
    _assert_reports_match(replay, reports[12:])
    assert any(r.decision.merge for r in replay)
    # telemetry carries on from the reference's snapshot
    assert int(rt.telemetry.ticks.value) == tel_ticks == D_TICKS
    assert int(rt.telemetry.ingress_replayed.value) == 3
    assert rt.telemetry.summary()["merge_rounds"] == ref_rt.telemetry.summary()["merge_rounds"]
    assert rt.governor.state.merges == ref_rt.governor.state.merges == merges
    np.testing.assert_array_equal(fe._last_drifted, ref_fe._last_drifted)
    np.testing.assert_allclose(fe._last_scores, ref_fe._last_scores, rtol=LOSS_RTOL_POST,
                               atol=1e-6)


def test_both_frontends_serve_the_same_windows_alike():
    """The same waves through both front-ends, each wave one full window:
    acks' status, tick and drifted flags equal, scores within the runtime
    bounds."""
    n_waves, per_wave = 12, 11

    def config(pkg):
        return pkg.ServeConfig(batch=DB, close_at_requests=per_wave, max_delay_s=60.0,
                               tick_deadline_s=600.0, seed=0)

    ref_rt, rt = _ref_runtime(), _port_twin()
    ref_reports = []
    _record(ref_rt, ref_reports)
    ref_fe = ref_serve.ServeFrontend(ref_rt, config(ref_serve))
    fe = port_serve.ServeFrontend(rt, config(port_serve))
    ref_acks = asyncio.run(_serve_waves(ref_fe, _waves(ref_serve, n_waves, per_wave, DD, NF, 4)))
    acks = asyncio.run(_serve_waves(fe, _waves(port_serve, n_waves, per_wave, DD, NF, 4)))
    assert rt.tick_no == ref_rt.tick_no == n_waves
    assert fe.warmup_thread == "serve-tick-worker"
    merged = False
    drifted = 0
    for t, (got, want) in enumerate(zip(acks, ref_acks, strict=True)):
        for g, w in zip(got, want, strict=True):
            assert (g.status, g.tick, g.drifted) == (w.status, w.tick, w.drifted) == (
                "ok", t, w.drifted)
            rtol = LOSS_RTOL_POST if merged else LOSS_RTOL_PRE
            np.testing.assert_allclose(g.score, w.score, rtol=rtol, atol=1e-6)
            drifted += int(g.drifted)
        merged |= bool(ref_reports[t].decision.merge)
    assert ref_rt.governor.state.merges == rt.governor.state.merges > 0
    assert drifted > 0, "no drift flag reached an ack: the comparison lost its teeth"
    for key in ("accepted", "acked", "shed", "deferred"):
        assert (rt.telemetry.summary()["ingress"][key]
                == ref_rt.telemetry.summary()["ingress"][key]), key
