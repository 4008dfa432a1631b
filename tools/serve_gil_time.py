"""Time the async serving front-end under load on one CUDA card, against
the same ticks without it, from the source tree given. Run from the root
of a checkout:

    python3 tools/serve_gil_time.py [--src PATH] [--label NAME] [--out FILE]
                                    [--intervals 0.005,...] [--devices 256]
                                    [--features 561 --hidden 128] [--device cpu]

``--src`` is the ``src`` directory of the tree to time (by default this
checkout's), so that two trees unpacked side by side are timed by one
script, in turns, in one process each. The fleet is the har width
(n = m = 561, Ñ = 128, identity, ridge 1e-3) on a ring of hops 2, B = 2,
merges every 16 ticks, telemetry on, its basis from a CPU
``torch.Generator`` seeded 0, as in ``chip_smoke.py`` phase 16 (a). For
each interval (``sys.setswitchinterval``; Python's default is 0.005 s)
a fresh runtime behind a ``ServeFrontend`` serves 16 pipelined clients,
32 one-row requests in flight each, 8 waves (4 096 requests), and the
windows it cut are then ticked again on a fresh runtime with no
front-end (``alone``), one after another on one thread. The tick worker
and the asyncio loop share the GIL, and every PyTorch call gives it up
and takes it back, so a tick under load stretches by the loop's work.

Each line printed, and appended to ``--out``, is one JSON object: the
label, the card's name and power limit as ``nvidia-smi`` gives them, the
interval, requests a second, request p50/p99 (the sink's submit-to-ack
histogram), tick p50/p99 under the front-end (the sink's
``tick_seconds``) and alone (the host clock around each ``tick``), the
ticks and merges, and the first live tick's host time beside the median.
All are host-clock times. ``--device cpu`` (with narrow ``--features``
and ``--hidden``) is a rehearsal.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SEED = 0
RIDGE = 1e-3
BATCH, MERGE_EVERY = 2, 16
CLIENTS, OUTSTANDING, WAVES = 16, 32, 8


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the tree's src directory")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out", default=None, help="a file to append the JSON lines to")
    ap.add_argument("--intervals", default="0.005",
                    help="interpreter switch intervals to serve at, in seconds")
    ap.add_argument("--devices", type=int, default=256)
    ap.add_argument("--features", type=int, default=561, help="n = m (the har width)")
    ap.add_argument("--hidden", type=int, default=128, help="Ñ (the har width)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (a rehearsal)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))

    import numpy as np
    import torch

    from repro_torch.fleet import init_fleet, ring
    from repro_torch.obs import TelemetryConfig
    from repro_torch.runtime import FleetRuntime, GovernorConfig, RuntimeConfig
    from repro_torch.serve import AdmissionConfig, SampleRequest, ServeConfig, ServeFrontend

    device = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = card_line() if device.type == "cuda" else "cpu (host clock)"
    d, n, nh = args.devices, args.features, args.hidden
    x_init = np.random.default_rng(SEED).normal(size=(d, 2 * nh, n)).astype(np.float32)
    fleet = init_fleet(torch.Generator().manual_seed(SEED), d, n, nh, x_init,
                       activation="identity", ridge=RIDGE, device=device)

    def runtime() -> FleetRuntime:
        return FleetRuntime(fleet, RuntimeConfig(
            topology=ring(d, hops=2), ridge=RIDGE,
            governor=GovernorConfig(merge_every=MERGE_EVERY),
            telemetry=TelemetryConfig(trace=False)), device=device)

    def serve(interval: float) -> tuple[dict, list]:
        """One loaded run; its numbers and the windows it ticked, in order."""
        rt = runtime()
        windows, tick_s = [], []
        orig = rt.tick

        def tick(batch, **kw):
            t0 = time.perf_counter()
            rep = orig(batch, **kw)
            tick_s.append(time.perf_counter() - t0)
            windows.append((batch, kw["served"], kw["allow_merge"]))
            return rep

        rt.tick = tick
        fe = ServeFrontend(rt, ServeConfig(
            batch=BATCH, max_delay_s=0.004,
            admission=AdmissionConfig(max_queue_per_device=8, client_cap=128), seed=SEED))
        rng = np.random.default_rng(SEED + 1)
        rows = rng.normal(size=(CLIENTS * WAVES * OUTSTANDING, n)).astype(np.float32)

        async def drive():
            await fe.start()

            async def client(c):
                acks = []
                for w in range(WAVES):
                    acks += await asyncio.gather(*[fe.submit_with_retries(SampleRequest(
                        device=int(rng.integers(d)), x=rows[(c * WAVES + w) * OUTSTANDING + i],
                        client=f"client-{c}")) for i in range(OUTSTANDING)])
                return acks

            t0 = time.perf_counter()
            nested = await asyncio.gather(*[client(c) for c in range(CLIENTS)])
            wall = time.perf_counter() - t0
            await fe.stop()
            return [a for acks in nested for a in acks], wall

        before = sys.getswitchinterval()
        sys.setswitchinterval(interval)
        try:
            acks, wall = asyncio.run(drive())
        finally:
            sys.setswitchinterval(before)
        assert getattr(fe, "failed", None) is None and all(a.ok for a in acks), (
            {a.status for a in acks})
        lat = rt.telemetry.summary()["ingress"]["request_latency"]
        ts = rt.telemetry.tick_seconds
        return {
            "interval_s": interval,
            "requests": len(acks),
            "requests_per_s": len(acks) / wall,
            "request_p50_ms": lat["p50_s"] * 1e3,
            "request_p99_ms": lat["p99_s"] * 1e3,
            "tick_p50_ms": ts.quantile(0.5) * 1e3,
            "tick_p99_ms": ts.quantile(0.99) * 1e3,
            "ticks": rt.tick_no,
            "merges": rt.governor.state.merges,
            "first_tick_ms": tick_s[0] * 1e3,
            "median_tick_ms": float(np.median(tick_s)) * 1e3,
        }, windows

    def alone(windows) -> dict:
        """The same windows ticked one after another with no front-end."""
        rt = runtime()
        rt.warmup(BATCH)
        secs = []
        for batch, served, allow in windows:
            t0 = time.perf_counter()
            rt.tick(batch, served=served, allow_merge=allow)
            secs.append(time.perf_counter() - t0)
        return {"alone_tick_p50_ms": float(np.median(secs)) * 1e3,
                "alone_tick_p99_ms": float(np.quantile(secs, 0.99)) * 1e3}

    for interval in (float(x) for x in args.intervals.split(",")):
        row, windows = serve(interval)
        row.update(alone(windows))
        line = json.dumps({"label": args.label, "card": card, **row})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")


if __name__ == "__main__":
    main()
