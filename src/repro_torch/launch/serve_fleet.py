"""Async fleet-ingress driver: concurrent clients → ServeFrontend →
resident FleetRuntime; port of ``repro.launch.serve_fleet``.

The runnable face of the serving-under-load stack: N synthetic clients
stream per-device sample bursts through the deadline batcher, the
admission controller applies backpressure, and the run exits with the
ingress summary — accepted / acked / shed / deferred, admission and
request latency percentiles — from the runtime's own telemetry sink.

    PYTHONPATH=src python -m repro_torch.launch.serve_fleet \\
        --devices 64 --batch 2 --requests 2000 --clients 8 [--device cpu]

    # durable mode: snapshots + write-ahead log, resumable after a kill
    PYTHONPATH=src python -m repro_torch.launch.serve_fleet \\
        --devices 64 --snapshot-dir /tmp/fleet-snap --wal-dir /tmp/fleet-wal

``python -m repro_torch.launch.serve --fleet ...`` hands over to this
driver. The fleet serves on the card unless ``--device cpu``; its shared
basis comes from a CPU ``torch.Generator`` seeded by ``--seed``, so the
card and the CPU start from the same fleet. Boot chunks and requests come
from numpy generators seeded by ``--seed`` and ``--seed + 1``.
"""
from __future__ import annotations

import argparse
import asyncio
import json

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.fleet import init_fleet, ring
from repro_torch.obs import TelemetryConfig
from repro_torch.runtime import FleetRuntime, GovernorConfig, RuntimeConfig
from repro_torch.serve import (
    AdmissionConfig,
    SampleRequest,
    ServeConfig,
    ServeFrontend,
)


def build_frontend(args) -> tuple[FleetRuntime, ServeFrontend]:
    device = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    d, f, h = args.devices, args.features, args.hidden
    x_init = rng.normal(size=(d, 2 * h, f)).astype(np.float32)
    fleet = init_fleet(
        torch.Generator().manual_seed(args.seed), d, f, h, x_init,
        activation="identity", ridge=1e-3, device=device,
    )
    runtime = FleetRuntime(fleet, RuntimeConfig(
        topology=ring(d, hops=2),
        governor=GovernorConfig(merge_every=args.merge_every),
        snapshot_every=args.snapshot_every if args.snapshot_dir else None,
        snapshot_dir=args.snapshot_dir,
        telemetry=TelemetryConfig(dir=args.telemetry_dir),
    ), device=device)
    frontend = ServeFrontend(runtime, ServeConfig(
        batch=args.batch,
        max_delay_s=args.max_delay_ms / 1e3,
        admission=AdmissionConfig(
            slo_p99_s=args.slo_ms / 1e3 if args.slo_ms else None,
        ),
        wal_dir=args.wal_dir,
        seed=args.seed,
    ), fallback=x_init[:, -1, :])
    return runtime, frontend


async def run_clients(frontend: ServeFrontend, args) -> list:
    rng = np.random.default_rng(args.seed + 1)
    per_client = -(-args.requests // args.clients)

    async def client(c: int) -> list:
        acks = []
        for _ in range(per_client):
            dev = int(rng.integers(args.devices))
            x = rng.normal(size=(1, args.features)).astype(np.float32)
            acks.append(await frontend.submit_with_retries(
                SampleRequest(device=dev, x=x, client=f"client-{c}")
            ))
        return acks

    nested = await asyncio.gather(*[client(c) for c in range(args.clients)])
    return [a for acks in nested for a in acks]


def main(argv: list[str] | None = None) -> dict:
    """Serve, print the JSON summary (acks by status, ticks, merges, the
    sink's ingress stats) and return it. A tick that raised fails the run
    (RuntimeError) after the acks are in."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=64)
    ap.add_argument("--features", type=int, default=16)
    ap.add_argument("--hidden", type=int, default=8)
    ap.add_argument("--batch", type=int, default=2,
                    help="per-device samples per tick window")
    ap.add_argument("--requests", type=int, default=2000)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--merge-every", type=int, default=16)
    ap.add_argument("--max-delay-ms", type=float, default=5.0)
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="tick p99 SLO driving admission backpressure")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--snapshot-dir", default=None)
    ap.add_argument("--snapshot-every", type=int, default=64)
    ap.add_argument("--wal-dir", default=None)
    ap.add_argument("--recover", action="store_true",
                    help="restore newest snapshot + replay WAL before serving")
    ap.add_argument("--telemetry-dir", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    for name in ("devices", "batch", "requests", "clients", "merge_every"):
        if getattr(args, name) < 1:
            ap.error(f"--{name.replace('_', '-')} must be >= 1 "
                     f"(got {getattr(args, name)})")
    if args.recover and not args.snapshot_dir:
        ap.error("--recover requires --snapshot-dir")

    runtime, frontend = build_frontend(args)
    if args.recover:
        restored, replayed = frontend.recover()
        print(f"recovered: tick {restored} + {replayed} replayed windows")

    async def serve() -> list:
        await frontend.start()
        try:
            return await run_clients(frontend, args)
        finally:
            await frontend.stop()

    acks = asyncio.run(serve())
    if frontend.failed is not None:
        raise RuntimeError(f"the fleet stopped serving: {frontend.failed}")
    by_status: dict[str, int] = {}
    for a in acks:
        by_status[a.status] = by_status.get(a.status, 0) + 1
    summary = runtime.finalize_telemetry()
    out = {
        "acks": by_status,
        "ticks": runtime.tick_no,
        "merges": runtime.governor.state.merges,
        "ingress": summary["ingress"],
    }
    print(json.dumps(out, indent=2, default=str))
    return out


if __name__ == "__main__":
    main()
