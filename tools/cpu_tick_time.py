"""Wall time of the port's FleetRuntime tick on the CPU, where every kernel
runs as its plain PyTorch version: chip_smoke.py's card-against-CPU fleet
(D = 16 devices at the har width, Ñ = 128, n = 561, identity activation),
its data and its runtime settings (merges at ticks 3, 7, 11 and 15), f32
payloads. Run from the root of a checkout:

    python3 tools/cpu_tick_time.py [--threads 4] [--repeats 3]

For each topology it prints the median wall time of the ticks without a
merge and of the merge ticks, in ms, over ``--repeats`` runs of the 16
ticks (the first run is a warm-up and not counted).
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (puts the checkout's src on the path)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--threads", type=int, default=4, help="torch CPU threads")
    ap.add_argument("--repeats", type=int, default=3, help="timed runs of the ticks")
    args = ap.parse_args()

    import numpy as np
    import torch

    from repro_torch.fleet import init_fleet
    from repro_torch.runtime import FleetRuntime

    torch.set_num_threads(args.threads)
    rng = np.random.default_rng(cs.SEED)
    x_init, ticks_np, _ = cs.make_streams(rng, cs.D_CPU, 2 * cs.N_HID)
    fleet = init_fleet(torch.Generator().manual_seed(cs.SEED), cs.D_CPU, cs.N_FEAT, cs.N_HID,
                       x_init, activation="identity", ridge=cs.RIDGE, device="cpu")
    for name, topo in cs.topologies(cs.D_CPU).items():
        plain, merge = [], []
        for run in range(args.repeats + 1):
            rt = FleetRuntime(fleet, cs.runtime_config(topo), device="cpu")
            for t in range(cs.TICKS):
                t0 = time.perf_counter()
                report = rt.tick(np.ascontiguousarray(ticks_np[t]))
                ms = (time.perf_counter() - t0) * 1e3
                if run:
                    (merge if report.decision.merge else plain).append(ms)
        print(f"{name}: tick {statistics.median(plain):.2f} ms ({len(plain)} ticks),"
              f" merge tick {statistics.median(merge):.2f} ms ({len(merge)} ticks)"
              if merge else f"{name}: tick {statistics.median(plain):.2f} ms, no merge")
    return 0


if __name__ == "__main__":
    sys.exit(main())
