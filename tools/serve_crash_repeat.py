"""Run the serving-ingress crash leg several times on one CUDA card (or,
with ``--device cpu``, on the host) at the har width (n = m = 561, Ñ = 128, as ``chip_smoke.py`` phase 16 (b) runs
it) and print, for each run, how the recovered front-end served its fresh
traffic. Run from the root of a checkout:

    python3 tools/serve_crash_repeat.py [--runs 4] [--deadline 1.0 60.0]
        [--device cuda|cpu] [--out FILE]

Each ``--deadline`` is the tick stall deadline (seconds) of the recovered
front-end (the child, a process of its own, keeps the module's); every
deadline runs ``--runs`` times, in turns. A run whose fresh requests were
not all acked ok is reported, not raised: its line holds the failed
claim's message (the statuses seen, the ladder's transitions, the longest
tick under the fresh traffic). A run that passed gives the number of
snapshotting ticks under the fresh traffic and the longest tick (host
clock). Each line is one JSON object with the card's name and power limit
as ``nvidia-smi`` gives them (on the host, ``cpu``); it is also appended to
``--out``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N_FEAT, N_HID = 561, 128   # the har width (configs/oselm_edge.py)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--deadline", type=float, nargs="+", default=[1.0, 60.0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from benchmarks import torch_serve_ingress as si

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    smi = "cpu" if device.type == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    for run in range(args.runs):
        for deadline in args.deadline:
            si.CRASH_TICK_DEADLINE_S = deadline  # read by _crash_frontend
            row = {"card": smi, "run": run, "deadline_s": deadline}
            with tempfile.TemporaryDirectory() as tmp:
                try:
                    c = si.run_crash(Path(tmp) / "crash", device=device,
                                     n_features=N_FEAT, n_hidden=N_HID)
                    row.update(ok=True, fresh_requests_ok=c["fresh_requests_ok"],
                               fresh_snapshots=c["fresh_snapshots"],
                               fresh_tick_max_s=c["fresh_tick_max_s"])
                except AssertionError as e:
                    row.update(ok=False, failed=str(e)[:400])
            line = json.dumps(row)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as fh:
                    fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
