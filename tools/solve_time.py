"""Time the two Gauss-Jordan solves, ``from_uv_solve`` and
``banded_merge_solve``, on one CUDA card, from the source tree given, and
hold each against an f64 solve of the same systems beside
``torch.linalg.solve``. Run from the root of a checkout:

    python3 tools/solve_time.py [--src PATH] [--label NAME] [--out FILE]

``--src`` is the ``src`` directory of the tree to time (by default this
checkout's), so that two trees unpacked side by side are timed by one
script, in turns, one process each; their kernels build into this
checkout's ``build/kernels``, keyed by a hash of each tree's sources.
Timed, on SPD systems from a seed scaled to pivots of
~1e4 (a star sum of some thousands of har devices):

- ``from_uv_solve`` at the har width (Ñ = 128, m = 561) at S = 1, 32 and
  256 (the star, the clusters of an isolated hierarchy, a stale round's
  per-device solves), as slices of a packed [U | V];
- ``from_uv_solve`` at Ñ = 768, m = 784 (the blocked wide solve), S = 1;
- ``banded_merge_solve`` at D = 256, Ñ = 128, m = 561, hops = 2.

Each line printed, and appended to ``--out``, is one JSON object: the
label, the card's name and power limit as ``nvidia-smi`` gives them, what
was timed, ``events_ms`` (CUDA events around the call, per call),
``alone_ms`` (torch.profiler's device time of one call, every kernel it
launches), and ``beta_f64`` and ``linalg_f64``: max |Δβ| / max |β| of the
call's β and of ``torch.linalg.solve``'s against an f64 solve.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks.torch_device_time import events_ms, profiled  # noqa: E402

SEED, RIDGE, SCALE = 0, 1e-3, 1e4


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the tree's src directory")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out", default=None, help="a file to append the JSON lines to")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("solve_time: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _lib, banded_merge_solve, from_uv_solve

    _lib.BUILD_ROOT = ROOT / "build" / "kernels"  # keyed by the sources' hash
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def packed(s, n, m):
        a = torch.randn((s, n, 3 * n), generator=gen, device="cuda")
        u = a @ a.transpose(1, 2) / (3 * n) * SCALE
        v = torch.randn((s, n, m), generator=gen, device="cuda") * SCALE
        return torch.cat([u, v], 2).contiguous()

    def f64_errs(beta, sums, n):
        a = sums[:, :, :n] + RIDGE * torch.eye(n, device="cuda")
        b64 = torch.linalg.solve(a.double(), sums[:, :, n:].double())
        lib = torch.linalg.solve(a, sums[:, :, n:])
        scale = float(b64.abs().max())
        return (float((beta.double() - b64).abs().max()) / scale,
                float((lib.double() - b64).abs().max()) / scale)

    def emit(what, fn, reps, beta, sums, n):
        ev = events_ms(fn, reps)
        alone, _, by = profiled(fn, reps)
        err, lib = f64_errs(beta, sums, n)
        line = json.dumps({"label": args.label, "card": smi, "what": what, "events_ms": ev,
                           "alone_ms": alone, "by_kernel": by, "beta_f64": err,
                           "linalg_f64": lib})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    for s, n, m in ((1, 128, 561), (32, 128, 561), (256, 128, 561), (1, 768, 784)):
        w = packed(s, n, m)
        u, v = w[:, :, :n], w[:, :, n:]
        _, beta = from_uv_solve(u, v, ridge=RIDGE)
        emit(f"from_uv_solve S={s} n={n} m={m}",
             lambda: from_uv_solve(u, v, ridge=RIDGE), 50 if s < 256 else 10, beta, w, n)
        del w, u, v, beta
    d, n, m, hops = 256, 128, 561, 2
    w = packed(d, n, m)
    _, beta = banded_merge_solve(w, hops, ridge=RIDGE)
    band = sum(torch.roll(w, -o, dims=0) for o in range(-hops, hops + 1))
    emit(f"banded_merge_solve D={d} n={n} m={m} hops={hops}",
         lambda: banded_merge_solve(w, hops, ridge=RIDGE), 10, beta, band, n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
