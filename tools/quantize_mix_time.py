"""Time ``quantize_pack`` and ``banded_mix`` on one CUDA card, from the
source tree given, alone and by CUDA events. Run from the root of a
checkout:

    python3 tools/quantize_mix_time.py [--src PATH] [--label NAME] [--out FILE]

``--src`` is the ``src`` directory of the tree to time (by default this
checkout's), so that two trees unpacked side by side are timed by one
script, in turns, in one process each; their kernels build into each
tree's own ``build/kernels``. Timed, on random payloads from a seed, at
the har width (D = 256 devices, Ñ = 128, m = 561):

- ``quantize_pack`` with the error-feedback residual (every int8 round
  after the first) and without;
- ``banded_mix`` at hops = 2 (the stale ring's mix);
- and, where the tree takes them, both at the wide layer (Ñ = 256 and 320,
  D = 16), where a tree that refuses them says so.

Each line printed, and appended to ``--out``, is one JSON object: the
label, the card's name and power limit as ``nvidia-smi`` gives them, what
was timed, ``events_ms`` (CUDA events around the call, per call) and
``alone_ms`` (torch.profiler's device time of one call: the sum of every
kernel it launches, whatever their names, so that two designs compare).
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

SEED = 0
D, N_FEAT, N_HID, HOPS = 256, 561, 128, 2
D_WIDE = 16


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the tree's src directory")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out", default=None, help="a file to append the JSON lines to")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("quantize_mix_time: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import banded_mix, quantize_pack

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    def emit(what, **numbers):
        line = json.dumps({"label": args.label, "card": smi, "what": what, **numbers})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    def kernel(what, fn, reps):
        try:
            fn()
        except ValueError as e:  # a tree whose kernel does not take this shape
            emit(what, refused=str(e))
            return
        ev = events_ms(fn, reps)
        alone, _, by = profiled(fn, reps)
        emit(what, events_ms=ev, alone_ms=alone, by_kernel=by)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for d, nh in ((D, N_HID), (D_WIDE, 256), (D_WIDE, 320)):
        u = torch.randn((d, nh, nh), generator=gen, device="cuda")
        v = torch.randn((d, nh, N_FEAT), generator=gen, device="cuda") * 0.1
        r = torch.randn((d, nh, nh + N_FEAT), generator=gen, device="cuda") * 0.01
        reps = 50 if d == D else 200
        kernel(f"quantize_pack D={d} n={nh} m={N_FEAT} residual",
               lambda: quantize_pack(u, v, r), reps)
        kernel(f"quantize_pack D={d} n={nh} m={N_FEAT} no residual",
               lambda: quantize_pack(u, v), reps)
        w = torch.cat([u, v], dim=2).contiguous()
        del u, v, r
        kernel(f"banded_mix D={d} n={nh} m={N_FEAT} hops={HOPS}",
               lambda: banded_mix(w, HOPS), reps)
        del w
    return 0


if __name__ == "__main__":
    sys.exit(main())
