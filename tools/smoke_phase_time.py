"""Run one phase of a tree's ``chip_smoke.py`` alone on one CUDA card and
print how long it took. Run from the root of a checkout:

    python3 tools/smoke_phase_time.py --tree PATH --phase phase_wide
        [--label NAME] [--out FILE]

``--tree`` is the root of the tree whose ``chip_smoke.py`` and ``src`` run
(by default this checkout), so that two trees unpacked side by side are
timed by one script, in turns, one process each; ``--phase`` names a
function of that ``chip_smoke.py`` (``phase_wide`` is phase 10,
``phase_durability`` phase 12, ``phase_cohort`` phase 17, ``phase_mesh``
phase 18). A phase that takes arguments gets them as that script's
``main`` makes them, by name: ``fleet``, ``ticks_dev``, ``ticks_np`` and
``shifted`` from ``make_streams`` and ``init_fleet`` at ``D`` from
``SEED``, and ``smi``; their making is not timed. The kernels build into this
checkout's ``build/kernels`` (the library is keyed by a hash of the
sources, so trees with the same sources share one build). The line
printed, and appended to ``--out``, is one JSON object: the label, the
card's name and power limit as ``nvidia-smi`` gives them, the phase, the
build's seconds and the phase's seconds (host clock, the phase's own
checks included).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT), help="the root of the tree to run")
    ap.add_argument("--phase", required=True, help="a function of its chip_smoke.py")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out", default=None, help="a file to append the JSON line to")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(0, str(tree))

    import inspect

    import torch

    if not torch.cuda.is_available():
        print("smoke_phase_time: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import _lib

    assert Path(chip_smoke.__file__).resolve().parent == tree, chip_smoke.__file__
    _lib.BUILD_ROOT = ROOT / "build" / "kernels"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _lib.build()
    _lib.library()
    build_s = time.perf_counter() - t0
    phase = getattr(chip_smoke, args.phase)
    kwargs = {}
    wanted = inspect.signature(phase).parameters
    if {"fleet", "ticks_dev", "ticks_np", "shifted"} & wanted.keys():
        import numpy as np

        from repro_torch.fleet import init_fleet

        rng = np.random.default_rng(chip_smoke.SEED)
        x_init, ticks_np, shifted = chip_smoke.make_streams(rng, chip_smoke.D,
                                                            2 * chip_smoke.N_HID)
        fleet = init_fleet(torch.Generator().manual_seed(chip_smoke.SEED), chip_smoke.D,
                           chip_smoke.N_FEAT, chip_smoke.N_HID, x_init, activation="identity",
                           ridge=chip_smoke.RIDGE, device="cuda")
        made = {"fleet": fleet, "ticks_dev": torch.from_numpy(ticks_np).cuda(),
                "ticks_np": ticks_np, "shifted": shifted}
        kwargs.update({k: v for k, v in made.items() if k in wanted})
    if "smi" in wanted:
        kwargs["smi"] = smi
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    phase(**kwargs)
    line = json.dumps({"label": args.label, "card": smi, "phase": args.phase,
                       "build_s": build_s, "phase_s": time.perf_counter() - t0})
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
