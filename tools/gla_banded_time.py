"""Time ``gla_forward`` and ``banded_merge_solve``, and the two paths that
run them, on one CUDA card, from the source tree given. Run from the root
of a checkout:

    python3 tools/gla_banded_time.py [--src PATH] [--label NAME] [--out FILE]

``--src`` is the ``src`` directory of the tree to time (by default this
checkout's), so that two trees unpacked side by side are timed by one
script, in turns, in one process each; their kernels build into each
tree's own ``build/kernels``. Timed, on random inputs from a seed:

- ``gla_forward`` at the hymba-1.5b serving shapes (B = 4, H = 25, dk = 16,
  dv = 64, bf16; S = 512, 1000 and 2048);
- ``banded_merge_solve`` at the har width (D = 256, Ñ = 128, m = 561,
  hops = 2) on SPD payloads;
- one full-width hymba-1.5b prefill (32 layers, bf16, B = 4, S = 512);
- four ``fleet_train_rounds`` rounds on the open ring (hops = 2) at the
  har width, 32 samples a round.

Each line printed, and appended to ``--out``, is one JSON object: the
label, the card's name and power limit as ``nvidia-smi`` gives them, what
was timed, ``events_ms`` (CUDA events around the call, per call) and
``alone_ms`` (torch.profiler's device time of one call: the sum of every
kernel it launches, whatever their names, so that two designs compare),
and for the two paths ``wall_ms`` (host clock to a synchronize).
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEED = 0
D, N_FEAT, N_HID, HOPS, T, ROUNDS, RIDGE = 256, 561, 128, 2, 32, 4, 1e-3


def events_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def profiled(fn, reps: int) -> tuple[float, float, dict[str, float]]:
    """(device ms of one call, wall ms of one call, device ms by kernel) over
    ``reps`` calls. A kernel's mean launch time counts once for each launch
    a call makes, so a launch the profiler drops does not shorten it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    by = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.count > 0:
            by[e.key[:60]] = e.self_device_time_total / e.count * math.ceil(e.count / reps) / 1e3
    return sum(by.values()), wall, by


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the tree's src directory")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out", default=None, help="a file to append the JSON lines to")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))

    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("gla_banded_time: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.fleet import fleet_train_rounds, init_fleet, ring
    from repro_torch.kernels import banded_merge_solve, gla_forward
    from repro_torch.models import init_params, prefill

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    def emit(what, **numbers):
        line = json.dumps({"label": args.label, "card": smi, "what": what, **numbers})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    def kernel(what, fn, reps):
        ev = events_ms(fn, reps)
        alone, _, by = profiled(fn, reps)
        emit(what, events_ms=ev, alone_ms=alone, by_kernel=by)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for s in (512, 1000, 2048):
        q, k = (torch.randn((4, s, 25, 16), generator=gen, device="cuda").bfloat16()
                for _ in range(2))
        v = torch.randn((4, s, 25, 64), generator=gen, device="cuda").bfloat16()
        la = -F.softplus(torch.randn((4, s, 25), generator=gen, device="cuda"))
        kernel(f"gla_forward B=4 S={s} H=25 dk=16 dv=64 bf16",
               lambda: gla_forward(q, k, v, la), 50)
        del q, k, v, la

    a = torch.randn((D, N_HID, 3 * N_HID), generator=gen, device="cuda")
    u = a @ a.transpose(1, 2) / (3 * N_HID)
    w = torch.cat([u, torch.randn((D, N_HID, N_FEAT), generator=gen, device="cuda")], 2)
    w = w.contiguous()
    del a, u
    kernel(f"banded_merge_solve D={D} n={N_HID} m={N_FEAT} hops={HOPS}",
           lambda: banded_merge_solve(w, HOPS, ridge=RIDGE), 10)
    del w

    cfg = get_config("hymba-1.5b")
    params = init_params(torch.Generator(device="cuda").manual_seed(SEED), cfg, device="cuda")
    tokens = torch.as_tensor(np.random.default_rng(SEED).integers(0, cfg.vocab, (4, 512)),
                             device="cuda")
    dev, wall, by = profiled(lambda: prefill(params, cfg, tokens, cache_len=528), 3)
    top = dict(sorted(by.items(), key=lambda kv: -kv[1])[:6])
    emit("hymba-1.5b prefill B=4 S=512 bf16", alone_ms=dev, wall_ms=wall, by_kernel=top)
    del params, tokens

    rng = np.random.default_rng(SEED)
    x_init = rng.standard_normal((D, 2 * N_HID, N_FEAT)).astype(np.float32)
    fleet = init_fleet(torch.Generator().manual_seed(SEED), D, N_FEAT, N_HID, x_init,
                       activation="identity", ridge=RIDGE, device="cuda")
    streams = torch.from_numpy(
        rng.standard_normal((D, ROUNDS * T, N_FEAT)).astype(np.float32)).cuda()
    topo = ring(D, HOPS)
    dev, wall, by = profiled(
        lambda: fleet_train_rounds(fleet, streams, topo, rounds=ROUNDS, ridge=RIDGE), 2)
    top = dict(sorted(by.items(), key=lambda kv: -kv[1])[:6])
    emit(f"fleet_train_rounds ring hops={HOPS} D={D}, {ROUNDS} rounds", alone_ms=dev,
         wall_ms=wall, by_kernel=top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
