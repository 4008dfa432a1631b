"""Time ``gla_backward`` at ``chip_smoke.py`` phase 20 (a)'s shapes, on one
CUDA card, from the source tree given. Run from the root of a checkout:

    python3 tools/gla_bwd_time.py [--src PATH] [--label NAME] [--out FILE]

``--src`` is the ``src`` directory of the tree to time (by default this
checkout's), so that two trees unpacked side by side are timed by one
script, in turns, in one process each; their kernels build into each
tree's own ``build/kernels``. The shapes, (B, S, H, dk, dv, dtype), on
random inputs from a seed (decays −softplus(N(0, 1))/4, a final-state
cotangent): hymba-1.5b's Mamba heads at its training shape (4, 512, 25, 16,
64) in bf16 and in f32, xLSTM's mLSTM at its training shape (2, 256, 4,
512, 513, bf16), and S off the chunk (3, 200, 5, 16, 64, bf16).

Each line printed, and appended to ``--out``, is one JSON object: the
label, the card's name and power limit as ``nvidia-smi`` gives them, the
shape, ``events_ms`` (CUDA events around the call, per call), ``alone_ms``
(torch.profiler's device time of one call: the sum of every kernel it
launches) with ``by_kernel``, the forward's ``gla_forward`` beside it by
the same two clocks, and the plain version's events.

``--plans 16x64p,32x64s,...`` (a tree with ``kernels.gla_scan.bwd_plan``)
times each bf16 shape again on each plan forced: dq/dk strips of 16 or 32
columns, dv strips of 32 or 64, ``p`` paired (one block a strip of each)
or ``s`` split; each such line has the plan, both clocks, ``by_kernel`` and
the largest of dq's, dk's, dv's and dlog a's distance from the plain
version over its largest magnitude.
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
SHAPES = ((4, 512, 25, 16, 64, "bfloat16"), (4, 512, 25, 16, 64, "float32"),
          (2, 256, 4, 512, 513, "bfloat16"), (3, 200, 5, 16, 64, "bfloat16"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the tree's src directory")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out", default=None, help="a file to append the JSON lines to")
    ap.add_argument("--reps", type=int, default=20, help="calls a timing")
    ap.add_argument("--plans", default="", help="bf16 plans to force, e.g. 16x64p,32x64s")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("gla_bwd_time: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import gla_backward, gla_backward_plain, gla_forward
    from repro_torch.kernels import gla_scan
    from repro_torch.kernels.gla_scan import _forward

    rule = getattr(gla_scan, "bwd_plan", None)
    plans = [(int(p[:p.index("x")]), int(p[p.index("x") + 1:-1]), p[-1] == "p")
             for p in args.plans.split(",") if p]

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for b, s, h, dk, dv, dname in SHAPES:
        dtype = getattr(torch, dname)
        q, k = (torch.randn((b, s, h, dk), generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        v, dy = (torch.randn((b, s, h, dv), generator=gen, device="cuda").to(dtype)
                 for _ in range(2))
        log_a = -F.softplus(torch.randn((b, s, h), generator=gen, device="cuda")) / 4
        ds = torch.randn((b, h, dk, dv), generator=gen, device="cuda")
        _, state, states, decay = _forward(q, k, v, log_a, keep=True)

        def fn():
            return gla_backward(q, k, v, log_a, dy, ds, states, decay, state)

        def plain():
            return gla_backward_plain(q, k, v, log_a, dy, ds, states, decay, state)

        def forward():
            return gla_forward(q, k, v, log_a)

        dev, _, by = profiled(fn, args.reps)
        line = json.dumps({
            "label": args.label, "card": smi,
            "what": f"gla_backward B={b} S={s} H={h} dk={dk} dv={dv} {dname}",
            "events_ms": events_ms(fn, args.reps), "alone_ms": dev, "by_kernel": by,
            "forward_events_ms": events_ms(forward, args.reps),
            "forward_alone_ms": profiled(forward, args.reps)[0],
            "plain_events_ms": events_ms(plain, 2),
        })
        lines = [line]
        if dtype == torch.bfloat16 and rule is not None:
            want = plain()
            for plan in plans:
                gla_scan.bwd_plan = lambda *_, plan=plan: plan
                got = fn()
                rel = max(float((g.float() - w.float()).abs().max() / w.float().abs().max())
                          for g, w in zip(got, want))
                dev, _, by = profiled(fn, args.reps)
                lines.append(json.dumps({
                    "label": args.label, "card": smi,
                    "what": f"gla_backward B={b} S={s} H={h} dk={dk} dv={dv} {dname}",
                    "plan": "%dx%d%s" % (plan[0], plan[1], "p" if plan[2] else "s"),
                    "events_ms": events_ms(fn, args.reps), "alone_ms": dev, "by_kernel": by,
                    "max_rel_vs_plain": rel}))
            gla_scan.bwd_plan = rule
        for line in lines:
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
        del q, k, v, dy, log_a, ds, state, states, decay
    return 0


if __name__ == "__main__":
    sys.exit(main())
