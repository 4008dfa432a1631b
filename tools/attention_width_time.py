"""Time ``flash_attention`` and ``gla_forward`` at the serving shapes and at
the head widths past the kernels' instances, on one CUDA card, from the
source tree given. Run from the root of a checkout:

    python3 tools/attention_width_time.py [--src PATH] [--label NAME] [--out FILE]

``--src`` is the ``src`` directory of the tree to time (by default this
checkout's), so that two trees unpacked side by side are timed by one
script, in turns, in one process each; their kernels build into each
tree's own ``build/kernels``. Timed, on random inputs from a seed:

- ``flash_attention`` at the hymba-1.5b serving shape (B = 4, S = 512,
  H = 25, hd = 64, causal, bf16), then at hd = 80, 96 and 320 in bf16
  and f32, beside ``scaled_dot_product_attention`` on the same inputs;
- ``gla_forward`` at the hymba-1.5b serving shape (B = 4, S = 512, H = 25,
  dk = 16, dv = 64, bf16), then at dk × dv = 128 × 128 and 512 × 513
  (B = 1, S = 2048, H = 4) in bf16 and f32.

A width the tree's wrapper refuses is recorded as refused. Each line
printed, and appended to ``--out``, is one JSON object: the label, the
card's name and power limit as ``nvidia-smi`` gives them, what was timed,
``events_ms`` (CUDA events around the call, per call) and ``alone_ms``
(torch.profiler's device time of one call: the sum of every kernel it
launches, whatever their names).
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the tree's src directory")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out", default=None, help="a file to append the JSON lines to")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("attention_width_time: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import flash_attention, gla_forward

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

    def timed(what, fn, reps, library=None):
        try:
            fn()
        except ValueError as e:  # a width this tree's wrapper does not take
            emit(what, refused=str(e))
            return
        dev, _, by = profiled(fn, reps)
        extra = {}
        if library is not None:
            extra = dict(sdpa_events_ms=events_ms(library, reps),
                         sdpa_alone_ms=profiled(library, reps)[0])
        emit(what, events_ms=events_ms(fn, reps), alone_ms=dev, by_kernel=by, **extra)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    b, s, h = 4, 512, 25
    both = (torch.bfloat16, torch.float32)
    for hd, dtypes in ((64, (torch.bfloat16,)), (80, both), (96, both), (320, both)):
        for dtype in dtypes:
            q, k, v = (torch.randn((b, s, h, hd), generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            timed(f"flash_attention B={b} S={s} H={h} hd={hd} causal {dtype}",
                  lambda: flash_attention(q, k, v, causal=True), 50,
                  lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
            del q, k, v, qt, kt, vt

    for (b, s, h, dk, dv), dtypes in (((4, 512, 25, 16, 64), (torch.bfloat16,)),
                                      ((1, 2048, 4, 128, 128), (torch.bfloat16, torch.float32)),
                                      ((1, 2048, 4, 512, 513), (torch.bfloat16, torch.float32))):
        for dtype in dtypes:
            q, k = (torch.randn((b, s, h, dk), generator=gen, device="cuda").to(dtype)
                    for _ in range(2))
            v = torch.randn((b, s, h, dv), generator=gen, device="cuda").to(dtype)
            la = -F.softplus(torch.randn((b, s, h), generator=gen, device="cuda"))
            timed(f"gla_forward B={b} S={s} H={h} dk={dk} dv={dv} {dtype}",
                  lambda: gla_forward(q, k, v, la), 20)
            del q, k, v, la
    return 0


if __name__ == "__main__":
    sys.exit(main())
