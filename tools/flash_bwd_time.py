"""Time ``flash_attention_bwd`` at ``chip_smoke.py`` phase 20 (a)'s shapes, on
one CUDA card, from the source tree given, each beside the backward of
``scaled_dot_product_attention`` on the same inputs. Run from the root of a
checkout:

    python3 tools/flash_bwd_time.py [--src PATH] [--label NAME] [--out FILE] [--wide]

``--src`` is the ``src`` directory of the tree to time (by default this
checkout's), so that two trees unpacked side by side are timed by one
script, in turns, in one process each; their kernels build into each
tree's own ``build/kernels``. The shapes, (B, Sq, Sk, H, hd, causal, dtype),
on random inputs from a seed: gemma3-1b's global layer at the training
run's shape (8, 128, 128, 4, 256) and at S 2048 (2, 2048, 2048, 4, 256),
granite-3-2b's (8, 512, 512, 32, 64), hd 128 (4, 512, 512, 32, 128), the
VLM's cross attention (4, 512, 1601, 32, 128, full), all bf16 and causal
unless said, one f32 case (2, 512, 512, 8, 256), one off the tiles
(3, 200, 333, 5, 96, full, bf16) and one on the CUDA cores in bf16 (2, 70,
70, 3, 100: hd not a multiple of 8), then past hd 256, on the wide pair:
(2, 512, 512, 4, 320, causal, bf16) and (2, 256, 333, 4, 512, full, f32).
``--wide`` times only those two.

Each line printed, and appended to ``--out``, is one JSON object: the
label, the card's name and power limit as ``nvidia-smi`` gives them, the
shape, ``events_ms`` (CUDA events around the call, per call), ``alone_ms``
(torch.profiler's device time of one call: the sum of every kernel it
launches) with ``by_kernel`` (which names the route), and SDPA's backward
alone and by events (its graph kept, the gradient taken again and again).
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
SHAPES = ((8, 128, 128, 4, 256, True, "bfloat16"), (2, 2048, 2048, 4, 256, True, "bfloat16"),
          (8, 512, 512, 32, 64, True, "bfloat16"), (4, 512, 512, 32, 128, True, "bfloat16"),
          (4, 512, 1601, 32, 128, False, "bfloat16"), (2, 512, 512, 8, 256, True, "float32"),
          (3, 200, 333, 5, 96, False, "bfloat16"), (2, 70, 70, 3, 100, True, "bfloat16"),
          (2, 512, 512, 4, 320, True, "bfloat16"), (2, 256, 333, 4, 512, False, "float32"))
WIDE = SHAPES[-2:]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the tree's src directory")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out", default=None, help="a file to append the JSON lines to")
    ap.add_argument("--reps", type=int, default=20, help="calls a timing")
    ap.add_argument("--wide", action="store_true", help="only the shapes past hd 256")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("flash_bwd_time: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import flash_attention_bwd, flash_attention_fwd

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for b, sq, sk, h, hd, causal, dname in WIDE if args.wide else SHAPES:
        dtype = getattr(torch, dname)
        q = torch.randn((b, sq, h, hd), generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn((b, sk, h, hd), generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        dout = torch.randn((b, sq, h, hd), generator=gen, device="cuda").to(dtype)
        out, m, l = flash_attention_fwd(q, k, v, causal=causal)

        def fn():
            return flash_attention_bwd(q, k, v, out, dout, m, l, causal=causal)

        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
        o_lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        do_lib = dout.transpose(1, 2)

        def library():
            return torch.autograd.grad(o_lib, (qt, kt, vt), do_lib, retain_graph=True)

        dev, _, by = profiled(fn, args.reps)
        line = json.dumps({
            "label": args.label, "card": smi,
            "what": f"flash_attention_bwd B={b} Sq={sq} Sk={sk} H={h} hd={hd}"
                    f" {'causal' if causal else 'full'} {dname}",
            "events_ms": events_ms(fn, args.reps), "alone_ms": dev, "by_kernel": by,
            "sdpa_bwd_events_ms": events_ms(library, args.reps),
            "sdpa_bwd_alone_ms": profiled(library, args.reps)[0],
        })
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del q, k, v, dout, out, m, l, qt, kt, vt, o_lib
    return 0


if __name__ == "__main__":
    sys.exit(main())
