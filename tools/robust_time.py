"""Time ``robust_segment_sum_mix`` on one CUDA card, from the source tree
given, alone and by CUDA events. Run from the root of a checkout:

    python3 tools/robust_time.py [--src PATH] [--label NAME] [--out FILE]
                                 [--shapes D:R:C:CLUSTERS:TRIM,...]

``--src`` is the ``src`` directory of the tree to time (by default this
checkout's), so that two trees unpacked side by side are timed by one
script, in turns, in one process each; their kernels build into each
tree's own ``build/kernels``. Timed, on random payloads, a mask with zeros
and clip scales in [0.5, 1) from a seed, at the shapes the merges give the
robust sum:

- one cluster (the star) of D = 4096 devices on the fleet benchmarks'
  (32, 80) payloads at trims 0, 1, 2, 4, 5, 8 and 9, and of D = 1024 at
  trim 1; D = 4096 in 512 clusters at trims 1 and 5;
- the har width (D = 256, (128, 689) payloads) as a star at trims 1, 5
  and 8, and in 32 clusters at trim 1.

``--shapes`` times the shapes given instead: D devices in CLUSTERS
clusters of equal runs (the last one shorter where they do not divide) on
(R, C) payloads at TRIM. Where the tree has both plans (``robust_streamed``
in ``kernels/robust_merge.py``), each shape is timed on each, forced, and
``picked`` says which one the wrapper takes there (past trim 8, which the
streamed plan does not take, the per-element plan alone); a tree with one
plan is timed as it is (``plan`` "as built"). Each line printed, and appended to
``--out``, is one JSON object: the label, the card's name and power limit
as ``nvidia-smi`` gives them, what was timed, the plan, ``events_ms``
(CUDA events around the call, per call), ``alone_ms`` (torch.profiler's
device time of one call: the sum of every kernel it launches, whatever
their names, so that two designs compare), the kernel's name, ``differ``
(elements of tot, lo and hi whose bits differ from the plain version's;
NaN is not among the inputs), and ``bound_ms``: the largest of the bytes
at 3.35 TB/s (the payloads, mask and scale read once, the three sums
written once), the chain floor (the longest cluster's dependent adds at 4
cycles each and 1.98 GHz) and the operations (5 + 4·trim a device and
element: the clip product, the masked product and add, the two sentinel
selects and the chains' 4·trim min and max, at 67 TFLOP/s). No PyTorch
call computes the function.
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
BYTES_PER_S = 3.35e12     # H100 SXM HBM3
F32_OPS_PER_S = 67e12     # H100 SXM f32, outside the tensor cores
ADD_CYCLES, CLOCK = 4, 1.98e9
# (devices, payload rows, payload columns, clusters, trim)
SHAPES = ([(4096, 32, 80, 1, t) for t in (0, 1, 2, 4, 5, 8, 9)]
          + [(1024, 32, 80, 1, 1), (4096, 32, 80, 512, 1), (4096, 32, 80, 512, 5)]
          + [(256, 128, 689, 1, t) for t in (1, 5, 8)] + [(256, 128, 689, 32, 1)])


def bound_ms(d: int, e: int, n_clusters: int, longest: int,
             trim: int) -> tuple[float, float, float, float]:
    """(bound, bytes term, chain term, operations term) in ms."""
    nbytes = 4 * (d * e + 2 * d + n_clusters + 1 + 3 * n_clusters * e)
    t_bytes = nbytes / BYTES_PER_S * 1e3
    t_chain = longest * ADD_CYCLES / CLOCK * 1e3
    t_ops = (5 + 4 * trim) * d * e / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_chain, t_ops), t_bytes, t_chain, t_ops


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the tree's src directory")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out", default=None, help="a file to append the JSON lines to")
    ap.add_argument("--shapes", default=None,
                    help="D:R:C:CLUSTERS:TRIM,... to time instead of the shapes above")
    args = ap.parse_args()
    shapes = SHAPES if args.shapes is None else [
        tuple(int(n) for n in shape.split(":")) for shape in args.shapes.split(",")]
    sys.path.insert(0, str(Path(args.src).resolve()))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("robust_time: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import robust_merge, robust_segment_sum_mix
    from repro_torch.kernels import robust_segment_sum_mix_plain

    rule = getattr(robust_merge, "robust_streamed", None)

    def force(plan):
        """The wrapper's rule, patched to pick ``plan`` (None: its own)."""
        if rule is not None:
            robust_merge.robust_streamed = rule if plan is None else (
                lambda *_: plan == "streamed")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    def emit(what, **numbers):
        line = json.dumps({"label": args.label, "card": smi, "what": what, **numbers})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for d, r, c, n_cl, trim in shapes:
        x = torch.randn((d, r, c), generator=gen, device="cuda")
        mask = (torch.rand(d, generator=gen, device="cuda") < 0.9).float()
        scale = 0.5 + 0.5 * torch.rand(d, generator=gen, device="cuda")
        cids = np.minimum(np.arange(d) // -(-d // n_cl), n_cl - 1).astype(np.int32)
        e = r * c
        longest = int(np.bincount(cids).max())
        args_ = (x, cids, mask, scale, n_cl, trim)
        want = robust_segment_sum_mix_plain(*args_)
        reps = 100 if d * e < 2e7 else 30
        picked = None if rule is None else (
            "streamed" if rule(n_cl, e, longest, trim, sms) else "element")
        b, t_bytes, t_chain, t_ops = bound_ms(d, e, n_cl, longest, trim)
        plans = (None,) if rule is None else (
            ("element", "streamed") if trim <= robust_merge.ROBUST_REG_TRIM else ("element",))
        for plan in plans:
            force(plan)
            fn = lambda: robust_segment_sum_mix(*args_)  # noqa: E731
            differ = sum(int((g != w).sum()) for g, w in zip(fn(), want))
            alone, _, by = profiled(fn, reps)
            emit(f"robust_segment_sum_mix D={d} ({r}, {c}) C={n_cl} trim={trim}",
                 plan=plan or "as built", picked=picked, events_ms=events_ms(fn, reps),
                 alone_ms=alone, kernel=max(by, key=by.get, default=None), differ=differ,
                 bound_ms=b, bytes_ms=t_bytes, chain_ms=t_chain, ops_ms=t_ops)
        force(None)
        del x, want
    return 0


if __name__ == "__main__":
    sys.exit(main())
