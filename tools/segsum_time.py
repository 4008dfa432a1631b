"""Time ``segment_sum_mix`` and ``masked_segment_sum_mix`` on one CUDA card,
from the source tree given, alone and by CUDA events. Run from the root of
a checkout:

    python3 tools/segsum_time.py [--src PATH] [--label NAME] [--out FILE]
                                 [--shapes D:R:C:CLUSTERS,...]

``--src`` is the ``src`` directory of the tree to time (by default this
checkout's), so that two trees unpacked side by side are timed by one
script, in turns, in one process each; their kernels build into each
tree's own ``build/kernels``. Timed, on random payloads and a mask with
zeros from a seed, at the shapes the merges give the segment sums:

- one cluster (the star) of D = 4096 and 1024 devices on the fleet
  benchmarks' (32, 80) payloads, and D = 4096 in 512 clusters;
- the har width (D = 256, (128, 689) payloads) as a star and in 32
  clusters;
- each side of the rule that picks the plan (``segsum_streamed``: more
  than 64 rows of the longest cluster for each wave of streamed blocks): a
  star of 64 and of 65 devices and 13 clusters of 512 and of 513 devices
  on (32, 80) payloads, and a star of 1024 devices on (128, 495) and
  (128, 496) payloads (15 and 16 waves).

``--shapes`` times the shapes given instead: D devices in CLUSTERS
clusters of equal runs (the last one shorter where they do not divide) on
(R, C) payloads. Where the tree has both plans, each shape is timed on each, forced, and
``picked`` says which one the wrapper takes there; a tree with one plan is
timed as it is (``plan`` "as built"). Each line printed, and appended to
``--out``, is one JSON object: the label, the card's name and power limit
as ``nvidia-smi`` gives them, what was timed, the plan, ``events_ms``
(CUDA events around the call, per call),
``alone_ms`` (torch.profiler's device time of one call: the sum of every
kernel it launches, whatever their names, so that two designs compare),
the kernel's name, ``bound_ms`` (the larger of the bytes at 3.35 TB/s and
the chain floor: the longest cluster's dependent adds at 4 cycles each and
1.98 GHz) and, once per shape, the same two times of the one PyTorch call
that computes the function (``w.sum(0)`` or ``torch.mv`` by the mask for
one cluster, ``index_add_`` or ``torch.mm`` by a 0/1 matrix for many).
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
ADD_CYCLES, CLOCK = 4, 1.98e9
# (devices, payload rows, payload columns, clusters)
SHAPES = [(4096, 32, 80, 1), (1024, 32, 80, 1), (4096, 32, 80, 512),
          (256, 128, 689, 1), (256, 128, 689, 32),
          (64, 32, 80, 1), (65, 32, 80, 1), (6656, 32, 80, 13), (6669, 32, 80, 13),
          (1024, 128, 495, 1), (1024, 128, 496, 1)]


def bound_ms(d: int, e: int, n_clusters: int, masked: bool) -> tuple[float, float, float]:
    """(bound, bytes term, chain term) in ms: the payloads (and the mask)
    read once, the sums and the offsets written and read once; each
    cluster's sum is d / n_clusters dependent adds."""
    nbytes = 4 * (d * e + n_clusters * e + n_clusters + 1 + (d if masked else 0))
    t_bytes = nbytes / BYTES_PER_S * 1e3
    t_chain = -(-d // n_clusters) * ADD_CYCLES / CLOCK * 1e3
    return max(t_bytes, t_chain), t_bytes, t_chain


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the tree's src directory")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out", default=None, help="a file to append the JSON lines to")
    ap.add_argument("--shapes", default=None,
                    help="D:R:C:CLUSTERS,... to time instead of the shapes above")
    args = ap.parse_args()
    shapes = SHAPES if args.shapes is None else [
        tuple(int(n) for n in shape.split(":")) for shape in args.shapes.split(",")]
    sys.path.insert(0, str(Path(args.src).resolve()))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("segsum_time: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from repro_torch.kernels import (
        masked_segment_sum_mix, masked_segment_sum_mix_plain, segment_sum_mix,
        segment_sum_mix_plain,
    )
    from repro_torch.kernels import topology_merge

    rule = getattr(topology_merge, "segsum_streamed", None)

    def force(plan):
        """The wrapper's rule, patched to pick ``plan`` (None: its own)."""
        if rule is not None:
            topology_merge.segsum_streamed = rule if plan is None else (
                lambda *_: plan == "streamed")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    def emit(what, **numbers):
        line = json.dumps({"label": args.label, "card": smi, "what": what, **numbers})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for d, r, c, n_cl in shapes:
        w = torch.randn((d, r, c), generator=gen, device="cuda")
        mask = (torch.rand(d, generator=gen, device="cuda") < 0.9).float()
        cids = np.minimum(np.arange(d) // -(-d // n_cl), n_cl - 1).astype(np.int32)
        e = r * c
        reps = 200 if d * e < 2e7 else 50
        wf = w.view(d, e)
        if n_cl == 1:
            libs = {"segment_sum_mix": ("w.sum(0)", lambda: w.sum(0, keepdim=True)),
                    "masked_segment_sum_mix": ("torch.mv by the mask",
                                               lambda: torch.mv(wf.t(), mask))}
        else:
            ids = torch.as_tensor(cids, dtype=torch.long, device="cuda")
            sel = torch.zeros((n_cl, d), device="cuda")
            sel[ids, torch.arange(d, device="cuda")] = mask
            libs = {"segment_sum_mix": ("index_add_", lambda: torch.zeros(
                        (n_cl, r, c), device="cuda").index_add_(0, ids, w)),
                    "masked_segment_sum_mix": ("torch.mm by a 0/1 matrix",
                                               lambda: torch.mm(sel, wf))}
        calls = {
            "segment_sum_mix": (lambda: segment_sum_mix(w, cids, n_cl),
                                lambda: segment_sum_mix_plain(w, cids, n_cl)),
            "masked_segment_sum_mix": (lambda: masked_segment_sum_mix(w, cids, mask, n_cl),
                                       lambda: masked_segment_sum_mix_plain(w, cids, mask, n_cl)),
        }
        longest = int(np.bincount(cids).max())
        picked = None if rule is None else (
            "streamed" if rule(n_cl, e, longest, torch.cuda.get_device_properties(0)
                               .multi_processor_count) else "element")
        for name, (fn, plain) in calls.items():
            b, t_bytes, t_chain = bound_ms(d, e, n_cl, name.startswith("masked"))
            lib_what, lib = libs[name]
            lib_alone, _, _ = profiled(lib, reps)
            lib_events = events_ms(lib, reps)
            want = plain()
            for plan in ("element", "streamed") if rule is not None else (None,):
                force(plan)
                differ = int((fn() != want).sum())
                alone, _, by = profiled(fn, reps)
                emit(f"{name} D={d} ({r}, {c}) C={n_cl}", plan=plan or "as built",
                     picked=picked, events_ms=events_ms(fn, reps), alone_ms=alone,
                     kernel=next(iter(by), None), differ=differ, bound_ms=b,
                     bytes_ms=t_bytes, chain_ms=t_chain, library=lib_what,
                     library_events_ms=lib_events, library_alone_ms=lib_alone)
            force(None)
        del w, wf
    return 0


if __name__ == "__main__":
    sys.exit(main())
