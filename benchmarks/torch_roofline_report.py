"""Roofline report of the port's dry run — renders the JSON records of
``python -m repro_torch.launch.dryrun`` (``artifacts/dryrun_torch/``) into
the roofline table, one row per arch × shape × mesh (the PyTorch
counterpart of ``benchmarks/roofline_report.py``).

    python benchmarks/torch_roofline_report.py [--artifacts DIR] [--device cpu]

The dry run traces each step on fake tensors and runs nothing on a device,
and its terms are the H100 data sheet's rates (``repro_torch.roofline.
HW_H100``), so the report reads the same with or without a card:
``--device`` is accepted as every port benchmark's is, and only names the
host in the last line. ``main`` returns the harness's CSV line (the
records and the least useful-FLOPs ratio); run as a script it prints the
table.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

ARTIFACTS = Path(__file__).resolve().parents[1] / "artifacts" / "dryrun_torch"


def load_records(artifacts: Path = ARTIFACTS) -> list[dict]:
    recs = []
    if not artifacts.exists():
        return recs
    for f in sorted(artifacts.glob("*.json")):
        try:
            recs.append(json.loads(f.read_text()))
        except (OSError, ValueError):
            pass
    return recs


def render_table(recs: list[dict]) -> str:
    hdr = (
        "| arch | shape | mesh | t_compute | t_memory | t_mem(fused attn) "
        "| t_collective | dominant | useful FLOPs | HBM/dev |\n"
        "|---|---|---|---|---|---|---|---|---|---|\n"
    )
    rows = []
    skips = []
    for r in recs:
        if r.get("status") == "skipped":
            skips.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} "
                         f"| — | — | — | — | SKIP: {r.get('reason', '')[:60]} | — | — |")
            continue
        if r.get("status") != "ok":
            continue
        mem = r.get("per_device_memory", {})
        hbm = (mem.get("temp_bytes", 0) + mem.get("argument_bytes", 0)) / 1e9
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['t_compute_s']*1e3:.1f} ms | {r['t_memory_s']*1e3:.1f} ms "
            f"| {r.get('t_memory_fused_attn_s', r['t_memory_s'])*1e3:.1f} ms "
            f"| {r['t_collective_s']*1e3:.1f} ms | {r['dominant']} "
            f"| {min(r['useful_flops_ratio'], 9.99):.2f} | {hbm:.1f} GB |"
        )
    return hdr + "\n".join(rows + skips)


def _records(argv: list[str] | None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--artifacts", default=str(ARTIFACTS), help="the dry run's records")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu: runs nothing")
    return load_records(Path(ap.parse_args(argv).artifacts))


def main(argv: list[str] | None = None) -> list[str]:
    recs = _records(argv)
    ok = [r for r in recs if r.get("status") == "ok"]
    if not ok:
        return ["roofline/report,0,no-artifacts-yet (run repro_torch.launch.dryrun)"]
    worst = min(ok, key=lambda r: r["useful_flops_ratio"])
    return [
        f"roofline/report,{len(ok):.1f},"
        f"records={len(ok)};worst_useful={worst['arch']}/{worst['shape']}"
        f"={worst['useful_flops_ratio']:.2f}"
    ]


if __name__ == "__main__":
    print(render_table(_records(None)))
