"""Dry run of the paper's own program: the federated OS-ELM detector step
(each rank's batch update, then the one-shot (U, V) all-reduce of the
cooperative merge) on the production meshes; port of
``repro.launch.dryrun_detector``.

This is the mesh-scale version of the paper's Table-4 merge cost: the
payload each device sends is U (Ñ×Ñ) + V (Ñ×m) floats however much data its
shard trained on, where the gradient all-reduce of any of the ten LM
architectures moves every parameter every step
(``python -m repro_torch.launch.dryrun``).

One rank's ``make_detector_step`` runs on fake tensors (its block of a
stacked fleet of states and features, as ``launch/dryrun.py`` runs a model)
against the dry run's ``ShapeMesh``, under the op counter; the collective
bytes it records per device are the U/V payload, 4·(Ñ² + Ñ·d_model).

    PYTHONPATH=src python -m repro_torch.launch.dryrun_detector [--multi-pod | --both]
"""
from __future__ import annotations

import argparse
import gzip
import json
from pathlib import Path

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.core import init_oselm, init_slfn
from repro_torch.launch.dryrun import ARTIFACTS, ShapeMesh
from repro_torch.launch.mesh import data_axes
from repro_torch.launch.steps import make_detector_step
from repro_torch.roofline import OpCounter, roofline_from_trace, tensor_bytes

__all__ = ["main", "run"]


def run(multi_pod: bool, *, d_model: int = 4096, n_hidden: int = 128, k: int = 256,
        out_dir: Path = ARTIFACTS) -> dict:
    mesh = ShapeMesh.production(multi_pod)
    dp = data_axes(mesh)
    n_shards = mesh.size(dp)
    ridge = 1e-2

    with FakeTensorMode():
        params = init_slfn(torch.Generator().manual_seed(0), d_model, n_hidden, device="cpu")
        warm = torch.randn((2 * n_hidden, d_model), generator=torch.Generator().manual_seed(1))
        st = init_oselm(params, warm, warm, activation="identity", ridge=ridge)
        # the stacked fleet (one state a data shard) and its features; this
        # rank steps its own block
        beta = st.beta.expand(n_shards, *st.beta.shape)
        p = st.p.expand(n_shards, *st.p.shape)
        feats = torch.zeros((n_shards, k, d_model), dtype=torch.float32)
        mine = st.replace(beta=beta[0], p=p[0])
        counter = mesh.counter = OpCounter()
        step = make_detector_step(mesh, dp, merge=True, ridge=ridge)
        with counter:
            out = step(mine, feats[0])
        mesh.counter = None
        args = tensor_bytes([*mine.params, mine.beta, mine.p, feats[0]])
        outs = tensor_bytes([out.beta, out.p])
    costs = counter.costs
    memory = {"argument_bytes": float(args), "output_bytes": float(outs),
              "temp_bytes": float(costs.peak_live_bytes),
              "peak_bytes": float(args + costs.peak_live_bytes)}
    print(f"detector × {mesh.name}: traced in {costs.seconds:.2f}s")
    # per-merge exchanged payload (the paper's communication cost):
    payload = 4 * (n_hidden * n_hidden + n_hidden * d_model)
    report = roofline_from_trace(
        costs, arch="oselm-detector", shape=f"batch{k}_d{d_model}", mesh_name=mesh.name,
        chips=mesh.chips,
        # detector model FLOPs: hidden proj + batch-k RLS update + merge solve
        model_flops=float(n_shards) * (
            2 * k * d_model * n_hidden            # H = xα
            + 2 * k * n_hidden * n_hidden * 2     # PHᵀ, gain
            + 2 * n_hidden ** 3 / 3 * 2           # U⁻¹ via Cholesky + solve
        ),
        per_device_memory=memory,
    )
    rec = {"status": "ok", **report.to_dict(), "uv_payload_bytes": payload,
           "coll_bytes_per_device": costs.collective_bytes, "compile_s": costs.seconds}
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = f"oselm-detector--batch{k}_d{d_model}--{mesh.name}"
    with gzip.open(out_dir / f"{stem}.ops.json.gz", "wt") as f:
        json.dump(costs.to_json(), f)
    (out_dir / f"{stem}.json").write_text(json.dumps(rec, indent=1))
    print(
        f"  FLOPs={report.hlo_flops:.3e} bytes={report.hlo_bytes:.3e} "
        f"coll={report.coll_bytes:.3e} ({payload} B U/V payload per device) "
        f"dominant={report.dominant}"
    )
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both", action="store_true")
    args = ap.parse_args()
    for mp in ([False, True] if args.both else [args.multi_pod]):
        run(mp)


if __name__ == "__main__":
    main()
