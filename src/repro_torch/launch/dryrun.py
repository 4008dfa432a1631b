"""Dry run of every (architecture × input shape) on the production meshes;
port of ``repro.launch.dryrun``.

The reference lowers and compiles each combination on 256 or 512 fake XLA
devices and reads its costs off the optimized HLO. The port runs eagerly
and has no HLO, so it runs the step instead, once, as one rank of the mesh
would, on stand-ins that allocate nothing:

- Parameters, optimizer state and inputs are fake tensors
  (``FakeTensorMode``): ``init_params`` draws from a CPU generator under
  the mode, so even llama3-405b's 0.8 TB of weights are shapes only. The
  step takes the kernels' plain routes, as on the CPU.
- The mesh is ``ShapeMesh``, a stand-in private to the dry run with the
  production layouts' axes, (16, 16) or (2, 16, 16). Its ``all_reduce``
  returns a tensor of the result's shape and reports its bytes to the op
  counter. ``make_production_mesh`` needs a world of 256 or 512 ranks and
  is not used.
- The port shards over the data axes only (each rank holds the whole
  model, ``launch/steps.py``), so one rank runs the step at the per-device
  batch (the global batch over the data shards, or the whole batch where
  it does not divide, as long_500k's batch of 1). Prefill and decode then
  send nothing, and a train step sends its gradient all-reduce. That term
  differs from the reference's GSPMD collectives by design: the reference
  also shards the weights over "model" and gathers them.
- ``roofline.op_costs.OpCounter`` counts the step's FLOPs, bytes, interior
  bytes and collective bytes per device; ``roofline_from_trace`` scales
  them by the chips, the reference's convention (global figures). The
  model axis runs replicas of the data shards' work, so on these meshes
  the port's counted FLOPs are the model's times the model axis's 16, and
  ``useful_flops_ratio`` says so.
- Per-device memory: the arguments by the port's ``launch/sharding.py``
  rules (``param_specs``, ``opt_state_specs``, ``batch_specs``,
  ``cache_specs_sharding``: each leaf's bytes over the sizes of the mesh
  axes in its spec), the outputs likewise, and the peak of live op results
  during the step at the per-device batch (``temp_bytes``).
- The model code has no data-dependent op (``.item()``, ``nonzero``) on
  these paths; one would raise under the fake mode and fail its combo.

Each combination writes ``artifacts/dryrun_torch/<arch>--<shape>--<mesh>.json``
with the reference's keys (``compile_s`` holds the seconds of the traced
step, where the reference compiles; ``cost_analysis`` the counter's own
per-device totals) and the per-op record beside it, gzipped
(``.ops.json.gz``), from which ``--reanalyze`` derives the report again.

Usage (no card needed):
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--skip-existing]
"""
from __future__ import annotations

import argparse
import gzip
import json
import math
import time
import traceback
from pathlib import Path

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.granite_3_2b import SWA_VARIANT as GRANITE_SWA
from repro_torch.launch.mesh import PRODUCTION, data_axes
from repro_torch.launch.sharding import (
    batch_specs,
    cache_specs_sharding,
    opt_state_specs,
    param_specs,
)
from repro_torch.launch.steps import (
    make_decode_step,
    make_optimizer,
    make_prefill_step,
    make_train_step,
)
from repro_torch.models import active_param_count, init_params, input_specs, param_count
from repro_torch.models.config import INPUT_SHAPES, ArchConfig, ShapeConfig
from repro_torch.roofline import OpCosts, OpCounter, RooflineReport, roofline_from_trace, tensor_bytes

__all__ = ["ARTIFACTS", "ShapeMesh", "combo_supported", "main", "model_flops", "reanalyze",
           "run_combo", "sharded_bytes", "trace_combo"]

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"


class ShapeMesh:
    """A production mesh's layout with no ranks behind it: the dry run's
    stand-in for ``launch.mesh.Mesh``. Its collectives return a new tensor
    of the result's shape and report their bytes to ``counter``."""

    def __init__(self, shape, axis_names, counter: OpCounter | None = None) -> None:
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.counter = counter

    @classmethod
    def production(cls, multi_pod: bool, counter: OpCounter | None = None) -> ShapeMesh:
        shape, axes = PRODUCTION[multi_pod]
        return cls(shape, axes, counter)

    @property
    def name(self) -> str:
        return "x".join(str(s) for s in self.shape.values())

    @property
    def chips(self) -> int:
        return math.prod(self.shape.values())

    def size(self, axes) -> int:
        return math.prod(self.shape[a] for a in axes)

    def all_reduce(self, t: torch.Tensor, axes=("data",)) -> torch.Tensor:
        if self.counter is not None:
            self.counter.collective("all-reduce", tuple(axes), t)
        return t.clone()


def model_flops(cfg: ArchConfig, shape: ShapeConfig, n_params: int, n_active: int) -> float:
    """MODEL_FLOPS = 6·N·D (training) / 2·N·D (inference) with N = active
    params; D = processed tokens."""
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch * 1  # decode: one token


def _effective_cfg(arch: str, shape_name: str) -> ArchConfig:
    return GRANITE_SWA if (arch == "granite-3-2b" and shape_name == "long_500k") else get_config(arch)


def combo_supported(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    if shape.name == "long_500k" and not cfg.supports_long_decode():
        return False, "full-attention arch; no sub-quadratic variant (DESIGN.md §5)"
    return True, ""


def sharded_bytes(tree, specs, mesh) -> int:
    """The bytes of ``tree``'s leaves on one device: each leaf's bytes over
    the sizes of the mesh axes its spec (the same structure) names."""
    if isinstance(tree, dict):
        return sum(sharded_bytes(tree[k], specs[k], mesh) for k in tree)
    if isinstance(tree, (list, tuple)):
        return sum(sharded_bytes(t, s, mesh) for t, s in zip(tree, specs))
    if not isinstance(tree, torch.Tensor):
        return 0
    axes = [a for dim in specs if dim is not None
            for a in (dim if isinstance(dim, tuple) else (dim,))]
    return tensor_bytes(tree) // mesh.size(axes)


def trace_combo(arch: str, shape_name: str, mesh: ShapeMesh) -> tuple[OpCosts, dict]:
    """Run one (arch × shape) step as one rank of ``mesh``, on fake tensors,
    under an op counter (which ``mesh`` reports its collectives to).
    Returns (the counted costs, meta: the model-FLOPs bookkeeping, the trace
    seconds and the per-device memory)."""
    cfg = _effective_cfg(arch, shape_name)
    shape = INPUT_SHAPES[shape_name]
    dp = data_axes(mesh)
    n_dp = mesh.size(dp)
    b_dev = shape.global_batch // n_dp if shape.global_batch % n_dp == 0 else shape.global_batch
    specs_in = input_specs(cfg, shape)

    def fake(spec: torch.Tensor) -> torch.Tensor:
        """A batch-leading stand-in at the per-device batch."""
        rows = (b_dev,) if spec.ndim else ()
        return torch.zeros((*rows, *spec.shape[1:]), dtype=spec.dtype)

    with FakeTensorMode():
        params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
        n_params, n_active = param_count(params), active_param_count(params, cfg)
        p_specs = param_specs(params, mesh)
        counter = mesh.counter = OpCounter()
        if shape.kind == "train":
            opt = make_optimizer(cfg)
            opt_state = opt.init(params)
            o_specs = opt_state_specs(opt_state, p_specs)
            b_specs = batch_specs("train", dp, mesh, cfg)
            batch = {k: fake(specs_in[k]) for k in b_specs}
            step = make_train_step(cfg, opt, mesh=mesh, axes=dp)
            args = sharded_bytes(params, p_specs, mesh) + \
                sharded_bytes([opt_state.mu, opt_state.nu], [o_specs.mu, o_specs.nu], mesh) + \
                tensor_bytes(batch)
            with counter:
                new_params, new_opt, metrics = step(params, opt_state, batch)
            outs = sharded_bytes(new_params, p_specs, mesh) + tensor_bytes(metrics) + \
                sharded_bytes([new_opt.mu, new_opt.nu], [o_specs.mu, o_specs.nu], mesh)
        elif shape.kind == "prefill":
            b_specs = batch_specs("prefill", dp, mesh, cfg)
            batch = {k: fake(specs_in[k]) for k in b_specs}
            args = sharded_bytes(params, p_specs, mesh) + tensor_bytes(batch)
            with counter:
                out = make_prefill_step(cfg)(params, batch)
            outs = tensor_bytes(out)
        else:  # decode: one token against a seq_len cache
            # (layers, B, ...) stacked caches at the per-device batch
            caches = {kind: {name: torch.zeros((t.shape[0], b_dev, *t.shape[2:]), dtype=t.dtype)
                             for name, t in tree.items()}
                      for kind, tree in specs_in["caches"].items()}
            c_specs = cache_specs_sharding(specs_in["caches"], mesh, dp,
                                           shard_seq=shape.name == "long_500k")
            token = fake(specs_in["token"])
            enc_out = fake(specs_in["enc_out"]) if cfg.frontend is not None else None
            args = sharded_bytes(params, p_specs, mesh) + tensor_bytes(token) + \
                tensor_bytes(enc_out) + sharded_bytes(specs_in["caches"], c_specs, mesh)
            step = make_decode_step(cfg, max_seq=shape.seq_len)
            with counter:
                logits, _ = step(params, token, caches, shape.seq_len - 1, enc_out)
            outs = tensor_bytes(logits)  # the caches are updated in place
        mesh.counter = None
    costs = counter.costs
    memory = {"argument_bytes": float(args), "output_bytes": float(outs),
              "temp_bytes": float(costs.peak_live_bytes),
              "peak_bytes": float(args + costs.peak_live_bytes)}
    print(f"  traced in {costs.seconds:.1f}s ({sum(costs.ops.values())} ops, per-device "
          f"batch {b_dev})")
    print("  per_device_memory:", memory)
    meta = {
        "n_params": n_params,
        "n_active": n_active,
        "model_flops": model_flops(cfg, shape, n_params, n_active),
        "compile_s": costs.seconds,
        "per_device_batch": b_dev,
        "per_device_memory": memory,
    }
    return costs, meta


def _record(costs: OpCosts, meta: dict, arch: str, shape_name: str, mesh_name: str,
            chips: int) -> tuple[dict, RooflineReport]:
    report = roofline_from_trace(
        costs, arch=arch, shape=shape_name, mesh_name=mesh_name, chips=chips,
        model_flops=meta["model_flops"], per_device_memory=meta["per_device_memory"])
    rec = {"status": "ok", **report.to_dict(), **meta}
    rec["cost_analysis"] = {"flops": costs.flops, "bytes accessed": costs.bytes,
                            "bytes interior": costs.interior_bytes,
                            "collective bytes": costs.collective_bytes}
    return rec, report


def _write(out_dir: Path, stem: str, rec: dict, costs: OpCosts | None = None) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    if costs is not None:
        with gzip.open(out_dir / f"{stem}.ops.json.gz", "wt") as f:
            json.dump(costs.to_json(), f)
    (out_dir / f"{stem}.json").write_text(json.dumps(rec, indent=1))


def run_combo(arch: str, shape_name: str, *, multi_pod: bool, out_dir: Path = ARTIFACTS,
              tag: str = "") -> dict:
    mesh = ShapeMesh.production(multi_pod)
    cfg = _effective_cfg(arch, shape_name)
    shape = INPUT_SHAPES[shape_name]
    ok, why = combo_supported(cfg, shape)
    label = f"{arch} × {shape_name} × {mesh.name}"
    stem = f"{arch}--{shape_name}--{mesh.name}{f'-{tag}' if tag else ''}"
    if not ok:
        print(f"SKIP {label}: {why}")
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh.name,
               "status": "skipped", "reason": why}
        _write(out_dir, stem, rec)
        return rec
    print(f"TRACE {label}")
    try:
        costs, meta = trace_combo(arch, shape_name, mesh)
    except Exception as e:
        traceback.print_exc()
        return {"arch": arch, "shape": shape_name, "mesh": mesh.name,
                "status": "failed", "error": f"{type(e).__name__}: {e}"}
    rec, report = _record(costs, meta, arch, shape_name, mesh.name, mesh.chips)
    _write(out_dir, stem, rec, costs)
    print(
        f"  FLOPs={report.hlo_flops:.3e} bytes={report.hlo_bytes:.3e} "
        f"coll={report.coll_bytes:.3e} dominant={report.dominant} "
        f"useful={report.useful_flops_ratio:.2f}"
    )
    return rec


def reanalyze(out_dir: Path = ARTIFACTS) -> None:
    """Derive each record's roofline again from its saved per-op record (no
    step is run)."""
    for jf in sorted(out_dir.glob("*.json")):
        rec = json.loads(jf.read_text())
        ops = jf.parent / (jf.stem + ".ops.json.gz")
        if rec.get("status") != "ok" or not ops.exists():
            continue
        with gzip.open(ops, "rt") as f:
            costs = OpCosts.from_json(json.load(f))
        new, report = _record(costs, rec, rec["arch"], rec["shape"], rec["mesh"], rec["chips"])
        rec.update(new)
        jf.write_text(json.dumps(rec, indent=1))
        print(f"reanalyzed {jf.name}: dominant={report.dominant} "
              f"useful={report.useful_flops_ratio:.2f}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(INPUT_SHAPES), default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--reanalyze", action="store_true")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    if args.reanalyze:
        reanalyze()
        return
    if args.all:
        combos = [(a, s) for a in sorted(ARCHS) for s in sorted(INPUT_SHAPES)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        combos = [(args.arch, args.shape)]

    t0 = time.perf_counter()
    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    results = []
    for multi_pod in meshes:
        mesh_name = ShapeMesh.production(multi_pod).name
        for arch, shape in combos:
            out = ARTIFACTS / f"{arch}--{shape}--{mesh_name}{('-' + args.tag) if args.tag else ''}.json"
            if args.skip_existing and out.exists():
                print(f"EXISTS {arch} × {shape} × {mesh_name}")
                continue
            results.append(run_combo(arch, shape, multi_pod=multi_pod, tag=args.tag))
    failed = [r for r in results if r.get("status") == "failed"]
    print(f"\n{len([r for r in results if r['status'] == 'ok'])} ok, "
          f"{len(failed)} failed, "
          f"{len([r for r in results if r['status'] == 'skipped'])} skipped "
          f"in {time.perf_counter() - t0:.1f}s")
    if failed:
        for f in failed:
            print("FAILED:", f["arch"], f["shape"], f["mesh"], f["error"][:200])
        raise SystemExit(1)


if __name__ == "__main__":
    main()
