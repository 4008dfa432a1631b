"""The port's dry run (``repro_torch.launch.dryrun``,
``launch/dryrun_detector.py``) and its report
(``benchmarks/torch_roofline_report.py``) against the reference's, on the
CPU.

- ``input_specs`` and ``cache_shape_structs`` give the reference's trees on
  all 10 archs × 4 shapes: the same names, shapes and types, as ``meta``
  tensors that allocate nothing.
- Parameter counts, active counts and model FLOPs: the port's, from
  ``init_params`` under ``FakeTensorMode``, equal the reference's, from
  ``jax.eval_shape(init_params)`` and its dry run's own ``model_flops``,
  for every arch; ``combo_supported`` agrees on all 40 combos.
- The detector's dry run records, per device, exactly the U/V payload
  4·(Ñ² + Ñ·d_model) as its collective bytes, on both production meshes.
- A full-size llama3-405b × decode_32k (about 0.8 TB of bf16 weights)
  runs on fake tensors in a process whose peak RSS stays under 4 GB, and
  writes every key of the reference's record.
- ``--reanalyze`` derives the same report from the saved per-op record,
  and ``torch_roofline_report`` renders the records a run just wrote.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

from repro.configs import get_config as ref_get_config
from repro.models import init_params as ref_init_params
from repro.models import input_specs as ref_input_specs
from repro.roofline.analysis import RooflineReport as RefReport
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import dryrun, dryrun_detector
from repro_torch.models import INPUT_SHAPES, active_param_count, init_params, input_specs
from repro_torch.models import param_count

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from benchmarks import torch_roofline_report  # noqa: E402

torch.set_num_threads(2)

COMBOS = [(a, s) for a in sorted(ARCHS) for s in sorted(INPUT_SHAPES)]
RSS_LIMIT = 4 * 2 ** 30


def _reference_dryrun():
    """``repro.launch.dryrun``, imported without keeping the 512-device
    XLA flag it sets at import (this process's jax keeps its devices)."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as mod
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return mod


def _leaves(tree, path=()):
    """{path: (shape, type name)} of a tree of specs of either package."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, (*path, k)))
        return out if out or not path else {path: "empty"}
    dtype = str(tree.dtype).removeprefix("torch.")
    return {path: (tuple(tree.shape), dtype)}


@pytest.mark.parametrize("combo", COMBOS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_input_specs_match_the_reference(combo):
    arch, shape = combo
    got = input_specs(get_config(arch), INPUT_SHAPES[shape])
    want = ref_input_specs(ref_get_config(arch), INPUT_SHAPES[shape])
    assert _leaves(got) == _leaves(want)
    assert all(t.device.type == "meta" for t in jax.tree_util.tree_leaves(
        got, is_leaf=lambda x: isinstance(x, torch.Tensor)))


def _reference_counts(arch: str) -> tuple[int, int]:
    """n_params and n_active as the reference's ``lower_combo`` takes them."""
    cfg = ref_get_config(arch)
    struct = jax.eval_shape(lambda k: ref_init_params(k, cfg), jax.random.PRNGKey(0))
    n_params = sum(math.prod(x.shape) for x in jax.tree.leaves(struct))
    if not cfg.n_experts:
        return n_params, n_params
    expert = sum(math.prod(struct["layers"][kind]["moe"][nm].shape)
                 for kind in ("moe", "arctic") if kind in struct["layers"]
                 and "moe" in struct["layers"][kind] for nm in ("w_gate", "w_up", "w_down"))
    return n_params, int(n_params - expert * (1 - cfg.experts_per_token / cfg.n_experts))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_counts_and_model_flops_match_the_reference(arch):
    ref = _reference_dryrun()
    want_params, want_active = _reference_counts(arch)
    cfg = get_config(arch)
    with FakeTensorMode():
        params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
        assert isinstance(params["embed"], FakeTensor)
        n_params, n_active = param_count(params), active_param_count(params, cfg)
    assert (n_params, n_active) == (want_params, want_active)
    for name, shape in INPUT_SHAPES.items():
        got = dryrun.model_flops(cfg, shape, n_params, n_active)
        assert got == ref.model_flops(ref_get_config(arch), shape, want_params, want_active), name
        ok = dryrun.combo_supported(dryrun._effective_cfg(arch, name), shape)
        assert ok == ref.combo_supported(ref._effective_cfg(arch, name), shape), name


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
def test_detector_collective_bytes_are_the_uv_payload(tmp_path, multi_pod):
    rec = dryrun_detector.run(multi_pod, out_dir=tmp_path)
    d_model, n_hidden, chips = 4096, 128, 512 if multi_pod else 256
    payload = 4 * (n_hidden * n_hidden + n_hidden * d_model)
    assert rec["uv_payload_bytes"] == payload
    assert rec["coll_bytes_per_device"] == payload
    assert rec["coll_bytes"] == payload * chips
    axes = "pod,data" if multi_pod else "data"
    assert rec["coll_breakdown"] == {f"all-reduce({axes})": float(payload * chips)}
    mesh = "2x16x16" if multi_pod else "16x16"
    assert (tmp_path / f"oselm-detector--batch256_d4096--{mesh}.json").exists()


def test_full_size_decode_allocates_nothing(tmp_path):
    """llama3-405b × decode_32k at full size in a process of its own: its
    peak RSS (``resource.getrusage``) stays under 4 GB, and its record has
    every key of the reference's."""
    code = ("import resource\n"
            "from pathlib import Path\n"
            "from repro_torch.launch import dryrun\n"
            "rec = dryrun.run_combo('llama3-405b', 'decode_32k', multi_pod=False, "
            f"out_dir=Path({str(tmp_path)!r}))\n"
            "assert rec['status'] == 'ok', rec\n"
            "print('maxrss_kb', resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    rss = int(res.stdout.split("maxrss_kb")[1]) * 1024
    print(f"llama3-405b × decode_32k: peak RSS {rss / 2 ** 30:.2f} GiB")
    assert rss < RSS_LIMIT
    rec = json.loads((tmp_path / "llama3-405b--decode_32k--16x16.json").read_text())
    want_keys = {"status", "n_params", "n_active", "model_flops", "compile_s", "cost_analysis",
                 *RefReport("", "", "", 1, 1.0, 1.0, 0.0, 0.0, {}, 1.0, {}).to_dict()}
    assert want_keys <= set(rec)
    assert rec["status"] == "ok" and rec["n_params"] > 4e11
    assert rec["coll_bytes"] == 0.0  # decode sends nothing: the port shards the batch only


def test_reanalyze_and_the_report_render_a_runs_records(tmp_path):
    rec = dryrun.run_combo("gemma3-1b", "decode_32k", multi_pod=False, out_dir=tmp_path)
    skipped = dryrun.run_combo("llama3-405b", "long_500k", multi_pod=False, out_dir=tmp_path)
    assert rec["status"] == "ok" and skipped["status"] == "skipped"
    assert (tmp_path / "gemma3-1b--decode_32k--16x16.ops.json.gz").exists()
    path = tmp_path / "gemma3-1b--decode_32k--16x16.json"
    before = json.loads(path.read_text())
    dryrun.reanalyze(tmp_path)
    assert json.loads(path.read_text()) == before
    lines = torch_roofline_report.main(["--artifacts", str(tmp_path), "--device", "cpu"])
    assert lines == [f"roofline/report,1.0,records=1;worst_useful=gemma3-1b/decode_32k="
                     f"{before['useful_flops_ratio']:.2f}"]
    table = torch_roofline_report.render_table(torch_roofline_report.load_records(tmp_path))
    assert "| gemma3-1b | decode_32k | 16x16 |" in table
    assert "| llama3-405b | long_500k | 16x16 | — |" in table
    assert torch_roofline_report.main(["--artifacts", str(tmp_path / "none")])[0].endswith(
        "no-artifacts-yet (run repro_torch.launch.dryrun)")
