"""The port's serving benchmarks (``benchmarks/torch_serve_runtime.py``,
``benchmarks/torch_serve_ingress.py``) and its fleet-serving driver
(``python -m repro_torch.launch.serve --fleet``), on the CPU.

- Each benchmark's ``--device cpu`` legs run inside the test with their
  claims asserted. Only tick counts are cut, never widths: the
  serve-runtime soak runs 120 ticks of its 220 (D = 256, n = 561, Ñ = 16
  as in the acceptance configuration; every drift event still falls in
  the middle half of the shorter streams), and the ingress steady leg 2
  waves a client of its 8 (D = 256, n = 16, Ñ = 8). The ingress crash
  leg's child runs as a subprocess on the CPU and is SIGKILLed after tick
  28, as on the card. The two wall-clock claims of the ingress bench are
  the card's (the CPU rehearsal reports them).
- Started from the reference's initial fleet (handed over as numpy), the
  port's serve-runtime soak reproduces the reference's live soak: the
  same missed drifts, false positives, merges and bytes, and AUCs within
  1e-3 (``tests/test_torch_bench_fleet.py``'s AUC bound); its int8 probe
  the reference's bytes and ratio exactly.
- The driver serves a few hundred requests on the CPU and prints the
  reference's JSON summary keys; without ``--device cpu`` and without a
  card it raises.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.fleet import init_fleet as ref_init_fleet
from repro_torch.convert import oselm_state_from_numpy

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from benchmarks import serve_runtime as ref_serve_runtime  # noqa: E402
from benchmarks import torch_run, torch_serve_ingress, torch_serve_runtime  # noqa: E402

torch.set_num_threads(2)

SOAK_TICKS = 120       # of the acceptance's 220
DIFF_TICKS = 100       # the differential's soak, gated only
INGRESS_ROUNDS = 2     # of the steady leg's 8 waves a client
CPU = torch.device("cpu")


def _ref_fleet_maker(fs, n_features, seed, device):
    """The reference's initial fleet for the port's soak, as numpy."""
    f = ref_init_fleet(jax.random.PRNGKey(seed), fs.n_devices, n_features,
                       torch_serve_runtime.N_HIDDEN, fs.x_init, activation="identity",
                       ridge=torch_serve_runtime.RIDGE)
    return oselm_state_from_numpy(f.params.alpha, f.params.bias, f.beta, f.p,
                                  activation=f.activation, forget=f.forget, device=device)


def test_serve_runtime_cpu_rehearsal_asserts_its_claims(tmp_path):
    lines = torch_serve_runtime.main(
        True, str(tmp_path / "sr.json"), str(tmp_path / "h.jsonl"), "cpu",
        ticks=SOAK_TICKS, telemetry=True, telemetry_dir=str(tmp_path / "tel"))
    report = json.loads((tmp_path / "sr.json").read_text())
    g, u = report["gated"], report["ungated"]
    assert g["ticks"] == u["ticks"] == SOAK_TICKS and g["n_devices"] == 256
    assert g["n_drift_events"] == 64 and not g["false_positives"]
    assert report["quantized_probe"]["byte_ratio_per_payload"] >= 3.5
    assert report["flight_probe"]["replay_matches"]
    assert [line.split(",")[0] for line in lines[:4]] == [
        "torch_serve_runtime/gated/d256", "torch_serve_runtime/ungated/d256",
        "torch_serve_runtime/slo/d64", "torch_serve_runtime/quantized/d64"]
    assert any(line.startswith("torch_serve_runtime/telemetry/") for line in lines)
    history = [json.loads(x) for x in (tmp_path / "h.jsonl").read_text().splitlines()]
    assert history[-1]["bench"] == "torch_serve_runtime" and history[-1]["backend"] == "cpu"


def test_serve_runtime_from_the_references_fleet_is_the_references_soak(monkeypatch):
    """The port's gated soak and int8 probe, started from the reference's
    initial fleet, against the reference's live run on the same streams:
    the benchmark's numbers are the reference's, so its basis-dependent
    claims are the basis's, not the port's."""
    ds, fs, x_eval, y_eval = ref_serve_runtime.build_scenario(256, DIFF_TICKS)
    ref = ref_serve_runtime.run_soak(fs, x_eval, y_eval, ds.n_features, gate=True)
    monkeypatch.setattr(torch_serve_runtime, "_fleet", _ref_fleet_maker)
    pds, pfs, px_eval, py_eval = torch_serve_runtime.build_scenario(256, DIFF_TICKS)
    np.testing.assert_array_equal(pfs.xs, np.asarray(fs.xs))
    np.testing.assert_array_equal(px_eval, np.asarray(x_eval))
    port = torch_serve_runtime.run_soak(pfs, px_eval, py_eval, pds.n_features, gate=True,
                                        device=CPU)
    for key in ("ticks", "merges", "bytes_spent", "n_drift_events", "missed_detections",
                "false_positives", "detection_delay_ticks_max"):
        assert port[key] == ref[key], (key, port[key], ref[key])
    assert abs(port["clean_auc_mean"] - ref["clean_auc_mean"]) <= 1e-3
    assert abs(port["clean_auc_min"] - ref["clean_auc_min"]) <= 1e-3

    ref_q = ref_serve_runtime.run_quantized_probe()
    port_q = torch_serve_runtime.run_quantized_probe(device=CPU)
    for prec in ("f32", "int8"):
        assert port_q[prec]["merges"] == ref_q[prec]["merges"]
        assert port_q[prec]["bytes_spent"] == ref_q[prec]["bytes_spent"]
        assert abs(port_q[prec]["clean_auc_mean"] - ref_q[prec]["clean_auc_mean"]) <= 1e-3
    assert port_q["byte_ratio_per_round"] == ref_q["byte_ratio_per_round"]


def test_serve_ingress_cpu_rehearsal_asserts_its_claims(tmp_path):
    lines = torch_serve_ingress.main(
        True, str(tmp_path / "si.json"), str(tmp_path / "h.jsonl"), "cpu",
        rounds=INGRESS_ROUNDS, crash_dir=str(tmp_path / "crash"))
    report = json.loads((tmp_path / "si.json").read_text())
    s, c = report["steady"], report["crash"]
    assert s["requests"] == 16 * 32 * INGRESS_ROUNDS == s["ok"] == s["acked"]
    assert s["warmup_thread"] == "serve-tick-worker"
    # the child ran to tick 28 and died by SIGKILL; the parent replayed
    # from the newest snapshot (every 8 ticks) bit for bit
    assert c["child_ticks"] >= torch_serve_ingress.CRASH_KILL_AT_TICK + 1
    assert c["restored_tick"] % torch_serve_ingress.CRASH_SNAPSHOT_EVERY == 0
    assert c["replayed_compared"] == c["child_ticks"] - c["restored_tick"]
    assert c["fresh_requests_ok"] == 4 * 16 * 2
    assert [line.split(",")[0] for line in lines[:4]] == [
        "torch_serve_ingress/steady/d256", "torch_serve_ingress/flood/d64",
        "torch_serve_ingress/crash/d64", "torch_serve_ingress/degraded/d32"]


def test_serve_benches_are_registered_in_the_harness():
    names = [name for name, _ in torch_run.BENCHES]
    assert "torch_serve_runtime" in names and "torch_serve_ingress" in names
    assert "serve_runtime" not in torch_run.__doc__.split("not yet ported")[1]


def _driver(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--fleet", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)


def test_serve_fleet_driver_serves_on_the_cpu(tmp_path):
    res = _driver("--device", "cpu", "--devices", "16", "--requests", "300",
                  "--clients", "6", "--merge-every", "4",
                  "--telemetry-dir", str(tmp_path / "tel"))
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout)
    assert sorted(out) == ["acks", "ingress", "merges", "ticks"]
    assert out["acks"] == {"ok": 300}
    assert out["ingress"]["accepted"] == out["ingress"]["acked"] == 300
    assert out["ticks"] > 0 and out["merges"] > 0
    for key in ("shed", "deferred", "retried", "queue_depth", "degraded_mode",
                "admission_latency", "request_latency", "replayed_ticks"):
        assert key in out["ingress"], key
    assert (tmp_path / "tel" / "exposition.txt").exists()


def test_serve_fleet_driver_recovers_its_own_snapshot_and_log(tmp_path):
    args = ("--device", "cpu", "--devices", "16", "--requests", "200", "--clients", "4",
            "--snapshot-dir", str(tmp_path / "snap"), "--snapshot-every", "8",
            "--wal-dir", str(tmp_path / "wal"))
    first = _driver(*args)
    assert first.returncode == 0, first.stderr[-3000:]
    ticks = json.loads(first.stdout)["ticks"]
    again = _driver(*args, "--recover")
    assert again.returncode == 0, again.stderr[-3000:]
    head, _, body = again.stdout.partition("\n")
    restored = ticks - ticks % 8
    assert head == f"recovered: tick {restored} + {ticks - restored} replayed windows"
    summary = json.loads(body)
    assert summary["ticks"] > ticks
    assert summary["ingress"]["replayed_ticks"] == ticks - restored


def test_serve_fleet_driver_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the driver's default device exists")
    res = _driver("--devices", "8", "--requests", "10", timeout=120)
    assert res.returncode != 0
    assert "no CUDA device is available" in res.stderr
