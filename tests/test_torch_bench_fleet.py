"""The port's fleet-scale benchmarks (``benchmarks/torch_fleet_scale.py``
with its merge bench, ``benchmarks/torch_fleet_ingest.py``) against the
reference's, on the CPU.

The reference's trained fleets are handed to the port's benchmarks
through their seams (``train=``, ``fleet_maker=``) as numpy arrays
(``repro_torch.convert``). Bounds: merged β within 5e-5 of the
reference's ``fleet_merge`` (ROADMAP queue 3: the reference's own
Gauss-Jordan and Cholesky merges differ by up to 1.8e-5 on β, and the port
solves by Gauss-Jordan); AUC rows within 1e-3; payloads, bytes and the
analytic FLOP and byte counts equal, exactly; each device's dense row
within 1e-5 of its sparse sum; the ingest baseline at the reference's own
agreement bounds (``benchmarks/fleet_ingest.py:100-111``: β at rtol 1e-4
/ atol 1e-5, the losses at 1e-5 / 1e-7).
"""
import functools
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fleet import all_to_all as ref_all_to_all
from repro.fleet import fleet_merge as ref_fleet_merge
from repro.fleet import fleet_train as ref_fleet_train
from repro.fleet import hierarchical as ref_hierarchical
from repro.fleet import init_fleet as ref_init_fleet
from repro.fleet import ring as ref_ring
from repro.fleet import star as ref_star
from repro_torch.convert import oselm_state_from_numpy
from repro_torch.fleet import all_to_all, hierarchical, ring, star
from repro_torch.kernels import fleet_ingest_plain
from repro_torch.kernels import topology_merge as tm

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from benchmarks import fleet_ingest as ref_fleet_ingest  # noqa: E402
from benchmarks import fleet_scale as ref_fleet_scale  # noqa: E402
from benchmarks import fleet_cohort as ref_fleet_cohort  # noqa: E402
from benchmarks import torch_fleet_cohort, torch_fleet_ingest, torch_fleet_scale  # noqa: E402
from benchmarks import torch_history, torch_run  # noqa: E402

torch.set_num_threads(2)

TOPOLOGIES = ("all_to_all", "star", "ring2", "hierarchical")


def _port(ref):
    return oselm_state_from_numpy(ref.params.alpha, ref.params.bias, ref.beta, ref.p,
                                  activation=ref.activation, forget=ref.forget, device="cpu")


def _ref_topologies(n):
    return {t.name: t for t in (ref_all_to_all(n), ref_star(n), ref_ring(n, hops=2),
                                ref_hierarchical(n, max(1, n // 8)))}


@pytest.fixture(scope="module")
def scale_rows():
    """fleet_scale's D = 8 rows: the port's from the reference's trained
    fleet, the reference's own, and that fleet's reference merges."""
    fleets = {}

    def ref_train(fs, seed, device):
        f0 = ref_init_fleet(jax.random.PRNGKey(seed), fs.n_devices, fs.xs.shape[2],
                            torch_fleet_scale.N_HIDDEN, jnp.asarray(fs.x_init),
                            activation="identity", ridge=1e-3)
        fleets["ref"] = ref_fleet_train(f0, jnp.asarray(fs.xs))
        return _port(fleets["ref"])

    got = torch_fleet_scale.run((8,), device="cpu", train=ref_train)
    want = ref_fleet_scale.run(device_grid=(8,))
    merged = {name: np.asarray(ref_fleet_merge(fleets["ref"], topo, ridge=1e-3).beta)
              for name, topo in _ref_topologies(8).items()}
    return {r["topology"]: r for r in got}, {r["topology"]: r for r in want}, merged


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_fleet_scale_rows_match_reference(scale_rows, topology):
    got, want, merged = scale_rows
    g, w = got[topology], want[topology]
    assert (g["n_devices"], g["payloads"], g["bytes"]) == (w["n_devices"], w["payloads"],
                                                           w["bytes"])
    assert abs(g["auc_mean"] - w["auc_mean"]) <= 1e-3 and abs(g["auc_min"] - w["auc_min"]) <= 1e-3
    diff = float(np.max(np.abs(g["merged_beta"].numpy() - merged[topology])))
    print(f"{topology}: merged beta max |port − reference| {diff:.2e} (bound 5e-5)")
    assert diff <= 5e-5
    assert np.isnan(g["beta_diff_vs_all_to_all"]) == np.isnan(w["beta_diff_vs_all_to_all"])


def test_fleet_scale_fedavg_row_matches_reference(scale_rows):
    got, want, _ = scale_rows
    name = f"fedavg_r{torch_fleet_scale.FEDAVG_ROUNDS}"
    assert (got[name]["payloads"], got[name]["bytes"]) == (want[name]["payloads"],
                                                           want[name]["bytes"])


def test_fleet_scale_claims_hold_on_the_ports_own_fleet():
    """The grid's claims at D = 8 on a fleet the port trains (its basis
    from a torch generator, the ingest's plain version)."""
    lines = torch_fleet_scale.main_lines((8,), device="cpu")
    assert [line.split(",")[0] for line in lines] == [
        f"fleet_scale/{t}/d8" for t in (*TOPOLOGIES, "fedavg_r10")]


@pytest.mark.parametrize("n_dev", [8, 256, 1024, 4096])
def test_cost_accounting_matches_reference(n_dev):
    f = 32 * (32 + 48)
    ref_topos = _ref_topologies(n_dev)
    for topo in (all_to_all(n_dev), star(n_dev), ring(n_dev, hops=2),
                 hierarchical(n_dev, max(1, n_dev // 8))):
        ref = ref_topos[topo.name]
        assert torch_fleet_scale._mix_flops_bytes(topo, n_dev, f) == \
            ref_fleet_scale._mix_flops_bytes(ref, n_dev, f), topo.name
        assert torch_fleet_scale._n_solves(topo) == ref_fleet_scale._n_solves(ref), topo.name
    assert torch_fleet_scale._dense_flops_bytes(n_dev, f) == \
        ref_fleet_scale._dense_flops_bytes(n_dev, f)


def test_merge_bench_dense_rows_equal_the_sparse_sums():
    report = torch_fleet_scale.merge_bench((16, 64), device="cpu")
    want = ref_fleet_scale.merge_bench((16, 64))
    keys = ("n_devices", "topology", "flops_sparse", "flops_dense", "bytes_sparse",
            "bytes_dense", "payloads", "solves")
    assert [tuple(r[k] for k in keys) for r in report["rows"]] == [
        tuple(r[k] for k in keys) for r in want["rows"]]
    for r in report["rows"]:
        assert r["dense_row_rel_err"] <= torch_fleet_scale.DENSE_ROW_TOL, r
    # the same check in f64, independently of the benchmark's own
    for n_dev in (16, 64):
        w = torch.randn((n_dev, 32, 80), generator=torch.Generator().manual_seed(n_dev))
        w2 = w.reshape(n_dev, -1).double().numpy()
        for topo in (ring(n_dev, hops=2), hierarchical(n_dev, n_dev // 8), star(n_dev)):
            dense = topo.dense_matrix().astype(np.float64) @ w2
            sparse = torch_fleet_scale.sparse_mix(topo, w).reshape(-1, w2.shape[1]).numpy()
            rel = np.max(np.abs(dense - sparse)) / np.max(np.abs(sparse))
            assert rel <= 1e-5, (topo.name, n_dev, rel)


def _ref_fleet(n_dev):
    fleet, window = ref_fleet_ingest._make_fleet(n_dev)
    return fleet, window, _port(fleet), torch.from_numpy(np.array(window))


def _agree(got_states, got_losses, want_states, want_losses):
    np.testing.assert_allclose(got_states.beta.numpy(), np.asarray(want_states.beta),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_losses.numpy(), np.asarray(want_losses), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("n_dev", [16, 64])
def test_ingest_baseline_matches_reference(n_dev):
    fleet, window, port_fleet, port_window = _ref_fleet(n_dev)
    want = ref_fleet_ingest._baseline_ingest(fleet, window)
    _agree(*torch_fleet_ingest.baseline_ingest(port_fleet, port_window), *want)
    # and the kernel's plain version against the baseline
    _agree(*fleet_ingest_plain(port_fleet, port_window),
           *torch_fleet_ingest.baseline_ingest(port_fleet, port_window))


def test_ingest_bench_on_reference_fleets():
    report = torch_fleet_ingest.run_bench(
        (16, 32), device="cpu", fleet_maker=lambda n, seed, device: _ref_fleet(n)[2:])
    assert [r["n_devices"] for r in report["rows"]] == [16, 32]
    for r in report["rows"]:
        assert r["kernel_plain_rel"] == 0.0  # on the CPU the kernel is its plain version
        assert r["state_bytes_baseline"] == 32 * r["state_bytes_fused"]
        assert r["state_bytes_fused"] == ref_fleet_ingest._state_traffic_bytes(
            r["n_devices"], per_sample=False)


def test_ingest_report_writes_its_artifact_and_history(tmp_path):
    out, history = tmp_path / "ingest.json", tmp_path / "history.jsonl"
    lines = torch_fleet_ingest.report_lines((16,), str(out), str(history), gate=True,
                                            device="cpu")
    assert lines[0].startswith("fleet_ingest/d16,")
    assert json.loads(out.read_text())["backend"] == "cpu"
    entry = json.loads(history.read_text())
    assert entry["bench"] == "torch_fleet_ingest" and set(entry["metrics"]) == {
        "fused_d16_host_ms", "baseline_d16_host_ms"}


def test_ingest_gate_reads_the_device_time_keys_only(tmp_path):
    """The standalone ingest gate: a 30 % rise of a device-time key fires
    it; entries of the old events keys (``fused_d{D}_us``) are no baseline
    for the new keys, and the CPU's host-clock keys gate nothing."""
    path = tmp_path / "history.jsonl"
    gate = functools.partial(torch_history.record_and_gate, "torch_fleet_ingest",
                             backend="NVIDIA H100 80GB HBM3", path=path)
    gate({"fused_d256_us": 100.0, "baseline_d256_us": 5000.0})       # an old run
    gate({"fused_d256_device_us": 90.0, "baseline_d256_device_us": 900.0})  # seeds
    gate({"fused_d256_device_us": 110.0, "baseline_d256_device_us": 1100.0})  # +22 %
    with pytest.raises(AssertionError, match=r"fused_d256_device_us.*30% slower"):
        gate({"fused_d256_device_us": 143.0, "baseline_d256_device_us": 1100.0})
    host = functools.partial(torch_history.record_and_gate, "torch_fleet_ingest",
                             backend="cpu", path=path)
    host({"fused_d16_host_ms": 1.0})
    host({"fused_d16_host_ms": 9.0})


def test_kernel_offsets_are_kept_by_content():
    """The segment kernels' offsets are checked, computed and put on the
    device once per content (a copy from pageable memory at every call
    waits for the stream: on the card it cost the merge bench's sparse path
    its D = 1024 win); bad ids still raise."""
    cpu = torch.device("cpu")
    ids = np.array([0, 0, 1, 1, 1, 3], np.int32)
    got = tm._device_starts(ids, 6, 4, "segment_sum_mix", cpu)
    starts, longest = got
    assert starts.dtype == torch.int32 and starts.tolist() == [0, 2, 5, 5, 6] and longest == 3
    assert tm._device_starts(ids.astype(np.int64), 6, 4, "segment_sum_mix", cpu) is got
    assert tm._device_starts(ids, 6, 5, "segment_sum_mix", cpu) is not got
    with pytest.raises(ValueError, match="sorted"):
        tm._device_starts(ids[::-1], 6, 4, "segment_sum_mix", cpu)
    with pytest.raises(ValueError, match=r"\(7,\)"):
        tm._device_starts(ids, 7, 4, "segment_sum_mix", cpu)
    assert tm._broadcast_on(*tm._ids_key(ids), 4, cpu).tolist() == ids.tolist()


def test_cohort_bench_rehearses_on_the_cpu(tmp_path):
    """``torch_fleet_cohort --device cpu``: the parity check at D = 64, the
    D = 4096 point in cohorts of 1024, its artifact and its history keys
    (host-clock keys no gate reads, and the tier-2 reduction)."""
    out, history = tmp_path / "cohort.json", tmp_path / "history.jsonl"
    lines = torch_fleet_cohort.main(["--device", "cpu", "--out", str(out),
                                     "--history", str(history)], gate=True)
    assert lines[0].startswith("fleet_cohort/parity_d64,nan,")
    assert lines[1].startswith(f"fleet_cohort/d{torch_fleet_cohort.CPU_D},")
    report = json.loads(out.read_text())
    assert report["backend"] == "cpu"
    parity = report["parity"]
    assert parity["beta_gap"] <= parity["bound"] and parity["sums_rel"] <= 1e-5
    (row,) = report["rows"]
    assert row["n_cohorts"] == torch_fleet_cohort.CPU_D // torch_fleet_cohort.CPU_COHORT
    assert row["tier2_bytes_per_round"] * 100 < row["flat_bytes_per_round"]
    assert row["copy_hidden_share"] is None and row["tick_device_us"] is None
    d = torch_fleet_cohort.CPU_D
    entry = json.loads(history.read_text())
    assert entry["bench"] == "torch_fleet_cohort" and set(entry["metrics"]) == {
        f"paged_tick_d{d}_host_ms", f"two_tier_merge_d{d}_host_ms", f"tier2_reduction_d{d}_ratio"}


@pytest.mark.parametrize("d", [ref_fleet_cohort.SMOKE_D, ref_fleet_cohort.FULL_D])
def test_cohort_bench_grid_and_tiers_are_the_references(d):
    """The same grid and the same tier accounting as the reference's bench
    at both scale points, without running either."""
    assert (torch_fleet_cohort.N_HIDDEN, torch_fleet_cohort.N_FEATURES, torch_fleet_cohort.BATCH,
            torch_fleet_cohort.COHORT, torch_fleet_cohort.SMOKE_D, torch_fleet_cohort.FULL_D,
            torch_fleet_cohort.PARITY_D, torch_fleet_cohort.PARITY_C) == (
        ref_fleet_cohort.N_HIDDEN, ref_fleet_cohort.N_FEATURES, ref_fleet_cohort.BATCH,
        ref_fleet_cohort.COHORT, ref_fleet_cohort.SMOKE_D, ref_fleet_cohort.FULL_D,
        ref_fleet_cohort.PARITY_D, ref_fleet_cohort.PARITY_C)
    from repro.fleet import CohortSchedule as RefCohortSchedule
    from repro.fleet import cohort_round_cost as ref_cost
    from repro_torch.fleet import CohortSchedule, cohort_round_cost

    got = cohort_round_cost(star(d), CohortSchedule(d, torch_fleet_cohort.COHORT), 4, 8)
    want = ref_cost(ref_star(d), RefCohortSchedule(d, ref_fleet_cohort.COHORT), 4, 8)
    assert (got.tier1_payloads, got.tier2_payloads, got.payload_bytes) == (
        want.tier1_payloads, want.tier2_payloads, want.payload_bytes)
    assert got.tier2_payloads * 100 < star(d).payloads_per_round


def test_cohort_bench_is_registered_in_the_harness():
    names = [name for name, _ in torch_run.BENCHES]
    assert "torch_fleet_cohort" in names
    assert "fleet_cohort" not in torch_run.__doc__.split("not yet ported")[1]
