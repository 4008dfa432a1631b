"""The port's §5 harness (``benchmarks/torch_paper_eval.py``) against the
reference's live ``benchmarks.paper_eval.eval_scenario``, on the CPU.

``har`` at the smoke sizes on ring and star. The port starts from the
reference's initial fleet (``repro_torch.convert``) and the reference's
initial BP-NN3 and FedAvg networks, and trains them on the reference's
shuffles (``jax.random`` cannot be repeated by a ``torch.Generator``, so
the test draws the permutations the reference draws and hands them to
the port's trainer in order, as ``tests/test_torch_baselines.py`` does).
Bounds:

- merges, comm bytes, bytes per merge, FedAvg's matched bytes, the comm
  ratio and the detection counts equal, and the sink's ledger equal to
  the governor's (``eval_scenario`` asserts that itself);
- f32 scenario AUCs within 1e-3 per device mean, the bound of
  ``tests/test_torch_scenarios.py`` (the runtimes' losses part by f32
  rounding across frameworks);
- BP-NN3 and FedAvg AUCs within 1e-6, ``tests/test_torch_baselines.py``'s
  bound on ``bpnn_auc`` (the trained networks agree at its rtol 1e-5);
- ``check_claims`` gives the reference's verdicts; the port's tick
  percentiles are positive seconds (two packages' clocks measure
  different code, so they are not compared).
"""
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.baselines import bpnn3_config as ref_bpnn3_config
from repro.baselines import init_bpnn as ref_init_bpnn
from repro.scenarios import make_scenario as ref_make_scenario
from repro_torch.baselines import bpnn as tbpnn
from repro_torch.convert import bpnn_params_from_numpy, oselm_state_from_numpy
from repro_torch.scenarios import make_scenario

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import benchmarks.paper_eval as ref_pe  # noqa: E402
import benchmarks.torch_paper_eval as pe  # noqa: E402

torch.set_num_threads(2)

NAME = "har"
TOPOLOGIES = ("ring", "star")
SEED = 0


def _bpnn_shuffles(seed, n, epochs):
    """The permutations the reference's train_bpnn draws from PRNGKey(seed)."""
    key, perms = jax.random.PRNGKey(seed), []
    for _ in range(epochs):
        key, k = jax.random.split(key)
        perms.append(torch.from_numpy(np.array(jax.random.permutation(k, n))))
    return perms


def _fedavg_shuffles(seed, sizes, rounds):
    """The permutations the reference's run_fedavg draws from PRNGKey(seed):
    each round, each client's one local epoch."""
    key, perms = jax.random.PRNGKey(seed), []
    for _ in range(rounds):
        for n in sizes:
            key, k = jax.random.split(key)
            _, k2 = jax.random.split(k)
            perms.append(torch.from_numpy(np.array(jax.random.permutation(k2, n))))
    return perms


@pytest.fixture(scope="module")
def rows():
    want = ref_pe.eval_scenario(NAME, pe.SMOKE_SIZES, TOPOLOGIES, seed=SEED)

    ref_sc = ref_make_scenario(NAME, **pe.SMOKE_SIZES).build()
    fleet = ref_sc.init_fleet(jax.random.PRNGKey(SEED))
    port_fleet = oselm_state_from_numpy(fleet.params.alpha, fleet.params.bias, fleet.beta,
                                        fleet.p, activation=fleet.activation,
                                        forget=fleet.forget, device="cpu")
    cfg = ref_bpnn3_config(ref_sc.n_features, pe.BPNN_HIDDEN, batch=8, epochs=pe.BPNN_EPOCHS)

    def init(seed):
        return bpnn_params_from_numpy(
            jax.tree.map(np.asarray, ref_init_bpnn(jax.random.PRNGKey(seed), cfg)), device="cpu")

    x_pool, per_device = pe._normal_phase_pool(ref_sc)
    perms = (_bpnn_shuffles(SEED, len(x_pool), pe.BPNN_EPOCHS)
             + _fedavg_shuffles(SEED + 1, [len(x) for x in per_device],
                                want["fedavg"]["rounds"]))
    mp = pytest.MonkeyPatch()
    mp.setattr(tbpnn, "_permutation", lambda generator, n: perms.pop(0))
    try:
        got = pe.eval_scenario(NAME, pe.SMOKE_SIZES, TOPOLOGIES, seed=SEED, device="cpu",
                               scenario=make_scenario(NAME, **pe.SMOKE_SIZES).build(),
                               fleet=port_fleet, bpnn_params=init(SEED),
                               fedavg_params=init(SEED + 1))
    finally:
        mp.undo()
    assert not perms, f"{len(perms)} shuffles left over"
    return got, want


@pytest.mark.parametrize("topo", TOPOLOGIES)
def test_ledger_and_detections_equal_the_reference(rows, topo):
    got, want = rows[0]["topologies"][topo], rows[1]["topologies"][topo]
    for key in ("merges", "comm_bytes", "bytes_per_merge", "fedavg_bytes_matched",
                "comm_ratio_vs_fedavg", "detection_delay_mean", "missed_detections",
                "false_positives"):
        assert got[key] == want[key], key
    assert got["merges"] >= 1 and got["launches"] is None  # no kernel launches on the CPU


@pytest.mark.parametrize("topo", TOPOLOGIES)
def test_scenario_aucs_match_the_reference(rows, topo):
    got, want = rows[0]["topologies"][topo], rows[1]["topologies"][topo]
    for key in ("local_auc_mean", "merged_auc_mean", "merged_auc_min", "clean_merged_auc_mean"):
        assert abs(got[key] - want[key]) <= 1e-3, (key, got[key], want[key])
    assert 0 < got["tick_p50_us"] <= got["tick_p99_us"]


def test_baseline_aucs_match_the_reference(rows):
    got, want = rows
    assert got["fedavg"]["rounds"] == want["fedavg"]["rounds"]
    assert got["fedavg"]["bytes"] == want["fedavg"]["bytes"]
    assert abs(got["bpnn"]["auc"] - want["bpnn"]["auc"]) <= 1e-6
    assert abs(got["fedavg"]["auc"] - want["fedavg"]["auc"]) <= 1e-6


@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_claims_give_the_reference_verdicts(rows, precision):
    got, want = rows
    factor = pe.COMM_FACTOR_BY_PRECISION[precision]
    assert factor == ref_pe.COMM_FACTOR_BY_PRECISION[precision]
    g = pe.check_claims({"scenarios": {NAME: got}}, TOPOLOGIES, comm_factor=factor)
    w = ref_pe.check_claims({"scenarios": {NAME: want}}, TOPOLOGIES, comm_factor=factor)
    assert {k: g[k] for k in w} == w
    assert g["kernels_launched"] is None


def test_constants_are_the_reference_harness(rows):
    for name in ("MERGE_EVERY", "BPNN_HIDDEN", "BPNN_EPOCHS", "AUC_MARGIN", "SMOKE_SIZES",
                 "FULL_SIZES", "SMOKE_TOPOLOGIES", "FULL_TOPOLOGIES", "UNASSERTED_TOPOLOGIES",
                 "COMM_FACTOR_BY_PRECISION"):
        assert getattr(pe, name) == getattr(ref_pe, name), name
    assert set(pe.MERGE_ROUTES) == set(pe.FULL_TOPOLOGIES)
    assert pe.routed_kernels("star", "int8") == (
        "fleet_ingest", "masked_segment_sum_mix", "from_uv_solve", "quantize_pack")
