"""The port's paper benchmarks (``benchmarks/torch_merge_loss.py``,
``torch_ablation_hidden.py``, ``torch_rocauc_grid.py``,
``torch_kernel_bench.py``) and its harness (``benchmarks/torch_run.py``)
against the reference's, on the CPU.

The reference's devices and BP-NNs are trained by the reference and handed
to the port's benchmarks through their seams (``trainer=``, ``fit=``), as
numpy arrays (``repro_torch.convert``): the port's generators cannot repeat
``jax.random``'s streams. The bounds are ``tests/test_torch_pair_eval.py``'s:
AUCs within 1e-3 (a one-shot Cholesky merge in each framework); the
unmerged devices' per-pattern losses at rtol 1e-5; the merged model's
losses held to an f64 merge of the same two devices at twice the
reference's own distance from it (the merge solves at κ(U) ~ 1e5 without
a ridge, so both f32 merges stray from the f64 one). The claims' booleans
are equal.
"""
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.baselines import bpnn3_config as ref_bpnn3_config
from repro.baselines import train_bpnn as ref_train_bpnn
from repro.baselines.bpnn import BPNNConfig as RefBPNNConfig
from repro.configs.oselm_edge import EdgeConfig as RefEdgeConfig
from repro_torch.baselines import bpnn3_config
from repro_torch.configs import EdgeConfig
from repro_torch.convert import bpnn_params_from_numpy, oselm_state_from_numpy
from repro_torch.data import class_subset, train_test_split

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from benchmarks import ablation_hidden as ref_ablation  # noqa: E402
from benchmarks import merge_loss as ref_merge_loss  # noqa: E402
from benchmarks import rocauc_grid as ref_rocauc  # noqa: E402
from benchmarks import torch_ablation_hidden, torch_kernel_bench, torch_merge_loss  # noqa: E402
from benchmarks import torch_rocauc_grid, torch_run  # noqa: E402
from benchmarks.common import train_edge_device as ref_train_edge_device  # noqa: E402
from benchmarks.torch_common import normalized_dataset  # noqa: E402
from test_torch_pair_eval import _f64_merged_losses  # noqa: E402

torch.set_num_threads(2)


class RefTrainer:
    """The seam's trainer: the reference trains the device (its key from
    the port's integer key) and the port receives its state; every state
    is kept for the f64 checks."""

    def __init__(self):
        self.states = []

    def __call__(self, ds, pattern, *, key, ecfg, seed, device=None):
        ref = ref_train_edge_device(ds, pattern, key=jax.random.PRNGKey(key),
                                    ecfg=RefEdgeConfig(*ecfg.__dict__.values()), seed=seed)
        self.states.append(ref)
        return oselm_state_from_numpy(ref.params.alpha, ref.params.bias, ref.beta, ref.p,
                                      activation=ref.activation, forget=ref.forget,
                                      device=device)


@pytest.mark.parametrize("dataset", sorted(torch_merge_loss.SCENARIOS))
def test_merge_loss_matches_reference(dataset):
    trainer = RefTrainer()
    got = torch_merge_loss.run(dataset, device="cpu", trainer=trainer)
    want = ref_merge_loss.run(dataset)
    assert list(got["rows"]) == list(want["rows"])
    for pat, row in got["rows"].items():
        for col in ("A_before", "B"):
            np.testing.assert_allclose(row[col], want["rows"][pat][col], rtol=1e-5,
                                       err_msg=f"{dataset} {pat} {col}")
    ds = normalized_dataset(dataset)
    _, test = train_test_split(ds, 0.8, seed=0)
    exact = _f64_merged_losses(*trainer.states, test, 64)
    port = max(abs(got["rows"][p]["A_after"] - exact[p]) / exact[p] for p in exact)
    ref = max(abs(want["rows"][p]["A_after"] - exact[p]) / exact[p] for p in exact)
    print(f"{dataset} A_after, largest relative distance from the f64 merge: port {port:.3e},"
          f" reference {ref:.3e} (bound: twice the reference's)")
    assert port <= 2 * ref
    assert got["claims"] == {k: bool(v) for k, v in want["claims"].items()}
    assert all(got["claims"].values())


def test_ablation_hidden_matches_reference():
    got = torch_ablation_hidden.run(widths=(16, 32), device="cpu", trainer=RefTrainer())
    want = ref_ablation.run(widths=(16, 32))
    for g, w in zip(got, want, strict=True):
        assert (g["n_hidden"], g["payload_bytes"]) == (w["n_hidden"], w["payload_bytes"])
        assert abs(g["auc"] - w["auc"]) <= 1e-3, (g, w)
    assert (got[-1]["auc"] >= got[0]["auc"] - 0.05) == (want[-1]["auc"] >= want[0]["auc"] - 0.05)


def _ref_fit(key, cfg, xa, xb, *, fedavg, device=None):
    """The seam's BP-NN: the reference's pooled training from the
    reference's key, handed over as arrays."""
    assert not fedavg
    params = ref_train_bpnn(jax.random.PRNGKey(key), RefBPNNConfig(*cfg),
                            jnp.asarray(np.concatenate([xa, xb])))
    return bpnn_params_from_numpy(jax.tree.map(np.asarray, params), device=device)


@pytest.fixture(scope="module")
def sub_grid():
    """A 2×2 sub-grid of har at 60 samples a class: the devices train on
    sitting and laying, and walking stays anomalous at evaluation. At this
    size the har config's Ñ = 128 boots on fewer rows than Ñ, where the
    reference's own merges give non-finite scores; the grid runs at
    ``tests/test_torch_pair_eval.py``'s Ñ = 32."""
    ds = normalized_dataset("har", samples_per_class=60)
    train, test = train_test_split(ds, 0.8, seed=0)
    return class_subset(train, [3, 5]), class_subset(test, [3, 5, 0])


def test_rocauc_sub_grid_matches_reference(sub_grid):
    train, test = sub_grid
    ecfg = EdgeConfig("har", 561, 32, "identity")
    before, after = torch_rocauc_grid.oselm_grids(train, test, ecfg, trials=1, device="cpu",
                                                  trainer=RefTrainer())
    ref_before, ref_after = ref_rocauc.oselm_grids(
        train, test, RefEdgeConfig(*ecfg.__dict__.values()), trials=1)
    assert before.shape == after.shape == (2, 2)
    np.testing.assert_allclose(before, ref_before, rtol=0, atol=1e-3)
    np.testing.assert_allclose(after, ref_after, rtol=0, atol=1e-3)
    bp = torch_rocauc_grid.bpnn_grid(train, test, lambda f: bpnn3_config(f, 256, batch=8, epochs=4),
                                     trials=1, device="cpu", fit=_ref_fit)
    ref_bp = ref_rocauc.bpnn_grid(train, test,
                                  lambda f: ref_bpnn3_config(f, 256, batch=8, epochs=4), trials=1)
    np.testing.assert_allclose(bp, ref_bp, rtol=0, atol=1e-3)
    got = torch_rocauc_grid.claims({"avg_before": before.mean(), "avg_after": after.mean(),
                                    "avg_bpnn3": bp.mean()})
    lift = ref_after.mean() - ref_before.mean()
    print(f"2×2 grid: port lift {got['lift']:.4f}, reference {lift:.4f}")
    assert got["lifted"] == bool(lift > 0.03)
    assert got["near_bp"] == bool(abs(ref_after.mean() - ref_bp.mean()) < 0.12)


def test_rocauc_own_baselines_run_on_the_cpu(sub_grid):
    """The port's own BP-NN3 and BP-NN3-FL fits on the sub-grid: finite
    AUCs in [0, 1]."""
    train, test = sub_grid
    for fedavg, epochs in ((False, 4), (True, 1)):
        grid = torch_rocauc_grid.bpnn_grid(
            train, test, lambda f, e=epochs: bpnn3_config(f, 32, batch=8, epochs=e),
            trials=1, fedavg=fedavg, device="cpu")
        assert grid.shape == (2, 2) and np.all((grid >= 0) & (grid <= 1))


def test_kernel_bench_prints_its_four_lines():
    lines = torch_kernel_bench.main(["--device", "cpu"])
    rows = [line for line in lines if not line.startswith("#")]
    assert [r.split(",")[0] for r in rows] == [
        "kernel/hidden_proj", "kernel/uv_accum", "kernel/rank1_add", "kernel/oselm_step_fused"]
    for r in rows:
        name, us, derived = r.split(",")
        assert float(us) > 0
        fields = dict(kv.split("=") for kv in derived.split(";"))
        assert set(fields) == {"plain_rel", "gflops", "lib_us", "lib_gflops"}
        assert float(fields["plain_rel"]) == 0.0  # on the CPU the kernel is its plain version


def test_run_refuses_an_unknown_benchmark(capsys):
    with pytest.raises(SystemExit) as err:
        torch_run.main(["--only", "kernel_bench", "--device", "cpu"])
    assert err.value.code == 2
    assert "unknown benchmark" in capsys.readouterr().err


def test_run_records_a_history_entry(tmp_path, capsys):
    history = tmp_path / "history.jsonl"
    torch_run.main(["--only", "torch_kernel_bench", "--device", "cpu",
                    "--history", str(history), "--check-regression"])
    out = capsys.readouterr().out
    assert "kernel/oselm_step_fused," in out and "# torch_kernel_bench ok" in out
    entries = [json.loads(line) for line in history.read_text().splitlines()]
    assert [e["bench"] for e in entries] == ["run.torch_kernel_bench"]
    assert entries[0]["backend"] == "cpu"
    assert "kernel/hidden_proj_us" in entries[0]["metrics"]
