"""The port's mesh-merge benchmark (``benchmarks/torch_mesh_merge.py``)
rehearsed on the CPU: four gloo ranks train on their HAR patterns and one
all-reduce pair merges them; the benchmark asserts the merge within 0.05
of the sequential pairwise merge (the reference's claim) and prints the
reference's CSV line. It is registered in the port's harness."""
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from benchmarks import torch_mesh_merge  # noqa: E402
from benchmarks.torch_run import BENCHES  # noqa: E402

torch.set_num_threads(2)


def test_mesh_merge_bench_on_the_cpu():
    lines = torch_mesh_merge.main(["--device", "cpu"])
    name, us, derived = lines[0].split(",")
    assert name == "mesh_merge/har" and float(us) > 0
    fields = dict(kv.split("=") for kv in derived.split(";"))
    assert fields["devices"] == "4"
    assert float(fields["beta_diff"]) < 0.05
    assert 0 < float(fields["max_pattern_loss"]) < 1
    assert "4 ranks over gloo on cpu" in lines[1]
    assert "torch_mesh_merge" in dict(BENCHES)
