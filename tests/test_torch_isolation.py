"""The port stands alone: no module of ``repro_torch``, nothing in
``chip_smoke.py`` and no port benchmark or example
(``benchmarks/torch_*.py``, ``examples/torch_*.py``) imports JAX or the
JAX package, and the entry points refuse to fall back to the CPU when no
card is present."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"


def _modules():
    for f in sorted(PKG.rglob("*.py")):
        rel = f.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def _forbidden(name: str) -> bool:
    return name == "jax" or name.startswith("jax.") or name == "repro" or name.startswith("repro.")


def test_importing_every_module_loads_no_jax_and_no_reference():
    mods = list(_modules())
    assert "repro_torch.runtime.runtime" in mods
    assert {"repro_torch.launch.steps", "repro_torch.launch.train",
            "repro_torch.optim.optimizers"} <= set(mods)
    code = (
        "import sys, importlib\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "print(','.join(bad))\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "", f"loaded: {res.stdout.strip()}"


@pytest.mark.parametrize("path", ["chip_smoke.py", "tests/torch_mesh_ranks.py", *[
    str(f.relative_to(ROOT)) for f in sorted(PKG.rglob("*.py"))
], *[str(f.relative_to(ROOT)) for f in sorted((ROOT / "benchmarks").glob("torch_*.py"))],
   *[str(f.relative_to(ROOT)) for f in sorted((ROOT / "examples").glob("torch_*.py"))]])
def test_sources_import_no_jax_and_no_reference(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


@pytest.mark.parametrize("path", [
    *[str(f.relative_to(ROOT)) for f in sorted((ROOT / "benchmarks").glob("torch_*.py"))],
    *[str(f.relative_to(ROOT)) for f in sorted((ROOT / "examples").glob("torch_*.py"))]])
def test_benchmarks_and_examples_load_no_jax_and_no_reference(path):
    """Importing a port benchmark or example, and everything it imports in
    turn (the reference's ``benchmarks/history.py`` and
    ``benchmarks/common.py`` import JAX), loads no ``jax`` and no ``repro``
    module."""
    code = (
        "import sys, importlib.util\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "spec = importlib.util.spec_from_file_location("
        f"'module_under_test', {str(ROOT / path)!r})\n"
        "module = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(module)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "print(','.join(bad))\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin"}, cwd=ROOT,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "", f"{path} loaded: {res.stdout.strip()}"


def test_paper_eval_entry_points_raise_without_a_card(monkeypatch):
    """The §5 harness and its example run on the card unless asked for the
    CPU."""
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "examples"))
    import torch_paper_tables

    from benchmarks import torch_paper_eval

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_paper_eval.run_bench()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_paper_eval.eval_scenario("har", torch_paper_eval.SMOKE_SIZES, ("star",))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_paper_tables.main(["--scenario", "har"])


def test_training_entry_points_raise_without_a_card(monkeypatch):
    """A training step's parameters come from ``init_params``, which puts
    them on the card by default, and ``train.main`` runs on the card unless
    ``--device cpu``: without a card both raise before anything is built."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import init_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(torch.Generator().manual_seed(0), get_config("gemma3-1b").reduced())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "gemma3-1b", "--reduced", "--steps", "1"])


def test_entry_points_raise_without_a_card(monkeypatch):
    """With no card and no explicit CPU request the port raises; it
    never carries on on the CPU."""
    from repro_torch.fleet import init_fleet, star
    from repro_torch.runtime import FleetRuntime, RuntimeConfig
    from repro_torch.scenarios import make_scenario, run_scenario

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x0 = np.zeros((3, 8, 6), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_fleet(torch.Generator().manual_seed(0), 3, 6, 4, x0)
    fleet = init_fleet(torch.Generator().manual_seed(0), 3, 6, 4, x0, ridge=1e-3, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FleetRuntime(fleet, RuntimeConfig(topology=star(3)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FleetRuntime(fleet, RuntimeConfig(topology=star(3), payload_precision="int8"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_scenario(make_scenario("har", n_devices=3, ticks=4, samples_per_class=8), "star")


def test_device_path_entry_points_raise_without_a_card(monkeypatch):
    """The single-device path and the baselines: a device, a network or a
    FedAvg run is built on the card unless the caller asks for the CPU."""
    import sys

    from repro_torch.baselines import bpnn3_config, init_bpnn, run_fedavg
    from repro_torch.configs import EDGE_CONFIGS
    from repro_torch.core import init_autoencoder
    from repro_torch.data import make_dataset

    sys.path.insert(0, str(ROOT))
    from benchmarks import torch_latency
    from benchmarks.torch_common import train_edge_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x0 = np.zeros((8, 6), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_autoencoder(torch.Generator(), 6, 4, x0)
    assert init_autoencoder(torch.Generator(), 6, 4, x0, ridge=1e-3, device="cpu").p.shape == (4, 4)
    cfg = bpnn3_config(6, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_bpnn(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_fedavg(torch.Generator(), cfg, [x0])
    ds = make_dataset("har", samples_per_class=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_edge_device(ds, "laying", key=0, ecfg=EDGE_CONFIGS["har"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_latency.main([])


def test_serving_entry_points_raise_without_a_card(monkeypatch):
    """The model and the serving loop are built on the card unless the
    caller asks for the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import main, serve
    from repro_torch.models import init_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("hymba-1.5b").reduced(d_model=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve(cfg, rounds=1, batch=1, prompt_len=8, new_tokens=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--arch", "hymba-1.5b", "--rounds", "1"])
    out = serve(cfg, rounds=1, batch=1, prompt_len=8, new_tokens=1, device="cpu")
    assert len(out) == 1 and out[0].tokens.shape == (1, 2)


def test_serving_example_raises_without_a_card(monkeypatch):
    sys.path.insert(0, str(ROOT / "examples"))
    import torch_serve_with_monitor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_serve_with_monitor.main(["--prompt-len", "8", "--new-tokens", "1"])


def test_fleet_example_raises_without_a_card(monkeypatch):
    """The port's fleet example runs on the card unless asked for the CPU."""
    sys.path.insert(0, str(ROOT / "examples"))
    import torch_fleet_topologies

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_fleet_topologies.main(["--devices", "4", "--steps", "8"])


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Alone in an empty directory, or with no card, the script exits
    non-zero and prints no result line."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    res = subprocess.run([sys.executable, str(alone)], capture_output=True, text=True,
                         cwd=tmp_path, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_mesh_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    """The multi-process helper and the mesh bench start their ranks on the
    card unless asked for the CPU."""
    sys.path.insert(0, str(ROOT))
    from benchmarks import torch_mesh_merge
    from repro_torch.launch.mesh import rank_device, spawn

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spawn(print, 2, tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_mesh_merge.run(2)
    assert rank_device("cpu", 1, 2) == torch.device("cpu")
