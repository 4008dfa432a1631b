"""The port stands alone: no module of ``repro_torch`` and nothing in
``chip_smoke.py`` imports JAX or the JAX package, and the entry points
refuse to fall back to the CPU when no card is present."""
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


@pytest.mark.parametrize("path", ["chip_smoke.py", *[
    str(f.relative_to(ROOT)) for f in sorted(PKG.rglob("*.py"))
]])
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


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Alone in an empty directory, or with no card, the script exits
    non-zero and prints no result line."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    res = subprocess.run([sys.executable, str(alone)], capture_output=True, text=True,
                         cwd=tmp_path, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
