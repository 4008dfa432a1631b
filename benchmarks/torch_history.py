"""Benchmark trajectory of the port: an append-only JSONL history and a
regression gate (the PyTorch counterpart of ``benchmarks/history.py``).

Every run appends one summary line per benchmark to
``BENCH_torch_history.jsonl`` ({bench, timestamp, backend, metrics}).
The backend is the card's name (``torch.cuda.get_device_name``) when the
run was on a CUDA device, else ``cpu``, so a CPU rehearsal never serves
as the card's baseline, nor one card's as another's.

``check_regression`` compares a fresh set of gated metrics against the
most recent prior entry of the same benchmark on the same backend: keys
ending in ``_us`` are wall-clocks (lower is better — fail on a slowdown
of more than ``threshold``) and keys ending in ``_ratio`` are efficiency
ratios such as the comm-vs-FedAvg factor (higher is better — fail on a
shrink of more than ``threshold``). The first run of a benchmark seeds
the baseline; a metric that disappears or appears is ignored.
"""
from __future__ import annotations

import json
import time
from pathlib import Path

import torch

DEFAULT_PATH = "BENCH_torch_history.jsonl"
DEFAULT_THRESHOLD = 0.25  # fail on a wall-clock regression past 25 %


def backend_of(device: str | torch.device) -> str:
    """The history's backend key: the card's name, or ``cpu``."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def _load_last(path: str | Path, bench: str, backend: str) -> dict | None:
    """The most recent prior entry of (bench, backend) usable as a
    baseline, or None. Entries of a failing gate carry ``"regressed":
    true`` and are skipped, so that a regression never becomes the next
    run's baseline."""
    p = Path(path)
    if not p.exists():
        return None
    last = None
    for line in p.read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            entry = json.loads(line)
        except json.JSONDecodeError:
            continue  # a torn write must not wedge every later run
        if (entry.get("bench") == bench and entry.get("backend") == backend
                and not entry.get("regressed", False)):
            last = entry
    return last


def record(
    bench: str,
    metrics: dict[str, float],
    *,
    backend: str,
    path: str | Path = DEFAULT_PATH,
    regressed: bool = False,
) -> dict | None:
    """Append one history line; returns the previous baseline entry of
    (bench, backend), or None when this run seeds it."""
    prev = _load_last(path, bench, backend)
    entry = {
        "bench": bench,
        "timestamp": time.time(),
        "backend": backend,
        "metrics": {k: float(v) for k, v in metrics.items()},
    }
    if regressed:
        entry["regressed"] = True
    with open(path, "a") as fh:
        fh.write(json.dumps(entry) + "\n")
    return prev


def check_regression(
    prev: dict | None,
    metrics: dict[str, float],
    *,
    threshold: float = DEFAULT_THRESHOLD,
) -> list[str]:
    """One line per metric that regressed against ``prev``; empty when
    none did (and when ``prev`` is None)."""
    if prev is None:
        return []
    failures = []
    for key, new_val in metrics.items():
        old_val = prev.get("metrics", {}).get(key)
        if old_val is None or old_val <= 0:
            continue
        ratio = float(new_val) / float(old_val)
        if key.endswith("_us") and ratio > 1.0 + threshold:
            failures.append(
                f"{key}: {old_val:.1f}us -> {float(new_val):.1f}us "
                f"({(ratio - 1.0) * 100:.0f}% slower, limit {threshold * 100:.0f}%)"
            )
        elif key.endswith("_ratio") and ratio < 1.0 - threshold:
            failures.append(
                f"{key}: {old_val:.1f}x -> {float(new_val):.1f}x "
                f"({(1.0 - ratio) * 100:.0f}% smaller, limit {threshold * 100:.0f}%)"
            )
    return failures


def record_and_gate(
    bench: str,
    metrics: dict[str, float],
    *,
    backend: str,
    path: str | Path = DEFAULT_PATH,
    threshold: float = DEFAULT_THRESHOLD,
) -> None:
    """Append to the history and raise if a metric regressed past
    ``threshold`` against the previous baseline of the same backend. The
    fresh numbers are kept even when the gate fires, marked ``regressed``
    so that they never become a baseline themselves."""
    prev = _load_last(path, bench, backend)
    failures = check_regression(prev, metrics, threshold=threshold)
    record(bench, metrics, backend=backend, path=path, regressed=bool(failures))
    if failures:
        raise AssertionError(
            f"{bench}: regression against the previous history entry — " + "; ".join(failures)
        )
