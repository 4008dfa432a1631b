"""Shared helpers of the port's benchmarks (the PyTorch counterpart of
``benchmarks/common.py``): the edge configuration and dataset the paper's
device-level figures use, one edge device's training, and a timer that
reads the card's clock.

Run the benchmarks from the root of the checkout, as
``python benchmarks/torch_latency.py`` or
``python -m benchmarks.torch_latency``; they put ``src`` on the path.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import EDGE_CONFIGS, EdgeConfig  # noqa: E402
from repro_torch.core import OSELMState, ae_train_stream, init_autoencoder  # noqa: E402
from repro_torch.data import make_dataset, make_pattern_stream, normalize_minmax  # noqa: E402


def timed_ms(fn, device: torch.device, *, warmup: int = 2, iters: int = 10) -> float:
    """Median milliseconds per call of ``fn``. On a CUDA device each call
    is bracketed by CUDA events and waited for, so the time is the card's
    from the first launch to the last, host enqueue gaps included; on the
    CPU it is the host clock."""
    for _ in range(warmup):
        fn()
    ts = []
    if device.type == "cuda":
        torch.cuda.synchronize()
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def edge_config(dataset: str) -> EdgeConfig:
    return EDGE_CONFIGS[dataset]


def normalized_dataset(name: str, seed: int = 0, samples_per_class: int = 200):
    """Dataset with the shared min-max normalisation convention."""
    return normalize_minmax(make_dataset(name, seed=seed, samples_per_class=samples_per_class))


def train_edge_device(
    ds, pattern, *, key: int, ecfg: EdgeConfig, seed: int = 0, limit: int | None = None,
    device: str | torch.device | None = None,
) -> OSELMState:
    """One edge device trained on one pattern: the Eq. 13 boot on the
    head of its shuffled stream, then k=1 steps over the rest. ``key``
    seeds the basis generator, so devices built with one key share a
    basis and can merge; ``device`` is the card unless ``device="cpu"``."""
    xs = make_pattern_stream(ds, pattern, seed=seed, limit=limit)
    # the boot chunk must hold at least Ñ rows for a well-posed Eq. 13
    # (the ridge guards the rest); never consume the whole stream on it
    n_init = min(max(2 * ecfg.n_hidden, 8), max(len(xs) - 8, len(xs) // 2))
    st = init_autoencoder(
        torch.Generator().manual_seed(key), ds.n_features, ecfg.n_hidden, xs[:n_init],
        activation=ecfg.activation,
        ridge=max(ecfg.ridge, 1e-2 if n_init < 2 * ecfg.n_hidden else ecfg.ridge),
        device=device,
    )
    return ae_train_stream(st, torch.as_tensor(xs[n_init:], device=st.device))
