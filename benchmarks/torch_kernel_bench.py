"""Micro-bench of the device path's core kernels on the card (the PyTorch
counterpart of ``benchmarks/kernel_bench.py``, at its shapes): each
kernel's µs a call beside the one library call, or the run of library
calls, that computes the same function.

- ``kernel/hidden_proj``: G(x·α + b), 256×561 · 561×128, sigmoid, against
  ``torch.addmm`` then ``torch.sigmoid``;
- ``kernel/uv_accum``: U = HᵀH at 512×128 (``matmul_atb``), against
  ``torch.mm``;
- ``kernel/rank1_add``: P + s·u·uᵀ on a 128×128 P, against ``torch.addr``;
- ``kernel/oselm_step_fused``: one k=1 step at the har width (561
  features, Ñ = 128, sigmoid; ``hidden_proj``, ``matmul_atb`` and the
  one-launch tail ``k1_update``), against the step in library calls whose
  two rank-1 updates are two ``torch.addr``.

Each kernel is first held to its plain PyTorch version at the bounds of
``tests/test_torch_gpu.py`` (the GEMMs at 1e-6 of the product's scale,
``rank1_add`` bit for bit, the step at 1e-5). Times are medians of
CUDA-event spans (``torch_common.timed_ms``) with TF32 off; GFLOP/s are
the operations the shapes need over that time.

    python benchmarks/torch_kernel_bench.py [--device cpu]

``--device cpu`` is a rehearsal: the kernels' plain versions run, and the
times are the host's, not the card's.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from benchmarks.torch_common import bench_device, timed_ms, where_line  # noqa: E402
from repro_torch.core import init_oselm, init_slfn  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    hidden_proj,
    hidden_proj_plain,
    matmul_atb,
    matmul_atb_plain,
    oselm_step_k1_kernel,
    oselm_step_k1_plain,
    rank1_add,
    rank1_add_plain,
)

GEMM_TOL = 1e-6   # max |kernel − plain| over the product's scale
STEP_TOL = 1e-5   # the k=1 step's P and β, max |kernel − plain| / max |plain|


def _rel(got: torch.Tensor, want: torch.Tensor, scale: torch.Tensor | None = None) -> float:
    assert bool(torch.isfinite(got).all()), "non-finite kernel output"
    scale = want if scale is None else scale
    return float((got - want).abs().max() / scale.abs().max())


def _gflops(flops: float, us: float) -> float:
    return flops / (us * 1e-6) / 1e9


def _library_step(state, x):
    """One k=1 step in library calls, in the kernels' order (β updated with
    the old P's ph/denom)."""
    h = torch.sigmoid(torch.addmm(state.params.bias, x[None, :], state.params.alpha))[0]
    ph = torch.mv(state.p, h)
    denom = 1.0 + torch.dot(h, ph)
    err = x - h @ state.beta
    return (torch.addr(state.p, ph, ph, alpha=-1.0 / denom),
            torch.addr(state.beta, ph, err, alpha=1.0 / denom))


def run(device: torch.device, seed: int = 0) -> list[dict]:
    g = torch.Generator().manual_seed(seed)
    rows = []

    def row(name, fn, library, flops, err):
        rows.append({"name": name, "err": err, "flops": flops,
                     "us": 1e3 * timed_ms(fn, device), "lib_us": 1e3 * timed_ms(library, device)})

    m, k, n = 256, 561, 128
    x = torch.randn((m, k), generator=g).to(device)
    a = torch.randn((k, n), generator=g).to(device)
    b = torch.randn((n,), generator=g).to(device)
    got = hidden_proj(x, a, b, activation="sigmoid")
    want = hidden_proj_plain(x, a, b, activation="sigmoid")
    err = _rel(got, want, torch.maximum(want.abs().max(), (x @ a + b).abs().max()))
    assert err <= GEMM_TOL, f"hidden_proj disagrees with its plain version ({err:.3e})"
    row("hidden_proj", lambda: hidden_proj(x, a, b, activation="sigmoid"),
        lambda: torch.sigmoid(torch.addmm(b, x, a)), 2 * m * k * n, err)

    h = torch.randn((512, 128), generator=g).to(device)
    err = _rel(matmul_atb(h, h), matmul_atb_plain(h, h))
    assert err <= GEMM_TOL, f"matmul_atb disagrees with its plain version ({err:.3e})"
    row("uv_accum", lambda: matmul_atb(h, h), lambda: torch.mm(h.T, h), 2 * 512 * 128 * 128,
        err)

    p = (torch.eye(128) * 0.5).to(device)
    u = torch.randn((128,), generator=g).to(device)
    assert torch.equal(rank1_add(p, u, u, -0.3), rank1_add_plain(p, u, u, -0.3)), (
        "rank1_add differs from its plain version")
    row("rank1_add", lambda: rank1_add(p, u, u, -0.3),
        lambda: torch.addr(p, u, u, alpha=-0.3), 2 * 128 * 128, 0.0)

    params = init_slfn(g, 561, 128, device=device)
    x0 = torch.randn((256, 561), generator=g).to(device)
    st = init_oselm(params, x0, x0, activation="sigmoid", ridge=1e-3)
    got, want = oselm_step_k1_kernel(st, x0[0], x0[0]), oselm_step_k1_plain(st, x0[0], x0[0])
    err = max(_rel(got.p, want.p), _rel(got.beta, want.beta))
    assert err <= STEP_TOL, f"the k=1 step disagrees with its plain version ({err:.3e})"
    nh, mm = 128, 561
    step_flops = 2 * 561 * nh + 2 * nh * nh + 2 * nh + 2 * nh * mm + 2 * nh * nh + 2 * nh * mm
    row("oselm_step_fused", lambda: oselm_step_k1_kernel(st, x0[0], x0[0]),
        lambda: _library_step(st, x0[0]), step_flops, err)
    return rows


def main(argv=None) -> list[str]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = bench_device(args.device)
    lines = [
        f"kernel/{r['name']},{r['us']:.1f},"
        f"plain_rel={r['err']:.2e};gflops={_gflops(r['flops'], r['us']):.2f};"
        f"lib_us={r['lib_us']:.1f};lib_gflops={_gflops(r['flops'], r['lib_us']):.2f}"
        for r in run(device)
    ]
    return lines + [f"# torch_kernel_bench on {where_line(device)}"]


if __name__ == "__main__":
    for line in main():
        print(line)
