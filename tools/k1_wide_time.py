"""Time the k=1 step's tail and the kernels the wide paths touch, on one
CUDA card, from the source tree given. Run from the root of a checkout:

    python3 tools/k1_wide_time.py [--src PATH] [--label NAME] [--out FILE]

``--src`` is the ``src`` directory of the tree to time (by default this
checkout's), so that two trees unpacked side by side are timed by one
script, in turns, in one process each; their kernels build into each
tree's own ``build/kernels``. Timed, on random inputs from a seed, at the
har width (n = m = 561, Ñ = 128) unless said otherwise:

- the k=1 step's tail after ph = P·h: ``k1_update`` where the tree has it,
  else the glue (1 + h·ph, t − h·β, the two reciprocals) and two
  ``rank1_add`` calls, as the tree's step runs them; and two
  ``torch.addr`` calls, the library's two updates;
- 200 k=1 steps (``ae_train_step``): wall time, device time and kernel
  launches a step, from torch.profiler;
- the existing shapes of the kernels this work touches: ``from_uv_solve``
  (S = 1, 32, 256), ``banded_merge_solve`` (D = 256, hops 2),
  ``fleet_ingest`` (D = 256, T = 32), ``quantize_pack`` (D = 256, with a
  residual), ``banded_mix`` (D = 256, hops 2), ``robust_segment_sum_mix``
  (star, D = 256, trim 1) and bf16 ``flash_attention`` (B = 4, S = 512,
  H = 25, hd 64);
- the wide shapes, where the tree takes them (a tree that refuses one says
  so): ``from_uv_solve`` at Ñ = 768 and 1024 (m = 784, S = 1 and 16),
  ``fleet_ingest`` at Ñ = 768 (D = 16, T = 32, n = m = 784) and
  ``quantize_pack`` at Ñ = 768 (D = 16, m = 784).

Each line printed, and appended to ``--out``, is one JSON object: the
label, the card's name and power limit as ``nvidia-smi`` gives them, what
was timed, ``events_ms`` (CUDA events around the call, per call) and
``alone_ms`` (torch.profiler's device time of one call, the sum of every
kernel it launches), and for the step ``wall_ms``, ``device_ms`` and
``launches`` a step.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks.torch_device_time import events_ms, profiled  # noqa: E402

SEED = 0
D, N_FEAT, N_HID, HOPS, T, RIDGE = 256, 561, 128, 2, 32, 1e-3
STEPS = 200


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the tree's src directory")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out", default=None, help="a file to append the JSON lines to")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k1_wide_time: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch import kernels as K
    from repro_torch.core import ae_train_step, init_autoencoder
    from repro_torch.fleet import init_fleet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    def emit(what, **numbers):
        line = json.dumps({"label": args.label, "card": smi, "what": what, **numbers})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    def kernel(what, fn, reps):
        try:
            fn()
        except ValueError as e:  # a tree whose kernel does not take this shape
            emit(what, refused=str(e))
            return
        alone, _, by = profiled(fn, reps)
        emit(what, events_ms=events_ms(fn, reps), alone_ms=alone, by_kernel=by)

    # ---- the k=1 step's tail, and 200 steps
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.uniform(0, 1, (4 * N_HID, N_FEAT)).astype(np.float32)).cuda()
    st = init_autoencoder(torch.Generator().manual_seed(SEED), N_FEAT, N_HID, x,
                          activation="identity", ridge=RIDGE, device="cuda")
    h = K.hidden_proj(x[:1], st.params.alpha, st.params.bias, activation="identity")[0]
    ph = K.matmul_atb(h[:, None].contiguous(), st.p)[0]
    t = x[0]
    if hasattr(K, "k1_update"):
        def tail():
            return K.k1_update(st.p, st.beta, h, ph, t)
    else:
        def tail():
            denom = 1.0 + h @ ph
            err = t - h @ st.beta
            return (K.rank1_add(st.p, ph, ph, -1.0 / denom),
                    K.rank1_add(st.beta, ph, err, 1.0 / denom))
    kernel(f"k=1 tail Ñ={N_HID} m={N_FEAT}", tail, 500)
    denom = 1.0 + h @ ph
    err = t - h @ st.beta
    sp, sb = float(-1.0 / denom), float(1.0 / denom)
    kernel(f"torch.addr x2 Ñ={N_HID} m={N_FEAT}",
           lambda: (torch.addr(st.p, ph, ph, alpha=sp), torch.addr(st.beta, ph, err, alpha=sb)),
           500)

    from torch.profiler import ProfilerActivity, profile

    xs = x[:STEPS]
    s = ae_train_step(st, xs[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(STEPS):
            s = ae_train_step(s, xs[i])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    t0 = time.perf_counter()
    for i in range(STEPS):
        s = ae_train_step(s, xs[i])
    torch.cuda.synchronize()
    emit(f"{STEPS} k=1 steps Ñ={N_HID} m={N_FEAT}",
         wall_ms=wall / STEPS, device_ms=sum(e.self_device_time_total for e in events) / 1e3 / STEPS,
         launches=sum(e.count for e in events) / STEPS,
         unprofiled_wall_ms=(time.perf_counter() - t0) * 1e3 / STEPS,
         by_kernel={e.key[:60]: e.count / STEPS for e in events})
    del s, xs

    # ---- the existing shapes
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def spd(s, n, m):
        a = torch.randn((s, n, 3 * n), generator=gen, device="cuda")
        return torch.cat([a @ a.transpose(1, 2) / (3 * n),
                          torch.randn((s, n, m), generator=gen, device="cuda")], dim=2)

    w = spd(D, N_HID, N_FEAT)
    for s in (1, 32, 256):
        ws = w[:s]
        kernel(f"from_uv_solve S={s} Ñ={N_HID} m={N_FEAT}",
               lambda: K.from_uv_solve(ws[:, :, :N_HID], ws[:, :, N_HID:], ridge=RIDGE),
               50 if s < 256 else 10)
    kernel(f"banded_merge_solve D={D} hops={HOPS} Ñ={N_HID}",
           lambda: K.banded_merge_solve(w, HOPS, ridge=RIDGE), 10)
    r = torch.randn(w.shape, generator=gen, device="cuda") * 0.01
    u, v = w[:, :, :N_HID].contiguous(), w[:, :, N_HID:].contiguous()
    kernel(f"quantize_pack D={D} Ñ={N_HID} residual", lambda: K.quantize_pack(u, v, r), 50)
    kernel(f"banded_mix D={D} Ñ={N_HID} hops={HOPS}", lambda: K.banded_mix(w, HOPS), 50)
    mask = (torch.rand(D, generator=gen, device="cuda") < 0.9).to(torch.float32)
    scale = torch.rand(D, generator=gen, device="cuda") * 0.5 + 0.5
    cids = np.zeros(D, np.int32)
    kernel(f"robust_segment_sum_mix star D={D} trim=1",
           lambda: K.robust_segment_sum_mix(w, cids, mask, scale, 1, 1), 50)
    del w, r, u, v
    x_init = torch.rand((D, 2 * N_HID, N_FEAT), generator=gen, device="cuda")
    fleet = init_fleet(torch.Generator().manual_seed(SEED), D, N_FEAT, N_HID, x_init.cpu().numpy(),
                       activation="identity", ridge=RIDGE, device="cuda")
    window = torch.rand((D, T, N_FEAT), generator=gen, device="cuda")
    kernel(f"fleet_ingest D={D} T={T} Ñ={N_HID}", lambda: K.fleet_ingest(fleet, window), 20)
    del fleet, x_init, window
    q, k, vv = (torch.randn((4, 512, 25, 64), generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(3))
    kernel("flash_attention B=4 S=512 H=25 hd=64 bf16 causal",
           lambda: K.flash_attention(q, k, vv, causal=True), 50)
    del q, k, vv

    # ---- the wide shapes
    m = 784
    for n in (768, 1024):
        w = spd(16, n, m)
        for s in (1, 16):
            ws = w[:s]
            kernel(f"from_uv_solve S={s} Ñ={n} m={m}",
                   lambda: K.from_uv_solve(ws[:, :, :n], ws[:, :, n:], ridge=RIDGE), 10)
        del w
    n, d = 768, 16
    w = spd(d, n, m)
    r = torch.randn(w.shape, generator=gen, device="cuda") * 0.01
    u, v = w[:, :, :n].contiguous(), w[:, :, n:].contiguous()
    kernel(f"quantize_pack D={d} Ñ={n} m={m} residual", lambda: K.quantize_pack(u, v, r), 50)
    del w, r, u, v
    x_init = torch.rand((d, 2 * n, m), generator=gen, device="cuda")
    fleet = init_fleet(torch.Generator().manual_seed(SEED), d, m, n, x_init.cpu().numpy(),
                       activation="identity", ridge=RIDGE, device="cuda")
    window = torch.rand((d, T, m), generator=gen, device="cuda")
    kernel(f"fleet_ingest D={d} T={T} Ñ={n} n=m={m}", lambda: K.fleet_ingest(fleet, window), 10)
    return 0


if __name__ == "__main__":
    sys.exit(main())
