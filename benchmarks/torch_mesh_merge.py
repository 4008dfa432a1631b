"""Beyond the paper, on the port: the cooperative model update as a
collective across processes (the PyTorch counterpart of
``benchmarks/mesh_merge.py``), on the card.

N ranks (``repro_torch.launch.mesh.spawn``) each train an OS-ELM
autoencoder on a different HAR pattern (``make_sharded_streams``, one
shared basis); ONE all-reduce pair of (U, V) merges them
(``mesh_federated_train``), the paper's two-device exchange generalised to
N. Asserts that the merge equals the sequential pairwise merge of the same
trained devices on one process (``cooperative_update``) within 0.05 on β,
and times the merge (``mesh_cooperative_update``, host clock to a
synchronisation and a barrier, p50 of 5). On the card every rank shares
card 0 and the collectives go over gloo through pinned host memory; each
rank's ``fleet_ingest`` launches are checked (one, its stream).

    python benchmarks/torch_mesh_merge.py [--device cpu] [--ranks N]
"""
from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks.torch_common import (  # noqa: E402
    bench_device,
    edge_config,
    normalized_dataset,
    where_line,
)

N_HIDDEN, STEPS, SEED = 64, 200, 0


def _devices(device, n_ranks: int, n_hidden: int, steps: int, seed: int):
    """The shared basis, the sharded HAR streams and each rank's Eq. 13
    boot, on ``device``."""
    import torch

    from repro_torch.core import init_oselm, init_slfn
    from repro_torch.data import make_sharded_streams

    ds = normalized_dataset("har", seed=seed)
    streams = make_sharded_streams(ds, n_ranks, steps + 2 * n_hidden, seed=seed)
    params = init_slfn(torch.Generator().manual_seed(seed), ds.n_features, n_hidden,
                       device=device)
    ridge = edge_config("har").ridge
    xs = torch.from_numpy(streams.xs).to(device)
    boots = [init_oselm(params, xs[s, : 2 * n_hidden], xs[s, : 2 * n_hidden],
                        activation="identity", ridge=ridge) for s in range(n_ranks)]
    return ds, xs[:, 2 * n_hidden :].contiguous(), boots, ridge


def _rank(rank: int, n_ranks: int, n_hidden: int, steps: int, seed: int) -> dict:
    """One rank: train its device on its pattern, merge by one all-reduce
    pair, then time the merge alone."""
    import numpy as np
    import torch

    from repro_torch.federated import mesh_cooperative_update, mesh_federated_train
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh()
    bench_device(mesh.device.type)
    _, rest, boots, ridge = _devices(mesh.device, n_ranks, n_hidden, steps, seed)
    reset_launch_counts()
    merged = mesh_federated_train(boots[rank], rest, mesh, ("data",), ridge=ridge)
    launches = launch_counts()
    mesh.reset_stats()
    ms = []
    for i in range(6):
        mesh.barrier()
        t0 = time.perf_counter()
        mesh_cooperative_update(merged, mesh, ("data",), ridge=ridge)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize()
        mesh.barrier()
        if i:  # the first is a warm-up
            ms.append((time.perf_counter() - t0) * 1e3)
    stats = mesh.stats
    return {"beta": merged.beta.cpu().numpy(), "p": merged.p.cpu().numpy(),
            "merge_ms": float(np.median(ms)), "launches": launches,
            "collective_ms": stats.seconds * 1e3 / max(stats.calls, 1),
            "bytes": stats.bytes // max(stats.calls, 1),
            "staged_bytes": stats.staged_bytes // max(stats.calls, 1),
            "backend": mesh.backend}


def run(n_ranks: int = 4, n_hidden: int = N_HIDDEN, steps: int = STEPS, seed: int = SEED, *,
        device=None, rendezvous_dir=None) -> dict:
    import numpy as np
    import torch

    from repro_torch.core import cooperative_update, oselm_loss, oselm_train_sequential, to_uv
    from repro_torch.launch.mesh import spawn

    device = bench_device(device)
    with tempfile.TemporaryDirectory(dir=rendezvous_dir) as rdv:
        results = spawn(_rank, n_ranks, rdv, device=device.type,
                        args=(n_ranks, n_hidden, steps, seed), timeout=600)
    if device.type == "cuda":
        for r, res in enumerate(results):
            assert res["launches"]["fleet_ingest"] == 1, (r, res["launches"])
    for res in results[1:]:
        assert np.array_equal(res["beta"], results[0]["beta"]), "ranks disagree on the merge"

    # the sequential pairwise merge of the same trained devices, on one process
    ds, rest, boots, _ = _devices(device, n_ranks, n_hidden, steps, seed)
    hosts = [oselm_train_sequential(boots[s], rest[s], rest[s]) for s in range(n_ranks)]
    ref = cooperative_update(hosts[0], *[to_uv(s) for s in hosts[1:]])
    diff = float(np.max(np.abs(results[0]["beta"] - ref.beta.cpu().numpy())))

    merged = ref.replace(beta=torch.from_numpy(results[0]["beta"]).to(device),
                         p=torch.from_numpy(results[0]["p"]).to(device))
    losses = {}
    for pat in range(ds.n_classes):
        xp = torch.from_numpy(ds.pattern(pat)[:32]).to(device)
        losses[ds.class_names[pat]] = float(oselm_loss(merged, xp, xp).mean())
    r0 = results[0]
    return {"n_devices": n_ranks, "beta_diff_vs_pairwise": diff, "losses": losses,
            "psum_merge_us": r0["merge_ms"] * 1e3, "collective_ms": r0["collective_ms"],
            "bytes": r0["bytes"], "staged_bytes": r0["staged_bytes"],
            "backend": r0["backend"], "device": device}


def main(argv=None) -> list[str]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--ranks", type=int, default=4)
    args = ap.parse_args(argv)
    r = run(args.ranks, device=args.device)
    assert r["beta_diff_vs_pairwise"] < 0.05, r
    return [
        f"mesh_merge/har,{r['psum_merge_us']:.1f},"
        f"devices={r['n_devices']};beta_diff={r['beta_diff_vs_pairwise']:.2e};"
        f"max_pattern_loss={max(r['losses'].values()):.4f}",
        f"# torch_mesh_merge: {r['n_devices']} ranks over {r['backend']} on "
        f"{where_line(r['device'])}; all-reduce {r['collective_ms']:.3f} ms a call, "
        f"{r['bytes']} bytes, {r['staged_bytes']} bytes staged",
    ]


if __name__ == "__main__":
    for line in main():
        print(line)
