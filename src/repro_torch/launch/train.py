"""End-to-end training driver; port of ``repro.launch.train``.

Trains a (reduced or full) architecture on synthetic token streams with
the paper's OS-ELM representation monitor attached: every step the
feature tap feeds each rank's OS-ELM autoencoder, and every
``--merge-every`` steps the one-shot cooperative model update (one
all-reduce) synchronizes them, so the drift score comes along for free.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b --reduced \\
        --steps 100 --batch 8 --seq 128 --device cpu

It runs on the card unless ``--device cpu``. ``--ranks`` ranks (one by
default) run through ``repro_torch.launch.mesh.spawn``: ``nccl`` for one
rank on the card, ``gloo`` for ranks sharing it or on the CPU. Each rank
takes its block of every global batch; the gradients are averaged over
the ranks (``launch.steps.make_train_step(mesh=)``), so every rank holds
the same parameters. The weights come from seed 0 on every rank;
``torch.Generator`` cannot reproduce the reference's threefry streams, so
the parameters and the tokens differ from the reference's (its tests hand
the reference's over as numpy arrays). Rank 0 saves ``{"params", "opt"}``
every 25 steps with ``--ckpt-dir``. As the reference's, the run fails
unless the loss at the last step is below the first's. ``main`` returns
rank 0's record: the losses, drift scores and step seconds, the launch
counts of the whole rank (``init_oselm``'s kernels included), the peak
device memory (None on the CPU) and the f64 sum of each parameter leaf at
the end.
"""
from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch

__all__ = ["DRIFT_FROM", "main", "synthetic_batch"]

DRIFT_FROM = 0.7   # from this share of the steps on, the vocabulary shifts


def synthetic_batch(generator: torch.Generator, vocab: int, batch: int, seq: int, step: int,
                    *, device=None) -> dict:
    """Markov-ish tokens (B, S) and labels (B, S): uniform tokens where every
    other one repeats the one before it (a learnable bigram), so the loss
    falls. ``generator`` is seeded with ``step`` here (the reference folds the
    step into its key); its device draws the tokens."""
    generator.manual_seed(step)
    base = torch.randint(0, vocab, (batch, seq + 1), generator=generator,
                         device=generator.device)
    rep = torch.repeat_interleave(base[:, ::2], 2, dim=1)[:, : seq + 1]
    even = torch.arange(seq + 1, device=base.device) % 2 == 0
    tokens = torch.where(even, base, rep).to(device)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--merge-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="the card (the default) or the CPU")
    ap.add_argument("--ranks", type=int, default=1, help="processes, each a block of the batch")
    return ap


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_rank(rank: int, opts: dict) -> dict:
    """One rank's run (``spawn`` calls it); returns its record as Python and
    numpy values."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core import init_oselm, init_slfn, oselm_loss
    from repro_torch.federated.mesh_federation import mesh_cooperative_update
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import data_axes, make_host_mesh
    from repro_torch.launch.steps import make_detector_step, make_optimizer, make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import tree_leaves

    mesh = make_host_mesh()
    dp = data_axes(mesh)
    device = mesh.device
    cfg = get_config(opts["arch"])
    if opts["reduced"]:
        cfg = cfg.reduced()
    steps, merge_every = opts["steps"], opts["merge_every"]
    if rank == 0:
        print(f"arch={cfg.name} ranks={mesh.size(dp)} mesh={mesh.shape} device={device}",
              flush=True)
    reset_launch_counts()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    draw = torch.Generator(device=device)
    params = init_params(draw.manual_seed(0), cfg, device=device)
    opt = make_optimizer(cfg, lr=opts["lr"])
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt, mesh=mesh, axes=dp)

    # the paper's detector: one OS-ELM autoencoder a rank
    det_hidden = cfg.detector_hidden
    slfn = init_slfn(torch.Generator().manual_seed(7), cfg.d_model, det_hidden, device=device)
    warm = torch.randn((2 * det_hidden, cfg.d_model), generator=torch.Generator().manual_seed(8))
    det = init_oselm(slfn, warm.to(device), warm.to(device), activation="identity", ridge=1e-2)
    det_step = make_detector_step(mesh, dp, merge=False)

    ckpt = CheckpointManager(opts["ckpt_dir"]) if opts["ckpt_dir"] and rank == 0 else None
    lo, hi = mesh.block(opts["batch"], dp, what="batch")
    losses, drifts, step_s = [], [], []
    for step in range(steps):
        batch = synthetic_batch(draw, cfg.vocab, opts["batch"], opts["seq"], step, device=device)
        if step >= int(steps * DRIFT_FROM):  # concept drift: a vocabulary shift
            batch = {k: (t * 7 + 3) % cfg.vocab for k, t in batch.items()}
        batch = {k: t[lo:hi] for k, t in batch.items()}
        _sync(device)
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)

        feats = metrics["features"]                      # (B / ranks, D)
        drift = oselm_loss(det, feats, feats).mean()
        drifts.append(float(mesh.all_reduce(drift, dp)) / mesh.size(dp))
        det = det_step(det, feats)
        if (step + 1) % merge_every == 0:
            det = mesh_cooperative_update(det, mesh, dp, ridge=1e-2)  # one-shot federated merge
        if rank == 0 and (step % 5 == 0 or step == steps - 1):
            print(f"step {step:4d} loss={loss:.4f} drift_score={drifts[-1]:9.3f} "
                  f"dt={step_s[-1]:.2f}s", flush=True)
        if ckpt and (step + 1) % 25 == 0:
            ckpt.save(step + 1, {"params": params, "opt": opt_state})
    _sync(device)
    assert losses[-1] < losses[0], "training did not reduce loss"
    if rank == 0:
        print(f"final loss {losses[-1]:.4f} (from {losses[0]:.4f})", flush=True)
    return {
        "rank": rank, "device": str(device), "arch": cfg.name, "losses": losses,
        "drifts": drifts, "step_s": step_s, "launches": launch_counts(),
        "peak_bytes": (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
                       else None),
        "param_sums": [float(t.double().sum()) for t in tree_leaves(params)],
    }


def main(argv: list[str] | None = None) -> dict:
    args = _parser().parse_args(argv)
    if args.device is None:
        from repro_torch._device import resolve_device

        resolve_device(None)  # raises without a card
    kind = args.device or "cuda"
    opts = {k: getattr(args, k) for k in ("arch", "reduced", "steps", "batch", "seq",
                                          "merge_every", "ckpt_dir", "lr")}
    if args.steps < 1 or args.ranks < 1 or args.batch % args.ranks:
        raise ValueError(f"need steps >= 1 and a batch ({args.batch}) that splits over "
                         f"{args.ranks} ranks")
    from repro_torch.launch.mesh import spawn

    with tempfile.TemporaryDirectory(prefix="repro-train-") as rendezvous:
        records = spawn(train_rank, args.ranks, rendezvous, device=kind, args=(opts,),
                        timeout=3600.0)
    for r in records[1:]:
        np.testing.assert_array_equal(r["losses"], records[0]["losses"])
    return records[0]


if __name__ == "__main__":
    main()
