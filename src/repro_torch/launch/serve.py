"""Batched serving with the paper's OS-ELM drift monitor; port of the
non-fleet loop of ``repro.launch.serve``.

Each round prefills a batch of prompts, decodes ``new_tokens`` greedy
tokens against the KV and SSM caches, and scores the batch's pooled
features with an OS-ELM autoencoder: ``ae_score`` → ``detector_update``
→ ``oselm_step``. The monitor is warmed up first on two prefills of
in-distribution prompts that the loop never serves, so that round 0 is
scored out of sample. At ``drift_round`` the prompts come from a narrow
slice of the vocabulary, permuted, (p·31 + 17) % vocab, and the score
rises.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
        --rounds 4 --batch 4 --prompt-len 64 --new-tokens 16 [--device cpu]

Prompts come from a numpy generator seeded by ``--seed``, each token
uniform over the vocabulary, as in the reference. The reference's drift
round permutes such a draw, and a permutation of a uniform draw is a
uniform draw, so its drift round changes nothing the monitor could see.
The port folds the drift round's tokens into the first ``DRIFT_VOCAB``
ids before the permutation: the round's requests then use few words, as
a narrow topic does. The weights come from a torch generator on the
serving device, seeded alike; the monitor's basis from a CPU generator
seeded with ``seed + 7``. ``--reduced`` is always on, as in the reference
(its flag is ``store_true`` with ``default=True``); ``serve`` itself runs
any config it is given.

``--telemetry-dir DIR`` (``serve(..., telemetry=sink)``) books each round
into a ``repro_torch.obs.TelemetrySink``: the serve counters (rounds,
tokens, drift flags), the round-time histogram, the drift-score gauge and
a ``serve_round`` span a round in ``DIR/trace.jsonl``; at the end the
exposition goes to ``DIR/exposition.txt`` and one ``telemetry:`` line
sums the run.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import ae_score, ae_train_stream, init_autoencoder, oselm_step
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.models.config import ArchConfig
from repro_torch.obs import TelemetryConfig, TelemetrySink
from repro_torch.runtime import DetectorConfig, detector_update, init_detector

MONITOR = DetectorConfig(alpha=0.7, k_sigma=4.0, warmup=2, patience=1)
MONITOR_SEED_OFFSET = 7   # the monitor's basis: torch.Generator().manual_seed(seed + 7)
WARM_PREFILLS = 2
DRIFT_VOCAB = 128         # the drift round's tokens come from this many ids


class ServeRound(NamedTuple):
    seconds: float           # prefill + decode, host clock ending in a sync
    tokens: np.ndarray       # (B, new_tokens + 1) greedy ids: the prefill's, then each step's
    score: float             # mean ae_score of the round's features
    flagged: bool            # the monitor's drift flag after this round
    prefill_seconds: float
    decode_seconds: float


def serve_prompts(vocab: int, *, rounds: int, batch: int, prompt_len: int, drift_round: int,
                  seed: int) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """(warm-up prompts, one batch per round) from ``np.random.default_rng
    (seed)``, tokens uniform over the vocabulary; the drift round's folded
    into ``DRIFT_VOCAB`` ids, then permuted."""
    rng = np.random.default_rng(seed)

    def draw() -> np.ndarray:
        return rng.integers(0, vocab, (batch, prompt_len))

    warm = [draw() for _ in range(WARM_PREFILLS)]
    per_round = []
    for rnd in range(rounds):
        p = draw()
        if rnd == drift_round:
            p = (p % min(vocab, DRIFT_VOCAB) * 31 + 17) % vocab
        per_round.append(p)
    return warm, per_round


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(
    cfg: ArchConfig,
    *,
    rounds: int = 3,
    batch: int = 4,
    prompt_len: int = 64,
    new_tokens: int = 8,
    drift_round: int = -1,
    seed: int = 0,
    device: str | torch.device | None = None,
    params: dict | None = None,
    telemetry: TelemetrySink | None = None,
) -> list[ServeRound]:
    """Run the serving loop on ``device`` (the card unless ``device="cpu"``)
    and print the reference's line per round. ``drift_round`` < 0 means the
    last round. ``params`` defaults to weights drawn from ``seed``.
    ``telemetry`` books every round into that sink."""
    if rounds < 1 or batch < 1:
        raise ValueError(f"need rounds >= 1 and batch >= 1, got {rounds} and {batch}")
    device = resolve_device(device)
    if params is None:
        params = init_params(torch.Generator(device=device).manual_seed(seed), cfg, device=device)
    b, s = batch, prompt_len
    max_seq = s + new_tokens
    drift_round = drift_round if drift_round >= 0 else rounds - 1
    warm, prompts = serve_prompts(cfg.vocab, rounds=rounds, batch=b, prompt_len=s,
                                  drift_round=drift_round, seed=seed)

    def ids(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.long, device=device)

    warm_feats = torch.cat([prefill(params, cfg, ids(w), cache_len=max_seq)[2] for w in warm])
    reps = 2 * cfg.detector_hidden // warm_feats.shape[0] + 1
    detector = init_autoencoder(
        torch.Generator().manual_seed(seed + MONITOR_SEED_OFFSET), cfg.d_model,
        cfg.detector_hidden, warm_feats.repeat(reps, 1), activation="identity", ridge=1e-2,
        device=device,
    )
    detector = ae_train_stream(detector, warm_feats)
    monitor = init_detector(1, device=device)
    if telemetry is not None:
        r = telemetry.registry
        rounds_total = r.counter("serve_rounds_total", "serving rounds completed")
        round_seconds = r.histogram("serve_round_seconds", "wall-clock per serving round")
        tokens_total = r.counter("serve_tokens_total", "tokens decoded")
        drift_score = r.gauge("serve_drift_score", "monitor's latest mean ae_score")
        drift_flags = r.counter("serve_drift_flags_total", "rounds the monitor flagged")

    out = []
    for rnd, prompt in enumerate(prompts):
        tokens = ids(prompt)
        _sync(device)
        span = (contextlib.nullcontext() if telemetry is None
                else telemetry.span("serve_round", round=rnd))
        with span:
            t0 = time.perf_counter()
            logits, caches, features = prefill(params, cfg, tokens, cache_len=max_seq)
            tok = logits.argmax(-1)
            _sync(device)
            t1 = time.perf_counter()
            generated = [tok]
            for i in range(new_tokens):
                logits, caches = decode_step(params, cfg, tok, caches, s + i, max_seq=max_seq)
                tok = logits.argmax(-1)
                generated.append(tok)
            _sync(device)
            t2 = time.perf_counter()
        dt = t2 - t0

        # every round is scored against the current detector, which then trains on it
        score = float(ae_score(detector, features).mean())
        monitor, flagged, _ = detector_update(
            monitor, torch.tensor([score], dtype=torch.float32, device=device), MONITOR)
        detector = oselm_step(detector, features, features)
        flagged = bool(flagged[0])
        if telemetry is not None:
            rounds_total.inc()
            round_seconds.observe(dt)
            tokens_total.inc(b * new_tokens)
            drift_score.set(score)
            if flagged:
                drift_flags.inc()
        flag = "  << DRIFT" if rnd == drift_round else ""
        if flagged:
            flag += "  [DETECTED]"
        print(f"round {rnd}: {b} reqs × {new_tokens} tok in {dt:.2f}s "
              f"({b * new_tokens / dt:.1f} tok/s) drift_score={score:.5f}{flag}")
        out.append(ServeRound(dt, torch.stack(generated, 1).cpu().numpy(), score, flagged,
                              t1 - t0, t2 - t1))
    return out


def main(argv: list[str] | None = None) -> list[ServeRound]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--drift-round", type=int, default=-1,
                    help="inject a shifted-distribution batch at this round")
    ap.add_argument("--seed", type=int, default=0,
                    help="base seed (prompts, params, the monitor's basis)")
    ap.add_argument("--telemetry-dir", default=None,
                    help="emit trace.jsonl/exposition.txt into this directory")
    ap.add_argument("--fleet", action="store_true",
                    help="not ported yet (ROADMAP queue 1, item 6: serving)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.fleet:
        raise NotImplementedError("--fleet (the async fleet-ingress driver) is not ported yet: "
                                  "ROADMAP queue 1, item 6 (serving)")
    if args.rounds < 1:
        ap.error(f"--rounds must be >= 1 (got {args.rounds}): a zero-round serving loop does "
                 "nothing")
    if args.batch < 1:
        ap.error(f"--batch must be >= 1 (got {args.batch}): every round serves at least one "
                 "request")
    sink = (TelemetrySink(TelemetryConfig(dir=args.telemetry_dir))
            if args.telemetry_dir else None)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    out = serve(cfg, rounds=args.rounds, batch=args.batch, prompt_len=args.prompt_len,
                new_tokens=args.new_tokens, drift_round=args.drift_round, seed=args.seed,
                device=args.device, telemetry=sink)
    if sink is not None:
        sink.close()
        r = sink.registry
        print("telemetry:", json.dumps({
            "dir": args.telemetry_dir,
            "rounds": int(r.counter("serve_rounds_total").value),
            "tokens": int(r.counter("serve_tokens_total").value),
            "drift_flags": int(r.counter("serve_drift_flags_total").value),
        }))
    return out


if __name__ == "__main__":
    main()
