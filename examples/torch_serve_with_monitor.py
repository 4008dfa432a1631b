"""End-to-end serving demo on the PyTorch/CUDA port: batched requests
against a reduced architecture with the paper's OS-ELM request monitor.

Prefill a batch of prompts, decode N tokens with the KV and SSM caches,
and score every request's pooled features with an OS-ELM autoencoder
trained on in-distribution features; out-of-distribution prompts (the
same prompts with a permuted vocabulary) are scored beside them.

    PYTHONPATH=src python examples/torch_serve_with_monitor.py [--arch hymba-1.5b] [--device cpu]

It runs on the CUDA card by default (the prefill's attention and mamba
heads through the flash-attention and GLA kernels); ``--device cpu`` runs
the kernels' plain PyTorch versions instead.
"""
import argparse
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import ae_score, ae_train_stream, init_autoencoder
from repro_torch.launch.serve import serve_prompts
from repro_torch.models import decode_step, init_params, prefill


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    params = init_params(torch.Generator(device=device).manual_seed(0), cfg, device=device)
    b, s = args.batch, args.prompt_len
    max_seq = s + args.new_tokens
    _, (prompt,) = serve_prompts(cfg.vocab, rounds=1, batch=b, prompt_len=s, drift_round=-1,
                                 seed=0)
    prompts = torch.as_tensor(prompt, device=device)

    t0 = time.perf_counter()
    logits, caches, features = prefill(params, cfg, prompts, cache_len=max_seq)
    _sync(device)
    print(f"prefill {b}×{s}: {time.perf_counter() - t0:.2f}s")

    # the paper's monitor: train the detector on in-distribution features
    det = init_autoencoder(torch.Generator().manual_seed(7), cfg.d_model, cfg.detector_hidden,
                           features.repeat(16, 1), activation="identity", ridge=1e-2,
                           device=device)
    det = ae_train_stream(det, features.repeat(8, 1))

    tok = logits.argmax(-1)
    generated = [tok]
    t0 = time.perf_counter()
    for i in range(args.new_tokens):
        logits, caches = decode_step(params, cfg, tok, caches, s + i, max_seq=max_seq)
        tok = logits.argmax(-1)
        generated.append(tok)
    _sync(device)
    dt = time.perf_counter() - t0
    print(f"decoded {args.new_tokens} tokens × {b} reqs: "
          f"{dt:.2f}s ({args.new_tokens * b / dt:.1f} tok/s)")

    in_dist = float(ae_score(det, features).mean())
    _, _, odd_features = prefill(params, cfg, (prompts * 31 + 17) % cfg.vocab, cache_len=max_seq)
    out_dist = float(ae_score(det, odd_features).mean())
    print(f"monitor score — in-dist requests: {in_dist:.4f}, shifted requests: {out_dist:.4f}")
    toks = torch.stack(generated, 1).cpu().numpy()
    print(f"sample continuation (req 0): {toks[0][:10].tolist()}")


if __name__ == "__main__":
    main()
