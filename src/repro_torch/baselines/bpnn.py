"""BP-NN autoencoder baselines (paper §5.1.2, Table 3); port of
``repro.baselines.bpnn``.

BP-NN3: a 3-layer (one hidden) autoencoder, ReLU hidden, Sigmoid output,
MSE loss, Adam. BP-NN5: a 5-layer deep autoencoder (three hidden). They
are the backpropagation comparison points for the OS-ELM results and the
local model of the BP-NN3-FL federated baseline. Gradients come from
``torch.autograd``; parameters are a list of {"w", "b"} dicts, as in the
reference.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from repro_torch._device import resolve_device
from repro_torch.core.activations import get_activation
from repro_torch.optim import OptState, adam


class BPNNConfig(NamedTuple):
    n_features: int
    hidden: tuple[int, ...]          # (Ñ1,) for BP-NN3; (Ñ1, Ñ2, Ñ3) for BP-NN5
    g_hidden: str = "relu"
    g_out: str = "sigmoid"
    lr: float = 1e-3
    batch: int = 8
    epochs: int = 20


def bpnn3_config(n_features: int, n1: int, *, batch: int = 8, epochs: int = 20) -> BPNNConfig:
    return BPNNConfig(n_features, (n1,), batch=batch, epochs=epochs)


def bpnn5_config(
    n_features: int, n1: int, n2: int, n3: int, *, batch: int = 8, epochs: int = 20
) -> BPNNConfig:
    return BPNNConfig(n_features, (n1, n2, n3), batch=batch, epochs=epochs)


def init_bpnn(
    generator: torch.Generator, cfg: BPNNConfig, *, device: str | torch.device | None = None
) -> list[dict]:
    """Glorot-normal MLP n → hidden... → n, drawn from ``generator`` (a
    CPU generator, so one seed gives one network on any device), on
    ``device`` (the card unless ``device="cpu"``)."""
    device = resolve_device(device)
    sizes = (cfg.n_features, *cfg.hidden, cfg.n_features)
    params = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((a, b), generator=generator) * (2.0 / (a + b)) ** 0.5
        params.append({"w": w.to(device), "b": torch.zeros(b, device=device)})
    return params


def bpnn_predict(params: Sequence[dict], cfg: BPNNConfig, x: torch.Tensor) -> torch.Tensor:
    g_h, g_o = get_activation(cfg.g_hidden), get_activation(cfg.g_out)
    h = x
    for layer in params[:-1]:
        h = g_h(h @ layer["w"] + layer["b"])
    return g_o(h @ params[-1]["w"] + params[-1]["b"])


def bpnn_loss(params: Sequence[dict], cfg: BPNNConfig, x: torch.Tensor) -> torch.Tensor:
    return torch.mean((x - bpnn_predict(params, cfg, x)) ** 2)


def bpnn_score(params: Sequence[dict], cfg: BPNNConfig, x: torch.Tensor) -> torch.Tensor:
    """Per-sample reconstruction MSE, the anomaly score."""
    return torch.mean((x - bpnn_predict(params, cfg, x)) ** 2, dim=-1)


def bpnn_grads(params: Sequence[dict], cfg: BPNNConfig, x: torch.Tensor) -> list[dict]:
    """∂ bpnn_loss / ∂ params, as a tree of the parameters' shape."""
    leaves = [p.detach().requires_grad_(True) for layer in params for p in layer.values()]
    it = iter(leaves)
    live = [{k: next(it) for k in layer} for layer in params]
    grads = iter(torch.autograd.grad(bpnn_loss(live, cfg, x), leaves))
    return [{k: next(grads) for k in layer} for layer in params]


def _epoch_fn(
    params: list[dict], opt_state: OptState, xb: torch.Tensor, cfg: BPNNConfig
) -> tuple[list[dict], OptState]:
    """One epoch of Adam steps over pre-shuffled batches ``xb`` (nb, batch, n)."""
    opt = adam(cfg.lr)
    for batch in xb:
        params, opt_state = opt.update(bpnn_grads(params, cfg, batch), opt_state, params)
    return params, opt_state


def _permutation(generator: torch.Generator, n: int) -> torch.Tensor:
    return torch.randperm(n, generator=generator)


def train_bpnn(
    generator: torch.Generator,
    cfg: BPNNConfig,
    x_train: torch.Tensor,
    *,
    params: Sequence[dict] | None = None,
    epochs: int | None = None,
) -> list[dict]:
    """Mini-batch Adam training for ``epochs`` (paper: E epochs, batch k),
    on ``x_train``'s device; each epoch's shuffle is drawn from
    ``generator``, and a fresh network too when ``params`` is None."""
    if params is None:
        params = init_bpnn(generator, cfg, device=x_train.device)
    params = list(params)
    opt_state = adam(cfg.lr).init(params)
    n = x_train.shape[0]
    nb = n // cfg.batch
    for _ in range(cfg.epochs if epochs is None else epochs):
        perm = _permutation(generator, n)[: nb * cfg.batch].to(x_train.device)
        params, opt_state = _epoch_fn(params, opt_state,
                                      x_train[perm].reshape(nb, cfg.batch, -1), cfg)
    return params
