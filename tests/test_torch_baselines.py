"""The port's BP-NN baselines, Adam and FedAvg against the reference on
the CPU, from the reference's initial parameters and on the same
pre-shuffled batches (the port's generators cannot repeat jax.random, so
the test draws the shuffles and hands them to both).

Bounds: the forward pass, loss and score at rtol 1e-5 (one f32 matmul
chain in each framework); one epoch of Adam and one FedAvg round at rtol
1e-5 / atol 2e-7 (autograd and jax.grad order the backward sums
differently, and Adam divides each gradient by its own running scale, so
a last-bit difference in a gradient moves its step; measured: at most
6.0e-8 absolute on BP-NN5's epoch); ``average_params`` bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.baselines import bpnn3_config, bpnn5_config, bpnn_loss, bpnn_predict, bpnn_score
from repro.baselines import init_bpnn as ref_init_bpnn
from repro.baselines.bpnn import _epoch_fn as ref_epoch_fn
from repro.baselines.fedavg import average_params as ref_average_params
from repro.baselines.fedavg import fedavg_round as ref_fedavg_round
from repro.optim import adam as ref_adam
from repro.scenarios.evaluate import bpnn_auc as ref_bpnn_auc
from repro_torch import baselines as tb
from repro_torch.baselines import bpnn as tbpnn
from repro_torch.convert import bpnn_params_from_numpy
from repro_torch.optim import adam
from repro_torch.scenarios import bpnn_auc

torch.set_num_threads(2)

N_FEAT = 24
CONFIGS = {"bpnn3": bpnn3_config(N_FEAT, 8, batch=4),
           "bpnn5": bpnn5_config(N_FEAT, 16, 8, 16, batch=4)}


def _data(seed, n=40):
    return np.random.default_rng(seed).uniform(0, 1, (n, N_FEAT)).astype(np.float32)


def _params(name, seed=0):
    ref = ref_init_bpnn(jax.random.PRNGKey(seed), CONFIGS[name])
    return ref, bpnn_params_from_numpy(jax.tree.map(np.asarray, ref), device="cpu")


def _close_tree(got, want, *, rtol, atol):
    for gl, wl in zip(got, want):
        for k in ("w", "b"):
            np.testing.assert_allclose(gl[k].detach().numpy(), np.asarray(wl[k]),
                                       rtol=rtol, atol=atol)


def _cfg(name):
    # the port's config type, with the reference's values
    return tb.BPNNConfig(*CONFIGS[name])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_loss_and_score_match_reference(name):
    ref, got = _params(name)
    x = _data(1)
    cfg = _cfg(name)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(tb.bpnn_predict(got, cfg, xt).numpy(),
                               np.asarray(bpnn_predict(ref, CONFIGS[name], jnp.asarray(x))),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(tb.bpnn_loss(got, cfg, xt)),
                               float(bpnn_loss(ref, CONFIGS[name], jnp.asarray(x))), rtol=1e-5)
    np.testing.assert_allclose(tb.bpnn_score(got, cfg, xt).numpy(),
                               np.asarray(bpnn_score(ref, CONFIGS[name], jnp.asarray(x))),
                               rtol=1e-5, atol=1e-7)


def test_adam_update_matches_reference():
    ref, got = _params("bpnn3")
    grads = [{k: np.random.default_rng(i).standard_normal(np.shape(v)).astype(np.float32)
              for k, v in layer.items()} for i, layer in enumerate(ref)]
    ropt, topt = ref_adam(1e-3), adam(1e-3)
    rs, ts = ropt.init(ref), topt.init(got)
    for _ in range(3):
        ref, rs = ropt.update(jax.tree.map(jnp.asarray, grads), rs, ref)
        got, ts = topt.update(bpnn_params_from_numpy(grads, device="cpu"), ts, got)
    _close_tree(got, ref, rtol=1e-6, atol=1e-7)
    assert ts.step == int(rs.step) == 3


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_one_epoch_of_adam_matches_reference(name):
    ref, got = _params(name, seed=2)
    x = _data(3)
    cfg = CONFIGS[name]
    perm = np.random.default_rng(4).permutation(len(x))
    nb = len(x) // cfg.batch
    xb = x[perm[: nb * cfg.batch]].reshape(nb, cfg.batch, -1)
    want, _ = ref_epoch_fn(ref, ref_adam(cfg.lr).init(ref), jnp.asarray(xb), cfg)
    out, state = tbpnn._epoch_fn(got, adam(cfg.lr).init(got), torch.from_numpy(xb), _cfg(name))
    assert state.step == nb
    _close_tree(out, want, rtol=1e-5, atol=2e-7)


def _reference_shuffles(key, n_clients, n, local_epochs):
    """The permutations the reference's fedavg_round draws, in order."""
    perms = []
    for _ in range(n_clients):
        key, k = jax.random.split(key)
        for _ in range(local_epochs):
            k, k2 = jax.random.split(k)
            perms.append(torch.from_numpy(np.array(jax.random.permutation(k2, n))))
    return perms


def test_average_params_and_one_fedavg_round_match_reference(monkeypatch):
    ref, got = _params("bpnn3", seed=5)
    cfg = CONFIGS["bpnn3"]
    clients = [_data(6), _data(7)]
    key = jax.random.PRNGKey(8)
    want, _ = ref_fedavg_round(key, ref, cfg, [jnp.asarray(c) for c in clients], 2)
    perms = _reference_shuffles(key, 2, 40, 2)
    monkeypatch.setattr(tbpnn, "_permutation", lambda generator, n: perms.pop(0))
    out = tb.fedavg_round(torch.Generator(), got, _cfg("bpnn3"),
                          [torch.from_numpy(c) for c in clients], 2)
    assert not perms
    _close_tree(out, want, rtol=1e-5, atol=2e-7)
    a, b = _params("bpnn3", seed=9)[0], _params("bpnn3", seed=10)[0]
    avg = tb.average_params([bpnn_params_from_numpy(jax.tree.map(np.asarray, t), device="cpu")
                             for t in (a, b)])
    _close_tree(avg, ref_average_params([a, b]), rtol=0, atol=0)


def test_bpnn_auc_and_init_match_reference():
    ref, got = _params("bpnn3", seed=11)
    x = _data(12, n=60)
    y = (np.arange(60) % 5 == 0).astype(np.int32)
    x[y == 1] += 0.5
    assert abs(bpnn_auc(got, _cfg("bpnn3"), x, y)
               - ref_bpnn_auc(ref, CONFIGS["bpnn3"], x, y)) <= 1e-6
    # the port's own initialiser: Glorot-normal weights (checked by
    # distribution, as jax.random cannot be repeated), zero biases
    big = tb.init_bpnn(torch.Generator().manual_seed(0), tb.bpnn3_config(561, 128), device="cpu")
    w = big[0]["w"].numpy()
    assert w.shape == (561, 128) and not big[0]["b"].any()
    assert abs(w.std() - np.sqrt(2.0 / (561 + 128))) < 2e-3 and abs(w.mean()) < 2e-3


def test_run_fedavg_trains_toward_the_clients():
    """R rounds on two clients lower the loss on both."""
    cfg = tb.bpnn3_config(N_FEAT, 8, batch=4)
    clients = [_data(13), _data(14) * 0.5]
    g = torch.Generator().manual_seed(0)
    start = tb.init_bpnn(torch.Generator().manual_seed(0), cfg, device="cpu")
    out = tb.run_fedavg(g, cfg, clients, tb.FedAvgConfig(rounds=5), device="cpu")
    for c in clients:
        xt = torch.from_numpy(c)
        assert float(tb.bpnn_loss(out, cfg, xt)) < float(tb.bpnn_loss(start, cfg, xt))
