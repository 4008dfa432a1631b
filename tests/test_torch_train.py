"""The port's training path against the reference's, on the CPU.

Each input comes from a numpy seed, or from the reference (its weights,
drawn with ``jax.random``, carried over by ``convert.model_params_from_numpy``),
and goes through both packages:

- ``lm_loss``'s value and metrics for every config of ``ARCHS`` at its
  reduced size (two chunks of cross-entropy): the loss and the aux losses
  within 1e-5, ``dropped_frac`` exactly, the features within 1e-4 of their
  largest magnitude;
- its gradients against ``jax.value_and_grad`` for gemma3-1b (S past the
  reduced window: a local and a global layer, so ``local_attention`` by
  autograd and the flash Function), granite-moe-3b-a800m (the aux losses
  through the router), hymba-1.5b and xlstm-1.3b (GLA's and the sLSTM's
  plain versions by autograd): each leaf within 1e-4 of its largest
  |g| (measured up to 1.5e-5; ``-s`` prints it); remat on and off give the
  same gradients bit for bit;
- ``make_train_step``: two steps with one and two micro-batches, with
  ``sgd`` (the parameters' moves held at 1e-4 of each leaf's largest move,
  past the two f32 roundings of p − lr·g at its largest |p|: the moves
  are linear in the gradients) and with ``make_optimizer`` (Adam; its
  first step moves each parameter by ≈ lr·sign(g), so a gradient near 0
  that rounds to the other sign moves it 2·lr: only the loss and the
  gradient norm are held, at 1e-5 and 1e-4);
- ``make_detector_step`` on one gloo rank and on two, through ``spawn``,
  against the reference's single-process ``oselm_step``, ``to_uv`` and
  ``from_uv`` (its ``shard_map`` raises under jax 0.9.0): 1e-4 of each
  output's largest magnitude (the k×k inverse and the Cholesky solves in
  f32, in other orders); in the same ranks, ``make_train_step(mesh=)``
  (each rank its block of the batch, the gradients averaged) against the
  single-process step on the whole batch;
- ``train.main --device cpu`` on reduced gemma3-1b for 25 steps: the loss
  falls, and the checkpoint at step 25 restores bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
import repro.models as rm
from repro.configs import ARCHS as REF_ARCHS
from repro.launch import steps as ref_steps
from repro.optim import sgd as ref_sgd
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import model_params_from_numpy
from repro_torch.launch import steps, train
from repro_torch.launch.mesh import spawn
from repro_torch.models import lm_loss, model
from repro_torch.optim import sgd, tree_leaves

import torch_mesh_ranks

torch.set_num_threads(2)

LOSS_ABS = 1e-5
FEAT_REL = 1e-4
GRAD_REL = 1e-4
B = 2


def _batch(cfg, s: int, seed: int, b: int = B) -> dict:
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.frontend is not None:
        out["frontend"] = rng.standard_normal(
            (b, cfg.n_frontend_tokens, cfg.d_frontend)).astype(np.float32)
    return out


def _pair(name: str, **replace):
    rcfg = dataclasses.replace(REF_ARCHS[name].reduced(), **replace)
    cfg = dataclasses.replace(get_config(name).reduced(), **replace)
    rparams = rm.init_params(jax.random.PRNGKey(0), rcfg)
    return rcfg, cfg, rparams, model_params_from_numpy(jax.tree.map(np.asarray, rparams),
                                                       device="cpu")


def _port_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    scale = np.abs(want).max()
    return float(np.abs(got.detach().float().numpy() - want).max() / (scale if scale else 1.0))


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_lm_loss_matches_reference(name):
    rcfg, cfg, rparams, params = _pair(name)
    batch = _batch(cfg, 32, seed=len(name))
    want_loss, want = jax.jit(lambda p, b: rm.lm_loss(p, rcfg, b["tokens"], b["labels"],
                                                       frontend=b.get("frontend"),
                                                       loss_chunk=16))(rparams, batch)
    t = _port_batch(batch)
    with torch.no_grad():
        loss, got = lm_loss(params, cfg, t["tokens"], t["labels"], frontend=t.get("frontend"),
                            loss_chunk=16)
    assert abs(float(loss) - float(want_loss)) <= LOSS_ABS
    for key in ("ce", "lb_loss", "z_loss"):
        assert abs(float(got[key]) - float(want[key])) <= LOSS_ABS, key
    assert float(got["dropped_frac"]) == float(want["dropped_frac"])
    assert got["features"].dtype == torch.float32 and not got["features"].requires_grad
    assert _rel(got["features"], want["features"]) <= FEAT_REL


GRAD_MODELS = {"gemma3-1b": 96, "granite-moe-3b-a800m": 64, "hymba-1.5b": 96, "xlstm-1.3b": 64}


def _port_grads(params, cfg, t):
    """lm_loss at chunks of 32 and its gradients, as ``steps.loss_and_grads``
    takes them (one leaf a layer, stacked back)."""
    live = steps._live(params)
    loss, _ = lm_loss(live, cfg, t["tokens"], t["labels"], frontend=t.get("frontend"),
                      loss_chunk=32)
    grads = steps._rebuild(params, torch.autograd.grad(loss, tree_leaves(live)), stacked=True)
    return loss.detach(), tree_leaves(grads)


@pytest.mark.parametrize("name", sorted(GRAD_MODELS))
def test_gradients_match_reference(name, monkeypatch):
    rcfg, cfg, rparams, params = _pair(name)
    batch = _batch(cfg, GRAD_MODELS[name], seed=3)
    (want_loss, _), want = jax.jit(jax.value_and_grad(
        lambda p: rm.lm_loss(p, rcfg, batch["tokens"], batch["labels"], loss_chunk=32),
        has_aux=True))(rparams)
    if name == "gemma3-1b":
        assert {"swa", "dense"} <= set(cfg.layer_pattern()) and GRAD_MODELS[name] > \
            cfg.sliding_window
    loss, got = _port_grads(params, cfg, _port_batch(batch))
    assert abs(float(loss) - float(want_loss)) <= LOSS_ABS
    rels = [_rel(g, w) for g, w in zip(got, jax.tree.leaves(want))]
    print(f"{name}: the worst leaf's gradient {max(rels):.2e} of its max |g| (bound {GRAD_REL})")
    assert len(rels) == len(jax.tree.leaves(want)) and max(rels) <= GRAD_REL
    if name == "gemma3-1b":  # without the checkpoints (remat off): the same bits
        monkeypatch.setattr(model, "checkpoint", lambda fn, *args, **kw: fn(*args))
        _, plain = _port_grads(params, cfg, _port_batch(batch))
        assert all(torch.equal(a, b) for a, b in zip(got, plain))


def _ref_step(rcfg, opt, rparams, batch, n):
    fn = jax.jit(ref_steps.make_train_step(rcfg, opt))
    state, out = opt.init(rparams), []
    for i in range(n):
        rparams, state, met = fn(rparams, state, {k: jnp.asarray(v) for k, v in batch[i].items()})
        out.append((rparams, met))
    return out


def _port_step(cfg, opt, params, batch, n):
    fn = steps.make_train_step(cfg, opt)
    state, out = opt.init(params), []
    for i in range(n):
        params, state, met = fn(params, state, _port_batch(batch[i]))
        out.append((params, met))
    return out


@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("opt", ["sgd", "make_optimizer"])
def test_train_step_matches_reference(opt, micro):
    rcfg, cfg, rparams, params = _pair("granite-moe-3b-a800m", num_microbatches=micro)
    batch = [_batch(cfg, 32, seed=10 + i, b=4) for i in range(2)]
    if opt == "sgd":
        ro, po = ref_sgd(0.5), sgd(0.5)
    else:
        ro, po = ref_steps.make_optimizer(rcfg, lr=1e-3), steps.make_optimizer(cfg, lr=1e-3)
    want = _ref_step(rcfg, ro, rparams, batch, 2)
    got = _port_step(cfg, po, params, batch, 2)
    for (rp, rmet), (pp, pmet) in zip(want, got):
        assert abs(float(pmet["loss"]) - float(rmet["loss"])) <= LOSS_ABS
        assert abs(float(pmet["grad_norm"]) - float(rmet["grad_norm"])) <= GRAD_REL * float(
            rmet["grad_norm"])
        assert tuple(pmet["features"].shape) == (4, cfg.d_model)
        assert _rel(pmet["features"], rmet["features"]) <= FEAT_REL
    if opt == "sgd":  # the moves are linear in the gradients: held leaf by leaf
        worst = 0.0
        for g, w, start in zip(tree_leaves(got[-1][0]), jax.tree.leaves(want[-1][0]),
                               tree_leaves(params)):
            w, start = np.asarray(w, np.float32), start.numpy()
            move = np.abs(w - start).max()
            # each package rounds p − lr·g to f32 once a step: two steps move the
            # two apart by up to two spacings at the leaf's largest |p|, besides
            # lr times their gradients' difference
            rounding = 2 * np.spacing(np.abs(w).max())
            err = float(np.abs(g.numpy() - w).max())
            if move > 0:
                worst = max(worst, (err - rounding) / move)
        print(f"sgd, {micro} micro-batches: the worst leaf's move off by {worst:.2e} of it,"
              f" past f32 rounding (bound {GRAD_REL})")
        assert worst <= GRAD_REL


def _ref_detector(d_model=24, hidden=8, shards=2, k=3, ridge=1e-2):
    slfn = rc.init_slfn(jax.random.PRNGKey(7), d_model, hidden)
    warm = np.random.default_rng(8).standard_normal((2 * hidden, d_model)).astype(np.float32)
    det0 = rc.init_oselm(slfn, warm, warm, activation="identity", ridge=ridge)
    feats = np.random.default_rng(9).standard_normal((shards, k, d_model)).astype(np.float32)
    leaves = {"alpha": np.asarray(slfn.alpha), "bias": np.asarray(slfn.bias),
              "beta": np.asarray(det0.beta), "p": np.asarray(det0.p),
              "activation": "identity", "forget": 1.0}
    alone = [rc.oselm_step(det0, feats[i], feats[i]) for i in range(shards)]
    uvs = [rc.to_uv(s, ridge=ridge) for s in alone]
    total = rc.UV(u=sum(uv.u for uv in uvs), v=sum(uv.v for uv in uvs))
    merged = [rc.from_uv(s, total, ridge=ridge) for s in alone]
    return leaves, feats, alone, merged


@pytest.mark.parametrize("shards", [1, 2])
def test_mesh_steps_match_the_single_process(shards, tmp_path):
    """The detector step on each rank against the reference's; the train
    step over the ranks (each its block of the batch, the gradients
    averaged) against the port's single-process step on the whole batch:
    the loss within 1e-5, the parameters within 1e-4 of each leaf's largest
    move past two f32 roundings."""
    ridge = 1e-2
    leaves, feats, alone, merged = _ref_detector(shards=shards, ridge=ridge)
    cfg = get_config("gemma3-1b").reduced()
    batch = {k: v for k, v in _batch(cfg, 32, seed=4, b=4).items()}
    ranks = spawn(torch_mesh_ranks.step_checks, shards, tmp_path, device="cpu",
                  args=(leaves, feats, ridge, "gemma3-1b", batch), timeout=120)
    for r, out in enumerate(ranks):
        for what, want in (("alone", alone[r]), ("merged", merged[r])):
            for leaf in ("beta", "p"):
                got = torch.from_numpy(out[what][leaf])
                rel = _rel(got, getattr(want, leaf))
                assert rel <= GRAD_REL, (r, what, leaf, rel)
        assert out["calls"] == 2  # one all-reduce of U and one of V
    for out in ranks[1:]:
        assert np.array_equal(out["merged"]["beta"], ranks[0]["merged"]["beta"])
        assert all(np.array_equal(a, b) for a, b in zip(out["params"], ranks[0]["params"]))
    from repro_torch.models import init_params

    start = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    params, _, met = steps.make_train_step(cfg, sgd(0.5))(start, sgd(0.5).init(start),
                                                          _port_batch(batch))
    assert abs(ranks[0]["loss"] - float(met["loss"])) <= LOSS_ABS
    for g, w, p0 in zip(ranks[0]["params"], tree_leaves(params), tree_leaves(start)):
        w, p0 = w.numpy(), p0.numpy()
        move = np.abs(w - p0).max()
        err = np.abs(g - w).max() - 2 * np.spacing(np.abs(w).max())
        assert err <= GRAD_REL * move, (err, move)


def test_train_main_on_the_cpu_saves_and_restores(tmp_path):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models import init_params

    rec = train.main(["--arch", "gemma3-1b", "--reduced", "--steps", "25", "--batch", "8",
                      "--seq", "64", "--lr", "3e-3", "--merge-every", "8", "--device", "cpu",
                      "--ckpt-dir", str(tmp_path)])
    assert len(rec["losses"]) == 25 and rec["losses"][-1] < rec["losses"][0]
    assert rec["peak_bytes"] is None and all(np.isfinite(rec["drifts"]))
    assert sum(rec["launches"].values()) == 0  # the plain versions on the CPU
    cfg = get_config("gemma3-1b").reduced()
    params = init_params(torch.Generator().manual_seed(1), cfg, device="cpu")
    opt = steps.make_optimizer(cfg)
    tree, step = CheckpointManager(tmp_path).restore({"params": params, "opt": opt.init(params)})
    assert step == 25 and int(tree["opt"].step) == 25
    sums = [float(t.double().sum()) for t in tree_leaves(tree["params"])]
    assert sums == rec["param_sums"]
