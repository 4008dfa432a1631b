"""The paper's device-level API on the port against the reference, on the
CPU: the client/server protocol of §4.2 (``repro_torch.federated``), the
client-selection strategies, the batch ELM of §3.1 and
``register_activation``.

- ``tests/test_selection_protocol.py`` and ``tests/test_federated.py`` run
  on the port (``device="cpu"``). A port device draws its basis from a
  ``torch.Generator``; devices that merge share one seed, each its own
  generator.
- ``EdgeDevice`` train, score, share and merge_from against the
  reference's, both starting from the reference's state carried across
  by ``repro_torch.convert``: P and β at 1e-5 (the bound
  ``tests/test_torch_e2lm.py`` holds ``ae_train_stream`` and
  ``cooperative_update`` to), U and V at rtol 1e-5 / atol 1e-4, scores at
  rtol 1e-5 / atol 1e-7.
- ``train_elm``/``predict_elm`` against the reference at 1e-5 (the
  Cholesky solve's bound in ``tests/test_torch_core.py``), and the
  reference's ``tests/test_core.py`` ELM cases on the port.
- A registered activation (a new name, and ``tanh`` registered again with
  another function) through ``hidden``, ``train_elm``, ``ae_train_stream``
  and the plain ``fleet_ingest`` against the reference with the same
  function registered; each name is taken out of both registries
  afterwards.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.activations as ref_activations
import repro_torch.core.activations as activations
from repro.core import (
    SLFNParams as RefSLFNParams,
    ae_train_stream as ref_ae_train_stream,
    hidden as ref_hidden,
    init_oselm as ref_init_oselm,
    predict_elm as ref_predict_elm,
    train_elm as ref_train_elm,
)
from repro.federated import EdgeDevice as RefEdgeDevice
from repro.federated import FederationServer as RefFederationServer
from repro.kernels.fleet_ingest import fleet_ingest_kernel
from repro_torch import core as tcore
from repro_torch.convert import oselm_state_from_numpy
from repro_torch.data import make_har_dataset, make_pattern_stream
from repro_torch.federated import (
    EdgeDevice,
    FederationServer,
    Payload,
    all_clients,
    cooperative_round,
    loss_threshold_selection,
    resource_constrained_selection,
)
from repro_torch.kernels import fleet_ingest_plain

torch.set_num_threads(2)

IDS = ["a", "b", "c", "d"]


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _port(ref):
    return oselm_state_from_numpy(ref.params.alpha, ref.params.bias, ref.beta, ref.p,
                                  activation=ref.activation, forget=ref.forget, device="cpu")


def _close(got, want, *, rtol=1e-5, atol=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


# ------------------------------------- tests/test_selection_protocol.py


def test_all_clients_is_identity():
    assert list(all_clients(IDS)) == IDS


def test_resource_constrained_selection_filters_by_budget():
    budgets = {"a": 1.0, "b": 5.0, "c": 2.5}  # "d" unknown: excluded
    assert list(resource_constrained_selection(budgets, threshold=2.5)(IDS)) == ["a", "c"]
    assert list(resource_constrained_selection(budgets, threshold=0.5)(IDS)) == []


def test_loss_threshold_selection_excludes_unsatisfying_models():
    losses = {"a": 0.01, "b": 9.0, "c": 0.2, "d": 0.19}
    assert list(loss_threshold_selection(losses, max_loss=0.2)(IDS)) == ["a", "c", "d"]
    assert list(loss_threshold_selection({}, max_loss=1e9)(IDS)) == []


def test_strategies_match_reference():
    from repro.federated.selection import (
        loss_threshold_selection as ref_loss,
        resource_constrained_selection as ref_resource,
    )

    rng = np.random.default_rng(4)
    ids = [f"d{i}" for i in range(30)]
    values = {i: float(v) for i, v in zip(ids[:25], rng.uniform(0, 2, 25))}
    for cut in (0.0, 0.7, 1.3, 5.0):
        assert list(loss_threshold_selection(values, cut)(ids)) == list(ref_loss(values, cut)(ids))
        assert (list(resource_constrained_selection(values, cut)(ids))
                == list(ref_resource(values, cut)(ids)))


@pytest.fixture(scope="module")
def uv():
    x = np.random.default_rng(0).normal(size=(64, 24)).astype(np.float32)
    return tcore.to_uv(tcore.init_autoencoder(_gen(), 24, 8, x, ridge=1e-3, device="cpu"))


def test_payload_round_trip(uv):
    p = Payload.from_uv("dev-0", uv, version=3)
    assert p.device_id == "dev-0" and p.version == 3
    assert isinstance(p.u, np.ndarray) and isinstance(p.v, np.ndarray)
    back = p.to_uv("cpu")
    assert isinstance(back, tcore.UV)
    assert torch.equal(back.u, uv.u) and torch.equal(back.v, uv.v)


def test_payload_nbytes_is_the_papers_claim(uv):
    p = Payload.from_uv("dev-0", uv)
    n_hidden, m = uv.u.shape[0], uv.v.shape[1]
    assert p.nbytes == n_hidden * (n_hidden + m) * 4 == uv.nbytes


def test_server_commlog_accounting(uv):
    server = FederationServer()
    for i in range(3):
        server.upload(Payload.from_uv(f"dev-{i}", uv, version=1))
    assert server.log.uploads == 3 and server.log.bytes_up == 3 * uv.nbytes
    assert sorted(server.peers_of("dev-0")) == ["dev-1", "dev-2"]
    assert server.download("dev-1").device_id == "dev-1"
    assert server.log.downloads == 1 and server.log.bytes_down == uv.nbytes
    server.upload(Payload.from_uv("dev-1", uv, version=2))
    assert server.store["dev-1"].version == 2 and len(server.store) == 3


def _make_devices(n: int, n_features: int = 24, n_hidden: int = 8):
    rng = np.random.default_rng(0)
    devs = []
    for i in range(n):
        x = rng.normal(size=(64, n_features)).astype(np.float32) * 0.1 + i
        d = EdgeDevice(f"dev-{i}", _gen(), n_features, n_hidden, x[:32], ridge=1e-3,
                       device="cpu")
        d.train(x[32:])
        devs.append(d)
    return devs


def test_cooperative_round_respects_selection():
    devs = _make_devices(3)
    before = [d.state.beta.clone() for d in devs]
    server = FederationServer()
    cooperative_round(devs, server, select=lambda ids: [i for i in ids if i != "dev-2"])
    assert float((devs[0].state.beta - before[0]).abs().max()) > 1e-6
    assert float((devs[1].state.beta - before[1]).abs().max()) > 1e-6
    assert torch.equal(devs[2].state.beta, before[2])
    assert server.log.uploads == 3 and server.log.downloads == 2


def test_cooperative_round_default_merges_everyone():
    devs = _make_devices(3)
    server = FederationServer()
    cooperative_round(devs, server)
    assert server.log.uploads == 3 and server.log.downloads == 3 * 2
    for d in devs[1:]:
        _close(d.state.beta, devs[0].state.beta.numpy(), rtol=1e-3, atol=1e-4)


# --------------------------------------------- tests/test_federated.py


@pytest.fixture(scope="module")
def har():
    return make_har_dataset(seed=0, samples_per_class=120)


def _har_device(har, device_id, pattern, seed=0, n_hidden=48):
    xs = make_pattern_stream(har, pattern, seed=7)
    dev = EdgeDevice(device_id, _gen(seed), har.n_features, n_hidden, xs[: 2 * n_hidden],
                     ridge=1e-3, device="cpu")
    dev.train(xs[2 * n_hidden:])
    return dev


def test_paper_scenario_device_b_normal_becomes_normal_at_a(har):
    dev_a, dev_b = _har_device(har, "A", "sitting"), _har_device(har, "B", "laying")
    laying = har.pattern("laying")[:64]
    before = dev_a.score(laying).mean()
    server = FederationServer()
    dev_b.share(server)
    dev_a.merge_from(server, ["B"])
    assert dev_a.score(laying).mean() < before / 5.0  # paper Fig. 7


def test_merge_symmetry_between_devices(har):
    dev_a, dev_b = _har_device(har, "A", "sitting"), _har_device(har, "B", "laying")
    cooperative_round([dev_a, dev_b], FederationServer())
    _close(dev_a.state.beta, dev_b.state.beta.numpy(), rtol=1e-3, atol=1e-4)


def test_comm_cost_independent_of_data_size(har):
    small, big = _har_device(har, "S", "walking"), _har_device(har, "B", "walking")
    big.train(make_pattern_stream(har, "standing", seed=11))
    server = FederationServer()
    small.share(server)
    big.share(server)
    assert server.store["S"].nbytes == server.store["B"].nbytes
    assert server.log.uploads == 2


def test_selective_round_excludes_bad_client(har):
    dev_a, dev_b = _har_device(har, "A", "sitting"), _har_device(har, "B", "laying")
    dev_c = _har_device(har, "C", "walking")
    rng = np.random.default_rng(0)
    dev_c.train(rng.normal(size=(200, har.n_features)).astype(np.float32) * 50.0)
    sel = loss_threshold_selection({"A": 0.1, "B": 0.1, "C": 99.0}, max_loss=1.0)
    cooperative_round([dev_a, dev_b, dev_c], FederationServer(), select=sel)
    assert dev_a.score(har.pattern("sitting")[:64]).mean() < 1.0
    assert dev_a.score(har.pattern("laying")[:64]).mean() < 1.0


# ---------------------------------------- EdgeDevice against the reference


N_IN, N_HID, N_INIT = 13, 7, 21


@pytest.mark.parametrize("activation", ["identity", "sigmoid"])
def test_edge_device_matches_reference(activation):
    """Two devices of each package, each port device holding its reference
    twin's boot state: train, score, share and a merge agree."""
    rng = np.random.default_rng(5)
    ridge = 5e-2 if activation == "sigmoid" else 1e-3
    xs = [rng.uniform(-1, 1, (N_INIT + 11, N_IN)).astype(np.float32) + s for s in (0.0, 0.3)]
    refs, ports = [], []
    for i, x in enumerate(xs):
        ref = RefEdgeDevice(f"d{i}", jax.random.PRNGKey(0), N_IN, N_HID, x[:N_INIT],
                            activation=activation, ridge=ridge)
        port = EdgeDevice(f"d{i}", _gen(), N_IN, N_HID, x[:N_INIT], activation=activation,
                          ridge=ridge, device="cpu")
        port.state = _port(ref.state)
        ref.train(x[N_INIT:])
        port.train(x[N_INIT:])
        _close(port.state.p, ref.state.p)
        _close(port.state.beta, ref.state.beta)
        _close(port.score(x), ref.score(x), atol=1e-7)
        refs.append(ref)
        ports.append(port)
    ref_server, server = RefFederationServer(), FederationServer()
    for r, p in zip(refs, ports):
        r.share(ref_server)
        p.share(server)
    for i in ("d0", "d1"):
        _close(server.store[i].u, ref_server.store[i].u, atol=1e-4)
        _close(server.store[i].v, ref_server.store[i].v, atol=1e-4)
        assert server.store[i].nbytes == ref_server.store[i].nbytes
        assert server.store[i].version == ref_server.store[i].version == 1
    refs[0].merge_from(ref_server, ["d1"])
    ports[0].merge_from(server, ["d1"])
    _close(ports[0].state.p, refs[0].state.p)
    _close(ports[0].state.beta, refs[0].state.beta)
    assert (server.log.bytes_down, server.log.downloads) == (
        ref_server.log.bytes_down, ref_server.log.downloads)


def test_edge_device_boots_as_init_autoencoder():
    x = np.random.default_rng(1).uniform(-1, 1, (N_INIT, N_IN)).astype(np.float32)
    dev = EdgeDevice("d", _gen(3), N_IN, N_HID, x, ridge=1e-3, device="cpu")
    want = tcore.init_autoencoder(_gen(3), N_IN, N_HID, x, ridge=1e-3, device="cpu")
    assert torch.equal(dev.state.p, want.p) and torch.equal(dev.state.beta, want.beta)
    assert dev.device == torch.device("cpu")


# ------------------------------------------------------------ batch ELM


def _slfn(seed=0, n_in=24, n_hidden=12):
    rng = np.random.default_rng(seed)
    alpha = rng.uniform(-1, 1, (n_in, n_hidden)).astype(np.float32)
    bias = rng.uniform(-1, 1, n_hidden).astype(np.float32)
    return (RefSLFNParams(jnp.asarray(alpha), jnp.asarray(bias)),
            tcore.SLFNParams(torch.from_numpy(alpha), torch.from_numpy(bias)))


def _data(seed, rows=256, n=24):
    return np.random.default_rng(seed).standard_normal((rows, n)).astype(np.float32)


@pytest.mark.parametrize("activation", ["identity", "sigmoid", "tanh"])
def test_train_and_predict_elm_match_reference(activation):
    ref_p, port_p = _slfn()
    x = _data(1)
    t = _data(2, n=5)
    ridge = 1e-3
    want = ref_train_elm(ref_p, jnp.asarray(x), jnp.asarray(t), activation=activation,
                         ridge=ridge)
    got = tcore.train_elm(port_p, x, t, activation=activation, ridge=ridge)
    assert isinstance(got, tcore.ELMModel) and got.activation == activation
    _close(got.beta, want.beta)
    _close(tcore.predict_elm(got, torch.from_numpy(x)), ref_predict_elm(want, jnp.asarray(x)))


def test_elm_fits_linear_map():
    _, slfn = _slfn()
    x = torch.from_numpy(_data(1))
    beta_star = torch.from_numpy(_data(9, rows=12, n=4))
    t = tcore.hidden(slfn, x, "sigmoid") @ beta_star
    model = tcore.train_elm(slfn, x, t, activation="sigmoid")
    _close(model.beta, beta_star.numpy(), rtol=1e-3, atol=1e-4)
    _close(tcore.predict_elm(model, x), t.numpy(), rtol=1e-3, atol=1e-3)


def test_elm_activation_variants():
    _, slfn = _slfn()
    x = _data(2)
    for act in ("sigmoid", "identity", "tanh", "relu"):
        m = tcore.train_elm(slfn, x, x, activation=act)
        assert m.beta.shape == (12, 24) and bool(torch.isfinite(m.beta).all())


def test_oselm_init_and_sequential_equal_batch_elm():
    _, slfn = _slfn()
    x = torch.from_numpy(_data(3))
    elm64 = tcore.train_elm(slfn, x[:64], x[:64], activation="sigmoid")
    st = tcore.init_oselm(slfn, x[:64], x[:64], activation="sigmoid")
    _close(st.beta, elm64.beta.numpy(), rtol=1e-4, atol=1e-4)
    st = tcore.init_oselm(slfn, x[:32], x[:32], activation="sigmoid")
    st = tcore.oselm_train_sequential(st, x[32:], x[32:])
    elm = tcore.train_elm(slfn, x, x, activation="sigmoid")
    _close(st.beta, elm.beta.numpy(), rtol=1e-3, atol=1e-4)


def test_merges_equal_batch_elm():
    """§4.2: a merge equals batch training on the union, either way round,
    and training on after it stays on the batch solution."""
    _, slfn = _slfn()
    x = torch.from_numpy(_data(12, rows=300))
    a, b, c = x[:100], x[100:200], x[200:]

    def trained(part):
        st = tcore.init_oselm(slfn, part[:32], part[:32], activation="sigmoid")
        return tcore.oselm_train_sequential(st, part[32:], part[32:])

    st_a, st_b = trained(a), trained(b)
    ab = tcore.cooperative_update(st_a, tcore.to_uv(st_b))
    ba = tcore.cooperative_update(st_b, tcore.to_uv(st_a))
    _close(ab.beta, ba.beta.numpy(), rtol=1e-3, atol=1e-4)
    _close(ab.beta, tcore.train_elm(slfn, x[:200], x[:200], activation="sigmoid").beta.numpy(),
           rtol=1e-3, atol=1e-4)
    on = tcore.oselm_train_sequential(ab, c, c)
    _close(on.beta, tcore.train_elm(slfn, x, x, activation="sigmoid").beta.numpy(),
           rtol=1e-3, atol=2e-4)


# -------------------------------------------------- register_activation


def _softplus_jax(x):
    return jnp.log1p(jnp.exp(-jnp.abs(x))) + jnp.maximum(x, 0.0)


def _softplus_torch(x):
    return torch.log1p(torch.exp(-x.abs())) + torch.clamp_min(x, 0.0)


# (name, reference function, port function): a new name, and a built-in
# name registered again with another function
REGISTERED = {
    "softplus_test": (_softplus_jax, _softplus_torch),
    "tanh": (lambda x: 1.7159 * jnp.tanh(x * (2.0 / 3.0)),
             lambda x: 1.7159 * torch.tanh(x * (2.0 / 3.0))),
}


@pytest.fixture(params=sorted(REGISTERED))
def registered(request):
    name = request.param
    ref_fn, port_fn = REGISTERED[name]
    saved = (ref_activations._REGISTRY.get(name), activations._REGISTRY.get(name))
    ref_activations.register_activation(name, ref_fn)
    tcore.register_activation(name, port_fn)
    try:
        yield name
    finally:
        for registry, fn in zip((ref_activations._REGISTRY, activations._REGISTRY), saved):
            if fn is None:
                registry.pop(name, None)
            else:
                registry[name] = fn


def test_registered_activation_matches_reference(registered):
    name = registered
    assert activations.kernel_code(name) is None
    ref_p, port_p = _slfn(4, n_in=13, n_hidden=7)
    rng = np.random.default_rng(8)
    x = rng.uniform(-1, 1, (40, 13)).astype(np.float32)
    _close(tcore.hidden(port_p, torch.from_numpy(x), name),
           ref_hidden(ref_p, jnp.asarray(x), name), atol=1e-6)
    want = ref_train_elm(ref_p, jnp.asarray(x), jnp.asarray(x), activation=name, ridge=1e-3)
    got = tcore.train_elm(port_p, x, x, activation=name, ridge=1e-3)
    _close(got.beta, want.beta)
    ref = ref_init_oselm(ref_p, jnp.asarray(x[:N_INIT]), jnp.asarray(x[:N_INIT]),
                         activation=name, ridge=1e-3)
    _close(_port(ref).p, ref.p)
    rs = ref_ae_train_stream(ref, jnp.asarray(x[N_INIT:]))
    gs = tcore.ae_train_stream(_port(ref), torch.from_numpy(x[N_INIT:]))
    _close(gs.p, rs.p)
    _close(gs.beta, rs.beta)
    # the fused ingest's plain version against the reference's Pallas kernel
    # (interpret mode), three devices on the shared basis
    stack = jax.tree_util.tree_map(lambda leaf: jnp.stack([leaf] * 3), ref)
    win = rng.uniform(-1, 1, (3, 9, 13)).astype(np.float32)
    want, want_loss = fleet_ingest_kernel(stack, jnp.asarray(win), block_d=4, interpret=True)
    got, loss = fleet_ingest_plain(_port(stack), torch.from_numpy(win))
    _close(got.p, want.p)
    _close(got.beta, want.beta)
    _close(loss, want_loss, atol=1e-7)


def test_builtin_names_keep_their_kernel_codes():
    assert {n: activations.kernel_code(n) for n in activations.ACTIVATION_CODES} == (
        activations.ACTIVATION_CODES)
    with pytest.raises(ValueError, match="unknown activation"):
        activations.kernel_code("no_such_activation")
