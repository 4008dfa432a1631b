"""The port's roofline (``repro_torch.roofline``) against the reference's
(``repro.roofline``), on the CPU.

- ``RooflineReport``: given the same counts and the same ``Hardware``
  rates, the port's terms, ``dominant``, useful-FLOPs ratio and ``to_dict``
  keys are the reference's, whichever term dominates; ``HW_H100`` holds
  the H100 SXM data sheet's rates.
- ``OpCounter``, the cases of the reference's ``tests/test_roofline.py``
  on an eager program: one matmul's FLOPs exactly, a Python loop of L
  layers (and loops nested) counted L times, a ``torch.utils.checkpoint``
  recompute counted, an in-place slice update counted as the update and
  not the buffer, and interior bytes only inside a kernel's plain version
  (``kernels._lib.plain``), equal to its ops' bytes less the kernel's own.
- The port's prefill FLOPs, counted on fake tensors, against the
  reference's ``analyze_hlo`` of its jitted prefill on one CPU device, on
  reduced configs of an attention arch (gemma3-1b) and of hymba-1.5b (its
  GLA): the gap measured 0 at S 128 and 512 (both count 2·|result|·
  |contraction| of every matmul the program runs, and the port's plain
  versions run the reference's products), so they are held equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.checkpoint import checkpoint

from repro.configs import get_config as ref_get_config
from repro.models import init_params as ref_init_params
from repro.models import prefill as ref_prefill
from repro.roofline.analysis import HW_V5E
from repro.roofline.analysis import RooflineReport as RefReport
from repro.roofline.hlo_costs import analyze_hlo
from repro_torch.configs import get_config
from repro_torch.kernels import _lib, flash_attention, gla_forward
from repro_torch.models import init_params, prefill
from repro_torch.roofline import HW_H100, Hardware, OpCounter, RooflineReport, tensor_bytes

torch.set_num_threads(2)

V5E_RATES = Hardware(name=HW_V5E.name, peak_flops=HW_V5E.peak_flops, hbm_bw=HW_V5E.hbm_bw,
                     link_bw=HW_V5E.link_bw)


def _counts(chips, hw, compute, memory, interior, collective):
    """Report inputs giving each term the seconds asked for on ``hw``."""
    return dict(arch="x", shape="train_4k", mesh="16x16", chips=chips,
                hlo_flops=chips * hw.peak_flops * compute,
                hlo_bytes=chips * hw.hbm_bw * memory,
                attn_interior_bytes=chips * hw.hbm_bw * interior,
                coll_bytes=chips * hw.link_bw * collective,
                coll_breakdown={"all-reduce": 1.0}, model_flops=chips * hw.peak_flops * 0.8,
                per_device_memory={"temp_bytes": 1.0})


@pytest.mark.parametrize("terms", [(1.0, 2.0, 1.0, 0.5), (3.0, 2.0, 0.5, 0.5),
                                   (1.0, 0.5, 0.25, 4.0)], ids=["memory", "compute", "collective"])
def test_report_terms_match_the_reference(terms):
    ref = RefReport(**_counts(256, HW_V5E, *terms))
    port = RooflineReport(**_counts(256, HW_V5E, *terms), hw=V5E_RATES)
    for name in ("t_compute", "t_memory", "t_memory_fused_attn", "t_collective",
                 "useful_flops_ratio"):
        assert getattr(port, name) == pytest.approx(getattr(ref, name), rel=1e-12), name
    assert port.dominant == ref.dominant
    got, want = port.to_dict(), ref.to_dict()
    assert list(got) == list(want)
    for key, value in want.items():
        if isinstance(value, float):
            assert got[key] == pytest.approx(value, rel=1e-12), key
        else:
            assert got[key] == value, key


def test_h100_rates_are_the_data_sheets():
    assert (HW_H100.peak_flops, HW_H100.hbm_bw, HW_H100.link_bw) == (989e12, 3.35e12, 450e9)
    r = RooflineReport(**_counts(8, HW_H100, 1.0, 2.0, 1.0, 0.5))
    assert r.hw is HW_H100 or r.hw == HW_H100
    assert (r.t_compute, r.t_memory, r.t_memory_fused_attn, r.t_collective) == pytest.approx(
        (1.0, 2.0, 1.0, 0.5), rel=1e-12)
    assert r.dominant == "memory" and r.useful_flops_ratio == pytest.approx(0.8)


# ---------------------------------------------------------- the op counter


def test_single_matmul_flops_exact():
    a, b = torch.randn(64, 128), torch.randn(128, 32)
    with OpCounter() as c:
        a @ b
    assert c.costs.flops == 2 * 64 * 32 * 128
    assert c.costs.bytes == 4 * (64 * 128 + 128 * 32 + 64 * 32)


def test_loop_of_layers_counts_each_layer():
    w, x = torch.randn(9, 32, 32), torch.randn(8, 32)
    with OpCounter() as c:
        h = x
        for i in range(9):
            h = torch.tanh(h @ w[i])
    assert c.costs.flops == 9 * 2 * 8 * 32 * 32
    w2, v = torch.randn(5, 4, 16, 16), torch.randn(16)
    with OpCounter() as c:
        for i in range(5):
            for j in range(4):
                v = torch.tanh(w2[i, j] @ v)
    assert c.costs.flops == 5 * 4 * 2 * 16 * 16


def test_checkpoint_recompute_is_counted():
    """A checkpointed forward runs again in the backward, and the counter
    sees its products: exactly one forward product (x·w) more."""
    w = torch.randn(64, 64, requires_grad=True)
    x = torch.randn(8, 64)

    def f(w, x):
        return torch.tanh(x @ w) @ w.T

    with OpCounter() as plain:
        torch.autograd.grad(f(w, x).sum(), w)
    with OpCounter() as remat:
        torch.autograd.grad(checkpoint(f, w, x, use_reentrant=False).sum(), w)
    assert remat.costs.flops > plain.costs.flops
    assert remat.costs.flops - plain.costs.flops == 2 * 8 * 64 * 64


def test_in_place_slice_update_counts_the_update_not_the_buffer():
    cache, rows = torch.zeros(1024, 256), torch.randn(64, 256)
    with OpCounter() as c:
        for i in range(64):
            cache[i] = rows[i]
    row = 256 * 4
    # each copy reads the row and writes it into its slot: its operands
    # and result at the row's size, never the 1 MB buffer
    assert c.costs.bytes == 64 * 3 * row
    assert c.costs.bytes < tensor_bytes(cache)


def test_interior_bytes_appear_only_inside_a_kernels_plain_version():
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 200, 2, 64), generator=gen) for _ in range(3))
    with OpCounter() as c:
        out = flash_attention(q, k, v)
    inside = sum(b * n for (_, _, b, scope), n in c.costs.ops.items() if scope)
    assert all(scope == "flash_attention" for (_, _, _, scope) in c.costs.ops)
    own = tensor_bytes((q, k, v)) + tensor_bytes(out)
    assert dict(c.costs.kernels) == {("flash_attention", own): 1}
    assert c.costs.interior_bytes == inside - own > 0
    assert c.costs.bytes == inside
    # the same products outside any plain version: no interior
    with OpCounter() as outside:
        s = q.transpose(1, 2) @ k.transpose(1, 2).transpose(-1, -2)
        torch.softmax(s, -1) @ v.transpose(1, 2)
    assert outside.costs.interior_bytes == 0 and not outside.costs.kernels
    assert all(scope == "" for (_, _, _, scope) in outside.costs.ops)
    # the GLA forward's plain version is a scope of its own; nothing listens
    # once the counter has exited
    la = -torch.rand((1, 200, 2), generator=gen)
    with OpCounter() as g:
        gla_forward(q, k, v, la)
    assert {scope for (_, _, _, scope) in g.costs.ops} == {"gla_forward"}
    assert _lib.plain_listener is None


def test_one_counter_at_a_time():
    with OpCounter():
        with pytest.raises(RuntimeError, match="already counting"):
            OpCounter().__enter__()


# -------------------------------------------- prefill FLOPs, port vs reference


@pytest.mark.parametrize("arch", ["gemma3-1b", "hymba-1.5b"])
@pytest.mark.parametrize("seq", [128, 512])
def test_prefill_flops_match_the_references_hlo_walk(arch, seq):
    b = 2
    ref_cfg = ref_get_config(arch).reduced()
    structs = jax.eval_shape(lambda key: ref_init_params(key, ref_cfg), jax.random.PRNGKey(0))
    hlo = jax.jit(lambda p, t: ref_prefill(p, ref_cfg, t)).lower(
        structs, jax.ShapeDtypeStruct((b, seq), jnp.int32)).compile().as_text()
    want = analyze_hlo(hlo)["flops"]
    cfg = get_config(arch).reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    with FakeTensorMode():
        params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
        tokens = torch.zeros((b, seq), dtype=torch.int32)
        with OpCounter() as c:
            prefill(params, cfg, tokens)
    print(f"{arch} S={seq}: port {c.costs.flops:.6e} FLOPs, reference {want:.6e}")
    assert c.costs.flops == want
