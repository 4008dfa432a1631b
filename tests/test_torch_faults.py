"""The port's fault injector against the reference's, bit for bit, on the
CPU: victims (explicit and ``frac``-chosen), payload operands, crash
masks, poisoned batches, Byzantine devices and active schedules, for
every fault kind, with windows and periods; and the same validation
errors."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.fleet.faults import FAULT_KINDS as REF_KINDS
from repro.fleet.faults import FaultInjector as RefInjector
from repro.fleet.faults import FaultSpec as RefSpec
from repro_torch.fleet.faults import FAULT_KINDS, FaultInjector, FaultSpec

torch.set_num_threads(2)

D, SHAPE, TICKS = 11, (11, 4, 7), 14

SPECS = [
    dict(kind="sign_flip", frac=0.2, magnitude=3.0, seed=1),
    dict(kind="scale", frac=0.1, magnitude=-25.0, seed=7),
    dict(kind="scale", devices=(2, 5), magnitude=0.5, start_tick=3, period=3),
    dict(kind="noise", devices=(1, 6), magnitude=0.5, start_tick=4, end_tick=9, seed=2),
    dict(kind="noise", frac=0.3, magnitude=0.1, period=2, seed=4),
    dict(kind="nan", devices=(5,), start_tick=6, period=2),
    dict(kind="inf", frac=0.15, start_tick=2, end_tick=12, period=5, seed=3),
    dict(kind="crash", devices=(0, 9), start_tick=3, end_tick=5),
    dict(kind="crash", frac=0.25, start_tick=7, seed=9),
    dict(kind="poison", devices=(3,), start_tick=5, end_tick=8, magnitude=2.0, seed=5),
    dict(kind="poison", frac=0.2, start_tick=10, period=2, magnitude=0.3, seed=6),
]


def _pair(specs, seed=11):
    return (FaultInjector(tuple(FaultSpec(**s) for s in specs), D, seed=seed),
            RefInjector(tuple(RefSpec(**s) for s in specs), D, seed=seed))


def test_fault_kinds_match_reference():
    assert FAULT_KINDS == REF_KINDS
    assert {s["kind"] for s in SPECS} == set(FAULT_KINDS)


@pytest.mark.parametrize("which", range(len(SPECS)))
def test_each_schedule_matches_reference(which):
    got, want = _pair([SPECS[which]])
    _hold(got, want)


@pytest.mark.parametrize("seed", [0, 11])
def test_all_schedules_together_match_reference(seed):
    got, want = _pair(SPECS, seed=seed)
    _hold(got, want)


def _hold(got, want):
    assert [v.tolist() for v in got._victims] == [v.tolist() for v in want._victims]
    assert got.byzantine_devices == want.byzantine_devices
    batch = np.random.default_rng(0).standard_normal((D, 3, 5)).astype(np.float32)
    for t in range(TICKS):
        for g, w in zip(got.payload_ops(t, SHAPE), want.payload_ops(t, SHAPE)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        mult, nonfin = got.payload_scale(t)
        np.testing.assert_array_equal(mult, want.payload_ops(t, SHAPE)[0])
        np.testing.assert_array_equal(nonfin, want.payload_ops(t, SHAPE)[2])
        noise = got.payload_noise(t, SHAPE)
        if noise is None:  # no noise schedule active: the reference's is all zeros
            assert not want.payload_ops(t, SHAPE)[1].any()
        np.testing.assert_array_equal(got.crash_mask(t), want.crash_mask(t))
        np.testing.assert_array_equal(got.poison_batch(batch, t), want.poison_batch(batch, t))
        assert (got.poison_batch(batch, t) is batch) == (want.poison_batch(batch, t) is batch)
        assert got.active_faults(t) == want.active_faults(t)


@pytest.mark.parametrize("bad", [
    dict(kind="emp"),
    dict(kind="scale", devices=(1,), frac=0.5),
    dict(kind="scale"),
    dict(kind="scale", frac=1.5),
    dict(kind="scale", devices=(1,), period=0),
    dict(kind="scale", devices=(1,), start_tick=8, end_tick=4),
    dict(kind="scale", devices=(1,), start_tick=4, end_tick=4),
])
def test_spec_validation_matches_reference(bad):
    with pytest.raises(ValueError) as got:
        FaultSpec(**bad)
    with pytest.raises(ValueError) as want:
        RefSpec(**bad)
    assert str(got.value) == str(want.value)


def test_injector_validation_matches_reference():
    with pytest.raises(ValueError, match=r"fault devices \[9\] out of range"):
        FaultInjector((FaultSpec(kind="scale", devices=(9,)),), 4)
    with pytest.raises(ValueError, match=r"fault devices \[9\] out of range"):
        RefInjector((RefSpec(kind="scale", devices=(9,)),), 4)
    with pytest.raises(TypeError, match="expected FaultSpec"):
        FaultInjector((dataclasses.asdict(FaultSpec(kind="scale", devices=(1,))),), 4)
    with pytest.raises(ValueError, match="vs fleet of 4"):
        FaultInjector((FaultSpec(kind="noise", devices=(1,)),), 4).payload_ops(0, (5, 2, 2))
    with pytest.raises(ValueError, match="vs fleet of 4"):
        RefInjector((RefSpec(kind="noise", devices=(1,)),), 4).payload_ops(0, (5, 2, 2))
