"""The port's npz store (``repro_torch.checkpoint``) against the
reference's ``repro.checkpoint``, on the CPU.

- The reference's ``tests/test_checkpoint.py`` cases (keep-last retention,
  ``keep=None``, ``keep >= 1``, the interrupted ``*.tmp`` cleaned up, the
  walk-back past a corrupt newest file) and ``tests/test_robust.py``'s
  walk-back past a torn and a zero-byte file, with an explicit step
  failing loudly, run on the port's ``CheckpointManager``.
- A nested tree (dicts, NamedTuples, dataclasses with static fields,
  tuples, lists, None; f32, f64, int32, int64, uint8, bool and bf16
  leaves) saved by either package loads in the other, leaf for leaf and
  bit for bit, and the port's key manifest equals the one jax's
  ``tree_flatten_with_path`` gives the reference's copy of the tree.
- Load keeps a numpy leaf of the template numpy with the template's dtype
  and makes a tensor leaf a tensor of the template's dtype and device.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_pytree as ref_load_pytree
from repro.checkpoint import save_pytree as ref_save_pytree
from repro.checkpoint.npz_store import _path_str as ref_path_str
from repro.core import OSELMState as RefOSELMState
from repro.core import SLFNParams as RefSLFNParams
from repro.runtime.detector import DetectorState as RefDetectorState
from repro_torch.checkpoint import (
    CheckpointManager,
    flatten_with_path,
    load_pytree,
    save_pytree,
)
from repro_torch.core import OSELMState, SLFNParams
from repro_torch.runtime import DetectorState

torch.set_num_threads(2)


def _tree(v: float) -> dict:
    return {"w": np.full((4, 3), v, np.float32), "step": np.asarray(int(v), np.int64)}


def _steps(mgr: CheckpointManager) -> list[int]:
    return sorted(int(p.stem.split("_")[1]) for p in mgr.dir.glob("ckpt_*.npz"))


# ------------------------------------------ the reference's manager cases


def test_keep_last_retention_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep_last=3)
    for s in range(8):
        mgr.save(s, _tree(float(s)))
    assert _steps(mgr) == [5, 6, 7]
    assert mgr.latest_step() == 7
    tree, step = mgr.restore(_tree(0.0))
    assert step == 7
    np.testing.assert_array_equal(tree["w"], _tree(7.0)["w"])


def test_keep_none_retains_everything(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=None)
    for s in range(6):
        mgr.save(s, _tree(float(s)))
    assert _steps(mgr) == list(range(6))


def test_keep_must_be_positive(tmp_path):
    with pytest.raises(ValueError, match="keep >= 1"):
        CheckpointManager(tmp_path, keep_last=0)


def test_atomic_write_cleans_interrupted_tmp(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    mgr.save(0, _tree(0.0))
    tmp = tmp_path / "ckpt_00000001.npz.12345.tmp"
    tmp.write_bytes(b"half a zip file")
    mgr.save(1, _tree(1.0))
    assert not tmp.exists()
    assert _steps(mgr) == [0, 1]
    _, step = mgr.restore(_tree(0.0))
    assert step == 1


def test_walkback_survives_corrupt_newest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=4)
    for s in range(3):
        mgr.save(s, _tree(float(s)))
    newest = tmp_path / "ckpt_00000002.npz"
    newest.write_bytes(newest.read_bytes()[: newest.stat().st_size // 2])
    tree, step = mgr.restore(_tree(0.0))
    assert step == 1
    np.testing.assert_array_equal(tree["w"], _tree(1.0)["w"])
    with pytest.raises(Exception):
        mgr.restore(_tree(0.0), step=2)


def test_restore_falls_back_past_torn_and_empty_files(tmp_path, caplog):
    cm = CheckpointManager(tmp_path, keep=4)
    tree = {"a": np.arange(6, dtype=np.int64).reshape(2, 3)}
    cm.save(1, tree)
    cm.save(2, {"a": tree["a"] + 1})
    latest = tmp_path / "ckpt_00000002.npz"
    latest.write_bytes(latest.read_bytes()[:40])  # torn write
    with caplog.at_level("WARNING"):
        got, step = cm.restore(tree)
    assert step == 1
    np.testing.assert_array_equal(got["a"], tree["a"])
    assert "falling back" in caplog.text

    cm.save(3, tree)
    (tmp_path / "ckpt_00000003.npz").write_bytes(b"")  # zero bytes
    _, step = cm.restore(tree)
    assert step == 1
    with pytest.raises(Exception):
        cm.restore(tree, step=3)
    (tmp_path / "ckpt_00000001.npz").write_bytes(b"junk")
    with pytest.raises(FileNotFoundError, match="all unreadable"):
        cm.restore(tree)


def test_empty_directory_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        CheckpointManager(tmp_path).restore(_tree(0.0))


def test_leaf_count_mismatch_raises(tmp_path):
    save_pytree(_tree(1.0), tmp_path / "a.npz")
    with pytest.raises(ValueError, match="template expects 3"):
        load_pytree({**_tree(1.0), "x": np.zeros(2)}, tmp_path / "a.npz")


# ------------------------------------------- the file across the packages


@dataclasses.dataclass(frozen=True)
class _Meta:
    """A dataclass whose second field is static metadata in both trees."""

    arr: object
    name: str = dataclasses.field(default="tag", metadata=dict(static=True))


jax.tree_util.register_dataclass(_Meta)


def _leaves(rng):
    return {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "f64": rng.standard_normal(4),
        "i32": rng.integers(-9, 9, (2, 3)).astype(np.int32),
        "i64": np.asarray(2**40 + 3, np.int64),
        "u8": rng.integers(0, 255, 7).astype(np.uint8),
        "bool": rng.random(6) < 0.5,
        "empty": np.zeros((0, 2), np.int64),
        "alpha": rng.standard_normal((2, 5, 3)).astype(np.float32),
        "bias": rng.standard_normal((2, 3)).astype(np.float32),
        "beta": rng.standard_normal((2, 3, 5)).astype(np.float32),
        "p": rng.standard_normal((2, 3, 3)).astype(np.float32),
        "det": [rng.standard_normal(2).astype(np.float32) for _ in range(3)]
        + [np.asarray([3, 4], np.int32), np.asarray([True, False]), np.asarray([0, 1], np.int32)],
    }


def _ref_tree(a):
    """The reference's tree: jax arrays under its own state types."""
    j = jnp.asarray
    return {
        "zeta": {"b": j(a["f32"]), "a": (a["i64"], [j(a["i32"]), None, a["u8"]])},
        "states": RefOSELMState(params=RefSLFNParams(j(a["alpha"]), j(a["bias"])),
                                beta=j(a["beta"]), p=j(a["p"]), activation="identity"),
        "det": RefDetectorState(*(j(x) for x in a["det"])),
        "meta": _Meta(a["f64"]),
        "ledger": a["empty"],
        "flags": a["bool"],
    }


def _port_tree(a):
    """The same tree in the port: tensors under the port's state types,
    numpy where the reference keeps numpy."""
    t = torch.from_numpy
    return {
        "zeta": {"b": t(a["f32"]), "a": (a["i64"], [t(a["i32"]), None, a["u8"]])},
        "states": OSELMState(params=SLFNParams(t(a["alpha"]), t(a["bias"])),
                             beta=t(a["beta"]), p=t(a["p"]), activation="identity"),
        "det": DetectorState(*(t(x) for x in a["det"])),
        "meta": _Meta(t(a["f64"])),
        "ledger": a["empty"],
        "flags": a["bool"],
    }


def _as_numpy(leaf):
    return leaf.numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)


def _ref_keys(tree):
    return [ref_path_str(kp) for kp, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_manifest_equals_jax_for_the_same_tree():
    a = _leaves(np.random.default_rng(0))
    port_keys = [k for k, _ in flatten_with_path(_port_tree(a))]
    assert port_keys == _ref_keys(_ref_tree(a))
    assert "states␟params␟alpha" in port_keys and "meta␟arr" in port_keys
    assert not any("activation" in k or "forget" in k or "name" in k for k in port_keys)


def test_reference_file_loads_in_the_port_bit_for_bit(tmp_path):
    a = _leaves(np.random.default_rng(1))
    ref_tree = _ref_tree(a)
    ref_save_pytree(ref_tree, tmp_path / "ref.npz")
    template = _port_tree({k: (np.zeros_like(v) if isinstance(v, np.ndarray) else v)
                           for k, v in a.items()})
    got = load_pytree(template, tmp_path / "ref.npz")
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(ref_tree)]
    flat = [leaf for _, leaf in flatten_with_path(got)]
    assert len(flat) == len(want)
    for g, w in zip(flat, want):
        np.testing.assert_array_equal(_as_numpy(g), w)
        assert _as_numpy(g).dtype == w.dtype
    assert isinstance(got["ledger"], np.ndarray) and got["ledger"].shape == (0, 2)
    assert isinstance(got["states"].beta, torch.Tensor)
    assert got["states"].activation == "identity" and got["zeta"]["a"][1][1] is None


def test_port_file_loads_in_the_reference_bit_for_bit(tmp_path):
    a = _leaves(np.random.default_rng(2))
    port_tree = _port_tree(a)
    save_pytree(port_tree, tmp_path / "port.npz")
    with np.load(tmp_path / "port.npz") as z:
        assert json.loads(str(z["__keys__"])) == _ref_keys(_ref_tree(a))
    got = ref_load_pytree(_ref_tree(a), tmp_path / "port.npz")
    want = [_as_numpy(leaf) for _, leaf in flatten_with_path(port_tree)]
    flat = jax.tree_util.tree_leaves(got)
    assert len(flat) == len(want)
    for g, w in zip(flat, want):
        np.testing.assert_array_equal(np.asarray(g), w)


def test_load_places_leaves_as_the_template(tmp_path):
    """A numpy leaf stays numpy at the template's dtype and keeps the
    file's shape; a tensor leaf takes the template's dtype and device; a
    bf16 tensor is saved as f32, as the reference saves bf16."""
    half = torch.tensor([1.5, -2.25, 3.0], dtype=torch.bfloat16)
    tree = {"ledger": np.arange(6, dtype=np.int64).reshape(3, 2), "w": half,
            "x": torch.arange(4, dtype=torch.int32)}
    save_pytree(tree, tmp_path / "a.npz")
    with np.load(tmp_path / "a.npz") as z:
        assert z["leaf_1"].dtype == np.float32  # keys sorted: ledger, w, x
    template = {"ledger": np.zeros((0, 2), np.int32), "w": torch.zeros(3, dtype=torch.bfloat16),
                "x": torch.zeros(4, dtype=torch.float64)}
    got = load_pytree(template, tmp_path / "a.npz")
    assert isinstance(got["ledger"], np.ndarray) and got["ledger"].dtype == np.int32
    assert got["ledger"].shape == (3, 2)
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], half)
    assert got["x"].dtype == torch.float64 and got["x"].device == template["x"].device
    np.testing.assert_array_equal(got["x"].numpy(), np.arange(4))
