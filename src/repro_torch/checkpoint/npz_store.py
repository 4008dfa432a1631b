"""npz snapshots of nested trees (port of ``repro.checkpoint.npz_store``).

A tree is flattened in the order ``jax.tree_util`` flattens the
reference's: dict keys sorted, the fields of a NamedTuple or a dataclass
in declaration order (a dataclass field whose metadata says ``static`` is
metadata, not a leaf), tuple and list items by index, None holding
nothing. Its leaves go into one compressed ``.npz`` as ``leaf_0 …
leaf_k`` beside a JSON ``__keys__`` manifest of their paths, each path's
parts joined by ``"␟"``: the reference's format, so that each package
reads the other's files. A tensor goes to the host to be saved; a leaf
npz cannot store (bf16) is saved as f32, as the reference saves it.

``load_pytree`` reads the leaves back by position into the structure of
a template: a numpy leaf of the template stays numpy with the template's
dtype (and the file's shape, so that a variable-length ledger comes back
whole), a tensor leaf becomes a tensor of the template's dtype on the
template's device.

``CheckpointManager`` keeps a directory of ``ckpt_<step>.npz`` snapshots:
atomic writes (a temporary file, then ``os.replace``), retention of the
newest ``keep``, and a restore that walks back past unreadable files.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import tempfile
import zipfile
from pathlib import Path
from typing import Any, Iterator

import numpy as np
import torch

Tree = Any

log = logging.getLogger(__name__)

_SEP = "␟"  # symbol for unit separator: never in a key name

__all__ = ["CheckpointManager", "flatten_with_path", "load_pytree", "save_pytree"]


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(type(node), "_fields")


def _children(node) -> list[tuple[str, Any]] | None:
    """(key, child) pairs of a container in the reference's flatten order,
    or None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (tuple, list)):
        return [(str(i), c) for i, c in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name)) for f in dataclasses.fields(node)
                if not f.metadata.get("static", False)]
    return None


def flatten_with_path(tree: Tree, prefix: tuple[str, ...] = ()) -> Iterator[tuple[str, Any]]:
    """(path, leaf) pairs in the reference's leaf order, each path the
    reference's manifest key."""
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        yield _SEP.join(prefix), tree
        return
    for key, child in kids:
        yield from flatten_with_path(child, prefix + (key,))


def _rebuild(template: Tree, leaves: Iterator[Any]) -> Tree:
    if template is None:
        return None
    if isinstance(template, dict):
        # children are consumed in sorted order, then rebuilt in the
        # template's own key order
        new = {k: _rebuild(template[k], leaves) for k in sorted(template)}
        return {k: new[k] for k in template}
    if _is_namedtuple(template):
        return type(template)(*(_rebuild(getattr(template, f), leaves)
                                for f in template._fields))
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(c, leaves) for c in template)
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: _rebuild(getattr(template, f.name), leaves)
            for f in dataclasses.fields(template) if not f.metadata.get("static", False)
        })
    return next(leaves)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.cpu().numpy()
    arr = np.asarray(leaf)
    if arr.dtype.kind not in "biufc":  # bf16 and the like: npz cannot store them
        arr = arr.astype(np.float32)
    return arr


def save_pytree(tree: Tree, path: str | os.PathLike) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays, keys = {}, []
    for i, (key, leaf) in enumerate(flatten_with_path(tree)):
        arrays[f"leaf_{i}"] = _host(leaf)
        keys.append(key)
    tmp = tempfile.NamedTemporaryFile(dir=path.parent, suffix=".tmp", delete=False)
    try:
        np.savez_compressed(tmp, __keys__=np.asarray(json.dumps(keys)), **arrays)
        tmp.close()
        os.replace(tmp.name, path)  # atomic
    finally:
        if os.path.exists(tmp.name):
            os.unlink(tmp.name)


def _restore_leaf(saved: np.ndarray, template):
    if isinstance(template, np.ndarray):
        # host-side leaves (counters, ledgers) stay numpy: int64 survives
        return np.asarray(saved, dtype=template.dtype)
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(saved)).to(
            device=template.device, dtype=template.dtype)
    return saved


def load_pytree(template: Tree, path: str | os.PathLike) -> Tree:
    """Restore into the structure of ``template``, leaf by leaf in order."""
    with np.load(path, allow_pickle=False) as data:
        leaves = [data[f"leaf_{i}"] for i in range(len(data.files) - 1)]
    flat = [leaf for _, leaf in flatten_with_path(template)]
    if len(flat) != len(leaves):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves; template expects {len(flat)}"
        )
    return _rebuild(template, iter([_restore_leaf(s, t) for s, t in zip(leaves, flat)]))


class CheckpointManager:
    """A retention-managed snapshot directory.

    Writes are atomic (a temporary file, then ``os.replace``), so a crash
    mid-save never leaves a truncated file under a checkpoint's name; the
    restore walk-back covers a disk that corrupts a file afterwards.
    ``keep``/``keep_last`` bound the directory to the N newest snapshots
    (``keep=None`` keeps all)."""

    def __init__(
        self,
        directory: str | os.PathLike,
        *,
        keep: int | None = 3,
        keep_last: int | None = None,
    ) -> None:
        self.dir = Path(directory)
        # keep_last is the serving stack's spelling of the same knob; it
        # wins when both are passed
        self.keep = keep_last if keep_last is not None else keep
        if self.keep is not None and self.keep < 1:
            raise ValueError(f"retention must keep >= 1 snapshot, got {self.keep}")
        self.dir.mkdir(parents=True, exist_ok=True)

    def save(self, step: int, tree: Tree) -> Path:
        p = self.dir / f"ckpt_{step:08d}.npz"
        save_pytree(tree, p)
        self._gc()
        return p

    def _steps(self) -> list[int]:
        return sorted(int(p.stem.split("_")[1]) for p in self.dir.glob("ckpt_*.npz"))

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, template: Tree, step: int | None = None) -> tuple[Tree, int]:
        """Restore the requested (or the newest readable) checkpoint.

        With ``step=None`` the manager walks back from the newest snapshot,
        warning past any file that does not load, so a recovering runtime
        resumes from the newest snapshot that does. An explicit ``step``
        fails loudly: the caller asked for that exact state."""
        if step is not None:
            return load_pytree(template, self.dir / f"ckpt_{step:08d}.npz"), step
        steps = self._steps()[::-1]
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        last_err: Exception | None = None
        for s in steps:
            path = self.dir / f"ckpt_{s:08d}.npz"
            try:
                return load_pytree(template, path), s
            except (OSError, ValueError, KeyError, EOFError,
                    zipfile.BadZipFile, json.JSONDecodeError) as e:
                log.warning(
                    "checkpoint %s is unreadable (%s: %s) — falling back to "
                    "the previous step", path.name, type(e).__name__, e,
                )
                last_err = e
        raise FileNotFoundError(
            f"no readable checkpoint in {self.dir} "
            f"({len(steps)} candidates, all unreadable)"
        ) from last_err

    def _gc(self) -> None:
        # a *.tmp here is an earlier process's interrupted save: its
        # atomic rename never happened
        for tmp in self.dir.glob("*.tmp"):
            tmp.unlink(missing_ok=True)
        if self.keep is None:
            return
        for old in sorted(self.dir.glob("ckpt_*.npz"))[: -self.keep]:
            old.unlink()
