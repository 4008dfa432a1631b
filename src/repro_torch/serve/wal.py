"""Write-ahead log of closed tick windows — the crash-replay source; port
of ``repro.serve.wal``.

The durability contract of the serving front-end: a window is logged
*before* its tick is dispatched, and the log entry carries everything
the tick consumed (the exact padded ``(D, B, F)`` batch, the served
mask, the merge veto). After a SIGKILL the restart resumes from the
newest runtime snapshot and replays every logged window with a seq at
or past the restored tick — bit-identical inputs, so the replayed
ticks reproduce the lost ticks exactly and every request that was
admitted-but-unacked at the kill gets trained and acked exactly once.

Entries are one ``.npz`` per window, written tmp + ``os.replace`` like
the checkpoint store: a crash mid-write can only ever leave a ``*.tmp``
turd, never a torn entry under the real name. ``gc(before)`` prunes
entries already covered by a snapshot (called after each runtime
snapshot), so the log stays bounded by the snapshot cadence.

The file names and npz keys are the reference's: either package replays
the other's log, array for array.
"""
from __future__ import annotations

import logging
import os
import tempfile
from pathlib import Path

import numpy as np

from repro_torch.serve.batcher import TickWindow

__all__ = ["WriteAheadLog"]

_FMT = "wal_{:08d}.npz"


class WriteAheadLog:
    """Directory of per-window npz entries keyed by tick seq."""

    def __init__(self, dir: str | Path) -> None:
        self.dir = Path(dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        # a previous process's in-flight write is junk by definition
        for tmp in self.dir.glob("*.tmp"):
            tmp.unlink(missing_ok=True)

    def _path(self, seq: int) -> Path:
        return self.dir / _FMT.format(seq)

    def append(self, window: TickWindow) -> Path:
        """Durably log one closed window (atomic rename)."""
        path = self._path(window.seq)
        fd, tmp = tempfile.mkstemp(
            dir=self.dir, prefix=path.name, suffix=".tmp"
        )
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(
                    f,
                    seq=np.asarray(window.seq, np.int64),
                    batch=window.batch,
                    served=window.served,
                    allow_merge=np.asarray(window.allow_merge, np.int64),
                )
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            Path(tmp).unlink(missing_ok=True)
            raise
        return path

    def entries(self) -> list[int]:
        """Logged seqs, ascending. A ``wal_*.npz`` name that does not
        parse as a seq is skipped with a warning naming the file: a
        corrupted rename would otherwise masquerade as a benign gap and
        make the resulting ``replayable()`` failure undiagnosable."""
        seqs = []
        for p in self.dir.glob("wal_*.npz"):
            try:
                seqs.append(int(p.stem.split("_")[1]))
            except (IndexError, ValueError):
                logging.getLogger(__name__).warning(
                    "WriteAheadLog: skipping malformed WAL filename %s "
                    "(expected wal_<seq:08d>.npz) — if a replay gap "
                    "follows, this file is the suspect", p,
                )
                continue
        return sorted(seqs)

    def load(self, seq: int) -> tuple[np.ndarray, np.ndarray, bool]:
        """(batch, served, allow_merge) of one logged window."""
        with np.load(self._path(seq)) as z:
            return (
                z["batch"],
                z["served"].astype(bool),
                bool(int(z["allow_merge"])),
            )

    def replayable(self, from_seq: int) -> list[int]:
        """Contiguous run of logged seqs starting at ``from_seq``.

        Entries below ``from_seq`` are already inside the snapshot
        being restored. A gap mid-run means the log lost a window some
        later logged window's tick depended on — replay past it would
        silently diverge from the pre-crash trajectory, so that is an
        error; entries from a contiguous prefix are safe."""
        seqs = [s for s in self.entries() if s >= from_seq]
        run: list[int] = []
        want = from_seq
        for s in seqs:
            if s != want:
                raise RuntimeError(
                    f"write-ahead log gap: expected seq {want}, found {s} "
                    f"(entries {seqs}); the log cannot replay past a hole"
                )
            run.append(s)
            want += 1
        return run

    def gc(self, before: int) -> int:
        """Drop entries with seq < ``before`` (covered by a snapshot)."""
        dropped = 0
        for s in self.entries():
            if s < before:
                self._path(s).unlink(missing_ok=True)
                dropped += 1
        return dropped
