"""Crash flight recorder: a bounded ring of recent tick records; port of
``repro.obs.flight``.

Debugging a chaos soak (fault injection, Byzantine payloads, SLO
breaches) needs the ticks *leading up to* the event, not just the
event: which devices were quarantined, what the governor decided, what
faults were active, what the losses looked like. The flight recorder
keeps the last ``capacity`` per-tick records (JSON-able dicts the
runtime assembles) and, when something goes wrong — an exception, a
non-finite payload rejection, a tick-latency SLO breach — dumps the
whole ring plus the failing tick's *input batch* to
``flight_<tick>.json``. The inputs make the dump replayable: feeding
them back through an identically-configured runtime reproduces the
failing tick bit-for-bit (fault schedules are deterministic).

Dumps are rate-limited (``max_dumps`` total, but the first occurrence
of each distinct reason always dumps) so a soak with a persistent
fault does not grind itself into the disk. The ring itself is part of
the runtime's snapshot state: a kill/restore resumes with the same
recent history it crashed with.
"""
from __future__ import annotations

import json
from collections import deque
from pathlib import Path

import numpy as np

__all__ = ["FlightRecorder", "jsonable"]


def jsonable(obj):
    """Recursively coerce numpy scalars/arrays into JSON-able Python."""
    if isinstance(obj, dict):
        return {str(k): jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    return obj


class FlightRecorder:
    """Last-N tick records + triggered dumps."""

    def __init__(self, capacity: int = 64, *, max_dumps: int = 4) -> None:
        if capacity < 1:
            raise ValueError(f"need capacity >= 1, got {capacity}")
        self.capacity = capacity
        self.max_dumps = max_dumps
        self._ring: deque[dict] = deque(maxlen=capacity)
        self.records_total = 0
        self.dumps: list[str] = []           # paths written this process
        self._dumped_reasons: set[str] = set()

    def __len__(self) -> int:
        return len(self._ring)

    def record(self, rec: dict) -> None:
        """Append one per-tick record. The dict is stored as-is — the
        hot tick loop must not pay a recursive coercion walk — and
        ``records()`` (the only read path: dumps and snapshots) applies
        ``jsonable`` lazily, so a dump still never fails on a stray
        numpy leaf. Callers hand over a fresh dict per tick and do not
        mutate it afterwards."""
        self._ring.append(rec)
        self.records_total += 1

    def records(self) -> list[dict]:
        return [jsonable(r) for r in self._ring]

    def should_dump(self, reason: str) -> bool:
        """First occurrence of a reason always dumps; after that the
        total budget gates (a soak with NaN payloads every round must
        not write hundreds of dumps)."""
        return reason not in self._dumped_reasons or len(self.dumps) < self.max_dumps

    def dump(
        self,
        directory: str | Path,
        tick: int,
        reason: str,
        *,
        inputs: np.ndarray | None = None,
        extra: dict | None = None,
    ) -> Path | None:
        """Write ``flight_<tick>.json`` with the ring, the trigger, and
        (when given) the failing tick's input batch. Returns the path,
        or None when rate-limited."""
        if not self.should_dump(reason):
            return None
        self._dumped_reasons.add(reason)
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        path = directory / f"flight_{tick:08d}.json"
        payload = {
            "reason": reason,
            "tick": int(tick),
            "ring": self.records(),
            "extra": jsonable(extra or {}),
        }
        if inputs is not None:
            inputs = np.asarray(inputs)
            payload["inputs"] = {
                "shape": list(inputs.shape),
                "dtype": str(inputs.dtype),
                "values": inputs.tolist(),
            }
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(payload))
        tmp.replace(path)  # atomic: a torn dump never shadows a good one
        self.dumps.append(str(path))
        return path

    # ------------------------------------------------------------- snapshot

    def state(self) -> dict:
        return {
            "capacity": self.capacity,
            "ring": self.records(),
            "records_total": self.records_total,
            "dumped_reasons": sorted(self._dumped_reasons),
        }

    def load_state(self, state: dict) -> None:
        self._ring.clear()
        self._ring.extend(state.get("ring", ()))
        self.records_total = int(state.get("records_total", len(self._ring)))
        self._dumped_reasons = set(state.get("dumped_reasons", ()))


def load_dump(path: str | Path) -> dict:
    """Read a ``flight_<tick>.json`` dump, reconstructing the input
    batch as a numpy array when present."""
    with open(path) as fh:
        payload = json.load(fh)
    if "inputs" in payload:
        spec = payload["inputs"]
        payload["inputs"] = np.asarray(
            spec["values"], dtype=np.dtype(spec["dtype"])
        ).reshape(spec["shape"])
    return payload


__all__.append("load_dump")
