"""Lightweight span tracing: JSONL traces + optional profiler hooks;
port of ``repro.obs.trace``.

A span is one named, attributed interval — ``span("merge", tick=t)`` —
written as a single JSON line the moment it closes:

    {"name": "merge", "ts": <unix-epoch start>, "dur_s": <seconds>,
     "tick": 12, ...}

The JSONL format loads with one ``json.loads`` per line (no trailing
comma framing, torn final lines are skippable), which is exactly what
post-mortem tooling over a chaos soak wants.

With ``annotations=True`` every span also enters a
``torch.profiler.record_function`` scope, so spans line up with the
kernels in a ``torch.profiler`` capture taken around the run — the
host-side tick phases and the device timeline share names.

A ``Tracer`` constructed with ``path=None`` and no annotations is a
near-free no-op (one perf_counter pair per span), so instrumented code
never needs a second "telemetry off" code path.
"""
from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path

__all__ = ["Tracer"]


class Tracer:
    """Buffered JSONL span writer (flush on ``close``/``flush`` or every
    ``buffer`` events)."""

    def __init__(
        self,
        path: str | Path | None = None,
        *,
        annotations: bool = False,
        buffer: int = 256,
    ) -> None:
        self.path = Path(path) if path is not None else None
        self.annotations = annotations
        self._buf: list[str] = []
        self._buffer = max(1, buffer)
        self.events_emitted = 0
        if self.path is not None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            # truncate: one trace file per run, not an append-across-runs log
            self.path.write_text("")

    @property
    def enabled(self) -> bool:
        return self.path is not None or self.annotations

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """One traced interval; ``attrs`` must be JSON-able scalars."""
        if not self.enabled:
            yield
            return
        ann = (
            _profiler_annotation(name)
            if self.annotations else contextlib.nullcontext()
        )
        ts = time.time()
        t0 = time.perf_counter()
        try:
            with ann:
                yield
        finally:
            self.emit({
                "name": name, "ts": ts,
                "dur_s": time.perf_counter() - t0, **attrs,
            })

    def emit(self, event: dict) -> None:
        """Record one pre-built event (spans use this internally)."""
        self.events_emitted += 1
        if self.path is None:
            return
        self._buf.append(json.dumps(event))
        if len(self._buf) >= self._buffer:
            self.flush()

    def flush(self) -> None:
        if self.path is None or not self._buf:
            return
        with open(self.path, "a") as fh:
            fh.write("\n".join(self._buf) + "\n")
        self._buf.clear()

    def close(self) -> None:
        self.flush()


def _profiler_annotation(name: str):
    """A ``torch.profiler.record_function`` scope: a labelled range in a
    profile taken around the run, nearly free when none is."""
    from torch.profiler import record_function

    return record_function(name)
