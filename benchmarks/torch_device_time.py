"""Times of a call on the card: CUDA events around it, and its device time
from torch.profiler. One implementation for the port's benchmarks,
``chip_smoke.py`` and the timers under ``tools/``.

It imports torch and nothing of the port, so that a timer which puts
another tree's ``src`` on the path (``tools/*_time.py --src``) times that
tree's code.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

# sessions run past those asked for, where some saw nothing at all
EXTRA_SESSIONS = 4


def events_ms(fn, reps: int) -> float:
    """ms of one call by CUDA events around ``reps`` calls, after one: the
    card's time with the host's enqueue gaps between launches included."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


Session = tuple[dict[str, tuple[float, int]], float]


def profile_sessions(fn, *, calls: int, sessions: int = 1, warmup: int = 1,
                     needs: tuple[str, ...] = ()) -> list[Session]:
    """``sessions`` torch.profiler sessions of ``calls`` calls each, after
    ``warmup`` calls: for each, ({kernel name: (mean µs of a launch,
    launches seen)}, host wall µs of one call). The profiler now and then
    drops some launches from a session, and now and then all of them (seen
    late in a long process): a session that saw no launch of a kernel whose
    name holds one of ``needs`` (of any kernel, where ``needs`` is empty) is
    run again, up to ``EXTRA_SESSIONS`` more in all. ``RuntimeError`` where
    none saw them."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(sessions + EXTRA_SESSIONS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e6 / calls
        by = {e.key: (e.self_device_time_total / e.count, e.count)
              for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.count > 0}
        if by and all(any(k in name for name in by) for k in needs):
            out.append((by, wall))
        if len(out) == sessions:
            return out
    if not out:
        raise RuntimeError("torch.profiler saw nothing run on the card")
    return out


def per_call_us(by: dict[str, tuple[float, int]], calls: int) -> dict[str, float]:
    """µs of one call by kernel, from a session of ``calls`` calls: a
    kernel's mean duration once for each launch a call makes, so that a
    launch the profiler dropped does not shorten the call."""
    return {name: mean * math.ceil(n / calls) for name, (mean, n) in by.items()}


def device_us(fn, *, warmup: int = 2, calls: int = 10, sessions: int = 5) -> float:
    """Median device time of one call of ``fn``, in µs, over ``sessions``
    sessions of ``calls`` calls: the sum of the durations of everything it
    ran on the card, which the code sets, without the host's enqueue gaps
    that CUDA events count."""
    runs = profile_sessions(fn, calls=calls, sessions=sessions, warmup=warmup)
    return float(np.median([sum(per_call_us(by, calls).values()) for by, _ in runs]))


def profiled(fn, reps: int) -> tuple[float, float, dict[str, float]]:
    """(device ms of one call, host wall ms of one call, device ms of one
    call by kernel, each name cut to 60 characters) from one session of
    ``reps`` calls: the form the timers under ``tools/`` print."""
    ((by, wall),) = profile_sessions(fn, calls=reps)
    ms: dict[str, float] = {}
    for name, us in per_call_us(by, reps).items():
        ms[name[:60]] = ms.get(name[:60], 0.0) + us / 1e3
    return sum(ms.values()), wall / 1e3, ms
