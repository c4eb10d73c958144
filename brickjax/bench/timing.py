"""Timing harness with the reference's protocol and phase taxonomy.

- ``time_func``: geometric repeat until the total wall time passes
  TOT_TIME=5 s, warm-up excluded (ref: stencils/stencils.h:28,40-53).
- ``time_mpi``: fixed MPI_ITER=25 iterations after one warm-up call
  (ref: stencils/fake.h:393-404, weak/main.cpp:39).
- ``PhaseTimers``: the five accumulators packtime/calltime/waittime/
  movetime/calctime (ref: include/brick-mpi.h:23, src/brick-mpi.cpp:7).
  Phases are measured by timing separately-jitted segments with
  block_until_ready (dispatch overlap means phases can sum above the
  fused step time; the fused step is the headline number).
- ``mpi_statistics``: min/avg/max/σ reduction (ref: brick-mpi.h:758-793),
  applied across per-step samples (and across devices when available).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

TOT_TIME = 5.0
MPI_ITER = 25


def _sync(x):
    """Execution barrier: block_until_ready, then read one element
    back (a host round trip that no asynchronous runtime can skip)."""
    if hasattr(x, "block_until_ready"):
        x.block_until_ready()
        try:
            v = x
            while getattr(v, "ndim", 0) > 0:
                v = v[(0,) * v.ndim]
            float(v)
        except TypeError:
            pass
    elif isinstance(x, (tuple, list)):
        for v in x:
            _sync(v)


def time_func(fn, *args, tot_time: float = TOT_TIME,
              chain: bool | None = None, inner: int = 1) -> float:
    """Average seconds per call, geometric repeat until >= tot_time of
    measurement (compile/warm-up excluded).

    When the function maps an array to one of the same shape/dtype, the
    repeat loop CHAINS (out = fn(out)) so every call is data-dependent.
    ``inner`` > 1 additionally wraps ``inner`` chained calls inside ONE
    jit (requires chainability), so per-dispatch host overhead is not
    measured as kernel time."""
    if inner > 1:
        import jax

        base = fn

        def fn(x):
            for _ in range(inner):
                x = base(x)
            return x
        fn = jax.jit(fn)
    out0 = fn(*args)
    _sync(out0)  # warm-up / compile
    if chain is None:
        chain = (len(args) == 1
                 and getattr(out0, "shape", None) == getattr(
                     args[0], "shape", ()) != ()
                 and getattr(out0, "dtype", None) == getattr(
                     args[0], "dtype", None))
    if inner > 1 and not chain:
        raise ValueError("inner>1 needs a chainable array->array fn")
    it = 1
    seed = out0
    while True:
        st = time.perf_counter()
        if chain:
            out = seed
            for _ in range(it):
                out = fn(out)
            seed = out  # donation-safe: never reuse a consumed buffer
        else:
            out = None
            for _ in range(it):
                out = fn(*args)
        _sync(out)
        elapsed = time.perf_counter() - st
        if elapsed >= tot_time or it > 1 << 20:
            return elapsed / it / inner
        it = it * 2 if elapsed < tot_time / 2 else max(
            it + 1, int(it * tot_time / max(elapsed, 1e-9)) + 1)


def time_mpi(fn, *args, iters: int = MPI_ITER,
             chain: bool | None = None) -> tuple[float, list[float]]:
    """(avg seconds, per-iteration samples) after one warm-up call,
    matching the reference protocol (total / MPI_ITER, fake.h:393-404).

    When chainable (array -> same-shape array), the average comes from a
    dependent chain with ONE final barrier — per-iteration barriers cost
    a host round trip each on this runtime and would dominate.  The
    per-sample distribution is then measured in a second, per-iteration-
    synced pass and includes that sync latency (distribution shape only).
    """
    out0 = fn(*args)
    _sync(out0)
    if chain is None:
        chain = (len(args) == 1
                 and getattr(out0, "shape", None) == getattr(
                     args[0], "shape", ()) != ()
                 and getattr(out0, "dtype", None) == getattr(
                     args[0], "dtype", None))
    samples = []
    if chain:
        st = time.perf_counter()
        out = out0
        for _ in range(iters):
            out = fn(out)
        _sync(out)
        avg = (time.perf_counter() - st) / iters
        for _ in range(min(iters, 5)):
            st = time.perf_counter()
            out = fn(out)
            _sync(out)
            samples.append(time.perf_counter() - st)
        return avg, samples
    for _ in range(iters):
        st = time.perf_counter()
        _sync(fn(*args))
        samples.append(time.perf_counter() - st)
    return sum(samples) / len(samples), samples


def mpi_statistics(samples) -> dict:
    """min/avg/max/σ like the reference's pretty-printer
    (brick-mpi.h:758-793)."""
    n = len(samples)
    avg = sum(samples) / n
    var = sum((s - avg) ** 2 for s in samples) / n
    return {"min": min(samples), "avg": avg, "max": max(samples),
            "sigma": math.sqrt(var)}


def device_statistics(fn, make_arg, devices=None, iters: int = 5):
    """Per-device timing spread, reduced like the reference's
    cross-rank ``mpi_statistics`` (brick-mpi.h:758-793).

    SPMD steps are lock-stepped by collectives, so per-device imbalance
    is measured by running the same single-device program placed on
    each device (``make_arg(device)`` commits the input there) — the
    slow-rank detector the reference's reduction exists for.

    Returns (stats dict, per-device averages).
    """
    import jax

    if devices is None:
        devices = jax.devices()
    per = []
    for d in devices:
        avg, _ = time_mpi(fn, make_arg(d), iters=iters)
        per.append(avg)
    return mpi_statistics(per), per


@dataclass
class PhaseTimers:
    """The reference's five-phase taxonomy."""

    packtime: float = 0.0
    calltime: float = 0.0
    waittime: float = 0.0
    movetime: float = 0.0
    calctime: float = 0.0
    samples: dict = field(default_factory=dict)

    def measure(self, name: str, fn, *args, iters: int = MPI_ITER):
        avg, samp = time_mpi(fn, *args, iters=iters)
        setattr(self, name, getattr(self, name) + avg)
        self.samples[name] = samp
        return avg

    def report(self) -> dict:
        out = {}
        for name in ("packtime", "calltime", "waittime", "movetime",
                     "calctime"):
            v = getattr(self, name)
            if name in self.samples:
                out[name] = {"total": v,
                             **mpi_statistics(self.samples[name])}
            elif v:
                out[name] = {"total": v}
        return out
