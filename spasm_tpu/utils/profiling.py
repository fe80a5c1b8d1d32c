"""Structured profiling hooks (SURVEY.md section 5: the reference has only
wall-clock stderr lines; device runs want real traces).

``phase("name")`` is a nestable timer whose records accumulate in
``phase_records`` (and echo through the log sink when verbose);
``trace(dir)`` wraps jax.profiler for XLA-level traces viewable in
TensorBoard / Perfetto."""

from __future__ import annotations

import contextlib
import time

from .logging import log

phase_records: list[tuple[str, float]] = []


@contextlib.contextmanager
def phase(name: str):
    t0 = time.time()
    try:
        yield
    finally:
        dt = time.time() - t0
        phase_records.append((name, dt))
        log(f"[profile] {name}: {dt:.3f}s")


def reset_phases():
    phase_records.clear()


@contextlib.contextmanager
def trace(logdir: str):
    """XLA-level profiler trace around a region."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
