"""Profiling hooks: jax.profiler traces + named phases.

Device-side equivalent of the reference's two tracing mechanisms (SURVEY.md section
5): PySCF-logger phase timers and line_profiler decoration
(``fftdf-with-k.py:18-19``).  Usage::

    with trace("/tmp/isdf-trace"):       # opens a profiler trace (xprof)
        with phase("build-y"):           # named scope + wall-clock log line
            ...
"""
from __future__ import annotations

import contextlib
import time

import jax

from fftisdf_tpu.utils.logging import Logger

_log = Logger(verbose=3)


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax profiler trace viewable with xprof/tensorboard."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def phase(name: str, log: Logger = None):
    """Named profiler scope + wall-clock log line (ref-style timer UX)."""
    log = log or _log
    t0 = time.perf_counter()
    with jax.profiler.TraceAnnotation(name):
        yield
    log.info("    wall time for %s: %9.3f sec", name, time.perf_counter() - t0)
