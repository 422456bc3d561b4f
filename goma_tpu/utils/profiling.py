"""Profiling helpers: jax.profiler traces around solver phases.

Parity-plus: the reference carries only coarse wall timers
(``src/md_timer.c:82 ut()``, the asm/solve split in
``src/mm_sol_nonlinear.c``) — those exist here as NewtonResult's
assembly_time/solve_time. This module adds the device deep view: an
XLA trace viewable in TensorBoard (or Perfetto) with named phase
annotations, so per-kernel device behavior of a Newton step can be
inspected.

    from goma_tpu.utils.profiling import trace, annotate

    with trace("/tmp/goma_trace"):
        with annotate("newton-iter"):
            solver.solve(x, params)
"""

from __future__ import annotations

from contextlib import contextmanager


@contextmanager
def trace(logdir: str, create_perfetto_link: bool = False):
    """Capture a jax.profiler trace of the enclosed block into ``logdir``
    (open with TensorBoard's profile plugin or ui.perfetto.dev)."""
    import jax

    jax.profiler.start_trace(logdir,
                             create_perfetto_link=create_perfetto_link)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region inside a trace (shows as a band in the trace viewer).
    Usable as a context manager; nests freely."""
    import jax

    return jax.profiler.TraceAnnotation(name)


def device_memory_profile(path: str) -> None:
    """Dump the current device memory profile (pprof format) to ``path`` —
    the device analog of watching the reference's heap with massif."""
    import jax

    with open(path, "wb") as f:
        f.write(jax.profiler.device_memory_profile())
