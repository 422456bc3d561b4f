"""jax.profiler integration (device deep tracing; reference has only
coarse ut() wall timers)."""

import glob


def test_trace_and_memory_profile(tmp_path):
    import jax.numpy as jnp

    from goma_tpu.utils.profiling import (annotate, device_memory_profile,
                                          trace)

    d = str(tmp_path / "tr")
    with trace(d):
        with annotate("matmul"):
            (jnp.ones((64, 64)) @ jnp.ones((64, 64))).block_until_ready()
    assert glob.glob(d + "/**/*", recursive=True)
    p = tmp_path / "mem.pprof"
    device_memory_profile(str(p))
    assert p.stat().st_size > 0
