"""Global numeric configuration.

The reference (Goma) is double-precision everywhere. The framework carries
an explicit working dtype, so a deck can run in float64 or float32:

- float64 requires ``jax.config.update("jax_enable_x64", True)`` (tests, the
  CLI's ``--x64``, the benchmark and the smoke test enable it);
- the Jacobian and Krylov dtype can be set apart from it
  (``Problem.jacobian_dtype``): f64 residuals with f32 Jacobians.
"""

from __future__ import annotations

import jax.numpy as jnp

_FP_DTYPE = jnp.float64


def set_fp_dtype(dtype) -> None:
    global _FP_DTYPE
    _FP_DTYPE = jnp.dtype(dtype)


def fp_dtype():
    """Working floating dtype. Falls back to f32 when x64 is disabled."""
    import jax

    if _FP_DTYPE == jnp.float64 and not jax.config.jax_enable_x64:
        return jnp.dtype(jnp.float32)
    return jnp.dtype(_FP_DTYPE)
