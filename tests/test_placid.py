"""PLACID surface-site solver vs exact Langmuir / deposition solutions.

Reference: ``src/mm_placid.c:165`` — pseudo-steady surface site fractions
(production = 0 per site species, sum-to-one per phase, bulk fractions
proportional to growth rates), damped pseudo-transient Newton.
"""

import jax.numpy as jnp
import numpy as np

from goma_tpu.physics.kinetics import _UNITS
from goma_tpu.physics.placid import (BULK_DEPOSITION, SFLUX_INITIALIZE,
                                     SFLUX_RESIDUAL, SurfaceMechanism,
                                     placid, surface_kinetics_flux)

R = _UNITS["si"][0]


def _langmuir_mech(kf=2.0, kr=0.5):
    # species [A(g) | S, A(s)]; A + S <-> A(s) as forward + reverse rows
    return SurfaceMechanism(
        nu=[[-1, -1, 1], [1, 1, -1]],
        A=[kf, kr],
        n_gas=1, phases=[("site", 2)], sden0=[3.0])


def test_langmuir_isotherm():
    """Steady coverage theta = K c/(1+K c), K = kf/kr; zero net gas flux."""
    kf, kr = 2.0, 0.5
    mech = _langmuir_mech(kf, kr)
    T, P, X = 300.0, 101325.0, 0.4
    c = X * P / (R * T)
    K = kf / kr
    theta = K * c / (1 + K * c)
    z, sd, conv = placid(mech, SFLUX_INITIALIZE, BULK_DEPOSITION,
                         1.0, jnp.array([X]), T, P,
                         jnp.array([0.5, 0.5]))
    assert bool(conv)
    np.testing.assert_allclose(float(z[1]), theta, rtol=1e-8)
    np.testing.assert_allclose(float(z[0]), 1 - theta, rtol=1e-8)
    assert abs(float(sd[0])) < 1e-10 * kf * c * 3.0  # equilibrium: no flux


def test_langmuir_vmap_batch():
    """vmap over gas compositions reproduces the full isotherm curve —
    the batched analog of the reference's per-point LAPACK loop."""
    import jax

    kf, kr = 2.0, 0.5
    mech = _langmuir_mech(kf, kr)
    T, P = 300.0, 101325.0
    Xs = np.linspace(0.05, 0.9, 8)
    cs = Xs * P / (R * T)
    K = kf / kr
    theta = K * cs / (1 + K * cs)
    sv = jax.vmap(lambda Xg: placid(mech, SFLUX_INITIALIZE, BULK_DEPOSITION,
                                    1.0, jnp.array([Xg]), T, P,
                                    jnp.array([0.5, 0.5])))
    z, _, conv = sv(jnp.asarray(Xs))
    assert bool(jnp.all(conv))
    np.testing.assert_allclose(np.asarray(z[:, 1]), theta, rtol=1e-7)


def test_bulk_deposition_fractions():
    """Two bulk species deposited from the adsorbed state at rates k1,k2:
    converged bulk mole fractions are the growth-rate ratios (reference
    BULK_DEPOSITION rows: x_i GR = sdot_i)."""
    kf, kr, k1, k2 = 5.0, 0.5, 0.3, 0.9
    # species [A(g) | S, A(s) | B1, B2]
    mech = SurfaceMechanism(
        nu=[[-1, -1, 1, 0, 0],    # adsorption
            [1, 1, -1, 0, 0],     # desorption
            [0, 1, -1, 1, 0],     # A(s) -> B1 + S
            [0, 1, -1, 0, 1]],    # A(s) -> B2 + S
        A=[kf, kr, k1, k2],
        n_gas=1, phases=[("site", 2), ("bulk", 2)], sden0=[2.0])
    T, P, X = 300.0, 101325.0, 0.3
    z, sd, conv = placid(mech, SFLUX_INITIALIZE, BULK_DEPOSITION,
                         1.0, jnp.array([X]), T, P,
                         jnp.array([0.5, 0.5, 0.5, 0.5]))
    assert bool(conv)
    # site balance with the deposition sink: theta/(1-theta)=kf c/(kr+k1+k2)
    c = X * P / (R * T)
    Kp = kf * c / (kr + k1 + k2)
    theta = Kp / (1 + Kp)
    np.testing.assert_allclose(float(z[1]), theta, rtol=1e-7)
    # bulk fractions = deposition-rate ratios
    np.testing.assert_allclose(float(z[2]), k1 / (k1 + k2), rtol=1e-7)
    np.testing.assert_allclose(float(z[3]), k2 / (k1 + k2), rtol=1e-7)
    # site-phase fractions sum to one
    np.testing.assert_allclose(float(z[0] + z[1]), 1.0, rtol=1e-10)


def test_surface_kinetics_flux_closure():
    """YFLUX-style closure: net gas production at the wall matches the
    analytic adsorption-desorption imbalance at the FROZEN coverage the
    solve converges to (equilibrium -> ~0 flux)."""
    from types import SimpleNamespace

    mech = _langmuir_mech()
    fl = surface_kinetics_flux(mech, species_ids=[0], time_scale=1.0,
                               pressure=101325.0, mode=SFLUX_INITIALIZE)
    sfv = SimpleNamespace(val={
        "species": jnp.array([[0.4], [0.1]]),
        "temperature": jnp.array([[300.0], [300.0]]),
    })
    q = fl(sfv, {}, {})
    assert q.shape == (2, 1)
    assert np.all(np.abs(np.asarray(q)) < 1e-8)  # equilibrium surface
