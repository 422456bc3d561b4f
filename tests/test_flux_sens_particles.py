"""Flux sensitivities + inertial particle dynamics (parity sweep items;
reference src/mm_flux.c:5792 evaluate_flux_sens and
src/ac_particles.c:4205 INERTIAL_TRACER_IMPLICIT)."""

import numpy as np
import jax.numpy as jnp

from goma_tpu.fem import Problem
from goma_tpu.mesh import rectangle_mesh
from goma_tpu.physics import Energy
from goma_tpu.solvers import NewtonOptions, NewtonSolver


def test_flux_sensitivity_linear_source():
    """-k lap T = p on the unit square, T=0 on the boundary: every flux is
    linear in p, so dF/dp must equal F(p)/p exactly."""
    from goma_tpu.post import heat_flux, sideset_integral
    from goma_tpu.post.postproc import flux_sensitivity

    mesh = rectangle_mesh(8, 8, elem="QUAD9")
    prob = Problem(
        mesh,
        [Energy(interp="Q2", transient=False, convection=False)],
        {"k": 1.0, "heat_source": lambda fv, mat, params: params["p"]},
    )
    for ns in ("left", "right", "top", "bottom"):
        prob.add_dirichlet(ns, "temperature", 0, 0.0)
    prob.finalize()
    p0 = 2.5
    params = prob.base_params(p=jnp.asarray(p0, dtype=prob.dtype))
    res = NewtonSolver(prob, NewtonOptions(max_iter=5, linear_solver="direct")
                       ).solve(np.zeros(prob.dofmap.n_dof), params)
    assert res.converged
    F = sideset_integral(prob, "top", heat_flux)
    F0 = float(F(jnp.asarray(res.x), params))
    dF = float(flux_sensitivity(prob, F, res.x, params, "p"))
    assert abs(F0) > 1e-3  # nontrivial flux
    np.testing.assert_allclose(dF, F0 / p0, rtol=1e-8)


def test_flux_sensitivity_fd_check():
    """Nonlinear case (k depends on p too): AD sensitivity matches central
    finite differences of the re-solved flux."""
    from goma_tpu.post import heat_flux, sideset_integral
    from goma_tpu.post.postproc import flux_sensitivity

    mesh = rectangle_mesh(6, 6, elem="QUAD9")

    def kfun(fv, mat, params):
        return params["p"] ** 2 + 0.5

    prob = Problem(
        mesh,
        [Energy(interp="Q2", transient=False, convection=False)],
        {"k": kfun, "heat_source": lambda fv, mat, params: params["p"]},
    )
    for ns in ("left", "right", "top", "bottom"):
        prob.add_dirichlet(ns, "temperature", 0, 0.0)
    prob.finalize()

    def solve_flux(pv):
        params = prob.base_params(p=jnp.asarray(pv, dtype=prob.dtype))
        res = NewtonSolver(prob, NewtonOptions(max_iter=8, linear_solver="direct")
                           ).solve(np.zeros(prob.dofmap.n_dof), params)
        assert res.converged
        F = sideset_integral(prob, "top", heat_flux)
        return res, params, F

    p0 = 1.3
    res, params, F = solve_flux(p0)
    dF = float(flux_sensitivity(prob, F, res.x, params, "p"))
    h = 1e-5
    rp, pp, Fp_fn = solve_flux(p0 + h)
    rm, pm, Fm_fn = solve_flux(p0 - h)
    Fp = float(Fp_fn(jnp.asarray(rp.x), pp))
    Fm = float(Fm_fn(jnp.asarray(rm.x), pm))
    np.testing.assert_allclose(dF, (Fp - Fm) / (2 * h), rtol=1e-5)


def test_inertial_particle_terminal_velocity():
    """Quiescent fluid + gravity: the particle must relax to the Stokes
    terminal velocity v_t = m g / (6 pi mu a) with the analytic exponential
    approach (linear drag, Re_p correction -> 1 as rho_f = 0)."""
    from goma_tpu.physics import Continuity, Momentum
    from goma_tpu.post.particles import trace_inertial_particles

    mesh = rectangle_mesh(4, 4, elem="QUAD9", xlim=(0, 10), ylim=(-1000, 10))
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    prob = Problem(mesh, [Momentum(dim=2, interp="Q2", transient=False),
                          Continuity(interp="Q1")], {"rho": 1.0, "mu": 1.0})
    for ns in ("left", "right", "bottom", "top"):
        prob.add_dirichlet(ns, "velocity", 0, 0.0)
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.finalize()
    x = np.zeros(prob.dofmap.n_dof)  # quiescent: u = 0, p = 0 is the solution

    a, rho_p, mu = 0.1, 8.0, 0.05
    g = -980.0
    m = rho_p * 4.0 / 3.0 * np.pi * a**3
    C = 6.0 * np.pi * mu * a
    v_t = m * g / C
    tau = m / C
    tr = trace_inertial_particles(
        prob, x, np.array([[5.0, 5.0]]), t_end=8 * tau, dt=tau / 200,
        radius=a, rho_p=rho_p, mu=mu, rho_f=0.0, gravity=(0.0, g),
    )
    assert tr.alive[0]
    v_end = tr.velocities[-1, 0, 1]
    np.testing.assert_allclose(v_end, v_t * (1 - np.exp(-8.0)), rtol=2e-2)
    # position: analytic x(t) = v_t (t - tau (1 - e^{-t/tau}))
    t = tr.times[-1]
    y_exact = 5.0 + v_t * (t - tau * (1 - np.exp(-t / tau)))
    np.testing.assert_allclose(tr.positions[-1, 0, 1], y_exact, rtol=2e-2)


def test_inertial_particle_pressure_gradient_buoyancy():
    """Hydrostatic pressure field grad p = rho_f g (p = rho_f g y, g < 0)
    with zero velocity: the pressure-gradient force is -V grad p = V rho_f
    |g| upward (buoyancy), so a density-matched particle (rho_p = rho_f)
    feels zero net force and stays put."""
    from goma_tpu.physics import Continuity, Momentum
    from goma_tpu.post.particles import trace_inertial_particles

    mesh = rectangle_mesh(4, 4, elem="QUAD9", xlim=(0, 10), ylim=(0, 10))
    prob = Problem(mesh, [Momentum(dim=2, interp="Q2", transient=False),
                          Continuity(interp="Q1")], {"rho": 1.0, "mu": 1.0})
    prob.finalize()
    rho_f, g = 2.0, -980.0
    x = np.zeros(prob.dofmap.n_dof)
    dm = prob.dofmap
    dp = dm.dof_of_node_svar[:, dm.svar("pressure")]
    ok = dp >= 0
    x[dp[ok]] = rho_f * g * mesh.coords[ok, 1]

    tr = trace_inertial_particles(
        prob, x, np.array([[5.0, 5.0]]), t_end=0.05, dt=1e-4,
        radius=0.1, rho_p=rho_f, mu=0.05, rho_f=rho_f, gravity=(0.0, g),
    )
    assert tr.alive[0]
    np.testing.assert_allclose(tr.positions[-1, 0], [5.0, 5.0], atol=1e-6)
    np.testing.assert_allclose(tr.velocities[-1, 0], [0.0, 0.0], atol=1e-6)
