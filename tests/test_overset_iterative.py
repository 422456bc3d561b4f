"""Constraint-aware (multiplier-in-block Schwarz) preconditioning: overset
Lagrange-multiplier saddles converge ITERATIVELY — the round-1 gap where
zero-diagonal lambda rows broke every preconditioner and forced
linear_solver='direct'."""

import numpy as np
import jax.numpy as jnp
import pytest

from goma_tpu.solvers import NewtonOptions, NewtonSolver


def test_overset_couette_gmres_matches_direct():
    import sys
    import os
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_overset import couette_overset

    # direct reference
    mesh, prob, res_d = couette_overset(y_c=0.3, ny=10)

    # iterative: auto precond resolves to constraint-aware Vanka with the
    # overset row-gathers as extra Schwarz blocks
    from test_overset import OPTS  # noqa: F401  (same deck rebuild below)
    from goma_tpu.mesh import rectangle_mesh
    from goma_tpu.mesh.immersed import polyline_block
    from goma_tpu.fem import Problem
    from goma_tpu.physics import Continuity, Momentum
    from goma_tpu.physics.overset import OversetLM, OversetNoSlip

    U_s, U_top, mu, y_c, nseg, ny = 0.4, 1.0, 0.7, 0.3, 7, 10
    mesh = rectangle_mesh(4, ny, elem="QUAD9", xlim=(0, 0.8), ylim=(0, 1))
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    line = np.stack([np.linspace(0, 0.8, nseg + 1),
                     np.full(nseg + 1, y_c)], axis=1)
    bi = polyline_block(mesh, line, name="wall")
    prob2 = Problem(
        mesh,
        [[Momentum(dim=2, interp="Q2", transient=False, convection=False),
          Continuity(interp="Q1")], [OversetLM(dim=2)]],
        [{"rho": 1.0, "mu": mu}, {}])
    prob2.add_dirichlet("top", "velocity", 0, U_top)
    prob2.add_dirichlet("bottom", "velocity", 0, 0.0)
    for ns in ("top", "bottom", "left", "right"):
        prob2.add_dirichlet(ns, "velocity", 1, 0.0)
    prob2.add_dirichlet("pin", "pressure", 0, 0.0)
    prob2.add_overset(bi, 0, OversetNoSlip(
        dim=2, u_target=lambda x, params: jnp.asarray([U_s, 0.0])))
    prob2.finalize()

    solver = NewtonSolver(prob2, NewtonOptions(
        max_iter=8, tol_residual=1e-10, linear_solver="gmres",
        precond="auto", linear_tol=1e-10, gmres_restart=120,
        linear_maxiter=3000, forcing="fixed", precond_lag=False))
    assert solver._precond_kind in ("vanka", "twolevel")
    res_i = solver.solve(np.zeros(prob2.dofmap.n_dof), prob2.base_params())
    assert res_i.converged, res_i.summary()
    # direct-solve iteration parity modulo one cleanup step (the linear
    # problem converges in 1 direct solve; GMRES at 1e-10 may leave a
    # ~1e-7 residue that one extra cheap iteration removes)
    assert res_i.iters <= res_d.iters + 1
    np.testing.assert_allclose(res_i.x, res_d.x, atol=1e-6)
    # and the Krylov solves actually converged (not maxed out)
    assert all(li < 3000 for li in res_i.linear_iters)


def test_immersed_cylinder_example_iterative():
    """The immersed-cylinder deck (moving overset geometry) converges with
    GMRES + constraint-aware Vanka."""
    from goma_tpu.mesh import rectangle_mesh
    from goma_tpu.mesh.immersed import circle_block
    from goma_tpu.fem import Problem
    from goma_tpu.physics import Continuity, Momentum
    from goma_tpu.physics.overset import OversetLM, OversetNoSlip

    mesh = rectangle_mesh(10, 6, elem="QUAD9", xlim=(0, 2.0), ylim=(0, 1.2))
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    bi = circle_block(mesh, center=(0.7, 0.6), radius=0.22, n=24,
                      name="cyl")
    prob = Problem(
        mesh,
        [[Momentum(dim=2, interp="Q2", transient=False, convection=False),
          Continuity(interp="Q1")], [OversetLM(dim=2)]],
        [{"rho": 1.0, "mu": 0.05}, {}])
    prob.add_dirichlet("left", "velocity", 0, 1.0)
    prob.add_dirichlet("left", "velocity", 1, 0.0)
    for ns in ("top", "bottom"):
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.add_overset(bi, 0, OversetNoSlip(
        dim=2, u_target=lambda x, params: jnp.zeros(2)))
    prob.finalize()

    res_d = NewtonSolver(prob, NewtonOptions(
        max_iter=6, tol_residual=1e-9, linear_solver="direct")).solve(
        np.zeros(prob.dofmap.n_dof), prob.base_params())
    res_i = NewtonSolver(prob, NewtonOptions(
        max_iter=6, tol_residual=1e-9, linear_solver="gmres", precond="auto",
        linear_tol=1e-9, gmres_restart=160, linear_maxiter=4000,
        forcing="fixed", precond_lag=False)).solve(
        np.zeros(prob.dofmap.n_dof), prob.base_params())
    assert res_d.converged and res_i.converged
    # closed immersed contours keep an unconstrained fictitious interior:
    # the Krylov solves converge more slowly there, costing at most one
    # cleanup Newton iteration vs the direct path
    assert res_i.iters <= res_d.iters + 1
    np.testing.assert_allclose(res_i.x, res_d.x, atol=1e-3)
