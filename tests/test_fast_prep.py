"""Vals-free fast prep (Problem._assemble_fast + NewtonSolver fast path).

The iterative hot path computes row-scaled norms / equilibration from
element-level row sums and materializes CSR values only on preconditioner
refactor. These tests pin (a) the residual is bit-identical to the full
path, (b) the element row sums upper-bound and closely track the assembled
row sums, and (c) Newton TRAJECTORIES (iteration counts, linear iteration
counts, residual-norm sequence) match the full-prep path — the reference
parity property (src/mm_sol_nonlinear.c:972 row_sum_scaling +
:1106 norms) that makes the approximation admissible.
"""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from goma_tpu.fem import Problem
from goma_tpu.mesh import rectangle_mesh
from goma_tpu.physics import Continuity, Momentum
from goma_tpu.solvers import NewtonOptions, NewtonSolver

from tests.test_cavity import cavity_problem


def _rand_x(prob, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.normal(size=prob.dofmap.n_dof) * 0.1)


def test_fast_assembly_matches_full():
    _, prob = cavity_problem(n=6, Re=50.0)
    params = prob.base_params()
    x = _rand_x(prob)
    R_full, vals, _ = prob._assemble_with_elem(x, params)
    R_fast, rs, aux = prob._assemble_fast(x, params)
    np.testing.assert_allclose(np.asarray(R_fast), np.asarray(R_full),
                               rtol=0, atol=1e-14)
    # element-level row sums: exact upper bound of the assembled row sums,
    # tight for the Galerkin-dominated rows
    import scipy.sparse as sp

    pat = prob.pattern
    A = sp.csr_matrix((np.asarray(vals), np.asarray(pat.indices),
                       np.asarray(pat.indptr)),
                      shape=(prob.dofmap.n_dof, prob.dofmap.n_dof))
    rs_true = np.abs(A).sum(axis=1).A1
    rs_fast = np.asarray(rs)
    assert np.all(rs_fast + 1e-12 >= rs_true)
    live = rs_true > 0
    ratio = rs_fast[live] / rs_true[live]
    # tightness: most rows essentially exact; no row inflated beyond a
    # small factor (advection / div-constraint sign cancellation)
    assert np.median(ratio) < 1.35
    assert ratio.max() < 5.0


def _solve(prob, fast, **kw):
    opts = NewtonOptions(max_iter=15, tol_residual=1e-9, linear_tol=1e-10,
                         gmres_restart=100, linear_maxiter=2000, **kw)
    s = NewtonSolver(prob, opts)
    if not fast:
        s._fast_prep = False
    else:
        assert s._fast_prep, "fast prep should engage on this deck"
    x0 = np.zeros(prob.dofmap.n_dof)
    return s.solve(x0, prob.base_params())


def test_newton_trajectory_parity_cavity():
    _, prob = cavity_problem(n=8, Re=100.0)
    r_full = _solve(prob, fast=False)
    r_fast = _solve(prob, fast=True)
    assert r_fast.converged and r_full.converged
    assert r_fast.iters == r_full.iters
    for (a, b) in zip(r_fast.res_norms, r_full.res_norms):
        # row-scaled norms differ only through the rs approximation
        assert a[1] == pytest.approx(b[1], rel=0.3)
    # unscaled trajectory: same quadratic tail
    assert r_fast.res_norms[-1][1] < 1e-9


def test_newton_trajectory_parity_ndlu_precond():
    _, prob = cavity_problem(n=8, Re=100.0)
    r_fast = _solve(prob, fast=True, precond="ndlu", ndlu_leaf_max=96,
                    precond_lag=True)
    r_full = _solve(prob, fast=False, precond="ndlu", ndlu_leaf_max=96,
                    precond_lag=True)
    assert r_fast.converged and r_full.converged
    assert r_fast.iters == r_full.iters
    # the slightly different equilibration (element rs vs assembled rs)
    # may shift Krylov counts by ~1 per step, never more
    for a, b in zip(r_fast.linear_iters, r_full.linear_iters):
        assert abs(a - b) <= 2, (r_fast.linear_iters, r_full.linear_iters)


def test_fast_prep_point_constraint_rows():
    """A deck with point (collocated) constraints engages the dg row sums."""
    from goma_tpu.bc.pointwise import plane

    mesh = rectangle_mesh(4, 4, elem="QUAD9")
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    eqs = [Momentum(dim=2, interp="Q2"), Continuity(interp="Q1")]
    prob = Problem(mesh, eqs, {"rho": 1.0, "mu": 1.0})
    for ns in ("left", "right", "bottom", "top"):
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("left", "velocity", 0, 1.0)
    prob.add_dirichlet("right", "velocity", 0, 1.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    # collocated constraint on u at the top nodes (exercises pc rows)
    prob.add_point_constraint("top", "velocity", 0,
                              lambda q, X, p: q[0] - 1.0)
    prob.finalize()
    x = _rand_x(prob, seed=1)
    params = prob.base_params()
    R_full, _, _ = prob._assemble_with_elem(x, params)
    R_fast, rs, _ = prob._assemble_fast(x, params)
    np.testing.assert_allclose(np.asarray(R_fast), np.asarray(R_full),
                               rtol=0, atol=1e-14)
    assert np.all(np.asarray(rs) > 0)


def test_prep32_switched_precision_newton():
    """Switched-precision prep (opts.prep32_tol): early iterations prep
    entirely at jacobian_dtype (one fused residual+Jacobian pass that
    skips the separate f64 residual), the endgame re-preps at
    full precision. Must reproduce the full-precision path's iteration
    count and solution; convergence is only declared from f64 norms."""
    import dataclasses

    _, prob = cavity_problem(8)
    prob.jacobian_dtype = jnp.float32
    x0 = jnp.zeros(prob.dofmap.n_dof, dtype=prob.dtype)
    base = NewtonOptions(max_iter=20, tol_residual=1e-9, linear_tol=1e-6,
                         precond="twolevel", gmres_restart=120,
                         linear_maxiter=400)
    sw = dataclasses.replace(base, prep32_tol=1e-4)
    r0 = NewtonSolver(prob, base).solve(x0, prob.base_params())
    r1 = NewtonSolver(prob, sw).solve(x0, prob.base_params())
    assert r0.converged and r1.converged
    assert r1.iters == r0.iters
    # same root: the switched path must land on the same solution
    np.testing.assert_allclose(r1.x, r0.x, rtol=0, atol=1e-9)
    # norms agree to f32 accuracy while above the switch threshold (below
    # it, tiny step differences compound and the absolute values are in
    # the sub-tolerance noise — only the root and iter count must match)
    for (a1, a2, a3), (b1, b2, b3) in zip(r0.res_norms, r1.res_norms):
        if a2 < 1e-4:
            break
        assert abs(a2 - b2) <= 1e-4 * max(a2, 1e-30)
    # final f64 norm actually below tol (not an f32-noise-floor readout)
    assert r1.res_norms[-1][1] < 1e-9
