"""On-device nested-dissection multifrontal LU (solvers/ndlu.py) — the
on-device analog of the reference's sparse direct dispatch
(src/mm_sol_nonlinear.c:1290-1515 UMFPACK/Amesos)."""

import numpy as np
import jax
import jax.numpy as jnp
import scipy.sparse as sp

from goma_tpu.fem import Problem
from goma_tpu.fem.sparsity import EllOperator, sym_sum_scale
from goma_tpu.mesh import rectangle_mesh
from goma_tpu.physics import Continuity, Momentum
from goma_tpu.solvers import NewtonOptions, NewtonSolver
from goma_tpu.solvers.ndlu import NDLU, zero_diag_defer_mask


def _cavity(n, Re=100.0):
    mesh = rectangle_mesh(n, n, elem="QUAD9")
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    prob = Problem(mesh, [Momentum(dim=2, interp="Q2", transient=False),
                          Continuity(interp="Q1")], {"rho": 1.0, "mu": 1.0 / Re})
    for ns in ("left", "right", "bottom"):
        prob.add_dirichlet(ns, "velocity", 0, 0.0)
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("top", "velocity", 0, 1.0)
    prob.add_dirichlet("top", "velocity", 1, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.finalize()
    return prob


def _saddle_system(n=10):
    """Equilibrated Newton matrix of the NS cavity (zero pressure diagonal:
    the hard static-pivoting case)."""
    prob = _cavity(n)
    x = jnp.zeros(prob.dofmap.n_dof)
    R, vals = prob._assemble(x, prob.base_params())
    pat = prob.pattern
    vals_s, scale = sym_sum_scale(vals, jnp.asarray(pat.rows),
                                  jnp.asarray(pat.indices), pat.n)
    return prob, pat, vals_s, scale * R


def test_ndlu_f64_matches_scipy_on_saddle():
    prob, pat, vals, b = _saddle_system(8)
    nd = NDLU(pat, leaf_max=64, dtype=jnp.float64)
    fac = nd.factor(vals)
    x = np.asarray(nd.solve(fac, b))
    A = sp.csr_matrix((np.asarray(vals), pat.indices, pat.indptr),
                      shape=(pat.n, pat.n))
    xs = sp.linalg.spsolve(A, np.asarray(b))
    assert np.linalg.norm(x - xs) / np.linalg.norm(xs) < 1e-12


def test_ndlu_f32_refinement_recovers_f64():
    """Static-pivoted f32 factorization + 2 refinement sweeps with the f64
    matvec reaches ~f64 backward error (the mixed-precision path)."""
    prob, pat, vals, b = _saddle_system(8)
    nd = NDLU(pat, leaf_max=64, dtype=jnp.float32)
    fac = nd.factor(vals)
    ell = EllOperator(pat)
    mv = lambda v: ell.matvec(vals, v)
    x = nd.solve_refined(fac, b, mv, refine=2)
    r = np.asarray(b - mv(x))
    assert np.linalg.norm(r) / np.linalg.norm(np.asarray(b)) < 1e-12


def test_newton_tpu_direct_matches_host_direct():
    """Full Newton on the cavity with linear_solver='tpu_direct' converges
    with the same iteration count and solution as the host direct path
    (iteration-count parity is the BASELINE metric)."""
    prob = _cavity(8)
    x0 = np.zeros(prob.dofmap.n_dof)
    r_host = NewtonSolver(prob, NewtonOptions(
        max_iter=10, tol_residual=1e-10, linear_solver="direct")).solve(
        x0, prob.base_params())
    r_dev = NewtonSolver(prob, NewtonOptions(
        max_iter=10, tol_residual=1e-10, linear_solver="tpu_direct",
        ndlu_refine=3)).solve(x0, prob.base_params())
    assert r_host.converged and r_dev.converged
    assert r_dev.iters == r_host.iters, (r_dev.summary(), r_host.summary())
    np.testing.assert_allclose(r_dev.x, r_host.x, atol=5e-8)


def test_ndlu_unbalanced_leaf_sizes():
    """Robustness: small leaves + uneven tree (leaf_max below the padding
    class sizes). NOTE: leaves must stay large enough that interior pressure
    dofs keep velocity partners inside their own block — static pivoting
    cannot cross the own/boundary split (see NDLU docstring); leaf_max ~2x
    the per-node dof count is the practical floor for saddle systems."""
    prob, pat, vals, b = _saddle_system(6)
    nd = NDLU(pat, leaf_max=33, dtype=jnp.float64)
    fac = nd.factor(vals)
    x = np.asarray(nd.solve(fac, b))
    A = sp.csr_matrix((np.asarray(vals), pat.indices, pat.indptr),
                      shape=(pat.n, pat.n))
    xs = sp.linalg.spsolve(A, np.asarray(b))
    assert np.linalg.norm(x - xs) / np.linalg.norm(xs) < 1e-11


def test_ndlu_blocked_lu_matches_scipy():
    """Blocked right-looking frontal LU (lu_block smaller than the biggest
    front, so every level goes through _block_lu's panel loop) reproduces
    the plain-LU factorization numerics. Requires the zero-diagonal defer
    ordering: panel pivoting cannot cross bs-block boundaries, so pressure
    rows must come after their velocity partners within each front."""
    prob, pat, vals, b = _saddle_system(8)
    nd = NDLU(pat, leaf_max=64, dtype=jnp.float64, lu_block=16,
              defer_dofs=zero_diag_defer_mask(pat, vals))
    fac = nd.factor(vals)
    x = np.asarray(nd.solve(fac, b))
    A = sp.csr_matrix((np.asarray(vals), pat.indices, pat.indptr),
                      shape=(pat.n, pat.n))
    xs = sp.linalg.spsolve(A, np.asarray(b))
    assert np.linalg.norm(x - xs) / np.linalg.norm(xs) < 1e-11


def test_ndlu_blocked_f32_refined():
    """Blocked f32 factorization + refinement still reaches f64 backward
    error (the bench cavity configuration: lu_block=128, f32, refine)."""
    prob, pat, vals, b = _saddle_system(8)
    nd = NDLU(pat, leaf_max=64, dtype=jnp.float32, lu_block=24,
              defer_dofs=zero_diag_defer_mask(pat, vals))
    fac = nd.factor(vals)
    ell = EllOperator(pat)
    mv = lambda v: ell.matvec(vals, v)
    x = nd.solve_refined(fac, b, mv, refine=3)
    r = np.asarray(b - mv(x))
    assert np.linalg.norm(r) / np.linalg.norm(np.asarray(b)) < 1e-12


def test_ndlu_lagged_factor_transient_reuse():
    """ndlu_lag reuses factors across Newton iterations/time steps when
    refinement against the fresh operator reaches the residual guard, and
    refactors when it cannot — convergence matches the no-lag path (the
    accepted step always satisfies the same inexact-Newton residual bound).
    Reference analog: Aztec AZ_reuse (src/sl_util.c:380)."""
    prob = _cavity(8)
    x0 = np.zeros(prob.dofmap.n_dof)
    s_lag = NewtonSolver(prob, NewtonOptions(
        max_iter=12, tol_residual=1e-10, linear_solver="tpu_direct",
        ndlu_refine=3, ndlu_lag=True))
    s_nol = NewtonSolver(prob, NewtonOptions(
        max_iter=12, tol_residual=1e-10, linear_solver="tpu_direct",
        ndlu_refine=3, ndlu_lag=False))
    r1 = s_lag.solve(x0, prob.base_params())
    r2 = s_nol.solve(x0, prob.base_params())
    assert r1.converged and r2.converged
    np.testing.assert_allclose(r1.x, r2.x, atol=5e-8)
    # second solve from the same start reuses warm factors: fewer fresh
    # factorizations than Newton iterations
    n0 = s_lag._ndlu_nfactor
    r3 = s_lag.solve(x0, prob.base_params())
    assert r3.converged
    assert s_lag._ndlu_nfactor - n0 < r3.iters
    np.testing.assert_allclose(r3.x, r1.x, atol=5e-8)


def test_gmres_with_ndlu_preconditioner():
    """precond="ndlu": GMRES accelerated by the (selective-inversion)
    multifrontal factor — lin its stay small and the solution matches the
    host direct path. Tables flow through the ntab jit args (the
    regression here was oversized traced programs)."""
    prob = _cavity(12)
    x0 = jnp.zeros(prob.dofmap.n_dof)
    s = NewtonSolver(prob, NewtonOptions(
        max_iter=12, tol_residual=1e-8, linear_tol=1e-6, precond="ndlu",
        linear_solver="gmres", gmres_restart=60, linear_maxiter=240))
    r = s.solve(x0, prob.base_params())
    assert r.converged
    assert max(r.linear_iters) <= 60  # near-exact preconditioner
    sd = NewtonSolver(prob, NewtonOptions(max_iter=12, tol_residual=1e-8,
                                          linear_solver="direct"))
    rd = sd.solve(x0, prob.base_params())
    np.testing.assert_allclose(r.x, rd.x, atol=1e-6)


def test_ndlu_invert_solve_matches_substitution():
    """invert=True factors apply through explicit L^-1/U^-1 matmuls; the
    result must match the substitution path to f32 roundoff."""
    from goma_tpu.solvers.ndlu import NDLU, zero_diag_defer_mask
    from goma_tpu.fem.sparsity import sym_sum_scale

    _prob, pat, vals, R = _saddle_system(8)
    dd = zero_diag_defer_mask(pat, vals)
    b = jnp.asarray(np.asarray(R, dtype=np.float64))
    x_ref = None
    for invert in (False, True):
        nd = NDLU(pat, leaf_max=64, dtype=jnp.float64, defer_dofs=dd,
                  invert=invert)
        x = np.asarray(nd.solve(nd.factor(jnp.asarray(vals)), b))
        if x_ref is None:
            x_ref = x
        else:
            np.testing.assert_allclose(x, x_ref, rtol=0, atol=1e-9)


def test_solve_refined_return_rel_and_sweep():
    """return_rel hands back the measured residual of the RETURNED iterate
    (or None if unmeasured); a fused sweep callable gives identical
    results to the matvec path."""
    from goma_tpu.solvers.ndlu import NDLU, zero_diag_defer_mask
    from goma_tpu.fem.sparsity import EllOperator

    _prob, pat, vals, R = _saddle_system(8)
    nd = NDLU(pat, leaf_max=64, dtype=jnp.float32,
              defer_dofs=zero_diag_defer_mask(pat, vals))
    ell = EllOperator(pat)
    v = jnp.asarray(vals)
    b = jnp.asarray(np.asarray(R, dtype=np.float64))
    fac = nd.factor(v)
    mv = lambda x: ell.matvec(v.astype(b.dtype), x)
    x1, rel = nd.solve_refined(fac, b, mv, refine=1, rel_tol=1e-6,
                               max_refine=8, return_rel=True)
    assert rel is None or rel <= 1e-6 * 1.01
    rn = float(jnp.linalg.norm(b - mv(x1)) / jnp.linalg.norm(b))
    assert rn <= 1e-5

    def sweep(facs, bb, x):
        r = bb - mv(x)
        return x + nd.solve(facs, r).astype(bb.dtype), jnp.linalg.norm(r)

    x2, rel2 = nd.solve_refined(fac, b, mv, refine=1, rel_tol=1e-6,
                                max_refine=8, return_rel=True, sweep=sweep)
    np.testing.assert_allclose(np.asarray(x2), np.asarray(x1),
                               rtol=0, atol=1e-10)


def _buoyant(n=6):
    """Multi-field saddle system (momentum+continuity+energy+species — the
    buoyant MES bench shape, 5 dofs on Q2 corner nodes) whose front density
    exposed a leaf_max fragility before clustered bisection)."""
    from goma_tpu.physics import Energy, Species
    from goma_tpu.physics.materials import BoussinesqBodyForce

    mesh = rectangle_mesh(n, n, elem="QUAD9")
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    prob = Problem(mesh, [Momentum(dim=2, transient=False), Continuity(),
                          Energy(interp="Q2", transient=False),
                          Species(n_species=1, interp="Q2", transient=False)],
                   {"rho": 1.0, "mu": 0.71, "k": 1.0, "Cp": 1.0,
                    "diffusivity": 1.0,
                    "body_force": BoussinesqBodyForce([0.0, 710.0], beta=-1.0,
                                                      T0=0.5)})
    for ns in ("left", "right", "top", "bottom"):
        prob.add_dirichlet(ns, "velocity", 0, 0.0)
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("left", "temperature", 0, 1.0)
    prob.add_dirichlet("right", "temperature", 0, 0.0)
    prob.add_dirichlet("left", "species", 0, 1.0)
    prob.add_dirichlet("right", "species", 0, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.finalize()
    # operating-point Jacobian (nonzero T couples the Boussinesq block)
    rng = np.random.RandomState(0)
    x = jnp.asarray(0.01 * rng.randn(prob.dofmap.n_dof))
    R, vals = prob._assemble(x, prob.base_params())
    pat = prob.pattern
    vals_s, scale = sym_sum_scale(vals, jnp.asarray(pat.rows),
                                  jnp.asarray(pat.indices), pat.n)
    return prob, pat, vals_s, scale * R


def test_ndlu_clusters_keep_node_dofs_in_one_front():
    """Structural guarantee of the clustered bisection: every mesh node's
    dofs (velocity + pressure + scalars) land in the SAME tree node's own
    block, so a saddle (pressure) row always has its conjugate momentum
    rows available for the defer-ordered unpivoted elimination. This is
    the robustness fix replacing per-deck leaf_max tuning."""
    from goma_tpu.solvers.ndlu import node_clusters

    for mk in (_cavity, lambda n: _buoyant(n)[0]):
        prob = mk(6)
        nd = NDLU(prob.pattern, leaf_max=96, dtype=jnp.float64,
                  clusters=node_clusters(prob))
        owner = np.full(prob.pattern.n, -1, dtype=np.int64)
        tid = 0
        for lev in nd.levels:
            for q in range(lev.own_w.shape[0]):
                o = lev.own_w[q]
                owner[o[o < prob.pattern.n]] = tid
                tid += 1
        assert np.all(owner >= 0)
        dm = prob.dofmap
        for nd_i in np.flatnonzero(np.asarray(dm.node_dof_count) > 1):
            s = int(dm.node_dof_start[nd_i])
            c = int(dm.node_dof_count[nd_i])
            assert len(set(owner[s:s + c])) == 1, f"node {nd_i} split"


def test_ndlu_cluster_leaf_sweep():
    """The multi-field saddle system factors
    and solves correctly at every leaf size in {64,96,192,256} with the
    clustered bisection + defer ordering + f32 refinement — no per-deck
    leaf_max tuning."""
    from goma_tpu.solvers.ndlu import node_clusters

    prob, pat, vals, b = _buoyant(6)
    ell = EllOperator(pat)
    mv = lambda v: ell.matvec(vals, v)
    cl = node_clusters(prob)
    dd = zero_diag_defer_mask(pat, np.asarray(vals))
    for leaf in (64, 96, 192, 256, 384):
        nd = NDLU(pat, leaf_max=leaf, dtype=jnp.float32, defer_dofs=dd,
                  clusters=cl)
        x = nd.solve_refined(nd.factor(vals), b, mv, refine=3)
        r = np.asarray(b - mv(x))
        rel = np.linalg.norm(r) / np.linalg.norm(np.asarray(b))
        assert rel < 1e-10, f"leaf_max={leaf}: rel={rel}"


def test_row_sums_ell_matches_segment_sum():
    """Scatter-free ELL row sums == segment_sum row sums."""
    from goma_tpu.fem.sparsity import EllOperator, row_sums_ell

    _prob, pat, vals, _ = _saddle_system(6)
    ell = EllOperator(pat)
    rs = np.asarray(row_sums_ell(jnp.asarray(vals),
                                 ell.tables["pos"]))
    import jax as _jax
    ref = np.asarray(_jax.ops.segment_sum(jnp.abs(jnp.asarray(vals)),
                                          jnp.asarray(pat.rows),
                                          num_segments=pat.n))
    np.testing.assert_allclose(rs, ref, rtol=1e-6, atol=1e-12)
