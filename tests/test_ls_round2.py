"""Level-set round 2: volume-preserving renormalization (HUYGENS_MASS_ITER
parity) + XFEM pressure enrichment (load_xfem_for_elem parity)."""

import numpy as np
import jax.numpy as jnp
import pytest

from goma_tpu.fem import Problem
from goma_tpu.mesh import rectangle_mesh
from goma_tpu.physics import (Continuity, CSFSurfaceTension, FillEquation,
                              Momentum, XFEMPressureContinuity,
                              XFEMPressureMomentum, renormalize,
                              renormalize_mass)
from goma_tpu.physics.level_set import FILL_VAR, ls_volume
from goma_tpu.solvers import NewtonOptions, NewtonSolver


def test_renormalize_mass_preserves_volume():
    """A distorted circle field: plain redistancing shifts the enclosed
    smoothed volume; the MASS_ITER variant restores it to ~1e-10."""
    mesh = rectangle_mesh(24, 24, elem="QUAD9", xlim=(-1, 1), ylim=(-1, 1))
    r = np.linalg.norm(mesh.coords, axis=1)
    eps = 0.12
    # non-distance field whose zero contour is the circle R=0.55, distorted
    F = (0.55**2 - r**2) * (1.0 + 0.3 * mesh.coords[:, 0])
    V0 = ls_volume(mesh, F, eps)
    Fd = renormalize(mesh, F)
    Vd = ls_volume(mesh, Fd, eps)
    Fm = renormalize_mass(mesh, F, eps)
    Vm = ls_volume(mesh, Fm, eps)
    assert abs(Vd - V0) > 1e-4          # plain redistancing drifts
    assert abs(Vm - V0) < 1e-9 * max(V0, 1)   # mass-iter restores
    # still (approximately) a signed distance: |grad| ~ 1 where smooth
    assert np.max(np.abs(Fm - Fd)) < 0.05     # only a small uniform shift


def test_renormalize_mass_long_advection_drift():
    """Rigid rotation of a circle with periodic mass renorm: enclosed
    volume drift stays < 0.1% over a long transient, vs the visible drift of plain renorm."""
    mesh = rectangle_mesh(20, 20, elem="QUAD9", xlim=(-1, 1), ylim=(-1, 1))
    eps = 0.15
    th0 = np.arctan2(mesh.coords[:, 1], mesh.coords[:, 0])
    rr = np.linalg.norm(mesh.coords, axis=1)

    def field(dth):
        # circle of radius .3 centered at distance .4, rotated by dth
        c = 0.4 * np.array([np.cos(dth), np.sin(dth)])
        return 0.3 - np.linalg.norm(mesh.coords - c, axis=1)

    F = field(0.0)
    V0 = ls_volume(mesh, F, eps)
    drift_mass = 0.0
    for k in range(1, 21):
        # advect exactly (rigid rotation), then renormalize with mass fix
        F = field(0.15 * k) * (1.0 + 0.2 * np.sin(3 * th0))  # distorted
        F = renormalize_mass(mesh, F, eps, target_volume=V0)
        drift_mass = abs(ls_volume(mesh, F, eps) - V0) / V0
    assert drift_mass < 1e-3


def _bubble(n=16, sigma=1.0, R=0.5, xfem=True):
    mesh = rectangle_mesh(n, n, elem="QUAD9", xlim=(-1, 1), ylim=(-1, 1))
    mesh.nodesets["all"] = np.arange(mesh.n_nodes, dtype=np.int32)
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    eqs = [Momentum(dim=2, interp="Q2", transient=False, convection=False),
           Continuity(interp="Q1"), FillEquation(interp="Q2", supg=0.0,
                                                 transient=False),
           CSFSurfaceTension(dim=2, sigma=sigma)]
    if xfem:
        eqs += [XFEMPressureContinuity(interp="Q1"),
                XFEMPressureMomentum(dim=2)]
    prob = Problem(mesh, eqs, {"rho": 1.0, "mu": 1.0})
    prob.add_dirichlet("all", FILL_VAR, 0,
                       lambda X: R - np.linalg.norm(X, axis=1))
    for ns in ("left", "right", "top", "bottom"):
        prob.add_dirichlet(ns, "velocity", 0, 0.0)
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.finalize()
    return prob, mesh


def test_xfem_static_bubble_pressure_jump():
    """Static bubble (Stokes + CSF): enriched pressure must (a) capture the
    Laplace jump sigma/R and (b) cut the spurious currents well below the
    non-enriched discretization."""
    sigma, R = 1.0, 0.5
    results = {}
    for xfem in (False, True):
        prob, mesh = _bubble(xfem=xfem)
        params = prob.base_params(ls_eps=jnp.asarray(0.2, dtype=prob.dtype))
        res = NewtonSolver(prob, NewtonOptions(
            max_iter=6, linear_solver="direct", tol_residual=1e-9)
        ).solve(np.zeros(prob.dofmap.n_dof), params)
        assert res.converged
        ux = prob.get_nodal_field(res.x, "velocity", 0)
        uy = prob.get_nodal_field(res.x, "velocity", 1)
        umax = np.nanmax(np.hypot(ux, uy))
        p = prob.get_nodal_field(res.x, "pressure")
        # nodal total pressure = standard part (enrichment vanishes at nodes)
        center = int(np.argmin(np.linalg.norm(mesh.coords, axis=1)))
        corner = int(np.argmin(np.linalg.norm(
            mesh.coords - np.array([-1, -1]), axis=1)))
        results[xfem] = dict(umax=umax, jump=p[center] - p[corner])

    exact = sigma / R
    # enriched: accurate jump + much smaller spurious currents
    assert abs(results[True]["jump"] - exact) < 0.05 * exact, results
    assert results[True]["umax"] < 0.5 * results[False]["umax"], results


def test_xfem_reproduces_smoothed_step_exactly():
    """Partition-of-unity check: with b_i = c and p_i = c H(F_i), the
    enriched + standard pressure equals c H_eps(F(x)) pointwise, so the
    momentum residual matches an identical problem where the same smoothed
    step is imposed through a body force... simpler: evaluate the enriched
    value at quadrature points directly."""
    from goma_tpu.fem.fields import eval_fieldvars
    from goma_tpu.physics.level_set import heaviside, xfem_pressure_basis

    prob, mesh = _bubble(n=6, xfem=True)
    bd = prob.dofmap.blocks[0]
    tables = prob.tables[0]
    c = 2.3
    eps = 0.2
    rng = np.random.RandomState(0)
    for le in [0, 7, 17]:
        q = np.zeros(bd.n_ldof)
        sF = bd.slot(FILL_VAR)
        sB = bd.slot("pressure_xfem")
        sP = bd.slot("pressure")
        Fn = rng.randn(sF.nbf) * 0.3
        q[sF.start:sF.start + sF.size] = Fn
        q[sB.start:sB.start + sB.size] = c
        X_e = mesh.coords[mesh.blocks[0].conn[le]]
        fv = eval_fieldvars(jnp.asarray(q), jnp.zeros_like(jnp.asarray(q)),
                            jnp.asarray(X_e), tables, bd.slots,
                            prob.dtype)
        psi, gpsi, p_enr, gp_enr = xfem_pressure_basis(fv, eps)
        # standard Q1 part interpolating c*H(F_i) at the Q1 nodes
        lf, lp = fv.lnodes[FILL_VAR], fv.lnodes["pressure_xfem"]
        idx = [lf.index(k) for k in lp]
        Hn = np.asarray(heaviside(jnp.asarray(Fn[idx]), eps))
        Np = np.asarray(fv.phi["pressure"])
        p_std = Np @ (c * Hn)
        Fq = np.asarray(fv.val[FILL_VAR][:, 0])
        np.testing.assert_allclose(
            np.asarray(p_enr) + p_std,
            c * np.asarray(heaviside(jnp.asarray(Fq), eps)), atol=1e-12)
