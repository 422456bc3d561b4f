"""Local (red/green) AMR: indicator-driven refinement of ONLY the LS
interface band on a triangle mesh, hanging-node-free, with solution
transfer and a continued two-phase transient. Reference:
src/adapt/omega_h_interface.cpp:1325 adapt_mesh_omega_h (LS-band metric),
resetup_problem.c."""

import numpy as np
import jax.numpy as jnp
import pytest

from goma_tpu.adapt import transfer_solution, zz_error_indicator
from goma_tpu.adapt.local_amr import (mark_ls_band, mark_top_fraction,
                                      red_green_refine)
from goma_tpu.fem import Problem
from goma_tpu.mesh import rectangle_mesh
from goma_tpu.physics import Continuity, Momentum
from goma_tpu.physics.level_set import (FILL_VAR, CSFSurfaceTension,
                                        FillEquation)
from goma_tpu.solvers import NewtonOptions, NewtonSolver
from goma_tpu.solvers.transient import TimeOptions, TransientSolver


def _areas(mesh):
    c3 = mesh.blocks[0].conn[:, :3]
    p = mesh.coords[c3]
    return 0.5 * np.abs(
        (p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1])
        - (p[:, 2, 0] - p[:, 0, 0]) * (p[:, 1, 1] - p[:, 0, 1]))


def _conforming(mesh):
    """Every interior edge is shared by exactly 2 elements (no hanging
    nodes possible on a conforming corner-edge graph)."""
    c3 = mesh.blocks[0].conn[:, :3]
    cnt = {}
    for e in range(c3.shape[0]):
        c = c3[e]
        for i, j in ((0, 1), (1, 2), (2, 0)):
            k = (min(c[i], c[j]), max(c[i], c[j]))
            cnt[k] = cnt.get(k, 0) + 1
    return all(v <= 2 for v in cnt.values())


def test_red_green_band_refinement_geometry():
    mesh = rectangle_mesh(10, 10, elem="TRI6", xlim=(-1, 1), ylim=(-1, 1))
    R = 0.5
    F = R - np.linalg.norm(mesh.coords, axis=1)
    marked = mark_ls_band(mesh, F, band=0.12)
    ne0 = mesh.blocks[0].n_elem
    new = red_green_refine(mesh, marked)
    ne1 = new.blocks[0].n_elem
    # local: grew, but far less than uniform 4x
    assert ne0 < ne1 < 2.6 * ne0, (ne0, ne1)
    assert _conforming(new)
    # total area preserved
    np.testing.assert_allclose(_areas(new).sum(), _areas(mesh).sum(),
                               rtol=1e-12)
    # refinement is localized: smallest elements sit in the band, far-field
    # elements keep the original size
    a_new = _areas(new)
    cent = new.coords[new.blocks[0].conn[:, :3]].mean(axis=1)
    far = np.linalg.norm(cent, axis=1) > R + 0.35
    near = np.abs(np.linalg.norm(cent, axis=1) - R) < 0.08
    assert a_new[near].max() < 0.6 * a_new[far].max()
    assert np.isclose(a_new[far].max(), _areas(mesh).max(), rtol=1e-9)
    # nodesets/sidesets rebuilt and non-empty
    for name in ("left", "right", "top", "bottom"):
        assert new.nodesets[name].size >= mesh.nodesets[name].size
        assert new.sidesets[name].elems.size >= \
            mesh.sidesets[name].elems.size


def _bubble_problem(mesh, sigma=1.0):
    mesh.nodesets["all"] = np.arange(mesh.n_nodes, dtype=np.int32)
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    eqs = [Momentum(dim=2, interp="Q2", transient=True, convection=False),
           Continuity(interp="Q1"),
           FillEquation(interp="Q2", supg=0.5),
           CSFSurfaceTension(dim=2, sigma=sigma)]
    prob = Problem(mesh, eqs, {"rho": 1.0, "mu": 1.0})
    for ns in ("left", "right", "top", "bottom"):
        for comp in range(2):
            prob.add_dirichlet(ns, "velocity", comp, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.finalize()
    return prob


def test_two_phase_transient_refines_band_and_continues():
    """Static bubble on TRI6: run 2 steps, refine ONLY the interface band,
    transfer (x, xdot), continue 2 more steps; Laplace jump survives the
    adapt and improves localization (the reference's in-run adapt hook,
    rf_solve.c:1843)."""
    sigma, R = 1.0, 0.5
    mesh = rectangle_mesh(9, 9, elem="TRI6", xlim=(-1, 1), ylim=(-1, 1))
    prob = _bubble_problem(mesh, sigma)
    F0 = R - np.linalg.norm(mesh.coords, axis=1)
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), FILL_VAR, 0, F0)
    params = prob.base_params(ls_eps=jnp.asarray(0.25, dtype=prob.dtype))
    ts = TransientSolver(prob, NewtonOptions(max_iter=8, tol_residual=1e-8,
                                             linear_solver="direct"),
                         TimeOptions(dt0=0.02, t_end=0.04, adapt=False,
                                     theta=0.0))
    r1 = ts.run(x0, params)
    assert all(s.converged for s in r1.steps)

    # --- adapt: refine the LS band only
    F = prob.get_nodal_field(np.asarray(r1.x), FILL_VAR, 0)
    marked = mark_ls_band(mesh, F, band=0.15)
    assert 0 < marked.sum() < 0.6 * marked.size
    new_mesh = red_green_refine(mesh, marked)
    assert _conforming(new_mesh)
    prob2 = _bubble_problem(new_mesh, sigma)
    x2, xdot2 = transfer_solution(prob, np.asarray(r1.x), prob2,
                                  xdot_old=np.asarray(r1.xdot))

    ts2 = TransientSolver(prob2, NewtonOptions(max_iter=10,
                                               tol_residual=1e-8,
                                               linear_solver="direct"),
                          TimeOptions(dt0=0.02, t_end=0.08, adapt=False,
                                      theta=0.0))
    params2 = prob2.base_params(ls_eps=jnp.asarray(0.25, dtype=prob2.dtype))
    r2 = ts2.run(x2, params2, t0=0.04, xdot0=xdot2)
    assert all(s.converged for s in r2.steps)

    # Laplace jump on the refined mesh
    p = prob2.get_nodal_field(np.asarray(r2.x), "pressure")
    c = new_mesh.coords
    rr = np.where(np.isfinite(p), np.linalg.norm(c, axis=1), np.inf)
    rc = np.where(np.isfinite(p), np.linalg.norm(
        c - np.array([-1.0, -1.0]), axis=1), np.inf)
    jump = p[int(np.argmin(rr))] - p[int(np.argmin(rc))]
    assert abs(jump - sigma / R) < 0.2 * sigma / R, jump


def test_mark_top_fraction_with_zz():
    """Doerfler marking off the ZZ indicator: marks a bounded fraction."""
    mesh = rectangle_mesh(8, 8, elem="TRI6")
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    eqs = [Momentum(dim=2, interp="Q2", transient=False),
           Continuity(interp="Q1")]
    prob = Problem(mesh, eqs, {"rho": 1.0, "mu": 0.05})
    for ns in ("left", "right", "bottom"):
        prob.add_dirichlet(ns, "velocity", 0, 0.0)
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("top", "velocity", 0,
                       lambda c: 16 * c[:, 0]**2 * (1 - c[:, 0])**2)
    prob.add_dirichlet("top", "velocity", 1, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.finalize()
    res = NewtonSolver(prob, NewtonOptions(max_iter=10, tol_residual=1e-8,
                                           linear_solver="direct")).solve(
        np.zeros(prob.dofmap.n_dof), prob.base_params())
    assert res.converged
    eta = zz_error_indicator(prob, res.x, "velocity", 0)
    marked = mark_top_fraction(eta, 0.25)
    assert 0.2 <= marked.mean() <= 0.45
    new = red_green_refine(mesh, marked)
    assert _conforming(new)


# ----------------------------------------------------------- 3D (tet) AMR
from goma_tpu.adapt.local_amr import triangulate_mesh
from goma_tpu.mesh import box_mesh


def _tet_vols(mesh):
    c4 = mesh.blocks[0].conn[:, :4]
    p = mesh.coords[c4]
    return np.einsum("ei,ei->e",
                     np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]),
                     p[:, 3] - p[:, 0]) / 6.0


def _tet_conforming(mesh):
    """Every interior triangle face shared by exactly 2 elements."""
    c4 = mesh.blocks[0].conn[:, :4]
    cnt = {}
    for e in range(c4.shape[0]):
        c = c4[e]
        for nd in ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)):
            k = tuple(sorted(int(c[i]) for i in nd))
            cnt[k] = cnt.get(k, 0) + 1
    return all(v <= 2 for v in cnt.values())


def test_box_mesh_tet_geometry():
    """Kuhn 6-tet box meshes: positive volumes summing to the box volume,
    conforming faces, complete boundary sidesets."""
    for elem in ("TET4", "TET10"):
        mesh = box_mesh(3, 3, 3, elem=elem)
        v = _tet_vols(mesh)
        assert np.all(v > 0), elem
        np.testing.assert_allclose(v.sum(), 1.0, rtol=1e-12)
        assert _tet_conforming(mesh)
        # each box side: 2 triangles per boundary cell face
        for name in ("left", "right", "front", "back", "top", "bottom"):
            assert mesh.sidesets[name].elems.size == 2 * 9, (elem, name)
            assert mesh.nodesets[name].size > 0


def test_tet_red_green_band_refinement_geometry():
    """LS-band refinement of a TET10 box: conforming, volume-preserving,
    localized to the band (reference: omega_h simplex adapt at mesh dim,
    omega_h_interface.cpp:229,1325)."""
    mesh = box_mesh(4, 4, 4, elem="TET10", xlim=(-1, 1), ylim=(-1, 1),
                    zlim=(-1, 1))
    R = 0.55
    F = R - np.linalg.norm(mesh.coords, axis=1)
    marked = mark_ls_band(mesh, F, band=0.1)
    assert 0 < marked.sum() < 0.7 * marked.size
    ne0 = mesh.blocks[0].n_elem
    new = red_green_refine(mesh, marked)
    ne1 = new.blocks[0].n_elem
    assert ne0 < ne1 < 6.0 * ne0, (ne0, ne1)
    assert _tet_conforming(new)
    v0, v1 = _tet_vols(mesh), _tet_vols(new)
    assert np.all(v1 > 0)
    np.testing.assert_allclose(v1.sum(), v0.sum(), rtol=1e-12)
    # localized: far-field elements keep the original max volume
    cent = new.coords[new.blocks[0].conn[:, :4]].mean(axis=1)
    far = np.linalg.norm(cent, axis=1) > R + 0.45
    near = np.abs(np.linalg.norm(cent, axis=1) - R) < 0.06
    assert v1[near].max() < 0.6 * v1[far].max()
    assert np.isclose(v1[far].max(), v0.max(), rtol=1e-9)
    for name in ("left", "right", "front", "back", "top", "bottom"):
        assert new.nodesets[name].size >= mesh.nodesets[name].size
        assert new.sidesets[name].elems.size >= \
            mesh.sidesets[name].elems.size


def test_tet4_red_green_all_patterns():
    """TET4: marking a single interior element exercises red + green-1 +
    green-3 closures together; the result is conforming with positive
    volumes."""
    mesh = box_mesh(3, 3, 3, elem="TET4")
    ne = mesh.blocks[0].n_elem
    cent = mesh.coords[mesh.blocks[0].conn[:, :4]].mean(axis=1)
    marked = np.zeros(ne, dtype=bool)
    marked[int(np.argmin(np.linalg.norm(cent - 0.5, axis=1)))] = True
    new = red_green_refine(mesh, marked)
    assert new.blocks[0].n_elem > ne
    assert _tet_conforming(new)
    v = _tet_vols(new)
    assert np.all(v > 0)
    np.testing.assert_allclose(v.sum(), 1.0, rtol=1e-12)


def test_triangulate_quad_mesh_and_refine():
    """QUAD9 -> TRI6 conversion: area-exact, center node reused as the
    diagonal midside, sidesets mapped; the result red/green-refines."""
    mesh = rectangle_mesh(6, 6, elem="QUAD9", xlim=(-1, 1), ylim=(-1, 1))
    tri = triangulate_mesh(mesh)
    assert tri.blocks[0].elem_type == "TRI6"
    assert tri.n_nodes == mesh.n_nodes  # QUAD9 centers reused, none added
    assert tri.blocks[0].n_elem == 2 * mesh.blocks[0].n_elem
    np.testing.assert_allclose(_areas(tri).sum(), 4.0, rtol=1e-12)
    assert _conforming(tri)
    for name in ("left", "right", "top", "bottom"):
        assert tri.sidesets[name].elems.size == mesh.sidesets[name].elems.size
    F = 0.5 - np.linalg.norm(tri.coords, axis=1)
    new = red_green_refine(tri, mark_ls_band(tri, F, band=0.15))
    assert _conforming(new)
    np.testing.assert_allclose(_areas(new).sum(), 4.0, rtol=1e-12)


def test_3d_two_phase_transient_refines_band_and_continues():
    """3D static bubble on TET10: 2 transient steps, refine ONLY the LS
    band, transfer (x, xdot), continue 2 more steps; the 2 sigma / R
    Laplace jump survives the adapt (the 3D counterpart of the 2D test
    above)."""
    sigma, R = 1.0, 0.5
    mesh = box_mesh(4, 4, 4, elem="TET10", xlim=(-1, 1), ylim=(-1, 1),
                    zlim=(-1, 1))
    def build(m):
        m.nodesets["pin"] = np.array([0], dtype=np.int32)
        eqs = [Momentum(dim=3, interp="Q2", transient=True,
                        convection=False),
               Continuity(interp="Q1"),
               FillEquation(interp="Q2", supg=0.5),
               CSFSurfaceTension(dim=3, sigma=sigma)]
        prob = Problem(m, eqs, {"rho": 1.0, "mu": 1.0})
        for ns in ("left", "right", "front", "back", "top", "bottom"):
            for comp in range(3):
                prob.add_dirichlet(ns, "velocity", comp, 0.0)
        prob.add_dirichlet("pin", "pressure", 0, 0.0)
        prob.finalize()
        return prob

    prob = build(mesh)
    F0 = R - np.linalg.norm(mesh.coords, axis=1)
    x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), FILL_VAR, 0, F0)
    params = prob.base_params(ls_eps=jnp.asarray(0.35, dtype=prob.dtype))
    ts = TransientSolver(prob, NewtonOptions(max_iter=8, tol_residual=1e-7,
                                             linear_solver="direct"),
                         TimeOptions(dt0=0.02, t_end=0.02, adapt=False,
                                     theta=0.0))
    r1 = ts.run(x0, params)
    assert all(s.converged for s in r1.steps)

    F = prob.get_nodal_field(np.asarray(r1.x), FILL_VAR, 0)
    marked = mark_ls_band(mesh, F, band=0.12)
    assert 0 < marked.sum() < 0.8 * marked.size
    new_mesh = red_green_refine(mesh, marked)
    assert _tet_conforming(new_mesh)
    assert np.all(_tet_vols(new_mesh) > 0)
    prob2 = build(new_mesh)
    x2, xdot2 = transfer_solution(prob, np.asarray(r1.x), prob2,
                                  xdot_old=np.asarray(r1.xdot))
    ts2 = TransientSolver(prob2, NewtonOptions(max_iter=10,
                                               tol_residual=1e-7,
                                               linear_solver="direct"),
                          TimeOptions(dt0=0.02, t_end=0.04, adapt=False,
                                      theta=0.0))
    params2 = prob2.base_params(ls_eps=jnp.asarray(0.35, dtype=prob2.dtype))
    r2 = ts2.run(x2, params2, t0=0.02, xdot0=xdot2)
    assert all(s.converged for s in r2.steps)

    p = prob2.get_nodal_field(np.asarray(r2.x), "pressure")
    c = new_mesh.coords
    rr = np.where(np.isfinite(p), np.linalg.norm(c, axis=1), np.inf)
    rc = np.where(np.isfinite(p), np.linalg.norm(
        c - np.array([-1.0, -1.0, -1.0]), axis=1), np.inf)
    jump = p[int(np.argmin(rr))] - p[int(np.argmin(rc))]
    exact = 2.0 * sigma / R
    assert abs(jump - exact) < 0.4 * exact, (jump, exact)
