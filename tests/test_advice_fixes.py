"""Regression tests for early review findings.

1. NormalModeMomentum base-shear term must be (u_hat . grad) u0 (was
   (grad u0)^T u_hat): Couette base flow u0 = (y, 0) with a constant
   perturbation u_hat = (0, 1) must produce an x-momentum inertia load
   rho * integral(phi_i) (so the global sum is rho * area); the buggy
   transposed form gives exactly zero.
2. QUAD8 rectangle_mesh sidesets must use the quad face layout (the
   triangle else-branch tagged interior faces and out-of-range elements).
3. Deck "expr:" strings evaluate through a sandboxed AST walker; attribute
   traversal escapes must raise instead of executing.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from goma_tpu.fem import Problem
from goma_tpu.mesh import rectangle_mesh


def test_normal_mode_base_shear_direction():
    from goma_tpu.physics import (NormalModeContinuity, NormalModeMomentum,
                                  NormalModeW)
    from goma_tpu.physics.normal_mode import NM_U

    mesh = rectangle_mesh(4, 4, elem="QUAD9")
    prob = Problem(
        mesh,
        [NormalModeMomentum(interp="Q2"), NormalModeW(interp="Q2"),
         NormalModeContinuity(interp="Q1")],
        {"rho": 2.0, "mu": 1.0},
        external_fields=("u0", "v0"),
    )
    prob.finalize()
    dt = prob.dtype
    params = prob.base_params(
        beta=jnp.asarray(0.0, dtype=dt),
        ext_u0=jnp.asarray(mesh.coords[:, 1], dtype=dt),  # Couette u0 = (y, 0)
        ext_v0=jnp.zeros(mesh.n_nodes, dtype=dt),
    )
    # constant perturbation u_hat = (0, 1), p_hat = 0
    x = np.zeros(prob.dofmap.n_dof)
    dm = prob.dofmap
    dv = dm.dof_of_node_svar[:, dm.svar(NM_U, 1)]
    x[dv[dv >= 0]] = 1.0
    R = np.asarray(prob._assemble(jnp.asarray(x, dtype=dt), params)[0])
    du = dm.dof_of_node_svar[:, dm.svar(NM_U, 0)]
    # sum_i integral(rho * phi_i) = rho * area = 2.0 by partition of unity;
    # the transposed (buggy) term gives 0 here
    assert abs(R[du[du >= 0]].sum() - 2.0) < 1e-10
    assert abs(R[dv[dv >= 0]].sum()) < 1e-10


def test_quad8_sidesets_quad_layout():
    mesh = rectangle_mesh(4, 2, elem="QUAD8")
    ne = sum(b.conn.shape[0] for b in mesh.blocks)
    assert ne == 8
    for name, ss in mesh.sidesets.items():
        assert ss.elems.max() < ne, f"sideset {name} references missing elements"
    # bottom faces: elements 0..3 face 0; top: elements 4..7 face 2
    np.testing.assert_array_equal(np.sort(mesh.sidesets["bottom"].elems), np.arange(4))
    np.testing.assert_array_equal(np.sort(mesh.sidesets["top"].elems), np.arange(4, 8))
    assert set(mesh.sidesets["top"].faces.tolist()) == {2}


def test_quad8_face_bc():
    """A Neumann flux on a QUAD8 sideset must land on boundary nodes only
    (with the pre-fix triangle-layout sidesets this applied flux on interior
    faces / crashed on 'top')."""
    from goma_tpu.physics import Energy
    from goma_tpu.bc import NormalFlux

    mesh = rectangle_mesh(4, 2, elem="QUAD8")
    prob = Problem(mesh, [Energy(interp="Q2", transient=False,
                                 convection=False)], {"k": 1.0})
    prob.add_dirichlet("bottom", "temperature", 0, 0.0)
    prob.add_face_kernel("top", NormalFlux(var="temperature", flux=1.0))
    prob.finalize()
    from goma_tpu.solvers import NewtonOptions, NewtonSolver

    res = NewtonSolver(prob, NewtonOptions(max_iter=5, linear_solver="direct")
                       ).solve(np.zeros(prob.dofmap.n_dof), prob.base_params())
    assert res.converged
    # 1D heat flux solution: T = y (k dT/dn = 1 on top, T = 0 at bottom)
    dm = prob.dofmap
    d = dm.dof_of_node_svar[:, dm.svar("temperature")]
    ok = d >= 0
    np.testing.assert_allclose(res.x[d[ok]], mesh.coords[ok, 1], atol=1e-8)


def test_deck_expression_sandbox():
    from goma_tpu.input.deck import expand_expressions

    assert expand_expressions("expr: 2*pi") == pytest.approx(2 * np.pi)
    assert expand_expressions("expr: np.sqrt(4.0)") == pytest.approx(2.0)
    assert expand_expressions({"a": "expr: sin(0.0)"})["a"] == pytest.approx(0.0)
    for payload in (
        "expr: ().__class__.__bases__[0].__subclasses__()",
        "expr: np.load('/etc/passwd')",
        "expr: __import__('os').system('true')",
        "expr: (lambda: 1)()",
        "expr: [x for x in (1,)]",
    ):
        with pytest.raises((ValueError, SyntaxError)):
            expand_expressions(payload)


def test_refine_factor_scales_with_indicator():
    from goma_tpu.adapt import refine_factor_from_indicator

    eta_small = np.full(16, 1e-8)
    eta_big = np.full(16, 1.0)
    assert refine_factor_from_indicator(eta_small, target_abs=1e-3) == 1
    f = refine_factor_from_indicator(eta_big, target_abs=1.0, p=1)
    assert f == 4  # ||eta|| = 4 -> one refinement by 4 at p=1
    assert refine_factor_from_indicator(eta_big, target_abs=2.0, p=2) == 2
