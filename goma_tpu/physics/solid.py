"""Real-solid mechanics (TOTAL_ALE) and solid dynamics.

Parity: reference ``src/mm_fill_rs.c`` (``assemble_real_solid:98``,
``solid_stress_tensor:824``) — the TOTAL_ALE split where a *real solid*
displacement field carries the material stress while a separate pseudo-solid
mesh displacement smooths the grid — plus ``src/mm_fill_solid.c`` strain
machinery (``belly_flop:77``). Stress form follows solid_stress_tensor:

    TT = lambda * volume_strain * I + 2 mu * strain
         - 2 mu * thermexp * (T - T_ref) * I        (thermoelastic)

with ``strain``/``volume_strain`` from the chosen constitutive model
(LINEAR small-strain, or NONLINEAR Green-Lagrange / St. Venant-Kirchhoff).

Design differences:
- all sensitivities (dTT_dx, dTT_drs, dTT_dT ... in the reference) come from
  AD of this residual; none are hand-coded;
- solid inertia uses a *first-order* velocity split (d_dot = v,
  rho v_dot = div P) integrated by the theta scheme — for linear problems
  theta=1/2 is algebraically identical to the reference's Newmark
  (beta=1/4, gamma=1/2) path (``predict_solution_newmark``,
  src/rf_solve.c:2818) while reusing the existing qdot machinery.

The TOTAL_ALE mesh<->solid tie (mesh follows the solid at material
boundaries, reference KIN_DISPLACEMENT-family BCs) is expressed with
multi-variable point constraints: see ``tie_mesh_to_solid``.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from goma_tpu.fem.equations import Equation, FaceKernel
from goma_tpu.physics.materials import prop

SOLID_VAR = "solid_displacement"


class RealSolid(Equation):
    """Momentum balance of the real solid, total-Lagrangian weak form:

        int_O0 grad0(phi) : P  +  phi rho (v_dot - b)  dV0

    ``model``: 'linear' (engineering strain) or 'nonlinear'
    (Green-Lagrange strain E with second Piola S = lam tr(E) I + 2 mu E,
    first Piola P = F S). Material keys: ``lame_mu``, ``lame_lambda``,
    ``solid_rho``, optional ``solid_thermexp``/``solid_ref_temp`` (needs a
    temperature variable) and ``solid_body_force``.

    ``dynamic`` adds the inertia term tested against a solid velocity
    variable supplied by :class:`SolidKinematics`.
    """

    measure = "reference"

    def __init__(self, dim: int, interp: str = "Q2", model: str = "nonlinear",
                 dynamic: bool = False, var: str = SOLID_VAR,
                 vel_var: str = "solid_velocity"):
        super().__init__(var, dim, interp)
        self.dim = dim
        assert model in ("linear", "nonlinear")
        self.model = model
        self.dynamic = dynamic
        self.vel_var = vel_var

    def stress(self, fv, mat, params):
        """First Piola-Kirchhoff stress (nq, dim, dim)."""
        dim = self.dim
        gd = fv.grad0[self.var]  # (nq, dim, dim): d d_a / d X0_k
        lam = prop(mat, "lame_lambda", fv, params, 1.0)
        mu = prop(mat, "lame_mu", fv, params, 1.0)
        I = jnp.eye(dim)[None]
        if self.model == "linear":
            eps = 0.5 * (gd + jnp.swapaxes(gd, 1, 2))
            tr = jnp.trace(eps, axis1=1, axis2=2)
            P = lam * tr[:, None, None] * I + 2.0 * mu * eps
            if "temperature" in fv.val and "solid_thermexp" in mat:
                a = prop(mat, "solid_thermexp", fv, params)
                T0 = mat.get("solid_ref_temp", 0.0)
                T = fv.val["temperature"][:, 0]
                P = P - (2.0 * mu * a * (T - T0))[:, None, None] * I
            return P
        F = I + gd
        E = 0.5 * (jnp.einsum("qka,qkb->qab", F, F) - I)
        trE = jnp.trace(E, axis1=1, axis2=2)
        S = lam * trE[:, None, None] * I + 2.0 * mu * E
        if "temperature" in fv.val and "solid_thermexp" in mat:
            a = prop(mat, "solid_thermexp", fv, params)
            T0 = mat.get("solid_ref_temp", 0.0)
            T = fv.val["temperature"][:, 0]
            S = S - (2.0 * mu * a * (T - T0))[:, None, None] * I
        return jnp.einsum("qak,qkb->qab", F, S)

    def residual(self, fv, mat, params):
        nq = fv.X0.shape[0]
        dim = self.dim
        P = self.stress(fv, mat, params)
        gphi = fv.gphi0[self.var]  # (nq, nbf, dim)
        contrib = jnp.einsum("qak,qik->qai", P, gphi)

        phi = fv.phi[self.var]
        if self.dynamic and self.vel_var in fv.dot:
            rho = prop(mat, "solid_rho", fv, params, 1.0)
            vdot = fv.dot[self.vel_var]  # (nq, dim)
            contrib = contrib + rho * jnp.einsum("qa,qi->qai", vdot, phi)
        b = mat.get("solid_body_force", None)
        if b is not None:
            rho = prop(mat, "solid_rho", fv, params, 1.0)
            bval = b(fv, mat, params) if callable(b) else jnp.broadcast_to(
                jnp.asarray(b), (nq, dim))
            contrib = contrib - rho * jnp.einsum("qa,qi->qai", bval, phi)
        return contrib


class SolidKinematics(Equation):
    """d_dot = v tested with the velocity basis: int phi (d_dot - v) dV0.

    Together with RealSolid(dynamic=True) this forms the first-order system
    replacing the reference's Newmark-beta second-order integration."""

    measure = "reference"

    def __init__(self, dim: int, interp: str = "Q2",
                 var: str = "solid_velocity", disp_var: str = SOLID_VAR):
        super().__init__(var, dim, interp)
        self.dim = dim
        self.disp_var = disp_var

    def residual(self, fv, mat, params):
        ddot = fv.dot[self.disp_var]
        v = fv.val[self.var]
        phi = fv.phi[self.var]
        return jnp.einsum("qa,qi->qai", ddot - v, phi)


class SolidTraction(FaceKernel):
    """Prescribed traction t on a boundary (reference-configuration measure is
    approximated by the current face measure — exact for small strain):
    -int phi t . e_a dA. ``traction``: (dim,) vector or callable(sfv)->
    (nq, dim)."""

    def __init__(self, dim: int, traction, var: str = SOLID_VAR):
        super().__init__(var, dim)
        self.dim = dim
        self.traction = traction

    def residual(self, sfv, mat, params):
        nq = sfv.x.shape[0]
        t = self.traction
        tval = t(sfv, mat, params) if callable(t) else jnp.broadcast_to(
            jnp.asarray(t), (nq, self.dim))
        phi = sfv.phi[self.var]
        return -jnp.einsum("qa,qi->qai", tval, phi)


def tie_mesh_to_solid(problem, nodeset, dim: int,
                      mesh_var: str = "mesh_displacement",
                      solid_var: str = SOLID_VAR):
    """TOTAL_ALE tie: replace the mesh-equation rows on ``nodeset`` with the
    constraints d_mesh - d_solid = 0, so the grid follows the material at
    solid boundaries (reference KIN_DISPLACEMENT BCs of the TOTAL_ALE
    formulation, src/mm_fill_rs.c). Interior mesh nodes keep their smoothing
    equation."""
    for a in range(dim):
        def g(q, X0, params, a=a, dim=dim):
            # q = concat(mesh comps, solid comps)
            return q[a] - q[dim + a]

        problem.add_point_constraint(nodeset, [mesh_var, solid_var], a, g)


class FSIVelocityTie(FaceKernel):
    """FLUID_SOLID / FLUID_SOLID_RS side of the conforming fluid<->solid
    interface: replace the fluid momentum rows with the no-slip tie
    v = d_dot (penalty; the reference's row surgery in
    ``src/bc_colloc.c:537 put_liquid_stress_in_solid`` path). The solid
    velocity is the displacement time derivative when ``solid_var`` is
    registered on the fluid block (``PassiveVar``); absent (or steady) it
    ties v to zero."""

    def __init__(self, dim: int, solid_var: str = SOLID_VAR,
                 penalty: float = 1e6):
        super().__init__("velocity", dim)
        self.dim = dim
        self.solid_var = solid_var
        self.penalty = penalty

    def residual(self, sfv, mat, params):
        v = sfv.val["velocity"]
        if self.solid_var in sfv.dot:
            v = v - sfv.dot[self.solid_var]
        phi = sfv.phi["velocity"]
        return self.penalty * jnp.einsum("qa,qi->qai", v, phi)


def tie_fluid_solid(problem, interface_nodeset, dim: int,
                    solid_var: str = SOLID_VAR, v_wall=0.0):
    """Conforming fluid<->solid interface: SOLID_FLUID(_RS) +
    FLUID_SOLID(_RS) (``src/bc_colloc.c:537`` ``put_liquid_stress_in_solid``
    / ``put_liquid_stress_in_solid_ALE``): the fluid momentum rows at the
    shared interface nodes are injected into the solid displacement rows
    (row sum = interface traction balance; the +1 sign is this framework's
    weak-form telescoping, see ``tie_lub_film``), then REPLACED by the
    no-slip tie — the replacement must happen after the injection (the
    reference's lec-level copy before its strong row surgery), which is
    exactly the point-constraint ordering here. The steady tie pins
    v = v_wall (scalar/(dim,) constant); for a moving solid use the
    transient :class:`FSIVelocityTie` penalty on a separate sideset
    instead (v = d_dot, no row replacement)."""
    vw = np.broadcast_to(np.asarray(v_wall, dtype=float), (dim,))
    for c in range(dim):
        problem.add_row_inject(interface_nodeset, "velocity", solid_var,
                               from_comp=c, to_comp=c, sign=1.0)
        problem.add_point_constraint(
            interface_nodeset, "velocity", c,
            (lambda c=c: lambda q, X0, params: q[c] - vw[c])())


def von_mises_strain(fv, var: str = None, nonlinear: bool = False):
    """The reference's FAUX_PLASTICITY strain measure
    (``assemble_max_strain``, ``src/mm_fill_terms.c:11078``):
    vmE = (2/3) sqrt(3 II(E_dev)) = (2/3) sqrt(1.5 dev(E):dev(E)) of the
    (small or Green) strain of the displacement field ``var``."""
    from goma_tpu.fem.fields import MESH_VAR

    v = var or (SOLID_VAR if SOLID_VAR in fv.grad else MESH_VAR)
    g = fv.grad[v]                        # (nq, dim, dim)
    E = 0.5 * (g + jnp.swapaxes(g, 1, 2))
    if nonlinear:
        E = E + 0.5 * jnp.einsum("qka,qkb->qab", g, g)
    tr = jnp.trace(E, axis1=1, axis2=2)
    d = g.shape[1]
    # deviator in the FULL 3x3 sense (2D plane strain: E33 = 0 but the
    # trace split still uses /3, matching calc_tensor_invariant)
    dev = E - (tr / 3.0)[:, None, None] * jnp.eye(d, dtype=g.dtype)
    dd = jnp.einsum("qab,qab->q", dev, dev) + (tr / 3.0) ** 2 * (3 - d)
    return (2.0 / 3.0) * jnp.sqrt(1.5 * dd + 1e-300)


class CurStrain(Equation):
    """R_CUR_STRAIN rows (``assemble_cur_strain``,
    ``src/mm_fill_terms.c:11278``): L2 projection of the current von Mises
    strain, R_i = phi_i (cs - vmE)."""

    def __init__(self, interp: str = "Q1", var: str = "cur_strain",
                 disp_var: str = None, nonlinear: bool = False):
        super().__init__(var, 1, interp)
        self.disp_var = disp_var
        self.nonlinear = nonlinear

    def residual(self, fv, mat, params):
        vm = von_mises_strain(fv, self.disp_var, self.nonlinear)
        phi = fv.phi[self.var]
        mis = fv.val[self.var][:, 0] - vm
        return (mis[:, None] * phi)[:, None, :]


class MaxStrain(Equation):
    """R_MAX_STRAIN rows (``assemble_max_strain``,
    ``src/mm_fill_terms.c:11078``): running maximum of the von Mises
    strain (history variable of the FAUX_PLASTICITY modulus model),

        R_i = phi_i ( max(vmE, ms_old) - ms )

    ms_old is reconstructed as ms - dt * ms_dot — exact under backward
    Euler (the transient driver's xdot definition), first-order otherwise
    (the reference's own selection is likewise evaluated at the old
    step)."""

    def __init__(self, interp: str = "Q1", var: str = "max_strain",
                 disp_var: str = None, nonlinear: bool = False):
        super().__init__(var, 1, interp)
        self.disp_var = disp_var
        self.nonlinear = nonlinear

    def residual(self, fv, mat, params):
        vm = von_mises_strain(fv, self.disp_var, self.nonlinear)
        ms = fv.val[self.var][:, 0]
        dt = params.get("dt", 0.0)
        ms_old = ms - dt * fv.dot[self.var][:, 0] if dt else ms
        sel = jnp.maximum(vm, ms_old)
        phi = fv.phi[self.var]
        return ((sel - ms)[:, None] * phi)[:, None, :]
