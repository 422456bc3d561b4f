"""Overset (fictitious-domain) fluid-structure coupling.

Parity: reference ``src/bc_contact.c`` (``apply_contact_bc:79``) — the
overlapping-grid contact method where Lagrange multipliers at solid-boundary
quadrature points tie the background-fluid velocity (interpolated inside the
fluid elements each point lands in) to the boundary motion, feeding reaction
forces back to the fluid (BAAIJENS_FLUID_SOLID / LAGRANGE_NO_SLIP BCs), with
the multipliers created as overlap augmenting conditions
(``src/mm_augc_util.c:2914 create_overlap_acs``).

Redesign: the multipliers are ordinary P0 elemental dofs on an
immersed BAR block (``goma_tpu.mesh.immersed``), the point-in-fluid-element
localization is a host precomputation (centroid kd-tree + isoparametric
Newton inversion), and ALL coupling Jacobian blocks (the reference's
hand-coded bAC/cAC/dAC arrays) come from one jacfwd over the combined
[bar-dofs, fluid-element-dofs] vector per quadrature point — assembled
straight into the CSR like interface kernels.

Current scope: prescribed boundary motion (rigid / driven solids); two-way
flexible-solid coupling rides the same machinery in a later round.

Note (boundary-only multipliers): only the EXTERIOR of a closed immersed
boundary is physical. The C0 background pressure cannot jump across the
curve, so the fictitious interior carries an artifact flow — exactly as in
the reference, where the overlapping solid mesh owns that region. Use
``quad_order=1`` on add_overset for the reference's
one-multiplier-per-collocation-point enforcement (tighter pointwise
no-slip); the default mortar (segment-average) form is smoother for
force/drag extraction.
"""

from __future__ import annotations

import jax.numpy as jnp

from goma_tpu.fem.equations import Equation

LM_VAR = "lm"


class OversetLM(Equation):
    """Carrier equation for the Lagrange-multiplier variable on the immersed
    BAR block: one P0 multiplier vector per segment. Contributes nothing in
    the volume — the multiplier rows are filled by the overset coupling."""

    def __init__(self, dim: int):
        super().__init__(LM_VAR, dim, "P0")
        self.dim = dim

    def residual(self, fv, mat, params):
        nq = fv.x.shape[0]
        return jnp.zeros((nq, self.ncomp, 1), dtype=fv.x.dtype)


class OversetNoSlip:
    """LAGRANGE_NO_SLIP + BAAIJENS_FLUID_SOLID pair: at each immersed-curve
    quadrature point x_q,

        multiplier rows:    + w_q ( u_f(x_q) - u_target(x_q, params) )
        fluid velocity rows: + w_q lambda . phi_f(x_q)

    ``u_target(x (dim,), params) -> (dim,)`` is the prescribed boundary
    velocity (0 = stationary rigid wall)."""

    fluid_var = "velocity"

    def __init__(self, dim: int, u_target=None):
        self.dim = dim
        self.u_target = u_target

    def residual(self, ov, q_lam, params):
        """ov: per-point context (x, w, fluid values/bases); q_lam (dim,).
        Returns (r_lam (dim,), rf_contribs {var: (ncomp, nbf)})."""
        u_f = ov.vals[self.fluid_var]  # (dim,)
        if self.u_target is None:
            ut = jnp.zeros(self.dim, dtype=u_f.dtype)
        else:
            ut = jnp.asarray(self.u_target(ov.x, params), dtype=u_f.dtype)
        r_lam = ov.w * (u_f - ut)
        phi = ov.phi[self.fluid_var]  # (nbf,)
        rf = {self.fluid_var: ov.w * q_lam[:, None] * phi[None, :]}
        return r_lam, rf


class OversetVars:
    """Fluid-side (and optionally solid-side) state at one immersed
    quadrature point."""

    def __init__(self):
        self.x = None  # (dim,)
        self.w = None  # scalar arc-length weight
        self.vals = {}  # fluid var -> (ncomp,)
        self.phi = {}  # fluid var -> (nbf,)
        self.vals_s = {}  # solid var -> (ncomp,)
        self.dots_s = {}  # solid var material time derivative -> (ncomp,)
        self.phi_s = {}  # solid var -> (nbf,)


class OversetFSI:
    """Two-way flexible-solid coupling (the BAAIJENS_SOLID_FLUID /
    BAAIJENS_FLUID_SOLID pair of src/bc_contact.c): at each immersed point,

        multiplier rows:   + w ( u_f(x_q) - d_dot_solid(x_q) )
        fluid rows:        + w lambda . phi_f     (reaction on the fluid)
        solid rows:        - w lambda . phi_s     (equal and opposite)

    Register with ``Problem.add_overset(..., solid=(solid_block, sideset))``
    where the bar block was built by attach_shell_block on that sideset.
    ``solid_var``: the solid displacement variable whose material velocity
    the fluid must match."""

    fluid_var = "velocity"

    def __init__(self, dim: int, solid_var: str = "solid_displacement"):
        self.dim = dim
        self.solid_var = solid_var

    def residual(self, ov, q_lam, params):
        u_f = ov.vals[self.fluid_var]
        ddot = ov.dots_s[self.solid_var]  # (dim,) material velocity
        r_lam = ov.w * (u_f - ddot)
        phi_f = ov.phi[self.fluid_var]
        rf = {self.fluid_var: ov.w * q_lam[:, None] * phi_f[None, :]}
        phi_s = ov.phi_s[self.solid_var]
        rs = {self.solid_var: -ov.w * q_lam[:, None] * phi_s[None, :]}
        return r_lam, rf, rs
