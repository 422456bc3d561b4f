"""Shell equations on curve (BAR) blocks embedded in 2D meshes.

Parity: reference shell family ``src/mm_fill_shell.c`` (40+ shell equations)
+ ``src/mm_shell_util.c`` shell-bulk "friend" coupling. Design:
shell elements are ordinary BAR blocks whose connectivity references the
same global nodes as the bulk boundary, so any variable shared between bulk
and shell couples automatically through the node-major dof map — the
reference's cross-element variable gather (``load_neighbor_var_data:1330``)
is simply not needed.

``attach_shell_block`` builds a BAR block along a side set.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from goma_tpu.fem.equations import Equation, FaceKernel
from goma_tpu.physics.materials import prop


def _face_param_nodes(et, face_id: int):
    """Local nodes on a face with their face-chart coordinates (s[, t])."""
    from goma_tpu.elements import faces as elem_faces
    from goma_tpu.mesh.mesh import _ref_nodes

    face = elem_faces(et.family)[face_id]
    ref = _ref_nodes(et)
    p0, J = face.ref_origin, face.ref_jac
    out = []
    for i in range(et.n_nodes):
        d = ref[i] - p0
        coef, *_ = np.linalg.lstsq(J, d, rcond=None)
        if np.linalg.norm(d - J @ coef) < 1e-12:
            out.append((i, coef))
    return out


# shell element node layouts in the face chart, per (bulk family, n nodes)
_SHELL_TARGETS = {
    ("hex", 4): ("QUAD4", [(-1, -1), (1, -1), (1, 1), (-1, 1)]),
    ("hex", 8): ("QUAD8", [(-1, -1), (1, -1), (1, 1), (-1, 1),
                           (0, -1), (1, 0), (0, 1), (-1, 0)]),
    ("hex", 9): ("QUAD9", [(-1, -1), (1, -1), (1, 1), (-1, 1),
                           (0, -1), (1, 0), (0, 1), (-1, 0), (0, 0)]),
    ("tet", 3): ("TRI3", [(0, 0), (1, 0), (0, 1)]),
    ("tet", 6): ("TRI6", [(0, 0), (1, 0), (0, 1),
                          (0.5, 0), (0.5, 0.5), (0, 0.5)]),
}


def attach_shell_block(mesh, sideset: str, name: str = "shell") -> int:
    """Create a shell block along a sideset's faces: BAR2/BAR3 on 2D bulk,
    QUAD4/8/9 or TRI3/6 surface elements on 3D bulk (reference:
    BILINEAR/BIQUAD_SHELL, TRISHELL on hexes/tets; shells share the bulk's
    boundary nodes so shared variables couple through the dof map — the
    friend-element gather of src/mm_shell_util.c:1330 is unnecessary).
    Returns the new block index."""
    from goma_tpu.elements import element_type
    from goma_tpu.mesh.mesh import Block, _face_all_nodes

    ss = mesh.sidesets[sideset]
    conn = []
    etname = None
    for e, f in zip(ss.elems, ss.faces):
        bi, le = mesh.global_elem_block(int(e))
        b = mesh.blocks[bi]
        et = element_type(b.elem_type)
        if et.dim == 2:
            nodes = _face_all_nodes(et, int(f))
            face_corners = nodes[:2]
            mids = nodes[2:]
            if mids:
                row = [b.conn[le, face_corners[0]], b.conn[le, face_corners[1]],
                       b.conn[le, mids[0]]]
                etname = "BAR3"
            else:
                row = [b.conn[le, face_corners[0]], b.conn[le, face_corners[1]]]
                etname = "BAR2"
        else:
            pn = _face_param_nodes(et, int(f))
            key = (et.family, len(pn))
            if key not in _SHELL_TARGETS:
                raise NotImplementedError(f"shell on {et.name} faces")
            etname, targets = _SHELL_TARGETS[key]
            row = []
            for tgt in targets:
                hit = min(pn, key=lambda ic: np.linalg.norm(ic[1] - np.asarray(tgt)))
                if np.linalg.norm(hit[1] - np.asarray(tgt)) > 1e-10:
                    raise RuntimeError("face chart mismatch building shell block")
                row.append(b.conn[le, hit[0]])
        conn.append(row)
    mesh.blocks.append(Block(name, etname, np.asarray(conn, dtype=np.int32)))
    return len(mesh.blocks) - 1


class ShellConduction(Equation):
    """Surface conduction along the shell: int ks dT/ds dphi/ds
    (adds in-plane shell conductivity to a bulk-shared temperature —
    reference shell energy, assemble_shell_energy)."""

    def __init__(self, ks: float, var: str = "temperature", interp: str = "Q2"):
        super().__init__(var, 1, interp)
        self.ks = ks

    def residual(self, fv, mat, params):
        # surface gradients (tangent-plane vectors): uniform for BAR-in-2D
        # curves and QUAD/TRI-in-3D shells (Laplace-Beltrami weak form)
        gT = fv.grad[self.var][:, 0, :]
        gphi = fv.gphi[self.var]
        return (self.ks * jnp.einsum("qk,qik->qi", gT, gphi))[:, None, :]


class SurfaceCharge(Equation):
    """R_SURF_CHARGE rows (``assemble_surface_charge``,
    ``src/mm_fill_shell.c:470``): surface charge density qs transported
    along the shell by surface diffusion,

        R_i = phi_i dqs/dt + D_s (dqs/ds) (dphi_i/ds) - phi_i * src

    ``src`` (optional material key ``qs_source``, callable or constant)
    carries the bulk normal-current drive n.J that the reference applies
    through its electric-field boundary terms."""

    def __init__(self, surf_diff: float, var: str = "surface_charge",
                 interp: str = "Q1", transient: bool = True):
        super().__init__(var, 1, interp)
        self.Ds = surf_diff
        self.transient = transient

    def residual(self, fv, mat, params):
        gq = fv.grad[self.var][:, 0, :]
        gphi = fv.gphi[self.var]
        phi = fv.phi[self.var]
        c = self.Ds * jnp.einsum("qk,qik->qi", gq, gphi)
        s = mat.get("qs_source", None)
        if s is not None:
            sv = s(fv, mat, params) if callable(s) else \
                jnp.full(fv.x.shape[0], float(s), dtype=fv.x.dtype)
            c = c - sv[:, None] * phi
        if self.transient:
            c = c + fv.dot[self.var][:, 0][:, None] * phi
        return c[:, None, :]


class TensionedString(Equation):
    """Membrane/string deflection under transverse load:
    -T d2w/ds2 = q  ->  int T dw/ds dphi/ds - phi q.
    Reference analog: structural shell tension (assemble_shell_tension)."""

    def __init__(self, tension: float, load, var: str = "shell_deflection",
                 interp: str = "Q2", transient: bool = False):
        super().__init__(var, 1, interp)
        self.T = tension
        self.load = load
        self.transient = transient

    def residual(self, fv, mat, params):
        gw = fv.grad[self.var][:, 0, :]  # surface gradient (membrane form)
        gphi = fv.gphi[self.var]
        phi = fv.phi[self.var]
        q = self.load(fv, mat, params) if callable(self.load) else self.load
        q = jnp.broadcast_to(jnp.asarray(q), gw.shape[:1])
        c = self.T * jnp.einsum("qk,qik->qi", gw, gphi) - jnp.einsum("q,qi->qi", q, phi)
        if self.transient:
            rho = prop(mat, "shell_rho", fv, params, 1.0)
            c = c + rho * jnp.einsum("q,qi->qi", fv.dot[self.var][:, 0], phi)
        return c[:, None, :]


class ShellCurvature(Equation):
    """Structural-shell normal force balance (inextensible elastica):

        D K'' = K T + P      (weak: -D ds(phi) ds(K) - (K T + P) phi)

    Reference: ``assemble_shell_structure`` (src/mm_fill_shell.c:802),
    R_SHELL_CURVATURE rows — bending stiffness D = elc->bend_stiffness, the
    pressure load P from the lubrication field when present (LUBP coupling)
    or the ``p_load`` material key."""

    def __init__(self, bend_stiffness: float, interp: str = "Q2"):
        super().__init__("sh_K", 1, interp)
        self.D = bend_stiffness

    def _p_load(self, fv, mat, params):
        if "lub_pressure" in fv.val:
            return fv.val["lub_pressure"][:, 0]
        P = mat.get("p_load", 0.0)
        if callable(P):
            return P(fv, mat, params)
        return jnp.broadcast_to(jnp.asarray(P), fv.x.shape[:1])

    def residual(self, fv, mat, params):
        K = fv.val["sh_K"][:, 0]
        T = fv.val["sh_tens"][:, 0]
        dK = fv.grad_s["sh_K"][:, 0]
        P = self._p_load(fv, mat, params)
        phi = fv.phi["sh_K"]
        dphi = fv.dphi_ds["sh_K"]
        c = -self.D * dK[:, None] * dphi - (K * T + P)[:, None] * phi
        return c[:, None, :]


class ShellTension(Equation):
    """Structural-shell tangential balance: ds(T) + D K ds(K) = 0
    (reference R_SHELL_TENSION rows, src/mm_fill_shell.c:952)."""

    def __init__(self, bend_stiffness: float, interp: str = "Q2"):
        super().__init__("sh_tens", 1, interp)
        self.D = bend_stiffness

    def residual(self, fv, mat, params):
        K = fv.val["sh_K"][:, 0]
        dK = fv.grad_s["sh_K"][:, 0]
        dT = fv.grad_s["sh_tens"][:, 0]
        phi = fv.phi["sh_tens"]
        c = (dT + self.D * K * dK)[:, None] * phi
        return c[:, None, :]


class BeamBending(Equation):
    """Euler-Bernoulli beam on a curve block with Hermite cubic (I_H3)
    elements: EI w'''' - T w'' = q, weak form

        int EI w'' phi'' + T w' phi' - q phi  ds

    The C1 Hermite basis (reference I_H3 interpolation,
    include/mm_as_const.h; basis tables el_elm_info/rf_shape) carries value
    + arc-slope dofs per node: declare ncomp=2 and constrain comp 0 (value)
    / comp 1 (slope) independently for clamped/pinned supports."""

    def __init__(self, EI: float, load=0.0, tension: float = 0.0,
                 var: str = "beam_w"):
        super().__init__(var, 2, "H3")
        self.EI = EI
        self.load = load
        self.tension = tension

    def residual(self, fv, mat, params):
        nq = fv.x.shape[0]
        w2 = fv.d2s[self.var][:, 0]
        phi = fv.phi[self.var]        # (nq, 4)
        d2phi = fv.d2phi_ds2[self.var]
        q = self.load(fv, mat, params) if callable(self.load) else self.load
        q = jnp.broadcast_to(jnp.asarray(q), (nq,))
        c = self.EI * w2[:, None] * d2phi - q[:, None] * phi
        if self.tension:
            w1 = fv.grad_s[self.var][:, 0]
            c = c + self.tension * w1[:, None] * fv.dphi_ds[self.var]
        return c.reshape(nq, 2, 2)


class ShellSurfDivV(Equation):
    """R_SHELL_SURF_DIV_V rows (surface-rheology projection family,
    ``src/mm_fill_shell.c:4456 assemble_shell_surface_rheo_pieces``): the
    surface divergence of the bulk velocity as a SOLVED shell variable,

        R_i = int phi_i (gamma1 - div_s v),   div_s v = (I - nn):grad v
            = t . dv/ds  on a 2D curve shell

    (+ optional surface-diffusion smoothing ``surf_div_diff`` matching the
    reference's SurfaceDiffusionCoeffProjectionEqn). Register the bulk
    velocity on the shell block with
    ``PassiveVar("velocity", dim, interp)`` so its nodal values route
    through the shell gather (shared boundary nodes)."""

    def __init__(self, interp: str = "Q2", var: str = "surf_div_v",
                 vel_var: str = "velocity"):
        super().__init__(var, 1, interp)
        self.vel_var = vel_var

    def residual(self, fv, mat, params):
        g1 = fv.val[self.var][:, 0]
        # t . dv/ds from the curve's arc-length derivatives
        dvds = fv.grad_s[self.vel_var]  # (nq, dim)
        div_s = jnp.einsum("qa,qa->q", fv.tangent, dvds)
        phi = fv.phi[self.var]
        c = (g1 - div_s)[:, None] * phi
        diff = mat.get("surf_div_diff", 0.0)
        if diff:
            c = c + diff * fv.grad_s[self.var][:, :1] * fv.dphi_ds[self.var]
        return c[:, None, :]


class Gamma1DerivBC(FaceKernel):
    """SH_GAMMA1_DERIV_SYMM (``src/mm_ns_bc.c:15582 fgamma1_deriv_bc``):
    collocated end condition n . grad(gamma1) = -g on the surface-rheology
    projection variable — g=0 is the symmetry closure. Applied as a penalty
    on the endpoint row (conormal times the arc-length derivative)."""

    def __init__(self, g: float = 0.0, var: str = "surf_div_v",
                 penalty: float = 1e4):
        super().__init__(var, 1)
        self.g = g
        self.penalty = penalty

    def residual(self, sfv, mat, params):
        dgds = sfv.grad[self.var][:, 0, :]  # tangential gradient (psign)
        s = self.g + jnp.einsum("qk,qk->q", sfv.normal, dgds)
        phi = sfv.phi[self.var]
        return self.penalty * s[:, None, None] * phi[:, None, :]


class ShellGradBC(FaceKernel):
    """The WEAK_SHELL_GRAD family (``src/bc_special.c:1429-1456``):
    bulk-side boundary flux assembled into a SHELL equation's rows —
    SURFACE_ELECTRIC_FIELD (surface charge <- k n . grad V,
    ``src/mm_fill_shell.c:2858``), SURFACE_ACOUSTIC_VELOCITY (shell
    boundary velocity <- acoustic gradients), SURFACE_LUBRICATION (lubp <-
    bulk momentum flux), SURFACE_USER_SHELL (user closure).

    Apply on the BULK sideset carrying the shell: the parent bulk element
    supplies full gradients (the reference's two-element assembly), and the
    shell variable's face trace supplies the test functions — register the
    shell variable on the bulk block with ``PassiveVar`` so its dofs join
    the bulk gather. ``flux``: callable(sfv, mat, params) -> (nq,); the
    canonical electric closure is :func:`bulk_normal_current`."""

    def __init__(self, shell_var: str, flux, sign: float = 1.0):
        super().__init__(shell_var, 1)
        self.flux = flux
        self.sign = sign

    def residual(self, sfv, mat, params):
        q = self.flux(sfv, mat, params)
        phi = sfv.phi[self.var]
        return self.sign * (q[:, None] * phi)[:, None, :]


def bulk_normal_current(conductivity: float = 1.0, pot_var: str = "voltage"):
    """k n . grad(V) of the bulk at the shell (SURFACE_ELECTRIC_FIELD)."""
    def flux(sfv, mat, params):
        gV = sfv.grad[pot_var][:, 0, :]
        return conductivity * jnp.einsum("qk,qk->q", gV, sfv.normal)

    return flux


class ShellCoordinates(Equation):
    """R_SHELL_X / R_SHELL_Y rows (``assemble_shell_coordinates``,
    ``src/mm_fill_shell.c:1638``): inextensible 2D structural-shell
    coordinate equations on a bar-shell block, realized — exactly like the
    reference's "const node space version" — on the MESH rows (the shell
    coordinates ARE the mesh coordinates of the curve):

        x-rows: equal-arc-length node distribution,
                R_i = -int detJ (dphi_i/dxi)           (telescopes to
                detJ_left - detJ_right at interior nodes)
        y-rows: curvature closure d2y/ds2 - K dx/ds = 0,
                R_i = BIG * int [ -(dy/dxi)(dphi/dxi)/detJ - phi K dx/dxi ]

    K comes from the solved shell curvature field (``curv_var``, default
    ``sh_K``) or the constant/callable material key ``shell_curvature``.
    SH_X/SH_Y Dirichlet cards then pin the endpoint coordinates via
    ``Problem.add_dirichlet`` on the mesh components."""

    def __init__(self, interp: str = "Q1", curv_var: str = "sh_K",
                 penalty: float = 1e3):
        from goma_tpu.fem.fields import MESH_VAR

        super().__init__(MESH_VAR, 2, interp)
        self.curv_var = curv_var
        self.penalty = penalty

    def residual(self, fv, mat, params):
        nq = fv.x.shape[0]
        t = fv.tangent
        detJ = fv.detJ
        dphi = fv.dphi_ds[self.var]       # dphi/ds
        phi = fv.phi[self.var]
        if self.curv_var in fv.val:
            K = fv.val[self.curv_var][:, 0]
        else:
            Kv = mat.get("shell_curvature", 0.0)
            K = Kv(fv, mat, params) if callable(Kv) else \
                jnp.full(nq, float(Kv), dtype=fv.x.dtype)
        # our assembly integrates c with w*detJ; the reference adds its
        # terms with bare wt — divide the xi-form terms by detJ once
        cx = -detJ[:, None] * dphi                       # = -dphi/dxi
        cy = -t[:, 1][:, None] * detJ[:, None] * dphi \
            - (K * t[:, 0])[:, None] * phi
        out = jnp.zeros((nq, 2, phi.shape[1]), dtype=phi.dtype)
        out = out.at[:, 0, :].set(cx)
        out = out.at[:, 1, :].set(self.penalty * cy)
        return out


class ShellSurfCurv(Equation):
    """R_SHELL_SURF_CURV rows (gamma2 of
    ``assemble_shell_surface_rheo_pieces``, ``src/mm_fill_shell.c:4896``):
    the surface curvature div_s(n) as a SOLVED shell projection variable,

        R_i = phi_i (kv - t . d(n)/ds) + D3 (dkv/ds)(dphi_i/ds)

    with n the (solved or registered) surface normal field ``normal_var``
    — register it on the shell block via ``PassiveVar`` or couple the
    SolvedNormal equations. ``surf_diff`` is the reference's
    surfaceDiffusionCoeff3 smoothing."""

    def __init__(self, interp: str = "Q2", var: str = "surf_curv",
                 normal_var: str = "normal", surf_diff: float = 0.0):
        super().__init__(var, 1, interp)
        self.normal_var = normal_var
        self.surf_diff = surf_diff

    def residual(self, fv, mat, params):
        kv = fv.val[self.var][:, 0]
        dn = fv.grad_s[self.normal_var]   # (nq, dim) d(n_a)/ds
        div_n = jnp.einsum("qa,qa->q", fv.tangent, dn)
        phi = fv.phi[self.var]
        c = (kv - div_n)[:, None] * phi
        if self.surf_diff:
            c = c + self.surf_diff * fv.grad_s[self.var][:, :1] \
                * fv.dphi_ds[self.var]
        return c[:, None, :]


SH_J = "sh_J"


class ShellDiffusionFlux(Equation):
    """R_SHELL_DIFF_FLUX rows (``assemble_shell_diffusion``,
    ``src/mm_fill_shell.c:2132``): Mullins surface-diffusion flux unknown
    on a bar shell,

        R_i = int [ Js phi_i + Ds Gs Va Kd (dphi_i/ds) ] ds

    — which integrates by parts to the strong statement
    Js = +d/ds(Ds Gs Va Kd) in the reference's sign orientation (surface
    flux driven by the chemical-potential/curvature gradient; pair with
    :class:`ShellDiffKinematic`, whose -dJs/ds closes Mullins surface
    diffusion v_n = -d2s(D Kd) with the usual dissipative sign). ``curv_var``: the
    curvature field (SHELL_DIFF_CURVATURE analog — a ShellSurfCurv
    projection or a PassiveVar). Material keys ``surf_diff_Ds``,
    ``surf_energy_Gs``, ``atomic_vol_Va`` (each default 1, matching the
    reference's Ds = 1 hardwire at :2235)."""

    def __init__(self, interp: str = "Q1", curv_var: str = "surf_curv"):
        super().__init__(SH_J, 1, interp)
        self.curv_var = curv_var

    def residual(self, fv, mat, params):
        Js = fv.val[SH_J][:, 0]
        Kd = fv.val[self.curv_var][:, 0]
        D = mat.get("surf_diff_Ds", 1.0) * mat.get("surf_energy_Gs", 1.0) \
            * mat.get("atomic_vol_Va", 1.0)
        phi = fv.phi[SH_J]
        dphi = fv.dphi_ds[SH_J]
        c = Js[:, None] * phi + D * Kd[:, None] * dphi
        return c[:, None, :]


class ShellDiffKinematic(Equation):
    """SHELL_DIFF_KINEMATIC (``src/mm_fill_shell.c:5603
    shell_diff_kinematic_bc``): kinematic closure on the bulk MESH rows
    along a diffusing shell surface — the surface recedes/grows by the
    surface divergence of the Mullins flux:

        penalty * ( n . xdot - sign * d(Js)/ds ) n_a phi_i

    (the reference's mass + diffusion terms, assembled over the shell
    curve; its -grad_sh_J/sdet is exactly -d(Js)/ds). Register on the
    bar-shell block carrying :class:`ShellDiffusionFlux`."""

    def __init__(self, interp: str = "Q1", sign: float = 1.0,
                 penalty: float = 1e4, flux_var: str = SH_J):
        from goma_tpu.fem.fields import MESH_VAR

        super().__init__(MESH_VAR, 2, interp)
        self.sign = sign
        self.penalty = penalty
        self.flux_var = flux_var

    def residual(self, fv, mat, params):
        from goma_tpu.fem.fields import MESH_VAR

        nq = fv.x.shape[0]
        n = fv.normal
        xdot = fv.dot[MESH_VAR] if MESH_VAR in fv.dot else \
            jnp.zeros_like(fv.x)
        dJ = fv.grad_s[self.flux_var][:, 0]
        mis = jnp.einsum("qk,qk->q", n, xdot) - self.sign * dJ
        phi = fv.phi[self.var]
        return self.penalty * jnp.einsum("q,qa,qi->qai", mis, n, phi)


def tie_fluid_shell(problem, mesh, nodeset: str, sidesets,
                    curv_var: str = "sh_K", tens_var: str = "sh_tens",
                    scale: float = 1.0):
    """SH_FLUID_STRESS (``src/bc_colloc.c:559`` →
    ``src/mm_fill_shell.c:3877 put_fluid_stress_on_shell``): load the bulk
    fluid momentum residual onto the structural-shell rows at shared
    nodes —

        R[sh_K]    += scale * (n0 R[mom0] + n1 R[mom1])
        R[sh_tens] += scale * (t0 R[mom0] + t1 R[mom1])

    realized as weighted cross-equation row injections with the averaged
    boundary normal/tangent per node (``sidesets`` feeds
    :func:`goma_tpu.bc.rotation.nodal_normals`; the reference evaluates
    fv->snormal at assembly — setup-time averaged normals match its
    behavior on non-deforming boundaries)."""
    import numpy as _np

    from goma_tpu.bc.rotation import nodal_normals

    normals = nodal_normals(mesh, sidesets)
    nodes = mesh.nodesets[nodeset] if isinstance(nodeset, str) else nodeset
    for node in _np.asarray(nodes):
        n = normals[int(node)]
        t = _np.array([-n[1], n[0]])
        for a in range(2):
            if abs(n[a]) > 1e-14:
                problem.add_row_inject([int(node)], "velocity", curv_var,
                                       from_comp=a, sign=scale * float(n[a]))
            if abs(t[a]) > 1e-14:
                problem.add_row_inject([int(node)], "velocity", tens_var,
                                       from_comp=a, sign=scale * float(t[a]))


class ShellNormal(Equation):
    """R_SHELL_NORMAL1-3 rows (``assemble_shell_normal``,
    ``src/mm_fill_shell.c:15954``): L2 projection of the shell's geometric
    unit normal into a solved nodal field,

        R_(a,i) = int phi_i (n_a - n_geom_a)

    (the displacement-coupled lubrication height model and the
    solved-normal curvature projections read this field). Works on BAR
    shells in 2D (ncomp=2) and QUAD/TRI surface shells in 3D (ncomp=3) —
    the geometric normal comes from the displaced configuration, so mesh
    sensitivities are AD-exact."""

    def __init__(self, dim: int, interp: str = "Q1",
                 var: str = "shell_normal"):
        super().__init__(var, dim, interp)
        self.dim = dim

    def residual(self, fv, mat, params):
        nv = fv.val[self.var]            # (nq, dim)
        phi = fv.phi[self.var]
        mis = nv - fv.normal
        return jnp.einsum("qa,qi->qai", mis, phi)


class ShellAngle(Equation):
    """R_SHELL_ANGLE1(-2) rows (``assemble_shell_angle``,
    ``src/mm_fill_shell.c:4303``): shell orientation angle(s) projected
    from the surface normal — 2D: ang0 = atan2(n_y, n_x); 3D adds
    ang1 = acos(n_z). Solved on the shell block from the geometric
    normal (the reference's fv->snormal of the friend element)."""

    def __init__(self, dim: int, interp: str = "Q1",
                 var: str = "shell_angle"):
        super().__init__(var, dim - 1, interp)
        self.dim = dim

    def residual(self, fv, mat, params):
        n = fv.normal
        a0 = jnp.arctan2(n[:, 1], n[:, 0])
        if self.ncomp == 1:
            ang = a0[:, None]
        else:
            ang = jnp.stack([a0, jnp.arccos(jnp.clip(n[:, 2], -1.0, 1.0))],
                            axis=1)
        phi = fv.phi[self.var]
        mis = fv.val[self.var] - ang
        return jnp.einsum("qa,qi->qai", mis, phi)


class ShellCurvaturePair(Equation):
    """R_SHELL_CURVATURE + R_SHELL_CURVATURE2 rows
    (``assemble_shell_curvature``, ``src/mm_fill_shell.c:16126``): the two
    tangent-direction normal curvatures of a 3D surface shell projected
    from a (solved or registered) normal field,

        k_i = t_i . grad_s(n) . t_i      (i = 0, 1)

    with t_i the orthonormalized shell tangents. Pair with
    :class:`ShellNormal` (the reference requires SHELL_NORMAL1-3 with
    these equations). ``ncomp=2``: comp 0 = K, comp 1 = K2."""

    def __init__(self, interp: str = "Q1", var: str = "sh_K_pair",
                 normal_var: str = "shell_normal"):
        super().__init__(var, 2, interp)
        self.normal_var = normal_var

    def residual(self, fv, mat, params):
        t0 = fv.tangents[:, :, 0]
        t0 = t0 / jnp.linalg.norm(t0, axis=1, keepdims=True)
        t1r = fv.tangents[:, :, 1]
        t1r = t1r - jnp.einsum("qk,qk->q", t1r, t0)[:, None] * t0
        t1 = t1r / jnp.linalg.norm(t1r, axis=1, keepdims=True)
        M = fv.grad[self.normal_var]     # (nq, comp, k) = d n_c / dx_k
        k0 = jnp.einsum("qc,qck,qk->q", t0, M, t0)
        k1 = jnp.einsum("qc,qck,qk->q", t1, M, t1)
        kg = jnp.stack([k0, k1], axis=1)
        phi = fv.phi[self.var]
        mis = fv.val[self.var] - kg
        return jnp.einsum("qa,qi->qai", mis, phi)
