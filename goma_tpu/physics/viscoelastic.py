"""Viscoelastic polymer stress: EVSS-F/DEVSS with SUPG, multimode.

Parity: reference ``src/mm_fill_stress.c`` — ``assemble_stress_fortin:1210``
(EVSS-F), multimode constitutive models (Oldroyd-B, Giesekus, PTT via
``polymer_time_const``/mode arrays, up to MAX_MODES=8), SUPG weighting, and
the velocity-gradient projection equation ``assemble_gradient:4597``.
Log-conformation (``assemble_stress_log_conf:2600``) is a planned follow-up.

Formulation (per mode m, stress S in symmetric components):

    R_S = w_i * [ S - 2 mu_p D
                  + lam * (Sdot + (u - xdot).grad S - G.S - S.G^T)
                  + (alpha lam / mu_p) S.S                      (Giesekus)
                  + (exp(eps lam tr(S)/mu_p) - 1) S ]           (exp. PTT)

with w_i = phi_i + tau_supg (u.grad phi_i) the SUPG weight and G the
L2-projected velocity gradient (the "F" of EVSS-F). The momentum equation
picks up div(S) through ``Momentum(ve_stress_modes=...)`` and the DEVSS
stabilization 2 mu_d (D(u) - sym(G)) via ``devss_mu``.
"""

from __future__ import annotations

import jax.numpy as jnp

from goma_tpu.fem.equations import Equation, FaceKernel, InterfaceKernel
from goma_tpu.fem.variables import sym_comps
from goma_tpu.physics.fluid import _as_nq, _sym_expand, advective_velocity
from goma_tpu.physics.materials import prop


def stress_var(mode: int) -> str:
    return f"stress{mode}"


class VelocityGradientProjection(Equation):
    """L2 projection G = grad(u): R_Gab = int phi_i (G_ab - du_a/dx_b).

    Components are row-major over the full (not symmetric) tensor.
    Reference: ``assemble_gradient`` (src/mm_fill_stress.c:4597).
    """

    def __init__(self, dim: int, interp: str = "Q1"):
        super().__init__("velocity_gradient", dim * dim, interp)
        self.dim = dim

    def residual(self, fv, mat, params):
        d = self.dim
        G = fv.val["velocity_gradient"].reshape(-1, d, d)  # (nq, d, d)
        gu = fv.grad["velocity"]
        phi = fv.phi["velocity_gradient"]
        diff = (G - gu).reshape(-1, d * d)
        return jnp.einsum("qc,qi->qci", diff, phi)


def full_from_comps(Gc, dim):
    return Gc.reshape(-1, dim, dim)


class VEStress(Equation):
    """One viscoelastic stress mode (symmetric components).

    model: "oldroyd_b" | "giesekus" | "ptt" (exponential) | "ptt_linear"
    """

    def __init__(
        self,
        mode: int,
        dim: int,
        lam: float,
        mu_p: float,
        model: str = "oldroyd_b",
        alpha: float = 0.0,
        eps_ptt: float = 0.0,
        interp: str = "Q1",
        supg: float = 0.5,
        use_projected_gradient: bool = True,
        transient: bool = True,
    ):
        ncomp = len(sym_comps(dim))
        super().__init__(stress_var(mode), ncomp, interp)
        self.mode = mode
        self.dim = dim
        self.lam = lam
        self.mu_p = mu_p
        self.model = model
        self.alpha = alpha
        self.eps_ptt = eps_ptt
        self.supg = supg
        self.use_projected_gradient = use_projected_gradient
        self.transient = transient

    def residual(self, fv, mat, params):
        d = self.dim
        comps = sym_comps(d)
        nq = fv.x.shape[0]
        var = self.var

        S = _sym_expand(fv.val[var], d)  # (nq, d, d)
        gu = fv.grad["velocity"]  # (nq, d, d)
        if self.use_projected_gradient and "velocity_gradient" in fv.val:
            L = full_from_comps(fv.val["velocity_gradient"], d)
        else:
            L = gu
        D = 0.5 * (gu + jnp.swapaxes(gu, 1, 2))
        u_adv = advective_velocity(fv)

        # material time derivative of S (components -> tensor)
        core = S - 2.0 * self.mu_p * D
        if self.lam > 0:
            conv = jnp.einsum(
                "qk,qabk->qab", u_adv,
                _sym_grad_expand(fv.grad[var], d),
            )
            LS = jnp.einsum("qac,qcb->qab", L, S)
            SLt = jnp.einsum("qac,qbc->qab", S, L)
            upper = conv - LS - SLt
            if self.transient:
                upper = upper + _sym_expand(fv.dot[var], d)
            core = core + self.lam * upper
            if self.model == "giesekus" and self.alpha != 0.0:
                SS = jnp.einsum("qac,qcb->qab", S, S)
                core = core + (self.alpha * self.lam / self.mu_p) * SS
            elif self.model in ("ptt", "ptt_linear") and self.eps_ptt != 0.0:
                trS = jnp.trace(S, axis1=1, axis2=2)
                z = self.eps_ptt * self.lam / self.mu_p * trS
                fac = jnp.exp(z) - 1.0 if self.model == "ptt" else z
                core = core + fac[:, None, None] * S

        # SUPG test function. tau = supg*h*|u| / (2|u|^2 + tiny): smooth at
        # u=0 (where it vanishes -- no streamline to stabilize along) and
        # AD-safe (jnp.linalg.norm has a NaN gradient at 0 under jacfwd).
        phi = fv.phi[var]  # (nq, nbf)
        if self.supg > 0:
            gphi = fv.gphi[var]
            u2 = jnp.sum(u_adv * u_adv, axis=1)
            tau = self.supg * fv.h_elem * jnp.sqrt(u2 + 1e-30) / (2.0 * u2 + 1e-12)
            w = phi + tau[:, None] * jnp.einsum("qk,qik->qi", u_adv, gphi)
        else:
            w = phi

        core_c = jnp.stack([core[:, a, b] for (a, b) in comps], axis=1)  # (nq, ncomp)
        return jnp.einsum("qc,qi->qci", core_c, w)


def _expm2_sym(A, scale=1.0):
    """Smooth closed-form exp(scale*A) for symmetric 2x2 (..., 2, 2).

    exp(A) = e^m [cosh(q) I + sinhc(q) (A - m I)] with m = tr(A)/2 and
    q^2 = ((A11-A22)/2)^2 + A12^2. cosh(q) and sinh(q)/q are even in q, so
    everything is a smooth function of q^2 — AD-safe at the degenerate point
    (unlike an eigendecomposition, whose jacfwd blows up at q=0)."""
    A = scale * A
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 1, 1]
    m = 0.5 * (a + c)
    q2 = 0.25 * (a - c) ** 2 + b * b
    small = q2 < 1e-8
    q2s = jnp.where(small, 1.0, q2)
    q = jnp.sqrt(q2s)
    coshq = jnp.where(small, 1.0 + q2 / 2 + q2 * q2 / 24, jnp.cosh(q))
    sinhc = jnp.where(small, 1.0 + q2 / 6 + q2 * q2 / 120, jnp.sinh(q) / q)
    em = jnp.exp(m)
    eye = jnp.eye(2, dtype=A.dtype)
    dev = A - m[..., None, None] * eye
    return em[..., None, None] * (
        coshq[..., None, None] * eye + sinhc[..., None, None] * dev
    )


def _x_over_sinh(x):
    """x/sinh(x), smooth and even; series for small x (AD-safe at 0)."""
    x2 = x * x
    small = x2 < 1e-8
    xs = jnp.where(small, 1.0, x)
    return jnp.where(small, 1.0 - x2 / 6 + 7 * x2 * x2 / 360, xs / jnp.sinh(xs))


def _eig2_sym(A):
    """Explicit eigendecomposition of symmetric 2x2 (..., 2, 2):
    returns (w (..., 2), R (..., 2, 2)) with A = R diag(w) R^T. Guarded at
    the degenerate point (falls back to the identity basis, with AD-safe
    double-where divisions); guard scales with the matrix so it works in
    f32 as well as f64."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 1, 1]
    eps = jnp.finfo(A.dtype).eps
    scale2 = a * a + 2 * b * b + c * c + 1.0  # +1: absolute floor near A=0
    tr2 = 0.5 * (a + c)
    disc2 = 0.25 * (a - c) ** 2 + b * b
    deg = disc2 < (eps * eps) * scale2
    disc = jnp.sqrt(jnp.where(deg, 1.0, disc2))
    disc = jnp.where(deg, 0.0, disc)
    w1 = tr2 - disc
    w2 = tr2 + disc
    # eigenvector of w2: the larger of (b, w2-a) and (w2-c, b)
    v0, v1 = b, disc + 0.5 * (c - a)
    u0, u1 = disc + 0.5 * (a - c), b
    pick = v0 * v0 + v1 * v1 >= u0 * u0 + u1 * u1
    e0 = jnp.where(pick, v0, u0)
    e1 = jnp.where(pick, v1, u1)
    nrm2 = e0 * e0 + e1 * e1
    nrm = jnp.sqrt(jnp.where(deg, 1.0, nrm2))
    c2 = jnp.where(deg, 1.0, e0 / jnp.where(deg, 1.0, nrm))
    s2 = jnp.where(deg, 0.0, e1 / jnp.where(deg, 1.0, nrm))
    # eigvec of w1 orthogonal; columns: [v(w1), v(w2)]
    R = jnp.stack([jnp.stack([-s2, c2], -1), jnp.stack([c2, s2], -1)], -1)
    w = jnp.stack([w1, w2], -1)
    return w, R


class LogConformationStress(Equation):
    """Log-conformation viscoelastic stress (2D, one mode).

    Parity: reference ``assemble_stress_log_conf`` (src/mm_fill_stress.c:2600)
    — the Fattal-Kupferman change of variables Psi = log(c) that keeps the
    conformation tensor SPD at high Weissenberg number:

        dPsi/dt + u.grad Psi - (Omega Psi - Psi Omega) - 2B
            = (1/lam)(exp(-Psi) - I)

    with Omega/B built from the velocity gradient projected onto c's
    eigenbasis. The momentum equation consumes the polymer stress
    tau = (mu_p/lam)(exp(Psi) - I) via ``LogConfMomentumStress``.
    Variable: sym components of Psi, stored in var "logconf{mode}".
    """

    def __init__(self, mode: int, lam: float, mu_p: float, interp: str = "Q1",
                 supg: float = 0.5, transient: bool = True,
                 use_projected_gradient: bool = True):
        super().__init__(f"logconf{mode}", 3, interp)  # 2D sym: (11, 12, 22)
        self.mode = mode
        self.lam = lam
        self.mu_p = mu_p
        self.supg = supg
        self.transient = transient
        self.use_projected_gradient = use_projected_gradient

    def residual(self, fv, mat, params):
        d = 2
        var = self.var
        Psi = _sym_expand(fv.val[var], d)  # (nq, 2, 2)
        gu = fv.grad["velocity"]
        if self.use_projected_gradient and "velocity_gradient" in fv.val:
            L = fv.val["velocity_gradient"].reshape(-1, d, d)
        else:
            L = gu
        u_adv = advective_velocity(fv)

        # Fattal-Kupferman decomposition in the eigenbasis of Psi. The
        # commutator [Omega, Psi] and 2B are each singular at degenerate
        # eigenvalues, but their SUM is smooth: in the eigenbasis it is
        #   [[2 M11, s], [s, 2 M22]],  s = (l2 M12 + l1 M21) (w2-w1)/(l2-l1)
        # and the divided difference (w2-w1)/(e^w2 - e^w1) =
        # e^{-wbar} (h/2)/sinh(h/2), h = w2-w1, is smooth through h = 0
        # (limit: comm + 2B -> 2 sym(L), the correct degenerate dynamics).
        w, Rm = _eig2_sym(Psi)  # Psi = R diag(w) R^T
        M = jnp.einsum("qia,qab,qbj->qij", jnp.swapaxes(Rm, 1, 2), L, Rm)
        m12, m21 = M[:, 0, 1], M[:, 1, 0]
        l1, l2 = jnp.exp(w[:, 0]), jnp.exp(w[:, 1])
        h = w[:, 1] - w[:, 0]
        wbar = 0.5 * (w[:, 0] + w[:, 1])
        dd = jnp.exp(-wbar) * _x_over_sinh(0.5 * h)  # (w2-w1)/(l2-l1)
        s = (l2 * m12 + l1 * m21) * dd
        Sum_h = jnp.stack(
            [
                jnp.stack([2.0 * M[:, 0, 0], s], -1),
                jnp.stack([s, 2.0 * M[:, 1, 1]], -1),
            ],
            -2,
        )
        comm_2B = jnp.einsum("qab,qbc,qdc->qad", Rm, Sum_h, Rm)

        conv = jnp.einsum("qk,qabk->qab", u_adv, _sym_grad_expand(fv.grad[var], d))
        expm = _expm2_sym(Psi, scale=-1.0)  # exp(-Psi), smooth closed form
        core = conv - comm_2B - (expm - jnp.eye(2)[None]) / self.lam
        if self.transient:
            core = core + _sym_expand(fv.dot[var], d)

        phi = fv.phi[var]
        if self.supg > 0:
            gphi = fv.gphi[var]
            u2 = jnp.sum(u_adv * u_adv, axis=1)
            tau_s = self.supg * fv.h_elem * jnp.sqrt(u2 + 1e-30) / (2.0 * u2 + 1e-12)
            wt = phi + tau_s[:, None] * jnp.einsum("qk,qik->qi", u_adv, gphi)
        else:
            wt = phi
        comps = sym_comps(d)
        core_c = jnp.stack([core[:, a, b] for (a, b) in comps], axis=1)
        return jnp.einsum("qc,qi->qci", core_c, wt)


def logconf_stress_tensor(fv, mode: int, lam: float, mu_p: float):
    """tau = (mu_p/lam)(exp(Psi) - I) for the momentum equation."""
    Psi = _sym_expand(fv.val[f"logconf{mode}"], 2)
    c = _expm2_sym(Psi)
    return (mu_p / lam) * (c - jnp.eye(2)[None])


def _sym_grad_expand(gS, d):
    """grad of symmetric components (nq, ncomp, dim) -> (nq, d, d, dim)."""
    comps = sym_comps(d)
    idx = {}
    for ci, (a, b) in enumerate(comps):
        idx[(a, b)] = ci
        idx[(b, a)] = ci
    rows = []
    for a in range(d):
        cols = [gS[:, idx[(a, b)], :] for b in range(d)]
        rows.append(jnp.stack(cols, axis=1))
    return jnp.stack(rows, axis=1)  # (nq, d, d, dim)


class SqrtConformationStress(Equation):
    """Square-root conformation evolution (Balci-Thomases-Renardy-Shelley):
    c = b b^T stays SPD by construction, with the rotation tensor a keeping
    b symmetric. Reference: ``assemble_stress_sqrt_conf``
    (src/mm_fill_stress.c:7416), source ``sqrt_conf_source:7210``, rotation
    ``compute_a_dot_b:6747``.

        lam (b_dot + u.grad b - b.g - a.b) + source(b) = 0
        source = -Z/2 (b^{-1} - b),  Z = 1 (Oldroyd-B) or the PTT factor
        a12 = (b01 g00 - b00 g01 + b11 g10 - b10 g11) / tr(b)   (2D)

    All Jacobian blocks (the reference's hand-coded d_source/d_a arrays) come
    from AD. 2D only (like the reference's primary use); variable
    "bconf<mode>" holds (b11, b12, b22), initialized to the identity.
    """

    def __init__(self, mode: int, lam: float, mu_p: float,
                 model: str = "oldroyd_b", eps_ptt: float = 0.0,
                 interp: str = "Q1", supg: float = 0.5,
                 use_projected_gradient: bool = False,
                 transient: bool = True):
        super().__init__(f"bconf{mode}", 3, interp)
        self.mode, self.lam, self.mu_p = mode, lam, mu_p
        self.model = model
        self.eps_ptt = eps_ptt
        self.supg = supg
        self.use_projected_gradient = use_projected_gradient
        self.transient = transient

    def residual(self, fv, mat, params):
        from goma_tpu.physics.fluid import advective_velocity

        d = 2
        var = self.var
        b = _sym_expand(fv.val[var], d)  # (nq, 2, 2)
        gu = fv.grad["velocity"]  # gu[q, a, k] = du_a/dx_k
        if self.use_projected_gradient and "velocity_gradient" in fv.val:
            gu = full_from_comps(fv.val["velocity_gradient"], d)
        u_adv = advective_velocity(fv)

        # reference index convention: g[a][b] = dv_b/dx_a = gu[b, a]
        # b.g:  (b g)_ij = b_ik g_kj = b_ik du_j/dx_k
        b_g = jnp.einsum("qik,qjk->qij", b, gu)
        # rotation: a12 from compute_a_dot_b (2D closed form)
        trb = b[:, 0, 0] + b[:, 1, 1] + 1e-16
        a12 = (b[:, 0, 1] * gu[:, 0, 0] - b[:, 0, 0] * gu[:, 1, 0]
               + b[:, 1, 1] * gu[:, 0, 1] - b[:, 1, 0] * gu[:, 1, 1]) / trb
        z = jnp.zeros_like(a12)
        a = jnp.stack([jnp.stack([z, a12], axis=-1),
                       jnp.stack([-a12, z], axis=-1)], axis=-2)
        a_b = jnp.einsum("qik,qkj->qij", a, b)

        det = b[:, 0, 0] * b[:, 1, 1] - b[:, 0, 1] * b[:, 1, 0] + 1e-16
        binv = jnp.stack([
            jnp.stack([b[:, 1, 1], -b[:, 0, 1]], axis=-1),
            jnp.stack([-b[:, 1, 0], b[:, 0, 0]], axis=-1),
        ], axis=-2) / det[:, None, None]
        if self.model in ("ptt", "ptt_linear") and self.eps_ptt != 0.0:
            trc = jnp.sum(b * b, axis=(1, 2))
            inner = self.eps_ptt * (trc - d)
            Z = jnp.exp(inner) if self.model == "ptt" else 1.0 + inner
        else:
            Z = jnp.ones_like(det)
        source = -0.5 * Z[:, None, None] * (binv - b)

        core = source
        if self.lam > 0:
            conv = jnp.einsum("qk,qabk->qab", u_adv,
                              _sym_grad_expand(fv.grad[var], d))
            upper = conv - b_g - a_b
            if self.transient:
                upper = upper + _sym_expand(fv.dot[var], d)
            core = core + self.lam * upper

        phi = fv.phi[var]
        if self.supg > 0:
            gphi = fv.gphi[var]
            u2 = jnp.sum(u_adv * u_adv, axis=1)
            tau_s = self.supg * fv.h_elem * jnp.sqrt(u2 + 1e-30) / (2.0 * u2 + 1e-12)
            wt = phi + tau_s[:, None] * jnp.einsum("qk,qik->qi", u_adv, gphi)
        else:
            wt = phi
        comps = sym_comps(d)
        # b12 equation: symmetrize (the a-rotation keeps b symmetric only
        # up to the discrete residual; test with the symmetric part)
        core = 0.5 * (core + jnp.swapaxes(core, 1, 2))
        core_c = jnp.stack([core[:, a_, b_] for (a_, b_) in comps], axis=1)
        return jnp.einsum("qc,qi->qci", core_c, wt)


def sqrtconf_stress_tensor(fv, mode: int, lam: float, mu_p: float):
    """tau = (mu_p/lam)(b b^T - I) for the momentum equation."""
    b = _sym_expand(fv.val[f"bconf{mode}"], 2)
    c = jnp.einsum("qik,qjk->qij", b, b)
    return (mu_p / lam) * (c - jnp.eye(2)[None])


class DGStressUpwind(InterfaceKernel):
    """Interior-face upwind advection for DISCONTINUOUS (P0/P1E) stress:
    the DG analog of the reference's neighbor-element stress coupling
    (``assemble_surface_stress``, src/mm_fill_stress.c:5017; the
    ``lec->J_stress_neighbor`` blocks come from jacfwd over the combined
    pair dofs). Adds lam (v.n)^- (s_ext - s_in) phi on the inflow side of
    every interior face (pairs from ``mesh.interface.interior_face_pairs``)."""

    def __init__(self, mode: int, lam: float, dim: int = 2):
        super().__init__(stress_var(mode), len(sym_comps(dim)))
        self.lam = lam

    def residual(self, sa, sb, mat_a, mat_b, params):
        v = sa.val["velocity"]
        vn = jnp.einsum("qk,qk->q", v, sa.normal)  # out of A into B
        s_a = sa.val[self.var]
        s_b = sb.val[self.var]
        ca = self.lam * jnp.minimum(vn, 0.0)[:, None, None] \
            * (s_b - s_a)[:, :, None] * sa.phi[self.var][:, None, :]
        cb = self.lam * jnp.minimum(-vn, 0.0)[:, None, None] \
            * (s_a - s_b)[:, :, None] * sb.phi[self.var][:, None, :]
        return ca, cb


class DGStressInflow(FaceKernel):
    """Inflow boundary closure for DG stress: exterior state = prescribed
    s_in (reference: stress inflow via tables in assemble_surface_stress)."""

    def __init__(self, mode: int, lam: float, s_in, dim: int = 2):
        super().__init__(stress_var(mode), len(sym_comps(dim)))
        self.lam = lam
        self.s_in = jnp.asarray(s_in)

    def residual(self, sfv, mat, params):
        v = sfv.val["velocity"]
        vn = jnp.einsum("qk,qk->q", v, sfv.normal)
        s = sfv.val[self.var]
        ds = self.s_in[None, :] - s
        return self.lam * jnp.minimum(vn, 0.0)[:, None, None] \
            * ds[:, :, None] * sfv.phi[self.var][:, None, :]


class AxisymHoopStress(Equation):
    """Hoop (theta-theta) viscoelastic stress component S_tt for
    axisymmetric (CYLINDRICAL) problems — the reference's s33 polymer-stress
    slot kept in 2D for axisymmetry (``include/rf_fem_const.h`` POLYMER_
    STRESS33*, assembled by ``assemble_stress_fortin`` with the cylindrical
    grad(e) terms).

    With axisymmetry (no swirl) the upper-convected derivative of the tt
    component decouples from the in-plane block:

        lam (S_tt_dot + u.grad S_tt - 2 (u_r/r) S_tt) + S_tt + g(S)
            = 2 mu_p (u_r/r)

    since L_tt = u_r / r. Pair with ``VEStress`` for the in-plane
    components and ``Momentum`` (axisym), whose hoop weak term picks up
    S_tt from ``fv.val["stress{m}_tt"]``. Giesekus/PTT closures use the
    full 3D invariants (tt enters S.S and tr S).
    """

    def __init__(self, mode: int, lam: float, mu_p: float,
                 model: str = "oldroyd_b", alpha: float = 0.0,
                 eps_ptt: float = 0.0, interp: str = "Q1",
                 supg: float = 0.5, transient: bool = True):
        super().__init__(f"{stress_var(mode)}_tt", 1, interp)
        self.mode = mode
        self.lam = lam
        self.mu_p = mu_p
        self.model = model
        self.alpha = alpha
        self.eps_ptt = eps_ptt
        self.supg = supg
        self.transient = transient

    def residual(self, fv, mat, params):
        if fv.coord not in ("cylindrical", "swirling"):
            raise ValueError("AxisymHoopStress requires an axisymmetric "
                             "Problem(coord=...)")
        var = self.var
        Stt = fv.val[var][:, 0]
        u = advective_velocity(fv)
        Ltt = u[:, 1] / fv.r  # u_r / r

        core = Stt - 2.0 * self.mu_p * Ltt
        if self.lam > 0:
            conv = jnp.einsum("qk,qk->q", u, fv.grad[var][:, 0, :])
            upper = conv - 2.0 * Ltt * Stt
            if self.transient:
                upper = upper + fv.dot[var][:, 0]
            core = core + self.lam * upper
            if self.model == "giesekus" and self.alpha != 0.0:
                core = core + (self.alpha * self.lam / self.mu_p) * Stt * Stt
            elif self.model in ("ptt", "ptt_linear") and self.eps_ptt != 0.0:
                Sip = _sym_expand(fv.val[stress_var(self.mode)], 2) \
                    if stress_var(self.mode) in fv.val else None
                trS = Stt + (jnp.trace(Sip, axis1=1, axis2=2)
                             if Sip is not None else 0.0)
                z = self.eps_ptt * self.lam / self.mu_p * trS
                fac = jnp.exp(z) - 1.0 if self.model == "ptt" else z
                core = core + fac * Stt

        phi = fv.phi[var]
        if self.supg > 0:
            gphi = fv.gphi[var]
            u2 = jnp.sum(u * u, axis=1)
            tau = self.supg * fv.h_elem * jnp.sqrt(u2 + 1e-30) / (2.0 * u2 + 1e-12)
            w = phi + tau[:, None] * jnp.einsum("qk,qik->qi", u, gphi)
        else:
            w = phi
        return jnp.einsum("q,qi->qi", core, w)[:, None, :]
