"""Porous-media flow: saturated Darcy and unsaturated Richards equation.

Parity: reference ``src/mm_fill_porous.c`` (``assemble_porous_transport:106``,
property loading ``load_porous_properties:995``) — the saturated /
unsaturated liquid-phase transport subset, with van Genuchten / Mualem
closures re-derived from the standard formulas (the reference implements the
same models as hand-coded C with hand-coded derivatives).

Richards equation (pressure head form, liquid phase):
    phi * dS(p)/dt  -  div( k k_r(p)/mu * (grad p - rho g) ) = 0
"""

from __future__ import annotations

import jax.numpy as jnp

from goma_tpu.fem.equations import Equation
from goma_tpu.physics.materials import prop

POR_VAR = "porous_pressure"


class VanGenuchten:
    """S_eff(p) = [1 + (alpha |p|)^n]^(-m), m = 1-1/n for p < 0 (suction);
    Mualem relative permeability k_r = sqrt(S)[1-(1-S^(1/m))^m]^2."""

    def __init__(self, alpha: float, n: float, s_res: float = 0.0, s_sat: float = 1.0,
                 kr_min: float = 1e-6):
        # kr_min regularizes the dry limit (k_r, dS/dp -> 0 makes the system
        # singular; same role as the reference's porous cutoffs)
        self.alpha, self.n, self.m = alpha, n, 1.0 - 1.0 / n
        self.s_res, self.s_sat = s_res, s_sat
        self.kr_min = kr_min

    def saturation(self, p):
        # smooth through p=0: suction = softplus(-p) keeps AD well-behaved
        suction = jnp.where(p < 0, -p, 0.0)
        se = (1.0 + (self.alpha * suction) ** self.n) ** (-self.m)
        return self.s_res + (self.s_sat - self.s_res) * se

    def krel(self, p):
        suction = jnp.where(p < 0, -p, 0.0)
        se = (1.0 + (self.alpha * suction) ** self.n) ** (-self.m)
        # the saturated branch is exactly 1; the unsaturated branch is
        # evaluated at se clipped AWAY from 1 because (1 - se^(1/m))^m has
        # infinite slope at se = 1 — under forward-mode AD (jacfwd, the
        # assembly path) that becomes 0 * inf = NaN for every p >= 0
        se = jnp.clip(se, 1e-7, 1.0 - 1e-9)
        kr_unsat = jnp.sqrt(se) * (1.0 - (1.0 - se ** (1.0 / self.m)) ** self.m) ** 2
        kr = jnp.where(p < 0, kr_unsat, 1.0)
        return jnp.maximum(kr, self.kr_min)


class TwoPhasePorous(Equation):
    """Two-phase (liquid + gas) porous flow, components (p_liq, p_gas) of
    ``porous_pressure``. Reference: POROUS_TWO_PHASE media
    (``src/mm_fill_porous.c assemble_porous_transport:106`` gas-phase branch).

    Liquid:  phi dS/dt - div( k k_rl/mu_l (grad p_l - rho_l g) ) = 0
    Gas:     phi d[(1-S) rho_g]/dt
             - div( rho_g k k_rg/mu_g (grad p_g - rho_g g) ) = 0

    with S = S(p_c), p_c = p_g - p_l (van Genuchten), Mualem relative
    permeabilities k_rl(S), k_rg = sqrt(1-Se)(1 - Se^(1/m))^(2m). Gas is
    ideal-compressible when ``compressible`` (rho_g = rho_g_ref p_g/p_ref),
    else constant density.

    Material keys: permeability, porosity, mu_liquid, mu_gas, rho_liquid,
    rho_gas (reference density), p_ref, gravity_vec optional.
    """

    def __init__(self, model: VanGenuchten, interp: str = "Q1",
                 transient: bool = True, compressible: bool = False):
        super().__init__(POR_VAR, 2, interp)
        self.model = model
        self.transient = transient
        self.compressible = compressible

    def _sat_of_pc(self, pc):
        """S(p_c): suction = p_c > 0 dries the medium (same VG closure with
        p = -p_c)."""
        return self.model.saturation(-pc)

    def _krg(self, pc):
        m = self.model.m
        suction = jnp.where(pc > 0, pc, 0.0)
        se = (1.0 + (self.model.alpha * suction) ** self.model.n) ** (-m)
        se = jnp.clip(se, 1e-7, 1.0 - 1e-7)
        krg = jnp.sqrt(1.0 - se) * (1.0 - se ** (1.0 / m)) ** (2.0 * m)
        return jnp.maximum(krg, self.model.kr_min)

    def residual(self, fv, mat, params):
        import jax as _jax

        nq = fv.x.shape[0]
        pl = fv.val[POR_VAR][:, 0]
        pg = fv.val[POR_VAR][:, 1]
        gpl = fv.grad[POR_VAR][:, 0, :]
        gpg = fv.grad[POR_VAR][:, 1, :]
        pc = pg - pl

        k = prop(mat, "permeability", fv, params, 1.0)
        phi_por = prop(mat, "porosity", fv, params, 1.0)
        mul = prop(mat, "mu_liquid", fv, params, 1.0)
        mug = prop(mat, "mu_gas", fv, params, 1.0)
        rho_l = prop(mat, "rho_liquid", fv, params, 1.0)
        rho_g_ref = prop(mat, "rho_gas", fv, params, 1.0)
        p_ref = mat.get("p_ref", 1.0)
        rho_g = rho_g_ref * pg / p_ref if self.compressible else \
            rho_g_ref * jnp.ones_like(pg)

        krl = self.model.krel(-pc)
        krg = self._krg(pc)
        gvec = mat.get("gravity_vec", None)

        drive_l = gpl
        drive_g = gpg
        if gvec is not None:
            g = jnp.asarray(gvec)[None, :]
            drive_l = gpl - rho_l * g
            drive_g = gpg - rho_g[:, None] * g
        flux_l = (k * krl / mul)[:, None] * drive_l
        flux_g = (rho_g * k * krg / mug)[:, None] * drive_g

        phi_b = fv.phi[POR_VAR]
        gphi = fv.gphi[POR_VAR]
        rl = jnp.einsum("qk,qik->qi", flux_l, gphi)
        rg = jnp.einsum("qk,qik->qi", flux_g, gphi)
        if self.transient:
            dS = _jax.vmap(_jax.grad(self._sat_of_pc))(pc)
            pldot = fv.dot[POR_VAR][:, 0]
            pgdot = fv.dot[POR_VAR][:, 1]
            pcdot = pgdot - pldot
            S = self._sat_of_pc(pc)
            rl = rl + jnp.einsum("q,qi->qi", phi_por * dS * pcdot, phi_b)
            # gas storage: phi d[(1-S) rho_g]/dt
            gas_dot = -dS * pcdot * rho_g
            if self.compressible:
                gas_dot = gas_dot + (1.0 - S) * rho_g_ref / p_ref * pgdot
            rg = rg + jnp.einsum("q,qi->qi", phi_por * gas_dot, phi_b)
        return jnp.stack([rl, rg], axis=1)


class PorousFlow(Equation):
    """Saturated (model=None) or unsaturated (model=VanGenuchten) flow.

    Material keys: ``permeability`` k, ``porosity`` phi, ``mu_liquid``,
    ``gravity_vec`` optional (dim,).
    """

    def __init__(self, model: VanGenuchten | None = None, interp: str = "Q1",
                 transient: bool = True):
        super().__init__(POR_VAR, 1, interp)
        self.model = model
        self.transient = transient

    def residual(self, fv, mat, params):
        nq = fv.x.shape[0]
        p = fv.val[POR_VAR][:, 0]
        gp = fv.grad[POR_VAR][:, 0, :]
        k = prop(mat, "permeability", fv, params, 1.0)
        mu = prop(mat, "mu_liquid", fv, params, 1.0)
        phi_por = prop(mat, "porosity", fv, params, 1.0)

        hyst = isinstance(self.model, TanhHystSaturation)
        if hyst:
            kr = self.model.krel_fv(p, fv)
        else:
            kr = self.model.krel(p) if self.model is not None else 1.0
        mob = k * kr / mu
        drive = gp
        gvec = mat.get("gravity_vec", None)
        if gvec is not None:
            rho = prop(mat, "rho_liquid", fv, params, 1.0)
            drive = gp - rho * jnp.asarray(gvec)[None, :]
        flux = (mob if jnp.ndim(mob) == 0 else mob[:, None]) * drive

        phi_b = fv.phi[POR_VAR]
        gphi = fv.gphi[POR_VAR]
        contrib = jnp.einsum("qk,qik->qi", flux, gphi)
        if self.transient and self.model is not None:
            # phi * dS/dt = phi * S'(p) * pdot  (AD supplies S'(p) along the
            # active scanning curve for the hysteretic model)
            import jax as _jax

            if hyst:
                dS = _jax.vmap(_jax.grad(
                    lambda pp, cu, sw, pw: self.model.saturation_pc(
                        -pp, cu, sw, pw)))(
                    p, fv.ext["hyst_curve"], fv.ext["hyst_sat_switch"],
                    fv.ext["hyst_pc_switch"])
            else:
                dS = _jax.vmap(_jax.grad(lambda pp: self.model.saturation(pp)))(p)
            pdot = fv.dot[POR_VAR][:, 0]
            contrib = contrib + jnp.einsum("q,qi->qi", phi_por * dS * pdot, phi_b)
        if "sink_linear" in mat and SINK_VAR in fv.val:
            # absorbing-particle sink (reference porous sink mass coupling,
            # J_pm_sink_mass blocks via AD): liquid removed at rate A
            if hyst:
                S = self.model.saturation_fv(p, fv)
            else:
                S = self.model.saturation(p) if self.model is not None else 1.0
            A = sink_absorption_rate(fv, mat, params, S)
            contrib = contrib + jnp.einsum("q,qi->qi", A, phi_b)
        return contrib[:, None, :]


SINK_VAR = "sink_mass"


def sink_absorption_rate(fv, mat, params, saturation):
    """LINEAR porous-sink absorption rate (reference
    ``por_mass_source_model``, src/mm_fill_porous.c:11271):

        A = tau * k2 * (s_max - s) * S / s_max   (>= 0, gated on S >= S_on)

    Material key ``sink_linear`` = (tau, s_max, k2, S_on)."""
    tau, smax, k2, S_on = mat["sink_linear"]
    s = fv.val[SINK_VAR][:, 0]
    gate = jnp.where(saturation >= S_on, tau, 0.0)
    return gate * k2 * (smax - s) * saturation / smax


class PorousSinkMass(Equation):
    """Absorbed-mass evolution (reference ``assemble_pore_sink_mass``,
    src/mm_fill_porous.c:734): s_dot = rho_liquid * A with A the absorption
    rate; couple the matching ``-A`` liquid sink into ``PorousFlow`` via the
    ``sink_linear`` material key so total liquid + absorbed mass conserves."""

    def __init__(self, model: VanGenuchten | None = None, interp: str = "Q1"):
        super().__init__(SINK_VAR, 1, interp)
        self.model = model

    def residual(self, fv, mat, params):
        rho = prop(mat, "rho_liquid", fv, params, 1.0)
        if self.model is not None and POR_VAR in fv.val:
            S = self.model.saturation(fv.val[POR_VAR][:, 0])
        else:
            S = jnp.ones_like(fv.val[SINK_VAR][:, 0])
        A = sink_absorption_rate(fv, mat, params, S)
        r = fv.dot[SINK_VAR][:, 0] - rho * A
        return (r[:, None] * fv.phi[SINK_VAR])[:, None, :]


class TanhHystSaturation:
    """Hysteretic tanh saturation with scanning curves — the reference's
    TANH_HYST model (``src/mm_fill_porous.c:5773``) with its per-point
    reversal state (``rf_element_storage.c`` Sat_QP_tn / p_cap_QP /
    sat_curve_type) and the d(p_liq)/dt reversal criterion
    (``evaluate_sat_hyst_criterion``, mm_fill_porous.c:11210; the nodal
    variant rf_util.c:3982).

    State design: the reversal state lives in three NODAL fields
    (curve type 0=wetting/1=draining, S at reversal, p_c at reversal)
    passed as external fields — piecewise-frozen inside each time step, so
    the jitted residual stays branch-free (one ``jnp.where`` over the two
    curves) and AD supplies dS/dp along the active scanning curve. Between
    accepted steps ``update_state`` applies the reference switch rules on
    host.

    Parameters mirror u_saturation[0..9]: (s_max, beta_w, alpha_w) wetting,
    (s_min, beta_d, alpha_d) draining, initial curve, switch-rate
    threshold.
    """

    EXT_FIELDS = ("hyst_curve", "hyst_sat_switch", "hyst_pc_switch")

    def __init__(self, s_max: float, beta_w: float, alpha_w: float,
                 s_min: float, beta_d: float, alpha_d: float,
                 draining_initial: bool = True,
                 switch_threshold: float = 0.0, kr_min: float = 1e-6,
                 mualem_m: float = 0.5):
        self.s_max, self.beta_w, self.alpha_w = s_max, beta_w, alpha_w
        self.s_min, self.beta_d, self.alpha_d = s_min, beta_d, alpha_d
        self.draining_initial = draining_initial
        self.switch_threshold = switch_threshold
        self.kr_min = kr_min
        self.mualem_m = mualem_m

    # ---------------------------------------------------------- curves
    def saturation_pc(self, pc, curve, sat_sw, pc_sw):
        """S(p_c) on the active scanning curve through the reversal point
        (mm_fill_porous.c:5823-5885 con_a/con_b construction)."""
        pc = jnp.maximum(pc, 1e-5)
        pc_sw = jnp.maximum(pc_sw, 1e-5)
        td = jnp.tanh(self.beta_d - self.alpha_d / pc)
        td_sw = jnp.tanh(self.beta_d - self.alpha_d / pc_sw)
        # The anchoring denominators vanish when pc_sw sits in the curve's
        # degenerate region (pc_sw << alpha/beta, where tanh saturates) —
        # both for the inactive jnp.where branch (draining-initial wetting
        # anchor at pc_sw ~ 0) and for reversals detected at very low
        # suction. Clamp sign-safely: keeps values and AD gradients finite
        # and bounds the scanning-curve slope, at the cost of an O(clamp)
        # anchoring error exactly where the curves carry no information.
        den_d = jnp.minimum(-1.0 + td_sw, -1e-2)
        con_b_d = (sat_sw - self.s_min) / den_d
        S_d = (self.s_min - con_b_d) + con_b_d * td
        tw = jnp.tanh(self.beta_w - self.alpha_w / pc)
        tw_sw = jnp.tanh(self.beta_w - self.alpha_w / pc_sw)
        den_w = jnp.maximum(tw_sw + 1.0, 1e-2)
        con_b_w = (sat_sw - self.s_max) / den_w
        S_w = (1.0 + con_b_w) + con_b_w * tw
        return jnp.clip(jnp.where(curve >= 0.5, S_d, S_w), 0.0, 1.0)

    def saturation_fv(self, p, fv):
        """S at quadrature points; Richards convention p_c = -p_liq
        (p_gas = 0)."""
        return self.saturation_pc(-p, fv.ext["hyst_curve"],
                                  fv.ext["hyst_sat_switch"],
                                  fv.ext["hyst_pc_switch"])

    def krel_fv(self, p, fv):
        """Mualem k_r on the effective saturation of the current state."""
        S = self.saturation_fv(p, fv)
        # high clip away from 1: (1 - se^(1/m))^m has infinite slope at
        # se = 1, a 0*inf = NaN under jacfwd (see VanGenuchten.krel)
        se = jnp.clip((S - self.s_min) / (self.s_max - self.s_min),
                      1e-7, 1.0 - 1e-9)
        m = self.mualem_m
        kr = jnp.sqrt(se) * (1.0 - (1.0 - se ** (1.0 / m)) ** m) ** 2
        return jnp.maximum(kr, self.kr_min)

    # ----------------------------------------------------------- state
    def init_state(self, n_nodes: int) -> dict:
        """Main-curve initial state (rf_element_storage.c:352-370)."""
        import numpy as _np

        if self.draining_initial:
            sat_sw = self.s_max
            pc_sw = 1e-12
        else:
            pc_sw = 1e12 * self.alpha_w
            sat_sw = self.s_max - (self.s_max - self.s_min) * 0.5 * (
                1.0 + _np.tanh(self.beta_w - self.alpha_w / pc_sw))
        return {
            "hyst_curve": _np.full(n_nodes, 1.0 if self.draining_initial else 0.0),
            "hyst_sat_switch": _np.full(n_nodes, sat_sw),
            "hyst_pc_switch": _np.full(n_nodes, pc_sw),
        }

    def update_state(self, state: dict, p_nodal, pdot_nodal) -> dict:
        """Apply the reversal rules after an accepted step
        (mm_fill_porous.c:11230-11265): dp_liq/dt > 0 means imbibing;
        switch curve when the rate crosses sign with magnitude above the
        threshold, snapshotting (S, p_c) as the new reversal point."""
        import numpy as _np

        p = _np.asarray(p_nodal, dtype=float)
        pdot = _np.asarray(pdot_nodal, dtype=float)
        pc = _np.maximum(-p, 1e-5)
        curve = state["hyst_curve"].copy()
        ssw = state["hyst_sat_switch"].copy()
        pcsw = state["hyst_pc_switch"].copy()
        import numpy as np

        S_now = _np.asarray(self.saturation_pc(
            jnp.asarray(pc), jnp.asarray(curve), jnp.asarray(ssw),
            jnp.asarray(pcsw)))
        thr = self.switch_threshold
        to_wet = (pdot > 0) & (curve >= 0.5) & (np.abs(pdot) > thr) & (S_now <= 0.9999)
        to_dry = (pdot <= 0) & (curve < 0.5) & (np.abs(pdot) > thr)
        for mask, newc in ((to_wet, 0.0), (to_dry, 1.0)):
            curve[mask] = newc
            ssw[mask] = S_now[mask]
            pcsw[mask] = pc[mask]
        return {"hyst_curve": curve, "hyst_sat_switch": ssw,
                "hyst_pc_switch": pcsw}
