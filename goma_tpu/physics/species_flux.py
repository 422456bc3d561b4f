"""Non-Fickian species flux models: Stefan-Maxwell multicomponent diffusion,
generalized-Fickian (full diffusivity matrix), and the HYDRODYNAMIC
shear-induced-migration suspension flux.

Parity: reference ``src/mm_fill_species.c`` mass-flux dispatch
(``get_continuous_species_terms:9117-9134``) — ``Stefan_Maxwell_diff_flux``
(``src/mm_fill_species.c:10439``), GENERALIZED_FICKIAN, and ``hydro_flux``
(``src/mm_std_models.c:3478``, Phillips/Leighton-Acrivos diffusive-flux
suspension model).

Design notes:
- Stefan-Maxwell inverts its (ns x ns) coefficient matrix *per quadrature
  point* with a batched dense solve — small-matrix ``jnp.linalg.solve``
  instead of the reference's per-point LU with scratch arrays.
- ``hydro_flux`` needs grad(shear-rate); like the reference (which solves a
  SHEAR_RATE projection equation to get nodal gammadot), we take it from a
  projected nodal field (``ProjectionEquation('shear_rate', ...)``) so the
  gradient is available without second derivatives of velocity.
- All Jacobian entries come from AD of these residuals; the reference's
  hand-coded c_term/mu_term/g_term sensitivities have no analog.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from goma_tpu.fem.equations import Equation, FaceKernel
from goma_tpu.physics.materials import prop
from goma_tpu.physics.fluid import _as_nq, advective_velocity


class StefanMaxwellSpecies(Equation):
    """Multicomponent Stefan-Maxwell transport of ns-1 mole fractions.

    The solved components are the first ns-1 mole fractions x_w; the last
    species is eliminated by sum(x) = 1 (reference: n_species =
    Num_Species_Eqn + 1, src/mm_fill_species.c:10495).

    The SM relations  grad x_i = sum_j (x_i J_j - x_j J_i) / (c D_ij)
    with closure sum_j J_j = 0 are solved pointwise for the molar fluxes J:
    per spatial direction the species couple through an (ns x ns) matrix
        A_ii = sum_{j!=i} x_j/(c D_ij),  A_ij = -x_i/(c D_ij)
    whose last row is replaced by the closure. Weak form of the conservation
    law then reads  phi*(xdot + u.grad x) - grad(phi) . J / c.
    """

    def __init__(self, n_species: int, D, c_total: float = 1.0,
                 interp: str = "Q1", transient: bool = True,
                 convection: bool = True):
        # n_species counts *solved* components (= reference Num_Species_Eqn)
        super().__init__("species", n_species, interp)
        self.ns = n_species + 1
        D = jnp.asarray(D, dtype=jnp.float64).astype(jnp.result_type(float))
        assert D.shape == (self.ns, self.ns), "D must be (ns+1, ns+1) SM diffusivities"
        self.D = D
        self.c_total = c_total
        self.transient = transient
        self.convection = convection

    def _fluxes(self, x_full, gx_full):
        """x_full (nq, ns), gx_full (nq, ns, dim) -> molar fluxes (nq, ns, dim)."""
        ns = self.ns
        c = self.c_total
        # pairwise inverse diffusivity with zero diagonal
        invD = jnp.where(jnp.eye(ns, dtype=bool), 0.0, 1.0 / (c * self.D))

        def solve_point(x, gx):
            # A J = B per spatial direction; directions share A
            A = -x[:, None] * invD
            A = A + jnp.diag(jnp.sum(invD * x[None, :], axis=1) - jnp.diag(A))
            # closure row: sum_j J_j = 0 replaces the last SM relation
            A = A.at[ns - 1, :].set(jnp.ones(ns, dtype=x.dtype))
            B = -gx  # (ns, dim)
            B = B.at[ns - 1, :].set(jnp.zeros(gx.shape[1], dtype=x.dtype))
            return jnp.linalg.solve(A, B)

        return jax.vmap(solve_point)(x_full, gx_full)

    def residual(self, fv, mat, params):
        nq = fv.x.shape[0]
        nsv = self.ncomp
        x = fv.val["species"]  # (nq, nsv) solved mole fractions
        gx = fv.grad["species"]  # (nq, nsv, dim)
        x_last = 1.0 - jnp.sum(x, axis=1, keepdims=True)
        gx_last = -jnp.sum(gx, axis=1, keepdims=True)
        x_full = jnp.concatenate([x, x_last], axis=1)
        gx_full = jnp.concatenate([gx, gx_last], axis=1)

        J = self._fluxes(x_full, gx_full)  # (nq, ns, dim) molar fluxes

        adv = jnp.zeros((nq, nsv))
        if self.transient:
            adv = adv + fv.dot["species"]
        if self.convection and "velocity" in fv.val:
            adv = adv + jnp.einsum("qk,qwk->qw", advective_velocity(fv), gx)
        phi = fv.phi["species"]
        gphi = fv.gphi["species"]
        contrib = jnp.einsum("qw,qi->qwi", adv, phi)
        contrib = contrib - jnp.einsum("qwk,qik->qwi", J[:, :nsv] / self.c_total, gphi)
        S = mat.get("species_source", None)
        if S is not None:
            Sval = S(fv, mat, params) if callable(S) else jnp.broadcast_to(
                jnp.asarray(S), (nq, nsv))
            contrib = contrib - jnp.einsum("qw,qi->qwi", Sval, phi)
        return contrib


class GeneralizedFickianSpecies(Equation):
    """Full diffusivity-matrix Fickian transport: J_w = -sum_v D_wv grad c_v.

    Reference: GENERALIZED_FICKIAN mass-flux model
    (``src/mm_fill_species.c`` fickian_flux generalized branch).
    ``D`` is (ns, ns), possibly non-symmetric (cross-diffusion).
    """

    def __init__(self, n_species: int, D, interp: str = "Q1",
                 transient: bool = True, convection: bool = True):
        super().__init__("species", n_species, interp)
        self.n_species = n_species
        D = jnp.asarray(D)
        assert D.shape == (n_species, n_species)
        self.D = D
        self.transient = transient
        self.convection = convection

    def residual(self, fv, mat, params):
        nq = fv.x.shape[0]
        c = fv.val["species"]
        gc = fv.grad["species"]  # (nq, ns, dim)
        adv = jnp.zeros((nq, self.n_species))
        if self.transient:
            adv = adv + fv.dot["species"]
        if self.convection and "velocity" in fv.val:
            adv = adv + jnp.einsum("qk,qwk->qw", advective_velocity(fv), gc)
        phi = fv.phi["species"]
        gphi = fv.gphi["species"]
        J = -jnp.einsum("wv,qvk->qwk", self.D, gc)
        contrib = jnp.einsum("qw,qi->qwi", adv, phi)
        contrib = contrib - jnp.einsum("qwk,qik->qwi", J, gphi)
        S = mat.get("species_source", None)
        if S is not None:
            Sval = S(fv, mat, params) if callable(S) else jnp.broadcast_to(
                jnp.asarray(S), (nq, self.n_species))
            contrib = contrib - jnp.einsum("qw,qi->qwi", Sval, phi)
        return contrib


class HydroSpecies(Equation):
    """Shear-induced particle migration (Phillips diffusive-flux model).

    Reference: HYDRODYNAMIC mass-flux model, ``hydro_flux``
    (``src/mm_std_models.c:3478``). The particle flux is

        N = - Kc a^2 (Y^2 grad(gd) + Y gd grad Y)          (collision term)
            - Kmu a^2 gd Y^2 (1/mu) (dmu/dY) grad Y        (viscosity term)
            + Dg a^2 Y f(Y) (rho_p - rho_f) g / mu0        (hindered settling)

    with gd the scalar shear rate taken from a *projected* nodal field
    (``gd_var``), exactly as the reference takes fv->SH from the SHEAR_RATE
    equation. f(Y) = (1 - Y/maxpack)^nexp * mu0/mu is the hindrance function
    (src/mm_std_models.c rel_mu_denom/mu_ppt). dmu/dY is evaluated by AD of
    the relative-viscosity closure mu(Y) = mu0 (1 - Y/maxpack)^nexp.

    Weak form: phi*(Ydot + u.grad Y) - grad(phi) . N.
    """

    def __init__(self, Kc: float, Kmu: float, a_rad: float = 1.0,
                 mu0: float = 1.0, maxpack: float = 0.68, nexp: float = -1.82,
                 settling=None, gd_var: str = "shear_rate",
                 interp: str = "Q1", transient: bool = True,
                 convection: bool = True, floor: float = 1e-2):
        super().__init__("species", 1, interp)
        self.Kc, self.Kmu, self.a2 = Kc, Kmu, a_rad * a_rad
        self.mu0, self.maxpack, self.nexp = mu0, maxpack, nexp
        # settling: None or (Dg, del_rho, gravity vector)
        self.settling = settling
        self.gd_var = gd_var
        self.transient = transient
        self.convection = convection
        self.floor = floor

    def _rel_visc(self, Y):
        """Krieger-Dougherty relative viscosity (floored like the reference's
        rel_mu_denom <= 0 -> 0.01 clamp, src/mm_std_models.c:3612)."""
        return jnp.maximum(1.0 - Y / self.maxpack, self.floor) ** self.nexp

    def particle_flux(self, fv, mat, params):
        """The Phillips diffusive particle flux N (nq, dim) at the given
        (element or face) field state — shared by the volumetric equation
        and the YFLUX_SUS boundary kernel (:class:`SuspensionFlux`)."""
        Y = fv.val["species"][:, 0]
        gY = fv.grad["species"][:, 0, :]  # (nq, dim)
        gd = fv.val[self.gd_var][:, 0]
        ggd = fv.grad[self.gd_var][:, 0, :]

        mu_rel = self._rel_visc(Y)
        dmurel_dY = jax.vmap(jax.grad(self._rel_visc))(Y)
        # (1/mu) dmu/dY is closure-independent of mu0
        dlnmu_dY = dmurel_dY / mu_rel

        # collision + viscosity-gradient fluxes
        N = -self.Kc * self.a2 * (
            (Y * Y)[:, None] * ggd + (Y * gd)[:, None] * gY
        )
        N = N - self.Kmu * self.a2 * (gd * Y * Y * dlnmu_dY)[:, None] * gY
        if self.settling is not None:
            Dg, del_rho, grav = self.settling
            grav = jnp.asarray(grav)
            hindrance = mu_rel ** (-1.0)  # f(Y) = mu0/mu
            N = N + (Dg * self.a2 * del_rho / self.mu0) * (
                Y * hindrance
            )[:, None] * grav[None, :]
        return N

    def residual(self, fv, mat, params):
        nq = fv.x.shape[0]
        gY = fv.grad["species"][:, 0, :]  # (nq, dim)
        N = self.particle_flux(fv, mat, params)

        adv = jnp.zeros(nq)
        if self.transient:
            adv = adv + fv.dot["species"][:, 0]
        if self.convection and "velocity" in fv.val:
            adv = adv + jnp.einsum("qk,qk->q", advective_velocity(fv), gY)
        phi = fv.phi["species"]
        gphi = fv.gphi["species"]
        contrib = jnp.einsum("q,qi->qi", adv, phi)
        contrib = contrib - jnp.einsum("qk,qik->qi", N, gphi)
        return contrib[:, None, :]


def koh_si_etch_rate_100(rho_H2O, rho_KOH, T):
    """Seidel et al. KOH/Si(100) wet-etch kinetics
    (``src/mm_std_models.c:6584 calc_KOH_Si_etch_rate_100``), transcribed
    verbatim: rate = H(rho_KOH) k0 C_H2O^4 C_KOH^0.25 exp(-Ea/kB T),
    smooth-gated over rho_KOH in [1e-6, 1e-4] g/cm^3, returned in cm/s."""
    k_B, E_a, k0 = 8.6173305e-5, 0.595, 2480.0
    MW_H2O, MW_KOH = 18.01528, 56.1056
    C_H2O = rho_H2O * 1000.0 / MW_H2O
    C_KOH = jnp.maximum(rho_KOH, 1e-30) * 1000.0 / MW_KOH
    lo, hi = 1.0e-6, 1.0e-4
    alpha = 0.5 * (hi - lo)
    z = (rho_KOH - (hi - alpha)) / alpha
    H = jnp.where(rho_KOH >= hi, 1.0,
                  jnp.where(rho_KOH <= lo, 0.0,
                            0.5 * (1.0 + z + jnp.sin(jnp.pi * z) / jnp.pi)))
    rate = H * k0 * C_H2O**4 * C_KOH**0.25 * jnp.exp(-E_a / (k_B * T))
    return rate / 1.0e4 / 3600.0


class KOHSiEtchFlux(FaceKernel):
    """YFLUX_ETCH (``src/mm_fill_species.c:4115 mass_flux_surf_etch``):
    KOH wet-etching species fluxes on a crystalline-Si(100) surface with
    the reference's species ordering (0 H2O, 1 KOH/OH-, 2 H2, 3 silicon
    hydroxyl byproducts) and stoichiometry

        q_0 = +2 (rho_Si/MW_Si) MW_H2O  R,   q_1 = +2 ... MW_OH  R,
        q_2 = -2 ... MW_H2 R,                q_3 = -1 ... MW_SiO2OH2 R.

    ``T``: process temperature (K)."""

    RHO_SI, MW_SI = 2.3290, 28.0855
    MWS = (18.01528, 17.008, 2.0 * 1.00794,
           28.0855 + 2.0 * 15.9994 + 2.0 * 17.008)
    STOICH = (2.0, 2.0, -2.0, -1.0)

    def __init__(self, comp: int, T: float, var: str = "species",
                 ncomp: int = 4):
        super().__init__(var, ncomp)
        self.comp = comp
        self.T = T

    def residual(self, sfv, mat, params):
        nq = sfv.x.shape[0]
        c = sfv.val[self.var]
        R = koh_si_etch_rate_100(c[:, 0], c[:, 1], self.T)
        q = self.STOICH[self.comp] * self.RHO_SI / self.MW_SI \
            * self.MWS[self.comp] * R
        phi = sfv.phi[self.var]
        out = jnp.zeros((nq, self.ncomp, phi.shape[1]), dtype=phi.dtype)
        return out.at[:, self.comp, :].set(q[:, None] * phi)


class ChargedSurfaceGradient(FaceKernel):
    """FICK_CHRGD_SURF_GRAD (``src/mm_fill_species.c:12579
    fickian_charged_gradient_bc``): pin the normal component of the
    charged-Fickian flux (diffusion + electromigration) at a boundary,

        n . (-D grad c - D z c (F/(R T)) grad V) = value

    applied as a penalty on the species rows (the reference's weak-strong
    hybrid). Material keys: ``diffusivity``, ``charge_number`` (z)."""

    F = 96487.0
    GAS_R = 8.314

    def __init__(self, value: float, z: float, T: float = 298.15,
                 comp: int = 0, var: str = "species", ncomp: int = 1,
                 penalty: float = 1e4, pot_var: str = "voltage"):
        super().__init__(var, ncomp)
        self.value, self.z, self.T = value, z, T
        self.comp = comp
        self.penalty = penalty
        self.pot_var = pot_var

    def residual(self, sfv, mat, params):
        nq = sfv.x.shape[0]
        D = prop(mat, "diffusivity", sfv, params, 1.0)
        gc = sfv.grad[self.var][:, self.comp, :]
        c = sfv.val[self.var][:, self.comp]
        n = sfv.normal
        flux = -D * jnp.einsum("qk,qk->q", gc, n)
        if self.pot_var in sfv.val:
            gV = sfv.grad[self.pot_var][:, 0, :]
            flux = flux - D * self.z * c * self.F / (self.GAS_R * self.T) \
                * jnp.einsum("qk,qk->q", gV, n)
        s = flux - self.value
        phi = sfv.phi[self.var]
        out = jnp.zeros((nq, self.ncomp, phi.shape[1]), dtype=phi.dtype)
        return out.at[:, self.comp, :].set(
            self.penalty * s[:, None] * phi)


class SuspensionFlux(FaceKernel):
    """YFLUX_SUS (``src/mm_fill_species.c:6706 sus_mass_flux_surf_bc``):
    weak suspension particle flux on the species rows,

        q_n = rho * n . N_hydro

    with N_hydro the Phillips shear-induced-migration flux of the
    HYDRODYNAMIC diffusivity model (``hydro_flux``,
    ``src/mm_std_models.c:3478``) — shared verbatim with
    :class:`HydroSpecies` via :meth:`HydroSpecies.particle_flux`, so the
    boundary condition and the volumetric transport use one closure (the
    reference couples them through ``s_terms.diff_flux``). ``rho`` is the
    suspension density (the reference's SUSPENSION density model; for
    SUSPENSION_PM particle phase pass the particle density).

    Requires the shear-rate projection field (``hydro.gd_var``) gathered on
    the face block — solved (:class:`ShearRateProjection`) or registered as
    a ``PassiveVar``."""

    def __init__(self, hydro: HydroSpecies, rho: float = 1.0,
                 var: str = "species", ncomp: int = 1, comp: int = 0):
        super().__init__(var, ncomp)
        self.hydro = hydro
        self.rho = rho
        self.comp = comp

    def residual(self, sfv, mat, params):
        nq = sfv.x.shape[0]
        N = self.hydro.particle_flux(sfv, mat, params)
        qn = self.rho * jnp.einsum("qk,qk->q", N, sfv.normal)
        phi = sfv.phi[self.var]
        out = jnp.zeros((nq, self.ncomp, phi.shape[1]), dtype=phi.dtype)
        # outward particle flux: + sign, same convention as PorousMassFlux
        return out.at[:, self.comp, :].set(qn[:, None] * phi)
