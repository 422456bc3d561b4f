"""Free-surface thin-film (shell) flow, film particles, and shell energy.

Parity targets (behavior, re-derived for AD/vmapped assembly):

- ``assemble_film`` (reference ``src/mm_fill_shell.c:8491``): coupled
  SHELL_FILMP / SHELL_FILMH system —

    R_P,i = phi_i * dH/dt - q . grad(phi_i) + phi_i * (EvapRate + flux_src)
    R_H,i = -sigma * grad(H) . grad(phi_i) + phi_i * P

  i.e. P is the capillary + disjoining film pressure (weak form of
  P = -sigma lap(H), the FILMH rows) and the film evolves by the Reynolds
  flux q = -(H^3/(3 mu)) * pg - beta_slip * H^2 * pg with the composite
  pressure gradient pg = grad(P) - grad(DisjPress(H)) - grav (flow-rate
  branch of ``calculate_lub_q_v``, ``src/mm_shell_util.c:4738-5110``,
  Newtonian k_turb = 3 with SlipCoeff).
- Disjoining pressure models ONE_TERM / TWO_TERM
  (``src/mm_std_models_shell.c:1193-1300``):
  TWO_TERM: Pi(H) = B * [ (H*/H)^n - factor * (H*/H)^m ],
  B = (sigma/H*) (n-1)(m-1)(1-cos(theta)) / (factor*(n-1) - (m-1)).
- ``film_evaporation_model`` CONC_POWER (``src/mm_std_models_shell.c:1038``):
  E = E0 (1 - C/CMax)^n for 0 < C < 0.95 CMax, else 0.
- ``assemble_film_particles`` (``src/mm_fill_shell.c:10188``):
    R_C,i = phi_i * H * dC/dt + (q . grad C) phi_i
            + D H grad(C) . grad(phi_i) - phi_i * C * EvapRate
  (the reference extrapolates q in time Adams-Bashforth-style for its
  explicit advection stabilization; the fully implicit AD path here uses
  the current q).
- ``assemble_shell_energy`` (``src/mm_fill_shell.c:7133``):
    R_T,i = rho Cp (H dT/dt + q . grad T) phi_i
            + H k_eff grad(T) . grad(phi_i) + phi_i * ht (T - T_amb)
  (signs normalized to this package's residual convention; the reference
  carries the opposite global sign on mass/advection).

Validated against exact solutions in ``tests/test_shell_film.py``
(fourth-order capillary leveling rate, evaporative concentration of
particles, fin-equation shell temperature).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from goma_tpu.fem.equations import Equation
from goma_tpu.physics.materials import prop

FILMP = "film_pressure"  # SHELL_FILMP
FILMH = "film_height"    # SHELL_FILMH
PARTC = "film_conc"      # SHELL_PARTC
SH_TEMP = "shell_temperature"  # SHELL_TEMPERATURE


# ----------------------------------------------------- disjoining pressure
def disjoining_two_term(angle_deg, nexp, mexp, h_star, factor=1.0,
                        sigma_key="sigma"):
    """TWO_TERM disjoining pressure Pi(H) (mm_std_models_shell.c:1203):
    attractive/repulsive power-law pair calibrated to an equilibrium
    contact angle. Returns a callable Pi(H, mat) for FilmFlux."""

    def pi_of_h(H, mat):
        sigma = mat.get(sigma_key, mat.get("sigma", 1.0))
        cosA = jnp.cos(jnp.deg2rad(jnp.asarray(angle_deg, H.dtype)))
        B = (sigma / h_star) * (nexp - 1.0) * (mexp - 1.0) * (1.0 - cosA) \
            / (factor * (nexp - 1.0) - (mexp - 1.0))
        r = h_star / jnp.maximum(H, 1e-12)
        return B * (r ** nexp - factor * r ** mexp)

    return pi_of_h


def disjoining_one_term(B, nexp, h_star):
    """ONE_TERM model Pi(H) = B (H*/H)^n (mm_std_models_shell.c:1261)."""

    def pi_of_h(H, mat):
        r = h_star / jnp.maximum(H, 1e-12)
        return B * r ** nexp

    return pi_of_h


def conc_power_evap(E0, nexp, CMax):
    """CONC_POWER film evaporation (mm_std_models_shell.c:1060): solvent
    evaporation shutting off as particle concentration approaches maximum
    packing. Returns callable E(fv, mat, params) reading film_conc."""

    def evap(fv, mat, params):
        if PARTC in fv.val:
            C = fv.val[PARTC][:, 0]
        else:
            C = jnp.zeros(fv.x.shape[0], dtype=fv.x.dtype)
        live = (C > 0.0) & (C < 0.95 * CMax)
        base = E0 * jnp.maximum(1.0 - C / CMax, 0.0) ** nexp
        return jnp.where(live, base, jnp.where(C <= 0.0, E0, 0.0))

    return evap


def _film_q(fv, mat, params):
    """Reynolds film flux q (free surface, one wall): the Newtonian
    flow-rate branch of calculate_lub_q_v for R_SHELL_FILMP
    (mm_shell_util.c:4960-5110, k_turb = 3)."""
    H = fv.val[FILMH][:, 0]
    gP = fv.grad[FILMP][:, 0, :]
    mu = prop(mat, "mu", fv, params, 1.0)
    pg = gP
    pi_fn = mat.get("disjoining", None)
    if pi_fn is not None:
        # grad(Pi(H)) = Pi'(H) grad(H) via AD
        dpi = jax.vmap(jax.grad(lambda h: pi_fn(h, mat)))(H)
        gH = fv.grad[FILMH][:, 0, :]
        pg = pg - dpi[:, None] * gH
    grav = mat.get("film_gravity", None)
    if grav is not None:
        pg = pg - jnp.asarray(grav, dtype=H.dtype)[None, :]
    # (H^3/(3 mu)) with mu either per-qp or constant
    mu_q = mu if getattr(mu, "ndim", 0) else jnp.full_like(H, mu)
    q = -(H ** 3 / (3.0 * mu_q))[:, None] * pg
    beta = mat.get("beta_slip", 0.0)
    if beta:
        q = q - beta * (H ** 2)[:, None] * pg
    return q, H


class FilmPressure(Equation):
    """SHELL_FILMP rows: film mass conservation (mm_fill_shell.c:8860).
    Material keys: mu, disjoining (callable Pi(H, mat), optional),
    film_gravity (dim,), beta_slip, evap (callable or constant),
    lub_source (callable, optional extra flux)."""

    def __init__(self, interp: str = "Q1", transient: bool = True):
        super().__init__(FILMP, 1, interp)
        self.transient = transient

    def residual(self, fv, mat, params):
        q, H = _film_q(fv, mat, params)
        phi = fv.phi[FILMP]
        gphi = fv.gphi[FILMP]
        c = -jnp.einsum("qk,qik->qi", q, gphi)
        ev = mat.get("evap", 0.0)
        E = ev(fv, mat, params) if callable(ev) else \
            jnp.full_like(H, float(ev))
        src = mat.get("lub_source", None)
        if src is not None:
            E = E + src(fv, mat, params)
        c = c + E[:, None] * phi
        if self.transient:
            c = c + fv.dot[FILMH][:, 0][:, None] * phi
        return c[:, None, :]


class FilmHeight(Equation):
    """SHELL_FILMH rows: weak capillary pressure definition
    P = -sigma lap(H) (mm_fill_shell.c:8905). Material key: sigma."""

    def __init__(self, interp: str = "Q1"):
        super().__init__(FILMH, 1, interp)

    def residual(self, fv, mat, params):
        sigma = prop(mat, "sigma", fv, params, 1.0)
        gH = fv.grad[FILMH][:, 0, :]
        P = fv.val[FILMP][:, 0]
        phi = fv.phi[FILMH]
        gphi = fv.gphi[FILMH]
        c = -sigma * jnp.einsum("qk,qik->qi", gH, gphi) + P[:, None] * phi
        return c[:, None, :]


class FilmParticles(Equation):
    """SHELL_PARTC rows: particle transport in the evaporating film
    (mm_fill_shell.c:10188). Material keys: D_partc, evap (shared with
    FilmPressure)."""

    def __init__(self, interp: str = "Q1", transient: bool = True):
        super().__init__(PARTC, 1, interp)
        self.transient = transient

    def residual(self, fv, mat, params):
        q, H = _film_q(fv, mat, params)
        C = fv.val[PARTC][:, 0]
        gC = fv.grad[PARTC][:, 0, :]
        phi = fv.phi[PARTC]
        gphi = fv.gphi[PARTC]
        adv = jnp.einsum("qk,qk->q", q, gC)
        c = adv[:, None] * phi
        D = mat.get("D_partc", 0.0)
        if D:
            c = c + D * jnp.einsum("q,qk,qik->qi", H, gC, gphi)
        ev = mat.get("evap", 0.0)
        E = ev(fv, mat, params) if callable(ev) else \
            jnp.full_like(H, float(ev))
        c = c - (C * E)[:, None] * phi
        if self.transient:
            c = c + (H * fv.dot[PARTC][:, 0])[:, None] * phi
        return c[:, None, :]


class ShellEnergy(Equation):
    """SHELL_TEMPERATURE rows: thermal energy in a lubrication film
    (mm_fill_shell.c:7133). Material keys: rho, Cp, k (conductivity),
    gap (film thickness H: constant or callable), lub_flux (callable
    q(fv, mat, params) -> (nq, dim), default 0 = conduction fin),
    ht_coeff / ht_tamb (ambient heat loss, mp->Lub_Heat_Xfer/Tamb)."""

    def __init__(self, interp: str = "Q1", transient: bool = False,
                 supg: float = 0.0):
        super().__init__(SH_TEMP, 1, interp)
        self.transient = transient
        self.supg = supg

    def residual(self, fv, mat, params):
        nq = fv.x.shape[0]
        rho = prop(mat, "rho", fv, params, 1.0)
        Cp = prop(mat, "Cp", fv, params, 1.0)
        k = prop(mat, "k", fv, params, 1.0)
        hfun = mat.get("gap", 1.0)
        H = hfun(fv, mat, params) if callable(hfun) else \
            jnp.full(nq, float(hfun), dtype=fv.x.dtype)
        T = fv.val[SH_TEMP][:, 0]
        gT = fv.grad[SH_TEMP][:, 0, :]
        phi = fv.phi[SH_TEMP]
        gphi = fv.gphi[SH_TEMP]
        qf = mat.get("lub_flux", None)
        wt = phi
        if qf is not None:
            q = qf(fv, mat, params)  # volumetric film flux (nq, dim)
            if self.supg > 0:
                v = q / jnp.maximum(H, 1e-30)[:, None]
                v2 = jnp.sum(v * v, axis=1)
                tau = self.supg * fv.h_elem / (2.0 * jnp.sqrt(v2 + 1e-30))
                wt = phi + tau[:, None] * jnp.einsum("qk,qik->qi", v, gphi)
            adv = jnp.einsum("qk,qk->q", q, gT)
            c = (rho * Cp * adv)[:, None] * wt
        else:
            c = jnp.zeros((nq, phi.shape[1]), dtype=fv.x.dtype)
        c = c + jnp.einsum("q,qk,qik->qi", H * k, gT, gphi)
        ht = mat.get("ht_coeff", 0.0)
        if ht:
            tamb = mat.get("ht_tamb", 0.0)
            c = c + (ht * (T - tamb))[:, None] * phi
        if self.transient:
            c = c + (rho * Cp * H * fv.dot[SH_TEMP][:, 0])[:, None] * wt
        return c[:, None, :]


SH_CONC = "shell_species"  # shell R_MASS rows


class ShellSpecies(Equation):
    """Scalar species transport in a lubrication gap, gap-integrated with
    concentration constant across the shell (``assemble_shell_species``,
    ``src/mm_fill_shell.c:8095``):

        R_c,i = H dc/dt phi_i + (q . grad c) phi_i
                + H D grad(c) . grad(phi_i) - s phi_i

    Material keys: ``D_shell`` (diffusivity, per species), ``gap`` (film
    thickness H: constant or callable), ``lub_flux`` (callable
    q(fv, mat, params) -> (nq, dim) volumetric film flux, default 0),
    ``shell_species_source`` (constant or callable — the reference's
    CONSTANT / ETCHING_KOH source models)."""

    def __init__(self, n_species: int = 1, interp: str = "Q1",
                 transient: bool = True):
        super().__init__(SH_CONC, n_species, interp)
        self.transient = transient

    def residual(self, fv, mat, params):
        nq = fv.x.shape[0]
        hfun = mat.get("gap", 1.0)
        H = hfun(fv, mat, params) if callable(hfun) else \
            jnp.full(nq, float(hfun), dtype=fv.x.dtype)
        C = fv.val[SH_CONC]                    # (nq, nw)
        gC = fv.grad[SH_CONC]                  # (nq, nw, dim)
        phi = fv.phi[SH_CONC]
        gphi = fv.gphi[SH_CONC]
        D = jnp.broadcast_to(
            jnp.asarray(mat.get("D_shell", 1.0), dtype=fv.x.dtype),
            (self.ncomp,))
        c = jnp.einsum("q,w,qwk,qik->qwi", H, D, gC, gphi)
        qf = mat.get("lub_flux", None)
        if qf is not None:
            q = qf(fv, mat, params)            # (nq, dim)
            c = c + jnp.einsum("qk,qwk,qi->qwi", q, gC, phi)
        s = mat.get("shell_species_source", None)
        if s is not None:
            sv = s(fv, mat, params) if callable(s) else \
                jnp.full((nq, self.ncomp), float(s), dtype=fv.x.dtype)
            c = c - jnp.einsum("qw,qi->qwi", sv, phi)
        if self.transient:
            c = c + jnp.einsum("q,qw,qi->qwi", H, fv.dot[SH_CONC], phi)
        return c
