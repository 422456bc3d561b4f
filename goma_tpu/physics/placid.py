"""PLACID: pseudo-steady surface-site / bulk-fraction kinetics solver.

Parity: ``src/mm_placid.c:165`` (``placid()``, Salinger & Moffat) — the
reference solves, at every surface quadrature point that carries a
Surface-Chemkin mechanism, a small dense damped-Newton system for the
surface site fractions (production rate of every site species = 0) and
bulk mole fractions (proportional to their deposition rates), with
pseudo-transient continuation (``calc_t`` heuristic time step), a
bounds-preserving damping rule (``calc_damping``, APPROACH=0.8), one
sum-to-one constraint per phase imposed on the largest-fraction species,
and convergence on a weighted update norm 10x tighter than the outer
nonlinear solver (EXTRA_ACCURACY=0.1). The converged ``sdot`` feeds
surface fluxes of the gas species (``src/mm_fill_species.c:2376``).

Redesign: the whole damped pseudo-transient Newton is ONE
``lax.while_loop`` over a fixed-shape state, the dim x dim Jacobian comes
from ``jax.jacfwd`` of the residual closure (replacing Surface Chemkin's
hand-coded ``skdsdx_``), the linear solve is a tiny dense
``jnp.linalg.solve``, and the solver ``vmap``s over all surface points —
thousands of independent few-dof Newton solves become one batched dense
kernel instead of a per-point LAPACK loop.

Surface-Chemkin concentration conventions (cgs or SI per ``units``):
gas species enter rates as concentrations ``X_g * P/(R T)``; surface
site species as ``z_k * sden0(phase)/kcov_k``; bulk species as
activities (= mole fractions). ``A`` therefore carries the usual
Chemkin surface units.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from goma_tpu.physics.kinetics import _UNITS

# reference mm_placid.c ifunc modes
SFLUX_INITIALIZE = 1
SFLUX_RESIDUAL = 2
SFLUX_JACOBIAN = 3
SFLUX_TRANSIENT = 4
# bulkFunc
BULK_DEPOSITION = 1
BULK_ETCH = 2

_APPROACH = 0.8          # calc_damping fraction of distance to the bound
_EXTRA_ACCURACY = 0.1    # surface solve overconverges 10x vs outer solver


class SurfaceMechanism:
    """Surface reaction mechanism over gas + site + bulk species.

    Species are ordered [gas (n_gas) | per-phase site/bulk blocks]. Each
    phase is ``(kind, count)`` with kind in {"site", "bulk"}; ``sden0``
    gives the site density per SITE phase (reference ``Ck.SDen0``),
    ``kcov`` the per-species site coverage (``Ck.Kcov``, default 1 for
    site species).

    nu, A, beta, Ea, orders: as :class:`~goma_tpu.physics.kinetics.
    ReactionNetwork` — mass-action rates r_j = k_j(T) prod c^ord with
    k = A T^beta exp(-Ea/RT); sdot = nu^T r (mol/area/s for surface
    rates).
    """

    def __init__(self, nu, A, Ea=None, beta=None, orders=None,
                 n_gas=1, phases=(("site", 1),), sden0=(1.0,), kcov=None,
                 units="si"):
        self.nu = np.asarray(nu, dtype=float)
        nr, ns = self.nu.shape
        self.A = np.asarray(A, dtype=float)
        self.Ea = np.zeros(nr) if Ea is None else np.asarray(Ea, float)
        self.beta = np.zeros(nr) if beta is None else np.asarray(beta, float)
        if orders is None:
            orders = np.where(self.nu < 0, -self.nu, 0.0)
        self.orders = np.asarray(orders, dtype=float)
        self.n_gas = int(n_gas)
        self.units = units
        # phase tables over the dim = ns - n_gas surface problem
        self.phases = list(phases)
        dim = ns - self.n_gas
        self.dim = dim
        kinds, starts, counts = [], [], []
        off = 0
        for kind, cnt in self.phases:
            kinds.append(kind)
            starts.append(off)
            counts.append(int(cnt))
            off += int(cnt)
        if off != dim:
            raise ValueError(f"phase counts sum to {off}, expected {dim}")
        self.kinds = kinds
        self.starts = np.asarray(starts)
        self.counts = np.asarray(counts)
        n_site_ph = sum(1 for k in kinds if k == "site")
        if len(sden0) != n_site_ph:
            raise ValueError("one sden0 per site phase")
        # per-surface-species site density and coverage tables
        sden_k = np.zeros(dim)
        is_site = np.zeros(dim, dtype=bool)
        phase_of = np.zeros(dim, dtype=np.int64)
        si = 0
        for p, (kind, cnt) in enumerate(self.phases):
            s = self.starts[p]
            phase_of[s:s + cnt] = p
            if kind == "site":
                sden_k[s:s + cnt] = float(sden0[si])
                is_site[s:s + cnt] = True
                si += 1
        self.sden_k = sden_k
        self.is_site = is_site
        self.phase_of = phase_of
        self.kcov = (np.ones(dim) if kcov is None
                     else np.asarray(kcov, dtype=float))
        self.sden_tot = float(sum(sden0))  # bulk relaxation time constant

    # ------------------------------------------------------------- rates
    def sdot(self, X_gas, z, T, P):
        """Molar production rates (ns,) of ALL species from activities:
        gas concentrations X_g P/(RT), site concentrations z sden0/kcov,
        bulk activities z."""
        R_u, _ = _UNITS[self.units]
        c_gas = jnp.maximum(X_gas, 0.0) * P / (R_u * T)
        c_surf = jnp.where(jnp.asarray(self.is_site),
                           z * jnp.asarray(self.sden_k / self.kcov),
                           jnp.maximum(z, 0.0))
        c = jnp.concatenate([c_gas, c_surf])
        logc = jnp.log(jnp.maximum(c, 1e-300))
        k = (jnp.asarray(self.A) * T ** jnp.asarray(self.beta)
             * jnp.exp(-jnp.asarray(self.Ea) / (_UNITS[self.units][0] * T)))
        r = k * jnp.exp(jnp.asarray(self.orders) @ logc)      # (nr,)
        return r @ jnp.asarray(self.nu)                       # (ns,)


def _phase_masks(mech: SurfaceMechanism):
    """(n_phase, dim) 0/1 membership masks (host, static)."""
    m = np.zeros((len(mech.phases), mech.dim))
    for p in range(len(mech.phases)):
        s, c = mech.starts[p], mech.counts[p]
        m[p, s:s + c] = 1.0
    return m


@partial(jax.jit, static_argnums=(0, 1, 2))
def placid(mech: SurfaceMechanism, ifunc: int, bulk_func: int,
           time_scale, X_gas, T, P, z0,
           reltol=1e-6, abstol=1e-9, iter_max=200):
    """One surface-point PLACID solve. Returns (z, sdot, converged).

    jittable; ``jax.vmap`` over (X_gas, T, P, z0) batches all surface
    points into one program. Faithful to ``mm_placid.c`` in: the
    pseudo-transient ``calc_t`` step with its <10-iteration free phase
    and 2x growth cap, the do_time -> steady handoff at ``time_scale``,
    per-phase sum-to-one row on the argmax species, bulk
    deposition/etch row forms, the APPROACH=0.8 bounds damping with
    3x damp growth cap, and the weighted update-norm convergence at
    0.1x(reltol, abstol)."""
    dim = mech.dim
    masks = jnp.asarray(_phase_masks(mech))               # (np, dim)
    is_site = jnp.asarray(mech.is_site)
    sden_k = jnp.asarray(mech.sden_k)
    kcov = jnp.asarray(mech.kcov)
    phase_of = jnp.asarray(mech.phase_of)
    is_bulk_ph = jnp.asarray(
        [1.0 if k == "bulk" else 0.0 for k in mech.kinds])
    time_scale = jnp.asarray(time_scale, dtype=jnp.result_type(float))

    do_time0 = ifunc in (SFLUX_INITIALIZE, SFLUX_TRANSIENT)

    def sdot_surf(z):
        return mech.sdot(X_gas, z, T, P)                   # (ns,)

    def residual(z, z_old, inv_t, do_time):
        sd = sdot_surf(z)
        sds = sd[mech.n_gas:]                              # (dim,)
        # per-phase growth rate: sum of positive sdots in BULK phases
        pos = jnp.maximum(sds, 0.0)
        gr_ph = masks @ pos * is_bulk_ph                   # (np,)
        gr_k = gr_ph[phase_of]                             # (dim,)
        # site rows: -kcov*sdot (+ pseudo-transient)
        r_site = -kcov * sds + do_time * inv_t * sden_k * (z - z_old)
        # bulk rows (deposition): z*GR - sdot_+ (negative sdot dropped);
        # etch or GR == 0: identity row freezes the fraction
        if bulk_func == BULK_DEPOSITION:
            r_dep = (z * gr_k - jnp.where(sds >= 0.0, sds, 0.0)
                     + do_time * inv_t * mech.sden_tot * (z - z_old))
            r_bulk = jnp.where(gr_k > 0.0, r_dep, z - z_old)
        else:
            r_bulk = z - z_old
        r = jnp.where(is_site, r_site, r_bulk)
        # per-phase sum constraint replaces the argmax-fraction row
        zmax = masks * z[None, :] - 1e30 * (1 - masks)
        spec = jnp.argmax(zmax, axis=1)                    # (np,)
        sums = masks @ z - 1.0                             # (np,)
        r = r.at[spec].set(sums)
        return r

    def calc_t(sd, z):
        """reference calc_t: max_i |kcov_i sdot_i| / (max(z_i,1e-12)
        sden0) over SITE species."""
        sds = sd[mech.n_gas:]
        t = jnp.abs(kcov * sds) / (jnp.maximum(z, 1e-12)
                                   * jnp.where(is_site, sden_k, jnp.inf))
        return jnp.max(jnp.where(is_site, t, 0.0))

    def calc_damping(z, dx, damp_old):
        """APPROACH=0.8 toward the violated bound; <=3x growth."""
        xnew = z - dx
        xtop = 1.0 - 0.1 * jnp.abs(1.0 - z)
        xbot = jnp.abs(z * 0.1) - 1e-16
        d_top = -_APPROACH * (1.0 - z) / jnp.where(dx == 0, 1.0, dx)
        d_bot = _APPROACH * z / jnp.where(dx == 0, 1.0, dx)
        d_big = -2.0 * jnp.maximum(z, 1e-10) / jnp.where(dx == 0, 1.0, dx)
        d = jnp.ones_like(z)
        d = jnp.where(xnew > xtop, d_top, d)
        d = jnp.where(xnew < xbot, d_bot, d)
        d = jnp.where((xnew <= xtop) & (xnew >= xbot)
                      & (xnew > 3.0 * jnp.maximum(z, 1e-10)), d_big, d)
        damp = jnp.clip(jnp.min(d), 1e-6, None)
        return jnp.minimum(damp, 3.0 * damp_old)

    def update_norm(z, dx, rel, ab):
        w = dx / (rel * jnp.abs(z) + ab)
        return jnp.sqrt(jnp.mean(w * w))

    jac = jax.jacfwd(residual, argnums=0)

    def body(st):
        z, damp_old, inv_t_prev, t_real, do_time, it, _ = st
        z_old = z
        sd = sdot_surf(z)
        # calc_t heuristics: free before iter 10, then 2x growth cap
        t_new = calc_t(sd, z)
        inv_t = jnp.where(it < 10, t_new,
                          jnp.minimum(t_new, 2.0 * inv_t_prev))
        if ifunc == SFLUX_TRANSIENT:
            # don't step past time_scale
            inv_t = jnp.where(t_real + 1.0 / jnp.maximum(inv_t, 1e-300)
                              > time_scale,
                              1.0 / jnp.maximum(time_scale - t_real, 1e-300),
                              inv_t)
        inv_t = jnp.where(do_time > 0, inv_t, 0.0)
        r = residual(z, z_old, inv_t, do_time)
        J = jac(z, z_old, inv_t, do_time)
        dx = jnp.linalg.solve(J, r)
        dx = jnp.where(jnp.all(jnp.isfinite(dx)), dx, jnp.zeros_like(dx))
        damp = calc_damping(z, dx, damp_old)
        un = update_norm(z, dx, reltol, abstol)
        z = z - damp * dx
        t_real = t_real + jnp.where(do_time > 0,
                                    damp / jnp.maximum(inv_t, 1e-300), 0.0)
        # do_time shuts off once t_real passes time_scale (steady endgame)
        do_time_n = jnp.where(t_real > time_scale, 0.0, do_time)
        return (z, damp, jnp.maximum(inv_t, 1e-300), t_real, do_time_n,
                it + 1, un)

    def cond(st):
        _, _, _, t_real, do_time, it, un = st
        if ifunc == SFLUX_TRANSIENT:
            live = t_real < time_scale
        else:
            live = (do_time > 0) | (un > _EXTRA_ACCURACY)
        return live & (it < iter_max)

    z0 = jnp.asarray(z0, dtype=jnp.result_type(float))
    st0 = (z0, jnp.asarray(1.0, z0.dtype), jnp.asarray(1e-300, z0.dtype),
           jnp.asarray(0.0, z0.dtype),
           jnp.asarray(1.0 if do_time0 else 0.0, z0.dtype),
           jnp.asarray(0, jnp.int32), jnp.asarray(1e6, z0.dtype))
    z, _, _, _, _, it, un = jax.lax.while_loop(cond, body, st0)
    sd = sdot_surf(z)
    conv = (un <= _EXTRA_ACCURACY) | jnp.asarray(ifunc == SFLUX_TRANSIENT)
    return z, sd, conv


def surface_kinetics_flux(mech: SurfaceMechanism, species_ids=None,
                          time_scale=1.0, z_init=None, reltol=1e-6,
                          abstol=1e-9, pressure=1.0, mode=SFLUX_RESIDUAL,
                          bulk_func=BULK_DEPOSITION):
    """Flux closure for the species YFLUX family: at every face
    quadrature point, solve the surface-site problem (placid) for the
    local gas composition and return the GAS-species surface production
    rates as inward normal fluxes — the reference's
    ``src/mm_fill_species.c:2376`` surface-chemkin flux hook.

    ``species_ids``: which transported species map to the mechanism's
    gas species (default 0..n_gas-1). Returns a callable
    ``(sfv, mat, params) -> (nq, len(species_ids))`` usable with
    :class:`goma_tpu.bc.free_surface.NormalFlux` (ncomp = n transported
    species) or any face kernel expecting a flux closure.
    """
    ids = list(range(mech.n_gas)) if species_ids is None else list(species_ids)
    if z_init is None:
        z_init = np.full(mech.dim, 1.0 / max(mech.dim, 1))

    def flux(sfv, mat, params):
        X = jnp.maximum(sfv.val["species"][:, jnp.asarray(ids)], 0.0)
        nq = X.shape[0]
        if "temperature" in sfv.val:
            T = sfv.val["temperature"][:, 0]
        else:
            T = jnp.ones(nq, dtype=X.dtype)
        P = jnp.full(nq, pressure, dtype=X.dtype)
        z0 = jnp.broadcast_to(jnp.asarray(z_init, X.dtype),
                              (nq, mech.dim))
        sv = jax.vmap(lambda Xg, Tq, Pq, z:
                      placid(mech, mode, bulk_func, time_scale,
                             Xg, Tq, Pq, z, reltol, abstol))
        _, sd, _ = sv(X, T, P, z0)
        # inward flux of transported species = surface production rate
        return sd[:, jnp.asarray(ids)]

    return flux
