"""Porous-shell equation family: thin porous layers coupled to lubrication.

Parity targets (behavior, re-derived for the AD/vmapped assembly):

- ``assemble_porous_shell_closed`` (``src/mm_fill_shell.c:11117``):
  closed-cell saturation S with capillary imbibition against trapped-gas
  compression. Through-thickness Darcy velocity (``dPdz_function``,
  ``src/mm_fill_shell.c:10869``):

      dP/dz = (P_gas - P_lub - P_cap) / (S H),   v_z = -(k/mu) dP/dz
      P_gas = P0 nbar / (1 - S) + (Pref - Patm),  P_cap = 2 sigma cos(theta)/R
      k = phi r^2 / 8   (capillary-bundle permeability)

  Saturation rows: R_S,i = phi_i (dS/dt - v_z / (phi H)); the absorbed
  liquid re-enters the lubrication mass balance as a sink (``LubPorousSink``,
  the ``R_LUBP`` source at ``src/mm_fill_shell.c:11290``).
- ``assemble_porous_shell_open`` (``src/mm_fill_shell.c:11945``):
  open-cell pore pressure P with in-plane Darcy flow and through-thickness
  exchange with the lubrication layer:

      R_P,i = phi_i d/dt(H phi_p S(P))
              + H k k_rel(S) (grad P - grav) . grad(phi_i)
              + phi_i * (kappa/mu) (P - P_eff) / (2 S H)

  with S(P) the capillary retention curve (E_MASS/E_DIFF/E_SOUR terms).
- ``assemble_porous_shell_saturation`` (``src/mm_fill_shell.c:13197``):
  stacked saturation layers SHELL_SAT_1/2/3 exchanging liquid through
  interlayer capillary-pressure differences (implemented here as
  ``PorousShellStackLayer`` with a two-film conductance exchange).

Validated in ``tests/test_shell_porous.py``: closed-cell imbibition ODE
against scipy integration, open-cell linearized diffusion against the exact
sinusoid decay rate, and a two-layer stack conserving total liquid.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from goma_tpu.fem.equations import Equation
from goma_tpu.physics.materials import prop

SAT_CLOSED = "shell_sat_closed"   # SHELL_SAT_CLOSED
P_OPEN = "shell_press_open"       # SHELL_PRESS_OPEN
LUB_VAR = "lub_pressure"          # shared with physics.lubrication


def _gap(fv, mat, params, key="gap"):
    h = mat.get(key, 1.0)
    nq = fv.x.shape[0]
    return h(fv, mat, params) if callable(h) else \
        jnp.full(nq, float(h), dtype=fv.x.dtype)


def closed_cell_vz(fv, mat, params):
    """Through-thickness imbibition velocity v_z of the closed-cell model
    (dPdz_function, mm_fill_shell.c:10869). Material keys: porosity,
    pore_radius (R), pore_height (H), mu, sigma, contact_angle_deg, P0
    (trapped-gas pressure), Pref/Patm, nbar (gas moles multiplier)."""
    S = jnp.clip(fv.val[SAT_CLOSED][:, 0], 1e-4, 1.0 - 1e-6)
    phi_p = mat.get("porosity", 0.5)
    R = mat["pore_radius"]
    H = mat.get("pore_height", 1.0)
    mu = prop(mat, "mu", fv, params, 1.0)
    sigma = mat.get("sigma", 1.0)
    theta = jnp.deg2rad(jnp.asarray(mat.get("contact_angle_deg", 0.0),
                                    S.dtype))
    P0 = mat.get("P0", 1.0)
    # trapped-gas moles: the GASN field when the gas-dissolution equation
    # is active (reference: nbar = fv->sh_sat_gasn, mm_fill_shell.c:10967)
    if "shell_sat_gasn" in fv.val:
        nbar = fv.val["shell_sat_gasn"][:, 0]
    else:
        nbar = mat.get("nbar", 1.0)
    dPrefatm = mat.get("Pref", 0.0) - mat.get("Patm", 0.0)
    if LUB_VAR in fv.val:
        plub = fv.val[LUB_VAR][:, 0]
    else:
        pl = mat.get("lub_pressure", 0.0)
        plub = pl(fv, mat, params) if callable(pl) else \
            jnp.full_like(S, float(pl))
    k = phi_p * R ** 2 / 8.0
    Pcap = 2.0 * sigma * jnp.cos(theta) / R
    Pgas = P0 * nbar / (1.0 - S) + dPrefatm
    dPdz = (Pgas - plub - Pcap) / (S * H)
    return -(k / mu) * dPdz, phi_p, H


class PorousShellClosed(Equation):
    """SHELL_SAT_CLOSED rows: R_S = phi_i (dS/dt - v_z/(phi_p H))."""

    def __init__(self, interp: str = "Q1"):
        super().__init__(SAT_CLOSED, 1, interp)

    def residual(self, fv, mat, params):
        vz, phi_p, H = closed_cell_vz(fv, mat, params)
        phi = fv.phi[SAT_CLOSED]
        c = (fv.dot[SAT_CLOSED][:, 0] - vz / (phi_p * H))[:, None] * phi
        return c[:, None, :]


class LubPorousSink(Equation):
    """The closed-cell absorption's sink in the lubrication mass balance
    (R_LUBP source, mm_fill_shell.c:11290): R_lub,i += -phi_i * v_z.
    Add alongside ReynoldsFilm on the same shell block."""

    def __init__(self, interp: str = "Q1"):
        super().__init__(LUB_VAR, 1, interp)

    def residual(self, fv, mat, params):
        vz, _, _ = closed_cell_vz(fv, mat, params)
        phi = fv.phi[LUB_VAR]
        return (-(vz)[:, None] * phi)[:, None, :]


def linear_retention(S0=0.0, c=1.0, Smax=1.0):
    """Linear capillary retention S(P) = clip(S0 + c P) — the simplest
    curve; use van_genuchten_retention for realistic decks."""

    def S_of_P(P):
        return jnp.clip(S0 + c * P, 1e-6, Smax)

    return S_of_P


def van_genuchten_retention(alpha, n, S_res=0.0, S_sat=1.0):
    """Van Genuchten S(P) on capillary suction Pc = -P (P < 0 unsaturated):
    Se = (1 + (alpha Pc)^n)^(-m), m = 1 - 1/n. AD-safe at P = 0."""
    m = 1.0 - 1.0 / n

    def S_of_P(P):
        pc = jnp.maximum(-P, 0.0)
        Se = (1.0 + (alpha * pc) ** n) ** (-m)
        return S_res + (S_sat - S_res) * Se

    return S_of_P


class PorousShellOpen(Equation):
    """SHELL_PRESS_OPEN rows (mm_fill_shell.c:11945): open-cell pore
    pressure with in-plane Darcy flow + lubrication exchange. Material
    keys: porosity, permeability, krel (callable of S; default 1),
    retention (callable S(P); default linear), gap (porous layer height H),
    mu, kappa_cross (through-thickness exchange permeability; default 0),
    p_eff (ambient/lubrication pressure for the exchange), grav (dim,)."""

    def __init__(self, interp: str = "Q1", transient: bool = True):
        super().__init__(P_OPEN, 1, interp)
        self.transient = transient

    def residual(self, fv, mat, params):
        H = _gap(fv, mat, params)
        phi_p = mat.get("porosity", 0.5)
        kperm = mat["permeability"]
        mu = prop(mat, "mu", fv, params, 1.0)
        S_of_P = mat.get("retention", linear_retention())
        krel = mat.get("krel", None)
        P = fv.val[P_OPEN][:, 0]
        gP = fv.grad[P_OPEN][:, 0, :]
        phi = fv.phi[P_OPEN]
        gphi = fv.gphi[P_OPEN]
        S = S_of_P(P)
        kr = krel(S) if krel is not None else jnp.ones_like(S)
        pg = gP
        grav = mat.get("grav", None)
        if grav is not None:
            pg = pg - jnp.asarray(grav, dtype=P.dtype)[None, :]
        mob = H * (kperm / mu) * kr
        c = jnp.einsum("q,qk,qik->qi", mob, pg, gphi)
        kx = mat.get("kappa_cross", 0.0)
        if kx:
            peff = mat.get("p_eff", 0.0)
            pe = peff(fv, mat, params) if callable(peff) else peff
            Ssafe = jnp.maximum(S, 1e-4)
            c = c + ((kx / mu) * (P - pe) / (2.0 * Ssafe * H))[:, None] * phi
        if self.transient:
            # d/dt (H phi_p S(P)) = H phi_p S'(P) dP/dt via AD
            dS = jax.vmap(jax.grad(S_of_P))(P)
            c = c + (H * phi_p * dS * fv.dot[P_OPEN][:, 0])[:, None] * phi
        return c[:, None, :]


SAT_GASN = "shell_sat_gasn"       # SHELL_SAT_GASN


class PorousShellGasN(Equation):
    """SHELL_SAT_GASN rows (``assemble_porous_shell_gasn``,
    ``src/mm_fill_shell.c:11650``): trapped-gas inventory n in a closed-cell
    porous shell, dissolving into the invading liquid by Henry's law:

        R_n,i = phi_i * ( dn/dt - flux ),
        flux  = -Z/S * ( n/(1-S) - Patm/P0 ),   Z = RT D / (H^2 kH)

    with the reference's first-order Taylor extension outside
    S in [dS, 1-dS] (dS = 1e-2) so the flux stays finite as the cell
    saturates or empties. Couples to SHELL_SAT_CLOSED (S).

    Material keys: ``P0`` (initial gas pressure), ``Patm``, ``henry`` (kH),
    ``RT``, ``gas_diffusivity`` (D), ``pore_height`` (H)."""

    DS_CLAMP = 1e-2

    def __init__(self, interp: str = "Q1"):
        super().__init__(SAT_GASN, 1, interp)

    def residual(self, fv, mat, params):
        n = fv.val[SAT_GASN][:, 0]
        S = fv.val[SAT_CLOSED][:, 0]
        H = mat.get("pore_height", 1.0)
        P0 = mat.get("P0", 1.0)
        Patm = mat.get("Patm", 1.0)
        kH = mat.get("henry", 1.0)
        RT = mat.get("RT", 1.0)
        D = mat.get("gas_diffusivity", 1.0)
        Z = RT * D / (H * H * kH)
        Pbr = Patm / P0
        dS = self.DS_CLAMP

        def f(s):
            return -Z / s * (n / (1.0 - s) - Pbr)

        si = jnp.clip(S, dS, 1.0 - dS)
        fi = f(si)
        # d(fi)/dS at si (same algebra the reference hand-codes as fi_S)
        fi_S = Z / si ** 2 * (n / (1.0 - si) - Pbr) \
            - Z / si * n / (1.0 - si) ** 2
        inside = (S >= dS) & (S <= 1.0 - dS)
        flux = jnp.where(inside, f(jnp.where(inside, S, si)),
                         fi + (S - si) * fi_S)
        phi = fv.phi[SAT_GASN]
        c = (fv.dot[SAT_GASN][:, 0] - flux)[:, None] * phi
        return c[:, None, :]


class PorousShellStackLayer(Equation):
    """One layer of the stacked-saturation family SHELL_SAT_1/2/3
    (assemble_porous_shell_saturation, mm_fill_shell.c:13197): Richards in
    saturation form on layer l with capillary-pressure-difference exchange
    to the adjacent layers,

      R_l,i = phi_i H_l phi_l dS_l/dt
              + H_l D_l(S_l) grad(S_l) . grad(phi_i)
              + phi_i * sum_adj G_la (Pc_a(S_a) - Pc_l(S_l))

    (outflow toward the adjacent layer with the higher capillary suction)

    Material keys (suffix _1/_2/_3 per layer): gap_l, porosity_l,
    diffusivity_l (callable of S or constant), pcap_l (callable Pc(S)),
    exchange_G (interlayer conductance, shared)."""

    def __init__(self, layer: int, n_layers: int, interp: str = "Q1",
                 transient: bool = True):
        super().__init__(f"shell_sat_{layer + 1}", 1, interp)
        self.layer = layer
        self.n_layers = n_layers
        self.transient = transient

    def residual(self, fv, mat, params):
        l = self.layer + 1
        var = f"shell_sat_{l}"
        H = mat.get(f"gap_{l}", 1.0)
        phi_p = mat.get(f"porosity_{l}", 0.5)
        D = mat.get(f"diffusivity_{l}", 1.0)
        S = fv.val[var][:, 0]
        gS = fv.grad[var][:, 0, :]
        phi = fv.phi[var]
        gphi = fv.gphi[var]
        Dv = D(S) if callable(D) else jnp.full_like(S, float(D))
        c = jnp.einsum("q,qk,qik->qi", H * Dv, gS, gphi)
        G = mat.get("exchange_G", 0.0)
        if G:
            pc_l = mat.get(f"pcap_{l}", lambda s: -s)
            for a in (self.layer - 1, self.layer + 1):
                if 0 <= a < self.n_layers:
                    va = f"shell_sat_{a + 1}"
                    Sa = fv.val[va][:, 0]
                    pc_a = mat.get(f"pcap_{a + 1}", lambda s: -s)
                    # outflow toward the layer with higher capillary
                    # suction: J_{l->a} = G (Pc_a - Pc_l) added to R_l
                    c = c + (G * (pc_a(Sa) - pc_l(S)))[:, None] * phi
        if self.transient:
            c = c + (H * phi_p * fv.dot[var][:, 0])[:, None] * phi
        return c[:, None, :]
