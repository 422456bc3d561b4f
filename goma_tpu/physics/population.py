"""Population-balance moment equations (QMOM).

Parity: reference ``src/mm_fill_population.c`` — transported moment
equations closed by quadrature (adaptive Wheeler inversion :44, growth /
nucleation sources). Moments M_k, k = 0..2N-1 of the particle size
distribution are advected with the flow; sources are evaluated at the
quadrature abscissas recovered from the moments.

    dM_k/dt + u.grad M_k = sum_j w_j [ k G(L_j) L_j^{k-1} ] + B0 L0^k  (+ ...)

The Wheeler algorithm builds the Jacobi matrix from moments; its
eigendecomposition gives abscissas/weights. For the small fixed N used here
(N <= 3) the symmetric tridiagonal eigenproblem is solved with explicit
formulas (N=1,2) — backend-portable, no LAPACK.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from goma_tpu.fem.equations import Equation
from goma_tpu.physics.fluid import advective_velocity

MOM_VAR = "moments"


def wheeler_n2(m):
    """Wheeler inversion for N=2 nodes from moments (m0..m3).
    Returns (weights (2,), abscissas (2,)). Batched over leading axes."""
    m0 = jnp.maximum(m[..., 0], 1e-300)
    s1 = m[..., 1] / m0
    s2 = m[..., 2] / m0
    s3 = m[..., 3] / m0
    # central moments
    c2 = jnp.maximum(s2 - s1**2, 1e-300)
    c3 = s3 - 3 * s1 * s2 + 2 * s1**3
    # Jacobi matrix [[a0, sqrt(b1)], [sqrt(b1), a1]]
    a0 = s1
    b1 = c2
    a1 = c3 / c2 + s1
    # eigenvalues of 2x2 symmetric
    tr = a0 + a1
    det = a0 * a1 - b1
    disc = jnp.sqrt(jnp.maximum(tr**2 / 4 - det, 0.0))
    L1 = tr / 2 - disc
    L2 = tr / 2 + disc
    # weights from first eigenvector components: w_i = m0 * v0i^2
    # eigenvector for L: (sqrt(b1), L - a0) normalized
    sb = jnp.sqrt(b1)

    def w_of(L):
        v0, v1 = sb, L - a0
        n2 = v0**2 + v1**2
        return m0 * v0**2 / jnp.maximum(n2, 1e-300)

    return jnp.stack([w_of(L1), w_of(L2)], -1), jnp.stack([L1, L2], -1)


def adaptive_wheeler_n2(m, rmin=(0.0, 1e-6), eabs: float = 1e-4):
    """Adaptive Wheeler inversion for up to N = 2 nodes (MAX_MOMENTS = 4,
    the reference's cap: ``2*N > MAX_MOMENTS`` errors out).

    Batched, jittable port of ``adaptive_wheeler``
    (``src/mm_fill_population.c:205``) with the reference's degeneracy
    ladder expressed as ``where`` selects instead of early returns:

    - ``m0 <= 0`` (or ``< PBE_FP_SMALL``): one zero node/weight;
    - ``m0 < rmin[0]``: collapse to a single node (w0=m0, L0=m1/m0);
    - unrealizable set (Wheeler ``b1 < 0``): Wright log-normal moment
      correction (``moment_correction_wright``), then re-invert;
    - degenerate recursion (``sig[2][2] <= 0``) or failed weight-ratio /
      node-separation tests (``minw/maxw <= rmin[1]`` or
      ``|L2-L1|/1 <= eabs``): collapse to a single node.

    Returns (weights (..., 2), nodes (..., 2), n_out (...,) int32); a
    collapsed set has w = (m0, 0), L = (m1/m0, 0).
    """
    small = 1e-300
    m = jnp.asarray(m)

    def invert(mm):
        m0 = jnp.maximum(mm[..., 0], small)
        a0 = mm[..., 1] / m0
        # Wheeler sigma recursion, k = 2 row (N = 2):
        # sig2_j = nu_{j+1} - a0 nu_j  (b0 = 0)
        sig2_2 = mm[..., 2] - a0 * mm[..., 1]
        sig2_3 = mm[..., 3] - a0 * mm[..., 2]
        # a1 = sig[2][3]/sig[2][2] - sig[1][2]/sig[1][1] (reference recursion)
        a1 = sig2_3 / jnp.where(jnp.abs(sig2_2) > small, sig2_2, small) - a0
        b1 = sig2_2 / m0
        return a0, a1, b1, sig2_2

    a0, a1, b1, sig22 = invert(m)
    # unrealizable (b1 < 0): Wright correction then re-invert
    unreal = b1 < 0.0
    m_fix = moment_correction_wright(m)
    m_use = jnp.where(unreal[..., None], m_fix, m)
    a0, a1, b1, sig22 = invert(m_use)

    # 2-node eigen solve of [[a0, -sqrt(b1)], [-sqrt(b1), a1]]
    b1c = jnp.maximum(b1, 0.0)
    tr = a0 + a1
    disc = jnp.sqrt(jnp.maximum(0.25 * (a0 - a1) ** 2 + b1c, 0.0))
    L1 = 0.5 * tr - disc
    L2 = 0.5 * tr + disc
    sb = jnp.sqrt(b1c)
    m0 = jnp.maximum(m_use[..., 0], small)

    def w_of(L):
        v0, v1 = sb, L - a0
        n2 = v0**2 + v1**2
        return m0 * v0**2 / jnp.maximum(n2, small)

    w1, w2 = w_of(L1), w_of(L2)

    # adaptivity ladder -> collapse to n = 1
    minw = jnp.minimum(w1, w2)
    maxw = jnp.maximum(w1, w2)
    sep = jnp.abs(L2 - L1)  # maxmab = 1 for n = 2 in the reference
    collapse = (
        (m_use[..., 0] < rmin[0])
        | (sig22 <= 0.0)
        | (minw / jnp.maximum(maxw, small) <= rmin[1])
        | (sep <= eabs)
    )
    zero = m[..., 0] <= small
    n_out = jnp.where(zero | collapse, 1, 2).astype(jnp.int32)
    Lmean = m_use[..., 1] / m0
    w_out = jnp.stack([
        jnp.where(zero, 0.0, jnp.where(collapse, m_use[..., 0], w1)),
        jnp.where(zero | collapse, 0.0, w2),
    ], axis=-1)
    L_out = jnp.stack([
        jnp.where(zero, 0.0, jnp.where(collapse, Lmean, L1)),
        jnp.where(zero | collapse, 0.0, L2),
    ], axis=-1)
    return w_out, L_out, n_out


class MomentEquations(Equation):
    """Four transported moments (N=2 QMOM) with growth G(L) and nucleation.

    growth: callable G(L) -> growth rate (jax scalar fn); nucleation_rate B0
    at size L0. ``adaptive=True`` closes the sources with the reference's
    adaptive Wheeler (degeneracy-safe node reduction + Wright correction,
    ``src/mm_fill_population.c:205``) instead of the plain N=2 inversion.
    """

    def __init__(self, growth=None, nucleation_rate: float = 0.0, L0: float = 0.0,
                 interp: str = "Q1", transient: bool = True, supg: float = 0.5,
                 adaptive: bool = False):
        super().__init__(MOM_VAR, 4, interp)
        self.growth = growth
        self.B0 = nucleation_rate
        self.L0 = L0
        self.transient = transient
        self.supg = supg
        self.adaptive = adaptive

    def residual(self, fv, mat, params):
        nq = fv.x.shape[0]
        M = fv.val[MOM_VAR]  # (nq, 4)
        gM = fv.grad[MOM_VAR]  # (nq, 4, dim)
        if "velocity" in fv.val:
            u = advective_velocity(fv)
            adv = jnp.einsum("qk,qck->qc", u, gM)
        else:
            u = jnp.zeros((nq, fv.dim))
            adv = jnp.zeros_like(M)
        r = adv
        if self.transient:
            r = r + fv.dot[MOM_VAR]

        # quadrature closure source
        if self.growth is not None or self.B0 != 0.0:
            if self.adaptive:
                w, L, _ = adaptive_wheeler_n2(M)  # (nq, 2)
            else:
                w, L = wheeler_n2(M)  # (nq, 2)
            src = jnp.zeros_like(M)
            ks = jnp.arange(4.0)
            if self.growth is not None:
                G = self.growth(L)  # (nq, 2)
                Lsafe = jnp.maximum(L, 1e-300)
                # k G(L_j) L_j^{k-1}
                term = jnp.einsum(
                    "k,qj,qkj->qk",
                    ks,
                    w * G,
                    Lsafe[:, None, :] ** jnp.maximum(ks - 1.0, 0.0)[None, :, None],
                )
                src = src + term
            if self.B0 != 0.0:
                src = src + self.B0 * self.L0 ** ks[None, :]
            r = r - src

        phi = fv.phi[MOM_VAR]
        if self.supg > 0 and "velocity" in fv.val:
            gphi = fv.gphi[MOM_VAR]
            u2 = jnp.sum(u * u, axis=1)
            tau = self.supg * fv.h_elem * jnp.sqrt(u2 + 1e-30) / (2.0 * u2 + 1e-12)
            w_t = phi + tau[:, None] * jnp.einsum("qk,qik->qi", u, gphi)
        else:
            w_t = phi
        return jnp.einsum("qc,qi->qci", r, w_t)


def lognormal_moments(m, i: int = 1, j: int = 3, n_moments: int = 4):
    """Moments of the log-normal distribution fitted through (m0, m_i, m_j).

    Reference: ``moments_set_lognormal`` (src/mm_fill_population.c:55):
    mu and sigma^2 from two moment ratios, then
    M_k = m0 exp(k mu + k^2 sigma^2 / 2). Batched over leading axes."""
    m0 = jnp.maximum(m[..., 0], 1e-300)
    ri = jnp.log(jnp.maximum(m[..., i], 1e-300) / m0)
    rj = jnp.log(jnp.maximum(m[..., j], 1e-300) / m0)
    mu = (j / (i * j - i * i)) * ri + (i / (i * j - j * j)) * rj
    sig2 = ((2.0 / (j * j)) * rj - (2.0 / (i * j)) * ri) / (1.0 - i / j)
    sig2 = jnp.maximum(sig2, 0.0)
    ks = jnp.arange(float(n_moments))
    return m0[..., None] * jnp.exp(ks * mu[..., None]
                                   + 0.5 * ks**2 * sig2[..., None])


def moment_correction_wright(m, n_moments: int = 4):
    """Wright log-normal moment correction (reference
    ``moment_correction_wright:78``, after Marchisio & Fox 2013): replace an
    unrealizable moment set by the average of the log-normal reconstructions
    through (m0, m1, m3) and (m0, m2, m3)."""
    m1 = lognormal_moments(m, 1, 3, n_moments)
    m2 = lognormal_moments(m, 2, 3, n_moments)
    return 0.5 * (m1 + m2)
