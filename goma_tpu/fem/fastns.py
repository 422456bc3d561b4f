"""Fused hand-derived residual+Jacobian for the incompressible NS Q2/Q1
block — the framework's hottest element kernel (BASELINE config #1 and the
velocity/pressure core of configs #2-#5).

Why this exists: the generic path AD's the per-element residual
(``jax.jacfwd`` with ~22 tangents, ``fem/assembly.py``). That is exact and
fully general, but every intermediate carries tiny trailing axes
((nq, dim, dim) etc.), which leaves wide vector units mostly idle.

Formulation (in place of an element-last quadrature loop):

1. **The geometry is fixed and rho/mu are constant, so every linear term
   is state-independent.** The viscous, pressure-gradient, divergence and
   mass blocks of the element Jacobian are PRECOMPUTED ONCE on the host
   (``Kfix``, ``Mvel``); the linear part of the residual is the batched
   matvec ``Kfix . q`` (exact: those terms are linear homogeneous in q).
   Per Newton iteration only the convection terms are rebuilt.
2. **The convection terms contract over the 9-point quadrature axis as
   tall-skinny GEMMs** (``(a*e, q) x (q, i)`` shapes with the huge element
   axis in M/N), which XLA hands to its matrix-product kernels instead of
   narrow elementwise work. No quadrature loop remains.

The Jacobian entries are the hand-derived linearization (matching the
reference's hand-coded ``lec->J`` of ``src/mm_fill_momentum.c:98`` /
``src/mm_fill_continuity.c:113``), verified against the AD path in tests
(the ``mm_numjac`` idea, AD as the oracle).

Scope (recognized by ``match_ns_q2q1``): one 2D block, equations exactly
[Momentum(dim=2), Continuity], any nodal velocity/pressure interpolation
pair, Galerkin terms only (no SUPG/PSPG/VE/DEVSS/body force/mass source),
constant scalar rho/mu, fixed geometry (no ALE), optional transient term
(ct/hist). Everything else falls back to the generic AD path.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def build_tables(problem, bi: int):
    """Host-precomputed tables for a fixed-geometry block.

    Returns (device_tables, static):
      fns:gphi  (nq, nbf_u, dim, ne)  velocity-basis physical gradients
      fns:w     (nq, ne)              quadrature weight x detJ
      fns:Kfix  (nl, nl, ne)          state-independent Jacobian blocks
                                      (viscous + pressure-grad + div)
      fns:Mvel  (nbf_u, nbf_u, ne)    rho * velocity mass matrix (per
                                      component; block-diagonal in a)
    plus static basis values Nu/Np and slot layout.
    """
    from goma_tpu.elements import element_type, eval_basis, geom_interp, volume_rule

    bd = problem.dofmap.blocks[bi]
    blk = problem.mesh.blocks[bi]
    et = element_type(blk.elem_type)
    qpts, qwts = volume_rule(et.family, problem.quad_order)
    gi = geom_interp(et)
    Ng, dNg = eval_basis(et.family, gi, qpts)
    X = problem.mesh.coords[blk.conn]  # (ne, nn, dim)
    Jm = np.einsum("qnd,enk->eqkd", dNg, X)
    detJ = np.linalg.det(Jm)
    invJ = np.linalg.inv(Jm)  # (ne, nq, d, k): dxi_d/dx_k

    su = bd.slot("velocity")
    sp = bd.slot("pressure")
    Nu, dNu = eval_basis(et.family, su.interp, qpts)
    Np_, dNp = eval_basis(et.family, sp.interp, qpts)
    gphi = np.einsum("qnd,eqdk->qnke", dNu, invJ)  # (nq, nbf_u, dim, ne)
    w = (qwts[None, :] * detJ).T  # (nq, ne)

    mat = problem.materials[bi]
    rho, mu = float(mat.get("rho", 1.0)), float(mat.get("mu"))
    nbu, nbp = Nu.shape[1], Np_.shape[1]
    usz = 2 * nbu
    nl = usz + nbp
    ne = X.shape[0]

    # ---- state-independent Jacobian blocks (also the linear residual) ----
    # viscous: d r_u[a,i] / d u[b,j] = w * mu * (delta_ab g_i.g_j
    #                                            + g[i,b] g[j,a])
    gg = np.einsum("qe,qike,qjke->ije", w, gphi, gphi)          # g_i . g_j
    cross = np.einsum("qe,qibe,qjae->abije", w, gphi, gphi)
    Juu = mu * (np.einsum("ab,ije->abije", np.eye(2), gg) + cross)
    # pressure gradient: d r_u[a,i] / d p[j] = -w g[i,a] P_j
    Jup = -np.einsum("qe,qiae,qj->aije", w, gphi, Np_)
    # divergence: d r_p[j] / d u[b,i] = w P_j g[i,b]
    Jpu = np.einsum("qe,qj,qibe->jbie", w, Np_, gphi)

    Kfix = np.zeros((nl, nl, ne))
    # velocity comp-major layout: local dof (a, i) -> a*nbu + i
    Kfix[:usz, :usz] = np.transpose(Juu, (0, 2, 1, 3, 4)).reshape(usz, usz, ne)
    Kfix[:usz, usz:nl] = Jup.reshape(usz, nbp, ne)
    Kfix[usz:nl, :usz] = Jpu.reshape(nbp, usz, ne)

    Mvel = rho * np.einsum("qe,qi,qj->ije", w, Nu, Nu)  # (nbu, nbu, ne)

    return {
        "fns:gphi": gphi.astype(np.float64),
        "fns:w": w.astype(np.float64),
        "fns:Kfix": Kfix.astype(np.float64),
        "fns:Mvel": Mvel.astype(np.float64),
    }, {"Nu": Nu, "Np": Np_, "su": (su.start, su.size, su.nbf),
        "sp": (sp.start, sp.size, sp.nbf)}


def node_gather(x, gnode, gp):
    """Element-local dof gather exploiting node-major dof adjacency: the
    (u, v) pair at each velocity node is fetched as ONE width-2 dynamic
    slice (vmapped -> an XLA gather of 2-wide rows), so the pass issues 13
    gather rows per element instead of 22 scalar loads (not measured on
    the GPU). Returns (ne, nl) in the comp-major slot layout the kernel
    expects."""
    uv = jax.vmap(jax.vmap(
        lambda i: jax.lax.dynamic_slice(x, (i,), (2,))))(gnode)
    p = x[gp]
    return jnp.concatenate([uv[..., 0], uv[..., 1], p], axis=1)


def build_node_gather(problem, bi: int):
    """Host-side verification + tables for :func:`node_gather`: requires
    the v dof to sit directly after the u dof at every velocity node
    (node-major numbering with velocity registered first — true for every
    matched NS block, but VERIFIED here; returns None to fall back)."""
    bd = problem.dofmap.blocks[bi]
    su = bd.slot("velocity")
    sp = bd.slot("pressure")
    g = bd.gather
    nbu = su.nbf
    gu = g[:, su.start:su.start + nbu]
    gv = g[:, su.start + nbu:su.start + 2 * nbu]
    gp = g[:, sp.start:sp.start + sp.nbf]
    if not np.array_equal(gv, gu + 1):
        return None
    if su.start != 0 or sp.start != 2 * nbu:
        return None  # kernel assumes [u, v, p] slot order
    return gu.astype(np.int32), gp.astype(np.int32)


def select_tables(T, bi: int, dtype):
    """Pick the precision-matched device tables for block ``bi``.

    The tables are stored in the problem dtype AND (when that is f64) a
    pre-cast f32 copy, so the per-iteration jit does not re-cast the
    (nl, nl, ne) ``Kfix`` stream, which is larger than the element kernel's
    own work (not measured on the GPU).
    """
    keys = ("fns:gphi", "fns:w", "fns:Kfix", "fns:Mvel")
    if jnp.dtype(dtype) == jnp.float32 and f"{keys[0]}32:{bi}" in T:
        return {k: T[f"{k}32:{bi}"] for k in keys}
    return {k: T[f"{k}{bi}"] for k in keys}


def match_ns_q2q1(problem, bi: int):
    """Return static meta if block bi is the recognized NS Galerkin block."""
    from goma_tpu.fem.fields import MESH_VAR
    from goma_tpu.physics.fluid import Continuity, Momentum

    bd = problem.dofmap.blocks[bi]
    eqs = problem.equations[bi]
    if len(eqs) != 2:
        return None
    mom = next((e for e in eqs if type(e) is Momentum), None)
    con = next((e for e in eqs if type(e) is Continuity), None)
    if mom is None or con is None or mom.dim != 2:
        return None
    if (mom.ve_stress_modes or mom.logconf_modes or mom.sqrtconf_modes
            or mom.supg > 0.0 or mom.devss_mu > 0.0 or con.pspg > 0.0):
        return None
    mat = problem.materials[bi]
    rho, mu = mat.get("rho", 1.0), mat.get("mu", None)
    if callable(rho) or callable(mu) or mu is None:
        return None
    if mat.get("body_force") is not None or mat.get("mass_source") is not None:
        return None
    if any(s.var == MESH_VAR for s in bd.slots):
        return None
    if bd.edge_signs is not None or problem.external_fields:
        return None
    if getattr(problem, "coord", "cartesian") != "cartesian":
        return None  # axisymmetric hoop terms live in the generic path
    from goma_tpu.elements import element_type

    if element_type(bd.elem_type).dim != 2:
        return None
    return {
        "rho": float(rho), "mu": float(mu),
        "transient": bool(mom.transient), "convection": bool(mom.convection),
    }


def ns_q2q1_rj(q, hist, T, meta, static, ct, dtype, with_jac=True,
               with_rs=False):
    """Residual (ne, nl) and exact Jacobian (ne, nl, nl) of the NS Galerkin
    block: precomputed linear part + batched-GEMM convection terms.

    q, hist: (ne, nl) gathered local dofs (velocity comp-major then pressure,
    the dofmap slot layout). T: device tables from :func:`build_tables`.

    ``with_rs``: also return the element-level absolute row sums (ne, nl),
    computed in the element-last frame while J is hot — cheaper than the
    caller re-reading the transposed (ne, nl, nl) J (see
    ``Problem._assemble_fast``).
    """
    rho = jnp.asarray(meta["rho"], dtype=dtype)
    ct = jnp.asarray(ct, dtype=dtype)
    u0, usz, nbu = static["su"]
    p0, psz, nbp = static["sp"]
    ne, nl = q.shape
    qT = q.astype(dtype).T  # (nl, ne)
    gphi = T["fns:gphi"].astype(dtype)  # (nq, nbu, 2, ne)
    w = T["fns:w"].astype(dtype)        # (nq, ne)
    Kfix = T["fns:Kfix"].astype(dtype)  # (nl, nl, ne)
    Mvel = T["fns:Mvel"].astype(dtype)  # (nbu, nbu, ne)
    Nu = jnp.asarray(static["Nu"], dtype=dtype)  # (nq, nbu)
    nq = Nu.shape[0]

    uu = qT[u0:u0 + usz].reshape(2, nbu, ne)

    # ---- residual: linear part is one batched matvec over the fixed op
    R = jnp.einsum("ije,je->ie", Kfix, qT)  # (nl, ne)

    if meta["transient"]:
        hT = hist.astype(dtype).T
        hu = hT[u0:u0 + usz].reshape(2, nbu, ne)
        r_t = jnp.einsum("ije,aje->aie", Mvel, ct * uu + hu)
        R = R.at[u0:u0 + usz].add(r_t.reshape(usz, ne))

    if meta["convection"]:
        # field evaluation (contractions over nbf with huge ne batch)
        uval = jnp.einsum("qi,aie->qae", Nu, uu)     # (nq, 2, ne)
        gu = jnp.einsum("qike,aie->qake", gphi, uu)  # (nq, 2, 2, ne)
        conv = jnp.einsum("qke,qake->qae", uval, gu)  # u . grad u
        wconv = w[:, None, :] * conv                 # (nq, 2, ne)
        # r_conv[a,i,e] = rho sum_q wconv[q,a,e] N[q,i] — GEMM over q
        r_c = rho * jnp.einsum("qae,qi->aie", wconv, Nu)
        R = R.at[u0:u0 + usz].add(r_c.reshape(usz, ne))

    r_out = R.T  # (ne, nl)
    if not with_jac:
        return (r_out, None, None) if with_rs else (r_out, None)

    # ---- Jacobian: fixed part + transient mass + convection GEMMs
    J = Kfix
    if meta["transient"]:
        mt = ct * Mvel
        z = jnp.zeros_like(mt)
        top = jnp.concatenate([mt, z], axis=1)     # (nbu, usz, ne)
        bot = jnp.concatenate([z, mt], axis=1)
        uu_blk = jnp.concatenate([top, bot], axis=0)  # (usz, usz, ne)
    else:
        uu_blk = jnp.zeros((usz, usz, ne), dtype=dtype)

    if meta["convection"]:
        # cg[q,j,e] = u . grad(phi_j)
        cg = jnp.einsum("qke,qjke->qje", uval, gphi)
        wcg = w[:, None, :] * cg                       # (nq, nbu, ne)
        # diag part: rho N_i cg_j summed over q — GEMM (i | q | j*e)
        Jcd = rho * jnp.einsum("qi,qje->ije", Nu, wcg)  # (i, j, ne)
        # outer part: rho gu[a,b] N_i N_j — GEMM (ij | q | ab*e)
        NN = jnp.einsum("qi,qj->qij", Nu, Nu)           # (nq, i, j)
        wgu = w[:, None, None, :] * gu                  # (nq, 2, 2, ne)
        Jab = rho * jnp.einsum("qabe,qij->abije", wgu, NN)
        z2 = jnp.zeros_like(Jcd)
        top = jnp.concatenate([Jcd + Jab[0, 0], Jab[0, 1]], axis=1)
        bot = jnp.concatenate([Jab[1, 0], Jcd + Jab[1, 1]], axis=1)
        uu_blk = uu_blk + jnp.concatenate([top, bot], axis=0)

    if meta["transient"] or meta["convection"]:
        J = J.at[u0:u0 + usz, u0:u0 + usz].add(uu_blk)

    J_ef = jnp.transpose(J, (2, 0, 1))  # (ne, nl, nl)
    if with_rs:
        rs = jnp.sum(jnp.abs(J), axis=1).T  # (ne, nl), element-last reduce
        return r_out, J_ef, rs
    return r_out, J_ef
