"""JAX-native sparse linear solvers.

Parity: replaces the reference's external solver stack — AztecOO GMRES/ILU
(``src/sl_aztecoo_interface.cpp``), Amesos/Amesos2 direct
(``src/sl_amesos_interface.cpp``), PETSc (``src/sl_petsc.c``) — dispatched at
``src/mm_sol_nonlinear.c:1290-1515``. Here: restarted GMRES with
vectorized modified Gram-Schmidt (one (m,n) matmul per Arnoldi step),
node-block-Jacobi preconditioning with batched dense inversion,
and a host scipy direct solve as the validation escape hatch (UMFPACK
parity, ``src/sl_umf.c``).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from goma_tpu.fem.sparsity import CSRPattern


# ---------------------------------------------------------------- precond
class BlockJacobi:
    """Node-block Jacobi preconditioner.

    Node-major dof numbering makes each node's dofs contiguous; blocks are
    extracted from the CSR values by a precomputed position map and inverted
    with one batched ``jnp.linalg.inv``. Elemental (discontinuous) dofs get
    scalar diagonal blocks. Reference analog: block-diagonal ILU0/Jacobi
    preconditioning in Aztec (``src/sl_util.c:380``).
    """

    #: optional storage dtype for the factored inverses (e.g. jnp.bfloat16):
    #: halves the preconditioner-apply HBM traffic; applies accumulate in
    #: the vector dtype. None = keep the factor dtype.
    store_dtype = None

    def __init__(self, pattern: CSRPattern, dofmap):
        starts = []
        counts = []
        mask = dofmap.node_dof_count > 0
        starts.append(dofmap.node_dof_start[mask].astype(np.int64))
        counts.append(dofmap.node_dof_count[mask].astype(np.int64))
        # elemental dofs -> 1x1 blocks
        n_elem_dof = dofmap.n_dof - dofmap.n_node_dof
        if n_elem_dof > 0:
            starts.append(np.arange(dofmap.n_node_dof, dofmap.n_dof, dtype=np.int64))
            counts.append(np.ones(n_elem_dof, dtype=np.int64))
        starts = np.concatenate(starts)
        counts = np.concatenate(counts)
        kmax = int(counts.max())
        nb = starts.shape[0]

        ii = np.arange(kmax)
        dof_ids = starts[:, None] + ii[None, :]  # (nb, kmax)
        valid = ii[None, :] < counts[:, None]
        dof_ids = np.where(valid, dof_ids, -1)

        rows = np.repeat(dof_ids[:, :, None], kmax, axis=2)
        cols = np.repeat(dof_ids[:, None, :], kmax, axis=1)
        ok = (rows >= 0) & (cols >= 0)
        pos = np.full((nb, kmax, kmax), pattern.nnz, dtype=np.int64)  # nnz -> zero pad slot
        p = pattern.find(rows[ok], cols[ok])
        pos_ok = np.where(p >= 0, p, pattern.nnz)
        pos[ok] = pos_ok

        self.nb, self.kmax = nb, kmax
        self.n = pattern.n
        # device tables are passed to jitted code explicitly (tb argument):
        # captured arrays inline into the HLO payload (see Problem._build_tables)
        eye = np.broadcast_to(np.eye(kmax, dtype=bool), (nb, kmax, kmax))
        pad_diag = eye & ~(valid[:, :, None] & valid[:, None, :])
        import jax as _jax

        self.tables = {
            "block_pos": _jax.device_put(pos),
            "dof_ids": _jax.device_put(np.where(valid, dof_ids, self.n)),
            "valid": _jax.device_put(valid),
            "pad_diag": _jax.device_put(pad_diag),
        }

    def factor(self, vals, tb=None):
        tb = tb or self.tables
        vals_ext = jnp.concatenate([vals, jnp.zeros(1, dtype=vals.dtype)])
        A = vals_ext[tb["block_pos"]]  # (nb, kmax, kmax)
        A = jnp.where(tb["pad_diag"], 1.0, A)
        # saddle-point guard: a block can be singular when a constraint row
        # (e.g. pressure in continuity) has zero diagonal and its off-diagonal
        # partners are Dirichlet-identity rows. Shift near-zero diagonals; the
        # preconditioner stays SPD-ish without touching the actual system.
        kmax = A.shape[-1]
        eye = jnp.eye(kmax, dtype=bool)
        diag = jnp.diagonal(A, axis1=1, axis2=2)
        fix = jnp.abs(diag) < 1e-10
        A = A + jnp.where(fix[:, :, None] & eye[None], 1.0, 0.0)
        from goma_tpu.utils.la import gj_inv

        Binv = gj_inv(A)  # backend/dtype-portable
        # final guard against residual singularity
        Binv = jnp.where(jnp.isfinite(Binv), Binv, 0.0)
        if self.store_dtype is not None:
            Binv = Binv.astype(self.store_dtype)
        return Binv

    def apply(self, Binv, r, tb=None):
        tb = tb or self.tables
        r_ext = jnp.concatenate([r, jnp.zeros(1, dtype=r.dtype)])
        rb = r_ext[tb["dof_ids"]]  # (nb, kmax)
        yb = jnp.einsum("bij,bj->bi", Binv, rb,
                        precision=jax.lax.Precision.HIGHEST,
                        preferred_element_type=r.dtype)
        yb = jnp.where(tb["valid"], yb, 0.0)
        # node dofs are contiguous and unique per block: scatter-free set
        return jnp.zeros(self.n + 1, dtype=r.dtype).at[tb["dof_ids"].reshape(-1)].add(
            yb.reshape(-1)
        )[: self.n]


class Vanka:
    """Element-block additive Schwarz ("Vanka") smoother.

    The classic saddle-point multigrid smoother (coupled local solves over
    each element's full dof set, including pressure), recast for batched
    device work: the per-element matrices are gathered from the CSR values
    by a precomputed position map and inverted as ONE batched dense inverse
    (n_elem x nl x nl); apply is gather + batched matvec + weighted
    scatter-add. Reference analog: coupled node/element relaxation the
    reference delegates to Ifpack/ML smoothers (src/sl_aztecoo_interface.cpp).
    """

    store_dtype = None  # see BlockJacobi.store_dtype

    def __init__(self, pattern, dofmap, key_prefix: str = "vk", problem=None,
                 extra_gathers=None):
        """``extra_gathers``: additional (ne, nl) coupled-dof groups added as
        Schwarz blocks — the constraint-aware extension for Lagrange-
        multiplier saddles: passing each overset set's combined
        [multiplier, fluid(, solid)] row gathers puts every zero-diagonal
        lambda row in a block together with the velocity dofs it constrains,
        making the local solves well-posed (reference analog: the coupled
        treatment of overlap AC rows in the bordering solve,
        src/mm_sol_nonlinear.c:1523-1724)."""
        self.n = pattern.n
        gathers = [bd.gather for bd in dofmap.blocks] + \
            [np.asarray(g) for g in (extra_gathers or [])]
        self._gathers = gathers
        self._n_std = len(dofmap.blocks)
        self.nb = len(gathers)
        self.pfx = key_prefix
        count = np.zeros(pattern.n + 1, dtype=np.float64)
        for g in gathers:
            np.add.at(count, g.ravel(), 1.0)
        wts = 1.0 / np.maximum(count, 1.0)
        # padded node-slot fast path (see fem/padded.py): the weighted Schwarz
        # recombination becomes the same row-gather combine as the matvec,
        # with the overlap weights folded into the padded local inverses
        self._problem = problem
        self.padded = bool(
            problem is not None
            and not extra_gathers
            and hasattr(problem, "ensure_padded_tables")
            and problem.ensure_padded_tables()
        )
        if self.padded:
            meta = problem._padded_meta
            self._meta = meta
            self._wp = []
            for bi, (bd, bm) in enumerate(zip(dofmap.blocks, meta["blocks"])):
                inv = None  # filled below from problem tables (numpy copy)
                invmap = np.asarray(
                    jax.device_get(problem._tables[f"pl:inv{bi}"])
                )
                g_ext = np.concatenate(
                    [bd.gather, np.full((bd.gather.shape[0], 1), pattern.n,
                                        dtype=bd.gather.dtype)], axis=1
                )
                dof_at = g_ext[np.arange(g_ext.shape[0])[:, None], invmap]
                wp = np.where(invmap < bm["nl"], wts[dof_at], 0.0)
                self._wp.append(wp)
        tables = {}
        flat_dofs = []  # concatenated (over blocks) per-contribution dof ids
        for bi, gg in enumerate(gathers):
            g = gg.astype(np.int64)  # (ne, nl)
            ne, nl = g.shape
            rows = np.repeat(g, nl, axis=1).ravel()
            cols = np.tile(g, (1, nl)).ravel()
            pos = pattern.find(rows, cols).reshape(ne, nl, nl)
            pos = np.where(pos >= 0, pos, pattern.nnz)  # pad slot -> 0.0
            tables[f"{key_prefix}:pos{bi}"] = jax.device_put(pos)
            tables[f"{key_prefix}:g{bi}"] = jax.device_put(g)
            tables[f"{key_prefix}:w{bi}"] = jax.device_put(wts[g])
            flat_dofs.append(g.ravel())
        # scatter-free combine: per dof, the positions of its contributions in
        # the concatenated per-block (zb * w).ravel() arrays (this turns the
        # Schwarz sum into a padded gather + sum instead of a scatter)
        flat = np.concatenate(flat_dofs)
        L = flat.shape[0]
        order = np.argsort(flat, kind="stable")
        sf = flat[order]
        starts = np.searchsorted(sf, np.arange(self.n))
        ends = np.searchsorted(sf, np.arange(self.n) + 1)
        kmax = max(int((ends - starts).max()), 1)
        dpos = np.full((self.n, kmax), L, dtype=np.int64)
        for k in range(kmax):
            sel = starts + k < ends
            dpos[sel, k] = order[(starts + k)[sel]]
        tables[f"{key_prefix}:dpos"] = jax.device_put(dpos)
        if self.padded:
            for bi, wp in enumerate(self._wp):
                tables[f"{key_prefix}:wp{bi}"] = jax.device_put(wp)
        self.tables = tables

    def factor(self, vals, tb=None):
        tb = tb or self.tables
        vals_ext = jnp.concatenate([vals, jnp.zeros(1, dtype=vals.dtype)])
        invs = []
        eye_cache = {}
        for bi in range(self.nb):
            Ae = vals_ext[tb[f"{self.pfx}:pos{bi}"]]  # (ne, nl, nl)
            nl = Ae.shape[-1]
            if nl not in eye_cache:
                eye_cache[nl] = jnp.eye(nl, dtype=vals.dtype)
            diag = jnp.diagonal(Ae, axis1=1, axis2=2)
            if bi < self._n_std:
                # standard element blocks (SMOOTHER role): regularize every
                # zero diagonal — the gentler diag-shifted local solves are
                # what keeps the two-level smoother stable in f32 (exact
                # local KKT inverses measurably diverge the f32 cycle)
                fix = (jnp.abs(diag) < 1e-12)[:, :, None] * eye_cache[nl][None]
            else:
                # extra (constraint) blocks: a zero diagonal gets a unit
                # entry only when its row OR column is dead (Dirichlet-wiped
                # partners). Live multiplier rows get the exact pivoted
                # local KKT inverse — the constraint-aware behavior that
                # makes overset saddles solvable iteratively.
                rowsum = jnp.sum(jnp.abs(Ae), axis=2) - jnp.abs(diag)
                colsum = jnp.sum(jnp.abs(Ae), axis=1) - jnp.abs(diag)
                fix = ((jnp.abs(diag) < 1e-12)
                       & ((rowsum < 1e-12) | (colsum < 1e-12))
                       )[:, :, None] * eye_cache[nl][None]
            from goma_tpu.utils.la import gj_inv

            Aei = gj_inv(Ae + fix)  # pivoted, dtype/backend-portable
            Aei = jnp.where(jnp.isfinite(Aei), Aei, 0.0)
            if self.padded:
                # pad into the node-slot layout with the overlap weights
                # folded in: apply is then identical to the padded matvec
                invmap = self._problem._tables[f"pl:inv{bi}"]
                hi = jax.lax.Precision.HIGHEST
                S = jax.nn.one_hot(invmap, nl + 1, dtype=Aei.dtype)[..., :nl]
                Ap = jnp.einsum("eai,eij->eaj", S, Aei, precision=hi)
                Ap = jnp.einsum("eaj,ebj->eab", Ap, S, precision=hi)
                wp = (tb or self.tables)[f"{self.pfx}:wp{bi}"].astype(Aei.dtype)
                Aei = wp[:, :, None] * Ap
            if self.store_dtype is not None:
                Aei = Aei.astype(self.store_dtype)
            invs.append(Aei)
        return tuple(invs)

    def apply(self, fac, r, tb=None):
        if self.padded:
            from goma_tpu.fem.padded import padded_matvec

            return padded_matvec(
                self._problem, self._meta, self._problem._tables, fac, r
            )
        tb = tb or self.tables
        r_ext = jnp.concatenate([r, jnp.zeros(1, dtype=r.dtype)])
        parts = []
        for bi in range(self.nb):
            g = tb[f"{self.pfx}:g{bi}"]
            rb = r_ext[g]  # (ne, nl)
            zb = jnp.einsum("eij,ej->ei", fac[bi], rb,
                            precision=jax.lax.Precision.HIGHEST)
            parts.append((zb * tb[f"{self.pfx}:w{bi}"].astype(r.dtype)).reshape(-1))
        flat = jnp.concatenate(parts + [jnp.zeros(1, dtype=r.dtype)])
        return jnp.sum(flat[tb[f"{self.pfx}:dpos"]], axis=1)


def identity_precond(r):
    return r


class FieldSplit:
    """Block lower-triangular field-split preconditioner for saddle-point
    systems (incompressible flow):

        M^-1 r:  z_u = A_hat^-1 r_u            (node-block-Jacobi sweeps)
                 z_p = S_hat^-1 (r_p - A_pu z_u)

    with S_hat ~ -(1/mu) M_p the lumped pressure mass matrix — the classic
    Cahouet-Chabard / pressure-mass Schur approximation. Plays the role of
    the reference's PCD Schur-complement preconditioner
    (``src/sl_petsc_pcd.c:115 PCDShellPCApply``), built from batched
    dense node blocks + diagonal Schur, no triangular solves.
    """

    def __init__(self, problem, pressure_var: str = "pressure", mu: float | None = None,
                 u_sweeps: int = 2):
        import numpy as _np

        pattern = problem.pattern
        dofmap = problem.dofmap
        self.bj = BlockJacobi(pattern, dofmap)
        self.n = pattern.n
        self.u_sweeps = u_sweeps

        # pressure dof mask
        pmask = _np.zeros(pattern.n, dtype=bool)
        if any(v.name == pressure_var for v in dofmap.vars):
            sv = dofmap.svar(pressure_var)
            d = dofmap.dof_of_node_svar[:, sv]
            pmask[d[d >= 0]] = True
        self.pmask = jnp.asarray(pmask)

        # lumped pressure mass diag over the undeformed mesh
        Mp = _np.zeros(pattern.n)
        from goma_tpu.elements import eval_basis, geom_interp, element_type, volume_rule
        from goma_tpu.elements import interp_local_nodes

        for bd, blk in zip(dofmap.blocks, problem.mesh.blocks):
            try:
                s = bd.slot(pressure_var)
            except KeyError:
                continue
            if s.interp in ("P0", "P1E"):
                continue
            et = element_type(blk.elem_type)
            qpts, qwts = volume_rule(et.family, problem.quad_order)
            Ng, dNg = eval_basis(et.family, geom_interp(et), qpts)
            Np, _ = eval_basis(et.family, s.interp, qpts)
            X = problem.mesh.coords[blk.conn]
            J = _np.einsum("qnd,enk->eqdk", dNg, X)
            detJ = _np.abs(_np.linalg.det(J))
            lumped = _np.einsum("eq,q,qi->ei", detJ, qwts, Np)  # row-sum lumping
            ln = list(interp_local_nodes(et.family, s.interp))
            nodes = blk.conn[:, ln]
            dofs = dofmap.dof_of_node_svar[nodes, dofmap.svar(pressure_var)]
            _np.add.at(Mp, dofs.ravel(), lumped.ravel())
        mu_val = mu if mu is not None else 1.0
        inv_shat = _np.where(Mp > 0, mu_val / _np.maximum(Mp, 1e-300), 0.0)
        self.inv_shat = jnp.asarray(inv_shat)
        self._matvec = None  # bound per factorization

    def factor(self, vals, matvec):
        Binv = self.bj.factor(vals)
        return (Binv, matvec)

    def apply(self, fac, r):
        Binv, matvec = fac
        pm = self.pmask
        r_u = jnp.where(pm, 0.0, r)
        # u-block: block-Jacobi-preconditioned Richardson sweeps on A_uu
        z = self.bj.apply(Binv, r_u)
        z = jnp.where(pm, 0.0, z)
        for _ in range(self.u_sweeps - 1):
            resid = r_u - jnp.where(pm, 0.0, matvec(z))
            z = z + jnp.where(pm, 0.0, self.bj.apply(Binv, resid))
        # pressure block: S_hat^-1 (r_p - A_pu z_u)
        r_p = jnp.where(pm, r - matvec(z), 0.0)
        z_p = self.inv_shat * r_p
        return z + jnp.where(pm, z_p, 0.0)


# ------------------------------------------------------------------ GMRES
@jax.tree_util.register_dataclass
@dataclass
class LinearResult:
    x: jnp.ndarray
    iters: jnp.ndarray
    resnorm: jnp.ndarray
    converged: jnp.ndarray


def gmres(matvec, b, precond=None, x0=None, tol=1e-8, atol=0.0, restart=40, maxiter=200):
    """Right-preconditioned restarted GMRES. ``matvec``/``precond`` are
    closures over the CSR values. Returns LinearResult. Fully jittable."""
    n = b.shape[0]
    dtype = b.dtype
    if precond is None:
        precond = identity_precond
    if x0 is None:
        x0 = jnp.zeros_like(b)
    m = restart

    bnorm = jnp.linalg.norm(b)
    target = jnp.maximum(tol * bnorm, atol)

    def arnoldi_cycle(x):
        r = b - matvec(x)
        beta = jnp.linalg.norm(r)

        V = jnp.zeros((m + 1, n), dtype=dtype)
        H = jnp.zeros((m + 1, m), dtype=dtype)
        V = V.at[0].set(r / jnp.where(beta > 0, beta, 1.0))
        # Givens rotations accumulated as a dense (m+1, m+1) orthogonal Q
        # (vectorized application: one small matvec per step); the running
        # residual estimate |(Q e1 beta)[j+1]| enables EARLY EXIT inside the
        # cycle — restarting is what stagnates GMRES on these nonsymmetric
        # saddle systems, so the restart is sized long and unused steps are
        # skipped via lax.cond (only one compiled branch executes).
        Q = jnp.eye(m + 1, dtype=dtype)

        def live(carry, j):
            V, H, Q, done, cnt = carry
            w = matvec(precond(V[j]))
            # vectorized CGS2: orthogonalize against all previous at once.
            # HIGHEST: a reduced-precision default (TF32 or bf16 passes)
            # destroys Krylov-basis orthogonality in f32
            hi = jax.lax.Precision.HIGHEST
            mask = (jnp.arange(m + 1) <= j).astype(dtype)
            h = jnp.matmul(V, w, precision=hi) * mask
            w = w - jnp.matmul(V.T, h, precision=hi)
            # one reorthogonalization pass (robustness, cf. DGKS)
            h2 = jnp.matmul(V, w, precision=hi) * mask
            w = w - jnp.matmul(V.T, h2, precision=hi)
            h = h + h2
            wn = jnp.linalg.norm(w)
            H = H.at[:, j].set(h)
            H = H.at[j + 1, j].set(wn)
            V = V.at[j + 1].set(w / jnp.where(wn > 1e-30, wn, 1.0))
            hr = jnp.matmul(Q, H[:, j], precision=jax.lax.Precision.HIGHEST)
            a0 = hr[j]
            a1 = hr[j + 1]
            rr = jnp.sqrt(a0 * a0 + a1 * a1)
            ok = rr > 1e-30
            c_ = jnp.where(ok, a0 / jnp.where(ok, rr, 1.0), 1.0)
            s_ = jnp.where(ok, a1 / jnp.where(ok, rr, 1.0), 0.0)
            qj = Q[j]
            qj1 = Q[j + 1]
            Q = Q.at[j].set(c_ * qj + s_ * qj1)
            Q = Q.at[j + 1].set(-s_ * qj + c_ * qj1)
            est = jnp.abs(Q[j + 1, 0] * beta)
            return (V, H, Q, est <= target, cnt + 1)

        def step(j, carry):
            return jax.lax.cond(carry[3], lambda c: c, lambda c: live(c, j), carry)

        V, H, Q, done, cnt = jax.lax.fori_loop(
            0, m, step, (V, H, Q, beta <= target, jnp.zeros((), jnp.int32))
        )
        # least squares min || beta e1 - H y || (portable small solver;
        # unexecuted columns are zero -> regularized solve returns y=0 there)
        from goma_tpu.utils.la import lstsq_small

        e1 = jnp.zeros(m + 1, dtype=dtype).at[0].set(beta)
        y = lstsq_small(H, e1)
        x_new = x + precond(
            jnp.matmul(V[:m].T, y, precision=jax.lax.Precision.HIGHEST)
        )
        return x_new, cnt

    def cond(carry):
        x, it, rn = carry
        return (rn > target) & (it < maxiter)

    def body(carry):
        x, it, _ = carry
        x, cnt = arnoldi_cycle(x)
        rn = jnp.linalg.norm(b - matvec(x))
        return (x, it + cnt, rn)

    rn0 = jnp.linalg.norm(b - matvec(x0))
    x, iters, rn = jax.lax.while_loop(cond, body, (x0, jnp.zeros((), jnp.int32), rn0))
    return LinearResult(x=x, iters=iters, resnorm=rn, converged=rn <= target)


def gmres_dr_cycle(matvec, precond, b, x0, U, C, restart, tol):
    """One GCRO-DR (recycled/deflated GMRES) cycle: minimize the residual
    over range(M U) + K_m((I-CC^T) A M, r0), with C = A M U orthonormal.

    The Newton-Krylov sequence solves a slowly-varying family of Jacobians
    whose preconditioned spectra share a small cluster of bad eigenvalues
    (measured: mid-Newton cavity solves burn 200+ Krylov its for a 1e-1
    reduction regardless of tolerance); carrying the harmonic-Ritz deflation
    space between Newton iterations removes exactly that cluster
    [Parks, de Sturler et al., "Recycling Krylov subspaces for sequences of
    linear systems", SIAM J. Sci. Comput. 28 (2006) — method reimplemented
    from the algorithm description]. Replaces the role AztecOO's
    reuse/recycle options play in the reference stack
    (src/sl_aztecoo_interface.cpp).

    U, C are (k, n) row-major; pass k=0 arrays (shape (0, n)) for a plain
    deflation-free cycle. Returns
    (x_new, rn_true, cnt, V, H, B) — V (m+1, n), H (m+1, m), B (k, m) feed
    the between-solves harvest; rn_true is the actual ||b - A x_new||.
    """
    n = b.shape[0]
    dtype = b.dtype
    m = restart
    k = U.shape[0]

    bnorm = jnp.linalg.norm(b)
    target = tol * bnorm

    r = b - matvec(x0)
    c0 = C @ r if k else jnp.zeros((0,), dtype)
    rp = r - C.T @ c0 if k else r
    beta = jnp.linalg.norm(rp)

    V = jnp.zeros((m + 1, n), dtype=dtype)
    H = jnp.zeros((m + 1, m), dtype=dtype)
    B = jnp.zeros((k, m), dtype=dtype)
    V = V.at[0].set(rp / jnp.where(beta > 0, beta, 1.0))
    Q = jnp.eye(m + 1, dtype=dtype)
    hi = jax.lax.Precision.HIGHEST

    def live(carry, j):
        V, H, B, Q, done, cnt = carry
        w = matvec(precond(V[j]))
        if k:
            bj = jnp.matmul(C, w, precision=hi)
            w = w - jnp.matmul(C.T, bj, precision=hi)
            B = B.at[:, j].set(bj)
        mask = (jnp.arange(m + 1) <= j).astype(dtype)
        h = jnp.matmul(V, w, precision=hi) * mask
        w = w - jnp.matmul(V.T, h, precision=hi)
        h2 = jnp.matmul(V, w, precision=hi) * mask
        w = w - jnp.matmul(V.T, h2, precision=hi)
        h = h + h2
        wn = jnp.linalg.norm(w)
        H = H.at[:, j].set(h)
        H = H.at[j + 1, j].set(wn)
        V = V.at[j + 1].set(w / jnp.where(wn > 1e-30, wn, 1.0))
        hr = jnp.matmul(Q, H[:, j], precision=hi)
        a0, a1 = hr[j], hr[j + 1]
        rr = jnp.sqrt(a0 * a0 + a1 * a1)
        ok = rr > 1e-30
        c_ = jnp.where(ok, a0 / jnp.where(ok, rr, 1.0), 1.0)
        s_ = jnp.where(ok, a1 / jnp.where(ok, rr, 1.0), 0.0)
        qj, qj1 = Q[j], Q[j + 1]
        Q = Q.at[j].set(c_ * qj + s_ * qj1)
        Q = Q.at[j + 1].set(-s_ * qj + c_ * qj1)
        est = jnp.abs(Q[j + 1, 0] * beta)
        return (V, H, B, Q, est <= target, cnt + 1)

    def step(j, carry):
        return jax.lax.cond(carry[4], lambda c: c, lambda c: live(c, j), carry)

    V, H, B, Q, done, cnt = jax.lax.fori_loop(
        0, m, step, (V, H, B, Q, beta <= target, jnp.zeros((), jnp.int32)))

    from goma_tpu.utils.la import lstsq_small

    e1 = jnp.zeros(m + 1, dtype=dtype).at[0].set(beta)
    y = lstsq_small(H, e1)
    z = jnp.matmul(V[:m].T, y, precision=hi)
    if k:
        alpha = c0 - jnp.matmul(B, y, precision=hi)
        z = z + jnp.matmul(U.T, alpha, precision=hi)
    x_new = x0 + precond(z)
    rn = jnp.linalg.norm(b - matvec(x_new))
    return x_new, rn, cnt, V, H, B


def bicgstab(matvec, b, precond=None, x0=None, tol=1e-8, atol=0.0, maxiter=500):
    """Right-preconditioned BiCGStab (reference: AZ_bicgstab option)."""
    if precond is None:
        precond = identity_precond
    if x0 is None:
        x0 = jnp.zeros_like(b)
    bnorm = jnp.linalg.norm(b)
    target = jnp.maximum(tol * bnorm, atol)

    r0 = b - matvec(x0)
    rhat = r0

    def cond(c):
        x, r, p, v, rho, alpha, omega, it = c
        return (jnp.linalg.norm(r) > target) & (it < maxiter)

    def body(c):
        x, r, p, v, rho, alpha, omega, it = c
        rho_new = jnp.dot(rhat, r)
        beta = (rho_new / jnp.where(rho != 0, rho, 1e-300)) * (
            alpha / jnp.where(omega != 0, omega, 1e-300)
        )
        p = r + beta * (p - omega * v)
        phat = precond(p)
        v = matvec(phat)
        alpha = rho_new / jnp.where(jnp.dot(rhat, v) != 0, jnp.dot(rhat, v), 1e-300)
        s = r - alpha * v
        shat = precond(s)
        t = matvec(shat)
        tt = jnp.dot(t, t)
        omega = jnp.dot(t, s) / jnp.where(tt != 0, tt, 1e-300)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        return (x, r, p, v, rho_new, alpha, omega, it + 1)

    z = jnp.zeros_like(b)
    one = jnp.ones((), b.dtype)
    x, r, *_, it = jax.lax.while_loop(
        cond, body, (x0, r0, z, z, one, one, one, jnp.zeros((), jnp.int32))
    )
    rn = jnp.linalg.norm(r)
    return LinearResult(x=x, iters=it, resnorm=rn, converged=rn <= target)


# ------------------------------------------------------- host direct solve
class LinearSolveError(RuntimeError):
    """Raised when a direct solve returns a non-finite solution (singular or
    numerically rank-deficient matrix). The reference treats a failed linear
    solve as a hard Newton failure (``src/mm_sol_nonlinear.c`` err < 0 ->
    abort iteration; the transient ladder then halves dt) — silently
    propagating inf/nan instead lets the recovery ladder mask real setup
    errors (round-1 advisor finding)."""


def direct_solve_host(pattern: CSRPattern, vals, R):
    """Serial sparse LU on host (scipy). Validation/golden path, the analog
    of the reference's UMFPACK/``lu`` escape hatches (``src/sl_umf.c``).
    Raises :class:`LinearSolveError` on a singular matrix instead of
    returning inf/nan."""
    import warnings

    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    A = sp.csr_matrix(
        (np.asarray(vals), np.asarray(pattern.indices), np.asarray(pattern.indptr)),
        shape=(pattern.n, pattern.n),
    )
    b = np.asarray(R)
    with warnings.catch_warnings():
        warnings.simplefilter("error", spla.MatrixRankWarning)
        try:
            x = spla.spsolve(A, b)
        except spla.MatrixRankWarning as e:
            raise LinearSolveError(f"direct solve: singular matrix ({e})") from e
    if not np.all(np.isfinite(x)):
        raise LinearSolveError("direct solve returned non-finite solution")
    # backward-stability check: a successful sparse LU leaves a tiny relative
    # residual even on ill-conditioned systems; a large one means SuperLU
    # factored a numerically singular matrix without warning (observed: rel
    # residual 0.5 with |x| ~ 1e14 on an unpinned pure-Neumann operator)
    bn = np.linalg.norm(b)
    if bn > 0.0:
        rel = np.linalg.norm(A @ x - b) / bn
        if rel > 1e-6:
            raise LinearSolveError(
                f"direct solve: residual {rel:.2e} of ||b|| — singular or "
                "numerically rank-deficient matrix")
    return x
