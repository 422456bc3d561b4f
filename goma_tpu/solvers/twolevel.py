"""Two-level (p-multigrid) preconditioner: Q2->Q1 coarsening with an exact
coarse solve on device.

Replaces the external AMG/ILU stacks the reference leans on (Trilinos
Ifpack/ML via ``src/sl_aztecoo_interface.cpp``, PETSc PC). Design:

- Restriction/prolongation P is the nodal embedding of the Q1/P1 subspace
  (corner-node dofs) into the full mixed space, built once on host; applying
  P / P^T on device is a gather + ``segment_sum`` with <= 2^dim weights per
  fine dof.
- The Galerkin coarse operator A_c = P^T A P is *recomputed from the CSR
  values every factorization* by one big ``segment_sum`` into a dense
  (nc, nc) matrix (precomputed index/weight expansion per fine nnz), then
  LU-factored with ``jax.scipy.linalg.lu_factor`` — dense device compute
  instead of sparse triangular solves.
- Smoother: damped node-block-Jacobi (batched dense inverses).

The coarse space contains the full saddle-point structure (velocity Q1 +
pressure Q1 + any elemental dofs), so the coarse solve is a true mixed
solve and the cycle is robust for incompressible flow.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from goma_tpu.elements import element_type, eval_basis, interp_local_nodes
from goma_tpu.solvers.linear import BlockJacobi


def _saddle_mask(problem, saddle_vars=("pressure", "lm")) -> np.ndarray:
    """Boolean (n_dof,) mask of dofs belonging to saddle-point (zero-diagonal
    Lagrange-multiplier-like) variables. Used to order the coarse space so
    the Schur-split block inverse pivots on the elliptic block first."""
    dofmap = problem.dofmap
    mask = np.zeros(dofmap.n_dof, dtype=bool)
    for name in saddle_vars:
        if name not in dofmap.svar_offset:
            continue
        v = dofmap.var(name)
        for c in range(v.ncomp):
            d = dofmap.dof_of_node_svar[:, dofmap.svar(name, c)]
            mask[d[d >= 0]] = True
        for bd in dofmap.blocks:
            for s in bd.slots:
                if s.var == name and s.interp in ("P0", "P1E"):
                    mask[bd.gather[:, s.start : s.start + s.size].ravel()] = True
    return mask


def _fine_to_coarse_weights(problem, saddle_vars=("pressure", "lm")):
    """Per fine dof: coarse dof ids + interpolation weights.

    Coarse space: for nodal slots with quadratic interpolation, the linear
    (corner-node) sub-interpolation; linear/elemental slots inject. Coarse
    dofs are ordered elliptic-first / saddle-last (see ``_saddle_mask``);
    returns (nc, cids, wts, n_elliptic).
    """
    from goma_tpu.mesh.mesh import _ref_nodes

    dofmap = problem.dofmap
    n = dofmap.n_dof
    QUAD_TO_LIN = {"Q2": "Q1", "P2": "P1"}

    is_coarse = np.zeros(n, dtype=bool)
    # vectorized entry accumulation: (fine dof, coarse dof, weight) triples
    # deduped at the end (elements sharing a fine dof repeat the same
    # weights, so "last wins" == "any wins"); the per-element python dict
    # loop this replaces cost ~100 s at 4096 elements
    tri_d, tri_c, tri_w = [], [], []

    for bd, blk in zip(dofmap.blocks, problem.mesh.blocks):
        et = element_type(blk.elem_type)
        ref = _ref_nodes(et)
        for s in bd.slots:
            if s.interp in ("P0", "P1E") or s.interp not in QUAD_TO_LIN:
                # injected: coarse keeps these dofs
                sl = bd.gather[:, s.start : s.start + s.size].ravel()
                is_coarse[sl] = True
                tri_d.append(sl.astype(np.int64))
                tri_c.append(sl.astype(np.int64))
                tri_w.append(np.ones(sl.shape[0]))
                continue
            lin = QUAD_TO_LIN[s.interp]
            ln_f = list(interp_local_nodes(et.family, s.interp))
            ln_c = list(interp_local_nodes(et.family, lin))
            # linear basis evaluated at the fine interpolation nodes
            W, _ = eval_basis(et.family, lin, ref[ln_f])  # (nbf_f, nbf_c)
            keepW = np.abs(W) > 1e-14
            for c in range(s.ncomp):
                cols = bd.gather[:, s.start + c * s.nbf : s.start + (c + 1) * s.nbf]
                ccols = cols[:, [ln_f.index(k) for k in ln_c]]
                is_coarse[ccols.ravel()] = True
                ne = cols.shape[0]
                ii, jj = np.nonzero(keepW)
                tri_d.append(cols[:, ii].ravel().astype(np.int64))
                tri_c.append(ccols[:, jj].ravel().astype(np.int64))
                tri_w.append(np.broadcast_to(W[ii, jj], (ne, ii.shape[0])).ravel())

    # order the coarse space elliptic-first, saddle-last: the blocked coarse
    # inverse does unpivoted Schur splits, which are only stable when every
    # leading principal block is far from singular — true for the elliptic
    # block, false once zero-diagonal saddle rows are mixed in.
    saddle = _saddle_mask(problem, saddle_vars)
    cdofs = np.where(is_coarse)[0]
    order = np.argsort(saddle[cdofs], kind="stable")  # False (elliptic) first
    n_elliptic = int((~saddle[cdofs]).sum())
    coarse_id = np.full(n, -1, dtype=np.int64)
    coarse_id[cdofs[order]] = np.arange(cdofs.shape[0])
    nc = int(is_coarse.sum())

    # dedupe (fine, coarse) pairs and pack per-fine-dof rows
    td = np.concatenate(tri_d)
    tc = np.concatenate(tri_c)
    tw = np.concatenate(tri_w)
    keys = td * np.int64(n) + tc
    uk, first = np.unique(keys, return_index=True)
    td, tc, tw = td[first], tc[first], tw[first]
    order = np.argsort(td, kind="stable")
    td, tc, tw = td[order], tc[order], tw[order]
    st = np.searchsorted(td, np.arange(n))
    en = np.searchsorted(td, np.arange(n) + 1)
    kmax = max(int((en - st).max()), 1)
    # pad with the out-of-range sentinel nc (NOT 0: a 0-padded cids makes
    # coarse dof 0 collect every pad slot in the transpose-gather map,
    # inflating it to hundreds of MB)
    cids = np.full((n, kmax), nc, dtype=np.int64)
    wts = np.zeros((n, kmax))
    for k in range(kmax):
        sel = st + k < en
        cids[sel, k] = coarse_id[tc[(st + k)[sel]]]
        wts[sel, k] = tw[(st + k)[sel]]
    return nc, cids, wts, n_elliptic


def coarse_dof_count(problem) -> tuple[int, int]:
    """(nc, n): size of the Q1/P1 coarse space vs the full dof count,
    without building the transfer weights (cheap feasibility probe for
    choosing two-level as the default preconditioner)."""
    dofmap = problem.dofmap
    n = dofmap.n_dof
    QUAD_TO_LIN = {"Q2": "Q1", "P2": "P1"}
    is_coarse = np.zeros(n, dtype=bool)
    for bd, blk in zip(dofmap.blocks, problem.mesh.blocks):
        et = element_type(blk.elem_type)
        for s in bd.slots:
            if s.interp not in QUAD_TO_LIN:
                sl = bd.gather[:, s.start : s.start + s.size]
                is_coarse[sl.ravel()] = True
                continue
            ln_f = list(interp_local_nodes(et.family, s.interp))
            ln_c = list(interp_local_nodes(et.family, QUAD_TO_LIN[s.interp]))
            for c in range(s.ncomp):
                cols = bd.gather[:, s.start + c * s.nbf : s.start + (c + 1) * s.nbf]
                is_coarse[cols[:, [ln_f.index(k) for k in ln_c]].ravel()] = True
    return int(is_coarse.sum()), n


class TwoLevel:
    """V(1,1)-cycle two-level preconditioner with exact dense coarse solve."""

    #: optional bf16 storage for the smoother inverses and the dense coarse
    #: inverse (halves preconditioner-apply HBM traffic; applies accumulate
    #: in the Krylov dtype). Set via NewtonOptions.precond_dtype.
    store_dtype = None

    def __init__(self, problem, smooth_damp: float = 0.7, pre_sweeps: int = 1,
                 post_sweeps: int = 1, coarse_solve: str = "lu",
                 smoother: str = "bj"):
        if smoother == "vanka":
            from goma_tpu.solvers.linear import Vanka

            # constraint-aware: overset multiplier rows join Schwarz blocks
            # with their coupled fluid/solid dofs (zero-diagonal lambda rows
            # are insolvable in any diagonal-based smoother otherwise)
            extras = [s.gather for s in getattr(problem, "ovs_sets", [])]
            self.bj = Vanka(problem.pattern, problem.dofmap, problem=problem,
                            extra_gathers=extras or None)
        else:
            self.bj = BlockJacobi(problem.pattern, problem.dofmap)
        self.smoother = smoother
        self.n = problem.pattern.n
        self.smooth_damp = smooth_damp
        self.pre_sweeps = pre_sweeps
        self.post_sweeps = post_sweeps
        # "lu": dense LU of the coarse operator + two triangular solves per
        # application. "inv": an explicit f32 inverse, so each application
        # is one dense matvec (kept as an option; not measured on the GPU).
        self.coarse_solve = coarse_solve
        # the f32 saddle-split inverse alone (~0.1 rel err) is enough for a
        # preconditioner application (measured: same Krylov iteration count
        # as 3 refinement steps); each step costs two dense (nc, nc) matvecs
        # of HBM traffic. Raise for tougher decks via the attribute.
        self.refine_steps = 0
        # saddle-diagonal stabilization of the equal-order Galerkin coarse
        # (see factor()); relative to the mean elliptic diagonal. 1e-6 is
        # far below preconditioner-quality resolution yet bounds the
        # periodic-deck checkerboard mode well above f32 eps.
        self.coarse_reg = 1e-6

        nc, cids, wts, n_ell = _fine_to_coarse_weights(problem)
        self.nc = nc
        self.n_elliptic = n_ell
        self.tables = dict(self.bj.tables)
        self.tables["cids"] = jax.device_put(cids)
        self.tables["wts"] = jax.device_put(wts)
        if nc * nc > 2**31 - 1:
            raise ValueError("coarse space too large for dense two-level")

        # per-nnz expansion for A_c = P^T A P. Contributions are scattered
        # into the *sparse* coarse pattern (precomputed here) — scattering
        # directly into the dense (nc, nc) would be a segment_sum with nc^2
        # segments, which compiles and runs pathologically. The sparse
        # coarse values are then densified with one cheap scatter.
        pat = problem.pattern
        k = cids.shape[1]
        r = pat.rows.astype(np.int64)
        c = pat.indices.astype(np.int64)
        ci = cids[r][:, :, None]  # (nnz, k, 1)
        cj = cids[c][:, None, :]  # (nnz, 1, k)
        wi = wts[r][:, :, None]
        wj = wts[c][:, None, :]
        flat = (ci * nc + cj).reshape(-1)
        w = (wi * wj).reshape(-1)
        keep = np.abs(w) > 1e-14
        flat = flat[keep]
        ckeys = np.unique(flat)
        self._c_nnz = ckeys.shape[0]
        self.tables["ac_idx"] = jax.device_put(np.searchsorted(ckeys, flat))
        self.tables["ac_w"] = jax.device_put(w[keep])
        self.tables["ac_rep"] = jax.device_put(np.repeat(np.arange(pat.nnz), k * k)[keep])
        self.tables["c_rows"] = jax.device_put((ckeys // nc).astype(np.int32))
        self.tables["c_cols"] = jax.device_put((ckeys % nc).astype(np.int32))

        # scatter-free restriction: per coarse dof, positions of its fine
        # contributions in the flattened (n*kmax) weighted array
        flat_c = cids.reshape(-1)
        Lf = flat_c.shape[0]
        order = np.argsort(flat_c, kind="stable")
        sc = flat_c[order]
        starts = np.searchsorted(sc, np.arange(nc))
        ends = np.searchsorted(sc, np.arange(nc) + 1)
        mc = int((ends - starts).max())
        rpos = np.full((nc, mc), Lf, dtype=np.int64)
        for k in range(mc):
            sel = starts + k < ends
            rpos[sel, k] = order[(starts + k)[sel]]
        self.tables["rpos"] = jax.device_put(rpos)

    # ------------------------------------------------------------- transfer
    def restrict(self, r, tb=None):
        """r_c = P^T r (scatter-free transpose gather)."""
        tb = tb or self.tables
        contrib = (tb["wts"].astype(r.dtype) * r[:, None]).reshape(-1)
        ext = jnp.concatenate([contrib, jnp.zeros(1, dtype=r.dtype)])
        return jnp.sum(ext[tb["rpos"]], axis=1)

    def prolong(self, zc, tb=None):
        """z = P z_c (cids pad sentinel nc reads the appended zero)."""
        tb = tb or self.tables
        zc_ext = jnp.concatenate([zc, jnp.zeros(1, dtype=zc.dtype)])
        return jnp.sum(tb["wts"].astype(zc.dtype) * zc_ext[tb["cids"]], axis=1)

    # ---------------------------------------------------------------- cycle
    def factor(self, vals, matvec, tb=None):
        tb = tb or self.tables
        Binv = self.bj.factor(vals, tb)
        ac_vals = tb["ac_w"].astype(vals.dtype) * vals[tb["ac_rep"]]
        cvals = jax.ops.segment_sum(ac_vals, tb["ac_idx"], num_segments=self._c_nnz)
        Ac = jnp.zeros((self.nc, self.nc), dtype=vals.dtype)
        Ac = Ac.at[tb["c_rows"], tb["c_cols"]].set(cvals)
        if self.coarse_reg and self.n_elliptic < self.nc:
            # pressure-stabilize the Galerkin coarse: the restricted space is
            # equal-order (Q1 velocity / Q1 pressure), which is not inf-sup
            # stable — on periodic/structured decks its checkerboard pressure
            # mode is EXACTLY singular even when the fine Q2/Q1 operator is
            # fine. A tiny negative saddle-diagonal shift (the classic
            # eps-stabilized Stokes form [A B^T; B -eps I]) bounds the mode
            # away from zero; preconditioner-only, never touches the fine
            # operator the Krylov iterates against.
            dm = jnp.mean(jnp.abs(jnp.diagonal(Ac)[: self.n_elliptic])) \
                if self.n_elliptic else jnp.asarray(1.0, vals.dtype)
            idx = jnp.arange(self.n_elliptic, self.nc)
            Ac = Ac.at[idx, idx].add(-self.coarse_reg * dm)
        if self.coarse_solve == "inv":
            from goma_tpu.utils.la import saddle_split_inv

            # split the Schur recursion at the elliptic/saddle boundary:
            # unpivoted block splits are stable on the elliptic block, and
            # the saddle Schur complement is then dense and well-behaved
            inv32 = saddle_split_inv(Ac.astype(jnp.float32), self.n_elliptic)
            if self.store_dtype is not None:
                inv32 = inv32.astype(self.store_dtype)
            coarse = (inv32, Ac)
        else:
            coarse = jax.scipy.linalg.lu_factor(Ac)
        return (Binv, coarse, matvec)

    def _coarse_apply(self, coarse, rc):
        if self.coarse_solve == "inv":
            inv32, Ac = coarse
            # full-f32 matvecs: bf16-pass rounding here makes the refinement
            # stall at ~1e-3 instead of contracting at the inverse's quality
            # (bf16 STORAGE of the inverse is fine: the apply promotes)
            with jax.default_matmul_precision("highest"):
                z = jnp.matmul(
                    inv32, rc.astype(jnp.float32),
                    preferred_element_type=jnp.float32).astype(rc.dtype)
                for _ in range(self.refine_steps):
                    r2 = rc - Ac @ z
                    z = z + (inv32 @ r2.astype(jnp.float32)).astype(rc.dtype)
            return z
        return jax.scipy.linalg.lu_solve(coarse, rc)

    def apply(self, fac, r, tb=None):
        tb = tb or self.tables
        Binv, coarse, matvec = fac
        # first pre-sweep starts from z = 0: skip the wasted matvec(0)
        z = self.smooth_damp * self.bj.apply(Binv, r, tb)
        for _ in range(self.pre_sweeps - 1):
            z = z + self.smooth_damp * self.bj.apply(Binv, r - matvec(z), tb)
        rc = self.restrict(r - matvec(z), tb)
        z = z + self.prolong(self._coarse_apply(coarse, rc), tb)
        for _ in range(self.post_sweeps):
            z = z + self.smooth_damp * self.bj.apply(Binv, r - matvec(z), tb)
        return z
