"""Stacked per-device NDLU: the distributed direct/strong subdomain solver.

The reference's parallel story includes distributed direct solves (Amesos
SuperLU_DIST / MUMPS, ``src/sl_amesos_interface.cpp:68``, dispatch
``src/mm_sol_nonlinear.c:1410-1434``). The counterpart built here: every
device factors its OWNED subdomain matrix with the same on-device
nested-dissection multifrontal LU the single-device path uses
(``solvers/ndlu.py``), and the factors act as the (restricted additive
Schwarz) subdomain solve of the partitioned Krylov iteration — fully
local applies, no halo traffic, selective inversion so every substitution
is a batched matmul.

SPMD constraint: one program runs on all devices, so per-device trees are
padded to a common SHAPE ENVELOPE — the per-level (nn, smax, bmax) maxima
over devices, with identity-padded fronts and zero one-hot extend-adds
where a device has fewer/smaller fronts (or fewer levels: degenerate
all-identity deep levels are prepended). All per-device differences live
in table CONTENTS (stacked with a leading device axis and sharded);
``factor``/``solve`` run inside ``shard_map`` on the [0]-sliced views.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from goma_tpu.fem.sparsity import CSRPattern
from jax.lax.linalg import triangular_solve

from goma_tpu.solvers.ndlu import build_nd_tree, gesp_boost


def _local_pattern(n: int, rows: np.ndarray, cols: np.ndarray) -> CSRPattern:
    keys = rows.astype(np.int64) * n + cols.astype(np.int64)
    order = np.argsort(keys)
    rows, cols, keys = rows[order], cols[order], keys[order]
    indptr = np.searchsorted(rows, np.arange(n + 1))
    diag = np.searchsorted(keys, np.arange(n, dtype=np.int64) * n
                           + np.arange(n))
    return CSRPattern(n=n, indptr=indptr.astype(np.int64),
                      indices=cols.astype(np.int32),
                      rows=rows.astype(np.int32), keys=keys,
                      diag=diag.astype(np.int64)), order


class StackedNDLU:
    """Per-device multifrontal LU factors under one SPMD program.

    Parameters
    ----------
    locals_ : list of (n_d, rows_d, cols_d, src_d, defer_d[, clusters_d])
        per device — the owned-subdomain pattern in device-local dof ids
        (0..n_d-1), ``src_d`` mapping each entry to its position in that
        device's padded (max_nnz,) CSR-values slice, the saddle defer
        mask, and optionally the atomic dof clustering (mesh-node groups,
        see :func:`goma_tpu.solvers.ndlu.node_clusters`) so every saddle
        dof shares its front with its node's momentum rows.
    mo : padded owned-vector length (PartitionedProblem.max_own).
    max_nnz : padded values length (sentinel slot appended on device).
    """

    def __init__(self, locals_, mo: int, max_nnz: int, leaf_max: int = 96,
                 dtype=jnp.float32, pivot_tol: float = 1e-8):
        self.mo = mo
        self.max_nnz = max_nnz
        self.dtype = dtype
        self.pivot_tol = pivot_tol
        self.nd = len(locals_)

        trees = []
        for loc in locals_:
            n_d, rows_d, cols_d, src_d, defer_d = loc[:5]
            clusters_d = loc[5] if len(loc) > 5 else None
            pat, order = _local_pattern(n_d, np.asarray(rows_d),
                                        np.asarray(cols_d))
            src_sorted = np.asarray(src_d)[order]
            levels = build_nd_tree(pat, leaf_max=leaf_max,
                                   defer_dofs=defer_d,
                                   clusters=clusters_d)
            trees.append((levels, src_sorted))

        L = max(len(t[0]) for t in trees)
        # align at the ROOT (levels are deepest-first): device level lists
        # shorter than L get degenerate deepest levels prepended
        meta = []
        for i in range(L):
            nn = s = b = cb = 0
            for levels, _ in trees:
                off = L - len(levels)
                if i >= off:
                    lv = levels[i - off]
                    nn = max(nn, lv.nn)
                    s = max(s, lv.smax)
                    b = max(b, lv.bmax)
            meta.append(dict(nn=max(nn, 1), s=max(s, 1), b=b))
        for i in range(L):
            # envelope child-boundary size: the previous (deeper) level's b
            meta[i]["cb"] = meta[i - 1]["b"] if i > 0 else 0
        self.meta = meta

        # per-level stacked tables
        self.tabs = []
        for i in range(L):
            nn, s, b, cb = (meta[i]["nn"], meta[i]["s"], meta[i]["b"],
                            meta[i]["cb"])
            f = s + b
            # max compact pairs over devices at this level
            K = 1
            for levels, _ in trees:
                off = L - len(levels)
                if i >= off:
                    K = max(K, levels[i - off].a_lin.shape[0])
            own_w = np.full((self.nd, nn, s), mo, np.int32)
            bnd_w = np.full((self.nd, nn, b), mo + 1, np.int32)
            lin = np.full((self.nd, K), 0, np.int32)
            src = np.full((self.nd, K), max_nnz, np.int32)
            padD = np.ones((self.nd, nn, s), np.float32)
            p0 = np.zeros((self.nd, nn, f, max(cb, 1)), np.float32)
            p1 = np.zeros((self.nd, nn, f, max(cb, 1)), np.float32)
            i0 = np.zeros((self.nd, nn), np.int32)
            i1 = np.zeros((self.nd, nn), np.int32)
            for d, (levels, src_sorted) in enumerate(trees):
                off = L - len(levels)
                if i < off:
                    # degenerate pad level: all-identity fronts, no entries
                    # (padD stays 1 everywhere; scatter pads land in the
                    # scratch tail below)
                    lin[d] = nn * f * f + np.arange(K, dtype=np.int32)
                    continue
                lv = levels[i - off]
                fd = lv.smax + lv.bmax
                # remap this device's compact linear positions from its own
                # (nn_d, fd, fd) layout into the envelope (nn, f, f)
                al = lv.a_lin.astype(np.int64)
                q = al // (fd * fd)
                r_ = (al % (fd * fd)) // fd
                c_ = al % fd
                # own slots keep their index; boundary slots shift by s - sd
                r_e = np.where(r_ < lv.smax, r_, r_ + (s - lv.smax))
                c_e = np.where(c_ < lv.smax, c_, c_ + (s - lv.smax))
                lin_d = ((q * f + r_e) * f + c_e).astype(np.int32)
                k = lin_d.shape[0]
                lin[d, :k] = lin_d
                # lv.a_src indexes the LOCAL pattern's entries; src_sorted
                # maps those to this device's (max_nnz,) vals positions
                src[d, :k] = src_sorted[lv.a_src]
                # distinct scratch-slot pads keep the scatter unique
                lin[d, k:] = nn * f * f + np.arange(K - k, dtype=np.int32)
                # lv.own_w pads with n_d (its local n): map those to mo
                ow = lv.own_w.copy()
                ow[ow >= locals_[d][0]] = mo
                own_w[d, :lv.nn, :lv.smax] = ow
                if lv.bmax:
                    bw = lv.bnd_w.copy()
                    bw[bw >= locals_[d][0]] = mo + 1
                    bnd_w[d, :lv.nn, :lv.bmax] = bw
                # identity pads: slots that are real own dofs get 0
                pD = np.ones((nn, s), np.float32)
                real = (ow != mo)
                pD[:lv.nn, :lv.smax] = np.where(real, 0.0, 1.0)
                padD[d] = pD
                if lv.c0_pos is not None and lv.cb:
                    cb_d = lv.cb
                    for which, (pos, idx) in enumerate(
                            ((lv.c0_pos, lv.c0_idx), (lv.c1_pos, lv.c1_idx))):
                        P = p0 if which == 0 else p1
                        I = i0 if which == 0 else i1
                        I[d, :lv.nn] = idx
                        # child boundary slot j of child front -> envelope
                        # parent slot (own kept, boundary shifted)
                        pe = np.where(pos < lv.smax, pos,
                                      pos + (s - lv.smax))
                        for q2 in range(lv.nn):
                            for j in range(cb_d):
                                pj = pe[q2, j]
                                if pos[q2, j] < fd:  # real placement
                                    P[d, q2, pj, j] = 1.0
            self.tabs.append(dict(
                own_w=own_w, bnd_w=bnd_w, lin=lin, src=src, padD=padD,
                p0=p0, p1=p1, i0=i0, i1=i1))

    # ---- device-side pieces (run inside shard_map; tabs pre-sliced [0])
    def factor(self, vals, tabs1):
        """vals: this device's (max_nnz,) CSR values slice. Returns the
        per-level (fwd, bwd, X, Y) factor pytree (selective inversion)."""
        # full-f32 panel/Schur products below — a reduced-precision default
        # degrades the Schur complements past what refinement recovers
        # (see ndlu.NDLU._factor)
        with jax.default_matmul_precision("highest"):
            return self._factor_body(vals, tabs1)

    def _factor_body(self, vals, tabs1):
        hi = jax.lax.Precision.HIGHEST
        vx = jnp.concatenate([vals.astype(self.dtype),
                              jnp.zeros(1, self.dtype)])
        facs = []
        S_prev = None
        for i, (m, tb) in enumerate(zip(self.meta, tabs1)):
            nn, s, b, cb = m["nn"], m["s"], m["b"], m["cb"]
            f = s + b
            K = tb["lin"].shape[0]
            Ff = jnp.zeros(nn * f * f + K, self.dtype)
            Ff = Ff.at[tb["lin"]].set(vx[tb["src"]], unique_indices=True)
            F = Ff[:nn * f * f].reshape(nn, f, f)
            if cb and S_prev is not None:
                for P, idx in ((tb["p0"], tb["i0"]), (tb["p1"], tb["i1"])):
                    Sc = S_prev[idx]
                    F = F + jnp.einsum("qfa,qab,qgb->qfg",
                                       P.astype(self.dtype), Sc,
                                       P.astype(self.dtype), precision=hi)
            # identity pads on own diagonal slots
            eyef = jnp.eye(f, dtype=self.dtype)
            padD = jnp.concatenate(
                [tb["padD"].astype(self.dtype),
                 jnp.zeros((nn, b), self.dtype)], axis=1)
            F = F + padD[:, :, None] * eyef[None]
            # partial pivoting inside the fully-summed block, then the GESP
            # boost: A11[perm] = L U, so A11^-1 = U^-1 L^-1 P with P the
            # row permutation eye[perm]. Folding P into fwd keeps Y, X, the
            # Schur update and solve() free of any explicit permutation.
            lu, _piv, perm = jax.lax.linalg.lu(F[:, :s, :s])
            lu = gesp_boost(lu, self.pivot_tol)
            eye = jnp.eye(s, dtype=self.dtype)
            fwd = triangular_solve(lu, eye[perm], left_side=True, lower=True,
                                   unit_diagonal=True)
            bwd = triangular_solve(
                lu, jnp.broadcast_to(eye, (nn, s, s)), left_side=True,
                lower=False)
            if b:
                Y = fwd @ F[:, :s, s:]
                X = F[:, s:, :s] @ bwd
                S_prev = F[:, s:, s:] - X @ Y
            else:
                X = jnp.zeros((nn, 0, s), self.dtype)
                Y = jnp.zeros((nn, s, 0), self.dtype)
                S_prev = jnp.zeros((nn, 0, 0), self.dtype)
            facs.append((fwd, bwd, X, Y))
        return facs

    def solve(self, facs, r_own, tabs1):
        """z = A_dd^{-1} r on this device's owned slice (mo,)."""
        hi = jax.lax.Precision.HIGHEST
        mo = self.mo
        w = jnp.zeros(mo + 2, self.dtype).at[:mo].set(
            r_own.astype(self.dtype))
        for m, tb, (fwd, bwd, X, Y) in zip(self.meta, tabs1, facs):
            bs = w[tb["own_w"]]
            y = jnp.einsum("nij,nj->ni", fwd, bs, precision=hi)
            w = w.at[tb["own_w"]].set(y)
            if m["b"]:
                w = w.at[tb["bnd_w"]].add(
                    -jnp.einsum("nbs,ns->nb", X, y, precision=hi))
        for m, tb, (fwd, bwd, X, Y) in zip(
                reversed(self.meta), reversed(tabs1), reversed(facs)):
            y = w[tb["own_w"]]
            if m["b"]:
                y = y - jnp.einsum("nsb,nb->ns", Y, w[tb["bnd_w"]],
                                   precision=hi)
            x = jnp.einsum("nij,nj->ni", bwd, y, precision=hi)
            w = w.at[tb["own_w"]].set(x)
        return w[:mo].astype(r_own.dtype)
