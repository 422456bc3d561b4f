"""Nested-dissection multifrontal LU, factorized and solved ON DEVICE.

On-device replacement for the reference's serial/parallel sparse direct
solvers (``src/sl_umf.c`` UMFPACK, ``src/sl_lu.c`` sparse1.4, Amesos
SuperLU/MUMPS dispatch ``src/mm_sol_nonlinear.c:1290-1515``). Those run on
the host CPU; this one maps the whole factorization onto batched dense
linear algebra on the accelerator:

- **Host symbolic phase** (once per sparsity pattern): recursive graph
  bisection of the adjacency of A+A^T (multilevel KWAY native kernel, the
  METIS analog already used for domain partitioning) builds a
  nested-dissection separator tree. Each tree node owns its separator dofs
  (leaves own whole subdomains); the node's *front* is [own | boundary]
  where boundary = ancestor dofs adjacent to the node's subtree. By the
  separator property the Schur complement of a subtree is dense exactly on
  that boundary, so all fill lives inside the dense fronts.
- **Device numeric phase** (every Newton iteration): levels are processed
  deepest-first; all fronts of a level factor TOGETHER as one batched dense
  LU (``jax.lax.linalg.lu`` with partial pivoting *within* the fully-summed
  block) + two batched triangular solves + one batched matmul for the Schur
  complement, all with static shapes. Front assembly is a unique-index
  scatter of the CSR entries plus one-hot placement matmuls for the
  children's Schur complements.
- **Static pivoting** (SuperLU_DIST GESP-style): no pivoting across the
  own/boundary split; tiny pivots are boosted to tau*max|diag| and the
  solve is wrapped in iterative refinement, which also recovers f64-quality
  solutions from an f32 factorization.

Complexity is the classic ND bound (O(n^{3/2}) flops / O(n log n) memory in
2D), carried out as batched dense kernels instead of scalar sparse loops.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp
from jax.lax.linalg import triangular_solve

from goma_tpu.fem.sparsity import CSRPattern


# ------------------------------------------------------------------ symbolic
@dataclass
class _Level:
    depth: int
    nn: int
    smax: int
    bmax: int
    own_w: np.ndarray   # (nn, smax) int32 dof ids; pad -> n (dummy slot)
    bnd_w: np.ndarray   # (nn, bmax) int32 dof ids; pad -> n+1
    # compact (front-linear-position, source) pairs for the CSR entries;
    # the dense gather map is built from these in NDLU.__init__
    a_lin: np.ndarray   # int32 into nn*f*f
    a_src: np.ndarray   # int32 into vals
    # child Schur extend-add as PERMUTED DENSE BLOCKS: the child's Schur
    # complement is dense on its boundary, so extend-add is
    # F[q] += P S_child P^T with P the (f, cb) one-hot placing child
    # boundary slots into the parent front — two batched matmuls instead of
    # an arbitrary (nn, f, f) gather over every front slot
    c0_pos: np.ndarray | None  # (nn, cb) parent-front slot of child-0
    #                            boundary element i; pad -> f (one-hot 0)
    c0_idx: np.ndarray | None  # (nn,) child-0 lvl_pos in child level
    c1_pos: np.ndarray | None
    c1_idx: np.ndarray | None
    cb: int             # child-level bmax (0 = no children anywhere)
    pad_node: np.ndarray  # identity-pad own slots
    pad_slot: np.ndarray


def _bisect(xadj, adjncy, n):
    """0/1 bisection of a subgraph (native multilevel FM; BFS fallback)."""
    from goma_tpu.native import bisect_partition

    w = np.ones(adjncy.shape[0], dtype=np.int64)
    return bisect_partition(xadj.astype(np.int64), adjncy.astype(np.int64), w)


def zero_diag_defer_mask(pattern: CSRPattern, vals,
                         tol: float = 1e-12) -> np.ndarray:
    """(n,) bool mask of rows whose diagonal is (near-)zero relative to the
    row max — saddle/multiplier rows that must be ordered LAST within each
    frontal block so the blocked panel LU never factors a structurally
    singular leading sub-block (cf. the reference routing such systems to
    full-pivoting UMFPACK, ``src/sl_umf.c``)."""
    import scipy.sparse as sp

    v = np.asarray(vals, dtype=np.float64)
    A = sp.csr_matrix((v, pattern.indices, pattern.indptr),
                      shape=(pattern.n, pattern.n))
    d = np.abs(A.diagonal())
    rowmax = np.abs(A).max(axis=1).toarray().ravel()
    return d <= tol * np.maximum(rowmax, 1e-300)


def node_clusters(problem) -> np.ndarray:
    """(n_dof,) cluster ids grouping every mesh node's dofs (velocity +
    pressure + scalars at that node) into one atomic unit for the ND
    bisection; elemental (P0/P1E) dofs stay singletons. See
    :func:`build_nd_tree` ``clusters``."""
    dm = problem.dofmap
    n = dm.n_dof
    cl = np.arange(n, dtype=np.int64)
    cnt = np.asarray(dm.node_dof_count)
    start = np.asarray(dm.node_dof_start)
    live = np.flatnonzero(cnt > 0)
    idx = np.concatenate([start[i] + np.arange(cnt[i]) for i in live]) \
        if live.size else np.empty(0, np.int64)
    cl[idx] = n + np.repeat(live, cnt[live])
    return cl


def build_nd_tree(pattern: CSRPattern, leaf_max: int = 96, debug: bool = False,
                  defer_dofs: np.ndarray | None = None,
                  clusters: np.ndarray | None = None):
    """Host symbolic analysis: separator tree + per-level gather plans.

    ``defer_dofs`` (bool (n,)): dofs ordered last within each tree node's
    own block (stable), so panel-restricted pivoting (``lu_block``) factors
    the elliptic sub-block before any zero-diagonal saddle row.

    ``clusters`` (int (n,)): atomic dof groups — bisection and separators
    operate on the CLUSTER graph, so all dofs of a cluster land in the
    same tree node. Passing the mesh-node clustering keeps every saddle
    (pressure) dof in the same front as its own node's conjugate momentum
    rows, the structural guarantee that the defer-ordered front elimination
    fills the saddle diagonals before they pivot, whatever the per-deck
    leaf_max."""
    import time as _time

    import scipy.sparse as sp

    _t = {"t0": _time.perf_counter()}

    def _mark(name):
        if debug:
            now = _time.perf_counter()
            print(f"ndlu symbolic [{name}]: {now - _t['t0']:.2f}s")
            _t["t0"] = now

    n = pattern.n
    A = sp.csr_matrix((np.ones(pattern.nnz, dtype=np.int8), pattern.indices,
                       pattern.indptr), shape=(n, n))
    G = (A + A.T).tocsr()
    G.setdiag(0)
    G.eliminate_zeros()

    if clusters is not None:
        # condense the dof graph to the cluster graph, run the IDENTICAL
        # tree construction on it, and expand own/boundary sets back to
        # dofs at the end (the recursion below sees cluster vertex ids)
        cl = np.asarray(clusters, dtype=np.int64)
        _, cl = np.unique(cl, return_inverse=True)  # densify ids
        ncl = int(cl.max()) + 1
        Pm = sp.csr_matrix((np.ones(n, np.int8), (cl, np.arange(n))),
                           shape=(ncl, n))
        Gc = (Pm @ G @ Pm.T).tocsr()
        Gc.setdiag(0)
        Gc.eliminate_zeros()
        order = np.argsort(cl, kind="stable")
        cstart = np.searchsorted(cl[order], np.arange(ncl + 1))
        dofs_of_cluster = [order[cstart[i]:cstart[i + 1]] for i in range(ncl)]
        csize = np.diff(cstart)
        G_work, n_work = Gc, ncl
    else:
        G_work, n_work = G, n
        csize = np.ones(n, dtype=np.int64)

    own_of, parent, depth = [], [], []  # per tree node

    mark = np.full(n_work, -1, dtype=np.int64)  # global -> local id scratch

    def _subgraph(verts: np.ndarray):
        """CSR of G_work restricted to `verts` (vectorized; ~6x faster than
        scipy's double fancy-index)."""
        k = verts.shape[0]
        mark[verts] = np.arange(k)
        start = G_work.indptr[verts]
        cnt = G_work.indptr[verts + 1] - start
        total = int(cnt.sum())
        # flat positions of all rows' entries: repeat each row start, add
        # a within-row ramp
        off = np.repeat(start - np.concatenate(([0], np.cumsum(cnt)[:-1])),
                        cnt)
        pos = off + np.arange(total)
        loc = mark[G_work.indices[pos]]
        keep = loc >= 0
        row_of = np.repeat(np.arange(k), cnt)[keep]
        indptr = np.concatenate(
            ([0], np.cumsum(np.bincount(row_of, minlength=k))))
        mark[verts] = -1
        return indptr.astype(np.int64), loc[keep].astype(np.int64)

    def rec(verts: np.ndarray, par: int, d: int) -> None:
        if int(csize[verts].sum()) <= leaf_max:
            own_of.append(verts)
            parent.append(par)
            depth.append(d)
            return
        sub_indptr, sub_indices = _subgraph(verts)
        part = _bisect(sub_indptr, sub_indices, verts.shape[0])
        m0 = part == 0
        if m0.all() or not m0.any():
            own_of.append(verts)
            parent.append(par)
            depth.append(d)
            return
        # vertex separator: smaller of the two edge-cut boundaries
        src = np.repeat(np.arange(verts.shape[0]), np.diff(sub_indptr))
        cross = part[src] != part[sub_indices]
        b0 = np.unique(src[cross & m0[src]])
        b1 = np.unique(src[cross & ~m0[src]])
        sep = b0 if b0.shape[0] <= b1.shape[0] else b1
        sep_mask = np.zeros(verts.shape[0], dtype=bool)
        sep_mask[sep] = True
        me = len(own_of)
        own_of.append(verts[sep_mask])
        parent.append(par)
        depth.append(d)
        c0 = verts[m0 & ~sep_mask]
        c1 = verts[~m0 & ~sep_mask]
        if c0.shape[0]:
            rec(c0, me, d + 1)
        if c1.shape[0]:
            rec(c1, me, d + 1)

    rec(np.arange(n_work, dtype=np.int32), -1, 0)
    _mark("recursion")
    n_nodes = len(own_of)
    if clusters is not None:
        # expand cluster vertex sets back to dof sets; everything below
        # (boundaries, entry assignment) runs on the dof graph G
        own_of = [
            np.concatenate([dofs_of_cluster[c] for c in verts]).astype(
                np.int64)
            if verts.shape[0] else np.empty(0, np.int64)
            for verts in own_of
        ]
    if defer_dofs is not None:
        # elliptic-first / saddle-last inside every own block: with blocked
        # panel LU the leading panels then always pivot on rows that carry a
        # (possibly Schur-filled) nonzero diagonal
        for t in range(n_nodes):
            own = own_of[t]
            if own.shape[0] > 1:
                own_of[t] = own[np.argsort(defer_dofs[own], kind="stable")]
    depth = np.asarray(depth)
    parent = np.asarray(parent)

    owner = np.empty(n, dtype=np.int32)
    pos_in_own = np.empty(n, dtype=np.int32)
    for t, own in enumerate(own_of):
        owner[own] = t
        pos_in_own[own] = np.arange(own.shape[0], dtype=np.int32)

    # proper-ancestor matrix (n_nodes small: <= a few thousand)
    anc = np.zeros((n_nodes, n_nodes), dtype=bool)
    for t in range(n_nodes):
        p = parent[t]
        while p >= 0:
            anc[t, p] = True
            p = parent[p]

    children: list[list[int]] = [[] for _ in range(n_nodes)]
    for t in range(n_nodes):
        if parent[t] >= 0:
            children[parent[t]].append(t)

    # bottom-up boundaries: B(t) = (N(own t) ∪ B(children)) ∩ ancestors(t)
    bnd_of: list[np.ndarray] = [None] * n_nodes
    for t in sorted(range(n_nodes), key=lambda q: -depth[q]):
        own = own_of[t]
        nbr = [G.indices[G.indptr[v]:G.indptr[v + 1]] for v in own]
        cand = [np.concatenate(nbr)] if nbr else [np.empty(0, np.int32)]
        for c in children[t]:
            cand.append(bnd_of[c])
        cand = np.unique(np.concatenate(cand)).astype(np.int32)
        keep = anc[t, owner[cand]]
        bnd_of[t] = cand[keep]

    _mark("boundaries")
    # level grouping by depth; per-node (level, index-in-level)
    max_d = int(depth.max())
    level_nodes = [np.where(depth == d)[0] for d in range(max_d + 1)]
    lvl_pos = np.empty(n_nodes, dtype=np.int32)
    for d, ids in enumerate(level_nodes):
        lvl_pos[ids] = np.arange(ids.shape[0], dtype=np.int32)

    smax = [max((own_of[t].shape[0] for t in ids), default=1) or 1
            for ids in level_nodes]
    bmax = [max((bnd_of[t].shape[0] for t in ids), default=0)
            for ids in level_nodes]
    smax = [max(s, 1) for s in smax]

    # (node, dof) -> boundary-slot lookup table
    bkeys, bvals = [], []
    for t in range(n_nodes):
        b = bnd_of[t]
        if b.shape[0]:
            bkeys.append(t * np.int64(n) + b.astype(np.int64))
            bvals.append(np.arange(b.shape[0], dtype=np.int32))
    bkeys = np.concatenate(bkeys) if bkeys else np.empty(0, np.int64)
    bvals = np.concatenate(bvals) if bvals else np.empty(0, np.int32)
    order = np.argsort(bkeys)
    bkeys, bvals = bkeys[order], bvals[order]

    def bnd_pos(ts, dofs):
        k = ts.astype(np.int64) * n + dofs.astype(np.int64)
        p = np.searchsorted(bkeys, k)
        p = np.clip(p, 0, max(bkeys.shape[0] - 1, 0))
        if bkeys.shape[0] == 0 or not np.all(bkeys[p] == k):
            raise RuntimeError("ndlu: boundary lookup miss (broken separator tree)")
        return bvals[p]

    _mark("lookups")
    # assign CSR entries to the deeper endpoint's node, vectorized
    ri, ci = pattern.rows, pattern.indices
    oi, oj = owner[ri], owner[ci]
    di, dj = depth[oi], depth[oj]
    if not np.all((di != dj) | (oi == oj)):
        raise RuntimeError("ndlu: entry between separated parts (bad separator)")
    t_ent = np.where(di >= dj, oi, oj).astype(np.int32)
    d_ent = depth[t_ent]
    s_ent = np.asarray(smax)[d_ent]
    own_i = owner[ri] == t_ent
    own_j = owner[ci] == t_ent
    r_ent = np.where(own_i, pos_in_own[ri], 0)
    c_ent = np.where(own_j, pos_in_own[ci], 0)
    if np.any(~own_i):
        r_ent[~own_i] = s_ent[~own_i] + bnd_pos(t_ent[~own_i], ri[~own_i])
    if np.any(~own_j):
        c_ent[~own_j] = s_ent[~own_j] + bnd_pos(t_ent[~own_j], ci[~own_j])

    _mark("entries")
    levels: list[_Level] = []
    for d in range(max_d, -1, -1):  # deepest first (elimination order)
        ids = level_nodes[d]
        nn = ids.shape[0]
        s, b = smax[d], bmax[d]
        f = s + b
        own_w = np.empty((nn, s), dtype=np.int32)
        own_w.fill(n)
        bnd_w = np.empty((nn, b), dtype=np.int32)
        bnd_w.fill(n + 1)
        pad_node, pad_slot = [], []
        for q, t in enumerate(ids):
            o, bb = own_of[t], bnd_of[t]
            own_w[q, :o.shape[0]] = o
            if bb.shape[0]:
                bnd_w[q, :bb.shape[0]] = bb
            if o.shape[0] < s:
                pad_node.append(np.full(s - o.shape[0], q, np.int32))
                pad_slot.append(np.arange(o.shape[0], s, dtype=np.int32))
        pad_node = np.concatenate(pad_node) if pad_node else np.empty(0, np.int32)
        pad_slot = np.concatenate(pad_slot) if pad_slot else np.empty(0, np.int32)

        # COMPACT (lin, src) pairs only: the device scatters the CSR entries
        # into the level's (nn, f, f) front array (NDLU._factor_body), so no
        # dense per-slot map is ever built on the host.
        if nn * f * f + 1 >= np.iinfo(np.int32).max:
            raise RuntimeError("ndlu: level front array exceeds int32 "
                               "indexing; raise leaf_max")
        sel = d_ent == d
        a_lin = ((lvl_pos[t_ent[sel]].astype(np.int64) * f
                  + r_ent[sel]) * f + c_ent[sel]).astype(np.int32)
        a_src = np.flatnonzero(sel).astype(np.int32)

        c0_pos = c0_idx = c1_pos = c1_idx = None
        cb = 0
        if d < max_d:
            cids = level_nodes[d + 1]
            cb = bmax[d + 1]
            c0_pos = np.full((nn, cb), f, dtype=np.int32)
            c1_pos = np.full((nn, cb), f, dtype=np.int32)
            c0_idx = np.zeros(nn, dtype=np.int32)
            c1_idx = np.zeros(nn, dtype=np.int32)
            for c in cids:
                bc = bnd_of[c]
                k = bc.shape[0]
                t = parent[c]
                q = int(lvl_pos[t])
                which = 0 if children[t][0] == c else 1
                (c0_idx if which == 0 else c1_idx)[q] = int(lvl_pos[c])
                if not k:
                    continue  # empty boundary: all-pad row, zero one-hot
                mine = owner[bc] == t
                fp = np.where(mine, pos_in_own[bc], 0).astype(np.int64)
                if np.any(~mine):
                    fp[~mine] = s + bnd_pos(np.full((~mine).sum(), t), bc[~mine])
                (c0_pos if which == 0 else c1_pos)[q, :k] = fp

        levels.append(_Level(d, nn, s, b, own_w, bnd_w, a_lin, a_src,
                             c0_pos, c0_idx, c1_pos, c1_idx, cb,
                             pad_node, pad_slot))
    _mark("levels")
    return levels


# ------------------------------------------------------------------ numeric
def gesp_boost(lu_d, pivot_tol: float):
    """GESP static-pivot boost on a batch of packed LU diagonals: pivots
    below ``pivot_tol * max|diag|`` of their front are raised to that
    size, keeping their sign."""
    s = lu_d.shape[-1]
    dg = jnp.diagonal(lu_d, axis1=1, axis2=2)
    mx = jnp.max(jnp.abs(dg), axis=1, keepdims=True)
    tau = pivot_tol * jnp.maximum(mx, 1e-30)
    fix = jnp.where(jnp.abs(dg) < tau, jnp.where(dg < 0, -tau, tau), dg)
    ar = jnp.arange(s)
    return lu_d.at[:, ar, ar].set(fix)


class NDLU:
    """Device multifrontal LU for a fixed :class:`CSRPattern`.

    ``factor(vals)`` -> opaque factor pytree (device); ``solve(fac, b)``
    applies it. ``solve_refined`` wraps iterative refinement using the
    pattern's ELL matvec — with an f32 factorization this recovers ~f32
    backward error in 1-2 steps and keeps improving with f64 vals.

    Constraint: pivoting cannot cross the own/boundary split, so for saddle
    systems (zero pressure diagonal) ``leaf_max`` must stay large enough
    that interior constraint dofs keep their conjugate partners inside the
    same block — ~2x the per-node dof count is the practical floor; the
    default 96 is safe for Q2/Q1-class problems. With ``lu_block`` pivoting
    is further restricted to bs x bs panels, so saddle systems additionally
    need ``defer_dofs`` (see :func:`zero_diag_defer_mask`) ordering the
    zero-diagonal rows last within each front — otherwise a leading panel
    can be structurally singular. A structurally-deficient block shows up
    as a boosted pivot and a large post-solve residual (the Newton
    tpu_direct path checks and aborts).
    """

    def __init__(self, pattern: CSRPattern, leaf_max: int = 96,
                 dtype=jnp.float32, pivot_tol: float = 1e-8,
                 lu_block: int | None = None,
                 defer_dofs: np.ndarray | None = None,
                 invert: bool = False,
                 clusters: np.ndarray | None = None):
        self.pattern = pattern
        self.dtype = dtype
        self.pivot_tol = pivot_tol
        # invert=True: SELECTIVE INVERSION (SuperLU_DIST-style) — L/U are
        # explicitly inverted at factor time so every solve application is
        # a batched matmul instead of a sequential triangular solve. The
        # inverse-apply rounding error is ~eps*cond(front), which a KRYLOV
        # wrapper absorbs but stationary iterative refinement may not — use
        # for preconditioning (precond="ndlu"), keep False for tpu_direct
        # refinement solves.
        self.invert = invert
        # lu_block=bs: blocked right-looking LU with pivoting restricted to
        # bs x bs diagonal blocks — a front is factored in ceil(s/bs) block
        # steps (small-block lu + 2 triangular solves + 1 matmul each).
        # Block-local row perms act on disjoint row slices, so they compose
        # into one block-diagonal permutation and the solve path is
        # unchanged. None (default) = one batched lu per level with partial
        # pivoting over the whole fully-summed block: on the H100 that was
        # the fastest factor of the 64x64 cavity (PERF.md, PR 1).
        self.lu_block = lu_block
        self.levels = build_nd_tree(pattern, leaf_max=leaf_max,
                                    defer_dofs=defer_dofs,
                                    clusters=clusters)
        self.n = pattern.n
        # device tables, passed as jit arguments (too big for jaxpr consts).
        # Front assembly uses the COMPACT (lin, src) pairs with a
        # unique-index scatter-set on device: it touches only the real CSR
        # entries, not every slot of the (nn, f, f) fronts.
        def onehot(pos, f):
            # (nn, f, cb) f32 placement: P[q, pos[q, i], i] = 1; pad slots
            # (pos == f) fall off the end -> all-zero column
            nn, cb = pos.shape
            P = np.zeros((nn, f + 1, cb), np.float32)
            qq = np.repeat(np.arange(nn), cb)
            P[qq, pos.ravel(), np.tile(np.arange(cb), nn)] = 1.0
            return jax.device_put(np.ascontiguousarray(P[:, :f, :]))

        self.tabs = []
        for lev in self.levels:
            f = lev.smax + lev.bmax
            p0 = p1 = i0 = i1 = None
            if lev.c0_pos is not None and lev.cb:
                p0 = onehot(lev.c0_pos, f)
                p1 = onehot(lev.c1_pos, f)
                i0 = jax.device_put(lev.c0_idx)
                i1 = jax.device_put(lev.c1_idx)
            self.tabs.append(dict(
                own_w=jax.device_put(lev.own_w),
                bnd_w=jax.device_put(lev.bnd_w),
                a_lin=jax.device_put(lev.a_lin),
                a_src=jax.device_put(lev.a_src),
                p0=p0, p1=p1, i0=i0, i1=i1,
                pad_node=jax.device_put(lev.pad_node),
                pad_slot=jax.device_put(lev.pad_slot),
            ))
        # preconditioner-protocol alias: NewtonSolver routes these through
        # its ntab jit-argument pytree (precond="ndlu") so the tables never
        # serialize into the traced program as constants
        self.tables = self.tabs
        self._factor_jit = jax.jit(self._factor)
        self._solve_jit = jax.jit(self._solve)

    def _block_lu(self, A11):
        """Blocked right-looking LU, pivoting restricted to the diagonal
        blocks. Returns (packed LU (nn, m, m), row perm (nn, m)) with
        m = ceil(s / bs) * bs; padded slots are identity rows/cols."""
        bs = self.lu_block
        nn, s, _ = A11.shape
        nb = -(-s // bs)
        m = nb * bs
        if m != s:
            A = jnp.zeros((nn, m, m), self.dtype)
            A = A.at[:, :s, :s].set(A11)
            ar = jnp.arange(s, m)
            A = A.at[:, ar, ar].set(1.0)
        else:
            A = A11
        perms = []
        for k in range(nb):
            r0 = k * bs
            D = A[:, r0:r0 + bs, r0:r0 + bs]
            lu_d, _piv, perm_d = jax.lax.linalg.lu(D)
            lu_d = gesp_boost(lu_d, self.pivot_tol)
            # permute the whole row slab (incl. already-computed L columns),
            # write the packed diagonal LU, eliminate the right panel
            slab = jnp.take_along_axis(A[:, r0:r0 + bs, :],
                                       perm_d[:, :, None], axis=1)
            slab = slab.at[:, :, r0:r0 + bs].set(lu_d)
            if r0 + bs < m:
                U12 = triangular_solve(lu_d, slab[:, :, r0 + bs:],
                                       left_side=True, lower=True,
                                       unit_diagonal=True)
                slab = slab.at[:, :, r0 + bs:].set(U12)
            A = A.at[:, r0:r0 + bs, :].set(slab)
            if r0 + bs < m:
                L21 = triangular_solve(lu_d, A[:, r0 + bs:, r0:r0 + bs],
                                       left_side=False, lower=False)
                A = A.at[:, r0 + bs:, r0:r0 + bs].set(L21)
                A = A.at[:, r0 + bs:, r0 + bs:].add(-(L21 @ U12))
            perms.append(perm_d + r0)
        return A, jnp.concatenate(perms, axis=1)

    # --- numeric factorization: one batched dense elimination per level
    def _factor(self, vals, tabs):
        # Pin every dense product in the factorization to full f32: a
        # reduced-precision default (TF32 or bf16 passes) degrades the Schur
        # complements (X @ Y below) to ~3-digit accuracy per level, and
        # refinement then stalls above the Newton linear tolerance on stiff
        # multi-field fronts.
        with jax.default_matmul_precision("highest"):
            return self._factor_body(vals, tabs)

    def _factor_body(self, vals, tabs):
        vals32 = vals.astype(self.dtype)
        facs = []
        S_prev = None
        for i, (lev, tb) in enumerate(zip(self.levels, tabs)):
            f = lev.smax + lev.bmax
            # compact unique-index scatter-set: only real CSR entries touch
            # the front array (see __init__ note)
            F = jnp.zeros(lev.nn * f * f, self.dtype).at[tb["a_lin"]].set(
                vals32[tb["a_src"]], unique_indices=True,
            ).reshape(lev.nn, f, f)
            if S_prev is not None and tb["p0"] is not None:
                # extend-add via one-hot placement matmuls (HIGHEST
                # precision: the 0/1 one-hot only selects, but a
                # reduced-precision matmul would round the Schur values)
                hi = jax.lax.Precision.HIGHEST
                for P, idx in ((tb["p0"], tb["i0"]), (tb["p1"], tb["i1"])):
                    Sc = S_prev[idx].astype(self.dtype)  # (nn, cb, cb)
                    F = F + jnp.einsum("qfa,qab,qgb->qfg", P, Sc, P,
                                       precision=hi)
            if lev.pad_node.shape[0]:
                F = F.at[tb["pad_node"], tb["pad_slot"], tb["pad_slot"]].add(1.0)
            s = lev.smax
            A11 = F[:, :s, :s]
            # named per level so a profiler trace attributes the front
            # factor (LU + boost + inversion) to its level
            with jax.named_scope(f"ndlu_l{i}_front_lu"):
                if self.lu_block and s > self.lu_block:
                    lu, perm = self._block_lu(A11)  # (nn, m, m), (nn, m)
                else:
                    lu, _piv, perm = jax.lax.linalg.lu(A11)
                    lu = gesp_boost(lu, self.pivot_tol)
                m = lu.shape[-1]  # == s, or the bs-padded size under lu_block
                if self.invert:
                    # invert ONCE so later applies (A12/A21 panels here, every
                    # substitution in solve()) are batched matmuls
                    eye = jnp.broadcast_to(jnp.eye(m, dtype=self.dtype),
                                           (lev.nn, m, m))
                    fwd = triangular_solve(lu, eye, left_side=True, lower=True,
                                           unit_diagonal=True)
                    bwd = triangular_solve(lu, eye, left_side=True, lower=False)
                else:
                    fwd = bwd = lu  # substitution path (exact triangular solves)
            if lev.bmax:
                A12 = F[:, :s, s:]
                A21 = F[:, s:, :s]
                A22 = F[:, s:, s:]
                if m != s:  # identity-padded rows/cols contribute zeros
                    A12 = jnp.concatenate(
                        [A12, jnp.zeros((lev.nn, m - s, lev.bmax),
                                        self.dtype)], axis=1)
                    A21 = jnp.concatenate(
                        [A21, jnp.zeros((lev.nn, lev.bmax, m - s),
                                        self.dtype)], axis=2)
                A12p = jnp.take_along_axis(A12, perm[:, :, None], axis=1)
                if self.invert:
                    Y = fwd @ A12p        # == L^{-1} P A12
                    X = A21 @ bwd         # == A21 U^{-1}
                else:
                    Y = triangular_solve(lu, A12p, left_side=True,
                                         lower=True, unit_diagonal=True)
                    X = triangular_solve(lu, A21, left_side=False,
                                         lower=False)
                S_prev = A22 - X @ Y
            else:
                X = jnp.zeros((lev.nn, 0, m), self.dtype)
                Y = jnp.zeros((lev.nn, m, 0), self.dtype)
                S_prev = jnp.zeros((lev.nn, 0, 0), self.dtype)
            facs.append((fwd, bwd, perm, X, Y))
        return facs

    def factor(self, vals):
        return self._factor_jit(vals, self.tabs)

    # --- forward/backward substitution through the tree. invert=True:
    # batched matvecs against the precomputed inverses (HIGHEST
    # precision). invert=False: exact triangular substitution.
    def _solve(self, facs, b, tabs):
        n = self.n
        hi = jax.lax.Precision.HIGHEST
        w = jnp.zeros(n + 2, self.dtype).at[:n].set(b.astype(self.dtype))
        for lev, tb, (fwd, bwd, perm, X, Y) in zip(self.levels, tabs, facs):
            bs = w[tb["own_w"]]
            m = fwd.shape[-1]
            if m != lev.smax:  # lu_block padding: zero-extend the segment
                bs = jnp.concatenate(
                    [bs, jnp.zeros((bs.shape[0], m - lev.smax), bs.dtype)],
                    axis=1)
            bs = jnp.take_along_axis(bs, perm, axis=1)
            if self.invert:
                y = jnp.einsum("nij,nj->ni", fwd, bs, precision=hi)
            else:
                y = triangular_solve(fwd, bs[..., None], left_side=True,
                                     lower=True, unit_diagonal=True)[..., 0]
            w = w.at[tb["own_w"]].set(y[:, :lev.smax])
            if lev.bmax:
                w = w.at[tb["bnd_w"]].add(-jnp.einsum(
                    "nbs,ns->nb", X, y))
        for lev, tb, (fwd, bwd, perm, X, Y) in zip(
                reversed(self.levels), reversed(tabs), reversed(facs)):
            y = w[tb["own_w"]]
            m = bwd.shape[-1]
            if m != lev.smax:
                y = jnp.concatenate(
                    [y, jnp.zeros((y.shape[0], m - lev.smax), y.dtype)],
                    axis=1)
            if lev.bmax:
                y = y - jnp.einsum("nsb,nb->ns", Y, w[tb["bnd_w"]])
            if self.invert:
                x = jnp.einsum("nij,nj->ni", bwd, y, precision=hi)
            else:
                x = triangular_solve(bwd, y[..., None], left_side=True,
                                     lower=False)[..., 0]
            w = w.at[tb["own_w"]].set(x[:, :lev.smax])
        return w[:n]

    def solve(self, facs, b):
        return self._solve_jit(facs, b, self.tabs)

    def solve_refined(self, facs, b, matvec, refine: int = 2,
                      rel_tol: float = 0.0, max_refine: int = 8,
                      return_rel: bool = False, sweep=None):
        """x = A^{-1} b with iterative-refinement sweeps; matvec should
        apply the SAME (equilibrated) operator the factorization saw, at
        its native (possibly higher) precision.

        ``refine`` fixed sweeps are always taken; if ``rel_tol > 0``,
        refinement continues (up to ``max_refine`` total) until
        ||b - A x|| <= rel_tol * ||b|| — the f32-front refinement rate is
        ~10x/sweep, but where it lands relative to a caller's guard varies
        with the backend's rounding, so a fixed count alone can strand the
        solve just above the guard.

        ``return_rel``: also return the measured ||b - A x|| / ||b|| of
        the RETURNED iterate, or None when the loop exited without
        measuring it (caller decides whether to recompute — each measure
        costs a matvec plus a host sync).

        ``sweep``: optional FUSED step ``(facs, b, x) -> (x_new, rn)``
        computing ``r = b - A x; rn = ||r||; x_new = x + solve(facs, r)``
        in ONE jitted dispatch instead of separate matvec/norm/solve
        dispatches. The math is identical to the unfused path."""
        import jax as _jax

        x = self.solve(facs, b).astype(b.dtype)
        bnorm = None
        prev_rn = None
        rel = None
        for it in range(max_refine):
            if sweep is not None:
                x_new, rn_d = sweep(facs, b, x)
            else:
                r = b - matvec(x)
                rn_d = None
            if it >= refine:
                if rel_tol <= 0.0:
                    break
                if bnorm is None:
                    bnorm = float(_jax.device_get(jnp.linalg.norm(b)))
                if rn_d is None:
                    rn_d = jnp.linalg.norm(r)
                rn = float(_jax.device_get(rn_d))
                rel = rn / (bnorm + 1e-300)  # residual of the CURRENT x
                if not np.isfinite(rn) or rn <= rel_tol * (bnorm + 1e-300):
                    break
                if prev_rn is not None and rn >= 0.9 * prev_rn:
                    # refinement stalled/diverging (a LAGGED factorization
                    # against a fresh operator does this once the Jacobian
                    # has moved too far: rho(I - A_new A_old^-1) >= 1) —
                    # stop burning sweeps; the caller's residual guard
                    # decides whether to refactor
                    break
                prev_rn = rn
            x = (x_new if sweep is not None
                 else x + self.solve(facs, r).astype(b.dtype))
            rel = None  # x moved past the last measurement
        return (x, rel) if return_rel else x
