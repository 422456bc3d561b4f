"""CSR sparsity pattern, precomputed scatter maps, sparse ops.

Parity: the reference builds the matrix graph from node-node connectivity
filtered by the equation-variable coupling mask
(``src/linalg/sparse_matrix.cpp:60 GomaSparseMatrix_SetProblemGraph``) and
scatters per-element blocks with ``load_lec`` (``src/mm_fill.c:4959``).

Redesign: the pattern is the union of per-block element dof
cross-products, built once on host. Every element-local Jacobian entry
(e, i, j) has a precomputed destination ``nnz_map[e, i, j]`` into the flat
CSR value array, so device-side assembly is a single ``segment_sum`` over a
static index map — no atomics, no pointer chasing. SpMV is gather +
multiply + ``segment_sum`` (padded-row ELL kernels can replace this later
without touching callers).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp


@dataclass
class CSRPattern:
    n: int
    indptr: np.ndarray  # (n+1,) int64
    indices: np.ndarray  # (nnz,) int32 column ids, sorted within rows
    rows: np.ndarray  # (nnz,) int32 row ids
    keys: np.ndarray  # (nnz,) int64 sorted row*n+col keys (for lookups)
    diag: np.ndarray  # (n,) int64 position of diagonal entry

    @property
    def nnz(self) -> int:
        return self.indices.shape[0]

    def find(self, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
        """Positions of (row, col) entries; -1 where absent."""
        from goma_tpu.native import searchsorted_native

        k = rows.astype(np.int64) * self.n + cols.astype(np.int64)
        pos = searchsorted_native(self.keys, k)
        pos = np.clip(pos, 0, self.nnz - 1)
        ok = self.keys[pos] == k
        return np.where(ok, pos, -1)


def build_pattern(n_dof: int, gathers: list[np.ndarray],
                  extra_keys: np.ndarray = None) -> CSRPattern:
    """Union of element-local dense couplings over all blocks + full diagonal.
    The sort+unique over all element key cross-products is the graph-build
    hot spot at production mesh sizes; it runs in parallel C++
    (goma_tpu.native.sort_unique, reference create_graph parity)."""
    from goma_tpu.native import sort_unique

    keys_parts = [np.arange(n_dof, dtype=np.int64) * n_dof + np.arange(n_dof)]
    if extra_keys is not None and extra_keys.size:
        keys_parts.append(np.asarray(extra_keys, dtype=np.int64).ravel())
    for g in gathers:
        g64 = g.astype(np.int64)
        ne, nl = g64.shape
        rows = np.repeat(g64, nl, axis=1)  # (ne, nl*nl)
        cols = np.tile(g64, (1, nl))
        keys_parts.append((rows * n_dof + cols).ravel())
    keys = sort_unique(np.concatenate(keys_parts))
    rows = (keys // n_dof).astype(np.int32)
    cols = (keys % n_dof).astype(np.int32)
    indptr = np.zeros(n_dof + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr)
    diag_keys = np.arange(n_dof, dtype=np.int64) * (n_dof + 1)
    diag = np.searchsorted(keys, diag_keys)
    return CSRPattern(n=n_dof, indptr=indptr, indices=cols, rows=rows, keys=keys, diag=diag)


def nnz_map_for_gather(pat: CSRPattern, gather: np.ndarray) -> np.ndarray:
    """(ne, nl, nl) destination positions for a block's local Jacobians."""
    ne, nl = gather.shape
    rows = np.repeat(gather, nl, axis=1).ravel()
    cols = np.tile(gather, (1, nl)).ravel()
    pos = pat.find(rows, cols)
    if np.any(pos < 0):
        raise RuntimeError("local Jacobian entry missing from pattern")
    return pos.reshape(ne, nl, nl).astype(np.int64)


# ------------------------------------------------------------- device ops
def spmv(vals: jnp.ndarray, x: jnp.ndarray, rows: jnp.ndarray, cols: jnp.ndarray, n: int):
    """CSR (COO-layout) sparse matvec: y = A @ x."""
    return jax.ops.segment_sum(vals * x[cols], rows, num_segments=n)


class EllOperator:
    """Padded-row (ELL) sparse matvec.

    ELL stores per-row column ids and CSR-value positions padded to the
    max row degree, so y = sum_k vals[pos[:, k]] * x[cols[:, k]] is pure
    gather + elementwise + row-sum — no scatter at all. This is the SpMV the
    Krylov stack uses on device (assembly still scatters once per Newton
    iteration, which is amortized).
    """

    def __init__(self, pat: CSRPattern):
        n = pat.n
        deg = np.diff(pat.indptr)
        K = int(deg.max())
        pos = np.full((n, K), pat.nnz, dtype=np.int64)  # pad -> zero slot
        cols = np.zeros((n, K), dtype=np.int32)  # pad col 0 (value 0 anyway)
        for_r = np.arange(n)
        # vectorized fill: offsets within rows
        idx = np.repeat(for_r, deg)
        offs = np.arange(pat.nnz) - np.repeat(pat.indptr[:-1], deg)
        pos[idx, offs] = np.arange(pat.nnz)
        cols[idx, offs] = pat.indices
        self.K = K
        self.n = n
        self.tables = {"pos": jax.device_put(pos), "cols": jax.device_put(cols)}

    def matvec(self, vals, x, tb=None):
        tb = tb or self.tables
        vals_ext = jnp.concatenate([vals, jnp.zeros(1, dtype=vals.dtype)])
        ve = vals_ext[tb["pos"]]  # (n, K)
        xe = x[tb["cols"]]  # (n, K)
        return jnp.sum(ve * xe, axis=1)


def row_sums_ell(vals, pos):
    """Row sums of |A| via the ELL gather map — scatter-free.

    Gathers the values into the padded (n, K) ELL layout and reduces
    densely instead of a ``segment_sum`` scatter-add over CSR rows (which
    is faster is not measured on the GPU). ``pos`` is
    ``EllOperator.tables["pos"]`` (pad slot -> nnz, value 0)."""
    ve = jnp.concatenate([vals, jnp.zeros(1, dtype=vals.dtype)])[pos]
    return jnp.sum(jnp.abs(ve), axis=1)


def row_sum_scale(vals, R, rows, n):
    """Row-sum scaling (reference ``src/sl_matrix_util.c:442``):
    scale rows of A and R by 1/sum_j |A_ij|. Returns scaled (vals, R, scale)."""
    s = jax.ops.segment_sum(jnp.abs(vals), rows, num_segments=n)
    s = jnp.where(s > 0, s, 1.0)
    inv = 1.0 / s
    return vals * inv[rows], R * inv, inv


def sym_sum_scale(vals, rows, cols, n):
    """Symmetric equilibration s_i = 1/sqrt(sum_j |A_ij|): returns
    (vals * s[rows] * s[cols], s). The Krylov stack solves (DAD) z = D R,
    dx = D z — equilibrated like the reference's row scaling but similarity-
    preserving, so the two-level Galerkin coarse correction stays variational."""
    rs = jax.ops.segment_sum(jnp.abs(vals), rows, num_segments=n)
    s = 1.0 / jnp.sqrt(jnp.where(rs > 0, rs, 1.0))
    return vals * s[rows] * s[cols], s


def make_spmv(pat: CSRPattern):
    rows = jnp.asarray(pat.rows)
    cols = jnp.asarray(pat.indices)
    n = pat.n

    def mv(vals, x):
        return spmv(vals, x, rows, cols, n)

    return mv
