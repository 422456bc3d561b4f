"""Small dense linear algebra with explicit formulas.

The isoparametric map Jacobian is (dim, dim) with dim in {1,2,3}; explicit
cofactor inverses keep the hot path elementwise (no LU lowering) and are
AD-friendly. Reference analog: ``beer_belly`` hand-codes the same inverses
(``src/mm_fill_util.c:139``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def gj_inv(A):
    """Batched Gauss-Jordan inverse with partial pivoting for small k
    (..., k, k). Works in any dtype on any backend without an LU custom
    call. All row selection uses one-hot algebra so traced loop indices are
    fine."""
    k = A.shape[-1]
    if k <= 3:
        _, inv = det_and_inv(A)
        return inv
    dtype = A.dtype
    batch = A.shape[:-2]
    eye = jnp.broadcast_to(jnp.eye(k, dtype=dtype), batch + (k, k))
    M = jnp.concatenate([A, eye], axis=-1)  # (..., k, 2k)

    def step(i, M):
        ei = (jnp.arange(k) == i).astype(dtype)  # (k,)
        ci = (jnp.arange(2 * k) == i).astype(dtype)  # (2k,)
        # partial pivot among rows >= i
        col = jnp.einsum("j,...kj->...k", ci, M)
        cand = jnp.where(jnp.arange(k) >= i, jnp.abs(col), -1.0)
        p = jnp.argmax(cand, axis=-1)  # (...,)
        ep = jax.nn.one_hot(p, k, dtype=dtype)  # (..., k)
        row_i = jnp.einsum("k,...kj->...j", ei, M)
        row_p = jnp.einsum("...k,...kj->...j", ep, M)
        # swap rows i <-> p
        M = (
            M
            + ei[:, None] * (row_p - row_i)[..., None, :]
            + ep[..., :, None] * (row_i - row_p)[..., None, :]
        )
        piv = jnp.einsum("j,...j->...", ci, row_p)
        piv = jnp.where(jnp.abs(piv) > 1e-300, piv, 1.0)
        rowi_n = row_p / piv[..., None]
        M = M + ei[:, None] * (rowi_n - row_p)[..., None, :]
        f = jnp.einsum("j,...kj->...k", ci, M) * (1.0 - ei)
        M = M - f[..., None] * rowi_n[..., None, :]
        return M

    M = jax.lax.fori_loop(0, k, step, M)
    return M[..., :, k:]


def blocked_inv(M, max_block: int = 8192):
    """Dense inverse by recursive 2x2 block (Schur-complement) partitioning:
    matrices above ``max_block`` rows recurse into LUs of at most that size
    glued by full-f32 matmuls; smaller ones are one ``jnp.linalg.inv``.

        inv([[A,B],[C,D]]) = [[Ai + Ai B Si C Ai, -Ai B Si],
                              [-Si C Ai,           Si      ]],
        S = D - C Ai B.
    """
    n = M.shape[0]
    if n <= max_block:
        return jnp.linalg.inv(M)
    # the Schur-glue matmuls MUST run at full f32: a reduced-precision
    # default (TF32 or bf16 passes) rounds at ~1e-3, which destroys the
    # block inverse (the LU inside jnp.linalg.inv is full f32 already)
    with jax.default_matmul_precision("highest"):
        k = ((n + 1) // 2 + 127) // 128 * 128  # split at a 128-aligned midpoint
        k = min(k, n - 1)
        A, B = M[:k, :k], M[:k, k:]
        C, D = M[k:, :k], M[k:, k:]
        Ai = blocked_inv(A, max_block)
        AiB = Ai @ B
        S = D - C @ AiB
        Si = blocked_inv(S, max_block)
        CAi = C @ Ai
        top_left = Ai + AiB @ (Si @ CAi)
        top_right = -(AiB @ Si)
        bot_left = -(Si @ CAi)
        return jnp.block([[top_left, top_right], [bot_left, Si]])


def saddle_split_inv(M, k, max_block: int = 8192):
    """Dense inverse of a saddle-point matrix with a known 2x2 structure:
    M = [[A, B], [C, D]] with A = M[:k,:k] the elliptic block and D the
    saddle (zero-diagonal / Lagrange-multiplier) block.

    ``blocked_inv``'s unpivoted midpoint splits are catastrophically unstable
    when a leading principal block mixes in near-singular saddle rows; here
    the first split is pinned to the elliptic/saddle boundary, so A's own
    principal minors (elliptic) are safe for further unpivoted recursion and
    S = D - C A^-1 B is the dense, well-conditioned Schur complement."""
    n = M.shape[0]
    if k <= 0 or k >= n:
        return blocked_inv(M, max_block)
    with jax.default_matmul_precision("highest"):  # see blocked_inv
        A, B = M[:k, :k], M[:k, k:]
        C, D = M[k:, :k], M[k:, k:]
        Ai = blocked_inv(A, max_block)
        AiB = Ai @ B
        S = D - C @ AiB
        Si = blocked_inv(S, max_block)
        CAi = C @ Ai
        top_left = Ai + AiB @ (Si @ CAi)
        return jnp.block([[top_left, -(AiB @ Si)], [-(Si @ CAi), Si]])


def lstsq_small(H, b):
    """Least squares min||H y - b|| for small tall H (m1, m) via normal
    equations + Gauss-Jordan (any dtype/backend, no QR custom call).
    Regularized for rank deficiency.

    Normal equations square the conditioning, so the small solve always runs
    in f64 (it is O(m^3) for m ~ restart — negligible) and casts back."""
    in_dtype = H.dtype
    H = H.astype(jnp.float64)
    b = b.astype(jnp.float64)
    m = H.shape[1]
    G = H.T @ H
    scale = jnp.trace(G) / m + 1e-300
    G = G + (1e-14 * scale) * jnp.eye(m, dtype=H.dtype)
    rhs = H.T @ b
    return (gj_inv(G) @ rhs).astype(in_dtype)


def det_and_inv(J):
    """Batched determinant + inverse for (..., d, d), d in {1, 2, 3}."""
    d = J.shape[-1]
    if d == 1:
        det = J[..., 0, 0]
        inv = (1.0 / det)[..., None, None]
        return det, inv
    if d == 2:
        a, b = J[..., 0, 0], J[..., 0, 1]
        c, e = J[..., 1, 0], J[..., 1, 1]
        det = a * e - b * c
        idet = 1.0 / det
        inv = jnp.stack(
            [
                jnp.stack([e * idet, -b * idet], axis=-1),
                jnp.stack([-c * idet, a * idet], axis=-1),
            ],
            axis=-2,
        )
        return det, inv
    if d == 3:
        a00, a01, a02 = J[..., 0, 0], J[..., 0, 1], J[..., 0, 2]
        a10, a11, a12 = J[..., 1, 0], J[..., 1, 1], J[..., 1, 2]
        a20, a21, a22 = J[..., 2, 0], J[..., 2, 1], J[..., 2, 2]
        c00 = a11 * a22 - a12 * a21
        c01 = a12 * a20 - a10 * a22
        c02 = a10 * a21 - a11 * a20
        det = a00 * c00 + a01 * c01 + a02 * c02
        idet = 1.0 / det
        c10 = a02 * a21 - a01 * a22
        c11 = a00 * a22 - a02 * a20
        c12 = a01 * a20 - a00 * a21
        c20 = a01 * a12 - a02 * a11
        c21 = a02 * a10 - a00 * a12
        c22 = a00 * a11 - a01 * a10
        inv = jnp.stack(
            [
                jnp.stack([c00 * idet, c10 * idet, c20 * idet], axis=-1),
                jnp.stack([c01 * idet, c11 * idet, c21 * idet], axis=-1),
                jnp.stack([c02 * idet, c12 * idet, c22 * idet], axis=-1),
            ],
            axis=-2,
        )
        return det, inv
    raise ValueError(d)
