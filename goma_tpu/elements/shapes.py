"""Element-type database: reference nodes, shape functions, faces.

Parity targets in the reference: ``src/el_elm_info.c`` (element database,
28 types), ``src/rf_shape.c:40 shape()`` (shape-function values/derivatives),
``include/mm_as_const.h:134-184`` (interpolation enum I_Q1/I_Q2/I_P0/I_P1...).

Design difference from the reference: shape functions are only ever evaluated
at *static* points (quadrature points, output points) on the host, producing
float64 numpy tables ``N (nq, nbf)`` / ``dN (nq, nbf, dim)`` that enter jitted
kernels as constants. There is no runtime shape-function evaluation on device.

Node ordering conventions (ours; Exodus IO permutes at the boundary):

- quad: corners CCW ``(-1,-1),(1,-1),(1,1),(-1,1)``; QUAD9 midsides 4..7 on
  edges (0-1),(1-2),(2-3),(3-0); center 8.
- tri: corners ``(0,0),(1,0),(0,1)``; TRI6 midsides 3..5 on (0-1),(1-2),(2-0).
- hex: corners 0..3 bottom CCW, 4..7 top CCW; HEX27 edges 8..11 bottom,
  12..15 top, 16..19 vertical; face centers 20..25 (z-,z+,y-,x+,y+,x-);
  center 26.
- tet: corners ``(0,0,0),(1,0,0),(0,1,0),(0,0,1)``; TET10 midsides 4..9 on
  (0-1),(1-2),(2-0),(0-3),(1-3),(2-3).

Faces are parametrized so the reference-space tangent frame gives an
*outward* normal (2D: n = (t_y, -t_x); 3D: n = t_s x t_t).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np

from goma_tpu.elements import quadrature as quad


# ---------------------------------------------------------------- 1D Lagrange
def _lag1d(c: float, order: int, x: np.ndarray) -> np.ndarray:
    """1D Lagrange basis value for node at coordinate c on [-1,1]."""
    if order == 1:
        return 0.5 * (1.0 + c * x)
    if order == 2:
        if c == -1.0:
            return 0.5 * x * (x - 1.0)
        if c == 1.0:
            return 0.5 * x * (x + 1.0)
        return 1.0 - x * x
    raise ValueError(order)


def _dlag1d(c: float, order: int, x: np.ndarray) -> np.ndarray:
    if order == 1:
        return np.full_like(x, 0.5 * c)
    if order == 2:
        if c == -1.0:
            return x - 0.5
        if c == 1.0:
            return x + 0.5
        return -2.0 * x
    raise ValueError(order)


def _tensor_eval(nodes: np.ndarray, order: int, pts: np.ndarray):
    """Tensor-product Lagrange shape functions.

    nodes: (n, dim) reference coords in {-1,0,1}^dim; pts: (nq, dim).
    Returns N (nq, n), dN (nq, n, dim).
    """
    nq, dim = pts.shape
    n = nodes.shape[0]
    vals = np.empty((nq, n, dim))
    dvals = np.empty((nq, n, dim))
    for i in range(n):
        for d in range(dim):
            vals[:, i, d] = _lag1d(nodes[i, d], order, pts[:, d])
            dvals[:, i, d] = _dlag1d(nodes[i, d], order, pts[:, d])
    N = np.prod(vals, axis=2)
    dN = np.empty((nq, n, dim))
    for d in range(dim):
        prod = dvals[:, :, d].copy()
        for e in range(dim):
            if e != d:
                prod *= vals[:, :, e]
        dN[:, :, d] = prod
    return N, dN


# ------------------------------------------------------------------ simplices
def _quad_s2(pts):
    """8-node serendipity quad (reference: I_SP / S_BIQUAD_QUAD serendipity,
    src/rf_shape.c). Nodes: 4 corners then midsides (0-1),(1-2),(2-3),(3-0)."""
    x, y = pts[:, 0], pts[:, 1]
    nq = pts.shape[0]
    N = np.empty((nq, 8))
    dN = np.empty((nq, 8, 2))
    corners = [(-1, -1), (1, -1), (1, 1), (-1, 1)]
    for i, (xi, yi) in enumerate(corners):
        N[:, i] = 0.25 * (1 + xi * x) * (1 + yi * y) * (xi * x + yi * y - 1)
        dN[:, i, 0] = 0.25 * xi * (1 + yi * y) * (2 * xi * x + yi * y)
        dN[:, i, 1] = 0.25 * yi * (1 + xi * x) * (xi * x + 2 * yi * y)
    mids = [(0, -1), (1, 0), (0, 1), (-1, 0)]
    for k, (xi, yi) in enumerate(mids):
        i = 4 + k
        if xi == 0:
            N[:, i] = 0.5 * (1 - x * x) * (1 + yi * y)
            dN[:, i, 0] = -x * (1 + yi * y)
            dN[:, i, 1] = 0.5 * yi * (1 - x * x)
        else:
            N[:, i] = 0.5 * (1 + xi * x) * (1 - y * y)
            dN[:, i, 0] = 0.5 * xi * (1 - y * y)
            dN[:, i, 1] = -y * (1 + xi * x)
    return N, dN


def _hex_s2(pts):
    """20-node serendipity hex (reference: S_TRIQUAD_HEX). Nodes: 8 corners,
    then edge midsides in the HEX27 edge order (bottom 8-11, top 12-15,
    vertical 16-19)."""
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    nq = pts.shape[0]
    N = np.empty((nq, 20))
    dN = np.empty((nq, 20, 3))
    nodes = _hex_nodes(2)[:20]
    for i, (xi, yi, zi) in enumerate(nodes):
        if i < 8:
            s = xi * x + yi * y + zi * z - 2
            N[:, i] = 0.125 * (1 + xi * x) * (1 + yi * y) * (1 + zi * z) * s
            dN[:, i, 0] = 0.125 * xi * (1 + yi * y) * (1 + zi * z) * (s + (1 + xi * x))
            dN[:, i, 1] = 0.125 * yi * (1 + xi * x) * (1 + zi * z) * (s + (1 + yi * y))
            dN[:, i, 2] = 0.125 * zi * (1 + xi * x) * (1 + yi * y) * (s + (1 + zi * z))
        elif xi == 0:
            N[:, i] = 0.25 * (1 - x * x) * (1 + yi * y) * (1 + zi * z)
            dN[:, i, 0] = -0.5 * x * (1 + yi * y) * (1 + zi * z)
            dN[:, i, 1] = 0.25 * yi * (1 - x * x) * (1 + zi * z)
            dN[:, i, 2] = 0.25 * zi * (1 - x * x) * (1 + yi * y)
        elif yi == 0:
            N[:, i] = 0.25 * (1 + xi * x) * (1 - y * y) * (1 + zi * z)
            dN[:, i, 0] = 0.25 * xi * (1 - y * y) * (1 + zi * z)
            dN[:, i, 1] = -0.5 * y * (1 + xi * x) * (1 + zi * z)
            dN[:, i, 2] = 0.25 * zi * (1 + xi * x) * (1 - y * y)
        else:
            N[:, i] = 0.25 * (1 + xi * x) * (1 + yi * y) * (1 - z * z)
            dN[:, i, 0] = 0.25 * xi * (1 + yi * y) * (1 - z * z)
            dN[:, i, 1] = 0.25 * yi * (1 + xi * x) * (1 - z * z)
            dN[:, i, 2] = -0.5 * z * (1 + xi * x) * (1 + yi * y)
    return N, dN


def eval_nedelec(family: str, pts: np.ndarray):
    """Lowest-order Nedelec (edge) vector basis on the reference element.

    Reference: I_N1 interpolation (include/mm_as_const.h) used by the
    time-harmonic EM curl-curl equations (src/mm_fill_em.c Nedelec variant,
    src/bc_integ.c:2447). One dof per edge = the tangential circulation; the
    dof is carried by the edge's midside node of the quadratic parent.

    Returns (Nvec (nq, nbf, dim), curl (nq, nbf)); 2D curl is the scalar
    z-component. Quad edge reference directions: (0->1), (1->2), (3->2),
    (0->3) — low-corner to high-corner in our structured node ordering, so
    globally consistent orientation on generator meshes.
    """
    pts = np.asarray(pts, dtype=float)
    nq = pts.shape[0]
    if family == "quad":
        x, y = pts[:, 0], pts[:, 1]
        N = np.zeros((nq, 4, 2))
        C = np.zeros((nq, 4))
        N[:, 0, 0] = (1 - y) / 4.0   # bottom, +x
        C[:, 0] = 0.25
        N[:, 1, 1] = (1 + x) / 4.0   # right, +y
        C[:, 1] = 0.25
        N[:, 2, 0] = (1 + y) / 4.0   # top, +x
        C[:, 2] = -0.25
        N[:, 3, 1] = (1 - x) / 4.0   # left, +y
        C[:, 3] = -0.25
        return N, C
    if family == "tri":
        # Whitney edge functions W_ij = L_i grad L_j - L_j grad L_i,
        # edges (0,1), (1,2), (2,0); curl = 2 (gLi x gLj)_z
        r, s = pts[:, 0], pts[:, 1]
        L = np.stack([1 - r - s, r, s], axis=1)
        gL = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
        edges = [(0, 1), (1, 2), (2, 0)]
        N = np.zeros((nq, 3, 2))
        C = np.zeros((nq, 3))
        for k, (i, j) in enumerate(edges):
            N[:, k, :] = L[:, i, None] * gL[j][None, :] - L[:, j, None] * gL[i][None, :]
            C[:, k] = 2.0 * (gL[i][0] * gL[j][1] - gL[i][1] * gL[j][0])
        return N, C
    if family == "hex":
        # 12 edge functions on [-1,1]^3: for the edge c0 -> c1 along axis a
        # with the two transverse coords fixed at signs s_b, the basis is
        #   N = d_a * prod_b (1 + s_b xi_b) / 8 * e_a   (circulation = 1)
        # and the 3D curl is returned as a VECTOR (nq, 12, 3)
        corners = np.array(
            [[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
             [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], dtype=float)
        N = np.zeros((nq, 12, 3))
        C = np.zeros((nq, 12, 3))
        for k, (i, j) in enumerate(NEDELEC_EDGE_CORNERS["hex"]):
            d = 0.5 * (corners[j] - corners[i])
            a = int(np.argmax(np.abs(d)))
            da = float(np.sign(d[a]))
            bs = [b for b in range(3) if b != a]
            s0, s1 = corners[i][bs[0]], corners[i][bs[1]]
            g = da * (1 + s0 * pts[:, bs[0]]) * (1 + s1 * pts[:, bs[1]]) / 8.0
            N[:, k, a] = g
            # curl(g e_a): (curl)_c = eps_{c b a} d g / d xi_b
            dg = np.zeros((nq, 3))
            dg[:, bs[0]] = da * s0 * (1 + s1 * pts[:, bs[1]]) / 8.0
            dg[:, bs[1]] = da * s1 * (1 + s0 * pts[:, bs[0]]) / 8.0
            ea = np.zeros(3)
            ea[a] = 1.0
            C[:, k, :] = np.cross(dg, ea[None, :])
        return N, C
    raise ValueError(f"Nedelec basis for family {family}")


# midside node carrying each edge dof (quadratic parents)
NEDELEC_EDGE_CORNERS = {
    "quad": ((0, 1), (1, 2), (3, 2), (0, 3)),
    "tri": ((0, 1), (1, 2), (2, 0)),
    # order matches the HEX20/27 midside nodes 8..19
    "hex": ((0, 1), (1, 2), (2, 3), (3, 0),
            (4, 5), (5, 6), (6, 7), (7, 4),
            (0, 4), (1, 5), (2, 6), (3, 7)),
}


def eval_hermite_bar(pts: np.ndarray):
    """Cubic Hermite basis on the reference bar xi in [-1, 1] (the
    reference's I_H3 interpolation, include/mm_as_const.h): two dofs per
    node — value and xi-slope. Order [N1, N2, M1, M2] (values then slopes).

    Returns (N (nq, 4), dN (nq, 4), d2N (nq, 4)) w.r.t. xi; the physical
    (arc-length) transform — slope basis scaled by ds/dxi, derivatives
    divided by it — happens per element in eval_curvevars."""
    xi = np.asarray(pts, dtype=float).reshape(-1)
    N = np.stack([
        0.25 * (xi - 1.0) ** 2 * (xi + 2.0),
        0.25 * (xi + 1.0) ** 2 * (2.0 - xi),
        0.25 * (xi - 1.0) ** 2 * (xi + 1.0),
        0.25 * (xi + 1.0) ** 2 * (xi - 1.0),
    ], axis=1)
    dN = np.stack([
        0.75 * (xi**2 - 1.0),
        -0.75 * (xi**2 - 1.0),
        0.25 * (3.0 * xi**2 - 2.0 * xi - 1.0),
        0.25 * (3.0 * xi**2 + 2.0 * xi - 1.0),
    ], axis=1)
    d2N = np.stack([
        1.5 * xi,
        -1.5 * xi,
        0.5 * (3.0 * xi - 1.0),
        0.5 * (3.0 * xi + 1.0),
    ], axis=1)
    return N, dN, d2N


def _tri_p1(pts):
    r, s = pts[:, 0], pts[:, 1]
    N = np.stack([1 - r - s, r, s], axis=1)
    dN = np.broadcast_to(
        np.array([[[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]]]), (pts.shape[0], 3, 2)
    ).copy()
    return N, dN


def _tri_p2(pts):
    r, s = pts[:, 0], pts[:, 1]
    L = 1 - r - s
    N = np.stack(
        [L * (2 * L - 1), r * (2 * r - 1), s * (2 * s - 1), 4 * r * L, 4 * r * s, 4 * s * L],
        axis=1,
    )
    dN = np.empty((pts.shape[0], 6, 2))
    dL = -1.0
    dN[:, 0, 0] = (4 * L - 1) * dL
    dN[:, 0, 1] = (4 * L - 1) * dL
    dN[:, 1, 0] = 4 * r - 1
    dN[:, 1, 1] = 0.0
    dN[:, 2, 0] = 0.0
    dN[:, 2, 1] = 4 * s - 1
    dN[:, 3, 0] = 4 * (L - r)
    dN[:, 3, 1] = -4 * r
    dN[:, 4, 0] = 4 * s
    dN[:, 4, 1] = 4 * r
    dN[:, 5, 0] = -4 * s
    dN[:, 5, 1] = 4 * (L - s)
    return N, dN


def _tet_p1(pts):
    r, s, t = pts[:, 0], pts[:, 1], pts[:, 2]
    N = np.stack([1 - r - s - t, r, s, t], axis=1)
    dN = np.broadcast_to(
        np.array([[[-1.0, -1.0, -1.0], [1, 0, 0], [0, 1, 0], [0, 0, 1]]], dtype=float),
        (pts.shape[0], 4, 3),
    ).copy()
    return N, dN


def _tet_p2(pts):
    r, s, t = pts[:, 0], pts[:, 1], pts[:, 2]
    L = 1 - r - s - t
    N = np.stack(
        [
            L * (2 * L - 1),
            r * (2 * r - 1),
            s * (2 * s - 1),
            t * (2 * t - 1),
            4 * r * L,
            4 * r * s,
            4 * s * L,
            4 * t * L,
            4 * r * t,
            4 * s * t,
        ],
        axis=1,
    )
    nq = pts.shape[0]
    dN = np.zeros((nq, 10, 3))
    for d, v in enumerate((r, s, t)):
        dN[:, 0, d] = -(4 * L - 1)
    dN[:, 1, 0] = 4 * r - 1
    dN[:, 2, 1] = 4 * s - 1
    dN[:, 3, 2] = 4 * t - 1
    # edge 4: 4 r L
    dN[:, 4, 0] = 4 * (L - r)
    dN[:, 4, 1] = -4 * r
    dN[:, 4, 2] = -4 * r
    # edge 5: 4 r s
    dN[:, 5, 0] = 4 * s
    dN[:, 5, 1] = 4 * r
    # edge 6: 4 s L
    dN[:, 6, 0] = -4 * s
    dN[:, 6, 1] = 4 * (L - s)
    dN[:, 6, 2] = -4 * s
    # edge 7: 4 t L
    dN[:, 7, 0] = -4 * t
    dN[:, 7, 1] = -4 * t
    dN[:, 7, 2] = 4 * (L - t)
    # edge 8: 4 r t
    dN[:, 8, 0] = 4 * t
    dN[:, 8, 2] = 4 * r
    # edge 9: 4 s t
    dN[:, 9, 1] = 4 * t
    dN[:, 9, 2] = 4 * s
    return N, dN


# ------------------------------------------------------------- ref node sets
def _quad_nodes(order):
    if order == 1:
        return np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], dtype=float)
    return np.array(
        [[-1, -1], [1, -1], [1, 1], [-1, 1], [0, -1], [1, 0], [0, 1], [-1, 0], [0, 0]],
        dtype=float,
    )


def _hex_nodes(order):
    c = np.array(
        [
            [-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
            [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1],
        ],
        dtype=float,
    )
    if order == 1:
        return c
    edges_bottom = [(0, 1), (1, 2), (2, 3), (3, 0)]
    edges_top = [(4, 5), (5, 6), (6, 7), (7, 4)]
    edges_vert = [(0, 4), (1, 5), (2, 6), (3, 7)]
    mids = [0.5 * (c[a] + c[b]) for a, b in edges_bottom + edges_top + edges_vert]
    faces = np.array(
        [[0, 0, -1], [0, 0, 1], [0, -1, 0], [1, 0, 0], [0, 1, 0], [-1, 0, 0]],
        dtype=float,
    )
    center = np.zeros((1, 3))
    return np.concatenate([c, np.array(mids), faces, center], axis=0)


@dataclass(frozen=True)
class Face:
    """One face of a reference element.

    ``corner_nodes``: parent-local node ids of the face corners (for matching
    against mesh sidesets). ``ref_map(fpts) -> epts`` maps face reference
    coords (nq, dim-1) to element reference coords (nq, dim); ``ref_jac`` is
    the constant d(elem_ref)/d(face_ref) matrix (dim, dim-1).
    """

    corner_nodes: tuple[int, ...]
    ref_origin: np.ndarray  # element ref coords of face param origin
    ref_jac: np.ndarray  # (dim, dim-1)

    def ref_map(self, fpts: np.ndarray) -> np.ndarray:
        return self.ref_origin[None, :] + fpts @ self.ref_jac.T


def _quad_faces():
    corners = _quad_nodes(1)
    faces = []
    for k in range(4):
        a, b = k, (k + 1) % 4
        origin = 0.5 * (corners[a] + corners[b])
        jac = (0.5 * (corners[b] - corners[a]))[:, None]
        faces.append(Face((a, b), origin, jac))
    return tuple(faces)


def _tri_faces():
    corners = np.array([[0, 0], [1, 0], [0, 1]], dtype=float)
    faces = []
    for k in range(3):
        a, b = k, (k + 1) % 3
        # param t in [0,1]
        origin = corners[a]
        jac = (corners[b] - corners[a])[:, None]
        faces.append(Face((a, b), origin, jac))
    return tuple(faces)


def _hex_faces():
    # (corner nodes CCW viewed from outside, s-axis corner pair, t-axis)
    c = _hex_nodes(1)
    defs = [
        (0, 3, 2, 1),  # z = -1 (outward -z)
        (4, 5, 6, 7),  # z = +1
        (0, 1, 5, 4),  # y = -1
        (1, 2, 6, 5),  # x = +1
        (2, 3, 7, 6),  # y = +1
        (3, 0, 4, 7),  # x = -1
    ]
    faces = []
    for nd in defs:
        p0, p1, p3 = c[nd[0]], c[nd[1]], c[nd[3]]
        origin = 0.25 * (c[nd[0]] + c[nd[1]] + c[nd[2]] + c[nd[3]])
        js = 0.5 * (p1 - p0)
        jt = 0.5 * (p3 - p0)
        faces.append(Face(tuple(nd), origin, np.stack([js, jt], axis=1)))
    return tuple(faces)


def _tet_faces():
    c = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=float)
    # outward-normal orientation via right-hand rule
    defs = [(0, 2, 1), (0, 1, 3), (1, 2, 3), (0, 3, 2)]
    faces = []
    for nd in defs:
        p0, p1, p2 = c[nd[0]], c[nd[1]], c[nd[2]]
        faces.append(Face(tuple(nd), p0, np.stack([p1 - p0, p2 - p0], axis=1)))
    return tuple(faces)


def _bar_faces():
    """Endpoint "faces" of a curve (BAR) element: 0-dimensional points.

    Reference analog: shell-element end BCs applied at bar endpoints
    (``src/mm_shell_bc.c`` SHELL_GRAD_* family, CAP_ENDFORCE special BCs,
    ``src/bc_special.c:77``). The face parametrization is a single dummy
    coordinate with a zero ref_jac, so ``ref_map`` collapses every
    quadrature point onto the endpoint and the affine-span node test in
    ``_face_all_nodes`` matches only the endpoint node. The outward
    direction (sign of the conormal, +-xi) is the sign of ``ref_origin``;
    the face-set builder forwards it to ``eval_surfacevars`` as "psign"."""
    return (
        Face((0,), np.array([-1.0]), np.zeros((1, 1))),
        Face((1,), np.array([+1.0]), np.zeros((1, 1))),
    )


# ---------------------------------------------------------------- main tables
@dataclass(frozen=True)
class ElementType:
    name: str
    family: str  # quad | tri | hex | tet | bar
    dim: int
    n_nodes: int
    order: int  # geometric order


_ELEMENTS: dict[str, ElementType] = {}


def _reg(name, family, dim, n_nodes, order):
    _ELEMENTS[name] = ElementType(name, family, dim, n_nodes, order)


_reg("QUAD4", "quad", 2, 4, 1)
_reg("QUAD9", "quad", 2, 9, 2)
_reg("QUAD8", "quad", 2, 8, 2)
_reg("HEX20", "hex", 3, 20, 2)
_reg("TRI3", "tri", 2, 3, 1)
_reg("TRI6", "tri", 2, 6, 2)
_reg("HEX8", "hex", 3, 8, 1)
_reg("HEX27", "hex", 3, 27, 2)
_reg("TET4", "tet", 3, 4, 1)
_reg("TET10", "tet", 3, 10, 2)
_reg("BAR2", "bar", 1, 2, 1)
_reg("BAR3", "bar", 1, 3, 2)


def element_type(name: str) -> ElementType:
    return _ELEMENTS[name]


# Interpolations: which local nodes of a parent element carry dofs, and how to
# evaluate basis functions at reference points. "Q1" on a QUAD9 parent uses
# the 4 corner nodes with bilinear functions (reference: I_Q1 on BIQUAD_QUAD).
_NODAL_INTERP_NODES = {
    ("quad", "Q1"): tuple(range(4)),
    ("quad", "Q2"): tuple(range(9)),
    ("quad", "S2"): tuple(range(8)),
    ("hex", "S2"): tuple(range(20)),
    # Nedelec edge dofs ride the midside nodes of quadratic parents
    ("quad", "N1"): (4, 5, 6, 7),
    ("tri", "N1"): (3, 4, 5),
    ("hex", "N1"): tuple(range(8, 20)),
    ("tri", "P1"): tuple(range(3)),
    ("tri", "P2"): tuple(range(6)),
    ("hex", "Q1"): tuple(range(8)),
    ("hex", "Q2"): tuple(range(27)),
    ("tet", "P1"): tuple(range(4)),
    ("tet", "P2"): tuple(range(10)),
    ("bar", "Q1"): (0, 1),
    ("bar", "Q2"): (0, 1, 2),
    # Hermite cubic: 2 dofs (value, slope) per end node; declare the var
    # with ncomp=2 (reference I_H3, include/mm_as_const.h)
    ("bar", "H3"): (0, 1),
}

# Elemental (discontinuous) interpolations: dofs live on the element, basis
# is evaluated in ref space. "P0": constant; "P1E": linear (1, xi...) monomials.
_ELEMENTAL_INTERPS = {"P0": 1, "P1E_2D": 3, "P1E_3D": 4}


def interp_local_nodes(family: str, interp: str) -> tuple[int, ...]:
    return _NODAL_INTERP_NODES[(family, interp)]


def n_basis(family: str, interp: str, dim: int) -> int:
    if interp == "P0":
        return 1
    if interp == "P1E":
        return dim + 1
    return len(_NODAL_INTERP_NODES[(family, interp)])


def eval_basis(family: str, interp: str, pts: np.ndarray):
    """Evaluate basis values/derivatives for (family, interp) at ref points.

    Returns N (nq, nbf), dN (nq, nbf, dim). For elemental interps dN is in
    reference coords too (used rarely; P0 grad = 0).
    """
    pts = np.asarray(pts, dtype=float)
    if pts.ndim == 1:
        pts = pts[:, None]
    nq, dim = pts.shape
    if interp == "P0":
        return np.ones((nq, 1)), np.zeros((nq, 1, dim))
    if interp == "P1E":
        N = np.concatenate([np.ones((nq, 1)), pts], axis=1)
        dN = np.zeros((nq, dim + 1, dim))
        for d in range(dim):
            dN[:, 1 + d, d] = 1.0
        return N, dN
    if family == "quad":
        if interp == "S2":
            return _quad_s2(pts)
        order = 1 if interp == "Q1" else 2
        return _tensor_eval(_quad_nodes(order), order, pts)
    if family == "hex":
        if interp == "S2":
            return _hex_s2(pts)
        order = 1 if interp == "Q1" else 2
        return _tensor_eval(_hex_nodes(order), order, pts)
    if family == "bar":
        order = 1 if interp == "Q1" else 2
        nodes = np.array([[-1.0], [1.0]]) if order == 1 else np.array([[-1.0], [1.0], [0.0]])
        return _tensor_eval(nodes, order, pts)
    if family == "tri":
        return _tri_p1(pts) if interp == "P1" else _tri_p2(pts)
    if family == "tet":
        return _tet_p1(pts) if interp == "P1" else _tet_p2(pts)
    raise ValueError((family, interp))


_GEOM_INTERP = {1: {"quad": "Q1", "tri": "P1", "hex": "Q1", "tet": "P1", "bar": "Q1"},
                2: {"quad": "Q2", "tri": "P2", "hex": "Q2", "tet": "P2", "bar": "Q2"}}


def geom_interp(et: ElementType) -> str:
    # serendipity elements use the serendipity basis for their geometry map
    if et.name in ("QUAD8", "HEX20"):
        return "S2"
    return _GEOM_INTERP[et.order][et.family]


def faces(family: str) -> tuple[Face, ...]:
    return {
        "quad": _quad_faces(),
        "tri": _tri_faces(),
        "hex": _hex_faces(),
        "tet": _tet_faces(),
        "bar": _bar_faces(),
    }[family]


@lru_cache(maxsize=None)
def volume_rule(family: str, npts_1d):
    """Volume quadrature rule for a family. npts_1d: Gauss order for tensor
    families; polynomial degree for simplices.

    Composite ("subgrid") rules: pass ``("subcell", n_sub, base_order)`` to
    subdivide the reference element into n_sub^dim congruent subcells with
    the base rule applied in each — the static-shape equivalent of the
    reference's level-set subgrid/subelement integration
    (``get_subelement_integration_pts``, used ``src/mm_fill.c:664-678``):
    sharp Heaviside property jumps integrate to O((h/n_sub)^2) without
    dynamic interface-fitted quadrature (which would break XLA's static
    shapes)."""
    if isinstance(npts_1d, tuple):
        tag, nsub, base = npts_1d
        assert tag == "subcell"
        pts, wts = volume_rule(family, base)
        if family in ("quad", "hex", "bar"):
            dim = {"quad": 2, "hex": 3, "bar": 1}[family]
            if pts.ndim == 1:
                pts = pts[:, None]
            h = 2.0 / nsub
            offs = [np.arange(nsub) * h - 1.0 + h / 2 for _ in range(dim)]
            grids = np.meshgrid(*offs, indexing="ij")
            centers = np.stack([g.ravel() for g in grids], axis=-1)  # (nc, dim)
            P = (centers[:, None, :] + pts[None, :, :] / nsub).reshape(-1, dim)
            W = np.tile(wts / nsub**dim, centers.shape[0])
            return P, W
        if family == "tri":
            P, W = [], []
            for i in range(nsub):
                for j in range(nsub - i):
                    v0 = np.array([i, j]) / nsub
                    e1 = np.array([1.0, 0.0]) / nsub
                    e2 = np.array([0.0, 1.0]) / nsub
                    P.append(v0 + pts[:, :1] * e1 + pts[:, 1:2] * e2)
                    W.append(wts / nsub**2)
                    if i + j < nsub - 1:  # inverted triangle
                        v0i = np.array([i + 1, j + 1]) / nsub
                        P.append(v0i - pts[:, :1] * e1 - pts[:, 1:2] * e2)
                        W.append(wts / nsub**2)
            return np.concatenate(P), np.concatenate(W)
        raise ValueError((family, npts_1d))
    if family in ("quad",):
        return quad.gauss_tensor(npts_1d, 2)
    if family == "hex":
        return quad.gauss_tensor(npts_1d, 3)
    if family == "bar":
        x, w = quad.gauss_1d(npts_1d)
        return x[:, None], w
    if family == "tri":
        return quad.tri_rule(2 * npts_1d - 1)
    if family == "tet":
        return quad.tet_rule(2 * npts_1d - 1)
    raise ValueError(family)


@lru_cache(maxsize=None)
def face_rule(family: str, npts_1d):
    """Quadrature on the face reference domain."""
    if isinstance(npts_1d, tuple):
        npts_1d = npts_1d[2]  # subcell volume rules: faces use the base rule
    if family == "bar":
        # endpoint: one dummy point (coordinate unused; ref_jac is zero),
        # unit weight — the point "measure"
        return np.zeros((1, 1)), np.ones(1)
    if family in ("quad", "tri"):
        if family == "tri":
            # edge param t in [0,1]
            x, w = quad.gauss_1d(npts_1d)
            return (0.5 * (x + 1.0))[:, None], 0.5 * w
        x, w = quad.gauss_1d(npts_1d)
        return x[:, None], w
    if family == "hex":
        return quad.gauss_tensor(npts_1d, 2)
    if family == "tet":
        # faces parametrized over unit triangle
        return quad.tri_rule(2 * npts_1d - 1)
    raise ValueError(family)
