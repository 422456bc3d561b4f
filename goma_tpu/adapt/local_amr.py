"""Indicator-driven LOCAL mesh refinement (red/green, hanging-node-free).

Parity: the reference's metric-driven local AMR
(``/root/reference/src/adapt/omega_h_interface.cpp:1325 adapt_mesh_omega_h``
— Omega_h tri/tet refinement keyed to an LS-band / error metric, with
solution transfer and problem re-setup). Redesign: refinement runs
fully on host between solves (device shapes stay static per Problem); the
classic red/green pattern on triangle meshes refines ONLY the marked
elements, closing neighbors with green bisections so no hanging nodes ever
exist — the new mesh drops into a fresh ``Problem`` and
``adapt.transfer_solution`` carries the state across (the
``resetup_problem`` analog).

Rules (Bank et al.):
- marked elements split RED: 4 similar children via edge midpoints;
- any element with >= 2 split edges is promoted to red (closure loop);
- an element with exactly 1 split edge splits GREEN: bisected toward the
  midpoint (children are never green-refined again — one adapt pass per
  call keeps quality bounded).

Supports single-block simplex meshes in 2D (TRI3/TRI6) and 3D (TET4/TET10)
— the same scope as the reference's omega_h path (OMEGA_H_SIMPLEX at mesh
dim, ``omega_h_interface.cpp:229``). Quad decks convert first via
:func:`triangulate_mesh` (QUAD4 -> TRI3, QUAD8/QUAD9 -> TRI6 reusing the
center node as the diagonal midside). Tet rules (Bey '95 red/green):
- marked tets split RED: 4 corner children + the interior octahedron cut
  into 4 along its SHORTEST diagonal (quality-preserving choice);
- closure: an element whose split-edge pattern is not {nothing, one edge,
  one complete face} is promoted to red (loop to fixpoint);
- one split edge -> GREEN bisection through the opposite edge; a fully
  split face -> 4 children toward the apex (children are never
  green-refined again — one adapt pass per call keeps quality bounded).

Nodesets and sidesets are carried over: a new midpoint node joins every
nodeset that contains both edge endpoints; sidesets are rebuilt from the
old boundary faces' node sets.
"""

from __future__ import annotations

import numpy as np

from goma_tpu.mesh.mesh import Block, Mesh, SideSet

_EDGES = ((0, 1), (1, 2), (2, 0))


_N_CORNERS = {"tri": 3, "tet": 4, "quad": 4, "hex": 8, "bar": 2}


def mark_ls_band(mesh, F: np.ndarray, band: float) -> np.ndarray:
    """Mark elements whose nodal level-set values cross zero or come within
    ``band`` of it (the reference's LS-band refinement trigger,
    omega_h_interface.cpp ls metric)."""
    from goma_tpu.elements import element_type

    blk = mesh.blocks[0]
    nc = _N_CORNERS[element_type(blk.elem_type).family]
    Fe = F[blk.conn[:, :nc]]
    return (np.abs(Fe).min(axis=1) < band) | \
        (np.sign(Fe).max(axis=1) != np.sign(Fe).min(axis=1))


def mark_top_fraction(eta: np.ndarray, frac: float = 0.2) -> np.ndarray:
    """Doerfler-style marking: the elements carrying the largest indicator
    values (top ``frac`` by count)."""
    n = eta.shape[0]
    k = max(1, int(np.ceil(frac * n)))
    thr = np.partition(eta, n - k)[n - k]
    return eta >= thr


def red_green_refine(mesh: Mesh, marked: np.ndarray) -> Mesh:
    """One red/green refinement pass of a single-block simplex mesh
    (TRI3/TRI6 in 2D, TET4/TET10 in 3D). ``marked``: (n_elem,) bool.
    Returns a NEW mesh (same element type). Quad/hex decks: convert with
    :func:`triangulate_mesh` first (2D; 3D hex decks are not yet
    convertible — mesh on tets for local AMR)."""
    assert len(mesh.blocks) == 1, "local AMR: single-block simplex meshes"
    blk = mesh.blocks[0]
    if blk.elem_type in ("TET4", "TET10"):
        return _refine_tet(mesh, marked)
    if blk.elem_type not in ("TRI3", "TRI6"):
        raise NotImplementedError(
            f"red/green refinement needs TRI3/TRI6/TET4/TET10 (got "
            f"{blk.elem_type}); quad meshes: triangulate_mesh() first")
    quadratic = blk.elem_type == "TRI6"
    conn3 = np.asarray(blk.conn[:, :3], dtype=np.int64)
    ne = conn3.shape[0]
    marked = np.asarray(marked, dtype=bool).copy()
    assert marked.shape == (ne,)

    def ekey(a, b):
        return (a, b) if a < b else (b, a)

    # closure: promote any element with >= 2 split edges to red
    red = marked.copy()
    while True:
        split = set()
        for e in np.where(red)[0]:
            c = conn3[e]
            for i, j in _EDGES:
                split.add(ekey(c[i], c[j]))
        changed = False
        for e in np.where(~red)[0]:
            c = conn3[e]
            ns = sum(ekey(c[i], c[j]) in split for i, j in _EDGES)
            if ns >= 2:
                red[e] = True
                changed = True
        if not changed:
            break

    # midpoint nodes for every split edge; a TRI6 parent's midside node
    # already sits at the midpoint — reuse it (no duplicates, no orphans)
    old_mid: dict[tuple[int, int], int] = {}
    if quadratic:
        for e in range(ne):
            c = conn3[e]
            for s, (i, j) in enumerate(_EDGES):
                old_mid[ekey(c[i], c[j])] = int(blk.conn[e, 3 + s])
    coords = [mesh.coords]
    mid: dict[tuple[int, int], int] = {}
    nxt = mesh.n_nodes
    newpts = []
    for k in sorted(split):
        if k in old_mid:
            mid[k] = old_mid[k]
            continue
        mid[k] = nxt
        newpts.append(0.5 * (mesh.coords[k[0]] + mesh.coords[k[1]]))
        nxt += 1
    if newpts:
        coords.append(np.asarray(newpts))
    coords3 = np.concatenate(coords, axis=0)

    # children (corner connectivity, parent orientation preserved)
    newconn = []
    parent = []
    for e in range(ne):
        c = conn3[e]
        ek = [ekey(c[i], c[j]) for i, j in _EDGES]
        have = [k in mid for k in ek]
        if red[e]:
            m01, m12, m20 = (mid[k] for k in ek)
            newconn += [[c[0], m01, m20], [m01, c[1], m12],
                        [m20, m12, c[2]], [m01, m12, m20]]
            parent += [e] * 4
        elif any(have):
            # green: bisect toward the single split edge's midpoint
            i = have.index(True)
            m = mid[ek[i]]
            a, b = _EDGES[i]
            opp = 3 - a - b
            newconn += [[c[a], m, c[opp]], [m, c[b], c[opp]]]
            parent += [e] * 2
        else:
            newconn.append(list(c))
            parent.append(e)
    newconn = np.asarray(newconn, dtype=np.int64)

    # elevate to TRI6: one midside node per unique edge of the new mesh;
    # surviving old edges keep their old midside node
    if quadratic:
        emap: dict[tuple[int, int], int] = {
            k: m for k, m in old_mid.items() if k not in split}
        mids = []
        conn6 = np.zeros((newconn.shape[0], 6), dtype=np.int64)
        conn6[:, :3] = newconn
        for e in range(newconn.shape[0]):
            c = newconn[e]
            for s, (i, j) in enumerate(_EDGES):
                k = ekey(c[i], c[j])
                if k not in emap:
                    emap[k] = nxt
                    mids.append(0.5 * (coords3[k[0]] + coords3[k[1]]))
                    nxt += 1
                conn6[e, 3 + s] = emap[k]
        coords_f = np.concatenate([coords3, np.asarray(mids)], axis=0) \
            if mids else coords3
        final_conn = conn6
    else:
        coords_f = coords3
        final_conn = newconn

    out = Mesh(mesh.dim, coords_f,
               [Block(blk.name, blk.elem_type,
                      final_conn.astype(np.int32), blk.material)])

    # nodesets: old members + any new node whose defining endpoints are all
    # in the set (edge midpoints of split member edges; TRI6 midsides ditto)
    node_parents: dict[int, tuple[int, int]] = {}
    for k, m in mid.items():
        node_parents[m] = k
    if quadratic:
        for k, m in emap.items():
            pa = []
            for p in k:
                pa.append(p)
            node_parents[m] = tuple(pa)

    def close_nodeset(ns: np.ndarray) -> np.ndarray:
        s = set(int(v) for v in ns)
        # iterate: midpoints of midpoints (TRI6 midsides of split halves)
        changed = True
        while changed:
            changed = False
            for m, (a, b) in node_parents.items():
                if m not in s and a in s and b in s:
                    s.add(m)
                    changed = True
        return np.asarray(sorted(s), dtype=np.int32)

    out.nodesets = {name: close_nodeset(ns)
                    for name, ns in mesh.nodesets.items()}

    # sidesets: rebuilt by face-node membership in the closed node sets,
    # restricted to faces on the new mesh boundary
    fc = final_conn[:, :3]
    facekeys = {}
    for e in range(fc.shape[0]):
        for f, (i, j) in enumerate(_EDGES):
            k = ekey(int(fc[e, i]), int(fc[e, j]))
            facekeys.setdefault(k, []).append((e, f))
    boundary = {k: v[0] for k, v in facekeys.items() if len(v) == 1}
    out.sidesets = {}
    for name, ss in mesh.sidesets.items():
        want = set(int(v) for v in close_nodeset(mesh.sideset_nodes(name)))
        elems, faces = [], []
        for (a, b), (e, f) in boundary.items():
            if a in want and b in want:
                elems.append(e)
                faces.append(f)
        out.sidesets[name] = SideSet(
            elems=np.asarray(elems, dtype=np.int32),
            faces=np.asarray(faces, dtype=np.int32))
    return out


# --------------------------------------------------------------- 3D (tet)
# library TET10 midside order (elements/shapes.py): 4..9 on these edges
_TEDGES = ((0, 1), (1, 2), (2, 0), (0, 3), (1, 3), (2, 3))
# local-edge index sets of the four faces (for the 3-split face pattern)
_TFACE_EDGES = ({0, 1, 2}, {0, 4, 3}, {2, 5, 3}, {1, 5, 4})
# face corners matching each _TFACE_EDGES entry, (corner triple, apex)
_TFACE_CORNERS = (((0, 1, 2), 3), ((0, 1, 3), 2), ((0, 2, 3), 1),
                  ((1, 2, 3), 0))
# opposite edge (disjoint vertex pair) of each local edge
_TEDGE_OPP = ((2, 3), (0, 3), (1, 3), (1, 2), (2, 0), (0, 1))
# outward-normal face definitions (elements/shapes.py _tet_faces)
_TFACES_OUT = ((0, 2, 1), (0, 1, 3), (1, 2, 3), (0, 3, 2))


def _refine_tet(mesh: Mesh, marked: np.ndarray) -> Mesh:
    """Red/green refinement of a TET4/TET10 mesh (Bey '95 rules; see module
    docstring). Children orientations are fixed to positive volume."""
    blk = mesh.blocks[0]
    quadratic = blk.elem_type == "TET10"
    conn4 = np.asarray(blk.conn[:, :4], dtype=np.int64)
    ne = conn4.shape[0]
    marked = np.asarray(marked, dtype=bool).copy()
    assert marked.shape == (ne,)

    def ekey(a, b):
        return (a, b) if a < b else (b, a)

    # closure: promote anything whose split pattern is not {0, 1 edge,
    # 1 complete face} to red
    red = marked.copy()
    while True:
        split = set()
        for e in np.where(red)[0]:
            c = conn4[e]
            for i, j in _TEDGES:
                split.add(ekey(c[i], c[j]))
        changed = False
        for e in np.where(~red)[0]:
            c = conn4[e]
            have = [ekey(c[i], c[j]) in split for (i, j) in _TEDGES]
            ns = sum(have)
            ok = ns <= 1 or (ns == 3 and any(
                all(have[le] for le in fe) for fe in _TFACE_EDGES))
            if not ok:
                red[e] = True
                changed = True
        if not changed:
            break

    # midpoint nodes; TET10 parents' midside nodes are reused
    old_mid: dict[tuple[int, int], int] = {}
    if quadratic:
        for e in range(ne):
            c = conn4[e]
            for s, (i, j) in enumerate(_TEDGES):
                old_mid[ekey(c[i], c[j])] = int(blk.conn[e, 4 + s])
    mid: dict[tuple[int, int], int] = {}
    nxt = mesh.n_nodes
    newpts = []
    for k in sorted(split):
        if k in old_mid:
            mid[k] = old_mid[k]
            continue
        mid[k] = nxt
        newpts.append(0.5 * (mesh.coords[k[0]] + mesh.coords[k[1]]))
        nxt += 1
    coords3 = (np.concatenate([mesh.coords, np.asarray(newpts)], axis=0)
               if newpts else mesh.coords.copy())

    newconn = []
    parent = []
    for e in range(ne):
        c = conn4[e]
        ek = [ekey(c[i], c[j]) for i, j in _TEDGES]
        have = [k in mid for k in ek]
        ns = sum(have)
        if red[e]:
            m = [mid[k] for k in ek]  # m01,m12,m02,m03,m13,m23
            m01, m12, m02, m03, m13, m23 = m
            newconn += [[c[0], m01, m02, m03], [m01, c[1], m12, m13],
                        [m02, m12, c[2], m23], [m03, m13, m23, c[3]]]
            # interior octahedron: cut along the shortest diagonal
            diags = ((m01, m23, (m02, m03, m13, m12)),
                     (m02, m13, (m01, m03, m23, m12)),
                     (m03, m12, (m01, m02, m23, m13)))
            dlen = [np.linalg.norm(coords3[p] - coords3[q])
                    for p, q, _ in diags]
            p, q, cyc = diags[int(np.argmin(dlen))]
            for t in range(4):
                newconn.append([p, q, cyc[t], cyc[(t + 1) % 4]])
            parent += [e] * 8
        elif ns == 1:
            # green bisection through the split edge's opposite edge
            i = have.index(True)
            m = mid[ek[i]]
            a, b = _TEDGES[i]
            cc, dd = _TEDGE_OPP[i]
            newconn += [[c[a], m, c[cc], c[dd]], [m, c[b], c[cc], c[dd]]]
            parent += [e] * 2
        elif ns == 3:
            fi = next(f for f, fe in enumerate(_TFACE_EDGES)
                      if all(have[le] for le in fe))
            (fa, fb, fc), ap = _TFACE_CORNERS[fi]
            mab = mid[ekey(c[fa], c[fb])]
            mbc = mid[ekey(c[fb], c[fc])]
            mca = mid[ekey(c[fc], c[fa])]
            d = c[ap]
            newconn += [[c[fa], mab, mca, d], [mab, c[fb], mbc, d],
                        [mca, mbc, c[fc], d], [mab, mbc, mca, d]]
            parent += [e] * 4
        else:
            newconn.append(list(c))
            parent.append(e)
    newconn = np.asarray(newconn, dtype=np.int64)
    # orientation fix: positive signed volume (library convention)
    P = coords3[newconn]
    vol = np.einsum("ei,ei->e",
                    np.cross(P[:, 1] - P[:, 0], P[:, 2] - P[:, 0]),
                    P[:, 3] - P[:, 0])
    flip = vol < 0
    if np.any(flip):
        tmp = newconn[flip, 1].copy()
        newconn[flip, 1] = newconn[flip, 2]
        newconn[flip, 2] = tmp

    # elevate to TET10
    node_parents: dict[int, tuple[int, int]] = {m: k for k, m in mid.items()}
    if quadratic:
        emap: dict[tuple[int, int], int] = {
            k: m for k, m in old_mid.items() if k not in split}
        mids = []
        conn10 = np.zeros((newconn.shape[0], 10), dtype=np.int64)
        conn10[:, :4] = newconn
        for e in range(newconn.shape[0]):
            c = newconn[e]
            for s, (i, j) in enumerate(_TEDGES):
                k = ekey(int(c[i]), int(c[j]))
                if k not in emap:
                    emap[k] = nxt
                    mids.append(0.5 * (coords3[k[0]] + coords3[k[1]]))
                    nxt += 1
                conn10[e, 4 + s] = emap[k]
        coords_f = (np.concatenate([coords3, np.asarray(mids)], axis=0)
                    if mids else coords3)
        final_conn = conn10
        for k, m in emap.items():
            node_parents.setdefault(m, k)
    else:
        coords_f = coords3
        final_conn = newconn

    out = Mesh(mesh.dim, coords_f,
               [Block(blk.name, blk.elem_type,
                      final_conn.astype(np.int32), blk.material)])

    def close_nodeset(ns: np.ndarray) -> np.ndarray:
        s = set(int(v) for v in ns)
        changed = True
        while changed:
            changed = False
            for m, (a, b) in node_parents.items():
                if m not in s and a in s and b in s:
                    s.add(m)
                    changed = True
        return np.asarray(sorted(s), dtype=np.int32)

    out.nodesets = {name: close_nodeset(ns)
                    for name, ns in mesh.nodesets.items()}

    # sidesets: boundary triangle faces whose corners all lie in the
    # closed node set, with face indices in the library's outward order
    fc = final_conn[:, :4]
    facekeys: dict[tuple, list] = {}
    for e in range(fc.shape[0]):
        for f, nd in enumerate(_TFACES_OUT):
            k = tuple(sorted(int(fc[e, i]) for i in nd))
            facekeys.setdefault(k, []).append((e, f))
    boundary = {k: v[0] for k, v in facekeys.items() if len(v) == 1}
    out.sidesets = {}
    for name, ss in mesh.sidesets.items():
        want = set(int(v) for v in close_nodeset(mesh.sideset_nodes(name)))
        elems, faces = [], []
        for k, (e, f) in boundary.items():
            if all(a in want for a in k):
                elems.append(e)
                faces.append(f)
        out.sidesets[name] = SideSet(
            elems=np.asarray(elems, dtype=np.int32),
            faces=np.asarray(faces, dtype=np.int32))
    return out


# -------------------------------------------------- quad -> tri conversion
def triangulate_mesh(mesh: Mesh) -> Mesh:
    """Convert a single-block 2D quad mesh to triangles for local AMR:
    QUAD4 -> 2x TRI3, QUAD8/QUAD9 -> 2x TRI6. The split diagonal is
    (corner0, corner2); for QUAD9 the element CENTER node is exactly the
    diagonal midpoint and is reused as its midside (no new nodes at all);
    QUAD8 adds one center node per element (serendipity value at (0,0)).
    Nodesets are unchanged (node ids are preserved); sidesets map each quad
    edge to the containing triangle's edge."""
    assert len(mesh.blocks) == 1, "triangulate_mesh: single-block meshes"
    blk = mesh.blocks[0]
    if blk.elem_type == "QUAD4":
        conn = np.asarray(blk.conn, dtype=np.int64)
        t1 = conn[:, [0, 1, 2]]
        t2 = conn[:, [0, 2, 3]]
        newconn = np.stack([t1, t2], axis=1).reshape(-1, 3)
        coords = mesh.coords.copy()
        etype = "TRI3"
        # quad edge -> (child offset, tri face)
        fmap = {0: (0, 0), 1: (0, 1), 2: (1, 1), 3: (1, 2)}
    elif blk.elem_type in ("QUAD8", "QUAD9"):
        conn = np.asarray(blk.conn, dtype=np.int64)
        ne = conn.shape[0]
        if blk.elem_type == "QUAD9":
            center = conn[:, 8]
            coords = mesh.coords.copy()
        else:
            # serendipity center: -1/4 sum(corners) + 1/2 sum(midsides)
            cpts = (-0.25 * mesh.coords[conn[:, :4]].sum(axis=1)
                    + 0.5 * mesh.coords[conn[:, 4:8]].sum(axis=1))
            center = mesh.n_nodes + np.arange(ne, dtype=np.int64)
            coords = np.concatenate([mesh.coords, cpts], axis=0)
        # TRI6 (corners a,b,c; midsides on (a,b),(b,c),(c,a))
        t1 = np.stack([conn[:, 0], conn[:, 1], conn[:, 2],
                       conn[:, 4], conn[:, 5], center], axis=1)
        t2 = np.stack([conn[:, 0], conn[:, 2], conn[:, 3],
                       center, conn[:, 6], conn[:, 7]], axis=1)
        newconn = np.stack([t1, t2], axis=1).reshape(-1, 6)
        etype = "TRI6"
        fmap = {0: (0, 0), 1: (0, 1), 2: (1, 1), 3: (1, 2)}
    else:
        raise NotImplementedError(
            f"triangulate_mesh supports QUAD4/QUAD8/QUAD9 (got "
            f"{blk.elem_type}); 3D hex decks: mesh on tets for local AMR")
    out = Mesh(mesh.dim, coords,
               [Block(blk.name, etype, newconn.astype(np.int32),
                      blk.material)])
    out.nodesets = {k: v.copy() for k, v in mesh.nodesets.items()}
    out.sidesets = {}
    for name, ss in mesh.sidesets.items():
        elems, faces = [], []
        for e, f in zip(ss.elems, ss.faces):
            off, tf = fmap[int(f)]
            elems.append(2 * int(e) + off)
            faces.append(tf)
        out.sidesets[name] = SideSet(
            elems=np.asarray(elems, dtype=np.int32),
            faces=np.asarray(faces, dtype=np.int32))
    return out
