"""Padded node-slot layout for the Krylov hot path.

The compact scalar-dof gathers of the element matvec issue one row per
local dof (~2 x n_elem x n_ldof rows per A@v). Where a gather costs about
the same per ROW whatever its width, those rows dominate a preconditioned
Krylov iteration. This module reshapes the matvec around node-vector rows:

  compact v (n_dof,)
    -> vp (n_nodes, K) node rows        [contiguous slices: node-major
                                         numbering makes each node's dofs
                                         consecutive; one slice per node]
    -> qp = vp[conn] (ne, nnode, K)     [ONE row gather per element-node]
    -> yp = Jp @ qp.reshape(ne, npad)   [batched dense matmul;
                                         Jp is blockJ re-indexed into the
                                         padded layout once per Newton
                                         iteration]
    -> transpose row-gather per node    [one row per (element, local node)]
    -> compact y (n_dof,)

Row counts drop from ~2*ne*nl scalar rows to ~ne*nnode + n_nodes*melems wide
rows (the gain is not measured on the GPU).

Elemental (P0/P1E) dofs are contiguous per (slot, element) in the compact
vector, so their gather/scatter is a pure reshape. Face-kernel (DG/boundary)
contributions keep the compact path and are combined through a dedicated
transpose gather. Reference analog: this replaces the CSR SpMV inside the
reference's Krylov solvers (AztecOO/PETSc) — same operator, node-row
dataflow.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from goma_tpu.elements import element_type, interp_local_nodes


def build_padded_tables(problem):
    """Precompute the static index tables for the padded matvec.

    Returns (meta, tables): meta holds static ints (K, per-block shapes),
    tables holds numpy arrays to be device_put by the caller.
    """
    dm = problem.dofmap
    mesh = problem.mesh
    n = dm.n_dof
    n_nodes = mesh.n_nodes
    K = max(int(dm.node_dof_count.max()), 1)

    starts = np.maximum(dm.node_dof_start.astype(np.int64), 0)
    counts = dm.node_dof_count.copy()
    alias = dm.node_alias
    slaves = None
    if alias is not None:
        # periodic dof sharing: slave nodes read the ROOT's dof slice (their
        # start already points there) and must pass it through un-masked...
        slaves = np.where(alias != np.arange(n_nodes))[0]
        counts[slaves] = dm.node_dof_count[alias[slaves]]
    valid = (np.arange(K)[None, :] < counts[:, None]).astype(np.float64)

    meta = {"K": K, "blocks": []}
    tables = {
        "pl:starts": starts.astype(np.int32),
        "pl:valid": valid,
    }
    if slaves is not None and slaves.size:
        # ...and the transpose-gather sums landing on slave rows must fold
        # into the root rows before the compact dof readout (write side)
        tables["pl:slv"] = slaves.astype(np.int32)
        tables["pl:slvroot"] = alias[slaves].astype(np.int32)
        meta["has_alias"] = True
    else:
        meta["has_alias"] = False

    total_rows = 0
    row_offsets = []
    for bi, (bd, blk) in enumerate(zip(dm.blocks, mesh.blocks)):
        et = element_type(blk.elem_type)
        nnode = et.n_nodes
        ne = blk.n_elem
        nl = bd.n_ldof
        nodal_slots = [s for s in bd.slots if s.interp not in ("P0", "P1E")]
        elem_slots = [s for s in bd.slots if s.interp in ("P0", "P1E")]
        m_elem = sum(s.size for s in elem_slots)
        npad_node = nnode * K
        npad = npad_node + m_elem

        # padded col -> local dof (nl = "none"); numpy-vectorized over elements
        invmap = np.full((ne, npad), nl, dtype=np.int32)
        conn = blk.conn.astype(np.int64)
        for s in nodal_slots:
            ln_list = list(interp_local_nodes(et.family, s.interp))
            sv0 = dm.svar_offset[s.var]
            for c in range(s.ncomp):
                for j, ln in enumerate(ln_list):
                    node = conn[:, ln]
                    slotidx = (
                        dm.dof_of_node_svar[node, sv0 + c] - starts[node]
                    ).astype(np.int64)
                    cols = ln * K + slotidx
                    invmap[np.arange(ne), cols] = s.start + c * s.nbf + j
        # elemental slots: tail columns map 1:1 to local dofs; also record the
        # compact base offset of each slot (dofs are slot-major: base + e*sz+i)
        elem_meta = []
        off = npad_node
        for s in elem_slots:
            sz = s.size
            base = int(bd.gather[0, s.start])  # dof of element 0, entry 0
            invmap[:, off : off + sz] = (
                np.arange(s.start, s.start + sz, dtype=np.int32)[None, :]
            )
            elem_meta.append({"base": base, "sz": sz, "col": off})
            off += sz

        tables[f"pl:inv{bi}"] = invmap
        meta["blocks"].append(
            {"ne": ne, "nnode": nnode, "nl": nl, "npad": npad,
             "npad_node": npad_node, "elem_slots": elem_meta}
        )
        row_offsets.append(total_rows)
        total_rows += ne * nnode

    # transpose gather: per node, the flattened (block, element, local-node)
    # row positions of its contributions
    flat_nodes = np.concatenate(
        [blk.conn.astype(np.int64).ravel() for blk in mesh.blocks]
    )
    order = np.argsort(flat_nodes, kind="stable")
    sf = flat_nodes[order]
    s0 = np.searchsorted(sf, np.arange(n_nodes))
    s1 = np.searchsorted(sf, np.arange(n_nodes) + 1)
    melems = max(int((s1 - s0).max()), 1)
    tgn = np.full((n_nodes, melems), total_rows, dtype=np.int32)
    for k in range(melems):
        sel = s0 + k < s1
        tgn[sel, k] = order[(s0 + k)[sel]]
    tables["pl:tgn"] = tgn
    meta["total_rows"] = total_rows

    # compact nodal dof -> padded flat position (node*K + slot)
    nd = np.repeat(np.arange(n_nodes, dtype=np.int64), dm.node_dof_count)
    slot = np.arange(dm.n_node_dof, dtype=np.int64) - starts[nd]
    tables["pl:dofpos"] = (nd * K + slot).astype(np.int32)
    meta["n_node_dof"] = int(dm.n_node_dof)

    # face contributions: dedicated transpose gather over flattened face parts
    if problem.face_sets:
        flat_fd = np.concatenate(
            [dm.blocks[fs.block_index].gather[fs.face_elems].astype(np.int64).ravel()
             for fs in problem.face_sets]
        )
        Lf = flat_fd.shape[0]
        orderf = np.argsort(flat_fd, kind="stable")
        sff = flat_fd[orderf]
        f0 = np.searchsorted(sff, np.arange(n))
        f1 = np.searchsorted(sff, np.arange(n) + 1)
        kf = max(int((f1 - f0).max()), 1)
        tgf = np.full((n, kf), Lf, dtype=np.int32)
        for k in range(kf):
            sel = f0 + k < f1
            tgf[sel, k] = orderf[(f0 + k)[sel]]
        tables["pl:tgf"] = tgf
    return meta, tables


def pad_block_jacobians(meta, T, blockJ):
    """Re-index the per-element local Jacobians (ne, nl, nl) into the padded
    layout (ne, npad, npad) with on-device one-hot contractions (runs once
    per Newton iteration; HIGHEST precision keeps the placement exact)."""
    hi = jax.lax.Precision.HIGHEST
    out = []
    for bi, bm in enumerate(meta["blocks"]):
        J = blockJ[bi]
        nl = bm["nl"]
        inv = T[f"pl:inv{bi}"]
        S = jax.nn.one_hot(inv, nl + 1, dtype=J.dtype)[..., :nl]  # (ne,npad,nl)
        Jp = jnp.einsum("eai,eij->eaj", S, J, precision=hi)
        Jp = jnp.einsum("eaj,ebj->eab", Jp, S, precision=hi)
        out.append(Jp)
    return tuple(out)


def padded_matvec(problem, meta, T, Jp, v):
    """y = A_vol @ v in the padded layout (volume-element contributions only;
    the caller adds face parts and applies rotation/constraint/Dirichlet/scale
    post-processing in compact space)."""
    K = meta["K"]
    dtype = v.dtype
    v_ext = jnp.concatenate([v, jnp.zeros(K, dtype=dtype)])
    starts = T["pl:starts"]
    # one contiguous K-slice per node (node-major numbering)
    vp = jax.vmap(lambda s: jax.lax.dynamic_slice(v_ext, (s,), (K,)))(starts)
    vp = vp * T["pl:valid"].astype(dtype)

    flats = []
    tails = []
    for bi, bm in enumerate(meta["blocks"]):
        conn = T[f"c{bi}"]
        qp = vp[conn].reshape(bm["ne"], bm["npad_node"])  # row gather
        for es in bm["elem_slots"]:
            qe = jax.lax.dynamic_slice(v, (es["base"],), (bm["ne"] * es["sz"],))
            qp = jnp.concatenate([qp, qe.reshape(bm["ne"], es["sz"])], axis=1)
        yp = jnp.einsum("eab,eb->ea", Jp[bi], qp,
                        precision=jax.lax.Precision.HIGHEST)
        flats.append(yp[:, : bm["npad_node"]].reshape(-1, K))
        for es in bm["elem_slots"]:
            tails.append(yp[:, es["col"] : es["col"] + es["sz"]].reshape(-1))

    flat = jnp.concatenate(flats + [jnp.zeros((1, K), dtype=dtype)], axis=0)
    vp_out = jnp.sum(flat[T["pl:tgn"]], axis=1)  # (n_nodes, melems, K) -> (n_nodes, K)
    if meta.get("has_alias"):
        # periodic dof sharing: contributions accumulated at slave-node rows
        # belong to the root's dofs (boundary-sized scatter-add)
        vp_out = vp_out.at[T["pl:slvroot"]].add(vp_out[T["pl:slv"]])
    y_nodal = vp_out.reshape(-1)[T["pl:dofpos"]]
    return jnp.concatenate([y_nodal] + tails) if tails else y_nodal
