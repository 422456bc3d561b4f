"""Global unknown numbering and per-element gather tables.

Parity: reference ``src/mm_unknown_map.c`` (``set_unknown_map:758``,
``Index_Solution:5182``) and the per-element pointer gather
``src/mm_fill_ptrs.c:1136 load_elem_dofptr``.

Redesign: instead of per-element pointer lists walked at runtime,
we precompute for every block a dense int32 gather table
``gather (n_elem, n_local_dof)`` so that the entire element state for a block
is one ``x[gather]`` gather, and scatter is one ``segment_sum``. Numbering is
node-major (all active variables at a node are contiguous), which makes the
node-block-Jacobi preconditioner a trivial reshape. Elemental (P0/P1E
discontinuous) dofs are appended after all nodal dofs.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from goma_tpu.elements import element_type, interp_local_nodes, n_basis
from goma_tpu.fem.variables import Var, resolve_interp
from goma_tpu.mesh.mesh import Mesh


@dataclass(frozen=True)
class LocalSlot:
    """One (variable, interpolation) slot in a block's local dof layout."""

    var: str
    ncomp: int
    interp: str  # resolved, family-specific
    nbf: int
    start: int  # offset in local dof vector; layout [comp, bf] row-major

    @property
    def size(self) -> int:
        return self.ncomp * self.nbf


@dataclass
class BlockDofs:
    block_index: int
    elem_type: str
    slots: list[LocalSlot]
    gather: np.ndarray  # (n_elem, n_ldof) int32
    n_ldof: int
    # per-element dof sign conjugation (Nedelec edge orientation): u_local =
    # sign * u_global and R_global = sign * R_local; None when not needed
    edge_signs: np.ndarray | None = None

    def slot(self, var: str) -> LocalSlot:
        for s in self.slots:
            if s.var == var:
                return s
        raise KeyError(var)

    def has(self, var: str) -> bool:
        return any(s.var == var for s in self.slots)


@dataclass
class DofMap:
    mesh: Mesh
    vars: list[Var]  # global variable order
    svar_offset: dict[str, int]  # var name -> first scalar-variable index
    n_svar: int
    dof_of_node_svar: np.ndarray  # (n_nodes, n_svar) int32, -1 inactive
    n_node_dof: int
    n_dof: int
    blocks: list[BlockDofs]
    node_dof_start: np.ndarray  # (n_nodes,) first dof at node (-1 if none)
    node_dof_count: np.ndarray  # (n_nodes,)
    node_alias: np.ndarray | None = None  # (n_nodes,) periodic root map

    def var(self, name: str) -> Var:
        for v in self.vars:
            if v.name == name:
                return v
        raise KeyError(name)

    def svar(self, var: str, comp: int = 0) -> int:
        return self.svar_offset[var] + comp

    def node_dofs(self, var: str, nodes: np.ndarray, comp: int = 0) -> np.ndarray:
        """Global dof ids of (var, comp) at the given nodes. Drops inactive."""
        d = self.dof_of_node_svar[nodes, self.svar(var, comp)]
        return d[d >= 0].astype(np.int32)


def build_dofmap(mesh: Mesh, block_vars: list[list[tuple[str, int, str]]],
                 node_alias: np.ndarray | None = None) -> DofMap:
    """block_vars[bi] = [(var_name, ncomp, abstract_interp), ...] per mesh block.

    The per-block variable list comes from the equations active on the block
    (reference: equation activation in ``src/mm_prob_def.c`` + problem
    description). Variable order within a local element vector follows the
    global first-seen registration order.

    ``node_alias``: optional (n_nodes,) root-node map for PERIODIC
    identification (reference PERIODIC_BC, applied there as PETSc matrix
    constraints, ``src/bc_integ.c``/``sl_petsc.c``; here the paired nodes
    SHARE dofs, so residual contributions from both sides accumulate in one
    row — exactly conservative, no constraint rows, no extra nnz). Slave
    nodes (alias[n] != n) get their root's dof rows; activity is unioned
    into the root.
    """
    assert len(block_vars) == len(mesh.blocks)

    # global variable order (first seen)
    vars_list: list[Var] = []
    for bv in block_vars:
        for name, ncomp, _ in bv:
            known = [v for v in vars_list if v.name == name]
            if known:
                if known[0].ncomp != ncomp:
                    raise ValueError(f"inconsistent ncomp for {name}")
            else:
                vars_list.append(Var(name, ncomp))

    svar_offset: dict[str, int] = {}
    off = 0
    for v in vars_list:
        svar_offset[v.name] = off
        off += v.ncomp
    n_svar = off

    # nodal activity
    active = np.zeros((mesh.n_nodes, n_svar), dtype=bool)
    resolved: list[list[tuple[str, int, str]]] = []
    for bi, (blk, bv) in enumerate(zip(mesh.blocks, block_vars)):
        et = element_type(blk.elem_type)
        rbv = []
        for name, ncomp, interp in bv:
            rint = resolve_interp(et.family, interp)
            # serendipity parents carry no interior/face-center nodes: the
            # quadratic interpolation there IS the serendipity one
            # (reference: I_SP on 8-node quads, include/mm_as_const.h)
            if rint == "Q2" and et.name in ("QUAD8", "HEX20"):
                rint = "S2"
            rbv.append((name, ncomp, rint))
            if rint not in ("P0", "P1E"):
                ln = interp_local_nodes(et.family, rint)
                if max(ln) >= et.n_nodes:
                    raise ValueError(
                        f"variable '{name}': interpolation {rint} uses local "
                        f"nodes up to {max(ln)} but block '{blk.name}' has "
                        f"{et.n_nodes}-node {blk.elem_type} elements; use a "
                        f"higher-order mesh or a lower-order interpolation"
                    )
                nodes = blk.conn[:, list(ln)].ravel()
                s0 = svar_offset[name]
                active[nodes[:, None], np.arange(s0, s0 + ncomp)[None, :]] = True
        resolved.append(rbv)

    # periodic identification: union slave activity into the root node,
    # deactivate slaves, and (after numbering) point slaves at root dofs
    slaves = None
    if node_alias is not None:
        node_alias = np.asarray(node_alias, dtype=np.int64)
        slaves = np.where(node_alias != np.arange(mesh.n_nodes))[0]
        if slaves.size:
            np.logical_or.at(active, node_alias[slaves], active[slaves])
            active[slaves] = False
        else:
            slaves = None

    # node-major numbering
    counts = active.sum(axis=1)
    node_start_full = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    n_node_dof = int(node_start_full[-1])
    dof_of_node_svar = np.full((mesh.n_nodes, n_svar), -1, dtype=np.int32)
    # within a node, dofs ordered by svar index
    order = np.cumsum(active, axis=1) - 1
    dof_of_node_svar[active] = (node_start_full[:-1][:, None] + order)[active].astype(np.int32)
    if slaves is not None:
        dof_of_node_svar[slaves] = dof_of_node_svar[node_alias[slaves]]

    node_dof_start = np.where(counts > 0, node_start_full[:-1], -1).astype(np.int32)
    node_dof_count = counts.astype(np.int32)
    if slaves is not None:
        # slaves report their root's dof range start (element-connectivity
        # consumers, e.g. the padded node-slot tables, subtract it from
        # dof_of_node_svar) but count 0, so per-node block enumerations
        # (node-block Jacobi, partitioned row maps) list each shared dof once
        node_dof_start[slaves] = node_dof_start[node_alias[slaves]]

    # elemental dofs appended
    next_dof = n_node_dof
    blocks_out: list[BlockDofs] = []
    for bi, (blk, rbv) in enumerate(zip(mesh.blocks, resolved)):
        et = element_type(blk.elem_type)
        ne = blk.n_elem
        slots: list[LocalSlot] = []
        start = 0
        # order by global var registration order; dedup same-var entries
        # (several Equations may share a test space, e.g. a primary kernel
        # plus normal-mode beta-correction kernels) — they must agree on
        # the interpolation
        name_order = {v.name: i for i, v in enumerate(vars_list)}
        rbv_sorted = sorted(rbv, key=lambda t: name_order[t[0]])
        seen_interp: dict[str, str] = {}
        rbv_dedup = []
        for name, ncomp, rint in rbv_sorted:
            if name in seen_interp:
                if seen_interp[name] != rint:
                    raise ValueError(
                        f"variable '{name}' declared with conflicting "
                        f"interpolations {seen_interp[name]} vs {rint} in "
                        f"block {bi}")
                continue
            seen_interp[name] = rint
            rbv_dedup.append((name, ncomp, rint))
        for name, ncomp, rint in rbv_dedup:
            nbf = n_basis(et.family, rint, et.dim)
            slots.append(LocalSlot(name, ncomp, rint, nbf, start))
            start += ncomp * nbf
        n_ldof = start

        gather = np.empty((ne, n_ldof), dtype=np.int32)
        signs = None
        for s in slots:
            if s.interp in ("P0", "P1E"):
                sz = s.size
                base = next_dof + np.arange(ne, dtype=np.int64) * sz
                idx = base[:, None] + np.arange(sz)[None, :]
                gather[:, s.start : s.start + sz] = idx.astype(np.int32)
                next_dof += ne * sz
            else:
                if s.interp == "N1":
                    # edge-dof orientation: the GLOBAL dof is the circulation
                    # along the low->high-global-corner direction; elements
                    # whose local traversal opposes it get a -1 sign in the
                    # per-element conjugation u_local = sign * u_global
                    # (the standard H(curl) orientation fix)
                    from goma_tpu.elements.shapes import NEDELEC_EDGE_CORNERS

                    if signs is None:
                        signs = np.ones((ne, n_ldof))
                    for k, (c0, c1) in enumerate(NEDELEC_EDGE_CORNERS[et.family]):
                        flip = blk.conn[:, c0] > blk.conn[:, c1]
                        for c in range(s.ncomp):
                            signs[flip, s.start + c * s.nbf + k] = -1.0
                ln = list(interp_local_nodes(et.family, s.interp))
                nodes = blk.conn[:, ln]  # (ne, nbf)
                for c in range(s.ncomp):
                    sv = svar_offset[s.var] + c
                    cols = dof_of_node_svar[nodes, sv]
                    if np.any(cols < 0):
                        raise RuntimeError(f"inactive dof gathered: {s.var}[{c}] block {bi}")
                    gather[:, s.start + c * s.nbf : s.start + (c + 1) * s.nbf] = cols
        if signs is not None and np.all(signs == 1.0):
            signs = None  # consistently oriented mesh: no conjugation needed
        blocks_out.append(BlockDofs(bi, blk.elem_type, slots, gather, n_ldof,
                                    edge_signs=signs))

    return DofMap(
        mesh=mesh,
        vars=vars_list,
        svar_offset=svar_offset,
        n_svar=n_svar,
        dof_of_node_svar=dof_of_node_svar,
        n_node_dof=n_node_dof,
        n_dof=int(next_dof),
        blocks=blocks_out,
        node_dof_start=node_dof_start,
        node_dof_count=node_dof_count,
        node_alias=node_alias if slaves is not None else None,
    )
