"""Global residual + Jacobian assembly.

Parity: the reference's assembly driver ``src/mm_fill.c`` (``matrix_fill_full
:155`` element loop, ``matrix_fill:314`` per-element quadrature loop,
``load_lec:4959`` scatter) — re-designed for batched device execution:

- element loop -> ``vmap`` over all elements of a same-type block;
- quadrature loop -> batched einsums with a static qp axis;
- hand-coded ``lec->J`` -> ``jax.jacfwd`` of the per-element residual
  (has_aux trick yields residual + exact Jacobian in one pass);
- ``load_lec`` scatter-add -> ``segment_sum`` over precomputed index maps;
- Dirichlet row surgery (``src/bc_dirich.c:44``) -> masked residual
  ``R = x - x_bc`` and static row/diagonal masks on the CSR values;
- integrated boundary conditions (``src/bc_integ.c:84``) -> face kernels
  vmapped over side-set faces with per-face static basis tables.

The whole assembly is one jitted function ``assemble(x, params) -> (R, vals)``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Any, Callable

import numpy as np
import jax
import jax.numpy as jnp

from goma_tpu import config
from goma_tpu.elements import element_type, eval_basis, face_rule, faces as elem_faces, geom_interp
from goma_tpu.fem.dofmap import DofMap, build_dofmap
from goma_tpu.fem.equations import Equation, FaceKernel, SurfaceVars
from goma_tpu.fem.fields import (
    MESH_VAR,
    BlockTables,
    build_block_tables,
    eval_fieldvars,
    _unpack,
)
from goma_tpu.fem.sparsity import CSRPattern, build_pattern, nnz_map_for_gather
from goma_tpu.mesh.mesh import Mesh


def eval_surfacevars(q_e, qdot_e, X_e, ftab, fwts, slots, dim, dtype,
                     coord: str = "cartesian") -> SurfaceVars:
    """FieldVars at the quadrature points of one face of one element.

    ``ftab`` holds per-face basis tables: "Ng"/"dNg" geometric, per-interp
    "N:<interp>"/"dN:<interp>", and "refjac" (dim, dim-1). With an
    axisymmetric ``coord``, ``wdA`` carries the extra r factor (dA = r ds);
    faces on the axis r=0 correctly get zero area.
    """
    u = _unpack(q_e, slots)
    udot = _unpack(qdot_e, slots)
    Xc = X_e
    if MESH_VAR in u:
        Xc = X_e + u[MESH_VAR].T

    from goma_tpu.utils.la import det_and_inv

    Ng, dNg = ftab["Ng"], ftab["dNg"]
    Jmat = jnp.einsum("qnd,nk->qkd", dNg, Xc)

    if "psign" in ftab:
        # bar-endpoint point "face" of a curve (shell) element embedded in
        # 2D: the measure is a unit point mass, the outward "normal" is the
        # signed unit tangent of the curve at the endpoint (conormal), and
        # field gradients are tangential (src/mm_shell_bc.c SHELL_GRAD_*
        # endpoint BC analog).
        tvec = Jmat[:, :, 0]  # dX/dxi (nq=1, 2)
        arclen = jnp.sqrt(jnp.sum(tvec**2, axis=1) + 1e-300)
        that = tvec / arclen[:, None]
        fv = SurfaceVars()
        fv.dim = dim
        fv.normal = ftab["psign"] * that
        fv.wdA = fwts
        fv.detJ = arclen
        fv.h_elem = arclen
        fv.tangents = that[:, :, None]
        # tangential pseudo-inverse: gphi = dN/dxi * t_hat / |dX/dxi|
        fv.invJ = (that / arclen[:, None])[:, None, :]  # (nq, 1, dim)
        fv.x = jnp.einsum("qn,nk->qk", Ng, Xc)
        if coord in ("cylindrical", "swirling"):
            fv.coord = coord
            r = fv.x[:, 1]
            fv.r = jnp.where(jnp.abs(r) < 1e-30, 1.0, r)
            fv.wdA = fv.wdA * fv.x[:, 1]
        gphi_cache = {}
        for s in slots:
            if f"N:{s.interp}" not in ftab:
                continue  # N1 / H3 traces unsupported on point faces
            Ni = ftab[f"N:{s.interp}"]
            dNi = ftab[f"dN:{s.interp}"]
            if s.interp not in gphi_cache:
                gphi_cache[s.interp] = jnp.einsum("qnd,qdk->qnk", dNi, fv.invJ)
            gp = gphi_cache[s.interp]
            fv.phi[s.var] = Ni
            fv.gphi[s.var] = gp
            fv.val[s.var] = jnp.einsum("qn,cn->qc", Ni, u[s.var])
            fv.grad[s.var] = jnp.einsum("qnk,cn->qck", gp, u[s.var])
            fv.dot[s.var] = jnp.einsum("qn,cn->qc", Ni, udot[s.var])
        return fv

    detJ, invJ = det_and_inv(Jmat)
    T = jnp.einsum("qkd,dm->qkm", Jmat, ftab["refjac"])

    fv = SurfaceVars()
    fv.dim = dim
    fv.invJ = invJ
    fv.tangents = T
    if dim == 2:
        t = T[:, :, 0]
        mag = jnp.linalg.norm(t, axis=1)
        fv.normal = jnp.stack([t[:, 1], -t[:, 0]], axis=1) / mag[:, None]
        fv.wdA = fwts * mag
    else:
        cr = jnp.cross(T[:, :, 0], T[:, :, 1])
        mag = jnp.linalg.norm(cr, axis=1)
        fv.normal = cr / mag[:, None]
        fv.wdA = fwts * mag
    fv.x = jnp.einsum("qn,nk->qk", Ng, Xc)
    fv.detJ = detJ
    fv.h_elem = 2.0 * jnp.abs(fv.detJ) ** (1.0 / dim)
    if coord in ("cylindrical", "swirling"):
        fv.coord = coord
        r = fv.x[:, 1]
        fv.r = jnp.where(jnp.abs(r) < 1e-30, 1.0, r)
        fv.wdA = fv.wdA * fv.x[:, 1]

    gphi_cache = {}
    for s in slots:
        Ni = ftab[f"N:{s.interp}"]
        dNi = ftab[f"dN:{s.interp}"]
        if s.interp not in gphi_cache:
            gphi_cache[s.interp] = jnp.einsum("qnd,qdk->qnk", dNi, invJ)
        gp = gphi_cache[s.interp]
        fv.phi[s.var] = Ni
        fv.gphi[s.var] = gp
        fv.val[s.var] = jnp.einsum("qn,cn->qc", Ni, u[s.var])
        fv.grad[s.var] = jnp.einsum("qnk,cn->qck", gp, u[s.var])
        fv.dot[s.var] = jnp.einsum("qn,cn->qc", Ni, udot[s.var])
    return fv


@dataclass
class _FaceSet:
    block_index: int
    kernels: list[FaceKernel]
    face_elems: np.ndarray  # (nf,) local element ids within block
    ftabs: dict[str, np.ndarray]  # stacked per-face tables (nf, ...)
    fwts: np.ndarray  # (nqf,)
    name: str = ""


@dataclass
class _IfcSet:
    """Paired-face interface set (cross-block coupling)."""

    block_a: int
    block_b: int
    kernels: list
    elems_a: np.ndarray  # (np,)
    elems_b: np.ndarray
    ftabs_a: dict[str, np.ndarray]
    ftabs_b: dict[str, np.ndarray]
    fwts: np.ndarray
    gather_ab: np.ndarray  # (np, nla + nlb) combined dof gather
    nla: int


@dataclass
class _OvsSet:
    """Overset (fictitious-domain) coupling set: one row per immersed-curve
    quadrature point, pairing the bar element carrying the Lagrange
    multiplier with the background (fluid) element containing the point.
    Reference: src/bc_contact.c overlapping-grid contact."""

    bar_block: int
    fluid_block: int
    kernels: list
    gather: np.ndarray  # (nr, nlb + nlf [+ nls]) combined dof gather
    nlb: int
    xq: np.ndarray  # (nr, dim) physical points
    wq: np.ndarray  # (nr,) arc-length quadrature weights
    Nf: dict[str, np.ndarray]  # fluid interp -> (nr, nbf) basis at the point
    # optional solid side (two-way FSI): parent-element basis at the points
    solid_block: int = -1
    nlf: int = 0
    Ns: dict[str, np.ndarray] = None  # solid interp -> (nr, nbf)


class Problem:
    """A coupled multiphysics problem on a mesh.

    Parity: plays the role of the reference's problem-description + setup
    (``src/rf_setup_problem.c:194``) and the assembly driver. Usage:

        prob = Problem(mesh, equations=[...], materials={...})
        prob.add_dirichlet("top", "velocity", 0, 1.0)
        prob.add_face_kernel("free_surface", CapillaryBC(...))
        prob.finalize()
        R, vals = prob.assemble(x, prob.base_params())
    """

    def __init__(
        self,
        mesh: Mesh,
        equations,
        materials=None,
        quad_order: int = 3,
        dtype=None,
        external_fields: tuple[str, ...] = (),
        coord: str = "cartesian",
    ):
        """``external_fields`` declares frozen nodal fields (reference:
        External_Field_Variables, include/mm_as_structs.h:1046) supplied at
        solve time as params["ext_<name>"] arrays over mesh nodes and exposed
        to kernels as fv.ext / fv.ext_grad.

        ``coord``: "cartesian" (default) | "cylindrical" | "swirling" —
        axisymmetric coordinates q = [z, r] with dV = r dr dz and hoop terms
        in vector kernels (reference CoordinateSystem card +
        load_coordinate_scales, src/mm_fill_aux.c:127)."""
        if coord not in ("cartesian", "cylindrical", "swirling"):
            raise ValueError(f"unknown coordinate system {coord!r}")
        self.coord = coord
        self.external_fields = tuple(external_fields)
        self.mesh = mesh
        if equations and isinstance(equations[0], Equation):
            equations = [list(equations) for _ in mesh.blocks]
        self.equations: list[list[Equation]] = equations
        if materials is None:
            materials = {}
        if isinstance(materials, dict):
            materials = [materials for _ in mesh.blocks]
        self.materials: list[dict] = materials
        self.quad_order = quad_order
        self._dtype = dtype
        self._dirichlet: list[tuple[str, str, int, Any]] = []
        self._face_sets: list[tuple[str, FaceKernel]] = []
        self._rot_specs: list = []
        self._rot_constraints: list = []
        self._point_specs: list = []
        self._periodic_specs: list = []
        self._point_load_specs: list = []
        self._edge_specs: list = []
        self._ifc_specs: list = []
        self._ovs_specs: list = []
        self._inject_specs: list = []
        self._inject = None
        self._devcache: dict = {}
        self._devcache_keep: list = []
        # optional lower-precision Jacobian (mixed-precision Newton-Krylov);
        # None = same as working dtype
        self.jacobian_dtype = None
        # fused hand-derived element kernels (fem/fastns.py) where a block
        # matches a recognized fast form; set False to force the generic AD
        # path everywhere (e.g. to cross-validate)
        self.enable_fast_kernels = True
        self._finalized = False

    @property
    def dtype(self):
        return self._dtype or config.fp_dtype()

    def _build_tables(self):
        """Device-resident static tables, passed to jitted code as an explicit
        pytree argument (params["_tables"]). Any array captured by closure is
        inlined into the lowered module as a dense literal — multi-MB
        modules, and literals defeat compile caching."""
        dt = self.dtype
        dev = jax.device_put
        T = {}
        for bi, (bd, blk) in enumerate(zip(self.dofmap.blocks, self.mesh.blocks)):
            T[f"g{bi}"] = dev(bd.gather.astype(np.int32))
            T[f"x{bi}"] = dev(self.mesh.coords[blk.conn].astype(dt))
            T[f"n{bi}"] = dev(self._nnz_maps[bi])
            T[f"c{bi}"] = dev(blk.conn.astype(np.int32))
            if bd.edge_signs is not None:
                T[f"sg{bi}"] = dev(bd.edge_signs.astype(dt))
        for j, fs in enumerate(self.face_sets):
            bd = self.dofmap.blocks[fs.block_index]
            blk = self.mesh.blocks[fs.block_index]
            T[f"fg{j}"] = dev(bd.gather[fs.face_elems].astype(np.int32))
            T[f"fx{j}"] = dev(self.mesh.coords[blk.conn[fs.face_elems]].astype(dt))
            T[f"fn{j}"] = dev(self._nnz_maps[fs.block_index][fs.face_elems])
            for k, v in fs.ftabs.items():
                T[f"ft{j}:{k}"] = dev(np.asarray(v).astype(dt))
        for j, es in enumerate(getattr(self, "edge_sets", [])):
            bd = self.dofmap.blocks[es.block_index]
            blk = self.mesh.blocks[es.block_index]
            T[f"eg{j}"] = dev(bd.gather[es.edge_elems].astype(np.int32))
            T[f"ex{j}"] = dev(self.mesh.coords[blk.conn[es.edge_elems]].astype(dt))
            T[f"en{j}"] = dev(self._nnz_maps[es.block_index][es.edge_elems])
            for k, v in es.etabs.items():
                T[f"et{j}:{k}"] = dev(np.asarray(v).astype(dt))
        for j, s in enumerate(self.ifc_sets):
            T[f"ig{j}"] = dev(s.gather_ab.astype(np.int32))
            T[f"ixa{j}"] = dev(self.mesh.coords[
                self.mesh.blocks[s.block_a].conn[s.elems_a]].astype(dt))
            T[f"ixb{j}"] = dev(self.mesh.coords[
                self.mesh.blocks[s.block_b].conn[s.elems_b]].astype(dt))
            T[f"in{j}"] = dev(self._ifc_nnz[j])
            for k, v in s.ftabs_a.items():
                T[f"ita{j}:{k}"] = dev(np.asarray(v).astype(dt))
            for k, v in s.ftabs_b.items():
                T[f"itb{j}:{k}"] = dev(np.asarray(v).astype(dt))
        for j, s in enumerate(self.ovs_sets):
            T[f"og{j}"] = dev(s.gather.astype(np.int32))
            T[f"ox{j}"] = dev(s.xq.astype(dt))
            T[f"ow{j}"] = dev(s.wq.astype(dt))
            T[f"on{j}"] = dev(self._ovs_nnz[j])
            for k, v in s.Nf.items():
                T[f"oN{j}:{k}"] = dev(np.asarray(v).astype(dt))
            for k, v in (s.Ns or {}).items():
                T[f"oNs{j}:{k}"] = dev(np.asarray(v).astype(dt))
        # fused fast-path element kernels (see fem/fastns.py): geometry
        # tables laid out element-last (element axis innermost)
        for bi, meta in getattr(self, "_fast_meta", {}).items():
            if meta is None:
                continue
            from goma_tpu.fem import fastns

            tabs, static = fastns.build_tables(self, bi)
            self._fast_static[bi] = static
            for k, a in tabs.items():
                T[f"{k}{bi}"] = dev(a.astype(dt))
                if np.dtype(dt) == np.float64:
                    # pre-cast f32 copy for the mixed-precision Jacobian
                    # passes: casting the (nl, nl, ne) Kfix stream inside
                    # the per-iteration jit dominates the assembly bucket
                    # (see fastns.select_tables)
                    T[f"{k}32:{bi}"] = dev(a.astype(np.float32))
            ng = fastns.build_node_gather(self, bi)
            if ng is not None:
                T[f"fns:gnode{bi}"] = dev(ng[0])
                T[f"fns:gp{bi}"] = dev(ng[1])
        T["tg"] = dev(self._tgather_pos)
        T["nnztg"] = dev(self._nnz_tgather)
        T["dirmask"] = dev(self._dir_mask)
        T["dirdofs"] = dev(self.dirichlet_dofs)
        T["dirkeep"] = dev(self._dir_nnz_keep.astype(dt))
        T["dirdiag"] = dev(self._dir_diag_pos)
        rd = self._rotation
        if rd is not None:
            T["rQ"] = dev(rd.Q.astype(dt))
            T["rpos"] = dev(rd.pos)
            T["rnode"] = dev(rd.entry_node)
            T["rdofs"] = dev(rd.dofs)
            if rd.con_rows.size:
                T["rcrow"] = dev(rd.con_rows)
                T["rcoef"] = dev(rd.con_coeff.astype(dt))
                T["rcdofs"] = dev(rd.con_dofs)
                T["rczero"] = dev(np.concatenate(rd.con_row_mask_pos))
                T["rcepos"] = dev(rd.con_entry_pos)
        for k, pc in enumerate(self._point_sets):
            T[f"pc{k}:rows"] = dev(pc.rows)
            T[f"pc{k}:dofs"] = dev(pc.dofs)
            T[f"pc{k}:coords"] = dev(pc.coords.astype(dt))
            T[f"pc{k}:epos"] = dev(pc.entry_pos)
            T[f"pc{k}:zero"] = dev(pc.zero_pos)
        for k, pl in enumerate(self._point_loads):
            T[f"pld{k}:rows"] = dev(pl.rows)
            T[f"pld{k}:dofs"] = dev(pl.dofs)
            T[f"pld{k}:coords"] = dev(pl.coords.astype(dt))
            T[f"pld{k}:epos"] = dev(pl.entry_pos)
        self._tables = T

    def _tb(self, params):
        t = params.get("_tables") if isinstance(params, dict) else None
        return t if t is not None else self._tables

    def add_dirichlet(self, nodeset: str, var: str, comp: int, value):
        """Strong Dirichlet on a node set. ``value``: scalar or callable
        f(coords (n, dim)) -> (n,). Reference: DX/DY/UVW cards ->
        ``put_dirichlet_in_matrix`` (``src/bc_dirich.c:44``)."""
        self._dirichlet.append((nodeset, var, comp, value))

    def add_face_kernel(self, sideset: str, kernel: FaceKernel):
        self._face_sets.append((sideset, kernel))

    def add_interface_kernel(self, pairs, kernel):
        """Cross-block interface term over the paired faces (see
        goma_tpu.mesh.interface.find_interface_faces / split_interface).
        Reference: interfacial sources between discontinuous variables,
        src/mm_interface.c."""
        self._ifc_specs.append((pairs, kernel))

    def add_edge_kernel(self, sideset_a: str, sideset_b: str, kernel):
        """Integrated BC on the 3D curve where two sidesets intersect
        (reference: bc_curve.c apply_integrated_curve_bc, e.g.
        VELO_TANGENT_EDGE). ``kernel``: an EdgeKernel (bc/edge.py)."""
        self._edge_specs.append((sideset_a, sideset_b, kernel))

    def add_rotation(self, sidesets, var: str):
        """Rotate the nodal equations of ``var`` into normal-tangent frames
        on the given sideset(s) (reference: auto-rotation,
        src/bc/rotate_coordinates.c:707)."""
        if isinstance(sidesets, str):
            sidesets = (sidesets,)
        self._rot_specs.append((tuple(sidesets), var))

    def add_rotated_dirichlet(self, sidesets, var: str, direction: str = "normal",
                              value=0.0):
        """Replace the rotated equation in ``direction`` ("normal",
        "tangent", "tangent2") with the strong constraint q.x = value, where
        q is the corresponding frame row (e.g. n.u = 0 slip).
        Implies rotation of var on those sidesets."""
        if isinstance(sidesets, str):
            sidesets = (sidesets,)
        d = {"normal": 0, "tangent": 1, "tangent2": 2}[direction]
        self._rot_constraints.append((tuple(sidesets), var, d, value))

    def add_point_constraint(self, nodeset, var: str, replace_comp: int, g):
        """Collocated nodal constraint g(q, X0, params)=0 replacing the
        ``replace_comp`` equation row of ``var`` at each node (reference
        bc_colloc.c; geometry helpers in goma_tpu.bc.pointwise)."""
        self._point_specs.append((nodeset, var, replace_comp, g))

    def add_row_inject(self, nodeset, from_var: str, to_var: str,
                       from_comp: int = 0, to_comp: int = 0,
                       sign: float = 1.0):
        """Add ``sign`` times the assembled residual/Jacobian row of
        ``from_var`` into the row of ``to_var`` at each node of ``nodeset``
        — the reference's cross-equation row moves
        (``src/mm_shell_bc.c:1743 put_lub_flux_in_film``,
        ``src/bc_colloc.c put_liquid_stress_in_solid``): flux/traction
        continuity by transferring one equation's natural boundary content
        into another's. Typically paired with a point constraint replacing
        the ``from_var`` row (e.g. the LUBP_SH_FP_MATCH pressure tie).
        Injection happens before rotations/point constraints/Dirichlet;
        the element-matvec fast path is disabled (CSR operator used)."""
        self._inject_specs.append(
            (nodeset, from_var, to_var, from_comp, to_comp, sign))

    def add_overset(self, bar_block, fluid_block, kernel, quad_order=None,
                    solid=None):
        """Overset (fictitious-domain) coupling between an immersed BAR
        block (carrying the P0 Lagrange-multiplier variable, see
        ``goma_tpu.physics.overset``) and a background block. At every
        immersed-curve quadrature point the containing background element is
        located on the host (kd-tree + isoparametric inversion) and the
        kernel ties the background field there to the boundary motion.
        Reference: overlapping-grid contact, ``src/bc_contact.c:79``;
        multiplier bookkeeping ``src/mm_augc_util.c:2914``. ``quad_order=1``
        collocates one multiplier constraint at each segment midpoint (the
        reference's one-AC-per-quadrature-point choice); higher orders
        enforce segment averages (mortar sense, default: problem order).

        ``solid=(solid_block, sideset)`` enables TWO-WAY coupling (the
        BAAIJENS_SOLID_FLUID pair): the bar block must have been built by
        ``attach_shell_block(mesh, sideset)`` so bar element i is sideset
        face i; the solid parent element's dofs join the combined gather and
        the kernel may return a third contribution dict for the solid rows."""
        self._ovs_specs.append((bar_block, fluid_block, kernel, quad_order,
                                solid))

    def add_periodic(self, nodeset_a: str, nodeset_b: str, translation=None,
                     tol: float = 1e-8):
        """PERIODIC_BC (reference ``include/rf_bc_const.h`` PERIODIC_BC,
        realized there through PETSc constraint rows): identify every node
        of ``nodeset_b`` with its image in ``nodeset_a`` under
        ``x_b = x_a + translation``. The paired nodes SHARE dofs — all
        variables active at both — so periodicity is exact, conservative,
        and adds no constraint rows or sparsity. ``translation`` (dim,)
        defaults to the mean offset between the two sets. Pairs are matched
        by nearest image point; a mismatch beyond ``tol`` (relative to the
        mesh extent) raises."""
        self._periodic_specs.append((nodeset_a, nodeset_b, translation, tol))

    def _periodic_alias(self):
        """Root-node map from the registered periodic identifications
        (union-find so doubly-periodic corners chain correctly)."""
        if not self._periodic_specs:
            return None
        mesh = self.mesh
        root = np.arange(mesh.n_nodes, dtype=np.int64)

        def find(i):
            while root[i] != i:
                root[i] = root[root[i]]
                i = root[i]
            return i

        scale = float(np.max(np.ptp(mesh.coords, axis=0)))
        for ns_a, ns_b, tr, tol in self._periodic_specs:
            a = np.asarray(mesh.nodesets[ns_a], dtype=np.int64)
            b = np.asarray(mesh.nodesets[ns_b], dtype=np.int64)
            if a.size != b.size:
                raise ValueError(
                    f"periodic sets '{ns_a}' ({a.size}) and '{ns_b}' "
                    f"({b.size}) differ in size")
            ca, cb = mesh.coords[a], mesh.coords[b]
            t = (np.mean(cb, axis=0) - np.mean(ca, axis=0)
                 if tr is None else np.asarray(tr, dtype=float))
            from scipy.spatial import cKDTree

            d, j = cKDTree(cb).query(ca + t[None, :])
            if np.max(d) > tol * max(scale, 1.0) or \
                    len(np.unique(j)) != a.size:
                raise ValueError(
                    f"periodic match '{ns_a}'->'{ns_b}' failed: max image "
                    f"distance {np.max(d):.3e} (tol {tol * max(scale, 1.0):.1e})"
                    " or non-bijective pairing; pass an explicit translation")
            for m, s in zip(a, b[j]):
                rm, rs = find(int(m)), find(int(s))
                if rm != rs:
                    root[max(rm, rs)] = min(rm, rs)
        for i in range(mesh.n_nodes):
            find(i)
        return root

    def add_point_load(self, nodeset, var: str, f, source_vars=None):
        """Additive weak nodal term (reference "special" BCs,
        ``src/bc_special.c:77``): ``f(q, X0, params) -> (ncomp(var),)`` is
        ADDED to the residual rows of ``var`` at each node of the set, with
        its row Jacobian from AD. ``q`` concatenates the components of
        ``source_vars`` (default ``[var]``) at the node. Used for
        contact-line / surface-tension endpoint forces (CAP_ENDFORCE, CA) and
        point sources."""
        self._point_load_specs.append((nodeset, var, source_vars, f))

    # ------------------------------------------------------------- finalize
    def finalize(self):
        mesh = self.mesh
        block_vars = [
            [(eq.var, eq.ncomp, eq.interp) for eq in eqs] for eqs in self.equations
        ]
        self.dofmap: DofMap = build_dofmap(
            mesh, block_vars, node_alias=self._periodic_alias())
        # interface (paired-face) sets add cross-block couplings to the graph
        self.ifc_sets: list[_IfcSet] = self._build_interface_sets()
        # overset (fictitious-domain) couplings likewise
        self.ovs_sets: list[_OvsSet] = self._build_overset_sets()
        # row-inject pairs (add_row_inject): resolve (from_row, to_row) and
        # widen the graph so the to_row holds every from_row column. Two
        # passes: the base pattern fixes the from-rows' column sets, then
        # explicit (to_row, col) keys are unioned in (exact — no spurious
        # fill; injection chains from->to->... are rejected)
        inj_pairs: list[tuple[int, int, float]] = []
        for (nodeset, fvar, tvar, fc, tc, sg) in self._inject_specs:
            nodes = mesh.nodesets[nodeset] if isinstance(nodeset, str) \
                else np.asarray(nodeset)
            for node in np.sort(np.asarray(nodes)):
                fr = int(self.dofmap.dof_of_node_svar[
                    node, self.dofmap.svar(fvar, fc)])
                tr = int(self.dofmap.dof_of_node_svar[
                    node, self.dofmap.svar(tvar, tc)])
                if fr < 0 or tr < 0:
                    continue
                inj_pairs.append((fr, tr, float(sg)))
        base_gathers = (
            [b.gather for b in self.dofmap.blocks]
            + [s.gather_ab for s in self.ifc_sets]
            + [s.gather for s in self.ovs_sets]
        )
        extra_keys = None
        if inj_pairs:
            frs = {p[0] for p in inj_pairs}
            trs = {p[1] for p in inj_pairs}
            if frs & trs:
                raise NotImplementedError(
                    "chained row injections (a to-row is also a from-row) "
                    "are not supported")
            pat0 = build_pattern(self.dofmap.n_dof, base_gathers)
            n64 = np.int64(self.dofmap.n_dof)
            keys = []
            for fr, tr, _ in inj_pairs:
                cols = pat0.indices[pat0.indptr[fr]:pat0.indptr[fr + 1]]
                keys.append(np.int64(tr) * n64 + cols.astype(np.int64))
                # the mutual entries: (to, from) for the injection itself and
                # (from, to) for a replacing cross-variable point constraint
                # (e.g. the LUBP_SH_FP_MATCH pressure tie on the from row)
                keys.append(np.array([np.int64(tr) * n64 + fr,
                                      np.int64(fr) * n64 + tr]))
            extra_keys = np.concatenate(keys)
        self.pattern: CSRPattern = build_pattern(
            self.dofmap.n_dof, base_gathers, extra_keys=extra_keys)
        if inj_pairs:
            fp_l, tp_l, ps_l = [], [], []
            for fr, tr, sg in inj_pairs:
                p0, p1 = int(self.pattern.indptr[fr]), int(self.pattern.indptr[fr + 1])
                fp = np.arange(p0, p1, dtype=np.int64)
                cols = self.pattern.indices[p0:p1]
                tp = self.pattern.find(np.full(cols.shape, tr), cols)
                if np.any(tp < 0):
                    raise RuntimeError("row-inject target entries missing")
                fp_l.append(fp)
                tp_l.append(tp)
                ps_l.append(np.full(fp.shape, sg))
            self._inject = {
                "from_rows": np.array([p[0] for p in inj_pairs]),
                "to_rows": np.array([p[1] for p in inj_pairs]),
                "sign_rows": np.array([p[2] for p in inj_pairs]),
                "from_pos": np.concatenate(fp_l),
                "to_pos": np.concatenate(tp_l),
                "sign_pos": np.concatenate(ps_l),
            }
        self._nnz_maps = [nnz_map_for_gather(self.pattern, b.gather) for b in self.dofmap.blocks]
        self._ifc_nnz = [nnz_map_for_gather(self.pattern, s.gather_ab) for s in self.ifc_sets]
        self._ovs_nnz = [nnz_map_for_gather(self.pattern, s.gather) for s in self.ovs_sets]

        # volume tables
        self.tables: list[BlockTables] = []
        for bd, blk in zip(self.dofmap.blocks, mesh.blocks):
            interps = {s.interp for s in bd.slots}
            self.tables.append(build_block_tables(blk.elem_type, interps, self.quad_order))

        # Dirichlet arrays. A value may be:
        #   scalar                      -> static
        #   f(coords)                   -> static, position dependent
        #   f(coords, params) [2 args]  -> parametric: re-evaluated (traced)
        #     inside assembly, so continuation/AC parameters can drive BCs
        #     (reference: update_parameterAC BC path, src/ac_update_parameter.c)
        import inspect
        import warnings

        # BC duplicate-resolution log (the reference's -bc_dup diagnostic
        # output, src/mm_bc_conflict.c check_for_bc_conflicts2D/3D): every
        # precedence decision made while finalizing strong conditions is
        # recorded here; see bc_dup_report().
        self.bc_dup_log: list[dict] = []

        dofs, vals = [], []
        param_specs = []  # (spec slice start, d, x, fn) before dedup
        for nodeset, var, comp, value in self._dirichlet:
            if nodeset.startswith("sideset:"):
                nodes = mesh.sideset_nodes(nodeset.split(":", 1)[1])
            else:
                nodes = mesh.nodesets[nodeset]
            d = self.dofmap.dof_of_node_svar[nodes, self.dofmap.svar(var, comp)]
            ok = d >= 0
            d = d[ok]
            x = mesh.coords[nodes[ok]]
            if callable(value) and len(inspect.signature(value).parameters) >= 2:
                start = sum(a.shape[0] for a in dofs)
                param_specs.append((start, d.astype(np.int64), x, value))
                v = np.full(d.shape, np.nan)  # placeholder; set at assembly
            else:
                v = value(x) if callable(value) else np.full(d.shape, float(value))
            dofs.append(d)
            vals.append(np.asarray(v, dtype=np.float64))
        self._param_dirichlet: list[tuple[np.ndarray, np.ndarray, Callable]] = []
        if dofs:
            dd = np.concatenate(dofs).astype(np.int64)
            vv = np.concatenate(vals)
            # Duplicate resolution: the FIRST spec in the deck wins, with a
            # warning when later specs carry conflicting values — the
            # reference's Dirichlet dup rule ("defaulting to 1st occurence",
            # src/mm_bc_conflict.c:832-851). Parametric (NaN placeholder)
            # entries cannot be value-compared statically and only
            # participate in the precedence ordering.
            uniq, first = np.unique(dd, return_index=True)
            keep_mask = np.zeros(dd.shape[0], dtype=bool)
            keep_mask[first] = True
            owner_val = vv[first][np.searchsorted(uniq, dd)]
            conf = (
                ~keep_mask
                & np.isfinite(vv)
                & np.isfinite(owner_val)
                & (np.abs(vv - owner_val)
                   > 1e-8 * np.maximum(1.0, np.maximum(np.abs(vv), np.abs(owner_val))))
            )
            if conf.any():
                warnings.warn(
                    f"{int(conf.sum())} Dirichlet entries conflict with an "
                    "earlier spec at the same dof; first spec takes "
                    "precedence (mm_bc_conflict.c dup rule)",
                    stacklevel=2,
                )
            for r in dd[~keep_mask]:
                self.bc_dup_log.append({
                    "row": int(r), "kept": "DIRICHLET (first spec)",
                    "dropped": "DIRICHLET (later spec)",
                    "rule": "first occurrence kept "
                            "(mm_bc_conflict.c:832)"})
            self.dirichlet_dofs = dd[keep_mask]
            self.dirichlet_vals = np.nan_to_num(vv[keep_mask])
            # parametric specs keep only the entries they own
            for start, d, x, fn in param_specs:
                own = keep_mask[start:start + d.shape[0]]
                if own.any():
                    self._param_dirichlet.append((d[own], x[own], fn))
        else:
            self.dirichlet_dofs = np.empty(0, dtype=np.int64)
            self.dirichlet_vals = np.empty(0, dtype=np.float64)
        dmask = np.zeros(self.dofmap.n_dof, dtype=bool)
        dmask[self.dirichlet_dofs] = True
        self._dir_mask = dmask
        self._dir_nnz_keep = (~dmask[self.pattern.rows]).astype(np.float64)
        self._dir_diag_pos = self.pattern.diag[self.dirichlet_dofs]

        # rotated BCs
        from goma_tpu.bc.rotation import build_rotation

        self._rotation = build_rotation(self, self._rot_specs, self._rot_constraints)

        # pointwise collocated constraints
        from goma_tpu.bc.pointwise import build_point_constraints

        self._point_sets = build_point_constraints(self, self._point_specs)

        # additive weak nodal terms (bc_special parity)
        from goma_tpu.bc.pointwise import build_point_loads

        self._point_loads = build_point_loads(self, self._point_load_specs)

        # face sets: group registered kernels by sideset
        bysset: dict[str, list[FaceKernel]] = {}
        for name, k in self._face_sets:
            bysset.setdefault(name, []).append(k)
        self.face_sets: list[_FaceSet] = []
        for name, kernels in bysset.items():
            self.face_sets.extend(self._build_face_set(name, kernels))

        # 3D edge-curve sets (bc_curve.c parity): group kernels per
        # sideset pair, intersect on host
        bypair: dict[tuple[str, str], list] = {}
        for sa, sb, k in self._edge_specs:
            bypair.setdefault((sa, sb), []).append(k)
        self.edge_sets = []
        if bypair:
            from goma_tpu.bc.edge import build_edge_sets

            for (sa, sb), kernels in bypair.items():
                self.edge_sets.extend(build_edge_sets(self, sa, sb, kernels))

        # transpose-gather map for the scatter-free element matvec: for every
        # dof, the positions of its contributions in the concatenated
        # (blocks..., faces...) element-local vectors. This turns the
        # scatter into an (n, m) gather.
        flat_parts = [bd.gather.ravel() for bd in self.dofmap.blocks]
        for fs in self.face_sets:
            flat_parts.append(self.dofmap.blocks[fs.block_index].gather[fs.face_elems].ravel())
        if flat_parts:
            flat = np.concatenate(flat_parts).astype(np.int64)
            L = flat.shape[0]
            order = np.argsort(flat, kind="stable")
            sorted_dofs = flat[order]
            starts = np.searchsorted(sorted_dofs, np.arange(self.dofmap.n_dof))
            ends = np.searchsorted(sorted_dofs, np.arange(self.dofmap.n_dof) + 1)
            m = int((ends - starts).max()) if L else 1
            pos = np.full((self.dofmap.n_dof, m), L, dtype=np.int64)
            for k in range(m):
                sel = starts + k < ends
                pos[sel, k] = order[(starts + k)[sel]]
            self._tgather_pos = pos
        else:
            self._tgather_pos = np.zeros((self.dofmap.n_dof, 1), dtype=np.int64)

        # scatter-free CSR-value assembly: per nnz entry, the positions of
        # its contributions in the concatenated (blocks..., faces...) flat
        # element-Jacobian arrays. This turns the load_lec scatter
        # (segment_sum) into a (nnz, kc) gather + sum
        # (kc = max elements sharing a coupling, 4 for Q2/Q1 interiors).
        nnz_parts = [self._nnz_maps[bi].ravel()
                     for bi in range(len(self.dofmap.blocks))]
        for fs in self.face_sets:
            nnz_parts.append(
                self._nnz_maps[fs.block_index][fs.face_elems].ravel())
        flatn = np.concatenate(nnz_parts).astype(np.int64)
        Lj = flatn.shape[0]
        ordn = np.argsort(flatn, kind="stable")
        sn = flatn[ordn]
        nnz = self.pattern.nnz
        st = np.searchsorted(sn, np.arange(nnz))
        en = np.searchsorted(sn, np.arange(nnz) + 1)
        kc = max(int((en - st).max()), 1) if Lj else 1
        npos = np.full((nnz, kc), Lj, dtype=np.int64)
        for k in range(kc):
            sel = st + k < en
            npos[sel, k] = ordn[(st + k)[sel]]
        self._nnz_tgather = npos

        # fused fast-path recognition (fem/fastns.py): hand-derived
        # residual+Jacobian for the NS Galerkin block, element-last layout
        from goma_tpu.fem import fastns

        self._fast_static: dict[int, dict] = {}
        self._fast_meta = {}
        if self.enable_fast_kernels:
            for bi in range(len(self.dofmap.blocks)):
                m = fastns.match_ns_q2q1(self, bi)
                if m is not None:
                    self._fast_meta[bi] = m

        self._build_tables()
        # re-finalize support (moving overset boundaries, remesh): drop any
        # caches derived from the previous layout
        self._padded_meta = None
        self._padded_ok = None
        self._finalized = True
        self._assemble_jit = jax.jit(self._assemble)
        self._residual_jit = jax.jit(self._residual_only)

    def _build_interface_sets(self) -> list["_IfcSet"]:
        """Per registered interface: A-side face quadrature tables, B-side
        basis tables at the *matching* reference points (host Newton
        inversion of B's face map at A's physical qps), and the combined
        (nla + nlb) dof gather that gives the cross-block Jacobian blocks."""
        out = []
        bykey: dict[int, tuple] = {}
        for pairs, k in self._ifc_specs:
            bykey.setdefault(id(pairs), (pairs, []))[1].append(k)
        mesh = self.mesh
        for pairs, kernels in bykey.values():
            ba, bb = pairs.block_a, pairs.block_b
            blk_a, blk_b = mesh.blocks[ba], mesh.blocks[bb]
            bd_a, bd_b = self.dofmap.blocks[ba], self.dofmap.blocks[bb]
            et_a, et_b = element_type(blk_a.elem_type), element_type(blk_b.elem_type)
            gi_a, gi_b = geom_interp(et_a), geom_interp(et_b)
            fpts, fwts = face_rule(et_a.family, self.quad_order)
            faces_a = elem_faces(et_a.family)
            faces_b = elem_faces(et_b.family)
            interps_a = {s.interp for s in bd_a.slots if s.interp != "N1"}
            interps_b = {s.interp for s in bd_b.slots if s.interp != "N1"}

            ta = {"Ng": [], "dNg": [], "refjac": []}
            tb = {"Ng": [], "dNg": [], "refjac": []}
            Na = {i: [] for i in interps_a}
            dNa = {i: [] for i in interps_a}
            Nb = {i: [] for i in interps_b}
            dNb = {i: [] for i in interps_b}
            for la, fa, lb, fb in zip(pairs.elems_a, pairs.faces_a,
                                      pairs.elems_b, pairs.faces_b):
                face_a = faces_a[int(fa)]
                epts_a = face_a.ref_map(fpts)
                Ng_a, dNg_a = eval_basis(et_a.family, gi_a, epts_a)
                Xa = mesh.coords[blk_a.conn[int(la)]]
                xq = Ng_a @ Xa  # physical qps (nq, dim)

                # invert B's face map at each physical qp (host Newton)
                face_b_o = faces_b[int(fb)]
                Xb = mesh.coords[blk_b.conn[int(lb)]]
                dim_f = face_b_o.ref_jac.shape[1]
                s = np.zeros((fpts.shape[0], dim_f))
                for _ in range(30):
                    epts_b = face_b_o.ref_map(s)
                    Ng_b, dNg_b = eval_basis(et_b.family, gi_b, epts_b)
                    xb = Ng_b @ Xb
                    # dX/ds = (dNg_b . refjac)^T Xb
                    dxds = np.einsum("qnd,df,nk->qkf", dNg_b,
                                     face_b_o.ref_jac, Xb)
                    r = xb - xq
                    JtJ = np.einsum("qkf,qkg->qfg", dxds, dxds)
                    Jtr = np.einsum("qkf,qk->qf", dxds, r)
                    ds = np.linalg.solve(JtJ, Jtr[:, :, None])[:, :, 0]
                    s = s - ds
                    if np.abs(ds).max() < 1e-13:
                        break
                epts_b = face_b_o.ref_map(s)
                if np.abs((eval_basis(et_b.family, gi_b, epts_b)[0] @ Xb) - xq).max() > 1e-8:
                    raise RuntimeError("interface faces are not conforming")
                Ng_b, dNg_b = eval_basis(et_b.family, gi_b, epts_b)
                ta["Ng"].append(Ng_a)
                ta["dNg"].append(dNg_a)
                ta["refjac"].append(face_a.ref_jac)
                tb["Ng"].append(Ng_b)
                tb["dNg"].append(dNg_b)
                tb["refjac"].append(face_b_o.ref_jac)
                for itp in interps_a:
                    N, dN = eval_basis(et_a.family, itp, epts_a)
                    Na[itp].append(N)
                    dNa[itp].append(dN)
                for itp in interps_b:
                    N, dN = eval_basis(et_b.family, itp, epts_b)
                    Nb[itp].append(N)
                    dNb[itp].append(dN)
            ftabs_a = {k: np.stack(v) for k, v in ta.items()}
            ftabs_b = {k: np.stack(v) for k, v in tb.items()}
            for itp in interps_a:
                ftabs_a[f"N:{itp}"] = np.stack(Na[itp])
                ftabs_a[f"dN:{itp}"] = np.stack(dNa[itp])
            for itp in interps_b:
                ftabs_b[f"N:{itp}"] = np.stack(Nb[itp])
                ftabs_b[f"dN:{itp}"] = np.stack(dNb[itp])
            ga = bd_a.gather[pairs.elems_a]
            gb = bd_b.gather[pairs.elems_b]
            out.append(_IfcSet(
                block_a=ba, block_b=bb, kernels=kernels,
                elems_a=np.asarray(pairs.elems_a), elems_b=np.asarray(pairs.elems_b),
                ftabs_a=ftabs_a, ftabs_b=ftabs_b, fwts=fwts,
                gather_ab=np.concatenate([ga, gb], axis=1), nla=ga.shape[1],
            ))
        return out

    def _build_overset_sets(self) -> list["_OvsSet"]:
        """Host precomputation for overset couplings: immersed-curve
        quadrature points + arc weights from the BAR geometry, containing
        background elements via centroid kd-tree + isoparametric Newton
        inversion (the host analog of the reference's
        ``jksd``/``find_id_elem`` search in src/bc_contact.c), background
        basis tables at the landed reference points, and the combined
        [bar, fluid] dof gather whose jacfwd gives every coupling block."""
        if not self._ovs_specs:
            return []
        from goma_tpu.elements import volume_rule
        from goma_tpu.post.particles import _invert_map

        mesh = self.mesh
        name2bi = {b.name: i for i, b in enumerate(mesh.blocks)}
        out = []
        bykey: dict[tuple, tuple] = {}
        for bb, fb, k, qo, solid in self._ovs_specs:
            bb = name2bi[bb] if isinstance(bb, str) else int(bb)
            fb = name2bi[fb] if isinstance(fb, str) else int(fb)
            bykey.setdefault((bb, fb, qo, solid), []).append(k)
        for (bb, fb, qo, solid), kernels in bykey.items():
            blk_b, blk_f = mesh.blocks[bb], mesh.blocks[fb]
            bd_b, bd_f = self.dofmap.blocks[bb], self.dofmap.blocks[fb]
            et_b, et_f = element_type(blk_b.elem_type), element_type(blk_f.elem_type)
            if et_b.family != "bar":
                raise ValueError("overset multiplier block must be a BAR block")
            qpts, qwts = volume_rule("bar", qo or self.quad_order)
            Ng, dNg = eval_basis("bar", geom_interp(et_b), qpts)
            nq = qpts.shape[0]
            interps_f = sorted({s.interp for s in bd_f.slots if s.interp != "N1"})

            from scipy.spatial import cKDTree

            cents = mesh.coords[blk_f.conn].mean(axis=1)
            tree = cKDTree(cents)

            # optional solid side: bar element i == sideset face i
            sb = -1
            interps_s = []
            if solid is not None:
                sb, ssname = solid
                sb = name2bi[sb] if isinstance(sb, str) else int(sb)
                ss = mesh.sidesets[ssname]
                if len(ss.elems) != blk_b.n_elem:
                    raise ValueError(
                        "overset solid coupling: bar block must be the shell "
                        "block attached to the given sideset (one bar element "
                        "per face)")
                blk_s = mesh.blocks[sb]
                bd_s = self.dofmap.blocks[sb]
                et_s = element_type(blk_s.elem_type)
                interps_s = sorted({s.interp for s in bd_s.slots
                                    if s.interp not in ("N1",)})

            rows_g, xs, ws, Nfs = [], [], [], {i: [] for i in interps_f}
            Nss = {i: [] for i in interps_s}
            for le in range(blk_b.n_elem):
                Xb = mesh.coords[blk_b.conn[le]]
                xq = Ng @ Xb  # (nq, dim)
                tang = np.einsum("qn,nk->qk", dNg[:, :, 0], Xb)
                wq = qwts * np.linalg.norm(tang, axis=1)
                _, cand = tree.query(xq, k=min(8, cents.shape[0]))
                cand = np.atleast_2d(cand)
                for iq in range(nq):
                    fe = -1
                    for ge in cand[iq]:
                        xi, ok = _invert_map(et_f, mesh.coords[blk_f.conn[ge]],
                                             xq[iq])
                        if ok:
                            fe = int(ge)
                            break
                    if fe < 0:
                        raise RuntimeError(
                            f"overset point {xq[iq]} lies outside the "
                            f"background block '{blk_f.name}'")
                    row = [bd_b.gather[le], bd_f.gather[fe]]
                    if solid is not None:
                        se = int(mesh.global_elem_block(int(ss.elems[le]))[1])
                        xi_s, ok = _invert_map(et_s,
                                               mesh.coords[blk_s.conn[se]],
                                               xq[iq])
                        if not ok:
                            raise RuntimeError(
                                "overset point does not invert into its "
                                "solid parent element")
                        for itp in interps_s:
                            N, _ = eval_basis(et_s.family, itp, xi_s[None, :])
                            Nss[itp].append(N[0])
                        row.append(bd_s.gather[se])
                    rows_g.append(np.concatenate(row))
                    xs.append(xq[iq])
                    ws.append(wq[iq])
                    for itp in interps_f:
                        N, _ = eval_basis(et_f.family, itp, xi[None, :])
                        Nfs[itp].append(N[0])
            out.append(_OvsSet(
                bar_block=bb, fluid_block=fb, kernels=kernels,
                gather=np.stack(rows_g).astype(np.int32), nlb=bd_b.n_ldof,
                xq=np.stack(xs), wq=np.asarray(ws),
                Nf={i: np.stack(v) for i, v in Nfs.items()},
                solid_block=sb, nlf=bd_f.n_ldof,
                Ns={i: np.stack(v) for i, v in Nss.items()} if interps_s else None,
            ))
        return out

    def _ovs_residual_fn(self, si: int, dtype=None) -> Callable:
        """Residual of one overset quadrature point over the combined
        [bar, fluid] local dofs; jacfwd yields the multiplier/velocity
        coupling blocks (the reference's hand-coded bAC/cAC/dAC arrays)."""
        from goma_tpu.physics.overset import LM_VAR, OversetVars

        s = self.ovs_sets[si]
        bd_b = self.dofmap.blocks[s.bar_block]
        bd_f = self.dofmap.blocks[s.fluid_block]
        has_solid = s.solid_block >= 0
        bd_s = self.dofmap.blocks[s.solid_block] if has_solid else None
        nlb = s.nlb
        nlbf = nlb + bd_f.n_ldof
        nl = nlbf + (bd_s.n_ldof if has_solid else 0)
        lam = bd_b.slot(LM_VAR)

        def row_res(q, h, xp, wp, Nf, Ns, params):
            qf = q[nlb:nlbf]
            ov = OversetVars()
            ov.x = xp
            ov.w = wp
            for sl in bd_f.slots:
                if sl.interp == "N1":
                    continue
                N = Nf[sl.interp]  # (nbf,)
                qv = qf[sl.start : sl.start + sl.size].reshape(sl.ncomp, sl.nbf)
                ov.vals[sl.var] = qv @ N
                ov.phi[sl.var] = N
            if has_solid:
                qs = q[nlbf:]
                qsdot = params["ct"] * qs + h[nlbf:]
                for sl in bd_s.slots:
                    if sl.interp in ("N1",):
                        continue
                    N = Ns[sl.interp]
                    qv = qs[sl.start : sl.start + sl.size].reshape(sl.ncomp, sl.nbf)
                    dv = qsdot[sl.start : sl.start + sl.size].reshape(sl.ncomp, sl.nbf)
                    ov.vals_s[sl.var] = qv @ N
                    ov.dots_s[sl.var] = dv @ N
                    ov.phi_s[sl.var] = N
            r = jnp.zeros(nl, dtype=q.dtype)
            q_lam = q[lam.start : lam.start + lam.size].reshape(lam.ncomp)
            for k in s.kernels:
                parts = k.residual(ov, q_lam, params)
                r_lam, rf = parts[0], parts[1]
                r = r.at[lam.start : lam.start + lam.size].add(r_lam)
                for var, contrib in rf.items():
                    sl = bd_f.slot(var)
                    r = r.at[nlb + sl.start : nlb + sl.start + sl.size].add(
                        contrib.reshape(-1))
                if len(parts) > 2 and has_solid:
                    for var, contrib in parts[2].items():
                        sl = bd_s.slot(var)
                        r = r.at[nlbf + sl.start : nlbf + sl.start + sl.size].add(
                            contrib.reshape(-1))
            return r, r

        return row_res

    def _ovs_contribs(self, x, hist, params, T, with_jac=True):
        """Sum of all overset sets' (R, vals) contributions."""
        n = self.dofmap.n_dof
        dtype = x.dtype
        R = jnp.zeros(n, dtype=dtype)
        vals = jnp.zeros(self.pattern.nnz, dtype=dtype) if with_jac else None
        for si, s in enumerate(self.ovs_sets):
            gather = T[f"og{si}"]
            xs = T[f"ox{si}"]
            ws = T[f"ow{si}"]
            Nf = {k: T[f"oN{si}:{k}"] for k in s.Nf}
            Ns = {k: T[f"oNs{si}:{k}"] for k in (s.Ns or {})}
            row_res = self._ovs_residual_fn(si)
            if with_jac:
                jac_fn = jax.jacfwd(row_res, argnums=0, has_aux=True)
                J, r = jax.vmap(jac_fn, in_axes=(0, 0, 0, 0, 0, 0, None))(
                    x[gather], hist[gather], xs, ws, Nf, Ns, params)
                vals = vals + jax.ops.segment_sum(
                    J.reshape(-1), T[f"on{si}"].reshape(-1),
                    num_segments=self.pattern.nnz)
            else:
                r, _ = jax.vmap(row_res, in_axes=(0, 0, 0, 0, 0, 0, None))(
                    x[gather], hist[gather], xs, ws, Nf, Ns, params)
            R = R + jax.ops.segment_sum(r.reshape(-1), gather.reshape(-1),
                                        num_segments=n)
        return R, vals

    def _build_face_set(self, sideset_name: str, kernels: list[FaceKernel]) -> list["_FaceSet"]:
        mesh = self.mesh
        ss = mesh.sidesets[sideset_name]
        # split faces by block
        per_block: dict[int, list[tuple[int, int]]] = {}
        for e, f in zip(ss.elems, ss.faces):
            bi, le = mesh.global_elem_block(int(e))
            per_block.setdefault(bi, []).append((le, int(f)))
        out = []
        for bi, lst in per_block.items():
            blk = mesh.blocks[bi]
            bd = self.dofmap.blocks[bi]
            et = element_type(blk.elem_type)
            gi = geom_interp(et)
            fpts, fwts = face_rule(et.family, self.quad_order)
            all_faces = elem_faces(et.family)
            # edge (N1) slots have no scalar face traces; face kernels on
            # Nedelec variables are not supported yet. Hermite (H3) traces
            # need the per-element arclength slope scaling — skipped.
            interps = {s.interp for s in bd.slots if s.interp not in ("N1", "H3")}
            # per-face tables
            Ngs, dNgs, refjacs = [], [], []
            Ni: dict[str, list] = {i: [] for i in interps}
            dNi: dict[str, list] = {i: [] for i in interps}
            for le, f in lst:
                face = all_faces[f]
                epts = face.ref_map(fpts)
                Ng, dNg = eval_basis(et.family, gi, epts)
                Ngs.append(Ng)
                dNgs.append(dNg)
                refjacs.append(face.ref_jac)
                for itp in interps:
                    N, dN = eval_basis(et.family, itp, epts)
                    Ni[itp].append(N)
                    dNi[itp].append(dN)
            ftabs = {
                "Ng": np.stack(Ngs),
                "dNg": np.stack(dNgs),
                "refjac": np.stack(refjacs),
            }
            if et.family == "bar":
                # outward sign of the endpoint conormal (+-xi end)
                ftabs["psign"] = np.array(
                    [[[all_faces[f].ref_origin[0]]] for _, f in lst])
            for itp in interps:
                ftabs[f"N:{itp}"] = np.stack(Ni[itp])
                ftabs[f"dN:{itp}"] = np.stack(dNi[itp])
            out.append(
                _FaceSet(
                    block_index=bi,
                    kernels=kernels,
                    face_elems=np.array([le for le, _ in lst], dtype=np.int64),
                    ftabs=ftabs,
                    fwts=fwts,
                    name=sideset_name,
                )
            )
        return out

    # ------------------------------------------------------------ parameters
    def bc_dup_report(self) -> str:
        """Human-readable table of every BC duplicate/conflict resolution
        made at finalize — the analog of the reference's ``-bc_dup``
        diagnostic file (``src/mm_bc_conflict.c`` writes bc_dup.txt listing
        which condition was kept/discarded at each contested node)."""
        log = getattr(self, "bc_dup_log", [])
        if not log:
            return "bc_dup: no duplicate boundary conditions detected"
        lines = [f"bc_dup: {len(log)} resolution(s)",
                 "  row      node   kept -> dropped   [rule]"]
        for e in log:
            node = e.get("node", "-")
            lines.append(f"  {e['row']:<8} {node:<6} {e['kept']} -> "
                         f"{e['dropped']}   [{e['rule']}]")
        return "\n".join(lines)

    def base_params(self, **extra) -> dict:
        """Default parameter pytree: steady state, registered Dirichlet values."""
        dt = self.dtype
        p = {
            "ct": jnp.zeros((), dtype=dt),  # d(qdot)/d(q) of the time scheme
            "hist": jnp.zeros(self.dofmap.n_dof, dtype=dt),  # qdot = ct*x + hist
            "dirichlet_val": jnp.asarray(self.dirichlet_vals, dtype=dt),
            "time": jnp.zeros((), dtype=dt),
        }
        for name in self.external_fields:
            p[f"ext_{name}"] = jnp.zeros(self.mesh.n_nodes, dtype=dt)
        p["_tables"] = self._tables
        p.update(extra)
        return p

    # ------------------------------------------------------------- assembly
    def _elem_residual_fn(self, bi: int, dtype=None) -> Callable:
        bd = self.dofmap.blocks[bi]
        tables = self.tables[bi]
        eqs = self.equations[bi]
        mat = self.materials[bi]
        dtype = dtype or self.dtype

        ext_names = self.external_fields
        # shell/curve blocks: reference dimension below the space dimension
        edim = element_type(bd.elem_type).dim
        from goma_tpu.fem.fields import eval_curvevars, eval_surfvars

        if edim < self.mesh.dim:
            eval_fn = eval_curvevars if edim == 1 else eval_surfvars
            if self.coord != "cartesian":
                raise NotImplementedError(
                    "shell/curve blocks are not supported in axisymmetric "
                    "coordinates yet")
        else:
            eval_fn = eval_fieldvars
        coord = self.coord

        def elem_res(q_e, hist_e, X_e, ext_e, sgn_e, params):
            # sgn_e: per-element dof sign conjugation (Nedelec orientation,
            # dofmap.edge_signs); 1.0 for consistently oriented blocks
            q_e = q_e * sgn_e
            qdot_e = params["ct"] * q_e + hist_e * sgn_e
            if eval_fn is eval_fieldvars:
                fv = eval_fn(q_e, qdot_e, X_e, tables, bd.slots, dtype, ext_e,
                             ext_names, coord)
            else:
                fv = eval_fn(q_e, qdot_e, X_e, tables, bd.slots, dtype, ext_e,
                             ext_names)
            r = jnp.zeros((bd.n_ldof,), dtype=q_e.dtype)
            for eq in eqs:
                s = bd.slot(eq.var)
                contrib = eq.residual(fv, mat, params)  # (nq, ncomp, nbf)
                w = fv.wdetJ0 if eq.measure == "reference" else fv.wdetJ
                acc = jnp.einsum("q,qcn->cn", w, contrib)
                r = r.at[s.start : s.start + s.size].add(acc.reshape(-1))
            r = r * sgn_e
            return r, r

        return elem_res

    def _face_residual_fn(self, fs: _FaceSet, dtype=None) -> Callable:
        bd = self.dofmap.blocks[fs.block_index]
        mat = self.materials[fs.block_index]
        dtype = dtype or self.dtype
        dim = self.mesh.dim
        fwts = jnp.asarray(fs.fwts, dtype=dtype)

        def face_res(q_e, hist_e, X_e, ftab, params):
            qdot_e = params["ct"] * q_e + hist_e
            sfv = eval_surfacevars(q_e, qdot_e, X_e, ftab, fwts, bd.slots, dim,
                                   dtype, self.coord)
            r = jnp.zeros((bd.n_ldof,), dtype=q_e.dtype)
            for k in fs.kernels:
                s = bd.slot(k.var)
                contrib = k.residual(sfv, mat, params)  # (nqf, ncomp, nbf)
                acc = jnp.einsum("q,qcn->cn", sfv.wdA, contrib)
                r = r.at[s.start : s.start + s.size].add(acc.reshape(-1))
            return r, r

        return face_res

    def _edge_residual_fn(self, ei: int, dtype=None) -> Callable:
        """Residual of one element's edge-curve contributions (bc_curve.c
        analog); jacfwd of this yields the edge BC Jacobian blocks."""
        es = self.edge_sets[ei]
        bd = self.dofmap.blocks[es.block_index]
        mat = self.materials[es.block_index]
        dtype = dtype or self.dtype
        from goma_tpu.bc.edge import eval_edgevars

        ewts = jnp.asarray(es.ewts, dtype=dtype)

        def edge_res(q_e, hist_e, X_e, etab, params):
            qdot_e = params["ct"] * q_e + hist_e
            efv = eval_edgevars(q_e, qdot_e, X_e, etab, ewts, bd.slots, dtype)
            r = jnp.zeros((bd.n_ldof,), dtype=q_e.dtype)
            for k in es.kernels:
                s = bd.slot(k.var)
                contrib = k.residual(efv, mat, params)  # (nq_e, ncomp, nbf)
                acc = jnp.einsum("q,qcn->cn", efv.wds, contrib)
                r = r.at[s.start : s.start + s.size].add(acc.reshape(-1))
            return r, r

        return edge_res

    def _edge_contribs(self, x, hist, params, T, with_jac=True):
        """Sum of all edge sets' (R, vals) contributions."""
        n = self.dofmap.n_dof
        dtype = x.dtype
        R = jnp.zeros(n, dtype=dtype)
        vals = jnp.zeros(self.pattern.nnz, dtype=dtype) if with_jac else None
        for ei, es in enumerate(self.edge_sets):
            gather = T[f"eg{ei}"]
            Xref = T[f"ex{ei}"]
            etabs = {k: T[f"et{ei}:{k}"] for k in es.etabs}
            edge_res = self._edge_residual_fn(ei)
            if with_jac:
                jac_fn = jax.jacfwd(edge_res, argnums=0, has_aux=True)
                J, r = jax.vmap(jac_fn, in_axes=(0, 0, 0, 0, None))(
                    x[gather], hist[gather], Xref, etabs, params)
                vals = vals + jax.ops.segment_sum(
                    J.reshape(-1), T[f"en{ei}"].reshape(-1),
                    num_segments=self.pattern.nnz)
            else:
                r, _ = jax.vmap(edge_res, in_axes=(0, 0, 0, 0, None))(
                    x[gather], hist[gather], Xref, etabs, params)
            R = R + jax.ops.segment_sum(r.reshape(-1), gather.reshape(-1),
                                        num_segments=n)
        return R, vals

    def _ifc_residual_fn(self, si: int, dtype=None) -> Callable:
        """Residual of one paired interface face over the COMBINED local dofs
        (nla + nlb): jacfwd of this yields the full two-sided Jacobian incl.
        the cross-block (neighbor) blocks — the lec->J_stress_neighbor analog."""
        s = self.ifc_sets[si]
        bd_a = self.dofmap.blocks[s.block_a]
        bd_b = self.dofmap.blocks[s.block_b]
        mat_a = self.materials[s.block_a]
        mat_b = self.materials[s.block_b]
        dtype = dtype or self.dtype
        dim = self.mesh.dim
        fwts = jnp.asarray(s.fwts, dtype=dtype)
        nla = s.nla

        def ifc_res(q_ab, hist_ab, Xa_e, Xb_e, fta, ftb, params):
            qa, qb = q_ab[:nla], q_ab[nla:]
            ha, hb = hist_ab[:nla], hist_ab[nla:]
            sa = eval_surfacevars(qa, params["ct"] * qa + ha, Xa_e, fta, fwts,
                                  bd_a.slots, dim, dtype, self.coord)
            sb = eval_surfacevars(qb, params["ct"] * qb + hb, Xb_e, ftb, fwts,
                                  bd_b.slots, dim, dtype, self.coord)
            r = jnp.zeros((q_ab.shape[0],), dtype=q_ab.dtype)
            for k in s.kernels:
                ca, cb = k.residual(sa, sb, mat_a, mat_b, params)
                # cross-variable interface kernels (var_a/var_b) target a
                # different equation on each side (e.g. VP_EQUIL: gas
                # species vs porous liquid pressure)
                sla = bd_a.slot(getattr(k, "var_a", None) or k.var)
                slb = bd_b.slot(getattr(k, "var_b", None) or k.var)
                acc_a = jnp.einsum("q,qcn->cn", sa.wdA, ca)
                acc_b = jnp.einsum("q,qcn->cn", sa.wdA, cb)
                r = r.at[sla.start : sla.start + sla.size].add(acc_a.reshape(-1))
                r = r.at[nla + slb.start : nla + slb.start + slb.size].add(
                    acc_b.reshape(-1))
            return r, r

        return ifc_res

    def _ifc_contribs(self, x, hist, params, T, with_jac=True):
        """Sum of all interface sets' (R, vals) contributions."""
        n = self.dofmap.n_dof
        dtype = x.dtype
        R = jnp.zeros(n, dtype=dtype)
        vals = jnp.zeros(self.pattern.nnz, dtype=dtype) if with_jac else None
        for si, s in enumerate(self.ifc_sets):
            gather = T[f"ig{si}"]
            Xa = T[f"ixa{si}"]
            Xb = T[f"ixb{si}"]
            fta = {k: T[f"ita{si}:{k}"] for k in s.ftabs_a}
            ftb = {k: T[f"itb{si}:{k}"] for k in s.ftabs_b}
            ifc_res = self._ifc_residual_fn(si)
            if with_jac:
                jac_fn = jax.jacfwd(ifc_res, argnums=0, has_aux=True)
                J, r = jax.vmap(jac_fn, in_axes=(0, 0, 0, 0, 0, 0, None))(
                    x[gather], hist[gather], Xa, Xb, fta, ftb, params)
                vals = vals + jax.ops.segment_sum(
                    J.reshape(-1), T[f"in{si}"].reshape(-1),
                    num_segments=self.pattern.nnz)
            else:
                r, _ = jax.vmap(ifc_res, in_axes=(0, 0, 0, 0, 0, 0, None))(
                    x[gather], hist[gather], Xa, Xb, fta, ftb, params)
            R = R + jax.ops.segment_sum(r.reshape(-1), gather.reshape(-1),
                                        num_segments=n)
        return R, vals

    def _ext_gather(self, params, conn):
        if self.external_fields:
            ext_stack = jnp.stack(
                [params[f"ext_{n}"] for n in self.external_fields], axis=-1
            )
            return ext_stack[conn]  # (ne, n_geom_nodes, n_ext)
        return jnp.zeros((conn.shape[0], conn.shape[1], 0), dtype=self.dtype)

    def _block_contrib(self, bi, x, hist, params, gather, Xref, nmap, conn, wmask=None,
                       fast_tables=None):
        """One block's (partial_R, partial_vals) from *array arguments*, so the
        element dimension can be sharded by a caller (see parallel/sharding).
        ``fast_tables``: element-last geometry tables enabling the fused
        hand-derived kernel (fem/fastns.py) — only passed by callers whose
        gather covers the same elements as the tables (unsharded)."""
        n = self.dofmap.n_dof
        if fast_tables is not None and wmask is None:
            from goma_tpu.fem import fastns

            r, J = fastns.ns_q2q1_rj(
                x[gather], hist[gather], fast_tables, self._fast_meta[bi],
                self._fast_static[bi], params["ct"], x.dtype)
            R = jax.ops.segment_sum(r.reshape(-1), gather.reshape(-1),
                                    num_segments=n)
            vals = jax.ops.segment_sum(
                J.reshape(-1), nmap.reshape(-1), num_segments=self.pattern.nnz)
            return R, vals
        q = x[gather]
        h = hist[gather]
        ext = self._ext_gather(params, conn)
        elem_res = self._elem_residual_fn(bi)
        sgn = self.dofmap.blocks[bi].edge_signs
        if sgn is not None:
            if q.shape[0] != sgn.shape[0]:
                raise NotImplementedError(
                    "sharded assembly with Nedelec edge signs not supported yet")
            sg, sax = jnp.asarray(sgn, dtype=q.dtype), 0
        else:
            sg, sax = 1.0, None
        jac_fn = jax.jacfwd(elem_res, argnums=0, has_aux=True)
        J, r = jax.vmap(jac_fn, in_axes=(0, 0, 0, 0, sax, None))(
            q, h, Xref, ext, sg, params)
        if wmask is not None:
            r = r * wmask[:, None]
            J = J * wmask[:, None, None]
        R = jax.ops.segment_sum(r.reshape(-1), gather.reshape(-1), num_segments=n)
        vals = jax.ops.segment_sum(
            J.reshape(-1), nmap.reshape(-1), num_segments=self.pattern.nnz
        )
        return R, vals

    def _face_contrib(self, fsi, x, hist, params, gather, Xref, ftabs, nmap, wmask=None):
        fs = self.face_sets[fsi]
        n = self.dofmap.n_dof
        q = x[gather]
        h = hist[gather]
        face_res = self._face_residual_fn(fs)
        jac_fn = jax.jacfwd(face_res, argnums=0, has_aux=True)
        J, r = jax.vmap(jac_fn, in_axes=(0, 0, 0, 0, None))(q, h, Xref, ftabs, params)
        if wmask is not None:
            r = r * wmask[:, None]
            J = J * wmask[:, None, None]
        R = jax.ops.segment_sum(r.reshape(-1), gather.reshape(-1), num_segments=n)
        vals = jax.ops.segment_sum(
            J.reshape(-1), nmap.reshape(-1), num_segments=self.pattern.nnz
        )
        return R, vals

    def _apply_inject(self, R, vals):
        """Cross-equation row injection (add_row_inject): R[to] += s R[from]
        and the matching CSR row entries. Runs on the raw assembled system,
        before rotations/point constraints/Dirichlet."""
        inj = self._inject
        if inj is None:
            return R, vals
        R = R.at[jnp.asarray(inj["to_rows"])].add(
            jnp.asarray(inj["sign_rows"], dtype=R.dtype)
            * R[jnp.asarray(inj["from_rows"])])
        if vals is not None:
            vals = vals.at[jnp.asarray(inj["to_pos"])].add(
                jnp.asarray(inj["sign_pos"], dtype=vals.dtype)
                * vals[jnp.asarray(inj["from_pos"])])
        return R, vals

    def _apply_rotation(self, x, R, vals, T):
        """Rotate assembled rows into normal-tangent frames and install
        constraint rows (device-side, fully vectorized)."""
        rd = self._rotation
        if rd is None:
            return R, vals
        dtype = R.dtype
        Q = T["rQ"]
        dofs = T["rdofs"]
        Rrows = jnp.einsum("nij,nj->ni", Q, R[dofs])
        R = R.at[dofs].set(Rrows)
        if vals is not None:
            pos = T["rpos"]
            vrows = vals[pos]  # (K, dim)
            new = jnp.einsum("kij,kj->ki", Q[T["rnode"]].astype(vals.dtype), vrows)
            vals = vals.at[pos].set(new)
        if rd.con_rows.size:
            crows = T["rcrow"]
            ccoef = T["rcoef"]
            cdofs = T["rcdofs"]
            cval = jnp.asarray(rd.con_value, dtype=dtype)
            Rcon = jnp.einsum("ni,ni->n", ccoef, x[cdofs]) - cval
            R = R.at[crows].set(Rcon)
            if vals is not None:
                vals = vals.at[T["rczero"]].set(jnp.zeros((), dtype=vals.dtype))
                vals = vals.at[T["rcepos"]].set(ccoef.astype(vals.dtype))
        return R, vals

    def _apply_dirichlet(self, x, R, vals, params):
        T = self._tb(params)
        n = self.dofmap.n_dof
        dtype = R.dtype
        if self.dirichlet_dofs.size:
            dmask = T["dirmask"]
            dd = T["dirdofs"]
            xv = jnp.zeros(n, dtype=dtype).at[dd].set(params["dirichlet_val"])
            for d, coords, fn in self._param_dirichlet:
                v = jnp.asarray(fn(jnp.asarray(coords, dtype=dtype), params), dtype=dtype)
                xv = xv.at[jnp.asarray(d)].set(jnp.broadcast_to(v, (d.shape[0],)))
            R = jnp.where(dmask, x - xv, R)
            if vals is not None:
                vals = vals * T["dirkeep"].astype(vals.dtype)
                vals = vals.at[T["dirdiag"]].set(
                    jnp.ones((), dtype=vals.dtype)
                )
        return R, vals

    def _elem_rj_parts(self, x, params, T, rdt=None):
        """Element/face loops shared by ``_assemble_with_elem`` and
        ``_assemble_fast``: per-part residual vectors plus per-element local
        Jacobians (mixed precision honored). Returns (r_parts, blockJ, faceJ)
        — the residual parts at ``rdt`` (or ``self.dtype``), the Jacobians at
        ``jacobian_dtype``.

        ``rdt``: residual-dtype override (switched-precision Newton). With
        ``rdt == jacobian_dtype`` the whole prep runs single-dtype — residual
        and Jacobian come out of ONE jacfwd/fused call, skipping the separate
        full-precision residual pass (the early Newton iterations don't
        need it — see NewtonOptions.prep32_tol).
        """
        # Full-f32 dots throughout the element work: at a reduced default
        # precision (TF32 or bf16 passes), f32 einsums (field evaluation
        # N@q, grad contractions, and everything jacfwd differentiates
        # through) leave ~1e-3-relative Jacobian entries, and on stiff
        # coupled systems (e.g. Ra=1e4 Boussinesq) that inexactness stalls
        # Newton. The per-element contractions are tiny (<=27x27).
        with jax.default_matmul_precision("highest"):
            return self._elem_rj_parts_body(x, params, T, rdt)

    def _elem_rj_parts_body(self, x, params, T, rdt=None):
        dtype = jnp.dtype(rdt) if rdt is not None else self.dtype
        jdt = jnp.dtype(self.jacobian_dtype) if self.jacobian_dtype else self.dtype
        down = dtype != self.dtype
        if down:
            params = jax.tree.map(
                lambda a: a.astype(dtype)
                if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating)
                else a,
                params,
            )
        tc = (lambda a: a.astype(dtype) if hasattr(a, "dtype")
              and jnp.issubdtype(a.dtype, jnp.floating) else a) if down \
            else (lambda a: a)
        mixed = jdt != dtype
        x = x.astype(dtype)
        hist = params["hist"]
        if mixed:
            # mixed-precision Newton-Krylov: the residual (and hence Newton
            # convergence to 1e-10) stays f64; the Jacobian/Krylov run in f32
            # (inexact Newton)
            params_j = jax.tree.map(
                lambda a: a.astype(jdt)
                if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating)
                else a,
                params,
            )
            xj = x.astype(jdt)
            histj = hist.astype(jdt)
        n = self.dofmap.n_dof
        # per-block/face parts combined at the end by transpose GATHERS
        # (T["tg"], T["nnztg"]) instead of segment_sum scatters
        r_parts = []
        blockJ = []
        faceJ = []

        rs_parts = []

        for bi, (bd, blk) in enumerate(zip(self.dofmap.blocks, self.mesh.blocks)):
            gather = T[f"g{bi}"]
            if bi in self._fast_meta:
                # fused hand-derived kernel, element-last layout (fastns.py)
                from goma_tpu.fem import fastns

                meta = self._fast_meta[bi]
                static = self._fast_static[bi]
                gn = T.get(f"fns:gnode{bi}")
                gat = ((lambda v: fastns.node_gather(v, gn, T[f"fns:gp{bi}"]))
                       if gn is not None else (lambda v: v[gather]))
                if mixed:
                    r, _ = fastns.ns_q2q1_rj(
                        gat(x), gat(hist),
                        fastns.select_tables(T, bi, dtype), meta, static,
                        params["ct"], dtype, with_jac=False)
                    _, J, rs = fastns.ns_q2q1_rj(
                        gat(xj), gat(histj),
                        fastns.select_tables(T, bi, jdt), meta, static,
                        params_j["ct"], jdt, with_rs=True)
                else:
                    r, J, rs = fastns.ns_q2q1_rj(
                        gat(x), gat(hist),
                        fastns.select_tables(T, bi, dtype), meta, static,
                        params["ct"], dtype, with_rs=True)
                blockJ.append(J)
                r_parts.append(r)
                rs_parts.append(rs)
                continue
            Xref = tc(T[f"x{bi}"])
            conn = T[f"c{bi}"]
            ext = tc(self._ext_gather(params, conn))
            elem_res = self._elem_residual_fn(bi, dtype)
            sgn = bd.edge_signs
            if sgn is not None:
                sg, sax = tc(T[f"sg{bi}"]), 0
            else:
                sg, sax = 1.0, None
            r, _ = jax.vmap(elem_res, in_axes=(0, 0, 0, 0, sax, None))(
                x[gather], hist[gather].astype(dtype), Xref, ext, sg, params
            )
            if mixed:
                jac_fn = jax.jacfwd(self._elem_residual_fn(bi, jdt), argnums=0,
                                    has_aux=True)
                J, _ = jax.vmap(jac_fn, in_axes=(0, 0, 0, 0, sax, None))(
                    xj[gather], histj[gather], Xref.astype(jdt),
                    ext.astype(jdt), sg if sgn is None else sg.astype(jdt),
                    params_j
                )
            else:
                jac_fn = jax.jacfwd(elem_res, argnums=0, has_aux=True)
                J, r = jax.vmap(jac_fn, in_axes=(0, 0, 0, 0, sax, None))(
                    x[gather], hist[gather].astype(dtype), Xref, ext, sg,
                    params
                )
            blockJ.append(J)
            r_parts.append(r)
            rs_parts.append(None)

        for fsi, fs in enumerate(self.face_sets):
            bd = self.dofmap.blocks[fs.block_index]
            blk = self.mesh.blocks[fs.block_index]
            fe = fs.face_elems
            gather = T[f"fg{fsi}"]
            Xref = tc(T[f"fx{fsi}"])
            ftabs = {k: tc(T[f"ft{fsi}:{k}"]) for k in fs.ftabs}
            face_res = self._face_residual_fn(fs, dtype)
            r, _ = jax.vmap(face_res, in_axes=(0, 0, 0, 0, None))(
                x[gather], hist[gather].astype(dtype), Xref, ftabs, params
            )
            if mixed:
                jac_fn = jax.jacfwd(self._face_residual_fn(fs, jdt), argnums=0,
                                    has_aux=True)
                J, _ = jax.vmap(jac_fn, in_axes=(0, 0, 0, 0, None))(
                    xj[gather], histj[gather], Xref.astype(jdt),
                    {k: v.astype(jdt) for k, v in ftabs.items()}, params_j
                )
            else:
                jac_fn = jax.jacfwd(face_res, argnums=0, has_aux=True)
                J, r = jax.vmap(jac_fn, in_axes=(0, 0, 0, 0, None))(
                    x[gather], hist[gather].astype(dtype), Xref, ftabs, params
                )
            faceJ.append(J)
            r_parts.append(r)
            rs_parts.append(None)
        return r_parts, blockJ, faceJ, rs_parts

    def _assemble_with_elem(self, x, params):
        """Like _assemble but also returns the per-element (and per-face)
        local Jacobians plus point-constraint rows, enabling the matrix-free
        element matvec (see ``element_matvec``): A@x as gather -> batched
        dense matmul -> small scatter instead of an ELL/CSR SpMV."""
        T = self._tb(params)
        dtype = self.dtype
        jdt = jnp.dtype(self.jacobian_dtype) if self.jacobian_dtype else dtype
        x = x.astype(dtype)
        hist = params["hist"]
        n = self.dofmap.n_dof
        r_parts, blockJ, faceJ, _ = self._elem_rj_parts(x, params, T)

        # combine: R via the dof transpose-gather; vals stays a
        # segment_sum (the (nnz, kc) gather needs 4.4M scalar-row gathers)
        flat_r = jnp.concatenate(
            [p.reshape(-1) for p in r_parts] + [jnp.zeros(1, dtype=dtype)])
        R = jnp.sum(flat_r[T["tg"]], axis=1)
        vals = jnp.zeros(self.pattern.nnz, dtype=jdt)
        nmaps = [T[f"n{bi}"] for bi in range(len(self.dofmap.blocks))] + \
            [T[f"fn{fsi}"] for fsi in range(len(self.face_sets))]
        for J, nmap in zip(blockJ + faceJ, nmaps):
            vals = vals + jax.ops.segment_sum(
                J.reshape(-1).astype(jdt), nmap.reshape(-1),
                num_segments=self.pattern.nnz)

        if getattr(self, "edge_sets", None):
            # edge-curve couplings are not in the element-matvec aux either
            # (NewtonSolver falls back to the CSR operator)
            dR, dv = self._edge_contribs(x, hist, params, T, with_jac=True)
            R = R + dR
            vals = vals + dv.astype(vals.dtype)
        if self.ifc_sets:
            # interface couplings are not in the element-matvec aux; callers
            # must use the CSR operator (NewtonSolver disables the element
            # matvec when interfaces are present)
            dR, dv = self._ifc_contribs(x, hist, params, T, with_jac=True)
            R = R + dR
            vals = vals + dv.astype(vals.dtype)
        if self.ovs_sets:
            dR, dv = self._ovs_contribs(x, hist, params, T, with_jac=True)
            R = R + dR
            vals = vals + dv.astype(vals.dtype)

        R, vals = self._apply_inject(R, vals)
        pl_dfs = []
        if self._point_loads:
            from goma_tpu.bc.pointwise import apply_point_loads

            R, vals, pl_dfs = apply_point_loads(
                self, self._point_loads, x, R, vals, params, T)
        R, vals = self._apply_rotation(x, R, vals, T)
        pc_dg = []
        if self._point_sets:
            from goma_tpu.bc.pointwise import apply_point_constraints

            for k, pc in enumerate(self._point_sets):
                dofs = T[f"pc{k}:dofs"]
                X0 = T[f"pc{k}:coords"]
                dg = jax.vmap(jax.jacfwd(lambda qi, Xi: pc.g(qi, Xi, params), argnums=0))(
                    x[dofs], X0
                )
                pc_dg.append(dg)
            R, vals = apply_point_constraints(self, self._point_sets, x, R, vals, params, T)
        R, vals = self._apply_dirichlet(x, R, vals, params)
        return R, vals, (tuple(blockJ), tuple(faceJ), tuple(pc_dg), tuple(pl_dfs))

    def _assemble_fast(self, x, params, rdt=None):
        """Vals-free assembly for the iterative fast path: residual, element
        Jacobians, and element-level absolute row sums — NO global CSR values.

        ``rdt``: residual-dtype override — with ``rdt == jacobian_dtype`` the
        separate full-precision residual pass disappears entirely (the
        switched-precision Newton prep; see ``_elem_rj_parts``).

        The reference assembles the global matrix every Newton iteration
        (``load_lec``, src/mm_fill.c:4959) because its solvers consume it;
        here that is an nnz-sized segment_sum scatter plus the
        equilibration/scaling passes over it. The Krylov path only ever
        needs (a) a matvec — served matrix-free from the element Jacobians —
        and (b) row sums for the reference's row-sum scaling
        (src/sl_matrix_util.c:442) — served here as

            rs[i] = sum_e sum_j |J_e[i_loc, j]|

        via the same dof transpose-gather that combines R. This upper-bounds
        the assembled row sum (triangle inequality; exact when contributions
        to a shared entry agree in sign — the dominant Galerkin terms do).
        CSR values are materialized only when a preconditioner refactor needs
        them (``NewtonSolver._scaled_vals``). Returns (R, rs, aux)."""
        T = self._tb(params)
        dtype = jnp.dtype(rdt) if rdt is not None else self.dtype
        jdt = jnp.dtype(self.jacobian_dtype) if self.jacobian_dtype else self.dtype
        if dtype != self.dtype:
            # downcast once so the row-surgery sections below (point loads /
            # rotation / point constraints / dirichlet) run single-dtype too
            params = jax.tree.map(
                lambda a: a.astype(dtype)
                if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating)
                else a,
                params,
            )
        x = x.astype(dtype)
        n = self.dofmap.n_dof
        r_parts, blockJ, faceJ, rs_el = self._elem_rj_parts(x, params, T,
                                                            rdt=rdt)

        flat_r = jnp.concatenate(
            [p.reshape(-1) for p in r_parts] + [jnp.zeros(1, dtype=dtype)])
        # element-level |row| sums through the SAME transpose-gather; fast
        # blocks hand back rs fused with the kernel (element-last reduce),
        # generic blocks pay the (ne, nl, nl) re-read
        s_parts = [(jnp.sum(jnp.abs(J), axis=2) if s is None else s)
                   .reshape(-1).astype(jdt)
                   for J, s in zip(blockJ + faceJ, rs_el)]
        flat_s = jnp.concatenate(s_parts + [jnp.zeros(1, dtype=jdt)])
        if flat_r.dtype == flat_s.dtype:
            # ONE row-gather of (r, s) pairs instead of two scalar-gather
            # passes (the tg gather is ~1.3M scalar loads at 192^2 —
            # pairing halves the passes)
            both = jnp.stack([flat_r, flat_s], axis=-1)
            gathered = both[T["tg"]]
            R = jnp.sum(gathered[..., 0], axis=1)
            rs = jnp.sum(gathered[..., 1], axis=1)
        else:
            R = jnp.sum(flat_r[T["tg"]], axis=1)
            rs = jnp.sum(flat_s[T["tg"]], axis=1)

        # --- row surgery, mirrored on rs (same order as _assemble_with_elem)
        pl_dfs = []
        if self._point_loads:
            from goma_tpu.bc.pointwise import apply_point_loads

            R, _, pl_dfs = apply_point_loads(
                self, self._point_loads, x, R, None, params, T)
            for k, df in enumerate(pl_dfs):
                rows = T[f"pld{k}:rows"]
                rs = rs.at[rows.reshape(-1)].add(
                    jnp.sum(jnp.abs(df), axis=2).reshape(-1).astype(jdt))
        rd = self._rotation
        if rd is not None:
            Q = T["rQ"].astype(R.dtype)
            dofs = T["rdofs"]
            R = R.at[dofs].set(jnp.einsum("nij,nj->ni", Q, R[dofs]))
            rs = rs.at[dofs].set(
                jnp.einsum("nij,nj->ni", jnp.abs(Q).astype(jdt), rs[dofs]))
            if rd.con_rows.size:
                crows = T["rcrow"]
                ccoef = T["rcoef"].astype(R.dtype)
                cdofs = T["rcdofs"]
                cval = jnp.asarray(rd.con_value, dtype=R.dtype)
                R = R.at[crows].set(
                    jnp.einsum("ni,ni->n", ccoef, x[cdofs]) - cval)
                rs = rs.at[crows].set(
                    jnp.sum(jnp.abs(ccoef), axis=1).astype(jdt))
        pc_dg = []
        if self._point_sets:
            from goma_tpu.bc.pointwise import apply_point_constraints

            for k, pc in enumerate(self._point_sets):
                dofs = T[f"pc{k}:dofs"]
                X0 = T[f"pc{k}:coords"]
                dg = jax.vmap(jax.jacfwd(
                    lambda qi, Xi: pc.g(qi, Xi, params), argnums=0))(
                    x[dofs], X0)
                pc_dg.append(dg)
                rs = rs.at[T[f"pc{k}:rows"]].set(
                    jnp.sum(jnp.abs(dg), axis=1).astype(jdt))
            R, _ = apply_point_constraints(
                self, self._point_sets, x, R, None, params, T)
        R, _ = self._apply_dirichlet(x, R, None, params)
        if self.dirichlet_dofs.size:
            rs = jnp.where(T["dirmask"], jnp.ones((), dtype=jdt), rs)
        return R, rs, (tuple(blockJ), tuple(faceJ), tuple(pc_dg), tuple(pl_dfs))

    def element_matvec(self, T, aux, scale, v):
        """Matrix-free y = A@v from the stored element Jacobians, reproducing
        exactly the surgered + row-scaled CSR operator. Scatter-free: the
        per-element products are combined through the precomputed transpose
        gather.

        ``T=None`` (the hot path) embeds the small index tables as
        compile-time constants: XLA specializes constant-index gathers."""
        T = T if T is not None else self._tables
        blockJ, faceJ, pc_dg, pl_dfs = aux
        n = self.dofmap.n_dof
        parts = []
        for bi, bd in enumerate(self.dofmap.blocks):
            gn = T.get(f"fns:gnode{bi}")
            if gn is not None:
                from goma_tpu.fem import fastns

                q = fastns.node_gather(v, gn, T[f"fns:gp{bi}"])
            else:
                q = v[T[f"g{bi}"]]  # (ne, nl)
            # full-f32 accumulation: a reduced-precision default injects
            # ~1e-3 relative error per matvec, which caps Krylov convergence
            parts.append(
                jnp.einsum("eij,ej->ei", blockJ[bi], q,
                           precision=jax.lax.Precision.HIGHEST).reshape(-1)
            )
        for fsi, fs in enumerate(self.face_sets):
            bd = self.dofmap.blocks[fs.block_index]
            gather = T[f"fg{fsi}"]
            q = v[gather]
            parts.append(
                jnp.einsum("eij,ej->ei", faceJ[fsi], q,
                           precision=jax.lax.Precision.HIGHEST).reshape(-1)
            )
        ye_flat = jnp.concatenate(parts + [jnp.zeros(1, dtype=v.dtype)])
        y = jnp.sum(ye_flat[T["tg"]], axis=1)
        return self._matvec_post(T, pc_dg, scale, v, y, pl_dfs)

    def _matvec_post(self, T, pc_dg, scale, v, y, pl_dfs=()):
        """Shared compact-space matvec post-processing: point-load rows,
        rotated rows, point-constraint rows, Dirichlet identity rows, row
        scale."""
        # additive nodal terms come BEFORE rotation (they are physical
        # contributions whose rows may then be rotated), matching _assemble
        for k, df in enumerate(pl_dfs):
            rows = T[f"pld{k}:rows"]
            dofs = T[f"pld{k}:dofs"]
            contrib = jnp.einsum("nlc,nc->nl", df.astype(v.dtype), v[dofs])
            y = y.at[rows.reshape(-1)].add(contrib.reshape(-1))
        rd = self._rotation
        if rd is not None:
            Q = T["rQ"].astype(v.dtype)
            dofs = T["rdofs"]
            y = y.at[dofs].set(jnp.einsum("nij,nj->ni", Q, y[dofs]))
            if rd.con_rows.size:
                y = y.at[T["rcrow"]].set(
                    jnp.einsum("ni,ni->n", T["rcoef"].astype(v.dtype), v[T["rcdofs"]])
                )
        for k, dg in enumerate(pc_dg):
            y = y.at[T[f"pc{k}:rows"]].set(
                jnp.einsum("ni,ni->n", dg, v[T[f"pc{k}:dofs"]])
            )
        if self.dirichlet_dofs.size:
            dmask = T["dirmask"]
            y = jnp.where(dmask, v, y)
        if scale is not None:
            y = y * scale
        return y

    # ---------------------------------------------------- padded matvec path
    def ensure_padded_tables(self):
        """Build (once) the padded node-slot layout tables; see fem/padded.py.
        Returns False when the layout does not pay off (padding blowup)."""
        if getattr(self, "_padded_meta", None) is not None:
            return self._padded_ok
        from goma_tpu.fem.padded import build_padded_tables

        meta, tb = build_padded_tables(self)
        # gate: padding waste inflates the batched matmuls and Jp traffic;
        # fall back to the compact path when npad >> nl
        ok = all(bm["npad"] <= 2.0 * bm["nl"] + 8 for bm in meta["blocks"])
        self._padded_meta = meta
        self._padded_ok = ok
        if ok:
            for k, a in tb.items():
                self._tables[k] = jax.device_put(a)
        return ok

    def pad_aux(self, aux, T=None):
        """blockJ -> padded-layout element Jacobians (once per Newton step)."""
        from goma_tpu.fem.padded import pad_block_jacobians

        T = T if T is not None else self._tables
        blockJ, faceJ, pc_dg, pl_dfs = aux
        return (pad_block_jacobians(self._padded_meta, T, blockJ), faceJ, pc_dg,
                pl_dfs)

    def padded_matvec(self, T, auxp, scale, v):
        """element_matvec on the padded node-slot layout (row gathers instead
        of scalar gathers). Same operator semantics."""
        from goma_tpu.fem.padded import padded_matvec as _pmv

        T = T if T is not None else self._tables
        Jp, faceJ, pc_dg, pl_dfs = auxp
        y = _pmv(self, self._padded_meta, T, Jp, v)
        if self.face_sets:
            parts = []
            for fsi, fs in enumerate(self.face_sets):
                q = v[T[f"fg{fsi}"]]
                parts.append(
                    jnp.einsum("eij,ej->ei", faceJ[fsi], q,
                               precision=jax.lax.Precision.HIGHEST).reshape(-1)
                )
            flat = jnp.concatenate(parts + [jnp.zeros(1, dtype=v.dtype)])
            y = y + jnp.sum(flat[T["pl:tgf"]], axis=1)
        return self._matvec_post(T, pc_dg, scale, v, y, pl_dfs)

    def _assemble(self, x, params):
        """Returns (R, vals): global residual and CSR Jacobian values, with
        Dirichlet rows replaced (R_d = x_d - x_bc, row = e_d)."""
        T = self._tb(params)
        dtype = self.dtype
        x = x.astype(dtype)
        hist = params["hist"]
        n = self.dofmap.n_dof
        R = jnp.zeros(n, dtype=dtype)
        vals = jnp.zeros(self.pattern.nnz, dtype=dtype)

        for bi, (bd, blk) in enumerate(zip(self.dofmap.blocks, self.mesh.blocks)):
            gather = T[f"g{bi}"]
            Xref = T[f"x{bi}"]
            nmap = T[f"n{bi}"]
            conn = T[f"c{bi}"]
            FT = ({k: T[f"{k}{bi}"] for k in ("fns:gphi", "fns:w", "fns:Kfix", "fns:Mvel")}
                  if bi in self._fast_meta else None)
            dR, dv = self._block_contrib(bi, x, hist, params, gather, Xref, nmap,
                                         conn, fast_tables=FT)
            R = R + dR
            vals = vals + dv

        for fsi, fs in enumerate(self.face_sets):
            bd = self.dofmap.blocks[fs.block_index]
            blk = self.mesh.blocks[fs.block_index]
            fe = fs.face_elems
            gather = T[f"fg{fsi}"]
            Xref = T[f"fx{fsi}"]
            ftabs = {k: T[f"ft{fsi}:{k}"] for k in fs.ftabs}
            nmap = T[f"fn{fsi}"]
            dR, dv = self._face_contrib(fsi, x, hist, params, gather, Xref, ftabs, nmap)
            R = R + dR
            vals = vals + dv

        if getattr(self, "edge_sets", None):
            dR, dv = self._edge_contribs(x, hist, params, T, with_jac=True)
            R = R + dR
            vals = vals + dv
        if self.ifc_sets:
            dR, dv = self._ifc_contribs(x, hist, params, T, with_jac=True)
            R = R + dR
            vals = vals + dv
        if self.ovs_sets:
            dR, dv = self._ovs_contribs(x, hist, params, T, with_jac=True)
            R = R + dR
            vals = vals + dv

        R, vals = self._apply_inject(R, vals)
        if self._point_loads:
            from goma_tpu.bc.pointwise import apply_point_loads

            R, vals, _ = apply_point_loads(self, self._point_loads, x, R, vals, params, T)
        R, vals = self._apply_rotation(x, R, vals, T)
        if self._point_sets:
            from goma_tpu.bc.pointwise import apply_point_constraints

            R, vals = apply_point_constraints(self, self._point_sets, x, R, vals, params, T)
        return self._apply_dirichlet(x, R, vals, params)

    def _residual_only(self, x, params):
        T = self._tb(params)
        dtype = self.dtype
        x = x.astype(dtype)
        hist = params["hist"]
        n = self.dofmap.n_dof
        R = jnp.zeros(n, dtype=dtype)
        for bi, (bd, blk) in enumerate(zip(self.dofmap.blocks, self.mesh.blocks)):
            gather = T[f"g{bi}"]
            if bi in self._fast_meta:
                from goma_tpu.fem import fastns

                gn = T.get(f"fns:gnode{bi}")
                gat = ((lambda v: fastns.node_gather(v, gn,
                                                     T[f"fns:gp{bi}"]))
                       if gn is not None else (lambda v: v[gather]))
                r, _ = fastns.ns_q2q1_rj(
                    gat(x), gat(hist),
                    fastns.select_tables(T, bi, dtype), self._fast_meta[bi],
                    self._fast_static[bi], params["ct"], dtype, with_jac=False)
                R = R + jax.ops.segment_sum(r.reshape(-1), gather.reshape(-1),
                                            num_segments=n)
                continue
            Xref = T[f"x{bi}"]
            conn = T[f"c{bi}"]
            ext = self._ext_gather(params, conn)
            elem_res = self._elem_residual_fn(bi)
            if bd.edge_signs is not None:
                sg, sax = T[f"sg{bi}"], 0
            else:
                sg, sax = 1.0, None
            r, _ = jax.vmap(elem_res, in_axes=(0, 0, 0, 0, sax, None))(
                x[gather], hist[gather], Xref, ext, sg, params
            )
            R = R + jax.ops.segment_sum(r.reshape(-1), gather.reshape(-1), num_segments=n)
        for fsi, fs in enumerate(self.face_sets):
            bd = self.dofmap.blocks[fs.block_index]
            blk = self.mesh.blocks[fs.block_index]
            fe = fs.face_elems
            gather = T[f"fg{fsi}"]
            Xref = T[f"fx{fsi}"]
            ftabs = {k: T[f"ft{fsi}:{k}"] for k in fs.ftabs}
            face_res = self._face_residual_fn(fs)
            r, _ = jax.vmap(face_res, in_axes=(0, 0, 0, 0, None))(
                x[gather], hist[gather], Xref, ftabs, params
            )
            R = R + jax.ops.segment_sum(r.reshape(-1), gather.reshape(-1), num_segments=n)
        if getattr(self, "edge_sets", None):
            dR, _ = self._edge_contribs(x, hist, params, T, with_jac=False)
            R = R + dR
        if self.ifc_sets:
            dR, _ = self._ifc_contribs(x, hist, params, T, with_jac=False)
            R = R + dR
        if self.ovs_sets:
            dR, _ = self._ovs_contribs(x, hist, params, T, with_jac=False)
            R = R + dR
        R, _ = self._apply_inject(R, None)
        if self._point_loads:
            from goma_tpu.bc.pointwise import apply_point_loads

            R, _, _ = apply_point_loads(self, self._point_loads, x, R, None, params, T)
        R, _ = self._apply_rotation(x, R, None, T)
        if self._point_sets:
            from goma_tpu.bc.pointwise import apply_point_constraints

            R, _ = apply_point_constraints(self, self._point_sets, x, R, None, params, T)
        R, _ = self._apply_dirichlet(x, R, None, params)
        return R

    # public jitted entry points
    def assemble(self, x, params):
        return self._assemble_jit(x, params)

    def residual(self, x, params):
        return self._residual_jit(x, params)

    # ---------------------------------------------------------- field access
    def set_nodal_field(self, x, var: str, comp: int, values) -> np.ndarray:
        """Write per-node values (array over all mesh nodes, or callable of
        coords) into the solution vector for (var, comp). Returns a copy."""
        x = np.array(x, copy=True)
        dofs = self.dofmap.dof_of_node_svar[:, self.dofmap.svar(var, comp)]
        ok = dofs >= 0
        v = values(self.mesh.coords) if callable(values) else np.asarray(values)
        if np.ndim(v) == 0:
            v = np.full(self.mesh.coords.shape[0], float(v))
        x[dofs[ok]] = v[ok]
        return x

    def get_nodal_field(self, x, var: str, comp: int = 0, fill=np.nan) -> np.ndarray:
        """Per-node values of (var, comp); inactive nodes get ``fill``."""
        dofs = self.dofmap.dof_of_node_svar[:, self.dofmap.svar(var, comp)]
        out = np.full(self.mesh.coords.shape[0], fill)
        ok = dofs >= 0
        out[ok] = np.asarray(x)[dofs[ok]]
        return out
