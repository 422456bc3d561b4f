"""Per-element field-variable evaluation at quadrature points.

Parity: reference ``src/load_field_variables.c`` (``load_fv:127``,
``load_fv_grads:2014``, ``load_fv_mesh_derivs:3754``) + the isoparametric map
``beer_belly`` (``src/mm_fill_util.c:139``) + basis loading
(``load_basis_functions:2607``).

Redesign: everything is evaluated for *all* quadrature points of an
element at once with batched einsums (leading axis = qp), inside a function
that is `vmap`-ed over all elements of a block. Mesh-displacement
sensitivities (the ALE core, hand-coded in the reference) come for free:
coordinates are ``X_ref + d`` with ``d`` part of the differentiated unknowns,
so ``jax.jacfwd`` of the residual includes all mesh derivatives exactly.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import jax.numpy as jnp

from goma_tpu.elements import element_type, eval_basis, geom_interp, interp_local_nodes
from goma_tpu.fem.dofmap import BlockDofs, LocalSlot

MESH_VAR = "mesh_displacement"


@dataclass
class BlockTables:
    """Static (host numpy) basis tables for one block's volume quadrature."""

    elem_type: str
    dim: int
    nq: int
    qwts: np.ndarray  # (nq,)
    Ng: np.ndarray  # (nq, n_geom_nodes) geometric basis
    dNg: np.ndarray  # (nq, n_geom_nodes, dim)
    N: dict[str, np.ndarray]  # interp -> (nq, nbf)
    dN: dict[str, np.ndarray]  # interp -> (nq, nbf, dim) (reference coords)
    # H(curl) edge interpolations (I_N1): reference vector basis + curl
    Nvec: dict[str, np.ndarray] = None  # interp -> (nq, nbf, dim)
    Ncurl: dict[str, np.ndarray] = None  # interp -> (nq, nbf)
    # Hermite (I_H3) raw xi-tables: interp -> (nq, 4) for N/dN/d2N
    H3: dict[str, tuple] = None


def build_block_tables(elem_type_name: str, interps: set[str], quad_order: int) -> BlockTables:
    from goma_tpu.elements import volume_rule
    from goma_tpu.elements.shapes import eval_hermite_bar, eval_nedelec

    et = element_type(elem_type_name)
    qpts, qwts = volume_rule(et.family, quad_order)
    gi = geom_interp(et)
    Ng, dNg = eval_basis(et.family, gi, qpts)
    N, dN = {}, {}
    Nvec, Ncurl = {}, {}
    H3 = {}
    for itp in sorted(interps | {gi}):
        if itp == "N1":
            Nvec[itp], Ncurl[itp] = eval_nedelec(et.family, qpts)
            continue
        if itp == "H3":
            if et.family != "bar":
                raise ValueError("I_H3 Hermite interpolation is bar-only")
            H3[itp] = eval_hermite_bar(qpts)
            continue
        N[itp], dN[itp] = eval_basis(et.family, itp, qpts)
    return BlockTables(elem_type_name, et.dim, qpts.shape[0], qwts, Ng, dNg, N, dN,
                       Nvec, Ncurl, H3)


class FieldVars:
    """Field values/gradients/time-derivatives at all quadrature points of one
    element (shapes below have leading qp axis; vmapped over elements).

    Attributes:
      x        (nq, dim)        current (possibly displaced) position
      detJ     (nq,)
      wdetJ    (nq,)            quadrature weight x detJ
      val[v]   (nq, ncomp)
      grad[v]  (nq, ncomp, dim)
      dot[v]   (nq, ncomp)      time derivative
      phi[v]   (nq, nbf)        basis of v's interpolation
      gphi[v]  (nq, nbf, dim)   physical gradient of basis
      h_elem   (nq,)            element size measure (for SUPG/PSPG tau)

    When a mesh-displacement variable is active (ALE), reference-configuration
    quantities are also provided (for total-Lagrangian mesh/solid equations,
    reference analog ``belly_flop`` deformation gradient, src/mm_fill_solid.c:77):
      X0       (nq, dim)        undisplaced position
      wdetJ0   (nq,)            reference measure
      gphi0[v] (nq, nbf, dim)   basis gradient w.r.t. reference coords
      grad0[v] (nq, ncomp, dim) field gradient w.r.t. reference coords
      F        (nq, dim, dim)   deformation gradient dx/dX0
    """

    def __init__(self):
        self.val: dict[str, Any] = {}
        self.grad: dict[str, Any] = {}
        self.dot: dict[str, Any] = {}
        self.phi: dict[str, Any] = {}
        self.gphi: dict[str, Any] = {}
        self.x = None
        self.detJ = None
        self.wdetJ = None
        self.h_elem = None
        self.dim = None
        self.invJ = None
        # coordinate system (reference load_coordinate_scales,
        # src/mm_fill_aux.c:127): "cartesian" | "cylindrical" | "swirling".
        # Cylindrical/swirling = axisymmetric with q = [z, r(, theta)],
        # h3 = r: wdetJ carries the extra r factor and fv.r holds the
        # (guarded) radial coordinate for hoop terms in vector kernels.
        self.coord = "cartesian"
        self.r = None
        self.X0 = None
        self.wdetJ0 = None
        self.gphi0: dict[str, Any] = {}
        self.grad0: dict[str, Any] = {}
        self.F = None
        # external (frozen) nodal fields, reference External_Field_Variables
        # (include/mm_as_structs.h:1046): ext[name] (nq,), ext_grad[name] (nq, dim)
        self.ext: dict[str, Any] = {}
        self.ext_grad: dict[str, Any] = {}
        # H(curl) edge (Nedelec) variables: vector values + scalar curl (2D)
        # and the transformed basis tables for test functions
        self.curl: dict[str, Any] = {}
        self.curl_phi: dict[str, Any] = {}
        # raw element-local dof values (ncomp, nbf) and the element-local
        # node ids of each variable's interpolation — lets kernels build
        # node-anchored enrichments (XFEM, reference load_xfem_for_elem
        # src/mm_fill_ls.c:4604) without extra plumbing
        self.q_nodal: dict[str, Any] = {}
        self.lnodes: dict[str, tuple] = {}


def _unpack(q_e, slots: list[LocalSlot]):
    out = {}
    for s in slots:
        out[s.var] = q_e[s.start : s.start + s.size].reshape(s.ncomp, s.nbf)
    return out


def eval_fieldvars(
    q_e: jnp.ndarray,
    qdot_e: jnp.ndarray,
    X_e: jnp.ndarray,
    tables: BlockTables,
    slots: list[LocalSlot],
    dtype,
    ext_e: jnp.ndarray | None = None,
    ext_names: tuple[str, ...] = (),
    coord: str = "cartesian",
) -> FieldVars:
    """Build FieldVars for one element. All table constants are cast to the
    working dtype at trace time."""
    dim = tables.dim
    u = _unpack(q_e, slots)
    udot = _unpack(qdot_e, slots)

    Ng = jnp.asarray(tables.Ng, dtype=dtype)
    dNg = jnp.asarray(tables.dNg, dtype=dtype)
    qwts = jnp.asarray(tables.qwts, dtype=dtype)

    Xc = X_e
    if MESH_VAR in u:
        # ALE: displaced coordinates carry dofs -> AD sees mesh sensitivities
        Xc = X_e + u[MESH_VAR].T

    # isoparametric map: Jmat[q,k,d] = dx_k/dxi_d
    from goma_tpu.utils.la import det_and_inv

    Jmat = jnp.einsum("qnd,nk->qkd", dNg, Xc)
    detJ, invJ = det_and_inv(Jmat)  # invJ[q,d,k] = dxi_d/dx_k ... see below

    # note: inv(Jmat)[q] has shape (dim, dim) with [d', k'] meaning row index
    # over the *second* axis of Jmat; since Jmat[q] maps d->k as x_k = J[k,d] xi_d,
    # inv(Jmat)[q][d, k] = dxi_d/dx_k.  Physical basis gradient:
    # dphi/dx_k = dphi/dxi_d * dxi_d/dx_k
    fv = FieldVars()
    fv.dim = dim
    fv.invJ = invJ
    fv.x = jnp.einsum("qn,nk->qk", Ng, Xc)
    fv.detJ = detJ
    fv.wdetJ = qwts * detJ
    # element size: from map Jacobian at first qp (isotropic measure)
    fv.h_elem = 2.0 * jnp.abs(detJ) ** (1.0 / dim)

    axisym = coord in ("cylindrical", "swirling")
    if axisym:
        # axisymmetric q = [z, r]: dV = r dr dz (h3 = r, the reference's
        # load_coordinate_scales CYLINDRICAL/SWIRLING branch with its r=0
        # kludge, src/mm_fill_aux.c:211-228)
        fv.coord = coord
        r = fv.x[:, 1]
        fv.r = jnp.where(jnp.abs(r) < 1e-30, 1.0, r)
        fv.wdetJ = fv.wdetJ * fv.r

    ale = MESH_VAR in u
    if ale:
        Jmat0 = jnp.einsum("qnd,nk->qkd", dNg, X_e)
        detJ0, invJ0 = det_and_inv(Jmat0)
        fv.X0 = jnp.einsum("qn,nk->qk", Ng, X_e)
        fv.wdetJ0 = qwts * detJ0
        if axisym:
            r0 = fv.X0[:, 1]
            fv.wdetJ0 = fv.wdetJ0 * jnp.where(jnp.abs(r0) < 1e-30, 1.0, r0)
        # deformation gradient F = dx/dX0 = Jmat . Jmat0^{-1} (in [k,d] layout:
        # F[k,m] = dx_k/dxi_d dxi_d/dX0_m)
        fv.F = jnp.einsum("qkd,qdm->qkm", Jmat, invJ0)
    else:
        # without mesh motion the reference configuration IS the current one;
        # alias so total-Lagrangian equations (solid mechanics in the
        # reference's LAGRANGIAN mode, src/mm_fill_solid.c) work standalone
        fv.X0 = fv.x
        fv.wdetJ0 = fv.wdetJ

    gphi_cache: dict[str, jnp.ndarray] = {}
    gphi0_cache: dict[str, jnp.ndarray] = {}
    for s in slots:
        if s.interp == "N1":
            # Nedelec: covariant (Piola) transform N_phys = J^-T N_ref; the
            # curl transforms as curl_ref/detJ (2D scalar) or
            # J . curl_ref / detJ (3D vector)
            Nv = jnp.asarray(tables.Nvec[s.interp], dtype=dtype)
            Cv = jnp.asarray(tables.Ncurl[s.interp], dtype=dtype)
            Nphys = jnp.einsum("qid,qdk->qik", Nv, invJ)
            if dim == 3:
                Cphys = jnp.einsum("qkd,qid->qik", Jmat, Cv) / detJ[:, None, None]
            else:
                Cphys = Cv / detJ[:, None]
            c = u[s.var][0]  # (nbf,) edge circulations
            cdot = udot[s.var][0]
            fv.phi[s.var] = Nphys  # (nq, nbf, dim) vector test functions
            fv.curl_phi[s.var] = Cphys
            fv.val[s.var] = jnp.einsum("qik,i->qk", Nphys, c)  # (nq, dim)
            if dim == 3:
                fv.curl[s.var] = jnp.einsum("qik,i->qk", Cphys, c)
            else:
                fv.curl[s.var] = jnp.einsum("qi,i->q", Cphys, c)
            fv.dot[s.var] = jnp.einsum("qik,i->qk", Nphys, cdot)
            continue
        Ni = jnp.asarray(tables.N[s.interp], dtype=dtype)
        dNi = jnp.asarray(tables.dN[s.interp], dtype=dtype)
        if s.interp not in gphi_cache:
            gphi_cache[s.interp] = jnp.einsum("qnd,qdk->qnk", dNi, invJ)
        gp = gphi_cache[s.interp]
        fv.phi[s.var] = Ni
        fv.gphi[s.var] = gp
        fv.val[s.var] = jnp.einsum("qn,cn->qc", Ni, u[s.var])
        fv.grad[s.var] = jnp.einsum("qnk,cn->qck", gp, u[s.var])
        fv.dot[s.var] = jnp.einsum("qn,cn->qc", Ni, udot[s.var])
        fv.q_nodal[s.var] = u[s.var]
        if s.interp not in ("P0", "P1E"):
            fv.lnodes[s.var] = tuple(interp_local_nodes(
                element_type(tables.elem_type).family, s.interp))
        if ale:
            if s.interp not in gphi0_cache:
                gphi0_cache[s.interp] = jnp.einsum("qnd,qdk->qnk", dNi, invJ0)
            gp0 = gphi0_cache[s.interp]
            fv.gphi0[s.var] = gp0
            fv.grad0[s.var] = jnp.einsum("qnk,cn->qck", gp0, u[s.var])
        else:
            fv.gphi0[s.var] = gp
            fv.grad0[s.var] = fv.grad[s.var]

    if ext_names:
        # frozen external nodal fields, interpolated with the geometric basis
        gphi_g = jnp.einsum("qnd,qdk->qnk", dNg, invJ)
        for k, name in enumerate(ext_names):
            e = ext_e[:, k]  # (n_geom_nodes,)
            fv.ext[name] = jnp.einsum("qn,n->q", Ng, e)
            fv.ext_grad[name] = jnp.einsum("qnk,n->qk", gphi_g, e)
    return fv


class CurveVars(FieldVars):
    """FieldVars for shell/curve elements (reference dimension < space
    dimension): BAR blocks embedded in a 2D mesh.

    Parity: the reference's shell element machinery (``src/mm_fill_shell.c``,
    ``src/mm_shell_util.c``): shell elements share mesh nodes with the bulk
    boundary, so shared variables couple automatically through the node-major
    dof map — no "friend element" gather is needed.

    Extra attributes:
      tangent  (nq, dim)  unit tangent along the curve
      normal   (nq, dim)  unit normal (tangent rotated -90 deg; for CCW bulk
                          boundaries this points OUT of the bulk)
      wds      (nq,)      arc-length quadrature weight
      dphi_ds[v] (nq, nbf) arc-length derivative of basis
      grad_s[v] (nq, ncomp) arc-length derivative of fields
      curvature (nq,)     signed curvature of the (displaced) curve
    """

    def __init__(self):
        super().__init__()
        self.tangent = None
        self.normal = None
        self.wds = None
        self.dphi_ds: dict[str, Any] = {}
        self.grad_s: dict[str, Any] = {}
        self.curvature = None
        # Hermite (I_H3) second arc-length derivatives
        self.d2s: dict[str, Any] = {}
        self.d2phi_ds2: dict[str, Any] = {}


def eval_surfvars(q_e, qdot_e, X_e, tables: BlockTables, slots, dtype,
                  ext_e=None, ext_names=()) -> CurveVars:
    """Field evaluation on a 2D shell element (QUAD/TRI) embedded in 3D.

    Parity: reference 3D shells (BILINEAR/BIQUAD_SHELL, TRISHELL,
    src/el_elm_info.c; shell machinery src/mm_fill_shell.c). Gradients are
    *surface* gradients (tangent-plane 3-vectors): grad_s u = J_s G^-1 du/dxi
    with J_s the (3, 2) tangent map and G = J_s^T J_s the first fundamental
    form; wdetJ integrates with sqrt(det G) dA."""
    u = _unpack(q_e, slots)
    udot = _unpack(qdot_e, slots)

    Ng = jnp.asarray(tables.Ng, dtype=dtype)
    dNg = jnp.asarray(tables.dNg, dtype=dtype)  # (nq, nn, 2)
    qwts = jnp.asarray(tables.qwts, dtype=dtype)

    Xc = X_e
    if MESH_VAR in u:
        Xc = X_e + u[MESH_VAR].T

    fv = CurveVars()
    fv.dim = Xc.shape[1]
    Js = jnp.einsum("qnd,nk->qkd", dNg, Xc)  # (nq, 3, 2)
    G = jnp.einsum("qkd,qke->qde", Js, Js)  # (nq, 2, 2) metric
    detG = G[:, 0, 0] * G[:, 1, 1] - G[:, 0, 1] * G[:, 1, 0]
    inv00 = G[:, 1, 1] / detG
    inv11 = G[:, 0, 0] / detG
    inv01 = -G[:, 0, 1] / detG
    Ginv = jnp.stack(
        [jnp.stack([inv00, inv01], axis=1), jnp.stack([inv01, inv11], axis=1)],
        axis=1,
    )
    dA = jnp.sqrt(jnp.maximum(detG, 1e-300))
    fv.wds = qwts * dA
    fv.wdetJ = fv.wds
    fv.detJ = dA
    fv.tangents = Js
    cr = jnp.cross(Js[:, :, 0], Js[:, :, 1])
    fv.normal = cr / jnp.linalg.norm(cr, axis=1, keepdims=True)
    fv.x = jnp.einsum("qn,nk->qk", Ng, Xc)
    fv.h_elem = jnp.sqrt(jnp.sum(fv.wds)) * jnp.ones_like(dA)

    # surface-gradient operator per interpolation: (nq, nbf, 3)
    proj = jnp.einsum("qkd,qde->qke", Js, Ginv)  # J_s G^-1
    for s in slots:
        Ni = jnp.asarray(tables.N[s.interp], dtype=dtype)
        dNi = jnp.asarray(tables.dN[s.interp], dtype=dtype)  # (nq, nbf, 2)
        gphi = jnp.einsum("qke,qne->qnk", proj, dNi)
        fv.phi[s.var] = Ni
        fv.gphi[s.var] = gphi
        fv.val[s.var] = jnp.einsum("qn,cn->qc", Ni, u[s.var])
        fv.grad[s.var] = jnp.einsum("qnk,cn->qck", gphi, u[s.var])
        fv.dot[s.var] = jnp.einsum("qn,cn->qc", Ni, udot[s.var])
    if ext_names:
        gphi_g = jnp.einsum("qke,qne->qnk", proj, dNg)
        for k, name in enumerate(ext_names):
            e = ext_e[:, k]
            fv.ext[name] = jnp.einsum("qn,n->q", Ng, e)
            fv.ext_grad[name] = jnp.einsum("qnk,n->qk", gphi_g, e)
    return fv


def eval_curvevars(q_e, qdot_e, X_e, tables: BlockTables, slots, dtype,
                   ext_e=None, ext_names=()) -> CurveVars:
    """Field evaluation on a BAR element embedded in 2D."""
    u = _unpack(q_e, slots)
    udot = _unpack(qdot_e, slots)

    Ng = jnp.asarray(tables.Ng, dtype=dtype)
    dNg = jnp.asarray(tables.dNg, dtype=dtype)  # (nq, nn, 1)
    qwts = jnp.asarray(tables.qwts, dtype=dtype)

    Xc = X_e
    if MESH_VAR in u:
        Xc = X_e + u[MESH_VAR].T

    fv = CurveVars()
    fv.dim = Xc.shape[1]
    dxds_ref = jnp.einsum("qn,nk->qk", dNg[:, :, 0], Xc)  # dx/dxi (nq, 2)
    mag = jnp.sqrt(jnp.sum(dxds_ref**2, axis=1) + 1e-300)
    fv.tangent = dxds_ref / mag[:, None]
    fv.normal = jnp.stack([fv.tangent[:, 1], -fv.tangent[:, 0]], axis=1)
    fv.wds = qwts * mag
    fv.wdetJ = fv.wds  # volume measure alias so generic kernels integrate
    fv.x = jnp.einsum("qn,nk->qk", Ng, Xc)
    fv.detJ = mag
    fv.h_elem = mag.sum() * 0 + jnp.sum(fv.wds)  # element length

    # curvature kappa = (x' x y'')/|x'|^3 via second FD of the map is omitted
    # until second-derivative tables exist; curve curvature from displaced
    # nodes is available through curvature projections instead.

    for s in slots:
        if s.interp == "H3":
            # Hermite cubic (I_H3): dofs [v1, v2, s1, s2] with s the PHYSICAL
            # arc-length slope; slope basis scales by ds/dxi = J per element
            # (straight BAR2: J constant), derivatives divide by J
            Nh, dNh, d2Nh = (jnp.asarray(a, dtype=dtype) for a in
                             tables.H3[s.interp])
            J = mag  # (nq,) ds/dxi
            sc = jnp.concatenate([jnp.ones((Nh.shape[0], 2), dtype=dtype),
                                  J[:, None] * jnp.ones((1, 2), dtype=dtype)],
                                 axis=1)
            phi = Nh * sc
            dphi = dNh * sc / J[:, None]
            d2phi = d2Nh * sc / (J**2)[:, None]
            c = u[s.var].reshape(-1)  # [v1, v2, s1, s2]
            cdot = udot[s.var].reshape(-1)
            fv.phi[s.var] = phi
            fv.dphi_ds[s.var] = dphi
            fv.d2phi_ds2[s.var] = d2phi
            fv.gphi[s.var] = dphi[:, :, None] * fv.tangent[:, None, :]
            fv.val[s.var] = jnp.einsum("qn,n->q", phi, c)[:, None]
            fv.grad_s[s.var] = jnp.einsum("qn,n->q", dphi, c)[:, None]
            fv.d2s[s.var] = jnp.einsum("qn,n->q", d2phi, c)[:, None]
            fv.grad[s.var] = fv.grad_s[s.var][:, :, None] * fv.tangent[:, None, :]
            fv.dot[s.var] = jnp.einsum("qn,n->q", phi, cdot)[:, None]
            continue
        Ni = jnp.asarray(tables.N[s.interp], dtype=dtype)
        dNi = jnp.asarray(tables.dN[s.interp], dtype=dtype)[:, :, 0]
        dphi = dNi / mag[:, None]
        fv.phi[s.var] = Ni
        fv.dphi_ds[s.var] = dphi
        # expose as gphi too: surface gradient (dphi/ds) t_k
        fv.gphi[s.var] = dphi[:, :, None] * fv.tangent[:, None, :]
        fv.val[s.var] = jnp.einsum("qn,cn->qc", Ni, u[s.var])
        fv.grad_s[s.var] = jnp.einsum("qn,cn->qc", dphi, u[s.var])
        fv.grad[s.var] = fv.grad_s[s.var][:, :, None] * fv.tangent[:, None, :]
        fv.dot[s.var] = jnp.einsum("qn,cn->qc", Ni, udot[s.var])
    if ext_names:
        for k, name in enumerate(ext_names):
            e = ext_e[:, k]
            fv.ext[name] = jnp.einsum("qn,n->q", Ng, e)
            dphi_g = dNg[:, :, 0] / mag[:, None]
            ds = jnp.einsum("qn,n->q", dphi_g, e)
            fv.ext_grad[name] = ds[:, None] * fv.tangent
    return fv
