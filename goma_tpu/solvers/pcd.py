"""PCD (pressure-convection-diffusion) Schur-complement preconditioner.

Parity: reference ``src/sl_petsc_pcd.c`` (``PCDShellPCApply:115``) with the
pressure-space operators assembled in ``src/sl_petsc.c set_pcd_matrices:390``:

    Mp    = int phi_i phi_j                      (pressure mass)
    Mp_mu = 0.5/mu * Mp                          (viscous-scaled mass)
    Ap    = int mu grad(phi_i) . grad(phi_j)     (viscous pressure Laplacian)
    Fp    = Ap + int rho (u . grad phi_j) phi_i  (+ rho*ct * Mp transient)

    S^-1 r_p  ~=  Ap^-1 Fp Mp^-1 r_p  +  Mp_mu^-1 r_p

combined with block-Jacobi Richardson sweeps on the velocity block (the
block-triangular field split). Redesign of the PETSc machinery:

- Ap is formed once on host (static geometry) and turned into an explicit
  dense f32 inverse — each application is one dense matmul instead of an inner
  KSP solve;
- Fp is *matrix-free*: the convection term is re-evaluated from the current
  velocity at quadrature points (stored at factor time), so no sparse
  pressure matrix is ever rebuilt;
- Mp is lumped (the reference's ``pcd_inverse_diag`` option);
- the reference's pcd_ss_remove/pcd_ns_remove row removal maps to
  ``remove_nodesets`` (Dirichlet-identity rows in Ap/Fp).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from goma_tpu.elements import (
    element_type,
    eval_basis,
    geom_interp,
    interp_local_nodes,
    volume_rule,
)
from goma_tpu.solvers.linear import BlockJacobi


class PCDFieldSplit:
    """Block-triangular field split with a PCD Schur approximation."""

    def __init__(self, problem, pressure_var: str = "pressure",
                 vel_var: str = "velocity", mu: float = 1.0, rho: float = 1.0,
                 u_sweeps: int = 2, remove_nodesets=(), max_dense: int = 20000):
        dofmap = problem.dofmap
        pattern = problem.pattern
        mesh = problem.mesh
        self.bj = BlockJacobi(pattern, dofmap)
        self.n = pattern.n
        self.u_sweeps = u_sweeps
        self.mu, self.rho = float(mu), float(rho)

        # ---- pressure dof numbering (compressed)
        sv = dofmap.svar(pressure_var)
        pd = dofmap.dof_of_node_svar[:, sv]
        pdofs = np.unique(pd[pd >= 0])
        np_p = pdofs.shape[0]
        if np_p > max_dense:
            raise ValueError(f"PCD dense Ap inverse: {np_p} pressure dofs > {max_dense}")
        self.np_p = np_p
        pidx = np.full(pattern.n, -1, dtype=np.int64)
        pidx[pdofs] = np.arange(np_p)
        pmask = np.zeros(pattern.n, dtype=bool)
        pmask[pdofs] = True
        self.pmask = jnp.asarray(pmask)

        # ---- per-block pressure/velocity quadrature tables (host, static)
        Ap = np.zeros((np_p, np_p))
        Mp_diag = np.zeros(np_p)
        self._blocks = []
        tables = dict(self.bj.tables)
        for bi, (bd, blk) in enumerate(zip(dofmap.blocks, mesh.blocks)):
            try:
                ps = bd.slot(pressure_var)
                vs = bd.slot(vel_var)
            except KeyError:
                continue
            if ps.interp in ("P0", "P1E"):
                continue
            et = element_type(blk.elem_type)
            dim = et.dim
            qpts, qwts = volume_rule(et.family, problem.quad_order)
            Ng, dNg = eval_basis(et.family, geom_interp(et), qpts)
            Npb, dNp = eval_basis(et.family, ps.interp, qpts)
            Nv, _ = eval_basis(et.family, vs.interp, qpts)
            X = mesh.coords[blk.conn]  # (ne, nn, dim)
            J = np.einsum("qnd,enk->eqkd", dNg, X)
            detJ = np.abs(np.linalg.det(J))
            invJ = np.linalg.inv(J)  # (ne, nq, d, k): dxi_d/dx_k
            gNp = np.einsum("qnd,eqdk->eqnk", dNp, invJ)  # physical grads
            w = detJ * qwts[None, :]  # (ne, nq)

            ln = list(interp_local_nodes(et.family, ps.interp))
            pn = pidx[dofmap.dof_of_node_svar[blk.conn[:, ln], sv]]  # (ne, nbp)
            # velocity local dofs in the element gather, (ne, dim, nbv)
            vg = bd.gather[:, vs.start : vs.start + vs.size].reshape(
                -1, vs.ncomp, vs.nbf
            )

            # static Ap and lumped Mp
            Ap_e = self.mu * np.einsum("eq,eqik,eqjk->eij", w, gNp, gNp)
            np.add.at(Ap, (pn[:, :, None], pn[:, None, :]), Ap_e)
            np.add.at(Mp_diag, pn.ravel(),
                      np.einsum("eq,qi->ei", w, Npb).ravel())

            self._blocks.append(bi)
            tables[f"pcd:pn{bi}"] = jax.device_put(pn)
            tables[f"pcd:vg{bi}"] = jax.device_put(vg.astype(np.int64))
            tables[f"pcd:w{bi}"] = jax.device_put(w)
            tables[f"pcd:Np{bi}"] = jax.device_put(Npb)
            tables[f"pcd:Nv{bi}"] = jax.device_put(Nv)
            tables[f"pcd:gNp{bi}"] = jax.device_put(gNp)

        # ---- boundary handling (reference pcd_ss/ns_remove): identity rows.
        # Default: pin the dofs that are Dirichlet rows in the global system
        # (e.g. a pinned pressure node); if none, pin dof 0 to fix the
        # Neumann null space of Ap.
        rm = []
        for ns in remove_nodesets:
            nodes = mesh.nodesets[ns]
            d = pidx[dofmap.dof_of_node_svar[nodes, sv]]
            rm.extend(d[d >= 0].tolist())
        if hasattr(problem, "dirichlet_dofs") and problem.dirichlet_dofs.size:
            d = pidx[problem.dirichlet_dofs]
            rm.extend(d[d >= 0].tolist())
        if not rm:
            rm = [0]
        rm = np.unique(np.asarray(rm, dtype=np.int64))
        Ap[rm, :] = 0.0
        Ap[:, rm] = 0.0
        Ap[rm, rm] = 1.0
        rmask = np.zeros(np_p, dtype=bool)
        rmask[rm] = True
        tables["pcd:rmask"] = jax.device_put(rmask)

        # dense inverse once (static geometry/viscosity); f32 is plenty for a
        # preconditioner, and each application is one (np, np) matmul
        Ap_inv = np.linalg.inv(Ap).astype(np.float32)
        tables["pcd:Apinv"] = jax.device_put(Ap_inv)
        inv_mp = np.where(Mp_diag > 0, 1.0 / np.maximum(Mp_diag, 1e-300), 0.0)
        tables["pcd:invMp"] = jax.device_put(inv_mp)
        # scatter pressure-space vector to/from global dofs
        tables["pcd:pdofs"] = jax.device_put(pdofs.astype(np.int64))
        self.tables = tables

    # ---------------------------------------------------------------- factor
    def factor(self, vals, xcur, ct, tb=None):
        """Binv for the velocity sweeps + current velocity at pressure-block
        quadrature points (drives the matrix-free Fp convection)."""
        tb = tb or self.tables
        Binv = self.bj.factor(vals)
        uqp = []
        for bi in self._blocks:
            vg = tb[f"pcd:vg{bi}"]
            Nv = tb[f"pcd:Nv{bi}"].astype(vals.dtype)
            ue = xcur.astype(vals.dtype)[vg]  # (ne, dim, nbv)
            uqp.append(jnp.einsum("qn,ean->eqa", Nv, ue))
        return (Binv, tuple(uqp), jnp.asarray(ct, dtype=vals.dtype))

    # ------------------------------------------------------------ Fp matvec
    def _fp_apply(self, a, uqp, ct, tb, dtype):
        """Fp a in pressure space: mu grad-grad + rho u.grad + rho ct mass."""
        out = jnp.zeros(self.np_p, dtype=dtype)
        # removed (Dirichlet-identity) dofs do not participate in the
        # integrals — mirrors the zeroed columns of the stored Ap, so that
        # Ap^-1 Fp == I exactly in the Stokes/steady limit
        a_in = jnp.where(tb["pcd:rmask"], 0.0, a)
        a_ext = jnp.concatenate([a_in, jnp.zeros(1, dtype=dtype)])
        for k, bi in enumerate(self._blocks):
            pn = tb[f"pcd:pn{bi}"]
            w = tb[f"pcd:w{bi}"].astype(dtype)
            Npb = tb[f"pcd:Np{bi}"].astype(dtype)
            gNp = tb[f"pcd:gNp{bi}"].astype(dtype)
            ae = a_ext[pn]  # (ne, nbp)
            ga = jnp.einsum("eqnk,en->eqk", gNp, ae)
            aq = jnp.einsum("qn,en->eq", Npb, ae)
            diff = self.mu * jnp.einsum("eq,eqik,eqk->ei", w, gNp, ga)
            conv = self.rho * jnp.einsum("eq,eqk,eqk,qi->ei", w, uqp[k], ga, Npb)
            mass = (self.rho * ct) * jnp.einsum("eq,eq,qi->ei", w, aq, Npb)
            out = out + jax.ops.segment_sum(
                (diff + conv + mass).reshape(-1), pn.reshape(-1),
                num_segments=self.np_p)
        return jnp.where(tb["pcd:rmask"], a, out)

    # ----------------------------------------------------------------- apply
    def apply(self, fac, r):
        Binv, uqp, ct, matvec = fac
        tb = self.tables
        dtype = r.dtype
        pm = self.pmask
        r_u = jnp.where(pm, 0.0, r)
        z = self.bj.apply(Binv, r_u)
        z = jnp.where(pm, 0.0, z)
        for _ in range(self.u_sweeps - 1):
            resid = r_u - jnp.where(pm, 0.0, matvec(z))
            z = z + jnp.where(pm, 0.0, self.bj.apply(Binv, resid))
        r_p_full = jnp.where(pm, r - matvec(z), 0.0)
        rp = r_p_full[tb["pcd:pdofs"]]
        invMp = tb["pcd:invMp"].astype(dtype)
        # y = Ap^-1 Fp Mp^-1 rp + 2 mu Mp^-1 rp   (PCDShellPCApply order;
        # Mp_mu^-1 = 2 mu Mp^-1)
        a = invMp * rp
        b = self._fp_apply(a, uqp, ct, tb, dtype)
        with jax.default_matmul_precision("highest"):
            y = (tb["pcd:Apinv"] @ b.astype(jnp.float32)).astype(dtype)
        y = y + 2.0 * self.mu * invMp * rp
        z_p = jnp.zeros(self.n, dtype=dtype).at[tb["pcd:pdofs"]].set(y)
        return z + jnp.where(pm, z_p, 0.0)
