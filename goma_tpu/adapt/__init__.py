"""Mesh adaptivity: error indicators, remesh-on-host, solution transfer.

Parity: reference ``src/adapt/omega_h_interface.cpp`` (``adapt_mesh_omega_h
:1325`` — metric-driven AMR with solution transfer) and
``src/adapt/resetup_problem.c``. Redesign: dynamic mesh topology
would trigger re-jit storms device-side, so adaptation runs fully on host
between solves — an error indicator picks the new resolution, a NEW mesh is
generated (any generator/reader), the solution (and xdot for transients) is
transferred by isoparametric interpolation, and a fresh ``Problem`` is
finalized (the resetup_problem analog). The transient driver then continues
on the new problem, exactly like the reference's in-run adapt hook
(``src/rf_solve.c:1843``).
"""

from __future__ import annotations

import numpy as np

from goma_tpu.elements import element_type, eval_basis, geom_interp, interp_local_nodes, volume_rule


def zz_error_indicator(problem, x, var: str, comp: int = 0) -> np.ndarray:
    """Zienkiewicz-Zhu recovery error indicator per element (concatenated
    over blocks): eta_e^2 = int_e |grad u_h - G(u_h)|^2, with G the lumped
    L2-projected (recovered) nodal gradient. The role of the reference's
    adapt metric sources (omega_h_interface.cpp metric construction)."""
    mesh = problem.mesh
    dofmap = problem.dofmap
    x = np.asarray(x)
    dim = mesh.dim

    # pass 1: recovered nodal gradient (lumped projection)
    Gnum = np.zeros((mesh.n_nodes, dim))
    Gden = np.zeros(mesh.n_nodes)
    elem_tabs = []
    for bd, blk in zip(dofmap.blocks, mesh.blocks):
        try:
            s = bd.slot(var)
        except KeyError:
            elem_tabs.append(None)
            continue
        et = element_type(blk.elem_type)
        qpts, qwts = volume_rule(et.family, problem.quad_order)
        Ng, dNg = eval_basis(et.family, geom_interp(et), qpts)
        Ni, dNi = eval_basis(et.family, s.interp, qpts)
        X = mesh.coords[blk.conn]
        J = np.einsum("qnd,enk->eqkd", dNg, X)
        detJ = np.abs(np.linalg.det(J))
        invJ = np.linalg.inv(J)
        gN = np.einsum("qnd,eqdk->eqnk", dNi, invJ)
        w = detJ * qwts[None, :]
        ln = list(interp_local_nodes(et.family, s.interp))
        dofs = dofmap.dof_of_node_svar[blk.conn[:, ln], dofmap.svar(var, comp)]
        ue = x[dofs]  # (ne, nbf)
        gu = np.einsum("eqnk,en->eqk", gN, ue)  # (ne, nq, dim)
        nodes = blk.conn[:, ln]
        num = np.einsum("eq,qi,eqk->eik", w, Ni, gu)
        den = np.einsum("eq,qi->ei", w, Ni)
        np.add.at(Gnum, nodes.reshape(-1), num.reshape(-1, dim))
        np.add.at(Gden, nodes.reshape(-1), den.reshape(-1))
        elem_tabs.append((s, Ni, gN, w, nodes, gu))
    G = Gnum / np.maximum(Gden, 1e-300)[:, None]

    # pass 2: element error against the recovered gradient
    etas = []
    for tab in elem_tabs:
        if tab is None:
            continue
        s, Ni, gN, w, nodes, gu = tab
        Ge = G[nodes]  # (ne, nbf, dim)
        Gq = np.einsum("qi,eik->eqk", Ni, Ge)
        diff = gu - Gq
        etas.append(np.sqrt(np.einsum("eq,eqk->e", w, diff * diff)))
    return np.concatenate(etas) if etas else np.zeros(0)


def transfer_solution(old_problem, x_old, new_problem,
                      xdot_old=None) -> np.ndarray | tuple:
    """Interpolate a solution vector from one Problem onto another's dof
    vector (reference: omega_h solution transfer + resetup). New nodes
    outside the old mesh (boundary roundoff) fall back to the nearest old
    node's value. Returns x_new (and xdot_new if xdot_old was given)."""
    from goma_tpu.post.particles import FieldSampler
    from scipy.spatial import cKDTree

    sampler = FieldSampler(old_problem)
    old_mesh = old_problem.mesh
    tree = cKDTree(old_mesh.coords)
    outs = []
    for vec in ([x_old] if xdot_old is None else [x_old, xdot_old]):
        vec = np.asarray(vec)
        x_new = np.zeros(new_problem.dofmap.n_dof)
        for v in new_problem.dofmap.vars:
            if v.name not in old_problem.dofmap.svar_offset:
                continue
            for c in range(v.ncomp):
                sv_new = new_problem.dofmap.svar(v.name, c)
                dnew = new_problem.dofmap.dof_of_node_svar[:, sv_new]
                active = np.where(dnew >= 0)[0]
                if active.size == 0:
                    continue
                pts = new_problem.mesh.coords[active]
                vals = np.asarray(sampler.sample(vec, v.name, pts, comp=c))
                bad = ~np.isfinite(vals)
                if np.any(bad):
                    _, nn = tree.query(pts[bad])
                    sv_old = old_problem.dofmap.svar(v.name, c)
                    dold = old_problem.dofmap.dof_of_node_svar[nn, sv_old]
                    ok = dold >= 0
                    fill = np.zeros(nn.shape[0])
                    fill[ok] = vec[dold[ok]]
                    vals[bad] = fill
                x_new[dnew[active]] = vals
        outs.append(x_new)
    return outs[0] if xdot_old is None else tuple(outs)


def refine_factor_from_indicator(eta: np.ndarray, target_abs: float,
                                 p: int = 1, max_factor: int = 4) -> int:
    """Suggested uniform refinement factor so the estimated global error
    ``||eta||_2`` drops to ``target_abs``, using the a-priori rate
    ``eta ~ h^p``: halving h divides the error by ``2^p``, so the factor is
    ``ceil((||eta||/target)^(1/p))``. Already below target -> 1."""
    if eta.size == 0:
        return 1
    eta_norm = float(np.sqrt(np.sum(np.asarray(eta, dtype=float) ** 2)))
    if eta_norm <= target_abs or target_abs <= 0.0:
        return 1
    return int(np.clip(np.ceil((eta_norm / target_abs) ** (1.0 / max(p, 1))),
                       1, max_factor))


from goma_tpu.adapt.local_amr import (mark_ls_band, mark_top_fraction,
                                      red_green_refine, triangulate_mesh)
