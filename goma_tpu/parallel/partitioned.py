"""Partitioned-DOF distributed Newton-Krylov (sharding v2).

Parity: the reference's actual parallel design (SURVEY §2.4) —
METIS element partitioning (``src/metis_decomp.c:372``), one-layer ghost
elements (``src/dp_ghost.cpp:71 generate_ghost_elems``), halo exchange of
the solution vector (``src/dp_comm.c:48 exchange_dof``), and
owner-computes assembled rows. Redesign:

- Host: RCB element partition -> node/dof ownership (a node belongs to the
  lowest part among its touching elements) -> per-device local index space
  ``[owned..., halo...]`` padded to common sizes for SPMD.
- Each device assembles its owned elements PLUS the ghost layer (every
  element touching an owned dof), so every owned matrix row / residual
  entry is complete locally — no reverse scatter communication at all
  (the dp_ghost trade: duplicated surface work for zero fold traffic).
- ``exchange_dof`` -> a fixed set of ``ppermute`` rounds over the device
  ring, one per partition-graph offset (RCB orderings give a handful),
  with host-precomputed send/recv position tables.
- Kylov: GMRES over owned-slice vectors; dot products and norms are the
  ONLY collectives (``psum``), matching ``L2_norm``'s MPI_Allreduce
  (``src/mm_sol_nonlinear.c:2720``); preconditioner is node-block Jacobi
  over owned nodes — fully local because a node's dofs share an owner.

Per-device memory is O(N/n_dev): owned + halo dofs, local elements, and
the owned-rows local CSR. Nothing global-sized lives on any device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


@dataclass
class PartitionedResult:
    x: np.ndarray
    converged: bool
    iters: int
    res_norms: list
    linear_iters: list


class PartitionedProblem:
    """Distributed wrapper of a finalized Problem.

    Covers volume blocks, face (weak/integrated) kernels, edge-curve
    kernels, interface pairs, overset (immersed-curve multiplier) rows,
    cross-equation row injection (add_row_inject), Dirichlet and rotated
    BCs, and external nodal fields. Row-sum scaling (not symmetric);
    block-Jacobi / Vanka / two-level / distributed-NDLU preconditioning.
    """

    def __init__(self, problem, device_mesh: Mesh | None = None,
                 axis: str = "dofs", partition_method: str = "auto"):
        if device_mesh is None:
            device_mesh = Mesh(np.array(jax.devices()), (axis,))
        self.problem = problem
        self.axis = axis
        self.device_mesh = device_mesh
        nd = int(device_mesh.devices.size)
        self.n_dev = nd
        dm = problem.dofmap
        mesh = problem.mesh
        n = dm.n_dof

        # ---- element partition (all blocks concatenated), reference
        # goma_metis_decomposition: multilevel KWAY over the element dual
        # graph by default (minimizes the halo the ppermute exchange
        # carries), RCB as the -rcb analog
        from goma_tpu.mesh.partition import partition_elements

        epart = partition_elements(mesh, nd, method=partition_method)
        eoff = np.cumsum([0] + [b.n_elem for b in mesh.blocks])

        # ---- node / dof ownership: lowest part among touching elements
        node_owner = np.full(mesh.n_nodes, nd, dtype=np.int32)
        for bi, b in enumerate(mesh.blocks):
            pe = epart[eoff[bi]:eoff[bi + 1]]
            for le in range(b.n_elem):
                nds = b.conn[le]
                node_owner[nds] = np.minimum(node_owner[nds], pe[le])
        dof_owner = np.full(n, -1, dtype=np.int32)
        nodal = dm.node_dof_count > 0
        for nid in np.where(nodal)[0]:
            s, c = dm.node_dof_start[nid], dm.node_dof_count[nid]
            dof_owner[s:s + c] = node_owner[nid]
        # elemental dofs follow their element's part
        for bi, (bd, b) in enumerate(zip(dm.blocks, mesh.blocks)):
            pe = epart[eoff[bi]:eoff[bi + 1]]
            for sl in bd.slots:
                if sl.interp in ("P0", "P1E"):
                    g = bd.gather[:, sl.start:sl.start + sl.size]
                    for le in range(b.n_elem):
                        dof_owner[g[le]] = pe[le]
        assert np.all(dof_owner >= 0)

        # ---- per-device sets
        owned = [np.where(dof_owner == d)[0] for d in range(nd)]
        # local elements: any element with an owned dof (own + ghost layer)
        loc_elems = [[] for _ in range(nd)]
        for bi, (bd, b) in enumerate(zip(dm.blocks, mesh.blocks)):
            gow = dof_owner[bd.gather]  # (ne, nl)
            for d in range(nd):
                sel = np.where(np.any(gow == d, axis=1))[0]
                loc_elems[d].append(sel)
        # interface pairs: each side's partner element joins the local set
        # wherever the other side is local (a pair assembles where its rows
        # are owned and needs BOTH elements' dofs; the partner's own volume
        # contributions land only on non-owned rows and are masked away)
        for s in problem.ifc_sets:
            ea = np.asarray(s.elems_a)
            eb = np.asarray(s.elems_b)
            for d in range(nd):
                la = np.zeros(mesh.blocks[s.block_a].n_elem, dtype=bool)
                la[loc_elems[d][s.block_a]] = True
                lb = np.zeros(mesh.blocks[s.block_b].n_elem, dtype=bool)
                lb[loc_elems[d][s.block_b]] = True
                sel = la[ea] | lb[eb]
                loc_elems[d][s.block_a] = np.unique(np.concatenate(
                    [loc_elems[d][s.block_a], ea[sel]])).astype(np.int64)
                loc_elems[d][s.block_b] = np.unique(np.concatenate(
                    [loc_elems[d][s.block_b], eb[sel]])).astype(np.int64)

        # overset (immersed-curve) rows: a row assembles on every device
        # owning ANY of its gathered dofs (the curve
        # blocks are small — replicate the coupling rows across the owners
        # instead of routing the reference's globally-coupled overlap ACs,
        # src/mm_augc_util.c:2914, through collectives). The row machinery
        # is element-loop-free (per-row basis tables, _ovs_contribs), so
        # the only partitioned requirement is that each assembling device
        # holds the row's full dof gather in owned+halo.
        ovs_sel = []
        ovs_need = [[] for _ in range(nd)]
        for s in problem.ovs_sets:
            gat_g = s.gather.astype(np.int64)
            gow = dof_owner[gat_g]
            sel = [np.flatnonzero(np.any(gow == d, axis=1))
                   for d in range(nd)]
            ovs_sel.append(sel)
            for d in range(nd):
                if sel[d].size:
                    ovs_need[d].append(gat_g[sel[d]].ravel())

        # halo dofs per device (element-touched union overset-row gathers)
        halos = []
        for d in range(nd):
            touched = [dm.blocks[bi].gather[loc_elems[d][bi]].ravel()
                       for bi in range(len(dm.blocks))] + ovs_need[d]
            touched = np.unique(np.concatenate(touched))
            halos.append(touched[dof_owner[touched] != d])

        self.max_own = max(int(o.shape[0]) for o in owned)
        self.max_halo = max(max(int(h.shape[0]) for h in halos), 1)
        self.max_loc = self.max_own + self.max_halo
        mo, ml = self.max_own, self.max_loc

        # global dof ids per local slot; pad owned with n (sentinel)
        own_g = np.full((nd, mo), n, dtype=np.int64)
        own_mask = np.zeros((nd, mo))
        loc_g = np.full((nd, ml), n, dtype=np.int64)
        l_of_g = [dict() for _ in range(nd)]
        for d in range(nd):
            o, h = owned[d], halos[d]
            own_g[d, :o.shape[0]] = o
            own_mask[d, :o.shape[0]] = 1.0
            loc_g[d, :o.shape[0]] = o
            loc_g[d, mo:mo + h.shape[0]] = h
            for i, g in enumerate(o):
                l_of_g[d][int(g)] = i
            for i, g in enumerate(h):
                l_of_g[d][int(g)] = mo + i
        self._own_g = own_g
        self._own_mask = own_mask
        self._dof_owner = dof_owner
        self._owned = owned

        # ---- halo-exchange schedule: ppermute rounds per ring offset
        # (reference exchange_dof's neighbor lists, src/dp_comm.c:48)
        need: dict[int, list[list[tuple[int, int]]]] = {}
        for d in range(nd):
            for g in halos[d]:
                s = int(dof_owner[g])
                delta = (d - s) % nd
                need.setdefault(delta, [[] for _ in range(nd)])
                # sender s must ship its owned slot of g to receiver d
                need[delta][s].append((l_of_g[s][int(g)], l_of_g[d][int(g)]))
        self._deltas = sorted(need.keys())
        send_tabs, recv_tabs = [], []
        for delta in self._deltas:
            cnt = max(max(len(v) for v in need[delta]), 1)
            sp = np.zeros((nd, cnt), dtype=np.int64)  # positions in own vec
            rp = np.full((nd, cnt), ml, dtype=np.int64)  # sentinel -> dropped
            for s in range(nd):
                r = (s + delta) % nd
                # entries sent by s land at r: recv positions indexed by r
                for k, (spos, rpos) in enumerate(need[delta][s]):
                    sp[s, k] = spos
                for k, (spos, rpos) in enumerate(need[delta][s]):
                    rp[r, k] = rpos
            send_tabs.append(sp)
            recv_tabs.append(rp)
        self._send_tabs = send_tabs
        self._recv_tabs = recv_tabs

        # ---- local element tables (per block), padded to max count
        self._eblocks = []
        for bi, (bd, b) in enumerate(zip(dm.blocks, mesh.blocks)):
            nl = bd.n_ldof
            mx = max(max(len(loc_elems[d][bi]) for d in range(nd)), 1)
            gat = np.full((nd, mx, nl), ml, dtype=np.int64)
            Xr = np.zeros((nd, mx) + mesh.coords[b.conn].shape[1:])
            wm = np.zeros((nd, mx))
            # geometry-node connectivity (global ids): external (frozen)
            # nodal fields are replicated in params, gathered per element
            cn = np.zeros((nd, mx, b.conn.shape[1]), dtype=np.int64)
            # Nedelec edge-dof orientation signs follow their element into
            # the local tables (dofmap.edge_signs; identical conjugation to
            # the single-device path)
            sg = (np.ones((nd, mx, nl))
                  if bd.edge_signs is not None else None)
            for d in range(nd):
                sel = loc_elems[d][bi]
                for k, le in enumerate(sel):
                    gat[d, k] = [l_of_g[d].get(int(g), ml)
                                 for g in bd.gather[le]]
                    Xr[d, k] = mesh.coords[b.conn[le]]
                    cn[d, k] = b.conn[le]
                    wm[d, k] = 1.0
                    if sg is not None:
                        sg[d, k] = bd.edge_signs[le]
            self._eblocks.append(dict(bi=bi, gather=gat, Xref=Xr, wmask=wm,
                                      nl=nl, signs=sg, conn=cn))

        # ---- local owned-rows CSR (per device, padded): rows = owned local
        # ids, cols = local ids; nnz map for each local element's (i, j)
        pat = problem.pattern
        rows_g = pat.rows
        cols_g = pat.indices
        sel_nnz = []
        for d in range(nd):
            sel = np.where(dof_owner[rows_g] == d)[0]
            sel_nnz.append(sel)
        self.max_nnz = max(int(s.shape[0]) for s in sel_nnz)
        lrow = np.zeros((nd, self.max_nnz), dtype=np.int64)
        lcol = np.full((nd, self.max_nnz), ml, dtype=np.int64)
        nnz_mask = np.zeros((nd, self.max_nnz))
        # global nnz position -> local position (per device) for elem maps
        g2l_nnz = [dict() for _ in range(nd)]
        for d in range(nd):
            s = sel_nnz[d]
            for k, p in enumerate(s):
                lrow[d, k] = l_of_g[d][int(rows_g[p])]
                lcol[d, k] = l_of_g[d].get(int(cols_g[p]), ml)
                g2l_nnz[d][int(p)] = k
            nnz_mask[d, :s.shape[0]] = 1.0
        self._lrow, self._lcol, self._nnz_mask = lrow, lcol, nnz_mask
        self._g2l_nnz = g2l_nnz  # kept for lazily-built preconditioners

        for eb in self._eblocks:
            bi = eb["bi"]
            nl = eb["nl"]
            nmap_g = problem._nnz_maps[bi]  # (ne, nl, nl) global nnz pos
            mx = eb["gather"].shape[1]
            lmap = np.full((nd, mx, nl, nl), self.max_nnz, dtype=np.int64)
            for d in range(nd):
                sel = loc_elems[d][bi]
                for k, le in enumerate(sel):
                    m = nmap_g[le]
                    flat = [g2l_nnz[d].get(int(p), self.max_nnz)
                            for p in m.ravel()]
                    lmap[d, k] = np.asarray(flat).reshape(nl, nl)
            eb["nmap"] = lmap

        # ---- row-inject pairs (add_row_inject): both rows of a pair live
        # at the SAME mesh node (dofmap resolution in finalize) and a
        # node's dofs share an owner, so the cross-equation row move is
        # FULLY LOCAL on that owner: its owned rows are complete
        # pre-injection (owner-computes ghost rule) and both rows' nnz
        # segments sit in its local CSR. Reference: SH_FLUID_STRESS-style
        # bulk->shell row moves under domain decomposition
        # (src/dp_ghost.cpp owner rows, src/mm_fill.c load_lec).
        inj = getattr(problem, "_inject", None)
        self._inj = inj is not None
        if self._inj:
            fr_g, tr_g = inj["from_rows"], inj["to_rows"]
            assert np.all(dof_owner[fr_g] == dof_owner[tr_g]), \
                "row-inject pair split across owners (non-nodal pair?)"
            sel_r = [np.flatnonzero(dof_owner[tr_g] == d)
                     for d in range(nd)]
            mxr_ = max(max(s.shape[0] for s in sel_r), 1)
            ito = np.full((nd, mxr_), ml, dtype=np.int64)
            ifr = np.full((nd, mxr_), ml, dtype=np.int64)
            isg = np.zeros((nd, mxr_))
            fp_g, tp_g = inj["from_pos"], inj["to_pos"]
            row_of_tp = rows_g[tp_g]
            sel_p = [np.flatnonzero(dof_owner[row_of_tp] == d)
                     for d in range(nd)]
            mxp_ = max(max(s.shape[0] for s in sel_p), 1)
            itp = np.full((nd, mxp_), self.max_nnz, dtype=np.int64)
            ifp = np.full((nd, mxp_), self.max_nnz, dtype=np.int64)
            ips = np.zeros((nd, mxp_))
            for d in range(nd):
                for k, i in enumerate(sel_r[d]):
                    ito[d, k] = l_of_g[d][int(tr_g[i])]
                    ifr[d, k] = l_of_g[d][int(fr_g[i])]
                    isg[d, k] = inj["sign_rows"][i]
                for k, i in enumerate(sel_p[d]):
                    itp[d, k] = g2l_nnz[d][int(tp_g[i])]
                    ifp[d, k] = g2l_nnz[d][int(fp_g[i])]
                    ips[d, k] = inj["sign_pos"][i]
            self._inj_tabs = dict(to=ito, frm=ifr, sgnr=isg,
                                  tpos=itp, fpos=ifp, psign=ips)

        # ---- local face-kernel tables (weak/integrated BCs): a face is
        # assembled on every device whose local (owned+ghost) element set
        # contains its parent element; non-owned rows land on sentinel
        # positions and are sliced away — identical owner-computes rule to
        # the volume blocks (reference: boundary faces live with their
        # element's partition, src/dp_ghost.cpp)
        self._fblocks = []
        for fsi, fs in enumerate(problem.face_sets):
            bi = fs.block_index
            bd = dm.blocks[bi]
            b = mesh.blocks[bi]
            nl = bd.n_ldof
            fe = fs.face_elems
            gat_g = bd.gather[fe]                # (nf, nl)
            Xr_g = mesh.coords[b.conn[fe]]
            nmap_g = problem._nnz_maps[bi][fe]   # (nf, nl, nl)
            loc_set = [set(int(v) for v in loc_elems[d][bi])
                       for d in range(nd)]
            sel_f = [np.asarray([i for i, le in enumerate(fe)
                                 if int(le) in loc_set[d]], dtype=np.int64)
                     for d in range(nd)]
            mx = max(max(s.shape[0] for s in sel_f), 1)
            gat = np.full((nd, mx, nl), ml, dtype=np.int64)
            Xr = np.zeros((nd, mx) + Xr_g.shape[1:])
            wm = np.zeros((nd, mx))
            lmap = np.full((nd, mx, nl, nl), self.max_nnz, dtype=np.int64)
            ft = {k: np.zeros((nd, mx) + np.asarray(v).shape[1:])
                  for k, v in fs.ftabs.items()}
            for d in range(nd):
                for k, fi in enumerate(sel_f[d]):
                    gat[d, k] = [l_of_g[d].get(int(g), ml)
                                 for g in gat_g[fi]]
                    Xr[d, k] = Xr_g[fi]
                    wm[d, k] = 1.0
                    lmap[d, k] = np.asarray(
                        [g2l_nnz[d].get(int(p), self.max_nnz)
                         for p in nmap_g[fi].ravel()]).reshape(nl, nl)
                    for kk, v in fs.ftabs.items():
                        ft[kk][d, k] = np.asarray(v)[fi]
            self._fblocks.append(dict(fsi=fsi, gather=gat, Xref=Xr,
                                      wmask=wm, nmap=lmap, ftabs=ft))

        # ---- local edge-curve kernel tables (3D sideset-intersection BCs,
        # bc_curve.c analog): same owner-computes rule as the face sets
        self._edblocks = []
        for esi, es in enumerate(getattr(problem, "edge_sets", []) or []):
            bi = es.block_index
            bd = dm.blocks[bi]
            b = mesh.blocks[bi]
            nl = bd.n_ldof
            fe = es.edge_elems
            gat_g = bd.gather[fe]
            Xr_g = mesh.coords[b.conn[fe]]
            nmap_g = problem._nnz_maps[bi][fe]
            loc_set = [set(int(v) for v in loc_elems[d][bi])
                       for d in range(nd)]
            sel_f = [np.asarray([i for i, le in enumerate(fe)
                                 if int(le) in loc_set[d]], dtype=np.int64)
                     for d in range(nd)]
            mx = max(max(s_.shape[0] for s_ in sel_f), 1)
            gat = np.full((nd, mx, nl), ml, dtype=np.int64)
            Xr = np.zeros((nd, mx) + Xr_g.shape[1:])
            wm = np.zeros((nd, mx))
            lmap = np.full((nd, mx, nl, nl), self.max_nnz, dtype=np.int64)
            et = {k: np.zeros((nd, mx) + np.asarray(v).shape[1:])
                  for k, v in es.etabs.items()}
            for d in range(nd):
                for k, fi in enumerate(sel_f[d]):
                    gat[d, k] = [l_of_g[d].get(int(g), ml)
                                 for g in gat_g[fi]]
                    Xr[d, k] = Xr_g[fi]
                    wm[d, k] = 1.0
                    lmap[d, k] = np.asarray(
                        [g2l_nnz[d].get(int(p), self.max_nnz)
                         for p in nmap_g[fi].ravel()]).reshape(nl, nl)
                    for kk, v in es.etabs.items():
                        et[kk][d, k] = np.asarray(v)[fi]
            self._edblocks.append(dict(esi=esi, gather=gat, Xref=Xr,
                                       wmask=wm, nmap=lmap, etabs=et))

        # ---- local interface-pair tables (cross-block paired-face
        # kernels): a pair assembles on every device owning any of its
        # combined dofs; both elements are local there (partner extension
        # above) and non-owned rows drop on sentinel positions
        self._iblocks = []
        for isi, s in enumerate(problem.ifc_sets):
            gat_g = s.gather_ab.astype(np.int64)  # (npair, nla+nlb)
            nl = gat_g.shape[1]
            Xa_g = mesh.coords[mesh.blocks[s.block_a].conn[s.elems_a]]
            Xb_g = mesh.coords[mesh.blocks[s.block_b].conn[s.elems_b]]
            nmap_g = problem._ifc_nnz[isi]  # (npair, nl, nl)
            gow = dof_owner[gat_g]
            sel_p = [np.flatnonzero(np.any(gow == d, axis=1))
                     for d in range(nd)]
            mx = max(max(sp.shape[0] for sp in sel_p), 1)
            gat = np.full((nd, mx, nl), ml, dtype=np.int64)
            Xa = np.zeros((nd, mx) + Xa_g.shape[1:])
            Xb = np.zeros((nd, mx) + Xb_g.shape[1:])
            wm = np.zeros((nd, mx))
            lmap = np.full((nd, mx, nl, nl), self.max_nnz, dtype=np.int64)
            fta = {k: np.zeros((nd, mx) + np.asarray(v).shape[1:])
                   for k, v in s.ftabs_a.items()}
            ftb = {k: np.zeros((nd, mx) + np.asarray(v).shape[1:])
                   for k, v in s.ftabs_b.items()}
            for d in range(nd):
                for k, pi in enumerate(sel_p[d]):
                    gat[d, k] = [l_of_g[d].get(int(g), ml)
                                 for g in gat_g[pi]]
                    Xa[d, k] = Xa_g[pi]
                    Xb[d, k] = Xb_g[pi]
                    wm[d, k] = 1.0
                    lmap[d, k] = np.asarray(
                        [g2l_nnz[d].get(int(p), self.max_nnz)
                         for p in nmap_g[pi].ravel()]).reshape(nl, nl)
                    for kk, v in s.ftabs_a.items():
                        fta[kk][d, k] = np.asarray(v)[pi]
                    for kk, v in s.ftabs_b.items():
                        ftb[kk][d, k] = np.asarray(v)[pi]
            self._iblocks.append(dict(isi=isi, gather=gat, Xa=Xa, Xb=Xb,
                                      wmask=wm, nmap=lmap, fta=fta, ftb=ftb))

        # ---- local overset (immersed-curve) row tables: row-based (no
        # parent element needed), owner-computes on any device owning a
        # gathered dof; non-owned target rows drop on sentinels
        self._oblocks = []
        for si, s in enumerate(problem.ovs_sets):
            gat_g = s.gather.astype(np.int64)
            nl = gat_g.shape[1]
            nmap_g = problem._ovs_nnz[si]  # (nr, nl, nl)
            sel = ovs_sel[si]
            mx = max(max(sp_.shape[0] for sp_ in sel), 1)
            gat = np.full((nd, mx, nl), ml, dtype=np.int64)
            xq = np.zeros((nd, mx) + s.xq.shape[1:])
            wq = np.zeros((nd, mx))
            wm = np.zeros((nd, mx))
            lmap = np.full((nd, mx, nl, nl), self.max_nnz, dtype=np.int64)
            Nf = {k: np.zeros((nd, mx) + np.asarray(v).shape[1:])
                  for k, v in s.Nf.items()}
            Ns = {k: np.zeros((nd, mx) + np.asarray(v).shape[1:])
                  for k, v in (s.Ns or {}).items()}
            for d in range(nd):
                for k, ri in enumerate(sel[d]):
                    gat[d, k] = [l_of_g[d].get(int(g), ml)
                                 for g in gat_g[ri]]
                    xq[d, k] = s.xq[ri]
                    wq[d, k] = s.wq[ri]
                    wm[d, k] = 1.0
                    lmap[d, k] = np.asarray(
                        [g2l_nnz[d].get(int(p), self.max_nnz)
                         for p in nmap_g[ri].ravel()]).reshape(nl, nl)
                    for kk, v in s.Nf.items():
                        Nf[kk][d, k] = np.asarray(v)[ri]
                    for kk, v in (s.Ns or {}).items():
                        Ns[kk][d, k] = np.asarray(v)[ri]
            self._oblocks.append(dict(si=si, gather=gat, xq=xq, wq=wq,
                                      wmask=wm, nmap=lmap, Nf=Nf, Ns=Ns))

        # ---- rotated (normal-tangent) rows: a rotated node's dofs share an
        # owner (node-major numbering + node ownership), so row rotation is
        # fully local on the owner; same for constraint-replacement rows
        rd_rot = problem._rotation
        self._rot = rd_rot is not None
        if self._rot:
            n_rot = rd_rot.dofs.shape[0]
            dim = rd_rot.dofs.shape[1]
            rot_owner = dof_owner[rd_rot.dofs[:, 0]]
            sel_rot = [np.flatnonzero(rot_owner == d) for d in range(nd)]
            mxr = max(max(s.shape[0] for s in sel_rot), 1)
            rdofs = np.full((nd, mxr, dim), mo, dtype=np.int64)
            rQ = np.zeros((nd, mxr, dim, dim))
            rot_lid = [dict() for _ in range(nd)]
            for d in range(nd):
                for k, i in enumerate(sel_rot[d]):
                    rdofs[d, k] = [l_of_g[d][int(g)] for g in rd_rot.dofs[i]]
                    rQ[d, k] = rd_rot.Q[i]
                    rot_lid[d][int(i)] = k
            K_owner = rot_owner[rd_rot.entry_node]
            sel_K = [np.flatnonzero(K_owner == d) for d in range(nd)]
            mxK = max(max(s.shape[0] for s in sel_K), 1)
            rpos = np.full((nd, mxK, dim), self.max_nnz, dtype=np.int64)
            rnode = np.zeros((nd, mxK), dtype=np.int64)
            for d in range(nd):
                for k, i in enumerate(sel_K[d]):
                    rpos[d, k] = [g2l_nnz[d][int(p)]
                                  for p in rd_rot.pos[i]]
                    rnode[d, k] = rot_lid[d][int(rd_rot.entry_node[i])]
            self._rtabs = dict(rdofs=rdofs, rQ=rQ, rpos=rpos, rnode=rnode)
            # constraint rows
            ncon = rd_rot.con_rows.shape[0]
            self._rot_con = ncon > 0
            if ncon:
                con_owner = dof_owner[rd_rot.con_rows]
                sel_c = [np.flatnonzero(con_owner == d) for d in range(nd)]
                mxc = max(max(s.shape[0] for s in sel_c), 1)
                lcrow = np.full((nd, mxc), mo, dtype=np.int64)
                lccoef = np.zeros((nd, mxc, dim))
                lcdofs = np.full((nd, mxc, dim), ml, dtype=np.int64)
                lcval = np.zeros((nd, mxc))
                lcepos = np.full((nd, mxc, dim), self.max_nnz, dtype=np.int64)
                zeros_per = [np.concatenate(
                    [np.asarray([g2l_nnz[d][int(p)]
                                 for p in rd_rot.con_row_mask_pos[i]],
                                dtype=np.int64) for i in sel_c[d]])
                    if sel_c[d].size else np.empty(0, np.int64)
                    for d in range(nd)]
                mxz = max(max(z.shape[0] for z in zeros_per), 1)
                lczero = np.full((nd, mxz), self.max_nnz, dtype=np.int64)
                for d in range(nd):
                    lczero[d, :zeros_per[d].shape[0]] = zeros_per[d]
                    for k, i in enumerate(sel_c[d]):
                        lcrow[d, k] = l_of_g[d][int(rd_rot.con_rows[i])]
                        lccoef[d, k] = rd_rot.con_coeff[i]
                        lcdofs[d, k] = [l_of_g[d][int(g)]
                                        for g in rd_rot.con_dofs[i]]
                        lcval[d, k] = rd_rot.con_value[i]
                        lcepos[d, k] = [g2l_nnz[d][int(p)]
                                        for p in rd_rot.con_entry_pos[i]]
                self._rtabs.update(rcrow=lcrow, rcoef=lccoef, rcdofs=lcdofs,
                                   rcval=lcval, rczero=lczero, rcepos=lcepos)

        # ---- Vanka (element-block Schwarz) smoother tables: every local
        # element's FULL dense block, gathered from the post-surgery CSR.
        # Entries in halo rows live on the row's owner — a per-factor nnz
        # halo exchange (same ppermute rounds as exchange_dof) ships them,
        # so the distributed smoother is bit-identical to the single-device
        # Vanka (linear.py), weights = 1/global dof multiplicity.
        count = np.zeros(n + 1)
        for bd in dm.blocks:
            np.add.at(count, bd.gather.ravel(), 1.0)
        vk_wts = 1.0 / np.maximum(count, 1.0)
        find = problem.pattern.find
        # per-device halo-nnz sets + per-block local tables
        halo_nnz = [dict() for _ in range(nd)]  # global pos -> halo index
        vk_blocks = []
        for bi, (bd, b) in enumerate(zip(dm.blocks, mesh.blocks)):
            nl = bd.n_ldof
            mx = max(max(len(loc_elems[d][bi]) for d in range(nd)), 1)
            vpos = [np.full((mx, nl, nl), -2, dtype=np.int64)
                    for _ in range(nd)]
            vg = np.full((nd, mx, nl), ml, dtype=np.int64)
            vw = np.zeros((nd, mx, nl))
            for d in range(nd):
                sel = loc_elems[d][bi]
                if not len(sel):
                    continue
                g = bd.gather[sel].astype(np.int64)  # (ne_d, nl)
                rows = np.repeat(g, nl, axis=1).ravel()
                cols = np.tile(g, (1, nl)).ravel()
                pos = find(rows, cols).reshape(-1, nl, nl)
                for k in range(len(sel)):
                    vg[d, k] = [l_of_g[d][int(q)] for q in g[k]]
                    vw[d, k] = vk_wts[g[k]]
                    for a in range(nl):
                        ro = dof_owner[g[k, a]]
                        for c in range(nl):
                            p = int(pos[k, a, c])
                            if p < 0:
                                continue  # structural zero
                            if ro == d:
                                vpos[d][k, a, c] = g2l_nnz[d][p]
                            else:
                                h = halo_nnz[d].setdefault(
                                    p, len(halo_nnz[d]))
                                # halo entries offset later by max_nnz
                                vpos[d][k, a, c] = -1000 - h
            vk_blocks.append(dict(bi=bi, vpos=vpos, vg=vg, vw=vw, mx=mx,
                                  nl=nl))
        self.max_hnnz = max(max(len(h) for h in halo_nnz), 1)
        mnzt = self.max_nnz + self.max_hnnz  # extended vals layout
        for vb in vk_blocks:
            out = np.full((nd,) + vb["vpos"][0].shape, mnzt, dtype=np.int64)
            for d in range(nd):
                vp = vb["vpos"][d]
                out[d] = np.where(
                    vp >= 0, vp,
                    np.where(vp <= -1000, self.max_nnz + (-1000 - vp), mnzt))
            vb["vpos"] = out
        self._vk_blocks = vk_blocks
        # nnz halo-exchange schedule (delta rounds like the dof exchange)
        vneed: dict[int, list[list[tuple[int, int]]]] = {}
        for d in range(nd):
            for p, h in halo_nnz[d].items():
                s = int(dof_owner[rows_g[p]])
                delta = (d - s) % nd
                vneed.setdefault(delta, [[] for _ in range(nd)])
                vneed[delta][s].append((g2l_nnz[s][int(p)], h))
        self._vk_deltas = sorted(vneed.keys())
        vk_send, vk_recv = [], []
        for delta in self._vk_deltas:
            cnt = max(max(len(v) for v in vneed[delta]), 1)
            sp = np.zeros((nd, cnt), dtype=np.int64)
            rp = np.full((nd, cnt), self.max_hnnz, dtype=np.int64)
            for s in range(nd):
                r = (s + delta) % nd
                for k, (spos, rpos) in enumerate(vneed[delta][s]):
                    sp[s, k] = spos
                    rp[r, k] = rpos
            vk_send.append(sp)
            vk_recv.append(rp)
        self._vk_send, self._vk_recv = vk_send, vk_recv

        # Dirichlet: local positions of constrained OWNED dofs
        dd = problem.dirichlet_dofs
        dval = problem.dirichlet_vals
        mxd = max(max(int((dof_owner[dd] == d).sum()) for d in range(nd)), 1) \
            if dd.size else 1
        ldir = np.full((nd, mxd), mo, dtype=np.int64)
        lval = np.zeros((nd, mxd))
        for d in range(nd):
            sel = np.where(dof_owner[dd] == d)[0] if dd.size else []
            for k, i in enumerate(sel):
                ldir[d, k] = l_of_g[d][int(dd[i])]
                lval[d, k] = dval[i]
        self._ldir, self._lval = ldir, lval
        # nnz entries to zero (rows of constrained dofs) handled via mask:
        dmask = np.zeros(n + 1)
        dmask[dd] = 1.0
        keep = 1.0 - dmask[rows_g]
        lkeep = np.zeros((nd, self.max_nnz))
        ldiag = np.full((nd, mxd), self.max_nnz, dtype=np.int64)
        for d in range(nd):
            s = sel_nnz[d]
            lkeep[d, :s.shape[0]] = keep[s]
            sel = np.where(dof_owner[dd] == d)[0] if dd.size else []
            for k, i in enumerate(sel):
                ldiag[d, k] = g2l_nnz[d][int(pat.diag[dd[i]])]
        self._lkeep, self._ldiag = lkeep, ldiag

        # block-Jacobi blocks over owned nodes (local nnz positions)
        starts, counts = [], []
        for d in range(nd):
            pass
        nodes_of = [np.where((node_owner == d) & nodal)[0] for d in range(nd)]
        mxb = max(max(len(v) for v in nodes_of), 1)
        kmax = int(dm.node_dof_count.max())
        bpos = np.full((nd, mxb, kmax, kmax), self.max_nnz, dtype=np.int64)
        bdof = np.full((nd, mxb, kmax), ml, dtype=np.int64)
        bval = np.zeros((nd, mxb, kmax, kmax))
        for d in range(nd):
            for kbi, nid in enumerate(nodes_of[d]):
                s, c = dm.node_dof_start[nid], dm.node_dof_count[nid]
                for a in range(c):
                    bdof[d, kbi, a] = l_of_g[d][int(s + a)]
                    for bcol in range(c):
                        p = pat.find(np.array([s + a]), np.array([s + bcol]))[0]
                        bpos[d, kbi, a, bcol] = g2l_nnz[d].get(int(p),
                                                               self.max_nnz)
                for a in range(c, kmax):
                    bval[d, kbi, a, a] = 1.0  # identity padding
        # elemental dofs: 1x1 blocks — find them per device
        self._bpos, self._bdof, self._bpad = bpos, bdof, bval
        ed = np.where(~np.isin(np.arange(n), np.concatenate(
            [np.arange(dm.node_dof_start[i], dm.node_dof_start[i]
                       + dm.node_dof_count[i]) for i in np.where(nodal)[0]])
        ))[0] if (dm.n_dof - dm.n_node_dof) > 0 else np.empty(0, np.int64)
        mxe = max(max(int((dof_owner[ed] == d).sum()) for d in range(nd)), 1) \
            if ed.size else 1
        epos = np.full((nd, mxe), self.max_nnz, dtype=np.int64)
        edofl = np.full((nd, mxe), ml, dtype=np.int64)
        for d in range(nd):
            sel = ed[dof_owner[ed] == d] if ed.size else []
            for k, g in enumerate(sel):
                edofl[d, k] = l_of_g[d][int(g)]
                epos[d, k] = g2l_nnz[d][int(pat.diag[g])]
        self._epos, self._edofl = epos, edofl

        self._dev_tables = None

    # ----------------------------------------------------------- device put
    def _tables(self):
        if self._dev_tables is not None:
            return self._dev_tables
        sh = NamedSharding(self.device_mesh, P(self.axis))
        dput = lambda a: jax.device_put(jnp.asarray(a), sh)
        T = {
            "own_mask": dput(self._own_mask),
            "lrow": dput(self._lrow), "lcol": dput(self._lcol),
            "nnz_mask": dput(self._nnz_mask),
            "lkeep": dput(self._lkeep), "ldiag": dput(self._ldiag),
            "ldir": dput(self._ldir), "lval": dput(self._lval),
            "bpos": dput(self._bpos), "bdof": dput(self._bdof),
            "bpad": dput(self._bpad),
            "epos": dput(self._epos), "edofl": dput(self._edofl),
        }
        for j, (sp, rp) in enumerate(zip(self._send_tabs, self._recv_tabs)):
            T[f"send{j}"] = dput(sp)
            T[f"recv{j}"] = dput(rp)
        for eb in self._eblocks:
            bi = eb["bi"]
            T[f"g{bi}"] = dput(eb["gather"])
            T[f"x{bi}"] = dput(eb["Xref"])
            T[f"w{bi}"] = dput(eb["wmask"])
            T[f"n{bi}"] = dput(eb["nmap"])
            if self.problem.external_fields:
                T[f"cn{bi}"] = dput(eb["conn"])
            if eb["signs"] is not None:
                T[f"s{bi}"] = dput(eb["signs"])
        for fb in self._fblocks:
            fsi = fb["fsi"]
            T[f"fg{fsi}"] = dput(fb["gather"])
            T[f"fx{fsi}"] = dput(fb["Xref"])
            T[f"fw{fsi}"] = dput(fb["wmask"])
            T[f"fn{fsi}"] = dput(fb["nmap"])
            for k, v in fb["ftabs"].items():
                T[f"ft{fsi}:{k}"] = dput(v)
        for eb2 in self._edblocks:
            esi = eb2["esi"]
            T[f"eg{esi}"] = dput(eb2["gather"])
            T[f"ex{esi}"] = dput(eb2["Xref"])
            T[f"ew{esi}"] = dput(eb2["wmask"])
            T[f"en{esi}"] = dput(eb2["nmap"])
            for k, v in eb2["etabs"].items():
                T[f"et{esi}:{k}"] = dput(v)
        for ib in self._iblocks:
            isi = ib["isi"]
            T[f"ig{isi}"] = dput(ib["gather"])
            T[f"ixa{isi}"] = dput(ib["Xa"])
            T[f"ixb{isi}"] = dput(ib["Xb"])
            T[f"iw{isi}"] = dput(ib["wmask"])
            T[f"in{isi}"] = dput(ib["nmap"])
            for k, v in ib["fta"].items():
                T[f"ita{isi}:{k}"] = dput(v)
            for k, v in ib["ftb"].items():
                T[f"itb{isi}:{k}"] = dput(v)
        for ob in self._oblocks:
            si = ob["si"]
            T[f"og{si}"] = dput(ob["gather"])
            T[f"ox{si}"] = dput(ob["xq"])
            T[f"oq{si}"] = dput(ob["wq"])
            T[f"ow{si}"] = dput(ob["wmask"])
            T[f"on{si}"] = dput(ob["nmap"])
            for k, v in ob["Nf"].items():
                T[f"oN{si}:{k}"] = dput(v)
            for k, v in ob["Ns"].items():
                T[f"oNs{si}:{k}"] = dput(v)
        if self._rot:
            for k, v in self._rtabs.items():
                T[f"rot:{k}"] = dput(v)
        if self._inj:
            for k, v in self._inj_tabs.items():
                T[f"inj:{k}"] = dput(v)
        for vb in self._vk_blocks:
            bi = vb["bi"]
            T[f"vkpos{bi}"] = dput(vb["vpos"])
            T[f"vkg{bi}"] = dput(vb["vg"])
            T[f"vkw{bi}"] = dput(vb["vw"])
        if getattr(self, "_tl", None) is not None:
            for k, v in self._tl["tabs"].items():
                T[f"tl:{k}"] = dput(v)
        if getattr(self, "_ndlu", None) is not None:
            for i, tb in enumerate(self._ndlu.tabs):
                for k, v in tb.items():
                    T[f"nd{i}:{k}"] = dput(v)
        for j, (sp, rp) in enumerate(zip(self._vk_send, self._vk_recv)):
            T[f"vksend{j}"] = dput(sp)
            T[f"vkrecv{j}"] = dput(rp)
        self._dev_tables = T
        return T

    # -------------------------------------------------------- device pieces
    def _exchange(self, x_own, T1):
        """x_local (ml+1,) from the owned slice: the exchange_dof analog.
        Runs INSIDE shard_map; ``T1`` holds per-device table views."""
        ml = self.max_loc
        x_loc = jnp.zeros(ml + 1, dtype=x_own.dtype)
        x_loc = x_loc.at[:self.max_own].set(x_own)
        for j, delta in enumerate(self._deltas):
            buf = x_own[T1[f"send{j}"]]
            perm = [(i, (i + delta) % self.n_dev) for i in range(self.n_dev)]
            buf = jax.lax.ppermute(buf, self.axis, perm)
            x_loc = x_loc.at[T1[f"recv{j}"]].set(buf)
        return x_loc

    def scatter_global(self, x_global):
        """Host: global vector -> sharded (nd, max_own) owned slices."""
        xg = np.asarray(x_global)
        out = np.zeros((self.n_dev, self.max_own), dtype=xg.dtype)
        for d in range(self.n_dev):
            o = self._owned[d]
            out[d, :o.shape[0]] = xg[o]
        sh = NamedSharding(self.device_mesh, P(self.axis))
        return jax.device_put(jnp.asarray(out), sh)

    def gather_global(self, x_own):
        """Host: sharded owned slices -> global vector."""
        a = np.asarray(jax.device_get(x_own))
        n = self.problem.dofmap.n_dof
        out = np.zeros(n, dtype=a.dtype)
        for d in range(self.n_dev):
            o = self._owned[d]
            out[o] = a[d, :o.shape[0]]
        return out

    # ----------------------------------------------------- sharded kernels
    def _prep_fn(self):
        """Build the jitted sharded prep: assemble + Dirichlet + row scale +
        norms. Per-device closures over the static problem definition."""
        prob = self.problem
        mo, ml, mnz = self.max_own, self.max_loc, self.max_nnz
        dtype = prob.dtype
        axis = self.axis

        def prep(x_own, hist_own, params, T):
            # shard_map passes per-device slices with leading axis 1
            T1 = {k: v[0] for k, v in T.items()}
            x_own = x_own[0]
            hist_own = hist_own[0]
            x_loc = self._exchange(x_own, T1)
            h_loc = self._exchange(hist_own, T1)
            R_loc = jnp.zeros(ml + 1, dtype=dtype)
            vals = jnp.zeros(mnz + 1, dtype=dtype)
            for eb in self._eblocks:
                bi = eb["bi"]
                g = T1[f"g{bi}"]          # (mx, nl)
                Xr = T1[f"x{bi}"].astype(dtype)
                wm = T1[f"w{bi}"].astype(dtype)
                nm = T1[f"n{bi}"]
                elem_res = prob._elem_residual_fn(bi)
                jac_fn = jax.jacfwd(elem_res, argnums=0, has_aux=True)
                sg_ax = 0 if f"s{bi}" in T1 else None
                sg = (T1[f"s{bi}"].astype(dtype) if sg_ax == 0 else 1.0)
                if prob.external_fields:
                    ext_stack = jnp.stack(
                        [params[f"ext_{nm}"] for nm in prob.external_fields],
                        axis=-1).astype(dtype)
                    ext_e = ext_stack[T1[f"cn{bi}"]]
                else:
                    ext_e = jnp.zeros(g.shape[:2] + (0,), dtype=dtype)
                J, r = jax.vmap(jac_fn, in_axes=(0, 0, 0, 0, sg_ax, None))(
                    x_loc[g], h_loc[g], Xr, ext_e, sg, params)
                r = r * wm[:, None]
                J = J * wm[:, None, None]
                R_loc = R_loc.at[g.reshape(-1)].add(r.reshape(-1))
                vals = vals.at[nm.reshape(-1)].add(J.reshape(-1))
            for fb in self._fblocks:
                fsi = fb["fsi"]
                fs = prob.face_sets[fsi]
                g = T1[f"fg{fsi}"]        # (mx, nl)
                Xr = T1[f"fx{fsi}"].astype(dtype)
                wm = T1[f"fw{fsi}"].astype(dtype)
                nm = T1[f"fn{fsi}"]
                ftabs = {k: T1[f"ft{fsi}:{k}"].astype(dtype)
                         for k in fb["ftabs"]}
                face_res = prob._face_residual_fn(fs)
                jac_fn = jax.jacfwd(face_res, argnums=0, has_aux=True)
                J, r = jax.vmap(jac_fn, in_axes=(0, 0, 0, 0, None))(
                    x_loc[g], h_loc[g], Xr, ftabs, params)
                r = r * wm[:, None]
                J = J * wm[:, None, None]
                R_loc = R_loc.at[g.reshape(-1)].add(r.reshape(-1))
                vals = vals.at[nm.reshape(-1)].add(J.reshape(-1))
            for eb2 in self._edblocks:
                esi = eb2["esi"]
                g = T1[f"eg{esi}"]
                Xr = T1[f"ex{esi}"].astype(dtype)
                wm = T1[f"ew{esi}"].astype(dtype)
                nm = T1[f"en{esi}"]
                etabs = {k: T1[f"et{esi}:{k}"].astype(dtype)
                         for k in eb2["etabs"]}
                edge_res = prob._edge_residual_fn(esi)
                jac_fn = jax.jacfwd(edge_res, argnums=0, has_aux=True)
                J, r = jax.vmap(jac_fn, in_axes=(0, 0, 0, 0, None))(
                    x_loc[g], h_loc[g], Xr, etabs, params)
                r = r * wm[:, None]
                J = J * wm[:, None, None]
                R_loc = R_loc.at[g.reshape(-1)].add(r.reshape(-1))
                vals = vals.at[nm.reshape(-1)].add(J.reshape(-1))
            for ib in self._iblocks:
                isi = ib["isi"]
                g = T1[f"ig{isi}"]
                Xa = T1[f"ixa{isi}"].astype(dtype)
                Xb = T1[f"ixb{isi}"].astype(dtype)
                wm = T1[f"iw{isi}"].astype(dtype)
                nm = T1[f"in{isi}"]
                fta = {k: T1[f"ita{isi}:{k}"].astype(dtype)
                       for k in ib["fta"]}
                ftb = {k: T1[f"itb{isi}:{k}"].astype(dtype)
                       for k in ib["ftb"]}
                ifc_res = prob._ifc_residual_fn(isi)
                jac_fn = jax.jacfwd(ifc_res, argnums=0, has_aux=True)
                J, r = jax.vmap(jac_fn, in_axes=(0, 0, 0, 0, 0, 0, None))(
                    x_loc[g], h_loc[g], Xa, Xb, fta, ftb, params)
                r = r * wm[:, None]
                J = J * wm[:, None, None]
                R_loc = R_loc.at[g.reshape(-1)].add(r.reshape(-1))
                vals = vals.at[nm.reshape(-1)].add(J.reshape(-1))
            for ob in self._oblocks:
                si = ob["si"]
                g = T1[f"og{si}"]
                xq = T1[f"ox{si}"].astype(dtype)
                wq = T1[f"oq{si}"].astype(dtype)
                wm = T1[f"ow{si}"].astype(dtype)
                nm = T1[f"on{si}"]
                Nf = {k: T1[f"oN{si}:{k}"].astype(dtype) for k in ob["Nf"]}
                Ns = {k: T1[f"oNs{si}:{k}"].astype(dtype) for k in ob["Ns"]}
                row_res = prob._ovs_residual_fn(si)
                jac_fn = jax.jacfwd(row_res, argnums=0, has_aux=True)
                J, r = jax.vmap(jac_fn, in_axes=(0, 0, 0, 0, 0, 0, None))(
                    x_loc[g], h_loc[g], xq, wq, Nf, Ns, params)
                r = r * wm[:, None]
                J = J * wm[:, None, None]
                R_loc = R_loc.at[g.reshape(-1)].add(r.reshape(-1))
                vals = vals.at[nm.reshape(-1)].add(J.reshape(-1))
            # cross-equation row injection on the complete local rows,
            # BEFORE rotation/Dirichlet (single-device _apply_inject order);
            # padded slots point at the sentinel entries with sign 0
            if self._inj:
                sgr = T1["inj:sgnr"].astype(dtype)
                R_loc = R_loc.at[T1["inj:to"]].add(
                    sgr * R_loc[T1["inj:frm"]])
                vals = vals.at[T1["inj:tpos"]].add(
                    T1["inj:psign"].astype(dtype) * vals[T1["inj:fpos"]])
            # rotated (normal-tangent) rows BEFORE Dirichlet, matching the
            # single-device order (_apply_rotation then _apply_dirichlet)
            if self._rot:
                Qr = T1["rot:rQ"].astype(dtype)
                rdofs = T1["rot:rdofs"]
                Rx = jnp.concatenate(
                    [R_loc[:mo] * T1["own_mask"].astype(dtype),
                     jnp.zeros(1, dtype=dtype)])
                Rx = Rx.at[rdofs].set(
                    jnp.einsum("nij,nj->ni", Qr, Rx[rdofs]))
                vrows = vals[T1["rot:rpos"]]
                vals = vals.at[T1["rot:rpos"]].set(jnp.einsum(
                    "kij,kj->ki", Qr[T1["rot:rnode"]], vrows))
                if self._rot_con:
                    ccoef = T1["rot:rcoef"].astype(dtype)
                    Rcon = jnp.einsum("ni,ni->n", ccoef,
                                      x_loc[T1["rot:rcdofs"]]) - \
                        T1["rot:rcval"].astype(dtype)
                    Rx = Rx.at[T1["rot:rcrow"]].set(Rcon)
                    vals = vals.at[T1["rot:rczero"]].set(
                        jnp.zeros((), dtype=dtype))
                    vals = vals.at[T1["rot:rcepos"]].set(ccoef)
                R = Rx[:mo]
            else:
                R = R_loc[:mo] * T1["own_mask"].astype(dtype)
            vals = vals[:mnz]
            # Dirichlet surgery (owned rows only)
            ldir, lval = T1["ldir"], T1["lval"].astype(dtype)
            xd = jnp.concatenate([x_own, jnp.zeros(1, dtype=dtype)])
            R = jnp.concatenate([R, jnp.zeros(1, dtype=dtype)]).at[ldir].set(
                xd[ldir] - lval)[:mo]
            vals = vals * T1["lkeep"].astype(dtype)
            vals = jnp.concatenate([vals, jnp.zeros(1, dtype=dtype)]).at[
                T1["ldiag"]].set(1.0)[:mnz]
            # row-sum scaling (reference row_sum_scaling_scale)
            rs = jnp.zeros(mo + 1, dtype=dtype).at[T1["lrow"]].add(
                jnp.abs(vals) * T1["nnz_mask"].astype(dtype))[:mo]
            scale = jnp.where(rs > 0, 1.0 / jnp.maximum(rs, 1e-300), 1.0)
            Rs = R * scale
            vals = vals * scale[T1["lrow"]] * T1["nnz_mask"].astype(dtype)
            m = T1["own_mask"].astype(dtype)
            l1 = jax.lax.psum(jnp.sum(jnp.abs(Rs) * m), axis)
            l2 = jnp.sqrt(jax.lax.psum(jnp.sum(Rs * Rs * m), axis))
            li = jax.lax.pmax(jnp.max(jnp.abs(Rs) * m), axis)
            return (Rs[None], vals[None], scale[None],
                    l1[None], l2[None], li[None])

        sh = P(self.axis)
        rep = P(self.axis)  # scalars come back as (nd,) stacked
        return jax.jit(jax.shard_map(
            prep, mesh=self.device_mesh,
            in_specs=(sh, sh, P(), sh), out_specs=(sh, sh, sh, sh, sh, sh),
            check_vma=False))

    def _matvec(self, vals, v_own, T1):
        """Owned y = A v with one halo exchange (per-device view)."""
        mo = self.max_own
        x_loc = self._exchange(v_own, T1)
        contrib = vals * x_loc[T1["lcol"]]
        return jnp.zeros(mo + 1, dtype=v_own.dtype).at[T1["lrow"]].add(
            contrib)[:mo] * T1["own_mask"].astype(v_own.dtype)

    def _bj_factor(self, vals, T1):
        from goma_tpu.utils.la import gj_inv

        vx = jnp.concatenate([vals, jnp.zeros(1, dtype=vals.dtype)])
        A = vx[T1["bpos"]] + T1["bpad"].astype(vals.dtype)
        diag = jnp.diagonal(A, axis1=1, axis2=2)
        kmax = A.shape[-1]
        eye = jnp.eye(kmax, dtype=bool)
        A = A + jnp.where((jnp.abs(diag) < 1e-10)[:, :, None] & eye[None],
                          1.0, 0.0)
        Binv = gj_inv(A)
        Binv = jnp.where(jnp.isfinite(Binv), Binv, 0.0)
        ed = vx[T1["epos"]]
        edinv = jnp.where(jnp.abs(ed) > 1e-300, 1.0 / ed, 0.0)
        return Binv, edinv

    def enable_twolevel(self):
        """Host tables for the distributed V(1,1) two-level cycle: the
        SAME Galerkin coarse operator and Q1/P1 coarse space as the
        single-device TwoLevel (solvers/twolevel.py), distributed as
        owner-computes partial sums psum-reduced into a replicated sparse
        coarse matrix, inverted identically on every device
        (saddle-split dense inverse)."""
        if getattr(self, "_tl", None) is not None:
            return
        from goma_tpu.solvers.twolevel import _fine_to_coarse_weights

        prob, nd = self.problem, self.n_dev
        nc, cids, wts, n_ell = _fine_to_coarse_weights(prob)
        pat = prob.pattern
        k = cids.shape[1]
        n = pat.n
        mo = self.max_own
        # per-device transfer rows over owned dofs (pad: sentinel nc, w=0)
        cids_l = np.full((nd, mo, k), nc, dtype=np.int64)
        wts_l = np.zeros((nd, mo, k))
        for d in range(nd):
            o = self._owned[d]
            cids_l[d, :o.shape[0]] = cids[o]
            wts_l[d, :o.shape[0]] = wts[o]
        # Galerkin expansion over the GLOBAL pattern, split by row owner
        r = pat.rows.astype(np.int64)
        c = pat.indices.astype(np.int64)
        ci = cids[r][:, :, None]
        cj = cids[c][:, None, :]
        w = (wts[r][:, :, None] * wts[c][:, None, :]).reshape(-1)
        flat = (ci * nc + cj).reshape(-1)
        rep = np.repeat(np.arange(pat.nnz), k * k)
        keep = np.abs(w) > 1e-14
        flat, w, rep = flat[keep], w[keep], rep[keep]
        ckeys = np.unique(flat)
        c_nnz = ckeys.shape[0]
        idx = np.searchsorted(ckeys, flat)
        eown = self._dof_owner[pat.rows[rep]]
        mxA = max(max(int((eown == d).sum()) for d in range(nd)), 1)
        ac_idx = np.full((nd, mxA), c_nnz, dtype=np.int64)
        ac_w = np.zeros((nd, mxA))
        ac_rep = np.full((nd, mxA), self.max_nnz, dtype=np.int64)
        for d in range(nd):
            sel = np.flatnonzero(eown == d)
            ac_idx[d, :sel.shape[0]] = idx[sel]
            ac_w[d, :sel.shape[0]] = w[sel]
            ac_rep[d, :sel.shape[0]] = [self._g2l_nnz[d][int(p)]
                                        for p in rep[sel]]
        self._tl = dict(
            nc=nc, n_ell=n_ell, c_nnz=c_nnz,
            tabs=dict(
                cids=cids_l, wts=wts_l, ac_idx=ac_idx, ac_w=ac_w,
                ac_rep=ac_rep,
                c_rows=np.tile((ckeys // nc).astype(np.int64)[None], (nd, 1)),
                c_cols=np.tile((ckeys % nc).astype(np.int64)[None], (nd, 1)),
            ))
        self._dev_tables = None  # rebuild with the new tables

    def enable_ndlu(self, leaf_max: int = 96):
        """Per-device multifrontal LU of the OWNED subdomain matrix as the
        (restricted additive Schwarz) subdomain solve — the distributed
        direct/strong-solver analog of the reference's SuperLU_DIST/MUMPS
        route (src/sl_amesos_interface.cpp:68, dispatch
        src/mm_sol_nonlinear.c:1410-1434). Fully local applies (selective
        inversion: batched matmuls), no halo traffic."""
        if getattr(self, "_ndlu", None) is not None:
            return
        from goma_tpu.solvers.ndlu import node_clusters
        from goma_tpu.solvers.ndlu_stack import StackedNDLU
        from goma_tpu.solvers.twolevel import _saddle_mask

        saddle = _saddle_mask(self.problem)
        clusters = node_clusters(self.problem)
        mo = self.max_own
        locals_ = []
        lrow, lcol, mask = self._lrow, self._lcol, self._nnz_mask
        for d in range(self.n_dev):
            n_d = self._owned[d].shape[0]
            live = (mask[d] > 0) & (lcol[d] < n_d)
            sel = np.flatnonzero(live)
            locals_.append((n_d, lrow[d, sel].astype(np.int32),
                            lcol[d, sel].astype(np.int32),
                            sel.astype(np.int32),
                            saddle[self._owned[d]],
                            clusters[self._owned[d]]))
        self._ndlu = StackedNDLU(locals_, mo=mo, max_nnz=self.max_nnz,
                                 leaf_max=leaf_max,
                                 dtype=jnp.dtype(self.problem.dtype)
                                 if jnp.dtype(self.problem.dtype) ==
                                 jnp.float32 else jnp.float32)
        self._dev_tables = None  # rebuild with the new tables

    def _vk_exchange_vals(self, vals, T1):
        """Ship halo-row CSR entries from their owners (per-factor): the
        nnz analog of exchange_dof, same ppermute ring rounds."""
        hv = jnp.zeros(self.max_hnnz + 1, dtype=vals.dtype)
        for j, delta in enumerate(self._vk_deltas):
            buf = vals[T1[f"vksend{j}"]]
            perm = [(i, (i + delta) % self.n_dev) for i in range(self.n_dev)]
            buf = jax.lax.ppermute(buf, self.axis, perm)
            hv = hv.at[T1[f"vkrecv{j}"]].set(buf)
        return hv[:self.max_hnnz]

    def _vanka_factor(self, vals, T1):
        """Element-block Schwarz factor: every local element's full dense
        block from the post-surgery CSR (halo rows shipped from owners);
        identical regularization to the single-device Vanka."""
        from goma_tpu.utils.la import gj_inv

        hv = self._vk_exchange_vals(vals, T1)
        vx = jnp.concatenate([vals, hv, jnp.zeros(1, dtype=vals.dtype)])
        invs = []
        for vb in self._vk_blocks:
            Ae = vx[T1[f"vkpos{vb['bi']}"]]  # (mx, nl, nl)
            nl = Ae.shape[-1]
            diag = jnp.diagonal(Ae, axis1=1, axis2=2)
            fix = (jnp.abs(diag) < 1e-12)[:, :, None] * \
                jnp.eye(nl, dtype=vals.dtype)[None]
            inv = gj_inv(Ae + fix)
            invs.append(jnp.where(jnp.isfinite(inv), inv, 0.0))
        return tuple(invs)

    def _vanka_apply(self, invs, r, T1):
        r_loc = self._exchange(r, T1)
        z = jnp.zeros(self.max_loc + 1, dtype=r.dtype)
        for vb, inv in zip(self._vk_blocks, invs):
            g = T1[f"vkg{vb['bi']}"]
            w = T1[f"vkw{vb['bi']}"].astype(r.dtype)
            ze = jnp.einsum("eij,ej->ei", inv, r_loc[g],
                            precision=jax.lax.Precision.HIGHEST) * w
            z = z.at[g.reshape(-1)].add(ze.reshape(-1))
        return z[:self.max_own] * T1["own_mask"].astype(r.dtype)

    def _bj_apply(self, fac, r, T1):
        Binv, edinv = fac
        mo = self.max_own
        rx = jnp.concatenate([r, jnp.zeros(self.max_loc + 1 - mo,
                                           dtype=r.dtype)])
        rb = rx[T1["bdof"]]  # (mxb, kmax)
        zb = jnp.einsum("bij,bj->bi", Binv, rb,
                        precision=jax.lax.Precision.HIGHEST)
        z = jnp.zeros(self.max_loc + 1, dtype=r.dtype).at[
            T1["bdof"].reshape(-1)].add(zb.reshape(-1))
        z = z.at[T1["edofl"]].add(edinv * rx[T1["edofl"]])
        return z[:mo] * T1["own_mask"].astype(r.dtype)

    def _gmres_fn(self, restart: int, smoother: str = "bj"):
        """Jitted sharded restarted-GMRES cycle (distributed dots via psum,
        the src/mm_sol_nonlinear.c:2720 allreduce analog). ``smoother``:
        "bj" node-block Jacobi (fully local) or "vanka" element-block
        Schwarz (one extra halo exchange per factor and per apply)."""
        axis = self.axis
        mo = self.max_own
        m = restart
        use_vk = smoother == "vanka"
        use_tl = smoother == "twolevel"
        use_nd = smoother == "ndlu"
        if use_tl:
            self.enable_twolevel()
            nc, n_ell, c_nnz = (self._tl["nc"], self._tl["n_ell"],
                                self._tl["c_nnz"])
        if use_nd:
            self.enable_ndlu()
            nd_L = len(self._ndlu.tabs)

        def cycle(vals, b_own, z_own, tol, T):
            T1 = {k: v[0] for k, v in T.items()}
            vals = vals[0]
            b = b_own[0]
            z = z_own[0]
            dtype = b.dtype
            mask = T1["own_mask"].astype(dtype)
            if use_vk:
                fac = self._vanka_factor(vals, T1)
                apply_M = lambda rr: self._vanka_apply(fac, rr, T1)
            elif use_tl:
                # distributed V(1,1): vanka pre/post smoothing + replicated
                # Galerkin coarse solve (psum-reduced sparse coarse values,
                # saddle-split dense inverse computed identically on every
                # device — the src/mm_sol_nonlinear.c allreduce pattern)
                from goma_tpu.utils.la import saddle_split_inv

                fac = self._vanka_factor(vals, T1)
                vx = jnp.concatenate([vals, jnp.zeros(1, dtype=dtype)])
                acv = T1["tl:ac_w"].astype(dtype) * vx[T1["tl:ac_rep"]]
                cvals = jnp.zeros(c_nnz + 1, dtype=dtype).at[
                    T1["tl:ac_idx"]].add(acv)[:c_nnz]
                cvals = jax.lax.psum(cvals, axis)
                Ac = jnp.zeros((nc, nc), dtype=dtype).at[
                    T1["tl:c_rows"], T1["tl:c_cols"]].set(cvals)
                cinv = saddle_split_inv(Ac.astype(jnp.float32), n_ell)
                cw = T1["tl:wts"].astype(dtype)
                ccid = T1["tl:cids"]

                def apply_M(rr):
                    zz = self._vanka_apply(fac, rr, T1)
                    rf = rr - self._matvec(vals, zz, T1)
                    rc = jax.lax.psum(
                        jnp.zeros(nc + 1, dtype=dtype).at[
                            ccid.reshape(-1)].add(
                            (cw * rf[:, None]).reshape(-1))[:nc], axis)
                    with jax.default_matmul_precision("highest"):
                        zc = jnp.matmul(
                            cinv, rc.astype(jnp.float32),
                            preferred_element_type=jnp.float32
                        ).astype(dtype)
                    zc_ext = jnp.concatenate([zc, jnp.zeros(1, dtype=dtype)])
                    zz = zz + jnp.sum(cw * zc_ext[ccid], axis=1) * mask
                    zz = zz + self._vanka_apply(
                        fac, rr - self._matvec(vals, zz, T1), T1)
                    return zz
            elif use_nd:
                # per-device owned-subdomain multifrontal LU (restricted
                # additive Schwarz): factor once per cycle, local applies
                ndtabs = [{k: T1[f"nd{i}:{k}"] for k in
                           ("own_w", "bnd_w", "lin", "src", "padD",
                            "p0", "p1", "i0", "i1")}
                          for i in range(nd_L)]
                fac = self._ndlu.factor(vals, ndtabs)
                apply_M = lambda rr: (self._ndlu.solve(fac, rr, ndtabs)
                                      * mask)
            else:
                fac = self._bj_factor(vals, T1)
                apply_M = lambda rr: self._bj_apply(fac, rr, T1)

            def pdot(a, c):
                return jax.lax.psum(jnp.sum(a * c * mask), axis)

            bn = jnp.sqrt(pdot(b, b))
            target = jnp.maximum(tol * bn, 1e-300)
            r = b - self._matvec(vals, z, T1)
            beta = jnp.sqrt(pdot(r, r))
            V = jnp.zeros((m + 1, mo), dtype=dtype)
            H = jnp.zeros((m + 1, m), dtype=dtype)
            V = V.at[0].set(r / jnp.where(beta > 0, beta, 1.0))
            Q = jnp.eye(m + 1, dtype=dtype)

            def live(carry, j):
                V, H, Q, done, cnt = carry
                w = self._matvec(vals, apply_M(V[j]), T1)
                sel = (jnp.arange(m + 1) <= j).astype(dtype)
                # distributed CGS2: local (m+1, mo) @ (mo,) then psum
                hi = jax.lax.Precision.HIGHEST
                h = jax.lax.psum(jnp.matmul(V, w * mask, precision=hi),
                                 axis) * sel
                w = w - jnp.matmul(V.T, h, precision=hi)
                h2 = jax.lax.psum(jnp.matmul(V, w * mask, precision=hi),
                                  axis) * sel
                w = w - jnp.matmul(V.T, h2, precision=hi)
                h = h + h2
                wn = jnp.sqrt(pdot(w, w))
                H2 = H.at[:, j].set(h).at[j + 1, j].set(wn)
                V2 = V.at[j + 1].set(w / jnp.where(wn > 1e-30, wn, 1.0))
                hr = jnp.matmul(Q, H2[:, j], precision=hi)
                a0, a1 = hr[j], hr[j + 1]
                rr = jnp.sqrt(a0 * a0 + a1 * a1)
                ok = rr > 1e-30
                c_ = jnp.where(ok, a0 / jnp.where(ok, rr, 1.0), 1.0)
                s_ = jnp.where(ok, a1 / jnp.where(ok, rr, 1.0), 0.0)
                qj, qj1 = Q[j], Q[j + 1]
                Q2 = Q.at[j].set(c_ * qj + s_ * qj1).at[j + 1].set(
                    -s_ * qj + c_ * qj1)
                est = jnp.abs(Q2[j + 1, 0] * beta)
                return (V2, H2, Q2, est <= target, cnt + 1)

            def step(j, carry):
                return jax.lax.cond(carry[3], lambda c: c,
                                    lambda c: live(c, j), carry)

            V, H, Q, done, cnt = jax.lax.fori_loop(
                0, m, step, (V, H, Q, beta <= target,
                             jnp.zeros((), jnp.int32)))
            from goma_tpu.utils.la import lstsq_small

            e1 = jnp.zeros(m + 1, dtype=dtype).at[0].set(beta)
            y = lstsq_small(H, e1)
            z2 = z + apply_M(jnp.matmul(
                V[:m].T, y, precision=jax.lax.Precision.HIGHEST))
            rn = b - self._matvec(vals, z2, T1)
            rnn = jnp.sqrt(pdot(rn, rn))
            return z2[None], rnn[None], cnt[None], target[None]

        sh = P(self.axis)
        return jax.jit(jax.shard_map(
            cycle, mesh=self.device_mesh,
            in_specs=(sh, sh, sh, P(), sh), out_specs=(sh, sh, sh, sh),
            check_vma=False))


class PartitionedNewtonSolver:
    """Damped full Newton over a PartitionedProblem: the distributed
    counterpart of NewtonSolver with identical iteration behavior (same
    assembly, same row scaling, same BJ-preconditioned restarted GMRES) —
    iteration-count parity with the single-device path is the test."""

    def __init__(self, pp: PartitionedProblem, max_iter: int = 12,
                 tol_residual: float = 1e-10, linear_tol: float = 1e-10,
                 restart: int = 60, linear_maxiter: int = 600,
                 smoother: str = "bj"):
        self.pp = pp
        self.max_iter = max_iter
        self.tol_residual = tol_residual
        self.linear_tol = linear_tol
        self.restart = restart
        self.linear_maxiter = linear_maxiter
        self._prep = pp._prep_fn()
        self._cycle = pp._gmres_fn(restart, smoother=smoother)

    def solve(self, x0_global, params) -> PartitionedResult:
        pp = self.pp
        T = pp._tables()
        dtype = pp.problem.dtype
        x = pp.scatter_global(np.asarray(x0_global, dtype=dtype))
        hist = pp.scatter_global(np.asarray(
            jax.device_get(params["hist"]), dtype=dtype))
        # keep devices free of global-sized arrays: the history enters as
        # sharded owned slices; strip the global copy from params
        params = dict(params)
        params["hist"] = jnp.zeros(0, dtype=dtype)
        res_norms, lin_iters = [], []
        converged = False
        it = 0
        for it in range(self.max_iter):
            R, vals, scale, l1, l2, li = self._prep(x, hist, params, T)
            l1v = float(jax.device_get(l1)[0])
            l2v = float(jax.device_get(l2)[0])
            liv = float(jax.device_get(li)[0])
            res_norms.append((l1v, l2v, liv))
            if l2v < self.tol_residual and liv < self.tol_residual:
                converged = True
                break
            z = jnp.zeros_like(R)
            tol = jnp.asarray(self.linear_tol, dtype=dtype)
            its = 0
            rn = np.inf
            target = None
            while its < self.linear_maxiter:
                z, rnj, cj, tgt = self._cycle(vals, R, z, tol, T)
                rn = float(jax.device_get(rnj)[0])
                target = float(jax.device_get(tgt)[0])
                its += max(int(jax.device_get(cj)[0]), 1)
                if rn <= target or not np.isfinite(rn):
                    break
            lin_iters.append(its)
            x = x - z
        return PartitionedResult(
            x=pp.gather_global(x), converged=converged, iters=it,
            res_norms=res_norms, linear_iters=lin_iters)


class PartitionedTransientSolver:
    """Theta-scheme transient driver over the partitioned path (the
    distributed counterpart of solvers/transient.py's core loop: qdot =
    ct*x + hist with ct = (1+2 theta)/dt, hist = -ct*x_old - 2 theta
    xdot_old; dt halves on a failed step). Fixed-dt with a failure ladder —
    the predictor/error-controlled variant stays host-side single-device.
    """

    def __init__(self, pp: PartitionedProblem, newton: dict | None = None,
                 dt0: float = 1e-2, t_end: float = 1.0, theta: float = 0.0,
                 max_failures: int = 8, bootstrap_be: bool = True):
        self.pp = pp
        self.newton = PartitionedNewtonSolver(pp, **(newton or {}))
        self.dt0, self.t_end, self.theta = dt0, t_end, theta
        self.max_failures = max_failures
        self.bootstrap_be = bootstrap_be

    def run(self, x0, params, t0: float = 0.0, xdot0=None):
        import jax.numpy as jnp

        dtype = self.pp.problem.dtype
        x = np.asarray(x0, dtype=dtype)
        xdot = (np.zeros_like(x) if xdot0 is None
                else np.asarray(xdot0, dtype=dtype))
        t, dt = t0, self.dt0
        steps = []
        fails = 0
        first = True
        while t < self.t_end - 1e-14:
            dt = min(dt, self.t_end - t)
            th = 0.0 if (first and self.bootstrap_be) else self.theta
            ct = (1.0 + 2.0 * th) / dt
            hist = -ct * x - 2.0 * th * xdot
            p = dict(params)
            p["ct"] = jnp.asarray(ct, dtype=dtype)
            p["hist"] = jnp.asarray(hist, dtype=dtype)
            p["time"] = jnp.asarray(t + dt, dtype=dtype)
            res = self.newton.solve(x, p)
            if not res.converged:
                fails += 1
                if fails > self.max_failures:
                    raise RuntimeError(
                        "partitioned transient: dt ladder exhausted")
                dt *= 0.5
                continue
            fails = 0
            x_new = np.asarray(res.x, dtype=dtype)
            xdot = ct * x_new + hist
            x = x_new
            t += dt
            first = False
            steps.append((t, dt, res.iters, True))
        return PartitionedResult(x=x, converged=True, iters=len(steps),
                                 res_norms=[s[:2] for s in steps],
                                 linear_iters=[])
