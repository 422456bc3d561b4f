"""Multi-chip element-sharded assembly.

Parity: the reference's distributed-processing backend (§2.4 of SURVEY):
METIS element partitioning (``src/metis_decomp.c:372``), halo exchange
(``src/dp_comm.c:48 exchange_dof``), collective reductions
(``src/dp_utils.c``). Redesign: one SPMD program over a
``jax.sharding.Mesh``; the element loop of every block is sharded over the
"elems" axis with ``shard_map``; each device scatters its partial residual /
CSR values with ``segment_sum`` and a single ``psum`` over ICI replaces the
entire MPI halo machinery (the dof vector is replicated — the analog of
Goma's ghost rows — so no point-to-point exchange is needed at all). For
problems too large to replicate, the dof-PARTITIONED design lives in
``goma_tpu.parallel.partitioned`` (ghost elements, ``ppermute`` halo
rounds, sharded Krylov with per-device preconditioner blocks); this
replicated path remains the simpler choice for small decks.

Element order within a block is partitioned contiguously; pair with a
locality-preserving host partition (see ``goma_tpu.mesh.partition``) so each
device's elements touch a compact dof range.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def _pad_to(a: np.ndarray, m: int):
    ne = a.shape[0]
    pad = (-ne) % m
    if pad == 0:
        return a, np.ones(ne)
    rep = np.repeat(a[:1], pad, axis=0)
    return np.concatenate([a, rep], axis=0), np.concatenate([np.ones(ne), np.zeros(pad)])


class ShardedProblem:
    """Wraps a finalized Problem with an element-sharded assemble().

    Exposes the same interface NewtonSolver needs (``_assemble``, ``pattern``,
    ``dofmap``), so the whole Newton stack runs unchanged over N chips.
    """

    def __init__(self, problem, device_mesh: Mesh | None = None, axis: str = "elems"):
        if device_mesh is None:
            device_mesh = Mesh(np.array(jax.devices()), (axis,))
        self.problem = problem
        self.mesh_axis = axis
        self.device_mesh = device_mesh
        self.pattern = problem.pattern
        self.dofmap = problem.dofmap
        n_dev = device_mesh.devices.size

        dtype = problem.dtype
        self._blocks = []
        for bi, (bd, blk) in enumerate(zip(problem.dofmap.blocks, problem.mesh.blocks)):
            gather, wmask = _pad_to(bd.gather, n_dev)
            Xref, _ = _pad_to(problem.mesh.coords[blk.conn], n_dev)
            nmap, _ = _pad_to(problem._nnz_maps[bi], n_dev)
            conn, _ = _pad_to(blk.conn, n_dev)
            self._blocks.append(
                dict(
                    bi=bi,
                    gather=jnp.asarray(gather, dtype=jnp.int32),
                    Xref=jnp.asarray(Xref, dtype=dtype),
                    nmap=jnp.asarray(nmap),
                    conn=jnp.asarray(conn, dtype=jnp.int32),
                    wmask=jnp.asarray(wmask, dtype=dtype),
                )
            )
        self._faces = []
        for fsi, fs in enumerate(problem.face_sets):
            bd = problem.dofmap.blocks[fs.block_index]
            blk = problem.mesh.blocks[fs.block_index]
            fe = fs.face_elems
            gather, wmask = _pad_to(bd.gather[fe], n_dev)
            Xref, _ = _pad_to(problem.mesh.coords[blk.conn[fe]], n_dev)
            nmap, _ = _pad_to(problem._nnz_maps[fs.block_index][fe], n_dev)
            ftabs = {}
            for k, v in fs.ftabs.items():
                pv, _ = _pad_to(v, n_dev)
                ftabs[k] = jnp.asarray(pv, dtype=dtype)
            self._faces.append(
                dict(
                    fsi=fsi,
                    gather=jnp.asarray(gather, dtype=jnp.int32),
                    Xref=jnp.asarray(Xref, dtype=dtype),
                    ftabs=ftabs,
                    nmap=jnp.asarray(nmap),
                    wmask=jnp.asarray(wmask, dtype=dtype),
                )
            )
        self._assemble_jit = jax.jit(self._assemble)

    def _assemble(self, x, params):
        prob = self.problem
        dtype = prob.dtype
        x = x.astype(dtype)
        axis = self.mesh_axis
        mesh = self.device_mesh
        eshard = P(axis)
        rep = P()

        def sharded_block(bi):
            def f(x, hist, params, gather, Xref, nmap, conn, wmask):
                R, vals = prob._block_contrib(
                    bi, x, hist, params, gather, Xref, nmap, conn, wmask
                )
                return jax.lax.psum((R, vals), axis)

            return jax.shard_map(
                f,
                mesh=mesh,
                in_specs=(rep, rep, rep, eshard, eshard, eshard, eshard, eshard),
                out_specs=(rep, rep),
                check_vma=False,
            )

        def sharded_face(fsi):
            def f(x, hist, params, gather, Xref, ftabs, nmap, wmask):
                R, vals = prob._face_contrib(
                    fsi, x, hist, params, gather, Xref, ftabs, nmap, wmask
                )
                return jax.lax.psum((R, vals), axis)

            return jax.shard_map(
                f,
                mesh=mesh,
                in_specs=(rep, rep, rep, eshard, eshard, eshard, eshard, eshard),
                out_specs=(rep, rep),
                check_vma=False,
            )

        hist = params["hist"]
        n = prob.dofmap.n_dof
        R = jnp.zeros(n, dtype=dtype)
        vals = jnp.zeros(prob.pattern.nnz, dtype=dtype)
        for b in self._blocks:
            dR, dv = sharded_block(b["bi"])(
                x, hist, params, b["gather"], b["Xref"], b["nmap"], b["conn"], b["wmask"]
            )
            R = R + dR
            vals = vals + dv
        for f in self._faces:
            dR, dv = sharded_face(f["fsi"])(
                x, hist, params, f["gather"], f["Xref"], f["ftabs"], f["nmap"], f["wmask"]
            )
            R = R + dR
            vals = vals + dv
        return prob._apply_dirichlet(x, R, vals, params)

    def assemble(self, x, params):
        return self._assemble_jit(x, params)

    def base_params(self, **extra):
        return self.problem.base_params(**extra)
