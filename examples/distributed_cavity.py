"""Distributed lid-driven cavity over a jax.sharding.Mesh.

The partitioned-DOF path (SURVEY §2.4; reference: METIS decomposition +
dp_ghost halos + exchange_dof, run as ``mpirun -np N goma``): element
k-way partition, one-layer ghost elements, ppermute halo exchange, and a
psum-only sharded Newton-Krylov with element-block Vanka smoothing.

Runs over every device JAX finds — the GPUs of one host:

    python examples/distributed_cavity.py

or, without accelerators, virtual CPU devices:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    JAX_PLATFORMS=cpu python examples/distributed_cavity.py
"""

import numpy as np


def run(n=16, Re=100.0, smoother="vanka", verbose=True):
    import jax

    from goma_tpu.fem import Problem
    from goma_tpu.mesh import rectangle_mesh
    from goma_tpu.parallel.partitioned import (PartitionedNewtonSolver,
                                               PartitionedProblem)
    from goma_tpu.physics import Continuity, Momentum

    mesh = rectangle_mesh(n, n, elem="QUAD9")
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    prob = Problem(mesh, [Momentum(dim=2, interp="Q2", transient=False),
                          Continuity(interp="Q1")],
                   {"rho": 1.0, "mu": 1.0 / Re})
    for ns in ("left", "right", "bottom"):
        prob.add_dirichlet(ns, "velocity", 0, 0.0)
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("top", "velocity", 0, 1.0)
    prob.add_dirichlet("top", "velocity", 1, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.finalize()

    pp = PartitionedProblem(prob)
    if verbose:
        print(f"devices: {len(jax.devices())}, dofs: {prob.dofmap.n_dof}, "
              f"per-device owned: {pp.max_own} (+{pp.max_halo} halo)")
    res = PartitionedNewtonSolver(
        pp, max_iter=15, tol_residual=1e-8, linear_tol=1e-8,
        restart=80, linear_maxiter=4000, smoother=smoother,
    ).solve(np.zeros(prob.dofmap.n_dof), prob.base_params())
    if verbose:
        for k, (l1, l2, li) in enumerate(res.res_norms):
            print(f"  it {k}: ||R||2 = {l2:.3e}")
        print(f"converged: {res.converged} "
              f"(Krylov its/Newton: {res.linear_iters})")
    return prob, res


if __name__ == "__main__":
    run()
