"""Partitioned-DOF sharding v2 (SURVEY §2.4 design: RCB partition + ghost
elements + ppermute halo exchange + sharded Krylov with psum-only
collectives). Runs on the 8-device virtual CPU mesh (conftest)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from goma_tpu.fem import Problem
from goma_tpu.mesh import rectangle_mesh
from goma_tpu.physics import Continuity, Energy, Momentum
from goma_tpu.solvers import NewtonOptions, NewtonSolver


def _cavity(n=12, Re=50.0):
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
    return prob


def test_partitioned_sizes_scale():
    """Per-device array sizes must scale ~1/N (plus the halo surface term) —
    the 'done' criterion for partitioned sharding."""
    from goma_tpu.parallel.partitioned import PartitionedProblem

    prob = _cavity(16)
    n = prob.dofmap.n_dof
    pp = PartitionedProblem(prob)
    nd = pp.n_dev
    assert nd == 8
    # owned slices partition the dofs exactly
    assert sum(o.shape[0] for o in pp._owned) == n
    # per-device owned size ~ n/8 (RCB balance within 2x)
    assert pp.max_own <= 2.0 * n / nd
    # halo is a surface term: much smaller than the owned interior
    assert pp.max_halo < 0.8 * pp.max_own
    # local CSR is O(n/N) too
    assert pp.max_nnz <= 2.0 * prob.pattern.nnz / nd


def test_partitioned_exchange_roundtrip():
    """Halo exchange delivers exactly the owner's values for every halo
    dof (the exchange_dof contract)."""
    from goma_tpu.parallel.partitioned import PartitionedProblem
    from jax.sharding import PartitionSpec as P

    prob = _cavity(8)
    pp = PartitionedProblem(prob)
    n = prob.dofmap.n_dof
    xg = np.arange(1.0, n + 1.0)
    x = pp.scatter_global(xg)
    T = pp._tables()

    def f(x_own, T):
        T1 = {k: v[0] for k, v in T.items()}
        return pp._exchange(x_own[0], T1)[None]

    sh = P(pp.axis)
    xloc = jax.jit(jax.shard_map(f, mesh=pp.device_mesh, in_specs=(sh, sh),
                                 out_specs=sh, check_vma=False))(x, T)
    xloc = np.asarray(jax.device_get(xloc))
    for d in range(pp.n_dev):
        o = pp._owned[d]
        np.testing.assert_array_equal(xloc[d, :o.shape[0]], xg[o])
        # halo slots carry the owner's values
        # reconstruct: local ids mo.. hold halos in the order built
        # (validated indirectly through assembly parity below too)


def test_partitioned_assembly_matches_global():
    """Sharded prep reproduces the single-device residual and row-scaled
    norms exactly."""
    from goma_tpu.parallel.partitioned import PartitionedProblem

    prob = _cavity(8)
    pp = PartitionedProblem(prob)
    rng = np.random.RandomState(0)
    xg = rng.rand(prob.dofmap.n_dof)
    params = prob.base_params()
    prep = pp._prep_fn()
    x = pp.scatter_global(xg)
    hist = pp.scatter_global(np.zeros_like(xg))
    p2 = dict(params)
    p2["hist"] = jnp.zeros(0, dtype=prob.dtype)
    R, vals, scale, l1, l2, li = prep(x, hist, p2, pp._tables())

    # single-device reference: assemble + row-sum scale
    from goma_tpu.fem.sparsity import row_sum_scale

    Rg, valsg = prob._assemble(jnp.asarray(xg, dtype=prob.dtype), params)
    _, Rs, _ = row_sum_scale(valsg, Rg, jnp.asarray(prob.pattern.rows),
                             prob.dofmap.n_dof)
    np.testing.assert_allclose(float(jax.device_get(l2)[0]),
                               float(jnp.linalg.norm(Rs)), rtol=1e-12)
    np.testing.assert_allclose(float(jax.device_get(li)[0]),
                               float(jnp.max(jnp.abs(Rs))), rtol=1e-12)
    # per-dof residual parity
    Rd = np.zeros(prob.dofmap.n_dof)
    Ra = np.asarray(jax.device_get(R))
    for d in range(pp.n_dev):
        o = pp._owned[d]
        Rd[o] = Ra[d, :o.shape[0]]
    np.testing.assert_allclose(Rd, np.asarray(Rs), atol=1e-13)


def test_partitioned_newton_iteration_parity():
    """Full distributed Newton matches the single-device solver on a
    nonlinear conduction problem where BJ-GMRES converges the linear
    solves tightly: identical iteration counts and residual trajectory
    (SURVEY §2.4 'Newton iteration counts match the single-device path')."""
    from goma_tpu.parallel.partitioned import (PartitionedNewtonSolver,
                                               PartitionedProblem)

    mesh = rectangle_mesh(10, 10, elem="QUAD9")
    prob = Problem(mesh, [Energy(interp="Q2", transient=False,
                                 convection=False)],
                   {"k": lambda fv, mat, p: 1.0
                    + 0.8 * fv.val["temperature"][:, 0] ** 2,
                    "heat_source": 5.0})
    for ns in ("left", "right", "top", "bottom"):
        prob.add_dirichlet(ns, "temperature", 0, 0.0)
    prob.finalize()
    x0 = np.zeros(prob.dofmap.n_dof)
    params = prob.base_params()

    single = NewtonSolver(prob, NewtonOptions(
        max_iter=15, tol_residual=1e-10, precond="block_jacobi",
        linear_tol=1e-10, gmres_restart=60, linear_maxiter=2000,
        precond_lag=False, forcing="fixed",
    ))
    r1 = single.solve(x0, params)
    assert r1.converged

    pp = PartitionedProblem(prob)
    r2 = PartitionedNewtonSolver(pp, max_iter=15, tol_residual=1e-10,
                                 linear_tol=1e-10, restart=60,
                                 linear_maxiter=2000).solve(x0, params)
    assert r2.converged
    assert r2.iters == r1.iters
    np.testing.assert_allclose(r2.x, r1.x, atol=1e-9)
    for (a1, a2, a3), (b1, b2, b3) in zip(r1.res_norms, r2.res_norms):
        np.testing.assert_allclose(a2, b2, rtol=1e-6)


def test_partitioned_cavity_solution_parity():
    """NS cavity (saddle system, inexact BJ-GMRES): the distributed solver
    converges to the same solution within the Newton tolerance."""
    from goma_tpu.parallel.partitioned import (PartitionedNewtonSolver,
                                               PartitionedProblem)

    prob = _cavity(10)
    x0 = np.zeros(prob.dofmap.n_dof)
    params = prob.base_params()
    single = NewtonSolver(prob, NewtonOptions(
        max_iter=12, tol_residual=1e-9, precond="block_jacobi",
        linear_tol=1e-8, gmres_restart=60, linear_maxiter=2000,
        precond_lag=False, forcing="fixed"))
    r1 = single.solve(x0, params)
    pp = PartitionedProblem(prob)
    r2 = PartitionedNewtonSolver(pp, max_iter=12, tol_residual=1e-9,
                                 linear_tol=1e-8, restart=60,
                                 linear_maxiter=2000).solve(x0, params)
    assert r1.converged and r2.converged
    assert abs(r2.iters - r1.iters) <= 1
    np.testing.assert_allclose(r2.x, r1.x, atol=1e-6)


def test_partitioned_nedelec_edge_signs_match_global():
    """Nedelec (N1) blocks route through the partitioned path with their
    per-element edge-sign conjugation intact: the sharded residual matches
    the single-device assembly exactly on a PEC curl-curl deck."""
    from goma_tpu.fem.sparsity import row_sum_scale
    from goma_tpu.parallel.partitioned import PartitionedProblem
    from goma_tpu.physics import EMWaveEdge
    from goma_tpu.physics.em import EDGE_RE

    mesh = rectangle_mesh(6, 6, elem="QUAD9", xlim=(0, 1), ylim=(0, 1))
    # structured meshes are consistently oriented (all signs +1): relabel
    # the nodes with a random permutation so real edge-sign flips occur
    perm = np.random.RandomState(7).permutation(mesh.n_nodes).astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(mesh.n_nodes, dtype=np.int32)
    mesh.coords = mesh.coords[inv]
    for b in mesh.blocks:
        b.conn = perm[b.conn]
    for k in list(mesh.nodesets):
        mesh.nodesets[k] = perm[mesh.nodesets[k]]
    prob = Problem(mesh, [EMWaveEdge("real", omega=2.0)],
                   {"mu_m": 1.0, "eps": 1.0, "J_im": (0.4, -0.2)})
    for ns in ("left", "right", "top", "bottom"):
        prob.add_dirichlet(ns, EDGE_RE, 0, 0.0)
    prob.finalize()
    assert prob.dofmap.blocks[0].edge_signs is not None  # signs in play
    assert np.any(prob.dofmap.blocks[0].edge_signs < 0)

    pp = PartitionedProblem(prob)
    rng = np.random.RandomState(3)
    xg = rng.rand(prob.dofmap.n_dof)
    params = prob.base_params()
    prep = pp._prep_fn()
    p2 = dict(params)
    p2["hist"] = jnp.zeros(0, dtype=prob.dtype)
    R, vals, scale, l1, l2, li = prep(
        pp.scatter_global(xg), pp.scatter_global(np.zeros_like(xg)),
        p2, pp._tables())

    Rg, valsg = prob._assemble(jnp.asarray(xg, dtype=prob.dtype), params)
    _, Rs, _ = row_sum_scale(valsg, Rg, jnp.asarray(prob.pattern.rows),
                             prob.dofmap.n_dof)
    np.testing.assert_allclose(float(jax.device_get(l2)[0]),
                               float(jnp.linalg.norm(Rs)), rtol=1e-12)
    Rd = np.zeros(prob.dofmap.n_dof)
    Ra = np.asarray(jax.device_get(R))
    for d in range(pp.n_dev):
        o = pp._owned[d]
        Rd[o] = Ra[d, :o.shape[0]]
    np.testing.assert_allclose(Rd, np.asarray(Rs), atol=1e-13)


def test_partitioned_face_kernels_parity():
    """Face (weak/integrated) BCs in the partitioned path: a convective
    heat-flux sideset assembles identically to the single-device solver
    (faces ride with their parent element's partition, dp_ghost-style)."""
    from goma_tpu.bc import ConvectiveHeatFlux
    from goma_tpu.parallel.partitioned import (PartitionedNewtonSolver,
                                               PartitionedProblem)

    mesh = rectangle_mesh(10, 10, elem="QUAD9")
    prob = Problem(mesh, [Energy(interp="Q2", transient=False,
                                 convection=False)],
                   {"k": 1.0, "heat_source": 3.0})
    prob.add_dirichlet("left", "temperature", 0, 1.0)
    prob.add_face_kernel("right", ConvectiveHeatFlux(h=2.5, T_inf=0.25))
    prob.add_face_kernel("top", ConvectiveHeatFlux(h=0.7, T_inf=-0.5))
    prob.finalize()
    x0 = np.zeros(prob.dofmap.n_dof)
    params = prob.base_params()

    single = NewtonSolver(prob, NewtonOptions(
        max_iter=10, tol_residual=1e-10, precond="block_jacobi",
        linear_tol=1e-10, gmres_restart=60, linear_maxiter=2000,
        precond_lag=False, forcing="fixed"))
    r1 = single.solve(x0, params)
    assert r1.converged

    pp = PartitionedProblem(prob)
    r2 = PartitionedNewtonSolver(pp, max_iter=10, tol_residual=1e-10,
                                 linear_tol=1e-10, restart=60,
                                 linear_maxiter=2000).solve(x0, params)
    assert r2.converged
    assert r2.iters == r1.iters
    np.testing.assert_allclose(r2.x, r1.x, atol=1e-8)


def test_partitioned_external_fields_parity():
    """External (frozen) nodal fields in the partitioned path: a
    field-dependent conductivity matches the single-device solution."""
    from goma_tpu.parallel.partitioned import (PartitionedNewtonSolver,
                                               PartitionedProblem)

    mesh = rectangle_mesh(8, 8, elem="QUAD9")
    prob = Problem(
        mesh,
        [Energy(interp="Q2", transient=False, convection=False)],
        {"k": lambda fv, mat, p: 1.0 + 2.0 * fv.ext["kmul"],
         "heat_source": 4.0},
        external_fields=("kmul",))
    prob.add_dirichlet("left", "temperature", 0, 0.0)
    prob.add_dirichlet("right", "temperature", 0, 0.0)
    prob.finalize()
    x0 = np.zeros(prob.dofmap.n_dof)
    params = prob.base_params(
        ext_kmul=jnp.asarray(mesh.coords[:, 0] ** 2, dtype=prob.dtype))

    single = NewtonSolver(prob, NewtonOptions(
        max_iter=10, tol_residual=1e-10, precond="block_jacobi",
        linear_tol=1e-10, gmres_restart=60, linear_maxiter=2000,
        precond_lag=False, forcing="fixed"))
    r1 = single.solve(x0, params)
    assert r1.converged

    pp = PartitionedProblem(prob)
    r2 = PartitionedNewtonSolver(pp, max_iter=10, tol_residual=1e-10,
                                 linear_tol=1e-10, restart=60,
                                 linear_maxiter=2000).solve(x0, params)
    assert r2.converged
    np.testing.assert_allclose(r2.x, r1.x, atol=1e-8)


def test_partitioned_rotated_bcs_parity():
    """Rotated (normal-tangent) rows + constraint replacement in the
    partitioned path: the tilted cavity matches the single-device solver
    (rotation is node-local because a node's dofs share an owner)."""
    from goma_tpu.parallel.partitioned import (PartitionedNewtonSolver,
                                               PartitionedProblem)

    n, Re, theta = 6, 50.0, np.pi / 6
    c, s = np.cos(theta), np.sin(theta)
    Rot = np.array([[c, -s], [s, c]])
    mesh = rectangle_mesh(n, n, elem="QUAD9")
    mesh.coords = mesh.coords @ Rot.T
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    prob = Problem(mesh, [Momentum(dim=2, interp="Q2", transient=False),
                          Continuity(interp="Q1")],
                   {"rho": 1.0, "mu": 1.0 / Re})
    for d in ("normal", "tangent"):
        prob.add_rotated_dirichlet(("left", "right", "bottom"),
                                   "velocity", d, 0.0)
    prob.add_rotated_dirichlet(("top",), "velocity", "normal", 0.0)
    prob.add_rotated_dirichlet(("top",), "velocity", "tangent", -1.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.finalize()
    x0 = np.zeros(prob.dofmap.n_dof)
    params = prob.base_params()

    single = NewtonSolver(prob, NewtonOptions(
        max_iter=12, tol_residual=1e-9, precond="block_jacobi",
        linear_tol=1e-9, gmres_restart=80, linear_maxiter=3000,
        precond_lag=False, forcing="fixed"))
    r1 = single.solve(x0, params)
    assert r1.converged

    pp = PartitionedProblem(prob)
    r2 = PartitionedNewtonSolver(pp, max_iter=12, tol_residual=1e-9,
                                 linear_tol=1e-9, restart=80,
                                 linear_maxiter=3000).solve(x0, params)
    assert r2.converged
    np.testing.assert_allclose(r2.x, r1.x, atol=2e-7)


def test_partitioned_transient_parity():
    """Theta-scheme transient over the partitioned path matches the
    single-device TransientSolver trajectory (BE, fixed dt)."""
    from goma_tpu.parallel.partitioned import (PartitionedProblem,
                                               PartitionedTransientSolver)
    from goma_tpu.solvers.transient import TimeOptions, TransientSolver

    mesh = rectangle_mesh(6, 6, elem="QUAD9")
    prob = Problem(mesh, [Energy(interp="Q2", transient=True,
                                 convection=False)],
                   {"k": 1.0, "rho": 1.0, "Cp": 1.0})
    prob.add_dirichlet("left", "temperature", 0, 1.0)
    prob.add_dirichlet("right", "temperature", 0, 0.0)
    prob.finalize()
    x0 = np.zeros(prob.dofmap.n_dof)
    params = prob.base_params()

    ts = TransientSolver(
        prob,
        NewtonOptions(max_iter=8, tol_residual=1e-11,
                      precond="block_jacobi", linear_tol=1e-11,
                      gmres_restart=60, linear_maxiter=2000,
                      precond_lag=False, forcing="fixed"),
        TimeOptions(dt0=0.02, t_end=0.08, adapt=False, theta=0.0))
    r1 = ts.run(x0, params)

    pp = PartitionedProblem(prob)
    r2 = PartitionedTransientSolver(
        pp, newton=dict(max_iter=8, tol_residual=1e-11, linear_tol=1e-11,
                        restart=60, linear_maxiter=2000),
        dt0=0.02, t_end=0.08, theta=0.0).run(x0, params)
    np.testing.assert_allclose(r2.x, np.asarray(r1.x), atol=1e-9)


def test_partitioned_vanka_smoother_parity():
    """Distributed element-block Vanka (halo-shipped full blocks): same
    solution as single-device Vanka-GMRES on the saddle cavity, and far
    fewer Krylov its than BJ."""
    from goma_tpu.parallel.partitioned import (PartitionedNewtonSolver,
                                               PartitionedProblem)

    prob = _cavity(8)
    x0 = np.zeros(prob.dofmap.n_dof)
    params = prob.base_params()
    single = NewtonSolver(prob, NewtonOptions(
        max_iter=12, tol_residual=1e-9, precond="vanka",
        linear_tol=1e-9, gmres_restart=60, linear_maxiter=2000,
        precond_lag=False, forcing="fixed"))
    r1 = single.solve(x0, params)
    assert r1.converged

    pp = PartitionedProblem(prob)
    rv = PartitionedNewtonSolver(pp, max_iter=12, tol_residual=1e-9,
                                 linear_tol=1e-9, restart=60,
                                 linear_maxiter=2000,
                                 smoother="vanka").solve(x0, params)
    assert rv.converged
    np.testing.assert_allclose(rv.x, np.asarray(r1.x), atol=2e-7)

    rb = PartitionedNewtonSolver(pp, max_iter=12, tol_residual=1e-9,
                                 linear_tol=1e-9, restart=60,
                                 linear_maxiter=2000,
                                 smoother="bj").solve(x0, params)
    assert rb.converged
    assert sum(rv.linear_iters) < sum(rb.linear_iters)


def test_partitioned_twolevel_parity():
    """Distributed V(1,1) two-level (vanka smoothing + psum-reduced
    replicated Galerkin coarse solve) matches the single-device TwoLevel
    solution on the saddle cavity with far fewer Krylov its than BJ."""
    from goma_tpu.parallel.partitioned import (PartitionedNewtonSolver,
                                               PartitionedProblem)

    prob = _cavity(8)
    x0 = np.zeros(prob.dofmap.n_dof)
    params = prob.base_params()
    single = NewtonSolver(prob, NewtonOptions(
        max_iter=12, tol_residual=1e-9, precond="twolevel",
        smoother="vanka", smooth_sweeps=1, smooth_damp=1.0,
        linear_tol=1e-9, gmres_restart=60, linear_maxiter=2000,
        precond_lag=False, forcing="fixed"))
    r1 = single.solve(x0, params)
    assert r1.converged

    pp = PartitionedProblem(prob)
    rt = PartitionedNewtonSolver(pp, max_iter=12, tol_residual=1e-9,
                                 linear_tol=1e-9, restart=60,
                                 linear_maxiter=2000,
                                 smoother="twolevel").solve(x0, params)
    assert rt.converged
    np.testing.assert_allclose(rt.x, np.asarray(r1.x), atol=2e-7)

    rb = PartitionedNewtonSolver(pp, max_iter=12, tol_residual=1e-9,
                                 linear_tol=1e-9, restart=60,
                                 linear_maxiter=2000).solve(x0, params)
    assert sum(rt.linear_iters) < 0.5 * sum(rb.linear_iters)


def test_partitioned_interface_parity():
    """Cross-block interface kernels (contact resistance): pair partners
    join the local element sets, so the distributed assembly matches the
    single-device solver on the split-interface two-layer deck."""
    from goma_tpu.mesh.interface import find_interface_faces, split_interface
    from goma_tpu.parallel.partitioned import (PartitionedNewtonSolver,
                                               PartitionedProblem)
    from goma_tpu.physics import InterfaceExchange
    from tests.test_interface import _two_block_strip

    ka, kb, h = 2.0, 0.5, 4.0
    mesh = _two_block_strip(4, 2)
    pairs = find_interface_faces(mesh, 0, 1)
    split_interface(mesh, pairs)
    prob = Problem(
        mesh,
        [[Energy(interp="Q1", transient=False, convection=False)],
         [Energy(interp="Q1", transient=False, convection=False)]],
        [{"rho": 1.0, "Cp": 1.0, "k": ka}, {"rho": 1.0, "Cp": 1.0, "k": kb}])
    prob.add_dirichlet("left", "temperature", 0, 1.0)
    prob.add_dirichlet("right", "temperature", 0, 0.0)
    prob.add_interface_kernel(pairs, InterfaceExchange("temperature",
                                                       coeff=h))
    prob.finalize()
    x0 = np.zeros(prob.dofmap.n_dof)
    params = prob.base_params()

    single = NewtonSolver(prob, NewtonOptions(
        max_iter=10, tol_residual=1e-11, precond="block_jacobi",
        linear_tol=1e-11, gmres_restart=60, linear_maxiter=2000,
        precond_lag=False, forcing="fixed"))
    r1 = single.solve(x0, params)
    assert r1.converged

    pp = PartitionedProblem(prob)
    r2 = PartitionedNewtonSolver(pp, max_iter=10, tol_residual=1e-11,
                                 linear_tol=1e-11, restart=60,
                                 linear_maxiter=2000).solve(x0, params)
    assert r2.converged
    np.testing.assert_allclose(r2.x, np.asarray(r1.x), atol=1e-9)


def test_partitioned_edge_kernels_3d_parity():
    """3D edge-curve BCs (bc_curve.c analog) + a 3D box mesh in the
    partitioned path: line-source conduction matches the single-device
    solver."""
    from goma_tpu.bc.edge import EdgeTraction
    from goma_tpu.mesh import box_mesh
    from goma_tpu.parallel.partitioned import (PartitionedNewtonSolver,
                                               PartitionedProblem)

    mesh = box_mesh(3, 3, 3, elem="HEX27")
    prob = Problem(mesh, [Energy(interp="Q2", transient=False,
                                 convection=False)], {"k": 1.0})
    prob.add_dirichlet("bottom", "temperature", 0, 0.0)
    prob.add_edge_kernel("top", "right", EdgeTraction("temperature", 1, 2.5))
    prob.finalize()
    x0 = np.zeros(prob.dofmap.n_dof)
    params = prob.base_params()

    single = NewtonSolver(prob, NewtonOptions(
        max_iter=8, tol_residual=1e-10, precond="block_jacobi",
        linear_tol=1e-10, gmres_restart=60, linear_maxiter=2000,
        precond_lag=False, forcing="fixed"))
    r1 = single.solve(x0, params)
    assert r1.converged

    pp = PartitionedProblem(prob)
    r2 = PartitionedNewtonSolver(pp, max_iter=8, tol_residual=1e-10,
                                 linear_tol=1e-10, restart=60,
                                 linear_maxiter=2000).solve(x0, params)
    assert r2.converged
    np.testing.assert_allclose(r2.x, np.asarray(r1.x), atol=1e-8)


def test_deck_distributed_routing():
    """solver.distributed=true in a deck routes through the partitioned
    path (steady + transient)."""
    from goma_tpu.input.deck import run_deck

    base = {
        "mesh": {"kind": "rectangle", "nx": 6, "ny": 6, "elem": "QUAD9"},
        "equations": [{"type": "energy", "interp": "Q2",
                       "transient": False, "convection": False}],
        "material": {"k": 1.0, "heat_source": 2.0},
        "bcs": [{"kind": "dirichlet", "nodeset": "left",
                 "var": "temperature", "comp": 0, "value": 0.0}],
        "solver": {"distributed": True, "max_iter": 8,
                   "tol_residual": 1e-10, "linear_tol": 1e-10,
                   "linear_maxiter": 1500},
    }
    prob, res, echo = run_deck(base)
    assert res.converged

    tdeck = dict(base)
    tdeck["equations"] = [{"type": "energy", "interp": "Q2",
                           "transient": True, "convection": False}]
    tdeck["material"] = {"k": 1.0, "rho": 1.0, "Cp": 1.0}
    tdeck["time"] = {"dt0": 0.05, "t_end": 0.1}
    prob, res, echo = run_deck(tdeck)
    assert res.converged and res.iters == 2  # 2 accepted steps


def test_partitioned_ndlu_subdomain_solver():
    """Distributed NDLU: every device factors its
    owned-subdomain matrix with the stacked multifrontal LU and applies it
    as the additive-Schwarz subdomain solve — the SuperLU_DIST/MUMPS
    analog (src/sl_amesos_interface.cpp:68). Same converged solution as
    the single-device path, far fewer Krylov its than BJ."""
    from goma_tpu.parallel.partitioned import (PartitionedNewtonSolver,
                                               PartitionedProblem)

    prob = _cavity(8)
    x0 = np.zeros(prob.dofmap.n_dof)
    params = prob.base_params()
    single = NewtonSolver(prob, NewtonOptions(
        max_iter=12, tol_residual=1e-9, linear_tol=1e-9,
        gmres_restart=60, linear_maxiter=2000, forcing="fixed"))
    r1 = single.solve(x0, params)
    assert r1.converged

    pp = PartitionedProblem(prob)
    rn = PartitionedNewtonSolver(pp, max_iter=12, tol_residual=1e-9,
                                 linear_tol=1e-9, restart=60,
                                 linear_maxiter=2000,
                                 smoother="ndlu").solve(x0, params)
    assert rn.converged
    np.testing.assert_allclose(rn.x, np.asarray(r1.x), atol=2e-7)
    # Newton-count parity with the single-device solver
    assert rn.iters == r1.iters

    rb = PartitionedNewtonSolver(pp, max_iter=12, tol_residual=1e-9,
                                 linear_tol=1e-9, restart=60,
                                 linear_maxiter=2000,
                                 smoother="bj").solve(x0, params)
    assert rb.converged
    assert sum(rn.linear_iters) < 0.7 * sum(rb.linear_iters)


def test_stacked_ndlu_exact_local_solves():
    """Each device's stacked factor inverts exactly its owned-subdomain
    matrix (Schwarz-block property): A_dd z = r to ~f32 accuracy."""
    from goma_tpu.parallel.partitioned import PartitionedProblem
    from jax.sharding import PartitionSpec as P

    prob = _cavity(6)
    pp = PartitionedProblem(prob)
    pp.enable_ndlu(leaf_max=48)
    T = pp._tables()
    params = prob.base_params()
    x = pp.scatter_global(np.zeros(prob.dofmap.n_dof))
    hist = pp.scatter_global(np.zeros(prob.dofmap.n_dof))
    prep = pp._prep_fn()
    p2 = dict(params); p2["hist"] = jnp.zeros(0, dtype=prob.dtype)
    R, vals, scale, *_ = prep(x, hist, p2, T)
    nd_L = len(pp._ndlu.tabs)

    def fs(vals_s, r_s, T_s):
        T1 = {k: v[0] for k, v in T_s.items()}
        tabs = [{k: T1[f"nd{i}:{k}"] for k in
                 ("own_w", "bnd_w", "lin", "src", "padD",
                  "p0", "p1", "i0", "i1")} for i in range(nd_L)]
        fac = pp._ndlu.factor(vals_s[0], tabs)
        z = pp._ndlu.solve(fac, r_s[0], tabs)
        return z[None]

    sh = P(pp.axis)
    rng = np.random.default_rng(0)
    r_own = jax.device_put(
        jnp.asarray(rng.normal(size=(pp.n_dev, pp.max_own))
                    * np.asarray(pp._own_mask)),
        jax.sharding.NamedSharding(pp.device_mesh, sh))
    z = jax.jit(jax.shard_map(fs, mesh=pp.device_mesh,
                              in_specs=(sh, sh, sh), out_specs=sh,
                              check_vma=False))(vals, r_own, T)
    # verify per device on host: A_dd z_d = r_d
    import scipy.sparse as sp

    zh = np.asarray(jax.device_get(z))
    rh = np.asarray(jax.device_get(r_own))
    vh = np.asarray(jax.device_get(vals))
    for d in range(pp.n_dev):
        n_d = pp._owned[d].shape[0]
        live = (pp._nnz_mask[d] > 0) & (pp._lcol[d] < n_d)
        sel = np.flatnonzero(live)
        A = sp.coo_matrix((vh[d, sel],
                           (pp._lrow[d, sel], pp._lcol[d, sel])),
                          shape=(n_d, n_d)).tocsr()
        res = A @ zh[d, :n_d] - rh[d, :n_d]
        denom = np.linalg.norm(rh[d, :n_d]) + 1e-30
        assert np.linalg.norm(res) / denom < 5e-5, (d, np.linalg.norm(res))


def test_partitioned_row_inject_parity():
    """Cross-equation row injection (add_row_inject) under the partitioned
    path: both rows of an inject pair live at the same node, so the row
    move is local to the node's owner. Per-dof
    residual and per-entry CSR parity against the single-device assembly
    on a coupled two-field deck with injection along one side."""
    from goma_tpu.fem.sparsity import row_sum_scale
    from goma_tpu.parallel.partitioned import PartitionedProblem
    from goma_tpu.physics import Species

    mesh = rectangle_mesh(6, 6, elem="QUAD9")
    prob = Problem(mesh, [Energy(interp="Q2", transient=False,
                                 convection=False),
                          Species(n_species=1, interp="Q2",
                                  transient=False)],
                   {"k": 1.0, "heat_source": 3.0, "diffusivity": 0.5,
                    "Cp": 1.0, "rho": 1.0})
    for ns in ("left", "bottom"):
        prob.add_dirichlet(ns, "temperature", 0, 0.0)
        prob.add_dirichlet(ns, "species", 0, 1.0)
    # inject the temperature rows into the species rows along the right
    # edge (the put_lub_flux_in_film / put_liquid_stress_in_solid shape)
    prob.add_row_inject("right", "temperature", "species", sign=0.7)
    prob.finalize()
    pp = PartitionedProblem(prob)
    rng = np.random.RandomState(3)
    xg = rng.rand(prob.dofmap.n_dof)
    params = prob.base_params()
    prep = pp._prep_fn()
    x = pp.scatter_global(xg)
    hist = pp.scatter_global(np.zeros_like(xg))
    p2 = dict(params)
    p2["hist"] = jnp.zeros(0, dtype=prob.dtype)
    R, vals, scale, l1, l2, li = prep(x, hist, p2, pp._tables())

    Rg, valsg = prob._assemble(jnp.asarray(xg, dtype=prob.dtype), params)
    _, Rs, _ = row_sum_scale(valsg, Rg, jnp.asarray(prob.pattern.rows),
                             prob.dofmap.n_dof)
    Rd = np.zeros(prob.dofmap.n_dof)
    Ra = np.asarray(jax.device_get(R))
    for d in range(pp.n_dev):
        o = pp._owned[d]
        Rd[o] = Ra[d, :o.shape[0]]
    np.testing.assert_allclose(Rd, np.asarray(Rs), atol=1e-12)
    # scaled CSR values parity, entry by entry (scatter local to global)
    from goma_tpu.fem.sparsity import sym_sum_scale  # noqa: F401 (import ok)
    rows = prob.pattern.rows
    rsg = np.zeros(prob.dofmap.n_dof)
    np.add.at(rsg, rows, np.abs(np.asarray(valsg)))
    valsg_scaled = np.asarray(valsg) / np.maximum(rsg, 1e-300)[rows]
    va = np.asarray(jax.device_get(vals))
    vg = np.zeros(prob.pattern.nnz)
    for d in range(pp.n_dev):
        sel = np.where(pp._dof_owner[rows] == d)[0]
        vg[sel] = va[d, :sel.shape[0]]
    np.testing.assert_allclose(vg, valsg_scaled, atol=1e-12)


def test_partitioned_row_inject_solve_converges():
    """A lubrication->film junction deck (the real add_row_inject user)
    converges under the 8-device partitioned Newton with the same
    iteration count as single-device."""
    from goma_tpu.parallel.partitioned import (PartitionedNewtonSolver,
                                               PartitionedProblem)
    from goma_tpu.physics import Species

    mesh = rectangle_mesh(8, 8, elem="QUAD9")
    prob = Problem(mesh, [Energy(interp="Q2", transient=False,
                                 convection=False),
                          Species(n_species=1, interp="Q2",
                                  transient=False)],
                   {"k": lambda fv, mat, p: 1.0
                    + 0.5 * fv.val["temperature"][:, 0] ** 2,
                    "heat_source": 4.0, "diffusivity": 1.0,
                    "Cp": 1.0, "rho": 1.0})
    for ns in ("left", "right", "top", "bottom"):
        prob.add_dirichlet(ns, "temperature", 0, 0.0)
    for ns in ("left", "top", "bottom"):
        prob.add_dirichlet(ns, "species", 0, 0.0)
    prob.add_row_inject("right", "temperature", "species", sign=1.0)
    prob.finalize()
    x0 = np.zeros(prob.dofmap.n_dof)
    params = prob.base_params()
    single = NewtonSolver(prob, NewtonOptions(
        max_iter=15, tol_residual=1e-9, precond="block_jacobi",
        linear_tol=1e-10, gmres_restart=80, linear_maxiter=3000,
        precond_lag=False, forcing="fixed"))
    r1 = single.solve(x0, params)
    assert r1.converged
    pp = PartitionedProblem(prob)
    r2 = PartitionedNewtonSolver(pp, max_iter=15, tol_residual=1e-9,
                                 linear_tol=1e-10, restart=80,
                                 linear_maxiter=3000).solve(x0, params)
    assert r2.converged
    assert r2.iters == r1.iters
    np.testing.assert_allclose(r2.x, r1.x, atol=1e-7)


def _ovs_couette(ny=8, y_c=0.3, U_s=0.4, U_top=1.0, mu=0.7, nseg=5):
    from goma_tpu.mesh import polyline_block
    from goma_tpu.physics import Continuity, Momentum, OversetLM, OversetNoSlip

    mesh = rectangle_mesh(4, ny, elem="QUAD9", xlim=(0, 0.8), ylim=(0, 1))
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    line = np.stack([np.linspace(0, 0.8, nseg + 1),
                     np.full(nseg + 1, y_c)], axis=1)
    bi = polyline_block(mesh, line, name="wall")
    prob = Problem(mesh,
                   [[Momentum(dim=2, interp="Q2", transient=False,
                              convection=False), Continuity(interp="Q1")],
                    [OversetLM(dim=2)]],
                   [{"rho": 1.0, "mu": mu}, {}])
    prob.add_dirichlet("top", "velocity", 0, U_top)
    prob.add_dirichlet("bottom", "velocity", 0, 0.0)
    for ns in ("top", "bottom", "left", "right"):
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.add_overset(bi, 0, OversetNoSlip(
        dim=2, u_target=lambda x, params: jnp.asarray([U_s, 0.0])))
    prob.finalize()
    return prob


def test_partitioned_overset_assembly_parity():
    """Overset (immersed-curve multiplier) decks under the partitioned
    path: coupling rows replicate onto every owner of
    a gathered dof; per-dof residual and per-entry scaled CSR parity vs
    the single-device assembly."""
    from goma_tpu.parallel.partitioned import PartitionedProblem

    prob = _ovs_couette()
    pp = PartitionedProblem(prob)
    rng = np.random.RandomState(7)
    xg = rng.rand(prob.dofmap.n_dof)
    params = prob.base_params()
    prep = pp._prep_fn()
    x = pp.scatter_global(xg)
    hist = pp.scatter_global(np.zeros_like(xg))
    p2 = dict(params)
    p2["hist"] = jnp.zeros(0, dtype=prob.dtype)
    R, vals, scale, l1, l2, li = prep(x, hist, p2, pp._tables())

    from goma_tpu.fem.sparsity import row_sum_scale

    Rg, valsg = prob._assemble(jnp.asarray(xg, dtype=prob.dtype), params)
    _, Rs, _ = row_sum_scale(valsg, Rg, jnp.asarray(prob.pattern.rows),
                             prob.dofmap.n_dof)
    Rd = np.zeros(prob.dofmap.n_dof)
    Ra = np.asarray(jax.device_get(R))
    for d in range(pp.n_dev):
        o = pp._owned[d]
        Rd[o] = Ra[d, :o.shape[0]]
    np.testing.assert_allclose(Rd, np.asarray(Rs), atol=1e-12)
    rows = prob.pattern.rows
    rsg = np.zeros(prob.dofmap.n_dof)
    np.add.at(rsg, rows, np.abs(np.asarray(valsg)))
    valsg_scaled = np.asarray(valsg) / np.maximum(rsg, 1e-300)[rows]
    va = np.asarray(jax.device_get(vals))
    vg = np.zeros(prob.pattern.nnz)
    for d in range(pp.n_dev):
        sel = np.where(pp._dof_owner[rows] == d)[0]
        vg[sel] = va[d, :sel.shape[0]]
    np.testing.assert_allclose(vg, valsg_scaled, atol=1e-12)


def test_partitioned_overset_solve_converges():
    """The immersed-line Couette deck converges under the 8-device
    partitioned Newton to the single-device solution."""
    from goma_tpu.parallel.partitioned import (PartitionedNewtonSolver,
                                               PartitionedProblem)

    prob = _ovs_couette()
    x0 = np.zeros(prob.dofmap.n_dof)
    params = prob.base_params()
    r1 = NewtonSolver(prob, NewtonOptions(
        max_iter=8, tol_residual=1e-10,
        linear_solver="direct")).solve(x0, params)
    assert r1.converged
    pp = PartitionedProblem(prob)
    r2 = PartitionedNewtonSolver(pp, max_iter=10, tol_residual=1e-8,
                                 linear_tol=1e-11, restart=120,
                                 linear_maxiter=6000,
                                 smoother="vanka").solve(x0, params)
    assert r2.converged, r2.res_norms
    np.testing.assert_allclose(r2.x, r1.x, atol=2e-6)
