"""Stacked per-device multifrontal LU (solvers/ndlu_stack.py): the pivoted
``lax`` front factor on owned subdomains of the saddle cavity, checked
device by device against scipy's sparse direct solve."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
from jax.sharding import Mesh

from goma_tpu.fem.sparsity import sym_sum_scale
from goma_tpu.parallel.partitioned import PartitionedProblem
from goma_tpu.solvers.ndlu_stack import StackedNDLU
from goma_tpu.solvers.twolevel import _saddle_mask
from test_ndlu import _cavity


def _subdomains(n=8, n_dev=2, order="saddle_last"):
    """Owned-subdomain matrices A_dd of the equilibrated cavity Jacobian at
    a convecting state, as StackedNDLU ``locals_`` plus the host matrices.

    ``order`` sets the defer mask of every front's own block: saddle rows
    last, no defer mask, or saddle rows first."""
    prob = _cavity(n)
    rng = np.random.default_rng(0)
    x = jnp.asarray(0.1 * rng.standard_normal(prob.dofmap.n_dof))
    _R, vals = prob._assemble(x, prob.base_params())
    pat = prob.pattern
    vals, _scale = sym_sum_scale(vals, jnp.asarray(pat.rows),
                                 jnp.asarray(pat.indices), pat.n)
    A = sp.csr_matrix((np.asarray(vals), pat.indices, pat.indptr),
                      shape=(pat.n, pat.n))
    pp = PartitionedProblem(
        prob, device_mesh=Mesh(np.array(jax.devices()[:n_dev]), ("dofs",)))
    saddle = _saddle_mask(prob)
    locals_, blocks = [], []
    defer = {"saddle_last": saddle, "none": None,
             "saddle_first": ~saddle}[order]
    for own in pp._owned:
        Add = A[own][:, own].tocoo()
        locals_.append((own.shape[0], Add.row.astype(np.int32),
                        Add.col.astype(np.int32),
                        np.arange(Add.nnz, dtype=np.int32),
                        None if defer is None else defer[own]))
        blocks.append((Add.tocsr(), saddle[own]))
    mo = max(b[0].shape[0] for b in blocks)
    max_nnz = max(b[0].nnz for b in blocks)
    return locals_, blocks, mo, max_nnz


def _device_solver(nd, d, A_dd, max_nnz):
    """(factor, solve) closures for device ``d`` on its [d]-sliced tables."""
    tabs = [{k: jnp.asarray(v[d]) for k, v in tb.items()} for tb in nd.tabs]
    v = np.zeros(max_nnz)
    v[:A_dd.nnz] = A_dd.tocoo().data
    fac = jax.jit(nd.factor)(jnp.asarray(v), tabs)

    def solve(r):
        rp = np.zeros(nd.mo)
        rp[:r.shape[0]] = r
        z = jax.jit(nd.solve)(fac, jnp.asarray(rp), tabs)
        return np.asarray(z, dtype=np.float64)[:r.shape[0]]

    return solve


@pytest.mark.parametrize("order", ["saddle_last", "none", "saddle_first"])
def test_stacked_ndlu_pivoted_f64_matches_scipy(order):
    """The pivoted lax front factor reproduces spsolve on every owned
    subdomain, whatever the order of the own block. With the saddle rows
    first, fronts start on a zero pivot and only partial pivoting inside
    the fully-summed block keeps the factor exact."""
    locals_, blocks, mo, max_nnz = _subdomains(order=order)
    nd = StackedNDLU(locals_, mo=mo, max_nnz=max_nnz, leaf_max=48,
                     dtype=jnp.float64)
    if order == "saddle_first":
        # some front's leading own dof is a saddle row (zero diagonal)
        lead_saddle = False
        for d, (A_dd, saddle) in enumerate(blocks):
            for tb in nd.tabs:
                first = tb["own_w"][d, :, 0]
                first = first[first < A_dd.shape[0]]
                lead_saddle |= bool(saddle[first].any())
        assert lead_saddle
    rng = np.random.default_rng(1)
    for d, (A_dd, _saddle) in enumerate(blocks):
        solve = _device_solver(nd, d, A_dd, max_nnz)
        r = rng.standard_normal(A_dd.shape[0])
        z = solve(r)
        zs = spla.spsolve(A_dd.tocsc(), r)
        assert np.linalg.norm(z - zs) / np.linalg.norm(zs) < 1e-10, d


def test_stacked_ndlu_f32_refined_backward_error():
    """An f32 stacked factor wrapped in iterative refinement against the
    f64 subdomain matrix reaches a backward error of 1e-12."""
    locals_, blocks, mo, max_nnz = _subdomains()
    nd = StackedNDLU(locals_, mo=mo, max_nnz=max_nnz, leaf_max=48,
                     dtype=jnp.float32)
    rng = np.random.default_rng(2)
    for d, (A_dd, _saddle) in enumerate(blocks):
        solve = _device_solver(nd, d, A_dd, max_nnz)
        r = rng.standard_normal(A_dd.shape[0])
        z = solve(r)
        for _ in range(6):
            z = z + solve(r - A_dd @ z)
        rel = np.linalg.norm(r - A_dd @ z) / np.linalg.norm(r)
        assert rel < 1e-12, (d, rel)
