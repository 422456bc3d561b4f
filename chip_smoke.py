"""Smoke test of the Newton–NDLU main path on an NVIDIA GPU.

Run from the repository root:

    python chip_smoke.py           # one card: fronts, cavity, deck, transient
    python chip_smoke.py --four    # four cards: the partitioned StackedNDLU
                                   # path and its single-card comparison only

Every phase prints one JSON line with the card's name and power limit
(``nvidia-smi``) beside its numbers; the last line of standard output is
``{"ok": true, "device": {"platform", "kind", "count"}}``. Without a GPU,
or when any phase misses its bound, the script exits non-zero and prints
no such line. Weights are replaced by data made from ``--seed``; each
device result is compared with a plain f64 reference on the host CPU
(scipy's ``spsolve`` or the host SuperLU Newton path).

Numbers here differ from run to run in their last bits: ``segment_sum``
assembly sums with atomics on the GPU, in no fixed order. Every bound below
is far above that noise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CARD = "unknown"

# --- bounds, each with its reason
# f32 factor + f64 iterative refinement: the CPU tests reach 1e-12 at 6x6 to
# 8x8; 1e-10 leaves room for a thousand-fold worse condition number at 64x64
FRONTS_REFINED_TOL = 1e-10
# one unrefined f32 selective-inverse apply is a preconditioner: ~eps_f32
# times the fronts' condition numbers
FRONTS_PRECOND_TOL = 1e-3
# Newton stops at ||R|| <= 1e-9 on the row-scaled residual; solutions of two
# such solves agree to ~cond * 1e-9
CAVITY_SOL_TOL = 1e-6
# f32 Jacobian/Krylov with per-step Newton tolerance 3e-8 against the f64
# host-direct steps: each step's state agrees to ~cond * 3e-8
TRANSIENT_SOL_TOL = 1e-5
# partitioned vs single-card Newton at tol 1e-9 (tests/test_partitioned.py
# uses 2e-7 at 8x8; the 64x64 operator is worse conditioned)
FOUR_ATOL = 1e-6


class PhaseFailed(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def emit(phase, **kw):
    print(json.dumps({"phase": phase, "card": CARD, **kw}, default=float),
          flush=True)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def l2_history(res):
    return [float(f"{r[1]:.4e}") for r in res.res_norms]


# ---------------------------------------------------------------- phases
def phase_fronts(n, seed):
    """NDLU on the n x n cavity Jacobian: the bench preconditioner path
    (f32, selective inversion, one unrefined apply) and the direct rung
    (f32 substitution + f64 refinement), against scipy spsolve in f64."""
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from __graft_entry__ import _cavity_problem
    from goma_tpu.fem.sparsity import EllOperator, sym_sum_scale
    from goma_tpu.solvers.ndlu import NDLU, node_clusters, zero_diag_defer_mask
    from goma_tpu.solvers.twolevel import _saddle_mask

    prob = _cavity_problem(n)
    pat = prob.pattern
    rng = np.random.default_rng(seed)
    x = jnp.asarray(0.1 * rng.standard_normal(prob.dofmap.n_dof))
    R, vals = prob._assemble(x, prob.base_params())
    vals, scale = sym_sum_scale(vals, jnp.asarray(pat.rows),
                                jnp.asarray(pat.indices), pat.n)
    b = scale * R
    A = sp.csr_matrix((np.asarray(vals, np.float64), pat.indices,
                       pat.indptr), shape=(pat.n, pat.n))
    bh = np.asarray(b, np.float64)
    xs = spla.spsolve(A.tocsc(), bh)
    clusters = node_clusters(prob)

    def resid(xd):
        xd = np.asarray(xd, np.float64)
        return float(np.linalg.norm(bh - A @ xd) / np.linalg.norm(bh))

    out = {"n": n, "n_dof": pat.n}
    # the bench preconditioner path (NewtonSolver precond="ndlu")
    nd = NDLU(pat, leaf_max=192, dtype=jnp.float32,
              defer_dofs=_saddle_mask(prob), invert=True, clusters=clusters)
    out["levels"] = [(lv.nn, lv.smax, lv.bmax) for lv in nd.levels]
    t0 = time.perf_counter()
    fac = jax.block_until_ready(nd.factor(vals))
    out["precond_factor_first_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fac = jax.block_until_ready(nd.factor(vals))
    out["precond_factor_s"] = time.perf_counter() - t0
    x1 = nd.solve(fac, b)
    out["precond_resid"] = resid(x1)
    out["precond_err_vs_spsolve"] = rel(x1, xs)
    # the direct rung (NewtonSolver linear_solver="tpu_direct")
    nd2 = NDLU(pat, leaf_max=192, dtype=jnp.float32,
               defer_dofs=zero_diag_defer_mask(pat, vals), clusters=clusters)
    fac2 = nd2.factor(vals)
    ell = EllOperator(pat)
    x2 = nd2.solve_refined(fac2, b, lambda v: ell.matvec(vals, v), refine=2,
                           rel_tol=0.1 * FRONTS_REFINED_TOL, max_refine=20)
    out["direct_resid"] = resid(x2)
    out["direct_err_vs_spsolve"] = rel(x2, xs)
    out["bounds"] = {"precond_resid": FRONTS_PRECOND_TOL,
                     "direct_resid": FRONTS_REFINED_TOL}
    emit("fronts", **out)
    check(out["precond_resid"] <= FRONTS_PRECOND_TOL,
          f"fronts: preconditioner residual {out['precond_resid']:.3e}")
    check(out["direct_resid"] <= FRONTS_REFINED_TOL,
          f"fronts: refined direct residual {out['direct_resid']:.3e}")


def _timed_newton(prob, opts):
    """Warm-up solve (compiles), then a timed solve from the same start."""
    import jax.numpy as jnp

    from goma_tpu.solvers import NewtonSolver

    solver = NewtonSolver(prob, opts)
    x0 = jnp.zeros(prob.dofmap.n_dof, dtype=prob.dtype)
    params = prob.base_params()
    t0 = time.perf_counter()
    solver.solve(x0, params)
    warm = time.perf_counter() - t0
    solver.reset_lagged()
    t0 = time.perf_counter()
    res = solver.solve(x0, params)
    total = time.perf_counter() - t0
    return res, warm, total / max(res.iters, 1)


def _cpu_reference_newton(n, tol):
    """The plain reference: the same deck on the host CPU in f64 with the
    host SuperLU linear solve."""
    import jax

    from __graft_entry__ import _cavity_problem
    from goma_tpu.solvers import NewtonOptions, NewtonSolver

    with jax.default_device(jax.devices("cpu")[0]):
        prob = _cavity_problem(n)
        res = NewtonSolver(prob, NewtonOptions(
            max_iter=20, tol_residual=tol, linear_solver="direct")).solve(
            np.zeros(prob.dofmap.n_dof), prob.base_params())
    return res


def phase_cavity(n):
    """Full Newton on the n x n cavity: GMRES + NDLU (the bench options)
    and the NDLU direct rung, against the host f64 SuperLU Newton."""
    import jax.numpy as jnp

    from __graft_entry__ import CAVITY64_CPU_RES_L2, _cavity_problem
    from goma_tpu.solvers import NewtonOptions

    tol = 1e-9
    ref = _cpu_reference_newton(n, tol)
    check(ref.converged, "cavity: CPU reference did not converge")
    runs = {
        "gmres+ndlu": NewtonOptions(
            max_iter=20, tol_residual=tol, linear_tol=1e-4, precond="ndlu",
            linear_solver="gmres", gmres_restart=60, linear_maxiter=240,
            ndlu_leaf_max=192, prep32_tol=3e-6, ew_eta_floor=1e-3,
            ew_endgame="standard"),
        "tpu_direct": NewtonOptions(
            max_iter=20, tol_residual=tol, linear_solver="tpu_direct",
            ndlu_leaf_max=192, ndlu_refine=1),
    }
    prob = _cavity_problem(n)
    prob.jacobian_dtype = jnp.float32  # f64 residual, f32 Jacobian/Krylov
    failures = []
    for name, opts in runs.items():
        res, warm, spi = _timed_newton(prob, opts)
        err = rel(res.x, ref.x)
        emit("cavity", n=n, solver=name, converged=bool(res.converged),
             newton_iters=res.iters, cpu_ref_iters=ref.iters,
             res_l2=l2_history(res), cpu_ref_res_l2=l2_history(ref),
             cpu_record_tol1e6_res_l2=CAVITY64_CPU_RES_L2 if n == 64 else None,
             linear_iters=[int(i) for i in res.linear_iters],
             sol_rel_err_vs_cpu=err, bound=CAVITY_SOL_TOL,
             sec_per_iter_info=spi, warmup_s_info=warm)
        if not res.converged:
            failures.append(f"{name} did not converge")
        if err > CAVITY_SOL_TOL:
            failures.append(f"{name} solution rel err {err:.3e}")
        if res.iters != ref.iters:
            failures.append(f"{name} took {res.iters} Newton iterations, "
                            f"the CPU reference {ref.iters}")
    check(not failures, "cavity: " + "; ".join(failures))


def phase_deck(n):
    """``python -m goma_tpu`` on examples/decks/cavity.json at n x n, with
    the deck's own solver options (``precond="auto"``). The default n=72
    (84k dof) is the largest cavity whose Q1 coarse space (73^2 * 3 dofs)
    stays under the 16,000-dof limit at which "auto" still picks the
    two-level preconditioner with its dense coarse solve."""
    import jax

    from goma_tpu.__main__ import main as cli_main

    with open(os.path.join(HERE, "examples", "decks", "cavity.json")) as f:
        deck = json.load(f)
    deck["mesh"]["nx"] = deck["mesh"]["ny"] = n
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "cavity.json")
        with open(path, "w") as f:
            json.dump(deck, f)
        t0 = time.perf_counter()
        rc = cli_main([path])
        wall = time.perf_counter() - t0
    stats = jax.devices()[0].memory_stats() or {}
    emit("deck", n=n, rc=rc, wall_s_info=wall,
         peak_bytes_in_use=stats.get("peak_bytes_in_use"))
    check(rc == 0, f"deck: CLI returned {rc}")


def _slot_build(nx, ny, gpu):
    """The bench's slot coater: gmres+ndlu overrides with an f32 Jacobian
    on the GPU, or f64 with the host direct solve for the CPU reference."""
    import jax.numpy as jnp

    from examples.slot_coater import build

    if not gpu:
        return build(nx=nx, ny=ny, t_end=0.04, linear_solver="direct")
    return build(
        nx=nx, ny=ny, t_end=0.04, linear_solver="gmres",
        jacobian_dtype=jnp.float32,
        newton_overrides=dict(precond="ndlu", gmres_restart=60,
                              linear_maxiter=240, ndlu_leaf_max=256,
                              linear_tol=1e-5, ew_eta_floor=1e-3,
                              ew_endgame="standard", prep32_tol=3e-6))


def _steps(res):
    return [(s.t, s.dt, s.newton_iters, bool(s.converged)) for s in res.steps]


def _converged(res):
    return res.n_failures == 0 and all(s.converged for s in res.steps)


def phase_transient(nx, ny, ref_nx, ref_ny):
    """ALE slot coater (rotated capillary BCs, the transient driver).

    At nx x ny on the GPU: the bench's warm leg [0, 0.04] and its timed
    leg [0.04, 0.12] (the continuation after which this deck once hung);
    every step must converge. At ref_nx x ref_ny: the warm leg on the GPU
    against the same steps in f64 with the host direct solve on the CPU
    (the CPU reference at the full size takes several minutes)."""
    import jax

    prob, ts, x0 = _slot_build(nx, ny, gpu=True)
    params = prob.base_params()
    t0 = time.perf_counter()
    warm = ts.run(x0, params)
    t_warm = time.perf_counter() - t0
    ts.topts.t_end = 0.12
    t0 = time.perf_counter()
    timed = ts.run(warm.x, params, t0=warm.t, xdot0=warm.xdot)
    t_timed = time.perf_counter() - t0

    prob_g, ts_g, x0_g = _slot_build(ref_nx, ref_ny, gpu=True)
    small = ts_g.run(x0_g, prob_g.base_params())
    with jax.default_device(jax.devices("cpu")[0]):
        prob_c, ts_c, x0_c = _slot_build(ref_nx, ref_ny, gpu=False)
        t0 = time.perf_counter()
        ref = ts_c.run(x0_c, prob_c.base_params())
        t_ref = time.perf_counter() - t0
    err = rel(small.x, ref.x)
    emit("transient", nx=nx, ny=ny, warm_steps=_steps(warm),
         timed_steps=_steps(timed), t=timed.t,
         n_failures=warm.n_failures + timed.n_failures,
         warm_wall_s_info=t_warm, timed_wall_s_info=t_timed,
         compared_at=[ref_nx, ref_ny], steps=_steps(small),
         cpu_ref_steps=_steps(ref), sol_rel_err_vs_cpu=err,
         bound=TRANSIENT_SOL_TOL, cpu_ref_wall_s_info=t_ref)
    check(_converged(warm) and _converged(timed) and _converged(small),
          "transient: a GPU step failed to converge")
    check(abs(timed.t - 0.12) < 1e-12, f"transient: stopped at t={timed.t}")
    check(abs(small.t - ref.t) < 1e-12, "transient: end times differ")
    check(err <= TRANSIENT_SOL_TOL, f"transient: state rel err {err:.3e}")


def phase_four(n):
    """Partitioned Newton with the StackedNDLU subdomain solve over every
    device, and the ``"distributed": true`` deck route, against the
    single-card NewtonSolver of the same deck."""
    import jax

    from goma_tpu.input.deck import build_problem, run_deck
    from goma_tpu.parallel.partitioned import (PartitionedNewtonSolver,
                                               PartitionedProblem)
    from goma_tpu.solvers import NewtonOptions, NewtonSolver

    with open(os.path.join(HERE, "examples", "decks", "cavity.json")) as f:
        deck = json.load(f)
    deck["mesh"]["nx"] = deck["mesh"]["ny"] = n
    tol, ltol = 1e-9, 1e-9
    prob, _echo = build_problem(deck)
    x0 = np.zeros(prob.dofmap.n_dof)
    params = prob.base_params()
    single = NewtonSolver(prob, NewtonOptions(
        max_iter=12, tol_residual=tol, linear_tol=ltol, gmres_restart=60,
        linear_maxiter=2000, forcing="fixed")).solve(x0, params)
    check(single.converged, "four: single-card reference did not converge")

    pp = PartitionedProblem(prob)  # 1-D mesh over jax.devices()
    t0 = time.perf_counter()
    part = PartitionedNewtonSolver(
        pp, max_iter=12, tol_residual=tol, linear_tol=ltol, restart=60,
        linear_maxiter=2000, smoother="ndlu").solve(x0, params)
    wall = time.perf_counter() - t0
    xs = pp.scatter_global(np.asarray(part.x))
    shard_devs = sorted(str(s.device) for s in xs.addressable_shards)

    ddeck = dict(deck)
    ddeck["solver"] = dict(deck["solver"], distributed=True, smoother="ndlu",
                           linear_tol=ltol)
    _p, droute, _e = run_deck(ddeck)

    failures = []
    for name, r in (("partitioned", part), ("deck_distributed", droute)):
        diff = float(np.max(np.abs(np.asarray(r.x) - np.asarray(single.x))))
        emit("four", route=name, n=n, n_devices=pp.n_dev,
             converged=bool(r.converged), newton_iters=r.iters,
             single_iters=single.iters,
             res_l2=[float(f"{v[1]:.4e}") for v in r.res_norms],
             single_res_l2=l2_history(single),
             linear_iters=[int(i) for i in r.linear_iters],
             max_abs_diff=diff, atol=FOUR_ATOL, shard_devices=shard_devs,
             wall_s_info=wall if name == "partitioned" else None)
        if not r.converged:
            failures.append(f"{name} did not converge")
        if r.iters != single.iters:
            failures.append(f"{name} {r.iters} vs single {single.iters} its")
        if diff > FOUR_ATOL:
            failures.append(f"{name} max |diff| {diff:.3e}")
    if len(set(shard_devs)) != len(jax.devices()):
        failures.append(f"shards on {shard_devs}, not on every device")
    check(not failures, "four: " + "; ".join(failures))


# ------------------------------------------------------------------ main
def main(argv=None, *, allow_cpu=False):
    """Run the phases; 0 on success. ``allow_cpu`` is the test seam that
    lets a CPU-only rehearsal past the device check (never set by the
    command line)."""
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card partitioned phase")
    ap.add_argument("--cavity-n", type=int, default=64)
    ap.add_argument("--deck-n", type=int, default=72)
    ap.add_argument("--slot", type=int, nargs=2, default=(96, 24),
                    metavar=("NX", "NY"))
    ap.add_argument("--slot-ref", type=int, nargs=2, default=(48, 12),
                    metavar=("NX", "NY"),
                    help="slot-coater size of the GPU-vs-CPU comparison")
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    # fails outside a checkout of the repository
    from goma_tpu.utils.device import card_line

    CARD = card_line()
    print(CARD, flush=True)  # before JAX touches the card

    import jax

    jax.config.update("jax_enable_x64", True)
    from goma_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    devs = jax.devices()
    dev = devs[0]
    if dev.platform != "gpu" and not allow_cpu:
        print(f"chip_smoke: no GPU (jax.devices()[0].platform = "
              f"{dev.platform!r})", file=sys.stderr)
        return 2
    emit("device", platform=dev.platform, kind=dev.device_kind,
         count=len(devs), compile_cache=cache)

    if a.four:
        check(len(devs) == 4 or allow_cpu,
              f"--four needs 4 devices, found {len(devs)}")
        phase_four(a.cavity_n)
    else:
        phase_fronts(a.cavity_n, a.seed)
        phase_cavity(a.cavity_n)
        phase_deck(a.deck_n)
        phase_transient(*a.slot, *a.slot_ref)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
