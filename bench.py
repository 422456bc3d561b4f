"""Benchmark: assembly+solve seconds per Newton iteration on one GPU.

Headline (config #1): the 64x64 Q2/Q1 lid-driven-cavity Navier-Stokes deck
— the reference's ``asmslv`` metric (``src/mm_sol_nonlinear.c``
assembly/solve timers), with ``vs_baseline`` = speedup over a 1-core
reference-style iteration (C++ -O3 scalar element assembly + SuperLU direct
solve on this host).

Runs every config in ONE process, in the order of ``PLAN``, under a wall
budget (``GOMA_BENCH_BUDGET_S``, default 1700 s): a config whose estimate
exceeds what is left is recorded as skipped, and a SIGALRM backstop at
budget + 60 s prints the cumulative result. Every time ends in
``jax.block_until_ready``. Without a GPU the bench exits non-zero and
prints nothing on standard output.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
"configs"}, where "device" names the platform, device kind and count as
JAX reports them and the card's name and power limit as nvidia-smi does.
"""

import json
import os
import signal
import sys
import time

import numpy as np

T0 = time.perf_counter()
BUDGET = float(os.environ.get("GOMA_BENCH_BUDGET_S", "1700"))

SUMMARY = {
    "metric": "",
    "value": None,
    "unit": "s/iter",
    "vs_baseline": None,
    "device": None,
    "configs": {},
}


def log(msg):
    print(f"[{time.perf_counter()-T0:6.0f}s] {msg}", file=sys.stderr,
          flush=True)


def elapsed():
    return time.perf_counter() - T0


def remaining():
    return BUDGET - elapsed()


def emit():
    print(json.dumps(SUMMARY), flush=True)


def _die(signum, frame):
    SUMMARY["configs"]["_interrupted"] = {
        "signal": int(signum), "elapsed_s": round(elapsed(), 1)}
    emit()
    os._exit(0)


def record(name, value):
    SUMMARY["configs"][name] = value
    log(f"bench[{name}]: {value}")


def gate(name, est_s):
    """Budget gate: skip a config whose estimated cost exceeds what's left."""
    if remaining() < est_s:
        record(name, {"skipped": f"budget ({remaining():.0f}s left, "
                                 f"est {est_s:.0f}s)"})
        return False
    return True


# ----------------------------------------------------- assembly microbench
def bench_assembly_micro(n=64, loops=32):
    """Element residual+Jacobian throughput on the device vs one x86 core on
    the SAME work (the NS Q2/Q1 cavity element kernel).

    Two device numbers:
    - ``pass_ms_scan``: per-pass time of the full assembly pass (residual +
      AD element Jacobians + row sums + BC surgery) from a lax.scan of
      ``loops`` data-dependent iterations inside ONE dispatch — device
      throughput without per-call host overhead;
    - ``pass_ms_chained``: the same pass as ``loops`` chained dispatches —
      what the Newton loop's per-iteration "asm" bucket pays.
    """
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _cavity_problem
    from goma_tpu.native import ref_assembly_seconds_per_element

    prob = _cavity_problem(n)
    prob.jacobian_dtype = jnp.float32
    ne = prob.mesh.n_elem
    params = prob.base_params()
    f32 = jnp.float32

    @jax.jit
    def one(x, p):
        # x' = x + eps R chains consecutive calls through a data
        # dependency, so pipelined dispatches cannot be elided; eps is tiny
        # (not 0.0 — the algebraic simplifier folds mul-by-zero)
        R, rs, aux = prob._assemble_fast(x, p, rdt=f32)
        return x + jnp.float32(1e-30) * R.astype(f32), rs

    @jax.jit
    def looped(x, p):
        def body(c, _):
            R, rs, _ = prob._assemble_fast(c, p, rdt=f32)
            return c + jnp.float32(1e-30) * R.astype(c.dtype), rs[0]
        c, outs = jax.lax.scan(body, x, None, length=loops)
        return c[0], outs

    x = jnp.zeros(prob.dofmap.n_dof, dtype=f32)
    # warmups (compile)
    jax.block_until_ready(one(x, params))
    jax.block_until_ready(looped(x, params))
    K = loops
    t0 = time.perf_counter()
    xx = x
    for _ in range(K):
        xx, rs = one(xx, params)
    jax.block_until_ready(xx)
    t_chain = (time.perf_counter() - t0) / K
    t0 = time.perf_counter()
    jax.block_until_ready(looped(x, params))
    t_loop = (time.perf_counter() - t0) / loops

    t_ref = ref_assembly_seconds_per_element()
    if t_ref is None:
        t_ref = 14e-3 / 4096
    best = min(t_loop, t_chain)

    # ---- FLOP/byte accounting (analytic, per element, f32 pass) ----
    # counted from the fastns formulation: linear residual matvec 2*nl^2,
    # convection residual ~1.4k, convection J blocks ~9k (the qabe,qij
    # GEMM dominates), row sums nl^2; table reads Kfix nl^2 + gphi
    # nq*nbu*2 + w nq, J write nl^2, q/r/rs vectors.
    nl, nq, nbu = 22, 9, 9
    flops_pe = (2 * nl * nl                      # Kfix . q
                + 1390 + 9000                    # convection R + J blocks
                + nl * nl)                       # |row| sums
    bytes_pe = 4 * (nl * nl + nq * nbu * 2 + nq  # table reads
                    + nl * nl                    # J write
                    + 6 * nl)                    # q, hist, r, rs traffic
    return {
        "n_elem": ne,
        "elem_us": round(best / ne * 1e6, 4),
        "pass_ms_scan": round(t_loop * 1e3, 3),
        "pass_ms_chained": round(t_chain * 1e3, 3),
        "ref_elem_us_1core": round(t_ref * 1e6, 3),
        "vs_baseline": round(t_ref / (best / ne), 2),
        "flops_per_elem": flops_pe,
        "bytes_per_elem": bytes_pe,
        "achieved_gflops": round(flops_pe * ne / best / 1e9, 2),
        "achieved_gbs": round(bytes_pe * ne / best / 1e9, 2),
        "note": "vs_baseline = 1-core C++ -O3 element R+J time / device "
                "per-element time of the full batched assembly pass "
                "(residual + exact element Jacobians [precomputed linear "
                "part + batched-GEMM convection] + row sums + BC surgery)",
    }


def bench_assembly_micro_sweep():
    """The per-element number at small AND production batch: the 64x64 deck
    (4k elements) is dominated by fixed pass overheads; the 192x192 deck
    (36.9k elements) is the production batch and the headline."""
    out = {"b4096": bench_assembly_micro(n=64, loops=32)}
    if remaining() > 240:
        big = bench_assembly_micro(n=192, loops=8)
        out["b36864"] = big
        out["vs_baseline"] = big["vs_baseline"]
        out["elem_us"] = big["elem_us"]
    else:
        out["vs_baseline"] = out["b4096"]["vs_baseline"]
        out["elem_us"] = out["b4096"]["elem_us"]
    return out


# --------------------------------------------------------------- config #1
def _time_cavity_solver(prob, opts, tag):
    """Warmup + timed full Newton solve; returns (sec_per_iter, res)."""
    import jax.numpy as jnp

    from goma_tpu.solvers import NewtonSolver

    solver = NewtonSolver(prob, opts)
    params = prob.base_params()
    x = jnp.zeros(prob.dofmap.n_dof, dtype=prob.dtype)
    log(f"bench[cavity:{tag}]: warmup full solve (compiles everything)...")
    t0 = time.perf_counter()
    res_w = solver.solve(x, params)
    tw = time.perf_counter() - t0
    log(f"bench[cavity:{tag}]: warmup {tw:.0f}s "
        f"(iters={res_w.iters}, lin={res_w.linear_iters})")
    solver.reset_lagged()
    t0 = time.perf_counter()
    res = solver.solve(x, params)
    t_total = time.perf_counter() - t0
    iters = max(res.iters, 1)
    sec_per_iter = t_total / iters
    log(f"bench[cavity:{tag}]: iters={res.iters} conv={res.converged} "
        f"lin={res.linear_iters}")
    log(f"bench[cavity:{tag}]: asm {res.assembly_time/iters*1000:.0f} ms + "
        f"slv {res.solve_time/iters*1000:.0f} ms = "
        f"{sec_per_iter*1000:.0f} ms/iter (total {t_total:.2f}s)")
    return sec_per_iter, res, t_total, tw


def _cavity_opts(kind, tol=1e-6, max_iter=20):
    from goma_tpu.solvers import NewtonOptions

    if kind == "gmres+ndlu":
        # prep32: far-from-solution iterations run the whole prep at f32;
        # the endgame re-preps and converges in f64.
        # Deep-convergence configs (tol < 1e-8): NEWTON is the
        # mixed-precision refinement loop — keep every f32 Krylov solve
        # LOOSE (eta floor 1e-3, classic EW oversolving safeguard) and
        # take a few extra quadratic/linear Newton steps with f64
        # residuals instead of grinding 120-240-iteration f32 solves
        # against their roundoff floor
        deep = tol < 1e-8
        return NewtonOptions(max_iter=max_iter, tol_residual=tol,
                             linear_tol=1e-4, precond="ndlu",
                             linear_solver="gmres",
                             gmres_restart=60, linear_maxiter=240,
                             ndlu_leaf_max=192, prep32_tol=3e-6,
                             ew_eta_floor=1e-3 if deep else 0.0,
                             ew_endgame="standard" if deep else "tighten")
    if kind == "tpu_direct":
        return NewtonOptions(max_iter=max_iter, tol_residual=tol,
                             linear_solver="tpu_direct", ndlu_leaf_max=192,
                             ndlu_refine=1)
    return NewtonOptions(max_iter=max_iter, tol_residual=tol,
                         linear_tol=1e-4, gmres_restart=240,
                         linear_maxiter=480, precond="twolevel",
                         smooth_sweeps=1)


def bench_cavity():
    import jax.numpy as jnp

    from __graft_entry__ import _cavity_problem

    n = int(os.environ.get("GOMA_BENCH_N", "64"))  # 64: 4096 Q2/Q1 elements
    prob = _cavity_problem(n)
    # mixed-precision Newton-Krylov: f64 residual (full 1e-10-capable
    # convergence), f32 Jacobian + Krylov
    prob.jacobian_dtype = jnp.float32

    # single-variant headline (gmres + lagged selective-inversion NDLU); the
    # ladder falls back only on failure, so a run pays one compile.
    variants = {}
    kinds = tuple(os.environ.get("GOMA_BENCH_CAVITY_KINDS",
                                 "gmres+ndlu,twolevel").split(","))
    for kind in kinds:
        try:
            s, r, t, tw = _time_cavity_solver(prob, _cavity_opts(kind), kind)
        except Exception as e:
            log(f"bench[cavity:{kind}]: FAILED {type(e).__name__}: {e}")
            continue
        if r.converged:
            variants[kind] = (s, r, t, tw)
            break
    if not variants:
        return {"error": "no cavity solver converged"}, None
    best = min(variants, key=lambda k: variants[k][0])
    sec_per_iter, res, t_total, tw = variants[best]
    iters = max(res.iters, 1)
    log(f"bench[cavity]: headline = {best} at {sec_per_iter*1000:.0f} ms/iter")

    log("bench[cavity]: running 1-core reference baseline...")
    den = _ref_iter_denominator(prob, exact_ns=True)

    out = {
        "sec_per_iter": round(sec_per_iter, 6),
        "solver": best,
        "newton_iters": res.iters,
        "linear_iters": res.linear_iters,
        "asm_ms": round(res.assembly_time / iters * 1000, 1),
        "slv_ms": round(res.solve_time / iters * 1000, 1),
        "total_s": round(t_total, 3),
        "warmup_s": round(tw, 1),
        "converged": bool(res.converged),
        "vs_baseline": round(den["ref_iter_s"] / sec_per_iter, 2),
    }
    out.update(den)
    return out, (prob, best)


def bench_cavity_tol1e10(prob, kind):
    """Deep-convergence entry (the BASELINE 1e-10 parity bar) — recorded
    separately AFTER the five configs. A stale lagged factor can balloon
    linear_iters toward linear_maxiter; the staleness policy refactors on
    linear-iteration growth."""
    try:
        s10, r10, t10, tw = _time_cavity_solver(
            prob, _cavity_opts(kind, tol=1e-10, max_iter=25),
            f"tol1e10:{kind}")
        return {
            "solver": kind,
            "converged": bool(r10.converged),
            "newton_iters": r10.iters,
            "linear_iters": r10.linear_iters,
            "sec_per_iter": round(s10, 6),
            "warmup_s": round(tw, 1),
            "res_norms_l2": [float(f"{r[1]:.4e}") for r in r10.res_norms],
            "res_norms_inf": [float(f"{r[2]:.4e}") for r in r10.res_norms],
        }
    except Exception as e:
        return {"error": f"{type(e).__name__}: {e}"[:200]}


def bench_cavity_scaling(sizes=(128, 192)):
    """Size-scaling entries: SuperLU's O(n^1.5) factor and the 1-core
    assembly both grow faster than the batched element work and the
    multifrontal fronts. Each entry carries its own measured 1-core
    denominator."""
    import jax.numpy as jnp

    from __graft_entry__ import _cavity_problem
    from goma_tpu.solvers import NewtonOptions

    out = {}
    for n in sizes:
        if not gate(f"cavity_{n}", 120 + n):
            out[f"cavity_{n}"] = {"skipped": "budget"}
            continue
        try:
            prob = _cavity_problem(n)
            prob.jacobian_dtype = jnp.float32
            leaf = 192 if n <= 128 else 256
            opts = NewtonOptions(max_iter=20, tol_residual=1e-6,
                                 linear_tol=1e-4, precond="ndlu",
                                 linear_solver="gmres", gmres_restart=60,
                                 linear_maxiter=240, ndlu_leaf_max=leaf)
            sec, res, tt, tw = _time_cavity_solver(prob, opts, f"scale{n}")
            den = _ref_iter_denominator(prob, x=res.x, exact_ns=True)
            it = max(res.iters, 1)
            out[f"cavity_{n}"] = {
                "n_dof": prob.dofmap.n_dof,
                "sec_per_iter": round(sec, 6),
                "newton_iters": res.iters,
                "converged": bool(res.converged),
                "asm_ms": round(res.assembly_time / it * 1000, 1),
                "slv_ms": round(res.solve_time / it * 1000, 1),
                "warmup_s": round(tw, 1),
                "vs_baseline": round(den["ref_iter_s"] / sec, 2),
                **den,
            }
        except Exception as e:
            out[f"cavity_{n}"] = {"error": f"{type(e).__name__}: {e}"[:200]}
        record(f"cavity_{n}", out[f"cavity_{n}"])
    return out


def _ref_iter_denominator(prob, x=None, nv2=None, nv1=None, exact_ns=False,
                          splu_reps=2, params=None):
    """1-core reference-style Newton-iteration time for THIS deck: compiled
    C++ -O3 scalar element assembly (exact NS kernel for the cavity, the
    generic multi-field kernel otherwise) + SuperLU direct solve on the
    deck's own assembled matrix (min of ``splu_reps`` repeats)."""
    import jax.numpy as jnp
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from goma_tpu.native import (ref_assembly_generic_seconds_per_element,
                                 ref_assembly_seconds_per_element)

    ne = prob.mesh.n_elem
    if exact_ns:
        t_elem = ref_assembly_seconds_per_element()
        if t_elem is None:
            t_elem = 14e-3 / 4096
    else:
        t_elem = ref_assembly_generic_seconds_per_element(nv2, nv1)
        if t_elem is None:
            t_elem = (9 * nv2 + 4 * nv1) ** 2 / 22.0**2 * 14e-3 / 4096
    if x is None:
        x = jnp.zeros(prob.dofmap.n_dof, dtype=prob.dtype)
    p = dict(prob.base_params() if params is None else params)
    # transient decks: assemble the representative matrix in steady form
    p.setdefault("ct", jnp.asarray(0.0, dtype=prob.dtype))
    p.setdefault("hist", jnp.zeros(prob.dofmap.n_dof, dtype=prob.dtype))
    R, vals = prob._assemble(jnp.asarray(x, dtype=prob.dtype), p)
    A = sp.csr_matrix(
        (np.asarray(vals, dtype=np.float64), prob.pattern.indices,
         prob.pattern.indptr), shape=(prob.pattern.n,) * 2).tocsc()
    b = np.asarray(R, dtype=np.float64)
    ts = []
    for _ in range(splu_reps):
        t0 = time.perf_counter()
        lu = spla.splu(A)
        _ = lu.solve(b)
        ts.append(time.perf_counter() - t0)
        if ts[-1] > 30.0:
            break  # a 30+ s factor is already timing-stable
    t_direct = min(ts)
    t_iter = t_elem * ne + t_direct
    log(f"bench[ref]: 1-core iter ~ {t_iter*1000:.0f} ms "
        f"(asm {t_elem*ne*1000:.1f} + splu {t_direct*1000:.0f}, "
        f"min of {len(ts)})")
    return {"ref_iter_s": round(t_iter, 4),
            "ref_asm_s": round(t_elem * ne, 4),
            "ref_slv_s": round(t_direct, 4)}


def _steady_sec_per_iter(prob, opts, x0, params, ref_fields=None):
    """Warm (compile) + timed solve of a steady deck; s/Newton-iter."""
    import jax.numpy as jnp

    from goma_tpu.solvers import NewtonSolver

    solver = NewtonSolver(prob, opts)
    t0 = time.perf_counter()
    rw = solver.solve(x0, params)
    tw = time.perf_counter() - t0
    solver.reset_lagged()
    t0 = time.perf_counter()
    res = solver.solve(x0, params)
    tt = time.perf_counter() - t0
    it = max(res.iters, 1)
    out = {
        "sec_per_iter": round(tt / it, 6),
        "newton_iters": res.iters,
        "linear_iters": res.linear_iters,
        "converged": bool(res.converged),
        "total_s": round(tt, 3),
        "warmup_s": round(tw, 1),
    }
    if ref_fields is not None and res.converged:
        den = _ref_iter_denominator(prob, x=res.x, nv2=ref_fields[0],
                                    nv1=ref_fields[1], params=params)
        out.update(den)
        out["vs_baseline"] = round(den["ref_iter_s"] / out["sec_per_iter"], 2)
    return out


# --------------------------------------------------------------- config #2
def bench_buoyant(direct_kind="gmres_ndlu"):
    """Coupled momentum+energy+species (buoyant convection; mirrors
    examples/buoyant_convection.py)."""
    import jax.numpy as jnp

    from goma_tpu.fem import Problem
    from goma_tpu.mesh import rectangle_mesh
    from goma_tpu.physics import Continuity, Energy, Momentum, Species
    from goma_tpu.physics.materials import BoussinesqBodyForce
    from goma_tpu.solvers import NewtonOptions

    # 48x48 (~47k dof with 5 fields/node): production-shaped
    n, Ra, Pr = 48, 1e4, 0.71
    mesh = rectangle_mesh(n, n, elem="QUAD9")
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    prob = Problem(
        mesh,
        [Momentum(dim=2, transient=False), Continuity(),
         Energy(interp="Q2", transient=False),
         Species(n_species=1, interp="Q2", transient=False)],
        {"rho": 1.0, "mu": Pr, "k": 1.0, "Cp": 1.0, "diffusivity": 1.0,
         "body_force": BoussinesqBodyForce([0.0, Ra * Pr], beta=-1.0, T0=0.5)})
    for ns in ("left", "right", "top", "bottom"):
        prob.add_dirichlet(ns, "velocity", 0, 0.0)
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("left", "temperature", 0, 1.0)
    prob.add_dirichlet("right", "temperature", 0, 0.0)
    prob.add_dirichlet("left", "species", 0, 1.0)
    prob.add_dirichlet("right", "species", 0, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.finalize()
    prob.jacobian_dtype = jnp.float32
    if direct_kind == "gmres_ndlu":
        opts = NewtonOptions(max_iter=15, tol_residual=1e-6, linear_tol=1e-4,
                             precond="ndlu", linear_solver="gmres",
                             gmres_restart=60, linear_maxiter=240,
                             ndlu_leaf_max=256, ew_eta_floor=1e-3,
                             ew_endgame="standard")
    elif direct_kind == "tpu_direct":
        opts = NewtonOptions(max_iter=15, tol_residual=1e-6,
                             linear_solver="tpu_direct", ndlu_leaf_max=256)
    else:
        opts = NewtonOptions(max_iter=15, tol_residual=1e-6, linear_tol=1e-4,
                             precond="twolevel", smooth_sweeps=1,
                             gmres_restart=160, linear_maxiter=1000)
    out = _steady_sec_per_iter(prob, opts,
                               jnp.zeros(prob.dofmap.n_dof,
                                         dtype=prob.dtype),
                               prob.base_params(),
                               ref_fields=(4, 1))  # u,v,T,Y Q2; p Q1
    out["linear_solver"] = direct_kind
    return out


# --------------------------------------------------------------- config #4
def bench_viscoelastic(direct_kind="gmres_ndlu"):
    """EVSS-F/DEVSS Oldroyd-B channel at Wi = lam*U/H ~ 1.5 from a ZERO
    initial guess, so the solve takes >=5 production-shaped Newton
    iterations."""
    import jax.numpy as jnp

    from goma_tpu.fem import Problem
    from goma_tpu.mesh import rectangle_mesh
    from goma_tpu.physics import (Continuity, Momentum,
                                  VelocityGradientProjection, VEStress)
    from goma_tpu.solvers import NewtonOptions

    # 64x32 (~34k dof with u,v Q2 + p,3S,4G Q1)
    n, lam, mu_p, mu_s, G, H = 32, 1.0, 1.0, 0.5, 2.0, 1.0
    mu_tot = mu_p + mu_s
    mesh = rectangle_mesh(2 * n, n, elem="QUAD9", xlim=(0, 2.0), ylim=(0, H))
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    prob = Problem(
        mesh,
        [Momentum(dim=2, transient=False, convection=False,
                  ve_stress_modes=1, devss_mu=mu_p),
         Continuity(),
         VEStress(0, dim=2, lam=lam, mu_p=mu_p, model="oldroyd_b",
                  interp="Q1", transient=False),
         VelocityGradientProjection(dim=2, interp="Q1")],
        {"rho": 0.0, "mu": mu_s, "body_force": np.array([G, 0.0])})
    uex = lambda c: G / (2 * mu_tot) * c[:, 1] * (H - c[:, 1])
    for ns in ("top", "bottom"):
        prob.add_dirichlet(ns, "velocity", 0, 0.0)
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    for ns in ("left", "right"):
        prob.add_dirichlet(ns, "velocity", 0, uex)
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.finalize()
    prob.jacobian_dtype = jnp.float32
    x0 = jnp.zeros(prob.dofmap.n_dof, dtype=prob.dtype)
    if direct_kind == "gmres_ndlu":
        # loose-eta inexact Newton (see _cavity_opts deep note): the 1e-8
        # nonlinear target is reached through extra cheap Newton steps
        # instead of 180-iteration f32 Krylov grinds
        opts = NewtonOptions(max_iter=25, tol_residual=1e-8, linear_tol=1e-4,
                             precond="ndlu", linear_solver="gmres",
                             gmres_restart=60, linear_maxiter=240,
                             ndlu_leaf_max=192, ew_eta_floor=1e-3,
                             ew_endgame="standard")
    elif direct_kind == "tpu_direct":
        opts = NewtonOptions(max_iter=25, tol_residual=1e-8,
                             linear_solver="tpu_direct", ndlu_leaf_max=192)
    else:
        opts = NewtonOptions(max_iter=25, tol_residual=1e-8, linear_tol=1e-5,
                             precond="twolevel", smooth_sweeps=1,
                             gmres_restart=160, linear_maxiter=1500)
    out = _steady_sec_per_iter(prob, opts, x0, prob.base_params(),
                               ref_fields=(2, 8))  # u,v Q2; p+3S+4G Q1
    out["linear_solver"] = direct_kind
    return out


def _transient_sec_per_iter(make, warm_t, timed_t, ref_fields=None):
    """Warm a TransientSolver over [0, warm_t], then time the continuation
    over [warm_t, warm_t+timed_t]; s per Newton iteration of the timed leg."""
    log("transient: building problem...")
    ts, x0, params = make()
    log("transient: warm leg (first compiles)...")
    t0 = time.perf_counter()
    r1 = ts.run(x0, params)
    tw = time.perf_counter() - t0
    log(f"transient: warm leg done in {tw:.0f}s ({len(r1.steps)} steps); "
        "timed leg...")
    t0 = time.perf_counter()
    ts.topts.t_end = warm_t + timed_t
    r2 = ts.run(r1.x, params, t0=r1.t, xdot0=r1.xdot)
    tt = time.perf_counter() - t0
    log(f"transient: timed leg done in {tt:.0f}s")
    nit = sum(s.newton_iters for s in r2.steps if s.converged)
    out = {
        "sec_per_iter": round(tt / max(nit, 1), 6),
        "newton_iters": nit,
        "steps": len(r2.steps),
        "total_s": round(tt, 3),
        "warmup_s": round(tw, 1),
    }
    if ref_fields is not None and nit > 0:
        den = _ref_iter_denominator(ts.problem, x=r2.x, nv2=ref_fields[0],
                                    nv1=ref_fields[1], params=params)
        out.update(den)
        out["vs_baseline"] = round(den["ref_iter_s"] / out["sec_per_iter"], 2)
    return out


# --------------------------------------------------------------- config #3
def bench_slot_coater(direct_kind="gmres_ndlu"):
    """ALE free-surface slot coater (examples/slot_coater.py build())."""
    import importlib

    sys.path.insert(0, ".")
    sc = importlib.import_module("examples.slot_coater")

    def make():
        import jax.numpy as jnp

        # 96x24 (~40k dof): production-shaped slot coater
        if direct_kind == "gmres_ndlu":
            # f32 Jacobian/Krylov with loose per-step linear solves (Newton
            # absorbs the inexactness; the deck's 1e-9 linear_tol ground f32
            # Krylov at its floor)
            prob, ts, x0 = sc.build(
                nx=96, ny=24, t_end=0.04, linear_solver="gmres",
                jacobian_dtype=jnp.float32,
                newton_overrides=dict(precond="ndlu", gmres_restart=60,
                                      linear_maxiter=240,
                                      ndlu_leaf_max=256, linear_tol=1e-5,
                                      ew_eta_floor=1e-3,
                                      ew_endgame="standard",
                                      prep32_tol=3e-6))
        else:
            prob, ts, x0 = sc.build(nx=96, ny=24, t_end=0.04,
                                    linear_solver=direct_kind)
        return ts, x0, prob.base_params()

    out = _transient_sec_per_iter(make, 0.04, 0.08,
                                  ref_fields=(4, 1))  # u,v,dx,dy Q2; p Q1
    out["linear_solver"] = (direct_kind if direct_kind != "direct"
                            else "direct(host)")
    return out


# --------------------------------------------------------------- config #5
def bench_two_phase(direct_kind="gmres_ndlu"):
    """Level-set two-phase static bubble with CSF tension (mirrors
    examples/two_phase_bubble.py run_static)."""
    import jax.numpy as jnp

    from goma_tpu.fem import Problem
    from goma_tpu.mesh import rectangle_mesh
    from goma_tpu.physics import (Continuity, CSFSurfaceTension, FillEquation,
                                  Momentum)
    from goma_tpu.solvers import NewtonOptions
    from goma_tpu.solvers.transient import TimeOptions, TransientSolver

    def make():
        # 48x48 (~31k dof)
        n, sigma, r0 = 48, 1.0, 0.5
        mesh = rectangle_mesh(n, n, elem="QUAD9", xlim=(-1, 1), ylim=(-1, 1))
        mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
        prob = Problem(
            mesh,
            [Momentum(dim=2, transient=True), Continuity(),
             CSFSurfaceTension(dim=2, sigma=sigma),
             FillEquation(interp="Q2", supg=0.0, transient=True)],
            {"rho": 1.0, "mu": 1.0})
        for ns in ("left", "right", "top", "bottom"):
            prob.add_dirichlet(ns, "velocity", 0, 0.0)
            prob.add_dirichlet(ns, "velocity", 1, 0.0)
        prob.add_dirichlet("pin", "pressure", 0, 0.0)
        prob.finalize()
        prob.jacobian_dtype = jnp.float32
        F0 = np.linalg.norm(mesh.coords, axis=1) - r0
        x0 = prob.set_nodal_field(np.zeros(prob.dofmap.n_dof), "fill", 0, F0)
        if direct_kind == "gmres_ndlu":
            nopts = NewtonOptions(max_iter=10, tol_residual=1e-8,
                                  linear_solver="gmres", precond="ndlu",
                                  linear_tol=1e-6, gmres_restart=60,
                                  linear_maxiter=240, ndlu_leaf_max=256)
        else:
            nopts = NewtonOptions(max_iter=10, tol_residual=1e-8,
                                  linear_solver=direct_kind)
        ts = TransientSolver(prob, nopts,
                             TimeOptions(dt0=0.02, t_end=0.04, adapt=False))
        return ts, x0, prob.base_params(ls_eps=jnp.asarray(0.2))

    out = _transient_sec_per_iter(make, 0.04, 0.04,
                                  ref_fields=(3, 1))  # u,v,F Q2; p Q1
    out["linear_solver"] = (direct_kind if direct_kind != "direct"
                            else "direct(host)")
    return out


PLAN = ["cavity_ns", "asm_element", "buoyant_mes", "viscoelastic",
        "two_phase_ls", "slot_coater_ale", "cavity_tol1e10"]
if os.environ.get("GOMA_BENCH_SCALING", "1") != "0":
    PLAN += ["cavity_128", "cavity_192"]
GATE_S = 120  # least budget left that a config may start with


def main():
    import jax

    from goma_tpu.utils.compile_cache import enable_compile_cache
    from goma_tpu.utils.device import card_line

    cache_dir = enable_compile_cache()
    jax.config.update("jax_enable_x64", True)
    devs = jax.devices()
    if devs[0].platform != "gpu":
        log(f"bench: no GPU (jax.devices()[0].platform = "
            f"{devs[0].platform!r}); nothing measured")
        return 2
    SUMMARY["device"] = {"platform": devs[0].platform,
                         "kind": devs[0].device_kind, "count": len(devs),
                         "card": card_line()}
    log(f"bench: {SUMMARY['device']}; compile cache at {cache_dir}; "
        f"budget {BUDGET:.0f}s")
    SUMMARY["metric"] = (
        "assembly+solve sec per Newton iter (NS cavity 64x64 Q2Q1, 37507 "
        "dof, f64 residual/f32 Krylov; vs_baseline = speedup over 1-core "
        "reference-style iteration (C++ -O3 assembly + SuperLU direct)); "
        "'configs' = all five BASELINE decks + asm_element microbench + "
        "tol1e10 + size scaling")

    signal.signal(signal.SIGTERM, _die)
    signal.signal(signal.SIGALRM, _die)
    signal.alarm(max(int(BUDGET) + 60, 60))  # backstop behind the gates
    for name in PLAN:
        if not gate(name, GATE_S):
            continue
        try:
            res = run_config(name)
        except Exception as e:  # record and go on with the next config
            res = {"error": f"{type(e).__name__}: {e}"[:300]}
        record(name, res)
        if name == "cavity_ns" and "sec_per_iter" in res:
            SUMMARY["value"] = res["sec_per_iter"]
            SUMMARY["vs_baseline"] = res.get("vs_baseline")
    SUMMARY["configs"]["_elapsed_s"] = round(elapsed(), 1)
    emit()
    return 0


_CAVITY_STATE = {}


def run_config(name):
    """Run ONE config, return its result dict."""
    if name == "asm_element":
        return bench_assembly_micro_sweep()
    if name == "cavity_ns":
        cav, state = bench_cavity()
        _CAVITY_STATE["state"] = state
        return cav
    if name == "cavity_tol1e10":
        state = _CAVITY_STATE.get("state")
        if state is None:
            cav, state = bench_cavity()
        return bench_cavity_tol1e10(*state)
    if name.startswith("cavity_") and name.split("_")[1].isdigit():
        n = int(name.split("_")[1])
        return bench_cavity_scaling(sizes=(n,)).get(name,
                                                    {"error": "gated"})
    ladder = {
        "buoyant_mes": (bench_buoyant,
                        ["gmres_ndlu", "tpu_direct", "twolevel"]),
        "viscoelastic": (bench_viscoelastic,
                         ["gmres_ndlu", "tpu_direct", "twolevel"]),
        "slot_coater_ale": (bench_slot_coater,
                            ["gmres_ndlu", "tpu_direct", "direct"]),
        "two_phase_ls": (bench_two_phase,
                         ["gmres_ndlu", "tpu_direct", "direct"]),
    }
    fn, kinds = ladder[name]
    res = {"error": "no solver rung ran"}
    for kind in kinds:
        try:
            res = fn(direct_kind=kind)
        except Exception as e:
            res = {"error": f"{type(e).__name__}: {e}"[:200]}
            log(f"bench[{name}:{kind}]: FAILED {res['error']}")
            continue
        ok = res.get("converged", res.get("newton_iters", 1) > 0)
        if ok:
            break
        log(f"bench[{name}]: {kind} did not converge; trying next rung")
    return res


if __name__ == "__main__":
    sys.exit(main())
