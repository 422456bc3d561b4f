"""Parameter continuation: zeroth/first order and pseudo-arclength.

Parity: reference ``src/ac_conti.c:104 continue_problem`` (zeroth/first-order
continuation with adaptive parameter step), ``src/ac_hunt.c:91 hunt_problem``
(multi-parameter sweeps), and LOCA's arclength bordering
(``src/loca_lib.c:74 con_lib``, ``src/loca_bord.c``).

Design distinctions:
- the parameter enters the residual through the ``params`` pytree, so the
  sensitivity dR/dlambda is one ``jax.jvp`` through the assembled residual —
  no hand-coded parameter derivatives (reference: ``soln_sens`` /
  ``update_parameterAC`` machinery);
- the bordered arclength solve reuses the same linear stack (two solves +
  2x2 Schur), the same structure the reference uses for LOCA bordering.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import jax
import jax.numpy as jnp

from goma_tpu.solvers.newton import NewtonOptions, NewtonResult, NewtonSolver


@dataclass
class ContinuationStep:
    lam: float
    x: np.ndarray
    newton_iters: int
    converged: bool


def _dR_dlam(problem, x, make_params, lam, eps=1e-7):
    """Directional derivative of the residual w.r.t. the parameter via jvp
    through the params pytree (exact to roundoff when make_params is traceable)."""
    def f(l):
        return problem._residual_jit(jnp.asarray(x), make_params(l))

    try:
        _, dr = jax.jvp(f, (jnp.asarray(lam, dtype=jnp.result_type(float)),),
                        (jnp.ones((), dtype=jnp.result_type(float)),))
        return np.asarray(dr)
    except Exception:
        # non-traceable make_params: central difference
        rp = np.asarray(f(lam + eps))
        rm = np.asarray(f(lam - eps))
        return (rp - rm) / (2 * eps)


def continue_problem(
    problem,
    make_params: Callable[[float], dict],
    lam_start: float,
    lam_end: float,
    dlam0: float,
    x0,
    newton_options: NewtonOptions | None = None,
    first_order: bool = True,
    max_steps: int = 200,
    min_dlam: float = 1e-10,
    growth: float = 1.5,
    step_bounds: Callable[[float], tuple[float, float]] | None = None,
) -> list[ContinuationStep]:
    """March the solution from lam_start to lam_end with adaptive d(lambda).

    ``make_params(lam) -> params`` builds the full parameter pytree (including
    Dirichlet values if they depend on lambda). First-order predictor uses
    x' = -J^{-1} dR/dlam (reference: first-order continuation).
    ``step_bounds(lam) -> (dmin, dmax)`` clamps |dlam| at the current point
    (reference: per-hunting-condition Delta_s_min/max, ``src/ac_hunt.c``);
    halving below dmin aborts, like the reference's step-size floor.
    """
    solver = NewtonSolver(problem, newton_options)

    def linsolve(vals, rhs):
        if solver.opts.linear_solver == "direct":
            from goma_tpu.solvers.linear import direct_solve_host

            return np.asarray(
                direct_solve_host(problem.pattern, np.asarray(vals), np.asarray(rhs))
            )
        lr = solver._solve_gmres(vals, jnp.asarray(rhs))
        return np.asarray(lr.x)

    steps: list[ContinuationStep] = []
    lam = lam_start
    dlam = dlam0
    direction = np.sign(lam_end - lam_start) or 1.0
    dlam = abs(dlam) * direction
    x = np.asarray(x0, dtype=float)

    res = solver.solve(x, make_params(lam))
    if not res.converged:
        raise RuntimeError("continuation: initial solve failed")
    x = res.x
    steps.append(ContinuationStep(lam, x.copy(), res.iters, True))

    while (lam_end - lam) * direction > 1e-14 and len(steps) < max_steps:
        dmin = min_dlam
        if step_bounds is not None:
            dmin, dmax = step_bounds(lam)
            dlam = direction * min(max(abs(dlam), dmin), dmax)
        dlam = direction * min(abs(dlam), abs(lam_end - lam))
        # predictor: x' = -J^{-1} dR/dlam (first order), else reuse x
        if first_order:
            _, vals = problem.assemble(jnp.asarray(x), make_params(lam))
            dr = _dR_dlam(problem, x, make_params, lam)
            x_pred = x - linsolve(vals, dr) * dlam
        else:
            x_pred = x

        res = solver.solve(x_pred, make_params(lam + dlam))
        if res.converged and np.all(np.isfinite(res.x)):
            lam = lam + dlam
            x = res.x
            steps.append(ContinuationStep(lam, x.copy(), res.iters, True))
            if res.iters <= 3:
                dlam *= growth
        else:
            dlam *= 0.5
            if abs(dlam) < max(min_dlam, dmin):
                raise RuntimeError(f"continuation stalled at lam={lam}")
    return steps


@dataclass
class ArcStep:
    lam: float
    x: np.ndarray
    newton_iters: int


def arclength_continue(
    problem,
    make_params: Callable[[float], dict],
    lam0: float,
    x0,
    ds0: float,
    n_steps: int,
    newton_options: NewtonOptions | None = None,
    max_newton: int = 12,
    lam_scale: float = 1.0,
) -> list[ArcStep]:
    """Pseudo-arclength continuation (tracks solution branches around folds).

    Bordered Newton on (x, lam) with constraint
       N = t_x . (x - x_pred) + t_lam (lam - lam_pred) = 0
    solved by the two-solve bordering algorithm (reference: LOCA
    ``src/loca_bord.c`` arc-length algorithm).
    """
    opts = newton_options or NewtonOptions()
    solver = NewtonSolver(problem, opts)

    def linsolve(vals, rhs):
        if opts.linear_solver == "direct":
            from goma_tpu.solvers.linear import direct_solve_host

            return np.asarray(direct_solve_host(problem.pattern, np.asarray(vals), np.asarray(rhs)))
        lr = solver._solve_gmres(vals, jnp.asarray(rhs))
        return np.asarray(lr.x)

    # converge the start point
    res = solver.solve(np.asarray(x0), make_params(lam0))
    if not res.converged:
        raise RuntimeError("arclength: initial solve failed")
    x = res.x
    lam = lam0

    # initial tangent: (dx/dlam, 1) normalized
    R, vals = problem.assemble(jnp.asarray(x), make_params(lam))
    dr = _dR_dlam(problem, x, make_params, lam)
    dxdl = -linsolve(vals, dr)
    t_x = dxdl
    t_l = 1.0
    nrm = np.sqrt(np.dot(t_x, t_x) + (lam_scale * t_l) ** 2)
    t_x, t_l = t_x / nrm, t_l / nrm

    out = [ArcStep(lam, x.copy(), res.iters)]
    ds = ds0
    for _ in range(n_steps):
        x_pred = x + ds * t_x
        lam_pred = lam + ds * t_l
        xc, lc = x_pred.copy(), float(lam_pred)
        ok = False
        for it in range(max_newton):
            params = make_params(lc)
            R, vals = problem.assemble(jnp.asarray(xc), params)
            Rn = np.asarray(R)
            N = np.dot(t_x, xc - x_pred) + lam_scale**2 * t_l * (lc - lam_pred)
            if np.linalg.norm(Rn) < opts.tol_residual * 100 and abs(N) < 1e-10:
                ok = True
                break
            dr = _dR_dlam(problem, xc, make_params, lc)
            w1 = linsolve(vals, Rn)  # J w1 = R
            w2 = linsolve(vals, dr)  # J w2 = dR/dlam
            # bordered update: dlam = -(N - t_x.w1) / (t_lam*ls^2 - t_x.w2)
            denom = lam_scale**2 * t_l - np.dot(t_x, w2)
            dlam = -(N - np.dot(t_x, w1)) / denom
            dx = -w1 - dlam * w2
            xc = xc + dx
            lc = lc + dlam
            if not np.all(np.isfinite(xc)):
                break
        if not ok:
            ds *= 0.5
            if abs(ds) < 1e-12:
                raise RuntimeError("arclength stalled")
            continue
        # new tangent from secant
        dx_sec = xc - x
        dl_sec = lc - lam
        nrm = np.sqrt(np.dot(dx_sec, dx_sec) + (lam_scale * dl_sec) ** 2)
        t_x, t_l = dx_sec / nrm, dl_sec / nrm
        x, lam = xc, lc
        out.append(ArcStep(lam, x.copy(), it + 1))
        if it <= 3:
            ds = min(ds * 1.3, ds0 * 4)
    return out
