"""Damped full-Newton nonlinear solver.

Parity: the reference's hot loop ``src/mm_sol_nonlinear.c:258
solve_nonlinear_problem`` — per iteration: assemble R and exact J, row-sum
scale, compute Linf/L1/L2 norms, convergence test against Epsilon, linear
solve, damped update ``x <- x - lambda dx`` (damp_factor semantics), with
the assembly+solve split timed (the BASELINE metric). The outer loop stays
host-side python (like the reference's C loop); each phase is one jitted
device call.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import jax
import jax.numpy as jnp

from goma_tpu.fem.sparsity import row_sum_scale
from goma_tpu.solvers.linear import BlockJacobi, LinearResult, bicgstab, direct_solve_host, gmres


@dataclass
class NewtonOptions:
    max_iter: int = 15
    # convergence on the row-scaled residual, like the reference's Epsilon[0]
    tol_residual: float = 1e-10
    # also require correction-norm convergence when > 0 (Epsilon[2] analog)
    tol_update: float = 0.0
    damp: float = 1.0
    # Reference damping ladder (src/mm_sol_nonlinear.c:1998-2040, input card
    # "Newton correction factor" src/mm_input.c:6538-6554): when
    # damp_factor2/3 and the custom tolerances are all set in [0,1], the
    # applied relaxation is chosen per-iteration from ||R||_inf (Norm[0][0]):
    #   ||R||inf > custom_tol3 -> damp_factor3
    #   ||R||inf > custom_tol2 -> damp_factor2
    #   ||R||inf > custom_tol1 -> damp_factor1
    #   else                   -> 1.0
    # and any selected factor <= 1e-6 falls back to damp_factor1. With the
    # defaults (-1) the ladder is off and the constant ``damp`` applies.
    damp_factor1: float | None = None  # None -> use ``damp``
    damp_factor2: float = -1.0
    damp_factor3: float = -1.0
    custom_tol1: float = -1.0
    custom_tol2: float = -1.0
    custom_tol3: float = -1.0
    row_scaling: bool = True
    # tpu_direct: on-device nested-dissection multifrontal LU (solvers/ndlu)
    # — batched dense frontal factorization + iterative refinement; the
    # on-device analog of the reference's UMFPACK/Amesos direct dispatch
    # (src/mm_sol_nonlinear.c:1290-1515)
    linear_solver: str = "gmres"  # gmres | bicgstab | direct | tpu_direct
    ndlu_leaf_max: int = 96
    # fixed sweeps before the rel_tol checks take over: 1, not 2 — the
    # checks stop refinement as soon as the guard is met, so a second
    # unconditional sweep only pays when the first already sufficed (not
    # measured on the GPU)
    ndlu_refine: int = 1
    # atomic mesh-node clustering of the ND bisection: every saddle
    # (pressure) dof shares a front with its node's momentum rows — the
    # structural robustness fix replacing per-deck leaf_max tuning
    ndlu_cluster: bool = True
    ndlu_dtype: str = "float32"  # factorization precision (refinement runs
    # at the assembled vals' precision, recovering f64-quality solves)
    # lagged factorization: reuse the previous Newton iteration's (or time
    # step's) multifrontal factors and iterate refinement against the FRESH
    # operator; refactor only when refinement cannot reach the residual
    # guard. The accepted step always satisfies ||b - A_new z|| <= rel_tol
    # ||b|| against the fresh Jacobian, so Newton convergence is the inexact-
    # Newton one the Krylov path uses. Reference analog: Aztec AZ_reuse
    # (src/sl_util.c:380) applied to a direct factorization.
    ndlu_lag: bool = True
    # refinement patience: bound total sweeps per solve. The break-even is
    # ~(factorization time / sweep time) — more patience just grinds
    # slow-converging lagged-factor sweeps past the point a refactor would
    # be cheaper (the value 8 is not measured on the GPU)
    ndlu_max_refine: int = 8
    # auto: two-level p-multigrid when the problem has a genuinely smaller
    # Q1/P1 coarse space that fits a dense coarse solve, else block-Jacobi
    precond: str = "auto"  # auto | block_jacobi | fieldsplit | pcd | twolevel
    fieldsplit_mu: float | None = None
    fieldsplit_rho: float | None = None
    fieldsplit_sweeps: int = 2
    # None: 1.0 for vanka (weighted overlap already averages), 0.7 for bj
    smooth_damp: float | None = None
    smooth_sweeps: int = 2
    # post-smoothing sweeps of the two-level cycle; None -> smooth_sweeps.
    # 0 gives a pre-only cycle: one smoother apply + one matvec cheaper per
    # Krylov iteration
    smooth_post_sweeps: int | None = None
    # two-level smoother: "bj" node-block-Jacobi | "vanka" element-block
    # additive Schwarz (the classic saddle-point multigrid smoother)
    smoother: str = "vanka"
    linear_tol: float = 1e-10
    gmres_restart: int = 120
    linear_maxiter: int = 600
    full_history: bool = True
    # inexact-Newton forcing: "ew" adapts the per-iteration Krylov tolerance
    # (Eisenstat-Walker choice 2: eta_k = 0.5 (|R_k|/|R_{k-1}|)^1.5, clipped
    # to [linear_tol, 0.1]) so early far-from-solution iterations don't pay
    # for tight linear solves; "fixed" always uses linear_tol
    forcing: str = "ew"  # ew | fixed
    # optional floor on the EW forcing tolerance: caps how tight the
    # mid-iteration linear solves get (fewer Krylov its per Newton step at
    # the cost of extra Newton steps); the endgame clamp below still
    # tightens the final solves enough to reach tol_residual
    ew_eta_floor: float = 0.0
    # endgame interaction of the EW forcing with tol_residual:
    #   "tighten": eta <- min(eta_ew, 0.5 tol/||R||) — every solve is at
    #              least accurate enough to finish (never a wasted last
    #              step, but mid-run solves oversolve: the next residual is
    #              nonlinearity-dominated, C ||R||^2 >> tol)
    #   "standard": eta <- max(eta_ew, 0.5 tol/||R||) — the classic
    #              oversolving safeguard (Eisenstat-Walker '96 §3): never
    #              solve tighter than finishing needs; mid-run keeps eta_ew
    ew_endgame: str = "tighten"  # tighten | standard
    # preconditioner factor storage: "f32" (default: factor dtype) or
    # "bf16" — smoother inverses + dense coarse inverse stored in bfloat16,
    # halving the apply's HBM traffic; the apply accumulates in the Krylov
    # dtype, so only the preconditioner QUALITY carries the rounding (a
    # preconditioner is insensitive at these tolerances)
    precond_dtype: str = "f32"
    # lagged preconditioner: reuse the factored preconditioner across Newton
    # iterations (and time steps) until the Krylov iteration count degrades
    # past the staleness threshold over its post-factor baseline. The Krylov
    # OPERATOR is always the fresh exact Jacobian — only the preconditioner
    # lags, so Newton convergence is unaffected. Reference analog: Aztec
    # pre_calc/AZ_reuse (src/sl_util.c:380).
    precond_lag: bool = True
    # staleness threshold (extra Krylov its over the post-factor baseline
    # before the lagged factor is declared stale). For the near-exact NDLU
    # preconditioner the check also fires MID-SOLVE: the solve refactors and
    # continues from its current iterate instead of grinding a tight-
    # tolerance endgame solve on a stale factor (the r3 tol1e10 cliff:
    # linear_iters [1,120,120,181,240] at 8x the 1e-6 per-iteration cost).
    # None -> kind-based default: 45 for "ndlu", else 2*gmres_restart
    # (high-iteration preconditioners like twolevel take 100+ its by design
    # — growth there is intrinsic, not staleness).
    precond_stale_its: int | None = None
    # GCRO-DR Krylov recycling: carry a k-dimensional harmonic-Ritz
    # deflation space between the Newton iterations' linear solves (the
    # slowly-varying Jacobian family shares its bad eigenvalue cluster).
    # 0 disables. See solvers/linear.py gmres_dr_cycle.
    recycle_k: int = 0
    # switched-precision prep (mixed-precision fast path only): while the
    # row-scaled ||R||_2 stays ABOVE this threshold, the whole per-iteration
    # prep (residual + element Jacobians + row sums + norms) runs at
    # jacobian_dtype in ONE pass, skipping the f64 residual evaluation.
    # Once the f32 norm drops below the threshold (kept well above the f32
    # row-scaled noise floor ~1e-6), the SAME iteration is re-prepped at
    # full precision and the endgame — including every convergence check —
    # runs f64. 0 disables (always full-precision residual).
    prep32_tol: float = 0.0


@dataclass
class NewtonResult:
    x: np.ndarray
    converged: bool
    iters: int
    res_norms: list  # per-iter (L1, L2, Linf) of scaled residual
    update_norms: list
    linear_iters: list
    assembly_time: float = 0.0
    solve_time: float = 0.0

    def summary(self) -> str:
        lines = ["  it      ||R||_1      ||R||_2    ||R||_inf   lin.its"]
        for i, (l1, l2, li) in enumerate(self.res_norms):
            lin = self.linear_iters[i] if i < len(self.linear_iters) else "-"
            lines.append(f"  {i:2d}  {l1:11.4e}  {l2:11.4e}  {li:11.4e}   {lin}")
        return "\n".join(lines)


class NewtonSolver:
    def __init__(self, problem, options: NewtonOptions | None = None):
        self.problem = problem
        self.opts = options or NewtonOptions()
        kind = self.opts.precond
        if kind == "auto":
            kind = "block_jacobi"
            # two-level needs the mesh blocks (plain single-device Problem)
            # and pays off only when the Q1/P1 coarse space is both a real
            # reduction and small enough for a dense coarse factorization.
            if hasattr(problem, "mesh"):
                from goma_tpu.solvers.twolevel import coarse_dof_count

                nc, n = coarse_dof_count(problem)
                if nc <= 0.8 * n and nc <= 16000:
                    kind = "twolevel"
            if getattr(problem, "ovs_sets", None):
                # multiplier saddles need the constraint-aware Schwarz
                # blocks; the dense two-level coarse solve is not robust on
                # the coarse-projected multiplier rows, so plain Vanka it is
                kind = "vanka"
        self._precond_kind = kind
        if kind == "vanka":
            from goma_tpu.solvers.linear import Vanka

            extras = [s.gather for s in getattr(problem, "ovs_sets", [])]
            self.precond = Vanka(problem.pattern, problem.dofmap,
                                 problem=problem,
                                 extra_gathers=extras or None)
            kind = "_done"
        if kind == "fieldsplit":
            from goma_tpu.solvers.linear import FieldSplit

            self.precond = FieldSplit(
                problem, mu=self.opts.fieldsplit_mu, u_sweeps=self.opts.fieldsplit_sweeps
            )
        elif kind == "pcd":
            from goma_tpu.solvers.pcd import PCDFieldSplit

            mat = problem.materials[0] if getattr(problem, "materials", None) else {}
            mu = self.opts.fieldsplit_mu
            if mu is None:
                mu = mat.get("mu") if isinstance(mat.get("mu"), (int, float)) else 1.0
            rho = self.opts.fieldsplit_rho
            if rho is None:
                rho = mat.get("rho") if isinstance(mat.get("rho"), (int, float)) else 1.0
            self.precond = PCDFieldSplit(
                problem, mu=mu, rho=rho, u_sweeps=self.opts.fieldsplit_sweeps
            )
        elif kind == "twolevel":
            from goma_tpu.solvers.twolevel import TwoLevel

            damp = self.opts.smooth_damp
            if damp is None:
                damp = 1.0 if self.opts.smoother == "vanka" else 0.7
            post = (self.opts.smooth_sweeps
                    if self.opts.smooth_post_sweeps is None
                    else self.opts.smooth_post_sweeps)
            self.precond = TwoLevel(
                problem, smooth_damp=damp,
                pre_sweeps=self.opts.smooth_sweeps, post_sweeps=post,
                smoother=self.opts.smoother,
            )
        elif kind == "ndlu":
            # near-exact preconditioner: the on-device multifrontal LU
            # (solvers/ndlu.py) factored in f32. Fresh factor -> 1-2 Krylov
            # its; with precond_lag the factor is reused across Newton
            # iterations (~10 its lagged) so the factorization amortizes.
            # The Krylov operator stays the fresh exact Jacobian.
            from goma_tpu.solvers.ndlu import NDLU
            from goma_tpu.solvers.twolevel import _saddle_mask

            # invert=True: applies become batched matmuls (selective
            # inversion) — safe here because GMRES wraps the apply; the
            # tpu_direct refinement path keeps exact substitution
            from goma_tpu.solvers.ndlu import node_clusters

            self.precond = NDLU(problem.pattern,
                                leaf_max=self.opts.ndlu_leaf_max,
                                dtype=jnp.dtype(self.opts.ndlu_dtype),
                                defer_dofs=_saddle_mask(problem),
                                invert=True,
                                clusters=node_clusters(problem)
                                if self.opts.ndlu_cluster else None)
        elif kind != "_done":
            self.precond = BlockJacobi(problem.pattern, problem.dofmap)
        if self.opts.precond_dtype == "bf16":
            # full bf16 factor storage measurably degrades the two-level
            # cycle on hard saddles (diverged the 64x64 cavity bench);
            # offered for easy problems only
            sd = jnp.bfloat16
            self.precond.store_dtype = sd
            if hasattr(self.precond, "bj"):
                self.precond.bj.store_dtype = sd
        elif self.opts.precond_dtype == "bf16-coarse":
            # bf16 only for the dense coarse inverse (the single largest
            # apply-side array); smoother inverses stay f32
            self.precond.store_dtype = jnp.bfloat16
        # interface (paired-face) couplings are not represented in the
        # element-matvec aux -> use the CSR (ELL) operator for such problems.
        # Direct paths (host direct / tpu_direct multifrontal) never matvec
        # through the element aux either (refinement uses the ELL operator),
        # so skip building it — it is the largest non-R+J cost in _prep
        _elem_capable = (
            hasattr(problem, "_assemble_with_elem")
            and not getattr(problem, "ifc_sets", None)
            and not getattr(problem, "ovs_sets", None)
            and not getattr(problem, "edge_sets", None)
            and getattr(problem, "_inject", None) is None
        )
        self._use_elem_mv = (
            _elem_capable
            and self.opts.linear_solver not in ("direct", "tpu_direct")
        )
        # tpu_direct never matvecs through the element aux, but it still
        # wants the ELEMENT assembly: it is the only path that honors
        # problem.jacobian_dtype (mixed precision — plain _assemble jacfwds
        # at the residual dtype). Iterative refinement recovers
        # residual-dtype step quality. The HOST direct
        # path stays on plain f64 assembly: spsolve has no refinement loop,
        # so its steps must be full precision.
        self._elem_asm_only = (
            _elem_capable and self.opts.linear_solver == "tpu_direct"
        )
        # padded node-slot matvec: row gathers instead of scalar gathers
        # (see fem/padded.py); falls back when padding doesn't pay off
        self._use_padded = bool(
            self._use_elem_mv
            and hasattr(problem, "ensure_padded_tables")
            and problem.ensure_padded_tables()
        )
        self._rows = jnp.asarray(problem.pattern.rows)
        self._cols = jnp.asarray(problem.pattern.indices)
        self._n = problem.dofmap.n_dof
        from goma_tpu.fem.sparsity import EllOperator

        self._ell = EllOperator(problem.pattern)
        # explicit device-table pytrees (jit arguments, not captured constants
        # — captured arrays would inline into the HLO module)
        self._ptab = getattr(problem, "_tables", None)
        self._ntab = {
            "prec": getattr(self.precond, "tables", {}),
            "ell": self._ell.tables,
        }
        self._prep = jax.jit(self._prepare)
        # vals-free fast prep (the iterative hot path): row-scaled norms and
        # equilibration from element-level row sums; global CSR values are
        # built only when the preconditioner refactors (_scaled_vals). See
        # Problem._assemble_fast for the design rationale.
        self._fast_prep = (
            self._use_elem_mv
            and self.opts.row_scaling
            and self.opts.linear_solver in ("gmres", "bicgstab")
            and hasattr(problem, "_assemble_fast")
        )
        self._fastprep_jit = jax.jit(self._prepare_fast)
        self._fastprep32_jit = jax.jit(self._prepare_fast32)
        self._vals_jit = jax.jit(self._scaled_vals)
        self._jdt = (jnp.dtype(problem.jacobian_dtype)
                     if getattr(problem, "jacobian_dtype", None)
                     else jnp.dtype(getattr(problem, "dtype", jnp.float64)))
        self._factor_jit = jax.jit(self._factor_num)
        # current state for state-dependent preconditioners (PCD convection)
        # and for deferred vals materialization (_vals_for_factor)
        self._cur_x = None
        self._cur_params = None
        self._cur_ct = 0.0
        self._fac_cache = None
        self._fac_base_its = None
        self._ndlu = None  # lazy tpu_direct multifrontal (solvers/ndlu.py)
        self._ndlu_fac = None  # lagged tpu_direct factors (opts.ndlu_lag)
        self._ndlu_nfactor = 0  # fresh factorization count (perf telemetry)
        self._ndlu_sweep = None  # fused refinement step (one dispatch/sweep)
        self._cycle_jit = jax.jit(self._gmres_cycle)
        self._solve_gmres = self._linsolve_gmres  # host restart loop
        self._eta_jit = jax.jit(self._eta_device)  # pipelined EW forcing
        self._solve_bicgstab = jax.jit(self._linsolve_bicgstab)
        # GCRO-DR recycling state (device (k, n) harmonic-Ritz space)
        self._recycle_U = None
        self._cycle_dr_jit = jax.jit(self._gmres_dr_cycle_fn)
        self._dr_setup_jit = jax.jit(self._dr_setup)
        self._dr_small_jit = jax.jit(self._dr_small_mats)
        self._dr_unew_jit = jax.jit(self._dr_unew)

    def reset_lagged(self):
        """Drop all lagged factors (preconditioner + tpu_direct NDLU +
        recycling space). Called by the transient failure ladder on a
        rejected step: a factor laid down along a diverging trajectory is
        a bad basis for the halved-dt retry (the dt-underflow mode the
        slot coater hit under gmres+ndlu — the reference refactors every
        iteration so never carries this state across a backoff,
        src/rf_solve.c:1956)."""
        self._fac_cache = None
        self._fac_base_its = None
        self._ndlu_fac = None
        self._recycle_U = None

    def _prepare(self, x, params, ell_tb=None):
        """Assemble + scale + norms, one device call. Also returns the
        element-Jacobian aux pytree powering the matrix-free matvec.

        ``ell_tb``: the ELL tables (passed as jit ARGS) enabling
        scatter-free row sums instead of a segment_sum over every nonzero
        (not measured on the GPU)."""
        if self._use_elem_mv:
            R, vals, aux = self.problem._assemble_with_elem(x, params)
            if self._use_padded:
                # re-index blockJ into the padded node-slot layout once per
                # Newton iteration (the matvec then runs on row gathers)
                aux = self.problem.pad_aux(aux, self.problem._tb(params))
        elif self._elem_asm_only:
            # direct path: element assembly for its mixed-precision Jacobian;
            # the aux is discarded (refinement matvecs through the CSR)
            R, vals, _ = self.problem._assemble_with_elem(x, params)
            aux = ((), (), ())
        else:
            R, vals = self.problem._assemble(x, params)
            aux = ((), (), ())
        # Norms/convergence follow the reference's row-sum-scaled residual
        # (src/mm_sol_nonlinear.c:972). The Krylov solve, however, runs on a
        # SYMMETRICALLY equilibrated operator (DAD) z = D R, dx = D z: plain
        # row scaling breaks the variational (Galerkin) coarse correction of
        # the two-level preconditioner (measured 2x iteration inflation),
        # while no equilibration at all breaks penalty-BC systems.
        if self.opts.row_scaling:
            if ell_tb is not None:
                # one scatter-free row-sum pass shared by the row-scaled
                # norms AND the symmetric equilibration
                from goma_tpu.fem.sparsity import row_sums_ell

                rs = row_sums_ell(vals, ell_tb["pos"])
                rs = jnp.where(rs > 0, rs, jnp.ones_like(rs))
                Rn = R / rs
                scale = 1.0 / jnp.sqrt(rs)
                vals = vals * (scale[self._rows] * scale[self._cols])
            else:
                from goma_tpu.fem.sparsity import sym_sum_scale

                _, Rn, _ = row_sum_scale(vals, R, self._rows, self._n)
                vals, scale = sym_sum_scale(vals, self._rows, self._cols,
                                            self._n)
        else:
            Rn = R
            scale = jnp.ones(self._n, dtype=vals.dtype)
        # norms in f32; max-scaled so the sum of
        # squares cannot overflow f32 range. The CHECKS are absolute
        # thresholds, so the ~1e-7 relative rounding of the norm value
        # is immaterial at any magnitude.
        Rn32 = Rn.astype(jnp.float32)
        mx = jnp.max(jnp.abs(Rn32))
        sc = jnp.where(mx > 0, mx, jnp.float32(1.0))
        norms = (
            jnp.sum(jnp.abs(Rn32 / sc)) * sc,
            jnp.linalg.norm(Rn32 / sc) * sc,
            mx,
        )
        return R, vals, norms, scale, aux

    def _prepare_fast(self, x, params):
        """Vals-free prep for the iterative path: one device call producing
        (R, norms, scale, aux). Row sums come from the element Jacobians
        (Problem._assemble_fast) — no nnz-sized scatter, no ELL row-sum
        gather, no vals scaling. Matches the reference's row-sum-scaled
        norms (src/mm_sol_nonlinear.c:972,1106) up to element-level sign
        agreement (see _assemble_fast; parity test in
        tests/test_fast_prep.py)."""
        R, rs, aux = self.problem._assemble_fast(x, params)
        if self._use_padded:
            aux = self.problem.pad_aux(aux, self.problem._tb(params))
        rs = jnp.where(rs > 0, rs, jnp.ones_like(rs))
        Rn = R / rs
        scale = 1.0 / jnp.sqrt(rs)
        Rn32 = Rn.astype(jnp.float32)
        mx = jnp.max(jnp.abs(Rn32))
        sc = jnp.where(mx > 0, mx, jnp.float32(1.0))
        norms = (
            jnp.sum(jnp.abs(Rn32 / sc)) * sc,
            jnp.linalg.norm(Rn32 / sc) * sc,
            mx,
        )
        return R, norms, scale, aux

    def _prepare_fast32(self, x, params):
        """Switched-precision prep (opts.prep32_tol): the whole pass —
        residual included — at jacobian_dtype. One fused residual+Jacobian
        evaluation instead of a separate f64 residual pass; used only while ||R|| is far from the convergence tolerance
        (the endgame re-preps at full precision)."""
        R, rs, aux = self.problem._assemble_fast(x, params, rdt=self._jdt)
        if self._use_padded:
            aux = self.problem.pad_aux(aux, self.problem._tb(params))
        rs = jnp.where(rs > 0, rs, jnp.ones_like(rs))
        Rn = R / rs
        scale = 1.0 / jnp.sqrt(rs)
        Rn32 = Rn.astype(jnp.float32)
        mx = jnp.max(jnp.abs(Rn32))
        sc = jnp.where(mx > 0, mx, jnp.float32(1.0))
        norms = (
            jnp.sum(jnp.abs(Rn32 / sc)) * sc,
            jnp.linalg.norm(Rn32 / sc) * sc,
            mx,
        )
        return R, norms, scale, aux

    def _scaled_vals(self, x, params, scale):
        """Global CSR values, symmetrically equilibrated with the fast-prep
        scale — called only when a preconditioner (re)factor needs the
        assembled matrix. The residual side of _assemble_with_elem is dead
        code under jit here (XLA DCE removes it)."""
        _, vals, _ = self.problem._assemble_with_elem(x, params)
        d = (scale[self._rows] * scale[self._cols]).astype(vals.dtype)
        return vals * d

    def _vals_for_factor(self, scale):
        """Materialize equilibrated CSR values at the current Newton state."""
        return self._vals_jit(self._cur_x, self._cur_params, scale)

    def _factor_state(self, vals):
        """(xp, ct) extra factor inputs for state-dependent preconditioners."""
        xp = self._cur_x
        if xp is None:
            xp = jnp.zeros(self._n, dtype=vals.dtype)
        return jnp.asarray(xp), jnp.asarray(self._cur_ct, dtype=vals.dtype)

    def _matvec(self, vals):
        ell = self._ell

        def mv(v):
            return ell.matvec(vals, v)

        return mv

    def _matvec_state(self, vals, scale, aux, ptab, ntab):
        """Preferred operator: element matrix-free (gather + batched matmul
        + transpose gather); ELL fallback when aux is unavailable."""
        if self._use_elem_mv and aux is not None and len(aux[0]):
            prob = self.problem
            # T=None: small index tables embed as compile-time constants —
            # XLA specializes constant-index gathers; only the huge
            # factor-only tables stay params.
            # scale on both sides: reproduces the symmetric equilibration
            # (DAD) of the CSR values (see _prepare)
            if self._use_padded:

                def mv(v):
                    return prob.padded_matvec(None, aux, scale, scale * v)

                return mv

            def mv(v):
                return prob.element_matvec(None, aux, scale, scale * v)

            return mv
        ell = self._ell

        def mv(v):
            return ell.matvec(vals, v)  # constant tables (hot path)

        return mv

    def _factor_num(self, vals, ntab=None, xp=None, ct=None):
        """Numeric preconditioner state (jit-friendly pytree, no closures)."""
        tb = (ntab or self._ntab)["prec"] or None
        if self._precond_kind == "twolevel":
            Binv, coarse, _ = self.precond.factor(vals, None, tb)
            return (Binv, coarse)
        if self._precond_kind == "fieldsplit":
            Binv, _ = self.precond.factor(vals, None)
            return (Binv,)
        if self._precond_kind == "pcd":
            return self.precond.factor(vals, xp, ct)
        if self._precond_kind == "ndlu":
            # tables flow through ntab as jit ARGUMENTS — tracing the
            # multifrontal factor with its gather/one-hot tables closed
            # over as constants would serialize them into the HLO
            # (hundreds of MB)
            return (self.precond._factor(vals, (ntab or self._ntab)["prec"]),)
        return (self.precond.factor(vals, tb),)

    def _apply_precond_mv(self, mv, vals, ntab, fac_num, r):
        # tb=None: apply-path tables embed as constants (hot path)
        if self._precond_kind == "twolevel":
            return self.precond.apply((*fac_num, mv), r, None)
        if self._precond_kind in ("fieldsplit", "pcd"):
            return self.precond.apply((*fac_num, mv), r)
        if self._precond_kind == "ndlu":
            tb = ntab["prec"] if ntab else self.precond.tabs
            return self.precond._solve(fac_num[0], r, tb)
        return self.precond.apply(fac_num[0], r, None)

    def _gmres_cycle(self, vals, scale, aux, ptab, ntab, fac_num, x, b, tol):
        """One restarted-GMRES cycle. The restart loop lives on HOST, which
        matches the reference's outer-loop structure."""
        mv = self._matvec_state(vals, scale, aux, ptab, ntab)
        M = lambda r: self._apply_precond_mv(mv, vals, ntab, fac_num, r)
        lr = gmres(mv, b, precond=M, tol=tol,
                   restart=self.opts.gmres_restart,
                   maxiter=self.opts.gmres_restart, x0=x)
        return lr.x, lr.resnorm, lr.iters

    # ------------------------------------------------- GCRO-DR recycling
    def _gmres_dr_cycle_fn(self, vals, scale, aux, ptab, ntab, fac_num, x, b,
                           U, C, tol):
        from goma_tpu.solvers.linear import gmres_dr_cycle

        mv = self._matvec_state(vals, scale, aux, ptab, ntab)
        M = lambda r: self._apply_precond_mv(mv, vals, ntab, fac_num, r)
        return gmres_dr_cycle(mv, M, b, x, U, C,
                              self.opts.gmres_restart, tol)

    def _dr_setup(self, vals, scale, aux, ptab, ntab, fac_num, U):
        """Re-orthonormalize the recycled space against the CURRENT
        operator: C = A M U made orthonormal, U scaled to match."""
        mv = self._matvec_state(vals, scale, aux, ptab, ntab)
        M = lambda r: self._apply_precond_mv(mv, vals, ntab, fac_num, r)
        AMU = jax.lax.map(lambda u: mv(M(u)), U)  # (k, n)
        Qc, Rc = jnp.linalg.qr(AMU.T)  # (n, k), (k, k)
        # guard rank loss: regularize tiny diagonals (the harvested space
        # occasionally has near-dependent columns)
        d = jnp.abs(jnp.diagonal(Rc))
        ok = jnp.all(d > 1e-12 * jnp.max(d))
        Rc = Rc + jnp.where(ok, 0.0, 1.0) * jnp.eye(Rc.shape[0], dtype=Rc.dtype)
        Unew = jax.scipy.linalg.solve_triangular(Rc.T, U, lower=True)
        return Qc.T, Unew, ok

    def _dr_small_mats(self, U, C, V):
        """Device inner products feeding the host-side harmonic-Ritz
        harvest: C^H U (k,k) and V^H U (m+1,k)."""
        return C @ U.T, V @ U.T

    def _dr_unew(self, g_u, g_v, U, V):
        """U_new = W g with W = [U; V_m] (rows)."""
        return (g_u.T @ U + g_v.T @ V[:V.shape[0] - 1]).astype(U.dtype)

    def _dr_harvest(self, U, C, V, H, B, cnt):
        """Between-solves harvest (host small dense math): the k smallest
        harmonic Ritz vectors of the composite space W = [U, V_m], using
        A M W = [C, V_{m+1}] G~ with G~ = [[I, B], [0, H]] — the pencil
        (G~^H G~) g = theta (G~^H Q^H W) g [Parks et al. 2006, Alg. 2
        structure]. Returns the new (k, n) device U or None on failure."""
        import numpy as onp
        import scipy.linalg as sla

        k = self.opts.recycle_k
        m = int(cnt)
        if m < k + 2:
            return None  # cycle too short to harvest anything useful
        ku = U.shape[0] if U is not None else 0
        CU, VU = (jax.device_get(a) for a in self._dr_small_jit(
            U if ku else jnp.zeros((0, V.shape[1]), V.dtype), C if ku else
            jnp.zeros((0, V.shape[1]), V.dtype), V))
        Hh = onp.asarray(jax.device_get(H))[: m + 1, :m]
        Bh = onp.asarray(jax.device_get(B))[:, :m] if ku else onp.zeros((0, m))
        # G~ ((ku+m+1) x (ku+m)) and Phi = [C V_{m+1}]^H W ((ku+m+1) x (ku+m))
        Gt = onp.zeros((ku + m + 1, ku + m))
        Gt[:ku, :ku] = onp.eye(ku)
        Gt[:ku, ku:] = Bh
        Gt[ku:, ku:] = Hh
        Phi = onp.zeros((ku + m + 1, ku + m))
        Phi[:ku, :ku] = CU[:, :ku] if ku else CU
        Phi[ku:, :ku] = VU[: m + 1, :ku] if ku else VU[: m + 1]
        Phi[ku:ku + m, ku:] = onp.eye(m)
        try:
            A_h = Gt.T @ Gt
            B_h = Gt.T @ Phi
            w, vecs = sla.eig(A_h, B_h)
        except Exception:
            return None
        finite = onp.isfinite(w)
        if finite.sum() < k:
            return None
        order = onp.argsort(onp.abs(w[finite]))
        vv = vecs[:, finite][:, order]
        # real basis from the leading complex-pair columns
        cols, seen = [], 0
        i = 0
        while seen < k and i < vv.shape[1]:
            c = vv[:, i]
            if onp.abs(c.imag).max() > 1e-13 * max(1.0, onp.abs(c.real).max()):
                cols.append(c.real)
                cols.append(c.imag)
                seen += 2
                i += 2  # skip the conjugate twin
            else:
                cols.append(c.real)
                seen += 1
                i += 1
        G = onp.stack(cols[:k], axis=1)  # (ku+m, k)
        Gq, _ = onp.linalg.qr(G)
        if not onp.all(onp.isfinite(Gq)):
            return None
        g_u = onp.zeros((ku, k))
        g_v = onp.zeros((V.shape[0] - 1, k))
        g_u[:, :] = Gq[:ku]
        g_v[:m] = Gq[ku:]
        Uz = U if ku else jnp.zeros((0, V.shape[1]), V.dtype)
        if ku == 0:
            Un = self._dr_unew(jnp.zeros((0, k), V.dtype),
                               jnp.asarray(g_v, V.dtype), Uz, V)
        else:
            Un = self._dr_unew(jnp.asarray(g_u, V.dtype),
                               jnp.asarray(g_v, V.dtype), Uz, V)
        return Un

    def _stale_its(self) -> int:
        """Krylov-iteration growth over the post-factor baseline that marks
        a lagged preconditioner factor stale (opts.precond_stale_its)."""
        if self.opts.precond_stale_its is not None:
            return int(self.opts.precond_stale_its)
        if self._precond_kind == "ndlu":
            return 45
        return 2 * self.opts.gmres_restart

    def _eta_device(self, l2, prev_l2):
        """Eisenstat-Walker forcing (choice 2) computed ON DEVICE so the
        Newton loop can chain prep -> eta -> first Krylov cycle without a
        host round trip (the pipelined path). Exact replica of the host
        formula in
        ``solve()``; ``prev_l2 < 0`` is the first-iteration sentinel."""
        o = self.opts
        lt = o.linear_tol
        ratio = l2 / jnp.maximum(prev_l2, 1e-300)
        eta = jnp.where(prev_l2 < 0,
                        max(lt, 1e-2),
                        jnp.minimum(0.1, jnp.maximum(lt, 0.5 * ratio**1.5)))
        if o.ew_eta_floor > 0:
            eta = jnp.maximum(eta, o.ew_eta_floor)
        if o.tol_residual > 0:
            need = 0.5 * o.tol_residual / jnp.maximum(l2, 1e-300)
            if o.ew_endgame == "standard":
                eta = jnp.minimum(0.1, jnp.maximum(
                    eta, jnp.minimum(need, 0.1)))
                eta = jnp.maximum(eta, lt)
            else:
                eta = jnp.maximum(lt, jnp.minimum(
                    eta, jnp.maximum(need, lt)))
        return eta

    def _linsolve_gmres(self, vals, R, scale=None, aux=None, tol=None,
                        extra_fetch=None):
        opts = self.opts
        if scale is None:
            scale = jnp.ones(self._n, dtype=R.dtype)
        ptab = self._ptab if (aux is not None and self._use_elem_mv) else None
        if aux is None:
            aux = ((), (), ())
        lagged = opts.precond_lag and self._fac_cache is not None
        if lagged:
            fac = self._fac_cache
        else:
            # fast-prep path carries vals=None: materialize the equilibrated
            # CSR values only now, when the factor actually needs them
            vals_f = vals if vals is not None else self._vals_for_factor(scale)
            fac = self._factor_jit(vals_f, self._ntab,
                                   *self._factor_state(vals_f))
            self._fac_cache = fac
            self._fac_base_its = None
        # symmetric equilibration: solve (DAD) z = D R, then dx = D z
        kdt = vals.dtype if vals is not None else self._jdt
        b = (scale.astype(R.dtype) * R).astype(kdt)
        z = jnp.zeros_like(b)
        if tol is None:
            tol = opts.linear_tol
        # ||b|| (and, in the pipelined Newton path, the prep's residual
        # norms and the device-computed EW tolerance) are fetched WITH the
        # first cycle's scalars: the first cycle always runs (rn starts at
        # ||b|| > target for any nonzero b), so a separate pre-solve fetch
        # would be a pure host round trip
        bnj = jnp.linalg.norm(b)
        tol_dev = jnp.asarray(tol, dtype=b.dtype)
        bnorm = None
        target = None
        extra_vals = None
        it = 0
        rn = np.inf

        def _first_fetch(rnj, cj):
            nonlocal bnorm, target, extra_vals
            pack = (bnj, rnj, cj, tol_dev) + tuple(extra_fetch or ())
            got = jax.device_get(pack)
            bnorm = float(got[0])
            target = max(float(got[3]) * bnorm, 1e-300)
            extra_vals = got[4:]
            return float(got[1]), int(got[2])

        kdr = opts.recycle_k
        if kdr > 0:
            # GCRO-DR: refresh the recycled space against this iteration's
            # operator, run deflated cycles, harvest for the next solve
            U = self._recycle_U
            if U is not None and U.shape[0] == kdr:
                C, U, _ok = self._dr_setup_jit(
                    vals, scale, aux, ptab, self._ntab, fac, U)
            else:
                U = jnp.zeros((0, b.shape[0]), dtype=b.dtype)
                C = U
            V = H = Bm = None
            cnt = 0
            while (target is None or rn > target) \
                    and it < opts.linear_maxiter:
                prev = rn
                z, rnj, cj, V, H, Bm = self._cycle_dr_jit(
                    vals, scale, aux, ptab, self._ntab, fac, z, b, U, C,
                    tol_dev)
                if target is None:
                    rn, cj_h = _first_fetch(rnj, cj)
                else:
                    rn_h, cj_h = jax.device_get((rnj, cj))
                    rn = float(rn_h)
                cnt = max(int(cj_h), 1)
                it += cnt
                if not np.isfinite(rn):
                    break
                if rn >= 0.999 * prev:
                    break
            if V is not None and np.isfinite(rn):
                Un = self._dr_harvest(U if U.shape[0] else None, C, V, H,
                                      Bm, cnt)
                if Un is not None:
                    self._recycle_U = Un
        else:
            stale = self._stale_its()
            base = self._fac_base_its if lagged else None
            it_refac = 0
            while (target is None or rn > target) \
                    and it < opts.linear_maxiter:
                if (lagged and it >= (base or 0) + stale):
                    # the lagged factor can't carry THIS solve's tolerance:
                    # refactor mid-solve and continue from the current
                    # iterate (the r3 tol1e10 cliff fix)
                    vals_f = (vals if vals is not None
                              else self._vals_for_factor(scale))
                    fac = self._factor_jit(vals_f, self._ntab,
                                           *self._factor_state(vals_f))
                    self._fac_cache = fac
                    self._fac_base_its = None
                    lagged = False
                    it_refac = it
                prev = rn
                z, rnj, cj = self._cycle_jit(vals, scale, aux, ptab, self._ntab,
                                             fac, z, b, tol_dev)
                # ONE host sync for all scalars: each device_get is a full
                # host<->device round trip
                if target is None:
                    rn, cj_h = _first_fetch(rnj, cj)
                else:
                    rn_h, cj_h = jax.device_get((rnj, cj))
                    rn = float(rn_h)
                it += max(int(cj_h), 1)
                if not np.isfinite(rn):
                    break
                if rn >= 0.999 * prev:
                    break  # stagnation (e.g. optimistic in-cycle estimate)
        if target is None:  # loop never ran (linear_maxiter <= 0)
            pack = (bnj, tol_dev) + tuple(extra_fetch or ())
            got = jax.device_get(pack)
            bnorm = float(got[0])
            target = max(float(got[1]) * bnorm, 1e-300)
            extra_vals = got[2:]
        if opts.precond_lag:
            # staleness policy: drop the cached factor once the iteration
            # count degrades past the threshold over its baseline. After a
            # mid-solve refactor the baseline counts only post-refactor its.
            if self._fac_base_its is None:
                self._fac_base_its = it - (it_refac if opts.recycle_k == 0
                                           else 0)
            elif (it >= self._fac_base_its + self._stale_its()
                  or not np.isfinite(rn)):
                self._fac_cache = None
        lr = LinearResult(
            x=scale * z, iters=jnp.asarray(it), resnorm=jnp.asarray(rn),
            converged=jnp.asarray(rn <= target),
        )
        return (lr, extra_vals) if extra_fetch is not None else lr

    def _linsolve_bicgstab(self, vals, R, scale=None, aux=None, tol=None):
        ptab = self._ptab if (aux is not None and self._use_elem_mv) else None
        if aux is None:
            aux = ((), (), ())
        if self.opts.precond_lag and self._fac_cache is not None:
            fac = self._fac_cache
        else:
            vals_f = vals if vals is not None else self._vals_for_factor(scale)
            fac = self._factor_jit(vals_f, self._ntab,
                                   *self._factor_state(vals_f))
            self._fac_cache = fac
            self._fac_base_its = None
        mv = self._matvec_state(vals, scale, aux, ptab, self._ntab)
        M = lambda r: self._apply_precond_mv(mv, vals, self._ntab, fac, r)
        if scale is None:
            scale = jnp.ones_like(R)
        b = (scale.astype(R.dtype) * R).astype(
            vals.dtype if vals is not None else self._jdt)
        lr = bicgstab(
            mv, b, precond=M,
            tol=self.opts.linear_tol if tol is None else tol,
            maxiter=self.opts.linear_maxiter,
        )
        return LinearResult(x=scale * lr.x, iters=lr.iters,
                            resnorm=lr.resnorm, converged=lr.converged)

    def _select_damp(self, norm_inf: float) -> float:
        """Per-iteration relaxation factor: the reference's damp_factor1-3
        ladder keyed on ||R||_inf (src/mm_sol_nonlinear.c:1998-2040)."""
        opts = self.opts
        d1 = opts.damp if opts.damp_factor1 is None else opts.damp_factor1
        d2, d3 = opts.damp_factor2, opts.damp_factor3
        in01 = lambda v: 0.0 <= v <= 1.0
        if in01(d1) and in01(d2) and in01(d3):
            if norm_inf > opts.custom_tol3:
                df = d3
            elif norm_inf > opts.custom_tol2:
                df = d2
            elif norm_inf > opts.custom_tol1:
                df = d1
            else:
                df = 1.0
        else:
            df = d1
        if df <= 1.0e-6:
            df = d1
        return df

    def _solve_pipelined(self, x0, params) -> NewtonResult:
        """Fast-prep GMRES Newton loop with the prep's norms fetch OVERLAPPED
        with the first Krylov cycle: prep, the device-side EW forcing
        tolerance, and the first cycle are dispatched back-to-back with NO
        host sync between them; the first cycle's scalar fetch then carries
        the residual norms along. The un-pipelined loop pays one host round
        trip per iteration just to *decide* convergence — here that decision
        rides the solve it would have gated. On the final (converged)
        iteration the speculative cycle's result is simply discarded.

        Semantics are identical to ``solve()``: same norms sequence, same
        EW tolerances (``_eta_device`` replicates the host formula), same
        prep32 endgame re-prep (which falls back to the sequential order
        for that one iteration)."""
        opts = self.opts
        x = jnp.asarray(x0)
        res_norms, upd_norms, lin_iters = [], [], []
        converged = False
        t_asm = t_slv = 0.0
        it = 0
        prev_l2_dev = None
        prep32 = (opts.prep32_tol > 0
                  and self._jdt != jnp.dtype(
                      getattr(self.problem, "dtype", jnp.float64)))
        for it in range(opts.max_iter):
            self._cur_x = x
            self._cur_params = params
            self._cur_ct = params.get("ct", 0.0) if isinstance(params, dict) \
                else 0.0
            # quadratic-convergence predictor: expected ||R||_2 ~
            # K ||R_prev||_2^2 with K ~ 3-6 on these decks (10x is
            # conservative). It informs two speculative choices:
            # - SPECULATE (dispatch the solve before reading the norms)
            #   only when another iteration is clearly coming — a wrong
            #   "sequential" costs one ~24 ms fetch, a wrong "speculate"
            #   wastes a whole discarded Krylov cycle;
            # - PRECISION: when the prep32 endgame is predicted, prep in
            #   f64 directly instead of paying the f32 pass AND the f64
            #   re-prep. Convergence/endgame FLAGS still follow the
            #   actual fetched norms, so a misprediction costs only time.
            exp_l2 = (np.inf if not res_norms
                      else 10.0 * res_norms[-1][1] ** 2)
            boundary = max(opts.prep32_tol, 2.0 * opts.tol_residual)
            cur32 = prep32 and exp_l2 >= boundary
            speculate = exp_l2 >= opts.tol_residual and \
                (not prep32 or exp_l2 >= boundary)
            t0 = time.perf_counter()
            if cur32:
                R, norms, scale, aux = self._fastprep32_jit(x, params)
            else:
                R, norms, scale, aux = self._fastprep_jit(x, params)
            t_asm += time.perf_counter() - t0
            t0 = time.perf_counter()
            if opts.forcing == "ew":
                sent = (jnp.asarray(-1.0, dtype=norms[1].dtype)
                        if prev_l2_dev is None else prev_l2_dev)
                eta = self._eta_jit(norms[1], sent)
            else:
                eta = opts.linear_tol
            if speculate:
                lr, fetched = self._solve_gmres(None, R, scale, aux, tol=eta,
                                                extra_fetch=norms)
                l1, l2, li = (float(v) for v in fetched)
            else:
                lr = None
                l1, l2, li = (float(v) for v in jax.device_get(norms))
                t_asm += time.perf_counter() - t0
                t0 = time.perf_counter()
            if (not cur32) and prep32 and (l2 < boundary
                                           or li < opts.tol_residual):
                # endgame confirmed and we are already at full precision
                prep32 = False
            if cur32 and (l2 < boundary or li < opts.tol_residual):
                # endgame: re-prep THIS iteration at full precision and run
                # the rest of the solve sequentially (once per Newton solve)
                t_slv += time.perf_counter() - t0
                prep32 = False
                t0 = time.perf_counter()
                R, norms, scale, aux = self._fastprep_jit(x, params)
                l1, l2, li = (float(v) for v in jax.device_get(norms))
                t_asm += time.perf_counter() - t0
                t0 = time.perf_counter()
                res_norms.append((l1, l2, li))
                if l2 < opts.tol_residual and li < opts.tol_residual:
                    converged = True
                    break
                if opts.forcing == "ew":
                    sent = (jnp.asarray(-1.0, dtype=norms[1].dtype)
                            if prev_l2_dev is None else prev_l2_dev)
                    eta = self._eta_jit(norms[1], sent)
                lr = self._solve_gmres(None, R, scale, aux, tol=eta)
            else:
                res_norms.append((l1, l2, li))
                if l2 < opts.tol_residual and li < opts.tol_residual:
                    converged = True
                    t_slv += time.perf_counter() - t0
                    break
                if lr is None:  # predictor said stop but Newton continues
                    lr = self._solve_gmres(None, R, scale, aux, tol=eta)
            prev_l2_dev = norms[1]
            lin_iters.append(lr.iters)
            t_slv += time.perf_counter() - t0
            x = x - self._select_damp(li) * lr.x.astype(x.dtype)
            if opts.full_history:
                upd_norms.append(jnp.linalg.norm(lr.x))
        lin_iters = [int(v) for v in jax.device_get(lin_iters)]
        upd_norms = [float(v) for v in jax.device_get(upd_norms)]
        return NewtonResult(
            x=np.asarray(jax.device_get(x)),
            converged=converged,
            iters=it,
            res_norms=res_norms,
            update_norms=upd_norms,
            linear_iters=lin_iters,
            assembly_time=t_asm,
            solve_time=t_slv,
        )

    def solve(self, x0, params) -> NewtonResult:
        opts = self.opts
        if (self._fast_prep and opts.linear_solver == "gmres"
                and opts.tol_update == 0):
            return self._solve_pipelined(x0, params)
        x = jnp.asarray(x0)
        res_norms, upd_norms, lin_iters = [], [], []
        converged = False
        t_asm = t_slv = 0.0
        it = 0
        prev_l2 = None
        for it in range(opts.max_iter):
            self._cur_x = x
            self._cur_params = params
            self._cur_ct = params.get("ct", 0.0) if isinstance(params, dict) else 0.0
            t0 = time.perf_counter()
            # opts.linear_solver may be switched after construction (e.g.
            # the segregated driver re-routes sub-solvers to direct):
            # direct paths need the assembled vals, so re-gate per solve
            fast = self._fast_prep and opts.linear_solver in ("gmres",
                                                              "bicgstab")
            if it == 0:
                prep32 = (fast and opts.prep32_tol > 0
                          and self._jdt != jnp.dtype(
                              getattr(self.problem, "dtype", jnp.float64)))
            if fast:
                if prep32:
                    R, norms, scale, aux = self._fastprep32_jit(x, params)
                else:
                    R, norms, scale, aux = self._fastprep_jit(x, params)
                vals = None
            else:
                R, vals, norms, scale, aux = self._prep(x, params,
                                                        self._ntab["ell"])
            l1, l2, li = jax.device_get(norms)
            if prep32 and (l2 < max(opts.prep32_tol, 2.0 * opts.tol_residual)
                           or li < opts.tol_residual):
                # endgame: the f32 norm is near the threshold — re-prep THIS
                # iteration at full precision and stay there. Convergence is
                # only ever declared from full-precision norms.
                prep32 = False
                R, norms, scale, aux = self._fastprep_jit(x, params)
                l1, l2, li = jax.device_get(norms)
            t_asm += time.perf_counter() - t0
            res_norms.append((float(l1), float(l2), float(li)))
            if l2 < opts.tol_residual and li < opts.tol_residual:
                converged = True
                break
            # Eisenstat-Walker adaptive forcing (choice 2): early iterations
            # get loose linear tolerances, the endgame gets linear_tol
            eta = opts.linear_tol
            if opts.forcing == "ew" and opts.linear_solver != "direct":
                if prev_l2 is None:
                    eta = max(opts.linear_tol, 1e-2)
                elif prev_l2 > 0:
                    eta = min(0.1, max(opts.linear_tol,
                                       0.5 * (float(l2) / prev_l2) ** 1.5))
                if opts.ew_eta_floor > 0:
                    eta = max(eta, opts.ew_eta_floor)
                if float(l2) > 0 and opts.tol_residual > 0:
                    need = 0.5 * opts.tol_residual / float(l2)
                    if opts.ew_endgame == "standard":
                        # classic oversolving safeguard: never solve tighter
                        # than finishing this step would need
                        eta = min(0.1, max(eta, min(need, 0.1)))
                        eta = max(eta, opts.linear_tol)
                    else:
                        # never looser than what finishing this step would
                        # need (tightens mid-run solves)
                        eta = max(opts.linear_tol,
                                  min(eta, max(need, opts.linear_tol)))
            prev_l2 = float(l2)
            t0 = time.perf_counter()
            if opts.linear_solver == "direct":
                # vals are symmetrically equilibrated: solve (DAD) z = D R
                s_h = np.asarray(jax.device_get(scale), dtype=np.float64)
                from goma_tpu.solvers.linear import LinearSolveError

                try:
                    z = direct_solve_host(
                        self.problem.pattern, jax.device_get(vals),
                        s_h * np.asarray(jax.device_get(R), dtype=np.float64),
                    )
                except LinearSolveError:
                    # hard linear-solve failure: abort the Newton iteration
                    # unconverged (reference: err < 0 -> goto free_and_clear,
                    # src/mm_sol_nonlinear.c; the transient driver's failure
                    # ladder then halves dt / re-tries)
                    t_slv += time.perf_counter() - t0
                    converged = False
                    break
                dx = jnp.asarray(s_h * z, dtype=R.dtype)
                lin_iters.append(1)
            elif opts.linear_solver == "tpu_direct":
                from goma_tpu.solvers.linear import LinearSolveError

                nd = self._ndlu
                if nd is None:
                    from goma_tpu.solvers.ndlu import NDLU, zero_diag_defer_mask

                    # value-based saddle detection (the equilibrated vals are
                    # live here): zero-diagonal rows go last in every front so
                    # blocked panel pivoting stays nonsingular
                    from goma_tpu.solvers.ndlu import node_clusters

                    nd = self._ndlu = NDLU(
                        self.problem.pattern, leaf_max=opts.ndlu_leaf_max,
                        dtype=jnp.dtype(opts.ndlu_dtype),
                        defer_dofs=zero_diag_defer_mask(
                            self.problem.pattern, jax.device_get(vals)),
                        clusters=node_clusters(self.problem)
                        if opts.ndlu_cluster else None,
                    )
                bD = scale * R
                rel_tol = max(1e-5, opts.linear_tol)
                mv = self._matvec(vals)
                if self._ndlu_sweep is None:
                    # one refinement sweep = matvec + norm + substitution
                    # + update fused into ONE dispatch (separate calls pay
                    # ~3 host<->device round trips each);
                    # tables/vals are jit ARGS, not consts
                    ell = self._ell
                    nd_solve = nd._solve

                    @jax.jit
                    def _fused(facs, tabs, vals_a, b, x):
                        r = b - ell.matvec(vals_a, x)
                        rn = jnp.linalg.norm(r)
                        return x + nd_solve(facs, r, tabs).astype(b.dtype), rn

                    self._ndlu_sweep = _fused
                sweep_fn = (lambda facs, b, x:
                            self._ndlu_sweep(facs, nd.tabs, vals, b, x))

                def _try(fac):
                    # refine-to-tolerance (0.5x headroom under the guard):
                    # the fixed-count landing point varies with hardware
                    # rounding; refinement always runs against the FRESH
                    # equilibrated operator. solve_refined hands back the
                    # residual it already measured for the returned iterate
                    # so the guard doesn't pay a second matvec + host sync
                    z, rel = nd.solve_refined(fac, bD, mv,
                                              refine=opts.ndlu_refine,
                                              rel_tol=0.5 * rel_tol,
                                              max_refine=opts.ndlu_max_refine,
                                              return_rel=True,
                                              sweep=sweep_fn)
                    if rel is None:
                        rel = float(jax.device_get(
                            jnp.linalg.norm(bD - self._ell.matvec(vals, z))
                            / (jnp.linalg.norm(bD) + 1e-300)))
                    return z, rel

                fresh = not (opts.ndlu_lag and self._ndlu_fac is not None)
                if fresh:
                    self._ndlu_nfactor += 1
                fac = nd.factor(vals) if fresh else self._ndlu_fac
                z, rel = _try(fac)
                if (not np.isfinite(rel) or rel > rel_tol) and not fresh:
                    # stale factors can't carry refinement to tolerance on
                    # this Jacobian — refactor and retry once
                    fac = nd.factor(vals)
                    fresh = True
                    self._ndlu_nfactor += 1
                    z, rel = _try(fac)
                if opts.ndlu_lag:
                    self._ndlu_fac = fac
                # singular/rank-deficient guard (direct-path semantics):
                # refined solve must leave a small relative residual. The
                # floor is the f32-factorization refinement limit; anything
                # up to the configured inexact-Newton linear_tol is still a
                # valid Newton step (same eta the Krylov path would use).
                if not np.isfinite(rel) or rel > rel_tol:
                    t_slv += time.perf_counter() - t0
                    converged = False
                    break
                dx = (scale * z).astype(R.dtype)
                lin_iters.append(1)
            else:
                fn = self._solve_gmres if opts.linear_solver == "gmres" else self._solve_bicgstab
                lr: LinearResult = fn(vals, R, scale, aux, tol=eta)
                dx = lr.x
                # deferred fetch: keep the device scalar; one batched
                # device_get after the loop replaces a host round trip per
                # iteration
                lin_iters.append(lr.iters)
            t_slv += time.perf_counter() - t0
            x = x - self._select_damp(float(li)) * dx.astype(x.dtype)
            if opts.tol_update > 0:
                # control-flow consumer: must fetch now
                un = float(jax.device_get(jnp.linalg.norm(dx)))
                upd_norms.append(un)
            elif opts.full_history:
                # record-only consumer: defer to the post-loop batch fetch
                upd_norms.append(jnp.linalg.norm(dx))
                un = np.inf
            else:
                un = np.inf
            if opts.tol_update > 0 and un < opts.tol_update:
                # correction-norm convergence (reference Epsilon[2] path)
                if fast:
                    R, norms, scale, aux = self._fastprep_jit(x, params)
                else:
                    R, vals, norms, scale, aux = self._prep(
                        x, params, self._ntab["ell"])
                l1, l2, li = jax.device_get(norms)
                res_norms.append((float(l1), float(l2), float(li)))
                converged = True
                it += 1
                break
        # drain the deferred per-iteration scalars in ONE transfer
        lin_iters = [int(v) for v in jax.device_get(lin_iters)]
        upd_norms = [float(v) for v in jax.device_get(upd_norms)]
        return NewtonResult(
            x=np.asarray(jax.device_get(x)),
            converged=converged,
            iters=it,
            res_norms=res_norms,
            update_norms=upd_norms,
            linear_iters=lin_iters,
            assembly_time=t_asm,
            solve_time=t_slv,
        )
