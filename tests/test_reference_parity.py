"""Golden Newton-trace parity fixtures.

The reference's north-star parity clause (BASELINE.json) is "identical
Newton iteration counts and residual norms to 1e-10 vs reference on a
slot-coating run"; the reference prints its iteration table in
``src/mm_sol_nonlinear.c:1106-1135``. A reference build is not available
in this environment (Trilinos/Aztec are not vendored, no network), so
the committed fixtures are golden traces of THIS framework's validated
f64 host-direct runs — the same format as the reference table
(iteration count + per-iteration scaled ``||R||``), stored in
``tests/golden/``. Their job is drift detection: any change to
assembly, BC application, scaling, damping, or the transient ladder
that alters convergence behavior fails here loudly. When a reference
build is available the fixtures can be regenerated from it verbatim
(same JSON shape) and the test becomes a true cross-code parity check.

Regenerate (after an INTENDED convergence-behavior change):
    python tests/test_reference_parity.py --regen
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

GOLD = os.path.join(os.path.dirname(__file__), "golden")


def _cavity_trace():
    """Steady lid-driven cavity (Re=100, 24x24 Q2/Q1), host direct solves,
    fixed forcing — a deterministic quadratic Newton tail."""
    import jax.numpy as jnp

    from goma_tpu.fem import Problem
    from goma_tpu.mesh import rectangle_mesh
    from goma_tpu.physics import Continuity, Momentum
    from goma_tpu.solvers import NewtonOptions, NewtonSolver

    mesh = rectangle_mesh(24, 24, elem="QUAD9")
    mesh.nodesets["pin"] = np.array([0], dtype=np.int32)
    prob = Problem(mesh, [Momentum(dim=2, transient=False), Continuity()],
                   {"rho": 1.0, "mu": 0.01})
    for ns in ("left", "right", "bottom"):
        prob.add_dirichlet(ns, "velocity", 0, 0.0)
        prob.add_dirichlet(ns, "velocity", 1, 0.0)
    prob.add_dirichlet("top", "velocity", 0, 1.0)
    prob.add_dirichlet("top", "velocity", 1, 0.0)
    prob.add_dirichlet("pin", "pressure", 0, 0.0)
    prob.finalize()
    opts = NewtonOptions(max_iter=15, tol_residual=1e-10,
                         linear_solver="direct", forcing="fixed")
    res = NewtonSolver(prob, opts).solve(jnp.zeros(prob.dofmap.n_dof),
                                         prob.base_params())
    assert res.converged
    return {
        "deck": "cavity Re=100 24x24 Q2Q1, host direct, forcing=fixed",
        "newton_iters": int(res.iters),
        "res_l2": [float(l2) for (_, l2, _) in res.res_norms],
    }


def _slot_coater_trace():
    """Transient ALE slot coater (16x4, three fixed steps), host direct —
    the named deck of the parity clause. Per-step Newton counts + the
    final step's residual trajectory."""
    import examples.slot_coater as sc

    prob, ts, x0 = sc.build(nx=16, ny=4, t_end=0.06, linear_solver="direct",
                            newton_overrides=dict(forcing="fixed"))
    ts.topts.adapt = False
    ts.topts.dt0 = 0.02
    r = ts.run(x0, prob.base_params())
    steps = [s for s in r.steps if s.converged]
    assert len(steps) == len(r.steps) and steps, "a step failed to converge"
    return {
        "deck": "slot coater ALE 16x4 Q2Q1, dt=0.02 x3, host direct",
        "steps": len(steps),
        "newton_iters": [int(s.newton_iters) for s in steps],
        "err_time": [float(s.err_time) for s in steps],
    }


def _check(trace, gold, max_extra_iters=0, log10_tol=1.0, floor=1e-11):
    """Iteration counts must match exactly (up to ``max_extra_iters``);
    each per-iteration ||R||_2 must match in log-space within
    ``log10_tol`` decades (quadratic tails diverge fast in absolute
    terms; the trajectory SHAPE is the parity object). Norms below
    ``floor`` are 'converged noise' and compare as equal."""
    gi, ti = gold["newton_iters"], trace["newton_iters"]
    if isinstance(gi, list):
        assert len(ti) == len(gi), (ti, gi)
        for a, b in zip(ti, gi):
            assert abs(a - b) <= max_extra_iters, (ti, gi)
    else:
        assert abs(ti - gi) <= max_extra_iters, (ti, gi)
    key = "res_l2" if "res_l2" in gold else "err_time"
    g, t = gold[key], trace[key]
    assert len(t) == len(g), (t, g)
    for a, b in zip(t, g):
        a, b = max(a, floor), max(b, floor)
        assert abs(np.log10(a) - np.log10(b)) <= log10_tol, (t, g)


def test_cavity_newton_trace_parity():
    with open(os.path.join(GOLD, "newton_trace_cavity.json")) as f:
        gold = json.load(f)
    _check(_cavity_trace(), gold)


def test_slot_coater_newton_trace_parity():
    with open(os.path.join(GOLD, "newton_trace_slot_coater.json")) as f:
        gold = json.load(f)
    _check(_slot_coater_trace(), gold)


if __name__ == "__main__":
    if "--regen" in sys.argv:
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        os.makedirs(GOLD, exist_ok=True)
        for name, fn in [("newton_trace_cavity.json", _cavity_trace),
                         ("newton_trace_slot_coater.json",
                          _slot_coater_trace)]:
            tr = fn()
            with open(os.path.join(GOLD, name), "w") as f:
                json.dump(tr, f, indent=2)
            print(name, "<-", tr)
    else:
        print(__doc__)
