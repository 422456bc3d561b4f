"""Per-level cost of the NDLU front factor on the current device.

For the n x n cavity Jacobian (the bench preconditioner configuration: f32,
selective inversion, leaf_max=192) and each ``lu_block`` in {None, 64, 128}:

- the whole ``NDLU.factor`` time;
- each level's front factor alone (batched ``lax.linalg.lu`` or the blocked
  panel LU, the GESP boost, and the two triangular inversions) on a batch
  of that level's shape (nn, s, s);
- the custom calls XLA lowers batched ``lu`` and ``triangular_solve`` to
  at each level's shape, and whether a while loop runs them.

With ``--trace DIR`` one factor call per ``lu_block`` is also traced with
``jax.profiler`` (named scopes ``ndlu_l<i>/front_lu``).

Run: python scripts/ndlu_front_levels.py [--n 64] [--reps 5] [--trace DIR]
Prints one JSON object per line; times are seconds, the median of --reps.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _median_time(fn, reps):
    import jax

    jax.block_until_ready(fn())  # compile
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _lowering(fn, x):
    """Custom-call targets and while-loop count in the optimized HLO."""
    import jax

    txt = jax.jit(fn).lower(x).compile().as_text()
    targets = sorted(set(re.findall(r'custom_call_target="([^"]+)"', txt)))
    return {"custom_calls": targets, "while_loops": txt.count(" while(")}


def _reduce_trace(d):
    """Device time of one traced factor call: per-level front factor (the
    ``ndlu_l<i>_front_lu`` scopes, matched in any event stat), the whole
    device busy time, and the kernels that took the most time."""
    import glob

    import jax

    paths = glob.glob(os.path.join(d, "plugins", "profile", "*",
                                   "*.xplane.pb"))
    if not paths:
        return {"trace": "no xplane file"}
    pd = jax.profiler.ProfileData.from_file(paths[0])
    per_level, kernels, busy = {}, {}, 0.0
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                dur = ev.duration_ns * 1e-9
                busy += dur
                kernels[ev.name] = kernels.get(ev.name, 0.0) + dur
                txt = " ".join(str(v) for _k, v in ev.stats)
                m = re.search(r"ndlu_l(\d+)_front_lu", txt)
                if m:
                    k = int(m.group(1))
                    per_level[k] = per_level.get(k, 0.0) + dur
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:25]
    return {"device_event_sum_s": busy,
            "front_lu_by_level_s": {str(k): v for k, v
                                    in sorted(per_level.items())},
            "top_kernels_s": top}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--trace", default=None)
    a = ap.parse_args()

    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)
    from goma_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from __graft_entry__ import _cavity_problem
    from goma_tpu.fem.sparsity import sym_sum_scale
    from goma_tpu.solvers.ndlu import NDLU, gesp_boost, node_clusters
    from goma_tpu.solvers.twolevel import _saddle_mask

    from goma_tpu.utils.device import card_line

    dev = jax.devices()[0]
    card = card_line()
    print(json.dumps({"device": dev.platform, "kind": dev.device_kind,
                      "card": card}), flush=True)

    prob = _cavity_problem(a.n)
    pat = prob.pattern
    rng = np.random.default_rng(0)
    x = jnp.asarray(0.1 * rng.standard_normal(prob.dofmap.n_dof))
    _R, vals = prob._assemble(x, prob.base_params())
    vals, _ = sym_sum_scale(vals, jnp.asarray(pat.rows),
                            jnp.asarray(pat.indices), pat.n)
    defer, clusters = _saddle_mask(prob), node_clusters(prob)

    for lu_block in (None, 64, 128):
        nd = NDLU(pat, leaf_max=192, dtype=jnp.float32, defer_dofs=defer,
                  invert=True, clusters=clusters, lu_block=lu_block)
        t_factor = _median_time(lambda: nd.factor(vals), a.reps)
        levels = []
        for i, lv in enumerate(nd.levels):
            s = lv.smax
            A = jnp.asarray(
                rng.standard_normal((lv.nn, s, s)) + s * np.eye(s),
                jnp.float32)

            def front(A11, nd=nd):
                with jax.default_matmul_precision("highest"):
                    if nd.lu_block and A11.shape[-1] > nd.lu_block:
                        lu, perm = nd._block_lu(A11)
                    else:
                        lu, _p, perm = jax.lax.linalg.lu(A11)
                        lu = gesp_boost(lu, nd.pivot_tol)
                    m = lu.shape[-1]
                    eye = jnp.broadcast_to(jnp.eye(m, dtype=lu.dtype),
                                           lu.shape)
                    tri = jax.lax.linalg.triangular_solve
                    fwd = tri(lu, eye, left_side=True, lower=True,
                              unit_diagonal=True)
                    bwd = tri(lu, eye, left_side=True, lower=False)
                    return fwd, bwd, perm

            jf = jax.jit(front)
            t = _median_time(lambda: jf(A), a.reps)
            levels.append(dict(level=i, nn=lv.nn, s=s, b=lv.bmax,
                               front_factor_s=t, **_lowering(front, A)))
        tot = sum(lv["front_factor_s"] for lv in levels)
        print(json.dumps({
            "lu_block": lu_block, "n": a.n, "n_dof": pat.n,
            "factor_s": t_factor, "front_factor_sum_s": tot,
            "front_share_of_factor": tot / t_factor,
            "small_front_share": sum(lv["front_factor_s"] for lv in levels
                                     if lv["s"] <= 128) / t_factor,
            "levels": levels, "card": card}), flush=True)
        if a.trace:
            d = os.path.join(a.trace, f"lu_block_{lu_block}")
            jax.block_until_ready(nd.factor(vals))
            with jax.profiler.trace(d):
                jax.block_until_ready(nd.factor(vals))
            print(json.dumps({"lu_block": lu_block, "trace": d,
                              **_reduce_trace(d)}), flush=True)


if __name__ == "__main__":
    main()
