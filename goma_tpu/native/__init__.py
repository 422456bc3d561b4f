"""Native (C++) mesh-preprocessing kernels with numpy fallbacks.

Compiled on first use with g++ (the image has no pybind11; bindings are
ctypes). If compilation fails a warning says so and the pure-numpy
fallbacks are used — same results, slower on large meshes (host-side work;
the device path is the same either way).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import warnings
from pathlib import Path

import numpy as np

_HERE = Path(__file__).parent
_LIB = None
_TRIED = False


def _compile(name: str = "meshprep", extra_flags: tuple = ()) -> Path | None:
    so = _HERE / "_build" / f"lib{name}.so"
    src = _HERE / f"{name}.cpp"
    if so.exists() and so.stat().st_mtime >= src.stat().st_mtime:
        return so
    so.parent.mkdir(exist_ok=True)
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", *extra_flags,
             str(src), "-o", str(so)],
            check=True, capture_output=True, timeout=120,
        )
        return so
    except Exception as e:
        warnings.warn(f"native {name}.cpp build failed ({type(e).__name__}); "
                      "using the numpy fallback")
        return None


def _lib():
    global _LIB, _TRIED
    if _LIB is None and not _TRIED:
        _TRIED = True
        so = _compile()
        if so is not None:
            lib = ctypes.CDLL(str(so))
            lib.rcb_partition.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int,
                ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
            ]
            lib.morton_order.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.kway_partition.argtypes = [
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32),
            ]
            lib.bisect_partition.argtypes = [
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32),
            ]
            lib.edge_cut.restype = ctypes.c_int64
            lib.edge_cut.argtypes = [
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32),
            ]
            _LIB = lib
    return _LIB


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def kway_partition(xadj: np.ndarray, adjncy: np.ndarray,
                   adjwgt: np.ndarray, nparts: int) -> np.ndarray:
    """Multilevel k-way graph partitioning (METIS KWAY analog; reference
    goma_metis_decomposition, src/metis_decomp.c:372). Falls back to a
    BFS greedy-growing partition in numpy if the native build is missing."""
    n = xadj.shape[0] - 1
    xadj = np.ascontiguousarray(xadj, dtype=np.int64)
    adjncy = np.ascontiguousarray(adjncy, dtype=np.int64)
    adjwgt = np.ascontiguousarray(adjwgt, dtype=np.int64)
    out = np.empty(n, dtype=np.int32)
    lib = _lib()
    if lib is not None:
        lib.kway_partition(_i64p(xadj), _i64p(adjncy), _i64p(adjwgt),
                           n, int(nparts),
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out
    # numpy fallback: single-level greedy BFS growing (no refinement)
    target = n / nparts
    out[:] = nparts - 1
    taken = np.zeros(n, dtype=bool)
    for p in range(nparts - 1):
        rest = np.where(~taken)[0]
        if rest.size == 0:
            break
        frontier = [int(rest[0])]
        taken[rest[0]] = True
        out[rest[0]] = p
        w = 1
        while frontier and w < target:
            v = frontier.pop(0)
            for u in adjncy[xadj[v]:xadj[v + 1]]:
                if not taken[u] and w < target:
                    taken[u] = True
                    out[u] = p
                    w += 1
                    frontier.append(int(u))
        if w < target:
            extra = np.where(~taken)[0][: int(target - w)]
            taken[extra] = True
            out[extra] = p
    return out


def bisect_partition(xadj: np.ndarray, adjncy: np.ndarray,
                     adjwgt: np.ndarray) -> np.ndarray:
    """Multilevel 2-way partition with true FM (rollback) refinement —
    better cuts than :func:`kway_partition` at nparts=2; used for
    nested-dissection separators (solvers/ndlu) and recursive bisection."""
    n = xadj.shape[0] - 1
    xadj = np.ascontiguousarray(xadj, dtype=np.int64)
    adjncy = np.ascontiguousarray(adjncy, dtype=np.int64)
    adjwgt = np.ascontiguousarray(adjwgt, dtype=np.int64)
    out = np.empty(n, dtype=np.int32)
    lib = _lib()
    if lib is not None:
        lib.bisect_partition(_i64p(xadj), _i64p(adjncy), _i64p(adjwgt), n,
                             out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out
    return kway_partition(xadj, adjncy, adjwgt, 2)


def graph_edge_cut(xadj, adjncy, adjwgt, part) -> int:
    """Total weight of edges crossing the partition."""
    xadj = np.ascontiguousarray(xadj, dtype=np.int64)
    adjncy = np.ascontiguousarray(adjncy, dtype=np.int64)
    adjwgt = np.ascontiguousarray(adjwgt, dtype=np.int64)
    part = np.ascontiguousarray(part, dtype=np.int32)
    lib = _lib()
    if lib is not None:
        return int(lib.edge_cut(
            _i64p(xadj), _i64p(adjncy), _i64p(adjwgt), xadj.shape[0] - 1,
            part.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))))
    src = np.repeat(np.arange(xadj.shape[0] - 1), np.diff(xadj))
    return int(adjwgt[part[src] != part[adjncy]].sum() // 2)


def rcb_partition(centroids: np.ndarray, nparts: int) -> np.ndarray:
    """Recursive coordinate bisection of points into nparts balanced parts.
    Reference analog: goma_metis_decomposition (src/metis_decomp.c:372) with
    the -rcb option."""
    centroids = np.ascontiguousarray(centroids, dtype=np.float64)
    n, dim = centroids.shape
    out = np.empty(n, dtype=np.int32)
    lib = _lib()
    if lib is not None:
        lib.rcb_partition(
            centroids.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            n, dim, nparts, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return out
    # numpy fallback
    def rec(ids, npart, p0):
        if npart <= 1 or len(ids) <= 1:
            out[ids] = p0
            return
        box = centroids[ids]
        axis = int(np.argmax(box.max(0) - box.min(0)))
        left = npart // 2
        k = max(1, min(len(ids) - 1, int(round(len(ids) * left / npart))))
        order = np.argpartition(box[:, axis], k)
        rec(ids[order[:k]], left, p0)
        rec(ids[order[k:]], npart - left, p0 + left)

    rec(np.arange(n), nparts, 0)
    return out


def morton_order(centroids: np.ndarray) -> np.ndarray:
    """Z-curve ordering of points (element gather locality)."""
    centroids = np.ascontiguousarray(centroids, dtype=np.float64)
    n, dim = centroids.shape
    lib = _lib()
    if lib is not None:
        out = np.empty(n, dtype=np.int64)
        lib.morton_order(
            centroids.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            n, dim, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        return out
    # numpy fallback: interleave 16-bit quantized coords
    lo, hi = centroids.min(0), centroids.max(0)
    q = ((centroids - lo) / np.where(hi > lo, hi - lo, 1) * 65535).astype(np.uint64)
    keys = np.zeros(n, dtype=np.uint64)
    for bit in range(16):
        for d in range(dim):
            keys |= ((q[:, d] >> np.uint64(bit)) & np.uint64(1)) << np.uint64(bit * dim + d)
    return np.argsort(keys, kind="stable").astype(np.int64)


def ref_assembly_seconds_per_element(n_rep: int = 20000) -> float | None:
    """Time the compiled reference-style scalar NS Q2/Q1 element assembly
    (one x86 core, -O3) — the honest denominator for the bench's assembly
    speedup. Returns None if the native build is unavailable."""
    so = _compile("refassembly")
    if so is None:
        return None
    from goma_tpu.elements import eval_basis, volume_rule

    lib = ctypes.CDLL(str(so))
    lib.ref_assembly_seconds_per_element.restype = ctypes.c_double
    lib.ref_assembly_seconds_per_element.argtypes = [
        ctypes.c_int] + [ctypes.POINTER(ctypes.c_double)] * 6 + [ctypes.c_int]

    qpts, qwts = volume_rule("quad", 3)
    N2, dN2 = eval_basis("quad", "Q2", qpts)
    N1, _ = eval_basis("quad", "Q1", qpts)
    X = np.array([[0, 0], [1, 0], [1, 1], [0, 1], [0.5, 0], [1, 0.5],
                  [0.5, 1], [0, 0.5], [0.5, 0.5]], dtype=float) * 0.1
    q = np.random.RandomState(0).rand(22)

    def p(a):
        a = np.ascontiguousarray(a, dtype=np.float64)
        return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    keep = [p(a) for a in (N2, dN2, N1, qwts, X, q)]
    return float(lib.ref_assembly_seconds_per_element(
        qpts.shape[0], *(k[1] for k in keep), n_rep))


def ref_assembly_generic_seconds_per_element(nv2: int, nv1: int,
                                             n_rep: int = 4000) -> float | None:
    """Compiled reference-style multi-field element assembly time (one x86
    core, -O3): nv2 Q2-interpolated scalar fields + nv1 Q1 fields on a 2D
    quad — the per-config baseline denominator for BASELINE decks #2-#5
    (the reference hand-codes R and every dR/dq per entry; cost shape
    ~ nq * n_ldof^2, src/mm_fill.c:1144-1700). None if native unavailable."""
    so = _compile("refassembly")
    if so is None:
        return None
    from goma_tpu.elements import eval_basis, volume_rule

    lib = ctypes.CDLL(str(so))
    fn = lib.ref_assembly_generic_seconds_per_element
    fn.restype = ctypes.c_double
    fn.argtypes = [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_double)] * 6 + [ctypes.c_int]

    qpts, qwts = volume_rule("quad", 3)
    N2, dN2 = eval_basis("quad", "Q2", qpts)
    N1, _ = eval_basis("quad", "Q1", qpts)
    X = np.array([[0, 0], [1, 0], [1, 1], [0, 1], [0.5, 0], [1, 0.5],
                  [0.5, 1], [0, 0.5], [0.5, 0.5]], dtype=float) * 0.1
    q = np.random.RandomState(0).rand(9 * nv2 + 4 * nv1)

    def p(a):
        a = np.ascontiguousarray(a, dtype=np.float64)
        return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    keep = [p(a) for a in (N2, dN2, N1, qwts, X, q)]
    return float(fn(qpts.shape[0], nv2, nv1, *(k[1] for k in keep), n_rep))


# ------------------------------------------------------ CSR graph kernels
_GRAPH_LIB = None
_GRAPH_TRIED = False


def _graph_lib():
    global _GRAPH_LIB, _GRAPH_TRIED
    if _GRAPH_LIB is None and not _GRAPH_TRIED:
        _GRAPH_TRIED = True
        so = _compile("graph", extra_flags=("-pthread",))
        if so is not None:
            lib = ctypes.CDLL(str(so))
            lib.sort_unique_i64.restype = ctypes.c_int64
            lib.sort_unique_i64.argtypes = [
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int]
            lib.searchsorted_i64.argtypes = [
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
            _GRAPH_LIB = lib
    return _GRAPH_LIB


def sort_unique(keys: np.ndarray) -> np.ndarray:
    """Sorted unique int64 keys (parallel C++ when available; the matrix
    graph-construction primitive, reference src/linalg/sparse_matrix.cpp
    create_graph)."""
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    lib = _graph_lib()
    if lib is None:
        return np.unique(keys)
    buf = keys.copy()
    m = lib.sort_unique_i64(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), buf.shape[0], 0)
    return buf[:m]


def searchsorted_native(sorted_keys: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Parallel lower_bound lookup (falls back to np.searchsorted)."""
    lib = _graph_lib()
    q = np.ascontiguousarray(queries, dtype=np.int64)
    if lib is None:
        return np.searchsorted(sorted_keys, q)
    s = np.ascontiguousarray(sorted_keys, dtype=np.int64)
    out = np.empty(q.shape[0], dtype=np.int64)
    lib.searchsorted_i64(
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), s.shape[0],
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), q.shape[0],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), 0)
    return out
