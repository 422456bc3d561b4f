// Native mesh-preprocessing kernels.
//
// Parity: the reference's native decomposition layer — METIS element
// partitioning (src/metis_decomp.c:372 goma_metis_decomposition) and the
// C++ ghost/graph builders (src/dp_ghost.cpp). Replacements:
//
//  - rcb_partition: recursive coordinate bisection of element centroids
//    into nparts balanced, spatially-compact parts (drives the shard_map
//    element sharding so each device touches a compact dof range).
//  - morton_order: Morton (Z-curve) ordering of element centroids for
//    gather locality on device.
//
// Built with g++ -O3 -shared; bound via ctypes (no pybind11 in the image).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <queue>
#include <utility>
#include <vector>

extern "C" {

// ----------------------------------------------------------------- RCB
static void rcb_recurse(const double* c, int dim, int64_t* ids, int64_t n,
                        int nparts, int part0, int32_t* out) {
  if (nparts <= 1 || n <= 1) {
    for (int64_t i = 0; i < n; ++i) out[ids[i]] = part0;
    return;
  }
  // split along the widest extent
  double lo[3] = {1e300, 1e300, 1e300}, hi[3] = {-1e300, -1e300, -1e300};
  for (int64_t i = 0; i < n; ++i) {
    const double* p = c + ids[i] * dim;
    for (int d = 0; d < dim; ++d) {
      lo[d] = std::min(lo[d], p[d]);
      hi[d] = std::max(hi[d], p[d]);
    }
  }
  int axis = 0;
  for (int d = 1; d < dim; ++d)
    if (hi[d] - lo[d] > hi[axis] - lo[axis]) axis = d;

  int left_parts = nparts / 2;
  int64_t nleft = (int64_t)((double)n * left_parts / nparts + 0.5);
  nleft = std::max<int64_t>(1, std::min(n - 1, nleft));
  std::nth_element(ids, ids + nleft, ids + n, [&](int64_t a, int64_t b) {
    return c[a * dim + axis] < c[b * dim + axis];
  });
  rcb_recurse(c, dim, ids, nleft, left_parts, part0, out);
  rcb_recurse(c, dim, ids + nleft, n - nleft, nparts - left_parts,
              part0 + left_parts, out);
}

void rcb_partition(const double* centroids, int64_t n, int dim, int nparts,
                   int32_t* part_out) {
  std::vector<int64_t> ids(n);
  std::iota(ids.begin(), ids.end(), 0);
  rcb_recurse(centroids, dim, ids.data(), n, nparts, 0, part_out);
}

// --------------------------------------------------------------- Morton
static inline uint64_t spread3(uint64_t x) {
  x &= 0x1fffff;
  x = (x | x << 32) & 0x1f00000000ffffULL;
  x = (x | x << 16) & 0x1f0000ff0000ffULL;
  x = (x | x << 8) & 0x100f00f00f00f00fULL;
  x = (x | x << 4) & 0x10c30c30c30c30c3ULL;
  x = (x | x << 2) & 0x1249249249249249ULL;
  return x;
}
static inline uint64_t spread2(uint64_t x) {
  x &= 0xffffffff;
  x = (x | x << 16) & 0x0000ffff0000ffffULL;
  x = (x | x << 8) & 0x00ff00ff00ff00ffULL;
  x = (x | x << 4) & 0x0f0f0f0f0f0f0f0fULL;
  x = (x | x << 2) & 0x3333333333333333ULL;
  x = (x | x << 1) & 0x5555555555555555ULL;
  return x;
}

void morton_order(const double* centroids, int64_t n, int dim,
                  int64_t* order_out) {
  double lo[3] = {1e300, 1e300, 1e300}, hi[3] = {-1e300, -1e300, -1e300};
  for (int64_t i = 0; i < n; ++i)
    for (int d = 0; d < dim; ++d) {
      double v = centroids[i * dim + d];
      lo[d] = std::min(lo[d], v);
      hi[d] = std::max(hi[d], v);
    }
  std::vector<uint64_t> keys(n);
  for (int64_t i = 0; i < n; ++i) {
    uint64_t k = 0;
    if (dim == 2) {
      for (int d = 0; d < 2; ++d) {
        double s = (hi[d] > lo[d]) ? (centroids[i * dim + d] - lo[d]) / (hi[d] - lo[d]) : 0.0;
        uint64_t q = (uint64_t)(s * 4294967295.0);
        k |= spread2(q) << d;
      }
    } else {
      for (int d = 0; d < dim; ++d) {
        double s = (hi[d] > lo[d]) ? (centroids[i * dim + d] - lo[d]) / (hi[d] - lo[d]) : 0.0;
        uint64_t q = (uint64_t)(s * 2097151.0);
        k |= spread3(q) << d;
      }
    }
    keys[i] = k;
  }
  std::iota(order_out, order_out + n, (int64_t)0);
  std::sort(order_out, order_out + n,
            [&](int64_t a, int64_t b) { return keys[a] < keys[b]; });
}

}  // extern "C"

// -------------------------------------------------- multilevel k-way
// METIS-style multilevel k-way graph partitioning over the element dual
// graph — the reference's default decomposition mode (KWAY in
// goma_metis_decomposition, src/metis_decomp.c:372). Original
// implementation of the textbook multilevel recipe: heavy-edge-matching
// coarsening, greedy-graph-growing initial partition on the coarsest
// graph, and greedy boundary (FM-style) refinement at every uncoarsening
// level.

namespace {

struct Graph {
  int64_t n = 0;
  std::vector<int64_t> xadj, adjncy;
  std::vector<int64_t> adjwgt, vwgt;
  std::vector<int64_t> cmap;  // fine vertex -> coarse vertex (on the finer graph)
};

// deterministic LCG (no libc rand state)
inline uint64_t lcg(uint64_t& s) {
  s = s * 6364136223846793005ULL + 1442695040888963407ULL;
  return s >> 33;
}

Graph coarsen(const Graph& g, uint64_t& seed) {
  std::vector<int64_t> match(g.n, -1), perm(g.n);
  std::iota(perm.begin(), perm.end(), (int64_t)0);
  for (int64_t i = g.n - 1; i > 0; --i)
    std::swap(perm[i], perm[lcg(seed) % (uint64_t)(i + 1)]);
  // heavy-edge matching
  int64_t nc = 0;
  std::vector<int64_t> label(g.n, -1);
  for (int64_t pi = 0; pi < g.n; ++pi) {
    int64_t v = perm[pi];
    if (match[v] >= 0) continue;
    int64_t best = -1, bw = -1;
    for (int64_t e = g.xadj[v]; e < g.xadj[v + 1]; ++e) {
      int64_t u = g.adjncy[e];
      if (match[u] < 0 && u != v && g.adjwgt[e] > bw) {
        bw = g.adjwgt[e];
        best = u;
      }
    }
    match[v] = (best >= 0) ? best : v;
    if (best >= 0) match[best] = v;
    label[v] = nc;
    if (best >= 0) label[best] = nc;
    ++nc;
  }
  Graph c;
  c.n = nc;
  c.vwgt.assign(nc, 0);
  for (int64_t v = 0; v < g.n; ++v) c.vwgt[label[v]] += g.vwgt[v];
  // contract adjacency (scatter-accumulate with a per-row stamp array)
  c.xadj.assign(nc + 1, 0);
  std::vector<int64_t> stamp(nc, -1), acc(nc, 0), cols;
  cols.reserve(g.adjncy.size());
  std::vector<int64_t> wout;
  wout.reserve(g.adjncy.size());
  for (int64_t cv = 0; cv < nc; ++cv) c.xadj[cv] = 0;
  std::vector<std::pair<int64_t, int64_t>> members(g.n);
  for (int64_t v = 0; v < g.n; ++v) members[v] = {label[v], v};
  std::sort(members.begin(), members.end());
  int64_t mi = 0;
  for (int64_t cv = 0; cv < nc; ++cv) {
    int64_t row_start = (int64_t)cols.size();
    for (; mi < g.n && members[mi].first == cv; ++mi) {
      int64_t v = members[mi].second;
      for (int64_t e = g.xadj[v]; e < g.xadj[v + 1]; ++e) {
        int64_t cu = label[g.adjncy[e]];
        if (cu == cv) continue;
        if (stamp[cu] != cv) {
          stamp[cu] = cv;
          acc[cu] = (int64_t)cols.size();
          cols.push_back(cu);
          wout.push_back(g.adjwgt[e]);
        } else {
          wout[acc[cu]] += g.adjwgt[e];
        }
      }
    }
    c.xadj[cv + 1] = (int64_t)cols.size();
    (void)row_start;
  }
  c.adjncy = std::move(cols);
  c.adjwgt = std::move(wout);
  c.cmap = std::move(label);
  return c;
}

// greedy graph growing on the coarsest graph
void initial_partition(const Graph& g, int nparts, int32_t* part,
                       uint64_t& seed) {
  int64_t total = 0;
  for (int64_t v = 0; v < g.n; ++v) total += g.vwgt[v];
  double target = (double)total / nparts;
  std::fill(part, part + g.n, (int32_t)(nparts - 1));
  std::vector<char> taken(g.n, 0);
  std::vector<int64_t> queue;
  for (int p = 0; p < nparts - 1; ++p) {
    int64_t w = 0;
    // seed: an untaken vertex (prefer one adjacent to taken region's
    // boundary-exterior for compactness; fall back to random)
    int64_t s = -1;
    for (int64_t tries = 0; tries < 32 && s < 0; ++tries) {
      int64_t cand = lcg(seed) % (uint64_t)g.n;
      if (!taken[cand]) s = cand;
    }
    if (s < 0)
      for (int64_t v = 0; v < g.n; ++v)
        if (!taken[v]) { s = v; break; }
    if (s < 0) break;
    queue.clear();
    queue.push_back(s);
    taken[s] = 1;
    part[s] = p;
    w += g.vwgt[s];
    size_t qh = 0;
    while (w < target && qh < queue.size()) {
      int64_t v = queue[qh++];
      for (int64_t e = g.xadj[v]; e < g.xadj[v + 1] && w < target; ++e) {
        int64_t u = g.adjncy[e];
        if (!taken[u]) {
          taken[u] = 1;
          part[u] = p;
          w += g.vwgt[u];
          queue.push_back(u);
        }
      }
    }
    // region ran out of connected untaken vertices before reaching target:
    // grab nearest untaken (disconnected) vertices
    for (int64_t v = 0; v < g.n && w < target; ++v)
      if (!taken[v]) {
        taken[v] = 1;
        part[v] = p;
        w += g.vwgt[v];
        queue.push_back(v);
      }
  }
}

// greedy k-way boundary refinement (simplified FM: positive-gain moves,
// balance-guarded; a few passes)
void refine(const Graph& g, int nparts, int32_t* part, int passes = 4,
            double imbalance = 1.03) {
  std::vector<int64_t> pw(nparts, 0);
  int64_t total = 0;
  for (int64_t v = 0; v < g.n; ++v) {
    pw[part[v]] += g.vwgt[v];
    total += g.vwgt[v];
  }
  double maxw = imbalance * (double)total / nparts;
  std::vector<int64_t> conn(nparts);
  for (int pass = 0; pass < passes; ++pass) {
    int64_t moved = 0;
    for (int64_t v = 0; v < g.n; ++v) {
      int32_t pv = part[v];
      if (g.xadj[v + 1] == g.xadj[v]) continue;
      std::fill(conn.begin(), conn.end(), 0);
      bool boundary = false;
      for (int64_t e = g.xadj[v]; e < g.xadj[v + 1]; ++e) {
        conn[part[g.adjncy[e]]] += g.adjwgt[e];
        if (part[g.adjncy[e]] != pv) boundary = true;
      }
      if (!boundary) continue;
      int64_t id = conn[pv];
      int best = -1;
      int64_t bg = 0;
      for (int p = 0; p < nparts; ++p) {
        if (p == pv || conn[p] == 0) continue;
        int64_t gain = conn[p] - id;
        bool fits = pw[p] + g.vwgt[v] <= (int64_t)maxw;
        bool helps_balance = pw[p] + g.vwgt[v] < pw[pv];
        if (fits && (gain > bg || (gain == bg && gain >= 0 && best < 0 &&
                                   helps_balance))) {
          bg = gain;
          best = p;
        }
      }
      if (best >= 0 && bg > 0) {
        pw[pv] -= g.vwgt[v];
        pw[best] += g.vwgt[v];
        part[v] = best;
        ++moved;
      }
    }
    // balance pass: if some part exceeds maxw, push its worst boundary
    // vertices to the lightest feasible neighbor part (zero/negative gain
    // allowed)
    for (int64_t v = 0; v < g.n; ++v) {
      int32_t pv = part[v];
      if (pw[pv] <= (int64_t)maxw) continue;
      std::fill(conn.begin(), conn.end(), 0);
      for (int64_t e = g.xadj[v]; e < g.xadj[v + 1]; ++e)
        conn[part[g.adjncy[e]]] += g.adjwgt[e];
      int best = -1;
      int64_t bw2 = INT64_MAX;
      for (int p = 0; p < nparts; ++p)
        if (p != pv && conn[p] > 0 && pw[p] < bw2 &&
            pw[p] + g.vwgt[v] <= (int64_t)maxw) {
          bw2 = pw[p];
          best = p;
        }
      if (best >= 0) {
        pw[pv] -= g.vwgt[v];
        pw[best] += g.vwgt[v];
        part[v] = best;
        ++moved;
      }
    }
    if (!moved) break;
  }
}

// ---- proper 2-way Fiduccia-Mattheyses refinement with rollback ----
// The greedy k-way refine above only takes positive-gain moves and stalls
// at jagged boundaries; FM climbs through negative-gain sequences and keeps
// the best prefix. Used for bisection (nested-dissection separators and
// recursive-bisection partitions), where cut quality matters most.
void fm2(const Graph& g, int32_t* part, int passes, double imbalance) {
  int64_t total = 0;
  for (int64_t v = 0; v < g.n; ++v) total += g.vwgt[v];
  const double maxw = imbalance * (double)total / 2.0;
  std::vector<int64_t> pw(2, 0);
  for (int64_t v = 0; v < g.n; ++v) pw[part[v]] += g.vwgt[v];
  std::vector<int64_t> gain(g.n);
  std::vector<char> locked(g.n);
  std::vector<int64_t> order;
  order.reserve(g.n);
  auto compute_gain = [&](int64_t v) {
    int64_t gn = 0;
    for (int64_t e = g.xadj[v]; e < g.xadj[v + 1]; ++e)
      gn += (part[g.adjncy[e]] != part[v]) ? g.adjwgt[e] : -g.adjwgt[e];
    return gn;
  };
  for (int pass = 0; pass < passes; ++pass) {
    std::fill(locked.begin(), locked.end(), 0);
    order.clear();
    // lazy max-heap of (gain, vertex); stale entries skipped on pop.
    // Seed with BOUNDARY vertices only: cold-heap FM is O(n log n) per
    // pass, but refinement moves start at the cut — interior vertices
    // enter lazily when a neighbor moves. A move cap bounds the
    // negative-gain hill-climb so a pass never degenerates into a
    // full-graph sweep.
    std::priority_queue<std::pair<int64_t, int64_t>> heap;
    for (int64_t v = 0; v < g.n; ++v) {
      bool bnd = false;
      for (int64_t e = g.xadj[v]; e < g.xadj[v + 1] && !bnd; ++e)
        bnd = part[g.adjncy[e]] != part[v];
      if (!bnd) continue;
      gain[v] = compute_gain(v);
      heap.push({gain[v], v});
    }
    if (heap.empty()) break;
    const int64_t max_moves = 4 * (int64_t)heap.size() + 64;
    int64_t cur = 0, best = 0;
    size_t best_len = 0;
    while (!heap.empty() && (int64_t)order.size() < max_moves) {
      auto [gv, v] = heap.top();
      heap.pop();
      if (locked[v] || gv != gain[v]) continue;
      int to = 1 - part[v];
      if ((double)(pw[to] + g.vwgt[v]) > maxw) continue;
      locked[v] = 1;
      pw[part[v]] -= g.vwgt[v];
      pw[to] += g.vwgt[v];
      part[v] = (int32_t)to;
      order.push_back(v);
      cur += gv;
      if (cur > best) {
        best = cur;
        best_len = order.size();
      }
      for (int64_t e = g.xadj[v]; e < g.xadj[v + 1]; ++e) {
        int64_t u = g.adjncy[e];
        if (locked[u]) continue;
        gain[u] = compute_gain(u);
        heap.push({gain[u], u});
      }
    }
    // rollback everything after the best prefix
    for (size_t i = order.size(); i > best_len; --i) {
      int64_t v = order[i - 1];
      int to = 1 - part[v];
      pw[part[v]] -= g.vwgt[v];
      pw[to] += g.vwgt[v];
      part[v] = (int32_t)to;
    }
    if (best <= 0) break;
  }
}

// BFS half-growing from a pseudo-peripheral seed (good initial bisection)
void initial_bisect(const Graph& g, int32_t* part, uint64_t& seed) {
  int64_t total = 0;
  for (int64_t v = 0; v < g.n; ++v) total += g.vwgt[v];
  int64_t start = (int64_t)(lcg(seed) % (uint64_t)g.n);
  std::vector<int64_t> q;
  std::vector<char> seen(g.n);
  for (int rep = 0; rep < 2; ++rep) {  // two BFS sweeps -> pseudo-peripheral
    std::fill(seen.begin(), seen.end(), 0);
    q.clear();
    q.push_back(start);
    seen[start] = 1;
    for (size_t h = 0; h < q.size(); ++h)
      for (int64_t e = g.xadj[q[h]]; e < g.xadj[q[h] + 1]; ++e)
        if (!seen[g.adjncy[e]]) {
          seen[g.adjncy[e]] = 1;
          q.push_back(g.adjncy[e]);
        }
    start = q.back();
  }
  std::fill(part, part + g.n, 1);
  std::fill(seen.begin(), seen.end(), 0);
  q.clear();
  q.push_back(start);
  seen[start] = 1;
  int64_t w = 0;
  for (size_t h = 0; h < q.size() && 2 * w < total; ++h) {
    int64_t v = q[h];
    part[v] = 0;
    w += g.vwgt[v];
    for (int64_t e = g.xadj[v]; e < g.xadj[v + 1]; ++e)
      if (!seen[g.adjncy[e]]) {
        seen[g.adjncy[e]] = 1;
        q.push_back(g.adjncy[e]);
      }
  }
  // disconnected leftovers: dump into the lighter side
  for (int64_t v = 0; v < g.n && 2 * w < total; ++v)
    if (!seen[v]) {
      part[v] = 0;
      w += g.vwgt[v];
    }
}

}  // namespace

extern "C" {

// Multilevel 2-way partition with FM refinement (for ND separators and
// recursive bisection; better cuts than the greedy k-way refine).
void bisect_partition(const int64_t* xadj, const int64_t* adjncy,
                      const int64_t* adjwgt, int64_t n, int32_t* part_out) {
  if (n == 0) return;
  uint64_t seed = 0x9e3779b97f4a7c15ULL;
  std::vector<Graph> levels(1);
  levels[0].n = n;
  levels[0].xadj.assign(xadj, xadj + n + 1);
  levels[0].adjncy.assign(adjncy, adjncy + xadj[n]);
  levels[0].adjwgt.assign(adjwgt, adjwgt + xadj[n]);
  levels[0].vwgt.assign(n, 1);
  while (levels.back().n > 64) {
    Graph c = coarsen(levels.back(), seed);
    if (c.n >= levels.back().n * 95 / 100) break;
    levels.push_back(std::move(c));
  }
  std::vector<int32_t> part(levels.back().n);
  initial_bisect(levels.back(), part.data(), seed);
  fm2(levels.back(), part.data(), 10, 1.05);
  for (int64_t li = (int64_t)levels.size() - 1; li > 0; --li) {
    const Graph& fine = levels[li - 1];
    const std::vector<int64_t>& cmap = levels[li].cmap;
    std::vector<int32_t> fpart(fine.n);
    for (int64_t v = 0; v < fine.n; ++v) fpart[v] = part[cmap[v]];
    part = std::move(fpart);
    fm2(fine, part.data(), 4, 1.05);
  }
  std::copy(part.begin(), part.end(), part_out);
}

void kway_partition(const int64_t* xadj, const int64_t* adjncy,
                    const int64_t* adjwgt, int64_t n, int nparts,
                    int32_t* part_out) {
  if (nparts <= 1 || n == 0) {
    std::fill(part_out, part_out + n, 0);
    return;
  }
  uint64_t seed = 0x9e3779b97f4a7c15ULL;
  std::vector<Graph> levels(1);
  levels[0].n = n;
  levels[0].xadj.assign(xadj, xadj + n + 1);
  levels[0].adjncy.assign(adjncy, adjncy + xadj[n]);
  levels[0].adjwgt.assign(adjwgt, adjwgt + xadj[n]);
  levels[0].vwgt.assign(n, 1);
  const int64_t coarse_target = std::max<int64_t>(64, 16LL * nparts);
  while (levels.back().n > coarse_target) {
    Graph c = coarsen(levels.back(), seed);
    if (c.n >= levels.back().n * 95 / 100) break;  // stalled matching
    levels.push_back(std::move(c));
  }
  std::vector<int32_t> part(levels.back().n);
  initial_partition(levels.back(), nparts, part.data(), seed);
  refine(levels.back(), nparts, part.data(), 8);
  for (int64_t li = (int64_t)levels.size() - 1; li > 0; --li) {
    const Graph& fine = levels[li - 1];
    const std::vector<int64_t>& cmap = levels[li].cmap;
    std::vector<int32_t> fpart(fine.n);
    for (int64_t v = 0; v < fine.n; ++v) fpart[v] = part[cmap[v]];
    part = std::move(fpart);
    refine(fine, nparts, part.data(), 4);
  }
  std::copy(part.begin(), part.end(), part_out);
}

// total weight of edges crossing a partition (diagnostic)
int64_t edge_cut(const int64_t* xadj, const int64_t* adjncy,
                 const int64_t* adjwgt, int64_t n, const int32_t* part) {
  int64_t cut = 0;
  for (int64_t v = 0; v < n; ++v)
    for (int64_t e = xadj[v]; e < xadj[v + 1]; ++e)
      if (part[v] != part[adjncy[e]]) cut += adjwgt[e];
  return cut / 2;
}

}  // extern "C"
