// Discrete Morse Theory graph kernel (C++17, C ABI for ctypes).
//
// Native re-implementation of the reference's discrete-Morse skeleton
// extraction (fl_tissue_model_tools/dmtgraph.py:38-453, itself a port of the
// pydmtgraph C++ extension). Semantics — including the value/index
// tie-breaking in the union-find merges (dmtgraph.py:130-144), the edge
// ordering (lexsort by (max endpoint value, index), dmtgraph.py:85,91), the
// 4-slot neighbor commit order (dmtgraph.py:327-332) and BFS-based Morse
// pairing (dmtgraph.py:335-377) — are preserved exactly so graphs are
// bit-comparable with the reference.
//
// Pipeline:
//   1. negate image; build primal vertices, dual (triangle) vertices and the
//      3 edge families (vertical, horizontal, anti-diagonal) of the pixel
//      complex in the reference's index order
//   2. drop edges touching (near-)zero vertices (|v| <= 1e-8)
//   3. 0-dim persistence: union-find over edges sorted ascending by
//      (max endpoint value, index)
//   4. 1-dim persistence on the dual complex, edges in reverse order,
//      flipped comparisons
//   5. collect: commit low-persistence vertex-edge pairs as tree adjacency,
//      BFS per component to find the minimum and assign Morse parents, trace
//      1-unstable manifolds of high-persistence edges with value < -delta2,
//      compact to (V x 2 int32 positions, E x 2 int32 indices)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr float kZeroAtol = 1e-8f;  // np.isclose(x, 0) default atol

struct UnionFind {
  // parent/value arrays; find with path halving like the reference
  std::vector<int32_t> parent;
  const float* value;

  UnionFind(int32_t n, const float* values) : parent(n), value(values) {
    for (int32_t i = 0; i < n; ++i) parent[i] = i;
  }

  int32_t find_compress(int32_t v) {
    int32_t root = v;
    while (parent[root] != root) root = parent[root];
    while (parent[v] != root) {
      int32_t next = parent[v];
      parent[v] = root;
      v = next;
    }
    return root;
  }

  // Returns the losing root's value, or NaN if already merged.
  // flip=false: smaller (value, index) root survives (dmtgraph.py:136-144)
  // flip=true:  larger (value, index) root survives (dmtgraph.py:130-135)
  float merge(int32_t v1, int32_t v2, bool flip) {
    int32_t p1 = find_compress(v1);
    int32_t p2 = find_compress(v2);
    if (p1 == p2) return std::numeric_limits<float>::quiet_NaN();
    bool p1_wins;
    if (flip) {
      p1_wins = value[p1] > value[p2] || (value[p1] == value[p2] && p1 > p2);
    } else {
      p1_wins = value[p1] < value[p2] || (value[p1] == value[p2] && p1 < p2);
    }
    if (p1_wins) {
      parent[p2] = p1;
      return value[p2];
    }
    parent[p1] = p2;
    return value[p1];
  }
};

struct Edge {
  int32_t v1, v2;    // primal vertex indices
  int32_t dv1, dv2;  // dual vertex indices
  uint8_t pair_type; // 0 unknown, 1 vertex-edge, 2 edge-triangle
  float persistence;
  float max_val;     // max endpoint value (cached)
};

}  // namespace

extern "C" {

// Returns 0 on success. Caller frees out buffers with dmt_free.
int dmt_compute_graph(const float* img_in, int32_t nrows, int32_t ncols,
                      float delta1, float delta2,
                      int32_t** out_verts, int32_t* out_n_verts,
                      int32_t** out_edges, int32_t* out_n_edges) {
  if (nrows < 2 || ncols < 2) return 1;
  const int64_t n_verts = (int64_t)nrows * ncols;
  const int32_t n_dual = (nrows - 1) * (ncols - 1) * 2;  // + 1 virtual

  // ----- vertices (negated image) ---------------------------------------
  std::vector<float> vval((size_t)n_verts);
  for (int64_t i = 0; i < n_verts; ++i) vval[i] = -img_in[i];

  // ----- dual vertices ----------------------------------------------------
  // cell (r, c): triangle 0 = max of (r,c),(r,c+1),(r+1,c)
  //              triangle 1 = max of (r,c+1),(r+1,c),(r+1,c+1)
  // (dmtgraph.py:168-199); virtual dual vertex n_dual has value +inf
  std::vector<float> dvval((size_t)n_dual + 1);
  for (int32_t r = 0; r < nrows - 1; ++r) {
    for (int32_t c = 0; c < ncols - 1; ++c) {
      const float a = vval[(int64_t)r * ncols + c];
      const float b = vval[(int64_t)r * ncols + c + 1];
      const float d = vval[(int64_t)(r + 1) * ncols + c];
      const float e = vval[(int64_t)(r + 1) * ncols + c + 1];
      const int32_t base = (r * (ncols - 1) + c) * 2;
      dvval[base] = std::max(a, std::max(b, d));
      dvval[base + 1] = std::max(b, std::max(d, e));
    }
  }
  dvval[n_dual] = std::numeric_limits<float>::infinity();

  // ----- edges (vertical, horizontal, diagonal; reference order) ---------
  std::vector<Edge> edges;
  edges.reserve((size_t)(nrows - 1) * ncols + (size_t)nrows * (ncols - 1) +
                (size_t)(nrows - 1) * (ncols - 1));
  auto nonzero = [&](int64_t v) { return std::fabs(vval[v]) > kZeroAtol; };
  auto push_edge = [&](int64_t v1, int64_t v2, int32_t dv1, int32_t dv2) {
    if (!nonzero(v1) || !nonzero(v2)) return;  // dmtgraph.py:71-77
    Edge e;
    e.v1 = (int32_t)v1;
    e.v2 = (int32_t)v2;
    e.dv1 = dv1;
    e.dv2 = dv2;
    e.pair_type = 0;
    e.persistence = std::numeric_limits<float>::infinity();
    e.max_val = std::max(vval[v1], vval[v2]);
    edges.push_back(e);
  };

  // vertical: (r,c)-(r+1,c); duals left/right of the edge (dmtgraph.py:206-229)
  for (int32_t r = 0; r < nrows - 1; ++r) {
    for (int32_t c = 0; c < ncols; ++c) {
      const int32_t dual = r * 2 * (ncols - 1) + c * 2;
      const int32_t dv1 = (c == 0) ? n_dual : dual - 1;
      const int32_t dv2 = (c == ncols - 1) ? n_dual : dual;
      push_edge((int64_t)r * ncols + c, (int64_t)(r + 1) * ncols + c, dv1, dv2);
    }
  }
  // horizontal: (r,c)-(r,c+1) (dmtgraph.py:232-254)
  for (int32_t r = 0; r < nrows; ++r) {
    for (int32_t c = 0; c < ncols - 1; ++c) {
      const int32_t dual = r * 2 * (ncols - 1) + c * 2;
      const int32_t dv1 = (r == 0) ? n_dual : dual - 2 * (ncols - 1) + 1;
      const int32_t dv2 = (r == nrows - 1) ? n_dual : dual;
      push_edge((int64_t)r * ncols + c, (int64_t)r * ncols + c + 1, dv1, dv2);
    }
  }
  // anti-diagonal: (r,c+1)-(r+1,c) (dmtgraph.py:257-274)
  for (int32_t r = 0; r < nrows - 1; ++r) {
    for (int32_t c = 0; c < ncols - 1; ++c) {
      const int32_t dual = r * 2 * (ncols - 1) + c * 2;
      push_edge((int64_t)r * ncols + c + 1, (int64_t)(r + 1) * ncols + c, dual,
                dual + 1);
    }
  }

  const int64_t n_edges = (int64_t)edges.size();

  // ----- sort ascending by (max_val, index) ------------------------------
  // pack (order-preserving float bits, index) into one uint64 so the sort
  // runs branch-light on integer keys (~5x faster than a comparator
  // stable_sort; the low 32 bits make it equivalent to the lexsort)
  auto float_key = [](float f) -> uint32_t {
    uint32_t u;
    std::memcpy(&u, &f, sizeof(u));
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  };
  std::vector<uint64_t> keyed((size_t)n_edges);
  for (int64_t i = 0; i < n_edges; ++i) {
    keyed[i] = ((uint64_t)float_key(edges[i].max_val) << 32) | (uint32_t)i;
  }
  std::sort(keyed.begin(), keyed.end());
  std::vector<int32_t> order(n_edges);
  for (int64_t i = 0; i < n_edges; ++i) {
    order[i] = (int32_t)(keyed[i] & 0xffffffffu);
  }

  // ----- persistence 1: union-find over primal vertices ------------------
  {
    UnionFind uf((int32_t)n_verts, vval.data());
    for (int64_t i = 0; i < n_edges; ++i) {
      Edge& e = edges[order[i]];
      const float death = e.max_val;
      const float birth = uf.merge(e.v1, e.v2, /*flip=*/false);
      if (!std::isnan(birth)) {
        e.persistence = death - birth;
        e.pair_type = 1;
      }
    }
  }

  // ----- persistence 2: reversed order, dual union-find, flipped ---------
  {
    UnionFind uf(n_dual + 1, dvval.data());
    for (int64_t i = n_edges - 1; i >= 0; --i) {
      Edge& e = edges[order[i]];
      if (e.pair_type != 0) continue;
      const float birth = e.max_val;
      const float death = uf.merge(e.dv1, e.dv2, /*flip=*/true);
      if (!std::isnan(death)) {
        e.persistence = death - birth;
        e.pair_type = 2;
      }
    }
  }

  // ----- collect: commit tree edges (reverse order, as the reference
  // iterates E after its second sort = descending (value, index)) ---------
  // neighbor slots: up to 4 per vertex, first-free-slot order
  std::vector<int32_t> neighbors((size_t)n_verts * 4, -1);
  auto add_neighbor = [&](int32_t v, int32_t n) {
    int32_t* slots = &neighbors[(size_t)v * 4];
    for (int k = 0; k < 4; ++k) {
      if (slots[k] == -1) {
        slots[k] = n;
        return;
      }
    }
  };
  for (int64_t i = n_edges - 1; i >= 0; --i) {
    const Edge& e = edges[order[i]];
    if (e.pair_type == 1 && e.persistence < delta1) {
      add_neighbor(e.v1, e.v2);
      add_neighbor(e.v2, e.v1);
    }
  }

  // ----- cancel Morse pairs: per-component BFS (dmtgraph.py:335-377) -----
  std::vector<int32_t> morse_parent((size_t)n_verts, -1);
  std::vector<int32_t> explored((size_t)n_verts, -1);
  std::vector<int32_t> queue((size_t)n_verts);
  for (int64_t i = 0; i < n_verts; ++i) {
    if (morse_parent[i] != -1) continue;
    int64_t qs = 0, qe = 1;
    queue[0] = (int32_t)i;
    int32_t min_v = (int32_t)i;
    while (qs < qe) {
      const int32_t curr = queue[qs++];
      explored[curr] = (int32_t)i;
      const float min_val = vval[min_v];
      const float cur_val = vval[curr];
      if (cur_val < min_val || (cur_val == min_val && curr < min_v)) min_v = curr;
      const int32_t* slots = &neighbors[(size_t)curr * 4];
      for (int k = 0; k < 4; ++k) {
        const int32_t nb = slots[k];
        if (nb == -1) break;
        if (explored[nb] != (int32_t)i && qe < (int64_t)n_verts) queue[qe++] = nb;
      }
    }
    morse_parent[min_v] = min_v;
    qs = 0;
    qe = 1;
    queue[0] = min_v;
    while (qs < qe) {
      const int32_t curr = queue[qs++];
      const int32_t* slots = &neighbors[(size_t)curr * 4];
      for (int k = 0; k < 4; ++k) {
        const int32_t nb = slots[k];
        if (nb == -1) break;
        if (morse_parent[nb] == -1) {
          morse_parent[nb] = curr;
          queue[qe++] = nb;
        }
      }
    }
  }

  // ----- collect unstable manifold (dmtgraph.py:379-427) -----------------
  std::vector<uint8_t> in_manifold((size_t)n_verts, 0);
  std::vector<std::pair<int32_t, int32_t>> mn_edges;
  auto collect_path_to_min = [&](int32_t v) {
    int32_t curr = v;
    while (!in_manifold[curr] && morse_parent[curr] != curr &&
           morse_parent[curr] != -1) {
      in_manifold[curr] = 1;
      mn_edges.emplace_back(curr, morse_parent[curr]);
      curr = morse_parent[curr];
    }
  };
  for (int64_t i = n_edges - 1; i >= 0; --i) {
    const Edge& e = edges[order[i]];
    const float edge_val = std::max(vval[e.v1], vval[e.v2]);
    if (e.persistence > delta1 && edge_val < -delta2) {
      collect_path_to_min(e.v1);
      collect_path_to_min(e.v2);
      mn_edges.emplace_back(e.v1, e.v2);
    }
  }

  // ----- compact to position / index arrays (dmtgraph.py:429-453) --------
  const int64_t m = (int64_t)mn_edges.size();
  std::vector<int32_t> index_map((size_t)n_verts, -1);
  int32_t* verts_out = (int32_t*)std::malloc(sizeof(int32_t) * 2 * 2 * (m ? m : 1));
  int32_t* edges_out = (int32_t*)std::malloc(sizeof(int32_t) * 2 * (m ? m : 1));
  if (!verts_out || !edges_out) {
    std::free(verts_out);
    std::free(edges_out);
    return 2;
  }
  int32_t vp = 0;
  for (int64_t i = 0; i < m; ++i) {
    const int32_t a = mn_edges[i].first;
    const int32_t b = mn_edges[i].second;
    if (index_map[a] == -1) {
      index_map[a] = vp;
      verts_out[vp * 2] = a / ncols;
      verts_out[vp * 2 + 1] = a % ncols;
      ++vp;
    }
    if (index_map[b] == -1) {
      index_map[b] = vp;
      verts_out[vp * 2] = b / ncols;
      verts_out[vp * 2 + 1] = b % ncols;
      ++vp;
    }
    edges_out[i * 2] = index_map[a];
    edges_out[i * 2 + 1] = index_map[b];
  }

  *out_verts = verts_out;
  *out_n_verts = vp;
  *out_edges = edges_out;
  *out_n_edges = (int32_t)m;
  return 0;
}

void dmt_free(void* p) { std::free(p); }

}  // extern "C"
